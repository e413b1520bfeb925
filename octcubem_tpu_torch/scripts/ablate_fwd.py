"""Ablations of the bf16 Hopper forward body (csrc/flash_fwd.cuh,
fwd_hopper_kernel: B1, B3, B5) on the card: each variant is a copy of the
package under ``build/ablate/<variant>/`` with edits of flash_fwd.cuh,
timed by ``time_kernels.py --root`` (device time per call):

- ``base``: the body as it is;
- ``noexp``: p = its exponent, no MUFU ex2 (the FFMA, clamp, sums, packing
  stay);
- ``noqk``: no s = Q K^T products (p from stale registers);
- ``nopv``: no acc += P V products;
- ``noload``: the producer fills the ring once and then only signals its
  barriers, so every later tile reuses stale K and V (no TMA traffic);
- ``nomask``: the ragged last key tile unmasked;
- ``nocls``: no cls fold in the epilogue.

Each of those computes wrong results on purpose; only its time means
anything.  The design alternatives after them in VARIANTS (the consumers
taking turns, a share of the exps on the FMA pipe, the ring's depth, the
key tile) compute the same function.  Run on a machine with the card:

    python octcubem_tpu_torch/scripts/ablate_fwd.py [--variants base,noexp]
        [--rows B1 ViT-L serving,B3] [--iters 50] [--rounds 2]

Prints one JSON line per variant and round ({"variant", "rows": {row:
device ms}}; odd rounds run the variants in reverse order), then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HEADER = "octcubem_tpu_torch/csrc/flash_fwd.cuh"

_PRODUCER_KV = "      mbar_expect_tx(full_k + s, Cfg::kKV);\n"

# variant -> [(text in flash_fwd.cuh, its replacement)]; each text must
# occur exactly once
VARIANTS = {
    "base": [],
    "noexp": [("pj[e] = on_fma<kEmu>(j) ? ex2_fma(x) : ex2(x);",
               "pj[e] = x;")],
    "noqk": [("    Wgmma<BN>::template ss<0, 0>(\n",
              "    if (kk < 0) Wgmma<BN>::template ss<0, 0>(\n")],
    "nopv": [("    Wgmma<D>::template rs<1>(acc, pa[i],\n",
              "    if (i < 0) Wgmma<D>::template rs<1>(acc, pa[i],\n")],
    "noload": [(_PRODUCER_KV,
                "      if (t >= S) {\n        mbar_arrive(full_k + s);\n"
                "        mbar_arrive(full_v + s);\n        continue;\n      }\n"
                + _PRODUCER_KV)],
    "nomask": [("  if (k0 + BN <= nk)\n    fixed_p<false, BN, kEmu>",
                "  if (true)\n    fixed_p<false, BN, kEmu>")],
    "nocls": [("  if (p.kc) {\n    // s_c = q . kc", "  if (false) {\n    // s_c = q . kc")],
}


def _pp(expr: str):
    """The consumers take turns where ``expr`` (of D) holds."""
    return ("kPingPong = D >= 80;", f"kPingPong = {expr};")


def _emu(expr: str):
    """Every ``expr``-th 8-key chunk's exps on the FMA pipe (0: none)."""
    return ("kEmuEvery = D == 32 ? 16 : 0;", f"kEmuEvery = {expr};")


# design alternatives (right results) to the body's choice, turns at
# D >= 80 and every 16th chunk's exps on the FMA pipe at D = 32: "plain"
# has neither, the others vary one of them (at every D unless named) or,
# from "plain", the ring's depth and the key tile
_PLAIN = [_pp("false"), _emu("0")]
VARIANTS.update({
    "plain": _PLAIN,
    "pingpong": [_pp("true"), _emu("0")],
    "pp80": [_emu("0")],
    "emu4": [_pp("false"), _emu("4")],
    "emu8": [_pp("false"), _emu("8")],
    "emu16": [_pp("false"), _emu("16")],
    "pp80_emu32": [_emu("D == 32 ? 8 : 0")],
    "pp80_emu80": [_emu("D == 32 || D == 80 ? 8 : 0")],
    "s3": _PLAIN + [("kStages = kPanels == 2 ? 3 : 4;", "kStages = 3;")],
    "bn64": _PLAIN + [("static constexpr int BN = 128;  // keys per tile",
                       "static constexpr int BN = 64;  // keys per tile")],
})

DEFAULT_ROWS = "B1 ViT-L serving,B1 MAE decoder,B3 ViT-H classifier"


def make_copy(name: str) -> Path:
    """build/ablate/<name>/: the package and pyproject.toml (so its kernels
    build under the copy), flash_fwd.cuh edited as VARIANTS[name] says."""
    dst = ROOT / "build" / "ablate" / name
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "octcubem_tpu_torch", dst / "octcubem_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "pyproject.toml", dst / "pyproject.toml")
    path = dst / HEADER
    path.write_text(edited(name, path.read_text()))
    return dst


def edited(name: str, text: str) -> str:
    """flash_fwd.cuh's ``text`` with variant ``name``'s edits; raises where
    a text to replace does not occur exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--rows", default=DEFAULT_ROWS)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    copies = {name: make_copy(name) for name in names}
    # every copy's forward libraries at once
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from "
             "octcubem_tpu_torch.ops import _cuda; "
             "_cuda.build(['flash_fwd_packed', 'flash_fwd_bh'])")
    procs = [subprocess.Popen([sys.executable, "-c", build, str(d)])
             for d in copies.values()]
    if any(p.wait() != 0 for p in procs):
        print("ablate_fwd: a build failed", file=sys.stderr)
        return 1
    script = Path(__file__).resolve().parent / "time_kernels.py"
    smi = None
    # round r times the variants forward when r is even, backward when odd,
    # so a drift of the card's speed over the run shows
    order = [name for r in range(args.rounds)
             for name in (names if r % 2 == 0 else names[::-1])]
    for name in order:
        dst = copies[name]
        res = subprocess.run(
            [sys.executable, str(script), "--root", str(dst), "--rows",
             args.rows, "--iters", str(args.iters)],
            check=True, capture_output=True, text=True)
        smi, line = res.stdout.strip().splitlines()[-2:]
        out = json.loads(line)
        print(json.dumps({"variant": name, "rows": {
            row: val["ms"] for row, val in out.items()
            if isinstance(val, dict)}}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
