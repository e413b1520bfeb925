"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``: its configuration
(``benchmark/configs/<config>.json`` with the builders beside it in
``<config>.py``), the driver that runs its traffic
(``benchmark/drivers/<driver>.py``), the traffic's parameters, the chips
it needs and the limits of its comparison with the plain reference.
``BENCHMARK.json`` at the root says which metrics the cell reports: with
``--trace 0`` its end-to-end metrics, with ``--trace 1`` its per-layer
ones, each read by ``benchmark/metrics/<base>.py``, where ``<base>`` is
the metric's name up to its first dot (``mfu.train`` and ``mfu.clip``
share ``metrics/mfu.py``).  Nothing here
names a cell, a configuration or a metric.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit); the same comparisons are the last lines of
standard error.  The run exits with another code than 0, and prints no
result, when no card is present (or fewer than the cell asks for), or
when JAX or the JAX package is loaded in this process once the window
has closed.  Every build and kernel cache sits under ``.bench_cache/`` at
the root of the checkout.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "octcubem_tpu")


def set_environment() -> None:
    """Fixed cache directories inside the checkout, before torch loads."""
    env = {"OCTCUBEM_TPU_TORCH_BUILD": CACHE / "kernels",
           "TRITON_CACHE_DIR": CACHE / "triton",
           "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
           "TORCHINDUCTOR_CACHE_DIR": CACHE / "inductor"}
    for k, v in env.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_module(path: Path, name: str):
    """The module at ``path``, loaded once a process under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str):
    """-> (cell dict, configuration dict, configuration module, driver
    module, BENCHMARK.json)."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    with open(HERE / "workloads" / f"{workload}.json") as f:
        cell = json.load(f)
    cell["name"] = workload
    with open(HERE / "configs" / f"{cell['config']}.json") as f:
        config = json.load(f)
    cfgmod = load_module(HERE / "configs" / f"{cell['config']}.py",
                         f"bench_config_{cell['config']}")
    driver = load_module(HERE / "drivers" / f"{cell['driver']}.py",
                         f"bench_driver_{cell['driver']}")
    return cell, config, cfgmod, driver, bench


def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def read_metrics(run, entries) -> dict:
    out = {}
    for m in entries:
        base = m["name"].split(".")[0]
        mod = load_module(HERE / "metrics" / f"{base}.py",
                          f"bench_metric_{base}")
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info(run) -> dict:
    import subprocess

    import torch

    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        limit = []
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": run.chips, "memory_peak_bytes": int(run.peak_bytes)}
    if run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
    return dev, limit


def execute(run, driver, bench) -> dict:
    """Drive the cell and assemble the result (the checks key last)."""
    driver.run(run)
    metrics = read_metrics(run, metric_entries(bench, run.name, run.trace))
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    cell, config, cfgmod, driver, bench = load_cell(args.workload)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from harness.core import Run

    run = Run(workload=cell, config=config, cfgmod=cfgmod, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda", 0), cache=CACHE, t_start=T_START)
    result = execute(run, driver, bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    result["device"], limit = card_info(run)
    if run.profile is not None:
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in run.checks}
    for line in run.notes:
        print(line, file=sys.stderr)
    print(f"card and power limit: {limit}; peaks: bf16 989e12 FLOP/s, "
          f"HBM 3.35e12 B/s (H100 SXM data sheet, at 700 W)",
          file=sys.stderr)
    for n, v, lim in run.checks:
        print(f"{n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
