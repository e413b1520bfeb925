"""Export a training checkpoint of the port to a reference-loadable .pth
(counterpart of octcubem_tpu/cli/export.py).

    python -m octcubem_tpu_torch.cli.export \\
        --ckpt ./output_pretrain            # run dir, or its ckpt/ dir
        --out ./octcube_export.pth \\
        [--step 40] [--style flash|retfound] [--subtree visual]

The checkpoint is one ``core/checkpoint.py`` wrote (a TrainState's
``state_dict()``: its ``params`` are exported).  ``--subtree`` keeps the
keys under a '/'-separated prefix and strips it (a leading ``params``
names the params themselves, as in the JAX CLI).  The run's geometry,
read from ``args.json`` beside ``ckpt/``, is stamped into the file under
``octcubem_tpu_geometry``, which both packages' loaders check
(``compat.torch_import.check_geometry_stamp``); a run at ``num_heads``
other than the reference's 16 gets a warning, since the reference
constructors hardcode 16 heads.
"""

from __future__ import annotations

import argparse
import json
import os


def _subtree(params: dict, subtree: str) -> dict:
    parts = [p for p in subtree.strip("/").split("/") if p]
    if parts[:1] == ["params"]:
        parts = parts[1:]
    if not parts:
        return params
    prefix = ".".join(parts) + "."
    out = {k[len(prefix):]: v for k, v in params.items()
           if k.startswith(prefix)}
    if not out:
        tops = sorted({k.split(".")[0] for k in params})
        raise SystemExit(f"subtree {subtree!r} not found; available: "
                         f"{tops[:20]}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser("OCTCube checkpoint export (PyTorch)")
    parser.add_argument("--ckpt", required=True,
                        help="training run dir (or its ckpt/ dir)")
    parser.add_argument("--out", required=True, help="output .pth path")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: latest)")
    parser.add_argument("--style", default="flash",
                        choices=["flash", "retfound"])
    parser.add_argument("--subtree", default=None,
                        help="'/'-separated key prefix to export (e.g. "
                             "'visual' for one tower)")
    args = parser.parse_args(argv)

    from ..compat.torch_export import export_state_dict, save_torch_checkpoint
    from ..compat.torch_import import GEOMETRY_KEY
    from ..core.checkpoint import restore_raw

    ckpt_dir = args.ckpt
    if os.path.isdir(os.path.join(ckpt_dir, "ckpt")):
        ckpt_dir = os.path.join(ckpt_dir, "ckpt")
    raw, step = restore_raw(ckpt_dir, args.step)
    params = raw["params"] if isinstance(raw, dict) and "params" in raw else raw
    if args.subtree:
        params = _subtree(params, args.subtree)
    sd = export_state_dict(params, style=args.style)
    extra = {"epoch": int(step)}
    ckpt_dir = ckpt_dir.rstrip("/")
    run_dir = (os.path.dirname(ckpt_dir)
               if os.path.basename(ckpt_dir) == "ckpt" else ckpt_dir)
    args_json = os.path.join(run_dir, "args.json")
    if os.path.exists(args_json):
        try:
            with open(args_json) as f:
                run_cfg = json.load(f)
        except ValueError:
            run_cfg = {}
        geom = {k: run_cfg[k] for k in
                ("model", "num_heads", "decoder_num_heads", "num_frames",
                 "t_patch_size", "input_size") if k in run_cfg}
        if geom:
            extra[GEOMETRY_KEY] = geom
        if run_cfg.get("num_heads", 16) != 16:
            print(f"WARNING: this run was pretrained with num_heads="
                  f"{run_cfg['num_heads']}.  The reference constructors "
                  "hardcode 16 heads: loading this .pth there computes a "
                  "DIFFERENT function unless the model is built with "
                  f"num_heads={run_cfg['num_heads']}.  The geometry is "
                  f"stamped under key '{GEOMETRY_KEY}'.")
    save_torch_checkpoint(args.out, sd, extra=extra)
    print(f"exported step {step} -> {args.out} "
          f"({len(sd)} tensors, style={args.style})")
    return args.out


if __name__ == "__main__":
    main()
