"""Checkpoint output-parity harness (counterpart of
octcubem_tpu/cli/parity_check.py): load a released .pth through the
importer, run the fp32 forward (TF32 off on the card) on given inputs,
and compare with expected outputs from the reference implementation (a
.npz with 'inputs' [B, C, T, H, W] or [B, T, H, W, C] and
'expected_logits').

    python -m octcubem_tpu_torch.cli.parity_check OCTCube_multitask_cls.pth \\
        expected.npz --model_family vit_st_dropout

Exit code 0 on PASS (max |dlogits| <= --atol), 1 on FAIL, with the
per-disease argmax agreement.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser("checkpoint output parity check")
    parser.add_argument("ckpt", help="reference .pth checkpoint")
    parser.add_argument("expected_npz",
                        help="npz with inputs + expected_logits from the "
                             "reference run")
    parser.add_argument("--model_family", default="vit_st_dropout")
    parser.add_argument("--model", default="flash_attn_vit_large_patch16")
    parser.add_argument("--num_frames", type=int, default=48)
    parser.add_argument("--input_size", type=int, default=256)
    parser.add_argument("--t_patch_size", type=int, default=3)
    parser.add_argument("--num_classes", type=int, default=16)
    parser.add_argument("--atol", type=float, default=1e-3)
    # architecture overrides (match the checkpoint's dims when they differ
    # from the named constructor, e.g. for reduced test checkpoints)
    parser.add_argument("--embed_dim", type=int, default=None)
    parser.add_argument("--depth", type=int, default=None)
    parser.add_argument("--num_heads", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)

    from ..compat.torch_import import (check_geometry_stamp,
                                       load_reference_weights,
                                       load_torch_checkpoint)
    from ..core.device import resolve_device
    from ..models import registry, vit_st

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 matmuls
    data = np.load(args.expected_npz)
    x = np.asarray(data["inputs"], np.float32)
    expected = np.asarray(data["expected_logits"], np.float32)
    if x.ndim == 5 and x.shape[1] in (1, 3) and x.shape[1] < x.shape[-1]:
        x = x.transpose(0, 2, 3, 4, 1)  # torch [B,C,T,H,W] -> channel-last

    kw = dict(num_frames=args.num_frames, t_patch_size=args.t_patch_size,
              img_size=args.input_size, in_chans=x.shape[-1],
              num_classes=args.num_classes)
    check_geometry_stamp(args.ckpt, args.num_heads or 16)
    if args.embed_dim or args.depth or args.num_heads:
        model = vit_st.create_model(
            vit_st.VisionTransformerST, device=device, seed=args.seed,
            embed_dim=args.embed_dim or 1024, depth=args.depth or 24,
            num_heads=args.num_heads or 16,
            head_type=("dropout" if "dropout" in args.model_family
                       else "aggregate"), **kw)
    else:
        model = registry.create_model(args.model_family, args.model,
                                      device=device, seed=args.seed, **kw)
    report = load_reference_weights(model, load_torch_checkpoint(args.ckpt))
    if report["missing"]:
        print(f"WARNING missing params (kept at init): {report['missing']}")

    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(x).to(device))
    logits = logits.float().cpu().numpy()
    err = np.abs(logits - expected)
    print(f"max abs err: {err.max():.3e}  mean: {err.mean():.3e}  "
          f"(atol {args.atol})")
    agree = np.argmax(logits.reshape(len(x), -1, 2), -1) == \
        np.argmax(expected.reshape(len(x), -1, 2), -1)
    print(f"per-disease argmax agreement: {agree.mean() * 100:.2f}%")
    if err.max() <= args.atol:
        print("PARITY: PASS")
        return 0
    print("PARITY: FAIL")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
