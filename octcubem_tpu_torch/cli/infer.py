"""Single-volume 8-disease inference (counterpart of
octcubem_tpu/cli/infer.py): val-transform a volume to (48, 256, 256),
run the ViT-L spatiotemporal classifier (dropout head, global pool),
reshape the logits to (8, 2), softmax, print per-disease probabilities.

    python -m octcubem_tpu_torch.cli.infer volume.npy --ckpt model.pth

Volumes are .npy [T, H, W]; DICOM input waits for data/dicom.py
(ROADMAP A10).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

DISEASES = ["Normal", "DME", "AMD", "POAG", "EPM", "DR", "VD", "RAO\\RVO", "RNV"]


def build_model(args, device):
    """The classifier with seeded weights and, from ``--ckpt``, the JAX
    CLI's import: the geometry stamp checked first, params the file lacks
    kept from the init with a warning that names them, keys with no slot
    an error."""
    from ..compat.torch_import import (check_geometry_stamp,
                                       load_reference_weights,
                                       load_torch_checkpoint)
    from ..core.precision import policy_from_name
    from ..models import vit_st

    if args.ckpt:
        check_geometry_stamp(args.ckpt, args.num_heads)
    model = vit_st.create_model(
        vit_st.flash_attn_vit_large_patch16, device=device, seed=args.seed,
        num_frames=args.num_frames,
        t_patch_size=args.t_patch_size, img_size=args.input_size,
        in_chans=1, num_classes=args.nb_classes, num_heads=args.num_heads,
        head_type="dropout", global_pool=True, sep_pos_embed=True,
        cls_embed=True, dtype=policy_from_name(args.precision).compute_dtype)
    if args.ckpt:
        report = load_reference_weights(
            model, load_torch_checkpoint(args.ckpt), strict=True)
        if report["missing"]:
            print(f"warning: missing params filled from init: "
                  f"{report['missing']}")
        print(f"Load checkpoint {args.ckpt}")
    else:
        print("No checkpoint for loading")
    return model


def process_volume(path: str, num_frames: int, input_size: int) -> np.ndarray:
    """.npy -> [1, T, H, W, 1] val-transformed volume (resize, /255)."""
    from ..data.transforms import Transform3D

    if not path.endswith(".npy"):
        raise NotImplementedError(
            "only .npy volumes are read; DICOM input is not ported yet "
            "(ROADMAP A10)")
    vol = np.load(path).astype(np.float32)
    vol = Transform3D(input_size, num_frames)(vol) / 255.0
    return vol[None, ..., None]


def parse_all_output(probs: np.ndarray) -> str:
    """Per-disease probability printout."""
    highest = int(np.argmax(probs[:, 1]))
    p = float(probs[highest, 1])
    disease_flag = p > 0.5
    out = "Disease probability: (Disease Name: Probability) \n"
    n = min(len(DISEASES), probs.shape[0] + 1)
    for i, name in enumerate(DISEASES[:n]):
        if i == 0:
            val = 1 - p if disease_flag else float(np.mean(probs[:, 0]))
        else:
            val = float(probs[i - 1, 1])
        out += f"{name}: {val:.3f}    "
    return out


def main(argv=None):
    from ..core.device import resolve_device

    parser = argparse.ArgumentParser("OCTCube single-volume inference (PyTorch)")
    parser.add_argument("volume", help=".npy OCT volume [T, H, W]")
    parser.add_argument("--ckpt", default=None,
                        help="reference .pth (any layout the importer "
                             "reads); seeded random weights when absent")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--t_patch_size", type=int, default=3)
    parser.add_argument("--num_frames", type=int, default=48)
    parser.add_argument("--input_size", type=int, default=256)
    parser.add_argument("--nb_classes", type=int, default=16)
    parser.add_argument("--num_heads", type=int, default=16,
                        help="encoder heads; must match the checkpoint's "
                             "pretrain geometry")
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="fp32")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.precision == "fp32":
        # full-fp32 matmuls on the card (the parity path)
        torch.backends.cuda.matmul.allow_tf32 = False
    # read + preprocess the volume before building the model so bad
    # inputs fail fast
    vol = process_volume(args.volume, args.num_frames, args.input_size)
    model = build_model(args, device)
    with torch.inference_mode():
        logits = model(torch.from_numpy(vol).to(device))
    logits = logits.float().cpu().numpy().reshape(-1, 2)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    print(parse_all_output(probs))
    return probs


if __name__ == "__main__":
    main()
