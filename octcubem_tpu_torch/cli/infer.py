"""Single-volume 8-disease inference (counterpart of
octcubem_tpu/cli/infer.py): val-transform a volume to (48, 256, 256),
run the ViT-L spatiotemporal classifier (dropout head, global pool),
reshape the logits to (8, 2), softmax, print per-disease probabilities.

    python -m octcubem_tpu_torch.cli.infer volume.dcm --ckpt model.pth
    python -m octcubem_tpu_torch.cli.infer volume.npy --saliency_dir out/

Volumes are .npy [T, H, W] or uncompressed little-endian DICOM
(data/dicom.py).  ``--saliency_dir`` writes a Grad-CAM overlay PNG for
the top-probability disease (utils/saliency.py, rendered by
utils/visualization.py, which needs matplotlib).  Runs on the card
unless ``--device cpu``.  The JAX CLI's flags all parse with its
effect: ``--attn_impl`` reaches the model; ``--model`` and
``--drop_path`` are read and have no effect at inference, and
``--global_pool``, ``--sep_pos_embed`` and ``--cls_embed`` are on.
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
        head_type="dropout", global_pool=args.global_pool,
        sep_pos_embed=args.sep_pos_embed, cls_embed=args.cls_embed,
        drop_path_rate=args.drop_path, attn_impl=args.attn_impl,
        dtype=policy_from_name(args.precision).compute_dtype,
        capture_cam=bool(getattr(args, "saliency_dir", None)))
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
    """DICOM / .npy -> [1, T, H, W, 1] val-transformed volume (resize,
    /255)."""
    from ..data.transforms import create_3d_transforms

    if path.endswith(".npy"):
        vol = np.load(path).astype(np.float32)
    else:
        from ..data.dicom import read_dicom

        vol = read_dicom(path).pixel_array.astype(np.float32)
    _, val_t = create_3d_transforms(input_size=input_size,
                                    num_frames=num_frames, RandFlipd_prob=0)
    vol = val_t(vol) / 255.0
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
    parser.add_argument("volume", help=".dcm or .npy OCT volume [T, H, W]")
    parser.add_argument("--ckpt", default=None,
                        help="reference .pth (any layout the importer "
                             "reads); seeded random weights when absent")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model", default="flash_attn_vit_large_patch16",
                        help="read and unused, as in the JAX CLI (the "
                             "model is the ViT-L classifier)")
    parser.add_argument("--t_patch_size", type=int, default=3)
    parser.add_argument("--num_frames", type=int, default=48)
    parser.add_argument("--input_size", type=int, default=256)
    parser.add_argument("--nb_classes", type=int, default=16)
    parser.add_argument("--num_heads", type=int, default=16,
                        help="encoder heads; must match the checkpoint's "
                             "pretrain geometry")
    parser.add_argument("--drop_path", type=float, default=0.2,
                        help="the model's drop-path rate; no effect at "
                             "inference")
    parser.add_argument("--global_pool", action="store_true", default=True)
    parser.add_argument("--sep_pos_embed", action="store_true", default=True)
    parser.add_argument("--cls_embed", action="store_true", default=True)
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="fp32")
    parser.add_argument("--attn_impl", default="auto",
                        help="attention implementation (ops/attention.py): "
                             "auto | flash | naive | ...")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    parser.add_argument("--saliency_dir", default=None,
                        help="write a Grad-CAM overlay PNG for the "
                             "top-probability disease into this directory "
                             "(needs matplotlib)")
    args = parser.parse_args(argv)

    from ..core.runtime import setup_compilation_cache

    device = resolve_device(args.device)
    setup_compilation_cache(device=device)
    if args.precision == "fp32":
        # full-fp32 matmuls on the card (the parity path)
        torch.backends.cuda.matmul.allow_tf32 = False
    # read + preprocess the volume before building the model so bad
    # inputs fail fast
    vol = process_volume(args.volume, args.num_frames, args.input_size)
    model = build_model(args, device)
    x = torch.from_numpy(vol).to(device)
    with torch.inference_mode():
        logits = model(x)
    logits = logits.float().cpu().numpy().reshape(-1, 2)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    print(parse_all_output(probs))

    if args.saliency_dir:
        # Grad-CAM of the top-probability disease's 'disease' logit (the
        # (i, 1) column of the reshaped head), as heatmap overlays
        from ..utils.saliency import gradcam
        from ..utils.visualization import save_cam_overlays

        top = int(np.argmax(probs[:, 1]))
        t_grid = args.num_frames // args.t_patch_size
        s_grid = args.input_size // model.patch_size
        cam = gradcam(model, x, class_idx=2 * top + 1,
                      grid=(t_grid, s_grid, s_grid))
        name = DISEASES[1:][top] if top + 1 < len(DISEASES) else str(top)
        path = save_cam_overlays(vol[0, ..., 0], cam[0], args.saliency_dir,
                                 tag=f"cam_{name.replace(chr(92), '-')}")
        print(f"saliency overlay: {path}")
    return probs


if __name__ == "__main__":
    main()
