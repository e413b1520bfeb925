"""Offline retrieval evaluation: laterality prediction from top-k
neighbors + top-3 retrieval panels (counterpart of
octcubem_tpu/cli/retrieval_eval.py; numpy on the host, matplotlib and PIL
imported inside the panel renderer).

    python -m octcubem_tpu_torch.cli.retrieval_eval \
        out/retrieval_results_0.pkl --topk 1 3 5 --panels_dir panels

Parity target: retinal-COEM/src/retDisease_eval/evaluate_results_test_
train_visualize_all_models_top3_col_aireadi_laterality.py: load the
retrieval features dumped by the retclip engine, predict each OCT
volume's laterality by majority vote over its top-k retrieved enface
images, report accuracy, and render top-3 retrieval panels.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def laterality_from_topk(img_feat: np.ndarray, enf_feat: np.ndarray,
                         enf_laterality: np.ndarray, k: int = 3) -> np.ndarray:
    """Predicted laterality per query by majority vote of top-k retrieved
    enface images (0 = OD, 1 = OS)."""
    logits = img_feat @ enf_feat.T
    topk = np.argsort(-logits, axis=1)[:, :k]
    votes = enf_laterality[topk]
    return (votes.mean(axis=1) > 0.5).astype(np.int64)


def evaluate_laterality(img_feat, enf_feat, img_laterality, enf_laterality,
                        ks=(1, 3, 5)) -> dict:
    out = {}
    img_laterality = np.asarray(img_laterality)
    for k in ks:
        pred = laterality_from_topk(img_feat, enf_feat,
                                    np.asarray(enf_laterality), k)
        out[f"laterality_acc@top{k}"] = float((pred == img_laterality).mean())
    return out


def top3_panels(img_feat, enf_feat, n_queries: int = 8) -> np.ndarray:
    """Indices [n_queries, 3] of the top-3 retrieved enface items for the
    first n_queries OCT queries (panel rendering is delegated to the
    caller, which owns the image data)."""
    logits = img_feat[:n_queries] @ enf_feat.T
    return np.argsort(-logits, axis=1)[:, :3]


def _load_panel_image(path: str | None):
    """Grayscale-ready array for a panel tile, or None.  Enface tiles are
    PNG/JPG; an OCT query path may be a frame PNG, a directory of frames
    (center frame shown), or an npy/dcm/mhd volume."""
    import glob
    import os

    if not path or not os.path.exists(path):
        return None
    if os.path.isdir(path):
        frames = sorted(glob.glob(os.path.join(path, "oct_*.png")))
        if not frames:
            return None
        path = frames[len(frames) // 2]
    if path.endswith((".npy", ".dcm", ".mhd")):
        from ..data import ingest

        if path.endswith(".npy"):
            vol = ingest.load_npy_volume(path)
        elif path.endswith(".dcm"):
            vol, _, _ = ingest.load_dicom_volume(path)
        else:
            vol = ingest.load_mhd_volume(path)
        return np.asarray(vol[len(vol) // 2], np.float32)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


def render_top3_panels(d: dict, out_dir: str, n_queries: int = 8,
                       enface_key: str = "enface") -> list[str]:
    """Query ground-truth enface + top-3 retrieved enface tiles, one PNG
    per query (reference get_ir_visualization, evaluate_results_…
    laterality.py:61-114: column 0 = paired IR ground truth, columns
    1..3 = top-k retrieved, saved per query under the query's id)."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = d["keys"]
    paths = d["paths"]
    img_feat = np.asarray(d["image"])
    enf_feat = np.asarray(d.get(enface_key, d.get("enface1")))
    idx = top3_panels(img_feat, enf_feat, n_queries=min(n_queries, len(keys)))
    enface_field = "enface1" if enface_key in ("enface", "enface1") \
        else "enface2"
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for q in range(idx.shape[0]):
        qkey = keys[q]
        tiles = [("Paired enface\n(Ground Truth)",
                  _load_panel_image(paths.get(qkey, {}).get(enface_field))
                  if paths.get(qkey, {}).get(enface_field)
                  else _load_panel_image(paths.get(qkey, {}).get("oct")))]
        for j, r in enumerate(idx[q]):
            rkey = keys[int(r)]
            tiles.append((f"Top {j + 1}\nretrieved",
                          _load_panel_image(
                              paths.get(rkey, {}).get(enface_field))))
        fig, ax = plt.subplots(1, len(tiles), figsize=(2 * len(tiles), 2.4))
        for a, (title, img) in zip(np.atleast_1d(ax), tiles):
            if img is not None:
                a.imshow(img, cmap="gray")
            a.set_title(title, fontsize=8)
            a.axis("off")
        fig.tight_layout()
        fname = os.path.join(out_dir,
                             f"panel_{qkey.replace('/', '_')}.png")
        fig.savefig(fname, dpi=100)
        plt.close(fig)
        written.append(fname)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser("retrieval laterality evaluation")
    parser.add_argument("features_pkl",
                        help="pickle with {'image': [N,D], 'enface': [N,D], "
                             "'image_laterality': [N], 'enface_laterality': [N]}"
                             " (+ 'keys'/'paths' from cli.retclip for panels)")
    parser.add_argument("--topk", type=int, nargs="+", default=[1, 3, 5])
    parser.add_argument("--panels_dir", default=None,
                        help="render query + top-3 retrieval panels here")
    parser.add_argument("--n_queries", type=int, default=8)
    args = parser.parse_args(argv)
    with open(args.features_pkl, "rb") as f:
        d = pickle.load(f)
    metrics = {}
    if "image_laterality" in d:
        metrics = evaluate_laterality(
            np.asarray(d["image"]),
            np.asarray(d.get("enface", d.get("enface1"))),
            d["image_laterality"], d["enface_laterality"],
            ks=tuple(args.topk))
        for k, v in metrics.items():
            print(f"{k}: {v:.4f}")
    elif not args.panels_dir:
        # laterality metrics are the default job; fail loudly on a pkl
        # that can't serve them rather than returning an empty result
        raise SystemExit(
            "pkl has no 'image_laterality'/'enface_laterality' — pass a "
            "laterality feature dump, or use --panels_dir for panel "
            "rendering only")
    if args.panels_dir:
        if "keys" not in d or "paths" not in d:
            raise SystemExit(
                "panel rendering needs 'keys'/'paths' in the pkl — rerun "
                "cli.retclip with --save_retrieval_results on real data")
        written = render_top3_panels(d, args.panels_dir,
                                     n_queries=args.n_queries)
        print(f"wrote {len(written)} panels to {args.panels_dir}")
        metrics["panels_written"] = len(written)
    return metrics


if __name__ == "__main__":
    main()
