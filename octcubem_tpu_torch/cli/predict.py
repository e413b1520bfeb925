"""Batch inference: a directory of OCT volumes -> predictions CSV
(counterpart of octcubem_tpu/cli/predict.py).

    python -m octcubem_tpu_torch.cli.predict data_root --ckpt model.pth
    python -m octcubem_tpu_torch.cli.predict data_root --quant int8
    python -m octcubem_tpu_torch.cli.predict data_root --export_aot m.octaot
    python -m octcubem_tpu_torch.cli.predict data_root --aot m.octaot

Walks a patient tree (PNG stacks, .npy or DICOM volumes;
data/patients.scan_directory), batches the volumes through the ViT-L
classifier (dropout head; bf16 by default, ``--precision fp32`` for the
parity path) and writes per-volume 8-disease probabilities, plus the
pre-head embeddings with ``--dump_embeddings``.  Every flag of the JAX
CLI, with its meaning.  ``--quant int8`` builds the float model, imports
the checkpoint and quantizes the block projections (ops/quant.py);
``--export_aot`` freezes the (logits, embedding) forward into an
artifact (compat/aot.py) and exits, ``--aot`` serves one (shapes from its
header).  Runs on the card unless ``--device cpu``.

Data-parallel serving (``--n_data N``, 0 = every rank): one process per
card (``torchrun --nproc_per_node N -m octcubem_tpu_torch.cli.predict
... --n_data N``).  As in the JAX CLI ``--batch_size`` is the global batch
and must divide over the N ranks; global batch k is volumes [k * B,
(k + 1) * B) and rank r predicts its rows [k * B + r * B / N, ...), its
tail padded.  Each batch's logits, embeddings and ids are gathered in
rank order, which is the global order, and rank 0 writes the CSV and the
embeddings; every rank returns the rows.

As in the JAX CLI the tail batch is padded to the batch size and the
host reads batch t-1's results only after batch t is issued; each batch
is copied to the card once, from pinned memory without a host wait.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np
import torch

DISEASES = ["DME", "AMD", "POAG", "EPM", "DR", "VD", "RAO_RVO", "RNV"]


class WithEmbeddings(torch.nn.Module):
    """The classifier's ``(logits, embedding)`` forward as a module (what
    ``--export_aot`` exports)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x, return_embeddings=True)


class _Rows:
    """The items of ``dataset`` at ``index``, in that order."""

    def __init__(self, dataset, index):
        self.dataset, self.index = dataset, index

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        return self.dataset[self.index[i]]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("OCTCube batch inference (PyTorch)")
    parser.add_argument("data_dir")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--out_csv", default="predictions.csv")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_frames", type=int, default=48)
    parser.add_argument("--input_size", type=int, default=256)
    parser.add_argument("--nb_classes", type=int, default=16)
    parser.add_argument("--precision", default="bf16")
    parser.add_argument("--quant", choices=["none", "int8"], default="none",
                        help="int8: quantize the block projections "
                             "(ops/quant.py); attention stays bf16 (B1)")
    parser.add_argument("--dump_embeddings", default=None,
                        help="optional .npz path for pre-head embeddings")
    parser.add_argument("--export_aot", default=None,
                        help="write a serving artifact of the (logits, "
                             "embedding) forward (compat/aot.py) instead of "
                             "predicting, then exit")
    parser.add_argument("--aot_platforms", default=None,
                        help="comma list for --export_aot ('cuda,cpu'); "
                             "default: the device it is exported on")
    parser.add_argument("--aot", default=None,
                        help="serve from an exported artifact instead of "
                             "building the model (shapes from its header)")
    parser.add_argument("--n_data", type=int, default=1,
                        help="data-parallel serving over N ranks, one "
                             "card each (0 = every rank)")
    parser.add_argument("--embed_dim", type=int, default=None)
    parser.add_argument("--depth", type=int, default=None)
    parser.add_argument("--num_heads", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights a checkpoint "
                             "does not replace")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    return parser


def build_model(args, device):
    """The ViT-ST classifier (dropout head) with seeded weights, the
    checkpoint imported as the JAX CLI imports it (geometry stamp first,
    ``strict=False``), then int8-quantized for ``--quant int8``."""
    from ..compat.torch_import import (check_geometry_stamp,
                                       load_reference_weights,
                                       load_torch_checkpoint)
    from ..models.vit_st import VisionTransformerST, create_model
    from ..ops.quant import quantize_state_dict

    dtype = torch.float32 if args.precision == "fp32" else torch.bfloat16
    model_kw = dict(
        num_frames=args.num_frames, t_patch_size=3, img_size=args.input_size,
        in_chans=1, num_classes=args.nb_classes,
        embed_dim=args.embed_dim or 1024, depth=args.depth or 24,
        num_heads=args.num_heads or 16, head_type="dropout", global_pool=True,
        dtype=dtype)
    model = create_model(VisionTransformerST, device=device, seed=args.seed,
                         **model_kw)
    if args.ckpt:
        check_geometry_stamp(args.ckpt, args.num_heads or 16)
        load_reference_weights(model, load_torch_checkpoint(args.ckpt),
                               strict=False)
    if args.quant == "int8":
        qmodel = create_model(VisionTransformerST, device=device,
                              seed=args.seed, quant=True, **model_kw)
        qmodel.load_state_dict(quantize_state_dict(model.state_dict()),
                               strict=True)
        model = qmodel
    return model


def main(argv=None):
    args = _parser().parse_args(argv)

    from ..core.device import resolve_device, to_device
    from ..core.runtime import setup_compilation_cache
    from ..data import loader as loader_lib, patients, transforms
    from ..utils.logging import Throughput, get_logger

    device = resolve_device(args.device)
    setup_compilation_cache(device=device)
    log = get_logger("predict")
    from ..core import multihost

    multihost.maybe_initialize(device)
    n_dev = args.n_data if args.n_data > 0 else multihost.world()[1]
    aot_fn = None
    if args.aot:
        from ..compat.aot import load_serving_artifact

        aot_fn, meta = load_serving_artifact(args.aot, device)
        b, t, s = meta["in_shapes"][0][:3]
        args.batch_size, args.num_frames, args.input_size = b, t, s
        args.nb_classes = meta.get("nb_classes", args.nb_classes)
        if args.n_data not in (0, 1):
            raise SystemExit("--aot serves single-device; drop --n_data")
        n_dev = 1
        log.info(f"serving from AOT artifact {args.aot} "
                 f"(batch {b}, {t}x{s}x{s}, {meta.get('quant')})")

    mesh, rank = None, 0
    if n_dev > 1 and not args.export_aot:
        from ..core.mesh import cli_mesh

        if args.batch_size % n_dev:
            raise SystemExit(
                f"--batch_size {args.batch_size} must be divisible by "
                f"the {n_dev}-rank data axis")
        mesh = cli_mesh(n_data=n_dev, device=device)
        rank = multihost.world()[0]
        log.info(f"serving data-parallel over {n_dev} ranks")
    local_b = args.batch_size // n_dev if mesh is not None else \
        args.batch_size
    ld = None
    n_batches = 0
    if not args.export_aot:
        visits = patients.scan_directory(args.data_dir, "*.png")
        if not visits:
            visits = patients.scan_directory(args.data_dir, "oct_*.png")
        if not visits:
            raise ValueError(f"no volumes found under {args.data_dir}")
        _, val_t = transforms.create_3d_transforms(
            args.input_size, args.num_frames, RandFlipd_prob=0)
        first = visits[0].frames[0]
        ds = patients.PatientDataset3D(
            visits, lambda v: np.int64(0), dataset_mode=(
                "dicom" if first.endswith(".dcm")
                else "volume" if first.endswith(".npy") else "frame"),
            max_frames=args.num_frames, transform=val_t,
            return_patient_id=True)
        n_batches = -(-len(ds) // args.batch_size)
        if mesh is not None:  # this rank's rows of every global batch
            ds = _Rows(ds, [i for i in range(len(ds))
                            if (i % args.batch_size) // local_b == rank])
        ld = loader_lib.Loader(ds, local_b, shuffle=False, drop_last=False,
                               num_workers=4, shard=(0, 1))

    if args.precision == "fp32":
        torch.backends.cuda.matmul.allow_tf32 = False
    shape = (local_b, args.num_frames, args.input_size, args.input_size, 1)
    if aot_fn is not None:
        predict = aot_fn
    else:
        model = WithEmbeddings(build_model(args, device))
        if args.export_aot:
            from ..compat.aot import export_serving_artifact

            platforms = (tuple(p.strip() for p in args.aot_platforms.split(","))
                         if args.aot_platforms else None)
            path = export_serving_artifact(
                model, (torch.zeros(shape, device=device),), args.export_aot,
                platforms=platforms,
                meta={"model": "vit_st", "nb_classes": args.nb_classes,
                      "quant": args.quant, "precision": args.precision})
            log.info(f"wrote AOT serving artifact {path}")
            return path

        def predict(x):
            with torch.inference_mode():
                return model(x)

    tput = Throughput()
    rows, embeddings = [], []

    def consume(logits, emb, pids):
        logits = logits.float().cpu().numpy()
        logits = logits[: len(pids)].reshape(len(pids), -1, 2)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True))[:, :, 1]
        for pid, p in zip(pids, probs):
            rows.append([pid] + [f"{v:.4f}" for v in p])
        embeddings.append(emb.float().cpu().numpy()[: len(pids)])
        tput.update(len(pids))
        return probs

    def gathered(logits, emb, pids):
        """The global batch's results in rank order (ids as lists)."""
        import torch.distributed as dist

        ids = [None] * n_dev
        dist.all_gather_object(ids, list(pids))
        keep = torch.cat([torch.arange(len(p)) + r * local_b
                          for r, p in enumerate(ids)])
        return (multihost.gather_rows(logits)[keep.to(logits.device)],
                multihost.gather_rows(emb)[keep.to(emb.device)],
                [p for part in ids for p in part])

    # one batch deep: batch t-1's results are read after batch t is issued
    probs = None
    pending = None
    batches = iter(ld)
    for _ in range(n_batches):
        vols, pids, _ = next(batches, (None, [], None))
        if vols is None:  # a rank with no rows in the tail batch
            vols = np.zeros(shape, np.float32)
        if vols.shape[0] < local_b:  # pad the tail batch
            pad = np.zeros((local_b - vols.shape[0],) + vols.shape[1:],
                           vols.dtype)
            vols = np.concatenate([vols, pad], 0)
        logits, emb = predict(to_device(vols.astype(np.float32), device))
        if mesh is not None:
            logits, emb, pids = gathered(logits, emb, pids)
        if pending is not None:
            probs = consume(*pending)
        pending = (logits, emb, pids)
    if pending is not None:
        probs = consume(*pending)
    if rank != 0:
        return rows
    with open(args.out_csv, "w", newline="") as f:
        w = csv.writer(f)
        names = (DISEASES if probs.shape[1] == len(DISEASES)
                 else [f"class_{i}" for i in range(probs.shape[1])])
        w.writerow(["patient_id"] + names)
        w.writerows(rows)
    if args.dump_embeddings:
        np.savez(args.dump_embeddings,
                 embeddings=np.concatenate(embeddings),
                 patient_ids=[r[0] for r in rows])
    log.info(f"wrote {len(rows)} predictions to {args.out_csv} "
             f"({tput.rate:.2f} volumes/s)")
    return rows


if __name__ == "__main__":
    main()
