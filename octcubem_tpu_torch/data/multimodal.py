"""Paired multimodal dataset: OCT volume <-> en face IR / FAF (counterpart
of octcubem_tpu/data/multimodal.py; numpy samples, PIL imported inside
the en face loader).

Parity target: retinal-COEM/src/training/multimodal_dataset.py
(OphthalDataset, 1549 LoC): the reference enumerates 13 mode combinations
over OCT3D / paired-IR / FAF / standalone-IR; here one dataset covers
them via modality presence flags, matching custom_collate_fn's
(data_dict, (names, modality_flags)) contract (:319-362).

Directory layout per eye/visit:
    root/patient/visit/
        oct_000.png ...            (or volume.npy / scan.dcm)
        ir.png                     (en face infrared)
        faf.png                    (fundus autofluorescence, optional)
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable

import numpy as np

from . import ingest
from .patients import Visit, scan_directory


@dataclasses.dataclass
class PairedRecord:
    visit: Visit
    ir_path: str | None
    faf_path: str | None


def scan_paired_directory(root: str, frame_glob: str = "oct_*.png",
                          ir_name: str = "ir.png",
                          faf_name: str = "faf.png") -> list[PairedRecord]:
    records = []
    for v in scan_directory(root, frame_glob):
        base = os.path.dirname(v.frames[0])
        ir = os.path.join(base, ir_name)
        faf = os.path.join(base, faf_name)
        records.append(PairedRecord(
            v, ir if os.path.exists(ir) else None,
            faf if os.path.exists(faf) else None))
    return records


def _load_enface(path: str, size: int) -> np.ndarray:
    from PIL import Image

    from .np_resize import resize_bilinear_np

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    img = resize_bilinear_np(np.moveaxis(img, -1, 0), (size, size))
    return np.ascontiguousarray(np.moveaxis(img, 0, -1))


# the reference's 13 explicit modes (multimodal_dataset.py:661-675); the
# dataset below keys behavior on the NAME, and the int aliases keep the
# reference's --multimodal_type numbering working
MODE_MAPPING = {
    0: "pair_ir_only",
    1: "faf_only",
    2: "standalone_ir_only",
    3: "all_ir_only",
    4: "all_enface_images",
    5: "standalone_ir_only_with_faf",
    6: "oct3d_only",
    7: "oct3d_ir",
    8: "oct3d_faf_only",
    9: "oct3d_paired_faf_cls",
    10: "oct3d_paired_ir_cls",
    11: "oct3d_faf_ir",
    12: "oct3d_paired_faf_ir_cls",
}
_ENFACE_ONLY_MODES = {"pair_ir_only", "faf_only", "standalone_ir_only",
                      "all_ir_only", "all_enface_images",
                      "standalone_ir_only_with_faf"}


def convert_hw_shape(oct_volume: np.ndarray, rng=None,
                     verbose_level: int = 0) -> np.ndarray:
    """Aspect-aware OCT shape normalization
    (multimodal_dataset.py:381-442): device-specific frame counts
    (19/25/49/61/97/121/193) and widths (512/768/1024/1536) are folded to
    a common 60/61 x H x 768 geometry by paired-frame averaging, edge
    drops and symmetric zero padding, BEFORE the trilinear resize.

    rng: randomness source for the coin-flip edge drop (the reference
    uses np.random directly; pass a Generator for determinism)."""
    rng = rng or np.random.default_rng()
    h, _, w = oct_volume.shape
    if w in (1536, 1024):
        oct_volume = (oct_volume[:, :, ::2] + oct_volume[:, :, 1::2]) / 2
    if h in (61, 49, 25, 121, 97):
        if rng.random() > 0.5:
            oct_volume = oct_volume[:-1]
        else:
            oct_volume = oct_volume[1:]
    if h == 193:
        oct_volume = oct_volume[:-1]
        oct_volume = (oct_volume[::2] + oct_volume[1::2]) / 2
    if h in (121, 97, 193):
        oct_volume = (oct_volume[::2] + oct_volume[1::2]) / 2
    if h == 25:
        oct_volume = np.pad(oct_volume, ((3, 3), (0, 0), (0, 0)))
    if h == 19:
        oct_volume = np.pad(oct_volume, ((6, 5), (0, 0), (0, 0)))
    if h in (49, 97, 48):
        oct_volume = np.pad(oct_volume, ((6, 6), (0, 0), (0, 0)))
    if oct_volume.dtype == np.uint8:
        oct_volume = oct_volume.astype(np.float32)
    if w in (512, 1024):
        oct_volume = np.pad(oct_volume, ((0, 0), (0, 0), (128, 128)))
    return oct_volume


@dataclasses.dataclass
class PairedOCTEnfaceDataset:
    """Yields {'image', 'enface1', 'enface2', 'weight1', 'weight2',
    '__key__'} samples; missing modalities are zero-filled with weight 0
    (the 3-mod loss masks them, clip_engine.three_modality_clip_loss).

    `mode` selects the reference's mode semantics (MODE_MAPPING, int or
    name): enface-only modes serve IR/FAF images without volumes and
    filter records to ones carrying that modality; oct3d_* modes require
    (and serve) the volume; *_faf* modes require FAF; *_cls modes
    additionally expect labels_fn."""

    records: list[PairedRecord]
    num_frames: int = 60
    oct_size: int = 256
    enface_size: int = 384
    oct_transform: Callable | None = None
    require_ir: bool = True
    labels_fn: Callable | None = None
    mode: int | str = "oct3d_ir"
    aspect_aware: bool = False   # convert_hw_shape before the resize
    # bumped by Loader.set_epoch (and AggregatedPairedDataset.epoch) so
    # per-item augmentation rngs redraw every epoch — a (seed, idx)-only
    # rng would repeat the identical crop/flip forever (loader.py:65-69)
    epoch: int = 0

    def __post_init__(self):
        self.mode = MODE_MAPPING.get(self.mode, self.mode)
        if self.mode not in MODE_MAPPING.values():
            raise ValueError(f"unknown multimodal mode {self.mode!r}")
        # oct3d_faf_ir (mode 11, the 3-mod trainer) keeps records with a
        # missing FAF — per-sample presence weights mask the loss
        needs_ir = self.mode in (
            "pair_ir_only", "standalone_ir_only", "all_ir_only",
            "standalone_ir_only_with_faf", "oct3d_ir",
            "oct3d_paired_ir_cls", "oct3d_paired_faf_ir_cls") or (
                self.require_ir and self.mode.startswith("oct3d"))
        needs_faf = self.mode in (
            "faf_only", "oct3d_faf_only", "oct3d_paired_faf_cls",
            "oct3d_paired_faf_ir_cls")
        if needs_ir:
            self.records = [r for r in self.records if r.ir_path is not None]
        if needs_faf:
            self.records = [r for r in self.records
                            if r.faf_path is not None]
        if self.mode == "all_enface_images":
            self.records = [r for r in self.records
                            if r.ir_path or r.faf_path]

    def __len__(self):
        return len(self.records)

    def _load_volume(self, r: PairedRecord, i: int) -> np.ndarray:
        v = r.visit
        first = v.frames[0]
        if os.path.isdir(first):
            # manifest rows may point at a visit DIRECTORY of PNG frames
            # (build_ga_manifest convention for frame-stack visits)
            import glob

            frames = sorted(glob.glob(os.path.join(first, "oct_*.png")))
            vol = ingest.load_frame_stack(frames)
        elif first.endswith(".npy"):
            vol = ingest.load_npy_volume(first)
        elif first.endswith(".dcm"):
            vol, _, _ = ingest.load_dicom_volume(first)
        elif first.endswith(".mhd"):
            vol = ingest.load_mhd_volume(first)
        else:
            vol = ingest.load_frame_stack(v.frames)
        if self.aspect_aware:
            vol = convert_hw_shape(
                vol, rng=np.random.default_rng((17, self.epoch, i)))
        vol = ingest.pad_or_crop_frames(vol, self.num_frames)
        if self.oct_transform is not None:
            vol = self.oct_transform(
                vol, rng=np.random.default_rng((self.epoch, i)))
        else:
            from .np_resize import resize_trilinear_np
            vol = resize_trilinear_np(
                vol, (self.num_frames, self.oct_size, self.oct_size))
        return vol

    def __getitem__(self, i):
        r = self.records[i]
        v = r.visit
        sample = {"__key__": f"{v.patient_id}/{v.visit_id}"}
        if self.mode not in _ENFACE_ONLY_MODES:
            vol = self._load_volume(r, i)
            sample["image"] = vol[..., None].astype(np.float32)
        es = self.enface_size
        if r.ir_path is not None:
            sample["enface1"] = _load_enface(r.ir_path, es)
            sample["weight1"] = np.float32(1.0)
        else:
            sample["enface1"] = np.zeros((es, es, 3), np.float32)
            sample["weight1"] = np.float32(0.0)
        if r.faf_path is not None:
            sample["enface2"] = _load_enface(r.faf_path, es)
            sample["weight2"] = np.float32(1.0)
        else:
            sample["enface2"] = np.zeros((es, es, 3), np.float32)
            sample["weight2"] = np.float32(0.0)
        if self.labels_fn is not None:
            sample["label"] = self.labels_fn(v)
        return sample


class OCTFAFIRClsDataset:
    """GA-growth / disease classification over paired OCT+FAF(+IR)
    volumes from a manifest table (OCTFAFIRClsDataset,
    multimodal_dataset.py:1303-1496): rows carry file-path columns
    (oct_file_path / faf_file_path / ir_file_path), label columns and an
    optional split column for cross-validation.

    - mode 9/10/12 semantics via PairedOCTEnfaceDataset.mode
    - labels standardized with the train-set mean/std (or preset values,
      so val/test reuse the train statistics, :1338-1350)
    - update_dataset_indexing('cv_train'|'cv_test', val_split) restricts
      the served rows to the CV side (:1394-1420)
    """

    def __init__(self, manifest_csv: str, parent_dir: str = "",
                 mode: int | str = 9, label_keys: list[str] | None = None,
                 num_frames: int = 60, oct_size: int = 256,
                 enface_size: int = 384, split_key: str = "split1",
                 preset_label_mean=None, preset_label_std=None,
                 standardize: bool = True, aspect_aware: bool = False):
        import csv

        mode = MODE_MAPPING.get(mode, mode)
        assert mode in ("oct3d_paired_faf_cls", "oct3d_paired_ir_cls",
                        "oct3d_paired_faf_ir_cls"), mode
        with open(manifest_csv) as f:
            self.rows = list(csv.DictReader(f))
        assert label_keys, "label_keys required for the cls dataset"
        self.label_keys = list(label_keys)
        self.mode = mode
        self.num_frames, self.oct_size = num_frames, oct_size
        self.enface_size = enface_size
        self.aspect_aware = aspect_aware

        def path(row, key):
            p = row.get(key, "") or ""
            return os.path.join(parent_dir, p) if p else None

        self.records = []
        for i, row in enumerate(self.rows):
            v = Visit(row.get("patient_id", str(i)),
                      row.get("visit_id", "0"),
                      [path(row, "oct_file_path")])
            self.records.append(PairedRecord(
                v, path(row, "ir_file_path"), path(row, "faf_file_path")))

        labels = np.asarray(
            [[float(r[k]) for k in self.label_keys] for r in self.rows],
            np.float32)
        self.label_mean = (np.asarray(preset_label_mean, np.float32)
                           if preset_label_mean is not None
                           else labels.mean(axis=0))
        self.label_std = (np.asarray(preset_label_std, np.float32)
                          if preset_label_std is not None
                          else labels.std(axis=0))
        self.labels = ((labels - self.label_mean)
                       / np.maximum(self.label_std, 1e-6)
                       if standardize else labels)

        self.split_list = [int(float(r.get(split_key, 0) or 0))
                           for r in self.rows]
        self.available_split = sorted(set(self.split_list))
        self.indexing = "all"
        self._index = list(range(len(self.rows)))

        # require_ir=False: the mode itself declares which paths it needs
        # (mode 9 pairs OCT with FAF only; 10/12 require IR explicitly)
        self._inner = PairedOCTEnfaceDataset(
            list(self.records), num_frames=num_frames, oct_size=oct_size,
            enface_size=enface_size, mode=mode, aspect_aware=aspect_aware,
            require_ir=False)
        assert len(self._inner) == len(self.records), \
            "cls manifest rows must carry the paths their mode requires"

    def cv_indices(self, val_split: int) -> tuple[list[int], list[int]]:
        """(train_rows, val_rows) for one CV fold — the snapshot form of
        update_dataset_indexing('cv_train'/'cv_test', val_split)
        (multimodal_dataset.py:1394-1420) so both sides can be served
        from one instance simultaneously."""
        tr = [i for i, s in enumerate(self.split_list) if s != val_split]
        va = [i for i, s in enumerate(self.split_list) if s == val_split]
        return tr, va

    def raw_label_stats(self, rows: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Mean/std of the (unstandardized) labels over `rows` — the
        reference standardizes val/test with the TRAIN-set statistics
        (multimodal_dataset.py:1338-1350 preset_label_mean/std).
        Requires standardize=False at construction."""
        sub = self.labels[rows]
        return sub.mean(axis=0), np.maximum(sub.std(axis=0), 1e-6)

    def update_dataset_indexing(self, indexing: str = "all",
                                val_split: int = 0) -> None:
        self.indexing = indexing
        if indexing == "all":
            self._index = list(range(len(self.rows)))
        elif indexing == "cv_train":
            self._index = [i for i, s in enumerate(self.split_list)
                           if s != val_split]
        elif indexing == "cv_test":
            self._index = [i for i, s in enumerate(self.split_list)
                           if s == val_split]
        else:
            raise ValueError(indexing)

    def __len__(self):
        return len(self._index)

    def __getitem__(self, i):
        j = self._index[i]
        sample = self._inner[j]
        sample["label"] = self.labels[j]
        return sample

    # epoch propagation hook for Loader.set_epoch (forwards to the inner
    # paired dataset, whose augmentation rngs are epoch-seeded)
    @property
    def epoch(self):
        return self._inner.epoch

    @epoch.setter
    def epoch(self, e):
        self._inner.epoch = e


class AggregatedPairedDataset:
    """Multi-source concatenation behind one loader (AggregatedDataset,
    multimodal_dataset.py:538-650): cumulative-size index dispatch into
    the child datasets, with the originating source recorded per sample
    as ``dataset_idx`` — the reference's custom_collate_fn carries the
    same field in its info tuple (:319-362).

    Children are PairedOCTEnfaceDataset-like (dict samples).  A shared
    ``mode`` is not enforced here; build each child with its own mode
    (the reference's get_data combined path builds per-source datasets
    too)."""

    def __init__(self, datasets: list):
        assert datasets, "need at least one source dataset"
        self.datasets = list(datasets)
        sizes = [len(d) for d in self.datasets]
        self.cumulative_sizes = np.cumsum(sizes).tolist()

    @property
    def records(self):
        # aggregated view so patient-level splitting keeps working
        out = []
        for d in self.datasets:
            out.extend(getattr(d, "records", []))
        return out

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int) -> tuple[int, int]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        for k, cum in enumerate(self.cumulative_sizes):
            if idx < cum:
                prev = self.cumulative_sizes[k - 1] if k else 0
                return k, idx - prev
        raise IndexError(idx)

    def __getitem__(self, idx):
        k, local = self._locate(idx)
        sample = dict(self.datasets[k][local])
        sample["dataset_idx"] = np.int32(k)
        # source-prefixed key: patient/visit ids are only unique within a
        # source, and retrieval dumps key rows globally
        if "__key__" in sample:
            sample["__key__"] = f"ds{k}/{sample['__key__']}"
        return sample

    def key_to_record(self) -> dict:
        """{prefixed __key__: PairedRecord} across all sources."""
        out = {}
        for di, child in enumerate(self.datasets):
            for r in getattr(child, "records", []):
                out[f"ds{di}/{r.visit.patient_id}/{r.visit.visit_id}"] = r
        return out

    # epoch propagation hook for Loader.set_epoch
    @property
    def epoch(self):
        return getattr(self.datasets[0], "epoch", 0)

    @epoch.setter
    def epoch(self, e):
        for d in self.datasets:
            if hasattr(d, "epoch"):
                d.epoch = e


def collate_paired(samples: list[dict]) -> tuple[dict, list[str]]:
    """Batch dict + keys, the custom_collate_fn contract
    (multimodal_dataset.py:319-362)."""
    keys = [s["__key__"] for s in samples]
    batch = {k: np.stack([s[k] for s in samples])
             for k in samples[0] if k != "__key__"}
    return batch, keys


def build_ga_manifest(parent_dir: str, out_csv: str,
                      labels_csv: str | None = None,
                      label_keys: list[str] | None = None,
                      n_splits: int = 5, seed: int = 0) -> int:
    """Walk a GA-study tree into the manifest CSV OCTFAFIRClsDataset
    consumes — the framework-side equivalent of the reference's
    dataset_management.py (oph_dataset index building + per-study split
    assignment, dataset_management.py:27-232; its S3/boto3 download
    plumbing and study-specific column cleanup are infrastructure, not
    framework, and are intentionally out of scope).

    Layout per visit dir (same convention as scan_paired_directory):
    oct frames (oct_*.png | *.npy | *.dcm | *.mhd), ir.png, faf.png.
    Optional labels_csv keyed by patient_id (and optionally visit_id)
    contributes the label columns; `split1` holds a patient-level
    n_splits-fold assignment (all of a patient's visits share a fold).
    Returns the number of manifest rows written.
    """
    import csv
    import glob

    from .patients import scan_directory

    visits = scan_directory(parent_dir, "oct_*.png")
    rows = []
    for v in visits:
        d = os.path.dirname(v.frames[0])
        oct_path = v.frames[0]
        if not oct_path.endswith(".png"):
            # single-file volumes (npy/dcm/mhd) come back as one entry
            others = (glob.glob(os.path.join(d, "*.npy"))
                      + glob.glob(os.path.join(d, "*.dcm"))
                      + glob.glob(os.path.join(d, "*.mhd")))
            oct_path = others[0] if others else oct_path
        ir = os.path.join(d, "ir.png")
        faf = os.path.join(d, "faf.png")
        rows.append({
            "patient_id": v.patient_id, "visit_id": v.visit_id,
            "oct_file_path": os.path.relpath(d, parent_dir),
            "ir_file_path": (os.path.relpath(ir, parent_dir)
                             if os.path.isfile(ir) else ""),
            "faf_file_path": (os.path.relpath(faf, parent_dir)
                              if os.path.isfile(faf) else ""),
        })

    label_cols: list[str] = []
    if labels_csv:
        with open(labels_csv) as f:
            lab_rows = list(csv.DictReader(f))
        label_cols = label_keys or [
            c for c in lab_rows[0] if c not in ("patient_id", "visit_id")]
        by_pid = {}
        for r in lab_rows:
            key = (str(r["patient_id"]), str(r.get("visit_id", "")))
            by_pid[key] = r
            by_pid.setdefault((str(r["patient_id"]), ""), r)
        rows = [dict(row, **{
            k: by_pid.get((row["patient_id"], row["visit_id"]),
                          by_pid.get((row["patient_id"], ""), {})).get(k, "")
            for k in label_cols}) for row in rows]
        rows = [r for r in rows if all(r[k] != "" for k in label_cols)]

    # patient-level fold assignment
    pids = sorted({r["patient_id"] for r in rows})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pids))
    fold_of = {pids[i]: int(j % n_splits)
               for j, i in enumerate(order)}
    for r in rows:
        r["split1"] = fold_of[r["patient_id"]]

    fieldnames = ["patient_id", "visit_id", "oct_file_path",
                  "ir_file_path", "faf_file_path"] + label_cols + ["split1"]
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)
    return len(rows)
