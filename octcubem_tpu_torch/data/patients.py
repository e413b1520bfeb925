"""Patient/visit-indexed OCT datasets, labels, and splits (counterpart of
octcubem_tpu/data/patients.py; plain numpy, item for item the same).

Parity targets:
- PatientDataset3D / PatientDatasetCenter2D (OCTCube/util/
  PatientDataset.py:514-1391): frame / volume / dicom source modes,
  patient vs visit iteration, center-B-scan extraction.
- PatientDataset*_inhouse (OCTCube/util/PatientDataset_inhouse.py):
  metadata-pickle patient->visit dicts, task-mode label construction
  (:125-154), normal-case downsampling (:279-332), visit expansion.
- k-fold / single-fold patient splits
  (main_finetune_downstream_inhouse_singlefold.py:294-316).

Directory layout convention (same as the reference's in-house data):
root/patient_id/[visit_id/]oct_000.png ...; or one .npy / .dcm per visit.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from typing import Any, Callable

import numpy as np

from . import ingest


@dataclasses.dataclass
class Visit:
    patient_id: str
    visit_id: str
    frames: list[str]               # file paths (PNGs) or [single npy/dcm]
    labels: dict[str, int] = dataclasses.field(default_factory=dict)
    metadata: dict = dataclasses.field(default_factory=dict)


def scan_directory(root: str, frame_glob: str = "*.png") -> list[Visit]:
    """Walk root/patient[/visit]/frames into Visit records."""
    visits = []
    for pid in sorted(os.listdir(root)):
        pdir = os.path.join(root, pid)
        if not os.path.isdir(pdir):
            continue
        subdirs = sorted(d for d in os.listdir(pdir)
                         if os.path.isdir(os.path.join(pdir, d)))
        if subdirs:
            for vid in subdirs:
                frames = sorted(glob.glob(os.path.join(pdir, vid, frame_glob)))
                other = sorted(glob.glob(os.path.join(pdir, vid, "*.npy"))
                               + glob.glob(os.path.join(pdir, vid, "*.dcm")))
                if frames or other:
                    visits.append(Visit(pid, vid, frames or other))
        else:
            frames = sorted(glob.glob(os.path.join(pdir, frame_glob)))
            other = sorted(glob.glob(os.path.join(pdir, "*.npy"))
                           + glob.glob(os.path.join(pdir, "*.dcm")))
            if frames or other:
                visits.append(Visit(pid, "0", frames or other))
    return visits


def load_metadata_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def inhouse_frame_paths(patient_id: str, visit_hash: str, prefix: str = "",
                        midfix: str = "/macOCT/", num_frames: int = 61,
                        mode: str = "oct_img") -> list[str]:
    """Frame-path convention of the in-house trees
    (get_file_list_given_patient_and_visit_hash,
    PatientDataset_inhouse.py:27-36): {prefix}{patient}{midfix}{visit}/
    oct-%03d.png for volumes, ir.png for the paired en face image."""
    d = prefix + patient_id + midfix + visit_hash
    if mode == "ir_img":
        return [d + "/ir.png"]
    return [d + f"/oct-{i:03d}.png" for i in range(num_frames)]


def load_inhouse_metadata(metadata_dir: str, task_mode: str = "multi_label",
                          disease: str = "AMD",
                          patient_id_list_dir: str = "multi_cls_expr_10x_0315/",
                          patient_dict_fname: str =
                          "patient_dict_w_metadata_first_visit_from_ir.pkl",
                          frame_prefix: str = "", midfix: str = "/macOCT/",
                          num_frames: int = 61,
                          ) -> tuple[list[Visit], list[str]]:
    """Schema-aware in-house metadata ingestion
    (PatientDataset_inhouse.py:160-290), replacing the bare pickle.load:

    - ``patient_dict_w_metadata*.pkl``: {patient_id: [visit_hash, ...]}
    - binary_cls: ``{disease}_w_disease.txt`` / ``_wo_disease.txt``
      patient-id lists under patient_id_list_dir (:181-193)
    - multi_label / multi_task*: ``multilabel_cls_dict.json`` with
      {"disease_list": [...], "patient_dict": {pid: [0/1 per disease]}},
      sorted by patient id (:199-207)

    Returns (visits, disease_list): one Visit per (patient, visit-hash)
    in patient order — the reference's visit-index expansion
    (mapping_patient2visit, :216-236) — with labels attached so
    build_labels() and kfold_patient_split() consume them directly.
    """
    import json

    pd_path = os.path.join(metadata_dir, patient_dict_fname)
    patient_dict = load_metadata_pickle(pd_path)
    list_dir = os.path.join(metadata_dir, patient_id_list_dir)

    def make_visits(pid: str, labels: dict) -> list[Visit]:
        out = []
        for vh in patient_dict.get(pid, []):
            frames = inhouse_frame_paths(pid, vh, frame_prefix, midfix,
                                         num_frames)
            out.append(Visit(pid, vh, frames, dict(labels)))
        return out

    visits: list[Visit] = []
    if task_mode == "binary_cls":
        def read_ids(fname):
            with open(os.path.join(list_dir, fname)) as f:
                return [line.strip() for line in f if line.strip()]

        for pid in read_ids(f"{disease}_w_disease.txt"):
            visits += make_visits(pid, {disease: 1})
        for pid in read_ids(f"{disease}_wo_disease.txt"):
            visits += make_visits(pid, {disease: 0})
        return visits, ["NC", disease]

    if task_mode == "multi_cls":
        raise NotImplementedError(
            "multi_cls id lists are unimplemented in the reference too "
            "(PatientDataset_inhouse.py:194,296)")

    with open(os.path.join(list_dir, "multilabel_cls_dict.json")) as f:
        ml = json.load(f)
    disease_list = ml["disease_list"]
    for pid in sorted(ml["patient_dict"]):
        vec = ml["patient_dict"][pid]
        labels = {d: int(v) for d, v in zip(disease_list, vec)}
        visits += make_visits(pid, labels)
    return visits, disease_list


def build_labels(visits: list[Visit], task_mode: str, disease: str = "AMD",
                 disease_list: tuple[str, ...] = ("AMD", "DME", "POG", "MH")):
    """Task-mode label construction (PatientDataset_inhouse.py:125-154).

    binary_cls  -> int {0: NC, 1: disease}
    multi_cls   -> int index into disease_list
    multi_label / multi_task -> [1 + len(disease_list)] vector with
                   column 0 = normal indicator.
    Returns (class_to_idx, label_fn(visit) -> label array/int).
    """
    if task_mode == "binary_cls":
        class_to_idx = {"NC": 0, disease: 1}

        def label_fn(v: Visit):
            return np.int64(v.labels.get(disease, 0))
    elif task_mode == "multi_cls":
        class_to_idx = {d: i for i, d in enumerate(disease_list)}

        def label_fn(v: Visit):
            for i, d in enumerate(disease_list):
                if v.labels.get(d, 0):
                    return np.int64(i)
            return np.int64(0)
    else:  # multi_label / multi_task*
        class_to_idx = {d: i for i, d in enumerate(disease_list)}

        def label_fn(v: Visit):
            vec = np.zeros(1 + len(disease_list), np.float32)
            any_d = 0
            for i, d in enumerate(disease_list):
                vec[1 + i] = v.labels.get(d, 0)
                any_d |= int(vec[1 + i] > 0)
            vec[0] = 0.0 if any_d else 1.0
            return vec
    return class_to_idx, label_fn


def downsample_normal(visits: list[Visit], ratio: float,
                      seed: int = 0) -> list[Visit]:
    """Keep only `ratio` of all-normal patients
    (PatientDataset_inhouse.py:279-332)."""
    rng = np.random.default_rng(seed)
    normal = [v for v in visits if not any(v.labels.values())]
    abnormal = [v for v in visits if any(v.labels.values())]
    keep = rng.permutation(len(normal))[: int(len(normal) * ratio)]
    return abnormal + [normal[i] for i in sorted(keep)]


def kfold_patient_split(visits: list[Visit], k: int, fold: int,
                        seed: int = 0, val_frac: float = 0.5):
    """Patient-level k-fold: held-out fold is split into val/test halves
    (the reference's KFold + val/test split, main_…singlefold.py:294-316)."""
    pids = sorted({v.patient_id for v in visits})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pids))
    folds = np.array_split(order, k)
    held = set(folds[fold].tolist())
    train_p = {pids[i] for j, f in enumerate(folds) if j != fold for i in f}
    held_list = [pids[i] for i in folds[fold]]
    nval = int(len(held_list) * val_frac)
    val_p, test_p = set(held_list[:nval]), set(held_list[nval:])
    sel = lambda ps: [v for v in visits if v.patient_id in ps]
    return sel(train_p), sel(val_p), sel(test_p)


def single_fold_split(visits: list[Visit], train_ids, val_ids, test_ids):
    by = lambda ids: [v for v in visits if v.patient_id in set(ids)]
    return by(train_ids), by(val_ids), by(test_ids)


@dataclasses.dataclass
class PatientDataset3D:
    """3D volumes per visit. dataset_mode: 'frame' | 'volume' | 'dicom'."""

    visits: list[Visit]
    label_fn: Callable[[Visit], Any]
    dataset_mode: str = "frame"
    max_frames: int | None = 60
    transform: Callable | None = None
    mode: str = "gray"
    downsample_width: bool = True
    same_3_frames: bool = False
    volume_resize: tuple[int, int] | None = None
    return_patient_id: bool = False
    return_frame_paths: bool = False
    shift_mean_std: bool = True
    # variable_joint dual-resolution mode (PatientDataset_inhouse.py:418-527,
    # return_both_res_image/high_res_transform/high_res_num_frames): the
    # sample becomes a (low_res, high_res) pair — the same raw frames pushed
    # through a second transform, center-cropped to high_res_max_frames.
    return_both_res_image: bool = False
    high_res_transform: Callable | None = None
    high_res_max_frames: int | None = None
    seed: int = 0
    epoch: int = 0  # set by Loader.set_epoch; varies augmentation per epoch

    def __len__(self):
        return len(self.visits)

    def __getitem__(self, idx: int):
        v = self.visits[idx]
        rng = np.random.default_rng(
            (self.seed, self.epoch, idx, len(self.visits)))
        if self.dataset_mode == "frame":
            vol = ingest.load_frame_stack(v.frames, self.mode,
                                          self.downsample_width)
        elif self.dataset_mode == "volume":
            vol = ingest.load_npy_volume(v.frames[0], self.downsample_width,
                                         self.volume_resize)
        elif self.dataset_mode == "dicom":
            vol, _, _ = ingest.load_dicom_volume(
                v.frames[0], shift_mean_std=self.shift_mean_std,
                downsample_width=self.downsample_width)
        else:
            raise ValueError(self.dataset_mode)
        raw = vol
        if self.max_frames:
            vol = ingest.pad_or_crop_frames(vol, self.max_frames,
                                            self.same_3_frames)
        if self.transform is not None:
            vol = self.transform(vol, rng=rng)
        label = self.label_fn(v)
        # channel-last, as the models take it
        sample = vol[..., None] if vol.ndim == 3 else vol
        if self.return_both_res_image and self.high_res_transform is not None:
            hi = raw
            if self.high_res_max_frames:
                hi = ingest.pad_or_crop_frames(hi, self.high_res_max_frames,
                                               self.same_3_frames)
            hi = self.high_res_transform(hi, rng=rng)
            hi = hi[..., None] if hi.ndim == 3 else hi
            sample = (sample, hi)
        if self.return_frame_paths:
            # frame paths aligned with the (padded/cropped) frame axis —
            # the SPL hardness keys (reference keys all_image_dict by
            # frame path, engine_pretrain.py:133-146)
            paths = ingest.pad_or_crop_paths(
                v.frames if self.dataset_mode == "frame"
                else [v.frames[0]] * vol.shape[0],
                self.max_frames or vol.shape[0])
            return sample, tuple(paths), label
        if self.return_patient_id:
            return sample, v.patient_id, label
        return sample, label


@dataclasses.dataclass
class ImageFolderDataset:
    """class-folder image dataset (torchvision ImageFolder convention) —
    the generic 2D fine-tune / Kermany data path (OCTCube/util/
    datasets.py:12-18)."""

    root: str
    transform: Callable | None = None
    mode: str = "rgb"
    seed: int = 0
    epoch: int = 0

    def __post_init__(self):
        self.classes = sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            for f in sorted(os.listdir(os.path.join(self.root, c))):
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".tif")):
                    self.samples.append(
                        (os.path.join(self.root, c, f), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB" if self.mode == "rgb" else "L")
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        if self.transform is not None:
            arr = self.transform(
                arr, rng=np.random.default_rng((self.seed, self.epoch, i)))
        return arr, np.int64(label)


def attach_labels_from_csv(visits: list[Visit], csv_path: str,
                           id_col: str = "patient_id",
                           label_cols: list[str] | None = None,
                           visit_col: str | None = None) -> list[Visit]:
    """Attach labels from a CSV keyed by patient (and optionally visit) —
    the generic form of the per-dataset label loaders the reference's
    duke14/oimhs/umn/hcms mains hard-code.  Returns visits that matched a
    CSV row."""
    import csv as _csv

    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    if label_cols is None:
        skip = {id_col, visit_col}
        label_cols = [c for c in rows[0] if c not in skip]
    index: dict = {}
    for r in rows:
        key = (str(r[id_col]), str(r[visit_col])) if visit_col else str(r[id_col])
        index[key] = {c: int(float(r[c])) for c in label_cols if r.get(c, "") != ""}
    out = []
    for v in visits:
        key = (v.patient_id, v.visit_id) if visit_col else v.patient_id
        if key in index:
            v.labels.update(index[key])
            out.append(v)
    return out


def few_shot_subsample(visits: list[Visit], k_per_class: int,
                       label_fn: Callable, seed: int = 0) -> list[Visit]:
    """Few-shot sublists: keep k samples per class (the reference's
    generate_sublists family, OCTCube/util/misc.py:408-581, generalized)."""
    rng = np.random.default_rng(seed)
    by_class: dict = {}
    for v in visits:
        lab = label_fn(v)
        key = int(np.argmax(lab)) if np.ndim(lab) else int(lab)
        by_class.setdefault(key, []).append(v)
    out = []
    for key in sorted(by_class):
        group = by_class[key]
        idx = rng.permutation(len(group))[:k_per_class]
        out.extend(group[i] for i in sorted(idx))
    return out


@dataclasses.dataclass
class PatientDatasetCenter2D:
    """Center B-scan per visit (PatientDatasetCenter2D, :809-1391)."""

    visits: list[Visit]
    label_fn: Callable[[Visit], Any]
    transform: Callable | None = None
    mode: str = "gray"
    downsample_width: bool = True
    return_path: bool = False
    seed: int = 0
    epoch: int = 0

    def __len__(self):
        return len(self.visits)

    def __getitem__(self, idx: int):
        v = self.visits[idx]
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        center = v.frames[len(v.frames) // 2]
        img = ingest.load_frame_stack([center], self.mode,
                                      self.downsample_width)[0]
        if self.transform is not None:
            img = self.transform(img, rng=rng)
        if img.ndim == 2:
            img = img[..., None]
        label = self.label_fn(v)
        if self.return_path:
            return img, label, center
        return img, label
