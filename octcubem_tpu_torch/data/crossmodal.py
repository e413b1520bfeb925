"""Cross-modality 3D datasets: nodule CT (MedMNIST) and cardiac
ultrasound (EchoNet) (counterpart of octcubem_tpu/data/crossmodal.py;
numpy, with cv2 imported only to decode a video).

Parity targets:
- OCTCube/util/MedMNISTDataset3D.py (NoduleMNIST3D wrapper): the medmnist
  package is absent here, so the reader consumes the underlying
  nodulemnist3d.npz layout directly ({split}_images [N,28,28,28],
  {split}_labels [N,1]).
- OCTCube/util/USDataset3D.py + assets/SLIViT/convert_avi_to_tiff.py /
  get_echonet_csv.py: EchoNet avi videos + FileList.csv with EF labels;
  avi decoding via cv2, imported inside ``EchoNetDataset._read_avi``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from .np_resize import resize_trilinear_np


@dataclasses.dataclass
class MedMNIST3DDataset:
    """NoduleMNIST3D-style npz volumes -> ([T, S, S, 1], label)."""

    npz_path: str
    split: str = "train"
    num_frames: int = 28
    input_size: int = 28
    transform: Optional[Callable] = None

    def __post_init__(self):
        data = np.load(self.npz_path)
        self.images = data[f"{self.split}_images"]
        self.labels = data[f"{self.split}_labels"].reshape(-1)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        vol = self.images[i].astype(np.float32) / 255.0  # [28, 28, 28]
        if (vol.shape[0] != self.num_frames
                or vol.shape[1] != self.input_size):
            vol = resize_trilinear_np(
                vol, (self.num_frames, self.input_size, self.input_size))
        if self.transform is not None:
            vol = self.transform(vol)
        return vol[..., None], np.int64(self.labels[i])


@dataclasses.dataclass
class EchoNetDataset:
    """EchoNet-Dynamic avi videos with EF regression labels.

    root/Videos/*.avi + root/FileList.csv (columns FileName, EF, Split).
    Returns ([T, S, S, 1], ef_float32) — the USDataset3D regression mode
    (--slivit_dataset us3d).

    In regression mode the reference standardizes EF as
    (EF - 60.0) / 12.371483 (USDataset3D.py:20-37, label_dtype='float'),
    so training targets sit at ~0±1 under the recipe blr; `standardize`
    mirrors that (default on).  De-standardize reported predictions with
    `ef_mean`/`ef_std` if raw-EF-unit metrics are wanted.
    """

    root: str
    split: str = "TRAIN"
    num_frames: int = 32
    input_size: int = 112
    transform: Optional[Callable] = None
    standardize: bool = True
    ef_mean: float = 60.0           # USDataset3D.py:20 (the hardcoded
    ef_std: float = 12.371483       # mean, not the data's 55.75)

    def __post_init__(self):
        self.items: list[tuple[str, float]] = []
        with open(os.path.join(self.root, "FileList.csv")) as f:
            for row in csv.DictReader(f):
                if row.get("Split", "").upper() == self.split.upper():
                    name = row["FileName"]
                    if not name.endswith(".avi"):
                        name += ".avi"
                    self.items.append(
                        (os.path.join(self.root, "Videos", name),
                         float(row["EF"])))

    def __len__(self):
        return len(self.items)

    def _read_avi(self, path: str) -> np.ndarray:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {path}")
        return np.stack(frames).astype(np.float32) / 255.0

    def __getitem__(self, i):
        path, ef = self.items[i]
        vol = self._read_avi(path)
        vol = resize_trilinear_np(
            vol, (self.num_frames, self.input_size, self.input_size))
        if self.transform is not None:
            vol = self.transform(vol)
        if self.standardize:
            ef = (ef - self.ef_mean) / self.ef_std
        return vol[..., None], np.float32(ef)
