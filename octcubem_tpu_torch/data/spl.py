"""Self-paced learning (SPL) state for the joint 2D branch (counterpart
of octcubem_tpu/data/spl.py).  The pickles ``all_image_dict-{epoch}.pkl``
keep the JAX package's layout ({name: {"hardness", "mse_loss",
"visited"}} of Python floats and ints), so an SPL dict passes between
the two packages both ways.

Parity target: Pre-training/custom_util/PatientDataset_pretrain.py:126-146
(all_image_dict hardness tracking, init_spl/update_spl top-K% selection)
and the per-epoch pickle checkpointing of the dict
(main_pretrain…py:469-489,660-687).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


class SPLState:
    """Tracks per-image hardness (MSE) and selects the top-K% hardest for
    the next epoch's 2D dataset."""

    def __init__(self, image_names: list[str]):
        self.hardness = {name: {"hardness": 0.0, "mse_loss": 0.0, "visited": 0}
                         for name in image_names}
        self.active: list[str] = list(image_names)

    def update_hardness(self, names: list[str], losses) -> None:
        """Write per-frame MSE back (engine_pretrain.py:133-146)."""
        for n, l in zip(names, np.asarray(losses).ravel()):
            if n in self.hardness:
                e = self.hardness[n]
                e["mse_loss"] = float(l)
                e["hardness"] = float(l)
                e["visited"] += 1

    def update_from_volume_losses(self, frame_paths, tube_losses,
                                  t_patch: int) -> None:
        """Write the 3D batch's per-temporal-tube MSEs into the
        frame-keyed hardness dict (engine_pretrain.py:133-146): tube k of
        volume j covers frames [k*t_patch, (k+1)*t_patch); each of those
        frame names gets the tube's loss.  Padded frames ('' paths) and
        names outside the dict are skipped."""
        tube_losses = np.asarray(tube_losses)
        for j, vol_paths in enumerate(frame_paths):
            for k, l in enumerate(tube_losses[j].ravel()):
                for fr in range(t_patch):
                    idx = k * t_patch + fr
                    if idx >= len(vol_paths):
                        break
                    name = vol_paths[idx]
                    if name in self.hardness:
                        e = self.hardness[name]
                        e["mse_loss"] = float(l)
                        e["hardness"] = float(l)
                        e["visited"] += 1

    def update_spl(self, k: float) -> list[str]:
        """Keep the top-K fraction hardest images
        (PatientDataset_pretrain.py:126-146). Returns the active list."""
        items = sorted(self.hardness.items(),
                       key=lambda kv: kv[1]["hardness"], reverse=True)
        n_keep = max(1, int(len(items) * k))
        self.active = [name for name, _ in items[:n_keep]]
        return self.active

    def save(self, out_dir: str, epoch: int) -> str:
        path = os.path.join(out_dir, f"all_image_dict-{epoch}.pkl")
        with open(path, "wb") as f:
            pickle.dump(self.hardness, f)
        return path

    def subset(self, dataset) -> "SPLSubset":
        """View of `dataset` restricted to the currently active (top-K
        hardest) images — the per-epoch 2D dataloader rebuild
        (main_pretrain…py:673-687)."""
        return SPLSubset(dataset, self)

    @classmethod
    def load(cls, path: str) -> "SPLState":
        with open(path, "rb") as f:
            d = pickle.load(f)
        obj = cls([])
        obj.hardness = d
        obj.active = list(d.keys())
        return obj


class Pretrain2DDataset:
    """Real 2D data for the joint high-res MAE branch: in-house center
    B-scans + an optional Kermany-style ImageFolder tree, concatenated
    (Inhouse_and_Kermany_Dataset, PatientDataset_pretrain.py:60-91; built
    by the reference main at main_pretrain_oph_joint_2d512_flash_attn.py:
    313-330).

    Each item is one grayscale image augmented MAE-style (random resized
    crop, scale 0.2-1.0, + hflip), resized to ``size``², replicated to a
    T=``t_patch`` tube for the shared 3D patch embed, and paired with a
    stable name (the file path) for SPL hardness tracking.
    """

    def __init__(self, visits=None, kermany_root: str | None = None,
                 size: int = 512, t_patch: int = 3,
                 scale: tuple = (0.2, 1.0), train: bool = True,
                 downsample_width: bool = True, seed: int = 0,
                 as_tube: bool = True):
        self.size = size
        self.t_patch = t_patch
        self.as_tube = as_tube
        self.scale = scale
        self.train = train
        self.downsample_width = downsample_width
        self.seed = seed
        self.epoch = 0  # set by Loader.set_epoch
        self.entries: list[tuple[str, str]] = []  # (kind, path)
        for v in visits or []:
            # ALL frames of every visit (get_all_image_list_and_dict,
            # PatientDataset_pretrain.py:118) — the SPL dict is keyed by
            # frame path and hardness comes from the 3D batch's tubes
            for f in v.frames:
                self.entries.append(("frame", f))
        if kermany_root:
            for dirpath, _, files in sorted(os.walk(kermany_root)):
                for f in sorted(files):
                    if f.lower().endswith(
                            (".png", ".jpg", ".jpeg", ".bmp", ".tif")):
                        self.entries.append(
                            ("image", os.path.join(dirpath, f)))
        self.names = [path for _, path in self.entries]

    def __len__(self):
        return len(self.entries)

    def _load(self, kind: str, path: str) -> np.ndarray:
        if kind == "frame":
            from . import ingest

            return ingest.load_frame_stack([path], "gray",
                                           self.downsample_width)[0]
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32) / 255.0

    def __getitem__(self, i: int):
        from .np_resize import resize_bilinear_np

        kind, path = self.entries[i]
        img = self._load(kind, path)  # [H, W] in [0, 1]
        h, w = img.shape
        if self.train:
            rng = np.random.default_rng((self.seed, self.epoch, i))
            area = h * w * rng.uniform(*self.scale)
            side = np.sqrt(area)
            ch, cw = min(h, int(round(side))), min(w, int(round(side)))
            top = rng.integers(0, h - ch + 1)
            left = rng.integers(0, w - cw + 1)
            img = img[top:top + ch, left:left + cw]
            if rng.random() < 0.5:
                img = img[:, ::-1]
        img = resize_bilinear_np(img[None], (self.size, self.size))[0]
        if not self.as_tube:  # plain 2D MAE ([S, S, 1])
            return img[:, :, None].astype(np.float32), self.names[i]
        tube = np.repeat(img[None, :, :, None], self.t_patch, axis=0)
        return tube.astype(np.float32), self.names[i]


class SPLSubset:
    """Name-indexed subset of a (sample, name) dataset following the SPL
    active list.  The view is live: update_spl() changes what it serves."""

    def __init__(self, dataset, state: SPLState):
        self.dataset = dataset
        self.state = state
        self._index = {name: i for i, name in enumerate(dataset.names)}

    def __len__(self):
        return len(self.state.active)

    def __getitem__(self, i):
        return self.dataset[self._index[self.state.active[i]]]
