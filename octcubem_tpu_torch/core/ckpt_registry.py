"""CV-fold checkpoint registry for evaluation (the port's copy of
octcubem_tpu/core/ckpt_registry.py, pure Python).

Parity target: retinal-COEM/src/open_clip/factory.py:63-130: JSON files
mapping each CV fold to its best-val / best-test checkpoint paths, used
to assemble per-fold models for ensemble evaluation.
"""

from __future__ import annotations

import json
import os


def save_ckpt_registry(path: str, entries: dict[int, dict[str, str]]) -> None:
    """entries: {fold: {"best_val": ckpt_path, "best_test": ckpt_path}}"""
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in entries.items()}, f, indent=2)


def load_ckpt_registry(path: str) -> dict[int, dict[str, str]]:
    with open(path) as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}


def cv_fold_ckpt_paths(registry_path: str, criterion: str = "best_val"
                       ) -> list[str]:
    """Ordered per-fold checkpoint paths (factory.py
    get_model_ckpt_cv_fold_path_list)."""
    reg = load_ckpt_registry(registry_path)
    return [reg[fold][criterion] for fold in sorted(reg)]


def scan_ckpt_registries(dir_path: str) -> dict[str, str]:
    """{name: path} for every *.json registry under dir_path."""
    if not os.path.isdir(dir_path):
        return {}
    return {f[:-5]: os.path.join(dir_path, f)
            for f in sorted(os.listdir(dir_path)) if f.endswith(".json")}
