"""AI-READI cross-device dataset support (counterpart of
octcubem_tpu/data/aireadi.py; plain Python on ``patients.Visit``).

Parity target: OCTCube/util/PatientDataset.py:1392-1585
(get_aireadi_patient_dict / filter_aireadi_patient_dict) and the
cross-device fine-tune mains (main_finetune_downstream_aireadi_correct_
visit.py): build a patient -> visit index from the AI-READI DICOM
manifest, filter by device (Spectralis / Maestro2 / Triton / Cirrus),
anatomic region and laterality, and produce visit-correct splits (all
visits of a patient stay on one side of the split).
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from .patients import Visit

DEVICES = ("Spectralis", "Maestro2", "Triton", "Cirrus")
DEVICE_MANUFACTURER = {
    "Spectralis": "Heidelberg",
    "Maestro2": "Topcon",
    "Triton": "Topcon",
    "Cirrus": "Zeiss",
}


def load_manifest(path: str) -> list[dict]:
    """Manifest rows with at least: participant_id, manufacturers_model_name,
    filepath; optional: laterality, anatomic_region, visit (tsv/csv/json)."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    delim = "\t" if path.endswith(".tsv") else ","
    with open(path) as f:
        return list(csv.DictReader(f, delimiter=delim))


def build_aireadi_visits(manifest: list[dict], data_root: str = "",
                         device: str | None = None,
                         laterality: str | None = None,
                         anatomic_region: str | None = None) -> list[Visit]:
    """Filtered Visit records; one visit per manifest row."""
    visits = []
    for row in manifest:
        model = row.get("manufacturers_model_name", row.get("device", ""))
        if device is not None and model != device:
            continue
        if laterality is not None and \
                row.get("laterality", "").upper() != laterality.upper():
            continue
        if anatomic_region is not None and \
                row.get("anatomic_region", "") != anatomic_region:
            continue
        pid = str(row.get("participant_id", row.get("patient_id")))
        path = os.path.join(data_root, row["filepath"])
        visits.append(Visit(
            patient_id=pid,
            visit_id=str(row.get("visit", row.get("visit_id", "0"))),
            frames=[path],
            labels={k: _to_int(v) for k, v in row.items()
                    if k.startswith("label_")},
            metadata={"manufacturer": DEVICE_MANUFACTURER.get(model, ""),
                      "manufacturers_model_name": model,
                      "laterality": row.get("laterality", "")},
        ))
    return visits


def _to_int(v):
    try:
        return int(float(v))
    except (TypeError, ValueError):
        return 0


def visit_correct_split(visits: list[Visit], val_frac: float = 0.2,
                        test_frac: float = 0.2, seed: int = 0):
    """Patient-level (visit-correct) train/val/test split: every visit of a
    patient lands on the same side (the 'correct_visit' fix the reference
    mains carry in their names)."""
    pids = sorted({v.patient_id for v in visits})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pids))
    n_test = int(len(pids) * test_frac)
    n_val = int(len(pids) * val_frac)
    test_p = {pids[i] for i in order[:n_test]}
    val_p = {pids[i] for i in order[n_test:n_test + n_val]}
    train_p = {pids[i] for i in order[n_test + n_val:]}
    sel = lambda ps: [v for v in visits if v.patient_id in ps]
    return sel(train_p), sel(val_p), sel(test_p)
