"""Fine-tune engine (counterpart of octcubem_tpu/train/finetune_engine.py):
the train and predict steps, and the host-side epoch pieces.

Parity target: OCTCube/engine_finetune.py:386-494 (train_one_epoch: loss
dispatch, NaN handling) and the best-model loop of
main_finetune_downstream_inhouse_singlefold.py:640-780 (val-AUC best with
the AUPRC tie-break, the test split at each new best, early stopping).

The train step runs the model in training mode, so drop-path and the
dropout head draw their masks from ``state.generator``; bf16 activations,
fp32 params and optimizer, no loss scaler.  Its NaN guard is JAX's: where
the loss is not finite, the whole state keeps its values (params, both
AdamW moments, the optimizer's count, so the schedule's step and the bias
correction stay put, and the step count); only the generator moves on.
The guard lives on the device (``AdamW.step(ok=...)``): the step reads
nothing back to the host, so the caller may read step t-1's metrics after
issuing step t, as the JAX CLI does.  ``evaluate`` runs the model in eval
mode with no gradient.

Data parallelism (``mesh``): each rank holds its rows of the global
batch.  The criterion is taken over the global batch, as JAX's is: the
logits are gathered across the data axis with a gradient
(``core/multihost.all_gather_with_grad``, whose backward sums over the
ranks) and the targets without, so the weighted criteria that divide by
the batch's valid count (``weighted_label_smoothing_ce``,
``multi_task_loss``) see the global count, and every rank computes the
same loss.  The gradient is then the mean over every rank, reduced
before the global norm and AdamW, and the NaN guard's ``ok`` is the
global loss's, so every rank keeps or reverts together.  Drop-path and
the dropout head draw their masks for the rank's rows from the
replicated generator: every rank takes the first B_local rows of a
global draw, where JAX's rank r would take rows [r * B_local, (r + 1) *
B_local), so the two agree at rate 0 only.  A state sharded over fsdp
(``core/fsdp.shard_state``) runs the forward and backward inside
``fsdp.gathered``; the loss, and so ``ok``, is the global one on every
rank, so the ranks keep or revert their chunks together.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle

import numpy as np
import torch

from ..core import fsdp, multihost
from ..core.mesh import check_mesh, data_group
from . import metrics as metrics_lib
from .optim import grad_norm
from .train_state import TrainState


def make_finetune_train_step(model, tx, criterion, mesh=None):
    """-> step(state, batch, targets) -> (state, {"loss", "grad_norm",
    "finite"}): 0-d tensors on the model's device, read without a host
    sync.  ``tx`` is ``state.tx``, the AdamW over ``model``'s params.
    ``mesh``: the data-parallel mesh (module docstring)."""
    params = list(model.parameters())
    reduce = check_mesh(mesh)
    group = data_group(mesh) if reduce else None

    def step(state: TrainState, batch, targets):
        batch, targets = multihost.local(batch), multihost.local(targets)
        model.train()
        with fsdp.gathered(state, mesh):
            out = model(batch, state.generator)
            if isinstance(out, tuple):
                out = out[0]
            if reduce:
                out = multihost.all_gather_with_grad(out, group)
                targets = multihost.all_gather(targets, group)
            loss = criterion(out, targets)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = fsdp.mean_grads(state, params, grads, reduce)
        for p, g in zip(params, grads):
            p.grad = g
        ok = torch.isfinite(loss)
        gn = grad_norm(params, grads, state.shards)
        tx.step(ok=ok)
        if not torch.is_tensor(state.step):
            state.step = torch.tensor(int(state.step), device=loss.device)
        state.step = torch.where(ok, state.step + 1, state.step)
        return state, {"loss": loss.detach(), "grad_norm": gn, "finite": ok}

    return step


def make_predict_step(model):
    """-> predict(batch) -> logits: eval mode, no gradient."""

    def predict(batch):
        model.eval()
        with torch.no_grad():
            out = model(batch)
        return out[0] if isinstance(out, tuple) else out

    return predict


@dataclasses.dataclass
class BestTracker:
    """Val-best tracking with the reference's tie-breakers
    (main_finetune…singlefold.py:695-780): primary val AUROC (macro),
    tie-break on AUPRC; the test split is evaluated at each new val best;
    early stop after ``patience`` epochs without improvement."""

    patience: int | None = None
    best_auc: float = -1.0
    best_auprc: float = -1.0
    best_epoch: int = -1
    epochs_since_best: int = 0
    best_val_metrics: dict | None = None
    best_test_metrics: dict | None = None

    def update(self, epoch: int, val_metrics: dict) -> bool:
        """True if this epoch is a new best (the caller saves a checkpoint
        and runs the test split).  Classification ranks on (AUROC,
        AUPRC), regression on (pearson r, -MSE) (engine_finetune.py:
        642-678)."""
        if "pearson_r" in val_metrics:  # regression task mode
            auc = val_metrics.get("pearson_r", 0.0)
            auprc = -val_metrics.get("mse", float("inf"))
        else:
            auc = val_metrics.get("roc", {}).get("macro", 0.0)
            auprc = val_metrics.get("auprc", {}).get("macro", 0.0)
        improved = (auc > self.best_auc) or (
            auc == self.best_auc and auprc > self.best_auprc)
        if improved:
            self.best_auc, self.best_auprc = auc, auprc
            self.best_epoch = epoch
            self.epochs_since_best = 0
            self.best_val_metrics = val_metrics
        else:
            self.epochs_since_best += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return (self.patience is not None
                and self.epochs_since_best >= self.patience)


def evaluate(predict_step, batches, task_mode: str,
             threshold: float = 0.5) -> tuple[dict, np.ndarray, np.ndarray]:
    """Prediction over an iterable of (batch, target) pairs and the
    reference metric battery -> (metrics, y_true, y_pred); predictions
    come back as fp32."""
    preds, trues = [], []
    for batch, target in batches:
        out = predict_step(batch)
        preds.append(out.float().cpu().numpy())
        trues.append(np.asarray(target))
    y_pred = np.concatenate(preds, axis=0)
    y_true = np.concatenate(trues, axis=0)
    return (metrics_lib.compute_metrics(task_mode, y_true, y_pred, threshold),
            y_true, y_pred)


def dump_frame_inference(out_dir: str, mode: str, names, y_true, y_pred,
                         embeddings=None) -> str:
    """Per-sample inference dump to pkl (engine_finetune.py:680-688)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"frame_inference_{mode}.pkl")
    payload = {"names": list(names), "y_true": np.asarray(y_true),
               "y_pred": np.asarray(y_pred)}
    if embeddings is not None:
        payload["embeddings"] = np.asarray(embeddings)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def write_confusion_matrices(y_true, y_pred, task_mode: str, out_dir: str,
                             mode: str,
                             class_names: list[str] | None = None) -> list:
    """Per-eval confusion-matrix images (the reference's pycm JPEGs,
    engine_finetune.py:766-776, 805-808): one C x C matrix for
    multi-class; a 2 x 2 matrix per task or class for multi-task and
    multi-label; none for regression.  Returns the written paths."""
    from ..utils.visualization import save_confusion_matrix

    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    paths = []
    if task_mode == "regression":
        return paths
    if task_mode.startswith("multi_task"):
        num_tasks = y_true.shape[1] - 1
        logits = y_pred.reshape(y_pred.shape[0], num_tasks, 2)
        for i in range(num_tasks):
            t = np.stack([y_true[:, 0], y_true[:, i + 1]], axis=1)
            valid = t.sum(axis=1) > 0
            if valid.sum() == 0:
                continue
            name = class_names[i] if class_names else str(i)
            p = os.path.join(out_dir, f"confusion_{mode}_task{i}_{name}.png")
            save_confusion_matrix(t[valid, 1],
                                  logits[valid, i].argmax(axis=1),
                                  ["normal", name], p)
            paths.append(p)
        return paths
    if task_mode == "multi_label":
        pred = (y_pred > 0).astype(np.int64)  # logits: sigmoid > 0.5
        for i in range(y_true.shape[1]):
            name = class_names[i] if class_names else str(i)
            p = os.path.join(out_dir, f"confusion_{mode}_class{i}_{name}.png")
            save_confusion_matrix(y_true[:, i], pred[:, i], ["neg", name], p)
            paths.append(p)
        return paths
    n_cls = y_pred.shape[1]
    names = class_names or [str(i) for i in range(n_cls)]
    p = os.path.join(out_dir, f"confusion_{mode}.png")
    save_confusion_matrix(y_true.astype(np.int64), y_pred.argmax(axis=1),
                          names[:n_cls], p)
    paths.append(p)
    return paths


def write_metric_csvs(metrics: dict, out_dir: str, mode: str,
                      class_names: list[str] | None = None) -> None:
    """macro_metrics_{mode}.csv and the per-class CSVs
    (engine_finetune.py:708-765)."""
    os.makedirs(out_dir, exist_ok=True)
    scalar = {k: v for k, v in metrics.items() if isinstance(v, float)}
    macro = {k: v["macro"] for k, v in metrics.items()
             if isinstance(v, dict) and "macro" in v}
    with open(os.path.join(out_dir, f"macro_metrics_{mode}.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        keys = list(macro) + list(scalar)
        w.writerow(keys)
        w.writerow([macro.get(k, scalar.get(k)) for k in keys])
    n_cls = 0
    for v in metrics.values():
        if isinstance(v, dict) and "classwise" in v:
            n_cls = len(v["classwise"])
            break
    for i in range(n_cls):
        name = class_names[i] if class_names else str(i)
        with open(os.path.join(out_dir, f"class_{i}_{name}_metrics_{mode}.csv"),
                  "w", newline="") as f:
            w = csv.writer(f)
            keys = [k for k, v in metrics.items()
                    if isinstance(v, dict) and "classwise" in v]
            w.writerow(keys)
            w.writerow([metrics[k]["classwise"][i] for k in keys])
