"""Evaluation metric battery (counterpart of octcubem_tpu/train/metrics.py),
host-side numpy + scipy only.

The JAX package computes these with scikit-learn, which the card's
machine does not have; this module computes the same numbers with numpy
(scipy for Pearson's r, as JAX calls it), following scikit-learn's
definitions step for step, its dtypes, orders of summation and undefined
cases included, so the two agree to rounding (tests/test_torch_port_
metrics.py holds them to 1e-12 on tied and untied scores):

- ROC AUC: the ROC curve at each distinct score (ties share a point),
  collinear points dropped, the trapezoid area; undefined (one class) ->
  ``_safe``'s 0.5;
- average precision: the uninterpolated sum over the precision-recall
  curve; the PR curve and its trapezoid AUC; max F1 along it;
- the confusion matrix, precision, recall, F1 (0 where undefined),
  Cohen's kappa, MCC, G-mean;
- R², explained variance (1 for a perfect fit, 0 where the target is
  constant), MSE, MAE, computed in the inputs' floating dtype.

Parity targets: OCTCube/engine_finetune.py (misc_measures_multi_task
:86-242, misc_measures_multi_label :251-343, misc_measures :346-382,
regression :642-678).  Each battery returns {metric: {"classwise": [...],
"macro": float}} so the engine writes the reference's macro and
per-class CSVs (:708-765).
"""

from __future__ import annotations

import numpy as np

METRIC_NAMES = [
    "acc", "roc", "auprc", "precision", "recall", "f1", "max_f1", "AP",
    "balanced_acc", "specificity", "sensitivity", "mcc", "G", "kappa",
]


def _safe(fn, default=0.0):
    try:
        v = fn()
        if v is None or (isinstance(v, float) and not np.isfinite(v)):
            return default
        return v
    except Exception:
        return default


def _clf_curve(y_true, score):
    """False and true positives at each distinct score, highest first
    (the last point takes every sample): -> (fps, tps) float64."""
    y = np.asarray(y_true).reshape(-1) == 1
    s = np.asarray(score).reshape(-1)
    if not np.all(np.isfinite(s)):
        raise ValueError("scores must be finite")
    # highest first; only each tie group's last cumulative count is read,
    # so the order within a group does not matter
    order = np.argsort(-s.astype(np.float64), kind="stable")
    s, y = s[order], y[order]
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y.astype(np.float64), dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def roc_auc(y_true, score) -> float:
    """Binary ROC AUC with ties; NaN when y_true holds one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fps, tps = _clf_curve(y_true, score)
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    return auc(fps / fps[-1], tps / tps[-1])


def pr_curve(y_true, score):
    """-> (precision, recall) from the highest threshold's end: recall
    decreasing, ending at (1, 0); recall is 1 throughout when y_true has
    no positive."""
    fps, tps = _clf_curve(y_true, score)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def average_precision(y_true, score) -> float:
    precision, recall = pr_curve(y_true, score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def auc(x, y) -> float:
    """Trapezoid area under y(x), x monotone either way."""
    x, y = np.asarray(x).reshape(-1), np.asarray(y).reshape(-1)
    if x.shape[0] < 2:
        raise ValueError("at least 2 points are needed to compute an AUC")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError("x is neither increasing nor decreasing")
    return float(direction * np.trapezoid(y, x))


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """[len(labels)]^2 counts, rows true, columns predicted; samples with
    a label outside ``labels`` are left out."""
    labels = list(labels)
    n = len(labels)
    cm = np.zeros((n, n), np.int64)
    pos = {v: i for i, v in enumerate(labels)}
    for t, p in zip(np.asarray(y_true).reshape(-1),
                    np.asarray(y_pred).reshape(-1)):
        if t in pos and p in pos:
            cm[pos[t], pos[p]] += 1
    return cm


def cohen_kappa(y1, y2) -> float:
    """Cohen's kappa over the union of both label sets; NaN when
    undefined."""
    labels = np.union1d(np.unique(y1), np.unique(y2))
    confusion = confusion_matrix(y1, y2, labels).astype(np.float64)
    n = confusion.shape[0]
    sum0 = confusion.sum(axis=0)
    sum1 = confusion.sum(axis=1)
    total = sum0.sum()
    if total == 0:
        return float("nan")
    expected = np.outer(sum0, sum1) / total
    w = np.ones((n, n), np.float64)
    np.fill_diagonal(w, 0)
    den = np.sum(w * expected)
    if den == 0:
        return float("nan")
    return float(1 - np.sum(w * confusion) / den)


def binary_task_metrics(y_true: np.ndarray, score: np.ndarray,
                        threshold: float = 0.5) -> dict[str, float]:
    """All metrics for one binary task. y_true in {0,1}; score = P(positive)."""
    pred = (score > threshold).astype(np.int64)
    eps = 1e-8
    cm = confusion_matrix(y_true, pred, labels=[0, 1])
    tn, fp, fn, tp = cm.ravel()
    sens = tp / (tp + fn + eps)
    spec = tn / (tn + fp + eps)
    prec = float(tp / (tp + fp)) if tp + fp else 0.0
    rec = float(tp / (tp + fn)) if tp + fn else 0.0
    f1_den = 2 * tp + fn + fp
    out = {
        "acc": float(np.average(np.asarray(y_true).reshape(-1) == pred)),
        "roc": _safe(lambda: roc_auc(y_true, score), 0.5),
        "precision": prec,
        "recall": rec,
        "f1": float(2 * tp / f1_den) if f1_den else 0.0,
        "AP": _safe(lambda: average_precision(y_true, score)),
        "balanced_acc": (sens + spec) / 2,
        "specificity": spec,
        "sensitivity": sens,
        "mcc": (tp * tn - fp * fn) / np.sqrt(
            (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn) + eps),
        "G": np.sqrt(rec * spec),
        "kappa": _safe(lambda: cohen_kappa(y_true, pred)),
    }
    try:
        pr, re = pr_curve(y_true, score)
        out["auprc"] = auc(re, pr)
        out["max_f1"] = float(np.max(2 * pr * re / (pr + re + eps)))
    except Exception:
        out["auprc"] = 0.0
        out["max_f1"] = 0.0
    return out


def multi_task_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                       threshold: float = 0.5) -> dict:
    """y_true [B, C] multi-label (col 0 = normal); y_pred [B, 2*(C-1)]
    logits.  Per task only the samples whose (normal, disease) one-hot
    is valid, a softmax over the pair, score = P(disease); a task whose
    valid samples hold one class is left out of the macro (nan in
    classwise), as the reference skips it."""
    num_tasks = y_true.shape[1] - 1
    logits = y_pred.reshape(y_pred.shape[0], num_tasks, 2).astype(np.float64)
    e = np.exp(logits - logits.max(axis=2, keepdims=True))
    prob = e / e.sum(axis=2, keepdims=True)

    per_task = {m: [] for m in METRIC_NAMES}
    included = []
    for i in range(num_tasks):
        t = np.stack([y_true[:, 0], y_true[:, i + 1]], axis=1)
        valid = t.sum(axis=1) > 0
        if valid.sum() == 0 or len(np.unique(t[valid, 1])) < 2:
            for m in METRIC_NAMES:
                per_task[m].append(float("nan"))
            continue
        included.append(i)
        tm = binary_task_metrics(t[valid, 1], prob[valid, i, 1], threshold)
        for m in METRIC_NAMES:
            per_task[m].append(tm.get(m, 0.0))
    return {m: {"classwise": per_task[m],
                "macro": (float(np.nanmean(per_task[m])) if included
                          else 0.0)}
            for m in METRIC_NAMES}


def multi_label_metrics(y_true: np.ndarray, score: np.ndarray,
                        threshold: float = 0.5) -> dict:
    """y_true [B, C] in {0,1}; score [B, C] probabilities."""
    per_cls = {m: [] for m in METRIC_NAMES}
    for i in range(y_true.shape[1]):
        tm = binary_task_metrics(y_true[:, i], score[:, i], threshold)
        for m in METRIC_NAMES:
            per_cls[m].append(tm.get(m, 0.0))
    return {m: {"classwise": per_cls[m], "macro": float(np.mean(per_cls[m]))}
            for m in METRIC_NAMES}


def ovr_macro_roc_auc(y_true: np.ndarray, prob: np.ndarray) -> float:
    """One-vs-rest macro ROC AUC over probabilities [B, C], with
    scikit-learn's ``roc_auc_score(multi_class="ovr")`` cases: defined
    only when y_true holds every one of C > 2 classes (ValueError
    otherwise, so ``_safe`` gives 0.5; at C = 2 it takes the binary
    route, which refuses a 2-column score)."""
    classes = np.unique(y_true)
    if prob.shape[1] <= 2 or len(classes) != prob.shape[1]:
        raise ValueError("y_true must hold every class of C > 2")
    if not np.allclose(1, prob.sum(axis=1)):
        raise ValueError("scores must be probabilities")
    cols = [roc_auc((y_true == c).astype(np.int64), prob[:, j])
            for j, c in enumerate(classes)]
    return float(np.average(cols))


def multi_class_metrics(y_true: np.ndarray, prob: np.ndarray) -> dict:
    """y_true [B] int labels; prob [B, C] softmax probabilities.
    One-vs-rest confusion-matrix stats (misc_measures, :346-382) + AUC."""
    n_cls = prob.shape[1]
    pred = prob.argmax(axis=1)
    per_cls = {m: [] for m in METRIC_NAMES}
    for i in range(n_cls):
        t = (y_true == i).astype(np.int64)
        tm = binary_task_metrics(t, prob[:, i], 0.5)
        tm["acc"] = float(((pred == i) == (y_true == i)).mean())
        for m in METRIC_NAMES:
            per_cls[m].append(tm.get(m, 0.0))
    out = {m: {"classwise": per_cls[m], "macro": float(np.mean(per_cls[m]))}
           for m in METRIC_NAMES}
    out["overall_acc"] = float((pred == y_true).mean())
    out["macro_roc_ovr"] = _safe(lambda: ovr_macro_roc_auc(y_true, prob), 0.5)
    return out


def _reg_targets(y_true, y_pred):
    """[n] targets -> [n, 1] arrays in their common floating dtype
    (float64 for integers)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    floats = [a.dtype for a in (y_true, y_pred) if a.dtype.kind == "f"]
    dt = np.result_type(*floats) if floats else np.float64
    y_true, y_pred = y_true.astype(dt), y_pred.astype(dt)
    if y_true.ndim == 1:
        y_true = y_true.reshape((-1, 1))
    if y_pred.ndim == 1:
        y_pred = y_pred.reshape((-1, 1))
    return y_true, y_pred


def _explained_fraction(numerator, denominator) -> float:
    """1 - num / den per output; 1 where num is 0, 0 where only den is."""
    scores = np.ones(numerator.shape, numerator.dtype)
    nz_num, nz_den = numerator != 0, denominator != 0
    valid = nz_num & nz_den
    scores[valid] = 1 - numerator[valid] / denominator[valid]
    scores[nz_num & ~nz_den] = 0.0
    return float(np.average(scores))


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = _reg_targets(y_true, y_pred)
    if y_pred.shape[0] < 2:
        return float("nan")
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    return _explained_fraction(numerator, denominator)


def explained_variance(y_true, y_pred) -> float:
    y_true, y_pred = _reg_targets(y_true, y_pred)
    diff_avg = np.average(y_true - y_pred, axis=0)
    numerator = np.average((y_true - y_pred - diff_avg) ** 2, axis=0)
    true_avg = np.average(y_true, axis=0)
    denominator = np.average((y_true - true_avg) ** 2, axis=0)
    return _explained_fraction(numerator, denominator)


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return float(np.average(np.average((y_true - y_pred) ** 2, axis=0)))


def mean_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return float(np.average(np.average(np.abs(y_pred - y_true), axis=0)))


def regression_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """Pearson r, R², explained variance, MSE, MAE
    (engine_finetune.py:642-678)."""
    from scipy.stats import pearsonr

    y_true = np.asarray(y_true).squeeze()
    y_pred = np.asarray(y_pred).squeeze()
    r = _safe(lambda: float(pearsonr(y_true, y_pred)[0]))
    return {
        "pearson_r": r,
        "r2": _safe(lambda: r2_score(y_true, y_pred)),
        "explained_variance": _safe(lambda: explained_variance(y_true, y_pred)),
        "mse": mean_squared_error(y_true, y_pred),
        "mae": mean_absolute_error(y_true, y_pred),
    }


def multi_output_regression_metrics(y_true: np.ndarray,
                                    y_pred: np.ndarray) -> dict:
    """Per-target battery for GA-growth labels: r2_k = pearson(y_k,
    yhat_k)^2 per label column (main_retclip_finetune_more_cls_3mod.py:
    48-50, 104-126), per-target MSE / MAE and macro means."""
    from scipy.stats import pearsonr

    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    if y_pred.ndim == 1:
        y_pred = y_pred[:, None]
    out = {}
    r2s = []
    for k in range(y_true.shape[1]):
        r = _safe(lambda: float(pearsonr(y_true[:, k], y_pred[:, k])[0]))
        out[f"r2_{k}"] = r * r
        out[f"pearson_r_{k}"] = r
        out[f"mse_{k}"] = float(np.mean((y_true[:, k] - y_pred[:, k]) ** 2))
        out[f"mae_{k}"] = float(np.mean(np.abs(y_true[:, k] - y_pred[:, k])))
        r2s.append(r * r)
    out["r2_macro"] = float(np.mean(r2s))
    out["mse_macro"] = float(np.mean(
        [out[f"mse_{k}"] for k in range(y_true.shape[1])]))
    return out


def compute_metrics(task_mode: str, y_true, y_pred, threshold=0.5) -> dict:
    """The task-mode dispatch of evaluate() (engine_finetune.py:497-813)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if task_mode.startswith("multi_task"):
        return multi_task_metrics(y_true, y_pred, threshold)
    if task_mode == "multi_label":
        return multi_label_metrics(y_true, 1 / (1 + np.exp(-y_pred)), threshold)
    if task_mode == "regression":
        return regression_metrics(y_true, y_pred)
    if task_mode == "multi_output_regression":
        return multi_output_regression_metrics(y_true, y_pred)
    e = np.exp(y_pred - y_pred.max(axis=1, keepdims=True))
    return multi_class_metrics(y_true.astype(np.int64), e / e.sum(1, keepdims=True))
