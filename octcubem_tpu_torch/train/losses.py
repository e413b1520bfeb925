"""Fine-tune losses (counterpart of octcubem_tpu/train/losses.py): the
reference's dispatch battery, in fp32 on the logits' device with no host
read (a 0-d loss tensor, so the step's NaN guard stays on the device).

- ``weighted_label_smoothing_ce`` (OCTCube/util/
  WeightedLabelSmoothingCrossEntropy.py): label-smoothed NLL with rows
  whose one-hot target is all zero masked out; mean over valid rows.
- ``multi_task_loss`` (OCTCube/engine_finetune.py:36-70): per-disease
  (normal, disease) pairs with per-sample validity, summed, then divided
  by the total valid weight (the reference's double normalization, kept).
- BCE-with-logits (multi_label), softmax CE (multi_class), MSE
  (regression), the FocalLoss2d option (OCTCube/util/focal_loss.py).
"""

from __future__ import annotations

import torch


def weighted_label_smoothing_ce(logits, target_onehot,
                                smoothing: float = 0.1):
    """logits [B, C]; target_onehot [B, C] (an all-zero row is invalid)."""
    valid = (target_onehot.sum(dim=-1) != 0).float()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    idx = torch.argmax(target_onehot, dim=-1)
    nll = -torch.gather(logprobs, -1, idx[:, None])[:, 0]
    smooth = -logprobs.mean(dim=-1)
    loss = (1.0 - smoothing) * nll + smoothing * smooth
    denom = valid.sum()
    return torch.where(denom == 0, torch.zeros_like(denom),
                       (loss * valid).sum() / torch.clamp(denom, min=1.0))


def multi_task_targets(target):
    """[B, C] multi-label (column 0 = normal) -> ([B, C-1, 2] one-hots,
    [B, C-1] validity weights); engine_finetune.py:36-44."""
    normal = target[:, 0:1]
    disease = target[:, 1:]
    t = torch.stack([normal.expand_as(disease), disease], dim=-1)
    return t, t.sum(dim=-1)


def multi_task_loss(logits, target, smoothing: float = 0.1):
    """logits [B, 2*(C-1)]; target [B, C] multi-label, normal column 0."""
    t, w = multi_task_targets(target)
    ntask = t.shape[1]
    out = logits.reshape(logits.shape[0], ntask, 2)
    t = t.float()
    per_task = torch.stack([
        weighted_label_smoothing_ce(out[:, i], t[:, i], smoothing)
        for i in range(ntask)])
    return per_task.sum() / (w.float().sum() + 1e-8)


def _bce_terms(x, t):
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits(logits, target):
    """Mean BCE-with-logits (multi_label mode)."""
    return _bce_terms(logits.float(), target.float()).mean()


def softmax_ce(logits, labels, smoothing: float = 0.0):
    """Multi-class CE with integer labels, optional label smoothing."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, labels.long()[:, None])[:, 0]
    if smoothing > 0:
        smooth = -logprobs.mean(dim=-1)
        nll = (1 - smoothing) * nll + smoothing * smooth
    return nll.mean()


def mse_loss(pred, target):
    return ((pred.float().squeeze() - target.float().squeeze()) ** 2).mean()


def focal_bce(logits, target, gamma: float = 2.0, balance: float = 0.25):
    """FocalLoss2d (OCTCube/util/focal_loss.py:18-37): binary focal over
    the disease columns, plain BCE on the normal column, combined."""
    x = logits.float()
    t = target.float()
    logpt = -_bce_terms(x, t)
    pt = torch.exp(logpt[:, 1:])
    focal = -((1 - pt) ** gamma) * logpt[:, 1:]
    c = x.shape[1]
    return ((balance * focal.mean() * (c - 1) - logpt[:, 0]) / c).mean()


def make_criterion(task_mode: str, *, smoothing: float = 0.1,
                   use_focal: bool = False):
    """Loss dispatch of engine_finetune.py:423-441."""
    if task_mode.startswith("multi_task"):
        return lambda o, t: multi_task_loss(o, t, smoothing)
    if task_mode == "multi_label":
        return focal_bce if use_focal else bce_with_logits
    if task_mode == "regression":
        return mse_loss
    # multi_cls / binary_cls
    return lambda o, t: softmax_ce(o, t, smoothing)
