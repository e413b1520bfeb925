"""The plain reference's optimizer: AdamW with decoupled weight decay, as
the configurations state it (``optimizer`` in each configuration file),
and the two learning-rate schedules they name.

Per leaf: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; with t the
count after the increment, u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) +
eps), plus weight_decay * p on matrices that are not a pos embedding, a
cls token or a mask token; p -= lr(t - 1) u.  A leaf with no gradient
takes a zero one.
"""

from __future__ import annotations

import math

import torch

_NO_DECAY = ("pos_embed", "cls_token", "mask_token")


def schedule(spec: dict):
    """lr(step) of a configuration's ``lr`` entry."""
    kind = spec["kind"]
    if kind == "warmup_half_cosine":
        base, lo = spec["base"], spec["min"]
        warm, total = spec["warmup_epochs"], spec["total_epochs"]
        per = spec["steps_per_epoch"]

        def lr(step):
            epoch = step / per
            if epoch < warm:
                return base * epoch / max(warm, 1e-8)
            prog = (epoch - warm) / max(total - warm, 1e-8)
            return lo + (base - lo) * 0.5 * (1.0 + math.cos(math.pi * prog))
        return lr
    if kind == "warmup_cosine_steps":
        base, warm, total = spec["base"], spec["warmup_steps"], spec["total_steps"]

        def lr(step):
            if step < warm:
                return base * (step + 1) / max(warm, 1)
            e = (step - warm) / max(total - warm, 1)
            return 0.5 * (1 + math.cos(math.pi * e)) * base
        return lr
    raise ValueError(f"unknown schedule {kind!r}")


def decayed(name: str, t) -> bool:
    return t.ndim > 1 and not any(k in name for k in _NO_DECAY)


class AdamW:
    def __init__(self, params: dict, spec: dict):
        self.p = params
        self.lr = schedule(spec["lr"])
        self.b1, self.b2 = spec["betas"]
        self.eps, self.wd = spec["eps"], spec["weight_decay"]
        self.t = 0
        self.m = {n: torch.zeros_like(v) for n, v in params.items()}
        self.v = {n: torch.zeros_like(v) for n, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        lr = self.lr(self.t)
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in self.p.items():
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / c1) / ((v / c2).sqrt() + self.eps)
            if self.wd and decayed(n, p):
                u = u + self.wd * p
            p.sub_(lr * u)
