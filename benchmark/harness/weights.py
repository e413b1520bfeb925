"""Seeded weights that the benchmark makes and hands to both sides.

``make(specs, seed, device)`` fills every parameter of a (name, shape)
list from one flat normal draw on the device, in a few large calls, in
name order, so that the program and the plain reference get the same
tensors whatever order their modules build them in:

- a LayerNorm scale (a 1-D ``weight`` under a name holding ``norm``):
  1 + N(0, 0.02);
- a bias, a token or a position embedding, any other 1-D or 0-d tensor:
  N(0, 0.02);
- a matrix or a patch kernel [out, ...]: N(0, 1 / fan_in), fan_in the
  elements of one output's slice;
- a name in ``fixed``: that value.

``injected(modules, seed, fixed)`` hands them to the program at its own
seam: each program module's ``init_params(model, generator)``, which its
``create_model`` calls on the freshly materialised model, is replaced for
the duration by one that copies these weights in.
"""

from __future__ import annotations

import contextlib

import torch

CHUNK = 1 << 26  # elements a call of the normal draw


def _scale_kind(name: str, shape) -> str:
    if len(shape) == 1 and name.endswith("weight") and "norm" in name:
        return "ln"
    if len(shape) >= 2 and "pos_embed" not in name and "token" not in name:
        return "fan_in"
    return "small"


def make(specs, seed: int, device, fixed=None) -> dict:
    """name -> fp32 tensor on ``device`` for each (name, shape) of
    ``specs`` (views of one flat buffer)."""
    fixed = fixed or {}
    specs = sorted((n, tuple(s)) for n, s in specs)
    sizes = [int(torch.Size(s).numel()) for _, s in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, device=device)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        flat[lo:hi] = torch.randn(hi - lo, generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(specs, sizes):
        t = out[name] = flat[off:off + n].view(shape)
        off += n
        tail = name.rsplit(".", 1)[-1]
        kind = _scale_kind(name, shape)
        if name in fixed or tail in fixed:
            t.fill_(float(fixed.get(name, fixed.get(tail))))
        elif kind == "ln":
            t.mul_(0.02).add_(1.0)
        elif kind == "fan_in":
            t.mul_((n // shape[0]) ** -0.5)
        else:
            t.mul_(0.02)
    return out


def specs_of(model) -> list:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


@torch.no_grad()
def load_into(model, seed: int, fixed=None) -> None:
    """Copy ``make``'s weights into every parameter of ``model``."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    w = make(specs_of(model), seed, dev, fixed)
    for name, p in params.items():
        p.copy_(w[name])
    del w


@contextlib.contextmanager
def injected(modules, seed: int, fixed=None):
    """Within the block, each module's ``init_params(model, generator)``
    loads these weights instead of the module's own draw."""
    saved = [(m, m.init_params) for m in modules]

    def init_params(model, generator=None):
        load_into(model, seed, fixed)

    try:
        for m in modules:
            m.init_params = init_params
        yield
    finally:
        for m, f in saved:
            m.init_params = f
