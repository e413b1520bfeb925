"""AdamW with the reference's weight-decay mask and layer-wise LR decay
(counterpart of octcubem_tpu/train/optim.py), over the port's state-dict
parameter names.

- No weight decay for 1-D params and for pos embeds, cls and mask tokens
  (OCTCube/util/lr_decay.py, the models' no_weight_decay()).
- Layer-wise LR decay (BEiT): scale = layer_decay ** (num_layers + 1 -
  layer_id), layer 0 = the embeddings, i + 1 = block i, num_layers + 1 =
  everything else.

``AdamW`` is one update with the JAX package's arithmetic, in optax's
order: global-norm clip, Adam moments with bias correction by the
post-increment count and eps outside the square root, decoupled weight
decay on the masked params, the layer scales, then the LR of the
pre-increment count.  Without clip and layer decay that is exactly
``build_fused_adamw``'s single pass.  A param whose ``.grad`` is None
takes a zero gradient, as JAX gives it one: its count, moments and
weight decay still advance (``torch.optim`` would skip it).  Each stage
is one multi-tensor (``torch._foreach_*``) op over all params.

On a state sharded over fsdp (``core/fsdp.py``) the params, ``mu`` and
``nu`` of a sharded leaf are this rank's chunks, on which every stage
above is elementwise; the clip's norm is the global gradient's
(``global_norm``).

``step(ok=...)`` is the fine-tune step's NaN guard on the device (JAX's
``jnp.where(ok, new, old)`` over the whole state): the update is computed
out of place and kept only where the 0-d bool ``ok`` holds, so a
non-finite loss leaves the params, both moments and the count as they
were, and the host reads nothing.  On that path the count is a 0-d
tensor on the params' device and the LR is read at it from a table of
the schedule over its ``total_steps`` (the last entry past the end).
Without ``ok`` the update is the host-count one above, unchanged.

LiT locking (the COEM towers): ``lit_lock_scales`` gives each param 1.0
or 0.0 by the reference lock() groups; ``make_partition`` freezes the
0.0 ones for real (``requires_grad_(False)``, so autograd builds no
backward for a frozen prefix, and an ``AdamW`` built over the trainable
params it returns holds no moments for the frozen ones), and
``scale_by_tree`` is the zero-scaled-update fallback, which still
differentiates and keeps moments for every param.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import torch
from torch import nn

from ..core.multihost import all_reduce_sum

_NO_DECAY = ("pos_embed", "cls_token", "mask_token")


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def weight_decay_mask(params) -> dict[str, bool]:
    """name -> True where weight decay applies: ndim > 1 and not a pos /
    cls / mask token embedding.  ``params``: a module or name -> tensor."""
    return {name: p.ndim > 1 and not any(t in name for t in _NO_DECAY)
            for name, p in _named(params).items()}


def layer_decay_scales(params, num_blocks: int, layer_decay: float,
                       name_prefix: str = "") -> dict[str, float]:
    """name -> BEiT layer-decay LR multiplier.  Layer 0: names starting
    with cls_token, pos_embed or patch_embed; i + 1: block i of a
    ``blocks`` / ``decoder_blocks`` stack; the rest: the head layer.
    Names are matched with ``name_prefix`` in front: the JAX CLIs pass
    their params tree with its root, ``"params."`` here, under which no
    name is layer 0 (cli/finetune.py)."""
    num_layers = num_blocks + 1
    scales = [layer_decay ** (num_layers - i) for i in range(num_layers + 1)]

    def layer_id(name: str) -> int:
        if name.startswith(("cls_token", "pos_embed", "patch_embed")):
            return 0
        m = re.search(r"blocks\.(\d+)\.", name)
        return int(m.group(1)) + 1 if m else num_layers

    return {name: scales[layer_id(name_prefix + name)]
            for name in _named(params)}


def lit_lock_scales(params, depth: int, n_unlocked: int,
                    tower_prefix: str = "visual.") -> dict[str, float]:
    """name -> 1.0 (trainable) or 0.0 (locked) for LiT image-tower locking.

    The groups follow the reference lock() (models_vit_st_flash_attn_
    nodrop.py:308-351): [embeds + pos + cls, blocks 0..D-2, the last block
    with the final norm, the head group], D + 2 groups, of which the last
    ``n_unlocked`` train: 0 freezes the whole tower (head included), 1
    unlocks the head group, 2 adds the last block and the final norm, D + 2
    the embeddings too.  Params outside ``tower_prefix`` always train
    (``"clip.visual."`` in the classification models)."""
    n_groups = depth + 2
    first_unlocked = n_groups - n_unlocked  # group indices >= this train

    def scale(name: str) -> float:
        if not name.startswith(tower_prefix):
            return 1.0
        if any(t in name for t in ("fc_aggregate_cls", "aggregate_cls_norm",
                                   "head")):
            group = n_groups - 1
        elif (m := re.search(r"blocks\.(\d+)\.", name)):
            i = int(m.group(1))
            # blocks 0..D-2 are groups 1..D-1; the last block shares group
            # D with the final norm
            group = i + 1 if i < depth - 1 else depth
        elif ".norm." in name:
            group = depth  # the final norm, with the last block
        else:
            group = 0  # patch_embed, pos embeds, cls_token
        return 1.0 if group >= first_unlocked else 0.0

    return {name: scale(name) for name in _named(params)}


def make_partition(model: nn.Module,
                   trainable_mask: Mapping[str, bool]) -> dict[str, nn.Parameter]:
    """Real freezing (the LiT lock): every param of ``model`` whose mask
    entry is false gets ``requires_grad_(False)``, the rest True ->
    {name: param} of the trainable ones, to build the ``AdamW`` over.
    Autograd then differentiates only what reaches a trainable param: a
    frozen tower prefix is a constant of the loss and builds no backward,
    as under the reference lock() (requires_grad=False)."""
    out = {}
    for name, p in model.named_parameters():
        keep = bool(trainable_mask[name])
        p.requires_grad_(keep)
        if keep:
            out[name] = p
    return out


def scale_by_tree(tx: "AdamW", scales: Mapping[str, float]) -> "AdamW":
    """Multiply ``tx``'s updates elementwise by a static per-param scalar
    (optax ``chain(tx, scale_by_tree(scales))``): folded into its layer
    scales, which multiply the update before the LR.  -> ``tx``."""
    extra = [float(scales[n]) for n in tx.names]
    tx.scales = (extra if tx.scales is None
                 else [a * b for a, b in zip(tx.scales, extra)])
    return tx


def global_norm(tensors, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, one fp32 0-d tensor.
    Each tensor's norm accumulates in fp64: the CPU's fp32 norm of a
    ViT-L weight's 4 M entries is 1e-4 off.  ``sharded``: per tensor,
    whether it is this rank's chunk of a leaf sharded over ``group``
    (fsdp, ``core/fsdp.py``): the chunks' sum of squares is summed over
    the group's ranks and every whole tensor is counted once, so every
    rank gets the norm of the global gradient."""
    if not tensors:
        return torch.zeros(())
    sharded = sharded or [False] * len(tensors)

    def squares(ts):  # the sum of squares, one fp64 0-d tensor
        norms = torch._foreach_norm([t.float() for t in ts], 2,
                                    dtype=torch.float64)
        return torch.stack(norms).square().sum()

    whole = [t for t, s in zip(tensors, sharded) if not s]
    chunks = [t for t, s in zip(tensors, sharded) if s]
    total = squares(whole) if whole else 0.0
    if chunks:
        total = total + all_reduce_sum(squares(chunks), group)
    return total.sqrt().float()


def grad_norm(params, grads, shards=None) -> torch.Tensor:
    """``global_norm`` of a step's gradients over ``params`` (None taken
    as zeros); ``shards``: the state's fsdp layout, or None."""
    grads = [g if g is not None else torch.zeros_like(p)
             for p, g in zip(params, grads)]
    if shards is None:
        return global_norm(grads)
    return global_norm(grads, shards.mask(params), shards.group)


class AdamW:
    """AdamW over named params (see the module docstring for the order).

    ``learning_rate``: a float or a function of the step count; ``clip_grad``:
    global-norm clip or None; ``scales``: name -> LR multiplier or None;
    ``mu_dtype``: storage type of the first moment (None: the param's)."""

    def __init__(self, params, learning_rate: float | Callable,
                 weight_decay: float = 0.05,
                 betas: tuple[float, float] = (0.9, 0.95), eps: float = 1e-8,
                 mu_dtype: torch.dtype | None = None,
                 clip_grad: float | None = None,
                 scales: Mapping[str, float] | None = None):
        named = _named(params)
        self.names = list(named)
        self.params = list(named.values())
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.clip_grad = clip_grad
        mask = weight_decay_mask(named)
        self.decayed = [i for i, n in enumerate(self.names) if mask[n]]
        self.scales = (None if scales is None
                       else [float(scales[n]) for n in self.names])
        self.mu_dtype = mu_dtype
        self.count = 0
        self.shards = None  # the fsdp layout of a sharded state (core/fsdp)
        self._lr_table = None
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> dict:
        """{"count", "mu", "nu"}: the moments keyed by parameter name, as
        references to the live tensors (mu in its storage type)."""
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy a ``state_dict()`` into this optimizer's tensors in place;
        names, shapes and dtypes must match."""
        for key in ("mu", "nu"):
            got = state[key]
            if set(got) != set(self.names):
                raise ValueError(f"{key}: names differ from the params'")
            for name, t in zip(self.names, getattr(self, key)):
                src = got[name]
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(
                        f"{key}[{name}]: {tuple(src.shape)} {src.dtype} != "
                        f"{tuple(t.shape)} {t.dtype}")
                t.copy_(src)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(int(count)) if callable(lr) else lr)

    def _grads(self) -> list[torch.Tensor]:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        grads = [g.float() for g in grads]
        if self.clip_grad is not None:
            gn = grad_norm(self.params, grads, self.shards)
            factor = torch.where(gn < self.clip_grad, torch.ones_like(gn),
                                 self.clip_grad / gn)
            grads = torch._foreach_mul(grads, factor)
        return grads

    @torch.no_grad()
    def step(self, ok: torch.Tensor | None = None) -> None:
        """One update from the params' ``.grad`` (None taken as zeros);
        with ``ok``, gated on it on the device (module docstring)."""
        if ok is not None:
            return self._gated_step(ok)
        grads = self._grads()
        lr = self.lr(self.count)  # the schedule's step: pre-increment
        self.count += 1           # bias correction: post-increment
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        mu = ([m.float() for m in self.mu] if self.mu_dtype is not None
              else self.mu)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        u = self._direction(mu, self.nu, c1, c2)
        torch._foreach_add_(self.params, u, alpha=-lr)
        if self.mu_dtype is not None:
            torch._foreach_copy_(self.mu, mu)

    def _direction(self, mu, nu, c1, c2) -> list[torch.Tensor]:
        """The update before the LR: (mu / c1) / (sqrt(nu / c2) + eps),
        plus the decoupled weight decay, times the layer scales."""
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, c1)
        torch._foreach_div_(u, denom)
        if self.weight_decay and self.decayed:
            torch._foreach_add_([u[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed],
                                alpha=self.weight_decay)
        if self.scales is not None:
            torch._foreach_mul_(u, self.scales)
        return u

    def _device_lr(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule at a device count, from a table of steps 0 ..
        ``total_steps`` built once; a schedule without ``total_steps`` is
        refused (a table it cannot size would freeze or skew the LR)."""
        if not callable(self.learning_rate):
            return torch.tensor(float(self.learning_rate),
                                dtype=torch.float64, device=count.device)
        total = getattr(self.learning_rate, "total_steps", None)
        if total is None:
            raise ValueError("step(ok=...) needs a float LR or a schedule "
                             "with total_steps (train/schedules.py)")
        if self._lr_table is None or self._lr_table.device != count.device:
            self._lr_table = torch.tensor(
                [self.lr(i) for i in range(int(total) + 1)],
                dtype=torch.float64, device=count.device)
        # index_select, not [count]: a 0-d index is read back to the host
        idx = count.clamp(max=self._lr_table.numel() - 1).reshape(1)
        return self._lr_table.index_select(0, idx)[0]

    def _gated_step(self, ok: torch.Tensor) -> None:
        dev = self.params[0].device
        if not torch.is_tensor(self.count):
            self.count = torch.tensor(int(self.count), device=dev)
        grads = self._grads()
        lr = self._device_lr(self.count)
        count = self.count + 1
        c1 = (1.0 - torch.pow(self.b1, count.double())).float()
        c2 = (1.0 - torch.pow(self.b2, count.double())).float()
        mu = torch._foreach_mul([m.float() for m in self.mu], self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        u = self._direction(mu, nu, c1, c2)
        torch._foreach_mul_(u, (-lr).float())
        new = torch._foreach_add(self.params, u)
        for old, upd in ((self.params, new), (self.mu, mu), (self.nu, nu)):
            for o, n in zip(old, upd):
                torch.where(ok, n.to(o.dtype), o, out=o)
        self.count = torch.where(ok, count, self.count)


def build_fused_adamw(params, learning_rate: float | Callable,
                      weight_decay: float = 0.05,
                      betas: tuple[float, float] = (0.9, 0.95),
                      eps: float = 1e-8, mu_dtype=None) -> AdamW:
    """The single-pass AdamW (no clip, no layer decay)."""
    return AdamW(params, learning_rate, weight_decay, betas, eps, mu_dtype)


def build_adamw(params, learning_rate: float | Callable,
                weight_decay: float = 0.05,
                betas: tuple[float, float] = (0.9, 0.95),
                layer_decay: float | None = None,
                num_blocks: int | None = None,
                clip_grad: float | None = None, mu_dtype=None,
                name_prefix: str = "") -> AdamW:
    """AdamW of the reference pretrain (betas 0.9 / 0.95) and finetune
    (layer decay) configurations; without clip_grad and layer_decay it is
    ``build_fused_adamw``.  ``name_prefix``: see ``layer_decay_scales``."""
    scales = None
    if layer_decay is not None and layer_decay != 1.0:
        if num_blocks is None:
            raise ValueError("layer_decay needs num_blocks")
        scales = layer_decay_scales(params, num_blocks, layer_decay,
                                    name_prefix)
    return AdamW(params, learning_rate, weight_decay, betas, mu_dtype=mu_dtype,
                 clip_grad=clip_grad, scales=scales)
