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
weight decay still advance (``torch.optim`` would skip it).  The LR is
folded into the first moment's scale and the decoupled decay is the
factor ``1 - lr * weight_decay * scale`` on the decayed params
(``torch.optim.AdamW``'s form).

Where it runs: a param list on the card takes ``csrc/adamw.cu``, one
pass that reads p, g, mu and nu once and writes p, mu and nu once (28
bytes a fp32 param), launched by ``_kernel_update``; it has no other
path, and raises on a list it does not take.  A CPU list takes
``_foreach_update``, the same arithmetic as multi-tensor
(``torch._foreach_*``) ops, one pass a stage: the kernel's plain
version, which the CPU tests hold against optax.

On a state sharded over fsdp (``core/fsdp.py``) the params, ``mu`` and
``nu`` of a sharded leaf are this rank's chunks, on which the update is
elementwise; the clip's norm is the global gradient's (``global_norm``).

``step(ok=...)`` is the fine-tune step's NaN guard on the device (JAX's
``jnp.where(ok, new, old)`` over the whole state): the update is kept
only where the 0-d bool ``ok`` holds, so a non-finite loss leaves the
params, both moments and the count as they were, and the host reads
nothing (the kernel writes nothing where ``ok`` is false; the plain
version computes out of place and selects).

The count is one 0-d int64 tensor on the params' device for the
optimizer's life, advanced in place, so a step captured into a CUDA
graph (``train/step_graph.py``) replays at the live count.  Every update
reads its LR and bias corrections at that count on the device, from one
table of the schedule over its ``total_steps`` and of the corrections,
so the host reads nothing.

LiT locking (the COEM towers): ``lit_lock_scales`` gives each param 1.0
or 0.0 by the reference lock() groups; ``make_partition`` freezes the
0.0 ones for real (``requires_grad_(False)``, so autograd builds no
backward for a frozen prefix, and an ``AdamW`` built over the trainable
params it returns holds no moments for the frozen ones), and
``scale_by_tree`` is the zero-scaled-update fallback, which still
differentiates and keeps moments for every param.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import re
from typing import Callable, Mapping

import torch
from torch import nn

from ..core.multihost import all_reduce_sum
from ..ops import _cuda
from ..utils import profiling

_NO_DECAY = ("pos_embed", "cls_token", "mask_token")

# csrc/adamw.cu: elements a block takes at a time (kChunk), tensors a
# launch holds (kMaxTensors)
ADAMW_CHUNK = 2048
ADAMW_GROUP = 64


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


def adamw_launches(sizes) -> list[tuple[list[int], list[int]]]:
    """csrc/adamw.cu's launches over tensors of ``sizes`` elements: per
    launch the indices of its tensors (in order, at most ``ADAMW_GROUP``;
    an empty tensor takes none) and their chunk counts, cumulative, which
    the launch's blocks walk ``ADAMW_CHUNK`` elements at a time."""
    live = [i for i, n in enumerate(sizes) if n]
    launches = []
    for k in range(0, len(live), ADAMW_GROUP):
        idx = live[k:k + ADAMW_GROUP]
        ends = itertools.accumulate(-(-sizes[i] // ADAMW_CHUNK) for i in idx)
        launches.append((idx, list(ends)))
    return launches


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
        self.count = torch.zeros((), dtype=torch.int64, device=(
            self.params[0].device if self.params else None))
        self.shards = None  # the fsdp layout of a sharded state (core/fsdp)
        self._table = None  # ``_scalars``', built at the first step
        self._plan = None  # the kernel's launches (``_kernel_plan``)
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
        names, shapes and dtypes must match.  The count, an ``int`` or a
        tensor, is written into the live count tensor."""
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
        self.count.copy_(torch.as_tensor(state["count"]))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(int(count)) if callable(lr) else lr)

    @torch.no_grad()
    def step(self, ok: torch.Tensor | None = None) -> None:
        """One update from the params' ``.grad`` (None taken as zeros);
        with ``ok``, gated on it on the device (module docstring).  Runs
        in the open step's ``adamw`` phase (utils/profiling.py)."""
        with profiling.phase("adamw"):
            lr, c1, c2 = self._scalars()  # read before the count moves
            self.count.add_(1 if ok is None else ok)
            if self.params and self.params[0].is_cuda:
                self._kernel_update(lr, c1, c2, ok)
            else:
                self._foreach_update(lr, c1, c2, ok)

    def _clip_factor(self) -> torch.Tensor | None:
        """The global-norm clip's factor on the gradient, a 0-d fp32
        tensor on the params' device; None without a clip."""
        if self.clip_grad is None:
            return None
        gn = grad_norm(self.params, [p.grad for p in self.params],
                       self.shards)
        return torch.where(gn < self.clip_grad, torch.ones_like(gn),
                           self.clip_grad / gn)

    def _foreach_update(self, lr, c1, c2, ok) -> None:
        """The update as multi-tensor ops, one pass a stage: the CPU's
        body and the kernel's plain version.  In place; with ``ok``, out
        of place and kept where it holds.  ``lr``, ``c1``, ``c2``: fp32
        0-d tensors on the params' device."""
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        factor = self._clip_factor()
        if factor is not None:
            grads = torch._foreach_mul(grads, factor)
        gated = ok is not None
        params, nu = ([[t.clone() for t in ts] for ts in (self.params, self.nu)]
                      if gated else (self.params, self.nu))
        mu = [m.to(torch.float32, copy=gated) for m in self.mu]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_mul(mu, -lr / c1)
        torch._foreach_div_(u, denom)
        if self.scales is not None:
            torch._foreach_mul_(u, self.scales)
        if self.weight_decay and self.decayed:
            groups: dict[float, list] = {}
            for i in self.decayed:
                s = 1.0 if self.scales is None else self.scales[i]
                groups.setdefault(s, []).append(params[i])
            for s, ps in groups.items():
                torch._foreach_mul_(ps, 1.0 - lr * (self.weight_decay * s))
        torch._foreach_add_(params, u)
        if gated:
            for old, new in ((self.params, params), (self.mu, mu),
                             (self.nu, nu)):
                for o, n in zip(old, new):
                    torch.where(ok, n.to(o.dtype), o, out=o)
        elif self.mu_dtype is not None:
            torch._foreach_copy_(self.mu, mu)

    def _kernel_plan(self, dev, mu_type) -> list:
        """csrc/adamw.cu's launches over this state (``adamw_launches``):
        per launch its tensor indices, the addresses p, g, mu, nu a tensor
        (g left 0), sizes, chunk ends, layer scales and the decay rates
        wd * s.  Built, with the state's tensors checked, again whenever a
        param or moment has moved (fsdp places chunks) or the scales or
        decay changed."""
        key = (tuple(map(torch.Tensor.data_ptr, itertools.chain(
            self.params, self.mu, self.nu))), id(self.scales),
            self.weight_decay)
        if self._plan is not None and self._plan[0] == key:
            return self._plan[1]
        for name, p, m, v in zip(self.names, self.params, self.mu, self.nu):
            for t, want in ((p, torch.float32), (m, mu_type),
                            (v, torch.float32)):
                if (t.dtype != want or t.device != dev
                        or not t.is_contiguous() or t.numel() != p.numel()):
                    raise ValueError(
                        f"{name}: the AdamW kernel takes contiguous {want} "
                        f"tensors of the param's size on {dev}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}")
        scale = self.scales or [1.0] * len(self.params)
        wd = [0.0] * len(self.params)
        for i in self.decayed:
            wd[i] = self.weight_decay * scale[i]
        launches = []
        for idx, ends in adamw_launches([p.numel() for p in self.params]):
            k = len(idx)
            ptrs = [a for i in idx for a in (self.params[i].data_ptr(), 0,
                                             self.mu[i].data_ptr(),
                                             self.nu[i].data_ptr())]
            launches.append((
                idx, (ctypes.c_longlong * (4 * k))(*ptrs),
                (ctypes.c_longlong * k)(*[self.params[i].numel()
                                          for i in idx]),
                (ctypes.c_int * k)(*ends),
                (ctypes.c_float * k)(*[scale[i] for i in idx]),
                (ctypes.c_float * k)(*[wd[i] for i in idx])))
        self._plan = (key, launches)
        return launches

    def _kernel_update(self, lr, c1, c2, ok) -> None:
        """The update as csrc/adamw.cu's one pass (module docstring).
        Takes every tensor on the params' card: p, nu and the gradients
        fp32, mu fp32 or bf16, each contiguous; raises on anything else.
        ``lr``, ``c1``, ``c2``, the clip factor and ``ok`` go by pointer."""
        dev = self.params[0].device
        mu_type = self.mu_dtype or torch.float32
        if mu_type not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the AdamW kernel keeps mu in fp32 or bf16, "
                             f"not {mu_type}")
        plan = self._kernel_plan(dev, mu_type)
        grads = []
        for name, p in zip(self.names, self.params):
            g = p.grad
            if g is not None:
                if not g.is_contiguous():
                    g = g.contiguous()  # the kernel walks memory in order
                if (g.dtype != torch.float32 or g.device != dev
                        or g.numel() != p.numel()):
                    raise ValueError(
                        f"{name}: the AdamW kernel takes a contiguous fp32 "
                        f"gradient of the param's size on {dev}, got "
                        f"{g.dtype} {tuple(g.shape)} on {g.device}")
            grads.append(g)
        if ok is not None and (ok.dtype != torch.bool or ok.device != dev):
            raise ValueError(f"ok: a bool tensor on {dev}, got {ok.dtype} "
                             f"on {ok.device}")
        at = [None if t is None else t.data_ptr()
              for t in (lr, c1, c2, self._clip_factor(), ok)]
        hyper = (ctypes.c_float * 5)(
            self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2, self.eps)
        lib = _cuda.library("adamw")
        stream = torch.cuda.current_stream(dev).cuda_stream
        for idx, ptrs, sizes, ends, scale, decay in plan:
            for j, i in enumerate(idx):
                ptrs[4 * j + 1] = 0 if grads[i] is None else grads[i].data_ptr()
            err = lib.octcube_adamw(
                *map(ctypes.addressof, (ptrs, sizes, ends, scale, decay)),
                len(idx), int(mu_type == torch.bfloat16),
                ctypes.addressof(hyper), *at, stream)
            _cuda.check(lib, err, "adamw")
        _cuda.launches["adamw"] += 1

    def _scalars(self) -> torch.Tensor:
        """This update's [lr, c1, c2], fp32 on the count's device: the
        schedule at the count and the bias corrections 1 - b^(count + 1),
        one row of a table read at the count.  The table is built at the
        first step, over the schedule's ``total_steps`` (the last LR past
        the end) and out to where both corrections round to 1 (b^k <=
        2^-26), so a row past its end holds what the count would give.  A
        schedule without ``total_steps`` is refused: a table it cannot
        size would freeze or skew the LR."""
        if self._table is None:
            sched = self.learning_rate
            if not callable(sched):
                lrs = [float(sched)]
            elif getattr(sched, "total_steps", None) is None:
                raise ValueError("AdamW needs a float LR or a schedule "
                                 "with total_steps (train/schedules.py)")
            else:
                lrs = [float(sched(i))
                       for i in range(int(sched.total_steps) + 1)]
            b = max(self.b1, self.b2)
            if not 0.0 <= b < 1.0:
                raise ValueError(f"betas lie in [0, 1), got {self.b1}, "
                                 f"{self.b2}")
            n = max(len(lrs), math.ceil(26 * math.log(2) / -math.log(b))
                    if b else 1)
            dev = self.count.device
            k = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
            self._table = torch.stack([
                torch.tensor(lrs + lrs[-1:] * (n - len(lrs)),
                             dtype=torch.float64, device=dev),
                1.0 - torch.pow(self.b1, k),
                1.0 - torch.pow(self.b2, k)], 1).float()
        # index_select, not [count]: a 0-d index is read back to the host
        idx = self.count.clamp(max=self._table.shape[0] - 1).reshape(1)
        return self._table.index_select(0, idx)[0]


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
