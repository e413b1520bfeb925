"""Contrastive (COEM) training engine: the CLIP losses, the train and
evaluation steps, the retrieval metrics (counterpart of
octcubem_tpu/train/clip_engine.py).

Parity targets:
- ClipLoss (open_clip/loss.py:148-229): symmetric InfoNCE over the global
  batch, logits in fp32.  JAX gets it from global arrays; here, under a
  data-parallel ``mesh``, each rank's features are gathered across the
  data axis in rank order by an all_gather that carries gradients
  (``core/multihost.all_gather_with_grad``: its backward sums the
  gradient over the ranks and keeps the rank's rows), and every rank
  computes the whole global loss.  The tower gradient on a rank is then
  the data degree times its rows' share, and ``logit_scale``'s is the
  global one, so the mean over every rank (reduced before the update) is
  the exact global gradient of both: JAX's semantics, not OpenCLIP's
  default ``gather_with_grad=False``, which gives the towers 1/W of it.
  The 3-modality presence weights, the feature-cached bank (every rank's
  chunk features) and the classification steps' logits are gathered
  the same way; ``evaluate_retrieval`` gathers the features in global
  order before the metrics.  No data-parallel step trains a BatchNorm:
  a ModifiedResNet tower cannot train through these steps in either
  package, so there is no SyncBatchNorm.
- ThreeModalityClipLoss (loss.py:232-388): 6 directed CE terms over 3
  pairs, masked by per-sample modality-presence weights; a pair with no
  valid sample contributes 0 (decided on the device: no host read).
- Feature-cached gradient accumulation (train_retclip.py:131-168): pass 1
  encodes every chunk under ``torch.no_grad()`` with the params as they
  are before the update; pass 2 re-encodes each chunk with grad, splices
  its features into the detached bank (so each chunk's loss spans the
  whole effective batch) and calls ``backward``.  The chunk gradients are
  SUMMED into ``.grad``: each sample's gradient flows through exactly one
  chunk's re-forward, so the sum is the full-batch gradient.  The logged
  loss is divided by ``accum_freq``.  Each chunk's drop-path draws are
  replayed in pass 2 from the generator state pass 1 started it at (JAX
  uses one key per chunk in both passes).
- Retrieval metrics R@1/5/10, mean / median rank, both directions
  (train_retclip.py:409-425), and the duplicate-corrected variant
  (:427-469).

A state sharded over fsdp (``core/fsdp.shard_state``) trains through
every step here, the accumulation included: the forwards and backwards
run inside ``fsdp.gathered`` (each sharded param read whole, gathered
once per step, its chunk's gradient reduce-scattered by every
``backward``), and ``_update`` takes the mean over the mesh and the
global norm.  ``logit_scale`` is 0-d, so the size policy replicates it.

LiT locking lives in the params (``optim.make_partition``): the steps
differentiate the optimizer's params only (``tx.params``), so a frozen
prefix builds no backward and holds no moments; under the zero-scale
fallback every param is differentiated.  The steps read nothing back to
the host: their metrics are 0-d tensors on the model's device, and the
caller reads step t-1's after it has issued step t.

Each train step is one ``utils/profiling.step("clip")`` with the phases
``forward`` (the towers and the loss; in the accumulation the cached
no-grad pass, which also runs in the range ``octcube.clip.cached``, and
each chunk's re-forward, splice and loss), ``backward`` (each
``loss.backward()``) and ``update`` (``_update``: ``reduce`` where the
step reduces, the norm, ``adamw``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core import fsdp, multihost
from ..core.mesh import check_mesh, data_group
from ..utils import profiling
from .optim import grad_norm
from .train_state import TrainState


def _ce_rows(logits, labels):
    return F.cross_entropy(logits.float(), labels, reduction="none")


def clip_loss(img_feat, enf_feat, logit_scale):
    """Symmetric InfoNCE over the batch, fp32 logits."""
    n = img_feat.shape[0]
    logits = logit_scale * (img_feat.float() @ enf_feat.float().T)
    labels = torch.arange(n, device=logits.device)
    return (_ce_rows(logits, labels).mean()
            + _ce_rows(logits.T, labels).mean()) / 2


def three_modality_clip_loss(img, enf1, enf2, scale, scale1, scale2, w1, w2):
    """6 directed CE terms masked by modality presence (loss.py:342-388).
    ``w1`` / ``w2``: [N] presence weights of enface1 / enface2.  Pair scales
    as in the reference: image-enf1 ``scale``, image-enf2 ``scale1``,
    enf1-enf2 ``scale2``."""
    n = img.shape[0]
    labels = torch.arange(n, device=img.device)
    img, enf1, enf2 = img.float(), enf1.float(), enf2.float()
    w1, w2 = w1.float(), w2.float()

    def masked_pair(a, b, s, w):
        la = _ce_rows(s * a @ b.T, labels) * w
        lb = _ce_rows(s * b @ a.T, labels) * w
        tot = w.sum()
        safe = torch.clamp_min(tot, 1.0)
        zero = torch.zeros_like(tot)
        return (torch.where(tot == 0, zero, la.sum() / safe),
                torch.where(tot == 0, zero, lb.sum() / safe))

    l1a, l1b = masked_pair(img, enf1, scale, w1)
    l2a, l2b = masked_pair(img, enf2, scale1, w2)
    l3a, l3b = masked_pair(enf1, enf2, scale2, w1 * w2)
    return (l1a + l1b + l2a + l2b + l3a + l3b) / 6


# ------------------------------------------------------------- train steps

class _Gather:
    """The data-parallel gathers of a step over ``mesh`` (identities
    without one)."""

    def __init__(self, mesh):
        self.on = check_mesh(mesh)
        self.group = data_group(mesh) if self.on else None

    def grad(self, t):
        return multihost.all_gather_with_grad(t, self.group) if self.on \
            else t

    def rows(self, t):
        return multihost.all_gather(t, self.group) if self.on else t


def _local_batch(batch):
    return {k: multihost.local(v) for k, v in batch.items()}


def _update(state: TrainState, tx, loss, reduce: bool = False):
    """One optimizer step from the params' ``.grad`` (first their mean
    over every rank when ``reduce`` or on a sharded state) -> metrics."""
    with profiling.phase("update"):
        with profiling.phase("reduce",
                             on=reduce or state.shards is not None):
            grads = fsdp.mean_grads(state, tx.params,
                                    [p.grad for p in tx.params], reduce)
        for p, g in zip(tx.params, grads):
            p.grad = g
        gn = grad_norm(tx.params, grads, state.shards)
        tx.step()
        state.step += 1
    return {"loss": loss.detach(), "grad_norm": gn}


def _backward(loss) -> None:
    """``loss.backward()`` in the step's backward phase."""
    with profiling.phase("backward", span=False):
        profiling.backward(loss).backward()


def make_clip_train_step(model, tx, three_mod: bool = False, mesh=None):
    """-> step(state, batch) -> (state, {"loss", "grad_norm"}): one
    contrastive step on {'image', 'enface'} (or 'enface1', 'enface2',
    'weight1', 'weight2' for ``three_mod``), the model in training mode.
    ``mesh``: the data-parallel mesh; the loss spans the global batch."""
    gather = _Gather(mesh)

    @profiling.stepped("clip")
    def step(state: TrainState, batch):
        batch = _local_batch(batch)
        model.train()
        tx.zero_grad()
        with fsdp.gathered(state, mesh):
            with profiling.phase("forward"):
                if three_mod:
                    img, e1, e2, *scales = model(
                        batch["image"], batch["enface1"], batch["enface2"],
                        generator=state.generator)
                    loss = three_modality_clip_loss(
                        gather.grad(img), gather.grad(e1), gather.grad(e2),
                        *scales, gather.rows(batch["weight1"]),
                        gather.rows(batch["weight2"]))
                else:
                    img, enf, scale = model(batch["image"], batch["enface"],
                                            generator=state.generator)
                    loss = clip_loss(gather.grad(img), gather.grad(enf),
                                     scale)
            _backward(loss)
        return state, _update(state, tx, loss, gather.on)

    return step


def _replay(gen: torch.Generator, start: torch.Tensor) -> torch.Generator:
    """A copy of ``gen`` set to the state ``start``."""
    g = torch.Generator(device=gen.device)
    g.set_state(start)
    return g


def _splice(bank: list, i: int, live):
    """The detached bank with chunk ``i`` replaced by the live features,
    flattened to [accum * chunk, D]."""
    return torch.cat(bank[:i] + [live] + bank[i + 1:])


def _accum_step(model, tx, accum_freq: int, encode, n_feat: int,
                chunk_loss, mesh=None):
    """The feature-cached accumulation (module docstring): ``encode(batch,
    i, generator)`` -> chunk i's model outputs, the first ``n_feat`` of
    them features; ``chunk_loss(spliced features, outputs, batch,
    gather)`` -> the loss over the whole bank.  Under ``mesh`` a chunk is
    the ranks' chunks i in rank order (``shard_microbatch``'s layout)."""
    gather = _Gather(mesh)

    @profiling.stepped("clip")
    def step(state: TrainState, batch):
        batch = _local_batch(batch)
        model.train()
        with fsdp.gathered(state, mesh):
            total = passes(state.generator, batch)
        return state, _update(state, tx, total / accum_freq, gather.on)

    def passes(gen, batch):
        """Both passes -> the summed chunk losses; the gradient in .grad."""
        starts, bank = [], []
        with profiling.phase("forward"), profiling.span("cached"), \
                torch.no_grad():
            for i in range(accum_freq):
                starts.append(gen.get_state())
                bank.append([gather.rows(f) for f in
                             encode(batch, i, gen)[:n_feat]])
        after = gen.get_state()
        banks = list(zip(*bank))  # per feature kind, one tensor per chunk
        tx.zero_grad()
        total = None
        for i in range(accum_freq):
            with profiling.phase("forward"):
                out = encode(batch, i, _replay(gen, starts[i]))
                full = [_splice(list(b), i, gather.grad(f))
                        for b, f in zip(banks, out[:n_feat])]
                loss = chunk_loss(full, out, batch, gather)
            _backward(loss)
            total = loss.detach() if total is None else total + loss.detach()
        gen.set_state(after)
        return total

    return step


def make_clip_accum_train_step(model, tx, accum_freq: int, mesh=None):
    """The 2-tower feature-cached accumulation step.  Batch tensors have
    leading dims [accum_freq, chunk, ...]."""

    def encode(batch, i, gen):
        return model(batch["image"][i], batch["enface"][i], generator=gen)

    def chunk_loss(full, out, batch, gather):
        return clip_loss(full[0], full[1], out[2])

    return _accum_step(model, tx, accum_freq, encode, 2, chunk_loss, mesh)


def make_clip_accum_train_step_3mod(model, tx, accum_freq: int, mesh=None):
    """The 3-modality feature-cached accumulation: the presence weights
    are taken over all chunks, so each chunk's loss is masked over the
    whole effective batch (train_retclip_3modalities.py:31-41).  Batch
    tensors have leading dims [accum_freq, chunk, ...]."""

    def encode(batch, i, gen):
        return model(batch["image"][i], batch["enface1"][i],
                     batch["enface2"][i], generator=gen)

    def chunk_loss(full, out, batch, gather):
        w1, w2 = (torch.cat([gather.rows(w) for w in batch[k]])
                  for k in ("weight1", "weight2"))
        return three_modality_clip_loss(*full, *out[3:], w1, w2)

    return _accum_step(model, tx, accum_freq, encode, 3, chunk_loss, mesh)


# ------------------------------------------- classification fine-tune steps

def _cls_forward(model, batch, three_mod, single_modality, generator=None):
    if three_mod:
        out = model(batch["image"], batch["enface1"], batch["enface2"],
                    single_modality=single_modality, generator=generator)
    else:
        out = model(batch["image"], batch["enface"],
                    single_modality=single_modality, generator=generator)
    return out[0]


def make_clip_cls_train_step(model, tx, criterion, three_mod: bool = False,
                             single_modality: str | None = None, mesh=None):
    """The COEM classification fine-tune step (train_retclip_finetune_
    more_cls_3mod.py train_one_epoch): towers and classification head,
    optionally one modality alone.  batch: {'image', 'enface' |
    'enface1' + 'enface2', 'label'}.  ``mesh``: the criterion is taken
    over the gathered global batch, as in train/finetune_engine.py."""
    gather = _Gather(mesh)

    @profiling.stepped("clip")
    def step(state: TrainState, batch):
        batch = _local_batch(batch)
        model.train()
        tx.zero_grad()
        with fsdp.gathered(state, mesh):
            with profiling.phase("forward"):
                logits = _cls_forward(model, batch, three_mod,
                                      single_modality, state.generator)
                loss = criterion(gather.grad(logits),
                                 gather.rows(batch["label"]))
            _backward(loss)
        return state, _update(state, tx, loss, gather.on)

    return step


def make_clip_cls_predict_step(model, three_mod: bool = False,
                               single_modality: str | None = None):
    """-> predict(batch) -> logits: eval mode, no gradient."""

    def predict(batch):
        model.eval()
        with torch.no_grad():
            return _cls_forward(model, batch, three_mod, single_modality)

    return predict


def check_retclip_run_geometry(ckpt_path: str, vcfg, ecfg) -> None:
    """Refuse tower init from a retclip run whose recorded tower geometry
    (params.txt, written by cli.retclip) disagrees on head partitioning.

    The tower tensors are shape-identical across head repartitionings
    (Wqkv stays [3D, D]), so ``init_towers_from_retclip``'s structural
    check cannot catch a num_heads mismatch: the model would load cleanly
    and compute the WRONG function.  Runs without params.txt (or files
    predating the geometry fields) pass unchallenged."""
    run_dir = ckpt_path.rstrip("/")
    for _ in range(3):  # accept run dir, run/ckpt, or a step dir's parent
        if os.path.exists(os.path.join(run_dir, "params.txt")):
            break
        run_dir = os.path.dirname(run_dir)
    path = os.path.join(run_dir, "params.txt")
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            saved = json.load(f)
    except ValueError:
        return
    for key, built in (("vision_cfg", vcfg), ("enface_cfg", ecfg)):
        rec = saved.get(key) or {}
        sh = rec.get("num_heads")
        bh = (built or {}).get("num_heads")
        if sh is not None and bh is not None and sh != bh:
            raise SystemExit(
                f"{ckpt_path} was trained with {key}.num_heads={sh} "
                f"(recorded in {path}), but this run builds the tower "
                f"with num_heads={bh}.  The tensors load cleanly either "
                "way and the model would silently compute the WRONG "
                "function — use a matching --model_config / flags.")


@torch.no_grad()
def init_towers_from_retclip(model, ckpt_path: str, step: int | None = None):
    """Initialise a classification model's towers (``model.clip``) from a
    trained retclip checkpoint in place; the classification head stays as
    it is (the reference loads the contrastive state dict strict=False,
    main_retclip_finetune_more_cls_3mod.py:452-470).

    ckpt_path: a cli.retclip output dir, its ckpt/ dir, or a specific
    step dir's parent.  -> (model, the number of tensors copied)."""
    from ..core.checkpoint import restore_raw

    if os.path.isdir(os.path.join(ckpt_path, "ckpt")):
        ckpt_path = os.path.join(ckpt_path, "ckpt")
    raw, _ = restore_raw(ckpt_path, step)
    src = raw["params"]  # the retclip TrainState's model state dict
    dst = model.clip.state_dict()
    groups: dict[str, dict] = {}
    for key, val in src.items():
        groups.setdefault(key.split(".", 1)[0], {})[key] = val
    copied = 0
    for top, sub in groups.items():
        mine = {k for k in dst if k.split(".", 1)[0] == top}
        if not mine:
            continue
        if mine != set(sub):
            raise ValueError(
                f"tower '{top}' structure mismatch between checkpoint and "
                "model (different configs?)")
        for key, val in sub.items():
            dst[key].copy_(val.to(dst[key].dtype))
        copied += len(sub)
    if copied == 0:
        raise ValueError(f"no tower params found in {ckpt_path}")
    return model, copied


# --------------------------------------------------------------- retrieval

def retrieval_metrics(img_feat: np.ndarray, enf_feat: np.ndarray,
                      prefix_a: str = "image_to_enface",
                      prefix_b: str = "enface_to_image") -> dict:
    """R@1/5/10 and mean / median rank, both directions
    (train_retclip.py:409-425)."""
    logits = img_feat @ enf_feat.T
    out = {}
    for name, mat in ((prefix_a, logits), (prefix_b, logits.T)):
        n = mat.shape[0]
        order = np.argsort(-mat, axis=1)
        rank = np.argmax(order == np.arange(n)[:, None], axis=1)
        out[f"{name}_mean_rank"] = float(rank.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(rank)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((rank < k).mean())
    return out


def retrieval_metrics_dup_corrected(img_feat, enf_feat, group_ids) -> dict:
    """Duplicate-corrected retrieval (train_retclip.py:427-469): a
    retrieved item counts as correct if it belongs to the same group (e.g.
    the same patient / eye) as the query."""
    group_ids = np.asarray(group_ids)
    logits = img_feat @ enf_feat.T
    out = {}
    for name, mat in (("image_to_enface", logits),
                      ("enface_to_image", logits.T)):
        order = np.argsort(-mat, axis=1)
        same = group_ids[order] == group_ids[:, None]
        rank = np.argmax(same, axis=1)
        out[f"{name}_corrected_mean_rank"] = float(rank.mean() + 1)
        out[f"{name}_corrected_median_rank"] = float(
            np.floor(np.median(rank)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_corrected_R@{k}"] = float((rank < k).mean())
    return out


def evaluate_retrieval(model, batches, three_mod: bool = False,
                       return_features: bool = False, encode_fn=None,
                       mesh=None):
    """Features over a val loader and their retrieval metrics
    (train_retclip.py:243-403); for 3-mod, all 3 pairs
    (train_retclip_3modalities.py:371-392).  ``return_features``: also the
    concatenated feature bank, the payload of retrieval_results_{epoch}.pkl
    (train_retclip.py:373-395).

    ``encode_fn``: an encoder with its weights inside, (img, enf) -> the
    two features (three for 3-mod): a frozen AOT artifact or the int8
    towers (cli/retclip.py --aot / --quant int8); ``model`` is unused
    then.  The model runs in eval mode with no gradient.  ``mesh``: each
    rank encodes its rows, and every batch's features are gathered across
    the data axis in rank order (the global batch's order) before the
    metrics, which every rank then computes alike."""
    gather = _Gather(mesh)
    if encode_fn is None:
        model.eval()
        n_out = 3 if three_mod else 2

        def encode_fn(*xs):
            with torch.no_grad():
                return model(*xs)[:n_out]

    names = (("image", "enface1", "enface2") if three_mod
             else ("image", "enface"))
    feats: dict[str, list] = {k: [] for k in names}
    for batch in batches:
        out = encode_fn(*(multihost.local(batch[k]) for k in names))
        for k, v in zip(names, out):
            feats[k].append(gather.rows(v.detach().float()).cpu().numpy())
    f = {k: np.concatenate(v) for k, v in feats.items()}
    if three_mod:
        out = {}
        out.update(retrieval_metrics(f["image"], f["enface1"],
                                     "image_to_enface1", "enface1_to_image"))
        out.update(retrieval_metrics(f["image"], f["enface2"],
                                     "image_to_enface2", "enface2_to_image"))
        out.update(retrieval_metrics(f["enface1"], f["enface2"],
                                     "enface1_to_enface2",
                                     "enface2_to_enface1"))
    else:
        out = retrieval_metrics(f["image"], f["enface"])
    return (out, f) if return_features else out
