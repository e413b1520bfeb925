"""Port parity: the global-batch CLIP losses on 4 gloo ranks against the
JAX package's losses on the global batch.

Four CPU processes (spawn, ``core/multihost.initialize`` with a
``FileStore``) each hold 2 of the 8 pairs of a global batch and run the
port's contrastive steps with ``mesh`` (data = 4) on linear towers
(features = normalize(x @ W), a learned log scale): the features are
gathered across the ranks with their gradient and every rank computes
the global loss.  The JAX side differentiates its ``clip_loss`` /
``three_modality_clip_loss`` over the 8 pairs (JAX's semantics: the
exact global gradient; tests/test_parallel.py shows its sharded loss
equal to the unsharded one).  Cases: ``make_clip_train_step`` (2 and 3
modalities, presence weights with absent samples), the feature-cached
accumulation at ``accum_freq = 2`` (2 and 3 modalities: the bank holds
every rank's chunk features), and ``evaluate_retrieval`` gathering the
features in global order.  JAX is imported in the test process only.

Tolerances: fp32 sums over 8 pairs in another order, 1e-5 relative on
the loss and on the tower and logit-scale gradients (atol 1e-6).
"""

import datetime
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
ROWS = 2          # pairs a rank holds
JOIN_S = 240
DIN = {"image": 12, "enface1": 10, "enface2": 9}
DOUT = 6
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    n = WORLD * ROWS
    x = {k: rng.standard_normal((n, d)).astype(np.float32)
         for k, d in DIN.items()}
    w = {k: (0.5 * rng.standard_normal((d, DOUT))).astype(np.float32)
         for k, d in DIN.items()}
    presence = np.ones((n,), np.float32)
    presence[[1, 4, 5]] = 0.0  # enface2 absent for three samples
    ls = np.log(np.array([10.0, 8.0, 12.0], np.float32))
    feats = {k: rng.standard_normal((2 * n, DOUT)).astype(np.float32)
             for k in ("image", "enface1")}
    return dict(x=x, w=w, presence=presence, ls=ls, feats=feats)


class _Towers(torch.nn.Module):
    """Linear towers with L2-normalised outputs and learned log scales;
    the COEM models' output layout ((img, enf, scale) or (img, enf1,
    enf2, scale, scale1, scale2))."""

    def __init__(self, inputs, three_mod):
        super().__init__()
        self.names = ("image", "enface1", "enface2")[:3 if three_mod else 2]
        names = self.names
        self.w = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(inputs["w"][k].copy()))
            for k in names})
        self.ls = torch.nn.Parameter(torch.from_numpy(
            inputs["ls"][:3 if three_mod else 1].copy()))
        self.three_mod = three_mod

    def forward(self, *xs, generator=None):
        feats = [torch.nn.functional.normalize(x @ self.w[k], dim=-1)
                 for x, k in zip(xs, self.names)]
        return (*feats, *self.ls.exp().unbind(0))


def _local(inputs, r, names, accum=1):
    rows = slice(r * ROWS, (r + 1) * ROWS)
    out = {k: torch.from_numpy(inputs["x"][k][rows]) for k in names}
    if accum > 1:  # [accum, ROWS / accum, ...]: chunk i is rows i
        out = {k: v.reshape(accum, ROWS // accum, -1) for k, v in out.items()}
    return out


# ------------------------------------------------------------- the ranks

def _rank_main(rank, store_path, inputs, out_dir):
    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.core.mesh import make_mesh
    from octcubem_tpu_torch.train import clip_engine, optim
    from octcubem_tpu_torch.train.train_state import TrainState

    torch.set_num_threads(1)
    multihost.initialize(store=dist.FileStore(store_path, WORLD),
                         world_size=WORLD, rank=rank, device="cpu",
                         timeout_s=60)
    try:
        mesh = make_mesh(n_data=WORLD, device="cpu")
        res = {}
        for case, three, accum in (("two", False, 1), ("three", True, 1),
                                   ("two_accum", False, 2),
                                   ("three_accum", True, 2)):
            model = _Towers(inputs, three)
            tx = optim.build_adamw(model, 0.0, 0.0)
            state = TrainState.create(model, tx, 0)
            names = ("image", "enface1", "enface2") if three else (
                "image", "enface1")
            batch = _local(inputs, rank, names, accum)
            if not three:
                batch["enface"] = batch.pop("enface1")
            else:
                w2 = torch.from_numpy(inputs["presence"][
                    rank * ROWS:(rank + 1) * ROWS])
                batch["weight1"] = torch.ones_like(w2)
                batch["weight2"] = w2
                if accum > 1:
                    batch["weight1"] = batch["weight1"].reshape(accum, -1)
                    batch["weight2"] = w2.reshape(accum, -1)
            if accum > 1:
                make = (clip_engine.make_clip_accum_train_step_3mod if three
                        else clip_engine.make_clip_accum_train_step)
                step = make(model, tx, accum, mesh=mesh)
            else:
                step = clip_engine.make_clip_train_step(
                    model, tx, three_mod=three, mesh=mesh)
            _, m = step(state, batch)
            res[f"{case}/loss"] = m["loss"].numpy()
            res.update({f"{case}/grad/{k}": p.grad.numpy()
                        for k, p in model.named_parameters()})

        # evaluate_retrieval: two batches of this rank's rows, gathered
        f = inputs["feats"]
        batches = [{k: torch.from_numpy(f[k][b * WORLD * ROWS + rank * ROWS:
                                             b * WORLD * ROWS
                                             + (rank + 1) * ROWS])
                    for k in ("image", "enface1")} for b in range(2)]
        batches = [{"image": b["image"], "enface": b["enface1"]}
                   for b in batches]
        metrics, feats = clip_engine.evaluate_retrieval(
            None, batches, return_features=True, encode_fn=lambda *xs: xs,
            mesh=mesh)
        res.update({f"eval/{k}": np.asarray(v) for k, v in metrics.items()})
        res["eval/feat_image"] = feats["image"]
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        multihost.shutdown()


# ----------------------------------------------------- the test process

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_clip")
    inputs = _inputs()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), inputs, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _bank_order(a, accum):
    """Global rows in the order of the feature bank: chunk-major, then
    rank (each rank's rows [r * ROWS, (r + 1) * ROWS) split into accum
    chunks)."""
    if accum == 1:
        return a
    per = a.reshape(WORLD, accum, ROWS // accum, *a.shape[1:])
    return per.transpose(1, 0, 2, *range(3, per.ndim)).reshape(a.shape)


def _jax_loss_and_grads(inputs, three, accum):
    """JAX's loss and gradient over the 8 pairs in the bank's order.  With
    accum_freq > 1, JAX's feature-cached accumulation
    (octcubem_tpu/train/clip_engine.py): the sum over chunks of the
    gradient of the loss over the whole bank with that chunk's features
    live and the others held, so the towers get the full-batch gradient
    and the logit scales accum_freq times theirs, as in the reference."""
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.train.clip_engine import (clip_loss,
                                                three_modality_clip_loss)

    names = ("image", "enface1", "enface2")[:3 if three else 2]
    xs = [jnp.asarray(_bank_order(inputs["x"][k], accum)) for k in names]
    w2 = jnp.asarray(_bank_order(inputs["presence"], accum))
    n = xs[0].shape[0]

    def feats(params):
        f = [x @ params["w"][k] for x, k in zip(xs, names)]
        return [v / jnp.linalg.norm(v, axis=-1, keepdims=True) for v in f]

    def loss(params, live):
        held = feats(jax.lax.stop_gradient(params))
        f = [jnp.where(live[:, None], a, b)
             for a, b in zip(feats(params), held)]
        s = jnp.exp(params["ls"])
        if three:
            return three_modality_clip_loss(*f, s[0], s[1], s[2],
                                            jnp.ones_like(w2), w2)
        return clip_loss(f[0], f[1], s[0])

    params = {"w": {k: jnp.asarray(inputs["w"][k]) for k in names},
              "ls": jnp.asarray(inputs["ls"][:3 if three else 1])}
    chunk = n // accum
    total, grads = 0.0, None
    for i in range(accum):
        live = (jnp.arange(n) // chunk) == i
        value, g = jax.value_and_grad(loss)(params, live)
        total += float(value)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    out = {f"w.{k}": np.asarray(v) for k, v in grads["w"].items()}
    out["ls"] = np.asarray(grads["ls"])
    return total / accum, out


@pytest.mark.parametrize("case,three,accum", [
    ("two", False, 1), ("three", True, 1), ("two_accum", False, 2),
    ("three_accum", True, 2)])
def test_global_clip_loss_and_gradients_match_jax(ranks, case, three, accum):
    """Every rank's loss is the global loss (with accum_freq 2, the mean of
    the chunk losses, each over the whole bank: JAX's over the 8 pairs),
    and the gradient each rank applies, tower weights and logit scales,
    is JAX's global gradient (its accumulation's, with accum_freq 2)."""
    inputs, results = ranks
    value, grads = _jax_loss_and_grads(inputs, three, accum)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{case}/loss"], value, **TOL,
                                   err_msg=f"rank {r}")
        for k, g in grads.items():
            np.testing.assert_allclose(res[f"{case}/grad/{k}"], g, **TOL,
                                       err_msg=f"rank {r} {k}")


def test_evaluate_retrieval_gathers_in_global_order(ranks):
    """Each rank encodes its rows of two eval batches; the features come
    back in the global batches' order and the metrics equal JAX's
    retrieval_metrics over all 16 pairs, on every rank."""
    from octcubem_tpu.train.clip_engine import retrieval_metrics

    inputs, results = ranks
    f = inputs["feats"]
    want = retrieval_metrics(f["image"], f["enface1"])
    for res in results:
        np.testing.assert_array_equal(res["eval/feat_image"], f["image"])
        for k, v in want.items():
            assert float(res[f"eval/{k}"]) == pytest.approx(v, abs=1e-12), k
