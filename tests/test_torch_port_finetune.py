"""The port's fine-tune engine against the JAX package's: train steps
against ``make_finetune_train_step`` (loss and updated params, at drop
path 0, aggregate head, the CLI's layer-decay AdamW), the NaN guard that
reverts the whole state on the device, the train / eval modes around
drop path and the dropout head, no host read inside a step, the gated
AdamW against the plain one, ``evaluate`` and ``dump_frame_inference``;
and the fine-tune data: MedMNIST, EchoNet (an .avi written by cv2) and the
AI-READI visit-correct split, item for item the JAX package's."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from octcubem_tpu.data import aireadi as jaireadi
from octcubem_tpu.data import crossmodal as jcross
from octcubem_tpu.models import vit_st as jvst
from octcubem_tpu.train import finetune_engine as jeng
from octcubem_tpu.train import losses as jlosses
from octcubem_tpu.train import optim as joptim
from octcubem_tpu.train import schedules as jsched
from octcubem_tpu.train.train_state import TrainState as JState
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.data import aireadi as taireadi
from octcubem_tpu_torch.data import crossmodal as tcross
from octcubem_tpu_torch.models import vit_st as tvst
from octcubem_tpu_torch.train import finetune_engine as teng
from octcubem_tpu_torch.train import losses as tlosses
from octcubem_tpu_torch.train import optim as toptim
from octcubem_tpu_torch.train import schedules as tsched
from octcubem_tpu_torch.train.train_state import TrainState

KW = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
          in_chans=1, num_classes=6, embed_dim=128, depth=2, num_heads=2,
          head_type="aggregate")
# Adam's u = m / (sqrt(v) + eps) is steep where a gradient cancels to ~0,
# so the param comparisons run eps = 1e-5, as test_torch_port_train.py
# does (du <= 5e-4 there, dp <= lr * du)
EPS = 1e-5
TOL_LOSS = dict(rtol=1e-5, atol=1e-6)
TOL_PARAM = dict(rtol=1e-5, atol=2e-6)
LR, STEPS = 1e-3, 8


def _batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 32, 32, 1)).astype(np.float32)
    if nan:
        x[0, 0, 0, 0, 0] = np.nan
    y = (rng.random((2, 4)) > 0.5).astype(np.float32)
    y[:, 0] = (y[:, 1:].sum(1) == 0)
    return x, y


@pytest.fixture(scope="module")
def jax_run():
    """JAX: the CLI's optimizer (layer decay over the rooted tree) at eps
    1e-5, three steps: finite, NaN, finite."""
    jm = jvst.VisionTransformerST(**KW, attn_impl="naive")
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 6, 32, 32, 1)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    sched = jsched.warmup_half_cosine(LR, 0.0, 0, 1, STEPS)
    tx = optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.95, eps=EPS),
        optax.add_decayed_weights(0.05, joptim.weight_decay_mask(params)),
        joptim.scale_by_tree(joptim.layer_decay_scales(params, 2, 0.65)),
        optax.scale_by_learning_rate(sched))
    jm = jvst.VisionTransformerST(**KW, attn_impl="flash")
    step = jeng.make_finetune_train_step(
        jm, tx, jlosses.make_criterion("multi_task_default"))
    state = JState.create(params, tx, jax.random.key(2))
    out = []
    for seed, nan in ((3, False), (4, True), (5, False)):
        x, y = _batch(seed, nan)
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        out.append((float(m["loss"]), bool(m["finite"]),
                    jax.tree.map(np.asarray, state.params)))
    return params, out


def _port_state(params, drop_path=0.0, **kw):
    tm = tvst.VisionTransformerST(**KW, drop_path_rate=drop_path, **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tx = toptim.AdamW(tm, tsched.warmup_half_cosine(LR, 0.0, 0, 1, STEPS),
                      0.05, eps=EPS,
                      scales=toptim.layer_decay_scales(tm, 2, 0.65, "params."))
    return tm, tx, TrainState.create(tm, tx, 0)


def _step(tm, tx):
    return teng.make_finetune_train_step(
        tm, tx, tlosses.make_criterion("multi_task_default"))


def test_steps_match_jax_with_nan_revert(jax_run):
    """Loss and params after each of three steps equal JAX's: the NaN
    step is non-finite in both and leaves the params where they were."""
    params, ref = jax_run
    tm, tx, state = _port_state(params)
    step = _step(tm, tx)
    for i, (seed, nan) in enumerate(((3, False), (4, True), (5, False))):
        x, y = _batch(seed, nan)
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        jloss, jfinite, jparams = ref[i]
        assert bool(m["finite"]) == jfinite == (not nan)
        if not nan:
            np.testing.assert_allclose(m["loss"].item(), jloss, **TOL_LOSS)
        want = state_dict_from_jax(jparams)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), err_msg=name,
                                       **TOL_PARAM)
    assert int(tx.count) == 2 and int(state.step) == 2


def test_nan_step_reverts_the_whole_state_and_only_the_generator_moves(
        jax_run):
    params, _ = jax_run
    tm, tx, state = _port_state(params, drop_path=0.3)
    step = _step(tm, tx)
    x, y = _batch(3)
    state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
    snap = {k: v.clone() for k, v in tm.state_dict().items()}
    mu = [m.clone() for m in tx.mu]
    nu = [v.clone() for v in tx.nu]
    count, n_step = tx.count.clone(), state.step.clone()
    gen = state.generator.get_state()
    xn, yn = _batch(4, nan=True)
    state, m = step(state, torch.from_numpy(xn), torch.from_numpy(yn))
    assert not bool(m["finite"])
    assert all(torch.equal(snap[k], v) for k, v in tm.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(mu, tx.mu))
    assert all(torch.equal(a, b) for a, b in zip(nu, tx.nu))
    assert torch.equal(tx.count, count) and torch.equal(state.step, n_step)
    assert not torch.equal(state.generator.get_state(), gen)
    # the next finite step equals a run that never took the NaN step, its
    # generator moved on by the same draws
    after_nan = state.generator.get_state()
    x2, y2 = _batch(5)
    state, m = step(state, torch.from_numpy(x2), torch.from_numpy(y2))
    got = {k: v.clone() for k, v in tm.state_dict().items()}
    tm2, tx2, state2 = _port_state(params, drop_path=0.3)
    step2 = _step(tm2, tx2)
    state2, _ = step2(state2, torch.from_numpy(x), torch.from_numpy(y))
    state2.generator.set_state(after_nan)
    state2, m2 = step2(state2, torch.from_numpy(x2), torch.from_numpy(y2))
    assert torch.equal(m["loss"], m2["loss"])
    assert all(torch.equal(got[k], v) for k, v in tm2.state_dict().items())


def test_step_trains_with_drop_path_and_evaluate_runs_eval_mode(jax_run):
    """The step runs in training mode (drop path draws from the state's
    generator), evaluate in eval mode with no gradient, deterministic."""
    params, _ = jax_run
    tm, tx, state = _port_state(params, drop_path=0.5)
    crit = tlosses.make_criterion("multi_task_default")
    x, y = (torch.from_numpy(a) for a in _batch(3))
    g = torch.Generator().manual_seed(0)
    g.set_state(state.generator.get_state())
    tm.train()
    with torch.no_grad():
        want = crit(tm(x, g), y)
    tm.eval()
    with torch.no_grad():
        eval_loss = crit(tm(x), y)
    state, m = _step(tm, tx)(state, x, y)
    assert tm.training
    assert torch.equal(m["loss"], want) and not torch.equal(want, eval_loss)
    predict = teng.make_predict_step(tm)
    a, b = predict(x), predict(x)
    assert not tm.training and torch.equal(a, b) and not a.requires_grad
    metrics, yt, yp = teng.evaluate(predict, [(x, y.numpy())] * 2,
                                    "multi_task_default")
    assert yp.shape == (4, 6) and yp.dtype == np.float32
    assert set(metrics) >= {"roc", "auprc", "f1"}


def test_dropout_head_draws_its_mask_in_training():
    tm = tvst.create_model(tvst.VisionTransformerST, device="cpu",
                           **dict(KW, head_type="dropout"), dropout=0.5)
    x = torch.from_numpy(_batch(3)[0])
    tm.train()
    a = tm(x, torch.Generator().manual_seed(1))
    b = tm(x, torch.Generator().manual_seed(1))
    c = tm(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    tm.eval()
    assert torch.equal(tm(x), tm(x))


class _NoHostRead:
    """Makes every tensor -> host conversion raise while active."""

    NAMES = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__",
             "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*a, **k):
            raise AssertionError("host read inside the step")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def test_step_reads_nothing_back_to_the_host(jax_run):
    params, _ = jax_run
    tm, tx, state = _port_state(params, drop_path=0.2)
    step = _step(tm, tx)
    for seed, nan in ((3, False), (4, True), (5, False)):
        x, y = (torch.from_numpy(a) for a in _batch(seed, nan))
        with _NoHostRead():
            state, m = step(state, x, y)
    assert int(tx.count) == 2


def test_gated_adamw_agrees_with_the_plain_update():
    """Finite steps through step(ok=True) against step(): the same params
    and moments, with the schedule and bias correction read at the
    count on the device."""
    torch.manual_seed(0)
    a = torch.nn.Linear(8, 4)
    b = torch.nn.Linear(8, 4)
    b.load_state_dict(a.state_dict())
    sched = tsched.warmup_half_cosine(1e-2, 1e-4, 1, 3, 4)
    ta = toptim.AdamW(a, sched, 0.05, clip_grad=1.0)
    tb = toptim.AdamW(b, sched, 0.05, clip_grad=1.0)
    ok = torch.tensor(True)
    for i in range(12):
        g = torch.Generator().manual_seed(i)
        for m in (a, b):
            for p in m.parameters():
                p.grad = torch.randn(p.shape, generator=g)
                g.manual_seed(i)
        ta.step()
        tb.step(ok=ok)
        for p, q in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
    assert ta.count == int(tb.count) == 12
    for m, n in zip(ta.mu + ta.nu, tb.mu + tb.nu):
        torch.testing.assert_close(m, n, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ok", [None, True])
def test_gated_adamw_refuses_a_schedule_it_cannot_size(ok):
    """A schedule without total_steps cannot size the device LR table:
    the first step, gated or not, raises before it changes anything,
    where a table of one entry would clamp every step to lr(0), 0 under
    warmup."""
    lin = torch.nn.Linear(8, 4)
    before = [p.detach().clone() for p in lin.parameters()]
    tx = toptim.AdamW(lin, lambda s: 1e-3 * s, 0.05)
    for p in lin.parameters():
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match="total_steps"):
        tx.step(ok=None if ok is None else torch.tensor(ok))
    assert all(torch.equal(a, p) for a, p in zip(before, lin.parameters()))
    assert int(tx.count) == 0
    sched = tsched.warmup_half_cosine(1e-2, 1e-4, 1, 3, 4)
    assert sched.total_steps == 12
    assert tsched.clip_cosine_lr(1e-3, 2, 9).total_steps == 9


def test_dump_frame_inference(tmp_path):
    names, yt, yp = ["a", "b"], np.array([0, 1]), np.array([[0.1], [0.9]])
    p = teng.dump_frame_inference(str(tmp_path), "val", names, yt, yp,
                                  embeddings=np.ones((2, 3)))
    jp = jeng.dump_frame_inference(str(tmp_path / "j"), "val", names, yt, yp,
                                   embeddings=np.ones((2, 3)))
    assert os.path.basename(p) == os.path.basename(jp)
    got, want = (pickle.load(open(f, "rb")) for f in (p, jp))
    assert got["names"] == want["names"]
    for k in ("y_true", "y_pred", "embeddings"):
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------------ data

def test_medmnist_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "n.npz",
             train_images=(rng.random((3, 28, 28, 28)) * 255).astype(np.uint8),
             train_labels=rng.integers(0, 2, (3, 1)))
    for frames, size in ((28, 28), (16, 32)):
        j = jcross.MedMNIST3DDataset(str(tmp_path / "n.npz"), "train",
                                     num_frames=frames, input_size=size)
        t = tcross.MedMNIST3DDataset(str(tmp_path / "n.npz"), "train",
                                     num_frames=frames, input_size=size)
        assert len(j) == len(t) == 3
        for i in range(3):
            (jv, jy), (tv, ty) = j[i], t[i]
            assert tv.shape == (frames, size, size, 1) and ty == jy
            np.testing.assert_array_equal(tv, jv)


def test_echonet_matches_jax(tmp_path):
    import cv2

    os.makedirs(tmp_path / "Videos")
    rng = np.random.default_rng(0)
    for k in range(2):
        wr = cv2.VideoWriter(str(tmp_path / "Videos" / f"v{k}.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 64))
        for _ in range(12):
            wr.write((rng.random((64, 64, 3)) * 255).astype(np.uint8))
        wr.release()
    with open(tmp_path / "FileList.csv", "w") as f:
        f.write("FileName,EF,Split\nv0,55.3,TRAIN\nv1.avi,61.0,VAL\n")
    for split in ("TRAIN", "VAL"):
        for std in (True, False):
            j = jcross.EchoNetDataset(str(tmp_path), split, num_frames=8,
                                      input_size=32, standardize=std)
            t = tcross.EchoNetDataset(str(tmp_path), split, num_frames=8,
                                      input_size=32, standardize=std)
            assert len(t) == len(j) == 1
            (jv, je), (tv, te) = j[0], t[0]
            assert tv.shape == (8, 32, 32, 1) and te == je
            np.testing.assert_array_equal(tv, jv)


def _manifest():
    return [{"participant_id": f"P{i % 7}",
             "manufacturers_model_name": ["Spectralis", "Maestro2", "Triton",
                                          "Cirrus"][i % 4],
             "filepath": f"vol_{i}.dcm",
             "laterality": "OD" if i % 2 == 0 else "OS",
             "anatomic_region": "macula" if i % 3 else "disc",
             "visit": str(i // 7), "label_dr": str(i % 2)}
            for i in range(28)]


@pytest.mark.parametrize("fmt", ["csv", "tsv", "json"])
def test_aireadi_visits_and_split_match_jax(fmt, tmp_path):
    import csv
    import json

    rows = _manifest()
    path = str(tmp_path / f"m.{fmt}")
    if fmt == "json":
        json.dump(rows, open(path, "w"))
    else:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, list(rows[0]),
                               delimiter="\t" if fmt == "tsv" else ",")
            w.writeheader()
            w.writerows(rows)
    assert taireadi.load_manifest(path) == jaireadi.load_manifest(path)
    man = taireadi.load_manifest(path)
    for kw in ({}, {"device": "Maestro2"}, {"laterality": "od"},
               {"anatomic_region": "disc", "device": "Cirrus"}):
        jv = jaireadi.build_aireadi_visits(man, "/data", **kw)
        tv = taireadi.build_aireadi_visits(man, "/data", **kw)
        assert [vars(v) for v in tv] == [vars(v) for v in jv]
    visits = taireadi.build_aireadi_visits(man)
    for seed in range(3):
        got = taireadi.visit_correct_split(visits, 0.2, 0.3, seed=seed)
        want = jaireadi.visit_correct_split(
            jaireadi.build_aireadi_visits(man), 0.2, 0.3, seed=seed)
        assert [[v.frames for v in s] for s in got] == [
            [v.frames for v in s] for s in want]
        pids = [{v.patient_id for v in s} for s in got]
        assert not (pids[0] & pids[1] or pids[0] & pids[2]
                    or pids[1] & pids[2])
