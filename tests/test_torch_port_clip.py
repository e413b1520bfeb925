"""Port parity: the contrastive engine's losses, metrics and helpers
(train/clip_engine.py) and the LiT lock groups (train/optim.py) against
the JAX package on the CPU, from seeded numpy inputs: both CLIP losses
(a pair with no valid sample contributes 0), ``lit_lock_scales`` key by
key at several unlocked counts and both tower prefixes, the retrieval
metrics and ``evaluate_retrieval``, ``init_towers_from_retclip`` and the
retclip run's geometry check; and that the steps read nothing back to
the host.  test_torch_port_clip_steps.py holds the steps against JAX's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.models import coem as jcoem
from octcubem_tpu.train import clip_engine as jeng
from octcubem_tpu.train import optim as joptim
from octcubem_tpu_torch.compat.jax_params import (_flatten, _to_torch_key,
                                                  state_dict_from_jax)
from octcubem_tpu_torch.core import checkpoint as ckpt_lib
from octcubem_tpu_torch.models import coem as tcoem
from octcubem_tpu_torch.train import clip_engine as teng
from octcubem_tpu_torch.train import optim as toptim
from octcubem_tpu_torch.train.train_state import TrainState

TOL = dict(rtol=1e-5, atol=1e-6)
DEPTH = 10
VCFG = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
            in_chans=1, embed_dim=16, depth=DEPTH, num_heads=1)
ECFG = dict(img_size=32, patch_size=16, in_chans=3, embed_dim=16, depth=2,
            num_heads=1, num_mod_head=1)


def _feats(seed, n=6, d=8):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def test_clip_loss_matches_jax():
    a, b = _feats(0), _feats(1)
    want = float(jeng.clip_loss(jnp.asarray(a), jnp.asarray(b),
                                jnp.float32(14.3)))
    got = teng.clip_loss(torch.from_numpy(a), torch.from_numpy(b),
                         torch.tensor(14.3))
    np.testing.assert_allclose(got.item(), want, **TOL)


@pytest.mark.parametrize("w1,w2", [
    ([1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 1]),
    ([1, 1, 0, 1, 1, 1], [0, 0, 0, 0, 0, 0]),   # enface2 absent: pairs 2, 3
    ([0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]),   # only the image: loss 0
])
def test_three_modality_loss_matches_jax(w1, w2):
    f = [_feats(s) for s in (2, 3, 4)]
    w1 = np.asarray(w1, np.float32)
    w2 = np.asarray(w2, np.float32)
    s = (10.0, 12.5, 20.0)
    want = float(jeng.three_modality_clip_loss(
        *map(jnp.asarray, f), *map(jnp.float32, s), jnp.asarray(w1),
        jnp.asarray(w2)))
    got = teng.three_modality_clip_loss(
        *map(torch.from_numpy, f), *map(torch.tensor, s),
        torch.from_numpy(w1), torch.from_numpy(w2))
    np.testing.assert_allclose(got.item(), want, **TOL)
    assert torch.isfinite(got)
    if not w1.any():
        assert got.item() == 0.0


def _jax_tree(cls_model: bool):
    kw = dict(embed_dim=8, vision_cfg=VCFG, enface_cfg=ECFG)
    if cls_model:
        jm = jcoem.COEP2TowerClassification(num_classes=3, **kw)
        tm = tcoem.COEP2TowerClassification(num_classes=3, **kw)
    else:
        jm, tm = jcoem.COEP2Tower(**kw), tcoem.COEP2Tower(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 6, 32, 32, 1)),
                            jnp.zeros((1, 32, 32, 3)))
    return shapes, tm


@pytest.mark.parametrize("cls_model", [False, True])
@pytest.mark.parametrize("n_unlocked", [0, 1, 2, 9, DEPTH + 2])
def test_lit_lock_scales_match_jax(n_unlocked, cls_model):
    """Every param's 1.0 / 0.0 equal to JAX's, key by key, with the tower
    prefix of each model kind ('visual' / 'clip.visual')."""
    shapes, tm = _jax_tree(cls_model)
    jprefix, tprefix = (("clip/visual/", "clip.visual.") if cls_model
                        else ("visual/", "visual."))
    jscales = joptim.lit_lock_scales(shapes, DEPTH, n_unlocked, jprefix)
    want = {_to_torch_key(p)[0]: s
            for p, s in _flatten(dict(jscales["params"])).items()}
    got = toptim.lit_lock_scales(tm, DEPTH, n_unlocked, tprefix)
    assert got == want
    frozen = sum(1 for v in got.values() if v == 0.0)
    assert (frozen == 0) == (n_unlocked >= DEPTH + 2)


def test_make_partition_freezes_for_real():
    tm = tcoem.COEP2Tower(embed_dim=8, vision_cfg=VCFG, enface_cfg=ECFG)
    scales = toptim.lit_lock_scales(tm, DEPTH, 2)
    trainable = toptim.make_partition(tm, {k: s > 0 for k, s in
                                           scales.items()})
    for name, p in tm.named_parameters():
        assert p.requires_grad == (scales[name] > 0) == (name in trainable)
    assert "visual.trunk.blocks.9.mlp.fc2.weight" in trainable
    assert "visual.trunk.norm.weight" in trainable
    assert "visual.trunk.blocks.8.mlp.fc2.weight" not in trainable
    tx = toptim.AdamW(trainable, 1e-3)
    assert set(tx.state_dict()["mu"]) == set(trainable)


def test_scale_by_tree_folds_into_the_update():
    p = {"a": torch.ones(3, requires_grad=True),
         "b": torch.ones(3, requires_grad=True)}
    tx = toptim.scale_by_tree(toptim.AdamW(p, 0.1, weight_decay=0.5),
                              {"a": 0.0, "b": 1.0})
    for t in p.values():
        t.grad = torch.ones(3)
    tx.step()
    assert torch.equal(p["a"], torch.ones(3))
    assert not torch.equal(p["b"], torch.ones(3))


def test_retrieval_metrics_match_jax():
    a, b = _feats(5, n=24), _feats(6, n=24)
    b[:12] = a[:12] + 0.1 * b[:12]  # half the pairs findable
    assert teng.retrieval_metrics(a, b) == jeng.retrieval_metrics(a, b)
    groups = np.arange(24) // 3
    assert (teng.retrieval_metrics_dup_corrected(a, b, groups)
            == jeng.retrieval_metrics_dup_corrected(a, b, groups))


@pytest.mark.parametrize("three_mod", [False, True])
def test_evaluate_retrieval_matches_jax(three_mod):
    """Features and metrics over two val batches, the live model and an
    encode_fn; the returned bank is the pkl payload."""
    ecfg = dict(ECFG, num_mod_head=2)
    vcfg = dict(VCFG, depth=2)
    cls_j, cls_t = ((jcoem.COEP3Tower, tcoem.COEP3Tower) if three_mod
                    else (jcoem.COEP2Tower, tcoem.COEP2Tower))
    jm = cls_j(embed_dim=8, vision_cfg=vcfg, enface_cfg=ecfg,
               attn_impl="naive")
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        b = {"image": rng.random((3, 6, 32, 32, 1), np.float32)}
        names = ("enface1", "enface2") if three_mod else ("enface",)
        for k in names:
            b[k] = rng.random((3, 32, 32, 3), np.float32)
        batches.append(b)
    args = [batches[0][k] for k in batches[0]]
    params = jax.jit(jm.init)(jax.random.key(0), *args)
    want, wf = jeng.evaluate_retrieval(
        jm, params, [{k: jnp.asarray(v) for k, v in b.items()}
                     for b in batches], three_mod=three_mod,
        return_features=True)
    tm = tcoem.create_model(cls_t, device="cpu", embed_dim=8,
                            vision_cfg=vcfg, enface_cfg=ecfg)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    got, gf = teng.evaluate_retrieval(tm, tb, three_mod=three_mod,
                                      return_features=True)
    assert set(gf) == set(wf)
    for k in wf:
        np.testing.assert_allclose(gf[k], wf[k], atol=1e-5, err_msg=k)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], atol=1e-12)
    n = 3 if three_mod else 2
    again = teng.evaluate_retrieval(
        None, tb, three_mod=three_mod,
        encode_fn=lambda *xs: tm.eval()(*xs)[:n])
    assert again == got


def _retclip_run(tmp_path, num_heads=1, enface_heads=1):
    """A retclip-like run dir: params.txt and ckpt/0 of a 2-tower state."""
    vcfg = dict(VCFG, depth=2, num_heads=num_heads)
    ecfg = dict(ECFG, num_heads=enface_heads)
    tm = tcoem.create_model(tcoem.COEP2Tower, device="cpu", seed=5,
                            embed_dim=8, vision_cfg=vcfg, enface_cfg=ecfg)
    state = TrainState.create(tm, toptim.AdamW(tm, 1e-3), 1)
    ckpt_lib.save_checkpoint(str(tmp_path / "run" / "ckpt"), 0, state,
                             {"epoch": 0})
    with open(tmp_path / "run" / "params.txt", "w") as f:
        json.dump({"vision_cfg": vcfg, "enface_cfg": ecfg}, f)
    return tm, str(tmp_path / "run")


def test_init_towers_from_retclip(tmp_path):
    """The towers and logit scale copied, the classification head kept;
    a model of another enface structure is refused."""
    src, run = _retclip_run(tmp_path)
    vcfg = dict(VCFG, depth=2)
    cls = tcoem.create_model(tcoem.COEP2TowerClassification, device="cpu",
                             embed_dim=8, num_classes=3, vision_cfg=vcfg,
                             enface_cfg=ECFG)
    head = {k: v.clone() for k, v in
            cls.classification_head.state_dict().items()}
    _, copied = teng.init_towers_from_retclip(cls, run)
    want = src.state_dict()
    assert copied == len(want)
    for k, v in cls.clip.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in cls.classification_head.state_dict().items():
        assert torch.equal(v, head[k])
    three = tcoem.create_model(tcoem.COEP3TowerClassification, device="cpu",
                               embed_dim=8, num_classes=3, vision_cfg=vcfg,
                               enface_cfg=dict(ECFG, num_mod_head=2))
    with pytest.raises(ValueError, match="structure mismatch"):
        teng.init_towers_from_retclip(three, run)


@pytest.mark.parametrize("heads,ok", [(1, True), (2, False)])
def test_retclip_run_geometry_check(tmp_path, heads, ok):
    """A head count that differs from the run's params.txt is refused by
    both packages; a run without params.txt passes."""
    _, run = _retclip_run(tmp_path)
    vcfg = dict(VCFG, num_heads=heads)
    for check in (teng.check_retclip_run_geometry,
                  jeng.check_retclip_run_geometry):
        if ok:
            check(run + "/ckpt", vcfg, ECFG)
        else:
            with pytest.raises(SystemExit, match="num_heads"):
                check(run + "/ckpt", vcfg, ECFG)
        check(str(tmp_path / "nowhere"), vcfg, ECFG)


@pytest.mark.parametrize("kind", ["accum", "accum3", "cls"])
def test_steps_read_nothing_back_to_the_host(kind, monkeypatch):
    """The contrastive steps issue their work and return 0-d tensors:
    every tensor -> host conversion raises inside them (the CLI reads step
    t-1's loss after issuing step t)."""
    vcfg, ecfg = dict(VCFG, depth=2), dict(ECFG, num_mod_head=2)
    rng = np.random.default_rng(8)
    lead = (2, 2) if kind.startswith("accum") else (4,)
    batch = {"image": torch.from_numpy(
        rng.random(lead + (6, 32, 32, 1), np.float32))}
    names = ("enface1", "enface2") if kind == "accum3" else ("enface",)
    for k in names:
        batch[k] = torch.from_numpy(rng.random(lead + (32, 32, 3),
                                               np.float32))
    if kind == "accum3":
        batch["weight1"] = torch.ones(lead)
        batch["weight2"] = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    cls = {"accum": tcoem.COEP2Tower, "accum3": tcoem.COEP3Tower,
           "cls": tcoem.COEP2TowerClassification}[kind]
    kw = dict(num_classes=3) if kind == "cls" else {}
    tm = tcoem.create_model(cls, device="cpu", embed_dim=8, vision_cfg=vcfg,
                            enface_cfg=ecfg, **kw)
    tx = toptim.AdamW(tm, 1e-3)
    state = TrainState.create(tm, tx, 1)
    if kind == "accum":
        step = teng.make_clip_accum_train_step(tm, tx, 2)
    elif kind == "accum3":
        step = teng.make_clip_accum_train_step_3mod(tm, tx, 2)
    else:
        from octcubem_tpu_torch.train import losses

        batch["label"] = torch.tensor([0, 2, 1, 0])
        step = teng.make_clip_cls_train_step(tm, tx, losses.softmax_ce)

    def refuse(*a, **k):
        raise AssertionError("host read inside the step")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "__bool__", "__float__",
                     "__int__", "__index__"):
            m.setattr(torch.Tensor, name, refuse)
        state, metrics = step(state, batch)
    assert state.step == 1 and tx.count == 1
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])
