"""Port parity for the fine-tuning family's ViTs: models/vit2d.py,
models/vit_3dhead.py and the vit_st options (return_embeddings,
return_hidden, lock_groups) against the JAX package, weights carried by
compat.jax_params.state_dict_from_jax.  Small: embed 128, 2 heads (head
dim 64), depth 2; the JAX side runs attn_impl="flash" (Pallas in
interpret mode), the port its default path (B1 / B2's plain versions on
the CPU).  Forward fp32 at 5e-5, d sum(out * w) / d params per leaf at
5e-4 of the leaf's largest entry, bf16 forwards at the vit_st tests'
2e-2.  Layer-decay scales key by key, with and without the params root
the JAX CLI passes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.models import registry as jreg
from octcubem_tpu.models import vit2d as jv2
from octcubem_tpu.models import vit_3dhead as jv3
from octcubem_tpu.models import vit_st as jvst
from octcubem_tpu.nn import layers as jlayers
from octcubem_tpu.train import optim as joptim
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import registry as treg
from octcubem_tpu_torch.models import vit2d as tv2
from octcubem_tpu_torch.models import vit_3dhead as tv3
from octcubem_tpu_torch.models import vit_st as tvst
from octcubem_tpu_torch.nn import layers as tlayers
from octcubem_tpu_torch.train import optim as toptim

GRAD_REL = 5e-4
BF16_ATOL = 2e-2
V2 = dict(img_size=32, patch_size=16, in_chans=1, num_classes=3,
          embed_dim=128, depth=2, num_heads=2)
V3 = dict(num_classes=3, img_size=32, patch_size=16, in_chans=1,
          embed_dim=128, depth=2, num_heads=2)
ST = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
          in_chans=1, num_classes=4, embed_dim=128, depth=2, num_heads=2)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_grads_close(ref_grads, model):
    for name, p in model.named_parameters():
        ref = ref_grads[name].numpy()
        tol = GRAD_REL * max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=tol, rtol=0,
                                   err_msg=name)


def _hold(jcls, tcls, kw, x, seed, **apply_kw):
    """Forward and per-leaf gradients of sum(out * w), fp32."""
    jm = jcls(**kw, attn_impl="naive")
    params = _perturb(jax.jit(jm.init)(jax.random.key(seed),
                                       jnp.asarray(x)), seed)
    jm = jcls(**kw, attn_impl="flash")
    out_shape = jax.eval_shape(lambda p: jm.apply(p, jnp.asarray(x)), params)
    w = _x(out_shape.shape, seed + 1)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x))
        return (out * w).sum(), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = tcls(**kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=5e-5, rtol=5e-5)
    assert_grads_close(state_dict_from_jax(jgrads), tm)
    return params


@pytest.mark.parametrize("global_pool,parity", [
    (True, "standard"), (False, "standard"), (True, "flash"),
    (False, "flash")])
def test_vit2d_forward_and_grads_match_jax(global_pool, parity):
    kw = dict(V2, global_pool=global_pool, parity=parity)
    params = _hold(jv2.VisionTransformer2D, tv2.VisionTransformer2D, kw,
                   _x((2, 32, 32, 1), 1), 3)
    keys = set(state_dict_from_jax(params))
    # a checkpoint holds fc_norm (global pool) or norm, never both
    assert ("fc_norm.weight" in keys) == global_pool
    assert ("norm.weight" in keys) == (not global_pool)


def test_vit2d_feature_without_head_and_bf16_match_jax():
    x = _x((2, 32, 32, 1), 2)
    kw = dict(V2, num_classes=0)
    jm = jv2.VisionTransformer2D(**kw, attn_impl="naive")
    params = _perturb(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), 4)
    assert "head" not in params["params"]
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 5e-5),
                          (jnp.bfloat16, torch.bfloat16, BF16_ATOL)):
        ref = np.asarray(jax.jit(jv2.VisionTransformer2D(
            **kw, dtype=jdt, attn_impl="flash").apply)(
                params, jnp.asarray(x)), np.float32)
        tm = tv2.VisionTransformer2D(**kw, dtype=tdt)
        tm.load_state_dict(state_dict_from_jax(params), strict=True)
        with torch.no_grad():
            out = tm(torch.from_numpy(x)).float().numpy()
        assert out.shape == (2, 128)
        np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_vit_3dhead_forward_and_grads_match_jax():
    params = _hold(jv3.VisionTransformer3DHead, tv3.VisionTransformer3DHead,
                   V3, _x((2, 3, 32, 32, 1), 5), 6)
    assert "trunk.head.weight" not in state_dict_from_jax(params)


def test_vit_3dhead_bf16_matches_jax():
    x = _x((1, 3, 32, 32, 1), 7)
    jm = jv3.VisionTransformer3DHead(**V3, attn_impl="naive")
    params = _perturb(jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x)), 8)
    ref = np.asarray(jax.jit(jv3.VisionTransformer3DHead(
        **V3, dtype=jnp.bfloat16, attn_impl="flash").apply)(
            params, jnp.asarray(x)), np.float32)
    tm = tv3.VisionTransformer3DHead(**V3, dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=BF16_ATOL, rtol=0)


# ------------------------------------------------------------ vit_st options

@pytest.fixture(scope="module")
def st_params():
    x = _x((2, 6, 32, 32, 1), 9)
    jm = jvst.VisionTransformerST(**ST, head_type="dropout",
                                  attn_impl="naive")
    return x, _perturb(jax.jit(jm.init)(jax.random.key(2), jnp.asarray(x)), 10)


@pytest.mark.parametrize("parity", ["flash", "standard"])
def test_return_hidden_matches_jax(st_params, parity):
    """Under flash parity each entry is the block's MLP branch, not the
    residual stream; under standard parity the hidden state."""
    x, params = st_params
    jm = jvst.VisionTransformerST(**ST, head_type="dropout", parity=parity,
                                  attn_impl="flash")
    ref = jax.jit(lambda p, v: jm.apply(p, v, return_hidden=True))(
        params, jnp.asarray(x))
    tm = tvst.VisionTransformerST(**ST, head_type="dropout", parity=parity)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), return_hidden=True)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=5e-5)


def test_stack_return_hidden_collects_mlp_branch_under_flash():
    x = torch.from_numpy(_x((2, 9, 128), 11))
    for parity in ("flash", "standard"):
        stack = tlayers.TransformerStack(2, 128, 2, parity=parity).eval()
        with torch.no_grad():
            hidden = stack(x, return_hidden=True)
            h, m = stack[0](x)
            h2, m2 = stack[1](h)
        want = [m, m2] if parity == "flash" else [h, h2]
        assert all(torch.equal(a, b) for a, b in zip(hidden, want))
        assert torch.equal(hidden[-1], stack(x))


def test_return_embeddings_matches_jax(st_params):
    x, params = st_params
    jm = jvst.VisionTransformerST(**ST, head_type="dropout",
                                  attn_impl="flash")
    jl, je = jax.jit(lambda p, v: jm.apply(p, v, return_embeddings=True))(
        params, jnp.asarray(x))
    tm = tvst.VisionTransformerST(**ST, head_type="dropout")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        tl, te = tm.eval()(torch.from_numpy(x), return_embeddings=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=5e-5,
                               rtol=5e-5)
    assert te.shape == (2, 128)


@pytest.mark.parametrize("head_type,sep", [("aggregate", True),
                                           ("dropout", False)])
def test_lock_groups_match_jax(head_type, sep):
    """The same groups in the same order, in the port's names; every
    param falls in exactly one group."""
    kw = dict(ST, head_type=head_type, sep_pos_embed=sep)
    jg = jvst.VisionTransformerST(**kw).lock_groups()
    tm = tvst.VisionTransformerST(**kw)
    tg = tm.lock_groups()
    conv = [[e.replace("blocks/blocks_", "blocks.") for e in g] for g in jg]
    assert tg == conv
    for name, _ in tm.named_parameters():
        owners = [i for i, g in enumerate(tg)
                  if any(name == e or name.startswith(e + ".") for e in g)]
        assert len(owners) == 1 or name.startswith("high_res"), name
    j3 = jv3.VisionTransformer3DHead(**V3).lock_groups()
    t3 = tv3.VisionTransformer3DHead(**V3).lock_groups()
    assert t3 == [[e.replace("/blocks/blocks_", ".blocks.").replace("/", ".")
                   for e in g] for g in j3]


def _layer_decay_case(family):
    if family == "vit_st":
        jm = jvst.VisionTransformerST(**ST, attn_impl="naive")
        return jm, tvst.VisionTransformerST(**ST), (1, 6, 32, 32, 1)
    if family == "vit2d":
        jm = jv2.VisionTransformer2D(**V2, attn_impl="naive")
        return jm, tv2.VisionTransformer2D(**V2), (1, 32, 32, 1)
    jm = jv3.VisionTransformer3DHead(**V3, attn_impl="naive")
    return jm, tv3.VisionTransformer3DHead(**V3), (1, 2, 32, 32, 1)


@pytest.mark.parametrize("family", ["vit_st", "vit2d", "vit_3dhead"])
def test_layer_decay_scales_match_jax_key_by_key(family):
    """Over the bare tree (embeddings at layer 0) and over the tree with
    its params root, as the JAX CLI builds its optimizer (no name is
    layer 0 there; the port's CLI passes name_prefix='params.')."""
    jm, tm, shape = _layer_decay_case(family)
    params = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros(shape))
    for rooted in (False, True):
        tree = params if rooted else params["params"]
        js = joptim.layer_decay_scales(tree, 2, 0.65)
        # each scale as a leaf of its param's shape, carried to port keys
        full = jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32),
                            js, tree)
        want = {k: float(v.flatten()[0])
                for k, v in state_dict_from_jax(full).items()}
        got = toptim.layer_decay_scales(tm, 2, 0.65,
                                        "params." if rooted else "")
        assert got == pytest.approx(want, rel=1e-6)
        assert set(got) == set(want)
        # vit_3dhead's embeddings sit under trunk/: never layer 0 in JAX
        assert len(set(got.values())) == (
            3 if rooted or family == "vit_3dhead" else 4)
    assert getattr(tm, "depth", 24) == 2


# ------------------------------------------------------------- registry

def test_registry_builds_the_fine_tuning_families():
    m = treg.create_model("vit2d", "vit_large_patch16", device="cpu",
                          depth=1, img_size=32, in_chans=1, num_classes=2)
    assert isinstance(m, tv2.VisionTransformer2D) and not m.training
    assert m.depth == 1 and hasattr(m, "fc_norm") and not hasattr(m, "norm")
    m = treg.create_model("vit_3dhead", "vit_large_patch16", device="cpu",
                          depth=1, img_size=32, in_chans=1, num_classes=2)
    assert isinstance(m, tv3.VisionTransformer3DHead)
    assert m.trunk.blocks.parity == "flash"
    assert "vit2d" in jreg._FAMILIES and "slivit" in jreg._FAMILIES
    with pytest.raises(KeyError, match="unknown model"):
        treg.create_model("vit2d", "no_such_model")


def test_block_return_pair_unchanged():
    jm = jlayers.Block(128, 2, attn_impl="flash")
    x = _x((1, 5, 128), 12)
    params = _perturb(jax.jit(jm.init)(jax.random.key(3), jnp.asarray(x)), 13)
    ref_h, ref_m = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = tlayers.Block(128, 2)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        h, m = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=5e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), atol=5e-5)
