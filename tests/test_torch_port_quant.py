"""Port parity: int8 serving (ops/quant.py, QuantDense, vit_st(quant=True),
serve --quant int8) against the JAX package on the CPU.

The weights and the per-token activations quantize to the same int8
values and scales as the JAX functions' (equal to the bit); the int32
products are exact on both sides, so int8_matmul agrees to an fp32 ulp.
Through a model the two packages' fp32 activations differ in their last
bits (another summation order in the Dense and attention), and a token
whose value sits on a rounding edge of its int8 grid may round one step
the other way: the logits are held to 1e-3 absolute (measured max
|dlogits| is stated at each test) and every argmax equal.  The JAX side
runs attn_impl="flash" (the Pallas kernels in interpret mode), the port
B1's plain version.  Tiny model: width 64, 4 heads, 2 blocks, 6x32x32.
"""

import argparse

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.cli import serve as jserve
from octcubem_tpu.compat.torch_export import (export_state_dict,
                                              save_torch_checkpoint)
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu.ops import quant as jquant
from octcubem_tpu_torch.cli import serve as tserve
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import vit_st as tvit
from octcubem_tpu_torch.nn.layers import QuantDense
from octcubem_tpu_torch.ops import quant as tquant

KW = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
          in_chans=1, num_classes=8, embed_dim=64, depth=2, num_heads=4,
          global_pool=True)
# through two quantized blocks; measured max |dlogits| 1.2e-7 (dropout
# head) and 1.3e-7 (aggregate) on logits up to 0.41 and 0.86, 6.0e-8
# through the servers; the bound leaves room for a token that rounds one
# int8 step apart
TOL_QLOGITS = 1e-3


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("shape,scale", [((64, 96), 0.05), ((48, 40), 3.0),
                                         ((128, 8), 1e-9)])
def test_quantize_weight_matches_jax(shape, scale):
    """[K, N] JAX layout against the port's [N, K]: int8 and scale equal to
    the bit (scale 1e-9 puts whole columns under eps)."""
    w = (np.random.default_rng(0).standard_normal(shape) * scale
         ).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero channel: its scale is eps / 127
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("xshape", [(4, 37, 64), (2, 9, 16), (130, 24)])
def test_int8_matmul_matches_jax(xshape):
    """fp32 within one ulp (rtol 1e-6): the int32 products are exact, the
    rescale is the same two fp32 multiplies."""
    rng = np.random.default_rng(1)
    k = xshape[-1]
    x = rng.standard_normal(xshape).astype(np.float32)
    x[..., 0, :] = 0.0  # a zero token row: its scale is eps / 127
    w = (rng.standard_normal((k, 40)) * 0.05).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js))
    got = tquant.int8_matmul(torch.from_numpy(x),
                             torch.from_numpy(np.asarray(jq).T.copy()),
                             torch.from_numpy(np.array(js)))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_int8_mm_on_the_cpu():
    """The CPU's int8 product takes any shape (the card's shape guard is
    in test_torch_port_cuda.py); a w_q that is not [N, K] is refused."""
    a = torch.ones((5, 12), dtype=torch.int8)
    w = torch.ones((7, 12), dtype=torch.int8)
    np.testing.assert_array_equal(tquant.int8_mm(a, w).numpy(),
                                  np.full((5, 7), 12, np.int32))
    with pytest.raises(ValueError, match=r"is not \[N, 12\]"):
        tquant.int8_mm(a, torch.ones((7, 8), dtype=torch.int8))


def test_quantize_state_dict_only_touches_block_projections():
    """The port's conversion of a float state dict equals the JAX
    conversion of the same tree mapped by state_dict_from_jax; only Wqkv,
    out_proj, fc1 and fc2 change, and the result loads strictly into a
    quant=True model."""
    jm = jvit.VisionTransformerST(**KW, head_type="dropout",
                                  attn_impl="naive")
    params = _perturb(jm.init(jax.random.key(0), jnp.zeros((1, 6, 32, 32, 1))),
                      1)
    got = tquant.quantize_state_dict(state_dict_from_jax(params))
    ref = state_dict_from_jax({"params": jquant.quantize_tree(
        params["params"])})
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
    changed = {k.rsplit(".", 2)[-2] for k in got if k.endswith(".weight_q")}
    assert changed == set(tquant.QUANT_MODULES)
    assert "head.weight" in got and "blocks.0.norm1.weight" in got
    qm = tvit.VisionTransformerST(**KW, head_type="dropout", quant=True)
    qm.load_state_dict(got, strict=True)
    assert isinstance(qm.blocks[0].mixer.Wqkv, QuantDense)


@pytest.mark.parametrize("head_type", ["dropout", "aggregate"])
def test_quant_vit_st_matches_jax(head_type):
    """quant=True classifiers on the same int8 tree: logits within
    TOL_QLOGITS, argmax equal; and both near their float models
    (tests/test_quant.py's own bound, rtol 0.15 atol 0.05)."""
    jm = jvit.VisionTransformerST(**KW, head_type=head_type,
                                  attn_impl="naive")
    x = np.random.default_rng(4).standard_normal(
        (2, 6, 32, 32, 1)).astype(np.float32)
    params = _perturb(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), 2)
    qparams = {"params": jquant.quantize_tree(params["params"])}
    jq = jvit.VisionTransformerST(**KW, head_type=head_type,
                                  attn_impl="flash", quant=True)
    ref = np.asarray(jq.apply(qparams, jnp.asarray(x)))
    tq = tvit.VisionTransformerST(**KW, head_type=head_type, quant=True)
    tq.load_state_dict(state_dict_from_jax(qparams), strict=True)
    with torch.inference_mode():
        got = tq.eval()(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL_QLOGITS, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    tf = tvit.VisionTransformerST(**KW, head_type=head_type)
    tf.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        fl = tf.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, fl, rtol=0.15, atol=0.05)


def _serve_args(path, pkg):
    common = dict(aot=None, ckpt=path, precision="fp32", num_frames=6,
                  input_size=32, nb_classes=4, embed_dim=64, depth=2,
                  num_heads=4, quant="int8")
    if pkg == "port":
        common.update(device="cpu", seed=0)
    return argparse.Namespace(**common)


def test_serve_int8_matches_jax_server(tmp_path):
    """serve --quant int8 on one checkpoint: the port's predictor against
    the JAX server's, logits within TOL_QLOGITS and the served
    probabilities (softmax over each disease's pair) within it too."""
    kw = dict(KW, num_classes=4, head_type="dropout")
    jm = jvit.VisionTransformerST(**kw, attn_impl="naive")
    params = _perturb(jax.jit(jm.init)(jax.random.key(3),
                                       jnp.zeros((1, 6, 32, 32, 1))), 5)
    path = str(tmp_path / "cls.pth")
    save_torch_checkpoint(path, export_state_dict(params, style="flash"))
    predict, meta = tserve.build_predictor(_serve_args(path, "port"))
    japply, _ = jserve.build_predictor(_serve_args(path, "jax"))
    assert meta["quant"] == "int8" and meta["import"]["missing"] == []
    x = np.random.default_rng(6).random((1, 6, 32, 32, 1), dtype=np.float32)
    got, ref = predict(x), np.asarray(japply(jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(got, ref, atol=TOL_QLOGITS, rtol=0)

    def probs(lg):
        lg = lg.reshape(1, -1, 2)
        e = np.exp(lg - lg.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True))[:, :, 1]

    np.testing.assert_allclose(probs(got), probs(ref), atol=TOL_QLOGITS)
