"""Rematerialisation in the port (nn/layers.py) on the CPU.

- ``remat``, ``remat_norm`` and ``MaskedAutoencoderViT3D.with_remat``
  give gradients bit-identical to the plain graph at drop_path_rate > 0:
  the drop-path masks come from an explicit generator, which checkpoint's
  own RNG preservation does not restore, so the checkpointed blocks
  replay it from its saved state.  A negative control checkpoints
  without the replay and must differ.
- The remat MAE against the JAX package's remat MAE (``remat=True``,
  deterministic: JAX's drop path draws from its own rng streams), loss
  and per-leaf gradients at the MAE tests' tolerances.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.utils.checkpoint import checkpoint

from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import vit_st as tvit
from octcubem_tpu_torch.nn import layers

from test_torch_port_mae import (GRAD_REL, TOL_OUT, assert_grads_close,
                                 jax_init, jax_noise, model_kw, torch_model,
                                 volume)

DROP = 0.3


def _mae_grads(model, x, seed=4):
    """Loss and per-parameter gradients of one training forward, its
    masking noise and drop-path masks from a generator seeded ``seed``;
    also the generator's end state."""
    model.train()
    g = torch.Generator().manual_seed(seed)
    noise = torch.rand((x.shape[0], model.num_tokens(x)), generator=g)
    loss = model(x, 0.9, noise, generator=g)[0]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    return loss.detach(), grads, g.get_state()


def _assert_bit_identical(a, b):
    la, ga, sa = a
    lb, gb, sb = b
    assert torch.equal(la, lb)
    assert torch.equal(sa, sb)
    for x, y in zip(ga, gb):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def _pair(**remat_kw):
    kw = model_kw("a", drop_path_rate=DROP)
    _, params = jax_init(model_kw("a"), volume("a"), 0.9)
    plain = torch_model(kw, params)
    other = torch_model(dict(kw, **remat_kw), params)
    return plain, other


@pytest.mark.parametrize("how", ["remat", "remat_norm", "with_remat"])
def test_remat_gradients_bit_identical(how):
    x = torch.from_numpy(volume("a", seed=31))
    if how == "with_remat":
        plain, _ = _pair()
        other = plain.with_remat()
    else:
        plain, other = _pair(**{how: True})
    ref = _mae_grads(plain, x)
    _assert_bit_identical(_mae_grads(other, x), ref)
    # the drop-path masks took part: another draw gives other gradients
    assert not torch.equal(_mae_grads(plain, x, seed=5)[0], ref[0])


def test_checkpoint_without_replay_differs(monkeypatch):
    """Negative control: checkpointing the blocks without replaying the
    generator recomputes with other drop-path masks."""
    plain, other = _pair(remat=True)
    x = torch.from_numpy(volume("a", seed=31))
    ref = _mae_grads(plain, x)
    monkeypatch.setattr(layers, "_checkpointed", lambda blk, x, g: checkpoint(
        blk, x, g, use_reentrant=False))
    loss, grads, _ = _mae_grads(other, x)
    assert torch.equal(loss, ref[0])  # the forward draws as before
    assert any(not torch.equal(a, b) for a, b in zip(grads, ref[1])
               if a is not None)


def test_with_remat_shares_parameters():
    plain, _ = _pair()
    twin = plain.with_remat()
    assert all(a is b for a, b in zip(plain.parameters(), twin.parameters()))
    assert len(list(plain.parameters())) == len(list(twin.parameters()))
    assert list(plain.state_dict()) == list(twin.state_dict())
    assert twin.blocks.remat and twin.decoder_blocks.remat
    assert not plain.blocks.remat and not plain.decoder_blocks.remat
    assert twin.blocks[0] is plain.blocks[0]


def test_remat_acts_only_under_autograd(monkeypatch):
    """No checkpoint is made while no gradient is recorded."""
    _, other = _pair(remat=True)
    calls = []
    monkeypatch.setattr(layers, "_checkpointed",
                        lambda *a: calls.append(1) or a[0](a[1], a[2]))
    x = torch.from_numpy(volume("a", seed=31))
    noise = torch.rand((2, other.num_tokens(x)))
    with torch.no_grad():
        other(x, 0.9, noise)
    assert not calls
    other(x, 0.9, noise)
    assert len(calls) == 3  # 2 encoder + 1 decoder blocks


def test_vit_st_remat_bit_identical():
    """The classifier's ``remat`` (JAX's VisionTransformerST has no
    remat_norm), drop path and head dropout from one generator."""
    kw = dict(num_frames=6, t_patch_size=3, img_size=32, in_chans=1,
              num_classes=4, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=DROP, head_type="dropout", dropout=0.5)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 6, 32, 32, 1)).astype(np.float32))
    out = []
    for remat in (False, True):
        m = tvit.create_model(tvit.VisionTransformerST, device="cpu",
                              seed=3, remat=remat, **kw).train()
        assert m.blocks.remat == remat
        g = torch.Generator().manual_seed(9)
        loss = m(x, generator=g).square().mean()
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(m.parameters()), allow_unused=True), g.get_state()))
    _assert_bit_identical(out[1], out[0])


def test_remat_mae_matches_jax_remat():
    """The port's remat MAE against JAX's remat=True MAE from the same
    params and noise: loss (TOL_OUT) and gradients (GRAD_REL per leaf)."""
    kw = model_kw("a", remat=True)
    x = volume("a", seed=32)
    jm, params = jax_init(kw, volume("a"), 0.9)
    key = jax.random.key(12)
    noise = jax_noise(jm, params, x, key)

    def jloss(p):
        return jm.apply(p, jnp.asarray(x), mask_ratio=0.9,
                        rngs={"masking": key})[0]
    ref, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    tm = torch_model(kw, params).train()
    assert tm.blocks.remat
    loss = tm(torch.from_numpy(x), 0.9, torch.from_numpy(noise))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **TOL_OUT)
    assert_grads_close(state_dict_from_jax(jgrads), tm, GRAD_REL)
