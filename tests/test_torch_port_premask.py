"""The blank-region pre-mask (data/premask.py) against the JAX package's.

The mask is discrete: XLA and torch add the fp32 dot products of the
similarity in different orders, so where two patches' scores nearly tie
at a frame's cut one may fall on either side.  The rule:

- on inputs with blank bands and clear margins the masks are equal;
- on random inputs each frame masks the same count in both (the volume's
  target), and a patch may differ only in a swap with another patch of
  its frame whose score is within EPS of its own (the cut passed between
  a near-tie).  EPS = 1e-6: a score is a mean of L cosines each within a
  few fp32 ulps (~1e-7) of the other package's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.data.premask import compute_premask as jax_premask
from octcubem_tpu_torch.data.premask import compute_premask, premask_scores

from test_torch_port_mae import jax_init, model_kw, torch_model

EPS = 1e-6


def assert_premask_close(got, ref, score, eps=EPS):
    """got, ref: [B, T*L] masks; score: [B, T, L] (the port's scores)."""
    b, t, l = score.shape
    g = np.asarray(got).reshape(b, t, l)
    r = np.asarray(ref).reshape(b, t, l)
    np.testing.assert_array_equal(g.sum(-1), r.sum(-1))  # per-frame counts
    for bi, ti in zip(*np.nonzero((g != r).any(-1))):
        only_g = np.sort(score[bi, ti][(g[bi, ti] > r[bi, ti])])
        only_r = np.sort(score[bi, ti][(r[bi, ti] > g[bi, ti])])
        assert np.abs(only_g - only_r).max() <= eps, (bi, ti, only_g, only_r)


def _band_start(grid, bi, ti):
    return grid // 4 + (bi + ti) % (grid // 4)


def _banded(b=2, t=3, grid=16, d=32, seed=0):
    """Random patch embeddings with blank bands: per frame, a run of patch
    rows (away from the borders) nearly identical, as a blank region
    embeds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, grid, grid, d)).astype(np.float32)
    blank = rng.standard_normal((d,)).astype(np.float32)
    for bi in range(b):
        for ti in range(t):
            r0 = _band_start(grid, bi, ti)
            x[bi, ti, r0:r0 + 4] = blank + 0.01 * rng.standard_normal(
                (4, grid, d)).astype(np.float32)
    return x.reshape(b, t * grid * grid, d)


@pytest.mark.parametrize("grid,ratio,clear", [(16, 0.6, 3), (8, 0.6, 1),
                                              (16, 0.3, 3), (16, 0.9, 2)])
def test_banded_inputs_equal_jax(grid, ratio, clear):
    x = _banded(grid=grid)
    ref = np.asarray(jax_premask(jnp.asarray(x), 3, grid, ratio, clear))
    got = compute_premask(torch.from_numpy(x), 3, grid, ratio, clear)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # the blank bands are masked; every frame masks the volume's count
    m = got.numpy().reshape(2, 3, grid, grid)
    for bi in range(2):
        for ti in range(3):
            r0 = _band_start(grid, bi, ti)
            rows = [r for r in range(r0, r0 + 4)
                    if clear <= r < grid - clear]
            assert m[bi, ti, rows].all()
    counts = m.sum((2, 3))
    assert (counts == counts[:, :1]).all() and (counts >= grid ** 2 // 2).all()


@pytest.mark.parametrize("seed", range(4))
def test_random_inputs_follow_the_rule(seed):
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((2, 4 * 64, 24)).astype(np.float32)
    ref = np.asarray(jax_premask(jnp.asarray(x), 4, 8))
    got = compute_premask(torch.from_numpy(x), 4, 8)
    score = premask_scores(torch.from_numpy(x), 4, 8).numpy()
    assert_premask_close(got.numpy(), ref, score)


def test_the_rule_rejects_a_real_difference():
    """Negative control: a swap between patches of distant scores fails."""
    x = np.random.default_rng(7).standard_normal(
        (1, 64, 16)).astype(np.float32)
    got = compute_premask(torch.from_numpy(x), 1, 8).numpy()
    score = premask_scores(torch.from_numpy(x), 1, 8).numpy()
    bad = got.copy()
    on, off = np.nonzero(got[0])[0][0], np.nonzero(got[0] == 0)[0][0]
    bad[0, on], bad[0, off] = 0.0, 1.0
    with pytest.raises(AssertionError):
        assert_premask_close(bad, got, score)


def test_model_embeddings_with_zeroed_bands():
    """From the MAE's own patch embeddings (forward_patch_embed) of volumes
    whose middle rows are zero in every frame (a nonzero patch bias makes
    them one embedding): equal to JAX and masked."""
    kw = model_kw("b")  # 128 x 128: 8 x 8 patches a frame
    x = np.random.default_rng(3).standard_normal(
        (2, 24, 128, 128, 1)).astype(np.float32)
    x[:, :, 48:80] = 0.0  # patch rows 3-4
    jm, params = jax_init(kw, x, 0.75)
    feat = np.asarray(jm.apply(params, jnp.asarray(x),
                               method=jm.forward_patch_embed))
    tm = torch_model(kw, params)
    with torch.no_grad():
        tfeat = tm.forward_patch_embed(torch.from_numpy(x))
    np.testing.assert_allclose(tfeat.numpy(), feat, atol=1e-5, rtol=1e-5)
    ref = np.asarray(jax_premask(jnp.asarray(feat), tm.t_grid, tm.grid,
                                 0.6, 2))
    got = compute_premask(tfeat, tm.t_grid, tm.grid, 0.6, 2).numpy()
    score = premask_scores(tfeat, tm.t_grid, tm.grid).numpy()
    assert_premask_close(got, ref, score)
    assert got.reshape(2, 8, 8, 8)[:, :, 3:5].all()
