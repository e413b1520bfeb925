"""The exact online softmax (TPU kernel B6) as the Hopper body computes it,
held against the JAX package on the CPU.

``hopper_exact`` below is a plain torch model of the card kernel's tile
schedule (csrc/flash_fwd.cuh, fwd_hopper_kernel with its exact-softmax
policy): 128-key tiles, keys past kv_valid read as zeros (TMA's fill)
and masked to -inf before the tile's row max, the scores in log2 units
x = s sl2 rounded to fp32 and the running max m of x, p = 2^(x - m) (so
the row's largest p is exactly 1) rounded to bf16 before PV, the rescale
a = 2^(m_old - m) applied to l at once and to acc after the previous
tile's PV has been added, lse = m ln 2 + log l.  No conditional rescale:
the body rescales on every tile (where it rescales acc, before or after
the next QK^T is issued, changes no number).

JAX's ``flash_attention(..., no_max=False)`` (its ``_fwd_kernel`` in
interpret mode, as the JAX package's tests run it) takes the same
schedule at block 128, so the two agree to fp32 rounding and the odd bf16
rounding of p that lands the other way: o within 2^-9 (one bf16 rounding
of JAX's bf16 o) plus 2^-10 of max|v|, lse within 1e-5 (x1) or 4 fp32
ulps of its size.  At JAX's own tiles and in ``flash_attention_rect``
(with kv_valid), and against the port's plain version (one row max), p
is rounded against another max, so o is held to the card's limits
(chip_smoke.py): 2^-8 + 2^-6 |o|, or 2^-8 of max|v| where logits are
large (x8: q and k x 8; x40: q x 40), lse to 1e-4 or 8 ulps.  A model
that skips the rescale of acc misses by far more.  Inputs are bf16
values made with numpy from a seed; ragged n against the 128-key tiles;
the rect cases hold NaN in k and v past kv_valid on the model's side
(JAX's rect kernel takes zeroed tails).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.ops import flash_attention as jfa
from octcubem_tpu_torch.ops import flash_attention as tfa

BLOCK = 128  # the Hopper body's key tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def hopper_exact(q, k, v, scale, kv_valid=None, rescale=True):
    """The card kernel's exact softmax, tile by tile (see the module
    docstring): q [B, H, Nq, D], k, v [B, H, Nk, D] bf16 -> (o fp32, lse
    fp32) over the first kv_valid keys.  ``rescale=False`` leaves acc
    unscaled (a broken kernel, for the negative control)."""
    b, h, nq, d = q.shape
    n = k.shape[2] if kv_valid is None else kv_valid
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qf = q.float()
    m = torch.full((b, h, nq), -math.inf)
    l = torch.zeros((b, h, nq))
    acc = torch.zeros((b, h, nq, d))
    prev = None  # p_{t-1} (bf16 values) and V_{t-1}
    for k0 in range(0, n, BLOCK):
        rows = min(BLOCK, n - k0)
        kt, vt = (torch.zeros((b, h, BLOCK, d)) for _ in range(2))
        kt[:, :, :rows] = k[:, :, k0:k0 + rows].float()
        vt[:, :, :rows] = v[:, :, k0:k0 + rows].float()
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * sl2
        valid = torch.arange(BLOCK) < rows
        x = x.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        sh = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        a = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp2(m - sh))
        p = torch.exp2(x - sh[..., None])
        l = l * a + p.sum(-1)
        if prev is not None:
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", *prev)
            if rescale:
                acc = acc * a[..., None]
        prev = (p.to(torch.bfloat16).float(), vt)
        m = m_new
    acc = acc + torch.einsum("bhqk,bhkd->bhqd", *prev)
    ls = torch.where(l <= 0, torch.ones_like(l), l)
    return acc / ls[..., None], sh * LN2 + torch.log(ls)


def _bf16(rng, shape, mul=1.0):
    """Standard normal values times mul, rounded to bf16 (as numpy fp32)."""
    x = torch.from_numpy(mul * rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16)


def _jax(fn, *ts):
    """fn, jitted, on the bf16 tensors ``ts`` as JAX bf16 arrays -> its
    output, each array as a float32 torch tensor."""
    args = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)),
        jax.jit(fn)(*args))


def _close_card(o, ref, lse, lse_ref, v, big):
    """The card's limits (chip_smoke.py): o within 2^-8 + 2^-6 |ref|, or
    2^-8 max|v| + 2^-6 |ref| at large logits; lse within 1e-4 or 8 ulps."""
    atol = 2 ** -8 * v.float().abs().max().item() if big else 2 ** -8
    torch.testing.assert_close(o.float(), ref.float(), atol=atol,
                               rtol=2 ** -6)
    tol = max(1e-4, 8 * 2 ** -23 * lse_ref.abs().max().item())
    torch.testing.assert_close(lse, lse_ref.float(), atol=tol, rtol=0)


CASES = [(n, d, mul) for n in (200, 333) for d in (32, 80)
         for mul in ("x1", "x8", "x40")]
MULS = {"x1": (1.0, 1.0), "x8": (8.0, 8.0), "x40": (40.0, 1.0)}


def _square(n, d, mul, seed):
    rng = np.random.default_rng(seed)
    qm, km = MULS[mul]
    return (_bf16(rng, (1, 2, n, d), qm), _bf16(rng, (1, 2, n, d), km),
            _bf16(rng, (1, 2, n, d)))


@pytest.mark.parametrize("n,d,mul", CASES)
def test_tile_model_matches_jax_at_its_tiles(n, d, mul):
    """JAX's B6 at block 128 runs the model's schedule: o and lse agree to
    rounding (module docstring); against JAX at its own tiles and the
    port's plain version, to the card's limits."""
    q, k, v = _square(n, d, mul, n + d)
    scale = d ** -0.5
    o, lse = hopper_exact(q, k, v, scale)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()

    def at128(a, b, c):
        o, lse = jfa._flash_bh(*(t.reshape(2, n, d) for t in (a, b, c)),
                               scale, BLOCK, BLOCK, False)
        return o.reshape(1, 2, n, d), lse.reshape(1, 2, n)

    o_j, lse_j = _jax(at128, q, k, v)
    vmax = v.float().abs().max().item()
    torch.testing.assert_close(o, o_j, atol=2 ** -10 * vmax, rtol=2 ** -9)
    tol = max(1e-5, 4 * 2 ** -23 * lse_j.abs().max().item())
    torch.testing.assert_close(lse, lse_j, atol=tol, rtol=0)

    big = mul != "x1"
    o_own = _jax(lambda a, b, c: jfa.flash_attention(a, b, c, no_max=False),
                 q, k, v)
    torch.testing.assert_close(o, o_own, atol=(2 ** -8 * vmax if big
                                               else 2 ** -8), rtol=2 ** -6)
    o_p, lse_p = tfa.fwd_bh_exact_plain(q, k, v, scale)
    _close_card(o, o_p, lse, lse_p, v, big)


@pytest.mark.parametrize("mul", ["x1", "x8", "x40"])
@pytest.mark.parametrize("nq,nk,kv_valid", [(100, 300, 259), (150, 400, 333)])
def test_tile_model_rect_with_a_nan_tail(nq, nk, kv_valid, mul):
    """The rect form: k and v hold NaN past kv_valid on the model's side,
    which reads them as TMA does (zeros past kv_valid, masked); JAX's
    flash_attention_rect takes the tails zeroed.  The card's limits."""
    rng = np.random.default_rng(nq + nk)
    qm, km = MULS[mul]
    d, scale = 64, 64 ** -0.5
    q = _bf16(rng, (1, 2, nq, d), qm)
    k, v = _bf16(rng, (1, 2, nk, d), km), _bf16(rng, (1, 2, nk, d))
    kn, vn = k.clone(), v.clone()
    kn[:, :, kv_valid:], vn[:, :, kv_valid:] = math.nan, math.nan
    o, lse = hopper_exact(q, kn, vn, scale, kv_valid)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    kz, vz = k.clone(), v.clone()
    kz[:, :, kv_valid:], vz[:, :, kv_valid:] = 0, 0
    o_j = _jax(lambda a, b, c: jfa.flash_attention_rect(
        a, b, c, no_max=False, kv_valid=kv_valid), q, kz, vz)
    vmax = v[:, :, :kv_valid].float().abs().max().item()
    big = mul != "x1"
    torch.testing.assert_close(o, o_j, atol=(2 ** -8 * vmax if big
                                             else 2 ** -8), rtol=2 ** -6)
    o_p, lse_p = tfa.fwd_bh_exact_plain(q, k, v, scale, kv_valid)
    _close_card(o, o_p, lse, lse_p, v[:, :, :kv_valid], big)


def test_tile_model_takes_a_negative_scale():
    """The max is taken of the scaled scores, so a negative scale needs
    nothing of its own: against the port's plain version at the card's
    limits."""
    q, k, v = _square(333, 32, "x8", 11)
    o, lse = hopper_exact(q, k, v, -(32 ** -0.5))
    o_p, lse_p = tfa.fwd_bh_exact_plain(q, k, v, -(32 ** -0.5))
    _close_card(o, o_p, lse, lse_p, v, True)


@pytest.mark.parametrize("mul", ["x8", "x40"])
def test_a_model_without_the_rescale_misses(mul):
    """The negative control: acc left unscaled while the max moves is off
    by far more than the card's limit, so the comparisons above have
    teeth."""
    q, k, v = _square(333, 32, mul, 7)
    o_bad, _ = hopper_exact(q, k, v, 32 ** -0.5, rescale=False)
    o_p, _ = tfa.fwd_bh_exact_plain(q, k, v, 32 ** -0.5)
    vmax = v.float().abs().max().item()
    err = (o_bad - o_p.float()).abs().max().item()
    assert err > 8 * 2 ** -8 * vmax
