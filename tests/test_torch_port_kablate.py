"""Port parity: B8's plain version (``octcubem_tpu_torch/scripts/
kablate.py::fwd_variant_plain``) against the TPU harness's
``scripts/kablate.py::fwd_variant``, whose Pallas kernel runs in TPU
interpret mode on the CPU, for every flag variant.

The JAX harness fixes its shape in module constants (BH 64, N 5,121,
D 32); the test sets them to BH 2, N 200, D 32 and runs every variant at
the base tile, 128 x 128 (the Hopper body's), so both sides pad the keys
to 256 and the pv-off variant takes columns 0-31 and 128-159, and the
base variant at each other tile of the port's set.  Importing the harness points JAX's persistent
compilation cache at a directory of the checkout for the whole process;
the fixture restores both settings it changes.  Tolerance: fp32, 5e-5
relative to the largest output (the noexp and mxonly variants sum raw
logits, so their outputs have no softmax scale).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from octcubem_tpu_torch.ops import _cuda
from octcubem_tpu_torch.scripts import kablate as tk

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jk():
    """scripts/kablate.py, imported with JAX's cache settings restored."""
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        spec = importlib.util.spec_from_file_location(
            "_kablate_tpu", ROOT / "scripts" / "kablate.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 200, 32)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("variant,tile", [
    (v, tk.BASE_TILE) for v in tk.VARIANTS] + [
    ("base", t) for t in tk.TILES if t != tk.BASE_TILE])
def test_fwd_variant_plain_matches_tpu_harness(jk, variant, tile,
                                               monkeypatch):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jk, "BH", 2)
    monkeypatch.setattr(jk, "N", 200)
    monkeypatch.setattr(jk, "D", 32)
    flags = tk.VARIANTS[variant]
    jflags = {k: v for k, v in flags.items() if k != "s_bf16"}
    if flags.get("s_bf16"):
        jflags["s_dtype"] = jnp.bfloat16
    _, block_q, block_k = tk.TILES[tile]
    q, k, v = _qkv(len(variant))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.fwd_variant(block_q, block_k, **jflags)(
            *map(jnp.asarray, (q, k, v))))
    n_pad = tk.n_pad_of(200, tile)
    assert n_pad == 256
    o, lse = tk.fwd_variant_plain(*map(torch.from_numpy, (q, k, v)),
                                  n_pad=n_pad, block_k=block_k, **flags)
    assert o.shape == (2, 200, 32) and lse.shape == (2, 200)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(o.numpy(), ref, rtol=0, atol=5e-5 * scale)


@pytest.mark.parametrize("tile,n_pad", [("f128x128", 5248),
                                        ("f128x64", 5248),
                                        ("f64x128", 5248), ("f64x64", 5184)])
def test_fwd_variant_dispatch_and_padding(tile, n_pad):
    """fwd_variant on CPU tensors runs the plain version at the tile's own
    padding (5,121 -> 5,248 where a side is 128, 5,184 at 64 x 64) and key
    tile, never the CUDA loader; each zero pad key adds e^-16 to l."""
    assert tk.n_pad_of(5121, tile) == n_pad
    assert tk.n_pad_of(5121) == tk.n_pad_of(5121, tk.BASE_TILE) == 5248
    q, k, v = map(torch.from_numpy, _qkv(1))
    before = dict(_cuda.launches)
    o, lse = tk.fwd_variant(q, k, v, tile)
    ref, lse_ref = tk.fwd_variant_plain(q, k, v, 256, tk.TILES[tile][2])
    assert torch.equal(o, ref) and torch.equal(lse, lse_ref)
    assert _cuda.launches == before
    _, l_nopad = tk.fwd_variant_plain(q, k, v, 200, 200)
    torch.testing.assert_close(lse - l_nopad,
                               torch.full_like(lse, 56 * np.exp(-16.0)),
                               rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="CUDA"):
        tk.fwd_variant_cuda(q, k, v)
