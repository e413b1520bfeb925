"""Port parity: the auxiliary COEM towers (models/aux_towers.py) and the
[B, H, N, D] flash path at head_dim 16 against the JAX package on the
CPU.

Both packages run the same seeded random weights (in the JAX init's tree,
carried by ``state_dict_from_jax`` with ``strict=True``, ``batch_stats``
included)
on the same seeded numpy inputs in fp32.  Outputs within TOL (1e-5);
gradients of a fixed random projection of the output, leaf by leaf,
within TOL_GRAD (1e-4 of the leaf's largest JAX gradient, at least
1e-7 of the largest of all, plus 1e-4 relative): fp32 sums in another
order.  The HIPT ViT-4K runs the JAX
package's flash kernels in interpret mode (the packed path's fallback to
the [B, H, N, D] kernels at head_dim 16) against the port's plain
versions: 257 tokens on a 16 x 16 map (the cls-fold branch) and 197 on a
14 x 14 map (unfolded, the pos embed interpolated).  The tokenizers are
compared in one process: ``SimpleTokenizer`` hashes with Python's salted
``hash``."""

import functools
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.models import aux_towers as jaux
from octcubem_tpu.ops import flash_attention as jfa
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import aux_towers as taux
from octcubem_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = 1e-4
TOL_TRAIN = dict(rtol=1e-4, atol=1e-4)


def _variables(jm, *args, seed=1, **kw):
    """Seeded random variables in the tree ``jm.init`` would make (its
    shapes from ``jax.eval_shape``, no init compiled): kernels, tables and
    embeddings N(0, 1 / fan_in) with fan_in all but the last axis; scales
    and variances 1 + 0.05 N(0, 1); biases and means 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jm.init, **kw),
                            jax.random.key(0), *args)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if name in ("scale", "var") else 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(tcls, variables, **kw):
    """The port's module with the JAX variables, loaded strictly, eval."""
    tm = tcls(**kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return tm.eval()


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


def _grads_match(jm, variables, tm, args, what):
    """Per-leaf gradients of sum(out * r), r fixed, in both packages."""
    out = jm.apply(variables, *args)
    r = np.random.default_rng(7).standard_normal(np.shape(out)).astype(
        np.float32)
    params = {k: v for k, v in variables.items() if k == "params"}
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        return jnp.sum(jm.apply({**p, **rest}, *args) * r)

    want = state_dict_from_jax(jax.jit(jax.grad(loss))(params))
    tm.zero_grad(set_to_none=True)
    t_out = tm(*(torch.from_numpy(np.asarray(a)) for a in args))
    (t_out * torch.from_numpy(r)).sum().backward()
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want), what
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g is not None, f"{what}: no gradient for {k}"
        w = w.numpy()
        # a leaf whose gradient is 0 in exact arithmetic (a key bias under
        # the softmax) keeps fp32 residue: floor at 1e-3 of the largest
        np.testing.assert_allclose(
            g.numpy(), w, rtol=TOL_GRAD,
            atol=TOL_GRAD * max(float(np.abs(w).max()), 1e-3 * top),
            err_msg=f"{what}: {k}")


# ------------------------------------------------------------ tokenizers

TEXTS = ["Macular degeneration, OS; stage 2!", "diabetic retinopathy",
         "geographic atrophy 12 mm^2"]


def test_simple_tokenizer_ids_equal():
    for n in (77, 8):
        np.testing.assert_array_equal(taux.SimpleTokenizer()(TEXTS, n),
                                      jaux.SimpleTokenizer()(TEXTS, n))


def _write_merges(path):
    """A tiny merge table in the reference's format: gzip text, a header
    line, then one 'a b' merge per line."""
    merges = ["t h", "th e</w>", "a t", "r e", "o n", "i n", "at r",
              "atr o", "g e", "e d</w>", "m a", "c u", "cu l", "l a"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def test_bpe_tokenizer_ids_and_decode_equal(tmp_path):
    path = tmp_path / "merges.txt.gz"
    _write_merges(path)
    tt, jt = taux.BPETokenizer(str(path)), jaux.BPETokenizer(str(path))
    assert (tt.vocab_size, tt.sot, tt.eot) == (jt.vocab_size, jt.sot, jt.eot)
    texts = TEXTS + ["the atrophy &amp; macula, édème"]
    np.testing.assert_array_equal(tt(texts), jt(texts))
    for t in texts:
        ids = tt.encode(t)
        assert ids == jt.encode(t)
        assert tt.decode(ids) == jt.decode(ids)


def test_get_tokenizer_falls_back_without_a_table(monkeypatch, tmp_path):
    monkeypatch.setenv("OCTCUBEM_BPE_VOCAB", str(tmp_path / "absent.gz"))
    assert taux.find_bpe_vocab() is None
    assert isinstance(taux.get_tokenizer(), taux.SimpleTokenizer)
    assert isinstance(jaux.get_tokenizer(), jaux.SimpleTokenizer)
    with pytest.raises(FileNotFoundError):
        taux.BPETokenizer()


# -------------------------------------------------------- text transformer

TEXT_KW = dict(vocab_size=300, context_length=12, width=32, depth=2, heads=2,
               output_dim=16)


@functools.lru_cache(maxsize=None)
def _text_pair():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 290, (3, 12)).astype(np.int32)
    tokens[:, 0] = 298                     # sot
    tokens[0, 7], tokens[0, 8:] = 299, 0   # eot, then pad
    tokens[1, 11] = 299
    tokens[2, 4], tokens[2, 5:] = 299, 0
    jm = jaux.TextTransformer(**TEXT_KW)
    v = _variables(jm, tokens)
    return jm, v, _port(taux.TextTransformer, v, **TEXT_KW), tokens


def test_text_transformer_matches_jax():
    jm, v, tm, tokens = _text_pair()
    want = jax.jit(jm.apply)(v, tokens)
    got = tm(torch.from_numpy(tokens))
    _close(got, want, "text features")
    # tokens stay integers: the eot rows are picked by the ids
    assert got.shape == (3, 16)
    _grads_match(jm, v, tm, (tokens,), "text transformer")


# -------------------------------------------------------- ModifiedResNet

RESNET_KW = dict(layers=(1, 1, 1, 1), width=8, heads=2, image_size=64,
                 output_dim=16)


@functools.lru_cache(maxsize=None)
def _resnet_pair():
    x = np.random.default_rng(0).random((4, 64, 64, 3), np.float32)
    jm = jaux.ModifiedResNet(**RESNET_KW)
    v = _variables(jm, x)
    return jm, v, _port(taux.ModifiedResNet, v, **RESNET_KW), x


def test_modified_resnet_eval_matches_jax():
    jm, v, tm, x = _resnet_pair()
    _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(v, x), "eval")
    _grads_match(jm, v, tm, (x,), "resnet eval")


def test_modified_resnet_train_output_and_batch_stats_match_jax():
    """deterministic=False with mutable=['batch_stats']: the batch-stat
    output and the updated running statistics (momentum 0.99, the biased
    variance); the port's buffers stay as they were."""
    jm, v, tm, x = _resnet_pair()
    want, upd = jax.jit(functools.partial(
        jm.apply, deterministic=False, mutable=["batch_stats"]))(v, x)
    before = {k: b.clone() for k, b in tm.named_buffers()}
    tm.train()
    try:
        got, stats = tm(torch.from_numpy(x), mutable=True)
        with pytest.raises(RuntimeError, match="mutable"):
            tm(torch.from_numpy(x))
    finally:
        tm.eval()
    # each stage-4 channel is normalised by the statistics of 16 values
    # (4 samples x 2 x 2), which carry the fp32 summation-order residue of
    # every layer below, and divide it by their spread: the batch-stat
    # output holds to TOL_TRAIN (measured 4.7e-5 on outputs up to 3.5),
    # the statistics themselves to TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg="train output", **TOL_TRAIN)
    want_stats = state_dict_from_jax({"params": {}, **upd})
    assert set(stats) == set(want_stats) == set(before)
    for k, w in want_stats.items():
        _close(stats[k], w.numpy(), k)
        assert torch.equal(dict(tm.named_buffers())[k], before[k])


# -------------------------------------------------------- HIPT ViT-4K

@functools.lru_cache(maxsize=None)
def _hipt_pair(heads, side):
    """Width 32 at img_size 256 (a 16 x 16 pos grid) at ``heads`` heads
    (2 of 16 or 1 of 32), on a side x side x 24 map."""
    kw = dict(input_embed_dim=24, output_embed_dim=32, depth=2,
              num_heads=heads, img_size=256)
    x = np.random.default_rng(side).standard_normal(
        (2, side, side, 24)).astype(np.float32)
    jm = jaux.VisionTransformer4K(**kw)
    v = _variables(jm, x)
    return jm, v, _port(taux.VisionTransformer4K, v, **kw), x


@pytest.mark.parametrize("heads,side", [(2, 16), (2, 14), (1, 16), (1, 14)],
                         ids=["d16-257", "d16-197", "d32-257", "d32-197"])
def test_vit4k_matches_jax(heads, side):
    """On the pos grid (257 tokens, folded) and off it (197, the pos embed
    bicubic-resized), head_dim 16 and 32."""
    jm, v, tm, x = _hipt_pair(heads, side)
    _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(v, x), "cls feature")
    _grads_match(jm, v, tm, (x,), f"vit4k {heads} heads, {side}^2")


# ------------------------------------------- flash at head_dim 16, CPU

@pytest.mark.parametrize("n", [257, 197])
def test_flash_head_dim_16_matches_jax(n):
    """flash_attention ([B, H, N, D]) and flash_attention_packed_qkv (the
    fused buffer, rerouted to the [B, H, N, D] views) at 12 heads of 16:
    the port's plain B3 / B4 (n = 257, folded) and B5 / B7 (197) against
    the JAX kernels in interpret mode, output and gradients."""
    b, h, d = 2, 12, 16
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v) * g)

    jo = jax.jit(jfa.flash_attention)(q, k, v)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    to = tfa.flash_attention(*ts)
    (to * torch.from_numpy(g)).sum().backward()
    _close(to, jo, "o")
    for name, t, w in zip("qkv", ts, jg):
        _close(t.grad, w, f"d{name}")

    qkv = np.concatenate([t.transpose(0, 2, 1, 3).reshape(b, n, h * d)
                          for t in (q, k, v)], axis=-1)
    gp = g.transpose(0, 2, 1, 3).reshape(b, n, h * d)
    jo = jax.jit(functools.partial(jfa.flash_attention_packed_qkv,
                                   num_heads=h))(qkv)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(
        jfa.flash_attention_packed_qkv(x, h) * gp)))(qkv)
    x = torch.from_numpy(qkv).requires_grad_()
    to = tfa.flash_attention_packed_qkv(x, h)
    (to * torch.from_numpy(gp)).sum().backward()
    _close(to, jo, "packed o")
    _close(x.grad, jg, "dqkv")


# ---------------------------------------------------- the key rules


def test_state_dict_from_jax_conv_rules_keep_existing_layouts():
    """Every 4-D kernel becomes a Conv2d weight [O, I / groups, kh, kw];
    the 2D patch embed keeps its proj.weight key and SLIViT's convs their
    names; a Dense kernel is transposed; an Embed's table and BatchNorm
    statistics get torch's names."""
    rng = np.random.default_rng(0)
    k4 = rng.standard_normal((3, 5, 2, 7)).astype(np.float32)
    k2 = rng.standard_normal((4, 6)).astype(np.float32)
    tree = {"params": {
        "patch_embed": {"kernel": k4, "bias": np.zeros(7, np.float32)},
        "stem_conv": {"kernel": k4},
        "trunk": {"patch_embed_proj": {"kernel": k4}},
        "fc": {"kernel": k2},
        "token_embedding": {"embedding": k2},
        "bn1": {"scale": np.ones(3, np.float32)}},
        "batch_stats": {"bn1": {"mean": np.zeros(3, np.float32),
                                "var": np.ones(3, np.float32)}}}
    sd = state_dict_from_jax(tree)
    conv = k4.transpose(3, 2, 0, 1)
    assert set(sd) == {"patch_embed.proj.weight", "patch_embed.proj.bias",
                       "stem_conv.weight", "trunk.patch_embed_proj.weight",
                       "fc.weight", "token_embedding.weight", "bn1.weight",
                       "bn1.running_mean", "bn1.running_var"}
    for key in ("patch_embed.proj.weight", "stem_conv.weight",
                "trunk.patch_embed_proj.weight"):
        np.testing.assert_array_equal(sd[key].numpy(), conv)
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), k2.T)
    np.testing.assert_array_equal(sd["token_embedding.weight"].numpy(), k2)


COVERAGE = {
    "text": (jaux.TextTransformer, taux.TextTransformer, TEXT_KW,
             lambda: (np.ones((2, 12), np.int32),)),
    "resnet": (jaux.ModifiedResNet, taux.ModifiedResNet, RESNET_KW,
               lambda: (np.ones((2, 64, 64, 3), np.float32),)),
    "hipt": (jaux.VisionTransformer4K, taux.VisionTransformer4K,
             dict(input_embed_dim=24, output_embed_dim=32, depth=2,
                  num_heads=2, img_size=64, num_classes=8),
             lambda: (np.ones((2, 4, 4, 24), np.float32),)),
    "focalnet": (jaux.FocalNetTower, taux.FocalNetTower,
                 dict(out_dim=8, model_name="focalnet_tiny_lrf",
                      trunk_cfg=dict(embed_dim=8, depths=(1, 2, 1, 1),
                                     use_conv_embed=True, use_postln=True)),
                 lambda: (np.ones((2, 32, 32, 3), np.float32),)),
    "perceiver": (jaux.PerceiverTower, taux.PerceiverTower,
                  dict(out_dim=8, cfg=dict(num_latents=4,
                                           num_latent_channels=16,
                                           num_image_channels=12,
                                           num_self_attention_layers=2)),
                  lambda: (np.ones((2, 10, 12), np.float32),)),
}


@pytest.mark.parametrize("tower", list(COVERAGE))
def test_jax_params_cover_every_aux_tower(tower):
    """Every leaf of the JAX tower's variables (params and batch_stats)
    has one slot in the port's state dict, of its shape, and no slot is
    left over: load_state_dict(strict=True) takes them."""
    jcls, tcls, kw, args = COVERAGE[tower]
    v = _variables(jcls(**kw), *args())
    sd = state_dict_from_jax(v)
    tm = tcls(**kw)
    own = tm.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    tm.load_state_dict(sd, strict=True)
