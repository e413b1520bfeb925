"""Auxiliary COEM towers (counterpart of octcubem_tpu/models/aux_towers.py):
the CLIP text transformer and its tokenizers, CLIP's ModifiedResNet, the
HIPT region ViT-4K, FocalNet, the Perceiver and a HuggingFace text
encoder, each selectable through the COEM factory (models/coem.py).

Layout and numerics are the JAX package's: image inputs are NHWC; every
Dense / Conv casts its input and weights to the compute dtype (flax
``dtype=``), LayerNorms and BatchNorms compute and return fp32, and
activations then follow type promotion as in JAX (a bf16 branch added to
an fp32 one is fp32).  Parameter names are the flax paths in state-dict
form, so ``compat.jax_params.state_dict_from_jax`` of a JAX tree (params
and ``batch_stats``) loads with ``strict=True``.

Attention: the HIPT ViT-4K runs the port's ``TransformerStack`` and so
the flash kernels (B1 / B2 at head_dim 32; B3 / B4 or B5 / B7 at 16); the
text transformer, the attention pool and the Perceiver compute their
attention in plain PyTorch, as the JAX package does in XLA einsums.

Where torch needs what flax infers at the first call: ``in_chans`` of
ModifiedResNet and FocalNet, and the Perceiver's feature width
(``num_image_channels``, default 512), size their first weights.  The
HuggingFace tower needs the ``transformers`` package and is built on the
CPU only where the card's machine lacks it; its encoder runs in its
parameters' dtype (fp32) and its dropout, in training mode, draws from
torch's global generator (a ``transformers`` module takes no
generator).
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense, DropPath, LayerNorm, TransformerStack
from ..ops.pos_embed import interpolate_spatial_pos_embed

# ------------------------------------------------------------ tokenizers


class SimpleTokenizer:
    """Byte-fallback word tokenizer with the CLIP context convention
    (<start> tokens <end>, pad to context_length): lower-cased word pieces
    hashed into the 49,408-slot space.  Python's ``hash`` of a str is
    salted per process unless ``PYTHONHASHSEED`` is set, so ids agree
    between processes only under one seed (as in the JAX package)."""

    vocab_size = 49408
    sot = vocab_size - 2
    eot = vocab_size - 1

    def encode(self, text: str) -> list[int]:
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        return [(hash(w) % (self.vocab_size - 2)) for w in words]

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t)[: context_length - 2] + [self.eot]
            out[i, : len(toks)] = toks
        return out


def _byte_unicode_table() -> tuple[dict[int, str], list[str]]:
    """Reversible byte <-> printable-unicode mapping (the GPT-2 / CLIP
    convention) -> (byte -> unit, units in vocab order: the kept printable
    bytes first, then the shifted ones; token ids depend on that order)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    units = [table[b] for b in keep]
    units += [table[b] for b in range(256) if b not in keep]
    return table, units


BPE_VOCAB_NAME = "bpe_simple_vocab_16e6.txt.gz"


def find_bpe_vocab() -> str | None:
    """The OpenAI BPE merge table (bpe_simple_vocab_16e6.txt.gz) on disk,
    or None: $OCTCUBEM_BPE_VOCAB, a copy next to this module, then an
    installed open_clip / clip package's copy.  Nothing is fetched."""
    import importlib.util

    candidates = [os.environ.get("OCTCUBEM_BPE_VOCAB", ""),
                  os.path.join(os.path.dirname(__file__), BPE_VOCAB_NAME)]
    for pkg in ("open_clip", "clip"):
        try:
            spec = importlib.util.find_spec(pkg)
        except (ImportError, ValueError):
            continue
        if spec and spec.origin:
            candidates.append(os.path.join(os.path.dirname(spec.origin),
                                           BPE_VOCAB_NAME))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


class BPETokenizer:
    """CLIP's BPE tokenizer: byte-level unicode mapping, the greedy
    lowest-rank merge loop with an end-of-word marker, CLIP's word regex,
    <start> / <end> specials, padded to ``context_length``.  Needs the
    ``regex`` package (ImportError without it) and a merge table
    (FileNotFoundError without one)."""

    def __init__(self, vocab_path: str | None = None,
                 context_length: int = 77):
        import gzip

        vocab_path = vocab_path or find_bpe_vocab()
        if vocab_path is None:
            raise FileNotFoundError(
                "BPE vocab not found; set $OCTCUBEM_BPE_VOCAB or place "
                f"{BPE_VOCAB_NAME} next to models/ (get_tokenizer() falls "
                "back to the hash tokenizer)")
        self.context_length = context_length
        self.byte_to_u, units = _byte_unicode_table()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a header; CLIP uses the first 48,894 merges
        merges = [tuple(line.split()) for line in lines[1: 49152 - 256 - 2 + 1]]
        self.rank = {m: i for i, m in enumerate(merges)}
        tokens = units + [u + "</w>" for u in units]
        tokens += ["".join(m) for m in merges]
        tokens += ["<start_of_text>", "<end_of_text>"]
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.vocab_size = len(self.encoder)       # 49408
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        self._cache: dict[str, tuple[str, ...]] = {}

        import regex

        self.word_pat = regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE)

    def _merge(self, word: str) -> tuple[str, ...]:
        """Greedy BPE: join the adjacent pair of lowest merge rank, every
        occurrence in one sweep, until no ranked pair remains."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = [(self.rank[p], i) for i, p in enumerate(pairs)
                      if p in self.rank]
            if not ranked:
                break
            best = pairs[min(ranked)[1]]
            out = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    out.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        result = tuple(parts)
        self._cache[word] = result
        return result

    def encode(self, text: str) -> list[int]:
        import html

        text = html.unescape(html.unescape(text)).strip()
        text = re.sub(r"\s+", " ", text).lower()
        ids = []
        for word in self.word_pat.findall(text):
            mapped = "".join(self.byte_to_u[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._merge(mapped))
        return ids

    def decode(self, ids) -> str:
        u_to_byte = {v: k for k, v in self.byte_to_u.items()}
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot, self.eot))
        raw = bytes(u_to_byte[c] for c in text)
        return (raw.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        n = context_length or self.context_length
        out = np.zeros((len(texts), n), np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t)[: n - 2] + [self.eot]
            out[i, : len(toks)] = toks
        return out


def get_tokenizer(context_length: int = 77):
    """The BPE tokenizer when its table and ``regex`` are there, else the
    hash tokenizer (self-consistent, not OpenAI-checkpoint compatible)."""
    try:
        return BPETokenizer(context_length=context_length)
    except (FileNotFoundError, ImportError):
        return SimpleTokenizer()


# ------------------------------------------------------- flax-like layers


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax / XLA "SAME" padding of one spatial dim: (low, high), the odd
    pixel at the high end (a stride-2 k3 conv on an even size pads
    (0, 1))."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC: ``weight`` [O, I / groups, kh, kw] (the
    port's Conv2d layout), "SAME" or explicit ((lo, hi), (lo, hi))
    padding, input and weights cast to ``compute_dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Any = "SAME", groups: int = 1, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.groups, self.compute_dtype = groups, compute_dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x):  # [B, H, W, C]
        dt = self.compute_dtype
        if self.padding == "SAME":
            (hl, hh), (wl, wh) = (_same_pads(n, self.kernel, self.stride)
                                  for n in x.shape[1:3])
        else:
            (hl, hh), (wl, wh) = self.padding
        y = F.pad(x.to(dt).permute(0, 3, 1, 2), (wl, wh, hl, hh))
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(y, self.weight.to(dt), bias, self.stride,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(epsilon=1e-5, dtype=float32)`` over the last
    axis: fp32 statistics and output, ``weight`` / ``bias`` (flax's scale
    and bias) and the ``running_mean`` / ``running_var`` buffers (its
    ``batch_stats``).  Eval mode normalises with the running statistics.
    Training mode normalises with the batch's mean and biased variance
    (E[x^2] - E[x]^2, clipped at 0, flax's fast variance) and keeps in
    ``new_stats`` the running statistics flax would write, momentum 0.99
    (torch's momentum 0.01): the buffers themselves do not change."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.new_stats: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x):
        x = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            m = self.momentum
            self.new_stats = (
                (m * self.running_mean + (1 - m) * mean).detach(),
                (m * self.running_var + (1 - m) * var).detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=...)``: the rows gathered, then cast to
    ``compute_dtype``."""

    def __init__(self, num: int, dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


def _avg_pool(x, s: int):
    """flax ``nn.avg_pool(x, (s, s), (s, s))`` on NHWC (VALID)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)


def _attend(q, k, v, scale: float, fill=None):
    """Plain attention as the JAX towers write it: q, k, v [B, n, H, d];
    fp32 scores (products of the inputs, fp32 sums), ``fill`` applied to
    them, fp32 softmax, probabilities cast to v's dtype before PV ->
    [B, nq, H, d] in v's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if fill is not None:
        s = fill(s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


# ------------------------------------------------------- CLIP text tower


_TEXT_BLOCK = ("ln1", "qkv", "proj", "ln2", "fc", "out")


class TextTransformer(nn.Module):
    """CLIP-style causal text transformer: token ids [B, L] (integers) ->
    the eot token's feature (at argmax of the ids, CLIP's convention) @
    ``text_projection`` [width, output_dim], fp32.  The blocks' modules
    keep the flax names ``blocks_{i}_{ln1, qkv, proj, ln2, fc, out}``, as
    SLIViT's do (models/slivit.py)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, depth: int = 12, heads: int = 8,
                 output_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.heads = depth, heads
        self.token_embedding = Embed(vocab_size, width, dtype)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        for i in range(depth):
            for name, mod in zip(_TEXT_BLOCK, (
                    LayerNorm(width),
                    Dense(width, 3 * width, compute_dtype=dtype),
                    Dense(width, width, compute_dtype=dtype),
                    LayerNorm(width),
                    Dense(width, 4 * width, compute_dtype=dtype),
                    Dense(4 * width, width, compute_dtype=dtype))):
                self.add_module(f"blocks_{i}_{name}", mod)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))

    def _block(self, i: int, x, causal):
        ln1, qkv, proj, ln2, fc, out = (getattr(self, f"blocks_{i}_{n}")
                                        for n in _TEXT_BLOCK)
        b, n, w = x.shape
        hd = w // self.heads
        t = qkv(ln1(x)).reshape(b, n, 3, self.heads, hd)
        ctx = _attend(t[:, :, 0], t[:, :, 1], t[:, :, 2], hd ** -0.5,
                      lambda s: torch.where(causal, s, -1e30))
        x = x + proj(ctx.reshape(b, n, w))
        return x + out(F.gelu(fc(ln2(x))))

    def forward(self, tokens, generator: torch.Generator | None = None):
        n = tokens.shape[1]
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[None, :n].to(x.dtype)
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=tokens.device).tril()
        for i in range(self.depth):
            x = self._block(i, x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)


# ------------------------------------------------------ ModifiedResNet

RESNET_GAP = (
    "ModifiedResNet in training mode computes batch statistics and new "
    "BatchNorm running statistics, which only a call with mutable=True "
    "returns (flax's mutable=['batch_stats']).  The COEM train steps call "
    "their model without it, as the JAX package's clip_engine applies "
    "COEP2Tower with deterministic=False and no mutable batch_stats, which "
    "flax refuses: a BatchNorm tower cannot be trained through the COEM "
    "steps of either package")


class _Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: every conv stride 1, an avgpool
    does the stride-2 downsampling after conv2 (and before the 1x1
    downsample projection)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        out = planes * 4

        def conv(i, o, k):
            return Conv(i, o, k, bias=False, compute_dtype=dtype)

        self.conv1, self.bn1 = conv(inplanes, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3), BatchNorm(planes)
        self.conv3, self.bn3 = conv(planes, out, 1), BatchNorm(out)
        self.downsample = stride > 1 or inplanes != out
        if self.downsample:
            self.downsample_conv = conv(inplanes, out, 1)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample:
            identity = x if self.stride == 1 else _avg_pool(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling: the spatial mean token prepended, learned
    pos embeds added, one MHA step for the mean token's query alone (the
    reference keeps row 0 of full self-attention: the same value)."""

    def __init__(self, embed_dim: int, num_heads: int, output_dim: int,
                 spacial_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Dense(embed_dim, embed_dim,
                                      compute_dtype=dtype))
        self.c_proj = Dense(embed_dim, output_dim, compute_dtype=dtype)

    def forward(self, x):  # [B, H, W, C]
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None, :tokens.shape[1]].to(
            tokens.dtype)
        hd = self.embed_dim // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.num_heads, hd)
        k = self.k_proj(tokens).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(tokens).reshape(b, -1, self.num_heads, hd)
        ctx = _attend(q, k, v, hd ** -0.5)
        return self.c_proj(ctx.reshape(b, self.embed_dim))


class ModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet: the 3-conv stem (the first conv stride 2,
    flax "SAME": padding (0, 1) on an even size) with an avgpool,
    anti-aliased strided bottlenecks, attention pooling.  Input NHWC.

    Eval mode uses the running BatchNorm statistics.  Training mode needs
    ``mutable=True`` and returns (output, new running statistics as
    {state-dict key: tensor}), as flax's ``apply(..., mutable=
    ['batch_stats'])``; without it the call raises (``RESNET_GAP``)."""

    def __init__(self, layers: tuple = (3, 4, 6, 3), output_dim: int = 512,
                 heads: int = 8, image_size: int = 224, width: int = 64,
                 in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()

        def conv(i, o):
            return Conv(i, o, 3, bias=False, compute_dtype=dtype)

        self.conv1, self.bn1 = (Conv(in_chans, width // 2, 3, stride=2,
                                     bias=False, compute_dtype=dtype),
                                BatchNorm(width // 2))
        self.conv2, self.bn2 = conv(width // 2, width // 2), BatchNorm(width // 2)
        self.conv3, self.bn3 = conv(width // 2, width), BatchNorm(width)
        inplanes = width
        self.block_names = []
        for stage, n_blocks in enumerate(layers):
            planes = width * 2 ** stage
            for i in range(n_blocks):
                name = f"layer{stage + 1}_{i}"
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, name, _Bottleneck(inplanes, planes, stride, dtype))
                self.block_names.append(name)
                inplanes = planes * 4
        self.attnpool = AttentionPool2d(width * 32, heads, output_dim,
                                        image_size // 32, dtype)

    def forward(self, x, generator: torch.Generator | None = None,
                mutable: bool = False):
        if self.training and not mutable:
            raise RuntimeError(RESNET_GAP)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = _avg_pool(x, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        out = self.attnpool(x)
        if not self.training:
            return out
        stats = {}
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = (
                    m.new_stats)
                m.new_stats = None
        return out, stats


# ------------------------------------------------------ HIPT ViT-4K


class VisionTransformer4K(nn.Module):
    """HIPT's region-level ViT: a [B, w, h, input_embed_dim] feature map
    from a patch-level encoder, projected by ``phi`` (Linear + exact
    GELU), cls prepended, learned pos embeds added (bicubic-resized from
    the (img_size / 16)^2 grid when the map differs), pre-norm blocks
    (``TransformerStack``, parity "standard": the flash kernels), the cls
    feature (through ``head`` when num_classes > 0)."""

    def __init__(self, input_embed_dim: int = 384, output_embed_dim: int = 192,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 img_size: int = 224, num_classes: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_embed_dim = input_embed_dim
        self.grid = img_size // 16
        self.phi = Dense(input_embed_dim, output_embed_dim, compute_dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, output_embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.grid ** 2 + 1, output_embed_dim))
        self.blocks = TransformerStack(depth, output_embed_dim, num_heads,
                                       mlp_ratio, dtype=dtype,
                                       parity="standard")
        self.norm = LayerNorm(output_embed_dim)
        self.head = (Dense(output_embed_dim, num_classes, compute_dtype=dtype)
                     if num_classes > 0 else None)

    def forward(self, x, generator: torch.Generator | None = None):
        b, w, h, _ = x.shape
        x = F.gelu(self.phi(x.reshape(b, w * h, self.input_embed_dim)))
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = self.pos_embed
        if w * h != self.grid ** 2:
            pos = interpolate_spatial_pos_embed(pos, (self.grid, self.grid),
                                                (w, h), num_extra_tokens=1)
        x = self.blocks(x + pos.to(x.dtype), generator)
        feat = self.norm(x)[:, 0]
        return feat if self.head is None else self.head(feat)


# ------------------------------------------------------------- FocalNet


class FocalModulation(nn.Module):
    """Focal modulation: ``f`` gives (query, context, level gates); the
    context runs through a pyramid of depthwise convs (kernel factor * l +
    window, stride 1, SAME), each level gated and summed, plus a gated
    global-average level; the 1x1 ``h`` forms the modulator, which
    multiplies the query.  NHWC."""

    def __init__(self, dim: int, focal_window: int = 3, focal_level: int = 2,
                 focal_factor: int = 2, use_postln: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.focal_level = dim, focal_level
        self.f = Dense(dim, 2 * dim + focal_level + 1, compute_dtype=dtype)
        for lvl in range(focal_level):
            k = focal_factor * lvl + focal_window
            setattr(self, f"focal_{lvl}", Conv(dim, dim, k, groups=dim,
                                               bias=False, compute_dtype=dtype))
        self.h = Conv(dim, dim, 1, compute_dtype=dtype)
        self.ln = LayerNorm(dim) if use_postln else None
        self.proj = Dense(dim, dim, compute_dtype=dtype)

    def forward(self, x):
        c = self.dim
        f = self.f(x)
        q, ctx, gates = f[..., :c], f[..., c:2 * c], f[..., 2 * c:]
        ctx_all = torch.zeros_like(ctx)
        for lvl in range(self.focal_level):
            ctx = F.gelu(getattr(self, f"focal_{lvl}")(ctx))
            ctx_all = ctx_all + ctx * gates[..., lvl:lvl + 1]
        ctx_global = F.gelu(ctx.mean(dim=(1, 2), keepdim=True))
        ctx_all = ctx_all + ctx_global * gates[..., self.focal_level:]
        out = q * self.h(ctx_all)
        if self.ln is not None:
            out = self.ln(out)
        return self.proj(out)


class _FocalNetBlock(nn.Module):
    """Pre-norm modulation + MLP block, optional layerscale (``gamma_1``,
    ``gamma_2``) and stochastic depth."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, focal_level: int = 2,
                 focal_window: int = 3, drop_path: float = 0.0,
                 use_layerscale: bool = False, layerscale_value: float = 1e-4,
                 use_postln: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layerscale_value = layerscale_value
        if use_layerscale:
            self.gamma_1 = nn.Parameter(torch.empty(dim))
            self.gamma_2 = nn.Parameter(torch.empty(dim))
        else:
            self.gamma_1 = self.gamma_2 = None
        self.norm1 = LayerNorm(dim)
        self.modulation = FocalModulation(dim, focal_window, focal_level,
                                          use_postln=use_postln, dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden, compute_dtype=dtype)
        self.mlp_fc2 = Dense(hidden, dim, compute_dtype=dtype)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, generator: torch.Generator | None = None):
        g1 = 1.0 if self.gamma_1 is None else self.gamma_1
        g2 = 1.0 if self.gamma_2 is None else self.gamma_2
        y = self.modulation(self.norm1(x))
        x = x + self.drop_path1(g1 * y, generator)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop_path2(g2 * y, generator)


class FocalNet(nn.Module):
    """Focal Modulation Network trunk, NHWC: 4 stages with channel
    doubling; stride-2 patch embeds between stages (k3 / s2 / p1 with
    ``use_conv_embed``, else non-overlapping 2x2), a 4x4 / s4 stem (k7 /
    s4 / p2 with ``use_conv_embed``); the final feature globally
    mean-pooled -> [B, num_features]."""

    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 in_chans: int = 3, embed_dim: int = 96,
                 depths: tuple = (2, 2, 6, 2), mlp_ratio: float = 4.0,
                 focal_levels: tuple = (2, 2, 2, 2),
                 focal_windows: tuple = (3, 3, 3, 3),
                 drop_path_rate: float = 0.0, use_conv_embed: bool = False,
                 use_layerscale: bool = False, use_postln: bool = False,
                 patch_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.num_features = embed_dim * 2 ** (len(self.depths) - 1)
        self._embed("patch_embed", in_chans, embed_dim, True, patch_size,
                    use_conv_embed, patch_norm, dtype)
        total, done = sum(self.depths), 0
        for i, depth in enumerate(self.depths):
            dim = embed_dim * 2 ** i
            for j in range(depth):
                # linear stochastic-depth decay over all blocks
                dp = drop_path_rate * (done + j) / max(1, total - 1)
                setattr(self, f"layers_{i}_blocks_{j}", _FocalNetBlock(
                    dim, mlp_ratio, focal_levels[i], focal_windows[i],
                    drop_path=dp, use_layerscale=use_layerscale,
                    use_postln=use_postln, dtype=dtype))
            done += depth
            if i < len(self.depths) - 1:
                self._embed(f"downsample_{i}", dim, dim * 2, False,
                            patch_size, use_conv_embed, patch_norm, dtype)
        self.norm = LayerNorm(self.num_features)

    def _embed(self, name, in_ch, dim, is_stem, patch_size, use_conv_embed,
               patch_norm, dtype):
        if use_conv_embed:
            k, s, p = (7, 4, 2) if is_stem else (3, 2, 1)
        else:
            k = s = patch_size if is_stem else 2
            p = 0
        setattr(self, f"{name}_proj", Conv(in_ch, dim, k, stride=s,
                                           padding=((p, p), (p, p)),
                                           compute_dtype=dtype))
        setattr(self, f"{name}_norm", LayerNorm(dim) if patch_norm else None)

    def _apply_embed(self, name, x):
        x = getattr(self, f"{name}_proj")(x)
        norm = getattr(self, f"{name}_norm")
        return x if norm is None else norm(x)

    def forward(self, x, generator: torch.Generator | None = None):
        x = self._apply_embed("patch_embed", x)
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{j}")(x, generator)
            if i < len(self.depths) - 1:
                x = self._apply_embed(f"downsample_{i}", x)
        return self.norm(x).mean(dim=(1, 2))


def _focalnet_variant(kw, **defaults) -> FocalNet:
    cfg = dict(defaults)
    cfg.update(kw)  # explicit caller kwargs win over the variant defaults
    return FocalNet(**cfg)


def focalnet_tiny_srf(**kw) -> FocalNet:
    return _focalnet_variant(kw, depths=(2, 2, 6, 2),
                             focal_levels=(2, 2, 2, 2), embed_dim=96,
                             drop_path_rate=0.2, use_layerscale=True)


def focalnet_small_srf(**kw) -> FocalNet:
    return _focalnet_variant(kw, depths=(2, 2, 18, 2),
                             focal_levels=(2, 2, 2, 2), embed_dim=96,
                             drop_path_rate=0.3, use_layerscale=True)


def focalnet_base_srf(**kw) -> FocalNet:
    return _focalnet_variant(kw, depths=(2, 2, 18, 2),
                             focal_levels=(2, 2, 2, 2), embed_dim=128,
                             drop_path_rate=0.5, use_layerscale=True)


def focalnet_tiny_lrf(**kw) -> FocalNet:
    """Large receptive field: 3 focal levels."""
    return _focalnet_variant(kw, depths=(2, 2, 6, 2),
                             focal_levels=(3, 3, 3, 3), embed_dim=96,
                             drop_path_rate=0.2, use_layerscale=True)


def focalnet_small_lrf(**kw) -> FocalNet:
    return _focalnet_variant(kw, depths=(2, 2, 18, 2),
                             focal_levels=(3, 3, 3, 3), embed_dim=96,
                             drop_path_rate=0.3, use_layerscale=True)


def focalnet_base_lrf(**kw) -> FocalNet:
    return _focalnet_variant(kw, depths=(2, 2, 18, 2),
                             focal_levels=(3, 3, 3, 3), embed_dim=128,
                             drop_path_rate=0.5, use_layerscale=True)


FOCALNET_VARIANTS = {
    "focalnet_tiny_srf": focalnet_tiny_srf,
    "focalnet_small_srf": focalnet_small_srf,
    "focalnet_base_srf": focalnet_base_srf,
    "focalnet_tiny_lrf": focalnet_tiny_lrf,
    "focalnet_small_lrf": focalnet_small_lrf,
    "focalnet_base_lrf": focalnet_base_lrf,
}


class FocalNetTower(nn.Module):
    """A FocalNet trunk and a linear projection to the embed dim (the
    reference's timm adapter; the trunk mean-pools already)."""

    def __init__(self, out_dim: int, model_name: str = "focalnet_tiny_srf",
                 trunk_cfg: dict | None = None, proj_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = FOCALNET_VARIANTS[model_name](dtype=dtype,
                                                   **(trunk_cfg or {}))
        self.head_proj = Dense(self.trunk.num_features, out_dim,
                               bias=proj_bias, compute_dtype=dtype)

    def forward(self, x, generator: torch.Generator | None = None):
        return self.head_proj(self.trunk(x, generator))


# ------------------------------------------------------------ Perceiver


class _PerceiverMHA(nn.Module):
    """Pre-LN (cross-)attention with separate q / kv norms and a residual,
    then a pre-LN MLP residual (widening factor 1).  A [B, M] pad mask
    (1 = padded) fills the masked scores with fp32's lowest value."""

    def __init__(self, num_heads: int, channels: int, cross: bool,
                 widening_factor: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.channels = num_heads, channels
        self.q_norm = LayerNorm(channels)
        self.kv_norm = LayerNorm(channels) if cross else None
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, Dense(channels, channels, compute_dtype=dtype))
        self.mlp_norm = LayerNorm(channels)
        self.mlp_fc1 = Dense(channels, channels * widening_factor,
                             compute_dtype=dtype)
        self.mlp_fc2 = Dense(channels * widening_factor, channels,
                             compute_dtype=dtype)

    def forward(self, xq, xkv=None, pad_mask=None):
        q_in = self.q_norm(xq)
        kv_n = q_in if xkv is None else self.kv_norm(xkv)
        hd = self.channels // self.num_heads
        b, nq = q_in.shape[:2]
        nk = kv_n.shape[1]
        q = self.q_proj(q_in).reshape(b, nq, self.num_heads, hd)
        k = self.k_proj(kv_n).reshape(b, nk, self.num_heads, hd)
        v = self.v_proj(kv_n).reshape(b, nk, self.num_heads, hd)
        fill = None
        if pad_mask is not None:
            masked = pad_mask[:, None, None, :].bool()
            low = torch.finfo(torch.float32).min

            def fill(s):
                return torch.where(masked, low, s)
        ctx = _attend(q, k, v, hd ** -0.5, fill)
        x = xq + self.o_proj(ctx.reshape(b, nq, self.channels))
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.mlp_norm(x))))
        return x + y


class VisionPerceiver(nn.Module):
    """Perceiver encoder over patch-feature bags: [B, M,
    num_image_channels] features, optional [B, M, 2] pixel coordinates
    and a [B, M] pad mask (1 = padded).  The features are projected and
    added to a 2D sincos embedding of the 256-px tile index on a
    1000 x 1000 grid (the h half first); ``latents`` cross-attend to them
    once, then self-attend; the latents' mean is the feature.  Without
    coords the tiles lie row-major on a ceil(sqrt(M))-wide grid."""

    def __init__(self, num_latents: int = 256, num_latent_channels: int = 512,
                 num_image_channels: int = 512,
                 num_cross_attention_heads: int = 4,
                 num_self_attention_heads: int = 4,
                 num_self_attention_layers: int = 6, grid_size: int = 1000,
                 tile: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.grid_size, self.tile = (num_latent_channels,
                                                    grid_size, tile)
        self.num_self_attention_layers = num_self_attention_layers
        self.input_proj = Dense(num_image_channels, num_latent_channels,
                                compute_dtype=dtype)
        self.latents = nn.Parameter(torch.empty(num_latents,
                                                num_latent_channels))
        self.cross_attn = _PerceiverMHA(num_cross_attention_heads,
                                        num_latent_channels, True, dtype=dtype)
        for i in range(num_self_attention_layers):
            setattr(self, f"self_attn_{i}", _PerceiverMHA(
                num_self_attention_heads, num_latent_channels, False,
                dtype=dtype))

    def _coord_pos_embed(self, coords):
        """[B, M, 2] pixel coords -> [B, M, C] sincos of the clamped tile
        index (row half, then column half)."""
        pos = torch.clamp(torch.floor(coords / float(self.tile)), 0,
                          self.grid_size - 1)
        c_half = self.channels // 2
        omega = torch.arange(c_half // 2, dtype=torch.float32,
                             device=coords.device) / (c_half / 2.0)
        omega = 1.0 / 10000 ** omega

        def sincos(p):
            out = p[..., None].float() * omega
            return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

        return torch.cat([sincos(pos[..., 0]), sincos(pos[..., 1])], dim=-1)

    def forward(self, x, coords=None, pad_mask=None,
                generator: torch.Generator | None = None):
        b, m, _ = x.shape
        x = self.input_proj(x)
        if coords is None:
            g = max(1, int(np.ceil(np.sqrt(m))))
            idx = torch.arange(m, device=x.device)
            coords = torch.stack([(idx // g) * self.tile,
                                  (idx % g) * self.tile], dim=-1).float()
            coords = coords[None].expand(b, m, 2)
        x = x + self._coord_pos_embed(coords).to(x.dtype)
        z = self.latents[None].to(x.dtype).expand(b, -1, -1)
        z = self.cross_attn(z, x, pad_mask)
        for i in range(self.num_self_attention_layers):
            z = getattr(self, f"self_attn_{i}")(z)
        return z.mean(dim=1)


class PerceiverTower(nn.Module):
    """The Perceiver as a vision tower: [B, M, C] feature bags or
    [B, H, W, C] maps (flattened row-major, which matches the default
    tile coords); projected by ``proj`` when its latent width is not
    ``out_dim``."""

    def __init__(self, out_dim: int, cfg: dict | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.perceiver = VisionPerceiver(dtype=dtype, **(cfg or {}))
        width = self.perceiver.channels
        self.proj = (Dense(width, out_dim, compute_dtype=dtype)
                     if width != out_dim else None)

    def forward(self, x, generator: torch.Generator | None = None,
                coords=None, pad_mask=None):
        if x.ndim == 4:
            b, h, w, c = x.shape
            x = x.reshape(b, h * w, c)
        z = self.perceiver(x, coords, pad_mask, generator)
        return z if self.proj is None else self.proj(z)


# ------------------------------------------------------ HF text tower


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "HFTextTower needs the transformers package (its torch "
            "AutoModel), which is not installed here") from e
    return transformers


class HFTextTower(nn.Module):
    """A HuggingFace text encoder as a CLIP text tower, built with
    ``transformers.AutoModel.from_config`` from ``hf_config`` (a config
    object; random init) or the config of a LOCAL ``model_name_or_path``
    (nothing is fetched).  Token ids [B, L] -> the pad-masked mean of the
    last hidden state ('mean_pooler') or its first token ('cls_pooler'),
    then a bias-free projection: 'linear', or 'mlp' (fc1 -> GELU -> fc2
    through (width + output_dim) / 2); with ``proj=None`` only when the
    widths differ.  Encoders with the BERT call signature (bert, roberta,
    electra)."""

    def __init__(self, output_dim: int, model_name_or_path: str | None = None,
                 hf_config: Any = None, pooler_type: str = "mean_pooler",
                 proj: str | None = "linear",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        tf = _transformers()
        cfg = hf_config
        if cfg is None:
            if model_name_or_path is None:
                raise ValueError("need hf_config or model_name_or_path")
            cfg = tf.AutoConfig.from_pretrained(model_name_or_path,
                                                local_files_only=True)
        self.config = cfg
        self.pooler_type, self.proj = pooler_type, proj
        self.transformer = tf.AutoModel.from_config(cfg)
        width = getattr(cfg, "hidden_size", getattr(cfg, "d_model", None))
        self._needs_proj = proj is not None or width != output_dim
        if proj == "mlp":
            hidden = (width + output_dim) // 2
            self.proj_fc1 = Dense(width, hidden, bias=False,
                                  compute_dtype=dtype)
            self.proj_fc2 = Dense(hidden, output_dim, bias=False,
                                  compute_dtype=dtype)
        elif self._needs_proj:
            self.proj_fc1 = Dense(width, output_dim, bias=False,
                                  compute_dtype=dtype)

    def forward(self, x, generator: torch.Generator | None = None):
        pad_id = self.config.pad_token_id or 0
        mask = (x != pad_id).long()
        pos = torch.arange(x.shape[1], device=x.device).expand(x.shape)
        hidden = self.transformer(
            input_ids=x, attention_mask=mask, token_type_ids=torch.zeros_like(x),
            position_ids=pos, head_mask=None).last_hidden_state
        if self.pooler_type == "cls_pooler":
            pooled = hidden[:, 0]
        else:  # the pad-masked mean
            m = mask[..., None].to(hidden.dtype)
            pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1),
                                                          min=1.0)
        if self.proj == "mlp":
            return self.proj_fc2(F.gelu(self.proj_fc1(pooled)))
        if self._needs_proj:
            return self.proj_fc1(pooled)
        return pooled


AUX_TOWERS = (TextTransformer, HFTextTower, ModifiedResNet,
              VisionTransformer4K, FocalNetTower, PerceiverTower)


# ---------------------------------------- seeded init (flax's defaults)


def _lecun(p: torch.Tensor, g: torch.Generator):
    from .vit_st import _lecun_

    _lecun_(p, g)


def _normal(p: torch.Tensor, std: float, g: torch.Generator):
    p.normal_(0.0, std, generator=g)


_OWN = {  # parameters the JAX modules initialise by name
    "positional_embedding": lambda p, m, g: _normal(
        p, 0.01 if isinstance(m, TextTransformer) else p.shape[-1] ** -0.5, g),
    "text_projection": lambda p, m, g: _normal(p, 0.01, g),
    "cls_token": lambda p, m, g: _normal(p, 0.02, g),
    "pos_embed": lambda p, m, g: _normal(p, 0.02, g),
    "latents": lambda p, m, g: _normal(p, 0.02, g),
    "gamma_1": lambda p, m, g: p.fill_(m.layerscale_value),
    "gamma_2": lambda p, m, g: p.fill_(m.layerscale_value),
}


@torch.no_grad()
def init_tower(tower: nn.Module, generator: torch.Generator):
    """Seeded random weights for an aux tower with the JAX modules'
    distributions: Dense and Conv kernels lecun truncated-normal, Embed
    rows N(0, 1 / width), norms' scales 1 and biases 0, running means 0
    and variances 1, and the named parameters of ``_OWN``; a HuggingFace
    encoder as its Flax init (kernels and embeddings N(0,
    initializer_range), biases 0, LayerNorms 1 / 0)."""
    hf = [m.transformer for m in tower.modules() if isinstance(m, HFTextTower)]
    hf_ids = {id(p) for t in hf for p in t.parameters()}
    for m in tower.modules():
        for name, p in m.named_parameters(recurse=False):
            if id(p) in hf_ids:
                continue
            if name in _OWN:
                _OWN[name](p, m, generator)
            elif name == "bias":
                p.zero_()
            elif isinstance(m, (nn.LayerNorm, BatchNorm)):
                p.fill_(1.0)
            elif isinstance(m, Embed):
                _normal(p, p.shape[1] ** -0.5, generator)
            else:  # Dense / Conv kernels
                _lecun(p, generator)
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for t in hf:
        std = t.config.initializer_range
        for m in t.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                _normal(m.weight, std, generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        emb = getattr(t, "embeddings", None)
        if emb is not None and hasattr(emb, "position_ids"):
            emb.position_ids.copy_(torch.arange(emb.position_ids.shape[-1])
                                   .expand_as(emb.position_ids))
        if emb is not None and hasattr(emb, "token_type_ids"):
            emb.token_type_ids.zero_()
