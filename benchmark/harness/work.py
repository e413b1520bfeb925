"""The yardstick's arithmetic: published peaks of one NVIDIA H100 and the
work that a call needs, counted from its shapes.

The peaks are NVIDIA's data sheet for the H100 SXM part, dense rates
without sparsity, at the full power limit of 700 W: 989 TFLOP/s in bf16
and 3.35 TB/s of HBM.  A run prints the card's power limit beside them.

The attention counts follow ``octcubem_tpu_torch/scripts/time_kernels.py``
(``fwd_work``) and ``chip_smoke.py``'s B2 timing, copied here so that a
later change to the program cannot move the yardstick.  The exp term of
``time_kernels.bound`` is left out on purpose: it is worked out from the
card's clock, not published, and the forward puts some of its exps on the
FMA pipe, so a share built on it could read above 100 %.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12       # HBM3 bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its products at the bf16
    peak and its bytes at the HBM rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attn_split(n: int) -> tuple[int, int]:
    """(query rows, keys) that the kernels see for a sequence of n tokens:
    a cls-prefixed length (n % 128 == 1, n > 128) runs n - 1 query rows
    against n keys (the cls token folded in as the extra key); any other
    n runs n against n."""
    if n % 128 == 1 and n > 128:
        return n - 1, n
    return n, n


def attn_fwd_work(b: int, h: int, n: int, d: int, es: int = 2):
    """(FLOP, bytes) of one attention forward over n tokens: QK^T and PV
    (4 b h m keys d), one read of q, k and v, one write of o and of the
    fp32 log-sum-exp."""
    m, keys = attn_split(n)
    flops = 4 * b * h * m * keys * d
    nbytes = (2 * b * h * m * d + 2 * b * h * keys * d) * es + b * h * m * 4
    return flops, nbytes


def attn_bwd_work(b: int, h: int, n: int, d: int, es: int = 2):
    """(FLOP, bytes) of one attention backward: the five products of
    FlashAttention's backward (S and dP recomputed, dV, dQ, dK: 10 b h m
    keys d); q, k, v, o, dO read and dq, dk, dv written once, the fp32
    log-sum-exp read, and the cls row's key and value read and their
    gradients written where the sequence has one."""
    m, keys = attn_split(n)
    flops = 10 * b * h * m * keys * d
    nbytes = 8 * b * m * h * d * es + b * h * m * 4
    if keys > m:
        nbytes += 4 * b * h * d * es
    return flops, nbytes


def vit_fwd_flops(n: int, layers: int = 24, d: int = 1024, pix: int = 0,
                  l: int = 0) -> float:
    """One ViT forward over n tokens (``chip_smoke.py``'s count): the
    block projections (2 n 12 d^2 a block), the attention products
    (4 n^2 d a block), the patch projection (2 l pix d)."""
    return layers * (2 * n * 12 * d * d + 4 * n * n * d) + 2 * l * pix * d


def mae_train_flops(d: int = 1024, layers: int = 24, dd: int = 512,
                    dlayers: int = 8, frames: int = 60, img: int = 256,
                    patch: int = 16, tpatch: int = 3,
                    mask: float = 0.90) -> float:
    """Analytic FLOPs of one 3D MAE train step per volume, fwd + bwd =
    3 x fwd (``chip_smoke.py``'s ``mae_train_flops``, itself the copy of
    ``bench.py``'s)."""
    l_full = (frames // tpatch) * (img // patch) ** 2
    l_vis = int(l_full * (1 - mask)) + 1
    l_dec = l_full + 1
    dense = (layers * 2 * l_vis * 12 * d * d
             + dlayers * 2 * l_dec * 12 * dd * dd
             + 2 * l_full * (tpatch * patch * patch) * d
             + 2 * l_dec * dd * (tpatch * patch * patch)
             + 2 * l_dec * d * dd)
    attn = layers * 4 * l_vis * l_vis * d + dlayers * 4 * l_dec * l_dec * dd
    return 3.0 * (dense + attn)


def coem_flops(pairs: int, unlocked: int = 8, layers: int = 24,
               oct_tokens: int = 5121, oct_pix: int = 3 * 16 * 16,
               enf_tokens: int = 577, enf_pix: int = 16 * 16 * 3,
               d: int = 1024) -> float:
    """Analytic FLOPs of a locked, rematerialised COEM accumulation step
    over ``pairs`` pairs (``chip_smoke.py``'s ``coem_flops``): pass 1 both
    forwards; pass 2 both forwards again, the OCT tower's ``unlocked``
    blocks recomputed and differentiated (3x their share), every en face
    block recomputed and differentiated (3x)."""
    oct_f = vit_fwd_flops(oct_tokens, layers, d, pix=oct_pix,
                          l=oct_tokens - 1)
    enf_f = vit_fwd_flops(enf_tokens, layers, d, pix=enf_pix,
                          l=enf_tokens - 1)
    per = 2 * (oct_f + enf_f) + 3 * oct_f * unlocked / layers + 3 * enf_f
    return pairs * per
