"""Blank-region pre-mask from patch embeddings (counterpart of
octcubem_tpu/data/premask.py), the same steps in float32:

1. per-frame cosine self-similarity of the patch embeddings;
2. each patch's mean similarity; the top ``p_emb_mask_ratio`` fraction of
   each frame are blank candidates (blank regions are self-similar);
3. the top and bottom ``up_down_clear`` patch rows are cleared (image
   borders);
4. a per-volume target count, max(max per-frame count, L/2), and each
   frame topped up to it by its highest-scoring unmasked patches.

Returns a [B, T*L] float mask (1 = force-mask), the ``pre_mask`` that
``ops.masking.random_masking`` takes.  The sorts are stable, as JAX's
argsort is: the key ``cand * 1e6 + score`` ties often in fp32 (its
spacing at 1e6 is 0.0625).  The similarity product runs in full fp32 on
the card (TF32 off for its duration, whatever the caller set), so the
card and the CPU differ only in summation order.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """Full-fp32 CUDA matmuls inside the block; the flag is restored after
    (a process-wide flag: not for concurrent use from threads)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def premask_scores(patch_embed: torch.Tensor, t_grid: int,
                   grid: int) -> torch.Tensor:
    """[B, T*L, D] -> [B, T, L]: each patch's mean cosine similarity to the
    patches of its frame."""
    b, tl, d = patch_embed.shape
    l = grid * grid
    if tl != t_grid * l:
        raise ValueError(f"{tl} tokens != {t_grid} frames x {l} patches")
    x = patch_embed.reshape(b, t_grid, l, d).float()
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
    with _ieee_fp32_matmul():
        sim = torch.matmul(x, x.transpose(-1, -2))       # [B, T, L, L]
    return sim.mean(dim=-1)


def compute_premask(patch_embed: torch.Tensor, t_grid: int, grid: int,
                    p_emb_mask_ratio: float = 0.6,
                    up_down_clear: int = 3) -> torch.Tensor:
    """patch_embed [B, T*L, D] (``model.forward_patch_embed``) -> the
    pre-mask [B, T*L] float32."""
    b = patch_embed.shape[0]
    l = grid * grid
    score = premask_scores(patch_embed, t_grid, grid)
    k = int(l * p_emb_mask_ratio)
    # candidates: the top-k most self-similar patches of each frame
    thresh = torch.sort(score, dim=-1, stable=True).values[..., l - k, None]
    cand = (score >= thresh).float()
    # clear the top and bottom patch rows (image borders)
    row = torch.arange(l, device=score.device) // grid
    border = (row < up_down_clear) | (row >= grid - up_down_clear)
    cand = cand.masked_fill(border, 0.0)
    # per-volume target: the most any frame has, at least L/2
    counts = cand.sum(dim=-1)                                     # [B, T]
    target = torch.clamp(counts.amax(dim=-1, keepdim=True), min=l // 2)
    # top up each frame: order by (candidate desc, score desc), mask the
    # first `target`
    key = cand * 1e6 + score
    order = torch.argsort(-key, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    mask = (rank < target[..., None]).float()
    return mask.reshape(b, t_grid * l)
