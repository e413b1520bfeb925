#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (octcubem_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase's error is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (nvcc, one process per source);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths and their neighbours give it, bf16 and fp32,
     plus a large-logit case, within stated tolerances: B1 (forward) and
     B2 (backward) on the packed layout; B3 / B5 (forward with and
     without the cls fold) and B4 / B7 (their backward) on the
     [B, H, N, D] views of the fused buffer, with the rectangular
     kv_valid form and B7's exact-softmax branch; ragged cases at each
     head_dim of the bf16 one-pass backward (query rows not a multiple
     of its query tile, keys not a multiple of its 128-key tile); every
     backward called twice: dk, dv, dkc, dvc bit-identical, dq (fp32
     adds in varying order) within tolerance on both runs; the bf16
     Hopper forward body (B1, B3, B5 at D in {32, 64, 80, 128}) on both
     routes: ragged rows and keys, with and without the cls fold, the
     rect form with kv_valid < Nk and NaN in the tail rows, q x 40, each
     call made twice with o and lse bit-identical; also at the
     fine-tuning family's 2D trunks (48, 197, 16, 64; no fold) and,
     head by head, at the variable_joint high-res stream's (1, 16,385,
     16, 64; folded), whose plain scores over all heads would take 17.2
     GB a tensor; and, sample by sample, at the COEM towers' (8, 5,121,
     16, 64; folded) and (8, 577, 16, 64; not folded), with B1 alone at
     the octcube_ir preset's chunk of 32 x 5,121; since PR 13 at head_dim
     16 (the Hopper forward on both forms, B3-B5 and B7 ragged and at
     large logits) and at phase 21's shapes: B1 / B2 at (128, 257, 6, 32;
     folded), B3 / B4 at (64, 257, 12, 16), B5 / B7 at (64, 197, 12, 16)
     and the rect form (197 query rows, 260 keys, kv_valid 250);
  4. the serving path: entry()'s ViT-L 48x256x256 bf16 forward, its
     launch counts, finite [1, 16] logits that agree with the same model
     run with impl="naive";
  5. serving: cli/serve.py's server in a thread with the ViT-L model,
     /healthz and four /predict requests;
  6. the ViT-H/14 classifier (16 heads of 80): entry()'s 48x224x224 bf16
     forward (32 B3 launches, no B1) against impl="naive"; its backward
     under a cross-entropy (32 B3 + 32 B4 launches), and the model cut to
     2 blocks against impl="naive" in loss and per-leaf gradients, fp32
     and bf16;
  7. the training path: train_entry()'s 3D MAE step (mask 0.90, batch 4,
     bf16, AdamW), three steps per configuration: ViT-L/16 at 60x256x256
     with both decoder geometries (32 B1 + 32 B2 launches per step) and
     ViT-H/14 at 60x224x224 (32 B5 + 32 B7 in the encoder, 8 B1 + 8 B2 in
     the decoder); finite loss and grad norm, params unchanged by the
     first update (its LR is 0) and changed by the next two, peak device
     memory, the step's time beside the parent tree's;
  8. flash against impl="naive" under autograd: each MAE cut to 2 + 2
     blocks at batch 2, loss and per-leaf gradients, fp32 and bf16;
  9. B1 and B2 at the ViT-L step's shapes, B3-B5 and B7 at the ViT-H
     paths' shapes, laid out as the paths lay them out, against their
     plain versions (the backward twice, as in phase 3); timings with
     CUDA events (kernel, plain version, a PyTorch library yardstick, the
     bound; the forwards and the steps).  A forward's bound is the larger
     of its products, its bytes and its exps (one per score, at the SFU's
     16 per clock per SM and the card's max SM clock: time_kernels.py);
 10. B6, the exact online softmax, against its plain version, fp32 and
     bf16, D in {32, 64, 80, 128, 256}, square (the fused buffer's
     views, ragged against the tiles) and rect with kv_valid < Nk and NaN
     past it, and with logits far above the fixed shift's clamp (q, k x 8;
     q x 40), where B6 agrees with impl="naive" and B5 does not; each
     case on the body it should run (bf16 at D <= 128 the Hopper body, by
     the kernel's name in a profile) and called twice, bit-identical;
     then B6 + B7's exact branch under autograd against the plain
     versions;
 11. the sequence-parallel layer on a one-rank NCCL group (a FileStore,
     no port): sequence_parallel_attention (no_max True and False) and
     ring_attention against unsharded flash_attention, forward and
     gradients, at the ViT-L MAE decoder's [4, 16, 5121, 32] in bf16;
     then that decoder's TransformerStack(8, 512, 16) at full width, batch
     4, bf16, with attn_impl="flash_sp" against attn_impl="flash" from the
     same weights: loss and per-leaf gradients, 8 B5 + 8 B7 launches
     against 8 B1 + 8 B2;
 12. the 4-shard geometry on one card: each rank's local body of
     sequence_parallel_attention (1,281 query rows of the decoder's 5,121
     padded to 5,124, against all 5,124 keys with kv_valid 5,121), B5 and
     B6, against unsharded attention; the shards' gradients summed
     against the unsharded ones, pad rows' gradients exactly 0;
 13. B8 on the Hopper body, every ablation variant at every tile,
     against its plain version at the harness's shape (BH 64, N 5,121,
     D 32), then the harness's timings (scripts/kablate.py);
 14. timings of B6 (the decoder's square shape and the shard shape,
     beside the parent's mma.sync body's) and B8 against their bounds,
     plain versions and SDPA;
 15. the vitl_joint_pretrain step at full width (ViT-L/16 MAE, decoder
     512 x 8 blocks x 16 heads, bf16): the 3D batch 4 x 60x256x256 at
     mask 0.90 with the in-step pre-mask, the 2D batch 64 x 3x512x512 at
     mask 0.75 in accum_2d=4 microbatches; three steps (finite, the LR-0
     first update, 160 B1 + 160 B2 launches each and no other kernel),
     saved after steps 1 and 2 (async, keep_last=2), restored into a
     fresh state bit for bit, step 3 from both (loss equal, gradients
     within the run-to-run limit of B2's dq), delete_recent_checkpoints
     leaving step 1;
     the step's time and peak memory beside its bound; the pre-mask on
     the card against the plain one on the CPU from the same embeddings
     of volumes with zeroed bands; remat_2d (the 2D batch whole through a
     remat model2d: 96 B1 launches against 64, a lower peak; at 2 + 2
     blocks the same loss and gradients within tolerance); cli/export.py
     of the checkpoint with its geometry stamp, cli/serve.py serving it
     (head from init, decoder keys unexpected) against vit_st run
     directly, a num_heads=8 stamp refused; a seeded ViT-L RETFound 2D
     checkpoint converted and imported into the MAE, one finite joint
     step from it;
 16. the serving options on the ViT-L/16 classifier at 48x256x256, batch
     1: the int8 model (block projections quantized from the bf16 one):
     24 B1 launches and int8 GEMMs in a profile, logits within the JAX
     test's int8 bound of the bf16 model, every disease's argmax equal,
     both forwards timed, cli/serve.py --quant int8 answering; the AOT
     artifact exported on the card (24 B1 op calls in its graph, 24 B1
     launches, the live logits to 1e-6), one exported on the CPU for
     ("cuda", "cpu") run on the card through B1, a cpu-only one refused
     there, cli/serve.py --aot answering, export and load seconds;
     Grad-CAM at full depth, bf16 and fp32, at layer -1 and 0 (B1 per
     block, B2 per block after the chosen one), a finite map in [0, 1]
     and its time, and flash against impl="naive" at 4 blocks; cli/infer.py
     on a .dcm equal to the same volume as .npy;
 17. the 2D MAE (mae_vit_large_patch16, 224, in_chans 1, bf16, fp32
     params), batch 16, mask 0.75: three forward-backward + AdamW updates
     (finite, the LR-0 first update, 32 B1 + 32 B2 launches each and no
     other kernel), the step's time and peak beside its bound; at 2 + 2
     blocks, batch 2, flash against impl="naive" in loss and per-leaf
     gradients, fp32 and bf16.  Phase 3 holds B1 and B2 at its shapes
     (n 50 and 197) and B2 at the serving shape;
 18. cli/pretrain.py in process on the card (octcubem_tpu_torch.cli.
     pretrain.main): the vitl_joint_pretrain preset at full width on 56
     synthetic volumes (batch 4, the 2D batch 64 in 4 microbatches), two
     epochs of two steps with a torch.profiler trace (args.json, log.txt,
     the SPL pickles, ckpt/{0,1}, the trace naming B1's and B2's kernels,
     its idle share); --resume latest into a third epoch (the state bit
     for bit before its first step, the 2D mask 0.80: B1 / B2 at n 205,
     which phase 3 also holds, the SPL dict reloaded);
     training_continue_reset_optim (the saved params, a fresh optimizer,
     epoch 0); the preset's first logged loss against one
     make_mae_train_step step on the CLI loaders' first batches at the
     CLI's seeds (TOL_CLI_LOSS); --mode 2d (the ViT-L/16 2D MAE at 224,
     batch 16); 160 B1 + 160 B2 launches in every joint step and 32 + 32
     in every 2D update; the CLI's step time (host wall and CUDA events),
     peak, model build and checkpoint staging seconds beside
     time_joint's direct step;
 19. the fine-tuning family (train/finetune_engine.py, the layer-decay
     AdamW gated on the device): the octcube_multitask step at full width
     (ViT-L/16 48x256x256, batch 1, drop path 0.2, layer decay 0.65):
     three steps (finite, the LR-0 first update, 24 B1 + 24 B2 each and
     no other kernel), a NaN volume's step reverted on the device and the
     next step against a run without it, the step's time, peak and trace
     (idle share, no device-to-host copy); that model cut to 2 blocks,
     flash against impl="naive" in loss and gradients, fp32 and bf16; the
     variable_joint model on its 256 and 512 streams (4,097 and 16,385
     tokens); vit2d (batch 48) and vit_3dhead (48 slices) at 224 (197
     tokens, no fold); the slivit_ct3d model (4 x 60 slices at 256^2,
     no hand-written kernel in its profile) and the ViT-L trunk with a
     SLIViT head; cli/predict.py in process (the CSV equal to the direct
     forward, --quant int8, --export_aot / --aot) and cli/finetune.py in
     process (the octcube_multitask preset on 10 synthetic volumes, the
     slivit_ct3d preset on a MedMNIST-layout .npz);
 20. the COEM contrastive path (train/clip_engine.py, models/coem.py) at
     full width and depth, bf16: the octcube_ir accumulation step on
     vitl16_octcube_ir (OCT ViT-ST-L/16 at 60x256x256, 5,121 tokens
     folded; en face ViT-L/16 at 384^2, 577 tokens; grad checkpointing,
     the partition lock at 9 groups), chunk 8 x accum_freq 2, three steps
     (finite, 256 B1 + 64 B2 each and no other kernel, the frozen params
     bit for bit with no moments, the trainable ones moved, no
     device-to-host copy in a step's trace, its time, peak, idle share
     and bound), and one step at the preset's 32 x 4 (512 B1 + 128 B2);
     the accumulated step against the full batch at 2 + 2 blocks in fp32
     (the JAX test's 1e-4 / 1e-3); flash against impl="naive" at 2 + 2
     blocks, fp32 and bf16 (the CLIP loss, and the gradients of a fixed
     random projection of the features); one vitl16_octcube_ef_3mod
     step (4 x 2: 400 B1 + 112 B2); clip_pair_gradcam at full width (OCT
     layers -1 and 0);
     cli/retclip.py in process on the octcube_ir preset (80 synthetic
     pairs, batch 8 x accum 4: the epoch, the retrieval pkl, the save,
     --resume latest with the state bit for bit, --evaluate_only --quant
     int8, --export_aot (48 B1 op calls, features equal to the live
     model's) and --aot, the first loss against one direct step);
     cli/retclip_finetune.py on vitl16_octcube_ef_3mod (synthetic, fp32,
     the lock, two folds of one epoch) and a vitl16_octcube_ir
     classifier's towers from the retclip run; cli/retrieval_eval.py on
     the dumped features with a seeded laterality column;
 21. the auxiliary COEM towers (models/aux_towers.py), bf16: the main
     path, a HIPT vit4k_xs <-> CLIP-text pair (ViT-B-16's text_cfg) built
     by create_coem_model from a JSON file, 128 pairs of seeded 16 x 16 x
     384 region features and SimpleTokenizer ids, three
     make_clip_train_step steps with the port's AdamW (finite, exactly 6
     B1 + 6 B2 each and no other kernel, the LR-0 first update, every
     param moved after; time, peak, idle share, bound); the pair at 2
     blocks, flash against impl="naive", fp32 and bf16; the default
     VisionTransformer4K (12 blocks of 12 heads of 16) at batch 64 on a
     16 x 16 map (12 B3 + 12 B4) and a 14 x 14 map (12 B5 + 12 B7),
     forward and backward, and at 2 blocks against impl="naive"; RN50's
     ModifiedResNet (eval and batch-stats mode), focalnet_tiny_srf and
     perceiver_base forward and backward with no csrc kernel in a
     profile; B3, B4, B5, B7 timed at head_dim 16.  Then one
     {"kernels": [...]} line with B1-B8; B1's and B2's entries carry
     ``launches_per_step_on``: for each phase-19, phase-20 and phase-21
     path, the launches counted in each of its checked steps of this run;
     B3's, B4's, B5's and B7's carry phase 21's, and ``at_head_dim_16``:
     their error and timing row at the default HIPT's shapes;
 22. the multi-rank paths (ROADMAP A14): (a) on a one-rank NCCL group
     formed by core/multihost.initialize, entry()'s ViT-L classifier
     with attn_impl="flash_tp" under use_tensor_parallel (its weights
     through shard_tp_params) against flash (24 B1), and three ViT-L MAE
     steps per decoder geometry under flash_tp against flash from the
     same state (step 1's loss and block 0's Wqkv gradient; 32 B1 + 32
     B2 a step); (b) the n_tp = 4 geometry one rank's body at a time at
     full ViT-L width (the encoder block at 4,097 tokens, both decoder
     geometries at 5,121): each sublayer's projections split by
     shard_tp_params' rule, the row-parallel partials summed as the
     all-reduce sums them, against the unsharded sublayer forward and
     backward; B1 / B2 at the rank's shard shapes (TP_SHARDS) against
     their plain versions and timed (events, plain, SDPA, bound); (c)
     two gloo ranks sharing cuda:0 (spawned, a FileStore, backend="gloo"
     given explicitly): cli/pretrain.py on vitl_joint_pretrain at full
     width (2 volumes and 8 2D images a rank), cli/retclip.py on
     octcube_ir (4 pairs x accum_freq 2 a rank) and cli/predict.py
     --n_data 2, each against the same CLI on one rank fed the global
     batch (the first loss within TOL_DP_LOSS, the launches per step
     equal, the CSV within TOL_DP_PROB), with each rank's step time, the
     gloo all-reduce's host time apart, and peak; since PR 15 also
     cli/pretrain.py at n_sp 2 on the two ranks (every stack's tokens
     split over them, B5 / B7 through flash_sp, the gathers' gloo
     fallback) against one rank on the same batch; (d) B1's and B2's
     entries of the kernels line carry ``at_tp_shards``: the rows of (b).
 23. states sharded over fsdp (ROADMAP A15, core/fsdp.py): (a) on a
     one-rank NCCL group, the ViT-L MAE step on a state placed by
     shard_state (fsdp_param_spec, data 1 x fsdp 1) against the
     replicated step: losses bit-equal, grad norms, gradients and
     params within B2's run-to-run limit, 32 B1 + 32 B2 a step; (b) two
     gloo ranks sharing cuda:0 on a data 1 x fsdp 2 mesh: the
     vitl_joint_pretrain step at full width (2 volumes and 8 2D images,
     accum_2d 1; 22c's geometry) and the octcube_ir CLIP step at 4
     pairs, each against one rank on the same batch (the first loss
     within TOL_FSDP_LOSS, the launches per step equal), with each
     rank's step time in CUDA events, the gathers', reduce-scatters'
     and all-reduces' host time apart, and its peak; a checkpoint saved
     by both ranks at step 1, resumed onto fsdp 2 and onto one rank
     (step 2's loss bit-equal to the uninterrupted run's); (c)
     entry.dryrun_multichip(4) on four gloo ranks sharing the card: its
     five legs and the ViT-L-width production leg finite.
The last line is {"ok": true, "device": {...}}.  Exits non-zero with no
result when there is no CUDA device or no port package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel-vs-plain tolerances: |d| <= atol + rtol * |plain|.
# fp32: the JAX kernel tests' own 5e-5 (summation order only).
# bf16: o is rounded to bf16 on both sides, so one rounding step apart is
# 2^-7 relative; allow two, plus an absolute floor for values near 0.
TOL_O = {"float32": (5e-5, 0.0), "bfloat16": (2 ** -8, 2 ** -6)}
TOL_LSE = 1e-4  # fp32 statistics on both sides
# B2 kernel-vs-plain, |d| <= tol * max|plain| per output:
# fp32: the JAX kernel-gradient tolerance (tests/test_flash_attention.py);
# the sums run over up to 5,121 terms in another order.
# bf16: each output is rounded to bf16 on both sides (2^-9 relative), and
# p and ds are rounded to bf16 before their products on both sides, so a
# score whose fp32 value differs in the last bit may round the other way;
# allow one bf16 step of the largest gradient, 2^-8, twice over.
# The bf16 backward at head_dim <= 128 adds dq's per-key-tile shares in
# fp32 in varying order: dq is held to the same tolerance on each of two
# runs, dk, dv, dkc and dvc must be bit-identical between them.
TOL_GRAD = {"float32": 5e-4, "bfloat16": 2 ** -7}

# the ViT-L and ViT-H step times of the parent tree: this script's own
# phase 7 in PR 4's final run, NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
PARENT_STEP_MS = {("ViT-L/16 60x256x256", 16): 118.597,
                  ("ViT-L/16 60x256x256", 4): 105.866,
                  ("ViT-H/14 60x224x224", 16): 151.139}
# B6 on the body it ran before the Hopper one (the mma.sync kernel), CUDA
# events per call at phase 14's two shapes, NVIDIA H100 80GB HBM3 at
# 700 W: the mean of scripts/time_kernels.py's two parent runs in an A/B
# call (PERF.md)
PARENT_B6_MS = {"square": 1.24775, "shard": 0.38244}
# the ViT-L logits, flash (fixed shift, unnormalised bf16 p) vs naive
# (exact softmax, normalised bf16 p) through 24 bf16 blocks.  Measured on an
# H100 at 700 W with seeded weights: 7.8e-3 (first kernel version) and
# 5.9e-3 (this one), on logits up to 0.92; the limit is ~2.5x the larger.
TOL_LOGITS = 2e-2


def _elapsed_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_args(qkv, num_heads):
    """B1's inputs for a fused buffer: tokens 1: with the cls row folded
    for a cls-prefixed n, else all tokens."""
    hd = qkv.shape[-1] // 3
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    n = qkv.shape[1]
    if n % 128 == 1 and n > 128:
        return q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1]
    return q, k, v, None, None


# (B, n, H, D, q scale) of the vitl_joint_pretrain step's 2D branch, at the
# microbatch of accum_2d=4 (64 / 4): the encoder at 256 visible patches of
# a 512x512 image (mask 0.75) + cls, folded; the decoder at 1,024 + cls;
# and the encoder at the 2D mask ratio cli/pretrain.py's schedule gives a
# third epoch after one warmup epoch (0.80: int(1024 * 0.19999...) = 204
# visible + cls = 205, 205 % 128 = 77, no fold), which phase 18's resumed
# run reaches
JOINT_2D_CASES = [(16, 257, 16, 64, 1.0), (16, 1025, 16, 32, 1.0),
                  (16, 205, 16, 64, 1.0)]
# (B, n, H, D, q scale) of the 2D MAE (mae_vit_large_patch16 at 224, batch
# 16, mask 0.75): the encoder at 49 kept patches + cls, the decoder at
# 196 + cls, neither folded (n % 128 != 1)
MAE2D_CASES = [(16, 50, 16, 64, 1.0), (16, 197, 16, 32, 1.0)]
# (B, n, H, D, q scale) of the fine-tuning family's 2D trunks: vit2d at
# 224 (batch 48) and vit_3dhead's trunk over 48 slices, 196 patches + cls,
# not folded (197 % 128 = 69)
FT_2D_CASES = [(48, 197, 16, 64, 1.0)]
# (B, n, H, D) of the variable_joint model's high-res stream: 48x512x512
# -> 16 x 32 x 32 tubes + cls, folded
HIGH_RES_CASE = (1, 16385, 16, 64)
# (B, n, H, D, q scale) of phase 21's HIPT vit4k_xs tower: a 16 x 16 map of
# region features + cls, folded, 6 heads of 32, at its batch of 128 pairs
HIPT_PAIR_CASES = [(128, 257, 6, 32, 1.0)]


def check_flash_fwd(torch, fa):
    """Phase 3: B1 against its plain version.  Returns the max |do| at the
    ViT-L shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 4097, 16, 64, 1.0), (1, 4097, 8, 128, 1.0),
             (1, 1025, 32, 32, 1.0), (1, 513, 4, 256, 1.0),
             (1, 4000, 16, 64, 1.0),
             (1, 512, 16, 64, 1.0),  # the MAE encoder's: 511 + cls, no fold
             (1, 4097, 16, 64, 40.0),  # q scaled: most logits above the clamp
             *JOINT_2D_CASES, *MAE2D_CASES, *FT_2D_CASES, *HIPT_PAIR_CASES]
    vitl_err = None
    for b, n, h, d, qmul in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda")
            qkv[..., :h * d] *= qmul
            qkv = qkv.to(dtype)
            args = _kernel_args(qkv, h)
            scale = d ** -0.5
            o, lse = fa.fwd_packed_cuda(*args, h, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
            do = (o.float() - o_ref.float()).abs()
            atol, rtol = TOL_O[str(dtype).split(".")[1]]
            excess = (do - rtol * o_ref.float().abs()).max().item()
            dlse = (lse - lse_ref).abs().max().item()
            clamped = "" if qmul == 1.0 else " large-logit"
            print(f"B1 B={b} n={n} H={h} D={d} {str(dtype)[6:]}{clamped} "
                  f"cls={args[3] is not None}: max|do|={do.max().item():.3e} "
                  f"(tol {atol:.1e}+{rtol:.1e}|o|) max|dlse|={dlse:.3e} "
                  f"(tol {TOL_LSE:.0e})")
            if not (excess <= atol and dlse <= TOL_LSE
                    and torch.isfinite(o.float()).all()):
                raise AssertionError(f"B1 disagrees with its plain version "
                                     f"at B={b} n={n} H={h} D={d} {dtype}")
            if (b, n, h, d, qmul, dtype) == (1, 4097, 16, 64, 1.0,
                                             torch.bfloat16):
                vitl_err = do.max().item()
    return vitl_err


def check_hopper_fwd(torch, fa):
    """Phase 3, the bf16 Hopper forward body (B1 on the packed route, B3 /
    B5 on the [B, H, N, D] views) at each D it serves against its plain
    version: 1,000 query rows and keys (no multiple of the 128-row and
    128-key tiles) without the cls fold, 1,000 + cls with it, q x 40 with
    it (most logits above the clamp), and B5's rect form (333 query rows,
    700 keys, kv_valid 651, NaN in k and v past it).  Each call is made
    twice: o and lse must be bit-identical (the forward has no atomics)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    dtype = torch.bfloat16
    atol, rtol = TOL_O["bfloat16"]
    for d in (16, 32, 64, 80, 128):
        h, scale = 4, d ** -0.5
        for case in ("ragged", "cls", "large-logit cls", "rect"):
            routes = ["bh"] + (["packed"] if d in fa.HEAD_DIMS
                               and case != "rect" else [])
            for route in routes:
                kv = None
                if case == "rect":
                    q = torch.randn((2, h, 333, d), generator=gen,
                                    device="cuda").to(dtype)
                    k, v = (torch.randn((2, h, 700, d), generator=gen,
                                        device="cuda").to(dtype)
                            for _ in range(2))
                    kv = 651
                    k[:, :, kv:], v[:, :, kv:] = math.nan, math.nan
                    args = (q, k, v, None, None)
                else:
                    cls = case != "ragged"
                    qkv = torch.randn((2, 1000 + cls, 3 * h * d),
                                      generator=gen, device="cuda")
                    if case.startswith("large"):
                        qkv[..., :h * d] *= 40.0
                    qkv = qkv.to(dtype)
                    args = (fa._split_qkv(qkv, cls) if route == "packed"
                            else _bh_args(qkv, h, cls))
                if route == "packed":
                    def call():
                        return fa.fwd_packed_cuda(*args, h, scale)
                    o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
                else:
                    def call():
                        return fa.fwd_bh_cuda(*args, scale, kv)
                    o_ref, lse_ref = fa.fwd_bh_plain(*args, scale, kv)
                (o, lse), (o2, lse2) = call(), call()
                torch.cuda.synchronize()
                d_o = (o.float() - o_ref.float()).abs()
                excess = (d_o - rtol * o_ref.float().abs()).max().item()
                dlse = (lse - lse_ref).abs().max().item()
                same = torch.equal(o, o2) and torch.equal(lse, lse2)
                print(f"Hopper forward {route} D={d} {case}: max|do|="
                      f"{d_o.max().item():.3e} (tol {atol:.1e}+{rtol:.1e}|o|) "
                      f"max|dlse|={dlse:.3e} (tol {TOL_LSE:.0e}); two runs "
                      f"bit-identical: {same}")
                if not (excess <= atol and dlse <= TOL_LSE and same
                        and torch.isfinite(o.float()).all()):
                    raise AssertionError(f"the Hopper forward disagrees with "
                                         f"its plain version or with itself: "
                                         f"{route} D={d} {case}")
                del args, o, lse, o2, lse2, o_ref, lse_ref


def _grads_twice(torch, what, call, ref, dtype):
    """A backward ``call`` made twice on the same inputs against its plain
    version ``ref`` (dq, dk, dv, dkc, dvc): each output of each run within
    TOL_GRAD x max|plain| and finite; dk, dv, dkc, dvc bit-identical
    between the runs.  Prints the largest run-to-run |d dq|.  Returns
    ({output: max |d|}, the outputs) of the first run."""
    first = call()
    second = call()
    torch.cuda.synchronize()
    tol = TOL_GRAD[str(dtype).split(".")[1]]
    errs, ok = {}, True
    for name, a, b, r in zip(("dq", "dk", "dv", "dkc", "dvc"), first, second,
                             ref):
        if r is None:
            ok &= a is None and b is None
            continue
        top = r.float().abs().max().item()
        errs[name] = (a.float() - r.float()).abs().max().item()
        for got in (a, b):
            ok &= ((got.float() - r.float()).abs().max().item() <= tol * top
                   and bool(torch.isfinite(got.float()).all()))
        if name != "dq":
            ok &= torch.equal(a, b)
    rerun = (first[0].float() - second[0].float()).abs().max().item()
    print(f"{what}: max|d| " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" (tol {tol:.1e} x max|plain|); run to run max|d dq|="
          f"{rerun:.3e}, dk dv dkc dvc identical")
    if not ok:
        raise AssertionError(f"{what}: the backward disagrees with its plain "
                             "version, or dk / dv / dkc / dvc moved between "
                             "two runs")
    return errs, first


def check_flash_bwd(torch, fa):
    """Phase 3, B2: against its plain version at B=1 on B1's own (o, lse),
    with a random dO and g_lse: at the serving shape (Grad-CAM's backward),
    and at the joint step's and the 2D MAE's shapes at B=16.  (Phase 8
    holds it at B=4, as the training step lays it out.)"""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(1, 4097, 16, 64, 1.0),  # the serving classifier's: Grad-CAM
             (1, 5121, 16, 32, 1.0), (1, 5121, 4, 128, 1.0),  # the decoder's
             (1, 512, 16, 64, 1.0),  # the encoder's: 511 + cls, no fold
             (1, 4000, 16, 64, 1.0), (1, 1025, 8, 128, 1.0),
             (1, 513, 4, 256, 1.0),
             (1, 1025, 8, 128, 40.0),  # q scaled: most logits above the clamp
             # ragged: rows and keys not multiples of the one pass's tiles
             (1, 700, 8, 32, 1.0), (1, 333, 4, 64, 1.0), (1, 901, 2, 128, 1.0),
             *JOINT_2D_CASES, *MAE2D_CASES, *FT_2D_CASES, *HIPT_PAIR_CASES]
    for b, n, h, d, qmul in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda")
            qkv[..., :h * d] *= qmul
            qkv = qkv.to(dtype)
            args = _kernel_args(qkv, h)
            scale = d ** -0.5
            o, lse = fa.fwd_packed_cuda(*args, h, scale)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
            g_lse = 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
            ref = fa.bwd_packed_plain(*args, o, lse, do, g_lse, h, scale)
            clamped = "" if qmul == 1.0 else " large-logit"
            _grads_twice(torch, f"B2 B={b} n={n} H={h} D={d} "
                         f"{str(dtype)[6:]}{clamped} cls={args[3] is not None}",
                         lambda: fa.bwd_packed_cuda(*args, o, lse, do, g_lse,
                                                    h, scale), ref, dtype)
            del qkv, o, lse, do, ref


def check_head_by_head(torch, fa):
    """Phase 3, B1 and B2 at the variable_joint high-res stream's
    (1, 16,385, 16, 64) with the cls fold, bf16 and fp32, against their
    plain versions head by head: the plain versions materialize the
    [n, n] scores (16 x 16,385^2 x 4 B = 17.2 GB a tensor over all heads),
    so each head's columns of the fused buffer go through them at H = 1
    and are held against that head's columns of the kernels' outputs (B1's
    o and lse, B2's dq, dk, dv, dkc, dvc from two runs), at phase 3's
    limits over each whole output (TOL_O, TOL_LSE; TOL_GRAD x max|plain|;
    dk, dv, dkc, dvc bit-identical between the runs)."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    b, n, h, d = HIGH_RES_CASE
    scale = d ** -0.5
    names = ("dq", "dk", "dv", "dkc", "dvc")
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[1]
        qkv = torch.randn((b, n, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        args = _kernel_args(qkv, h)
        o, lse = fa.fwd_packed_cuda(*args, h, scale)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
        g_lse = 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
        runs = [fa.bwd_packed_cuda(*args, o, lse, do, g_lse, h, scale)
                for _ in range(2)]
        torch.cuda.synchronize()
        atol, rtol = TOL_O[key]
        excess = dlse = 0.0
        top = dict.fromkeys(names, 0.0)
        err = {k: [0.0, 0.0] for k in names}
        finite = bool(torch.isfinite(o.float()).all())
        for j in range(h):
            sl = slice(j * d, (j + 1) * d)
            hargs = tuple(None if t is None else t[..., sl] for t in args)
            o_ref, lse_ref = fa.fwd_packed_plain(*hargs, 1, scale)
            d_o = (o[..., sl].float() - o_ref.float()).abs()
            excess = max(excess, (d_o - rtol * o_ref.float().abs()).max()
                         .item())
            dlse = max(dlse, (lse[:, j:j + 1] - lse_ref).abs().max().item())
            ref = fa.bwd_packed_plain(*hargs, o[..., sl], lse[:, j:j + 1],
                                      do[..., sl], g_lse[:, j:j + 1], 1,
                                      scale)
            for name, r, g0, g1 in zip(names, ref, *runs):
                top[name] = max(top[name], r.float().abs().max().item())
                for i, g in enumerate((g0, g1)):
                    err[name][i] = max(err[name][i], (
                        g[..., sl].float() - r.float()).abs().max().item())
            del o_ref, lse_ref, d_o, ref
            torch.cuda.empty_cache()
        finite &= all(bool(torch.isfinite(g.float()).all())
                      for r in runs for g in r)
        same = all(torch.equal(runs[0][i], runs[1][i]) for i in range(1, 5))
        tol = TOL_GRAD[key]
        grads_ok = all(max(err[k]) <= tol * top[k] for k in names)
        print(f"B1 / B2 head by head B={b} n={n} H={h} D={d} {key} cls=True: "
              f"max|do|-{rtol:.1e}|o| = {excess:.3e} (tol {atol:.1e}) "
              f"max|dlse|={dlse:.3e} (tol {TOL_LSE:.0e}); B2 max|d| "
              + " ".join(f"{k}={max(err[k]):.3e}/{top[k]:.3e}" for k in names)
              + f" (tol {tol:.1e} x max|plain|); dk dv dkc dvc identical "
              f"between runs {same}")
        if not (excess <= atol and dlse <= TOL_LSE and grads_ok and same
                and finite):
            raise AssertionError(f"B1 / B2 disagree with their plain versions "
                                 f"head by head at n={n} {key}")
        del qkv, args, o, lse, do, g_lse, runs
        torch.cuda.empty_cache()


# (B, n, H, D) of the COEM towers (phase 20): the OCT tower at 60x256x256
# (5,120 tubes + cls, folded) and the en face tower at 384^2 (576 + cls,
# not folded) at phase 20's chunk of 8, and the OCT tower at the octcube_ir
# preset's chunk of 32 (the forward alone: its pass 1)
COEM_CASES = [(8, 5121, 16, 64), (8, 577, 16, 64)]
COEM_FWD_CASE = (32, 5121, 16, 64)


def check_coem_shapes(torch, fa):
    """Phase 3, B1 and B2 at the COEM towers' shapes, bf16 and fp32,
    against their plain versions sample by sample (the plain scores of all
    8 samples would take 13.4 GB a tensor at 5,121 tokens): each sample's
    rows of the fused buffer go through them at B = 1 and are held
    against that sample's rows of the kernels' outputs (B1's o and lse,
    B2's dq, dk, dv, dkc, dvc from two runs) at phase 3's limits over each
    whole output; then B1 alone at the preset's chunk of 32 x 5,121."""
    gen = torch.Generator(device="cuda").manual_seed(38)
    names = ("dq", "dk", "dv", "dkc", "dvc")
    for (b, n, h, d), bwd in [(c, True) for c in COEM_CASES] + [
            (COEM_FWD_CASE, False)]:
        scale = d ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[1]
            qkv = torch.randn((b, n, 3 * h * d), generator=gen,
                              device="cuda").to(dtype)
            args = _kernel_args(qkv, h)
            o, lse = fa.fwd_packed_cuda(*args, h, scale)
            runs = []
            if bwd:
                do = torch.randn(o.shape, generator=gen,
                                 device="cuda").to(dtype)
                g_lse = 0.1 * torch.randn(lse.shape, generator=gen,
                                          device="cuda")
                runs = [fa.bwd_packed_cuda(*args, o, lse, do, g_lse, h, scale)
                        for _ in range(2)]
            torch.cuda.synchronize()
            atol, rtol = TOL_O[key]
            excess = dlse = 0.0
            top = dict.fromkeys(names, 0.0)
            err = {k: [0.0, 0.0] for k in names}
            finite = bool(torch.isfinite(o.float()).all())
            for i in range(b):
                one = tuple(None if t is None else t[i:i + 1] for t in args)
                o_ref, lse_ref = fa.fwd_packed_plain(*one, h, scale)
                d_o = (o[i:i + 1].float() - o_ref.float()).abs()
                excess = max(excess, (d_o - rtol * o_ref.float().abs()).max()
                             .item())
                dlse = max(dlse, (lse[i:i + 1] - lse_ref).abs().max().item())
                if bwd:
                    ref = fa.bwd_packed_plain(*one, o[i:i + 1], lse[i:i + 1],
                                              do[i:i + 1], g_lse[i:i + 1], h,
                                              scale)
                    for name, r, g0, g1 in zip(names, ref, *runs):
                        if r is None:
                            continue
                        top[name] = max(top[name],
                                        r.float().abs().max().item())
                        for j, g in enumerate((g0, g1)):
                            err[name][j] = max(err[name][j], (
                                g[i:i + 1].float() - r.float()).abs().max()
                                .item())
                    del ref
                del o_ref, lse_ref, d_o
            torch.cuda.empty_cache()
            cls = args[3] is not None
            line = (f"B1{' / B2' if bwd else ''} sample by sample B={b} "
                    f"n={n} H={h} D={d} {key} cls={cls}: max|do|-"
                    f"{rtol:.1e}|o| = {excess:.3e} (tol {atol:.1e}) "
                    f"max|dlse|={dlse:.3e} (tol {TOL_LSE:.0e})")
            ok = excess <= atol and dlse <= TOL_LSE and finite
            if bwd:
                finite = all(bool(torch.isfinite(g.float()).all())
                             for r in runs for g in r if g is not None)
                same = all(torch.equal(runs[0][i], runs[1][i])
                           for i in range(1, 5) if runs[0][i] is not None)
                tol = TOL_GRAD[key]
                live = [k for k in names if top[k] > 0]
                grads_ok = all(max(err[k]) <= tol * top[k] for k in live)
                line += ("; B2 max|d| " + " ".join(
                    f"{k}={max(err[k]):.3e}/{top[k]:.3e}" for k in live)
                         + f" (tol {tol:.1e} x max|plain|); dk dv dkc dvc "
                         f"identical between runs {same}")
                ok = ok and grads_ok and same and finite
            print(line)
            if not ok:
                raise AssertionError(f"B1 / B2 disagree with their plain "
                                     f"versions at the COEM shape B={b} "
                                     f"n={n} {key}")
            del qkv, args, o, lse, runs
            if bwd:
                del do, g_lse
            torch.cuda.empty_cache()


def _nonzero(launches):
    return {k: c for k, c in launches.items() if c}


def run_main_path(torch, _cuda, entry_mod, name="ViT-L 48x256x256",
                  counter="flash_fwd_packed", **entry_kw):
    """Phases 4 and 6: entry()'s forward through the kernels: one launch
    of ``counter`` per block and no other kernel."""
    fn, (model, x) = entry_mod.entry(**entry_kw)
    _cuda.reset_launches()
    logits = fn(model, x)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    print(f"entry forward {name}: logits {list(logits.shape)} {logits.dtype}, "
          f"launches {_nonzero(launches)}")
    if tuple(logits.shape) != (1, 16) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {logits}")
    depth = len(model.blocks)
    if _nonzero(launches) != {counter: depth}:
        raise AssertionError(f"expected {depth} {counter} launches and no "
                             f"other kernel, got {launches}")

    mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
    for m in mhas:
        m.attn_impl = "naive"
    ref = fn(model, x)
    for m in mhas:
        m.attn_impl = "auto"
    err = (logits.float() - ref.float()).abs().max().item()
    print(f"entry forward {name} vs impl='naive': max|dlogits|={err:.3e} "
          f"(tol {TOL_LOGITS:.0e}; max|logits|="
          f"{ref.float().abs().max().item():.3e})")
    if err > TOL_LOGITS:
        raise AssertionError(f"flash and naive {name} forwards disagree")
    return fn, model, x, depth


def _post_npy(url, arr):
    buf = io.BytesIO()
    import numpy as np
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read().decode())


@contextlib.contextmanager
def _serving(serve, argv):
    """cli/serve.py's server in a thread -> its base URL; shut down after."""
    started, box, errors = threading.Event(), [], []

    def run():
        try:
            serve.main(argv, started, box)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            started.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    if not started.wait(timeout=600):
        raise AssertionError("server did not start")
    if errors:
        raise errors[0]
    httpd = box[0]
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        th.join(timeout=60)


def _disease_probs(logits):
    """[1, 16] logits -> [1, 8] probabilities, as the server computes
    them."""
    import numpy as np

    lg = logits.float().cpu().numpy().reshape(1, -1, 2)
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[:, :, 1]


def run_serve(torch, _cuda, serve):
    """Phase 5: the server answers healthz and four predicts."""
    import numpy as np

    _cuda.reset_launches()
    with _serving(serve, ["--port", "0", "--seed", "0"]) as base:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read().decode())
        print(f"serve /healthz: {r.status} {health}")
        rng = np.random.default_rng(0)
        vols = [("?raw=0", rng.random((48, 256, 256), dtype=np.float32))
                for _ in range(3)]
        vols.append(("", (rng.random((40, 200, 300)) * 255).astype(np.float32)))
        for query, vol in vols:
            code, out = _post_npy(base + "/predict" + query, vol)
            probs = np.asarray(out.get("probs", [[np.nan]]), np.float64)
            print(f"serve /predict{query} {list(vol.shape)}: {code} "
                  f"probs {probs.shape} latency_ms {out.get('latency_ms')}")
            if code != 200 or probs.shape != (1, 8) or not np.isfinite(probs).all():
                raise AssertionError(f"bad predict answer {code} {out}")
    launches = dict(_cuda.launches)
    print(f"serve launches (warm-up + 4 predicts): {launches}")
    if launches["flash_fwd_packed"] != 24 * 5:
        raise AssertionError(f"expected {24 * 5} B1 launches, got {launches}")


def time_flash_fwd(torch, fa, rate):
    """Phase 9: B1 at the ViT-L shape: kernel, plain version, the library
    yardstick and the bound (``rate``: the card's exps per second)."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    b, n, h, d = 1, 4097, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    args = _kernel_args(qkv, h)
    scale = d ** -0.5
    ms = _elapsed_ms(lambda: fa.fwd_packed_cuda(*args, h, scale), 50)
    plain_ms = _elapsed_ms(lambda: fa.fwd_packed_plain(*args, h, scale), 5, 1)
    qh, kh, vh = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    library_ms = _elapsed_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 50)
    m = n - 1  # query rows of the kernel; keys are m plus the cls
    flops, nbytes, exps = fwd_work(b, h, m, n, d)
    bound_ms, bound_by = bound(flops, nbytes, exps, rate)
    print(f"B1 timing at B={b} H={h} N={n} D={d} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
          f"{nbytes:.3e} B, {exps:.3e} exp at {rate:.3e}/s); "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def mae_train_flops(d=1024, layers=24, dd=512, dlayers=8, frames=60,
                    img=256, patch=16, tpatch=3, mask=0.90) -> float:
    """Analytic FLOPs of one ViT-L 3D MAE train step per volume (fwd + bwd
    = 3 x fwd): the port's copy of bench.py's mae_train_flops, which this
    script may not import (bench.py imports JAX)."""
    l_full = (frames // tpatch) * (img // patch) ** 2     # 5120
    l_vis = int(l_full * (1 - mask)) + 1                  # 511 + cls
    l_dec = l_full + 1
    dense = (layers * 2 * l_vis * 12 * d * d + dlayers * 2 * l_dec * 12 * dd * dd
             + 2 * l_full * (tpatch * patch * patch) * d
             + 2 * l_dec * dd * (tpatch * patch * patch)
             + 2 * l_dec * d * dd)
    attn = layers * 4 * l_vis * l_vis * d + dlayers * 4 * l_dec * l_dec * dd
    return 3.0 * (dense + attn)


def run_train(torch, _cuda, entry_mod, optim, name, geometries, expect,
              flops_kw, **entry_kw):
    """Phase 7: three MAE steps per decoder geometry, with their launch
    counts (``expect``, and no other kernel), the LR-0 first update and
    peak memory; then the step's time.  Returns the last step's
    launches."""
    last = None
    for dec_heads in geometries:
        torch.cuda.reset_peak_memory_stats()
        step, state, x = entry_mod.train_entry(dec_heads=dec_heads, batch=4,
                                               **entry_kw)
        model, tx = state.params, state.tx
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().clone() for p in model.parameters()]
        if tx.lr(0) != 0.0:
            raise AssertionError(f"the schedule's first LR is {tx.lr(0)}")
        for i in range(3):
            _cuda.reset_launches()
            state, m = step(state, x, mask_ratio=0.9)
            torch.cuda.synchronize()
            last = dict(_cuda.launches)
            loss, gn = m["loss"].item(), m["grad_norm"].item()
            print(f"train {name} dec_heads={dec_heads} step {i + 1}: loss "
                  f"{loss:.6f} grad_norm {gn:.6f} lr {tx.lr(i):.4e} launches "
                  f"{_nonzero(last)}")
            if not (math.isfinite(loss) and math.isfinite(gn)):
                raise AssertionError("non-finite loss or grad norm")
            if _nonzero(last) != expect:
                raise AssertionError(f"expected launches {expect} per step "
                                     f"and no other kernel, got {last}")
            if i == 0 and not all(torch.equal(a, p) for a, p in
                                  zip(before, model.parameters())):
                raise AssertionError("params moved at the first update, "
                                     "whose LR is 0")
        decayed = optim.weight_decay_mask(model)
        # the only params allowed to stay put: no gradient, no decay
        free = {n for n, p in model.named_parameters()
                if p.grad is None and not decayed[n]}
        still = {n for n, a, p in zip(names, before, model.parameters())
                 if torch.equal(a, p)}
        print(f"train {name} dec_heads={dec_heads}: {len(names) - len(still)} "
              f"of {len(names)} params moved by steps 2-3; unmoved "
              f"{sorted(still)}")
        if still - free:
            raise AssertionError(f"params did not move: {sorted(still - free)}")
        del before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = _elapsed_ms(lambda: step(state, x, mask_ratio=0.9), 5, 1)
        flops = mae_train_flops(**flops_kw) * x.shape[0]
        bound = flops / PEAK_BF16_FLOPS * 1e3
        print(f"train step {name} dec_heads={dec_heads} (mask 0.90, batch "
              f"{x.shape[0]}, bf16): {ms:.3f} ms per step (parent "
              f"{PARENT_STEP_MS[(name, dec_heads)]:.3f}), "
              f"{x.shape[0] / ms * 1e3:.3f} vol/s; bound {bound:.3f} ms "
              f"({flops:.3e} FLOP at {PEAK_BF16_FLOPS:.3e} FLOP/s); "
              f"max_memory_allocated {peak:.2f} GiB")
        del step, state, x, model, tx
        torch.cuda.empty_cache()
    return last


# flash (B1 + B2) against impl="naive" under autograd, the MAE cut to 2 + 2
# blocks: |dloss| / |loss| and max over leaves of max|dgrad| / max|grad|.
# Measured on an H100 at 700 W with these seeds at batch 1: fp32 0 and
# 1.27e-6 (limits: ~8 fp32 ulps for the loss, 2.5x for the gradients);
# bf16 5.1e-6 and 9.0e-3 (limits ~2.5x).  At batch 2, as run here: fp32
# 0 and 1.70e-6, bf16 4.7e-6 and 7.2e-3, all inside the same limits.
TOL_NAIVE = {"float32": (1e-6, 3e-6), "bfloat16": (1.3e-5, 2.2e-2)}
# the 2D MAE (ViT-L/16 at 224) cut to 2 + 2 blocks at batch 2 (50 / 197
# tokens), the same comparison: measured on an H100 at 700 W, fp32 0 and
# 5.1e-7, bf16 1.62e-5 and 7.2e-3.  Its loss is the mean squared error of
# a bf16 prediction over 147 masked patches a sample, so it moves with
# each pred element one bf16 step apart; the limits are ~2.5x, the
# gradients' the 3D MAE's.
TOL_NAIVE_2D = {"float32": (1e-6, 3e-6), "bfloat16": (4e-5, 2.2e-2)}
# the ViT-H/14 classifier cut to 2 blocks (4,097 tokens), flash (B3 + B4)
# against impl="naive" under a cross-entropy.  Its loss is taken from the
# model's bf16 logits, so flash and naive logits one bf16 step apart move
# it by ~1e-4 relative: measured on an H100 at 700 W, fp32 9.0e-8 and
# 1.77e-6, bf16 6.9e-5 and 9.9e-3; the bf16 loss limit is ~2.5x.
TOL_NAIVE_CLS = {"float32": (1e-6, 3e-6), "bfloat16": (2e-4, 2.2e-2)}


def check_flash_vs_naive(torch, entry_mod, name, **entry_kw):
    """Phase 8: the same weights, input and noise through the flash path
    and impl="naive", fp32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = torch.rand((2, 5120), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        _, state, x = entry_mod.train_entry(batch=2, depth=2, decoder_depth=2,
                                            dtype=dtype, **entry_kw)
        model = state.params
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = model(x, 0.9, noise)[0]
            loss.backward()
            res[impl] = (loss.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()
                                       if p.grad is not None})
        _compare_to_naive(f"MAE {name} {str(dtype)[6:]} (2+2 blocks, 512 / "
                          f"5,121 tokens)", res, dtype)
        del state, x, model, res
        torch.cuda.empty_cache()


def _compare_to_naive(what, res, dtype, tols=TOL_NAIVE,
                      label="flash vs naive"):
    """res: {impl: (loss, {leaf: grad})} -> holds flash ("auto") to naive
    within ``tols``: |dloss| / |loss| and, over leaves, max|dgrad| /
    max|grad|."""
    (lf, gf), (ln, gn) = res["auto"], res["naive"]
    dloss = abs(lf - ln) / abs(ln)
    worst, leaf = max(((gf[n] - gn[n]).abs().max().item()
                       / gn[n].abs().max().item(), n) for n in gn)
    tl, tg = tols[str(dtype).split(".")[1]]
    print(f"{label} {what}: loss {lf:.6f} vs {ln:.6f}, rel "
          f"{dloss:.3e} (tol {tl:.0e}); worst leaf {leaf} rel {worst:.3e} "
          f"(tol {tg:.0e})")
    if not (dloss <= tl and worst <= tg and set(gf) == set(gn)):
        raise AssertionError(f"flash and naive disagree: {what}")


def _check_main_path_shape(torch, fa, name, args, o, lse, do, out, h,
                           scale):
    """B1 and B2 at a main-path shape (B=4, bf16), laid out as the training
    step lays them out, against their plain versions: q, k, v, kc, vc are
    column views of the fused buffer, dO is autograd's [:, 1:] slice after
    the cls concat, and B2 writes into the column views of one dqkv
    buffer.  Returns the max |d| over B2's outputs."""
    o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
    do_o = (o.float() - o_ref.float()).abs()
    atol, rtol = TOL_O["bfloat16"]
    excess = (do_o - rtol * o_ref.float().abs()).max().item()
    dlse = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    print(f"B1 {name} B={o.shape[0]} bf16 as on the main path: max|do|="
          f"{do_o.max().item():.3e} max|dlse|={dlse:.3e}")
    if not (excess <= atol and dlse <= TOL_LSE):
        raise AssertionError(f"B1 disagrees with its plain version at the "
                             f"{name} shape, B={o.shape[0]}")
    ref = fa.bwd_packed_plain(*args, o, lse, do, None, h, scale)
    # each run writes the dqkv views whole; keep the first run's apart
    errs, _ = _grads_twice(
        torch, f"B2 {name} B={o.shape[0]} bf16 as on the main path",
        lambda: tuple(None if t is None else t.clone() for t in
                      fa.bwd_packed_cuda(*args, o, lse, do, None, h, scale,
                                         out=out)), ref, torch.bfloat16)
    return max(errs.values())


def time_flash_bwd(torch, fa, rate):
    """Phase 9, B2 at the encoder's and both decoder geometries' shapes
    (B=4): first held against its plain version as the step lays it out
    (with B1), then timed: kernel, plain version, the library yardstick
    (SDPA forward + backward minus its forward, at the same [B, H, N, D])
    and the bound.  Also B1's time at the decoder shape, against its bound
    with the exps at ``rate``.  Returns the reference decoder's row."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, (b, n, h, d) in (("decoder h16", (4, 5121, 16, 32)),
                               ("decoder h4", (4, 5121, 4, 128)),
                               ("encoder", (4, 512, 16, 64))):
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        args = _kernel_args(qkv, h)
        cls = args[3] is not None
        scale = d ** -0.5
        o, lse = fa.fwd_packed_cuda(*args, h, scale)
        # autograd's dO: the gradient of the [B, n, H*D] attention output,
        # rows 1: when the cls query row was concatenated in front
        do = torch.randn((b, n, h * d), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        do = do[:, 1:] if cls else do
        dqkv = torch.zeros_like(qkv)
        out = _kernel_args(dqkv, h)
        err = _check_main_path_shape(torch, fa, name, args, o, lse, do, out,
                                     h, scale)
        ms = _elapsed_ms(lambda: fa.bwd_packed_cuda(*args, o, lse, do, None,
                                                    h, scale, out=out), 20)
        fwd_ms = _elapsed_ms(lambda: fa.fwd_packed_cuda(*args, h, scale), 20)
        plain_ms = _elapsed_ms(lambda: fa.bwd_packed_plain(
            *args, o, lse, do, None, h, scale), 3, 1)
        qh, kh, vh = (t.contiguous().requires_grad_() for t in
                      qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
        g = torch.randn((b, h, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        sdpa_fwd = _elapsed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 20)
        sdpa_all = _elapsed_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            (qh, kh, vh), g), 20)
        m = n - 1 if cls else n
        keys = m + 1 if cls else m
        es = qkv.element_size()
        flops = 10 * b * h * m * keys * d
        nbytes = (8 * b * m * h * d * es + b * h * m * 4
                  + (4 * b * h * d * es if cls else 0))
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
               "library_ms": sdpa_all - sdpa_fwd,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        fwd_bound, fwd_by = bound(*fwd_work(b, h, m, keys, d), rate)
        print(f"B2 timing {name} B={b} H={h} N={n} D={d} bf16: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa bwd "
              f"{row['library_ms']:.4f} ms (fwd+bwd {sdpa_all:.4f} - fwd "
              f"{sdpa_fwd:.4f}), bound {row['bound_ms']:.4f} ms ({flops:.3e} "
              f"FLOP -> {t_ops:.4f} ms; {nbytes:.3e} B -> {t_bytes:.4f} ms); "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved; B1 at this shape "
              f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f} ms by {fwd_by})")
        rows[name] = row
        del qkv, args, o, lse, do, dqkv, out, qh, kh, vh, g
        torch.cuda.empty_cache()
    return rows["decoder h16"]


# ------------------------------------------------ [B, H, N, D]: B3-B5, B7

def _bh_views(qkv, h):
    """q, k, v [B, H, N, D] views of a fused [B, N, 3*H*D] buffer (batch
    stride N*3*H*D, head stride D, row stride 3*H*D), as the packed path
    hands them to flash_attention."""
    b, n, hd3 = qkv.shape
    d = hd3 // (3 * h)
    return [t.transpose(1, 2) for t in qkv.view(b, n, 3, h, d).unbind(2)]


def _bh_args(qkv, h, cls):
    """B3's (cls) or B5's inputs: tokens 1: with row 0 as the cls
    key/value, or all rows."""
    q, k, v = _bh_views(qkv, h)
    if cls:
        return (q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1],
                v[:, :, :1])
    return q, k, v, None, None


def _bh_do(torch, gen, b, n, h, d, dtype, cls):
    """autograd's dO for the kernel's rows: the [B, H, N, D] view of a
    [B, N, H, D] gradient (the packed output's), rows 1: after the cls
    query row's concat."""
    do = torch.randn((b, n, h, d), generator=gen, device="cuda",
                     dtype=dtype).transpose(1, 2)
    return do[:, :, 1:] if cls else do


def _hold_bh(torch, fa, what, args, dtype, gen, kv_valid=None, no_max=True):
    """B3 / B5 and B4 / B7 against their plain versions on the same
    inputs: the forward (no_max only) and the backward on the plain
    forward's (o, lse) -- or, for no_max=False, the exact softmax's --
    with autograd's strided dO and a nonzero g_lse.  Returns (max |do|,
    max |d| over the gradients)."""
    q, k, v = args[:3]
    b, h, nq, d = q.shape
    scale = d ** -0.5
    fwd_err = None
    if no_max:
        o, lse = fa.fwd_bh_cuda(*args, scale, kv_valid)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.fwd_bh_plain(*args, scale, kv_valid)
        d_o = (o.float() - o_ref.float()).abs()
        atol, rtol = TOL_O[str(dtype).split(".")[1]]
        excess = (d_o - rtol * o_ref.float().abs()).max().item()
        dlse = (lse - lse_ref).abs().max().item()
        fwd_err = d_o.max().item()
        if not (excess <= atol and dlse <= TOL_LSE
                and torch.isfinite(o.float()).all()):
            raise AssertionError(f"{what}: the forward disagrees with its "
                                 f"plain version (max|do| {fwd_err:.3e}, "
                                 f"max|dlse| {dlse:.3e})")
        del o, lse, d_o
    else:
        kk = k[:, :, :kv_valid] if kv_valid else k
        vv = v[:, :, :kv_valid] if kv_valid else v
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
        lse_ref = torch.logsumexp(s, dim=-1)
        o_ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                             vv.float()).to(dtype)
        del s
    cls = args[3] is not None
    do = _bh_do(torch, gen, b, nq + cls, h, d, dtype, cls)
    g_lse = 0.1 * torch.randn(lse_ref.shape, generator=gen, device="cuda")
    ref = fa.bwd_bh_plain(*args, o_ref, lse_ref, do, g_lse, scale, no_max,
                          kv_valid)
    errs, got = _grads_twice(
        torch, f"{what} {str(dtype)[6:]}"
        + (f" (fwd max|do|={fwd_err:.3e})" if no_max else ""),
        lambda: fa.bwd_bh_cuda(*args, o_ref, lse_ref, do, g_lse, scale,
                               no_max, kv_valid), ref, dtype)
    if kv_valid is not None and not bool(
            (got[1][:, :, kv_valid:] == 0).all()
            and (got[2][:, :, kv_valid:] == 0).all()):
        raise AssertionError(f"{what}: dk / dv not 0 past kv_valid")
    return fwd_err, max(errs.values())


# (name, B, N, H, D, q scale) of phase 21's default HIPT ViT-4K (depth 12,
# 12 heads of 16) at batch 64: a 16 x 16 map + cls (folded) and a 14 x 14
# map + cls (not folded)
HIPT_BH_CASES = [("HIPT 16x16", 64, 257, 12, 16, 1.0),
                 ("HIPT 14x14", 64, 197, 12, 16, 1.0)]


def check_bh_kernels(torch, fa):
    """Phase 3, B3-B5 and B7 against their plain versions, bf16 and fp32,
    on the fused buffer's [B, H, N, D] views: the ViT-H/14 classifier
    (B3 / B4) and MAE encoder (B5 / B7) shapes, other head dims, the
    large-logit case, the rectangular kv_valid form (a 4-way query shard
    of the decoder's 5,121 tokens padded to 5,124, and at head_dim 16)
    and B7's exact-softmax branch; the default HIPT ViT-4K's shapes at
    head_dim 16.  Returns {kernel: max |d|} at the path shapes in bf16
    (the ViT-H paths', and "B3 D=16" etc. at the HIPT's)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {}
    # (name, B, N, H, D, q multiplier)
    cases = [("ViT-H classifier", 1, 4097, 16, 80, 1.0),
             ("ViT-H encoder", 4, 512, 16, 80, 1.0),
             ("D=64", 2, 1025, 8, 64, 1.0), ("D=128", 2, 700, 4, 128, 1.0),
             ("D=32", 2, 513, 8, 32, 1.0), ("D=256", 1, 300, 2, 256, 1.0),
             ("large-logit D=80", 2, 1025, 4, 80, 40.0),
             # ragged: rows and keys not multiples of the one pass's tiles
             ("ragged D=80", 2, 333, 4, 80, 1.0),
             ("ragged D=32", 2, 700, 4, 32, 1.0),
             # phase 21's default HIPT ViT-4K (12 heads of 16, batch 64):
             # 257 tokens (B3 / B4 on 256 + the cls fold) and 197 (B5 / B7)
             *HIPT_BH_CASES, ("large-logit D=16", 2, 1025, 4, 16, 40.0),
             ("ragged D=16", 2, 333, 4, 16, 1.0)]
    for name, b, n, h, d, qmul in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda")
            qkv[..., :h * d] *= qmul
            qkv = qkv.to(dtype)
            for cls in (False, True):
                kernels = ("B3 + B4" if cls else "B5 + B7")
                fe, be = _hold_bh(torch, fa, f"{kernels} {name} B={b} N={n} "
                                  f"H={h} D={d}", _bh_args(qkv, h, cls),
                                  dtype, gen)
                on_path = (cls, name) in ((True, "ViT-H classifier"),
                                          (False, "ViT-H encoder"))
                if on_path and dtype == torch.bfloat16:
                    errs["B3" if cls else "B5"] = fe
                    errs["B4" if cls else "B7"] = be
                hipt = (cls, name) in ((True, "HIPT 16x16"),
                                       (False, "HIPT 14x14"))
                if hipt and dtype == torch.bfloat16:
                    errs["B3 D=16" if cls else "B5 D=16"] = fe
                    errs["B4 D=16" if cls else "B7 D=16"] = be
            del qkv
            torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        # rect: the decoder's 5,121 tokens padded to 5,124, a 4-way shard
        h, d = 16, 32
        q = torch.randn((1, h, 1281, d), generator=gen, device="cuda")
        k, v = (torch.randn((1, h, 5124, d), generator=gen, device="cuda")
                for _ in range(2))
        _hold_bh(torch, fa, "B5 + B7 rect Nq=1281 Nk=5124 kv_valid=5121 "
                 "H=16 D=32", (q.to(dtype), k.to(dtype), v.to(dtype), None,
                               None), dtype, gen, kv_valid=5121)
        # rect at the HIPT head_dim: 197 query rows against 260 keys
        q = torch.randn((64, 12, 197, 16), generator=gen, device="cuda")
        k, v = (torch.randn((64, 12, 260, 16), generator=gen, device="cuda")
                for _ in range(2))
        _hold_bh(torch, fa, "B5 + B7 rect Nq=197 Nk=260 kv_valid=250 "
                 "H=12 D=16", (q.to(dtype), k.to(dtype), v.to(dtype), None,
                               None), dtype, gen, kv_valid=250)
        # B7's exact-softmax branch, logits far above the fixed-shift clamp
        qkv = torch.randn((4, 512, 3 * 16 * 80), generator=gen, device="cuda")
        qkv[..., :16 * 80] *= 8.0
        _hold_bh(torch, fa, "B7 no_max=False ViT-H encoder x8 logits",
                 _bh_args(qkv.to(dtype), 16, False), dtype, gen,
                 no_max=False)
        del q, k, v, qkv
    return errs


def run_vith_backward(torch, _cuda, entry_mod):
    """Phase 6: the ViT-H/14 classifier's backward as fine-tuning runs it
    (training mode, the dropout head drawing from a generator; fp32 params,
    bf16 compute) under a cross-entropy: 32 B3 + 32 B4 launches and finite
    gradients.  Then the model cut to 2 blocks (eval mode), flash against
    impl="naive": loss and per-leaf gradients, fp32 and bf16.  Returns the
    B4 launches."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, 48, 224, 224, 1), generator=gen, device="cuda")
    label = torch.tensor([3], device="cuda")
    vith = dict(ctor=entry_mod.vit_st.vit_huge_patch14, img_size=224)
    _, (model, _) = entry_mod.entry(**vith)
    model.train()
    _cuda.reset_launches()
    loss = F.cross_entropy(model(x, torch.Generator(device="cuda")
                                 .manual_seed(8)).float(), label)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"ViT-H classifier backward (48x224x224, train mode, bf16 "
          f"compute): loss {loss.item():.6f}, {len(grads)} leaves with "
          f"gradients, finite {finite}, launches {_nonzero(launches)}")
    depth = len(model.blocks)
    if _nonzero(launches) != {"flash_fwd_bh_cls": depth,
                              "flash_bwd_bh_cls": depth} or not finite:
        raise AssertionError(f"expected {depth} B3 + {depth} B4 launches and "
                             f"finite gradients, got {launches}")
    del model, grads, loss
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        _, (model, _) = entry_mod.entry(**vith, depth=2,
                                        dtype=dtype)
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(x).float(), label)
            loss.backward()
            res[impl] = (loss.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()
                                       if p.grad is not None})
        _compare_to_naive(f"ViT-H classifier {str(dtype)[6:]} (2 blocks, "
                          f"4,097 tokens)", res, dtype, TOL_NAIVE_CLS)
        del model, res
        torch.cuda.empty_cache()
    return launches["flash_bwd_bh_cls"]


# (path, (B, N, H, D), cls fold) of B3 / B4 (folded) and B5 / B7 on the
# ViT-H/14 paths (phase 9) and the default HIPT ViT-4K's (phase 21)
VITH_BH_PATHS = (("ViT-H classifier", (1, 4097, 16, 80), True),
                 ("ViT-H encoder", (4, 512, 16, 80), False))
HIPT_BH_PATHS = (("HIPT 16x16", (64, 257, 12, 16), True),
                 ("HIPT 14x14", (64, 197, 12, 16), False))


def time_bh_kernels(torch, fa, rate, paths=VITH_BH_PATHS):
    """Phase 9 (and 21), B3-B5 and B7 at the paths' shapes (bf16, laid out
    as the paths lay them out), timed: kernel, plain version, the library
    yardstick (SDPA at the same [B, H, N, D]: its forward for B3 and B5,
    forward + backward minus forward for B4 and B7) and the bound (the
    forwards' with their exps at ``rate``).  Returns {kernel: row}."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for path, (b, n, h, d), cls in paths:
        fwd, bwd = ("B3", "B4") if cls else ("B5", "B7")
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        args = _bh_args(qkv, h, cls)
        scale = d ** -0.5
        o, lse = fa.fwd_bh_cuda(*args, scale)
        do = _bh_do(torch, gen, b, n, h, d, torch.bfloat16, cls)
        _grads_twice(torch, f"{bwd} {path} B={b} bf16 as on the main path",
                     lambda: fa.bwd_bh_cuda(*args, o, lse, do, None, scale),
                     fa.bwd_bh_plain(*args, o, lse, do, None, scale),
                     torch.bfloat16)
        t = {fwd: _elapsed_ms(lambda: fa.fwd_bh_cuda(*args, scale), 50),
             bwd: _elapsed_ms(lambda: fa.bwd_bh_cuda(*args, o, lse, do, None,
                                                     scale), 20)}
        plain = {fwd: _elapsed_ms(lambda: fa.fwd_bh_plain(*args, scale), 3, 1),
                 bwd: _elapsed_ms(lambda: fa.bwd_bh_plain(
                     *args, o, lse, do, None, scale), 3, 1)}
        qh, kh, vh = (x.contiguous().requires_grad_() for x in
                      _bh_views(qkv, h))
        g = torch.randn((b, h, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        sdpa_fwd = _elapsed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 50)
        sdpa_all = _elapsed_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            (qh, kh, vh), g), 20)
        lib = {fwd: sdpa_fwd, bwd: sdpa_all - sdpa_fwd}
        m = n - 1 if cls else n          # query rows of the kernels
        keys = m + 1 if cls else m
        es = qkv.element_size()
        elems = b * m * h * d            # one [B, H, m, D] operand
        work = {fwd: fwd_work(b, h, m, keys, d),
                bwd: (10 * b * h * m * keys * d,
                      (3 * b * n * h * d + 2 * elems + 3 * elems) * es
                      + 2 * b * h * m * 4 + (2 * b * h * d * es if cls else 0),
                      0)}
        for kern in (fwd, bwd):
            flops, nbytes, exps = work[kern]
            bound_ms, bound_by = bound(flops, nbytes, exps, rate)
            rows[kern] = {"ms": t[kern], "plain_ms": plain[kern],
                          "library_ms": lib[kern], "bound_ms": bound_ms,
                          "bound_by": bound_by}
            print(f"{kern} timing {path} B={b} H={h} N={n} D={d} bf16: kernel "
                  f"{t[kern]:.4f} ms, plain {plain[kern]:.4f} ms, sdpa "
                  f"{'fwd' if kern == fwd else 'bwd'} {lib[kern]:.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
                  f"{nbytes:.3e} B, {exps:.3e} exp); "
                  f"{flops / t[kern] / 1e9:.1f} TFLOP/s achieved")
        del qkv, args, o, lse, do, qh, kh, vh, g
        torch.cuda.empty_cache()
    return rows


def time_forward(torch, fn, model, x, name):
    ms = _elapsed_ms(lambda: fn(model, x), 20)
    u, p = model.t_patch_size, model.patch_size
    n = 1 + x.shape[1] // u * (x.shape[2] // p) ** 2
    dim, depth = model.head.weight.shape[1], len(model.blocks)
    flops = depth * (2 * n * 12 * dim * dim + 4 * n * n * dim) \
        + 2 * (n - 1) * u * p * p * dim
    print(f"entry forward ({name} bf16, batch 1): {ms:.3f} ms per "
          f"volume; {flops:.3e} FLOP -> bound {flops / PEAK_BF16_FLOPS * 1e3:.3f} "
          f"ms at {PEAK_BF16_FLOPS:.3e} FLOP/s")
    return ms


# ----------------------------------------------------- B6: exact softmax

def _hold(torch, what, got, ref, dtype, atol=None):
    """|got - ref| <= atol + rtol |ref| at TOL_O[dtype] (``atol`` given:
    in place of TOL_O's) -> max |d|."""
    d = (got.float() - ref.float()).abs()
    atol0, rtol = TOL_O[str(dtype).split(".")[1]]
    atol = atol0 if atol is None else atol
    excess = (d - rtol * ref.float().abs()).max().item()
    if not (excess <= atol and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: max|d| {d.max().item():.3e} over "
                             f"{atol:.1e} + {rtol:.1e}|ref|")
    return d.max().item()


def _grads_close(torch, what, got, ref, dtype):
    """Each |got - ref| <= TOL_GRAD[dtype] * max|ref| -> the worst ratio."""
    tol = TOL_GRAD[str(dtype).split(".")[1]]
    worst = 0.0
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        rel = ((a.float() - r.float()).abs().max().item()
               / max(r.float().abs().max().item(), 1e-30))
        worst = max(worst, rel)
        if not (rel <= tol and torch.isfinite(a.float()).all()):
            raise AssertionError(f"{what}: {name} rel {rel:.3e} over {tol:.1e}")
    return worst


def _body_of(torch, fn):
    """Which forward body one call of fn runs: the name, up to its '<', of
    the one forward kernel in a profile of the call (after a call outside
    the profile, which loads the kernel).  A profile that records no
    device kernel (seen now and then on the first profile of a process)
    is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        bodies = {n.split("<")[0].split("::")[-1] for n in names
                  if "fwd_" in n and "_kernel" in n}
        if bodies:
            break
    if len(bodies) != 1:
        raise AssertionError(f"expected one forward kernel, ran {names}")
    return bodies.pop()


def check_b6(torch, fa, naive):
    """Phase 10: B6 against fwd_bh_exact_plain, fp32 and bf16, on the body
    each case should run (bf16 at D <= 128 the Hopper body, found by name
    in a profile of the call), each call made twice with o and lse
    bit-identical; then B6 + B7 (exact branch) under autograd against the
    plain versions.  The rect cases hold NaN in k and v past kv_valid for
    the forward (the gradients take finite tails).  Returns max |do| at
    the decoder shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    # (name, B, Nq, Nk, kv_valid, H, D, q multiplier, k multiplier); square
    # cases read the fused buffer's [B, H, N, D] views; every N ragged
    # against the 128-key and 128-row tiles
    cases = [("decoder D=32", 4, 5121, 5121, None, 16, 32, 1.0, 1.0),
             ("D=64", 2, 1025, 1025, None, 8, 64, 1.0, 1.0),
             ("ViT-H D=80", 1, 4097, 4097, None, 16, 80, 1.0, 1.0),
             ("D=128", 2, 513, 513, None, 4, 128, 1.0, 1.0),
             ("D=256", 1, 300, 300, None, 2, 256, 1.0, 1.0),
             ("decoder shard rect D=32", 4, 1281, 5124, 5121, 16, 32, 1.0,
              1.0),
             ("rect D=80", 2, 300, 1000, 950, 4, 80, 1.0, 1.0),
             ("large-logit q, k x 8 D=80", 2, 1025, 1025, None, 4, 80, 8.0,
              8.0),
             ("large-logit q, k x 8 rect D=64", 2, 200, 700, 650, 4, 64, 8.0,
              8.0),
             ("large-logit q x 40 D=32", 2, 1025, 1025, None, 4, 32, 40.0,
              1.0),
             ("large-logit q x 40 rect D=128", 2, 333, 700, 651, 4, 128, 40.0,
              1.0)]
    dec_err = None
    for name, b, nq, nk, kv, h, d, qmul, kmul in cases:
        mul = qmul * kmul
        for dtype in (torch.bfloat16, torch.float32):
            scale = d ** -0.5
            if nq == nk:
                qkv = torch.randn((b, nq, 3 * h * d), generator=gen,
                                  device="cuda")
                qkv[..., :h * d] *= qmul
                qkv[..., h * d:2 * h * d] *= kmul
                q, k, v = _bh_views(qkv.to(dtype), h)
                kn, vn = k, v
            else:
                q = qmul * torch.randn((b, h, nq, d), generator=gen,
                                       device="cuda")
                k, v = (torch.randn((b, h, nk, d), generator=gen,
                                    device="cuda") for _ in range(2))
                q, k, v = q.to(dtype), (kmul * k).to(dtype), v.to(dtype)
                kn, vn = k.clone(), v.clone()
                kn[:, :, kv:], vn[:, :, kv:] = math.nan, math.nan

            def call():
                return fa.fwd_bh_cuda(q, kn, vn, None, None, scale, kv, False)

            body = _body_of(torch, call)
            want = ("fwd_f32_kernel" if dtype == torch.float32 else
                    "fwd_hopper_kernel" if d <= 128 else "fwd_bf16_kernel")
            if body != want:
                raise AssertionError(f"B6 {name} {dtype} ran {body}, not "
                                     f"{want}")
            (o, lse), (o2, lse2) = call(), call()
            torch.cuda.synchronize()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            if not same:
                raise AssertionError(f"B6 {name} {dtype}: two calls differ")
            o_ref, lse_ref = fa.fwd_bh_exact_plain(q, k, v, scale, kv)
            # large logits (q, k x 8; q x 40), where a few keys carry each
            # row:
            # - bf16: the kernel rounds p relative to its running max, the
            #   plain version (and naive) relative to the row max or after
            #   normalising, each to 2^-9 of p, so o may differ by 2^-8 of
            #   the weighted |v| on top of o's own rounding; TOL_O's floor
            #   assumes many small p whose roundings average out;
            # - fp32: a logit of size L (max|lse| ~ max L, ~370) carries an
            #   absolute rounding error of a few ulps of L, which moves p
            #   by that much relative and o by that times |v|: 4 ulps of
            #   max|lse| times max|v|, at least TOL_O's.
            big = None
            if mul > 1.0:
                vmax = (v[:, :, :kv] if kv else v).float().abs().max().item()
                big = (2 ** -8 * vmax if dtype == torch.bfloat16 else
                       max(TOL_O["float32"][0], 4 * 2 ** -23 * vmax
                           * lse_ref.abs().max().item()))
            err = _hold(torch, f"B6 {name} {dtype}", o, o_ref, dtype, big)
            # lse = m + log l, rounded at its own magnitude: TOL_LSE, or 8
            # fp32 ulps where |lse| is large (~300 at the large logits,
            # whose ulp is 3.05e-5)
            dlse = (lse - lse_ref).abs().max().item()
            tol_lse = max(TOL_LSE, 8 * 2 ** -23 * lse_ref.abs().max().item())
            if dlse > tol_lse:
                raise AssertionError(f"B6 {name} {dtype}: max|dlse| {dlse}")
            line = (f"B6 {name} B={b} Nq={nq} Nk={nk} kv_valid={kv} H={h} "
                    f"D={d} {str(dtype)[6:]} ({body}"
                    f"{', NaN tail' if kv else ''}): max|do|={err:.3e} "
                    f"max|dlse|={dlse:.3e} (tol {tol_lse:.1e}); two calls "
                    f"bit-identical")
            if mul > 1.0:
                kk, vv = (t[:, :, :kv] if kv else t for t in (k, v))
                ref = naive(q, kk, vv, scale=scale)
                e6 = _hold(torch, f"B6 vs naive {name} {dtype}", o, ref, dtype,
                           big)
                o5, _ = fa.fwd_bh_cuda(q, k, v, None, None, scale, kv)
                e5 = (o5.float() - ref.float()).abs().max().item()
                if e5 <= 10 * max(e6, big):
                    raise AssertionError(f"B5 agrees with naive at {name}: "
                                         "the case does not pass the clamp")
                line += (f"; vs naive: B6 {e6:.3e}, B5 (fixed shift) "
                         f"{e5:.3e}")
                del o5
            print(line)
            if name == "decoder D=32" and dtype == torch.bfloat16:
                dec_err = err
            # B6 + B7 (exact) under autograd, against the plain versions
            # (the plain backward on the plain forward's o and lse)
            g = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
            _, grads = _attn_grads(torch, lambda *a: fa.flash_attention_rect(
                *a, scale, False, kv), q, k, v, g)
            ref = fa.bwd_bh_plain(q, k, v, None, None, o_ref, lse_ref, g, None,
                                  scale, False, kv)
            rel = _grads_close(torch, f"B6 + B7 {name} {dtype}", grads, ref,
                               dtype)
            print(f"B6 + B7 exact {name} {str(dtype)[6:]}: gradients against "
                  f"the plain versions, worst rel {rel:.3e} (tol "
                  f"{TOL_GRAD[str(dtype)[6:]]:.1e} x max|plain|)")
            del q, k, v, kn, vn, o, lse, o2, lse2, o_ref, lse_ref, g, grads
            del ref
        torch.cuda.empty_cache()
    return dec_err


# ------------------------------------------- the sequence-parallel layer

def _attn_grads(torch, fn, q, k, v, g):
    """fn(q, k, v) and its q, k, v gradients under the cotangent g."""
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, g)
    return out.detach(), grads


def run_sp_one_rank(torch, _cuda, fa, sp, layers):
    """Phase 11 on a one-rank NCCL group: the sp and ring layers against
    unsharded flash_attention; then the decoder stack under flash_sp
    against flash.  Returns the launches of the layer runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("sp",))
        gen = torch.Generator(device="cuda").manual_seed(11)
        b, h, n, d = 4, 16, 5121, 32
        q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        _cuda.reset_launches()
        runs = {
            "sequence_parallel_attention no_max=True": (
                lambda *a: sp.sequence_parallel_attention(*a, mesh),
                lambda *a: fa.flash_attention(*a)),
            "sequence_parallel_attention no_max=False": (
                lambda *a: sp.sequence_parallel_attention(*a, mesh,
                                                          no_max=False),
                lambda *a: fa.flash_attention(*a, no_max=False)),
            "ring_attention": (lambda *a: sp.ring_attention(*a, mesh),
                               lambda *a: fa.flash_attention(*a))}
        results = {}
        for name, (fn, ref_fn) in runs.items():
            results[name] = _attn_grads(torch, fn, q, k, v, g)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        for name, (fn, ref_fn) in runs.items():
            out, grads = results[name]
            out_ref, grads_ref = _attn_grads(torch, ref_fn, q, k, v, g)
            err = _hold(torch, f"{name} forward", out, out_ref, torch.bfloat16)
            rel = _grads_close(torch, name, grads, grads_ref, torch.bfloat16)
            print(f"one-rank NCCL {name} [4, 16, 5121, 32] bf16 vs unsharded "
                  f"flash_attention: max|do|={err:.3e}, gradients worst rel "
                  f"{rel:.3e}")
        print(f"one-rank NCCL layer launches: {_nonzero(launches)}")
        want = {"flash_fwd_bh": 2, "flash_fwd_bh_exact": 1, "flash_bwd_bh": 3}
        if _nonzero(launches) != want:
            raise AssertionError(f"expected {want}, got {launches}")
        del q, k, v, g, results

        # the decoder's stack at full width, flash_sp against flash
        torch.manual_seed(12)
        stack = layers.TransformerStack(8, 512, 16, dtype=torch.bfloat16,
                                        parity="flash").cuda()
        x = torch.randn((4, 5121, 512), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        res, stack_launches = {}, {}
        for impl in ("flash_sp", "flash"):
            for m in stack.modules():
                if hasattr(m, "attn_impl"):
                    m.attn_impl = impl
            stack.zero_grad(set_to_none=True)
            _cuda.reset_launches()
            with sp.use_sequence_parallel(mesh, "sp"):
                loss = (stack(x).float() ** 2).mean()
                loss.backward()
            torch.cuda.synchronize()
            stack_launches[impl] = _nonzero(_cuda.launches)
            res["auto" if impl == "flash_sp" else "naive"] = (
                loss.item(), {nm: p.grad.clone() for nm, p in
                              stack.named_parameters()})
        print(f"decoder stack launches: {stack_launches}")
        if stack_launches != {
                "flash_sp": {"flash_fwd_bh": 8, "flash_bwd_bh": 8},
                "flash": {"flash_fwd_packed": 8, "flash_bwd_packed": 8}}:
            raise AssertionError(f"unexpected launches {stack_launches}")
        _compare_to_naive("decoder TransformerStack(8, 512, 16) bf16, 5,121 "
                          "tokens, batch 4", res, torch.bfloat16,
                          label="flash_sp vs flash")
        for k_, c in stack_launches["flash_sp"].items():
            launches[k_] = launches.get(k_, 0) + c
        del stack, x, res
        torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


def run_sp_shards(torch, _cuda, fa):
    """Phase 12: the 4-shard geometry of a vitl_joint_pretrain_sp4 run on
    one card, each rank's local body in turn.  Returns the launches."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, h, n, n_pad, d, n_sp = 4, 16, 5121, 5124, 32, 4
    n_loc = n_pad // n_sp
    q0, k0, v0, g = (torch.randn((b, h, n_pad, d), generator=gen,
                                 device="cuda", dtype=torch.bfloat16)
                     for _ in range(4))
    g[:, :, n:] = 0  # the loss reads the valid rows only
    keep = (torch.arange(n_pad, device="cuda") < n)[:, None]
    launches = {}
    for no_max in (True, False):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        km, vm = torch.where(keep, k, 0), torch.where(keep, v, 0)
        _cuda.reset_launches()
        outs, grads = [], [torch.zeros(t.shape, device="cuda")
                           for t in (q, k, v)]
        for r in range(n_sp):
            rows = slice(r * n_loc, (r + 1) * n_loc)
            o = fa.flash_attention_rect(q[:, :, rows], km, vm, no_max=no_max,
                                        kv_valid=n)
            for acc, gr in zip(grads, torch.autograd.grad(
                    o, (q, k, v), g[:, :, rows], retain_graph=True)):
                acc += gr.float()
            outs.append(o.detach())
        torch.cuda.synchronize()
        for key, c in _nonzero(_cuda.launches).items():
            launches[key] = launches.get(key, 0) + c
        out = torch.cat(outs, dim=2)
        ref_out, ref_grads = _attn_grads(
            torch, lambda a, b_, c: fa.flash_attention(a, b_, c,
                                                       no_max=no_max),
            q0[:, :, :n], k0[:, :, :n], v0[:, :, :n], g[:, :, :n])
        err = _hold(torch, f"4 shards no_max={no_max}", out[:, :, :n],
                    ref_out, torch.bfloat16)
        rel = _grads_close(torch, f"4 shards no_max={no_max}",
                           [t[:, :, :n] for t in grads], ref_grads,
                           torch.bfloat16)
        pad_zero = all(bool((t[:, :, n:] == 0).all()) for t in grads)
        print(f"4 shards of 1,281 rows x 5,124 keys (kv_valid 5,121), "
              f"no_max={no_max}, bf16: concatenated output vs unsharded "
              f"max|do|={err:.3e}; summed gradients worst rel {rel:.3e}; pad "
              f"rows' gradients exactly 0: {pad_zero}")
        if not pad_zero:
            raise AssertionError("pad rows got a nonzero gradient")
        del q, k, v, km, vm, outs, grads, out, ref_out, ref_grads
    print(f"4-shard launches: {launches}")
    want = {"flash_fwd_bh": 4, "flash_fwd_bh_exact": 4, "flash_bwd_bh": 8}
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    return launches


# ------------------------------------------------------ B8 and timings

def check_b8(torch, kablate):
    """Phase 13: B8, every flag variant at every tile of the Hopper body,
    against its plain version at the harness's shape, each at its own
    padding; the base variant's call is profiled to show the body it ran.
    Returns max |do| of base at the base tile."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn((kablate.BH, kablate.N, kablate.D), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    runs = [(name, tile) for tile in kablate.TILES
            for name in kablate.VARIANTS]
    body = _body_of(torch, lambda: kablate.fwd_variant_cuda(q, k, v))
    print(f"B8 base {kablate.BASE_TILE} runs {body}")
    if body != "fwd_hopper_kernel":
        raise AssertionError(f"B8 ran {body}, not the Hopper body")
    base_err = None
    for name, tile in runs:
        flags = kablate.VARIANTS[name]
        o, lse = kablate.fwd_variant_cuda(q, k, v, tile, **flags)
        torch.cuda.synchronize()
        o_ref, lse_ref = kablate.fwd_variant_plain(
            q, k, v, kablate.n_pad_of(kablate.N, tile), kablate.TILES[tile][2],
            **flags)
        err = (o.float() - o_ref.float()).abs().max().item()
        top = o_ref.float().abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        ltop = max(lse_ref.abs().max().item(), 1e-30)
        print(f"B8 {name} {tile} BH={kablate.BH} N={kablate.N} D={kablate.D} "
              f"bf16: max|do|={err:.3e} (tol 2^-7 x max|plain| = "
              f"{2 ** -7 * top:.3e}), max|dl|={lerr:.3e} (tol 1e-4 x "
              f"{ltop:.3e})")
        if not (err <= 2 ** -7 * top and lerr <= 1e-4 * ltop
                and torch.isfinite(o.float()).all()):
            raise AssertionError(f"B8 {name} {tile} disagrees with its plain "
                                 "version")
        if (name, tile) == ("base", kablate.BASE_TILE):
            base_err = err
        del o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return base_err


def _row(ms, plain_ms, library_ms, work, rate):
    """A forward's row: its times and its bound from ``work`` = (FLOP,
    bytes, exps) at ``rate`` exps per second."""
    from octcubem_tpu_torch.scripts.time_kernels import bound

    bound_ms, bound_by = bound(*work, rate)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_b6(torch, fa, rate):
    """Phase 14, B6 at the decoder's square shape (the fused buffer's
    views) and at the 4-shard shape: kernel, plain version, SDPA at the
    same [B, H, N, D], the bound, and the parent's body's time
    (PARENT_B6_MS).  Returns the square shape's row."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import fwd_work

    gen = torch.Generator(device="cuda").manual_seed(15)
    b, h, n, d = 4, 16, 5121, 32
    scale = d ** -0.5
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = _bh_views(qkv, h)
    ms = _elapsed_ms(lambda: fa.fwd_bh_cuda(q, k, v, None, None, scale, None,
                                            False), 20)
    plain_ms = _elapsed_ms(lambda: fa.fwd_bh_exact_plain(q, k, v, scale), 3, 1)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    sdpa = _elapsed_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, scale=scale), 20)
    row = _row(ms, plain_ms, sdpa, fwd_work(b, h, n, n, d), rate)
    print(f"B6 timing decoder square B={b} H={h} N={n} D={d} bf16: kernel "
          f"{ms:.4f} ms (the parent's mma.sync body "
          f"{PARENT_B6_MS['square']:.4f}), plain {plain_ms:.4f} ms, sdpa "
          f"{sdpa:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); {4 * b * h * n * n * d / ms / 1e9:.1f} "
          "TFLOP/s achieved")
    del qkv, q, k, v, qc, kc, vc
    nq, nk, kv = 1281, 5124, 5121
    q = torch.randn((b, h, nq, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    ms_s = _elapsed_ms(lambda: fa.fwd_bh_cuda(q, k, v, None, None, scale, kv,
                                              False), 20)
    plain_s = _elapsed_ms(lambda: fa.fwd_bh_exact_plain(q, k, v, scale, kv),
                          3, 1)
    kk, vv = k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous()
    sdpa_s = _elapsed_ms(lambda: F.scaled_dot_product_attention(
        q, kk, vv, scale=scale), 20)
    shard = _row(ms_s, plain_s, sdpa_s, fwd_work(b, h, nq, kv, d), rate)
    print(f"B6 timing shard rect B={b} H={h} Nq={nq} Nk={nk} kv_valid={kv} "
          f"D={d} bf16: kernel {ms_s:.4f} ms (the parent's mma.sync body "
          f"{PARENT_B6_MS['shard']:.4f}), plain {plain_s:.4f} ms, sdpa "
          f"{sdpa_s:.4f} ms, bound {shard['bound_ms']:.4f} ms "
          f"({shard['bound_by']})")
    return row


def time_b8(torch, _cuda, kablate, rate):
    """Phase 13, then: the harness's timings (every variant, the tiles and
    a b* variant) with the launch count of its run; B8 base's plain
    version and SDPA at the same inputs viewed as [4, 16, N, D] (the base
    variant is attention up to the pad keys' e^-16 mass).  Returns B8's
    row."""
    import torch.nn.functional as F

    names = list(kablate.VARIANTS) + [t for t in kablate.TILES
                                      if t != kablate.BASE_TILE] + ["bwd"]
    _cuda.reset_launches()
    times = kablate.main(names)
    torch.cuda.synchronize()
    launches = _cuda.launches["flash_ablate"]
    print(f"kablate harness launches: {_nonzero(_cuda.launches)}")
    if not launches:
        raise AssertionError("the harness launched no B8")
    gen = torch.Generator(device="cuda").manual_seed(16)
    bh, n, d = kablate.BH, kablate.N, kablate.D
    q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    plain_ms = _elapsed_ms(lambda: kablate.fwd_variant_plain(
        q, k, v, kablate.n_pad_of(n), kablate.TILES[kablate.BASE_TILE][2]),
        3, 1)
    q4, k4, v4 = (t.view(4, bh // 4, n, d) for t in (q, k, v))
    sdpa = _elapsed_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=d ** -0.5), 20)
    from octcubem_tpu_torch.scripts.time_kernels import fwd_work

    row = _row(times["base"], plain_ms, sdpa, fwd_work(1, bh, n, n, d), rate)
    print(f"B8 base timing BH={bh} N={n} D={d} bf16: kernel {row['ms']:.4f} "
          f"ms (the harness's), plain {plain_ms:.4f} ms, sdpa {sdpa:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return dict(row, launches=launches)


# ----------------------------------- phase 15: the joint step, checkpoints

JOINT_B1_B2 = {"flash_fwd_packed": 160, "flash_bwd_packed": 160}
# the blank-region pre-mask on the card against its plain version on the
# CPU: equal per-frame counts, and a patch may differ only in a swap with
# one of its frame whose score is within this of its own (fp32 sums of
# 256 cosines in another order: a few ulps of 1)
PREMASK_EPS = 1e-6


def joint_flops(batch=4, batch2d=64) -> float:
    """Analytic FLOPs of one vitl_joint_pretrain step: the 3D batch at mask
    0.90 and the 2D batch (one tube of 3 frames at 512: 1,024 tokens) at
    mask 0.75, each fwd + bwd = 3 x fwd."""
    return (batch * mae_train_flops()
            + batch2d * mae_train_flops(frames=3, img=512, mask=0.75))


def _leaf_grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


# two flash runs of one bf16 model, per leaf max|dg| / max|g|: B2 sums dq
# in varying order, and its one-ulp differences in bf16 pass through every
# block below.  Held to B2's own bf16 limit; measured on an H100 at 700 W:
# 5.4e-3 and 5.2e-3 (full depth, step 3 resumed vs live) and 5.8e-3
# (2 + 2 blocks, remat vs not), 0.67-0.75 of it.
TOL_RUN_TO_RUN = TOL_GRAD["bfloat16"]


def _grads_agree(what, got, ref):
    """Per leaf |dg| <= TOL_RUN_TO_RUN * max|g| -> the worst ratio."""
    tol = TOL_RUN_TO_RUN
    if set(got) != set(ref):
        raise AssertionError(f"{what}: different leaves have gradients")
    worst, leaf = max(((got[n] - ref[n]).abs().max().item()
                       / max(ref[n].abs().max().item(), 1e-30), n)
                      for n in ref)
    print(f"{what}: worst leaf {leaf} rel {worst:.3e} (tol {tol:.1e})")
    if not worst <= tol:
        raise AssertionError(f"{what}: gradients disagree")
    return worst


def _joint_step(torch, _cuda, step, state, x, what):
    """One vitl_joint_pretrain step: finite, 160 B1 + 160 B2 launches and
    no other kernel."""
    _cuda.reset_launches()
    state, m = step(state, x, mask_ratio=0.9)
    torch.cuda.synchronize()
    launches = _nonzero(_cuda.launches)
    loss, gn = m["loss"].item(), m["grad_norm"].item()
    print(f"{what}: loss {loss:.6f} (3D {m['loss_3d'].item():.6f}, 2D "
          f"{m['loss_2d'].item():.6f}) grad_norm {gn:.6f} launches "
          f"{launches}")
    if not (math.isfinite(loss) and math.isfinite(gn)):
        raise AssertionError(f"{what}: non-finite loss or grad norm")
    if launches != JOINT_B1_B2:
        raise AssertionError(f"{what}: expected {JOINT_B1_B2} and no other "
                             f"kernel, got {launches}")
    return state, m


def time_joint(torch, step, state, x, smi, what):
    """The step's time, and its peak: the state held and three steps on
    it, the peak counter reset just before."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _elapsed_ms(lambda: step(state, x, mask_ratio=0.9), 2, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = joint_flops()
    bound = flops / PEAK_BF16_FLOPS * 1e3
    print(f"{what} (3D 4x60x256x256 mask 0.90 + 2D 64x3x512x512 mask 0.75, "
          f"bf16) on {smi}: {ms:.3f} ms per step; bound {bound:.3f} ms "
          f"({flops:.3e} FLOP at {PEAK_BF16_FLOPS:.3e} FLOP/s); "
          f"max_memory_allocated {peak:.2f} GiB")
    return ms, peak


def run_remat_2d(torch, _cuda, entry_mod, smi):
    """15.2: the 2D branch whole (accum_2d=1) through a remat model2d, and
    without; then remat on and off at 2 + 2 blocks."""
    peaks = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, state, x = entry_mod.train_entry(
            joint=True, batch=4, batch2d=64, accum_2d=1, use_premask=True,
            remat_2d=remat)
        _cuda.reset_launches()
        state, m = step(state, x, mask_ratio=0.9)
        torch.cuda.synchronize()
        launches = _nonzero(_cuda.launches)
        want = {"flash_fwd_packed": 96 if remat else 64,
                "flash_bwd_packed": 64}
        print(f"remat_2d={remat} accum_2d=1: loss {m['loss'].item():.6f} "
              f"launches {launches}")
        if launches != want or not math.isfinite(m["loss"].item()):
            raise AssertionError(f"expected {want} and a finite loss, got "
                                 f"{launches}, {m['loss'].item()}")
        _, peaks[remat] = time_joint(torch, step, state, x, smi,
                                     f"remat_2d={remat} step")
        del step, state, x, m
    if not peaks[True] < peaks[False]:
        raise AssertionError(f"remat peak {peaks[True]:.2f} GiB is not below "
                             f"{peaks[False]:.2f} GiB")
    res = {}
    for remat in (True, False):
        step, state, x = entry_mod.train_entry(
            joint=True, batch=4, batch2d=64, accum_2d=1, use_premask=True,
            remat_2d=remat, depth=2, decoder_depth=2)
        state, m = step(state, x, mask_ratio=0.9)
        res[remat] = (m["loss"].item(), _leaf_grads(state.params))
        del step, state, x
    print(f"remat_2d 2+2 blocks: loss {res[True][0]!r} vs {res[False][0]!r}")
    if res[True][0] != res[False][0]:
        raise AssertionError("remat changed the joint loss")
    _grads_agree("remat_2d on vs off, 2+2 blocks", res[True][1], res[False][1])
    torch.cuda.empty_cache()
    return peaks


def check_premask(torch, model, x):
    """15.3: the pre-mask on the card against the plain function on the
    CPU, from the same embeddings, on volumes with zeroed bands."""
    from octcubem_tpu_torch.data.premask import compute_premask, premask_scores

    bias = model.patch_embed.proj.bias.detach()
    if not bias.abs().max().item() > 0:
        raise AssertionError("a zero patch bias embeds blank patches as 0")
    xb = x.clone()
    xb[:, :, 96:160] = 0.0  # patch rows 6-9 of 16, every frame
    with torch.no_grad():
        feat = model.forward_patch_embed(xb)
    got = compute_premask(feat, model.t_grid, model.grid).cpu()
    host = feat.cpu()
    ref = compute_premask(host, model.t_grid, model.grid)
    score = premask_scores(host, model.t_grid, model.grid)
    b, t, l = score.shape
    g, r = got.reshape(b, t, l), ref.reshape(b, t, l)
    if not torch.equal(g.sum(-1), r.sum(-1)):
        raise AssertionError("pre-mask per-frame counts differ")
    ndiff, worst = int((g != r).sum().item()), 0.0
    for bi, ti in zip(*torch.nonzero((g != r).any(-1), as_tuple=True)):
        s = score[bi, ti]
        a = torch.sort(s[g[bi, ti] > r[bi, ti]]).values
        c = torch.sort(s[r[bi, ti] > g[bi, ti]]).values
        worst = max(worst, (a - c).abs().max().item())
    band = g.reshape(b, t, 16, 16)[:, :, 6:10]
    print(f"pre-mask card vs CPU: {ndiff} patches differ (worst swap "
          f"{worst:.3e}, eps {PREMASK_EPS:.0e}); masked per frame "
          f"{int(g[0, 0].sum())} of {l}; zeroed-band patches masked "
          f"{int(band.sum())} of {band.numel()}")
    if worst > PREMASK_EPS or not bool(band.all()):
        raise AssertionError("the card's pre-mask breaks the rule")


def _state_equal(torch, a, b):
    pa, pb = a.params.state_dict(), b.params.state_dict()
    return (a.step == b.step and a.tx.count == b.tx.count
            and all(torch.equal(pa[k], pb[k]) for k in pa)
            and all(u.dtype == v.dtype and torch.equal(u, v) for u, v in
                    zip(a.tx.mu + a.tx.nu, b.tx.mu + b.tx.nu))
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def run_joint_and_resume(torch, _cuda, entry_mod, optim, ckpt, run_dir,
                         smi):
    """15.1 and 15.4: three joint steps at full width, saved after steps 1
    and 2 (async, keep_last=2), restored into a fresh state, step 3 taken
    from both; the NaN cleanup; the step's time.  -> (ms, peak, model, x)."""
    ck_dir = str(Path(run_dir) / "ckpt")
    torch.cuda.reset_peak_memory_stats()
    step, state, x = entry_mod.train_entry(joint=True, batch=4, batch2d=64,
                                           accum_2d=4, use_premask=True)
    model = state.params
    names = [n for n, _ in model.named_parameters()]
    before = [p.detach().clone() for p in model.parameters()]
    if state.tx.lr(0) != 0.0:
        raise AssertionError(f"the schedule's first LR is {state.tx.lr(0)}")
    state, _ = _joint_step(torch, _cuda, step, state, x, "joint step 1")
    if not all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
        raise AssertionError("params moved at the first update, whose LR "
                             "is 0")
    ckpt.save_checkpoint(ck_dir, state.step, state)
    state, _ = _joint_step(torch, _cuda, step, state, x, "joint step 2")
    t0 = time.time()
    ckpt.save_checkpoint(ck_dir, state.step, state, {"epoch": state.step},
                         keep_last=2, async_save=True)
    staged = time.time() - t0
    ckpt.wait_for_saves(ck_dir)
    print(f"checkpoint of step {state.step}: staged in {staged:.1f} s, on "
          f"disk after {time.time() - t0:.1f} s; steps "
          f"{sorted(os.listdir(ck_dir))}")
    fstep, fresh, fx = entry_mod.train_entry(joint=True, batch=4, batch2d=64,
                                             accum_2d=4, use_premask=True)
    if _state_equal(torch, fresh, state):
        raise AssertionError("the fresh state already equals the live one")
    restored, extra, at = ckpt.restore_checkpoint(ck_dir, fresh)
    if not (at == 2 and extra == {"epoch": 2}
            and _state_equal(torch, restored, state)):
        raise AssertionError("the restored state differs from the live one")
    print(f"restore of step {at}: params, mu, nu, count, step and generator "
          "bit-identical to the live state")
    state, m = _joint_step(torch, _cuda, step, state, x, "joint step 3")
    fresh, fm = _joint_step(torch, _cuda, fstep, fresh, fx,
                            "joint step 3 from the restored state")
    if m["loss"].item() != fm["loss"].item():
        raise AssertionError("the resumed step's loss differs")
    _grads_agree("step 3 resumed vs live", _leaf_grads(fresh.params),
                 _leaf_grads(state.params))
    del fstep, fresh, fx, restored
    deleted = ckpt.delete_recent_checkpoints(ck_dir, 1)
    left = ckpt.latest_step(ck_dir)
    print(f"delete_recent_checkpoints(1): deleted {deleted}, latest {left}")
    if deleted != [2] or left != 1:
        raise AssertionError("the NaN cleanup did not leave the older step")
    decayed = optim.weight_decay_mask(model)
    free = {n for n, p in model.named_parameters()
            if p.grad is None and not decayed[n]}
    still = {n for n, a, p in zip(names, before, model.parameters())
             if torch.equal(a, p)}
    print(f"joint: {len(names) - len(still)} of {len(names)} params moved by "
          f"steps 2-3; unmoved {sorted(still)}")
    if still - free:
        raise AssertionError(f"params did not move: {sorted(still - free)}")
    del before
    torch.cuda.empty_cache()
    ms, peak = time_joint(torch, step, state, x, smi,
                          "vitl_joint_pretrain step (accum_2d=4)")
    return ms, peak, model, x


def run_export_and_serve(torch, _cuda, run_dir):
    """15.5: cli/export.py writes the checkpoint's MAE with its stamp;
    cli/serve.py serves it (head from init, decoder keys unexpected) and
    agrees with vit_st run directly; a num_heads=8 stamp is refused."""
    import numpy as np

    from octcubem_tpu_torch.cli import export, serve
    from octcubem_tpu_torch.compat import torch_export, torch_import
    from octcubem_tpu_torch.data.transforms import Transform3D
    from octcubem_tpu_torch.models import vit_st

    pth = str(Path(run_dir) / "octcube_export.pth")
    export.main(["--ckpt", run_dir, "--out", pth])
    stamp = torch.load(pth, map_location="cpu", weights_only=True,
                       mmap=True)["octcubem_tpu_geometry"]
    print(f"export stamp {stamp}")
    if stamp.get("num_heads") != 16:
        raise AssertionError("the export carries no head-count stamp")
    rng = np.random.default_rng(15)
    vols = [rng.random((48, 256, 256), dtype=np.float32) for _ in range(3)]
    raw = (rng.random((40, 200, 300)) * 255).astype(np.float32)
    _cuda.reset_launches()
    with _serving(serve, ["--port", "0", "--seed", "0", "--ckpt", pth]) as base:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read().decode())
        report = health["import"]
        print(f"serve /healthz of the export: missing {report['missing']}, "
              f"{len(report['unexpected'])} unexpected keys")
        if (report["missing"] != ["head.weight", "head.bias"]
                or not all(k.startswith(("decoder_", "mask_token",
                                         "high_res_patch_embed."))
                           for k in report["unexpected"])
                or not any(k.startswith("decoder_blocks.")
                           for k in report["unexpected"])):
            raise AssertionError(f"unexpected import report {report}")
        answers = [_post_npy(base + "/predict?raw=0", v) for v in vols]
        answers.append(_post_npy(base + "/predict", raw))
    launches = _nonzero(_cuda.launches)
    if launches != {"flash_fwd_packed": 24 * 5}:
        raise AssertionError(f"expected 120 B1 launches, got {launches}")
    model = vit_st.create_model(
        vit_st.VisionTransformerST, seed=0, num_frames=48, t_patch_size=3,
        img_size=256, in_chans=1, num_classes=16, head_type="dropout",
        global_pool=True, dtype=torch.bfloat16)
    torch_import.load_reference_weights(
        model, torch_import.load_torch_checkpoint(pth), strict=False)
    worst = 0.0
    inputs = vols + [Transform3D(256, 48, train=False)(raw) / 255.0]
    for (code, out), v in zip(answers, inputs):
        with torch.inference_mode():
            probs = _disease_probs(model(torch.from_numpy(v[None, ..., None])
                                         .to(model.head.weight.device)))
        got = np.asarray(out.get("probs", [[np.nan]]), np.float64)
        if code != 200 or got.shape != probs.shape:
            raise AssertionError(f"bad predict answer {code} {out}")
        worst = max(worst, float(np.abs(got - probs).max()))
    print(f"served export vs vit_st run directly: max|dprobs| {worst:.3e} "
          "(tol 1e-6)")
    if not worst <= 1e-6:
        raise AssertionError("the server and the direct model disagree")
    bad = str(Path(run_dir) / "stamped_8.pth")
    torch_export.save_torch_checkpoint(
        bad, {}, extra={"octcubem_tpu_geometry": {"num_heads": 8}})
    _cuda.reset_launches()
    try:
        serve.build_predictor(argparse.Namespace(
            aot=None, quant="none", ckpt=bad, device=None, seed=0,
            num_frames=48, input_size=256, nb_classes=16, precision="bf16",
            embed_dim=None, depth=None, num_heads=None))
    except SystemExit as e:
        print(f"num_heads=8 stamp refused: {str(e)[:100]}...")
    else:
        raise AssertionError("a num_heads=8 stamp was served at 16 heads")
    if _nonzero(_cuda.launches):
        raise AssertionError("the refused file reached a forward")
    del model
    torch.cuda.empty_cache()


def run_retfound_init(torch, entry_mod, run_dir):
    """15.6: a seeded RETFound-layout 2D checkpoint of the MAE's encoder
    (ViT-L: fused attn.qkv, a 14 x 14 flat pos embed with its cls row, a
    Conv2d patch embed), converted and imported into the MAE; one joint
    step from it is finite."""
    from octcubem_tpu_torch.compat import torch_export, torch_import

    step, state, x = entry_mod.train_entry(joint=True, batch=4, batch2d=64,
                                           accum_2d=4, use_premask=True)
    model = state.params
    d, dev = model.embed_dim, model.cls_token.device
    gen = torch.Generator(device=dev).manual_seed(6)

    def r(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).cpu()

    sd = {"cls_token": r(1, 1, d), "pos_embed": r(1, 1 + 14 * 14, d),
          "patch_embed.proj.weight": r(d, 1, 16, 16),
          "patch_embed.proj.bias": r(d), "norm.weight": 1 + r(d),
          "norm.bias": r(d)}
    for i in range(len(model.blocks)):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1 + r(d), p + "norm1.bias": r(d),
                   p + "attn.qkv.weight": r(3 * d, d),
                   p + "attn.qkv.bias": r(3 * d),
                   p + "attn.proj.weight": r(d, d), p + "attn.proj.bias": r(d),
                   p + "norm2.weight": 1 + r(d), p + "norm2.bias": r(d),
                   p + "mlp.fc1.weight": r(4 * d, d),
                   p + "mlp.fc1.bias": r(4 * d),
                   p + "mlp.fc2.weight": r(d, 4 * d), p + "mlp.fc2.bias": r(d)})
    path = str(Path(run_dir) / "RETFound_oct_weights.pth")
    torch_export.save_torch_checkpoint(path, sd)
    del sd
    conv = torch_import.convert_retfound_2d_state_dict(
        torch_import.load_torch_checkpoint(path), t_patch_size=3,
        target_grid=model.high_res_grid)
    report = torch_import.load_reference_weights(model, conv)
    print(f"RETFound 2D init ({len(model.blocks)} blocks of {d}): "
          f"{len(conv)} keys imported, {len(report['missing'])} missing "
          f"(kept from init), {len(report['unexpected'])} unexpected")
    if not (torch.equal(model.blocks[0].mixer.Wqkv.weight.detach().cpu(),
                        torch.from_numpy(conv["blocks.0.attn.qkv.weight"]))
            and "pos_embed_temporal" in report["missing"]):
        raise AssertionError("the RETFound weights did not land")
    state, m = step(state, x, mask_ratio=0.9)
    loss = m["loss"].item()
    print(f"joint step from the RETFound init: loss {loss:.6f} grad_norm "
          f"{m['grad_norm'].item():.6f}")
    if not (math.isfinite(loss) and math.isfinite(m["grad_norm"].item())):
        raise AssertionError("non-finite joint step from the RETFound init")
    del step, state, x, model
    torch.cuda.empty_cache()


def run_phase15(torch, _cuda, entry_mod, optim, smi):
    """Phase 15 -> (the joint step's ms and peak GiB, remat_2d's peaks)."""
    from octcubem_tpu_torch.core import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as run_dir:
        with open(Path(run_dir) / "args.json", "w") as f:
            json.dump({"model": "mae_vit_large_patch16", "num_heads": 16,
                       "decoder_num_heads": 16, "num_frames": 60,
                       "t_patch_size": 3, "input_size": 256}, f)
        ms, peak, model, x = run_joint_and_resume(
            torch, _cuda, entry_mod, optim, ckpt, run_dir, smi)
        check_premask(torch, model, x)
        del model, x
        torch.cuda.empty_cache()
        peaks = run_remat_2d(torch, _cuda, entry_mod, smi)
        run_export_and_serve(torch, _cuda, run_dir)
        run_retfound_init(torch, entry_mod, run_dir)
    return ms, peak, peaks


# ------------------------------------- phase 16: the serving options

# int8 against bf16 logits: the JAX package's own bound for its int8
# classifier (tests/test_quant.py:95), and every disease's argmax equal
TOL_INT8 = dict(rtol=0.15, atol=0.05)
# an AOT program runs the live model's kernels in the same order
TOL_AOT = 1e-6
# int8 GEMMs in a profile of the int8 forward, by kernel name (cuBLASLt's
# int8 kernels name their operand type)
INT8_GEMM = ("s8", "i8", "int8", "imma", "igemm")
CAM_GRID = (16, 16, 16)
# Grad-CAM flash against impl="naive" (4 blocks, layer 0, bf16), |dmap| on
# maps each over its max: the map is a 1,024-channel dot of the activation
# (one bf16 step apart, 2^-8) with the token mean of dScore/dA (B2's bf16
# limit, 2^-7 of its largest entry); their sum is 0.0117, and 2^-5 allows
# ~2.5x that.  With the seeded weights the attention branch is small next
# to the residual stream, whose bf16 step absorbs the two paths'
# differences, so the check also runs with the q projection x 8, where
# attention is sharp and carries the signal.
TOL_CAM_NAIVE = 2 ** -5


def _serve_and_hold(torch, _cuda, serve, argv, what, model, vols,
                    expect_b1, tol):
    """Start the server with ``argv``; /healthz, then one /predict?raw=0
    per volume, each held against ``model`` run directly on it within
    ``tol``; ``expect_b1`` B1 launches over the warm-up and the
    requests."""
    import numpy as np

    _cuda.reset_launches()
    with _serving(serve, argv) as base:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read().decode())
        print(f"{what} /healthz: {r.status} quant={health.get('quant')} "
              f"source={health.get('source')}")
        answers = [_post_npy(base + "/predict?raw=0", v) for v in vols]
    launches = _nonzero(_cuda.launches)
    worst = 0.0
    for (code, out), v in zip(answers, vols):
        got = np.asarray(out.get("probs", [[np.nan]]), np.float64)
        with torch.inference_mode():
            ref = _disease_probs(model(torch.from_numpy(v[None, ..., None])
                                       .to("cuda")))
        if code != 200 or got.shape != ref.shape:
            raise AssertionError(f"{what}: bad predict answer {code} {out}")
        worst = max(worst, float(np.abs(got - ref).max()))
        print(f"{what} /predict?raw=0: {code} latency_ms "
              f"{out.get('latency_ms')}")
    print(f"{what}: max|dprobs| vs the model run directly {worst:.3e} (tol "
          f"{tol:.0e}); launches {launches}")
    if not worst <= tol:
        raise AssertionError(f"{what}: the server and the model disagree")
    if launches != {"flash_fwd_packed": expect_b1}:
        raise AssertionError(f"{what}: expected {expect_b1} B1 launches, got "
                             f"{launches}")


def run_int8(torch, _cuda, entry_mod, serve, model, fn, x):
    """16.1: the int8 model (block projections quantized from ``model``):
    24 B1 launches and int8 GEMMs in a profile, logits within TOL_INT8 of
    the bf16 model and every disease's argmax equal, both timed; then
    cli/serve.py --quant int8."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from octcubem_tpu_torch.ops.quant import quantize_state_dict
    from octcubem_tpu_torch.scripts.profile_forward import kernel_rows

    _, (qmodel, _) = entry_mod.entry(quant=True)
    qmodel.load_state_dict(quantize_state_dict(model.state_dict()),
                           strict=True)
    _cuda.reset_launches()
    q = fn(qmodel, x)
    torch.cuda.synchronize()
    launches = _nonzero(_cuda.launches)
    ref = fn(model, x)
    d = (q.float() - ref.float()).abs()
    excess = (d - TOL_INT8["rtol"] * ref.float().abs()).max().item()
    agree = torch.equal(q.float().reshape(-1, 2).argmax(-1),
                        ref.float().reshape(-1, 2).argmax(-1))
    print(f"int8 ViT-L forward: launches {launches}; max|dlogits| vs bf16 "
          f"{d.max().item():.3e} (tol {TOL_INT8['atol']} + "
          f"{TOL_INT8['rtol']}|ref|, max|logits| "
          f"{ref.float().abs().max().item():.3e}); disease argmax equal: "
          f"{agree}")
    if launches != {"flash_fwd_packed": 24}:
        raise AssertionError(f"int8: expected 24 B1 launches, got {launches}")
    if not (excess <= TOL_INT8["atol"] and agree
            and torch.isfinite(q.float()).all()):
        raise AssertionError("the int8 logits leave the bf16 model's bound")
    for _ in range(3):  # a first profile may record no device kernel
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(qmodel, x)
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        if rows:
            break
    int8 = [r for r in rows if any(t in r[0].lower() for t in INT8_GEMM)]
    for name, count, us in rows[:12]:
        print(f"int8 forward kernel {count:4d} x {us / 1e3:8.3f} ms "
              f"{name[:110]}")
    n_int8 = sum(c for _, c, _ in int8)
    print(f"int8 forward: {n_int8} int8 GEMM launches "
          f"({sum(u for _, _, u in int8) / 1e3:.3f} ms) of "
          f"{sum(c for _, c, _ in rows)} kernels")
    if n_int8 < 4 * 24:
        raise AssertionError("the int8 forward ran no int8 GEMM per "
                             "projection")
    ms_bf16 = _elapsed_ms(lambda: fn(model, x), 20)
    ms_int8 = _elapsed_ms(lambda: fn(qmodel, x), 20)
    print(f"ViT-L 48x256x256 batch 1 forward, CUDA events over 20: bf16 "
          f"{ms_bf16:.3f} ms, int8 {ms_int8:.3f} ms")
    rng = np.random.default_rng(16)
    vols = [rng.random((48, 256, 256), dtype=np.float32) for _ in range(2)]
    # the server builds the same seeded init and quantizes it the same way
    _serve_and_hold(torch, _cuda, serve,
                    ["--port", "0", "--seed", "0", "--quant", "int8"],
                    "serve --quant int8", qmodel, vols, 24 * 3, 1e-6)
    del qmodel, q, ref
    torch.cuda.empty_cache()
    return ms_bf16, ms_int8


def run_aot(torch, _cuda, entry_mod, serve, model, fn, x, run_dir):
    """16.2: the bf16 ViT-L exported on the card, written, loaded back:
    24 B1 op calls in its graph, 24 B1 launches, the live logits within
    TOL_AOT; a ("cuda", "cpu") artifact exported on the CPU runs on the
    card through B1; a cpu-only one is refused there; cli/serve.py --aot.
    Returns the export and load seconds."""
    import numpy as np

    from octcubem_tpu_torch.compat import aot

    live = fn(model, x)
    path = str(Path(run_dir) / "vitl.octaot")
    t0 = time.time()
    aot.export_serving_artifact(model, (x,), path,
                                meta={"nb_classes": 16, "quant": "none"})
    export_s = time.time() - t0
    t0 = time.time()
    afn, meta = aot.load_serving_artifact(path)
    load_s = time.time() - t0
    calls = aot.flash_op_calls(afn.program)
    _cuda.reset_launches()
    out = afn(x)
    torch.cuda.synchronize()
    launches = _nonzero(_cuda.launches)
    err = (out.float() - live.float()).abs().max().item()
    print(f"AOT export on the card {export_s:.2f} s, load {load_s:.2f} s, "
          f"{os.path.getsize(path) / 2 ** 30:.2f} GiB; header "
          f"{ {k: meta[k] for k in ('platforms', 'exported_on', 'in_shapes')} }; "
          f"flash op calls in the graph {calls}; launches {launches}; "
          f"max|dlogits| vs the live model {err:.3e} (tol {TOL_AOT:.0e})")
    if calls != 24 or launches != {"flash_fwd_packed": 24}:
        raise AssertionError("the artifact's graph or run misses B1")
    if not err <= TOL_AOT:
        raise AssertionError("the artifact and the live model disagree")
    del afn

    _, (cpu_model, cpu_x) = entry_mod.entry(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    both = str(Path(run_dir) / "vitl_both.octaot")
    t0 = time.time()
    aot.export_serving_artifact(cpu_model, (cpu_x,), both,
                                platforms=("cuda", "cpu"))
    cpu_export_s = time.time() - t0
    del cpu_model
    t0 = time.time()
    bfn, bmeta = aot.load_serving_artifact(both)
    move_s = time.time() - t0
    _cuda.reset_launches()
    out = bfn(x)
    torch.cuda.synchronize()
    launches = _nonzero(_cuda.launches)
    err2 = (out.float() - live.float()).abs().max().item()
    print(f"AOT exported on the CPU for {bmeta['platforms']} in "
          f"{cpu_export_s:.2f} s, loaded onto the card (moved) in "
          f"{move_s:.2f} s: launches {launches}; max|dlogits| vs the live "
          f"model {err2:.3e}")
    if launches != {"flash_fwd_packed": 24} or not err2 <= TOL_AOT:
        raise AssertionError("the CPU-exported artifact did not run B1 on "
                             "the card to the live logits")
    ms_aot = _elapsed_ms(lambda: bfn(x), 10)
    del bfn
    os.remove(both)

    _, (small, small_x) = entry_mod.entry(device="cpu", depth=1)
    cpu_only = str(Path(run_dir) / "cpu_only.octaot")
    aot.export_serving_artifact(small, (small_x,), cpu_only)
    try:
        aot.load_serving_artifact(cpu_only)
    except ValueError as e:
        print(f"cpu-only artifact refused on the card: {e}")
    else:
        raise AssertionError("a cpu-only artifact was loaded on the card")
    del small

    rng = np.random.default_rng(17)
    vols = [rng.random((48, 256, 256), dtype=np.float32)]
    _serve_and_hold(torch, _cuda, serve, ["--port", "0", "--aot", path],
                    "serve --aot", model, vols, 24 * 2, 1e-6)
    os.remove(path)
    print(f"AOT artifact forward (the CPU export on the card), CUDA events "
          f"over 10: {ms_aot:.3f} ms")
    return export_s, load_s


def run_gradcam(torch, _cuda, entry_mod, x):
    """16.3: Grad-CAM on the ViT-L classifier at full depth, bf16 and fp32
    (infer's default), at layer -1 (infer's) and layer 0: B1 per block and
    B2 per block after the chosen one; a finite map in [0, 1]; its time.
    Then flash against impl="naive" at 4 blocks, full width."""
    import numpy as np

    from octcubem_tpu_torch.utils.saliency import gradcam

    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        _, (model, _) = entry_mod.entry(capture_cam=True, dtype=dtype)
        for layer in (-1, 0):
            _cuda.reset_launches()
            cam = gradcam(model, x, layer=layer, grid=CAM_GRID)
            torch.cuda.synchronize()
            launches = _nonzero(_cuda.launches)
            expect = {"flash_fwd_packed": 24}
            if layer == 0:
                expect["flash_bwd_packed"] = 23
            ms = _elapsed_ms(lambda: gradcam(model, x, layer=layer,
                                             grid=CAM_GRID), 3, 1)
            times[(str(dtype)[6:], layer)] = ms
            print(f"Grad-CAM ViT-L {str(dtype)[6:]} layer {layer}: map "
                  f"{cam.shape} in [{cam.min():.3f}, {cam.max():.3f}], "
                  f"launches {launches}, {ms:.3f} ms per map (CUDA events "
                  f"over 3)")
            if (cam.shape != (1,) + CAM_GRID or not np.isfinite(cam).all()
                    or cam.min() < 0 or cam.max() > 1):
                raise AssertionError("bad Grad-CAM map")
            if launches != expect:
                raise AssertionError(f"Grad-CAM: expected {expect}, got "
                                     f"{launches}")
        del model
        torch.cuda.empty_cache()

    _, (model, _) = entry_mod.entry(capture_cam=True, depth=4)
    mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
    errs = []
    for q_mul in (1.0, 8.0):
        with torch.no_grad():
            for m in mhas:
                m.Wqkv.weight[:m.Wqkv.weight.shape[1]] *= q_mul
        cams = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            cams[impl] = gradcam(model, x, layer=0, grid=CAM_GRID)
        errs.append(float(np.abs(cams["auto"] - cams["naive"]).max()))
        print(f"Grad-CAM flash vs naive (ViT-L 4 blocks, 4,097 tokens, bf16, "
              f"layer 0, q x {q_mul:g}): max|dmap| {errs[-1]:.3e} (tol "
              f"{TOL_CAM_NAIVE:.3e})")
    if not max(errs) <= TOL_CAM_NAIVE:
        raise AssertionError("flash and naive Grad-CAM maps disagree")
    del model
    torch.cuda.empty_cache()
    return times, errs


def run_dicom(torch, infer, run_dir):
    """16.4: cli/infer.py on a .dcm written by write_dicom against the same
    volume as .npy (no --saliency_dir: the card's machine has no
    matplotlib)."""
    import numpy as np

    from octcubem_tpu_torch.data.dicom import write_dicom

    vol = (np.random.default_rng(18).random((40, 200, 300)) * 255).astype(
        np.uint8)
    dcm, npy = (str(Path(run_dir) / n) for n in ("vol.dcm", "vol.npy"))
    write_dicom(dcm, vol)
    np.save(npy, vol)
    t0 = time.time()
    p_dcm = infer.main([dcm])
    dcm_s = time.time() - t0
    p_npy = infer.main([npy])
    print(f"infer on a .dcm ({dcm_s:.2f} s with the model build, fp32): "
          f"probs {p_dcm.shape}, equal to the .npy's: "
          f"{np.array_equal(p_dcm, p_npy)}")
    if (p_dcm.shape != (8, 2) or not np.isfinite(p_dcm).all()
            or not np.array_equal(p_dcm, p_npy)):
        raise AssertionError("infer on the .dcm and the .npy disagree")


def run_phase16(torch, _cuda, entry_mod, serve, infer):
    """Phase 16 -> its timings."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.rand((1, 48, 256, 256, 1), generator=gen, device="cuda")
    fn, (model, _) = entry_mod.entry()
    out = {}
    out["bf16_ms"], out["int8_ms"] = run_int8(torch, _cuda, entry_mod, serve,
                                              model, fn, x)
    with tempfile.TemporaryDirectory() as run_dir:
        out["export_s"], out["load_s"] = run_aot(
            torch, _cuda, entry_mod, serve, model, fn, x, run_dir)
        del model
        torch.cuda.empty_cache()
        out["cam_ms"], out["cam_naive_err"] = run_gradcam(
            torch, _cuda, entry_mod, x)
        run_dicom(torch, infer, run_dir)
    return out


# ------------------------------------------------- phase 17: the 2D MAE

MAE2D_B1_B2 = {"flash_fwd_packed": 32, "flash_bwd_packed": 32}


def mae2d_train_flops(d=1024, layers=24, dd=512, dlayers=8, img=224,
                      patch=16, chans=1, mask=0.75) -> float:
    """Analytic FLOPs of one 2D MAE train step per image (fwd + bwd = 3 x
    fwd), as mae_train_flops counts the 3D one: the encoder on the kept
    patches + cls, the decoder on every patch + cls; the patch embed runs
    on every patch (the 2D module embeds, then gathers)."""
    l_full = (img // patch) ** 2                          # 196
    l_vis = int(l_full * (1 - mask)) + 1                  # 49 + cls
    l_dec = l_full + 1
    pix = patch * patch * chans
    dense = (layers * 2 * l_vis * 12 * d * d + dlayers * 2 * l_dec * 12 * dd * dd
             + 2 * l_full * pix * d + 2 * l_dec * dd * pix
             + 2 * l_vis * d * dd)
    attn = layers * 4 * l_vis * l_vis * d + dlayers * 4 * l_dec * l_dec * dd
    return 3.0 * (dense + attn)


def run_mae2d(torch, _cuda, optim, schedules, smi):
    """17.1: mae_vit_large_patch16 (img 224, in_chans 1) in bf16 with fp32
    params, batch 16, mask 0.75: three forward-backward + AdamW updates
    (finite; the first at LR 0 leaves every param as it was; 32 B1 + 32
    B2 launches each and no other kernel), then its time and peak beside
    its bound."""
    from octcubem_tpu_torch.models import mae2d

    torch.cuda.empty_cache()
    model = mae2d.create_model(mae2d.mae_vit_large_patch16, seed=3,
                               img_size=224, in_chans=1, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((16, 224, 224, 1), generator=gen, device="cuda")
    tx = optim.build_adamw(model, schedules.warmup_half_cosine(
        1.6e-3, 0.0, 1, 50, 1000), weight_decay=0.05)
    if tx.lr(0) != 0.0:
        raise AssertionError(f"the schedule's first LR is {tx.lr(0)}")
    l_full = (224 // 16) ** 2

    def step():
        noise = torch.rand((16, l_full), generator=gen, device="cuda")
        tx.zero_grad()
        loss = model(x, 0.75, noise)[0]
        loss.backward()
        tx.step()
        return loss

    names = [n for n, _ in model.named_parameters()]
    before = [p.detach().clone() for p in model.parameters()]
    for i in range(3):
        _cuda.reset_launches()
        loss = step().item()
        torch.cuda.synchronize()
        launches = _nonzero(_cuda.launches)
        print(f"MAE 2D ViT-L/16 224 batch 16 step {i + 1}: loss {loss:.6f} "
              f"lr {tx.lr(i):.4e} launches {launches}")
        if not math.isfinite(loss):
            raise AssertionError("non-finite 2D MAE loss")
        if launches != MAE2D_B1_B2:
            raise AssertionError(f"expected {MAE2D_B1_B2} per step and no "
                                 f"other kernel, got {launches}")
        if i == 0 and not all(torch.equal(a, p) for a, p in
                              zip(before, model.parameters())):
            raise AssertionError("params moved at the first update, whose "
                                 "LR is 0")
    still = sorted(n for n, a, p in zip(names, before, model.parameters())
                   if torch.equal(a, p))
    print(f"MAE 2D: {len(names) - len(still)} of {len(names)} params moved "
          f"by steps 2-3; unmoved {still}")
    if still:
        raise AssertionError(f"params did not move: {still}")
    del before
    # the peak of the state held and the steps on it (no copy of the params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _elapsed_ms(step, 5, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = 16 * mae2d_train_flops()
    bound = flops / PEAK_BF16_FLOPS * 1e3
    print(f"MAE 2D step (ViT-L/16 224, in_chans 1, batch 16, mask 0.75, "
          f"bf16) on {smi}: {ms:.3f} ms per step (CUDA events over 5), "
          f"{16 / ms * 1e3:.1f} images/s; bound {bound:.3f} ms ({flops:.3e} "
          f"FLOP at {PEAK_BF16_FLOPS:.3e} FLOP/s); max_memory_allocated "
          f"{peak:.2f} GiB")
    del model, tx, x
    torch.cuda.empty_cache()
    return ms, peak, bound


def check_mae2d_vs_naive(torch):
    """17.2: the 2D MAE cut to 2 + 2 blocks at batch 2, flash (B1 + B2)
    against impl="naive": loss and per-leaf gradients, fp32 and bf16,
    within TOL_NAIVE_2D."""
    from octcubem_tpu_torch.models import mae2d

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, 224, 224, 1), generator=gen, device="cuda")
    noise = torch.rand((2, 196), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        model = mae2d.create_model(mae2d.mae_vit_large_patch16, seed=3,
                                   img_size=224, in_chans=1, dtype=dtype,
                                   depth=2, decoder_depth=2)
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = model(x, 0.75, noise)[0]
            loss.backward()
            res[impl] = (loss.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()
                                       if p.grad is not None})
        _compare_to_naive(f"MAE 2D ViT-L/16 {str(dtype)[6:]} (2+2 blocks, "
                          f"50 / 197 tokens)", res, dtype, TOL_NAIVE_2D)
        del model, res
        torch.cuda.empty_cache()


# ------------------------------------- phase 18: the pretraining CLI

# the full-width flags of the vitl_joint_pretrain runs: 56 volumes make a
# 2D dataset of 224 images, whose smallest SPL subset (K 0.3) holds 67, so
# the 2D batch stays 64 (4 microbatches of 16)
CLI_JOINT = ["--preset", "vitl_joint_pretrain", "--synthetic",
             "--synthetic_n", "56", "--batch_size", "4"]
# the CLI's first-step loss against the engine's step on the same batch:
# the same kernels on the same inputs in the same order, so bit-equal is
# expected; relative
TOL_CLI_LOSS = 1e-6


class CliProbe:
    """What phase 18 reads from inside a CLI run without changing what the
    run does: for each step, its launches (the counters set to 0 just
    before it), the host clock when it was issued, CUDA events around it,
    its keyword arguments and its metrics; the seconds to build each model
    and to stage each checkpoint; the seconds the main thread waited on
    each loader for each batch (the loader stall), by dataset; and a check
    of the state the run's first step sees.  ``patch(pretrain)`` wraps the
    functions the CLI calls."""

    def __init__(self, torch, _cuda):
        self.torch, self._cuda = torch, _cuda
        self.steps, self.build_s, self.stage_s = [], [], []
        self.waits = []
        self.on_first = None

    def _wrap_step(self, step):
        torch, _cuda = self.torch, self._cuda

        def wrapped(state, *args, **kw):
            if self.on_first is not None:
                self.on_first(state)
                self.on_first = None
            _cuda.reset_launches()
            # the allocator counts on the host as the step is issued, so
            # the peak is read without waiting for the card
            torch.cuda.reset_peak_memory_stats()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            t = time.perf_counter()
            ev[0].record()
            out = step(state, *args, **kw)
            ev[1].record()
            self.steps.append({
                "t": t, "ev": ev, "kw": kw, "out": out[1:],
                "launches": _nonzero(_cuda.launches),
                "peak": torch.cuda.max_memory_allocated() / 2 ** 30})
            return out

        return wrapped

    @contextlib.contextmanager
    def patch(self, pretrain):
        from octcubem_tpu_torch.core import checkpoint
        from octcubem_tpu_torch.data.loader import Loader
        from octcubem_tpu_torch.models import mae2d, mae3d
        from octcubem_tpu_torch.train import mae_engine

        def timed(fn, into):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                into.append(time.perf_counter() - t0)
                return out
            return call

        def waited(iterate):
            def gen(loader):
                it = iterate(loader)
                kind = type(loader.dataset).__name__
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    self.waits.append((kind, time.perf_counter() - t0))
                    yield batch
            return gen

        saved = [(mae_engine, "make_mae_train_step"),
                 (pretrain, "make_2d_step"), (mae3d, "create_model"),
                 (mae2d, "create_model"), (checkpoint, "save_checkpoint"),
                 (Loader, "__iter__")]
        saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
        make3, make2 = saved[0][2], saved[1][2]
        mae_engine.make_mae_train_step = (
            lambda *a, **k: self._wrap_step(make3(*a, **k)))
        pretrain.make_2d_step = lambda *a, **k: self._wrap_step(make2(*a, **k))
        mae3d.create_model = timed(saved[2][2], self.build_s)
        mae2d.create_model = timed(saved[3][2], self.build_s)
        checkpoint.save_checkpoint = timed(saved[4][2], self.stage_s)
        Loader.__iter__ = waited(saved[5][2])
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def take(self):
        """-> (steps, build seconds, staging seconds) since the last take;
        prints the loader stalls."""
        self.torch.cuda.synchronize()
        out = list(self.steps), list(self.build_s), list(self.stage_s)
        stalls = {}
        for kind, sec in self.waits:
            stalls.setdefault(kind, []).append(round(sec * 1e3, 3))
        if stalls:
            print(f"loader stall (ms the main thread waited for each batch, "
                  f"in order) {stalls}")
        for acc in (self.steps, self.build_s, self.stage_s, self.waits):
            acc.clear()
        return out


def _cli_steps(what, steps, want):
    """Every step: ``want`` launches and no other kernel, a finite loss
    (and grad norm).  -> the losses."""
    losses = []
    for i, s in enumerate(steps):
        loss = s["out"][0]["loss"] if isinstance(s["out"][0], dict) \
            else s["out"][0]
        loss = loss.item()
        gn = (s["out"][0]["grad_norm"].item()
              if isinstance(s["out"][0], dict) else 0.0)
        losses.append(loss)
        if s["launches"] != want:
            raise AssertionError(f"{what} step {i + 1}: expected {want} and "
                                 f"no other kernel, got {s['launches']}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"{what} step {i + 1}: loss {loss}, "
                                 f"grad norm {gn}")
    print(f"{what}: {len(steps)} steps, launches {steps[0]['launches']} "
          f"each, losses {[round(v, 6) for v in losses]}")
    return losses


def _cli_times(what, steps, smi, per_epoch):
    """The CLI's step time: the host wall between issuing consecutive
    steps of one epoch, and CUDA events around each step after the
    first -> (host ms list, event ms list)."""
    host = [(steps[i + 1]["t"] - steps[i]["t"]) * 1e3
            for i in range(len(steps) - 1) if (i + 1) % per_epoch]
    events = [s["ev"][0].elapsed_time(s["ev"][1]) for s in steps[1:]]
    print(f"{what} on {smi}: host wall per step (issue to next issue, "
          f"within an epoch) {[round(v, 3) for v in host]} ms; CUDA events "
          f"per step after the first {[round(v, 3) for v in events]} ms; "
          f"peak per step (max_memory_allocated, reset before each) "
          f"{[round(s['peak'], 2) for s in steps]} GiB")
    return host, events


def trace_idle_share(path):
    """(idle share, busy ms, window ms, kernel names) of a Chrome trace:
    the window from its first to its last event, busy the union of its
    device kernels' intervals."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi, _ in kernels:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    window = end - start
    return 1.0 - busy / window, busy / 1e3, window / 1e3, {
        k[2] for k in kernels}


def _cli_engine_loss(torch, pretrain):
    """One make_mae_train_step step at the CLI's seeds (model 0, generator
    1) on the CLI loaders' first batches -> its loss."""
    from octcubem_tpu_torch.data import loader as loader_lib, spl as spl_lib
    from octcubem_tpu_torch.models import mae3d
    from octcubem_tpu_torch.train import mae_engine, optim
    from octcubem_tpu_torch.train.train_state import TrainState

    model = mae3d.create_model(
        mae3d.flash_attn_mae_vit_large_patch16, seed=0, dtype=torch.bfloat16,
        attn_impl="auto", input_size=256, high_res_input_size=512,
        num_frames=60, t_patch_size=3, pred_t_dim=60, norm_pix_loss=False,
        num_heads=16, decoder_num_heads=16, remat=False)
    tx = optim.build_adamw(model, 0.0, 0.05)
    state = TrainState.create(model, tx, seed=1)
    ds2d = pretrain.SyntheticOCT2D(224, 3, 512)
    ds3d = pretrain.SyntheticOCT3D(56, 60, 256, n_names=224)
    ld3 = loader_lib.Loader(ds3d, 4, num_workers=4)
    ld3.set_epoch(0)
    vols = next(iter(ld3))[0]
    ld2 = loader_lib.Loader(spl_lib.SPLState(ds2d.names).subset(ds2d), 64,
                            num_workers=2)
    imgs = next(loader_lib.cycle(ld2))[0]
    step = mae_engine.make_mae_train_step(model, tx, joint=True,
                                          use_premask=True, accum_2d=4)
    x2 = torch.from_numpy(imgs).cuda().reshape(4, 16, 3, 512, 512, 1)
    _, m = step(state, torch.from_numpy(vols).cuda(), mask_ratio=0.9,
                batch2d=x2, mask_ratio_2d=0.75)
    loss = m["loss"].item()
    del model, tx, state, step, m, x2
    torch.cuda.empty_cache()
    return loss


def _log_records(run):
    with open(Path(run) / "log.txt") as f:
        return [json.loads(line) for line in f]


def run_phase18(torch, _cuda, entry_mod, smi):
    """Phase 18: cli/pretrain.py in process on the card, four runs (the
    preset at full width with a profile; --resume latest into a third
    epoch at 2D mask 0.80; training_continue_reset_optim; --mode 2d), then
    the preset again for one step against the engine's step, and
    time_joint's direct step beside the CLI's."""
    import shutil

    from octcubem_tpu_torch.cli import pretrain

    probe = CliProbe(torch, _cuda)
    with tempfile.TemporaryDirectory() as tmp, probe.patch(pretrain):
        free = shutil.disk_usage(tmp).free / 2 ** 30
        print(f"phase 18 scratch {tmp}: {free:.1f} GiB free")
        run1, run3 = str(Path(tmp) / "run1"), str(Path(tmp) / "run3")
        # 18.1 the preset at full width, with a profile
        torch.cuda.empty_cache()
        held_before = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        state1 = pretrain.main(CLI_JOINT + [
            "--epochs", "2", "--steps_per_epoch", "2", "--profile_steps",
            "1", "--output_dir", run1])
        wall = time.perf_counter() - t0
        steps, build_s, stage_s = probe.take()
        peak = max(s["peak"] for s in steps)
        _cli_steps("cli/pretrain.py vitl_joint_pretrain run 1", steps,
                   JOINT_B1_B2)
        host1, ev1 = _cli_times("cli/pretrain.py run 1 (2 epochs x 2 steps)",
                                steps, smi, 2)
        recs = _log_records(run1)
        files = sorted(os.listdir(run1))
        print(f"run 1: {wall:.1f} s in main; model built in "
              f"{build_s[0]:.2f} s; checkpoints staged in "
              f"{[round(v, 2) for v in stage_s]} s; step peak "
              f"(max_memory_allocated) {peak:.2f} GiB, of which "
              f"{held_before:.2f} GiB was held before the run, on {smi}; "
              f"files {files}; log.txt {recs}")
        want = {"args.json", "log.txt", "all_image_dict-0.pkl",
                "all_image_dict-1.pkl", "ckpt", "profile"}
        if not (want <= set(files) and [r["epoch"] for r in recs] == [0, 1]
                and all(math.isfinite(r["train_loss"]) for r in recs)
                and sorted(os.listdir(Path(run1) / "ckpt")) == ["0", "1"]):
            raise AssertionError("run 1 did not write what it should")
        idle, busy, window, names = trace_idle_share(
            Path(run1) / "profile" / "trace.json")
        print(f"run 1 profile (step 2 of epoch 0): idle share {idle:.4f} "
              f"(device busy {busy:.3f} ms in a {window:.3f} ms window) on "
              f"{smi}")
        for body in ("fwd_hopper_kernel", "bwd_hopper_kernel"):
            if not any(body in n for n in names):
                raise AssertionError(f"the CLI's trace names no {body}")
        # 18.2 --resume latest: the saved state bit for bit before the
        # first step, epoch 2 at 2D mask 0.80, the SPL dict reloaded
        restored = []

        def held(state):
            restored.append(_state_equal(torch, state, state1))

        probe.on_first = held
        state2 = pretrain.main(CLI_JOINT + [
            "--epochs", "3", "--steps_per_epoch", "2", "--resume", "latest",
            "--output_dir", run1])
        steps, build_s, stage_s = probe.take()
        _cli_steps("cli/pretrain.py run 2 (resumed, epoch 2)", steps,
                   JOINT_B1_B2)
        host2, ev2 = _cli_times("cli/pretrain.py run 2", steps, smi, 2)
        log = (Path(run1) / "out.log").read_text()
        recs = _log_records(run1)
        masks = {s["kw"]["mask_ratio_2d"] for s in steps}
        print(f"run 2: restored state bit-identical {restored}; 2D mask "
              f"{masks}; log.txt epochs {[r['epoch'] for r in recs]}; model "
              f"built in {build_s[0]:.2f} s; checkpoint staged in "
              f"{[round(v, 2) for v in stage_s]} s on {smi}")
        if not (restored == [True] and masks == {0.8}
                and [r["epoch"] for r in recs] == [0, 1, 2]
                and "all_image_dict-1.pkl (K=" in log):
            raise AssertionError("the resume did not restore the state, "
                                 "reach epoch 2 at mask 0.80 or reload SPL")
        del state1
        # 18.3 training_continue_reset_optim: the saved params, a fresh
        # optimizer, epoch 0
        fresh = []
        live = {k: v for k, v in state2.params.state_dict().items()}

        def reset(state):
            p = state.params.state_dict()
            fresh.append(state.step == 0 and state.tx.count == 0
                         and all(torch.equal(p[k], live[k]) for k in live)
                         and not any(bool(m.any()) for m in
                                     state.tx.mu + state.tx.nu))

        probe.on_first = reset
        state3 = pretrain.main(CLI_JOINT + [
            "--epochs", "1", "--steps_per_epoch", "1", "--resume", run1,
            "--resume_type", "training_continue_reset_optim",
            "--output_dir", run3])
        steps, _, _ = probe.take()
        _cli_steps("cli/pretrain.py run 3 (reset_optim)", steps, JOINT_B1_B2)
        p3 = state3.params.state_dict()
        same = all(torch.equal(p3[k], live[k]) for k in live)
        recs = _log_records(run3)
        print(f"run 3: params equal to the saved ones, fresh optimizer, step "
              f"0 before its step {fresh}; params unmoved by its LR-0 update "
              f"{same}; AdamW count {state3.tx.count}; log.txt epochs "
              f"{[r['epoch'] for r in recs]}")
        if not (fresh == [True] and same and state3.tx.count == 1
                and [r["epoch"] for r in recs] == [0]):
            raise AssertionError("training_continue_reset_optim did not "
                                 "continue the params with a fresh optimizer")
        del state2, state3, live, p3
        shutil.rmtree(run1)
        shutil.rmtree(run3)
        torch.cuda.empty_cache()
        # 18.5 the CLI's first step against the engine's step
        run5 = str(Path(tmp) / "run5")
        pretrain.main(CLI_JOINT + ["--epochs", "1", "--steps_per_epoch", "1",
                                   "--output_dir", run5])
        probe.take()
        [rec] = _log_records(run5)
        shutil.rmtree(run5)
        torch.cuda.empty_cache()
        ref = _cli_engine_loss(torch, pretrain)
        probe.take()
        rel = abs(rec["train_loss"] - ref) / abs(ref)
        print(f"CLI first-step loss {rec['train_loss']!r} vs "
              f"make_mae_train_step {ref!r}: rel {rel:.3e} "
              f"(tol {TOL_CLI_LOSS:.0e})")
        if not rel <= TOL_CLI_LOSS:
            raise AssertionError("the CLI's step computes another loss")
        # 18.4 --mode 2d: the ViT-L/16 2D MAE at 224, batch 16
        run4 = str(Path(tmp) / "run4")
        pretrain.main(["--mode", "2d", "--synthetic", "--synthetic_n", "8",
                       "--epochs", "1", "--output_dir", run4])
        steps, build_s, stage_s = probe.take()
        _cli_steps("cli/pretrain.py --mode 2d", steps, MAE2D_B1_B2)
        ev4 = [s["ev"][0].elapsed_time(s["ev"][1]) for s in steps[1:]]
        print(f"--mode 2d on {smi}: CUDA events per update after the first "
              f"{[round(v, 3) for v in ev4]} ms; model built in "
              f"{build_s[0]:.2f} s; checkpoint staged in "
              f"{[round(v, 2) for v in stage_s]} s; log.txt "
              f"{_log_records(run4)}")
        shutil.rmtree(run4)
    torch.cuda.empty_cache()
    print(f"held before the direct step: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    # the direct step on phase 15's inputs, in the same run
    step, state, x = entry_mod.train_entry(joint=True, batch=4, batch2d=64,
                                           accum_2d=4, use_premask=True)
    direct_ms, direct_peak = time_joint(
        torch, step, state, x, smi, "time_joint's direct step (phase 15's "
        "inputs)")
    del step, state, x
    torch.cuda.empty_cache()
    # run 1 traces its second step: the profiler's start and the traced
    # step are left out of the summary
    print(f"phase 18 summary on {smi}: CLI joint step (unprofiled steps "
          f"after each run's first), CUDA events "
          f"{[round(v, 3) for v in ev1[1:] + ev2]} ms, host wall "
          f"{[round(v, 3) for v in host1[1:] + host2]} ms; direct step "
          f"{direct_ms:.3f} ms (peak {direct_peak:.2f} GiB); CLI run 1 step "
          f"peak {peak:.2f} GiB; idle share {idle:.4f}")


# ------------------------------------- phase 19: the fine-tuning family

FT_B1_B2 = {"flash_fwd_packed": 24, "flash_bwd_packed": 24}
# the multi-task target of every classifier step: normal column 0, then 8
# diseases (16 logits, the octcube_multitask head)
FT_TARGET = [[0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]]
# the CLI runs: the preset at full width on 10 seeded volumes (6 train, 2
# val, 2 test at batch 1), and the SLIViT ct3d preset on 8 / 4 / 4 items
CLI_FT = ["--preset", "octcube_multitask", "--synthetic", "--synthetic_n",
          "10", "--epochs", "1"]


def finetune_flops(d=1024, layers=24, frames=48, img=256, patch=16,
                   tpatch=3, chans=1, batch=1, classes=16) -> float:
    """Analytic FLOPs of one ViT fine-tuning step (fwd + bwd = 3 x fwd)
    over every token + cls; ``frames=None`` for a 2D ViT (vit2d, and
    vit_3dhead's trunk over ``batch`` slices)."""
    grid = (img // patch) ** 2
    l = grid * (frames // tpatch if frames else 1)
    n = l + 1
    pix = (tpatch if frames else 1) * patch * patch * chans
    dense = (layers * 2 * n * 12 * d * d + 2 * l * pix * d + 2 * d * d
             + 2 * d * classes)
    attn = layers * 4 * n * n * d
    return 3.0 * batch * (dense + attn)


def _profiled(torch, fn, tmp, tag):
    """One call of ``fn`` under torch.profiler -> (idle share, busy ms,
    window ms, kernel names, device-to-host copies)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(tmp, f"trace_{tag}.json")
    prof.export_chrome_trace(path)
    idle, busy, window, names = trace_idle_share(path)
    os.remove(path)
    dtoh = sorted({e.name for e in prof.events()
                   if "DtoH" in e.name or "Device -> Host" in e.name})
    return idle, busy, window, names, dtoh


def _ft_state(torch, model, cfg, steps_per_epoch, seed):
    """cli/finetune.py's optimizer for ``model`` under preset ``cfg`` (its
    schedule at blr scaled to batch 1, its layer decay over the rooted
    names) and a TrainState on it."""
    from octcubem_tpu_torch.train import optim, schedules
    from octcubem_tpu_torch.train.train_state import TrainState

    sched = schedules.warmup_half_cosine(
        schedules.scale_base_lr(cfg.blr, 1), cfg.min_lr, cfg.warmup_epochs,
        cfg.epochs, steps_per_epoch)
    tx = optim.build_adamw(
        model, sched, cfg.weight_decay,
        layer_decay=cfg.layer_decay, num_blocks=getattr(model, "depth", 24),
        name_prefix="params.")
    return TrainState.create(model, tx, seed), tx


def convnext_flops(slices=60, img=256, depths=(3, 3, 9, 3),
                   dims=(96, 192, 384, 768), batch=4, head_dim=256) -> float:
    """Analytic FLOPs of one slivit_baseline step (fwd + bwd = 3 x fwd):
    ConvNeXt-tiny on every slice (stem 4x4/4, per block a 7x7 depthwise
    conv and the 4x pointwise MLP, 2x2/2 downsamples) and the head's
    patch projection; the compact ViT's own products are left out (under
    0.1 %)."""
    r = img // 4
    f = 2 * r * r * dims[0] * 4 * 4 * 3
    for stage, (depth, c) in enumerate(zip(depths, dims)):
        if stage:
            r //= 2
            f += 2 * r * r * c * 2 * 2 * dims[stage - 1]
        f += depth * r * r * c * (2 * 49 + 2 * 2 * 4 * c)
    proj = 2 * dims[-1] * r * r * head_dim
    return 3.0 * batch * slices * (f + proj)


def _ft_step(torch, _cuda, step, state, x, y, what, seen, want=FT_B1_B2):
    """One fine-tune step: finite, ``want`` launches and no other kernel;
    the launches read (counters set to 0 just before the step) are
    appended to ``seen``."""
    _cuda.reset_launches()
    state, m = step(state, x, y)
    torch.cuda.synchronize()
    launches = _nonzero(_cuda.launches)
    seen.append(launches)
    loss, gn = m["loss"].item(), m["grad_norm"].item()
    print(f"{what}: loss {loss:.6f} grad_norm {gn:.6f} finite "
          f"{bool(m['finite'])} launches {launches}")
    if not (math.isfinite(loss) and math.isfinite(gn) and bool(m["finite"])):
        raise AssertionError(f"{what}: non-finite loss or grad norm")
    if launches != want:
        raise AssertionError(f"{what}: expected {want} and no other kernel, "
                             f"got {launches}")
    return state, m


def _time_ft(torch, step, state, x, y, smi, what, flops, iters=5):
    """CUDA events over ``iters`` steps after one, and the peak of the
    state held and those steps (counter reset just before)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _elapsed_ms(lambda: step(state, x, y), iters, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bound = flops / PEAK_BF16_FLOPS * 1e3
    print(f"{what} on {smi}: {ms:.3f} ms per step (CUDA events over "
          f"{iters} after 1); bound {bound:.3f} ms ({flops:.3e} FLOP at "
          f"{PEAK_BF16_FLOPS:.3e} FLOP/s); max_memory_allocated "
          f"{peak:.2f} GiB")
    return ms, peak, bound


def _spacing(torch, p):
    """The fp32 spacing above a tensor's largest magnitude."""
    m = p.detach().abs().max()
    return (torch.nextafter(m, m * 2 + 1) - m).item()


def run_ft_multitask(torch, _cuda, smi, tmp):
    """19a: the octcube_multitask step at full width (vit_st aggregate
    head, ViT-L/16 48x256x256, batch 1, bf16 with fp32 params, drop path
    0.2, layer decay 0.65, blr 5e-3 scaled to batch 1, the multi-task
    loss over 16 outputs): three steps (finite; the LR-0 first update
    moves nothing; the next two move every param whose scaled LR can move
    it at all in fp32; 24 B1 + 24 B2 each and no other kernel); one step
    on a NaN volume (params, both moments, the count and the step kept;
    the generator moves on) and the next finite step against a run that
    never took the NaN step (the same loss bit for bit, gradients within
    B2's run-to-run limit); the step's time, peak and trace (idle share,
    no device-to-host copy)."""
    from octcubem_tpu_torch.core.config import PRESETS
    from octcubem_tpu_torch.models import vit_st
    from octcubem_tpu_torch.train import finetune_engine, losses

    cfg = PRESETS["octcube_multitask"]
    gen = torch.Generator(device="cuda").manual_seed(19)
    model = vit_st.create_model(
        vit_st.vit_large_patch16, seed=19, num_frames=cfg.num_frames,
        t_patch_size=cfg.t_patch_size, img_size=cfg.input_size,
        in_chans=cfg.in_chans, num_classes=cfg.num_classes,
        num_heads=cfg.num_heads, drop_path_rate=cfg.drop_path,
        dtype=torch.bfloat16)
    state, tx = _ft_state(torch, model, cfg, 2, 20)
    if tx.lr(0) != 0.0:
        raise AssertionError(f"the schedule's first LR is {tx.lr(0)}")
    step = finetune_engine.make_finetune_train_step(
        model, tx, losses.make_criterion(cfg.task_mode,
                                         smoothing=cfg.smoothing))
    x = torch.rand((1, 48, 256, 256, 1), generator=gen, device="cuda")
    y = torch.tensor(FT_TARGET, device="cuda")
    names = [n for n, _ in model.named_parameters()]
    before = [p.detach().clone() for p in model.parameters()]
    seen = []
    for i in range(3):
        state, m = _ft_step(torch, _cuda, step, state, x, y,
                            f"octcube_multitask step {i + 1} (lr "
                            f"{tx.lr(i):.4e})", seen)
        if i == 0 and not all(torch.equal(a, p) for a, p in
                              zip(before, model.parameters())):
            raise AssertionError("params moved at the first update, whose "
                                 "LR is 0")
    # a param may stay put only where twice its scaled LR is below one fp32
    # spacing at its largest entry: Adam's |u| is at most about 1 at steps
    # 2-3 with these betas (Cauchy-Schwarz over the two or three
    # gradients), so no entry can round to a new value (the early blocks'
    # LayerNorm scales, all 1.0, at 3.9e-6 x 0.65^(24 - i))
    lr_max = max(tx.lr(1), tx.lr(2))
    still, unexplained = [], []
    for n, a, p, s in zip(names, before, model.parameters(), tx.scales):
        if torch.equal(a, p):
            still.append(n)
            if 2 * lr_max * s >= _spacing(torch, p):
                unexplained.append(n)
    moments = all(bool((m != 0).any()) for m in tx.mu + tx.nu)
    print(f"octcube_multitask: {len(names) - len(still)} of {len(names)} "
          f"params moved by steps 2-3 (lr {lr_max:.4e} x layer scales); "
          f"unmoved {still}; every param's moments moved {moments}; count "
          f"{int(tx.count)}")
    if unexplained or not moments or int(tx.count) != 3:
        raise AssertionError(f"params that should have moved did not: "
                             f"{unexplained}")
    del before
    # the NaN step: the whole state kept, the generator moved on
    snap = ([p.detach().clone() for p in model.parameters()],
            [t.clone() for t in tx.mu], [t.clone() for t in tx.nu],
            tx.count.clone(), state.step.clone())
    gen_before = state.generator.get_state()
    bad = x.clone()
    bad[0, 7, 100, 100, 0] = math.nan
    _cuda.reset_launches()
    state, m = step(state, bad, y)
    torch.cuda.synchronize()
    kept = (all(torch.equal(a, p) for a, p in zip(snap[0], model.parameters()))
            and all(torch.equal(a, b) for a, b in zip(snap[1], tx.mu))
            and all(torch.equal(a, b) for a, b in zip(snap[2], tx.nu))
            and torch.equal(snap[3], tx.count)
            and torch.equal(snap[4], state.step))
    moved_gen = not torch.equal(gen_before, state.generator.get_state())
    print(f"octcube_multitask NaN step: loss {m['loss'].item()} finite "
          f"{bool(m['finite'])}; params, mu, nu, count and step kept "
          f"{kept}; generator moved on {moved_gen}; launches "
          f"{_nonzero(_cuda.launches)}")
    if bool(m["finite"]) or not kept or not moved_gen:
        raise AssertionError("the NaN step was not reverted on the device")
    after_nan = state.generator.get_state()
    state, m_a = _ft_step(torch, _cuda, step, state, x, y,
                          "octcube_multitask step after the NaN step", seen)
    loss_a, grads_a = m_a["loss"].clone(), _leaf_grads(model)
    with torch.no_grad():
        for p, s in zip(model.parameters(), snap[0]):
            p.copy_(s)
        for dst, src in ((tx.mu, snap[1]), (tx.nu, snap[2])):
            for a, b in zip(dst, src):
                a.copy_(b)
    tx.count, state.step = snap[3].clone(), snap[4].clone()
    state.generator.set_state(after_nan)
    state, m_b = _ft_step(torch, _cuda, step, state, x, y,
                          "the same step in a run without the NaN step", [])
    same_loss = torch.equal(loss_a, m_b["loss"])
    print(f"after the NaN step vs without it: loss {loss_a.item():.6f} vs "
          f"{m_b['loss'].item():.6f}, bit-identical {same_loss}")
    _grads_agree("after the NaN step vs without it", grads_a,
                 _leaf_grads(model))
    if not same_loss:
        raise AssertionError("the step after the NaN step differs from a run "
                             "without it")
    del snap, grads_a
    flops = finetune_flops()
    ms, peak, bound = _time_ft(torch, step, state, x, y, smi,
                               "octcube_multitask step (ViT-L/16 48x256x256, "
                               "batch 1, bf16)", flops)
    idle, busy, window, _, dtoh = _profiled(
        torch, lambda: step(state, x, y), tmp, "multitask")
    print(f"octcube_multitask step trace on {smi}: idle share {idle:.4f} "
          f"(busy {busy:.3f} of {window:.3f} ms); device-to-host copies "
          f"{dtoh}")
    if dtoh:
        raise AssertionError(f"the fine-tune step reads the device: {dtoh}")
    del state, tx, model, step, x
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "bound": bound, "idle": idle,
            "seen": {"octcube_multitask steps": seen}}


# the octcube_multitask model cut to 2 blocks (4,097 tokens), flash
# against impl="naive" under its multi-task loss: fp32 and the bf16
# gradients at phase 8's limits (TOL_NAIVE).  The bf16 loss is taken from
# 16 bf16 logits (a mean of 8 two-way smoothed CEs), where phase 8's is a
# mean over thousands of bf16 predictions: one bf16 step of one logit
# moves it by ~1e-4 relative.  scripts/ft_naive_spread.py on an H100 at
# 700 W, 7 draws (this one and seeds 0-5): bf16 loss rel 3.9e-5 to
# 1.151e-3 (this draw 3.6e-4), so its limit is ~2.2x the largest.  B1
# broken at run time (scale off by 2^-7, D = 128's scale, no cls key)
# moves the bf16 loss by 5.4e-4 to 7.5e-4, inside that spread: the fp32
# half is what catches it (loss rel 1.5e-5 to 5.5e-4 against draws of at
# most 2.1e-7, gradients 1.1e-2 to 0.54 against at most 1.6e-6).
TOL_NAIVE_FT = {"float32": TOL_NAIVE["float32"],
                "bfloat16": (2.5e-3, TOL_NAIVE["bfloat16"][1])}


def check_ft_vs_naive(torch):
    """19b: the octcube_multitask model cut to 2 blocks at drop path 0,
    batch 1, flash (B1 + B2) against impl="naive": the multi-task loss
    and per-leaf gradients, fp32 and bf16, within TOL_NAIVE_FT."""
    from octcubem_tpu_torch.models import vit_st
    from octcubem_tpu_torch.train import losses

    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.rand((1, 48, 256, 256, 1), generator=gen, device="cuda")
    y = torch.tensor(FT_TARGET, device="cuda")
    crit = losses.make_criterion("multi_task_default")
    for dtype in (torch.float32, torch.bfloat16):
        model = vit_st.create_model(
            vit_st.vit_large_patch16, seed=22, depth=2, num_frames=48,
            img_size=256, in_chans=1, num_classes=16, dtype=dtype).train()
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = crit(model(x), y)
            loss.backward()
            res[impl] = (loss.item(), _leaf_grads(model))
        _compare_to_naive(f"octcube_multitask model {str(dtype)[6:]} (2 "
                          f"blocks, 4,097 tokens)", res, dtype, TOL_NAIVE_FT)
        del model, res
        torch.cuda.empty_cache()


def run_ft_variable_joint(torch, _cuda, smi, tmp):
    """19c: the variable_joint model (high_res_input_size 512: a second
    patch embed, the spatial pos embed stored at the 32 x 32 grid): one
    step on the 48x256x256 stream (4,097 tokens, the table bicubic-pooled
    to 16 x 16), one on the 48x512x512 stream (16,385 tokens); 24 B1 + 24
    B2 each; each stream's time and peak."""
    from octcubem_tpu_torch.core.config import PRESETS
    from octcubem_tpu_torch.models import vit_st
    from octcubem_tpu_torch.train import finetune_engine, losses

    cfg = PRESETS["octcube_multitask"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    model = vit_st.create_model(
        vit_st.vit_large_patch16, seed=23, num_frames=48, img_size=256,
        in_chans=1, num_classes=16, drop_path_rate=cfg.drop_path,
        high_res_input_size=cfg.high_res_input_size, dtype=torch.bfloat16)
    state, tx = _ft_state(torch, model, cfg, 2, 24)
    step = finetune_engine.make_finetune_train_step(
        model, tx, losses.make_criterion(cfg.task_mode))
    y = torch.tensor(FT_TARGET, device="cuda")
    out, seen = {}, {}
    for size in (256, 512):
        x = torch.rand((1, 48, size, size, 1), generator=gen, device="cuda")
        tokens = (size // 16) ** 2 * 16 + 1
        state, _ = _ft_step(torch, _cuda, step, state, x, y,
                            f"variable_joint step, the {size} stream "
                            f"({tokens} tokens)", seen.setdefault(
                                f"variable_joint {tokens}-token step", []))
        res = _time_ft(torch, step, state, x, y, smi,
                       f"variable_joint step, 48x{size}x{size} stream",
                       finetune_flops(img=size), iters=3)
        idle = _profiled(torch, lambda: step(state, x, y), tmp,
                         f"vj{size}")[0]
        print(f"variable_joint {size} stream step trace on {smi}: idle "
              f"share {idle:.4f}")
        out[size] = res + (idle,)
        del x
    del state, tx, model, step
    torch.cuda.empty_cache()
    return out, seen


def run_ft_2d_trunks(torch, _cuda, smi, tmp):
    """19d: vit2d ViT-L/16 at 224, in_chans 1, batch 48, and vit_3dhead
    (ViT-L/16 trunk at 224 over 48 slices, batch 1): one step each through
    the engine (24 B1 + 24 B2 at 197 tokens, no fold; a finite loss), its
    time, peak and trace idle share."""
    from octcubem_tpu_torch.core.config import PRESETS
    from octcubem_tpu_torch.models import registry
    from octcubem_tpu_torch.train import finetune_engine, losses

    gen = torch.Generator(device="cuda").manual_seed(25)
    y = torch.tensor(FT_TARGET, device="cuda")
    out, seen = {}, {}
    for family, shape in (("vit2d", (48, 224, 224, 1)),
                          ("vit_3dhead", (1, 48, 224, 224, 1))):
        model = registry.create_model(
            family, "vit_large_patch16", device="cuda", seed=25, img_size=224,
            in_chans=1, num_classes=16, drop_path_rate=0.2,
            dtype=torch.bfloat16)
        state, tx = _ft_state(torch, model, PRESETS["octcube_multitask"], 2,
                              26)
        step = finetune_engine.make_finetune_train_step(
            model, tx, losses.make_criterion("multi_task_default"))
        x = torch.rand(shape, generator=gen, device="cuda")
        yy = y.expand(shape[0], -1).contiguous()
        state, _ = _ft_step(torch, _cuda, step, state, x, yy,
                            f"{family} ViT-L/16 224 step, input "
                            f"{list(shape)} (197 tokens)",
                            seen.setdefault(f"{family} 197-token step", []))
        res = _time_ft(torch, step, state, x, yy, smi,
                       f"{family} step ({list(shape)}, bf16)",
                       finetune_flops(frames=None, img=224, batch=48), 3)
        idle = _profiled(torch, lambda: step(state, x, yy), tmp, family)[0]
        print(f"{family} step trace on {smi}: idle share {idle:.4f}")
        out[family] = res + (idle,)
        del model, state, tx, step, x
        torch.cuda.empty_cache()
    return out, seen


SLIVIT_HAND = ("fwd_hopper_kernel", "bwd_hopper_kernel", "flash_")


def run_ft_slivit(torch, _cuda, smi, tmp):
    """19e: the slivit_ct3d model (slivit_baseline: the ConvNeXt-tiny trunk
    on 60 slices at 256^2 stacked into one tall image, the compact ViT
    head; batch 4, multi_cls, layer decay 1.0): one step with a finite
    loss, its time and peak, and no hand-written kernel in its profile
    (its attention is the head's torch.matmul softmax); then the ViT-L
    trunk with a SLIViT head at 48x256x256, batch 1: one step, 24 B1 +
    24 B2."""
    from octcubem_tpu_torch.core.config import PRESETS
    from octcubem_tpu_torch.models import slivit
    from octcubem_tpu_torch.train import finetune_engine, losses

    cfg = PRESETS["slivit_ct3d"]
    gen = torch.Generator(device="cuda").manual_seed(27)
    model = slivit.create_model(
        slivit.slivit_baseline, seed=27, num_classes=cfg.num_classes,
        num_frames=cfg.num_frames, img_size=cfg.input_size,
        slivit_depth=cfg.slivit_depth, dtype=torch.bfloat16)
    state, tx = _ft_state(torch, model, cfg, 2, 28)
    step = finetune_engine.make_finetune_train_step(
        model, tx, losses.make_criterion(cfg.task_mode,
                                         smoothing=cfg.smoothing))
    x = torch.rand((cfg.batch_size, cfg.num_frames, cfg.input_size,
                    cfg.input_size, 1), generator=gen, device="cuda")
    y = torch.tensor([0, 1, 1, 0], device="cuda")
    state, _ = _ft_step(torch, _cuda, step, state, x, y,
                        "slivit_ct3d step (4 x 60 x 256 x 256)", [], want={})
    ms, peak, bound = _time_ft(torch, step, state, x, y, smi,
                               "slivit_ct3d step (batch 4, bf16)",
                               convnext_flops(), 3)
    idle, busy, window, names, _ = _profiled(torch, lambda: step(state, x, y),
                                             tmp, "slivit")
    hand = sorted(n for n in names if any(h in n for h in SLIVIT_HAND))
    print(f"slivit_ct3d step trace on {smi}: idle share {idle:.4f} (busy "
          f"{busy:.3f} of {window:.3f} ms), {len(names)} kernel names, "
          f"hand-written kernels {hand}")
    if hand:
        raise AssertionError(f"slivit_baseline launched hand kernels: {hand}")
    del model, state, tx, step, x
    torch.cuda.empty_cache()
    model = slivit.create_model(
        slivit.vit_large_patch16_slivit, seed=29, num_classes=2,
        num_frames=48, t_patch_size=3, img_size=256, in_chans=1,
        drop_path_rate=0.2, dtype=torch.bfloat16)
    state, tx = _ft_state(torch, model, PRESETS["octcube_multitask"], 2,
                          30)
    step = finetune_engine.make_finetune_train_step(
        model, tx, losses.make_criterion("multi_cls"))
    x = torch.rand((1, 48, 256, 256, 1), generator=gen, device="cuda")
    y1 = torch.tensor([1], device="cuda")
    seen = []
    state, _ = _ft_step(torch, _cuda, step, state, x, y1,
                        "vit_large_patch16_slivit step (48x256x256)", seen)
    head = _time_ft(torch, step, state, x, y1, smi,
                    "vit_large_patch16_slivit step (batch 1, bf16)",
                    finetune_flops(), 3)
    idle_head = _profiled(torch, lambda: step(state, x, y1), tmp, "head")[0]
    print(f"vit_large_patch16_slivit step trace on {smi}: idle share "
          f"{idle_head:.4f}")
    head = head + (idle_head,)
    del model, state, tx, step, x
    torch.cuda.empty_cache()
    return {"ct3d": (ms, peak, bound, idle), "head": head,
            "seen": {"ViT-L + SLIViT head step": seen}}


def run_ft_predict(torch, _cuda, smi, tmp):
    """19f: cli/predict.py in process over 6 seeded .npy volumes at
    48x256x256, batch 4 (the tail batch padded): its CSV equals a direct
    vit_st forward of the batches it sent to the card (seeded weights
    as the CLI builds them), the embeddings .npz holds 6 rows, --quant
    int8 answers, and --export_aot then --aot gives the live CSV to 1e-6
    and its embeddings."""
    import csv

    import numpy as np

    from octcubem_tpu_torch.cli import predict
    from octcubem_tpu_torch.core import device as devmod

    root = Path(tmp) / "predict"
    rng = np.random.default_rng(31)
    for i in range(6):
        d = root / "data" / f"p{i}"
        d.mkdir(parents=True)
        np.save(d / "vol.npy", (rng.random((48, 256, 256)) * 255).astype(
            np.float32))
    sent = []
    real = devmod.to_device

    def spy(batch, device):
        t = real(batch, device)
        sent.append(t)
        return t

    def run(tag, extra):
        out = root / tag
        out.mkdir()
        _cuda.reset_launches()
        rows = predict.main([str(root / "data"), "--batch_size", "4",
                             "--out_csv", str(out / "p.csv"),
                             "--dump_embeddings", str(out / "e.npz")] + extra)
        torch.cuda.synchronize()
        with open(out / "p.csv") as f:
            table = list(csv.reader(f))
        return rows, table, np.load(out / "e.npz"), _nonzero(_cuda.launches)

    devmod.to_device = spy
    try:
        t0 = time.perf_counter()
        rows, live, emb, launches = run("live", [])
        wall = time.perf_counter() - t0
    finally:
        devmod.to_device = real
    print(f"cli/predict.py: {len(rows)} rows in {wall:.2f} s, {len(sent)} "
          f"batches of {[list(t.shape) for t in sent]}, launches {launches}, "
          f"header {live[0]}")
    if (len(rows) != 6 or emb["embeddings"].shape != (6, 1024)
            or launches != {"flash_fwd_packed": 24 * len(sent)}):
        raise AssertionError("cli/predict.py: wrong rows, embeddings or "
                             "launches")
    args = predict._parser().parse_args([str(root / "data")])
    model = predict.WithEmbeddings(predict.build_model(args, torch.device(
        "cuda")))
    with torch.inference_mode():
        outs = [model(t) for t in sent]
    logits = torch.cat([o[0] for o in outs])[:6].float().cpu().numpy()
    direct_emb = torch.cat([o[1] for o in outs])[:6].float().cpu().numpy()
    lg = logits.reshape(6, -1, 2)
    e = np.exp(lg - lg.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True))[:, :, 1]
    want = [[f"{v:.4f}" for v in p] for p in probs]
    got = [r[1:] for r in live[1:]]
    demb = float(np.abs(direct_emb - emb["embeddings"]).max())
    print(f"cli/predict.py vs the direct forward: CSV equal {got == want}; "
          f"max|d embedding| {demb:.3e}")
    if got != want or demb > 1e-6:
        raise AssertionError("cli/predict.py's CSV differs from the direct "
                             "forward")
    del model, outs, sent
    _, q, qemb, ql = run("int8", ["--quant", "int8"])
    qprobs = np.array([[float(v) for v in r[1:]] for r in q[1:]])
    lprobs = np.array([[float(v) for v in r[1:]] for r in live[1:]])
    print(f"cli/predict.py --quant int8: {len(q) - 1} rows, launches {ql}, "
          f"max|d prob| vs bf16 {np.abs(qprobs - lprobs).max():.3e}")
    if len(q) != 7 or not np.isfinite(qprobs).all():
        raise AssertionError("cli/predict.py --quant int8 did not answer")
    art = str(root / "m.octaot")
    t0 = time.perf_counter()
    predict.main([str(root / "data"), "--batch_size", "4", "--export_aot",
                  art])
    export_s = time.perf_counter() - t0
    _, a, aemb, al = run("aot", ["--aot", art])
    aprobs = np.array([[float(v) for v in r[1:]] for r in a[1:]])
    demb = float(np.abs(aemb["embeddings"] - emb["embeddings"]).max())
    print(f"cli/predict.py --export_aot in {export_s:.1f} s, --aot: launches "
          f"{al}, max|d prob| vs live {np.abs(aprobs - lprobs).max():.3e}, "
          f"max|d embedding| {demb:.3e}")
    if (a[0] != live[0] or not np.allclose(aprobs, lprobs, rtol=0, atol=1e-6)
            or demb > 1e-6 or al != launches):
        raise AssertionError("the AOT artifact's CSV differs from the live one")
    os.remove(art)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _probe_finetune(probe):
    """Wraps the engine's make_finetune_train_step so that ``probe`` (a
    CliProbe) records each step cli/finetune.py takes."""
    from octcubem_tpu_torch.train import finetune_engine

    make = finetune_engine.make_finetune_train_step
    finetune_engine.make_finetune_train_step = (
        lambda *a, **k: probe._wrap_step(make(*a, **k)))
    try:
        yield probe
    finally:
        finetune_engine.make_finetune_train_step = make


def run_ft_cli(torch, _cuda, smi, tmp, direct_ms):
    """19g: cli/finetune.py in process: the octcube_multitask preset at
    full width on 10 synthetic volumes, one epoch (args.json, log.txt, the
    val and test metric CSVs, ckpt/ at the best epoch, the confusion
    images; 24 B1 + 24 B2 in every step), its step time beside 19a's
    direct step; then the slivit_ct3d preset on a seeded
    nodulemnist3d.npz (8 / 4 / 4 items) for one epoch at its full
    geometry (60 slices at 256^2, batch 4)."""
    import shutil

    import numpy as np

    from octcubem_tpu_torch.cli import finetune

    probe = CliProbe(torch, _cuda)
    run1 = str(Path(tmp) / "ft1")
    with _probe_finetune(probe):
        t0 = time.perf_counter()
        res = finetune.main(CLI_FT + ["--output_dir", run1])
        wall = time.perf_counter() - t0
    steps = probe.take()[0]
    seen = [s["launches"] for s in steps]
    files = sorted(os.listdir(run1))
    _cli_steps("cli/finetune.py octcube_multitask", steps, FT_B1_B2)
    _, ev = _cli_times("cli/finetune.py octcube_multitask (one epoch)",
                       steps, smi, len(steps))
    with open(Path(run1) / "log.txt") as f:
        recs = [json.loads(line) for line in f]
    ckpt = sorted(os.listdir(Path(run1) / "ckpt"))
    pngs = [f for f in files if f.startswith("confusion_test")]
    print(f"cli/finetune.py octcube_multitask on {smi}: {wall:.1f} s in "
          f"main, result {res}; CUDA events per step after the first "
          f"{[round(v, 3) for v in ev]} ms (19a's direct step "
          f"{direct_ms:.3f} ms); log.txt {recs}; ckpt {ckpt}; confusion "
          f"images {len(pngs)}; files {files}")
    want = {"args.json", "log.txt", "macro_metrics_val.csv",
            "macro_metrics_test.csv", "ckpt"}
    if not want <= set(files) or ckpt != ["0"] or not pngs:
        raise AssertionError(f"cli/finetune.py wrote {files}, ckpt {ckpt}")
    for p in pngs:
        with open(Path(run1) / p, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{p} is not a PNG")
    shutil.rmtree(run1)
    # the SLIViT ct3d preset on MedMNIST-layout data
    rng = np.random.default_rng(33)
    npz = Path(tmp) / "nodulemnist3d.npz"
    parts = {}
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        parts[f"{split}_images"] = rng.integers(0, 255, (n, 28, 28, 28),
                                                dtype=np.uint8)
        parts[f"{split}_labels"] = rng.integers(0, 2, (n, 1), dtype=np.int64)
    np.savez(npz, **parts)
    run2 = str(Path(tmp) / "ft2")
    with _probe_finetune(probe):
        t0 = time.perf_counter()
        finetune.main(["--slivit_dataset", "ct3d", "--data_dir", str(npz),
                       "--epochs", "1", "--output_dir", run2])
        wall = time.perf_counter() - t0
    steps = probe.take()[0]
    _cli_steps("cli/finetune.py slivit_ct3d", steps, {})
    files = sorted(os.listdir(run2))
    ev2 = [s["ev"][0].elapsed_time(s["ev"][1]) for s in steps]
    print(f"cli/finetune.py slivit_ct3d on {smi}: {wall:.1f} s in main; "
          f"CUDA events per step {[round(v, 3) for v in ev2]} ms; files "
          f"{files}")
    if not {"macro_metrics_val.csv", "macro_metrics_test.csv",
            "confusion_test.png", "ckpt"} <= set(files):
        raise AssertionError(f"cli/finetune.py slivit_ct3d wrote {files}")
    shutil.rmtree(run2)
    torch.cuda.empty_cache()
    return ev, {"cli/finetune.py octcube_multitask steps": seen}


def run_phase19(torch, _cuda, smi):
    """Phase 19: the fine-tuning family (19a-19g above), on one card;
    checkpoints and artifacts under a temporary directory."""
    try:
        import matplotlib  # noqa: F401
        renderer = "matplotlib"
    except ImportError:
        renderer = "the stdlib PNG grid (no matplotlib)"
    print(f"phase 19: confusion images rendered by {renderer}")
    with tempfile.TemporaryDirectory() as tmp:
        a = run_ft_multitask(torch, _cuda, smi, tmp)
        check_ft_vs_naive(torch)
        vj, vj_seen = run_ft_variable_joint(torch, _cuda, smi, tmp)
        trunks, trunks_seen = run_ft_2d_trunks(torch, _cuda, smi, tmp)
        sl = run_ft_slivit(torch, _cuda, smi, tmp)
        run_ft_predict(torch, _cuda, smi, tmp)
        cli_ev, cli_seen = run_ft_cli(torch, _cuda, smi, tmp, a["ms"])
    print(f"phase 19 summary on {smi} (ms per step, CUDA events; peak GiB; "
          f"bound ms; idle share): octcube_multitask {a['ms']:.3f} / "
          f"{a['peak']:.2f} / {a['bound']:.3f} / {a['idle']:.4f}; "
          f"variable_joint 256 {vj[256][0]:.3f} / {vj[256][1]:.2f} / "
          f"{vj[256][2]:.3f} / {vj[256][3]:.4f}, 512 {vj[512][0]:.3f} / "
          f"{vj[512][1]:.2f} / {vj[512][2]:.3f} / {vj[512][3]:.4f}; vit2d "
          f"{trunks['vit2d'][0]:.3f} / "
          f"{trunks['vit2d'][1]:.2f} / {trunks['vit2d'][2]:.3f} / "
          f"{trunks['vit2d'][3]:.4f}; vit_3dhead "
          f"{trunks['vit_3dhead'][0]:.3f} / {trunks['vit_3dhead'][1]:.2f} / "
          f"{trunks['vit_3dhead'][2]:.3f} / {trunks['vit_3dhead'][3]:.4f}; "
          f"slivit_ct3d {sl['ct3d'][0]:.3f} / {sl['ct3d'][1]:.2f} / "
          f"{sl['ct3d'][2]:.3f} / {sl['ct3d'][3]:.4f}; ViT-L + SLIViT head "
          f"{sl['head'][0]:.3f} / {sl['head'][1]:.2f} / {sl['head'][2]:.3f} / "
          f"{sl['head'][3]:.4f}; the CLI's "
          f"octcube_multitask steps {[round(v, 3) for v in cli_ev]}")
    # for the kernels line: per kernel, each path's launches in each of its
    # checked steps, as the counters read them in this run
    seen = {**a["seen"], **vj_seen, **trunks_seen, **sl["seen"], **cli_seen}
    return {kern: {path: [d.get(kern, 0) for d in steps]
                   for path, steps in seen.items()} for kern in FT_B1_B2}


# ----------------------------------------- phase 20: the COEM contrastive path

# the octcube_ir preset's towers (vitl16_octcube_ir): the OCT ViT-ST-L/16
# at 60x256x256 (5,120 tubes + cls = 5,121 tokens, folded) and the en face
# ViT-L/16 at 384^2 (576 patches + cls = 577, not folded), 16 heads of 64;
# the partition lock at 9 unlocked groups leaves OCT blocks 16-23 and the
# head trainable, so per accumulation chunk: pass 1 runs 24 + 24 B1; pass 2
# runs 24 + 8 recomputed B1 and 8 B2 in the OCT tower, 24 + 24 B1 and 24 B2
# in the en face tower (remat): 128 B1 + 32 B2 a chunk.  The 3-modality
# step runs the en face trunk twice a chunk: 200 B1 + 56 B2.
COEM_CONFIG = "vitl16_octcube_ir"
COEM_3MOD_CONFIG = "vitl16_octcube_ef_3mod"


def coem_launches(accum, three_mod=False):
    per = (200, 56) if three_mod else (128, 32)
    return {"flash_fwd_packed": per[0] * accum,
            "flash_bwd_packed": per[1] * accum}


def vit_fwd_flops(n, layers=24, d=1024, pix=0, l=0):
    """One ViT forward over n tokens: the block projections (2 * n * 12 d^2
    a block), the attention products (4 * n^2 * d a block), the patch
    projection (2 * l * pix * d)."""
    return layers * (2 * n * 12 * d * d + 4 * n * n * d) + 2 * l * pix * d


def coem_flops(pairs, unlocked=8, layers=24, enface_passes=1):
    """Analytic FLOPs of a locked, rematerialised accumulation step over
    ``pairs`` pairs: pass 1 both forwards; pass 2 both forwards again, the
    OCT tower's ``unlocked`` blocks recomputed and differentiated (3x their
    share), every en face block recomputed and differentiated (3x);
    ``enface_passes`` en face images a pair (2 for the 3-modality step)."""
    oct_f = vit_fwd_flops(5121, layers, pix=3 * 16 * 16, l=5120)
    enf_f = vit_fwd_flops(577, layers, pix=16 * 16 * 3, l=576)
    per = (2 * (oct_f + enface_passes * enf_f)
           + 3 * oct_f * unlocked / layers + 3 * enface_passes * enf_f)
    return pairs * per


def _coem_batch(torch, gen, accum, chunk, three_mod=False):
    """Seeded pairs on the card, [accum, chunk, ...]: OCT volumes
    60x256x256x1, en face 384x384x3 (and a second en face image with a
    presence weight for 3-modality)."""
    lead = (accum, chunk)
    b = {"image": torch.rand(lead + (60, 256, 256, 1), generator=gen,
                             device="cuda")}
    if three_mod:
        b["enface1"] = torch.rand(lead + (384, 384, 3), generator=gen,
                                  device="cuda")
        b["enface2"] = torch.rand(lead + (384, 384, 3), generator=gen,
                                  device="cuda")
        b["weight1"] = torch.ones(lead, device="cuda")
        b["weight2"] = (torch.rand(lead, generator=gen, device="cuda")
                        > 0.3).float()
    else:
        b["enface"] = torch.rand(lead + (384, 384, 3), generator=gen,
                                 device="cuda")
    return b


def _coem_state(torch, name, seed, dtype=None, lock=9, lr=None, **kw):
    """A COEM model from its registry config on the card with the
    octcube_ir preset's optimizer: the partition lock at ``lock`` groups,
    AdamW (0.9, 0.98) at the preset's cosine LR (or ``lr``) over the
    trainable params -> (model, tx, state, frozen names)."""
    from octcubem_tpu_torch.core.config import PRESETS
    from octcubem_tpu_torch.models import registry
    from octcubem_tpu_torch.train import optim, schedules
    from octcubem_tpu_torch.train.train_state import TrainState

    cfg = PRESETS["octcube_ir"]
    dtype = torch.bfloat16 if dtype is None else dtype
    model = registry.create_coem_model(name, dtype=dtype, seed=seed, **kw)
    params = dict(model.named_parameters())
    if lock is not None:
        scales = optim.lit_lock_scales(model, model.vision_cfg["depth"], lock)
        params = optim.make_partition(model, {k: s > 0
                                              for k, s in scales.items()})
    sched = (schedules.clip_cosine_lr(cfg.lr, cfg.warmup_steps, 100)
             if lr is None else lr)
    tx = optim.build_adamw(params, sched, cfg.weight_decay,
                           betas=(0.9, 0.98))
    frozen = [k for k in dict(model.named_parameters()) if k not in params]
    return model, tx, TrainState.create(model, tx, seed + 1), frozen


def _coem_step(torch, _cuda, step, state, batch, what, want, seen):
    """One COEM step: finite loss and grad norm, ``want`` launches and no
    other kernel; the launches (counters set to 0 just before the step)
    are appended to ``seen``."""
    _cuda.reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = _nonzero(_cuda.launches)
    seen.append(launches)
    loss, gn = m["loss"].item(), m["grad_norm"].item()
    print(f"{what}: loss {loss:.6f} grad_norm {gn:.6f} launches {launches}")
    if not (math.isfinite(loss) and math.isfinite(gn)):
        raise AssertionError(f"{what}: non-finite loss or grad norm")
    if launches != want:
        raise AssertionError(f"{what}: expected {want} and no other kernel, "
                             f"got {launches}")
    return state, m


def run_coem_steps(torch, _cuda, smi, tmp):
    """20a: the octcube_ir accumulation step at full width and depth
    (vitl16_octcube_ir, bf16 with fp32 params, grad checkpointing, the
    partition lock at 9 groups), chunk 8 x accum_freq 2, three steps:
    finite, 256 B1 + 64 B2 each and no other kernel; the frozen params
    bit for bit and no optimizer moments for them; every trainable param
    moved that its LR can move in fp32; the step's time, peak, trace
    (idle share, no device-to-host copy) and bound.  20b: one step at the
    preset's real size, chunk 32 x accum_freq 4 (512 B1 + 128 B2)."""
    from octcubem_tpu_torch.train import clip_engine

    gen = torch.Generator(device="cuda").manual_seed(20)
    model, tx, state, frozen = _coem_state(torch, COEM_CONFIG, 20,
                                           remat=True)
    step = clip_engine.make_clip_accum_train_step(model, tx, 2)
    batch = _coem_batch(torch, gen, 2, 8)
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    want = coem_launches(2)
    seen = []
    for i in range(3):
        state, _ = _coem_step(torch, _cuda, step, state, batch,
                              f"octcube_ir step {i + 1} (chunk 8 x accum 2, "
                              f"lr {tx.lr(i):.4e})", want, seen)
    params = dict(model.named_parameters())
    frozen_same = all(torch.equal(before[n], params[n]) for n in frozen)
    no_moments = not set(frozen) & set(tx.state_dict()["mu"])
    lr_sum = sum(tx.lr(i) for i in range(3))
    still, unexplained = [], []
    for n in set(names) - set(frozen):
        if torch.equal(before[n], params[n]):
            still.append(n)
            # Adam's |u| is about 1 at the first steps: a param stays put
            # only where the LRs' sum is below its fp32 spacing
            if 2 * lr_sum >= _spacing(torch, params[n]):
                unexplained.append(n)
    print(f"octcube_ir lock: {len(frozen)} of {len(names)} params frozen "
          f"(OCT blocks 0-15, the embeddings), bit-identical after three "
          f"steps {frozen_same}; moments held for {len(tx.names)} params, "
          f"none frozen {no_moments}; trainable unmoved {sorted(still)}")
    if not (frozen_same and no_moments and len(frozen) > 0) or unexplained:
        raise AssertionError(f"the lock failed: frozen kept {frozen_same}, "
                             f"no frozen moments {no_moments}, unexplained "
                             f"unmoved {unexplained}")
    del before
    flops = coem_flops(16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _elapsed_ms(lambda: step(state, batch), 3, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bound = flops / PEAK_BF16_FLOPS * 1e3
    idle, busy, window, _, dtoh = _profiled(
        torch, lambda: step(state, batch), tmp, "coem")
    print(f"octcube_ir step (chunk 8 x accum 2) on {smi}: {ms:.3f} ms per "
          f"step (CUDA events over 3 after 1); bound {bound:.3f} ms "
          f"({flops:.3e} FLOP at {PEAK_BF16_FLOPS:.3e} FLOP/s); "
          f"max_memory_allocated {peak:.2f} GiB; trace idle share "
          f"{idle:.4f} (busy {busy:.3f} of {window:.3f} ms); device-to-host "
          f"copies {dtoh}")
    if dtoh:
        raise AssertionError(f"the COEM step reads the device: {dtoh}")
    # 20b: the preset's real size
    step4 = clip_engine.make_clip_accum_train_step(model, tx, 4)
    del batch
    torch.cuda.empty_cache()
    big = _coem_batch(torch, gen, 4, 32)
    seen_big = []
    state, _ = _coem_step(torch, _cuda, step4, state, big,
                          "octcube_ir step at the preset's size (chunk 32 x "
                          "accum 4)", coem_launches(4), seen_big)
    torch.cuda.reset_peak_memory_stats()
    ms_big = _elapsed_ms(lambda: step4(state, big), 1, 0)
    peak_big = torch.cuda.max_memory_allocated() / 2 ** 30
    bound_big = coem_flops(128) / PEAK_BF16_FLOPS * 1e3
    print(f"octcube_ir step (chunk 32 x accum 4) on {smi}: {ms_big:.3f} ms "
          f"(CUDA events, one step after one); bound {bound_big:.3f} ms; "
          f"max_memory_allocated {peak_big:.2f} GiB")
    del big, state, tx, model, step, step4
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "bound": bound, "idle": idle,
            "ms_big": ms_big, "peak_big": peak_big, "bound_big": bound_big,
            "seen": {"octcube_ir steps (8 x 2)": seen,
                     "octcube_ir step (32 x 4)": seen_big}}


# the accumulated step against the full-batch step at the same params: the
# JAX package's own tolerances (tests/test_coem.py:320-322), loss to 1e-4
# and grad norm to 1e-3 relative.  Every chunk's loss spans the whole
# bank and so the logit scale, whose gradient the summed chunks count
# accum_freq times, as the JAX step and OpenCLIP do: the grad norm sits a
# little above the full batch's (4.4e-4 relative on an H100, PR 12)
TOL_ACCUM = (1e-4, 1e-3)


def check_coem_accum_vs_full(torch):
    """20c: the octcube_ir towers cut to 2 + 2 blocks at full width and
    resolution, fp32, 8 pairs: the accumulation step (chunk 4 x 2, LR 0)
    against the loss and gradient norm of the full batch."""
    from octcubem_tpu_torch.train import clip_engine
    from octcubem_tpu_torch.train.optim import global_norm

    gen = torch.Generator(device="cuda").manual_seed(23)
    cut = _cut_towers(2)
    model, tx, state, _ = _coem_state(torch, COEM_CONFIG, 23,
                                      dtype=torch.float32, lock=None, lr=0.0,
                                      remat=True, **cut)
    batch = _coem_batch(torch, gen, 2, 4)
    model.train()
    img, enf, scale = model(batch["image"].flatten(0, 1),
                            batch["enface"].flatten(0, 1))
    full = clip_engine.clip_loss(img, enf, scale)
    grads = torch.autograd.grad(full, tx.params)
    full_gn = global_norm(grads).item()
    del img, enf, grads
    step = clip_engine.make_clip_accum_train_step(model, tx, 2)
    _, m = step(state, batch)
    dl = abs(m["loss"].item() - full.item()) / abs(full.item())
    dg = abs(m["grad_norm"].item() - full_gn) / full_gn
    print(f"accumulation (4 x 2) vs the full batch of 8, fp32, 2 + 2 blocks: "
          f"loss {m['loss'].item():.7f} vs {full.item():.7f} rel {dl:.3e} "
          f"(tol {TOL_ACCUM[0]:.0e}); grad norm {m['grad_norm'].item():.6f} "
          f"vs {full_gn:.6f} rel {dg:.3e} (tol {TOL_ACCUM[1]:.0e})")
    if not (dl <= TOL_ACCUM[0] and dg <= TOL_ACCUM[1]):
        raise AssertionError("the accumulated step differs from the full "
                             "batch")
    del model, tx, state, step, batch
    torch.cuda.empty_cache()


def _cut_towers(depth):
    """create_coem_model overrides: vitl16_octcube_ir's towers at ``depth``
    blocks each, full width and resolution."""
    import json

    from octcubem_tpu_torch.models import registry

    with open(Path(registry.CONFIG_DIR) / f"{COEM_CONFIG}.json") as f:
        cfg = json.load(f)
    return {"vision_cfg": dict(cfg["vision_cfg"], depth=depth),
            "enface_cfg": dict(cfg["enface_cfg"], depth=depth)}


# COEP2Tower cut to 2 + 2 blocks, flash (B1 + B2) against impl="naive".
# At random init the towers' features are near orthogonal and the CLIP
# loss sits at ln(pairs): its gradient is the residue of near-cancelling
# per-sample terms.  Measured on an H100 at 700 W (PR 12, two draws):
# flash against naive moved those gradients by 1.1e-3 to 1.3e-3 of a
# leaf's largest in fp32 and by 0.5 to 1.2 in bf16, so they tell nothing.
# The gradients held are those of a fixed random projection of both
# towers' normalized features (no cancellation across samples; on the CPU
# the plain versions agree to 5e-7), at phase 8's limits (TOL_NAIVE);
# the CLIP loss itself is held in fp32 at phase 8's limit (measured 0)
# and in bf16 at phase 19's 2.5e-3 (measured 3.4e-6 and 2.6e-5).
TOL_NAIVE_COEM_LOSS = {"float32": TOL_NAIVE["float32"][0],
                       "bfloat16": 2.5e-3}


def check_coem_vs_naive(torch):
    """20d: COEP2Tower at 2 + 2 blocks (full width, 5,121 and 577 tokens),
    4 pairs, flash against impl="naive", fp32 and bf16: the contrastive
    loss (TOL_NAIVE_COEM_LOSS), and the per-leaf gradients of a fixed
    random projection of the two towers' features (TOL_NAIVE)."""
    from octcubem_tpu_torch.models import registry
    from octcubem_tpu_torch.train import clip_engine

    gen = torch.Generator(device="cuda").manual_seed(24)
    batch = _coem_batch(torch, gen, 1, 4)
    x = (batch["image"][0], batch["enface"][0])
    r = torch.randn((2, 512), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        model = registry.create_coem_model(COEM_CONFIG, dtype=dtype, seed=25,
                                           **_cut_towers(2)).train()
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        clip, proj = {}, {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            img, enf, scale = model(*x)
            clip[impl] = clip_engine.clip_loss(img, enf, scale).item()
            obj = (img @ r[0]).sum() + (enf @ r[1]).sum()
            obj.backward()
            proj[impl] = (obj.item(), _leaf_grads(model))
        dl = abs(clip["auto"] - clip["naive"]) / abs(clip["naive"])
        what = (f"COEP2Tower {key} (2 + 2 blocks, 5,121 / 577 tokens, 4 "
                f"pairs)")
        print(f"flash vs naive {what}: CLIP loss {clip['auto']:.8f} vs "
              f"{clip['naive']:.8f}, rel {dl:.3e} (tol "
              f"{TOL_NAIVE_COEM_LOSS[key]:.1e})")
        if dl > TOL_NAIVE_COEM_LOSS[key]:
            raise AssertionError(f"flash and naive disagree: {what}")
        # the projection's value is a readout; its gradients are held
        tols = {key: (math.inf, TOL_NAIVE[key][1])}
        _compare_to_naive(f"{what}, projected features", proj, dtype, tols)
        del model, clip, proj
        torch.cuda.empty_cache()


def run_coem_3mod(torch, _cuda, smi):
    """20e: one vitl16_octcube_ef_3mod accumulation step (chunk 4 x 2,
    bf16, remat, the partition lock): finite, 400 B1 + 112 B2 and no other
    kernel, its time and bound."""
    from octcubem_tpu_torch.train import clip_engine

    gen = torch.Generator(device="cuda").manual_seed(26)
    model, tx, state, _ = _coem_state(torch, COEM_3MOD_CONFIG, 26,
                                      remat=True)
    step = clip_engine.make_clip_accum_train_step_3mod(model, tx, 2)
    batch = _coem_batch(torch, gen, 2, 4, three_mod=True)
    seen = []
    state, _ = _coem_step(torch, _cuda, step, state, batch,
                          "octcube_ef_3mod step (chunk 4 x accum 2)",
                          coem_launches(2, three_mod=True), seen)
    ms = _elapsed_ms(lambda: step(state, batch), 1, 0)
    bound = coem_flops(8, enface_passes=2) / PEAK_BF16_FLOPS * 1e3
    print(f"octcube_ef_3mod step (chunk 4 x accum 2) on {smi}: {ms:.3f} ms "
          f"(CUDA events, one step after one); bound {bound:.3f} ms")
    del model, tx, state, step, batch
    torch.cuda.empty_cache()
    return {"ms": ms, "bound": bound,
            "seen": {"octcube_ef_3mod step (4 x 2)": seen}}


def run_coem_gradcam(torch, _cuda, smi):
    """20f: clip_pair_gradcam at full width (COEP2Tower with capture_cam,
    bf16, one pair): OCT target at layers -1 and 0, a finite [1, 20, 16,
    16] map in [0, 1]; 48 B1 per map and B2 for each OCT block after the
    chosen one (0 at -1, 23 at 0)."""
    import numpy as np

    from octcubem_tpu_torch.models import registry
    from octcubem_tpu_torch.utils.saliency import clip_pair_gradcam

    gen = torch.Generator(device="cuda").manual_seed(27)
    model = registry.create_coem_model(COEM_CONFIG, dtype=torch.bfloat16,
                                       seed=27, capture_cam=True)
    b = _coem_batch(torch, gen, 1, 1)
    x = (b["image"][0], b["enface"][0])
    for layer, b2 in ((-1, 0), (0, 23)):
        _cuda.reset_launches()
        cam = clip_pair_gradcam(model, *x, target="image", layer=layer,
                                grid=(20, 16, 16))
        launches = _nonzero(_cuda.launches)
        ms = _elapsed_ms(lambda: clip_pair_gradcam(
            model, *x, target="image", layer=layer, grid=(20, 16, 16)), 2, 0)
        want = {"flash_fwd_packed": 48, **({"flash_bwd_packed": b2}
                                           if b2 else {})}
        ok = (cam.shape == (1, 20, 16, 16) and np.isfinite(cam).all()
              and cam.min() >= 0 and cam.max() <= 1 and cam.max() > 0)
        print(f"clip_pair_gradcam OCT layer {layer} on {smi}: map "
              f"{cam.shape} in [{cam.min():.3e}, {cam.max():.3e}], "
              f"launches {launches}, {ms:.3f} ms per map (CUDA events over "
              f"2)")
        if not ok or launches != want:
            raise AssertionError(f"clip_pair_gradcam layer {layer}: ok {ok}, "
                                 f"launches {launches} (want {want})")
    del model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _probe_clip(probe):
    """Wraps the engine's contrastive step builders so that ``probe`` (a
    CliProbe) records each step a CLI takes."""
    from octcubem_tpu_torch.train import clip_engine

    names = ("make_clip_train_step", "make_clip_accum_train_step",
             "make_clip_accum_train_step_3mod", "make_clip_cls_train_step")
    saved = {n: getattr(clip_engine, n) for n in names}
    for n, make in saved.items():
        setattr(clip_engine, n, lambda *a, _make=make, **k:
                probe._wrap_step(_make(*a, **k)))
    try:
        yield probe
    finally:
        for n, make in saved.items():
            setattr(clip_engine, n, make)


CLI_RETCLIP = ["--preset", "octcube_ir", "--synthetic", "--synthetic_n",
               "80", "--batch_size", "8"]


def _cli_first_loss(torch):
    """One direct make_clip_accum_train_step step of cli/retclip.py's
    first step: its model (seed 0) and optimizer, its loader's first batch
    (SyntheticPairs, the 0.2 val split, batch 8 x accum 4) -> its loss."""
    import numpy as np

    from octcubem_tpu_torch.cli import retclip
    from octcubem_tpu_torch.core.config import PRESETS
    from octcubem_tpu_torch.core.device import to_device
    from octcubem_tpu_torch.data import loader as loader_lib
    from octcubem_tpu_torch.models import coem
    from octcubem_tpu_torch.train import clip_engine, optim, schedules
    from octcubem_tpu_torch.train.train_state import TrainState

    cfg = PRESETS["octcube_ir"]
    model = coem.create_model(coem.COEP2Tower, seed=cfg.seed,
                              embed_dim=cfg.embed_dim,
                              vision_cfg=dict(cfg.vision_cfg),
                              enface_cfg=dict(cfg.enface_cfg),
                              dtype=torch.bfloat16, remat=True)
    scales = optim.lit_lock_scales(model, 24, cfg.lock_image_unlocked_groups)
    params = optim.make_partition(model, {k: s > 0 for k, s in
                                          scales.items()})
    ds = retclip.SyntheticPairs(80, 60, 256, 384)
    train, _ = retclip._split_train_val(ds, 0.2, cfg.seed)
    ld = loader_lib.Loader(train, 32, num_workers=4, seed=cfg.seed)
    tx = optim.build_adamw(params, schedules.clip_cosine_lr(
        cfg.lr, cfg.warmup_steps, cfg.epochs * len(ld)), cfg.weight_decay,
        betas=(0.9, 0.98))
    state = TrainState.create(model, tx, cfg.seed + 1)
    ld.set_epoch(0)
    vol, enf = next(iter(ld))
    batch = {k: to_device(np.asarray(v, np.float32), torch.device("cuda"))
             .reshape((4, 8) + v.shape[1:])
             for k, v in (("image", vol), ("enface", enf))}
    _, m = clip_engine.make_clip_accum_train_step(model, tx, 4)(state, batch)
    loss = m["loss"].item()
    del model, tx, state, batch
    torch.cuda.empty_cache()
    return loss


def run_coem_cli(torch, _cuda, smi, tmp):
    """20g: cli/retclip.py in process on the octcube_ir preset at full
    width (80 synthetic pairs: 64 train, 16 val; batch 8 x accum 4, two
    steps an epoch): one epoch (params.txt, results.jsonl, the retrieval
    pkl, ckpt/0; 512 B1 + 128 B2 a step), its first loss against one
    direct step on the same batch; --resume latest into a second epoch,
    the state bit for bit before its first step; --evaluate_only with
    --quant int8; --export_aot (48 B1 op calls in the graph, features
    equal to the live model's) and --evaluate_only --aot (metrics equal to
    the live evaluation's).  20h: cli/retclip_finetune.py on
    vitl16_octcube_ef_3mod, synthetic, fp32 as the JAX CLI, the lock, two
    folds of one epoch; the towers of a vitl16_octcube_ir classifier
    initialised from the retclip run (init_towers_from_retclip, its
    geometry check first).  20i: cli/retrieval_eval.py on the dumped
    features with a seeded laterality column."""
    import pickle

    import numpy as np

    from octcubem_tpu_torch.cli import retclip, retclip_finetune, retrieval_eval
    from octcubem_tpu_torch.compat.aot import (flash_op_calls,
                                               load_serving_artifact)
    from octcubem_tpu_torch.core import checkpoint as ckpt_lib
    from octcubem_tpu_torch.models import registry
    from octcubem_tpu_torch.train import clip_engine

    run = str(Path(tmp) / "retclip")
    probe = CliProbe(torch, _cuda)
    with _probe_clip(probe):
        t0 = time.perf_counter()
        retclip.main(CLI_RETCLIP + ["--epochs", "1", "--output_dir", run,
                                    "--save_retrieval_results"])
        wall = time.perf_counter() - t0
    steps = probe.take()[0]
    want = coem_launches(4)
    losses = _cli_steps("cli/retclip.py octcube_ir", steps, want)
    _, ev = _cli_times("cli/retclip.py octcube_ir (one epoch)", steps, smi,
                       len(steps))
    files = sorted(os.listdir(run))
    with open(Path(run) / "results.jsonl") as f:
        rows = [json.loads(line) for line in f]
    print(f"cli/retclip.py octcube_ir on {smi}: {wall:.1f} s in main; files "
          f"{files}; results {rows}")
    if (len(steps) != 2 or not {"params.txt", "results.jsonl",
                                "retrieval_results_0.pkl"} <= set(files)
            or sorted(os.listdir(Path(run) / "ckpt")) != ["0"]):
        raise AssertionError(f"cli/retclip.py: {len(steps)} steps, {files}")
    direct = _cli_first_loss(torch)
    print(f"cli/retclip.py first loss {losses[0]:.7f} vs one direct step on "
          f"its first batch {direct:.7f} (tol {TOL_CLI_LOSS:.0e})")
    if abs(losses[0] - direct) > TOL_CLI_LOSS:
        raise AssertionError("the CLI's first loss differs from the direct "
                             "step's")
    # --resume latest: the state the first resumed step sees is the saved one
    raw, _ = ckpt_lib.restore_raw(str(Path(run) / "ckpt"))
    seen_state = []

    def check(state):
        sd = state.params.state_dict()
        opt = state.tx.state_dict()
        seen_state.append(
            all(torch.equal(sd[k].cpu(), v) for k, v in raw["params"].items())
            and all(torch.equal(opt[m][k].cpu(), v)
                    for m in ("mu", "nu")
                    for k, v in raw["opt_state"][m].items())
            and opt["count"] == raw["opt_state"]["count"]
            and torch.equal(state.generator.get_state(), raw["generator"]))

    probe.on_first = check
    with _probe_clip(probe):
        retclip.main(CLI_RETCLIP + ["--epochs", "2", "--output_dir", run,
                                    "--resume", "latest"])
    resumed = probe.take()[0]
    _cli_steps("cli/retclip.py --resume latest", resumed, want)
    print(f"cli/retclip.py --resume latest: state bit for bit before the "
          f"first step {seen_state}; ckpt {sorted(os.listdir(Path(run) / 'ckpt'))}")
    if seen_state != [True]:
        raise AssertionError("the resumed state differs from the checkpoint")
    steps_all = steps + resumed
    # evaluation: live, int8, an artifact
    ev_args = CLI_RETCLIP + ["--output_dir", run, "--resume", "latest",
                             "--evaluate_only"]
    live = retclip.main(ev_args)
    _cuda.reset_launches()
    q = retclip.main(ev_args + ["--quant", "int8"])
    q_launch = _nonzero(_cuda.launches)
    art = str(Path(tmp) / "coem_encoder.octaot")
    t0 = time.perf_counter()
    retclip.main(CLI_RETCLIP + ["--output_dir", run, "--resume", "latest",
                                "--export_aot", art])
    export_s = time.perf_counter() - t0
    fn, meta = load_serving_artifact(art)
    calls = flash_op_calls(fn.program)
    latest, _ = ckpt_lib.restore_raw(str(Path(run) / "ckpt"))
    model = registry.create_coem_model(COEM_CONFIG, dtype=torch.bfloat16,
                                       state_dict=latest["params"])
    with open(Path(run) / "retrieval_results_0.pkl", "rb") as f:
        pkl = pickle.load(f)
    gen = torch.Generator(device="cuda").manual_seed(28)
    b = _coem_batch(torch, gen, 1, 8)
    x = (b["image"][0], b["enface"][0])
    _cuda.reset_launches()
    got = fn(*x)
    torch.cuda.synchronize()
    art_launch = _nonzero(_cuda.launches)
    with torch.no_grad():
        ref = model(*x)[:2]
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(got, ref))
    aot = retclip.main(ev_args + ["--aot", art])
    print(f"cli/retclip.py evaluation on {smi}: live {live}; int8 {q} "
          f"(launches {q_launch}); artifact exported in {export_s:.1f} s, "
          f"{calls} B1 op calls in its graph, {art_launch} launches, "
          f"features against the live model's max|d| {err:.3e} (tol "
          f"{TOL_AOT:.0e}); --aot {aot}")
    if (calls != 48 or err > TOL_AOT or aot != live
            or art_launch != {"flash_fwd_packed": 48}):
        raise AssertionError("the retrieval artifact differs from the live "
                             "encoder")
    del model, fn, got, ref, b, x
    torch.cuda.empty_cache()
    # 20i: the offline evaluator on the dumped features
    rng = np.random.default_rng(29)
    lat = rng.integers(0, 2, len(pkl["image"]))
    pkl["image_laterality"] = pkl["enface_laterality"] = lat
    lat_pkl = str(Path(tmp) / "retrieval_laterality.pkl")
    with open(lat_pkl, "wb") as f:
        pickle.dump(pkl, f)
    lat_m = retrieval_eval.main([lat_pkl, "--topk", "1", "3", "5"])
    print(f"cli/retrieval_eval.py on the dumped features ({len(lat)} rows, "
          f"seeded laterality): {lat_m}")
    if set(lat_m) != {"laterality_acc@top1", "laterality_acc@top3",
                      "laterality_acc@top5"}:
        raise AssertionError(f"cli/retrieval_eval.py gave {lat_m}")
    # 20h: the classification fine-tune and the tower init
    ft = str(Path(tmp) / "retclip_ft")
    with _probe_clip(probe):
        t0 = time.perf_counter()
        reg = retclip_finetune.main([
            "--model_config", COEM_3MOD_CONFIG, "--synthetic_n", "8",
            "--batch_size", "2", "--k_folds", "2", "--epochs", "1",
            "--lock_image", "--output_dir", ft])
        ft_wall = time.perf_counter() - t0
    ft_steps = probe.take()[0]
    # fp32 without remat: 24 + 2 x 24 B1, 8 + 2 x 24 B2 a step
    ft_want = {"flash_fwd_packed": 72, "flash_bwd_packed": 56}
    _cli_steps("cli/retclip_finetune.py octcube_ef_3mod (fp32)", ft_steps,
               ft_want)
    ft_ev = [s["ev"][0].elapsed_time(s["ev"][1]) for s in ft_steps]
    print(f"cli/retclip_finetune.py on {smi}: {ft_wall:.1f} s in main, "
          f"registry {reg}; CUDA events per step "
          f"{[round(v, 3) for v in ft_ev]} ms; peak "
          f"{[round(s['peak'], 2) for s in ft_steps]} GiB")
    if sorted(reg) != [0, 1]:
        raise AssertionError(f"cli/retclip_finetune.py registry {reg}")
    cls = registry.create_coem_model(COEM_CONFIG, num_classes=2)
    clip_engine.check_retclip_run_geometry(run, cls.vision_cfg,
                                           cls.enface_cfg)
    _, copied = clip_engine.init_towers_from_retclip(cls, run)
    sd = cls.clip.state_dict()
    same = all(torch.equal(sd[k].cpu(), v)
               for k, v in latest["params"].items())
    print(f"init_towers_from_retclip: {copied} tensors from the retclip run, "
          f"equal to its latest checkpoint {same}")
    if not same or copied != len(sd):
        raise AssertionError("the classifier's towers differ from the run's")
    del cls, sd, latest, raw
    torch.cuda.empty_cache()
    return ev, {"cli/retclip.py octcube_ir steps": [
        s["launches"] for s in steps_all],
        "cli/retclip_finetune.py octcube_ef_3mod steps": [
            s["launches"] for s in ft_steps]}


def run_phase20(torch, _cuda, smi):
    """Phase 20: the COEM contrastive path (20a-20i above), on one card;
    checkpoints and artifacts under a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        a = run_coem_steps(torch, _cuda, smi, tmp)
        check_coem_accum_vs_full(torch)
        check_coem_vs_naive(torch)
        three = run_coem_3mod(torch, _cuda, smi)
        run_coem_gradcam(torch, _cuda, smi)
        cli_ev, cli_seen = run_coem_cli(torch, _cuda, smi, tmp)
    print(f"phase 20 summary on {smi} (ms per step, CUDA events; peak GiB; "
          f"bound ms; idle share): octcube_ir 8 x 2 {a['ms']:.3f} / "
          f"{a['peak']:.2f} / {a['bound']:.3f} / {a['idle']:.4f}; 32 x 4 "
          f"{a['ms_big']:.3f} / {a['peak_big']:.2f} / {a['bound_big']:.3f}; "
          f"octcube_ef_3mod 4 x 2 {three['ms']:.3f} / - / "
          f"{three['bound']:.3f}; the CLI's steps "
          f"{[round(v, 3) for v in cli_ev]}")
    seen = {**a["seen"], **three["seen"], **cli_seen}
    return {kern: {path: [d.get(kern, 0) for d in steps]
                   for path, steps in seen.items()}
            for kern in ("flash_fwd_packed", "flash_bwd_packed")}


# ------------------------------------- phase 21: the auxiliary COEM towers

# The main path's pair, in the COEM JSON schema (written to a temporary
# file; the registry's configs stay the JAX package's): HIPT's vit4k_xs
# (mahmoodlab/HIPT, HIPT_4K/vision_transformer4k.py::vit4k_xs: 384-d patch
# features of a 4,096-px region on a 16 x 16 map, 192 wide, 6 blocks of 6
# heads of 32, pos grid 14 x 14 from img_size 224) against OpenCLIP
# ViT-B-16.json's text_cfg (77 tokens, 49,408 ids, 512 wide, 12 blocks of 8
# heads), embed 512
HIPT_PAIR_CFG = {
    "embed_dim": 512,
    "vision_cfg": {"hipt": True, "input_embed_dim": 384,
                   "output_embed_dim": 192, "depth": 6, "num_heads": 6,
                   "img_size": 224},
    "enface_cfg": {"text": True, "context_length": 77, "vocab_size": 49408,
                   "width": 512, "depth": 12, "heads": 8}}
HIPT_PAIRS = 128
# one B1 and one B2 per HIPT block (257 tokens, folded); the text tower's
# attention is plain PyTorch, as in the JAX package
HIPT_PAIR_STEP = {"flash_fwd_packed": 6, "flash_bwd_packed": 6}
# the pair's AdamW: OpenCLIP's defaults (lr 5e-4, wd 0.2, betas 0.9 /
# 0.98), a linear warmup from 0 so that the first update moves nothing
HIPT_LR, HIPT_WARMUP = 5e-4, 10
# report words for SimpleTokenizer's texts
REPORT_WORDS = ("geographic", "atrophy", "drusen", "macula", "fovea",
                "retina", "edema", "hemorrhage", "lesion", "region", "tumor",
                "stroma", "epithelium", "necrosis", "margin", "invasive",
                "carcinoma", "benign", "grade", "2", "3", "mm", ",", ".")


def hipt_pair_flops(pairs, hipt=6, text=12):
    """Analytic FLOPs of one pair step (fwd + bwd = 3 x fwd): the HIPT
    tower (phi over 256 features, 257 tokens x 192 through ``hipt``
    blocks, its head) and the text tower (77 tokens x 512 through ``text``
    blocks with full-square attention products, its projection)."""
    v = vit_fwd_flops(257, hipt, 192, pix=384, l=256) + 2 * 192 * 512
    t = vit_fwd_flops(77, text, 512) + 2 * 512 * 512
    return 3 * pairs * (v + t)


def _write_json(tmp, name, cfg):
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _hipt_pair_batch(torch, gen, pairs, seed):
    """Seeded 16 x 16 x 384 region feature maps and SimpleTokenizer ids of
    seeded report texts (integers, on the card)."""
    import random

    from octcubem_tpu_torch.models.aux_towers import SimpleTokenizer

    rnd = random.Random(seed)
    texts = [" ".join(rnd.choice(REPORT_WORDS)
                      for _ in range(rnd.randint(4, 60)))
             for _ in range(pairs)]
    ids = torch.from_numpy(SimpleTokenizer()(texts)).long().to("cuda")
    return {"image": torch.randn((pairs, 16, 16, 384), generator=gen,
                                 device="cuda"),
            "enface": ids}


def run_hipt_pair(torch, _cuda, smi, tmp):
    """21a: the main path.  The vit4k_xs <-> CLIP-text pair from
    create_coem_model(<json>) at full width, bf16 with fp32 params, 128
    pairs, make_clip_train_step with the port's AdamW: three steps
    (finite loss and grad norm, exactly 6 B1 + 6 B2 each and no other
    kernel, the LR-0 first update moving nothing, every param moved after
    the next two that its LRs can move in fp32); the step's time (CUDA
    events), peak, idle share of a traced step, device time by kernel and
    bound."""
    from octcubem_tpu_torch.models import aux_towers, registry
    from octcubem_tpu_torch.scripts.time_kernels import device_split
    from octcubem_tpu_torch.train import clip_engine, optim
    from octcubem_tpu_torch.train.train_state import TrainState

    path = _write_json(tmp, "hipt_vit4k_xs_clip_text.json", HIPT_PAIR_CFG)
    model = registry.create_coem_model(path, dtype=torch.bfloat16, seed=21)
    if not (isinstance(model.visual, aux_towers.VisionTransformer4K)
            and isinstance(model.enface.tower, aux_towers.TextTransformer)):
        raise AssertionError("the pair's towers are not HIPT ViT-4K and the "
                             "CLIP text transformer")
    tx = optim.build_adamw(
        model, lambda i: HIPT_LR * min(i / HIPT_WARMUP, 1.0), 0.2,
        betas=(0.9, 0.98))
    state = TrainState.create(model, tx, 22)
    step = clip_engine.make_clip_train_step(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = _hipt_pair_batch(torch, gen, HIPT_PAIRS, 21)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []
    for i in range(3):
        state, _ = _coem_step(torch, _cuda, step, state, batch,
                              f"HIPT vit4k_xs <-> CLIP text step {i + 1} "
                              f"({HIPT_PAIRS} pairs, lr {tx.lr(i):.3e})",
                              HIPT_PAIR_STEP, seen)
        if i == 0 and not all(torch.equal(before[n], p) for n, p in
                              model.named_parameters()):
            raise AssertionError("the LR-0 first update moved a param")
    lr_sum = sum(tx.lr(i) for i in range(3))
    still, unexplained = [], []
    for n, p in model.named_parameters():
        if torch.equal(before[n], p):
            still.append(n)
            if 2 * lr_sum >= _spacing(torch, p):
                unexplained.append(n)
    print(f"HIPT pair: {len(before)} params, unmoved after three steps "
          f"{sorted(still)}; batch enface dtype {batch['enface'].dtype}")
    if unexplained:
        raise AssertionError(f"params the updates should move stayed: "
                             f"{unexplained}")
    del before
    flops = hipt_pair_flops(HIPT_PAIRS)
    bound = flops / PEAK_BF16_FLOPS * 1e3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _elapsed_ms(lambda: step(state, batch), 3, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    idle, busy, window, names, dtoh = _profiled(
        torch, lambda: step(state, batch), tmp, "hipt_pair")
    split = device_split(torch, lambda: step(state, batch), 2)
    top = sorted(split["kernels"].items(), key=lambda kv: -kv[1])[:8]
    print(f"HIPT pair step device time by kernel ({split['ms']:.3f} ms a "
          f"step, profiler, 2 steps after 5): "
          + "; ".join(f"{k} {v:.3f}" for k, v in top))
    print(f"HIPT pair step ({HIPT_PAIRS} pairs) on {smi}: {ms:.3f} ms per "
          f"step (CUDA events over 3 after 1); bound {bound:.4f} ms "
          f"({flops:.3e} FLOP at {PEAK_BF16_FLOPS:.3e} FLOP/s); "
          f"max_memory_allocated {peak:.2f} GiB; trace idle share "
          f"{idle:.4f} (busy {busy:.3f} of {window:.3f} ms); device-to-host "
          f"copies {dtoh}")
    del model, tx, state, step, batch
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "bound": bound, "idle": idle,
            "seen": {"HIPT vit4k_xs <-> CLIP text steps (128 pairs)": seen}}


def check_hipt_pair_vs_naive(torch, tmp):
    """21b: the pair with 2 HIPT blocks (and 2 text blocks, whose attention
    is plain either way), 8 pairs, flash (B1 + B2) against impl="naive",
    fp32 and bf16: the CLIP loss (TOL_NAIVE_COEM_LOSS) and the per-leaf
    gradients of a fixed random projection of both features (TOL_NAIVE),
    as phase 20d and for its reason."""
    from octcubem_tpu_torch.models import registry
    from octcubem_tpu_torch.train import clip_engine

    cfg = json.loads(json.dumps(HIPT_PAIR_CFG))
    cfg["vision_cfg"]["depth"] = cfg["enface_cfg"]["depth"] = 2
    path = _write_json(tmp, "hipt_pair_2_blocks.json", cfg)
    gen = torch.Generator(device="cuda").manual_seed(24)
    batch = _hipt_pair_batch(torch, gen, 8, 24)
    r = torch.randn((2, 512), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        model = registry.create_coem_model(path, dtype=dtype,
                                           seed=25).train()
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        clip, proj = {}, {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            img, enf, scale = model(batch["image"], batch["enface"])
            clip[impl] = clip_engine.clip_loss(img, enf, scale).item()
            obj = (img @ r[0]).sum() + (enf @ r[1]).sum()
            obj.backward()
            proj[impl] = (obj.item(), _leaf_grads(model))
        dl = abs(clip["auto"] - clip["naive"]) / abs(clip["naive"])
        what = f"HIPT pair {key} (2 + 2 blocks, 257 / 77 tokens, 8 pairs)"
        print(f"flash vs naive {what}: CLIP loss {clip['auto']:.8f} vs "
              f"{clip['naive']:.8f}, rel {dl:.3e} (tol "
              f"{TOL_NAIVE_COEM_LOSS[key]:.1e})")
        if dl > TOL_NAIVE_COEM_LOSS[key]:
            raise AssertionError(f"flash and naive disagree: {what}")
        tols = {key: (math.inf, TOL_NAIVE[key][1])}
        _compare_to_naive(f"{what}, projected features", proj, dtype, tols)
        del model, clip, proj
        torch.cuda.empty_cache()


# the default HIPT ViT-4K cut to 2 blocks, flash (B3 + B4) against
# impl="naive": its value is a fixed random projection of 8 cls features
# (1,536 terms of either sign), which in bf16 moves with each feature one
# bf16 step apart: measured on an H100 at 700 W, 2.2e-4 relative (fp32 0),
# so the bf16 value is held at phase 20d's loss limit and the gradients at
# phase 8's
TOL_NAIVE_HIPT = {"float32": TOL_NAIVE["float32"],
                  "bfloat16": (TOL_NAIVE_COEM_LOSS["bfloat16"],
                               TOL_NAIVE["bfloat16"][1])}


def _vit4k(torch, dtype, seed, **kw):
    from octcubem_tpu_torch.models import aux_towers, coem

    return coem.create_model(aux_towers.VisionTransformer4K, dtype=dtype,
                             seed=seed, **kw).train()


def run_hipt_default(torch, _cuda, smi):
    """21c: VisionTransformer4K() as the JAX class defaults it (depth 12,
    12 heads of 16), bf16, batch 64: forward and backward (a fixed random
    projection of the cls feature) on a 16 x 16 map (257 tokens, folded:
    12 B3 + 12 B4 and no other kernel) and a 14 x 14 map (197, not
    folded, the pos grid itself: 12 B5 + 12 B7); time and peak; then the
    model cut to 2 blocks, flash against impl="naive", fp32 and bf16, on
    the 16 x 16 map (TOL_NAIVE_HIPT)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    model = _vit4k(torch, torch.bfloat16, 31)
    r = torch.randn((192,), generator=gen, device="cuda")
    seen = {}
    for side, want in ((16, {"flash_fwd_bh_cls": 12, "flash_bwd_bh_cls": 12}),
                       (14, {"flash_fwd_bh": 12, "flash_bwd_bh": 12})):
        x = torch.randn((64, side, side, 384), generator=gen, device="cuda")

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            out = model(x)
            (out.float() @ r).sum().backward()
            return out

        _cuda.reset_launches()
        out = fwd_bwd()
        torch.cuda.synchronize()
        launches = _nonzero(_cuda.launches)
        n = side * side + 1
        what = f"HIPT ViT-4K default (12 x 12 heads of 16) {side}x{side} map"
        finite = bool(torch.isfinite(out.float()).all()) and all(
            bool(torch.isfinite(p.grad.float()).all())
            for p in model.parameters())
        print(f"{what}, batch 64: out {tuple(out.shape)} finite {finite}; "
              f"launches {launches}")
        if launches != want or not finite:
            raise AssertionError(f"{what}: expected {want} and finite, got "
                                 f"{launches}")
        seen[f"HIPT ViT-4K default {side}x{side} (fwd + bwd)"] = [launches]
        torch.cuda.reset_peak_memory_stats()
        ms = _elapsed_ms(fwd_bwd, 5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flops = 3 * 64 * vit_fwd_flops(n, 12, 192, pix=384, l=n - 1)
        print(f"{what} fwd + bwd on {smi}: {ms:.3f} ms (CUDA events over 5 "
              f"after 2); bound {flops / PEAK_BF16_FLOPS * 1e3:.4f} ms; "
              f"max_memory_allocated {peak:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    x = torch.randn((8, 16, 16, 384), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        model = _vit4k(torch, dtype, 32, depth=2)
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = (model(x).float() @ r).sum()
            loss.backward()
            res[impl] = (loss.item(), _leaf_grads(model))
        _compare_to_naive(f"HIPT ViT-4K default {str(dtype)[6:]} (2 blocks, "
                          f"257 tokens, 12 heads of 16)", res, dtype,
                          TOL_NAIVE_HIPT)
        del model, res
        torch.cuda.empty_cache()
    return seen


def _no_hand_kernel(torch, _cuda, what, fn, tmp):
    """One call of ``fn`` with the launch counters at 0 and under the
    profiler: no csrc kernel launched or in the trace, and finite."""
    _cuda.reset_launches()
    _, _, _, names, _ = _profiled(torch, fn, tmp, "aux")
    hand = sorted(k for k in names if any(h in k for h in SLIVIT_HAND))
    if _nonzero(_cuda.launches) or hand:
        raise AssertionError(f"{what}: launched a hand kernel: "
                             f"{_nonzero(_cuda.launches)} {hand}")


def run_towers_without_kernels(torch, _cuda, smi, tmp):
    """21d: the towers with no hand kernel, bf16, each forward and
    backward (a fixed random projection of the output): OpenCLIP RN50.json's
    ModifiedResNet (layers 3, 4, 6, 3, width 64, 32 heads, 224, output
    1,024) at batch 64, in eval and in batch-stats mode (mutable=True);
    focalnet_tiny_srf at 224, batch 64, training mode (drop path 0.2 from
    a generator); the Perceiver at perceiver_base (256 latents x 512, one
    cross layer of 4 heads, 6 self layers of 4) over 8 bags of 4,096
    features of 384 with a pad mask.  Finite, time (CUDA events), peak,
    and no csrc kernel launched or in a profile."""
    from octcubem_tpu_torch.models import aux_towers, coem

    gen = torch.Generator(device="cuda").manual_seed(41)
    bags = torch.randn((8, 4096, 384), generator=gen, device="cuda")
    lengths = torch.randint(2048, 4097, (8,), generator=gen, device="cuda")
    pad = (torch.arange(4096, device="cuda")[None] >= lengths[:, None]).float()
    cases = [
        ("ModifiedResNet RN50 eval", aux_towers.ModifiedResNet,
         dict(layers=(3, 4, 6, 3), output_dim=1024, heads=32,
              image_size=224, width=64), (64, 224, 224, 3), "eval"),
        ("ModifiedResNet RN50 batch stats", aux_towers.ModifiedResNet,
         dict(layers=(3, 4, 6, 3), output_dim=1024, heads=32,
              image_size=224, width=64), (64, 224, 224, 3), "stats"),
        ("focalnet_tiny_srf 224", aux_towers.FocalNetTower,
         dict(out_dim=512, model_name="focalnet_tiny_srf",
              trunk_cfg={"img_size": 224}), (64, 224, 224, 3), "train"),
        ("perceiver_base 8 x 4,096 x 384", aux_towers.PerceiverTower,
         dict(out_dim=512, cfg={"num_image_channels": 384}), None, "eval"),
    ]
    rows = {}
    for what, ctor, kw, shape, mode in cases:
        model = coem.create_model(ctor, dtype=torch.bfloat16, seed=42, **kw)
        model.train(mode != "eval")
        x = (bags if shape is None else
             torch.rand(shape, generator=gen, device="cuda"))
        r = None
        g = torch.Generator(device="cuda").manual_seed(43)

        def call():
            if shape is None:
                return model(x, pad_mask=pad)
            if mode == "stats":
                return model(x, mutable=True)[0]
            return model(x, g)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            out = call()
            (out.float() @ r).sum().backward()
            return out

        r = torch.randn((call().shape[-1],), generator=gen, device="cuda")
        out = fwd_bwd()
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out.float()).all()) and all(
            p.grad is None or bool(torch.isfinite(p.grad.float()).all())
            for p in model.parameters())
        if not finite:
            raise AssertionError(f"{what}: not finite")
        _no_hand_kernel(torch, _cuda, what, fwd_bwd, tmp)
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = _elapsed_ms(lambda: call(), 5)
        ms = _elapsed_ms(fwd_bwd, 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{what} (bf16, {mode}) on {smi}: out {tuple(out.shape)} "
              f"finite; forward {fwd_ms:.3f} ms, forward + backward "
              f"{ms:.3f} ms (CUDA events); max_memory_allocated {peak:.2f} "
              f"GiB; no csrc kernel in its profile")
        rows[what] = (fwd_ms, ms, peak)
        del model, x, out
        torch.cuda.empty_cache()
    return rows


def run_phase21(torch, _cuda, fa, smi, rate):
    """Phase 21: the auxiliary COEM towers (21a-21d above) and the
    head_dim-16 kernels' timings at the default HIPT's shapes.  Returns
    ({counter: {path: [launches per checked step]}}, {kernel: timing row
    at D = 16})."""
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"phase 21: {held:.2f} GiB still allocated on entry (earlier "
          f"phases'), inside each peak below")
    with tempfile.TemporaryDirectory() as tmp:
        pair = run_hipt_pair(torch, _cuda, smi, tmp)
        check_hipt_pair_vs_naive(torch, tmp)
        hipt = run_hipt_default(torch, _cuda, smi)
        rows = run_towers_without_kernels(torch, _cuda, smi, tmp)
    timing = time_bh_kernels(torch, fa, rate, HIPT_BH_PATHS)
    print(f"phase 21 summary on {smi} (ms, CUDA events; peak GiB; bound "
          f"ms; idle share): HIPT pair step {pair['ms']:.3f} / "
          f"{pair['peak']:.2f} / {pair['bound']:.4f} / {pair['idle']:.4f}; "
          + "; ".join(f"{k} fwd {f:.3f} fwd+bwd {b:.3f} / {m:.2f}"
                      for k, (f, b, m) in rows.items()))
    seen = {**pair["seen"], **hipt}
    counters = ("flash_fwd_packed", "flash_bwd_packed", "flash_fwd_bh_cls",
                "flash_bwd_bh_cls", "flash_fwd_bh", "flash_bwd_bh")
    return ({kern: {path: [d.get(kern, 0) for d in steps]
                    for path, steps in seen.items()
                    if any(d.get(kern, 0) for d in steps)}
             for kern in counters}, timing)


# ------------------------------------------ phase 22: the multi-rank paths

# (name, B, n, heads of the shard, D) of B1 / B2 on a flash_tp rank at
# n_tp = 4: the ViT-L encoder (4 of its 16 heads of 64) at the serving
# forward's 4,097 tokens and the MAE encoder's 512 (batch 4); the reference
# decoder (4 of 16 heads of 32) and the vitl_mae_tpu_native decoder (1 of 4
# heads of 128) at 5,121 tokens (batch 4).  Each is the rank's own fused
# buffer [B, n, 3 * heads * D], which flash_tp slices into q, k, v.
TP_SHARDS = (("encoder 4x64 n4097", 1, 4097, 4, 64),
             ("encoder 4x64 n512", 4, 512, 4, 64),
             ("decoder 4x32 n5121", 4, 5121, 4, 32),
             ("decoder 1x128 n5121", 4, 5121, 1, 128))
# (name, model width, heads, B, n) of the n_tp = 4 geometry held one rank's
# body at a time in 22b, at full ViT-L width
TP_GEOMS = (("ViT-L encoder", 1024, 16, 1, 4097),
            ("ViT-L MAE decoder h16", 512, 16, 4, 5121),
            ("ViT-L MAE decoder h4", 512, 4, 4, 5121))
N_TP = 4
# the CLIs on two ranks against one rank fed the global batch: the first
# step's loss (equal params, equal samples and noise) at the bf16 loss
# limit phases 19 and 20 hold a CLI's loss to (TOL_NAIVE_COEM_LOSS); the
# probabilities at one bf16 step of a logit near 1 times p(1 - p) <= 1/4,
# plus the CSV's 4-decimal rounding
TOL_DP_LOSS = 2.5e-3
# 22b's weight gradients are bf16 GEMMs over B * n rows (20,484 in the
# decoders), which cuBLAS reduces in an order that depends on the shape:
# on an H100 at 700 W the decoder h16's out_proj gradient of the rank
# bodies sat 1.98e-2 of its largest from the unsharded one's in three
# runs, with the heads' attention outputs bit-identical between the two
# forms; relative to the largest, ~2.5x that
TOL_TP_WGRAD = 5e-2
TOL_DP_PROB = 2 ** -8 + 1e-4


def check_tp_shards(torch, fa, rate):
    """22b / 22d: B1 and B2 at each TP_SHARDS shape, laid out as flash_tp
    lays them out (column views of the rank's fused buffer), against their
    plain versions at phase 3's limits (B2 twice); then timed: CUDA events
    over the kernel, its plain version, SDPA at the same [B, H, N, D]
    (the backward: SDPA forward + backward minus its forward) and the
    bound -> {"flash_fwd_packed": {name: row}, "flash_bwd_packed": ...}."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = {"flash_fwd_packed": {}, "flash_bwd_packed": {}}
    for name, b, n, h, d in TP_SHARDS:
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        args = _kernel_args(qkv, h)
        cls = args[3] is not None
        scale = d ** -0.5
        o, lse = fa.fwd_packed_cuda(*args, h, scale)
        o_ref, _ = fa.fwd_packed_plain(*args, h, scale)
        fwd_err = (o.float() - o_ref.float()).abs().max().item()
        del o_ref
        do = torch.randn((b, n, h * d), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        do = do[:, 1:] if cls else do
        dqkv = torch.zeros_like(qkv)
        out = _kernel_args(dqkv, h)
        bwd_err = _check_main_path_shape(torch, fa, f"flash_tp shard {name}",
                                         args, o, lse, do, out, h, scale)
        m = n - 1 if cls else n
        keys = m + 1 if cls else m
        qh, kh, vh = (t.contiguous().requires_grad_() for t in
                      qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
        g = torch.randn((b, h, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        sdpa_fwd = _elapsed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 20)
        sdpa_all = _elapsed_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            (qh, kh, vh), g), 20)
        fwd = {"max_abs_err": fwd_err,
               "ms": _elapsed_ms(lambda: fa.fwd_packed_cuda(*args, h, scale),
                                 20),
               "plain_ms": _elapsed_ms(lambda: fa.fwd_packed_plain(
                   *args, h, scale), 3, 1),
               "library_ms": sdpa_fwd}
        fwd["bound_ms"], fwd["bound_by"] = bound(*fwd_work(b, h, m, keys, d),
                                                 rate)
        es = qkv.element_size()
        flops = 10 * b * h * m * keys * d
        nbytes = (8 * b * m * h * d * es + b * h * m * 4
                  + (4 * b * h * d * es if cls else 0))
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bwd = {"max_abs_err": bwd_err,
               "ms": _elapsed_ms(lambda: fa.bwd_packed_cuda(
                   *args, o, lse, do, None, h, scale, out=out), 20),
               "plain_ms": _elapsed_ms(lambda: fa.bwd_packed_plain(
                   *args, o, lse, do, None, h, scale), 3, 1),
               "library_ms": sdpa_all - sdpa_fwd,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        for kern, row in (("B1", fwd), ("B2", bwd)):
            print(f"{kern} flash_tp shard {name} B={b} H={h} N={n} D={d} "
                  f"bf16: max|d| vs plain {row['max_abs_err']:.3e}; kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"by {row['bound_by']}")
        rows["flash_fwd_packed"][name] = fwd
        rows["flash_bwd_packed"][name] = bwd
        del qkv, args, o, lse, do, dqkv, out, qh, kh, vh, g
        torch.cuda.empty_cache()
    return rows


def run_tp_one_rank(torch, _cuda, entry_mod):
    """22a: attn_impl="flash_tp" on a one-rank NCCL group formed by
    core/multihost.initialize: entry()'s ViT-L classifier forward (its
    weights through shard_tp_params) against flash, then three MAE steps
    per decoder geometry against flash from the same state (step 1's
    loss and Wqkv gradient of block 0).  Returns the launches per step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.parallel.tensor import (shard_tp_params,
                                                    use_tensor_parallel)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    multihost.initialize(store=dist.FileStore(f"{tmp}/store", 1),
                         world_size=1, rank=0, device="cuda")
    seen = {}
    try:
        print(f"22a: one-rank group, backend {dist.get_backend()}, "
              f"{multihost.summary()}")
        if dist.get_backend() != "nccl":
            raise AssertionError("the one-rank group is not NCCL")
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("tp",))
        fn, (model, x) = entry_mod.entry(attn_impl="flash_tp")
        shard_tp_params(model, mesh)
        _cuda.reset_launches()
        with use_tensor_parallel(mesh):
            logits = fn(model, x)
        torch.cuda.synchronize()
        launches = _nonzero(_cuda.launches)
        del model
        ref_fn, (ref, _) = entry_mod.entry()
        want = ref_fn(ref, x)
        del ref
        err = (logits.float() - want.float()).abs().max().item()
        print(f"22a entry() ViT-L 48x256x256 flash_tp vs flash: max|dlogits| "
              f"{err:.3e} (tol {TOL_LOGITS:.0e}), launches {launches}")
        if err > TOL_LOGITS or launches != {"flash_fwd_packed": 24}:
            raise AssertionError("flash_tp's classifier forward")
        seen["classifier forward"] = [launches["flash_fwd_packed"]]
        for dec_heads in (16, 4):
            runs = {}
            for impl in ("flash_tp", "auto"):
                step, state, x = entry_mod.train_entry(dec_heads=dec_heads,
                                                       batch=4, attn_impl=impl)
                losses, counts = [], []
                for i in range(3):
                    _cuda.reset_launches()
                    with use_tensor_parallel(mesh):
                        state, m = step(state, x, mask_ratio=0.9)
                    torch.cuda.synchronize()
                    counts.append(_nonzero(_cuda.launches))
                    losses.append(m["loss"].item())
                    if i == 0:
                        g = state.params.blocks[0].mixer.Wqkv.weight.grad
                        runs[impl] = (losses, counts, g.clone())
                del step, state, x
                torch.cuda.empty_cache()
            (lt, ct, gt), (lf, _, gf) = runs["flash_tp"], runs["auto"]
            dloss = abs(lt[0] - lf[0]) / abs(lf[0])
            dgrad = ((gt - gf).abs().max() / gf.abs().max()).item()
            print(f"22a MAE dec_heads={dec_heads} flash_tp: losses "
                  f"{[round(v, 6) for v in lt]} (flash {[round(v, 6) for v in lf]}), "
                  f"step 1 rel dloss {dloss:.3e} (tol "
                  f"{TOL_NAIVE['bfloat16'][0]:.1e}), blocks.0.mixer.Wqkv "
                  f"grad rel {dgrad:.3e} (tol {TOL_RUN_TO_RUN:.1e}), launches "
                  f"per step {ct}")
            want = {"flash_fwd_packed": 32, "flash_bwd_packed": 32}
            if (dloss > TOL_NAIVE["bfloat16"][0] or dgrad > TOL_RUN_TO_RUN
                    or any(c != want for c in ct)):
                raise AssertionError(f"flash_tp's MAE step, dec_heads "
                                     f"{dec_heads}")
            for kern in want:
                seen[f"MAE dec_heads={dec_heads} {kern}"] = [
                    c[kern] for c in ct]
        return seen
    finally:
        multihost.shutdown()


def run_tp_geometry(torch, _cuda, fa):
    """22b: the n_tp = 4 geometry one rank's body at a time on one card,
    at full ViT-L width: a block's attention and its MLP, each with its
    projections split by shard_tp_params' rule (each rank the rows of its
    heads in each of q, k, v and their out_proj columns; fc1's rows and
    fc2's columns), each rank's heads through flash_attention_packed
    (head_parallel_attention's body), the row-parallel partial products
    summed in fp32 (what the all-reduce gives) and the bias added once,
    then one rounding to bf16; each rank reads its own copy of the input,
    whose gradients are summed in fp32 (the column-parallel input's
    all-reduce).  Held against the unsharded sublayer: the output at
    phase 3's bf16 limit and, under one backward, the input's gradient at
    B2's and every weight's at TOL_TP_WGRAD.  Returns the launches."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.nn.layers import MHA, Mlp
    from octcubem_tpu_torch.parallel.tensor import _tp_split

    gen = torch.Generator(device="cuda").manual_seed(23)
    seen = {}

    def part(lin, x, pname, r, row):
        idx = _tp_split(pname, lin.weight.shape, N_TP, r)[1].cuda()
        if row:
            return F.linear(x, lin.weight.index_select(1, idx).bfloat16())
        return F.linear(x, lin.weight.index_select(0, idx).bfloat16(),
                        lin.bias.index_select(0, idx).bfloat16())

    def reduce(parts, lin):
        return (sum(p.float() for p in parts) + lin.bias.float()).bfloat16()

    for name, dim, heads, b, n in TP_GEOMS:
        torch.manual_seed(24)
        mha = MHA(dim, heads, dtype=torch.bfloat16).cuda()
        mlp = Mlp(dim, 4 * dim, dim, torch.bfloat16).cuda()

        seen_a = {}

        def attn_tp(xs):
            parts, heads_out = [], []
            for r, x in enumerate(xs):
                qkv = part(mha.Wqkv, x, "mixer.Wqkv.weight", r, False)
                hd = qkv.shape[-1] // 3
                a = fa.flash_attention_packed(
                    qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                    heads // N_TP)
                heads_out.append(a.detach())
                parts.append(part(mha.out_proj, a, "mixer.out_proj.weight",
                                  r, True))
            seen_a["tp"] = torch.cat(heads_out, dim=-1)
            return reduce(parts, mha.out_proj)

        mha.out_proj.register_forward_pre_hook(
            lambda _, args: seen_a.__setitem__("flash", args[0].detach()))

        def mlp_tp(xs):
            return reduce([part(mlp.fc2, F.gelu(part(
                mlp.fc1, x, "mlp.fc1.weight", r, False)), "mlp.fc2.weight",
                r, True) for r, x in enumerate(xs)], mlp.fc2)

        for sub, module, sharded, want in (
                ("attention", mha, attn_tp, {"flash_fwd_packed": N_TP,
                                             "flash_bwd_packed": N_TP}),
                ("MLP", mlp, mlp_tp, {})):
            x0 = torch.randn((b, n, dim), generator=gen, device="cuda",
                             dtype=torch.bfloat16)
            g = torch.randn((b, n, dim), generator=gen, device="cuda")
            names = ["input"] + [k for k, _ in module.named_parameters()]
            params = list(module.parameters())
            res = {}
            for label, fn in (("tp", sharded), ("flash", module)):
                xs = [x0.clone().requires_grad_()
                      for _ in range(N_TP if label == "tp" else 1)]
                for p in params:
                    p.grad = None
                _cuda.reset_launches()
                out = fn(xs) if label == "tp" else fn(xs[0])
                (out.float() * g).sum().backward()
                torch.cuda.synchronize()
                dx = sum(t.grad.float() for t in xs)
                res[label] = (out.detach(), [dx] + [p.grad.clone()
                                                    for p in params],
                              _nonzero(_cuda.launches))
            (o_t, g_t, l_t), (o_f, g_f, l_f) = res["tp"], res["flash"]
            err = _hold(torch, f"22b {name} {sub} output", o_t, o_f,
                        torch.bfloat16)
            rels = {k: ((a.float() - r.float()).abs().max()
                        / r.float().abs().max().clamp_min(1e-30)).item()
                    for k, a, r in zip(names, g_t, g_f)}
            d_in = rels.pop("input")
            leaf = max(rels, key=rels.get)
            worst = rels[leaf]
            if sub == "attention":
                da = (seen_a["tp"].float() - seen_a["flash"].float()).abs()
                amax = seen_a["flash"].float().abs().max().item()
                print(f"22b {name}: the heads' attention output, the rank "
                      f"bodies' against the unsharded one: max|da| "
                      f"{da.max().item():.3e} of max|a| {amax:.3e}, "
                      f"elements differing {int((da > 0).sum())} of "
                      f"{da.numel()}")
            print(f"22b n_tp={N_TP} {name} {sub} (width {dim}, {heads} "
                  f"heads, B={b}, n={n}) bf16, {N_TP} rank bodies vs the "
                  f"unsharded sublayer: max|dout| {err:.3e}; the input's "
                  f"gradient rel {d_in:.3e} (tol {TOL_GRAD['bfloat16']:.1e}),"
                  f" the weights' worst {worst:.3e} ({leaf}; tol "
                  f"{TOL_TP_WGRAD:.0e}); launches {l_t} vs {l_f}")
            if (d_in > TOL_GRAD["bfloat16"] or worst > TOL_TP_WGRAD
                    or l_t != want):
                raise AssertionError(f"22b: the n_tp geometry of {name} "
                                     f"{sub}")
            if want:
                seen[name] = l_t
            del res, x0, g
        del mha, mlp
        torch.cuda.empty_cache()
    return seen


def _global_order(world, chunks_of):
    """A Loader._indices for one rank serving the global batches ``world``
    ranks assemble (each rank's local batch, its stride of the
    permutation, in rank order; chunk by chunk where ``chunks_of(loader)``
    > 1, as the feature-cached accumulation splits a batch).  Loaders
    that do not shuffle (the eval splits) keep their order."""
    import numpy as np

    from octcubem_tpu_torch.data.loader import Loader

    plain = Loader._indices

    def _indices(self):
        idx = plain(self)
        if not self.shuffle:
            return idx
        per = [idx[r::world][:len(idx) // world] for r in range(world)]
        b = self.batch_size // world
        m = b // chunks_of(self)
        out = [per[r][i * b + c * m:i * b + (c + 1) * m]
               for i in range(len(per[0]) // b)
               for c in range(chunks_of(self)) for r in range(world)]
        return np.concatenate(out) if out else idx[:0]

    return _indices


def _gloo_clis(tmp, world):
    """(name, module, argv, the one-rank run's argv, accumulation chunks)
    of 22c's CLI runs; the per-rank batches are the comment's."""
    from octcubem_tpu_torch.core.config import PRESETS
    import dataclasses

    # vitl_joint_pretrain at full width: 2 volumes and 8 2D images a rank
    # (the 2D batch whole, accum_2d 1), 16 synthetic volumes (the 2D SPL
    # subset's 19 hold the one-rank run's 16), one epoch of two steps
    pre = dataclasses.asdict(PRESETS["vitl_joint_pretrain"])
    pre.update(accum_2d=1, epochs=1)
    cfgs = {}
    for b, b2 in ((2, 8), (2 * world, 8 * world)):
        cfgs[b] = _write_json(tmp, f"pre{b}.json",
                              dict(pre, batch_size=b, batch_size_2d=b2))
    # the same preset with n_sp = world: both ranks hold the same 2 volumes
    # and 8 2D images, every stack's tokens split over them
    cfgs["sp"] = _write_json(tmp, "pre_sp.json", dict(
        pre, batch_size=2, batch_size_2d=8, n_sp=world,
        attn_impl="flash_sp"))
    ret = _write_json(tmp, "ret.json", dict(dataclasses.asdict(
        PRESETS["octcube_ir"]), accum_freq=2, epochs=1))
    data = Path(tmp) / "predict"
    import numpy as np
    rng = np.random.default_rng(32)
    for i in range(5):
        d = data / f"p{i}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "vol.npy", (rng.random((48, 256, 256)) * 255).astype(
            np.float32))

    def pretrain(b, out, cfg=None):
        return ["--preset", cfg or cfgs[b], "--synthetic", "--synthetic_n",
                "16", "--steps_per_epoch", "2", "--output_dir", out]

    def retclip(b, out):
        # octcube_ir at full width, 4 pairs a rank x accum_freq 2
        return ["--preset", ret, "--synthetic", "--synthetic_n", "40",
                "--batch_size", str(b), "--output_dir", out]

    def predict(out, n_data):
        return [str(data), "--batch_size", "2", "--n_data", str(n_data),
                "--out_csv", f"{out}/p.csv", "--dump_embeddings",
                f"{out}/e.npz"]

    return [
        ("pretrain", "pretrain", pretrain(2, f"{tmp}/two/pretrain"),
         pretrain(2 * world, f"{tmp}/one/pretrain"), 1),
        ("retclip", "retclip", retclip(4, f"{tmp}/two/retclip"),
         retclip(4 * world, f"{tmp}/one/retclip"), 2),
        ("predict", "predict", predict(f"{tmp}/two", world),
         predict(f"{tmp}/one", 1), 1),
        ("pretrain_sp", "pretrain",
         pretrain(2, f"{tmp}/two/pretrain_sp", cfgs["sp"]),
         pretrain(2, f"{tmp}/one/pretrain_sp"), 1)]


def _gloo_rank(rank, world, tmp):
    """22c's rank: a gloo group with the other rank on cuda:0 (NCCL
    refuses two ranks on one device), then each CLI in process; what it
    measured goes to tmp/rank{rank}.json."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from octcubem_tpu_torch.cli import pretrain, predict, retclip
    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.ops import _cuda

    mods = {"pretrain": pretrain, "retclip": retclip, "predict": predict}
    multihost.initialize(store=dist.FileStore(f"{tmp}/store", world),
                         world_size=world, rank=rank, local_rank=0,
                         backend="gloo", device="cuda", timeout_s=300)
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    try:
        reduce_ms = []
        plain_reduce = multihost.all_reduce_mean

        def timed_reduce(*a, **k):
            t0 = time.perf_counter()
            res = plain_reduce(*a, **k)
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
            return res

        multihost.all_reduce_mean = timed_reduce
        probe = CliProbe(torch, _cuda)
        for name, mod, argv, _, _ in _gloo_clis(tmp, world):
            os.makedirs(f"{tmp}/two/{name}", exist_ok=True)
            reduce_ms.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if name == "predict":
                _cuda.reset_launches()
                rows = mods[mod].main(argv)
                torch.cuda.synchronize()
                out[name] = {"rows": rows,
                             "launches": _nonzero(_cuda.launches)}
            else:
                ctx = (probe.patch(pretrain) if mod == "pretrain"
                       else _probe_clip(probe))
                with ctx:
                    mods[mod].main(argv)
                steps, _, _ = probe.take()
                out[name] = {
                    "losses": [s["out"][0]["loss"].item() for s in steps],
                    "launches": [s["launches"] for s in steps],
                    "host_ms": [(steps[i + 1]["t"] - steps[i]["t"]) * 1e3
                                for i in range(len(steps) - 1)],
                    "event_ms": [s["ev"][0].elapsed_time(s["ev"][1])
                                 for s in steps],
                    "reduce_ms": list(reduce_ms)}
            out[name]["wall_s"] = time.perf_counter() - t0
            out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            dist.barrier()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        multihost.shutdown()


def run_gloo_clis(torch, _cuda, smi):
    """22c: cli/pretrain.py, cli/retclip.py and cli/predict.py on two gloo
    ranks sharing cuda:0 (spawned, a FileStore, backend="gloo" given
    explicitly), each against the same CLI on one rank (this process) fed
    the global batch: per step the launches, the first step's loss, the
    step time with the gloo all-reduce's host time apart (gloo stages
    through the host: not NCCL's time), each rank's peak; predict's CSV
    and embeddings.  Returns the launches per step."""
    import csv

    import numpy as np
    import torch.multiprocessing as mp

    from octcubem_tpu_torch.cli import pretrain, predict, retclip
    from octcubem_tpu_torch.data.loader import Loader

    world = 2
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + 400  # they take about a minute
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    print(f"22c: {world} gloo ranks on cuda:0 ran the CLIs in "
          f"{time.perf_counter() - t0:.1f} s, exit codes {codes}")
    if codes != [0] * world:
        raise AssertionError(f"22c: rank exit codes {codes}")
    ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
             for r in range(world)]
    print(f"22c: backend {[r['backend'] for r in ranks]}, devices "
          f"{[r['device'] for r in ranks]}")
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("22c ran on another backend than gloo")
    seen = {}
    probe = CliProbe(torch, _cuda)
    mods = {"pretrain": pretrain, "retclip": retclip, "predict": predict}
    for name, mod, _, argv1, chunks in _gloo_clis(tmp, world):
        os.makedirs(f"{tmp}/one/{name}", exist_ok=True)
        sp = name == "pretrain_sp"  # one data index: the ranks' batch
        plain = Loader._indices
        Loader._indices = _global_order(
            1 if sp else world, lambda ld, c=chunks: c)
        try:
            if name == "predict":
                _cuda.reset_launches()
                predict.main(argv1)
                torch.cuda.synchronize()
                one_launches = _nonzero(_cuda.launches)
            else:
                ctx_ = (probe.patch(pretrain) if mod == "pretrain"
                        else _probe_clip(probe))
                with ctx_:
                    mods[mod].main(argv1)
                steps, _, _ = probe.take()
        finally:
            Loader._indices = plain
        if name == "predict":
            with open(f"{tmp}/one/p.csv") as f:
                want = list(csv.reader(f))
            with open(f"{tmp}/two/p.csv") as f:
                got = list(csv.reader(f))
            dprob = float(np.abs(
                np.asarray([r[1:] for r in got[1:]], float)
                - np.asarray([r[1:] for r in want[1:]], float)).max())
            demb = float(np.abs(np.load(f"{tmp}/one/e.npz")["embeddings"]
                                - np.load(f"{tmp}/two/e.npz")["embeddings"])
                         .max())
            per_rank = [r[name]["launches"] for r in ranks]
            print(f"22c cli/predict.py --n_data {world} (batch 2, one volume "
                  f"a rank a batch, 5 volumes) vs one rank: ids equal "
                  f"{[r[0] for r in got] == [r[0] for r in want]}, max|d "
                  f"prob| {dprob:.3e} (tol {TOL_DP_PROB:.2e}), max|d "
                  f"embedding| {demb:.3e}; launches per rank {per_rank} "
                  f"(one rank {one_launches}); rows returned on every rank "
                  f"{all(r[name]['rows'] == got[1:] for r in ranks)}; wall "
                  f"{[round(r[name]['wall_s'], 1) for r in ranks]} s")
            if ([r[0] for r in got] != [r[0] for r in want]
                    or len(got) != 6 or dprob > TOL_DP_PROB
                    or any(r[name]["rows"] != got[1:] for r in ranks)
                    or any(c != {"flash_fwd_packed": 24 * 3}
                           for c in per_rank)):
                raise AssertionError("22c: cli/predict.py on two ranks")
            seen[f"predict --n_data {world} per rank"] = [
                c["flash_fwd_packed"] for c in per_rank]
            continue
        one = {"losses": [s["out"][0]["loss"].item() for s in steps],
               "launches": [s["launches"] for s in steps]}
        got = ranks[0][name]
        dloss = abs(got["losses"][0] - one["losses"][0]) / abs(
            one["losses"][0])
        what = {"pretrain": "vitl_joint_pretrain at full width, 2 volumes "
                            "and 8 2D images a rank",
                "retclip": "octcube_ir at full width, 4 pairs x accum_freq "
                           "2 a rank",
                "pretrain_sp": f"vitl_joint_pretrain at n_sp {world}, the "
                               f"same 2 volumes and 8 2D images on each "
                               f"rank, flash_sp (B5 / B7)"}[name]
        print(f"22c cli/{name}.py on {world} gloo ranks ({what}) vs one rank "
              f"on the global batch: losses "
              f"{[round(v, 6) for v in got['losses']]} vs "
              f"{[round(v, 6) for v in one['losses']]}, step 1 rel dloss "
              f"{dloss:.3e} (tol {TOL_DP_LOSS:.1e}); launches per step "
              f"{got['launches']} (one rank {one['launches']})")
        for r, rk in enumerate(ranks):
            res = rk[name]
            print(f"22c cli/{name}.py rank {r} on {smi}: host ms per step "
                  f"(issue to next issue) {[round(v, 1) for v in res['host_ms']]}"
                  f", CUDA events per step {[round(v, 1) for v in res['event_ms']]}"
                  f" ms; gloo all-reduce of the gradient (host ms, each call; "
                  f"through the host, not NCCL's time) "
                  f"{[round(v, 1) for v in res['reduce_ms']]}; peak "
                  f"{res['peak_gib']:.2f} GiB; wall {res['wall_s']:.1f} s")
        # under sp each attention call is one B5 and one B7 launch where
        # one rank's is one B1 and one B2
        want = ([{"flash_fwd_bh": c["flash_fwd_packed"],
                  "flash_bwd_bh": c["flash_bwd_packed"]}
                 for c in one["launches"]] if sp else one["launches"])
        if (dloss > TOL_DP_LOSS or len(got["losses"]) != 2
                or any(rk[name]["launches"] != want for rk in ranks)
                or any(set(c) != {"flash_fwd_packed", "flash_bwd_packed"}
                       for c in one["launches"])
                or not all(math.isfinite(v) for v in got["losses"])):
            raise AssertionError(f"22c: cli/{name}.py on two ranks")
        for kern in want[0]:
            seen[f"cli/{name}.py {world} gloo ranks {kern}"] = [
                c[kern] for c in got["launches"]]
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints
    return seen


def run_phase22(torch, _cuda, entry_mod, fa, smi, rate):
    """Phase 22: the multi-rank paths (a)-(c); the shard shapes' kernel
    rows for (d)."""
    seen = {}
    seen["22a one-rank NCCL flash_tp"] = run_tp_one_rank(torch, _cuda,
                                                         entry_mod)
    seen["22b n_tp=4 rank bodies"] = run_tp_geometry(torch, _cuda, fa)
    rows = check_tp_shards(torch, fa, rate)
    seen["22c gloo ranks on cuda:0"] = run_gloo_clis(torch, _cuda, smi)
    print(f"phase 22 launches per step: {json.dumps(seen)}")
    return rows


# ------------------------------------ phase 23: fsdp-sharded states (A15)

# 23b's first loss against one rank's on the same batch: the fsdp ranks
# run the forward on whole weights gathered from their chunks, equal to
# one rank's, so any difference is the sharding's
TOL_FSDP_LOSS = 1e-4


class _Collectives:
    """Host milliseconds of each call to core/multihost's all_gather (the
    fsdp gathers), reduce_scatter (their backward) and all_reduce_mean
    (the whole leaves' reduction), recorded while installed."""

    NAMES = ("all_gather", "reduce_scatter", "all_reduce_mean")

    def __init__(self, multihost):
        self.multihost, self.ms = multihost, {n: [] for n in self.NAMES}
        self.saved = {n: getattr(multihost, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(multihost, n, self._timed(fn, self.ms[n]))

    @staticmethod
    def _timed(fn, into):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def take(self) -> dict:
        out = {n: [len(v), sum(v)] for n, v in self.ms.items()}
        for v in self.ms.values():
            v.clear()
        return out

    def restore(self):
        for n, fn in self.saved.items():
            setattr(self.multihost, n, fn)


def _timed_step(torch, _cuda, step, state, *args, **kw):
    """One step with the launches (counters set to 0 just before it), its
    CUDA-event and host ms and the peak since the reset."""
    _cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    ev[0].record()
    state, m = step(state, *args, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    return state, m, {
        "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
        "launches": _nonzero(_cuda.launches),
        "event_ms": ev[0].elapsed_time(ev[1]),
        "host_ms": (time.perf_counter() - t0) * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _last_mlp(names) -> list:
    """The last decoder block's MLP weights among ``names``: sharded by
    fsdp_param_spec at the MAE's decoder width, and below every B2 of the
    backward, so their gradients are exact across runs."""
    last = max(int(n.split(".")[1]) for n in names
               if n.startswith("decoder_blocks."))
    return [f"decoder_blocks.{last}.mlp.{fc}.weight" for fc in ("fc1", "fc2")]


def run_fsdp_one_rank(torch, _cuda, entry_mod):
    """23a: the ViT-L MAE step (60x256x256, mask 0.90, batch 4, decoder 16
    x 32) on a one-rank NCCL group, its state placed by
    core/fsdp.shard_state (fsdp_param_spec on a data 1 x fsdp 1 mesh),
    against the replicated step from the same state, two steps each (the
    first at LR 0 moves no param): both losses bit-equal; the last
    decoder block's MLP weights (sharded leaves whose gradient no B2
    reaches) bit-equal in gradient and after step 2's update; the grad
    norms within B2's run-to-run limit (B2 sums dq in varying order, so
    every gradient below an attention differs between any two runs; the
    worst leaf is printed); 32 B1 + 32 B2 a step."""
    import torch.distributed as dist

    from octcubem_tpu_torch.core import fsdp, multihost
    from octcubem_tpu_torch.core.mesh import make_mesh
    from octcubem_tpu_torch.train import mae_engine

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp1_")
    multihost.initialize(store=dist.FileStore(f"{tmp}/store", 1),
                         world_size=1, rank=0, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("the one-rank group is not NCCL")
        mesh = make_mesh(1, 1, device="cuda")
        runs = {}
        for sharded in (False, True):
            step, state, x = entry_mod.train_entry(batch=4)
            if sharded:
                fsdp.shard_state(state, mesh)
                step = mae_engine.make_mae_train_step(
                    state.params, state.tx, mesh=mesh)
            rows = []
            for _ in range(2):
                state, _, row = _timed_step(torch, _cuda, step, state, x,
                                            mask_ratio=0.9)
                rows.append(row)
            runs[sharded] = (rows, _leaf_grads(state.params),
                             {n: p.detach().clone() for n, p in
                              state.params.named_parameters()},
                             len(state.shards.dims) if sharded else 0,
                             state.tx.lr(1))
            del step, state, x
            torch.cuda.empty_cache()
        (rep, g_rep, p_rep, _, lr), (got, g_got, p_got, n_sh, _) = (
            runs[False], runs[True])
        losses_equal = all(a["loss"] == b["loss"] for a, b in zip(got, rep))
        dgn = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                  for a, b in zip(got, rep))
        free = _last_mlp(p_rep)
        free_equal = all(torch.equal(g_got[n], g_rep[n])
                         and torch.equal(p_got[n], p_rep[n]) for n in free)
        worst, leaf = max(((g_got[n] - g_rep[n]).abs().max().item()
                           / g_rep[n].abs().max().item(), n) for n in g_rep)
        dparam = max((p_got[n] - p_rep[n]).abs().max().item() for n in p_rep)
        print(f"23a fsdp_param_spec on a one-rank NCCL group ({n_sh} leaves "
              f"placed sharded): losses {[r['loss'] for r in got]} vs "
              f"replicated {[r['loss'] for r in rep]} (bit-equal "
              f"{losses_equal}); {free} gradients and params after step 2 "
              f"bit-equal {free_equal}; max rel d grad_norm {dgn:.3e} (tol "
              f"{TOL_RUN_TO_RUN:.1e}); B2's run-to-run spread: step 2's "
              f"worst leaf {leaf} rel {worst:.3e}, max|d param| {dparam:.3e}"
              f" (LR {lr:.3e}); launches per step "
              f"{[r['launches'] for r in got]}, event ms "
              f"{[round(r['event_ms'], 1) for r in got]} vs "
              f"{[round(r['event_ms'], 1) for r in rep]}")
        want = {"flash_fwd_packed": 32, "flash_bwd_packed": 32}
        if (not losses_equal or not free_equal or dgn > TOL_RUN_TO_RUN
                or n_sh == 0 or any(n not in g_got for n in free)
                or any(r["launches"] != want for r in got + rep)):
            raise AssertionError("23a: the fsdp-placed step")
        return {"23a MAE step, fsdp 1": [r["launches"] for r in got]}
    finally:
        multihost.shutdown()


def _fsdp_rank(rank, world, tmp):
    """23b's rank: a gloo group with the other rank on cuda:0, mesh data 1
    x fsdp 2; the vitl_joint_pretrain step (2 volumes and 8 2D images,
    accum_2d 1) three times on a state placed by shard_state, a sharded
    checkpoint at step 1 resumed onto fsdp 2 for steps 2-3, then the
    octcube_ir CLIP step at 4 pairs; what it measured goes to
    tmp/fsdp{rank}.json, its chunks of ``_last_mlp`` after step 2 (the
    first update at a non-zero LR) to tmp/mlp{rank}_{run,resumed}.pt."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from octcubem_tpu_torch import entry as entry_mod
    from octcubem_tpu_torch.core import checkpoint, fsdp, multihost
    from octcubem_tpu_torch.core.mesh import make_mesh
    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.train import clip_engine, mae_engine

    multihost.initialize(store=dist.FileStore(f"{tmp}/store", world),
                         world_size=world, rank=rank, local_rank=0,
                         backend="gloo", device="cuda", timeout_s=300)
    coll = _Collectives(multihost)
    out = {"backend": dist.get_backend()}
    try:
        mesh = make_mesh(1, world, device="cuda")

        def joint():
            step, state, x = entry_mod.train_entry(joint=True, batch=2,
                                                   batch2d=8)
            x2 = step.keywords["batch2d"]
            fsdp.shard_state(state, mesh)
            step = mae_engine.make_mae_train_step(state.params, state.tx,
                                                  joint=True, mesh=mesh)
            return step, state, x, x2

        step, state, x, x2 = joint()
        shards = state.shards
        mlp = _last_mlp(shards.dims)
        out["mlp_dims"] = {n: shards.dims[n] for n in mlp}

        def save_mlp(tag):
            params = dict(state.params.named_parameters())
            torch.save({n: params[n].detach().cpu() for n in mlp},
                       f"{tmp}/mlp{rank}_{tag}.pt")

        out["sharded_leaves"] = len(shards.dims)
        out["sharded_elems"] = shards.n * sum(p.numel()
                                              for p, _, _ in shards._params)
        out["local_elems"] = sum(p.numel() for p in state.params.parameters())
        coll.take()
        rows = []
        for i in range(3):
            state, _, row = _timed_step(torch, _cuda, step, state, x, 0.9,
                                        batch2d=x2, mask_ratio_2d=0.75)
            row["collectives"] = coll.take()
            rows.append(row)
            if i == 1:
                save_mlp("run")
            if i == 0:  # every rank gathers, rank 0 writes; then wait
                t0 = time.perf_counter()
                checkpoint.save_checkpoint(f"{tmp}/ckpt", 1, state)
                multihost.barrier()
                out["save_s"] = time.perf_counter() - t0
                out["save_collectives"] = coll.take()
        out["joint"] = rows
        del step, state
        torch.cuda.empty_cache()
        step, state, x, x2 = joint()
        checkpoint.restore_checkpoint(f"{tmp}/ckpt", state)
        out["restored_step"] = state.step
        out["resumed"] = []
        for i in range(2):
            state, _, row = _timed_step(torch, _cuda, step, state, x, 0.9,
                                        batch2d=x2, mask_ratio_2d=0.75)
            out["resumed"].append(row)
            if i == 0:
                save_mlp("resumed")
        del step, state, x, x2
        torch.cuda.empty_cache()

        model, tx, cstate, _ = _coem_state(torch, COEM_CONFIG, 0)
        fsdp.shard_state(cstate, mesh)
        out["clip_sharded_leaves"] = len(cstate.shards.dims)
        cstep = clip_engine.make_clip_train_step(model, tx, mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(23)
        batch = {k: v[0] for k, v in _coem_batch(torch, gen, 1, 4).items()}
        coll.take()
        rows = []
        for _ in range(2):
            cstate, _, row = _timed_step(torch, _cuda, cstep, cstate, batch)
            row["collectives"] = coll.take()
            rows.append(row)
        out["clip"] = rows
        with open(f"{tmp}/fsdp{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        coll.restore()
        multihost.shutdown()


def run_fsdp_gloo(torch, _cuda, entry_mod, smi):
    """23b: two gloo ranks sharing cuda:0 on a data 1 x fsdp 2 mesh
    (``_fsdp_rank``), each against one rank (this process) on the same
    batch: the joint step's and the CLIP step's losses within
    TOL_FSDP_LOSS (the joint's step 3 and the CLIP's step 2 come after an
    update at a non-zero LR), their launches per step equal; the
    checkpoint saved by both ranks at step 1 and resumed onto one rank
    here.  The joint's schedule puts step 1 at LR 0, so step 2's loss is
    bit-equal in every run, uninterrupted or resumed on either mesh, and
    step 2 is the first update: after it each rank's chunk of the
    ``_last_mlp`` weights, uninterrupted and resumed onto fsdp 2, is
    bit-equal to its block of one rank's whole weight, uninterrupted and
    resumed (AdamW on the chunk, the moments restored and the block the
    reduce-scatter keeps), and step 3's losses are within TOL_FSDP_LOSS
    of one rank's uninterrupted one.  Prints each rank's step time in CUDA
    events with the gathers', reduce-scatters' and all-reduces' host ms
    apart, and its peak."""
    import torch.multiprocessing as mp

    from octcubem_tpu_torch.core import checkpoint
    from octcubem_tpu_torch.train import clip_engine

    world = 2
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_fsdp_rank, args=(r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + 400
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    print(f"23b: {world} gloo ranks on cuda:0 (data 1 x fsdp {world}) in "
          f"{time.perf_counter() - t0:.1f} s, exit codes {codes}")
    if codes != [0] * world:
        raise AssertionError(f"23b: rank exit codes {codes}")
    ranks = [json.loads(Path(f"{tmp}/fsdp{r}.json").read_text())
             for r in range(world)]
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("23b ran on another backend than gloo")

    # one rank on the same batch, then the sharded checkpoint resumed here
    step, state, x = entry_mod.train_entry(joint=True, batch=2, batch2d=8)
    mlp = _last_mlp(dict(state.params.named_parameters()))

    def whole_mlp():
        params = dict(state.params.named_parameters())
        return {n: params[n].detach().cpu() for n in mlp}

    runs = {}
    for tag, n_steps in (("run", 3), ("resumed", 2)):
        if tag == "resumed":
            checkpoint.restore_checkpoint(f"{tmp}/ckpt", state)
        rows = []
        for i in range(n_steps):
            state, _, row = _timed_step(torch, _cuda, step, state, x,
                                        mask_ratio=0.9)
            rows.append(row)
            if i == n_steps - 2:
                runs[tag] = (rows, whole_mlp())
    (one_rows, one_mlp), (one_resumed, one_mlp_resumed) = (
        runs["run"], runs["resumed"])
    del step, state, x
    torch.cuda.empty_cache()
    model, tx, cstate, _ = _coem_state(torch, COEM_CONFIG, 0)
    cstep = clip_engine.make_clip_train_step(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(23)
    batch = {k: v[0] for k, v in _coem_batch(torch, gen, 1, 4).items()}
    one_clip = []
    for _ in range(2):
        cstate, _, row = _timed_step(torch, _cuda, cstep, cstate, batch)
        one_clip.append(row)
    del model, tx, cstate, cstep, batch
    torch.cuda.empty_cache()
    # each rank's chunk after step 2 against its block of one rank's
    mlp_equal = {}
    for tag, want in (("run", one_mlp), ("resumed", one_mlp_resumed)):
        for r in range(world):
            got = torch.load(f"{tmp}/mlp{r}_{tag}.pt")
            mlp_equal[f"{tag} rank {r}"] = all(
                torch.equal(got[n], want[n].chunk(
                    world, ranks[r]["mlp_dims"][n])[r]) for n in mlp)
    mlp_equal["one rank resumed vs uninterrupted"] = all(
        torch.equal(one_mlp[n], one_mlp_resumed[n]) for n in mlp)
    shutil.rmtree(tmp, ignore_errors=True)

    r0 = ranks[0]
    whole = r0["local_elems"] + r0["sharded_elems"] * (world - 1) // world
    print(f"23b fsdp_param_spec shards {r0['sharded_leaves']} leaves of "
          f"{r0['sharded_elems']} params of {whole} "
          f"({r0['sharded_elems'] / whole:.3f}); a rank holds "
          f"{r0['local_elems']}; octcube_ir {r0['clip_sharded_leaves']} "
          f"leaves")
    seen, bad = {}, []
    for name, one_steps, what in (
            ("joint", one_rows, "vitl_joint_pretrain at full width, 2 "
                                "volumes and 8 2D images, accum_2d 1"),
            ("clip", one_clip, "octcube_ir CLIP step, 4 pairs, lock 9")):
        got = [r[name] for r in ranks]
        one_row = one_steps[0]
        dloss = max(abs(s["loss"] - o["loss"]) / abs(o["loss"])
                    for g in got for s, o in zip(g, one_steps))
        print(f"23b {name} ({what}) on {world} fsdp ranks vs one rank: "
              f"losses {[[s['loss'] for s in g] for g in got]} vs "
              f"{[s['loss'] for s in one_steps]}, max rel dloss {dloss:.3e} "
              f"(tol {TOL_FSDP_LOSS:.0e}); launches per step "
              f"{[s['launches'] for s in got[0]]} (one rank "
              f"{one_row['launches']})")
        for r, g in enumerate(got):
            print(f"23b {name} rank {r} on {smi}: CUDA events per step "
                  f"{[round(s['event_ms'], 1) for s in g]} ms, host "
                  f"{[round(s['host_ms'], 1) for s in g]} ms; host ms (calls)"
                  f" of the gathers "
                  f"{[(round(s['collectives']['all_gather'][1], 1), s['collectives']['all_gather'][0]) for s in g]}"
                  f", reduce-scatters "
                  f"{[(round(s['collectives']['reduce_scatter'][1], 1), s['collectives']['reduce_scatter'][0]) for s in g]}"
                  f", whole-leaf all-reduces "
                  f"{[(round(s['collectives']['all_reduce_mean'][1], 1), s['collectives']['all_reduce_mean'][0]) for s in g]}"
                  f" (gloo through the host, not NCCL's time); peak "
                  f"{[round(s['peak_gib'], 2) for s in g]} GiB (one rank "
                  f"{one_row['peak_gib']:.2f}; 22c's CLI {12.87} GiB)")
        if (dloss > TOL_FSDP_LOSS
                or any(s["launches"] != one_row["launches"]
                       for g in got for s in g)
                or not all(math.isfinite(s["loss"]) and math.isfinite(
                    s["grad_norm"]) for g in got for s in g)):
            bad.append(name)
        for kern in ("flash_fwd_packed", "flash_bwd_packed"):
            seen[f"23b {name} fsdp 2 {kern}"] = [
                s["launches"].get(kern, 0) for s in got[0]]
    step2 = ([r["joint"][1]["loss"] for r in ranks]
             + [r["resumed"][0]["loss"] for r in ranks]
             + [one_rows[1]["loss"], one_resumed[0]["loss"]])
    step3 = ([r["joint"][2]["loss"] for r in ranks]
             + [r["resumed"][1]["loss"] for r in ranks]
             + [one_resumed[1]["loss"]])
    d3 = max(abs(v - one_rows[2]["loss"]) / abs(one_rows[2]["loss"])
             for v in step3)
    print(f"23b checkpoint: saved by both ranks at step 1 in "
          f"{[round(r['save_s'], 1) for r in ranks]} s (gathers: host ms, "
          f"calls {[r['save_collectives']['all_gather'][::-1] for r in ranks]}"
          f"); one rank's resumed step: peak {one_resumed[0]['peak_gib']:.2f}"
          f" GiB, {one_resumed[0]['event_ms']:.1f} ms (restored step "
          f"{[r['restored_step'] for r in ranks]}); step 2 losses (fsdp "
          f"uninterrupted, resumed onto fsdp 2, one rank uninterrupted, "
          f"resumed onto one rank) {step2}; step 3 losses {step3} vs one "
          f"rank's uninterrupted {one_rows[2]['loss']}, max rel {d3:.3e} "
          f"(tol {TOL_FSDP_LOSS:.0e}); {mlp} after step 2 (the first "
          f"update at a non-zero LR) bit-equal to one rank's block: "
          f"{mlp_equal}; step 2 grad norms "
          f"{[r['joint'][1]['grad_norm'] for r in ranks]}, "
          f"{[r['resumed'][0]['grad_norm'] for r in ranks]}, "
          f"{one_resumed[0]['grad_norm']} (B2's dq order: within "
          f"{TOL_RUN_TO_RUN:.1e})")
    gn = ranks[0]["joint"][1]["grad_norm"]
    if (any(v != step2[0] for v in step2) or d3 > TOL_FSDP_LOSS
            or not all(mlp_equal.values())
            or any(r["restored_step"] != 1 for r in ranks)
            or any(abs(r["resumed"][0]["grad_norm"] - gn)
                   > TOL_RUN_TO_RUN * gn for r in ranks)
            or abs(one_resumed[0]["grad_norm"] - gn) > TOL_RUN_TO_RUN * gn):
        bad.append("checkpoint")
    if bad:
        raise AssertionError(f"23b: {bad}")
    return seen


def run_phase23(torch, _cuda, entry_mod, smi):
    """Phase 23: states sharded over fsdp (a)-(b), then
    entry.dryrun_multichip(4) on four gloo ranks sharing the card (c)."""
    seen = {"23a": run_fsdp_one_rank(torch, _cuda, entry_mod)}
    seen["23b"] = run_fsdp_gloo(torch, _cuda, entry_mod, smi)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = entry_mod.dryrun_multichip(4)
    print(f"23c: dryrun_multichip(4) on {smi}: {len(lines)} lines in "
          f"{time.perf_counter() - t0:.1f} s")
    # NCCL takes one card a rank; with fewer than four the ranks share
    want = ("4 cards, one a rank, backend nccl"
            if torch.cuda.device_count() >= 4 else "gloo ranks sharing")
    if want not in lines[0] or len(lines) != 8:
        raise AssertionError(f"23c: dryrun_multichip(4), want {want!r} in "
                             f"{lines[0]!r}")
    print(f"phase 23 launches per step: {json.dumps(seen)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "octcubem_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the octcubem_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from octcubem_tpu_torch import entry as entry_mod
    from octcubem_tpu_torch.cli import infer, serve
    from octcubem_tpu_torch.nn import layers
    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.ops import flash_attention as fa
    from octcubem_tpu_torch.ops.attention import naive_attention
    from octcubem_tpu_torch.parallel import sequence as sp
    from octcubem_tpu_torch.scripts import kablate
    from octcubem_tpu_torch.scripts.time_kernels import exp_rate
    from octcubem_tpu_torch.train import optim, schedules

    # full-fp32 matmuls and convolutions for the fp32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    rate = exp_rate(torch)
    print(f"exp rate {rate:.4e} per second (16 per clock per SM, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
          f"the max SM clock)")

    t0 = time.time()
    _cuda.build()
    print(f"kernels built in {time.time() - t0:.1f} s")
    clock = [time.time()]

    def phase_done(name):
        now = time.time()
        print(f"[phase] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    # per kernel: its name, registers, spills, and any wgmma serialised
    for name in _cuda.KERNELS:
        for line in _cuda.build_log(name).read_text().splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "error", "warning", "wgmma")):
                print(f"ptxas {name}: {line.strip()}")

    err = check_flash_fwd(torch, fa)
    check_hopper_fwd(torch, fa)
    check_flash_bwd(torch, fa)
    check_head_by_head(torch, fa)
    check_coem_shapes(torch, fa)
    bh_errs = check_bh_kernels(torch, fa)
    phase_done("3: B1-B5, B7 against their plain versions")

    # serving: ViT-L (B1), the server, then ViT-H/14 (B3)
    fn, model, x, launches = run_main_path(torch, _cuda, entry_mod)
    run_serve(torch, _cuda, serve)
    timing = time_flash_fwd(torch, fa, rate)
    time_forward(torch, fn, model, x, "ViT-L 48x256x256")
    del fn, model, x
    phase_done("4-5: ViT-L serving and the server")
    vith = dict(ctor=entry_mod.vit_st.vit_huge_patch14, img_size=224)
    fn, model, x, b3_launches = run_main_path(
        torch, _cuda, entry_mod, name="ViT-H/14 48x224x224",
        counter="flash_fwd_bh_cls", **vith)
    time_forward(torch, fn, model, x, "ViT-H/14 48x224x224")
    del fn, model, x
    torch.cuda.empty_cache()
    b4_launches = run_vith_backward(torch, _cuda, entry_mod)
    phase_done("6: ViT-H/14 classifier")

    # training: ViT-L/16 (B1 + B2), then ViT-H/14 (B5 + B7, B1 + B2)
    launches_bwd = run_train(
        torch, _cuda, entry_mod, optim, "ViT-L/16 60x256x256", (16, 4),
        {"flash_fwd_packed": 32, "flash_bwd_packed": 32}, {})[
            "flash_bwd_packed"]
    check_flash_vs_naive(torch, entry_mod, "ViT-L/16")
    mae_h = dict(ctor=entry_mod.mae3d.mae_vit_huge_patch14, input_size=224)
    b57 = run_train(
        torch, _cuda, entry_mod, optim, "ViT-H/14 60x224x224", (16,),
        {"flash_fwd_bh": 32, "flash_bwd_bh": 32, "flash_fwd_packed": 8,
         "flash_bwd_packed": 8},
        dict(d=1280, layers=32, img=224, patch=14), **mae_h)
    check_flash_vs_naive(torch, entry_mod, "ViT-H/14", **mae_h)
    phase_done("7-8: MAE steps and flash vs naive")

    timing_bwd = time_flash_bwd(torch, fa, rate)
    timing_bh = time_bh_kernels(torch, fa, rate)
    phase_done("9: B1-B5, B7 timings")

    # the exact softmax (B6) and the sequence-parallel layer
    b6_err = check_b6(torch, fa, naive_attention)
    phase_done("10: B6 against its plain version")
    sp_launches = run_sp_one_rank(torch, _cuda, fa, sp, layers)
    phase_done("11: the sp layer on a one-rank NCCL group")
    run_sp_shards(torch, _cuda, fa)
    phase_done("12: the 4-shard geometry")
    b8_err = check_b8(torch, kablate)
    timing_b8 = time_b8(torch, _cuda, kablate, rate)
    phase_done("13: B8 and the ablation harness")
    timing_b6 = time_b6(torch, fa, rate)
    phase_done("14: B6 timings")
    run_phase15(torch, _cuda, entry_mod, optim, smi)
    phase_done("15: the joint step, remat_2d, pre-mask, resume, export")
    run_phase16(torch, _cuda, entry_mod, serve, infer)
    phase_done("16: int8, AOT, Grad-CAM, DICOM")
    run_mae2d(torch, _cuda, optim, schedules, smi)
    check_mae2d_vs_naive(torch)
    phase_done("17: the 2D MAE")
    run_phase18(torch, _cuda, entry_mod, smi)
    phase_done("18: cli/pretrain.py")
    ft_launches = run_phase19(torch, _cuda, smi)
    phase_done("19: the fine-tuning family")
    coem_launches_seen = run_phase20(torch, _cuda, smi)
    phase_done("20: the COEM contrastive path")
    aux_seen, timing_d16 = run_phase21(torch, _cuda, fa, smi, rate)
    phase_done("21: the auxiliary COEM towers")
    tp_rows = run_phase22(torch, _cuda, entry_mod, fa, smi, rate)
    phase_done("22: the multi-rank paths")
    run_phase23(torch, _cuda, entry_mod, smi)
    phase_done("23: fsdp-sharded states, dryrun_multichip(4)")
    per_step = {kern: {**ft_launches[kern], **coem_launches_seen[kern],
                       **aux_seen[kern]}
                for kern in ft_launches}

    kernels = [{
        "name": "flash_fwd_packed", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_fwd_packed.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:859",
        "launches": launches,
        "launches_per_step_on": per_step["flash_fwd_packed"],
        "max_abs_err": err, **timing,
        "at_tp_shards": tp_rows["flash_fwd_packed"]}, {
        "name": "flash_bwd_packed", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_bwd_packed.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:961",
        "launches": launches_bwd,
        "launches_per_step_on": per_step["flash_bwd_packed"],
        **timing_bwd, "at_tp_shards": tp_rows["flash_bwd_packed"]}]
    # (counter, TPU kernel's line, source, launches on its path)
    for kern, counter, line, src, n in (
            ("B3", "flash_fwd_bh_cls", 128, "flash_fwd_bh.cu", b3_launches),
            ("B4", "flash_bwd_bh_cls", 397, "flash_bwd_bh.cu", b4_launches),
            ("B5", "flash_fwd_bh", 91, "flash_fwd_bh.cu", b57["flash_fwd_bh"]),
            ("B7", "flash_bwd_bh", 329, "flash_bwd_bh.cu",
             b57["flash_bwd_bh"])):
        kernels.append({
            "name": counter, "route": "cuda",
            "source": f"octcubem_tpu_torch/csrc/{src}",
            "replaces": f"octcubem_tpu/ops/flash_attention.py:{line}",
            "launches": n, "launches_per_step_on": aux_seen[counter],
            "max_abs_err": bh_errs[kern], **timing_bh[kern],
            "at_head_dim_16": {"max_abs_err": bh_errs[f"{kern} D=16"],
                               **timing_d16[kern]}})
    kernels.append({
        "name": "flash_fwd_bh_exact", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_fwd_bh.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:170",
        "launches": sp_launches["flash_fwd_bh_exact"], "max_abs_err": b6_err,
        **timing_b6})
    kernels.append({
        "name": "flash_ablate", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_ablate.cu",
        "replaces": "scripts/kablate.py:33", "max_abs_err": b8_err,
        **timing_b8})
    for k in kernels:
        for key, val in k.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"{k['name']}: {key} is {val}")
        # the SFU's exps are operations too: the line names two kinds
        for row in (k, k.get("at_head_dim_16", {}),
                    *k.get("at_tp_shards", {}).values()):
            if row.get("bound_by") == "exp":
                row["bound_by"] = "operations"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
