"""Entry points: the spatiotemporal classifier forward (counterpart of
``__graft_entry__.entry()``) and the 3D MAE pretraining step (the
configuration of ``bench.py::measure``), each for a model constructor of
the registry: ViT-L/16 by default, ViT-H/14 through ``ctor``."""

from __future__ import annotations

import functools

import torch

from .models import mae3d, vit_st
from .train import mae_engine, optim, schedules
from .train.train_state import TrainState


def entry(device=None, ctor=vit_st.flash_attn_vit_large_patch16,
          img_size: int = 256, **model_kw):
    """-> (fn, (model, x)): ``fn(model, x)`` is the bf16 inference forward
    of the released OCTCube classifier config (dropout head, global pool,
    separable pos embeds) on one 48 x ``img_size`` x ``img_size`` volume of
    ones.  Default: ViT-L/16 at 256, 4,096 tube tokens plus cls; with
    ``ctor=vit_st.vit_huge_patch14, img_size=224``, ViT-H/14 (16 heads of
    80) at the same 4,096 + cls.  Weights are seeded random; ``model_kw``
    overrides model arguments (e.g. depth).  Runs on the card unless
    ``device="cpu"``."""
    kw = dict(num_frames=48, t_patch_size=3, img_size=img_size, in_chans=1,
              num_classes=16, head_type="dropout", global_pool=True,
              sep_pos_embed=True, cls_embed=True, dtype=torch.bfloat16,
              attn_impl="auto")
    kw.update(model_kw)
    model = vit_st.create_model(ctor, device=device, seed=0, **kw)
    x = torch.ones((1, kw["num_frames"], img_size, img_size, 1),
                   dtype=torch.float32, device=model.head.weight.device)

    def fn(model, x):
        with torch.inference_mode():
            return model(x)

    return fn, (model, x)


def train_entry(device=None, dec_heads: int = 16, batch: int = 4,
                ctor=mae3d.mae_vit_large_patch16, input_size: int = 256,
                joint: bool = False, batch2d: int = 64, accum_2d: int = 1,
                use_premask: bool = False, remat_2d: bool = False,
                **model_kw):
    """-> (step, state, x): ``step(state, x, mask_ratio=0.9)`` is one MAE
    pretraining step (forward, backward, fused AdamW) of ``ctor``'s 3D MAE
    at full width and depth, with a decoder 512 wide, 8 blocks,
    ``dec_heads`` heads (16 of 32, the reference geometry, or 4 of 128);
    bf16 compute with fp32 params; the spatial pos embeds stored at twice
    ``input_size``.  Default: ViT-L/16 (1024 wide, 24 blocks, 16 heads of
    64) at 256; with ``ctor=mae3d.mae_vit_huge_patch14, input_size=224``,
    ViT-H/14 (1280 wide, 32 blocks, 16 heads of 80).  AdamW betas (0.9,
    0.95), weight decay 0.05, LR warmup_half_cosine(1.6e-3, 0, 1, 50,
    1000).  x is ``batch`` seeded-normal 60 x ``input_size`` x
    ``input_size`` volumes; weights are seeded random.  ``model_kw``
    overrides model arguments (e.g. depth, decoder_depth).

    ``joint=True`` is the ``vitl_joint_pretrain`` step: each step adds the
    MAE loss of ``batch2d`` seeded-normal 2D images (3 frames, one tube,
    at twice ``input_size``: 1,024 tokens each at 512 and patch 16) at
    mask 0.75, bound into the returned step (its ``batch2d`` keyword),
    laid out [accum_2d, batch2d / accum_2d, ...] when ``accum_2d`` > 1;
    ``use_premask`` computes the blank-region pre-mask in the step;
    ``remat_2d`` runs the 2D branch through ``model.with_remat()``.  Runs
    on the card unless ``device="cpu"``."""
    kw = dict(decoder_embed_dim=512, decoder_depth=8, num_frames=60,
              t_patch_size=3, pred_t_dim=60, input_size=input_size,
              high_res_input_size=2 * input_size, in_chans=1,
              dtype=torch.bfloat16, attn_impl="auto", num_heads=16,
              decoder_num_heads=dec_heads)
    kw.update(model_kw)
    model = mae3d.create_model(ctor, device=device, seed=1, **kw)
    dev = model.cls_token.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch, kw["num_frames"], input_size, input_size, 1),
                    generator=gen, device=dev)
    sched = schedules.warmup_half_cosine(1.6e-3, 0.0, 1, 50, 1000)
    tx = optim.build_adamw(model, sched, weight_decay=0.05)
    state = TrainState.create(model, tx, seed=2)
    step = mae_engine.make_mae_train_step(
        model, tx, joint=joint, use_premask=use_premask, accum_2d=accum_2d,
        model2d=model.with_remat() if remat_2d else None)
    if joint:
        if batch2d % accum_2d:
            raise ValueError(f"batch2d {batch2d} is not a multiple of "
                             f"accum_2d {accum_2d}")
        size = kw["high_res_input_size"]
        shape = (batch2d, kw["t_patch_size"], size, size, 1)
        if accum_2d > 1:
            shape = (accum_2d, batch2d // accum_2d) + shape[1:]
        x2 = torch.randn(shape, generator=gen, device=dev)
        step = functools.partial(step, batch2d=x2, mask_ratio_2d=0.75)
    return step, state, x
