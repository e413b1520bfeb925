"""Entry point: the flagship ViT-L spatiotemporal classifier forward
(counterpart of ``__graft_entry__.entry()``)."""

from __future__ import annotations

import torch

from .models import vit_st


def entry(device=None):
    """-> (fn, (model, x)): ``fn(model, x)`` is the bf16 inference forward
    of the released OCTCube classifier config (ViT-L/16, dropout head,
    global pool, separable pos embeds) on one 48x256x256 volume of ones,
    4,096 tube tokens plus cls.  Weights are seeded random.  Runs on the
    card unless ``device="cpu"``."""
    model = vit_st.create_model(
        vit_st.flash_attn_vit_large_patch16, device=device, seed=0,
        num_frames=48, t_patch_size=3, img_size=256, in_chans=1,
        num_classes=16, head_type="dropout", global_pool=True,
        sep_pos_embed=True, cls_embed=True, dtype=torch.bfloat16,
        attn_impl="auto")
    x = torch.ones((1, 48, 256, 256, 1), dtype=torch.float32,
                   device=model.head.weight.device)

    def fn(model, x):
        with torch.inference_mode():
            return model(x)

    return fn, (model, x)
