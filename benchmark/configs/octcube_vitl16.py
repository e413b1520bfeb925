"""octcube_vitl16: the OCTCube ViT-L/16 3D encoder as the MAE pretrainer.

Builders of the program's objects for the drivers (the weights made by
the benchmark and handed in at the program's ``init_params`` seam), the
plain reference's geometry, and the analytic FLOP counts.
"""

from __future__ import annotations

from harness import weights, work

TRUNK = ("patch_size", "t_patch_size", "in_chans", "embed_dim", "depth",
         "num_heads", "mlp_ratio")


def mae_geometry(cfg: dict, overrides: dict | None = None) -> dict:
    """The MAE's numbers as one flat dict (``overrides``: a cut geometry
    for the CPU tests)."""
    g = {k: cfg[k] for k in TRUNK}
    g.update(cfg["mae"])
    g.update(overrides or {})
    return g


def build_mae_train(cfg: dict, device, seed: int, batch: int,
                    overrides=None):
    """The pretraining step as ``entry.train_entry`` builds it (fused
    AdamW, bf16 compute, fp32 params) -> (step, state, geometry)."""
    from octcubem_tpu_torch import entry
    from octcubem_tpu_torch.models import mae3d

    g = mae_geometry(cfg, overrides)
    model_kw = dict(patch_size=g["patch_size"], embed_dim=g["embed_dim"],
                    depth=g["depth"], num_heads=g["num_heads"],
                    mlp_ratio=g["mlp_ratio"], in_chans=g["in_chans"],
                    num_frames=g["num_frames"], t_patch_size=g["t_patch_size"],
                    pred_t_dim=g["pred_t_dim"],
                    high_res_input_size=g["high_res_input_size"],
                    decoder_embed_dim=g["decoder_embed_dim"],
                    decoder_depth=g["decoder_depth"],
                    norm_pix_loss=g["norm_pix_loss"])
    with weights.injected([mae3d], seed):
        step, state, x = entry.train_entry(
            device=device, dec_heads=g["decoder_num_heads"], batch=batch,
            ctor=mae3d.MaskedAutoencoderViT3D, input_size=g["input_size"],
            **model_kw)
    del x
    return step, state, g


def mae_flops_per_sample(g: dict) -> float:
    return work.mae_train_flops(
        d=g["embed_dim"], layers=g["depth"], dd=g["decoder_embed_dim"],
        dlayers=g["decoder_depth"], frames=g["num_frames"],
        img=g["input_size"], patch=g["patch_size"], tpatch=g["t_patch_size"],
        mask=g["mask_ratio"])
