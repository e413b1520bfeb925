"""octcube_vitl16_joint: the OCTCube joint-resolution MAE pretrainer as
the published job runs it on each card: every step one 3D volume at
mask 0.90 with its blank-region pre-mask computed in the step, and 64 2D
B-scans at 512^2 at mask 0.75 through the same model's high-res patch
embed and shared decoder, the two losses summed.

What ``drivers/mae_joint_train.py`` takes from it: the program's step,
made by ``entry.train_entry(joint=True, ...)`` (the step of
``mae_engine.make_mae_train_step``, the benchmark's weights handed in at
the program's ``init_params`` seam), the plain reference's geometry and
the analytic FLOP count.
"""

from __future__ import annotations

from harness import weights, work

TRUNK = ("patch_size", "t_patch_size", "in_chans", "embed_dim", "depth",
         "num_heads", "mlp_ratio")


def geometry(cfg: dict, overrides: dict | None = None) -> dict:
    """The model's, the joint step's and the pre-mask's numbers and the
    compute dtype as one flat dict (``overrides``: a cut geometry for the
    CPU tests)."""
    g = {k: cfg[k] for k in TRUNK}
    g.update(cfg["mae"])
    g.update(cfg["joint"])
    g["compute"] = cfg["precision"]["compute"]
    g.update(overrides or {})
    return g


def build_joint_train(cfg: dict, device, seed: int, overrides=None):
    """The joint pretraining step as ``entry.train_entry`` builds it
    (fused AdamW, the configuration's compute dtype, fp32 params, the
    pre-mask in the step) -> (step, state, geometry).  The step is the
    engine's own, called
    ``step(state, x, mask_ratio, batch2d=..., mask_ratio_2d=...,
    noise=...)``: the 2D batch that ``train_entry`` binds is dropped, each
    step is given its own."""
    import torch

    from octcubem_tpu_torch import entry
    from octcubem_tpu_torch.models import mae3d

    g = geometry(cfg, overrides)
    model_kw = dict(dtype=getattr(torch, g["compute"]),
                    patch_size=g["patch_size"], embed_dim=g["embed_dim"],
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
            device=device, dec_heads=g["decoder_num_heads"], batch=g["batch"],
            ctor=mae3d.MaskedAutoencoderViT3D, input_size=g["input_size"],
            joint=True, batch2d=g["batch2d"], accum_2d=g["accum_2d"],
            use_premask=g["use_premask"], **model_kw)
    del x
    return step.func, state, g


def flops_per_step(g: dict) -> float:
    """Analytic FLOPs of one joint step (fwd + bwd = 3 x fwd): the volumes'
    3D MAE and the 2D images' MAE at one tube over the high-res grid.
    The pre-mask's similarity products (2.7 GFLOP a volume) are left
    out."""
    common = dict(d=g["embed_dim"], layers=g["depth"],
                  dd=g["decoder_embed_dim"], dlayers=g["decoder_depth"],
                  patch=g["patch_size"], tpatch=g["t_patch_size"])
    f3 = work.mae_train_flops(frames=g["num_frames"], img=g["input_size"],
                              mask=g["mask_ratio"], **common)
    f2 = work.mae_train_flops(frames=g["t_patch_size"],
                              img=g["high_res_input_size"],
                              mask=g["mask_ratio_2d"], **common)
    return g["batch"] * f3 + g["batch2d"] * f2
