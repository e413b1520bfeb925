"""Typed config system + named presets (counterpart of
octcubem_tpu/core/config.py; the port keeps its own copy).

Replaces the reference's per-entry-point argparse forests (~100-120 flags
each, SURVEY §5.6) and the shell-script hyperparameter conventions.  Each
preset mirrors a canonical reference script configuration and is cited.
Every field and every preset value is the JAX package's, so a config
passes between the two packages through ``to_json`` / ``load_config``.
Field names that describe the JAX mesh (``n_data``, ``n_fsdp``, ``n_sp``,
``opt_chain``) are kept for that reason; the port's CLIs say what each
means on the card.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


def _d(**kw):
    return dataclasses.field(default_factory=lambda: dict(**kw))


@dataclasses.dataclass
class MAEPretrainConfig:
    """Joint-res 3D MAE pretraining.

    Preset 'vitl_joint' mirrors Pre-training/scripts/
    run_chunks_pretraining_vitl_oph_joint_flash_attn.sh:25-58.
    """

    model: str = "flash_attn_mae_vit_large_patch16"
    input_size: int = 256
    high_res_input_size: int = 512
    num_frames: int = 60
    t_patch_size: int = 3
    pred_t_dim: int = 60
    mask_ratio: float = 0.90
    mask_ratio_2d_min: float = 0.75
    mask_ratio_2d_max: float = 0.85
    norm_pix_loss: bool = False
    # MAE decoder head count.  16 = reference parity geometry
    # (Pre-training/models_mae_joint_res_flash_attn.py:807-843:
    # decoder_embed_dim 512 / 16 heads -> head_dim 32); 4 = head_dim 128
    # at the same params.  The decoder is a pretraining scaffold
    # discarded after pretraining.
    decoder_num_heads: int = 16
    # Encoder head count (16 = reference parity, head_dim 64).  Unlike
    # the decoder, the encoder IS the shipped artifact: re-partitioning
    # to 8 heads (head_dim 128) changes the function the checkpoint
    # computes, so every downstream consumer (finetune / infer / serve)
    # must build with the same num_heads.  The parameters are identical
    # either way (Wqkv is [3D, D] regardless of head slicing).
    num_heads: int = 16
    batch_size: int = 1
    batch_size_2d: int = 64
    accum_iter: int = 1
    epochs: int = 50
    warmup_epochs: int = 1
    blr: float = 1.6e-3
    min_lr: float = 0.0
    weight_decay: float = 0.05
    clip_grad: Optional[float] = None
    # the JAX package's legacy optax.chain AdamW layout; the port has one
    # AdamW (train/optim.py), whose update both layouts compute, so the
    # field is recorded and selects the same optimizer
    opt_chain: bool = False
    spl_k_max: float = 0.7
    spl_k_min: float = 0.3
    precision: str = "bf16"
    remat: bool = False
    # rematerialize only the 2D high-res branch of the joint step (the
    # 512^2 batch-64 2D side holds most of the activations), while the 3D
    # side keeps the no-remat graph (mae_engine model2d)
    remat_2d: bool = False
    # microbatch ONLY the 2D branch (mae_engine accum_2d): peak 2D
    # activation memory drops by the factor WITHOUT remat.  On an NVIDIA
    # H100 80GB HBM3 at 700 W (chip_smoke.py phase 15) the preset's step
    # peaks at 14.74 GiB, the 2D batch whole at 42.38 GiB and remat_2d at
    # 14.63 GiB.  Exclusive with accum_iter>1; batch_size_2d must divide
    # by it.  Gradient math identical (mean over microbatches).
    accum_2d: int = 1
    seed: int = 0
    output_dir: str = "./output_pretrain"
    resume: Optional[str] = None
    init_ckpt: Optional[str] = None
    # training_new | resume_latest | retfound_2_flash_attn | imagenet_mae |
    # imagenet_ft | training_continue_reset_optim  (reference
    # main_pretrain_oph_joint_2d512_flash_attn.py:457-571, 6+1 types)
    resume_type: str = "training_new"
    load_spl_dir: Optional[str] = None  # SPL dict dir for …reset_optim
    epoch_load_spl: int = -1            # which epoch's all_image_dict-*.pkl
    use_premask: bool = True
    n_data: Optional[int] = None  # data-parallel size (None = all)
    n_fsdp: int = 1
    # sequence parallelism over the 20k-token high-res attention
    # (parallel/sequence.py): n_sp > 1 routes attention through
    # attn_impl='flash_sp'
    n_sp: int = 1
    attn_impl: str = "auto"


@dataclasses.dataclass
class FinetuneConfig:
    """Downstream fine-tune.

    Preset 'octcube_multitask' mirrors OCTCube/scripts/Template/
    multitask_cls.sh:6-38 (ViT-L 3D ST, 48x256², blr 5e-3, layer decay
    0.65, wd 0.05, drop-path 0.2, batch 1).
    """

    model: str = "flash_attn_vit_large_patch16"
    model_family: str = "vit_st"  # vit_st | vit_st_dropout | vit2d | vit_3dhead
    task_mode: str = "multi_task_default"
    num_classes: int = 16
    num_frames: int = 48
    t_patch_size: int = 3
    input_size: int = 256
    in_chans: int = 1
    # encoder head partitioning — MUST match the pretrain geometry the
    # finetune_ckpt was trained with (16 = reference checkpoints; 8 =
    # encoders pretrained with MAEPretrainConfig.num_heads=8).  The
    # parameters are identical across values, so a mismatch loads
    # cleanly but computes the wrong function.
    num_heads: int = 16
    batch_size: int = 1
    epochs: int = 50
    warmup_epochs: int = 5
    blr: float = 5e-3
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    layer_decay: float = 0.65
    drop_path: float = 0.2
    smoothing: float = 0.1
    clip_grad: Optional[float] = None
    use_focal: bool = False
    global_pool: bool = True
    sep_pos_embed: bool = True
    cls_embed: bool = True
    # variable_joint dual-resolution fine-tune (main_finetune_downstream_
    # inhouse_singlefold.py:84-85,269-276 + models_vit_st_joint_flash_attn
    # .py:74-120): dataset yields (low, high) pairs; training alternates
    # the two streams through the joint model's resolution dispatch.
    variable_joint: bool = False
    high_res_input_size: int = 512
    high_res_num_frames: Optional[int] = None
    k_folds: int = 1
    fold: int = 0
    # SLIViT cross-modality experiments (--slivit_exp path,
    # main_finetune_downstream_inhouse_singlefold_diffmodal.py:82-101):
    # slivit_dataset selects nodule-CT (ct3d) or EchoNet (us3d);
    # slivit_depth = --slivit_vit_depth_num (compact-ViT head layers)
    slivit_dataset: Optional[str] = None  # None | ct3d | us3d
    slivit_depth: int = 5
    patience: Optional[int] = None
    early_stop_patience: Optional[int] = None
    precision: str = "bf16"
    seed: int = 0
    output_dir: str = "./output_finetune"
    finetune_ckpt: Optional[str] = None  # pretrained checkpoint to load
    eval_only: bool = False
    disease_list: tuple = ("AMD", "DME", "POG", "ERM", "DR", "VD", "RAORVO", "RNV")
    n_data: Optional[int] = None
    n_fsdp: int = 1


@dataclasses.dataclass
class RetClipConfig:
    """Contrastive (COEM) training.

    Preset 'octcube_ir' mirrors retinal-COEM/src/scripts/retclip_train/
    train_IR_512-MAE3D-nodrop-vit-large.sh:21-50 (bsz 32x4 accum 4,
    lr 1e-4, 50 epochs, grad ckpt, lock-image 9 unlocked groups).
    """

    model: str = "vit_large_patch16_retclip"
    embed_dim: int = 512
    three_mod: bool = False
    vision_cfg: dict = _d(num_frames=60, t_patch_size=3, img_size=256,
                          patch_size=16, in_chans=1, embed_dim=1024,
                          depth=24, num_heads=16)
    enface_cfg: dict = _d(img_size=384, patch_size=16, in_chans=3,
                          embed_dim=1024, depth=24, num_heads=16)
    batch_size: int = 32
    accum_freq: int = 4
    epochs: int = 50
    warmup_steps: int = 200
    lr: float = 1e-4
    weight_decay: float = 0.1
    lock_image: bool = True
    lock_image_unlocked_groups: int = 9
    # 'partition' = real freezing (no frozen backward, no moments —
    # reference lock() requires_grad=False semantics); 'zero_scale' =
    # zero-scaled updates, still differentiates
    lock_mode: str = "partition"
    grad_checkpointing: bool = True
    precision: str = "bf16"
    seed: int = 0
    output_dir: str = "./output_retclip"
    resume: Optional[str] = None
    visual_init_ckpt: Optional[str] = None   # OCTCube.pth
    enface_init_ckpt: Optional[str] = None   # RETFound_cfp_weights.pth
    save_frequency: int = 1
    keep_last: Optional[int] = 5
    evaluate_only: bool = False
    save_retrieval_results: bool = False
    n_data: Optional[int] = None
    n_fsdp: int = 1
    # resume-compat escapes: a full-TrainState restore needs the SAME
    # optimizer layout; resume_params_only=true restores params only
    # (fresh optimizer) and works across any layout change
    opt_chain: bool = False
    resume_params_only: bool = False


@dataclasses.dataclass
class InferConfig:
    """Single-volume inference (inference_OCTCube.ipynb cell 4 defaults)."""

    model: str = "flash_attn_vit_large_patch16"
    ckpt: Optional[str] = None
    t_patch_size: int = 3
    num_frames: int = 48
    input_size: int = 256
    nb_classes: int = 16
    global_pool: bool = True
    sep_pos_embed: bool = True
    cls_embed: bool = True
    precision: str = "fp32"   # parity path: fp32 + highest matmul precision


PRESETS: dict[str, Any] = {
    # the full joint config (3D batch 4 + 2D 512^2 batch 64), its 2D
    # branch in 4 microbatches (no remat): on an NVIDIA H100 80GB HBM3 at
    # 700 W it peaks at 14.74 GiB against 42.38 GiB with the 2D batch
    # whole (chip_smoke.py phase 15); remat_2d is the other mitigation
    "vitl_joint_pretrain": MAEPretrainConfig(accum_2d=4),
    # same encoder (the shipped artifact is unchanged in architecture),
    # decoder re-partitioned to 4 heads (head_dim 128) at the same params
    "vitl_mae_tpu_native": MAEPretrainConfig(accum_2d=4,
                                             decoder_num_heads=4),
    # encoder ALSO re-partitioned (8 heads -> head_dim 128).  Unlike
    # vitl_mae_tpu_native this changes the shipped encoder's function
    # (checkpoint tensors stay reference-shaped, but downstream
    # finetune/infer/serve must build with num_heads=8 — the CLIs all
    # expose the knob)
    "vitl_mae_tpu_native_enc8": MAEPretrainConfig(accum_2d=4,
                                                  decoder_num_heads=4,
                                                  num_heads=8),
    # ViT-H/14 — the next model size up, which the reference registry
    # ships but never trains (mae_vit_huge_patch14,
    # Pre-training/models_mae_joint_res_flash_attn.py:829-843).  224^2
    # volumes (patch 14 -> the same 5121-token decoder sequence as ViT-L
    # at 256^2/16), enc 10 heads (1280/10 = head_dim 128), dec 4 heads.
    # The 2D branch runs 448^2 (14-divisible counterpart of the ViT-L
    # 512^2) with the same accum_2d microbatching.
    "vith_mae_tpu_native": MAEPretrainConfig(
        model="mae_vit_huge_patch14", input_size=224,
        high_res_input_size=448, batch_size=4, num_heads=10,
        decoder_num_heads=4, accum_2d=4),
    # high-res joint pretrain with the 20k-token attention sharded 4-way
    # over a composed (data, sp) mesh — the case sequence parallelism was
    # built for (SURVEY §5.7 optional headroom)
    "vitl_joint_pretrain_sp4": MAEPretrainConfig(n_sp=4,
                                                 attn_impl="flash_sp"),
    "octcube_multitask": FinetuneConfig(),
    # SLIViT cross-modality baselines (main_…diffmodal.py --slivit_exp):
    # nodule-CT classification — the reference loads 28^3 MedMNIST and
    # hard-resizes every volume to (60, 256, 256) (MedMNISTDataset3D.py
    # t_compose Resized spatial_size=(60,256,256); --slivit_slices
    # default 60, main_…diffmodal.py:100), so 60 slices through the
    # ConvNeXt trunk at 256^2 — and EchoNet EF regression
    "slivit_ct3d": FinetuneConfig(
        model_family="slivit", model="slivit_baseline",
        slivit_dataset="ct3d", task_mode="multi_cls", num_classes=2,
        num_frames=60, input_size=256, batch_size=4, epochs=20,
        blr=5e-4, layer_decay=1.0, disease_list=("nodule",)),
    "slivit_us3d": FinetuneConfig(
        model_family="slivit", model="slivit_baseline",
        slivit_dataset="us3d", task_mode="regression", num_classes=1,
        num_frames=32, input_size=256, batch_size=4, epochs=20,
        blr=5e-4, layer_decay=1.0, disease_list=("EF",)),
    "octcube_ir": RetClipConfig(),
    "octcube_ef": RetClipConfig(three_mod=True),
    "infer_8disease": InferConfig(),
}


def load_config(cls, path_or_preset: str, **overrides):
    """Load from a preset name or a JSON file, with keyword overrides."""
    if path_or_preset in PRESETS:
        cfg = dataclasses.replace(PRESETS[path_or_preset])
    else:
        with open(path_or_preset) as f:
            data = json.load(f)
        cfg = cls(**data)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def check_resume_geometry(cfg, prev_args_json: str, fields) -> None:
    """Fail loudly when a resume's model-geometry fields differ from the
    prior run's recorded config: across head re-partitionings (and
    several other geometry fields) the parameters are identical, so the
    restore succeeds and silently trains a DIFFERENT function.  Missing/
    unreadable file or absent fields (older runs) skip silently."""
    try:
        with open(prev_args_json) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        return
    diffs = [(k, prev[k], getattr(cfg, k)) for k in fields
             if k in prev and prev[k] != getattr(cfg, k)]
    if diffs:
        detail = "; ".join(f"{k}: checkpoint run={a!r}, current={b!r}"
                           for k, a, b in diffs)
        raise SystemExit(
            f"--resume geometry mismatch vs {prev_args_json}: {detail}. "
            "The param tree is identical across these fields, so the "
            "restore would succeed and silently train a DIFFERENT "
            "function (e.g. an enc8-pretrained encoder resumed at 16 "
            "heads).  Pass the matching preset/flags or start a new run.")
