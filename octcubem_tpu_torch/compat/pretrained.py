"""Released-checkpoint registry: names -> sources + import recipes (the
port's copy of octcubem_tpu/compat/pretrained.py, pure Python; the
import notes name the compat functions both packages share).

The reference keeps an OpenCLIP URL registry (open_clip/pretrained.py)
plus README download links and a `ckpt/` drop directory; this module is
the equivalent map for the checkpoints the OCTCube-M release actually
ships (reference README.md:14-15,111-113), each entry naming the
torch_import path that loads it.  Nothing downloads: `locate()`
resolves a name against a local checkpoint directory.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class PretrainedEntry:
    filename: str
    description: str
    source: str                 # where the release publishes it
    model_family: str           # registry family that consumes it
    model: str                  # constructor name
    import_notes: str           # which compat path applies


REGISTRY: dict[str, PretrainedEntry] = {
    "octcube": PretrainedEntry(
        filename="OCTCube.pth",
        description="3D MAE-pretrained ViT-L/16 encoder (26,685 volumes)",
        source="https://huggingface.co/zucksliu/OCTCubeM (also Drive; "
               "reference README.md:15)",
        model_family="vit_st",
        model="flash_attn_vit_large_patch16",
        import_notes="import_state_dict(drop_keys=('head',)); Wqkv fused "
                     "qkv remap + pos-embed interpolation automatic",
    ),
    "octcube_multitask_cls": PretrainedEntry(
        filename="OCTCube_multitask_cls.pth",
        description="8-disease multi-task classifier (inference notebook "
                    "model; 48x256x256, dropout head)",
        source="https://huggingface.co/zucksliu/OCTCubeM "
               "(reference README.md:111)",
        model_family="vit_st_dropout",
        model="flash_attn_vit_large_patch16",
        import_notes="cli.infer / cli.predict load it directly; "
                     "cli.parity_check verifies logits vs a reference dump",
    ),
    "octcube_ir": PretrainedEntry(
        filename="OCTCube-IR.pt",
        description="2-tower OCT<->IR contrastive model",
        source="https://huggingface.co/zucksliu/OCTCubeM "
               "(reference README.md:15)",
        model_family="coem",
        model="vit_large_patch16_retFound_enface-"
              "vit_large_patch16_mae_joint_nodrop",
        import_notes="tower state dicts split on visual./text. prefixes; "
                     "see models/registry.create_coem_model",
    ),
    "retfound_oct": PretrainedEntry(
        filename="RETFound_oct_weights.pth",
        description="RETFound OCT 2D MAE weights (en face / 2D baselines "
                    "and retfound_2_flash_attn pretraining init)",
        source="https://github.com/rmaphoh/RETFound_MAE "
               "(reference README.md:99)",
        model_family="vit2d",
        model="vit_large_patch16",
        import_notes="convert_retfound_2d_state_dict for the 3D MAE init "
                     "path (resume_type='retfound_2_flash_attn')",
    ),
    "retfound_cfp": PretrainedEntry(
        filename="RETFound_cfp_weights.pth",
        description="RETFound color-fundus weights (enface tower init in "
                    "the shipped COEM configs)",
        source="https://github.com/rmaphoh/RETFound_MAE",
        model_family="vit2d",
        model="vit_large_patch16",
        import_notes="fused attn.qkv remap automatic in import_state_dict",
    ),
}


def locate(name: str, ckpt_dir: str = "./ckpt") -> str | None:
    """Resolve a registry name to an existing local file, or None.

    Checks $OCTCUBEM_CKPT_DIR, then ckpt_dir, for the entry's filename.
    """
    entry = REGISTRY[name]
    for d in (os.environ.get("OCTCUBEM_CKPT_DIR", ""), ckpt_dir):
        if not d:
            continue
        p = os.path.join(d, entry.filename)
        if os.path.isfile(p):
            return p
    return None


def describe() -> str:
    lines = []
    for name, e in REGISTRY.items():
        lines.append(f"{name}: {e.filename} — {e.description}\n"
                     f"  source: {e.source}\n"
                     f"  load:   {e.model_family}/{e.model}; {e.import_notes}")
    return "\n".join(lines)
