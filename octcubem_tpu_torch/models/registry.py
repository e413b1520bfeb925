"""Model name registry (counterpart of octcubem_tpu/models/registry.py):
the reference's ``models_*.__dict__[name]`` constructor pattern.

Families and the reference modules they follow:
  vit_st            -> models_vit_st_flash_attn_nodrop (aggregate head)
  vit_st_dropout    -> models_vit_st_flash_attn (dropout head)
  vit2d             -> models_vit / models_vit_flash_attn
  vit_3dhead        -> models_vit_3dhead_flash_attn
  mae3d             -> models_mae_joint_res_flash_attn
  slivit            -> model_slivit_baseline / models_vit_st_flash_attn_slivit
  coem2 / coem3     -> open_clip CustomTextCLIP(3Mod), from the JSON
                       configs in ``configs/`` (open_clip/factory.py)
"""

from __future__ import annotations

import json
import os

from . import coem, mae3d, slivit, vit2d, vit_3dhead, vit_st

_FAMILIES = {
    "vit_st": vit_st,
    "vit_st_dropout": vit_st,
    "vit2d": vit2d,
    "vit_3dhead": vit_3dhead,
    "mae3d": mae3d,
    "slivit": slivit,
}
_CTOR_PREFIXES = ("vit", "mae", "flash", "slivit")


def _family(family: str):
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family {family!r}; available: "
                       f"{sorted(_FAMILIES)}")
    return _FAMILIES[family]


def create_model(family: str, name: str, device=None, seed: int = 0,
                 state_dict=None, **kwargs):
    """create_model('vit_st', 'flash_attn_vit_large_patch16', ...): the
    named constructor of ``family``, built by that module's
    ``create_model`` (seeded init on ``device``, default cuda, then
    ``state_dict`` imported over it)."""
    mod = _family(family)
    if family == "vit_st_dropout":
        kwargs.setdefault("head_type", "dropout")
    ctor = getattr(mod, name, None)
    if ctor is None or not name.startswith(_CTOR_PREFIXES):
        raise KeyError(
            f"unknown model {name!r} in family {family!r}; available: "
            f"{[n for n in dir(mod) if n.startswith(_CTOR_PREFIXES)]}")
    return mod.create_model(ctor, device=device, seed=seed,
                            state_dict=state_dict, **kwargs)


CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def list_coem_configs() -> list[str]:
    if not os.path.isdir(CONFIG_DIR):
        return []
    return sorted(f[:-5] for f in os.listdir(CONFIG_DIR) if f.endswith(".json"))


def create_coem_model(name_or_path: str, num_classes: int | None = None,
                      device=None, seed: int = 0, state_dict=None, **kwargs):
    """A COEM model from a JSON config (the reference's model_configs
    pattern; schema {embed_dim, three_mod, vision_cfg, enface_cfg}), a
    name in ``configs/`` or a path; with ``num_classes`` its
    classification variant.  Built on ``device`` (default cuda) with
    seeded weights, then ``state_dict`` imported over them, as
    ``create_model``."""
    path = (name_or_path if os.path.isfile(name_or_path)
            else os.path.join(CONFIG_DIR, name_or_path + ".json"))
    with open(path) as f:
        cfg = json.load(f)
    three_mod = cfg.pop("three_mod", False)
    cfg.update(kwargs)
    if num_classes is not None:
        ctor = (coem.COEP3TowerClassification if three_mod
                else coem.COEP2TowerClassification)
        cfg["num_classes"] = num_classes
    else:
        ctor = coem.COEP3Tower if three_mod else coem.COEP2Tower
    return coem.create_model(ctor, device=device, seed=seed,
                             state_dict=state_dict, **cfg)
