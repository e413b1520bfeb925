"""Model name registry (counterpart of octcubem_tpu/models/registry.py):
the reference's ``models_*.__dict__[name]`` constructor pattern.

Families and the reference modules they follow:
  vit_st            -> models_vit_st_flash_attn_nodrop (aggregate head)
  vit_st_dropout    -> models_vit_st_flash_attn (dropout head)
  vit2d             -> models_vit / models_vit_flash_attn
  vit_3dhead        -> models_vit_3dhead_flash_attn
  mae3d             -> models_mae_joint_res_flash_attn
  slivit            -> model_slivit_baseline / models_vit_st_flash_attn_slivit
The COEM JSON configs come with the contrastive path (ROADMAP A13);
asking for them raises ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

from . import mae3d, slivit, vit2d, vit_3dhead, vit_st

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


def list_coem_configs() -> list[str]:
    raise NotImplementedError(
        "the COEM model configs are not ported yet (ROADMAP A13)")


def create_coem_model(name_or_path: str, num_classes: int | None = None,
                      **kwargs):
    raise NotImplementedError(
        "the COEM contrastive models are not ported yet (ROADMAP A13)")
