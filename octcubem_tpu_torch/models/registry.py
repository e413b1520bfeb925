"""Model name registry (counterpart of octcubem_tpu/models/registry.py):
the reference's ``models_*.__dict__[name]`` constructor pattern.

The port serves the families it has: ``vit_st`` (aggregate head),
``vit_st_dropout`` (dropout head) and ``mae3d``.  ``vit2d``,
``vit_3dhead`` and ``slivit`` come with the fine-tuning family (ROADMAP
A12), the COEM JSON configs with the contrastive path (A13); asking for
them raises ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

from . import mae3d, vit_st

_FAMILIES = {
    "vit_st": vit_st,
    "vit_st_dropout": vit_st,
    "mae3d": mae3d,
}
_LATER = {"vit2d": "A12", "vit_3dhead": "A12", "slivit": "A12"}


def _family(family: str):
    if family in _LATER:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet "
            f"(ROADMAP {_LATER[family]})")
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
    if ctor is None or not name.startswith(("vit", "mae", "flash")):
        raise KeyError(
            f"unknown model {name!r} in family {family!r}; available: "
            f"{[n for n in dir(mod) if n.startswith(('vit', 'mae', 'flash'))]}")
    return mod.create_model(ctor, device=device, seed=seed,
                            state_dict=state_dict, **kwargs)


def list_coem_configs() -> list[str]:
    raise NotImplementedError(
        "the COEM model configs are not ported yet (ROADMAP A13)")


def create_coem_model(name_or_path: str, num_classes: int | None = None,
                      **kwargs):
    raise NotImplementedError(
        "the COEM contrastive models are not ported yet (ROADMAP A13)")
