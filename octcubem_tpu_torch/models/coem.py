"""retinal-COEM contrastive towers, OCT volume <-> en face IR / FAF
(counterpart of octcubem_tpu/models/coem.py).

Parity targets (retinal-COEM/src/open_clip/):
- the OCT tower: a ViT-ST with the aggregate head projecting to the CLIP
  embed dim (fc_aggregate_cls -> norm -> GELU -> head(out_dim));
- the en face tower: a 2D ViT trunk with a shared ``head`` projection,
  GELU, and one ``mod_head_{i}`` linear per modality; forward(x, modality);
- CustomTextCLIP / CustomTextCLIP3Mod: ``logit_scale`` initialised to
  ln(1/0.07) and used as exp(min(s, ln 100)) (a clamped scale gets no
  gradient); the 3-modality model adds ``logit_scale1`` / ``logit_scale2``;
- ClassificationHead and the two *Classification models: the towers'
  features concatenated -> LayerNorm -> MLP; a single-modality ablation
  zero-fills the missing towers.

Parameter names are the JAX package's flax paths in state-dict form
(``visual.trunk.blocks.0.mixer.Wqkv.weight``, ``enface.mod_head_0.weight``,
``clip.visual...`` + ``classification_head...`` in the classification
models), so ``compat.jax_params.state_dict_from_jax`` of a JAX tree loads
strictly.  Every attention call goes through the fused-QKV flash path
(B1 forward, B2 backward on the card).  ``generator`` draws drop-path
masks in training mode (the shipped configs' rate is 0).

The auxiliary towers (models/aux_towers.py) are selected as in the JAX
package: a list-valued ``layers`` builds the ModifiedResNet, ``hipt`` the
HIPT ViT-4K (whose attention runs the flash kernels), ``tower`` or
``model_name`` FocalNet and the Perceiver; in the en face slot
``hf_model_name`` / ``hf_config`` a HuggingFace text encoder and ``text``
the CLIP text transformer, both through ``_TextTowerAdapter`` (token ids
in, one projection, the modality index ignored).  A ModifiedResNet
refuses training mode without ``mutable=True``, so the COEM train steps
refuse it, as the JAX package's do (aux_towers.RESNET_GAP).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense, LayerNorm
from . import aux_towers
from .vit2d import VisionTransformer2D
from .vit_3dhead import VisionTransformer3DHead
from .vit_st import VisionTransformerST

LOGIT_SCALE_INIT = float(math.log(1 / 0.07))
LOGIT_SCALE_MAX = float(math.log(100.0))  # clamp at ln 100


class OCTTower(nn.Module):
    """ViT-ST trunk with the aggregate projection head to ``out_dim``.
    Input [B, T, H, W, C]."""

    def __init__(self, out_dim: int = 512, num_frames: int = 60,
                 t_patch_size: int = 3, img_size: int = 256,
                 patch_size: int = 16, in_chans: int = 1,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 drop_path_rate: float = 0.0, global_pool: bool = True,
                 sep_pos_embed: bool = True, cls_embed: bool = True,
                 parity: str = "flash", capture_cam: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        self.trunk = VisionTransformerST(
            num_frames=num_frames, t_patch_size=t_patch_size,
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            num_classes=out_dim, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, drop_path_rate=drop_path_rate,
            global_pool=global_pool, sep_pos_embed=sep_pos_embed,
            cls_embed=cls_embed, head_type="aggregate", parity=parity,
            capture_cam=capture_cam, dtype=dtype, attn_impl=attn_impl,
            remat=remat, quant=quant)

    def forward(self, x, generator: torch.Generator | None = None):
        return self.trunk(x, generator)

    def lock_groups(self) -> list[list[str]]:
        return [[f"trunk.{p}" for p in g] for g in self.trunk.lock_groups()]


class EnfaceTower(nn.Module):
    """2D ViT trunk, a shared projection and one head per modality.
    Input [B, H, W, C]."""

    def __init__(self, out_dim: int = 512, num_mod_head: int = 2,
                 img_size: int = 384, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, drop_path_rate: float = 0.0,
                 global_pool: bool = True, parity: str = "flash",
                 capture_cam: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        self.num_mod_head = num_mod_head
        self.trunk = VisionTransformer2D(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            num_classes=0, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, drop_path_rate=drop_path_rate,
            global_pool=global_pool, parity=parity, capture_cam=capture_cam,
            dtype=dtype, attn_impl=attn_impl, remat=remat, quant=quant)
        self.head = Dense(embed_dim, out_dim, compute_dtype=dtype)
        # mod_head_{i} attributes, so the keys read enface.mod_head_0.*
        for i in range(num_mod_head):
            setattr(self, f"mod_head_{i}",
                    Dense(out_dim, out_dim, compute_dtype=dtype))

    def forward(self, x, modality: int = 0,
                generator: torch.Generator | None = None):
        feat = self.trunk.forward_features(x, generator)
        feat = F.gelu(self.head(feat))
        return getattr(self, f"mod_head_{modality}")(feat)


def _normalize(x):
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


def _build_vision_tower(cfg, out_dim, dtype, attn_impl, remat, capture_cam,
                        quant=False):
    """The vision-tower dispatch of the JAX package: ``tower`` names the
    branch ('vit2d' = ViT_2Dhead, 'vit_3dhead' = ViT_3Dhead); a list-valued
    ``layers`` selects ModifiedResNet, ``hipt`` the HIPT ViT-4K (its cls
    head is the CLIP projection), 'focalnet' / a focalnet ``model_name``
    FocalNet, 'perceiver' the Perceiver; the default is the OCT ViT-ST
    tower."""
    cfg = dict(cfg or {})
    tower = cfg.pop("tower", None)
    if quant and tower not in (None, "vit2d"):
        raise ValueError(f"int8 quant is not wired for tower={tower!r} "
                         "(supported: the OCT ViT-ST and vit2d towers)")
    if quant and (isinstance(cfg.get("layers"), (list, tuple))
                  or cfg.get("hipt") or cfg.get("model_name")):
        raise ValueError("int8 quant is not wired for the aux towers")
    if tower == "vit2d":
        # the num_classes head doubles as the CLIP projection
        return VisionTransformer2D(num_classes=out_dim, dtype=dtype,
                                   attn_impl=attn_impl, remat=remat,
                                   quant=quant, **cfg)
    if tower == "vit_3dhead":
        return VisionTransformer3DHead(num_classes=out_dim, dtype=dtype,
                                       attn_impl=attn_impl, remat=remat,
                                       **cfg)
    if isinstance(cfg.get("layers"), (list, tuple)):
        cfg["layers"] = tuple(cfg["layers"])
        return aux_towers.ModifiedResNet(output_dim=out_dim, dtype=dtype,
                                         **cfg)
    if cfg.pop("hipt", False):
        return aux_towers.VisionTransformer4K(num_classes=out_dim,
                                              dtype=dtype, **cfg)
    if tower == "focalnet" or str(cfg.get("model_name", "")).startswith(
            "focalnet"):
        name = cfg.pop("model_name", "focalnet_tiny_srf")
        return aux_towers.FocalNetTower(out_dim=out_dim, model_name=name,
                                        trunk_cfg=cfg, dtype=dtype)
    if tower == "perceiver" or "perceiver" in str(cfg.get("model_name", "")):
        cfg.pop("model_name", None)
        return aux_towers.PerceiverTower(out_dim=out_dim, cfg=cfg, dtype=dtype)
    return OCTTower(out_dim=out_dim, dtype=dtype, attn_impl=attn_impl,
                    remat=remat, capture_cam=capture_cam, quant=quant, **cfg)


def _build_enface_tower(cfg, out_dim, dtype, attn_impl, remat, capture_cam,
                        quant=False):
    """The en face tower dispatch: the shipped configs feed images to the
    multi-head ViT trunk (EnfaceTower); ``hf_model_name`` / ``hf_config``
    select a HuggingFace text encoder and ``text`` the CLIP text
    transformer, each behind ``_TextTowerAdapter``."""
    cfg = dict(cfg or {})
    if quant and _is_text(cfg):
        raise ValueError("int8 quant is not wired for text towers")
    if cfg.get("hf_model_name") or cfg.get("hf_config"):
        return _TextTowerAdapter(aux_towers.HFTextTower(
            output_dim=out_dim, model_name_or_path=cfg.get("hf_model_name"),
            hf_config=cfg.get("hf_config"),
            pooler_type=cfg.get("pooler_type", "mean_pooler"),
            proj=cfg.get("proj", "linear"), dtype=dtype))
    if cfg.pop("text", False):
        return _TextTowerAdapter(aux_towers.TextTransformer(
            output_dim=out_dim, dtype=dtype, **cfg))
    return EnfaceTower(out_dim=out_dim, dtype=dtype, attn_impl=attn_impl,
                       remat=remat, capture_cam=capture_cam, quant=quant,
                       **cfg)


def _is_text(cfg: dict) -> bool:
    """Whether an en face config selects a text tower."""
    return bool(cfg.get("hf_model_name") or cfg.get("hf_config")
                or cfg.get("text"))


class _TextTowerAdapter(nn.Module):
    """A (token ids -> feature) text tower in the en face slot: the call
    contract enface(x, modality, generator), the modality ignored (one
    projection).  Its parameters read ``enface.tower.*``."""

    def __init__(self, tower: nn.Module):
        super().__init__()
        self.tower = tower

    def forward(self, x, modality: int = 0,
                generator: torch.Generator | None = None):
        return self.tower(x, generator)


def _scale(s):
    """exp(min(s, ln 100)), as a 0-d fp32 tensor."""
    return torch.exp(torch.clamp(s, max=LOGIT_SCALE_MAX))


class COEP2Tower(nn.Module):
    """The 2-tower contrastive model (OCTCube-IR): forward ->
    (image features, en face features, logit scale), features
    L2-normalized (fp32)."""

    def __init__(self, embed_dim: int = 512, vision_cfg: dict | None = None,
                 enface_cfg: dict | None = None, capture_cam: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.vision_cfg, self.enface_cfg = vision_cfg, enface_cfg
        self.visual = _build_vision_tower(vision_cfg, embed_dim, dtype,
                                          attn_impl, remat, capture_cam,
                                          quant=quant)
        # the forward calls modality 0 only, and flax creates only the
        # heads a forward calls: the JAX tree has mod_head_0 alone
        cfg = dict(enface_cfg or {})
        if not _is_text(cfg):
            cfg["num_mod_head"] = 1
        self.enface = _build_enface_tower(cfg, embed_dim, dtype, attn_impl,
                                          remat, capture_cam, quant=quant)
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))

    def encode_image(self, image, normalize: bool = False,
                     generator: torch.Generator | None = None):
        f = self.visual(image, generator)
        return _normalize(f) if normalize else f

    def encode_enface(self, enface, normalize: bool = False,
                      modality: int = 0,
                      generator: torch.Generator | None = None):
        f = self.enface(enface, modality, generator)
        return _normalize(f) if normalize else f

    def forward(self, image, enface, single_modality: Optional[str] = None,
                generator: torch.Generator | None = None):
        scale = _scale(self.logit_scale)
        if single_modality == "image":
            return self.encode_image(image, True, generator), None, scale
        if single_modality == "enface":
            return (None, self.encode_enface(enface, True, 0, generator),
                    scale)
        return (self.encode_image(image, True, generator),
                self.encode_enface(enface, True, 0, generator), scale)


class COEP3Tower(nn.Module):
    """The 3-modality model (OCT + IR + FAF through the 2-head en face
    trunk): forward -> (img, enf1, enf2, scale, scale1, scale2)."""

    def __init__(self, embed_dim: int = 512, vision_cfg: dict | None = None,
                 enface_cfg: dict | None = None, capture_cam: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.vision_cfg, self.enface_cfg = vision_cfg, enface_cfg
        self.visual = _build_vision_tower(vision_cfg, embed_dim, dtype,
                                          attn_impl, remat, capture_cam,
                                          quant=quant)
        cfg = dict(enface_cfg or {})
        cfg.setdefault("num_mod_head", 2)
        self.enface = _build_enface_tower(cfg, embed_dim, dtype, attn_impl,
                                          remat, capture_cam, quant=quant)
        for name in ("logit_scale", "logit_scale1", "logit_scale2"):
            setattr(self, name,
                    nn.Parameter(torch.tensor(LOGIT_SCALE_INIT)))

    def forward(self, image, enface1, enface2,
                single_modality: Optional[str] = None,
                generator: torch.Generator | None = None):
        scales = tuple(_scale(s) for s in (
            self.logit_scale, self.logit_scale1, self.logit_scale2))
        img = enf1 = enf2 = None
        if single_modality in (None, "image"):
            img = _normalize(self.visual(image, generator))
        if single_modality in (None, "enface1"):
            enf1 = _normalize(self.enface(enface1, 0, generator))
        if single_modality in (None, "enface2"):
            enf2 = _normalize(self.enface(enface2, 1, generator))
        return (img, enf1, enf2) + scales


class ClassificationHead(nn.Module):
    """LayerNorm -> fc1 -> GELU -> fc2 over ``in_dim`` concatenated
    features (model.py:723-739)."""

    def __init__(self, in_dim: int, hidden_dim: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_norm = LayerNorm(in_dim)
        self.fc1 = Dense(in_dim, hidden_dim, compute_dtype=dtype)
        self.fc2 = Dense(hidden_dim, num_classes, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.input_norm(x))))


class COEP2TowerClassification(nn.Module):
    """The 2-tower features concatenated -> classification head
    (model.py:741-770): forward -> (logits, logit scale)."""

    def __init__(self, embed_dim: int = 512, num_classes: int = 2,
                 vision_cfg: dict | None = None,
                 enface_cfg: dict | None = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.vision_cfg, self.enface_cfg = vision_cfg, enface_cfg
        self.clip = COEP2Tower(embed_dim=embed_dim, vision_cfg=vision_cfg,
                               enface_cfg=enface_cfg, dtype=dtype,
                               attn_impl=attn_impl, remat=remat)
        self.classification_head = ClassificationHead(
            2 * embed_dim, embed_dim, num_classes, dtype)

    def forward(self, image, enface, single_modality: Optional[str] = None,
                generator: torch.Generator | None = None):
        img, enf, scale = self.clip(image, enface, single_modality, generator)
        if single_modality == "image":
            feats = torch.cat([img, torch.zeros_like(img)], dim=-1)
        elif single_modality == "enface":
            feats = torch.cat([torch.zeros_like(enf), enf], dim=-1)
        else:
            feats = torch.cat([img, enf], dim=-1)
        return self.classification_head(feats), scale


class COEP3TowerClassification(nn.Module):
    """The 3-tower features concatenated -> classification head
    (model.py:772-810): forward -> (logits, scale, scale1, scale2)."""

    def __init__(self, embed_dim: int = 512, num_classes: int = 2,
                 vision_cfg: dict | None = None,
                 enface_cfg: dict | None = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.vision_cfg, self.enface_cfg = vision_cfg, enface_cfg
        self.clip = COEP3Tower(embed_dim=embed_dim, vision_cfg=vision_cfg,
                               enface_cfg=enface_cfg, dtype=dtype,
                               attn_impl=attn_impl, remat=remat)
        self.classification_head = ClassificationHead(
            3 * embed_dim, embed_dim, num_classes, dtype)

    def forward(self, image, enface1, enface2,
                single_modality: Optional[str] = None,
                generator: torch.Generator | None = None):
        img, e1, e2, s0, s1, s2 = self.clip(image, enface1, enface2,
                                            single_modality, generator)
        zero = torch.zeros_like(next(f for f in (img, e1, e2)
                                     if f is not None))
        feats = torch.cat([f if f is not None else zero
                           for f in (img, e1, e2)], dim=-1)
        return self.classification_head(feats), s0, s1, s2


# ---- seeded initialisation (the flax initialisers' distributions) ----

_WRAPPERS = ("clip.", "visual.", "enface.", "trunk.")


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator):
    """Seeded random weights with the JAX package's distributions: each
    parameter as ``vit_st.init_vit_param`` by its name inside the towers
    (so every ``head`` kernel N(0, 0.02)), the ``mod_head_{i}`` and the
    classification fc1 kernels N(0, 0.02), the logit scales ln(1/0.07); a
    quant model's int8 weights 0 and scales 1; an aux tower's as its JAX
    modules initialise them (``aux_towers.init_tower``)."""
    from .vit_st import init_vit_param

    for name, b in model.named_buffers():
        if name.endswith("weight_q"):
            b.zero_()
        elif name.endswith(".scale"):
            b.fill_(1.0)
    aux = [m for m in model.modules()
           if isinstance(m, aux_towers.AUX_TOWERS)]
    for m in aux:
        aux_towers.init_tower(m, generator)
    aux_params = {id(p) for m in aux for p in m.parameters()}
    for name, p in model.named_parameters():
        if id(p) in aux_params:
            continue
        rel = name
        while rel.startswith(_WRAPPERS):
            rel = rel.split(".", 1)[1]
        if rel.startswith("logit_scale"):
            p.fill_(LOGIT_SCALE_INIT)
        elif (rel.startswith("mod_head_") and rel.endswith("weight")
              or rel == "classification_head.fc1.weight"):
            p.normal_(0.0, 0.02, generator=generator)
        else:
            init_vit_param(rel, p, generator)


def create_model(ctor, device=None, seed: int = 0, state_dict=None,
                 **kw) -> nn.Module:
    """``ctor(**kw)`` on ``device`` (default cuda) in eval mode with seeded
    random weights, then ``state_dict`` imported over them
    (``compat.torch_import.build_model``)."""
    from ..compat.torch_import import build_model

    return build_model(ctor, init_params, device, seed, state_dict,
                       **kw).eval()
