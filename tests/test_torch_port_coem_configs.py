"""Port parity: the COEM registry (models/registry.py, the JSON configs in
models/configs/) and the tower options against the JAX package on the
CPU: every shipped config builds in both packages with the same keys and
sizes (the port's params left uninitialised: full-width ViT-L towers), the
seeded init, the A13b towers' selectors, the int8 towers and capture_cam."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.models import coem as jcoem
from octcubem_tpu.models import registry as jreg
from octcubem_tpu_torch.compat.jax_params import _flatten, _to_torch_key
from octcubem_tpu_torch.models import coem as tcoem
from octcubem_tpu_torch.models import registry as treg
from octcubem_tpu_torch.nn.layers import QuantDense

VCFG = dict(num_frames=6, t_patch_size=3, img_size=128, patch_size=16,
            in_chans=1, embed_dim=32, depth=2, num_heads=2)
ECFG = dict(img_size=48, patch_size=16, in_chans=3, embed_dim=32, depth=2,
            num_heads=2)
EDIM = 16


def _jax_shapes(jm, args):
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *args)
    out = {}
    for path, leaf in _flatten(dict(shapes["params"])).items():
        key, _ = _to_torch_key(path)
        out[key] = int(np.prod(leaf.shape))
    return out


@pytest.mark.parametrize("name", jreg.list_coem_configs())
def test_every_config_builds_with_the_jax_keys(name, monkeypatch):
    """Each shipped config builds through create_coem_model, plain and as
    the classifier, with exactly the JAX tree's keys and sizes (params
    left uninitialised here: full-width ViT-L towers)."""
    monkeypatch.setattr(tcoem, "init_params", lambda model, gen: None)
    for num_classes in (None, 4):
        jm = jreg.create_coem_model(name, num_classes=num_classes,
                                    attn_impl="naive")
        three = isinstance(jm, (jcoem.COEP3Tower,
                                jcoem.COEP3TowerClassification))
        vcfg, ecfg = jm.vision_cfg, jm.enface_cfg
        tower = vcfg.get("tower")
        if tower == "vit2d":
            vis = jax.ShapeDtypeStruct((1, vcfg["img_size"],
                                        vcfg["img_size"], 3), jnp.float32)
        elif tower == "vit_3dhead":
            vis = jax.ShapeDtypeStruct((1, 2, vcfg["img_size"],
                                        vcfg["img_size"], 3), jnp.float32)
        else:
            vis = jax.ShapeDtypeStruct(
                (1, vcfg["num_frames"], vcfg["img_size"], vcfg["img_size"],
                 1), jnp.float32)
        enf = jax.ShapeDtypeStruct((1, ecfg["img_size"], ecfg["img_size"],
                                    3), jnp.float32)
        want = _jax_shapes(jm, (vis, enf, enf) if three else (vis, enf))
        tm = treg.create_coem_model(name, num_classes=num_classes,
                                    device="cpu")
        got = {k: v.numel() for k, v in tm.state_dict().items()}
        assert got == want, name
        assert tm.vision_cfg == vcfg and tm.enface_cfg == ecfg
        assert not tm.training


def test_registry_is_seeded():
    kw = dict(device="cpu", seed=3)
    a = treg.create_coem_model("vitl16_octcube_ir_tiny_test", **kw)
    b = treg.create_coem_model("vitl16_octcube_ir_tiny_test", **kw)
    c = treg.create_coem_model("vitl16_octcube_ir_tiny_test", device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    key = "visual.trunk.blocks.0.mixer.Wqkv.weight"
    assert not torch.equal(sa[key], sc[key])
    assert all(torch.isfinite(v).all() for v in sa.values())


@pytest.mark.parametrize("cfg,where", [
    (dict(layers=[1, 1, 1, 1], width=8), "vision"),
    (dict(hipt=True), "vision"),
    (dict(tower="focalnet"), "vision"),
    (dict(model_name="perceiver_tiny"), "vision"),
    (dict(hf_model_name="bert-base-uncased"), "enface"),
    (dict(hf_config="tiny bert"), "enface"),
    (dict(text=True, width=8), "enface"),
])
def test_aux_towers_are_a13b(cfg, where):
    """The A13b selectors build the aux towers of models/aux_towers.py
    (their parity: test_torch_port_aux_{towers,coem}.py); a HuggingFace
    model name is read from local files only, so an absent one raises
    OSError and nothing is fetched."""
    from transformers import BertConfig

    from octcubem_tpu_torch.models import aux_towers as taux

    if cfg.get("hf_config"):
        cfg = dict(hf_config=BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64))
    kw = dict(embed_dim=EDIM, vision_cfg=VCFG, enface_cfg=ECFG)
    kw["vision_cfg" if where == "vision" else "enface_cfg"] = cfg
    if "hf_model_name" in cfg:
        with pytest.raises(OSError):
            tcoem.COEP2Tower(**kw)
        return
    with torch.device("meta"):
        model = tcoem.COEP2Tower(**kw)
    tower = model.visual if where == "vision" else model.enface.tower
    want = {"layers": taux.ModifiedResNet, "hipt": taux.VisionTransformer4K,
            "tower": taux.FocalNetTower, "model_name": taux.PerceiverTower,
            "hf_config": taux.HFTextTower, "text": taux.TextTransformer}
    assert isinstance(tower, want[next(iter(cfg))])


def test_quant_towers_and_refusals():
    """quant=True builds QuantDense block projections in both towers (the
    ViT-ST and vit2d ones); the 3D-head tower and the text towers refuse
    it, as in JAX."""
    tm = tcoem.COEP2Tower(embed_dim=EDIM, vision_cfg=VCFG, enface_cfg=ECFG,
                          quant=True)
    assert isinstance(tm.visual.trunk.blocks[0].mixer.Wqkv, QuantDense)
    assert isinstance(tm.enface.trunk.blocks[1].mlp.fc2, QuantDense)
    with pytest.raises(ValueError, match="int8 quant"):
        tcoem.COEP2Tower(vision_cfg=dict(tower="vit_3dhead"), quant=True)
    with pytest.raises(ValueError, match="text towers"):
        tcoem.COEP2Tower(vision_cfg=VCFG, enface_cfg=dict(text=True),
                         quant=True)
    with pytest.raises(ValueError):
        jcoem.COEP2Tower(vision_cfg=dict(tower="vit_3dhead"),
                         quant=True).init(
            jax.random.key(0), jnp.zeros((1, 2, 32, 32, 3)),
            jnp.zeros((1, 48, 48, 3)))


def test_capture_cam_reaches_both_trunks():
    tm = tcoem.COEP2Tower(embed_dim=EDIM, vision_cfg=VCFG, enface_cfg=ECFG,
                          capture_cam=True)
    assert tm.visual.trunk.blocks.capture_cam
    assert tm.enface.trunk.blocks.capture_cam
    assert tcoem.OCTTower(**VCFG).lock_groups()[-1] == [
        "trunk.fc_aggregate_cls", "trunk.aggregate_cls_norm", "trunk.head"]
