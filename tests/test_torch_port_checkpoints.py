"""The port's checkpoint reader against the JAX package's on the reference's
own save formats (CPU):

- OCTCube's ``{'model', 'optimizer', 'epoch', 'scaler', 'args'}``, whose
  'args' is an ``argparse.Namespace`` (OCTCube/util/misc.py);
- each wrapper the JAX loader unwraps ('model', 'state_dict',
  'model_state', 'teacher'; COEM saves under 'state_dict').

Both readers must return the same keys and values for the same file.
"""

import argparse

import numpy as np
import pytest
import torch

from octcubem_tpu.compat.torch_import import \
    load_torch_checkpoint as jax_load
from octcubem_tpu_torch.compat.torch_import import load_torch_checkpoint


def _flash_state(seed: int = 0) -> dict:
    """A small flash-layout state dict (bf16 and fp32 leaves)."""
    g = torch.Generator().manual_seed(seed)
    return {
        "cls_token": torch.randn((1, 1, 16), generator=g),
        "blocks.0.mixer.Wqkv.weight": torch.randn((48, 16), generator=g),
        "blocks.0.mixer.Wqkv.bias": torch.randn((48,), generator=g),
        "blocks.0.mixer.out_proj.weight":
            torch.randn((16, 16), generator=g).to(torch.bfloat16),
        "head.weight": torch.randn((4, 16), generator=g),
    }


def _assert_same(port: dict, ref: dict) -> None:
    assert set(port) == set(ref) and port
    for k, v in port.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_reference_training_checkpoint_loads(tmp_path):
    """OCTCube's training save: the weights under 'model' with 'module.'
    prefixes, beside optimizer state, an epoch, a scaler and the run's
    argparse.Namespace."""
    sd = {f"module.{k}": v for k, v in _flash_state().items()}
    path = tmp_path / "checkpoint-399.pth"
    torch.save({"model": sd, "optimizer": {"state": {}, "param_groups": []},
                "epoch": 399, "scaler": {"scale": 65536.0},
                "args": argparse.Namespace(model="flash_attn_vit_large_patch16",
                                           lr=1.5e-4, mask_ratio=0.9)}, path)
    got = load_torch_checkpoint(str(path))
    assert not any(k.startswith("module.") for k in got)
    _assert_same(got, jax_load(str(path)))


@pytest.mark.parametrize("wrapper", ["model", "state_dict", "model_state",
                                     "teacher"])
def test_each_wrapper_unwraps(wrapper, tmp_path):
    """A file whose weights sit under ``wrapper`` (with other entries beside
    it) reads to the weights themselves, as the JAX loader reads it."""
    path = tmp_path / f"{wrapper}.pth"
    torch.save({"epoch": 7, "name": "run", wrapper: _flash_state(1)}, path)
    got = load_torch_checkpoint(str(path))
    assert set(got) == set(_flash_state())
    _assert_same(got, jax_load(str(path)))
