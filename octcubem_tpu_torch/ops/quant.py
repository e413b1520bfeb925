"""Int8 post-training quantization for the serving path (counterpart of
octcubem_tpu/ops/quant.py).

The scheme is the JAX package's, step for step (dynamic PTQ, no
calibration data):
- weights: symmetric per-output-channel int8, quantized once offline
  (``quantize_weight``);
- activations: symmetric per-token dynamic int8, each token row scaled
  by its own fp32 abs-max at run time;
- the product int8 x int8 -> int32 (``torch._int_mm``: cuBLASLt on the
  card, a reference loop on the CPU), rescaled in fp32 as
  ``y * (s_x * w_scale)`` and cast to the input's dtype.

The port keeps the reference weight layout: ``weight_q`` int8
[out, in], ``scale`` fp32 [out], the bias beside them.  Only the block
projections (``QUANT_MODULES``) are converted; attention itself stays
bf16 through the flash kernels.  The JAX product is XLA's dot, not a
Pallas kernel, so no hand kernel replaces it.
"""

from __future__ import annotations

from typing import Mapping

import torch

QUANT_MODULES = ("Wqkv", "out_proj", "fc1", "fc2")


def quantize_weight(w: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-output-channel int8 quantization.  w: [out, in]
    float -> (w_q int8 [out, in], scale fp32 [out]), w ~= w_q * scale."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    scale = torch.clamp_min(amax, eps) / 127.0
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return w_q.to(torch.int8), scale


def int8_mm(a: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] @ w_q.T (w_q int8 [N, K]) -> int32 [M, N].

    On the card ``torch._int_mm`` takes M > 16 and K, N multiples of 8;
    any other shape is refused here rather than run another way.  w_q.T
    is passed as a column-major [K, N] view, the operand layout cuBLASLt's
    int8 GEMM takes."""
    m, k = a.shape
    n = w_q.shape[0]
    if w_q.shape != (n, k):
        raise ValueError(f"w_q {tuple(w_q.shape)} is not [N, {k}]")
    if a.is_cuda and not (m > 16 and k % 8 == 0 and n % 8 == 0):
        raise ValueError(
            f"the card's int8 GEMM (torch._int_mm) takes M > 16 rows and K, "
            f"N multiples of 8; got M={m}, K={k}, N={n}")
    return torch._int_mm(a.contiguous(), w_q.t())


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Dynamically quantized x [..., K] @ (w_q [N, K] * w_scale [N]).T ->
    [..., N] in x's dtype: per-token abs-max scale, round half to even,
    clip to +-127, the int32 product, then y * (s_x * w_scale)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = torch.clamp_min(amax, eps) / 127.0
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    y = int8_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*x.shape[:-1], w_q.shape[0])
    return (y.float() * (s_x * w_scale)).to(x.dtype)


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor],
                        module_names=QUANT_MODULES) -> dict:
    """A float model's state dict -> the int8 serving layout: every 2-D
    ``{module}.weight`` whose module is named in ``module_names`` becomes
    ``{module}.weight_q`` and ``{module}.scale``; biases and everything
    else pass through.  It loads strictly into the same model built with
    ``quant=True`` (nn/layers.py ``QuantDense`` keeps the module names)."""
    out = {}
    for key, val in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        if (leaf == "weight" and mod.rpartition(".")[2] in module_names
                and val.ndim == 2):
            out[mod + ".weight_q"], out[mod + ".scale"] = quantize_weight(val)
        else:
            out[key] = val
    return out
