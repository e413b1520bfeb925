"""AOT serving artifacts through ``torch.export`` (counterpart of
octcubem_tpu/compat/aot.py, which serialises ``jax.export`` StableHLO).

Freezes a model's forward into ONE file: the forward is exported with
``torch.export.export`` (weights inside the program) and saved with
``torch.export.save``.  Loading needs the port's ops module, which
registers the B1 custom op the graph calls
(``octcubem_tpu_torch::flash_fwd_packed_qkv``, ops/flash_attention.py),
and no model code, config or checkpoint tree.  The op's CUDA
implementation launches B1 on the card, its CPU one runs the plain
version, so a program runs on either device.

Container (the JAX package's, one file)::

    OCTPU-AOT1\\n           magic
    {...json header...}\\n  one line: format, platforms, shapes, dtypes,
                           the device it was exported on, user meta
    <raw bytes>            torch.export.save() payload

The header's ``"format": "torch.export"`` tells it from a JAX artifact,
which the loader refuses, as it refuses a bad magic and a platform the
header does not list.  Platforms are ``cuda`` and ``cpu``; the payload
is one program, exported on one device: ``torch.export`` records that
device in the program (its weights, and the device of any tensor the
forward creates), and the loader moves the program to the device it
runs on (``torch.export.passes.move_to_device_pass``) when they differ.
"""

from __future__ import annotations

import io
import json
import os

import torch

MAGIC = b"OCTPU-AOT1\n"
FORMAT = "torch.export"
PLATFORMS = ("cuda", "cpu")
FLASH_OP = "octcubem_tpu_torch.flash_fwd_packed_qkv"


def export_serving_artifact(module: torch.nn.Module, example_args, path: str,
                            platforms=None, meta: dict | None = None) -> str:
    """Export ``module(*example_args)`` and write a serving artifact to
    ``path`` -> ``path``.  The example args fix the (static) input
    shapes and dtypes; the module's weights go into the file.  The
    forward is traced with no gradient recorded, so attention is the B1
    op.  ``platforms`` defaults to the example inputs' device; pass
    ``("cuda", "cpu")`` for a file that serves on both.  A program with no
    call of the op is refused: its attention was traced as plain aten ops
    (only B1's packed path, head_dim in ``HEAD_DIMS``, is an op), which
    would never launch a kernel on the card."""
    args = tuple(example_args)
    device = args[0].device.type
    platforms = (device,) if platforms is None else tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {platforms}: each must be one of "
                         f"{PLATFORMS}")
    with torch.no_grad():
        program = torch.export.export(module, args)
    if not flash_op_calls(program):
        raise ValueError(f"the exported program holds no call of the B1 op "
                         f"{FLASH_OP}: its attention would run as plain "
                         f"aten ops on every device")
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = dict(meta or {})
    header.update({
        "format": FORMAT,
        "platforms": list(platforms),
        "exported_on": device,
        "in_shapes": [list(a.shape) for a in args],
        "in_dtypes": [str(a.dtype).removeprefix("torch.") for a in args],
        "torch": torch.__version__,
    })
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(json.dumps(header).encode() + b"\n")
        f.write(buf.getbuffer())
    os.replace(tmp, path)
    return path


def flash_op_calls(program) -> int:
    """Calls of the B1 custom op in an exported program's graph."""
    return sum(1 for node in program.graph.nodes
               if node.op == "call_function" and FLASH_OP in str(node.target))


def load_serving_artifact(path: str, device=None):
    """Load an artifact written by ``export_serving_artifact`` onto
    ``device`` (default cuda, which needs a card) -> ``(fn, meta)``:
    ``fn(*args)`` runs the program under inference mode (``fn.program``
    is the ExportedProgram), ``meta`` is the header.  Raises ValueError
    on a bad container, a JAX artifact, or a device whose platform the
    header does not list."""
    from ..core.device import resolve_device
    from ..ops import flash_attention  # noqa: F401  registers the B1 op

    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not an OCTPU-AOT1 artifact")
        header = json.loads(f.readline().decode())
        blob = f.read()
    if header.get("format") != FORMAT:
        raise ValueError(
            f"{path}: a {header.get('format', 'jax.export')!r} artifact; the "
            f"PyTorch port loads {FORMAT!r} artifacts (re-export with "
            f"octcubem_tpu_torch.compat.aot.export_serving_artifact)")
    dev = resolve_device(device)
    if dev.type not in header["platforms"]:
        raise ValueError(
            f"{path}: artifact exported for {header['platforms']}, but it "
            f"was asked to run on {dev.type!r}; re-export with "
            f"platforms=(..., {dev.type!r})")
    program = torch.export.load(io.BytesIO(blob))
    if dev.type != header["exported_on"]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    module = program.module()

    def fn(*args):
        with torch.inference_mode():
            return module(*args)

    fn.program = program
    return fn, header
