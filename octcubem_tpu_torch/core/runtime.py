"""Process-level runtime setup shared by the port's CLI entry points
(counterpart of octcubem_tpu/core/runtime.py).

The JAX package turns on XLA's persistent compile cache here, since it
compiles a program per shape.  The port compiles nothing per shape: what
it builds is its kernel libraries, once per source tree
(``ops/_cuda.py``, keyed by a hash of the sources and flags).  This
builds them all up front, one ``nvcc`` per source in parallel, into
``_cuda.build_dir()``, so a CLI pays for the build before it builds its
model and not inside its first step.  A later process finds them built.
"""

from __future__ import annotations

import os

import torch

_active: str | None = None


def setup_compilation_cache(cache_dir: str | None = None,
                            device: str | torch.device | None = None
                            ) -> str | None:
    """Build the kernel libraries for this process when it runs on the
    card.

    Directory resolution: explicit argument (which sets
    ``$OCTCUBEM_TPU_TORCH_BUILD`` for the process, so every later lookup
    finds the same libraries), else ``_cuda.build_dir()``; an empty
    string disables the up-front build (kernels then build at first
    use).  ``device`` other than cuda (the CPU, whose wrappers run the
    plain versions) builds nothing.  Safe to call more than once: the
    first call that builds wins, later calls return its directory.
    Returns the build directory in use, or None when nothing was built.
    """
    global _active
    if _active is not None:
        return _active
    dev = torch.device("cuda" if device is None else device)
    if cache_dir == "" or dev.type != "cuda":
        return None
    from ..ops import _cuda

    if cache_dir is not None:
        os.environ["OCTCUBEM_TPU_TORCH_BUILD"] = cache_dir
    _cuda.build()
    _active = str(_cuda.build_dir())
    return _active
