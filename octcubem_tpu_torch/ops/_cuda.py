"""Build-at-first-use loader for the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries are named by a hash of the sources
and flags, so an edit rebuilds and an unchanged tree reuses the earlier
build.  They go to ``$OCTCUBEM_TPU_TORCH_BUILD`` when that is set, else to
``build/octcubem_tpu_torch/`` at the root of a checkout, else (an
installed package, whose directory may be read-only) to
``octcubem_tpu_torch/`` under ``$XDG_CACHE_HOME`` or ``~/.cache``.
Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.

``launches`` counts kernel calls per TPU kernel replaced (``COUNTERS``):
a wrapper adds one exactly where it calls its kernel (one call may be
several launches of one algorithm, as the backward's passes are), so a
run can show that its main path went through the kernels.  The
``[B, H, N, D]`` forward library serves three TPU kernels (B3, B5, B6)
and the backward two (B4, B7), counted apart.  ``adamw`` replaces no TPU
kernel (XLA fused optax's AdamW there) and counts one per update.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# both backward libraries: o, dO, g_lse, delta, B, H, n, D, strides (o, dO:
# batch, head, row), is_bf16, stream
_DELTA = ([_P] * 4 + [_I] * 4 + [_P, _I, _P], ctypes.c_int)

# library name -> (source file, {exported C function: (argtypes, restype)})
KERNELS = {
    "flash_fwd_packed": ("flash_fwd_packed.cu", {
        # q, k, v, kc, vc, o, lse, B, H, n, D, row_stride, batch_stride,
        # o_row_stride, o_batch_stride, scale, is_bf16, stream
        "octcube_flash_fwd_packed": ([_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _L, _L, _L, _L,
                                      _F, _I, _P], ctypes.c_int),
        "octcube_error_string": ([_I], ctypes.c_char_p),
    }),
    "flash_bwd_packed": ("flash_bwd_packed.cu", {
        # q, k, v, kc, vc, dO, lse, delta, dq, dk, dv, dkc, dvc, scratch,
        # dq_acc, B, H, n, D, row_stride, batch_stride, do_row_stride,
        # do_batch_stride, g_row_stride, g_batch_stride, gc_batch_stride,
        # scale, is_bf16, stream
        "octcube_flash_bwd_packed": ([_P] * 15 + [_I] * 4 + [_L] * 7
                                     + [_F, _I, _P], ctypes.c_int),
        # B, H, n, D, is_bf16 -> fp32 floats of cls partial sums
        "octcube_flash_bwd_packed_scratch": ([_I] * 5, ctypes.c_longlong),
        "octcube_flash_bwd_delta": _DELTA,
        "octcube_error_string": ([_I], ctypes.c_char_p),
    }),
    "flash_fwd_bh": ("flash_fwd_bh.cu", {
        # q, k, v, kc, vc, o, lse, B, H, nq, nk, D, strides (q, k, v, o:
        # batch, head, row), scale, is_bf16, exact, stream
        "octcube_flash_fwd_bh": ([_P] * 7 + [_I] * 5 + [_P, _F, _I, _I, _P],
                                 ctypes.c_int),
        "octcube_error_string": ([_I], ctypes.c_char_p),
    }),
    "flash_bwd_bh": ("flash_bwd_bh.cu", {
        # q, k, v, kc, vc, dO, lse, delta, dq, dk, dv, dkc, dvc, scratch,
        # dq_acc, B, H, nq, nk, kv_valid, D, strides (q, k, v, dO, dq, dk,
        # dv, dkc / dvc: batch, head, row), scale, no_max, is_bf16, stream
        "octcube_flash_bwd_bh": ([_P] * 15 + [_I] * 6 + [_P, _F, _I, _I, _P],
                                 ctypes.c_int),
        # B, H, nq, D, is_bf16 -> fp32 floats of cls partial sums
        "octcube_flash_bwd_bh_scratch": ([_I] * 5, ctypes.c_longlong),
        "octcube_flash_bwd_delta": _DELTA,
        "octcube_error_string": ([_I], ctypes.c_char_p),
    }),
    "flash_ablate": ("flash_ablate.cu", {
        # q, k, v, o, lse, BH, n, n_pad, D, tile, flags, scale, stream
        "octcube_flash_ablate": ([_P] * 5 + [_I] * 6 + [_F, _P], ctypes.c_int),
        "octcube_error_string": ([_I], ctypes.c_char_p),
    }),
    "adamw": ("adamw.cu", {
        # host arrays ptrs, sizes, ends, scale, decay; count, mu_bf16; host
        # array hyper; device pointers lr, c1, c2, clip, ok; stream
        "octcube_adamw": ([_P] * 5 + [_I] * 2 + [_P] * 7, ctypes.c_int),
        "octcube_error_string": ([_I], ctypes.c_char_p),
    }),
}

# built beside whichever library a process loads first, in the same nvcc
# round: a training run's first update would otherwise wait for its own
# build inside the step
BUILT_WITH_ANY = ("adamw",)

# launch counter -> the TPU kernel it replaces (octcubem_tpu/ops/
# flash_attention.py; B8 in scripts/kablate.py)
COUNTERS = {
    "flash_fwd_packed": "B1 _fwd_kernel_packed",
    "flash_bwd_packed": "B2 _bwd_kernel_packed",
    "flash_fwd_bh_cls": "B3 _fwd_kernel_nomax_cls",
    "flash_bwd_bh_cls": "B4 _fused_bwd_kernel_cls",
    "flash_fwd_bh": "B5 _fwd_kernel_nomax",
    "flash_fwd_bh_exact": "B6 _fwd_kernel",
    "flash_bwd_bh": "B7 _fused_bwd_kernel",
    "flash_ablate": "B8 fwd_variant",
    "adamw": "none: optax's AdamW, which XLA fuses into one pass",
}

launches: dict[str, int] = {name: 0 for name in COUNTERS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin, default /usr/local/cuda/bin)")


def build_dir() -> Path:
    """Where the libraries are built (see the module docstring)."""
    if env := os.environ.get("OCTCUBEM_TPU_TORCH_BUILD"):
        return Path(env)
    if (_ROOT / "pyproject.toml").is_file():
        return _ROOT / "build" / "octcubem_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "octcubem_tpu_torch"


def lib_path(name: str) -> Path:
    """Where the library of ``name`` is built: keyed on the source, every
    header under csrc/ and the flags."""
    src, _ = KERNELS[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    """nvcc's output (ptxas registers, shared memory, spills) of the last
    build of ``name``."""
    return lib_path(name).with_suffix(".log")


def build(names=None) -> dict[str, Path]:
    """Compile every library in ``names`` (default all) that is not built
    yet, one nvcc process per source, all started together.  nvcc's output
    is kept beside each library (``build_log``)."""
    names = list(KERNELS) if names is None else list(names)
    todo = [name for name in names if not lib_path(name).exists()]
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        text, _ = proc.communicate()
        build_log(name).write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed, with the C
    signatures of ``KERNELS[name]``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            built = build(dict.fromkeys((name, *BUILT_WITH_ANY)))
            lib = ctypes.CDLL(str(built[name]))
            for fn, (argtypes, restype) in KERNELS[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.octcube_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
