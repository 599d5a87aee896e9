"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``; PyTorch's
headers are never included, so a build takes seconds.  The libraries land
in ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so a stale
library is never loaded.  Nothing is built when the package is imported:
the first launch builds what it needs, and ``build_all`` builds every
source at once with one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures, by entry name: the source ``csrc/<source>.cu``, the C
# function and its argument types; every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints.  An entry's name is
# its source's unless the source has several.
SIGNATURES = {
    "flash_attention": (
        "repro_flash_attention_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P],
    ),
    "paged_decode": (
        "repro_paged_decode_attention",
        [_P] * 6 + [_I] * 10 + [_F, _P],
    ),
    "paged_decode_max_clusters": (
        "repro_paged_decode_max_clusters",
        [_I] * 6 + [_P],
        "paged_decode",
    ),
    "galore_project": (
        "repro_galore_project_batched",
        [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "galore_project_2d": (
        "repro_galore_project",
        [_P] * 7 + [_I] * 5 + [_F] * 4 + [_P],
        "galore_project",
    ),
    "lowrank_adam": (
        "repro_lowrank_adam_update_batched",
        [_P] * 9 + [_I] * 5 + [_F] * 9 + [_P],
    ),
    "lowrank_backproject": (
        "repro_lowrank_backproject",
        [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P],
        "lowrank_adam",
    ),
    "lowrank_msgd": (
        "repro_lowrank_msgd_update_batched",
        [_P] * 6 + [_I] * 5 + [_F] * 4 + [_P],
    ),
    "lowrank_adam_mini": (
        "repro_lowrank_adam_mini_update_batched",
        [_P] * 8 + [_I] * 6 + [_F] * 5 + [_P],
    ),
    "lowrank_adam8bit": (
        "repro_lowrank_adam8bit_update_batched",
        [_P] * 17 + [_I] * 7 + [_F] * 9 + [_P],
    ),
    "power_iter": (
        "repro_power_iter_batched",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _source(entry_name: str) -> str:
    sig = SIGNATURES[entry_name]
    return sig[2] if len(sig) > 2 else entry_name


SOURCES = tuple(dict.fromkeys(_source(e) for e in SIGNATURES))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "src/repro_torch/csrc at first use and need the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc into a temporary file; returns (popen, tmp, final)."""
    final = _lib_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, final


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, final = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, final)  # atomic: a concurrent build never sees a half file
    return log


def build_all() -> Dict[str, str]:
    """Compile every source in parallel; returns name -> nvcc's output
    (register and shared-memory use from ``-Xptxas -v``; empty when the
    library was already built)."""
    started = {n: _start(n) for n in SOURCES}
    return {n: _finish(n, s) for n, s in started.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    its entry points' argument and return types declared."""
    if name not in _loaded:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry_name in SIGNATURES:
            if _source(entry_name) == name:
                fn_name, argtypes = SIGNATURES[entry_name][:2]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def entry(name: str):
    """The C entry point named ``name`` in ``SIGNATURES``."""
    return getattr(library(_source(name)), SIGNATURES[name][0])


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
