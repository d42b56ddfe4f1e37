"""Build and load the hand-written CUDA kernels.

Each ``photon_ml_torch/csrc/<name>.cu`` exports one or more plain
``extern "C"`` launchers.  It is compiled by ``nvcc`` for ``sm_90a`` into
a shared library under ``build/kernels/`` at the repository root, named
by a hash of its source and flags, and loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes.  A
library whose hash already exists is loaded as it is; any edit to the
source builds a new one.

Building needs ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``), which only the
machine with the GPU has.  Nothing here runs at import time: a kernel is
built the first time its wrapper launches it, or all at once by
``build_all()`` (``chip_smoke.py`` does that, and times it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills; a build prints that report to stderr.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32

# source name → {launcher name: argtypes}; each returns an int (a
# launcher: the CUDA status of its launch; otherwise as its source
# says).  The types are set on load.
_SIGNATURES = {
    "gather_rowsum": {
        "gather_rowsum_prepare": [],
        "gather_rowsum_launch": [
            _P,      # table  f32 [L]
            _P,      # vals   f32 [n, k]
            _P,      # ids    i32 [n, k]
            _P,      # out    f32 [n]
            _I64,    # n
            _I32,    # k
            _I32,    # vec: slots a thread loads at once (4 or 1)
            _I32,    # tpr: threads a row
            _I32,    # head: table entries copied into shared memory
            _I32,    # blocks
            _I32,    # device index
            _P,      # cudaStream_t
        ],
        "gather_rowsum_lanes_launch": [
            _P,      # table  f32 [T, lanes], lane-minor
            _P,      # vals   f32 [n, k]
            _P,      # ids    i32 [n, k]
            _P,      # out    f32 [n, lanes]
            _I64,    # n
            _I32,    # k
            _I32,    # lanes: 2, 4, 8 or 16
            _I32,    # vec: slots a thread loads at once (4 or 1)
            _I32,    # tpr: threads a row
            _I32,    # blocks
            _I32,    # device index
            _P,      # cudaStream_t
        ],
    },
    "grr_contract": {
        "grr_contract_dense_launch": [
            _P,              # table_t f32 [n_gw, 128, 128]
            _P, _P, _P,      # g1, g2, g3 i8 [n_st_p, 128, 128]
            _P,              # vals f32 [n_st_p, 128, 128]
            _P,              # gwg i32 [n_st_p / 4]
            _P,              # out f32 [n_ow_p, 128 / cap, 128]
            _P,              # scratch f32 [n_blocks, 2, 128 / cap, 128]
            _I32,            # n_gw
            _I32,            # n_ow_p
            _I32,            # cap
            _I32,            # n_blocks
            _P,              # cudaStream_t
        ],
        "grr_contract_launch": [
            _P,              # table_t f32 [n_gw, 128, 128]
            _P, _P, _P,      # g1, g2, g3 i8 [n_st, 128, 128]
            _P,              # vals f32 [n_st, 128, 128]
            _P,              # gw_of_st i32 [n_st]
            _P,              # ow_of_st i32 [n_st], sorted
            _P,              # out f32 [n_ow, 128 / cap, 128]
            _P,              # scratch f32 [n_blocks, 2, 128 / cap, 128]
            _I64,            # n_st
            _I32,            # n_ow
            _I32,            # cap
            _I32,            # n_blocks
            _P,              # cudaStream_t
        ],
    },
}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (popen, tmp, final) or None if
    the library is already built."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish_build(name: str, started) -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{out}")
    print(f"nvcc {name}.cu:\n{out}", file=sys.stderr, end="")
    os.replace(tmp, final)


def build_all(names=None) -> list[Path]:
    """Build every kernel (or ``names``), one ``nvcc`` per source, all
    started together; returns the library paths."""
    names = list(names) if names is not None else sorted(_SIGNATURES)
    started = {n: _start_build(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish_build(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built on first use), with
    every launcher's argument types set."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
        return lib
