"""The host ETL library: LIBSVM parsing and the GRR plan builders in C++.

Counterpart of ``photon_ml_tpu/native/__init__.py``.  ``fast_etl.cpp`` is
a verbatim copy of the JAX package's source; this module binds the parts
the training path uses (``pml_libsvm_*``, ``pml_edge_color``,
``pml_grr_routes``, ``pml_grr_plan*``, ``pml_colmajor_*``).  It is host code, not a kernel of
the card.

Build: ``g++ -O3 -shared -fPIC`` into ``build/native/`` at the repository
root, named by a hash of the source and flags, at first use (seconds).
The library is written to a temporary file and moved into place with
``os.replace``, so concurrent builders (test workers) never load a
partial file.  ``lib()`` returns None where no compiler is available and
callers fall back to numpy; at full width that fallback (the Python edge
colorer) takes hours, so a run at scale checks ``native_available()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("fast_etl.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = False  # False = not yet attempted


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"fast_etl-{h.hexdigest()[:16]}.so"


def _build(final: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_name(f"{final.stem}.{os.getpid()}."
                          f"{threading.get_ident()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"photon_ml_torch.native: g++ unavailable ({e!r}); "
                         "using the numpy fallbacks\n")
        return False
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        sys.stderr.write("photon_ml_torch.native: build failed, using the "
                         f"numpy fallbacks\n{proc.stderr[:2000]}\n")
        return False
    os.replace(tmp, final)
    return True


def _bind(dll: ctypes.CDLL) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    dll.pml_libsvm_parse.restype = vp
    dll.pml_libsvm_parse.argtypes = [ctypes.c_char_p, i64]
    dll.pml_libsvm_sizes.argtypes = [
        vp, ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i32)]
    dll.pml_libsvm_fill.argtypes = [vp] * 5
    dll.pml_libsvm_free.argtypes = [vp]
    dll.pml_edge_color.restype = i32
    dll.pml_edge_color.argtypes = [vp, vp, i64, i32, i32, i32, vp]
    dll.pml_grr_routes.restype = i32
    dll.pml_grr_routes.argtypes = [vp, vp, i64, vp, vp, vp]
    dll.pml_grr_plan.restype = vp
    dll.pml_grr_plan.argtypes = [vp, vp, i64, i64, i32, i64, i64, i32,
                                 i64, i64]
    dll.pml_grr_plan_sizes.argtypes = [vp] + [ctypes.POINTER(i64)] * 2 + [
        ctypes.POINTER(i32)] * 4
    dll.pml_grr_plan_fill.argtypes = [vp] * 10
    dll.pml_grr_plan_free.argtypes = [vp]
    dll.pml_colmajor_vrows.restype = i64
    dll.pml_colmajor_vrows.argtypes = [vp, vp, i64, i64, i64, i64, vp]
    dll.pml_colmajor_fill.argtypes = [vp, vp, i64, i64, i64, i64, vp, i64,
                                      vp, vp, vp]


def lib() -> "ctypes.CDLL | None":
    """The loaded native library, or None (numpy fallback)."""
    global _lib
    if _lib is not False:
        return _lib  # type: ignore[return-value]
    with _lock:
        if _lib is not False:
            return _lib  # type: ignore[return-value]
        final = library_path()
        if not final.exists() and not _build(final):
            _lib = None
            return None
        try:
            dll = ctypes.CDLL(str(final))
        except OSError:
            _lib = None
            return None
        _bind(dll)
        _lib = dll
        return dll


def native_available() -> bool:
    """True when the native library is loaded (or loadable)."""
    return lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def libsvm_parse_native(data: bytes):
    """Parse LIBSVM text → (labels, row_ptr, cols, vals, max_col), or
    None without the native library.  Raises ValueError on malformed
    input (the Python parser's contract)."""
    dll = lib()
    if dll is None:
        return None
    handle = dll.pml_libsvm_parse(data, len(data))
    if not handle:
        raise ValueError("malformed LIBSVM input (native parser)")
    try:
        n = ctypes.c_int64()
        nnz = ctypes.c_int64()
        max_col = ctypes.c_int32()
        dll.pml_libsvm_sizes(handle, ctypes.byref(n), ctypes.byref(nnz),
                             ctypes.byref(max_col))
        labels = np.empty(n.value, np.float32)
        row_ptr = np.empty(n.value + 1, np.int64)
        cols = np.empty(nnz.value, np.int32)
        vals = np.empty(nnz.value, np.float32)
        dll.pml_libsvm_fill(handle, _ptr(labels), _ptr(row_ptr),
                            _ptr(cols), _ptr(vals))
        return labels, row_ptr, cols, vals, int(max_col.value)
    finally:
        dll.pml_libsvm_free(handle)


def edge_color_native(src: np.ndarray, dst: np.ndarray, n_left: int,
                      n_right: int, n_colors: int) -> "np.ndarray | None":
    """Proper edge coloring of a bipartite multigraph (Euler split); every
    degree must be divisible by ``n_colors`` (a power of two).  None
    without the native library."""
    dll = lib()
    if dll is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    color = np.empty(src.size, np.int32)
    rc = dll.pml_edge_color(_ptr(src), _ptr(dst), src.size, n_left,
                            n_right, n_colors, _ptr(color))
    if rc != 0:
        raise ValueError("pml_edge_color: invalid arguments")
    return color


def grr_routes_native(dst: np.ndarray, hi: np.ndarray):
    """Batched supertile routing → (g1, g2, g3) int8, or None without the
    native library.  ``dst``: [n_st,128,128] int32 slot bijections;
    ``hi``: [n_st,128,128] int8 gather planes."""
    dll = lib()
    if dll is None:
        return None
    dst = np.ascontiguousarray(dst, np.int32)
    hi = np.ascontiguousarray(hi, np.int8)
    g1, g2, g3 = np.empty_like(hi), np.empty_like(hi), np.empty_like(hi)
    rc = dll.pml_grr_routes(_ptr(dst), _ptr(hi), dst.shape[0], _ptr(g1),
                            _ptr(g2), _ptr(g3))
    if rc != 0:
        raise ValueError("pml_grr_routes: dst tile is not a bijection")
    return g1, g2, g3


def colmajor_build_native(cols: np.ndarray, vals: np.ndarray, dim: int,
                          capacity: int):
    """Transposed-ELL build → (tvals, trows, vcol), or None without the
    library.  A counting sort in row-scan order: the arrays of
    ``data.colmajor``'s numpy path, byte for byte."""
    dll = lib()
    if dll is None:
        return None
    from photon_ml_torch.ops.kernels import vrow_pad

    n, k = cols.shape
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    counts = np.zeros(dim, np.int64)
    v = dll.pml_colmajor_vrows(_ptr(cols), _ptr(vals), n, k, dim, capacity,
                               _ptr(counts))
    if v < 0:
        raise ValueError("column id out of range in colmajor build")
    v_pad = vrow_pad(int(v))
    tvals = np.zeros((v_pad, capacity), np.float32)
    trows = np.zeros((v_pad, capacity), np.int32)
    vcol = np.zeros(v_pad, np.int32)
    dll.pml_colmajor_fill(_ptr(cols), _ptr(vals), n, k, dim, capacity,
                          _ptr(counts), v_pad, _ptr(tvals), _ptr(trows),
                          _ptr(vcol))
    return tvals, trows, vcol


def grr_plan_native(cols: np.ndarray, vals: np.ndarray, direction: int,
                    table_len: int, n_segments: int, cap: int | None = None,
                    idx_range: "tuple[int, int] | None" = None):
    """One GRR direction's plan straight from the row-ELL arrays, or None
    without the native library (the reference's ``grr_plan_native``).

    ``direction`` 0: idx = column, seg = row (X·w); 1: idx = row, seg =
    column (Xᵀr).  Entries with value 0 are dropped.  ``idx_range=(lo,
    hi)`` keeps table indices in [lo, hi) (``lo`` window-aligned) and
    rebases them to idx − lo.  Returns the plan arrays and the chosen cap;
    routing is the caller's next step (``grr_routes_native``)."""
    dll = lib()
    if dll is None:
        return None
    cols = np.asarray(cols)
    if cols.dtype.itemsize > 4 and cols.size and (
            int(cols.max()) > np.iinfo(np.int32).max
            or int(cols.min()) < np.iinfo(np.int32).min):
        raise ValueError("column id exceeds int32 range in GRR plan build")
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    n, k = cols.shape
    if cap is not None and cap not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ValueError(f"cap must be a power of two ≤ 128, got {cap}")
    lo, hi = idx_range if idx_range is not None else (0, int(table_len))
    handle = dll.pml_grr_plan(
        _ptr(cols), _ptr(vals), n, k, int(direction), int(table_len),
        int(n_segments), 0 if cap is None else int(cap), int(lo), int(hi))
    if not handle:
        raise MemoryError("pml_grr_plan allocation failed")
    try:
        n_st, n_spill = ctypes.c_int64(), ctypes.c_int64()
        cap_out, n_gw = ctypes.c_int32(), ctypes.c_int32()
        n_ow, error = ctypes.c_int32(), ctypes.c_int32()
        dll.pml_grr_plan_sizes(
            handle, ctypes.byref(n_st), ctypes.byref(n_spill),
            ctypes.byref(cap_out), ctypes.byref(n_gw), ctypes.byref(n_ow),
            ctypes.byref(error))
        if error.value == 1:
            raise ValueError("idx or seg out of range in GRR plan build")
        if error.value:
            return None  # size overflow: the numpy path decides
        st, m = int(n_st.value), int(n_spill.value)
        hi_ = np.empty((st, 128, 128), np.int8)
        v_out = np.empty((st, 128, 128), np.float32)
        dst = np.empty((st, 128, 128), np.int32)
        gw_of_st = np.empty(st, np.int32)
        ow_of_st = np.empty(st, np.int32)
        first_of_ow = np.empty(st, np.int32)
        spill_idx = np.zeros(m, np.int32)
        spill_seg = np.zeros(m, np.int32)
        spill_val = np.zeros(m, np.float32)
        dll.pml_grr_plan_fill(
            handle, _ptr(hi_), _ptr(v_out), _ptr(dst), _ptr(gw_of_st),
            _ptr(ow_of_st), _ptr(first_of_ow), _ptr(spill_idx),
            _ptr(spill_seg), _ptr(spill_val))
    finally:
        dll.pml_grr_plan_free(handle)
    return {
        "hi": hi_, "vals": v_out, "dst": dst, "gw_of_st": gw_of_st,
        "ow_of_st": ow_of_st, "first_of_ow": first_of_ow,
        "spill_idx": spill_idx, "spill_seg": spill_seg,
        "spill_val": spill_val, "cap": int(cap_out.value),
        "n_gw": int(n_gw.value), "n_ow": int(n_ow.value),
    }
