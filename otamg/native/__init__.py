"""ctypes bindings for the native host layer (``otamg_native.cpp``).

Compiled on first import with g++ into ``build/libotamg_native.so``.
If no toolchain is available the module degrades gracefully:
``available()`` returns False and callers fall back to the pure
JAX/NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "otamg_native.cpp")
_BUILD = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD, "libotamg_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return True
    # Build into a per-process file and rename it into place: processes
    # importing this module at once (test workers) must never load a
    # half-written library.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    lib = ctypes.CDLL(_SO)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.otamg_cc_bipartite.argtypes = [i32p, i32p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32, i32p]
    lib.otamg_csr_spmv.argtypes = [i64p, i32p, f64p, f64p,
                                   ctypes.c_int32, f64p]
    lib.otamg_spgemm_symbolic.argtypes = [i64p, i32p, ctypes.c_int32,
                                          i64p, i32p, ctypes.c_int32, i64p]
    lib.otamg_spgemm_numeric.argtypes = [i64p, i32p, f64p, ctypes.c_int32,
                                         i64p, i32p, f64p, ctypes.c_int32,
                                         i64p, i32p, f64p]
    lib.otamg_ichol0.argtypes = [i64p, i32p, f64p, ctypes.c_int32]
    lib.otamg_ichol0.restype = ctypes.c_int32
    lib.otamg_ichol_solve.argtypes = [i64p, i32p, f64p, ctypes.c_int32,
                                      f64p, f64p]
    lib.otamg_chol_solve_dense.argtypes = [f64p, f64p, ctypes.c_int32]
    lib.otamg_chol_solve_dense.restype = ctypes.c_int32
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def cc_bipartite(edge_rows: np.ndarray, edge_cols: np.ndarray,
                 m: int, n: int) -> np.ndarray:
    """Union-find connected components of the bipartite edge list;
    host-side oracle for :func:`otamg.amg.graph
    .connected_components_bipartite` (the ``dmperm`` role)."""
    lib = _load()
    assert lib is not None
    labels = np.empty(m + n, np.int32)
    lib.otamg_cc_bipartite(
        np.ascontiguousarray(edge_rows, np.int32),
        np.ascontiguousarray(edge_cols, np.int32),
        np.int64(len(edge_rows)), np.int32(m), np.int32(n), labels)
    return labels


def csr_spmv(indptr, indices, vals, x) -> np.ndarray:
    lib = _load()
    assert lib is not None
    nrows = len(indptr) - 1
    y = np.empty(nrows, np.float64)
    lib.otamg_csr_spmv(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(vals, np.float64),
        np.ascontiguousarray(x, np.float64), np.int32(nrows), y)
    return y


def csr_spgemm(a_indptr, a_indices, a_vals, b_indptr, b_indices, b_vals,
               b_cols: int):
    """Gustavson SpGEMM C = A @ B on host CSR arrays; returns
    (indptr, indices, vals)."""
    lib = _load()
    assert lib is not None
    a_rows = len(a_indptr) - 1
    a_indptr = np.ascontiguousarray(a_indptr, np.int64)
    a_indices = np.ascontiguousarray(a_indices, np.int32)
    a_vals = np.ascontiguousarray(a_vals, np.float64)
    b_indptr = np.ascontiguousarray(b_indptr, np.int64)
    b_indices = np.ascontiguousarray(b_indices, np.int32)
    b_vals = np.ascontiguousarray(b_vals, np.float64)
    row_nnz = np.empty(a_rows, np.int64)
    lib.otamg_spgemm_symbolic(a_indptr, a_indices, np.int32(a_rows),
                              b_indptr, b_indices, np.int32(b_cols),
                              row_nnz)
    c_indptr = np.zeros(a_rows + 1, np.int64)
    np.cumsum(row_nnz, out=c_indptr[1:])
    nnz = int(c_indptr[-1])
    c_indices = np.empty(nnz, np.int32)
    c_vals = np.empty(nnz, np.float64)
    lib.otamg_spgemm_numeric(a_indptr, a_indices, a_vals, np.int32(a_rows),
                             b_indptr, b_indices, b_vals, np.int32(b_cols),
                             c_indptr, c_indices, c_vals)
    return c_indptr, c_indices, c_vals


def ichol0(indptr, indices, vals):
    """IC(0) on the lower-triangular CSR pattern; returns factor vals.
    Raises on nonpositive pivots (like MATLAB ichol)."""
    lib = _load()
    assert lib is not None
    out = np.ascontiguousarray(vals, np.float64).copy()
    rc = lib.otamg_ichol0(np.ascontiguousarray(indptr, np.int64),
                          np.ascontiguousarray(indices, np.int32),
                          out, np.int32(len(indptr) - 1))
    if rc != 0:
        raise ValueError(f"ichol0 failed at row {rc}")
    return out


def ichol_solve(indptr, indices, lvals, b) -> np.ndarray:
    lib = _load()
    assert lib is not None
    n = len(indptr) - 1
    x = np.empty(n, np.float64)
    lib.otamg_ichol_solve(np.ascontiguousarray(indptr, np.int64),
                          np.ascontiguousarray(indices, np.int32),
                          np.ascontiguousarray(lvals, np.float64),
                          np.int32(n),
                          np.ascontiguousarray(b, np.float64), x)
    return x


def chol_solve_dense(A, b) -> np.ndarray:
    """In-place dense Cholesky solve (column-major lower); A and b are
    copied.  Small-system direct-solve role of ``Hybrid_AMG.m:91``."""
    lib = _load()
    assert lib is not None
    n = A.shape[0]
    Ac = np.asfortranarray(A, np.float64).copy(order="F")
    bc = np.ascontiguousarray(b, np.float64).copy()
    rc = lib.otamg_chol_solve_dense(
        Ac.reshape(-1, order="F").copy(), bc, np.int32(n))
    if rc != 0:
        raise ValueError(f"cholesky failed at column {rc}")
    return bc
