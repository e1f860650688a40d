"""Sparse container and kernel tests vs dense/scipy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from otamg.sparse import BSR, COO, CSR, ell_spmv, spgemm


def rand_sparse(rng, nr, nc, density):
    A = rng.standard_normal((nr, nc))
    A[rng.uniform(size=(nr, nc)) >= density] = 0.0
    return A


@pytest.mark.parametrize("nr,nc,density", [(13, 9, 0.3), (32, 32, 0.1),
                                           (8, 20, 0.0), (5, 5, 1.0)])
def test_coo_roundtrip_matvec(nr, nc, density):
    rng = np.random.default_rng(0)
    A = rand_sparse(rng, nr, nc, density)
    coo = COO.from_dense(jnp.asarray(A), capacity=nr * nc)
    np.testing.assert_allclose(np.asarray(coo.to_dense()), A, atol=1e-14)
    x = rng.standard_normal(nc)
    np.testing.assert_allclose(np.asarray(coo.matvec(jnp.asarray(x))),
                               A @ x, rtol=1e-12, atol=1e-12)
    y = rng.standard_normal(nr)
    np.testing.assert_allclose(np.asarray(coo.rmatvec(jnp.asarray(y))),
                               A.T @ y, rtol=1e-12, atol=1e-12)
    At = coo.transpose()
    np.testing.assert_allclose(np.asarray(At.to_dense()), A.T, atol=1e-14)


def test_coo_tight_capacity_and_jit():
    rng = np.random.default_rng(1)
    A = rand_sparse(rng, 16, 12, 0.2)
    cap = int((A != 0).sum()) + 3
    f = jax.jit(lambda M: COO.from_dense(M, capacity=cap).matvec(
        jnp.ones(12)))
    np.testing.assert_allclose(np.asarray(f(jnp.asarray(A))),
                               A @ np.ones(12), rtol=1e-12)


def test_coo_sum_duplicates():
    rows = jnp.asarray([2, 0, 2, 1, 0, 0], jnp.int32)
    cols = jnp.asarray([1, 0, 1, 2, 0, 0], jnp.int32)
    vals = jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 99.0])
    coo = COO((3, 3), rows, cols, vals, jnp.int32(5))  # last entry invalid
    out = coo.sum_duplicates()
    D = np.zeros((3, 3))
    D[2, 1] = 4.0
    D[0, 0] = 7.0
    D[1, 2] = 4.0
    np.testing.assert_allclose(np.asarray(out.to_dense()), D, atol=1e-14)
    assert int(out.nnz) == 3


@pytest.mark.parametrize("nr,nc,density,row_cap", [(13, 9, 0.3, 9),
                                                   (40, 30, 0.15, 12)])
def test_csr_roundtrip_matvec(nr, nc, density, row_cap):
    rng = np.random.default_rng(2)
    A = rand_sparse(rng, nr, nc, density)
    csr = CSR.from_dense(jnp.asarray(A), row_cap=row_cap)
    np.testing.assert_allclose(np.asarray(csr.to_dense()), A, atol=1e-14)
    x = rng.standard_normal(nc)
    np.testing.assert_allclose(np.asarray(csr.matvec(jnp.asarray(x))),
                               A @ x, rtol=1e-12, atol=1e-12)
    sq = rand_sparse(rng, nc, nc, density) + np.eye(nc)
    csq = CSR.from_dense(jnp.asarray(sq))
    np.testing.assert_allclose(np.asarray(csq.diag()), np.diag(sq),
                               rtol=1e-12)


def test_csr_from_coo():
    rng = np.random.default_rng(3)
    A = rand_sparse(rng, 11, 7, 0.4)
    coo = COO.from_dense(jnp.asarray(A))
    csr = CSR.from_coo(coo, row_cap=7)
    np.testing.assert_allclose(np.asarray(csr.to_dense()), A, atol=1e-14)


@pytest.mark.parametrize("bs", [2, 4])
def test_bsr_matvec(bs):
    rng = np.random.default_rng(4)
    nr = nc = 4 * bs
    A = rand_sparse(rng, nr, nc, 0.3)
    bsr = BSR.from_dense(jnp.asarray(A), bs=bs)
    np.testing.assert_allclose(np.asarray(bsr.to_dense()), A, atol=1e-14)
    x = rng.standard_normal(nc)
    np.testing.assert_allclose(np.asarray(bsr.matvec(jnp.asarray(x))),
                               A @ x, rtol=1e-12, atol=1e-12)


def test_spgemm_vs_dense():
    rng = np.random.default_rng(5)
    A = rand_sparse(rng, 12, 9, 0.3)
    B = rand_sparse(rng, 9, 14, 0.3)
    Ac = COO.from_dense(jnp.asarray(A))
    Bc = CSR.from_dense(jnp.asarray(B), row_cap=14)
    C = spgemm(Ac, Bc, out_capacity=12 * 14)
    np.testing.assert_allclose(np.asarray(C.to_dense()), A @ B,
                               rtol=1e-12, atol=1e-12)


def _ell_case(case, rng):
    """(cols, vals, x, scipy CSR of the stored entries) for one ELL shape."""
    import scipy.sparse as sp

    if case == "oob":
        # Out-of-range padding columns (violating the col-0/val-0
        # invariant) must gather 0, not a clamped neighbour.
        cols = np.asarray([[0, 5, 999], [2, 998, 997]])
        vals = np.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        x = np.arange(200.0)
        keep = cols < x.shape[0]
    else:
        # "single": one short row block; "wide": row capacity > 128.
        nr, n, cap = (70, 50, 16) if case == "single" else (200, 300, 150)
        A = rand_sparse(rng, nr, n, 0.45 if case == "wide" else 0.2)
        csr = CSR.from_dense(jnp.asarray(A), row_cap=cap)
        cols = np.asarray(csr.ell_cols)
        vals = np.asarray(csr.ell_vals)
        x = rng.standard_normal(n)
        keep = vals != 0
    rows = np.broadcast_to(np.arange(cols.shape[0])[:, None], cols.shape)
    ref = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                        shape=(cols.shape[0], x.shape[0]))
    return cols, vals, x, ref


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["single", "wide", "oob"])
def test_ell_spmv_vs_scipy(case, dtype):
    """The gather SpMV against scipy's CSR product of the stored entries:
    one short row block, a row capacity past 128, and out-of-range
    padding columns, in f32 and f64."""
    cols, vals, x, ref = _ell_case(case, np.random.default_rng(6))
    got = jax.jit(ell_spmv)(jnp.asarray(cols, jnp.int32),
                            jnp.asarray(vals, dtype), jnp.asarray(x, dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == np.float32 else 1e-12
    want = ref @ x.astype(dtype).astype(np.float64)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_asat_coo_vs_dense():
    from otamg.sparse import asat_coo
    rng = np.random.default_rng(7)
    m, n = 9, 7
    p = rng.uniform(0.5, 2.0, m)
    q = rng.uniform(0.5, 2.0, n)
    s = (rng.uniform(size=m * n) > 0.5).astype(float)
    S = s.reshape((m, n), order="F")
    A1 = np.kron(np.eye(n), p[None, :])
    A2 = np.kron(q[None, :], np.eye(m))
    A = np.vstack([A1, A2])
    H0 = A @ np.diag(s) @ A.T
    coo = asat_coo(jnp.asarray(S), jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(np.asarray(coo.to_dense()), H0,
                               rtol=1e-12, atol=1e-12)
    nnz_true = (H0 != 0).sum()
    assert int(coo.nnz) == nnz_true


def test_spgemm_tight_capacity():
    """Regression: tight out_capacity must not displace real entries with
    spurious zero-valued groups from padded B slots."""
    rng = np.random.default_rng(5)
    A = rand_sparse(rng, 12, 9, 0.3)
    B = rand_sparse(rng, 9, 14, 0.3)
    true_nnz = int(((A @ B) != 0).sum())
    Ac = COO.from_dense(jnp.asarray(A))
    Bc = CSR.from_dense(jnp.asarray(B), row_cap=14)
    C = spgemm(Ac, Bc, out_capacity=true_nnz)
    np.testing.assert_allclose(np.asarray(C.to_dense()), A @ B,
                               rtol=1e-12, atol=1e-12)
    assert int(C.nnz) == true_nnz
