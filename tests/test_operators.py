"""Unit tests for otamg.ot.operators against dense numpy oracles.

Oracle: materialise ``A = [I_n (x) p^T; q^T (x) I_m]`` (column-major vec)
and check every matrix-free kernel against it (SURVEY.md section 4:
property tests — adjointness, ASAt == A diag(s) A^T, invAAt vs dense solve).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from otamg.ot import operators as op


def dense_A(p, q):
    m, n = len(p), len(q)
    A1 = np.kron(np.eye(n), p[None, :])      # n x mn
    A2 = np.kron(q[None, :], np.eye(m))      # m x mn
    return np.vstack([A1, A2])               # (n+m) x mn


def rand_pq(rng, m, n, unit=False):
    if unit:
        return np.ones(m), np.ones(n)
    return rng.uniform(0.5, 2.0, m), rng.uniform(0.5, 2.0, n)


@pytest.mark.parametrize("m,n,unit", [(7, 5, True), (6, 9, False), (8, 8, False)])
def test_apply_A_At_vs_dense(m, n, unit):
    rng = np.random.default_rng(0)
    p, q = rand_pq(rng, m, n, unit)
    A = dense_A(p, q)
    X = rng.standard_normal((m, n))
    y = rng.standard_normal(n + m)

    got = op.apply_A(jnp.asarray(X), jnp.asarray(p), jnp.asarray(q))
    want = A @ X.ravel(order="F")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)

    gotT = op.apply_At(jnp.asarray(y), jnp.asarray(p), jnp.asarray(q))
    wantT = (A.T @ y).reshape((m, n), order="F")
    np.testing.assert_allclose(np.asarray(gotT), wantT, rtol=1e-12, atol=1e-12)


def test_adjointness():
    rng = np.random.default_rng(1)
    m, n = 11, 4
    p, q = rand_pq(rng, m, n)
    X = rng.standard_normal((m, n))
    y = rng.standard_normal(n + m)
    lhs = np.vdot(np.asarray(op.apply_A(jnp.asarray(X), jnp.asarray(p), jnp.asarray(q))), y)
    rhs = np.vdot(X, np.asarray(op.apply_At(jnp.asarray(y), jnp.asarray(p), jnp.asarray(q))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("m,n", [(7, 5), (6, 9)])
def test_asat_vs_dense(m, n):
    rng = np.random.default_rng(2)
    p, q = rand_pq(rng, m, n)
    A = dense_A(p, q)
    s = (rng.uniform(size=m * n) > 0.4).astype(float)
    S = s.reshape((m, n), order="F")
    H0 = A @ np.diag(s) @ A.T
    d1, d2 = op.asat_diags(jnp.asarray(S), jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(np.asarray(d1), np.diag(H0)[:n], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(d2), np.diag(H0)[n:], rtol=1e-12)
    z = rng.standard_normal(n + m)
    got = op.apply_asat(jnp.asarray(z), jnp.asarray(S), jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(np.asarray(got), H0 @ z, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("sg1,sg2", [(1.0, 1.0), (0.3, 0.3), (2.0, 0.7)])
def test_inv_aat_vs_dense(sg1, sg2):
    rng = np.random.default_rng(3)
    m, n = 6, 8
    p, q = rand_pq(rng, m, n)
    A = dense_A(p, q)
    M = np.diag(np.concatenate([sg1 * np.ones(n), sg2 * np.ones(m)])) + A @ A.T
    x = rng.standard_normal(n + m)
    got = op.inv_aat(jnp.asarray(x), jnp.asarray(p), jnp.asarray(q), sg1, sg2)
    want = np.linalg.solve(M, x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-12)


def test_inv_hht_vs_dense():
    rng = np.random.default_rng(4)
    m, n = 5, 7
    p, q = rand_pq(rng, m, n)
    A = dense_A(p, q)
    phi = np.ones(m * n)
    G = np.vstack([A, phi[None, :]])
    IY = np.vstack([np.eye(n), np.zeros((m, n)), np.zeros((1, n))])
    IZ = np.vstack([np.zeros((n, m)), np.eye(m), np.zeros((1, m))])
    H = np.hstack([G, IY, IZ])
    sg = 1.7
    M = sg * np.eye(n + m + 1) + H @ H.T
    v = rng.standard_normal(n + m + 1)
    got = op.inv_hht(jnp.asarray(v), jnp.asarray(p), jnp.asarray(q), sg,
                     jnp.asarray(phi.reshape((m, n), order="F")))
    want = np.linalg.solve(M, v)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-12)


def test_apply_H_Ht_adjoint():
    rng = np.random.default_rng(5)
    m, n = 6, 4
    p, q = rand_pq(rng, m, n)
    Phi = rng.uniform(size=(m, n))
    X = rng.standard_normal((m, n))
    y = rng.standard_normal(n)
    z = rng.standard_normal(m)
    lam = rng.standard_normal(n + m + 1)
    Hx = np.asarray(op.apply_H(*map(jnp.asarray, (X, y, z, p, q, Phi))))
    Xp, slack = op.apply_Ht(jnp.asarray(lam), jnp.asarray(p), jnp.asarray(q), jnp.asarray(Phi))
    lhs = np.vdot(Hx, lam)
    rhs = np.vdot(X, np.asarray(Xp)) + np.vdot(np.concatenate([y, z]), np.asarray(slack))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_mat_ingest_roundtrip(tmp_path):
    """A reference-layout ``.mat`` (column vectors, MATLAB column-major
    ``vec`` of the (m, n) matrices) loads back exactly."""
    import scipy.io as sio

    from otamg.ot import load_class1_mat, load_class2_mat

    rng = np.random.default_rng(0)
    m, n = 6, 5
    C = rng.random((m, n))
    r = rng.random((n, 1))
    l = rng.random((m, 1))
    l *= r.sum() / l.sum()
    vec = lambda M: M.reshape(-1, 1, order="F")
    d1 = dict(m=m, n=n, c=vec(C), gama=np.full((m * n, 1), np.inf), r=r,
              l=l, p=np.ones((m, 1)), q=np.ones((n, 1)))
    path1 = str(tmp_path / "data1.mat")
    sio.savemat(path1, d1)
    prob = load_class1_mat(path1)
    assert prob.m == m and prob.n == n
    np.testing.assert_array_equal(np.asarray(prob.C), C)
    np.testing.assert_array_equal(np.asarray(prob.r), r.ravel())
    np.testing.assert_allclose(float(jnp.sum(prob.r)),
                               float(jnp.sum(prob.l)), rtol=1e-10)
    assert bool(jnp.all(jnp.isinf(prob.gama)))

    Phi = rng.random((m, n))
    cap = min(float(r.sum()), float(l.sum()))
    path2 = str(tmp_path / "data4.mat")
    sio.savemat(path2, d1 | dict(phi=vec(Phi), mu=0.6 * cap))
    prob2 = load_class2_mat(path2)
    assert prob2.m == m and prob2.n == n
    np.testing.assert_array_equal(np.asarray(prob2.Phi), Phi)
    assert 0.0 < float(prob2.mu) < cap


def test_ingest_rejects_zero_weights(tmp_path):
    """Reference guard parity: zero entries in p/q are rejected at ingest
    (``Hybrid_AMG.m:19``, ``aug_PCG.m:18``)."""
    import pytest
    import scipy.io as sio

    from otamg.ot import load_class1_mat

    m = n = 4
    d = dict(m=m, n=n,
             c=np.random.rand(m * n, 1), gama=np.full((m * n, 1), np.inf),
             r=np.ones((n, 1)), l=np.ones((m, 1)),
             p=np.concatenate([np.zeros((1, 1)), np.ones((m - 1, 1))]),
             q=np.ones((n, 1)))
    path = str(tmp_path / "bad.mat")
    sio.savemat(path, d)
    with pytest.raises(ValueError, match="zero elements"):
        load_class1_mat(path)


def test_feasibility_polish_projects_onto_constraint():
    """The Class-2 tail safeguard: alternating projection onto {Hu=b} and
    the nonnegative orthant kills a small feasibility residual by orders
    of magnitude without leaving the orthant."""
    import jax

    from otamg.ot import operators as op
    from otamg.ot import random_class2

    prob = random_class2(jax.random.PRNGKey(3), 20, 16, mu_frac=0.5)
    p, q, Phi, b = prob.p, prob.q, prob.Phi, prob.b
    n, m = prob.n, prob.m
    # feasible interior-ish point: mass-scaled product coupling + slacks
    # absorbing the marginal remainders; perturb at the safeguard's
    # operating scale (the tail stall is ~1e-5 feasibility error)
    X = jnp.outer(prob.l, prob.r)
    X = X * (b[-1] / op.vdot_hi(Phi, X))     # phi' x = mu exactly
    y = jnp.maximum(b[:n] - X.sum(axis=0), 0.0)
    z = jnp.maximum(b[n:n + m] - X.sum(axis=1), 0.0)
    X = X * (1 + 1e-5 * jax.random.uniform(jax.random.PRNGKey(4), X.shape))
    r0 = float(jnp.linalg.norm(
        op.apply_H(X, y, z, p, q, Phi) - b))
    assert r0 > 1e-6
    Xp, yp, zp = op.feasibility_polish(X, y, z, p, q, Phi, b)
    r1 = float(jnp.linalg.norm(
        op.apply_H(Xp, yp, zp, p, q, Phi) - b))
    assert r1 < 1e-12
    assert float(jnp.min(Xp)) >= 0 and float(jnp.min(yp)) >= 0
    assert float(jnp.min(zp)) >= 0
    # the polish is a least-norm-sized correction: stays near the input
    assert float(jnp.linalg.norm(Xp - X)) <= 10 * r0


def test_feasibility_polish_sparse_support():
    """The rounding must also work on a SPARSE plan (the real tail state:
    OT solutions are sparse; a least-norm projection fails there because
    its correction clips on the zero entries)."""
    import jax

    from otamg.ot import operators as op
    from otamg.ot import random_class2

    prob = random_class2(jax.random.PRNGKey(5), 24, 18, mu_frac=0.5)
    p, q, Phi, b = prob.p, prob.q, prob.Phi, prob.b
    n, m = prob.n, prob.m
    key1, key2 = jax.random.split(jax.random.PRNGKey(6))
    mask = jax.random.uniform(key1, (m, n)) < 0.08   # ~sparse support
    X = jnp.where(mask, jnp.outer(prob.l, prob.r), 0.0)
    X = X * (b[-1] / op.vdot_hi(Phi, X))
    y = jnp.maximum(b[:n] - X.sum(axis=0), 0.0)
    z = jnp.maximum(b[n:n + m] - X.sum(axis=1), 0.0)
    X = X * (1 + 1e-5 * jax.random.uniform(key2, X.shape))
    r0 = float(jnp.linalg.norm(op.apply_H(X, y, z, p, q, Phi) - b))
    assert r0 > 1e-7
    Xp, yp, zp = op.feasibility_polish(X, y, z, p, q, Phi, b)
    r1 = float(jnp.linalg.norm(op.apply_H(Xp, yp, zp, p, q, Phi) - b))
    assert r1 < 1e-11, f"sparse polish left r={r1:.2e}"
    assert float(jnp.min(Xp)) >= 0
