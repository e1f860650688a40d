"""Full preconditioner-menu coverage (reference ``PCG.m:34-66,90-105``).

Each menu entry is checked as an explicit operator: ``M^{-1}`` must be
symmetric positive definite, match its closed-form dense oracle, and
accelerate PCG on a bipartite SPD test matrix with the reference's
fine/coarse ``nf`` split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from otamg.config import PCGOptions, Preconditioner
from otamg.krylov.pcg import make_preconditioner, pcg_matrix
from otamg.opt.newton import make_pcg_solver
from otamg.ot import operators as op


def bipartite_spd(nf=12, nc=9, seed=0):
    """SPD matrix with the bipartite block structure ``[[V, U], [U^T, T]]``
    (``V``/``T`` diagonal) that BI_SSOR assumes — a shifted graph
    Laplacian of a dense bipartite graph."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.1, 1.0, size=(nf, nc))
    V = np.diag(W.sum(axis=1) + 0.3)
    T = np.diag(W.sum(axis=0) + 0.3)
    H = np.block([[V, -W], [-W.T, T]])
    return jnp.asarray(H)


def materialize(apply_fn, n):
    return jnp.stack([apply_fn(jnp.eye(n)[:, i]) for i in range(n)],
                     axis=1)


@pytest.mark.parametrize("which", [Preconditioner.SSOR,
                                   Preconditioner.ICHOL,
                                   Preconditioner.BI_SSOR,
                                   Preconditioner.JACOBI])
def test_minv_spd(which):
    H = bipartite_spd()
    n = H.shape[0]
    apply_fn = make_preconditioner(H, which, omega=1.5, nf=12)
    Minv = np.asarray(materialize(apply_fn, n))
    np.testing.assert_allclose(Minv, Minv.T, atol=1e-12)
    assert np.linalg.eigvalsh(Minv).min() > 0


def test_ssor_matches_dense_oracle():
    """SSOR: ``M = (D + wL) D^{-1} (D + wU) / (w (2-w))``; the applied
    operator must equal ``M^{-1}`` (``PCG.m:96-99``)."""
    H = bipartite_spd()
    n = H.shape[0]
    omega = 1.5
    D = np.diag(np.diag(np.asarray(H)))
    L = np.tril(np.asarray(H), -1)
    U = np.triu(np.asarray(H), 1)
    M = (D + omega * L) @ np.linalg.solve(D, D + omega * U) \
        / (omega * (2 - omega))
    apply_fn = make_preconditioner(H, Preconditioner.SSOR, omega=omega)
    Minv = np.asarray(materialize(apply_fn, n))
    np.testing.assert_allclose(Minv, np.linalg.inv(M), rtol=1e-10,
                               atol=1e-12)


def test_ichol_is_exact_inverse():
    """The ICHOL role is filled by a complete dense Cholesky (PCG.m:46
    is only reachable by hand-selection); on an accelerator the dense
    factor of the small coarse systems is both stronger and faster."""
    H = bipartite_spd()
    n = H.shape[0]
    apply_fn = make_preconditioner(H, Preconditioner.ICHOL)
    Minv = np.asarray(materialize(apply_fn, n))
    np.testing.assert_allclose(Minv, np.linalg.inv(np.asarray(H)),
                               rtol=1e-9, atol=1e-12)


def test_bissor_matches_block_ssor():
    """On a matrix whose diagonal blocks are exactly diagonal, the
    explicit bi-SSOR inverse (``PCG.m:55-66``) coincides with elementwise
    SSOR — both reduce to block-SSOR on the 2x2 bipartite splitting."""
    H = bipartite_spd()
    n = H.shape[0]
    bissor = make_preconditioner(H, Preconditioner.BI_SSOR, omega=1.4,
                                 nf=12)
    ssor = make_preconditioner(H, Preconditioner.SSOR, omega=1.4)
    r = jnp.asarray(np.random.default_rng(1).normal(size=n))
    np.testing.assert_allclose(np.asarray(bissor(r)),
                               np.asarray(ssor(r)), rtol=1e-10)


def test_bissor_requires_nf():
    H = bipartite_spd()
    with pytest.raises(ValueError):
        make_preconditioner(H, Preconditioner.BI_SSOR)


@pytest.mark.parametrize("which", [Preconditioner.NONE,
                                   Preconditioner.JACOBI,
                                   Preconditioner.SSOR,
                                   Preconditioner.ICHOL,
                                   Preconditioner.BI_SSOR])
def test_pcg_converges_with_each_preconditioner(which):
    H = bipartite_spd(24, 18, seed=2)
    n = H.shape[0]
    e = jnp.asarray(np.random.default_rng(3).normal(size=n))
    res = pcg_matrix(H, e, PCGOptions(retol=1e-10, maxit=500, precd=which),
                     nf=24)
    x_ref = np.linalg.solve(np.asarray(H), np.asarray(e))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)
    if which != Preconditioner.NONE:
        base = pcg_matrix(H, e, PCGOptions(retol=1e-10, maxit=500,
                                           precd=Preconditioner.NONE))
        assert int(res.iters) <= int(base.iters)


def test_newton_pcg_bissor_selectable():
    """The matrix-free Newton PCG honors ``precd=BI_SSOR`` and solves the
    SsN Jacobian system to the same answer as Jacobi."""
    rng = np.random.default_rng(5)
    m = n = 16
    p = jnp.asarray(rng.uniform(0.5, 1.5, m))
    q = jnp.asarray(rng.uniform(0.5, 1.5, n))
    S = jnp.asarray((rng.uniform(size=(m, n)) < 0.4).astype(np.float64))
    tvec = jnp.asarray((rng.uniform(size=n + m) < 0.5).astype(np.float64))
    bk1 = jnp.asarray(0.05)
    tk = jnp.asarray(1.3)
    rhs = jnp.asarray(rng.normal(size=n + m))

    jac = make_pcg_solver(p, q, PCGOptions(retol=1e-12, maxit=2000))
    bis = make_pcg_solver(p, q, PCGOptions(retol=1e-12, maxit=2000,
                                           precd=Preconditioner.BI_SSOR))
    za = jac(S, tvec, bk1, tk, rhs)
    zb = bis(S, tvec, bk1, tk, rhs)
    np.testing.assert_allclose(np.asarray(zb.zeta), np.asarray(za.zeta),
                               rtol=1e-7, atol=1e-10)

    # Oracle: both must solve Jk zeta = rhs for the assembled Jk.
    d1, d2 = op.asat_diags(S, p, q)
    off = (q[:, None] * S.T) * p[None, :]
    H0 = np.block([[np.diag(np.asarray(d1)), np.asarray(off)],
                   [np.asarray(off).T, np.diag(np.asarray(d2))]])
    Jk = float(bk1) * np.eye(n + m) \
        + (np.diag(np.asarray(tvec)) + H0) / float(tk)
    np.testing.assert_allclose(Jk @ np.asarray(zb.zeta),
                               np.asarray(rhs), rtol=1e-6, atol=1e-8)


def test_newton_pcg_rejects_dense_only_menu():
    p = jnp.ones(4)
    q = jnp.ones(4)
    with pytest.raises(ValueError):
        make_pcg_solver(p, q, PCGOptions(precd=Preconditioner.SSOR))


def test_pcg_resk_history():
    """The per-iteration residual history (reference 4th output,
    ``PCG.m:74,85``): monotone bookkeeping — resk[it-1] equals the final
    relative residual, entries beyond `iters` stay zero, and the recorded
    history is consistent with convergence to the tolerance."""
    H = bipartite_spd(10, 8, seed=3)
    e = jnp.asarray(np.random.default_rng(4).standard_normal(18))
    r = pcg_matrix(H, e, PCGOptions(retol=1e-10, maxit=200), resk=True)
    it = int(r.iters)
    resk = np.asarray(r.resk)
    assert r.resk.shape == (200,)
    assert 0 < it < 200
    np.testing.assert_allclose(resk[it - 1], float(r.res), rtol=1e-12)
    assert np.all(resk[it:] == 0)
    assert resk[it - 1] <= 1e-10
    # without the flag the history is absent (no extra carry in the loop)
    r2 = pcg_matrix(H, e, PCGOptions(retol=1e-10, maxit=200))
    assert r2.resk is None
