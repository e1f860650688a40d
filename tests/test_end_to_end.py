"""Integration tests: both problem classes to the reference KKT tolerance,
cross-checked against scipy.optimize.linprog (the reference's own disabled
oracle, ``Class1/APD_SsN_Class1.m:42-51``, resurrected — SURVEY.md
section 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

from otamg.config import AMGOptions, APDOptions, InnerSolver
from otamg.opt import solve_class1
from otamg.opt.apd2 import solve_class2
from otamg.ot import random_class1, random_class2


def dense_A(p, q):
    m, n = len(p), len(q)
    A1 = np.kron(np.eye(n), p[None, :])
    A2 = np.kron(q[None, :], np.eye(m))
    return np.vstack([A1, A2])


@pytest.fixture(scope="module")
def c1_prob():
    return random_class1(jax.random.PRNGKey(42), 24, 20)


@pytest.fixture(scope="module")
def c1_lp(c1_prob):
    prob = c1_prob
    A = dense_A(np.asarray(prob.p), np.asarray(prob.q))
    c = np.asarray(prob.C).ravel(order="F")
    return linprog(c, A_eq=A, b_eq=np.asarray(prob.b), bounds=(0, None),
                   method="highs")


@pytest.mark.parametrize("inner", [InnerSolver.PCG, InnerSolver.AMG,
                                   InnerSolver.TWOGRID,
                                   InnerSolver.AUG_PCG,
                                   InnerSolver.DIRECT])
def test_class1_all_inner_solvers(c1_prob, c1_lp, inner):
    res = solve_class1(c1_prob, APDOptions(inner_solver=inner))
    assert res.converged, f"{inner} did not converge"
    assert res.iters <= 100
    assert abs(res.fxk[-1] - c1_lp.fun) / abs(c1_lp.fun) < 1e-5
    assert res.fail_count == 0


def test_class1_capacitated():
    """Capacity-constrained transport (prob 3 of the reference header,
    finite gama) exercises the box prox and the capacitated merit."""
    key = jax.random.PRNGKey(3)
    prob = random_class1(key, 16, 16, gama=np.inf)
    # tight-ish capacity: max entry of the product coupling * 0.9
    mass = float(jnp.sum(prob.r))
    Xprod = np.outer(np.asarray(prob.l), np.asarray(prob.r)) / mass
    gama = 2.0 * Xprod.max()
    prob = prob.__class__(C=prob.C, r=prob.r, l=prob.l, p=prob.p, q=prob.q,
                          gama=jnp.full((16, 16), gama, prob.C.dtype))
    res = solve_class1(prob, APDOptions(inner_solver=InnerSolver.PCG))
    assert res.converged
    A = dense_A(np.asarray(prob.p), np.asarray(prob.q))
    c = np.asarray(prob.C).ravel(order="F")
    lp = linprog(c, A_eq=A, b_eq=np.asarray(prob.b), bounds=(0, gama),
                 method="highs")
    assert abs(res.fxk[-1] - lp.fun) / abs(lp.fun) < 1e-5
    # capacity actually binds somewhere, otherwise the test is vacuous
    assert np.asarray(res.X).max() > 0.99 * gama


@pytest.fixture(scope="module")
def c2_prob():
    return random_class2(jax.random.PRNGKey(7), 20, 16, mu_frac=0.6)


@pytest.fixture(scope="module")
def c2_lp(c2_prob):
    prob = c2_prob
    m, n = prob.m, prob.n
    A = dense_A(np.asarray(prob.p), np.asarray(prob.q))
    phi = np.asarray(prob.Phi).ravel(order="F")
    G = np.vstack([A, phi[None, :]])
    IY = np.vstack([np.eye(n), np.zeros((m, n)), np.zeros((1, n))])
    IZ = np.vstack([np.zeros((n, m)), np.eye(m), np.zeros((1, m))])
    H = np.hstack([G, IY, IZ])
    c = np.concatenate([np.asarray(prob.C).ravel(order="F"),
                        np.zeros(n + m)])
    return linprog(c, A_eq=H, b_eq=np.asarray(prob.b), bounds=(0, None),
                   method="highs")


@pytest.mark.parametrize("inner", [InnerSolver.AMG, InnerSolver.AUG_PCG,
                                   InnerSolver.DIRECT])
def test_class2_inner_solvers(c2_prob, c2_lp, inner):
    res = solve_class2(c2_prob,
                       APDOptions(ssn_tol1=1e-10, inner_solver=inner))
    assert res.converged, f"{inner} did not converge"
    assert abs(res.fxk[-1] - c2_lp.fun) / abs(c2_lp.fun) < 1e-5
    assert res.fail_count == 0
    # mass budget respected: <phi, x> == mu at optimum (mu < full mass)
    got_mass = float(jnp.vdot(c2_prob.Phi, res.X))
    np.testing.assert_allclose(got_mass, float(c2_prob.mu), rtol=1e-4)


@pytest.mark.slow
def test_class2_500_polish_lp_oracle(class2_fixture_path):
    """LP-oracle validation of the feas_polish safeguard at the FULL
    500^2 fixture scale (round-3 verdict item 3).

    The Class-2 tail can stall without the polish (unconverged at rel
    ~1e-5 with every inner solver under rounding coarser than the CPU's
    f64), and a polished result goes through ``feasibility_polish``.
    This pins what that relies on: (a) the converged solution matches the
    HiGHS LP optimum; (b) polishing a tail-perturbed iterate (the stall
    signature: complementarity at target, marginal feasibility ~1e-5
    off) restores FULL KKT convergence without moving the objective off
    the LP optimum."""
    import os

    import scipy.sparse as sp

    from otamg.ot import load_class2_mat, operators as op

    if not os.path.exists(class2_fixture_path):
        pytest.skip("reference fixture not available")
    prob = load_class2_mat(class2_fixture_path)
    m, n = prob.m, prob.n
    opts = APDOptions(inner_solver=InnerSolver.AMG, ssn_tol1=1e-10,
                      amg=AMGOptions(maxit=40, smoth=10))
    res = solve_class2(prob, opts)
    assert res.converged

    # Sparse LP oracle (dense A at 500^2 would be 2 GB).  Column-major
    # vec: x_(i,j) sits at flat index j*m + i.
    p = np.asarray(prob.p)
    q = np.asarray(prob.q)
    mn = m * n
    rows = np.concatenate([
        np.repeat(np.arange(n), m),              # q-side marginals
        n + np.tile(np.arange(m), n),            # p-side marginals
        np.full(mn, n + m),                      # phi mass row
    ])
    cols = np.concatenate([np.arange(mn)] * 3)
    vals = np.concatenate([
        np.tile(p, n),                           # p_i on row j
        np.repeat(q, m),                         # q_j on row n+i
        np.asarray(prob.Phi).ravel(order="F"),
    ])
    G = sp.coo_matrix((vals, (rows, cols)), shape=(n + m + 1, mn))
    IY = sp.coo_matrix((np.ones(n), (np.arange(n), np.arange(n))),
                       shape=(n + m + 1, n))
    IZ = sp.coo_matrix((np.ones(m), (n + np.arange(m), np.arange(m))),
                       shape=(n + m + 1, m))
    H = sp.hstack([G, IY, IZ]).tocsc()
    c = np.concatenate([np.asarray(prob.C).ravel(order="F"),
                        np.zeros(n + m)])
    lp = linprog(c, A_eq=H, b_eq=np.asarray(prob.b), bounds=(0, None),
                 method="highs")
    assert lp.status == 0
    assert abs(res.fxk[-1] - lp.fun) / (1 + abs(lp.fun)) < 1e-5

    # (b) Tail-stall signature: multiplicative feasibility noise on the
    # plan (~1e-5, the stall level), duals untouched.
    key = jax.random.PRNGKey(3)
    X_pert = res.X * (1 + 1e-5 * jax.random.uniform(key, res.X.shape,
                                                    dtype=res.X.dtype))
    Xp, yp, zp = op.feasibility_polish(
        X_pert, res.y, res.z, prob.p, prob.q, prob.Phi, prob.b,
        lam=res.lam.astype(res.X.dtype))
    kk = op.kkt_class2(Xp, yp, zp, res.lam, prob.C, prob.b, prob.p,
                       prob.q, prob.Phi)
    kkt0 = res.kkt[0]
    rel = np.asarray([float(v) for v in kk]) / (1 + kkt0)
    assert rel.max() <= 1e-6, f"polish failed to restore KKT: {rel}"
    fx = float(op.vdot_hi(prob.C, Xp))
    assert abs(fx - lp.fun) / (1 + abs(lp.fun)) < 1e-5


def test_warmup_consistency():
    """Warm starts produce finite, feasible-leaning iterates."""
    from otamg.opt import warmup_class1, warmup_class2

    prob = random_class1(jax.random.PRNGKey(0), 12, 10)
    ws = warmup_class1(prob, 100)
    assert bool(jnp.all(jnp.isfinite(ws.X)))
    assert bool(jnp.all(jnp.isfinite(ws.lam)))
    prob2 = random_class2(jax.random.PRNGKey(1), 12, 10, mu_frac=0.5)
    ws2 = warmup_class2(prob2, 100)
    for a in (ws2.X, ws2.y, ws2.z, ws2.lam):
        assert bool(jnp.all(jnp.isfinite(a)))


def test_assignment_problem():
    from otamg.ot import assignment_problem

    prob = assignment_problem(jax.random.PRNGKey(2), 16)
    res = solve_class1(prob, APDOptions(inner_solver=InnerSolver.AMG))
    assert res.converged
    # assignment LP optimum: compare against scipy's Hungarian solver
    from scipy.optimize import linear_sum_assignment
    C = np.asarray(prob.C)
    ri, ci = linear_sum_assignment(C)
    assert abs(res.fxk[-1] - C[ri, ci].sum()) < 1e-4


def test_fused_driver_matches_loop(c1_prob):
    from otamg.opt.apd import solve_class1_fused

    opts = APDOptions(inner_solver=InnerSolver.AMG)
    r1 = solve_class1(c1_prob, opts)
    r2 = solve_class1_fused(c1_prob, opts)
    assert r2.converged == r1.converged
    assert r2.iters == r1.iters
    np.testing.assert_allclose(r2.fxk[-1], r1.fxk[-1], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(r2.X), np.asarray(r1.X),
                               rtol=1e-10, atol=1e-14)


def test_chunked_driver_matches_loop(c1_prob):
    from otamg.opt.apd import solve_class1_chunked

    opts = APDOptions(inner_solver=InnerSolver.AMG)
    r1 = solve_class1(c1_prob, opts)
    r2 = solve_class1_chunked(c1_prob, opts, chunk=5)
    assert r2.converged == r1.converged
    assert r2.iters == r1.iters
    np.testing.assert_allclose(r2.fxk[-1], r1.fxk[-1], rtol=1e-12)
    np.testing.assert_allclose(r2.kkt_x, r1.kkt_x, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(r2.X), np.asarray(r1.X),
                               rtol=1e-10, atol=1e-14)
    assert (r2.ssn_itnum == r1.ssn_itnum).all()
    assert r2.inner_total == r1.inner_total
    assert (r2.solver_itnum == r1.solver_itnum).all()


def test_class2_fused_matches_loop(c2_prob):
    from otamg.opt.apd2 import solve_class2_fused

    opts = APDOptions(ssn_tol1=1e-10, inner_solver=InnerSolver.AMG)
    r1 = solve_class2(c2_prob, opts)
    r2 = solve_class2_fused(c2_prob, opts)
    assert r2.converged == r1.converged and r2.iters == r1.iters
    np.testing.assert_allclose(r2.fxk[-1], r1.fxk[-1], rtol=1e-12)


def test_class2_chunked_matches_loop(c2_prob):
    from otamg.opt.apd2 import solve_class2_chunked

    opts = APDOptions(ssn_tol1=1e-10, inner_solver=InnerSolver.AMG)
    r1 = solve_class2(c2_prob, opts)
    r2 = solve_class2_chunked(c2_prob, opts, chunk=5)
    assert r2.converged == r1.converged and r2.iters == r1.iters
    np.testing.assert_allclose(r2.fxk[-1], r1.fxk[-1], rtol=1e-12)
    np.testing.assert_allclose(r2.kkt, r1.kkt, rtol=1e-10)
    assert (r2.ssn_itnum == r1.ssn_itnum).all()
    assert (r2.solver_itnum == r1.solver_itnum).all()
