"""Determinism and finite-guard tests (SURVEY.md section 5.2: the build's
substitute for race detection — seeded randomness must make whole solves
reproducible)."""

import jax
import numpy as np

from otamg.config import APDOptions, InnerSolver
from otamg.opt import solve_class1
from otamg.ot import random_class1


def test_solve_bitwise_deterministic():
    prob = random_class1(jax.random.PRNGKey(9), 20, 16)
    opts = APDOptions(inner_solver=InnerSolver.AMG, maxit=15,
                      kkt_tol=1e-30, seed=123)
    r1 = solve_class1(prob, opts)
    r2 = solve_class1(prob, opts)
    np.testing.assert_array_equal(np.asarray(r1.X), np.asarray(r2.X))
    np.testing.assert_array_equal(np.asarray(r1.lam), np.asarray(r2.lam))
    np.testing.assert_array_equal(r1.kkt_l, r2.kkt_l)


def test_step_program_cache_reuse_and_isolation():
    """Round-4 program cache: same (shapes, options) reuses the SAME
    jitted step across solves (warm solves must not recompile), while
    different shapes/options/problems get distinct entries and identical
    results to a fresh build."""
    from otamg.opt.apd import _STEP_CACHE, make_class1_step

    _STEP_CACHE.clear()
    p1 = random_class1(jax.random.PRNGKey(1), 20, 16)
    p2 = random_class1(jax.random.PRNGKey(2), 20, 16)   # same shapes
    p3 = random_class1(jax.random.PRNGKey(1), 24, 16)   # different shape
    opts = APDOptions(inner_solver=InnerSolver.AMG, maxit=8, seed=0)
    s1 = make_class1_step(p1, opts)
    assert make_class1_step(p1, opts) is s1
    assert make_class1_step(p2, opts) is s1   # keyed on shapes, not values
    assert make_class1_step(p3, opts) is not s1
    opts2 = APDOptions(inner_solver=InnerSolver.AMG, maxit=9, seed=0)
    assert make_class1_step(p1, opts2) is not s1
    # The cached step must still produce per-problem answers (the
    # problem is an argument, not baked in).
    r1 = solve_class1(p1, opts)
    r2 = solve_class1(p2, opts)
    assert not np.array_equal(np.asarray(r1.X), np.asarray(r2.X))
    r1b = solve_class1(p1, opts)
    np.testing.assert_array_equal(np.asarray(r1.X), np.asarray(r1b.X))


def test_different_seed_different_randomness_same_answer():
    """Seeds change MIS tie-breaks and initial guesses but not the
    converged answer (tolerance-based reproducibility, SURVEY.md hard
    part (e))."""
    prob = random_class1(jax.random.PRNGKey(10), 20, 16)
    r1 = solve_class1(prob, APDOptions(inner_solver=InnerSolver.AMG,
                                       seed=1))
    r2 = solve_class1(prob, APDOptions(inner_solver=InnerSolver.AMG,
                                       seed=2))
    assert r1.converged and r2.converged
    np.testing.assert_allclose(r1.fxk[-1], r2.fxk[-1], rtol=1e-7)


def test_pipeline_and_sync_fetch_identical(monkeypatch):
    """The two metric-fetch modes (synchronous default vs the pipelined
    lagged fetch, OTAMG_PIPELINE_FETCH=1) are pure driver plumbing and
    must produce identical solves."""
    prob = random_class1(jax.random.PRNGKey(5), 20, 16)
    opts = APDOptions(inner_solver=InnerSolver.AMG, seed=3)
    monkeypatch.delenv("OTAMG_PIPELINE_FETCH", raising=False)
    r_sync = solve_class1(prob, opts)
    monkeypatch.setenv("OTAMG_PIPELINE_FETCH", "1")
    r_pipe = solve_class1(prob, opts)
    assert r_sync.converged and r_pipe.converged
    assert r_sync.iters == r_pipe.iters
    np.testing.assert_array_equal(np.asarray(r_sync.X),
                                  np.asarray(r_pipe.X))
    np.testing.assert_array_equal(r_sync.kkt_l, r_pipe.kkt_l)


def test_all_metrics_finite():
    prob = random_class1(jax.random.PRNGKey(11), 16, 12)
    res = solve_class1(prob, APDOptions(inner_solver=InnerSolver.AMG))
    assert np.isfinite(res.kkt_x).all()
    assert np.isfinite(res.kkt_l).all()
    assert np.isfinite(res.fxk).all()
