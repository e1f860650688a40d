"""APD + SsN outer optimizer (layer L6) for problem Class 1.

Reimplements the inexact accelerated primal-dual loop with semismooth-
Newton inner solves inlined in the reference driver
(``Class1/APD_SsN_Class1.m:101-275``): momentum schedule, adaptive SsN
inexactness, active-set Jacobian, Armijo backtracking on the dual merit,
stagnation breaks, extrapolation and the random-restart heuristic.

Accelerator-first structure: one jitted ``outer_step`` contains the
*entire* APD iteration — the SsN loop and the Armijo line search are
``lax.while_loop``s, the Newton solve is a closure (PCG here; AMG in
:mod:`otamg.hybrid`), and the plan never leaves the device.  The Python
driver only sequences the <=100 outer iterations and collects metrics.

Line-search redesign (same math, fewer flops): along ``lam_old + step *
zeta`` the O(mn) map ``A^T lam`` is affine in ``step``, so we precompute
``A^T zeta`` once and each backtrack costs one fused elementwise pass
instead of the reference's repeated ``Aty`` GEMVs
(``Class1/APD_SsN_Class1.m:191,202``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from otamg.config import APDOptions
from otamg.opt.admm import warmup_class1
from otamg.opt.newton import NewtonSolveResult, NewtonSolver, make_pcg_solver
from otamg.ot import operators as op
from otamg.ot.problems import Class1Problem


class _SsnCarry(NamedTuple):
    it: jax.Array         # iterations completed
    lam: jax.Array        # current dual iterate (lam_new)
    Zk: jax.Array         # (m, n) z(lam) — prox argument
    nFk: jax.Array        # ||F(lam)||
    anchor: jax.Array     # Fk_res print anchor (kept for parity/debug)
    done: jax.Array
    it_min: jax.Array     # inner-solver iteration stats
    it_sum: jax.Array
    it_max: jax.Array
    fail: jax.Array       # # inner solves that hit maxit (FailAMG analogue)
    ncomp: jax.Array      # info[0] of the last Newton solve (Hybrid_AMG.m:113)
    last: jax.Array       # info[1]: last large-component ordinal
    key: jax.Array


class OuterMetrics(NamedTuple):
    kkt_x: jax.Array
    kkt_l: jax.Array
    fxk: jax.Array
    ssn_it: jax.Array
    it_min: jax.Array
    it_avg: jax.Array
    it_max: jax.Array
    it_sum: jax.Array
    fail: jax.Array
    restarted: jax.Array
    ncomp: jax.Array
    last: jax.Array


@dataclasses.dataclass
class SolveResult:
    X: Any
    lam: Any
    converged: bool
    iters: int
    kkt_x: np.ndarray          # raw norms, index 0 = warm start
    kkt_l: np.ndarray
    fxk: np.ndarray
    ssn_itnum: np.ndarray
    solver_itnum: np.ndarray   # (iters, 3) min/avg/max, -1 where unset
    restarts: np.ndarray
    fail_count: int
    wall_time: float
    inner_total: int = 0   # total inner-solver iterations (SumAMG role)
    state: tuple | None = None  # (X, V, lam, bk, key) when requested —
    #                             exact warm-handoff / debugging state
    info_ncomp: np.ndarray | None = None  # per-outer info[0] (num_comp)
    info_last: np.ndarray | None = None   # per-outer info[1] (it_num)


def _merit(lam, Zk, wlk, bk1, tk, gama, capacitated: bool, acc=None):
    """Dual merit for the Armijo search (``Class1/APD_SsN_Class1.m:182-189``).

    For prob < 3 (``gama = inf``): ``f0 + tk/2 ||prox(z)||^2``;
    for capacity-constrained problems: ``f0 + tk/2 (||z||^2 -
    ||z - prox(z)||^2)`` — identical when ``gama = inf``.  ``acc``
    requests high-precision accumulation of the O(mn) dots.
    """
    f0 = bk1 / 2 * jnp.vdot(lam, lam) - jnp.vdot(wlk, lam)
    PZ = op.prox_box(Zk, gama)
    if capacitated:
        return f0 + 0.5 * tk * (
            op.vdot_hi(Zk, Zk, acc)
            - op.vdot_hi(Zk - PZ, Zk - PZ, acc))
    return f0 + 0.5 * tk * op.vdot_hi(PZ, PZ, acc)


def make_solver_from_options(p, q, opts: APDOptions) -> NewtonSolver:
    """Dispatch the ``inner_solver`` menu
    (``Class1/APD_SsN_Class1.m:66-71``)."""
    from otamg.config import InnerSolver

    if opts.inner_solver == InnerSolver.DIRECT:
        from otamg.hybrid import make_direct_solver

        return make_direct_solver(p, q)
    if opts.inner_solver == InnerSolver.PCG:
        return make_pcg_solver(p, q, opts.pcg)
    if opts.inner_solver == InnerSolver.AUG_PCG:
        from otamg.hybrid import make_aug_pcg_solver

        return make_aug_pcg_solver(p, q, opts.pcg)
    if opts.inner_solver == InnerSolver.AMG:
        from otamg.hybrid import make_hybrid_amg_solver

        dist_mesh = None
        if opts.explicit_dist:
            from otamg.dist import make_mesh

            # shard_map needs the row count to divide evenly over the
            # mesh; use the largest device count that does.
            m = p.shape[0]
            ndev = len(jax.devices())
            while m % ndev:
                ndev -= 1
            dist_mesh = make_mesh(ndev)
        return make_hybrid_amg_solver(p, q, opts.amg,
                                      solve_dtype=opts.solve_dtype,
                                      dist_mesh=dist_mesh)
    if opts.inner_solver == InnerSolver.TWOGRID:
        from otamg.hybrid import make_hybrid_amg_solver

        return make_hybrid_amg_solver(p, q, opts.amg, twogrid=True,
                                      solve_dtype=opts.solve_dtype)
    raise ValueError(f"unknown inner solver {opts.inner_solver}")


# Program caches.  A jitted program's executable is keyed on the jit
# WRAPPER object: rebuilding the wrapper per solve call retraces, and
# can recompile, every program, making "warm" solves cost cold time.
# Since the problem is a step ARGUMENT, the step closes over nothing
# problem-specific and can be cached by (shapes/dtypes, options).
_STEP_CACHE: dict = {}
_warmup1_jit = jax.jit(warmup_class1, static_argnums=1)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _class1_init_jit(pr, X, lam, hi, acc):
    """Prologue: cast the warm-start dual, measure KKT0 + objective.
    One cached program (module-level) with ``prob`` as argument."""
    lam = lam.astype(hi)
    kx0, kl0 = op.kkt_class1(X, lam, pr.C, pr.b, pr.p, pr.q, pr.gama, acc)
    return X, lam, kx0, kl0, op.vdot_hi(pr.C, X)


def _abstract_key(prob) -> tuple:
    return tuple((tuple(getattr(l, "shape", ())), str(getattr(l, "dtype",
                                                              type(l))))
                 for l in jax.tree_util.tree_leaves(prob))


# Module-level jit: a fresh wrapper per call retraces, and
# _is_capacitated runs BEFORE the _STEP_CACHE lookup — warm capacitated
# solves would pay a compile per solve.  One wrapper => one cached
# program per shape.
_any_finite_jit = jax.jit(lambda g: jnp.any(jnp.isfinite(g)))


def _is_capacitated(gama) -> bool:
    """Concrete ``any(isfinite(gama))`` that works on multi-process global
    arrays too (eager numpy on a non-addressable array is rejected; a jit
    with the array as ARGUMENT returns a replicated scalar)."""
    if np.ndim(gama) == 0:
        return bool(np.isfinite(jax.device_get(jnp.asarray(gama))))
    return bool(_any_finite_jit(gama))


def make_class1_step(prob: Class1Problem, opts: APDOptions,
                     solver: NewtonSolver | None = None,
                     capacitated: bool | None = None,
                     fused: bool = False):
    """Build the jitted APD outer step ``(k, X, V, lam, bk, key,
    resk_prev, kkt_norm0, prob) -> (X, V, lam, bk, key, metrics)``.

    The problem is a pytree ARGUMENT of the step (not a closure
    constant): jit closures over arrays spanning non-addressable devices
    are rejected in multi-process runs, while arguments shard cleanly.
    ``prob`` here is only read for static metadata (shapes, dtype,
    capacitated-ness); with ``solver=None`` the Newton solver is built
    from the traced ``p``/``q`` inside the step.
    """
    dtype = prob.C.dtype
    # Mixed precision (SURVEY.md hard part (f)): when the plan is stored
    # in fp32, the dual-space state and every O(mn) *reduction*
    # (operator applications into the dual, merit dots, KKT norms) are
    # carried in f64 — small vectors and f64-accumulated GEMVs only, so
    # the bulk O(mn)/O(N^2) work stays fp32.  Requires x64 enabled.
    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None
    if capacitated is None:
        capacitated = _is_capacitated(prob.gama)
    cache_key = None
    if solver is None and not fused:
        cache_key = ("c1", _abstract_key(prob), opts, capacitated,
                     str(hi))
        cached = _STEP_CACHE.get(cache_key)
        if cached is not None:
            return cached
    nm = prob.n + prob.m
    user_solver = solver

    def ssn_solve(p, q, gama, solver, Wk, wlk, lam0, bk1, tk, ssn_tol,
                  key):
        """The SsN while-loop (``Class1/APD_SsN_Class1.m:137-238``).
        ``lam0``/``wlk`` are hi-precision; Z-space arrays stay lo."""
        zeros_t = jnp.zeros(nm, dtype)

        def F_of(lam, Zk):
            return (bk1 * lam
                    - op.apply_A(op.prox_box(Zk, gama), p, q, acc).astype(hi)
                    - wlk)

        Z0 = (Wk - op.apply_At(lam0.astype(dtype), p, q)) / tk
        nF0 = jnp.linalg.norm(F_of(lam0, Z0))
        big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
        init = _SsnCarry(jnp.int32(0), lam0, Z0, nF0, nF0,
                         nF0 <= ssn_tol, big, jnp.int32(0), jnp.int32(0),
                         jnp.int32(0), jnp.int32(0), jnp.int32(0), key)

        def cond(c: _SsnCarry):
            return jnp.logical_not(c.done)

        def body(c: _SsnCarry) -> _SsnCarry:
            lam_old = c.lam
            At_lam = op.apply_At(lam_old.astype(dtype), p, q)
            Zk_old = (Wk - At_lam) / tk
            S = jnp.logical_and(Zk_old >= 0, Zk_old <= gama).astype(dtype)
            Fk_old = F_of(lam_old, Zk_old)
            nFk_old = jnp.linalg.norm(Fk_old)
            key, sub = jax.random.split(c.key)
            sol = solver(S, zeros_t, jnp.asarray(bk1, dtype),
                         jnp.asarray(tk, dtype),
                         (-Fk_old).astype(dtype), sub)
            zeta = sol.zeta.astype(hi)
            # --- Armijo backtracking (:182-211), affine in `step` ---
            At_zeta = op.apply_At(sol.zeta.astype(dtype), p, q)
            cF_old = _merit(lam_old, Zk_old, wlk, bk1, tk, gama, capacitated,
                            acc)
            ress = jnp.abs(jnp.vdot(Fk_old, zeta))

            def trial(step):
                lam_t = lam_old + step * zeta
                Z_t = (Wk - At_lam - step.astype(dtype) * At_zeta) / tk
                return lam_t, Z_t, _merit(lam_t, Z_t, wlk, bk1, tk, gama,
                                          capacitated, acc)

            lam_t, Z_t, cF_new = trial(jnp.asarray(1.0, hi))

            def ls_cond(carry):
                ll, step, lam_t, Z_t, cF_new = carry
                # NaN-safe Armijo: treat a non-finite merit as "not yet
                # acceptable" so overflowing trial steps keep backtracking
                # (a NaN would otherwise exit the loop and be accepted).
                ok = cF_new <= cF_old - opts.nu * step * ress
                return jnp.logical_and(jnp.logical_not(ok),
                                       ll < opts.ll_max)

            def ls_body(carry):
                ll, step, *_ = carry
                step = step * opts.delta
                lam_t, Z_t, cF_new = trial(step)
                return ll + 1, step, lam_t, Z_t, cF_new

            ll, step, lam_new, Z_new, cF_new = lax.while_loop(
                ls_cond, ls_body,
                (jnp.int32(0), jnp.asarray(1.0, hi), lam_t, Z_t, cF_new))

            Fk_new = F_of(lam_new, Z_new)
            nFk_new = jnp.linalg.norm(Fk_new)
            it = c.it + 1
            # Break conditions of :213-231: converged, stagnated, budget.
            conv = (nFk_new <= ssn_tol)
            stag = jnp.abs(nFk_old - nFk_new) < ssn_tol / 100
            done = jnp.logical_or(jnp.logical_or(conv, stag),
                                  it >= opts.ssn_maxit)
            # Reject a stagnation-exit step that leaves ||F|| above the
            # tolerance (see apd2.py: it violates the APD inexactness
            # criterion and can re-excite the feasibility residual in the
            # marginal tail); the dropped step carried < ssn_tol/100 of
            # progress by construction.
            reject = jnp.logical_and(stag, jnp.logical_not(conv))
            lam_new = jnp.where(reject, lam_old, lam_new)
            Z_new = jnp.where(reject, Zk_old, Z_new)
            nFk_new = jnp.where(reject, nFk_old, nFk_new)
            anchor = jnp.where(c.anchor / nFk_new >= 2, nFk_new, c.anchor)
            return _SsnCarry(
                it, lam_new, Z_new, nFk_new, anchor, done,
                jnp.minimum(c.it_min, sol.iters),
                c.it_sum + sol.iters,
                jnp.maximum(c.it_max, sol.iters),
                c.fail + (sol.iters >= _solver_maxit).astype(jnp.int32),
                sol.ncomp, sol.last, key)

        # maxit of the inner solver, to count FailAMG-style budget hits
        # (``Class1/APD_SsN_Class1.m:163-166``).
        _solver_maxit = jnp.int32(
            opts.amg.maxit if opts.inner_solver.name in ("AMG", "TWOGRID")
            else opts.pcg.maxit)
        return lax.while_loop(cond, body, init)

    def outer_step(k, X, V, lam, bk, key, resk_prev, kkt_norm0, pr):
        """One APD iteration (``Class1/APD_SsN_Class1.m:101-275``)."""
        p, q, C, gama = pr.p, pr.q, pr.C, pr.gama
        b = pr.b
        b_hi = b.astype(hi)
        solver = (user_solver if user_solver is not None
                  else make_solver_from_options(p, q, opts))
        kf = k.astype(dtype)
        ak = jnp.sqrt(kf ** 2 * bk)
        bk1 = bk / (1 + ak)
        tk = bk * (1 + ak) / ak ** 2
        ssn_tol = jnp.maximum(bk1 / kf ** 2, opts.ssn_tol1)
        Wk = -C + bk * (X + ak * V) / ak ** 2
        wlk = (bk1 * (lam - (op.apply_A(X, p, q, acc).astype(hi) - b_hi)
                      / bk) - b_hi)

        key, sub = jax.random.split(key)
        ssn = ssn_solve(p, q, gama, solver, Wk, wlk, lam.astype(hi),
                        bk1.astype(hi), tk, ssn_tol, sub)

        lam1 = ssn.lam
        X1 = op.prox_box(ssn.Zk, gama)
        V1 = X1 + (X1 - X) / ak

        # Restart heuristic (:241-249): compare the *normalized* new KKT
        # residual to the *raw* previous one, exactly as the reference does.
        kx1, kl1 = op.kkt_class1(X1, lam1, C, b, p, q, gama, acc)
        rr = jnp.maximum(kx1 / (1 + kkt_norm0[0]), kl1 / (1 + kkt_norm0[1]))
        key, sub = jax.random.split(key)
        restart = jnp.logical_and(bk1 < opts.restart_bk_floor, rr > resk_prev)
        bk1 = jnp.where(restart, jax.random.uniform(sub, dtype=dtype), bk1)
        X1 = jnp.where(restart, X, X1)
        lam1 = jnp.where(restart, lam, lam1)
        V1 = jnp.where(restart, X, V1)

        # Final residual record (:253-254) at the possibly-reverted state.
        kx, kl = op.kkt_class1(X1, lam1, C, b, p, q, gama, acc)
        fxk = op.vdot_hi(C, X1, acc)
        avg = jnp.where(ssn.it > 0, ssn.it_sum // jnp.maximum(ssn.it, 1), -1)
        metrics = OuterMetrics(
            kkt_x=kx, kkt_l=kl, fxk=fxk, ssn_it=ssn.it,
            it_min=jnp.where(ssn.it > 0, ssn.it_min, -1), it_avg=avg,
            it_max=jnp.where(ssn.it > 0, ssn.it_max, -1),
            it_sum=ssn.it_sum, fail=ssn.fail, restarted=restart,
            ncomp=ssn.ncomp, last=ssn.last)
        return X1, V1, lam1, bk1, key, metrics

    if fused:
        return outer_step
    jitted = jax.jit(outer_step)
    if cache_key is not None:
        _STEP_CACHE[cache_key] = jitted
    return jitted


def solve_class1(prob: Class1Problem, opts: APDOptions = APDOptions(),
                 solver: NewtonSolver | None = None,
                 warm: tuple | None = None,
                 verbose: bool = False,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 10,
                 resume: bool = False,
                 return_state: bool = False) -> SolveResult:
    """End-to-end Class-1 solve: A-ADMM warm start + APD-SsN to the
    relative KKT tolerance (``KKT_Tol = 1e-6``,
    ``Class1/APD_SsN_Class1.m:35,264-268``)."""
    t0 = time.perf_counter()
    dtype = prob.C.dtype

    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None

    # Prologue via MODULE-LEVEL cached jits with ``prob`` as ARGUMENT
    # (multi-process safe, and no per-call retrace/recompile — see the
    # _STEP_CACHE note).
    if warm is None:
        ws = _warmup1_jit(prob, opts.warmup.maxit)
        X, lam = ws.X, ws.lam
    else:
        X, lam = warm
    X, lam, kx0, kl0, fx0 = _class1_init_jit(prob, X, lam, hi, acc)
    V = X
    kx0 = float(kx0)
    kl0 = float(kl0)
    kkt_norm0 = jnp.asarray([kx0, kl0], dtype)

    step = make_class1_step(prob, opts, solver)
    key = jax.random.PRNGKey(opts.seed)
    bk = jnp.asarray(1.0, dtype)
    k_start = 1
    resk_restored = None
    if resume and checkpoint_dir is not None:
        from otamg.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            # The warm-start state is the sharding template: X/V/lam
            # restored onto exactly the placements the step expects
            # (multi-process sharded restore needs them; see
            # diag/checkpoint.py).
            st = ckpt.load_state(checkpoint_dir,
                                 template=dict(X=X, V=X, lam=lam))
            X, V, lam, bk, key = st.X, st.V, st.lam, st.bk, st.key
            k_start = st.k + 1
            resk_restored = st.resk

    kkt_x = [kx0]
    kkt_l = [kl0]
    fxk = [float(fx0)]
    ssn_itnum, solver_itnum, restarts = [], [], []
    info_ncomp, info_last = [], []
    fail_total = 0
    inner_total = 0
    converged = False
    k_final = opts.maxit

    # Metric fetch mode.  Synchronous by default: each iteration's
    # metrics are fetched before the next dispatch.
    # OTAMG_PIPELINE_FETCH=1 selects the software-pipelined fetch
    # (iteration k's metrics fetched while k+1 executes, stopping lagged
    # one step).  Which is faster on the GPU has not been measured.
    pipeline = os.environ.get("OTAMG_PIPELINE_FETCH", "0") == "1"
    resk_dev = (jnp.asarray(resk_restored, dtype)
                if resk_restored is not None
                else jnp.asarray(max(kkt_x[-1], kkt_l[-1]), dtype))

    def record(mtr_dev):
        nonlocal fail_total, inner_total
        mtr = jax.device_get(mtr_dev)
        kkt_x.append(float(mtr.kkt_x))
        kkt_l.append(float(mtr.kkt_l))
        fxk.append(float(mtr.fxk))
        ssn_itnum.append(int(mtr.ssn_it))
        solver_itnum.append((int(mtr.it_min), int(mtr.it_avg),
                             int(mtr.it_max)))
        restarts.append(bool(mtr.restarted))
        info_ncomp.append(int(mtr.ncomp))
        info_last.append(int(mtr.last))
        fail_total += int(mtr.fail)
        inner_total += int(mtr.it_sum)
        rr = max(kkt_x[-1] / (1 + kx0), kkt_l[-1] / (1 + kl0))
        return rr

    def report(k):
        if verbose:
            print(f"APD it={k:3d} kkt_x={kkt_x[-1]:.2e} "
                  f"kkt_l={kkt_l[-1]:.2e} fk={fxk[-1]:.6e} "
                  f"ssn={ssn_itnum[-1]} inner={solver_itnum[-1]}"
                  + (" RESTART" if restarts[-1] else ""))

    pending = None          # (k, metrics, state-after-step-k)
    for k in range(k_start, opts.maxit + 1):
        prev_state = (X, V, lam, bk, key)
        X, V, lam, bk, key, mtr = step(
            jnp.asarray(k, jnp.int32), X, V, lam, bk, key, resk_dev,
            kkt_norm0, prob)
        resk_dev = jnp.maximum(mtr.kkt_x, mtr.kkt_l).astype(dtype)
        if not pipeline:
            rr = record(mtr)
            report(k)
            if rr <= opts.kkt_tol:
                converged = True
                k_final = k
                break
        else:
            if pending is not None:
                kp, mtr_p = pending
                rr = record(mtr_p)
                report(kp)
                if rr <= opts.kkt_tol:
                    converged = True
                    k_final = kp
                    # the state after step kp is what step k consumed
                    X, V, lam, bk, key = prev_state
                    pending = None
                    break
            pending = (k, mtr)
        if checkpoint_dir is not None and k % checkpoint_every == 0:
            from otamg.diag import checkpoint as ckpt

            ckpt.save_state(checkpoint_dir,
                            ckpt.APDState(X, V, lam, bk, key, k,
                                          resk_dev))
    if pending is not None:
        kp, mtr_p = pending
        rr = record(mtr_p)
        report(kp)
        if rr <= opts.kkt_tol:
            converged = True
            k_final = kp

    return SolveResult(
        X=X, lam=lam, converged=converged, iters=k_final,
        kkt_x=np.asarray(kkt_x), kkt_l=np.asarray(kkt_l),
        fxk=np.asarray(fxk), ssn_itnum=np.asarray(ssn_itnum),
        solver_itnum=np.asarray(solver_itnum),
        restarts=np.asarray(restarts), fail_count=fail_total,
        wall_time=time.perf_counter() - t0, inner_total=inner_total,
        state=(X, V, lam, bk, key) if return_state else None,
        info_ncomp=np.asarray(info_ncomp), info_last=np.asarray(info_last))


def solve_class1_chunked(prob: Class1Problem,
                         opts: APDOptions = APDOptions(),
                         solver: NewtonSolver | None = None,
                         warm: tuple | None = None,
                         chunk: int = 8,
                         verbose: bool = False,
                         checkpoint_dir: str | None = None,
                         resume: bool = False) -> SolveResult:
    """Chunked on-device driver: runs up to ``chunk`` APD outer iterations
    per jitted program with an on-device convergence early-exit, so the
    host<->device round trip is paid once per chunk instead of once per
    iteration.  Identical trajectory to
    :func:`solve_class1` — same ``outer_step`` body, same restart/record
    semantics — just batched dispatch.

    ``checkpoint_dir`` saves the full APD state (including the restart
    residual ``resk``) at every chunk boundary; ``resume=True`` restores
    the latest one and continues with an exactly-identical trajectory."""
    t0 = time.perf_counter()
    dtype = prob.C.dtype
    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None

    if warm is None:
        ws = _warmup1_jit(prob, opts.warmup.maxit)
        X, lam = ws.X, ws.lam
    else:
        X, lam = warm
    X, lam, kx0, kl0, fx0 = _class1_init_jit(prob, X, lam, hi, acc)
    V = X
    kx0 = float(kx0)
    kl0 = float(kl0)
    kkt_norm0 = jnp.asarray([kx0, kl0], dtype)

    step = make_class1_step(prob, opts, solver, fused=True)
    maxit = opts.maxit
    kkt_tol = opts.kkt_tol

    @jax.jit
    def run_chunk(k0, X, V, lam, bk, key, resk_prev, pr):
        recs0 = {
            "kkt_x": jnp.zeros(chunk, hi), "kkt_l": jnp.zeros(chunk, hi),
            "fxk": jnp.zeros(chunk, hi),
            "ssn": jnp.zeros(chunk, jnp.int32),
            "imin": jnp.full(chunk, -1, jnp.int32),
            "iavg": jnp.full(chunk, -1, jnp.int32),
            "imax": jnp.full(chunk, -1, jnp.int32),
            "isum": jnp.zeros(chunk, jnp.int32),
            "fail": jnp.zeros(chunk, jnp.int32),
            "restart": jnp.zeros(chunk, bool),
            "ncomp": jnp.zeros(chunk, jnp.int32),
            "last": jnp.zeros(chunk, jnp.int32),
        }

        def cond(c):
            i, k, X, V, lam, bk, key, resk, conv, recs = c
            more = jnp.logical_and(i < chunk, k <= maxit)
            return jnp.logical_and(more, jnp.logical_not(conv))

        def body(c):
            i, k, X, V, lam, bk, key, resk, conv, recs = c
            X1, V1, lam1, bk1, key, mtr = step(
                k, X, V, lam, bk, key, resk, kkt_norm0, pr)
            rr = jnp.maximum(mtr.kkt_x / (1 + kx0), mtr.kkt_l / (1 + kl0))
            conv = rr <= kkt_tol
            resk1 = jnp.maximum(mtr.kkt_x, mtr.kkt_l).astype(dtype)
            recs = {
                "kkt_x": recs["kkt_x"].at[i].set(mtr.kkt_x.astype(hi)),
                "kkt_l": recs["kkt_l"].at[i].set(mtr.kkt_l.astype(hi)),
                "fxk": recs["fxk"].at[i].set(mtr.fxk.astype(hi)),
                "ssn": recs["ssn"].at[i].set(mtr.ssn_it),
                "imin": recs["imin"].at[i].set(mtr.it_min),
                "iavg": recs["iavg"].at[i].set(mtr.it_avg),
                "imax": recs["imax"].at[i].set(mtr.it_max),
                "isum": recs["isum"].at[i].set(mtr.it_sum),
                "fail": recs["fail"].at[i].set(mtr.fail),
                "restart": recs["restart"].at[i].set(mtr.restarted),
                "ncomp": recs["ncomp"].at[i].set(mtr.ncomp),
                "last": recs["last"].at[i].set(mtr.last),
            }
            return i + 1, k + 1, X1, V1, lam1, bk1, key, resk1, conv, recs

        init = (jnp.int32(0), k0, X, V, lam, bk, key, resk_prev,
                jnp.bool_(False), recs0)
        i, k, X, V, lam, bk, key, resk, conv, recs = lax.while_loop(
            cond, body, init)
        return i, k, X, V, lam, bk, key, resk, conv, recs

    key = jax.random.PRNGKey(opts.seed)
    bk = jnp.asarray(1.0, dtype)
    resk = jnp.asarray(max(kx0, kl0), dtype)
    k = 1
    if resume and checkpoint_dir is not None:
        from otamg.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            d = ckpt.load_dict(checkpoint_dir,
                               template=dict(X=X, V=X, lam=lam))
            X, V, lam = d["X"], d["V"], d["lam"].astype(hi)
            bk, key = d["bk"], d["key"]
            resk = d["resk"].astype(dtype)
            k = d["k"] + 1
    kkt_x = [kx0]
    kkt_l = [kl0]
    fxk = [float(fx0)]
    ssn_itnum, solver_itnum, restarts = [], [], []
    info_ncomp, info_last = [], []
    fail_total = 0
    inner_total = 0
    converged = False
    while k <= maxit and not converged:
        i, k_dev, X, V, lam, bk, key, resk, conv, recs = run_chunk(
            jnp.asarray(k, jnp.int32), X, V, lam, bk, key, resk, prob)
        done = int(i)
        converged = bool(conv)
        recs = jax.device_get(recs)
        kkt_x.extend(recs["kkt_x"][:done].tolist())
        kkt_l.extend(recs["kkt_l"][:done].tolist())
        fxk.extend(recs["fxk"][:done].tolist())
        ssn_itnum.extend(recs["ssn"][:done].tolist())
        solver_itnum.extend(
            zip(recs["imin"][:done].tolist(), recs["iavg"][:done].tolist(),
                recs["imax"][:done].tolist()))
        restarts.extend(recs["restart"][:done].tolist())
        info_ncomp.extend(recs["ncomp"][:done].tolist())
        info_last.extend(recs["last"][:done].tolist())
        fail_total += int(recs["fail"][:done].sum())
        inner_total += int(recs["isum"][:done].sum())
        if verbose:
            for j in range(done):
                print(f"APD it={k + j:3d} kkt_x={recs['kkt_x'][j]:.2e} "
                      f"kkt_l={recs['kkt_l'][j]:.2e} "
                      f"fk={recs['fxk'][j]:.6e} ssn={recs['ssn'][j]}"
                      + (" RESTART" if recs["restart"][j] else ""))
        k += done
        if checkpoint_dir is not None and done > 0:
            from otamg.diag import checkpoint as ckpt

            ckpt.save_dict(checkpoint_dir, k - 1,
                           dict(X=X, V=V, lam=lam, bk=bk, key=key,
                                resk=resk))

    return SolveResult(
        X=X, lam=lam, converged=converged, iters=k - 1,
        kkt_x=np.asarray(kkt_x), kkt_l=np.asarray(kkt_l),
        fxk=np.asarray(fxk), ssn_itnum=np.asarray(ssn_itnum),
        solver_itnum=np.asarray(solver_itnum).reshape(-1, 3),
        restarts=np.asarray(restarts), fail_count=fail_total,
        wall_time=time.perf_counter() - t0, inner_total=inner_total,
        info_ncomp=np.asarray(info_ncomp), info_last=np.asarray(info_last))


def solve_class1_fused(prob: Class1Problem,
                       opts: APDOptions = APDOptions(),
                       solver: NewtonSolver | None = None,
                       warm: tuple | None = None) -> SolveResult:
    """Whole-solve-on-device variant of :func:`solve_class1`: warm start +
    the full APD loop run as a single jitted ``lax.while_loop`` with
    on-device convergence checks — one host round trip for the entire
    solve (the Python-loop driver remains for logging/checkpoint
    workflows)."""
    t0 = time.perf_counter()
    dtype = prob.C.dtype
    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None
    step = make_class1_step(prob, opts, solver, fused=True)
    maxit = opts.maxit

    @jax.jit
    def run(key, pr):
        p, q, C, gama = pr.p, pr.q, pr.C, pr.gama
        b = pr.b
        if warm is None:
            ws = warmup_class1(pr, opts.warmup.maxit)
            X, lam = ws.X, ws.lam
        else:
            X, lam = warm
        lam = lam.astype(hi)
        V = X
        kx0, kl0 = op.kkt_class1(X, lam, C, b, p, q, gama, acc)
        kkt_norm0 = jnp.stack([kx0, kl0]).astype(dtype)

        rec_kx = jnp.zeros(maxit + 1, hi).at[0].set(kx0)
        rec_kl = jnp.zeros(maxit + 1, hi).at[0].set(kl0)
        rec_fx = jnp.zeros(maxit + 1, hi).at[0].set(
            op.vdot_hi(C, X, acc))
        rec_ssn = jnp.zeros(maxit + 1, jnp.int32)
        rec_imin = jnp.full(maxit + 1, -1, jnp.int32)
        rec_iavg = jnp.full(maxit + 1, -1, jnp.int32)
        rec_imax = jnp.zeros(maxit + 1, jnp.int32)
        rec_isum = jnp.zeros(maxit + 1, jnp.int32)
        rec_restart = jnp.zeros(maxit + 1, bool)
        rec_ncomp = jnp.zeros(maxit + 1, jnp.int32)
        rec_last = jnp.zeros(maxit + 1, jnp.int32)

        def cond(c):
            (k, X, V, lam, bk, key, resk, done, fail, *_recs) = c
            return jnp.logical_not(done)

        def body(c):
            (k, X, V, lam, bk, key, resk, done, fail,
             rec_kx, rec_kl, rec_fx, rec_ssn, rec_imin, rec_iavg,
             rec_imax, rec_isum, rec_restart, rec_ncomp, rec_last) = c
            X1, V1, lam1, bk1, key, mtr = step(
                k, X, V, lam, bk, key, resk, kkt_norm0, pr)
            rr = jnp.maximum(mtr.kkt_x / (1 + kx0), mtr.kkt_l / (1 + kl0))
            done = jnp.logical_or(rr <= opts.kkt_tol, k >= maxit)
            resk1 = jnp.maximum(mtr.kkt_x, mtr.kkt_l).astype(dtype)
            rec_kx = rec_kx.at[k].set(mtr.kkt_x.astype(hi))
            rec_kl = rec_kl.at[k].set(mtr.kkt_l.astype(hi))
            rec_fx = rec_fx.at[k].set(mtr.fxk.astype(hi))
            rec_ssn = rec_ssn.at[k].set(mtr.ssn_it)
            rec_imin = rec_imin.at[k].set(mtr.it_min)
            rec_iavg = rec_iavg.at[k].set(mtr.it_avg)
            rec_imax = rec_imax.at[k].set(mtr.it_max)
            rec_isum = rec_isum.at[k].set(mtr.it_sum)
            rec_restart = rec_restart.at[k].set(mtr.restarted)
            rec_ncomp = rec_ncomp.at[k].set(mtr.ncomp)
            rec_last = rec_last.at[k].set(mtr.last)
            return (k + 1, X1, V1, lam1, bk1, key, resk1, done,
                    fail + mtr.fail, rec_kx, rec_kl, rec_fx, rec_ssn,
                    rec_imin, rec_iavg, rec_imax, rec_isum, rec_restart,
                    rec_ncomp, rec_last)

        resk0 = jnp.maximum(kx0, kl0).astype(dtype)
        init = (jnp.int32(1), X, V, lam, jnp.asarray(1.0, dtype), key,
                resk0, jnp.bool_(False), jnp.int32(0),
                rec_kx, rec_kl, rec_fx, rec_ssn, rec_imin, rec_iavg,
                rec_imax, rec_isum, rec_restart, rec_ncomp, rec_last)
        (k, X, V, lam, bk, key, resk, done, fail,
         rec_kx, rec_kl, rec_fx, rec_ssn, rec_imin, rec_iavg, rec_imax,
         rec_isum, rec_restart, rec_ncomp, rec_last) = lax.while_loop(
            cond, body, init)
        return (k - 1, X, lam, fail, rec_kx, rec_kl, rec_fx, rec_ssn,
                rec_imin, rec_iavg, rec_imax, rec_isum, rec_restart,
                rec_ncomp, rec_last)

    (k, X, lam, fail, rec_kx, rec_kl, rec_fx, rec_ssn, rec_imin,
     rec_iavg, rec_imax, rec_isum, rec_restart, rec_ncomp,
     rec_last) = run(jax.random.PRNGKey(opts.seed), prob)
    iters = int(k)
    kx = np.asarray(rec_kx)[: iters + 1]
    kl = np.asarray(rec_kl)[: iters + 1]
    rr = max(kx[-1] / (1 + kx[0]), kl[-1] / (1 + kl[0]))
    itnum = np.stack([np.asarray(rec_imin)[1: iters + 1],
                      np.asarray(rec_iavg)[1: iters + 1],
                      np.asarray(rec_imax)[1: iters + 1]], axis=1)
    return SolveResult(
        X=X, lam=lam, converged=bool(rr <= opts.kkt_tol), iters=iters,
        kkt_x=kx, kkt_l=kl, fxk=np.asarray(rec_fx)[: iters + 1],
        ssn_itnum=np.asarray(rec_ssn)[1: iters + 1],
        solver_itnum=itnum,
        restarts=np.asarray(rec_restart)[1: iters + 1],
        fail_count=int(fail), wall_time=time.perf_counter() - t0,
        inner_total=int(np.asarray(rec_isum)[1: iters + 1].sum()),
        info_ncomp=np.asarray(rec_ncomp)[1: iters + 1],
        info_last=np.asarray(rec_last)[1: iters + 1])
