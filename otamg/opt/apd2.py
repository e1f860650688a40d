"""APD + SsN outer optimizer for problem Class 2 (partial OT).

Mirrors :mod:`otamg.opt.apd` for the three-block primal ``(x, y, z)`` and
``(n+m+1)``-dimensional dual of ``Class2/APD_SsN_Class2.m:95-285``.
Differences from Class 1, faithfully kept:

* prox is the nonnegative projection (``:25``),
* SsN floor tolerance 1e-10 (``:28``),
* the stagnation break uses ``< SsN_Tol`` (not ``/100``; ``:223``),
* restart sets ``bk1 = 10*bk1`` instead of a random draw (``:254``),
* four KKT residuals (x, y, z, lambda; ``:56-59``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from otamg.config import APDOptions, InnerSolver
from otamg.opt.admm import warmup_class2
from otamg.opt.newton import NewtonSolver, make_pcg_solver
from otamg.ot import operators as op
from otamg.ot.problems import Class2Problem


def default_class2_options() -> APDOptions:
    """Reference Class-2 budgets: SsN floor tolerance 1e-10
    (``Class2/APD_SsN_Class2.m:28``) and AMG ``maxit=40, smoth=10``
    (``Class2/APD_SsN_Class2.m:80-81`` — the Class-1 defaults are 30/5)."""
    from otamg.config import AMGOptions

    return APDOptions(ssn_tol1=1e-10, amg=AMGOptions(maxit=40, smoth=10))


class _Ssn2Carry(NamedTuple):
    it: jax.Array
    lam: jax.Array
    ZX: jax.Array       # (m, n) plan block of z(lam)
    zs: jax.Array       # (n + m,) slack block of z(lam)
    nFk: jax.Array
    anchor: jax.Array
    done: jax.Array
    it_min: jax.Array
    it_sum: jax.Array
    it_max: jax.Array
    fail: jax.Array
    ncomp: jax.Array      # info[0] of the last Newton solve (Hybrid_AMG.m:113)
    last: jax.Array       # info[1]: last large-component ordinal
    key: jax.Array


class Outer2Metrics(NamedTuple):
    kkt_x: jax.Array
    kkt_y: jax.Array
    kkt_z: jax.Array
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
class Solve2Result:
    X: Any
    y: Any
    z: Any
    lam: Any
    converged: bool
    iters: int
    kkt: np.ndarray            # (iters+1, 4) raw norms [x, y, z, lam]
    fxk: np.ndarray
    ssn_itnum: np.ndarray
    solver_itnum: np.ndarray
    restarts: np.ndarray
    fail_count: int
    wall_time: float
    inner_total: int = 0   # total inner-solver iterations (SumAMG role)
    info_ncomp: np.ndarray | None = None  # per-outer info[0] (num_comp)
    info_last: np.ndarray | None = None   # per-outer info[1] (it_num)
    polished: bool = False  # feasibility-polish safeguard fired


def make_pot_solver_from_options(p, q, Phi, opts: APDOptions) -> NewtonSolver:
    from otamg.hybrid.pot import (
        make_pot_amg_solver,
        make_pot_direct_solver,
        make_pot_pcg_solver,
    )

    if opts.inner_solver == InnerSolver.DIRECT:
        return make_pot_direct_solver(p, q, Phi)
    if opts.inner_solver == InnerSolver.PCG:
        # Plain PCG on the full arrow system, matrix-free Jacobi.
        return _make_arrow_pcg_solver(p, q, Phi, opts)
    if opts.inner_solver == InnerSolver.AUG_PCG:
        return make_pot_pcg_solver(p, q, Phi, opts.pcg)
    if opts.inner_solver == InnerSolver.AMG:
        return make_pot_amg_solver(p, q, Phi, opts.amg,
                                   solve_dtype=opts.solve_dtype)
    if opts.inner_solver == InnerSolver.TWOGRID:
        return make_pot_amg_solver(p, q, Phi, opts.amg, twogrid=True,
                                   solve_dtype=opts.solve_dtype)
    raise ValueError(f"unknown inner solver {opts.inner_solver}")


def _make_arrow_pcg_solver(p, q, Phi, opts: APDOptions) -> NewtonSolver:
    """Matrix-free Jacobi-PCG on the full (n+m+1) arrow Jacobian
    (``inner_solver=2``, ``Class2/APD_SsN_Class2.m:153-159``)."""
    from otamg.krylov.pcg import pcg
    from otamg.opt.newton import NewtonSolveResult

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        del key
        d1, d2 = op.asat_diags(S, p, q)
        SPhi = S * Phi
        ss = op.apply_A(SPhi, p, q)
        spp = op.vdot_hi(Phi, SPhi)  # O(mn) same-sign: chunked
        diag = bk1 + jnp.concatenate(
            [tvec + jnp.concatenate([d1, d2]), spp[None]]) / tk

        def matvec(v):
            v1, vlast = v[:-1], v[-1]
            top = (tvec * v1 + op.apply_asat(v1, S, p, q, d1, d2)
                   + vlast * ss) / tk
            bot = (jnp.vdot(ss, v1) + spp * vlast) / tk
            return bk1 * v + jnp.concatenate([top, bot[None]])

        r = pcg(matvec, rhs, lambda v: v / diag,
                retol=opts.pcg.retol, maxit=opts.pcg.maxit)
        zero = jnp.int32(0)
        return NewtonSolveResult(r.x, r.iters, r.res, zero, zero)

    return solve


# Program caches, as in otamg.opt.apd: rebuilding jit wrappers per
# solve call retraces; the step closes over nothing problem-specific, so
# cache by (shapes/dtypes, options).
_STEP2_CACHE: dict = {}


@functools.partial(jax.jit, static_argnums=(3, 4))
def _polish_jit(X, us, lam, n, acc, pr):
    """Feasibility polish + honest re-measurement (tail safeguard; see
    operators.feasibility_polish).  Module-level cached program.

    The rounding is dual-aware (saturated rows/columns filled exactly);
    a dual clip was tried and rejected — zeroing noise duals injects
    their magnitude into kkt_x through G^T lam."""
    p, q, C, Phi, b = pr.p, pr.q, pr.C, pr.Phi, pr.b
    Xp, yp, zp = op.feasibility_polish(X, us[:n], us[n:], p, q, Phi, b,
                                       lam=lam.astype(X.dtype))
    usp = jnp.concatenate([yp, zp])
    k = op.kkt_class2(Xp, yp, zp, lam, C, b, p, q, Phi, acc)
    fx = op.vdot_hi(C, Xp, acc)
    return Xp, usp, jnp.stack(k), fx


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _class2_init_jit(pr, warm_maxit, n, hi, acc):
    """Warm start + prologue (cast, KKT0, objective) as ONE cached
    module-level program with ``prob`` as argument."""
    ws = warmup_class2(pr, warm_maxit)
    X, lam = ws.X, ws.lam.astype(hi)
    us = jnp.concatenate([ws.y, ws.z])
    k0 = op.kkt_class2(X, us[:n], us[n:], lam, pr.C, pr.b, pr.p, pr.q,
                       pr.Phi, acc)
    return X, us, lam, jnp.stack(k0), op.vdot_hi(pr.C, X)


def make_class2_step(prob: Class2Problem, opts: APDOptions,
                     solver: NewtonSolver | None = None,
                     fused: bool = False):
    """Build the jitted Class-2 APD outer step; the problem is a pytree
    ARGUMENT of the step (multi-process safe — see
    :func:`otamg.opt.apd.make_class1_step`)."""
    m, n = prob.m, prob.n
    dtype = prob.C.dtype
    # Mixed precision, mirroring :func:`otamg.opt.apd.make_class1_step`
    # (SURVEY.md hard part (f)): with fp32 storage the dual-space state and
    # every O(mn) reduction (H applications into the dual, merit dots, KKT
    # norms) are carried in f64; the bulk O(mn) work stays fp32.
    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None
    cache_key = None
    if solver is None and not fused:
        from otamg.opt.apd import _abstract_key

        cache_key = ("c2", _abstract_key(prob), opts, str(hi))
        cached = _STEP2_CACHE.get(cache_key)
        if cached is not None:
            return cached
    user_solver = solver
    solver_maxit = jnp.int32(
        opts.amg.maxit if opts.inner_solver in
        (InnerSolver.AMG, InnerSolver.TWOGRID) else opts.pcg.maxit)

    def ssn_solve(p, q, Phi, solver, WX, ws, wlk, lam0, bk1, tk, ssn_tol,
                  key, tail):
        """SsN loop (``Class2/APD_SsN_Class2.m:136-243``).
        ``lam0``/``wlk``/``bk1`` are hi-precision; z-space arrays stay
        lo-precision.

        ``tail`` relaxes the ENTRY test to ``10 * ssn_tol`` in the
        marginal tail (complementarity residuals at target, only the
        feasibility residual above): the previous lambda then already
        satisfies the inexactness criterion up to a constant, and
        noise-scale Newton nudges would re-excite the feasibility
        residual.  (A FULL lambda freeze was tried and diverges — the
        feasibility residual decays through the lambda updates, not the
        bk-telescoping alone — so only this mild hysteresis remains.)"""

        def Hu(X, us, out_dtype=None):
            return op.apply_H(X, us[:n], us[n:], p, q, Phi, out_dtype)

        def z_of(lam):
            HtX, Hts = op.apply_Ht(lam.astype(dtype), p, q, Phi)
            return (WX - HtX) / tk, (ws - Hts) / tk

        def F_of(lam, ZX, zs):
            PX = op.prox_nonneg(ZX)
            ps = op.prox_nonneg(zs)
            return bk1 * lam - Hu(PX, ps, acc).astype(hi) - wlk

        def merit(lam, ZX, zs):
            f0 = bk1 / 2 * jnp.vdot(lam, lam) - jnp.vdot(wlk, lam)
            PX = op.prox_nonneg(ZX)
            ps = op.prox_nonneg(zs)
            return f0 + 0.5 * tk * (op.vdot_hi(PX, PX, acc)
                                    + op.vdot_hi(ps, ps, acc))

        ZX0, zs0 = z_of(lam0)
        nF0 = jnp.linalg.norm(F_of(lam0, ZX0, zs0))
        entry_tol = jnp.where(tail, 10.0 * ssn_tol, ssn_tol)
        big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
        init = _Ssn2Carry(jnp.int32(0), lam0, ZX0, zs0, nF0, nF0,
                          nF0 <= entry_tol, big, jnp.int32(0), jnp.int32(0),
                          jnp.int32(0), jnp.int32(0), jnp.int32(0), key)

        def cond(c):
            return jnp.logical_not(c.done)

        def body(c: _Ssn2Carry) -> _Ssn2Carry:
            lam_old = c.lam
            HtX_old, Hts_old = op.apply_Ht(lam_old.astype(dtype), p, q,
                                           Phi)
            ZX_old = (WX - HtX_old) / tk
            zs_old = (ws - Hts_old) / tk
            S = (ZX_old >= 0).astype(dtype)
            tmask = (zs_old >= 0).astype(dtype)
            Fk_old = F_of(lam_old, ZX_old, zs_old)
            nFk_old = jnp.linalg.norm(Fk_old)
            key, sub = jax.random.split(c.key)
            sol = solver(S, tmask, jnp.asarray(bk1, dtype),
                         jnp.asarray(tk, dtype), (-Fk_old).astype(dtype),
                         sub)
            zeta = sol.zeta.astype(hi)
            # Armijo (:199-231); H^T lam is affine in the step size.
            HtzX, Htzs = op.apply_Ht(sol.zeta.astype(dtype), p, q, Phi)
            cF_old = merit(lam_old, ZX_old, zs_old)
            ress = jnp.abs(jnp.vdot(Fk_old, zeta))

            def trial(step):
                lam_t = lam_old + step * zeta
                step_lo = step.astype(dtype)
                ZX_t = (WX - HtX_old - step_lo * HtzX) / tk
                zs_t = (ws - Hts_old - step_lo * Htzs) / tk
                return lam_t, ZX_t, zs_t, merit(lam_t, ZX_t, zs_t)

            lam_t, ZX_t, zs_t, cF_new = trial(jnp.asarray(1.0, hi))

            def ls_cond(carry):
                ll, step, *_, cF_new = carry
                # NaN-safe: non-finite merits keep backtracking.
                ok = cF_new <= cF_old - opts.nu * step * ress
                return jnp.logical_and(jnp.logical_not(ok),
                                       ll < opts.ll_max)

            def ls_body(carry):
                ll, step, *_ = carry
                step = step * opts.delta
                lam_t, ZX_t, zs_t, cF_new = trial(step)
                return ll + 1, step, lam_t, ZX_t, zs_t, cF_new

            _, _, lam_new, ZX_new, zs_new, _ = lax.while_loop(
                ls_cond, ls_body,
                (jnp.int32(0), jnp.asarray(1.0, hi), lam_t, ZX_t, zs_t,
                 cF_new))

            Fk_new = F_of(lam_new, ZX_new, zs_new)
            nFk_new = jnp.linalg.norm(Fk_new)
            it = c.it + 1
            conv = nFk_new <= ssn_tol
            # Class2 stagnation uses the *full* tolerance (:223).
            stag = jnp.abs(nFk_old - nFk_new) < ssn_tol
            done = jnp.logical_or(jnp.logical_or(conv, stag),
                                  it >= opts.ssn_maxit)
            # Reject a stagnation-exit step that leaves ||F|| above the
            # tolerance: it violates the inexactness criterion the APD
            # feasibility telescoping relies on, and in the marginal tail
            # (x/y/z residuals frozen near the target) such sub-tolerance
            # lambda nudges re-excite the feasibility residual kkt_l —
            # a tail stall at rel ~1e-5 with EVERY inner solver.
            # Only the final (stagnant) step is dropped, losing less than
            # ssn_tol of residual progress by construction; productive
            # steps and maxit exits are kept (reference behavior).
            reject = jnp.logical_and(stag, jnp.logical_not(conv))
            lam_new = jnp.where(reject, lam_old, lam_new)
            ZX_new = jnp.where(reject, ZX_old, ZX_new)
            zs_new = jnp.where(reject, zs_old, zs_new)
            nFk_new = jnp.where(reject, nFk_old, nFk_new)
            anchor = jnp.where(c.anchor / nFk_new >= 2, nFk_new, c.anchor)
            return _Ssn2Carry(
                it, lam_new, ZX_new, zs_new, nFk_new, anchor, done,
                jnp.minimum(c.it_min, sol.iters), c.it_sum + sol.iters,
                jnp.maximum(c.it_max, sol.iters),
                c.fail + (sol.iters >= solver_maxit).astype(jnp.int32),
                sol.ncomp, sol.last, key)

        return lax.while_loop(cond, body, init)

    def outer_step(k, X, us, VX, vs, lam, bk, key, kkt_norm0, prev_kkt,
                   pr):
        p, q, C, Phi = pr.p, pr.q, pr.C, pr.Phi
        b = pr.b
        b_hi = b.astype(hi)
        solver = (user_solver if user_solver is not None
                  else make_pot_solver_from_options(p, q, Phi, opts))

        def Hu(X, us, out_dtype=None):
            return op.apply_H(X, us[:n], us[n:], p, q, Phi, out_dtype)

        resk_prev = jnp.max(prev_kkt)  # reference's raw `resk` (see :96)
        kf = k.astype(dtype)
        ak = jnp.sqrt(kf ** 2 * bk)
        bk1 = bk / (1 + ak)
        tk = bk * (1 + ak) / ak ** 2
        ssn_tol = jnp.maximum(bk1 / kf ** 2, opts.ssn_tol1)
        WX = -C + bk * (X + ak * VX) / ak ** 2
        ws = bk * (us + ak * vs) / ak ** 2  # wc slack block is zero
        wlk = (bk1 * (lam - (Hu(X, us, acc).astype(hi) - b_hi) / bk)
               - b_hi)
        # Marginal-tail signature from the previous iteration: x/y/z
        # residuals at target, only the feasibility residual above (see
        # ssn_solve's `tail` doc).
        prev_rel = prev_kkt / (1 + kkt_norm0)
        tail = jnp.logical_and(jnp.max(prev_rel[:3]) <= opts.kkt_tol,
                               prev_rel[3] > opts.kkt_tol)

        key, sub = jax.random.split(key)
        ssn = ssn_solve(p, q, Phi, solver, WX, ws, wlk, lam.astype(hi),
                        bk1.astype(hi), tk, ssn_tol, sub, tail)

        lam1 = ssn.lam
        X1 = op.prox_nonneg(ssn.ZX)
        us1 = op.prox_nonneg(ssn.zs)
        VX1 = X1 + (X1 - X) / ak
        vs1 = us1 + (us1 - us) / ak

        kx, ky, kz, kl = op.kkt_class2(X1, us1[:n], us1[n:], lam1, C, b,
                                       p, q, Phi, acc)
        rr = jnp.max(jnp.stack([kx, ky, kz, kl]) / (1 + kkt_norm0))
        restart = jnp.logical_and(bk1 < opts.restart_bk_floor,
                                  rr > resk_prev)
        bk1 = jnp.where(restart, 10 * bk1, bk1)  # :254
        X1 = jnp.where(restart, X, X1)
        us1 = jnp.where(restart, us, us1)
        lam1 = jnp.where(restart, lam, lam1)
        VX1 = jnp.where(restart, X, VX1)
        vs1 = jnp.where(restart, us, vs1)

        kx, ky, kz, kl = op.kkt_class2(X1, us1[:n], us1[n:], lam1, C, b,
                                       p, q, Phi, acc)
        fxk = op.vdot_hi(C, X1, acc)
        avg = jnp.where(ssn.it > 0, ssn.it_sum // jnp.maximum(ssn.it, 1), -1)
        metrics = Outer2Metrics(
            kkt_x=kx, kkt_y=ky, kkt_z=kz, kkt_l=kl, fxk=fxk,
            ssn_it=ssn.it,
            it_min=jnp.where(ssn.it > 0, ssn.it_min, -1), it_avg=avg,
            it_max=jnp.where(ssn.it > 0, ssn.it_max, -1),
            it_sum=ssn.it_sum, fail=ssn.fail, restarted=restart,
            ncomp=ssn.ncomp, last=ssn.last)
        return X1, us1, VX1, vs1, lam1, bk1, key, metrics

    if fused:
        return outer_step
    jitted = jax.jit(outer_step)
    if cache_key is not None:
        _STEP2_CACHE[cache_key] = jitted
    return jitted


def solve_class2(prob: Class2Problem, opts: APDOptions | None = None,
                 solver: NewtonSolver | None = None,
                 verbose: bool = False,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 10,
                 resume: bool = False) -> Solve2Result:
    """End-to-end Class-2 solve to relative KKT <= 1e-6
    (``Class2/APD_SsN_Class2.m:27,276-280``)."""
    if opts is None:
        opts = default_class2_options()
    t0 = time.perf_counter()
    m, n = prob.m, prob.n
    dtype = prob.C.dtype

    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None

    X, us, lam, k0, fx0 = _class2_init_jit(prob, opts.warmup.maxit, n,
                                           hi, acc)
    VX, vs = X, us
    kkt0 = np.asarray(jax.device_get(k0), np.float64)
    kkt_norm0 = jnp.asarray(kkt0, dtype)

    step = make_class2_step(prob, opts, solver)

    def _polish(X, us, lam, pr):
        Xp, usp, k, fx = _polish_jit(X, us, lam, n, acc, pr)
        return Xp, usp, lam, k, fx

    key = jax.random.PRNGKey(opts.seed)
    bk = jnp.asarray(1.0, dtype)
    k_start = 1
    prev_restored = None
    if resume and checkpoint_dir is not None:
        from otamg.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            # Warm-start state = sharding template (multi-process
            # sharded restore; see diag/checkpoint.py).
            d = ckpt.load_dict(checkpoint_dir,
                               template=dict(X=X, us=us, VX=VX, vs=vs,
                                             lam=lam))
            X, us, VX, vs = d["X"], d["us"], d["VX"], d["vs"]
            lam, bk, key = d["lam"].astype(hi), d["bk"], d["key"]
            k_start = d["k"] + 1
            # Key unified with the chunked driver ('prev_kkt') so a
            # checkpoint written by either driver resumes in the other;
            # 'prev' accepted for pre-round-5 artifacts.
            prev_restored = d.get("prev_kkt", d.get("prev"))

    kkt_hist = [kkt0]
    fxk = [float(fx0)]
    ssn_itnum, solver_itnum, restarts = [], [], []
    info_ncomp, info_last = [], []
    fail_total = 0
    inner_total = 0
    converged = False
    polished = False
    k_final = opts.maxit

    # Metric fetch: SYNCHRONOUS by default (each iteration's metrics are
    # fetched before the next dispatch).  Setting
    # OTAMG_PIPELINE_FETCH=1 selects the software-pipelined
    # mode (fetch k's metrics while k+1 executes; stop decision lags one
    # iteration and the converged state is restored from the saved
    # pre-dispatch state) — see the dispatch loop below.
    prev_dev = (jnp.asarray(prev_restored, dtype)
                if prev_restored is not None
                else jnp.asarray(kkt_hist[-1], dtype))

    def record(mtr_dev):
        nonlocal fail_total, inner_total
        mtr = jax.device_get(mtr_dev)
        kk = np.asarray([float(mtr.kkt_x), float(mtr.kkt_y),
                         float(mtr.kkt_z), float(mtr.kkt_l)])
        kkt_hist.append(kk)
        fxk.append(float(mtr.fxk))
        ssn_itnum.append(int(mtr.ssn_it))
        solver_itnum.append((int(mtr.it_min), int(mtr.it_avg),
                             int(mtr.it_max)))
        restarts.append(bool(mtr.restarted))
        info_ncomp.append(int(mtr.ncomp))
        info_last.append(int(mtr.last))
        fail_total += int(mtr.fail)
        inner_total += int(mtr.it_sum)
        return kk

    def finish(kp, kk, state):
        """Convergence / polish decision for iteration kp whose
        post-step state is `state`.  Returns True when solved."""
        nonlocal X, us, lam, converged, polished, k_final
        rr = (kk / (1 + kkt0)).max()
        if verbose:
            print(f"APD2 it={kp:3d} kkt={kk[0]:.2e}/{kk[1]:.2e}/"
                  f"{kk[2]:.2e}/{kk[3]:.2e} fk={fxk[-1]:.6e} "
                  f"ssn={ssn_itnum[-1]} inner={solver_itnum[-1]}"
                  + (" RESTART" if restarts[-1] else ""))
        if rr <= opts.kkt_tol:
            X, us, lam = state[0], state[1], state[4]
            converged = True
            k_final = kp
            return True
        if (opts.feas_polish and rr > opts.kkt_tol
                and (kk[:3] / (1 + kkt0[:3])).max() <= opts.kkt_tol):
            # Complementarity at target, feasibility the sole straggler:
            # try the projection polish; accept only on full convergence.
            Xp, usp, lamp, kkp, fxp = _polish(state[0], state[1],
                                              state[4], prob)
            kkp = np.asarray(kkp)
            if verbose:
                print(f"POLISH it={kp} kkt={kkp[0]:.2e}/{kkp[1]:.2e}/"
                      f"{kkp[2]:.2e}/{kkp[3]:.2e} "
                      f"rr={float((kkp / (1 + kkt0)).max()):.2e}")
            if (kkp / (1 + kkt0)).max() <= opts.kkt_tol:
                X, us, lam = Xp, usp, lamp
                kkt_hist[-1] = kkp
                fxk[-1] = float(fxp)
                polished = True
                converged = True
                k_final = kp
                return True
        return False

    # Sync metric fetch by default; OTAMG_PIPELINE_FETCH=1 selects the
    # lagged fetch (see otamg.opt.apd.solve_class1).
    pipeline = os.environ.get("OTAMG_PIPELINE_FETCH", "0") == "1"
    pending = None          # (k, metrics, state-after-step-k)
    for k in range(k_start, opts.maxit + 1):
        prev_state = (X, us, VX, vs, lam, bk, key)
        X, us, VX, vs, lam, bk, key, mtr = step(
            jnp.asarray(k, jnp.int32), X, us, VX, vs, lam, bk, key,
            kkt_norm0, prev_dev, prob)
        prev_dev = jnp.stack([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z,
                              mtr.kkt_l]).astype(dtype)
        if not pipeline:
            kk = record(mtr)
            if finish(k, kk, (X, us, VX, vs, lam, bk, key)):
                break
        else:
            if pending is not None:
                kp, mtr_p = pending
                kk = record(mtr_p)
                if finish(kp, kk, prev_state):
                    pending = None
                    break
            pending = (k, mtr)
        if checkpoint_dir is not None and k % checkpoint_every == 0:
            from otamg.diag import checkpoint as ckpt

            ckpt.save_dict(checkpoint_dir, k,
                           dict(X=X, us=us, VX=VX, vs=vs, lam=lam,
                                bk=bk, key=key, prev_kkt=prev_dev))
    if pending is not None:
        kp, mtr_p = pending
        kk = record(mtr_p)
        finish(kp, kk, (X, us, VX, vs, lam, bk, key))

    return Solve2Result(
        X=X, y=us[:n], z=us[n:], lam=lam, converged=converged,
        iters=k_final, kkt=np.asarray(kkt_hist), fxk=np.asarray(fxk),
        ssn_itnum=np.asarray(ssn_itnum),
        solver_itnum=np.asarray(solver_itnum),
        restarts=np.asarray(restarts), fail_count=fail_total,
        wall_time=time.perf_counter() - t0, inner_total=inner_total,
        info_ncomp=np.asarray(info_ncomp), info_last=np.asarray(info_last),
        polished=polished)


def _polish_final(prob: Class2Problem, opts: APDOptions, acc,
                  X, us, lam, kkt0: np.ndarray):
    """Exit-time feasibility polish for the chunked/fused drivers.

    The loop driver polishes inline (it sees per-iteration residuals);
    the on-device drivers only need the FINAL state: when the run ends
    unconverged with all three complementarity residuals at target and
    only ``kkt_l`` stalled, apply :func:`operators.feasibility_polish`
    and accept only if the honestly re-measured FULL KKT passes.
    Returns ``(X, us, kk, fx, accepted)``."""
    Xp, usp, kkp, fxp = _polish_jit(X, us, lam, prob.n, acc, prob)
    kkp = np.asarray(jax.device_get(kkp))
    ok = bool((kkp / (1 + kkt0)).max() <= opts.kkt_tol)
    return Xp, usp, kkp, float(fxp), ok


def _polish_applicable(opts: APDOptions, kk: np.ndarray,
                       kkt0: np.ndarray) -> bool:
    """Polish precondition: unconverged, complementarity (x/y/z) at
    target, feasibility (lam) the sole straggler."""
    rr = (kk / (1 + kkt0)).max()
    return bool(opts.feas_polish and rr > opts.kkt_tol
                and (kk[:3] / (1 + kkt0[:3])).max() <= opts.kkt_tol)


def solve_class2_chunked(prob: Class2Problem,
                         opts: APDOptions | None = None,
                         solver: NewtonSolver | None = None,
                         chunk: int = 8,
                         verbose: bool = False,
                         checkpoint_dir: str | None = None,
                         resume: bool = False) -> Solve2Result:
    """Chunked on-device Class-2 driver: up to ``chunk`` APD iterations per
    jitted program with on-device early exit (see
    :func:`otamg.opt.apd.solve_class1_chunked`).  Trajectory-identical to
    :func:`solve_class2`.  ``checkpoint_dir``/``resume`` save/restore the
    full state at chunk boundaries (exact-resume, including ``resk``)."""
    if opts is None:
        opts = default_class2_options()
    t0 = time.perf_counter()
    m, n = prob.m, prob.n
    dtype = prob.C.dtype

    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None

    X, us, lam, k0, fx0 = _class2_init_jit(prob, opts.warmup.maxit, n,
                                           hi, acc)
    VX, vs = X, us
    kkt0 = np.asarray(jax.device_get(k0), np.float64)
    kkt_norm0 = jnp.asarray(kkt0, dtype)

    step = make_class2_step(prob, opts, solver, fused=True)
    maxit = opts.maxit
    kkt_tol = opts.kkt_tol

    @jax.jit
    def run_chunk(k0_, X, us, VX, vs, lam, bk, key, prev0, pr):
        recs0 = {
            "kkt": jnp.zeros((chunk, 4), dtype),
            "fxk": jnp.zeros(chunk, dtype),
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
            i, k, X, us, VX, vs, lam, bk, key, prev, conv, recs = c
            more = jnp.logical_and(i < chunk, k <= maxit)
            return jnp.logical_and(more, jnp.logical_not(conv))

        def body(c):
            i, k, X, us, VX, vs, lam, bk, key, prev, conv, recs = c
            X1, us1, VX1, vs1, lam1, bk1, key, mtr = step(
                k, X, us, VX, vs, lam, bk, key, kkt_norm0, prev, pr)
            kk = jnp.stack([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z, mtr.kkt_l])
            conv = jnp.max(kk / (1 + kkt_norm0)) <= kkt_tol
            recs = {
                "kkt": recs["kkt"].at[i].set(kk),
                "fxk": recs["fxk"].at[i].set(mtr.fxk),
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
            return (i + 1, k + 1, X1, us1, VX1, vs1, lam1, bk1, key,
                    kk.astype(dtype), conv, recs)

        init = (jnp.int32(0), k0_, X, us, VX, vs, lam, bk, key,
                prev0, jnp.bool_(False), recs0)
        out = lax.while_loop(cond, body, init)
        i, k, X, us, VX, vs, lam, bk, key, prev, conv, recs = out
        return i, X, us, VX, vs, lam, bk, key, prev, conv, recs

    key = jax.random.PRNGKey(opts.seed)
    bk = jnp.asarray(1.0, dtype)
    prev = jnp.asarray(kkt0, dtype)
    k = 1
    if resume and checkpoint_dir is not None:
        from otamg.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            d = ckpt.load_dict(checkpoint_dir,
                               template=dict(X=X, us=us, VX=VX, vs=vs,
                                             lam=lam))
            X, us, VX, vs = d["X"], d["us"], d["VX"], d["vs"]
            lam, bk, key = d["lam"].astype(hi), d["bk"], d["key"]
            prev = d.get("prev_kkt", d.get("prev"))
            if prev is None:
                raise KeyError("checkpoint is missing 'prev_kkt' (restart-"
                               "heuristic residual) — cannot exact-resume")
            prev = prev.astype(dtype)
            k = d["k"] + 1
    kkt_hist = [kkt0]
    fxk = [float(fx0)]
    ssn_itnum, solver_itnum, restarts = [], [], []
    info_ncomp, info_last = [], []
    fail_total = 0
    inner_total = 0
    converged = False
    while k <= maxit and not converged:
        (i, X, us, VX, vs, lam, bk, key, prev, conv, recs) = run_chunk(
            jnp.asarray(k, jnp.int32), X, us, VX, vs, lam, bk, key, prev,
            prob)
        done = int(i)
        converged = bool(conv)
        recs = jax.device_get(recs)
        kkt_hist.extend(list(recs["kkt"][:done]))
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
                kk = recs["kkt"][j]
                print(f"APD2 it={k + j:3d} kkt={kk[0]:.2e}/{kk[1]:.2e}/"
                      f"{kk[2]:.2e}/{kk[3]:.2e} fk={recs['fxk'][j]:.6e} "
                      f"ssn={recs['ssn'][j]}"
                      + (" RESTART" if recs["restart"][j] else ""))
        k += done
        if checkpoint_dir is not None and done > 0:
            from otamg.diag import checkpoint as ckpt

            ckpt.save_dict(checkpoint_dir, k - 1,
                           dict(X=X, us=us, VX=VX, vs=vs, lam=lam,
                                bk=bk, key=key, prev_kkt=prev))

    polished = False
    if (not converged and len(kkt_hist) > 1
            and _polish_applicable(opts, np.asarray(kkt_hist[-1]), kkt0)):
        Xp, usp, kkp, fxp, ok = _polish_final(prob, opts, acc, X, us, lam,
                                              kkt0)
        if ok:
            X, us = Xp, usp
            kkt_hist[-1] = kkp
            fxk[-1] = fxp
            converged = polished = True

    return Solve2Result(
        X=X, y=us[:n], z=us[n:], lam=lam, converged=converged,
        iters=k - 1, kkt=np.asarray(kkt_hist), fxk=np.asarray(fxk),
        ssn_itnum=np.asarray(ssn_itnum),
        solver_itnum=np.asarray(solver_itnum).reshape(-1, 3),
        restarts=np.asarray(restarts), fail_count=fail_total,
        wall_time=time.perf_counter() - t0, inner_total=inner_total,
        info_ncomp=np.asarray(info_ncomp), info_last=np.asarray(info_last),
        polished=polished)


def solve_class2_fused(prob: Class2Problem,
                       opts: APDOptions | None = None,
                       solver: NewtonSolver | None = None) -> Solve2Result:
    """Whole-solve-on-device Class-2 driver (see
    :func:`otamg.opt.apd.solve_class1_fused`)."""
    if opts is None:
        opts = default_class2_options()
    t0 = time.perf_counter()
    m, n = prob.m, prob.n
    dtype = prob.C.dtype
    step = make_class2_step(prob, opts, solver, fused=True)
    maxit = opts.maxit

    hi = jnp.float64 if (dtype == jnp.float32
                         and jax.config.jax_enable_x64) else dtype
    acc = hi if hi != dtype else None

    @jax.jit
    def run(key, pr):
        p, q, C, Phi, b = pr.p, pr.q, pr.C, pr.Phi, pr.b
        ws = warmup_class2(pr, opts.warmup.maxit)
        X = ws.X
        us = jnp.concatenate([ws.y, ws.z])
        lam = ws.lam.astype(hi)
        VX, vs = X, us
        k0 = op.kkt_class2(X, us[:n], us[n:], lam, C, b, p, q, Phi, acc)
        kkt_norm0 = jnp.stack(k0)

        rec_kkt = jnp.zeros((maxit + 1, 4), dtype).at[0].set(kkt_norm0)
        rec_fx = jnp.zeros(maxit + 1, dtype).at[0].set(op.vdot_hi(C, X))
        rec_ssn = jnp.zeros(maxit + 1, jnp.int32)
        rec_imin = jnp.full(maxit + 1, -1, jnp.int32)
        rec_iavg = jnp.full(maxit + 1, -1, jnp.int32)
        rec_imax = jnp.zeros(maxit + 1, jnp.int32)
        rec_isum = jnp.zeros(maxit + 1, jnp.int32)
        rec_restart = jnp.zeros(maxit + 1, bool)
        rec_ncomp = jnp.zeros(maxit + 1, jnp.int32)
        rec_last = jnp.zeros(maxit + 1, jnp.int32)

        def cond(c):
            return jnp.logical_not(c[7])

        def body(c):
            (k, X, us, VX, vs, lam, bk, done, key, prev, fail,
             rec_kkt, rec_fx, rec_ssn, rec_imin, rec_iavg, rec_imax,
             rec_isum, rec_restart, rec_ncomp, rec_last) = c
            X1, us1, VX1, vs1, lam1, bk1, key, mtr = step(
                k, X, us, VX, vs, lam, bk, key, kkt_norm0, prev, pr)
            kk = jnp.stack([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z, mtr.kkt_l])
            rr = jnp.max(kk / (1 + kkt_norm0))
            done = jnp.logical_or(rr <= opts.kkt_tol, k >= maxit)
            return (k + 1, X1, us1, VX1, vs1, lam1, bk1, done, key,
                    kk.astype(dtype), fail + mtr.fail,
                    rec_kkt.at[k].set(kk), rec_fx.at[k].set(mtr.fxk),
                    rec_ssn.at[k].set(mtr.ssn_it),
                    rec_imin.at[k].set(mtr.it_min),
                    rec_iavg.at[k].set(mtr.it_avg),
                    rec_imax.at[k].set(mtr.it_max),
                    rec_isum.at[k].set(mtr.it_sum),
                    rec_restart.at[k].set(mtr.restarted),
                    rec_ncomp.at[k].set(mtr.ncomp),
                    rec_last.at[k].set(mtr.last))

        init = (jnp.int32(1), X, us, VX, vs, lam,
                jnp.asarray(1.0, dtype), jnp.bool_(False), key,
                kkt_norm0.astype(dtype), jnp.int32(0),
                rec_kkt, rec_fx, rec_ssn, rec_imin, rec_iavg, rec_imax,
                rec_isum, rec_restart, rec_ncomp, rec_last)
        out = lax.while_loop(cond, body, init)
        (k, X, us, VX, vs, lam, bk, done, key, prev, fail,
         rec_kkt, rec_fx, rec_ssn, rec_imin, rec_iavg, rec_imax,
         rec_isum, rec_restart, rec_ncomp, rec_last) = out
        return (k - 1, X, us, lam, fail, rec_kkt, rec_fx, rec_ssn,
                rec_imin, rec_iavg, rec_imax, rec_isum, rec_restart,
                rec_ncomp, rec_last,
                kkt_norm0)

    (k, X, us, lam, fail, rec_kkt, rec_fx, rec_ssn, rec_imin, rec_iavg,
     rec_imax, rec_isum, rec_restart, rec_ncomp, rec_last,
     kkt_norm0) = run(
        jax.random.PRNGKey(opts.seed), prob)
    iters = int(k)
    kkt = np.asarray(rec_kkt)[: iters + 1]
    kkt0 = kkt[0]
    converged = bool((kkt[-1] / (1 + kkt0)).max() <= opts.kkt_tol)
    fxk = np.asarray(rec_fx)[: iters + 1]
    polished = False
    if (not converged and iters >= 1
            and _polish_applicable(opts, kkt[-1], kkt0)):
        Xp, usp, kkp, fxp, ok = _polish_final(prob, opts, acc, X, us, lam,
                                              kkt0)
        if ok:
            X, us = Xp, usp
            kkt[-1] = kkp
            fxk[-1] = fxp
            converged = polished = True
    itnum = np.stack([np.asarray(rec_imin)[1: iters + 1],
                      np.asarray(rec_iavg)[1: iters + 1],
                      np.asarray(rec_imax)[1: iters + 1]], axis=1)
    return Solve2Result(
        X=X, y=us[:n], z=us[n:], lam=lam,
        converged=converged, iters=iters, kkt=kkt,
        fxk=fxk,
        ssn_itnum=np.asarray(rec_ssn)[1: iters + 1],
        solver_itnum=itnum,
        restarts=np.asarray(rec_restart)[1: iters + 1],
        fail_count=int(fail), wall_time=time.perf_counter() - t0,
        inner_total=int(np.asarray(rec_isum)[1: iters + 1].sum()),
        info_ncomp=np.asarray(rec_ncomp)[1: iters + 1],
        info_last=np.asarray(rec_last)[1: iters + 1],
        polished=polished)
