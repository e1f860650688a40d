"""SMW-reduced Newton solvers for partial OT (``Class2/AMG4POT.m``,
``Class2/PCG4POT.m``).

The POT Jacobian is the arrow system ``He = bk1 I + (cT + cH0)/tk`` on
``n+m+1`` unknowns with ``cH0 = G diag(s) G^T``, ``G = [A; phi^T]``.
Sherman-Morrison-Woodbury eliminates the last row/column down to the core
``(n+m)`` system ``Ae = bk1 I + (T + H0)/tk`` — the Class-1 form — solved
twice (``Ae vv = v``, ``Ae ww = w``; ``AMG4POT.m:45-51``).

Improvement over the reference (SURVEY.md section 3.2): the two solves
share a single hierarchy setup — the reference rebuilds the AMG hierarchy
for each (``AMG4POT.m:46-47`` calls ``Hybrid_AMG`` twice), doubling the
setup cost for identical ``Ae``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from otamg.config import AMGOptions, PCGOptions
from otamg.hybrid.solver import make_aug_pcg_solver
from otamg.opt.newton import NewtonSolveResult, NewtonSolver
from otamg.ot import operators as op


def make_pot_amg_solver(p: jax.Array, q: jax.Array, Phi: jax.Array,
                        opts: AMGOptions,
                        twogrid: bool = False,
                        solve_dtype=None,
                        refine: int = 10) -> NewtonSolver:
    """POT Newton solver: SMW reduction + hybrid AMG core solves with a
    shared hierarchy (``AMG4POT.m`` with the 'amg'/'twogrid' backends)."""
    if twogrid:
        opts = AMGOptions(
            retol=opts.retol, bigph=opts.bigph, maxit=opts.maxit,
            theta=opts.theta, smoth=opts.smoth, cycle=opts.cycle,
            isnsp=opts.isnsp, inter=opts.inter, max_levels=2,
            coarsen_ratio=opts.coarsen_ratio,
            coarse_pcg=PCGOptions(retol=1e-11, maxit=100))

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        sg = 1.0 / tk
        z1, z2 = rhs[:-1], rhs[-1]
        SPhi = S * Phi
        # O(mn) same-sign reduction: chunked (a long sequential
        # accumulator loses ~N ulps of relative accuracy)
        phi_e = bk1 + sg * op.vdot_hi(Phi, SPhi)
        v = op.apply_A(SPhi, p, q)
        w = z1 - (sg / phi_e) * z2 * v

        kg1, kg2, ks = jax.random.split(key, 3)
        from otamg.hybrid.solver import build_he_solver

        he_solve, ncomp, last = build_he_solver(S, tvec, bk1, tk, p, q,
                                                opts, solve_dtype, refine,
                                                rhs.dtype, ks)
        vv, it1, res1 = he_solve(v, kg1)
        ww, it2, res2 = he_solve(w, kg2)

        tt = sg ** 2 / (phi_e - sg ** 2 * jnp.vdot(v, vv))
        zeta1 = ww + tt * vv * jnp.vdot(v, ww)
        zeta2 = (z2 - sg * jnp.vdot(v, zeta1)) / phi_e
        zeta = jnp.concatenate([zeta1, zeta2[None]])
        return NewtonSolveResult(zeta, jnp.maximum(it1, it2),
                                 jnp.maximum(res1, res2), ncomp, last)

    return solve


def make_pot_pcg_solver(p: jax.Array, q: jax.Array, Phi: jax.Array,
                        opts: PCGOptions) -> NewtonSolver:
    """POT Newton solver with augmented-PCG core solves
    (``Class2/PCG4POT.m``)."""
    core = make_aug_pcg_solver(p, q, opts)

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        sg = 1.0 / tk
        z1, z2 = rhs[:-1], rhs[-1]
        SPhi = S * Phi
        # O(mn) same-sign reduction: chunked (a long sequential
        # accumulator loses ~N ulps of relative accuracy)
        phi_e = bk1 + sg * op.vdot_hi(Phi, SPhi)
        v = op.apply_A(SPhi, p, q)
        w = z1 - (sg / phi_e) * z2 * v
        k1, k2 = jax.random.split(key)
        r1 = core(S, tvec, bk1, tk, v, k1)
        r2 = core(S, tvec, bk1, tk, w, k2)
        vv, ww = r1.zeta, r2.zeta
        tt = sg ** 2 / (phi_e - sg ** 2 * jnp.vdot(v, vv))
        zeta1 = ww + tt * vv * jnp.vdot(v, ww)
        zeta2 = (z2 - sg * jnp.vdot(v, zeta1)) / phi_e
        zeta = jnp.concatenate([zeta1, zeta2[None]])
        return NewtonSolveResult(zeta, jnp.maximum(r1.iters, r2.iters),
                                 jnp.maximum(r1.res, r2.res),
                                 jnp.maximum(r1.ncomp, r2.ncomp),
                                 jnp.int32(0))

    return solve


def make_pot_direct_solver(p: jax.Array, q: jax.Array,
                           Phi: jax.Array) -> NewtonSolver:
    """Dense direct solve of the full arrow system (``inner_solver=1``,
    ``Class2/APD_SsN_Class2.m:148-152``); oracle for tests."""
    n, m = q.shape[0], p.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        del key
        d1, d2 = op.asat_diags(S, p, q)
        off = (q[:, None] * S.T) * p[None, :]
        H0 = jnp.block([[jnp.diag(d1), off], [off.T, jnp.diag(d2)]])
        ss = op.apply_A(S * Phi, p, q)
        spp = op.vdot_hi(Phi, S * Phi)
        cH0 = jnp.block([[H0, ss[:, None]], [ss[None, :], spp[None, None]]])
        cT = jnp.diag(jnp.concatenate([tvec, jnp.zeros(1, S.dtype)]))
        Jk = bk1 * jnp.eye(n + m + 1, dtype=S.dtype) + (cT + cH0) / tk
        zeta = jax.scipy.linalg.solve(Jk, rhs, assume_a="pos")
        return NewtonSolveResult(zeta, jnp.int32(1),
                                 jnp.asarray(0.0, S.dtype), jnp.int32(0),
                                 jnp.int32(0))

    return solve
