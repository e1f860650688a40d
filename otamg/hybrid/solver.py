"""Hybrid Newton-system solvers (layer L4).

Reference ``Hybrid_AMG.m`` / ``Hybrid_twogrid.m`` / ``aug_PCG.m``: transform
the SsN Jacobian system ``He zeta = z`` (``He = bk1 I + (T + H0)/tk``) by
the similarity ``Q0 = diag(q, -p)`` into ``Ae u = f`` with

    ``Ae = bk1 Q + (K + A0)/tk``,  ``A0 = Q0 H0 Q0``,  ``K = Q0 T Q0``,

where ``A0`` is the graph Laplacian of the *bipartite active-set graph*
with edge weights ``w_ij = p_i^2 q_j^2 s_ij`` (off-diagonal block
``-diag(q^2) Y^T diag(p^2)``; diagonal = incident edge-weight sums).  So in
matrix terms ``Ae = diag(g) - E/tk`` with ``E_ij = p_i^2 q_j^2 s_ij`` and
``g = bk1 [q^2; p^2] + (k + a0diag)/tk`` — exactly the structured form
:mod:`otamg.amg.hierarchy` is built around.

Accelerator-first redesign of the component dispatch
(``Hybrid_AMG.m:27-91``): instead of permuting per-component submatrices
out of the matrix and running one AMG per large component plus a direct
solve on gathered small ones, we label components on-device (label
propagation replaces ``dmperm``), and solve *all* components
simultaneously in one masked hierarchy whose kernel-projected smoothing
and interpolation normalization act per component through the labels.  Same math, no data-dependent shapes,
no sequential component loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

import os

from otamg.amg.graph import connected_components_bipartite
from otamg.amg.hierarchy import _mm, amg_solve, setup_hierarchy

# Diagnostic tracing of the mixed-precision refinement loop (adds host
# syncs; debug runs only).
_DEBUG_REFINE = bool(os.environ.get("OTAMG_DEBUG_REFINE"))
from otamg.config import AMGOptions, PCGOptions
from otamg.krylov.pcg import pcg
from otamg.opt.newton import NewtonSolveResult, NewtonSolver


def _transform(S, tvec, bk1, tk, rhs, p, q):
    """Shared Q0-transform pieces (``Hybrid_AMG.m:16-24``)."""
    p2 = p * p
    q2 = q * q
    q0 = jnp.concatenate([q, -p])
    qp2 = jnp.concatenate([q2, p2])
    E = (p2[:, None] * q2[None, :]) * S
    a0diag = jnp.concatenate([jnp.sum(E, axis=0), jnp.sum(E, axis=1)])
    kdiag = qp2 * tvec
    g = bk1 * qp2 + (kdiag + a0diag) / tk
    f = q0 * rhs
    return E, g, kdiag, f, q0


def _component_info(E, kdiag):
    """Component labels + per-component near-singularity flags
    (``Hybrid_AMG.m:33-40,60-66``: a component is near-singular iff the
    ``K`` diagonal vanishes on it).

    Also returns ``last``: the 1-based ordinal (components enumerated in
    increasing root-label order) of the last component with more than
    ``N0 = 100`` nodes — the reference's ``it_num``/``info(2)``
    (``Hybrid_AMG.m:51,80,113``; 0 when every component is small).
    """
    N = kdiag.shape[0]
    labels = connected_components_bipartite(E)
    ksum = jax.ops.segment_sum(kdiag, labels, num_segments=N)
    nsp = ksum[labels] == 0
    roots = labels == jnp.arange(N, dtype=labels.dtype)
    ncomp = jnp.sum(roots).astype(jnp.int32)
    sizes = jax.ops.segment_sum(jnp.ones(N, jnp.int32), labels,
                                num_segments=N)
    ordinal = jnp.cumsum(roots.astype(jnp.int32))
    large = jnp.logical_and(roots, sizes > 100)
    last = jnp.max(jnp.where(large, ordinal, 0)).astype(jnp.int32)
    return labels, nsp, ncomp, last


def make_hybrid_amg_solver(p: jax.Array, q: jax.Array,
                           opts: AMGOptions,
                           twogrid: bool = False,
                           solve_dtype=None,
                           refine: int = 10,
                           dist_mesh=None) -> NewtonSolver:
    """Newton solver via the hybrid AMG path (``inner_solver=4``; with
    ``twogrid=True`` the two-level variant of ``Hybrid_twogrid.m`` /
    ``twogrid_bigph.m`` — one coarse level, Jacobi-PCG coarse correction
    capped at 100 iterations, ``twogrid_bigph.m:98-99``).

    Mixed precision: with ``solve_dtype=float32`` the hierarchy is
    built and cycled in fp32 and the solution is polished by
    ``refine`` rounds of iterative refinement — true-precision residual
    through the *structured* operator (two masked GEMVs), fp32 correction
    solve reusing the same hierarchy.  The reference needs rel tol 1e-11
    (``amg_options.retol``); fp32 cycles reach ~1e-7, and each refinement
    round squares down the residual, restoring f64-quality solutions at
    fp32 cost.

    ``dist_mesh`` selects the explicit-collectives distributed assembly
    (:func:`otamg.dist.assembly.transform_sharded`: shard_map psum /
    all_gather over the mesh's row axis) for the hybrid transform, in
    place of the implicit XLA SPMD partitioning.
    """
    if twogrid:
        import dataclasses

        # Reference two-grid coarse correction is deliberately INEXACT:
        # Jacobi-PCG capped at 100 iterations on the (large) level-2
        # system (``twogrid_bigph.m:98-99``) — keep pcg mode here.
        opts = dataclasses.replace(
            opts, max_levels=2, coarse_solver="pcg",
            coarse_pcg=PCGOptions(retol=1e-11, maxit=100))
    if dist_mesh is not None and opts.fuse_deep:
        import dataclasses

        # The fused deep-matrix build runs dense GEMM chains over the
        # hierarchy arrays; under the explicit-collectives assembly
        # those arrays are mesh-sharded and every build GEMM drags
        # collectives through the composition chain — pathologically
        # slow on a CPU mesh and pointless anyway (the deep levels are
        # replicated-scale objects).  Disable the fusion here; the
        # single-device and implicitly sharded paths keep it.
        opts = dataclasses.replace(opts, fuse_deep=False)

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        k_setup, k_solve = jax.random.split(key)
        he_solve, ncomp, last = build_he_solver(S, tvec, bk1, tk, p, q,
                                                opts, solve_dtype, refine,
                                                rhs.dtype, k_setup,
                                                dist_mesh=dist_mesh)
        zeta, iters, rel = he_solve(rhs, k_solve)
        return NewtonSolveResult(zeta, iters, rel, ncomp, last)

    return solve


def build_he_solver(S, tvec, bk1, tk, p, q, opts: AMGOptions,
                    solve_dtype, refine: int, hi, key,
                    dist_mesh=None):
    """Build the hierarchy once and return ``(he_solve, ncomp, last)``
    where ``he_solve(rhs, key) -> (zeta, iters, rel)`` solves
    ``He zeta = rhs`` and ``(ncomp, last)`` mirror the reference's
    ``info = [num_comp, it_num]`` (``Hybrid_AMG.m:113``).

    The returned closure can be called repeatedly against the same ``He``
    — the shared-setup improvement AMG4POT needs (SURVEY.md section 3.2:
    the reference rebuilds the hierarchy for each of its two solves).
    """
    lo = hi if solve_dtype is None else jnp.dtype(solve_dtype)
    if dist_mesh is None:
        E, g, kdiag, _, q0 = _transform(S, tvec, bk1, tk,
                                        jnp.zeros_like(tvec), p, q)
    else:
        # Explicit-collectives distributed assembly (``ASAt.m:14-19`` /
        # ``Hybrid_AMG.m:16-24``): E row-block sharded, KKT diagonals
        # replicated via psum + all_gather over the interconnect.
        from otamg.dist.assembly import transform_sharded

        E, g, kdiag = transform_sharded(dist_mesh, S, tvec, bk1, tk, p, q)
        q0 = jnp.concatenate([q, -p])
    labels, nsp, ncomp, last = _component_info(E, kdiag)
    if opts.bigph:
        # Non-Laplacian diagonal bk1*Q + K/tk == Ae @ (component
        # indicator), exactly — the analytic form of the kernel-projection
        # quantities (computed in the problem dtype, cast once; see
        # setup_hierarchy's gk doc for why the matvec form cancels).
        qp2_t = jnp.concatenate([q * q, p * p])
        gk = (bk1 * qp2_t + kdiag / tk).astype(lo)
        lv1, dense = setup_hierarchy(E.astype(lo), g.astype(lo),
                                     jnp.asarray(1.0 / tk, lo),
                                     labels, nsp, opts, key, gk=gk)
    else:
        # Non-bigph mode (``Class_AMG.m:72``): ignore the bipartite
        # structure — assemble the dense ``Ae`` and run the generic
        # weighted-Jacobi/MIS hierarchy.  The reference drivers always set
        # bigph=1; this path exists for parity with the AMG library mode.
        from otamg.amg.hierarchy import setup_hierarchy_generic

        nn = q.shape[0]
        mm = p.shape[0]
        Elo = E.astype(lo)
        Ae = jnp.block(
            [[jnp.zeros((nn, nn), lo), Elo.T],
             [Elo, jnp.zeros((mm, mm), lo)]]) * jnp.asarray(-1.0 / tk, lo)
        Ae = Ae + jnp.diag(g.astype(lo))
        lv1, dense = setup_hierarchy_generic(Ae, opts, key, labels, nsp)

    n = q.shape[0]
    N = tvec.shape[0]
    mixed = lo != hi
    if mixed:
        qp2 = jnp.concatenate([q * q, p * p]).astype(hi)
        ghi = bk1 * qp2 + (kdiag.astype(hi) + _a0diag_hi(S, p, q)) / tk
        Shi = S.astype(hi)
        p2 = (p * p).astype(hi)
        q2 = (q * q).astype(hi)

        def ae_hi(v):
            v1, v2 = v[:n], v[n:]
            ev1 = p2 * _mm(Shi, q2 * v1)
            ev2 = q2 * _mm(Shi.T, p2 * v2)
            return ghi * v - jnp.concatenate([ev2, ev1]) / tk

        # Exact kernel-mode deflation: on a near-singular component c
        # (K vanishes there) the indicator xi_c satisfies
        # Ae xi_c = bk1 Q xi_c exactly, so the kernel coordinate obeys the
        # 1-D equation bk1 (xi^T Q xi) a_c = xi^T r — solvable in f64 with
        # no 1/bk1 amplification through the fp32 solver.
        nsp_f = nsp.astype(hi)
        qsum = jax.ops.segment_sum(qp2 * nsp_f, labels, num_segments=N)
        den = bk1 * qsum
        safe_den = jnp.where(den > 0, den, 1.0)

    def he_solve(rhs, kguess):
        f = q0 * rhs
        # Random initial guess scaled as the reference's ``bk1*tk*rand``
        # (Hybrid_AMG.m:69).
        guess = jnp.asarray(bk1 * tk, lo) * jax.random.uniform(
            kguess, f.shape, dtype=lo)
        if not mixed:
            r = amg_solve(lv1, dense, f.astype(lo), guess, opts)
            return q0 * r.x, r.iters, r.rel_res

        # Mixed path, in *deflated coordinates*: u = Y a + w, with a the
        # per-component kernel coordinate (Q-weighted mean on the near-
        # singular components) and w kernel-free.  As bk1 -> 0 the true a
        # grows like xi^T f / bk1; evaluating Ae u on such u cancels
        # O(|a| * a0diag/tk) terms catastrophically even in f64, so all
        # residual algebra is done on (a, w):
        #   a(w)   = (xi^T f - bk1 xi^T Q w) / (bk1 xi^T Q xi)   [exact]
        #   r(a,w) = f - bk1 Q Y a - Ae w                        [no huge
        #            intermediate: w stays range-sized]
        nf = jnp.linalg.norm(f)
        safe_nf = jnp.where(nf > 0, nf, 1.0)
        target = jnp.asarray(opts.retol, hi)
        zeros_lo = jnp.zeros(N, lo)
        segf = jax.ops.segment_sum(f * nsp_f, labels, num_segments=N)

        def deflate(w):
            mean = jax.ops.segment_sum(qp2 * w * nsp_f, labels,
                                       num_segments=N)
            mean = jnp.where(qsum > 0, mean / jnp.where(qsum > 0, qsum,
                                                        1.0), 0.0)
            return w - jnp.where(nsp, mean[labels], 0.0) * nsp_f

        def a_of(w):
            segw = jax.ops.segment_sum(qp2 * w * nsp_f, labels,
                                       num_segments=N)
            a = jnp.where(den > 0, (segf - bk1 * segw) / safe_den, 0.0)
            return jnp.where(nsp, a[labels], 0.0)

        def residual(w):
            wd = deflate(w)
            a = a_of(wd)
            r = f - bk1 * qp2 * a * nsp_f - ae_hi(wd)
            return wd, a, r

        def refine_cond(c):
            w, rel, rounds, its = c
            return jnp.logical_and(rel > target, rounds < refine)

        def refine_body(c):
            w, rel_prev, rounds, its = c
            wd, a, r = residual(w)
            cor = amg_solve(lv1, dense, r.astype(lo), zeros_lo, opts,
                            deflated=True)
            w2 = wd + cor.x.astype(hi)
            _, _, r2 = residual(w2)
            rel = jnp.linalg.norm(r2) / safe_nf
            if _DEBUG_REFINE:
                jax.debug.print(
                    "REFINE round={r} rel={rel:.3e} cor_it={ci} "
                    "cor_rel={cr:.3e} bk1={b:.3e}", r=rounds, rel=rel,
                    ci=cor.iters, cr=cor.rel_res, b=bk1)
            # Safeguard: a correction that does not reduce the true
            # residual (the fp32 cycle diverged — rho>1 bail-outs at
            # extreme bk1 — or stagnated) is REVERTED, and the loop ends
            # by jumping the round counter; refinement may stop early but
            # can never make the Newton step worse than its best iterate.
            ok = rel < rel_prev
            w2 = jnp.where(ok, w2, wd)
            rel = jnp.where(ok, rel, rel_prev)
            rounds = jnp.where(ok, rounds + 1, jnp.int32(refine))
            return w2, rel, rounds, jnp.maximum(its, cor.iters)

        w0 = guess.astype(hi)
        _, _, r0 = residual(w0)
        rel0 = jnp.linalg.norm(r0) / safe_nf
        w, rel, _, iters = lax.while_loop(
            refine_cond, refine_body,
            (w0, rel0, jnp.int32(0), jnp.int32(0)))
        wd, a, _ = residual(w)
        u = wd + a
        return q0 * u, iters, rel

    return he_solve, ncomp, last


def _a0diag_hi(S, p, q):
    """Exact ``A0`` diagonal in the input precision: column/row sums of
    ``E_ij = p_i^2 q_j^2 s_ij``."""
    p2 = p * p
    q2 = q * q
    col = q2 * _mm(S.T, p2)   # (n,)
    row = p2 * _mm(S, q2)     # (m,)
    return jnp.concatenate([col, row])


def make_aug_pcg_solver(p: jax.Array, q: jax.Array,
                        opts: PCGOptions) -> NewtonSolver:
    """Nullspace-augmented PCG (``aug_PCG.m``, ``inner_solver=3``).

    Solves the bordered system ``[[Y^T QK Y, Y^T QK], [QK Y, Ae]]`` where
    ``Y`` is the component indicator matrix — realized matrix-free through
    segment reductions on the component labels, with the coarse unknowns
    carried at their component-root positions of an N-padded vector.
    """
    n = q.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        del key
        E, g, kdiag, f, q0 = _transform(S, tvec, bk1, tk, rhs, p, q)
        N = g.shape[0]
        labels, _, ncomp, _last = _component_info(E, kdiag)
        roots = labels == jnp.arange(N, dtype=labels.dtype)
        qp2 = jnp.concatenate([q * q, p * p])
        qk = bk1 * qp2 + kdiag / tk  # diag of QK = bk1*Q + K/tk
        inv_tk = 1.0 / tk

        def ae_mv(v):
            v1, v2 = v[:n], v[n:]
            o1 = g[:n] * v1 - inv_tk * _mm(E.T, v2)
            o2 = g[n:] * v2 - inv_tk * _mm(E, v1)
            return jnp.concatenate([o1, o2])

        def aug_mv(x):
            U, u = x[:N], x[N:]
            Yu = U[labels]  # (Y U) expanded to nodes
            top = jax.ops.segment_sum(qk * (Yu + u), labels,
                                      num_segments=N)
            top = jnp.where(roots, top, U)  # identity on padding rows
            bot = qk * Yu + ae_mv(u)
            return jnp.concatenate([top, bot])

        seg_qk = jax.ops.segment_sum(qk, labels, num_segments=N)
        diag_top = jnp.where(roots, seg_qk, 1.0)
        diag_aug = jnp.concatenate([diag_top, g])
        aug_f = jnp.concatenate(
            [jnp.where(roots,
                       jax.ops.segment_sum(f, labels, num_segments=N),
                       0.0), f])
        r = pcg(aug_mv, aug_f, lambda v: v / diag_aug,
                retol=opts.retol, maxit=opts.maxit)
        U, u = r.x[:N], r.x[N:]
        zeta = q0 * (U[labels] + u)
        return NewtonSolveResult(zeta, r.iters, r.res, ncomp, jnp.int32(0))

    return solve


def make_direct_solver(p: jax.Array, q: jax.Array) -> NewtonSolver:
    """Dense direct solve of ``Jk zeta = rhs`` (``inner_solver=1``,
    ``Class1/APD_SsN_Class1.m:143-145``) — materializes the (n+m)^2 KKT
    matrix; dense Cholesky.  Intended for oracles/small systems."""
    n = q.shape[0]
    m = p.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        del key
        from otamg.ot import operators as op

        d1, d2 = op.asat_diags(S, p, q)
        off = (q[:, None] * S.T) * p[None, :]  # diag(q) Y^T diag(p), (n,m)
        H0 = jnp.block([[jnp.diag(d1), off], [off.T, jnp.diag(d2)]])
        Jk = bk1 * jnp.eye(n + m, dtype=S.dtype) \
            + (jnp.diag(tvec) + H0) / tk
        zeta = jax.scipy.linalg.solve(Jk, rhs, assume_a="pos")
        one = jnp.int32(1)
        return NewtonSolveResult(zeta, one, jnp.asarray(0.0, S.dtype),
                                 jnp.int32(0), jnp.int32(0))

    return solve
