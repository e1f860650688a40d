"""Preconditioned conjugate gradients (layer L2).

Shewchuk-style PCG as in reference ``PCG.m:1-6,76-86``: one operator
application, one preconditioner application, two dots and three axpys per
iteration, stopping on ``delta_new <= tol^2 * delta_0`` or ``maxit``.

Accelerator-first redesign: the loop is a ``lax.while_loop`` over a small
carry, so an entire solve is a single XLA computation — no per-iteration
host sync.
The operator and preconditioner are passed as *functions* (closures over
whatever structure represents the matrix: masked-dense bipartite blocks,
padded CSR, or an explicit dense array), which is how matrix-freedom is
expressed in JAX instead of MATLAB's sparse-matrix polymorphism.

The preconditioner menu of ``PCG.m:34-66`` is provided by
:func:`make_preconditioner` for explicit dense matrices; structured callers
build their own closures (e.g. the closed-form bi-SSOR inverse for the
bipartite Laplacian lives in :mod:`otamg.amg.hierarchy`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from otamg.config import PCGOptions, Preconditioner

_P = lax.Precision.HIGHEST


class PCGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array      # int32 iterations taken
    res: jax.Array        # final relative residual sqrt(delta_new/delta_0)
    resk: jax.Array | None = None  # per-iteration residual history
    #   (reference ``PCG.m:74,85``); fixed-size ``resk_len`` device array,
    #   entry i = relative residual after iteration i+1, 0 beyond `iters`.


def pcg(matvec: Callable[[jax.Array], jax.Array],
        e: jax.Array,
        precond: Callable[[jax.Array], jax.Array] | None = None,
        x0: jax.Array | None = None,
        retol: float = 1e-11,
        maxit: int = 10_000,
        resk_len: int = 0) -> PCGResult:
    """Solve ``H d = e`` for SPD ``H`` given as a matvec closure.

    Matches the reference loop ``PCG.m:69-88`` (including the
    ``delta_new > tol^2 * delta_0`` stopping rule measured in the
    preconditioner norm).  With ``resk_len > 0`` the per-iteration relative
    residual history is carried in a fixed-size device array and returned
    as ``PCGResult.resk`` (the reference's fourth output, ``PCG.m:74,85``)
    — fixed capacity keeps the loop jittable under static shapes.
    """
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(e)

    # Low-precision floor: fp32 cannot reach the reference's 1e-11, so the
    # tolerance is clamped to a few ulps of relative residual; in fp64 the
    # floor (~9e-16) never binds (SURVEY.md hard part (f)).
    eps = jnp.finfo(e.dtype).eps
    retol_eff = jnp.maximum(jnp.asarray(retol, e.dtype), 4 * eps)

    r0 = e - matvec(x0)
    p0 = precond(r0)
    delta0 = jnp.vdot(r0, p0)
    # Guard: delta0 == 0 means x0 is exact; loop below then never runs.
    safe_delta0 = jnp.where(delta0 == 0, 1.0, delta0)

    resk0 = jnp.zeros(resk_len, e.dtype) if resk_len > 0 else None

    def cond(carry):
        it, d, r, p, delta_new, done, resk = carry
        return jnp.logical_not(done)

    def body(carry):
        it, d, r, p, delta_old, _, resk = carry
        q = matvec(p)
        qp = jnp.vdot(q, p)
        # Breakdown guard: qp <= 0 (or NaN) means SPD has been lost to
        # roundoff — stop and keep the current iterate.
        breakdown = jnp.logical_not(qp > 0)
        alpha = jnp.where(breakdown, 0.0, delta_old / jnp.where(
            qp == 0, 1.0, qp))
        d1 = d + alpha * p
        r1 = r - alpha * q
        w = precond(r1)
        delta_new = jnp.vdot(r1, w)
        beta = delta_new / jnp.where(delta_old == 0, 1.0, delta_old)
        p1 = w + beta * p
        keep = jnp.logical_not(breakdown)
        it1 = it + keep.astype(jnp.int32)
        done = jnp.logical_or(
            breakdown,
            jnp.logical_or(it1 >= maxit, jnp.logical_not(
                delta_new > (retol_eff ** 2) * delta0)))
        done = jnp.logical_or(done,
                              jnp.logical_not(jnp.isfinite(delta_new)))
        sel = lambda a, b: jnp.where(keep, a, b)
        if resk is not None:
            # Record at the *pre-increment* index as ``resk(it) = ...``
            # (``PCG.m:85``); rejected (breakdown) steps record nothing.
            val = jnp.sqrt(jnp.abs(sel(delta_new, delta_old) / safe_delta0))
            idx = jnp.minimum(it, resk_len - 1)
            resk = jnp.where(keep, resk.at[idx].set(val), resk)
        return (it1, sel(d1, d), sel(r1, r), sel(p1, p),
                sel(delta_new, delta_old), done, resk)

    init_done = jnp.logical_not(delta0 > (retol_eff ** 2) * delta0)
    init_done = jnp.logical_or(init_done, delta0 == 0)
    it, d, r, p, delta_new, _, resk = lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, p0, delta0,
                     jnp.logical_or(init_done, maxit <= 0), resk0))
    res = jnp.sqrt(jnp.abs(delta_new / safe_delta0))
    return PCGResult(d, it, res, resk)


def _tri_solve_lower(L: jax.Array, b: jax.Array) -> jax.Array:
    return jax.scipy.linalg.solve_triangular(L, b, lower=True)


def _tri_solve_upper(U: jax.Array, b: jax.Array) -> jax.Array:
    return jax.scipy.linalg.solve_triangular(U, b, lower=False)


def make_preconditioner(H: jax.Array, which: Preconditioner,
                        omega: float = 1.5,
                        nf: int | None = None
                        ) -> Callable[[jax.Array], jax.Array]:
    """Build ``r -> M^{-1} r`` for an explicit dense SPD ``H``
    (reference ``PCG.m:34-66`` and ``pre_cond_M`` at ``:90-105``).

    * NONE   — identity.
    * JACOBI — divide by ``diag(H)`` (reference default, ``PCG.m:23``).
    * SSOR   — ``omega*(2-omega) * (D+omega*U)^{-1} D (D+omega*L)^{-1}``
      via two dense triangular solves (``PCG.m:96-99``).
    * ICHOL  — zero-fill incomplete Cholesky.  On an accelerator a dense
      Cholesky of the (small, dense) coarse matrices is both faster and
      stronger, so we use the *complete* factor; the reference only reaches this branch
      when ``precd=4`` is hand-selected (``PCG.m:46``, never by defaults).
    * BI_SSOR — the explicit bipartite-SSOR inverse (``PCG.m:55-66``)
      requires the fine-node split ``nf``; built here densely.
    """
    n = H.shape[0]
    if which == Preconditioner.NONE:
        return lambda r: r
    if which == Preconditioner.JACOBI:
        dinv = 1.0 / jnp.diag(H)
        return lambda r: r * dinv
    if which == Preconditioner.SSOR:
        D = jnp.diag(jnp.diag(H))
        L = jnp.tril(H, -1)
        U = jnp.triu(H, 1)
        DL = D + omega * L
        DU = D + omega * U
        scale = omega * (2.0 - omega)

        def apply_ssor(r):
            p1 = _tri_solve_lower(DL, r)
            p2 = jnp.diag(H) * p1
            return scale * _tri_solve_upper(DU, p2)

        return apply_ssor
    if which == Preconditioner.ICHOL:
        Lc = jnp.linalg.cholesky(H)

        def apply_chol(r):
            y = _tri_solve_lower(Lc, r)
            return _tri_solve_upper(Lc.T, y)

        return apply_chol
    if which == Preconditioner.BI_SSOR:
        if nf is None:
            raise ValueError("BI_SSOR requires the fine-node count nf "
                             "(reference PCG.m:67 errors likewise)")
        V = jnp.diag(H)[:nf]
        T = jnp.diag(H)[nf:]
        U = H[:nf, nf:]
        invV = 1.0 / V
        invT = 1.0 / T
        scale = omega * (2.0 - omega)

        def apply_bissor(r):
            r1, r2 = r[:nf], r[nf:]
            # [invV + w^2 invV U invT U' invV, -w invV U invT;
            #  -w invT U' invV,                 invT]
            Ut_invV_r1 = jnp.matmul(U.T, invV * r1, precision=_P)
            p1 = invV * r1 + (omega ** 2) * invV * jnp.matmul(
                U, invT * Ut_invV_r1, precision=_P) \
                - omega * invV * jnp.matmul(U, invT * r2, precision=_P)
            p2 = -omega * invT * Ut_invV_r1 + invT * r2
            return scale * jnp.concatenate([p1, p2])

        return apply_bissor
    raise ValueError(f"unknown preconditioner {which}")


def pcg_matrix(H: jax.Array, e: jax.Array,
               opts: PCGOptions = PCGOptions(),
               x0: jax.Array | None = None,
               nf: int | None = None,
               resk: bool = False) -> PCGResult:
    """Reference-shaped entry ``[d, it, res, resk] = PCG(H, e,
    pcg_options)`` for an explicit dense matrix (``PCG.m:1``); pass
    ``resk=True`` for the per-iteration residual history (4th output)."""
    matvec = lambda v: jnp.matmul(H, v, precision=_P)
    precond = make_preconditioner(H, opts.precd, opts.omega, nf)
    return pcg(matvec, e, precond, x0, opts.retol, opts.maxit,
               resk_len=opts.maxit if resk else 0)
