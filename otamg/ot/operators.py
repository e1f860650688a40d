"""Matrix-free OT operator kernels (layer L1).

The discrete OT constraint matrix is the Kronecker-structured

.. math::

    A = \\begin{bmatrix} I_n \\otimes p^T \\\\ q^T \\otimes I_m \\end{bmatrix}
        \\in \\mathbb{R}^{(n+m) \\times mn},

with marginal weights :math:`p \\in \\mathbb{R}^m`, :math:`q \\in
\\mathbb{R}^n`.  The reference applies it matrix-free on the vectorised plan
(``Ax.m:10-13``, ``Aty.m:10-13``).  Accelerator-first redesign: the plan is
*always* held as the dense matrix :math:`X \\in \\mathbb{R}^{m \\times n}`
(MATLAB's ``vec`` is column-major, so ingest reshapes with ``order='F'``);
every operator application is a GEMV/GEMM or rank-2 outer-product update
that maps straight onto dense BLAS.  Dual vectors are flat ``(n + m,)`` arrays with
the ``n`` block first, matching the reference layout ``y = [r-part; l-part]``.

All functions are dtype-polymorphic and jit-safe (static shapes, no Python
control flow on traced values).  Matmuls use ``Precision.HIGHEST`` because
the downstream Newton solves need every bit of f32 accuracy (the default
precision may round fp32 operands to TF32 on a GPU).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

_P = lax.Precision.HIGHEST

# Convention used throughout this module:
#   X : (m, n) plan matrix            s/Y : (m, n) active-set mask
#   y : (n + m,) dual vector, blocks (yn, ym) with yn of length n
#   p : (m,) row marginal weights     q : (n,) column marginal weights


def split_dual(y: jax.Array, n: int):
    """Split a flat dual vector into its (n,) and (m,) blocks."""
    return y[:n], y[n:]


def apply_A(X: jax.Array, p: jax.Array, q: jax.Array,
            out_dtype=None) -> jax.Array:
    """``A @ vec(X)`` without materialising ``A`` (reference ``Ax.m``).

    Returns the flat ``(n + m,)`` vector ``[X^T p; X q]``.  ``out_dtype``
    requests a higher accumulation precision (mixed-precision mode: fp32
    storage with f64-accumulated reductions).
    """
    kw = {} if out_dtype is None else {
        "preferred_element_type": out_dtype}
    yn = jnp.matmul(X.T, p, precision=_P, **kw)
    ym = jnp.matmul(X, q, precision=_P, **kw)
    return jnp.concatenate([yn, ym])


# Two-stage reduction chunk width.  A single long reduce whose
# accumulation is linear loses relative accuracy in proportion to its
# length on a same-sign sum, and the Class-2 warm start amplifies that
# error through its (ak/bk)-scaled multiplier updates.  Splitting into
# 2048-wide chunks keeps every accumulator short at negligible cost; XLA
# fuses the reshape.
_CHUNK = 2048


def sum_chunked(x: jax.Array) -> jax.Array:
    """Numerically-safe sum of a 1-D array (recursive chunked reduce).

    Recursion keeps EVERY accumulator at most ``_CHUNK`` long: a two-stage
    reduce would leave the outer accumulate linear in ``n / _CHUNK`` (a
    4096^2 plan gives an 8192-term same-sign outer sum), while the
    recursive form bounds every accumulator at every scale.  Depth is
    ceil(log_2048 n): static, tiny.
    """
    n = x.shape[0]
    if n <= _CHUNK:
        return jnp.sum(x)
    rows = -(-n // _CHUNK)
    xp = jnp.pad(x, (0, rows * _CHUNK - n)).reshape(rows, _CHUNK)
    return sum_chunked(jnp.sum(xp, axis=1))


def vdot_hi(a: jax.Array, b: jax.Array, out_dtype=None) -> jax.Array:
    """Dot product with chunked accumulation (and optional higher
    precision).  The f32*f32 products are exact in f64, so casting before
    the multiply matches einsum's mixed-precision accumulate exactly."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    if out_dtype is not None:
        a = a.astype(out_dtype)
        b = b.astype(out_dtype)
    return sum_chunked(a * b)


def norm_hi(a: jax.Array, out_dtype=None) -> jax.Array:
    """2-norm with optional high-precision accumulation."""
    return jnp.sqrt(vdot_hi(a, a, out_dtype))


def apply_At(y: jax.Array, p: jax.Array, q: jax.Array) -> jax.Array:
    """``unvec(A^T y)`` as an ``(m, n)`` rank-2 outer-product sum
    (reference ``Aty.m``): ``p yn^T + ym q^T``."""
    n = q.shape[0]
    yn, ym = split_dual(y, n)
    return jnp.outer(p, yn) + jnp.outer(ym, q)


def asat_diags(S: jax.Array, p: jax.Array, q: jax.Array):
    """Diagonal blocks of ``H0 = A diag(s) A^T`` (reference ``ASAt.m:9-19``).

    With ``Y = unvec(s)``: ``d1 = Y^T (p*p)`` (length n) and
    ``d2 = Y (q*q)`` (length m).  The off-diagonal block is the masked
    dense matrix ``diag(q) Y^T diag(p)`` (n x m) — never materialised;
    see :func:`apply_asat`.
    """
    d1 = jnp.matmul(S.T, p * p, precision=_P)
    d2 = jnp.matmul(S, q * q, precision=_P)
    return d1, d2


def apply_asat(z: jax.Array, S: jax.Array, p: jax.Array, q: jax.Array,
               d1: jax.Array | None = None,
               d2: jax.Array | None = None) -> jax.Array:
    """Matrix-free ``H0 @ z`` with ``H0 = A diag(s) A^T``
    (operator form of reference ``ASAt.m`` / dead ``ASAtz.m``).

    Block action on ``z = (z1 (n,), z2 (m,))``::

        out1 = d1*z1 + q * (Y^T (p*z2))
        out2 = p * (Y (q*z1)) + d2*z2

    Two masked GEMVs over the ``(m, n)`` grid; O(mn) flops.
    """
    n = q.shape[0]
    if d1 is None or d2 is None:
        d1, d2 = asat_diags(S, p, q)
    z1, z2 = split_dual(z, n)
    out1 = d1 * z1 + q * jnp.matmul(S.T, p * z2, precision=_P)
    out2 = p * jnp.matmul(S, q * z1, precision=_P) + d2 * z2
    return jnp.concatenate([out1, out2])


def prox_box(X: jax.Array, gama) -> jax.Array:
    """Projection onto ``[0, gama]`` (reference ``prox`` lambda,
    ``Class1/APD_SsN_Class1.m:29``).  ``gama`` may be scalar ``inf``."""
    return jnp.clip(X, 0.0, gama)


def prox_nonneg(X: jax.Array) -> jax.Array:
    """Projection onto the nonnegative orthant (``Class2/APD_SsN_Class2.m:25``)."""
    return jnp.maximum(X, 0.0)


def inv_aat(x: jax.Array, p: jax.Array, q: jax.Array,
            sg1: float | jax.Array, sg2: float | jax.Array | None = None
            ) -> jax.Array:
    """Closed-form ``(diag(sg1 I_n, sg2 I_m) + A A^T)^{-1} x``
    (reference ``invAAt.m:17-18``).

    ``A A^T = [[|p|^2 I_n, q p^T], [p q^T, |q|^2 I_m]]`` — two scaled
    identities plus a rank-1 coupling, inverted exactly in O(m + n).
    """
    if sg2 is None:
        sg2 = sg1
    n = q.shape[0]
    np2 = jnp.vdot(p, p)
    nq2 = jnp.vdot(q, q)
    vn, vm = split_dual(x, n)
    den = sg1 * sg2 + sg1 * nq2 + sg2 * np2
    qvn = jnp.vdot(q, vn)
    pvm = jnp.vdot(p, vm)
    yn = vn / (sg1 + np2) + (np2 / (sg1 + np2) * qvn - pvm) * q / den
    ym = vm / (sg2 + nq2) + (nq2 / (sg2 + nq2) * pvm - qvn) * p / den
    return jnp.concatenate([yn, ym])


def inv_hht(v: jax.Array, p: jax.Array, q: jax.Array, sg,
            Phi: jax.Array) -> jax.Array:
    """Closed-form ``(sg I + H H^T)^{-1} v`` for the POT operator
    ``H = [G, IY, IZ]`` with ``G = [A; phi^T]`` (reference
    ``Class2/invHHt.m:8-17``).

    One extra row/column over :func:`inv_aat`, eliminated via the 2x2 block
    Schur complement with scalar ``s = t - l^T V l``, ``l = A phi``.
    ``Phi`` is the ``(m, n)`` matrix form of ``phi``.
    """
    t = sg + vdot_hi(Phi, Phi)  # O(mn) same-sign sum: chunked (see above)
    el = apply_A(Phi, p, q)
    Vl = inv_aat(el, p, q, sg + 1.0)
    s = t - jnp.vdot(el, Vl)
    v1, v2 = v[:-1], v[-1]
    Vv1 = inv_aat(v1, p, q, sg + 1.0)
    y1 = s * Vv1 + jnp.vdot(el, Vv1) * Vl - v2 * Vl
    y2 = v2 - jnp.vdot(el, Vv1)
    return jnp.concatenate([y1, y2[None]]) / s


# ---------------------------------------------------------------------------
# Class-2 (partial OT) extended operator H = [G, IY, IZ], G = [A; phi^T].
# Primal u = (X (m,n), y (n,), z (m,)); dual lam has length n + m + 1.
# ---------------------------------------------------------------------------


def apply_H(X: jax.Array, y: jax.Array, z: jax.Array,
            p: jax.Array, q: jax.Array, Phi: jax.Array,
            out_dtype=None) -> jax.Array:
    """``H @ (vec(X), y, z)`` = ``[A vec(X) + [y; z]; <phi, x>]``
    (reference ``Class2/APD_SsN_Class2.m:60``).  ``out_dtype`` requests
    high-precision accumulation of the O(mn) reductions (mixed-precision
    mode, as :func:`apply_A`)."""
    yz = jnp.concatenate([y, z])
    top = apply_A(X, p, q, out_dtype) + (
        yz if out_dtype is None else yz.astype(out_dtype))
    bot = vdot_hi(Phi, X, out_dtype)
    return jnp.concatenate([top, bot[None]])


def feasibility_polish(X: jax.Array, y: jax.Array, z: jax.Array,
                       p: jax.Array, q: jax.Array, Phi: jax.Array,
                       b: jax.Array, rounds: int = 8,
                       lam: jax.Array | None = None):
    """OT-native feasibility rounding of the POT primal ``u = (X, y, z)``
    onto ``{H u = b, u >= 0}`` (Altschuler-et-al-style, adapted to the
    partial-OT slack structure).

    Tail safeguard with no reference analogue: in the degenerate APD tail
    the complementarity residuals can sit at target while the feasibility
    residual ``||H u - b||`` stalls on active-set chatter (rounding
    coarser than the CPU's f64 flips marginally-active entries).  A least-norm projection fails here — it spreads correction
    mass onto the plan's zero entries where the nonneg clip undoes it —
    so instead:

    1. scale each column/row of ``X`` down to its marginal
       (``p^T X_col <= b_j``, ``(X q)_i <= b_{n+i}``) — never increases
       entries, preserves the support;
    2. restore the phi-row mass ``phi^T x = mu``: a deficit is added
       back proportionally to the remaining row/column slacks (never
       violating the marginals), a surplus removed by a global scale;
    3. the slacks absorb the (now one-sided) marginal gaps exactly:
       ``y = b[:n] - X^T p >= 0``, ``z = b[n:] - X q >= 0``.

    The result is feasible to roundoff; the caller re-measures the FULL
    KKT on the polished iterate, so the convergence claim stays honest.

    With ``lam`` given, the rounding is DUAL-AWARE: columns/rows whose
    duals are strictly positive are filled EXACTLY to their marginals
    (complementarity demands zero slack there) and the phi-mass rebalance
    is restricted to doubly-unsaturated entries, so the residual marginal
    gaps settle where ``y/z > 0`` is dual-consistent.
    """
    n = q.shape[0]
    m = p.shape[0]
    bl, bm, mu = b[:n], b[n:-1], b[-1]
    if lam is not None:
        # Dual-saturated rows/columns (lam strictly positive above noise)
        # must end with ZERO slack or the reassigned y/z reads as
        # complementarity residual against those duals.
        sat_c = lam[:n] > 1e-5
        sat_r = lam[n:n + m] > 1e-5
    else:
        sat_c = jnp.zeros(n, bool)
        sat_r = jnp.zeros(m, bool)
    for _ in range(rounds):
        # 1. column/row scale-down (never increases entries, keeps the
        # support), then EXACT multiplicative fill-up of the saturated
        # columns and rows.  The row pass perturbs the columns first-
        # order in the slack, so the alternation is Sinkhorn-like and
        # converges geometrically over the rounds.
        col = jnp.matmul(X.T, p, precision=_P)           # (n,)
        X = X * jnp.minimum(1.0, bl / jnp.where(col > 0, col, 1.0))[None, :]
        row = jnp.matmul(X, q, precision=_P)             # (m,)
        X = X * jnp.minimum(1.0, bm / jnp.where(row > 0, row, 1.0))[:, None]
        col = jnp.matmul(X.T, p, precision=_P)
        fc = jnp.where(sat_c & (col > 0),
                       bl / jnp.where(col > 0, col, 1.0), 1.0)
        X = X * fc[None, :]
        row = jnp.matmul(X, q, precision=_P)
        fr = jnp.where(sat_r & (row > 0),
                       bm / jnp.where(row > 0, row, 1.0), 1.0)
        X = X * fr[:, None]
        mass = vdot_hi(Phi, X)
        if lam is not None:
            # 2a. phi-row mass correction through the doubly-UNSATURATED
            # entries only (their rows/columns have genuine slack, so
            # the rescale lands where y/z > 0 is dual-consistent).
            U = (~sat_r)[:, None] & (~sat_c)[None, :]
            Mu = vdot_hi(Phi * U, X)
            want = mu - (mass - Mu)
            f = jnp.where(Mu > 0, want / jnp.where(Mu > 0, Mu, 1.0), 1.0)
            # Clamp: f < 0 would write negative plan entries (only the
            # slacks go through prox_nonneg), and f > fmax would overfill
            # the unsaturated marginals.  fmax is the tightest remaining
            # slack ratio over the columns/rows the rescale touches.
            XU = jnp.where(U, X, 0.0)
            colU = jnp.matmul(XU.T, p, precision=_P)
            rowU = jnp.matmul(XU, q, precision=_P)
            col = jnp.matmul(X.T, p, precision=_P)
            row = jnp.matmul(X, q, precision=_P)
            fmax_c = jnp.min(jnp.where(
                colU > 0, 1.0 + (bl - col) / jnp.where(colU > 0, colU, 1.0),
                jnp.inf))
            fmax_r = jnp.min(jnp.where(
                rowU > 0, 1.0 + (bm - row) / jnp.where(rowU > 0, rowU, 1.0),
                jnp.inf))
            fmax = jnp.maximum(jnp.minimum(fmax_c, fmax_r), 1.0)
            f = jnp.clip(f, 0.0, fmax)
            X = jnp.where(U, X * f, X)
        else:
            # 2b. generic mass correction: a deficit is ADDED along the
            # row/column slack product (never violating the marginals —
            # targeted, so it converges on sparse supports where a
            # global rescale would ping-pong against the marginal caps);
            # a surplus is removed by a global scale.
            deficit = mu - mass
            col = jnp.matmul(X.T, p, precision=_P)
            row = jnp.matmul(X, q, precision=_P)
            cs = jnp.maximum(bl - col, 0.0)
            rs = jnp.maximum(bm - row, 0.0)
            D = (rs / p)[:, None] * cs[None, :]
            denom = vdot_hi(Phi, D)
            add = jnp.where(denom > 0,
                            deficit / jnp.where(denom > 0, denom, 1.0),
                            0.0)
            # Cap so the addition cannot overfill a marginal (the loop can
            # end on this step): column j gains add*cs_j*sum(rs) <= cs_j
            # -> add <= 1/sum(rs); row i gains add*(rs_i/p_i)*(q.cs)
            # <= rs_i -> add <= min(p)/(q.cs).
            srs = sum_chunked(rs)
            qcs = jnp.vdot(q, cs)
            cap = jnp.minimum(
                jnp.where(srs > 0, 1.0 / jnp.where(srs > 0, srs, 1.0),
                          jnp.inf),
                jnp.where(qcs > 0, jnp.min(p) / jnp.where(qcs > 0, qcs, 1.0),
                          jnp.inf))
            add = jnp.minimum(add, cap)
            scale = jnp.where(mass > 0,
                              mu / jnp.where(mass > 0, mass, 1.0), 1.0)
            X = jnp.where(deficit >= 0, X + add * D, X * scale)
    # 3. slacks absorb the marginal gaps exactly.
    col = jnp.matmul(X.T, p, precision=_P)
    row = jnp.matmul(X, q, precision=_P)
    y = prox_nonneg(bl - col)
    z = prox_nonneg(bm - row)
    return X, y, z


def apply_Ht(lam: jax.Array, p: jax.Array, q: jax.Array, Phi: jax.Array):
    """``H^T lam`` split into plan/slack parts (reference
    ``Class2/APD_SsN_Class2.m:124``): returns ``(G^T lam`` as ``(m, n)``,
    ``lam[:n+m])`` — the slack blocks just see the first ``n+m`` duals."""
    lam_nm, lam_last = lam[:-1], lam[-1]
    Xpart = apply_At(lam_nm, p, q) + lam_last * Phi
    return Xpart, lam_nm


# ---------------------------------------------------------------------------
# KKT residuals
# ---------------------------------------------------------------------------


def kkt_class1(X: jax.Array, lam: jax.Array, C: jax.Array, b: jax.Array,
               p: jax.Array, q: jax.Array, gama, out_dtype=None):
    """Primal/dual KKT residual norms for Class 1
    (reference ``Class1/APD_SsN_Class1.m:63-65``)::

        KKT(lam) = || A x - b ||
        KKT(x)   = || x - prox(x - c - A^T lam) ||
    """
    hb = b if out_dtype is None else b.astype(out_dtype)
    kkt_l = jnp.linalg.norm(apply_A(X, p, q, out_dtype) - hb)
    lam_lo = lam.astype(X.dtype)
    R = X - prox_box(X - C - apply_At(lam_lo, p, q), gama)
    kkt_x = norm_hi(R.ravel(), out_dtype)
    return kkt_x, kkt_l


def kkt_class2(X: jax.Array, y: jax.Array, z: jax.Array, lam: jax.Array,
               C: jax.Array, b: jax.Array, p: jax.Array, q: jax.Array,
               Phi: jax.Array, out_dtype=None):
    """Four KKT residual norms for Class 2 (partial OT), reference
    ``Class2/APD_SsN_Class2.m:56-59``.  ``out_dtype`` requests
    high-precision accumulation (as :func:`kkt_class1`)."""
    n = q.shape[0]
    hb = b if out_dtype is None else b.astype(out_dtype)
    kkt_l = jnp.linalg.norm(apply_H(X, y, z, p, q, Phi, out_dtype) - hb)
    lam_lo = lam.astype(X.dtype)
    lam_n, lam_m = lam_lo[:n], lam_lo[n:n + X.shape[0]]
    kkt_z = norm_hi(z - jnp.maximum(z - lam_m, 0.0), out_dtype)
    kkt_y = norm_hi(y - jnp.maximum(y - lam_n, 0.0), out_dtype)
    Gt = apply_At(lam_lo[:-1], p, q) + lam_lo[-1] * Phi
    Rx = X - jnp.maximum(X - C - Gt, 0.0)
    kkt_x = norm_hi(Rx.ravel(), out_dtype)
    return kkt_x, kkt_y, kkt_z, kkt_l
