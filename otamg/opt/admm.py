"""A-ADMM warm start (layer L5).

Accelerated ADMM producing the initial pair ``(x0, lambda0)`` for the APD
loop, matching reference ``Class1/warmup_class1.m`` and
``Class2/warmup_class2.m``.  Every iteration is closed-form: the x-update
solves its KKT system exactly through the O(m+n) Schur inverses
(``invAAt.m`` / ``invHHt.m``) — no inner linear iteration at all.

Accelerator-first: the whole warm start is one ``lax.fori_loop`` inside
jit; state lives as ``(m, n)`` matrices; per-iteration cost is a handful
of fused O(mn) elementwise passes plus four GEMVs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from otamg.ot import operators as op
from otamg.ot.problems import Class1Problem, Class2Problem


class WarmStart1(NamedTuple):
    X: jax.Array      # (m, n) primal plan
    lam: jax.Array    # (n + m,) equality multipliers


class WarmStart2(NamedTuple):
    X: jax.Array      # (m, n)
    y: jax.Array      # (n,)
    z: jax.Array      # (m,)
    lam: jax.Array    # (n + m + 1,)


def warmup_class1(prob: Class1Problem, maxit: int = 100) -> WarmStart1:
    """Reference ``warmup_class1.m:2`` driven for a fixed ``maxit``
    iterations (the drivers use 100, ``Class1/APD_SsN_Class1.m:55,59``)."""
    p, q, C, gama = prob.p, prob.q, prob.C, prob.gama
    m, n = prob.m, prob.n
    b = prob.b
    Atb = op.apply_At(b, p, q)
    dtype = C.dtype

    zeros_mn = jnp.zeros((m, n), dtype)
    # State mirrors warmup_class1.m:28-30: the multiplier for [Ax=b; x=w]
    # is split into lam1 (n+m,) and its (m, n) block Lam2.
    class Carry(NamedTuple):
        gk: jax.Array
        bk: jax.Array
        X: jax.Array
        V: jax.Array
        W: jax.Array
        Pi: jax.Array
        lam1: jax.Array
        Lam2: jax.Array

    init = Carry(jnp.asarray(1.0, dtype), jnp.asarray(1.0, dtype),
                 zeros_mn, zeros_mn, zeros_mn, zeros_mn,
                 jnp.zeros(n + m, dtype), zeros_mn)
    muf = 0.0

    def body(_, s: Carry) -> Carry:
        # warmup_class1.m:57-60
        ak = s.bk
        bk1 = s.bk / (1 + ak)
        gk1 = (s.gk + muf * ak) / (1 + ak)
        etafk = (1 + ak) * s.gk + muf * ak
        sgk = 1.0 / bk1
        etagk = (1 + ak) * s.bk
        # warmup_class1.m:62-63
        wwk = (ak * s.Pi + s.W) / (1 + ak)
        wxk = (ak * s.gk * s.V + (s.gk + muf * ak) * s.X) / etafk
        # warmup_class1.m:65-67
        hlk1 = s.lam1 - (op.apply_A(s.X, p, q) - b) / s.bk
        hLk2 = s.Lam2 - (s.X - s.W) / s.bk - (ak / s.bk) * (s.Pi - s.W)
        cAw = -Atb - s.W
        cAlk = op.apply_At(hlk1, p, q) + hLk2
        dd = etafk * wxk - ak ** 2 * (C + cAlk + sgk * cAw)
        # warmup_class1.m:69-70 — closed-form KKT solve via invAAt
        tt = sgk * ak ** 2
        sg = 1 + etafk / tt
        X1 = (dd - op.apply_At(
            op.inv_aat(op.apply_A(dd, p, q), p, q, sg), p, q)) / (etafk + tt)
        # warmup_class1.m:71-75
        V1 = X1 + (X1 - s.X) / ak
        bLk2 = s.Lam2 + (ak / s.bk) * (V1 - s.Pi)
        W1 = op.prox_box(wwk - ak ** 2 / etagk * (-bLk2), gama)
        Pi1 = W1 + (W1 - s.W) / ak
        lam1_1 = s.lam1 + (ak / s.bk) * (op.apply_A(V1, p, q) - b)
        Lam2_1 = s.Lam2 + (ak / s.bk) * (V1 - Pi1)
        return Carry(gk1, bk1, X1, V1, W1, Pi1, lam1_1, Lam2_1)

    out = lax.fori_loop(0, maxit, body, init)
    return WarmStart1(out.X, out.lam1)


def warmup_class2(prob: Class2Problem, maxit: int = 100) -> WarmStart2:
    """Reference ``warmup_class2.m`` for the partial-OT three-block
    operator ``H = [G, IY, IZ]``; x-update uses ``invHHt``."""
    p, q, C, Phi = prob.p, prob.q, prob.C, prob.Phi
    m, n = prob.m, prob.n
    b = prob.b  # (n + m + 1,)
    Htb_X, Htb_s = op.apply_Ht(b, p, q, Phi)  # (m,n), (n+m,)
    dtype = C.dtype

    zeros_mn = jnp.zeros((m, n), dtype)
    zeros_s = jnp.zeros(n + m, dtype)

    class Carry(NamedTuple):
        gk: jax.Array
        bk: jax.Array
        X: jax.Array      # plan block of u
        u_s: jax.Array    # slack blocks (y; z), (n+m,)
        VX: jax.Array
        v_s: jax.Array
        WX: jax.Array
        w_s: jax.Array
        PiX: jax.Array
        pi_s: jax.Array
        lam1: jax.Array   # (n+m+1,) equality multipliers
        Lam2X: jax.Array  # (m, n) splitting multipliers, plan block
        lam2s: jax.Array  # (n+m,) splitting multipliers, slack block

    init = Carry(jnp.asarray(1.0, dtype), jnp.asarray(1.0, dtype),
                 zeros_mn, zeros_s, zeros_mn, zeros_s, zeros_mn, zeros_s,
                 zeros_mn, zeros_s, jnp.zeros(n + m + 1, dtype),
                 zeros_mn, zeros_s)
    muf = 0.0

    def Hu(X, u_s):
        return op.apply_H(X, u_s[:n], u_s[n:], p, q, Phi)

    def body(_, s: Carry) -> Carry:
        ak = s.bk
        bk1 = s.bk / (1 + ak)
        gk1 = (s.gk + muf * ak) / (1 + ak)
        etafk = (1 + ak) * s.gk + muf * ak
        sgk = 1.0 / bk1
        etagk = (1 + ak) * s.bk
        # warmup_class2.m:64-66
        wwX = (ak * s.PiX + s.WX) / (1 + ak)
        ww_s = (ak * s.pi_s + s.w_s) / (1 + ak)
        wuX = (ak * s.gk * s.VX + (s.gk + muf * ak) * s.X) / etafk
        wu_s = (ak * s.gk * s.v_s + (s.gk + muf * ak) * s.u_s) / etafk
        # warmup_class2.m:68-72
        hlk1 = s.lam1 - (Hu(s.X, s.u_s) - b) / s.bk
        hLk2X = s.Lam2X - (s.X - s.WX) / s.bk - (ak / s.bk) * (s.PiX - s.WX)
        hlk2s = s.lam2s - (s.u_s - s.w_s) / s.bk - (ak / s.bk) * (s.pi_s - s.w_s)
        cAwX = -Htb_X - s.WX
        cAw_s = -Htb_s - s.w_s
        HtX, Ht_s = op.apply_Ht(hlk1, p, q, Phi)
        cAlkX = HtX + hLk2X
        cAlk_s = Ht_s + hlk2s
        ddX = etafk * wuX - ak ** 2 * (C + cAlkX + sgk * cAwX)
        dd_s = etafk * wu_s - ak ** 2 * (cAlk_s + sgk * cAw_s)
        # warmup_class2.m:74-77 — closed form via invHHt
        tt = sgk * ak ** 2
        sg = 1 + etafk / tt
        Hdd = Hu(ddX, dd_s)
        ff = op.inv_hht(Hdd, p, q, sg, Phi)
        HtfX, Htf_s = op.apply_Ht(ff, p, q, Phi)
        X1 = (ddX - HtfX) / (etafk + tt)
        u_s1 = (dd_s - Htf_s) / (etafk + tt)
        # warmup_class2.m:79-86
        VX1 = X1 + (X1 - s.X) / ak
        v_s1 = u_s1 + (u_s1 - s.u_s) / ak
        b0 = Hu(VX1, v_s1) - b
        bLk2X = s.Lam2X + (ak / s.bk) * (VX1 - s.PiX)
        blk2s = s.lam2s + (ak / s.bk) * (v_s1 - s.pi_s)
        WX1 = op.prox_nonneg(wwX - ak ** 2 / etagk * (-bLk2X))
        w_s1 = op.prox_nonneg(ww_s - ak ** 2 / etagk * (-blk2s))
        PiX1 = WX1 + (WX1 - s.WX) / ak
        pi_s1 = w_s1 + (w_s1 - s.w_s) / ak
        lam1_1 = s.lam1 + (ak / s.bk) * b0
        Lam2X1 = s.Lam2X + (ak / s.bk) * (VX1 - PiX1)
        lam2s1 = s.lam2s + (ak / s.bk) * (v_s1 - pi_s1)
        return Carry(gk1, bk1, X1, u_s1, VX1, v_s1, WX1, w_s1,
                     PiX1, pi_s1, lam1_1, Lam2X1, lam2s1)

    out = lax.fori_loop(0, maxit, body, init)
    return WarmStart2(out.X, out.u_s[:n], out.u_s[n:], out.lam1)
