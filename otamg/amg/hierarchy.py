"""AMG hierarchy: setup, cycles and the classical solve loop (layer L3).

Reimplements the reference engine (``AMG/Class_AMG.m``, ``AMG/transfer.m``,
``AMG/MG_Vcycle.m``, ``AMG/MG_Wcycle.m``) with an accelerator-native
structure:

* **Level 1 is structured, not sparse.**  The fine operator is
  ``Ae = diag(g) - E/tk`` on the bipartite node set (q-side then p-side),
  where ``E`` is the ``(m, n)`` masked-dense edge-weight matrix
  ``E_ij = p_i^2 q_j^2 s_ij``.  Matvecs, the block Gauss-Seidel smoother
  (``Class_AMG.m:48-59``) and the level-1 ideal interpolation
  (``transfer.m:19-25``) are all GEMV/GEMM on ``E`` — dense BLAS work, no
  CSR.
* **Coarse levels are capacity-padded dense.**  MIS coarsening yields
  data-dependent sizes; each level has a *static* capacity
  (``ceil(ratio * prev)``) with an activity mask, padded entries carry an
  identity diagonal.  Every shape is static, so the whole setup + solve
  compiles once.
* **One hierarchy for all graph components.**  Instead of the reference's
  per-component sub-AMGs (``Hybrid_AMG.m:53-81``), the kernel-projected
  smoothing of ``MG_Vcycle.m:14-21`` is generalized to *per-component*
  scalar corrections via segment reductions over component labels — the
  same math applied to every component simultaneously, with the
  correction coefficient zeroed on components that are not near-singular.
* **Cycles run off a static visit tape.**  The V/W-cycle recursion is
  unrolled at trace time into a sequence of (op, level) codes executed by
  ``lax.scan`` + ``lax.switch``; trace size is O(levels), runtime equals
  the recursive schedule (a W-cycle's second child visit is warm-started
  exactly as ``MG_Wcycle.m:28-30``; the duplicate coarsest-level solve the
  reference performs — its warm start is ignored there — is deduplicated).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from otamg.amg.graph import mis_dense, strength_dense
from otamg.config import AMGOptions, Cycle
from otamg.krylov.pcg import pcg

_P = lax.Precision.HIGHEST

# Diagnostic kill-switch: disable the fused (carried-product) bipartite
# smoother and run the generic recompute-every-sweep path.
import os as _os

_NO_FUSED_SMOOTH = bool(_os.environ.get("OTAMG_NO_FUSED_SMOOTH"))


def _mm(a, b):
    return jnp.matmul(a, b, precision=_P)


class BipartiteLevel(NamedTuple):
    """Finest level: ``A = diag(g) - E/tk`` over n q-side + m p-side nodes."""

    E: jax.Array        # (m, n) nonnegative edge weights
    g: jax.Array        # (n + m,) diagonal
    inv_tk: jax.Array   # scalar 1/tk
    W: jax.Array        # (n, m) ideal-interpolation block to level 2
    labels: jax.Array   # (n + m,) component labels
    nsp: jax.Array      # (n + m,) near-singular-component mask
    Axi: jax.Array      # (n + m,) A @ 1 (for kernel-projected smoothing)
    xx: jax.Array       # (n + m,) per-node gathered xi^T A xi of component
    Exi1: jax.Array     # (m,)  E @ nsp[:n] — the fused smoother's carried
    #                     edge-product update along the projection vector
    #                     (exact: E is nonnegative, the sum cancels nothing)
    Etxi2: jax.Array    # (n,)  E^T @ nsp[n:]


class DenseLevel(NamedTuple):
    A: jax.Array        # (c, c) padded dense operator (identity on padding)
    active: jax.Array   # (c,) bool
    P: jax.Array        # (c_prev, c) prolongation from previous level
    labels: jax.Array   # (c,) component labels (original fine node ids)
    nsp: jax.Array      # (c,) bool
    Axi: jax.Array      # (c,)
    xx: jax.Array       # (c,)
    evecs: jax.Array    # (c, c) eigenvectors of A in the solve dtype
    #                     (coarsest level only; (0, 0) elsewhere) —
    #                     eigendecomposed ONCE at setup so each coarse
    #                     visit is two tiny GEMVs.
    einv: jax.Array     # (c,) *filtered* inverse eigenvalues:
    #                     1/lambda_i where lambda_i > 4 eps(solve dtype) *
    #                     lambda_max, else 0.  The coarsest operator carries
    #                     near-kernel eigenvalues ~bk1; an EXACT solve maps
    #                     the solve-dtype roundoff in the restricted
    #                     residual to O(eps/bk1)-sized noise along those
    #                     eigenvectors — residual-invisible (residual
    #                     contribution ~ bk1 * noise) but catastrophic for
    #                     the Newton step.  The reference's per-visit
    #                     Jacobi-PCG (``MG_Vcycle.m:43``) never resolves
    #                     eigendirections below its stagnation floor, which
    #                     is what makes it stable; the spectral cutoff is
    #                     the deterministic equivalent, at two GEMVs/visit.


class CSRLevel(NamedTuple):
    """Sparse fine level for the generic hierarchy: the solve-phase hot
    loop (matvecs + Jacobi sweeps, executed every cycle) runs on the ELL
    container — a gather + row-sum that moves O(nnz) instead of O(N^2)
    HBM traffic — while setup (strength/MIS/Galerkin, executed once)
    densifies.  This is the sparse layer's product consumer: past the
    crossover where the fine operator no longer pays for dense storage,
    :func:`setup_hierarchy_generic` accepts a CSR and keeps level 0
    sparse."""

    ell_cols: jax.Array  # (N, row_cap) int32 padded column indices
    ell_vals: jax.Array  # (N, row_cap) padded values
    dg: jax.Array        # (N,) diagonal of A
    labels: jax.Array    # (N,) component labels
    nsp: jax.Array       # (N,) near-singular mask
    Axi: jax.Array       # (N,)
    xx: jax.Array        # (N,)


@jax.tree_util.register_pytree_node_class
class HaloCSRLevel:
    """Row-sharded sparse fine level: a :class:`CSRLevel` whose matvec
    runs the halo-exchange distributed SpMV (``otamg/dist/spmv.py::
    spmv_halo`` — bidirectional ``ppermute`` ring, interior compute
    overlapped with the halo transfer).  The production consumer of the
    halo path: banded operators at ``N >~ 1e5`` where replicating the
    vector (the all_gather scheme) wastes interconnect bandwidth the band
    structure doesn't need.

    Static aux: ``(mesh, halo)`` — the mesh is topology, not data."""

    __slots__ = ("ell_cols", "ell_vals", "dg", "labels", "nsp", "Axi",
                 "xx", "mesh", "halo")

    def __init__(self, ell_cols, ell_vals, dg, labels, nsp, Axi, xx,
                 mesh, halo: int):
        self.ell_cols, self.ell_vals, self.dg = ell_cols, ell_vals, dg
        self.labels, self.nsp, self.Axi, self.xx = labels, nsp, Axi, xx
        self.mesh, self.halo = mesh, halo

    def tree_flatten(self):
        return ((self.ell_cols, self.ell_vals, self.dg, self.labels,
                 self.nsp, self.Axi, self.xx), (self.mesh, self.halo))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def halo_csr_matvec(lv: HaloCSRLevel, v: jax.Array) -> jax.Array:
    from otamg.dist.spmv import spmv_halo

    return spmv_halo(lv.mesh, lv.ell_cols, lv.ell_vals, v, lv.halo)


@jax.tree_util.register_pytree_node_class
class AggCSRLevel:
    """Intermediate SPARSE level produced by consecutive-block
    aggregation (:func:`setup_hierarchy_sparse`): same array fields as
    :class:`CSRLevel` plus the static aggregation factor ``agg`` of the
    transfer from its PARENT — restriction is a ``reshape(-1,
    agg).sum(1)`` and prolongation a ``repeat``, so no interpolation
    matrix is ever materialized at large N."""

    __slots__ = ("ell_cols", "ell_vals", "dg", "labels", "nsp", "Axi",
                 "xx", "agg")

    def __init__(self, ell_cols, ell_vals, dg, labels, nsp, Axi, xx,
                 agg: int):
        self.ell_cols, self.ell_vals, self.dg = ell_cols, ell_vals, dg
        self.labels, self.nsp, self.Axi, self.xx = labels, nsp, Axi, xx
        self.agg = agg

    def tree_flatten(self):
        return ((self.ell_cols, self.ell_vals, self.dg, self.labels,
                 self.nsp, self.Axi, self.xx), (self.agg,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


Hierarchy = tuple  # (BipartiteLevel | DenseLevel | CSRLevel, tuple[...])


def _lvl_size(lv) -> int:
    """Node count of a level object of any type."""
    if isinstance(lv, BipartiteLevel):
        return lv.g.shape[0]
    if isinstance(lv, (CSRLevel, HaloCSRLevel, AggCSRLevel)):
        return lv.dg.shape[0]
    return lv.A.shape[0]


# ---------------------------------------------------------------------------
# Level operations
# ---------------------------------------------------------------------------


def csr_matvec(lv: CSRLevel, v: jax.Array) -> jax.Array:
    from otamg.sparse.kernels import ell_spmv

    return ell_spmv(lv.ell_cols, lv.ell_vals, v)


def csr_smooth_apply(lv: CSRLevel, r: jax.Array,
                     transpose: bool) -> jax.Array:
    """Weighted Jacobi, as :func:`dense_smooth_apply`."""
    del transpose
    return 0.5 * r / lv.dg


def _level0_ops(lv):
    """(matvec, smooth_apply) pair for a level object of any type (the
    name is historical — sparse levels can now appear at any depth)."""
    if isinstance(lv, BipartiteLevel):
        return bip_matvec, bip_smooth_apply
    if isinstance(lv, HaloCSRLevel):
        return halo_csr_matvec, csr_smooth_apply
    if isinstance(lv, (CSRLevel, AggCSRLevel)):
        return csr_matvec, csr_smooth_apply
    return dense_matvec, dense_smooth_apply


def bip_matvec(lv: BipartiteLevel, v: jax.Array) -> jax.Array:
    n = lv.W.shape[0]
    v1, v2 = v[:n], v[n:]
    out1 = lv.g[:n] * v1 - lv.inv_tk * _mm(lv.E.T, v2)
    out2 = lv.g[n:] * v2 - lv.inv_tk * _mm(lv.E, v1)
    return jnp.concatenate([out1, out2])


def bip_smooth_apply(lv: BipartiteLevel, r: jax.Array,
                     transpose: bool) -> jax.Array:
    """Block Gauss-Seidel ``R^{-1}`` (or its transpose) for the bigraph
    split (``Class_AMG.m:48-59``): with ``V = diag(g1)``, ``U = -E^T/tk``,
    ``T = diag(g2)``, ``R^{-1} = [[V^{-1}, 0], [-T^{-1} U^T V^{-1},
    T^{-1}]]``."""
    n = lv.W.shape[0]
    r1, r2 = r[:n], r[n:]
    g1, g2 = lv.g[:n], lv.g[n:]
    if not transpose:
        e1 = r1 / g1
        e2 = (r2 + lv.inv_tk * _mm(lv.E, e1)) / g2
    else:
        e2 = r2 / g2
        e1 = (r1 + lv.inv_tk * _mm(lv.E.T, e2)) / g1
    return jnp.concatenate([e1, e2])


def dense_matvec(lv: DenseLevel, v: jax.Array) -> jax.Array:
    return _mm(lv.A, v)


def dense_smooth_apply(lv: DenseLevel, r: jax.Array,
                       transpose: bool) -> jax.Array:
    """Weighted Jacobi ``R^{-1} = 0.5 diag(A)^{-1}`` (``Class_AMG.m:72,84``;
    symmetric, so the transpose is identical)."""
    del transpose
    return 0.5 * r / jnp.diag(lv.A)


def _projected_smooth(matvec, smooth_apply, lv, e, r, smoth_it: int,
                      transpose: bool, nseg: int, deflated: bool = False):
    """``smoth_it`` sweeps of (per-component kernel-projected) smoothing.

    Generalizes ``MG_Vcycle.m:14-24``: on each sweep the residual's mean
    over every near-singular component is corrected exactly along the
    component's constant vector, via segment sums keyed on component
    labels; components that are not near-singular get a zero coefficient,
    reducing to the plain sweep ``e += R (r - A e)``.

    ``deflated=True`` (the mixed-precision correction solves): instead of
    SOLVING the kernel coordinate, project it OUT after every sweep.  At
    the solve dtype the Galerkin coarse matrices carry roundoff
    ~eps*|A| in their actual kernel-mode curvature, which at small bk1
    dwarfs the true curvature bk1*xi'Qxi — the 1-D kernel Newton step
    then uses a wrong (even wrong-signed) curvature and the kernel
    coordinate AMPLIFIES ~30x per cycle.  The surrounding f64 (a, w)
    algebra (``build_he_solver``) handles that coordinate exactly, so the
    cycle must simply keep its iterates kernel-free.
    """
    xi = lv.nsp.astype(r.dtype)  # project only on near-singular components

    if deflated:
        cnt = jax.ops.segment_sum(xi, lv.labels, num_segments=nseg)
        safe_cnt = jnp.where(cnt > 0, cnt, 1.0)

        def sweep(_, e):
            g = r - matvec(lv, e)
            e = e + smooth_apply(lv, g, transpose)
            mean = jax.ops.segment_sum(e * xi, lv.labels,
                                       num_segments=nseg) / safe_cnt
            return e - xi * jnp.where(lv.nsp, mean[lv.labels], 0.0)

        return lax.fori_loop(0, smoth_it, sweep, e)

    safe_xx = jnp.where(jnp.abs(lv.xx) > 0, lv.xx, 1.0)

    def sweep(_, e):
        g = r - matvec(lv, e)
        xig = jax.ops.segment_sum(g * xi, lv.labels, num_segments=nseg)
        coef = jnp.where(lv.nsp, xig[lv.labels] / safe_xx, 0.0)
        ghat = xi * coef + smooth_apply(lv, g - lv.Axi * coef, transpose)
        return e + ghat

    return lax.fori_loop(0, smoth_it, sweep, e)


def _projected_smooth_bip(lv: BipartiteLevel, e, r, smoth_it: int,
                          transpose: bool, nseg: int,
                          deflated: bool, e_is_zero: bool):
    """Traffic-optimal fused form of :func:`_projected_smooth` for the
    bipartite fine level — the solver's hot loop (``MG_Wcycle.m:16-23``
    at level 1).

    The generic sweep reads ``E`` three times: the residual's matvec
    needs both ``E^T e2`` and ``E e1``, and the block-GS apply one more
    directed product.  Here the edge products ``u = E e1`` / ``w = E^T
    e2`` are CARRIED across sweeps and updated incrementally from the
    sweep's own corrections — the residual then costs no ``E`` reads at
    all, and each sweep performs exactly the two directed products its
    Gauss-Seidel data dependency forces (``E d1`` cannot start before
    ``E^T e2`` is known): the structural floor of 2 reads/sweep.  The
    projection-term updates ride the precomputed ``Exi1``/``Etxi2``
    (component coefficients are scalars per component, and ``E`` has no
    edges across components).  Math identical to the generic path;
    float-level rounding differs only in the order of the carried sums.

    ``e_is_zero`` marks the pre-smoothing entry (the cycle zeroes the
    level): the carried products start at exactly zero instead of two
    warm-up reads.
    """
    n = lv.W.shape[0]
    m = lv.E.shape[0]
    dtype = r.dtype
    itk = lv.inv_tk
    g1d, g2d = lv.g[:n], lv.g[n:]
    r1, r2 = r[:n], r[n:]
    lab1, lab2 = lv.labels[:n], lv.labels[n:]
    nsp1, nsp2 = lv.nsp[:n], lv.nsp[n:]
    xi1 = nsp1.astype(dtype)
    xi2 = nsp2.astype(dtype)
    if e_is_zero:
        e1 = jnp.zeros(n, dtype)
        e2 = jnp.zeros(m, dtype)
        u = jnp.zeros(m, dtype)
        w = jnp.zeros(n, dtype)
    else:
        e1, e2 = e[:n], e[n:]
        u = _mm(lv.E, e1)
        w = _mm(lv.E.T, e2)

    if deflated:
        cnt = (jax.ops.segment_sum(xi1, lab1, num_segments=nseg)
               + jax.ops.segment_sum(xi2, lab2, num_segments=nseg))
        safe_cnt = jnp.where(cnt > 0, cnt, 1.0)

        def sweep(_, c):
            e1, e2, u, w = c
            gg1 = r1 - g1d * e1 + itk * w
            gg2 = r2 - g2d * e2 + itk * u
            if not transpose:
                d1 = gg1 / g1d
                t = _mm(lv.E, d1)
                d2 = (gg2 + itk * t) / g2d
                tw = _mm(lv.E.T, d2)
            else:
                d2 = gg2 / g2d
                tw = _mm(lv.E.T, d2)
                d1 = (gg1 + itk * tw) / g1d
                t = _mm(lv.E, d1)
            e1m, e2m = e1 + d1, e2 + d2
            mean = (jax.ops.segment_sum(e1m * xi1, lab1, num_segments=nseg)
                    + jax.ops.segment_sum(e2m * xi2, lab2,
                                          num_segments=nseg)) / safe_cnt
            m1 = jnp.where(nsp1, mean[lab1], 0.0)
            m2 = jnp.where(nsp2, mean[lab2], 0.0)
            return (e1m - xi1 * m1, e2m - xi2 * m2,
                    u + t - m2 * lv.Exi1, w + tw - m1 * lv.Etxi2)

        e1, e2, _, _ = lax.fori_loop(0, smoth_it, sweep, (e1, e2, u, w))
        return jnp.concatenate([e1, e2])

    xx1, xx2 = lv.xx[:n], lv.xx[n:]
    sxx1 = jnp.where(jnp.abs(xx1) > 0, xx1, 1.0)
    sxx2 = jnp.where(jnp.abs(xx2) > 0, xx2, 1.0)
    Axi1, Axi2 = lv.Axi[:n], lv.Axi[n:]

    def sweep(_, c):
        e1, e2, u, w = c
        gg1 = r1 - g1d * e1 + itk * w
        gg2 = r2 - g2d * e2 + itk * u
        xig = (jax.ops.segment_sum(gg1 * xi1, lab1, num_segments=nseg)
               + jax.ops.segment_sum(gg2 * xi2, lab2, num_segments=nseg))
        c1 = jnp.where(nsp1, xig[lab1] / sxx1, 0.0)
        c2 = jnp.where(nsp2, xig[lab2] / sxx2, 0.0)
        gp1 = gg1 - Axi1 * c1
        gp2 = gg2 - Axi2 * c2
        if not transpose:
            d1 = gp1 / g1d
            t = _mm(lv.E, d1)
            d2 = (gp2 + itk * t) / g2d
            tw = _mm(lv.E.T, d2)
        else:
            d2 = gp2 / g2d
            tw = _mm(lv.E.T, d2)
            d1 = (gp1 + itk * tw) / g1d
            t = _mm(lv.E, d1)
        return (e1 + xi1 * c1 + d1, e2 + xi2 * c2 + d2,
                u + c2 * lv.Exi1 + t, w + c1 * lv.Etxi2 + tw)

    e1, e2, _, _ = lax.fori_loop(0, smoth_it, sweep, (e1, e2, u, w))
    return jnp.concatenate([e1, e2])


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _coarse_target(nfine: int) -> int:
    """Reference depth rule: coarsen until level size
    ``<= 1 + floor(N_fine^(1/3))`` (``Class_AMG.m:76``)."""
    return 1 + int(math.floor(nfine ** (1.0 / 3.0)))


def capacity_schedule(m: int, nfine: int, opts: AMGOptions) -> list[int]:
    """Static per-level capacities for the dense levels (level 2 is exactly
    the p-side size ``m``; deeper levels shrink by ``coarsen_ratio``)."""
    caps = [m]
    target = (opts.coarse_target if opts.coarse_target is not None
              else _coarse_target(nfine))
    while caps[-1] > target and len(caps) < opts.max_levels - 1:
        caps.append(int(math.ceil(opts.coarsen_ratio * caps[-1])))
    return caps


def _component_xx(matvec, lv_partial, active_f, labels, nseg):
    Axi = matvec(lv_partial, active_f)
    xx = jax.ops.segment_sum(active_f * Axi, labels, num_segments=nseg)
    return Axi, xx[labels]


def setup_hierarchy(E: jax.Array, g: jax.Array, inv_tk,
                    labels: jax.Array, nsp: jax.Array,
                    opts: AMGOptions, key: jax.Array,
                    gk: jax.Array | None = None) -> Hierarchy:
    """Build the full hierarchy for ``Ae = diag(g) - E/tk``.

    ``labels``/``nsp`` come from the hybrid layer's component analysis.
    Mirrors the setup phase of ``Class_AMG.m:41-85`` with the level-1
    bigraph ideal interpolation of ``transfer.m:19-25`` and MIS/standard
    interpolation (effective ``W1 + 0.5 W2`` — see ``transfer.m:49-56``'s
    always-true guard) on coarser levels.

    ``gk`` is the NON-Laplacian part of the diagonal, ``bk1 Q + K/tk``,
    which equals ``Ae @ xi`` exactly on every component indicator ``xi``
    (the Laplacian part annihilates per-component constants).  The
    kernel-projection quantities ``Axi``/``xx`` are built from it
    analytically: evaluating ``Ae @ 1`` by matvec instead subtracts two
    nearly-equal ~|g|-sized quantities, and once ``bk1 |Q| < eps |g|``
    (late outer iterations in fp32) the result is pure cancellation noise
    with the wrong sign — the projected smoother then ADDS kernel error
    and the whole cycle diverges.  Without ``gk`` (generic callers) the
    matvec fallback is used.
    """
    m, n = E.shape
    N = n + m
    dtype = E.dtype
    nseg = N

    # --- level 1: ideal interpolation W = -Aff^{-1} Afc = diag(1/g1) E^T/tk
    g1 = g[:n]
    W = (E.T / g1[:, None]) * inv_tk
    # isnsp row-normalization (transfer.m:22-24), per near-singular node;
    # relative guard as in _coarsen_dense (healthy rows sum to ~1).
    rowsum = jnp.sum(W, axis=1)
    norm_mask = jnp.logical_and(nsp[:n], jnp.abs(rowsum) > 0.01)
    W = jnp.where(norm_mask[:, None],
                  W / jnp.where(norm_mask, rowsum, 1.0)[:, None], W)
    # Kernel-projection validity (see _interp_defect): the analytic
    # Axi/xx propagation to the dense levels assumes P maps coarse
    # component indicators to fine ones, i.e. every nsp q-row whose
    # component persists on the p-side sums to 1 after normalization.
    pcount = jax.ops.segment_sum(jnp.ones(m, jnp.int32), labels[n:],
                                 num_segments=nseg)
    persists = pcount[labels[:n]] > 0
    relevant = jnp.logical_and(nsp[:n], persists)
    rowsum1 = jnp.sum(W, axis=1)
    defect1 = jnp.max(jnp.where(relevant, jnp.abs(rowsum1 - 1.0), 0.0))
    ok = defect1 < 0.1

    # Fused-smoother projection products: E @ xi and E^T @ xi for the
    # near-singular indicator xi = nsp.  Nonnegative sums — exact, no
    # cancellation (unlike Ae @ 1, see the ``gk`` note below) — computed
    # once per hierarchy (two E reads, amortized over every sweep).
    xi1 = nsp[:n].astype(dtype)
    xi2 = nsp[n:].astype(dtype)
    Exi1 = _mm(E, xi1)
    Etxi2 = _mm(E.T, xi2)
    lv1_partial = BipartiteLevel(E, g, jnp.asarray(inv_tk, dtype), W,
                                 labels, nsp,
                                 jnp.zeros(N, dtype), jnp.ones(N, dtype),
                                 Exi1, Etxi2)
    if gk is None:
        ones_fine = jnp.ones(N, dtype)
        Axi1 = bip_matvec(lv1_partial, ones_fine)
        xxseg = jax.ops.segment_sum(Axi1, labels, num_segments=nseg)
        axi2 = None
    else:
        Axi1 = gk.astype(dtype)
        xxseg = jax.ops.segment_sum(Axi1, labels, num_segments=nseg)
        # Exact restriction of Axi through P = [W; I]: nonnegative GEMV,
        # no cancellation.
        axi2 = _mm(W.T, Axi1[:n]) + Axi1[n:]
    lv1 = lv1_partial._replace(Axi=Axi1, xx=xxseg[labels])

    # --- level 2: Galerkin P^T Ae P with P = [W; I]  (m x m dense)
    G1W = g1[:, None] * W
    A2 = _mm(W.T, G1W) - inv_tk * _mm(W.T, E.T) - inv_tk * _mm(E, W) \
        + jnp.diag(g[n:])
    A2 = 0.5 * (A2 + A2.T)
    active2 = jnp.ones(m, bool)
    labels2 = labels[n:]
    nsp2 = nsp[n:]

    caps = capacity_schedule(m, N, opts)
    dense_levels = _build_dense_chain(A2, active2, labels2, nsp2, caps,
                                      opts, key, nseg,
                                      axi0=axi2, xxseg=xxseg, ok0=ok)
    return lv1, dense_levels


def _build_dense_chain(A0, act0, lab0, nsp0, caps, opts: AMGOptions,
                       key: jax.Array, nseg: int,
                       axi0=None, xxseg=None, ok0=True) -> tuple:
    """Build the chain of padded dense levels (MIS coarsening) starting
    from ``A0`` at capacity ``caps[0]``, ending with the eigendecomposed
    coarsest level.

    With ``axi0``/``xxseg`` given, the kernel-projection quantities are
    propagated analytically — ``Axi_{l+1} = P^T Axi_l`` (exact on the
    normalized nsp rows, the only ones the projection uses) and ``xx``
    is level-invariant per component — instead of re-evaluated by matvec,
    which cancels catastrophically once ``bk1`` is below the solve-dtype
    roundoff of the level diagonal (see :func:`setup_hierarchy`).

    ``ok0`` and the per-level interpolation defects gate the projection:
    when a prolongation fails ``P 1_c = 1_f`` on a persisting
    near-singular component (e.g. the MIS bail-out picked a handful of
    random C points on a weakly-connected level and most F rows have no
    strong C neighbor to normalize through), the coarse indicator is NOT
    a near-kernel vector of the Galerkin operator — the analytic Axi/xx
    are then wrong and the additive projection term in
    :func:`_projected_smooth` AMPLIFIES the error (observed: x4600 per
    sweep, NaN within one W-cycle at 2048^2).  The mask cascades: once a
    level's interpolation breaks the invariant, that level and everything
    below run plain (unprojected) smoothing, which is always contractive.
    """
    dtype = A0.dtype
    dense_levels = []
    A_cur, act_cur, lab_cur, nsp_cur = A0, act0, lab0, nsp0
    ok_cur = jnp.asarray(ok0, bool)
    axi_cur = axi0
    P_cur = jnp.zeros((0, 0), dtype)  # unused for the chain head
    no_vec = jnp.zeros((0, 0), dtype)
    no_val = jnp.zeros((0,), dtype)

    for li, cap in enumerate(caps):
        last = li == len(caps) - 1
        # Coarsest-grid factorization, computed ONCE per hierarchy: the
        # reference re-solves the coarsest system by Jacobi-PCG on every
        # cycle visit (``MG_Vcycle.m:43``; its direct solve is commented at
        # ``:44``) — a W-cycle visits the coarsest level 2^(levels-2) times
        # per cycle, so we eigendecompose here (the matrix is small, so
        # this is negligible) and each visit applies the
        # spectrally-filtered inverse (see the DenseLevel.einv doc for why
        # exact inversion is unstable at the solve dtype).  Padding rows
        # carry an identity diagonal.
        if last:
            # Eigendecompose in the SOLVE dtype: the spectral filter below
            # truncates everything under ~256 ulps of lambda_max, so the
            # retained spectrum has condition <= ~1/(256 eps) — well
            # within the dtype's factorization range, and the deflated
            # cycle handles the truncated directions elsewhere.  (An f64
            # factor was only needed by the earlier exact-solve design.)
            lam, evecs = jnp.linalg.eigh(A_cur)
            # Truncation margin: the restricted residual reaching the
            # coarsest level carries a few-to-tens of ulps of solve-dtype
            # matmul noise per restriction hop, so the low-precision
            # cutoff needs real headroom above eps — at 4 eps the fp32
            # cycle can diverge in the small-bk1 regime, depending on the
            # device's fp32 summation order.  f64 stays at 4 eps (never
            # binds in practice).
            factor = 4.0 if dtype == jnp.float64 else float(
                opts.coarse_cutoff_ulps)
            cutoff = factor * jnp.finfo(dtype).eps * jnp.max(jnp.abs(lam))
            einv = jnp.where(lam > cutoff, 1.0 / jnp.where(lam > cutoff,
                                                           lam, 1.0), 0.0)
        else:
            evecs, einv = no_vec, no_val
        lvd_partial = DenseLevel(A_cur, act_cur, P_cur, lab_cur, nsp_cur,
                                 jnp.zeros(cap, dtype), jnp.ones(cap, dtype),
                                 evecs, einv)
        nsp_eff = jnp.logical_and(nsp_cur, ok_cur)
        lvd_partial = lvd_partial._replace(nsp=nsp_eff)
        if axi_cur is None:
            xi = act_cur.astype(dtype)
            Axi = dense_matvec(lvd_partial, xi)
            xx = jax.ops.segment_sum(xi * Axi, lab_cur, num_segments=nseg)
            lvd = lvd_partial._replace(Axi=Axi, xx=xx[lab_cur])
        else:
            lvd = lvd_partial._replace(Axi=axi_cur, xx=xxseg[lab_cur])
        dense_levels.append(lvd)
        if last:
            break
        cap_next = caps[li + 1]
        key, sub = jax.random.split(key)
        (A_cur, act_cur, lab_cur, nsp_cur, P_cur, defect) = _coarsen_dense(
            A_cur, act_cur, lab_cur, nsp_cur, cap_next, opts, sub, nseg)
        ok_cur = jnp.logical_and(ok_cur, defect < 0.1)
        if axi_cur is not None:
            axi_cur = _mm(P_cur.T, axi_cur)

    return tuple(dense_levels)


def setup_hierarchy_generic(A, opts: AMGOptions,
                            key: jax.Array,
                            labels: jax.Array | None = None,
                            nsp: jax.Array | None = None,
                            dist: tuple | None = None) -> Hierarchy:
    """Generic (non-bigph) hierarchy for an arbitrary SPD matrix:
    weighted-Jacobi fine-level smoothing and MIS/standard-interpolation
    coarsening from level 1 down (the reference's ``bigph=0`` path,
    ``Class_AMG.m:72`` + ``transfer.m:30-66``).

    ``A`` may be a dense ``(N, N)`` array or a
    :class:`otamg.sparse.CSR`.  With a CSR input the one-time setup
    densifies (strength/MIS/Galerkin are GEMM-shaped), but level 0 of the
    returned hierarchy stays sparse — every solve-phase fine matvec and
    smoothing sweep runs on the ELL container, O(nnz) HBM traffic instead
    of O(N^2).

    Returns ``(chain[0], chain[1:])`` so :func:`amg_solve` accepts it
    directly — the cycle dispatches on the level type, not the level
    index.
    """
    from otamg.sparse.containers import CSR

    csr = A if isinstance(A, CSR) else None
    if csr is not None:
        A = csr.to_dense()
    N = A.shape[0]
    if labels is None:
        labels = jnp.zeros(N, jnp.int32)
    if nsp is None:
        nsp = jnp.zeros(N, bool)
    caps = [N]
    target = (opts.coarse_target if opts.coarse_target is not None
              else _coarse_target(N))
    while caps[-1] > target and len(caps) < opts.max_levels:
        caps.append(int(math.ceil(opts.coarsen_ratio * caps[-1])))
    chain = _build_dense_chain(A, jnp.ones(N, bool), labels, nsp, caps,
                               opts, key, N)
    head = chain[0]
    if csr is not None and len(chain) > 1:
        head = CSRLevel(csr.ell_cols, csr.ell_vals, jnp.diag(head.A),
                        head.labels, head.nsp, head.Axi, head.xx)
        if dist is not None:
            # Row-shard the fine level over the mesh; every solve-phase
            # fine matvec becomes the halo-exchange distributed SpMV.
            mesh, halo = dist
            head = _shard_halo_level(head, mesh, halo)
    return head, chain[1:]


def _shard_halo_level(head, mesh, halo: int):
    """Row-shard a :class:`CSRLevel` head over ``mesh`` as a
    :class:`HaloCSRLevel`, validating :func:`otamg.dist.spmv.spmv_halo`'s
    bandwidth contract EAGERLY: every stored (nonzero-valued) column of
    shard ``s`` must lie in ``[s*R - halo, (s+1)*R + halo)``.  The
    solve-phase SpMV clamps column indices purely to guard the gather —
    a too-small halo would otherwise silently evaluate a clamped
    operator A' and converge amg_solve to the wrong system's solution
    (round-5 review), so an out-of-window column is a loud setup error
    here instead.  Zero-valued padding slots (col 0) are exempt: they
    contribute nothing through the clamp."""
    from jax.sharding import NamedSharding, PartitionSpec

    ndev = mesh.devices.size
    N = head.ell_cols.shape[0]
    if N % ndev != 0:
        raise ValueError(f"halo fine level: {N} rows do not divide the "
                         f"{ndev}-device mesh")
    R = N // ndev
    if halo > R:
        raise ValueError(f"halo={halo} wider than the {R}-row shard block")
    shard = jnp.arange(N, dtype=head.ell_cols.dtype) // R
    lo = (shard * R - halo)[:, None]
    hi = ((shard + 1) * R + halo)[:, None]
    bad = jnp.logical_and(head.ell_vals != 0,
                          jnp.logical_or(head.ell_cols < lo,
                                         head.ell_cols >= hi))
    if bool(jnp.any(bad)):
        need = int(jnp.max(jnp.where(
            bad, jnp.maximum(lo - head.ell_cols, head.ell_cols - hi + 1),
            0))) + halo
        raise ValueError(
            f"halo={halo} violates the banded SpMV contract: "
            f"{int(jnp.sum(bad))} stored entries fall outside their "
            f"shard's column window (need halo >= {need}); spmv_halo "
            f"would silently evaluate a clamped operator")
    row = NamedSharding(mesh, PartitionSpec("x", None))
    vec = NamedSharding(mesh, PartitionSpec("x"))
    return HaloCSRLevel(
        jax.device_put(head.ell_cols, row),
        jax.device_put(head.ell_vals, row),
        jax.device_put(head.dg, vec),
        jax.device_put(head.labels, vec),
        jax.device_put(head.nsp, vec),
        jax.device_put(head.Axi, vec),
        jax.device_put(head.xx, vec), mesh, halo)


def _agg_galerkin_ell(cols, vals, k: int, out_cap: int):
    """Galerkin product for unit consecutive-block aggregation on ELL:
    with ``P[i, i//k] = 1``, every fine entry ``(i, j, v)`` maps to the
    coarse entry ``(i//k, j//k, v)`` — rows grouped ``k``-at-a-time,
    columns integer-divided, duplicates merged.  Pure reshapes/gathers;
    no interpolation matrix is materialized."""
    from otamg.dist.assembly import ell_row_sum_duplicates

    N, rc = cols.shape
    Nc = -(-N // k)
    pad = Nc * k - N
    if pad:
        cols = jnp.concatenate(
            [cols, jnp.zeros((pad, rc), cols.dtype)])
        vals = jnp.concatenate(
            [vals, jnp.zeros((pad, rc), vals.dtype)])
    gc = (cols // k).astype(cols.dtype).reshape(Nc, k * rc)
    gv = vals.reshape(Nc, k * rc)
    out_c, out_v, ngmax = ell_row_sum_duplicates(gc, gv, out_cap)
    return out_c, out_v, ngmax, Nc


def setup_hierarchy_sparse(csr, opts: AMGOptions, key: jax.Array,
                           agg: int = 2, dense_crossover: int = 1024,
                           dist: tuple | None = None) -> Hierarchy:
    """Sparse-setup hierarchy for LARGE SPD operators (``N >~ 1e5``)
    where the generic path's setup-time densification
    (:func:`setup_hierarchy_generic`) no longer fits memory.

    Coarsening above ``dense_crossover`` uses unit consecutive-block
    aggregation (factor ``agg``): the Galerkin product is an ELL
    reshape+merge (:func:`_agg_galerkin_ell`), restriction a block
    row-sum and prolongation a repeat — O(nnz) setup, no MIS and no
    interpolation matrices.  At/below the crossover the operator is
    densified and the reference MIS/standard-interpolation chain
    (``transfer.m:41-66``) takes over, ending in the eigensolved coarse
    level.  Intended for Laplacian-like banded operators with a trivial
    near-kernel (labels/nsp are not tracked through the aggregation
    levels); the OT product path keeps its dense reference-faithful
    setup.

    ``dist=(mesh, halo)`` row-shards the FINE level so every fine
    matvec runs the halo-exchange SpMV (:class:`HaloCSRLevel`).
    """
    cols, vals = csr.ell_cols, csr.ell_vals
    N = cols.shape[0]
    dtype = vals.dtype

    def diag_of(c, v, n):
        return jnp.sum(v * (c == jnp.arange(n, dtype=c.dtype)[:, None]),
                       axis=1)

    def mk_sparse_level(c, v, n, k):
        z = jnp.zeros(n, jnp.int32)
        f = jnp.zeros(n, bool)
        one = jnp.ones(n, dtype)
        dg = diag_of(c, v, n)
        if k is None:
            return CSRLevel(c, v, dg, z, f, one, one)
        return AggCSRLevel(c, v, dg, z, f, one, one, k)

    head = mk_sparse_level(cols, vals, N, None)
    if dist is not None:
        mesh, halo = dist
        head = _shard_halo_level(head, mesh, halo)

    chain: list = []
    c, v, n = cols, vals, N
    while n > dense_crossover:
        out_cap = c.shape[1] + 2
        c, v, ngmax, n = _agg_galerkin_ell(c, v, agg, out_cap)
        if int(ngmax) > out_cap:
            raise ValueError(
                f"aggregation Galerkin overflow: {int(ngmax)} distinct "
                f"coarse columns > capacity {out_cap} (operator not "
                f"banded enough for the sparse path)")
        if n > dense_crossover:
            chain.append(mk_sparse_level(c, v, n, agg))

    # Densify the crossover operator and hand over to the reference
    # MIS/standard-interpolation dense chain.
    rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None],
                            c.shape)
    Ad = jnp.zeros((n, n), dtype).at[rows, c].add(v)
    caps = [n]
    target = (opts.coarse_target if opts.coarse_target is not None
              else _coarse_target(N))
    while caps[-1] > target and len(caps) < opts.max_levels:
        caps.append(int(math.ceil(opts.coarsen_ratio * caps[-1])))
    dchain = list(_build_dense_chain(Ad, jnp.ones(n, bool),
                                     jnp.zeros(n, jnp.int32),
                                     jnp.zeros(n, bool), caps, opts,
                                     key, n))
    # The dense head's transfer from the last sparse level is the unit
    # aggregation matrix, materialized (small: <= agg*crossover rows);
    # identity when no aggregation happened (N already at crossover).
    nf_prev = _lvl_size(chain[-1]) if chain else N
    P_agg = (jnp.eye(n, dtype=dtype) if nf_prev == n
             else jnp.repeat(jnp.eye(n, dtype=dtype), agg,
                             axis=0)[:nf_prev])
    dchain[0] = dchain[0]._replace(P=P_agg)
    return head, tuple(chain) + tuple(dchain)


def _coarsen_dense(A, active, labels, nsp, cap_next: int,
                   opts: AMGOptions, key: jax.Array, nseg: int):
    """One MIS + standard-interpolation + Galerkin coarsening step
    (``transfer.m:41-66``) on a padded dense level.

    Also returns the interpolation DEFECT: the worst deviation of a
    near-singular F row's weight sum from 1, over rows whose component
    keeps at least one C node (the ``P 1_c = 1_f`` invariant the
    kernel-projection machinery relies on — see
    :func:`_build_dense_chain`)."""
    c = A.shape[0]
    dtype = A.dtype
    Sval = strength_dense(A, active)
    As = Sval >= opts.theta
    isC, isF = mis_dense(As, active, key)

    dinv = 1.0 / jnp.diag(A)
    fc_mask = jnp.logical_and(isF[:, None], isC[None, :])
    # Compaction geometry (depends only on the C/F split, not on the
    # interpolation weights): C columns in index order, overflow beyond
    # the static capacity demoted (rare — MIS targets N/2).
    perm = jnp.argsort(jnp.logical_not(isC), stable=True)
    colidx = perm[:cap_next]
    numC = jnp.sum(isC)
    keep = jnp.arange(cap_next) < numC
    active_next = keep
    labels_next = labels[colidx]
    nsp_next = jnp.logical_and(nsp[colidx], active_next)
    kept_flag = jnp.zeros(c, bool).at[colidx].set(keep)
    ccount = jax.ops.segment_sum(kept_flag.astype(jnp.int32), labels,
                                 num_segments=nseg)
    relevant = jnp.logical_and(
        jnp.logical_and(active, nsp),
        jnp.logical_and(ccount[labels] > 0, jnp.logical_not(kept_flag)))

    def ideal_W(_):
        # Ideal interpolation W = -Aff^{-1} Afc on the F subsystem:
        # A-harmonic, so ``P 1_c = 1_f`` holds per component exactly —
        # immune to the MIS bail-out's missing strong C neighbors.
        ff = jnp.logical_and(isF[:, None], isF[None, :])
        Aff = jnp.where(ff, A, 0.0) + jnp.diag(
            jnp.logical_not(isF).astype(dtype))
        Afc = jnp.where(fc_mask, A, 0.0)
        W = -jnp.linalg.solve(Aff, Afc)
        return jnp.where(isF[:, None], W, 0.0) * isC[None, :]

    def standard_W(_):
        # Standard interpolation; the reference's always-true guard makes
        # the effective weight 0.5 regardless of `inter` (transfer.m:54-56).
        strong_ff = jnp.logical_and(
            As, jnp.logical_and(isF[:, None], isF[None, :]))
        AFFs = jnp.where(strong_ff, A, 0.0) + jnp.diag(
            jnp.where(isF, jnp.diag(A), 0.0))
        W1 = jnp.where(fc_mask, -A * dinv[:, None], 0.0)
        W2 = -dinv[:, None] * _mm(AFFs, W1)
        return W1 + 0.5 * W2

    def finish(W):
        """Normalization -> truncated P -> Galerkin -> defect."""
        # Near-null-space row normalization (transfer.m:60-62), per-node.
        # Guard is RELATIVE, not the reference's ~0 test: an F node whose
        # interpolation weights sum to ~0 (no strong C neighbor in its
        # component after an unlucky threshold flip) would have its row
        # divided by that tiny sum — an exploding prolongation turns the
        # whole cycle divergent (rho > 1).  Healthy rows sum to O(1);
        # only those are safe to normalize.
        rowsum = jnp.sum(W, axis=1)
        norm_mask = jnp.logical_and(jnp.logical_and(isF, nsp),
                                    jnp.abs(rowsum) > 0.01)
        W = jnp.where(norm_mask[:, None],
                      W / jnp.where(norm_mask, rowsum, 1.0)[:, None], W)
        P_full = W + jnp.diag(isC.astype(dtype))
        P = P_full[:, colidx] * keep[None, :].astype(dtype)
        Ac = _mm(P.T, _mm(A, P))
        Ac = 0.5 * (Ac + Ac.T)
        Ac = Ac + jnp.diag(jnp.logical_not(active_next).astype(dtype))
        # Interpolation defect, measured on the truncated P so capacity
        # demotion counts too: every active near-singular node that must
        # interpolate from the coarse grid (F node or demoted C node) in
        # a component that keeps at least one C node must have its P row
        # sum to 1, or P 1_c != 1_f and the projection invariant breaks.
        rowsum_p = jnp.sum(P, axis=1)
        defect = jnp.max(jnp.where(relevant, jnp.abs(rowsum_p - 1.0), 0.0))
        return Ac, P, defect

    if opts.inter >= 2:
        Ac, P, defect = finish(ideal_W(None))
    else:
        Ac, P, defect = finish(standard_W(None))
        # Defect REPAIR (round-4; no reference analogue — the reference
        # never ran where its MIS bail-out mattered): when the standard
        # interpolation breaks ``P 1_c = 1_f`` on a persisting
        # near-singular component (2048^2 active sets do this), rebuild
        # the level with IDEAL interpolation instead of disabling the
        # kernel projection from here down.  Below the threshold the
        # standard branch is taken unchanged, so small-problem
        # trajectories are bit-identical; at 2048^2 the repair turns an
        # unconverged (it=100, rel 7e-5) fp32 run into it=59.
        Ac, P, defect = lax.cond(
            defect >= 0.1,
            lambda _: finish(ideal_W(None)),
            lambda _: (Ac, P, defect), None)
    return Ac, active_next, labels_next, nsp_next, P, defect


# ---------------------------------------------------------------------------
# Cycles: static visit tape executed by scan + switch
# ---------------------------------------------------------------------------


def _gen_tape(num_levels: int, gamma: int) -> list[tuple[str, int]]:
    """Unroll the cycle recursion into a static (op, level) sequence.
    ``gamma``: 1 = V, 2 = W, 3 = F (W's revisit structure but the second
    child visit runs as a V-cycle — level l visited l+1 times, linear in
    depth, vs the W-cycle's 2^(l-1)).  Levels are 0 (bipartite) ..
    num_levels-1."""
    ops: list[tuple[str, int]] = []
    last = num_levels - 1

    def visit(l: int, g: int) -> None:
        if l == last:
            ops.append(("coarse", l))
            return
        ops.append(("pre", l))
        ops.append(("down", l))
        visit(l + 1, g)
        if g >= 2 and l + 1 != last:
            # warm-started revisit (MG_Wcycle.m:28-30); F demotes the
            # revisit (and everything under it) to a V-cycle.
            visit(l + 1, 1 if g == 3 else g)
        ops.append(("up", l))

    visit(0, gamma)
    return ops


def _coarse_solve(lv, r, nseg: int, deflated: bool, coarse_retol: float,
                  coarse_maxit: int, coarse_direct: bool):
    """Coarsest-level solve, shared by the full tape and the deep build.

    Default: spectrally-filtered direct solve via the setup-time
    eigendecomposition (two tiny GEMVs); eigendirections below the
    solve-dtype noise floor are truncated — the deterministic equivalent
    of the reference PCG's stagnation (see ``DenseLevel.einv``).
    Fallback: Jacobi-PCG with the reference PCG defaults
    (``MG_Vcycle.m:43``, ``PCG.m:18-27``)."""
    if coarse_direct and isinstance(lv, DenseLevel) \
            and lv.evecs.shape[0] > 0:
        rc = r.astype(lv.evecs.dtype)
        e_c = _mm(lv.evecs, lv.einv * _mm(lv.evecs.T, rc))
        if deflated:
            # Keep the coarse correction kernel-free too (the spectral
            # filter truncates most of it; this removes the rest exactly).
            xi_c = lv.nsp.astype(e_c.dtype)
            cntc = jax.ops.segment_sum(
                xi_c, lv.labels, num_segments=nseg)
            mean = jax.ops.segment_sum(
                e_c * xi_c, lv.labels, num_segments=nseg
            ) / jnp.where(cntc > 0, cntc, 1.0)
            e_c = e_c - xi_c * jnp.where(lv.nsp, mean[lv.labels], 0.0)
        return e_c.astype(r.dtype)
    if isinstance(lv, BipartiteLevel):
        dg = lv.g
        mv = lambda v: bip_matvec(lv, v)
    else:
        dg = jnp.diag(lv.A)
        mv = lambda v: dense_matvec(lv, v)
    res = pcg(mv, r, lambda v: v / dg,
              retol=coarse_retol, maxit=coarse_maxit)
    return res.x


def make_cycle(num_dense: int, smoth_it: int, gamma: int, nseg: int,
               coarse_retol: float = 1e-11, coarse_maxit: int = 10_000,
               coarse_direct: bool = True, deflated: bool = False):
    """Build ``cycle(lv1, dense_levels, r) -> e`` executing one V/W cycle.

    The tape is static; the scan body is a ``lax.switch`` over the
    distinct (op, level) pairs, so each op is traced exactly once.

    ``coarse_direct=True`` solves the coarsest level with the
    spectrally-filtered f64 eigendecomposition computed at setup (two tiny
    GEMVs per visit) instead of the reference's Jacobi-PCG
    (``MG_Vcycle.m:43``; the direct solve is its commented alternative
    ``:44``).  Trajectories agree to the PCG tolerance — and it removes a
    data-dependent 1e4-iteration inner while_loop from the hot cycle
    program.  See ``DenseLevel.einv`` for why the filter (not a plain
    exact solve) is required at low solve dtypes.

    **Fused deep correction** (round 5): the sub-tape below level 0 —
    everything between ``down(0)`` and ``up(0)``, including W/F revisits
    of level 1 — is a LINEAR map ``r1 -> e1`` (every op is a
    correction-form linear update).  ``cycle.build_deep(lv1, dense,
    dtype)`` materializes it ONCE per Newton solve as a ``(cap1, cap1)``
    matrix by vmapping the exact sub-tape over identity columns (the
    GEMVs batch into GEMMs); passing the result as ``deep_D`` replaces
    the whole op-count-bound deep tape of many tiny GEMVs with one GEMV
    per cycle.  Same linear algebra, different rounding
    order — trajectory pins are re-verified with the flag on.
    """
    num_levels = num_dense + 1
    tape = _gen_tape(num_levels, gamma)
    op_ids = sorted(set(tape))
    id_of = {op: i for i, op in enumerate(op_ids)}
    tape_codes = jnp.asarray([id_of[t] for t in tape], jnp.int32)
    # Deep sub-tape: tape is [pre(0), down(0), <deep...>, up(0)] whenever
    # there are >= 2 levels; fusing pays only with >= 2 dense levels
    # (otherwise the deep part is already a single coarse op).
    can_fuse = num_dense >= 2
    if can_fuse:
        assert tape[0] == ("pre", 0) and tape[1] == ("down", 0) \
            and tape[-1] == ("up", 0)
        # The deep tape gets its own op-id set: lax.switch traces EVERY
        # branch, and level-0 branches cannot trace against the dummy
        # level-0 slots of the deep carry.
        deep_op_ids = sorted(set(tape[2:-1]))
        deep_id_of = {op: i for i, op in enumerate(deep_op_ids)}
        deep_codes = jnp.asarray([deep_id_of[t] for t in tape[2:-1]],
                                 jnp.int32)

    def cycle(lv1: BipartiteLevel | DenseLevel,
              dense: Sequence[DenseLevel], r0: jax.Array,
              deep_D: jax.Array | None = None):
        n_plus_m = r0.shape[0]
        dtype = r0.dtype
        levels = [lv1] + list(dense)
        # Level 0 is the structured bipartite level (bigph, the product
        # path), a plain dense level (generic non-bigph hierarchy,
        # Class_AMG.m:72), or a CSR level (sparse fine operator past the
        # dense crossover); dispatch on the type, not the index.
        bip0 = isinstance(lv1, BipartiteLevel)
        mv0, sm0 = _level0_ops(lv1)

        def lvl_matvec(l, v):
            if l == 0:
                return mv0(levels[l], v)
            mv, _ = _level0_ops(levels[l])
            return mv(levels[l], v)

        def lvl_smooth(l, e, r, transpose, e_is_zero=False):
            if l == 0:
                if bip0 and not _NO_FUSED_SMOOTH:
                    # Fused 2-reads-per-sweep form (see
                    # _projected_smooth_bip); the pre-smooth entry always
                    # starts from a zeroed level.
                    return _projected_smooth_bip(levels[0], e, r, smoth_it,
                                                 transpose, nseg, deflated,
                                                 e_is_zero)
                return _projected_smooth(mv0, sm0, levels[l], e, r,
                                         smoth_it, transpose, nseg,
                                         deflated)
            mv, sm = _level0_ops(levels[l])
            return _projected_smooth(mv, sm, levels[l], e, r, smoth_it,
                                     transpose, nseg, deflated)

        def restrict(l, rr):
            # from level l to l+1
            if l == 0 and bip0:
                n = lv1.W.shape[0]
                return rr[n:] + _mm(lv1.W.T, rr[:n])
            child = levels[l + 1]
            if isinstance(child, AggCSRLevel):
                # Consecutive-block aggregation: P^T is a block row-sum.
                k, nc = child.agg, child.dg.shape[0]
                pad = nc * k - rr.shape[0]
                if pad:
                    rr = jnp.concatenate([rr, jnp.zeros(pad, rr.dtype)])
                return rr.reshape(nc, k).sum(axis=1)
            return _mm(child.P.T, rr)

        def prolong(l, ec):
            # from level l+1 back to l
            if l == 0 and bip0:
                return jnp.concatenate([_mm(lv1.W, ec), ec])
            child = levels[l + 1]
            if isinstance(child, AggCSRLevel):
                k = child.agg
                nf = _lvl_size(levels[l])
                return jnp.repeat(ec, k)[:nf]
            return _mm(child.P, ec)

        shapes = [n_plus_m] + [_lvl_size(lv) for lv in dense]
        e0 = tuple(jnp.zeros(s, dtype) for s in shapes)
        r_init = tuple(
            r0 if i == 0 else jnp.zeros(s, dtype)
            for i, s in enumerate(shapes))

        def make_branch(op):
            kind, l = op

            def branch(carry):
                es, rs = carry
                es, rs = list(es), list(rs)
                if kind == "pre":
                    # Level 0 is the tape root, visited exactly once per
                    # cycle with the freshly-zeroed e0 — the fused
                    # smoother can skip its two warm-up E matvecs.
                    # (Deeper levels' pre can be warm-started W revisits.)
                    es[l] = lvl_smooth(l, es[l], rs[l], False,
                                       e_is_zero=(l == 0))
                elif kind == "down":
                    rr = rs[l] - lvl_matvec(l, es[l])
                    rs[l + 1] = restrict(l, rr)
                    es[l + 1] = jnp.zeros_like(es[l + 1])
                elif kind == "up":
                    es[l] = es[l] + prolong(l, es[l + 1])
                    es[l] = lvl_smooth(l, es[l], rs[l], True)
                elif kind == "coarse":
                    es[l] = _coarse_solve(levels[l], rs[l], nseg, deflated,
                                          coarse_retol, coarse_maxit,
                                          coarse_direct).astype(dtype)
                return tuple(es), tuple(rs)

            return branch

        branches = [make_branch(op) for op in op_ids]

        def body(carry, code):
            carry = lax.switch(code, branches, carry)
            return carry, None

        if deep_D is not None:
            # Short path: the whole deep tape is the precomputed linear
            # map ``deep_D`` (math convention: e1 = deep_D @ r1).
            carry = branches[id_of[("pre", 0)]]((e0, r_init))
            carry = branches[id_of[("down", 0)]](carry)
            es, rs = list(carry[0]), list(carry[1])
            es[1] = _mm(deep_D, rs[1])
            carry = branches[id_of[("up", 0)]]((tuple(es), tuple(rs)))
            return carry[0][0]

        (es, _), _ = lax.scan(body, (e0, r_init), tape_codes)
        return es[0]

    def _deep_algebraic(dense: Sequence[DenseLevel], dtype):
        """Bottom-up algebraic build of the deep matrix ``D`` (math
        convention: ``e1 = D @ r1``) from per-level closed forms — pure
        GEMMs, no scatters and no scanned tape.

        Every deep-tape op has a dense matrix form: the (projected)
        Jacobi sweep is ``e' = G1 e + B1 r`` with the kernel projections
        expressed through label-equality masks (``eq_ij = [lab_i =
        lab_j]``), a smoothing phase is the ``smoth_it``-fold composite,
        a visit is the classic two-grid composition ``C = Gp (Hp +
        P D_next P^T (I - A Hp)) + Hp``, the warm-started W/F revisit is
        ``D = C + C' (I - A C)``, and the coarse solve is
        ``evecs diag(einv) evecs^T`` (+ deflation projector).  Exact
        arithmetic matches the tape op-for-op; rounding differs (pins
        re-verified).  Replaces the vmapped-tape build, whose batched
        segment-sum scatters were pure overhead."""
        phase_cache: dict = {}
        node_cache: dict = {}

        def proj_parts(lv, cap):
            xi = lv.nsp.astype(dtype)
            eq = (lv.labels[:, None] == lv.labels[None, :]).astype(dtype)
            return xi, eq * xi[None, :]

        def phase_ops(idx):
            if idx in phase_cache:
                return phase_cache[idx]
            lv = dense[idx]
            A = lv.A.astype(dtype)
            cap = A.shape[0]
            I = jnp.eye(cap, dtype=dtype)
            K = 0.5 / jnp.diag(A)
            xi, xmat = proj_parts(lv, cap)
            if deflated:
                cnt = jnp.sum(xmat, axis=1)  # = cnt[labels], gathered
                safe = jnp.where(cnt > 0, cnt, 1.0)
                Pm = (xi / safe)[:, None] * xmat
                IKA = I - K[:, None] * A
                G1 = IKA - _mm(Pm, IKA)          # Q (I - K A)
                B1 = jnp.diag(K) - Pm * K[None, :]  # Q diag(K)
            else:
                safe_xx = jnp.where(jnp.abs(lv.xx) > 0, lv.xx,
                                    1.0).astype(dtype)
                Wm = (xi / safe_xx)[:, None] * xmat
                M = (xi[:, None] * Wm
                     + K[:, None] * (I - lv.Axi.astype(dtype)[:, None]
                                     * Wm))
                G1 = I - _mm(M, A)
                B1 = M
            Gp, Hp = I, jnp.zeros_like(I)
            for _ in range(smoth_it):
                Gp = _mm(G1, Gp)
                Hp = _mm(G1, Hp) + B1
            phase_cache[idx] = (Gp, Hp)
            return Gp, Hp

        def coarse_matrix(lv):
            C = _mm(lv.evecs * lv.einv[None, :], lv.evecs.T)
            if deflated:
                xi, xmat = proj_parts(lv, C.shape[0])
                cnt = jnp.sum(xmat, axis=1)
                safe = jnp.where(cnt > 0, cnt, 1.0)
                Pm = (xi / safe)[:, None] * xmat
                C = C - _mm(Pm, C)
            return C.astype(dtype)

        last = len(dense) - 1

        def visit(idx, g):
            key = ("v", idx, g)
            if key in node_cache:
                return node_cache[key]
            Gp, Hp = phase_ops(idx)
            Dn = deep(idx + 1, g)
            A = dense[idx].A.astype(dtype)
            P = dense[idx + 1].P.astype(dtype)
            I = jnp.eye(A.shape[0], dtype=dtype)
            T = _mm(P.T, I - _mm(A, Hp))
            M2 = Hp + _mm(P, _mm(Dn, T))
            C = _mm(Gp, M2) + Hp
            node_cache[key] = C
            return C

        def deep(idx, g):
            key = ("d", idx, g)
            if key in node_cache:
                return node_cache[key]
            if idx == last:
                D = coarse_matrix(dense[idx])
            else:
                C = visit(idx, g)
                if g >= 2:
                    C2 = visit(idx, 1 if g == 3 else g)
                    A = dense[idx].A.astype(dtype)
                    I = jnp.eye(A.shape[0], dtype=dtype)
                    D = C + _mm(C2, I - _mm(A, C))
                else:
                    D = C
            node_cache[key] = D
            return D

        return deep(0, gamma)

    def build_deep(lv1, dense: Sequence[DenseLevel], dtype):
        """Materialize the deep sub-tape as a ``(cap1, cap1)`` matrix
        ``D`` (math convention: ``e1 = D @ r1``), or return ``None``
        when fusing cannot pay (fewer than 2 dense levels).

        Primary path: closed-form bottom-up composition
        (:func:`_deep_algebraic` — pure GEMMs).  Fallback (non-dense
        deep chain or PCG coarse solve): vmap the EXACT sub-tape over
        identity columns."""
        if not can_fuse:
            return None
        if not all(isinstance(lv, DenseLevel) for lv in dense):
            return None  # sparse deep levels: run the full tape
        if coarse_direct and dense[-1].evecs.shape[0] > 0:
            return _deep_algebraic(dense, dtype)
        cap1 = dense[0].A.shape[0]

        def deep_fn(r1):
            # Level-0 slots are never touched by the deep tape; size-1
            # dummies keep the vmapped carry small.
            es = tuple([jnp.zeros(1, dtype)]
                       + [jnp.zeros(lv.A.shape[0], dtype) for lv in dense])
            rs = tuple([jnp.zeros(1, dtype)]
                       + [r1 if i == 0 else jnp.zeros(lv.A.shape[0], dtype)
                          for i, lv in enumerate(dense)])
            levels = [lv1] + list(dense)

            def lvl_smooth(l, e, r, transpose):
                return _projected_smooth(dense_matvec, dense_smooth_apply,
                                         levels[l], e, r, smoth_it,
                                         transpose, nseg, deflated)

            def make_branch(op):
                kind, l = op

                def branch(carry):
                    es, rs = carry
                    es, rs = list(es), list(rs)
                    if kind == "pre":
                        es[l] = lvl_smooth(l, es[l], rs[l], False)
                    elif kind == "down":
                        rr = rs[l] - dense_matvec(levels[l], es[l])
                        rs[l + 1] = _mm(levels[l + 1].P.T, rr)
                        es[l + 1] = jnp.zeros_like(es[l + 1])
                    elif kind == "up":
                        es[l] = es[l] + _mm(levels[l + 1].P, es[l + 1])
                        es[l] = lvl_smooth(l, es[l], rs[l], True)
                    elif kind == "coarse":
                        es[l] = _coarse_solve(levels[l], rs[l], nseg,
                                              deflated, coarse_retol,
                                              coarse_maxit, coarse_direct)
                    return tuple(es), tuple(rs)

                return branch

            branches = [make_branch(op) for op in deep_op_ids]

            def body(carry, code):
                return lax.switch(code, branches, carry), None

            (es, _), _ = lax.scan(body, (es, rs), deep_codes)
            return es[1]

        # vmap rows are deep(e_j) = columns of D; transpose to the math
        # convention e1 = D @ r1.
        return jax.vmap(deep_fn)(jnp.eye(cap1, dtype=dtype)).T

    cycle.build_deep = build_deep
    return cycle


# ---------------------------------------------------------------------------
# Classical solve loop (Class_AMG.m:86-109)
# ---------------------------------------------------------------------------


class AMGSolveResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    rel_res: jax.Array


def amg_solve(lv1: BipartiteLevel | DenseLevel,
              dense: Sequence[DenseLevel],
              b: jax.Array, guess: jax.Array, opts: AMGOptions,
              deflated: bool = False) -> AMGSolveResult:
    """Stationary iteration ``x += cycle(b - A x)`` with relative-residual
    stopping and the divergence guard ``rho_k > 1 -> break``
    (``Class_AMG.m:95-106``).  ``lv1`` may be the structured bipartite
    level (bigph) or a plain dense level (generic hierarchy).
    ``deflated=True`` keeps all iterates kernel-free (mixed-precision
    correction solves; see :func:`_projected_smooth`)."""
    nseg = b.shape[0]
    gamma = {Cycle.V: 1, Cycle.W: 2, Cycle.F: 3}[opts.cycle]
    cycle = make_cycle(len(dense), opts.smoth, gamma, nseg,
                       opts.coarse_pcg.retol, opts.coarse_pcg.maxit,
                       opts.coarse_solver == "direct", deflated)
    # Fused deep correction: one matrix build per solve (outside the
    # stationary while_loop), one GEMV per cycle thereafter.
    deep_D = (cycle.build_deep(lv1, dense, b.dtype)
              if opts.fuse_deep else None)
    mv0 = _level0_ops(lv1)[0]

    r0 = b - mv0(lv1, guess)
    res0 = jnp.linalg.norm(r0)
    safe0 = jnp.where(res0 == 0, 1.0, res0)
    # Low-precision floor on the relative tolerance (never binds in fp64).
    retol_eff = jnp.maximum(jnp.asarray(opts.retol, b.dtype),
                            4 * jnp.finfo(b.dtype).eps)

    def cond(c):
        it, x, r, rel, rho, done = c
        return jnp.logical_not(done)

    def body(c):
        # The residual is CARRIED: iteration k's post-update residual
        # ``b - A x_new`` is exactly iteration k+1's ``r`` (the revert
        # keeps the old pair), so recomputing it at the top of the body
        # — as the reference does (``Class_AMG.m:95-104``) — would cost a
        # redundant fine-level matvec per iteration.  Float-identical to
        # the recomputing form.
        it, x, r, rel, rho, _ = c
        e = cycle(lv1, dense, r, deep_D)
        x_new = x + e
        r_new = b - mv0(lv1, x_new)
        res = jnp.linalg.norm(r_new)
        # NaN guard (the reference's commented check, Class_AMG.m:79-81):
        # a non-finite cycle result is treated as divergence — revert and
        # stop rather than poisoning the Newton step.  A residual-GROWING
        # cycle (rho > 1) is likewise REVERTED before the break: the
        # reference keeps the amplified iterate (Class_AMG.m:105-106),
        # which hands the Newton step a direction that is worse than the
        # initial guess; keeping the best-so-far iterate is trajectory-
        # neutral whenever the guard never fires.
        bad = jnp.logical_not(jnp.isfinite(res))
        grew = jnp.logical_or(bad, res > jnp.linalg.norm(r))
        x_new = jnp.where(grew, x, x_new)
        r_new = jnp.where(grew, r, r_new)
        rel_new = jnp.where(grew, rel, res / safe0)
        rho_new = jnp.where(bad, 2.0, res / jnp.linalg.norm(r))
        it = it + 1
        done = jnp.logical_or(rel_new <= retol_eff, it >= opts.maxit)
        done = jnp.logical_or(done, rho_new > 1.0)
        return it, x_new, r_new, rel_new, rho_new, done

    init = (jnp.int32(0), guess, r0, jnp.asarray(1.0, b.dtype),
            jnp.asarray(0.0, b.dtype), res0 == 0)
    it, x, r, rel, rho, _ = lax.while_loop(cond, body, init)
    return AMGSolveResult(x, it, rel)


def amg_solve_matrix(A: jax.Array, b: jax.Array,
                     opts: AMGOptions = AMGOptions(),
                     guess: jax.Array | None = None,
                     key: jax.Array | None = None,
                     dist: tuple | None = None) -> AMGSolveResult:
    """Standalone generic AMG solve of ``A x = b`` for an SPD dense
    matrix — the reference's ``Class_AMG.m`` entry point with ``bigph=0``
    (weighted-Jacobi fine smoothing, MIS coarsening throughout).

    ``dist=(mesh, halo)`` with a CSR input row-shards the fine level over
    the mesh and runs every fine matvec through the halo-exchange
    distributed SpMV (:class:`HaloCSRLevel`)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if guess is None:
        guess = jnp.zeros_like(b)
    lv0, rest = setup_hierarchy_generic(A, opts, key, dist=dist)
    if isinstance(lv0, HaloCSRLevel):
        from jax.sharding import NamedSharding, PartitionSpec

        vec = NamedSharding(lv0.mesh, PartitionSpec("x"))
        b = jax.device_put(b, vec)
        guess = jax.device_put(guess, vec)
    return amg_solve(lv0, rest, b, guess, opts)
