"""Tests for the AMG engine: graph algorithms vs scipy oracles, hierarchy
invariants (Galerkin symmetry, P rows sum to 1 under isnsp), and full
hybrid solves vs dense direct solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from otamg.amg.graph import (
    connected_components_bipartite,
    mis_dense,
    strength_dense,
)
from otamg.amg.hierarchy import (
    amg_solve,
    bip_matvec,
    setup_hierarchy,
)
from otamg.config import AMGOptions, Cycle
from otamg.hybrid import make_aug_pcg_solver, make_hybrid_amg_solver


def random_bipartite_mask(rng, m, n, density):
    return (rng.uniform(size=(m, n)) < density).astype(float)


@pytest.mark.parametrize("m,n,density", [(12, 9, 0.15), (30, 25, 0.05),
                                         (20, 20, 0.3), (8, 8, 0.0)])
def test_components_vs_scipy(m, n, density):
    rng = np.random.default_rng(7)
    S = random_bipartite_mask(rng, m, n, density)
    labels = np.asarray(connected_components_bipartite(jnp.asarray(S)))
    # scipy oracle on the (n+m) bipartite adjacency (cols first, rows after)
    A = sp.lil_matrix((n + m, n + m))
    for i in range(m):
        for j in range(n):
            if S[i, j]:
                A[j, n + i] = 1
                A[n + i, j] = 1
    ncomp, ref = csgraph.connected_components(A.tocsr(), directed=False)
    assert len(np.unique(labels)) == ncomp
    # same partition: labels agree iff ref labels agree
    for c in np.unique(ref):
        idx = np.where(ref == c)[0]
        assert len(np.unique(labels[idx])) == 1, "component split differs"
    # representative is the min node index of the component
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        assert labels[idx].min() == idx.min()


def test_strength_matches_reference_formula():
    rng = np.random.default_rng(8)
    N = 10
    # Laplacian-like SPD matrix
    B = rng.uniform(size=(N, N)) * (rng.uniform(size=(N, N)) < 0.4)
    W = (B + B.T) / 2
    np.fill_diagonal(W, 0)
    A = np.diag(W.sum(1) + 0.1) - W
    active = np.ones(N, bool)
    S = np.asarray(strength_dense(jnp.asarray(A), jnp.asarray(active)))
    # oracle
    A0 = -A.copy()
    np.fill_diagonal(A0, 0)
    mr = A0.max(axis=1)
    mr[mr <= 0] = np.inf
    expected = np.zeros_like(A0)
    for i in range(N):
        for j in range(N):
            if i != j and A0[i, j] != 0:
                expected[i, j] = A0[i, j] / min(mr[i], mr[j])
    np.testing.assert_allclose(S, expected, rtol=1e-12, atol=1e-15)


def test_mis_properties():
    rng = np.random.default_rng(9)
    N = 40
    W = (rng.uniform(size=(N, N)) < 0.2).astype(float)
    W = np.triu(W, 1)
    W = W + W.T
    A = np.diag(W.sum(1) + 1e-3) - W
    active = jnp.ones(N, bool)
    S = strength_dense(jnp.asarray(A), active)
    As = S >= 0.25
    isC, isF = mis_dense(As, active, jax.random.PRNGKey(0))
    isC, isF = np.asarray(isC), np.asarray(isF)
    assert not np.any(isC & isF)
    # C is independent in the strong graph up to the absorb step: every F
    # node was produced as a neighbor of C or isolated
    Asn = np.asarray(As)
    iso = ~Asn.any(axis=1)
    assert np.all(isC[iso]), "strength-isolated nodes must be C"
    assert isC.sum() >= 1


def _build_problem(rng, m, n, density, bk1, tk, tfrac=0.0):
    p = rng.uniform(0.5, 2.0, m)
    q = rng.uniform(0.5, 2.0, n)
    S = random_bipartite_mask(rng, m, n, density)
    tvec = np.zeros(n + m)
    if tfrac > 0:
        tvec = (rng.uniform(size=n + m) < tfrac) * rng.uniform(
            0.1, 1.0, n + m)
    rhs = rng.standard_normal(n + m)
    return p, q, S, tvec, rhs


def _dense_Jk(p, q, S, tvec, bk1, tk):
    m, n = len(p), len(q)
    d1 = S.T @ (p * p)
    d2 = S @ (q * q)
    off = (q[:, None] * S.T) * p[None, :]
    H0 = np.block([[np.diag(d1), off], [off.T, np.diag(d2)]])
    return bk1 * np.eye(n + m) + (np.diag(tvec) + H0) / tk


@pytest.mark.parametrize("m,n,density,bk1,tfrac", [
    (16, 12, 0.3, 1e-2, 0.0),
    (24, 24, 0.08, 1e-4, 0.0),     # disconnected, near-singular
    (20, 15, 0.2, 1e-3, 0.5),      # with K (POT-style SPD components)
    (30, 30, 0.5, 1e-6, 0.0),      # dense-ish, very near-singular
])
def test_hybrid_amg_solves_jacobian(m, n, density, bk1, tfrac):
    rng = np.random.default_rng(11)
    p, q, S, tvec, rhs = _build_problem(rng, m, n, density, bk1, 1.0, tfrac)
    tk = 0.7
    Jk = _dense_Jk(p, q, S, tvec, bk1, tk)
    want = np.linalg.solve(Jk, rhs)

    solver = make_hybrid_amg_solver(jnp.asarray(p), jnp.asarray(q),
                                    AMGOptions(maxit=40))
    out = solver(jnp.asarray(S), jnp.asarray(tvec), bk1, tk,
                 jnp.asarray(rhs), jax.random.PRNGKey(3))
    got = np.asarray(out.zeta)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-7, f"rel err {err:.2e}, iters={int(out.iters)}, " \
                       f"res={float(out.res):.2e}"


def test_hybrid_twogrid_solves_jacobian():
    rng = np.random.default_rng(12)
    m = n = 20
    p, q, S, tvec, rhs = _build_problem(rng, m, n, 0.25, 1e-3, 1.0)
    tk = 1.3
    Jk = _dense_Jk(p, q, S, tvec, 1e-3, tk)
    want = np.linalg.solve(Jk, rhs)
    solver = make_hybrid_amg_solver(jnp.asarray(p), jnp.asarray(q),
                                    AMGOptions(maxit=40), twogrid=True)
    out = solver(jnp.asarray(S), jnp.asarray(tvec), 1e-3, tk,
                 jnp.asarray(rhs), jax.random.PRNGKey(4))
    err = np.linalg.norm(np.asarray(out.zeta) - want) / np.linalg.norm(want)
    assert err < 1e-7, f"rel err {err:.2e}, iters={int(out.iters)}"


def test_aug_pcg_solves_jacobian():
    rng = np.random.default_rng(13)
    m, n = 18, 14
    p, q, S, tvec, rhs = _build_problem(rng, m, n, 0.12, 1e-5, 1.0)
    tk = 0.9
    Jk = _dense_Jk(p, q, S, tvec, 1e-5, tk)
    want = np.linalg.solve(Jk, rhs)
    from otamg.config import PCGOptions
    solver = make_aug_pcg_solver(jnp.asarray(p), jnp.asarray(q),
                                 PCGOptions())
    out = solver(jnp.asarray(S), jnp.asarray(tvec), 1e-5, tk,
                 jnp.asarray(rhs), jax.random.PRNGKey(5))
    err = np.linalg.norm(np.asarray(out.zeta) - want) / np.linalg.norm(want)
    assert err < 1e-6, f"rel err {err:.2e}, iters={int(out.iters)}"


def test_hierarchy_invariants():
    """Galerkin coarse matrices stay symmetric; under isnsp the level-1
    prolongation rows sum to 1 (kernel preservation, transfer.m:60-62)."""
    rng = np.random.default_rng(14)
    m = n = 24
    p = rng.uniform(0.5, 2.0, m)
    q = rng.uniform(0.5, 2.0, n)
    S = random_bipartite_mask(rng, m, n, 0.3)
    bk1, tk = 1e-5, 1.0
    p2, q2 = p * p, q * q
    E = (p2[:, None] * q2[None, :]) * S
    a0diag = np.concatenate([E.sum(0), E.sum(1)])
    qp2 = np.concatenate([q2, p2])
    g = bk1 * qp2 + a0diag / tk
    from otamg.amg.graph import connected_components_bipartite as ccb
    labels = ccb(jnp.asarray(E))
    nsp = jnp.ones(n + m, bool)
    lv1, dense = setup_hierarchy(jnp.asarray(E), jnp.asarray(g), 1 / tk,
                                 labels, nsp, AMGOptions(),
                                 jax.random.PRNGKey(0))
    # W rows sum to 1 where the q-node has any edge (kernel preservation)
    Wsum = np.asarray(jnp.sum(lv1.W, axis=1))
    has_edge = E.sum(0) > 0
    np.testing.assert_allclose(Wsum[has_edge], 1.0, rtol=1e-12)
    for lv in dense:
        A = np.asarray(lv.A)
        np.testing.assert_allclose(A, A.T, rtol=0, atol=1e-12)
        act = np.asarray(lv.active)
        # padding rows are exactly identity
        if (~act).any():
            sub = A[~act][:, act]
            np.testing.assert_allclose(sub, 0, atol=1e-14)
            np.testing.assert_allclose(np.diag(A)[~act], 1.0, rtol=1e-12)


def _grid_laplacian(nx, ny):
    N = nx * ny
    A = np.zeros((N, N))
    for i in range(nx):
        for j in range(ny):
            k = i * ny + j
            A[k, k] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < ny:
                    A[k, ii * ny + jj] = -1.0
    return A


def test_generic_amg_solves_spd_matrix():
    """Standalone non-bigph AMG (``Class_AMG.m:72``, weighted-Jacobi fine
    smoothing + MIS coarsening throughout) on a shifted 2D grid Laplacian.
    The reference's generic algorithm (0.5-weighted Jacobi) contracts at
    ~0.7/cycle here, so the budgeted accuracy is 1e-6, not the product
    path's 1e-11."""
    from otamg.amg.hierarchy import amg_solve_matrix

    rng = np.random.default_rng(21)
    A = _grid_laplacian(12, 10) + 0.01 * np.eye(120)
    b = rng.standard_normal(120)
    res = amg_solve_matrix(jnp.asarray(A), jnp.asarray(b),
                           AMGOptions(maxit=60))
    want = np.linalg.solve(A, b)
    err = np.linalg.norm(np.asarray(res.x) - want) / np.linalg.norm(want)
    assert err < 1e-6, f"rel err {err:.2e}, iters={int(res.iters)}"


@pytest.mark.parametrize("cycle", [Cycle.V, Cycle.W, Cycle.F])
def test_fuse_deep_matches_full_tape(cycle):
    """The fused deep correction (one precomputed matrix per solve, one
    GEMV per cycle) must reproduce the full visit tape: the sub-tape
    below level 0 is a linear map, so the two are the same algebra at a
    different rounding order.  Checked on BOTH the generic hierarchy and
    the production bipartite path (deep-enough hierarchies via a small
    ``coarse_target``)."""
    import dataclasses

    from otamg.amg.hierarchy import amg_solve_matrix

    rng = np.random.default_rng(33)
    A = _grid_laplacian(12, 10) + 0.01 * np.eye(120)
    b = rng.standard_normal(120)
    o0 = AMGOptions(maxit=20, cycle=cycle, coarse_target=12)
    o1 = dataclasses.replace(o0, fuse_deep=True)
    r0 = amg_solve_matrix(jnp.asarray(A), jnp.asarray(b), o0)
    r1 = amg_solve_matrix(jnp.asarray(A), jnp.asarray(b), o1)
    assert int(r0.iters) == int(r1.iters)
    xdiff = np.linalg.norm(np.asarray(r0.x - r1.x)) \
        / np.linalg.norm(np.asarray(r0.x))
    assert xdiff < 1e-12, f"fused deviates: {xdiff:.2e}"

    # Production (bipartite Newton-system) path.
    m, n = 48, 40
    p, q, S, tvec, rhs = _build_problem(rng, m, n, 0.25, 1e-4, 1.0)
    tk = 0.9
    Jk = _dense_Jk(p, q, S, tvec, 1e-4, tk)
    want = np.linalg.solve(Jk, rhs)
    outs = []
    for o in (AMGOptions(maxit=40, cycle=cycle, coarse_target=8),
              AMGOptions(maxit=40, cycle=cycle, coarse_target=8,
                         fuse_deep=True)):
        solver = make_hybrid_amg_solver(jnp.asarray(p), jnp.asarray(q), o)
        outs.append(solver(jnp.asarray(S), jnp.asarray(tvec), 1e-4, tk,
                           jnp.asarray(rhs), jax.random.PRNGKey(5)))
    for out in outs:
        err = np.linalg.norm(np.asarray(out.zeta) - want) \
            / np.linalg.norm(want)
        assert err < 1e-7, f"rel err {err:.2e}"
    # The rounding-order difference can land the relative residual on
    # opposite sides of retol at the final cycle; allow exactly that.
    assert abs(int(outs[0].iters) - int(outs[1].iters)) <= 1


def test_hybrid_amg_nonbigph_matches_bigph():
    """``bigph=False`` routes the hybrid solve through the generic dense
    hierarchy; both modes must solve the same Jacobian system.  The
    generic weighted-Jacobi hierarchy converges much more slowly than the
    block-GS bipartite one (which is exactly why the reference drivers
    always set ``bigph=1``), so its accuracy budget is looser."""
    rng = np.random.default_rng(22)
    m = n = 18
    p, q, S, tvec, rhs = _build_problem(rng, m, n, 0.3, 1e-2, 1.0, 1.0)
    tk = 0.9
    Jk = _dense_Jk(p, q, S, tvec, 1e-2, tk)
    want = np.linalg.solve(Jk, rhs)
    for bigph, tol in ((True, 1e-9), (False, 1e-6)):
        solver = make_hybrid_amg_solver(
            jnp.asarray(p), jnp.asarray(q),
            AMGOptions(maxit=60, bigph=bigph))
        out = solver(jnp.asarray(S), jnp.asarray(tvec), 1e-2, tk,
                     jnp.asarray(rhs), jax.random.PRNGKey(5))
        err = np.linalg.norm(np.asarray(out.zeta) - want) \
            / np.linalg.norm(want)
        assert err < tol, f"bigph={bigph}: rel err {err:.2e}"


def test_generic_amg_csr_fine_level_matches_dense():
    """A CSR fine operator must produce the same generic-AMG result as the
    dense one (identical math; solve-phase matvecs run on the ELL
    container — the sparse layer's product consumer)."""
    from otamg.amg.hierarchy import CSRLevel, amg_solve_matrix
    from otamg.amg import setup_hierarchy_generic
    from otamg.config import AMGOptions
    from otamg.sparse import CSR

    rng = np.random.default_rng(31)
    A = _grid_laplacian(12, 10) + 0.01 * np.eye(120)
    b = rng.standard_normal(120)
    Aj = jnp.asarray(A)
    csr = CSR.from_dense(Aj, row_cap=5)
    # coarse_target below N so the hierarchy has >1 level (a single-level
    # hierarchy is pure eigensolve and keeps the dense head).
    opts = AMGOptions(maxit=60, coarse_target=30)

    lv0, rest = setup_hierarchy_generic(csr, opts, jax.random.PRNGKey(0))
    assert isinstance(lv0, CSRLevel)

    res_d = amg_solve_matrix(Aj, jnp.asarray(b), opts)
    res_s = amg_solve_matrix(csr, jnp.asarray(b), opts)
    assert int(res_s.iters) == int(res_d.iters)
    np.testing.assert_allclose(np.asarray(res_s.x), np.asarray(res_d.x),
                               rtol=1e-12, atol=1e-14)


def test_generic_amg_halo_csr_fine_level():
    """Production consumer of the halo-exchange distributed SpMV
    (round-4 verdict item 7): a BANDED CSR fine operator row-sharded
    over the mesh runs every solve-phase fine matvec through
    ``spmv_halo`` (``HaloCSRLevel``) inside ``amg_solve`` — and must
    reproduce the single-device CSR result exactly.  The jitted solve's
    HLO must actually contain the ring collective."""
    from otamg.amg.hierarchy import HaloCSRLevel, amg_solve_matrix
    from otamg.amg import setup_hierarchy_generic
    from otamg.config import AMGOptions
    from otamg.dist import make_mesh
    from otamg.sparse import CSR

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    rng = np.random.default_rng(37)
    N = 256  # divisible by 4; band half-width 1 << N/4 rows per shard
    A = _grid_laplacian(16, 16) + 0.01 * np.eye(N)  # banded: |i-j| <= 16
    b = rng.standard_normal(N)
    Aj = jnp.asarray(A)
    csr = CSR.from_dense(Aj, row_cap=5)
    opts = AMGOptions(maxit=60, coarse_target=48)
    mesh = make_mesh(4)

    lv0, rest = setup_hierarchy_generic(csr, opts, jax.random.PRNGKey(0),
                                        dist=(mesh, 16))
    assert isinstance(lv0, HaloCSRLevel)
    # The fine matvec's lowered HLO must carry the ppermute ring.
    v = jax.device_put(jnp.asarray(b),
                       jax.sharding.NamedSharding(
                           mesh, jax.sharding.PartitionSpec("x")))
    from otamg.amg.hierarchy import halo_csr_matvec

    hlo = jax.jit(lambda lv, v: halo_csr_matvec(lv, v)).lower(
        lv0, v).compile().as_text()
    assert "collective-permute" in hlo

    res_s = amg_solve_matrix(csr, jnp.asarray(b), opts)
    res_h = amg_solve_matrix(csr, jnp.asarray(b), opts, dist=(mesh, 16))
    assert int(res_h.iters) == int(res_s.iters)
    np.testing.assert_allclose(np.asarray(res_h.x), np.asarray(res_s.x),
                               rtol=1e-11, atol=1e-13)


def test_halo_bandwidth_violation_is_loud():
    """Round-5 review: ``spmv_halo`` clamps column indices purely to
    guard the gather, so a too-small halo would silently evaluate a
    CLAMPED operator and amg_solve would converge to the wrong system's
    solution.  Setup must reject it eagerly — with the halo the operator
    actually needs in the message."""
    from otamg.amg import setup_hierarchy_generic
    from otamg.config import AMGOptions
    from otamg.dist import make_mesh
    from otamg.sparse import CSR

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    N = 256
    A = _grid_laplacian(16, 16) + 0.01 * np.eye(N)  # bandwidth 16
    csr = CSR.from_dense(jnp.asarray(A), row_cap=5)
    opts = AMGOptions(maxit=60, coarse_target=48)
    mesh = make_mesh(4)
    with pytest.raises(ValueError, match="need halo >= 16"):
        setup_hierarchy_generic(csr, opts, jax.random.PRNGKey(0),
                                dist=(mesh, 4))


def _banded_ell(N, shift=0.01):
    """1-D Laplacian + shift as padded ELL arrays (tridiagonal)."""
    import scipy.sparse as sp

    A = sp.diags([-np.ones(N - 1), np.full(N, 2.0 + shift),
                  -np.ones(N - 1)], [-1, 0, 1]).tocsr()
    rc = 3
    cols = np.zeros((N, rc), np.int32)
    vals = np.zeros((N, rc))
    for i in range(N):
        s, e = A.indptr[i], A.indptr[i + 1]
        cols[i, :e - s] = A.indices[s:e]
        vals[i, :e - s] = A.data[s:e]
    from otamg.sparse import CSR

    return A, CSR(indptr=jnp.asarray(A.indptr),
                  ell_cols=jnp.asarray(cols),
                  ell_vals=jnp.asarray(vals), shape=(N, N))


def test_sparse_aggregation_hierarchy_large_banded():
    """Sparse-setup path (``setup_hierarchy_sparse``): aggregation
    coarsening above the dense crossover keeps setup O(nnz), so the
    hierarchy builds at sizes where the generic path's densification
    cannot.  The solve must reach the direct solution; with
    ``dist=(mesh, halo)`` every fine matvec is the halo-exchange SpMV
    and the result must be identical."""
    import scipy.sparse.linalg as spl

    from otamg.amg.hierarchy import (AggCSRLevel, HaloCSRLevel,
                                     amg_solve, setup_hierarchy_sparse)
    from otamg.config import AMGOptions, Cycle

    N = 16384
    A, csr = _banded_ell(N)
    opts = AMGOptions(maxit=60, cycle=Cycle.W, coarse_target=64,
                      retol=1e-10)
    lv0, rest = setup_hierarchy_sparse(csr, opts, jax.random.PRNGKey(0),
                                       agg=2, dense_crossover=1024)
    assert any(isinstance(lv, AggCSRLevel) for lv in rest)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(N))
    res = amg_solve(lv0, rest, b, jnp.zeros(N), opts)
    want = spl.spsolve(A.tocsc(), np.asarray(b))
    err = np.linalg.norm(np.asarray(res.x) - want) / np.linalg.norm(want)
    assert err < 1e-8, f"err {err:.2e} after {int(res.iters)} cycles"

    if len(jax.devices()) >= 4:
        from otamg.dist import make_mesh

        mesh = make_mesh(4)
        lv0h, resth = setup_hierarchy_sparse(
            csr, opts, jax.random.PRNGKey(0), agg=2,
            dense_crossover=1024, dist=(mesh, 1))
        assert isinstance(lv0h, HaloCSRLevel)
        bh = jax.device_put(b, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("x")))
        resh = amg_solve(lv0h, resth, bh, jnp.zeros_like(bh), opts)
        assert int(resh.iters) == int(res.iters)
        np.testing.assert_allclose(np.asarray(resh.x),
                                   np.asarray(res.x), rtol=1e-11,
                                   atol=1e-13)


@pytest.mark.slow
def test_extreme_bk1_newton_system_refines():
    """Regression: the it=40 Newton system from an fp32 trajectory
    (spanning-tree active set, one giant near-singular component,
    bk1 ~ 6.5e-6) — the state where (a) matvec-computed kernel-projection
    quantities cancel to noise and (b) the solve-dtype Galerkin roundoff
    dwarfs the true kernel curvature.  The mixed-precision he_solve must
    refine it below the reference tolerance; before the analytic-gk +
    deflated-cycle fixes it diverged (rel ~1 after safeguarding)."""
    import os

    from otamg.hybrid.solver import build_he_solver
    from otamg.ot import load_class1_mat
    from otamg.ot import operators as op

    path = os.path.join(os.path.dirname(__file__), "data",
                        "state39_fp32.npz")
    fixture = "/root/reference/Class1/InputData/data1-500.mat"
    if not os.path.exists(fixture):
        pytest.skip("reference fixture not available")
    prob = load_class1_mat(fixture)
    d = np.load(path)
    X = jnp.asarray(d["X"])
    V = jnp.asarray(d["V"])
    lam = jnp.asarray(d["lam"])
    bk = jnp.asarray(d["bk"])
    dtype = X.dtype
    C, b, p, q, gama = prob.C, prob.b, prob.p, prob.q, prob.gama
    k = jnp.asarray(40, jnp.int32).astype(dtype)
    ak = jnp.sqrt(k ** 2 * bk)
    bk1 = bk / (1 + ak)
    tk = bk * (1 + ak) / ak ** 2
    Wk = -C + bk * (X + ak * V) / ak ** 2
    Zk = (Wk - op.apply_At(lam.astype(dtype), p, q)) / tk
    S = jnp.logical_and(Zk >= 0, Zk <= gama).astype(dtype)
    b_hi = b.astype(jnp.float64)
    wlk = (bk1 * (lam - (op.apply_A(X, p, q, jnp.float64) - b_hi) / bk)
           - b_hi)
    Fk = (bk1 * lam - op.apply_A(op.prox_box(Zk, gama), p, q,
                                 jnp.float64) - wlk)
    he, ncomp, _last = build_he_solver(
        S, jnp.zeros(1000, dtype), jnp.asarray(bk1, dtype),
        jnp.asarray(tk, dtype), p.astype(dtype), q.astype(dtype),
        AMGOptions(), "float32", 10, jnp.float64, jax.random.PRNGKey(7))
    zeta, iters, rel = he(-Fk, jax.random.PRNGKey(8))
    assert float(rel) < 1e-11, f"refinement stalled at rel={float(rel):.2e}"
