"""End-to-end benchmark suite: the five BASELINE.json configs.

    1. Class1 OT demo 64x64, single chip, AMG-PCG SsN to reference tol
    2. Class1 OT 256x256: deeper AMG hierarchy, V- vs W-cycle
    3. Class2 partial OT demo: AMG4POT path
    4. 1024x1024 OT row-partitioned over all local devices
    5. 2048x2048 OT: distributed assembly (scaled to available hardware;
       multi-host runs require jax.distributed outside this harness)

Each prints one JSON line.  Sizes auto-shrink with --quick for CI.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_class1(m, n, cycle, inner, mesh=None, label="",
               explicit_dist=False, single=False, fuse_deep=False):
    import jax

    from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
    from otamg.opt import solve_class1
    from otamg.ot import random_class1

    solve_dtype = None if jax.default_backend() == "cpu" else "float32"
    prob = random_class1(jax.random.PRNGKey(0), m, n)
    if mesh is not None:
        from otamg.dist import shard_class1

        prob = shard_class1(prob, mesh)
    opts = APDOptions(
        inner_solver=InnerSolver[inner], solve_dtype=solve_dtype,
        amg=AMGOptions(cycle=Cycle[cycle], fuse_deep=fuse_deep),
        explicit_dist=explicit_dist)
    t0 = time.time()
    res = solve_class1(prob, opts)  # warm-up/compile
    dt = time.time() - t0
    if not single:
        t0 = time.time()
        res = solve_class1(prob, opts)
        dt = time.time() - t0
    print(json.dumps({
        "bench": label or f"class1_{m}x{n}_{cycle}_{inner}",
        "m": m, "n": n, "cycle": cycle, "inner": inner,
        "devices": 1 if mesh is None else int(mesh.devices.size),
        "converged": bool(res.converged), "iters": int(res.iters),
        "time_s": round(dt, 3),
        "fail": int(res.fail_count),
        "explicit_dist": explicit_dist,
        "cold_timing": single,
    }))
    return res


def run_class2(m, n, mesh=None, label="", single=False,
               feas_polish=False):
    import jax

    from otamg.config import AMGOptions, APDOptions, InnerSolver
    from otamg.opt.apd2 import solve_class2
    from otamg.ot import random_class2

    solve_dtype = None if jax.default_backend() == "cpu" else "float32"
    prob = random_class2(jax.random.PRNGKey(1), m, n, mu_frac=0.6)
    if mesh is not None:
        from otamg.dist import shard_class2

        prob = shard_class2(prob, mesh)
    opts = APDOptions(ssn_tol1=1e-10, inner_solver=InnerSolver.AMG,
                      solve_dtype=solve_dtype,
                      amg=AMGOptions(maxit=40, smoth=10),
                      feas_polish=feas_polish)
    t0 = time.time()
    res = solve_class2(prob, opts)
    dt = time.time() - t0
    if not single:
        t0 = time.time()
        res = solve_class2(prob, opts)
        dt = time.time() - t0
    print(json.dumps({
        "bench": label or f"class2_{m}x{n}_amg4pot", "m": m, "n": n,
        "devices": 1 if mesh is None else int(mesh.devices.size),
        "converged": bool(res.converged), "iters": int(res.iters),
        "time_s": round(dt, 3), "fail": int(res.fail_count),
        "cold_timing": single,
    }))


def run_sparse_halo(N, label=""):
    """Generic AMG on a banded N-node Laplacian with sparse-aggregation
    setup and the halo-exchange distributed fine SpMV (``spmv_halo``
    riding a bidirectional ppermute ring inside ``amg_solve``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from otamg.amg.hierarchy import amg_solve, setup_hierarchy_sparse
    from otamg.config import AMGOptions, Cycle
    from otamg.dist import make_mesh
    from otamg.sparse import CSR

    ndev = len(jax.devices())
    while N % ndev:
        ndev -= 1
    mesh = make_mesh(ndev) if ndev > 1 else None
    # Tridiagonal 1-D Laplacian + shift, built directly in ELL form.
    idx = jnp.arange(N, dtype=jnp.int32)
    cols = jnp.stack([jnp.maximum(idx - 1, 0), idx,
                      jnp.minimum(idx + 1, N - 1)], axis=1)
    vals = jnp.stack([jnp.where(idx > 0, -1.0, 0.0),
                      jnp.full(N, 2.01),
                      jnp.where(idx < N - 1, -1.0, 0.0)], axis=1)
    csr = CSR(indptr=jnp.zeros(N + 1, jnp.int32), ell_cols=cols,
              ell_vals=vals, shape=(N, N))
    opts = AMGOptions(maxit=60, cycle=Cycle.W, coarse_target=64,
                      retol=1e-10)
    dist = (mesh, 1) if mesh is not None else None
    t0 = time.time()
    lv0, rest = setup_hierarchy_sparse(csr, opts, jax.random.PRNGKey(0),
                                       agg=2, dense_crossover=1024,
                                       dist=dist)
    setup_s = time.time() - t0
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(N))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        b = jax.device_put(b, NamedSharding(mesh, PartitionSpec("x")))
    t0 = time.time()
    res = amg_solve(lv0, rest, b, jnp.zeros_like(b), opts)
    rel = float(res.rel_res)
    dt = time.time() - t0
    t0 = time.time()
    res = amg_solve(lv0, rest, b, jnp.zeros_like(b), opts)
    warm = time.time() - t0
    print(json.dumps({
        "bench": label or f"cfg7_sparse_halo_{N}",
        "N": N, "devices": 1 if mesh is None else ndev,
        "halo_spmv": mesh is not None,
        "iters": int(res.iters), "rel_res": rel,
        "setup_s": round(setup_s, 3), "time_s": round(warm, 3),
        "cold_s": round(dt, 3),
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="shrink sizes for CI")
    ap.add_argument("--configs", default="1,2,3,4",
                    help="comma-separated config numbers to run")
    ap.add_argument("--single", action="store_true",
                    help="time the first (cold) solve only — for big "
                         "configs where a second solve busts the budget")
    args = ap.parse_args()

    from otamg.config import enable_compile_cache

    enable_compile_cache()
    import jax

    jax.config.update("jax_enable_x64", True)

    configs = {int(c) for c in args.configs.split(",")}
    shrink = 4 if args.quick else 1

    if 1 in configs:
        run_class1(64 // shrink, 64 // shrink, "W", "AMG",
                   label="cfg1_class1_64")
    if 2 in configs:
        for cyc in ("W", "V"):
            run_class1(256 // shrink, 256 // shrink, cyc, "AMG",
                       label=f"cfg2_class1_256_{cyc}")
    if 3 in configs:
        run_class2(128 // shrink, 128 // shrink)
    if 4 in configs:
        ndev = len(jax.devices())
        if ndev > 1:
            from otamg.dist import make_mesh

            mesh = make_mesh(ndev)
            size = 1024 // shrink
            run_class1(size, size, "W", "AMG", mesh=mesh,
                       label=f"cfg4_class1_{size}_dist{ndev}")
        else:
            size = 1024 // shrink
            run_class1(size, size, "W", "AMG",
                       label=f"cfg4_class1_{size}_1chip")
    if 6 in configs:
        # Class-2 at 1024^2 (round-4 addition; the reference's own
        # Class2 driver was written for 1000^2 inputs,
        # ``Class2/APD_SsN_Class2.m:20``).
        ndev = len(jax.devices())
        mesh = None
        if ndev > 1:
            from otamg.dist import make_mesh

            mesh = make_mesh(ndev)
        size = 1024 // shrink
        run_class2(size, size, mesh=mesh,
                   label=f"cfg6_class2_{size}_dist{ndev}",
                   single=args.single, feas_polish=True)
    if 7 in configs:
        # Sparse-setup AMG with the halo-exchange fine SpMV at N >= 1e5
        # (round-4 verdict item 7's production consumer, at a scale the
        # densifying generic setup cannot reach).
        run_sparse_halo(131072 // shrink)
    if 5 in configs:
        # BASELINE config 5: 2048^2 with EXPLICIT distributed KKT assembly
        # (shard_map psum/all_gather, ``ASAt.m:14-19`` ->
        # ``otamg.dist.assembly.transform_sharded``) feeding the AMG
        # hierarchy, row-sharded over every visible device.
        ndev = len(jax.devices())
        size = 2048 // shrink
        mesh = None
        if ndev > 1:
            from otamg.dist import make_mesh

            mesh = make_mesh(ndev)
        # F-cycle: linear-in-depth tape, trajectory-identical to the
        # reference W (pinned in tests/test_fixture_trajectory.py) — what
        # makes a WARM cfg5 measurement fit the 2-core CPU budget
        # (round-4 cold W run: 3607 s).  NOTE: fuse_deep is NOT requested
        # here — make_hybrid_amg_solver force-disables the fused deep
        # build whenever explicit-dist sharding is active (the deep
        # matrix would gather sharded operands), so passing it would
        # only mislabel the recorded config.
        run_class1(size, size, "F", "AMG", mesh=mesh,
                   label=f"cfg5_class1_{size}_dist{ndev}_explicit",
                   explicit_dist=True, single=args.single,
                   fuse_deep=False)


if __name__ == "__main__":
    main()
