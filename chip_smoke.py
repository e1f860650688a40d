"""Smoke test of the IPD-SsN-AMG solve path on the GPU.

    python chip_smoke.py              # one card: phases a-d
    python chip_smoke.py --multichip  # four cards: phase e only

Phases, each printing one JSON line (the last line is the verdict):

a. device     -- JAX's devices and ``nvidia-smi``'s name and power limit.
b. precision  -- the fp32 level operators of a seeded 4096^2 Class-1 Newton
                 system (built by the solver's own setup code), run on the
                 card and compared with an f64 NumPy reference: the masked
                 dense GEMVs, the fused bipartite smoother, a Galerkin GEMM,
                 the coarse eigensolve and its filtered inverse.  Also
                 times the ELL SpMV.
c. trajectory -- Class 1 and Class 2 at 500^2 with the production options
                 (``bench.options``) against pins recorded on the CPU; the
                 Class-1 solve again (determinism) and all-f64.
d. real size  -- Class 2 at 2048^2 through ``otamg.cli.main`` and Class 1 at
                 4096^2 through ``solve_class1``, to relative KKT <= 1e-6.
e. multichip  -- Class 1 at 2048^2 on one card, row-sharded over four cards
                 through the CLI's ``--shard``, and with explicit-collective
                 assembly (``APDOptions(explicit_dist=True)``).

Any failed check ends the run with a non-zero exit.  Without a GPU the
script exits non-zero before any solve.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
import tempfile
import time

TOL_PRECISION = 1e-5    # fp32 products at Precision.HIGHEST; TF32 ~1e-3
TOL_OBJECTIVE = 1e-6    # relative distance of the objective to its pin
MAX_ITER_DRIFT = 2      # outer iterations allowed off the CPU pin
KKT_TOL = 1e-6

# CPU pins of phase c: production options, f64 state, fp32 AMG, seed 0.
# Recorded with
#   JAX_PLATFORMS=cpu python -c 'import chip_smoke; chip_smoke.print_pins(500)'
PINS_500 = {
    "class1": {"iters": 55, "fails": 0, "objective": 1.0810500251146964},
    "class2": {"iters": 50, "fails": 0, "objective": 0.1993452165292393},
}


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, ok: bool, **fields) -> None:
    print(json.dumps({"phase": phase, "ok": ok} | fields), flush=True)
    if not ok:
        raise SmokeFailure(f"phase {phase} failed")


def _rel_err(got, ref) -> float:
    """``max|got - ref| / max|ref|`` in f64."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _solve(cls: str, prob, opts):
    from otamg.opt import solve_class1
    from otamg.opt.apd2 import solve_class2

    t0 = time.perf_counter()
    solve = solve_class1 if cls == "class1" else solve_class2
    res = solve(prob, opts)
    return res, time.perf_counter() - t0


def rel_kkt(res) -> float:
    """Final relative KKT residual of a Class-1 or Class-2 result."""
    import numpy as np

    if hasattr(res, "kkt"):
        return float(np.max(res.kkt[-1] / (1 + res.kkt[0])))
    return max(res.kkt_x[-1] / (1 + res.kkt_x[0]),
               res.kkt_l[-1] / (1 + res.kkt_l[0]))


def summary(res) -> dict:
    return {"converged": bool(res.converged), "iters": int(res.iters),
            "fails": int(res.fail_count),
            "objective": float(res.fxk[-1]), "rel_kkt": rel_kkt(res)}


# --------------------------------------------------------------------------
# a. device
# --------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from otamg.diag.device import gpu_name_power, require_gpu

    device = require_gpu()
    smi = gpu_name_power()
    print(smi, flush=True)
    emit("device", True, devices=[str(d) for d in jax.devices()],
         kind=device["kind"], count=device["count"],
         name_power_limit=smi)
    return device


# --------------------------------------------------------------------------
# b. precision at real widths
# --------------------------------------------------------------------------


def newton_levels(size: int, seed: int = 0, coarse_target=None):
    """fp32 hierarchy of the first Newton system of a seeded Class-1
    solve (k = 1, bk = 1, so bk1 = 1/2 and tk = 2), built by the solver's
    own setup functions on the A-ADMM warm start's active set.
    ``coarse_target`` overrides the production coarsest size, so that a
    small problem still has two coarse levels."""
    import jax
    import jax.numpy as jnp

    import bench
    from otamg.amg.hierarchy import setup_hierarchy
    from otamg.hybrid.solver import _component_info, _transform
    from otamg.opt.apd import _warmup1_jit
    from otamg.ot import operators as op

    opts = bench.options("class1")
    if coarse_target is not None:
        opts = dataclasses.replace(opts, amg=dataclasses.replace(
            opts.amg, coarse_target=coarse_target))
    prob = bench.problem("class1", size, seed)
    ws = _warmup1_jit(prob, opts.warmup.maxit)
    bk1, tk = 0.5, 2.0

    @jax.jit
    def setup(pr, X, lam, key):
        p, q = pr.p, pr.q
        Z = (-pr.C + 2.0 * X - op.apply_At(lam, p, q)) / tk
        S = jnp.logical_and(Z >= 0, Z <= pr.gama).astype(Z.dtype)
        zeros = jnp.zeros(p.shape[0] + q.shape[0], Z.dtype)
        E, g, kdiag, _, _ = _transform(S, zeros, bk1, tk, zeros, p, q)
        labels, nsp, _, _ = _component_info(E, kdiag)
        f32 = jnp.float32
        gk = (bk1 * jnp.concatenate([q * q, p * p]) + kdiag / tk).astype(f32)
        return setup_hierarchy(E.astype(f32), g.astype(f32),
                               jnp.asarray(1.0 / tk, f32), labels, nsp,
                               opts.amg, key, gk=gk)

    lv1, dense = setup(prob, ws.X, ws.lam, jax.random.PRNGKey(seed + 1))
    return lv1, dense, opts.amg


def smooth_reference(E, g, inv_tk, labels, nsp, r, sweeps: int):
    """f64 NumPy reference of the deflated kernel-projected block
    Gauss-Seidel sweeps (``hierarchy._projected_smooth``, deflated=True,
    with ``bip_matvec`` / ``bip_smooth_apply``)."""
    import numpy as np

    m, n = E.shape
    N = n + m
    xi = nsp.astype(np.float64)
    cnt = np.bincount(labels, weights=xi, minlength=N)
    safe = np.where(cnt > 0, cnt, 1.0)
    e = np.zeros(N)
    for _ in range(sweeps):
        res = r - (g * e - inv_tk * np.concatenate([E.T @ e[n:],
                                                    E @ e[:n]]))
        d1 = res[:n] / g[:n]
        d2 = (res[n:] + inv_tk * (E @ d1)) / g[n:]
        e = e + np.concatenate([d1, d2])
        mean = np.bincount(labels, weights=e * xi, minlength=N) / safe
        e = e - xi * np.where(nsp, mean[labels], 0.0)
    return e


def spmv_rate(rows: int, cap: int, seed: int = 0) -> dict:
    """Marginal time of one ELL SpMV (f32 values, int32 columns) from a
    chain of K products, and its rate over the ELL arrays' bytes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from otamg.sparse.kernels import ell_spmv

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    cols = jax.random.randint(k1, (rows, cap), 0, rows, jnp.int32)
    vals = jax.random.normal(k2, (rows, cap), jnp.float32)
    x = jax.random.normal(k3, (rows,), jnp.float32)
    ref = np.sum(np.asarray(vals, np.float64)
                 * np.asarray(x, np.float64)[np.asarray(cols)], axis=1)
    err = _rel_err(jax.jit(ell_spmv)(cols, vals, x), ref)

    def chain(K):
        @jax.jit
        def run(c, v, x):
            def body(_, x):
                y = ell_spmv(c, v, x)
                return y / jnp.max(jnp.abs(y))

            return jax.lax.fori_loop(0, K, body, x)

        run(cols, vals, x).block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(cols, vals, x).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    k_lo, k_hi = 20, 220
    t = (chain(k_hi) - chain(k_lo)) / (k_hi - k_lo)
    nbytes = rows * cap * 8
    return {"rows": rows, "cap": cap, "rel_err": err, "time_s": t,
            "gbps": nbytes / t / 1e9}


def phase_precision(size: int = 4096, spmv_shapes=((2048, 204),
                                                   (8192, 327)),
                    coarse_target=None) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from otamg.amg import hierarchy as H

    t0 = time.perf_counter()
    lv1, dense, amg = newton_levels(size, coarse_target=coarse_target)
    f64 = np.float64
    E = np.asarray(lv1.E, f64)
    m, n = E.shape
    N = n + m
    rng = np.random.default_rng(0)
    errs = {}

    # Masked dense GEMVs of the fine level.
    v = jnp.asarray(rng.standard_normal(n), jnp.float32)
    w = jnp.asarray(rng.standard_normal(m), jnp.float32)
    Ev, Etw = jax.jit(lambda E, v, w: (H._mm(E, v), H._mm(E.T, w)))(
        lv1.E, v, w)
    errs["gemv_E"] = _rel_err(Ev, E @ np.asarray(v, f64))
    errs["gemv_Et"] = _rel_err(Etw, E.T @ np.asarray(w, f64))

    # Fused bipartite smoother: one pre-smoothing phase from zero, in the
    # deflated form the mixed-precision correction solves run.
    r = jnp.asarray(rng.standard_normal(N), jnp.float32)
    smooth = jax.jit(functools.partial(
        H._projected_smooth_bip, smoth_it=amg.smoth, transpose=False,
        nseg=N, deflated=True, e_is_zero=True))
    got = smooth(lv1, jnp.zeros(N, jnp.float32), r)
    ref = smooth_reference(E, np.asarray(lv1.g, f64),
                           float(lv1.inv_tk), np.asarray(lv1.labels),
                           np.asarray(lv1.nsp), np.asarray(r, f64),
                           amg.smoth)
    errs["smoother"] = _rel_err(got, ref)

    # Galerkin triple product of the first MIS coarsening, P^T (A P).
    A2, P3 = dense[0].A, dense[1].P
    Ac = jax.jit(lambda A, P: H._mm(P.T, H._mm(A, P)))(A2, P3)
    A2h, P3h = np.asarray(A2, f64), np.asarray(P3, f64)
    errs["galerkin"] = _rel_err(Ac, P3h.T @ (A2h @ P3h))

    # Coarsest level: the eigensolve the setup runs (backward error and
    # orthogonality in f64), then the filtered-inverse GEMV pair.
    lc = dense[-1]
    lam, V = jax.jit(jnp.linalg.eigh)(lc.A)
    Ah, lam, V = (np.asarray(a, f64) for a in (lc.A, lam, V))
    errs["eigh_residual"] = float(np.max(np.abs(Ah @ V - V * lam))
                                  / np.max(np.abs(Ah)))
    errs["eigh_orthogonality"] = float(np.max(np.abs(V.T @ V
                                                     - np.eye(len(lam)))))
    rc = jnp.asarray(rng.standard_normal(lc.A.shape[0]), jnp.float32)
    coarse = jax.jit(functools.partial(
        H._coarse_solve, nseg=N, deflated=False, coarse_retol=0.0,
        coarse_maxit=0, coarse_direct=True))
    Vc, ec = np.asarray(lc.evecs, f64), np.asarray(lc.einv, f64)
    errs["coarse_inverse"] = _rel_err(
        coarse(lc, rc), Vc @ (ec * (Vc.T @ np.asarray(rc, f64))))

    spmv = [spmv_rate(rows, cap) for rows, cap in spmv_shapes]
    ok = (max(errs.values()) <= TOL_PRECISION
          and all(s["rel_err"] <= TOL_PRECISION for s in spmv))
    rec = {"size": size, "levels": [m + n] + [int(d.A.shape[0])
                                              for d in dense],
           "precision": "HIGHEST", "tol": TOL_PRECISION,
           "rel_err": errs, "spmv": spmv,
           "seconds": time.perf_counter() - t0}
    emit("precision", ok, **rec)
    return rec


# --------------------------------------------------------------------------
# c. trajectory at 500^2 against the CPU pins
# --------------------------------------------------------------------------


def pin_run(size: int) -> dict:
    """Phase c's two solves with the production options: the pins."""
    import bench

    return {cls: summary(_solve(cls, bench.problem(cls, size),
                                bench.options(cls))[0])
            for cls in ("class1", "class2")}


def print_pins(size: int = 500) -> None:
    """Print the pin dict of :func:`phase_trajectory` (run on the CPU)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    pins = pin_run(size)
    print(json.dumps({cls: {k: s[k] for k in ("iters", "fails",
                                               "objective")}
                      for cls, s in pins.items()}))


def phase_trajectory(size: int = 500, pins=PINS_500) -> dict:
    import numpy as np

    import bench

    rec, ok = {"size": size}, True
    for cls in ("class1", "class2"):
        prob = bench.problem(cls, size)
        res, cold = _solve(cls, prob, bench.options(cls))
        got, pin = summary(res), pins[cls]
        drift = got["iters"] - pin["iters"]
        dobj = abs(got["objective"] - pin["objective"]) / abs(
            pin["objective"])
        rec[cls] = got | {"pin": pin, "iter_drift": drift,
                          "objective_rel_diff": dobj,
                          "cold_s_incl_compile": cold}
        ok &= (got["converged"] and got["fails"] == 0
               and abs(drift) <= MAX_ITER_DRIFT and dobj <= TOL_OBJECTIVE)
        if cls == "class1":
            res2, warm = _solve(cls, prob, bench.options(cls))
            rec["class1"]["warm_s"] = warm
            rec["class1_rerun_bit_identical"] = {
                "iters": int(res2.iters) == int(res.iters),
                "objective": float(res2.fxk[-1]) == float(res.fxk[-1]),
                "plan": bool(np.array_equal(np.asarray(res2.X),
                                            np.asarray(res.X)))}
            f64 = dataclasses.replace(bench.options(cls), solve_dtype=None)
            r64, cold64 = _solve(cls, prob, f64)
            _, warm64 = _solve(cls, prob, f64)
            rec["class1_all_f64"] = summary(r64) | {
                "cold_s_incl_compile": cold64, "warm_s": warm64}
    emit("trajectory", bool(ok), **rec)
    return rec


# --------------------------------------------------------------------------
# d. real size
# --------------------------------------------------------------------------


def cli_solve(argv: list) -> dict:
    """Run ``otamg.cli.main(argv)`` in-process; return its report plus
    the final relative KKT residual read back from its ``--log``."""
    import numpy as np

    from otamg import cli

    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "run.jsonl")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv + ["--log", log])
        seconds = time.perf_counter() - t0
        with open(log) as fh:
            rows = [json.loads(line) for line in fh]
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = [k for k in rows[0] if k.startswith("kkt_")]
    first = np.asarray([rows[0][k] for k in keys])
    last = np.asarray([rows[-1][k] for k in keys])
    return rep | {"rc": rc, "rel_kkt": float(np.max(last / (1 + first))),
                  "cold_s_incl_compile": seconds}


def _peak_bytes(dev):
    """The process's peak device memory so far (the CPU keeps no stats)."""
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in dir(ma) if k.endswith("_in_bytes")}


def phase_real(c1_size: int = 4096, c2_size: int = 2048) -> dict:
    import jax
    import jax.numpy as jnp

    import bench
    from otamg.opt import solve_class1
    from otamg.opt.apd import make_class1_step

    dev = jax.devices()[0]
    rec = {}
    c2 = cli_solve(["class2", "--m", str(c2_size), "--n", str(c2_size),
                    "--seed", "0", "--cycle", "f", "--fuse-deep"])
    rec["class2_cli"] = c2 | {
        "size": c2_size,
        "process_peak_bytes_in_use": _peak_bytes(dev)}
    ok = (c2["rc"] == 0 and c2["converged"] and c2["fail_count"] == 0
          and c2["rel_kkt"] <= KKT_TOL)

    opts = bench.options("class1")
    prob = bench.problem("class1", c1_size)
    t0 = time.perf_counter()
    res = solve_class1(prob, opts, return_state=True)
    cold = time.perf_counter() - t0
    X, V, lam, bk, key = res.state
    step = make_class1_step(prob, opts)
    scalar = jnp.asarray(1.0, X.dtype)
    compiled = step.lower(jnp.asarray(1, jnp.int32), X, V, lam, bk, key,
                          scalar, jnp.stack([scalar, scalar]),
                          prob).compile()
    got = summary(res)
    rec["class1"] = got | {
        "size": c1_size, "cold_s_incl_compile": cold,
        "outer_step_memory": _memory(compiled),
        "process_peak_bytes_in_use": _peak_bytes(dev)}
    ok &= (got["converged"] and got["fails"] == 0
           and got["rel_kkt"] <= KKT_TOL)
    emit("real_size", bool(ok), **rec)
    return rec


# --------------------------------------------------------------------------
# e. four cards
# --------------------------------------------------------------------------


def phase_multichip(size: int = 2048) -> dict:
    import bench

    opts = bench.options("class1")
    prob = bench.problem("class1", size)
    one, t_one = _solve("class1", prob, opts)
    shard = cli_solve(["class1", "--m", str(size), "--n", str(size),
                       "--seed", "0", "--cycle", "f", "--fuse-deep",
                       "--shard"])
    expl, t_expl = _solve("class1", prob,
                          dataclasses.replace(opts, explicit_dist=True))
    runs = {"one_card": summary(one) | {"cold_s_incl_compile": t_one},
            "cli_shard": {k: shard[k] for k in ("converged", "iters",
                                                 "objective", "rel_kkt",
                                                 "cold_s_incl_compile")}
            | {"fails": shard["fail_count"]},
            "explicit_dist": summary(expl) | {"cold_s_incl_compile": t_expl}}
    ref = runs["one_card"]
    ok = True
    for name, r in runs.items():
        r["objective_rel_diff"] = abs(r["objective"] - ref["objective"]) / abs(
            ref["objective"])
        ok &= (r["converged"] and r["iters"] == ref["iters"]
               and r["objective_rel_diff"] <= TOL_OBJECTIVE)
    emit("multichip", bool(ok), size=size, runs=runs)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only phase e, on four cards")
    args = ap.parse_args(argv)

    from otamg.config import enable_compile_cache

    enable_compile_cache()
    import jax

    jax.config.update("jax_enable_x64", True)
    device = phase_device()
    try:
        if args.multichip:
            if device["count"] != 4:
                emit("multichip", False,
                     error=f"needs 4 cards, found {device['count']}")
            phase_multichip()
        else:
            phase_precision()
            phase_trajectory()
            phase_real()
    except SmokeFailure as exc:
        print(exc, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
