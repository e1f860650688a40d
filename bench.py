"""Benchmark: Class-1 and Class-2 OT solves to relative KKT <= 1e-6 on one
GPU, through the public ``solve_class1``/``solve_class2`` API.

Run ``python bench.py``.  It prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, ...,
   "device": {...}, "class2": {...}}

Problems are seeded, never loaded (:func:`problem`):
``random_class1(PRNGKey(0), 500, 500)`` and ``random_class2(PRNGKey(0),
500, 500, mu_frac=0.6)``.  Each class is solved once
cold (compile included) and ``WARM_SAMPLES`` times warm; ``value`` is the
warm median.  The reference publishes no timings, so ``vs_baseline`` is
the ratio against a fixed nominal budget of 60 s (> 1.0 is faster).

The benchmark runs on the GPU only: without one it exits non-zero before
any solve.
"""

import json
import statistics
import sys
import time

NOMINAL_BUDGET_S = 60.0
WARM_SAMPLES = 3
SIZE = 500
SEED = 0
# Transported mass as a fraction of the smaller marginal (the CLI's
# default); with a fraction drawn from the key the 500^2 instance stalls
# at relative KKT ~2e-5 even in all-f64.
MU_FRAC = 0.6


def problem(cls: str, size: int = SIZE, seed: int = SEED):
    """The seeded f64 problem of class ``cls`` at ``size`` x ``size``."""
    import jax
    import jax.numpy as jnp

    from otamg.ot import random_class1, random_class2

    key = jax.random.PRNGKey(seed)
    if cls == "class1":
        return random_class1(key, size, size, dtype=jnp.float64)
    return random_class2(key, size, size, dtype=jnp.float64,
                         mu_frac=MU_FRAC)


def options(cls: str):
    """Production options: f64 APD state around the fp32 AMG hierarchy,
    F-cycle, fused deep correction."""
    from otamg.config import AMGOptions, APDOptions, Cycle

    if cls == "class1":
        amg = AMGOptions(cycle=Cycle.F, fuse_deep=True)
        return APDOptions(solve_dtype="float32", amg=amg)
    # Class-2 AMG budget maxit=40/smoth=10 (Class2/APD_SsN_Class2.m:80-81).
    amg = AMGOptions(maxit=40, smoth=10, cycle=Cycle.F, fuse_deep=True)
    return APDOptions(ssn_tol1=1e-10, solve_dtype="float32", amg=amg)


def bench_class(cls: str, device: dict) -> dict:
    from otamg.amg.hierarchy import capacity_schedule
    from otamg.config import Cycle
    from otamg.diag.roofline import roofline_report, solve_bytes_model
    from otamg.opt import solve_class1
    from otamg.opt.apd2 import solve_class2

    opts = options(cls)
    prob = problem(cls)
    solve = solve_class1 if cls == "class1" else solve_class2

    t0 = time.perf_counter()
    res = solve(prob, opts)
    cold_s = time.perf_counter() - t0
    ok = bool(res.converged)
    warm = []
    while ok and len(warm) < WARM_SAMPLES:
        t0 = time.perf_counter()
        res = solve(prob, opts)
        warm.append(time.perf_counter() - t0)
        ok = bool(res.converged)
    value = statistics.median(warm) if ok else float("inf")
    out = {
        "metric": f"{cls}_{SIZE}_time_to_kkt1e-6",
        "value": value,
        "unit": "s",
        "vs_baseline": NOMINAL_BUDGET_S / value if ok else 0.0,
        "converged": ok,
        "iters": int(res.iters),
        "fails": int(res.fail_count),
        "problem": f"random_{cls}(PRNGKey({SEED}), {SIZE}, {SIZE})"
                   + (f", mu_frac={MU_FRAC}" if cls == "class2" else ""),
        "platform": device["platform"],
        "inner": opts.inner_solver.name,
        "driver": "loop",
        "fuse_deep": opts.amg.fuse_deep,
        "cold_s": cold_s,
        "warm_samples": warm,
        "warm_s": min(warm) if ok else None,
        "warm_median_s": value if ok else None,
        "warm_spread": max(warm) / min(warm) if ok else None,
    }
    if ok:
        # Modelled HBM bytes from the solve's own counters over the warm
        # median (a cold time would count compilation as bandwidth).
        m, n = int(prob.p.shape[0]), int(prob.q.shape[0])
        amg = opts.amg
        gamma = {Cycle.V: 1, Cycle.W: 2, Cycle.F: 3}[amg.cycle]
        model_b = solve_bytes_model(
            m, n, int(res.iters), int(res.ssn_itnum.sum()),
            int(res.inner_total), amg.smoth, gamma,
            capacity_schedule(m, m + n, amg), amg.fuse_deep)
        out.update(roofline_report(model_b, value, device["kind"]))
    return out


def main() -> int:
    from otamg.config import enable_compile_cache

    enable_compile_cache()
    import jax

    from otamg.diag.device import gpu_name_power, require_gpu

    jax.config.update("jax_enable_x64", True)
    device = require_gpu()
    device["name_power_limit"] = gpu_name_power()
    out = bench_class("class1", device)
    out["device"] = device
    out["class2"] = bench_class("class2", device)
    print(json.dumps(out), flush=True)
    return 0 if out["converged"] and out["class2"]["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
