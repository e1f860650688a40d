"""Command-line driver: the reference demo scripts as a real CLI.

Usage::

    python -m otamg.cli class1 [--mat PATH | --m M --n N] [--inner amg]
    python -m otamg.cli class2 [--mat PATH | --m M --n N] [--mu-frac F]
    python -m otamg.cli info

Replaces the reference's edit-the-script configuration
(``Class1/APD_SsN_Class1.m:35-36,66-71``) with flags; per-iteration
records go to ``--log`` (JSONL) and the reference's three diagnostic
panels to ``--plot`` (PNG).
"""

from __future__ import annotations

import argparse
import json
import sys


def _common(sub):
    sub.add_argument("--mat", help=".mat fixture path (reference format)")
    sub.add_argument("--m", type=int, default=128)
    sub.add_argument("--n", type=int, default=128)
    sub.add_argument("--inner", default="amg",
                     choices=["direct", "pcg", "aug_pcg", "amg", "twogrid"])
    sub.add_argument("--maxit", type=int, default=100)
    sub.add_argument("--kkt-tol", type=float, default=1e-6)
    sub.add_argument("--seed", type=int, default=0)
    sub.add_argument("--cycle", default="w", choices=["v", "w", "f"],
                     help="AMG cycle: w = reference W-cycle (default), "
                          "v = V-cycle, f = F-cycle (W's revisit "
                          "structure with V revisits — linear-in-depth "
                          "visit tape with the reference W's "
                          "trajectories at every tested size; the bench "
                          "uses f)")
    sub.add_argument("--fuse-deep", action="store_true",
                     help="apply the AMG levels below the fine one as "
                          "one precomputed matrix per Newton solve (one "
                          "GEMV per cycle; the bench configuration)")
    sub.add_argument("--fp32", action="store_true",
                     help="force fp32 storage (not recommended; the "
                          "accelerator default is f64 state + fp32 "
                          "solver)")
    sub.add_argument("--solve-dtype", default=None,
                     help="inner-solver dtype (float32 selects the mixed-"
                          "precision AMG path; default: float32 on an "
                          "accelerator, the problem dtype on the CPU)")
    sub.add_argument("--driver", default="loop",
                     choices=["loop", "chunked", "fused"],
                     help="loop: one host dispatch per APD iteration "
                          "(logging/checkpoint); chunked/fused are "
                          "trajectory-identical drivers with one "
                          "dispatch per chunk / per solve (fused has no "
                          "checkpoint support)")
    sub.add_argument("--chunk", type=int, default=8,
                     help="iterations per dispatch for --driver chunked")
    sub.add_argument("--log", help="JSONL per-iteration record path")
    sub.add_argument("--plot", help="PNG plot prefix")
    sub.add_argument("--checkpoint", help="checkpoint directory (orbax)")
    sub.add_argument("--resume", action="store_true",
                     help="resume from the latest checkpoint in "
                          "--checkpoint (loop and chunked drivers)")
    sub.add_argument("--verbose", "-v", action="store_true")
    sub.add_argument("--coordinator",
                     help="multi-host: coordinator address host:port for "
                          "jax.distributed.initialize (or set "
                          "OTAMG_COORDINATOR); every process runs the same "
                          "command")
    sub.add_argument("--num-processes", type=int,
                     help="multi-host: total process count (or "
                          "OTAMG_NUM_PROCESSES)")
    sub.add_argument("--process-id", type=int,
                     help="multi-host: this process's index (or "
                          "OTAMG_PROCESS_ID)")
    sub.add_argument("--shard", action="store_true",
                     help="row-block shard the problem over all (global) "
                          "devices before solving")
    sub.add_argument("--feas-polish", action="store_true",
                     help="class2: enable the feasibility-polish tail "
                          "safeguard (projection onto {Hu=b} when only "
                          "the feasibility residual stalls; re-measured "
                          "honestly)")
    sub.add_argument("--profile",
                     help="capture a jax.profiler trace of the solve into "
                          "this directory (view in TensorBoard/Perfetto)")


def _setup_jax(args):
    import jax

    # Multi-host initialization must precede any other JAX use.
    from otamg.dist import init_multihost

    if init_multihost(getattr(args, "coordinator", None),
                      getattr(args, "num_processes", None),
                      getattr(args, "process_id", None)):
        print(f"multi-host: process {jax.process_index()}/"
              f"{jax.process_count()}, {len(jax.devices())} global / "
              f"{len(jax.local_devices())} local devices", file=sys.stderr)

    if not args.fp32:
        jax.config.update("jax_enable_x64", True)
    from otamg.config import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    return jnp.float32 if args.fp32 else jnp.float64


def _opts(args, class2=False):
    from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver

    inner = InnerSolver[args.inner.upper()]
    ssn_tol1 = 1e-10 if class2 else 1e-11
    import jax

    if args.fp32:
        ssn_tol1 = max(ssn_tol1, 1e-7)  # fp32-storage floor
    solve_dtype = args.solve_dtype
    if solve_dtype is None and jax.default_backend() != "cpu":
        # Accelerator: f64 APD state around the fp32 AMG hierarchy with
        # f64 iterative refinement (hybrid/solver.py::build_he_solver).
        # The CPU keeps the reference's all-f64 precision.
        solve_dtype = "float32"
    cycle = Cycle[getattr(args, "cycle", "w").upper()]
    fuse_deep = getattr(args, "fuse_deep", False)
    # Class-2 AMG budget: maxit 40, smoth 10 (Class2/APD_SsN_Class2.m:80-81)
    amg = (AMGOptions(maxit=40, smoth=10, cycle=cycle, fuse_deep=fuse_deep)
           if class2 else AMGOptions(cycle=cycle, fuse_deep=fuse_deep))
    return APDOptions(maxit=args.maxit, kkt_tol=args.kkt_tol,
                      inner_solver=inner, ssn_tol1=ssn_tol1,
                      seed=args.seed, solve_dtype=solve_dtype, amg=amg,
                      feas_polish=getattr(args, "feas_polish", False))


def _maybe_profile(args):
    """``--profile DIR``: capture a jax.profiler trace around the solve."""
    import contextlib

    if not getattr(args, "profile", None):
        return contextlib.nullcontext()
    from otamg.diag.profiling import trace

    print(f"profiling to {args.profile}", file=sys.stderr)
    return trace(args.profile)


def cmd_class1(args) -> int:
    dtype = _setup_jax(args)
    import jax

    from otamg.diag.metrics import plot_run, solver_report
    from otamg.opt import (solve_class1, solve_class1_chunked,
                           solve_class1_fused)
    from otamg.ot import load_class1_mat, random_class1

    if args.mat:
        prob = load_class1_mat(args.mat, dtype=dtype)
    else:
        prob = random_class1(jax.random.PRNGKey(args.seed), args.m, args.n,
                             dtype=dtype)
    if args.shard:
        from otamg.dist import make_mesh, shard_class1

        prob = shard_class1(prob, make_mesh())
    if args.checkpoint and args.driver == "fused":
        print("warning: --checkpoint is ignored with --driver fused (the "
              "whole solve is one device program); use loop (per-"
              "iteration) or chunked (per-chunk)", file=sys.stderr)
    with _maybe_profile(args):
        if args.driver == "chunked":
            res = solve_class1_chunked(prob, _opts(args), chunk=args.chunk,
                                       verbose=args.verbose,
                                       checkpoint_dir=args.checkpoint,
                                       resume=args.resume)
        elif args.driver == "fused":
            res = solve_class1_fused(prob, _opts(args))
        else:
            res = solve_class1(prob, _opts(args), verbose=args.verbose,
                               checkpoint_dir=args.checkpoint,
                               resume=args.resume)
    rep = solver_report(res)
    print(json.dumps(rep))
    if args.log:
        from otamg.diag.metrics import RunLog

        log = RunLog(args.log)
        for k in range(len(res.kkt_x)):
            log.log(it=k, kkt_x=float(res.kkt_x[k]),
                    kkt_l=float(res.kkt_l[k]), fxk=float(res.fxk[k]))
        log.close()
    if args.plot:
        for p in plot_run(res, args.plot):
            print(f"wrote {p}", file=sys.stderr)
    if args.checkpoint:
        from otamg.diag.checkpoint import save_result

        save_result(args.checkpoint, res)
    return 0 if res.converged else 1


def cmd_class2(args) -> int:
    dtype = _setup_jax(args)
    import jax

    from otamg.diag.metrics import plot_run, solver_report
    from otamg.opt.apd2 import (solve_class2, solve_class2_chunked,
                                solve_class2_fused)
    from otamg.ot import load_class2_mat, random_class2

    if args.mat:
        prob = load_class2_mat(args.mat, dtype=dtype)
    else:
        prob = random_class2(jax.random.PRNGKey(args.seed), args.m, args.n,
                             dtype=dtype, mu_frac=args.mu_frac)
    if args.shard:
        from otamg.dist import make_mesh, shard_class2

        prob = shard_class2(prob, make_mesh())
    if args.checkpoint and args.driver == "fused":
        print("warning: --checkpoint is ignored with --driver fused (the "
              "whole solve is one device program); use loop (per-"
              "iteration) or chunked (per-chunk)", file=sys.stderr)
    with _maybe_profile(args):
        if args.driver == "chunked":
            res = solve_class2_chunked(prob, _opts(args, class2=True),
                                       chunk=args.chunk,
                                       verbose=args.verbose,
                                       checkpoint_dir=args.checkpoint,
                                       resume=args.resume)
        elif args.driver == "fused":
            res = solve_class2_fused(prob, _opts(args, class2=True))
        else:
            res = solve_class2(prob, _opts(args, class2=True),
                               verbose=args.verbose,
                               checkpoint_dir=args.checkpoint,
                               resume=args.resume)
    rep = solver_report(res)
    print(json.dumps(rep))
    if args.log:
        from otamg.diag.metrics import RunLog

        log = RunLog(args.log)
        for k in range(res.kkt.shape[0]):
            log.log(it=k, kkt_x=float(res.kkt[k, 0]),
                    kkt_y=float(res.kkt[k, 1]), kkt_z=float(res.kkt[k, 2]),
                    kkt_l=float(res.kkt[k, 3]), fxk=float(res.fxk[k]))
        log.close()
    if args.plot:
        for p in plot_run(res, args.plot):
            print(f"wrote {p}", file=sys.stderr)
    return 0 if res.converged else 1


def cmd_info(args) -> int:
    import jax

    import otamg

    print(json.dumps({
        "version": otamg.__version__,
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "native": __import__("otamg.native", fromlist=["available"])
        .available(),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="otamg")
    subs = ap.add_subparsers(dest="cmd", required=True)
    s1 = subs.add_parser("class1", help="OT / assignment / capacitated")
    _common(s1)
    s2 = subs.add_parser("class2", help="partial OT")
    _common(s2)
    s2.add_argument("--mu-frac", type=float, default=0.6)
    subs.add_parser("info", help="environment report")
    args = ap.parse_args(argv)
    return {"class1": cmd_class1, "class2": cmd_class2,
            "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
