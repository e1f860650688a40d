"""otamg — a GPU sparse linear-algebra + optimization framework in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the
reference MATLAB code ``zihang-student/Codes-of-IPD-SsN-AMG-method``
(IPD-SsN-AMG: inexact accelerated primal-dual method with semismooth-Newton
inner solves and algebraic-multigrid linear solvers, for discrete optimal
transport and partial optimal transport).

Layer map (mirrors SURVEY.md section 1, re-designed accelerator-first):

=========  ==========================================  =====================
Layer      Package                                     Reference analogue
=========  ==========================================  =====================
L7 driver  :mod:`otamg.cli`, :mod:`otamg.opt.apd`      Class1/2 demo scripts
L6 outer   :mod:`otamg.opt.apd` (APD + SsN)            inlined outer loops
L5 warm    :mod:`otamg.opt.admm` (A-ADMM)              warmup_class1/2.m
L4 hybrid  :mod:`otamg.hybrid`                         Hybrid_AMG.m et al.
L3 AMG     :mod:`otamg.amg`                            AMG/*.m
L2 Krylov  :mod:`otamg.krylov`                         PCG.m, aug_PCG.m
L1 ops     :mod:`otamg.ot.operators`                   Ax/Aty/ASAt/inv*.m
L0 native  :mod:`otamg.sparse`, :mod:`otamg.native`    MATLAB built-ins
=========  ==========================================  =====================

Design principles (why this is not a port):

* The transport plan lives on an ``(m, n)`` grid; we keep it as a dense
  matrix and express every operator application as batched GEMV/GEMM that
  maps onto dense BLAS.  The Newton system is a bipartite graph Laplacian
  over ``m + n`` nodes whose off-diagonal block is an ``m x n`` masked dense
  matrix — the fine AMG level therefore uses a *structured masked-dense*
  representation (``otamg.amg.hierarchy``) instead of CSR.
* Coarse AMG levels use capacity-padded dense matrices so every level has a
  static shape and the whole multigrid hierarchy (setup + W-cycles) compiles
  into a single XLA program: no host round-trips inside a Newton solve.
* A general padded CSR/COO sparse library (:mod:`otamg.sparse`) covers
  problems whose KKT systems outgrow the dense crossover, plus a C++
  host-side native layer (:mod:`otamg.native`) for the roles MATLAB
  delegated to SuiteSparse (components/ichol/direct solves).
* Multi-chip scaling shards the ``m`` axis of the plan over a
  ``jax.sharding.Mesh`` with ``shard_map`` + ``psum`` collectives
  (:mod:`otamg.dist`); the small KKT vectors stay replicated and coarse
  grids gather below a crossover size.
"""

__version__ = "0.1.0"

from otamg.config import (  # noqa: F401
    AMGOptions,
    APDOptions,
    PCGOptions,
    WarmupOptions,
)
