"""Distribution layer: mesh construction and sharding rules (SURVEY.md
section 2.3's accelerator parallelism mapping).

The reference is entirely serial; the scaling dimension of this framework
is the plan size ``m x n`` (SURVEY.md section 5.7).  The sharding design:

* the ``(m, n)`` plan ``X``, cost ``C``, capacity ``Gama``, active-set
  masks and the bipartite edge matrix ``E`` are **row-block sharded** over
  a 1-D mesh axis ``"x"`` (the p/m side), ``p`` sharded alike;
* the ``(n + m)`` KKT/dual vectors are **replicated** — they are tiny
  compared to the plan, and every operator application reduces over the
  sharded axis (``X^T p``) with an XLA ``psum`` over the interconnect;
* AMG coarse grids below the crossover (everything from level 2 down:
  dense ``m x m`` and smaller) are gathered/replicated — the classic
  coarse-grid agglomeration.

We express this through ``jax.sharding.NamedSharding`` constraints and let
the XLA SPMD partitioner insert the collectives, per the scaling-book
recipe: pick a mesh, annotate shardings, let XLA work.  ``shard_map`` is
reserved for the explicit-collective paths (:mod:`otamg.dist.spmv`,
:mod:`otamg.dist.assembly`).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from otamg.ot.problems import Class1Problem, Class2Problem


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = "x") -> Mesh:
    """1-D device mesh over the plan's row axis.

    After :func:`init_multihost`, ``jax.devices()`` spans every process's
    devices, so the same mesh construction scales from one chip to a
    multi-host cluster: the row-block sharding keeps each block's
    collective partners on the fast links within a host and lets only the
    ``psum`` reductions cross the network between hosts."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Initialize ``jax.distributed`` for multi-host execution (SURVEY.md
    section 2.3: single process -> multi-host via
    ``jax.distributed.initialize``).

    Arguments fall back to ``OTAMG_COORDINATOR`` / ``OTAMG_NUM_PROCESSES``
    / ``OTAMG_PROCESS_ID`` environment variables (so launchers that only
    control the environment work), and to JAX's own auto-detection for
    ``None`` fields.  Returns False (no-op) when no coordinator is
    configured — the single-process path.  Call before any other JAX use.
    """
    import os

    coordinator = coordinator or os.environ.get("OTAMG_COORDINATOR")
    if coordinator is None:
        return False
    if num_processes is None and "OTAMG_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["OTAMG_NUM_PROCESSES"])
    if process_id is None and "OTAMG_PROCESS_ID" in os.environ:
        process_id = int(os.environ["OTAMG_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def plan_sharding(mesh: Mesh, axis_name: str = "x") -> NamedSharding:
    """Sharding of ``(m, n)`` plan-shaped arrays: row blocks."""
    return NamedSharding(mesh, P(axis_name, None))


def row_sharding(mesh: Mesh, axis_name: str = "x") -> NamedSharding:
    """Sharding of ``(m,)`` row-marginal arrays."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_class1(prob: Class1Problem, mesh: Mesh,
                 axis_name: str = "x") -> Class1Problem:
    """Place a Class-1 problem on the mesh: plan-shaped arrays row-block
    sharded, marginals on their natural axes, duals replicated."""
    ps = plan_sharding(mesh, axis_name)
    rs = row_sharding(mesh, axis_name)
    rep = replicated(mesh)
    gama = prob.gama
    if getattr(gama, "ndim", 0) == 2:
        gama = jax.device_put(gama, ps)
    else:
        gama = jax.device_put(gama, rep)
    return Class1Problem(
        C=jax.device_put(prob.C, ps),
        r=jax.device_put(prob.r, rep),
        l=jax.device_put(prob.l, rs),
        p=jax.device_put(prob.p, rs),
        q=jax.device_put(prob.q, rep),
        gama=gama)


def shard_class2(prob: Class2Problem, mesh: Mesh,
                 axis_name: str = "x") -> Class2Problem:
    ps = plan_sharding(mesh, axis_name)
    rs = row_sharding(mesh, axis_name)
    rep = replicated(mesh)
    return Class2Problem(
        C=jax.device_put(prob.C, ps),
        r=jax.device_put(prob.r, rep),
        l=jax.device_put(prob.l, rs),
        p=jax.device_put(prob.p, rs),
        q=jax.device_put(prob.q, rep),
        Phi=jax.device_put(prob.Phi, ps),
        mu=jax.device_put(prob.mu, rep))
