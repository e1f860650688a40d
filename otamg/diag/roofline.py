"""End-to-end roofline accounting for the OT solves.

A bytes-moved model of the WHOLE solve, assembled from the solver's own
iteration counters (outer iterations, SsN steps, AMG cycles) and the
static hierarchy shape, divided by measured wall time.  The model counts the principal
HBM array traffic:

* **Fine-level smoothing** — the dominant operator.  The fused bipartite
  smoother reads ``E`` twice per sweep (``hierarchy.py::
  _projected_smooth_bip``); each cycle runs 2 phases x ``smoth`` sweeps
  plus ~2 extra E-passes (residual matvec + restriction/prolongation
  touching E through W).
* **Deep-level traffic** — per cycle, each dense-level visit moves its
  ``cap^2`` operator a fixed number of times; visit counts are taken
  from the REAL cycle tape (``hierarchy._gen_tape``), so V/W/F
  differences are exact.  With ``fuse_deep`` the per-cycle deep traffic
  collapses to one ``cap1^2`` GEMV and the tape traversal is paid once
  per Newton solve (the D build, GEMM-batched).
* **Setup** — per Newton solve: building ``E`` from the active set,
  ideal interpolation, Galerkin chain (~a few passes over ``E`` and
  each ``cap^2``).
* **Outer O(mn) work** — the APD/SsN dual-space operator applications,
  prox, merit and KKT reductions, modelled as a fixed number of
  ``m*n``-sized passes per outer / per SsN iteration (counted from
  ``opt/apd.py``: ~8 passes/outer for updates+KKT, ~12 passes/SsN for
  Z / active set / F / line search).

The model is a principal-traffic LOWER bound (index arrays, small
vectors, and scalar fetches are ignored), so ``roofline_frac`` is an
honest efficiency claim, not an upper-bound flatter.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence


class DevicePeaks(NamedTuple):
    hbm_gbps: float       # HBM bandwidth, GB/s
    bf16_tflops: float    # dense bf16 tensor-core rate
    fp32_tflops: float    # fp32 outside the tensor cores
    power_w: float        # board power the rates assume


# Published peaks keyed by ``jax.Device.device_kind``.  Source: NVIDIA
# H100 Tensor Core GPU data sheet (dense rates, without sparsity).
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(3350.0, 989.0, 67.0, 700.0),
    "NVIDIA H100 PCIe": DevicePeaks(2000.0, 756.0, 51.0, 350.0),
}


def device_peaks(device_kind: str) -> DevicePeaks:
    """Peaks of ``device_kind``; a device not in :data:`PEAKS` raises."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to PEAKS") from None

# O(mn)-pass coefficients (counted from otamg/opt/apd.py; see module
# docstring).  Plan/dual state is f64 (8 B) in the production config.
_OUTER_MN_PASSES = 8
_SSN_MN_PASSES = 12
# Per-visit dense-level operator passes: pre+post smoothing phases read
# A twice per sweep via matvec+apply, plus residual/transfer touches.
_DENSE_VISIT_PASSES = lambda smoth: 2 * smoth * 2 + 4
_FINE_CYCLE_PASSES = lambda smoth: 2 * smoth * 2 + 2


def _deep_tape_visits(num_dense: int, gamma: int) -> dict[int, int]:
    """Per-dense-level smoothing-visit counts of one cycle, from the
    real tape (level 1..num_dense; the coarsest solve is 2 GEMVs on the
    last cap and is counted like a visit for simplicity)."""
    from otamg.amg.hierarchy import _gen_tape

    visits: dict[int, int] = {}
    for kind, lvl in _gen_tape(num_dense + 1, gamma):
        if kind in ("pre", "coarse") and lvl >= 1:
            visits[lvl] = visits.get(lvl, 0) + 1
    return visits


def solve_bytes_model(m: int, n: int, iters: int, ssn_total: int,
                      cycles_total: int, smoth: int, gamma: int,
                      caps: Sequence[int], fuse_deep: bool,
                      plan_itemsize: int = 8,
                      solve_itemsize: int = 4) -> float:
    """Modelled HBM bytes moved by one end-to-end solve.

    ``caps`` is the dense-level capacity schedule
    (``hierarchy.capacity_schedule``); ``cycles_total`` the summed AMG
    cycle count over all Newton solves (``SolveResult.inner_total``);
    ``ssn_total`` the summed SsN iterations (= number of Newton solves,
    each with one setup).
    """
    mn = m * n
    E_bytes = mn * solve_itemsize
    newton_solves = ssn_total

    # Fine-level smoothing traffic per cycle.
    fine = cycles_total * _FINE_CYCLE_PASSES(smoth) * E_bytes

    # Deep-level traffic.
    visits = _deep_tape_visits(len(caps), gamma)
    tape_bytes = sum(v * _DENSE_VISIT_PASSES(smoth)
                     * caps[l - 1] ** 2 * solve_itemsize
                     for l, v in visits.items())
    if fuse_deep and len(caps) >= 2:
        # One D GEMV per cycle + the algebraic build per Newton solve
        # (closed-form GEMM composition: ~smoth phase-power GEMMs + ~10
        # composition GEMMs per level, each touching ~cap^2 operands).
        build_bytes = ((smoth + 10) * sum(c * c for c in caps)
                       * solve_itemsize)
        deep = (cycles_total * caps[0] ** 2 * solve_itemsize
                + newton_solves * build_bytes)
    else:
        deep = cycles_total * tape_bytes

    # Setup per Newton solve: E assembly from the active set (read mn
    # f64 mask, write E), ideal interpolation + level-2 Galerkin
    # (GEMM-bound; ~4 E passes), deep Galerkin chain (~6 passes over
    # each cap^2) + coarse eigendecomposition (flop-bound, ~2 passes).
    setup = newton_solves * (
        (mn * plan_itemsize + 5 * E_bytes)
        + 8 * sum(c * c for c in caps) * solve_itemsize)

    # Outer O(mn) dual-space work (f64).
    outer = ((iters * _OUTER_MN_PASSES + ssn_total * _SSN_MN_PASSES)
             * mn * plan_itemsize)

    return float(fine + deep + setup + outer)


def roofline_report(model_bytes: float, wall_s: float,
                    device_kind: str) -> dict:
    """GB/s and fraction of ``device_kind``'s HBM roofline for a measured
    wall time."""
    peak = device_peaks(device_kind).hbm_gbps
    gbps = model_bytes / wall_s / 1e9 if wall_s > 0 else 0.0
    return {
        "model_bytes": model_bytes,
        "model_gbps": gbps,
        "roofline_frac": gbps / peak,
    }
