#!/bin/sh
# Scaling-efficiency artifact (BASELINE.md:30): cfg4 (Class-1 1024^2, AMG,
# W-cycle) at 1 / 2 / 4 / 8 virtual CPU devices, one fresh process per
# device count (device count is fixed per-process by XLA_FLAGS).
#
# CAVEAT recorded with the artifact: this machine has 2 physical cores, so
# N virtual devices time-slice those cores — the table measures the
# sharding + collective overhead of the row-partitioned solve (ideal = flat
# wall-clock across N), NOT hardware speedup.  Real scaling needs a real
# slice; the dryrun_multichip entry validates the same shardings compile.
set -u
cd "$(dirname "$0")/.."
OUT=benchmarks/SCALING_cpu.jsonl
: > "$OUT.tmp"
for N in 1 2 4 8; do
  echo "=== scaling sweep: $N device(s) ===" >&2
  JAX_PLATFORMS=cpu \
  XLA_FLAGS="--xla_force_host_platform_device_count=$N" \
  OTAMG_SWEEP_DEVICES=$N \
  timeout 5400 python benchmarks/suite.py --configs 4 >> "$OUT.tmp" 2>benchmarks/scaling_$N.err
  echo "rc=$? for N=$N" >&2
done
mv "$OUT.tmp" "$OUT"
echo "sweep done" >&2
