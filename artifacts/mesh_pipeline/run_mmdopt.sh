#!/bin/bash
# Mesh-pipeline demo with the PAPER'S method (VERDICT r3 item 5): mmd_opt
# — the HBM/latency-critical inner-CEM path — dispatched through the
# production mesh CLIs at a realistic reduced-set size (N=5, the flagship
# acceptance cell's shape, beta 0.3 noise), 256 configs, plus cvar for the
# intersection comparison.  Same three commands as run.sh; the round-3
# demo ran only the cheap proxies (cvar/mmd_random), this closes that gap.
#
# Recorded run: 8-device virtual CPU mesh (the multi-chip CI substrate);
# on several GPUs the identical commands run with real cards and
# per-process store shards.
set -ex
cd "$(dirname "$0")/../.."
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=8"

python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt cvar \
  --noise_levels 0.3 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises beta --num_configs 256 --chunk 32 --dispatch mesh \
  --out artifacts/mesh_pipeline/data_mmdopt \
  --metrics artifacts/mesh_pipeline/sweep_metrics_mmdopt.jsonl

D=artifacts/mesh_pipeline/data_mmdopt/static/beta_noise/noise_30/ts_50
python -m mpc_mmd_tpu.cli.validate --compare --mesh --n_mc 1000 \
  --data $D/mmd_opt_5_samples_6_obs $D/cvar_5_samples_6_obs \
  --out artifacts/mesh_pipeline/stats_mmdopt \
  | tee artifacts/mesh_pipeline/validate_mmdopt.json
