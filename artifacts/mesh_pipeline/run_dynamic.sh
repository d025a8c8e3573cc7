#!/bin/bash
# Round-5: dynamic-workload mesh demo (VERDICT r4 next-round item 7) —
# the last untraversed workload x dispatch cell.  Same production mesh
# CLIs as run_mmdopt.sh but --workload dynamic (cut-in scenario, obstacle
# trajectories from the behavioral QP, scenarios.dynamic_cutin), mmd_opt
# at the flagship reduced-set size N=5 + cvar context, 256 configs,
# scenario-sharded shard_map dispatch with psum'd acceptance stats.
#
# Recorded run: 8-device virtual CPU mesh (the multi-chip CI substrate);
# on several GPUs the identical commands run with real cards and
# per-process store shards.
set -ex
cd "$(dirname "$0")/../.."
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=8"

python -m mpc_mmd_tpu.cli.sweep --workload dynamic --costs mmd_opt cvar \
  --noise_levels 0.3 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises beta --num_configs 256 --chunk 32 --dispatch mesh \
  --out artifacts/mesh_pipeline/data_dynamic \
  --metrics artifacts/mesh_pipeline/sweep_metrics_dynamic.jsonl

D=artifacts/mesh_pipeline/data_dynamic/dynamic/beta_noise/noise_30/ts_50
python -m mpc_mmd_tpu.cli.validate --compare --mesh --n_mc 1000 \
  --data $D/mmd_opt_5_samples_6_obs $D/cvar_5_samples_6_obs \
  --out artifacts/mesh_pipeline/stats_dynamic \
  | tee artifacts/mesh_pipeline/validate_dynamic.json
