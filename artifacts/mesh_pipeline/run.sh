#!/bin/bash
# Multi-device pipeline demo (BASELINE config 5's shape, end to end):
# a 1024-config sweep dispatched as a scenario-sharded shard_map over the
# device mesh, mesh-sharded 1000-MC intersection validation, paired
# Wilcoxon stats, and the grid box-plot figure — three commands, the same
# ones a multi-GPU run uses (there the mesh is real cards, and on several
# hosts each runs the sweep with its own process_id; the store's
# per-process shards and the chunk-ownership convention make that a no-op
# change).
#
# Recorded run: 8-device virtual CPU mesh (this repo's CI substrate),
# cvar vs mmd_random (the two fast risk modes — mmd_opt's inner CEM at
# 1024 configs is an accelerator job, see artifacts/acceptance/ for its
# quality evidence).
set -ex
cd "$(dirname "$0")/../.."
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=8"

python -m mpc_mmd_tpu.cli.sweep --workload static --costs cvar mmd_random \
  --noise_levels 0.1 --num_reduced_sets 10 --num_obs 6 --num_prime 50 \
  --noises gaussian --num_configs 1024 --chunk 64 --dispatch mesh \
  --out artifacts/mesh_pipeline/data \
  --metrics artifacts/mesh_pipeline/sweep_metrics.jsonl

python -m mpc_mmd_tpu.cli.validate --compare --mesh --n_mc 1000 \
  --data artifacts/mesh_pipeline/data/static/gaussian_noise/noise_10/ts_50/cvar_10_samples_6_obs \
         artifacts/mesh_pipeline/data/static/gaussian_noise/noise_10/ts_50/mmd_random_10_samples_6_obs \
  --out artifacts/mesh_pipeline/stats_meshdemo \
  | tee artifacts/mesh_pipeline/validate_out.json

python -m mpc_mmd_tpu.cli.report grid \
  --stats_root artifacts/mesh_pipeline/stats_meshdemo \
  --noise gaussian --noise_levels 0.1 --num_reduced_sets 10 \
  --num_obs 6 --num_prime 50 --modes mmd_random cvar \
  --out artifacts/mesh_pipeline/grid_meshdemo.png
