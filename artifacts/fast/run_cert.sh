#!/bin/bash
# Outer-CEM budget ("fast" operating point) certification.
#
# The outer budget num_batch=100 x maxiter_cem=20 is the reference's tuning
# constant, not spec (synthetic_static_obs/optimizer/cem.py:88-89,137-140).
# This script proves (or refutes) quality-neutrality of the candidate
# budgets on the two discriminating acceptance cells (beta noise, N=5
# reduced set) with the same protocol as the realtime-preset cert
# (../realtime/run_cert.sh): 200-config sweeps per arm + cvar context,
# scenario-intersection join, 1000-MC paired validation, Wilcoxon +
# bootstrap CI per pair.
set -ex
cd "$(dirname "$0")/../.."

for LVL in 0.2 0.3; do
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --out artifacts/fast/data \
    --metrics artifacts/fast/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --outer_budget 64x14 \
    --out artifacts/fast/data \
    --metrics artifacts/fast/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --outer_budget 64x12 \
    --out artifacts/fast/data \
    --metrics artifacts/fast/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs cvar \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --out artifacts/fast/data \
    --metrics artifacts/fast/sweep_metrics.jsonl

  N=$(python -c "print(round($LVL*100))")
  D=artifacts/fast/data/static/beta_noise/noise_$N/ts_50
  python -m mpc_mmd_tpu.cli.validate --compare --n_mc 1000 \
    --data $D/mmd_opt_5_samples_6_obs \
           $D/mmd_opt_B64x14_5_samples_6_obs \
           $D/mmd_opt_B64x12_5_samples_6_obs \
           $D/cvar_5_samples_6_obs \
    --labels mmd_opt fast64x14 fast64x12 cvar \
    --out artifacts/fast/stats_cert \
    | tee artifacts/fast/cert_beta${N}_N5.json
done
