#!/bin/bash
# Realtime operating-point certification.
#
# The inner-CEM budget S=100x20 iterations is the reference's tuning
# choice (compute_beta.py:14-15) and dominates the mmd_opt solve.
# This script proves the trade quality-neutral on the two DISCRIMINATING
# acceptance cells (beta noise, N=5 reduced set — where mmd_opt's
# advantage over cvar concentrates): 200-config sweeps per budget +
# cvar, scenario-intersection join, 1000-MC paired validation, Wilcoxon
# + bootstrap CI per pair.
set -ex
cd "$(dirname "$0")/../.."

for LVL in 0.2 0.3; do
  # default-budget mmd_opt, two reduced budgets, and cvar for context
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --out artifacts/realtime/data \
    --metrics artifacts/realtime/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --inner_budget 64x12 \
    --out artifacts/realtime/data \
    --metrics artifacts/realtime/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --inner_budget 48x8 \
    --out artifacts/realtime/data \
    --metrics artifacts/realtime/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs cvar \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 200 --out artifacts/realtime/data \
    --metrics artifacts/realtime/sweep_metrics.jsonl

  N=$(python -c "print(round($LVL*100))")
  D=artifacts/realtime/data/static/beta_noise/noise_$N/ts_50
  # 4-way join: budget family vs each other AND vs cvar, same scenarios
  python -m mpc_mmd_tpu.cli.validate --compare --n_mc 1000 \
    --data $D/mmd_opt_5_samples_6_obs \
           $D/mmd_opt_S64x12_5_samples_6_obs \
           $D/mmd_opt_S48x8_5_samples_6_obs \
           $D/cvar_5_samples_6_obs \
    --labels mmd_opt rt64x12 rt48x8 cvar \
    --out artifacts/realtime/stats_cert \
    | tee artifacts/realtime/cert_beta${N}_N5.json
done
