#!/bin/bash
# Second extension: add the B=64 x maxiter_cem=10 outer arm (the next point
# down the budget curve) AND the combined inner+outer arm S=64x12 + B=64x10
# (the smallest budget on the grid) to the 600-config certification.  The
# existing arms resume from their stores; the re-validation joins all
# seven arms on one paired set.
set -ex
cd "$(dirname "$0")/../.."

for LVL in 0.2 0.3; do
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 600 --outer_budget 64x10 \
    --out artifacts/fast/data \
    --metrics artifacts/fast/sweep_metrics.jsonl
  python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
    --noise_levels $LVL --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
    --noises beta --num_configs 600 --inner_budget 64x12 \
    --outer_budget 64x10 \
    --out artifacts/fast/data \
    --metrics artifacts/fast/sweep_metrics.jsonl

  N=$(python -c "print(round($LVL*100))")
  D=artifacts/fast/data/static/beta_noise/noise_$N/ts_50
  python -m mpc_mmd_tpu.cli.validate --compare --n_mc 1000 \
    --data $D/mmd_opt_5_samples_6_obs \
           $D/mmd_opt_B64x14_5_samples_6_obs \
           $D/mmd_opt_B64x12_5_samples_6_obs \
           $D/mmd_opt_B64x10_5_samples_6_obs \
           $D/mmd_opt_S64x12_B64x12_5_samples_6_obs \
           $D/mmd_opt_S64x12_B64x10_5_samples_6_obs \
           $D/cvar_5_samples_6_obs \
    --labels mmd_opt fast64x14 fast64x12 fast64x10 fastrt64x12 fastrt64x10 cvar \
    --out artifacts/fast/stats_cert \
    | tee artifacts/fast/cert_beta${N}_N5.json
done

python artifacts/fast/summarize.py | tee artifacts/fast/pooled.json
