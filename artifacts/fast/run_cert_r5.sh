#!/bin/bash
# Round-5 certification broadening: the
# promoted combined budget fastrt64x10 (outer B=64 x maxiter_cem=10 +
# inner S=64 x 12) was certified on exactly two static beta cells; this
# adds (a) a gaussian static cell (noise 0.1, N=5 — the shape bench.py
# headlines) and (b) a dynamic-workload cell (beta 0.3, N=5, cut-in
# scenario), each with the same paired-MC protocol: 600-config sweeps per
# arm with identical scenario seeds, intersection join, 1000-MC paired
# validation, Wilcoxon + bootstrap CI per pair.
set -x
cd "$(dirname "$0")/../.."

# ---- cell 3: gaussian 0.1, N=5, static ---------------------------------
python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
  --noise_levels 0.1 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises gaussian --num_configs 600 --out artifacts/fast/data \
  --metrics artifacts/fast/sweep_metrics.jsonl
python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt \
  --noise_levels 0.1 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises gaussian --num_configs 600 --outer_budget 64x10 \
  --inner_budget 64x12 --out artifacts/fast/data \
  --metrics artifacts/fast/sweep_metrics.jsonl
python -m mpc_mmd_tpu.cli.sweep --workload static --costs cvar \
  --noise_levels 0.1 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises gaussian --num_configs 600 --out artifacts/fast/data \
  --metrics artifacts/fast/sweep_metrics.jsonl

D=artifacts/fast/data/static/gaussian_noise/noise_10/ts_50
python -m mpc_mmd_tpu.cli.validate --compare --n_mc 1000 \
  --data $D/mmd_opt_5_samples_6_obs \
         $D/mmd_opt_S64x12_B64x10_5_samples_6_obs \
         $D/cvar_5_samples_6_obs \
  --labels mmd_opt fastrt64x10 cvar \
  --out artifacts/fast/stats_cert \
  | tee artifacts/fast/cert_gauss10_N5.json

# ---- cell 4: dynamic workload, beta 0.3, N=5 ---------------------------
python -m mpc_mmd_tpu.cli.sweep --workload dynamic --costs mmd_opt \
  --noise_levels 0.3 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises beta --num_configs 600 --out artifacts/fast/data \
  --metrics artifacts/fast/sweep_metrics.jsonl
python -m mpc_mmd_tpu.cli.sweep --workload dynamic --costs mmd_opt \
  --noise_levels 0.3 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises beta --num_configs 600 --outer_budget 64x10 \
  --inner_budget 64x12 --out artifacts/fast/data \
  --metrics artifacts/fast/sweep_metrics.jsonl
python -m mpc_mmd_tpu.cli.sweep --workload dynamic --costs cvar \
  --noise_levels 0.3 --num_reduced_sets 5 --num_obs 6 --num_prime 50 \
  --noises beta --num_configs 600 --out artifacts/fast/data \
  --metrics artifacts/fast/sweep_metrics.jsonl

DD=artifacts/fast/data/dynamic/beta_noise/noise_30/ts_50
python -m mpc_mmd_tpu.cli.validate --compare --n_mc 1000 \
  --data $DD/mmd_opt_5_samples_6_obs \
         $DD/mmd_opt_S64x12_B64x10_5_samples_6_obs \
         $DD/cvar_5_samples_6_obs \
  --labels mmd_opt fastrt64x10 cvar \
  --out artifacts/fast/stats_cert_dyn \
  | tee artifacts/fast/cert_dyn_beta30_N5.json
