#!/bin/bash
# Round-5 serialized job queue (one device — jobs must not overlap).
# Logs to artifacts/r5_queue.log.  Each stage tolerates failure of the
# previous one (no set -e): sweeps resume from their stores on re-run.
cd "$(dirname "$0")/.."
set -x
date
bash artifacts/fast/run_cert_r5.sh > artifacts/fast/run_cert_r5.log 2>&1
date
bash artifacts/closedloop_discrim/run_matrix_fastrt.sh \
  > artifacts/closedloop_discrim/run_matrix_fastrt.log 2>&1
date
bash artifacts/closedloop_discrim/run_replication_beta.sh \
  > artifacts/closedloop_discrim/run_replication_beta.log 2>&1
date
echo R5_QUEUE_DONE
