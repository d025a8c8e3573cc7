"""Metrics, timing, and profiling — absent in the reference (SURVEY.md §5:
prints only; the per-iteration convergence traces are computed in-graph but
discarded by every caller).

Here the solver returns its convergence traces (SolveResult.res / res_2 /
res_beta) and this module gives them somewhere to go: a structured JSONL
metric stream, wall-clock phase timers, and an optional jax.profiler trace
wrapper for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class MetricLogger:
    """Append-only JSONL metric stream (host-0 only under multi-host)."""

    path: Optional[str] = None
    _records: List[Dict[str, Any]] = field(default_factory=list)

    def _is_primary(self) -> bool:
        try:
            import jax
            return jax.process_index() == 0
        except Exception:
            return True

    def log(self, event: str, **fields) -> None:
        rec = {"t": time.time(), "event": event}
        for k, v in fields.items():
            if isinstance(v, (np.ndarray, np.generic)):
                v = np.asarray(v).tolist()
            rec[k] = v
        self._records.append(rec)
        if self.path and self._is_primary():
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def records(self, event: Optional[str] = None):
        if event is None:
            return list(self._records)
        return [r for r in self._records if r["event"] == event]


@contextlib.contextmanager
def phase_timer(logger: MetricLogger, phase: str, **fields):
    """Wall-clock timer for a named phase; logs {"event": "phase", ...}."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log("phase", phase=phase,
                   seconds=time.perf_counter() - t0, **fields)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace wrapper (no-op when log_dir is None)."""
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


def solve_report(result, logger: MetricLogger, **context) -> None:
    """Log a SolveResult's convergence diagnostics."""
    logger.log("solve",
               best_cost=float(np.asarray(result.res)[-1]),
               final_residual=float(np.asarray(result.res_2)[-1]),
               risk_obs=float(np.asarray(result.risk_obs)),
               risk_lane=float(np.asarray(result.risk_lane)),
               cost_trace=np.asarray(result.res),
               **context)
