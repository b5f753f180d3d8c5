"""Structured training/decode metrics: stdout + JSONL sink.

The reference's observability is verbose-print statements and a progress
bar (SURVEY.md §5.5). Here every EM iteration / decode phase can emit a
structured record: wall-clock, samples/s, log-likelihood, sigma, per-neuron
onset rates — to stdout and/or an append-only JSONL file.

Copy of the JAX package's utils/metrics.py without `profile_trace`, whose
profiler annotation waits for the port's tracing slice.
"""

from __future__ import annotations

import json
import time


class MetricsLogger:
    """Append-only JSONL metrics sink with optional stdout echo."""

    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._f = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields):
        rec = {"event": event,
               "t": round(time.perf_counter() - self._t0, 4), **fields}
        line = json.dumps(rec)
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)
        return rec

    def em_iter(self, i: int, ll: float, sigma, lp, elapsed: float,
                n_samples: int):
        import numpy as _np

        sg = _np.asarray(sigma, _np.float64).reshape(-1)
        return self.log(
            "em_iter", iter=i, ll=float(ll),
            sigma=float(sg[0]) if sg.size == 1 else [float(v) for v in sg],
            onset_logp=[float(v) for v in lp], wall_s=round(elapsed, 4),
            samples_per_s=round(n_samples / max(elapsed, 1e-9), 1))

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

