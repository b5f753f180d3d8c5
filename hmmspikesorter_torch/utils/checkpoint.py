"""EM training checkpoint/resume.

The reference has no training persistence at all — EM state lives in locals
and is lost on interruption (SURVEY.md §5.4); only *results* are saved. The
model state is tiny ((K, N) templates + (N,) onset log-probs + scalars), so
we checkpoint every iteration as a single .npz plus a JSON sidecar of
metadata — recovery is "load and continue" (train.em.train_model accepts a
resume point via its warm-start path, models.api.refit_template_model).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def save_checkpoint(path: str, *, lp, mu, sigma, em_iter: int, phase: str,
                    ll_history=None, extra: dict | None = None) -> None:
    """Atomically write a training checkpoint (.npz + .json sidecar)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "em_iter": int(em_iter),
        "phase": phase,
        "n_neurons": int(np.asarray(mu).shape[1]),
        "K": int(np.asarray(mu).shape[0]),
        "ll_history": list(map(float, ll_history or [])),
        **(extra or {}),
    }
    d = os.path.dirname(path) or "."
    # metadata travels INSIDE the npz so a crash between file writes can
    # never pair new weights with stale metadata; the .json sidecar is a
    # human-readable convenience derived from the same dict
    tmp = None
    try:
        with tempfile.NamedTemporaryFile(dir=d, suffix=".npz",
                                         delete=False) as f:
            # sigma: scalar (single-channel) or (C,) per-channel noise (MC)
            np.savez(f, lp=np.asarray(lp), mu=np.asarray(mu),
                     sigma=np.asarray(sigma, np.float64),
                     meta_json=np.asarray(json.dumps(meta)))
            tmp = f.name
        os.replace(tmp, path)
        tmp = None
    finally:
        if tmp is not None:
            os.unlink(tmp)
    tmp = None
    try:
        with tempfile.NamedTemporaryFile("w", dir=d, suffix=".json",
                                         delete=False) as f:
            json.dump(meta, f)
            tmp = f.name
        os.replace(tmp, path + ".json")
        tmp = None
    finally:
        if tmp is not None:
            os.unlink(tmp)


def load_checkpoint(path: str):
    """Returns (state dict with lp/mu/sigma, metadata dict). sigma is a
    float for single-channel checkpoints, a (C,) array for multi-channel
    ones."""
    z = np.load(path)
    sg = np.asarray(z["sigma"])
    state = {"lp": z["lp"], "mu": z["mu"],
             "sigma": float(sg) if sg.ndim == 0 else sg}
    if "meta_json" in z:                 # authoritative: same atomic file
        meta = json.loads(str(z["meta_json"]))
    else:                                # older checkpoints: the sidecar
        meta_path = path + ".json"
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
    return state, meta
