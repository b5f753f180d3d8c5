"""Spike extraction and unit export (counterpart of the JAX package's
io/extraction.py; reference src/extraction.jl).

A neuron's spike time is every sample where the decoded combined state has
that neuron at the ring position of its template trough (argmin of the
template's active rows), i.e. the spike's alignment point — the documented
intent of the reference's `extract_spiketimes`, whose Julia-0.6 builtins
are dead on Julia 1.x.

Unit files follow the reference's MAT contract (src/extraction.jl:26-36):
filename pattern ``g%03dc%02d_spiketrain.mat`` and keys ``timestamps`` /
``sampling_rate`` / ``waveform``, plus ``confidence`` when asked for.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io

DEFAULT_SAMPLING_RATE = 40000.0  # reference src/extraction.jl:26


def unroll_mlseq(ml_seq, states) -> np.ndarray:
    """(n_neurons, T) per-neuron ring positions (reference
    src/extraction.jl:4-13). The CLI writes `unroll_mlseq(...) + 1` as its
    `mlseq` output (1 == silent, types.jl:150)."""
    states = np.asarray(states)
    return states[:, np.asarray(ml_seq)]


def _trough_waveform(mu: np.ndarray, i: int) -> np.ndarray:
    """(K,) alignment waveform of neuron i: the template itself for (K, N)
    models, the largest-peak-to-peak channel's for (K, N, C) models."""
    mu = np.asarray(mu)
    if mu.ndim == 2:
        return mu[:, i]
    c = int(np.argmax(np.ptp(mu[:, i, :], axis=0)))
    return mu[:, i, c]


def _trough_index(mu: np.ndarray, i: int) -> int:
    """Ring position of neuron i's alignment trough, restricted to the
    ACTIVE rows 1..K-1 (row 0 is the silent baseline)."""
    return 1 + int(np.argmin(_trough_waveform(mu, i)[1:]))


def extract_spiketimes(model) -> list[np.ndarray]:
    """Per-neuron spike sample indices (reference src/extraction.jl:15-24)
    of a decoded model."""
    tm = model.template_model
    rolled = unroll_mlseq(model.ml_seq, tm.state_space.states)
    return [np.nonzero(rolled[i] == _trough_index(tm.mu, i))[0]
            for i in range(tm.n_neurons)]


def extract_spiketimes_from_onsets(onsets, mu, x0: int = 0, *,
                                   T: int) -> list[np.ndarray]:
    """Spike timestamps straight from decoded onsets, no label sequence.

    The trough-aligned timestamp of a spike with onset o is
    ``o + argmin(waveform) - 1`` (the neuron reaches ring position k at
    sample o + k - 1). ``x0`` seeds a spike already in progress at sample 0
    (its onset lies before the recording); timestamps are clipped to
    [0, T). Equals extract_spiketimes(model) exactly."""
    from ..core.events import phase_of

    mu = np.asarray(mu)
    N = mu.shape[1]
    K = mu.shape[0]
    out = []
    for i in range(N):
        qidx = _trough_index(mu, i)
        ts = np.asarray(onsets[i], np.int64) + qidx - 1
        p0 = int(phase_of(np.asarray([int(x0)]), i, N, K, True)[0])
        if p0 > 1:                       # mid-spike at t=0: onset at 1-p0
            ts = np.concatenate([[qidx - p0], ts])
        out.append(ts[(ts >= 0) & (ts < T)])
    return out


def extract_units(model, channel: int, *,
                  sampling_rate: float = DEFAULT_SAMPLING_RATE,
                  with_confidence: bool = False,
                  confidence_kwargs: dict | None = None) -> dict:
    """Unit dicts keyed by the reference's filename pattern
    (src/extraction.jl:26-36).

    with_confidence=True adds a per-spike posterior 'confidence' array to
    each unit (core/posterior.spike_confidence), aligned with the
    timestamps through each spike's onset: a spike already in progress at
    sample 0 has a trough but no in-recording onset (NaN); a final spike
    whose trough falls past the recording end has no timestamp (dropped).
    confidence_kwargs go to spike_confidence (e.g. device="cpu", or
    windowed=True)."""
    tm = model.template_model
    pidx = extract_spiketimes(model)
    confs = onsets = None
    if with_confidence:
        from ..core.events import _onsets_dense
        from ..core.posterior import spike_confidence

        confs = spike_confidence(model, **(confidence_kwargs or {}))
        onsets = getattr(model, "spike_onsets", None)
        if onsets is None:                 # the list spike_confidence used
            onsets = _onsets_dense(np.asarray(model.ml_seq),
                                   N=tm.n_neurons, K=tm.K,
                                   overlaps=tm.allow_overlaps)
    units = {}
    for i, ts in enumerate(pidx):
        name = "g%03dc%02d_spiketrain.mat" % (channel, i + 1)
        units[name] = {
            "timestamps": ts,
            "sampling_rate": sampling_rate,
            "waveform": tm.mu[:, i],
        }
        if confs is not None:
            # timestamp = onset + trough - 1: match each timestamp back to
            # its onset
            on_exp = np.asarray(ts, np.int64) - (_trough_index(tm.mu, i) - 1)
            src = np.asarray(onsets[i], np.int64)
            conf_ts = np.full(len(ts), np.nan)
            if len(src):
                pos = np.searchsorted(src, on_exp)
                ok = (pos < len(src)) & (
                    src[np.minimum(pos, len(src) - 1)] == on_exp)
                conf_ts[ok] = np.asarray(confs[i])[pos[ok]]
            units[name]["confidence"] = conf_ts
    return units


def save_units(units: dict, outdir: str = "sorted") -> None:
    """Write one MAT file per unit (reference src/extraction.jl:38-42)."""
    os.makedirs(outdir, exist_ok=True)
    for name, payload in units.items():
        scipy.io.savemat(os.path.join(outdir, name), payload)


def load_unit(fname: str) -> dict:
    """Read a unit MAT file (reference src/extraction.jl:44-46)."""
    return scipy.io.loadmat(fname, squeeze_me=True)
