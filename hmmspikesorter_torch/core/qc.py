"""Per-unit quality-control metrics for decoded spike trains (a copy of the
JAX package's core/qc.py with its imports pointed at this package; numpy
only).

Beyond-reference capability: the reference emits raw labels and nothing
else, but production sorting pipelines gate units on quality metrics
before analysis (the practice standardized by the Kilosort/phy
ecosystem). This module computes the standard per-unit metrics straight
from a decoded HMMSpikingModel — plus the model-based ones only this
framework can provide (posterior confidence, drift trajectories):

  * spike count and firing rate;
  * ISI statistics and refractory violations. The decode topology
    structurally enforces ISI >= K (a neuron's ring must finish before
    it can re-onset), so violations against a window <= K are an
    internal-consistency invariant — reported separately, always
    against K (`isi_invariant_violations`, always 0 on a healthy
    decode). The headline `isi_violations` uses a PHYSIOLOGICAL
    window: 1.5 ms when `fs` is given (the usual absolute refractory
    period), else K samples — so on real recordings it measures
    contamination, not the invariant;
  * missing-spike mass: the posterior expected onset count
    sum_t P(neuron n onsets at t) minus the decoded count, as a
    fraction — the model-based analog of the amplitude-cutoff
    "fraction missing" metric (spikes the MAP decode rejected but the
    posterior still assigns mass to);
  * SNR: peak template amplitude over the noise SD (best channel for
    multi-channel models);
  * presence ratio: the fraction of time bins containing at least one
    spike — a dying or drifting-away unit shows up here first;
  * posterior confidence summary (core/posterior.spike_confidence) —
    how much forward-backward probability mass backs each MAP spike;
  * drift metrics, when the model came from the adaptive decode
    (train/adaptive.py): per-chunk tracked amplitude trajectory, the
    end-to-start amplitude ratio, and the worst-case template shape
    correlation against the first chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["UnitQC", "unit_qc", "qc_arrays"]


@dataclasses.dataclass
class UnitQC:
    """Quality metrics of one decoded unit (see module docstring)."""

    n_spikes: int
    rate: float                  # spikes/sample, or Hz when fs given
    isi_min: float               # samples (nan when < 2 spikes)
    isi_violations: int          # ISIs < refractory (physiological)
    isi_violation_frac: float
    isi_invariant_violations: int  # ISIs < K — decode invariant, 0 on
    #                              a healthy decode (always computed)
    snr: float                   # peak |template| / noise SD (best chan)
    presence_ratio: float        # fraction of bins with >= 1 spike
    conf_median: float           # nan when confidence not computed
    conf_frac_low: float         # fraction of spikes with conf < 0.5
    missing_mass: float          # est. fraction of spikes missed:
    #                              max(0, E[count] - decoded)/E[count]
    #                              from posterior onset mass (nan when
    #                              posteriors unavailable)
    amp_drift_ratio: float       # tracked last/first amplitude (nan if
    #                              not a drift decode)
    shape_stability: float       # min corr(template_c, template_0)
    amp_trajectory: np.ndarray | None  # (n_chunks,) tracked amplitudes


def _template_amp_snr(mu, sigma, n):
    """(peak amplitude, snr) of unit n; best channel for (K, N, C)."""
    if mu.ndim == 3:
        amps = np.abs(mu[:, n, :]).max(axis=0)           # (C,)
        c = int(np.argmax(amps / np.asarray(sigma)))
        return float(amps[c]), float(amps[c] / np.asarray(sigma)[c])
    a = float(np.abs(mu[:, n]).max())
    return a, a / float(sigma)


def unit_qc(model, *, fs: float | None = None,
            refractory: int | None = None, n_bins: int = 100,
            confidence=None, posteriors=None) -> list[UnitQC]:
    """Per-unit QC metrics for a decoded model (SC or MC, stationary or
    drift-decoded).

    fs: sampling rate — rates become Hz (else spikes/sample).
    refractory: violation window in samples. Defaults to 1.5 ms when
    `fs` is given (a physiological absolute refractory period — the
    window that measures real contamination), else to K. The K-window
    decode invariant is ALWAYS reported separately
    (`isi_invariant_violations`), whatever `refractory` is.
    n_bins: presence-ratio binning — the recording is split into this
    many equal time bins and `presence_ratio` is the fraction
    containing at least one spike (coarser bins are more forgiving of
    bursty units; 100 matches the common ecosystem default).
    confidence: None computes per-spike posterior confidence (from
    `posteriors` when given, else via the windowed fast mode on long
    recordings); False skips it (NaN summaries); or pass the
    precomputed per-unit list to reuse it.
    posteriors: optional precomputed (T, N) onset-posterior grid
    (core/posterior.model_posteriors) — reused for both the confidence
    scores and the missing-spike-mass estimate. When neither
    posteriors nor confidence is available, missing_mass is NaN.
    """
    from .events import _onsets_dense
    from .posterior import confidence_from_posteriors, model_posteriors

    tm = model.template_model
    K = tm.K
    N = tm.n_neurons
    T = len(np.asarray(model.ml_seq))
    if refractory is None:
        refractory = max(1, round(0.0015 * fs)) if fs is not None else K
    onsets = getattr(model, "spike_onsets", None)
    if onsets is None:
        onsets = _onsets_dense(np.asarray(model.ml_seq), N=N, K=K,
                               overlaps=tm.allow_overlaps)
    if posteriors is None and confidence is None:
        # EXACT posteriors at any length: long recordings route to the
        # chained parallel two-pass (drift-decoded models go through
        # their track either way)
        posteriors = model_posteriors(model)
    if confidence is None:
        confidence = confidence_from_posteriors(
            posteriors, onsets, half_width=(K - 1) // 2)
    elif confidence is False:
        confidence = [None] * N

    mu = np.asarray(tm.mu)
    sigma = getattr(tm, "sigmas", None)
    if sigma is None:
        sigma = tm.sigma
    track = getattr(model, "track", None)

    edges = np.linspace(0, T, n_bins + 1)
    out = []
    for n in range(N):
        on = np.sort(np.asarray(onsets[n], np.int64))
        isis = np.diff(on).astype(np.float64)
        viol = int((isis < refractory).sum())
        inv_viol = int((isis < K).sum())
        rate = len(on) / T * (fs if fs is not None else 1.0)
        if posteriors is not None:
            expected = float(np.asarray(posteriors)[:, n].sum())
            miss = (max(0.0, expected - len(on)) / expected
                    if expected > 0 else float("nan"))
        else:
            miss = float("nan")
        _, snr = _template_amp_snr(mu, sigma, n)
        hist, _ = np.histogram(on, bins=edges)
        conf = confidence[n]
        if conf is not None and len(conf):
            conf = np.asarray(conf, np.float64)
            cmed = float(np.median(conf))
            clow = float((conf < 0.5).mean())
        else:
            cmed = clow = float("nan")

        amp_traj = None
        drift_ratio = float("nan")
        stability = float("nan")
        if track is not None:
            mu_t = np.asarray(track.mu)                  # (B, K, ...)
            if track.is_mc:
                amps = np.abs(mu_t[:, :, n, :]).max(axis=1)   # (B, C)
                c = int(np.argmax(amps[0]))
                amp_traj = amps[:, c]
                shapes = mu_t[:, :, n, c]
            else:
                amp_traj = np.abs(mu_t[:, :, n]).max(axis=1)  # (B,)
                shapes = mu_t[:, :, n]
            if amp_traj[0] > 0:
                drift_ratio = float(amp_traj[-1] / amp_traj[0])
            s0 = shapes[0] - shapes[0].mean()
            denom0 = np.linalg.norm(s0)
            corrs = []
            for b in range(1, shapes.shape[0]):
                sb = shapes[b] - shapes[b].mean()
                d = denom0 * np.linalg.norm(sb)
                corrs.append(float(s0 @ sb / d) if d > 0 else np.nan)
            stability = float(np.nanmin(corrs)) if corrs else 1.0

        out.append(UnitQC(
            n_spikes=len(on), rate=float(rate),
            isi_min=float(isis.min()) if len(isis) else float("nan"),
            isi_violations=viol,
            isi_violation_frac=float(viol / max(len(isis), 1)),
            isi_invariant_violations=inv_viol,
            snr=snr,
            presence_ratio=float((hist > 0).mean()),
            conf_median=cmed, conf_frac_low=clow,
            missing_mass=miss,
            amp_drift_ratio=drift_ratio, shape_stability=stability,
            amp_trajectory=amp_traj))
    return out


def qc_arrays(qcs: list[UnitQC]) -> dict:
    """The QC list as a dict of per-unit arrays (MAT-file friendly —
    the CLI's --qc output struct)."""
    scalar_fields = [f.name for f in dataclasses.fields(UnitQC)
                     if f.name != "amp_trajectory"]
    out = {f: np.array([getattr(q, f) for q in qcs]) for f in scalar_fields}
    if qcs and qcs[0].amp_trajectory is not None:
        out["amp_trajectory"] = np.stack(
            [q.amp_trajectory for q in qcs])
    return out
