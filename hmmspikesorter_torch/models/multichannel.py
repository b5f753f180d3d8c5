"""Multi-channel model API (counterpart of the JAX package's
models/multichannel.py).

The reference CLI receives multi-channel templates (`spikeForms` is
(K, nchan, N), src/hmmsort.jl:46-56) and keeps only the first channel.
This module keeps them all: each neuron has a per-channel template, the
observation is the (T, C) multi-electrode trace, and the decode uses the
joint per-channel Gaussian evidence (core/emission_mc.py).

* `HMMTemplateModelMC` — (K, N, C) templates + (C,) noise + onset probs.
* `fit_spiking_model_mc` — whole-signal / chunked Viterbi decode (the
  reference chunk protocol, fit.jl:11-42, through api._chunked_decode).
* `fit_spiking_model_mc_fast` — parallel overlap-save decode, one-shot or
  streaming, dense or events transfer, with seam repair; on a CUDA device
  with overlaps the blocks decode through kernels 11 and 4
  (ops/viterbi_ovn_mb.py).
* `predict_mc` — per-channel reconstruction (a drift-decoded model's each
  chunk under its own templates).
* `fit_spiking_model_adaptive_mc` — drift-adaptive decode: the templates
  tracked through the recording, each chunk decoded under its own
  (train/adaptive.track_drift_mc, decode_tracked_mc).
* `refit_template_model_mc`, `fit_mc` — MC Baum-Welch (train/em_mc.py).

Entry points run on `cuda` unless `device="cpu"` is passed; the working
dtype is float32 on cuda and float64 on the CPU unless `dtype` is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.emission_mc import state_means_mc
from ..core.events import _onsets_dense, decode_events_mc_overlap_save
from ..core.path_score import path_cumulative_ll_mc
from ..core.state_space import StateSpace, build_state_space
from ..ops.ring_viterbi_mc import mc_block_decoder, mc_ring_engine
from ..parallel.overlap_save import (mc_overlap_save,
                                     overlap_save_decode_long)
from ..parallel.seam_repair import repair_seams
from ..utils.device import as_float, numpy_dtype
from .api import (MAX_ONESHOT_BLOCKS, HMMSpikingModel, _all_silent_model,
                  _chunked_decode, _resolve)


@dataclasses.dataclass
class HMMTemplateModelMC:
    """Multi-channel spike-template model.

    mu: (K, N, C) per-channel templates (row 0 = per-channel silence
    contribution); sigmas: (C,) per-channel noise stds; lp: (N,) onset
    log-probs; allow_overlaps controls the decode state space (the
    combined-state topology is channel-independent).
    """

    mu: np.ndarray
    sigmas: np.ndarray
    lp: np.ndarray
    allow_overlaps: bool = False

    def __post_init__(self):
        self.mu = np.asarray(self.mu, dtype=np.float64)
        self.sigmas = np.atleast_1d(np.asarray(self.sigmas,
                                               dtype=np.float64))
        self.lp = np.asarray(self.lp, dtype=np.float64)
        if self.mu.ndim != 3:
            raise ValueError("mu must be (K, N, C)")
        if self.sigmas.shape != (self.mu.shape[2],):
            raise ValueError("sigmas must be (C,) matching mu's channels")

    @property
    def K(self) -> int:
        return self.mu.shape[0]

    @property
    def n_neurons(self) -> int:
        return self.mu.shape[1]

    @property
    def n_channels(self) -> int:
        return self.mu.shape[2]

    @property
    def state_space(self) -> StateSpace:
        return build_state_space(self.n_neurons, self.K, self.allow_overlaps)

    def channel(self, c: int):
        """Single-channel projection of this model (what the reference's
        channel-1-only pipeline would see for c = 0)."""
        from .api import HMMTemplateModel

        return HMMTemplateModel(mu=self.mu[:, :, c],
                                sigma=float(self.sigmas[c]), lp=self.lp,
                                allow_overlaps=self.allow_overlaps)


def _mc_engine_for(templates: HMMTemplateModelMC):
    """The plain whole-signal MC engine of the model's topology
    (non-overlap any N; pairwise-overlap N=2 cross form, any N direct
    form): the one dispatch every MC decode and repair path shares."""
    return mc_ring_engine(templates.n_neurons, templates.allow_overlaps)


def _mc_decoder_for(templates: HMMTemplateModelMC, device, dtype):
    """yy (T, C) host samples -> (labels numpy, ll float)."""
    engine = _mc_engine_for(templates)

    def decode(yy):
        x, ll = engine(yy, templates.lp, templates.mu, templates.sigmas,
                       dtype=dtype, device=device)
        return x.cpu().numpy(), float(ll)

    return decode


def _check_yc(templates, yc):
    yc = np.asarray(yc)
    if yc.ndim != 2 or yc.shape[1] != templates.n_channels:
        raise ValueError(f"yc must be (T, {templates.n_channels})")
    return yc


def fit_spiking_model_mc(templates: HMMTemplateModelMC, yc,
                         chunksize: int | None = None, *, progress=None,
                         device=None, dtype=None) -> HMMSpikingModel:
    """Multi-channel Viterbi MAP decode through the plain engines on
    `device`; chunksize enables the reference's silence-snapping chunk
    protocol (fit.jl:11-42). yc: (T, C)."""
    yc = _check_yc(templates, yc).astype(np.float64)
    if templates.n_neurons == 0:
        return _all_silent_model(templates, yc)
    dev, dt = _resolve(device, dtype)
    decode = _mc_decoder_for(templates, dev, dt)
    if chunksize is None or chunksize >= len(yc):
        x, ll = decode(yc)
        return HMMSpikingModel(templates, x, ll, yc)
    ml_seq, ll = _chunked_decode(yc, decode, chunksize, progress)
    return HMMSpikingModel(templates, ml_seq, ll, yc)


def fit_spiking_model_mc_fast(templates: HMMTemplateModelMC, yc, *,
                              L: int = 8192, H: int | None = None,
                              streaming: bool | None = None,
                              blocks_per_call: int = 256,
                              prefetch: int = 2, repair: bool = True,
                              block_engine: str = "auto",
                              transfer: str = "dense", device=None,
                              dtype=None) -> HMMSpikingModel:
    """Production multi-channel decode: parallel overlap-save
    (parallel/overlap_save.mc_overlap_save) on `device`, automatic seam
    repair, and the telescoped reference ll
    (core/path_score.path_cumulative_ll_mc) on the host. On a CUDA device
    with overlaps and N >= 2 the block decode runs kernels 11 and 4
    (block_engine "auto" or "cuda_ovn"); else the plain engines.

    streaming=None streams recordings longer than MAX_ONESHOT_BLOCKS
    blocks through the host-side block-batch loop (raw (B, W, C) windows go
    to the device and the channel projection runs per batch,
    ops/ring_viterbi_mc.mc_block_decoder); True/False force either path.
    Labels are identical either way.

    transfer="events" copies the packed spike-onset grid to the host
    instead of the dense labels (core/events.py: an exact host rebuild,
    the decoded onsets exposed as model.spike_onsets), on both the one-shot
    and the streaming path."""
    if transfer not in ("dense", "events"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    yc = _check_yc(templates, yc).astype(np.float64)
    if templates.n_neurons == 0:
        return _all_silent_model(templates, yc, transfer=transfer)
    dev, dt = _resolve(device, dtype)
    if H is None:
        H = max(4 * templates.K, 64)
    if len(yc) < L + 2 * H:
        # shorter than one window: exact whole-signal decode, with the fast
        # path's fields
        m = fit_spiking_model_mc(templates, yc, device=dev, dtype=dt)
        m.seam_ok = np.ones(0, bool)
        m.seams_repaired = 0
        m.spike_onsets = (_onsets_dense(np.asarray(m.ml_seq, np.int32),
                                        N=templates.n_neurons, K=templates.K,
                                        overlaps=templates.allow_overlaps)
                          if transfer == "events" else None)
        return m
    if streaming is None:
        streaming = len(yc) > MAX_ONESHOT_BLOCKS * L
    if streaming:
        dec = mc_block_decoder(templates.lp, templates.mu, templates.sigmas,
                               overlaps=templates.allow_overlaps,
                               block_engine=block_engine, device=dev,
                               dtype=dt)
        espec = ((templates.n_neurons, templates.K,
                  templates.allow_overlaps) if transfer == "events" else None)
        x, seam_ok = overlap_save_decode_long(
            yc, L=L, H=H, blocks_per_call=blocks_per_call,
            block_decoder=dec, prefetch=prefetch, device=dev,
            window_dtype=numpy_dtype(dt), event_spec=espec)
        spike_onsets = None
    elif transfer == "events":
        spike_onsets, x, seam_ok = decode_events_mc_overlap_save(
            yc, templates.lp, templates.mu, templates.sigmas, L=L, H=H,
            overlaps=templates.allow_overlaps, block_engine=block_engine,
            device=dev, dtype=dt)
    else:
        x, seam_ok = mc_overlap_save(yc, templates.lp, templates.mu,
                                     templates.sigmas, L=L, H=H,
                                     overlaps=templates.allow_overlaps,
                                     block_engine=block_engine, device=dev,
                                     dtype=dt)
        x, seam_ok = x.cpu().numpy(), seam_ok.cpu().numpy()
        spike_onsets = None
    n_repaired = 0
    if repair and not seam_ok.all():
        failed = (np.nonzero(~seam_ok)[0] + 1) * L
        x, _ = repair_seams(yc, x, failed,
                            _mc_repair_decoder(templates, dev, dt), H=H)
        n_repaired = int((~seam_ok).sum())
        seam_ok = np.ones_like(seam_ok)
        spike_onsets = None          # repair rewrote labels; recompute below
    ll = path_cumulative_ll_mc(yc, x, templates.state_space.states,
                               templates.mu, templates.sigmas, templates.lp)
    model = HMMSpikingModel(templates, x, ll, yc)
    model.seam_ok = seam_ok
    model.seams_repaired = n_repaired
    if spike_onsets is None and transfer == "events":
        spike_onsets = _onsets_dense(x, N=templates.n_neurons, K=templates.K,
                                     overlaps=templates.allow_overlaps)
    model.spike_onsets = spike_onsets
    return model


def _mc_repair_decoder(templates: HMMTemplateModelMC, device, dtype):
    """Seam-repair window decoder (the contract of
    parallel/seam_repair.make_window_decoder): decode(y_win, silent_start)
    -> int64 numpy labels, through the plain MC engine on `device`."""
    engine = _mc_engine_for(templates)

    def decode(y_win, silent_start):
        x, _ = engine(y_win, templates.lp, templates.mu, templates.sigmas,
                      silent_start=silent_start, with_ll=False, dtype=dtype,
                      device=device)
        return x.cpu().numpy()

    return decode


def predict_mc(model: HMMSpikingModel, *, device=None,
               dtype=None) -> np.ndarray:
    """Per-channel reconstruction: the (T, C) denoised signal, the
    C-channel generalisation of reconstruct_signal
    (src/reconstruction.jl:1-9). A drift-decoded model (it carries a
    multichannel `.track`) reconstructs each chunk span with its own
    tracked templates (the api.predict rule)."""
    dev, dt = _resolve(device, dtype)
    tm = model.template_model
    states = tm.state_space.states
    x = np.asarray(model.ml_seq)
    track = getattr(model, "track", None)
    if track is not None and track.is_mc:
        out = np.empty((len(x), tm.n_channels))
        for c, (s, e) in enumerate(track.bounds):
            smu_c = state_means_mc(states, as_float(track.mu[c], dt, dev))
            out[s:e] = smu_c.cpu().numpy()[x[s:e]]
        return out
    smu_c = state_means_mc(states, as_float(tm.mu, dt, dev))
    return smu_c.cpu().numpy()[x]


def refit_template_model_mc(model: HMMTemplateModelMC, yc, nsteps: int, *,
                            verbose: int = 0, fb_mode: str | None = None,
                            device=None, dtype=None) -> HMMTemplateModelMC:
    """Warm-start MC EM from an existing model (the MC mirror of the
    reference fit!, fit.jl:49-52) — also the checkpoint-recovery path:
    load em_mc_latest.npz (utils/checkpoint.load_checkpoint), rebuild the
    HMMTemplateModelMC and continue with this."""
    from ..train.em import EMTables
    from ..train.em_mc import auto_fb_mode_mc, em_chain_mc

    dev, dt = _resolve(device, dtype)
    yc = np.asarray(yc, np.float64)
    K = model.K
    if fb_mode is None:
        fb_mode = auto_fb_mode_mc(len(yc), K, model.n_neurons,
                                  model.n_channels, dev)
    tables = EMTables.build(build_state_space(model.n_neurons, K, False), dev)
    lp, _pi, mu, sg, lls = em_chain_mc(
        as_float(yc, dt, dev), as_float(model.lp, dt, dev),
        as_float(model.mu, dt, dev), as_float(model.sigmas, dt, dev), tables,
        K=K, n_iters=nsteps, fb_mode=fb_mode)
    if verbose > 0:
        print(f"refit_mc: ll {float(lls[0]):.1f} -> {float(lls[-1]):.1f}")
    return HMMTemplateModelMC(mu=mu.cpu().numpy(), sigmas=sg.cpu().numpy(),
                              lp=lp.cpu().numpy(),
                              allow_overlaps=model.allow_overlaps)


def fit_mc(yc, n_neurons: int = 3, K: int = 60, nsteps: int = 10, *,
           device=None, dtype=None, **kwargs) -> HMMSpikingModel:
    """Train (multi-channel Baum-Welch, train/em_mc.train_model_mc) then
    decode — the MC mirror of the reference composite fit (fit.jl:1-4)."""
    from ..train.em_mc import train_model_mc

    yc = np.asarray(yc, dtype=np.float64)
    model, _, _ = train_model_mc(yc, n_neurons=n_neurons, K=K, nsteps=nsteps,
                                 device=device, dtype=dtype, **kwargs)
    return fit_spiking_model_mc(model, yc, device=device, dtype=dtype)


def fit_spiking_model_adaptive_mc(templates: HMMTemplateModelMC, yc, *,
                                  chunk: int = 32768, forget: float = 0.3,
                                  inner_steps: int = 1, H: int | None = None,
                                  repair: bool = True,
                                  fb_mode: str | None = None,
                                  transfer: str = "dense", device=None,
                                  dtype=None) -> HMMSpikingModel:
    """Drift-adaptive joint multichannel decode, the mirror of
    models/api.fit_spiking_model_adaptive: online-EM template tracking over
    (T, C) chunks (train/adaptive.track_drift_mc; kernels 12-13 on the
    card), then every chunk decoded with its own adapted templates
    (train/adaptive.decode_tracked_mc; kernel 11's per-window mode and
    kernel 4). The returned model carries `seam_ok`, `seams_repaired`,
    `spike_onsets` and `track`. With no template left it returns the
    stationary paths' all-silent null model."""
    from ..train.adaptive import decode_tracked_mc, track_drift_mc

    if templates.n_neurons == 0:
        return _all_silent_model(templates, np.asarray(yc, np.float64),
                                 transfer="events")
    dev, dt = _resolve(device, dtype)
    tr = track_drift_mc(templates, yc, chunk=chunk, forget=forget,
                        inner_steps=inner_steps, fb_mode=fb_mode, device=dev,
                        dtype=dt)
    return decode_tracked_mc(tr, yc, H=H, repair=repair, transfer=transfer,
                             device=dev, dtype=dt)
