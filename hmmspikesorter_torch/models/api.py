"""Public decode API (counterpart of the JAX package's models/api.py, decode
half): the reference's StatsBase verbs for a known template model
(src/fit.jl).

* `HMMTemplateModel` — templates + noise + onset probs (reference
  `HMMSpikeTemplateModel`, src/types.jl:15-19).
* `HMMSpikingModel` — a decoded spike train (src/types.jl:21-37).
* `fit_spiking_model` — Viterbi decode, whole-signal or chunked
  (fit.jl:6-9 and the chunked variant fit.jl:11-42), plain engines.
* `fit_spiking_model_fast` — the production decode: parallel overlap-save
  with the CUDA kernels on the card.
* `fit_template_model` — EM training from random templates (fit.jl:44-47
  -> train/em.train_model); `refit_template_model` — warm-start EM
  (fit!, fit.jl:49-52); `fit` — train then decode (fit.jl:1-4). On a CUDA
  device the E-step runs kernels 5-6 (ops/fb_mb.py).
* `predict` — reconstruction (fit.jl:54-56), `bic` (fit.jl:68-72),
  `loglikelihood` (types.jl:32).

Entry points run on `cuda` unless `device="cpu"` is passed; the working
dtype is float32 on cuda and float64 on the CPU unless `dtype` is given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import UNSET, _section, pick
from ..core.path_score import path_cumulative_ll, path_cumulative_ll_mc
from ..core.reconstruction import reconstruct_signal
from ..core.state_space import StateSpace, build_state_space
from ..ops.ring_viterbi import ring_block_decoder, ring_engine
from ..parallel.overlap_save import (overlap_save_decode_long,
                                     resolve_block_engine, ring_overlap_save)
from ..parallel.seam_repair import make_window_decoder, repair_seams
from ..train.em import TrainResult, _em_phase, train_model
from ..utils.device import as_float, default_dtype, numpy_dtype, resolve_device

# Past this many overlap-save blocks the fast path streams fixed-size window
# batches (the JAX package's compile-time bound; here it bounds the
# one-shot batch's device memory the same way).
MAX_ONESHOT_BLOCKS = 256


@dataclasses.dataclass
class HMMTemplateModel:
    """Spike-template model (reference HMMSpikeTemplateModel).

    mu: (K, N) templates (row 0 = silence); sigma: noise std; lp: (N,) onset
    log-probs; allow_overlaps controls the decode state space (the
    reference decodes the CLI path with overlaps on, hmmsort.jl:57).
    """

    mu: np.ndarray
    sigma: float
    lp: np.ndarray
    allow_overlaps: bool = False
    pi: np.ndarray | None = None

    def __post_init__(self):
        self.mu = np.asarray(self.mu, dtype=np.float64)
        self.lp = np.asarray(self.lp, dtype=np.float64)

    @property
    def K(self) -> int:
        return self.mu.shape[0]

    @property
    def n_neurons(self) -> int:
        return self.mu.shape[1]

    @property
    def state_space(self) -> StateSpace:
        return build_state_space(self.n_neurons, self.K, self.allow_overlaps)


@dataclasses.dataclass
class HMMSpikingModel:
    """A decoded spike train (reference HMMSpikingModel, types.jl:21-37)."""

    template_model: HMMTemplateModel
    ml_seq: np.ndarray  # (T,) int decoded combined-state sequence (0-based)
    ll: float           # reference's cumulative-score sum (viterbi.jl:92-96)
    y: np.ndarray       # the decoded signal

    @property
    def loglikelihood(self) -> float:
        return self.ll


def _resolve(device, dtype):
    dev = resolve_device(device)
    return dev, (default_dtype(dev) if dtype is None else dtype)


def fit_template_model(
    y,
    n_neurons: int | None = None,
    K: int | None = None,
    nsteps: int | None = None,
    *,
    rng: np.random.Generator | None = None,
    verbose: int = 0,
    config=None,
    device=None,
    dtype=None,
    **kwargs,
) -> HMMTemplateModel:
    """EM-train a template model (reference fit.jl:44-47 -> train_model).

    A config supplies defaults for anything not passed explicitly (this
    entry point's nsteps default is 10, vs train_model's reference 8 —
    kept when neither the kwarg nor the config sets it)."""
    if nsteps is None and (config is None or config.train is None
                           or config.train.nsteps is None):
        nsteps = 10
    res: TrainResult = train_model(
        y, n_neurons, K, nsteps, rng=rng, verbose=verbose, config=config,
        device=device, dtype=dtype, **kwargs)
    return HMMTemplateModel(mu=res.mu, sigma=res.sigma, lp=res.lp, pi=res.pi)


def refit_template_model(model: HMMTemplateModel, y, nsteps: int, *,
                         verbose: int = 0, device=None,
                         dtype=None) -> HMMTemplateModel:
    """Warm-start EM from an existing model (reference fit! at
    fit.jl:49-52)."""
    dev, dt = _resolve(device, dtype)
    lp, pi, mu, sigma, _ = _em_phase(
        np.asarray(y, np.float64), model.lp, model.mu, model.sigma, nsteps,
        model.K, dtype=dt, device=dev, verbose=verbose)
    return HMMTemplateModel(mu=mu, sigma=sigma, lp=lp, pi=pi,
                            allow_overlaps=model.allow_overlaps)


def _all_silent_model(templates, y) -> HMMSpikingModel:
    """Degenerate pure-noise decode for n_neurons == 0 (training can prune
    every template; the reference CLI returns a null model,
    hmmsort.jl:40-45). ll keeps the cumulative-score contract through the
    telescoped path score; a (T, C) recording takes the multi-channel score
    with the model's per-channel sigmas."""
    y = np.asarray(y)
    x = np.zeros(len(y), np.int32)
    states = templates.state_space.states
    if y.ndim == 2:
        ll = path_cumulative_ll_mc(y, x, states, templates.mu,
                                   templates.sigmas, templates.lp)
    else:
        ll = path_cumulative_ll(y, x, states, templates.mu,
                                float(templates.sigma), templates.lp)
    model = HMMSpikingModel(templates, x, float(ll), y)
    model.seam_ok = np.ones(0, bool)
    model.seams_repaired = 0
    model.spike_onsets = None
    return model


def fit_spiking_model(templates: HMMTemplateModel, y, chunksize=UNSET, *,
                      progress=None, config=None, device=None,
                      dtype=None) -> HMMSpikingModel:
    """Viterbi MAP decode (reference fit.jl:6-9; chunked: fit.jl:11-42)
    through the plain ring engines on `device`.

    chunksize resolution: explicit kwarg (None = whole-signal) > the
    config's decode.chunksize > whole-signal. The chunked variant
    reproduces the reference's silence-snapping protocol exactly, the
    accumulation of whole-chunk scores into `ll` included (fit.jl:37).
    """
    dev, dt = _resolve(device, dtype)
    dc = _section(config, "decode")
    chunksize = pick(chunksize, dc("chunksize"), None)
    y = np.asarray(y, dtype=np.float64)
    if templates.n_neurons == 0:
        return _all_silent_model(templates, y)
    decode = _decoder_for(templates, dev, dt)
    if chunksize is None or chunksize >= len(y):
        x, ll = decode(y)
        return HMMSpikingModel(templates, x, ll, y)
    ml_seq, ll = _chunked_decode(y, decode, chunksize, progress)
    return HMMSpikingModel(templates, ml_seq, ll, y)


def _chunked_decode(y, decode, chunksize, progress=None):
    """The reference's silence-snapping chunk loop (fit.jl:11-42). y's
    leading axis is time; decode maps a time slice to (labels, ll)."""
    n = len(y)
    ml_seq = np.zeros(n, dtype=np.int64)  # 0 == all-silent
    ll = 0.0
    i = 0
    while i < n - 1:
        j = min(i + chunksize, n)
        x, _ll = decode(y[i:j])
        x = np.asarray(x)
        l = 0
        if i > 0:  # skip a non-silent prefix: we must start from silence
            while l < len(x) and x[l] > 0:
                l += 1
        if j < n:  # retract the right edge back to the last silent state
            k = len(x)
            while k > l and x[k - 1] > 0:
                k -= 1
                j -= 1
        else:
            k = len(x)
        if j <= i:
            raise RuntimeError(
                f"chunk [{i}, {j + (len(x) - k)}) contains no silent state to "
                "snap to; increase chunksize")
        ml_seq[i + l: j] = x[l:k]
        ll += float(_ll)
        i = j
        if progress is not None:
            progress(i, n)
    return ml_seq, ll


def _decoder_for(templates: HMMTemplateModel, device, dtype):
    """yy (host samples) -> (labels numpy, ll float) via the ring engine of
    the model's topology (nov, ov2 or ovn)."""
    engine = ring_engine(templates.n_neurons, templates.allow_overlaps)
    mu_t = as_float(templates.mu, dtype, device)
    lp, sigma = templates.lp, templates.sigma

    def decode(yy):
        x, ll = engine(as_float(yy, dtype, device), lp, mu_t, sigma)
        return x.cpu().numpy(), float(ll)

    return decode


def fit_spiking_model_fast(templates: HMMTemplateModel, y, *,
                           L: int | None = None,
                           H: int | None = None,
                           streaming: bool | None = None,
                           blocks_per_call: int | None = None,
                           prefetch: int | None = None,
                           repair: bool | None = None,
                           block_engine: str | None = None,
                           transfer: str | None = None,
                           config=None, device=None,
                           dtype=None) -> HMMSpikingModel:
    """Production decode: parallel overlap-save on `device`
    (parallel/overlap_save.ring_overlap_save). On a CUDA device with
    overlaps the block decode runs hand-written kernels: kernels 1-2 for
    N=2 (block_engine "auto" or "cuda"), kernels 3-4 for N >= 3 ("auto" or
    "cuda_ovn"; N=3 and N=4 at K <= 65); else the plain ring engines
    (nov, ov2 or ovn by topology).

    streaming=True uses the host-side block-batch loop
    (overlap_save_decode_long, the CLI's route): batches of
    `blocks_per_call` windows, `prefetch` of them in flight. streaming=None
    streams recordings longer than MAX_ONESHOT_BLOCKS blocks. Labels are
    identical either way (same windows, same seam protocol).

    Integer recordings (int16 ADC data) ship raw and are cast on the
    device; float32 of an int16 is exact. The reference's cumulative-score
    ll (src/viterbi.jl:92-96) comes from the O(T) telescoped path score
    (core/path_score.py) on the host. repair=True (default) re-decodes any
    seam that found no common silence (parallel/seam_repair.py);
    `seam_ok` reflects the post-repair state, `seams_repaired` counts the
    flagged seams.

    transfer="events" (the sparse onset transfer, core/events.py) belongs
    to a later slice and raises NotImplementedError.
    """
    dev, dt = _resolve(device, dtype)
    dc = _section(config, "decode")

    def arg(v, field, default):
        return pick(UNSET if v is None else v, dc(field), default)

    L = arg(L, "L", 8192)
    H = arg(H, "H", None)
    streaming = arg(streaming, "streaming", None)
    blocks_per_call = arg(blocks_per_call, "blocks_per_call", 256)
    prefetch = arg(prefetch, "prefetch", 2)
    repair = arg(repair, "repair", True)
    block_engine = arg(block_engine, "block_engine", "auto")
    transfer = arg(transfer, "transfer", "dense")
    if transfer not in ("dense", "events"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if transfer == "events":
        raise NotImplementedError(
            "transfer='events' needs core/events.py (ROADMAP §1 step 6), "
            "which a later slice of the port adds")

    y_raw = np.asarray(y)
    int_input = np.issubdtype(y_raw.dtype, np.integer)
    y = y_raw.astype(np.float64)
    if templates.n_neurons == 0:
        return _all_silent_model(templates, y)
    if H is None:
        H = max(4 * templates.K, 64)
    if streaming is None:
        streaming = len(y) > MAX_ONESHOT_BLOCKS * L
    if streaming and len(y) < L + 2 * H:
        streaming = False          # shorter than one window: decode one-shot
    y_dev = y_raw if int_input else y
    if streaming:
        block_engine = resolve_block_engine(
            block_engine, templates.allow_overlaps, templates.K,
            templates.n_neurons, dev)
        dec = ring_block_decoder(templates.lp, templates.mu, templates.sigma,
                                 overlaps=templates.allow_overlaps,
                                 block_engine=block_engine, device=dev,
                                 dtype=dt)
        x, seam_ok = overlap_save_decode_long(
            y_dev, L=L, H=H, blocks_per_call=blocks_per_call,
            block_decoder=dec, prefetch=prefetch, device=dev,
            window_dtype=y_raw.dtype if int_input else numpy_dtype(dt))
    else:
        x, seam_ok = ring_overlap_save(
            y_dev, templates.lp, templates.mu, templates.sigma, L=L, H=H,
            overlaps=templates.allow_overlaps, block_engine=block_engine,
            device=dev, dtype=dt)
        x, seam_ok = x.cpu().numpy(), seam_ok.cpu().numpy()
    n_repaired = 0
    if repair and not seam_ok.all():
        dec = make_window_decoder(templates.lp, templates.mu,
                                  templates.sigma,
                                  overlaps=templates.allow_overlaps,
                                  device=dev, dtype=dt)
        failed = (np.nonzero(~seam_ok)[0] + 1) * L
        x, _ = repair_seams(y, x, failed, dec, H=H)
        n_repaired = int((~seam_ok).sum())
        seam_ok = np.ones_like(seam_ok)
    ll = path_cumulative_ll(y, x, templates.state_space.states,
                            templates.mu, templates.sigma, templates.lp)
    model = HMMSpikingModel(templates, x, ll, y)
    model.seam_ok = seam_ok
    model.seams_repaired = n_repaired
    model.spike_onsets = None
    return model


def fit(y, n_neurons: int = 3, K: int = 60, nsteps: int = 10, *,
        device=None, dtype=None, **kwargs) -> HMMSpikingModel:
    """Train then decode (reference composite fit, fit.jl:1-4)."""
    templates = fit_template_model(y, n_neurons, K, nsteps, device=device,
                                   dtype=dtype, **kwargs)
    return fit_spiking_model(templates, y, device=device, dtype=dtype)


def predict(model: HMMSpikingModel, *, device=None,
            dtype=None) -> np.ndarray:
    """Reconstructed (denoised) signal (reference fit.jl:54-56)."""
    dev, dt = _resolve(device, dtype)
    tm = model.template_model
    return reconstruct_signal(model.ml_seq, tm.state_space.states,
                              as_float(tm.mu, dt, dev)).cpu().numpy()


def loglikelihood(model: HMMSpikingModel) -> float:
    return model.ll


def bic(model: HMMSpikingModel) -> float:
    """log(n)*k - 2*ll with k = |mu| + 1 + N (reference fit.jl:68-72)."""
    tm = model.template_model
    k = tm.mu.size + 1 + tm.n_neurons
    return math.log(len(model.ml_seq)) * k - 2.0 * model.ll


def model_response(model: HMMSpikingModel) -> np.ndarray:
    """The raw decoded signal (reference model_response, src/types.jl:33)."""
    return model.y
