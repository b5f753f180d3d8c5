"""Drift-adaptive template tracking: online EM with exponential forgetting,
then a decode with each chunk's own templates (counterpart of the JAX
package's train/adaptive.py).

Real recordings drift: electrode micro-motion changes spike amplitudes and
shapes over minutes, so one stationary template set mis-scores early or
late spikes. The templates are tracked THROUGH the recording with stepwise
online EM (sufficient-statistic blending, the Cappe-Moulines scheme):

    for each chunk c (length Tc):
        s_c  <- em_chunk_stats(y_c; theta_{c-1}) / Tc        E-step
        sbar <- (1 - forget) * sbar + forget * s_c           blend
        theta_c <- M-step(sbar)                              train/em.py

The statistics are linear-space per-state sums (train/em.em_chunk_stats),
so the convex blend is exact, and the M-step (train/em._m_step_from_stats)
is scale-invariant. `forget` sets the memory horizon (~chunk/forget
samples). The E-step runs on the training ladder: kernels 5-6
("overlap_cuda") on the card where the chunk admits them, the "ring" loops
on the CPU.

`decode_tracked` then decodes every overlap-save window under the
templates of its own chunk (window = chunk): on the card the N=2 overlap
topology runs kernel 16 (ops/viterbi_mb.ov2_forward_mb_tracked, each
window's constants in its own row) and kernel 2, N >= 3 kernels 3 and 4
window by window; the non-overlap topology runs the plain engine window by
window, as the JAX package runs its vmapped XLA scan there. Seams are
silence-snapped as in the stationary decode (state 0 means "no template
playing" under any parameters), and a flagged seam is re-decoded with its
left chunk's parameters (parallel/seam_repair.py).

The multichannel mirror, `track_drift_mc` and `decode_tracked_mc`, tracks
per-channel templates over a (T, C) recording (kernels 12-13 for the
E-step on the card) and decodes every window under its chunk's emission
tables in one launch of kernel 11's per-window mode and one of kernel 4.

decode_tracked(transfer="events") copies one packed onset blob instead of
the dense labels (core/events.py). Entry points run on `cuda` unless
`device="cpu"` is passed; the working dtype is float32 on cuda and float64
on the CPU unless `dtype` is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state_space import build_state_space, n_states
from ..utils.device import as_float, default_dtype, resolve_device
from .em import EMTables, _m_step_from_stats, choose_fb_mode, em_chunk_stats

__all__ = ["DriftTrack", "track_drift", "track_drift_batched",
           "decode_tracked", "track_drift_mc", "decode_tracked_mc"]


@dataclasses.dataclass
class DriftTrack:
    """Per-chunk parameter trajectory from track_drift.

    lp (B, N), mu (B, K, N), sigma (B,): the parameters in force after
    each chunk's update; lls (B,): each chunk's predictive log-likelihood
    under the PRE-update parameters (a drift monitor: a persistent drop
    means the model is falling behind the drift); bounds: the (start, end)
    sample span of each chunk. A multichannel track (track_drift_mc) carries
    mu (B, K, N, C) and sigma (B, C); `is_mc` tells them apart."""

    lp: np.ndarray
    mu: np.ndarray
    sigma: np.ndarray
    lls: np.ndarray
    bounds: list[tuple[int, int]]
    chunk: int
    forget: float
    allow_overlaps: bool

    @property
    def n_chunks(self) -> int:
        return len(self.bounds)

    @property
    def is_mc(self) -> bool:
        return self.mu.ndim == 4

    def model_at(self, c: int):
        """The template model in force for chunk c (decode topology from the
        tracked model)."""
        if self.is_mc:
            from ..models.multichannel import HMMTemplateModelMC

            return HMMTemplateModelMC(self.mu[c], self.sigma[c], self.lp[c],
                                      allow_overlaps=self.allow_overlaps)
        from ..models.api import HMMTemplateModel

        return HMMTemplateModel(self.mu[c], float(self.sigma[c]), self.lp[c],
                                allow_overlaps=self.allow_overlaps)


def _auto_fb_mode(K: int, N: int, Tc: int, device) -> tuple[str, int]:
    """(fb_mode, block) of one chunk's E-step: train/em.choose_fb_mode
    applied to the chunk length — "ring" on the CPU, as the JAX package
    gives there; on the card kernels 5-6 ("overlap_cuda") where
    em_kernel_ok and the chunk covers two kernel windows, else "overlap"
    or "blocked"."""
    mode = choose_fb_mode(torch.device(device), K, N, Tc)
    return mode, (2048 if mode in ("overlap", "overlap_cuda") else 256)


def _chunk_modes(fb_mode, block, K, N, Tc, device):
    if fb_mode is None:
        mode, blk = _auto_fb_mode(K, N, Tc, device)
    else:
        mode, blk = fb_mode, 256
    return mode, (block if block is not None else blk)


def _m_step(sbar, tables, dtype, device, K, N):
    """M-step from blended statistics (cast to the working dtype)."""
    s = [as_float(v, dtype, device) for v in sbar]
    return _m_step_from_stats(s[0], s[1], s[2], torch.log(s[3]),
                              torch.log(s[4]), tables.states, dtype, K, N)


def _track_loop(y_blocks, lp, mu, sg, forget, *, stats_fn, m_step,
                inner_steps):
    """The full-chunk online-EM loop on the device, free of host syncs (the
    JAX `_track_scan`): y_blocks (n, chunk[, C]). stats_fn(y_c, lp, mu, sg)
    -> (G1, Gy, Gy2, X, Xd, ll) and m_step(sbar) -> (lp, mu, sg) are the
    single-channel or the multichannel pair (the JAX `kind`). The blend runs
    on the device in the working dtype (float32 on the card, as the JAX
    device loop blends in its working dtype). Returns the per-chunk (lp, mu,
    sg, ll) stacked on the device and the final blended statistics."""
    Tc = y_blocks.shape[1]
    sbar = None
    traj = []
    for y_c in y_blocks:
        ll0 = None
        for _ in range(inner_steps):
            G1, Gy, Gy2, X, Xd, ll = stats_fn(y_c, lp, mu, sg)
            s_c = [v.to(mu.dtype) / Tc for v in (G1, Gy, Gy2, X, Xd)]
            sbar = s_c if sbar is None else [
                (1.0 - forget) * a + forget * b for a, b in zip(sbar, s_c)]
            lp, mu, sg = m_step(sbar)
            ll0 = ll if ll0 is None else ll0    # predictive: pre-update
        traj.append((lp, mu, sg, ll0.to(mu.dtype)))
    return [torch.stack(v) for v in zip(*traj)], sbar


def track_drift(templates, y, *, chunk: int = 32768, forget: float = 0.3,
                inner_steps: int = 1, fb_mode: str | None = None,
                block: int | None = None, callback=None,
                device_loop: bool | None = None, device=None,
                dtype=None) -> DriftTrack:
    """Track drifting templates through `y` with online EM.

    templates: the starting HMMTemplateModel; y: (T,) signal. Chunks are a
    fixed grid of `chunk` samples (the decode windows of decode_tracked); a
    tail chunk shorter than max(4K, 256) inherits the previous parameters
    instead of updating. inner_steps > 1 re-blends each chunk that many
    times. callback(c, lp, mu, sigma, ll) observes each update.

    device_loop (None = auto: on for a CUDA device without a callback) runs
    the full-chunk sequence on the device with no per-chunk host round
    trip, blending in the working dtype; the host loop (the CPU, callbacks,
    the ragged tail) blends in float64 on the host, as the JAX package's
    host loop does. Training statistics use the non-overlap topology (the
    reference's training space); the decode topology of the returned track
    follows templates.allow_overlaps."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError("track_drift takes a (T,) trace")
    K, N = templates.K, templates.n_neurons
    if N == 0:
        raise ValueError("track_drift needs at least one template")
    if not 0.0 < forget <= 1.0:
        raise ValueError("forget must be in (0, 1]")
    T = y.shape[0]
    chunk = int(min(chunk, T))
    if chunk < 2:
        raise ValueError("chunk must be >= 2")
    inner = max(1, inner_steps)

    tables = EMTables.build(build_state_space(N, K, False), dev)
    y_dev = as_float(y, dt, dev)
    bounds = [(s, min(s + chunk, T)) for s in range(0, T, chunk)]
    min_stats = max(4 * K, 256)
    lp_c, mu_c, sg_c = (as_float(v, dt, dev) for v in
                        (templates.lp, templates.mu, templates.sigma))
    sbar = None                     # host float64 blended statistics
    lp_out = np.empty((len(bounds), N))
    mu_out = np.empty((len(bounds), K, N))
    sg_out = np.empty(len(bounds))
    lls = np.empty(len(bounds))

    n_full = T // chunk
    use_device = (device_loop if device_loop is not None
                  else dev.type == "cuda" and callback is None)
    start = 0
    if use_device and n_full >= 2:
        mode, blk = _chunk_modes(fb_mode, block, K, N, chunk, dev)
        (lp_t, mu_t, sg_t, ll_t), sbar_d = _track_loop(
            y_dev[: n_full * chunk].reshape(n_full, chunk), lp_c, mu_c, sg_c,
            forget, inner_steps=inner,
            stats_fn=lambda y_c, lp, mu, sg: em_chunk_stats(
                y_c, lp, mu, sg, tables, K=K, fb_mode=mode, block=blk),
            m_step=lambda sbar: _m_step(sbar, tables, dt, dev, K, N))
        lp_out[:n_full] = lp_t.cpu().numpy()
        mu_out[:n_full] = mu_t.cpu().numpy()
        sg_out[:n_full] = sg_t.cpu().numpy()
        lls[:n_full] = ll_t.cpu().numpy()
        lp_c, mu_c, sg_c = lp_t[-1], mu_t[-1], sg_t[-1]
        sbar = [v.to("cpu", torch.float64) for v in sbar_d]
        start = n_full

    for c in range(start, len(bounds)):
        s, e = bounds[c]
        Tc = e - s
        if Tc < min_stats and c > 0:
            # tail too short to estimate from; carry the parameters
            lp_out[c], mu_out[c], sg_out[c] = (lp_out[c - 1], mu_out[c - 1],
                                               sg_out[c - 1])
            lls[c] = np.nan
            continue
        mode, blk = _chunk_modes(fb_mode, block, K, N, Tc, dev)
        ll_c = None
        for _ in range(inner):
            G1, Gy, Gy2, X, Xd, ll = em_chunk_stats(
                y_dev[s:e], lp_c, mu_c, sg_c, tables, K=K, fb_mode=mode,
                block=blk)
            if ll_c is None:
                ll_c = float(ll)    # predictive ll (pre-update params)
            s_c = [v.to("cpu", torch.float64) / Tc
                   for v in (G1, Gy, Gy2, X, Xd)]
            sbar = s_c if sbar is None else [
                (1.0 - forget) * a + forget * b for a, b in zip(sbar, s_c)]
            lp_c, mu_c, sg_c = _m_step(sbar, tables, dt, dev, K, N)
        lp_out[c] = lp_c.cpu().numpy()
        mu_out[c] = mu_c.cpu().numpy()
        sg_out[c] = float(sg_c)
        lls[c] = ll_c
        if callback is not None:
            callback(c, lp_out[c], mu_out[c], sg_out[c], lls[c])
    return DriftTrack(lp=lp_out, mu=mu_out, sigma=sg_out, lls=lls,
                      bounds=bounds, chunk=chunk, forget=forget,
                      allow_overlaps=templates.allow_overlaps)


def track_drift_batched(templates, ys, *, chunk: int = 32768,
                        forget: float = 0.3, inner_steps: int = 1,
                        fb_mode: str | None = None, block: int | None = None,
                        device_loop: bool | None = None, device=None,
                        dtype=None) -> list[DriftTrack]:
    """Independent per-channel drift tracks over a (C, T) batch against the
    shared starting templates (CLI --adaptive --channels all): one
    track_drift per channel, the result the JAX package's vmapped program
    is tested equal to."""
    ys = np.asarray(ys)
    if ys.ndim != 2:
        raise ValueError("track_drift_batched takes a (C, T) batch")
    if templates.n_neurons == 0:
        raise ValueError("track_drift_batched needs at least one template")
    return [track_drift(templates, row, chunk=chunk, forget=forget,
                        inner_steps=inner_steps, fb_mode=fb_mode,
                        block=block, device_loop=device_loop, device=device,
                        dtype=dtype) for row in ys]


def _tracked_overlap_save(y, lp_all, mu_all, sg_all, *, L: int, H: int,
                          overlaps: bool, device, dtype):
    """Overlap-save decode with PER-WINDOW parameters: window b decodes with
    the templates of its own chunk (lp_all (B, N), mu_all (B, K, N), sg_all
    (B,)); window build, decode, seam snap and stitch as
    parallel/overlap_save.ring_overlap_save. On a CUDA device in float32 the
    N=2 overlap topology runs kernels 16 + 2 (ops/viterbi_mb.ov2_decode_mb
    with per-window constants, one launch each) and N >= 3 kernels 3 + 4
    window by window, each window under its own constants (where
    ovn_kernel_ok admits the topology); their plain versions elsewhere. The
    non-overlap topology runs the plain engine window by window. Returns (x
    (T,) int16 / int32, seam_ok (B-1,) bool), on `device`."""
    from ..ops import viterbi_mb as vmb
    from ..ops import viterbi_ovn_mb as vomb
    from ..ops.ring_viterbi import engine_name, nov_decode_batched, ring_engine
    from ..parallel.overlap_save import (_build_windows, _snap_and_stitch,
                                         _to_device)

    dev = torch.device(device)
    mu_t = as_float(mu_all, dtype, dev)
    lp_t = as_float(lp_all, dtype, dev)
    sg_t = as_float(sg_all, dtype, dev)
    K, N = mu_t.shape[1], mu_t.shape[2]
    y = _to_device(y, dev, dtype)
    T = y.shape[0]
    B = -(-T // L)
    W = L + 2 * H
    out_dtype = vmb.labels_dtype(n_states(N, K, overlaps))
    name = engine_name(N, overlaps)
    if B == 1 or T < W:
        x, _ = ring_engine(N, overlaps)(y, lp_t[0], mu_t[0], sg_t[0],
                                        silent_start=True, with_ll=False)
        return x.to(out_dtype), torch.ones(0, dtype=torch.bool, device=dev)
    y_win, edge_rows = _build_windows(y, T=T, L=L, H=H, B=B, W=W)
    y_win = y_win.contiguous()
    sil0 = torch.arange(B, device=dev) == 0     # forced silent start
    on_card = dev.type == "cuda" and dtype == torch.float32
    if name == "ov2":
        c = vmb.ov2_consts(lp_t, mu_t, sg_t, dtype=dtype, device=dev)
        kernel = on_card and K - 1 <= vmb.KP
        xb = (vmb.ov2_decode_mb if kernel else vmb.ov2_decode_mb_plain)(
            y_win, sil0, c).to(out_dtype)
    else:
        # window by window, each under its own constants: kernels 3-4 on
        # the card where they take the topology, else the plain engines
        ovn = (vomb.ovn_decode_mb if on_card and vomb.ovn_kernel_ok(N, K)
               else vomb.ovn_decode_mb_plain)
        xb = torch.empty((B, W), dtype=out_dtype, device=dev)
        for b in range(B):
            one = slice(b, b + 1)
            if name == "nov":
                xb[b] = nov_decode_batched(y_win[one], sil0[one], lp_t[b],
                                           mu_t[b], sg_t[b])[0]
            else:
                cb = vomb.ovn_consts(lp_t[b], mu_t[b], sg_t[b], dtype=dtype,
                                     device=dev)
                xb[b] = ovn(y_win[one], sil0[one], cb)[0]
    x, seam_ok = _snap_and_stitch(xb, T=T, L=L, H=H, B=B,
                                  edge_rows=edge_rows)
    return x.to(out_dtype), seam_ok


def _tracked_overlap_save_events(y, lp_all, mu_all, sg_all, *, L: int,
                                 H: int, overlaps: bool, device, dtype):
    """The tracked decode and the event extraction on `device`, the
    per-window-parameter mirror of core/events._ring_overlap_save_events_impl:
    (blob, x), the dense labels x left there for the fallback (kernels 16
    and 2 on the card for the N=2 overlap topology)."""
    from ..core.events import _event_blob

    x, seam_ok = _tracked_overlap_save(y, lp_all, mu_all, sg_all, L=L, H=H,
                                       overlaps=overlaps, device=device,
                                       dtype=dtype)
    K, N = np.shape(mu_all)[1:]
    return _event_blob(x, seam_ok, N=N, K=K, overlaps=overlaps), x


def _piecewise_path_ll(y, x, track: DriftTrack, ss) -> float:
    """Reference cumulative-score ll of the stitched path, each step's
    transition + emission increment charged under the parameters of the
    chunk OWNING that step. The reference's ll is the SUM of the running
    prefix T1[x_t, t] over t >= 1 (core/path_score.py), so the prefix is
    carried across chunk boundaries: with constant parameters this reduces
    exactly to path_cumulative_ll. A host numpy loop, as in the JAX
    package."""
    from ..core.path_score import path_transition_weights
    from ..utils.logmath import HALF_LOG_2PI

    states = np.asarray(ss.states)
    Nn = states.shape[0]
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.float64)
    K = track.mu.shape[1]
    # silent-start prefix (decode forces x[0] == 0; mirror the fallback)
    if x[0] == 0:
        prefix = 0.0
    else:
        mu0 = track.mu[0]
        sg0 = float(track.sigma[0])
        smu0 = mu0[states, np.arange(Nn)[:, None]].sum(axis=0)
        prefix = float(-HALF_LOG_2PI - np.log(sg0)
                       - (y[0] - smu0[x[0]]) ** 2 / (2.0 * sg0 * sg0))
    total = 0.0
    for c, (s, e) in enumerate(track.bounds):
        lo = max(s, 1)
        if lo >= e:
            continue
        mu_c = track.mu[c]
        sg_c = float(track.sigma[c])
        smu = mu_c[states, np.arange(Nn)[:, None]].sum(axis=0)
        pos = states[:, x[lo - 1:e]]                     # (N, span+1)
        w = path_transition_weights(pos[:, :-1], pos[:, 1:], track.lp[c], K)
        em = (-HALF_LOG_2PI - np.log(sg_c)
              - (y[lo:e] - smu[x[lo:e]]) ** 2 / (2.0 * sg_c * sg_c))
        pref = prefix + np.cumsum(w + em)
        total += float(pref.sum())
        prefix = float(pref[-1])
    return total


def _protocol_decode_tracked(track: DriftTrack, y, decoder_for):
    """Sequential per-chunk decode with the reference silence-snap protocol
    (models/api._chunked_decode semantics), each chunk under ITS OWN
    parameters: the tracked decode of recordings too short to window
    (T < chunk + 2H). decoder_for(model) -> decode(yy) -> (labels, ll)."""
    T = len(y)
    x = np.zeros(T, np.int64)
    pos = 0
    for c, (s, e) in enumerate(track.bounds):
        if pos >= e and e < T:
            continue                 # retraction already crossed chunk c
        xc = np.asarray(decoder_for(track.model_at(c))(y[pos:e])[0])
        lo = 0
        if pos > 0:                  # must start from silence
            while lo < len(xc) and xc[lo] > 0:
                lo += 1
        j = e
        k = len(xc)
        if e < T:                    # retract to the last silent state
            while k > lo and xc[k - 1] > 0:
                k -= 1
                j -= 1
            if j <= pos:
                raise RuntimeError(
                    f"chunk [{pos}, {e}) has no silent state to snap to; "
                    "track with a larger chunk")
        x[pos + lo:j] = xc[lo:k]
        pos = j
    return x


def decode_tracked(track: DriftTrack, y, *, H: int | None = None,
                   repair: bool = True, transfer: str = "dense",
                   device=None, dtype=None):
    """Decode `y` with the tracked per-chunk templates (_tracked_overlap_save:
    window = chunk, each under its own parameters). Returns an
    HMMSpikingModel whose template_model is the LAST chunk's model, with the
    fast path's extras (`seam_ok`, `seams_repaired`, `spike_onsets`), the
    piecewise cumulative-score ll and `track`.

    transfer="events" copies only the packed spike-onset events to the
    host and rebuilds the labels exactly there (core/events.py), as the
    stationary fast path does; flagged seams fall back to the dense labels.

    Flagged seams (no common silence within +-H) are re-decoded with the
    seam's left-chunk parameters over widening windows
    (parallel/seam_repair.py). A multichannel track goes to
    decode_tracked_mc."""
    from ..core.events import _decode_from_blob, _onsets_dense
    from ..models.api import HMMSpikingModel, _decoder_for
    from ..parallel.seam_repair import make_window_decoder, repair_seams

    if transfer not in ("dense", "events"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    if track.is_mc:
        return decode_tracked_mc(track, y, H=H, repair=repair,
                                 transfer=transfer, device=dev, dtype=dt)
    y = np.asarray(y, np.float64)
    T = y.shape[0]
    B = track.n_chunks
    K = track.mu.shape[1]
    N = track.mu.shape[2]
    L = track.chunk
    if track.bounds[-1][1] != T or -(-T // L) != B:
        raise ValueError("track does not cover this signal (bounds "
                         f"{track.bounds[-1]} vs T={T})")
    if H is None:
        H = max(4 * K, 64)
    if L < 2 * H:
        raise ValueError(f"chunk={L} < 2H={2 * H}; track with a larger "
                         "chunk (or pass a smaller decode halo H)")

    onsets = None
    if B > 1 and T < L + 2 * H:
        # too short to window but multi-chunk: the one-shot branch would
        # decode the tail with chunk 0's parameters; the sequential
        # per-chunk protocol snaps its seams to silence by construction
        x = _protocol_decode_tracked(
            track, y, lambda tm: _decoder_for(tm, dev, dt))
        seam_ok = np.ones(0, bool)
    elif transfer == "events" and B > 1:
        blob, x_dense = _tracked_overlap_save_events(
            y, track.lp, track.mu, track.sigma, L=L, H=H,
            overlaps=track.allow_overlaps, device=dev, dtype=dt)
        onsets, x, seam_ok = _decode_from_blob(
            blob, x_dense, T=T, N=N, K=K, B=B,
            overlaps=track.allow_overlaps, return_labels=True)
    else:
        x, seam_ok = _tracked_overlap_save(
            y, track.lp, track.mu, track.sigma, L=L, H=H,
            overlaps=track.allow_overlaps, device=dev, dtype=dt)
        x, seam_ok = x.cpu().numpy(), seam_ok.cpu().numpy()

    n_repaired = 0
    if repair and not seam_ok.all():
        for s in np.nonzero(~seam_ok)[0]:
            dec = make_window_decoder(track.lp[s], track.mu[s],
                                      float(track.sigma[s]),
                                      overlaps=track.allow_overlaps,
                                      device=dev, dtype=dt)
            x, _ = repair_seams(y, x, [(int(s) + 1) * L], dec, H=H)
        n_repaired = int((~seam_ok).sum())
        seam_ok = np.ones_like(seam_ok)
        onsets = None                    # labels changed under the repair

    ss = build_state_space(N, K, track.allow_overlaps)
    ll = _piecewise_path_ll(y, x, track, ss)
    model = HMMSpikingModel(track.model_at(B - 1), x, ll, y)
    model.seam_ok = seam_ok
    model.seams_repaired = n_repaired
    model.spike_onsets = (onsets if onsets is not None else
                          _onsets_dense(x, N=N, K=K,
                                        overlaps=track.allow_overlaps))
    model.track = track
    return model


# --------------------------------------------------------------------------
# multichannel mirror: the same online blend over per-channel moments, and a
# decode of every window under its own chunk's (lp, mu (K, N, C), sigmas
# (C,)), the emission tables built per window (core/emission_mc
# .MCTablesDevice).


def track_drift_mc(templates, yc, *, chunk: int = 32768,
                   forget: float = 0.3, inner_steps: int = 1,
                   fb_mode: str | None = None, block: int | None = None,
                   callback=None, device_loop: bool | None = None,
                   device=None, dtype=None) -> DriftTrack:
    """Track drifting multichannel templates through a (T, C) recording with
    online EM: track_drift's loop over the multichannel statistics
    (train/em_mc.em_chunk_stats_mc) and M-step. The E-step engine is
    train/em_mc.auto_fb_mode_mc's per chunk length: kernels 12-13
    ("overlap_cuda") on the card, "gather" on the CPU. device_loop (None =
    auto: on for a CUDA device without a callback) runs the full chunks on
    the device, blending in the working dtype; the host loop (the CPU,
    callbacks, the ragged tail) blends in float64, as the JAX host loop
    does."""
    from .em_mc import _m_step_from_stats_mc, auto_fb_mode_mc, \
        em_chunk_stats_mc

    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    yc = np.asarray(yc)
    if yc.ndim != 2:
        raise ValueError("track_drift_mc takes a (T, C) recording")
    K, N, C = templates.K, templates.n_neurons, templates.n_channels
    if yc.shape[1] != C:
        raise ValueError(f"recording has {yc.shape[1]} channels but the "
                         f"templates have {C}")
    if N == 0:
        raise ValueError("track_drift_mc needs at least one template")
    if not 0.0 < forget <= 1.0:
        raise ValueError("forget must be in (0, 1]")
    T = yc.shape[0]
    chunk = int(min(chunk, T))
    if chunk < 2:
        raise ValueError("chunk must be >= 2")
    inner = max(1, inner_steps)
    blk = block if block is not None else 2048

    tables = EMTables.build(build_state_space(N, K, False), dev)
    yc_dev = as_float(yc, dt, dev)
    bounds = [(s, min(s + chunk, T)) for s in range(0, T, chunk)]
    min_stats = max(4 * K, 256)
    lp_c, mu_c, sg_c = (as_float(v, dt, dev) for v in
                        (templates.lp, templates.mu, templates.sigmas))

    def stats_fn(mode):
        return lambda y_c, lp, mu, sg: em_chunk_stats_mc(
            y_c, lp, mu, sg, tables, K=K, fb_mode=mode, block=blk)

    def m_step(sbar):
        v = [as_float(x, dt, dev) for x in sbar]
        return _m_step_from_stats_mc(v[0], v[1], v[2], torch.log(v[3]),
                                     torch.log(v[4]), dt, K, N, C)

    def mode_of(Tc):
        return fb_mode if fb_mode is not None else auto_fb_mode_mc(
            Tc, K, N, C, dev, blk)

    sbar = None                     # host float64 blended statistics
    lp_out = np.empty((len(bounds), N))
    mu_out = np.empty((len(bounds), K, N, C))
    sg_out = np.empty((len(bounds), C))
    lls = np.empty(len(bounds))

    n_full = T // chunk
    use_device = (device_loop if device_loop is not None
                  else dev.type == "cuda" and callback is None)
    start = 0
    if use_device and n_full >= 2:
        (lp_t, mu_t, sg_t, ll_t), sbar_d = _track_loop(
            yc_dev[: n_full * chunk].reshape(n_full, chunk, C), lp_c, mu_c,
            sg_c, forget, stats_fn=stats_fn(mode_of(chunk)), m_step=m_step,
            inner_steps=inner)
        lp_out[:n_full] = lp_t.cpu().numpy()
        mu_out[:n_full] = mu_t.cpu().numpy()
        sg_out[:n_full] = sg_t.cpu().numpy()
        lls[:n_full] = ll_t.cpu().numpy()
        lp_c, mu_c, sg_c = lp_t[-1], mu_t[-1], sg_t[-1]
        sbar = [v.to("cpu", torch.float64) for v in sbar_d]
        start = n_full

    for c in range(start, len(bounds)):
        s, e = bounds[c]
        Tc = e - s
        if Tc < min_stats and c > 0:
            # tail too short to estimate from; carry the parameters
            lp_out[c], mu_out[c], sg_out[c] = (lp_out[c - 1], mu_out[c - 1],
                                               sg_out[c - 1])
            lls[c] = np.nan
            continue
        stats = stats_fn(mode_of(Tc))
        ll_c = None
        for _ in range(inner):
            G1, Gy, Gy2, X, Xd, ll = stats(yc_dev[s:e], lp_c, mu_c, sg_c)
            if ll_c is None:
                ll_c = float(ll)    # predictive ll (pre-update params)
            s_c = [v.to("cpu", torch.float64) / Tc
                   for v in (G1, Gy, Gy2, X, Xd)]
            sbar = s_c if sbar is None else [
                (1.0 - forget) * a + forget * b for a, b in zip(sbar, s_c)]
            lp_c, mu_c, sg_c = m_step(sbar)
        lp_out[c] = lp_c.cpu().numpy()
        mu_out[c] = mu_c.cpu().numpy()
        sg_out[c] = sg_c.cpu().numpy()
        lls[c] = ll_c
        if callback is not None:
            callback(c, lp_out[c], mu_out[c], sg_out[c], lls[c])
    return DriftTrack(lp=lp_out, mu=mu_out, sigma=sg_out, lls=lls,
                      bounds=bounds, chunk=chunk, forget=forget,
                      allow_overlaps=templates.allow_overlaps)


def _mc_win_streams(y_win, lp_all, mu_all, sg_all, *, device, dtype):
    """Each window's emission streams under its own tables: raw windows
    y_win (B, W, C) and per-window (lp, mu, sigmas) -> (es (B, W), d (B, W,
    N, K-1), the MCTablesDevice of the B windows, lp (B, N)), in `dtype` on
    `device`. The tables are computed in float64 (MCTables' values) and
    stored in `dtype`; each window's streams come from mc_streams_from, a
    window at a time, as the stationary decode computes them."""
    from ..core.emission_mc import MCTablesDevice

    dev = torch.device(device)
    B, W, _ = y_win.shape
    K, N = np.shape(mu_all)[1:3]
    tb = MCTablesDevice(as_float(mu_all, torch.float64, dev),
                        as_float(sg_all, torch.float64, dev), dtype)
    es = y_win.new_empty((B, W), dtype=dtype)
    d = y_win.new_empty((B, W, N, K - 1), dtype=dtype)
    for b in range(B):
        es[b], d[b] = tb.streams(y_win[b].to(dtype), b)
    return es, d, tb, as_float(lp_all, dtype, dev)


def _mc_win_engine(y_win, sil, lp_all, mu_all, sg_all, *, overlaps: bool,
                   device, dtype):
    """The per-window MC decode: raw windows y_win (B, W, C), (B,) bool
    silent-start rows and each window's (lp (B, N), mu (B, K, N, C), sigmas
    (B, C)) -> (B, W) labels. Each window's streams come from its own
    tables (MCTablesDevice with a leading window axis, mc_streams_from a
    window at a time). On a CUDA device in float32 every overlap N >= 2
    that ovn_mc_kernel_ok admits runs kernel 11 in its per-window mode and
    kernel 4, one launch each (at N=2 kernel 11's direct form, as the
    stationary decode). Elsewhere the plain engines of the JAX package's
    per-window engine, window by window: the non-overlap decode, the
    cross-form ov2 at N=2, the direct-form ovn for N >= 3."""
    from ..ops import viterbi_mb as vmb
    from ..ops import viterbi_ovn_mb as vomb
    from ..ops.ring_viterbi_mc import _nov_decode, _ov2_decode

    dev = torch.device(device)
    B, W, _ = y_win.shape
    K, N = np.shape(mu_all)[1:3]
    es, d, tb, lp_t = _mc_win_streams(y_win, lp_all, mu_all, sg_all,
                                      device=dev, dtype=dtype)
    out_dtype = vmb.labels_dtype(n_states(N, K, overlaps))
    if overlaps and N >= 2:
        kernel = (dev.type == "cuda" and dtype == torch.float32
                  and vomb.ovn_mc_kernel_ok(N, K))
        if kernel or N >= 3:
            c = vomb.ovn_mc_consts_batched(lp_t, tb.c1, tb.c2_stack,
                                           dtype=dtype, device=dev)
            dec = (vomb.ovn_mc_decode_mb_tracked if kernel
                   else vomb.ovn_mc_decode_mb_plain)
            return dec(es, d, sil, c).to(out_dtype)
        # N=2 off the kernel: the cross form, every window under its own
        # row of constants in one pass
        return _ov2_decode(es, d, sil, lp_t, tb.c1, tb.x2_01)[0].to(
            out_dtype)
    xb = torch.empty((B, W), dtype=out_dtype, device=dev)
    for b in range(B):
        one = slice(b, b + 1)
        xb[b] = _nov_decode(es[one], d[one], sil[one].to(torch.bool),
                            lp_t[b], tb.c1[b])[0][0]
    return xb


def _tracked_overlap_save_mc(yc, lp_all, mu_all, sg_all, *, L: int, H: int,
                             overlaps: bool, device, dtype):
    """Multichannel overlap-save decode with PER-WINDOW parameters: the raw
    (B, W, C) halo windows of the recording, window b decoded under chunk
    b's templates by `_mc_win_engine` (one launch each of kernels 11 and 4
    on the card), then one seam snap and stitch. Returns (x (T,) int16 /
    int32, seam_ok (B-1,) bool), on `device`."""
    from ..parallel.overlap_save import (_build_windows, _snap_and_stitch,
                                         _to_device)

    dev = torch.device(device)
    yc = _to_device(yc, dev, dtype)
    T = yc.shape[0]
    B = -(-T // L)
    W = L + 2 * H
    kw = dict(overlaps=overlaps, device=dev, dtype=dtype)
    if B == 1 or T < W:
        x = _mc_win_engine(yc[None], torch.ones(1, dtype=torch.bool,
                                                device=dev),
                           lp_all[:1], mu_all[:1], sg_all[:1], **kw)[0]
        return x, torch.ones(0, dtype=torch.bool, device=dev)
    y_win, edge_rows = _build_windows(yc, T=T, L=L, H=H, B=B, W=W)
    sil0 = torch.arange(B, device=dev) == 0     # forced silent start
    xb = _mc_win_engine(y_win.contiguous(), sil0, lp_all, mu_all, sg_all,
                        **kw)
    return _snap_and_stitch(xb, T=T, L=L, H=H, B=B, edge_rows=edge_rows)


def _tracked_overlap_save_mc_events(yc, lp_all, mu_all, sg_all, *, L: int,
                                    H: int, overlaps: bool, device, dtype):
    """The multichannel tracked decode and the event extraction on `device`:
    (blob in the JAX package's byte layout, x), the dense labels x left
    there for the fallback."""
    from ..core.events import _event_blob

    x, seam_ok = _tracked_overlap_save_mc(yc, lp_all, mu_all, sg_all, L=L,
                                          H=H, overlaps=overlaps,
                                          device=device, dtype=dtype)
    K, N = np.shape(mu_all)[1:3]
    return _event_blob(x, seam_ok, N=N, K=K, overlaps=overlaps), x


def _piecewise_path_ll_mc(yc, x, track: DriftTrack, ss) -> float:
    """MC mirror of _piecewise_path_ll: per-channel Gaussian emission sums,
    each step charged under its owning chunk's parameters, the running
    prefix carried across chunk boundaries. A host numpy loop, as in the
    JAX package."""
    from ..core.path_score import path_transition_weights
    from ..utils.logmath import HALF_LOG_2PI

    states = np.asarray(ss.states)
    Nn = states.shape[0]
    x = np.asarray(x, np.int64)
    yc = np.asarray(yc, np.float64)
    K = track.mu.shape[1]

    def em_rows(c, idx_t, idx_x):
        mu_c = track.mu[c]
        sg_c = np.asarray(track.sigma[c], np.float64)    # (C,)
        smu = mu_c[states, np.arange(Nn)[:, None], :].sum(axis=0)  # (S, C)
        dev = yc[idx_t] - smu[idx_x]                     # (n, C)
        return np.sum(-HALF_LOG_2PI - np.log(sg_c)
                      - dev * dev / (2.0 * sg_c * sg_c), axis=-1)

    if x[0] == 0:
        prefix = 0.0
    else:
        prefix = float(em_rows(0, np.array([0]), np.array([x[0]]))[0])
    total = 0.0
    for c, (s, e) in enumerate(track.bounds):
        lo = max(s, 1)
        if lo >= e:
            continue
        pos = states[:, x[lo - 1:e]]
        w = path_transition_weights(pos[:, :-1], pos[:, 1:], track.lp[c], K)
        em = em_rows(c, np.arange(lo, e), x[lo:e])
        pref = prefix + np.cumsum(w + em)
        total += float(pref.sum())
        prefix = float(pref[-1])
    return total


def decode_tracked_mc(track: DriftTrack, yc, *, H: int | None = None,
                      repair: bool = True, transfer: str = "dense",
                      device=None, dtype=None):
    """Decode a (T, C) recording with the tracked per-chunk multichannel
    templates (_tracked_overlap_save_mc: window = chunk, each under its own
    parameters; kernels 11 and 4 once each on the card), the mirror of
    decode_tracked: the sequential per-chunk protocol for recordings too
    short to window, transfer="events" (the packed onset blob, the dense
    labels on a flagged seam), flagged seams re-decoded with the seam's
    left-chunk model (models/multichannel._mc_repair_decoder), and the
    piecewise cumulative-score ll. The returned model carries `seam_ok`,
    `seams_repaired`, `spike_onsets` and `track`."""
    from ..core.events import _decode_from_blob, _onsets_dense
    from ..models.api import HMMSpikingModel
    from ..models.multichannel import _mc_decoder_for, _mc_repair_decoder
    from ..parallel.seam_repair import repair_seams

    if transfer not in ("dense", "events"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    yc = np.asarray(yc, np.float64)
    if yc.ndim != 2:
        raise ValueError("decode_tracked_mc takes a (T, C) recording")
    if not track.is_mc:
        raise ValueError("single-channel track: use decode_tracked")
    T = yc.shape[0]
    B = track.n_chunks
    K, N = track.mu.shape[1], track.mu.shape[2]
    L = track.chunk
    if track.bounds[-1][1] != T or -(-T // L) != B:
        raise ValueError("track does not cover this signal (bounds "
                         f"{track.bounds[-1]} vs T={T})")
    if H is None:
        H = max(4 * K, 64)
    if L < 2 * H:
        raise ValueError(f"chunk={L} < 2H={2 * H}; track with a larger "
                         "chunk (or pass a smaller decode halo H)")

    onsets = None
    kw = dict(L=L, H=H, overlaps=track.allow_overlaps, device=dev, dtype=dt)
    if B > 1 and T < L + 2 * H:
        # the sequential per-chunk protocol keeps the tail under its own
        # chunk's parameters (decode_tracked's rule)
        x = _protocol_decode_tracked(
            track, yc, lambda tm: _mc_decoder_for(tm, dev, dt))
        seam_ok = np.ones(0, bool)
    elif transfer == "events" and B > 1:
        blob, x_dense = _tracked_overlap_save_mc_events(
            yc, track.lp, track.mu, track.sigma, **kw)
        onsets, x, seam_ok = _decode_from_blob(
            blob, x_dense, T=T, N=N, K=K, B=B,
            overlaps=track.allow_overlaps, return_labels=True)
    else:
        x, seam_ok = _tracked_overlap_save_mc(yc, track.lp, track.mu,
                                              track.sigma, **kw)
        x, seam_ok = x.cpu().numpy(), seam_ok.cpu().numpy()

    n_repaired = 0
    if repair and not seam_ok.all():
        for s in np.nonzero(~seam_ok)[0]:
            dec = _mc_repair_decoder(track.model_at(int(s)), dev, dt)
            x, _ = repair_seams(yc, x, [(int(s) + 1) * L], dec, H=H)
        n_repaired = int((~seam_ok).sum())
        seam_ok = np.ones_like(seam_ok)
        onsets = None                    # labels changed under the repair

    ss = build_state_space(N, K, track.allow_overlaps)
    ll = _piecewise_path_ll_mc(yc, x, track, ss)
    model = HMMSpikingModel(track.model_at(B - 1), x, ll, yc)
    model.seam_ok = seam_ok
    model.seams_repaired = n_repaired
    model.spike_onsets = (onsets if onsets is not None else
                          _onsets_dense(x, N=N, K=K,
                                        overlaps=track.allow_overlaps))
    model.track = track
    return model
