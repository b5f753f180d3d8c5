"""Sparse spike-event representation of a decoded label sequence and the
events-transfer decode (counterpart of the JAX package's core/events.py).

On a valid path every neuron's ring phase advances deterministically after
its onset (reference transition semantics, src/types.jl:94-113), so the
labels are fully described by the initial state and each neuron's onset
times: the samples where its phase equals 1, the timestamps
extract_spiketimes aligns (reference src/extraction.jl:15-24).
`spike_confidence` and `core/qc.py` read them.

The packed form puts each neuron's onsets on a (N, ceil(T/G)) uint8 grid:
consecutive onsets of one neuron are at least K samples apart, so a chunk of
G <= K samples holds at most one, stored as its offset in the chunk (G when
there is none). The extraction is tensor arithmetic on the labels' device.

The events transfer (`decode_events_overlap_save` and its multichannel,
streaming, tracked and channel-batched siblings) decodes on the device,
packs the onsets there and copies one flat uint8 blob to the host instead of
the dense labels; `labels_from_onsets` rebuilds the labels exactly. Blob
layout (the JAX package's bytes): [packed (N*C) | counts (N int32,
little-endian) | x0 (int32) | seam_ok (B-1 bool)]. A seam that found no
common silence, or a packing cross-check that fails, falls back to the
dense labels, which are still on the device: a raw-cut seam can splice
mid-spike and break phase continuity. `BRANCHES` counts which branch each
decode took.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import default_dtype, resolve_device


def _pair_list(N: int):
    """Pair enumeration order of the overlap states (i-major, j-minor),
    matching core/state_space's enumeration."""
    return [(i, j) for i in range(N - 1) for j in range(i + 1, N)]


def phase_of(x, n: int, N: int, K: int, overlaps: bool):
    """Ring phase of neuron `n` at every sample of label sequence `x`:
    0 = silent, 1..K-1 = ring position. Pure arithmetic on the closed-form
    state encoding; takes and returns numpy arrays or torch tensors."""
    xp = torch if isinstance(x, torch.Tensor) else np
    Km1 = K - 1
    single_lo = 1 + n * Km1
    zero = xp.zeros_like(x)
    phase = xp.where((x >= single_lo) & (x < single_lo + Km1),
                     x - single_lo + 1, zero)
    if overlaps:
        base = 1 + N * Km1
        for rank, (i, j) in enumerate(_pair_list(N)):
            if n not in (i, j):
                continue
            lo = base + rank * Km1 * Km1
            r = x - lo
            inpair = (r >= 0) & (r < Km1 * Km1)
            p = (r // Km1 + 1) if n == i else (r % Km1 + 1)
            phase = xp.where(inpair, p, phase)
    return phase


def event_chunk(K: int) -> int:
    """Largest power-of-two chunk length G <= min(K, 128): at most one onset
    per neuron per chunk on a valid path, and offsets fit a uint8 with G as
    the no-onset sentinel."""
    g = 1
    while g * 2 <= min(K, 128):
        g *= 2
    return g


def extract_onsets_packed(x, *, N: int, K: int, overlaps: bool):
    """Onset extraction onto the packed uint8 event grid, on x's device.

    Args:
      x: (..., T) integer labels (a tensor or an array); leading axes are a
        batch (the windows of a streaming call, the channels of a batch).

    Returns:
      packed: (..., N, ceil(T/G)) uint8 tensor: offset of the onset within
        each G-sample chunk, or G when the chunk has none (G =
        event_chunk(K)).
      counts: (..., N) int32 tensor of true onset totals (on a valid path
        `(packed < G).sum(-1) == counts`).
    """
    x = torch.as_tensor(x).to(torch.int32)
    T = x.shape[-1]
    G = event_chunk(K)
    C = -(-T // G)
    offs = torch.arange(G, dtype=torch.int32, device=x.device).repeat(C)[:T]
    sentinel = torch.full_like(offs, G)
    rows, counts = [], []
    for n in range(N):
        mask = phase_of(x, n, N, K, overlaps) == 1
        key = torch.nn.functional.pad(torch.where(mask, offs, sentinel),
                                      (0, C * G - T), value=G)
        rows.append(key.reshape(*x.shape[:-1], C, G).amin(dim=-1))
        counts.append(mask.sum(dim=-1).to(torch.int32))
    return (torch.stack(rows, dim=-2).to(torch.uint8),
            torch.stack(counts, dim=-1))


def onsets_from_packed(packed, counts, *, K: int):
    """Host-side unpack: (N, C) uint8 grid -> list of N ascending onset
    index arrays. Raises if the packed grid lost an onset (invalid path:
    onsets closer than K apart)."""
    packed = np.asarray(packed.cpu() if isinstance(packed, torch.Tensor)
                        else packed)
    counts = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor)
                        else counts)
    G = event_chunk(K)
    out = []
    for n in range(packed.shape[0]):
        c_idx = np.nonzero(packed[n] < G)[0]
        if len(c_idx) != counts[n]:
            raise ValueError(
                f"packed event grid lost {counts[n] - len(c_idx)} onsets of "
                f"neuron {n}: onsets closer than K={K} apart (invalid path)")
        out.append((c_idx * G + packed[n, c_idx]).astype(np.int64))
    return out


def extract_onsets(x, *, N: int, K: int, overlaps: bool):
    """List of N onset-index arrays for labels `x` (packed extraction on
    x's device, then the host unpack)."""
    packed, counts = extract_onsets_packed(x, N=N, K=K, overlaps=overlaps)
    return onsets_from_packed(packed, counts, K=K)


def _onsets_dense(x, *, N, K, overlaps):
    """Onset lists straight from dense labels (no spacing assumption)."""
    x = np.asarray(x)
    t = np.arange(len(x))
    return [t[phase_of(x, n, N, K, overlaps) == 1] for n in range(N)]


def labels_from_onsets(onsets, x0, *, T: int, N: int, K: int,
                       overlaps: bool) -> np.ndarray:
    """Exact host-side reconstruction of the label sequence.

    Args:
      onsets: list of N ascending onset-index arrays.
      x0: the decoded initial state (seeds spikes already in progress at
        sample 0 — an active phase at t=0 has no onset inside [0, T)).

    Returns (T,) int32 labels, bit-equal to the dense decode for any valid
    path.
    """
    x0 = int(x0)
    Km1 = K - 1
    # per-neuron onset lists, with a virtual (negative) onset for a spike
    # already in progress at t=0: phase p0 at t=0 <=> onset 1-p0. p0 == 1
    # IS a real onset at t=0 — already in the extracted list, so adding
    # the virtual one would double-count it in the validity sweep.
    ons = []
    for n in range(N):
        pos = np.asarray(onsets[n], np.int64)
        p0 = int(phase_of(np.asarray([x0]), n, N, K, overlaps)[0])
        if p0 > 1:
            pos = np.concatenate([[1 - p0], pos])
        ons.append(pos)

    # validity sweep over the event endpoints (O(events log events)):
    # no sample may have more than max_active simultaneously active rings
    all_on = np.concatenate(ons) if N else np.zeros(0, np.int64)
    if all_on.size:
        pts = np.concatenate([all_on, all_on + Km1])
        delta = np.concatenate([np.ones(all_on.size, np.int64),
                                -np.ones(all_on.size, np.int64)])
        order = np.lexsort((delta, pts))         # ends before starts at ties
        peak = int(np.cumsum(delta[order]).max())
        if peak > (2 if overlaps else 1):
            raise ValueError(
                "more than the allowed number of simultaneously active "
                "neurons - not a valid path of this state space")

    # sparse writes only - everything is O(T zeros + n_events * K), never
    # full-array passes (the labels are ~97% silence in production)
    x = np.zeros(T, np.int32)
    ramp = np.arange(1, K, dtype=np.int32)
    moff = np.arange(Km1)
    for n in range(N):
        pos = ons[n]
        if len(pos):
            idx = pos[:, None] + moff[None, :]
            ok = (idx >= 0) & (idx < T)
            x[idx[ok]] = np.broadcast_to(n * Km1 + ramp, idx.shape)[ok]
    if overlaps:
        base = 1 + N * Km1
        for rank, (i, j) in enumerate(_pair_list(N)):
            oi, oj = ons[i], ons[j]
            if not len(oi) or not len(oj):
                continue
            # overlapping ring intervals: |oi - oj| < K-1. One neuron's
            # onsets are >= K apart, so each oi sees at most 2 candidate
            # oj in that window.
            jlo = np.searchsorted(oj, oi - Km1 + 1)
            jhi = np.searchsorted(oj, oi + Km1)
            for d in range(2):
                sel = jlo + d < jhi
                ii = np.nonzero(sel)[0]
                if not len(ii):
                    continue
                a, b = oi[ii], oj[jlo[ii] + d]
                s = np.maximum(a, b)[:, None] + moff[None, :]
                ok = ((s < np.minimum(a, b)[:, None] + Km1)
                      & (s >= 0) & (s < T))
                ids = (base + rank * Km1 * Km1
                       + (s - a[:, None]) * Km1 + (s - b[:, None]))
                x[s[ok]] = ids[ok]
    return x


def _u8(a):
    """Flat uint8 view of an integer or bool tensor (on its device): the
    bytes of an int32 as they lie in memory, little-endian on the card and
    the CPU alike."""
    a = torch.atleast_1d(a).contiguous()
    if a.dtype == torch.uint8:
        return a.reshape(-1)
    if a.dtype == torch.bool:
        return a.to(torch.uint8).reshape(-1)
    return a.view(torch.uint8).reshape(-1)


def _event_blob(x, seam_ok, *, N: int, K: int, overlaps: bool):
    """The blob of (..., T) labels and their seam flags, on their device:
    [packed | counts | x0 (one int32 a row) | seam_ok]."""
    packed, counts = extract_onsets_packed(x, N=N, K=K, overlaps=overlaps)
    return torch.cat([_u8(packed), _u8(counts),
                      _u8(x[..., 0].to(torch.int32)), _u8(seam_ok)])


def _parse_event_blob(blob, *, T, N, K, B):
    """Host-side inverse of the blob layout above."""
    blob = np.asarray(blob)
    G = event_chunk(K)
    C = -(-T // G)
    o = N * C
    packed = blob[:o].reshape(N, C)
    counts = blob[o : o + 4 * N].view(np.int32)
    o += 4 * N
    x0 = int(blob[o : o + 4].view(np.int32)[0])
    o += 4
    seam_ok = blob[o : o + max(B - 1, 0)].astype(bool)
    return packed, counts, x0, seam_ok


# which branch the events-transfer decodes took, a channel at a time: the
# host rebuild from events, or the dense labels' fallback
BRANCHES = {"events": 0, "dense": 0}


def _labels_of(packed, counts, x0, seam_ok, x_dense, *, T, N, K, overlaps,
               return_labels=True):
    """(onsets, labels or None) of one decoded recording: rebuilt from its
    events when every seam snapped and the packing cross-check holds, else
    from its dense labels `x_dense` (a callable giving the (T,) labels on
    the host: the one extra device-to-host copy of the fallback)."""
    if seam_ok.all():
        try:
            onsets = onsets_from_packed(packed, counts, K=K)
            x = (labels_from_onsets(onsets, x0, T=T, N=N, K=K,
                                    overlaps=overlaps)
                 if return_labels else None)
            BRANCHES["events"] += 1
            return onsets, x
        except ValueError:
            pass                                 # fall through to dense
    # raw-cut seams can splice mid-spike: phase continuity (and the >= K
    # onset spacing) is only guaranteed between silent cuts
    BRANCHES["dense"] += 1
    x = x_dense().astype(np.int32)
    return (_onsets_dense(x, N=N, K=K, overlaps=overlaps),
            x if return_labels else None)


def _decode_from_blob(blob, x_dense, *, T, N, K, B, overlaps,
                      return_labels):
    """(onsets, x or None, seam_ok) from a one-recording blob: one
    device-to-host copy of the blob, a second of the dense labels only
    for the fallback."""
    packed, counts, x0, seam_ok = _parse_event_blob(
        blob.cpu().numpy(), T=T, N=N, K=K, B=B)
    onsets, x = _labels_of(packed, counts, x0, seam_ok,
                           lambda: x_dense.cpu().numpy(), T=T, N=N, K=K,
                           overlaps=overlaps, return_labels=return_labels)
    return onsets, x, seam_ok


def _n_blocks(T, L, H):
    """Overlap-save blocks of a T-sample recording (1: one exact decode)."""
    return -(-T // L) if T >= L + 2 * H else 1


def _ring_overlap_save_events_impl(y, lp, mu, sigma, *, L, H, overlaps,
                                   block_engine, device, dtype):
    """Decode and event extraction on `device`: (blob, x), the dense
    labels x left there for the fallback."""
    from ..parallel.overlap_save import ring_overlap_save

    x, seam_ok = ring_overlap_save(y, lp, mu, sigma, L=L, H=H,
                                   overlaps=overlaps,
                                   block_engine=block_engine, device=device,
                                   dtype=dtype)
    K, N = np.shape(mu)
    return _event_blob(x, seam_ok, N=N, K=K, overlaps=overlaps), x


def _resolve(device, dtype):
    dev = resolve_device(device)
    return dev, (default_dtype(dev) if dtype is None else dtype)


def decode_events_overlap_save(y, lp, mu, sigma, *, L: int, H: int,
                               overlaps: bool, block_engine: str = "auto",
                               return_labels: bool = True, device=None,
                               dtype=None):
    """Production decode with sparse event transfer.

    Runs the one-shot overlap-save decode
    (parallel/overlap_save.ring_overlap_save: kernels 1-2 or 3-4 on the
    card) and the onset extraction on `device`, then copies only the
    packed events to the host. When every seam snapped to silence the
    labels are rebuilt exactly on the host; a flagged seam (or a packing
    cross-check failure) falls back to the dense labels, still on the
    device. Integer recordings ship raw and are cast on the device.

    Returns (onsets list of N int arrays, x (T,) int32 or None,
    seam_ok (B-1,) bool).
    """
    dev, dt = _resolve(device, dtype)
    K, N = np.shape(mu)
    T = int(np.shape(y)[0])
    blob, x_dense = _ring_overlap_save_events_impl(
        y, lp, mu, sigma, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, device=dev, dtype=dt)
    return _decode_from_blob(blob, x_dense, T=T, N=N, K=K,
                             B=_n_blocks(T, L, H), overlaps=overlaps,
                             return_labels=return_labels)


def _mc_overlap_save_events_impl(es, d, lp, tables, *, L, H, overlaps,
                                 block_engine, N, K):
    """The multichannel decode from its streams and the event extraction,
    on the streams' device: (blob, x)."""
    from ..parallel.overlap_save import _mc_overlap_save_impl

    x, seam_ok = _mc_overlap_save_impl(es, d, lp, tables, L=L, H=H,
                                       overlaps=overlaps,
                                       block_engine=block_engine)
    return _event_blob(x, seam_ok, N=N, K=K, overlaps=overlaps), x


def decode_events_mc_overlap_save(yc, lp, mu, sigmas, *, L: int, H: int,
                                  overlaps: bool,
                                  block_engine: str = "auto",
                                  return_labels: bool = True, device=None,
                                  dtype=None):
    """Multi-channel production decode with sparse event transfer: the
    contract of decode_events_overlap_save over the joint (T, C) model
    (parallel/overlap_save.mc_overlap_save: kernels 11 and 4 on the
    card)."""
    from ..parallel.overlap_save import _mc_prepare

    dev, dt = _resolve(device, dtype)
    K, N, _ = np.shape(mu)
    T = int(np.shape(yc)[0])
    es, d, tables, block_engine = _mc_prepare(
        yc, mu, sigmas, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, device=dev, dtype=dt)
    blob, x_dense = _mc_overlap_save_events_impl(
        es, d, lp, tables, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, N=N, K=K)
    return _decode_from_blob(blob, x_dense, T=T, N=N, K=K,
                             B=_n_blocks(T, L, H), overlaps=overlaps,
                             return_labels=return_labels)


def make_events_block_decoder(block_decoder, *, N: int, K: int,
                              overlaps: bool):
    """Wrap a streaming block decoder ((B, W) windows -> (B, W) labels) so
    that each call returns ONE packed event blob on the device instead of
    the dense label batch (parallel/overlap_save.overlap_save_decode_long's
    device-to-host copy). Each window's decode is a valid path by itself
    (no splicing happens on the device), so the host rebuild
    (unpack_window_blob) is exact without a fallback."""

    def dec(y_win, sil):
        return _pack_label_windows(block_decoder(y_win, sil), N=N, K=K,
                                   overlaps=overlaps)

    return dec


def _pack_label_windows(xb, *, N, K, overlaps):
    """(B, W) labels -> [packed (B*N*C) | counts (B*N int32) | x0 (B
    int32)] on their device."""
    packed, counts = extract_onsets_packed(xb, N=N, K=K, overlaps=overlaps)
    return torch.cat([_u8(packed), _u8(counts),
                      _u8(xb[:, 0].to(torch.int32))])


def unpack_window_blob(blob, *, B: int, W: int, N: int, K: int,
                       overlaps: bool) -> np.ndarray:
    """Host-side inverse of make_events_block_decoder: (B, W) int32
    labels, bit-equal to the dense block decode."""
    blob = np.asarray(blob)
    G = event_chunk(K)
    C = -(-W // G)
    o = B * N * C
    packed = blob[:o].reshape(B, N, C)
    counts = blob[o : o + 4 * B * N].view(np.int32).reshape(B, N)
    x0 = blob[o + 4 * B * N : o + 4 * B * N + 4 * B].view(np.int32)
    out = np.empty((B, W), np.int32)
    for b in range(B):
        onsets = onsets_from_packed(packed[b], counts[b], K=K)
        out[b] = labels_from_onsets(onsets, int(x0[b]), T=W, N=N, K=K,
                                    overlaps=overlaps)
    return out


def _ring_overlap_save_batched_events_impl(ys, lp, mu, sigma, *, L, H,
                                           overlaps, block_engine, device,
                                           dtype):
    """Channel-batched decode and event extraction on `device`: (blob,
    xs). Blob layout: [packed (Ch*N*C) | counts (Ch*N int32) | x0 (Ch
    int32) | seam_ok (Ch*(B-1) bool)]."""
    from ..parallel.overlap_save import _ring_overlap_save_batched_impl

    xs, seam_ok = _ring_overlap_save_batched_impl(
        ys, lp, mu, sigma, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, device=device, dtype=dtype)
    K, N = np.shape(mu)
    return _event_blob(xs, seam_ok, N=N, K=K, overlaps=overlaps), xs


def decode_events_overlap_save_batched(ys, lp, mu, sigma, *, L: int,
                                       H: int, overlaps: bool,
                                       block_engine: str = "auto",
                                       return_labels: bool = True,
                                       device=None, dtype=None):
    """Channel-batched production decode with sparse event transfer: the
    (Ch, T) recording batch decodes in one batch of windows
    (parallel/overlap_save.ring_overlap_save_batched: one launch each of
    kernels 1-2 or 3-4 on the card) and one event blob comes back.

    Returns (onsets: list of Ch lists of N int arrays, xs (Ch, T) int32
    or None, seam_ok (Ch, B-1) bool). Channels whose seams all snapped
    rebuild from events; any flagged channel falls back to the dense
    labels (one extra copy for the whole batch).
    """
    from ..parallel.overlap_save import resolve_block_engine

    dev, dt = _resolve(device, dtype)
    K, N = np.shape(mu)
    Ch, T = np.shape(ys)
    if T < L + 2 * H:
        raise ValueError("signal shorter than one window; decode directly")
    G = event_chunk(K)
    C = -(-T // G)
    B = -(-T // L)
    block_engine = resolve_block_engine(block_engine, overlaps, K, N, dev)
    blob, xs_dense = _ring_overlap_save_batched_events_impl(
        ys, lp, mu, sigma, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, device=dev, dtype=dt)
    blob = blob.cpu().numpy()
    o = Ch * N * C
    packed = blob[:o].reshape(Ch, N, C)
    counts = blob[o : o + 4 * Ch * N].view(np.int32).reshape(Ch, N)
    o += 4 * Ch * N
    x0 = blob[o : o + 4 * Ch].view(np.int32)
    o += 4 * Ch
    seam_ok = blob[o : o + Ch * max(B - 1, 0)].astype(bool).reshape(
        Ch, max(B - 1, 0))

    dense = []                     # the batch's dense labels, fetched once

    def dense_row(c):
        if not dense:
            dense.append(xs_dense.cpu().numpy())
        return dense[0][c]

    onsets, xs = [], []
    for c in range(Ch):
        on, x = _labels_of(packed[c], counts[c], int(x0[c]), seam_ok[c],
                           lambda c=c: dense_row(c), T=T, N=N, K=K,
                           overlaps=overlaps, return_labels=return_labels)
        onsets.append(on)
        xs.append(x)
    return onsets, (np.stack(xs) if return_labels else None), seam_ok
