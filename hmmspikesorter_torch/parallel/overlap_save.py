"""Overlap-save time-parallel Viterbi: halo decode + silence-snapped seams
(counterpart of the JAX package's parallel/overlap_save.py; same seam
protocol, edge rows and int16 labels).

The analog of the reference's sequential silence-snapping chunker
(src/fit.jl:11-42): every block decodes in parallel over a halo-extended
window and each seam is snapped to a sample where the two adjacent block
decodes agree on silence:

* block b's window is [b*L - H, b*L + L + H); the first window starts at
  sample 0 (emission-only init + forced silent start, src/viterbi.jl:56-63)
  and the last ends at T (argmax termination), so the signal edges are
  faithful to the sequential engine; interior windows use emission-only
  init, absorbed by the halo;
* for the seam at p = (b+1)*L the cut q is the *last* sample <= p where
  both decodes are all-silent, else the first such sample > p; the left
  block supplies labels before the cut, the right block from the cut;
* `seam_ok` reports whether a common silent sample existed (if not, the
  cut falls at p; parallel/seam_repair.py can re-decode it).

`ring_overlap_save` is the one-shot path (all windows in one batch on the
device); `ring_overlap_save_batched` the same for a (Ch, T) channel batch,
every channel's windows in one batch; `overlap_save_decode_long` streams
fixed-size window batches and stitches on the host. `overlap_save_viterbi`
and `gather_block_decoder` run the generic gather engine (any state space
with in-edge tables, plain PyTorch on every device): the one-shot decode
and the streaming driver's block decoder.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from ..core.emission import emission_logprob
from ..core.state_space import n_states
from ..core.viterbi import gather_viterbi, gaussian_emission
from ..ops.ring_viterbi import ring_block_decoder, ring_engine
from ..ops.viterbi_mb import KP, labels_dtype
from ..ops.viterbi_ovn_mb import ovn_kernel_ok, ovn_mc_kernel_ok
from ..utils.device import (as_float, default_dtype, numpy_dtype,
                            resolve_device)
from ..utils.metrics import profile_trace


def _decode_blocks(em_win, v0, in_idx, in_w):
    """Viterbi of (B, W, S) emission windows with per-window init score
    vectors v0 (B, S) -> (B, W) labels, every window in one batch."""
    return gather_viterbi(v0, lambda t: em_win[:, t], em_win.shape[1],
                          in_idx, in_w)


def _decode_blocks_from_y(y_win, sil, in_idx, in_w, state_mu, sigma):
    """Like _decode_blocks but computes each step's emissions from the
    samples, so the (B, W, S) emission tensor is never materialised (needed
    for overlap state spaces at long T). sil: (B,) bool, the rows with the
    reference's forced silent start (the block containing sample 0,
    src/viterbi.jl:63)."""
    em = gaussian_emission(state_mu, sigma)
    y_win = y_win.to(state_mu.dtype)
    v0 = em(y_win[:, 0])
    S = state_mu.shape[0]
    first = sil[:, None] & (torch.arange(S, device=v0.device) == 0)[None, :]
    v0 = torch.where(first, torch.zeros_like(v0), v0)
    return gather_viterbi(v0, lambda t: em(y_win[:, t]), y_win.shape[1],
                          in_idx, in_w)


def _gather_tables(in_idx, in_w, state_mu, sigma, device, dtype):
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    return (torch.as_tensor(in_idx, device=dev).long(),
            as_float(in_w, dtype, dev), as_float(state_mu, dtype, dev),
            as_float(sigma, dtype, dev))


def overlap_save_viterbi(y, in_idx, in_w, state_mu, sigma, *, L: int,
                         H: int, device=None, dtype=None):
    """Parallel overlap-save decode of one sequence through the generic
    gather engine on `device` (default CUDA; dtype float32 there, float64
    on the CPU unless given), every window in one batch.

    y: (T,) observations; T must be a multiple of L and >= L + 2H. L: core
    block length; H: halo length (choose H >= a few K). Window b covers
    [b*L - H, b*L + L + H) clamped into the signal, and each seam is
    snapped as in the module docstring.

    Returns (x (T,) int32, seam_ok (B-1,) bool), both on `device`.
    """
    if L < 2 * H:
        raise ValueError("need L >= 2H so seam cuts are monotone")
    in_idx, in_w, state_mu, sigma = _gather_tables(in_idx, in_w, state_mu,
                                                   sigma, device, dtype)
    dev, dtype = state_mu.device, state_mu.dtype
    y = as_float(y, dtype, dev)
    T = y.shape[0]
    if T % L != 0:
        raise ValueError(f"T={T} must be a multiple of L={L}")
    B = T // L
    W = L + 2 * H
    if B > 1 and T < W:
        raise ValueError(f"T={T} must be >= L + 2H = {W}")

    em = emission_logprob(y, state_mu, sigma)             # (T, S)

    if B == 1:
        # single block: exactly the sequential engine's semantics
        v0 = em[0].clone()
        v0[0] = 0.0
        x = _decode_blocks(em[None], v0[None], in_idx, in_w)[0]
        return x, torch.ones(0, dtype=torch.bool, device=dev)

    # window starts, clamped so every window lies inside the signal
    starts = torch.clamp(torch.arange(B, device=dev) * L - H, 0, T - W)
    win_idx = starts[:, None] + torch.arange(W, device=dev)[None, :]
    em_win = em[win_idx]                                  # (B, W, S)
    # emission-only init per block; block 0 gets the forced silent start
    v0 = em_win[:, 0, :].clone()
    v0[0, 0] = 0.0

    xb = _decode_blocks(em_win, v0, in_idx, in_w)         # (B, W)

    # seam s between blocks s, s+1 at absolute p=(s+1)*L, window [p-H, p+H)
    p = (torch.arange(B - 1, device=dev) + 1) * L
    offs = torch.arange(2 * H, device=dev)
    left_pos = (p - H - starts[:-1])[:, None] + offs[None, :]
    right_pos = (p - H - starts[1:])[:, None] + offs[None, :]
    left = torch.gather(xb[:-1], 1, left_pos)
    right = torch.gather(xb[1:], 1, right_pos)
    both_silent = (left == 0) & (right == 0)              # (B-1, 2H)
    # last common-silent offset <= H (retract-to-silence), else first > H,
    # else H (raw cut, flagged)
    le_mask = both_silent & (offs[None, :] <= H)
    gt_mask = both_silent & (offs[None, :] > H)
    has_le = le_mask.any(dim=1)
    has_gt = gt_mask.any(dim=1)
    last_le = (2 * H - 1) - torch.argmax(le_mask.flip(1).to(torch.uint8),
                                         dim=1)
    first_gt = torch.argmax(gt_mask.to(torch.uint8), dim=1)
    q = torch.where(has_le, last_le, torch.where(has_gt, first_gt, H))
    seam_ok = has_le | has_gt

    # stitch: block b owns absolute range [cut_{b-1}, cut_b)
    cuts = (p - H) + q
    t_abs = torch.arange(T, device=dev)
    owner = torch.searchsorted(cuts, t_abs, right=True)
    return xb[owner, t_abs - starts[owner]], seam_ok


def gather_block_decoder(in_idx, in_w, state_mu, sigma, *, device=None,
                         dtype=None):
    """The generic gather engine as a block decoder for
    overlap_save_decode_long ((B, W) windows, (B,) bool silent-start rows
    -> (B, W) int32 labels, on `device`): the JAX package's
    `overlap_save_decode_long` with block_decoder=None. Plain PyTorch on
    every device; emissions are computed a step at a time, so no (B, W, S)
    tensor exists."""
    in_idx, in_w, state_mu, sigma = _gather_tables(in_idx, in_w, state_mu,
                                                   sigma, device, dtype)

    def decode(y_win, sil):
        return _decode_blocks_from_y(y_win, sil, in_idx, in_w, state_mu,
                                     sigma)

    return decode


def resolve_block_engine(block_engine, overlaps, K, N, device):
    """Map "auto"/"cuda"/"cuda_ovn"/"ring" to the engine used for this
    topology.

    "cuda" is kernels 1-2 (N=2 with overlaps, K-1 <= 64, a CUDA device);
    "cuda_ovn" kernels 3-4 (overlaps, N >= 2, K-1 <= 64, a CUDA device, and
    the state of one window in one CTA's shared memory,
    ops/viterbi_ovn_mb.ovn_kernel_ok); "auto" takes "cuda" for N=2 and
    "cuda_ovn" for N >= 3 when their conditions hold, else "ring", the
    plain PyTorch engines. An explicit name is validated: a typo must not
    decode with another engine, and an explicit kernel engine that cannot
    run raises."""
    if block_engine not in ("auto", "cuda", "cuda_ovn", "ring"):
        raise ValueError(f"unknown block_engine {block_engine!r}; expected "
                         "'auto', 'ring', 'cuda' or 'cuda_ovn'")
    if block_engine == "ring":
        return "ring"
    on_cuda = torch.device(device).type == "cuda"
    ok_ov2 = overlaps and N == 2 and K - 1 <= KP and on_cuda
    ok_ovn = overlaps and ovn_kernel_ok(N, K) and on_cuda
    if block_engine == "cuda_ovn":
        if not ok_ovn:
            raise ValueError(
                "block_engine='cuda_ovn' requires an overlap topology with "
                f"N >= 2, K <= {KP + 1}, a state that fits one CTA's shared "
                "memory, and a CUDA device")
        return "cuda_ovn"
    if ok_ov2:
        return "cuda"
    if block_engine == "cuda":
        raise ValueError(
            "block_engine='cuda' requires the N=2 overlap topology with "
            f"K <= {KP + 1} on a CUDA device")
    if ok_ovn and N >= 3:
        return "cuda_ovn"
    return "ring"


def _edge_rows(T, L, H, B, W):
    """Static {row: realign shift} map of the windows clamped to a real
    signal edge. Besides rows 0 and B-1, row B-2's right halo overruns T
    iff 0 < T mod L < H."""
    edge_rows = {0: H, B - 1: (T - W) - ((B - 1) * L - H)}
    if B >= 3 and (B - 1) * L + H > T:
        edge_rows[B - 2] = (T - W) - ((B - 2) * L - H)
    return edge_rows


def _build_windows(y, *, T, L, H, B, W):
    """Uniform halo windows: row b covers [b*L - H, b*L - H + W) of the
    H-zero-padded signal (rows of one reshape plus a shifted head). Rows
    whose uniform window would cross a real signal edge decode the real
    edge instead and are rolled back after the decode. Trailing axes of y
    (T, ...) are kept: (B, W, ...).

    Returns (y_win (B, W, ...), edge_rows {row: realign shift})."""
    Tp = B * L
    pad = (0, 0) * (y.dim() - 1) + (H, Tp - T + (L - H))
    y_ext = F.pad(y, pad)                            # length Tp + L
    A = y_ext.reshape(B + 1, L, *y.shape[1:])
    y_win = torch.cat([A[:B], A[1:, : 2 * H]], dim=1)
    edge_rows = _edge_rows(T, L, H, B, W)
    for b in edge_rows:
        start = 0 if b == 0 else T - W
        y_win[b] = y[start:start + W]
    return y_win, edge_rows


def _snap_and_stitch(xb, *, T, L, H, B, edge_rows):
    """Silence-snap every seam and stitch (B, W) block labels into (T,).

    Returns (x (T,), seam_ok (B-1,))."""
    dev = xb.device
    Tp = B * L
    xb = xb.clone()
    for b, shift in edge_rows.items():               # to uniform coordinates
        xb[b] = torch.roll(xb[b], shift)
    left = xb[:-1, L:L + 2 * H]
    right = xb[1:, : 2 * H]
    both_silent = (left == 0) & (right == 0)
    offs = torch.arange(2 * H, device=dev)
    # positions at or past the true signal end hold rolled-in garbage on
    # the last row — never silence certificates
    p_all = (torch.arange(B - 1, device=dev) + 1) * L
    both_silent &= (p_all[:, None] - H + offs[None, :]) < T
    le_mask = both_silent & (offs[None, :] <= H)
    gt_mask = both_silent & (offs[None, :] > H)
    has_le = le_mask.any(dim=1)
    has_gt = gt_mask.any(dim=1)
    last_le = (2 * H - 1) - torch.argmax(le_mask.flip(1).to(torch.uint8),
                                         dim=1)
    first_gt = torch.argmax(gt_mask.to(torch.uint8), dim=1)
    q = torch.where(has_le, last_le, torch.where(has_gt, first_gt, H))
    seam_ok = has_le | has_gt
    cuts = p_all - H + q                             # (B-1,) absolute
    # position (b, i) (abs t = bL+i) belongs to b-1 if t < cut_{b-1}, to
    # b+1 if t >= cut_b, else to b
    core = xb[:, H:H + L]
    prev_full = torch.zeros_like(core)
    prev_full[1:, :H] = xb[:-1, L + H:L + 2 * H]
    next_full = torch.zeros_like(core)
    next_full[:-1, L - H:] = xb[1:, :H]
    t_grid = (torch.arange(B, device=dev) * L)[:, None] + \
        torch.arange(L, device=dev)[None, :]
    prev_cut = torch.cat([cuts.new_zeros(1), cuts])
    next_cut = torch.cat([cuts, cuts.new_full((1,), Tp)])
    x = torch.where(t_grid < prev_cut[:, None], prev_full,
                    torch.where(t_grid >= next_cut[:, None], next_full,
                                core)).reshape(-1)
    return x[:T], seam_ok


def _to_device(y, device, dtype):
    """The signal as a `dtype` tensor on `device`. Float samples are cast
    on the host (the same rounding, half the bytes to move when the working
    type is float32); integer samples travel raw and are cast on the
    device (float32 of an int16 is exact)."""
    if not isinstance(y, torch.Tensor):
        y = np.asarray(y)
        if np.issubdtype(y.dtype, np.floating):
            y = y.astype(numpy_dtype(dtype))
        y = torch.from_numpy(np.ascontiguousarray(y))
    return y.to(device).to(dtype)


def ring_overlap_save(y, lp, mu, sigma, *, L: int, H: int, overlaps: bool,
                      block_engine: str = "auto", device, dtype):
    """One-shot overlap-save decode on `device`: window build, every block
    decode in one batch, seam snap and stitch; the signal goes to the
    device once (integer samples raw, cast there) and only labels exist at
    the end.

    block_engine: "cuda" (kernels 1-2), "cuda_ovn" (kernels 3-4), "ring"
    (plain engines) or "auto" (resolve_block_engine). Returns (x (T,)
    int16/int32 tensor, seam_ok (B-1,) bool tensor), both on `device`.
    """
    if L < 2 * H:
        raise ValueError("need L >= 2H so seam cuts are monotone")
    mu_t = as_float(mu, dtype, device)
    K, N = mu_t.shape
    block_engine = resolve_block_engine(block_engine, overlaps, K, N, device)
    with profile_trace("decode.upload"):
        y = _to_device(y, device, dtype)
    T = y.shape[0]
    B = -(-T // L)
    W = L + 2 * H
    out_dtype = labels_dtype(n_states(N, K, overlaps))
    if B == 1 or T < W:
        # whole signal in one exact decode (no padding: fake trailing zeros
        # would alter the argmax termination at the true last sample,
        # src/viterbi.jl:90)
        engine = ring_engine(N, overlaps)
        with profile_trace("decode.windows"):
            x, _ = engine(y, lp, mu_t, sigma, silent_start=True,
                          with_ll=False)
        return x.to(out_dtype), torch.ones(0, dtype=torch.bool, device=device)
    with profile_trace("decode.windows"):
        y_win, edge_rows = _build_windows(y, T=T, L=L, H=H, B=B, W=W)
        sil0 = torch.arange(B, device=device) == 0     # forced silent start
        dec = ring_block_decoder(lp, mu_t, sigma, overlaps=overlaps,
                                 block_engine=block_engine, device=device,
                                 dtype=dtype)
        xb = dec(y_win, sil0)
    with profile_trace("decode.stitch"):
        x, seam_ok = _snap_and_stitch(xb, T=T, L=L, H=H, B=B,
                                      edge_rows=edge_rows)
        return x.to(out_dtype), seam_ok


def _build_windows_arrays(ys, *, T, L, H, B, W):
    """The halo windows of every row of a (Ch, T) batch: (Ch, B, W)
    (_build_windows over the channel axis kept as a trailing axis)."""
    y_win, _ = _build_windows(ys.T, T=T, L=L, H=H, B=B, W=W)
    return y_win.permute(2, 0, 1)


def ring_overlap_save_batched(ys, lp, mu, sigma, *, L: int, H: int,
                              overlaps: bool, block_engine: str = "auto",
                              device, dtype):
    """Channel-batched one-shot decode on `device`: (Ch, T) recordings ->
    (Ch, T) labels. Every channel's overlap-save windows fold into one
    batch of Ch*B windows, so kernels 1-2 (N=2) or 3-4 (N >= 3) decode all
    channels in one launch each on the card; the plain engines elsewhere.
    Same per-channel seam protocol and edge handling as ring_overlap_save.
    Returns (x (Ch, T) int16/int32 tensor, seam_ok (Ch, B-1) bool tensor),
    both on `device`."""
    if L < 2 * H:
        raise ValueError("need L >= 2H so seam cuts are monotone")
    K, N = np.shape(mu)
    if np.shape(ys)[1] < L + 2 * H:
        raise ValueError("signal shorter than one window; decode directly")
    block_engine = resolve_block_engine(block_engine, overlaps, K, N, device)
    return _ring_overlap_save_batched_impl(
        ys, lp, mu, sigma, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, device=device, dtype=dtype)


def _ring_overlap_save_batched_impl(ys, lp, mu, sigma, *, L, H, overlaps,
                                    block_engine, device, dtype):
    mu_t = as_float(mu, dtype, device)
    K, N = mu_t.shape
    ys = _to_device(ys, device, dtype)
    Ch, T = ys.shape
    B = -(-T // L)
    W = L + 2 * H
    out_dtype = labels_dtype(n_states(N, K, overlaps))
    y_win = _build_windows_arrays(ys, T=T, L=L, H=H, B=B, W=W)
    edge_rows = _edge_rows(T, L, H, B, W)
    sil = (torch.arange(B, device=device) == 0).repeat(Ch)
    dec = ring_block_decoder(lp, mu_t, sigma, overlaps=overlaps,
                             block_engine=block_engine, device=device,
                             dtype=dtype)
    xb = dec(y_win.reshape(Ch * B, W), sil).reshape(Ch, B, W)
    del y_win
    rows = [_snap_and_stitch(xb[c], T=T, L=L, H=H, B=B, edge_rows=edge_rows)
            for c in range(Ch)]
    return (torch.stack([x for x, _ in rows]).to(out_dtype),
            torch.stack([ok for _, ok in rows]))


def overlap_save_decode_long(y, *, L: int, H: int, block_decoder,
                             blocks_per_call: int = 8, prefetch: int = 2,
                             window_dtype, device, event_spec=None):
    """Host-driven overlap-save decode of arbitrarily long signals.

    Streams batches of `blocks_per_call` halo windows through
    `block_decoder` ((B, W) device windows, (B,) bool silent-start rows ->
    (B, W) device labels, e.g. ops/ring_viterbi.ring_block_decoder), then
    snaps every seam to common silence and stitches on the host. y may be
    multi-channel (T, C): windows are cut along time and keep the channel
    axis, (B, W, C) (ops/ring_viterbi_mc.mc_block_decoder). Choice
    memory is bounded by blocks_per_call * (L+2H) * K bytes.

    Windows are cut on the host, cast to `window_dtype` (raw integers stay
    integers: the decoder casts on the device) and shipped to `device`.
    `prefetch` chunk calls are dispatched before the oldest one's labels
    are fetched (CUDA launches are asynchronous; the fetch is the blocking
    point). prefetch=1 is the strictly serial loop.

    `event_spec=(N, K, overlaps)` switches each call's device-to-host copy
    to the packed spike-event blob (core/events.make_events_block_decoder,
    about 16x smaller at K=60); the labels are rebuilt exactly on the host:
    each window's decode is a valid path, so no fallback is needed.

    The JAX function's generic engine (its block_decoder=None) is
    `gather_block_decoder(in_idx, in_w, state_mu, sigma)` here, with
    window_dtype = state_mu's.

    Returns (x (T,) int32 numpy, seam_ok (B-1,) bool numpy).
    """
    if L < 2 * H:
        raise ValueError("need L >= 2H so seam cuts are monotone")
    if prefetch < 1:
        raise ValueError("prefetch must be >= 1")
    y = np.asarray(y)
    T = len(y)
    Tp = -(-T // L) * L                    # seam grid; windows themselves
    B = Tp // L                            # never extend past the real T
    W = L + 2 * H
    if T < W:
        raise ValueError("signal shorter than one window; decode directly")
    starts = np.clip(np.arange(B) * L - H, 0, T - W)
    starts[-1] = T - W                     # real termination at T, not pad
    labels = np.empty((B, W), np.int32)
    if event_spec is not None:
        from ..core.events import (make_events_block_decoder,
                                   unpack_window_blob)

        eN, eK, eov = event_spec
        block_decoder = make_events_block_decoder(block_decoder, N=eN,
                                                  K=eK, overlaps=eov)
    pending = deque()                      # (c0, c1, device labels or blob)

    def fetch_oldest():
        p0, p1, out = pending.popleft()
        if event_spec is not None:
            lab = unpack_window_blob(out.cpu().numpy(), B=blocks_per_call,
                                     W=W, N=eN, K=eK, overlaps=eov)
        else:
            lab = out[: p1 - p0].cpu().numpy()
        labels[p0:p1] = lab[: p1 - p0]

    for c0 in range(0, B, blocks_per_call):
        c1 = min(c0 + blocks_per_call, B)
        idx = starts[c0:c1, None] + np.arange(W)[None, :]
        y_win = y[idx].astype(window_dtype)
        if c1 - c0 < blocks_per_call:      # keep one batch shape
            padb = blocks_per_call - (c1 - c0)
            y_win = np.concatenate(
                [y_win, np.zeros((padb, W) + y.shape[1:], window_dtype)])
        # the block containing sample 0 gets the reference's forced silent
        # start (src/viterbi.jl:63)
        sil = np.zeros(len(y_win), bool)
        if c0 == 0:
            sil[0] = True
        out = block_decoder(torch.from_numpy(y_win).to(device),
                            torch.from_numpy(sil).to(device))
        pending.append((c0, c1, out))
        if len(pending) >= prefetch:
            fetch_oldest()
    while pending:
        fetch_oldest()

    # host-side seam snap + stitch (same protocol as _snap_and_stitch);
    # the last seam's window is clamped to the true signal end
    x = np.empty(T, np.int32)
    seam_ok = np.ones(B - 1, bool)
    cuts = np.empty(B - 1, np.int64)
    for s in range(B - 1):
        p = (s + 1) * L
        lo, hi = p - H, min(p + H, T)
        lw = labels[s, lo - starts[s]: hi - starts[s]]
        rw = labels[s + 1, lo - starts[s + 1]: hi - starts[s + 1]]
        both = (lw == 0) & (rw == 0)
        offs = np.arange(hi - lo)
        le = np.nonzero(both & (offs <= H))[0]
        gt = np.nonzero(both & (offs > H))[0]
        if len(le):
            q = le[-1]
        elif len(gt):
            q = gt[0]
        else:
            q = H
            seam_ok[s] = False
        cuts[s] = lo + q
    bounds = np.concatenate([[0], cuts, [T]])
    for b in range(B):
        a, e = bounds[b], bounds[b + 1]
        x[a:e] = labels[b, a - starts[b]: e - starts[b]]
    return x, seam_ok


def resolve_block_engine_mc(block_engine, overlaps, K, N, device):
    """The multi-channel mirror of resolve_block_engine: kernel 11 (with
    kernel 4) covers every overlap N >= 2 that
    ops/viterbi_ovn_mb.ovn_mc_kernel_ok admits, on a CUDA device. "auto"
    takes it there ("cuda_ovn") and the plain engines ("ring") elsewhere;
    "cuda" and "cuda_ovn" both name it (the JAX "pallas"/"pallas_ovn") and
    raise where it cannot run."""
    if block_engine not in ("auto", "cuda", "cuda_ovn", "ring"):
        raise ValueError(f"unknown block_engine {block_engine!r}; expected "
                         "'auto', 'ring', 'cuda' or 'cuda_ovn'")
    if block_engine == "ring":
        return "ring"
    feasible = (overlaps and N >= 2 and ovn_mc_kernel_ok(N, K)
                and torch.device(device).type == "cuda")
    if feasible:
        return "cuda_ovn"
    if block_engine != "auto":
        raise ValueError(
            f"block_engine={block_engine!r} (MC) requires an overlap "
            f"topology with N >= 2, K <= {KP + 1}, a state that fits one "
            "CTA's shared memory, and a CUDA device")
    return "ring"


def _mc_prepare(yc, mu, sigmas, *, L, H, overlaps, block_engine, device,
                dtype):
    """Shared MC front-end prep: resolve the engine, build the tables and
    project the channel streams on `device` (es (T,), d (T, N, K-1))."""
    from ..core.emission_mc import MCTables, mc_streams

    if L < 2 * H:
        raise ValueError("need L >= 2H so seam cuts are monotone")
    K, N, _ = np.shape(mu)
    block_engine = resolve_block_engine_mc(block_engine, overlaps, K, N,
                                           device)
    tables = MCTables(mu, sigmas)
    es, d = mc_streams(_to_device(yc, device, dtype), tables)
    return es, d, tables, block_engine


def mc_overlap_save(yc, lp, mu, sigmas, *, L: int, H: int, overlaps: bool,
                    block_engine: str = "auto", device, dtype):
    """Multi-channel one-shot overlap-save decode on `device`.

    yc: (T, C) observations; mu: (K, N, C) per-channel templates; sigmas:
    (C,) per-channel noise stds. The channel axis collapses before the
    windows are built: the factorised emission (core/emission_mc.py) turns
    yc into the streams (es, d) with one (T, C) x (C, N(K-1)) product, and
    windowing commutes with that pointwise map, so the halo windows are
    built over the stream features and the block decodes, seam snap and
    stitch are the single-channel machinery. block_engine: "auto" /
    "cuda_ovn" (kernels 11 and 4 on CUDA), "ring" (the plain engines: nov,
    the cross-form ov2, the direct-form ovn).

    Returns (x (T,) int16/int32 tensor, seam_ok (B-1,) bool tensor), both
    on `device`.
    """
    es, d, tables, block_engine = _mc_prepare(
        yc, mu, sigmas, L=L, H=H, overlaps=overlaps,
        block_engine=block_engine, device=device, dtype=dtype)
    return _mc_overlap_save_impl(es, d, lp, tables, L=L, H=H,
                                 overlaps=overlaps, block_engine=block_engine)


def _mc_overlap_save_impl(es, d, lp, tables, *, L, H, overlaps,
                          block_engine):
    from ..ops.ring_viterbi_mc import mc_stream_decoder

    T = es.shape[0]
    dev, dtype = es.device, es.dtype
    B = -(-T // L)
    W = L + 2 * H
    if B == 1 or T < W:
        # whole signal in one exact decode; the plain engine in the form
        # the kernel would use (direct at N=2 when kernel 11 is the engine)
        dec = mc_stream_decoder(lp, tables, overlaps=overlaps,
                                block_engine="ring", device=dev, dtype=dtype,
                                direct=block_engine == "cuda_ovn")
        x = dec(es[None], d[None], torch.ones(1, dtype=torch.bool,
                                              device=dev))[0]
        return x, torch.ones(0, dtype=torch.bool, device=dev)
    es_win, edge_rows = _build_windows(es, T=T, L=L, H=H, B=B, W=W)
    d_win, _ = _build_windows(d.reshape(T, -1), T=T, L=L, H=H, B=B, W=W)
    d_win = d_win.reshape(B, W, *d.shape[1:])
    sil0 = torch.arange(B, device=dev) == 0        # forced silent start
    dec = mc_stream_decoder(lp, tables, overlaps=overlaps,
                            block_engine=block_engine, device=dev,
                            dtype=dtype)
    xb = dec(es_win, d_win, sil0)
    del es_win, d_win
    return _snap_and_stitch(xb, T=T, L=L, H=H, B=B, edge_rows=edge_rows)
