"""Onset lists of a decoded label sequence (counterpart of the host part of
the JAX package's core/events.py).

On a valid path every neuron's ring phase advances deterministically after
its onset (reference transition semantics, src/types.jl:94-113), so the
labels are fully described by each neuron's onset times: the samples where
its phase equals 1, the timestamps extract_spiketimes aligns (reference
src/extraction.jl:15-24). `spike_confidence` and `core/qc.py` read them.

The packed form puts each neuron's onsets on a (N, ceil(T/G)) uint8 grid:
consecutive onsets of one neuron are at least K samples apart, so a chunk of
G <= K samples holds at most one, stored as its offset in the chunk (G when
there is none). The events-transfer decode that ships this grid instead of
the labels (`decode_events_overlap_save`, `labels_from_onsets`) belongs to a
later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch


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
      x: (T,) integer labels (a tensor or an array).

    Returns:
      packed: (N, ceil(T/G)) uint8 tensor: offset of the onset within each
        G-sample chunk, or G when the chunk has none (G = event_chunk(K)).
      counts: (N,) int32 tensor of true onset totals (on a valid path
        `(packed < G).sum(1) == counts`).
    """
    x = torch.as_tensor(x).to(torch.int32)
    T = x.shape[0]
    G = event_chunk(K)
    C = -(-T // G)
    offs = torch.arange(G, dtype=torch.int32, device=x.device).repeat(C)[:T]
    rows, counts = [], []
    for n in range(N):
        mask = phase_of(x, n, N, K, overlaps) == 1
        key = torch.where(mask, offs, torch.full_like(offs, G))
        key = torch.nn.functional.pad(key, (0, C * G - T), value=G)
        rows.append(key.reshape(C, G).amin(dim=1))
        counts.append(mask.sum().to(torch.int32))
    return torch.stack(rows).to(torch.uint8), torch.stack(counts)


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
