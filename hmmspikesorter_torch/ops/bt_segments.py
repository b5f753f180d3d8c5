"""The launch plan of the backtrace chase machine (csrc/bt_chase.cuh) that
kernels 2 (csrc/viterbi_ov2_bt.cu) and 4 (csrc/viterbi_ovn_bt.cu) share.

A launch runs G lanes a window (one of SEGMENTS), each chasing its own
segment from a guessed end state (the silent state; the top segment's is
exact) with one global load a step, then fix-up passes until every
segment's end label is the hand-off of the segment above it (the
predecessor of that segment's first label).

Segment g of a tile [t0, t1) (tiles of at most `TILE_MAX` steps, from the
window's end) covers [max(t0, t1 - (g+1) len), t1 - g len) with len =
ceil((t1 - t0) / G): g = 0 is the latest.
"""

from __future__ import annotations

SEGMENTS = (32, 64, 128, 256, 512, 1024)   # the lane counts the kernels take
TILE_MAX = 49152         # csrc/bt_chase.cuh kTileMax: steps a shared tile
SEGMENT_STEPS = 16       # the plan's shortest segment
LANES_PER_SM = 512       # the plan's most lanes an SM (B windows of G)


def bt_launch_plan(B: int, W: int, sm_count: int,
                   segments: int | None = None) -> int:
    """The lanes a window G of kernels 2 and 4 for B windows of W steps on
    a card of sm_count SMs, or the forced `segments` (one of SEGMENTS).

    The most lanes a window, a power of two from 32 to 1024, that keeps
    segments at least SEGMENT_STEPS long (shorter ones chain more fix-up
    passes) and the card's lanes at most LANES_PER_SM an SM (B windows of G
    lanes); 32 at the least. On an H100 this came within 4% of the fastest
    forced G at every main-path shape."""
    if segments is not None:
        if segments not in SEGMENTS:
            raise ValueError(f"bt_launch_plan: segments {segments} not in "
                             f"{SEGMENTS}")
        return segments
    G = 32
    while (2 * G <= SEGMENTS[-1] and W >= 2 * G * SEGMENT_STEPS
           and B * 2 * G <= LANES_PER_SM * sm_count):
        G *= 2
    return G
