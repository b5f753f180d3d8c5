"""The comparison of a cell's kept answers with the plain reference, folded
into each number's worst reading beside its limit."""

from __future__ import annotations


def worst(readings, limits) -> dict:
    """readings: [{name: value}] -> {name: {"value": max, "limit": limit}}."""
    out = {}
    for reading in readings:
        for k, v in reading.items():
            out[k] = max(out.get(k, v), v)
    return {k: {"value": v, "limit": limits[k]} for k, v in out.items()}


def judge(entry, kept, pool, limits) -> dict:
    """kept {recording: [answer]}: the entry's reference worked out once a
    recording, each answer compared with it, the readings folded."""
    readings = []
    for r, answers in kept.items():
        y = pool[r][0]
        ref = entry.reference(r, y)
        readings += [entry.compare(y, ans, ref) for ans in answers]
    return worst(readings, limits)
