"""The traced part of a `--trace 1` run: torch.profiler (CUPTI) over a few
calls of the window, read in memory into host spans, device intervals and
the calls they belong to. Nothing is written to disk.

The harness wraps each traced call in a `portbench.call` span; the
program's own `record_function` spans (`decode.*`, `em.*`) fall inside
them. A kernel or copy belongs to the call whose host span holds it: every
call ends with its result on the host, so its device work ends inside it.
"""

from __future__ import annotations

import torch

CALL = "portbench.call"


class Trace:
    """What the layer readers read: `spans` [(name, t0, t1)] of the host
    (seconds), `device` [(name, t0, t1, kind)] with kind "kernel" or
    "copy", `calls` [dict(t0, t1, meta)] and the traced `window` (t0, t1)."""

    def __init__(self, spans, device, calls, window):
        self.spans, self.device, self.calls, self.window = (
            spans, device, calls, window)

    def in_call(self, call, items):
        return [d for d in items if d[1] >= call["t0"] and d[2] <= call["t1"]]

    def kernel_s(self, call) -> float:
        return sum(d[2] - d[1] for d in self.in_call(call, self.device)
                   if d[3] == "kernel")

    def busy_s(self, t0=None, t1=None) -> float:
        """Seconds of [t0, t1] in which a kernel or copy ran (their union)."""
        t0 = self.window[0] if t0 is None else t0
        t1 = self.window[1] if t1 is None else t1
        return sum(b - a for a, b in _union(self.device, t0, t1))

    def span_s(self, call, names) -> float:
        return sum(s[2] - s[1] for s in self.in_call(call, self.spans)
                   if s[0] in names)

    def self_s(self, call, name) -> float:
        """A span's time minus what spans inside it cover."""
        inside = self.in_call(call, self.spans)
        total = 0.0
        for s in inside:
            if s[0] != name:
                continue
            kids = [k for k in inside if k is not s and k[1] >= s[1]
                    and k[2] <= s[2] and k[0] != CALL]
            total += (s[2] - s[1]) - sum(b - a for a, b in
                                         _union(kids, s[1], s[2]))
        return total

    def breakdown(self):
        by_name = {}
        for name, a, b, _ in self.device:
            if a >= self.window[0] and b <= self.window[1]:
                by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = _union(self.device, *self.window)
        gaps, last = [], self.window[0]
        for a, b in busy + [(self.window[1], self.window[1])]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            holders = [s for s in self.spans if s[1] <= mid <= s[2]]
            inner = min(holders, key=lambda s: s[2] - s[1], default=None)
            named.append([inner[0] if inner else "harness between calls",
                          b - a])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": named}


def _union(items, t0, t1):
    iv = sorted((max(d[1], t0), min(d[2], t1)) for d in items
                if d[2] > t0 and d[1] < t1)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Tracer:
    """Starts and stops one profiler session and reads its trace."""

    def __init__(self):
        self.prof = None
        self.events = []

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def call(self):
        return torch.profiler.record_function(CALL)

    def stop(self):
        self.prof.__exit__(None, None, None)
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None

    def read(self, metas) -> Trace:
        spans, device, calls = [], [], []
        base = min((e.start_ns() for e in self.events), default=0)
        on_card = []
        for e in self.events:
            t0 = (e.start_ns() - base) * 1e-9
            t1 = t0 + e.duration_ns() * 1e-9
            card = e.device_type() == torch.autograd.DeviceType.CUDA
            if e.is_user_annotation() and not card:
                spans.append((e.name(), t0, t1))
                if e.name() == CALL:
                    calls.append((t0, t1))
            elif card and not e.is_user_annotation():
                on_card.append((e.name(), t0, t1))
        # the card's copies of the host spans (gpu_user_annotation) are
        # neither kernels nor copies
        names = {s[0] for s in spans}
        for name, t0, t1 in on_card:
            if name in names:
                continue
            kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
            device.append((name, t0, t1, kind))
        calls.sort()
        if len(calls) != len(metas):
            raise RuntimeError(f"trace holds {len(calls)} calls, the run "
                               f"traced {len(metas)}")
        calls = [{"t0": a, "t1": b, "meta": m}
                 for (a, b), m in zip(calls, metas)]
        window = (calls[0]["t0"], calls[-1]["t1"])
        return Trace(spans, device, calls, window)
