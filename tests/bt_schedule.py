"""The schedule of the backtrace chase machine's segment design
(hmmspikesorter_torch/csrc/bt_chase.cuh, kernels 2 and 4) in plain
PyTorch, for the tests: the CPU tests hold it against the plain
backtraces, and the card tests hold the kernels' fix-up pass counts
against it."""

import torch

from hmmspikesorter_torch.ops.bt_segments import TILE_MAX


def emulate_segments(prev, xT, W: int, G: int, tile: int = TILE_MAX):
    """The segment design's schedule in plain PyTorch: (labels (B, W) long,
    passes (B,), re-chased steps (B,)), counted as the kernels count them.

    prev(x, b, t): the (R,) states at t-1 given (R,) states x at steps t of
    windows b (the plain step trees, `ov2_back_step`, `ovn_back_step`)."""
    B = xT.shape[0]
    dev = xT.device
    labels = torch.zeros((B, W), dtype=torch.long, device=dev)
    passes = torch.zeros(B, dtype=torch.long, device=dev)
    fixed = torch.zeros(B, dtype=torch.long, device=dev)
    x_end = xT.long().clone()
    bb = torch.arange(B, device=dev)[:, None].expand(B, G)
    gg = torch.arange(G, device=dev)[None, :].expand(B, G)
    t1 = W
    while t1 > 0:
        t0 = max(0, t1 - tile)
        n = t1 - t0
        ln = -(-n // G)
        hi = t1 - gg * ln
        lo = torch.clamp(hi - ln, min=t0)
        on = hi > t0
        # the speculative chase: silent guesses, the top segment exact
        x = torch.where(gg == 0, x_end[:, None], torch.zeros_like(gg))
        t = hi - 1
        labels[bb[on], t[on]] = x[on]
        for _ in range(ln - 1):
            act = on & (t > lo)
            x[act] = prev(x[act], bb[act], t[act])
            t = torch.where(act, t - 1, t)
            labels[bb[act], t[act]] = x[act]
        out = torch.full((B, G), -1, dtype=torch.long, device=dev)
        has = on & (lo > 0)
        out[has] = prev(x[has], bb[has], lo[has])
        # fix-up passes, each window until no hand-off changed
        running = torch.ones(B, dtype=torch.bool, device=dev)
        while bool(running.any()):
            want = torch.cat([out[:, :1], out[:, :-1]], dim=1)
            top = labels[bb, (hi - 1).clamp(0, W - 1)]
            need = (running[:, None] & on & (gg > 0) & (want != top))
            x = want.clone()
            t = hi - 1
            labels[bb[need], t[need]] = x[need]
            fixed += need.sum(dim=1)
            act = need & (t > lo)
            met = torch.zeros_like(need)
            while bool(act.any()):
                x[act] = prev(x[act], bb[act], t[act])
                t = torch.where(act, t - 1, t)
                hit = act & (x == labels[bb, t.clamp(0, W - 1)])
                met |= hit
                write = act & ~hit
                labels[bb[write], t[write]] = x[write]
                fixed += write.sum(dim=1)
                act = write & (t > lo)
            ran = need & ~met
            new = out.clone()
            fin = ran & (lo > 0)
            new[fin] = prev(x[fin], bb[fin], lo[fin])
            changed = ran & (new != out)
            out = torch.where(changed, new, out)
            passes += running.long()
            running &= changed.any(dim=1)
        busy = -(-n // ln)
        x_end = out[:, busy - 1]
        t1 = t0
    return labels, passes, fixed
