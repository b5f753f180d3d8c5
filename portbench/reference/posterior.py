"""(T, N) onset posteriors, P(neuron n is at ring position 1 at sample t),
from the plain forward-backward of `hmm.py`. Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from . import hmm
from .space import Space


def onset_posteriors(y, mu, sigma, lp, space: Space, *, L=2048, H=512,
                     device="cpu", dtype=torch.float64, max_bytes=20 << 30):
    dev = torch.device(device)
    T = len(y)
    out = np.zeros((T, space.N))
    onset = torch.as_tensor((space.pos == 1).astype(np.float64), device=dev,
                            dtype=dtype)                         # (S, N)
    for grp in hmm.forward_backward(y, mu, sigma, lp, space, L=L, H=H,
                                    device=dev, dtype=dtype,
                                    max_bytes=max_bytes):
        W = grp["W"]
        rows = []
        for t0 in range(0, W, 512):
            ab = grp["alpha"][t0:t0 + 512] + grp["beta"][t0:t0 + 512]
            g = torch.exp(ab - hmm._lse(ab)[..., None])
            rows.append(g @ onset)                                # (n, G, N)
        p = torch.cat(rows).double().cpu().numpy()
        for j, (s, a) in enumerate(zip(grp["starts"], grp["core"])):
            b = min(a + grp["L"], T)
            out[a:b] = p[a - s:b - s, j]
    return out
