"""The combined ring-HMM state space, worked out from the model's semantics.

Plain NumPy; imports nothing of the program. Semantics (Herbst et al. 2008;
HMMSpikeSorter.jl src/types.jl): each of N neurons is silent (ring position
0) or plays its template at positions 1..K-1. A step advances every active
neuron (k -> k+1, K-1 -> 0); a neuron silent in the source state may start
a spike (0 -> 1). A state holds at most one active neuron without overlaps
and at most two with them. Per neuron a silent -> silent move weighs
lpz = log1p(-exp(sum(lp))), an onset lp[n], a ring move 0.

States are numbered as the reference Julia package numbers them (0-based):
state 0 all silent; 1 + n(K-1) + (k-1) neuron n alone at position k; then
for each pair i < j the (K-1)^2 positions (k1, k2), k1-major. The program's
labels use this numbering, so labels compare index for index.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import numpy as np


@dataclasses.dataclass(frozen=True)
class Space:
    N: int
    K: int
    overlaps: bool
    pos: np.ndarray      # (S, N) ring positions
    src: np.ndarray      # (E,) edge sources
    dst: np.ndarray      # (E,) edge targets
    nsil: np.ndarray     # (E,) neurons silent on both sides of the edge
    ons: np.ndarray      # (E, N) 1 where the edge starts a neuron's spike

    @property
    def S(self) -> int:
        return self.pos.shape[0]

    def edge_w(self, lp) -> np.ndarray:
        lp = np.asarray(lp, np.float64)
        lpz = np.log1p(-np.exp(lp.sum())) if lp.size else 0.0
        return self.nsil * lpz + self.ons @ lp

    def in_table(self, lp):
        """(S, D) sources of each state's in-edges, ascending (the first
        maximum among them wins a tie), padded with source 0 and weight
        -inf; and the (S, D) weights."""
        w = self.edge_w(lp)
        order = np.lexsort((self.src, self.dst))
        return _pad(self.dst[order], self.src[order], w[order], self.S)

    def out_table(self, lp):
        """(S, D) targets of each state's out-edges and their weights."""
        w = self.edge_w(lp)
        order = np.lexsort((self.dst, self.src))
        return _pad(self.src[order], self.dst[order], w[order], self.S)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.S)

    def state_means(self, mu) -> np.ndarray:
        """(S,) the sum over neurons of mu[position, neuron]."""
        mu = np.asarray(mu, np.float64)
        return mu[self.pos, np.arange(self.N)[None, :]].sum(axis=1)


def _pad(key, val, w, S):
    counts = np.bincount(key, minlength=S)
    D = int(counts.max())
    idx = np.zeros((S, D), np.int64)
    wt = np.full((S, D), -np.inf)
    start = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(key)) - start[key]
    idx[key, slot] = val
    wt[key, slot] = w
    return idx, wt


def build(N: int, K: int, overlaps: bool) -> Space:
    cols = [np.zeros(N, np.int64)]
    for n in range(N):
        for k in range(1, K):
            c = np.zeros(N, np.int64)
            c[n] = k
            cols.append(c)
    if overlaps:
        for i, j in combinations(range(N), 2):
            for k1 in range(1, K):
                for k2 in range(1, K):
                    c = np.zeros(N, np.int64)
                    c[i], c[j] = k1, k2
                    cols.append(c)
    pos = np.stack(cols)
    index = {tuple(p): s for s, p in enumerate(pos.tolist())}
    max_active = 2 if overlaps else 1
    src, dst, nsil, ons = [], [], [], []
    for s, p in enumerate(pos):
        adv = np.where(p == 0, 0, np.where(p == K - 1, 0, p + 1))
        silent = np.nonzero(p == 0)[0]
        for r in range(0, max_active + 1):
            for O in combinations(silent.tolist(), r):
                tgt = adv.copy()
                tgt[list(O)] = 1
                if int((tgt > 0).sum()) > max_active:
                    continue
                src.append(s)
                dst.append(index[tuple(tgt.tolist())])
                nsil.append(len(silent) - r)
                o = np.zeros(N, np.int64)
                o[list(O)] = 1
                ons.append(o)
    return Space(N, K, overlaps, pos, np.asarray(src), np.asarray(dst),
                 np.asarray(nsil, np.float64),
                 np.asarray(ons, np.float64).reshape(-1, N))


def path_score(y, x, space: Space, mu, sigma, lp) -> float:
    """The reference's cumulative score of path x (HMMSpikeSorter.jl
    src/viterbi.jl:92-96): the sum over t >= 1 of the running score
    T1[x_t, t] read along the path, with T1[0, 0] = 0 for a silent start.
    Along a path the running score is the prefix sum of its transition and
    emission terms, so this is O(T). An impossible move gives -inf."""
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.int64)
    sigma = float(sigma)
    m = space.state_means(mu)[x]
    em = -0.5 * np.log(2 * np.pi) - np.log(sigma) - (y - m) ** 2 / (2 * sigma ** 2)
    if len(x) < 2:
        return 0.0
    lp = np.asarray(lp, np.float64)
    w_of = {}
    for s, d, w in zip(space.src.tolist(), space.dst.tolist(),
                       space.edge_w(lp).tolist()):
        w_of[(s, d)] = w
    pair = x[:-1] * space.S + x[1:]
    uniq, inv = np.unique(pair, return_inverse=True)
    wu = np.array([w_of.get((int(u) // space.S, int(u) % space.S), -np.inf)
                   for u in uniq])
    steps = wu[inv] + em[1:]
    start = 0.0 if x[0] == 0 else em[0]
    return float((start + np.cumsum(steps)).sum())


def path_score_lowp(y, x, space: Space, mu, sigma, lp, dtype) -> float:
    """path_score with every term and sum in `dtype` (a torch type): the
    control's ll."""
    import torch

    x = np.asarray(x, np.int64)
    m = torch.as_tensor(space.state_means(mu)[x], dtype=dtype)
    yt = torch.as_tensor(np.asarray(y, np.float64), dtype=dtype)
    s = torch.tensor(float(sigma), dtype=dtype)
    c = torch.tensor(-0.5 * np.log(2 * np.pi) - np.log(sigma), dtype=dtype)
    em = c - (yt - m) ** 2 / (2 * s * s)
    lp = np.asarray(lp, np.float64)
    w_of = dict(zip(zip(space.src.tolist(), space.dst.tolist()),
                    space.edge_w(lp).tolist()))
    pair = x[:-1] * space.S + x[1:]
    uniq, inv = np.unique(pair, return_inverse=True)
    wu = np.array([w_of.get((int(u) // space.S, int(u) % space.S), -np.inf)
                   for u in uniq])
    steps = torch.as_tensor(wu[inv], dtype=dtype) + em[1:]
    start = 0.0 if x[0] == 0 else float(em[0])
    return float((start + torch.cumsum(steps, 0)).sum())
