"""Entry `sort`: the production decode, models/api.fit_spiking_model_fast,
on one recording a call. The answer is the labels, the ll and the seam
flags on the host.

Judged against reference/hmm.viterbi in float64 on `check_windows` of the
reference's windows, the first, the last and the rest drawn from the seed
(the whole recording's reference outlasts the window): the share of their
labels that differ (the decode), the program's ll against the reference's
path score of the program's labels over the whole recording (the host ll),
and the seams left flagged over the whole recording (overlap-save and its
repair)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen.pool import templates
from portbench.reference import hmm, space


def onset_counts(x, pos):
    """(N,) spikes started along a label path: position 1 of each neuron."""
    p = pos[np.asarray(x, np.int64)]
    return (p == 1).sum(axis=0)


class Entry:
    def __init__(self, cfg, traffic, device):
        from hmmspikesorter_torch.models import api

        self.api, self.cfg, self.traffic, self.device = api, cfg, traffic, device
        self.mu = templates(cfg)
        self.lp = np.log(np.asarray(cfg["pp"], np.float64))
        self.tm = api.HMMTemplateModel(self.mu, cfg["sigma"], self.lp,
                                       allow_overlaps=cfg["overlaps"])
        self.samples = (cfg["recording_samples"] if traffic["samples"] ==
                        "recording" else int(traffic["samples"]))
        self.space = space.build(cfg["N"], cfg["K"], cfg["overlaps"])

    def setup(self, pool, seed):
        self.pool, self.seed = pool, seed

    def call(self, r):
        y = self.pool[r][0]
        m = self.api.fit_spiking_model_fast(self.tm, y, device=self.device,
                                            **self.traffic["args"])
        return {"x": np.asarray(m.ml_seq), "ll": float(m.ll),
                "seam_ok": np.asarray(m.seam_ok, bool)}, len(y)

    def meta(self, ans):
        return {"T": len(ans["x"]), "N": self.cfg["N"], "K": self.cfg["K"],
                "overlaps": self.cfg["overlaps"]}

    def release(self):
        self.tm = None

    def info(self, kept, pool):
        lines = []
        for r, answers in kept.items():
            if answers:
                found = onset_counts(answers[0]["x"], self.space.pos)
                truth = np.bincount([c for _, c in pool[r][1]],
                                    minlength=self.cfg["N"])
                lines.append(f"recording {r}: onsets decoded "
                             f"{found.tolist()}, generated {truth.tolist()}")
        return lines

    def windows(self, r, T):
        """The reference's windows compared for recording r: the first, the
        last and a uniform draw of the rest."""
        L = self.traffic["reference"]["L"]
        B = -(-T // L)
        n = min(self.traffic["check_windows"], B)
        rest = np.random.default_rng([self.seed, r, 2]).choice(
            np.arange(1, B - 1), size=max(n - 2, 0), replace=False)
        return np.unique(np.concatenate([[0, B - 1], rest])).astype(np.int64)

    def reference(self, r, y, dtype=torch.float64):
        """Labels on the drawn windows, -1 elsewhere."""
        ref = self.traffic["reference"]
        dev = "cuda" if self.device == "cuda" else "cpu"
        return hmm.viterbi(y, self.mu, self.cfg["sigma"], self.lp,
                           self.space, L=ref["L"], H=ref["H"], device=dev,
                           dtype=dtype, select=self.windows(r, len(y)))

    def control(self, r, y, dtype):
        """The reference in the program's place, labels and ll computed at a
        lower precision; the samples outside the drawn windows read silent."""
        x = np.maximum(self.reference(r, y, dtype), 0)
        ll = space.path_score_lowp(y, x, self.space, self.mu,
                                   self.cfg["sigma"], self.lp, dtype)
        return {"x": x, "ll": ll, "seam_ok": np.ones(0, bool)}

    def compare(self, y, ans, x_ref):
        s_prog = space.path_score(y, ans["x"], self.space, self.mu,
                                  self.cfg["sigma"], self.lp)
        ll_err = (abs(ans["ll"] - s_prog) / abs(s_prog)
                  if np.isfinite(s_prog) else np.inf)
        on = x_ref >= 0
        return {"label_mismatch": float(np.mean(ans["x"][on] != x_ref[on])),
                "ll_rel_err": float(ll_err),
                "seams_flagged": float((~ans["seam_ok"]).sum())}
