"""Entry `confidence`: exact onset posteriors, core/posterior.
model_posteriors, of a model, one recording a call (the CLI's `--confidence`). Set-up
builds each recording's model object from the configuration's templates
and the recording (model_posteriors reads nothing else of it, so nothing
is decoded). The answer is the (T, N) posteriors on the host.

Judged against reference/posterior.onset_posteriors in float64: the
largest posterior error and the error of each neuron's expected onset
count."""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen.pool import templates
from portbench.reference import posterior, space


class Entry:
    def __init__(self, cfg, traffic, device):
        from hmmspikesorter_torch.core import posterior as post
        from hmmspikesorter_torch.models import api

        self.api, self.post = api, post
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.mu = templates(cfg)
        self.lp = np.log(np.asarray(cfg["pp"], np.float64))
        self.tm = api.HMMTemplateModel(self.mu, cfg["sigma"], self.lp,
                                       allow_overlaps=cfg["overlaps"])
        self.samples = (cfg["recording_samples"] if traffic["samples"] ==
                        "recording" else int(traffic["samples"]))
        self.space = space.build(cfg["N"], cfg["K"], cfg["overlaps"])

    def setup(self, pool, seed):
        self.models = [self.api.HMMSpikingModel(
            self.tm, np.zeros(len(y), np.int32), 0.0, y) for y, _ in pool]

    def call(self, r):
        p = self.post.model_posteriors(self.models[r], device=self.device)
        return np.asarray(p), p.shape[0]

    def meta(self, ans):
        return {"T": ans.shape[0], "N": self.cfg["N"], "K": self.cfg["K"],
                "overlaps": self.cfg["overlaps"]}

    def release(self):
        self.models = None

    def info(self, kept, pool):
        return [f"recording {r}: expected onsets "
                f"{np.round(answers[0].sum(axis=0), 3).tolist()}, generated "
                f"{np.bincount([c for _, c in pool[r][1]], minlength=self.cfg['N']).tolist()}"
                for r, answers in kept.items() if answers]

    def reference(self, r, y, dtype=torch.float64):
        ref = self.traffic["reference"]
        dev = "cuda" if self.device == "cuda" else "cpu"
        return posterior.onset_posteriors(y, self.mu, self.cfg["sigma"],
                                          self.lp, self.space, L=ref["L"],
                                          H=ref["H"], device=dev, dtype=dtype)

    def control(self, r, y, dtype):
        return self.reference(r, y, dtype)

    @staticmethod
    def compare(y, p, p_ref):
        p = np.asarray(p, np.float64)
        mass = p_ref.sum(axis=0)
        return {"post_max_abs_err": float(np.abs(p - p_ref).max()),
                "onset_mass_rel_err": float(
                    (np.abs(p.sum(axis=0) - mass) / mass).max())}
