"""Entry `train`: template learning, models/api.fit_template_model, from
`n_init` random templates (drawn from a generator seeded for the
recording, so a recording's answer repeats), `nsteps` + `nsteps // 2`
Baum-Welch iterations with the template surgery between. The answer is
the learned templates, sigma and onset log-probs on the host.

Judged against reference/train.train in float64 from the same draws: the
templates kept, and the worst template's distance, sigma's and the onset
log-probs' errors."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import train

NO_MATCH = 1e300        # a number that no template of the other side has


class Entry:
    def __init__(self, cfg, traffic, device):
        from hmmspikesorter_torch.models import api

        self.api, self.cfg, self.traffic, self.device = api, cfg, traffic, device
        self.samples = int(traffic["samples"])
        self.args = traffic["args"]

    def setup(self, pool, seed):
        self.pool = pool
        self.seed = seed

    def rng(self, r):
        return np.random.default_rng([self.seed, r, 1])

    def call(self, r):
        y = self.pool[r][0]
        a = self.args
        tm = self.api.fit_template_model(y, a["n_init"], self.cfg["K"],
                                         nsteps=a["nsteps"], rng=self.rng(r),
                                         device=self.device)
        return {"mu": np.asarray(tm.mu), "sigma": float(tm.sigma),
                "lp": np.asarray(tm.lp)}, len(y)

    def meta(self, ans):
        a = self.args
        return {"T": self.samples, "K": self.cfg["K"],
                "phases": [(a["n_init"], a["nsteps"]),
                           (ans["mu"].shape[1], a["nsteps"] // 2)]}

    def release(self):
        pass

    def info(self, kept, pool):
        return [f"recording {r}: templates kept {answers[0]['mu'].shape[1]}, "
                f"generated {self.cfg['N']}"
                for r, answers in kept.items() if answers]

    def reference(self, r, y, dtype=torch.float64):
        ref = self.traffic["reference"]
        dev = "cuda" if self.device == "cuda" else "cpu"
        mu, sigma, lp = train.train(y, self.args["n_init"], self.cfg["K"],
                                    self.args["nsteps"], self.rng(r),
                                    device=dev, dtype=dtype, L=ref["L"],
                                    H=ref["H"])
        return {"mu": mu, "sigma": sigma, "lp": lp}

    def control(self, r, y, dtype):
        return self.reference(r, y, dtype)

    @staticmethod
    def compare(y, ans, ref):
        out = {"templates_kept_diff": float(abs(ans["mu"].shape[1]
                                                - ref["mu"].shape[1]))}
        if out["templates_kept_diff"] or ref["mu"].shape[1] == 0:
            out.update(mu_rel_err=NO_MATCH if out["templates_kept_diff"]
                       else 0.0, sigma_rel_err=abs(ans["sigma"] - ref["sigma"])
                       / ref["sigma"], lp_abs_err=NO_MATCH
                       if out["templates_kept_diff"] else 0.0)
            return out
        norms = np.linalg.norm(ref["mu"], axis=0)
        scale = np.maximum(norms, np.median(norms))
        d = np.linalg.norm(ans["mu"] - ref["mu"], axis=0) / scale
        out["mu_rel_err"] = float(d.max())
        out["sigma_rel_err"] = float(abs(ans["sigma"] - ref["sigma"])
                                     / ref["sigma"])
        out["lp_abs_err"] = float(np.abs(ans["lp"] - ref["lp"]).max())
        return out
