"""Carry a template model's parameters, or an EM state, into this package
as numpy arrays, so that a model built elsewhere (e.g. by the JAX
package's training) is decoded here unchanged, or EM starts here from the
same point. Nothing of the other package is imported: the caller passes
its fields."""

from __future__ import annotations

import numpy as np

from .models.api import HMMTemplateModel
from .models.multichannel import HMMTemplateModelMC
from .train.em import TrainResult


def template_model_from_numpy(mu, sigma, lp,
                              allow_overlaps: bool) -> HMMTemplateModel:
    """mu: (K, N) templates; sigma: noise std; lp: (N,) onset log-probs."""
    return HMMTemplateModel(
        mu=np.array(mu, dtype=np.float64), sigma=float(sigma),
        lp=np.array(lp, dtype=np.float64), allow_overlaps=bool(allow_overlaps))


def template_model_mc_from_numpy(mu, sigmas, lp,
                                 allow_overlaps: bool) -> HMMTemplateModelMC:
    """mu: (K, N, C) per-channel templates; sigmas: (C,) per-channel noise
    stds; lp: (N,) onset log-probs (e.g. the fields of the JAX package's
    HMMTemplateModelMC or of its train_model_mc result)."""
    return HMMTemplateModelMC(
        mu=np.array(mu, dtype=np.float64),
        sigmas=np.array(sigmas, dtype=np.float64),
        lp=np.array(lp, dtype=np.float64), allow_overlaps=bool(allow_overlaps))


def train_result_from_numpy(lp, mu, sigma, pi=None,
                            ll_history=()) -> TrainResult:
    """An EM state (the fields of a TrainResult: lp (N,), mu (K, N), sigma,
    pi (S,) or None for the uniform init) as float64 numpy."""
    mu = np.array(mu, dtype=np.float64)
    K, N = mu.shape
    S = 1 + N * (K - 1)
    pi = (np.full(S, -np.log(S)) if pi is None
          else np.array(pi, dtype=np.float64))
    return TrainResult(lp=np.array(lp, dtype=np.float64), pi=pi, mu=mu,
                       sigma=float(sigma), n_neurons=N, K=K,
                       ll_history=[float(v) for v in ll_history])
