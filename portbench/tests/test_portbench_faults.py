"""A run with the timed path broken underneath has to come out not correct:
each fault that a cell can have, planted in the program on the CPU at a
tiny size on the cell's own route (the streamed overlap-save, the chained
posteriors), the rest of the run driven as on the card. One card and no
exchange between cards, so no fault of that kind."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import run_tiny


def altered_labels(monkeypatch):
    from hmmspikesorter_torch.models import api

    real = api.overlap_save_decode_long

    def fault(*a, **k):
        x, ok = real(*a, **k)
        x = x.copy()
        x[len(x) // 2] = (x[len(x) // 2] + 1) % 3
        return x, ok

    monkeypatch.setattr(api, "overlap_save_decode_long", fault)


def half_labels(monkeypatch):
    from hmmspikesorter_torch.models import api

    real = api.overlap_save_decode_long

    def fault(*a, **k):
        x, ok = real(*a, **k)
        x = x.copy()
        x[len(x) // 2:] = 0
        return x, ok

    monkeypatch.setattr(api, "overlap_save_decode_long", fault)


def unchanged_step(monkeypatch):
    from hmmspikesorter_torch.train import em

    def fault(y, lp, mu, sigma, tables, **k):
        S = tables.states.shape[1]
        return lp, torch.zeros(S, dtype=mu.dtype), mu, sigma, torch.zeros(
            (), dtype=mu.dtype)

    monkeypatch.setattr(em, "em_step", fault)


def half_batch(monkeypatch):
    from hmmspikesorter_torch.train import em

    real = em.em_step
    monkeypatch.setattr(em, "em_step", lambda y, *a, **k: real(
        y[: len(y) // 2], *a, **k))


def altered_templates(monkeypatch):
    from hmmspikesorter_torch.models import api

    real = api.train_model

    def fault(*a, **k):
        res = real(*a, **k)
        res.mu = res.mu.copy()
        res.mu[len(res.mu) // 2, 0] += 0.05
        return res

    monkeypatch.setattr(api, "train_model", fault)


def altered_posterior(monkeypatch):
    from hmmspikesorter_torch.core import posterior

    real = posterior.onset_posteriors_chained

    def fault(*a, **k):
        p = np.array(real(*a, **k))
        p[len(p) // 2, 0] += 0.5
        return p

    monkeypatch.setattr(posterior, "onset_posteriors_chained", fault)


def half_posteriors(monkeypatch):
    from hmmspikesorter_torch.core import posterior

    real = posterior.onset_posteriors_chained

    def fault(*a, **k):
        p = np.array(real(*a, **k))
        p[len(p) // 2:] = 0.0
        return p

    monkeypatch.setattr(posterior, "onset_posteriors_chained", fault)


FAULTS = [("n2.sort", altered_labels), ("n2.sort", half_labels),
          ("n2.train", unchanged_step), ("n2.train", half_batch),
          ("n2.train", altered_templates),
          ("n2.confidence", altered_posterior),
          ("n2.confidence", half_posteriors)]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, plant, capsys, monkeypatch):
    plant(monkeypatch)
    rc, res, _ = run_tiny(cell, capsys)
    assert rc == 0
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
