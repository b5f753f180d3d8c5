"""Posterior driver: the wall of one model_posteriors call minus the time in
it during which the card ran a kernel or a copy, per call (measured from
outside: core/posterior.py has no spans)."""


def read(tr):
    v = [(c["t1"] - c["t0"]) - tr.busy_s(c["t0"], c["t1"]) for c in tr.calls]
    return 1e3 * sum(v) / len(v) if v else None
