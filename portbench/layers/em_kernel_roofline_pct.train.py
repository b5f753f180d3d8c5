"""Kernels: the E-steps' least time on the card (work/counts.em_step on the
recording's T samples, for each iteration at its number of templates,
against work/peaks) over the device time of every kernel the fit
launched, in percent."""

from portbench.work import counts, peaks


def read(tr):
    least = kern = 0.0
    for c in tr.calls:
        m = c["meta"]
        for n, steps in m["phases"]:
            if n > 0:
                least += steps * peaks.least_seconds(
                    *counts.em_step(n, m["K"], m["T"]))
        kern += tr.kernel_s(c)
    return 100.0 * least / kern if kern > 0 else None
