"""Kernels: the exact posteriors' least time on the card
(work/counts.posteriors_ov2 on the recording's T samples against
work/peaks) over the device time of every kernel the call launched, in
percent. Reads nothing where the model is not the N=2 overlap space."""

from portbench.work import counts, peaks


def read(tr):
    least = kern = 0.0
    for c in tr.calls:
        m = c["meta"]
        if m["N"] != 2 or not m["overlaps"]:
            return None
        least += peaks.least_seconds(*counts.posteriors_ov2(m["K"], m["T"]))
        kern += tr.kernel_s(c)
    return 100.0 * least / kern if kern > 0 else None
