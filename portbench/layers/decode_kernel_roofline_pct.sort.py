"""Kernels: the decode's least time on the card (work/counts.decode on the
recording's T samples against work/peaks) over the device time of every
kernel the call launched, in percent."""

from portbench.work import counts, peaks


def read(tr):
    least = kern = 0.0
    for c in tr.calls:
        m = c["meta"]
        least += peaks.least_seconds(*counts.decode(m["N"], m["K"],
                                                    m["overlaps"], m["T"]))
        kern += tr.kernel_s(c)
    return 100.0 * least / kern if kern > 0 else None
