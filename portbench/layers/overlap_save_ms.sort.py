"""Overlap-save: what a decode call spends outside the host ll, per
recording: the call's wall minus its `decode.ll` span. That is the windows
cut and shipped, the block decoder's kernels, the label download, the
stitch and the seam repair; the streaming path carries no spans of its
own to split it further."""


def read(tr):
    v = [(c["t1"] - c["t0"]) - tr.span_s(c, ("decode.ll",)) for c in tr.calls
         if tr.span_s(c, ("decode.ll",)) > 0]
    return 1e3 * sum(v) / len(v) if v else None
