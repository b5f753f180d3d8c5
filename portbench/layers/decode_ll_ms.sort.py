"""Host ll: self time of the program's `decode.ll` span (core/path_score on
the host), per recording."""


def read(tr):
    v = [tr.self_s(c, "decode.ll") for c in tr.calls]
    return 1e3 * sum(v) / len(v) if any(v) else None
