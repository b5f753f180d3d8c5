"""Training driver / EM step: the program's spans em.e_step and em.m_step,
per Baum-Welch iteration."""


def read(tr):
    total = sum(tr.span_s(c, ("em.e_step", "em.m_step")) for c in tr.calls)
    steps = sum(1 for c in tr.calls for s in tr.in_call(c, tr.spans)
                if s[0] == "em.e_step")
    return 1e3 * total / steps if steps else None
