"""Recording samples whose answer reached the host, over the whole window:
from its start to the last answer (a closed loop's last call ends past
the nominal close)."""


def read(w):
    return w.samples / w.seconds if w.samples else None
