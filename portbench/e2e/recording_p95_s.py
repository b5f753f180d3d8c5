"""The 95th percentile, over every recording answered in the window, of the
seconds from its call to its answer on the host."""

import numpy as np


def read(w):
    return float(np.percentile(w.latencies, 95)) if w.latencies else None
