"""95th percentile over every batch of the window of the time from its
first frame entering ``predict_stream`` to its last result (host clock)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.array(ctx["latencies_s"]), 95)) * 1e3
