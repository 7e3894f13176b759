"""A dataset for the Loader's worker processes, which
tests/test_torch_port_tools.py runs in a process of its own."""

import numpy as np


class Items:
    """23 samples of their index and one draw of the worker's generator;
    with ``fail``, sample 17 raises."""

    def __init__(self, fail: bool = False):
        self.fail = fail

    def __len__(self):
        return 23

    def __getitem__(self, i, rng=None):
        if i == 17 and self.fail:
            raise ValueError("sample 17 is unreadable")
        return {"x": np.full((2,), i, np.float32),
                "r": np.asarray([rng.random()], np.float64)}
