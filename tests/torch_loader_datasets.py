"""A dataset for tests/test_torch_leftovers.py that a loader worker process
can unpickle without importing the test module (and JAX with it)."""

import os
import signal


class DiesAt:
    """``dataset`` whose sample ``index`` kills the process that reads it."""

    def __init__(self, dataset, index: int):
        self.dataset, self.index = dataset, index

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        if i == self.index:
            os.kill(os.getpid(), signal.SIGKILL)
        return self.dataset[i]
