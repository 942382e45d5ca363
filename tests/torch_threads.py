"""One PyTorch intra-op thread for a port test module.

The port's tensors in these tests are small, so PyTorch's thread pool only
adds overhead, and under the suite's parallel workers (``-n 6``) it
oversubscribes the cores. Each ``tests/test_torch_*.py`` takes the pin with

    from torch_threads import one_torch_thread  # noqa: F401
    pytestmark = pytest.mark.usefixtures("one_torch_thread")

and sets no thread count of its own. The fixture is module-scoped, so the
module's own module fixtures (a trained checkpoint, a spawned world) run
pinned as well; the old count comes back when the module ends. JAX's and
XLA's threading is left as it is.
"""

import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
