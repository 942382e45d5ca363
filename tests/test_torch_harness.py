"""The test harness's own rules for the port's tests: one PyTorch thread
(tests/torch_threads.py's fixture, taken by every port test file, which
sets no thread count of its own), and the deadline on the spawned two-rank
world (tests/torch_dist_worker.py's ``spawn``)."""

import glob
import os
import time

import pytest
import torch

import torch_dist_worker as worker
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def threads_in_a_module_fixture():
    return torch.get_num_threads()


def test_one_torch_thread(threads_in_a_module_fixture):
    """In the test and in the module's own module fixtures (a trained
    checkpoint, a spawned world), which run after the pin."""
    assert torch.get_num_threads() == 1
    assert threads_in_a_module_fixture == 1


def _port_test_files():
    """The port's test files: ``test_torch_*.py`` that use PyTorch or the
    port (``test_torch_import.py`` tests the JAX package's torchvision
    weight importer and uses neither)."""
    files = {}
    for path in glob.glob(os.path.join(TESTS, "test_torch_*.py")):
        with open(path) as f:
            text = f.read()
        if "ppn_tpu_torch" in text or "\nimport torch\n" in text:
            files[os.path.basename(path)] = text
    return files


def test_no_port_test_file_pins_threads_itself():
    files = _port_test_files()
    assert len(files) > 30
    unpinned = [name for name, text in files.items()
                if 'usefixtures("one_torch_thread")' not in text]
    pinning = [name for name, text in files.items()
               if "set_num_threads" in text
               and name != os.path.basename(__file__)]
    assert unpinned == [] and pinning == []


def test_spawn_kills_a_rank_past_its_deadline(tmp_path):
    """Rank 0 ends at once, rank 1 would sleep 300 s: at the 15 s deadline
    rank 1 is killed and the call fails naming it."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError,
                       match="rank 1 still alive after the 15 s deadline"):
        worker.spawn(worker.sleeping_rank, (str(tmp_path), 300.0), 2, 15)
    assert time.monotonic() - t0 < 60
    with open(tmp_path / "pid1") as f:
        pid = int(f.read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
