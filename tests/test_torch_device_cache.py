"""The port's on-disk render memo (ppn_tpu_torch/data/synthetic.py
``materialize_collated``) and the one-process side of its capacity-sharded
``DeviceCache``, against the JAX package's on the CPU. The two-rank cases
(each rank's rows against the JAX package's ``NamedSharding`` shards, the
gathered slices against the replicated cache) run in the two-rank world of
tests/test_torch_parallel.py.

``PPN_SYNTH_CACHE`` points each package at its own directory under
``tmp_path``: unset it would be the temporary directory's
``ppn_synth_cache``, which both packages share under different keys."""

import os

import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import SyntheticPoseDataset as JaxDataset
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.device_cache import DeviceCache, block_rows
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.parallel import Mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == np.asarray(w).tobytes(), k


@pytest.mark.parametrize("image_uint8", [True, False])
def test_materialize_collated_matches_jax(tmp_path, monkeypatch,
                                          image_uint8):
    """Miss (renders, writes ``<key>/*.npy`` and ``_complete``), hit (the
    same arrays, loaded read-only through mmap, nothing rendered) and
    ``PPN_SYNTH_CACHE=0`` (no memo): bitwise the JAX package's in each, and
    the keys of the two packages differ."""
    cfg, jcfg = get_config("tiny_test"), jax_get_config("tiny_test")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("PPN_SYNTH_CACHE", str(theirs))
    want = JaxDataset(jcfg, size=5, seed=3, num_persons=2
                      ).materialize_collated(image_uint8=image_uint8)
    monkeypatch.setenv("PPN_SYNTH_CACHE", str(ours))
    ds = SyntheticPoseDataset(cfg, size=5, seed=3, num_persons=2)
    _same(ds.materialize_collated(image_uint8=image_uint8), want)
    (entry,) = os.listdir(ours)
    assert entry not in os.listdir(theirs)
    assert sorted(os.listdir(ours / entry)) == sorted(
        ["_complete"] + [f"{k}.npy" for k in want])
    # a hit renders nothing
    monkeypatch.setattr(SyntheticPoseDataset, "__getitem__",
                        lambda self, i: pytest.fail("rendered on a hit"))
    hit = ds.materialize_collated(image_uint8=image_uint8)
    assert all(isinstance(v, np.memmap) and not v.flags.writeable
               for v in hit.values())
    _same(hit, want)
    monkeypatch.undo()
    monkeypatch.setenv("PPN_SYNTH_CACHE", "0")
    _same(ds.materialize_collated(image_uint8=image_uint8), want)
    assert os.listdir(ours) == [entry]


def test_memo_hit_lists_its_fields_as_a_miss_does(tmp_path, monkeypatch):
    """A hit lists the fields in ``collate``'s order, as the miss that
    wrote it and a run without the memo do (a hit used to list them by
    file name, and two ranks of one sharded cache, one hit and one render,
    then unpacked each other's rows in different orders)."""
    monkeypatch.setenv("PPN_SYNTH_CACHE", str(tmp_path))
    ds = SyntheticPoseDataset(get_config("tiny_test"), size=2, seed=4)
    miss = ds.materialize_collated()
    hit = ds.materialize_collated()
    monkeypatch.setenv("PPN_SYNTH_CACHE", "0")
    plain = ds.materialize_collated()
    assert isinstance(hit["image"], np.memmap)
    assert list(hit) == list(miss) == list(plain) == [
        "image", "keypoints", "visible", "bboxes", "valid"]
    assert list(DeviceCache(ds, device="cpu").data) == list(plain)


def test_materialize_collated_needs_the_complete_marker(tmp_path,
                                                        monkeypatch):
    """An entry without ``_complete`` (a writer cut off) is no hit: the set
    renders again, and the published entry is left to whoever completes
    it (a rename onto a non-empty directory fails and the loser cleans up
    its temporary directory)."""
    monkeypatch.setenv("PPN_SYNTH_CACHE", str(tmp_path))
    ds = SyntheticPoseDataset(get_config("tiny_test"), size=3, seed=1)
    first = ds.materialize_collated()
    (entry,) = os.listdir(tmp_path)
    os.remove(tmp_path / entry / "_complete")
    (tmp_path / entry / "image.npy").write_bytes(b"torn")
    again = ds.materialize_collated()
    _same(again, first)
    assert not isinstance(again["image"], np.memmap)
    assert os.listdir(tmp_path) == [entry]
    assert sorted(os.listdir(tmp_path / entry)) == sorted(
        f"{k}.npy" for k in first)


def test_device_cache_feeds_from_the_memo_and_reshards(tmp_path,
                                                       monkeypatch):
    """``DeviceCache`` takes a synthetic dataset's memo (one render of the
    set for two caches), holds writable copies of its rows, and
    ``block_rows`` is the JAX package's cyclic padding cut into contiguous
    blocks. A mesh of one rank holds every row; a sharded cache is not
    resharded again."""
    monkeypatch.setenv("PPN_SYNTH_CACHE", str(tmp_path))
    ds = SyntheticPoseDataset(get_config("tiny_test"), size=5, seed=2)
    renders = []
    real = SyntheticPoseDataset.__getitem__
    monkeypatch.setattr(SyntheticPoseDataset, "__getitem__",
                        lambda self, i: renders.append(i) or real(self, i))
    a = DeviceCache(ds, device="cpu")
    b = DeviceCache(ds, device="cpu")
    assert renders == list(range(5))
    assert all(torch.equal(v, b.data[k]) for k, v in a.data.items())
    a.data["image"][0, 0, 0, 0] = 7          # writable, not the memo
    np.testing.assert_array_equal(block_rows(5, 2, 0), [0, 1, 2])
    np.testing.assert_array_equal(block_rows(5, 2, 1), [3, 4, 0])
    np.testing.assert_array_equal(block_rows(1, 4, 3), [0])
    one = Mesh((1,), ("data",), torch.device("cpu"))
    c = DeviceCache(ds, device="cpu", mesh=one)
    assert c.nbytes() == b.nbytes()
    assert all(torch.equal(v, b.batch([4, 1, 0, 2])[k])
               for k, v in c.batch([4, 1, 0, 2]).items())
    with pytest.raises(ValueError, match="sharded already"):
        c.reshard(one)
