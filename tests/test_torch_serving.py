"""The port's micro-batching pose server (ppn_tpu_torch/serving.py): the
cases of tests/test_serving.py, on a CPU predictor (tiny_test, fresh init,
detection threshold 0.02 so that proposals survive)."""

import dataclasses
import threading

import numpy as np
import pytest

from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.inference import Predictor
from ppn_tpu_torch.serving import PoseServer, _bucket
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def predictor():
    cfg = get_config("tiny_test")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detection_thresh=0.02))
    return Predictor.from_checkpoint(cfg, None, device="cpu")


def _images(cfg, n, seed=0):
    ds = SyntheticPoseDataset(cfg, size=n, seed=seed, num_persons=1)
    return [np.clip(ds[i]["image"] * 255 + 0.5, 0, 255).astype(np.uint8)
            for i in range(n)]


def test_server_matches_direct_batch_bitwise(predictor):
    """One bucket's worth with a generous window: the server runs the
    (B, H, W, 3) shape a direct predict would, so every request's result is
    bitwise that image's row (no permutation, no mixing)."""
    imgs = _images(predictor.cfg, 4)
    want = predictor.predict(np.stack(imgs))
    with PoseServer(predictor, max_batch=4,
                    batch_window_ms=2000.0) as server:
        futs = [server.submit(im) for im in imgs]
        got = [f.result(timeout=300) for f in futs]
        stats = server.stats()
    assert stats == {"images": 4, "batches_by_size": {4: 1}}
    assert want.kp_score.any()
    for i, g in enumerate(got):
        for name in want._fields:
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(want, name)[i],
                                          err_msg=f"request {i} field {name}")


def test_server_pads_to_bucket_and_survives_odd_counts(predictor):
    imgs = _images(predictor.cfg, 3, seed=1)
    with PoseServer(predictor, max_batch=8,
                    batch_window_ms=1000.0) as server:
        got = [f.result(timeout=300)
               for f in [server.submit(im) for im in imgs]]
        stats = server.stats()
    assert stats["images"] == 3
    assert list(stats["batches_by_size"]) == [4]  # 3 padded to bucket 4
    assert [_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    want = predictor.predict(np.stack(imgs + [np.zeros_like(imgs[0])]))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.valid, want.valid[i])
        np.testing.assert_array_equal(g.kp_cell, want.kp_cell[i])


def test_server_concurrent_clients_each_get_their_own(predictor):
    imgs = _images(predictor.cfg, 8, seed=2)
    results = [None] * len(imgs)
    with PoseServer(predictor, max_batch=8,
                    batch_window_ms=500.0) as server:
        def client(i):
            results[i] = server.predict(imgs[i], timeout=300)

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(imgs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
    # each result against a direct single predict: decisions must match
    # (float low bits may differ across batch shapes)
    for i, g in enumerate(results):
        want = predictor.predict_single(imgs[i])
        np.testing.assert_array_equal(g.valid, want.valid,
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(g.kp_score > 0, want.kp_score > 0,
                                      err_msg=f"request {i}")
        v = want.valid
        if v.any():
            np.testing.assert_array_equal(g.kp_cell[v], want.kp_cell[v],
                                          err_msg=f"request {i}")


def test_server_rejects_bad_shapes_and_closes(predictor):
    server = PoseServer(predictor, max_batch=2, batch_window_ms=1.0)
    with pytest.raises(ValueError):
        server.submit(np.zeros((8, 8, 3), np.uint8))
    server.close()
    server.close()                      # a second close is a no-op
    with pytest.raises(RuntimeError):
        server.submit(np.zeros((*predictor.cfg.model.insize, 3), np.uint8))
    with pytest.raises(ValueError):
        PoseServer(predictor, max_batch=3)


def test_server_survives_cancelled_futures(predictor):
    """A Future cancelled while queued must not kill the dispatcher
    (set_result on a cancelled Future raises); the server keeps serving."""
    imgs = _images(predictor.cfg, 4, seed=3)
    with PoseServer(predictor, max_batch=4,
                    batch_window_ms=300.0) as server:
        futs = [server.submit(im) for im in imgs[:3]]
        futs[1].cancel()  # may or may not win the race with the dispatcher
        for i in (0, 2):
            assert futs[i].result(timeout=300) is not None
        # still alive and serving after the cancellation
        assert server.predict(imgs[3], timeout=300) is not None
        server.warmup(dtypes=(np.uint8,))   # every bucket shape runs
