"""The port's target encoding (ppn_tpu_torch/ops/encode.py) against the JAX
package's encode_batch, and the encode → feature map → decode round trip.

Scenes where no two persons write the same (cell, class) must encode
bitwise equal. Where two do, the JAX package's combined .set scatter leaves
the winner unspecified; the port picks the highest person index among the
valid writers. There each cell's four box fields must come from that one
person, and delta and te (maxima, order-free) must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import random_people
from ppn_tpu.ops import encode as jenc
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.ops import decode as dec
from ppn_tpu_torch.ops import encode as enc
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


GT = ("keypoints", "visible", "bboxes", "valid")
# The JAX functions run op by op: under jit, XLA on the CPU rounds the
# part-box side differently (an ulp of tw/th on about 1% of cells).
_jax_encode = jenc.encode_batch
_jax_to_fm = jax.vmap(jenc.targets_to_feature_map, (None, 0))


def _batch(name, n, seed, persons, spread=1.0):
    """The synthetic dataset's GT (no pixels); ``spread`` > 1 scales
    coordinates about the image center, pushing some joints and boxes far
    outside the frame."""
    jcfg = jax_get_config(name)
    scenes = [random_people(np.random.default_rng(np.random.SeedSequence(
        [seed, i])), jcfg.model, jcfg.data.max_persons, persons)
        for i in range(n)]
    b = {k: np.stack([sc[k] for sc in scenes]) for k in GT}
    H, W = jcfg.model.insize
    c = np.array([W / 2, H / 2], np.float32)
    b["keypoints"] = (b["keypoints"] - c) * spread + c
    b["bboxes"][..., :2] = (b["bboxes"][..., :2] - c) * spread + c
    return b


def _writers(cfg, b):
    """{(image, y, x, class): the person indices that write there}."""
    H, W = cfg.outsize
    sy, sx = cfg.stride
    B, P = b["valid"].shape
    out = {}
    for i in range(B):
        for p in range(P):
            if not b["valid"][i, p]:
                continue
            cens = [b["bboxes"][i, p, :2]] + list(b["keypoints"][i, p])
            oks = [True] + list(b["visible"][i, p])
            for c, (cen, ok) in enumerate(zip(cens, oks)):
                x, y = np.floor(cen[0] / sx), np.floor(cen[1] / sy)
                if ok and 0 <= x < W and 0 <= y < H:
                    out.setdefault((i, int(y), int(x), c), []).append(p)
    return out


def _encode_both(name, b):
    cfg = get_config(name).model
    want = _jax_encode(jax_get_config(name).model, *(b[k] for k in GT))
    got = enc.encode_batch(cfg, *(torch.from_numpy(b[k]) for k in GT))
    return cfg, {f: np.asarray(getattr(want, f)) for f in want._fields}, \
        {f: getattr(got, f).numpy() for f in got._fields}


@pytest.mark.parametrize("name,persons,spread", [
    ("tiny_test", 1, 1.0), ("mpii_r18_384", 2, 1.0),
    ("mpii_r18_384", 2, 3.0)])
def test_encode_bitwise_without_collisions(name, persons, spread):
    b = _batch(name, 16, seed=4, persons=persons, spread=spread)
    cfg = get_config(name).model
    clean = [i for i in range(16) if not any(
        len(v) > 1 for k, v in _writers(cfg, b).items() if k[0] == i)]
    assert len(clean) >= 4, clean
    b = {k: v[clean[:4]] for k, v in b.items()}
    _, want, got = _encode_both(name, b)
    for f in want:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("name,persons", [("tiny_test", 3),
                                          ("mpii_r18_384", (6, 12))])
def test_encode_collisions_take_one_person(name, persons):
    b = _batch(name, 4, seed=7, persons=persons)
    cfg, want, got = _encode_both(name, b)
    np.testing.assert_array_equal(got["delta"], want["delta"])
    np.testing.assert_array_equal(got["te"], want["te"])
    sy, sx = cfg.stride
    img_h, img_w = cfg.insize
    collided = 0
    for (i, y, x, c), ps in _writers(cfg, b).items():
        fields = np.array([got[f][i, y, x, c] for f in ("tx", "ty", "tw",
                                                         "th")])
        if len(ps) == 1:
            for f in ("tx", "ty", "tw", "th"):
                assert got[f][i, y, x, c] == want[f][i, y, x, c]
            continue
        collided += 1
        p = max(ps)
        cen = b["bboxes"][i, p, :2] if c == 0 else b["keypoints"][i, p, c - 1]
        gx, gy = np.float32(cen[0] / sx), np.float32(cen[1] / sy)
        assert fields[0] == gx - np.floor(gx)
        assert fields[1] == gy - np.floor(gy)
        wh = b["bboxes"][i, p, 2:]
        if c == 0:
            np.testing.assert_array_equal(
                fields[2:], wh / np.array([img_w, img_h], np.float32))
        else:
            side = np.float32(0.2) * np.sqrt(np.float32(np.sum(wh * wh)))
            np.testing.assert_allclose(fields[2:],
                                       side / np.array([img_w, img_h]),
                                       rtol=1e-6)
    assert collided > 0


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384"])
def test_round_trip_through_feature_map_and_decode(name):
    """targets_to_feature_map agrees with the JAX package's, and the port's
    decode brings every GT box back at its responsible cell."""
    b = _batch(name, 4, seed=11, persons=1)
    cfg = get_config(name).model
    t = enc.encode_batch(cfg, *(torch.from_numpy(b[k]) for k in GT))
    fm = enc.targets_to_feature_map(cfg, t)
    jcfg = jax_get_config(name).model
    jfm = np.asarray(_jax_to_fm(jcfg, _jax_encode(jcfg, *(b[k] for k in GT))))
    np.testing.assert_allclose(fm.numpy(), jfm, rtol=1e-6, atol=1e-6)

    act, props = dec.decode(cfg, fm)
    sy, sx = cfg.stride
    for i in range(4):
        p = int(np.flatnonzero(b["valid"][i])[0])
        cx, cy = b["bboxes"][i, p, :2]
        y, x = int(cy // sy), int(cx // sx)
        assert float(t.delta[i, y, x, 0]) == 1.0
        assert float(props.score[i, y, x, 0]) > 0.99
        np.testing.assert_allclose(props.boxes[i, y, x, 0].numpy(),
                                   b["bboxes"][i, p], rtol=1e-3, atol=0.05)
    assert float(act.resp[t.delta < 0.5].max()) < 1e-4
