"""The last parity leftovers of the port against the JAX package on the CPU:
``MetricLogger(tensorboard=True)`` (ppn_tpu_torch/utils/tb_events.py, no
TensorFlow) against the JAX logger's ``tf.summary`` file, read back by
TensorBoard and TensorFlow; ``make_grain_loader`` against the JAX
package's no-grain batches at 0 and 2 worker processes, and against its
grain path; ``num_params`` over the six registry configs; and the five
small public helpers of ops/boxes.py, ops/nms.py and ops/encode.py.

Tolerances: everything here is compared bitwise. The event files differ
only in ``wall_time`` and ``source_metadata``; the loaders move the same
samples; both ``num_params`` are integer counts; the box helpers and the
encoder evaluate the same f32 operations in the same order (the encoder on
scenes of one person, where no two writers share a cell and class); the
NMS oracle makes decisions only.
"""

import glob
import itertools
import os
import pickle
import re

import numpy as np
import pytest
import torch
from flax import nnx

import torch_loader_datasets
from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data import pipeline as jpipe
from ppn_tpu.data.synthetic import SyntheticPoseDataset as JaxDataset
from ppn_tpu.data.synthetic import random_people
from ppn_tpu.nn import PoseProposalNet as JaxModel
from ppn_tpu.nn import num_params as jax_num_params
from ppn_tpu.ops import boxes as jboxes
from ppn_tpu.ops import encode as jenc
from ppn_tpu.ops import nms as jnms
from ppn_tpu.ops.decode import Proposals as JaxProposals
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.data.pipeline import make_grain_loader
from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
from ppn_tpu_torch.nn import PoseProposalNet, num_params
from ppn_tpu_torch.ops import boxes, decode, encode, nms
from ppn_tpu_torch.testing import KINDS, feature_map_case
from ppn_tpu_torch.utils import tb_events
from ppn_tpu_torch.utils.logging import MetricLogger
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["mpii_r18_384", "mpii_r50_384", "coco_r18_384",
           "coco_r18_384_crowded", "mpii_r18_224_fast", "tiny_test"]
# chip_smoke.py phase 27 (chip/paths.py) holds the card's model to this
# count
MPII_R18_384_PARAMS = 14_254_006


# ---- TensorBoard event files ------------------------------------------------

# steps 0 (no step field), a negative one and one past 2³²; a NaN, a
# denormal, -0 and the largest f32; a numpy and a torch scalar
LOG_CALLS = [
    (0, {"loss_total": 1.25, "lr": 0.1}),
    (1, {"loss_total": float("nan"), "grad/norm": 1e-45}),
    (-3, {"loss_total": -0.0, "lr": np.float32(3.4e38)}),
    (2 ** 40, {"lr": torch.tensor(0.007), "loss_total": 2.5}),
]


@pytest.fixture(scope="module")
def event_files(tmp_path_factory):
    """The same ``log`` calls through the port's logger and the JAX
    package's (TensorFlow, imported once here: ~13 s). Returns the two
    event files, the two log directories and ``tf``."""
    import tensorflow as tf

    from ppn_tpu.utils.logging import MetricLogger as JaxLogger

    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("port", "jax")}
    for key, cls in (("port", MetricLogger), ("jax", JaxLogger)):
        logger = cls(dirs[key], stdout=False, tensorboard=True)
        for step, metrics in LOG_CALLS:
            logger.log(step, metrics)
        logger.close()
    files = {k: glob.glob(os.path.join(d, "tb", "train", "*"))
             for k, d in dirs.items()}
    assert all(len(f) == 1 for f in files.values()), files
    return {k: f[0] for k, f in files.items()}, dirs, tf


def _loaded(path):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)

    out = []
    for e in EventFileLoader(path).Load():
        e.ClearField("wall_time")
        e.ClearField("source_metadata")
        out.append(e)
    return out


def test_event_file_reads_back_as_the_references(event_files):
    """TensorBoard's loader yields the same events in the same order:
    file version, step, tag, dtype, shape, tensor bytes, plugin and data
    class (everything but the wall time and the writer's name)."""
    files, _, _ = event_files
    got, want = _loaded(files["port"]), _loaded(files["jax"])
    assert len(got) == 1 + sum(len(m) for _, m in LOG_CALLS)
    assert got[0].file_version == "brain.Event:2"
    assert [e.SerializeToString() for e in got] == [
        e.SerializeToString() for e in want]
    for e, (step, tag, value) in zip(got[1:], (
            (s, t, v) for s, m in LOG_CALLS for t, v in m.items())):
        (v,) = e.summary.value
        assert (e.step, v.tag, v.metadata.plugin_data.plugin_name) == (
            step, tag, "scalars")
        assert v.metadata.data_class == 1            # DATA_CLASS_SCALAR
        assert v.tensor.dtype == 1 and not v.tensor.tensor_shape.dim
        assert v.tensor.tensor_content == np.float32(float(value)).tobytes()


def test_event_file_is_named_and_placed_as_the_references(event_files):
    files, dirs, _ = event_files
    name = r"events\.out\.tfevents\.(\d+)\.(.+)\.(\d+)\.(\d+)\.v2"
    got = re.fullmatch(name, os.path.basename(files["port"]))
    want = re.fullmatch(name, os.path.basename(files["jax"]))
    assert got and want
    assert got[2] == want[2] and int(got[3]) == os.getpid()
    assert got[4] == want[4] == "0"
    assert os.path.dirname(files["port"]) == os.path.join(
        dirs["port"], "tb", "train")
    # the JSONL beside it is the logger's as before
    with open(os.path.join(dirs["port"], "train_metrics.jsonl")) as fh:
        assert len(fh.readlines()) == len(LOG_CALLS)


@pytest.mark.parametrize("flip", [None, "length", "length_crc", "payload",
                                  "payload_crc"])
def test_tensorflow_record_reader_checks_every_crc(event_files, tmp_path,
                                                   flip):
    """``tf_record_iterator`` reads every record of the port's file back
    byte for byte; one flipped byte in a record's length, its CRC, its
    payload or the payload's CRC is refused."""
    files, _, tf = event_files
    data = bytearray(open(files["port"], "rb").read())
    second = 12 + int.from_bytes(data[:8], "little") + 4   # record 2
    n = int.from_bytes(data[second:second + 8], "little")
    at = {"length": second, "length_crc": second + 8,
          "payload": second + 12 + n // 2,
          "payload_crc": second + 12 + n}
    path = str(tmp_path / "events")
    if flip is not None:
        data[at[flip]] ^= 0x10
    open(path, "wb").write(bytes(data))
    if flip is None:
        records = list(tf.compat.v1.io.tf_record_iterator(path))
        assert b"".join(tb_events.record(r) for r in records) == bytes(data)
        assert len(records) == 1 + sum(len(m) for _, m in LOG_CALLS)
    else:
        with pytest.raises(tf.errors.DataLossError):
            list(tf.compat.v1.io.tf_record_iterator(path))


def test_a_failed_event_write_raises(tmp_path):
    """No 'unavailable, continue' branch: a write or a flush that fails
    raises out of ``log``, and so does a log directory that cannot be
    made."""
    logger = MetricLogger(str(tmp_path), stdout=False, tensorboard=True)
    logger._tb._fh.close()
    logger._tb._fh = open("/dev/full", "wb")
    with pytest.raises(OSError):
        logger.log(1, {"loss_total": 1.0})
    (tmp_path / "blocked").mkdir()
    (tmp_path / "blocked" / "tb").write_text("a file where tb/ should be")
    with pytest.raises(OSError):
        MetricLogger(str(tmp_path / "blocked"), stdout=False,
                     tensorboard=True)


# ---- make_grain_loader ------------------------------------------------------

def _no_grain_path(jds, batch_size, seed, num_epochs):
    """ppn_tpu/data/pipeline.py:86-95, the JAX function's batches without
    grain, by name."""
    if num_epochs is None:
        return jpipe.infinite_batches(jds, batch_size, seed=seed)
    return (b for e in range(num_epochs) for b in jpipe.epoch_batches(
        jds, batch_size,
        rng=np.random.default_rng(np.random.SeedSequence([seed, e]))))


def _bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("num_workers,num_epochs,size", [
    (0, None, 10), (0, 2, 10), (0, None, 3), (0, 2, 3),
    (2, None, 10), (2, 2, 10), (2, None, 3)])
def test_loader_is_the_no_grain_path(num_workers, num_epochs, size):
    """Bitwise the JAX package's no-grain batches: endless epochs (the
    first five batches; a set smaller than the batch drawn with
    replacement) or ``num_epochs`` full-batch passes (none for a set
    smaller than the batch), in worker processes or not."""
    cfg, jcfg = get_config("tiny_test"), jax_get_config("tiny_test")
    ds = SyntheticPoseDataset(cfg, size=size, seed=3)
    jds = JaxDataset(jcfg, size=size, seed=3)
    got = list(itertools.islice(make_grain_loader(
        ds, 4, seed=5, num_workers=num_workers, num_epochs=num_epochs), 5))
    want = list(itertools.islice(_no_grain_path(jds, 4, 5, num_epochs), 5))
    assert len(want) == (0 if num_epochs and size < 4 else
                         4 if num_epochs else 5)
    _bitwise(got, want)


def test_loader_against_the_references_grain_path():
    """The JAX function with grain (installed here, not on the card): the
    same batch count, shapes and dtypes, and every sample one of the
    dataset's (grain's own shuffle order is not reproduced)."""
    jcfg = jax_get_config("tiny_test")
    jds = JaxDataset(jcfg, size=8, seed=2)
    grain = list(jpipe.make_grain_loader(jds, 4, seed=1, num_epochs=2))
    ours = list(make_grain_loader(
        SyntheticPoseDataset(get_config("tiny_test"), size=8, seed=2), 4,
        seed=1, num_epochs=2))
    assert len(grain) == len(ours) == 4
    for g, o in zip(grain, ours):
        assert {k: (v.shape, v.dtype) for k, v in g.items()} == {
            k: (v.shape, v.dtype) for k, v in o.items()}
    samples = {jds[i]["image"].tobytes() for i in range(len(jds))}
    for b in grain + ours:
        assert all(img.tobytes() in samples for img in b["image"])


def test_loader_worker_death_raises():
    """A worker that dies is an error in the caller, not a quiet drop to
    fewer workers."""
    ds = torch_loader_datasets.DiesAt(
        SyntheticPoseDataset(get_config("tiny_test"), size=8, seed=0), 5)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(make_grain_loader(ds, 4, num_workers=1, num_epochs=1))


def test_loader_workers_take_the_file_datasets(tmp_path):
    """An MPII tree of JPEGs (the native decoder) through 2 workers is
    bitwise the same batches in-process; the COCO dataset pickles and
    gives the same samples after."""
    from ppn_tpu_torch.data.coco import COCOKeypointsDataset
    from ppn_tpu_torch.data.mpii import MPIIDataset
    from ppn_tpu_torch.testing import write_coco_set, write_mpii_set

    cfg = get_config("tiny_test")
    src = SyntheticPoseDataset(cfg, size=4, seed=6, cache=True)
    write_mpii_set(cfg, str(tmp_path / "mpii"), {"train": (src, 4, 0)},
                   ext="jpg")
    ds = MPIIDataset(cfg, str(tmp_path / "mpii"),
                     str(tmp_path / "mpii" / "annot" / "train.json"))
    _bitwise(list(make_grain_loader(ds, 2, num_workers=2, num_epochs=1)),
             list(make_grain_loader(ds, 2, num_epochs=1)))
    write_coco_set(str(tmp_path / "coco"), src, 2, ext="jpg")
    coco = COCOKeypointsDataset(
        cfg, str(tmp_path / "coco"),
        str(tmp_path / "coco" / "annotations"
            / "person_keypoints_train2017.json"), "train2017")
    again = pickle.loads(pickle.dumps(coco))
    _bitwise([again[1]], [coco[1]])


# ---- num_params -------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_num_params_is_the_jax_count(name):
    """Counted on the meta device here and through ``nnx.eval_shape``
    there: no weights are made, ResNet-50 included."""
    with torch.device("meta"):
        model = PoseProposalNet(get_config(name).model)
    jmodel = nnx.eval_shape(
        lambda: JaxModel(jax_get_config(name).model, rngs=nnx.Rngs(0)))
    assert num_params(model) == jax_num_params(jmodel)
    if name == "mpii_r18_384":
        assert num_params(model) == MPII_R18_384_PARAMS
        # the buffers (BatchNorm's running statistics) are not counted
        assert sum(b.numel() for b in model.buffers()) > 0


def test_chip_smoke_pins_the_same_count():
    from chip import paths

    assert paths.MPII_R18_384_PARAMS == MPII_R18_384_PARAMS


# ---- the five public helpers ------------------------------------------------

def _boxes(rng, *shape):
    """Center-format boxes in a 64-pixel frame, some degenerate (w or h 0)."""
    b = np.concatenate([rng.uniform(0, 64, (*shape, 2)),
                        rng.uniform(0, 24, (*shape, 2))], -1)
    b[..., 2:][rng.random((*shape, 2)) < 0.1] = 0.0
    return b.astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_box_helpers_are_the_jax_functions(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 2, 7), _boxes(rng, 2, 5)
    t = torch.from_numpy
    pairs = [
        (boxes.box_area(t(a[..., 2:])), jboxes.box_area(a[..., 2:])),
        (boxes.cxcywh_to_tlbr(t(a)), jboxes.cxcywh_to_tlbr(a)),
        (boxes.pairwise_iou_cxcywh(t(a), t(b)),
         jboxes.pairwise_iou_cxcywh(a, b)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("name,kind", [
    *((n, k) for n in ("tiny_test", "mpii_r18_384") for k in KINDS),
    ("mpii_r18_384", "chain"), ("coco_r18_384_crowded", "normal"),
    ("coco_r18_384_crowded", "chain")])
def test_nms_single_scan_is_the_jax_oracle_and_the_waves(name, kind):
    """The sequential oracle keeps what the JAX package's keeps on the same
    proposals, and what the port's wave NMS keeps."""
    m, jm = get_config(name).model, jax_get_config(name).model
    for seed in range(2):
        fm = torch.from_numpy(feature_map_case(m, 1, seed, kind)[0])
        _, props = decode.decode(m, fm)
        got = nms.nms_single_scan(m, props)
        want = jnms.nms_single_scan(jm, JaxProposals(
            props.boxes.numpy(), props.score.numpy()))
        np.testing.assert_array_equal(got.keep.numpy(),
                                      np.asarray(want.keep))
        assert got.score.numpy().tobytes() == np.asarray(
            want.score).tobytes()
        waves = nms.nms_single(m, props)
        assert torch.equal(got.keep, waves.keep)


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384",
                                  "coco_r18_384"])
def test_encode_single_is_the_jax_function(name):
    m, jcfg = get_config(name).model, jax_get_config(name)
    for seed in range(3):
        gt = random_people(np.random.default_rng(seed), jcfg.model,
                           jcfg.data.max_persons, 1)
        args = [gt[k] for k in ("keypoints", "visible", "bboxes", "valid")]
        got = encode.encode_single(m, *args)
        want = jenc.encode_single(jcfg.model, *args)
        for f in want._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.shape == w.shape and g.dtype == w.dtype, f
            assert g.tobytes() == w.tobytes(), (seed, f)
        assert float(got.delta.sum()) > 0
