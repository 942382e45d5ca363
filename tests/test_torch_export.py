"""The port's export of the inference pipeline (ppn_tpu_torch/utils/
export.py, ``torch.export``) and the bounded NMS it traces, on the CPU.

The round trip is held against the live plain pipeline on the same
weights: ``valid`` equal, the floats within 4 ulps (the exported graph runs
the same ATen operations). The bounded NMS runs exactly H'·W' waves and is
held bitwise against the early-exit loop. The exported People are held
against the JAX package's ``export_pipeline`` on the same parameters
within tests/test_export.py's tolerances (rtol 5e-3, atol 5e-2 on the
boxes; ``valid`` equal).

The weights are tests/test_torch_model.py's seeded ones (seed 5, which
keeps persons on these images at detection_thresh 0.02; see
tests/test_torch_tta.py), in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.data.synthetic import SyntheticPoseDataset
from ppn_tpu.train import steps as jst
from ppn_tpu.utils.export import export_pipeline as jax_export_pipeline
from ppn_tpu.utils.export import load_pipeline as jax_load_pipeline
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.ops import decode as dec
from ppn_tpu_torch.ops import nms as nmsops
from ppn_tpu_torch.ops.postprocess import postprocess_batch_plain
from ppn_tpu_torch.testing import KINDS, feature_map_case, max_ulp
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.utils.export import export_pipeline, load_pipeline
from ppn_tpu_torch.utils.params_io import state_dict_from_jax_leaves

from test_torch_model import _jax_template, _numpy_leaves

BATCH = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tensors here are small: PyTorch's thread pool only adds overhead, and
    under the suite's parallel workers it oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NMS_CASES = [(name, kind) for name in ("tiny_test", "mpii_r18_384")
             for kind in KINDS] + [("mpii_r18_384", "chain"),
                                   ("coco_r18_384_crowded", "chain")]


@pytest.mark.parametrize("name,kind", NMS_CASES)
def test_bounded_nms_is_bitwise_the_early_exit_loop(name, kind):
    """Every seeded map kind (``chain``, where every proposal is a candidate
    and keeps alternate along rows, needs the most waves; it needs a grid
    wider than tiny_test's)."""
    m = get_config(name).model
    fm = torch.from_numpy(feature_map_case(m, BATCH, seed=3, kind=kind))
    _, props = dec.decode(m, fm)
    want = nmsops.nms_batch(m, props)
    got = nmsops.nms_batch(m, props, bounded=True)
    assert torch.equal(got.keep, want.keep)
    assert torch.equal(got.score, want.score)


@pytest.fixture(scope="module")
def exported():
    """The f32 tiny_test weights on both sides, the port's exported
    artifact and its reloaded callable, its images and the JAX (graphdef,
    state)."""
    jcfg, cfg = jax_get_config("tiny_test"), get_config("tiny_test")
    jcfg, cfg = (dataclasses.replace(
        c, train=dataclasses.replace(c.train, dtype="float32",
                                     ema_decay=0.0),
        model=dataclasses.replace(c.model, detection_thresh=0.02))
        for c in (jcfg, cfg))
    graphdef, flat, treedef = _jax_template(jcfg.model, jnp.float32)
    leaves = _numpy_leaves(flat, seed=5)
    tree = jax.tree.unflatten(treedef, leaves)
    jstate = jst.TrainState(params=tree["params"], rest=tree["rest"],
                            opt_state=None, step=0,
                            rng=jax.random.PRNGKey(0))
    state = st.create_train_state(cfg, device="cpu")
    state.model.load_state_dict(
        state_dict_from_jax_leaves(cfg, leaves, state.model))
    ds = SyntheticPoseDataset(jcfg, size=BATCH, seed=6, num_persons=2)
    images = np.stack([ds[i]["image"] for i in range(BATCH)])
    blob = export_pipeline(cfg, state, batch=BATCH, device="cpu")
    return cfg, state, images, (blob, load_pipeline(blob)), (jcfg, graphdef,
                                                             jstate)


def test_export_roundtrip(exported):
    cfg, state, images, (blob, run), _ = exported
    assert isinstance(blob, bytes) and len(blob) > 10_000
    kp_box, kp_score, valid = run(images)
    with torch.no_grad():
        want = postprocess_batch_plain(
            cfg.model, st.eval_model(state)(torch.from_numpy(images)))
    assert valid.any()
    assert torch.equal(valid, want.valid)
    assert max_ulp(kp_box.numpy(), want.kp_box.numpy()) <= 4
    assert max_ulp(kp_score.numpy(), want.kp_score.numpy()) <= 4


def test_exported_pipeline_runs_on_its_device_and_floats_only(exported):
    _, _, images, (_, run), _ = exported
    with pytest.raises(ValueError, match="exported for cpu"):
        run(torch.zeros((BATCH, 64, 64, 3), device="meta"))
    # the graph was traced for floats in [0, 1]: uint8 would not be scaled
    with pytest.raises(ValueError, match="uint8"):
        run((images * 255).astype(np.uint8))
    # numpy images are uploaded to the artifact's device; tensors there run
    a, b = run(images), run(torch.from_numpy(images))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_exported_people_match_the_jax_export(exported):
    _, _, images, (_, run), (jcfg, graphdef, jstate) = exported
    want = jax.device_get(jax_load_pipeline(
        jax_export_pipeline(jcfg, graphdef, jstate, batch=BATCH))(images))
    got = run(images)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=5e-3, atol=5e-2)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
