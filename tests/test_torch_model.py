"""The port's model (ppn_tpu_torch.nn) against the JAX PoseProposalNet.

The same weights — made with numpy from a seed, BN statistics included —
go into both models: into the JAX one by ``nnx.merge`` and into the port
through ``state_dict_from_jax_leaves``, the snapshot loader's own path. The
same uint8 images go through both; the logits are compared.

Tolerances, relative to the largest logit |want|:
  * f32 compute on both sides: 2e-5. The two frameworks sum the conv dot
    products in different orders (up to 4608 terms over ~20 layers), which
    costs a few hundred f32 eps at most; a wrong pad, BN term or layout
    moves logits by O(1).
  * bf16 compute: 3e-2, about 8 bf16 eps (2^-8). Both sides round to bf16
    after every conv, BN step and residual add, but XLA may keep some
    intermediates in f32 where PyTorch rounds, and the conv sums differ
    in order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.nn.model import PoseProposalNet as JaxPPN
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.nn.model import PoseProposalNet
from ppn_tpu_torch.nn.resnet import same_pads
from ppn_tpu_torch.utils.params_io import (jax_leaf_paths,
                                           state_dict_from_jax_leaves)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _jax_template(model_cfg, dtype=jnp.float32):
    """(graphdef, flattened (path, ShapeDtypeStruct) list, treedef) of the
    JAX model's {"params", "rest"} tree, without materializing weights."""
    abstract = nnx.eval_shape(
        lambda: JaxPPN(model_cfg, dtype=dtype, rngs=nnx.Rngs(0)))
    graphdef, params, rest = nnx.split(abstract, nnx.Param, ...)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        {"params": params, "rest": rest})
    return graphdef, flat, treedef


def _path_tuple(path):
    """A jax key path as the port's tuple (the trailing `.value` dropped)."""
    keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    return tuple(keys[:-1] if keys[-1] == "value" else keys)


def _numpy_leaves(flat, seed):
    """Seeded weights for every leaf: He-scaled kernels, BN scale/var in
    [0.5, 1.5], biases and means N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path, leaf in flat:
        name = _path_tuple(path)[-1]
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        leaves.append(a.astype(np.float32))
    return leaves


@pytest.mark.parametrize("name", ["tiny_test", "mpii_r18_384",
                                  "mpii_r18_224_fast"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_logits_match_jax(name, compute):
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    cfg = get_config(name)
    graphdef, flat, treedef = _jax_template(jax_get_config(name).model, jdtype)
    leaves = _numpy_leaves(flat, seed=1)
    tree = jax.tree.unflatten(treedef, leaves)

    @jax.jit
    def jax_forward(params, rest, images):
        m = nnx.merge(graphdef, params, rest)
        m.eval()
        return m(images)

    model = PoseProposalNet(cfg.model, dtype=tdtype)
    model.load_state_dict(state_dict_from_jax_leaves(cfg, leaves, model))
    model.eval()

    images = np.random.default_rng(2).integers(
        0, 256, (2, *cfg.model.insize, 3), dtype=np.uint8)
    want = np.asarray(jax_forward(tree["params"], tree["rest"], images))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    tol = F32_TOL if compute == "float32" else BF16_TOL
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50"])
@pytest.mark.parametrize("name", ["mpii_r18_384", "coco_r18_384"])
def test_leaf_order_and_shapes_match_jax(name, backbone):
    """Shapes only: the port's leaf order is the JAX tree's flatten order,
    and every leaf's shape fits the port's parameter it maps to."""
    jcfg = jax_get_config(name)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, backbone=backbone))
    cfg = get_config(name)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=backbone))
    _, flat, _ = _jax_template(jcfg.model)
    with torch.device("meta"):
        model = PoseProposalNet(cfg.model)
    assert jax_leaf_paths(model) == [_path_tuple(p) for p, _ in flat]
    # the loader checks every shape; zero-stride leaves cost no memory
    leaves = [np.broadcast_to(np.float16(0), leaf.shape) for _, leaf in flat]
    sd = state_dict_from_jax_leaves(cfg, leaves, model)
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(sd[k].shape == want[k].shape for k in want)


@pytest.mark.parametrize("size,k,s,want", [
    (384, 7, 2, (2, 3)),    # the stem: 2 before, 3 after
    (192, 3, 2, (0, 1)),    # max-pool and every 3×3/2 conv
    (96, 1, 2, (0, 0)),     # 1×1/2 projection
    (48, 3, 1, (1, 1)),     # stride 1 is symmetric
    (7, 3, 2, (1, 1)),      # odd input
])
def test_same_pads_match_xla(size, k, s, want):
    assert same_pads(size, k, s) == want
