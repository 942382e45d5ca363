"""The rest of the model family against the JAX package on the CPU: the
ResNet-34 and ResNet-50 backbones (``--backbone resnet34|resnet50``,
``mpii_r50_384``), one ResNet-50 ``Bottleneck`` in training mode, and the
train CLI on a ResNet-50. The 224² config (``mpii_r18_224_fast``) is held
where its pieces are: its logits in tests/test_torch_model.py, its plain
post-process in tests/test_torch_postprocess.py and tests/test_torch_tta.py,
its warp in tests/test_torch_warp.py and the video path's 720p → 224²
resize in tests/test_torch_tta.py.

The same weights, made with numpy from a seed as tests/test_torch_model.py
makes them, go into both packages: into the JAX model by ``nnx.merge`` and
into the port through ``utils/params_io.state_dict_from_jax_leaves``.

Tolerances:
  * eval-mode logits at full channel widths on a 128² input (4×4 grid):
    tests/test_torch_model.py's ``F32_TOL`` (2e-5) and ``BF16_TOL`` (3e-2)
    of the largest logit;
  * the Bottleneck in f32 training mode: the output, the input's gradient
    and each parameter's gradient within 2e-5 of their own largest value
    (one block sums at most 1152 products a conv, far fewer than the
    trunk's ~20 layers that F32_TOL covers; the BatchNorm backward, which
    subtracts batch means of the upstream gradient, measured ~1e-6); each
    updated running statistic within 1e-5 of its largest value (sums over
    128 values per channel in another order; measured ~1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from ppn_tpu.configs import get_config as jax_get_config
from ppn_tpu.nn.resnet import Bottleneck as JaxBottleneck
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.nn.model import PoseProposalNet
from ppn_tpu_torch.nn.resnet import Bottleneck
from ppn_tpu_torch.utils.params_io import (_leaf_specs,
                                           state_dict_from_jax_leaves)

from test_torch_model import (BF16_TOL, F32_TOL, _jax_template,
                              _numpy_leaves, _path_tuple)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCK_TOL = 2e-5
STATS_TOL = 1e-5


def _family_configs(backbone, insize=(128, 128)):
    """mpii_r18_384 of both packages with ``backbone`` at ``insize``."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("mpii_r18_384")
        out.append(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=backbone, insize=insize,
            outsize=(insize[0] // 32, insize[1] // 32))))
    return out


@pytest.mark.parametrize("backbone", ["resnet34", "resnet50"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_family_logits_match_jax(backbone, compute):
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    jcfg, cfg = _family_configs(backbone)
    graphdef, flat, treedef = _jax_template(jcfg.model, jdtype)
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
    assert got.shape == want.shape == (2, 4, 4, cfg.model.num_channels)
    scale = np.abs(want).max()
    tol = F32_TOL if compute == "float32" else BF16_TOL
    err = np.abs(got - want).max()
    print(f"{backbone} {compute}: max |Δ| {err:.3g} = {err / scale:.3g} of "
          f"the largest logit {scale:.4g}")
    assert err <= tol * scale, (err, scale)


def test_bottleneck_training_matches_flax():
    """The stride-2 projection Bottleneck at its real widths (cin 256,
    cout 128, expansion 4: layer3's first block of ResNet-50), f32, in
    training mode, on a (2, 8, 8, 256) input: the output, the gradients
    of every parameter and of the input under a seeded linear loss, and
    the running statistics each BatchNorm updates."""
    rng = np.random.default_rng(7)
    jblock = JaxBottleneck(256, 128, 2, dtype=jnp.float32,
                           rngs=nnx.Rngs(0))
    graphdef, params, rest = nnx.split(jblock, nnx.Param, ...)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        {"params": params, "rest": rest})
    leaves = _numpy_leaves(flat, seed=3)
    tree = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves])
    x = rng.normal(0.0, 1.0, (2, 8, 8, 256)).astype(np.float32)
    r = rng.normal(0.0, 1.0, (2, 4, 4, 512)).astype(np.float32)

    def loss_fn(p, rest, x):
        m = nnx.merge(graphdef, p, rest)
        y = m(x)
        return jnp.sum(y * r), (y, nnx.split(m, nnx.Param, ...)[2])

    # the statistics are traced too (their gradient is not used): Flax
    # updates them in place, which it allows only at the trace they live in
    (_, (want_y, want_rest)), (want_gp, _, want_gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True)(
        tree["params"], tree["rest"], jnp.asarray(x))

    block = Bottleneck(256, 128, 2, dtype=torch.float32).train()
    specs = _leaf_specs(block)
    assert [s[0] for s in specs] == [_path_tuple(p) for p, _ in flat]
    block.load_state_dict(state_dict_from_jax_leaves(None, leaves, block))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = block(tx)
    (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()

    want_y = np.asarray(want_y)
    got_y = y.detach().permute(0, 2, 3, 1).numpy()
    assert np.abs(got_y - want_y).max() <= BLOCK_TOL * np.abs(want_y).max()
    gx = tx.grad.permute(0, 2, 3, 1).numpy()
    want_gx = np.asarray(want_gx)
    assert np.abs(gx - want_gx).max() <= BLOCK_TOL * np.abs(want_gx).max()

    want_leaves = jax.tree.leaves({"params": want_gp, "rest": want_rest})
    named = dict(block.named_parameters())
    buffers = dict(block.named_buffers())
    checked = 0
    for (path, name, is_kernel), want in zip(specs, want_leaves):
        want = np.asarray(want)
        if is_kernel:
            want = want.transpose(3, 2, 0, 1)
        if path[0] == "params":
            got, tol = named[name].grad.numpy(), BLOCK_TOL
        else:
            got, tol = buffers[name].numpy(), STATS_TOL
        err = np.abs(got - want).max()
        print(f"{name}: max |Δ| {err:.3g} = {err / np.abs(want).max():.3g} "
              "of the largest value")
        assert err <= tol * np.abs(want).max(), (name, err)
        checked += 1
    # four ConvBN units: a kernel and four BatchNorm leaves each
    assert checked == len(want_leaves) == 20


def test_train_cli_resnet50_writes_a_checkpoint(tmp_path, capsys):
    from ppn_tpu_torch.apps import train

    train.main(["--device", "cpu", "--config", "tiny_test", "--backbone",
                "resnet50", "--steps", "2", "--overfit", "2",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final:" in out
    assert (tmp_path / "ckpt_00000002.pt").exists()
    payload = torch.load(tmp_path / "ckpt_00000002.pt", weights_only=True)
    # the bottleneck trunk's last 1×1 expands to 2048 channels
    assert payload["model"]["backbone.blocks.15.conv3.conv.weight"].shape == (
        2048, 512, 1, 1)
