"""The port's torchvision weight import (ppn_tpu_torch/utils/torch_import.py,
``--pretrained``) against the JAX package's (ppn_tpu/utils/torch_import.py):
the six cases of tests/test_torch_import.py on the same synthesized
torchvision state dicts (no torchvision needed, nothing downloaded), and the
port's backbone forward against the JAX backbone's on one converted dict
each of ResNet-18 and ResNet-50, within the bf16 logit tolerance of
tests/test_torch_model.py (3e-2 of the largest output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from ppn_tpu.nn.resnet import resnet18 as jax_resnet18
from ppn_tpu.nn.resnet import resnet50 as jax_resnet50
from ppn_tpu.utils.torch_import import load_torch_resnet as jax_load
from ppn_tpu_torch.configs import get_config
from ppn_tpu_torch.nn.resnet import resnet18, resnet50
from ppn_tpu_torch.train import steps as st
from ppn_tpu_torch.utils.torch_import import (load_torch_resnet,
                                              torchvision_state_dict)

from test_torch_import import (_fake_torchvision_resnet18_sd,
                               _fake_torchvision_resnet50_sd)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16_TOL = 3e-2


def _torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def test_conversion_consumes_everything():
    sd = _fake_torchvision_resnet18_sd(np.random.default_rng(0))
    bb = resnet18()
    used = load_torch_resnet(bb, _torch_sd(sd))
    assert used == 5 + 8 * 10 + 3 * 5
    # both sides are OIHW: no transpose
    np.testing.assert_array_equal(bb.stem.conv.weight.detach().numpy(),
                                  sd["conv1.weight"])
    np.testing.assert_array_equal(
        bb.blocks[2].proj.conv.weight.detach().numpy(),
        sd["layer2.0.downsample.0.weight"])
    np.testing.assert_array_equal(bb.blocks[7].conv2.bn.running_var.numpy(),
                                  sd["layer4.1.bn2.running_var"])
    # the inverse gives back every consumed tensor
    back = torchvision_state_dict(bb)
    assert len(back) == used
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_conversion_changes_forward():
    sd = _fake_torchvision_resnet18_sd(np.random.default_rng(1))
    bb = resnet18().eval()
    x = torch.ones((1, 3, 64, 64))
    with torch.no_grad():
        before = bb(x).float()
        load_torch_resnet(bb, _torch_sd(sd))
        after = bb(x).float()
    assert not torch.allclose(before, after)


def test_pretrained_cli_path_end_to_end(tmp_path):
    """--pretrained PATH: the train state starts from the imported backbone
    weights, and the train CLI takes the flag."""
    from ppn_tpu_torch.apps import train as train_app

    sd = _fake_torchvision_resnet18_sd(np.random.default_rng(2))
    pth = tmp_path / "resnet18.pth"
    torch.save(_torch_sd(sd), pth)
    state = st.create_train_state(get_config("tiny_test"), device="cpu",
                                  pretrained=str(pth))
    bb = state.model.backbone
    np.testing.assert_array_equal(bb.stem.conv.weight.detach().numpy(),
                                  sd["conv1.weight"])
    np.testing.assert_array_equal(bb.blocks[5].conv1.bn.running_mean.numpy(),
                                  sd["layer3.1.bn1.running_mean"])
    train_app.main([
        "--config", "tiny_test", "--overfit", "2", "--steps", "2",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--no-resume",
        "--pretrained", str(pth), "--device", "cpu",
    ])
    assert (tmp_path / "ckpt" / "ckpt_00000002.pt").exists()


def test_strict_mismatch_raises():
    sd = _torch_sd(_fake_torchvision_resnet18_sd(np.random.default_rng(0)))
    extra = dict(sd, **{"layer9.0.extra.weight": torch.zeros(1, 1, 1, 1)})
    with pytest.raises(ValueError, match="consumed"):
        load_torch_resnet(resnet18(), extra)
    missing = {k: v for k, v in sd.items() if k != "layer3.0.bn2.bias"}
    with pytest.raises(ValueError, match="lacks layer3.0.bn2.bias"):
        load_torch_resnet(resnet18(), missing)
    shapes = dict(sd, **{"conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(ValueError, match="conv1.weight"):
        load_torch_resnet(resnet18(), shapes)


def test_resnet50_bottleneck_conversion():
    sd = _fake_torchvision_resnet50_sd(np.random.default_rng(2))
    bb = resnet50()
    used = load_torch_resnet(bb, _torch_sd(sd))
    assert used == 5 + 16 * 15 + 4 * 5
    np.testing.assert_array_equal(bb.blocks[0].conv3.bn.running_var.numpy(),
                                  sd["layer1.0.bn3.running_var"])
    np.testing.assert_array_equal(
        bb.blocks[13].proj.conv.weight.detach().numpy(),
        sd["layer4.0.downsample.0.weight"])


def test_bottleneck_sd_into_basic_backbone_raises():
    sd = _fake_torchvision_resnet50_sd(np.random.default_rng(3))
    with pytest.raises(ValueError, match="bottleneck"):
        load_torch_resnet(resnet18(), _torch_sd(sd))


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_backbone_forward_matches_jax_on_the_converted_dict(backbone):
    fake, jax_make, make = {
        "resnet18": (_fake_torchvision_resnet18_sd, jax_resnet18, resnet18),
        "resnet50": (_fake_torchvision_resnet50_sd, jax_resnet50, resnet50),
    }[backbone]
    sd = fake(np.random.default_rng(4))
    jbb = jax_make(rngs=nnx.Rngs(0))
    jax_load(jbb, sd)
    jbb.eval()
    graphdef, jstate = nnx.split(jbb)
    bb = make().eval()
    load_torch_resnet(bb, _torch_sd(sd))
    x = np.random.default_rng(5).random((2, 64, 64, 3), np.float32)
    want = np.asarray(jax.jit(lambda s, x: nnx.merge(graphdef, s)(x))(
        jstate, x).astype(jnp.float32))
    with torch.no_grad():
        got = bb(torch.from_numpy(x).permute(0, 3, 1, 2)).float()
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
