"""The yardstick's frozen copies equal the program's pieces they were
copied from, at commit 6c798b19f2f81ac884339f9f662eb9e6d03a12e7."""

import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference.geometry import Geometry
from perfbench.yardstick import flops, post_bytes, synthetic, trace, weights
from perfbench.tests import tiny


def _cfg(name):
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name,gflop", [("mpii_r18_384", 11.545),
                                        ("mpii_r50_384", 26.946)])
def test_flops_equal_the_programs_counter(name, gflop):
    from ppn_tpu_torch.bench.suite import forward_flops
    from ppn_tpu_torch.configs import get_config

    mine = flops.forward_flops(_cfg(name)["model"])
    assert mine == forward_flops(get_config(name), 1)
    assert round(mine / 1e9, 3) == gflop
    assert flops.train_flops(_cfg(name)["model"]) == 3 * mine


@pytest.mark.parametrize("name,batch", [("tiny_test", 3),
                                        ("mpii_r18_384", 2)])
def test_needed_bytes_equal_the_programs(name, batch):
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.ops.cuda_post import needed_bytes

    m = (tiny.config_file(name) if name == "tiny_test"
         else _cfg(name))["model"]
    g = Geometry(m)
    gen = torch.Generator().manual_seed(4)
    fm = torch.randn((batch, *g.outsize, g.num_channels), generator=gen)
    fm[..., :2 * g.num_classes] += 2.0      # proposals above the threshold
    assert post_bytes.needed_bytes(g, fm) == needed_bytes(
        get_config(name).model, fm)


def test_renders_equal_the_programs_generator():
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.pipeline import collate
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset

    m = _cfg("mpii_r18_384")["model"]
    mine = synthetic.render_set(m, 12, 2**31 + 5, 3, workers=1)
    ds = SyntheticPoseDataset(get_config("mpii_r18_384"), size=3,
                              seed=2**31 + 5)
    theirs = collate([ds[i] for i in range(3)], image_uint8=True)
    for k in synthetic.FIELDS:
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_snapshot_loads_as_the_programs_loader():
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.utils.params_io import load_inference_npz

    cfg = _cfg("mpii_r18_384")
    work = harness.load_json(harness.BENCH / "workloads/r18-infer-b128.json")
    path = str(harness.ROOT / work["weights"]["path"])
    assert weights.sha256(path) == work["weights"]["sha256"]
    mine = weights.load_snapshot(cfg["model"], path, "cpu")
    theirs = load_inference_npz(get_config("mpii_r18_384"), path,
                                device="cpu").state_dict()
    assert set(mine) == set(theirs)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0)


def test_seeded_weights_fit_the_program_and_follow_the_seed():
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.nn.model import PoseProposalNet

    m = _cfg("mpii_r50_384")["model"]
    a, b = (weights.seeded(m, s, "cpu") for s in (2**33, 2**33))
    c = weights.seeded(m, 7, "cpu")
    model = PoseProposalNet(get_config("mpii_r50_384").model)
    model.load_state_dict(a)                  # every name and shape
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.out.weight"], c["head.out.weight"])
    assert float(a["head.out.bias"][0]) == -1.0


def test_categories_extend_the_programs():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tpp", harness.ROOT / "tools/torch_predict_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("void ppn_post_kernel<1024>(...)", "Memcpy HtoD (Pageable)",
                 "cutlass_tensorop_bf16_s16816fprop", "sm90_xmma_gemm",
                 "void at::native::elementwise_kernel<...>",
                 "reduce_kernel<512>", "max_pool_forward_nhwc", "other"):
        assert trace.category(name) == mod._category(name)
    assert trace.category("ppn_warp_kernel<3, true>") == "ppn_warp_kernel"


def test_config_files_hold_what_runs():
    for name in ("mpii_r18_384", "mpii_r50_384"):
        cfg = _cfg(name)
        harness.program_config(cfg)
        json.dumps(cfg)
        assert cfg["reduced"] == []
