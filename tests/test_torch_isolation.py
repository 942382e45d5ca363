"""The port stands alone: no file of ppn_tpu_torch/ and not chip_smoke.py
imports jax, flax or the JAX package, and the entry points run on CUDA
unless the caller asks for the CPU — without a GPU they raise instead of
falling back.

grain, tensorflow and tensorboard are forbidden too: importing
``grain.python`` leaves ``jax`` in ``sys.modules``, and
``torch.utils.tensorboard`` loads tensorflow, which loads jax; the card's
machine has none of the three. Nor has it ``google.protobuf``, so the
port's TensorBoard writer (utils/tb_events.py) encodes its records by
hand. Nor does any of them import the JAX tools' ``tools/_artifact.py``,
which writes into ``artifacts/`` by default: the port's tools write a file
only when given ``--out``."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ppn_tpu", "grain",
             "tensorflow", "tensorboard", "google.protobuf",
             "tools._artifact")


def _port_files():
    pkg = os.path.join(ROOT, "ppn_tpu_torch")
    tools = os.path.join(ROOT, "tools")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(tools, n) for n in os.listdir(tools)
        if n.startswith("torch_") and n.endswith(".py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f)
           if any(m == x or m.startswith(x + ".") for x in FORBIDDEN)]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.nn.model import PoseProposalNet
    from ppn_tpu_torch.ops.postprocess import forward_postprocess_fast
    from ppn_tpu_torch.utils.params_io import load_inference_npz

    cfg = get_config("tiny_test")
    model = PoseProposalNet(cfg.model)
    images = np.zeros((1, *cfg.model.insize, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_postprocess_fast(cfg.model, model, images)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_inference_npz(
            get_config("mpii_r18_384"),
            os.path.join(ROOT, "artifacts", "mpii_hero_r5_ema_f16.npz"))
    # the training slice's entry points
    import torch as _torch

    from ppn_tpu_torch.apps import train
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.ops.augment import augment_batch
    from ppn_tpu_torch.train.trainer import Trainer

    ds = SyntheticPoseDataset(cfg, size=2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, iter([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCache(ds)
    batch = DeviceCache(ds, device="cpu").batch([0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        augment_batch(cfg.model, cfg.data, _torch.Generator(), batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--config", "tiny_test", "--steps", "1"])
    out = augment_batch(cfg.model, cfg.data, _torch.Generator(), batch,
                        device="cpu")
    assert out["image"].dtype == _torch.bfloat16
    # asked for explicitly, the CPU works
    ppl = Predictor(cfg, model, device="cpu").predict(images)
    assert ppl.kp_cell.shape == (1, cfg.model.max_instances,
                                 cfg.model.num_classes, 2)


def test_serving_slice_defaults_to_cuda_and_raises_without_it(no_cuda):
    from ppn_tpu_torch.apps import predict, serve, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.nn.model import PoseProposalNet

    cfg = get_config("tiny_test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, PoseProposalNet(cfg.model), flip_tta=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_checkpoint(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.main(["--config", "tiny_test", "--synthetic", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--config", "tiny_test", "--selftest", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video.main(["--config", "tiny_test", "--frames", "2"])


def test_evaluation_slice_defaults_to_cuda_and_raises_without_it(no_cuda,
                                                                 capsys):
    from ppn_tpu_torch.apps import evaluate

    argv = ["--config", "tiny_test", "--max-images", "2", "--batch-size", "2"]
    for metric in ("pckh", "oks"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate.main(argv + ["--metric", metric])
    assert capsys.readouterr().out == ""
    # asked for explicitly, the CPU works
    summary = evaluate.main(argv + ["--metric", "oks", "--device", "cpu"])
    assert "oks/AP" in summary


def test_chip_smoke_fails_without_cuda(no_cuda, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_ninth_slice_is_scanned_and_defaults_to_cuda(no_cuda, tmp_path):
    """The data-parallel, export, profiling, debug and weight-import modules
    are among the files scanned for imports; their entry points run on
    CUDA unless asked otherwise."""
    scanned = {os.path.relpath(f, ROOT) for f in _port_files()}
    for name in ("parallel/__init__.py", "parallel/mesh.py",
                 "parallel/multihost.py", "utils/export.py",
                 "utils/profiling.py", "utils/debug.py",
                 "utils/torch_import.py"):
        assert os.path.join("ppn_tpu_torch", name) in scanned
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.nn.model import PoseProposalNet
    from ppn_tpu_torch.parallel import make_mesh
    from ppn_tpu_torch.utils import profiling
    from ppn_tpu_torch.utils.export import export_pipeline

    cfg = get_config("tiny_test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_pipeline(cfg, PoseProposalNet(cfg.model), batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path)):
            pass
    assert make_mesh(device="cpu").device == torch.device("cpu")


def test_file_input_slice_is_scanned_and_defaults_to_cuda(no_cuda, tmp_path,
                                                          capsys):
    """The file loaders are among the files scanned for imports; the train
    and evaluate CLIs on a file tree and the video CLI on a directory of
    JPEGs run on CUDA unless asked otherwise."""
    scanned = {os.path.relpath(f, ROOT) for f in _port_files()}
    for name in ("data/imageio.py", "data/mpii.py", "data/coco.py"):
        assert os.path.join("ppn_tpu_torch", name) in scanned
    from ppn_tpu_torch.apps import evaluate, train, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.testing import write_mpii_set

    cfg = get_config("tiny_test")
    src = SyntheticPoseDataset(cfg, size=2, seed=0, cache=True)
    root = str(tmp_path / "mpii")
    write_mpii_set(cfg, root, {"train": (src, 2, 0), "valid": (src, 2, 0)},
                   ext="jpg")
    data = ["--config", "tiny_test", "--data", "mpii", "--data-root", root]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(data + ["--steps", "1", "--batch-size", "2",
                           "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video.main(["--config", "tiny_test", "--frames", "2", "--source",
                    os.path.join(root, "images")])
    assert capsys.readouterr().out == ""


def test_native_and_k_step_slice_is_scanned_and_defaults_to_cuda(
        no_cuda, tmp_path, capsys):
    """The native pool's package is among the files scanned for imports;
    its wrapper imports PIL only as the bare package, to find
    ``pillow.libs``, never a PIL decoder. The K-step trainer (the library
    and the CLI) and the video CLI on a directory of JPEGs (the native
    pool) run on CUDA unless asked otherwise."""
    scanned = {os.path.relpath(f, ROOT) for f in _port_files()}
    for name in ("native/__init__.py", "native/loader.py"):
        assert os.path.join("ppn_tpu_torch", name) in scanned
    path = os.path.join(ROOT, "ppn_tpu_torch", "native", "loader.py")
    pil = [m for m in _imported_modules(path) if m.split(".")[0] == "PIL"]
    assert pil == ["PIL"]
    with open(path) as fh:
        tree = ast.parse(fh.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and getattr(n.value, "id", None) == "PIL"
                and n.attr != "__file__"]

    import dataclasses

    from ppn_tpu_torch.apps import train, video
    from ppn_tpu_torch.configs import get_config
    from ppn_tpu_torch.data.device_cache import DeviceCache
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.testing import write_mpii_set
    from ppn_tpu_torch.train.trainer import Trainer

    cfg = get_config("tiny_test")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_call=2, batch_size=2))
    cache = DeviceCache(SyntheticPoseDataset(cfg, size=2, seed=0),
                        device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, iter([]), device_cache=cache)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--config", "tiny_test", "--overfit", "2", "--steps",
                    "2", "--steps-per-call", "2", "--ckpt-dir",
                    str(tmp_path / "ck")])
    src = SyntheticPoseDataset(cfg, size=2, seed=0, cache=True)
    root = str(tmp_path / "mpii")
    write_mpii_set(cfg, root, {"train": (src, 2, 0)}, ext="jpg")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video.main(["--config", "tiny_test", "--frames", "2", "--source",
                    os.path.join(root, "images")])
    assert capsys.readouterr().out == ""


def test_bench_is_scanned_and_defaults_to_cuda(no_cuda, capsys):
    """The benchmark suite and headline are among the files scanned for
    imports, and they run on CUDA unless asked otherwise."""
    scanned = {os.path.relpath(f, ROOT) for f in _port_files()}
    for name in ("bench/__init__.py", "bench/suite.py", "bench/headline.py"):
        assert os.path.join("ppn_tpu_torch", name) in scanned
    from ppn_tpu_torch.bench import headline, suite

    with pytest.raises(RuntimeError, match="device='cpu'"):
        suite._flagship()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        headline.run_bench()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        suite.main(["--configs", "7"])
    assert '"value"' not in capsys.readouterr().out
