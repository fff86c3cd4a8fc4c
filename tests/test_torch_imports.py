"""The port's boundary: ``repro_torch`` and ``chip_smoke.py`` import
nothing of JAX and nothing of the JAX package ``repro`` (the machine
with the card has no JAX), the launch table reads none of the JAX
package's tables, and the entry points do not fall back to the CPU when
no card is present."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)(?!_))",
    re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("serve.cognitive_engine", "core.cognitive",
              "kernels.event_voxel", "kernels.demosaic", "kernels.nlm",
              "kernels.isp_fused", "isp.fuse", "kernels.spike_dwconv",
              "kernels.max_pool", "core.backbones", "kernels.tune",
              "kernels.spike_conv_lif", "launch.roofline",
              "kernels.backbone_fuse", "kernels.backbone_segment",
              "models.blocks", "models.attention", "models.transformer",
              "models.lm", "serve.engine", "launch.serve",
              "kernels.flash_attention", "serve.fleet", "serve.faults",
              "serve.supervisor", "serve.scheduler",
              "distributed.fault_tolerance", "data.synthetic",
              "checkpoint.manager", "train.trainer", "train.detector",
              "launch.train", "device", "distributed.sharding",
              "distributed.compress", "distributed.pipeline_parallel",
              "launch.mesh"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith('jax.') or n == 'repro'\n"
        "             or n.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_have_no_jax_or_repro_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_port_reads_no_jax_tuning_table():
    """The port's launch table has its own chain: no source of the port
    names the JAX package's table variable or its packaged table."""
    jax_var = "REPRO_" + "TUNE_TABLE"
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        assert jax_var not in text, f
        assert "repro/kernels/tuned_defaults" not in text, f
        assert '"repro", "kernels"' not in text, f
    from repro_torch.kernels import tune
    assert tune.ENV_VAR == "REPRO_TORCH_TUNE_TABLE"
    assert Path(tune.DEFAULT_TABLE_PATH).parent == PKG / "kernels"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("from jax import numpy", True),
    ("import repro.core", True), ("from repro.core import npu", True),
    ("    from repro import configs", True),
    ("import repro_torch", False), ("from repro_torch.core import npu", False),
    ("import jaxlib_free", False)])
def test_forbidden_import_pattern(line, bad):
    assert bool(_FORBIDDEN.search(line)) == bad


def test_entry_points_default_to_cuda_and_raise_without_it():
    import numpy as np

    from repro_torch.configs.registry import reduced_snn
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.npu import init_npu
    from repro_torch.serve.cognitive_engine import CognitiveEngine
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = reduced_snn("spiking_yolo")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_npu(gen, cfg)
    params = init_npu(gen, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CognitiveEngine(params, cfg, batch=2)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"


def test_data_layer_imports_no_model():
    """The scene generator sits below the model: importing it loads
    neither the NPU nor the training modules."""
    code = ("import sys, repro_torch.data.synthetic\n"
            "print(sorted(n for n in sys.modules if n.startswith(\n"
            "    ('repro_torch.core.npu', 'repro_torch.core.train',\n"
            "     'repro_torch.train'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_training_entry_points_default_to_cuda():
    from repro_torch.configs.registry import TRAIN_CONFIGS
    from repro_torch.data.synthetic import make_scene_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.train.detector import train_detector
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_scene_batch(gen, batch=1, height=32, width=32, time_steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_detector(TRAIN_CONFIGS["detector_smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("name", ["fused", "hdr_fused"])
def test_fused_isp_configs_convert(name):
    """The JAX fused ISP configs map onto "cuda_fused" with the same
    stages; "pallas_fused" has no port for the SNN and encoding
    configs (the JAX package has no such backend for them)."""
    import dataclasses

    from repro.configs import registry as jreg
    from repro_torch import convert
    from repro_torch.configs.registry import ISP_CONFIGS
    cfg = convert.isp_config(jreg.ISP_CONFIGS[name])
    assert cfg.backend == "cuda_fused"
    assert cfg.stages == tuple(jreg.ISP_CONFIGS[name].stages)
    assert cfg == ISP_CONFIGS[name]
    with pytest.raises(ValueError, match="has no port"):
        convert.snn_config(dataclasses.replace(
            jreg.SNN_ARCHS["spiking_yolo"], backend="pallas_fused"))
    with pytest.raises(ValueError, match="has no port"):
        convert.encoding_config(dataclasses.replace(
            jreg.ENCODING_CONFIGS["paper_binary"], backend="pallas_fused"))
