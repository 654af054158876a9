"""Guards of the PyTorch port's boundaries.

- No module under ``src/repro_torch/``, not ``chip_smoke.py`` and not the
  CUDA tests (``tests/test_torch_cuda.py`` and its helper, run where only
  the port is installed) imports ``jax`` or anything of the JAX package
  ``repro`` (checked on the AST, so a lazy import inside a function counts
  too).
- Importing the port loads no JAX.
- Entry points that create tensors default to the card and raise on a
  machine without one unless the caller passes ``device="cpu"``.
"""
import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
    REPO / "tests" / "helpers" / "torch_parity.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_port_module_imports():
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))
    assert "repro_torch.search.engine" in names
    assert "repro_torch.serving.batcher" in names
    for name in names:
        importlib.import_module(name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch, repro_torch.core.pipeline, "
            "repro_torch.search, repro_torch.kernels, repro_torch.convert, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.ckpt, repro_torch.dist, repro_torch.bench.table1_main; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    """Pretend the machine has no card, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(no_gpu):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.invariance import identity_transform
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    from repro_torch.models.ssm import init_ssm_state

    cfg = get_config("opt-tiny").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        identity_transform(cfg.d_ff)
    assert identity_transform(cfg.d_ff, "cpu").pi.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibration_tensor(cfg.vocab_size, 1, 8)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_model(params, cfg, QuantConfig(bits=2, group_size=32))
    # and with device="cpu" they run
    assert quantize_model(params, cfg, QuantConfig(bits=2, group_size=32),
                          device="cpu").method == "rtn"
    assert calibration_tensor(cfg.vocab_size, 1, 8, device="cpu").shape == (1, 8)
    scfg = get_config("mamba2-2.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_ssm_state(scfg, 2)
    assert init_ssm_state(scfg, 2, device="cpu")["state"].device.type == "cpu"


def test_serving_entry_points_default_to_cuda_and_raise_without_a_gpu(no_gpu):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QTensor, QuantConfig
    from repro_torch.launch.serve import BatchedServer, PagedServer
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.serving import PagedKVCache

    cfg = get_config("opt-tiny").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(cfg, n_pages=8, page_size=8, max_pages_per_seq=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params_q = pack_model(params, QuantConfig(bits=2, group_size=32))
    up = params_q["blocks"]["mlp"]["up"]
    assert isinstance(up, QTensor) and up.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServer(params_q, cfg, max_batch=2, max_len=32)
    server = PagedServer(params_q, cfg, max_batch=2, max_len=32,
                         device="cpu")
    assert server.cache.pools["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 16)
    assert init_cache(cfg, 2, 16, device="cpu")["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(params_q, cfg, batch_size=2, max_len=32)
    assert BatchedServer(params_q, cfg, batch_size=2, max_len=32,
                         device="cpu").generate([]) == []


def test_train_and_checkpoint_entry_points_default_to_cuda(no_gpu, tmp_path):
    from repro_torch.bench.common import bench_model
    from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                             restore_checkpoint,
                                             restore_sharded_checkpoint,
                                             save_checkpoint)
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(steps=1, batch=2, seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--steps", "1", "--batch", "2", "--seq", "16"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_model(ckpt_dir=tmp_path / "bench")
    save_checkpoint(tmp_path, 1, {"w": torch.ones(2)})   # saving needs no card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_sharded_checkpoint(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(tmp_path).restore()
    # and with device="cpu" they run
    assert restore_checkpoint(tmp_path, device="cpu")[0]["w"].device.type == "cpu"
    tree, _ = CheckpointManager(tmp_path, device="cpu").restore()
    assert tree["w"].device.type == "cpu"
    _, losses, _ = train(steps=2, batch=2, seq=16, log_every=1000, device="cpu")
    assert len(losses) == 2


def test_quantize_model_refuses_params_on_another_device():
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.model import init_params

    cfg = get_config("opt-tiny").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["lm_head"] = params["lm_head"].to("meta")
    with pytest.raises(ValueError, match="lm_head"):
        quantize_model(params, cfg, QuantConfig(bits=2, group_size=32),
                       device="cpu")
