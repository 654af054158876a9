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
    for name in names:
        importlib.import_module(name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch, repro_torch.core.pipeline, "
            "repro_torch.search, repro_torch.kernels, repro_torch.convert; "
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
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    cfg = get_config("opt-tiny").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
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
