"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test calls ``needs_cuda()`` and skips without a card: the CUDA
kernels have no interpret mode. The kernels run the plain versions' fp32
arithmetic operation for operation, so they are held to them exactly.
This file imports neither JAX nor ``repro``, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import needs_cuda
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref


def _tq_args(f, seed):
    """A random (pi, s, phi) for width f, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    pi = rng.permutation(f)
    s = (1.0 + 0.05 * rng.standard_normal(f)).astype(np.float32)
    phi = (1e-2 * rng.standard_normal(f // 2)).astype(np.float32)
    return (torch.from_numpy(pi.astype(np.int64)), torch.from_numpy(s),
            torch.from_numpy(phi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group", [(2, 32), (3, 128), (8, 64)])
def test_group_quant_cuda_matches_plain(dtype, bits, group):
    dev = needs_cuda()
    w = (torch.randn((512, 384), generator=torch.Generator().manual_seed(1))
         * 2.5).to(dev, dtype)
    before = tk.LAUNCHES["group_quant"]
    fq, s, z = tk.group_quant(w, bits=bits, group=group)
    assert tk.LAUNCHES["group_quant"] == before + 1
    assert fq.dtype == dtype
    for got, want in zip((fq, s, z), tref.group_quant_ref(w, bits, group)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("bits,group", [(2, 32), (4, 16)])
def test_transform_quant_cuda_matches_plain(mode, bits, group):
    dev = needs_cuda()
    D, F = 96, 256
    w = torch.randn((D, F) if mode == "up" else (F, D),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    pi, s, phi = (x.to(dev) for x in _tq_args(F, seed=3))
    before = tk.LAUNCHES["transform_quant"]
    fq, sc, z = tk.transform_quant(w, pi, s, phi, bits=bits, group=group,
                                   mode=mode)
    assert tk.LAUNCHES["transform_quant"] == before + 1
    for got, want in zip((fq, sc, z), tref.transform_quant_ref(
            w, pi, s, phi, bits=bits, group=group, mode=mode)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_wrappers_raise_on_bad_inputs():
    dev = needs_cuda()
    w = torch.randn((64, 32), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk.group_quant(w.t(), bits=2, group=32)
    with pytest.raises(ValueError, match="dtype"):
        tk.group_quant(w.half(), bits=2, group=32)
    with pytest.raises(ValueError, match="multiple"):
        tk.group_quant(w, bits=2, group=24)
    pi = torch.arange(32, device=dev)
    s, phi = torch.ones(32, device=dev), torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="index"):
        tk.transform_quant(w, pi + 1, s, phi, bits=2, group=32, mode="up")
    with pytest.raises(ValueError, match="dtype"):
        tk.transform_quant(w, pi.int(), s, phi, bits=2, group=32, mode="up")
    with pytest.raises(ValueError, match="is on"):
        tk.transform_quant(w, pi.cpu(), s, phi, bits=2, group=32, mode="up")
