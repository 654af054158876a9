"""Port parity: the kernels' plain PyTorch versions vs the JAX kernels.

On the CPU the port's wrappers (``repro_torch.kernels``) run the plain
versions; the JAX wrappers run the Pallas kernels in interpret mode, as the
reference's own tests do. Same numpy inputs; scale/zero ``rtol=1e-5``, fake-
quant weights within one quantization step (``tests/test_kernels.py`` bar).

The CUDA kernels themselves are held to these plain versions in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_within_one_step, to_np
from repro import kernels as jk
from repro.kernels import ref as jref
from repro_torch import kernels as tk
from repro_torch.core import quant as tq
from repro_torch.kernels import ref as tref

SHAPES_GQ = [(128, 128), (256, 256), (512, 128), (384, 256)]
GQ_CASES = [(bits, group, K, N)
            for bits, group in [(2, 32), (2, 128), (4, 64), (8, 64)]
            for K, N in SHAPES_GQ if K % group == 0]
TQ_CASES = [(mode, bits, group, D, F)
            for mode in ("up", "down") for bits in (2, 3, 4)
            for group in (16, 32) for D, F in [(64, 128), (128, 64), (96, 96)]]


def _transform(f, seed):
    rng = np.random.default_rng(seed)
    pi = rng.permutation(f)
    s = (1.0 + 0.05 * rng.standard_normal(f)).astype(np.float32)
    phi = (1e-2 * rng.standard_normal(f // 2)).astype(np.float32)
    return pi, s, phi


def _tq_args(pi, s, phi):
    return (torch.from_numpy(pi.astype(np.int64)), torch.from_numpy(s),
            torch.from_numpy(phi))


def _jq_args(pi, s, phi):
    return jnp.asarray(pi.astype(np.int32)), jnp.asarray(s), jnp.asarray(phi)


@pytest.mark.parametrize("bits,group,K,N", GQ_CASES)
def test_group_quant_plain_matches_jax(bits, group, K, N):
    rng = np.random.default_rng(K + N + bits)
    w = (rng.standard_normal((K, N)) * 2.5).astype(np.float32)
    fq, s, z = tk.group_quant(torch.from_numpy(w), bits=bits, group=group)
    jfq, js, jz = jk.group_quant(jnp.asarray(w), bits=bits, group=group)
    np.testing.assert_allclose(to_np(s), to_np(js), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(to_np(z), to_np(jz), rtol=1e-5, atol=1e-8)
    assert_within_one_step(fq, jfq, js, group)
    _, rs, rz = jref.group_quant_ref(jnp.asarray(w), bits, group)
    np.testing.assert_array_equal(to_np(s), to_np(rs))
    np.testing.assert_array_equal(to_np(z), to_np(rz))


def test_group_quant_plain_bf16_matches_jax():
    """bf16 input, fp32 arithmetic. The JAX kernel's scale ((max - min) /
    q_max) comes out of XLA as a multiply by 1/q_max, 1 ulp off its own
    oracle's division here, which flips one zero-point tie (7.5): scale is
    held to the kernel at rtol 1e-5, scale and zero exactly to the JAX
    oracle (whose correctly rounded division the port follows), fq within
    one step of the kernel."""
    rng = np.random.default_rng(0)
    w32 = (rng.standard_normal((128, 128)) * 2).astype(np.float32)
    w = torch.from_numpy(w32).to(torch.bfloat16)
    fq, s, z = tk.group_quant(w, bits=4, group=64)
    jfq, js, jz = jk.group_quant(jnp.asarray(w32).astype(jnp.bfloat16),
                                 bits=4, group=64)
    assert fq.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(s), to_np(js), rtol=1e-5, atol=1e-8)
    _, rs, rz = jref.group_quant_ref(jnp.asarray(w32).astype(jnp.bfloat16),
                                     4, 64)
    np.testing.assert_array_equal(to_np(s), to_np(rs))
    np.testing.assert_array_equal(to_np(z), to_np(rz))
    assert_within_one_step(fq, jfq, js, 64)


@pytest.mark.parametrize("mode,bits,group,D,F", TQ_CASES)
def test_transform_quant_plain_matches_jax(mode, bits, group, D, F):
    rng = np.random.default_rng(D + F + bits)
    shape = (D, F) if mode == "up" else (F, D)
    w = rng.standard_normal(shape).astype(np.float32)
    pi, s, phi = _transform(F, seed=bits + group)
    fq, sc, z = tk.transform_quant(torch.from_numpy(w), *_tq_args(pi, s, phi),
                                   bits=bits, group=group, mode=mode)
    jfq, jsc, jz = jk.transform_quant(jnp.asarray(w), *_jq_args(pi, s, phi),
                                      bits=bits, group=group, mode=mode)
    np.testing.assert_allclose(to_np(sc), to_np(jsc), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(to_np(z), to_np(jz), rtol=1e-5, atol=1e-8)
    assert_within_one_step(fq, jfq, jsc, group)


@pytest.mark.parametrize("mode", ["up", "down"])
def test_transform_quant_identity_is_plain_fake_quant(mode):
    """Identity (pi, s, phi) reduces to the group fake-quant round trip."""
    D, F, group = 64, 128, 32
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.standard_normal(
        (D, F) if mode == "up" else (F, D)).astype(np.float32))
    pi = torch.arange(F)
    fq, _, _ = tk.transform_quant(w, pi, torch.ones(F), torch.zeros(F // 2),
                                  bits=2, group=group, mode=mode)
    want = tq.fake_quant(w, tq.QuantConfig(bits=2, group_size=group))
    np.testing.assert_array_equal(to_np(fq), to_np(want))


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    tk.reset_launch_counts()
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    for got, want in zip(tk.group_quant(w, bits=2, group=32),
                         tref.group_quant_ref(w, 2, 32)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    pi, s, phi = _tq_args(*_transform(32, seed=1))
    for got, want in zip(
            tk.transform_quant(w, pi, s, phi, bits=2, group=32, mode="up"),
            tref.transform_quant_ref(w, pi, s, phi, bits=2, group=32,
                                     mode="up")):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tk.LAUNCHES == {"group_quant": 0, "transform_quant": 0}


def test_wrappers_refuse_other_devices():
    """Neither CPU nor CUDA: raise, never fall back to the plain version."""
    w = torch.empty((64, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.group_quant(w, bits=2, group=32)
    pi = torch.empty(32, dtype=torch.int64, device="meta")
    s = torch.empty(32, device="meta")
    phi = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.transform_quant(w, pi, s, phi, bits=2, group=32, mode="up")
    with pytest.raises(ValueError, match="mode"):
        tk.transform_quant(w, pi, s, phi, bits=2, group=32, mode="sideways")
