"""Port parity: ``quant_matmul`` (x @ dequant(packed W)) and its plain
version vs the JAX reference.

The same numpy weights are packed by the reference's ``quantize_tensor``
and carried across (uint32 words viewed as int32). On a CPU tensor
``kernels.quant_matmul`` runs its plain version; it is held to the
reference's ``quant_matmul`` (its Pallas kernel in interpret mode where the
shape tiles, its oracle elsewhere) and to ``quant_matmul_ref`` at
rtol = atol = 5e-4, the bar of ``tests/test_kernels.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tkernels
from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.quant import quantize_tensor as jquantize_tensor
from repro.kernels import quant_matmul as jquant_matmul
from repro.kernels.ref import dequant_ref as jdequant_ref
from repro.kernels.ref import quant_matmul_ref as jquant_matmul_ref
from repro_torch.core.quant import QuantConfig, quantize_tensor
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(rtol=5e-4, atol=5e-4)
SHAPES_MM = [(8, 128, 128), (16, 256, 256), (32, 512, 128), (8, 128, 384)]


def _case(M, K, N, bits, group, seed):
    """numpy x, w; the reference's packed QTensor; the port's tensors."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qt = jquantize_tensor(jnp.asarray(w), JQuantConfig(bits=bits,
                                                       group_size=group))
    port = (torch.from_numpy(np.asarray(qt.packed).view(np.int32).copy()),
            torch.from_numpy(np.asarray(qt.scale).copy()),
            torch.from_numpy(np.asarray(qt.zero).copy()))
    return x, w, qt, port


@pytest.mark.parametrize("bits,group", [(2, 64), (2, 128), (4, 64), (8, 32),
                                        (3, 32)])
@pytest.mark.parametrize("M,K,N", SHAPES_MM)
def test_quant_matmul_sweep_matches_reference(bits, group, M, K, N):
    if K % group:
        pytest.skip("group must divide K (as the reference sweep)")
    x, _, qt, port = _case(M, K, N, bits, group, seed=M * K + N + bits)
    got = to_np(tkernels.quant_matmul(torch.from_numpy(x), *port, bits=bits,
                                      group=group))
    jx = jnp.asarray(x)
    np.testing.assert_allclose(got, np.asarray(jquant_matmul(
        jx, qt.packed, qt.scale, qt.zero, bits=bits, group=group)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jquant_matmul_ref(
        jx, qt.packed, qt.scale, qt.zero, bits, group)), **TOL)


@pytest.mark.parametrize("bits", range(1, 9))
def test_quant_matmul_every_width_with_padding(bits):
    """Bits 1-8 at K = 96, M = 7, N = 100: 3- and 6-bit words pad K to a
    multiple of lcm(group, 32 // bits); M and N off the reference kernel's
    tiling (its wrapper falls back to the oracle there)."""
    M, K, N, group = 7, 96, 100, 32
    x, _, qt, port = _case(M, K, N, bits, group, seed=bits)
    k_pad = port[0].shape[0] * (32 // bits)
    assert k_pad % math.lcm(group, 32 // bits) == 0
    assert (k_pad > K) == (bits in (3, 6))
    got = to_np(tkernels.quant_matmul(torch.from_numpy(x), *port, bits=bits,
                                      group=group))
    jx = jnp.asarray(x)
    for want in (jquant_matmul(jx, qt.packed, qt.scale, qt.zero, bits=bits,
                               group=group),
                 jquant_matmul_ref(jx, qt.packed, qt.scale, qt.zero, bits,
                                   group)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the plain dequant is the reference's, value for value
    np.testing.assert_array_equal(
        to_np(tref.dequant_ref(*port, bits, group, K)),
        np.asarray(jdequant_ref(qt.packed, qt.scale, qt.zero, bits, group,
                                K)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_dtypes(dtype):
    """x in f32 and bf16 (widened to f32 in both packages), output f32."""
    bits, group, M, K, N = 2, 64, 8, 128, 128
    x, _, qt, port = _case(M, K, N, bits, group, seed=0)
    tx = torch.from_numpy(x).to(dtype)
    got = tkernels.quant_matmul(tx, *port, bits=bits, group=group)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    jx = jnp.asarray(to_np(tx)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(jquant_matmul(
        jx, qt.packed, qt.scale, qt.zero, bits=bits, group=group)), **TOL)


def test_port_packing_feeds_the_same_product():
    """The port's own ``quantize_tensor`` words give the reference's
    product (packing is bit-exact, so the plain versions agree)."""
    bits, group, M, K, N = 3, 32, 8, 96, 128
    x, w, qt, _ = _case(M, K, N, bits, group, seed=9)
    tq = quantize_tensor(torch.from_numpy(w), QuantConfig(bits=bits,
                                                          group_size=group))
    np.testing.assert_array_equal(to_np(tq.packed),
                                  np.asarray(qt.packed).view(np.int32))
    got = tkernels.quant_matmul(torch.from_numpy(x), tq.packed, tq.scale,
                                tq.zero, bits=bits, group=group)
    np.testing.assert_allclose(to_np(got), np.asarray(jquant_matmul_ref(
        jnp.asarray(x), qt.packed, qt.scale, qt.zero, bits, group)), **TOL)
