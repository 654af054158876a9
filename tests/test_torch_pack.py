"""Port parity: packed storage (``repro_torch.core.quant`` packing,
``QTensor``, ``quantized.qmodel``, the packed-tree converter) vs the JAX
reference.

Packed words are held bit for bit (the port stores the reference's uint32
words as int32), scales and zero points exactly, and dequantized weights
exactly: both sides run the same fp32 operations per group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import to_np
from repro.configs import get_config as jget_config
from repro.core import quant as jq
from repro.models import init_params as jinit_params
from repro.models.model import dequant_tree as jdequant_tree
from repro.quantized import qmodel as jqm
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.models.model import dequant_tree as tdequant_tree
from repro_torch.models.model import layer_slice
from repro_torch.quantized import qmodel as tqm

BITS = list(range(1, 9))


def _words(packed):
    """Reference uint32 words or port int32 words -> int32 numpy."""
    a = np.asarray(packed) if not isinstance(packed, torch.Tensor) \
        else packed.numpy()
    return a.view(np.int32)


def _assert_qtensor_equal(t, j):
    np.testing.assert_array_equal(_words(t.packed), _words(j.packed))
    np.testing.assert_array_equal(to_np(t.scale), np.asarray(j.scale))
    np.testing.assert_array_equal(to_np(t.zero), np.asarray(j.zero))
    assert (t.bits, t.group_size, tuple(t.shape)) == \
        (j.bits, j.group_size, tuple(j.shape))


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_codes_bit_exact(bits):
    vpw = tq.vals_per_word(bits)
    assert vpw == jq.vals_per_word(bits)
    codes = np.random.default_rng(bits).integers(
        0, 1 << bits, size=(vpw * 7, 13)).astype(np.int32)
    got = tq.pack_codes(torch.from_numpy(codes), bits)
    want = jq.pack_codes(jnp.asarray(codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words(got), _words(want))
    back = tq.unpack_codes(got, bits, codes.shape[0] - 3)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jq.unpack_codes(want, bits, codes.shape[0] - 3)))
    np.testing.assert_array_equal(back.numpy(), codes[:-3])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(64, 24), (3, 64, 24), (96,)],
                         ids=["2d", "stacked", "vector"])
def test_quantize_tensor_matches_reference(bits, shape):
    """K=64 with groups of 32 needs the lcm(G, vpw) padding for 3, 5, 6 and
    7 bits (vpw 10, 6, 5, 4 ... lcm 160, 96, 160, 32)."""
    w = (np.random.default_rng(100 + bits).standard_normal(shape)
         * 1.7).astype(np.float32)
    qcfg_t, qcfg_j = tq.QuantConfig(bits, 32), jq.QuantConfig(bits, 32)
    t = tq.quantize_tensor(torch.from_numpy(w), qcfg_t)
    j = jq.quantize_tensor(jnp.asarray(w), qcfg_j)
    _assert_qtensor_equal(t, j)
    deq = t.dequantize()
    assert tuple(deq.shape) == shape
    np.testing.assert_array_equal(deq.numpy(), np.asarray(j.dequantize()))
    if len(shape) == 3:     # one layer of a stacked leaf is that layer's QTensor
        np.testing.assert_array_equal(t[1].dequantize().numpy(),
                                      deq[1].numpy())


def test_bits_per_param_matches_reference():
    for bits in BITS:
        for g in (32, 128, -1):
            assert tq.bits_per_param(tq.QuantConfig(bits, g)) == \
                jq.bits_per_param(jq.QuantConfig(bits, g))


@pytest.fixture(scope="module")
def packed_pair():
    cfg = jget_config("opt-tiny").reduced(n_layers=2, d_model=64, d_ff=128,
                                          vocab_size=256, n_heads=4,
                                          n_kv_heads=2)
    jparams = jinit_params(jax.random.PRNGKey(0), cfg)
    jpq = jqm.pack_model(jparams, jq.QuantConfig(bits=2, group_size=32))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jpq, tparams


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_pack_model_and_byte_reports_match_reference(packed_pair):
    cfg, jpq, tparams = packed_pair
    tpq = tqm.pack_model(tparams, tq.QuantConfig(bits=2, group_size=32))
    jflat = _flat(jax.tree.map(lambda x: x, jpq,
                               is_leaf=lambda x: isinstance(x, jq.QTensor)))
    tflat = _flat(tpq)
    assert sorted(tflat) == sorted(jflat)
    n_packed = 0
    for path, j in jflat.items():
        t = tflat[path]
        if isinstance(j, jq.QTensor):
            assert isinstance(t, tq.QTensor), path
            _assert_qtensor_equal(t, j)
            n_packed += 1
        else:
            np.testing.assert_array_equal(to_np(t), np.asarray(j))
    assert n_packed == 6            # wq wk wv wo up down
    assert tqm.packed_bytes(tpq) == jqm.packed_bytes(jpq)
    assert tqm.dense_bytes(tpq) == jqm.dense_bytes(jpq)
    assert tqm.dense_bytes(tpq, 4) == jqm.dense_bytes(jpq, 4)
    assert tpq["blocks"]["mlp"]["up"].packed.device.type == "cpu"


def test_packed_tree_converter_and_dequant_tree(packed_pair):
    """A reference packed tree carried across gives QTensor leaves whose
    per-layer ``dequant_tree`` equals the reference's."""
    cfg, jpq, _ = packed_pair
    tpq = params_from_numpy(jax.tree.map(np.asarray, jpq), "cpu")
    up = tpq["blocks"]["mlp"]["up"]
    assert isinstance(up, tq.QTensor) and up.packed.dtype == torch.int32
    for i in range(cfg.n_layers):
        jl = jdequant_tree(jax.tree.map(lambda x: x[i], jpq["blocks"]))
        tl = tdequant_tree(layer_slice(tpq["blocks"], i))
        for path, j in _flat(jl).items():
            np.testing.assert_array_equal(to_np(_flat(tl)[path]),
                                          np.asarray(j), err_msg=str(path))
