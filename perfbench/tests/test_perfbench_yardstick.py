"""The frozen yardstick against hand-worked small shapes, and the lower
precisions the control computes in."""
import types

import pytest
import torch

from perfbench.metrics import _yardstick as Y
from perfbench.reference import lowp

TINY = types.SimpleNamespace(
    n_layers=2, d_model=4, n_heads=2, n_kv_heads=1, head_dim=0, d_ff=8,
    gated_mlp=True, use_bias=False, qk_norm=False, norm="rmsnorm",
    pos_emb="rope", tie_embeddings=False, max_seq_len=16, padded_vocab=10,
    resolved_head_dim=2)


def test_matmul_params_and_forward_flops():
    # per layer: wq 4x4 + wo 4x4 + wk, wv 4x2 each + 3 FFN 4x8 = 144; head 40
    assert Y.matmul_params(TINY) == 2 * 144 + 40
    # B 3, S 5: 2 * 328 * 15 + 4 * 2 layers * 3 * 15 pairs * 2 heads * 2 dims
    assert Y.forward_flops(TINY, 3, 5) == 2 * 328 * 15 + 4 * 2 * 3 * 15 * 4


def test_param_count():
    # attention 2*16 + 2*8 = 48, FFN 96, norm 4: 2 * (48 + 96 + 8) + 4 + 40
    # (embedding) + 40 (head)
    assert Y.dense_param_count(TINY) == 2 * 152 + 4 + 40 + 40


def test_bytes_bounds():
    # w (4 x 8 f32) read + written, 4 groups of (scale, zero) per column...
    assert Y.tq_bytes(4, 8, 2, 8) == 2 * 32 * 4 + 2 * 2 * 8 * 4 + 8 * 12 + 32
    assert Y.tq_bytes_per_proposal(TINY, 2, 4) == \
        2 * Y.tq_bytes(4, 8, 2, 8) + Y.tq_bytes(8, 4, 2, 8)
    ms, kind = Y.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and kind == "bytes"
    ms, kind = Y.bound_ms(0, 67e9)
    assert ms == pytest.approx(1.0) and kind == "operations"


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0,
                      float("inf")], dtype=torch.float32)
    got = lowp.tf32_round(x)
    # ties go away from zero; 10 mantissa bits kept
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0,
                            float("inf")]
    y = torch.randn(1000)
    assert ((lowp.tf32_round(y) - y).abs() <= y.abs() * 2**-11).all()


def test_fp8_rounding_and_products():
    x = torch.randn(64, 32)
    w = torch.randn(32, 16)
    exact = lowp.matmul(x, w, "float32")
    err8 = (lowp.matmul(x, w, "fp8") - exact).abs().max()
    err32 = (lowp.matmul(x, w, "tf32") - exact).abs().max()
    assert 0 < err32 < err8
    torch.testing.assert_close(lowp.fp8_round(x, -1).abs().amax(-1),
                               x.abs().amax(-1))
    with pytest.raises(ValueError):
        lowp.matmul(x, w, "int4")


def test_batched_fp8_products_scale_per_row_and_column():
    # a batched product scales each matrix of the batch on its own axes:
    # the same as the 2-D product of each
    x = torch.randn(3, 8, 16)
    w = torch.randn(3, 16, 4) * torch.tensor([1.0, 100.0, 0.01])[:, None,
                                                                   None]
    got = lowp.matmul(x, w, "fp8")
    for i in range(3):
        torch.testing.assert_close(got[i], lowp.matmul(x[i], w[i], "fp8"))


def test_fp8_activations_round_per_token():
    h = torch.randn(2, 5, 32) * torch.logspace(-3, 3, 5)[None, :, None]
    got = lowp.activation(h, "fp8")
    assert torch.equal(got, lowp.fp8_round(h, -1))
    rel = ((got - h).abs() / h.abs().amax(-1, keepdim=True)).max()
    assert 0 < rel <= 2**-4
    for precision in ("float32", "tf32"):
        assert lowp.activation(h, precision) is h
