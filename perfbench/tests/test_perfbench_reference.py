"""The plain reference against the port at tiny sizes on the CPU, in
float32: the forward of each family, the group fake-quant (both range
types), and the (π, s, φ) transforms."""
import dataclasses

import pytest
import torch

from perfbench.drivers.search import model_config
from perfbench.reference import model as M
from perfbench.reference import quant as Q
from perfbench.tiny import tiny_cell
from perfbench.weights import layer, make_weights

CELLS = ("search.opt-1.3b", "search.qwen3-4b")


def _arch(cell):
    return dataclasses.replace(tiny_cell(cell).arch, param_dtype="float32",
                               compute_dtype="float32")


def _fp_layer(params):
    return lambda i: {k: {n: t.float() for n, t in v.items()}
                      for k, v in layer(params, i).items()}


@pytest.mark.parametrize("cell", CELLS)
def test_forward_matches_the_port(cell):
    from repro_torch.models.model import forward
    arch = _arch(cell)
    params = make_weights(arch, 3, torch.device("cpu"), torch.float32)
    tokens = torch.randint(0, arch.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    got, hidden = forward(params, model_config(arch), tokens,
                          collect_hidden=True)
    want, taps = M.forward(params, arch, _fp_layer(params), tokens, n_taps=2)
    V = arch.vocab_size
    torch.testing.assert_close(want[..., :V], got[..., :V], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(taps, hidden[:2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_matches_the_port(dtype):
    from repro_torch.core.quant import QuantConfig, fake_quant
    w = (torch.randn(3, 64, 48, generator=torch.Generator().manual_seed(0))
         * 0.05).to(dtype)
    got = fake_quant(w, QuantConfig(bits=2, group_size=32))
    want = Q.fake_quant(w, 2, 32, dtype)
    assert torch.equal(want.to(dtype), got)


def test_transforms_match_the_port():
    from repro_torch.core import invariance as inv
    g = torch.Generator().manual_seed(4)
    D, F = 8, 16
    up, down, gate = (torch.randn(D, F, generator=g),
                      torch.randn(F, D, generator=g),
                      torch.randn(D, F, generator=g))
    b_up = torch.randn(F, generator=g)
    t = inv.propose(g, inv.identity_transform(F, "cpu"),
                    inv.ProposalConfig(sigma_s=0.3, sigma_r=0.3,
                                       subset_frac=0.5))
    u, d, bu, gt, _ = inv.apply_transform_ffn(t, up, down, b_up, gate)
    torch.testing.assert_close(Q.transform_up(up, *t), u)
    torch.testing.assert_close(Q.transform_down(down, *t), d)
    torch.testing.assert_close(Q.transform_bias(b_up, *t), bu)
    torch.testing.assert_close(gate[:, t.pi], gt)
    assert not Q.is_identity(*t)
    assert Q.is_identity(*inv.identity_transform(F, "cpu"))
