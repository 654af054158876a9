"""A run's inputs come from its seed: the same seed gives the same weights
and calibration batch, another seed other ones, and each part of a run its
own stream."""
import dataclasses

import torch

from perfbench.drivers.search import calibration_batch
from perfbench.generate import derive_seed
from perfbench.tiny import tiny_cell
from perfbench.weights import make_weights


def test_derived_seeds_are_stable_and_apart():
    seed = 2**31 + 12345
    assert derive_seed(seed, 2) == derive_seed(seed, 2)
    parts = {derive_seed(seed, 2), derive_seed(seed, 3),
             derive_seed(seed, 10, 0), derive_seed(seed, 10, 1),
             derive_seed(seed + 1, 2)}
    assert len(parts) == 5
    assert all(0 <= s < 2**62 for s in parts)


def test_same_seed_same_weights_and_batch():
    cell = tiny_cell("search.opt-1.3b")
    arch = dataclasses.replace(cell.arch, param_dtype="float32")
    cpu = torch.device("cpu")

    def inputs(seed):
        return (make_weights(arch, seed, cpu, torch.float32),
                calibration_batch(arch, cell.traffic, seed, cpu))

    (wa, ca), (wb, cb), (wc, cc) = inputs(7), inputs(7), inputs(8)
    assert torch.equal(ca, cb) and not torch.equal(ca, cc)
    for k in ("wq", "wo"):
        a, b, c = (w["blocks"]["attn"][k] for w in (wa, wb, wc))
        assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(wa["lm_head"], wb["lm_head"])
