"""The port's examples (``repro_torch.examples``) run on the CPU at tiny
arguments, each held to what the reference's example of the same name
prints: the search ends no higher than it started, the served requests
return ``max_new`` tokens each, training lowers the loss, and every
architecture gets the reference's adapter with the reference's unit count.
"""
import math

import pytest

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core.search import make_adapter as jmake_adapter
from repro_torch.examples import (multiarch_smoke, quickstart,
                                  serve_quantized, train_then_quantize)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_quickstart_search_ends_at_or_below_its_start(capsys, monkeypatch):
    """The example takes no size argument (as the reference's); its search
    is cut here from 150 steps to 30, its other settings kept."""
    from repro_torch.core.search import SearchConfig

    monkeypatch.setattr(quickstart, "SearchConfig",
                        lambda **kw: SearchConfig(**{**kw, "steps": 30}))
    res = quickstart.main(["--device", "cpu"])
    assert res.search.history[-1][0] == 30
    assert res.method == "awq+invarexplore"
    assert res.search.final_loss <= res.search.initial_loss
    out = capsys.readouterr().out
    assert "calib CE: fp32=" in out and "search: " in out


def test_serve_quantized_returns_max_new_tokens_a_request(capsys):
    outs = serve_quantized.main(["--requests", "3", "--max-new", "2",
                                 "--batch", "2", "--max-len", "32",
                                 "--page-size", "8", "--device", "cpu"])
    assert len(outs) == 3 and all(len(o) == 2 for o in outs)
    assert "[serve] batcher stats:" in capsys.readouterr().out


def test_train_then_quantize_lowers_the_loss(capsys):
    out = train_then_quantize.main(["--steps", "4", "--search-steps", "1",
                                    "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(math.isfinite(p) for p in out["ppl"].values())
    assert "held-out ppl:" in capsys.readouterr().out


def test_multiarch_smoke_names_the_reference_adapters(capsys):
    rows = multiarch_smoke.main(["--device", "cpu"])
    assert rows
    for arch, loss, name, n_units, shared in rows:
        jcfg = jget_config(arch).reduced()
        want = jmake_adapter(jcfg)
        assert (name, n_units) == (type(want).__name__, want.n_units), arch
        assert shared == (type(jmake_adapter(jcfg, phase="shared")).__name__
                          if jcfg.block_pattern == "hybrid" else None), arch
        assert math.isfinite(loss), arch
    assert capsys.readouterr().out.rstrip().endswith("all architectures OK")


def test_examples_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, serve_quantized, train_then_quantize,
                multiarch_smoke):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])
