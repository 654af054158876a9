"""End-to-end PTQ pipeline: base method → (optional) InvarExplore search.

    params_q = quantize_model(params_fp, cfg, qcfg, method="rtn",
                              calib_tokens=X, search=SearchConfig(...)).params_q

Contract between stages (as in the reference):
  * the base method produces FFN weights in the continuous domain — plain
    θ₀ for RTN — and FINAL fake-quant weights for everything else
    (attention projections), which stay frozen during the search;
  * InvarExplore then hill-climbs fq(T(θ_base)) per unit (Algorithm 1);
  * without the search, the FFN weights are simply fake-quantized.

Only ``method="rtn"`` is ported; AWQ, GPTQ and OmniQuant wait (ROADMAP
Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.core.rtn import map_quantizable
from repro_torch.core.search import SearchConfig
from repro_torch.device import check_on_device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.search.api import run as run_invar_search

__all__ = ["quantize_model", "PTQResult"]

# the dense FFN leaves the search transforms (kept continuous until the
# search quantizes them)
_FFN_KEYS = ("up", "gate", "down")


def _is_ffn(path):
    return path[-1] in _FFN_KEYS


@dataclasses.dataclass
class PTQResult:
    params_q: dict
    method: str
    search: Optional[object]  # SearchResult when InvarExplore ran


def _as_tokens(tokens, dev: torch.device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(dev, torch.int64)
    return torch.from_numpy(np.asarray(tokens).astype(np.int64)).to(dev)


def quantize_model(
    params_fp: dict,
    cfg: ModelConfig,
    qcfg: QuantConfig,
    method: str = "rtn",
    calib_tokens=None,
    search: Optional[SearchConfig] = None,
    *,
    device="cuda",
) -> PTQResult:
    """Quantize ``params_fp`` (which must already live on ``device``).
    ``calib_tokens`` (numpy or tensor, (B, S)) is needed by the search."""
    dev = resolve_device(device)
    check_on_device(params_fp, dev)
    if method in ("awq", "gptq", "omniquant"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP Queue 1 item 8)")
    if method != "rtn":
        raise ValueError(f"unknown method {method!r}")
    if search is not None and calib_tokens is None:
        raise ValueError("the InvarExplore search needs calib_tokens")

    # 1) base method: RTN keeps the continuous weights
    params_base = params_fp

    # 2) freeze non-FFN quantizable weights at their fake-quant values
    params_base = map_quantizable(
        params_base, lambda w, p: fake_quant(w, qcfg), only=lambda p: not _is_ffn(p))

    # 3) InvarExplore search or plain FFN fake-quant
    if search is not None:
        result = run_invar_search(params_fp, params_base, cfg, qcfg,
                                  _as_tokens(calib_tokens, dev), search)
        return PTQResult(result.params_q, method + "+invarexplore", result)

    params_q = map_quantizable(
        params_base, lambda w, p: fake_quant(w, qcfg), only=_is_ffn)
    return PTQResult(params_q, method, None)
