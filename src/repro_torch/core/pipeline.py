"""End-to-end PTQ pipeline: base method → (optional) InvarExplore search.

    params_q = quantize_model(params_fp, cfg, qcfg, method="awq",
                              calib_tokens=X, search=SearchConfig(...)).params_q

Contract between stages (as in the reference):
  * the base method produces FFN weights in the continuous (dequantized)
    domain — AWQ-scaled/clipped, GPTQ-compensated, OmniQuant-optimized, or
    plain θ₀ for RTN — and FINAL fake-quant weights for everything else
    (attention projections), which stay frozen during the search;
  * InvarExplore then hill-climbs fq(T(θ_base)) per unit (Algorithm 1);
  * without the search, the FFN weights are simply fake-quantized.

The base method and the freezing run under the span ``quantize.base``.

Every leaf of the result has the dtype ``params_fp`` gives it. Where a
base method returns a leaf in a wider dtype (AWQ on a bf16 model returns
f32 weights, as the reference's does: jnp promotes them by its f32 scales
and clip ratios), the fake-quant is computed in that dtype, with the
reference's values, and rounded once to the model's dtype; the search
casts its stack and candidates so (``search.engine``). The reference keeps
those leaves f32, and its forward then runs partly in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.awq import awq_process_dense
from repro_torch.core.gptq import gptq_process_dense
from repro_torch.core.omniquant import omniquant_process_dense
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.core.rtn import get_by_path, map_quantizable
from repro_torch.core.search import SearchConfig
from repro_torch.device import check_on_device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.search.api import run as run_invar_search

__all__ = ["quantize_model", "PTQResult"]

# leaves the search transforms (kept continuous until the search quantizes
# them): dense / MoE FFNs plus the Mamba projections (within-head
# permutation targets), as in the reference
_FFN_KEYS = ("up", "gate", "down", "w_z", "w_x", "out_proj")


def _is_ffn(path):
    return path[-1] in _FFN_KEYS


@dataclasses.dataclass
class PTQResult:
    params_q: dict
    method: str
    search: Optional[object]  # SearchResult when InvarExplore ran
    # what the base method reports: AWQ's per-layer grid choices
    # ({"choices": [...]}), OmniQuant's block losses ({"losses": (L, steps)})
    base: Optional[dict] = None


def _like(tree, like):
    """``tree`` with every tensor leaf in the dtype of ``like``'s leaf at the
    same path (the same tensor where they agree)."""
    if isinstance(tree, dict):
        return {k: _like(v, like[k]) for k, v in tree.items()}
    return tree.to(like.dtype) if isinstance(tree, torch.Tensor) else tree


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
    forward_kwargs: Optional[dict] = None,
    omniquant_steps: int = 200,
    device="cuda",
) -> PTQResult:
    """Quantize ``params_fp`` (which must already live on ``device``).

    ``method``: "rtn", "awq", "gptq" or "omniquant". ``calib_tokens``
    (numpy or tensor, (B, S)) is needed by every method but RTN, and by the
    search. ``forward_kwargs`` (``enc_embeds`` / ``vision_embeds`` tensors
    on ``device``) go to the search's forwards only, as in the reference:
    the base methods calibrate on text. ``omniquant_steps``: Adam steps per
    block for ``omniquant`` (the reference's 200; read by no other
    method).

    On an encoder-decoder stack the search transforms the decoder's FFNs
    only, so the encoder's FFN leaves come back at full precision from a
    search run, while RTN alone fake-quantizes them (the reference's
    semantics)."""
    dev = resolve_device(device)
    check_on_device(params_fp, dev)
    if method != "rtn" and calib_tokens is None:
        raise ValueError(f"method {method!r} needs calib_tokens")
    if search is not None and calib_tokens is None:
        raise ValueError("the InvarExplore search needs calib_tokens")
    tokens = None if calib_tokens is None else _as_tokens(calib_tokens, dev)
    if forward_kwargs:
        check_on_device(forward_kwargs, dev, "forward_kwargs")

    with obs.trace_span("quantize.base"):
        # 1) base-method processing (continuous-domain FFN weights)
        base = None
        if method == "rtn":
            params_base = params_fp
        elif method == "awq":
            params_base, choices = awq_process_dense(params_fp, cfg, tokens,
                                                     qcfg)
            base = {"choices": choices}
        elif method == "gptq":
            params_base = gptq_process_dense(params_fp, cfg, tokens, qcfg)
        elif method == "omniquant":
            params_base, losses = omniquant_process_dense(
                params_fp, cfg, tokens, qcfg, steps=omniquant_steps)
            base = {"losses": losses}
        else:
            raise ValueError(f"unknown method {method!r}")

        # 2) freeze non-FFN quantizable weights at their fake-quant values, each
        #    in the dtype params_fp gives it (module docstring)
        params_base = map_quantizable(
            params_base,
            lambda w, p: fake_quant(w, qcfg).to(get_by_path(params_fp, p).dtype),
            only=lambda p: not _is_ffn(p))

    # 3) InvarExplore search or plain FFN fake-quant
    if search is not None:
        result = run_invar_search(params_fp, params_base, cfg, qcfg, tokens,
                                  search, forward_kwargs=forward_kwargs)
        return PTQResult(result.params_q, method + "+invarexplore", result,
                         base)

    params_q = map_quantizable(
        params_base, lambda w, p: fake_quant(w, qcfg), only=_is_ffn)
    return PTQResult(_like(params_q, params_fp), method, None, base)
