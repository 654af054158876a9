"""Quantized model packing for the serving path.

``pack_model`` converts every quantizable weight into a packed ``QTensor``
(32-bit words of codes + group scale/zero). The serving steps dequantize
each layer's QTensor slice as they reach it (``models.model.dequant_tree``),
so serving holds only the packed form in device memory.
"""
from __future__ import annotations

from repro_torch.core.quant import QTensor, QuantConfig, quantize_tensor
from repro_torch.core.rtn import map_quantizable

__all__ = ["pack_model", "packed_bytes", "dense_bytes", "cache_bytes",
           "serving_memory_report"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def pack_model(params, qcfg: QuantConfig, only=None):
    """Replace quantizable weight leaves with QTensors (on the leaves' own
    device).

    Works on fake-quant params (values already on the grid -> packing is
    lossless) or raw params (packing IS the RTN quantization).
    """
    return map_quantizable(params, lambda w, p: quantize_tensor(w, qcfg),
                           only=only)


def packed_bytes(params) -> int:
    return sum(leaf.memory_bytes() if isinstance(leaf, QTensor)
               else leaf.numel() * leaf.element_size()
               for leaf in _leaves(params))


def cache_bytes(cache) -> int:
    """Total bytes of a KV-cache tree (page pools, int8 code + scale layouts
    alike) — the serving memory term that dominates once weights are
    ultra-low-bit."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(cache))


def serving_memory_report(params_q, cache) -> dict:
    """Weight vs KV-cache memory split for a serving configuration."""
    wb, cb = packed_bytes(params_q), cache_bytes(cache)
    return {"weight_bytes": wb, "kv_bytes": cb,
            "kv_fraction": cb / max(wb + cb, 1)}


def dense_bytes(params, dtype_bytes: int = 2) -> int:
    """What the same tree would cost un-quantized at fp16/bf16."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            n = 1
            for d in tuple(leaf.packed.shape[:-2]) + tuple(leaf.shape):
                n *= d
            total += n * dtype_bytes
        else:
            total += leaf.numel() * dtype_bytes
    return total
