"""Packed-model helpers for serving (the reference's ``repro.quantized``)."""
from repro_torch.quantized.qmodel import (cache_bytes, dense_bytes, pack_model,
                                          packed_bytes, serving_memory_report)

__all__ = ["pack_model", "packed_bytes", "dense_bytes", "cache_bytes",
           "serving_memory_report"]
