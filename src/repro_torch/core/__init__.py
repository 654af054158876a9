"""Quantization codecs, invariant transforms, objectives, RTN, the search
adapter and the PTQ pipeline (the reference's ``repro.core``, slice 1)."""
