"""Quantization codecs, invariant transforms, objectives, the PTQ base
methods (RTN, GPTQ, AWQ, OmniQuant) and their calibration taps, the search
adapter and the PTQ pipeline (the reference's ``repro.core``)."""
