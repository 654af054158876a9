"""Hand-written Hopper kernels of the port and their plain versions.

- ``group_quant``: group fake-quant round trip (the TPU kernel
  ``repro/kernels/group_quant.py``); backs ``core.quant.fake_quant``.
- ``transform_quant``: fused (π, s, φ) transform + group fake-quant (the
  TPU kernel ``repro/kernels/transform_quant.py``); the search's fused
  candidate build.

CUDA C++ sources live in ``repro_torch/csrc/`` and are built with nvcc for
``sm_90a`` on first use (``build.py``); ``ops.py`` holds the wrappers and
their launch counts, ``ref.py`` the plain PyTorch versions.
"""
from repro_torch.kernels.ops import (LAUNCHES, group_quant,
                                     reset_launch_counts, transform_quant)

__all__ = ["group_quant", "transform_quant", "LAUNCHES",
           "reset_launch_counts"]
