"""PyTorch + CUDA port of the InvarExplore system (``repro`` is the JAX
reference it is held against).

Slice 1 carries the paper's Table 1 flow on the dense OPT model: RTN
(``core.pipeline.quantize_model``) followed by the InvarExplore discrete
search (``search.run``), with the two search kernels written by hand for
Hopper (``kernels.group_quant``, ``kernels.transform_quant``, sources in
``csrc/``). The package imports ``torch`` and ``numpy`` only — never ``jax``
and nothing of ``repro``.

Every entry point that creates tensors takes ``device=`` and defaults to
``"cuda"``; on a machine without a GPU it raises unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
