"""The reference's examples on the port's API (``examples/*.py`` of the
JAX package), each runnable as ``python -m repro_torch.examples.<name>``
and on the card unless ``--device cpu`` is passed:

- ``quickstart``: a tiny OPT through AWQ + 150 InvarExplore steps;
- ``serve_quantized``: a 2-bit packed model served through ``PagedServer``;
- ``train_then_quantize``: train opt-tiny, then RTN against RTN + search;
- ``multiarch_smoke``: a forward and the search adapter of every
  architecture's reduced config.

Weights are drawn by the port's ``init_params`` (a ``torch.Generator``), so
the numbers differ from the reference's; the steps and the lines printed
are the reference's.
"""
