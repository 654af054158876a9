"""Command-line entry points of the port (the reference's ``repro.launch``):
``train``, ``serve``, ``search`` and ``dist_smoke``, with ``mesh`` shapes."""
