"""Command-line entry points of the port (the reference's ``repro.launch``):
``train``, ``serve`` and ``search``."""
