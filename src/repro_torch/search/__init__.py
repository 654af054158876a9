"""Discrete search: the front door (``api.run``), the engine's sequential
lane (``engine.py``) and the annealing schedules (``anneal.py``, a verbatim
copy of the reference's pure-Python module)."""
from repro_torch.search.anneal import accept, temperature_schedule
from repro_torch.search.api import run

__all__ = ["run", "temperature_schedule", "accept"]
