"""Discrete search: the front door (``api.run``), the engine's sequential
lane (``engine.py``), islands and migration (``islands.py``), the tabu
memory (``tabu.py``), candidate install (``install.py``) and the annealing
schedules (``anneal.py``). ``anneal.py`` and ``tabu.py`` are copies of the
reference's host-only modules."""
from repro_torch.search.anneal import accept, temperature_schedule
from repro_torch.search.api import run

__all__ = ["run", "temperature_schedule", "accept"]
