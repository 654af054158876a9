"""One driver per kind of traffic, found by the name a mix gives in ``driver``."""
