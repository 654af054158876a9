"""Faults planted in the program underneath a run, each a way the timed path
of a search cell can go wrong. The CPU tests run tiny cells with each one
and see ``correct`` come out false; ``calibrate.py --fault <name>`` reads
what each gives at a cell's own size, where a limit's upper reading comes
from a fault.

    with plant("head_altered", n_match=10):
        ...   # a run of the cell

``n_match`` is the number of block outputs the objective matches (the
taps); the faults named ``..._past_taps`` and ``head_altered`` sit beyond
them, where only the score over the whole forward can see them.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _swap(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def half_batch(n_match):
    """The objective scores half the calibration batch, the mean taken over
    the rest."""
    from repro_torch.core import objective as obj
    ce, mse = obj.calib_ce, obj.activation_mse

    def half(x, axis):
        return x.narrow(axis, 0, x.shape[axis] // 2)
    stack = contextlib.ExitStack()
    stack.enter_context(_swap(obj, "calib_ce", lambda logits, tokens, v: ce(
        half(logits, 0), half(tokens, 0), v)))
    stack.enter_context(_swap(obj, "activation_mse", lambda hq, hf, n: mse(
        half(hq, 1), half(hf, 1), n)))
    return stack


def state_unchanged(n_match):
    """An accepted move records no transform: the state stays as it was."""
    from repro_torch.search import engine
    return _swap(engine, "tree_install_unit", lambda tree, u, t: tree)


def answer_altered(n_match):
    """Every score the objective returns is 1 % off."""
    from repro_torch.core import objective as obj
    evaluate = obj.CEObjective.evaluate
    return _swap(obj.CEObjective, "evaluate",
                 lambda *a: tuple(x * 1.01 for x in evaluate(*a)))


def install_skipped_past_taps(n_match):
    """An accepted FFN unit at or past the taps is left out of the stack
    that later candidates are scored on (its transform is still
    returned)."""
    from repro_torch.core.search import DenseFFNAdapter
    install = DenseFFNAdapter.install_unit

    def skip(self, fq_stack, u, unit):
        return fq_stack if u >= n_match else install(self, fq_stack, u, unit)
    return _swap(DenseFFNAdapter, "install_unit", skip)


def head_altered(n_match):
    """The final norm and LM head's logits are 1 % off: past every tap."""
    from repro_torch.models import model
    head = model.lm_head_logits
    return _swap(model, "lm_head_logits",
                 lambda *a, **k: head(*a, **k) * 1.01)


FAULTS = {f.__name__: f for f in (half_batch, state_unchanged,
                                  answer_altered, install_skipped_past_taps,
                                  head_altered)}


def plant(name: str, n_match: int):
    """A context in which the fault ``name`` is planted in the program."""
    return FAULTS[name](n_match)
