"""Search objectives: the paper's loss (Eqn. 23) behind a pluggable protocol.

The paper optimizes ``CE(X, quant(θ)) + α · MSE(H, H₀)``; the search loop
only consumes the scalar pair, so objectives implement the reference's
:class:`Objective` protocol:

- ``prepare(env) → state``      once-per-run precomputation;
- ``evaluate(logits, hidden, state, env) → (primary, aux)`` per candidate;
  the engine combines them as ``loss = primary + α · aux``;
- ``resolve_mix(p0, a0, env) → α`` from the step-0 values.

Built-ins: ``"ce"`` (Eqn. 23, the default) and ``"kl"`` (the Algorithm-1
listing's label-free variant). ``swd_actmatch`` and ``saliency_ce`` wait
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.models.model import lm_loss

__all__ = ["calib_ce", "calib_kl", "activation_mse", "resolve_alpha",
           "ObjectiveEnv", "Objective", "CEObjective", "KLObjective",
           "OBJECTIVES", "register_objective", "get_objective",
           "objective_name"]


def calib_ce(logits, tokens, vocab_size: int):
    """Next-token cross-entropy on the calibration batch."""
    return lm_loss(logits[:, :-1], tokens[:, 1:], vocab_size)


def calib_kl(logits_q, logits_fp, vocab_size: int):
    """KL(p_fp || p_q) averaged over positions."""
    V = logits_q.shape[-1]
    if V > vocab_size:
        keep = torch.arange(V, device=logits_q.device) < vocab_size
        neg = torch.finfo(torch.float32).min / 2
        logits_q = torch.where(keep, logits_q, neg)
        logits_fp = torch.where(keep, logits_fp, neg)
    lq = torch.log_softmax(logits_q.float(), dim=-1)
    lp = torch.log_softmax(logits_fp.float(), dim=-1)
    p = torch.exp(lp)
    return torch.mean(torch.sum(p * (lp - lq), dim=-1))


def activation_mse(hidden_q, hidden_fp, n_match: int):
    """MSE over the first ``n_match`` per-layer block outputs.

    hidden_*: (L, B, S, D) stacks from forward(collect_hidden=True).
    n_match == 0 disables activation matching (paper Table 4, '0 layers').
    """
    if n_match == 0:
        return hidden_q.new_zeros((), dtype=torch.float32)
    hq = hidden_q[:n_match].float()
    hf = hidden_fp[:n_match].float()
    return torch.mean(torch.square(hq - hf))


def resolve_alpha(ce0: float, mse0: float, ce_weight: float = 10.0) -> float:
    """Paper §4.1: α chosen so CE is ``ce_weight``× more important than the
    activation MSE at the start of the search."""
    if mse0 <= 0:
        return 0.0
    return float(ce0 / (ce_weight * mse0))


@dataclasses.dataclass(frozen=True)
class ObjectiveEnv:
    """Everything an objective may read, fixed for one engine run: the
    calibration batch, the FP reference forward on it, and the paper's
    matching hyper-parameters."""

    calib: Any                    # (B, S) int tokens
    logits_fp: Any                # (B, S, V) FP reference logits
    hidden_fp: Any                # (n_match, B, S, D) FP taps, or None
    vocab_size: int
    n_match: int
    ce_weight: float = 10.0


class Objective:
    """Base protocol; subclasses override the hooks below."""

    name = "objective"

    def prepare(self, env: ObjectiveEnv) -> Any:
        return None

    def evaluate(self, logits, hidden, state, env: ObjectiveEnv):
        raise NotImplementedError

    def resolve_mix(self, primary0: float, aux0: float,
                    env: ObjectiveEnv) -> float:
        return 0.0


def _aux_mse(logits, hidden, env: ObjectiveEnv):
    if env.n_match:
        return activation_mse(hidden, env.hidden_fp, env.n_match)
    return logits.new_zeros((), dtype=torch.float32)


class CEObjective(Objective):
    """Eqn. 23: calibration CE + α · activation MSE — the paper default."""

    name = "ce"

    def evaluate(self, logits, hidden, state, env: ObjectiveEnv):
        return calib_ce(logits, env.calib, env.vocab_size), \
            _aux_mse(logits, hidden, env)

    def resolve_mix(self, primary0, aux0, env):
        return resolve_alpha(primary0, aux0, env.ce_weight) \
            if env.n_match else 0.0


class KLObjective(CEObjective):
    """Algorithm-1 listing: KL(p_fp || p_q) + α · activation MSE."""

    name = "kl"

    def evaluate(self, logits, hidden, state, env: ObjectiveEnv):
        return calib_kl(logits, env.logits_fp, env.vocab_size), \
            _aux_mse(logits, hidden, env)


OBJECTIVES: Dict[str, Callable[[], Objective]] = {
    "ce": CEObjective,
    "kl": KLObjective,
}


def register_objective(name: str, factory: Callable[[], Objective],
                       overwrite: bool = False) -> None:
    """Register a custom objective factory under ``name``."""
    if name in OBJECTIVES and not overwrite:
        raise ValueError(f"objective {name!r} already registered")
    OBJECTIVES[name] = factory


def get_objective(spec: Union[str, Objective, None]) -> Objective:
    """Resolve ``SearchConfig.objective``: a registry name, an ``Objective``
    instance (returned as-is), or None (the default CE objective)."""
    if spec is None:
        return CEObjective()
    if isinstance(spec, Objective):
        return spec
    if isinstance(spec, str):
        try:
            return OBJECTIVES[spec]()
        except KeyError:
            raise ValueError(
                f"unknown objective {spec!r}; registered: "
                f"{sorted(OBJECTIVES)}") from None
    raise TypeError(
        f"objective must be a name or an Objective, got {type(spec).__name__}")


def objective_name(spec: Union[str, Objective, None]) -> str:
    """The stats label for an objective spec."""
    if spec is None:
        return "ce"
    if isinstance(spec, Objective):
        return spec.name
    return str(spec)
