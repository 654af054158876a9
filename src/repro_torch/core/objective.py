"""Search objectives: the paper's loss (Eqn. 23) behind a pluggable protocol.

The paper optimizes ``CE(X, quant(θ)) + α · MSE(H, H₀)``; the search loop
only consumes the scalar pair, so objectives implement the reference's
:class:`Objective` protocol:

- ``prepare(env) → state``      once-per-run precomputation;
- ``evaluate(logits, hidden, state, env) → (primary, aux)`` per candidate;
  the engine combines them as ``loss = primary + α · aux``;
- ``resolve_mix(p0, a0, env) → α`` from the step-0 values;
- ``metrics() → dict``          static labels for the obs registry rows.

Built-ins (see ``OBJECTIVES`` / :func:`get_objective`), the reference's
four:

- ``"ce"``           Eqn. 23, the default;
- ``"kl"``           the Algorithm-1 listing's label-free KL variant;
- ``"swd_actmatch"`` sliced-Wasserstein alignment of tapped activations
  (random-projection 1-D Wasserstein, PAPERS.md: Cao/Yin/Aref 2026);
- ``"saliency_ce"``  per-token CE weighted by the FP model's confidence in
  the true token (PAPERS.md: Cao/Aref 2025).

``swd_actmatch`` draws its projection directions from a ``torch.Generator``
seeded with ``proj_seed`` on the objective's device (the reference draws
them from ``jax.random``, which the port does not re-derive); ``dirs=``
hands it the directions instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.models.model import lm_loss

__all__ = ["calib_ce", "calib_kl", "activation_mse", "resolve_alpha",
           "ObjectiveEnv", "Objective", "CEObjective", "KLObjective",
           "SWDActMatchObjective", "SaliencyCEObjective", "OBJECTIVES",
           "register_objective", "get_objective", "objective_name"]


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

    def metrics(self) -> Dict[str, str]:
        return {"objective": self.name}


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


def _swd_1d(x_sorted, y):
    """1-D Wasserstein-2² between pre-sorted reference projections and a new
    sample set (both (N, P)): sort y, mean squared quantile difference."""
    return torch.mean(torch.square(torch.sort(y, dim=0).values - x_sorted))


class SWDActMatchObjective(Objective):
    """Sliced-Wasserstein activation alignment (PAPERS.md 2601.07878).

    Project the tapped activations of the quantized and FP models onto
    ``n_proj`` fixed random directions, sort each 1-D cloud, and average the
    squared quantile differences — a distributional match that, unlike the
    pointwise MSE, tolerates token-position reshuffling while still pinning
    the activation geometry. With ``n_match == 0`` the logits cloud is
    matched instead (data-free variant). ``aux`` is the calibration CE so
    ``resolve_mix`` can anchor the scale the same way the paper anchors α.

    ``dirs``: optional (d, n_proj) raw directions (normalised here, as the
    reference normalises its draws); None draws them from
    ``torch.Generator(device).manual_seed(proj_seed)``.
    """

    name = "swd_actmatch"

    def __init__(self, n_proj: int = 64, proj_seed: int = 0,
                 ce_anchor: bool = True, dirs=None):
        self.n_proj = int(n_proj)
        self.proj_seed = int(proj_seed)
        self.ce_anchor = bool(ce_anchor)
        self.dirs = dirs

    def _features(self, hidden, env: ObjectiveEnv):
        if env.n_match and hidden is not None:
            h = hidden[:env.n_match].float()
            return h.reshape(env.n_match, -1, h.shape[-1])    # (L, N, D)
        return None

    def prepare(self, env: ObjectiveEnv):
        feats = self._features(env.hidden_fp, env)
        if feats is None:   # data-free fallback: match the logits cloud
            ref = env.logits_fp.float()
            feats = ref.reshape(1, -1, ref.shape[-1])
        d, dev = feats.shape[-1], feats.device
        if self.dirs is None:
            gen = torch.Generator(device=dev).manual_seed(self.proj_seed)
            dirs = torch.randn((d, self.n_proj), generator=gen,
                               dtype=torch.float32, device=dev)
        else:
            dirs = torch.as_tensor(self.dirs, dtype=torch.float32, device=dev)
            if tuple(dirs.shape) != (d, self.n_proj):
                raise ValueError(f"dirs has shape {tuple(dirs.shape)}, "
                                 f"expected {(d, self.n_proj)}")
        dirs = dirs / (torch.linalg.norm(dirs, dim=0, keepdim=True) + 1e-12)
        # (L, N, n_proj) reference projections, pre-sorted along samples
        ref_sorted = torch.sort(feats @ dirs, dim=1).values
        return {"dirs": dirs, "ref_sorted": ref_sorted}

    def evaluate(self, logits, hidden, state, env: ObjectiveEnv):
        feats = self._features(hidden, env)
        if feats is None:
            lg = logits.float()
            feats = lg.reshape(1, -1, lg.shape[-1])
        proj = feats @ state["dirs"]                          # (L, N, n_proj)
        swd = torch.stack([_swd_1d(r, p) for r, p in
                           zip(state["ref_sorted"], proj)]).mean()
        aux = (calib_ce(logits, env.calib, env.vocab_size) if self.ce_anchor
               else logits.new_zeros((), dtype=torch.float32))
        return swd, aux

    def resolve_mix(self, primary0, aux0, env):
        # anchor: the CE term starts 1/ce_weight as important as the SWD
        if not self.ce_anchor or aux0 <= 0:
            return 0.0
        return float(primary0 / (env.ce_weight * aux0))

    def metrics(self):
        return {"objective": self.name, "n_proj": str(self.n_proj)}


class SaliencyCEObjective(Objective):
    """Saliency-weighted CE (PAPERS.md 2504.13932): per-token NLL weighted by
    the FP model's probability of the true token, so tokens the full-precision
    model is confident about dominate the search signal while tokens it
    already gets wrong cannot drag the climb. Weights are normalized to mean
    1 over valid positions (the unweighted CE is the all-ones special case);
    ``aux`` is the paper's activation MSE, mixed exactly like ``"ce"``."""

    name = "saliency_ce"

    def __init__(self, temperature: float = 1.0):
        self.temperature = float(temperature)

    def prepare(self, env: ObjectiveEnv):
        lg = env.logits_fp[:, :-1].float()
        # a same-device divisor: the reference's division on every device
        temp = torch.tensor(self.temperature, dtype=torch.float32,
                            device=lg.device)
        lp = torch.log_softmax(lg / temp, dim=-1)
        labels = env.calib[:, 1:].long()
        p_true = torch.gather(torch.exp(lp), -1, labels[..., None])[..., 0]
        return {"w": p_true / torch.clamp_min(torch.mean(p_true), 1e-9)}

    def evaluate(self, logits, hidden, state, env: ObjectiveEnv):
        lg = logits[:, :-1]
        labels = env.calib[:, 1:].long()
        V = lg.shape[-1]
        if V > env.vocab_size:
            keep = torch.arange(V, device=lg.device) < env.vocab_size
            neg = torch.finfo(torch.float32).min / 2
            lg = torch.where(keep[None, None, :], lg, neg)
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        return torch.mean(nll * state["w"]), _aux_mse(logits, hidden, env)

    def resolve_mix(self, primary0, aux0, env):
        return resolve_alpha(primary0, aux0, env.ce_weight) \
            if env.n_match else 0.0

    def metrics(self):
        return {"objective": self.name,
                "saliency_temperature": str(self.temperature)}


OBJECTIVES: Dict[str, Callable[[], Objective]] = {
    "ce": CEObjective,
    "kl": KLObjective,
    "swd_actmatch": SWDActMatchObjective,
    "saliency_ce": SaliencyCEObjective,
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
