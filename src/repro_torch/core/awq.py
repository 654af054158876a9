"""AWQ baseline (Lin et al. 2024b): activation-aware scaling + clipping, a
transcription of the reference's.

Scaling — the paper's framing: AWQ's per-channel scaling is the SPECIAL CASE
of InvarExplore's S transform on the FFN hidden axis, with s chosen by a grid
search over ``s = act_mag^α`` (α ∈ [0, 1], 20 points) minimizing the quantized
block-output MSE. (Exact invariance for ReLU; AWQ applies it regardless.)

Clipping — per-group max/min shrink grid-searched to minimize per-matrix
output MSE (AWQ's second component; also used by OmniQuant).

Every candidate's ``fake_quant`` is ``core.quant.fake_quant``: the
``group_quant`` kernel on a CUDA tensor. The candidates run one after
another and only the best so far is kept (the reference stacks all of them
and takes ``argmin``); a strict ``<`` keeps the first of equal losses, as
``argmin`` does. The grids hold the reference's float32 values bit for bit
(:func:`f32_linspace`).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.quant import QuantConfig, _grouped, fake_quant
from repro_torch.core.taps import capture_dense_taps
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

__all__ = ["f32_linspace", "GridChoice", "awq_alpha_search", "awq_scale_ffn",
           "clip_grid_search", "clip_search", "awq_process_dense",
           "ALPHA_GRID", "CLIP_GRID", "CLIP_WEIGHTS"]

ALPHA_GRID = 20                 # α points in [0, 1]
CLIP_GRID = 10                  # clip ratios in [0.5, 1]
# the weights clip_search runs on, per layer (gate where the model has one)
CLIP_WEIGHTS = ("up", "gate", "down", "wq", "wk", "wv", "wo")


def f32_linspace(start: float, stop: float, num: int) -> List[float]:
    """``jnp.linspace(start, stop, num)``'s float32 values, bit for bit.

    JAX writes ``t = i / (num − 1)`` and ``start · (1 − t) + stop · t``. On
    the CPU, XLA compiles the division as a multiply by r = fl(1 / (num −
    1)) and the sum as one fused multiply-add, ``fma(i, fl(stop · r),
    fl(start · fl(1 − fl(i · r))))``, and the last point is ``stop``. (The
    product of two float32 values is exact in float64, so the float64 sum
    below rounds once more than a true FMA; the tests hold both grids to the
    reference.) ``torch.linspace``, and numpy's float64 grid rounded to
    float32, differ from it in some elements."""
    f32, f64 = np.float32, np.float64
    if num == 1:
        return [float(f32(start))]
    i = np.arange(num - 1, dtype=f32)
    r = f32(1) / f32(num - 1)
    head = f32(start) * (f32(1) - i * r)
    pts = (i.astype(f64) * f64(f32(stop) * r) + head.astype(f64)).astype(f32)
    return [float(p) for p in pts] + [float(f32(stop))]


@dataclasses.dataclass
class GridChoice:
    """One grid search: the index of the chosen point, its value, and every
    candidate's loss (Python floats, in grid order)."""

    index: int
    value: float
    losses: List[float]


def _mm(a, b):
    """a @ b in the wider of the two dtypes (jnp's promotion: the reference
    multiplies bf16 activations by f32 scaled weights in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _ffn(act, wu, wd, bu, wg, x):
    up = _mm(x, wu)
    if bu is not None:
        up = up + bu
    h = act(x @ wg) * up if wg is not None else act(up)
    return _mm(h, wd)


def _mse(y, y_fp):
    return torch.mean(torch.square(y - y_fp))


def awq_alpha_search(w_up, w_down, b_up, w_gate, x_mlp, qcfg: QuantConfig,
                     cfg: ModelConfig, n_grid: int = ALPHA_GRID):
    """The α grid search of one FFN: x_mlp (n, D) inputs of the up
    projection -> (s (F,) of the chosen α, :class:`GridChoice`)."""
    act = L.activation_fn(cfg.activation)
    y_fp = _ffn(act, w_up, w_down, b_up, w_gate, x_mlp)
    # activation magnitude per hidden channel (input of down projection)
    up = x_mlp @ w_up + (b_up if b_up is not None else 0.0)
    mid = act(x_mlp @ w_gate) * up if w_gate is not None else act(up)
    act_mag = torch.mean(torch.abs(mid), dim=0) + 1e-8          # (F,)
    alphas = f32_linspace(0.0, 1.0, n_grid)
    wg, best, best_s, losses = None, None, None, []
    for i, alpha in enumerate(alphas):
        # α is an f32 array in the reference's grid map, so s is f32 in a
        # bf16 model too
        s = torch.pow(act_mag.float(), alpha)
        s = s / torch.sqrt(torch.amax(s) * torch.amin(s) + 1e-12)
        s = torch.clamp(s, 1e-4, 1e4)
        wu = fake_quant(w_up * s[None, :], qcfg)
        wd = fake_quant(w_down / s[:, None], qcfg)
        bu = b_up * s if b_up is not None else None
        if w_gate is not None:      # the reference re-quantizes it per α
            wg = fake_quant(w_gate, qcfg)
        loss = float(_mse(_ffn(act, wu, wd, bu, wg, x_mlp), y_fp))
        losses.append(loss)
        if best is None or loss < losses[best]:
            best, best_s = i, s
    return best_s, GridChoice(best, alphas[best], losses)


def awq_scale_ffn(w_up, w_down, b_up, w_gate, x_mlp, qcfg: QuantConfig,
                  cfg: ModelConfig, n_grid: int = ALPHA_GRID):
    """Grid-search the hidden-axis scaling vector for one FFN.

    x_mlp: (n, D) inputs of the up projection. Returns scaled
    (w_up, w_down, b_up, w_gate) and the chosen s (F,), as the reference.
    """
    s, _ = awq_alpha_search(w_up, w_down, b_up, w_gate, x_mlp, qcfg, cfg,
                            n_grid)
    out_b = b_up * s if b_up is not None else None
    return w_up * s[None, :], w_down / s[:, None], out_b, w_gate, s


def clip_grid_search(w, x, qcfg: QuantConfig, n_grid: int = CLIP_GRID):
    """Per-group clip-ratio grid search minimizing ||x@w − x@fq(clip(w))||²
    -> (the clipped, still continuous-domain weights, :class:`GridChoice`).
    The ratios are f32 arrays in the reference's grid map, so the clipped
    candidates (and the result) are f32 whatever w's dtype."""
    y_fp = _mm(x, w)
    wg = _grouped(w, qcfg.resolve_group(w.shape[0])).float()
    wmax = torch.amax(wg, dim=1, keepdim=True)
    wmin = torch.amin(wg, dim=1, keepdim=True)
    ratios = f32_linspace(0.5, 1.0, n_grid)
    best, best_w, losses = None, None, []
    for i, r in enumerate(ratios):
        wc = torch.clamp(wg, wmin * r, wmax * r).reshape(w.shape)
        loss = float(_mse(_mm(x, fake_quant(wc, qcfg)), y_fp))
        losses.append(loss)
        if best is None or loss < losses[best]:
            best, best_w = i, wc
    return best_w, GridChoice(best, ratios[best], losses)


def clip_search(w, x, bits: int, group_size: int, n_grid: int = CLIP_GRID):
    """Per-group clip-ratio grid search (the reference's signature). Returns
    the clipped (still continuous-domain) weights."""
    return clip_grid_search(w, x, QuantConfig(bits=bits, group_size=group_size),
                            n_grid)[0]


def awq_process_dense(params, cfg: ModelConfig, calib_tokens,
                      qcfg: QuantConfig, do_clip: bool = True):
    """AWQ over a dense decoder: hidden-axis scaling per FFN + weight clipping
    on every quantizable linear.

    Returns (continuous-domain processed params, choices): ``choices[i]`` is
    layer i's {"alpha": GridChoice, "clip": {weight: GridChoice}} (the
    reference returns the params only; the choices are what a card run is
    compared on).

    The searches run in the reference's dtypes, and the result has them:
    in a bf16 model the scaled up / down (and b_up) and every clipped
    weight come back f32, as jnp promotes them by the f32 scales and
    ratios (``core.pipeline`` rounds them to the model's dtype after the
    fake-quant).
    """
    taps = capture_dense_taps(params, cfg, calib_tokens)

    def flat(name, i):       # (B, S, ·) -> (B·S, ·)
        t = taps[name][i]
        return t.reshape(-1, t.shape[-1])

    blocks = dict(params["blocks"])
    # f32 copies of what the searches write (see above); the rest as it is
    f32 = ("up", "down", "b_up") + (CLIP_WEIGHTS if do_clip else ())
    dtypes = {k: v.dtype for k, v in {**blocks["mlp"],
                                      **blocks["attn"]}.items()}
    mlp = {k: v.to(torch.float32, copy=True) if k in f32 else v
           for k, v in blocks["mlp"].items()}
    attn = {k: v.to(torch.float32, copy=True) if k in f32 else v
            for k, v in blocks["attn"].items()}
    inputs = {"up": "mlp_in", "gate": "mlp_in", "down": "mlp_mid",
              "wq": "attn_in", "wk": "attn_in", "wv": "attn_in",
              "wo": "attn_mid"}
    choices = []
    for i in range(cfg.n_layers):
        x_mlp = flat("mlp_in", i)
        # layer i's leaves are still the originals here: the α search reads
        # them in their own dtype, as the reference's does
        orig = {k: mlp[k][i].to(dtypes[k])
                for k in ("up", "down", "b_up", "gate") if k in mlp}
        s, alpha = awq_alpha_search(orig["up"], orig["down"], orig.get("b_up"),
                                    orig.get("gate"), x_mlp, qcfg, cfg)
        mlp["up"][i] = mlp["up"][i] * s[None, :]
        mlp["down"][i] = mlp["down"][i] / s[:, None]
        if "b_up" in mlp:
            mlp["b_up"][i] = mlp["b_up"][i] * s
        clips = {}
        if do_clip:
            for key in CLIP_WEIGHTS:
                tree = mlp if key in mlp else attn
                if key not in tree:
                    continue
                tree[key][i], clips[key] = clip_grid_search(
                    tree[key][i], flat(inputs[key], i), qcfg)
        choices.append({"alpha": alpha, "clip": clips})
    blocks["mlp"], blocks["attn"] = mlp, attn
    out = dict(params)
    out["blocks"] = blocks
    return out, choices
