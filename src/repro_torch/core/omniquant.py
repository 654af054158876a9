"""OmniQuant-lite baseline (Shao et al. 2024): learnable weight clipping (LWC)
+ learnable equivalent scaling (LET), trained with a straight-through
estimator on block-wise output MSE — a transcription of the reference's.

Per FFN block, the learnables are:
  gamma/beta: per-group sigmoid-parameterized shrink of (max, min) for up/down
  log_s:      hidden-axis equivalent scaling (the gradient-based counterpart
              of the paper's discrete S search)
optimized with Adam for ``steps`` iterations. Plain PyTorch with autograd,
as the reference is plain ``jnp`` with ``jax.grad``: the STE is
``q + (clip(round(q)) − q).detach()``, and ``amax``/``amin`` share the
gradient among tied elements as JAX's reduce-max does. Layers run one after
another; the reference vmaps them.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantConfig, _grouped
from repro_torch.core.taps import capture_dense_taps
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

__all__ = ["fake_quant_lwc", "block_problem", "omni_step",
           "omniquant_process_dense"]


def fake_quant_lwc(w, qcfg: QuantConfig, gamma, beta):
    """Fake-quant with learnable clipping; differentiable via STE.

    gamma/beta: (K//G, N) logits; sigmoid(·) shrinks max/min.
    """
    g = qcfg.resolve_group(w.shape[0])
    wg = _grouped(w.float(), g)
    wmax = torch.amax(wg, dim=1) * torch.sigmoid(gamma)
    wmin = torch.amin(wg, dim=1) * torch.sigmoid(beta)
    # a same-device divisor: the reference's division, on every device
    q_range = torch.tensor(float(qcfg.q_max - qcfg.q_min), dtype=wmax.dtype,
                           device=wmax.device)
    scale = torch.clamp_min((wmax - wmin) / q_range, 1e-8)
    zero = torch.round(qcfg.q_min - wmin / scale)
    q = wg / scale[:, None] + zero[:, None]
    q_ste = q + (torch.clamp(torch.round(q), qcfg.q_min, qcfg.q_max) - q).detach()
    dq = (q_ste - zero[:, None]) * scale[:, None]
    return dq.reshape(w.shape).to(w.dtype)


def _adam_update(g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step; ``t`` is a float32 0-dim tensor (the reference's float
    step count), so the bias corrections are float32 powers."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mhat = m / (1 - torch.pow(torch.full_like(t, b1), t))
    vhat = v / (1 - torch.pow(torch.full_like(t, b2), t))
    return -lr * mhat / (torch.sqrt(vhat) + eps), m, v


def block_problem(w_up, w_down, w_gate, b_up, x, bits, group_size, gated,
                  act_name):
    """One FFN block's LWC + LET problem: (θ₀, ``loss_of(θ)``,
    ``quantized(θ) -> (fake-quant up, fake-quant down, s)``), with θ the
    dict ``g_up``, ``b_up_c``, ``g_dn``, ``b_dn_c``, ``log_s`` of the
    reference's ``_optimize_block`` (same init, same loss)."""
    qcfg = QuantConfig(bits=bits, group_size=group_size)
    act = L.activation_fn(act_name)
    F = w_up.shape[1]
    gsz = qcfg.resolve_group(w_up.shape[0])
    gsz_d = qcfg.resolve_group(w_down.shape[0])
    dev = w_up.device

    def ffn(wu, wd, wg, bu, x):
        up = x @ wu + bu
        h = act(x @ wg) * up if gated else act(up)
        return h @ wd

    with torch.no_grad():
        y_fp = ffn(w_up, w_down, w_gate, b_up, x)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    theta = {
        "g_up": full((w_up.shape[0] // gsz, F), 4.0),
        "b_up_c": full((w_up.shape[0] // gsz, F), 4.0),
        "g_dn": full((F // gsz_d, w_down.shape[1]), 4.0),
        "b_dn_c": full((F // gsz_d, w_down.shape[1]), 4.0),
        "log_s": full((F,), 0.0),
    }

    def quantized(theta):
        s = torch.exp(theta["log_s"])
        wu = fake_quant_lwc(w_up * s[None, :], qcfg, theta["g_up"], theta["b_up_c"])
        wd = fake_quant_lwc(w_down / s[:, None], qcfg, theta["g_dn"], theta["b_dn_c"])
        return wu, wd, s

    def loss_of(theta):
        wu, wd, s = quantized(theta)
        return torch.mean(torch.square(ffn(wu, wd, w_gate, b_up * s, x) - y_fp))

    return theta, loss_of, quantized


def omni_step(loss_of, theta, m, v, step: int, lr=5e-3):
    """One Adam step of :func:`block_problem`'s loss from state (θ, m, v)
    at 0-based ``step``: returns (the loss at θ, θ', m', v'); the inputs
    are not modified."""
    params = {k: p.detach().requires_grad_(True) for k, p in theta.items()}
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    t = torch.tensor(step + 1.0, dtype=torch.float32, device=loss.device)
    theta2, m2, v2 = {}, {}, {}
    with torch.no_grad():
        for (k, p), gk in zip(params.items(), grads):
            d, m2[k], v2[k] = _adam_update(gk, m[k], v[k], t, lr)
            theta2[k] = p + d
    return loss.detach(), theta2, m2, v2


def _optimize_block(w_up, w_down, w_gate, b_up, x, bits, group_size, steps,
                    gated, act_name, lr=5e-3):
    """LWC + LET on one FFN block. Returns (fake-quant up, fake-quant down,
    scaled b_up, the per-step losses (steps,) before each update)."""
    theta, loss_of, quantized = block_problem(
        w_up, w_down, w_gate, b_up, x, bits, group_size, gated, act_name)
    m = {k: torch.zeros_like(p) for k, p in theta.items()}
    v = {k: torch.zeros_like(p) for k, p in theta.items()}
    losses = torch.empty(steps, dtype=torch.float32, device=w_up.device)
    for step in range(steps):
        losses[step], theta, m, v = omni_step(loss_of, theta, m, v, step, lr)
    with torch.no_grad():
        wu, wd, s = quantized(theta)
        return wu, wd, b_up * s, losses


def omniquant_process_dense(params, cfg: ModelConfig, calib_tokens,
                            qcfg: QuantConfig, steps: int = 200):
    """Block-wise LWC+LET optimization of every FFN. Returns (params whose
    FFN weights are the OPTIMIZED fake-quant weights (already on the grid),
    the per-layer losses (L, steps))."""
    taps = capture_dense_taps(params, cfg, calib_tokens)
    blocks = dict(params["blocks"])
    mlp = dict(blocks["mlp"])
    gated = "gate" in mlp
    out = {k: torch.empty_like(mlp[k]) for k in ("up", "down")}
    b_out = torch.empty((cfg.n_layers, cfg.d_ff), dtype=mlp["up"].dtype,
                        device=mlp["up"].device)
    losses = []
    for i in range(cfg.n_layers):
        x = taps["mlp_in"][i].reshape(-1, cfg.d_model)
        b_up = mlp["b_up"][i] if "b_up" in mlp else torch.zeros_like(b_out[i])
        gate = mlp["gate"][i] if gated else torch.zeros_like(mlp["up"][i])
        out["up"][i], out["down"][i], b_out[i], li = _optimize_block(
            mlp["up"][i], mlp["down"][i], gate, b_up, x, qcfg.bits,
            qcfg.group_size, steps, gated, cfg.activation)
        losses.append(li)
    mlp.update(out)
    if "b_up" in mlp:
        mlp["b_up"] = b_out
    blocks["mlp"] = mlp
    result = dict(params)
    result["blocks"] = blocks
    return result, torch.stack(losses)
