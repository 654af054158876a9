"""GPTQ baseline (Frantar et al. 2023), a transcription of the reference's.

Per linear weight W (K, N) used as ``x @ W`` with calibration inputs
X (n, K): sequentially quantize input-dim rows; after quantizing row k, the
remaining rows absorb the rounding error weighted by the inverse-Hessian:

    H      = 2 XᵀX + λI            (λ = damp · mean(diag H) + 1e-6)
    U      = cholesky(H⁻¹)ᵀ        (upper factor, as in the reference code)
    err_k  = (W[k] - dq(W[k])) / U[k, k]
    W[j]  -= U[k, j] · err_k        for j > k

Group scale/zero are (re)computed from the *updated* weights at each group
boundary. The work is split in two, so that each part can be held to the
reference on its own: :func:`gptq_factor` (H, damping, the two
factorisations, U) and :func:`gptq_rows` (the row loop). The loop is eager
PyTorch — plain ``jnp`` in the reference, no kernel there either — with the
group refresh ``k % G == 0`` a host branch; the update touches rows
``k+1:`` only (the reference subtracts a masked column, ``x − 0·e = x``
elsewhere, and never reads rows ≤ k again). Layers run one after another;
the reference vmaps them.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantConfig
from repro_torch.core.taps import capture_dense_taps
from repro_torch.models.config import ModelConfig

__all__ = ["gptq_factor", "gptq_rows", "gptq_matrix", "gptq_process_dense"]

# (tap, block, weights it feeds): the quantizable linears grouped by input
_BY_INPUT = (("attn_in", "attn", ("wq", "wk", "wv")),
             ("attn_mid", "attn", ("wo",)),
             ("mlp_in", "mlp", ("up", "gate")),
             ("mlp_mid", "mlp", ("down",)))


def gptq_factor(x, damp: float = 0.01):
    """x (n, K) calibration inputs -> U (K, K), the upper Cholesky factor of
    the damped inverse Hessian (Hinv = UᵀU)."""
    xf = x.float()
    K = xf.shape[1]
    eye = torch.eye(K, dtype=torch.float32, device=xf.device)
    H = 2.0 * (xf.T @ xf)
    diag_mean = torch.mean(torch.diagonal(H))
    H = H + (damp * diag_mean + 1e-6) * eye
    Hinv = torch.cholesky_solve(eye, torch.linalg.cholesky(H))
    # symmetrize for numerical safety before the second factorization
    Hinv = 0.5 * (Hinv + Hinv.T) + 1e-8 * eye
    return torch.linalg.cholesky(Hinv).T.contiguous()


def _qparams(rows, q_max, qm: int):
    """Closed-form scale/zero of one group of rows (G, N), as the reference's
    ``gptq_matrix.qparams``; the divisor ``q_max`` is a same-device tensor,
    so the division rounds as the reference's does on every device."""
    wmax = torch.amax(rows, dim=0)
    wmin = torch.amin(rows, dim=0)
    scale = torch.clamp_min((wmax - wmin) / q_max, 1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0, qm)
    return scale, zero


def gptq_rows(w, U, bits: int, group_size: int):
    """The row loop: w (K, N) and U from :func:`gptq_factor` -> (dq (K, N)
    in w's dtype, the scales (K/G, N) each group was quantized with)."""
    K, N = w.shape
    G = group_size if group_size != -1 else K
    qm = (1 << bits) - 1
    q_max = torch.tensor(float(qm), dtype=torch.float32, device=w.device)
    W = w.float().clone()
    dq = torch.empty_like(W)
    scales = torch.empty((K // G, N), dtype=torch.float32, device=w.device)
    # row views taken once: the loop is host-bound (≈ 9 small launches a row)
    w_rows, dq_rows, u_diag = W.unbind(0), dq.unbind(0), U.diagonal().unbind(0)
    for k in range(K):
        if k % G == 0:       # refresh from the CURRENT (updated) weights
            scale, zero = _qparams(W[k:k + G], q_max, qm)
            scales[k // G] = scale
        wk, dqk = w_rows[k], dq_rows[k]
        q = torch.div(wk, scale).round_().add_(zero).clamp_(0, qm)
        torch.mul(scale, q.sub_(zero), out=dqk)
        err = torch.sub(wk, dqk).div_(u_diag[k])
        # W[j] -= U[k, j] · err for j > k, in place (one pass, no temporary)
        W[k + 1:].addcmul_(U[k, k + 1:, None], err, value=-1.0)
    return dq.to(w.dtype), scales


def gptq_matrix(w, x, bits: int, group_size: int, damp: float = 0.01):
    """w: (K, N); x: (n, K) calibration inputs. Returns dequantized-domain
    GPTQ-compensated weights (K, N)."""
    return gptq_rows(w, gptq_factor(x, damp), bits, group_size)[0]


def gptq_process_dense(params, cfg: ModelConfig, calib_tokens,
                       qcfg: QuantConfig, damp: float = 0.01):
    """Run GPTQ over every quantizable linear of a dense decoder.

    Returns params with all attn/mlp weights replaced by GPTQ-compensated
    dequantized-domain weights (on the quantization grid, so a later
    ``fake_quant`` with the same config is ~idempotent; the search
    re-quantizes transformed versions of them). Weights that share an input
    (wq/wk/wv; up/gate) share its factorisation: the same U the reference
    computes once per weight.
    """
    taps = capture_dense_taps(params, cfg, calib_tokens)
    blocks = dict(params["blocks"])
    for sub in ("attn", "mlp"):
        blocks[sub] = dict(blocks[sub])
    for tap, sub, keys in _BY_INPUT:
        keys = [k for k in keys if k in blocks[sub]]
        outs = {k: torch.empty_like(blocks[sub][k]) for k in keys}
        for i in range(cfg.n_layers):
            x = taps[tap][i]
            U = gptq_factor(x.reshape(-1, x.shape[-1]), damp)
            for k in keys:
                outs[k][i] = gptq_rows(blocks[sub][k][i], U, qcfg.bits,
                                       qcfg.group_size)[0]
        blocks[sub].update(outs)
    out = dict(params)
    out["blocks"] = blocks
    return out
