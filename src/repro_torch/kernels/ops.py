"""Public wrappers of the hand-written kernels.

For a CPU tensor each wrapper runs the kernel's plain PyTorch version
(``ref.py``); that is the only reason it ever does. For a CUDA tensor it
validates shape, dtype, device and contiguity, allocates the outputs,
launches the CUDA kernel on the current stream and adds one to its launch
count — or raises. There is no fallback: no strip-size planner like the
TPU wrapper's ``tq_plan``, no plain version on the card and no CPU detour.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.kernels import ref

# the kernel-binding modules by module path: the package re-exports the
# wrappers below under the same names as these submodules
_gq = importlib.import_module("repro_torch.kernels.group_quant")
_tq = importlib.import_module("repro_torch.kernels.transform_quant")

__all__ = ["group_quant", "transform_quant", "LAUNCHES",
           "reset_launch_counts"]

# kernel launches per wrapper since the last reset (plain integers)
LAUNCHES = {"group_quant": 0, "transform_quant": 0}

_MAX_GRID_Y = 65535 * 256   # columns: gridDim.y blocks of 256 threads


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _check_cuda(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype in dtypes, f"{name} has dtype {t.dtype}, expected one of "
             f"{sorted(str(d) for d in dtypes)}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_quant_args(K: int, N: int, bits: int, group: int) -> None:
    _require(1 <= bits <= 8, f"bits must be in [1, 8], got {bits}")
    _require(group > 0 and K % group == 0,
             f"K={K} must be a positive multiple of group={group}")
    _require(0 < N <= _MAX_GRID_Y, f"N={N} out of the kernel's range")


def group_quant(w: torch.Tensor, *, bits: int, group: int):
    """Fused fake-quant roundtrip of w (K, N) fp32 or bf16, groups of
    ``group`` rows along K. Returns (fq (K, N) in w's dtype, scale (K/G, N)
    f32, zero (K/G, N) f32)."""
    if w.device.type == "cpu":
        return ref.group_quant_ref(w, bits, group)
    _require(w.device.type == "cuda",
             f"group_quant runs on CUDA or CPU tensors, got {w.device}")
    _require(w.ndim == 2, f"w must be 2-D, got shape {tuple(w.shape)}")
    K, N = w.shape
    _check_cuda("w", w, w.device, (torch.float32, torch.bfloat16), (K, N))
    _check_quant_args(K, N, bits, group)
    fq = torch.empty_like(w)
    scale = torch.empty((K // group, N), dtype=torch.float32, device=w.device)
    zero = torch.empty_like(scale)
    _gq.launch(w, fq, scale, zero, bits=bits, group=group)
    LAUNCHES["group_quant"] += 1
    return fq, scale, zero


def transform_quant(w: torch.Tensor, pi: torch.Tensor, s: torch.Tensor,
                    phi: torch.Tensor, *, bits: int, group: int, mode: str):
    """Fused (π, s, φ) invariant transform + group fake-quant roundtrip.

    mode="up":   w (D, F) -> (fq (D, F), scale (D/G, F), zero (D/G, F))
    mode="down": w (F, D) -> (fq (F, D), scale (F/G, D), zero (F/G, D))
    w f32; pi (F,) int64, a permutation; s (F,) f32; phi (F/2,) f32.
    """
    _require(mode in _tq.MODES, f"mode must be 'up' or 'down', got {mode!r}")
    if w.device.type == "cpu":
        return ref.transform_quant_ref(w, pi, s, phi, bits=bits, group=group,
                                       mode=mode)
    _require(w.device.type == "cuda",
             f"transform_quant runs on CUDA or CPU tensors, got {w.device}")
    _require(w.ndim == 2, f"w must be 2-D, got shape {tuple(w.shape)}")
    K, N = w.shape
    f = N if mode == "up" else K
    _require(f % 2 == 0, f"transformed axis f={f} must be even")
    _check_cuda("w", w, w.device, (torch.float32,), (K, N))
    _check_cuda("pi", pi, w.device, (torch.int64,), (f,))
    _check_cuda("s", s, w.device, (torch.float32,), (f,))
    _check_cuda("phi", phi, w.device, (torch.float32,), (f // 2,))
    _check_quant_args(K, N, bits, group)
    lo, hi = torch.stack(torch.aminmax(pi)).tolist()   # one host sync
    _require(0 <= lo and hi < f, f"pi must index [0, {f})")
    svec = s if mode == "up" else 1.0 / s
    cos, sin = torch.cos(phi), torch.sin(phi)
    fq = torch.empty_like(w)
    scale = torch.empty((K // group, N), dtype=torch.float32, device=w.device)
    zero = torch.empty_like(scale)
    _tq.launch(w, pi, svec, cos, sin, fq, scale, zero, bits=bits,
               group=group, mode=mode)
    LAUNCHES["transform_quant"] += 1
    return fq, scale, zero
