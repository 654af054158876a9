"""Public wrappers of the hand-written kernels.

For a CPU tensor each wrapper runs the kernel's plain PyTorch version
(``ref.py``); that is the only reason it ever does. For a CUDA tensor it
validates shape, dtype, device and contiguity, allocates the outputs,
launches the CUDA kernel on the current stream and adds one to its launch
count — or raises. There is no fallback: the TPU wrapper's ``tq_plan``
fell back to jnp above its strip budget, the port's planners only size the
launch; no plain version on the card and no CPU detour.
"""
from __future__ import annotations

import importlib

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import ref

# the kernel-binding modules by module path: the package re-exports the
# wrappers below under the same names as these submodules
_gq = importlib.import_module("repro_torch.kernels.group_quant")
_tq = importlib.import_module("repro_torch.kernels.transform_quant")
_pd = importlib.import_module("repro_torch.kernels.paged_decode")
_fd = importlib.import_module("repro_torch.kernels.flash_decode")
_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
_ca = importlib.import_module("repro_torch.kernels.causal_attention")

__all__ = ["group_quant", "transform_quant", "paged_decode",
           "paged_decode_route", "flash_decode", "quant_matmul",
           "causal_attention", "LAUNCHES", "reset_launch_counts"]

# kernel launches per wrapper (per route for paged_decode) since the last
# reset (plain integers)
LAUNCHES = {"group_quant": 0, "transform_quant": 0, "paged_decode": 0,
            "paged_decode_gqa": 0, "paged_decode_gqa_mp": 0,
            "flash_decode": 0, "quant_matmul": 0, "causal_attention": 0}

# columns: the first group_quant kernel's limit (gridDim.y blocks of 256
# threads), kept as the wrappers' check; the kernels walk 1-D grids
_MAX_GRID_Y = 65535 * 256


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _require_card(name: str, t: torch.Tensor) -> None:
    """A wrapper's tensor off the CPU must be a real CUDA tensor: a fake
    one (the dry run's trace, ``launch.dryrun``) or a meta one raises
    before anything is built or launched."""
    _require(t.device.type == "cuda",
             f"{name} runs on CUDA or CPU tensors, got {t.device}")
    _require(not is_fake(t), f"{name} reached with a fake tensor: a fake "
             f"trace builds and launches no kernel")


def _check_cuda(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype in dtypes, f"{name} has dtype {t.dtype}, expected one of "
             f"{sorted(str(d) for d in dtypes)}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_head_dim(Dh: int) -> None:
    """The decode kernels (paged routes and flash) load 4 values at a
    time."""
    _require(Dh % 4 == 0, f"head dim {Dh} must be a multiple of 4 (the "
             f"kernel loads 4 values at a time)")


def _check_quant_args(K: int, N: int, bits: int, group: int) -> None:
    _require(1 <= bits <= 8, f"bits must be in [1, 8], got {bits}")
    _require(group > 0 and K % group == 0,
             f"K={K} must be a positive multiple of group={group}")
    _require(0 < N <= _MAX_GRID_Y, f"N={N} out of the kernel's range")


def group_quant(w: torch.Tensor, *, bits: int, group: int,
                round_range: bool = False):
    """Fused fake-quant roundtrip of w (K, N) fp32 or bf16, groups of
    ``group`` rows along K. Returns (fq (K, N) in w's dtype, scale (K/G, N)
    f32, zero (K/G, N) f32).

    The arithmetic is f32 (the TPU kernel's). ``round_range`` rounds each
    group's range, scale and its 1e-8 floor to w's dtype as they are
    computed: the reference's ``core.quant.fake_quant`` on a bf16 w
    (``core.quant.compute_qparams`` in bf16). For an f32 w it changes
    nothing."""
    if w.device.type == "cpu":
        return ref.group_quant_ref(w, bits, group, round_range=round_range)
    _require_card("group_quant", w)
    _require(w.ndim == 2, f"w must be 2-D, got shape {tuple(w.shape)}")
    K, N = w.shape
    _check_cuda("w", w, w.device, (torch.float32, torch.bfloat16), (K, N))
    _check_quant_args(K, N, bits, group)
    fq = torch.empty_like(w)
    scale = torch.empty((K // group, N), dtype=torch.float32, device=w.device)
    zero = torch.empty_like(scale)
    _gq.launch(w, fq, scale, zero, bits=bits, group=group,
               round_range=round_range)
    LAUNCHES["group_quant"] += 1
    return fq, scale, zero


def transform_quant(w: torch.Tensor, pi: torch.Tensor, s: torch.Tensor,
                    phi: torch.Tensor, *, bits: int, group: int, mode: str):
    """Fused (π, s, φ) invariant transform + group fake-quant roundtrip.

    mode="up":   w (D, F) -> (fq (D, F), scale (D/G, F), zero (D/G, F))
    mode="down": w (F, D) -> (fq (F, D), scale (F/G, D), zero (F/G, D))
    w f32 or bf16, computed in f32 either way, fq in w's dtype (the TPU
    kernel's ``out_shape``), scale and zero f32; pi (F,) int64, a gather
    index into [0, F) (a permutation on the search's path); s (F,) f32; phi
    (F/2,) f32. A CUDA call launches the kernel by ``transform_quant.plan``
    or raises.
    """
    _require(mode in _tq.MODES, f"mode must be 'up' or 'down', got {mode!r}")
    if w.device.type == "cpu":
        return ref.transform_quant_ref(w, pi, s, phi, bits=bits, group=group,
                                       mode=mode)
    _require_card("transform_quant", w)
    _require(w.ndim == 2, f"w must be 2-D, got shape {tuple(w.shape)}")
    K, N = w.shape
    f = N if mode == "up" else K
    _require(f % 2 == 0, f"transformed axis f={f} must be even")
    _check_cuda("w", w, w.device, (torch.float32, torch.bfloat16), (K, N))
    _check_cuda("pi", pi, w.device, (torch.int64,), (f,))
    _check_cuda("s", s, w.device, (torch.float32,), (f,))
    _check_cuda("phi", phi, w.device, (torch.float32,), (f // 2,))
    _check_quant_args(K, N, bits, group)
    # raises for a shape it cannot take
    plan = _tq.plan(K, N, group, mode, w.element_size())
    _require(mode == "up" or plan.vec == 1 or w.data_ptr() % 16 == 0,
             "w must start on a 16-byte boundary (the down kernel copies 16 "
             "bytes at a time)")
    lo, hi = torch.stack(torch.aminmax(pi)).tolist()   # one host sync
    _require(0 <= lo and hi < f, f"pi must index [0, {f})")
    svec = s if mode == "up" else 1.0 / s
    cos, sin = torch.cos(phi), torch.sin(phi)
    fq = torch.empty_like(w)
    scale = torch.empty((K // group, N), dtype=torch.float32, device=w.device)
    zero = torch.empty_like(scale)
    _tq.launch(w, pi, svec, cos, sin, fq, scale, zero, bits=bits,
               group=group, mode=mode, plan=plan)
    LAUNCHES["transform_quant"] += 1
    return fq, scale, zero


def _check_kv_loads(**pools) -> None:
    """The decode kernels load K/V 4 values at a time."""
    for name, t in pools.items():
        _require(t.data_ptr() % (4 * t.element_size()) == 0,
                 f"{name} must start on a {4 * t.element_size()}-byte "
                 f"boundary (the kernel loads 4 values at a time)")


def paged_decode_route(H: int, Hkv: int, *, fused_gqa: bool = True,
                       gqa_pages_per_block: int = 1) -> str:
    """Which paged-decode kernel a call takes (``repro.kernels.ops``'s
    routing): GQA shapes with ``fused_gqa`` take the per-KV-head kernel, in
    its multi-page form when ``gqa_pages_per_block > 1``; MHA, or
    ``fused_gqa=False``, takes the per-query-head kernel."""
    if fused_gqa and H > Hkv and H % Hkv == 0:
        return "paged_decode_gqa_mp" if gqa_pages_per_block > 1 \
            else "paged_decode_gqa"
    return "paged_decode"


def paged_decode(q, k_pages, v_pages, block_tables, seq_lens, k_scale=None,
                 v_scale=None, *, normalize: bool = True,
                 fused_gqa: bool = True, gqa_pages_per_block: int = 1):
    """Paged one-token decode attention over a block-table page pool.

    q (B, H, Dh) f32/bf16 attends over the pages named by ``block_tables``
    (B, P) int32 in the (N, page_size, Hkv, Dh) pools (f32, bf16, or int8
    with f32 (N, page_size, Hkv) scales), masked to ``seq_lens`` (B,) int32.
    Returns (B, H, Dh) f32, or the (acc, m, l) partials when
    ``normalize=False``. A CPU call runs ``ref.paged_decode_ref``; a CUDA
    call launches the kernel of :func:`paged_decode_route` (the split-KV
    pass and, where the planner splits, the merge of its partials; one
    count per call) or raises.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, block_tables,
                                    seq_lens, k_scale, v_scale,
                                    normalize=normalize)
    _require_card("paged_decode", q)
    _require(q.ndim == 3 and k_pages.ndim == 4,
             f"q must be (B, H, Dh) and pools (N, psz, Hkv, Dh), got "
             f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, Dh = q.shape
    N, psz, Hkv, _ = k_pages.shape
    P = block_tables.shape[-1]
    _require(H % Hkv == 0, f"H={H} not a multiple of Hkv={Hkv}")
    _check_head_dim(Dh)
    route = paged_decode_route(H, Hkv, fused_gqa=fused_gqa,
                               gqa_pages_per_block=gqa_pages_per_block)
    mp = gqa_pages_per_block if route == "paged_decode_gqa_mp" else 1
    dev = q.device
    q = q if q.dtype == torch.float32 else q.float()
    _check_cuda("q", q, dev, (torch.float32,), (B, H, Dh))
    kv_types = (torch.float32, torch.bfloat16, torch.int8)
    _check_cuda("k_pages", k_pages, dev, kv_types, (N, psz, Hkv, Dh))
    _check_cuda("v_pages", v_pages, dev, (k_pages.dtype,), (N, psz, Hkv, Dh))
    _check_kv_loads(k_pages=k_pages, v_pages=v_pages)
    _check_cuda("block_tables", block_tables, dev, (torch.int32,), (B, P))
    _check_cuda("seq_lens", seq_lens, dev, (torch.int32,), (B,))
    _require((k_scale is None) == (v_scale is None),
             "k_scale and v_scale come together")
    if k_scale is not None:
        _check_cuda("k_scale", k_scale, dev, (torch.float32,), (N, psz, Hkv))
        _check_cuda("v_scale", v_scale, dev, (torch.float32,), (N, psz, Hkv))
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)  # noqa: E741 — softmax (m, l)
    _pd.launch(route, q, k_pages, v_pages, block_tables, seq_lens, k_scale,
               v_scale, out, m, l, normalize=normalize, pages_per_block=mp)
    LAUNCHES[route] += 1
    return out if normalize else (out, m, l)


def flash_decode(q, k, v, k_scale=None, v_scale=None, *, kv_len=None):
    """One-token decode attention over a contiguous KV cache.

    q (B, H, Dh) f32/bf16 attends over the first ``kv_len`` (None: S) rows
    of k/v (B, S, Hkv, Dh) — f32, bf16, or int8 with f32 (B, S, Hkv)
    scales; query head h reads KV head h // (H // Hkv), so GQA caches are
    not repeated. Returns (B, H, Dh) f32; ``kv_len = 0`` gives exactly 0. A
    CPU call runs ``ref.flash_decode_ref``; a CUDA call launches the kernel
    by ``flash_decode.plan`` (the split-KV pass over the live rows and,
    where the planner splits, the merge of its partials; one count per
    call) or raises.
    """
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, k_scale, v_scale, kv_len)
    _require_card("flash_decode", q)
    _require(q.ndim == 3 and k.ndim == 4,
             f"q must be (B, H, Dh) and k/v (B, S, Hkv, Dh), got "
             f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Dh = q.shape
    _, S, Hkv, _ = k.shape
    _require(S > 0 and Hkv > 0 and H % Hkv == 0,
             f"H={H} not a multiple of Hkv={Hkv}, or an empty cache")
    _check_head_dim(Dh)
    n = S if kv_len is None else int(kv_len)
    _require(n >= 0, f"kv_len must be >= 0, got {kv_len}")
    dev = q.device
    q = q if q.dtype == torch.float32 else q.float()
    _check_cuda("q", q, dev, (torch.float32,), (B, H, Dh))
    _check_cuda("k", k, dev, (torch.float32, torch.bfloat16, torch.int8),
                (B, S, Hkv, Dh))
    _check_cuda("v", v, dev, (k.dtype,), (B, S, Hkv, Dh))
    _check_kv_loads(k=k, v=v)
    _require((k_scale is None) == (v_scale is None),
             "k_scale and v_scale come together")
    if k_scale is not None:
        _check_cuda("k_scale", k_scale, dev, (torch.float32,), (B, S, Hkv))
        _check_cuda("v_scale", v_scale, dev, (torch.float32,), (B, S, Hkv))
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    _fd.launch(q, k, v, k_scale, v_scale, out, kv_len=min(n, S))
    LAUNCHES["flash_decode"] += 1
    return out


def quant_matmul(x, packed, scale, zero, *, bits: int, group: int):
    """x (M, K) f32/bf16 @ dequant(packed (K_pad/vpw, N)) -> (M, N) f32.

    ``packed`` holds the 32-bit words as int32 (slot i of word w is row
    w·vpw + i at bit offset i·bits, vpw = 32 // bits); scale / zero are
    (K_pad/G, N) f32 and rows K..K_pad-1 are padding. Every shape takes the
    kernel (the reference's wrapper falls back to jnp off its tiling). A
    CPU call runs ``ref.quant_matmul_ref``; a CUDA call launches the kernel
    by ``quant_matmul.plan`` (the split-K pass and, where K is split, the
    sum of its partials; one count per call) or raises.
    """
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, packed, scale, zero, bits, group)
    _require_card("quant_matmul", x)
    _require(1 <= bits <= 8, f"bits must be in [1, 8], got {bits}")
    _require(x.ndim == 2 and packed.ndim == 2,
             f"x must be (M, K) and packed (W, N), got {tuple(x.shape)} and "
             f"{tuple(packed.shape)}")
    M, K = x.shape
    W, N = packed.shape
    k_pad = W * (32 // bits)
    _require(group > 0 and k_pad % group == 0 and K <= k_pad,
             f"packed rows cover K_pad={k_pad}, which must hold K={K} and be "
             f"a multiple of group={group}")
    _require(0 < M <= 65535 * 8 and 0 < N, f"M={M}, N={N} out of the "
             f"kernel's range")
    dev = x.device
    _check_cuda("x", x, dev, (torch.float32, torch.bfloat16), (M, K))
    _check_cuda("packed", packed, dev, (torch.int32,), (W, N))
    _check_cuda("scale", scale, dev, (torch.float32,), (k_pad // group, N))
    _check_cuda("zero", zero, dev, (torch.float32,), (k_pad // group, N))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    _qm.launch(x, packed, scale, zero, out, bits=bits, group=group)
    LAUNCHES["quant_matmul"] += 1
    return out


def causal_attention(q, k, v):
    """Causal self-attention of q (B, S, Hq, Dh) over k / v (B, S, Hkv,
    Dh), bf16, without a cache -> (B, S, Hq, Dh) bf16: the function of
    ``blocked_attention(q, k, v, causal=True)`` with f32 scores; query head
    h reads KV head h // (Hq // Hkv), nothing repeated. A CPU call runs
    ``ref.causal_attention_ref``; a CUDA call launches the kernel (Dh 64 or
    128, contiguous tensors on 16-byte boundaries, no input that requires
    grad: the kernel has no backward) or raises.
    """
    if q.device.type == "cpu":
        return ref.causal_attention_ref(q, k, v)
    _require_card("causal_attention", q)
    _require(q.ndim == 4 and k.ndim == 4,
             f"q must be (B, S, Hq, Dh) and k/v (B, S, Hkv, Dh), got "
             f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    _require(S > 0 and Hkv > 0 and Hq % Hkv == 0,
             f"Hq={Hq} not a multiple of Hkv={Hkv}, or an empty sequence")
    _require(Dh in _ca.HEAD_DIMS, f"head dim {Dh} not compiled in (the "
             f"kernel takes {_ca.HEAD_DIMS})")
    dev = q.device
    _check_cuda("q", q, dev, (torch.bfloat16,), (B, S, Hq, Dh))
    _check_cuda("k", k, dev, (torch.bfloat16,), (B, S, Hkv, Dh))
    _check_cuda("v", v, dev, (torch.bfloat16,), (B, S, Hkv, Dh))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.data_ptr() % 16 == 0, f"{name} must start on a 16-byte "
                 f"boundary (the kernel copies 16 bytes at a time)")
        _require(not t.requires_grad, f"{name} requires grad: the kernel "
                 f"has no backward")
    out = torch.empty_like(q)
    _ca.launch(q, k, v, out)
    LAUNCHES["causal_attention"] += 1
    return out
