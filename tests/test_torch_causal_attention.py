"""The ``causal_attention`` kernel's host side and its route, on the CPU.

- ``kernels.causal_attention`` on a CPU tensor runs its plain version,
  ``blocked_attention(q, k, v, causal=True)``, bit for bit, and counts no
  launch.
- ``models.layers.self_attention`` without a cache takes the kernel only
  where ``takes_causal_kernel`` admits its inputs: each excluded case (an
  f32 q, ``causal=False``, a cache, an input that requires grad, Dh 112,
  bf16 scores, a CPU tensor) takes ``blocked_attention``. The card is
  stood in for by patching ``layers._real_cuda``, with the kernel's
  wrapper replaced by a spy; a CPU bf16 call gives what it gave before.
- The arguments the binding hands ``rq_causal_attention`` (with the
  library stubbed out), its row plan, and the errors it raises on what the
  source reports.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
import importlib
from types import SimpleNamespace

import pytest
import torch

import repro_torch.kernels as tkernels
from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")
tca = importlib.import_module("repro_torch.kernels.causal_attention")


def _qkv(B, S, Hq, Hkv, Dh, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype)
                 for shape in ((B, S, Hq, Dh), (B, S, Hkv, Dh),
                               (B, S, Hkv, Dh)))


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [(2, 40, 4, 2, 64),
                                           (1, 17, 2, 2, 128),
                                           (2, 1, 4, 1, 64)],
                         ids=["gqa", "mha", "s1"])
def test_cpu_wrapper_is_blocked_attention_and_counts_nothing(B, S, Hq, Hkv,
                                                             Dh):
    tkernels.reset_launch_counts()
    q, k, v = _qkv(B, S, Hq, Hkv, Dh)
    got = tkernels.causal_attention(q, k, v)
    want = tL.blocked_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, want)
    assert torch.equal(tref.causal_attention_ref(q, k, v), want)
    assert tkernels.LAUNCHES["causal_attention"] == 0


def _cfg(Dh=64, dtype="bfloat16", softmax="float32"):
    return ModelConfig(d_model=128, n_heads=4, n_kv_heads=2, head_dim=Dh,
                       param_dtype=dtype, compute_dtype=dtype,
                       attn_softmax_dtype=softmax, attn_chunk=16)


def _attn_params(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.compute_dtype)
    hd, D = cfg.resolved_head_dim, cfg.d_model

    def w(i, o):
        return (torch.randn((i, o), generator=g) * i ** -0.5).to(dt)
    return {"wq": w(D, cfg.n_heads * hd), "wk": w(D, cfg.n_kv_heads * hd),
            "wv": w(D, cfg.n_kv_heads * hd), "wo": w(cfg.n_heads * hd, D)}


@pytest.fixture
def route(monkeypatch):
    """Record which path each ``self_attention`` call takes: the kernel's
    wrapper is a spy (it runs the plain version), ``blocked_attention`` is
    wrapped; ``on_card(True)`` makes every tensor count as a real CUDA
    one."""
    calls = []
    real_blocked = tL.blocked_attention

    def kernel(q, k, v):
        calls.append("kernel")
        return real_blocked(q, k, v, causal=True)

    def blocked(*a, **kw):
        calls.append("blocked")
        return real_blocked(*a, **kw)

    monkeypatch.setattr(tkernels, "causal_attention", kernel)
    monkeypatch.setattr(tL, "blocked_attention", blocked)

    def on_card(flag):
        monkeypatch.setattr(tL, "_real_cuda", lambda t: flag)
    return SimpleNamespace(calls=calls, on_card=on_card)


def _run(cfg, *, causal=True, cache=None, grad=False, S=12, seed=2):
    p = _attn_params(cfg)
    if grad:
        p = {k: w.requires_grad_() for k, w in p.items()}
    dt = getattr(torch, cfg.compute_dtype)
    x = torch.randn((2, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed)).to(dt)
    return tL.self_attention(p, cfg, x, torch.arange(S), causal=causal,
                             cache=cache)


def test_route_takes_the_kernel_where_admitted(route):
    route.on_card(True)
    out, _ = _run(_cfg())
    assert route.calls == ["kernel"]
    assert out.dtype == torch.bfloat16


def _cache(cfg):
    shape = (2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16),
            "v": torch.zeros(shape, dtype=torch.bfloat16)}


EXCLUDED = {
    "f32": lambda: _run(_cfg(dtype="float32")),
    "not-causal": lambda: _run(_cfg(), causal=False),
    "cache": lambda: _run(_cfg(), cache=_cache(_cfg())),
    "requires-grad": lambda: _run(_cfg(), grad=True),
    "dh-112": lambda: _run(_cfg(Dh=112)),
    "bf16-scores": lambda: _run(_cfg(softmax="bfloat16")),
}


@pytest.mark.parametrize("case", list(EXCLUDED))
def test_route_leaves_each_excluded_case_to_blocked_attention(case, route):
    route.on_card(True)
    EXCLUDED[case]()
    assert route.calls == ["blocked"]


def test_route_leaves_a_cpu_tensor_to_blocked_attention(route):
    _run(_cfg())
    assert route.calls == ["blocked"]


def test_predicate_reads_the_inputs_alone(monkeypatch):
    monkeypatch.setattr(tL, "_real_cuda", lambda t: True)
    q, k, v = _qkv(1, 4, 4, 2, 128)
    kw = dict(causal=True, softmax_dtype=torch.float32)
    assert tL.takes_causal_kernel(q, k, v, **kw)
    assert not tL.takes_causal_kernel(q, k.float(), v, **kw)
    assert not tL.takes_causal_kernel(q, k, v.float(), **kw)
    assert not tL.takes_causal_kernel(q, k, v.requires_grad_(), **kw)
    monkeypatch.setattr(tL, "_real_cuda", lambda t: False)
    assert not tL.takes_causal_kernel(q, k, v.detach(), **kw)


def test_real_cuda_refuses_cpu_meta_and_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert not tL._real_cuda(torch.zeros(2))
    assert not tL._real_cuda(torch.zeros(2, device="meta"))
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.zeros(2))
    assert not tL._real_cuda(fake)


@pytest.mark.parametrize("Dh", [64, 128])
def test_cpu_bf16_self_attention_is_unchanged(Dh):
    """On the CPU a bf16 call still computes ``blocked_attention`` then
    ``attn_out``, bit for bit."""
    cfg = _cfg(Dh=Dh)
    p = _attn_params(cfg)
    x = torch.randn((2, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    pos = torch.arange(12)
    got, cache = tL.self_attention(p, cfg, x, pos)
    q, k, v = tL.attn_qkv(p, cfg, x, pos)
    want = tL.attn_out(p, tL.blocked_attention(
        q, k, v, causal=True, chunk=cfg.attn_chunk))
    assert cache is None and torch.equal(got, want)


# ---- the binding, with the library stubbed out ---------------------------

_C_ARGS = ("q", "k", "v", "out", "B", "S", "Hq", "Hkv", "Dh", "scale",
           "stream")


def _launch_args(monkeypatch, *, B, S, Hq, Hkv, Dh, rc=0):
    """The arguments ``causal_attention.launch`` hands
    ``rq_causal_attention`` for CPU tensors of these shapes, with the
    library and the stream stubbed out; ``rc`` is what the stub returns."""
    calls = []

    def entry(*a):
        calls.append(dict(zip(_C_ARGS, a, strict=True)))
        return rc

    monkeypatch.setattr(tca.build, "load", lambda name, sig: SimpleNamespace(
        rq_causal_attention=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=7))
    q, k, v = _qkv(B, S, Hq, Hkv, Dh)
    out = torch.empty_like(q)
    tca.launch(q, k, v, out)
    (args,) = calls
    assert (args["q"], args["k"], args["v"], args["out"]) == tuple(
        t.data_ptr() for t in (q, k, v, out))
    return args


def test_launch_hands_the_kernel_its_shape_and_scale(monkeypatch):
    a = _launch_args(monkeypatch, B=8, S=512, Hq=32, Hkv=8, Dh=128)
    assert (a["B"], a["S"], a["Hq"], a["Hkv"], a["Dh"], a["stream"]) == \
        (8, 512, 32, 8, 128, 7)
    # Dh^-0.5 rounded to f32, as blocked_attention's f32 scale
    assert a["scale"] == float(torch.tensor(128 ** -0.5))
    assert a["scale"] != 128 ** -0.5
    b = _launch_args(monkeypatch, B=2, S=40, Hq=4, Hkv=4, Dh=64)
    assert b["scale"] == 0.125


@pytest.mark.parametrize("rc,err", [(-2, ValueError), (700, RuntimeError)],
                         ids=["head-dim", "cuda"])
def test_launch_raises_on_what_the_source_reports(rc, err, monkeypatch):
    with pytest.raises(err):
        _launch_args(monkeypatch, B=1, S=8, Hq=2, Hkv=2, Dh=64, rc=rc)


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tkernels.causal_attention(q, q, q)


def test_qwen3_4b_config_is_admitted_and_opt_1_3b_is_not(monkeypatch):
    """The search cells' two models: Qwen3-4B's bf16 attention (32 / 8 x
    128) is admitted, opt-1.3b's f32 one (32 x 64) is not."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(tL, "_real_cuda", lambda t: True)
    for name, admitted in (("qwen3-4b", True), ("opt-1.3b", False)):
        cfg = get_config(name)
        dt = getattr(torch, cfg.compute_dtype)
        hd = cfg.resolved_head_dim
        q = torch.empty((1, 2, cfg.n_heads, hd), dtype=dt)
        kv = torch.empty((1, 2, cfg.n_kv_heads, hd), dtype=dt)
        assert tL.takes_causal_kernel(
            q, kv, kv, causal=True,
            softmax_dtype=getattr(torch, cfg.attn_softmax_dtype)) == admitted
