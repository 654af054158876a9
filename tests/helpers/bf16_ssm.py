"""The bf16 checks of a Mamba stack (``tests/test_torch_bf16_ssm.py``:
Mamba2; ``tests/test_torch_bf16_hybrid.py``: Zamba2), on the reduced
config in its own bf16 with ``test_torch_bf16.py::_pair``'s weights on
both sides; their bars are in those files' docstrings. Each arch's tests
sit in one file, so that one process builds its pair."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers.bf16_families import pair
from helpers.torch_parity import to_np
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.convert import params_from_numpy
from repro_torch.data.calib import calibration_tokens
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from test_torch_bf16 import ULPS, _forwards, _ulp_of_scale, assert_bf16_close

PARTED = 0.01          # share of a block's outputs the port may part on
SPREAD_FRAC = 1e-3     # share of the embedding table moved by one ulp


def _ulps(got, want):
    got, want = (to_np(x).astype(np.float64) for x in (got, want))
    return float(np.abs(got - want).max() / _ulp_of_scale(want))


def reference_spread(pr, tokens, draws=2):
    """The reference's own bf16 forward against itself with ``SPREAD_FRAC``
    of the embedding table moved by one bf16 ulp (up or down at random):
    the largest distance in ulps of the scale over ``draws``, for the
    logits and each collected block output."""
    jcfg, _, jp, _, _, _ = pr
    fwd = jax.jit(lambda p: jmodel.forward(p, jcfg, jnp.asarray(tokens),
                                           collect_hidden=True))
    l0, h0 = fwd(jp)
    tok = np.asarray(jp["embed"]["tok"])
    bits = tok.view(np.uint16).astype(np.int32)
    rng = np.random.default_rng(0)
    spread = np.zeros(1 + h0.shape[0])
    for _ in range(draws):
        moved = (rng.random(tok.shape) < SPREAD_FRAC) & (tok != 0)
        away = np.where(rng.random(tok.shape) < 0.5, 1, -1)
        new = np.where(moved, bits + away, bits).astype(np.uint16)
        p = {**jp, "embed": {**jp["embed"],
                             "tok": jnp.asarray(new.view(jnp.bfloat16))}}
        l, h = fwd(p)
        spread = np.maximum(spread, [_ulps(l, l0)] + [
            _ulps(h[i], h0[i]) for i in range(h.shape[0])])
    return spread


def assert_blocks_part_on_few_outputs(arch):
    """Each Mamba block of the stack on the same bf16 input: the port
    parts from the reference's jitted ``ssm_forward`` on at most PARTED
    of the outputs."""
    jcfg, tcfg, jp, tp, _, _ = pair(arch)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, jcfg.d_model)).astype(jnp.bfloat16)
    fwd = jax.jit(lambda pl, x: jssm.ssm_forward(pl, jcfg, x))
    for u in range(jp["blocks"]["ssm"]["w_z"].shape[0]):
        want = fwd(jax.tree.map(lambda a: a[u], jp["blocks"]["ssm"]),
                   jnp.asarray(x))
        got = tssm.ssm_forward({k: v[u] for k, v in
                                tp["blocks"]["ssm"].items()},
                               tcfg, params_from_numpy(x, "cpu"))
        assert got.dtype == torch.bfloat16
        parted = np.mean(to_np(got) != to_np(want))
        assert parted <= PARTED, f"block {u}: parts on {parted:.2%}"


def assert_forward_within_the_bar(arch, spread):
    """The forward over 2 x 64 tokens, logits and every collected block
    output, at ``assert_bf16_close``'s bars: elementwise ULPS, or with
    ``spread`` the reference's own spread where that is wider."""
    pr = pair(arch)
    tokens = calibration_tokens(pr[0].vocab_size, n_seqs=2, seq_len=64)
    (tl, jl, l32), (th, jh, h32) = _forwards(pr, tokens)
    bars = np.full(1 + th.shape[0], float(ULPS))
    if spread:
        bars = np.maximum(bars, reference_spread(pr, tokens))
    assert_bf16_close(tl, jl, l32, f"{arch} logits", ulps=bars[0])
    for i in range(th.shape[0]):
        assert_bf16_close(th[i], jh[i], h32[i], f"{arch} block {i}",
                          ulps=bars[1 + i])


def assert_prefill_and_decode_within_the_dtype_bar(arch):
    """Prefill of 3 x 9 tokens, then 3 decode steps, against the
    reference's jitted prefill and decode at ``assert_bf16_close``'s dtype
    bar; the conv windows bf16 and the SSD state f32."""
    jcfg, tcfg, jp, tp, jp32, jcfg32 = pair(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jpre = jax.jit(lambda p, t, cfg: jmodel.prefill(p, cfg, t, 32),
                   static_argnums=2)
    jdec = jax.jit(lambda p, t, c, i, cfg: jmodel.decode_step(p, cfg, t, c, i),
                   static_argnums=4)
    jl, jc = jpre(jp, jnp.asarray(toks), jcfg)
    l32, c32 = jpre(jp32, jnp.asarray(toks), jcfg32)
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                            32)
    ssm_cache = tc["ssm"] if "ssm" in tc else tc
    assert ssm_cache["state"].dtype == torch.float32
    assert all(w.dtype == torch.bfloat16 for w in ssm_cache["conv"].values())
    assert_bf16_close(tl, jl, l32, "prefill logits")
    for step, tok in enumerate(rng.integers(0, jcfg.vocab_size, (3, 3, 1))):
        tok = tok.astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, 9 + step, jcfg)
        l32, c32 = jdec(jp32, jnp.asarray(tok), c32, 9 + step, jcfg32)
        tl, tc = tmodel.decode_step(tp, tcfg,
                                    torch.from_numpy(tok.astype(np.int64)),
                                    tc, 9 + step)
        assert_bf16_close(tl, jl, l32, f"decode step {step}")
