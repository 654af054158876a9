"""The bf16 train-step checks (``tests/test_torch_bf16_train*.py``): the
reduced configs in their own bf16 with ``test_torch_bf16.py::_pair``'s
weights on both sides, 2 x 32 calibration tokens (and the stub frontends'
bf16 frames or patches), and the bars the files' docstrings state.

The reference's bf16 backward is chaotic at the ulp level: moving one
element in a thousand of its token embedding by one ulp moves its own
gradients by several ulps. So a gradient is held to that spread, not to
equality:

- the loss within ``LOSS_RTOL`` of the reference's jitted
  ``value_and_grad``;
- each gradient leaf elementwise within ``SPREAD_X`` x the reference's own
  spread on that leaf, with a floor of one ulp of the leaf's scale in its
  dtype. The spread is the largest distance of the reference's gradients
  from themselves under ``DRAWS`` draws of ``SPREAD_FRAC`` of the token
  embedding moved by one ulp, and with the batch's rows reversed (the same
  loss summed in another order: XLA reduces a bf16 gradient over the
  batch and sequence in bf16, rounding after every add, so a norm weight's
  or a bias's gradient moves by up to 2.5 ulps of its scale under that
  reordering alone, where one-ulp embedding moves show about one);
- each leaf's RMS distance from the fp32 model's gradients (the same
  weights widened) at most ``FARTHER`` x the reference's, except a key
  bias (``ZERO_GRAD``): its exact gradient is 0 (softmax is shift-invariant
  per query), so both packages return rounding noise and the RMS bar would
  weigh noise against noise (the reference's own embedding draws read
  1.38-1.61 x its unmoved run there); it is held elementwise.

AdamW is held with the reference's jitted update fed the same gradients
and state (``assert_adamw_like``): m and v at
``test_torch_train.py::test_adamw_update_matches_reference``'s bars, the
bf16 leaves equal except one ulp on fewer than ``ULP_SHARE`` of their
elements, the f32 leaves at that test's params bar.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers.bf16_families import frontend_bf16, jkw, pair, tkw
from helpers.torch_parity import to_np
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import adamw as ja
from repro_torch.convert import params_from_numpy
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as ta

LOSS_RTOL = 1e-4
SPREAD_FRAC = 1e-3     # share of the token embedding moved by one ulp
DRAWS = 2
SPREAD_X = 2           # elementwise bar, in units of the reference's spread
FARTHER = 1.25         # port vs fp32 against reference bf16 vs fp32, by RMS
ULP_SHARE = 1e-3       # share of a bf16 leaf that may sit one ulp off
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
ZERO_GRAD = ("attn/bk", "xattn/bk")


def jloss_fn(cfg):
    """The reference's train-step loss (``repro.launch.steps``'s
    ``loss_of``): mean next-token CE, a vision stack's patch logits
    dropped."""
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0

    def loss_of(p, mb):
        kw = {k: mb[k] for k in ("vision_embeds", "enc_embeds") if k in mb}
        logits = jmodel.forward(p, cfg, mb["tokens"], **kw)
        if prefix:
            logits = logits[:, prefix:]
        return jmodel.lm_loss(logits[:, :-1], mb["tokens"][:, 1:],
                              cfg.vocab_size)

    return loss_of


def leaves(tree, path=()):
    """(path "a/b/c", leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def f64(x):
    return to_np(x).astype(np.float64)


def ulp_of_scale(ref, dtype) -> float:
    """One ulp, in ``dtype``, of the largest magnitude of ``ref``."""
    m = float(np.abs(ref).max())
    if m == 0.0:
        return 0.0
    return 2.0 ** (np.floor(np.log2(m)) - (7 if dtype == "bfloat16" else 23))


def moved_embedding(jp, rng):
    """``jp`` with ``SPREAD_FRAC`` of its non-zero token-embedding elements
    moved one bf16 ulp up or down at random."""
    tok = np.asarray(jp["embed"]["tok"])
    bits = tok.view(np.uint16).astype(np.int32)
    moved = (rng.random(tok.shape) < SPREAD_FRAC) & (tok != 0)
    away = np.where(rng.random(tok.shape) < 0.5, 1, -1)
    new = np.where(moved, bits + away, bits).astype(np.uint16)
    return {**jp, "embed": {**jp["embed"],
                            "tok": jnp.asarray(new.view(jnp.bfloat16))}}


def widen(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a).astype(
        np.float32)), tree)


def to_jax(tree):
    """A port tree as jax arrays of the same dtypes."""
    return jax.tree.map(jnp.asarray, ta.tree_map(
        lambda t: to_np(t).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
        else to_np(t), tree))


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


class Family:
    """One arch's reduced bf16 pair, batch and compiled reference functions
    (``value_and_grad`` in bf16 and in fp32, the train step), built once per
    test module."""

    def __init__(self, arch, n_seqs=2, seq_len=32):
        self.arch = arch
        (self.jcfg, self.tcfg, self.jp, self.tp, _,
         self.jcfg32) = pair(arch)
        tokens = calibration_tokens(self.jcfg.vocab_size, n_seqs=n_seqs,
                                    seq_len=seq_len)
        kw = frontend_bf16(self.jcfg, n_seqs)
        self.jb = {"tokens": jnp.asarray(tokens), **jkw(kw)}
        self.jb32 = {"tokens": jnp.asarray(tokens), **jkw(kw, np.float32)}
        self.tb = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
                   **tkw(kw)}
        self.vg = jax.jit(jax.value_and_grad(jloss_fn(self.jcfg)))
        self.vg32 = jax.jit(jax.value_and_grad(jloss_fn(self.jcfg32)))

    @functools.cached_property
    def jstep(self):
        return jax.jit(jsteps.make_train_step(self.jcfg,
                                              ja.AdamWConfig(**OPT)))

    def reference_grads(self, jp):
        """(loss, grads, per-leaf spread, fp32 grads) of the reference at
        ``jp``."""
        loss, g = self.vg(jp, self.jb)
        g = dict(leaves(g))
        rng = np.random.default_rng(0)
        spread = {k: 0.0 for k in g}
        reversed_rows = {k: v[::-1] for k, v in self.jb.items()}
        for p, batch in [(moved_embedding(jp, rng), self.jb)
                         for _ in range(DRAWS)] + [(jp, reversed_rows)]:
            for k, v in leaves(self.vg(p, batch)[1]):
                spread[k] = max(spread[k], float(np.abs(f64(v) - f64(g[k]))
                                                 .max()))
        _, g32 = self.vg32(widen(jp), self.jb32)
        return float(loss), g, spread, dict(leaves(g32))

    def port_grads(self, tp):
        loss, g = tsteps._value_and_grad(tsteps._loss_fn(self.tcfg), tp,
                                         self.tb)
        return float(loss), g


def grad_report(tloss, tgrads, ref):
    """The grad bars on the port's (loss, grads) against ``ref`` (a
    ``Family.reference_grads`` result). Returns {leaf: (err / bar,
    port RMS / reference RMS, the spread in ulps of the leaf's scale, its
    dtype)}; raises AssertionError naming the first leaf outside a bar."""
    jloss, jg, spread, g32 = ref
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    out = {}
    got = dict(leaves(tgrads))
    assert sorted(got) == sorted(jg)
    for k, t in got.items():
        dtype = str(jg[k].dtype)
        assert str(t.dtype).split(".")[-1] == dtype, (k, t.dtype, dtype)
        j, tt, j32 = f64(jg[k]), f64(t), f64(g32[k])
        bar = SPREAD_X * max(spread[k], ulp_of_scale(j, dtype))
        err = float(np.abs(tt - j).max())
        rms = lambda d: float(np.sqrt(np.mean(d * d)))  # noqa: E731
        ours, theirs = rms(tt - j32), rms(j - j32)
        assert err <= bar, (f"{k}: {err:.4g} > {SPREAD_X} x the reference's "
                            f"spread {spread[k]:.4g} (ulp "
                            f"{ulp_of_scale(j, dtype):.4g}); equal on "
                            f"{np.mean(tt == j):.2%}")
        assert ours <= FARTHER * theirs or k.endswith(ZERO_GRAD), (
            f"{k}: RMS off fp32 {ours:.4g} > {FARTHER} x the reference's "
            f"{theirs:.4g}")
        ulp = ulp_of_scale(j, dtype)
        out[k] = (err / bar if bar else 0.0, ours / theirs if theirs else 1.0,
                  spread[k] / ulp if ulp else 0.0, dtype)
    return out


def summary(report) -> str:
    """The worst leaf of a ``grad_report`` as a share of its bar, the
    largest RMS ratio and the range of the reference's spreads over the
    bf16 leaves (both off the key biases): what the files' docstrings
    quote (``pytest -s`` prints it)."""
    worst = max(report.items(), key=lambda kv: kv[1][0])
    rms = max(((k, v) for k, v in report.items()
               if not k.endswith(ZERO_GRAD)), key=lambda kv: kv[1][1])
    spreads = [v[2] for k, v in report.items()
               if not k.endswith(ZERO_GRAD) and v[3] == "bfloat16"] or [0.0]
    return (f"worst {worst[0]} {worst[1][0]:.2f} of its bar; largest RMS "
            f"ratio {rms[0]} {rms[1][1]:.3f}; spreads {min(spreads):.2f}-"
            f"{max(spreads):.2f} bf16 ulps of a bf16 leaf's scale")


@functools.lru_cache(maxsize=None)
def _jadamw(cfg):
    return jax.jit(lambda p, g, s: ja.adamw_update(p, g, s, cfg))


def assert_adamw_like(tout, jp, jg, js, opt=OPT, what=""):
    """The port's AdamW output ``tout`` (params, state, metrics) against
    the reference's jitted ``adamw_update`` on (``jp``, ``jg``, ``js``):
    the bars of this module's docstring."""
    cfg = ja.AdamWConfig(**opt)
    jnew, jst, jm = _jadamw(cfg)(jp, jg, js)
    tnew, tst, tm = tout
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=f"{what} {k}")
    assert int(tst["step"]) == int(jst["step"])
    for name, atol in (("m", 1e-9), ("v", 1e-12)):
        for (k, a), (_, b) in zip(leaves(tst[name]), leaves(jst[name])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                       atol=atol, err_msg=f"{what} {name} {k}")
    for (k, a), (_, b) in zip(leaves(tnew), leaves(jnew)):
        if str(b.dtype) == "bfloat16":
            assert a.dtype == torch.bfloat16, k
            a16 = a.view(torch.int16).numpy().astype(np.int32)
            b16 = np.asarray(b).view(np.int16).astype(np.int32)
            apart = np.abs(a16 - b16)
            assert apart.max() <= 1, f"{what} {k}: {apart.max()} ulps apart"
            assert np.mean(apart) < ULP_SHARE, (
                f"{what} {k}: one ulp apart on {np.mean(apart):.3%}")
        else:
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{what} {k}")


def moved_share(new, old):
    """{leaf: share of its elements that moved} over the bf16 weight
    matrices (a stacked block leaf of 3 dims or more, a top-level leaf of
    2 or more)."""
    out = {}
    for (k, a), (_, b) in zip(leaves(new), leaves(old)):
        stacked = k.split("/")[0] in ("blocks", "enc_blocks")
        if a.dtype == torch.bfloat16 and a.ndim >= (3 if stacked else 2):
            out[k] = float((a != b).float().mean())
    return out


def state_to_torch(js):
    return {"m": to_torch(js["m"]), "v": to_torch(js["v"]),
            "step": torch.tensor(int(js["step"]), dtype=torch.int32)}


def assert_three_steps_teacher_forced(fam, steps=3, min_moved=0.1):
    """``steps`` steps of the port's ``make_train_step`` at ``OPT``, each
    from the reference's (params, state) after the step before: the step's
    gradients at the grad bars, its update at the AdamW bars against the
    reference's update fed the port's gradients, and at least
    ``min_moved`` of every bf16 weight matrix moved. Returns the grad
    reports."""
    tstep = tsteps.make_train_step(fam.tcfg, ta.AdamWConfig(**OPT))
    jp, js = fam.jp, ja.adamw_init(fam.jp)
    reports = []
    for k in range(steps):
        tp, ts = to_torch(jp), state_to_torch(js)
        tl, tg = fam.port_grads(tp)
        tout = tstep(tp, ts, fam.tb)
        # the gradients held below are the step's own
        again = ta.adamw_update(tp, tg, ts, ta.AdamWConfig(**OPT))
        for (name, a), (_, b) in zip(leaves(tout[0]), leaves(again[0])):
            assert torch.equal(a, b), name
        assert float(tout[2]["loss"]) == tl
        reports.append(grad_report(tl, tg, fam.reference_grads(jp)))
        assert_adamw_like(tout, jp, to_jax(tg), js, what=f"step {k}")
        moved = moved_share(tout[0], tp)
        assert min(moved.values()) >= min_moved, (k, moved)
        jp, js, _ = fam.jstep(jp, js, fam.jb)
    return reports


def assert_accum_within_bars(fam, accum=2):
    """``make_train_step(accum_steps=accum)`` of both packages from the
    reference's state after one step, with b1 = 0 and no clipping (the new
    m is then the step's gradients exactly, f32, in both packages): the
    accumulated gradients (the new m) f32 and at the grad bars, their
    spread and fp32 distance taken through the reference's own accumulating
    step; the update at the AdamW bars against the reference's update fed
    the port's accumulated gradients."""
    opt = dict(OPT, b1=0.0, grad_clip=1e30)
    jstep = jax.jit(jsteps.make_train_step(fam.jcfg, ja.AdamWConfig(**opt),
                                           accum_steps=accum))
    jstep32 = jax.jit(jsteps.make_train_step(fam.jcfg32, ja.AdamWConfig(**opt),
                                             accum_steps=accum))
    jp, js, _ = fam.jstep(fam.jp, ja.adamw_init(fam.jp), fam.jb)
    _, jst, jm = jstep(jp, js, fam.jb)
    rng = np.random.default_rng(0)
    spread = {k: 0.0 for k, _ in leaves(jst["m"])}
    reversed_rows = {k: v[::-1] for k, v in fam.jb.items()}
    for p, batch in [(moved_embedding(jp, rng), fam.jb)
                     for _ in range(DRAWS)] + [(jp, reversed_rows)]:
        _, sm, _ = jstep(p, js, batch)
        for (k, a), (_, b) in zip(leaves(sm["m"]), leaves(jst["m"])):
            spread[k] = max(spread[k], float(np.abs(f64(a) - f64(b)).max()))
    js32 = {"m": js["m"], "v": js["v"], "step": js["step"]}
    _, st32, _ = jstep32(widen(jp), js32, fam.jb32)
    tp = to_torch(jp)
    tout = tsteps.make_train_step(fam.tcfg, ta.AdamWConfig(**opt),
                                  accum_steps=accum)(tp, state_to_torch(js),
                                                     fam.tb)
    tg = tout[1]["m"]
    # the microbatch gradients (bf16 leaves bf16) were summed into f32
    # zeros and divided in f32, as the reference's scan sums them
    rows = fam.tb["tokens"].shape[0] // accum
    parts = [tsteps._value_and_grad(
        tsteps._loss_fn(fam.tcfg), tp,
        {k: v[i * rows:(i + 1) * rows] for k, v in fam.tb.items()})[1]
        for i in range(accum)]
    n = torch.tensor(float(accum))
    for (k, g), *mgs in zip(leaves(tg), *(leaves(p) for p in parts)):
        want = sum((m.float() for _, m in mgs),
                   torch.zeros(g.shape, dtype=torch.float32)) / n
        assert g.dtype == torch.float32 and torch.equal(g, want), k
    ref = (float(jm["loss"]), dict(leaves(jst["m"])), spread,
           dict(leaves(st32["m"])))
    report = grad_report(float(tout[2]["loss"]), tg, ref)
    assert_adamw_like(tout, jp, to_jax(tg), js, opt=opt, what="accum")
    return report


# one Family per arch and process: each test file's tests share its compiles
family = functools.lru_cache(maxsize=None)(Family)
