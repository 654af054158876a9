"""Port parity: AdamW, the schedules, global-norm clipping, the train step,
``train()`` and its CLI (``repro_torch.optim``, ``repro_torch.launch``) vs
the JAX reference, on the same numpy inputs.

Bars:
- the optimizer's arithmetic (``adamw_update``, ``clip_by_global_norm``,
  both schedules): rtol 1e-6 — the port reproduces each f32 operation and
  each double-folded constant of the reference; ``pow``/``cos`` and the
  global norm's sums may part in the last ulp;
- one train step from the same params: loss, ``grad_norm`` and ``lr`` at
  rtol 1e-5, params at atol 1e-5 — except ``blocks/attn/bk``, whose exact
  gradient is 0 (softmax is shift-invariant per query, so a key bias
  moves no score difference): both packages step it on their rounding
  noise, which Adam normalises, so it is held to moving no more than one
  step of the learning rate;
- ``accum_steps=4`` against the full batch: the reference's own bar
  (``tests/test_substrate.py``): loss 1e-4, params rtol 2e-3, atol 2e-4;
- ``train()`` for 10 steps from the same params: per-step losses at rtol
  1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenDataset as JTokenDataset
from repro.data.pipeline import make_pipeline as jmake_pipeline
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import train as jtrain
from repro.models import init_params as jinit_params
from repro.optim import adamw as ja
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, TokenDataset, make_pipeline
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import main as tmain
from repro_torch.launch.train import train as ttrain
from repro_torch.optim import adamw as ta

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
            n_kv_heads=4, max_seq_len=256)   # conftest's tiny_cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_np(tree):
    """(sorted key path, numpy) pairs of a port tree."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append(("/".join(path), t.detach().numpy()))

    walk(tree, ())
    return out


def _rand_tree(rng, scale=1.0):
    # keys deliberately out of sorted order: the global norm must walk them
    # in jax.tree.leaves order
    return {"z": rng.normal(size=(4, 3)).astype(np.float32) * scale,
            "a": {"y": rng.normal(size=(5,)).astype(np.float32) * scale,
                  "b": rng.normal(size=(2, 2, 3)).astype(np.float32) * scale}}


def _to_t(tree):
    return params_from_numpy(tree, device="cpu")


def _close(t_tree, j_tree, rtol, atol=0.0):
    for (k, a), b in zip(_flat_np(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=k)


OPT = dict(lr=1e-2, warmup_steps=10, total_steps=100, min_lr_frac=0.1)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("step", [0, 3, 9, 57, 99, 150])
def test_adamw_update_matches_reference(step, schedule):
    rng = np.random.default_rng(step)
    p, g = _rand_tree(rng), _rand_tree(rng, 0.3)
    m = _rand_tree(rng, 0.01)
    v = jax.tree.map(np.abs, _rand_tree(rng, 0.01))
    jc, tc = ja.AdamWConfig(**OPT), ta.AdamWConfig(**OPT)
    jsched = ja.cosine_schedule(jc) if schedule == "cosine" else ja.linear_warmup(jc)
    tsched = ta.cosine_schedule(tc) if schedule == "cosine" else ta.linear_warmup(tc)
    jp, js, jm = ja.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.int32(step)}, jc, jsched)
    tp_in = _to_t(p)
    tp, ts, tm = ta.adamw_update(
        tp_in, _to_t(g), {"m": _to_t(m), "v": _to_t(v),
                             "step": torch.tensor(step, dtype=torch.int32)},
        tc, tsched)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == step + 1
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    _close(tp, jp, 1e-6, 1e-7)
    _close(ts["m"], js["m"], 1e-6, 1e-9)
    _close(ts["v"], js["v"], 1e-6, 1e-12)
    # the inputs are not modified
    for (k, a), (_, b) in zip(_flat_np(tp_in), _flat_np(_to_t(p))):
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _rand_tree(np.random.default_rng(1), 2.0)
    jg, jn = ja.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = ta.clip_by_global_norm(_to_t(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tg, jg, 1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match_reference_past_total_steps(kind):
    jc, tc = ja.AdamWConfig(**OPT), ta.AdamWConfig(**OPT)
    jf = (ja.cosine_schedule if kind == "cosine" else ja.linear_warmup)(jc)
    tf = (ta.cosine_schedule if kind == "cosine" else ta.linear_warmup)(tc)
    for s in range(0, 131):
        want = float(jf(jnp.int32(s)))
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0.0), s


# the reference's own optimizer checks (tests/test_substrate.py), on the port

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = ta.adamw_init(params)
    cfg = ta.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=1,
                         total_steps=100, grad_clip=10.0)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = ta.adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = ta.clip_by_global_norm(g, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_cosine_schedule_shape():
    cfg = ta.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lr = ta.cosine_schedule(cfg)
    i32 = lambda s: torch.tensor(s, dtype=torch.int32)  # noqa: E731
    assert float(lr(i32(0))) == 0.0
    assert float(lr(i32(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(lr(i32(100))) == pytest.approx(0.1, rel=1e-2)


def test_adamw_init_layout():
    p = _to_t(_rand_tree(np.random.default_rng(0)))
    st = ta.adamw_init(p)
    assert set(st) == {"m", "v", "step"}
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    for (k, a), (_, b) in zip(_flat_np(st["m"]), _flat_np(p)):
        assert a.shape == b.shape and a.dtype == np.float32 and not a.any(), k


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_setup():
    jcfg, tcfg = jget_config("opt-tiny").reduced(**TINY), \
        tget_config("opt-tiny").reduced(**TINY)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                               (8, 32)).astype(np.int32)
    return jcfg, tcfg, jp, tokens


def test_train_step_matches_reference(step_setup):
    jcfg, tcfg, jp, tokens = step_setup
    jo = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jnew, jst, jm = jax.jit(jmake_train_step(jcfg, ja.AdamWConfig(**jo)))(
        jp, ja.adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    # m and v carried across from the reference's state, as the params are
    tstate = {"m": params_from_numpy(_np_tree(ja.adamw_init(jp)["m"]), device="cpu"),
              "v": params_from_numpy(_np_tree(ja.adamw_init(jp)["v"]), device="cpu"),
              "step": torch.tensor(0, dtype=torch.int32)}
    tnew, tst, tm = make_train_step(tcfg, ta.AdamWConfig(**jo))(
        tp, tstate, {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    lr = float(jm["lr"])
    flat_j = dict(zip(["/".join(str(getattr(k, "key", k)) for k in path)
                       for path, _ in jax.tree_util.tree_flatten_with_path(jnew)[0]],
                      jax.tree.leaves(jnew)))
    for k, a in _flat_np(tnew):
        b = np.asarray(flat_j[k])
        if k == "blocks/attn/bk":
            start = np.asarray(jp["blocks"]["attn"]["bk"])
            assert np.abs(a - start).max() <= lr * 1.01
            assert np.abs(b - start).max() <= lr * 1.01
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)
    # the optimizer state moved the same way
    np.testing.assert_allclose(_flat_np(tst["m"])[0][1],
                               np.asarray(jax.tree.leaves(jst["m"])[0]),
                               rtol=1e-4, atol=1e-9)
    assert int(tst["step"]) == int(jst["step"]) == 1


def test_grad_accumulation_matches_full_batch(step_setup):
    """accum_steps=4 gives the full batch's update (the loss is a mean over
    tokens and the microbatches have equal token counts)."""
    _, tcfg, jp, tokens = step_setup
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    ocfg = ta.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    batch = {"tokens": torch.from_numpy(tokens)}
    p1, _, m1 = make_train_step(tcfg, ocfg, accum_steps=1)(tp, ta.adamw_init(tp), batch)
    p4, _, m4 = make_train_step(tcfg, ocfg, accum_steps=4)(tp, ta.adamw_init(tp), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for (k, a), (_, b) in zip(_flat_np(p1), _flat_np(p4)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=k)


def test_ragged_accum_steps_raises_in_both():
    """B % accum_steps != 0: the reference's reshape raises (TypeError); the
    port raises ValueError naming B and accum_steps instead of dropping the
    last rows."""
    jcfg = jget_config("opt-tiny").reduced()
    tcfg = tget_config("opt-tiny").reduced()
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (5, 16)).astype(np.int32)
    with pytest.raises(TypeError):
        jmake_train_step(jcfg, ja.AdamWConfig(), accum_steps=2)(
            jp, ja.adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    step = make_train_step(tcfg, ta.AdamWConfig(), accum_steps=2)
    with pytest.raises(ValueError, match=r"5 rows.*accum_steps=2"):
        step(tp, ta.adamw_init(tp), {"tokens": torch.from_numpy(tokens)})
    # B < accum_steps would have averaged empty microbatches into NaN
    with pytest.raises(ValueError, match=r"1 rows.*accum_steps=2"):
        step(tp, ta.adamw_init(tp), {"tokens": torch.from_numpy(tokens[:1])})


def test_train_matches_reference_for_ten_steps():
    jcfg = jget_config("opt-tiny").reduced(**TINY)
    p0 = _np_tree(jinit_params(jax.random.PRNGKey(3), jcfg))
    kw = dict(steps=10, batch=4, seq=64, lr=1e-3, log_every=1000)
    # the reference's step donates (deletes) the params it is given
    _, jl, _ = jtrain(params=jax.tree.map(jnp.asarray, p0), cfg=jcfg, **kw)
    tp = params_from_numpy(p0, device="cpu")
    _, tl, tcfg = ttrain(params=tp, cfg=tget_config("opt-tiny").reduced(**TINY),
                         device="cpu", **kw)
    assert tcfg.max_seq_len == jcfg.max_seq_len
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_train_cli_trains_resumes_and_writes_reference_checkpoints(tmp_path, capsys):
    from repro.ckpt.checkpoint import restore_checkpoint as jrestore

    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--arch", "opt-tiny", "--batch", "8", "--seq", "64",
            "--ckpt-dir", ck, "--save-every", "10"]
    tmain(argv + ["--steps", "40"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert losses[-1] < losses[0], out
    tmain(argv + ["--steps", "60"])
    assert "[train] resumed from step 40" in capsys.readouterr().out
    steps = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert steps == ["step_00000040", "step_00000050", "step_00000060"]
    assert (tmp_path / "ck" / "step_00000060" / "host0000.npz").exists()
    (params, opt_state), manifest = jrestore(ck)
    assert manifest["step"] == 60 and int(opt_state["step"]) == 60
    assert params["blocks"]["mlp"]["up"].shape == (2, 64, 128)


@pytest.mark.parametrize("text", ["", "hello", "héllo wörld ✓", "a\nb\tc"])
@pytest.mark.parametrize("special", [True, False])
def test_byte_tokenizer_matches_reference(text, special):
    j, t = JByteTokenizer(), ByteTokenizer()
    ids = t.encode(text, add_special=special)
    assert ids == j.encode(text, add_special=special)
    assert t.decode(ids) == j.decode(ids) == text
    assert t.vocab_size == j.vocab_size == 259


@pytest.mark.parametrize("n_tokens,length", [(1000, 64), (40, 64), (64, 64)],
                         ids=["chunked", "padded", "whole"])
def test_token_dataset_samples_equal_reference(n_tokens, length):
    """``TokenDataset`` (exported from ``repro_torch.data``): the same
    samples as the reference's from the same ``rng``, alone and as the
    step-indexed pipeline's source (a corpus shorter than a sequence is
    zero-padded)."""
    corpus = np.random.default_rng(0).integers(0, 512, n_tokens)
    j, t = JTokenDataset(corpus), TokenDataset(corpus)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        a, b = t.sample(rt, length), j.sample(rj, length)
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    cfg = dict(seq_len=length, global_batch=4, vocab_size=512)
    got = make_pipeline(DataConfig(**cfg), source=t)(3)
    want = jmake_pipeline(JDataConfig(**cfg), source=j)(3)
    np.testing.assert_array_equal(got, want)
