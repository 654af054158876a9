"""The helpers of ``chip_smoke.py`` that the CPU reaches.

- Its reading of a profiler trace (``trace_ms``): device time is taken only
  from a complete trace, one in which every named kernel was counted a
  whole multiple of the calls. On the H100, after long traces, the
  profiler drops some kernels' events and would otherwise read low.
- Phase 7's launch-count formula (``base_method_gq_launches``), held to the
  ``group_quant`` calls that ``quantize_model`` makes on the CPU, and its
  card-against-CPU comparisons (``choices_agree``, ``within_one_step``,
  ``parts_only_at_ties``).
- Phase 8's launch-count formula (``search_launches``), held to the kernel
  wrapper calls of ``search.run`` on the CPU, its state-deterministic
  proposal source, its install-mode comparison, and 8f run CPU against CPU.
- Phase 9's parameter bar (``within``), its train-state leaves, 9c's launch
  counts on the bench model's shapes (held to the wrapper calls of a
  ``table1_main`` row on the CPU), and 9d run CPU against CPU.
- Phase 10's reckoning (``dense_param_count`` held to ``init_params``'s
  leaves; Qwen3-4B's parameters, bytes and forward operations), its launch
  formulas at 36 layers and 3 FFN matrices (held to the wrapper calls of a
  gated ``quantize_model`` on the CPU), OmniQuant's parting bar
  (``omni_partings``), and 10d run CPU against CPU for each zoo config.
- Phase 11's reckoning (``moe_param_count`` held to ``init_params``'s
  leaves, the depth cut's 4,165,165,056 analytic params, the forward's
  operations over the E·C slots of the dispatch buffer), its launch
  formulas on Phi-3.5-MoE (held to the wrapper calls of an MoE
  ``quantize_model`` on the CPU), the plain-route oracle's swap of the
  paged-decode kernel, and 11d run CPU against CPU for both MoE configs.
- Phase 12's reckoning, launch formulas and 12d CPU against CPU.
- Phase 13's reckoning (``encdec_param_count`` held to ``init_params``'s
  leaves; SeamlessM4T-medium's and InternVL2-1B's parameters, forward
  operations and cross-cache bytes), its launch formula (held to the
  wrapper calls of ``quantize_model`` with ``forward_kwargs`` on the
  CPU), its greedy oracle, and 13e run CPU against CPU for both configs.
- The bf16 train step's checks (13d, 14e, ``phase_small_bf16``): 14e's
  memory reckoning at 12 of Qwen3-4B's 36 layers against
  ``ModelConfig.param_count``, ``run_train_steps`` on the CPU, the bar the
  card's reduced train steps are held to (the CPU's own spread) refusing
  a step moved one lr the wrong way, and the bf16 checkpoint round trip.
- Phase 15's helpers: ``split_pool``'s per-rank shares of a paged cache,
  whose merged partials equal the whole cache's decode; ``hold_merge``
  refusing a merge that drops one shard's ``l``; ``mapped_matches``
  refusing a history with one accept flipped.
- Phase 16's: 16b (``remat_runs``) on opt-tiny reduced on the CPU — every
  policy bit for bit with remat off, the FLOPs of the real run equal to
  the fake trace's, the peaks within the band (on the CPU the real run's
  peak is the dry run's tracker over real tensors); ``hold_remat``
  falling back to 9d's bars and refusing a step past them;
  ``peak_ratio``'s band; 16c's rows (``launch_rows``) as the checker's
  verdicts, and ``phase_launch_budget`` refusing a wrapper that takes a
  shape the checker flags.
- 2b's launch formula (``table3_main_path_launches``) at Table 3's 1-bit
  and 2-bit group-16 settings, held to the wrapper calls of its pair of
  ``quantize_model`` calls on the CPU.
- 5e's helpers: the batch-wide sampled step's checks and its launch count
  (4 calls of n_layers) on the CPU, the alternating sampled trace, the
  perturbed scores whose argmax is the sampled token, and the near-tie
  rule a parting between two sampled runs is held to
  (``sampled_parting_gap``, ``compare_sampled``), and the recorded run
  (``serve_recording``) whose rows ``check_reach`` holds each sampled
  token to, with its paged-decode calls counted.
- 17's ``check_example`` refusing what the reference's examples would not
  print.
"""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401

# one intra-op thread: at these tiny shapes PyTorch's CPU pool costs more
# than the work, and far more beside the other test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
trace_ms = CS.trace_ms
SPLIT = "void split_decode::split_kernel<float, false, 1, true>"
MERGE = "split_decode::merge_kernel(split_decode::Args)"
NAMES = ("split_decode::split_kernel", "split_decode::merge_kernel")


def _ev(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


@pytest.mark.parametrize("events,want", [
    ([_ev(SPLIT, 20, 300.0), _ev(MERGE, 20, 50.0)], 350.0 / 20 / 1e3),
    ([_ev(SPLIT, 120, 600.0)], 600.0 / 20 / 1e3),          # 6 launches a call
    ([_ev(SPLIT, 20, 300.0), _ev("cudaLaunchKernel", 7, 0.0)], 300.0 / 20 / 1e3),
], ids=["split+merge", "six-a-call", "zero-time-entry"])
def test_a_complete_trace_gives_the_time_per_call(events, want):
    ms, counts, others = trace_ms(events, NAMES, 20)
    assert ms == pytest.approx(want) and others == []
    assert all(n % 20 == 0 for n in counts.values())


@pytest.mark.parametrize("events", [
    [_ev(SPLIT, 16, 1670.0)],                                # dropped events
    [_ev(SPLIT, 20, 300.0), _ev(MERGE, 19, 48.0)],           # one kernel short
    [_ev(SPLIT, 118, 590.0)],                                # 6 a call, 2 lost
    [],                                                      # empty trace
], ids=["dropped", "one-short", "six-a-call-short", "empty"])
def test_an_incomplete_trace_gives_no_time(events):
    ms, counts, _ = trace_ms(events, NAMES, 20)
    assert ms is None
    assert counts == {e.key: e.count for e in events}


def test_other_kernels_are_named_not_timed():
    """A trace with device work under other names only: no time, and the
    names are returned so that the caller can fail on wrong fragments."""
    ms, counts, others = trace_ms([_ev("ampere_sgemm_32x32", 20, 90.0)],
                                  NAMES, 20)
    assert ms is None and counts == {} and others == ["ampere_sgemm_32x32"]


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    from repro_torch.configs import get_config
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    out = {}
    for name, over in (("opt", {}), ("gated-silu", dict(gated_mlp=True,
                                                       activation="silu"))):
        cfg = get_config("opt-tiny").reduced(**over)
        out[name] = (cfg, init_params(cfg, torch.Generator().manual_seed(1),
                                      device="cpu"))
    calib = calibration_tensor(512, n_seqs=2, seq_len=32, device="cpu")
    return out, calib


@pytest.mark.parametrize("search", [False, True], ids=["alone", "search"])
@pytest.mark.parametrize("method", ["rtn", "gptq", "awq", "omniquant"])
@pytest.mark.parametrize("model", ["opt", "gated-silu"])
def test_base_method_launch_formula_counts_the_group_quant_calls(
        tiny_models, monkeypatch, model, method, search):
    """Every ``fake_quant`` reaches ``repro_torch.kernels.group_quant``
    (one launch on the card): count the calls on the CPU."""
    import repro_torch.kernels as kernels
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig

    models, calib = tiny_models
    cfg, params = models[model]
    calls = []
    real = kernels.group_quant

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(kernels, "group_quant", counted)
    scfg = SearchConfig(steps=2, fused_kernel=True, log_every=0) \
        if search else None
    quantize_model(params, cfg, QuantConfig(2, 32), method, calib, scfg,
                   omniquant_steps=2, device="cpu")
    want = CS.base_method_gq_launches(method, cfg)
    assert len(calls) == want
    if method == "awq" and model == "opt":
        assert want == 6 + cfg.n_layers * (20 * 2 + 10 * 6)


def _choice(index, losses):
    from repro_torch.core.awq import GridChoice
    return GridChoice(index, 0.0, list(losses))


def _layer(alpha, clips):
    return {"alpha": alpha, "clip": clips}


def test_choices_agree_passes_equal_picks_and_near_ties():
    cpu = [_layer(_choice(2, [3.0, 2.0, 1.0]),
                  {"up": _choice(0, [1.0, 1.0 + 1e-7, 2.0])})]
    same = [_layer(_choice(2, [3.0, 2.0, 1.0]),
                   {"up": _choice(0, [1.0, 1.0, 2.0])})]
    assert CS.choices_agree(same, cpu) == []
    tie = [_layer(_choice(2, [3.0, 2.0, 1.0]),
                  {"up": _choice(1, [1.0, 1.0, 2.0])})]
    parted = CS.choices_agree(tie, cpu)
    assert [(p["layer"], p["grid"], p["card"], p["cpu"]) for p in parted] == [
        (0, "clip up", 1, 0)]
    assert parted[0]["rel_gap"] == pytest.approx(1e-7)


def test_choices_agree_fails_a_parting_away_from_a_tie():
    cpu = [_layer(_choice(2, [3.0, 2.0, 1.0]), {})]
    card = [_layer(_choice(1, [3.0, 2.0, 1.0]), {})]
    with pytest.raises(AssertionError, match="not a near tie"):
        CS.choices_agree(card, cpu)


def _grid_weights(seed=0, L=2, K=64, N=8):
    """Weights on a 2-bit g32 grid (every group uses levels 0..3)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(L, K, N)).astype(np.float32)
    codes[:, ::32] = 0
    codes[:, 1::32] = 3
    scale = rng.uniform(0.1, 1.0, size=(L, K // 32, 1, N)).astype(np.float32)
    w = (codes.reshape(L, K // 32, 32, N) - 1) * scale
    return torch.from_numpy(w.reshape(L, K, N)), np.repeat(
        scale, 32, axis=2).reshape(L, K, N)


def test_within_one_step_takes_rare_one_step_flips_only():
    w, step = _grid_weights()
    assert CS.within_one_step(w, w, 2, 32) == 0.0
    one = w.clone()
    one[0, 5, 3] += float(step[0, 5, 3])             # one flip in 1024
    assert CS.within_one_step(one, w, 2, 32) == pytest.approx(1 / w.numel())
    two = w.clone()
    two[0, 5, 3] += 2 * float(step[0, 5, 3])
    with pytest.raises(AssertionError, match="more than one step"):
        CS.within_one_step(two, w, 2, 32)
    many = w.clone()
    many[:, 2:10] += torch.from_numpy(step[:, 2:10])
    with pytest.raises(AssertionError, match="step apart"):
        CS.within_one_step(many, w, 2, 32)
    # the GPTQ bar: small drift counts only past atol
    drift = w + 1e-4
    assert CS.within_one_step(drift, w, 2, 32, atol=1e-3) == 0.0


def test_parts_only_at_ties_knows_where_the_ties_are():
    """A group on levels {0, 1, 2} of its scale re-quantizes at 2/3 of
    it: the middle level lands on a round-half tie."""
    s = 0.3
    base = torch.zeros(1, 32, 1)
    base[0, :, 0] = torch.tensor([0.0, s, 2 * s] * 10 + [0.0, 2 * s])
    step = 2 * s / 3
    want = base.clone()
    got = base.clone()
    got[0, 1, 0] += step / 2            # the tie rounds the other way
    assert CS.parts_only_at_ties(got, want, base, 2, 32) == pytest.approx(
        1 / 32)
    off = base.clone()
    off[0, 0, 0] += step                # level 0 is not at a tie
    with pytest.raises(AssertionError, match="away from a round-half tie"):
        CS.parts_only_at_ties(off, want, base, 2, 32)


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_search():
    from repro_torch.configs import get_config
    from repro_torch.core import rtn
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    cfg = get_config("opt-tiny").reduced(n_kv_heads=4)
    qcfg = QuantConfig(2, 32)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    base = rtn.map_quantizable(params, lambda w, p: fake_quant(w, qcfg),
                               only=lambda p: p[-1] not in ("up", "down"))
    calib = calibration_tensor(cfg.vocab_size, n_seqs=2, seq_len=64,
                               device="cpu")
    return cfg, qcfg, params, base, calib


@pytest.mark.parametrize("kw,source", [
    (dict(population=2, fused_kernel=True), None),
    (dict(population=3, fused_kernel=False), None),
    (dict(population=2, islands=2, migrate_every=2, fused_kernel=True,
          shard_calib=True), None),
    (dict(population=2, fused_kernel=True, install="stack"), None),
    (dict(population=2, fused_kernel=True, tabu=16), "state"),
    (dict(population=2, fused_kernel=False, tabu=16), "state"),
    (dict(population=2, fused_kernel=True, tabu=16, temperature=3e-3,
          anneal="constant", steps=16), "state"),
], ids=["fused", "unfused", "islands", "stack", "tabu", "tabu-unfused",
        "tabu-warm"])
def test_search_launch_formula_counts_the_kernel_calls(
        tiny_search, monkeypatch, kw, source):
    """Phase 8's ``search_launches`` against the ``group_quant`` and
    ``transform_quant`` wrapper calls of ``search.run`` on the CPU (one
    launch each on the card), tabu skips and cached accepts included."""
    import repro_torch.kernels as kernels
    from repro_torch.core import invariance as inv
    from repro_torch.core.search import SearchConfig
    from repro_torch.search import run

    cfg, qcfg, params, base, calib = tiny_search
    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    scfg = SearchConfig(log_every=0, seed=0, **{"steps": 8, **kw})
    src = None if source is None else [
        CS.StateProposals(torch, inv, torch.device("cpu"))]
    res = run(params, base, cfg, qcfg, calib, scfg, proposals=src)
    assert calls == CS.search_launches(cfg, scfg, res.stats)
    if source:
        assert res.stats["tabu_skips"] > 0
    if kw.get("temperature"):
        assert res.stats["tabu_rebuilds"] > 0


@pytest.mark.parametrize("kw,source", [
    (dict(population=2, fused_kernel=True), None),
    (dict(population=2, islands=2, migrate_every=2, fused_kernel=True,
          shard_calib=True), None),
    (dict(population=2, fused_kernel=True, tabu=16), "state"),
], ids=["fused", "islands", "tabu"])
def test_search_forwards_counts_the_forwards(tiny_search, monkeypatch, kw,
                                             source):
    """``search_forwards`` against the forwards ``search.run`` makes on the
    CPU: set-up, island baselines on sharded calibration, tabu skips."""
    from repro_torch.core import invariance as inv
    from repro_torch.core.search import SearchConfig
    from repro_torch.search import engine, run

    cfg, qcfg, params, base, calib = tiny_search
    calls = []
    real = engine.forward

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(engine, "forward", counted)
    scfg = SearchConfig(log_every=0, seed=0, **{"steps": 8, **kw})
    src = None if source is None else [
        CS.StateProposals(torch, inv, torch.device("cpu"))]
    res = run(params, base, cfg, qcfg, calib, scfg, proposals=src)
    assert len(calls) == CS.search_forwards(scfg, res.stats)
    if source:
        assert res.stats["tabu_skips"] > 0


def test_attention_launches_follow_the_kernels_route():
    """One ``causal_attention`` launch a decoder self-attention block a
    forward where the model is bf16 with f32 scores and Dh 64 or 128: the
    bf16 Qwen3-4B, Phi-3.5-MoE, SeamlessM4T (its decoder only) and
    InternVL2; none for an f32 model, bf16 scores or Dh 112 (Zamba2), and
    none for Mamba2, which has no attention."""
    import dataclasses

    from repro_torch.configs import get_config

    qwen = get_config("qwen3-4b")
    assert CS.attention_launches(qwen, 34) == 34 * 36
    assert CS.attention_launches(dataclasses.replace(
        qwen, param_dtype="float32", compute_dtype="float32"), 34) == 0
    assert CS.attention_launches(dataclasses.replace(
        qwen, attn_softmax_dtype="bfloat16"), 34) == 0
    assert CS.attention_launches(get_config("opt-1.3b"), 34) == 0
    for arch, blocks in (("phi3.5-moe-42b-a6.6b", 32),
                         ("seamless-m4t-medium", 12), ("internvl2-1b", 24),
                         ("zamba2-7b", 0), ("mamba2-2.7b", 0)):
        cfg = get_config(arch)
        assert CS.attention_launches(cfg, 2) == 2 * blocks, arch


def test_state_proposals_depend_only_on_the_state():
    from repro_torch.core import invariance as inv

    src = CS.StateProposals(torch, inv, torch.device("cpu"))
    t = inv.identity_transform(64, "cpu")
    pcfg = inv.ProposalConfig()
    a, b = src(t, 2, pcfg), src(t, 2, pcfg)
    assert all(torch.equal(x, y) for ca, cb in zip(a, b)
               for x, y in zip(ca, cb))
    assert not torch.equal(a[0].pi, a[1].pi)
    moved = src(a[0], 2, pcfg)
    assert not torch.equal(moved[0].pi, a[0].pi)


def test_histories_identical_falls_back_to_the_install_bar(capsys):
    h = [(0, 5.0, 4.0, 1.0, True), (1, 4.9, 3.9, 1.0, True)]
    assert CS.histories_identical(h, list(h), "same") is True
    near = [h[0], (1, 4.9 + 5e-6, 3.9, 1.0, True)]
    assert CS.histories_identical(near, h, "near") is False
    assert '"first_step": 1' in capsys.readouterr().out
    with pytest.raises(AssertionError, match="step 1"):
        CS.histories_identical([h[0], (1, 4.9, 3.9, 1.0, False)], h, "flag")
    with pytest.raises(AssertionError, match="step 1"):
        CS.histories_identical([h[0], (1, 4.91, 3.9, 1.0, True)], h, "far")


def test_phase_8f_runs_cpu_against_cpu():
    """8f's comparisons and its cached-accept check on the CPU's own data:
    the card's run is held to exactly this yardstick."""
    CS.phase_small_search_engine(torch, devs=("cpu", "cpu"))


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta,ok", [(0.0, True), (1e-4, True), (2e-4, True),
                                      (3e-3, False)])
def test_within_holds_the_accumulation_bar(delta, ok):
    want = [torch.zeros(3), torch.ones(4)]
    got = [torch.full((3,), delta), torch.ones(4) + delta]
    if ok:
        assert CS.within(torch, got, want, what="t", **CS.ACCUM_TOL) == \
            pytest.approx(delta, rel=1e-3)
    else:
        with pytest.raises(AssertionError, match="leaf 0"):
            CS.within(torch, got, want, what="t", **CS.ACCUM_TOL)


def test_state_leaves_cover_params_m_v_and_step():
    from repro_torch.optim.adamw import adamw_init
    params = {"b": {"w": torch.ones(2, 3)}, "a": torch.zeros(4)}
    leaves = CS.state_leaves((params, adamw_init(params)))
    # params, then m, step, v (sorted keys)
    assert [tuple(x.shape) for x in leaves] == [(4,), (2, 3)] * 2 + [()] + \
        [(4,), (2, 3)]


@pytest.mark.parametrize("row", ["rtn", "awq", "awq+invarexplore"])
def test_table1_row_launches_match_the_formula(monkeypatch, row):
    """9c holds each row's launches to ``base_method_gq_launches`` on the
    bench model and 2 x 400 ``transform_quant`` on a +IE row: count the
    wrapper calls of the same ``quantize_model`` on the CPU (the bench
    model's shapes, random weights, 2 search steps)."""
    import repro_torch.kernels as kernels
    from repro_torch.bench.common import BENCH_CFG
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    params = init_params(BENCH_CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    calib = calibration_tensor(BENCH_CFG.vocab_size, 2, 32, device="cpu")
    method, search = row.split("+")[0], "+" in row
    scfg = SearchConfig(steps=2, n_match_layers=4, log_every=0,
                        fused_kernel=True) if search else None
    quantize_model(params, BENCH_CFG, QuantConfig(2, 32), method, calib, scfg,
                   device="cpu")
    assert calls == {"group_quant": CS.base_method_gq_launches(method, BENCH_CFG),
                     "transform_quant": 2 * 2 if search else 0}


def test_phase_9d_runs_cpu_against_cpu():
    CS.phase_small_train(torch, devs=("cpu", "cpu"))


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b", "internlm2-1.8b",
                                  "command-r-35b", "opt-tiny"])
def test_dense_param_count_is_init_params_leaves(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert CS.dense_param_count(cfg) == sum(t.numel() for t in
                                            tree_leaves(params))


def test_qwen3_4b_reckoning():
    """10a's sizes, from the shapes (PERF.md's predictions use them)."""
    from repro_torch.configs import get_config

    cfg = CS.zoo_config(get_config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == (
        36, 2560, 32, 8, 128, 9728, 152064)
    assert cfg.param_dtype == cfg.compute_dtype == "float32"
    assert get_config("qwen3-4b").param_dtype == "bfloat16"
    per_layer = 2 * 2560 * 4096 + 2 * 2560 * 1024 + 3 * 2560 * 9728
    assert CS.matmul_params(cfg) == 36 * per_layer + 2560 * 152064
    assert CS.dense_param_count(cfg) == 4_412_079_616     # 17.6 GB in fp32
    assert CS.matmul_params(cfg) == pytest.approx(4.02e9, rel=1e-3)
    # 2 · 4.02 B · 2048 tokens, and 2 % more for causal attention
    assert CS.forward_flops(cfg, 4, 512) == pytest.approx(16.79e12, rel=1e-3)
    assert CS.ffn_stack_bytes(cfg) == 36 * 3 * 2560 * 9728 * 4


def test_qwen3_4b_launch_formulas():
    """36 layers and 3 FFN matrices: the counts 10a and 10b hold the
    kernels to."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig
    from repro_torch.kernels import ops

    cfg = CS.zoo_config(get_config)
    stats = {"tabu_skips": 0, "tabu_rebuilds": 0}
    assert CS.search_launches(cfg, SearchConfig(steps=16, fused_kernel=True),
                              stats) == {"group_quant": 3,
                                         "transform_quant": 48}
    assert CS.base_method_gq_launches("rtn", cfg) == 7
    assert CS.base_method_gq_launches("awq", cfg) == 7 + 36 * (20 * 3 + 10 * 7)
    assert CS.paged_launches(cfg, 21) == 756
    assert ops.paged_decode_route(cfg.n_heads, cfg.n_kv_heads) == \
        "paged_decode_gqa"
    assert ops.paged_decode_route(cfg.n_heads, cfg.n_kv_heads,
                                  gqa_pages_per_block=2) == \
        "paged_decode_gqa_mp"
    assert [mp for _, _, mp in CS.ZOO_SERVE] == [1, 1, 2]


@pytest.mark.parametrize("method", ["rtn", "awq"])
def test_gated_quantize_launches_match_the_formulas(monkeypatch, method):
    """10a's counts on a gated RoPE model: the ``group_quant`` and
    ``transform_quant`` wrapper calls of ``quantize_model`` with a fused
    search on qwen3-4b reduced."""
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, 2, 32, device="cpu")
    scfg = SearchConfig(steps=3, fused_kernel=True, log_every=0)
    res = quantize_model(params, cfg, QuantConfig(2, 32), method, calib, scfg,
                         device="cpu")
    assert calls == {
        "group_quant": CS.base_method_gq_launches(method, cfg),
        "transform_quant": CS.search_launches(cfg, scfg, res.search.stats)[
            "transform_quant"]} and calls["transform_quant"] == 9


def test_omni_partings_holds_a_parted_layer_by_the_calibration_ce():
    """A layer whose block losses part (an STE near-tie flip) is held by its
    first steps and by the quantized model's calibration CE against the
    yardstick's one-ulp spread; a layer that parts at once, or a model whose
    CE ends far off, fails."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    cfg = get_config("internlm2-1.8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, 2, 32, device="cpu")
    qcfg = QuantConfig(2, 32)
    ref = quantize_model(params, cfg, qcfg, "omniquant", calib, device="cpu")
    losses = ref.base["losses"]

    def run(loss, params_q=ref.params_q):
        return CS.omni_partings(torch, SimpleNamespace(
            params_q=params_q, base={"losses": loss}), ref, params, cfg,
            calib, qcfg)

    assert run(losses.clone()) == {}
    late = losses.clone()
    late[1, 50:] *= 1 + 1e-4
    out = run(late)
    assert out["layers"] == [{"layer": 1, "first_step": 50}]
    assert out["ce"] == out["ce_ref"] and out["bar"] >= 1e-3 * out["ce_ref"]
    early = losses.clone()
    early[0, 2:] *= 1.01
    with pytest.raises(AssertionError, match="first steps"):
        run(early)
    mlp = ref.params_q["blocks"]["mlp"]
    far = {**ref.params_q, "blocks": {**ref.params_q["blocks"], "mlp": {
        **mlp, "down": mlp["down"] * 4}}}
    with pytest.raises(AssertionError, match="calibration CE"):
        run(late, far)


def test_within_one_step_but_spares_only_parted_layers():
    """The weight bar over every layer first; a layer that fails it is
    left to the calibration-CE bar only if OmniQuant's losses parted
    there."""
    want = torch.linspace(-1, 1, 3 * 64 * 8).reshape(3, 64, 8)
    step = float((want[0, :32, 0].max() - want[0, :32, 0].min()) / 3)
    assert CS.within_one_step_but(want.clone(), want, 2, 32, {1}) == (0.0, [])
    off = want.clone()
    off[1] += 3 * step                      # layer 1 three steps away
    frac, spared = CS.within_one_step_but(off, want, 2, 32, {1})
    assert (frac, spared) == (0.0, [1])
    with pytest.raises(AssertionError, match="more than one step"):
        CS.within_one_step_but(off, want, 2, 32, {0})
    with pytest.raises(AssertionError, match="more than one step"):
        CS.within_one_step_but(off, want, 2, 32, set())


@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b", "internlm2-1.8b",
                                  "command-r-35b"])
def test_phase_10d_runs_cpu_against_cpu(arch):
    from repro_torch.kernels import ops
    CS.phase_small_zoo(torch, ops, arch, devs=("cpu", "cpu"))


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "moonshot-v1-16b-a3b"])
def test_moe_param_count_is_init_params_leaves(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import tree_leaves

    for cfg in (get_config(arch).reduced(), CS.small_moe_config(get_config,
                                                                arch)):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert CS.moe_param_count(cfg) == sum(t.numel() for t in
                                              tree_leaves(params))


def test_phi_moe_reckoning():
    """11a's sizes, from the shapes (PERF.md's predictions use them)."""
    from repro_torch.configs import get_config

    cfg = CS.moe_config(get_config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab,
            cfg.moe.num_experts, cfg.moe.top_k) == (
        3, 4096, 32, 8, 128, 6400, 32256, 16, 2)
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"   # its own
    assert get_config("phi3.5-moe-42b-a6.6b").n_layers == 32
    assert cfg.param_count() == 4_165_165_056          # 16.66 GB in fp32
    # LayerNorm: 4 D a block and 2 D for the final norm beside the count
    assert CS.moe_param_count(cfg) == 4_165_165_056 + 3 * 2 * 4096 + 2 * 4096
    assert cfg.moe.capacity(512) == 80
    B, S = 4, 512
    experts = 2 * B * 16 * 80 * 3 * 4096 * 6400   # a layer: 16 x 80 slots a row
    assert experts == pytest.approx(0.805e12, rel=1e-3)
    proj = 2 * B * S * (2 * 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 16)
    assert proj == pytest.approx(0.172e12, rel=1e-2)
    attn = 2 * 2 * B * (S * (S + 1) // 2) * 32 * 128
    head = 2 * B * S * 4096 * 32256
    assert head == pytest.approx(0.541e12, rel=1e-3)
    assert CS.moe_forward_flops(cfg, B, S) == 3 * (experts + proj + attn) \
        + head
    assert CS.moe_forward_flops(cfg, B, S) == pytest.approx(3.50e12, rel=1e-2)
    assert CS.expert_stack_bytes(cfg) == 3 * 16 * 3 * 4096 * 6400 * 4
    assert [s for _, s in CS.moe_gq_shapes(cfg)] == [
        (3 * 4096, 4096), (3 * 4096, 1024), (3 * 4096, 4096),
        (3 * 16 * 4096, 6400), (3 * 16 * 6400, 4096)]


def test_phi_moe_launch_formulas():
    """The counts 11a-11c hold the kernels to: 7 ``group_quant`` a
    quantize call, 3 x 16 ``transform_quant`` a fused search over the L·E
    expert units, both GQA routes, 3 layers a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig
    from repro_torch.kernels import ops

    cfg = CS.moe_config(get_config)
    stats = {"tabu_skips": 0, "tabu_rebuilds": 0}
    assert CS.search_launches(cfg, SearchConfig(steps=16, fused_kernel=True),
                              stats) == {"group_quant": 3,
                                         "transform_quant": 48}
    assert CS.base_method_gq_launches("rtn", cfg) == 7
    assert CS.paged_launches(cfg, 21) == 63
    assert ops.paged_decode_route(cfg.n_heads, cfg.n_kv_heads) == \
        "paged_decode_gqa"
    assert [(sharing, mp) for _, sharing, mp in CS.MOE_SERVE] == [
        (False, 1), (True, 1), (True, 2)]


@pytest.mark.parametrize("search", [False, True], ids=["alone", "search"])
def test_moe_quantize_launches_match_the_formulas(monkeypatch, search):
    """11a's counts on an MoE model: the ``group_quant`` and
    ``transform_quant`` wrapper calls of ``quantize_model`` rtn (with a
    fused search) on phi3.5-moe reduced."""
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, 2, 32, device="cpu")
    scfg = SearchConfig(steps=3, fused_kernel=True, log_every=0) \
        if search else None
    res = quantize_model(params, cfg, QuantConfig(2, 32), "rtn", calib, scfg,
                         device="cpu")
    want_tq = CS.search_launches(cfg, scfg, res.search.stats)[
        "transform_quant"] if search else 0
    assert calls == {"group_quant": CS.base_method_gq_launches("rtn", cfg),
                     "transform_quant": want_tq}
    assert want_tq == (9 if search else 0)


def test_stepwise_oracle_checks_every_step_and_restores_the_route():
    """11b's oracle serves each run again under ``StepCheck`` (every decode
    step computed again through the plain paged decode on cloned pools),
    needs the timed run's tokens back, and puts the decode step back; a
    run whose tokens it does not reproduce fails."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.serving import build_trace
    from repro_torch.serving import decode as dec

    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    params_q = pack_model(init_params(cfg, torch.Generator().manual_seed(3),
                                      device="cpu"), QuantConfig(2, 32))
    reqs = [Request(**t) for t in build_trace(
        cfg.vocab_size, n_tenants=2, per_tenant=2, page_size=8, max_new=3)]
    small = dict(max_batch=4, page_size=8, n_pages=64, max_len=64)
    runs = {}
    for label, sharing, mp in CS.MOE_SERVE:
        outs = PagedServer(params_q, cfg, prefix_cache=sharing,
                           gqa_pages_per_block=mp, device="cpu",
                           **small).generate(reqs)
        runs[label] = dict(outs=outs, sharing=sharing, mp=mp)
    real_step = dec.paged_decode_logits
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(CS, "SERVE", dict(CS.SERVE, **small))
    try:
        oracle = CS.stepwise_oracle(torch, ref, cfg, params_q, "cpu")
        ties, name, peers = oracle(reqs, runs)
        assert dec.paged_decode_logits is real_step
        assert ties == {k: [] for k in runs} and "plain version" in name
        assert peers == {k: k for k in runs}
        bad = dict(runs, on=dict(runs["on"], outs=[o[::-1] for o in
                                                   runs["on"]["outs"]]))
        with pytest.raises(AssertionError, match="timed run"):
            oracle(reqs, bad)
        assert dec.paged_decode_logits is real_step
    finally:
        monkeypatch.undo()


def test_step_check_refuses_a_step_far_from_its_plain_route():
    """``StepCheck`` holds each decode step to the plain route on the same
    inputs: on the CPU the two are one computation (no parting, every
    step and live row counted); a plain route that computes something
    else (attention output 0) is refused."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import BatchedServer, PagedServer, Request
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.serving import build_trace

    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    pq = pack_model(init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu"), QuantConfig(2, 32))
    reqs = [Request(**t) for t in build_trace(
        cfg.vocab_size, n_tenants=2, per_tenant=2, page_size=8, max_new=4)]
    small = dict(max_batch=4, page_size=8, n_pages=64, max_len=64)
    want = PagedServer(pq, cfg, device="cpu", **small).generate(reqs)
    check = CS.StepCheck(torch, ref, cfg)
    with check:
        got = check.watch_paged(PagedServer(pq, cfg, device="cpu",
                                            **small)).generate(reqs)
    assert got == want and check.parted == [] and check.steps > 0
    assert check.rows >= len(reqs) * 3
    on = dataclasses.replace(cfg, use_flash_decode=True)
    check = CS.StepCheck(torch, ref, cfg)
    with check:
        check.watch_batched(BatchedServer(pq, on, batch_size=4, max_len=64,
                                          device="cpu"), cfg).generate(reqs)
    assert check.parted == [] and check.steps == 3
    zero = SimpleNamespace(paged_decode_ref=lambda q, *a, **k:
                           torch.zeros_like(q))
    with pytest.raises(AssertionError, match="not a near tie"):
        with CS.StepCheck(torch, zero, cfg) as check:
            check.watch_paged(PagedServer(pq, cfg, device="cpu",
                                          **small)).generate(reqs)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "moonshot-v1-16b-a3b"])
def test_phase_11d_runs_cpu_against_cpu(arch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = CS.small_moe_config(get_config, arch)
    assert cfg.moe.num_experts == (4 if arch.startswith("phi") else 64)
    CS.phase_small_zoo(torch, ops, arch, devs=("cpu", "cpu"), cfg=cfg)


# ---------------------------------------------------------------------------
# phase 12: the SSM and hybrid families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_param_count_is_init_params_leaves(arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import tree_leaves
    for cfg in (get_config(arch).reduced(),
                dataclasses.replace(get_config(arch).reduced(), n_layers=13)):
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert sum(t.numel() for t in tree_leaves(params)) == \
            CS.ssm_param_count(cfg)


def test_ssm_reckoning():
    """12a's and 12c's models: Mamba2-2.7B at full width and depth in its
    own bf16, 2.83 B params (11.3 GB in fp32) of which the searched Mamba
    stack is 10.07 GB in fp32;
    Zamba2-7B at 13 blocks, (11, 2), 1.29 B params; one forward's
    operations over 4 x 512 tokens."""
    from repro_torch.configs import get_config

    cfg = CS.ssm_config(get_config)
    assert (cfg.n_layers, cfg.d_model, cfg.param_dtype) == (64, 2560,
                                                            "bfloat16")
    assert cfg.param_count() == 2_831_727_616
    assert CS.ssm_param_count(cfg) == 2_831_727_616 + 64 * (5120 + 256) + 2560
    assert CS.mamba_stack_bytes(cfg) == 64 * 3 * 2560 * 5120 * 4
    assert CS.ssm_dims(cfg) == (64, 0, 5120, 80, 128, 128)
    # per block: the quadratic chunk terms over 4 chunks of 128, then the
    # states; 2 per weight per token over the projections and the head
    quad = 2 * 4 * 4 * 128 * 128 * 80 * (128 + 64)
    states = 4 * 4 * 4 * 128 * 80 * 64 * 128 + 2 * 4 * 4 * 80 * 64 * 128
    assert CS.ssd_flops(cfg, 4, 512) == quad + states
    mm = 64 * (2560 * (2 * 5120 + 256 + 80) + 5120 * 2560) + 2560 * 50432
    assert CS.ssm_matmul_params(cfg) == mm
    assert CS.ssm_forward_flops(cfg, 4, 512) == \
        2 * mm * 2048 + 64 * (quad + states)
    hcfg = CS.ssm_config(get_config, "zamba2-7b")
    assert hcfg.n_layers == 13 and hcfg.hybrid_layout() == (11, 2)
    assert hcfg.param_count() == 1_292_582_512
    assert CS.ssm_dims(hcfg) == (11, 2, 7168, 112, 64, 64)
    assert hcfg.resolved_head_dim == 112
    assert ("out_proj stack", (11 * 7168, 3584)) in CS.ssm_gq_shapes(hcfg)


def test_ssm_launch_formulas():
    """12a: 3 ``group_quant`` for RTN, 3 + 3 x 16 with 16 unfused Mamba
    steps; 12c: 10 and 4 + 3 + 3 x 8 + 3 = 34 with 24 ``transform_quant``
    (the shared FFN's 8 fused steps, 3 weights each)."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig

    scfg = SearchConfig(steps=16, fused_kernel=True)
    cfg = CS.ssm_config(get_config)
    assert CS.ssm_quantize_launches(cfg) == {"group_quant": 3,
                                             "transform_quant": 0}
    assert CS.ssm_quantize_launches(cfg, scfg) == {"group_quant": 51,
                                                   "transform_quant": 0}
    hcfg = CS.ssm_config(get_config, "zamba2-7b")
    assert CS.ssm_quantize_launches(hcfg) == {"group_quant": 10,
                                              "transform_quant": 0}
    assert CS.ssm_quantize_launches(hcfg, scfg) == {"group_quant": 34,
                                                    "transform_quant": 24}


@pytest.mark.parametrize("run", ["alone", "unfused", "fused"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_quantize_launches_match_the_formulas(monkeypatch, arch, run):
    """12a's and 12c's counts: the ``group_quant`` and ``transform_quant``
    wrapper calls of ``quantize_model`` rtn (with 5 search steps: an odd
    budget, 2 + 3 in hybrid) on the reduced configs."""
    import warnings

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    search, fused = run != "alone", run == "fused"
    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, 2, 32, device="cpu")
    scfg = SearchConfig(steps=5, fused_kernel=fused, log_every=0) \
        if search else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = quantize_model(params, cfg, QuantConfig(2, 32), "rtn", calib,
                             scfg, device="cpu")
    assert calls == CS.ssm_quantize_launches(cfg, scfg)
    if search:
        CS.phases_monotone(res.search.history, res.search.final_loss, arch)


def test_history_phases_and_the_phase_invariant():
    h = [(0, 5.0, 0, 0, True), (1, 4.0, 0, 0, True), (2, 4.5, 0, 0, False),
         (0, 6.0, 0, 0, True), (1, 5.5, 0, 0, True)]
    assert CS.history_phases(h) == [h[:3], h[3:]]
    CS.phases_monotone(h, 5.5, "ok")
    with pytest.raises(AssertionError, match="last accepted"):
        CS.phases_monotone(h, 4.0, "final")
    bad = h[:2] + [(2, 4.5, 0, 0, True)]
    with pytest.raises(AssertionError, match="did not lower"):
        CS.phases_monotone(bad, 4.5, "bad")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_phase_12d_runs_cpu_against_cpu(arch):
    from repro_torch.kernels import ops
    CS.phase_small_ssm(torch, ops, arch, devs=("cpu", "cpu"))


# ---------------------------------------------------------------------------
# phase 13: the encoder-decoder and vision families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_encdec_param_count_is_init_params_leaves(arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import tree_leaves
    for cfg in (get_config(arch).reduced(),
                dataclasses.replace(get_config(arch).reduced(), n_layers=3,
                                    d_ff=96)):
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert sum(t.numel() for t in tree_leaves(params)) == \
            CS.encdec_param_count(cfg)


def test_encdec_reckoning():
    """13a's and 13c's models at full width and depth, in their own bf16:
    their analytic and tree parameter counts, one forward's operations over
    4 x 512 tokens (Seamless with 4 x 4096 frames), and 13b's cross cache
    (4-byte elements here; ``test_families_bf16_reckoning`` has bf16's)."""
    from repro_torch.configs import get_config

    s = CS.encdec_config(get_config)
    assert (s.n_layers, s.encoder_layers, s.d_model, s.param_dtype) == (
        12, 12, 1024, "bfloat16")
    assert s.param_count() == 910_761_984 and s.padded_vocab == 256256
    # biases (q, k, v, o of 3 attentions; up, down), LayerNorm biases, the
    # final norm: what the analytic count leaves out
    assert CS.encdec_param_count(s) == 911_085_568
    D, F, L, T, S, B = 1024, 4096, 12, 4096, 512, 4
    enc = 2 * B * T * L * (4 * D * D + 2 * D * F) + 4 * L * B * T * T * D
    cross = L * (2 * B * S * 2 * D * D + 2 * B * T * 2 * D * D
                 + 4 * B * S * T * D)
    dec = 2 * (L * (4 * D * D + 2 * D * F) + D * 256256) * B * S \
        + 4 * L * B * (S * (S + 1) // 2) * D
    assert CS.encdec_forward_flops(s, B, S, T) == enc + cross + dec
    assert CS.cross_cache_bytes(s, 8, T) == 2 * L * 8 * T * 16 * 64 * 4
    v = CS.encdec_config(get_config, "internvl2-1b")
    assert v.param_count() == 493_889_536 and v.padded_vocab == 151808
    assert CS.encdec_param_count(v) == CS.dense_param_count(v) == 493_918_080
    assert v.n_heads // v.n_kv_heads == 7 and v.tie_embeddings
    assert CS.encdec_forward_flops(v, 4, 512) == CS.forward_flops(v, 4, 512)
    assert [s for _, s in CS.encdec_gq_shapes(s)] == [
        (12 * 1024, 1024), (12 * 1024, 4096), (12 * 4096, 1024)]
    assert [s for _, s in CS.encdec_gq_shapes(v)] == [
        (24 * 896, 896), (24 * 896, 128), (24 * 896, 4864), (24 * 4864, 896)]


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_encdec_gq_shapes_are_the_quantizable_leaves(arch):
    """``encdec_gq_shapes`` names each shape ``fake_quant`` gives
    ``group_quant`` over the quantizable leaves, and no other."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.rtn import get_by_path
    from repro_torch.models.model import init_params, quantizable_paths
    cfg = get_config(arch).reduced()
    if cfg.is_enc_dec:   # an encoder as deep as the decoder hides its shapes
        cfg = dataclasses.replace(cfg, encoder_layers=cfg.n_layers + 1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = {(w.numel() // w.shape[-1], w.shape[-1])
              for w in (get_by_path(params, p)
                        for p in quantizable_paths(params))}
    assert {s for _, s in CS.encdec_gq_shapes(cfg)} == leaves


def test_encdec_launch_formulas():
    """13a: RTN freezes 12 attention stacks (decoder, cross, encoder) and
    quantizes 4 FFN stacks; with the search the encoder FFN is left alone:
    12 + 2 ``group_quant`` and 2 x 16 ``transform_quant``. 13c (InternVL2,
    gated): RTN 7, AWQ 7 + 24 x 130."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig

    s = CS.encdec_config(get_config)
    none = {"tabu_skips": 0, "tabu_rebuilds": 0}
    assert CS.encdec_quantize_launches(s) == {"group_quant": 16,
                                              "transform_quant": 0}
    assert CS.encdec_quantize_launches(
        s, SearchConfig(steps=16, fused_kernel=True), none) == {
            "group_quant": 14, "transform_quant": 32}
    v = CS.encdec_config(get_config, "internvl2-1b")
    assert CS.encdec_quantize_launches(v) == {"group_quant": 7,
                                              "transform_quant": 0}
    assert CS.base_method_gq_launches("rtn", v) == 7
    assert CS.base_method_gq_launches("awq", v) == 7 + 24 * 130


@pytest.mark.parametrize("run", ["alone", "unfused", "fused"])
def test_encdec_quantize_launches_match_the_formulas(monkeypatch, run):
    """13a's counts: the wrapper calls of ``quantize_model`` rtn with the
    frames through ``forward_kwargs`` (and 3 search steps) on the reduced
    Seamless."""
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    cfg = get_config("seamless-m4t-medium").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, 2, 16, device="cpu")
    kw = CS.frontend_kw(torch, cfg, 2, seed=1, device="cpu")
    scfg = None if run == "alone" else SearchConfig(
        steps=3, fused_kernel=run == "fused", log_every=0)
    res = quantize_model(params, cfg, QuantConfig(2, 32), "rtn", calib, scfg,
                         forward_kwargs=kw, device="cpu")
    stats = res.search.stats if res.search else None
    assert calls == CS.encdec_quantize_launches(cfg, scfg, stats)


def test_check_greedy_with_a_frontend_takes_the_oracles_tokens_and_refuses_others():
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_params

    cfg = get_config("internvl2-1b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = CS.frontend_kw(torch, cfg, 2, seed=1, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(2))
    seq = toks
    for _ in range(4):
        logits = forward(params, cfg, seq, **kw)[:, -1, :cfg.vocab_size]
        seq = torch.cat([seq, logits.argmax(-1)[:, None]], dim=1)
    reqs = [SimpleNamespace(prompt=p) for p in toks.tolist()]
    gen = seq[:, 5:].tolist()
    assert CS.check_greedy(torch, forward, params, cfg, reqs, gen, "ok",
                           kw=kw, device="cpu") == []
    bad = [list(g) for g in gen]
    bad[1][2] = (bad[1][2] + 1) % cfg.vocab_size
    with pytest.raises(AssertionError, match="request 1 token 2"):
        CS.check_greedy(torch, forward, params, cfg, reqs, bad, "bad",
                        kw=kw, device="cpu")


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_phase_13e_runs_cpu_against_cpu(arch):
    from repro_torch.kernels import ops
    CS.phase_small_encdec(torch, ops, arch, devs=("cpu", "cpu"))


def test_qwen3_4b_bf16_reckoning():
    """14's sizes in the config's own bf16, from the shapes (PERF.md's
    predictions use them), and phase 10's fp32 depth cut."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-4b")
    assert cfg.param_dtype == cfg.compute_dtype == "bfloat16"
    assert CS.dense_param_count(cfg) * 2 == 8_824_159_232       # 8.82 GB
    assert CS.ffn_stack_bytes(cfg, 2) == 5_379_194_880          # 5.38 GB
    assert [s for _, s in CS.encdec_gq_shapes(cfg)] == [
        (36 * 2560, 4096), (36 * 2560, 1024), (36 * 4096, 2560),
        (36 * 2560, 9728), (36 * 9728, 2560)]
    for K, N in ((2560, 9728), (9728, 2560)):
        nbytes = CS.tq_bytes(K, N, 32, 9728, 2)
        assert nbytes == 2 * K * N * 2 + 2 * (K // 32) * N * 4 + 9728 * 16
        bound, by = CS.bound_ms(nbytes, CS.TQ_OPS * K * N)
        assert by == "bytes" and bound == pytest.approx(0.0316, abs=1e-4)
    assert CS.gq_bytes(92160, 9728, 32, 2) == 2 * 92160 * 9728 * 2 \
        + 2 * 2880 * 9728 * 4
    assert CS.zoo_config(get_config).n_layers == 36
    assert CS.zoo_config(get_config, n_layers=CS.ZOO_FP32_LAYERS).n_layers \
        == 4


def test_qwen3_4b_bf16_launch_formulas():
    """The counts 14b and 14d hold the kernels to: the bf16 model launches
    what the fp32 one does (fake_quant and the fused lane go through the
    same kernels in either dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig

    cfg = get_config("qwen3-4b")
    stats = {"tabu_skips": 0, "tabu_rebuilds": 0}
    assert CS.search_launches(cfg, SearchConfig(steps=16, fused_kernel=True),
                              stats) == {"group_quant": 3,
                                         "transform_quant": 48}
    assert CS.base_method_gq_launches("rtn", cfg) == 7
    assert CS.base_method_gq_launches("awq", cfg) == 4687
    assert CS.paged_launches(cfg, 21) == 756


def test_bf16_oracle_weights_and_near_tie():
    """A bf16 model's greedy oracle runs on bf16 weights, and its near tie
    is wider than an fp32 model's."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model

    cfg = get_config("qwen3-4b").reduced(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    assert CS.near_tie(cfg) == 2.0 ** -5
    assert CS.near_tie(get_config("qwen3-4b").reduced()) == CS.NEAR_TIE

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dense = CS.oracle_weights(pack_model(params, QuantConfig(2, 32)), cfg)
    assert dense["blocks"]["mlp"]["up"].dtype == torch.bfloat16
    assert dense["blocks"]["ln1"]["w"].dtype == torch.bfloat16


def test_check_greedy_lists_every_near_tie_of_a_request(monkeypatch):
    """After a near tie a request is still held, token by token, to the
    oracle after its own tokens: every tie is listed (so ``compare_runs``
    finds the first parting of two runs among them), and a later token
    off the oracle without a tie still fails."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_params

    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = [3, 1, 4, 1, 5]
    seq = torch.tensor([prompt])
    for _ in range(5):
        logits = forward(params, cfg, seq)[:, -1, :cfg.vocab_size]
        seq = torch.cat([seq, logits.argmax(-1)[:, None]], dim=1)
    out = seq[0, 5:].tolist()
    out[4] = (out[4] + 1) % cfg.vocab_size     # the last token: no later one
    out[1] = (out[1] + 1) % cfg.vocab_size     # moves the oracle after it
    reqs = [SimpleNamespace(prompt=prompt)]
    monkeypatch.setattr(CS, "near_tie", lambda c: float("inf"))
    ties = CS.check_greedy(torch, forward, params, cfg, reqs, [out], "t",
                           device="cpu")
    assert [(i, j) for i, j, _ in ties][:1] == [(0, 1)]
    assert (0, 4) in [(i, j) for i, j, _ in ties]
    monkeypatch.setattr(CS, "near_tie", lambda c: 0.0)
    with pytest.raises(AssertionError, match="request 0 token 1"):
        CS.check_greedy(torch, forward, params, cfg, reqs, [out], "t",
                        device="cpu")


def test_check_greedy_excuses_only_a_token_near_the_top(monkeypatch):
    """A token off the oracle is excused where its own oracle logit is
    within the bar of the top (the runner-up at a near tie), not wherever
    the oracle's top-2 gap is under the bar: at the bar halfway between
    the top-2 gap and the lowest token's gap, the runner-up passes and the
    lowest token fails."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_params

    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = [3, 1, 4, 1, 5]
    seq = torch.tensor([prompt])
    for _ in range(5):
        logits = forward(params, cfg, seq)[:, -1, :cfg.vocab_size]
        seq = torch.cat([seq, logits.argmax(-1)[:, None]], dim=1)
    last = logits[0]                          # the oracle at the last token
    order = torch.argsort(last, descending=True)
    top = float(last[order[0]])
    gap2 = (top - float(last[order[1]])) / abs(top)
    gap_low = (top - float(last[order[-1]])) / abs(top)
    bar = (gap2 + gap_low) / 2
    reqs = [SimpleNamespace(prompt=prompt)]
    out = seq[0, 5:].tolist()
    monkeypatch.setattr(CS, "near_tie", lambda c: bar)
    out[4] = int(order[1])
    ties = CS.check_greedy(torch, forward, params, cfg, reqs, [out], "t",
                           device="cpu")
    assert [(i, j) for i, j, _ in ties] == [(0, 4)]
    assert ties[0][2] == pytest.approx(gap2, rel=1e-5)
    out[4] = int(order[-1])
    with pytest.raises(AssertionError, match="request 0 token 4"):
        CS.check_greedy(torch, forward, params, cfg, reqs, [out], "t",
                        device="cpu")


# ---------------------------------------------------------------------------
# phases 11-13 in the configs' own bf16
# ---------------------------------------------------------------------------

def test_phi_moe_bf16_reckoning():
    """11's Phi-3.5-MoE in bf16 (PERF.md's predictions use these): params
    and expert-stack bytes, the shapes ``group_quant`` (bf16,
    ``round_range``) and ``transform_quant`` (one expert) take with their
    bounds, the decode layout of the GQA routes and ``flash_decode``; the
    launch counts are fp32's (the same kernels in either dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig

    cfg = CS.moe_config(get_config)
    assert CS.own_dtype_kw(torch, cfg) == dict(dtype=torch.bfloat16,
                                               round_range=True)
    assert CS.moe_param_count(cfg) * 2 == 8_330_395_648       # 8.33 GB
    assert CS.expert_stack_bytes(cfg, 2) == 7_549_747_200     # 7.55 GB
    assert dict(CS.moe_gq_shapes(cfg))["experts up/gate"] == (196608, 6400)
    assert CS.gq_bytes(196608, 6400, 32, 2) == 2 * 196608 * 6400 * 2 \
        + 2 * 6144 * 6400 * 4
    for K, N in ((4096, 6400), (6400, 4096)):
        nbytes = CS.tq_bytes(K, N, 32, 6400, 2)
        assert nbytes == 2 * K * N * 2 + 2 * (K // 32) * N * 4 + 6400 * 16
        bound, by = CS.bound_ms(nbytes, CS.TQ_OPS * K * N)
        assert by == "bytes" and bound == pytest.approx(0.0333, abs=1e-4)
    stats = {"tabu_skips": 0, "tabu_rebuilds": 0}
    assert CS.search_launches(cfg, SearchConfig(steps=16, fused_kernel=True),
                              stats) == {"group_quant": 3,
                                         "transform_quant": 48}
    assert CS.base_method_gq_launches("rtn", cfg) == 7
    assert CS.paged_launches(cfg, 21) == 63
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (32, 8, 128)


def test_ssm_bf16_reckoning():
    """12's models in bf16: Mamba2-2.7B 5.66 GB of params, its searched
    Mamba stack 5.03 GB; Zamba2-7B at 13 blocks 2.59 GB, the shared FFN
    (3584, 14336) ``transform_quant`` takes, ``flash_decode`` at Dh 112;
    launch counts as in fp32."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig

    cfg = CS.ssm_config(get_config)
    assert CS.ssm_param_count(cfg) * 2 == 5_664_148_480
    assert CS.mamba_stack_bytes(cfg, 2) == 5_033_164_800
    assert dict(CS.ssm_gq_shapes(cfg))["w_z/w_x stack"] == (163840, 5120)
    hcfg = CS.ssm_config(get_config, "zamba2-7b")
    assert hcfg.param_dtype == hcfg.compute_dtype == "bfloat16"
    assert CS.ssm_param_count(hcfg) * 2 == 2_585_332_704
    assert (hcfg.d_model, hcfg.d_ff) == (3584, 14336)
    nbytes = CS.tq_bytes(3584, 14336, 32, 14336, 2)
    bound, by = CS.bound_ms(nbytes, CS.TQ_OPS * 3584 * 14336)
    assert by == "bytes" and bound == pytest.approx(0.0653, abs=1e-4)
    assert (hcfg.n_heads, hcfg.n_kv_heads, hcfg.resolved_head_dim) == \
        (32, 32, 112)
    scfg = SearchConfig(steps=16, fused_kernel=True)
    assert CS.ssm_quantize_launches(cfg, scfg) == {"group_quant": 51,
                                                   "transform_quant": 0}
    assert CS.ssm_quantize_launches(hcfg, scfg) == {"group_quant": 34,
                                                    "transform_quant": 24}


def test_encdec_bf16_reckoning():
    """13's models in bf16: Seamless 1.82 GB of params, its cross cache at
    B 8 x 4096 frames 1.61 GB, its decoder FFN (1024, 4096) and
    InternVL2's (896, 4864) for ``transform_quant``, the decode layouts
    (16/16 x 64, 14/2 x 64); launch counts as in fp32."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig

    s = CS.encdec_config(get_config)
    v = CS.encdec_config(get_config, "internvl2-1b")
    assert CS.encdec_param_count(s) * 2 == 1_822_171_136
    assert CS.encdec_param_count(v) * 2 == 987_836_160
    assert CS.cross_cache_bytes(s, 8, 4096, 2) == 1_610_612_736
    for c, (D, F) in ((s, (1024, 4096)), (v, (896, 4864))):
        assert (c.d_model, c.d_ff) == (D, F)
        for K, N in ((D, F), (F, D)):
            nbytes = CS.tq_bytes(K, N, 32, F, 2)
            assert nbytes == 2 * K * N * 2 + 2 * (K // 32) * N * 4 + F * 16
    assert (s.n_heads, s.n_kv_heads, s.resolved_head_dim) == (16, 16, 64)
    assert (v.n_heads, v.n_kv_heads, v.resolved_head_dim) == (14, 2, 64)
    scfg = SearchConfig(steps=16, fused_kernel=True)
    stats = {"tabu_skips": 0, "tabu_rebuilds": 0}
    assert CS.encdec_quantize_launches(s) == {"group_quant": 16,
                                              "transform_quant": 0}
    assert CS.encdec_quantize_launches(s, scfg, stats) == {
        "group_quant": 14, "transform_quant": 32}
    assert CS.search_launches(v, scfg, stats) == {"group_quant": 3,
                                                  "transform_quant": 48}


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                                  "zamba2-7b", "seamless-m4t-medium",
                                  "internvl2-1b"])
def test_phase_small_bf16_runs_cpu_against_cpu(arch):
    from repro_torch.kernels import ops
    CS.phase_small_bf16(torch, ops, arch, devs=("cpu", "cpu"))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_family_accepts_runs_on_the_cpu(arch, capsys):
    """The accept comparison's plumbing at the reduced size: both runs take
    STEPS steps from one proposal stream (one per phase of the hybrid)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops

    cfg = get_config(arch).reduced(param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    kw = CS.frontend_kw(torch, cfg, 4, seed=1, device="cpu") \
        if cfg.is_enc_dec else None
    n = CS.family_accepts(torch, ops, cfg, QuantConfig(2, 32), kw=kw,
                          device="cpu")
    line = json.loads(capsys.readouterr().out.split(
        "bf16_vs_fp32_accepts: ")[1].splitlines()[0])
    assert line["differing"] == n == len(line["differ_at"])
    assert len(line["bf16_accepts"]) == len(line["fp32_accepts"]) == CS.STEPS


def test_step_check_excuses_a_router_tie_only_near_the_top():
    """A token off the plain step's argmax passes at a near tie of the
    logits, or at a router near tie (margin <= ROUTER_TIE_ULPS) within
    ROUTER_TIE_GAP of the top; farther, or at a wider margin, it fails;
    ``counts()`` reports the rows at a router tie and the rule's reach."""
    cfg = SimpleNamespace(vocab_size=4, compute_dtype="bfloat16", name="t")
    plain = torch.tensor([[10.0, 9.99, 7.0, 2.0]] * 3)
    got = torch.tensor([[0.0, 1.0, 0.0, 0.0],      # the runner-up: a tie
                        [0.0, 0.0, 1.0, 0.0],      # gap 0.3
                        [10.0, 0.0, 0.0, 0.0]])    # the argmax
    check = CS.StepCheck(torch, None, cfg)
    check._hold(got, plain, torch.tensor([9.0, 1.0, 0.0]), range(3))
    assert [(s, i) for s, i, _, _ in check.parted] == [(0, 0), (0, 1)]
    c = check.counts()
    assert (c["rows"], c["router_tie_rows"], c["top2_under_near_tie"]) == \
        (3, 2, 3)
    assert c["vocab_share_within_router_gap"] == pytest.approx(0.75)
    with pytest.raises(AssertionError, match="not a near tie"):
        check._hold(got, plain, torch.tensor([9.0, 3.0, 0.0]), range(3))
    far = torch.tensor([[0.0, 0.0, 0.0, 1.0]])     # gap 0.8
    with pytest.raises(AssertionError, match="not a near tie"):
        CS.StepCheck(torch, None, cfg)._hold(far, plain[:1],
                                             torch.tensor([0.0]), [0])


def _served_zamba2():
    """Zamba2 reduced in bf16, RTN-packed, and one BatchedServer batch of
    4 requests run keeping its logits."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.serving import build_trace

    cfg = get_config("zamba2-7b").reduced(param_dtype="bfloat16",
                                          compute_dtype="bfloat16")
    pq = pack_model(init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu"), QuantConfig(2, 32))
    reqs = [Request(**t) for t in build_trace(
        cfg.vocab_size, n_tenants=2, per_tenant=2, page_size=8, max_new=5)]
    server = BatchedServer(pq, cfg, batch_size=4, max_len=64, device="cpu")
    outs = server.generate(reqs)
    got, served = CS.generate_with_logits(torch, server, reqs)
    return cfg, pq, reqs, outs, got, served


def test_served_logits_are_the_servers_own():
    """``generate_with_logits`` serves the tokens ``generate`` serves, each
    the argmax of its kept row, and leaves the server as it was."""
    cfg, _, reqs, outs, got, served = _served_zamba2()
    assert got == outs
    assert served.shape == (4, 5, cfg.vocab_size)
    assert served.argmax(-1).tolist() == outs


def test_hold_served_logits_refuses_a_step_that_computes_something_else(
        capsys):
    """The served logits of a bf16 hybrid stack pass against the full
    forward at twice its spread (``embed_moved``: the embedding's
    elements moved by one ulp, SPREAD_FRAC of them or all), and the bar
    refuses the off-by-one control; served rows one position late, or a
    row of another request, fail."""
    from repro_torch.models.model import forward

    cfg, pq, reqs, outs, _, served = _served_zamba2()
    dense = CS.oracle_weights(pq, cfg)
    moved = CS.embed_moved(torch, dense, 0)["embed"]["tok"]
    apart = moved != dense["embed"]["tok"]
    assert 0 < float(apart.float().mean()) < 3 * CS.SPREAD_FRAC
    assert torch.all((moved.float() - dense["embed"]["tok"].float()).abs()[
        apart] <= dense["embed"]["tok"].float().abs()[apart] * 2 ** -7)
    tok = dense["embed"]["tok"]
    every = CS.embed_moved(torch, dense, 0, CS.SERVED_SPREAD_FRAC)
    assert torch.equal(every["embed"]["tok"] != tok, tok != 0)
    padded = CS.padded_requests(type(reqs[0]), reqs, 4)
    largest, bar = CS.hold_served_logits(torch, forward, dense, cfg, padded,
                                         outs, served, "t", device="cpu")
    line = json.loads(capsys.readouterr().out.split(
        "served_logits_oracle: ")[1])
    assert largest <= bar == CS.SERVED_SPREADS * line["spread"]
    assert line["control_over_bar"] >= CS.POWER_SHARE
    late = torch.cat([served[:, :1], served[:, :-1]], 1)
    with pytest.raises(AssertionError, match="served rows farther"):
        CS.hold_served_logits(torch, forward, dense, cfg, padded, outs, late,
                              "t", device="cpu")
    other = served.clone()
    other[0, 2] = served[3, 2]
    with pytest.raises(AssertionError, match="served rows farther"):
        CS.hold_served_logits(torch, forward, dense, cfg, padded, outs, other,
                              "t", device="cpu")


def test_phase_small_bf16_train_and_ckpt_roundtrip_cpu(tmp_path, capsys):
    """Phase 14's reduced Qwen3-4B case CPU against CPU: the 3 bf16 train
    steps (each within every bar: the same device reads 0) and the train
    state through both checkpoint formats, bf16 params and f32 m / v back
    bit for bit."""
    from repro_torch.kernels import ops
    CS.phase_small_bf16(torch, ops, "qwen3-4b", devs=("cpu", "cpu"),
                        ckpt_dir=tmp_path / "ck")
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("small_bf16: ")][-1]
    row = json.loads(line.split(": ", 1)[1])
    assert row["ckpt_roundtrip_dtypes"] == ["bfloat16", "float32", "int32"]
    assert len(row["train_worst_share_of_bar"]) == CS.SMALL_TRAIN["steps"]
    assert all(v == 0.0 for r in row["train_worst_share_of_bar"]
               for v in r.values())
    assert not (tmp_path / "ck").exists()


def test_train_step_bar_refuses_a_step_moved_one_lr_the_wrong_way():
    """The bar ``phase_small_bf16`` holds the card's train steps to (the
    CPU port's own spread, ``train_step_spread``) has power: the same step
    with every param's update reversed (each element moved about one lr
    the wrong way from where it started) is refused, while the step
    itself passes."""
    from repro_torch.configs import get_config
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map

    cfg = get_config("qwen3-4b").reduced(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    batch = {"tokens": calibration_tensor(cfg.vocab_size, n_seqs=2,
                                          seq_len=32, seed=11, device="cpu")}
    step = make_train_step(cfg, AdamWConfig(lr=CS.SMALL_TRAIN["lr"],
                                            warmup_steps=1, total_steps=100))
    state = adamw_init(params)
    cpu = torch.device("cpu")
    want = CS.small_train_step(torch, step, params, state, batch, cpu)
    spread = CS.train_step_spread(torch, step, params, state, batch, want, cpu)
    CS.hold_train_step(torch, want, want, spread, "the step itself")
    wrong = tree_map(lambda new, old: (2 * old.float() - new.float()).to(
        new.dtype), want[0], params)
    with pytest.raises(AssertionError, match="param leaf"):
        CS.hold_train_step(torch, (wrong,) + want[1:], want, spread,
                           "reversed")


def test_train_reckoning_of_the_14e_cut():
    """14e's memory reckoning at 12 of Qwen3-4B's 36 layers, from
    ``ModelConfig.param_count``: 1,989,734,400 parameters (the port's tree
    adds the final norm and the q / k norms, 5,632), 24 B each in the
    out-of-place bf16 step (47.8 GB), 57.1 GB with the temporaries and the
    logits at B 4 x 512: within one card, where the full 36 layers' state
    alone (105.9 GB) is not. The optimizer's bytes: 28 a bf16 element, 40
    an f32 one."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("qwen3-4b")
    cut = dataclasses.replace(full, n_layers=CS.TRAIN14["layers"])
    r = CS.train_reckoning(cut, CS.TRAIN14["batch"], CS.TRAIN14["seq"])
    assert r["n_params"] == cut.param_count() == 1_989_734_400
    assert CS.dense_param_count(cut) - cut.param_count() == \
        cut.d_model + 2 * cut.n_layers * cut.resolved_head_dim
    assert r["bytes_per_param"] == 24
    assert r["state_bytes"] == 24 * cut.param_count()
    assert r["total_bytes"] == 57_096_437_760 < CS.CARD_BYTES
    assert CS.train_reckoning(full, 4, 512)["state_bytes"] > CS.CARD_BYTES
    tree = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(5)}}
    assert CS.optimizer_bytes(tree) == 12 * 28 + 5 * 40


@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-1b"])
def test_run_train_steps_runs_on_the_cpu(arch):
    """13d's and 14e's train run (``run_train_steps``) at the reduced size
    in bf16 on the CPU: four finite losses (at 2 x 32 tokens of a 512-token
    vocabulary the batches' spread hides any fall), every step moving bf16
    elements, and the row's arithmetic (the timings and peak are the
    card's)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced(param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    kw = CS.frontend_kw(torch, cfg, 2, seed=6, device="cpu") \
        if cfg.frontend == "vision" else {}
    row = CS.run_train_steps(torch, cfg, 2, 32, 4, 1e-3, kw, seed=200,
                             device="cpu")
    assert len(row["losses"]) == 4
    assert min(row["bf16_moved_share"]) > 0.1
    assert row["n_params"] - row["n_params_analytic"] < 0.01 * row["n_params"]
    assert row["optimizer_bytes"] == 28 * row["n_params"]   # all bf16
    assert row["peak_bytes"] is None and row["optimizer_queued_ms"] is None


def _cpu_paged_case(B=4, H=4, Hkv=2, Dh=8, P=6, psz=4, lens=(24, 11, 1, 0),
                    seed=3):
    g = torch.Generator().manual_seed(seed)
    n = B * P + 1
    q = torch.randn((B, H, Dh), generator=g)
    kp = torch.randn((n, psz, Hkv, Dh), generator=g)
    vp = torch.randn((n, psz, Hkv, Dh), generator=g)
    bt = (torch.randperm(n - 1, generator=g)[: B * P] + 1).reshape(B, P).int()
    return [q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32), None, None]


def _shard_partials(case, n, psz=4):
    from repro_torch.kernels import ops
    parts = [ops.paged_decode(*CS.split_pool(torch, case, n, r, psz=psz)[:5],
                              normalize=False) for r in range(n)]
    return [torch.stack(x) for x in zip(*parts)]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_pool_shares_merge_to_the_whole_cache(n):
    """15b's per-rank pools: rank r holds pages [r·P/n, (r+1)·P/n) of every
    sequence (local lengths clamped to its share, so a sequence can leave a
    shard empty), and the merge of the shards' partials is the decode of
    the whole cache."""
    from repro_torch.kernels import ops, ref
    case = _cpu_paged_case()
    whole = ops.paged_decode(*case)
    shares = [CS.split_pool(torch, case, n, r, psz=4) for r in range(n)]
    per = 6 // n
    for r, sh in enumerate(shares):
        assert sh[1].shape[0] == 4 * per + 1 and sh[3].shape == (4, per)
        want = (case[4] - r * per * 4).clamp(0, per * 4)
        assert torch.equal(sh[4], want.int())
        for b in range(4):   # the rank's pages hold the whole cache's rows
            for p in range(per):
                assert torch.equal(sh[1][sh[3][b, p]],
                                   case[1][case[3][b, r * per + p]])
    if n > 1:
        assert any(int(sh[4][2]) == 0 for sh in shares)   # an empty shard
    acc, m, l = _shard_partials(case, n)  # noqa: E741
    got = ref.merge_partials(acc, m, l)
    assert CS.hold_merge(torch, got, whole, "merge") <= 1e-6


def test_hold_merge_refuses_a_merge_that_drops_a_shards_l():
    from repro_torch.kernels import ops, ref
    case = _cpu_paged_case()
    whole = ops.paged_decode(*case)
    acc, m, l = _shard_partials(case, 2)  # noqa: E741
    dropped = l.clone()
    dropped[1] = 0.0                   # shard 1's normalizer mass lost
    with pytest.raises(AssertionError, match="the merge is not"):
        CS.hold_merge(torch, ref.merge_partials(acc, m, dropped), whole,
                      "dropped l")


def test_mapped_matches_refuses_one_flipped_accept():
    hist = [[(0, 5.0, 4.0, 1.0, True), (1, 4.5, 3.9, 0.6, True),
             (2, 4.7, 4.0, 0.7, False)],
            [(0, 5.0, 4.0, 1.0, True), (1, 5.2, 4.1, 1.1, False)]]
    pi = np.arange(8).tobytes()
    seq = {"histories": hist, "initial_loss": 5.0, "final_loss": 4.5,
           "migrations": 1, "pi": pi, "s": b"s", "phi": b"p"}
    CS.mapped_matches(seq, dict(seq), "same")
    flipped = [list(h) for h in hist]
    flipped[1][1] = (1, 5.2, 4.1, 1.1, True)
    with pytest.raises(AssertionError, match="island 1 parts"):
        CS.mapped_matches(seq, dict(seq, histories=flipped), "flipped")
    with pytest.raises(AssertionError, match="pi"):
        CS.mapped_matches(seq, dict(seq, pi=np.arange(1, 9).tobytes()),
                          "pi")


def test_first_layers_cuts_a_packed_model_as_packing_the_cut_weights():
    """14d's depth cut: the first n layers of a packed model are the packed
    first n layers of its weights, leaf for leaf (QTensor components
    included), and the rest of the tree is kept."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QTensor, QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model

    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    qc = QuantConfig(bits=2, group_size=32)
    got = CS.first_layers(pack_model(params, qc), 1)
    cut = dict(params, blocks={k: {n: w[:1] for n, w in v.items()}
                               if isinstance(v, dict) else v[:1]
                               for k, v in params["blocks"].items()})
    want = pack_model(cut, qc)

    def leaves(t, p=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], p + (k,))
        elif isinstance(t, QTensor):
            for c in ("packed", "scale", "zero"):
                yield p + (c,), getattr(t, c)
        else:
            yield p, t

    a, b = dict(leaves(got)), dict(leaves(want))
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    assert a[("blocks", "mlp", "up", "packed")].shape[0] == 1


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

def test_remat_runs_on_the_cpu():
    from repro_torch.configs import get_config
    rows = CS.remat_runs(torch, get_config("opt-tiny").reduced(), 2, 16,
                         device="cpu")
    assert list(rows) == list(CS.REMAT_POLICIES)
    for policy, r in rows.items():
        assert r["bit_equal"] and r["flops"] == r["fake_flops"] > 0
        assert r["fake_over_card"] == 1.0 and r["step_ms"] is None
    assert rows["full"]["flops"] > rows["off"]["flops"] == \
        rows["dots_all"]["flops"]
    assert len({r["loss"] for r in rows.values()}) == 1


def _remat_run(scale=0.0):
    g = {"w": torch.linspace(-1.0, 1.0, 64)}
    p = {"w": torch.linspace(0.0, 2.0, 64)}
    return {"loss": torch.tensor(3.0), "grad_norm": torch.tensor(1.0),
            "grads": {"w": g["w"] * (1 + scale)},
            "params": {"w": p["w"] + scale}}


def test_hold_remat_falls_back_to_the_9d_bars_and_refuses_past_them():
    ref = _remat_run()
    assert CS.hold_remat(torch, ref, _remat_run(), "same") is True
    assert CS.hold_remat(torch, ref, _remat_run(1e-6), "near") is False
    with pytest.raises(AssertionError, match="off the bar"):
        CS.hold_remat(torch, ref, _remat_run(1e-2), "far")
    moved = _remat_run()
    moved["loss"] = torch.tensor(3.001)
    with pytest.raises(AssertionError, match="loss parts"):
        CS.hold_remat(torch, ref, moved, "loss")


@pytest.mark.parametrize("fake,card,ok", [(95, 100, True), (109, 100, True),
                                          (89, 100, False), (111, 100, False)])
def test_peak_ratio_holds_the_band(fake, card, ok):
    if ok:
        assert CS.peak_ratio(fake, card, "x") == fake / card
    else:
        with pytest.raises(AssertionError, match="outside"):
            CS.peak_ratio(fake, card, "x")


def test_launch_rows_are_the_checkers_verdicts():
    from repro_torch.analysis import launch_budget
    rows = CS.launch_rows()
    zoo = [r for r in rows if r["arch"] != "probe"]
    assert len(zoo) == sum(1 for r in launch_budget.zoo_units() if r["proj"])
    assert all(r["reason"] is None for r in zoo)
    probes = [r for r in rows if r["arch"] == "probe"]
    assert [r["reason"] is None for r in probes] == [False, False, False,
                                                     True]
    assert {(r["arch"], r["mode"]) for r in zoo} >= {
        ("qwen3-4b", "up"), ("qwen3-4b", "down"), ("command-r-35b", "up")}


def test_phase_launch_budget_checks_and_refuses_on_the_cpu():
    from repro_torch.kernels import ops, ref
    rows = [dict(arch="x", proj="up", K=64, N=128, mode="up", group=32,
                 dtype="float32", reason=None),
            dict(arch="x", proj="down", K=128, N=64, mode="down", group=32,
                 dtype="bfloat16", reason=None)]
    assert CS.phase_launch_budget(torch, ops, ref, rows, device="cpu") == \
        (2, 0, 0)
    # the CPU route runs the plain version: a shape the checker flags is
    # taken there, which the phase reports as the wrapper launching it
    bad = dict(rows[0], reason="refused")
    with pytest.raises(AssertionError, match="launched it"):
        CS.phase_launch_budget(torch, ops, ref, [bad], device="cpu")


def test_gq_check_cases_cover_every_body_and_width():
    """Phase 1's group_quant checks: the main path's stacks (f32), AWQ's
    per-layer matrices, a per-column group, the 1-D path and a ragged N
    (f32 and bf16), each at every group of GROUPS where it has one; across
    them the kernel's plans reach every body, a narrowed vector and a
    halved hold."""
    import importlib as il
    from repro_torch.configs import get_config
    gq = il.import_module("repro_torch.kernels.group_quant")
    main = CS.main_path_gq_shapes(get_config("opt-1.3b"))
    cases = CS.gq_check_cases(main)
    assert [c[:2] for c in cases[:3]] == [(leaf, s) for leaf, s, _ in main]
    both = ("float32", "bfloat16")
    got = {(label, shape): (dtypes, groups)
           for label, shape, dtypes, groups in cases}
    for shape in CS.GQ_LAYER:
        assert got[("awq layer", shape)] == (both, CS.GROUPS)
    assert got[("per-column", (2048, 2048))] == (both, (2048,))
    assert got[("vector", (2048, 1))] == (both, CS.GROUPS + (2048,))
    assert got[("ragged", (2048, 4868))] == (both, CS.GROUPS)
    assert 4868 % 8 and (2048, 2048) in CS.GQ_LAYER
    plans = [gq.plan(*shape, g, getattr(torch, dt))
             for _, shape, dtypes, groups in cases
             for dt in dtypes for g in groups]
    assert {p.body for p in plans} == set(gq.BODIES)
    assert any(p.vec == 4 and p.body == "general" for p in plans)  # bf16
    assert {p.passes for p in plans} == {1, 2}
    assert any(p.hold < gq.hold_rows(4) and p.body == "fixed"
               for p in plans)


def test_first_layers_state_cuts_params_m_and_v():
    """9b's cut: every leaf under ``blocks`` of params, m and v sliced to
    the first n layers and copied, the step and the other leaves kept; the
    cut state takes the cut model's train step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves

    cfg = get_config("opt-tiny").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = (params, adamw_init(params))
    p, o = CS.first_layers_state(state, 1)
    assert p["blocks"].keys() == params["blocks"].keys()
    for got, full in zip(tree_leaves(p["blocks"]),
                         tree_leaves(params["blocks"])):
        assert got.shape[0] == 1 and torch.equal(got, full[:1])
        assert got.data_ptr() != full.data_ptr()
    assert p["lm_head"] is params["lm_head"] and o["step"] is state[1]["step"]
    for k in ("m", "v"):
        assert [x.shape[0] for x in tree_leaves(o[k]["blocks"])] == \
            [1] * len(tree_leaves(o[k]["blocks"]))
    step = make_train_step(dataclasses.replace(cfg, n_layers=1),
                           AdamWConfig())
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    _, _, m = step(p, o, {"tokens": toks})
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("bits,group", CS.TABLE3)
def test_table3_launch_formula_counts_the_kernel_calls(tiny_models,
                                                       monkeypatch, bits,
                                                       group):
    """2b's ``table3_main_path_launches`` against the ``group_quant`` and
    ``transform_quant`` wrapper calls of its pair of ``quantize_model``
    calls (RTN, then RTN + the fused search) at Table 3's settings."""
    import repro_torch.kernels as kernels
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig

    models, calib = tiny_models
    cfg, params = models["opt"]
    calls = {"group_quant": 0, "transform_quant": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    qcfg = QuantConfig(bits, group)
    scfg = SearchConfig(steps=3, fused_kernel=True, log_every=0)
    quantize_model(params, cfg, qcfg, "rtn", device="cpu")
    res = quantize_model(params, cfg, qcfg, "rtn", calib, scfg, device="cpu")
    assert calls == CS.table3_main_path_launches(cfg, scfg)
    assert res.search.final_loss <= res.search.initial_loss


@pytest.fixture(scope="module")
def tiny_packed():
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model

    cfg = get_config("opt-tiny").reduced(n_kv_heads=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, pack_model(params, QuantConfig(2, 32))


def test_sampled_step_launch_formula_and_its_checks_on_the_cpu(
        tiny_packed, monkeypatch):
    """5e's batch-wide step checks on the CPU, each paged-decode call
    counted as the card counts its launches: 4 calls of n_layers each."""
    from repro_torch.kernels import ops
    from repro_torch.serving import build_trace
    from repro_torch.serving import decode as dec

    cfg, params_q = tiny_packed
    real = dec.paged_decode

    def counted(q, k_pages, *a, **k):
        ops.LAUNCHES[ops.paged_decode_route(q.shape[1], k_pages.shape[2])] \
            += 1
        return real(q, k_pages, *a, **k)

    monkeypatch.setattr(dec, "paged_decode", counted)
    trace = build_trace(cfg.vocab_size, **CS.TRACE)
    assert CS.phase_sampled_step(torch, ops, cfg, params_q, trace,
                                 "cpu") == 4 * cfg.n_layers


def test_sampled_trace_alternates_the_settings():
    from repro_torch.launch.serve import Request
    from repro_torch.serving import build_trace

    reqs = CS.sampled_trace(Request, build_trace(512, **CS.TRACE))
    assert [(r.temperature, r.top_k) for r in reqs[:5]] == [
        (0.0, 0), CS.SAMPLED[0], (0.0, 0), CS.SAMPLED[1], (0.0, 0)]
    assert len({r.seed for r in reqs}) == len(reqs)


@pytest.mark.parametrize("temperature,top_k", [(0.8, 50), (1.0, 0),
                                               (0.5, 3)])
def test_perturbed_scores_give_the_sampled_token(temperature, top_k):
    """The scores 5e rebuilds from a served row and the request's stream
    have the token ``sample_logits_per_seq`` drew as their argmax, and the
    top-k restriction leaves -inf outside the kept set."""
    from repro_torch.launch.serve import Request
    from repro_torch.serving import decode as dec

    row = torch.randn(300, generator=torch.Generator().manual_seed(2)) * 3
    req = Request(prompt=np.zeros(4, np.int32), temperature=temperature,
                  top_k=top_k, seed=17)
    for j in range(6):
        tok = dec.sample_logits_per_seq(
            row[None], [dec.request_key(17, j, "cpu")], [temperature],
            [top_k])
        s = CS.perturbed_scores(torch, dec, row, req, j)
        assert int(torch.argmax(s)) == int(tok[0])
        if top_k:
            assert int(torch.isfinite(s).sum()) == top_k


def test_sampled_parting_gap_excuses_only_near_ties():
    """Two runs drawing tokens 1 and 2 part by rounding alone when each
    run's scores hold the other's token within the bar of its own; a
    clear winner in either run refuses the parting."""
    bar = CS.NEAR_TIE
    sa = torch.tensor([0.0, 10.0, 10.0 - 1e-5, 3.0])
    sb = torch.tensor([0.0, 10.0 - 2e-5, 10.0, 3.0])
    assert CS.sampled_parting_gap(sa, sb, 1, 2) < bar
    far_a = torch.tensor([0.0, 10.0, 9.0, 3.0])      # run a: 1 by far
    far_b = torch.tensor([0.0, 9.0, 10.0, 3.0])      # run b: 2 by far
    assert CS.sampled_parting_gap(far_a, sb, 1, 2) > bar
    assert CS.sampled_parting_gap(sa, far_b, 1, 2) > bar


def test_compare_sampled_holds_partings_to_their_rule():
    """Greedy requests may part only at an oracle near tie; sampled ones
    only where the two runs' perturbed scores nearly tie."""
    from repro_torch.launch.serve import Request
    from repro_torch.serving import decode as dec

    row = torch.randn(64, generator=torch.Generator().manual_seed(5))
    g = Request(prompt=np.zeros(4, np.int32))
    s = Request(prompt=np.zeros(4, np.int32), temperature=1.0, seed=3)
    top = int(torch.argmax(CS.perturbed_scores(torch, dec, row, s, 0)))
    other = (top + 1) % 64
    a = {"outs": [[5, 6], [top]], "rows": {(1, 0): row}}
    b = {"outs": [[5, 7], [other]], "rows": {(1, 0): row}}
    with pytest.raises(AssertionError, match="greedy request 0"):
        CS.compare_sampled(torch, dec, [g, s], a, b, set(), 1e-4, "t")
    with pytest.raises(AssertionError, match="sampled request 1"):
        CS.compare_sampled(torch, dec, [g, s], a, b, {(0, 1)}, 1e-4, "t")
    tied = row.clone()
    sc = CS.perturbed_scores(torch, dec, row, s, 0)
    tied[other] += float(sc[top] - sc[other])      # the two now tie
    a["rows"] = b["rows"] = {(1, 0): tied}
    parts = CS.compare_sampled(torch, dec, [g, s], a, b, {(0, 1)}, 1e-4, "t")
    assert [p[:2] for p in parts] == [(0, 1), (1, 0)]


def test_serve_recording_keeps_every_sampled_row_for_check_reach(
        tiny_packed, monkeypatch):
    """5e's recorded run on the CPU over the trace's first 8 requests: it
    serves the tokens an unrecorded run serves, keeps the row of every
    sampled token (``check_reach`` holds each one), puts the hooks back,
    and calls paged decode n_layers times a step, counted as the card
    counts its launches. A token off its row's draw, or one with no row,
    is refused."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.serving import build_trace
    from repro_torch.serving import decode as dec

    cfg, params_q = tiny_packed
    real = dec.paged_decode

    def counted(q, k_pages, *a, **k):
        ops.LAUNCHES[ops.paged_decode_route(q.shape[1], k_pages.shape[2])] \
            += 1
        return real(q, k_pages, *a, **k)

    monkeypatch.setattr(dec, "paged_decode", counted)
    trace = build_trace(cfg.vocab_size, **CS.TRACE)[:8]

    def server():
        return PagedServer(params_q, cfg, prefix_cache=True, device="cpu",
                           **CS.SERVE)

    want = server().generate(CS.sampled_trace(Request, trace))
    srv, reqs = server(), CS.sampled_trace(Request, trace)
    logits_step = dec.paged_decode_logits
    ops.reset_launch_counts()
    outs, rows = CS.serve_recording(torch, dec, srv, reqs)
    assert outs == want
    assert dec.paged_decode_logits is logits_step
    assert not {"run", "_first_token"} & set(vars(srv.batcher))
    route = ops.paged_decode_route(cfg.n_heads, cfg.n_kv_heads)
    assert ops.LAUNCHES[route] == cfg.n_layers * srv.batcher.stats["steps"]
    n = sum(len(o) for r, o in zip(reqs, outs) if r.temperature > 0.0)
    assert n > 0 and len(rows) == n
    assert CS.check_reach(torch, dec, cfg, reqs, outs, rows, "t") == n
    i = next(i for i, r in enumerate(reqs) if r.temperature > 0.0)
    bad = [list(o) for o in outs]
    bad[i][0] = int(torch.argmin(rows[(i, 0)]))
    with pytest.raises(AssertionError, match=f"request {i} token 0 is"):
        CS.check_reach(torch, dec, cfg, reqs, bad, rows, "t")
    del rows[(i, 0)]
    with pytest.raises(AssertionError, match="no recorded row"):
        CS.check_reach(torch, dec, cfg, reqs, outs, rows, "t")


def test_check_example_refuses_what_the_reference_would_not_print():
    res = SimpleNamespace(search=SimpleNamespace(
        initial_loss=2.0, final_loss=2.5, accept_rate=0.1))
    with pytest.raises(AssertionError, match="quickstart"):
        CS.check_example("quickstart", res, "calib CE: fp32=1")
    with pytest.raises(AssertionError, match="train_then_quantize"):
        CS.check_example("train_then_quantize", {
            "losses": [6.0, 6.5], "ppl": {"rtn": 1.0},
            "accept_rate": 0.0}, "")
    with pytest.raises(AssertionError, match="serve_quantized"):
        CS.check_example("serve_quantized", [[1] * 15], "[serve] batcher "
                         "stats:")
    with pytest.raises(AssertionError, match="multiarch"):
        CS.check_example("multiarch_smoke", [("a", float("nan"), "X", 1,
                                              None)],
                         "all architectures OK")
    assert CS.check_example("multiarch_smoke", [("a", 1.0, "X", 2, None)],
                            "a  ...\n\nall architectures OK\n") == {
        "archs": {"a": ["X", 2]}}
