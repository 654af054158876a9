"""Port parity: ``repro_torch.dist.collectives`` and ``dist.attention`` in 2
and 4 real gloo ranks on the CPU against the JAX reference.

The ranks (``helpers.dist_workers.collective_checks``) start once per world
size, all together, in one module-scoped fixture, and hand back their
outputs; the reference runs here, while the ranks work, under
``jax.vmap(f, axis_name="d")`` over the same seeded per-rank inputs stacked
on a leading axis, which gives its collectives (``all_gather``, ``pmax``,
``psum``) that many shards: one jitted program a world size computes every
reference output.

Bars: ``argmin_allgather`` and ``elite_broadcast`` exact (ties go to the
first rank); ``compressed_psum`` within N·max(scale)/2 of the exact sum
(``tests/test_substrate.py``), its codes equal to the reference's but at
one-step round-half ties (``assert_within_one_step``), its output within
one quantization step of the reference's; the sharded decodes within 1e-5
of the reference's ``use_pallas=False`` merge and of one unsharded decode
(``tests/test_paged.py``'s bar, bf16 pools included: both sides read them
upcast to f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.dist_ranks import finish_ranks, start_ranks
from helpers.dist_workers import (PAGED_CASES, PSUM_CASES, collective_checks,
                                  collective_inputs, paged_inputs)
from helpers.torch_parity import assert_within_one_step
from repro.core import quant as jq
from repro.dist import attention as ja
from repro.dist import collectives as jc
from repro.kernels import ops as jops
from repro_torch.core import quant as tq

WORLDS = (2, 4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _dtype(case):
    return jnp.bfloat16 if case[-1] == "bfloat16" else jnp.float32


def _reference(world):
    """Every reference output for ``world`` shards: the collectives (shard
    0's row; every shard holds the same result) under one jitted vmap, and
    the unsharded decodes."""
    x = collective_inputs(world)
    cases = [paged_inputs(world, *c[1:6]) for c in PAGED_CASES]
    q = jnp.asarray(x["q"])

    def body(am, ties, tv, tw, ps, k, v, start, paged):
        return {"argmin": jc.argmin_allgather(am, "d"),
                "argmin_ties": jc.argmin_allgather(ties, "d"),
                "broadcast": [jc.elite_broadcast({"v": tv, "w": tw}, o, "d")
                              for o in range(world)],
                "psum": [jc.compressed_psum(ps, "d", bits=b, group=g)
                         for b, g in PSUM_CASES],
                "decode": [ja.sharded_decode_attention(
                    q, k, v, "d", shard_start=start, kv_len=n)
                    for n in x["kv_lens"]],
                "paged": [ja.sharded_paged_decode_attention(
                    jnp.asarray(c["q"]), kp, vp, bt, ln, "d",
                    use_pallas=False) for c, (kp, vp, bt, ln)
                    in zip(cases, paged)]}

    paged = [(jnp.asarray(c["kp"], _dtype(case)),
              jnp.asarray(c["vp"], _dtype(case)), jnp.asarray(c["bt"]),
              jnp.asarray(c["lens"])) for c, case in zip(cases, PAGED_CASES)]
    sharded = jax.jit(jax.vmap(body, axis_name="d"))(
        jnp.asarray(x["argmin"]), jnp.asarray(x["argmin_ties"]),
        jnp.asarray(x["tree_v"]), jnp.asarray(x["tree_w"]),
        jnp.asarray(x["psum"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.arange(world) * 8, paged)

    @jax.jit
    def dense():
        k = jnp.concatenate(list(jnp.asarray(x["k"])), axis=1)
        v = jnp.concatenate(list(jnp.asarray(x["v"])), axis=1)
        return {
            "decode": [ja.merge_partials(*(a[None] for a in
                                           ja.partial_decode_attention(
                                               q, k, v, kv_len=n)))
                       for n in x["kv_lens"]],
            "paged": [jops.paged_decode(
                jnp.asarray(c["q"]), jnp.asarray(c["whole"][0], _dtype(case)),
                jnp.asarray(c["whole"][1], _dtype(case)),
                jnp.asarray(c["whole"][2]), jnp.asarray(c["whole"][3]),
                use_pallas=False) for c, case in zip(cases, PAGED_CASES)]}

    return (jax.tree.map(lambda a: np.asarray(a)[0], sharded),
            jax.tree.map(np.asarray, dense()))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    handles = {w: start_ranks(collective_checks, w, tmp) for w in WORLDS}
    try:
        refs = {w: _reference(w) for w in WORLDS}
        return {w: finish_ranks(h) for w, h in handles.items()}, refs
    finally:   # a failure here leaves no rank running
        for procs, _ in handles.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def refs(both):
    return both[1]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["argmin", "argmin_ties"])
def test_argmin_allgather_matches_reference(ranks, refs, world, name):
    x = collective_inputs(world)[name]
    v, i = refs[world][0][name]
    want = (float(v), int(i))
    assert all(r[name] == want for r in ranks[world])
    if name == "argmin_ties":
        assert want[1] == int(np.argmin(x))   # the first of the tied ranks
        assert (x == x.min()).sum() == 2


@pytest.mark.parametrize("world", WORLDS)
def test_elite_broadcast_matches_reference(ranks, refs, world):
    for owner in range(world):
        want = refs[world][0]["broadcast"][owner]
        for r in ranks[world]:
            v, w, none = r["broadcast"][owner]
            np.testing.assert_array_equal(v, want["v"])
            np.testing.assert_array_equal(w, want["w"])
            assert w.dtype == np.int32 and none is None


def _encode(flats, bits, group):
    """(codes, dequantized) of each rank's padded contribution in the port,
    and (codes, dequantized, scale) in the reference (one jitted vmap)."""
    cfg_t = tq.QuantConfig(bits=bits, group_size=group)
    cfg_j = jq.QuantConfig(bits=bits, group_size=group)
    port = []
    for flat in flats:
        t = torch.from_numpy(flat)
        s_t, z_t = tq.compute_qparams(t, cfg_t)
        c_t = tq.quantize_codes(t, s_t, z_t, cfg_t)
        port.append((c_t.numpy(),
                     tq.dequantize_codes(c_t, s_t, z_t, cfg_t).numpy()))

    def ref(j):
        s_j, z_j = jq.compute_qparams(j, cfg_j)
        c_j = jq.quantize_codes(j, s_j, z_j, cfg_j)
        return c_j, jq.dequantize_codes(c_j, s_j, z_j, cfg_j), s_j

    ref_out = jax.jit(jax.vmap(ref))(jnp.asarray(np.stack(flats)))
    return port, tuple(np.asarray(a) for a in ref_out)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(PSUM_CASES)),
                         ids=[f"{b}-{g}" for b, g in PSUM_CASES])
def test_compressed_psum_matches_reference(ranks, refs, world, case):
    bits, group = PSUM_CASES[case]
    x = collective_inputs(world)["psum"]
    want = refs[world][0]["psum"][case]
    got = ranks[world][0]["psum"][bits, group]
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r["psum"][bits, group], got)
    assert got.shape == x.shape[1:] and got.dtype == np.float32
    # the codes, rank by rank, on the padded flat contribution
    vpw = 32 // bits
    unit = group * vpw // np.gcd(group, vpw)
    n = x[0].size
    flats = [np.concatenate([row.reshape(-1),
                             np.zeros((-n) % unit, np.float32)]) for row in x]
    port, (c_j, fq_j, s_j) = _encode(flats, bits, group)
    steps = []
    for (c_t, fq_t), cj, fj, sj in zip(port, c_j, fq_j, s_j):
        assert_within_one_step(fq_t, fj, sj, group)
        assert np.mean(c_t != cj) < 1e-3
        steps.append(np.repeat(sj, group)[:n])
    steps = np.stack(steps)
    # the error bound against the exact sum, and one step of the reference's
    exact = x.sum(axis=0)
    assert np.all(np.abs(got - exact).reshape(-1)
                  <= world * steps.max() / 2 + 1e-6)
    np.testing.assert_array_less(
        np.abs(got - want).reshape(-1), steps.max(axis=0) * 1.001 + 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_decode_attention_matches_reference(ranks, refs, world):
    x = collective_inputs(world)
    sharded, dense = refs[world]
    assert x["kv_lens"][0] <= 8     # every shard but the first fully masked
    for i, kv_len in enumerate(x["kv_lens"]):
        for r in ranks[world]:
            got = r["decode"][kv_len]
            np.testing.assert_allclose(got, sharded["decode"][i], **TOL)
            np.testing.assert_allclose(got, dense["decode"][i], **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(PAGED_CASES)),
                         ids=[c[0] for c in PAGED_CASES])
def test_sharded_paged_decode_matches_reference(ranks, refs, world, case):
    name, H, Hkv = PAGED_CASES[case][:3]
    c = paged_inputs(world, *PAGED_CASES[case][1:6])
    sharded, dense = refs[world]
    # the cases hold a fully masked shard and a length-0 shard of a sequence
    assert (c["lens"] == 0).any()
    for mp in ((1, 2) if H > Hkv else (1,)):
        for r in ranks[world]:
            got = r["paged"][name, mp]
            np.testing.assert_allclose(got, sharded["paged"][case], **TOL)
            np.testing.assert_allclose(got, dense["paged"][case], **TOL)
