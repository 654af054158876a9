"""Port parity: the sharding rules (``repro_torch.dist.sharding``) against
the reference's ``repro.dist.sharding``, spec for spec.

For every registered config and for the mesh of ``tests/test_sharding.py``
(data 16 x model 16) and a few more (2 x 1, 1 x 2, 4 x 2, a 2 x 16 x 16
multi-pod mesh), the spec trees of ``param_specs`` (dense and packed
QTensor params: component specs), ``opt_state_specs`` (with and without
ZeRO-1), ``cache_specs`` (batch- and sequence- or head-sharded) and
``data_spec`` must equal the reference's ``tuple(PartitionSpec)``, leaf for
leaf. The leaves' shapes come from the reference's ``param_structs`` /
``qparam_structs`` (``jax.eval_shape``: no weights), handed to the port as
shape-only leaves; the port's own parameter trees have the same paths
(``test_port_param_trees_have_the_reference_paths``). Then a rank's slice
under a spec (``shard_index``) tiles every leaf exactly once over the
ranks that write it (``replica_zero``).
"""
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.core import quant as jq
from repro.dist import sharding as js
from repro.launch.steps import param_structs, qparam_structs
from repro_torch.configs import get_config as tget_config
from repro_torch.core import quant as tq
from repro_torch.dist import sharding as ts
from repro_torch.models.model import init_params

ARCHS = list_archs(assigned_only=False)
MESHES = ({"data": 16, "model": 16}, {"data": 2, "model": 1},
          {"data": 1, "model": 2}, {"data": 4, "model": 2},
          {"pod": 2, "data": 16, "model": 16})
IDS = ["x".join(str(v) for v in m.values()) for m in MESHES]


def _mock_mesh(shape):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _to_port(tree):
    """Reference structs -> shape-only port leaves (QTensor kept)."""
    if isinstance(tree, jq.QTensor):
        return tq.QTensor(*(_to_port(c) for c in (tree.packed, tree.scale,
                                                  tree.zero)),
                          tree.bits, tree.group_size, tree.shape)
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_port(v) for v in tree)
    if tree is None:
        return None
    return types.SimpleNamespace(shape=tuple(tree.shape))


def _norm(entry):
    """One spec entry as a plain tuple-or-name (PartitionSpec may keep a
    1-tuple of axes)."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _flat(tree, path=()):
    """(path, spec tuple) pairs of a reference (PartitionSpec leaves) or
    port (tuple leaves) spec tree; QTensor nodes by component."""
    if isinstance(tree, P):
        return [(path, tuple(_norm(e) for e in tree))]
    if isinstance(tree, (jq.QTensor, tq.QTensor)):
        return [(path + (c,), tuple(_norm(e) for e in getattr(tree, c)))
                for c in ("packed", "scale", "zero")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, tuple) and tree and all(
            e is None or isinstance(e, (str, tuple)) for e in tree) and \
            not any(isinstance(e, tuple) and e and not isinstance(e[0], str)
                    for e in tree):
        return [(path, tuple(_norm(e) for e in tree))]
    if isinstance(tree, tuple):
        if tree == ():
            return [(path, ())]
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _assert_same(port, ref):
    got, want = dict(_flat(port)), dict(_flat(ref))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.fixture(scope="module")
def structs():
    out = {}
    for arch in ARCHS:
        cfg = jget_config(arch)
        out[arch] = (cfg, param_structs(cfg), qparam_structs(
            cfg, jq.QuantConfig(bits=2, group_size=128)))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(structs, arch, mesh):
    cfg, ps, qs = structs[arch]
    tcfg = tget_config(arch)
    tps, tqs = _to_port(ps), _to_port(qs)

    def rules(**kw):
        return (ts.ShardingRules(mesh, tcfg, **kw),
                js.ShardingRules(_mock_mesh(mesh), cfg, **kw))

    tr, jr = rules()
    _assert_same(ts.param_specs(tr, tps), js.param_specs(jr, ps))
    _assert_same(ts.param_specs(tr, tqs), js.param_specs(jr, qs))
    for batch in (128, 3, 1):
        _assert_same(ts.data_spec(tr, batch), js.data_spec(jr, batch))
    for kw in ({}, {"zero1": True}):
        tr, jr = rules(**kw)
        _assert_same(ts.opt_state_specs(tr, tps),
                     js.opt_state_specs(jr, ps))
    for kw in ({}, {"long_decode_shard": "heads"}):
        tr, jr = rules(**kw)
        for batch in (128, 3, 1):
            _assert_same(ts.cache_specs(tr, tcfg, batch),
                         js.cache_specs(jr, cfg, batch))


@pytest.mark.parametrize("arch", ["opt-tiny", "qwen3-4b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_port_param_trees_have_the_reference_paths(arch):
    """The rules read paths: the port's own parameter tree (at the reduced
    size) must carry the reference's."""
    cfg = tget_config(arch).reduced()
    port = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(
        lambda k: __import__("repro.models", fromlist=["init_params"])
        .init_params(k, jget_config(arch).reduced()), jax.random.PRNGKey(0))

    def paths(t, p=()):
        if isinstance(t, dict):
            return {x for k, v in t.items() for x in paths(v, p + (k,))}
        if isinstance(t, (tuple, list)):
            return {x for i, v in enumerate(t) for x in paths(v, p + (i,))}
        return set() if t is None else {(p, tuple(t.shape))}

    assert paths(port) == paths(ref)


@pytest.mark.parametrize("mesh", MESHES[1:4], ids=IDS[1:4])
@pytest.mark.parametrize("spec", [("data", "model"), (None, "model"),
                                  ("model", None), (("data", "model"), None),
                                  (None, None), ()])
def test_written_slices_tile_each_leaf_once(mesh, spec):
    shape = (8, 16)
    n = 1
    for v in mesh.values():
        n *= v
    seen = torch.zeros(shape, dtype=torch.int32)
    for r in range(n):
        if ts.replica_zero(spec, mesh, r):
            idx = ts.shard_index(spec, shape, mesh, r)
            seen[tuple(slice(a, b) for a, b in idx)] += 1
    assert bool((seen == 1).all())
