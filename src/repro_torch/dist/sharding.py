"""Sharding rules: partition specs over the ("data", "model") mesh (the
reference's ``repro.dist.sharding``, pure Python).

One ``ShardingRules`` object holds the mesh geometry plus the model config
and answers every "where does this leaf live?" question:

  - ``param_specs``     — megatron-style tensor parallelism over "model":
                          attention QKV / MLP up+gate column-sharded, WO / MLP
                          down row-sharded, MoE experts sharded on the expert
                          dim, vocab-sharded embeddings. Head-aware: an arch
                          whose (kv-)head count does not divide the model axis
                          replicates those weights instead.
  - ``opt_state_specs`` — param specs for m/v, plus ZeRO-1: the first free
                          (replicated) dim that divides the data axis is
                          sharded over "data".
  - ``cache_specs``     — decode KV caches: batch-sharded over "data" when the
                          batch divides it, otherwise sequence-sharded or
                          head-sharded (``long_decode_shard="heads"``).
  - ``data_spec``       — token batches over "data", replicated fallback.

A spec is a tuple with one entry per dim: a mesh-axis name, a tuple of
names, or None (replicated) — ``tuple(PartitionSpec)`` of the reference's.
Every proposed axis is divisibility-gated. QTensor leaves get
component-wise specs (a ``QTensor`` whose packed / scale / zero are specs,
each re-gated against its own row count).

The port's forward shards nothing: a spec says which slice of a leaf a
rank owns (``shard_index`` / ``shard_of``), which is what the format-2
checkpoint writes and ``dist.fault.remesh_restore`` reads back. A mesh is
its shape, a dict of axis name -> size (``launch.mesh.make_local_mesh``),
or anything with such a ``.shape``; rank r sits at the row-major
coordinates of r over the axes in that order.
"""
from __future__ import annotations

import math

from repro_torch.core.quant import QTensor

__all__ = ["ShardingRules", "param_specs", "opt_state_specs", "cache_specs",
           "data_spec", "mesh_coords", "shard_index", "shard_of",
           "replica_zero"]


def _shape_dict(mesh) -> dict:
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


class ShardingRules:
    """Mesh geometry + model config -> sharding decisions. Batch-parallel
    dims shard over every data-like axis present ("pod" and "data")."""

    def __init__(self, mesh, cfg, *, zero1: bool = False,
                 long_decode_shard: str = "seq"):
        if long_decode_shard not in ("seq", "heads"):
            raise ValueError(f"long_decode_shard must be 'seq' or 'heads', "
                             f"got {long_decode_shard!r}")
        shape = _shape_dict(mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.zero1 = zero1
        self.long_decode_shard = long_decode_shard
        self.model = int(shape.get("model", 1))
        self.has_model = "model" in shape and self.model > 1
        self.batch_axes = tuple(a for a in ("pod", "data") if a in shape)
        self.data = 1
        for a in self.batch_axes:
            self.data *= int(shape[a])
        self.has_data = self.data > 1

    @property
    def batch_entry(self):
        """The spec entry for a batch-parallel dim."""
        if not self.batch_axes:
            return None
        return self.batch_axes[0] if len(self.batch_axes) == 1 \
            else self.batch_axes

    @property
    def heads_ok(self) -> bool:
        return self.has_model and self.cfg.n_heads > 0 \
            and self.cfg.n_heads % self.model == 0

    @property
    def kv_heads_ok(self) -> bool:
        return self.has_model and self.cfg.n_kv_heads > 0 \
            and self.cfg.n_kv_heads % self.model == 0

    @property
    def ssm_heads_ok(self) -> bool:
        if not (self.has_model and self.cfg.ssm is not None):
            return False
        return self.cfg.ssm.n_heads(self.cfg.d_model) % self.model == 0


def _map_tree(fn, tree, path=()):
    if isinstance(tree, QTensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


_MLP_COL = ("up", "gate", "b_up", "b_gate")   # output (N) dim sharded
_ATTN_Q = ("wq", "bq")                         # q-head-structured outputs
_ATTN_KV = ("wk", "wv", "bk", "bv")            # kv-head-structured outputs


def _propose(rules: ShardingRules, path):
    """Negative trailing-dim index to shard over "model", or None."""
    if not rules.has_model:
        return None
    names = tuple(str(k) for k in path)
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    if parent in ("attn", "xattn"):
        if leaf in _ATTN_Q and rules.heads_ok:
            return -1
        if leaf in _ATTN_KV and rules.kv_heads_ok:
            return -1
        if leaf == "wo" and rules.heads_ok:
            return -2
        return None
    if parent == "mlp":
        if leaf in _MLP_COL:
            return -1
        if leaf == "down":
            return -2
        return None
    if parent == "moe":
        if leaf in ("up", "down", "gate"):
            return -3  # expert dim of (..., E, D, F)
        return None  # router stays replicated (tiny, feeds top_k)
    if parent == "ssm":
        if leaf in ("w_z", "w_x") and rules.ssm_heads_ok:
            return -1
        if leaf == "out_proj" and rules.ssm_heads_ok:
            return -2
        return None
    if parent == "embed":
        return -2 if leaf == "tok" else None  # vocab-sharded embedding
    if leaf == "lm_head":
        return -1  # (D, V): vocab-sharded output projection
    return None


def _gated(rules: ShardingRules, ndim: int, shape, pos) -> tuple:
    """Full-rank spec with "model" at ``pos`` iff that dim divides the axis."""
    entries = [None] * ndim
    if pos is not None and -pos <= ndim and shape[pos] % rules.model == 0:
        entries[pos] = "model"
    return tuple(entries)


def _leaf_spec(rules: ShardingRules, path, shape) -> tuple:
    return _gated(rules, len(shape), shape, _propose(rules, path))


def _qtensor_specs(rules: ShardingRules, path, qt: QTensor) -> QTensor:
    """Component specs for a packed QTensor leaf: the logical (K, N) weight
    decides the trailing axis; each component re-gates on its OWN dim."""
    pos = _propose(rules, path)
    if pos is not None and not (-pos <= len(qt.shape)
                                and qt.shape[pos] % rules.model == 0):
        pos = None  # logical weight itself unshardable -> replicate everywhere

    def comp(arr) -> tuple:
        return _gated(rules, len(arr.shape), arr.shape, pos)

    return QTensor(packed=comp(qt.packed), scale=comp(qt.scale),
                   zero=comp(qt.zero), bits=qt.bits,
                   group_size=qt.group_size, shape=qt.shape)


def param_specs(rules: ShardingRules, structs):
    """Spec tree mirroring a param (or packed-QTensor-param) tree; leaves
    need only ``.shape``."""
    def leaf(path, node):
        if isinstance(node, QTensor):
            return _qtensor_specs(rules, path, node)
        return _leaf_spec(rules, path, tuple(node.shape))
    return _map_tree(leaf, structs)


def _zero1_spec(rules: ShardingRules, spec: tuple, shape) -> tuple:
    """Shard the first free dim that divides the data axis over "data"."""
    if not rules.has_data:
        return spec
    entries = list(spec)
    for i, (ax, dim) in enumerate(zip(entries, shape)):
        if ax is None and dim % rules.data == 0:
            entries[i] = rules.batch_entry
            return tuple(entries)
    return spec


def opt_state_specs(rules: ShardingRules, structs):
    """Specs for the AdamW state over PARAM structs: {"m", "v", "step"};
    with ``zero1=True`` each m/v leaf also shards one free axis over
    "data"."""
    def leaf(path, node):
        if isinstance(node, QTensor):
            return _qtensor_specs(rules, path, node)
        shape = tuple(node.shape)
        spec = _leaf_spec(rules, path, shape)
        if rules.zero1:
            spec = _zero1_spec(rules, spec, shape)
        return spec
    mv = _map_tree(leaf, structs)
    return {"m": mv, "v": mv, "step": ()}


def cache_specs(rules: ShardingRules, cfg, batch: int):
    """Decode-cache specs for ``init_cache(cfg, batch, max_len)`` trees:
    batch-sharded when the batch divides the data axis, otherwise
    sequence-sharded over "data" (or head-sharded with
    ``long_decode_shard="heads"``); KV heads over "model" when the kv-head
    count divides it."""
    batch_ok = rules.has_data and batch % rules.data == 0
    b_ax = rules.batch_entry if batch_ok else None
    seq_ax = None
    if not batch_ok and rules.has_data and rules.long_decode_shard == "seq":
        seq_ax = rules.batch_entry
    h_ax = "model" if rules.kv_heads_ok else None

    def dense_cache():
        kv = (None, b_ax, seq_ax, h_ax, None)
        c = {"k": kv, "v": kv}
        if cfg.kv_cache_dtype == "int8":
            sc = (None, b_ax, seq_ax, h_ax)
            c["k_scale"] = sc
            c["v_scale"] = sc
        return c

    def ssm_cache():
        sh_ax = "model" if rules.ssm_heads_ok else None
        return {
            "state": (None, b_ax, sh_ax, None, None),   # (L, B, H, hd, N)
            "conv": {"x": (None, b_ax, None, sh_ax),    # (L, B, W, di)
                     "B": (None, b_ax, None, None),
                     "C": (None, b_ax, None, None)},
        }

    if cfg.block_pattern in ("dense", "moe"):
        return dense_cache()
    if cfg.block_pattern == "ssm":
        return ssm_cache()
    if cfg.block_pattern == "hybrid":
        return {"ssm": ssm_cache(), "attn": dense_cache()}
    raise ValueError(cfg.block_pattern)


def data_spec(rules: ShardingRules, batch: int) -> tuple:
    """(B, S) token batches: batch over "data" when divisible, else
    replicate."""
    ok = rules.has_data and batch % rules.data == 0
    return (rules.batch_entry if ok else None, None)


# ---------------------------------------------------------------------------
# a rank's slice under a spec
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> dict:
    """Axis name -> rank's coordinate: the row-major position of ``rank``
    over the mesh's axes (a mesh of W = prod(sizes) ranks)."""
    shape = _shape_dict(mesh)
    if not 0 <= rank < math.prod(shape.values()):
        raise ValueError(f"rank {rank} outside a mesh of "
                         f"{math.prod(shape.values())} ranks {shape}")
    coords = {}
    for name in reversed(list(shape)):
        coords[name] = rank % shape[name]
        rank //= shape[name]
    return {k: coords[k] for k in shape}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(spec, shape, mesh, rank: int) -> list:
    """[[start, stop], ...] of the slice of a ``shape`` leaf that ``rank``
    owns under ``spec``: a dim named by axes splits into prod(sizes) equal
    parts, the part being the row-major index of the rank's coordinates on
    those axes; a dim past the spec, or None, stays whole."""
    sizes, coords = _shape_dict(mesh), mesh_coords(mesh, rank)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for entry, dim in zip(spec, shape):
        n, part = 1, 0
        for ax in _axes(entry):
            n, part = n * sizes[ax], part * sizes[ax] + coords[ax]
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry!r} "
                             f"({n} parts)")
        out.append([part * dim // n, (part + 1) * dim // n])
    return out


def replica_zero(spec, mesh, rank: int) -> bool:
    """True iff ``rank`` writes its slice of a leaf under ``spec``: its
    coordinate is 0 on every axis the spec does not shard over (each
    global slice has exactly one such rank)."""
    used = {ax for entry in spec for ax in _axes(entry)}
    coords = mesh_coords(mesh, rank)
    return all(c == 0 for ax, c in coords.items() if ax not in used)


def shard_of(x, spec, mesh, rank: int):
    """``rank``'s slice of the tensor ``x`` under ``spec`` (a view)."""
    idx = shard_index(spec, tuple(x.shape), mesh, rank)
    return x[tuple(slice(a, b) for a, b in idx)]
