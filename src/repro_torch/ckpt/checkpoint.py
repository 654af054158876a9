"""Checkpoints: manifests, async save, addressable-shard format — on disk the
reference's ``repro.ckpt.checkpoint``, so either package restores the
other's checkpoints.

Two on-disk formats share one directory layout and one manifest commit point:

format 1 — host-local full arrays:
    <dir>/step_000100/
        manifest.json        — step, keys (global shape/dtype/sha), extra
        host0000.npz         — this host's FULL copy of every leaf

format 2 — addressable shards:
    <dir>/step_000100/
        host0000.npz         — the shards host 0 wrote (raw bytes)
        shards_host0000.json — per-shard records: key, npz entry, index
                               ([start, stop) per dim) and sha256 checksum
        host0001.npz / shards_host0001.json / ...
        manifest.json        — tree structure + GLOBAL shapes, written by
                               process 0 only after every host's shard
                               manifest landed (the commit record)

What keeps the two packages' files interchangeable:
  - the same flat keys (``_flatten``: sorted dict keys, ``__{i}`` for tuple
    items, ``__none`` for None, ``__qt_packed/scale/zero/meta`` for a
    ``QTensor``), dtype names and sha256[:16] checksums of the same bytes;
  - the port's ``QTensor`` words are int32 views of the reference's uint32
    words: they are written as uint32, bit for bit, and read back as the
    int32 view (any uint32 leaf comes back so);
  - numpy has no bf16: a bf16 leaf is written through its raw 2-byte words
    (format 1: a ``V2`` array, as numpy stores the reference's bf16; format
    2: the bytes, as the reference's ``_to_bytes``) and viewed back through
    the manifest's dtype name.

Format 2 is written by every process of the ``torch.distributed`` world
(``process_index_count``: one host a rank). Given a spec tree and a mesh
shape (``dist.sharding``: a tuple of mesh-axis names per dim, a
``QTensor`` of component specs), each rank writes only the slices it owns,
by the reference's replica-0 rule: a leaf's slice is written by the one
rank whose coordinates are 0 on every axis the leaf's spec does not shard
over, so every global slice lands exactly once; a leaf without a spec, and
a plain value, is written whole by rank 0. Every rank passes the whole
tree (the port's ranks hold whole tensors). Rank 0 commits
``manifest.json`` once every host's shard manifest has landed (a
filesystem barrier, no collective: the manager writes on a thread).
``restore_sharded_checkpoint`` assembles whichever hosts' shards overlap
what it is asked for: whole tensors, or under a target spec tree and mesh
shape only one rank's slice of each leaf — the elastic re-mesh onto
another mesh shape or world size (``dist.fault.remesh_restore``). Every
restore verifies checksums, and corruption errors NAME THE FILE. Restores
return tensors on ``device`` (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "save_sharded_checkpoint", "restore_sharded_checkpoint",
           "latest_step", "list_steps", "process_index_count"]

_SEP = "/"


def process_index_count() -> tuple:
    """(this process's index, the process count) for shard ownership and
    gc: the ``torch.distributed`` rank and world size, (0, 1) without a
    process group."""
    from repro_torch.dist import runtime
    return runtime.process_index(), runtime.process_count()


def _flatten(tree, path=()):
    """Yield (path, leaf) with QTensor exploded to components and None kept
    as a sentinel (the reference's key scheme)."""
    if isinstance(tree, QTensor):
        yield path + ("__qt_packed",), tree.packed
        yield path + ("__qt_scale",), tree.scale
        yield path + ("__qt_zero",), tree.zero
        yield path + ("__qt_meta",), np.array(
            [tree.bits, tree.group_size] + list(tree.shape), np.int64)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (f"__{i}",))
    elif tree is None:
        yield path + ("__none",), np.zeros((), np.int8)
    else:
        yield path, tree


def _host(key: str, leaf):
    """(numpy carrier, dtype name) of a leaf, copied to the host (a copy for
    a CPU tensor too, so the caller may change it after a save): a bf16
    tensor's carrier is its uint16 words, a packed QTensor's its uint32
    words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    if key.endswith("__qt_packed"):
        a = a.view(np.uint32)
    return a, str(a.dtype)


def _snapshot(tree) -> dict:
    """Flat key -> (numpy carrier, dtype name): the synchronous device ->
    host copy of every leaf, QTensor components included."""
    out = {}
    for p, v in _flatten(tree):
        key = _SEP.join(p)
        out[key] = _host(key, v)
    return out


def _carrier(name: str) -> np.dtype:
    """numpy dtype that holds a manifest dtype's bytes."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _to_tensor(a: np.ndarray, name: str, dev: torch.device) -> torch.Tensor:
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(dev)
    if name == "uint32":
        a = a.view(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _unflatten(flat: dict, names: dict, dev: torch.device):
    """Rebuild the nested dict/tuple/QTensor tree from flat 'a/b/c' keys
    (numpy carriers), tensors on ``dev``."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (key, val)

    def leaf(entry):
        key, val = entry
        return _to_tensor(val, names[key], dev)

    def rebuild(node):
        if not isinstance(node, dict):
            return leaf(node)
        if "__none" in node:
            return None
        if "__qt_meta" in node:
            meta = np.asarray(node["__qt_meta"][1])
            return QTensor(leaf(node["__qt_packed"]), leaf(node["__qt_scale"]),
                           leaf(node["__qt_zero"]), int(meta[0]), int(meta[1]),
                           tuple(int(x) for x in meta[2:]))
        if node and all(k.startswith("__") and k[2:].isdigit() for k in node):
            return tuple(rebuild(node[f"__{i}"]) for i in range(len(node)))
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _bytes_view(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of an array's payload (a copy only when it is not
    contiguous)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(_bytes_view(arr)).hexdigest()[:16]


def _checksums(arrays: dict) -> dict:
    """key -> ``_checksum`` of every array, on a thread pool (hashlib
    releases the GIL on large buffers, so leaves hash in parallel)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return dict(zip(arrays, ex.map(_checksum, arrays.values())))


def _publish_npz(directory: pathlib.Path, name: str, flat: dict):
    tmp = directory / f".tmp_{name}"                  # np.savez appends .npz
    np.savez(tmp, **flat)                             # unless it's present
    tmp_npz = directory / f".tmp_{name}.npz"
    obs.counter("ckpt_bytes_written_total",
                "Checkpoint shard/file bytes published to disk").inc(
        tmp_npz.stat().st_size)
    tmp_npz.rename(directory / f"{name}.npz")


def _publish_json(path: pathlib.Path, obj):
    tmp = path.with_name("." + path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.rename(path)


# ---------------------------------------------------------------------------
# format 1: host-local full arrays
# ---------------------------------------------------------------------------

def save_checkpoint(directory, step: int, tree, *, host_id: int = 0,
                    extra: Optional[dict] = None, verify: bool = True):
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    _write_full(d, step, _snapshot(tree), host_id=host_id, extra=extra,
                verify=verify)
    return d


def _write_full(d: pathlib.Path, step: int, snap: dict, *, host_id: int,
                extra: Optional[dict], verify: bool):
    sums = _checksums({k: a for k, (a, _) in snap.items()}) if verify else {}
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(a.shape), "dtype": name,
                     **({"sha": sums[k]} if verify else {})}
                 for k, (a, name) in snap.items()},
        "extra": extra or {},
        "format": 1,
    }
    # numpy stores the reference's bf16 words as a 2-byte void array
    flat = {k: (a.view("V2") if name == "bfloat16" else a)
            for k, (a, name) in snap.items()}
    _publish_npz(d, f"host{host_id:04d}", flat)
    _publish_json(d / "manifest.json", manifest)


def restore_checkpoint(directory, step: Optional[int] = None, *, host_id: int = 0,
                       verify: bool = True, device="cuda"):
    """Returns (tree, manifest), the tree's tensors on ``device``. A
    format-2 checkpoint is assembled whole (``restore_sharded_checkpoint``)."""
    dev = resolve_device(device)
    base = pathlib.Path(directory)
    step = _resolve_step(base, step)
    d = base / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest.get("format", 1) == 2:
        tree = restore_sharded_checkpoint(directory, step, verify=verify,
                                          device=dev)[0]
        return tree, manifest
    flat = _read_full(d, manifest, host_id, verify)
    names = {k: m["dtype"] for k, m in manifest["keys"].items()}
    return _unflatten(flat, names, dev), manifest


def _read_full(d: pathlib.Path, manifest: dict, host_id: int,
               verify: bool) -> dict:
    """Flat key -> numpy carrier of a format-1 step, checksums verified."""
    shard_file = d / f"host{host_id:04d}.npz"
    try:
        with np.load(shard_file) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:  # zip CRC / truncation surfaces before checksums
        raise IOError(f"checkpoint corruption in {shard_file}: "
                      f"unreadable shard file ({e})") from e
    if verify:
        for k in manifest["keys"]:
            if k not in flat:
                raise IOError(f"checkpoint corruption in {shard_file}: "
                              f"leaf {k!r} missing from shard file")
        sums = _checksums({k: flat[k] for k, meta in manifest["keys"].items()
                           if "sha" in meta})
        for k, got in sums.items():
            if got != manifest["keys"][k]["sha"]:
                raise IOError(f"checkpoint corruption in {shard_file}: "
                              f"leaf {k!r} fails its manifest checksum")
    return flat


def _resolve_step(base: pathlib.Path, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base}")
    return step


# ---------------------------------------------------------------------------
# format 2: addressable shards
# ---------------------------------------------------------------------------

def _spec_at(specs, parts):
    """The spec at a flat key's path (its '/'-split parts) in a spec tree
    mirroring the saved tree; None (whole) where the tree has none."""
    node = specs
    for p in parts:
        if node is None:
            return None
        if isinstance(node, QTensor):
            if not p.startswith("__qt_") or p == "__qt_meta":
                return None
            node = getattr(node, p[len("__qt_"):])
        elif isinstance(node, dict):
            node = node.get(p)
        elif p.startswith("__") and p[2:].isdigit():
            node = node[int(p[2:])]
        else:
            return None
    return node


def _dtype_name(key: str, leaf) -> str:
    """The manifest dtype name ``_host`` would give the leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        name = str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    else:
        name = str(np.asarray(leaf).dtype)
    return "uint32" if key.endswith("__qt_packed") else name


def _check_mesh(specs, mesh, n_ranks: int) -> dict:
    from repro_torch.dist import sharding
    if specs is None:
        return {}
    if mesh is None:
        raise ValueError("a spec tree needs the mesh shape it refers to")
    shape = sharding._shape_dict(mesh)
    if int(np.prod(list(shape.values()))) != n_ranks:
        raise ValueError(f"mesh {shape} has {int(np.prod(list(shape.values())))}"
                         f" ranks, the world {n_ranks}")
    return shape


def _prepare_shards(tree, specs=None, mesh=None):
    """Synchronous device->host snapshot of this process's shards. Returns
    (records, flat_arrays, keys_meta):
      records     — [{key, npz, index, sha}] for this host's shard manifest
      flat_arrays — npz entry name -> raw shard bytes
      keys_meta   — flat key -> {shape, dtype} GLOBAL metadata
    Without ``specs`` process 0 writes every leaf whole; with them each
    rank copies and writes only the slices it owns (module docstring)."""
    from repro_torch.dist import sharding
    pid, n = process_index_count()
    mesh = _check_mesh(specs, mesh, n)
    records, flat_arrays, keys_meta = [], {}, {}
    for path, leaf in _flatten(tree):
        key = _SEP.join(path)
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else np.shape(leaf)
        keys_meta[key] = {"shape": list(shape),
                          "dtype": _dtype_name(key, leaf)}
        spec = _spec_at(specs, path) if isinstance(leaf, torch.Tensor) \
            else None
        if spec is None or not any(spec):
            if pid != 0:
                continue
            index = [[0, d] for d in shape]
        else:
            if not sharding.replica_zero(spec, mesh, pid):
                continue
            index = sharding.shard_index(spec, shape, mesh, pid)
            leaf = leaf[tuple(slice(a, b) for a, b in index)]
        a, _ = _host(key, leaf)
        npz = f"{key}#{pid}"
        flat_arrays[npz] = _bytes_view(a)
        records.append({"key": key, "npz": npz, "index": index})
    sums = _checksums(flat_arrays)
    for rec in records:
        rec["sha"] = sums[rec["npz"]]
    return records, flat_arrays, keys_meta


def _write_shards(d: pathlib.Path, step: int, prepared, *, extra, timeout):
    records, flat_arrays, keys_meta = prepared
    pid, n_hosts = process_index_count()
    # a crashed earlier attempt at this step (no manifest.json committed)
    # may have left THIS host's files behind; remove them first so process
    # 0's filesystem barrier below cannot count a stale shard manifest as
    # this attempt's (each host cleans only its own files)
    if not (d / "manifest.json").exists():
        for stale in (d / f"host{pid:04d}.npz",
                      d / f"shards_host{pid:04d}.json"):
            stale.unlink(missing_ok=True)
    _publish_npz(d, f"host{pid:04d}", flat_arrays)
    _publish_json(d / f"shards_host{pid:04d}.json",
                  {"host": pid, "shards": records})
    if pid != 0:
        return
    # filesystem barrier: the manifest is the commit record, so it must not
    # land before every host's shard manifest has
    deadline = time.monotonic() + timeout
    while len(list(d.glob("shards_host*.json"))) < n_hosts:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"step {step}: only "
                f"{len(list(d.glob('shards_host*.json')))}/{n_hosts} host "
                f"shard manifests landed within {timeout}s")
        time.sleep(0.05)
    _publish_json(d / "manifest.json", {
        "step": step, "keys": keys_meta, "extra": extra or {},
        "format": 2, "hosts": n_hosts,
    })


def save_sharded_checkpoint(directory, step: int, tree, *, specs=None,
                            mesh=None, extra: Optional[dict] = None,
                            timeout: float = 120.0):
    """Format-2 save: this process's shards (its slices under ``specs`` over
    the ``mesh`` shape, or with no specs everything from process 0) plus a
    shard manifest (index + checksum per shard); process 0 publishes the
    global manifest once all hosts' shard manifests exist. Every rank of
    the world calls it. Synchronous; the async wrapper is
    ``CheckpointManager(sharded=True)``."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    _write_shards(d, step, _prepare_shards(tree, specs, mesh), extra=extra,
                  timeout=timeout)
    return d


class _ShardReader:
    """Lazy, checksum-verifying reader over every host's saved shards."""

    def __init__(self, d: pathlib.Path, n_hosts: int, verify: bool):
        self.d = d
        self.verify = verify
        self.by_key: dict = {}
        self._npz: dict = {}
        for h in range(n_hosts):
            mf = d / f"shards_host{h:04d}.json"
            if not mf.exists():
                raise IOError(f"checkpoint corruption in {d}: shard manifest "
                              f"{mf.name} missing (host {h} never wrote)")
            for rec in json.loads(mf.read_text())["shards"]:
                self.by_key.setdefault(rec["key"], []).append((h, rec))

    def shard(self, host: int, rec: dict, dtype: np.dtype) -> np.ndarray:
        f = self.d / f"host{host:04d}.npz"
        if host not in self._npz:
            if not f.exists():
                raise IOError(f"checkpoint corruption in {f}: shard file "
                              f"missing")
            self._npz[host] = np.load(f)
        try:
            raw = self._npz[host][rec["npz"]]
        except Exception as e:
            raise IOError(f"checkpoint corruption in {f}: shard "
                          f"{rec['npz']!r} unreadable ({e})") from e
        if self.verify and _checksum(raw) != rec["sha"]:
            raise IOError(f"checkpoint corruption in {f}: shard "
                          f"{rec['npz']!r} fails its shard-manifest checksum")
        shape = tuple(b - a for a, b in rec["index"])
        return raw.view(dtype).reshape(shape)

    def close(self):
        for z in self._npz.values():
            z.close()

    def assemble(self, key: str, shape, dtype, index=None) -> np.ndarray:
        """Materialize ``leaf[index]`` (the whole leaf when None) by
        stitching the saved shards that overlap it; verifies full
        coverage."""
        if index is None:
            index = [[0, d] for d in shape]
        out = np.zeros(tuple(b - a for a, b in index), dtype=dtype)
        covered = 0
        for host, rec in self.by_key.get(key, ()):
            ov = [(max(ta, sa), min(tb, sb))
                  for (ta, tb), (sa, sb) in zip(index, rec["index"])]
            if any(lo >= hi for lo, hi in ov):
                continue
            data = self.shard(host, rec, dtype)
            src = tuple(slice(lo - sa, hi - sa)
                        for (lo, hi), (sa, _) in zip(ov, rec["index"]))
            dst = tuple(slice(lo - ta, hi - ta)
                        for (lo, hi), (ta, _) in zip(ov, index))
            out[dst] = data[src]
            covered += int(np.prod([hi - lo for lo, hi in ov])) if ov else 1
        want = int(np.prod(out.shape)) if out.ndim else 1
        if covered != want:
            raise IOError(
                f"checkpoint corruption in {self.d}: leaf {key!r} has "
                f"{covered}/{want} elements covered by saved shards for "
                f"index {index} (missing or overlapping host shard files)")
        return out


def _target_index(specs, mesh, rank, key, shape):
    """The [start, stop] box of ``rank``'s slice of a leaf under ``specs``
    (None: the whole leaf)."""
    from repro_torch.dist import sharding
    spec = None if specs is None else _spec_at(specs, key.split(_SEP))
    if spec is None or not any(spec):
        return None
    return sharding.shard_index(spec, shape, mesh, rank)


def restore_sharded_checkpoint(directory, step: Optional[int] = None, *,
                               specs=None, mesh=None,
                               rank: Optional[int] = None,
                               verify: bool = True, device="cuda"):
    """Restore of a format-2 checkpoint written by any number of hosts,
    placed on ``device``. Returns (tree, manifest).

    Without ``specs`` every leaf is assembled whole from the hosts' shards.
    With a target spec tree over the ``mesh`` shape each leaf comes back as
    ``rank``'s slice (this process's rank by default), assembled from only
    the saved shards that overlap it — the elastic re-mesh: the target mesh
    may differ in shape and size from the one that saved. A format-1
    checkpoint restores through ``restore_checkpoint`` (then is sliced)."""
    dev = resolve_device(device)
    base = pathlib.Path(directory)
    step = _resolve_step(base, step)
    d = base / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if rank is None:
        rank = process_index_count()[0]
    if specs is not None and mesh is None:
        raise ValueError("a spec tree needs the mesh shape it refers to")
    names = {k: m["dtype"] for k, m in manifest["keys"].items()}
    if manifest.get("format", 1) != 2:
        if specs is None:
            return restore_checkpoint(directory, step, verify=verify,
                                      device=dev)
        flat = _read_full(d, manifest, 0, verify)
        for key, a in flat.items():
            idx = _target_index(specs, mesh, rank, key, a.shape)
            if idx is not None:
                flat[key] = a[tuple(slice(lo, hi) for lo, hi in idx)]
        return _unflatten(flat, names, dev), manifest
    reader = _ShardReader(d, int(manifest.get("hosts", 1)), verify)
    try:
        flat = {}
        for key, meta in manifest["keys"].items():
            shape = tuple(meta["shape"])
            flat[key] = reader.assemble(
                key, shape, _carrier(meta["dtype"]),
                _target_index(specs, mesh, rank, key, shape))
    finally:
        reader.close()
    return _unflatten(flat, names, dev), manifest


# ---------------------------------------------------------------------------
# directory queries + async manager
# ---------------------------------------------------------------------------

def list_steps(directory) -> list:
    """Steps with a published manifest, ascending (partial saves excluded)."""
    base = pathlib.Path(directory)
    if not base.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in base.glob("step_*")
                  if (p / "manifest.json").exists())


def latest_step(directory) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _host_id_of(name: str) -> int:
    """Host id embedded in a shard filename (``host0003.npz`` /
    ``shards_host0003.json`` -> 3); -1 if the name doesn't parse."""
    stem = name.split(".")[0]
    digits = stem[len("shards_host"):] if stem.startswith("shards_host") \
        else stem[len("host"):]
    try:
        return int(digits)
    except ValueError:
        return -1


class CheckpointManager:
    """Async save + retention. ``save()`` copies every leaf to host memory
    synchronously (the caller may then change or free its tensors) and
    returns; file writes run on a background thread, at most one in flight
    (``wait()`` joins, and re-raises a failed write).

    ``sharded=True`` writes format 2 (every rank calls ``save`` and
    ``wait`` at the same step), each rank its slices under ``specs`` over
    the ``mesh`` shape when given. Retention (gc) then runs per host: each
    host unlinks its own shard files (process 0 uncommits the manifest
    first and sweeps shards of hosts beyond the current count). ``restore``
    places tensors on ``device`` (the card unless ``device="cpu"``): whole,
    or one rank's slices under target specs (``dist.fault.remesh_restore``).
    """

    def __init__(self, directory, keep: int = 3, *, sharded: bool = False,
                 device="cuda", specs=None, mesh=None):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self.sharded = sharded
        self.device = device
        self.specs = specs
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extra=None):
        self.wait()
        d = self.dir / f"step_{step:08d}"
        d.mkdir(parents=True, exist_ok=True)
        if self.sharded:
            prepared = _prepare_shards(tree, self.specs, self.mesh)  # sync

            def _write():
                _write_shards(d, step, prepared, extra=extra, timeout=120.0)
        else:
            snap = _snapshot(tree)             # sync: QTensor components too

            def _write():
                _write_full(d, step, snap, host_id=0, extra=extra,
                            verify=True)

        def _work():
            try:
                with obs.trace_span("ckpt.save", step=step,
                                    sharded=self.sharded,
                                    hist=obs.histogram(
                                        "ckpt_save_seconds",
                                        "Checkpoint write latency")):
                    _write()
                self._gc()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight save. A failure on the writer thread re-raises
        HERE — callers that treat a returned wait() as "the checkpoint is
        durable" (run_resilient, PreemptionGuard.drain) must not be lied to
        by a dead thread."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise IOError(f"async checkpoint save failed: {e}") from e

    def restore(self, step=None, *, specs=None, mesh=None,
                verify: bool = True):
        """Checksum-verifying restore (corruption raises IOError naming the
        file) onto the manager's device: whole tensors, or this rank's
        slices under target ``specs`` over the ``mesh`` shape."""
        dev = resolve_device(self.device)
        self.wait()  # an in-flight async save must land before we read
        with obs.trace_span("ckpt.restore", hist=obs.histogram(
                "ckpt_restore_seconds", "Checkpoint restore latency")):
            if self.sharded or specs is not None:
                return restore_sharded_checkpoint(self.dir, step, specs=specs,
                                                  mesh=mesh, verify=verify,
                                                  device=dev)
            return restore_checkpoint(self.dir, step, verify=verify,
                                      device=dev)

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*"))
        drop = steps[:-self.keep]
        if drop:
            obs.counter("ckpt_gc_sweeps_total",
                        "Retention sweeps that removed old steps").inc()
        if not self.sharded:
            for p in drop:
                for f in p.iterdir():
                    f.unlink()
                p.rmdir()
            return
        pid, nproc = process_index_count()
        for p in drop:
            if pid == 0:
                # uncommit FIRST: list_steps/restore key on the manifest, so
                # once it is gone no reader can race the per-host unlinks
                # below into a partial restore
                (p / "manifest.json").unlink(missing_ok=True)
            (p / f"host{pid:04d}.npz").unlink(missing_ok=True)
            (p / f"shards_host{pid:04d}.json").unlink(missing_ok=True)
            if pid == 0:
                # sweep shards of host ids beyond the current count (a save
                # from more hosts leaves files no live process owns)
                for f in p.glob("*host*.npz"):
                    if _host_id_of(f.name) >= nproc:
                        f.unlink(missing_ok=True)
                for f in p.glob("shards_host*.json"):
                    if _host_id_of(f.name) >= nproc:
                        f.unlink(missing_ok=True)
            try:
                p.rmdir()   # whichever host unlinks last wins the rmdir;
            except OSError:  # still-populated (peer mid-gc) is fine — the
                pass         # directory is retried on the next gc cycle
