"""Port parity: checkpoints (``repro_torch.ckpt``) and fault tolerance
(``repro_torch.dist.fault``) against the JAX reference.

- Formats 1 and 2 are interchangeable: a checkpoint either package writes
  restores in the other, bit for bit, with f32, bf16, int32 and ``QTensor``
  leaves, None, and a ``(params, opt_state)`` tuple; both write the same
  manifests (keys, shapes, dtype names, sha256[:16]) and the same payload
  bytes. One exception is the reference's own: its ``restore_checkpoint``
  cannot read a bf16 leaf of a format-1 checkpoint, its own included (numpy
  stores bf16 as 2-byte void words and ``jnp.asarray`` refuses them), so
  port-written format-1 bf16 is held to the reference's bytes and read back
  in JAX through format 2.
- A JAX format-2 checkpoint written on a 2×2 mesh of 4 CPU devices (a
  child process, as ``tests/test_ckpt_sharded.py`` does) assembles in the
  port, as written and with its shards split over two fake hosts.
- Corruption names the file; the manager's async save, gc, ``keep`` and
  ``wait()`` re-raising; ``run_resilient`` recovery and its skip of a
  corrupt newest step; the watchdog; ``PreemptionGuard`` on SIGTERM.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.ckpt import checkpoint as jck
from repro.core.quant import QTensor as JQTensor
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.quant import quantize_tensor as jquantize_tensor
from repro.dist.fault import run_resilient as jrun_resilient
from repro_torch import obs
from repro_torch.ckpt import checkpoint as tck
from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import QTensor
from repro_torch.dist.fault import PreemptionGuard, StepWatchdog, run_resilient

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# one tree in both packages
# ---------------------------------------------------------------------------

def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "w": jnp.asarray(rng.normal(size=(8, 4)).astype(np.float32)),
        "emb": {"b16": jnp.asarray(rng.normal(size=(6, 4)).astype(np.float32)
                                   ).astype(jnp.bfloat16),
                "ids": jnp.arange(6, dtype=jnp.int32).reshape(2, 3)},
        "qt": jquantize_tensor(jnp.asarray(rng.normal(size=(64, 8)).astype(np.float32)),
                               JQuantConfig(bits=2, group_size=32)),
        "none": None,
    }
    opt = {"m": {"w": jnp.asarray(rng.normal(size=(8, 4)).astype(np.float32))},
           "step": jnp.int32(7)}
    return (params, opt)


def _to_port(tree):
    """The reference tree -> the port's, leaf for leaf (tuples, None and
    QTensors included)."""
    if isinstance(tree, tuple):
        return tuple(_to_port(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, JQTensor):
        return params_from_numpy({"q": jax.tree.map(np.asarray, tree)}, device="cpu")["q"]
    return params_from_numpy({"x": np.asarray(tree)}, device="cpu")["x"]


def _bits(x):
    """numpy bits of a port tensor or a reference array (bf16 as uint16,
    uint32 words as int32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return a, str(a.dtype)


def assert_same(port, ref, path="tree"):
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_same(p, r, f"{path}/{i}")
    elif isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), path
        for k in ref:
            assert_same(port[k], ref[k], f"{path}/{k}")
    elif ref is None:
        assert port is None, path
    elif isinstance(ref, JQTensor):
        assert isinstance(port, QTensor), path
        assert (port.bits, port.group_size, tuple(port.shape)) == \
            (ref.bits, ref.group_size, tuple(ref.shape)), path
        for name in ("packed", "scale", "zero"):
            assert_same(getattr(port, name), getattr(ref, name), f"{path}.{name}")
    else:
        (a, da), (b, db) = _bits(port), _bits(ref)
        assert da == db and a.shape == b.shape, (path, da, db, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _without_bf16(tree):
    params, opt = tree
    params = dict(params, emb={"ids": params["emb"]["ids"]})
    return (params, opt)


# ---------------------------------------------------------------------------
# format 1 and format 2, both ways
# ---------------------------------------------------------------------------

def test_jax_format1_restores_in_the_port(tmp_path):
    jt = _jax_tree()
    jck.save_checkpoint(tmp_path, 5, jt, extra={"note": "jax"})
    tree, manifest = tck.restore_checkpoint(tmp_path, device="cpu")
    assert manifest["step"] == 5 and manifest["extra"] == {"note": "jax"}
    assert_same(tree, jt)
    assert tree[0]["qt"].packed.dtype == torch.int32


def test_port_format1_restores_in_jax(tmp_path):
    jt = _without_bf16(_jax_tree(1))
    tck.save_checkpoint(tmp_path, 6, _to_port(jt))
    tree, manifest = jck.restore_checkpoint(tmp_path)
    assert manifest["step"] == 6 and manifest["format"] == 1
    assert_same(_to_port(tree), jt)
    assert tree[0]["qt"].packed.dtype == jnp.uint32


def test_reference_cannot_read_bf16_format1_its_own_included(tmp_path):
    """The reference fault the port works around (module docstring)."""
    jck.save_checkpoint(tmp_path / "j", 1, {"b": jnp.ones(3, jnp.bfloat16)})
    tck.save_checkpoint(tmp_path / "t", 1, {"b": torch.ones(3, dtype=torch.bfloat16)})
    for d in ("j", "t"):
        with pytest.raises(TypeError, match="V2"):
            jck.restore_checkpoint(tmp_path / d)
        tree, _ = tck.restore_checkpoint(tmp_path / d, device="cpu")
        assert tree["b"].dtype == torch.bfloat16 and bool((tree["b"] == 1).all())


def _members(npz):
    with np.load(npz) as z:
        return {k: (z[k].shape, z[k].dtype.itemsize, z[k].tobytes()) for k in z.files}


@pytest.mark.parametrize("fmt", [1, 2])
def test_both_packages_write_the_same_manifest_and_bytes(tmp_path, fmt):
    jt = _jax_tree(2)
    save = {1: (jck.save_checkpoint, tck.save_checkpoint),
            2: (jck.save_sharded_checkpoint, tck.save_sharded_checkpoint)}[fmt]
    dj = save[0](tmp_path / "j", 3, jt, extra={"k": 1})
    dt = save[1](tmp_path / "t", 3, _to_port(jt), extra={"k": 1})
    mj = json.loads((dj / "manifest.json").read_text())
    mt = json.loads((dt / "manifest.json").read_text())
    assert mt == mj
    assert mj["keys"]["__0/emb/b16"]["dtype"] == "bfloat16"
    assert mj["keys"]["__0/qt/__qt_packed"]["dtype"] == "uint32"
    assert _members(dt / "host0000.npz") == _members(dj / "host0000.npz")
    if fmt == 2:
        assert json.loads((dt / "shards_host0000.json").read_text()) == \
            json.loads((dj / "shards_host0000.json").read_text())


def test_format2_both_ways(tmp_path):
    jt = _jax_tree(3)
    jck.save_sharded_checkpoint(tmp_path / "j", 2, jt)
    tree, manifest = tck.restore_sharded_checkpoint(tmp_path / "j", device="cpu")
    assert manifest["format"] == 2 and manifest["hosts"] == 1
    assert_same(tree, jt)
    # restore_checkpoint reads format 2 too
    assert_same(tck.restore_checkpoint(tmp_path / "j", device="cpu")[0], jt)
    tck.save_sharded_checkpoint(tmp_path / "t", 2, _to_port(jt))
    back, _ = jck.restore_sharded_checkpoint(tmp_path / "t", None, None)
    assert_same(_to_port(back), jt)


_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.ckpt.checkpoint import save_sharded_checkpoint
from repro.core.quant import QuantConfig, quantize_tensor
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
rng = np.random.default_rng(0)
w = rng.normal(size=(8, 16)).astype(np.float32)
b = rng.normal(size=(4, 8)).astype(np.float32)
qt = quantize_tensor(jnp.asarray(rng.normal(size=(64, 8)).astype(np.float32)),
                     QuantConfig(bits=2, group_size=32))
put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
tree = {"w": put(w, P("data", "model")),
        "b16": put(jnp.asarray(b).astype(jnp.bfloat16), P(None, "model")),
        "qt": jax.tree.map(lambda x: put(x, P(None, "model")), qt),
        "t": (jnp.arange(4.0), None)}
save_sharded_checkpoint(sys.argv[1], 3, tree)
np.savez(sys.argv[2], w=w, b16=np.asarray(tree["b16"]).view(np.uint16),
         packed=np.asarray(qt.packed), scale=np.asarray(qt.scale),
         zero=np.asarray(qt.zero))
print("OK")
"""


@pytest.fixture(scope="module")
def jax_mesh_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp / "ck"),
                           str(tmp / "want.npz")], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr
    with np.load(tmp / "want.npz") as z:
        want = {k: z[k] for k in z.files}
    return tmp / "ck", want


def _split_onto_two_hosts(step_dir):
    """Give every second shard record of host 0 to a fake host 1 (its npz a
    copy of host 0's, so it holds the entries its records name)."""
    recs = json.loads((step_dir / "shards_host0000.json").read_text())["shards"]
    h0, h1 = recs[0::2], recs[1::2]
    shutil.copy(step_dir / "host0000.npz", step_dir / "host0001.npz")
    (step_dir / "shards_host0000.json").write_text(json.dumps({"host": 0, "shards": h0}))
    (step_dir / "shards_host0001.json").write_text(json.dumps({"host": 1, "shards": h1}))
    m = json.loads((step_dir / "manifest.json").read_text())
    (step_dir / "manifest.json").write_text(json.dumps(dict(m, hosts=2)))
    return len(h0), len(h1)


@pytest.mark.parametrize("hosts", [1, 2])
def test_jax_mesh_format2_assembles_in_the_port(jax_mesh_ckpt, tmp_path, hosts):
    src, want = jax_mesh_ckpt
    d = tmp_path / "ck"
    shutil.copytree(src, d)
    if hosts == 2:
        n0, n1 = _split_onto_two_hosts(d / "step_00000003")
        assert n0 > 0 and n1 > 0
    tree, manifest = tck.restore_sharded_checkpoint(d, device="cpu")
    assert manifest["hosts"] == hosts
    np.testing.assert_array_equal(tree["w"].numpy(), want["w"])
    assert tree["b16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["b16"].view(torch.int16).numpy().view(np.uint16),
                                  want["b16"])
    np.testing.assert_array_equal(tree["qt"].packed.numpy(), want["packed"].view(np.int32))
    np.testing.assert_array_equal(tree["qt"].scale.numpy(), want["scale"])
    np.testing.assert_array_equal(tree["qt"].zero.numpy(), want["zero"])
    assert tree["t"][1] is None and tree["t"][0].tolist() == [0.0, 1.0, 2.0, 3.0]
    # a host whose shard manifest is lost is named
    if hosts == 2:
        (d / "step_00000003" / "shards_host0001.json").unlink()
        with pytest.raises(IOError, match="shards_host0001.json"):
            tck.restore_sharded_checkpoint(d, device="cpu")


# ---------------------------------------------------------------------------
# corruption, the manager, gc
# ---------------------------------------------------------------------------

def _flip(f):
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))


@pytest.mark.parametrize("sharded", [False, True], ids=["format1", "format2"])
def test_corruption_names_the_file(tmp_path, sharded):
    mgr = tck.CheckpointManager(tmp_path, sharded=sharded, device="cpu")
    mgr.save(4, {"w": torch.arange(4096.0)})
    mgr.wait()
    _flip(tmp_path / "step_00000004" / "host0000.npz")
    with pytest.raises(IOError, match="host0000.npz"):
        mgr.restore(4)


def test_checksum_mismatch_names_file_and_leaf(tmp_path):
    d = tck.save_checkpoint(tmp_path, 1, {"w": torch.arange(8.0)})
    arr = np.arange(8.0, dtype=np.float32)
    arr[3] = -1.0                  # a readable file with other values
    np.savez(tmp_path / "bad", w=arr)
    shutil.copy(tmp_path / "bad.npz", d / "host0000.npz")
    with pytest.raises(IOError, match=r"host0000.npz: leaf 'w' fails"):
        tck.restore_checkpoint(tmp_path, 1, device="cpu")


def test_manager_async_gc_keep_and_restore(tmp_path):
    before = obs.counter("ckpt_bytes_written_total").value()
    mgr = tck.CheckpointManager(tmp_path, keep=2, device="cpu")
    for step in (1, 2, 3, 4):
        mgr.save(step, {"w": torch.full((4,), float(step))})
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert tck.list_steps(tmp_path) == [3, 4] and tck.latest_step(tmp_path) == 4
    tree, manifest = mgr.restore()
    assert manifest["step"] == 4 and float(tree["w"][0]) == 4.0
    assert obs.counter("ckpt_bytes_written_total").value() > before
    assert obs.histogram("ckpt_save_seconds").count() >= 4


def test_manager_snapshot_is_taken_at_save(tmp_path):
    """The caller may change its tensors once save() returns."""
    mgr = tck.CheckpointManager(tmp_path, device="cpu")
    w = torch.zeros(1 << 16)
    mgr.save(1, {"w": w})
    w += 1
    mgr.wait()
    assert float(mgr.restore(1)[0]["w"].abs().max()) == 0.0


def test_manager_wait_surfaces_async_save_failure(tmp_path, monkeypatch):
    mgr = tck.CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, {"w": torch.ones(3)})
    mgr.wait()

    def boom(*a, **kw):
        raise TimeoutError("disk went away")

    monkeypatch.setattr(tck, "_write_full", boom)
    mgr.save(2, {"w": torch.ones(3)})
    with pytest.raises(IOError, match="async checkpoint save failed"):
        mgr.wait()
    monkeypatch.undo()
    mgr.save(3, {"w": torch.ones(3)})     # the error is consumed
    mgr.wait()
    assert tck.list_steps(tmp_path) == [1, 3]


def test_manager_roundtrips_a_train_state_with_qtensor_and_bf16(tmp_path):
    jt = _jax_tree(4)
    mgr = tck.CheckpointManager(tmp_path, device="cpu")
    mgr.save(9, _to_port(jt))
    restored, manifest = mgr.restore(9)
    assert manifest["step"] == 9
    assert_same(restored, jt)


def test_manager_sharded_gc_is_per_host(tmp_path, monkeypatch):
    """Each host unlinks only its own shard files; process 0 uncommits the
    manifest first and the last host wins the rmdir."""
    for step in (1, 2, 3):
        d = tck.save_sharded_checkpoint(tmp_path, step, {"w": torch.ones(4)})
        shutil.copy(d / "host0000.npz", d / "host0001.npz")
        shutil.copy(d / "shards_host0000.json", d / "shards_host0001.json")
    mgr = tck.CheckpointManager(tmp_path, keep=2, sharded=True, device="cpu")
    old = tmp_path / "step_00000001"
    monkeypatch.setattr(tck, "process_index_count", lambda: (1, 2))
    mgr._gc()
    assert not (old / "host0001.npz").exists()
    assert (old / "manifest.json").exists() and (old / "host0000.npz").exists()
    monkeypatch.setattr(tck, "process_index_count", lambda: (0, 2))
    mgr._gc()
    assert not old.exists()
    assert tck.list_steps(tmp_path) == [2, 3]


def test_manager_sharded_gc_sweeps_shrunk_hosts(tmp_path):
    for step in (1, 2, 3):
        tck.save_sharded_checkpoint(tmp_path, step, {"w": torch.ones(4)})
    d = tmp_path / "step_00000001"
    for h in (1, 2):
        shutil.copy(d / "host0000.npz", d / f"host{h:04d}.npz")
        shutil.copy(d / "shards_host0000.json", d / f"shards_host{h:04d}.json")
    tck.CheckpointManager(tmp_path, keep=2, sharded=True, device="cpu")._gc()
    assert not d.exists() and tck.list_steps(tmp_path) == [2, 3]


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def _counting_step(fail_at):
    armed = {"on": True}

    def step_fn(state, step):
        if step == fail_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")
        return {"w": state["w"] + 1}

    return step_fn


def test_run_resilient_recovers_like_the_reference(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "t", device="cpu")
    state, events = run_resilient(_counting_step(7), {"w": torch.zeros(())},
                                  n_steps=10, ckpt=mgr, save_every=5)
    jmgr = jck.CheckpointManager(tmp_path / "j")
    jstate, jevents = jrun_resilient(_counting_step(7), {"w": jnp.zeros(())},
                                     n_steps=10, ckpt=jmgr, save_every=5)
    assert float(state["w"]) == float(jstate["w"]) == 10.0
    assert events == jevents
    assert ("restored", 5) in events


def test_run_resilient_skips_a_corrupt_newest_step(tmp_path):
    mgr = tck.CheckpointManager(tmp_path, device="cpu")
    armed = {"on": True}

    def step_fn(state, step):
        if step == 8 and armed["on"]:
            armed["on"] = False
            mgr.wait()
            _flip(tmp_path / "step_00000006" / "host0000.npz")
            raise RuntimeError("failure that also corrupted the newest save")
        return {"w": state["w"] + torch.ones(256)}

    state, events = run_resilient(step_fn, {"w": torch.zeros(256)}, n_steps=10,
                                  ckpt=mgr, save_every=3)
    kinds = [e[0] for e in events]
    assert "corrupt_ckpt" in kinds and ("restored", 3) in events
    assert float(state["w"][0]) == 10.0


def test_watchdog_flags_a_straggler():
    wd = StepWatchdog(threshold=2.0)
    for _ in range(10):
        assert wd.observe(0.1) is False
    assert wd.observe(0.5) is True
    assert wd.flagged == 1 and wd.stats()["warmed_up"]
    assert wd.median_step == pytest.approx(0.1)


def test_preemption_guard_drains_on_sigterm(tmp_path):
    mgr = tck.CheckpointManager(tmp_path, device="cpu")

    def step_fn(state, step):
        if step == 3:
            signal.raise_signal(signal.SIGTERM)
        return {"w": state["w"] + 1}

    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        state, events = run_resilient(step_fn, {"w": torch.zeros(())},
                                      n_steps=10, ckpt=mgr, save_every=0,
                                      preemption=guard)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert events[-2:] == [("saved", 4), ("preempted", 4)]
    assert float(state["w"]) == 4.0
    assert float(mgr.restore()[0]["w"]) == 4.0
