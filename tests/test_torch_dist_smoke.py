"""The port's multi-process smoke, run locally: ``repro_torch.launch.dist_smoke``
as real child processes on the CPU (gloo), as ``tests/test_dist_smoke.py``
drives the reference's.

- one process (a world of one): the mapped search with 1 island equal to
  the sequential engine bit for bit, the obs aggregate, and a format-2
  checkpoint restored onto another mesh shape and whole;
- two processes over one ``file://`` store: the same checks with the
  mapped search's 2 islands on 2 ranks, a migration, byte-identical merged
  snapshots, and shards written by BOTH processes.
"""
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
CMD = [sys.executable, "-m", "repro_torch.launch.dist_smoke", "--device",
       "cpu", "--steps", "3", "--migrate-every", "2"]


def test_dist_smoke_single_process(tmp_path):
    proc = subprocess.run(CMD + ["--ckpt-dir", str(tmp_path)], env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\n--- stdout ---\n{proc.stdout}\n"
        f"--- stderr ---\n{proc.stderr}")
    assert "mapped parity OK: 1 islands" in proc.stdout
    assert "obs aggregation OK: 1 process(es)" in proc.stdout
    assert "sharded ckpt OK" in proc.stdout
    assert "DIST_SMOKE_OK process=0/1" in proc.stdout


def test_dist_smoke_two_processes(tmp_path):
    common = ["--coordinator", f"file://{tmp_path}/store",
              "--num-processes", "2", "--ckpt-dir", str(tmp_path / "ck"),
              "--metrics-out", str(tmp_path / "metrics.json")]
    p1 = subprocess.Popen(CMD + common + ["--process-id", "1"], env=ENV,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    try:
        p0 = subprocess.run(CMD + common + ["--process-id", "0"], env=ENV,
                            capture_output=True, text=True, timeout=300)
        out1, _ = p1.communicate(timeout=120)
    except Exception:
        p1.kill()
        raise
    assert p0.returncode == 0, (
        f"proc0 rc={p0.returncode}\n--- stdout ---\n{p0.stdout}\n"
        f"--- stderr ---\n{p0.stderr}\n--- proc1 ---\n{out1}")
    assert p1.returncode == 0, f"proc1 rc={p1.returncode}\n{out1}"
    assert "mapped parity OK: 2 islands x 3 steps, 1 migrations" in p0.stdout
    assert "widgets=21, identical snapshots" in p0.stdout
    assert "DIST_SMOKE_OK process=0/2" in p0.stdout
    assert "DIST_SMOKE_OK process=1/2" in out1
    assert (tmp_path / "metrics.json").exists()
    step = tmp_path / "ck" / "step_00000001"
    assert sorted(p.name for p in step.iterdir()) == [
        "host0000.npz", "host0001.npz", "manifest.json",
        "shards_host0000.json", "shards_host0001.json"]
