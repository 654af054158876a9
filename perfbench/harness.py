"""What every run of the benchmark shares: finding a cell's configuration,
traffic mix, metric readers and limits by the names in ``BENCHMARK.json``;
the model's sizes; the environment a run keeps its caches in; the checks
that end a run; and the result line.

Nothing here imports the program: ``run.py`` puts the checkout's ``src/``
on the path and the drivers import ``repro_torch`` themselves.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass(frozen=True)
class Arch:
    """A dense decoder's sizes, as a configuration file's ``model`` gives
    them (the port's ``ModelConfig`` field names)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    activation: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    use_bias: bool = False
    pos_emb: str = "rope"
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    vocab_pad_multiple: int = 256
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One ``workloads`` entry with what its names point to."""

    name: str
    entry: dict
    config: dict          # perfbench/configs/<config>.json
    arch: Arch
    traffic: dict         # perfbench/traffic/<traffic>.json
    limits: dict          # perfbench/checks/<cell>.json
    end_to_end: list      # this cell's end-to-end metric entries
    per_layer: list       # this cell's per-layer metric entries


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None):
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(known: {sorted(cells)})")
    entry = cells[name]
    cfg_file = {c["name"]: c for c in bench["configs"]}[entry["config"]]["file"]
    return make_cell(entry, root / cfg_file, root,
                     [m for m in bench["end_to_end"] if _applies(m, name)],
                     [m for m in bench["per_layer"] if _applies(m, name)])


def make_cell(entry: dict, cfg_file: Path, root: Path, end_to_end,
              per_layer) -> Cell:
    config = load_json(cfg_file)
    here = root / "perfbench"
    return Cell(
        name=entry["name"], entry=entry, config=config,
        arch=Arch(**config["model"]),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(here / "checks" / f"{entry['name']}.json"),
        end_to_end=end_to_end, per_layer=per_layer)


def reader(name: str):
    """The ``read(record)`` function of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """The module ``perfbench/drivers/<name>.py``: its ``run(ctx)`` drives a
    run, its ``check(ctx, ...)`` works out the compared numbers."""
    return importlib.import_module(f"perfbench.drivers.{name}")


def cache_env(root: Path = ROOT) -> None:
    """Keep every build and kernel cache at fixed paths inside the checkout
    (the port builds its kernels into ``build/kernels``; these cover any
    other build tool). Set before torch is imported."""
    cache = root / "build" / "perfbench" / "cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def few_threads() -> None:
    """One process with few threads: the host's part of every step is one
    Python thread launching work on the card, and an idle pool of CPU
    threads spinning beside it only adds noise. Set before torch is
    imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that the run must not have
    loaded, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every compared number at or
    under its limit. A number the run did not produce is a failure."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks
