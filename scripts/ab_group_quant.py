"""Time this tree's ``group_quant`` kernel against another build of the
kernel source, on one CUDA card, in turns (other, this, this, other).

    mkdir -p build/ab
    git show <rev>:src/repro_torch/csrc/group_quant.cu > build/ab/gq_other.cu
    git show <rev>:src/repro_torch/csrc/quant_common.cuh > build/ab/quant_common.cuh
    python3 scripts/ab_group_quant.py build/ab/gq_other.cu

The other source must export the entry point this tree's does
(``rq_group_quant(w, fq, scale, zero, k, n, group, bits, dtype,
round_range, stream)``). At the shapes the main path gives the kernel
(``SHAPES``: opt-1.3b's stacked leaves, the zoo's largest stacks, the
per-layer matrices AWQ quantizes once per candidate, a per-column group),
in f32 and bf16 (``round_range`` on, as ``core.quant.fake_quant`` calls
it), 2-bit, both builds are held bit for bit to the plain version, then
timed: the median of CUDA-event timings of one launch (ms) and the
kernel's own time under ``torch.profiler`` (device ms), beside the bytes
bound. Prints the ``nvidia-smi`` name/power-limit line, then one JSON line
per (shape, dtype).
"""
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

gq = importlib.import_module("repro_torch.kernels.group_quant")

BITS = 2
# (label, (K, N), group; None: 32)
SHAPES = (
    ("opt-1.3b attn stack", (49152, 2048), None),
    ("opt-1.3b up stack", (49152, 8192), None),
    ("opt-1.3b down stack", (196608, 2048), None),
    ("seamless stack", (12288, 4096), None),
    ("internvl2 up stack", (21504, 4864), None),
    ("qwen3-4b up stack", (92160, 9728), None),
    ("layer attn", (2048, 2048), None),
    ("layer up", (2048, 8192), None),
    ("qwen3-4b layer up", (2560, 9728), None),
    ("internvl2 layer up", (896, 4864), None),
    ("per-column", (2048, 2048), 2048),
)


def load_other(source: Path):
    """Build ``source`` with the port's nvcc flags next to it; its entry."""
    lib = source.with_suffix(".so")
    subprocess.run([build._nvcc(), *build._flags("group_quant"), "-o",
                    str(lib), str(source)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).rq_group_quant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = load_other(Path(argv[0]).resolve())
    build.build_all(("group_quant",))
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    for label, (K, N), group in SHAPES:
        group = group or 32
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn((K, N), generator=gen, device=dev) * 2.5).to(dtype)
            rr = dtype == torch.bfloat16
            outs = {k: (torch.empty_like(w), torch.empty((K // group, N),
                                                         device=dev),
                        torch.empty((K // group, N), device=dev))
                    for k in ("other", "this")}

            def run_other():
                fq, s, z = outs["other"]
                rc = other(w.data_ptr(), fq.data_ptr(), s.data_ptr(),
                           z.data_ptr(), K, N, group, BITS,
                           1 if dtype == torch.bfloat16 else 0, int(rr),
                           torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"other build: CUDA error {rc}")

            def run_this():
                gq.launch(w, *outs["this"], bits=BITS, group=group,
                          round_range=rr)
            want = ref.group_quant_ref(w, BITS, group, round_range=rr)
            bound, by = cs.bound_ms(cs.gq_bytes(K, N, group, w.element_size()),
                                    cs.GQ_OPS * K * N)
            row = {"shape": label, "K": K, "N": N, "group": group,
                   "dtype": str(dtype), "round_range": rr,
                   "plan": gq.plan(K, N, group, dtype)._asdict(),
                   "bound_ms": bound, "bound_by": by}
            for k, fn in (("other", run_other), ("this", run_this)):
                fn()
                cs.exact(torch, outs[k], want, f"{k} {label} {dtype}")
                row[f"{k}_ms"], row[f"{k}_device_ms"] = [], []
            del want
            for k in ("other", "this", "this", "other"):
                fn = run_other if k == "other" else run_this
                row[f"{k}_ms"].append(cs.time_ms(torch, fn, warmup=5,
                                                 reps=50))
                row[f"{k}_device_ms"].append(cs.device_ms(
                    torch, fn, ("group_quant",), calls=30))
            for k in ("other", "this"):     # by the mean of the two turns
                row[f"{k}_share_of_bound"] = bound / statistics.mean(
                    row[f"{k}_device_ms"])
            print("ab: " + json.dumps(row), flush=True)
            del w, outs
            torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
