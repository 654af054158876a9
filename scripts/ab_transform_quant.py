"""Time this tree's ``transform_quant`` kernels against another build of the
kernel source, on one CUDA card, in turns (other, this, this, other).

    git show <rev>:src/repro_torch/csrc/transform_quant.cu > build/ab/tq_other.cu
    git show <rev>:src/repro_torch/csrc/quant_common.cuh > build/ab/quant_common.cuh
    python3 scripts/ab_transform_quant.py build/ab/tq_other.cu

The other source must export the single entry point of the first CUDA port
(``rq_transform_quant(w, pi, svec, cos, sin, fq, scale, zero, k, n, group,
bits, mode, stream)``, mode 0 up, 1 down). At opt-1.3b's FFN shapes (up
(2048, 8192), down (8192, 2048), 2-bit g32) and an identity, a partially
shuffled and a random pi, both builds are held bit for bit to the plain
version, then timed: the median of CUDA-event timings of one launch (ms)
and the kernel's own time under ``torch.profiler`` (device ms). Prints the
``nvidia-smi`` name/power-limit line and one JSON line per (mode, pi).
"""
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

tq = importlib.import_module("repro_torch.kernels.transform_quant")

D, F, BITS, GROUP = 2048, 8192, 2, 32


def load_other(source: Path):
    """Build ``source`` with the port's nvcc flags next to it; its entry."""
    lib = source.with_suffix(".so")
    subprocess.run([build._nvcc(), *build._flags("transform_quant"), "-o",
                    str(lib), str(source)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).rq_transform_quant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = load_other(Path(argv[0]).resolve())
    build.build_all(("transform_quant",))
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sv = 1.0 + 0.05 * torch.randn(F, generator=gen, device=dev)
    phi = 1e-2 * torch.randn(F // 2, generator=gen, device=dev)
    cos, sin = torch.cos(phi), torch.sin(phi)
    for mode in ("up", "down"):
        w = torch.randn((D, F) if mode == "up" else (F, D), generator=gen,
                        device=dev)
        K, N = w.shape
        svec = sv if mode == "up" else 1.0 / sv
        plan = tq.plan(K, N, GROUP, mode)
        bound, _ = cs.bound_ms(cs.tq_bytes(K, N, GROUP, F), cs.TQ_OPS * K * N)
        for kind in cs.PI_KINDS:
            pi = cs.make_pi(torch, kind, F, gen, dev)
            outs = {k: (torch.empty_like(w), torch.empty((K // GROUP, N),
                                                         device=dev),
                        torch.empty((K // GROUP, N), device=dev))
                    for k in ("other", "this")}

            def run_other():
                fq, s, z = outs["other"]
                rc = other(w.data_ptr(), pi.data_ptr(), svec.data_ptr(),
                           cos.data_ptr(), sin.data_ptr(), fq.data_ptr(),
                           s.data_ptr(), z.data_ptr(), K, N, GROUP, BITS,
                           0 if mode == "up" else 1,
                           torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"other build: CUDA error {rc}")

            def run_this():
                fq, s, z = outs["this"]
                tq.launch(w, pi, svec, cos, sin, fq, s, z, bits=BITS,
                          group=GROUP, mode=mode, plan=plan)
            want = ref.transform_quant_ref(w, pi, sv, phi, bits=BITS,
                                           group=GROUP, mode=mode)
            row = {"mode": mode, "pi": kind, "shape": [K, N],
                   "plan": plan._asdict(), "bound_ms": bound}
            for k, fn in (("other", run_other), ("this", run_this)):
                fn()
                cs.exact(torch, outs[k], want, f"{k} {mode} {kind}")
                row[f"{k}_ms"], row[f"{k}_device_ms"] = [], []
            for k in ("other", "this", "this", "other"):
                fn = run_other if k == "other" else run_this
                row[f"{k}_ms"].append(cs.time_ms(torch, fn, warmup=5,
                                                 reps=50))
                row[f"{k}_device_ms"].append(cs.device_ms(
                    torch, fn, ("transform_quant",), calls=30))
            print("ab: " + json.dumps(row), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
