"""Time this tree's ``quant_matmul`` and per-query-head paged-decode kernels
against another build of their sources, on one CUDA card, in turns (other,
this, this, other).

    mkdir -p build/ab/other
    for f in quant_matmul.cu paged_decode.cu decode_attention.cuh split_decode.cuh; do
        git show <rev>:src/repro_torch/csrc/$f > build/ab/other/$f
    done
    python3 scripts/ab_decode_matmul.py build/ab/other

The other directory must hold a ``quant_matmul.cu`` exporting the entry of
the first CUDA port (``rq_quant_matmul(x, packed, scale, zero, out, M, K,
N, W, group, bits, x_dtype, stream)``, one launch) and a ``paged_decode.cu``
(with the headers it includes) exporting the first per-query-head entry
(``rq_paged_decode_head(q, k, v, ks, vs, bt, lens, out, m, l, B, H, Hkv,
Dh, psz, P, normalize, kv_dtype, quant, scale, stream)``). Both are built
with this tree's nvcc flags.

``quant_matmul`` at every case ``chip_smoke.py`` times (``QM_SHAPES``, f32
x); the per-query-head route at the paged server's decode shape (B 8,
opt-1.3b's 32 heads of 64, page size 16, the 8-tenant trace's lengths), at
B 8 x 1024 and at B 1 x 8192 (f32 pools). Both builds are held to the plain
version (5e-4 and 1e-5, the reference's bars), then timed: the median of
CUDA-event timings of one call (ms) and the kernels' own time under
``torch.profiler`` (device ms), beside ``torch.matmul`` on the dequantised
weights for ``quant_matmul``. Prints the ``nvidia-smi`` name/power-limit line
and one JSON line per case.
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

qm = importlib.import_module("repro_torch.kernels.quant_matmul")
pd = importlib.import_module("repro_torch.kernels.paged_decode")

_P, _I = ctypes.c_void_p, ctypes.c_int
OTHER_SIG = {
    "quant_matmul": ("rq_quant_matmul", [_P] * 5 + [_I] * 7 + [_P]),
    "paged_decode": ("rq_paged_decode_head",
                     [_P] * 10 + [_I] * 9 + [ctypes.c_float, _P]),
}
# device-kernel name fragments of each build's launches
NAMES = {"quant_matmul": {"other": ("quant_matmul",),
                          "this": ("quant_matmul",)},
         "paged_decode": {"other": ("decode_attention::",),
                          "this": cs.PD_KERNEL_NAMES}}
HEAD = dict(H=32, Hkv=32, Dh=64)      # opt-1.3b's attention heads


def build_other(src_dir: Path, name: str):
    """Start building ``src_dir/<name>.cu`` with the port's nvcc flags (GNU
    unique symbols off, so its template statics stay its own beside this
    tree's library); returns (library path, process)."""
    lib = src_dir / f"lib{name}_other.so"
    return lib, subprocess.Popen(
        [build._nvcc(), *build._flags(name), "-Xcompiler", "-fno-gnu-unique",
         "-o", str(lib), str(src_dir / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_other(name: str, lib: Path, proc):
    """Wait for ``build_other``'s nvcc; the built entry point."""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the other {name}:\n{text}")
    fn_name, argtypes = OTHER_SIG[name]
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.restype = _I
    fn.argtypes = argtypes
    return fn


def turns(kernel, run):
    """Times of ``run`` ({'other': fn, 'this': fn}) in turns: one-call ms
    and device ms, each a list in the order other, this, this, other."""
    row = {f"{k}_{m}": [] for k in ("other", "this")
           for m in ("ms", "device_ms")}
    for k in ("other", "this", "this", "other"):
        row[f"{k}_ms"].append(cs.time_ms(torch, run[k], warmup=5, reps=50))
        row[f"{k}_device_ms"].append(cs.device_ms(
            torch, run[k], NAMES[kernel][k], calls=30))
    return row


def ab_quant_matmul(other):
    dev = torch.device("cuda")
    from repro_torch.core.quant import QuantConfig, quantize_tensor
    gen = torch.Generator(device=dev).manual_seed(12)
    for name, M, K, N, bits, group in cs.QM_SHAPES:
        qt = quantize_tensor(torch.randn((K, N), generator=gen, device=dev),
                             QuantConfig(bits=bits, group_size=group))
        x = torch.randn((M, K), generator=gen, device=dev)
        w = (qt.packed, qt.scale, qt.zero)
        W = qt.packed.shape[0]
        outs = {k: torch.empty((M, N), device=dev) for k in ("other", "this")}

        def run_other():
            rc = other(x.data_ptr(), *(t.data_ptr() for t in w),
                       outs["other"].data_ptr(), M, K, N, W, group, bits, 0,
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"other quant_matmul: CUDA error {rc}")

        def run_this():
            qm.launch(x, *w, outs["this"], bits=bits, group=group)
        want = ref.quant_matmul_ref(x, *w, bits, group)
        run = {"other": run_other, "this": run_this}
        row = {"kernel": "quant_matmul", "case": name, "shape": [M, K, N],
               "bits": bits, "group": group,
               "plan": qm.plan(M, N, W, bits, group,
                               qm.sm_count(dev))._asdict()}
        for k, fn in run.items():
            fn()
            torch.testing.assert_close(outs[k], want, **cs.QM_TOL)
            row[f"{k}_max_abs_err"] = float((outs[k] - want).abs().max())
        row.update(turns("quant_matmul", run))
        row["this_split_device_ms"] = cs.device_ms(
            torch, run_this, ("quant_matmul_split",), calls=30)
        if row["plan"]["n_split"] > 1:
            row["this_sum_device_ms"] = cs.device_ms(
                torch, run_this, ("quant_matmul_sum",), calls=30)
        dense = ref.dequant_ref(*w, bits, group, K)
        row["library_ms"] = cs.time_ms(torch, lambda: torch.matmul(x, dense),
                                       reps=50)
        row["library_device_ms"] = cs.device_ms(
            torch, lambda: torch.matmul(x, dense), ("",), calls=30)
        nbytes = (x.numel() * 4 + qt.packed.numel() * 4
                  + 2 * qt.scale.numel() * 4 + M * N * 4)
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            nbytes, 2 * M * K * N + 2 * W * (32 // bits) * N)
        print("ab: " + json.dumps(row), flush=True)
        del dense


def decode_lens():
    from repro_torch.configs import get_config
    from repro_torch.serving import build_trace
    trace = build_trace(get_config("opt-1.3b").vocab_size, **cs.TRACE)[:8]
    return [len(t["prompt"]) + cs.TRACE["max_new"] // 2 for t in trace]


def ab_paged_head(other):
    H, Hkv, Dh = HEAD["H"], HEAD["Hkv"], HEAD["Dh"]
    for ctx, B, lens in (("decode", 8, decode_lens()),
                         ("long", 8, [1024] * 8), ("long-b1", 1, [8192])):
        P = -(-max(lens) // cs.PSZ)
        q, kp, vp, bt, ln, ks, vs = cs.paged_case(
            torch, B=B, H=H, Hkv=Hkv, Dh=Dh, P=P, lens=lens,
            dtype=torch.float32, seed=7)
        outs = {k: [torch.empty((B, H, Dh), device=q.device),
                    torch.empty((B, H), device=q.device),
                    torch.empty((B, H), device=q.device)]
                for k in ("other", "this")}

        def run_other():
            o, m, l_ = outs["other"]
            rc = other(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
                       bt.data_ptr(), ln.data_ptr(), o.data_ptr(),
                       m.data_ptr(), l_.data_ptr(), B, H, Hkv, Dh, cs.PSZ, P,
                       1, 0, 0, float(Dh ** -0.5),
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"other paged decode: CUDA error {rc}")

        def run_this():
            pd.launch("paged_decode", q, kp, vp, bt, ln, None, None,
                      *outs["this"], normalize=True)
        want = ref.paged_decode_ref(q, kp, vp, bt, ln)
        run = {"other": run_other, "this": run_this}
        row = {"kernel": "paged_decode", "context": ctx, "batch": B,
               "heads": [H, Hkv], "head_dim": Dh, "lens": lens,
               "n_split": cs.n_split(torch, pd, "paged_decode", B, H, Hkv,
                                     P, cs.PSZ, 1)}
        for k, fn in run.items():
            fn()
            torch.testing.assert_close(outs[k][0], want, **cs.PD_TOL)
            row[f"{k}_max_abs_err"] = float((outs[k][0] - want).abs().max())
        row.update(turns("paged_decode", run))
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            cs.paged_bytes(q, kp, ks, lens, H, Hkv), 4 * H * Dh * sum(lens))
        print("ab: " + json.dumps(row), flush=True)


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    src = Path(argv[0]).resolve()
    jobs = {name: build_other(src, name) for name in OTHER_SIG}
    build.build_all(tuple(OTHER_SIG))    # this tree's, meanwhile
    others = {name: load_other(name, *job) for name, job in jobs.items()}
    print(cs.nvidia_smi_line(), flush=True)
    ab_quant_matmul(others["quant_matmul"])
    ab_paged_head(others["paged_decode"])
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
