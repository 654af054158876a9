// Group fake-quant round trip: w (K, N) -> fq (K, N), scale and zero
// (K/G, N), groups of G contiguous rows per column.
//
// Replaces the TPU kernel src/repro/kernels/group_quant.py,
// group_quant_pallas (body _kernel).
//
// Bound: bytes. About ten operations per element against 8 bytes moved for
// fp32 (one read, one write), so the card's memory rate is the limit.
// Design: one thread per (group, column); neighbouring threads take
// neighbouring columns, so every row read and write is coalesced. A thread
// reads its G values once for min/max and again (from L1/L2) to write fq;
// scale and zero are written once. Device memory sees one read of w, one
// write of fq and the small scale/zero planes. The TPU kernel tiled
// (bg*G, bn) blocks through VMEM; here no staging is needed.
#include <cstdint>

#include "quant_common.cuh"

namespace {

template <typename T>
__global__ void group_quant_kernel(const T* __restrict__ w,
                                   T* __restrict__ fq,
                                   float* __restrict__ scale,
                                   float* __restrict__ zero, int64_t n,
                                   int group, float qmax) {
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int64_t g = blockIdx.x;
  const T* src = w + g * group * n + col;
  T* dst = fq + g * group * n + col;

  float wmin = rq::to_f32(src[0]);
  float wmax = wmin;
  for (int r = 1; r < group; ++r) {
    const float v = rq::to_f32(src[(int64_t)r * n]);
    wmin = fminf(wmin, v);
    wmax = fmaxf(wmax, v);
  }
  float s, z;
  rq::group_params(wmin, wmax, qmax, &s, &z);
  for (int r = 0; r < group; ++r) {
    const float v = rq::to_f32(src[(int64_t)r * n]);
    dst[(int64_t)r * n] = rq::from_f32<T>(rq::fake_quant_value(v, s, z, qmax));
  }
  scale[g * n + col] = s;
  zero[g * n + col] = z;
}

template <typename T>
int launch(const void* w, void* fq, void* scale, void* zero, int64_t k,
           int64_t n, int group, int bits, cudaStream_t stream) {
  const int threads = n >= 256 ? 256 : (int)((n + 31) / 32 * 32);
  const dim3 grid((unsigned)(k / group), (unsigned)((n + threads - 1) / threads));
  const float qmax = (float)((1 << bits) - 1);
  group_quant_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(fq),
      static_cast<float*>(scale), static_cast<float*>(zero), n, group, qmax);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int rq_group_quant(const void* w, void* fq, void* scale,
                              void* zero, int64_t k, int64_t n, int group,
                              int bits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, fq, scale, zero, k, n, group, bits, s);
  return launch<float>(w, fq, scale, zero, k, n, group, bits, s);
}
