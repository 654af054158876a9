// Fused invariant transform (pi, s, phi) + group fake-quant round trip.
//
// Replaces the TPU kernel src/repro/kernels/transform_quant.py,
// transform_quant_pallas (bodies _kernel_up and _kernel_down).
//
//   mode 0, "up":   w (D, F). Rotate column pairs (2i, 2i+1) by phi_i, scale
//                   columns by s, permute columns by pi; quant groups of G
//                   rows run along D.
//   mode 1, "down": w (F, D). Rotate row pairs by phi_i, scale rows by 1/s,
//                   permute rows by pi; quant groups run along F, so pi
//                   changes group membership and the transform cannot be
//                   split from the quantisation.
//
// Output element (r, j) of "up" is rot(w)[r, pi[j]] * s[pi[j]]; output row i
// of "down" is rot(w)[pi[i], :] * (1/s)[pi[i]]. The wrapper passes cos(phi),
// sin(phi) and the column scale (s, or 1/s for "down") computed by PyTorch,
// so the kernel and the plain version share them bit for bit; -fmad=false
// keeps c*a - s*b as two rounded products and a rounded difference, like
// the plain version's separate tensor operations.
//
// Bound: bytes. About fifteen operations per element against 8 bytes moved
// (one read of w, one write of fq). Design: one thread per (group, output
// column), neighbouring threads on neighbouring output columns. The thread
// builds each transformed value with a gather straight from device memory:
// "up" reads source column pi[j] and its pair partner (one 8-byte pair),
// "down" reads source rows pi[i] and its partner at the thread's column
// (coalesced across the warp). The TPU kernel needed the whole F strip in
// VMEM to resolve pi and fell back to jnp above its strip budget (both of
// opt-1.3b's FFN shapes); the gather has no strip limit, so every shape
// runs here. Two passes over the group (min/max, then write) re-read the
// gathered values from L1/L2, not from device memory.
#include <cstdint>

#include "quant_common.cuh"

namespace {

// Rotated value of pair member `odd` of the pair (a, b): the plain
// version's ra = c*a - s*b, rb = s*a + c*b.
__device__ __forceinline__ float rotate(float a, float b, float c, float sn,
                                        bool odd) {
  return odd ? (sn * a + c * b) : (c * a - sn * b);
}

__global__ void transform_quant_up_kernel(
    const float* __restrict__ w, const int64_t* __restrict__ pi,
    const float* __restrict__ svec, const float* __restrict__ cosv,
    const float* __restrict__ sinv, float* __restrict__ fq,
    float* __restrict__ scale, float* __restrict__ zero, int64_t f,
    int group, float qmax) {
  const int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= f) return;
  const int64_t g = blockIdx.x;
  const int64_t src = pi[j];
  const int64_t pair = src >> 1;
  const bool odd = (src & 1) != 0;
  const float c = cosv[pair];
  const float sn = sinv[pair];
  const float sc = svec[src];
  const float* row0 = w + g * group * f + 2 * pair;

  float wmin = 0.0f, wmax = 0.0f;
  for (int r = 0; r < group; ++r) {
    const float* p = row0 + (int64_t)r * f;
    const float v = rotate(p[0], p[1], c, sn, odd) * sc;
    wmin = r == 0 ? v : fminf(wmin, v);
    wmax = r == 0 ? v : fmaxf(wmax, v);
  }
  float s, z;
  rq::group_params(wmin, wmax, qmax, &s, &z);
  float* out = fq + g * group * f + j;
  for (int r = 0; r < group; ++r) {
    const float* p = row0 + (int64_t)r * f;
    const float v = rotate(p[0], p[1], c, sn, odd) * sc;
    out[(int64_t)r * f] = rq::fake_quant_value(v, s, z, qmax);
  }
  scale[g * f + j] = s;
  zero[g * f + j] = z;
}

__global__ void transform_quant_down_kernel(
    const float* __restrict__ w, const int64_t* __restrict__ pi,
    const float* __restrict__ svec, const float* __restrict__ cosv,
    const float* __restrict__ sinv, float* __restrict__ fq,
    float* __restrict__ scale, float* __restrict__ zero, int64_t n,
    int group, float qmax) {
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int64_t g = blockIdx.x;
  const int64_t row_base = g * group;

  float wmin = 0.0f, wmax = 0.0f;
  for (int r = 0; r < group; ++r) {
    const int64_t src = pi[row_base + r];
    const int64_t pair = src >> 1;
    const float* p = w + 2 * pair * n + col;
    const float v = rotate(p[0], p[n], cosv[pair], sinv[pair], (src & 1) != 0)
                    * svec[src];
    wmin = r == 0 ? v : fminf(wmin, v);
    wmax = r == 0 ? v : fmaxf(wmax, v);
  }
  float s, z;
  rq::group_params(wmin, wmax, qmax, &s, &z);
  for (int r = 0; r < group; ++r) {
    const int64_t src = pi[row_base + r];
    const int64_t pair = src >> 1;
    const float* p = w + 2 * pair * n + col;
    const float v = rotate(p[0], p[n], cosv[pair], sinv[pair], (src & 1) != 0)
                    * svec[src];
    fq[(row_base + r) * n + col] = rq::fake_quant_value(v, s, z, qmax);
  }
  scale[g * n + col] = s;
  zero[g * n + col] = z;
}

}  // namespace

// w (K, N) float32, pi int64, svec/cosv/sinv float32. mode 0 = up (the
// transformed axis is N), 1 = down (it is K). Returns cudaGetLastError()
// after the launch (0 = cudaSuccess).
extern "C" int rq_transform_quant(const void* w, const void* pi,
                                  const void* svec, const void* cosv,
                                  const void* sinv, void* fq, void* scale,
                                  void* zero, int64_t k, int64_t n, int group,
                                  int bits, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = n >= 256 ? 256 : (int)((n + 31) / 32 * 32);
  const dim3 grid((unsigned)(k / group), (unsigned)((n + threads - 1) / threads));
  const float qmax = (float)((1 << bits) - 1);
  const float* wf = static_cast<const float*>(w);
  const int64_t* p = static_cast<const int64_t*>(pi);
  const float* sv = static_cast<const float*>(svec);
  const float* cv = static_cast<const float*>(cosv);
  const float* snv = static_cast<const float*>(sinv);
  float* out = static_cast<float*>(fq);
  float* sc = static_cast<float*>(scale);
  float* zr = static_cast<float*>(zero);
  if (mode == 0) {
    transform_quant_up_kernel<<<grid, threads, 0, st>>>(
        wf, p, sv, cv, snv, out, sc, zr, n, group, qmax);
  } else {
    transform_quant_down_kernel<<<grid, threads, 0, st>>>(
        wf, p, sv, cv, snv, out, sc, zr, n, group, qmax);
  }
  return (int)cudaGetLastError();
}
