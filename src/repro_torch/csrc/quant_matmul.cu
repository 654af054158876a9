// Fused dequant-matmul: out = x @ dequant(packed W).
//
// x (M, K) f32 or bf16; packed (W, N) 32-bit words, W = K_pad / vpw with
// vpw = 32 / bits: slot i of word w holds the code of row w * vpw + i at bit
// offset i * bits; scale / zero (K_pad / G, N) f32, one pair per group of G
// rows. The dequantised weight is (code - zero) * scale, rows K..K_pad - 1
// are padding (x has no column for them). out (M, N) f32.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py
// (quant_matmul_pallas), which unpacks and dequantises each (bk, bn) weight
// tile after it is loaded and feeds the MXU. Its wrapper (repro ops.py)
// falls back to jnp unless M % 8 == 0, N % 128 == 0 and K % vpw == 0; here
// every shape goes through the kernel: the ragged M, N and K edges are
// masked (x rows past M and columns past K are staged as 0).
//
// Bound: at decode-sized M the packed words and the f32 scale/zero dominate
// the bytes, and at M = 8 the 2 M K N operations on the fp32 pipe are the
// larger term (H100: 67 TFLOP/s fp32 against 3.35 TB/s). Design (simple,
// no tensor cores yet): a CTA owns kBM rows of M by kBN = 32 columns of N,
// one column per lane, so each warp reads a 128-byte row of words; the
// kWarps warps split the words of each K chunk. The chunk's x rows are
// staged in shared memory as f32 (read by every lane at the same address: a
// broadcast); each thread unpacks a word into its vpw codes, dequantises
// them in registers with the group's (scale, zero) — reloaded only where the
// group changes — and accumulates kBM fp32 sums. The warps' partial sums
// are added in a fixed order at the end, so the result is deterministic.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 32;      // columns of N per CTA (one per lane)
constexpr int kBM = 8;       // rows of M per CTA
constexpr int kChunk = 512;  // most rows of K staged per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int kBits>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const T* __restrict__ x,
                        const uint32_t* __restrict__ packed,
                        const float* __restrict__ scale,
                        const float* __restrict__ zero,
                        float* __restrict__ out, int M, int K, int N, int W,
                        int G) {
  constexpr int kVpw = 32 / kBits;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  constexpr int kWordsPerChunk = kChunk / kVpw;
  constexpr int kRows = kWordsPerChunk * kVpw;  // K rows per chunk
  __shared__ float xs[kBM][kRows];
  __shared__ float red[kWarps][kBM][kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int n = n0 + lane;
  const int m0 = blockIdx.y * kBM;
  float acc[kBM];
#pragma unroll
  for (int m = 0; m < kBM; ++m) acc[m] = 0.f;

  for (int w0 = 0; w0 < W; w0 += kWordsPerChunk) {
    const int k0 = w0 * kVpw;
    __syncthreads();  // every warp is done with the previous chunk's xs
    for (int i = tid; i < kBM * kRows; i += kThreads) {
      const int m = i / kRows, kk = i - m * kRows;
      const int row = m0 + m, k = k0 + kk;
      xs[m][kk] = (row < M && k < K) ? to_f32(x[(int64_t)row * K + k]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int nw = min(kWordsPerChunk, W - w0);
      for (int wi = warp; wi < nw; wi += kWarps) {
        const uint32_t word = packed[(int64_t)(w0 + wi) * N + n];
        const int kw = k0 + wi * kVpw;  // first K row of this word
        int g = kw / G;
        int next = (g + 1) * G;         // first row of the next group
        float s = scale[(int64_t)g * N + n];
        float z = zero[(int64_t)g * N + n];
#pragma unroll
        for (int i = 0; i < kVpw; ++i) {
          if (kw + i == next) {
            ++g;
            next += G;
            s = scale[(int64_t)g * N + n];
            z = zero[(int64_t)g * N + n];
          }
          const float wv = ((float)((word >> (i * kBits)) & kMask) - z) * s;
          const int kk = wi * kVpw + i;
#pragma unroll
          for (int m = 0; m < kBM; ++m) acc[m] += xs[m][kk] * wv;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  // kThreads == kBM * kBN: one output per thread, warps added in order
  const int m = tid / kBN, c = tid - (tid / kBN) * kBN;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += red[w][m][c];
  if (m0 + m < M && n0 + c < N) out[(int64_t)(m0 + m) * N + n0 + c] = sum;
}

template <typename T, int kBits>
int launch_bits(const void* x, const void* packed, const void* scale,
                const void* zero, void* out, int M, int K, int N, int W,
                int G, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kBN - 1) / kBN),
                  (unsigned)((M + kBM - 1) / kBM));
  quant_matmul_kernel<T, kBits><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<float*>(out), M, K, N, W, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(int bits, const void* x, const void* packed,
                 const void* scale, const void* zero, void* out, int M,
                 int K, int N, int W, int G, cudaStream_t s) {
  switch (bits) {
    case 1: return launch_bits<T, 1>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 2: return launch_bits<T, 2>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 3: return launch_bits<T, 3>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 4: return launch_bits<T, 4>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 5: return launch_bits<T, 5>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 6: return launch_bits<T, 6>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 7: return launch_bits<T, 7>(x, packed, scale, zero, out, M, K, N, W, G, s);
    case 8: return launch_bits<T, 8>(x, packed, scale, zero, out, M, K, N, W, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int rq_quant_matmul(const void* x, const void* packed,
                               const void* scale, const void* zero,
                               void* out, int M, int K, int N, int W,
                               int group, int bits, int x_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    return launch_typed<__nv_bfloat16>(bits, x, packed, scale, zero, out, M,
                                       K, N, W, group, s);
  return launch_typed<float>(bits, x, packed, scale, zero, out, M, K, N, W,
                             group, s);
}
