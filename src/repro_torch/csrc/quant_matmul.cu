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
// masked (x rows past M and columns past K are staged as 0, columns past N
// are neither loaded nor written).
//
// Bound: at decode-sized M (8) the 2 M K N operations on the fp32 pipe are
// the larger term (H100: 67 TFLOP/s fp32 against 3.35 TB/s for the packed
// words, scales and zeros); TF32 tensor cores are not used, since at K =
// 8192 their rounding alone is of the order of the 5e-4 bar. So the design
// spends as few instructions per weight as it can, and fills the card:
//
// 1. Split-K. The grid is (ceil(N / 128), n_split, ceil(M / 8)). CTA
//    (j, s, i) owns 128 columns and 8 rows of M over the s-th of n_split
//    runs of K, which share n_units units of unit_words words as evenly as
//    whole units allow (the binding's planner, kernels/quant_matmul.py,
//    picks them so that the grid fills one wave of two CTAs per SM, and no
//    more, at decode shapes; a unit is whole groups where there are enough
//    of those, else one word: the kernel changes group wherever one
//    starts, checking rows only in a word where one does).
//    With one run the CTA writes out itself; otherwise each run's (M, N)
//    partial goes to a workspace the binding allocates and a second small
//    kernel adds the runs in order. No atomics: the result does not change
//    from run to run.
// 2. Dequantise once, use it 8 times. A thread owns 4 adjacent columns (one
//    16-byte load of 4 words a K word-row, the group's scale and zero as two
//    float4) and all 8 rows of M, so each dequantised value feeds 8 fused
//    multiply-adds. x is staged k-major in shared memory (xs[k][m], f32), so
//    the 8 rows of one k are two 16-byte broadcast loads that serve 4
//    columns. Codes become floats without a conversion instruction:
//    0x4B000000 | code is the float 2^23 + code, and subtracting 2^23 is
//    exact; then (code - zero) * scale, as the plain version computes it.
//    Per weight: a shift, a LOP3, three fp32 operations and 8 FMAs.
// 3. Bytes in flight. The 8 warps of a CTA split its run into contiguous
//    shares; each thread issues its first two words and its first two groups'
//    scale and zero before x is staged, and keeps the next word and the next
//    group's pair in flight while it reduces the current one. The warps'
//    partial sums meet in shared memory, added in warp order.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;              // columns of N per thread
constexpr int kBN = 32 * kCols;       // columns of N per CTA
constexpr int kBM = 8;                // rows of M per CTA
constexpr int kChunkRows = 1024;      // most K rows of x staged at once
constexpr int kXBatch = 8;            // x loads a thread issues together
// shared memory: the staged x chunk, then the warps' partial sums
constexpr int kSmemFloats = kChunkRows * kBM;
static_assert(kWarps * kBM * kBN <= kSmemFloats, "partials fit the x area");
static_assert(kThreads == kBM * 32, "one output float4 per thread");

struct Args {
  const void* x;
  const uint32_t* packed;
  const float* scale;
  const float* zero;
  float* out;          // (M, N), written directly when n_split == 1
  float* ws;           // (n_split, M, N) partials otherwise
  int M, K, N, W, G;
  int n_split, n_units, unit_words;
  int vec;             // N % 4 == 0 and 16-byte aligned bases: vector loads
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// columns [n, n + 4) of the row at `p` (p points at column n); columns at
// or past N read as 0
__device__ __forceinline__ uint4 load_words(const uint32_t* p, int n, int N,
                                            bool vec) {
  if (vec) return n < N ? __ldg(reinterpret_cast<const uint4*>(p)) : uint4{};
  uint4 r{};
  if (n < N) r.x = __ldg(p);
  if (n + 1 < N) r.y = __ldg(p + 1);
  if (n + 2 < N) r.z = __ldg(p + 2);
  if (n + 3 < N) r.w = __ldg(p + 3);
  return r;
}
__device__ __forceinline__ float4 load_f4(const float* p, int n, int N,
                                          bool vec) {
  if (vec)
    return n < N ? __ldg(reinterpret_cast<const float4*>(p)) : float4{};
  float4 r{};
  if (n < N) r.x = __ldg(p);
  if (n + 1 < N) r.y = __ldg(p + 1);
  if (n + 2 < N) r.z = __ldg(p + 2);
  if (n + 3 < N) r.w = __ldg(p + 3);
  return r;
}

// (code - zero) * scale for the code at bit `shift` of `word`
template <int kBits>
__device__ __forceinline__ float dequant(uint32_t word, int shift, float z,
                                         float s) {
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  const float code =
      __uint_as_float(((word >> shift) & kMask) | 0x4B000000u) - 8388608.f;
  return (code - z) * s;
}

template <typename T, int kBits>
__global__ void __launch_bounds__(kThreads, 2)
    quant_matmul_split_kernel(Args a) {
  constexpr int kVpw = 32 / kBits;
  constexpr int kChunkWords = kChunkRows / kVpw;
  __shared__ __align__(16) float smem[kSmemFloats];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * kBN + lane * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kBM;
  const int N = a.N, G = a.G;
  const bool vec = a.vec;
  const int last_group = a.W * kVpw / G - 1;
  const int w_begin =
      (int)((int64_t)split * a.n_units / a.n_split) * a.unit_words;
  const int w_end =
      (int)((int64_t)(split + 1) * a.n_units / a.n_split) * a.unit_words;
  const T* x = static_cast<const T*>(a.x);
  const uint32_t* pk = a.packed + n;
  const float* sc = a.scale + n;
  const float* zr = a.zero + n;

  float acc[kBM][kCols];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int c0 = w_begin; c0 < w_end; c0 += kChunkWords) {
    const int nw = min(kChunkWords, w_end - c0);
    const int per = (nw + kWarps - 1) / kWarps;  // this warp's share
    const int lo = c0 + min(warp * per, nw);
    const int hi = c0 + min((warp + 1) * per, nw);
    // this warp's first loads go out before x is staged
    uint4 w0{}, w1{};
    float4 s{}, z{}, s_nx{}, z_nx{};
    int g = 0, next = 0;  // current group, first row of the next one
    if (lo < hi) {
      w0 = load_words(pk + (int64_t)lo * N, n, N, vec);
      if (lo + 1 < hi) w1 = load_words(pk + (int64_t)(lo + 1) * N, n, N, vec);
      g = lo * kVpw / G;
      next = (g + 1) * G;
      s = load_f4(sc + (int64_t)g * N, n, N, vec);
      z = load_f4(zr + (int64_t)g * N, n, N, vec);
      const int gn = min(g + 1, last_group);
      s_nx = load_f4(sc + (int64_t)gn * N, n, N, vec);
      z_nx = load_f4(zr + (int64_t)gn * N, n, N, vec);
    }

    // stage x rows [k0, k0 + nw * vpw) k-major: m fastest, so a warp
    // writes 32 consecutive floats; each thread has kXBatch loads in flight
    __syncthreads();  // every warp is done with the previous chunk's xs
    const int k0 = c0 * kVpw, n_x = nw * kVpw * kBM;
    for (int i0 = tid; i0 < n_x; i0 += kThreads * kXBatch) {
      float v[kXBatch];
#pragma unroll
      for (int j = 0; j < kXBatch; ++j) {
        const int i = i0 + j * kThreads;
        const int kk = i / kBM, row = m0 + i - kk * kBM, k = k0 + kk;
        v[j] = i < n_x && row < a.M && k < a.K
                   ? to_f32(x[(int64_t)row * a.K + k])
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kXBatch; ++j)
        if (i0 + j * kThreads < n_x) smem[i0 + j * kThreads] = v[j];
    }
    __syncthreads();

    // the group that starts at row `next` becomes the current one, and the
    // one after it is fetched
    auto next_group = [&]() {
      s = s_nx;
      z = z_nx;
      ++g;
      next += G;
      const int gn = min(g + 1, last_group);
      s_nx = load_f4(sc + (int64_t)gn * N, n, N, vec);
      z_nx = load_f4(zr + (int64_t)gn * N, n, N, vec);
    };
    for (int w = lo; w < hi; ++w) {
      const uint4 w2 = w + 2 < hi
                           ? load_words(pk + (int64_t)(w + 2) * N, n, N, vec)
                           : uint4{};
      const int kw = w * kVpw;
      const float4* xw = reinterpret_cast<const float4*>(smem + (kw - k0) * kBM);
      // row i of the word: dequantise 4 columns, 32 FMAs
      auto row = [&](int i) {
        const float4 xa = xw[2 * i], xb = xw[2 * i + 1];
        const float xm[kBM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float wv[kCols] = {dequant<kBits>(w0.x, i * kBits, z.x, s.x),
                                 dequant<kBits>(w0.y, i * kBits, z.y, s.y),
                                 dequant<kBits>(w0.z, i * kBits, z.z, s.z),
                                 dequant<kBits>(w0.w, i * kBits, z.w, s.w)};
#pragma unroll
        for (int m = 0; m < kBM; ++m)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[m][c] = fmaf(xm[m], wv[c], acc[m][c]);
      };
      if (kw == next) next_group();
      if (kw + kVpw <= next) {  // the word lies in one group: no checks
#pragma unroll
        for (int i = 0; i < kVpw; ++i) row(i);
      } else {  // a group starts inside the word
#pragma unroll
        for (int i = 0; i < kVpw; ++i) {
          if (kw + i == next) next_group();
          row(i);
        }
      }
      w0 = w1;
      w1 = w2;
    }
  }

  // the warps' partial sums, added in warp order through the x area
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(smem);  // (kWarps, kBM, 32 lanes)
#pragma unroll
  for (int m = 0; m < kBM; ++m)
    red[(warp * kBM + m) * 32 + lane] =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int m = tid >> 5, c = tid & 31;  // this thread's output float4
  float4 o = red[m * 32 + c];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 p = red[(w * kBM + m) * 32 + c];
    o.x += p.x;
    o.y += p.y;
    o.z += p.z;
    o.w += p.w;
  }
  const int row = m0 + m, col = blockIdx.x * kBN + c * kCols;
  if (row >= a.M || col >= N) return;
  float* dst = (a.n_split == 1 ? a.out
                               : a.ws + (int64_t)split * a.M * N) +
               (int64_t)row * N + col;
  if (vec) {
    *reinterpret_cast<float4*>(dst) = o;
  } else {
    const float ov[kCols] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col + j < N) dst[j] = ov[j];
  }
}

// out[i] = sum of the n_split partials ws[s][i], in split order; the loads
// go out kBatch at a time (a loop of dependent loads would wait on the L2
// once per split)
__global__ void __launch_bounds__(kThreads)
    quant_matmul_sum_kernel(const float* __restrict__ ws,
                            float* __restrict__ out, int64_t mn,
                            int n_split) {
  constexpr int kBatch = 8;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p0 = 0; p0 < n_split; p0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = p0 + j < n_split ? ws[(int64_t)(p0 + j) * mn + i] : 0.f;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) s += v[j];
    }
    out[i] = s;
  }
}

template <typename T, int kBits>
int launch_bits(const Args& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.N + kBN - 1) / kBN), (unsigned)a.n_split,
                  (unsigned)((a.M + kBM - 1) / kBM));
  quant_matmul_split_kernel<T, kBits><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  const int64_t mn = (int64_t)a.M * a.N;
  const int64_t blocks = (mn + kThreads - 1) / kThreads;
  quant_matmul_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                            kThreads, 0, stream>>>(a.ws, a.out, mn,
                                                   a.n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(int bits, const Args& a, cudaStream_t s) {
  switch (bits) {
    case 1: return launch_bits<T, 1>(a, s);
    case 2: return launch_bits<T, 2>(a, s);
    case 3: return launch_bits<T, 3>(a, s);
    case 4: return launch_bits<T, 4>(a, s);
    case 5: return launch_bits<T, 5>(a, s);
    case 6: return launch_bits<T, 6>(a, s);
    case 7: return launch_bits<T, 7>(a, s);
    case 8: return launch_bits<T, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The split pass and, when n_split > 1, the sum of its partials. ws is the
// (n_split, M, N) f32 workspace (unused, may be null, when n_split == 1);
// run s holds units [s * U / n_split, (s + 1) * U / n_split) of the U =
// W / unit_words units of K. x_dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int rq_quant_matmul(const void* x, const void* packed,
                               const void* scale, const void* zero,
                               void* out, void* ws, int M, int K, int N,
                               int W, int group, int bits, int x_dtype,
                               int n_split, int unit_words, void* stream) {
  Args a;
  a.x = x;
  a.packed = static_cast<const uint32_t*>(packed);
  a.scale = static_cast<const float*>(scale);
  a.zero = static_cast<const float*>(zero);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.M = M;
  a.K = K;
  a.N = N;
  a.W = W;
  a.G = group;
  a.n_split = n_split;
  a.n_units = W / unit_words;
  a.unit_words = unit_words;
  a.vec = N % 4 == 0 && aligned16(packed) && aligned16(scale) &&
          aligned16(zero) && aligned16(out) && (n_split == 1 || aligned16(ws));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) return launch_typed<__nv_bfloat16>(bits, a, s);
  return launch_typed<float>(bits, a, s);
}
