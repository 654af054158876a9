// Fused causal self-attention over bf16 q, k, v, for the bf16 forward
// without a cache (the calibration forward of the search, prefill-free
// scoring):
//
//   out[b,i,h] = sum_{j<=i} softmax_j(q[b,i,h] . k[b,j,h/rep] * Dh^-0.5)
//                 . v[b,j,h/rep]
//
// q (B, S, Hq, Dh), k / v (B, S, Hkv, Dh), out (B, S, Hq, Dh), all bf16
// and contiguous; rep = Hq / Hkv; Dh 64 or 128. It computes exactly the
// function of the plain path, models/layers.py::blocked_attention(q, k, v,
// causal=True) with softmax_dtype float32, and replaces no TPU kernel: the
// reference's blocked_attention is jnp (src/repro/models/layers.py), not
// Pallas. It was added because that plain path, on a bf16 model, upcasts
// q / k / v to f32, forms the whole (B, Hkv, rep, S, S) f32 score matrix
// with SIMT f32 GEMMs and runs about ten elementwise passes over it: on
// Qwen3-4B at B 8 x S 512 (32 / 8 x 128 heads) 268 MB of scores a layer
// and about 2.8 ms a call, two thirds of a search step's device time.
//
// Bound: the tensor cores. A call's work at that shape is 8.6 GFLOP for
// Q K^T and 3 x 8.6 for P V (the three-term P below), 0.035 ms at the
// card's 989 TFLOP/s; its 84 MB of q, k, v and out take 0.025 ms at
// 3.35 TB/s.
//
// Precision: nothing is computed below the plain path's f32.
// - Q K^T: bf16 x bf16 tensor-core products of the model's own q and k,
//   exact in f32, summed in f32, then scaled by Dh^-0.5 (rounded to f32,
//   as the plain path's) in f32: the plain path's f32 product of the
//   upcast values up to f32 rounding.
// - Softmax: the online recurrence with the running max, sum and rescale
//   in f32 registers; s * scale - max is formed with one rounding (an
//   FMA) and exp is expf (within 2 f32 ulps; no ex2.approx on unscaled
//   inputs). Keys past the diagonal get the score -inf, whose probability
//   expf(-inf) is exactly 0, as the plain path's where(mask, p, 0).
// - P V: P enters at full f32 precision. Each probability is split into
//   three bf16 terms: hi is p truncated to bf16 (its top 8 significant
//   bits), r = p - hi is exact in f32 and has at most 16, mid is r
//   truncated (8 more) and lo = r - mid, exact too, has at most 8 bits, so
//   bf16 holds it exactly: hi + mid + lo = p for every p above 2^-110
//   (bf16 has f32's exponents but its subnormals stop at 2^-133; a smaller
//   p is below 2^-110 of the row's sum, which holds a 1). Three bf16 MMAs
//   of the terms against V's exact bf16 values accumulate in f32. No TF32
//   and no single bf16 rounding of P anywhere.
// - The output is acc / max(l, 1e-30) in f32, rounded once to bf16, as
//   the plain path's.
//
// Design: mma.sync m16n8k16 with cp.async double buffering, the form
// taken where the wgmma / TMA one is not brought up; that one is later
// work. At Qwen3-4B's shape the MMAs (three quarters of them the
// three-term P V) run at about 270 TFLOP/s.
// - A CTA takes one (b, query head) and a block of 64 query rows, 16 a
//   warp; measured on the H100 against 128-row blocks (8 warps, or 4 warps
//   of 32 rows), which were slower. Query head h reads KV head h / rep
//   (no repeated K/V); the grid orders the query heads of one KV head side
//   by side so their CTAs share K/V in L2. Causal work grows with the
//   block's position, so the grid launches the last (heaviest) query
//   blocks first.
// - Q's tile is staged once with cp.async; its MMA fragments are read
//   with ldmatrix one k-step ahead of their use, as are K's. K / V tiles
//   of 32 keys x Dh are staged with cp.async two deep: tile t + 1 loads
//   while tile t is computed. Shared memory rows are XOR-swizzled by
//   16-byte chunk, so ldmatrix reads are free of bank conflicts. Keys past
//   S are zero-filled and masked.
// - Scores, the online softmax and P V stay in registers: the S
//   accumulator's layout is the A fragment of the P V MMA, so the three P
//   terms are packed in place; V's B fragments come by ldmatrix.trans,
//   each serving the three terms.
// - KV tiles past the diagonal are never loaded; a warp skips a tile that
//   lies wholly past its 16 rows, and only the tiles that hold the
//   diagonal (or S's ragged end) are masked.
// - The epilogue divides by l and writes bf16 through the warp's own rows
//   of the Q tile in shared memory, then 16-byte stores straight into the
//   (B, S, Hq, Dh) layout: no permute, no f32 output tensor.
//
// Inputs the route in models/layers.py::self_attention leaves to
// blocked_attention: an f32 (or other non-bf16) q, k or v; causal=False
// (the encoder, cross-attention); a cache (prefill into it, decode, int8
// caches); an input that requires grad (training); a softmax_dtype other
// than f32; Dh other than 64 or 128; a tensor off the card; and
// core/taps.py's own call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace causal_attention {

constexpr int kWarps = 4;              // warps of a CTA
constexpr int kRows = 16 * kWarps;     // query rows of a CTA, 16 a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;              // keys of a K / V tile
constexpr int kStages = 2;             // K / V tiles staged at once
constexpr int kErrHeadDim = -2;        // Dh is not 64 or 128

// element offset of 16-byte chunk c of row r in a tile of DH columns,
// chunks XOR-swizzled by the row's low three bits
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate; not
// volatile, so the compiler may interleave it with loads and arithmetic
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// the top 16 bits of x: its bf16 value truncated, exact as an f32
__device__ __forceinline__ float top16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// (top 16 bits of x, top 16 bits of y) as one bf16 pair, x in the low half
__device__ __forceinline__ uint32_t top_pair(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// two probabilities (x, y) -> their (hi, mid, lo) bf16 pairs, summing to
// (x, y) exactly (see the note at the top): hi is x truncated to bf16, the
// rest r = x - hi is exact in f32, mid is r truncated, and r - mid, exact
// too, has at most 8 significant bits, so its top 16 bits are all of it
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const float xr = x - top16(x), yr = y - top16(y);
  hi = top_pair(x, y);
  mid = top_pair(xr, yr);
  lo = top_pair(xr - top16(xr), yr - top16(yr));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int B, int S, int Hq,
                     int Hkv, int n_qblocks, float scale) {
  constexpr int kChunks = DH / 8;    // 16-byte chunks of a row
  constexpr int kSteps = DH / 16;    // k-steps of Q K^T
  constexpr int kOut = DH / 8;       // n-tiles of the output
  constexpr int kN = kKeys / 8;      // n-tiles of a tile's scores
  constexpr int kPairs = kKeys / 16; // ... taken two at a time
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kRows * DH;            // kStages x kKeys x DH
  __nv_bfloat16* sv = sk + kStages * kKeys * DH;  // kStages x kKeys x DH

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  // the last (heaviest) query blocks first; query heads of one KV head
  // side by side
  const int bh = B * Hq;
  const int qb = n_qblocks - 1 - static_cast<int>(blockIdx.x) / bh;
  const int rem = static_cast<int>(blockIdx.x) % bh;
  const int b = rem / Hq, h = rem % Hq, hk = h / (Hq / Hkv);
  const int q0 = qb * kRows;
  const int n_tiles = (min(q0 + kRows, S) + kKeys - 1) / kKeys;
  const size_t q_row = static_cast<size_t>(Hq) * DH;
  const size_t kv_row = static_cast<size_t>(Hkv) * DH;
  const __nv_bfloat16* qg = q + static_cast<size_t>(b) * S * q_row +
                            static_cast<size_t>(h) * DH;
  const __nv_bfloat16* kg = k + static_cast<size_t>(b) * S * kv_row +
                            static_cast<size_t>(hk) * DH;
  const __nv_bfloat16* vg = v + static_cast<size_t>(b) * S * kv_row +
                            static_cast<size_t>(hk) * DH;

  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = q0 + r < S;
    cp_async16(sq + swz<DH>(r, c),
               ok ? qg + static_cast<size_t>(q0 + r) * q_row + c * 8 : qg,
               ok);
  }
  auto load_kv = [&](int t) {
    __nv_bfloat16* dk = sk + (t % kStages) * kKeys * DH;
    __nv_bfloat16* dv = sv + (t % kStages) * kKeys * DH;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int key = t * kKeys + r;
      const bool ok = key < S;
      const size_t off = ok ? static_cast<size_t>(key) * kv_row + c * 8 : 0;
      cp_async16(dk + swz<DH>(r, c), kg + off, ok);
      cp_async16(dv + swz<DH>(r, c), vg + off, ok);
    }
  };
  for (int t = 0; t < kStages - 1; ++t) {   // Q rides with tile 0
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  // the warp's rows: row0 + g holds accumulator entries 0 and 1, row0 + g
  // + 8 entries 2 and 3
  const int row0 = q0 + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  // Q's A fragment of k-step s
  auto q_frag = [&](uint32_t(&a)[4], int s) {
    ldsm_x4(a, sq + swz<DH>(warp * 16 + mr + ((mi & 1) << 3),
                            2 * s + (mi >> 1)));
  };
  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};   // this lane's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t (and Q) landed
    __syncthreads();
    // the stage tile t - 1 held: every warp is past it
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();
    const int key0 = t * kKeys;
    if (key0 > row0 + 15) continue;   // the whole tile lies past the diagonal
    const __nv_bfloat16* ks = sk + (t % kStages) * kKeys * DH;
    const __nv_bfloat16* vs = sv + (t % kStages) * kKeys * DH;

    // scores: 16 rows x kKeys keys, kN n-tiles of 8 keys. Step j = (k-step
    // s, key pair np) loads the fragments of step j + 1 before its MMAs.
    float sc[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    auto k_frag = [&](uint32_t(&kb)[4], int j) {
      ldsm_x4(kb, ks + swz<DH>((j % kPairs) * 16 + mr + ((mi >> 1) << 3),
                               2 * (j / kPairs) + (mi & 1)));
    };
    uint32_t kb[2][4], qa[2][4];
    k_frag(kb[0], 0);
    q_frag(qa[0], 0);
#pragma unroll
    for (int j = 0; j < kSteps * kPairs; ++j) {
      if (j + 1 < kSteps * kPairs) {
        k_frag(kb[(j + 1) & 1], j + 1);
        if ((j + 1) % kPairs == 0)
          q_frag(qa[((j + 1) / kPairs) & 1], (j + 1) / kPairs);
      }
      const int s = j / kPairs, np = j % kPairs;
      mma(sc[2 * np], qa[s & 1], kb[j & 1][0], kb[j & 1][1]);
      mma(sc[2 * np + 1], qa[s & 1], kb[j & 1][2], kb[j & 1][3]);
    }

    // online softmax over the tile, in f32. Masked scores become -inf, so
    // their probability is expf(-inf) = 0 exactly. The max is taken over
    // the unscaled sums: scale > 0 and rounding keep the order, so
    // max(s) * scale is the max of the scaled scores.
    if (key0 + kKeys - 1 > row0 || key0 + kKeys > S) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * t4 + (e & 1);
          if (key > rows[e >> 1] || key >= S) sc[n][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // key 0 is in every row's first tile, so m_new is finite from there
      const float m_new = fmaxf(m_run[i], mx[i] * scale);
      corr[i] = expf(m_run[i] - m_new);   // exp(-inf) = 0 at first
      m_run[i] = m_new;
      neg_m[i] = -m_new;
      l_run[i] = l_run[i] * corr[i];
    }
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // s * scale - m with one rounding
        const float p = expf(__fmaf_rn(sc[n][e], scale, neg_m[e >> 1]));
        sc[n][e] = p;
        l_run[e >> 1] = l_run[e >> 1] + p;
      }

    // P V: 16 keys at a time, P as three bf16 terms against V; four output
    // n-tiles a step, term by term, so an accumulator's next MMA is four
    // MMAs behind its last
#pragma unroll
    for (int kk = 0; kk < kPairs; ++kk) {
      uint32_t pt[3][4];   // lo, mid, hi
      split3(sc[2 * kk][0], sc[2 * kk][1], pt[2][0], pt[1][0], pt[0][0]);
      split3(sc[2 * kk][2], sc[2 * kk][3], pt[2][1], pt[1][1], pt[0][1]);
      split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pt[2][2], pt[1][2],
             pt[0][2]);
      split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pt[2][3], pt[1][3],
             pt[0][3]);
#pragma unroll
      for (int dq = 0; dq < kOut / 4; ++dq) {
        uint32_t vb[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          ldsm_x4_trans(vb[h2],
                        vs + swz<DH>(kk * 16 + mr + ((mi & 1) << 3),
                                     4 * dq + 2 * h2 + (mi >> 1)));
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma(o[4 * dq + n], pt[term], vb[n >> 1][2 * (n & 1)],
                vb[n >> 1][2 * (n & 1) + 1]);
      }
    }
  }

  // epilogue: out = acc / max(l, 1e-30) in bf16, through this warp's rows
  // of the Q tile (no other warp reads them)
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[i] = fmaxf(l, 1e-30f);
  }
  __syncwarp();
  __nv_bfloat16* so = sq + warp * 16 * DH;
#pragma unroll
  for (int n = 0; n < kOut; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16 x = __float2bfloat16_rn(o[n][2 * i] / den[i]);
      const __nv_bfloat16 y = __float2bfloat16_rn(o[n][2 * i + 1] / den[i]);
      *reinterpret_cast<uint32_t*>(so + swz<DH>(g + 8 * i, n) + 2 * t4) =
          pack(x, y);
    }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * S + row) *
                                          q_row +
                                static_cast<size_t>(h) * DH + c * 8) =
          *reinterpret_cast<const uint4*>(so + swz<DH>(r, c));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, float scale, cudaStream_t stream) {
  const int smem = (kRows * DH + 2 * kStages * kKeys * DH) * 2;
  auto kern = attention_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qblocks = (S + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(n_qblocks) * B * Hq;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      B, S, Hq, Hkv, n_qblocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace causal_attention

// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// kErrHeadDim (-2) without launching when Dh is not 64 or 128. The caller
// checks shapes, dtypes, contiguity and 16-byte alignment; S >= 1, Hq a
// multiple of Hkv; scale is Dh^-0.5 rounded to f32.
extern "C" int rq_causal_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int Hq, int Hkv, int Dh, float scale,
                                   void* stream) {
  using namespace causal_attention;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch<128>(q, k, v, out, B, S, Hq, Hkv, scale, st);
  if (Dh == 64) return launch<64>(q, k, v, out, B, S, Hq, Hkv, scale, st);
  return kErrHeadDim;
}
