// Split-KV one-token decode attention: the body of every decode kernel of
// the port, the three paged routes (rq_paged_decode_head,
// rq_paged_decode_gqa, rq_paged_decode_gqa_mp in paged_decode.cu) and the
// contiguous flash route (rq_flash_decode in flash_decode.cu). A CTA holds
// one query head (QR = 1) or the rep query heads of one KV head (QR 2/4/8).
//
//   out[b,h] = softmax(q[b,h] . K[rows(b), h/rep]^T / sqrt(Dh)) . V[...]
//
// Two flavours, picked at compile time by launch<kContig>() (each .cu
// instantiates only its own):
// - paged (kContig = false): position pos of sequence b is slot
//   pos % psz of page bt[b, pos / psz] of the (N, psz, Hkv, Dh) pool, and
//   the sequence's length is lens[b], read on the device;
// - contiguous (kContig = true): position pos of sequence b is row
//   b * S + pos of the (B * S, Hkv, Dh) cache, with page size 1, and every
//   sequence has the host's one length kv_len, passed as P (the live rows
//   the planner cut into runs). No block table, no length tensor.
//
// Bound: bytes. Every live K/V row is read once for its rep query heads and
// carries about 4 flops per value per query row, so the card's memory rate
// is the limit and the kernel needs many bytes in flight on every SM. The
// design:
//
// 1. Split-KV. The grid is (n_split, Hkv * n_qc, B): CTA (s, u, b) takes
//    the contiguous run of pages [s * run, (s + 1) * run) of sequence b
//    (run and n_split come from the binding's planner; for the multi-page
//    route a run is a whole number of MP-page blocks) and computes the
//    (acc, m, l) partials of its query rows over that run. A CTA whose run
//    starts at or past the sequence's live positions loads nothing and
//    writes the empty partial (acc 0, m -1e30, l 0). Paged lengths and
//    block tables are read on the device, the contiguous kv_len is the
//    host's own: no host sync. With n_split = 1 the CTA writes the final
//    output itself and no merge runs.
// 2. Merge. With n_split > 1 the partials go to a workspace the binding
//    allocates ((n_split, B, H, Dh) acc, (n_split, B, H) m and l) and a
//    second small kernel, one CTA per (b, h), merges them:
//    m* = max m_i, l = sum e^(m_i - m*) l_i, acc = sum e^(m_i - m*) acc_i,
//    then out = acc / max(l, 1e-30) or the raw (acc, m*, l). A second
//    kernel was chosen over a last-arriving CTA behind an atomic counter:
//    it needs no counter zeroed before every call, sums the partials in a
//    fixed order (the result does not change from run to run) and costs
//    one launch, which the planner only pays where a split has at least
//    MIN_RUN_ROWS rows to read. An empty sequence merges to exactly 0 with
//    (m, l) = (-1e30, 0): every weight is e^0 = 1 on zero partials and
//    0 / max(0, 1e-30) = 0, where a plain acc / l would give 0 / 0.
// 3. Loads overlap compute. A CTA walks its run in tiles of tile_rows
//    positions (the binding's TILE_ROWS, passed in; found by position, so a
//    tile may cross pages: neither the page size nor MP sizes shared
//    memory) and stages each tile's live K/V rows raw (f32, bf16 or int8,
//    and the int8 scales) into shared memory
//    with cp.async, `stages` tiles deep (3 where three fit beside a second
//    CTA on the SM, else 2): while tile i is reduced, tiles i+1 ..
//    i+stages-1 are in flight. int8 and bf16 are converted to f32 as they
//    are read from shared memory. Three barriers per tile: tile ready,
//    scores written, probabilities written.
// 4. An inner loop for rep query rows, on 8 warps. Scores: a warp takes 4
//    rows of K at a time, 8 lanes per row each summing an eighth of Dh (a
//    quarter-warp reads 8 consecutive 16-byte pieces of one row: no bank
//    clash) for all QR query rows at once, so every K value read from
//    shared memory serves every query row and the 8 lanes meet in 3
//    shuffles per query row. P.V: a thread owns 4 consecutive Dh values for
//    every query row and a strided share of the tile's rows, accumulating
//    in registers across tiles; the shares are summed once, at the end of
//    the run. Products accumulate with explicit fmaf: the library is built
//    with -fmad=false, which would otherwise double the FP instructions.
//
// What limits it now (PERF.md §7: timed with the copies, or the arithmetic,
// switched off): at f32 the cp.async pipeline on its own takes most of the
// kernel's time, at bf16 and int8 the per-tile arithmetic and barriers do;
// neither reaches the card's memory rate.
//
// Query rows per CTA: QR = 1 on the per-query-head route (n_qc = rep
// chunks of one row, so CTA (s, u, b) serves query head u; a GQA layout
// served with fused_gqa=False reads each K/V row once per query head, rep -
// 1 times of it from L2); on the fused-GQA routes QR = 2, 4 or 8 (the
// smallest that holds rep), and a rep above 8 is cut into n_qc = ceil(rep /
// 8) chunks of 8, each its own CTA.
//
// Positions at or past the length are masked by SELECTION: they are never
// loaded, their score is -1e30 and their probability 0 without touching K
// or V, so a dead or NaN-poisoned slot cannot reach the arithmetic (0 * NaN
// would be NaN). A length of 0 gives exactly 0.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace split_decode {

// four consecutive Dh values as f32: one 16-, 8- or 4-byte load (Dh % 4 == 0
// and 4-value-aligned bases keep every such load aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDq = kThreads;  // 4-value pieces per row: Dh <= 1024
// shared memory under which three stages still leave room for a second CTA
// on the SM (228 KB per SM, 1 KB of it reserved per block)
constexpr int kTwoPerSm = 112 * 1024;

// returned (instead of a CUDA error) without launching; the bindings raise
constexpr int kErrSmem = -1;     // one CTA's tiles exceed a block's smem
constexpr int kErrHeadDim = -2;  // Dh > 4 * kMaxDq

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int32_t* bt;    // paged: (B, P) block table
  const int32_t* lens;  // paged: (B,) lengths
  float* out;           // (B, H, Dh)
  float* m_out;         // (B, H)
  float* l_out;         // (B, H)
  float* ws_acc;        // (n_split, B, H, Dh) when n_split > 1
  float* ws_m;          // (n_split, B, H)
  float* ws_l;          // (n_split, B, H)
  // contiguous: psz = 1, P = kv_len (every sequence's live rows), S the
  // cache rows per sequence
  int B, H, Hkv, Dh, psz, P, S;
  int run_pages;   // pages per split
  int n_split;
  int normalize;
  // positions per staged tile (one online-softmax update): the planner's
  // TILE_ROWS, halved by launch_typed() only where it does not fit
  int tile_rows;
  // set by launch(): query-row chunks per KV head, tiles in flight (2 or 3)
  int n_qc, stages;
  float scale;     // Dh ** -0.5
};

// Shared-memory layout (bytes), computed the same way on host and device.
struct Layout {
  int dq;        // 4-value pieces per row
  int row_b;     // bytes of one staged row
  int stage_b;   // bytes of one stage: K rows, V rows, K and V scales
  int area_b;    // stages, or the final reduction buffer if larger
  int q_off, p_off, st_off, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int Dh, int elem, int tile_rows,
                                         int stages, int qr, bool quant) {
  Layout L;
  L.dq = Dh / 4;
  L.row_b = Dh * elem;
  L.stage_b = align16(2 * tile_rows * L.row_b + (quant ? 8 * tile_rows : 0));
  const int groups = kThreads / L.dq;
  const int red_b = groups * qr * Dh * 4;
  L.area_b = align16(stages * L.stage_b > red_b ? stages * L.stage_b : red_b);
  L.q_off = L.area_b;
  L.p_off = L.q_off + align16(qr * Dh * 4);
  L.st_off = L.p_off + align16(tile_rows * qr * 4);
  L.total = L.st_off + align16(3 * qr * 4);
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// one 4-value piece of a row: 16, 8 or 4 bytes
template <typename T>
__device__ __forceinline__ void cp_piece(void* dst, const T* src) {
  if constexpr (sizeof(T) == 4) cp_async16(dst, src);
  else if constexpr (sizeof(T) == 2) cp_async8(dst, src);
  else cp_async4(dst, src);
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` committed groups are still in flight
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending >= 1) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename T, bool kQuant, int QR, bool kContig>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dh = a.Dh;
  const int tile_rows = a.tile_rows;
  const Layout L = layout(Dh, (int)sizeof(T), tile_rows, a.stages, QR, kQuant);
  const int dq = L.dq;
  float* q_s = reinterpret_cast<float*>(smem + L.q_off);   // (QR, Dh)
  float* p_s = reinterpret_cast<float*>(smem + L.p_off);   // (tile, QR)
  float* m_s = reinterpret_cast<float*>(smem + L.st_off);  // (QR,)
  float* l_s = m_s + QR;
  float* corr_s = l_s + QR;

  const int split = blockIdx.x;
  const int g = blockIdx.y / a.n_qc;             // KV head
  const int qc = blockIdx.y - g * a.n_qc;        // query-row chunk
  const int b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  const int h0 = g * rep + qc * QR;              // first query head
  const int nq = min(QR, rep - qc * QR);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this CTA's positions: [pos0, pos1) of the sequence's live ones; a
  // length past the P pages reads all P pages, as the plain version does
  const int len = kContig ? a.P : min(a.lens[b], a.P * a.psz);
  const int pos0 = split * a.run_pages * a.psz;
  const int pos1 = min(pos0 + a.run_pages * a.psz, len);
  const bool direct = a.n_split == 1;
  float* o_base = direct ? a.out : a.ws_acc + (int64_t)split * a.B * a.H * Dh;
  float* m_base = direct ? a.m_out : a.ws_m + (int64_t)split * a.B * a.H;
  float* l_base = direct ? a.l_out : a.ws_l + (int64_t)split * a.B * a.H;
  const int64_t bh0 = (int64_t)b * a.H + h0;

  if (pos0 >= pos1) {  // nothing live in this run: the empty partial
    for (int i = tid; i < nq * Dh; i += kThreads) o_base[bh0 * Dh + i] = 0.f;
    if (tid < nq) {
      if (m_base) m_base[bh0 + tid] = kNeg;
      if (l_base) l_base[bh0 + tid] = 0.f;
    }
    return;
  }

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int n_tiles = (pos1 - pos0 + tile_rows - 1) / tile_rows;
  // the (slot, KV head) row of position pos
  auto row_of = [&](int pos) -> int64_t {
    if constexpr (kContig) {
      return ((int64_t)b * a.S + pos) * a.Hkv + g;
    } else {
      const int pg = pos / a.psz;
      return ((int64_t)a.bt[(int64_t)b * a.P + pg] * a.psz +
              (pos - pg * a.psz)) * a.Hkv + g;
    }
  };

  // stage tile `t` (if it exists) into its ring slot; one commit per call
  // so the group count stays in step with the tile index
  auto stage_tile = [&](int t) {
    if (t < n_tiles) {
      unsigned char* kb = smem + (t % a.stages) * L.stage_b;
      unsigned char* vb = kb + tile_rows * L.row_b;
      const int start = pos0 + t * tile_rows;
      const int nv = min(tile_rows, pos1 - start);
      const int rows_per = kThreads / dq;  // rows one pass covers
      const int c = tid % dq;
      if (tid < rows_per * dq) {
        for (int r = tid / dq; r < nv; r += rows_per) {
          const int64_t row = row_of(start + r);
          cp_piece<T>(kb + r * L.row_b + c * 4 * sizeof(T),
                      kp + row * Dh + 4 * c);
          cp_piece<T>(vb + r * L.row_b + c * 4 * sizeof(T),
                      vp + row * Dh + 4 * c);
        }
      }
      if (kQuant) {
        float* ksc = reinterpret_cast<float*>(vb + tile_rows * L.row_b);
        float* vsc = ksc + tile_rows;
        for (int r = tid; r < nv; r += kThreads) {
          const int64_t row = row_of(start + r);
          cp_async4(ksc + r, a.ks + row);
          cp_async4(vsc + r, a.vs + row);
        }
      }
    }
    cp_commit();
  };

  for (int t = 0; t < a.stages - 1; ++t) stage_tile(t);

  const float* qg = a.q + bh0 * Dh;
  for (int i = tid; i < nq * Dh; i += kThreads) q_s[i] = qg[i];
  if (tid < QR) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  const int cg = lane & 7;  // scores: this lane's pieces of a K row

  // P.V ownership: 4 consecutive Dh values (piece c) of every query row,
  // rows tg, tg + groups, ... of each tile
  const int groups = kThreads / dq;
  const bool pv_on = tid < groups * dq;
  const int pc = tid % dq;
  const int tg = tid / dq;
  float acc[QR][4];
#pragma unroll
  for (int qi = 0; qi < QR; ++qi)
    acc[qi][0] = acc[qi][1] = acc[qi][2] = acc[qi][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait(a.stages - 2);
    __syncthreads();  // tile t visible; every read of its slot's last use done
    stage_tile(t + a.stages - 1);

    const unsigned char* kb = smem + (t % a.stages) * L.stage_b;
    const unsigned char* vb = kb + tile_rows * L.row_b;
    const float* ksc = reinterpret_cast<const float*>(vb + tile_rows * L.row_b);
    const float* vsc = ksc + tile_rows;
    const int start = pos0 + t * tile_rows;
    const int nv = min(tile_rows, pos1 - start);

    // scores: 4 rows per warp pass, 8 lanes per row (a quarter-warp reads
    // 8 consecutive pieces of one row: no bank clash)
    for (int r0 = warp * 4; r0 < tile_rows; r0 += kWarps * 4) {
      const int r = r0 + (lane >> 3);
      float dot[QR];
#pragma unroll
      for (int qi = 0; qi < QR; ++qi) dot[qi] = 0.f;
      if (r < nv) {  // masked rows are not read
        const T* krow = reinterpret_cast<const T*>(kb + r * L.row_b);
        for (int c = cg; c < dq; c += 8) {
          const float4 kv = load4(krow + 4 * c);
#pragma unroll
          for (int qi = 0; qi < QR; ++qi) {
            const float4 qq = reinterpret_cast<const float4*>(q_s)[qi * dq + c];
            dot[qi] = fmaf(qq.x, kv.x, dot[qi]);
            dot[qi] = fmaf(qq.y, kv.y, dot[qi]);
            dot[qi] = fmaf(qq.z, kv.z, dot[qi]);
            dot[qi] = fmaf(qq.w, kv.w, dot[qi]);
          }
        }
      }
#pragma unroll
      for (int qi = 0; qi < QR; ++qi) {
        dot[qi] += __shfl_xor_sync(0xffffffffu, dot[qi], 1);
        dot[qi] += __shfl_xor_sync(0xffffffffu, dot[qi], 2);
        dot[qi] += __shfl_xor_sync(0xffffffffu, dot[qi], 4);
      }
      if (cg == 0 && r < tile_rows) {
        const float f = kQuant && r < nv ? ksc[r] * a.scale : a.scale;
#pragma unroll
        for (int qi = 0; qi < QR; ++qi)
          p_s[r * QR + qi] = r < nv ? dot[qi] * f : kNeg;
      }
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int qi = warp; qi < nq; qi += kWarps) {
      float mx = kNeg;
      for (int r = lane; r < nv; r += 32) mx = fmaxf(mx, p_s[r * QR + qi]);
      mx = warp_max(mx);
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < tile_rows; r += 32) {
        const float p = r < nv ? expf(p_s[r * QR + qi] - m_new) : 0.f;
        p_s[r * QR + qi] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[qi] = corr;
        l_s[qi] = l_s[qi] * corr + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V over the live rows only
    if (pv_on) {
#pragma unroll
      for (int qi = 0; qi < QR; ++qi) {
        const float c = qi < nq ? corr_s[qi] : 0.f;
        acc[qi][0] *= c;
        acc[qi][1] *= c;
        acc[qi][2] *= c;
        acc[qi][3] *= c;
      }
#pragma unroll 4
      for (int r = tg; r < nv; r += groups) {
        float4 vv = load4(reinterpret_cast<const T*>(vb + r * L.row_b) + 4 * pc);
        if (kQuant) {
          const float s = vsc[r];
          vv = make_float4(vv.x * s, vv.y * s, vv.z * s, vv.w * s);
        }
        float p[QR];
        if constexpr (QR == 1) {
          p[0] = p_s[r];
        } else if constexpr (QR % 4 == 0) {
#pragma unroll
          for (int j = 0; j < QR; j += 4) {
            const float4 p4 = reinterpret_cast<const float4*>(p_s + r * QR)[j / 4];
            p[j] = p4.x;
            p[j + 1] = p4.y;
            p[j + 2] = p4.z;
            p[j + 3] = p4.w;
          }
        } else {
          const float2 p2 = reinterpret_cast<const float2*>(p_s + r * QR)[0];
          p[0] = p2.x;
          p[1] = p2.y;
        }
#pragma unroll
        for (int qi = 0; qi < QR; ++qi) {
          acc[qi][0] = fmaf(p[qi], vv.x, acc[qi][0]);
          acc[qi][1] = fmaf(p[qi], vv.y, acc[qi][1]);
          acc[qi][2] = fmaf(p[qi], vv.z, acc[qi][2]);
          acc[qi][3] = fmaf(p[qi], vv.w, acc[qi][3]);
        }
      }
    }
  }

  // sum the row groups' accumulators (in a fixed order) through the stage
  // area, which no copy writes any more
  cp_wait(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // (groups, QR, Dh)
  if (pv_on) {
#pragma unroll
    for (int qi = 0; qi < QR; ++qi)
      reinterpret_cast<float4*>(red + (tg * QR + qi) * Dh)[pc] =
          make_float4(acc[qi][0], acc[qi][1], acc[qi][2], acc[qi][3]);
  }
  __syncthreads();
  for (int i = tid; i < nq * Dh; i += kThreads) {
    const int qi = i / Dh, d = i - qi * Dh;
    float o = 0.f;
    for (int j = 0; j < groups; ++j) o += red[(j * QR + qi) * Dh + d];
    o_base[bh0 * Dh + i] =
        direct && a.normalize ? o / fmaxf(l_s[qi], 1e-30f) : o;
  }
  if (tid < nq) {
    if (m_base) m_base[bh0 + tid] = m_s[tid];
    if (l_base) l_base[bh0 + tid] = l_s[tid];
  }
}

// sum (or max) of x over the block, the warps' results combined in a fixed
// order; every thread gets the result. `scratch` holds kWarps floats.
__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* scratch) {
  x = is_max ? warp_max(x) : warp_sum(x);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w)
    r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

// One CTA per (b, h): merge the n_split partials of the workspace. The
// splits are shared out over the threads twice: first for m* and l (and
// the weights e^(m_i - m*), kept in shared memory), then for acc, where a
// thread owns 4 Dh values (piece c) of a strided share of the splits; the
// shares are summed in a fixed order.
__global__ void __launch_bounds__(kThreads) merge_kernel(Args a) {
  extern __shared__ __align__(16) float msm[];
  float* part = msm;                    // (groups, Dh)
  float* w_s = msm + 4 * kThreads;      // (n_split,)
  __shared__ float scratch[kWarps];
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t BH = (int64_t)a.B * a.H;
  const int n = a.n_split, Dh = a.Dh, dq = Dh / 4;

  float mx = kNeg;
  for (int i = tid; i < n; i += kThreads) mx = fmaxf(mx, a.ws_m[i * BH + bh]);
  const float m_star = block_reduce(mx, true, scratch);
  float ls = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float w = expf(a.ws_m[i * BH + bh] - m_star);
    w_s[i] = w;
    ls += w * a.ws_l[i * BH + bh];
  }
  const float l = block_reduce(ls, false, scratch);  // syncs: w_s visible

  const int groups = kThreads / dq;
  const int c = tid % dq, sg = tid / dq;
  if (sg < groups) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = sg; i < n; i += groups) {
      const float w = w_s[i];
      const float4 p =
          reinterpret_cast<const float4*>(a.ws_acc + (i * BH + bh) * Dh)[c];
      o.x += w * p.x;
      o.y += w * p.y;
      o.z += w * p.z;
      o.w += w * p.w;
    }
    reinterpret_cast<float4*>(part + sg * Dh)[c] = o;
  }
  __syncthreads();
  const float d = a.normalize ? fmaxf(l, 1e-30f) : 1.f;
  for (int i = tid; i < Dh; i += kThreads) {
    float o = 0.f;
    for (int j = 0; j < groups; ++j) o += part[j * Dh + i];
    a.out[bh * Dh + i] = a.normalize ? o / d : o;
  }
  if (tid == 0) {
    if (a.m_out) a.m_out[bh] = m_star;
    if (a.l_out) a.l_out[bh] = l;
  }
}

template <typename T, bool kQuant, int QR, bool kContig>
int launch_typed(Args a, cudaStream_t stream, int max_smem) {
  // the given tile, three stages where that leaves room for a second CTA
  // on the SM, else two; fewer rows only where even two stages would not
  // fit the card (very wide heads): a run the planner sizes to hold one
  // given tile then still holds one
  Layout L;
  for (;; a.tile_rows /= 2) {
    const int elem = (int)sizeof(T);
    a.stages =
        layout(a.Dh, elem, a.tile_rows, 3, QR, kQuant).total <= kTwoPerSm ? 3
                                                                          : 2;
    L = layout(a.Dh, elem, a.tile_rows, a.stages, QR, kQuant);
    if (L.total <= max_smem) break;
    if (a.tile_rows == 1) return kErrSmem;
  }
  auto kernel = split_kernel<T, kQuant, QR, kContig>;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a.n_split, (unsigned)(a.Hkv * a.n_qc),
                  (unsigned)a.B);
  kernel<<<grid, kThreads, L.total, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  const size_t merge_smem = sizeof(float) * (4 * kThreads + a.n_split);
  merge_kernel<<<(unsigned)(a.B * a.H), kThreads, merge_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kQuant, bool kContig>
int launch_qr(const Args& a, int qr, cudaStream_t s, int max_smem) {
  if (qr == 1) return launch_typed<T, kQuant, 1, kContig>(a, s, max_smem);
  if (qr == 2) return launch_typed<T, kQuant, 2, kContig>(a, s, max_smem);
  if (qr == 4) return launch_typed<T, kQuant, 4, kContig>(a, s, max_smem);
  return launch_typed<T, kQuant, 8, kContig>(a, s, max_smem);
}

// One decode over B sequences, paged or contiguous (kContig): the split
// pass, then (n_split > 1) the merge. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8; quant: scales given; per_query_head: one query row per CTA (QR
// 1, n_qc = rep chunks), else the smallest QR that holds rep. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess), kErrSmem when
// one CTA's tiles need more shared memory than a block has, or kErrHeadDim
// when Dh > 1024, without launching.
template <bool kContig>
int launch(Args a, int kv_dtype, int quant, int per_query_head,
           void* stream) {
  if (a.Dh / 4 > kMaxDq) return kErrHeadDim;
  const int rep = a.H / a.Hkv;
  const int qr = per_query_head ? 1 : (rep <= 2 ? 2 : (rep <= 4 ? 4 : 8));
  a.n_qc = (rep + qr - 1) / qr;
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2)
    return quant ? launch_qr<int8_t, true, kContig>(a, qr, s, smem)
                 : launch_qr<int8_t, false, kContig>(a, qr, s, smem);
  if (kv_dtype == 1)
    return quant ? launch_qr<__nv_bfloat16, true, kContig>(a, qr, s, smem)
                 : launch_qr<__nv_bfloat16, false, kContig>(a, qr, s, smem);
  return quant ? launch_qr<float, true, kContig>(a, qr, s, smem)
               : launch_qr<float, false, kContig>(a, qr, s, smem);
}

}  // namespace split_decode
