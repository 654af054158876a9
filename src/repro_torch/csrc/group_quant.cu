// Group fake-quant round trip: w (K, N) -> fq (K, N), scale and zero
// (K/G, N), groups of G contiguous rows per column.
//
// Replaces the TPU kernel src/repro/kernels/group_quant.py,
// group_quant_pallas (body _kernel).
//
// Bound: bytes. About ten operations per element against 8 bytes moved for
// fp32 (one read, one write), so the card's memory rate is the limit. The
// design keeps that rate: w is read from device memory once and fq written
// once, each with 16-byte accesses, and enough loads are in flight per SM.
//
// Tile body (N > 1). A CTA of 256 threads walks (group, column tile)
// blocks. A thread owns one column vector (vec values: 4 f32 or 8 bf16 in
// 16 bytes, narrower when N is not a multiple of that) and the rows
// s, s + S, s + 2S, ... of the group, where S is the number of row slices
// that share a column vector. It loads its rows into registers (at most
// H = 16 vectors, 8 for bf16, all issued before the first is used), takes
// their min/max, combines them across the S slices (warp shuffles; shared
// memory as well when the slices span warps), and writes fq from the
// registers, so w is read once. S is the smallest power of two with
// G <= H S, so a group of 32, 64 or 128 rows is 2, 4 or 8 slices (bf16:
// 4, 8, 16) inside one warp: those three groups are compiled with G fixed
// (every loop unrolled, no row predicate). Other groups run the same body
// with G at run time; a group of more than 16 H rows (a per-column
// quantiser, G = K) spreads its slices over the CTA's warps, up to 128
// slices and 128 H held rows, or 256 H at 2 H rows a thread and one CTA
// an SM; a larger group is read twice (statistics, then codes: the second
// read from L2). A call of between one and two waves of CTAs holds H / 2
// rows instead (see kWave).
// Neighbouring lanes take neighbouring column vectors, so each row access
// of a warp is one run of (32 / slices-per-warp) x 16 contiguous bytes.
//
// Vector body (N = 1, the 1-D path): a group is G contiguous values; a team
// of min(32, largest power of two <= G) lanes reads it with consecutive
// addresses and several groups share a warp, so no lane idles.
//
// The launch plan (body, vec, slices, ...) is make_plan below; the Python
// planner kernels/group_quant.py::plan computes the same and the card
// checks compare the two (rq_group_quant_plan).
//
// round_range: the group's range and scale are rounded to w's dtype (bf16)
// as they are computed, as the reference's jnp fake_quant
// (src/repro/core/quant.py compute_qparams) computes them on a bf16 w; the
// TPU kernel computes them in f32 (round_range 0). Identical for f32 w.
// min/max are taken with fminf/fmaxf in another order than the plain
// version's reduction; they are exact, so only the sign of a zero minimum
// can differ, which no output depends on by value.
#include <cstdint>
#include <cstring>

#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;        // a CTA: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHold = 16;            // values a vector-body lane holds
constexpr int kMaxSlices = 128;      // row slices of a column vector in a CTA
constexpr int64_t kMaxGrid = 2147483647;

enum Body { kFixed = 0, kGeneral = 1, kVector = 2 };

// The fields of rq_group_quant_plan, in order (kernels/group_quant.py Plan).
struct Plan {
  int64_t body, vec, slices, cw, ws, hold, passes, tile, blocks, grid, smem;
};

// Rows a tile-body thread holds: 16 vectors of 16 bytes (64 registers), 8
// for bf16, whose 8 values a vector would otherwise spill at 2 CTAs an SM
// (its per-column min, max, scale and zero take twice the f32 registers).
// The card runs kWave such CTAs at once (2 an SM); a call of between one
// and two waves would run its second wave nearly empty, so it holds half
// as many rows in twice as many blocks, 3 CTAs an SM.
__host__ __device__ constexpr int hold_rows(int esize) {
  return esize == 4 ? 16 : 8;
}
constexpr int64_t kWave = 2 * 132;

int64_t pow2_ceil(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

int64_t pow2_floor(int64_t x) {
  int64_t p = 1;
  while (2 * p <= x) p <<= 1;
  return p;
}

// The tile body's plan for vector width vec and `hold` rows a thread.
Plan tile_plan(int64_t k, int64_t n, int64_t group, int esize, int64_t vec,
               int64_t hold) {
  Plan p{};
  p.vec = vec;
  int64_t s = pow2_ceil((group + hold - 1) / hold);
  if (s > kMaxSlices) s = kMaxSlices;
  p.slices = s;
  const int64_t sw = s <= 16 ? s : 16;                 // slices of a warp
  p.ws = s / sw;
  p.cw = 32 / sw;
  p.hold = hold;
  p.passes = group <= s * hold ? 1 : 2;
  p.body = (vec == 16 / esize && (group == 32 || group == 64 || group == 128))
               ? kFixed : kGeneral;
  const int64_t cvecs = (kWarps / p.ws) * p.cw;        // column vectors
  p.tile = cvecs * vec;
  p.blocks = (k / group) * ((n / vec + cvecs - 1) / cvecs);
  p.smem = (int64_t)sizeof(float) * 2 * kWarps * 16;  // the tile's red
  return p;
}

// align: the largest power of two (<= 16) that divides every base address.
Plan make_plan(int64_t k, int64_t n, int64_t group, int esize, int align) {
  Plan p{};
  if (n == 1) {
    p.body = kVector;
    p.vec = 1;
    p.slices = group < 32 ? pow2_floor(group) : 32;   // lanes of a team
    p.cw = 32 / p.slices;                              // groups of a warp
    p.ws = 1;
    p.hold = kHold;
    p.passes = group <= p.slices * kHold ? 1 : 2;
    p.tile = kWarps * p.cw;                            // groups of a CTA
    p.blocks = (k / group + p.tile - 1) / p.tile;
  } else {
    int64_t vec = 16 / esize;
    while (vec > 1 && (n % vec != 0 || align < (vec * 4 < 16 ? vec * 4 : 16)))
      vec /= 2;
    const int64_t hold = hold_rows(esize);
    p = tile_plan(k, n, group, esize, vec, hold);
    if (p.passes == 2 && group <= kMaxSlices * 2 * hold)
      p = tile_plan(k, n, group, esize, vec, 2 * hold);  // one CTA an SM
    else if (p.blocks > kWave && p.blocks < 2 * kWave &&
             p.slices <= 8)   // halved, the slices stay in one warp
      p = tile_plan(k, n, group, esize, vec, hold / 2);
  }
  p.grid = p.blocks < kMaxGrid ? p.blocks : kMaxGrid;
  return p;
}

template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// VEC values of one access.
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  const R r = *reinterpret_cast<const R*>(p);
  Pack<T, VEC> out;
  memcpy(&out, &r, sizeof(R));
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  R r;
  memcpy(&r, &v, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

// VEC f32 values, in 16-byte stores (VEC = 8: two).
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  constexpr int kPart = VEC < 4 ? VEC : 4;
#pragma unroll
  for (int i = 0; i < VEC; i += kPart) {
    Pack<float, kPart> q;
#pragma unroll
    for (int j = 0; j < kPart; ++j) q.v[j] = v[i + j];
    store_pack<float, kPart>(p + i, q);
  }
}

template <typename T>
__device__ __forceinline__ void qparams(float wmin, float wmax, float qmax,
                                        bool round_range, float* s, float* z) {
  if (round_range)
    rq::group_params_rounded<T>(wmin, wmax, qmax, s, z);
  else
    rq::group_params(wmin, wmax, qmax, s, z);
}

template <typename T, int VEC>
__device__ __forceinline__ void minmax(const Pack<T, VEC>& x, float* mn,
                                       float* mx) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = rq::to_f32(x.v[j]);
    mn[j] = fminf(mn[j], v);
    mx[j] = fmaxf(mx[j], v);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> quant(const Pack<T, VEC>& x,
                                              const float* s, const float* z,
                                              float qmax) {
  float f[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    f[j] = rq::fake_quant_value(rq::to_f32(x.v[j]), s[j], z[j], qmax);
  Pack<T, VEC> y;
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    // two values a conversion, each rounded to nearest even as
    // rq::from_f32 rounds one
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[j], f[j + 1]);
      y.v[j] = h.x;
      y.v[j + 1] = h.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) y.v[j] = rq::from_f32<T>(f[j]);
  }
  return y;
}

// Tile body: HOLD rows a thread; FIXED_G > 0 compiles the group (32, 64
// or 128: one warp's slices, every row held), 0 takes group, sw (slices of
// a warp) and ws (warps along the rows) at run time. See the header.
template <typename T, int VEC, int HOLD, int FIXED_G>
__global__ void __launch_bounds__(
    kThreads, HOLD < hold_rows(sizeof(T)) ? 3
              : HOLD > hold_rows(sizeof(T)) ? 1 : 2)
group_quant_tile(const T* __restrict__ w, T* __restrict__ fq,
        float* __restrict__ scale, float* __restrict__ zero, int64_t n,
        int group, int sw, int ws, int64_t tiles, int64_t blocks, float qmax,
        bool round_range) {
  constexpr bool kFix = FIXED_G > 0;
  constexpr int kRows = HOLD;
  const int G = kFix ? FIXED_G : group;
  const int SW = kFix ? FIXED_G / kRows : sw;
  const int WS = kFix ? 1 : ws;
  const int CW = 32 / SW;
  const int WC = kWarps / WS;
  const int S = SW * WS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c_in = (warp % WC) * CW + lane % CW;   // column vector in the tile
  const int s = (warp / WC) * SW + lane / CW;       // row slice
  const int64_t nvec = n / VEC;
  const bool held = kFix || G <= S * kRows;
  // a warp's partial min (0) and max (1) of its CW <= 2 column vectors
  // when the slices span warps (WS > 1)
  __shared__ float red[2][kWarps][16];

  for (int64_t b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int64_t g = b / tiles;
    const int64_t cv = (b % tiles) * (WC * CW) + c_in;
    const bool live = cv < nvec;
    const int64_t off = g * G * n + cv * VEC;
    const T* src = w + off;
    T* dst = fq + off;

    Pack<T, VEC> v[kRows];
    float mn[VEC], mx[VEC];
    if (held) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        v[i] = live && (kFix || s + i * S < G)
                   ? load_pack<T, VEC>(src + (int64_t)(s + i * S) * n)
                   : Pack<T, VEC>{};
#pragma unroll
      for (int j = 0; j < VEC; ++j) mn[j] = mx[j] = rq::to_f32(v[0].v[j]);
#pragma unroll
      for (int i = 1; i < kRows; ++i)
        if (kFix || s + i * S < G) minmax<T, VEC>(v[i], mn, mx);
    } else {
      // a group beyond the held rows: statistics first (read 1 of 2)
      v[0] = live ? load_pack<T, VEC>(src + (int64_t)s * n) : Pack<T, VEC>{};
#pragma unroll
      for (int j = 0; j < VEC; ++j) mn[j] = mx[j] = rq::to_f32(v[0].v[j]);
#pragma unroll 8
      for (int r = s + S; r < G; r += S)
        if (live) minmax<T, VEC>(load_pack<T, VEC>(src + (int64_t)r * n),
                                 mn, mx);
    }
    // across the slices of a warp (lanes CW apart), then across warps
    for (int o = CW; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        mn[j] = fminf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
      }
    }
    if constexpr (!kFix) {
      if (WS > 1) {      // CW = 2: a warp's partials are lanes 0 and 1
        if (lane < CW) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            red[0][warp][lane * VEC + j] = mn[j];
            red[1][warp][lane * VEC + j] = mx[j];
          }
        }
        __syncthreads();
        for (int k = 0; k < WS; ++k) {
          const int ow = k * WC + warp % WC;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            mn[j] = fminf(mn[j], red[0][ow][(lane % CW) * VEC + j]);
            mx[j] = fmaxf(mx[j], red[1][ow][(lane % CW) * VEC + j]);
          }
        }
        __syncthreads();   // red is written again by the next block
      }
    }
    float sc[VEC], zp[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      qparams<T>(mn[j], mx[j], qmax, round_range, &sc[j], &zp[j]);
    if (!live) continue;
    if (held) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (kFix || s + i * S < G)
          store_pack<T, VEC>(dst + (int64_t)(s + i * S) * n,
                             quant<T, VEC>(v[i], sc, zp, qmax));
    } else {
#pragma unroll 8
      for (int r = s; r < G; r += S)   // read 2 of 2
        store_pack<T, VEC>(
            dst + (int64_t)r * n,
            quant<T, VEC>(load_pack<T, VEC>(src + (int64_t)r * n), sc, zp,
                          qmax));
    }
    if (s == 0) {
      store_f32<VEC>(scale + g * n + cv * VEC, sc);
      store_f32<VEC>(zero + g * n + cv * VEC, zp);
    }
  }
}

// Vector body (N = 1): teams of `team` lanes, one group each, 32 / team
// groups a warp; a lane holds the values lane, lane + team, ... of its
// group (at most kHold; a longer group is read twice).
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_quant_vector(const T* __restrict__ w, T* __restrict__ fq,
          float* __restrict__ scale, float* __restrict__ zero,
          int64_t groups, int group, int team, int64_t blocks, float qmax,
          bool round_range) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = lane % team;
  const bool held = group <= team * kHold;
  for (int64_t b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int64_t g = (b * kWarps + warp) * (32 / team) + lane / team;
    const bool live = g < groups;
    const T* src = w + g * group;
    T v[kHold];
    float mn = 0.0f, mx = 0.0f;
    if (live) {
      v[0] = src[e];
      mn = mx = rq::to_f32(v[0]);
      if (held) {
#pragma unroll
        for (int i = 1; i < kHold; ++i)
          if (e + i * team < group) {
            v[i] = src[e + i * team];
            const float x = rq::to_f32(v[i]);
            mn = fminf(mn, x);
            mx = fmaxf(mx, x);
          }
      } else {
        for (int i = e + team; i < group; i += team) {
          const float x = rq::to_f32(src[i]);
          mn = fminf(mn, x);
          mx = fmaxf(mx, x);
        }
      }
    }
    for (int o = 1; o < team; o <<= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (!live) continue;
    float s, z;
    qparams<T>(mn, mx, qmax, round_range, &s, &z);
    T* dst = fq + g * group;
    if (held) {
#pragma unroll
      for (int i = 0; i < kHold; ++i)
        if (e + i * team < group)
          dst[e + i * team] = rq::from_f32<T>(
              rq::fake_quant_value(rq::to_f32(v[i]), s, z, qmax));
    } else {
      for (int i = e; i < group; i += team)
        dst[i] = rq::from_f32<T>(
            rq::fake_quant_value(rq::to_f32(src[i]), s, z, qmax));
    }
    if (e == 0) {
      scale[g] = s;
      zero[g] = z;
    }
  }
}

int64_t tiles_of(const Plan& p, int64_t n) {
  const int64_t cvecs = (kWarps / p.ws) * p.cw;
  return (n / p.vec + cvecs - 1) / cvecs;
}

template <typename T, int VEC, int HOLD>
void run_held(const Plan& p, const T* w, T* fq, float* scale, float* zero,
              int64_t n, int group, float qmax, bool rr, cudaStream_t st) {
  const dim3 grid((unsigned)p.grid);
  const int64_t tiles = tiles_of(p, n);
  const int sw = (int)(p.slices / p.ws), ws = (int)p.ws;
  if constexpr (VEC * sizeof(T) == 16 && HOLD <= hold_rows(sizeof(T))) {
    if (p.body == kFixed) {
      if (group == 32)
        group_quant_tile<T, VEC, HOLD, 32><<<grid, kThreads, 0, st>>>(
            w, fq, scale, zero, n, group, sw, ws, tiles, p.blocks, qmax, rr);
      else if (group == 64)
        group_quant_tile<T, VEC, HOLD, 64><<<grid, kThreads, 0, st>>>(
            w, fq, scale, zero, n, group, sw, ws, tiles, p.blocks, qmax, rr);
      else
        group_quant_tile<T, VEC, HOLD, 128><<<grid, kThreads, 0, st>>>(
            w, fq, scale, zero, n, group, sw, ws, tiles, p.blocks, qmax, rr);
      return;
    }
  }
  group_quant_tile<T, VEC, HOLD, 0><<<grid, kThreads, 0, st>>>(
      w, fq, scale, zero, n, group, sw, ws, tiles, p.blocks, qmax, rr);
}

// The plan's hold: hold_rows, its half or (a long group) its double.
template <typename T, int VEC>
void run_tile(const Plan& p, const T* w, T* fq, float* scale, float* zero,
              int64_t n, int group, float qmax, bool rr, cudaStream_t st) {
  constexpr int kFull = hold_rows(sizeof(T));
  if (p.hold == kFull)
    run_held<T, VEC, kFull>(p, w, fq, scale, zero, n, group, qmax, rr, st);
  else if (p.hold < kFull)
    run_held<T, VEC, kFull / 2>(p, w, fq, scale, zero, n, group, qmax, rr,
                                st);
  else
    run_held<T, VEC, kFull * 2>(p, w, fq, scale, zero, n, group, qmax, rr,
                                st);
}

int align_of(const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t x = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                      (uintptr_t)d | 16;
  return (int)(x & (~x + 1));
}

template <typename T>
int launch(const void* w_, void* fq_, void* scale_, void* zero_, int64_t k,
           int64_t n, int group, int bits, bool rr, cudaStream_t st) {
  const T* w = static_cast<const T*>(w_);
  T* fq = static_cast<T*>(fq_);
  float* scale = static_cast<float*>(scale_);
  float* zero = static_cast<float*>(zero_);
  const Plan p = make_plan(k, n, group, (int)sizeof(T),
                           align_of(w_, fq_, scale_, zero_));
  const float qmax = (float)((1 << bits) - 1);
  if (p.body == kVector) {
    group_quant_vector<T><<<dim3((unsigned)p.grid), kThreads, 0, st>>>(
        w, fq, scale, zero, k / group, group, (int)p.slices, p.blocks, qmax,
        rr);
  } else {
    switch (p.vec) {
      case 8:
        if constexpr (sizeof(T) == 2) {
          run_tile<T, 8>(p, w, fq, scale, zero, n, group, qmax, rr, st);
          break;
        }
        return (int)cudaErrorInvalidValue;
      case 4:
        run_tile<T, 4>(p, w, fq, scale, zero, n, group, qmax, rr, st);
        break;
      case 2:
        run_tile<T, 2>(p, w, fq, scale, zero, n, group, qmax, rr, st);
        break;
      default:
        run_tile<T, 1>(p, w, fq, scale, zero, n, group, qmax, rr, st);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; round_range: 1 rounds the range and
// the scale to the dtype (see above). Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int rq_group_quant(const void* w, void* fq, void* scale,
                              void* zero, int64_t k, int64_t n, int group,
                              int bits, int dtype, int round_range,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, fq, scale, zero, k, n, group, bits,
                                 round_range != 0, s);
  return launch<float>(w, fq, scale, zero, k, n, group, bits,
                       round_range != 0, s);
}

// The launch plan of rq_group_quant for 16-byte aligned tensors, as 11
// int64 values in Plan's order (body 0 fixed, 1 general, 2 vector).
extern "C" void rq_group_quant_plan(int64_t k, int64_t n, int group,
                                    int dtype, int64_t* out) {
  const Plan p = make_plan(k, n, group, dtype == 1 ? 2 : 4, 16);
  const int64_t f[] = {p.body, p.vec,  p.slices, p.cw,   p.ws,  p.hold,
                       p.passes, p.tile, p.blocks, p.grid, p.smem};
  memcpy(out, f, sizeof(f));
}
