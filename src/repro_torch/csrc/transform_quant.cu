// Fused invariant transform (pi, s, phi) + group fake-quant round trip.
//
// Replaces the TPU kernel src/repro/kernels/transform_quant.py,
// transform_quant_pallas (bodies _kernel_up and _kernel_down).
//
//   "up":   w (D, F). Rotate column pairs (2i, 2i+1) by phi_i, scale columns
//           by s, permute columns by pi; quant groups of G rows run along D.
//   "down": w (F, D). Rotate row pairs by phi_i, scale rows by 1/s, permute
//           rows by pi; quant groups run along F, so pi changes group
//           membership and the transform cannot be split from the
//           quantisation.
//
// Output element (r, j) of "up" is rot(w)[r, pi[j]] * s[pi[j]]; output row i
// of "down" is rot(w)[pi[i], :] * (1/s)[pi[i]]. pi is a gather index (any
// values in [0, f), duplicates included). The wrapper passes cos(phi),
// sin(phi) and the scale vector (s, or 1/s for "down") computed by PyTorch,
// so the kernel and the plain version share them bit for bit; -fmad=false
// keeps c*a - s*b as two rounded products and a rounded difference, like
// the plain version's separate tensor operations.
//
// w and fq are f32 or bf16 (the TPU kernel's w.dtype): a bf16 value is
// widened to f32 as it is loaded, every operation is the f32 one in the
// same order, and fq is rounded to bf16 once as it is stored; scale and
// zero are f32 either way (the TPU kernel's out_shape).
//
// Bound: bytes. About fifteen operations per element against 8 bytes moved
// in f32 (one read of w, one write of fq), 4 in bf16. The launch
// parameters come from the pure-Python planner
// kernels/transform_quant.py::plan.
//
// "up" design. A column's group statistics depend only on its source column:
// pi moves whole quantised columns. So each quant band (G rows) is one thread
// block cluster whose CTAs split the F source columns into contiguous
// slices. A CTA reads its slice in source order (a thread per column, the
// pair partner from the neighbouring lane by a warp shuffle, coalesced
// loads with the whole group in flight), takes the per-column min/max,
// scale and zero, and stores the column's codes (round(v / scale) + zero,
// clipped: an integer in [0, 255]) as bytes in shared memory, 16 rows to a
// 16-byte word. After cluster.sync() each CTA produces its slice of OUTPUT
// columns: it gathers the codes, scale and zero of column pi[j] from the
// owning CTA's shared memory (distributed shared memory) and writes
// coalesced rows of fq = (code - zero) * scale — the plain version's last
// two operations — and of scale and zero. w is read once and fq written
// once when a thread can hold its column's group (G <= 32) and the cluster
// the band's codes; otherwise a first pass takes the statistics and a
// second streams the codes in sub-bands of R rows, a cluster barrier after
// each (the second read mostly hits L2). Four 256-thread CTAs share an SM
// (64 registers a thread), so one cluster's reads overlap another's gather
// and writes; with one CTA an SM the phases of a band run one after the
// other.
//
// "down" design. One CTA per (group, column tile). It loads the group's pi,
// cos, sin and scale entries into shared memory once, stages the G source
// rows and their pair-partner rows of its tile with cp.async (16-byte
// copies of 4 f32 or 8 bf16 values, all in flight together), computes each
// transformed value once into shared memory (f32; a bf16 tile keeps its
// staged rows and computes each value again for the write), reduces
// min/max over row slices, and writes fq 16 bytes at a time.
#include <cooperative_groups.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "quant_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUpThreads = 256;    // kernels/transform_quant.py UP_THREADS
constexpr int kUpBlocks = 4;       // "up" CTAs an SM holds (registers)
constexpr int kHoldRows = 32;      // kernels/transform_quant.py UP_HOLD_ROWS
constexpr int kDownThreads = 256;  // kernels/transform_quant.py DOWN_THREADS

// Rotated value of pair member `odd` of the pair (a, b): the plain
// version's ra = c*a - s*b, rb = s*a + c*b.
__device__ __forceinline__ float rotate(float a, float b, float c, float sn,
                                        bool odd) {
  return odd ? (sn * a + c * b) : (c * a - sn * b);
}

// The transformed value of column col from its own value x and its pair
// partner's value y (the neighbouring lane's).
__device__ __forceinline__ float transform(float x, float y, float c,
                                           float sn, float sv, bool odd) {
  return (odd ? rotate(y, x, c, sn, true) : rotate(x, y, c, sn, false)) * sv;
}

// The code of value v as byte i % 4 of a 32-bit word.
__device__ __forceinline__ unsigned code_byte(float v, float s, float z,
                                              float qmax, int i) {
  return (unsigned)rq::quant_code(v, s, z, qmax) << (8 * (i % 4));
}

// The cluster of a band: CTA `rank` owns source (and output) columns
// [rank * slice, rank * slice + slice) of the band's rows; sub-bands of
// `rows` rows. One thread per source column at a time (neighbouring lanes
// hold a rotation pair: slice and blockDim.x are even). Shared memory:
// codes [ceil(rows / 16)][slice] 16-byte words (word h of a column holds
// rows 16h .. 16h + 15, one byte each), (scale, zero) per column, then pi
// of the CTA's output columns.
template <typename T>
__global__ void __launch_bounds__(kUpThreads, kUpBlocks)
transform_quant_up_kernel(
    const T* __restrict__ w, const int64_t* __restrict__ pi,
    const float* __restrict__ svec, const float* __restrict__ cosv,
    const float* __restrict__ sinv, T* __restrict__ fq,
    float* __restrict__ scale, float* __restrict__ zero, int f, int group,
    int slice, int rows, float qmax) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t band = blockIdx.x / cluster.num_blocks();
  const int chunks = (rows + 15) / 16;
  const bool one_pass = rows == group && group <= kHoldRows;

  extern __shared__ uint4 smem_up[];
  uint4* codes = smem_up;                                    // [chunks][slice]
  float2* sz = reinterpret_cast<float2*>(codes + (int64_t)chunks * slice);
  int* srcs = reinterpret_cast<int*>(sz + slice);            // [slice]

  const int c0 = rank * slice;
  const int ncols = max(0, min(slice, f - c0));   // even: f and slice are
  const T* wband = w + band * group * f;

  for (int jl = threadIdx.x; jl < ncols; jl += blockDim.x)
    srcs[jl] = (int)pi[c0 + jl];   // read after the first cluster barrier

  // statistics (and, in one pass, codes) in source order; every lane of a
  // warp runs every iteration, for the partner shuffle
  for (int base = 0; base < ncols; base += blockDim.x) {
    const int cl = base + threadIdx.x;
    const bool live = cl < ncols;
    const int col = c0 + cl;
    const bool odd = (col & 1) != 0;
    float c = 0.0f, sn = 0.0f, sv = 0.0f;
    if (live) {
      c = cosv[col >> 1];
      sn = sinv[col >> 1];
      sv = svec[col];
    }
    const T* src = wband + col;
    float lo = CUDART_INF_F, hi = -CUDART_INF_F;
    if (one_pass) {   // the group in registers: values, statistics, codes
      float x[kHoldRows];
#pragma unroll
      for (int i = 0; i < kHoldRows; ++i)
        x[i] = live && i < group ? rq::to_f32(src[(int64_t)i * f]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kHoldRows; ++i)
        if (i < group) {
          const float y = __shfl_xor_sync(0xffffffffu, x[i], 1);
          x[i] = transform(x[i], y, c, sn, sv, odd);
          lo = fminf(lo, x[i]);
          hi = fmaxf(hi, x[i]);
        }
      if (live) {
        float s, z;
        rq::group_params(lo, hi, qmax, &s, &z);
        sz[cl] = make_float2(s, z);
#pragma unroll
        for (int h = 0; h < kHoldRows / 16; ++h)
          if (h < chunks) {
            unsigned a[4] = {0, 0, 0, 0};
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if (16 * h + i < group)
                a[i / 4] |= code_byte(x[16 * h + i], s, z, qmax, i);
            codes[h * slice + cl] = make_uint4(a[0], a[1], a[2], a[3]);
          }
      }
    } else {          // statistics over the whole group first
      for (int r0 = 0; r0 < group; r0 += 16) {
        float x[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          x[i] = live && r0 + i < group
                     ? rq::to_f32(src[(int64_t)(r0 + i) * f]) : 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (r0 + i < group) {
            const float y = __shfl_xor_sync(0xffffffffu, x[i], 1);
            const float v = transform(x[i], y, c, sn, sv, odd);
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
          }
      }
      if (live) {
        float s, z;
        rq::group_params(lo, hi, qmax, &s, &z);
        sz[cl] = make_float2(s, z);
      }
    }
  }

  for (int b0 = 0; b0 < group; b0 += rows) {
    const int nrows = min(rows, group - b0);
    if (!one_pass) {   // this sub-band's codes, from the statistics (each
      // thread reads back only the (scale, zero) it wrote)
      for (int base = 0; base < ncols; base += blockDim.x) {
        const int cl = base + threadIdx.x;
        const bool live = cl < ncols;
        const int col = c0 + cl;
        const bool odd = (col & 1) != 0;
        float c = 0.0f, sn = 0.0f, sv = 0.0f;
        float2 q = make_float2(1.0f, 0.0f);
        if (live) {
          c = cosv[col >> 1];
          sn = sinv[col >> 1];
          sv = svec[col];
          q = sz[cl];
        }
        const T* src = wband + (int64_t)b0 * f + col;
        for (int h = 0; h < chunks; ++h) {
          float x[16];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            x[i] = live && 16 * h + i < nrows
                       ? rq::to_f32(src[(int64_t)(16 * h + i) * f]) : 0.0f;
          unsigned a[4] = {0, 0, 0, 0};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (16 * h + i < nrows) {
              const float y = __shfl_xor_sync(0xffffffffu, x[i], 1);
              const float v = transform(x[i], y, c, sn, sv, odd);
              a[i / 4] |= code_byte(v, q.x, q.y, qmax, i);
            }
          if (live) codes[h * slice + cl] = make_uint4(a[0], a[1], a[2], a[3]);
        }
      }
    }
    cluster.sync();   // every slice's codes of the sub-band are in place

    // resolve pi: gather output column j from the CTA owning pi[j]
    for (int jl = threadIdx.x; jl < ncols; jl += blockDim.x) {
      const int64_t j = c0 + jl;
      const int owner = srcs[jl] / slice;
      const int loc = srcs[jl] - owner * slice;
      const uint4* rc = cluster.map_shared_rank(codes, owner) + loc;
      const float2 q = cluster.map_shared_rank(sz, owner)[loc];
      if (b0 == 0) {
        scale[band * f + j] = q.x;
        zero[band * f + j] = q.y;
      }
      T* out = fq + (band * group + b0) * (int64_t)f + j;
      for (int h0 = 0; h0 < chunks; h0 += 2) {   // 32 rows: 2 words
        uint4 cw[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          cw[m] = h0 + m < chunks ? rc[(int64_t)(h0 + m) * slice]
                                  : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const unsigned wd[4] = {cw[m].x, cw[m].y, cw[m].z, cw[m].w};
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int r = 16 * (h0 + m) + i;
            if (h0 + m < chunks && r < nrows)
              out[(int64_t)r * f] = rq::from_f32<T>(rq::dequant_code(
                  (float)((wd[i / 4] >> (8 * (i % 4))) & 0xffu), q.x, q.y));
          }
        }
      }
    }
    cluster.sync();   // no CTA overwrites or leaves while others read it
  }
}

// Stage VEC values of T from device to shared memory: a 16-byte or 4-byte
// cp.async, or a plain load for a 2-byte single value.
template <typename T, int VEC>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  constexpr int kBytes = (int)sizeof(T) * VEC;
  static_assert(kBytes == 16 || kBytes == 4 || kBytes == 2, "copy size");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

// VEC values of T in one aligned access (16 bytes at most).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC], const T* p) {
  if constexpr (sizeof(T) * VEC <= 16) {
    const Pack<T, VEC> t = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = rq::to_f32(t.v[e]);
  } else {   // f32 VEC 8: two 16-byte loads
#pragma unroll
    for (int h = 0; h < VEC; h += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + h);
      x[h] = t.x; x[h + 1] = t.y; x[h + 2] = t.z; x[h + 3] = t.w;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  if constexpr (sizeof(T) * VEC <= 16) {
    Pack<T, VEC> t;
#pragma unroll
    for (int e = 0; e < VEC; ++e) t.v[e] = rq::from_f32<T>(x[e]);
    *reinterpret_cast<Pack<T, VEC>*>(p) = t;
  } else {
#pragma unroll
    for (int h = 0; h < VEC; h += 4)
      *reinterpret_cast<float4*>(p + h) =
          make_float4(x[h], x[h + 1], x[h + 2], x[h + 3]);
  }
}

// The transformed value of staged row r's VEC columns from its source row
// x and the pair partner p: the source row is the pair's second member
// when it is odd.
template <int VEC>
__device__ __forceinline__ void transform_row(float (&x)[VEC],
                                             const float (&p)[VEC], bool odd,
                                             float cr, float sr, float vr) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    x[e] = (odd ? rotate(p[e], x[e], cr, sr, true)
                : rotate(x[e], p[e], cr, sr, false)) * vr;
}

// One CTA per (group g, tile of units * VEC columns); kDownThreads threads
// = units column units x (kDownThreads / units) row slices. An f32 tile
// keeps the transformed values in the staged rows (written over the source
// row); a bf16 tile cannot, so it transforms each value again for the
// write, from the same staged inputs by the same operations.
template <typename T, int VEC>
__global__ void __launch_bounds__(kDownThreads) transform_quant_down_kernel(
    const T* __restrict__ w, const int64_t* __restrict__ pi,
    const float* __restrict__ svec, const float* __restrict__ cosv,
    const float* __restrict__ sinv, T* __restrict__ fq,
    float* __restrict__ scale, float* __restrict__ zero, int64_t n,
    int group, int units, int tiles, float qmax) {
  constexpr bool kKeep = std::is_same<T, float>::value;
  const int tw = units * VEC;                      // tile width, columns
  const int slices = blockDim.x / units;
  extern __shared__ float4 smem_down[];
  T* xs = reinterpret_cast<T*>(smem_down);         // [group][tw] source rows
  T* ps = xs + group * tw;                         // [group][tw] partners
  float* mn = reinterpret_cast<float*>(ps + group * tw);  // [slices][tw]
  float* mx = mn + slices * tw;                    // [slices][tw]
  float* cs = mx + slices * tw;                    // [group] cos, sin, scale
  float* ss = cs + group;
  float* vs = ss + group;
  int* rsrc = reinterpret_cast<int*>(vs + group);  // [group] source rows

  const int tile = blockIdx.x % tiles;
  const int64_t g = blockIdx.x / tiles;
  const int64_t col0 = (int64_t)tile * tw;

  for (int r = threadIdx.x; r < group; r += blockDim.x) {
    const int src = (int)pi[g * group + r];
    rsrc[r] = src;
    cs[r] = cosv[src >> 1];
    ss[r] = sinv[src >> 1];
    vs[r] = svec[src];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < group * units; k += blockDim.x) {
    const int r = k / units, c = k - r * units;
    const int64_t col = col0 + c * VEC;
    if (col < n) {
      const int src = rsrc[r];
      copy_async<T, VEC>(xs + r * tw + c * VEC, w + (int64_t)src * n + col);
      copy_async<T, VEC>(ps + r * tw + c * VEC,
                         w + (int64_t)(src ^ 1) * n + col);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int c = threadIdx.x % units, sl = threadIdx.x / units;
  const int64_t col = col0 + c * VEC;
  const bool live = col < n;
  const int per = (group + slices - 1) / slices;
  const int r_lo = min(group, sl * per), r_hi = min(group, r_lo + per);
  float lo[VEC], hi[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    lo[e] = CUDART_INF_F;
    hi[e] = -CUDART_INF_F;
  }
  if (live) {
    for (int r = r_lo; r < r_hi; ++r) {
      float x[VEC], p[VEC];
      load_vec<T, VEC>(x, xs + r * tw + c * VEC);
      load_vec<T, VEC>(p, ps + r * tw + c * VEC);
      transform_row<VEC>(x, p, (rsrc[r] & 1) != 0, cs[r], ss[r], vs[r]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        lo[e] = fminf(lo[e], x[e]);
        hi[e] = fmaxf(hi[e], x[e]);
      }
      if constexpr (kKeep)
        store_vec<T, VEC>(xs + r * tw + c * VEC, x);   // kept for the write
    }
  }
  store_vec<float, VEC>(mn + sl * tw + c * VEC, lo);
  store_vec<float, VEC>(mx + sl * tw + c * VEC, hi);
  __syncthreads();
  if (!live) return;

  float s[VEC], z[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    lo[e] = CUDART_INF_F;
    hi[e] = -CUDART_INF_F;
  }
  for (int k = 0; k < slices; ++k) {
    float a[VEC], b[VEC];
    load_vec<float, VEC>(a, mn + k * tw + c * VEC);
    load_vec<float, VEC>(b, mx + k * tw + c * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      lo[e] = fminf(lo[e], a[e]);
      hi[e] = fmaxf(hi[e], b[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    rq::group_params(lo[e], hi[e], qmax, &s[e], &z[e]);
  for (int r = r_lo; r < r_hi; ++r) {
    float x[VEC];
    load_vec<T, VEC>(x, xs + r * tw + c * VEC);
    if constexpr (!kKeep) {
      float p[VEC];
      load_vec<T, VEC>(p, ps + r * tw + c * VEC);
      transform_row<VEC>(x, p, (rsrc[r] & 1) != 0, cs[r], ss[r], vs[r]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      x[e] = rq::fake_quant_value(x[e], s[e], z[e], qmax);
    store_vec<T, VEC>(fq + (g * group + r) * n + col, x);
  }
  if (sl == 0) {
    store_vec<float, VEC>(scale + g * n + col, s);
    store_vec<float, VEC>(zero + g * n + col, z);
  }
}

template <typename T>
int launch_up(const void* w, const void* pi, const void* svec,
              const void* cosv, const void* sinv, void* fq, void* scale,
              void* zero, int64_t d, int64_t f, int group, int bits,
              int cluster, int slice, int rows, int threads, int smem,
              cudaStream_t stream) {
  auto kernel = transform_quant_up_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(d / group * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(w),
      static_cast<const int64_t*>(pi), static_cast<const float*>(svec),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<T*>(fq), static_cast<float*>(scale),
      static_cast<float*>(zero), (int)f, group, slice, rows,
      (float)((1 << bits) - 1));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_down(const void* w, const void* pi, const void* svec,
                const void* cosv, const void* sinv, void* fq, void* scale,
                void* zero, int64_t f, int64_t n, int group, int bits,
                int units, int smem, cudaStream_t stream) {
  const int tw = units * VEC;
  const int tiles = (int)((n + tw - 1) / tw);
  const dim3 grid((unsigned)(f / group * tiles));
  auto kernel = transform_quant_down_kernel<T, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kDownThreads, smem, stream>>>(
      static_cast<const T*>(w), static_cast<const int64_t*>(pi),
      static_cast<const float*>(svec), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<T*>(fq),
      static_cast<float*>(scale), static_cast<float*>(zero), n, group, units,
      tiles, (float)((1 << bits) - 1));
  return (int)cudaGetLastError();
}

}  // namespace

// "up": w (d, f) float32 (dtype 0) or bfloat16 (dtype 1), fq the same;
// pi (f,) int64, svec/cosv/sinv float32. One cluster of `cluster` CTAs per
// band of `group` rows, `slice` columns and `threads` threads per CTA,
// sub-bands of `rows` rows, `smem` bytes of dynamic shared memory
// (kernels/transform_quant.py::plan). Returns cudaGetLastError() after the
// launch (0 = cudaSuccess) or the launch's own error.
extern "C" int rq_transform_quant_up(
    const void* w, const void* pi, const void* svec, const void* cosv,
    const void* sinv, void* fq, void* scale, void* zero, int64_t d,
    int64_t f, int group, int bits, int dtype, int cluster, int slice,
    int rows, int threads, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_up<__nv_bfloat16>(w, pi, svec, cosv, sinv, fq, scale, zero,
                                    d, f, group, bits, cluster, slice, rows,
                                    threads, smem, st);
  return launch_up<float>(w, pi, svec, cosv, sinv, fq, scale, zero, d, f,
                          group, bits, cluster, slice, rows, threads, smem,
                          st);
}

// "down": w (f, n) float32 (dtype 0) or bfloat16 (dtype 1). One CTA per
// (group, tile of units * vec columns), kDownThreads threads, `smem` bytes
// of dynamic shared memory; vec is the values of one 16-byte copy (4 f32,
// 8 bf16; n % vec == 0) or 1.
extern "C" int rq_transform_quant_down(
    const void* w, const void* pi, const void* svec, const void* cosv,
    const void* sinv, void* fq, void* scale, void* zero, int64_t f,
    int64_t n, int group, int bits, int dtype, int units, int vec, int smem,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (vec == 8)
      return launch_down<__nv_bfloat16, 8>(w, pi, svec, cosv, sinv, fq,
                                           scale, zero, f, n, group, bits,
                                           units, smem, st);
    return launch_down<__nv_bfloat16, 1>(w, pi, svec, cosv, sinv, fq, scale,
                                         zero, f, n, group, bits, units,
                                         smem, st);
  }
  if (vec == 4)
    return launch_down<float, 4>(w, pi, svec, cosv, sinv, fq, scale, zero,
                                 f, n, group, bits, units, smem, st);
  return launch_down<float, 1>(w, pi, svec, cosv, sinv, fq, scale, zero, f,
                               n, group, bits, units, smem, st);
}
