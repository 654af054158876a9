// One-token decode attention over a contiguous KV cache: the body of the
// flash decode kernel (flash_decode.cu includes it and only fills in
// Args). The three paged routes run the split-KV body of split_decode.cuh,
// which takes load4 and the warp reductions from here.
//
//   out[b,h] = softmax(q[b,h] . K[b, :kv_len, h/rep]^T / sqrt(Dh)) . V[...]
//
// q (B, H, Dh) f32; K/V (B, S, Hkv, Dh) f32, bf16 or int8 (+ f32 scales
// (B, S, Hkv)). Output out (B, H, Dh) f32, normalised by max(l, 1e-30).
//
// A CTA owns the rep query heads of KV head g of sequence b and walks the
// live positions in tiles of `tile` rows, one online-softmax update per
// tile, so shared memory never grows with the cache.
//
// Bound: bytes. At decode the live K/V bytes dominate (16 KiB per token per
// layer at opt-1.3b in fp32: 32 heads x 64 x 4 B x 2), against about 4
// flops per K/V value. Design: each CTA loops over live positions only,
// and stages the tile's live K/V rows once into shared memory
// as f32 — int8 rows dequantised with their per-(slot, head) scales on the
// way — with neighbouring threads on neighbouring 4-value pieces of a row,
// so every row read is coalesced and vectorised, and each thread keeps
// several loads in flight (a first version that loaded one value per
// iteration was latency-bound: 5.7 us per page at 1024 tokens). Each K/V
// row is read once for all rep query heads. (m, l, acc) stay in shared
// memory in f32.
//
// Positions at or past kv_len are masked by SELECTION: they are never
// loaded, their score is set to -1e30 and their probability to 0 without
// touching K or V, so a NaN there cannot reach the arithmetic (0 * NaN
// would be NaN). kv_len = 0 keeps m = -1e30, l = 0, acc = 0 and returns
// exactly 0.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode_attention {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

constexpr int kUnroll = 4;  // 4-value loads a thread keeps in flight

// returned (instead of a CUDA error) when one CTA would need more shared
// memory than the card gives a block; the bindings raise on it
constexpr int kErrSmem = -1;

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

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  int kv_len;          // live rows of every sequence (S where larger)
  float* out;
  int H, Hkv, Dh, S;
  int tile;            // positions per online-softmax update
  float scale;         // Dh ** -0.5
};

// floats of dynamic shared memory for one CTA (the layout at the top of
// decode_kernel)
inline int64_t smem_floats(int tile, int nq, int dh) {
  return 2LL * tile * dh + 2LL * nq * dh + (int64_t)nq * tile + 3LL * nq;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  extern __shared__ float smem[];
  const int Dh = a.Dh;
  const int nq = a.H / a.Hkv;  // rep
  const int tile_len = a.tile;
  float* k_t = smem;                      // (tile_len, Dh) staged K
  float* v_t = k_t + tile_len * Dh;       // (tile_len, Dh) staged V
  float* q_s = v_t + tile_len * Dh;       // (nq, Dh)
  float* acc = q_s + nq * Dh;             // (nq, Dh)
  float* s = acc + nq * Dh;               // (nq, tile_len) scores, then probs
  float* m_s = s + nq * tile_len;         // (nq,)
  float* l_s = m_s + nq;
  float* corr_s = l_s + nq;

  const int b = blockIdx.x;
  const int g = blockIdx.y;  // KV head
  const int h0 = g * nq;     // first query head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(a.kv_len, a.S);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  const float* qg = a.q + ((int64_t)b * a.H + h0) * Dh;
  for (int i = tid; i < nq * Dh; i += kThreads) {
    q_s[i] = qg[i];
    acc[i] = 0.f;
  }
  for (int i = tid; i < nq; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  int n_tiles = (len + tile_len - 1) / tile_len;
  n_tiles = n_tiles < 1 ? 1 : n_tiles;
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int start = tile * tile_len;
    int nv = len - start;  // live positions of this tile: the first nv
    nv = nv < 0 ? 0 : (nv > tile_len ? tile_len : nv);

    // 1. stage the live rows (f32, dequantised); nothing past len is read.
    // Each thread issues all of its kUnroll 4-value loads before it stores
    // any, so their device-memory latencies overlap.
    const int dv = Dh / 4;
    const int n4 = nv * dv;
    for (int base = tid; base < n4; base += kThreads * kUnroll) {
      float4 kr[kUnroll], vr[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + u * kThreads;
        if (e < n4) {
          const int t = e / dv, d = (e - t * dv) * 4;
          const int64_t row = ((int64_t)b * a.S + start + t) * a.Hkv + g;
          kr[u] = load4(kp + row * Dh + d);
          vr[u] = load4(vp + row * Dh + d);
          if (kQuant) {
            ksc[u] = a.ks[row];
            vsc[u] = a.vs[row];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + u * kThreads;
        if (e < n4) {
          if (kQuant) {
            kr[u] = make_float4(kr[u].x * ksc[u], kr[u].y * ksc[u],
                                kr[u].z * ksc[u], kr[u].w * ksc[u]);
            vr[u] = make_float4(vr[u].x * vsc[u], vr[u].y * vsc[u],
                                vr[u].z * vsc[u], vr[u].w * vsc[u]);
          }
          reinterpret_cast<float4*>(k_t)[e] = kr[u];
          reinterpret_cast<float4*>(v_t)[e] = vr[u];
        }
      }
    }
    __syncthreads();

    // 2. scores: one warp per (query row, position), lanes split Dh
    for (int pi = warp; pi < nq * tile_len; pi += kWarps) {
      const int qi = pi / tile_len, t = pi - qi * tile_len;
      if (t >= nv) {  // masked by selection: K is not read
        if (lane == 0) s[pi] = kNeg;
        continue;
      }
      float dot = 0.f;
      for (int d = lane; d < Dh; d += 32) dot += q_s[qi * Dh + d] * k_t[t * Dh + d];
      dot = warp_sum(dot);
      if (lane == 0) s[pi] = dot * a.scale;
    }
    __syncthreads();

    // 3. online-softmax update, one warp per query row
    for (int qi = warp; qi < nq; qi += kWarps) {
      float* row = s + qi * tile_len;
      float mx = kNeg;
      for (int t = lane; t < tile_len; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile_len; t += 32) {
        const float p = t < nv ? expf(row[t] - m_new) : 0.f;
        row[t] = p;
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

    // 4. acc = acc * corr + p @ V over the live positions only
    for (int i = tid; i < nq * Dh; i += kThreads) {
      const int qi = i / Dh, d = i - qi * Dh;
      const float* p = s + qi * tile_len;
      float pv = 0.f;
      for (int t = 0; t < nv; ++t) pv += p[t] * v_t[t * Dh + d];
      acc[i] = acc[i] * corr_s[qi] + pv;
    }
    __syncthreads();
  }

  float* og = a.out + ((int64_t)b * a.H + h0) * Dh;
  for (int i = tid; i < nq * Dh; i += kThreads)
    og[i] = acc[i] / fmaxf(l_s[i / Dh], 1e-30f);
}

template <typename T, bool kQuant>
int launch_typed(const Args& a, int B, size_t smem, cudaStream_t stream) {
  auto kernel = decode_kernel<T, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)B, (unsigned)a.Hkv), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch over B sequences. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8; quant: scales given. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess), or kErrSmem without launching.
inline int launch(const Args& a, int B, int kv_dtype, int quant,
                  void* stream) {
  const int nq = a.H / a.Hkv;
  const size_t smem = sizeof(float) * (size_t)smem_floats(a.tile, nq, a.Dh);
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)max_smem) return kErrSmem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2)
    return quant ? launch_typed<int8_t, true>(a, B, smem, s)
                 : launch_typed<int8_t, false>(a, B, smem, s);
  if (kv_dtype == 1)
    return quant ? launch_typed<__nv_bfloat16, true>(a, B, smem, s)
                 : launch_typed<__nv_bfloat16, false>(a, B, smem, s);
  return quant ? launch_typed<float, true>(a, B, smem, s)
               : launch_typed<float, false>(a, B, smem, s);
}

}  // namespace decode_attention
