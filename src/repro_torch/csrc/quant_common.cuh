// Shared device helpers for the group fake-quant kernels: dtype conversion
// and the closed forms of core.quant (q_min = 0), written so that each value
// rounds exactly as the plain PyTorch version's separate operations do.
// Built with -fmad=false (no fused multiply-add contraction) and without
// --use_fast_math (IEEE division, no flush-to-zero); rintf rounds half to
// even like torch.round / jnp.round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rq {

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eqns. 2-3: scale = max((max - min) / q_max, 1e-8),
//            zero  = clip(round(-min / scale), 0, q_max).
__device__ __forceinline__ void group_params(float wmin, float wmax,
                                             float qmax, float* scale,
                                             float* zero) {
  const float s = fmaxf((wmax - wmin) / qmax, 1e-8f);
  *scale = s;
  *zero = fminf(fmaxf(rintf(-wmin / s), 0.0f), qmax);
}

// Eqns. 2-3 with the range (max - min), the scale and its 1e-8 floor each
// rounded to T as they are computed: the reference's compute_qparams on a
// w of dtype T (bf16 arithmetic there), then widened to f32 as its
// scale_dtype. For T = float it is group_params.
template <typename T>
__device__ __forceinline__ void group_params_rounded(float wmin, float wmax,
                                                     float qmax, float* scale,
                                                     float* zero) {
  const float range = to_f32(from_f32<T>(wmax - wmin));
  const float s = fmaxf(to_f32(from_f32<T>(range / qmax)),
                        to_f32(from_f32<T>(1e-8f)));
  *scale = s;
  *zero = fminf(fmaxf(rintf(-wmin / s), 0.0f), qmax);
}

// Eqn. 1: the code q = clip(round(w / scale) + zero, 0, q_max), an integer
// in [0, q_max] held exactly as a float (and in a byte, q_max <= 255).
__device__ __forceinline__ float quant_code(float w, float scale, float zero,
                                            float qmax) {
  return fminf(fmaxf(rintf(w / scale) + zero, 0.0f), qmax);
}

// Eqn. 4: (q - zero) * scale.
__device__ __forceinline__ float dequant_code(float q, float scale,
                                              float zero) {
  return (q - zero) * scale;
}

// Eqns. 1 and 4: (clip(round(w / scale) + zero, 0, q_max) - zero) * scale.
__device__ __forceinline__ float fake_quant_value(float w, float scale,
                                                  float zero, float qmax) {
  return dequant_code(quant_code(w, scale, zero, qmax), scale, zero);
}

}  // namespace rq
