// Paged one-token decode attention over a block-table page pool.
//
//   out[b,h] = softmax(q[b,h] . K[pages(b), h/rep]^T / sqrt(Dh)) . V[...]
//
// q (B, H, Dh) f32; K/V pools (N, psz, Hkv, Dh) f32, bf16 or int8 (+ f32
// scales (N, psz, Hkv)); block_tables (B, P) int32; seq_lens (B,) int32.
// Outputs out (B, H, Dh) f32 (normalised by max(l, 1e-30), or the raw
// accumulator when normalize == 0) and the log-sum-exp stats m, l (B, H).
//
// Replaces the three TPU kernels of src/repro/kernels/paged_decode.py:
//   rq_paged_decode_head    <- paged_decode_pallas      (one CTA per (b, h))
//   rq_paged_decode_gqa     <- paged_decode_gqa_pallas  (one CTA per (b, g))
//   rq_paged_decode_gqa_mp  <- _gqa_multipage_call      (MP pages per update)
// All three are the kernel body of decode_attention.cuh (bound, design and
// masking are described there): a CTA owns nq query rows (1, or the rep
// query heads of KV head g) and walks the live pages in tiles of mp pages,
// one online-softmax update per tile, so the routes cannot drift apart.
// Only live pages are loaded (n_live = max(ceil(len / psz), 1), as the TPU
// kernel's dead-page skip); the fused-GQA routes read each KV page once for
// all rep query heads, the per-query-head route rep times (from L2).
#include "decode_attention.cuh"

namespace {

using decode_attention::Args;

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* bt, const void* lens, void* out,
               void* m, void* l, int H, int Hkv, int Dh, int psz, int P,
               int per_query_head, int mp, int normalize, float scale) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.bt = static_cast<const int32_t*>(bt);
  a.lens = static_cast<const int32_t*>(lens);
  a.kv_len = 0;
  a.out = static_cast<float*>(out);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.H = H;
  a.Hkv = Hkv;
  a.Dh = Dh;
  a.psz = psz;
  a.P = P;
  a.per_query_head = per_query_head;
  a.tile = mp * psz;
  a.normalize = normalize;
  a.scale = scale;
  return a;
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 = cudaSuccess),
// or kErrSmem without launching.
extern "C" int rq_paged_decode_head(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* bt, const void* lens, void* out, void* m,
    void* l, int B, int H, int Hkv, int Dh, int psz, int P, int normalize,
    int kv_dtype, int quant, float scale, void* stream) {
  return decode_attention::launch(
      make_args(q, k, v, ks, vs, bt, lens, out, m, l, H, Hkv, Dh, psz, P, 1,
                1, normalize, scale),
      B, kv_dtype, quant, stream);
}

extern "C" int rq_paged_decode_gqa(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* bt, const void* lens, void* out, void* m,
    void* l, int B, int H, int Hkv, int Dh, int psz, int P, int normalize,
    int kv_dtype, int quant, float scale, void* stream) {
  return decode_attention::launch(
      make_args(q, k, v, ks, vs, bt, lens, out, m, l, H, Hkv, Dh, psz, P, 0,
                1, normalize, scale),
      B, kv_dtype, quant, stream);
}

extern "C" int rq_paged_decode_gqa_mp(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* bt, const void* lens, void* out, void* m,
    void* l, int B, int H, int Hkv, int Dh, int psz, int P, int mp,
    int normalize, int kv_dtype, int quant, float scale, void* stream) {
  return decode_attention::launch(
      make_args(q, k, v, ks, vs, bt, lens, out, m, l, H, Hkv, Dh, psz, P, 0,
                mp, normalize, scale),
      B, kv_dtype, quant, stream);
}
