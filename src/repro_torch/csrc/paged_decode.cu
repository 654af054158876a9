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
//   rq_paged_decode_head    <- paged_decode_pallas      (per (b, h), split)
//   rq_paged_decode_gqa     <- paged_decode_gqa_pallas  (per (b, g), split)
//   rq_paged_decode_gqa_mp  <- _gqa_multipage_call      (MP pages per update)
// One body, the split-KV body of split_decode.cuh: a CTA owns one query
// head (rq_paged_decode_head) or the rep query heads of one KV head (the
// two fused-GQA entries) over one run of pages (the binding's planner picks
// the runs and the tile's positions: kernels/paged_decode.py), stages tiles
// with cp.async a few deep, and a second small kernel merges the runs'
// (acc, m, l) partials when there is more than one. The fused-GQA entries
// differ in the runs they are given: the multi-page route's runs are whole
// blocks of MP pages.
// Only live pages are loaded (the TPU kernels' dead-page skip, and more: no
// slot at or past the length is read); the fused-GQA routes read each KV
// row once for all rep query heads, the per-query-head route rep times
// (from L2).
#include "split_decode.cuh"

namespace {

split_decode::Args split_args(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* bt, const void* lens, void* out, void* m,
    void* l, void* ws_acc, void* ws_m, void* ws_l, int B, int H, int Hkv,
    int Dh, int psz, int P, int n_split, int run_pages, int tile_rows,
    int normalize, float scale) {
  split_decode::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.bt = static_cast<const int32_t*>(bt);
  a.lens = static_cast<const int32_t*>(lens);
  a.out = static_cast<float*>(out);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_m = static_cast<float*>(ws_m);
  a.ws_l = static_cast<float*>(ws_l);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Dh = Dh;
  a.psz = psz;
  a.P = P;
  a.run_pages = run_pages;
  a.n_split = n_split;
  a.tile_rows = tile_rows;
  a.normalize = normalize;
  a.scale = scale;
  return a;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches (0 =
// cudaSuccess), kErrSmem (-1) without launching when one CTA's tiles need
// more shared memory than a block has, or kErrHeadDim (-2) without
// launching when Dh > 1024. ws_acc (n_split, B, H, Dh), ws_m and ws_l
// (n_split, B, H) are the partials' workspace, unused (may be null) when
// n_split == 1; each sequence is cut into n_split runs of run_pages pages,
// staged tile_rows positions at a time.
#define RQ_PAGED_ENTRY(name, per_query_head)                                 \
  extern "C" int name(                                                       \
      const void* q, const void* k, const void* v, const void* ks,           \
      const void* vs, const void* bt, const void* lens, void* out, void* m,  \
      void* l, void* ws_acc, void* ws_m, void* ws_l, int B, int H, int Hkv,  \
      int Dh, int psz, int P, int n_split, int run_pages, int tile_rows,     \
      int normalize, int kv_dtype, int quant, float scale, void* stream) {   \
    return split_decode::launch<false>(                                      \
        split_args(q, k, v, ks, vs, bt, lens, out, m, l, ws_acc, ws_m, ws_l, \
                   B, H, Hkv, Dh, psz, P, n_split, run_pages, tile_rows,     \
                   normalize, scale),                                        \
        kv_dtype, quant, per_query_head, stream);                            \
  }

RQ_PAGED_ENTRY(rq_paged_decode_head, 1)
RQ_PAGED_ENTRY(rq_paged_decode_gqa, 0)
RQ_PAGED_ENTRY(rq_paged_decode_gqa_mp, 0)
