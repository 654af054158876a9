// One-token decode attention over a contiguous KV cache.
//
//   out[b,h] = softmax(q[b,h] . K[b, :kv_len, h/rep]^T / sqrt(Dh)) . V[...]
//
// q (B, H, Dh) f32; K/V (B, S, Hkv, Dh) f32, bf16 or int8 (+ f32 scales
// (B, S, Hkv)); kv_len in [0, S]. Output out (B, H, Dh) f32, normalised by
// max(l, 1e-30); kv_len = 0 gives exactly 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas), which streams every chunk of the max_len buffer
// and masks the positions at or past kv_len, needs S % chunk == 0, and
// takes GQA caches with their KV heads repeated to H first (the
// reference's models/layers.py does so before its flash route). Here the
// cache runs through the contiguous flavour of the split-KV body of
// split_decode.cuh (bound and design are described there): the cache is a
// pool of one-row pages, row b * S + pos for position pos of sequence b,
// every sequence kv_len rows long. The binding's planner (kernels/flash_decode.py, with the paged
// routes' plan) cuts the kv_len live rows into n_split runs across CTAs,
// so one long sequence still fills the card; a second small kernel merges
// the runs' partials when there is more than one. A CTA holds one query
// head at rep 1 (QR 1) and the rep query heads of one KV head otherwise
// (QR 2/4/8), so each live K/V row is read once and no repeated cache
// exists; only rows below kv_len are loaded, staged a few tiles deep with
// cp.async, so shared memory does not grow with S and any S works; masking
// is by selection, so NaN past kv_len is never read. Bound: bytes — the
// live K/V rows (2 x kv_len x Hkv x Dh values per sequence) dominate.
#include "split_decode.cuh"

// Returns cudaGetLastError() after the launches (0 = cudaSuccess),
// kErrSmem (-1) without launching when one CTA's tiles need more shared
// memory than a block has, or kErrHeadDim (-2) without launching when
// Dh > 1024. ws_acc (n_split, B, H, Dh), ws_m and ws_l (n_split, B, H) are
// the partials' workspace, unused (may be null) when n_split == 1; the
// kv_len live rows of each sequence are cut into n_split runs of run_rows
// rows, staged tile_rows rows at a time.
extern "C" int rq_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, void* out,
                               void* ws_acc, void* ws_m, void* ws_l, int B,
                               int H, int Hkv, int Dh, int S, int kv_len,
                               int n_split, int run_rows, int tile_rows,
                               int kv_dtype, int quant, float scale,
                               void* stream) {
  split_decode::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.out = static_cast<float*>(out);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_m = static_cast<float*>(ws_m);
  a.ws_l = static_cast<float*>(ws_l);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Dh = Dh;
  a.psz = 1;
  a.P = kv_len;
  a.S = S;
  a.run_pages = run_rows;
  a.n_split = n_split;
  a.tile_rows = tile_rows;
  a.normalize = 1;
  a.scale = scale;
  return split_decode::launch<true>(a, kv_dtype, quant, H == Hkv, stream);
}
