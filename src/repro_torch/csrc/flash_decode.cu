// One-token decode attention over a contiguous KV cache.
//
//   out[b,h] = softmax(q[b,h] . K[b, :kv_len, h/rep]^T / sqrt(Dh)) . V[...]
//
// q (B, H, Dh) f32; K/V (B, S, Hkv, Dh) f32, bf16 or int8 (+ f32 scales
// (B, S, Hkv)); kv_len in [0, S]. Output out (B, H, Dh) f32; kv_len = 0
// gives exactly 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_pallas), which streams every chunk of the max_len buffer
// and masks the positions at or past kv_len, needs S % chunk == 0, and
// takes GQA caches with their KV heads repeated to H first
// (models/layers.py::_flash_decode_attention). Here the cache runs through
// the kernel body of decode_attention.cuh (bound and design are described
// there): one CTA per (b, KV head) holds its rep query heads, so each live
// K/V row is read once and no repeated cache exists; only positions below
// kv_len are loaded, in tiles of kTile rows, so shared memory does not grow
// with S and any S works; masking is by selection, so NaN past kv_len is
// never read. Bound: bytes — the live K/V rows (2 x kv_len x Hkv x Dh
// values per sequence) dominate.
#include "decode_attention.cuh"

namespace {

constexpr int kTile = 64;  // rows per online-softmax update

}  // namespace

// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// kErrSmem without launching.
extern "C" int rq_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, void* out,
                               int B, int H, int Hkv, int Dh, int S,
                               int kv_len, int kv_dtype, int quant,
                               float scale, void* stream) {
  decode_attention::Args a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.kv_len = kv_len;
  a.out = static_cast<float*>(out);
  a.H = H;
  a.Hkv = Hkv;
  a.Dh = Dh;
  a.S = S;
  a.tile = kTile;
  a.scale = scale;
  return decode_attention::launch(a, B, kv_dtype, quant, stream);
}
