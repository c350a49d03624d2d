// Decode attention over a dense (slot-per-sequence) packed KV cache for
// sm_90a:
//
//   out[b, e, g, :] = softmax_t(q[b, e, g, :] . K[b, t, e, :] / sqrt(hd)) V[b, t, e, :]
//                     over rows t < lengths[b]
//
// K/V are (B, S, KV, hd) int8 codes, or (B, S, KV, hd/2) u8 holding two
// 4-bit codes (low nibble first), each row with an f32 scale (B, S, KV):
// int8 dequantizes to code * scale, int4 to (nibble - 8) * scale. q is
// (B, KV, G, hd) bf16 or f32; out (B, KV, G, hd) f32.
//
// Replaces src/repro/kernels/kv_cache_attention.py: kv_cache_attention_pallas
// (:81, pallas_call at :103; body _kv_attn_kernel :45, _dequant_tile :35).
// The Pallas grid (B, S/bs) walks the cache in tiles of bs rows on a
// sequential grid axis, carrying (m, l, acc) in revisited output blocks,
// and halves bs until it divides S. Here one CUDA block per (b, KV head)
// walks the rows t < lengths[b] of its own (S, KV) slice in a loop, at
// (b * S + t) * KV + e, with (m, l, acc) on chip: no block table, no
// power-of-two block and no tail tile, so S is any length (P + gen at
// the serve loop's default, 48; or 8192 + 16).
//
// The walk is attend_rows (attn_common.cuh), shared with the paged
// kernels: 128-row tiles staged into shared memory as 8-byte words, scores
// by lane groups with warp-shuffle sums, one warp per query row for the
// online softmax, and a two-level PV sum.
//
// What bounds it on the H100: the bytes of the K and V rows it must read,
// lengths[b] * KV * (hd * bits / 8 + 4) * 2 per sequence, plus q and out
// (at B 2, KV 16, hd 64, int8 and 32768 rows: 142.6 MB, 43 us at 3.35
// TB/s). The operations, 4 * G * hd per row and head, are far below the
// tensor cores' rate. The kernel launches B * KV blocks (64 at the serve
// shape B 4, KV 16: under half of the 132 SMs; 32 at B 2, KV 16), so one
// pass over a long cache runs on a quarter of the card. Splitting the walk
// over S, TMA staging and tensor-core QK/PV are later kernel work.
//
// Masking: the walk stops at min(lengths[b], S), so rows past the length
// are never read (the reference's kernel reads every tile and masks them
// to exact zeros). With lengths[b] <= 0 no row is read and the output is
// 0 (the reference's oracle averages every row there); the serve loop
// never passes 0, since its lengths are pos + 1.
//
// The kernel takes hd 16, 32, 64 or 128, G up to 8 (compiled for G == 1
// and for any G up to 8), q bf16 or f32, and bits 8 or 4.
//
// Build without --use_fast_math: expf stays accurate.

#include "attn_common.cuh"

namespace {

// grid (KV, B). GT as in attend_rows: 1 (G == 1) or kMaxG (any G up to it).
template <int BITS, typename TQ, int GT>
__global__ void __launch_bounds__(kThreads)
kv_cache_attn_kernel(const TQ* __restrict__ q, const uint8_t* __restrict__ k_codes,
                     const float* __restrict__ k_sc, const uint8_t* __restrict__ v_codes,
                     const float* __restrict__ v_sc, const int64_t* __restrict__ lengths,
                     float* __restrict__ out, int S, int KV, int G, int hd_shift,
                     float scale) {
    const int e = blockIdx.x, b = blockIdx.y;
    const int64_t n = lengths[b];
    const int t_end = static_cast<int>(n < S ? n : S);
    const size_t first = static_cast<size_t>(b) * S;
    const size_t head = static_cast<size_t>(b) * KV + e;
    const size_t gh = static_cast<size_t>(G) << hd_shift;
    auto row_of = [=](int t) { return (first + t) * KV + e; };
    attend_rows<BITS, TQ, false, GT>(q + head * gh, k_codes, k_sc, v_codes, v_sc, row_of, 0,
                                     t_end, G, hd_shift, scale, out + head * gh, nullptr,
                                     nullptr);
}

template <int BITS, typename TQ>
cudaError_t launch_typed(const void* q, const void* k, const void* ksc, const void* v,
                         const void* vsc, const void* lengths, float* out, int B, int S,
                         int KV, int G, int hd, cudaStream_t stream) {
    const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
    const dim3 grid(KV, B);
    auto* pq = static_cast<const TQ*>(q);
    auto* pk = static_cast<const uint8_t*>(k);
    auto* pks = static_cast<const float*>(ksc);
    auto* pv = static_cast<const uint8_t*>(v);
    auto* pvs = static_cast<const float*>(vsc);
    auto* pl = static_cast<const int64_t*>(lengths);
    const int hs = log2_exact(hd);
    if (G == 1)
        kv_cache_attn_kernel<BITS, TQ, 1><<<grid, kThreads, 0, stream>>>(
            pq, pk, pks, pv, pvs, pl, out, S, KV, G, hs, scale);
    else
        kv_cache_attn_kernel<BITS, TQ, kMaxG><<<grid, kThreads, 0, stream>>>(
            pq, pk, pks, pv, pvs, pl, out, S, KV, G, hs, scale);
    return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). q: (B, KV, G, hd) f32 (q_bf16 == 0) or
// bf16; k, v (B, S, KV, hd * bits / 8) int8 / u8 codes; scales (B, S, KV)
// f32; lengths (B,) int64; out (B, KV, G, hd) f32. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int kv_cache_attention_launch(const void* q, const void* k, const void* k_sc,
                                         const void* v, const void* v_sc,
                                         const void* lengths, void* out, int B, int S,
                                         int KV, int G, int hd, int bits, int q_bf16,
                                         void* stream) {
    if ((hd != 16 && hd != 32 && hd != 64 && hd != 128) || G < 1 || G > kMaxG || B < 1 ||
        S < 1 || KV < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    auto* po = static_cast<float*>(out);
    cudaError_t err = cudaErrorInvalidValue;
    if (bits == 8)
        err = q_bf16 ? launch_typed<8, __nv_bfloat16>(q, k, k_sc, v, v_sc, lengths, po, B, S,
                                                      KV, G, hd, st)
                     : launch_typed<8, float>(q, k, k_sc, v, v_sc, lengths, po, B, S, KV, G,
                                              hd, st);
    else if (bits == 4)
        err = q_bf16 ? launch_typed<4, __nv_bfloat16>(q, k, k_sc, v, v_sc, lengths, po, B, S,
                                                      KV, G, hd, st)
                     : launch_typed<4, float>(q, k, k_sc, v, v_sc, lengths, po, B, S, KV, G,
                                              hd, st);
    return static_cast<int>(err);
}
