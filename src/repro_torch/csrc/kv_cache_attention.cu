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
// and halves bs until it divides S. Here the rows of one (b, KV head),
// at (b * S + t) * KV + e of its own (S, KV) slice, are cut into C
// contiguous chunks of rows_per_rank rows (whole tiles), and the C blocks
// of one thread-block cluster walk them at once with (m, l, acc) on chip
// and merge on chip: no block table, no power-of-two block and no tail
// tile, so S is any length (P + gen at the serve loop's default, 48; or
// 8192 + 16).
//
// What bounds it on the H100: the bytes of the K and V rows it must read,
// lengths[b] * KV * (hd * bits / 8 + 4) * 2 per sequence, plus q and out
// (at B 2, KV 16, hd 64, int8 and 32768 rows: 142.6 MB, 43 us at 3.35
// TB/s), and the SMs' instruction rate for a walk that rounds every product
// and sum on its own. The operations, 4 * G * hd per row and head, are far
// below the tensor cores' rate. One block per (b, KV head) would launch B *
// KV blocks (32 at B 2, KV 16: a quarter of the 132 SMs) and leave the
// memory idle while a block computes. The design answers with the walk
// attend_rows_cluster (attn_common.cuh), shared with the paged single pass:
// grid (C * KV, B) in clusters of C along x, C chosen by
// kernels/paged_attention.py::cluster_ranks from S, B, KV and G alone (at B
// 2, KV 16: C = 11 at 8k and 12 at 32k, 352 and 384 blocks, all resident at
// once; C = 1 at the serve loop's S 48), each rank keeping the next tile's
// cp.async copies in flight while it consumes one, and a merge through
// distributed shared memory: one launch, no scratch in device memory.
//
// Masking: rank c walks rows [c * rows_per_rank, min((c + 1) *
// rows_per_rank, lengths[b], S)), so rows past the length are never read
// (the reference's kernel reads every tile and masks them to exact
// zeros), and a rank whose chunk starts past the length weighs exactly 0
// in the merge. With lengths[b] <= 0 no row is read and the output is 0
// (the reference's oracle averages every row there); the serve loop never
// passes 0, since its lengths are pos + 1.
//
// The kernel takes hd 16, 32, 64, 128 and 256, and 120 for int8 (run as
// 128 with 8 zero dims, attn_common.cuh; an int4 row of 120 dims is 60
// bytes, which the 8-byte copies cannot take), G up to 8 (compiled for G
// == 1 and for any G up to 8) and at hd 256 up to 16 (recurrentgemma-9b's
// multi-query local layers), q bf16 or f32, and bits 8 or 4. A local
// layer's cache is a ring of W = min(max_len, window) rows (the fixed
// loop writes row pos at pos % W) whose first min(pos + 1, W) rows are
// live, so its lengths say all the kernel needs: it takes no window.
//
// Build without --use_fast_math: expf stays accurate.

#include "attn_common.cuh"

namespace {

struct DenseArgs {
    const void* q;
    const uint8_t* k;
    const float* k_sc;
    const uint8_t* v;
    const float* v_sc;
    const int64_t* lengths;
    float* out;
    int S, KV, G, C, rows;                    // rows: rows_per_rank
    float scale;
};

// grid (C * KV, B), clusters of C along x: block x is rank x % C of KV
// head x / C. GT as in attend_rows_cluster: 1 (G == 1), kGroupG or, at hd
// kWideHD, kWideG.
template <int BITS, int HD, int HDR, typename TQ, int GT>
__global__ void __launch_bounds__(kThreads) kv_cache_attn_kernel(const DenseArgs a) {
    const int rank = blockIdx.x % a.C, e = blockIdx.x / a.C, b = blockIdx.y;
    const int64_t n = a.lengths[b] < a.S ? a.lengths[b] : a.S;
    const int t_begin = rank * a.rows;
    const int t_end = static_cast<int>(n < t_begin + a.rows ? n : t_begin + a.rows);
    const size_t first = static_cast<size_t>(b) * a.S;
    const size_t head = static_cast<size_t>(b) * a.KV + e;
    const size_t gh = static_cast<size_t>(a.G) * HDR;
    const int KV = a.KV;
    auto tile_rows = [=](int s0) {
        return [=](int tl) { return (first + s0 + tl) * KV + e; };
    };
    attend_rows_cluster<BITS, HD, HDR, TQ, GT>(static_cast<const TQ*>(a.q) + head * gh, a.k,
                                               a.k_sc, a.v, a.v_sc, tile_rows, t_begin, t_begin,
                                               t_end, a.G, a.scale, a.out + head * gh);
}

template <int BITS, int HD, int HDR, typename TQ>
cudaError_t run_hd(const DenseArgs& a, int B, cudaStream_t stream, int* clusters) {
    const int smem = walk_smem(a.G, HD, HD * BITS / 8).total;
    const dim3 grid(a.C * a.KV, B);
    if (a.G == 1)
        return launch_cluster(kv_cache_attn_kernel<BITS, HD, HDR, TQ, 1>, grid, kThreads, a.C,
                              smem, stream, clusters, a);
    if (a.G <= kGroupG)
        return launch_cluster(kv_cache_attn_kernel<BITS, HD, HDR, TQ, kGroupG>, grid, kThreads,
                              a.C, smem, stream, clusters, a);
    if constexpr (HD == kWideHD && HDR == kWideHD)
        return launch_cluster(kv_cache_attn_kernel<BITS, HD, HDR, TQ, kWideG>, grid, kThreads,
                              a.C, smem, stream, clusters, a);
    return cudaErrorInvalidValue;
}

template <int BITS, typename TQ>
cudaError_t run_typed(const DenseArgs& a, int hd, int B, cudaStream_t stream, int* clusters) {
    switch (hd) {
        case 16: return run_hd<BITS, 16, 16, TQ>(a, B, stream, clusters);
        case 32: return run_hd<BITS, 32, 32, TQ>(a, B, stream, clusters);
        case 64: return run_hd<BITS, 64, 64, TQ>(a, B, stream, clusters);
        case 128: return run_hd<BITS, 128, 128, TQ>(a, B, stream, clusters);
        case 256: return run_hd<BITS, 256, 256, TQ>(a, B, stream, clusters);
        case 120:
            if constexpr (BITS == 8) return run_hd<8, 128, 120, TQ>(a, B, stream, clusters);
            return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
    }
}

// Launch, or with ``clusters`` set report the active clusters instead.
cudaError_t run(const void* q, const void* k, const void* k_sc, const void* v,
                const void* v_sc, const void* lengths, void* out, int B, int S, int KV,
                int G, int hd, int bits, int q_bf16, int C, int rows, cudaStream_t stream,
                int* clusters) {
    const bool hd_ok = hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256 ||
                       (hd == 120 && bits == 8);
    if (!hd_ok || G < 1 || G > kMaxG || B < 1 ||
        S < 1 || KV < 1 || (bits != 8 && bits != 4) || C < 1 || C > kMaxCluster ||
        rows < 1 || static_cast<int64_t>(C) * rows < S ||
        static_cast<int64_t>(C - 1) * rows >= S)
        return cudaErrorInvalidValue;
    const int row_bytes = hd * bits / 8;      // copied in 16-byte units where they divide it
    if (row_bytes % 16 == 0 &&
        (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
        return cudaErrorInvalidValue;
    DenseArgs a{q, static_cast<const uint8_t*>(k), static_cast<const float*>(k_sc),
                static_cast<const uint8_t*>(v), static_cast<const float*>(v_sc),
                static_cast<const int64_t*>(lengths), static_cast<float*>(out), S, KV, G, C,
                rows,
                static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
    if (bits == 8)
        return q_bf16 ? run_typed<8, __nv_bfloat16>(a, hd, B, stream, clusters)
                      : run_typed<8, float>(a, hd, B, stream, clusters);
    return q_bf16 ? run_typed<4, __nv_bfloat16>(a, hd, B, stream, clusters)
                  : run_typed<4, float>(a, hd, B, stream, clusters);
}

}  // namespace

// C entry point (bound with ctypes). q: (B, KV, G, hd) f32 (q_bf16 == 0) or
// bf16; k, v (B, S, KV, hd * bits / 8) int8 / u8 codes; scales (B, S, KV)
// f32; lengths (B,) int64; out (B, KV, G, hd) f32; C ranks of rows_per_rank
// rows each (cluster_ranks), C <= kMaxCluster (16) and (C - 1) *
// rows_per_rank < S <= C * rows_per_rank. Returns the cudaError_t of the launch (0 on success).
extern "C" int kv_cache_attention_launch(const void* q, const void* k, const void* k_sc,
                                         const void* v, const void* v_sc,
                                         const void* lengths, void* out, int B, int S,
                                         int KV, int G, int hd, int bits, int q_bf16, int C,
                                         int rows_per_rank, void* stream) {
    return static_cast<int>(run(q, k, k_sc, v, v_sc, lengths, out, B, S, KV, G, hd, bits,
                                q_bf16, C, rows_per_rank, static_cast<cudaStream_t>(stream),
                                nullptr));
}

// cudaOccupancyMaxActiveClusters of the launch with these shapes: the
// clusters the card holds at once (>= 0), or minus the cudaError_t.
extern "C" int kv_cache_attention_active_clusters(int B, int S, int KV, int G, int hd,
                                                  int bits, int q_bf16, int C,
                                                  int rows_per_rank) {
    int n = 0;
    const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                B, S, KV, G, hd, bits, q_bf16, C, rows_per_rank, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
