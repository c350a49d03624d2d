// Paged decode attention over the packed KV pool for sm_90a: a single-pass
// kernel, a split-KV (flash-decoding) kernel and the split's merge pass.
//
//   out[b, e, g, :] = softmax_t(q[b, e, g, :] . K[b, t, e, :] / sqrt(hd)) V[b, t, e, :]
//                     over rows lo[b] <= t < lengths[b]
//
// lo[b] = max(0, lengths[b] - window) on a local (sliding-window) layer, 0
// otherwise (window 0): the reference's rows t > pos - window with pos =
// lengths[b] - 1 (src/repro/models/layers.py:556-557 and :589-591, where
// its engine masks a gathered view in jnp; its Pallas kernels take no
// window).
//
// K/V row t of sequence b lives in physical block tables[b, t / bs] at
// offset t % bs of the pool (n_blocks, bs, KV, hd) int8 codes, or
// (n_blocks, bs, KV, hd/2) u8 holding two 4-bit codes (low nibble first),
// each row with an f32 scale (n_blocks, bs, KV): int8 dequantizes to
// code * scale, int4 to (nibble - 8) * scale.
//
// Replaces src/repro/kernels/paged_attention.py: paged_attention_pallas
// (:74, pallas_call at :128) and paged_attention_splitkv_pallas (:210,
// pallas_call at :270) with the jnp merge_splitkv_partials (:151), here
// done on chip, or above kMaxCluster chunks in a second small CUDA pass.
// The Pallas grids walk the table on a sequential grid axis with the
// running (m, l, acc) carried in revisited output blocks; here blocks walk
// their rows in a loop and keep (m, l, acc) on chip, reading their own
// table entries (the Pallas scalar prefetch).
//
// What bounds both on the H100: the bytes of the K and V rows they must
// read, lengths[b] * KV * (hd * bits / 8 + 4) * 2 per sequence (142.6 MB
// per layer at 32k context, 2 sequences, KV 16, hd 64, int8: 43 us at
// 3.35 TB/s), and the SMs' instruction rate for a walk that rounds every
// product and sum on its own. The operations, 4 * H * hd per row, are far
// below the tensor cores' rate. Reaching the byte rate needs enough loads
// in flight on enough SMs, and few instructions a code. Both kernels run
// the one cluster walk attend_rows_cluster (attn_common.cuh, shared with
// the dense-cache kernel in kv_cache_attention.cu): the walk of one (b, KV
// head) is cut into chunks of nbc table entries (whole entries), walked at
// once by the ranks of a thread-block cluster and merged on chip through
// distributed shared memory. Each rank copies tiles with cp.async into a
// ring, the table entry of the next tile read before it waits for the
// current one (once a tile where bs >= kTile).
//   - single pass (paged_attention): C chunks, one cluster of C ranks a
//     head: grid (C * KV, B), C from kernels/paged_attention.py::
//     cluster_ranks on nb * bs, B, KV and G alone (12 at 32k with block
//     512, B 2, KV 16; 1 at the serve shapes), one launch and no scratch.
//     On a local layer the chunks cover the rows a window can reach, not
//     the table: min(nb * bs, window + step - 1) rows (step = max(kTile,
//     bs)), counted from lo[b] rounded down to a multiple of step, which
//     the kernel computes on the device; the walk starts at lo's tile and
//     masks the rows below lo, so a local layer reads window rows, not
//     lengths[b];
//   - split (paged_attention_splitkv): the caller's kv_splits gives ns
//     chunks (split_partition), one rank a chunk, in K clusters of C ranks
//     a head (split_clusters: K = 1 up to kMaxCluster chunks). At K = 1
//     it is the single pass's kernel on those chunks: one launch, no
//     scratch. Above, paged_attn_split_kernel (grid (C * K * KV, B))
//     writes each cluster's unnormalised partial (m, l, acc) to scratch,
//     and merge_kernel reduces the K partials in a second pass. Chunks
//     count from row 0 on every layer; on a local layer a chunk wholly
//     below lo[b] reads nothing and weighs 0, as a chunk past lengths[b].
// The walk stops at lengths[b] (the reference walks every table entry and
// masks).
//
// Masking: rows t >= lengths[b] and t < lo[b] score -1e30 and weigh
// exactly 0 (rows below lo in the first tile are not copied). A chunk,
// rank or cluster with no live row carries m = -1e30, l = 0, acc = 0,
// which a merge weighs by exp(-1e30 - M) = 0. With lengths[b] == 0 no row
// is read and the output is 0 (the reference's oracle averages every row
// there).
//
// The kernels take hd 16, 32, 64, 128 and 256, and 120 for int8 (run as
// 128 with 8 zero dims, attn_common.cuh; an int4 row of 120 dims is 60
// bytes, which the 8-byte copies cannot take), G up to 8 (compiled for G
// == 1 and for any G up to 8) and, in the single pass at hd 256, up to 16
// (recurrentgemma-9b's multi-query local layers; the split keeps to 8),
// and a block size that is a power of two.
//
// Build without --use_fast_math: expf stays accurate.

#include <type_traits>

#include "attn_common.cuh"

namespace {

struct PagedArgs {
    const void* q;
    const uint8_t* k;
    const float* k_sc;
    const uint8_t* v;
    const float* v_sc;
    const int64_t* tables;
    const int64_t* lengths;
    float* out;
    int KV, G, bs_shift, nb, C, nbc;          // nbc: table entries a rank
    // window: a local layer's (0: none); base_shift: the chunks count from
    // lo rounded down to a multiple of 1 << base_shift (the single pass), or
    // from row 0 (-1: the split)
    int window, base_shift;
    float scale;
};

// The split above kMaxCluster chunks: ns chunks a head in K clusters of C
// ranks; out holds the clusters' unnormalised sums (B, K, KV, G, hd), m and
// l their max and sum of exponentials (B, K, KV, G).
struct SplitArgs : PagedArgs {
    float* m;
    float* l;
    int ns, K;
};

// Walk chunk c of sequence b, KV head e: table entries [f + c * nbc,
// min(f + (c + 1) * nbc, nb)), f the first entry of the walk (0, or the
// single pass's window base), cut to the rows [lo, lengths[b]) (none past
// nb), as this block's rank of its cluster; the merge goes to out_h (G,
// HDR), and with m_h and l_h given it is the cluster's unnormalised
// partial. The walk's tiles start at the chunk's start or at lo's tile,
// whichever is later. bs is a power of two (bs_shift); row t of sequence b
// lives at offset t % bs of block tables[b, t / bs].
template <int BITS, int HD, int HDR, typename TQ, int GT>
__device__ __forceinline__ void walk_chunk(const PagedArgs& a, int b, int e, int c,
                                           float* out_h, float* m_h, float* l_h) {
    const int bs_shift = a.bs_shift, KV = a.KV;
    const int64_t* tbl = a.tables + static_cast<size_t>(b) * a.nb;
    const int64_t len = a.lengths[b];
    const int lo = static_cast<int>(a.window > 0 && len > a.window ? len - a.window : 0);
    const int f = a.base_shift >= 0 ? ((lo >> a.base_shift) << a.base_shift) >> bs_shift : 0;
    const int e0 = f + c * a.nbc;
    const int t_begin = max(e0 << bs_shift, lo & ~(kTile - 1));
    const int64_t chunk_end = static_cast<int64_t>(min(e0 + a.nbc, a.nb)) << bs_shift;
    const int t_end = static_cast<int>(len < chunk_end ? len : chunk_end);
    const size_t head = static_cast<size_t>(b) * KV + e;
    // a tile starts on a multiple of kTile from a block boundary, so with
    // bs >= kTile it lies inside one block: one table read for the tile
    const bool one_block = (1 << bs_shift) >= kTile;
    auto tile_rows = [=](int s0) {
        const size_t base = one_block ? (static_cast<size_t>(tbl[s0 >> bs_shift]) << bs_shift) +
                                            (s0 & ((1 << bs_shift) - 1))
                                      : 0;
        return [=](int tl) {
            if (one_block) return (base + tl) * KV + e;
            const int t = s0 + tl;
            return ((static_cast<size_t>(tbl[t >> bs_shift]) << bs_shift) +
                    (t & ((1 << bs_shift) - 1))) * KV + e;
        };
    };
    attend_rows_cluster<BITS, HD, HDR, TQ, GT>(
        static_cast<const TQ*>(a.q) + head * a.G * HDR, a.k, a.k_sc, a.v, a.v_sc, tile_rows,
        t_begin, lo, t_end, a.G, a.scale, out_h, m_h, l_h);
}

// The single pass, and the split up to kMaxCluster chunks: grid (C * KV,
// B), clusters of C along x; block x is rank x % C of KV head x / C and
// walks chunk rank. out (B, KV, G, hd). GT is the number of query rows
// compiled in: 1 (G == 1, the dense models' MHA), kGroupG (any G up to it)
// or, at hd kWideHD, kWideG.
template <int BITS, int HD, int HDR, typename TQ, int GT>
__global__ void __launch_bounds__(kThreads) paged_attn_cluster_kernel(const PagedArgs a) {
    const int rank = blockIdx.x % a.C, e = blockIdx.x / a.C, b = blockIdx.y;
    const size_t head = static_cast<size_t>(b) * a.KV + e;
    walk_chunk<BITS, HD, HDR, TQ, GT>(a, b, e, rank, a.out + head * a.G * HDR, nullptr,
                                      nullptr);
}

// The split above kMaxCluster chunks: grid (C * K * KV, B), clusters of C
// along x; block x is rank x % C of cluster k = (x / C) % K of KV head x /
// (C * K). Cluster k walks ns / K chunks, one more for the first ns % K
// clusters, in order; a rank past its cluster's chunks walks none.
template <int BITS, int HD, int HDR, typename TQ, int GT>
__global__ void __launch_bounds__(kThreads) paged_attn_split_kernel(const SplitArgs a) {
    const int rank = blockIdx.x % a.C, k = (blockIdx.x / a.C) % a.K;
    const int e = blockIdx.x / (a.C * a.K), b = blockIdx.y;
    const int base = a.ns / a.K, extra = a.ns % a.K;
    const int first = k * base + min(k, extra), size = base + (k < extra ? 1 : 0);
    const size_t part = (static_cast<size_t>(b) * a.K + k) * a.KV + e;
    walk_chunk<BITS, HD, HDR, TQ, GT>(a, b, e, rank < size ? first + rank : a.ns,
                                      a.out + part * a.G * HDR, a.m + part * a.G,
                                      a.l + part * a.G);
}

// grid (KV, B): out = sum_k w_k acc_k / max(sum_k w_k l_k, 1e-30), w_k =
// e^(m_k - M), M = max_k m_k, over the K clusters' partials in cluster
// order, each product and sum rounded on its own (the cluster merge's
// arithmetic).
__global__ void merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                             const float* __restrict__ l, float* __restrict__ out, int KV,
                             int G, int hd, int K) {
    const int e = blockIdx.x, b = blockIdx.y;
    for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
        const int g = i / hd;
        float M = kNeg;
        for (int k = 0; k < K; ++k)
            M = fmaxf(M, m[((static_cast<size_t>(b) * K + k) * KV + e) * G + g]);
        float num = 0.f, den = 0.f;
        for (int k = 0; k < K; ++k) {
            const size_t part = (static_cast<size_t>(b) * K + k) * KV + e;
            const float w = expf(m[part * G + g] - M);
            const float x = __fmul_rn(w, acc[part * G * hd + i]);
            const float y = __fmul_rn(w, l[part * G + g]);
            num = k ? __fadd_rn(num, x) : x;
            den = k ? __fadd_rn(den, y) : y;
        }
        out[(static_cast<size_t>(b) * KV + e) * G * hd + i] = num / fmaxf(den, 1e-30f);
    }
}

template <int BITS, int HD, int HDR, typename TQ, int GT, typename Args>
cudaError_t launch_gt(const Args& a, dim3 grid, int smem, cudaStream_t stream, int* clusters) {
    if constexpr (std::is_same<Args, SplitArgs>::value)
        return launch_cluster(paged_attn_split_kernel<BITS, HD, HDR, TQ, GT>, grid, kThreads,
                              a.C, smem, stream, clusters, a);
    else
        return launch_cluster(paged_attn_cluster_kernel<BITS, HD, HDR, TQ, GT>, grid, kThreads,
                              a.C, smem, stream, clusters, a);
}

// The kernel compiled for ``a.G``'s query rows: GT 1, kGroupG, or at hd
// kWideHD (the single pass only) kWideG.
template <int BITS, int HD, int HDR, typename TQ, typename Args>
cudaError_t run_hd(const Args& a, dim3 grid, cudaStream_t stream, int* clusters) {
    const int smem = walk_smem(a.G, HD, HD * BITS / 8).total;
    if (a.G == 1) return launch_gt<BITS, HD, HDR, TQ, 1>(a, grid, smem, stream, clusters);
    if (a.G <= kGroupG)
        return launch_gt<BITS, HD, HDR, TQ, kGroupG>(a, grid, smem, stream, clusters);
    if constexpr (HD == kWideHD && HDR == kWideHD && !std::is_same<Args, SplitArgs>::value)
        return launch_gt<BITS, HD, HDR, TQ, kWideG>(a, grid, smem, stream, clusters);
    return cudaErrorInvalidValue;
}

template <int BITS, typename TQ, typename Args>
cudaError_t run_typed(const Args& a, int hd, dim3 grid, cudaStream_t stream, int* clusters) {
    switch (hd) {
        case 16: return run_hd<BITS, 16, 16, TQ>(a, grid, stream, clusters);
        case 32: return run_hd<BITS, 32, 32, TQ>(a, grid, stream, clusters);
        case 64: return run_hd<BITS, 64, 64, TQ>(a, grid, stream, clusters);
        case 128: return run_hd<BITS, 128, 128, TQ>(a, grid, stream, clusters);
        case 256: return run_hd<BITS, 256, 256, TQ>(a, grid, stream, clusters);
        case 120:
            if constexpr (BITS == 8) return run_hd<8, 128, 120, TQ>(a, grid, stream, clusters);
            return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
    }
}

// Launch ``a`` on ``grid`` (or with ``clusters`` set report the active
// clusters instead) with the kernel its type names, for its bits and q type.
template <typename Args>
cudaError_t run(const Args& a, int hd, int bits, int q_bf16, dim3 grid, cudaStream_t stream,
                int* clusters) {
    if (bits == 8)
        return q_bf16 ? run_typed<8, __nv_bfloat16>(a, hd, grid, stream, clusters)
                      : run_typed<8, float>(a, hd, grid, stream, clusters);
    return q_bf16 ? run_typed<4, __nv_bfloat16>(a, hd, grid, stream, clusters)
                  : run_typed<4, float>(a, hd, grid, stream, clusters);
}

// The checks both kernels share, then their arguments in ``a``.
cudaError_t paged_args(PagedArgs& a, const void* q, const void* kp, const void* ksc,
                       const void* vp, const void* vsc, const void* tables,
                       const void* lengths, void* out, int B, int KV, int G, int hd, int bs,
                       int nb, int bits, int C, int nbc, int window, int base_shift) {
    const bool hd_ok = hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256 ||
                       (hd == 120 && bits == 8);
    if (!hd_ok || G < 1 || G > kMaxG || B < 1 || KV < 1 || log2_exact(bs) < 0 || nb < 1 ||
        (bits != 8 && bits != 4) || C < 1 || C > kMaxCluster || nbc < 1 || window < 0)
        return cudaErrorInvalidValue;
    const int row_bytes = hd * bits / 8;      // copied in 16-byte units where they divide it
    if (row_bytes % 16 == 0 &&
        (reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 != 0)
        return cudaErrorInvalidValue;
    a = PagedArgs{q, static_cast<const uint8_t*>(kp), static_cast<const float*>(ksc),
                  static_cast<const uint8_t*>(vp), static_cast<const float*>(vsc),
                  static_cast<const int64_t*>(tables), static_cast<const int64_t*>(lengths),
                  static_cast<float*>(out), KV, G, log2_exact(bs), nb, C, nbc, window,
                  base_shift, static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
    return cudaSuccess;
}

// The single pass: C ranks of nbc table entries each over the walk's n
// entries, (C - 1) * nbc < n <= C * nbc: n = nb, or on a local layer the
// entries of min(nb * bs, window + step - 1) rows, step = max(kTile, bs)
// (kernels/paged_attention.py::walk_extent).
cudaError_t single(const void* q, const void* kp, const void* ksc, const void* vp,
                   const void* vsc, const void* tables, const void* lengths, void* out, int B,
                   int KV, int G, int hd, int bs, int nb, int bits, int q_bf16, int C, int nbc,
                   int window, cudaStream_t stream, int* clusters) {
    const int step_shift = max(log2_exact(kTile), log2_exact(bs));
    PagedArgs a;
    const cudaError_t err = paged_args(a, q, kp, ksc, vp, vsc, tables, lengths, out, B, KV, G,
                                       hd, bs, nb, bits, C, nbc, window, step_shift);
    if (err != cudaSuccess) return err;
    int64_t rows = static_cast<int64_t>(nb) * bs;
    if (window > 0 && window + (int64_t{1} << step_shift) - 1 < rows)
        rows = window + (int64_t{1} << step_shift) - 1;
    const int64_t n = (rows + bs - 1) / bs;
    if (static_cast<int64_t>(C) * nbc < n || static_cast<int64_t>(C - 1) * nbc >= n)
        return cudaErrorInvalidValue;
    return run(a, hd, bits, q_bf16, dim3(C * KV, B), stream, clusters);
}

// The split: ns chunks of nbc table entries (ns * nbc >= nb; chunks past
// nb walk nothing) in K clusters of C = ceil(ns / K) ranks. K == 1 runs
// the single pass's kernel on those chunks into out; above, the split
// kernel writes the clusters' partials to acc, m and l, and merge_kernel
// reduces them into out.
cudaError_t split(const void* q, const void* kp, const void* ksc, const void* vp,
                  const void* vsc, const void* tables, const void* lengths, float* acc,
                  float* m, float* l, float* out, int B, int KV, int G, int hd, int bs, int nb,
                  int bits, int q_bf16, int ns, int nbc, int K, int C, int window,
                  cudaStream_t stream, int* clusters) {
    if (ns < 1 || K < 1 || G > kGroupG || static_cast<int64_t>(ns) * nbc < nb ||
        C != (ns + K - 1) / K ||
        (K > 1 && !clusters && !(acc && m && l)))
        return cudaErrorInvalidValue;
    PagedArgs a;
    cudaError_t err = paged_args(a, q, kp, ksc, vp, vsc, tables, lengths, K == 1 ? out : acc,
                                 B, KV, G, hd, bs, nb, bits, C, nbc, window, -1);
    if (err != cudaSuccess) return err;
    if (K == 1) return run(a, hd, bits, q_bf16, dim3(C * KV, B), stream, clusters);
    const SplitArgs sa{a, m, l, ns, K};
    err = run(sa, hd, bits, q_bf16, dim3(C * K * KV, B), stream, clusters);
    if (err != cudaSuccess || clusters) return err;
    merge_kernel<<<dim3(KV, B), 128, 0, stream>>>(acc, m, l, out, KV, G, hd, K);
    return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). q: (B, KV, G, hd) f32 (q_bf16 == 0) or
// bf16; pools (n_blocks, bs, KV, hd * bits / 8) int8 / u8 codes; scales
// (n_blocks, bs, KV) f32; tables (B, nb) and lengths (B,) int64; out (B, KV,
// G, hd) f32; window a local layer's (> 0) or 0. Each returns the
// cudaError_t of its launches (0 on success).
//
// The single pass: C ranks of nbc table entries each (cluster_ranks over
// walk_extent), C <= kMaxCluster (16).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* k_sc,
                                      const void* v_pool, const void* v_sc,
                                      const void* tables, const void* lengths, void* out,
                                      int B, int KV, int G, int hd, int bs, int nb,
                                      int bits, int q_bf16, int C, int nbc, int window,
                                      void* stream) {
    return static_cast<int>(single(q, k_pool, k_sc, v_pool, v_sc, tables, lengths, out, B, KV,
                                   G, hd, bs, nb, bits, q_bf16, C, nbc, window,
                                   static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the single pass with these shapes: the
// clusters the card holds at once (>= 0), or minus the cudaError_t.
extern "C" int paged_attention_active_clusters(int B, int KV, int G, int hd, int bs, int nb,
                                               int bits, int q_bf16, int C, int nbc,
                                               int window) {
    int n = 0;
    const cudaError_t err = single(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, B, KV, G, hd, bs, nb, bits, q_bf16, C,
                                   nbc, window, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The split: ns chunks of nbc table entries (split_partition) in K clusters
// of C ranks (split_clusters). At K > 1, acc (B, K, KV, G, hd), m and l (B,
// K, KV, G) f32 are the caller's scratch for the clusters' partials, which
// the merge pass reduces into out; at K == 1 they are not read and may be
// null.
extern "C" int paged_attention_splitkv_launch(const void* q, const void* k_pool,
                                              const void* k_sc, const void* v_pool,
                                              const void* v_sc, const void* tables,
                                              const void* lengths, void* acc, void* m,
                                              void* l, void* out, int B, int KV, int G,
                                              int hd, int bs, int nb, int bits, int q_bf16,
                                              int ns, int nbc, int K, int C, int window,
                                              void* stream) {
    return static_cast<int>(split(q, k_pool, k_sc, v_pool, v_sc, tables, lengths,
                                  static_cast<float*>(acc), static_cast<float*>(m),
                                  static_cast<float*>(l), static_cast<float*>(out), B, KV, G,
                                  hd, bs, nb, bits, q_bf16, ns, nbc, K, C, window,
                                  static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the split's walk with these shapes (the
// cluster kernel at K == 1, the split kernel above): the clusters the card
// holds at once (>= 0), or minus the cudaError_t.
extern "C" int paged_attention_splitkv_active_clusters(int B, int KV, int G, int hd, int bs,
                                                       int nb, int bits, int q_bf16, int ns,
                                                       int nbc, int K, int C, int window) {
    int n = 0;
    const cudaError_t err = split(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, B, KV, G, hd, bs, nb, bits,
                                  q_bf16, ns, nbc, K, C, window, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
