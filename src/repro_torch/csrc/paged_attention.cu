// Paged decode attention over the packed KV pool for sm_90a: a single-pass
// kernel, a split-KV (flash-decoding) kernel and the split's merge pass.
//
//   out[b, e, g, :] = softmax_t(q[b, e, g, :] . K[b, t, e, :] / sqrt(hd)) V[b, t, e, :]
//                     over rows t < lengths[b]
//
// K/V row t of sequence b lives in physical block tables[b, t / bs] at
// offset t % bs of the pool (n_blocks, bs, KV, hd) int8 codes, or
// (n_blocks, bs, KV, hd/2) u8 holding two 4-bit codes (low nibble first),
// each row with an f32 scale (n_blocks, bs, KV): int8 dequantizes to
// code * scale, int4 to (nibble - 8) * scale.
//
// Replaces src/repro/kernels/paged_attention.py: paged_attention_pallas
// (:74, pallas_call at :128) and paged_attention_splitkv_pallas (:210,
// pallas_call at :270) with the jnp merge_splitkv_partials (:151), here a
// second small CUDA pass. The Pallas grids walk the table on a sequential
// grid axis with the running (m, l, acc) carried in revisited output
// blocks; here blocks walk their rows in a loop and keep (m, l, acc) on
// chip, reading their own table entries (the Pallas scalar prefetch).
//
// What bounds both on the H100: the bytes of the K and V rows they must
// read, lengths[b] * KV * (hd * bits / 8 + 4) * 2 per sequence (142.6 MB
// per layer at 32k context, 2 sequences, KV 16, hd 64, int8: 43 us at
// 3.35 TB/s), and the SMs' instruction rate for a walk that rounds every
// product and sum on its own. The operations, 4 * H * hd per row, are far
// below the tensor cores' rate. Reaching the byte rate needs enough loads
// in flight on enough SMs, and few instructions a code:
//   - single pass (paged_attention): the walk of one (b, KV head) is cut
//     into C chunks of nbc table entries (whole tiles and whole entries,
//     as split_partition cuts a table), walked at once by the C blocks of
//     one thread-block cluster and merged on chip through distributed
//     shared memory (attend_rows_cluster in attn_common.cuh, shared with
//     the dense-cache kernel in kv_cache_attention.cu): grid (C * KV, B),
//     C from kernels/paged_attention.py::cluster_ranks on nb * bs, B, KV
//     and G alone (12 at 32k with block 512, B 2, KV 16; 1 at the serve
//     shapes), one launch and no scratch. Each rank copies tiles with
//     cp.async into a ring, the table entry of the next tile read before
//     it waits for the current one (once a tile where bs >= kTile);
//   - split (paged_attention_splitkv): one block per (b, chunk, KV head)
//     walks with attend_rows (registers-then-shared-memory staging, up to
//     8 independent 8-byte loads a thread before any is used) and writes
//     unnormalised partials to scratch, which merge_kernel reduces in a
//     second pass; kv_splits is the caller's.
// Both walks stop at lengths[b] (the reference walks every table entry and
// masks), share the per-tile arithmetic (scores by lane groups with
// warp-shuffle sums, one warp per query row for the online softmax, a
// two-level PV sum) and reduce the R = 256 / hd PV groups in shared
// memory at the end.
//
// Masking: rows t >= lengths[b] score -1e30 and weigh exactly 0. A chunk
// or rank with no live row carries m = -1e30, l = 0, acc = 0, which a
// merge weighs by exp(-1e30 - M) = 0. With lengths[b] == 0 no row is read
// and the output is 0 (the reference's oracle averages every row there).
//
// The kernels take hd 16, 32, 64 or 128, G up to 8 (compiled for G == 1
// and for any G up to 8), and a block size that is a power of two.
//
// Build without --use_fast_math: expf stays accurate.

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
    float scale;
};

// The single pass: grid (C * KV, B), clusters of C along x; block x is rank
// x % C of KV head x / C and walks table entries [rank * nbc, (rank + 1) *
// nbc) of sequence b, cut at lengths[b]. out (B, KV, G, hd). GT is the
// number of query rows compiled in: 1 (G == 1, the dense models' MHA) or
// kMaxG (any G up to it). bs is a power of two (bs_shift); row t of
// sequence b lives at offset t % bs of block tables[b, t / bs].
template <int BITS, int HD, typename TQ, int GT>
__global__ void __launch_bounds__(kThreads) paged_attn_cluster_kernel(const PagedArgs a) {
    const int rank = blockIdx.x % a.C, e = blockIdx.x / a.C, b = blockIdx.y;
    const int bs_shift = a.bs_shift, KV = a.KV;
    const int64_t* tbl = a.tables + static_cast<size_t>(b) * a.nb;
    const int t_begin = (rank * a.nbc) << bs_shift;
    const int64_t chunk_end = static_cast<int64_t>(min((rank + 1) * a.nbc, a.nb)) << bs_shift;
    const int t_end = static_cast<int>(a.lengths[b] < chunk_end ? a.lengths[b] : chunk_end);
    const size_t head = static_cast<size_t>(b) * KV + e;
    const size_t gh = static_cast<size_t>(a.G) * HD;
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
    attend_rows_cluster<BITS, HD, TQ, GT>(static_cast<const TQ*>(a.q) + head * gh, a.k,
                                          a.k_sc, a.v, a.v_sc, tile_rows, t_begin, t_end, a.G,
                                          a.scale, a.out + head * gh);
}

template <int BITS, int HD, typename TQ>
cudaError_t run_hd(const PagedArgs& a, int B, cudaStream_t stream, int* clusters) {
    const int smem = walk_smem(a.G, HD, HD * BITS / 8).total;
    const dim3 grid(a.C * a.KV, B);
    if (a.G == 1)
        return launch_cluster(paged_attn_cluster_kernel<BITS, HD, TQ, 1>, grid, a.C, smem,
                              stream, clusters, a);
    return launch_cluster(paged_attn_cluster_kernel<BITS, HD, TQ, kMaxG>, grid, a.C, smem,
                          stream, clusters, a);
}

template <int BITS, typename TQ>
cudaError_t run_typed(const PagedArgs& a, int hd, int B, cudaStream_t stream, int* clusters) {
    switch (hd) {
        case 16: return run_hd<BITS, 16, TQ>(a, B, stream, clusters);
        case 32: return run_hd<BITS, 32, TQ>(a, B, stream, clusters);
        case 64: return run_hd<BITS, 64, TQ>(a, B, stream, clusters);
        default: return run_hd<BITS, 128, TQ>(a, B, stream, clusters);
    }
}

// The single pass: launch, or with ``clusters`` set report the active
// clusters instead.
cudaError_t run(const void* q, const void* kp, const void* ksc, const void* vp,
                const void* vsc, const void* tables, const void* lengths, void* out, int B,
                int KV, int G, int hd, int bs, int nb, int bits, int q_bf16, int C, int nbc,
                cudaStream_t stream, int* clusters) {
    if ((hd != 16 && hd != 32 && hd != 64 && hd != 128) || G < 1 || G > kMaxG || B < 1 ||
        KV < 1 || log2_exact(bs) < 0 || nb < 1 || (bits != 8 && bits != 4) || C < 1 ||
        C > kMaxCluster || nbc < 1 || C * nbc < nb || (C - 1) * nbc >= nb)
        return cudaErrorInvalidValue;
    const int row_bytes = hd * bits / 8;      // copied in 16-byte units from 16 bytes up
    if (row_bytes >= 16 &&
        (reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 != 0)
        return cudaErrorInvalidValue;
    PagedArgs a{q, static_cast<const uint8_t*>(kp), static_cast<const float*>(ksc),
                static_cast<const uint8_t*>(vp), static_cast<const float*>(vsc),
                static_cast<const int64_t*>(tables), static_cast<const int64_t*>(lengths),
                static_cast<float*>(out), KV, G, log2_exact(bs), nb, C, nbc,
                static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
    if (bits == 8)
        return q_bf16 ? run_typed<8, __nv_bfloat16>(a, hd, B, stream, clusters)
                      : run_typed<8, float>(a, hd, B, stream, clusters);
    return q_bf16 ? run_typed<4, __nv_bfloat16>(a, hd, B, stream, clusters)
                  : run_typed<4, float>(a, hd, B, stream, clusters);
}

// The split: grid (KV, ns, B); writes the unnormalised partials acc (B, ns,
// KV, G, hd), m and l (B, ns, KV, G) of chunk c = table entries [c * nbc,
// (c + 1) * nbc) through attend_rows (attn_common.cuh). GT as above.
template <int BITS, typename TQ, int GT>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const TQ* __restrict__ q, const uint8_t* __restrict__ k_pool,
                        const float* __restrict__ k_sc, const uint8_t* __restrict__ v_pool,
                        const float* __restrict__ v_sc, const int64_t* __restrict__ tables,
                        const int64_t* __restrict__ lengths, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out, int KV, int G,
                        int hd_shift, int bs_shift, int nb, int nbc, float scale) {
    const int e = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int ns = gridDim.y;
    const int bs = 1 << bs_shift;
    const int64_t* tbl = tables + static_cast<size_t>(b) * nb;
    const int t_begin = c * nbc * bs;
    const int64_t chunk_end = static_cast<int64_t>(min((c + 1) * nbc, nb)) * bs;
    const int t_end = static_cast<int>(lengths[b] < chunk_end ? lengths[b] : chunk_end);
    const size_t head = (static_cast<size_t>(b) * ns + c) * KV + e;
    const size_t gh = static_cast<size_t>(G) << hd_shift;
    auto row_of = [=](int t) {
        return ((static_cast<size_t>(tbl[t >> bs_shift]) << bs_shift) + (t & (bs - 1))) *
                   KV + e;
    };
    attend_rows<BITS, TQ, GT>(
        q + (static_cast<size_t>(b) * KV + e) * gh, k_pool, k_sc, v_pool, v_sc, row_of,
        t_begin, t_end, G, hd_shift, scale, out + head * gh, m_out + head * G,
        l_out + head * G);
}

// grid (KV, B): out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c, 1e-30).
__global__ void merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                             const float* __restrict__ l, float* __restrict__ out, int KV,
                             int G, int hd, int ns) {
    const int e = blockIdx.x, b = blockIdx.y;
    for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
        const int g = i / hd;
        float M = kNeg;
        for (int c = 0; c < ns; ++c)
            M = fmaxf(M, m[((static_cast<size_t>(b) * ns + c) * KV + e) * G + g]);
        float num = 0.f, den = 0.f;
        for (int c = 0; c < ns; ++c) {
            const size_t head = (static_cast<size_t>(b) * ns + c) * KV + e;
            const float w = expf(m[head * G + g] - M);
            num += w * acc[head * G * hd + i];
            den += w * l[head * G + g];
        }
        out[(static_cast<size_t>(b) * KV + e) * G * hd + i] = num / fmaxf(den, 1e-30f);
    }
}

template <int BITS, typename TQ>
cudaError_t split_typed(const void* q, const void* kp, const void* ksc, const void* vp,
                        const void* vsc, const void* tables, const void* lengths, float* out,
                        float* m, float* l, int B, int KV, int G, int hd, int bs, int nb,
                        int ns, int nbc, cudaStream_t stream) {
    const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
    const dim3 grid(KV, ns, B);
    auto* pq = static_cast<const TQ*>(q);
    auto* pk = static_cast<const uint8_t*>(kp);
    auto* pks = static_cast<const float*>(ksc);
    auto* pv = static_cast<const uint8_t*>(vp);
    auto* pvs = static_cast<const float*>(vsc);
    auto* pt = static_cast<const int64_t*>(tables);
    auto* pl = static_cast<const int64_t*>(lengths);
    const int hs = log2_exact(hd), bss = log2_exact(bs);
    if (G == 1)
        paged_attn_split_kernel<BITS, TQ, 1><<<grid, kThreads, 0, stream>>>(
            pq, pk, pks, pv, pvs, pt, pl, out, m, l, KV, G, hs, bss, nb, nbc, scale);
    else
        paged_attn_split_kernel<BITS, TQ, kMaxG><<<grid, kThreads, 0, stream>>>(
            pq, pk, pks, pv, pvs, pt, pl, out, m, l, KV, G, hs, bss, nb, nbc, scale);
    return cudaGetLastError();
}

cudaError_t split(const void* q, const void* kp, const void* ksc, const void* vp,
                  const void* vsc, const void* tables, const void* lengths, float* out,
                  float* m, float* l, int B, int KV, int G, int hd, int bs, int nb, int bits,
                  int q_bf16, int ns, int nbc, cudaStream_t stream) {
    if ((hd != 16 && hd != 32 && hd != 64 && hd != 128) || G < 1 || G > kMaxG ||
        log2_exact(bs) < 0 || nb < 1 || ns < 1 || nbc < 1)
        return cudaErrorInvalidValue;
    if (bits == 8)
        return q_bf16 ? split_typed<8, __nv_bfloat16>(q, kp, ksc, vp, vsc, tables, lengths,
                                                      out, m, l, B, KV, G, hd, bs, nb, ns,
                                                      nbc, stream)
                      : split_typed<8, float>(q, kp, ksc, vp, vsc, tables, lengths, out, m,
                                              l, B, KV, G, hd, bs, nb, ns, nbc, stream);
    if (bits == 4)
        return q_bf16 ? split_typed<4, __nv_bfloat16>(q, kp, ksc, vp, vsc, tables, lengths,
                                                      out, m, l, B, KV, G, hd, bs, nb, ns,
                                                      nbc, stream)
                      : split_typed<4, float>(q, kp, ksc, vp, vsc, tables, lengths, out, m,
                                              l, B, KV, G, hd, bs, nb, ns, nbc, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// C entry points (bound with ctypes). q: (B, KV, G, hd) f32 (q_bf16 == 0) or
// bf16; pools (n_blocks, bs, KV, hd * bits / 8) int8 / u8 codes; scales
// (n_blocks, bs, KV) f32; tables (B, nb) and lengths (B,) int64; out (B, KV,
// G, hd) f32. Each returns the cudaError_t of its launches (0 on success).
//
// The single pass: C ranks of nbc table entries each (cluster_ranks), C <= 8
// and (C - 1) * nbc < nb <= C * nbc.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* k_sc,
                                      const void* v_pool, const void* v_sc,
                                      const void* tables, const void* lengths, void* out,
                                      int B, int KV, int G, int hd, int bs, int nb,
                                      int bits, int q_bf16, int C, int nbc, void* stream) {
    return static_cast<int>(run(q, k_pool, k_sc, v_pool, v_sc, tables, lengths, out, B, KV,
                                G, hd, bs, nb, bits, q_bf16, C, nbc,
                                static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the single pass with these shapes: the
// clusters the card holds at once (>= 0), or minus the cudaError_t.
extern "C" int paged_attention_active_clusters(int B, int KV, int G, int hd, int bs, int nb,
                                               int bits, int q_bf16, int C, int nbc) {
    int n = 0;
    const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, B, KV, G, hd, bs, nb, bits, q_bf16, C, nbc, nullptr,
                                &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The split: ns chunks of nbc table entries; acc (B, ns, KV, G, hd), m and l
// (B, ns, KV, G) f32 are the caller's scratch for the partials, which the
// merge pass reduces into out.
extern "C" int paged_attention_splitkv_launch(const void* q, const void* k_pool,
                                              const void* k_sc, const void* v_pool,
                                              const void* v_sc, const void* tables,
                                              const void* lengths, void* acc, void* m,
                                              void* l, void* out, int B, int KV, int G,
                                              int hd, int bs, int nb, int bits, int q_bf16,
                                              int ns, int nbc, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto* pa = static_cast<float*>(acc);
    auto* pm = static_cast<float*>(m);
    auto* pl = static_cast<float*>(l);
    const cudaError_t err = split(q, k_pool, k_sc, v_pool, v_sc, tables, lengths, pa, pm, pl,
                                  B, KV, G, hd, bs, nb, bits, q_bf16, ns, nbc, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_kernel<<<dim3(KV, B), 128, 0, st>>>(pa, pm, pl, static_cast<float*>(out), KV, G, hd,
                                              ns);
    return static_cast<int>(cudaGetLastError());
}
