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
// blocks; here one CUDA block per (b, KV head), or per (b, chunk, KV head)
// for the split, walks its rows in a loop and keeps (m, l, acc) on chip.
// The block reads its own table entries (the Pallas scalar prefetch).
//
// What bounds it on the H100: the bytes of the K and V rows it must read,
// lengths[b] * KV * (hd * bits / 8 + 4) * 2 per sequence (142.6 MB per
// layer at 32k context, 2 sequences, KV 16, hd 64, int8: 43 us at 3.35
// TB/s). The operations, 4 * H * hd per row, are far below the tensor
// cores' rate. Reaching the byte rate needs enough loads in flight on
// enough SMs; the design keeps it simple and right and takes two steps
// towards that (the walk, attend_rows in attn_common.cuh, is shared with
// the dense-cache kernel in kv_cache_attention.cu):
//   - the walk stops at lengths[b]: rows past it are never read (the
//     reference walks every table entry and masks them to exact zeros);
//   - each tile of kTile tokens is staged into shared memory by all 256
//     threads at once, up to 8 independent 8-byte loads a thread issued
//     before any is used, so one block keeps up to 32 KB in flight;
//   - scores: the lanes of a group hold one token's row, one 8-byte word
//     each (8 int8 or 16 int4 codes), dot it with the G query rows of the
//     KV head (q in shared memory, f32) and reduce by warp shuffles; the
//     G rows of a head share every K/V row the block loads;
//   - softmax: one warp per query row updates (m, l) over the tile;
//   - PV: thread (r, d) sums every R-th token of the tile for output dim
//     d and all G rows, then folds the tile's sum into its running f32 sum
//     (a two-level sum: at 32k context a thread's sequential chain is 32
//     tokens long, not 8192); the R = 256 / hd groups are reduced in
//     shared memory at the end.
// The single pass launches B * KV blocks: 32 at B = 2, KV = 16, a quarter
// of the 132 SMs, which is why the split exists. Double buffering,
// cp.async/TMA staging and tensor-core QK/PV are later kernel work.
//
// Masking: rows t >= lengths[b] score -1e30 and weigh exactly 0. A chunk
// with no live row writes m = -1e30, l = 0, acc = 0, which the merge
// weighs by exp(-1e30 - M) = 0. With lengths[b] == 0 no row is read and
// the output is 0 (the reference's oracle averages every row there).
//
// The kernel takes hd 16, 32, 64 or 128, G up to 8 (compiled for G == 1
// and for any G up to 8), and a block size that is a power of two.
//
// Build without --use_fast_math: expf stays accurate.

#include "attn_common.cuh"

namespace {

// grid (KV, ns, B); ns == 1 and nbc == nb for the single pass. SPLIT writes
// the unnormalised partials acc (B, ns, KV, G, hd), m and l (B, ns, KV, G);
// otherwise out (B, KV, G, hd) = acc / max(l, 1e-30). GT is the number of
// query rows compiled in: 1 (G == 1, the dense models' MHA) or kMaxG (any G
// up to it). hd and bs are powers of two (shifts: hd_shift, bs_shift). The
// walk itself is attend_rows (attn_common.cuh); row t of sequence b lives
// at offset t % bs of block tables[b, t / bs].
template <int BITS, typename TQ, bool SPLIT, int GT>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const uint8_t* __restrict__ k_pool,
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
    const size_t head = SPLIT ? (static_cast<size_t>(b) * ns + c) * KV + e
                              : static_cast<size_t>(b) * KV + e;
    const size_t gh = static_cast<size_t>(G) << hd_shift;
    auto row_of = [=](int t) {
        return ((static_cast<size_t>(tbl[t >> bs_shift]) << bs_shift) + (t & (bs - 1))) *
                   KV + e;
    };
    attend_rows<BITS, TQ, SPLIT, GT>(
        q + (static_cast<size_t>(b) * KV + e) * gh, k_pool, k_sc, v_pool, v_sc, row_of,
        t_begin, t_end, G, hd_shift, scale, out + head * gh,
        SPLIT ? m_out + head * G : nullptr, SPLIT ? l_out + head * G : nullptr);
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

template <bool SPLIT, int BITS, typename TQ>
cudaError_t launch_typed(const void* q, const void* kp, const void* ksc, const void* vp,
                         const void* vsc, const void* tables, const void* lengths,
                         float* out, float* m, float* l, int B, int KV, int G, int hd,
                         int bs, int nb, int ns, int nbc, cudaStream_t stream) {
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
        paged_attn_kernel<BITS, TQ, SPLIT, 1><<<grid, kThreads, 0, stream>>>(
            pq, pk, pks, pv, pvs, pt, pl, out, m, l, KV, G, hs, bss, nb, nbc, scale);
    else
        paged_attn_kernel<BITS, TQ, SPLIT, kMaxG><<<grid, kThreads, 0, stream>>>(
            pq, pk, pks, pv, pvs, pt, pl, out, m, l, KV, G, hs, bss, nb, nbc, scale);
    return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t launch(const void* q, const void* kp, const void* ksc, const void* vp,
                   const void* vsc, const void* tables, const void* lengths, float* out,
                   float* m, float* l, int B, int KV, int G, int hd, int bs, int nb,
                   int bits, int q_bf16, int ns, int nbc, cudaStream_t stream) {
    if ((hd != 16 && hd != 32 && hd != 64 && hd != 128) || G < 1 || G > kMaxG ||
        log2_exact(bs) < 0 || nb < 1 || ns < 1 || nbc < 1)
        return cudaErrorInvalidValue;
    if (bits == 8)
        return q_bf16 ? launch_typed<SPLIT, 8, __nv_bfloat16>(q, kp, ksc, vp, vsc, tables,
                                                              lengths, out, m, l, B, KV, G,
                                                              hd, bs, nb, ns, nbc, stream)
                      : launch_typed<SPLIT, 8, float>(q, kp, ksc, vp, vsc, tables, lengths,
                                                      out, m, l, B, KV, G, hd, bs, nb, ns,
                                                      nbc, stream);
    if (bits == 4)
        return q_bf16 ? launch_typed<SPLIT, 4, __nv_bfloat16>(q, kp, ksc, vp, vsc, tables,
                                                              lengths, out, m, l, B, KV, G,
                                                              hd, bs, nb, ns, nbc, stream)
                      : launch_typed<SPLIT, 4, float>(q, kp, ksc, vp, vsc, tables, lengths,
                                                      out, m, l, B, KV, G, hd, bs, nb, ns,
                                                      nbc, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// C entry points (bound with ctypes). q: (B, KV, G, hd) f32 (q_bf16 == 0) or
// bf16; pools (n_blocks, bs, KV, hd * bits / 8) int8 / u8 codes; scales
// (n_blocks, bs, KV) f32; tables (B, nb) and lengths (B,) int64; out (B, KV,
// G, hd) f32. Each returns the cudaError_t of its launches (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* k_sc,
                                      const void* v_pool, const void* v_sc,
                                      const void* tables, const void* lengths, void* out,
                                      int B, int KV, int G, int hd, int bs, int nb,
                                      int bits, int q_bf16, void* stream) {
    return static_cast<int>(launch<false>(q, k_pool, k_sc, v_pool, v_sc, tables, lengths,
                                          static_cast<float*>(out), nullptr, nullptr, B, KV,
                                          G, hd, bs, nb, bits, q_bf16, 1, nb,
                                          static_cast<cudaStream_t>(stream)));
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
    const cudaError_t err = launch<true>(q, k_pool, k_sc, v_pool, v_sc, tables, lengths, pa,
                                         pm, pl, B, KV, G, hd, bs, nb, bits, q_bf16, ns, nbc,
                                         st);
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_kernel<<<dim3(KV, B), 128, 0, st>>>(pa, pm, pl, static_cast<float*>(out), KV, G, hd,
                                              ns);
    return static_cast<int>(cudaGetLastError());
}
