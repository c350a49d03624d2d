// The walk that the decode-attention kernels share (paged_attention.cu and
// kv_cache_attention.cu): attend_rows_cluster folds K/V rows [t_begin,
// t_end) of one (sequence, KV head) into an online softmax for the G query
// rows of that head, in tiles of kTile rows, with kThreads threads a block.
// The walk of a head is cut along the sequence into the C ranks of a
// thread-block cluster; each rank walks its chunk through a cp.async ring,
// and the ranks merge their partials on chip through distributed shared
// memory, into the normalised output (the single passes, and the split at
// kv_splits <= kMaxCluster) or into one unnormalised partial (m, l, acc) of
// the cluster (the split above kMaxCluster chunks, whose clusters a second
// pass merges).
//
// What bounds it on the H100: the bytes of the K and V rows it must
// read (rows * KV * (hd * bits / 8 + 4) * 2 a sequence; 142.6 MB at 32k
// context, B 2, KV 16, hd 64, int8: 42.6 us at 3.35 TB/s). The
// operations, 4 * G * hd a row and head, sit far below the tensor cores'
// ridge; but the walk is no plain dot product: each product and sum
// rounds on its own (below) and every code is turned into a float, so at
// a byte or half a byte a code the SMs' instruction rate binds it as much
// as the bytes do (PERF.md section 6 has the measurements). One block per
// (sequence, KV head) (B 2, KV 16: 32 blocks on 132 SMs) that loads a
// tile, waits and then computes reaches neither. So:
//   - C ranks give B * KV * C blocks; the single passes take C from
//     kernels/paged_attention.py::cluster_ranks (static shapes only): as
//     many as stay resident in one wave, three blocks an SM (two for G >
//     1; one at hd 256, whose ring of two 128-row stages takes 130 KB);
//     the split takes one rank a chunk (split_clusters); up to 16, above 8
//     as a non-portable cluster (up to 8 at hd 256, one block an SM);
//   - a ring of kStages tiles: the copies of the next tile fly while a
//     tile is consumed, and the rows of that next tile (the table entries
//     of the pool) are read before the wait for the current one;
//   - fewer instructions, the arithmetic untouched: HD compiled in; codes
//     made floats by an exact bias (kBias8 / kBias4) instead of a conversion
//     at an eighth of the add rate; a scoring lane takes two words of a row
//     and adds them itself (the butterfly's first level); for G == 1 q
//     stays in registers, for G > 1 it sits in a padded layout that spreads
//     a warp's reads over the banks; a PV thread takes two adjacent dims
//     (two chains) and the PV runs on four warps, one per scheduler.
//
// Each kernel says where row t lives: the index of the (token, head) pair,
// so that its codes start at byte row * hd * BITS / 8 of the code tensor
// and its scale is scale[row]. attend_rows_cluster takes ``tile_rows(s0)``,
// which gives the row of token s0 + tl of a tile as ``row_of(tl)``, so that
// a tile inside one pool block reads its table entry once. The paged
// kernels read the block table there; the dense-cache kernel computes (b *
// S + t) * KV + e.
//
// Every product and every sum is rounded on its own (__fmul_rn /
// __fadd_rn: no fused multiply-add), in the order written here, so that a
// torch replay of the walk (kernels/kv_cache_attention.py::
// kv_cache_attention_walk) gives the same bits on the card. A change to the
// walk's order or rounding must change that replay with it.
//
// Per tile of kTile rows:
//   - staging: cp.async copies of the tile's K/V rows and scales, 16 bytes
//     a copy where a row is a multiple of 16 bytes (the codes must then
//     start on a 16-byte boundary), else 8;
//   - scores: the words of a token's row are dotted with the G query rows
//     of the head, each word's 64 / BITS codes in one chain, and the words
//     meet in an xor butterfly; the K scale multiplies the sum;
//   - softmax: one warp per query row updates (m, l) over the tile, lane L
//     summing p[L], p[L + 32], ..., the lanes meeting in a butterfly;
//   - PV: chain (r, d) sums every R-th token of the tile, from token r on,
//     for output dim d and each of the G rows, then folds the tile's sum
//     into its running f32 sum (R = kThreads / hd token groups, reduced in
//     shared memory at the end).
// Rows below t_lo or at or past t_end score -1e30 and weigh exactly 0 (a
// local layer's window starts at t_lo; the walk starts at t_begin, on a
// tile boundary at or below it); such rows are not copied and the PV step
// starts past them. With no row at all (t_end <= max(t_begin, t_lo)) m
// stays -1e30 and l and the sums 0.
//
// The cluster merge (rank order 0..C-1, each product and sum rounded on
// its own): M = max_c m_c, w_c = expf(m_c - M), out = sum_c w_c acc_c /
// max(sum_c w_c l_c, 1e-30). A rank with no row weighs expf(-1e30 - M) =
// 0; at C = 1, w = 1 and the output is acc / max(l, 1e-30), the
// arithmetic of one block over the whole extent, bit for bit (the rank
// writes it without the cluster barriers). Asked for the cluster's partial
// instead, the merge writes M, sum_c w_c l_c and sum_c w_c acc_c, unscaled.
//
// HD, the head dim compiled in, is 16, 32, 64, 128 or 256, and HDR <= HD
// the real one: a head dim that is no power of two (120) runs as the next
// one up, its HD - HDR padding dims zero in q, so each pad product is an
// exact zero and the sums are those of the HDR real dims; the pad dims'
// outputs are never written. q, out and the codes in device memory are
// HDR wide (rows of HDR * BITS / 8 bytes, a multiple of 8); in shared
// memory a row is HD wide. G is at most kMaxG; GT is the number of query
// rows compiled in: 1, or kMaxG for any G up to it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                    // tokens per tile
constexpr int kMaxG = 8;                      // query rows per KV head
constexpr float kNeg = -1e30f;
constexpr int kStages = 2;                    // ring stages
constexpr int kMaxCluster = 16;               // ranks a cluster (above 8: non-portable)
constexpr size_t kNoRow = ~static_cast<size_t>(0);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; 16-byte
// copies bypass L1 (.cg), smaller ones may not (.ca).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v >> 1) : 0; }

// Codes as floats without an integer-to-float conversion (16 a clock on an
// SM, an eighth of the f32 add rate): an integer 0 <= c < 256 placed in the
// low bits of the float 2^23 (0x4b000000) is the float 2^23 + c, and
// subtracting 2^23 + bias is exact. The values are the ones a conversion
// gives, so the arithmetic that follows is unchanged.
constexpr float kBias8 = 8388736.f;           // 2^23 + 128: int8 code c stored as c + 128
constexpr float kBias4 = 8388616.f;           // 2^23 + 8: 4-bit code n stands for n - 8

// The 64 / BITS codes of one 8-byte word, as floats, in row order, by the
// exact bias above: byte j of a 32-bit half goes to
// the low byte of 0x4b000000 with one byte permute.
template <int BITS>
__device__ __forceinline__ void decode_word_exact(uint2 w, float* c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const unsigned x = h ? w.y : w.x;
        if (BITS == 8) {
            const unsigned b = x ^ 0x80808080u;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                c[4 * h + j] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4b000000u, 0x7540 | j)),
                                         kBias8);
        } else {
            const unsigned lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                c[8 * h + 2 * j] =
                    __fsub_rn(__uint_as_float(__byte_perm(lo, 0x4b000000u, 0x7540 | j)), kBias4);
                c[8 * h + 2 * j + 1] =
                    __fsub_rn(__uint_as_float(__byte_perm(hi, 0x4b000000u, 0x7540 | j)), kBias4);
            }
        }
    }
}

// The two codes of dims d0, d0 + 1 of one V row (d0 even), as floats, by
// the same exact bias.
template <int BITS>
__device__ __forceinline__ void row_codes2(const uint8_t* row, int d0, float* c) {
    if (BITS == 8) {
        const unsigned x = *reinterpret_cast<const unsigned short*>(row + d0) ^ 0x8080u;
#pragma unroll
        for (int j = 0; j < 2; ++j)
            c[j] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540 | j)), kBias8);
    } else {
        const unsigned by = row[d0 >> 1];
        c[0] = __fsub_rn(__uint_as_float((by & 0xfu) | 0x4b000000u), kBias4);
        c[1] = __fsub_rn(__uint_as_float((by >> 4) | 0x4b000000u), kBias4);
    }
}

// Byte offsets of attend_rows_cluster's dynamic shared memory: q at 0 (G
// rows of hd + hd * bits / 64 f32: the q values of each 8-byte word of a
// row sit one float further apart than the word's codes, so the lanes of
// a row read distinct banks; the rank's G * hd sums after the walk), the
// scores / probabilities (G * kTile f32), m, l and corr (kMaxG f32 each),
// then the ring of kStages stages, each K codes, V codes (kTile rows of
// row_bytes), K scales, V scales (kTile f32); after the walk the ring
// holds the PV groups' sums (kThreads * G f32).
struct WalkSmem {
    int p, stats, ring, stage_bytes, total;
};

__host__ __device__ inline WalkSmem walk_smem(int G, int hd, int row_bytes) {
    WalkSmem s;
    s.p = G * (hd + row_bytes / 8) * 4;
    s.stats = s.p + G * kTile * 4;
    s.ring = (s.stats + 3 * kMaxG * 4 + 15) & ~15;
    s.stage_bytes = 2 * kTile * row_bytes + 2 * kTile * 4;
    const int ring = kStages * s.stage_bytes, red = kThreads * G * 4;
    s.total = s.ring + (ring > red ? ring : red);
    return s;
}

// Walk rows [max(t_begin, t_lo), t_end) of one head, in tiles from
// t_begin, as rank cluster.block_rank() of its cluster, then merge the
// ranks' partials into out_h (G, HDR), which
// the ranks write in shares: normalised, or with m_h and l_h (G) given,
// the cluster's unnormalised partial (the sums in out_h, the max and the
// sum of exponentials in m_h and l_h). Every block of the cluster must
// call it (a rank with no row too): with C > 1 it synchronises the cluster
// twice.
// qh: the head's G query rows (G, HDR). Rows of a multiple of 16 bytes are
// copied in 16-byte units (the codes must start on a 16-byte boundary),
// others in 8. HD is compiled in, so every loop bound is a constant.
template <int BITS, int HD, int HDR, typename TQ, int GT, typename TileRows>
__device__ __forceinline__ void attend_rows_cluster(
    const TQ* __restrict__ qh, const uint8_t* __restrict__ k_codes,
    const float* __restrict__ k_sc, const uint8_t* __restrict__ v_codes,
    const float* __restrict__ v_sc, TileRows tile_rows, int t_begin, int t_lo, int t_end,
    int G, float scale, float* __restrict__ out_h, float* __restrict__ m_h = nullptr,
    float* __restrict__ l_h = nullptr) {
    namespace cg = cooperative_groups;
    constexpr int CPW = 64 / BITS;            // codes per 8-byte word
    constexpr int WPR = HD / CPW;             // words per K/V row: 1..32
    constexpr int HD_SHIFT = ilog2(HD);
    constexpr int ROW_BYTES = WPR * 8;        // a row in shared memory
    constexpr int GROW = HDR * BITS / 8;      // a row in device memory
    static_assert(HDR <= HD && GROW % 8 == 0, "rows of whole 8-byte words");
    constexpr int CODE_BYTES = kTile * ROW_BYTES;   // one stage's K (or V) codes
    constexpr int R = kThreads / HD;          // token groups of the PV step: 1..16
    // scores: a lane dots KW words of a row, words part and part + LPT,
    // and adds the two (the butterfly's first level); LPT lanes hold a row
    constexpr int KW = WPR >= 2 ? 2 : 1;
    constexpr int LPT = WPR / KW;
    constexpr int TPW = 32 / LPT;             // tokens a warp scores at once
    constexpr int QS = HD + WPR;              // floats a q row takes in shared memory
    constexpr int UNIT = GROW % 16 == 0 ? 16 : 8;   // bytes a copy moves
    constexpr int UPR = GROW / UNIT;          // copies a row
    constexpr int COPIES = (kTile * UPR + kThreads - 1) / kThreads;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    extern __shared__ __align__(16) unsigned char smem[];
    const WalkSmem lay = walk_smem(G, HD, ROW_BYTES);
    float* s_q = reinterpret_cast<float*>(smem);
    float* s_p = reinterpret_cast<float*>(smem + lay.p);
    float* s_m = reinterpret_cast<float*>(smem + lay.stats);
    float* s_l = s_m + kMaxG;
    float* s_corr = s_l + kMaxG;
    unsigned char* ring = smem + lay.ring;

    for (int i = tid; i < G * HD; i += kThreads) {
        const int g = i >> HD_SHIFT, dim = i & (HD - 1);
        s_q[g * QS + (dim / CPW) * (CPW + 1) + dim % CPW] =
            dim < HDR ? to_f32(qh[g * HDR + dim]) : 0.f;
    }
    if (tid < kMaxG) {
        s_m[tid] = kNeg;
        s_l[tid] = 0.f;
        s_corr[tid] = 1.f;
    }

    // the PV step: thread (r, d0) of the first kThreads / DPT threads sums
    // token group r's chains for dims d0 and d0 + 1 (one chain a dim)
    constexpr int DPT = 2;                    // dims a PV thread takes
    constexpr int PV_THREADS = kThreads / DPT;
    const int r = tid / (HD / DPT), d0 = (tid % (HD / DPT)) * DPT;
    float acc[GT][DPT];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[g][j] = 0.f;

    // the copies: unit u of a tile is bytes [(u % UPR) * UNIT, ...) of row
    // u / UPR; thread tid takes units tid + c * kThreads. Rows below t_lo
    // (the head of the first tile) and from t_end on are not copied
    const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile : 0;
    size_t rows[COPIES];                      // this thread's rows of the planned tile
    size_t srow;                              // and the row of its scales
    auto plan = [&](int i) {
        const int s0 = t_begin + i * kTile;
        const int n_live = i < n_tiles ? min(kTile, t_end - s0) : 0;
        const int n_dead = max(0, t_lo - s0);
#pragma unroll
        for (int c = 0; c < COPIES; ++c) rows[c] = kNoRow;
        srow = kNoRow;
        if (n_live > n_dead) {
            const auto row_of = tile_rows(s0);   // row_of(tl): the row of token s0 + tl
#pragma unroll
            for (int c = 0; c < COPIES; ++c) {
                const int tl = (tid + c * kThreads) / UPR;
                if (tl >= n_dead && tl < n_live) rows[c] = row_of(tl);
            }
            if (tid >= n_dead && tid < n_live) srow = row_of(tid);
        }
    };
    auto fire = [&](int i) {                  // one commit group per tile, empty or not
        unsigned char* st = ring + (i % kStages) * lay.stage_bytes;
#pragma unroll
        for (int c = 0; c < COPIES; ++c) {
            if (rows[c] == kNoRow) continue;
            const int u = tid + c * kThreads;
            const int dst = (u / UPR) * ROW_BYTES + (u % UPR) * UNIT;
            const size_t off = rows[c] * GROW + (u % UPR) * UNIT;
            cp_async<UNIT>(st + dst, k_codes + off);
            cp_async<UNIT>(st + CODE_BYTES + dst, v_codes + off);
        }
        if (srow != kNoRow) {
            float* ssc = reinterpret_cast<float*>(st + 2 * CODE_BYTES);
            cp_async<4>(ssc + tid, k_sc + srow);
            cp_async<4>(ssc + kTile + tid, v_sc + srow);
        }
        cp_async_commit();
    };

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        plan(i);
        fire(i);
    }
    __syncthreads();                          // q, m, l and corr in shared memory
    const int grp = lane / LPT, part = lane % LPT;
    float q1[GT == 1 ? KW * CPW : 1];         // G == 1: the lane's q slices, kept
    if (GT == 1) {
#pragma unroll
        for (int w = 0; w < KW; ++w)
#pragma unroll
            for (int j = 0; j < CPW; ++j)
                q1[w * CPW + j] = s_q[(part + w * LPT) * (CPW + 1) + j];
    }

    for (int i = 0; i < n_tiles; ++i) {
        plan(i + kStages - 1);                // table reads in flight during the wait
        cp_async_wait<kStages - 2>();         // this thread's copies of tile i landed
        __syncthreads();                      // everyone's; tile i - 1 is consumed
        const int s0 = t_begin + i * kTile;
        const int n_live = min(kTile, t_end - s0);
        const int n_dead = max(0, t_lo - s0);  // rows below the window's start
        const unsigned char* st = ring + (i % kStages) * lay.stage_bytes;
        const uint2* s_k = reinterpret_cast<const uint2*>(st);
        const uint8_t* vb = st + CODE_BYTES;
        const float* s_ksc = reinterpret_cast<const float*>(st + 2 * CODE_BYTES);
        const float* s_vsc = s_ksc + kTile;

        // 1. scores
#pragma unroll
        for (int tl0 = warp * TPW; tl0 < kTile; tl0 += kWarps * TPW) {
            const int tl = tl0 + grp;
            float dot[GT];
#pragma unroll
            for (int g = 0; g < GT; ++g) dot[g] = 0.f;
#pragma unroll
            for (int w = 0; w < KW; ++w) {
                float codes[CPW];
                decode_word_exact<BITS>(s_k[tl * WPR + part + w * LPT], codes);
                const float* qd = s_q + (part + w * LPT) * (CPW + 1);
#pragma unroll
                for (int g = 0; g < GT; ++g) {
                    if (GT != 1 && g >= G) continue;
                    float dw = 0.f;
#pragma unroll
                    for (int j = 0; j < CPW; ++j)
                        dw = __fadd_rn(dw, __fmul_rn(GT == 1 ? q1[w * CPW + j] : qd[g * QS + j],
                                                     codes[j]));
                    dot[g] = w ? __fadd_rn(dot[g], dw) : dw;
                }
            }
#pragma unroll
            for (int o = LPT >> 1; o > 0; o >>= 1) {
#pragma unroll
                for (int g = 0; g < GT; ++g)
                    dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
            }
            if (part == 0) {
#pragma unroll
                for (int g = 0; g < GT; ++g)
                    if (GT == 1 || g < G)
                        s_p[g * kTile + tl] =
                            tl >= n_dead && tl < n_live
                                ? __fmul_rn(__fmul_rn(dot[g], s_ksc[tl]), scale)
                                : kNeg;
            }
        }
        __syncthreads();
        fire(i + kStages - 1);                // into the stage tile i - 1 used

        // 2. online softmax: one warp per query row
        for (int g = warp; g < G; g += kWarps) {
            float* sp = s_p + g * kTile;
            float mx = kNeg;
#pragma unroll
            for (int k = lane; k < kTile; k += 32) mx = fmaxf(mx, sp[k]);
            mx = warp_max(mx);
            const float m_prev = s_m[g];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
#pragma unroll
            for (int k = lane; k < kTile; k += 32) {
                const float p = k >= n_dead && k < n_live ? expf(sp[k] - m_new) : 0.f;
                sp[k] = p;
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                s_corr[g] = corr;
                s_l[g] = __fadd_rn(__fmul_rn(s_l[g], corr), sum);
                s_m[g] = m_new;
            }
        }
        __syncthreads();

        // 3. PV: chain (r, d) sums tokens r, r + R, ... of the tile for dim
        //    d, then folds the tile's sum into its running one; four tokens'
        //    values are read before their sums, which run in token order
        if (tid < PV_THREADS) {
            float tacc[GT][DPT];
#pragma unroll
            for (int g = 0; g < GT; ++g)
#pragma unroll
                for (int j = 0; j < DPT; ++j) tacc[g][j] = 0.f;
            auto values = [&](int tl, float* vv) {
                row_codes2<BITS>(vb + tl * ROW_BYTES, d0, vv);
                const float vs = s_vsc[tl];
#pragma unroll
                for (int j = 0; j < DPT; ++j) vv[j] = __fmul_rn(vv[j], vs);
            };
            auto fold = [&](int tl, const float* vv) {
#pragma unroll
                for (int g = 0; g < GT; ++g) {
                    if (GT != 1 && g >= G) continue;
                    const float pg = s_p[g * kTile + tl];
#pragma unroll
                    for (int j = 0; j < DPT; ++j)
                        tacc[g][j] = __fadd_rn(tacc[g][j], __fmul_rn(pg, vv[j]));
                }
            };
            // the chain's first live token (skipped rows weigh exactly 0)
            int tl = r + (n_dead > r ? (n_dead - r + R - 1) / R * R : 0);
            for (; tl + 3 * R < n_live; tl += 4 * R) {
                float vv[4][DPT];
#pragma unroll
                for (int k = 0; k < 4; ++k) values(tl + k * R, vv[k]);
#pragma unroll
                for (int k = 0; k < 4; ++k) fold(tl + k * R, vv[k]);
            }
            for (; tl < n_live; tl += R) {
                float vv[DPT];
                values(tl, vv);
                fold(tl, vv);
            }
#pragma unroll
            for (int g = 0; g < GT; ++g)
                if (GT == 1 || g < G) {
#pragma unroll
                    for (int j = 0; j < DPT; ++j)
                        acc[g][j] = __fadd_rn(__fmul_rn(acc[g][j], s_corr[g]), tacc[g][j]);
                }
        }
    }

    // 4. reduce the R groups' sums (in the ring, its copies all landed) into
    //    this rank's sums: the output itself when the rank is alone, else
    //    kept in s_q for the merge
    cp_async_wait<0>();
    __syncthreads();
    float* s_red = reinterpret_cast<float*>(ring);
    if (tid < PV_THREADS) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
            if (GT == 1 || g < G) {
#pragma unroll
                for (int j = 0; j < DPT; ++j) s_red[(r * G + g) * HD + d0 + j] = acc[g][j];
            }
    }
    __syncthreads();
    const int C = static_cast<int>(cg::this_cluster().num_blocks());
    for (int i = tid; i < G * HD; i += kThreads) {
        const int g = i >> HD_SHIFT, dd = i & (HD - 1);
        float sum = 0.f;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) sum += s_red[(rr * G + g) * HD + dd];
        if (C != 1)
            s_q[i] = sum;
        else if (dd < HDR)                    // the merge's arithmetic at weight 1
            out_h[g * HDR + dd] = m_h ? sum : sum / fmaxf(s_l[g], 1e-30f);
    }
    if (C == 1) {
        if (m_h && tid < G) {
            m_h[tid] = s_m[tid];
            l_h[tid] = s_l[tid];
        }
        return;
    }

    // 5. merge the ranks' partials through distributed shared memory
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                           // every rank's sums, m and l are written
    const int rank = static_cast<int>(cluster.block_rank());
    for (int i = rank * kThreads + tid; i < G * HD; i += C * kThreads) {
        const int g = i >> HD_SHIFT, dd = i & (HD - 1);
        if (dd >= HDR) continue;              // a pad dim
        float M = kNeg;
        for (int c = 0; c < C; ++c) M = fmaxf(M, cluster.map_shared_rank(s_m, c)[g]);
        float num = 0.f, den = 0.f;
        for (int c = 0; c < C; ++c) {
            const float w = expf(cluster.map_shared_rank(s_m, c)[g] - M);
            const float a = __fmul_rn(w, cluster.map_shared_rank(s_q, c)[i]);
            const float b = __fmul_rn(w, cluster.map_shared_rank(s_l, c)[g]);
            num = c ? __fadd_rn(num, a) : a;
            den = c ? __fadd_rn(den, b) : b;
        }
        if (!m_h) {
            out_h[g * HDR + dd] = num / fmaxf(den, 1e-30f);
            continue;
        }
        out_h[g * HDR + dd] = num;
        if (dd == 0) {
            m_h[g] = M;
            l_h[g] = den;
        }
    }
    cluster.sync();                           // no rank leaves while its memory is read
}

int log2_exact(int v) {                      // -1 unless v is a power of two
    if (v < 1 || (v & (v - 1))) return -1;
    int s = 0;
    while ((1 << s) < v) ++s;
    return s;
}

}  // namespace
