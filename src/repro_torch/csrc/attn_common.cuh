// The walk that the decode-attention kernels share (paged_attention.cu and
// kv_cache_attention.cu): one CUDA block of kThreads threads folds the K/V
// rows [t_begin, t_end) of one (sequence, KV head) into an online softmax
// for the G query rows of that head.
//
// Each kernel says where row t lives through ``row_of(t)``: the index of
// the (token, head) pair, so that its codes start at byte row_of(t) *
// hd * BITS / 8 of the code tensor and its scale is scale[row_of(t)]. The
// paged kernels read the block table there; the dense-cache kernel
// computes (b * S + t) * KV + e.
//
// Every product and every sum is rounded on its own (__fmul_rn /
// __fadd_rn: no fused multiply-add), in the order written here, so that a
// torch replay of the walk (kernels/kv_cache_attention.py::
// kv_cache_attention_walk) gives the same bits on the card. A change to the
// walk's order or rounding must change that replay with it.
//
// Per tile of kTile rows:
//   - staging: all kThreads threads load the tile's K/V rows as 8-byte
//     words (8 int8 or 16 int4 codes), up to 8 independent loads a thread
//     issued before any is used, into shared memory, zeros past t_end;
//   - scores: the lanes of a group hold one token's row, one word each,
//     dot it with the G query rows of the head (q in shared memory, f32)
//     and reduce by warp shuffles; the K scale multiplies the sum;
//   - softmax: one warp per query row updates (m, l) over the tile;
//   - PV: thread (r, d) sums every R-th token of the tile for output dim d
//     and all G rows, then folds the tile's sum into its running f32 sum
//     (R = kThreads / hd token groups, reduced in shared memory at the
//     end).
// Rows at or past t_end score -1e30 and weigh exactly 0; with no row at
// all (t_end <= t_begin) m stays -1e30 and l and the sums 0.
//
// hd is 16, 32, 64 or 128 (hd_shift = log2 hd) and G at most kMaxG; GT is
// the number of query rows compiled in: 1, or kMaxG for any G up to it.

#pragma once

#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                    // tokens per tile
constexpr int kMaxG = 8;                      // query rows per KV head
constexpr int kMaxHd = 128;
constexpr int kTileWords = kTile * kMaxHd / 8;        // 8-byte words, int8 at hd 128
constexpr int kWordsPerThread = kTileWords / kThreads;
constexpr float kNeg = -1e30f;

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

// The 64 / BITS codes of one 8-byte word, as floats, in row order.
template <int BITS>
__device__ __forceinline__ void decode_word(uint2 w, float* c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const unsigned byte = ((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xffu;
        if (BITS == 8) {
            c[j] = static_cast<float>(static_cast<int8_t>(byte));
        } else {
            c[2 * j] = static_cast<float>(static_cast<int>(byte & 0xfu) - 8);
            c[2 * j + 1] = static_cast<float>(static_cast<int>(byte >> 4) - 8);
        }
    }
}

// Walk rows [t_begin, t_end) of one head. qh: the head's G query rows (G,
// hd). SPLIT writes the unnormalised sums to out_h (G, hd) and the running
// max and sum of exponentials to m_h and l_h (G); otherwise out_h = sums /
// max(l, 1e-30).
template <int BITS, typename TQ, bool SPLIT, int GT, typename RowOf>
__device__ __forceinline__ void attend_rows(
    const TQ* __restrict__ qh, const uint8_t* __restrict__ k_codes,
    const float* __restrict__ k_sc, const uint8_t* __restrict__ v_codes,
    const float* __restrict__ v_sc, RowOf row_of, int t_begin, int t_end, int G,
    int hd_shift, float scale, float* __restrict__ out_h, float* __restrict__ m_h,
    float* __restrict__ l_h) {
    constexpr int CPW = 64 / BITS;            // codes per 8-byte word
    constexpr int CPW_SHIFT = BITS == 8 ? 3 : 4;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int hd = 1 << hd_shift;
    const int wpr_shift = hd_shift - CPW_SHIFT;
    const int wpr = 1 << wpr_shift;           // words per K/V row: 1..16
    const int row_bytes = wpr * 8;

    __shared__ __align__(16) uint2 s_k[kTileWords];
    __shared__ __align__(16) uint2 s_v[kTileWords];
    __shared__ float s_ksc[kTile], s_vsc[kTile];
    __shared__ float s_q[kMaxG * kMaxHd];
    __shared__ float s_p[kMaxG * kTile];
    __shared__ float s_m[kMaxG], s_l[kMaxG], s_corr[kMaxG];

    for (int i = tid; i < G * hd; i += kThreads) s_q[i] = to_f32(qh[i]);
    if (tid < kMaxG) {
        s_m[tid] = kNeg;
        s_l[tid] = 0.f;
        s_corr[tid] = 1.f;
    }

    const int R = kThreads >> hd_shift;       // token groups of the PV step
    const int d = tid & (hd - 1), r = tid >> hd_shift;
    float acc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[g] = 0.f;
    __syncthreads();

    for (int s0 = t_begin; s0 < t_end; s0 += kTile) {
        const int n_live = min(kTile, t_end - s0);
        // 1. stage the tile's K/V words and scales (zeros past the live rows)
        uint2 kr[kWordsPerThread], vr[kWordsPerThread];
#pragma unroll
        for (int i = 0; i < kWordsPerThread; ++i) {
            const int w = tid + i * kThreads;
            const int tl = w >> wpr_shift;
            kr[i] = vr[i] = make_uint2(0u, 0u);
            if (tl < n_live) {
                const size_t off = (static_cast<size_t>(row_of(s0 + tl)) << wpr_shift) +
                                   (w & (wpr - 1));
                kr[i] = reinterpret_cast<const uint2*>(k_codes)[off];
                vr[i] = reinterpret_cast<const uint2*>(v_codes)[off];
            }
        }
        float ksc = 0.f, vsc = 0.f;
        if (tid < n_live) {
            const size_t row = row_of(s0 + tid);
            ksc = k_sc[row];
            vsc = v_sc[row];
        }
        __syncthreads();                      // the previous tile is consumed
#pragma unroll
        for (int i = 0; i < kWordsPerThread; ++i) {
            const int w = tid + i * kThreads;
            if (w < kTile * wpr) {
                s_k[w] = kr[i];
                s_v[w] = vr[i];
            }
        }
        if (tid < kTile) {
            s_ksc[tid] = ksc;
            s_vsc[tid] = vsc;
        }
        __syncthreads();

        // 2. scores: a group of wpr lanes holds one token's row
        const int tpw = 32 >> wpr_shift;
        const int grp = lane >> wpr_shift, part = lane & (wpr - 1);
        for (int tl0 = warp * tpw; tl0 < kTile; tl0 += kWarps * tpw) {
            const int tl = tl0 + grp;
            float codes[CPW];
            decode_word<BITS>(s_k[tl * wpr + part], codes);
            const float* qd = s_q + part * CPW;
            float dot[GT];
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                dot[g] = 0.f;
                if (GT == 1 || g < G) {
#pragma unroll
                    for (int j = 0; j < CPW; ++j)
                        dot[g] = __fadd_rn(dot[g], __fmul_rn(qd[g * hd + j], codes[j]));
                }
            }
            for (int o = wpr >> 1; o > 0; o >>= 1) {
#pragma unroll
                for (int g = 0; g < GT; ++g)
                    dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
            }
            if (part == 0) {
#pragma unroll
                for (int g = 0; g < GT; ++g)
                    if (GT == 1 || g < G)
                        s_p[g * kTile + tl] =
                            tl < n_live ? __fmul_rn(__fmul_rn(dot[g], s_ksc[tl]), scale) : kNeg;
            }
        }
        __syncthreads();

        // 3. online softmax: one warp per query row
        for (int g = warp; g < G; g += kWarps) {
            float* sp = s_p + g * kTile;
            float mx = kNeg;
            for (int i = lane; i < kTile; i += 32) mx = fmaxf(mx, sp[i]);
            mx = warp_max(mx);
            const float m_prev = s_m[g];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            for (int i = lane; i < kTile; i += 32) {
                const float p = i < n_live ? expf(sp[i] - m_new) : 0.f;
                sp[i] = p;
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

        // 4. PV: thread (r, d) sums tokens r, r + R, ... of the tile for dim
        //    d, then folds the tile's sum into its running one
        float tacc[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) tacc[g] = 0.f;
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(s_v);
        for (int tl = r; tl < n_live; tl += R) {
            float code;
            if (BITS == 8) {
                code = static_cast<float>(static_cast<int8_t>(vb[tl * row_bytes + d]));
            } else {
                const unsigned by = vb[tl * row_bytes + (d >> 1)];
                code = static_cast<float>(static_cast<int>((d & 1) ? (by >> 4) : (by & 0xfu)) - 8);
            }
            const float vv = __fmul_rn(code, s_vsc[tl]);
#pragma unroll
            for (int g = 0; g < GT; ++g)
                if (GT == 1 || g < G)
                    tacc[g] = __fadd_rn(tacc[g], __fmul_rn(s_p[g * kTile + tl], vv));
        }
#pragma unroll
        for (int g = 0; g < GT; ++g)
            if (GT == 1 || g < G) acc[g] = __fadd_rn(__fmul_rn(acc[g], s_corr[g]), tacc[g]);
    }

    // 5. reduce the R groups' sums in shared memory (over the K tile)
    __syncthreads();
    float* s_red = reinterpret_cast<float*>(s_k);     // R * G * hd <= 2048 floats
#pragma unroll
    for (int g = 0; g < GT; ++g)
        if (GT == 1 || g < G) s_red[(r * G + g) * hd + d] = acc[g];
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
        const int g = i / hd, dd = i - g * hd;
        float sum = 0.f;
        for (int rr = 0; rr < R; ++rr) sum += s_red[(rr * G + g) * hd + dd];
        out_h[i] = SPLIT ? sum : sum / fmaxf(s_l[g], 1e-30f);
    }
    if (SPLIT && tid < G) {
        m_h[tid] = s_m[tid];
        l_h[tid] = s_l[tid];
    }
}

int log2_exact(int v) {                      // -1 unless v is a power of two
    if (v < 1 || (v & (v - 1))) return -1;
    int s = 0;
    while ((1 << s) < v) ++s;
    return s;
}

}  // namespace
