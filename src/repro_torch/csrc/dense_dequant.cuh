// The dequant walk on dense_common.cuh's tiling, shared by dequant_matmul.cu
// and expert_gemm.cu (row 2 and row 7):
//
//   out = (a @ dequant(w).T) * scales                                   (f32)
//   dequant(w)[n, k] = codebook[code(n, k)]     (per-channel scales (N,))
//   grouped: dequant(w)[n, k] = codebook[code(n, k)] * s[n, k / G]  (no epilogue)
//
// Rounding, replayed by the plain versions (ref.py::tile_order_matmul): a
// thread adds each 8 codes' products one at a time into a block sum (times
// its group scale), and the block sums into one f32 sum per (row, column);
// the 8 k-lanes' sums meet in a pairwise tree, the C ranks' partials in
// rank order, then the per-channel scale multiplies (short chains: the sum
// stays near the exact one, and so does a tensor-parallel sum of K slices).
// Each product and each sum is rounded on its own (__fmul_rn / __fadd_rn),
// except where every product is exact in f32: bf16 activations against a
// codebook of integers of at most 16 bits (the port's uniform codebooks:
// -2..1, -8..7) and no scale folded into the levels. There a fused
// multiply-add gives the same bits; the block checks the codebook and
// takes that path.
#pragma once

#include <cuda_bf16.h>

#include "dense_common.cuh"

constexpr int kCb = 16;               // codebook floats staged (2^bits <= 16)

template <typename TA>
struct Acts;

// 8 activations of one row as f32, from a 16- or 32-byte aligned address
// of the activation tile (a broadcast: every lane of a warp reads it).
template <>
struct Acts<__nv_bfloat16> {
    static constexpr int BITS = 16;
    static __device__ __forceinline__ void load8(const unsigned char* p, float (&v)[8]) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[2 * i] = __uint_as_float(w[i] << 16);
            v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};

template <>
struct Acts<float> {
    static constexpr int BITS = 32;
    static __device__ __forceinline__ void load8(const unsigned char* p, float (&v)[8]) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        const float4 y = *reinterpret_cast<const float4*>(p + 16);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    }
};

template <bool EXACT>
__device__ __forceinline__ float madd(float acc, float x, float w) {
    if constexpr (EXACT) return __fmaf_rn(x, w, acc);   // x * w exact: the same bits
    return __fadd_rn(acc, __fmul_rn(x, w));
}

// Group modes: per-channel scales (the epilogue); a group scale for each
// 8 codes (G a multiple of 8: it multiplies their block sum); a group scale
// folded into each code's level (any other G).
constexpr int kChannel = 0, kBlock = 1, kFold = 2;

// The products of one weight word (CPW codes from k0) for every row and
// column of the thread, 8 codes a block: each block's products are summed
// one by one into a block sum (times its group scale under kBlock), which
// is added into acc. FULL: the whole word lies below hi. 2-bit levels are
// read two at a time from the table of the 16 level pairs (cb2), which
// halves the codebook reads; the same levels, so the same bits.
template <int WB, int NC, int GM, typename TA, bool EXACT, bool FULL>
__device__ __forceinline__ void dq_word(const DenseArgs& a, const DenseTile& t, int k0,
                                        const uint32_t (&wd)[NC], const float* cb,
                                        const float* st, const unsigned char* at,
                                        float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / WB;
    constexpr unsigned MASK = (1u << WB) - 1u;
    const int lane = threadIdx.x % 32;
    const float2* cb2 = reinterpret_cast<const float2*>(cb + kCb + 32 * NC);
#pragma unroll
    for (int b = 0; b < CPW / 8; ++b) {
        const int kb = k0 + 8 * b;
        float lv[8][NC];
        if constexpr (WB == 2) {               // two neighbouring levels a read
#pragma unroll
            for (int q = 0; q < 8; q += 2)
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    const float2 p = cb2[(wd[i] >> (WB * (8 * b + q))) & 15u];
                    lv[q][i] = p.x;
                    lv[q + 1][i] = p.y;
                }
        } else {
#pragma unroll
            for (int q = 0; q < 8; ++q)
#pragma unroll
                for (int i = 0; i < NC; ++i) lv[q][i] = cb[(wd[i] >> (WB * (8 * b + q))) & MASK];
        }
        float s[NC];
        if constexpr (GM == kBlock) {
            const int g = t.group(min(kb, a.K - 1)) - t.g_lo;
#pragma unroll
            for (int i = 0; i < NC; ++i) s[i] = st[(lane + 32 * i) * a.s_pitch + g];
        } else if constexpr (GM == kFold) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int g = t.group(min(kb + q, a.K - 1)) - t.g_lo;
#pragma unroll
                for (int i = 0; i < NC; ++i)
                    lv[q][i] = __fmul_rn(lv[q][i], st[(lane + 32 * i) * a.s_pitch + g]);
            }
        }
        const unsigned char* arow = at + (kb - t.lo) * (Acts<TA>::BITS / 8);
#pragma unroll
        for (int r = 0; r < kMaxMt; ++r) {
            if (r >= t.rows) break;
            float av[8];
            Acts<TA>::load8(arow + r * a.a_pitch, av);
            float part[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) part[i] = 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                if (!FULL && kb + q >= t.hi) break;
#pragma unroll
                for (int i = 0; i < NC; ++i) part[i] = madd<EXACT>(part[i], av[q], lv[q][i]);
            }
#pragma unroll
            for (int i = 0; i < NC; ++i)
                acc[r][i] = __fadd_rn(acc[r][i], GM == kBlock ? __fmul_rn(part[i], s[i]) : part[i]);
        }
    }
}

// The walk of every round, then the merge.
template <int WB, int NC, int GM, typename TA, bool EXACT>
__device__ __forceinline__ void dq_run(const DenseArgs& a, DenseTile& t, unsigned char* smem,
                                       float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / WB;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(smem);
    const float* st = reinterpret_cast<const float*>(smem + a.s_off);
    const float* cb = reinterpret_cast<const float*>(smem + a.t_off);
    for (int round = 0;;) {
        const int nwords = (t.hi - t.lo + CPW - 1) / CPW;
        for (int w = warp; w < nwords; w += kLanes) {
            uint32_t wd[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) wd[i] = wt[(lane + 32 * i) * a.w_pitch + w];
            const int k0 = t.lo + w * CPW;
            if (k0 + CPW <= t.hi)
                dq_word<WB, NC, GM, TA, EXACT, true>(a, t, k0, wd, cb, st, smem + a.a_off, acc);
            else
                dq_word<WB, NC, GM, TA, EXACT, false>(a, t, k0, wd, cb, st, smem + a.a_off, acc);
        }
        if (++round == a.rounds) break;
        __syncthreads();                      // the next round rewrites the tiles
        dense_stage<WB, Acts<TA>::BITS, GM != kChannel>(a, t, round, smem, [] {});
    }
}

// One block's tile: row tile ``row_tile`` of a's operands (the kernels'
// bodies: a.MT rows x 32 NC columns x its windows).
template <int WB, int NC, bool GROUPED, typename TA>
__device__ __forceinline__ void dequant_tile(const DenseArgs& a, int row_tile) {
    constexpr int NT = 32 * NC;
    constexpr int NCB = 1 << WB;
    extern __shared__ __align__(16) unsigned char smem[];
    if (a.C > 1) dense_arrive();
    DenseTile t(a, NT, row_tile);
    // the codebook (kCb floats), then the tile's per-channel scales
    float* cb = reinterpret_cast<float*>(smem + a.t_off);
    float* esc = cb + kCb;
    dense_stage<WB, Acts<TA>::BITS, GROUPED>(a, t, 0, smem, [&] {
        if (threadIdx.x < NCB) dense_cp4(cb + threadIdx.x, a.table + threadIdx.x);
        if (!GROUPED && threadIdx.x < t.cols)
            dense_cp4(esc + threadIdx.x, a.scales + t.n0 + threadIdx.x);
    });
    if constexpr (WB == 2) {                  // after the codebook: its 16 level pairs
        float2* cb2 = reinterpret_cast<float2*>(esc + NT);
        if (threadIdx.x < 16) cb2[threadIdx.x] = make_float2(cb[threadIdx.x & 3], cb[threadIdx.x >> 2]);
        __syncthreads();
    }
    float acc[kMaxMt][NC];
#pragma unroll
    for (int r = 0; r < kMaxMt; ++r)
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
    // bf16 rows against integer levels of at most 16 bits: every product is
    // exact (not where a group scale folds into the levels)
    bool exact = sizeof(TA) == 2 && (!GROUPED || a.G % 8 == 0);
#pragma unroll
    for (int i = 0; i < NCB; ++i)
        exact = exact && cb[i] == rintf(cb[i]) && fabsf(cb[i]) <= 65536.f;
    if constexpr (!GROUPED) {
        if (exact)
            dq_run<WB, NC, kChannel, TA, true>(a, t, smem, acc);
        else
            dq_run<WB, NC, kChannel, TA, false>(a, t, smem, acc);
    } else if (a.G % 8 == 0) {
        if (exact)
            dq_run<WB, NC, kBlock, TA, true>(a, t, smem, acc);
        else
            dq_run<WB, NC, kBlock, TA, false>(a, t, smem, acc);
    } else {
        dq_run<WB, NC, kFold, TA, false>(a, t, smem, acc);
    }
    dense_merge<NC>(a, t, smem, acc, [&](int m, int n, float v) {
        if constexpr (!GROUPED) v = __fmul_rn(v, esc[n - t.n0]);
        a.out[static_cast<size_t>(m) * a.N + n] = v;
    });
}

// The launch on the kernels of a source: ``Kernels::get<WB, NC, GROUPED,
// TA>()`` is its __global__ instantiation, which takes ``a`` (DenseArgs, or
// the expert kernels' ExpertArgs).
template <class Kernels, int WB, int NC, typename TA, class Args>
cudaError_t dequant_launch_nc(Args& a, int NT, cudaStream_t stream, int* clusters) {
    dim3 grid;
    int smem = 0;
    const int table = kCb + NT + (WB == 2 ? 32 : 0);     // codebook, scales, level pairs
    const cudaError_t err =
        dense_args(a, dense_experts(a), NT, WB, Acts<TA>::BITS, table, 0, grid, smem);
    if (err != cudaSuccess) return err;
    if (a.G > 0)
        return dense_launch(Kernels::template get<WB, NC, true, TA>(), grid, a.C, smem, 0, stream,
                            clusters, a);
    return dense_launch(Kernels::template get<WB, NC, false, TA>(), grid, a.C, smem, 0, stream,
                        clusters, a);
}

template <class Kernels, int WB, typename TA, class Args>
cudaError_t dequant_launch_bits(Args& a, int NT, cudaStream_t stream, int* clusters) {
    if (NT == 64) return dequant_launch_nc<Kernels, WB, 2, TA>(a, NT, stream, clusters);
    return dequant_launch_nc<Kernels, WB, 4, TA>(a, NT, stream, clusters);
}

template <class Kernels, class Args>
cudaError_t dequant_dispatch(Args& a, int bits, int a_bf16, int NT, cudaStream_t stream,
                             int* clusters) {
    if (bits == 2)
        return a_bf16 ? dequant_launch_bits<Kernels, 2, __nv_bfloat16>(a, NT, stream, clusters)
                      : dequant_launch_bits<Kernels, 2, float>(a, NT, stream, clusters);
    if (bits == 4)
        return a_bf16 ? dequant_launch_bits<Kernels, 4, __nv_bfloat16>(a, NT, stream, clusters)
                      : dequant_launch_bits<Kernels, 4, float>(a, NT, stream, clusters);
    return cudaErrorInvalidValue;
}
