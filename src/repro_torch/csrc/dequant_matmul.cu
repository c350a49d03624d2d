// Packed-weight dequant matmul for sm_90a:
//
//   out = (a @ dequant(w).T) * scales                                   (f32)
//   dequant(w)[n, k] = codebook[code(n, k)]     (per-channel scales (N,))
//   grouped: dequant(w)[n, k] = codebook[code(n, k)] * s[n, k / G]  (no epilogue)
//
// Replaces src/repro/kernels/lut_dequant_matmul.py::dequant_matmul_pallas
// (pallas_call at :116), where group-wise scales fold into the weight
// before the contraction (:55-71). Here a group scale multiplies the sum of
// each 8 codes of its group (G a multiple of 8), or folds into each level
// (any other G).
//
// What bounds it on the H100: at the decode shapes (M <= 4, K x N up to
// 2816 x 1024 / 1024 x 2816) the packed weights are ~0.7 MB (w2), well under
// a microsecond of HBM, so latency bounds it: the launch, the DRAM round
// trips a block waits on, the cluster barrier. At the fixed loop's prefill
// (M 128) the f32 multiply-adds (M K N of them) bound it. The design
// (dense_common.cuh): a block owns MT <= 8 rows, NT = 64 or 128 columns
// and one K window, the C windows of a column tile merge in one cluster;
// every load of a window is issued before the first product (one DRAM round
// trip); the activations are staged once in shared memory and read by all
// columns; each decoded weight (a codebook read) serves the MT rows, each
// activation the thread's NC columns.
//
// Rounding, replayed by the plain version (ref.py::tile_order_matmul): a
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
// No tensor cores: an mma's internal accumulation could not be replayed.

#include <cuda_bf16.h>

#include "dense_common.cuh"

namespace {

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
// is added into acc. FULL: the whole word lies below hi.
template <int WB, int NC, int GM, typename TA, bool EXACT, bool FULL>
__device__ __forceinline__ void dq_word(const DenseArgs& a, const DenseTile& t, int k0,
                                        const uint32_t (&wd)[NC], const float* cb,
                                        const float* st, const unsigned char* at,
                                        float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / WB;
    constexpr unsigned MASK = (1u << WB) - 1u;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int b = 0; b < CPW / 8; ++b) {
        const int kb = k0 + 8 * b;
        float lv[8][NC];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int i = 0; i < NC; ++i) lv[q][i] = cb[(wd[i] >> (WB * (8 * b + q))) & MASK];
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

template <int WB, int NC, bool GROUPED, typename TA>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
dequant_matmul_kernel(DenseArgs a) {
    constexpr int NT = 32 * NC;
    constexpr int NCB = 1 << WB;
    extern __shared__ __align__(16) unsigned char smem[];
    if (a.C > 1) dense_arrive();
    DenseTile t(a, NT);
    // the codebook (kCb floats), then the tile's per-channel scales
    float* cb = reinterpret_cast<float*>(smem + a.t_off);
    float* esc = cb + kCb;
    dense_stage<WB, Acts<TA>::BITS, GROUPED>(a, t, 0, smem, [&] {
        if (threadIdx.x < NCB) dense_cp4(cb + threadIdx.x, a.table + threadIdx.x);
        if (!GROUPED && threadIdx.x < t.cols)
            dense_cp4(esc + threadIdx.x, a.scales + t.n0 + threadIdx.x);
    });
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

template <int WB, int NC, typename TA>
cudaError_t launch_nc(DenseArgs& a, int NT, cudaStream_t stream, int* clusters) {
    dim3 grid;
    int smem = 0;
    const cudaError_t err = dense_args(a, NT, WB, Acts<TA>::BITS, kCb + NT, grid, smem);
    if (err != cudaSuccess) return err;
    if (a.G > 0)
        return dense_launch(dequant_matmul_kernel<WB, NC, true, TA>, grid, a.C, smem, stream,
                            clusters, a);
    return dense_launch(dequant_matmul_kernel<WB, NC, false, TA>, grid, a.C, smem, stream,
                        clusters, a);
}

template <int WB, typename TA>
cudaError_t launch_bits(DenseArgs& a, int NT, cudaStream_t stream, int* clusters) {
    if (NT == 64) return launch_nc<WB, 2, TA>(a, NT, stream, clusters);
    return launch_nc<WB, 4, TA>(a, NT, stream, clusters);
}

cudaError_t dispatch(DenseArgs& a, int bits, int a_bf16, int NT, cudaStream_t stream,
                     int* clusters) {
    if (bits == 2)
        return a_bf16 ? launch_bits<2, __nv_bfloat16>(a, NT, stream, clusters)
                      : launch_bits<2, float>(a, NT, stream, clusters);
    if (bits == 4)
        return a_bf16 ? launch_bits<4, __nv_bfloat16>(a, NT, stream, clusters)
                      : launch_bits<4, float>(a, NT, stream, clusters);
    return cudaErrorInvalidValue;
}

DenseArgs make_args(const void* a, const void* w, const void* codebook, const void* scales,
                    void* out, int M, int N, int K, int group_size, int MT, int C,
                    int k_per_rank) {
    DenseArgs d{};
    d.a = a;
    d.w = static_cast<const uint8_t*>(w);
    d.table = static_cast<const float*>(codebook);
    d.scales = static_cast<const float*>(scales);
    d.out = static_cast<float*>(out);
    d.M = M;
    d.N = N;
    d.K = K;
    d.G = group_size;
    d.MT = MT;
    d.C = C;
    d.kpr = k_per_rank;
    d.rounds = k_per_rank > 0 && C > 0
                   ? static_cast<int>((static_cast<int64_t>(K) + static_cast<int64_t>(C) *
                                                                     k_per_rank - 1) /
                                      (static_cast<int64_t>(C) * k_per_rank))
                   : 0;
    return d;
}

}  // namespace

// C entry point (bound with ctypes). a: (M, K) f32 (a_bf16 == 0) or bf16,
// w: (N, K/f) u8, codebook: (2^bits,) f32, scales: (N,) f32 or (N, K/G) f32
// when group_size > 0, out: (M, N) f32; the tiling (MT rows, NT columns, C
// ranks of k_per_rank codes a window) from kernels/lut_gemm.py::
// dense_partition. Returns the cudaError_t of the launch (0 on success).
extern "C" int dequant_matmul_launch(const void* a, const void* w, const void* codebook,
                                     const void* scales, void* out, int M, int N, int K,
                                     int bits, int group_size, int a_bf16, int MT, int NT,
                                     int C, int k_per_rank, void* stream) {
    DenseArgs d = make_args(a, w, codebook, scales, out, M, N, K, group_size, MT, C, k_per_rank);
    return static_cast<int>(
        dispatch(d, bits, a_bf16, NT, static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of that launch (bf16 activations): the
// clusters the card holds at once; a negative cudaError_t on failure.
extern "C" int dequant_matmul_active_clusters(int M, int N, int K, int bits, int group_size,
                                              int MT, int NT, int C, int k_per_rank) {
    DenseArgs d = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, M, N, K, group_size,
                            MT, C, k_per_rank);
    int n = 0;
    const cudaError_t err = dispatch(d, bits, 1, NT, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
