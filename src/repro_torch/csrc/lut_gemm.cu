// Product-LUT GEMM (paper §3.2 LUT-16) for sm_90a.
//
//   out[m, n] = sum_k LUT[(w[n, k] << a_bits) | a[m, k]]               (f32)
//   grouped:  out[m, n] = sum_g s[n, g] * sum_{k in g} LUT[...]
//
// Replaces src/repro/kernels/lut_gemm.py::lut_gemm_pallas (pallas_call at
// :233). There the K grid axis carried the sum across sequential grid steps
// in one VMEM accumulator tile; here the C windows of a column tile run as
// the ranks of one thread-block cluster and their partials merge on chip.
//
// What bounds it on the H100: at the decode shapes (M <= 4, K x N up to
// 2816 x 1024 / 1024 x 2816) the packed weights are ~0.7 MB, well under a
// microsecond of HBM, so latency bounds it (launch, DRAM round trips, the
// cluster barrier); at the fixed loop's prefill (M 128) the shared-memory
// table reads (M K N of them, half that at w2a2) do. The design
// (dense_common.cuh): a block owns MT <= 8 rows, NT = 64 or 128 columns and
// one K window; every load of the window is issued before the first lookup;
// the activation codes are staged once in shared memory for all columns;
// each unpacked weight unit serves the MT rows, each activation unit the
// thread's NC columns.
//
// The table sits in shared memory transposed, entry (a << w_bits) | w, so
// the 32 lanes of a warp (32 columns, one activation unit) read 2^w_bits
// consecutive words: no bank conflicts for any of the four widths. At w2a2
// a unit is a pair of neighbouring codes: the block builds the 256 sums
// LUT[w0, a0] + LUT[w1, a1] from the 16-entry table and reads once a pair,
// which halves the table reads (the w4a4 walk, on K / 2 units).
//
// With the port's integer product tables every partial sum is an exact
// integer in f32, so the result is bit-identical to the plain version in
// any order. Any f32 table is taken; a float table's sums round in this
// walk's order. Grouped, the scale multiplies each group's partial of 8
// units (one fused multiply-add), or each unit's entry where the group is
// not a multiple of 8 units. No tensor cores.

#include "dense_common.cuh"

namespace {

// Group modes: none, one scale per 8 units, one scale per unit.
constexpr int kNone = 0, kBlock = 1, kUnit = 2;

// The lookups of one weight word (CPW units from k0) for every row and
// column of the thread. FULL: the whole word lies below hi.
template <int UW, int UA, int NC, int GM, bool FULL>
__device__ __forceinline__ void lut_word(const DenseArgs& a, const DenseTile& t, int k0,
                                         const uint32_t (&wd)[NC], const float* tab,
                                         const float* st, const unsigned char* at,
                                         float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / UW;
    constexpr int AW = CPW * UA / 32;         // activation words a row
    constexpr unsigned WM = (1u << UW) - 1u, AM = (1u << UA) - 1u;
    const int lane = threadIdx.x % 32;
    float s[CPW / 8][NC];
    if constexpr (GM == kBlock) {
#pragma unroll
        for (int b = 0; b < CPW / 8; ++b) {
            const int g = t.group(min(k0 + 8 * b, a.K - 1)) - t.g_lo;
#pragma unroll
            for (int i = 0; i < NC; ++i) s[b][i] = st[(lane + 32 * i) * a.s_pitch + g];
        }
    }
    const unsigned char* arow = at + (k0 - t.lo) * UA / 8;
#pragma unroll
    for (int r = 0; r < kMaxMt; ++r) {
        if (r >= t.rows) break;
        uint32_t aw[AW];
        if constexpr (AW == 1) {
            aw[0] = *reinterpret_cast<const uint32_t*>(arow + r * a.a_pitch);
        } else if constexpr (AW == 2) {
            const uint2 v = *reinterpret_cast<const uint2*>(arow + r * a.a_pitch);
            aw[0] = v.x;
            aw[1] = v.y;
        } else {
            static_assert(AW == 4, "4, 8 or 16 activation bytes a word");
            const uint4 v = *reinterpret_cast<const uint4*>(arow + r * a.a_pitch);
            aw[0] = v.x;
            aw[1] = v.y;
            aw[2] = v.z;
            aw[3] = v.w;
        }
#pragma unroll
        for (int b = 0; b < CPW / 8; ++b) {
            float part[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) part[i] = 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int u = 8 * b + q;
                if (!FULL && k0 + u >= t.hi) break;
                const unsigned au = ((aw[(UA * u) / 32] >> ((UA * u) % 32)) & AM) << UW;
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    const float v = tab[au | ((wd[i] >> (UW * u)) & WM)];
                    if constexpr (GM == kNone) {
                        acc[r][i] += v;
                    } else if constexpr (GM == kBlock) {
                        part[i] += v;
                    } else {
                        const int g = t.group(k0 + u) - t.g_lo;
                        acc[r][i] = __fmaf_rn(st[(lane + 32 * i) * a.s_pitch + g], v, acc[r][i]);
                    }
                }
            }
            if constexpr (GM == kBlock) {
#pragma unroll
                for (int i = 0; i < NC; ++i) acc[r][i] = __fmaf_rn(s[b][i], part[i], acc[r][i]);
            }
        }
    }
}

template <int UW, int UA, int NC, int GM>
__device__ __forceinline__ void lut_walk(const DenseArgs& a, DenseTile& t, unsigned char* smem,
                                         float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / UW;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(smem);
    const float* st = reinterpret_cast<const float*>(smem + a.s_off);
    const float* tab = reinterpret_cast<const float*>(smem + a.t_off);
    for (int round = 0;;) {
        const int nwords = (t.hi - t.lo + CPW - 1) / CPW;
        for (int w = warp; w < nwords; w += kLanes) {
            uint32_t wd[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) wd[i] = wt[(lane + 32 * i) * a.w_pitch + w];
            const int k0 = t.lo + w * CPW;
            if (k0 + CPW <= t.hi)
                lut_word<UW, UA, NC, GM, true>(a, t, k0, wd, tab, st, smem + a.a_off, acc);
            else
                lut_word<UW, UA, NC, GM, false>(a, t, k0, wd, tab, st, smem + a.a_off, acc);
        }
        if (++round == a.rounds) break;
        __syncthreads();                      // the next round rewrites the tiles
        dense_stage<UW, UA, GM != kNone>(a, t, round, smem, [] {});
    }
}

// UW / UA: bits of a weight / activation unit; ``pair``: the units are code
// pairs of w2a2 and the table is built from the 16-entry product LUT.
template <int UW, int UA, int NC, bool GROUPED>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
lut_gemm_kernel(DenseArgs a, int pair) {
    constexpr int NT = 32 * NC;
    constexpr int NTAB = 1 << (UW + UA);
    extern __shared__ __align__(16) unsigned char smem[];
    if (a.C > 1) dense_arrive();
    DenseTile t(a, NT);
    float* tab = reinterpret_cast<float*>(smem + a.t_off);
    dense_stage<UW, UA, GROUPED>(a, t, 0, smem, [&] {
        if (pair) {                           // (a0 | a1 << 2) << 4 | (w0 | w1 << 2)
            const int i = threadIdx.x;        // NTAB == kDenseThreads
            const int ap = i >> 4, wp = i & 15;
            const float v0 = __ldg(a.table + (((wp & 3) << 2) | (ap & 3)));
            const float v1 = __ldg(a.table + (((wp >> 2) << 2) | (ap >> 2)));
            tab[i] = v0 + v1;
        } else if (reinterpret_cast<uintptr_t>(a.table) % 16 == 0) {
            // 16 bytes a load (entries (w, a..a+3)), stored transposed;
            // neighbouring threads take neighbouring w, so the stores of a
            // warp fall on distinct banks
            for (int i = threadIdx.x; i < NTAB / 4; i += kDenseThreads) {
                const int w = i & ((1 << UW) - 1), au = (i >> UW) * 4;
                const uint4 v =
                    __ldg(reinterpret_cast<const uint4*>(a.table + (w << UA) + au));
                tab[(au << UW) | w] = __uint_as_float(v.x);
                tab[((au + 1) << UW) | w] = __uint_as_float(v.y);
                tab[((au + 2) << UW) | w] = __uint_as_float(v.z);
                tab[((au + 3) << UW) | w] = __uint_as_float(v.w);
            }
        } else {
            for (int i = threadIdx.x; i < NTAB; i += kDenseThreads) {
                const int w = i >> UA, au = i & ((1 << UA) - 1);
                dense_cp4(tab + ((au << UW) | w), a.table + i);
            }
        }
    });
    float acc[kMaxMt][NC];
#pragma unroll
    for (int r = 0; r < kMaxMt; ++r)
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
    if (!GROUPED)
        lut_walk<UW, UA, NC, kNone>(a, t, smem, acc);
    else if (a.G % 8 == 0)
        lut_walk<UW, UA, NC, kBlock>(a, t, smem, acc);
    else
        lut_walk<UW, UA, NC, kUnit>(a, t, smem, acc);
    dense_merge<NC>(a, t, smem, acc, [&](int m, int n, float v) {
        a.out[static_cast<size_t>(m) * a.N + n] = v;
    });
}

template <int UW, int UA, int NC>
cudaError_t launch_nc(DenseArgs& a, int NT, int pair, cudaStream_t stream, int* clusters) {
    dim3 grid;
    int smem = 0;
    const cudaError_t err = dense_args(a, NT, UW, UA, 1 << (UW + UA), grid, smem);
    if (err != cudaSuccess) return err;
    if (a.G > 0)
        return dense_launch(lut_gemm_kernel<UW, UA, NC, true>, grid, a.C, smem, stream,
                            clusters, a, pair);
    return dense_launch(lut_gemm_kernel<UW, UA, NC, false>, grid, a.C, smem, stream, clusters,
                        a, pair);
}

template <int UW, int UA>
cudaError_t launch_units(DenseArgs& a, int NT, int pair, cudaStream_t stream, int* clusters) {
    if (NT == 64) return launch_nc<UW, UA, 2>(a, NT, pair, stream, clusters);
    return launch_nc<UW, UA, 4>(a, NT, pair, stream, clusters);
}

// K, group_size and k_per_rank arrive in codes; w2a2 walks code pairs.
cudaError_t dispatch(DenseArgs& a, int w_bits, int a_bits, cudaStream_t stream, int NT,
                     int* clusters) {
    const int key = w_bits * 16 + a_bits;
    if (key == 2 * 16 + 2) {
        if (a.K % 2 || a.G % 2 || a.kpr % 2) return cudaErrorInvalidValue;
        a.K /= 2;
        a.G /= 2;
        a.kpr /= 2;
        return launch_units<4, 4>(a, NT, 1, stream, clusters);
    }
    if (key == 4 * 16 + 4) return launch_units<4, 4>(a, NT, 0, stream, clusters);
    if (key == 2 * 16 + 8) return launch_units<2, 8>(a, NT, 0, stream, clusters);
    if (key == 4 * 16 + 8) return launch_units<4, 8>(a, NT, 0, stream, clusters);
    return cudaErrorInvalidValue;
}

DenseArgs make_args(const void* a, const void* w, const void* lut, const void* scales,
                    void* out, int M, int N, int K, int group_size, int MT, int C,
                    int k_per_rank) {
    DenseArgs d{};
    d.a = a;
    d.w = static_cast<const uint8_t*>(w);
    d.table = static_cast<const float*>(lut);
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

// C entry point (bound with ctypes). a: (M, K/fa) u8, w: (N, K/fw) u8,
// lut: (2^(w_bits+a_bits),) f32, scales: (N, K/G) f32 or null, out: (M, N)
// f32; the tiling (MT rows, NT columns, C ranks of k_per_rank codes a
// window) from kernels/lut_gemm.py::dense_partition. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lut_gemm_launch(const void* a, const void* w, const void* lut, const void* scales,
                               void* out, int M, int N, int K, int w_bits, int a_bits,
                               int group_size, int MT, int NT, int C, int k_per_rank,
                               void* stream) {
    DenseArgs d = make_args(a, w, lut, scales, out, M, N, K, scales ? group_size : 0, MT, C,
                            k_per_rank);
    return static_cast<int>(
        dispatch(d, w_bits, a_bits, static_cast<cudaStream_t>(stream), NT, nullptr));
}

// cudaOccupancyMaxActiveClusters of that launch: the clusters the card
// holds at once; a negative cudaError_t on failure.
extern "C" int lut_gemm_active_clusters(int M, int N, int K, int w_bits, int a_bits,
                                        int group_size, int MT, int NT, int C, int k_per_rank) {
    DenseArgs d = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, M, N, K, group_size,
                            MT, C, k_per_rank);
    int n = 0;
    const cudaError_t err = dispatch(d, w_bits, a_bits, nullptr, NT, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
