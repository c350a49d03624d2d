// Fused-prologue bit-sliced LUT GEMM (T-MAC decomposition) for sm_90a.
//
//   a_scale[m] = max(amax_k |x[m, k]| / 2^(a_bits-1), 1e-8)  in x's dtype,
//                or the given f32 a_sc ((1, 1) or (M, 1))
//   q[m, k]    = clamp(rint(x[m, k] / a_scale[m]), -2^(a_bits-1), 2^(a_bits-1)-1)
//   acc[m, n]  = sum_k w[n, k] * q[m, k]        (exact int32; w = idx - 2^(b-1))
//   out[m, n]  = (acc * w_scales[n]) * a_scale[m]                        (f32)
//   grouped:     (sum_g f32(acc_g[m, n]) * w_scales[n, g]) * a_scale[m],
//                groups summed in ascending order
//
// Replaces src/repro/kernels/lut_gemm_bitsliced.py::lut_gemm_bs_fused_pallas
// (pallas_call at :368, body _bs_fused_kernel at :258-289). The Pallas body
// holds whole K rows because the dynamic amax reduces over them; here the
// K slices of a column tile form a thread-block cluster that reduces the
// amax together.
//
// What bounds it on the H100: the bytes of the planes, b * N * K/4 (a
// pattern byte carries 4 bits, so twice the natural packing): 1.44 MB at
// w2, 1024 x 2816, under half a microsecond at 3.35 TB/s; 27.5 MB at
// codeqwen1.5-7b's 4096 x 13440, 8.2 us. Neither is what limits it. At the
// serving shapes (M <= 32) the limit is latency: the launch, one DRAM
// round trip, the amax exchange, one table build and the merge's cluster
// barrier on a block's critical path. At codeqwen's shapes it is the SM's
// load/store path: one 8-byte table read per (4 rows, plane, group,
// column) and one 16-byte plane load per (plane, segment, column) from
// 32 rows a warp. The design (the integer core is bs_common.cuh, shared
// with lut_gemm_bitsliced.cu):
//   - a block owns MT rows x NT columns x one K window; the C windows of a
//     column tile form a cluster (kernels/lut_gemm_bitsliced.py::
//     bs_partition picks MT, NT, C and the window so that every cluster is
//     resident at once); per channel one round of C windows covers K,
//     while small scale groups over a long K take several rounds, so the
//     grouped partials stay within a block's shared memory at any K;
//   - the block issues its first plane loads (16 bytes a plane a thread)
//     and the loads of every x value of its slice's first table chunk at
//     once, before anything else, so they are in flight together;
//   - prologue: each rank reduces |x| over its own windows of each row (the
//     first chunk from those registers); the ranks read each other's maxima through
//     distributed shared memory after one cluster barrier (a maximum is
//     exact in any order) and round the scale to x's dtype as the plain
//     version does. A static a_sc skips this. No block reads a whole row:
//     x is read once per column tile;
//   - each rank quantizes only its windows (IEEE division, rounded to x's
//     dtype when the scale is dynamic, rint half to even) and builds its
//     16-entry tables once for all NT columns, chunk by chunk;
//   - lookups: one shared-memory word serves MT rows, summed 16 groups at a
//     time in packed 16-bit lanes, widened into int32;
//   - merge (bs_common.cuh): the ranks' exact int32 sums meet in the owner
//     rank's shared memory, then the epilogue runs in the plain version's
//     order, so per-channel outputs are bit-identical to it; grouped terms
//     are added round by round in ascending group order over the ranks, as
//     the plain version adds them, so grouped outputs are bit-identical too.
// Later work: a denser plane layout (two patterns a byte: half the plane
// bytes, a new leaf), decoding the planes for int8 mma at M >= 32 where
// the lookups dominate, and paired-plane 256-entry tables (16x the table
// stores of the 16-entry table for half the lookups at w2; not built or
// measured).
//
// Build without --use_fast_math: '/' must stay IEEE for the codes to match.

#include <cuda_bf16.h>

#include "bs_common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round an f32 value to x's dtype, back in f32.
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The rows' raw activations, quantized with the scales in s_scale (tile
// row r) as the plain version quantizes them.
template <typename TX>
struct QuantRows {
    const TX* x;
    int K;
    const float* s_scale;
    bool dynamic;
    float qmin, qmax;
    struct Raw {
        TX v[kGroup];
    };
    __device__ void load(int m, int kg, Raw& raw) const {
        const TX* px = x + static_cast<size_t>(m) * K + static_cast<size_t>(kg) * kGroup;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) raw.v[i] = px[i];
    }
    __device__ void codes(const Raw& raw, int r, int (&q)[kGroup]) const {
        const float s = s_scale[r];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
            float v = to_f32(raw.v[i]) / s;
            if (dynamic) v = round_to(v, TX{});
            q[i] = static_cast<int>(fminf(fmaxf(rintf(v), qmin), qmax));
        }
    }
};

template <int BITS, int MT, bool GROUPED, typename TX>
__global__ void __launch_bounds__(kBsThreads, kBsMinBlocks)
bs_fused_kernel(const __grid_constant__ BsArgs a) {
    using Core = BsCore<BITS, MT, GROUPED>;
    extern __shared__ __align__(16) unsigned char smem[];
    Core core(a, smem);
    unsigned* s_amax = reinterpret_cast<unsigned*>(smem + a.scale_off);
    float* s_scale = reinterpret_cast<float*>(s_amax + MT);
    const bool dynamic = a.a_sc_rows == 0;
    const QuantRows<TX> src{static_cast<const TX*>(a.x), a.K, s_scale, dynamic,
                            -static_cast<float>(1 << (a.a_bits - 1)),
                            static_cast<float>((1 << (a.a_bits - 1)) - 1)};

    if (threadIdx.x < MT) s_amax[threadIdx.x] = 0u;
    core.start(!dynamic);
    typename QuantRows<TX>::Raw raw[Core::ITEMS];
    core.fetch(src, core.lo, raw);            // every x value of the first chunk at once
    __syncthreads();

    // Prologue: each row's activation scale.
    if (dynamic) {
        // this rank's max |x| of the thread's row (r = threadIdx.x % MT for
        // every item), from the fetched items and the rest of its windows
        const int r = threadIdx.x % MT, m = core.m0 + r;
        float amax = 0.f;
#pragma unroll
        for (int u = 0; u < Core::ITEMS; ++u)
#pragma unroll
            for (int i = 0; i < kGroup; ++i) amax = fmaxf(amax, fabsf(to_f32(raw[u].v[i])));
        if (m < a.M) {
            const TX* row = src.x + static_cast<size_t>(m) * a.K;
            for (int t = 0; t < a.rounds; ++t) {
                int wlo, whi;
                core.window(t, wlo, whi);
                if (t == 0) wlo = min(whi, wlo + Core::KCH);   // past the fetched chunk
                for (int k = wlo * kGroup + threadIdx.x / MT; k < whi * kGroup;
                     k += kBsThreads / MT)
                    amax = fmaxf(amax, fabsf(to_f32(row[k])));
            }
        }
#pragma unroll
        for (int o = 16; o >= MT; o >>= 1)     // lanes of one row
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        // >= 0: its bits order as unsigned ints
        if (threadIdx.x % 32 < MT && amax > 0.f) atomicMax(s_amax + r, __float_as_uint(amax));
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();                       // every rank's maxima are written
        if (threadIdx.x < MT) {
            unsigned v[kMaxBsCluster];
#pragma unroll
            for (int k = 0; k < kMaxBsCluster; ++k)
                v[k] = k < a.C ? cluster.map_shared_rank(s_amax, k)[threadIdx.x] : 0u;
            float amax_c = 0.f;
#pragma unroll
            for (int k = 0; k < kMaxBsCluster; ++k) amax_c = fmaxf(amax_c, __uint_as_float(v[k]));
            const float s = round_to(amax_c / -src.qmin, TX{});
            s_scale[threadIdx.x] = fmaxf(s, round_to(1e-8f, TX{}));
        }
    } else if (threadIdx.x < MT) {
        const int m = core.m0 + threadIdx.x;
        s_scale[threadIdx.x] = m < a.M ? a.a_sc[a.a_sc_rows == 1 ? 0 : m] : 1.f;
    }
    __syncthreads();

    float* out = a.out;
    const float* scales = a.scales;
    const int N = a.N;
    core.run(
        src, raw, dynamic,
        [&](int r, int m, int n, int acc) {
            const float v = static_cast<float>(acc) * scales[n];
            out[static_cast<size_t>(m) * N + n] = v * s_scale[r];
        },
        [&](int r, int m, int n, float acc) {
            out[static_cast<size_t>(m) * N + n] = acc * s_scale[r];
        });
}

template <int BITS, int MT, typename TX>
cudaError_t run_mt(const BsArgs& a, dim3 grid, int smem, cudaStream_t stream, int* clusters) {
    if (a.gpg > 0)
        return launch_cluster(bs_fused_kernel<BITS, MT, true, TX>, grid, kBsThreads, a.C, smem,
                              stream, clusters, a);
    return launch_cluster(bs_fused_kernel<BITS, MT, false, TX>, grid, kBsThreads, a.C, smem,
                          stream, clusters, a);
}

template <int BITS, typename TX>
cudaError_t run_bits(const BsArgs& a, int MT, dim3 grid, int smem, cudaStream_t stream,
                     int* clusters) {
    if (MT == 1) return run_mt<BITS, 1, TX>(a, grid, smem, stream, clusters);
    if (MT == 4) return run_mt<BITS, 4, TX>(a, grid, smem, stream, clusters);
    return run_mt<BITS, 8, TX>(a, grid, smem, stream, clusters);
}

// Launch, or with ``clusters`` set report the active clusters instead.
cudaError_t run(const void* x, const void* planes, const void* scales, const void* a_sc,
                void* out, int M, int N, int K, int bits, int a_bits, int group_size,
                int x_bf16, int a_sc_rows, int MT, int NT, int C, int k_per_rank,
                cudaStream_t stream, int* clusters) {
    if (a_bits < 2 || a_bits > 8 || (bits != 2 && bits != 4) ||
        (a_sc_rows != 0 && a_sc_rows != 1 && a_sc_rows != M))
        return cudaErrorInvalidValue;
    BsArgs a{};
    a.x = x;
    a.planes = static_cast<const uint8_t*>(planes);
    a.scales = static_cast<const float*>(scales);
    a.a_sc = static_cast<const float*>(a_sc);
    a.out = static_cast<float*>(out);
    a.M = M;
    a.N = N;
    a.K = K;
    a.a_bits = a_bits;
    a.a_sc_rows = a_sc_rows;
    dim3 grid;
    int smem = 0;
    const cudaError_t err = bs_args(a, MT, NT, C, k_per_rank, group_size, grid, smem);
    if (err != cudaSuccess) return err;
    if (bits == 2)
        return x_bf16 ? run_bits<2, __nv_bfloat16>(a, MT, grid, smem, stream, clusters)
                      : run_bits<2, float>(a, MT, grid, smem, stream, clusters);
    return x_bf16 ? run_bits<4, __nv_bfloat16>(a, MT, grid, smem, stream, clusters)
                  : run_bits<4, float>(a, MT, grid, smem, stream, clusters);
}

}  // namespace

// C entry point (bound with ctypes). x: (M, K) f32 (x_bf16 == 0) or bf16,
// planes: (bits, N, K/4) u8, scales: (N,) f32, or (N, K/G) f32 when
// group_size > 0, a_sc: f32 with a_sc_rows entries (0: none, dynamic
// scales; 1: one scale for every row; M: one per row), out: (M, N) f32.
// MT, NT, C and k_per_rank: the tiling of bs_partition. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lut_gemm_bs_fused_launch(const void* x, const void* planes,
                                        const void* scales, const void* a_sc,
                                        void* out, int M, int N, int K, int bits,
                                        int a_bits, int group_size, int x_bf16,
                                        int a_sc_rows, int MT, int NT, int C,
                                        int k_per_rank, void* stream) {
    return static_cast<int>(run(x, planes, scales, a_sc, out, M, N, K, bits, a_bits, group_size,
                                x_bf16, a_sc_rows, MT, NT, C, k_per_rank,
                                static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the launch with this tiling: the
// clusters the card holds at once (>= 0), or minus the cudaError_t.
extern "C" int lut_gemm_bs_fused_active_clusters(int M, int N, int K, int bits, int a_bits,
                                                 int group_size, int x_bf16, int a_sc_rows,
                                                 int MT, int NT, int C, int k_per_rank) {
    int n = 0;
    const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, nullptr, M, N, K, bits,
                                a_bits, group_size, x_bf16, a_sc_rows, MT, NT, C, k_per_rank,
                                nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
