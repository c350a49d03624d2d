// Two-step bit-sliced LUT GEMM (T-MAC decomposition) for sm_90a: the
// activations arrive already quantized to int8 codes.
//
//   out[m, n] = sum_k (idx[n, k] - 2^(b-1)) * a_codes[m, k]     (exact int32, f32 out)
//   grouped:    out[m, n] = sum_g f32(partial_g[m, n]) * w_scales[n, g]
//               with partial_g the exact integer sum over scale group g,
//               each product and each sum rounded on its own, g ascending
//
// Replaces src/repro/kernels/lut_gemm_bitsliced.py::lut_gemm_bitsliced_pallas
// (pallas_call at :227, bodies _bs_kernel / _bs_grouped_kernel at :50-140).
// The serve path reaches it only through row-parallel leaves under tensor
// parallelism: each rank runs it on its K slice of the codes and the planes,
// and one all-reduce sums the ranks' partials (exact per channel: they are
// integers below 2^24).
//
// What bounds it on the H100: the bytes of the planes, b * N * K/4 (0.72 MB
// at w2, 2816 x 1024; the tp=2 slices are half that), about 0.2 us at
// 3.35 TB/s. At the serving shapes (M <= 32) the limit is latency: the
// launch, one DRAM round trip, one table build and the merge's cluster
// barrier on a block's critical path. The design is the fused kernel's
// (lut_gemm_bs_fused.cu) without its prologue, on the same integer core
// (bs_common.cuh):
//   - a block owns MT rows x NT columns x one K window; the C windows of a
//     column tile form a cluster (kernels/lut_gemm_bitsliced.py::
//     bs_partition), one round of C windows per channel, several rounds
//     for small scale groups over a long K; the first plane loads (16
//     bytes a plane a thread) and every code of the window's first table
//     chunk are issued at once, at the block's start;
//   - each rank builds its rows' 16-entry tables from the codes once for
//     all NT columns, chunk by chunk, and sums the lookups of MT rows in
//     packed 16-bit lanes, widened into int32 every 16 groups;
//   - per channel: the ranks' int32 sums meet in the owner rank's shared
//     memory (exact in any order) and are converted once;
//   - grouped: windows hold whole scale groups; the rank that owns a group
//     turns its exact int32 partial into f32(partial) * scale (__fmul_rn,
//     the scales copied in with cp.async at the window's start), and the
//     owner of the output adds those terms, round by round, in ascending
//     group order over all ranks (__fadd_rn, no FMA): the order
//     ref.py::ref_lut_gemm_bitsliced
//     sums them in, so grouped outputs are bit-identical to the plain
//     version too, and phase 13's tp=2 checks hold bit for bit.
// Later work: as for the fused kernel (a denser plane layout, int8 mma at
// M >= 32).

#include "bs_common.cuh"

namespace {

// The rows' codes, read as they are.
struct CodeRows {
    const int8_t* q8;
    int K;
    struct Raw {
        int8_t v[kGroup];
    };
    __device__ void load(int m, int kg, Raw& raw) const {
        const int8_t* pc = q8 + static_cast<size_t>(m) * K + static_cast<size_t>(kg) * kGroup;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) raw.v[i] = pc[i];
    }
    __device__ void codes(const Raw& raw, int, int (&q)[kGroup]) const {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) q[i] = raw.v[i];
    }
};

template <int BITS, int MT, bool GROUPED>
__global__ void __launch_bounds__(kBsThreads, kBsMinBlocks)
bs_two_step_kernel(const __grid_constant__ BsArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    BsCore<BITS, MT, GROUPED> core(a, smem);
    const CodeRows src{static_cast<const int8_t*>(a.x), a.K};
    core.start(true);
    CodeRows::Raw raw[BsCore<BITS, MT, GROUPED>::ITEMS];
    core.fetch(src, core.lo, raw);
    float* out = a.out;
    const int N = a.N;
    core.run(
        src, raw, false,
        [&](int, int m, int n, int acc) {
            out[static_cast<size_t>(m) * N + n] = __int2float_rn(acc);
        },
        [&](int, int m, int n, float acc) { out[static_cast<size_t>(m) * N + n] = acc; });
}

template <int BITS, int MT>
cudaError_t run_mt(const BsArgs& a, dim3 grid, int smem, cudaStream_t stream, int* clusters) {
    if (a.gpg > 0)
        return launch_cluster(bs_two_step_kernel<BITS, MT, true>, grid, kBsThreads, a.C, smem,
                              stream, clusters, a);
    return launch_cluster(bs_two_step_kernel<BITS, MT, false>, grid, kBsThreads, a.C, smem,
                          stream, clusters, a);
}

template <int BITS>
cudaError_t run_bits(const BsArgs& a, int MT, dim3 grid, int smem, cudaStream_t stream,
                     int* clusters) {
    if (MT == 1) return run_mt<BITS, 1>(a, grid, smem, stream, clusters);
    if (MT == 4) return run_mt<BITS, 4>(a, grid, smem, stream, clusters);
    return run_mt<BITS, 8>(a, grid, smem, stream, clusters);
}

// Launch, or with ``clusters`` set report the active clusters instead.
cudaError_t run(const void* codes, const void* planes, const void* scales, void* out, int M,
                int N, int K, int bits, int group_size, int MT, int NT, int C, int k_per_rank,
                cudaStream_t stream, int* clusters) {
    if (bits != 2 && bits != 4) return cudaErrorInvalidValue;
    BsArgs a{};
    a.x = codes;
    a.planes = static_cast<const uint8_t*>(planes);
    a.scales = static_cast<const float*>(scales);
    a.out = static_cast<float*>(out);
    a.M = M;
    a.N = N;
    a.K = K;
    dim3 grid;
    int smem = 0;
    const cudaError_t err = bs_args(a, MT, NT, C, k_per_rank, group_size, grid, smem);
    if (err != cudaSuccess) return err;
    if (bits == 2) return run_bits<2>(a, MT, grid, smem, stream, clusters);
    return run_bits<4>(a, MT, grid, smem, stream, clusters);
}

}  // namespace

// C entry point (bound with ctypes). codes: (M, K) int8, planes:
// (bits, N, K/4) u8, scales: (N, K/G) f32 when group_size > 0 (else
// unused, may be null), out: (M, N) f32. MT, NT, C and k_per_rank: the
// tiling of bs_partition. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int lut_gemm_bitsliced_launch(const void* codes, const void* planes,
                                         const void* scales, void* out, int M, int N,
                                         int K, int bits, int group_size, int MT, int NT,
                                         int C, int k_per_rank, void* stream) {
    return static_cast<int>(run(codes, planes, scales, out, M, N, K, bits, group_size, MT, NT,
                                C, k_per_rank, static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the launch with this tiling: the
// clusters the card holds at once (>= 0), or minus the cudaError_t.
extern "C" int lut_gemm_bitsliced_active_clusters(int M, int N, int K, int bits,
                                                  int group_size, int MT, int NT, int C,
                                                  int k_per_rank) {
    int n = 0;
    const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, M, N, K, bits, group_size,
                                MT, NT, C, k_per_rank, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
