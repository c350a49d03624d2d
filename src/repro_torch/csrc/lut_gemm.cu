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
// thread's NC columns. The walk and its table layout: dense_lut.cuh (with
// integer product tables bit-identical to the plain version in any order).
// No tensor cores.

#include "dense_lut.cuh"

namespace {

template <int UW, int UA, int NC, bool GROUPED>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
lut_gemm_kernel(DenseArgs a, int pair) {
    lut_tile<UW, UA, NC, GROUPED>(a, pair, blockIdx.z);
}

struct LutGemmKernels {
    template <int UW, int UA, int NC, bool GROUPED>
    static auto get() { return &lut_gemm_kernel<UW, UA, NC, GROUPED>; }
};

// K, group_size and k_per_rank arrive in codes; w2a2 walks code pairs.
cudaError_t dispatch(DenseArgs& a, int w_bits, int a_bits, cudaStream_t stream, int NT,
                     int* clusters) {
    const int key = w_bits * 16 + a_bits;
    if (key == 2 * 16 + 2) {
        const cudaError_t err = lut_pairs(a);
        if (err != cudaSuccess) return err;
        return lut_launch_units<LutGemmKernels, 4, 4>(a, NT, 1, stream, clusters);
    }
    using K = LutGemmKernels;
    if (key == 4 * 16 + 4) return lut_launch_units<K, 4, 4>(a, NT, 0, stream, clusters);
    if (key == 2 * 16 + 8) return lut_launch_units<K, 2, 8>(a, NT, 0, stream, clusters);
    if (key == 4 * 16 + 8) return lut_launch_units<K, 4, 8>(a, NT, 0, stream, clusters);
    return cudaErrorInvalidValue;
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
    DenseArgs d = dense_make_args(a, w, lut, scales, out, M, N, K, scales ? group_size : 0, MT,
                                  C, k_per_rank);
    return static_cast<int>(
        dispatch(d, w_bits, a_bits, static_cast<cudaStream_t>(stream), NT, nullptr));
}

// cudaOccupancyMaxActiveClusters of that launch: the clusters the card
// holds at once; a negative cudaError_t on failure.
extern "C" int lut_gemm_active_clusters(int M, int N, int K, int w_bits, int a_bits,
                                        int group_size, int MT, int NT, int C, int k_per_rank) {
    DenseArgs d = dense_make_args(nullptr, nullptr, nullptr, nullptr, nullptr, M, N, K,
                                  group_size, MT, C, k_per_rank);
    int n = 0;
    const cudaError_t err = dispatch(d, w_bits, a_bits, nullptr, NT, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
