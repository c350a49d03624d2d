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
// Rounding (dense_dequant.cuh), replayed by the plain version
// (ref.py::tile_order_matmul): 8-code block sums, the k-lanes' sums in a
// pairwise tree, the ranks' partials in rank order, each product and sum
// rounded on its own except where every product is exact in f32 (bf16 rows
// against integer levels), where a fused multiply-add gives the same bits.
// No tensor cores: an mma's internal accumulation could not be replayed.

#include "dense_dequant.cuh"

namespace {

template <int WB, int NC, bool GROUPED, typename TA>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
dequant_matmul_kernel(DenseArgs a) {
    dequant_tile<WB, NC, GROUPED, TA>(a, blockIdx.z);
}

struct DequantMatmulKernels {
    template <int WB, int NC, bool GROUPED, typename TA>
    static auto get() { return &dequant_matmul_kernel<WB, NC, GROUPED, TA>; }
};

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
    DenseArgs d = dense_make_args(a, w, codebook, scales, out, M, N, K, group_size, MT, C,
                                  k_per_rank);
    return static_cast<int>(dequant_dispatch<DequantMatmulKernels>(
        d, bits, a_bf16, NT, static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of that launch (bf16 activations): the
// clusters the card holds at once; a negative cudaError_t on failure.
extern "C" int dequant_matmul_active_clusters(int M, int N, int K, int bits, int group_size,
                                              int MT, int NT, int C, int k_per_rank) {
    DenseArgs d = dense_make_args(nullptr, nullptr, nullptr, nullptr, nullptr, M, N, K,
                                  group_size, MT, C, k_per_rank);
    int n = 0;
    const cudaError_t err = dequant_dispatch<DequantMatmulKernels>(d, bits, 1, NT, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
