// Per-expert packed-weight GEMMs for sm_90a, the MoE serving hot path:
//
//   expert_dequant_matmul   out[e] = (x[e] @ dequant(w[e]).T) * scales[e]      (f32)
//                           grouped: the (E, N, K/G) scales fold into the
//                           dequantized weight before the contraction
//   expert_lut_gemm         out[e, m, n] = sum_k LUT[(w[e,n,k] << b) | a[e,m,k]]
//                           grouped: sum_g s[e,n,g] * sum_{k in g} LUT[...]
//
// Replace src/repro/kernels/expert_dequant_matmul.py::expert_dequant_matmul_pallas
// (pallas_call at :112) and ::expert_lut_gemm_pallas (pallas_call at :233).
// There the grid walks (E, M-tiles, N-tiles, K-tiles) and the sequential K
// axis carries each sum in one VMEM output tile; here the expert is the
// outer index of grid z on the tiled walk of dense_common.cuh, the same
// walk as dequant_matmul (row 2, dense_dequant.cuh) and lut_gemm (row 1,
// dense_lut.cuh): block (c, j, e * row_tiles + i) is rank c of column tile
// j, row tile i, of expert e, and takes its operands at expert e's offsets.
//
// What bounds them on the H100: at moonshot-v1-16b-a3b's decode shape
// (E 64, M = capacity 4, K x N = 2048 x 1408 or 1408 x 2048, w2) a call
// reads 46.1 MB of packed codes, 13.8 us at 3.35 TB/s; the E M N K = 738 M
// products on the CUDA cores (no tensor cores: the plain version could not
// replay an mma) take longer, and so do the lookups of the LUT kernel (one
// a code pair a row at w2a2, through the 256-entry pair table). The design
// against that: kernels/lut_gemm.py::expert_partition counts the tiles of
// all experts, so a block takes a whole column tile's K in one window where
// the tiles allow (one DRAM round trip, no cluster merge); the activations
// are staged once for all NT columns, each decoded weight serves the MT
// rows, and a warp's table reads hit distinct banks; the dequant walk reads
// 2-bit levels in pairs, and the LUT walk keeps its table at a static
// address and sums 8 units' entries before adding them.
//
// Experts that the dispatch left empty: with ``active`` (E,) given, a block
// of an expert whose flag is 0 writes zeros to its output tile and loads
// nothing (dense_common.cuh::dense_expert). The grid does not depend on the
// flags, so a CUDA graph can capture the launch.
//
// Rounding: the dequant kernel's is dense_dequant.cuh's, which its plain
// version replays with a leading expert axis (ref.py::tile_order_matmul on
// expert_partition's tiling), so the two agree bit for bit; a last-ulp
// difference would flip a router's top-k somewhere in 48 layers and move
// the logits far. The LUT kernel with an integer product table sums exact
// integers, bit-identical to its plain version in any order; grouped, each
// group's partial of 8 units is scaled on its own (1e-5 of the plain
// version's scale).

#include "dense_dequant.cuh"
#include "dense_lut.cuh"

namespace {

template <int WB, int NC, bool GROUPED, typename TA>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
expert_dequant_kernel(ExpertArgs a) {
    const int row_tile = dense_expert(a, 32 * NC);
    if (row_tile >= 0) dequant_tile<WB, NC, GROUPED, TA>(a, row_tile);
}

template <int UW, int UA, int NC, bool GROUPED>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
expert_lut_kernel(ExpertArgs a, int pair) {
    const int row_tile = dense_expert(a, 32 * NC);
    if (row_tile >= 0) lut_tile<UW, UA, NC, GROUPED>(a, pair, row_tile);
}

struct ExpertDequantKernels {
    template <int WB, int NC, bool GROUPED, typename TA>
    static auto get() { return &expert_dequant_kernel<WB, NC, GROUPED, TA>; }
};

struct ExpertLutKernels {
    template <int UW, int UA, int NC, bool GROUPED>
    static auto get() { return &expert_lut_kernel<UW, UA, NC, GROUPED>; }
};

// w_bits == a_bits == bits: w2a2 walks code pairs through the pair table,
// w4a4 single codes; both on 4-bit units.
cudaError_t lut_dispatch(ExpertArgs& a, int bits, int NT, cudaStream_t stream, int* clusters) {
    if (bits == 2) {
        const cudaError_t err = lut_pairs(a);
        if (err != cudaSuccess) return err;
        return lut_launch_units<ExpertLutKernels, 4, 4>(a, NT, 1, stream, clusters);
    }
    if (bits == 4) return lut_launch_units<ExpertLutKernels, 4, 4>(a, NT, 0, stream, clusters);
    return cudaErrorInvalidValue;
}

// The walk's arguments (shapes in codes) with the expert axis: E experts,
// ``active`` (E,) u8 or null, rows of K / group_size scales (1 per channel).
ExpertArgs expert_args(const void* a, const void* w, const void* table, const void* scales,
                       void* out, const void* active, int E, int M, int N, int K,
                       int group_size, int MT, int C, int k_per_rank) {
    ExpertArgs x;
    static_cast<DenseArgs&>(x) = dense_make_args(a, w, table, scales, out, M, N, K, group_size,
                                                 MT, C, k_per_rank);
    x.active = static_cast<const unsigned char*>(active);
    x.E = E;
    x.s_row = group_size > 0 ? K / group_size : 1;
    return x;
}

}  // namespace

// C entry points (bound with ctypes). Each launch returns the cudaError_t
// of the launch (0 on success), each query the clusters (blocks at C 1) the
// card holds at once, or a negative cudaError_t. The tiling (MT rows, NT
// columns, C ranks of k_per_rank codes a window) comes from
// kernels/lut_gemm.py::expert_partition; active: (E,) u8 or null (every
// expert computed).
//
// x: (E, M, K) f32 (x_bf16 == 0) or bf16, w: (E, N, K/f) u8, codebook:
// (2^bits,) f32, scales: (E, N) f32 or (E, N, K/G) f32 when group_size > 0,
// out: (E, M, N) f32.
extern "C" int expert_dequant_matmul_launch(const void* x, const void* w, const void* codebook,
                                            const void* scales, void* out, const void* active,
                                            int E, int M, int N, int K, int bits,
                                            int group_size, int x_bf16, int MT, int NT, int C,
                                            int k_per_rank, void* stream) {
    ExpertArgs d = expert_args(x, w, codebook, scales, out, active, E, M, N, K, group_size, MT,
                               C, k_per_rank);
    return static_cast<int>(dequant_dispatch<ExpertDequantKernels>(
        d, bits, x_bf16, NT, static_cast<cudaStream_t>(stream), nullptr));
}

extern "C" int expert_dequant_matmul_active_clusters(int E, int M, int N, int K, int bits,
                                                     int group_size, int MT, int NT, int C,
                                                     int k_per_rank) {
    ExpertArgs d = expert_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, E, M, N, K,
                               group_size, MT, C, k_per_rank);
    int n = 0;
    const cudaError_t err = dequant_dispatch<ExpertDequantKernels>(d, bits, 1, NT, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// a: (E, M, K/f) u8, w: (E, N, K/f) u8 (w_bits == a_bits == bits), lut:
// (2^(2 bits),) f32, scales: (E, N, K/G) f32 or null, out: (E, M, N) f32.
extern "C" int expert_lut_gemm_launch(const void* a, const void* w, const void* lut,
                                      const void* scales, void* out, const void* active, int E,
                                      int M, int N, int K, int bits, int group_size, int MT,
                                      int NT, int C, int k_per_rank, void* stream) {
    ExpertArgs d = expert_args(a, w, lut, scales, out, active, E, M, N, K,
                               scales ? group_size : 0, MT, C, k_per_rank);
    return static_cast<int>(lut_dispatch(d, bits, NT, static_cast<cudaStream_t>(stream), nullptr));
}

extern "C" int expert_lut_gemm_active_clusters(int E, int M, int N, int K, int bits,
                                               int group_size, int MT, int NT, int C,
                                               int k_per_rank) {
    ExpertArgs d = expert_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, E, M, N, K,
                               group_size, MT, C, k_per_rank);
    int n = 0;
    const cudaError_t err = lut_dispatch(d, bits, NT, nullptr, &n);
    return err == cudaSuccess ? n : -static_cast<int>(err);
}
