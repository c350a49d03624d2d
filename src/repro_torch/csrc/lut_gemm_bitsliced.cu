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
// integers below 2^24). The Pallas body tiles for the TPU's GEMV and matrix
// regimes; here every block owns a few rows and eight columns and nothing
// crosses blocks.
//
// What bounds it on the H100: the bytes of the planes, b * N * K/4 (0.72 MB
// at w2, 2816 x 1024; the tp=2 slices are half that), about 0.2 us at
// 3.35 TB/s. At the serving shapes (M <= 32) launch latency and the
// shared-memory lookups dominate instead. The design is the fused kernel's
// integer core (bs_common.cuh) without its prologue and epilogue:
//   - grid (N/8, M/MT): a block owns MT <= 8 rows and 8 columns, one warp
//     per column;
//   - K is walked in chunks of 64 pattern groups (256 codes): the block
//     builds each row's 16-entry subset-sum tables from the codes in shared
//     memory, then each lane reads its groups' plane bytes, coalesced along
//     K/4, and adds the plane dot for every row, in int32;
//   - per channel: one warp-shuffle sum per row at the end;
//   - grouped: a warp walks each chunk in segments that end at a scale
//     group's end; when a group completes, its exact integer partial is
//     summed over the warp, converted, scaled and added to the row's f32
//     sum (__fmul_rn / __fadd_rn, no FMA), groups in ascending order, which
//     is the order ref.py::ref_lut_gemm_bitsliced sums them. A group may
//     span several chunks or hold a single pattern group.
// Paired-plane 256-entry tables, int16 runs and tensor cores are later work.

#include "bs_common.cuh"

namespace {

template <int BITS, int MT, bool GROUPED>
__global__ void __launch_bounds__(kWarps * 32)
bs_two_step_kernel(const int8_t* __restrict__ codes, const uint8_t* __restrict__ planes,
                   const float* __restrict__ scales, float* __restrict__ out, int M,
                   int N, int K, int group_size) {
    __shared__ int16_t s_lut[MT][kEntries][kChunk];

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int m0 = blockIdx.y * MT;
    const int n = blockIdx.x * kWarps + warp;
    const bool active = n < N;                // inactive warps still build tables
    const int KG = K / kGroup;
    const int gpg = GROUPED ? group_size / kGroup : KG;   // pattern groups per scale group
    const int n_groups = GROUPED ? K / group_size : 1;

    int acc[MT];
    float accf[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        acc[i] = 0;
        accf[i] = 0.f;
    }

    for (int c0 = 0; c0 < KG; c0 += kChunk) {
        const int cg = min(kChunk, KG - c0);
        for (int t = threadIdx.x; t < MT * kChunk; t += blockDim.x) {
            const int i = t / kChunk;
            const int g = t % kChunk;
            const int m = m0 + i;
            int q[kGroup] = {0, 0, 0, 0};
            if (m < M && g < cg) {
                const int8_t* pc = codes + static_cast<size_t>(m) * K +
                                   static_cast<size_t>(c0 + g) * kGroup;
#pragma unroll
                for (int j = 0; j < kGroup; ++j) q[j] = pc[j];
            }
            store_subset_sums(s_lut[i], g, q);
        }
        __syncthreads();

        if (active) {
            for (int s0 = 0; s0 < cg;) {
                // this segment ends at the chunk's end or its scale group's end
                const int s1 = min(cg, s0 + gpg - (c0 + s0) % gpg);
                for (int g = s0 + lane; g < s1; g += 32) {
                    unsigned pat[BITS];
                    load_patterns<BITS>(planes, N, KG, n, c0 + g, pat);
#pragma unroll
                    for (int i = 0; i < MT; ++i) acc[i] += plane_dot<BITS>(s_lut[i], pat, g);
                }
                if (GROUPED && (c0 + s1) % gpg == 0) {      // uniform over the warp
                    const float s =
                        scales[static_cast<size_t>(n) * n_groups + (c0 + s1) / gpg - 1];
#pragma unroll
                    for (int i = 0; i < MT; ++i) {
                        const int part = warp_sum_int(acc[i]);
                        accf[i] = __fadd_rn(accf[i], __fmul_rn(__int2float_rn(part), s));
                        acc[i] = 0;
                    }
                }
                s0 = s1;
            }
        }
        __syncthreads();
    }

    if (!active) return;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int m = m0 + i;
        if (m < M) {                          // uniform over the warp
            const float v = GROUPED ? accf[i] : __int2float_rn(warp_sum_int(acc[i]));
            if (lane == 0) out[static_cast<size_t>(m) * N + n] = v;
        }
    }
}

template <int BITS, int MT>
cudaError_t launch_mt(const int8_t* codes, const uint8_t* planes, const float* scales,
                      float* out, int M, int N, int K, int group_size,
                      cudaStream_t stream) {
    const dim3 grid((N + kWarps - 1) / kWarps, (M + MT - 1) / MT);
    const dim3 block(kWarps * 32);
    if (group_size > 0)
        bs_two_step_kernel<BITS, MT, true><<<grid, block, 0, stream>>>(
            codes, planes, scales, out, M, N, K, group_size);
    else
        bs_two_step_kernel<BITS, MT, false><<<grid, block, 0, stream>>>(
            codes, planes, scales, out, M, N, K, group_size);
    return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const int8_t* codes, const uint8_t* planes, const float* scales,
                        float* out, int M, int N, int K, int group_size,
                        cudaStream_t stream) {
    if (M == 1)
        return launch_mt<BITS, 1>(codes, planes, scales, out, M, N, K, group_size, stream);
    if (M <= 4)
        return launch_mt<BITS, 4>(codes, planes, scales, out, M, N, K, group_size, stream);
    return launch_mt<BITS, 8>(codes, planes, scales, out, M, N, K, group_size, stream);
}

}  // namespace

// C entry point (bound with ctypes). codes: (M, K) int8, planes:
// (bits, N, K/4) u8, scales: (N, K/G) f32 when group_size > 0 (else
// unused, may be null), out: (M, N) f32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int lut_gemm_bitsliced_launch(const void* codes, const void* planes,
                                         const void* scales, void* out, int M, int N,
                                         int K, int bits, int group_size, void* stream) {
    auto* pc = static_cast<const int8_t*>(codes);
    auto* pp = static_cast<const uint8_t*>(planes);
    auto* ps = static_cast<const float*>(scales);
    auto* po = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (K % kGroup || (group_size > 0 && (group_size % kGroup || K % group_size)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (bits == 2) return launch_bits<2>(pc, pp, ps, po, M, N, K, group_size, st);
    if (bits == 4) return launch_bits<4>(pc, pp, ps, po, M, N, K, group_size, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
