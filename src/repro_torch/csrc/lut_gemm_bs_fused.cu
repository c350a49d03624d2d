// Fused-prologue bit-sliced LUT GEMM (T-MAC decomposition) for sm_90a.
//
//   a_scale[m] = max(amax_k |x[m, k]| / 2^(a_bits-1), 1e-8)  in x's dtype,
//                or the given f32 a_sc ((1, 1) or (M, 1))
//   q[m, k]    = clamp(rint(x[m, k] / a_scale[m]), -2^(a_bits-1), 2^(a_bits-1)-1)
//   acc[m, n]  = sum_k w[n, k] * q[m, k]        (exact int32; w = idx - 2^(b-1))
//   out[m, n]  = (acc * w_scales[n]) * a_scale[m]                        (f32)
//   grouped:     (sum_g acc_g[m, n] * w_scales[n, g]) * a_scale[m]
//
// The weight arrives as b two's-complement bit planes (bits, N, K/4) u8:
// plane p's byte kg holds bit p of codes 4kg..4kg+3 of idx XOR 2^(b-1), so
// w = sum_p coef_p * bit_p with coef = (1, 2, ..., -2^(b-1)).
//
// Replaces src/repro/kernels/lut_gemm_bitsliced.py::lut_gemm_bs_fused_pallas
// (pallas_call at :368, body _bs_fused_kernel at :258-289). The Pallas body
// holds whole K rows because the dynamic amax reduces over them; here every
// block does the same for its rows, so nothing crosses blocks.
//
// What bounds it on the H100: the bytes of the planes, b * N * K/4. A
// pattern byte carries only 4 bits, so the planes are twice the natural
// packing (1.44 MB at w2, 1024 x 2816); at 3.35 TB/s that is under half a
// microsecond. At the serving shapes (M <= 32) launch latency, the K-long
// per-row prologue and the shared-memory lookups dominate instead. The
// design keeps it simple and right:
//   - grid (N/8, M/MT): a block owns MT <= 8 rows and 8 columns, one warp
//     per column;
//   - prologue: one warp per row reduces amax over K and rounds the scale
//     to x's dtype (bf16 or f32), or reads a_sc. Every column tile redoes
//     this and re-reads its rows from L2: the price of fusing it;
//   - core: K is walked in chunks of 64 pattern groups (256 codes). The
//     block quantizes each row's chunk (IEEE division, rounded to x's
//     dtype when the scale is dynamic, as torch and JAX round a bf16
//     quotient; rint is half to even) and builds each group's 16-entry
//     subset-sum table in shared memory, laid out [row][pattern][group] so
//     the lanes' lookups fall on distinct banks. Each lane then reads its
//     groups' plane bytes, coalesced along K/4, and adds coef_p * table
//     entry for every row, in int32;
//   - finish: a warp-shuffle reduction, then the epilogue in the order the
//     plain version uses, so per-channel outputs are bit-identical to it.
//     Grouped outputs scale each group's lane partial and sum in f32, in
//     another order than the plain version (stated tolerance).
// Paired-plane 256-entry tables, int16 runs, wider loads and sharing one
// quantized row tile between column tiles are later kernel work.
//
// Build without --use_fast_math: '/' must stay IEEE for the codes to match.

#include <cuda_bf16.h>

#include "lut_common.cuh"

namespace {

constexpr int kGroup = 4;                 // codes per plane pattern byte
constexpr int kEntries = 1 << kGroup;     // subset sums per group
constexpr int kChunk = 64;                // pattern groups per table chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round an f32 value to x's dtype, back in f32.
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <int BITS>
__device__ __forceinline__ constexpr int plane_coef(int p) {
    return p == BITS - 1 ? -(1 << p) : (1 << p);
}

template <int BITS, int MT, bool GROUPED, typename TX>
__global__ void __launch_bounds__(kWarps * 32)
bs_fused_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ planes,
                const float* __restrict__ scales, const float* __restrict__ a_sc,
                float* __restrict__ out, int M, int N, int K, int a_bits,
                int group_size, int a_sc_rows) {
    __shared__ int16_t s_lut[MT][kEntries][kChunk];
    __shared__ float s_scale[MT];

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int m0 = blockIdx.y * MT;
    const int n = blockIdx.x * kWarps + warp;
    const bool active = n < N;                // inactive warps still build tables
    const bool dynamic = a_sc_rows == 0;
    const float qmax = static_cast<float>((1 << (a_bits - 1)) - 1);
    const float qmin = -static_cast<float>(1 << (a_bits - 1));

    // Prologue: each row's activation scale.
    for (int i = warp; i < MT; i += kWarps) {
        const int m = m0 + i;
        float s = 1.f;
        if (m < M) {
            if (!dynamic) {
                s = a_sc[a_sc_rows == 1 ? 0 : m];
            } else {
                const TX* row = x + static_cast<size_t>(m) * K;
                float amax = 0.f;
                for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(row[k])));
                amax = warp_max(amax);
                s = round_to(amax / -qmin, TX{});
                s = fmaxf(s, round_to(1e-8f, TX{}));
            }
        }
        if (lane == 0) s_scale[i] = s;
    }
    __syncthreads();

    const int KG = K / kGroup;
    const int n_groups = GROUPED ? K / group_size : 1;
    const int gpg = GROUPED ? group_size / kGroup : 1;   // pattern groups per scale group
    int acc[MT];
    float accf[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        acc[i] = 0;
        accf[i] = 0.f;
    }

    for (int c0 = 0; c0 < KG; c0 += kChunk) {
        const int cg = min(kChunk, KG - c0);
        // Quantize the rows' chunk and build the subset-sum tables.
        for (int t = threadIdx.x; t < MT * kChunk; t += blockDim.x) {
            const int i = t / kChunk;
            const int g = t % kChunk;
            const int m = m0 + i;
            int q[kGroup] = {0, 0, 0, 0};
            if (m < M && g < cg) {
                const float s = s_scale[i];
                const TX* px = x + static_cast<size_t>(m) * K + static_cast<size_t>(c0 + g) * kGroup;
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    float v = to_f32(px[j]) / s;
                    if (dynamic) v = round_to(v, TX{});
                    q[j] = static_cast<int>(fminf(fmaxf(rintf(v), qmin), qmax));
                }
            }
            int e[kEntries];
            e[0] = 0;
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
#pragma unroll
                for (int p = 0; p < (1 << j); ++p) e[(1 << j) + p] = e[p] + q[j];
#pragma unroll
            for (int p = 0; p < kEntries; ++p) s_lut[i][p][g] = static_cast<int16_t>(e[p]);
        }
        __syncthreads();

        if (active) {
            for (int g = lane; g < cg; g += 32) {
                const int kg = c0 + g;
                unsigned pat[BITS];
#pragma unroll
                for (int p = 0; p < BITS; ++p)
                    pat[p] = planes[(static_cast<size_t>(p) * N + n) * KG + kg] & (kEntries - 1);
                float s = 1.f;
                if (GROUPED) s = scales[static_cast<size_t>(n) * n_groups + kg / gpg];
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    int v = 0;
#pragma unroll
                    for (int p = 0; p < BITS; ++p) v += plane_coef<BITS>(p) * s_lut[i][pat[p]][g];
                    if (GROUPED)
                        accf[i] += static_cast<float>(v) * s;
                    else
                        acc[i] += v;
                }
            }
        }
        __syncthreads();
    }

    if (!active) return;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int m = m0 + i;
        if (m < M) {                          // uniform over the warp
            if (GROUPED) {
                const float v = warp_sum(accf[i]);
                if (lane == 0) out[static_cast<size_t>(m) * N + n] = v * s_scale[i];
            } else {
                const int v = warp_sum_int(acc[i]);
                if (lane == 0)
                    out[static_cast<size_t>(m) * N + n] =
                        (static_cast<float>(v) * scales[n]) * s_scale[i];
            }
        }
    }
}

template <int BITS, int MT, typename TX>
cudaError_t launch_mt(const void* x, const uint8_t* planes, const float* scales,
                      const float* a_sc, float* out, int M, int N, int K, int a_bits,
                      int group_size, int a_sc_rows, cudaStream_t stream) {
    const dim3 grid((N + kWarps - 1) / kWarps, (M + MT - 1) / MT);
    const dim3 block(kWarps * 32);
    auto* px = static_cast<const TX*>(x);
    if (group_size > 0)
        bs_fused_kernel<BITS, MT, true, TX><<<grid, block, 0, stream>>>(
            px, planes, scales, a_sc, out, M, N, K, a_bits, group_size, a_sc_rows);
    else
        bs_fused_kernel<BITS, MT, false, TX><<<grid, block, 0, stream>>>(
            px, planes, scales, a_sc, out, M, N, K, a_bits, group_size, a_sc_rows);
    return cudaGetLastError();
}

template <int BITS, typename TX>
cudaError_t launch_bits(const void* x, const uint8_t* planes, const float* scales,
                        const float* a_sc, float* out, int M, int N, int K, int a_bits,
                        int group_size, int a_sc_rows, cudaStream_t stream) {
    if (M == 1)
        return launch_mt<BITS, 1, TX>(x, planes, scales, a_sc, out, M, N, K, a_bits,
                                      group_size, a_sc_rows, stream);
    if (M <= 4)
        return launch_mt<BITS, 4, TX>(x, planes, scales, a_sc, out, M, N, K, a_bits,
                                      group_size, a_sc_rows, stream);
    return launch_mt<BITS, 8, TX>(x, planes, scales, a_sc, out, M, N, K, a_bits,
                                  group_size, a_sc_rows, stream);
}

}  // namespace

// C entry point (bound with ctypes). x: (M, K) f32 (x_bf16 == 0) or bf16,
// planes: (bits, N, K/4) u8, scales: (N,) f32, or (N, K/G) f32 when
// group_size > 0, a_sc: f32 with a_sc_rows entries (0: none, dynamic
// scales; 1: one scale for every row; M: one per row), out: (M, N) f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lut_gemm_bs_fused_launch(const void* x, const void* planes,
                                        const void* scales, const void* a_sc,
                                        void* out, int M, int N, int K, int bits,
                                        int a_bits, int group_size, int x_bf16,
                                        int a_sc_rows, void* stream) {
    auto* pp = static_cast<const uint8_t*>(planes);
    auto* ps = static_cast<const float*>(scales);
    auto* pa = static_cast<const float*>(a_sc);
    auto* po = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (a_bits < 2 || a_bits > 8 || K % kGroup || (group_size > 0 && group_size % kGroup))
        return static_cast<int>(cudaErrorInvalidValue);
    if (bits == 2)
        return x_bf16 ? launch_bits<2, __nv_bfloat16>(x, pp, ps, pa, po, M, N, K, a_bits,
                                                      group_size, a_sc_rows, st)
                      : launch_bits<2, float>(x, pp, ps, pa, po, M, N, K, a_bits,
                                              group_size, a_sc_rows, st);
    if (bits == 4)
        return x_bf16 ? launch_bits<4, __nv_bfloat16>(x, pp, ps, pa, po, M, N, K, a_bits,
                                                      group_size, a_sc_rows, st)
                      : launch_bits<4, float>(x, pp, ps, pa, po, M, N, K, a_bits,
                                              group_size, a_sc_rows, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
