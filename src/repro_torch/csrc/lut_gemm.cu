// Product-LUT GEMM (paper §3.2 LUT-16) for sm_90a.
//
//   out[m, n] = sum_k LUT[(w[n, k] << a_bits) | a[m, k]]               (f32)
//   grouped:  out[m, n] = sum_g s[n, g] * sum_{k in g} LUT[...]
//
// Replaces src/repro/kernels/lut_gemm.py::lut_gemm_pallas (pallas_call at
// :233). There the K grid axis carried the sum across sequential grid steps
// in one VMEM accumulator tile; here a loop inside the warp replaces it and
// nothing crosses blocks.
//
// What bounds it on the H100: at the serving shapes (M <= 32 rows, K x N up
// to 2816 x 1024 / 1024 x 2816) the packed weight bytes are ~0.7 MB, i.e.
// well under a microsecond at 3.35 TB/s, so launch latency and the
// shared-memory gathers (M * K lookups per column) bound it, not HBM.
// The design keeps it simple and right: the whole product LUT (16 f32
// entries for w2a2, 4096 for w4a8) is staged once per block in shared
// memory; one warp owns one output column n and up to MT rows; lanes walk
// the weight row's packed bytes coalesced along K, unpack with shift and
// mask in registers, reuse each unpacked weight chunk for all MT rows,
// index the shared LUT and accumulate in f32; a warp-shuffle reduction
// finishes each (m, n). With integer LUT entries every partial sum is an
// exact integer, so the result is bit-identical to the plain version.
// No tensor cores, TMA or wgmma: making it fast is later work.

#include "lut_common.cuh"

namespace {

template <int WB, int AB, int MT, bool GROUPED>
__global__ void __launch_bounds__(kWarps * 32)
lut_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                const float* __restrict__ lut, const float* __restrict__ scales,
                float* __restrict__ out, int M, int N, int K, int group_size) {
    constexpr int FW = Pack<WB>::FACTOR;
    constexpr int FA = Pack<AB>::FACTOR;
    constexpr int L = lcm_c(FW, FA);          // codes per lane step
    constexpr int WBYTES = L / FW;
    constexpr int ABYTES = L / FA;
    constexpr int NLUT = 1 << (WB + AB);
    __shared__ float s_lut[NLUT];
    for (int i = threadIdx.x; i < NLUT; i += blockDim.x) s_lut[i] = lut[i];
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n = blockIdx.x * kWarps + warp;
    if (n >= N) return;                       // uniform over the warp
    const int m0 = blockIdx.y * MT;
    const int kpw = K / FW;
    const int kpa = K / FA;
    const int nsteps = K / L;
    const int n_groups = GROUPED ? K / group_size : 1;
    const uint8_t* wrow = w + static_cast<size_t>(n) * kpw;

    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;

    for (int c = lane; c < nsteps; c += 32) {
        unsigned widx[L];                     // w << a_bits, index-ready
#pragma unroll
        for (int b = 0; b < WBYTES; ++b) {
            const unsigned byte = wrow[c * WBYTES + b];
#pragma unroll
            for (int j = 0; j < FW; ++j) widx[b * FW + j] = code_of<WB>(byte, j) << AB;
        }
        float s = 1.f;
        if (GROUPED) s = scales[static_cast<size_t>(n) * n_groups + (c * L) / group_size];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const int m = m0 + i;
            if (m < M) {
                const uint8_t* arow = a + static_cast<size_t>(m) * kpa + c * ABYTES;
                float part = 0.f;
#pragma unroll
                for (int b = 0; b < ABYTES; ++b) {
                    const unsigned byte = arow[b];
#pragma unroll
                    for (int j = 0; j < FA; ++j)
                        part += s_lut[widx[b * FA + j] | code_of<AB>(byte, j)];
                }
                acc[i] += GROUPED ? s * part : part;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int m = m0 + i;
        if (m < M) {                          // uniform over the warp
            const float v = warp_sum(acc[i]);
            if (lane == 0) out[static_cast<size_t>(m) * N + n] = v;
        }
    }
}

template <int WB, int AB, int MT>
cudaError_t launch_mt(const uint8_t* a, const uint8_t* w, const float* lut,
                      const float* scales, float* out, int M, int N, int K,
                      int group_size, cudaStream_t stream) {
    const dim3 grid((N + kWarps - 1) / kWarps, (M + MT - 1) / MT);
    const dim3 block(kWarps * 32);
    if (scales != nullptr)
        lut_gemm_kernel<WB, AB, MT, true><<<grid, block, 0, stream>>>(
            a, w, lut, scales, out, M, N, K, group_size);
    else
        lut_gemm_kernel<WB, AB, MT, false><<<grid, block, 0, stream>>>(
            a, w, lut, scales, out, M, N, K, group_size);
    return cudaGetLastError();
}

template <int WB, int AB>
cudaError_t launch_bits(const uint8_t* a, const uint8_t* w, const float* lut,
                        const float* scales, float* out, int M, int N, int K,
                        int group_size, cudaStream_t stream) {
    if (M == 1) return launch_mt<WB, AB, 1>(a, w, lut, scales, out, M, N, K, group_size, stream);
    if (M <= 4) return launch_mt<WB, AB, 4>(a, w, lut, scales, out, M, N, K, group_size, stream);
    return launch_mt<WB, AB, 8>(a, w, lut, scales, out, M, N, K, group_size, stream);
}

}  // namespace

// C entry point (bound with ctypes). a: (M, K/fa) u8, w: (N, K/fw) u8,
// lut: (2^(w_bits+a_bits),) f32, scales: (N, K/G) f32 or null, out: (M, N)
// f32. Returns the cudaError_t of the launch (0 on success).
extern "C" int lut_gemm_launch(const void* a, const void* w, const void* lut,
                               const void* scales, void* out, int M, int N,
                               int K, int w_bits, int a_bits, int group_size,
                               void* stream) {
    auto* pa = static_cast<const uint8_t*>(a);
    auto* pw = static_cast<const uint8_t*>(w);
    auto* pl = static_cast<const float*>(lut);
    auto* ps = static_cast<const float*>(scales);
    auto* po = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const int key = w_bits * 16 + a_bits;
    switch (key) {
        case 2 * 16 + 2: return launch_bits<2, 2>(pa, pw, pl, ps, po, M, N, K, group_size, st);
        case 2 * 16 + 8: return launch_bits<2, 8>(pa, pw, pl, ps, po, M, N, K, group_size, st);
        case 4 * 16 + 4: return launch_bits<4, 4>(pa, pw, pl, ps, po, M, N, K, group_size, st);
        case 4 * 16 + 8: return launch_bits<4, 8>(pa, pw, pl, ps, po, M, N, K, group_size, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
