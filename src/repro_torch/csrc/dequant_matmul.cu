// Packed-weight dequant matmul for sm_90a:
//
//   out = (a @ dequant(w).T) * scales                                   (f32)
//   dequant(w)[n, k] = codebook[code(n, k)]     (per-channel scales (N,))
//   grouped: dequant(w)[n, k] = codebook[code(n, k)] * s[n, k / G]  (no epilogue)
//
// Replaces src/repro/kernels/lut_dequant_matmul.py::dequant_matmul_pallas
// (pallas_call at :116). Group-wise scales fold into the weight before the
// contraction, as there (:55-71) and in ref.py:96-98.
//
// What bounds it on the H100: at the serving shapes (M <= 32, K x N up to
// 2816 x 1024) the packed weights are ~0.7 MB (w2) and the f32 FMAs are
// 2*M*K*N <= 185 MFLOP, so the CUDA-core f32 rate and launch latency bound
// it, not HBM. The design: the 2^b-entry codebook sits in shared memory;
// one warp owns one output column n and up to MT rows; lanes walk the
// packed weight row coalesced along K, decode the codes in registers
// (shift, mask, codebook read, optional group scale) and reuse each decoded
// weight for all MT rows, upcasting the bf16/f32 activations to f32 and
// accumulating in f32; a warp-shuffle reduction finishes each (m, n) and
// the per-channel scale is the epilogue. Each product and each sum is
// rounded on its own (__fmul_rn / __fadd_rn, no fused multiply-add), in an
// order the plain version repeats (ref.py::warp_order_matmul, one packed
// byte a lane step), so the two agree bit for bit: through a model, last-
// ulp differences grow, most of all where a router picks experts. No
// tensor cores, TMA or wgmma: a mixed-input wgmma GEMM is later work.

#include <cuda_bf16.h>

#include "lut_common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int WB, int MT, bool GROUPED, typename TA>
__global__ void __launch_bounds__(kWarps * 32)
dequant_matmul_kernel(const TA* __restrict__ a, const uint8_t* __restrict__ w,
                      const float* __restrict__ codebook,
                      const float* __restrict__ scales, float* __restrict__ out,
                      int M, int N, int K, int group_size) {
    constexpr int F = Pack<WB>::FACTOR;
    constexpr int NCB = 1 << WB;
    __shared__ float s_cb[NCB];
    for (int i = threadIdx.x; i < NCB; i += blockDim.x) s_cb[i] = codebook[i];
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n = blockIdx.x * kWarps + warp;
    if (n >= N) return;                       // uniform over the warp
    const int m0 = blockIdx.y * MT;
    const int kp = K / F;
    const int n_groups = GROUPED ? K / group_size : 1;
    const uint8_t* wrow = w + static_cast<size_t>(n) * kp;

    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;

    for (int c = lane; c < kp; c += 32) {
        const unsigned byte = wrow[c];
        float wv[F];
        float s = 1.f;
        if (GROUPED) s = scales[static_cast<size_t>(n) * n_groups + (c * F) / group_size];
#pragma unroll
        for (int j = 0; j < F; ++j) {
            const float lv = s_cb[code_of<WB>(byte, j)];
            wv[j] = GROUPED ? lv * s : lv;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const int m = m0 + i;
            if (m < M) {
                const TA* arow = a + static_cast<size_t>(m) * K + c * F;
#pragma unroll
                for (int j = 0; j < F; ++j)
                    acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(arow[j]), wv[j]));
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int m = m0 + i;
        if (m < M) {                          // uniform over the warp
            const float v = warp_sum(acc[i]);
            if (lane == 0) out[static_cast<size_t>(m) * N + n] = GROUPED ? v : v * scales[n];
        }
    }
}

template <int WB, int MT, typename TA>
cudaError_t launch_mt(const TA* a, const uint8_t* w, const float* cb,
                      const float* scales, float* out, int M, int N, int K,
                      int group_size, cudaStream_t stream) {
    const dim3 grid((N + kWarps - 1) / kWarps, (M + MT - 1) / MT);
    const dim3 block(kWarps * 32);
    if (group_size > 0)
        dequant_matmul_kernel<WB, MT, true, TA><<<grid, block, 0, stream>>>(
            a, w, cb, scales, out, M, N, K, group_size);
    else
        dequant_matmul_kernel<WB, MT, false, TA><<<grid, block, 0, stream>>>(
            a, w, cb, scales, out, M, N, K, group_size);
    return cudaGetLastError();
}

template <int WB, typename TA>
cudaError_t launch_bits(const void* a, const uint8_t* w, const float* cb,
                        const float* scales, float* out, int M, int N, int K,
                        int group_size, cudaStream_t stream) {
    auto* pa = static_cast<const TA*>(a);
    if (M == 1) return launch_mt<WB, 1>(pa, w, cb, scales, out, M, N, K, group_size, stream);
    if (M <= 4) return launch_mt<WB, 4>(pa, w, cb, scales, out, M, N, K, group_size, stream);
    return launch_mt<WB, 8>(pa, w, cb, scales, out, M, N, K, group_size, stream);
}

}  // namespace

// C entry point (bound with ctypes). a: (M, K) f32 (a_bf16 == 0) or bf16,
// w: (N, K/f) u8, codebook: (2^bits,) f32, scales: (N,) f32 or (N, K/G) f32
// when group_size > 0, out: (M, N) f32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dequant_matmul_launch(const void* a, const void* w,
                                     const void* codebook, const void* scales,
                                     void* out, int M, int N, int K, int bits,
                                     int group_size, int a_bf16, void* stream) {
    auto* pw = static_cast<const uint8_t*>(w);
    auto* pc = static_cast<const float*>(codebook);
    auto* ps = static_cast<const float*>(scales);
    auto* po = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (bits == 2)
        return a_bf16 ? launch_bits<2, __nv_bfloat16>(a, pw, pc, ps, po, M, N, K, group_size, st)
                      : launch_bits<2, float>(a, pw, pc, ps, po, M, N, K, group_size, st);
    if (bits == 4)
        return a_bf16 ? launch_bits<4, __nv_bfloat16>(a, pw, pc, ps, po, M, N, K, group_size, st)
                      : launch_bits<4, float>(a, pw, pc, ps, po, M, N, K, group_size, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
