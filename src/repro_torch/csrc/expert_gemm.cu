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
// axis carries each sum in one VMEM output tile; here the expert is grid z,
// a loop inside the warp walks K, and nothing crosses blocks.
//
// What bounds them on the H100: at moonshot-v1-16b-a3b's decode shape
// (E 64, M = capacity 4, K x N = 2048 x 1408 or 1408 x 2048, w2) a call
// reads 46.1 MB of packed codes, 13.8 us at 3.35 TB/s, so HBM bounds it.
// The work per code is the limit of this design: the dequant kernel
// decodes each code once (shift, mask, codebook read in shared memory,
// optional group scale) and spends M f32 multiply-adds on it on the CUDA
// cores; the LUT kernel does one shared-memory lookup per (m, n, k),
// E*M*N*K of them.
// The design: one warp owns one output column (e, n) and up to MT rows;
// lanes walk the packed weight row coalesced along K (the dequant kernel a
// 4-byte word a lane step, the LUT kernel a word where the row length
// allows, else a byte), reusing each decoded weight for all MT rows; the
// 2^b-entry codebook or the 2^(2b)-entry product LUT sits in shared
// memory; a warp-shuffle reduction finishes each (e, m, n). With integer
// LUT entries every partial sum of the LUT kernel is an exact integer, so
// per channel it is bit-identical to the plain version. The dequant kernel
// rounds each product and each sum on its own (no fused multiply-add) in
// an order its plain version repeats (ref.py::warp_order_matmul), so it is
// bit-identical too: a last-ulp difference would flip the router's top-k
// somewhere in 48 layers and move the logits far. Rows of an expert that
// no token filled are zero and come out zero. No tensor cores, TMA or
// skipping of empty capacity slots: those are later work.

#include <cuda_bf16.h>

#include "lut_common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive packed bytes (VEC = 1 or 4, 4-byte aligned when 4), as
// the low bytes of a word: byte b at bits [8b, 8b + 8).
template <int VEC>
__device__ __forceinline__ unsigned load_bytes(const uint8_t* p) {
    if constexpr (VEC == 4) return *reinterpret_cast<const unsigned*>(p);
    else return *p;
}

// NV consecutive activations of one row as f32, in 16-byte loads when
// VECTOR (the caller guarantees 16-byte alignment then).
template <int NV, bool VECTOR, typename TA>
__device__ __forceinline__ void load_row(const TA* p, float (&dst)[NV]) {
    if constexpr (VECTOR && (NV * sizeof(TA)) % 16 == 0) {
        alignas(16) TA buf[NV];
#pragma unroll
        for (int q = 0; q < static_cast<int>(NV * sizeof(TA) / 16); ++q)
            reinterpret_cast<uint4*>(buf)[q] = reinterpret_cast<const uint4*>(p)[q];
#pragma unroll
        for (int j = 0; j < NV; ++j) dst[j] = to_f32(buf[j]);
    } else {
#pragma unroll
        for (int j = 0; j < NV; ++j) dst[j] = to_f32(p[j]);
    }
}

template <int WB, bool ALIGNED, int MT, bool GROUPED, typename TA>
__global__ void __launch_bounds__(kWarps * 32)
expert_dequant_kernel(const TA* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ codebook,
                      const float* __restrict__ scales, float* __restrict__ out,
                      int M, int N, int K, int group_size) {
    constexpr int F = Pack<WB>::FACTOR;
    constexpr int NCB = 1 << WB;
    constexpr int CODES = 4 * F;              // codes per lane step: a 4-byte word
    __shared__ float s_cb[NCB];
    for (int i = threadIdx.x; i < NCB; i += blockDim.x) s_cb[i] = codebook[i];
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n = blockIdx.x * kWarps + warp;
    if (n >= N) return;                       // uniform over the warp
    const int e = blockIdx.z;
    const int m0 = blockIdx.y * MT;
    const int kp = K / F;
    const int words = (kp + 3) / 4;           // the last one partial unless ALIGNED
    const int n_groups = GROUPED ? K / group_size : 1;
    const size_t row = static_cast<size_t>(e) * N + n;   // weight row (e, n)
    const uint8_t* wrow = w + row * kp;
    const TA* xe = x + static_cast<size_t>(e) * M * K;

    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;

    for (int c = lane; c < words; c += 32) {
        const unsigned word = ALIGNED ? load_bytes<4>(wrow + c * 4) : 0u;
        float wv[CODES];                      // codes past K decode to 0
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int byte_ix = c * 4 + b;
            const bool in = ALIGNED || byte_ix < kp;
            const unsigned byte = ALIGNED ? (word >> (8 * b)) & 0xffu
                                          : in ? wrow[byte_ix] : 0u;
            float s = 1.f;                    // a byte never straddles a group
            if (GROUPED && in) s = scales[row * n_groups + (byte_ix * F) / group_size];
#pragma unroll
            for (int j = 0; j < F; ++j) {
                const float lv = s_cb[code_of<WB>(byte, j)];
                wv[b * F + j] = !in ? 0.f : GROUPED ? lv * s : lv;
            }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const int m = m0 + i;
            if (m < M) {
                const TA* xr = xe + static_cast<size_t>(m) * K + c * CODES;
                float xv[CODES];
                if (ALIGNED) {
                    load_row<CODES, true>(xr, xv);
                } else {
#pragma unroll
                    for (int j = 0; j < CODES; ++j)
                        xv[j] = c * CODES + j < K ? to_f32(xr[j]) : 0.f;
                }
#pragma unroll
                for (int j = 0; j < CODES; ++j)
                    acc[i] = __fadd_rn(acc[i], __fmul_rn(xv[j], wv[j]));
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int m = m0 + i;
        if (m < M) {                          // uniform over the warp
            const float v = warp_sum(acc[i]);
            if (lane == 0)
                out[(static_cast<size_t>(e) * M + m) * N + n] = GROUPED ? v : v * scales[row];
        }
    }
}

template <int B, int VEC, int MT, bool GROUPED>
__global__ void __launch_bounds__(kWarps * 32)
expert_lut_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                  const float* __restrict__ lut, const float* __restrict__ scales,
                  float* __restrict__ out, int M, int N, int K, int group_size) {
    constexpr int F = Pack<B>::FACTOR;        // w_bits == a_bits: one pack factor
    constexpr int NLUT = 1 << (2 * B);
    __shared__ float s_lut[NLUT];
    for (int i = threadIdx.x; i < NLUT; i += blockDim.x) s_lut[i] = lut[i];
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n = blockIdx.x * kWarps + warp;
    if (n >= N) return;                       // uniform over the warp
    const int e = blockIdx.z;
    const int m0 = blockIdx.y * MT;
    const int kp = K / F;
    const int n_groups = GROUPED ? K / group_size : 1;
    const size_t row = static_cast<size_t>(e) * N + n;
    const uint8_t* wrow = w + row * kp;
    const uint8_t* ae = a + static_cast<size_t>(e) * M * kp;

    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.f;

    for (int c = lane; c < kp / VEC; c += 32) {
        const unsigned wbytes = load_bytes<VEC>(wrow + c * VEC);
        unsigned widx[VEC * F];               // w << b, index-ready
        float s[VEC];
#pragma unroll
        for (int b = 0; b < VEC; ++b) {
            const unsigned byte = (wbytes >> (8 * b)) & 0xffu;
#pragma unroll
            for (int j = 0; j < F; ++j) widx[b * F + j] = code_of<B>(byte, j) << B;
            s[b] = GROUPED ? scales[row * n_groups + ((c * VEC + b) * F) / group_size] : 1.f;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const int m = m0 + i;
            if (m < M) {
                const unsigned abytes = load_bytes<VEC>(ae + static_cast<size_t>(m) * kp + c * VEC);
#pragma unroll
                for (int b = 0; b < VEC; ++b) {
                    const unsigned byte = (abytes >> (8 * b)) & 0xffu;
                    float part = 0.f;
#pragma unroll
                    for (int j = 0; j < F; ++j)
                        part += s_lut[widx[b * F + j] | code_of<B>(byte, j)];
                    acc[i] += GROUPED ? s[b] * part : part;
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int m = m0 + i;
        if (m < M) {                          // uniform over the warp
            const float v = warp_sum(acc[i]);
            if (lane == 0) out[(static_cast<size_t>(e) * M + m) * N + n] = v;
        }
    }
}

dim3 grid_of(int E, int M, int N, int MT) {
    return dim3((N + kWarps - 1) / kWarps, (M + MT - 1) / MT, E);
}

template <int WB, bool ALIGNED, int MT, typename TA>
cudaError_t dequant_mt(const TA* x, const uint8_t* w, const float* cb,
                       const float* scales, float* out, int E, int M, int N,
                       int K, int group_size, cudaStream_t stream) {
    const dim3 grid = grid_of(E, M, N, MT), block(kWarps * 32);
    if (group_size > 0)
        expert_dequant_kernel<WB, ALIGNED, MT, true, TA><<<grid, block, 0, stream>>>(
            x, w, cb, scales, out, M, N, K, group_size);
    else
        expert_dequant_kernel<WB, ALIGNED, MT, false, TA><<<grid, block, 0, stream>>>(
            x, w, cb, scales, out, M, N, K, group_size);
    return cudaGetLastError();
}

template <int WB, bool ALIGNED, typename TA>
cudaError_t dequant_rows(const TA* x, const uint8_t* w, const float* cb,
                         const float* scales, float* out, int E, int M, int N,
                         int K, int group_size, cudaStream_t stream) {
    if (M <= 4) return dequant_mt<WB, ALIGNED, 4>(x, w, cb, scales, out, E, M, N, K, group_size, stream);
    return dequant_mt<WB, ALIGNED, 8>(x, w, cb, scales, out, E, M, N, K, group_size, stream);
}

// Rows on whole words: every weight row starts on a 4-byte boundary and
// every activation row on act_align bytes (K/f a multiple of 4, aligned
// base pointers). The dequant kernel then loads whole words and 16-byte
// activation vectors, else byte by byte with the same lane steps; the LUT
// kernel steps a word a lane, else a byte.
bool word_steps(const void* act, int act_align, const void* w, int kp) {
    return kp % 4 == 0 && reinterpret_cast<uintptr_t>(act) % act_align == 0
        && reinterpret_cast<uintptr_t>(w) % 4 == 0;
}

template <int WB, typename TA>
cudaError_t dequant_bits(const void* x, const uint8_t* w, const float* cb,
                         const float* scales, float* out, int E, int M, int N,
                         int K, int group_size, cudaStream_t stream) {
    auto* px = static_cast<const TA*>(x);
    if (word_steps(x, 16, w, K / Pack<WB>::FACTOR))
        return dequant_rows<WB, true>(px, w, cb, scales, out, E, M, N, K, group_size, stream);
    return dequant_rows<WB, false>(px, w, cb, scales, out, E, M, N, K, group_size, stream);
}

template <int B, int VEC, int MT>
cudaError_t lut_mt(const uint8_t* a, const uint8_t* w, const float* lut,
                   const float* scales, float* out, int E, int M, int N, int K,
                   int group_size, cudaStream_t stream) {
    const dim3 grid = grid_of(E, M, N, MT), block(kWarps * 32);
    if (scales != nullptr)
        expert_lut_kernel<B, VEC, MT, true><<<grid, block, 0, stream>>>(
            a, w, lut, scales, out, M, N, K, group_size);
    else
        expert_lut_kernel<B, VEC, MT, false><<<grid, block, 0, stream>>>(
            a, w, lut, scales, out, M, N, K, group_size);
    return cudaGetLastError();
}

template <int B>
cudaError_t lut_bits(const uint8_t* a, const uint8_t* w, const float* lut,
                     const float* scales, float* out, int E, int M, int N, int K,
                     int group_size, cudaStream_t stream) {
    const bool words = word_steps(a, 4, w, K / Pack<B>::FACTOR);
    if (words && M <= 4) return lut_mt<B, 4, 4>(a, w, lut, scales, out, E, M, N, K, group_size, stream);
    if (words) return lut_mt<B, 4, 8>(a, w, lut, scales, out, E, M, N, K, group_size, stream);
    if (M <= 4) return lut_mt<B, 1, 4>(a, w, lut, scales, out, E, M, N, K, group_size, stream);
    return lut_mt<B, 1, 8>(a, w, lut, scales, out, E, M, N, K, group_size, stream);
}

}  // namespace

// C entry points (bound with ctypes). Each returns the cudaError_t of the
// launch (0 on success).
//
// x: (E, M, K) f32 (x_bf16 == 0) or bf16, w: (E, N, K/f) u8, codebook:
// (2^bits,) f32, scales: (E, N) f32 or (E, N, K/G) f32 when group_size > 0,
// out: (E, M, N) f32.
extern "C" int expert_dequant_matmul_launch(const void* x, const void* w,
                                            const void* codebook, const void* scales,
                                            void* out, int E, int M, int N, int K,
                                            int bits, int group_size, int x_bf16,
                                            void* stream) {
    auto* pw = static_cast<const uint8_t*>(w);
    auto* pc = static_cast<const float*>(codebook);
    auto* ps = static_cast<const float*>(scales);
    auto* po = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (bits == 2)
        return x_bf16 ? dequant_bits<2, __nv_bfloat16>(x, pw, pc, ps, po, E, M, N, K, group_size, st)
                      : dequant_bits<2, float>(x, pw, pc, ps, po, E, M, N, K, group_size, st);
    if (bits == 4)
        return x_bf16 ? dequant_bits<4, __nv_bfloat16>(x, pw, pc, ps, po, E, M, N, K, group_size, st)
                      : dequant_bits<4, float>(x, pw, pc, ps, po, E, M, N, K, group_size, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// a: (E, M, K/f) u8, w: (E, N, K/f) u8 (w_bits == a_bits == bits), lut:
// (2^(2 bits),) f32, scales: (E, N, K/G) f32 or null, out: (E, M, N) f32.
extern "C" int expert_lut_gemm_launch(const void* a, const void* w, const void* lut,
                                      const void* scales, void* out, int E, int M,
                                      int N, int K, int bits, int group_size,
                                      void* stream) {
    auto* pa = static_cast<const uint8_t*>(a);
    auto* pw = static_cast<const uint8_t*>(w);
    auto* pl = static_cast<const float*>(lut);
    auto* ps = static_cast<const float*>(scales);
    auto* po = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (bits == 2) return lut_bits<2>(pa, pw, pl, ps, po, E, M, N, K, group_size, st);
    if (bits == 4) return lut_bits<4>(pa, pw, pl, ps, po, E, M, N, K, group_size, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
