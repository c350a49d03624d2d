// The integer core shared by the two bit-sliced LUT GEMM kernels
// (lut_gemm_bs_fused.cu, lut_gemm_bitsliced.cu): per-token 16-entry
// subset-sum tables in shared memory, the weight's bit-plane patterns, and
// the exact int32 dot of one pattern group against one row's table.
//
// The weight arrives as b two's-complement bit planes (bits, N, K/4) u8:
// plane p's byte kg holds bit p of codes 4kg..4kg+3 of idx XOR 2^(b-1), so
// w = sum_p coef_p * bit_p with coef = (1, 2, ..., -2^(b-1)). A table entry
// e[pattern] is the sum of the codes whose bit is set in the pattern, so
// sum_j w[4kg + j] * q[4kg + j] = sum_p coef_p * e[pattern_p].
#pragma once

#include <cstdint>

#include "lut_common.cuh"

constexpr int kGroup = 4;                 // codes per plane pattern byte
constexpr int kEntries = 1 << kGroup;     // subset sums per group
constexpr int kChunk = 64;                // pattern groups per table chunk

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <int BITS>
__device__ __forceinline__ constexpr int plane_coef(int p) {
    return p == BITS - 1 ? -(1 << p) : (1 << p);
}

// The 16 subset sums of one pattern group's four codes q, into column g of
// a row's table laid out [pattern][group], so that lanes reading
// neighbouring groups fall on distinct banks.
__device__ __forceinline__ void store_subset_sums(int16_t (*table)[kChunk], int g,
                                                  const int (&q)[kGroup]) {
    int e[kEntries];
    e[0] = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int p = 0; p < (1 << j); ++p) e[(1 << j) + p] = e[p] + q[j];
#pragma unroll
    for (int p = 0; p < kEntries; ++p) table[p][g] = static_cast<int16_t>(e[p]);
}

// Column n's 4-bit pattern of pattern group kg in every plane (a plane byte
// carries its pattern in the low nibble; the high nibble is masked off).
template <int BITS>
__device__ __forceinline__ void load_patterns(const uint8_t* __restrict__ planes, int N,
                                              int KG, int n, int kg,
                                              unsigned (&pat)[BITS]) {
#pragma unroll
    for (int p = 0; p < BITS; ++p)
        pat[p] = planes[(static_cast<size_t>(p) * N + n) * KG + kg] & (kEntries - 1);
}

// sum_p coef_p * table[pat_p][g]: the exact integer dot of one pattern
// group's weights with one row's codes.
template <int BITS>
__device__ __forceinline__ int plane_dot(const int16_t (*table)[kChunk],
                                         const unsigned (&pat)[BITS], int g) {
    int v = 0;
#pragma unroll
    for (int p = 0; p < BITS; ++p) v += plane_coef<BITS>(p) * table[pat[p]][g];
    return v;
}
