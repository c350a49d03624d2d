// Shared pieces of the packed-code kernels: the sub-byte layout of
// core/packing.py (slot i of a byte holds code i at bits
// [SLOT*i, SLOT*(i+1))), a warp reduction, and compile-time lcm.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int BITS>
struct Pack {
    static constexpr int SLOT = (BITS == 3) ? 4 : BITS;   // slot stride in bits
    static constexpr int FACTOR = 8 / SLOT;                // codes per byte
    static constexpr unsigned MASK = (1u << BITS) - 1u;
};

// Code j of a packed byte (the natural, scheme 'a' unpack).
template <int BITS>
__device__ __forceinline__ unsigned code_of(unsigned byte, int j) {
    return (byte >> (Pack<BITS>::SLOT * j)) & Pack<BITS>::MASK;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__host__ __device__ constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }
__host__ __device__ constexpr int lcm_c(int a, int b) { return a / gcd_c(a, b) * b; }

// Warps per block: each warp owns one output column.
constexpr int kWarps = 8;
