// The product-LUT walk on dense_common.cuh's tiling, shared by lut_gemm.cu
// and expert_gemm.cu (row 1 and row 8):
//
//   out[m, n] = sum_k LUT[(w[n, k] << a_bits) | a[m, k]]               (f32)
//   grouped:  out[m, n] = sum_g s[n, g] * sum_{k in g} LUT[...]
//
// The table sits in shared memory transposed, entry (a << w_bits) | w, so
// the 32 lanes of a warp (32 columns, one activation unit) read 2^w_bits
// consecutive words: no bank conflicts for any of the four widths. At w2a2
// a unit is a pair of neighbouring codes: the block builds the 256 sums
// LUT[w0, a0] + LUT[w1, a1] from the 16-entry table and reads once a pair,
// which halves the table reads (the w4a4 walk, on K / 2 units).
//
// With the port's integer product tables every partial sum is an exact
// integer in f32, so the result is bit-identical to the plain version in
// any order. Any f32 table is taken; a float table's sums round in this
// walk's order. Grouped, the scale multiplies each group's partial of 8
// units (one fused multiply-add), or each unit's entry where the group is
// not a multiple of 8 units.
#pragma once

#include "dense_common.cuh"

// Group modes: none, one scale per 8 units, one scale per unit.
constexpr int kLutNone = 0, kLutBlock = 1, kLutUnit = 2;

// The lookups of one weight word (CPW units from k0) for every row and
// column of the thread. FULL: the whole word lies below hi. ``tab`` is a
// static shared array, so an entry's address is its byte offset
// (activation unit << (UW + 2) | weight unit << 2) plus a constant; the
// entries of 8 units meet in a partial before they are added (per channel:
// short chains) or scaled (kLutBlock).
template <int UW, int UA, int NC, int GM, bool FULL>
__device__ __forceinline__ void lut_word(const DenseArgs& a, const DenseTile& t, int k0,
                                         const uint32_t (&wd)[NC], const float* tab,
                                         const float* st, const unsigned char* at,
                                         float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / UW;
    constexpr int AW = CPW * UA / 32;         // activation words a row
    constexpr unsigned WM = (1u << UW) - 1u, AM = (1u << UA) - 1u;
    const int lane = threadIdx.x % 32;
    float s[CPW / 8][NC];
    if constexpr (GM == kLutBlock) {
#pragma unroll
        for (int b = 0; b < CPW / 8; ++b) {
            const int g = t.group(min(k0 + 8 * b, a.K - 1)) - t.g_lo;
#pragma unroll
            for (int i = 0; i < NC; ++i) s[b][i] = st[(lane + 32 * i) * a.s_pitch + g];
        }
    }
    const unsigned char* arow = at + (k0 - t.lo) * UA / 8;
#pragma unroll
    for (int r = 0; r < kMaxMt; ++r) {
        if (r >= t.rows) break;
        uint32_t aw[AW];
        if constexpr (AW == 1) {
            aw[0] = *reinterpret_cast<const uint32_t*>(arow + r * a.a_pitch);
        } else if constexpr (AW == 2) {
            const uint2 v = *reinterpret_cast<const uint2*>(arow + r * a.a_pitch);
            aw[0] = v.x;
            aw[1] = v.y;
        } else {
            static_assert(AW == 4, "4, 8 or 16 activation bytes a word");
            const uint4 v = *reinterpret_cast<const uint4*>(arow + r * a.a_pitch);
            aw[0] = v.x;
            aw[1] = v.y;
            aw[2] = v.z;
            aw[3] = v.w;
        }
#pragma unroll
        for (int b = 0; b < CPW / 8; ++b) {
            float part[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) part[i] = 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int u = 8 * b + q;
                if (!FULL && k0 + u >= t.hi) break;
                const unsigned au = ((aw[(UA * u) / 32] >> ((UA * u) % 32)) & AM) << (UW + 2);
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    const unsigned o = au | (((wd[i] >> (UW * u)) & WM) << 2);
                    const float v = *reinterpret_cast<const float*>(
                        reinterpret_cast<const char*>(tab) + o);
                    if constexpr (GM != kLutUnit) {
                        part[i] += v;
                    } else {
                        const int g = t.group(k0 + u) - t.g_lo;
                        acc[r][i] = __fmaf_rn(st[(lane + 32 * i) * a.s_pitch + g], v, acc[r][i]);
                    }
                }
            }
            if constexpr (GM == kLutBlock) {
#pragma unroll
                for (int i = 0; i < NC; ++i) acc[r][i] = __fmaf_rn(s[b][i], part[i], acc[r][i]);
            } else if constexpr (GM == kLutNone) {
#pragma unroll
                for (int i = 0; i < NC; ++i) acc[r][i] += part[i];
            }
        }
    }
}

template <int UW, int UA, int NC, int GM>
__device__ __forceinline__ void lut_walk(const DenseArgs& a, DenseTile& t, unsigned char* smem,
                                         const float* tab, float (&acc)[kMaxMt][NC]) {
    constexpr int CPW = 32 / UW;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t* wt = reinterpret_cast<const uint32_t*>(smem);
    const float* st = reinterpret_cast<const float*>(smem + a.s_off);
    for (int round = 0;;) {
        const int nwords = (t.hi - t.lo + CPW - 1) / CPW;
        for (int w = warp; w < nwords; w += kLanes) {
            uint32_t wd[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) wd[i] = wt[(lane + 32 * i) * a.w_pitch + w];
            const int k0 = t.lo + w * CPW;
            if (k0 + CPW <= t.hi)
                lut_word<UW, UA, NC, GM, true>(a, t, k0, wd, tab, st, smem + a.a_off, acc);
            else
                lut_word<UW, UA, NC, GM, false>(a, t, k0, wd, tab, st, smem + a.a_off, acc);
        }
        if (++round == a.rounds) break;
        __syncthreads();                      // the next round rewrites the tiles
        dense_stage<UW, UA, GM != kLutNone>(a, t, round, smem, [] {});
    }
}

// One block's tile: row tile ``row_tile`` of a's operands (the kernels'
// bodies). UW / UA: bits of a weight / activation unit; ``pair``: the units
// are code pairs of w2a2 and the table is built from the 16-entry product
// LUT. The table is a static shared array, so a lookup's address is one OR
// of two offsets and a constant.
template <int UW, int UA, int NC, bool GROUPED>
__device__ __forceinline__ void lut_tile(const DenseArgs& a, int pair, int row_tile) {
    constexpr int NT = 32 * NC;
    constexpr int NTAB = 1 << (UW + UA);
    extern __shared__ __align__(16) unsigned char smem[];
    if (a.C > 1) dense_arrive();
    DenseTile t(a, NT, row_tile);
    __shared__ __align__(16) float tab[NTAB];
    dense_stage<UW, UA, GROUPED>(a, t, 0, smem, [&] {
        if (pair) {                           // (a0 | a1 << 2) << 4 | (w0 | w1 << 2)
            const int i = threadIdx.x;        // NTAB == kDenseThreads
            const int ap = i >> 4, wp = i & 15;
            const float v0 = __ldg(a.table + (((wp & 3) << 2) | (ap & 3)));
            const float v1 = __ldg(a.table + (((wp >> 2) << 2) | (ap >> 2)));
            tab[i] = v0 + v1;
        } else if (reinterpret_cast<uintptr_t>(a.table) % 16 == 0) {
            // 16 bytes a load (entries (w, a..a+3)), stored transposed;
            // neighbouring threads take neighbouring w, so the stores of a
            // warp fall on distinct banks
            for (int i = threadIdx.x; i < NTAB / 4; i += kDenseThreads) {
                const int w = i & ((1 << UW) - 1), au = (i >> UW) * 4;
                const uint4 v =
                    __ldg(reinterpret_cast<const uint4*>(a.table + (w << UA) + au));
                tab[(au << UW) | w] = __uint_as_float(v.x);
                tab[((au + 1) << UW) | w] = __uint_as_float(v.y);
                tab[((au + 2) << UW) | w] = __uint_as_float(v.z);
                tab[((au + 3) << UW) | w] = __uint_as_float(v.w);
            }
        } else {
            for (int i = threadIdx.x; i < NTAB; i += kDenseThreads) {
                const int w = i >> UA, au = i & ((1 << UA) - 1);
                dense_cp4(tab + ((au << UW) | w), a.table + i);
            }
        }
    });
    float acc[kMaxMt][NC];
#pragma unroll
    for (int r = 0; r < kMaxMt; ++r)
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
    if (!GROUPED)
        lut_walk<UW, UA, NC, kLutNone>(a, t, smem, tab, acc);
    else if (a.G % 8 == 0)
        lut_walk<UW, UA, NC, kLutBlock>(a, t, smem, tab, acc);
    else
        lut_walk<UW, UA, NC, kLutUnit>(a, t, smem, tab, acc);
    dense_merge<NC>(a, t, smem, acc, [&](int m, int n, float v) {
        a.out[static_cast<size_t>(m) * a.N + n] = v;
    });
}

// The launch on the kernels of a source: ``Kernels::get<UW, UA, NC,
// GROUPED>()`` is its __global__ instantiation, which takes ``a``
// (DenseArgs, or the expert kernels' ExpertArgs) and ``pair``. The table
// is static shared memory, outside the layout but inside its budget.
template <class Kernels, int UW, int UA, int NC, class Args>
cudaError_t lut_launch_nc(Args& a, int NT, int pair, cudaStream_t stream, int* clusters) {
    constexpr int kTableBytes = 4 << (UW + UA);
    dim3 grid;
    int smem = 0;
    const cudaError_t err =
        dense_args(a, dense_experts(a), NT, UW, UA, 0, kTableBytes, grid, smem);
    if (err != cudaSuccess) return err;
    if (a.G > 0)
        return dense_launch(Kernels::template get<UW, UA, NC, true>(), grid, a.C, smem,
                            kTableBytes, stream, clusters, a, pair);
    return dense_launch(Kernels::template get<UW, UA, NC, false>(), grid, a.C, smem, kTableBytes,
                        stream, clusters, a, pair);
}

template <class Kernels, int UW, int UA, class Args>
cudaError_t lut_launch_units(Args& a, int NT, int pair, cudaStream_t stream, int* clusters) {
    if (NT == 64) return lut_launch_nc<Kernels, UW, UA, 2>(a, NT, pair, stream, clusters);
    return lut_launch_nc<Kernels, UW, UA, 4>(a, NT, pair, stream, clusters);
}

// w2a2 on the w4a4 walk over code pairs: K, G and k_per_rank arrive in
// codes and leave in pairs.
inline cudaError_t lut_pairs(DenseArgs& a) {
    if (a.K % 2 || a.G % 2 || a.kpr % 2) return cudaErrorInvalidValue;
    a.K /= 2;
    a.G /= 2;
    a.kpr /= 2;
    return cudaSuccess;
}
