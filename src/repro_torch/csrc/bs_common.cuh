// The integer core shared by the two bit-sliced LUT GEMM kernels
// (lut_gemm_bs_fused.cu, lut_gemm_bitsliced.cu): a block owns MT rows, NT
// columns and one K slice, builds the slice's subset-sum tables once for
// all NT columns, walks the weight's bit planes 16 bytes at a time (the
// next segment's bytes in flight while one is looked up), sums the
// lookups of several rows at once in packed 16-bit lanes, and merges the
// ranks' exact partials through distributed shared memory.
//
// The weight arrives as b two's-complement bit planes (bits, N, K/4) u8:
// plane p's byte kg holds bit p of codes 4kg..4kg+3 of idx XOR 2^(b-1) in
// its low nibble, so w = sum_p coef_p * bit_p with coef = (1, 2, ...,
// -2^(b-1)). A table entry e[pattern] is the sum of the codes whose bit is
// set in the pattern, so sum_j w[4kg + j] * q[4kg + j] = sum_p coef_p *
// e[pattern_p].
//
// The tiling (MT, NT, C ranks of kgpr pattern groups each) is chosen by
// kernels/lut_gemm_bitsliced.py::bs_partition and passed in; the CPU walk
// (lut_gemm_bitsliced_walk) replays the same cut.
//
//   grid (C, N/NT, M/MT), clusters of C blocks along x: block x is rank x of
//   the column tile. K is cut into windows of kgpr pattern groups, a whole
//   number of 16-group segments and, under group scales, of scale groups;
//   in round t rank c owns window t * C + c (the last window ragged, later
//   ones empty). Per channel one round covers K; under group scales
//   bs_partition shrinks the window until the partials fit, so small
//   groups over a long K take several rounds. Thread t takes column t % NT and
//   segments t / NT, t / NT + 256 / NT, ... of each table chunk, so a
//   warp's lanes read one group's table with 32 columns' patterns.
//
// Merge: rank o / share owns output o of the MT x NT tile. Per channel
// each thread adds its int32 sums into the owner's shared memory (atomics
// through distributed shared memory, exact in any order); one cluster
// barrier then separates the sends from the owners' reads of their own
// memory. Under group scales each rank keeps one int32 partial per scale
// group of its window, turns it into the term f32(partial) * scale
// (__fmul_rn) and sends the term to the owner. A round's C windows are
// consecutive in K, so the owner adds the round's terms in ascending
// group order onto its running sums (__fadd_rn):
// ref.py::ref_lut_gemm_bitsliced's order over the whole of K. One cluster
// barrier a round separates the sends from the owners' reads, and the
// owners' arrival after reading releases the next round's sends.
//
// Tables: entry p of pattern group g (chunk-local) for row r sits at
//   table[((g * 16 + (p ^ (g & 15))) * MT) + r]    (u16, e + kBias)
// so the MT rows' entries of one pattern share one 2/8/16-byte word, and a
// group's 16 words are permuted by g: lanes of a warp that read one group
// with random patterns touch distinct banks (MT <= 4), and lanes that build
// neighbouring groups store to distinct banks.
//
// Packed sums: every entry carries kBias = 512 >= 4 * 128, so it lies in
// [0, 1020] and the sum of a 16-group segment (16320 at most) stays inside
// its 16-bit lane: plain 32-bit adds sum two rows at once and no carry
// crosses a lane. A plane's run of 16 groups is half of what
// ref.py::_int16_run proves safe for a single plane (32). At a segment's
// end (or a scale group's) the lanes widen into int32:
//   sum_p coef_p * lane_p - n * kBias * sum_p coef_p,   sum_p coef_p = -1.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

constexpr int kGroup = 4;                 // codes per plane pattern byte
constexpr int kEntries = 1 << kGroup;     // subset sums per group
constexpr int kSeg = 16;                  // pattern groups per 16-byte plane load
constexpr int kBias = kGroup * 128;       // keeps every packed entry non-negative
constexpr int kBsThreads = 256;
// blocks of 256 threads an SM holds at once: caps a thread at 80 registers
// (without the cap the unrolled lookups took 140-205 and a launch ran in
// two waves of clusters)
constexpr int kBsMinBlocks = 3;
constexpr int kTableBytes = 32 * 1024;    // one chunk's tables
constexpr int kMaxBsCluster = 8;          // portable cluster size

// pattern groups a table chunk holds (a multiple of kSeg)
template <int MT>
constexpr int chunk_groups() { return kTableBytes / (kEntries * MT * 2); }

template <int BITS>
__device__ __forceinline__ constexpr int plane_coef(int p) {
    return p == BITS - 1 ? -(1 << p) : (1 << p);
}

// What both kernels take. x is the (M, K) activations (fused: bf16 or f32)
// or int8 codes (two-step).
struct BsArgs {
    const void* x;
    const uint8_t* planes;                // (bits, N, K/4)
    const float* scales;                  // (N,), or (N, K/G) when gpg > 0
    const float* a_sc;                    // fused: static scale(s), or null
    float* out;                           // (M, N) f32
    int M, N, K;
    int gpg;                              // pattern groups a scale group (0: per channel)
    int a_bits, a_sc_rows;                // fused only
    int nt_shift, C, kgpr;                // log2 NT, ranks, pattern groups a window
    int rounds;                           // rounds of C windows that cover K
    int vec;                              // plane rows 16-byte aligned: uint4 loads
    int share;                            // outputs of the tile each rank writes
    int part_off, wsc_off, recv_off, sums_off, scale_off;   // shared memory (bs_layout)
};

struct BsLayout {
    int part_off, wsc_off, recv_off, sums_off, scale_off, total;
};

// Shared memory of one block: the chunk's tables; under group scales the
// rank's int32 partials (one per scale group of the window, row and
// column) and its scales of the tile's columns; what the ranks send in a
// round for this rank's share of the outputs (one int32 sum per output,
// or one f32 term per scale group of the round's C windows) and, under
// group scales, the share's running f32 sums; 2 * MT words for the row
// amax and scale.
inline BsLayout bs_layout(int MT, int NT, int C, int kgpr, int gpg) {
    const int chunk = kTableBytes / (kEntries * MT * 2);
    const int seg_groups = (kgpr + kSeg - 1) / kSeg * kSeg;
    const int table = (seg_groups < chunk ? seg_groups : chunk) * kEntries * MT * 2;
    const int ng = gpg > 0 ? kgpr / gpg : 0;
    const int part = ng * MT * NT * 4;
    const int wsc = ng * NT * 4;
    const int share = (MT * NT + C - 1) / C;
    const int recv = (gpg > 0 ? C * ng : 1) * share * 4;
    const int sums = gpg > 0 ? share * 4 : 0;
    const int recv_off = table + part + wsc;
    const int sums_off = recv_off + recv;
    return {table, table + part, recv_off, sums_off, sums_off + sums,
            sums_off + sums + 2 * MT * 4};
}

// The MT rows' 16-bit entries of one pattern as 32-bit words (two rows a
// word; one word for MT == 1).
template <int MT>
struct TableWord {
    static constexpr int W = MT == 1 ? 1 : MT / 2;
    static __device__ __forceinline__ void load_at(const unsigned char* p, uint32_t (&w)[W]) {
        if constexpr (MT == 1) {
            w[0] = *reinterpret_cast<const uint16_t*>(p);
        } else if constexpr (MT == 4) {
            const uint2 v = *reinterpret_cast<const uint2*>(p);
            w[0] = v.x;
            w[1] = v.y;
        } else {
            static_assert(MT == 8, "MT is 1, 4 or 8");
            const uint4 v = *reinterpret_cast<const uint4*>(p);
            w[0] = v.x;
            w[1] = v.y;
            w[2] = v.z;
            w[3] = v.w;
        }
    }
    static __device__ __forceinline__ int lane(const uint32_t (&w)[W], int r) {
        if constexpr (MT == 1) return static_cast<int>(w[0]);
        return static_cast<int>((w[r >> 1] >> ((r & 1) * 16)) & 0xffffu);
    }
};

// Issue a 4-byte copy from global to shared memory that completes in the
// background (cp.async); cp_async_wait() waits for the thread's copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The two halves of a cluster barrier (release, acquire).
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One block of the cluster walk: MT rows from m0, NT columns from n0, the
// rank's pattern groups [lo, hi), walked in chunks of chunk_groups<MT>().
// Src gives the rows' codes: Src::Raw holds one pattern group's four raw
// values of one row, src.load(m, kg, raw) issues their loads and
// src.codes(raw, r, q) turns them into four codes of tile row r.
template <int BITS, int MT, bool GROUPED>
struct BsCore {
    static constexpr int W = TableWord<MT>::W;
    static constexpr int KCH = chunk_groups<MT>();
    static constexpr int S = MT * 2;          // bytes of one table word
    static constexpr int ITEMS = KCH * MT / kBsThreads;   // (row, group) items a thread builds

    const BsArgs& a;
    uint16_t* table;
    int* part;                                // grouped: this rank's int32 partials
    float* wsc;                               // grouped: this rank's scales of the tile
    int* recv;                                // sums (grouped: f32 terms) sent to this rank
    float* sums;                              // grouped: the share's running sums
    int rank, m0, n0, n, col, j, tpc, lo, hi, KG;   // [lo, hi): the round's window
    int ch, s;                                // the segment held in cur
    uint32_t cur[BITS][4];                    // its plane words, in flight from start() on
    int tot[MT];

    __device__ BsCore(const BsArgs& args, unsigned char* smem) : a(args) {
        table = reinterpret_cast<uint16_t*>(smem);
        part = reinterpret_cast<int*>(smem + a.part_off);
        wsc = reinterpret_cast<float*>(smem + a.wsc_off);
        recv = reinterpret_cast<int*>(smem + a.recv_off);
        sums = reinterpret_cast<float*>(smem + a.sums_off);
        rank = blockIdx.x;
        m0 = blockIdx.z * MT;
        col = threadIdx.x & ((1 << a.nt_shift) - 1);
        n0 = blockIdx.y << a.nt_shift;
        n = n0 + col;
        j = threadIdx.x >> a.nt_shift;        // warp-uniform: NT >= 32
        tpc = kBsThreads >> a.nt_shift;
        KG = a.K / kGroup;
        window(0, lo, hi);
#pragma unroll
        for (int r = 0; r < MT; ++r) tot[r] = 0;
    }

    // This rank's window of round t: pattern groups [wlo, whi), empty past K.
    __device__ void window(int t, int& wlo, int& whi) const {
        wlo = min(KG, (t * a.C + rank) * a.kgpr);
        whi = min(KG, wlo + a.kgpr);
    }

    __device__ int groups() const { return GROUPED ? (hi - lo) / a.gpg : 1; }

    // Zero the window's partials, issue its first segment's plane loads and
    // (grouped) the copies of its scales, so they are in flight through the
    // prologue and the first table build. With ``arrive`` the block then
    // arrives at the cluster barrier phase that run() waits on before it
    // writes into other ranks' shared memory (a kernel whose prologue holds
    // a cluster barrier passes false; later rounds pass false).
    __device__ void start(bool arrive) {
        const int NT = 1 << a.nt_shift;
        const int words = GROUPED ? groups() * MT * NT : a.share;
        for (int i = threadIdx.x; i < words; i += kBsThreads) (GROUPED ? part : recv)[i] = 0;
        if (arrive) cluster_arrive();
        ch = lo;
        s = j;
        settle(ch, s);
        load(ch, s, cur);
        if (GROUPED) {
            const int n_groups = KG / a.gpg, g_lo = lo / a.gpg;
            for (int i = threadIdx.x; i < groups() * NT; i += kBsThreads) {
                const int lg = i >> a.nt_shift, c = i & (NT - 1);
                if (n0 + c < a.N)
                    cp_async4(wsc + i,
                              a.scales + static_cast<size_t>(n0 + c) * n_groups + g_lo + lg);
            }
        }
    }

    // Move (c, t) to the thread's next segment that exists: the same
    // chunk, else segment j of the next chunk, else past hi.
    __device__ void settle(int& c, int& t) const {
        while (c < hi && t * kSeg >= min(KCH, hi - c)) {
            c += KCH;
            t = j;
        }
    }

    __device__ void load(int c, int t, uint32_t (&pb)[BITS][4]) const {
        const int kg0 = c + t * kSeg;
        const bool live = c < hi && n < a.N;
        const size_t row = static_cast<size_t>(n) * KG + kg0;
        const size_t plane = static_cast<size_t>(a.N) * KG;
#pragma unroll
        for (int p = 0; p < BITS; ++p) {
            if (live && a.vec) {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.planes + p * plane + row));
                pb[p][0] = v.x;
                pb[p][1] = v.y;
                pb[p][2] = v.z;
                pb[p][3] = v.w;
            } else {
#pragma unroll
                for (int w = 0; w < 4; ++w) pb[p][w] = 0;
                if (live) {
                    const int lim = min(c + KCH, hi) - kg0;
#pragma unroll
                    for (int b = 0; b < kSeg; ++b)    // unrolled: pb stays in registers
                        if (b < lim)
                            pb[p][b >> 2] |= static_cast<uint32_t>(a.planes[p * plane + row + b])
                                             << ((b & 3) * 8);
                }
            }
        }
    }

    // Issue the loads of chunk c0's (row, group) items: item u of this
    // thread is i = threadIdx.x + u * kBsThreads, row i % MT (the same row
    // for every u), chunk-local group i / MT. Items past the chunk or the
    // rows stay zero.
    template <class Src>
    __device__ void fetch(const Src& src, int c0, typename Src::Raw (&raw)[ITEMS]) const {
        const int kch = min(KCH, hi - c0);
        const int r = threadIdx.x % MT;
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
            const int g = (threadIdx.x + u * kBsThreads) / MT;
            raw[u] = typename Src::Raw{};
            if (g < kch && m0 + r < a.M) src.load(m0 + r, c0 + g, raw[u]);
        }
    }

    // The 16 subset sums of the items' codes, biased, into chunk c0's
    // tables: entry p of group g at word g * 16 + (p ^ (g & 15)).
    template <class Src>
    __device__ void build(const Src& src, int c0, const typename Src::Raw (&raw)[ITEMS]) const {
        const int npad = (min(KCH, hi - c0) + kSeg - 1) / kSeg * kSeg;
        const int r = threadIdx.x % MT;
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
            const int g = (threadIdx.x + u * kBsThreads) / MT;
            if (g >= npad) break;
            int q[kGroup];
            src.codes(raw[u], r, q);
            int e[kEntries];
            e[0] = 0;
#pragma unroll
            for (int i = 0; i < kGroup; ++i)
#pragma unroll
                for (int p = 0; p < (1 << i); ++p) e[(1 << i) + p] = e[p] + q[i];
#pragma unroll
            for (int p = 0; p < kEntries; ++p)
                table[(g * kEntries + (p ^ (g & (kEntries - 1)))) * MT + r] =
                    static_cast<uint16_t>(e[p] + kBias);
        }
    }

    // Widen n groups' packed plane sums into int32 for every row.
    __device__ void widen(const uint32_t (&acc)[BITS][W], int cnt, int (&v)[MT]) const {
#pragma unroll
        for (int r = 0; r < MT; ++r) {
            int x = cnt * kBias;              // - cnt * kBias * sum_p coef_p
#pragma unroll
            for (int p = 0; p < BITS; ++p)
                x += plane_coef<BITS>(p) * TableWord<MT>::lane(acc[p], r);
            v[r] = x;
        }
    }

    // The lookups of segment (c, t) held in pb: per plane, 16 groups summed
    // in packed lanes, widened at the segment's end and, under group scales
    // (each group's partial going to the rank's shared-memory partials), at
    // every scale group's end where EACH (groups that are not whole
    // segments), else at the segment's end only. A segment starts on a multiple
    // of 16 groups, so group i of it permutes its words by i: the byte
    // offset of pattern pat is (pat ^ i) * S, four made at once from a
    // plane word.
    template <bool EACH>
    __device__ void lookup(int c, int t, const uint32_t (&pb)[BITS][4]) {
        const int kg0 = c + t * kSeg;
        const unsigned char* seg =
            reinterpret_cast<const unsigned char*>(table) + t * kSeg * kEntries * S;
        uint32_t acc[BITS][W];
#pragma unroll
        for (int p = 0; p < BITS; ++p)
#pragma unroll
            for (int w = 0; w < W; ++w) acc[p][w] = 0;
        int since = 0, next = 0;
        if (EACH) next = (kg0 / a.gpg + 1) * a.gpg;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
            // bytes of (pat ^ i) * S for groups 4 q4 .. 4 q4 + 3 (at most 240)
            constexpr uint32_t kMask = 0x0f0f0f0fu * S;
            const uint32_t rot = (((4 * q4) | ((4 * q4 + 1) << 8) | ((4 * q4 + 2) << 16) |
                                   ((4 * q4 + 3) << 24))) * S;
            uint32_t off[BITS];
#pragma unroll
            for (int p = 0; p < BITS; ++p) off[p] = ((pb[p][q4] * S) & kMask) ^ rot;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int i = 4 * q4 + b;
#pragma unroll
                for (int p = 0; p < BITS; ++p) {
                    uint32_t w[W];
                    TableWord<MT>::load_at(seg + i * kEntries * S + ((off[p] >> (8 * b)) & 0xff),
                                           w);
#pragma unroll
                    for (int k = 0; k < W; ++k) acc[p][k] += w[k];
                }
                if constexpr (EACH) {
                    ++since;
                    const bool end = kg0 + i + 1 == next;
                    if (end || i == kSeg - 1) {   // uniform over the warp
                        if (kg0 + i < hi && n < a.N) {
                            int v[MT];
                            widen(acc, since, v);
                            int* dst = part + (((kg0 + i - lo) / a.gpg) * MT << a.nt_shift) + col;
#pragma unroll
                            for (int r = 0; r < MT; ++r) atomicAdd(dst + (r << a.nt_shift), v[r]);
                        }
#pragma unroll
                        for (int p = 0; p < BITS; ++p)
#pragma unroll
                            for (int k = 0; k < W; ++k) acc[p][k] = 0;
                        since = 0;
                        if (end) next += a.gpg;
                    }
                }
            }
        }
        if constexpr (!GROUPED) {
            int v[MT];
            widen(acc, kSeg, v);
#pragma unroll
            for (int r = 0; r < MT; ++r) tot[r] += v[r];
        } else if constexpr (!EACH) {         // the segment lies in one scale group
            if (n < a.N) {
                int v[MT];
                widen(acc, kSeg, v);
                int* dst = part + (((kg0 - lo) / a.gpg) * MT << a.nt_shift) + col;
#pragma unroll
                for (int r = 0; r < MT; ++r) atomicAdd(dst + (r << a.nt_shift), v[r]);
            }
        }
    }

    // Walk the round's window chunk by chunk from the first chunk's fetched
    // items: build the chunk's tables (fetching a later chunk's items
    // first), then look up every segment of the thread, the next one's
    // planes in flight.
    template <class Src>
    __device__ void walk(const Src& src, typename Src::Raw (&raw)[ITEMS]) {
        for (int c0 = lo; c0 < hi; c0 += KCH) {
            if (c0 != lo) fetch(src, c0, raw);
            build(src, c0, raw);
            __syncthreads();
            while (ch == c0) {                // uniform over the warp
                int nc = ch, nt = s + tpc;
                settle(nc, nt);
                uint32_t nxt[BITS][4];
                load(nc, nt, nxt);
                if constexpr (GROUPED) {
                    if (a.gpg % kSeg)
                        lookup<true>(ch, s, cur);
                    else
                        lookup<false>(ch, s, cur);
                } else {
                    lookup<false>(ch, s, cur);
                }
#pragma unroll
                for (int p = 0; p < BITS; ++p)
#pragma unroll
                    for (int w = 0; w < 4; ++w) cur[p][w] = nxt[p][w];
                ch = nc;
                s = nt;
            }
            if (c0 + KCH < hi) __syncthreads();   // the next chunk rewrites the tables
        }
    }

    // Walk every round and merge the ranks' partials on chip, then write
    // the tile: rank o / share owns output o of the MT x NT tile. Per
    // channel (one round) every thread adds its int32 sums into the owner's
    // shared memory (atomics through distributed shared memory: exact in
    // any order), and after one cluster barrier each rank reads only its
    // own shared memory, so no block waits on another to leave: fin(r, m,
    // n, the sum). Under group scales, round by round, every rank sends
    // each scale group's term f32(partial) * scale to the owner, which adds
    // the round's terms in ascending group order onto its running sums
    // (each sum rounded on its own): fin_g(r, m, n, the f32 sum). raw holds
    // the first window's first chunk, fetched; ``started``: a cluster
    // barrier has passed since the block zeroed its sums (else start(true)
    // arrived and this waits).
    template <class Src, class Fin, class FinG>
    __device__ void run(const Src& src, typename Src::Raw (&raw)[ITEMS], bool started, Fin fin,
                        FinG fin_g) {
        cg::cluster_group cluster = cg::this_cluster();
        const int NT = 1 << a.nt_shift;
        const int share = a.share;
        if constexpr (!GROUPED) {
            walk(src, raw);
            if (!started) cluster_wait();     // every rank has zeroed its sums
            if (n < a.N) {
#pragma unroll
                for (int r = 0; r < MT; ++r) {
                    const int o = (r << a.nt_shift) + col, k = o / share;
                    atomicAdd(cluster.map_shared_rank(recv, k) + o - k * share, tot[r]);
                }
            }
            cluster.sync();                   // every sum has arrived
        } else {
            const int n_groups = KG / a.gpg, ngw = a.kgpr / a.gpg;
            for (int i = threadIdx.x; i < share; i += kBsThreads) sums[i] = 0.f;
            for (int t = 0; t < a.rounds; ++t) {
                if (t > 0) {
                    window(t, lo, hi);
                    start(false);
                    fetch(src, lo, raw);
                }
                walk(src, raw);
                cp_async_wait();
                __syncthreads();              // the block's partials and scales are in
                if (t > 0 || !started) cluster_wait();   // the owners may be written
                for (int i = threadIdx.x; i < groups() * MT * NT; i += kBsThreads) {
                    const int lg = i / (MT * NT), o = i - lg * MT * NT;
                    const float term = __fmul_rn(__int2float_rn(part[i]),
                                                 wsc[(lg << a.nt_shift) + (o & (NT - 1))]);
                    const int k = o / share;
                    cluster.map_shared_rank(recv, k)[(rank * ngw + lg) * share + o - k * share] =
                        __float_as_int(term);
                }
                cluster.sync();               // every term of the round has arrived
                const int g0 = t * a.C * ngw, gn = min(a.C * ngw, n_groups - g0);
                for (int i = threadIdx.x; i < share; i += kBsThreads) {
                    float accf = sums[i];
#pragma unroll 8
                    for (int g = 0; g < gn; ++g)   // loads ahead, adds in order
                        accf = __fadd_rn(accf, __int_as_float(recv[g * share + i]));
                    sums[i] = accf;
                }
                if (t + 1 < a.rounds) cluster_arrive();   // the round's terms are read
            }
        }
        for (int i = threadIdx.x; i < share; i += kBsThreads) {
            const int o = rank * share + i;
            const int r = o >> a.nt_shift;
            const int m = m0 + r, nn = n0 + (o & (NT - 1));
            if (o >= MT * NT || m >= a.M || nn >= a.N) continue;
            if constexpr (!GROUPED)
                fin(r, m, nn, recv[i]);
            else
                fin_g(r, m, nn, sums[i]);
        }
    }
};

// Check the tiling a wrapper passes and fill the launch's arguments.
inline cudaError_t bs_args(BsArgs& a, int MT, int NT, int C, int k_per_rank, int group_size,
                           dim3& grid, int& smem) {
    if (a.K < kGroup || a.K % kGroup || a.M < 1 || a.N < 1 ||
        (MT != 1 && MT != 4 && MT != 8) || (NT != 32 && NT != 64 && NT != 128) || C < 1 ||
        C > kMaxBsCluster || k_per_rank < kGroup || k_per_rank % (kGroup * kSeg) ||
        static_cast<int64_t>(C - 1) * k_per_rank >= a.K ||
        (group_size <= 0 && static_cast<int64_t>(C) * k_per_rank < a.K))
        return cudaErrorInvalidValue;
    if (group_size > 0 &&
        (group_size % kGroup || a.K % group_size || k_per_rank % group_size))
        return cudaErrorInvalidValue;
    a.gpg = group_size > 0 ? group_size / kGroup : 0;
    a.nt_shift = NT == 32 ? 5 : NT == 64 ? 6 : 7;
    a.C = C;
    a.kgpr = k_per_rank / kGroup;
    a.rounds = static_cast<int>((a.K + static_cast<int64_t>(C) * k_per_rank - 1) /
                                (static_cast<int64_t>(C) * k_per_rank));
    a.vec = (a.K / kGroup) % kSeg == 0 && reinterpret_cast<uintptr_t>(a.planes) % 16 == 0;
    const BsLayout l = bs_layout(MT, NT, C, a.kgpr, a.gpg);
    a.share = (MT * NT + C - 1) / C;
    a.part_off = l.part_off;
    a.wsc_off = l.wsc_off;
    a.recv_off = l.recv_off;
    a.sums_off = l.sums_off;
    a.scale_off = l.scale_off;
    smem = l.total;
    grid = dim3(C, (a.N + NT - 1) / NT, (a.M + MT - 1) / MT);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    return cudaSuccess;
}
