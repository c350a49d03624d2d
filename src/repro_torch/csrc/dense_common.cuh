// The tiled walk shared by the packed-weight GEMM kernels (lut_gemm.cu,
// dequant_matmul.cu, and expert_gemm.cu with an expert axis): a block owns
// MT rows, NT = 32 * NC columns and one K window of one expert; the C
// windows of a column tile are the ranks of one thread-block cluster, whose
// partials meet in the owners' shared memory. The two inner loops are
// dense_dequant.cuh and dense_lut.cuh.
//
// The tiling (MT, NT, C, the window of kpr units) is chosen by
// kernels/lut_gemm.py::dense_partition (expert_partition for the expert
// GEMMs) and passed in. A unit is what one table read serves: a code
// (dequant_matmul, and lut_gemm except w2a2), or a pair of neighbouring
// codes (lut_gemm w2a2, through a 256-entry pair table).
//
//   grid (C, N/NT, E * M/MT), clusters of C blocks along x: block x is rank
//   x of the column tile, block z = e * (M/MT) + i row tile i of expert e
//   (E 1 for the dense kernels; a block of an expert flagged empty writes
//   zeros and returns, dense_expert). K is cut into windows of kpr units;
//   in round t rank c owns window t * C + c (the last window ragged, later
//   ones empty), and the rounds keep each window's tiles under the
//   shared-memory budget.
//
// One DRAM round trip a round: before its first product every thread has
// issued all of its loads of the window: the weight tile in 16-byte pieces
// into registers (neighbouring threads on neighbouring addresses), then
// stored into shared memory at an odd word pitch; the MT activation rows
// and the scale tile by cp.async; the codebook or product table once a
// block. The activations are staged once and read by all NT columns.
//
// The walk: warp j (a k-lane) takes the 4-byte weight words j, j + 8, ...
// of the window, lane l the columns l, l + 32, ..., l + 32 (NC - 1). All
// lanes of a warp read one word position of 32 columns (the odd pitch puts
// them on 32 banks) and one activation position (a broadcast), so a table
// read indexed (activation unit, weight unit) touches 2^(weight bits)
// consecutive words: no bank conflicts. Each thread keeps one f32 sum per
// (row, column) and adds a word's units in order.
//
// Merge, in a fixed order the plain dequant version replays
// (ref.py::tile_order_matmul): the 8 k-lanes' sums of an output meet in a
// pairwise tree in shared memory, giving the rank's partial; rank o /
// share owns output o of the MT x NT tile, every rank writes its partial
// into the owner's shared memory (distributed shared memory), and after one
// cluster barrier the owner adds the C partials in rank order and applies
// the epilogue. No atomics and no second pass.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

constexpr int kDenseThreads = 256;
constexpr int kLanes = kDenseThreads / 32;    // k-lanes (warps) a block
constexpr int kMaxMt = 8;                     // rows a tile
constexpr int kDenseMinBlocks = 2;            // blocks an SM holds at once (caps 128 registers)
constexpr int kMaxDenseCluster = 8;           // portable cluster size
constexpr int kWPieces = 8;                   // 16-byte weight pieces a thread holds
constexpr int kWTileBytes = kWPieces * 16 * kDenseThreads;   // 32 KB a round

// What the kernels take; sizes in units unless named in bytes. Each operand
// but the table has a leading expert axis of E (1 for the dense kernels).
struct DenseArgs {
    const void* a;                // (E, M, K) activations or (E, M, K/fa) packed codes
    const uint8_t* w;             // (E, N, K/fw) packed weight codes
    const float* table;           // codebook or product LUT (2^(wb + ab),)
    const float* scales;          // (E, N), (E, N, K/G) or null
    float* out;                   // (E, M, N) f32
    int M, N, K;                  // K in units
    int G;                        // group size in units (0: none)
    int MT, C, kpr, rounds;       // rows a tile, ranks, units a window, rounds
    int share;                    // outputs of the tile each rank owns
    int w_row, a_row;             // bytes of a global weight / activation row
    int w_vec, a_vec;             // bytes a copy: 16, 4 or 1
    int w_pitch;                  // words of a weight-tile row (odd)
    int a_pitch;                  // bytes of an activation-tile row
    int s_pitch;                  // floats of a scale-tile row
    int a_off, s_off, t_off, recv_off;   // shared memory (dense_layout)
    int red_off;                  // the k-lanes' sums: past the tiles, or 0 (over them)
};

// The expert kernels' arguments: the walk's, then the expert axis
// (dense_expert). The dense kernels take DenseArgs alone: the walks sit at
// the 128-register cap, and these fields in their struct, or ``active`` as
// a separate parameter of the expert kernels, moved times by up to 15%.
struct ExpertArgs : DenseArgs {
    const unsigned char* active;  // (E,): 0 where no token was dispatched to the expert, or null
    int E;                        // experts
    int s_row;                    // floats of a global scale row: K / G, or 1 per channel
};

// Experts a launch covers: the grid's z counts E x the row tiles.
inline int dense_experts(const DenseArgs&) { return 1; }
inline int dense_experts(const ExpertArgs& a) { return a.E; }

struct DenseLayout {
    int a_off, s_off, t_off, recv_off, red_off, total;
};

// shared memory a block may take with kDenseMinBlocks blocks an SM
constexpr int kDenseSmemBudget = 113 * 1024;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of one block: the round's weight tile (NT rows of w_pitch
// words), activation tile (MT rows) and, grouped, scale tile (NT rows of
// the window's groups); then the table (``table_floats``), what the ranks
// send this rank (C x share f32), and the k-lanes' sums (kLanes x MT x NT
// f32) where the budget holds them, else over the tiles once the walk is
// over (red_off 0: one more barrier). ``static_bytes`` of static shared
// memory (the LUT walk's table) come off the budget.
inline DenseLayout dense_layout(int MT, int NT, int C, int kpr, int w_unit_bits,
                                int a_unit_bits, int G, int table_floats, int static_bytes) {
    const int w_words = kpr * w_unit_bits / 32;
    const int w_pitch = w_words | 1;
    const int wt = round16(NT * w_pitch * 4);
    const int at = round16(MT * (kpr * a_unit_bits / 8));
    const int st = G > 0 ? round16(NT * ((kpr + G - 1) / G + 1) * 4) : 0;
    const int red = kLanes * MT * NT * 4;
    const int share = (MT * NT + C - 1) / C;
    const int rest = round16(table_floats * 4) + round16(C * share * 4);
    if (wt + at + st + rest + red + static_bytes <= kDenseSmemBudget) {
        const int t_off = wt + at + st, recv_off = t_off + round16(table_floats * 4);
        const int red_off = recv_off + round16(C * share * 4);
        return {wt, wt + at, t_off, recv_off, red_off, red_off + red};
    }
    const int tiles = wt + at + st > red ? wt + at + st : red;
    const int t_off = round16(tiles);
    const int recv_off = t_off + round16(table_floats * 4);
    return {wt, wt + at, t_off, recv_off, 0, recv_off + C * share * 4};
}

// Check the tiling a wrapper passes and fill the launch's arguments. The
// window unit is kLanes weight words (128 units at 2 bits, 64 at 4).
inline cudaError_t dense_args(DenseArgs& a, int E, int NT, int w_unit_bits, int a_unit_bits,
                              int table_floats, int static_bytes, dim3& grid, int& smem) {
    const int unit = kLanes * 32 / w_unit_bits;
    if (E < 1 || a.M < 1 || a.N < 1 || a.K < 1 || a.MT < 1 || a.MT > kMaxMt ||
        (NT != 64 && NT != 128) || a.C < 1 || a.C > kMaxDenseCluster || a.kpr < unit || a.kpr % unit ||
        static_cast<int64_t>(a.C) * a.kpr * (a.rounds - 1) >= a.K ||
        static_cast<int64_t>(a.C) * a.kpr * a.rounds < a.K ||
        static_cast<int64_t>(NT) * a.kpr * w_unit_bits / 8 > kWTileBytes)
        return cudaErrorInvalidValue;
    a.w_row = static_cast<int>(static_cast<int64_t>(a.K) * w_unit_bits / 8);
    a.a_row = static_cast<int>(static_cast<int64_t>(a.K) * a_unit_bits / 8);
    const auto ptr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
    a.w_vec = (ptr(a.w) % 16 == 0 && a.w_row % 16 == 0) ? 16
              : (ptr(a.w) % 4 == 0 && a.w_row % 4 == 0) ? 4 : 1;
    a.a_vec = (ptr(a.a) % 16 == 0 && a.a_row % 16 == 0) ? 16
              : (ptr(a.a) % 4 == 0 && a.a_row % 4 == 0) ? 4 : 1;
    a.w_pitch = (a.kpr * w_unit_bits / 32) | 1;
    a.a_pitch = a.kpr * a_unit_bits / 8;
    a.s_pitch = a.G > 0 ? (a.kpr + a.G - 1) / a.G + 1 : 0;
    const DenseLayout l = dense_layout(a.MT, NT, a.C, a.kpr, w_unit_bits, a_unit_bits, a.G,
                                       table_floats, static_bytes);
    a.share = (a.MT * NT + a.C - 1) / a.C;
    a.a_off = l.a_off;
    a.s_off = l.s_off;
    a.t_off = l.t_off;
    a.recv_off = l.recv_off;
    a.red_off = l.red_off;
    smem = l.total;
    const int64_t z = static_cast<int64_t>(E) * ((a.M + a.MT - 1) / a.MT);
    grid = dim3(a.C, (a.N + NT - 1) / NT, static_cast<unsigned>(z));
    if (grid.y > 65535 || z > 65535) return cudaErrorInvalidValue;
    return cudaSuccess;
}

// The launch's arguments before dense_args completes them: every pointer,
// the shapes (K, group_size and k_per_rank in units) and the tiling; the
// rounds of C windows that cover K.
inline DenseArgs dense_make_args(const void* a, const void* w, const void* table,
                                 const void* scales, void* out, int M, int N, int K,
                                 int group_size, int MT, int C, int k_per_rank) {
    DenseArgs d{};
    d.a = a;
    d.w = static_cast<const uint8_t*>(w);
    d.table = static_cast<const float*>(table);
    d.scales = static_cast<const float*>(scales);
    d.out = static_cast<float*>(out);
    d.M = M;
    d.N = N;
    d.K = K;
    d.G = group_size;
    d.MT = MT;
    d.C = C;
    d.kpr = k_per_rank;
    d.rounds = k_per_rank > 0 && C > 0
                   ? static_cast<int>((static_cast<int64_t>(K) + static_cast<int64_t>(C) *
                                                                     k_per_rank - 1) /
                                      (static_cast<int64_t>(C) * k_per_rank))
                   : 0;
    return d;
}

// Copies from global to shared memory that complete in the background
// (cp.async, 16 or 4 bytes); dense_wait() waits for the thread's copies.
__device__ __forceinline__ void dense_cp16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void dense_cp4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void dense_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The two halves of a cluster barrier (release, acquire).
__device__ __forceinline__ void dense_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void dense_cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// i / d for 0 <= i < 2^21 without an integer division (a runtime divisor
// costs a chain of some 20 dependent instructions): the float quotient is
// within one of the true one, and one step each way corrects it.
struct DivBy {
    int d;
    float inv;
    __device__ explicit DivBy(int divisor) : d(divisor), inv(1.0f / static_cast<float>(divisor)) {}
    __device__ __forceinline__ int operator()(int i) const {
        int q = __float2int_rz(static_cast<float>(i) * inv);
        q += (q + 1) * d <= i;
        q -= q * d > i;
        return q;
    }
};

// The expert axis: block z = e * row_tiles + i owns row tile i of expert e.
// Moves a's pointers to expert e's operands and returns i. Where the
// dispatch left expert e empty (active[e] == 0) the block instead writes
// zeros to its share of the output tile, loads no weights and returns -1:
// the ranks of a cluster share z, so all of them return, before any
// cluster barrier.
__device__ __forceinline__ int dense_expert(ExpertArgs& a, int NT) {
    const int row_tiles = (a.M + a.MT - 1) / a.MT;
    const int e = blockIdx.z / row_tiles, i = blockIdx.z - e * row_tiles;
    a.out += static_cast<size_t>(e) * a.M * a.N;
    if (a.active != nullptr && !__ldg(a.active + e)) {
        const int m0 = i * a.MT, rows = min(a.MT, a.M - m0);
        const int n0 = blockIdx.y * NT, cols = min(NT, a.N - n0);
        for (int o = blockIdx.x * kDenseThreads + threadIdx.x; o < rows * cols;
             o += a.C * kDenseThreads) {
            const int r = o / cols;
            a.out[static_cast<size_t>(m0 + r) * a.N + n0 + o - r * cols] = 0.f;
        }
        return -1;
    }
    a.a = static_cast<const unsigned char*>(a.a) + static_cast<size_t>(e) * a.M * a.a_row;
    a.w += static_cast<size_t>(e) * a.N * a.w_row;
    if (a.scales != nullptr) a.scales += static_cast<size_t>(e) * a.N * a.s_row;
    return i;
}

// The block's place in the grid (row tile ``row_tile`` of its expert) and
// its window of round t.
struct DenseTile {
    int rank, n0, m0, rows, cols;     // rows / cols of the tile that exist
    int lo, hi;                       // the round's window [lo, hi), in units
    DivBy group;                      // unit -> its scale group (G, or 1 without)
    int g_lo;                         // the window's first group
    __device__ DenseTile(const DenseArgs& a, int NT, int row_tile) : group(a.G > 0 ? a.G : 1) {
        rank = blockIdx.x;
        n0 = blockIdx.y * NT;
        m0 = row_tile * a.MT;
        rows = min(a.MT, a.M - m0);
        cols = min(NT, a.N - n0);
    }
    __device__ void window(const DenseArgs& a, int t) {
        lo = min(a.K, (t * a.C + rank) * a.kpr);
        hi = min(a.K, lo + a.kpr);
        g_lo = group(lo);
    }
};

// Issue the loads of the window's weight tile: ``v`` gets this thread's
// 16-byte pieces (piece i = threadIdx.x + u * kDenseThreads of the tile,
// row-major). Only with w_vec == 16; dense_store_weights puts them in place.
template <int WUB>
__device__ __forceinline__ void dense_load_weights(const DenseArgs& a, const DenseTile& t,
                                                   const DivBy& per, uint4 (&v)[kWPieces]) {
    const int total = t.cols * per.d;
    const uint8_t* src = a.w + static_cast<size_t>(t.n0) * a.w_row + t.lo * WUB / 8;
#pragma unroll
    for (int u = 0; u < kWPieces; ++u) {
        const int i = threadIdx.x + u * kDenseThreads;
        if (i < total) {
            const int r = per(i), p = i - r * per.d;
            v[u] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * a.w_row) + p);
        }
    }
}

template <int WUB>
__device__ __forceinline__ void dense_store_weights(const DenseArgs& a, const DenseTile& t,
                                                    const DivBy& per, const uint4 (&v)[kWPieces],
                                                    uint32_t* wt) {
    const int total = t.cols * per.d;
#pragma unroll
    for (int u = 0; u < kWPieces; ++u) {
        const int i = threadIdx.x + u * kDenseThreads;
        if (i < total) {
            const int r = per(i), p = i - r * per.d;
            uint32_t* d = wt + r * a.w_pitch + 4 * p;
            d[0] = v[u].x;
            d[1] = v[u].y;
            d[2] = v[u].z;
            d[3] = v[u].w;
        }
    }
}

// The weight tile where its rows are not 16-byte aligned: 4-byte words, or
// single bytes, loaded and stored one by one.
template <int WUB>
__device__ void dense_copy_weights_narrow(const DenseArgs& a, const DenseTile& t, uint32_t* wt) {
    const int bytes = (t.hi - t.lo) * WUB / 8;
    const uint8_t* src = a.w + static_cast<size_t>(t.n0) * a.w_row + t.lo * WUB / 8;
    if (bytes == 0) return;
    if (a.w_vec == 4) {
        const DivBy per(bytes / 4);
        for (int i = threadIdx.x; i < t.cols * per.d; i += kDenseThreads) {
            const int r = per(i), p = i - r * per.d;
            wt[r * a.w_pitch + p] =
                __ldg(reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(r) * a.w_row) + p);
        }
    } else {
        uint8_t* wb = reinterpret_cast<uint8_t*>(wt);
        const DivBy per(bytes);
        for (int i = threadIdx.x; i < t.cols * bytes; i += kDenseThreads) {
            const int r = per(i), p = i - r * bytes;
            wb[r * a.w_pitch * 4 + p] = __ldg(src + static_cast<size_t>(r) * a.w_row + p);
        }
    }
}

// Issue the copies of the window's activation rows (the tile's rows, units
// [lo, hi)) into the activation tile.
template <int AUB>
__device__ __forceinline__ void dense_copy_rows(const DenseArgs& a, const DenseTile& t,
                                                unsigned char* at) {
    const int bytes = (t.hi - t.lo) * AUB / 8;
    if (bytes == 0) return;
    const unsigned char* src = static_cast<const unsigned char*>(a.a) +
                               static_cast<size_t>(t.m0) * a.a_row + t.lo * AUB / 8;
    const int vec = a.a_vec;
    const DivBy per(bytes / vec);
    for (int i = threadIdx.x; i < t.rows * per.d; i += kDenseThreads) {
        const int r = per(i), p = i - r * per.d;
        const unsigned char* s = src + static_cast<size_t>(r) * a.a_row + p * vec;
        unsigned char* d = at + r * a.a_pitch + p * vec;
        if (vec == 16)
            dense_cp16(d, s);
        else if (vec == 4)
            dense_cp4(d, s);
        else
            *d = *s;
    }
}

// Issue the copies of the window's group scales: column c's scales of
// groups lo / G .. (hi - 1) / G at st[c * s_pitch + g - lo / G].
__device__ __forceinline__ void dense_copy_scales(const DenseArgs& a, const DenseTile& t,
                                                  float* st) {
    if (t.hi <= t.lo) return;
    const int n_groups = t.group(a.K);
    const DivBy ng(t.group(t.hi - 1) - t.g_lo + 1);
    for (int i = threadIdx.x; i < t.cols * ng.d; i += kDenseThreads) {
        const int c = ng(i), g = i - c * ng.d;
        dense_cp4(st + c * a.s_pitch + g,
                  a.scales + static_cast<size_t>(t.n0 + c) * n_groups + t.g_lo + g);
    }
}

// Stage round t's tiles: issue every load of the window, then put the
// weight pieces in place and wait for the copies. ``extra`` runs between
// the issue and the wait (the block's first round loads its table there).
template <int WUB, int AUB, bool GROUPED, class Extra>
__device__ __forceinline__ void dense_stage(const DenseArgs& a, DenseTile& t, int round,
                                            unsigned char* smem, Extra extra) {
    t.window(a, round);
    uint32_t* wt = reinterpret_cast<uint32_t*>(smem);
    uint4 v[kWPieces];
    const DivBy per(max(1, (t.hi - t.lo) * WUB / 8 / 16));    // 16-byte pieces a row
    if (a.w_vec == 16 && t.hi > t.lo) dense_load_weights<WUB>(a, t, per, v);
    dense_copy_rows<AUB>(a, t, smem + a.a_off);
    if (GROUPED) dense_copy_scales(a, t, reinterpret_cast<float*>(smem + a.s_off));
    extra();
    if (a.w_vec != 16)
        dense_copy_weights_narrow<WUB>(a, t, wt);
    else if (t.hi > t.lo)
        dense_store_weights<WUB>(a, t, per, v, wt);
    dense_wait();
    __syncthreads();
}

// Launch ``kernel`` on ``grid`` in clusters of C blocks along x (through
// launch_cluster), or, for C == 1, as a plain launch: the kernels then skip
// every cluster barrier. With ``clusters`` set, write the clusters (blocks
// for C == 1) the card holds at once there instead of launching. A block
// above 48 KB of shared memory in all, ``static_bytes`` of it static,
// needs the kernel's dynamic limit raised first.
template <typename... Params, typename... Args>
cudaError_t dense_launch(void (*kernel)(Params...), dim3 grid, int C, int smem, int static_bytes,
                         cudaStream_t stream, int* clusters, Args... args) {
    if (smem + static_bytes > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    if (C > 1 || clusters)
        return launch_cluster(kernel, grid, kDenseThreads, C, smem, stream, clusters, args...);
    kernel<<<grid, kDenseThreads, smem, stream>>>(args...);
    return cudaGetLastError();
}

// The 8 k-lanes' sums of output o meet in a pairwise tree:
// ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7)).
__device__ __forceinline__ float dense_lane_sum(const float* red, int stride, int o) {
    float v[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) v[j] = red[j * stride + o];
#pragma unroll
    for (int w = 1; w < kLanes; w *= 2)
#pragma unroll
        for (int j = 0; j < kLanes; j += 2 * w) v[j] = __fadd_rn(v[j], v[j + w]);
    return v[0];
}

// After the last round: the k-lanes' sums acc[r][i] (row r, column lane +
// 32 i) meet in shared memory (dense_lane_sum); each rank writes its
// partial of output o into rank o / share's receive buffer; after one
// cluster barrier the owner adds the C partials in rank order and stores
// fin(m, n, sum). The block arrived at the cluster barrier when it started
// (dense_arrive), so every rank is running when the partials are sent.
// With one rank the block stores its partials itself.
template <int NC, class Fin>
__device__ __forceinline__ void dense_merge(const DenseArgs& a, const DenseTile& t,
                                            unsigned char* smem,
                                            const float (&acc)[kMaxMt][NC], Fin fin) {
    constexpr int NT = 32 * NC;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* red = reinterpret_cast<float*>(smem + a.red_off);
    if (a.red_off == 0) __syncthreads();      // every warp is done with the tiles
#pragma unroll
    for (int r = 0; r < kMaxMt; ++r)
        if (r < t.rows)
#pragma unroll
            for (int i = 0; i < NC; ++i) red[(warp * a.MT + r) * NT + lane + 32 * i] = acc[r][i];
    __syncthreads();
    const int outs = t.rows * NT;
    if (a.C == 1) {
        for (int o = threadIdx.x; o < outs; o += kDenseThreads) {
            const int r = o / NT, c = o - r * NT;
            if (c >= t.cols) continue;
            fin(t.m0 + r, t.n0 + c, dense_lane_sum(red, a.MT * NT, o));
        }
        return;
    }
    dense_cluster_wait();                     // every rank has started
    cg::cluster_group cluster = cg::this_cluster();
    float* recv = reinterpret_cast<float*>(smem + a.recv_off);
    const DivBy share(a.share);
    for (int o = threadIdx.x; o < outs; o += kDenseThreads) {
        const float v = dense_lane_sum(red, a.MT * NT, o);
        const int k = share(o);
        cluster.map_shared_rank(recv, k)[t.rank * a.share + o - k * a.share] = v;
    }
    cluster.sync();                           // every partial has arrived
    for (int i = threadIdx.x; i < a.share; i += kDenseThreads) {
        const int o = t.rank * a.share + i;
        if (o >= outs) break;
        const int r = o / NT, c = o - r * NT;
        if (c >= t.cols) continue;
        float v = recv[i];
        for (int k = 1; k < a.C; ++k) v = __fadd_rn(v, recv[k * a.share + i]);
        fin(t.m0 + r, t.n0 + c, v);
    }
}
