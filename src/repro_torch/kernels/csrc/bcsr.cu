// Blocked (BCSR, BCSC) leaves for Hopper (sm_90a): SpMV, SpMM and SDDMM
// over the lowered path's stacked per-piece streams of stored blocks,
// batched over pieces. Each stored block e of piece p has a block-row id
// brow[p, e], a block-column bcol[p, e] and a dense (br, bc) f32 tile. One
// kernel of each serves both distribution strategies: under rows the
// block-row ids are expanded from the shard's pos array at lower time,
// under nnz they are the shard's block-rows rebased to its window and
// clipped, as the reference's emitter does (padding slots carry the
// dropped id max_brows).
//
// bcsr_spmv replaces the TPU kernel src/repro/kernels/bcsr.py:68 bcsr_spmv,
// bcsr_spmm src/repro/kernels/bcsr.py:118 bcsr_spmm and bcsr_sddmm
// src/repro/kernels/bcsr.py:160 bcsr_sddmm.
//
// What bounds them on this card: bytes. A stored block moves its tile
// (br.bc.4 B) and two ids; SpMV reads bc entries of c and writes br of y,
// SpMM reads a (bc, J) block of C and writes a (br, J) block of Y, SDDMM
// reads br rows of C and bc rows of D (K each) and writes a tile. At
// (4, 4) blocks, J = K = 32, the flops (2.br.bc.J per block for SpMM,
// 2.br.bc.K for SDDMM) are an order of magnitude below the byte time in
// f32, so the CUDA cores suffice and the tensor cores (TF32 would break the
// f32 tolerance) are left for later.
//
// What the design does about it: the TPU kernels regroup the blocks into
// bcsr_ell_pack groups and reduce block-rows with one-hot matmuls, because
// the TPU has no scatter (layout.py:1-22). Here the stream is read as it
// is. A power-law block pattern puts a third of a million blocks in one
// block-row, so the reductions are cut into fixed 128-block segments, not
// block-rows, and folded deterministically by segment_fold.cuh, as
// spmm_coo_nnz and spmttkrp_coo are:
//  - Phase 1 (per segment): a run of equal block-rows that lies in the
//    segment alone is written to the output directly. A run that crosses
//    a segment edge leaves its partial in tail[seg] of the segment where it
//    starts (even at that segment's first block) and in head[seg] of every
//    later segment it reaches, so every segment wholly inside one
//    block-row writes its head.
//    bcsr_spmm: a warp per (segment, 32-wide tile of j), lanes on j, each
//    lane holding the br sums of its column, so every gathered line of C
//    (one 128-byte line across the warp per block-column offset c at
//    J = 32) serves all br rows of the tile. No shared memory and no
//    barrier: the ids come in with one coalesced load per 32 blocks and
//    are broadcast by shuffle; the tile is read by warp-uniform loads
//    (16-byte ones where the tile allows). The block the main path runs,
//    (4, 4), is a template argument: its tile and C lines are loaded
//    before the block's run-end test and FMAs. Any other block takes a
//    generic instance with bc at run time and warps over groups of 8 rows.
//    Each (r, j) sum adds one fma per c, c in order
//    within a block, blocks in stream order, from 0 at each run.
//    bcsr_spmv (J = 1), the (4, 4) block: a warp per segment, lanes on
//    stored blocks, each lane with its block's four row sums: each tile's
//    64 bytes are read once by four 16-byte loads (a warp's loads cover
//    32 contiguous tiles), each block's c quad by one 16-byte gather and
//    the ids by one coalesced load per 32 blocks, all before the FMAs. A
//    segmented shuffle scan over the 32 blocks sums each run's rows, and
//    the open run is carried from chunk to chunk (details at the kernel).
//    Any other block, or a tile or c base off a 16-byte boundary, takes
//    the generic instance: a warp per (segment, r), lanes on stored
//    blocks, the same scan over 32 blocks a chunk.
//  - The fold (segment_fold::fold_rows<128>, W = br or br.J outputs a
//    block-row): group sums of 64 heads, then a thread per segment edge
//    takes each block-row that crosses edges at its first edge and writes
//    tail[first] + the heads before the first whole group + the groups'
//    sums + the heads after, in that order: the longest block-row of the
//    main path (2,589 segments) folds 40 group sums and at most 126 heads.
//    (bcsr_fold, which it replaced, added a block-row's heads one at a
//    time on one thread: 0.151 of bcsr_spmm's 0.814 ms on the spmm_bcsr
//    rows cell, NVIDIA H100 80GB HBM3 at 700 W.)
//  bcsr_sddmm: outputs never overlap, so there is no reduction across
//    blocks. A warp takes 64 consecutive stored blocks, lanes on (column,
//    k-quad), with 16-byte gathers of Dt, several blocks' in flight before
//    any FMA, and the C rows of the current block-row held in registers
//    while the warp's blocks stay in it (D is transposed once at lower
//    time, so both are contiguous in k); a xor tree sums each column's
//    lanes, and each tile is stored once (details at the kernel).
// Every output is written once, with no float atomics, so results repeat
// bit for bit. Offsets into the outputs are int64.
//
// Contract of bcsr_spmv / bcsr_spmm: block-row ids are non-decreasing
// within a piece; ids below 0 or at/after R = max_brows are dropped, and
// the output is zeroed by the caller. Block-columns (and bcsr_sddmm's
// block-rows) are clamped into the grid; padding slots hold zero tiles.
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "segment_fold.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kSeg = 128;       // stored blocks per segment

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// one piece's block-row ids, cut into kSeg-long segments
struct Stream {
    const int* brow;
    int64_t N;
    int64_t nseg;
    __device__ int64_t lo(int64_t s) const { return s * kSeg; }
    __device__ int64_t hi(int64_t s) const {
        const int64_t h = (s + 1) * kSeg;
        return h < N ? h : N;
    }
    __device__ int first(int64_t s) const { return __ldg(brow + s * kSeg); }
    __device__ int last(int64_t s) const { return __ldg(brow + hi(s) - 1); }
    // does the run of segment s's first (last) id go on beyond it?
    __device__ bool open_lo(int64_t s) const {
        return s > 0 && __ldg(brow + lo(s) - 1) == first(s);
    }
    __device__ bool open_hi(int64_t s) const {
        return hi(s) < N && __ldg(brow + hi(s)) == last(s);
    }
};

// Where a segment's run of block-row `row` goes, in segment_fold.cuh's
// convention: the first run, when it began in an earlier segment, to head;
// the last run (`at_end`), when it goes on in a later one, to tail (unless
// it is also the first run that began earlier); any other run of an id in
// [0, R) to the output row; a dropped id nowhere (nullptr).
struct Slots {
    float* head;          // this segment's head, tail and output rows,
    float* tail;          // each at the caller's first output
    float* out;
    int64_t W;            // outputs per block-row
    int first, R;
    bool open_lo, open_hi;
    __device__ float* at(int row, bool at_end) const {
        if (row == first && open_lo) return head;
        if (at_end && open_hi) return tail;
        return row >= 0 && row < R ? out + int64_t(row) * W : nullptr;
    }
};

// dst[k] = src[k] for k < T (a tile, or rows of one), read by warp-uniform
// loads, or 0 where !use; 16-byte loads when T % 4 == 0 (src then 16-byte
// aligned: checked at the entry)
template <int T>
__device__ __forceinline__ void load_tile(float (&dst)[T],
                                          const float* __restrict__ src,
                                          bool use) {
    if constexpr (T % 4 == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int i = 0; i < T / 4; ++i) {
            const float4 v = use ? __ldg(s4 + i) : make_float4(0, 0, 0, 0);
            dst[4 * i] = v.x;
            dst[4 * i + 1] = v.y;
            dst[4 * i + 2] = v.z;
            dst[4 * i + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < T; ++i) dst[i] = use ? __ldg(src + i) : 0.f;
    }
}

// grid (ceil(nseg * n_jt * n_rg / 8), P), 256 threads: a warp per
// (segment, 32-wide tile of j, group of BR rows), lanes on j. BC > 0: the
// block is (BR, BC) exactly (n_rg = 1). BC == 0: bc at run time, rows
// r0 .. r0 + nr - 1. Gathering the next block before this one's FMAs does
// not pay: at (4, 4) two blocks in flight took 94 registers (16 warps an
// SM) and phase 1 0.78 ms, one block 62 registers (32 warps) and 0.56 ms
// (H100 SXM).
template <int BR, int BC>
__global__ void __launch_bounds__(kThreads)
bcsr_spmm_phase1(const int* __restrict__ brow, const int* __restrict__ bcol,
                 const float* __restrict__ tiles, const float* __restrict__ C,
                 float* __restrict__ head, float* __restrict__ tail,
                 float* __restrict__ Y, int64_t N, int br, int bc,
                 int grid_cols, int J, int R, int n_jt, int n_rg,
                 int64_t nseg) {
    const int lane = threadIdx.x % kWarp;
    const int64_t wid = int64_t(blockIdx.x) * (kThreads / kWarp)
                        + threadIdx.x / kWarp;
    const int per_seg = n_jt * n_rg;
    if (wid >= nseg * per_seg) return;           // warp-uniform
    const int64_t p = blockIdx.y;
    const int64_t seg = wid / per_seg;
    const int jt = int(wid % per_seg) / n_rg;
    const int r0 = int(wid % per_seg) % n_rg * BR;
    const int nbc = BC > 0 ? BC : bc;
    const int nr = BC > 0 ? BR : min(BR, br - r0);
    const int j = jt * kWarp + lane;
    const bool live = j < J;
    const Stream st{brow + p * N, N, nseg};
    const int64_t lo = st.lo(seg), hi = st.hi(seg);
    const int first = st.first(seg);
    if (first >= R || st.last(seg) < 0) return;   // warp-uniform: dropped
    const int tile = br * nbc;
    const int* pc = bcol + p * N;
    const float* pt = tiles + p * N * tile + r0 * nbc;   // row r0 of a tile
    const float* Cj = C + j;
    const int64_t W = int64_t(br) * J;
    const int64_t w0 = int64_t(r0) * J + j;
    const int64_t edge = (p * nseg + seg) * W + w0;
    const Slots slots{head + edge, tail + edge, Y + p * int64_t(R) * W + w0,
                      W, first, R, st.open_lo(seg), st.open_hi(seg)};
    float acc[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = 0.f;
    int cur = first;
    auto put = [&](float* dst) {                 // the run's sums, rows r0..
        if (!live || dst == nullptr) return;
#pragma unroll
        for (int r = 0; r < BR; ++r)
            if (r < nr) dst[int64_t(r) * J] = acc[r];
    };
    auto next_run = [&](int row) {               // warp-uniform: a run ends
        put(slots.at(cur, false));
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] = 0.f;
        cur = row;
    };
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        int row_l = 0, col_l = 0;
        if (lane < cnt) {
            row_l = st.brow[base + lane];
            col_l = int(clamp_index(pc[base + lane], grid_cols));
        }
        const float* ct = pt + base * tile;      // this chunk's tiles
        for (int t = 0; t < cnt; ++t) {
            const int row = __shfl_sync(0xffffffffu, row_l, t);
            const int col = __shfl_sync(0xffffffffu, col_l, t);
            const bool use = row >= 0 && row < R;      // else dropped
            const float* cr = Cj + int64_t(col) * nbc * J;
            if constexpr (BC > 0) {
                float tv[BR * BC], cv[BC];               // loaded first
                load_tile(tv, ct + t * tile, use);
#pragma unroll
                for (int c = 0; c < BC; ++c)
                    cv[c] = use && live ? __ldg(cr + int64_t(c) * J) : 0.f;
                if (row != cur) next_run(row);
                if (!use) continue;
#pragma unroll
                for (int c = 0; c < BC; ++c)
#pragma unroll
                    for (int r = 0; r < BR; ++r)
                        acc[r] = fmaf(tv[r * BC + c], cv[c], acc[r]);
            } else {
                if (row != cur) next_run(row);
                if (!use) continue;
                const float* tr = ct + t * tile;
                for (int c = 0; c < nbc; ++c) {
                    const float x = live ? __ldg(cr + int64_t(c) * J) : 0.f;
#pragma unroll
                    for (int r = 0; r < BR; ++r)
                        if (r < nr)
                            acc[r] = fmaf(__ldg(tr + r * nbc + c), x, acc[r]);
                }
            }
        }
    }
    put(slots.at(cur, true));
}

// Inclusive scan over the lanes of equal key; keys are non-decreasing
// across the lanes, so an equal key d lanes back means the whole stretch
// between is one run.
__device__ __forceinline__ float segmented_scan(float v, int key, int lane) {
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, d);
        const int k = __shfl_up_sync(0xffffffffu, key, d);
        if (lane >= d && k == key) v += u;
    }
    return v;
}

// The generic SpMV instance. grid (ceil(nseg * br * 32 / 256), P), 256
// threads: a warp per (seg, r), lanes on stored blocks.
__global__ void bcsr_spmv_phase1(const int* __restrict__ brow,
                                 const int* __restrict__ bcol,
                                 const float* __restrict__ tiles,
                                 const float* __restrict__ cvec,
                                 float* __restrict__ head,
                                 float* __restrict__ tail,
                                 float* __restrict__ y,
                                 int64_t N, int br, int bc, int grid_cols,
                                 int R, int64_t nseg) {
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int64_t wid = int64_t(blockIdx.x) * (kThreads / kWarp)
                        + threadIdx.x / kWarp;
    if (wid >= nseg * br) return;                // warp-uniform
    const int64_t seg = wid / br;
    const int r = int(wid % br);
    const Stream st{brow + p * N, N, nseg};
    const int64_t lo = st.lo(seg), hi = st.hi(seg);
    const int first = st.first(seg);
    if (first >= R || st.last(seg) < 0) return;   // warp-uniform: dropped
    const int tile = br * bc;
    const int* pc = bcol + p * N;
    const float* pt = tiles + p * N * tile;
    const int64_t edge = (p * nseg + seg) * br + r;
    const Slots slots{head + edge, tail + edge, y + p * int64_t(R) * br + r,
                      br, first, R, st.open_lo(seg), st.open_hi(seg)};
    int cur = first;
    float carry = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        const int64_t e = base + lane;
        int key = INT_MAX;                       // past every id
        float v = 0.f;
        if (lane < cnt) {
            key = st.brow[e];
            if (key >= 0 && key < R) {
                const float* tr = pt + e * tile + r * bc;
                const float* cv = cvec + clamp_index(pc[e], grid_cols) * bc;
                for (int c = 0; c < bc; ++c) v += tr[c] * __ldg(cv + c);
            }
        }
        if (__shfl_sync(0xffffffffu, key, 0) != cur) {
            // the carried run ended with the previous chunk
            float* dst = slots.at(cur, false);
            if (lane == 0 && dst) *dst = carry;
            carry = 0.f;
        }
        v = segmented_scan(v, key, lane);
        const int next = __shfl_down_sync(0xffffffffu, key, 1);
        const float total = v + (key == cur ? carry : 0.f);
        if (lane < cnt - 1 && next != key) {     // a run ends in the chunk
            float* dst = slots.at(key, false);
            if (dst) *dst = total;
        }
        carry = __shfl_sync(0xffffffffu, total, cnt - 1);   // runs on
        cur = __shfl_sync(0xffffffffu, key, cnt - 1);
    }
    float* dst = slots.at(cur, true);
    if (lane == 0 && dst) *dst = carry;
}

// The (4, 4) SpMV instance. grid (ceil(nseg * 32 / 256), P), 256 threads:
// a warp per segment, lanes on stored blocks, each lane with its block's
// four row sums. Per 32-block chunk, lane t loads the id and block-column
// of block t, its tile as four 16-byte loads (the warp's loads cover the
// chunk's 2 KB of tiles) and its c quad as one 16-byte gather, all before
// any FMA; then per row r the dot is x.x first, then y, z, w by fma. As in
// the generic instance: if block 0 starts another block-row than the
// carried run's, the carried run is written; a segmented inclusive scan
// over the chunk's 32 lanes (shuffles 1 .. 16 up, among equal ids) sums
// each run's four rows; a run that ends inside the chunk is written (scan
// + carry when it continues the carried run) as one 16-byte store; the
// chunk's last run is carried on. So a run's sum depends only on where its
// blocks fall in the stream. (On an NVIDIA H100 80GB HBM3 at 700 W, phase 1
// of the spmv_bcsr cells: this layout, 52 registers, 0.064 ms; lanes on
// (block, row) with 8 blocks a step and four steps' loads ahead, 73
// registers, 0.075; two chunks' loads ahead, 0.065.)
__global__ void __launch_bounds__(kThreads)
bcsr_spmv_phase1_44(const int* __restrict__ brow,
                    const int* __restrict__ bcol,
                    const float* __restrict__ tiles,
                    const float* __restrict__ cvec,
                    float* __restrict__ head, float* __restrict__ tail,
                    float* __restrict__ y, int64_t N, int grid_cols, int R,
                    int64_t nseg) {
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int64_t seg = int64_t(blockIdx.x) * (kThreads / kWarp)
                        + threadIdx.x / kWarp;
    if (seg >= nseg) return;                     // warp-uniform
    const Stream st{brow + p * N, N, nseg};
    const int64_t lo = st.lo(seg), hi = st.hi(seg);
    const int first = st.first(seg);
    if (first >= R || st.last(seg) < 0) return;   // warp-uniform: dropped
    const int* pc = bcol + p * N;
    const float4* pt = reinterpret_cast<const float4*>(tiles + p * N * 16);
    const float4* c4 = reinterpret_cast<const float4*>(cvec);
    const int64_t edge = (p * nseg + seg) * 4;
    const Slots slots{head + edge, tail + edge, y + p * int64_t(R) * 4, 4,
                      first, R, st.open_lo(seg), st.open_hi(seg)};
    auto put = [](float* dst, const float (&v)[4]) {   // one 16-byte store
        if (dst) *reinterpret_cast<float4*>(dst) =
            make_float4(v[0], v[1], v[2], v[3]);
    };
    int cur = first;
    float carry[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        const int64_t e = base + lane;
        const int k = lane < cnt ? st.brow[e] : INT_MAX;   // past every id
        const bool use = k >= 0 && k < R;        // else dropped
        float4 t[4], c;                          // every load first
#pragma unroll
        for (int r = 0; r < 4; ++r)
            t[r] = use ? __ldg(pt + e * 4 + r) : make_float4(0, 0, 0, 0);
        c = use ? __ldg(c4 + clamp_index(pc[e], grid_cols))
                : make_float4(0, 0, 0, 0);
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            v[r] = t[r].x * c.x;
            v[r] = fmaf(t[r].y, c.y, v[r]);
            v[r] = fmaf(t[r].z, c.z, v[r]);
            v[r] = fmaf(t[r].w, c.w, v[r]);
        }
        if (__shfl_sync(0xffffffffu, k, 0) != cur) {
            // the carried run ended with the previous chunk
            if (lane == 0) put(slots.at(cur, false), carry);
#pragma unroll
            for (int r = 0; r < 4; ++r) carry[r] = 0.f;
        }
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
            const int kw = __shfl_up_sync(0xffffffffu, k, d);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float w = __shfl_up_sync(0xffffffffu, v[r], d);
                if (lane >= d && kw == k) v[r] += w;
            }
        }
        const int next = __shfl_down_sync(0xffffffffu, k, 1);
        float total[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
            total[r] = k == cur ? v[r] + carry[r] : v[r];
        if (lane < cnt - 1 && next != k)         // a run ends in the chunk
            put(slots.at(k, false), total);
#pragma unroll
        for (int r = 0; r < 4; ++r)              // the last run goes on
            carry[r] = __shfl_sync(0xffffffffu, total[r], cnt - 1);
        cur = __shfl_sync(0xffffffffu, k, cnt - 1);
    }
    if (lane == 0) put(slots.at(cur, true), carry);
}

// bcsr_sddmm: a warp per (run of kSdBlocks consecutive stored blocks of a
// piece, row group of kSdRows rows, tile of S columns), lanes on (column
// slot, k-quad): G lanes a column (G = K / 4 up to a power of two, at most
// 32), S = 32 / G columns. A (4, 4) block at K = 32 is one row group and one
// column tile (G = 8, S = 4), so its whole tile is one warp step; larger
// blocks take more warps, each walking the same run of blocks. The warp
// takes its blocks kSdU at a time: per k tile of 4G floats, the kSdU blocks'
// Dt quads (16-byte loads, one per lane and block; VEC) and their tile
// values are all loaded before any FMA; each lane holds the C quads of its
// k-quad for the kSdRows rows of the current (block-row, k tile) in
// registers and reloads them only when that key changes, so consecutive
// blocks of one block-row gather C once (the result does not depend on the
// ids' order; only the reuse does). Lane (slot, q) sums its quad's four
// products into one partial per row (fma, in k order); a tree of log2(G)
// xor shuffles sums the G lanes of a column; lane q of a column then
// writes rows q, q + G, ... of the group, out = tile * sum, so a (4, 4)
// block's 16 outputs go out as one 64-byte store. !VEC (K % 4 != 0, or C
// or Dt off a 16-byte boundary) reads the quads as four 4-byte loads.
// Outputs never overlap and nothing is atomic: the bits repeat from launch
// to launch. (On an NVIDIA H100 80GB HBM3 at 700 W, sddmm_bcsr nnz cell: a
// first version gave one warp every (row group, column tile) step of its
// blocks, decoded per step: 155-187 registers, 8 warps an SM, 1.42 ms;
// this one 124-128 registers, 0.82 ms. Of kSdU = 2, 4 and 8 blocks in
// flight, 4 was fastest; capped at 80 registers it spilled and gained
// nothing.)
constexpr int kSdRows = 4;        // rows of C a lane holds
constexpr int kSdU = 4;           // blocks gathered before their FMAs
constexpr int kSdBlocks = 64;     // stored blocks a warp takes

template <bool VEC>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int k, int K, bool use) {
    if (!use) return make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (VEC) {
        return __ldg(reinterpret_cast<const float4*>(row + k));
    } else {
        return make_float4(__ldg(row + k),
                           k + 1 < K ? __ldg(row + k + 1) : 0.f,
                           k + 2 < K ? __ldg(row + k + 2) : 0.f,
                           k + 3 < K ? __ldg(row + k + 3) : 0.f);
    }
}

__device__ __forceinline__ float dot_quad(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// grid (ceil(ceil(N / kSdBlocks) * n_rg * n_ct / 8), P), 256 threads
template <bool VEC, int G>
__global__ void __launch_bounds__(kThreads)
bcsr_sddmm_kernel(const int* __restrict__ brow, const int* __restrict__ bcol,
                  const float* __restrict__ tiles,
                  const float* __restrict__ C, const float* __restrict__ Dt,
                  float* __restrict__ out, int64_t N, int br, int bc,
                  int n_c, int64_t c_stride, int m, int K, int n_rg,
                  int n_ct) {
    constexpr int S = kWarp / G;                  // columns a step
    constexpr int W = (kSdRows + G - 1) / G;      // rows a lane writes
    const int lane = threadIdx.x % kWarp;
    const int q = lane % G;
    const int64_t p = blockIdx.y;
    const int64_t wid = int64_t(blockIdx.x) * (kThreads / kWarp)
                        + threadIdx.x / kWarp;
    const int per = n_rg * n_ct;                  // warps a run of blocks
    const int64_t b0 = wid / per * kSdBlocks;
    if (b0 >= N) return;                          // warp-uniform
    const int r0 = int(wid % per) / n_ct * kSdRows;   // first row
    const int c = int(wid % per) % n_ct * S + lane / G;   // this column
    const bool col_in = c < bc;
    const int nr = br - r0 < kSdRows ? br - r0 : kSdRows;
    const int n_kt = (K + 4 * G - 1) / (4 * G);
    const int64_t b1 = b0 + kSdBlocks < N ? b0 + kSdBlocks : N;
    const int tile = br * bc;
    const int grid_r = n_c / br, grid_c = m / bc;
    const int* pr = brow + p * N;
    const int* pc = bcol + p * N;
    // row r0 + q of this column, in the piece's first tile / output
    const float* pt = tiles + p * N * tile + (r0 + q) * bc + c;
    float* po = out + p * N * tile + (r0 + q) * bc + c;
    const float* Cp = C + p * c_stride + int64_t(r0) * K;
    float4 creg[kSdRows];                         // C quads of key `ctag`
    int64_t ctag = -1;
    for (int64_t base = b0; base < b1; base += kWarp) {
        const int cnt = b1 - base < kWarp ? int(b1 - base) : kWarp;
        int row_l = 0, col_l = 0;
        if (lane < cnt) {
            row_l = int(clamp_index(pr[base + lane], grid_r));
            col_l = int(clamp_index(pc[base + lane], grid_c));
        }
        for (int t0 = 0; t0 < cnt; t0 += kSdU) {
            // block t0 + u: its block-row, this lane's Dt row and tile
            // values (rows q, q + G, ... of the group)
            int row[kSdU], drow[kSdU];
            float tv[kSdU][W];
#pragma unroll
            for (int u = 0; u < kSdU; ++u) {
                const int t = t0 + u < cnt ? t0 + u : cnt - 1;
                const bool in = t0 + u < cnt && col_in;
                row[u] = __shfl_sync(0xffffffffu, row_l, t);
                drow[u] = __shfl_sync(0xffffffffu, col_l, t) * bc
                          + (col_in ? c : 0);
                const int64_t e = (base + t) * tile;
#pragma unroll
                for (int w = 0; w < W; ++w)
                    tv[u][w] = in && q + w * G < nr
                        ? __ldg(pt + e + w * G * bc) : 0.f;
            }
            float part[kSdU][kSdRows];
#pragma unroll
            for (int u = 0; u < kSdU; ++u)
#pragma unroll
                for (int r = 0; r < kSdRows; ++r) part[u][r] = 0.f;
            for (int kt = 0; kt < n_kt; ++kt) {
                const int k = kt * 4 * G + 4 * q;
                float4 d[kSdU];                   // every gather first
#pragma unroll
                for (int u = 0; u < kSdU; ++u)
                    d[u] = load_quad<VEC>(Dt + int64_t(drow[u]) * K, k, K,
                                          t0 + u < cnt && col_in && k < K);
#pragma unroll
                for (int u = 0; u < kSdU; ++u) {
                    if (t0 + u >= cnt) break;     // warp-uniform
                    const int64_t key = int64_t(row[u]) * n_kt + kt;
                    if (key != ctag) {            // warp-uniform
                        ctag = key;
                        const float* cr = Cp + int64_t(row[u]) * br * K;
#pragma unroll
                        for (int r = 0; r < kSdRows; ++r)
                            creg[r] = load_quad<VEC>(cr + int64_t(r) * K, k,
                                                     K, r < nr && k < K);
                    }
#pragma unroll
                    for (int r = 0; r < kSdRows; ++r)
                        part[u][r] = dot_quad(creg[r], d[u], part[u][r]);
                }
            }
#pragma unroll
            for (int u = 0; u < kSdU; ++u) {
                if (t0 + u >= cnt) break;         // warp-uniform
#pragma unroll
                for (int r = 0; r < kSdRows; ++r)
#pragma unroll
                    for (int off = G / 2; off > 0; off >>= 1)
                        part[u][r] += __shfl_xor_sync(0xffffffffu,
                                                      part[u][r], off);
                if (!col_in) continue;
                const int64_t e = (base + t0 + u) * tile;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    const int rr = q + w * G;
                    if (rr < nr) {
                        // part[u][rr] without a local-memory index
                        float sum = 0.f;
#pragma unroll
                        for (int x = 0; x < kSdRows; ++x)
                            if (x == rr) sum = part[u][x];
                        po[e + w * G * bc] = tv[u][w] * sum;
                    }
                }
            }
        }
    }
}

template <int G>
int launch_sddmm(bool vec, const int* brow, const int* bcol,
                 const float* tiles, const float* C, const float* Dt,
                 float* out, int P, int64_t N, int br, int bc, int n_c,
                 int64_t c_stride, int m, int K, cudaStream_t s) {
    constexpr int S = kWarp / G;
    const int n_rg = (br + kSdRows - 1) / kSdRows, n_ct = (bc + S - 1) / S;
    const int64_t warps = (N + kSdBlocks - 1) / kSdBlocks * n_rg * n_ct;
    dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads),
              unsigned(P));
    if (vec)
        bcsr_sddmm_kernel<true, G><<<grid, kThreads, 0, s>>>(
            brow, bcol, tiles, C, Dt, out, N, br, bc, n_c, c_stride, m, K,
            n_rg, n_ct);
    else
        bcsr_sddmm_kernel<false, G><<<grid, kThreads, 0, s>>>(
            brow, bcol, tiles, C, Dt, out, N, br, bc, n_c, c_stride, m, K,
            n_rg, n_ct);
    return int(cudaGetLastError());
}

// Phase 1 of bcsr_spmm by the (BR, BC) instance; -1 (nothing launched)
// when the block is not (BR, BC) or its tiles need 16-byte loads that
// ``vec`` (an aligned tile base) does not allow.
template <int BR, int BC>
int spmm_phase1(int br, int bc, bool vec, const int* brow, const int* bcol,
                const float* tiles, const float* C, float* head, float* tail,
                float* Y, int P, int64_t N, int grid_cols, int J, int R,
                int n_jt, int64_t nseg, cudaStream_t s) {
    if (br != BR || bc != BC || (!vec && (BR * BC) % 4 == 0)) return -1;
    const int64_t warps = nseg * n_jt;
    dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads),
              unsigned(P));
    bcsr_spmm_phase1<BR, BC><<<grid, kThreads, 0, s>>>(
        brow, bcol, tiles, C, head, tail, Y, N, br, bc, grid_cols, J, R,
        n_jt, 1, nseg);
    return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// brow, bcol: (P, N); tiles: (P, N, br, bc); c: (grid_cols * bc,);
// head, tail: (P, nseg, br) and group: (P, nseg / 64, br) f32 scratch with
// nseg = ceil(N / 128); y: (P, R * br), zeroed.
int bcsr_spmv(const int* brow, const int* bcol, const float* tiles,
              const float* c, float* head, float* tail, float* group,
              float* y, int P, int64_t N, int br, int bc, int grid_cols,
              int R, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nseg = (N + kSeg - 1) / kSeg;
    // 16-byte tile and c loads need aligned bases (a view may start
    // anywhere)
    const bool vec = reinterpret_cast<uintptr_t>(tiles) % 16 == 0
                     && reinterpret_cast<uintptr_t>(c) % 16 == 0;
    if (br == 4 && bc == 4 && vec) {
        dim3 grid(unsigned((nseg * kWarp + kThreads - 1) / kThreads),
                  unsigned(P));
        bcsr_spmv_phase1_44<<<grid, kThreads, 0, s>>>(
            brow, bcol, tiles, c, head, tail, y, N, grid_cols, R, nseg);
    } else {
        const int64_t warps = nseg * br;
        dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads),
                  unsigned(P));
        bcsr_spmv_phase1<<<grid, kThreads, 0, s>>>(
            brow, bcol, tiles, c, head, tail, y, N, br, bc, grid_cols, R,
            nseg);
    }
    const int err = int(cudaGetLastError());
    if (err != 0) return err;
    return segment_fold::fold_rows<kSeg>(brow, head, tail, group, y, P, N,
                                         br, R, nseg, s);
}

// brow, bcol: (P, N); tiles: (P, N, br, bc), any block; C:
// (grid_cols * bc, J); head, tail: (P, nseg, br, J) and group:
// (P, nseg / 64, br, J) scratch; Y: (P, R * br, J), zeroed.
int bcsr_spmm(const int* brow, const int* bcol, const float* tiles,
              const float* C, float* head, float* tail, float* group,
              float* Y, int P, int64_t N, int br, int bc, int grid_cols,
              int J, int R, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_jt = (J + kWarp - 1) / kWarp;
    const int64_t nseg = (N + kSeg - 1) / kSeg;
    // 16-byte tile loads need an aligned base (a view may start anywhere)
    const bool vec = reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
    int err = spmm_phase1<4, 4>(br, bc, vec, brow, bcol, tiles, C, head, tail,
                                Y, P, N, grid_cols, J, R, n_jt, nseg, s);
    if (err < 0) {                               // any other block: generic
        constexpr int kRows = 8;
        const int n_rg = (br + kRows - 1) / kRows;
        const int64_t warps = nseg * n_jt * n_rg;
        dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads),
                  unsigned(P));
        bcsr_spmm_phase1<kRows, 0><<<grid, kThreads, 0, s>>>(
            brow, bcol, tiles, C, head, tail, Y, N, br, bc, grid_cols, J, R,
            n_jt, n_rg, nseg);
        err = int(cudaGetLastError());
    }
    if (err != 0) return err;
    return segment_fold::fold_rows<kSeg>(brow, head, tail, group, Y, P, N,
                                         br * J, R, nseg, s);
}

// brow, bcol: (P, N); tiles, out: (P, N, br, bc), any block; C: (n_c, K)
// shared (c_stride 0) or (P, n_c, K) (c_stride n_c * K), row blocks of br
// rows (n_c a multiple of br); Dt: (m, K), D transposed, in column blocks
// of bc rows (m a multiple of bc).
int bcsr_sddmm(const int* brow, const int* bcol, const float* tiles,
               const float* C, const float* Dt, float* out, int P,
               int64_t N, int br, int bc, int n_c, int64_t c_stride, int m,
               int K, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // 16-byte quads need K % 4 == 0 and aligned bases (a view may start
    // anywhere); each piece's C then starts aligned too
    const bool vec = K % 4 == 0
                     && reinterpret_cast<uintptr_t>(C) % 16 == 0
                     && reinterpret_cast<uintptr_t>(Dt) % 16 == 0;
    int g = 1;                                   // K / 4 up to a power of 2
    while (g < kWarp && 4 * g < K) g <<= 1;
    switch (g) {
#define BCSR_SDDMM(G_)                                                        \
    case G_:                                                                  \
        return launch_sddmm<G_>(vec, brow, bcol, tiles, C, Dt, out, P, N, br, \
                                bc, n_c, c_stride, m, K, s);
    BCSR_SDDMM(1) BCSR_SDDMM(2) BCSR_SDDMM(4) BCSR_SDDMM(8) BCSR_SDDMM(16)
    BCSR_SDDMM(32)
#undef BCSR_SDDMM
    }
    return int(cudaErrorInvalidValue);
}

}  // extern "C"
