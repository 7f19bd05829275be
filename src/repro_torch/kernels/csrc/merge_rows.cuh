// The merge-path split of one CSR row shard, shared by the rows leaves of
// spmv.cu and spmm.cu (Merrill & Garland, "Merge-based Parallel Sparse
// Matrix-Vector Multiplication", SC'16).
//
// A piece's R row ends (pos[1..R]) and its nnz = pos[R] - pos[0] entries
// form one merged list of R + nnz items, in which row r's entries come
// before its end item: entry e sits at position (its row) + (e - pos[0]),
// row r's end at r + (pos[r+1] - pos[0]). The list is cut into chunks of
// kItems items, one warp each, so an empty row, a two-entry fibre and a
// row of a million entries all cost in proportion to their items. A warp
// finds where its chunk starts, (rows ended, entries taken), with one
// search along its diagonal over pos, and walks the chunk 32 items at a
// time; which items of a batch are row ends comes from one coalesced load
// of the next 32 row ends and a warp-wide OR, not from a row-id array.
//
// Rows whose items lie in one chunk are summed and written by that chunk.
// A row that crosses chunks leaves the partial of its first chunk in
// tail[chunk] and that of every later chunk it reaches in head[chunk]; a
// second phase, a warp per 32 rows, finds those rows from pos alone
// (their first entry and their end lie in different chunks) and folds
// tail[first] + head[first + 1] + ... + head[last] in a fixed order. So
// every output is written once, with no float atomics, and results repeat
// bit for bit. Empty rows are written 0 by the chunk holding their end.
//
// Index hygiene: pos is clamped into [0, N] and each row end into
// [pos[0], pos[R]], so no entry outside [pos[0], pos[R]) is read (the
// shard's padding tail never is) whatever pos holds; positions are 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace merge_rows {

constexpr int kWarp = 32;
constexpr int kItems = 256;    // merge items (row ends + entries) per chunk

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// One piece's row ends, relative to its first entry.
struct RowEnds {
    const int* pos;    // the piece's pos, R + 1 values
    int64_t R, e0, nnz;

    __device__ RowEnds(const int* pos_p, int R_, int64_t N)
        : pos(pos_p), R(R_) {
        e0 = clamp64(__ldg(pos_p), 0, N);
        nnz = clamp64(__ldg(pos_p + R_), e0, N) - e0;
    }
    // entries before row i's end (i in [-1, R)); end(-1) = 0
    __device__ __forceinline__ int64_t end(int64_t i) const {
        return i < 0 ? 0 : clamp64(int64_t(__ldg(pos + i + 1)) - e0, 0, nnz);
    }
    // position of row i's end item in the merged list
    __device__ __forceinline__ int64_t item(int64_t i) const {
        return i + end(i);
    }
    __device__ __forceinline__ int64_t items() const { return R + nnz; }
};

// Rows ended before merged position d: #{i in [0, R): item(i) < d}, kept in
// [max(0, d - nnz), min(d, R)] so that d - result is an entry count in
// [0, nnz]. The whole warp searches together, 32 probes a round: four
// rounds for 2^19 rows. Warp-uniform result.
__device__ __forceinline__ int64_t merge_search(const RowEnds& re, int64_t d,
                                                int lane) {
    int64_t lo = d - re.nnz > 0 ? d - re.nnz : 0;
    int64_t hi = d < re.R ? d : re.R;
    while (hi - lo > kWarp) {
        const int64_t step = (hi - lo + kWarp - 1) / kWarp;
        const int64_t probe = lo + (lane + 1) * step - 1;
        const bool before = probe < hi && re.item(probe) < d;
        const int m = __popc(__ballot_sync(0xffffffffu, before));
        const int64_t next_hi = lo + (m + 1) * step - 1;
        lo += m * step;
        hi = next_hi < hi ? next_hi : hi;
    }
    const int64_t probe = lo + lane;
    const bool before = probe < hi && re.item(probe) < d;
    return lo + __popc(__ballot_sync(0xffffffffu, before));
}

// Bit t is set when item D0 + t is a row end; ib = rows ended before D0,
// so only rows ib .. ib + 31 can end in [D0, D0 + 32). Warp-uniform.
__device__ __forceinline__ unsigned end_mask(const RowEnds& re, int64_t ib,
                                             int64_t D0, int lane) {
    const int64_t i = ib + lane;
    unsigned bit = 0;
    if (i < re.R) {
        const int64_t off = re.item(i) - D0;
        if (off >= 0 && off < kWarp) bit = 1u << off;
    }
    return __reduce_or_sync(0xffffffffu, bit);
}

// The chunks a row's items span: [s0, s1] from its first entry to its end
// (s0 == s1 for an empty row). A row with s0 != s1 belongs to phase 2.
__device__ __forceinline__ void row_chunks(const RowEnds& re, int64_t r,
                                           int64_t* s0, int64_t* s1) {
    const int64_t lo = re.end(r - 1), hi = re.end(r);
    *s0 = (r + lo) / kItems;
    *s1 = hi > lo ? (r + hi) / kItems : *s0;
}

}  // namespace merge_rows
