// The fold of a row cut by fixed segment (or chunk) edges, shared by the
// rows and nnz leaves of spmm.cu and by spmttkrp.cu.
//
// Phase 1 of those kernels sums each run of equal row ids inside a
// segment; a run that lies in one segment alone is written by it, a run
// that crosses edges leaves its partial in the segment where it starts
// (tail[first]) and in every later segment it reaches (head[s]). This
// header adds the rest, in a fixed order, with one writer per output and no
// float atomics, so results repeat bit for bit:
//  - group_sums: group[g] = head[64 g] + ... + head[64 g + 63], in order,
//    a warp per (piece, group, 32-column tile);
//  - fold_segments: tail[a] + head[a + 1] + ... + head[b] of one column as
//    the heads before the first whole group inside (a, b], those groups'
//    sums and the heads after them, so a row over 6,000 segments folds at
//    most 94 group sums and 126 heads;
//  - edge_fold (the nnz leaves, row-sorted streams of SEG-entry segments):
//    a thread per segment edge s (the first entry of segment s). A row that
//    crosses an edge (rows[SEG s - 1] == rows[SEG s]) is taken at its
//    first crossing edge, which finds the row's last segment by a search
//    over the segments' first ids (nseg entries, not N); the warp then
//    writes Y[row] = fold_segments(s - 1, last), lanes on columns.
// (spmm_coo_nnz folded its long rows one head at a time along a chain
// found by binary search before these group sums: 3.54 ms against 1.53 at
// 2^21 rows, 25.1 M entries and J = 32 on an NVIDIA H100 80GB HBM3 at
// 700 W.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segment_fold {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps per block
constexpr int kFold = 32;      // loads in flight in fold_in_order
constexpr int kGroup = 64;     // segments per group sum

// Adds x[s * J] for s in [from, to] to acc, in order, kFold loads in
// flight.
__device__ __forceinline__ float fold_in_order(const float* __restrict__ x,
                                               int64_t J, int64_t from,
                                               int64_t to, float acc) {
    int64_t s = from;
    for (; s + kFold - 1 <= to; s += kFold) {
        float h[kFold];
#pragma unroll
        for (int u = 0; u < kFold; ++u) h[u] = __ldg(x + (s + u) * J);
#pragma unroll
        for (int u = 0; u < kFold; ++u) acc += h[u];
    }
    for (; s <= to; ++s) acc += __ldg(x + s * J);
    return acc;
}

// A warp per (piece, group of kGroup segments, column tile); grid
// (ceil(n_groups * n_tiles * 32 / 256), P). The fold reads group[g] only
// for groups inside one row's span, where phase 1 wrote every head, so a
// row's fold takes one load per group instead of 64.
__global__ void group_sums(const float* __restrict__ head,
                           float* __restrict__ group, int J, int n_tiles,
                           int64_t nseg, int64_t n_groups) {
    const int64_t p = blockIdx.y;
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x)
                         / kWarp;
    const int j = int(warp % n_tiles) * kWarp + threadIdx.x % kWarp;
    if (warp >= n_groups * n_tiles || j >= J) return;
    const int64_t g = warp / n_tiles;
    group[(p * n_groups + g) * J + j] = fold_in_order(
        head + (p * nseg + g * kGroup) * J + j, J, 0, kGroup - 1, 0.f);
}

// tail[a] + head[a + 1] + ... + head[b] of one column (x[s * J] is
// segment or chunk s's partial, group[g] the sum of heads 64 g .. 64 g + 63),
// in a fixed order: the heads before the first group inside (a, b], those
// groups' sums, the heads after them.
__device__ __forceinline__ float fold_segments(const float* __restrict__ hp,
                                               const float* __restrict__ tp,
                                               const float* __restrict__ gp,
                                               int64_t J, int64_t a,
                                               int64_t b) {
    const int64_t g_lo = (a + kGroup) / kGroup, g_hi = (b + 1) / kGroup;
    float acc = __ldg(tp + a * J);
    int64_t s = a + 1;
    if (g_lo < g_hi) {
        acc = fold_in_order(hp, J, s, g_lo * kGroup - 1, acc);
        acc = fold_in_order(gp, J, g_lo, g_hi - 1, acc);
        s = g_hi * kGroup;
    }
    return fold_in_order(hp, J, s, b, acc);
}

// A thread per segment edge s >= 1 of a piece; grid (ceil(nseg / 256), P).
// The lane at a row's first crossing edge finds the row's last segment b1
// (the last segment whose first id is the row), and the warp writes
// Y[row] = fold_segments(first = s - 1, b1).
template <int SEG>
__global__ void edge_fold(const int* __restrict__ rows,
                          const float* __restrict__ head,
                          const float* __restrict__ tail,
                          const float* __restrict__ group,
                          float* __restrict__ Y, int64_t N, int J,
                          int max_rows, int64_t nseg, int64_t n_groups) {
    const int64_t p = blockIdx.y;
    const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x % kWarp;
    if (e - lane >= nseg) return;                     // warp-uniform
    const int* pr = rows + p * N;
    int row = -1;
    int64_t b1 = 0;
    if (e >= 1 && e < nseg) {
        const int r = __ldg(pr + e * SEG);
        const bool starts = __ldg(pr + e * SEG - 1) == r
            && (e == 1 || __ldg(pr + (e - 1) * SEG - 1) != r);
        if (starts && r >= 0 && r < max_rows) {
            // the last segment k >= e with rows[k * SEG] == r
            int64_t lo = e, hi = nseg;
            while (hi - lo > 1) {
                const int64_t mid = (lo + hi) >> 1;
                if (__ldg(pr + mid * SEG) == r) lo = mid;
                else hi = mid;
            }
            row = r;
            b1 = lo;
        }
    }
    const float* hp = head + p * nseg * J;
    const float* tp = tail + p * nseg * J;
    const float* gp = group + p * n_groups * J;
    for (unsigned todo = __ballot_sync(0xffffffffu, row >= 0); todo;
         todo &= todo - 1) {
        const int k = __ffs(todo) - 1;
        const int64_t a = e - lane + k - 1;
        const int64_t b = __shfl_sync(0xffffffffu, b1, k);
        float* out = Y + (p * max_rows + __shfl_sync(0xffffffffu, row, k)) * J;
        for (int j = lane; j < J; j += kWarp)
            out[j] = fold_segments(hp + j, tp + j, gp + j, J, a, b);
    }
}

// The group pass (when there is a whole group) and edge_fold over the
// head, tail (P, nseg, J) and group (P, nseg / 64, J) partials of a
// row-sorted stream of SEG-entry segments; returns cudaGetLastError().
template <int SEG>
int fold_rows(const int* rows, const float* head, const float* tail,
              float* group, float* Y, int P, int64_t N, int J, int max_rows,
              int64_t nseg, cudaStream_t s) {
    const int n_tiles = (J + kWarp - 1) / kWarp;
    const int64_t n_groups = nseg / kGroup;
    if (n_groups > 0) {
        const int64_t warps = n_groups * n_tiles;
        dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads),
                  unsigned(P));
        group_sums<<<grid, kThreads, 0, s>>>(head, group, J, n_tiles, nseg,
                                             n_groups);
        const int err = int(cudaGetLastError());
        if (err != 0) return err;
    }
    dim3 grid(unsigned((nseg + kThreads - 1) / kThreads), unsigned(P));
    edge_fold<SEG><<<grid, kThreads, 0, s>>>(rows, head, tail, group, Y, N,
                                             J, max_rows, nseg, n_groups);
    return int(cudaGetLastError());
}

}  // namespace segment_fold
