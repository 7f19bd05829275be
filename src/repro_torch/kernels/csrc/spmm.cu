// SpMM leaves for Hopper (sm_90a): Y = B . C over the lowered path's stacked
// per-piece shards, batched over pieces.
//
// spmm_csr_rows replaces the TPU kernel src/repro/kernels/spmm.py:54
// spmm_ell (rows strategy). spmm_coo_nnz is the nnz strategy's leaf, which
// has no TPU kernel: the reference runs src/repro/kernels/ref.py:106
// leaf_spmm_nnz, a segment_sum, and the port's plain version of it reduces
// with index_add_, whose float atomics on the card change the low bits
// from run to run.
//
// What bounds it on this card: bytes. Each stored entry is read once
// (crd + val = 8 B), C (K, J) once and Y (P, R, J) written once; at
// 3.35 TB/s the 2 flops per entry and column are an order of magnitude
// below the byte time in f32. In practice the kernel reads one row of C
// per stored entry, so C's rows are re-read from L2 or device memory as
// often as their column index repeats.
//
// What the design does about it: the TPU kernel re-blocks CSR into row-block
// ELL and reduces with a one-hot matmul because the TPU has no scatter and
// wants (8, 128) tiles (layout.py:1-22). Here spmm_csr_rows splits each
// piece by merge path (merge_rows.cuh): a warp per (piece, chunk of 256
// items, 32-column tile of J), so a row of any length spreads over many
// warps and a warp covers many short rows. Lanes own the columns, so every
// gather of a row of C (kept (K, J) row-major) is one coalesced 128-byte
// read. Per batch of 32 items, the chunk's (crd, val) pairs are loaded with
// one coalesced load (lane t holds item t, if it is an entry) and handed
// out by shuffles; the 32 gathers of C's rows are issued before the sums,
// so they are in flight together; then each lane adds its column over the
// batch's entries in storage order and, at each row-end item, writes the
// row (0 for an empty row). A row that crosses chunks leaves its partials
// in tail / head; phase 2a sums the heads of each group of 64 chunks in
// order, and phase 2 (a warp per 32 rows) adds, for each column, the first
// chunk's tail, the heads before the first group inside the row, those
// groups' sums and the heads after them, in that order: a row of 5,200
// chunks folds 81 group sums, not 5,200 heads. The last tile masks columns
// >= J. (The first version gave one warp to each (row, column tile):
// 336.4 ms at 2^21 rows, 25.1 M entries and J = 32 on an NVIDIA H100 80GB
// HBM3 at 700 W, set by the longest row, 1,326,299 entries walked by one
// warp; this one 1.43 ms on the same card and inputs.)
//
// spmm_coo_nnz (row-sorted COO shards, rows rebased to the piece's window)
// is bound by bytes the same way: 12 B per stored entry, one gathered row
// of C per entry and Y written once. Its design is spmv_coo_nnz's scheme
// (spmv.cu) with lanes on 32-column tiles of J and the rows kernel's group
// fold, so no entry's work is repeated, a row of any length is spread over
// many warps and no warp folds a long row's segments one by one:
//  - Y is cleared once (cudaMemsetAsync), so a row with no entry needs no
//    writer.
//  - Phase 1: a warp per (piece, 256-entry segment, column tile). The
//    segment's (row, col, val) triples are read 32 at a time with one
//    coalesced load and handed to the lanes by shuffles; the 32 gathers
//    of C rows are issued before the sums, so they are in flight together.
//    Which entries end a run comes from one ballot per batch (each lane
//    compares its id with the next), so the sums branch on a warp-uniform
//    mask, as the rows kernel's do, and dropped ids cost no gather.
//    A run of equal row ids that lies in this segment alone is summed in
//    storage order and written to Y, its only writer. A run that crosses
//    the segment's start goes to head[seg], one that crosses its end (and
//    not its start) to tail[seg].
//  - Group pass: group[g] = head[64 g] + ... + head[64 g + 63], in order
//    (segment_fold.cuh's group_sums, shared with the rows kernel and
//    spmttkrp_coo).
//  - Phase 2 (segment_fold.cuh's edge_fold, shared with spmttkrp_coo),
//    driven by segment edges: a thread per edge s (the first entry
//    of segment s). The rows that cross an edge (rows[256 s - 1] ==
//    rows[256 s]) are taken at their first crossing edge, which finds the
//    row's last segment by a search over the segments' first ids (nseg
//    entries, not N); the warp then folds, lanes on columns,
//    tail[first] + the heads before the first whole group + the groups'
//    sums + the heads after, in that order (fold_segments, the rows
//    kernel's phase-2 fold): a row over 5,181 segments folds at most 81
//    group sums and 126 heads.
// (The first version gave phase 2 a warp per 32 rows of every piece, each
// lane running two binary searches over the piece's whole stream, wrote
// the empty rows there, and folded a row's segments one head at a time:
// 3.54 ms at 2^21 rows, 25.1 M entries and J = 32 on an NVIDIA H100 80GB
// HBM3 at 700 W.)
// Every output element is written once, with no float atomics, so results
// repeat bit for bit.
//
// Contract of spmm_csr_rows: pos is non-decreasing within a piece (CSR);
// whatever it holds, no entry outside [pos[0], pos[R]) is read. Columns are
// clamped into [0, K).
//
// Contract of spmm_coo_nnz (spmv_coo_nnz's): row ids are non-decreasing
// within a piece; ids below 0 or at/after max_rows are dropped. Columns
// are clamped into [0, K).
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_rows.cuh"
#include "segment_fold.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps per block
constexpr int kSeg = 256;      // entries per spmm_coo_nnz segment

using merge_rows::RowEnds;
using merge_rows::kItems;
using segment_fold::fold_segments;
using segment_fold::kGroup;

// Rows phase 1: a warp per (piece, chunk, column tile); grid
// (ceil(n_chunks * n_tiles * 32 / 256), P).
__global__ void spmm_rows_phase1_kernel(const int* __restrict__ pos,
                                        const int* __restrict__ crd,
                                        const float* __restrict__ vals,
                                        const float* __restrict__ C,
                                        float* __restrict__ Y,
                                        float* __restrict__ head,
                                        float* __restrict__ tail,
                                        int R, int64_t N, int K, int J,
                                        int n_tiles, int64_t n_chunks) {
    const int64_t p = blockIdx.y;
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x)
                         / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (warp >= n_chunks * n_tiles) return;           // warp-uniform
    const int64_t chunk = warp / n_tiles;
    const int j = int(warp % n_tiles) * kWarp + lane;
    const bool live = j < J;
    const RowEnds re(pos + p * (int64_t(R) + 1), R, N);
    const int64_t d0 = chunk * kItems;
    const int64_t d_end = d0 + kItems < re.items() ? d0 + kItems : re.items();
    if (d0 >= d_end) return;
    const int* pc = crd + p * N + re.e0;
    const float* pv = vals + p * N + re.e0;
    float* Yp = Y + p * int64_t(R) * J + j;
    const int64_t edge = (p * n_chunks + chunk) * J + j;
    // (rows ended, entries taken) before the chunk; is its first row open?
    const int64_t i0 = merge_rows::merge_search(re, d0, lane);
    const bool open = i0 < R && d0 - i0 > re.end(i0 - 1);
    const unsigned lower = (1u << lane) - 1;
    int64_t ib = i0, jb = d0 - i0;
    float acc = 0.f;                   // this lane's column of row ib so far
    for (int64_t D0 = d0; D0 < d_end; D0 += kWarp) {
        const unsigned mask = merge_rows::end_mask(re, ib, D0, lane);
        const int n_valid = d_end - D0 < kWarp ? int(d_end - D0) : kWarp;
        // lane t holds item t's (column, value) when it is an entry
        int k_l = 0;
        float v_l = 0.f;
        if (lane < n_valid && !((mask >> lane) & 1u)) {
            const int64_t e = jb + lane - __popc(mask & lower);
            if (e < re.nnz) {
                const int k = pc[e];
                k_l = k < 0 ? 0 : (k >= K ? K - 1 : k);
                v_l = pv[e];
            }
        }
        float cv[kWarp];
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
            const int k = __shfl_sync(0xffffffffu, k_l, t);
            const bool entry = t < n_valid && !((mask >> t) & 1u);
            cv[t] = entry && live ? __ldg(C + int64_t(k) * J + j) : 0.f;
        }
        int64_t row = ib;
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
            const float v = __shfl_sync(0xffffffffu, v_l, t);
            if (t >= n_valid) break;                  // warp-uniform
            if ((mask >> t) & 1u) {                   // row `row` ends here
                if (live) {
                    if (row == i0 && open) head[edge] = acc;
                    else Yp[row * J] = acc;
                }
                acc = 0.f;
                ++row;
            } else {
                acc += v * cv[t];
            }
        }
        const int ends = __popc(mask);
        ib += ends;
        jb += n_valid - ends;
    }
    if (live && ib < R) {
        if (ib == i0 && open) head[edge] = acc;             // a middle chunk
        else if (jb > re.end(ib - 1)) tail[edge] = acc;     // row starts here
    }
}

// Rows phase 2: a warp per 32 rows of a piece, for the rows that cross
// chunks: per column, tail[first chunk], then in chunk order the heads up
// to the first whole group, the whole groups' sums and the heads after
// them; grid (ceil(groups * 32 / 256), P).
__global__ void spmm_rows_phase2_kernel(const int* __restrict__ pos,
                                        const float* __restrict__ head,
                                        const float* __restrict__ tail,
                                        const float* __restrict__ group,
                                        float* __restrict__ Y,
                                        int R, int64_t N, int J,
                                        int64_t n_chunks, int64_t n_groups) {
    const int64_t p = blockIdx.y;
    const int64_t r0 = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x)
                       / kWarp * kWarp;
    const int lane = threadIdx.x % kWarp;
    if (r0 >= R) return;                              // warp-uniform
    const RowEnds re(pos + p * (int64_t(R) + 1), R, N);
    int64_t s0 = 0, s1 = 0;
    if (r0 + lane < R) merge_rows::row_chunks(re, r0 + lane, &s0, &s1);
    const float* hp = head + p * n_chunks * J;
    const float* tp = tail + p * n_chunks * J;
    const float* gp = group + p * n_groups * J;
    for (unsigned cross = __ballot_sync(0xffffffffu, s1 != s0); cross;
         cross &= cross - 1) {
        const int k = __ffs(cross) - 1;
        const int64_t a = __shfl_sync(0xffffffffu, s0, k);
        const int64_t b = __shfl_sync(0xffffffffu, s1, k);
        float* out = Y + (p * R + r0 + k) * J;
        for (int j = lane; j < J; j += kWarp)
            out[j] = fold_segments(hp + j, tp + j, gp + j, J, a, b);
    }
}

// Phase 1: a warp per (piece, segment, column tile); grid
// (ceil(nseg * n_tiles * 32 / 256), P).
__global__ void spmm_coo_phase1_kernel(const int* __restrict__ rows,
                                       const int* __restrict__ cols,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ C,
                                       float* __restrict__ head,
                                       float* __restrict__ tail,
                                       float* __restrict__ Y,
                                       int64_t N, int K, int J, int max_rows,
                                       int n_tiles, int64_t nseg) {
    const int64_t p = blockIdx.y;
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (warp >= nseg * n_tiles) return;               // warp-uniform
    const int64_t seg = warp / n_tiles;
    const int j = int(warp % n_tiles) * kWarp + lane;
    const bool live = j < J;
    const int* pr = rows + p * N;
    const int* pc = cols + p * N;
    const float* pv = vals + p * N;
    const int64_t lo = seg * kSeg;
    const int64_t hi = lo + kSeg < N ? lo + kSeg : N;
    // does the run of the segment's first / last id go on beyond it?
    const bool open_lo = lo > 0 && __ldg(pr + lo - 1) == __ldg(pr + lo);
    const bool open_hi = hi < N && __ldg(pr + hi) == __ldg(pr + hi - 1);
    const int64_t edge = (p * nseg + seg) * J + j;
    float* Yp = Y + p * int64_t(max_rows) * J;
    bool first = true;                 // still in the segment's first run?
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        // lane t holds entry t's (row, column, value); a dropped id's
        // entry has column -1 (no gather) and value 0
        int r_l = -1, c_l = -1;
        float v_l = 0.f;
        if (lane < cnt) {
            r_l = pr[base + lane];
            if (r_l >= 0 && r_l < max_rows) {
                const int c = pc[base + lane];
                c_l = c < 0 ? 0 : (c >= K ? K - 1 : c);
                v_l = pv[base + lane];
            }
        }
        // bit t: entry t ends its run inside the segment (the segment's
        // last entry never does: its run is handled after the loop)
        int next = __shfl_down_sync(0xffffffffu, r_l, 1);
        if (lane == kWarp - 1 && base + kWarp < hi)
            next = __ldg(pr + base + kWarp);
        const bool ends = base + lane + 1 < hi && lane < cnt && next != r_l;
        const unsigned mask = __ballot_sync(0xffffffffu, ends);
        float cv[kWarp];
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
            const int c = __shfl_sync(0xffffffffu, c_l, t);
            cv[t] = c >= 0 && live ? __ldg(C + int64_t(c) * J + j) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
            const float v = __shfl_sync(0xffffffffu, v_l, t);
            if (t >= cnt) break;                      // warp-uniform
            acc += v * cv[t];
            if ((mask >> t) & 1u) {                   // a run ends here
                const int row = __shfl_sync(0xffffffffu, r_l, t);
                if (live) {
                    if (first && open_lo) head[edge] = acc;
                    else if (row >= 0 && row < max_rows)
                        Yp[int64_t(row) * J + j] = acc;
                }
                acc = 0.f;
                first = false;
            }
        }
    }
    // the segment's last run
    const int last = __ldg(pr + hi - 1);
    if (first && open_lo) {
        if (live) head[edge] = acc;
    } else if (open_hi) {
        if (live) tail[edge] = acc;
    } else if (live && last >= 0 && last < max_rows) {
        Yp[int64_t(last) * J + j] = acc;
    }
}

}  // namespace

extern "C" {

// head, tail: (P, n_chunks, J) and group: (P, n_chunks / 64, J) f32
// scratch, n_chunks = ceil((R + N) / 256); Y: (P, R, J), every element
// written.
int spmm_csr_rows(const int* pos, const int* crd, const float* vals,
                  const float* C, float* head, float* tail, float* group,
                  float* Y, int P, int R, int64_t N, int K, int J,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = (J + kWarp - 1) / kWarp;
    const int64_t n_chunks = (int64_t(R) + N + kItems - 1) / kItems;
    const int64_t n_groups = n_chunks / kGroup;
    const int64_t warps1 = n_chunks * n_tiles;
    dim3 grid1(unsigned((warps1 * kWarp + kThreads - 1) / kThreads),
               unsigned(P));
    spmm_rows_phase1_kernel<<<grid1, kThreads, 0, s>>>(
        pos, crd, vals, C, Y, head, tail, R, N, K, J, n_tiles, n_chunks);
    int err = int(cudaGetLastError());
    if (err != 0) return err;
    if (n_groups > 0) {
        const int64_t warps = n_groups * n_tiles;
        dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads),
                  unsigned(P));
        segment_fold::group_sums<<<grid, kThreads, 0, s>>>(
            head, group, J, n_tiles, n_chunks, n_groups);
        err = int(cudaGetLastError());
        if (err != 0) return err;
    }
    const int64_t groups = (int64_t(R) + kWarp - 1) / kWarp;
    dim3 grid2(unsigned((groups * kWarp + kThreads - 1) / kThreads),
               unsigned(P));
    spmm_rows_phase2_kernel<<<grid2, kThreads, 0, s>>>(
        pos, head, tail, group, Y, R, N, J, n_chunks, n_groups);
    return int(cudaGetLastError());
}

// rows, cols, vals: (P, N); C: (K, J); head, tail: (P, nseg, J) and group:
// (P, nseg / 64, J) f32 scratch with nseg = ceil(N / 256); Y:
// (P, max_rows, J), cleared here, so every element is written.
int spmm_coo_nnz(const int* rows, const int* cols, const float* vals,
                 const float* C, float* head, float* tail, float* group,
                 float* Y, int P, int64_t N, int K, int J, int max_rows,
                 void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = int(cudaMemsetAsync(
        Y, 0, size_t(P) * size_t(max_rows) * size_t(J) * sizeof(float), s));
    if (err != 0) return err;
    const int n_tiles = (J + kWarp - 1) / kWarp;
    const int64_t nseg = (N + kSeg - 1) / kSeg;
    const int64_t warps1 = nseg * n_tiles;
    dim3 grid1(unsigned((warps1 * kWarp + kThreads - 1) / kThreads),
               unsigned(P));
    spmm_coo_phase1_kernel<<<grid1, kThreads, 0, s>>>(
        rows, cols, vals, C, head, tail, Y, N, K, J, max_rows, n_tiles, nseg);
    err = int(cudaGetLastError());
    if (err != 0 || nseg < 2) return err;
    return segment_fold::fold_rows<kSeg>(rows, head, tail, group, Y, P, N, J,
                                         max_rows, nseg, s);
}

}  // extern "C"
