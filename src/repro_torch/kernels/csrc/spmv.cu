// SpMV leaves for Hopper (sm_90a): y = B . c over the lowered path's stacked
// per-piece shards, batched over pieces.
//
// spmv_csr_rows replaces the TPU kernel src/repro/kernels/spmv.py:72
// spmv_ell (rows strategy). spmv_coo_nnz replaces src/repro/kernels/spmv.py:126
// spmv_coo_phase1 together with its segment_sum merge (ops.py:72) (nnz
// strategy).
//
// What bounds them on this card: bytes. Each stored entry is read once
// (crd + val = 8 B for CSR, row + col + val = 12 B for COO) plus one 4 B
// gather of c; at 3.35 TB/s the floating-point work (2 flops per entry) is
// three orders of magnitude below the byte time.
//
// What the design does about it: the TPU kernels re-block CSR into row-block
// ELL and reduce with a one-hot matmul because the TPU has no scatter and
// wants (8, 128) tiles (layout.py:1-22). Here the kernels read the CSR / COO
// shards directly, so only real entries cost bytes:
//  - spmv_csr_rows: a merge-path split of each piece (merge_rows.cuh): a
//    warp per chunk of 256 items (row ends + entries), so no row, however
//    long, and no run of short or empty rows sets the time. Lanes sit on
//    items, 32 at a time: each entry lane forms its product, and a
//    segmented shuffle scan over equal rows (the row of an item is the
//    batch's first row plus the row ends before it, from the chunk's merge
//    coordinate) sums them; the lane holding a row's end writes the row,
//    and the partial of the row still open at the batch's end is carried
//    to the next batch. Rows that cross chunks go through tail / head and
//    phase 2, which folds a row's chunk partials with lanes strided over
//    the chunks and a fixed shuffle tree. (The first version gave one warp
//    to each row: 12.24 ms at 2^21 rows and 25.1 M entries, longest row
//    1,326,299, on an NVIDIA H100 80GB HBM3 at 700 W, set by that row; and
//    2.06 ms over SpTTV's 8.5 M two-entry fibres, 30 of 32 lanes idle;
//    this one 0.32 and 0.40 ms on the same card and inputs.)
//  - spmv_coo_nnz: the TPU kernel's two-phase scheme, made deterministic
//    and carried to sorted COO the way the rows kernels split their items.
//    y is cleared once (cudaMemsetAsync), so rows with no entry need no
//    writer. Phase 1 takes fixed 1024-entry blocks, four consecutive
//    entries a thread (so each thread has four gathers of c in flight),
//    forms each entry's product, sums the runs inside each thread, and
//    runs a segmented scan of the threads' last runs over equal row ids
//    (a warp scan, then the carry from earlier warps of the block). A row
//    run that lies wholly inside the block is written to y by the thread
//    holding its last entry, its only writer; the block leaves only the
//    partials of its first and last runs in head / tail (2 floats a
//    block). Phase 2 takes the rows that cross block edges
//    (rows[b.1024 - 1] == rows[b.1024]): a warp per 32 edges; the lane at
//    a row's first crossing edge finds the row's last block by a search
//    over the blocks' first ids, and the warp folds tail[first] +
//    head[first + 1] + ... + head[last] with lanes strided over the
//    blocks, eight loads in flight each, and a fixed shuffle tree (the
//    rows phase 2's fold), so a row over thousands of
//    blocks does not serialise. (The first version stored the run partials
//    in a (P, N) scratch and gave phase 2 a warp per 32 rows, each lane
//    running two binary searches over the whole piece: 0.64 ms at 2^21
//    rows and 25.1 M entries on an NVIDIA H100 80GB HBM3 at 700 W.)
// Every output is written once, with no float atomics, so results repeat
// bit for bit. Row ids stay int32 (the TPU kernel carries them through an
// f32 matmul, exact only to 2^24).
//
// Contract of spmv_csr_rows: pos is non-decreasing within a piece (CSR);
// whatever it holds, no entry outside [pos[0], pos[R]) is read. Contract
// of spmv_coo_nnz: row ids are non-decreasing within a piece. Ids below 0
// or at/after max_rows are dropped, as segment_sum drops them.
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;           // 8 warps per block
constexpr int kPer = 4;                 // entries per thread, nnz phase 1
constexpr int kNnzBlock = kThreads * kPer;   // entries per phase-1 block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

using merge_rows::RowEnds;
using merge_rows::kItems;

// Rows phase 1: a warp per (piece, chunk); grid
// (ceil(n_chunks * 32 / 256), P).
__global__ void spmv_rows_phase1_kernel(const int* __restrict__ pos,
                                        const int* __restrict__ crd,
                                        const float* __restrict__ vals,
                                        const float* __restrict__ c,
                                        float* __restrict__ y,
                                        float* __restrict__ head,
                                        float* __restrict__ tail,
                                        int R, int64_t N, int m,
                                        int64_t n_chunks) {
    const int64_t p = blockIdx.y;
    const int64_t chunk = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x)
                          / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (chunk >= n_chunks) return;                    // warp-uniform
    const RowEnds re(pos + p * (int64_t(R) + 1), R, N);
    const int64_t d0 = chunk * kItems;
    const int64_t d_end = d0 + kItems < re.items() ? d0 + kItems : re.items();
    if (d0 >= d_end) return;
    const int* pc = crd + p * N + re.e0;
    const float* pv = vals + p * N + re.e0;
    float* yp = y + p * R;
    const int64_t edge = p * n_chunks + chunk;
    // (rows ended, entries taken) before the chunk; is its first row open?
    const int64_t i0 = merge_rows::merge_search(re, d0, lane);
    const bool open = i0 < R && d0 - i0 > re.end(i0 - 1);
    const unsigned lower = (1u << lane) - 1;
    int64_t ib = i0, jb = d0 - i0;
    float carry = 0.f;                 // the partial of row ib so far
    for (int64_t D0 = d0; D0 < d_end; D0 += kWarp) {
        const unsigned mask = merge_rows::end_mask(re, ib, D0, lane);
        const int n_valid = d_end - D0 < kWarp ? int(d_end - D0) : kWarp;
        const int rank = __popc(mask & lower);        // row ends before me
        const bool is_end = (mask >> lane) & 1u;
        const bool valid = lane < n_valid;
        float v = 0.f;
        if (valid && !is_end) {
            const int64_t e = jb + lane - rank;
            if (e < re.nnz) v = pv[e] * __ldg(c + clamp_index(pc[e], m));
        }
        // segmented inclusive scan over equal rows: row = ib + rank
        const int key = valid ? rank : kWarp + 1;
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, v, d);
            const int up_key = __shfl_up_sync(0xffffffffu, key, d);
            if (lane >= d && up_key == key) v += up;
        }
        if (key == 0) v += carry;
        if (valid && is_end) {
            if (rank == 0 && open && ib == i0) head[edge] = v;
            else yp[ib + rank] = v;
        }
        const int ends = __popc(mask);
        const float last = __shfl_sync(0xffffffffu, v, n_valid - 1);
        carry = (mask >> (n_valid - 1)) & 1u ? 0.f : last;
        ib += ends;
        jb += n_valid - ends;
    }
    if (lane == 0 && ib < R) {
        if (ib == i0 && open) head[edge] = carry;           // a middle chunk
        else if (jb > re.end(ib - 1)) tail[edge] = carry;   // row starts here
    }
}

// tp[a] + hp[a + 1] + ... + hp[b] over the warp, in a fixed order: lane l
// adds the partials a + l, a + l + 32, ... in order, kFold loads in flight,
// then a fixed shuffle tree. Every lane returns the sum.
constexpr int kFold = 8;

__device__ __forceinline__ float fold_span(const float* __restrict__ hp,
                                           const float* __restrict__ tp,
                                           int64_t a, int64_t b, int lane) {
    float acc = 0.f;
    int64_t s = a + lane;
    for (; s + (kFold - 1) * kWarp <= b; s += kFold * kWarp) {
        float h[kFold];
#pragma unroll
        for (int u = 0; u < kFold; ++u) {
            const int64_t t = s + u * kWarp;
            h[u] = __ldg((t == a ? tp : hp) + t);
        }
#pragma unroll
        for (int u = 0; u < kFold; ++u) acc += h[u];
    }
    for (; s <= b; s += kWarp) acc += __ldg((s == a ? tp : hp) + s);
    return warp_sum(acc);
}

// Rows phase 2: a warp per 32 rows of a piece, for the rows that cross
// chunks, each folded by fold_span; grid (ceil(groups * 32 / 256), P).
__global__ void spmv_rows_phase2_kernel(const int* __restrict__ pos,
                                        const float* __restrict__ head,
                                        const float* __restrict__ tail,
                                        float* __restrict__ y,
                                        int R, int64_t N, int64_t n_chunks) {
    const int64_t p = blockIdx.y;
    const int64_t r0 = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x)
                       / kWarp * kWarp;
    const int lane = threadIdx.x % kWarp;
    if (r0 >= R) return;                              // warp-uniform
    const RowEnds re(pos + p * (int64_t(R) + 1), R, N);
    int64_t s0 = 0, s1 = 0;
    if (r0 + lane < R) merge_rows::row_chunks(re, r0 + lane, &s0, &s1);
    for (unsigned cross = __ballot_sync(0xffffffffu, s1 != s0); cross;
         cross &= cross - 1) {
        const int k = __ffs(cross) - 1;
        const int64_t a = __shfl_sync(0xffffffffu, s0, k);
        const int64_t b = __shfl_sync(0xffffffffu, s1, k);
        const float acc = fold_span(head + p * n_chunks, tail + p * n_chunks,
                                    a, b, lane);
        if (lane == 0) y[p * R + r0 + k] = acc;
    }
}

// Nnz phase 1: grid (ceil(N / 1024), P). Thread t takes entries
// 4t .. 4t + 3 of the block. Writes y for the runs inside the block, head /
// tail for the block's first and last runs.
__global__ void spmv_coo_phase1_kernel(const int* __restrict__ rows,
                                       const int* __restrict__ cols,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ c,
                                       float* __restrict__ y,
                                       float* __restrict__ head,
                                       float* __restrict__ tail,
                                       int64_t N, int m, int max_rows,
                                       int64_t n_blocks) {
    constexpr int kNone = 0x7fffffff;    // the row of an entry past the end
    __shared__ int warp_first_row[kThreads / kWarp];
    __shared__ int warp_last_row[kThreads / kWarp];
    __shared__ float warp_last_sum[kThreads / kWarp];

    const int64_t p = blockIdx.y;
    const int64_t lo = int64_t(blockIdx.x) * kNnzBlock;
    const int64_t hi = lo + kNnzBlock < N ? lo + kNnzBlock : N;
    const int64_t i0 = lo + int64_t(threadIdx.x) * kPer;
    const int lane = threadIdx.x % kWarp;
    const int w = threadIdx.x / kWarp;
    const int* prows = rows + p * N;

    // the thread's entries; v[j] becomes the sum of its run up to entry j
    int r[kPer];
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        r[j] = kNone;
        v[j] = 0.f;
        if (i0 + j < hi) {
            r[j] = prows[i0 + j];
            v[j] = vals[p * N + i0 + j]
                   * __ldg(c + clamp_index(cols[p * N + i0 + j], m));
        }
    }
#pragma unroll
    for (int j = 1; j < kPer; ++j)
        if (r[j] == r[j - 1]) v[j] += v[j - 1];

    // Segmented inclusive scan of the threads' last runs within the warp:
    // rows are sorted, so lane t - d ends on the row lane t ends on exactly
    // when the run spans all of lanes t - d + 1 .. t. s is then the sum of
    // the run of row `last` up to this thread's last entry.
    const int last = r[kPer - 1];
    float s = v[kPer - 1];
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, d);
        const int up_last = __shfl_up_sync(0xffffffffu, last, d);
        if (lane >= d && up_last == last) s += up;
    }
    // the carry into the thread's first run: earlier lanes, then earlier
    // warps of the block, nearest first
    const float s_prev = __shfl_up_sync(0xffffffffu, s, 1);
    const int last_prev = __shfl_up_sync(0xffffffffu, last, 1);
    const int next_first = __shfl_down_sync(0xffffffffu, r[0], 1);
    float carry = lane > 0 && last_prev == r[0] ? s_prev : 0.f;
    if (lane == 0) warp_first_row[w] = r[0];
    if (lane == kWarp - 1) {
        warp_last_row[w] = last;
        warp_last_sum[w] = s;
    }
    __syncthreads();
    if (i0 >= hi) return;
    if (warp_first_row[w] == r[0]) {
        for (int k = w - 1; k >= 0; --k) {
            if (warp_last_row[k] != r[0]) break;
            carry += warp_last_sum[k];
            if (warp_first_row[k] != r[0]) break;
        }
    }
    const int after = lane < kWarp - 1 ? next_first
        : w + 1 < kThreads / kWarp ? warp_first_row[w + 1] : kNone;
    const int block_first = warp_first_row[0];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int64_t i = i0 + j;
        const bool last_run = i == hi - 1;   // the block's last run ends here
        if (i >= hi || !(last_run || (j + 1 < kPer ? r[j + 1] : after) != r[j]))
            continue;
        const float sum = r[j] == r[0] ? v[j] + carry : v[j];
        const bool first_run = r[j] == block_first;
        const int64_t edge = p * n_blocks + blockIdx.x;
        if (first_run) head[edge] = sum;
        if (last_run) tail[edge] = sum;
        const bool cross = (first_run && lo > 0 && prows[lo - 1] == r[j])
                           || (last_run && hi < N && prows[hi] == r[j]);
        if (!cross && r[j] >= 0 && r[j] < max_rows)
            y[p * max_rows + r[j]] = sum;
    }
}

// Nnz phase 2: a warp per 32 block edges e (the first entry of block e)
// of a piece, e >= 1; grid (ceil(n_blocks / 256), P). The
// lane at a row's first crossing edge finds its last block b1 (the last
// block whose first id is the row) and the warp writes
// y[row] = tail[e - 1] + head[e] + ... + head[b1].
__global__ void spmv_coo_phase2_kernel(const int* __restrict__ rows,
                                       const float* __restrict__ head,
                                       const float* __restrict__ tail,
                                       float* __restrict__ y, int64_t N,
                                       int max_rows, int64_t n_blocks) {
    const int64_t p = blockIdx.y;
    const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x % kWarp;
    if (e - lane >= n_blocks) return;                 // warp-uniform
    const int* prows = rows + p * N;
    int row = -1;
    int64_t b1 = 0;
    if (e >= 1 && e < n_blocks) {
        const int r = prows[e * kNnzBlock];
        const bool starts = prows[e * kNnzBlock - 1] == r
            && (e == 1 || prows[(e - 1) * kNnzBlock - 1] != r);
        if (starts && r >= 0 && r < max_rows) {
            // the last block k >= e with rows[k . 1024] == r
            int64_t lo_b = e, hi_b = n_blocks;
            while (hi_b - lo_b > 1) {
                const int64_t mid = (lo_b + hi_b) >> 1;
                if (__ldg(prows + mid * kNnzBlock) == r) lo_b = mid;
                else hi_b = mid;
            }
            row = r;
            b1 = lo_b;
        }
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, row >= 0); todo;
         todo &= todo - 1) {
        const int k = __ffs(todo) - 1;
        const int64_t a = e - lane + k - 1;
        const int64_t b = __shfl_sync(0xffffffffu, b1, k);
        const int r = __shfl_sync(0xffffffffu, row, k);
        const float acc = fold_span(head + p * n_blocks, tail + p * n_blocks,
                                    a, b, lane);
        if (lane == 0) y[p * max_rows + r] = acc;
    }
}

inline unsigned blocks_for_warps(int64_t warps) {
    return unsigned((warps * kWarp + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// head, tail: (P, n_chunks) f32 scratch, n_chunks = ceil((R + N) / 256);
// y: (P, R), every element written.
int spmv_csr_rows(const int* pos, const int* crd, const float* vals,
                  const float* c, float* head, float* tail, float* y, int P,
                  int R, int64_t N, int m, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_chunks = (int64_t(R) + N + kItems - 1) / kItems;
    dim3 grid1(blocks_for_warps(n_chunks), unsigned(P));
    spmv_rows_phase1_kernel<<<grid1, kThreads, 0, s>>>(
        pos, crd, vals, c, y, head, tail, R, N, m, n_chunks);
    int err = int(cudaGetLastError());
    if (err != 0) return err;
    const int64_t groups = (int64_t(R) + kWarp - 1) / kWarp;
    dim3 grid2(blocks_for_warps(groups), unsigned(P));
    spmv_rows_phase2_kernel<<<grid2, kThreads, 0, s>>>(
        pos, head, tail, y, R, N, n_chunks);
    return int(cudaGetLastError());
}

// head, tail: (P, ceil(N / 1024)) f32 scratch; y: (P, max_rows), cleared
// here, so every element is written.
int spmv_coo_nnz(const int* rows, const int* cols, const float* vals,
                 const float* c, float* head, float* tail, float* y,
                 int P, int64_t N, int m, int max_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = int(cudaMemsetAsync(
        y, 0, size_t(P) * size_t(max_rows) * sizeof(float), s));
    if (err != 0) return err;
    const int64_t n_blocks = (N + kNnzBlock - 1) / kNnzBlock;
    dim3 grid1(static_cast<unsigned>(n_blocks), static_cast<unsigned>(P));
    spmv_coo_phase1_kernel<<<grid1, kThreads, 0, s>>>(
        rows, cols, vals, c, y, head, tail, N, m, max_rows, n_blocks);
    err = int(cudaGetLastError());
    if (err != 0 || n_blocks < 2) return err;
    const int64_t groups = (n_blocks + kWarp - 1) / kWarp;
    dim3 grid2(blocks_for_warps(groups), unsigned(P));
    spmv_coo_phase2_kernel<<<grid2, kThreads, 0, s>>>(
        rows, head, tail, y, N, max_rows, n_blocks);
    return int(cudaGetLastError());
}

}  // extern "C"
