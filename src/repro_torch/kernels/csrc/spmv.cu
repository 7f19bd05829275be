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
//  - spmv_coo_nnz: the TPU kernel's two-phase scheme, made deterministic.
//    Phase 1 takes fixed 256-entry blocks, forms each entry's product, runs a
//    segmented scan over equal row ids and stores the partial sum of every
//    row run at the run's last position. Phase 2 gives one warp to each 32
//    rows of a piece. Lane k finds row k's position range by binary search
//    over the sorted row ids; then, row by row, the lanes add the run
//    partials of the blocks the range touches, in lane-strided block order,
//    with a fixed shuffle tree, and the warp stores its 32 sums at once.
//    (A first version, a warp per row reading a row pointer that phase 1
//    built with one thread per run of empty rows, took 2.6 ms at 2^21 rows
//    and 25.1 M entries on an H100 SXM at 700 W; this one 0.67 ms.)
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
constexpr int kNnzBlock = kThreads;     // entries per phase-1 block

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

// Rows phase 2: a warp per 32 rows of a piece, for the rows that cross
// chunks: lane l adds the partials of chunks first + l, first + l + 32, ...
// in order, kFold loads in flight, then a fixed shuffle tree; grid
// (ceil(groups * 32 / 256), P).
constexpr int kFold = 8;

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
    const float* hp = head + p * n_chunks;
    const float* tp = tail + p * n_chunks;
    for (unsigned cross = __ballot_sync(0xffffffffu, s1 != s0); cross;
         cross &= cross - 1) {
        const int k = __ffs(cross) - 1;
        const int64_t a = __shfl_sync(0xffffffffu, s0, k);
        const int64_t b = __shfl_sync(0xffffffffu, s1, k);
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
        acc = warp_sum(acc);
        if (lane == 0) y[p * R + r0 + k] = acc;
    }
}

// Phase 1: grid (ceil(N / 256), P).
__global__ void spmv_coo_phase1_kernel(const int* __restrict__ rows,
                                       const int* __restrict__ cols,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ c,
                                       float* __restrict__ partial,
                                       int64_t N, int m) {
    __shared__ int warp_first_row[kThreads / kWarp];
    __shared__ int warp_last_row[kThreads / kWarp];
    __shared__ float warp_last_sum[kThreads / kWarp];

    const int64_t p = blockIdx.y;
    const int64_t i = int64_t(blockIdx.x) * kNnzBlock + threadIdx.x;
    const int lane = threadIdx.x % kWarp;
    const int w = threadIdx.x / kWarp;
    const bool live = i < N;

    int row = 0x7fffffff;                // sentinel past the piece's end
    float v = 0.f;
    if (live) {
        row = rows[p * N + i];
        v = vals[p * N + i] * __ldg(c + clamp_index(cols[p * N + i], m));
    }

    // Segmented inclusive scan within the warp: rows are sorted, so lane
    // j - d holds the same row as lane j exactly when the run spans both.
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
        float up = __shfl_up_sync(0xffffffffu, v, d);
        int up_row = __shfl_up_sync(0xffffffffu, row, d);
        if (lane >= d && up_row == row) v += up;
    }
    const int next_row = __shfl_down_sync(0xffffffffu, row, 1);
    if (lane == 0) warp_first_row[w] = row;
    if (lane == kWarp - 1) {
        warp_last_row[w] = row;
        warp_last_sum[w] = v;
    }
    __syncthreads();
    if (!live) return;

    // Carry the run in from earlier warps of this block, nearest first.
    if (warp_first_row[w] == row) {
        for (int k = w - 1; k >= 0; --k) {
            if (warp_last_row[k] != row) break;
            v += warp_last_sum[k];
            if (warp_first_row[k] != row) break;
        }
    }
    bool run_end;
    if (threadIdx.x == kThreads - 1 || i == N - 1) {
        run_end = true;
    } else if (lane == kWarp - 1) {
        run_end = warp_first_row[w + 1] != row;
    } else {
        run_end = next_row != row;
    }
    if (run_end) partial[p * N + i] = v;
}

// First position in a[0, n) whose id is >= key (a sorted).
__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long n, int key) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < key) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Phase 2: one warp per 32 consecutive rows of a piece.
__global__ void spmv_coo_phase2_kernel(const int* __restrict__ rows,
                                       const float* __restrict__ partial,
                                       float* __restrict__ y,
                                       int P, int64_t N, int max_rows) {
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    const int64_t groups = (int64_t(max_rows) + kWarp - 1) / kWarp;
    if (warp >= int64_t(P) * groups) return;
    const int64_t p = warp / groups;
    const int64_t r = (warp % groups) * kWarp + lane;
    const int* prows = rows + p * N;
    const float* pa = partial + p * N;
    long long lo_l = 0, hi_l = 0;
    if (r < max_rows) {
        lo_l = lower_bound(prows, N, int(r));
        hi_l = lower_bound(prows, N, int(r) + 1);
    }
    float mine = 0.f;
    for (int k = 0; k < kWarp; ++k) {
        const long long lo = __shfl_sync(0xffffffffu, lo_l, k);
        const long long hi = __shfl_sync(0xffffffffu, hi_l, k);
        float acc = 0.f;
        if (hi > lo) {
            const long long b1 = (hi - 1) / kNnzBlock;
            for (long long b = lo / kNnzBlock + lane; b <= b1; b += kWarp) {
                const long long last = b * kNnzBlock + kNnzBlock - 1;
                acc += pa[last < hi - 1 ? last : hi - 1];
            }
        }
        acc = warp_sum(acc);
        if (lane == k) mine = acc;
    }
    if (r < max_rows) y[p * max_rows + r] = mine;
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

// partial: (P, N) f32 scratch.
int spmv_coo_nnz(const int* rows, const int* cols, const float* vals,
                 const float* c, float* partial, float* y,
                 int P, int64_t N, int m, int max_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid1(unsigned((N + kNnzBlock - 1) / kNnzBlock), unsigned(P));
    spmv_coo_phase1_kernel<<<grid1, kThreads, 0, s>>>(
        rows, cols, vals, c, partial, N, m);
    int err = int(cudaGetLastError());
    if (err != 0) return err;
    const int64_t groups = (int64_t(max_rows) + kWarp - 1) / kWarp;
    spmv_coo_phase2_kernel<<<blocks_for_warps(int64_t(P) * groups), kThreads,
                             0, s>>>(rows, partial, y, P, N, max_rows);
    return int(cudaGetLastError());
}

}  // extern "C"
