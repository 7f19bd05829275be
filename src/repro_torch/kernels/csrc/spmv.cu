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
// shards directly, so only real entries (and the shard's padding tail, which
// no row range covers) cost bytes:
//  - spmv_csr_rows: one warp per (piece, row). Lanes read the row's entries
//    with coalesced, lane-strided loads and reduce with a fixed shuffle tree.
//    A row's work is not split across warps, so a power-law matrix leaves one
//    warp with its longest row; the nnz strategy is the fix for that.
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
//    and 25.1 M entries on an H100 SXM at 700 W; this one 0.67 ms.) Every
//    output is written once, with no float atomics, so results repeat bit
//    for bit. Row ids stay int32 throughout (the TPU kernel carries them
//    through an f32 matmul, exact only to 2^24).
//
// Contract of spmv_coo_nnz: row ids are non-decreasing within a piece. Ids
// below 0 or at/after max_rows are dropped, as segment_sum drops them.
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void spmv_csr_rows_kernel(const int* __restrict__ pos,
                                     const int* __restrict__ crd,
                                     const float* __restrict__ vals,
                                     const float* __restrict__ c,
                                     float* __restrict__ y,
                                     int P, int R, int64_t N, int m) {
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (warp >= int64_t(P) * R) return;
    const int64_t p = warp / R;
    const int64_t r = warp % R;
    const int* prow = pos + p * (R + 1);
    int64_t lo = prow[r], hi = prow[r + 1];
    lo = lo < 0 ? 0 : (lo > N ? N : lo);
    hi = hi < lo ? lo : (hi > N ? N : hi);
    const int* pc = crd + p * N;
    const float* pv = vals + p * N;
    float acc = 0.f;
    for (int64_t e = lo + lane; e < hi; e += kWarp)
        acc += pv[e] * __ldg(c + clamp_index(pc[e], m));
    acc = warp_sum(acc);
    if (lane == 0) y[p * R + r] = acc;
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

int spmv_csr_rows(const int* pos, const int* crd, const float* vals,
                  const float* c, float* y, int P, int R, int64_t N, int m,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    spmv_csr_rows_kernel<<<blocks_for_warps(int64_t(P) * R), kThreads, 0, s>>>(
        pos, crd, vals, c, y, P, R, N, m);
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
