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
// wants (8, 128) tiles (layout.py:1-22). Here one warp owns one
// (piece, row, 32-column tile of J): lanes own the columns, so every gather
// of a row of C (kept (K, J) row-major) is one coalesced 128-byte read, and
// the row's (crd, val) pairs are loaded 32 at a time with one coalesced load
// and handed to the lanes by shuffles. Each lane sums its column over the
// row's entries in storage order, so results repeat bit for bit; the last
// tile masks columns >= J. A row's work is not split across warps, so the
// longest row of a power-law matrix bounds the time; the nnz strategy is
// the fix for that.
//
// spmm_coo_nnz (row-sorted COO shards, rows rebased to the piece's window)
// is bound by bytes the same way: 12 B per stored entry, one gathered row
// of C per entry and Y written once. Its design is spmv_coo_nnz's scheme
// (spmv.cu) with lanes on 32-column tiles of J, so no entry's work is
// repeated and a row of any length is spread over many warps:
//  - Phase 1: a warp per (piece, 256-entry segment, column tile). The
//    segment's (row, col, val) triples are read 32 at a time with one
//    coalesced load and handed to the lanes by shuffles; the 32 gathers
//    of C rows are issued before the sums, so they are in flight together.
//    A run of equal row ids that lies in this segment alone is summed in
//    storage order and written to Y. A run that crosses the segment's
//    start goes to head[seg], one that crosses its end (and not its start)
//    to tail[seg].
//  - Phase 2: a warp per 32 rows of a piece. Lane k finds row k's position
//    range by binary search over the sorted ids. Row by row, the lanes
//    (on columns) write 0 for an empty row and, for a row that crosses
//    segments, tail[first segment] plus head[each later segment] in
//    segment order. Rows that phase 1 wrote are left alone.
// Every output element is written once, with no float atomics, so results
// repeat bit for bit.
//
// Contract of spmm_coo_nnz (spmv_coo_nnz's): row ids are non-decreasing
// within a piece; ids below 0 or at/after max_rows are dropped. Columns
// are clamped into [0, K).
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps per block
constexpr int kSeg = 256;      // entries per spmm_coo_nnz segment

__global__ void spmm_csr_rows_kernel(const int* __restrict__ pos,
                                     const int* __restrict__ crd,
                                     const float* __restrict__ vals,
                                     const float* __restrict__ C,
                                     float* __restrict__ Y,
                                     int P, int R, int64_t N, int K, int J,
                                     int n_tiles) {
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (warp >= int64_t(P) * R * n_tiles) return;
    const int tile = int(warp % n_tiles);
    const int64_t pr = warp / n_tiles;            // p * R + r
    const int64_t p = pr / R;
    const int64_t r = pr % R;
    const int j = tile * kWarp + lane;
    const bool live = j < J;

    const int* prow = pos + p * (int64_t(R) + 1);
    int64_t lo = prow[r], hi = prow[r + 1];
    lo = lo < 0 ? 0 : (lo > N ? N : lo);
    hi = hi < lo ? lo : (hi > N ? N : hi);
    const int* pc = crd + p * N;
    const float* pv = vals + p * N;

    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int64_t e = base + lane;
        int k_l = 0;
        float v_l = 0.f;
        if (e < hi) {
            const int k = pc[e];
            k_l = k < 0 ? 0 : (k >= K ? K - 1 : k);
            v_l = pv[e];
        }
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        for (int t = 0; t < cnt; ++t) {
            const int k = __shfl_sync(0xffffffffu, k_l, t);
            const float v = __shfl_sync(0xffffffffu, v_l, t);
            if (live) acc += v * __ldg(C + int64_t(k) * J + j);
        }
    }
    if (live) Y[pr * J + j] = acc;
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
    int cur = __ldg(pr + lo);
    int64_t run_lo = lo;
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        int r_l = INT_MAX, c_l = 0;
        float v_l = 0.f;
        if (lane < cnt) {
            r_l = pr[base + lane];
            const int c = pc[base + lane];
            c_l = c < 0 ? 0 : (c >= K ? K - 1 : c);
            v_l = pv[base + lane];
        }
        float cv[kWarp];
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
            const int c = __shfl_sync(0xffffffffu, c_l, t);
            cv[t] = (t < cnt && live) ? __ldg(C + int64_t(c) * J + j) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
            const int row = __shfl_sync(0xffffffffu, r_l, t);
            const float v = __shfl_sync(0xffffffffu, v_l, t);
            if (t >= cnt) break;                      // warp-uniform
            if (row != cur) {                         // a run ends here
                if (run_lo == lo && open_lo) {
                    if (live) head[edge] = acc;
                } else if (live && cur >= 0 && cur < max_rows) {
                    Yp[int64_t(cur) * J + j] = acc;
                }
                acc = 0.f;
                cur = row;
                run_lo = base + t;
            }
            if (row >= 0 && row < max_rows) acc += v * cv[t];
        }
    }
    // the segment's last run
    if (run_lo == lo && open_lo) {
        if (live) head[edge] = acc;
    } else if (open_hi) {
        if (live) tail[edge] = acc;
    } else if (live && cur >= 0 && cur < max_rows) {
        Yp[int64_t(cur) * J + j] = acc;
    }
}

// First position in a[0, n) whose id is >= key (a sorted).
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ a,
                                               int64_t n, int key) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < key) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Phase 2: a warp per 32 consecutive rows of a piece; grid
// (ceil(P * groups * 32 / 256)).
__global__ void spmm_coo_phase2_kernel(const int* __restrict__ rows,
                                       const float* __restrict__ head,
                                       const float* __restrict__ tail,
                                       float* __restrict__ Y,
                                       int P, int64_t N, int J, int max_rows,
                                       int64_t nseg) {
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    const int64_t groups = (int64_t(max_rows) + kWarp - 1) / kWarp;
    if (warp >= int64_t(P) * groups) return;          // warp-uniform
    const int64_t p = warp / groups;
    const int64_t r0 = (warp % groups) * kWarp;
    const int* pr = rows + p * N;
    int64_t lo_l = 0, hi_l = 0;
    if (r0 + lane < max_rows) {
        lo_l = lower_bound(pr, N, int(r0 + lane));
        hi_l = lower_bound(pr, N, int(r0 + lane) + 1);
    }
    float* Yp = Y + p * int64_t(max_rows) * J;
    const int64_t e0 = p * nseg;                      // this piece's edges
    const int last = max_rows - r0 < kWarp ? int(max_rows - r0) : kWarp;
    for (int k = 0; k < last; ++k) {
        const int64_t lo = __shfl_sync(0xffffffffu, lo_l, k);
        const int64_t hi = __shfl_sync(0xffffffffu, hi_l, k);
        float* out = Yp + (r0 + k) * J;
        if (hi == lo) {                               // an empty row
            for (int j = lane; j < J; j += kWarp) out[j] = 0.f;
            continue;
        }
        const int64_t s0 = lo / kSeg, s1 = (hi - 1) / kSeg;
        if (s0 == s1) continue;                       // phase 1 wrote it
        for (int j = lane; j < J; j += kWarp) {
            float acc = __ldg(tail + (e0 + s0) * J + j);
            for (int64_t s = s0 + 1; s <= s1; ++s)
                acc += __ldg(head + (e0 + s) * J + j);
            out[j] = acc;
        }
    }
}

}  // namespace

extern "C" {

int spmm_csr_rows(const int* pos, const int* crd, const float* vals,
                  const float* C, float* Y, int P, int R, int64_t N, int K,
                  int J, void* stream) {
    const int n_tiles = (J + kWarp - 1) / kWarp;
    const int64_t warps = int64_t(P) * R * n_tiles;
    const unsigned blocks = unsigned((warps * kWarp + kThreads - 1) / kThreads);
    spmm_csr_rows_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pos, crd, vals, C, Y, P, R, N, K, J, n_tiles);
    return int(cudaGetLastError());
}

// rows, cols, vals: (P, N); C: (K, J); head, tail: (P, nseg, J) scratch
// with nseg = ceil(N / 256); Y: (P, max_rows, J), every element written.
int spmm_coo_nnz(const int* rows, const int* cols, const float* vals,
                 const float* C, float* head, float* tail, float* Y, int P,
                 int64_t N, int K, int J, int max_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = (J + kWarp - 1) / kWarp;
    const int64_t nseg = (N + kSeg - 1) / kSeg;
    const int64_t warps1 = nseg * n_tiles;
    dim3 grid1(unsigned((warps1 * kWarp + kThreads - 1) / kThreads),
               unsigned(P));
    spmm_coo_phase1_kernel<<<grid1, kThreads, 0, s>>>(
        rows, cols, vals, C, head, tail, Y, N, K, J, max_rows, n_tiles, nseg);
    int err = int(cudaGetLastError());
    if (err != 0) return err;
    const int64_t groups = (int64_t(max_rows) + kWarp - 1) / kWarp;
    const int64_t warps2 = int64_t(P) * groups;
    const unsigned blocks2 = unsigned((warps2 * kWarp + kThreads - 1)
                                      / kThreads);
    spmm_coo_phase2_kernel<<<blocks2, kThreads, 0, s>>>(
        rows, head, tail, Y, P, N, J, max_rows, nseg);
    return int(cudaGetLastError());
}

}  // extern "C"
