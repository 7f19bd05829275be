// SpMTTKRP leaf for Hopper (sm_90a): A(i, l) = sum over the stored entries
// (i, j, k, v) of v . C[j, l] . D[k, l], over the lowered path's stacked,
// flattened per-piece entry streams (row, j, k, val), batched over pieces.
// One kernel serves the three lowered leaves: CSF rows (the stream is
// flattened at lower time), COO3 rows and the nnz strategy.
//
// spmttkrp_coo replaces the TPU kernel src/repro/kernels/spmttkrp.py:70
// spmttkrp_ell.
//
// What bounds it on this card: bytes. Each stored entry is read once
// (row + j + k + val = 16 B), C (J, L) and D (K, L) once, and A written
// once; at L = 32 the 3L flops per entry are below the byte time in f32.
// In practice every entry gathers an L-row of C and of D; at the main
// path's shapes both factors (8 MB each) stay in the 50 MB L2.
//
// What the design does about it: the TPU kernel re-blocks the stream into
// row-block ELL and reduces with a one-hot matmul, because the TPU has no
// scatter (layout.py:1-22). Here the stream is read as it is, and the work
// is cut into fixed 256-entry segments, not rows, so a slice of 1.6 M
// entries is spread over thousands of warps (the skew that makes the rows
// kernels of SpMV and SpMM slow). The scheme is spmv_coo_nnz's, made
// deterministic the same way, with the lanes on l:
//  - Phase 1: one warp per (segment, 32-wide tile of l). The lanes load 32
//    entries at a time with coalesced loads and hand them out by shuffles;
//    each lane sums its column of the current row run in entry order, so
//    every gather of C or D is one 128-byte read at L = 32. A run that lies
//    inside the segment, touching neither edge, belongs to no other
//    segment and is written to A directly. The run at the segment's start
//    goes to head[seg], the run at its end (when it is another row) to
//    tail[seg].
//  - Phase 2: one warp per (segment, tile) again. A row cut by segment
//    edges is owned by the segment where it starts: that warp adds its
//    edge partial and then the head partials of the following segments
//    that continue the row (found by binary search over the segments'
//    first rows), in segment order, and writes the row once.
// Every output is written once, with no float atomics, so results repeat
// bit for bit. Rows stay int32.
//
// Contract: row ids are non-decreasing within a piece. Ids below 0 or
// at/after max_rows are dropped (the padding carries max_rows); A is
// zeroed by the caller, so rows without entries stay 0.
//
// The entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;   // 8 warps per block
constexpr int kSeg = 256;       // entries per segment

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct Stream {
    const int* rows;      // this piece's rows
    int64_t N;
    int64_t nseg;
    __device__ int64_t seg_lo(int64_t s) const { return s * kSeg; }
    __device__ int64_t seg_hi(int64_t s) const {
        const int64_t hi = (s + 1) * kSeg;
        return hi < N ? hi : N;
    }
    __device__ int first_row(int64_t s) const { return __ldg(rows + s * kSeg); }
    __device__ int last_row(int64_t s) const { return __ldg(rows + seg_hi(s) - 1); }
};

// grid (ceil(nseg * n_tiles / 8), P)
__global__ void spmttkrp_phase1_kernel(const int* __restrict__ rows,
                                       const int* __restrict__ jj,
                                       const int* __restrict__ kk,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ C,
                                       const float* __restrict__ D,
                                       float* __restrict__ head,
                                       float* __restrict__ tail,
                                       float* __restrict__ A,
                                       int64_t N, int J, int K, int L,
                                       int max_rows, int n_tiles,
                                       int64_t nseg) {
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int64_t wid = int64_t(blockIdx.x) * (kThreads / kWarp)
                        + threadIdx.x / kWarp;
    if (wid >= nseg * n_tiles) return;           // warp-uniform
    const int64_t seg = wid / n_tiles;
    const int l = int(wid % n_tiles) * kWarp + lane;
    const bool live = l < L;
    const Stream st{rows + p * N, N, nseg};
    const int* pj = jj + p * N;
    const int* pk = kk + p * N;
    const float* pv = vals + p * N;
    const int64_t lo = st.seg_lo(seg), hi = st.seg_hi(seg);
    int cur = st.first_row(seg);
    if (cur >= max_rows || st.last_row(seg) < 0) return;   // all dropped
    float* Ap = A + p * int64_t(max_rows) * L;
    const int64_t edge = (p * nseg + seg) * L + l;

    bool at_head = true;
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int64_t e = base + lane;
        int r_l = 0, j_l = 0, k_l = 0;
        float v_l = 0.f;
        if (e < hi) {
            r_l = st.rows[e];
            j_l = clamp_index(pj[e], J);
            k_l = clamp_index(pk[e], K);
            v_l = pv[e];
        }
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        for (int t = 0; t < cnt; ++t) {
            const int r = __shfl_sync(0xffffffffu, r_l, t);
            const int64_t j = __shfl_sync(0xffffffffu, j_l, t);
            const int64_t k = __shfl_sync(0xffffffffu, k_l, t);
            const float v = __shfl_sync(0xffffffffu, v_l, t);
            if (r != cur) {                      // warp-uniform: a run ends
                if (at_head) {
                    if (live) head[edge] = acc;
                    at_head = false;
                } else if (live && cur >= 0 && cur < max_rows) {
                    Ap[int64_t(cur) * L + l] = acc;
                }
                acc = 0.f;
                cur = r;
            }
            if (live) acc += v * __ldg(C + j * L + l) * __ldg(D + k * L + l);
        }
    }
    if (live) (at_head ? head : tail)[edge] = acc;
}

// The head partials of segments t0, t0+1, ... whose first row is r, added
// in segment order.
__device__ float chain_sum(const Stream& st, const float* __restrict__ head,
                           int64_t piece_edge0, int L, int l, int64_t t0,
                           int r) {
    if (t0 >= st.nseg || st.first_row(t0) != r) return 0.f;
    // first segment at or after t0 whose first row is past r
    int64_t a = t0 + 1, b = st.nseg;
    while (a < b) {
        const int64_t mid = (a + b) >> 1;
        if (st.first_row(mid) <= r) a = mid + 1;
        else b = mid;
    }
    float acc = 0.f;
#pragma unroll 8
    for (int64_t t = t0; t < a; ++t)
        acc += __ldg(head + (piece_edge0 + t) * L + l);
    return acc;
}

__global__ void spmttkrp_phase2_kernel(const int* __restrict__ rows,
                                       const float* __restrict__ head,
                                       const float* __restrict__ tail,
                                       float* __restrict__ A,
                                       int64_t N, int L, int max_rows,
                                       int n_tiles, int64_t nseg) {
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int64_t wid = int64_t(blockIdx.x) * (kThreads / kWarp)
                        + threadIdx.x / kWarp;
    if (wid >= nseg * n_tiles) return;           // warp-uniform
    const int64_t seg = wid / n_tiles;
    const int l = int(wid % n_tiles) * kWarp + lane;
    const bool live = l < L;
    const Stream st{rows + p * N, N, nseg};
    const int64_t e0 = p * nseg;                 // this piece's first edge slot
    float* Ap = A + p * int64_t(max_rows) * L;
    const int hr = st.first_row(seg), tr = st.last_row(seg);
    const bool multi = hr != tr;
    const int lc = live ? l : 0;                 // dead lanes read in bounds
    // the tail's row starts here
    if (multi && tr >= 0 && tr < max_rows) {
        float acc = tail[(e0 + seg) * L + lc];
        acc += chain_sum(st, head, e0, L, lc, seg + 1, tr);
        if (live) Ap[int64_t(tr) * L + l] = acc;
    }
    // the head's row starts here
    if (hr >= 0 && hr < max_rows
            && (seg == 0 || st.last_row(seg - 1) != hr)) {
        float acc = head[(e0 + seg) * L + lc];
        if (!multi) acc += chain_sum(st, head, e0, L, lc, seg + 1, hr);
        if (live) Ap[int64_t(hr) * L + l] = acc;
    }
}

}  // namespace

extern "C" {

// rows, j, k, vals: (P, N); C: (J, L); D: (K, L); head, tail: (P, nseg, L)
// scratch with nseg = ceil(N / 256); A: (P, max_rows, L), zeroed.
int spmttkrp_coo(const int* rows, const int* j, const int* k,
                 const float* vals, const float* C, const float* D,
                 float* head, float* tail, float* A, int P, int64_t N,
                 int J, int K, int L, int max_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = (L + kWarp - 1) / kWarp;
    const int64_t nseg = (N + kSeg - 1) / kSeg;
    const int64_t warps = nseg * n_tiles;
    dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads), unsigned(P));
    spmttkrp_phase1_kernel<<<grid, kThreads, 0, s>>>(
        rows, j, k, vals, C, D, head, tail, A, N, J, K, L, max_rows, n_tiles,
        nseg);
    int err = int(cudaGetLastError());
    if (err != 0) return err;
    spmttkrp_phase2_kernel<<<grid, kThreads, 0, s>>>(
        rows, head, tail, A, N, L, max_rows, n_tiles, nseg);
    return int(cudaGetLastError());
}

}  // extern "C"
