// SpMTTKRP leaf for Hopper (sm_90a): A(i, l) = sum over the stored entries
// (i, j, k, v) of v . C[j, l] . D[k, l], over the lowered path's stacked,
// flattened per-piece entry streams (row, j, k, val), batched over pieces.
// One kernel serves the three lowered leaves: CSF rows (the stream is
// flattened at lower time), COO3 rows and the nnz strategy.
//
// spmttkrp_coo replaces the TPU kernel src/repro/kernels/spmttkrp.py:70
// spmttkrp_ell.
//
// What bounds it on this card: bytes, and the latency of gathering them.
// Each stored entry is read once (row + j + k + val = 16 B), C (J, L) and
// D (K, L) once, and A written once; at L = 32 the 3L flops per entry are
// below the byte time in f32. In practice every entry gathers an L-row of
// C and of D; at the main path's shapes both factors (8 MB each) stay in
// the 50 MB L2, so the gathers are L2 reads, 256 B an entry at L = 32.
//
// What the design does about it: the TPU kernel re-blocks the stream into
// row-block ELL and reduces with a one-hot matmul, because the TPU has no
// scatter (layout.py:1-22). Here the stream is read as it is, cut into
// fixed 256-entry segments, not rows, so a slice of 1.6 M entries is spread
// over thousands of warps; it is spmm_coo_nnz's scheme (spmm.cu) with a
// second gathered factor:
//  - A is cleared once by the caller, so a row with no entry needs no
//    writer.
//  - Phase 1: a warp per (piece, segment, 32-wide tile of l), lanes on l,
//    so every gather of C or D is one 128-byte line at L = 32. The
//    segment's (row, j, k, val) entries come 32 at a time with one
//    coalesced load each and are handed out by shuffles; kAhead entries'
//    lines of C and of D are all gathered before their FMAs (2 kAhead
//    loads a lane in flight). An entry with a dropped id gathers nothing,
//    and a segment of dropped ids only (a piece's padding tail under the
//    rows strategy) returns at once. Which entries end a run comes from
//    one ballot per 32 (each lane compares its id with the next). Each lane sums its column of a
//    run in entry order from 0, acc += v . C . D: a run that lies in this
//    segment alone is written to A, its only writer; one that crosses the
//    segment's start goes to head[seg], one that crosses its end (and not
//    its start) to tail[seg].
//  - The fold (segment_fold.cuh, shared with spmm_coo_nnz): group sums of
//    64 heads, then a thread per segment edge takes each row that crosses
//    edges at its first edge and writes tail[first] + the heads before the
//    first whole group + the groups' sums + the heads after, in that
//    order: the longest slice (about 6,230 segments) folds at most 97
//    group sums and 126 heads, not 6,230 heads one at a time.
// (The first version gathered one entry's lines at a time, four
// shuffles and a run test per entry, and folded a long row one head at a
// time along a chain found by binary search: 1.573 ms for the spmttkrp
// rows cell (17.2 M entries, L = 32) on an NVIDIA H100 80GB HBM3 at 700 W.)
// Every output is written once, with no float atomics, so results repeat
// bit for bit. Rows stay int32.
//
// Contract: row ids are non-decreasing within a piece. Ids below 0 or
// at/after max_rows are dropped (the padding carries max_rows); A is
// zeroed by the caller, so rows without entries stay 0. j and k are
// clamped into [0, J) and [0, K).
//
// The entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_fold.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;   // 8 warps per block
constexpr int kSeg = 256;       // entries per segment
constexpr int kAhead = 4;       // entries gathered before their FMAs

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// grid (ceil(nseg * n_tiles * 32 / 256), P). At most 51 registers, so
// that five blocks (40 warps) fit an SM: on the H100 more warps hid more of
// the gathers' latency than more entries ahead of each warp (16 entries
// ahead took 74 registers and 1.60 ms against 1.28 at 4 and 48 registers,
// on the spmttkrp rows cell; PERF.md has the sweep).
__global__ void __launch_bounds__(kThreads, 5)
spmttkrp_phase1_kernel(const int* __restrict__ rows,
                       const int* __restrict__ jj,
                       const int* __restrict__ kk,
                       const float* __restrict__ vals,
                       const float* __restrict__ C,
                       const float* __restrict__ D,
                       float* __restrict__ head, float* __restrict__ tail,
                       float* __restrict__ A, int64_t N, int J, int K,
                       int L, int max_rows, int n_tiles, int64_t nseg) {
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int64_t warp = (int64_t(blockIdx.x) * kThreads + threadIdx.x)
                         / kWarp;
    if (warp >= nseg * n_tiles) return;          // warp-uniform
    const int64_t seg = warp / n_tiles;
    const int l = int(warp % n_tiles) * kWarp + lane;
    const bool live = l < L;
    const int* pr = rows + p * N;
    const int* pj = jj + p * N;
    const int* pk = kk + p * N;
    const float* pv = vals + p * N;
    const int64_t lo = seg * kSeg;
    const int64_t hi = lo + kSeg < N ? lo + kSeg : N;
    // a segment of dropped ids only (a piece's padding tail) writes nothing
    if (__ldg(pr + lo) >= max_rows || __ldg(pr + hi - 1) < 0) return;
    // does the run of the segment's first / last id go on beyond it?
    const bool open_lo = lo > 0 && __ldg(pr + lo - 1) == __ldg(pr + lo);
    const bool open_hi = hi < N && __ldg(pr + hi) == __ldg(pr + hi - 1);
    const int64_t edge = (p * nseg + seg) * L + l;
    float* Ap = A + p * int64_t(max_rows) * L + l;   // this lane's column
    const float* Cl = C + l;
    const float* Dl = D + l;
    bool first = true;                 // still in the segment's first run?
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
        const int cnt = hi - base < kWarp ? int(hi - base) : kWarp;
        // lane t holds entry t's (row, j, k, val); a dropped id's entry
        // has j = -1 (no gather) and val 0
        int r_l = -1, j_l = -1, k_l = 0;
        float v_l = 0.f;
        if (lane < cnt) {
            r_l = pr[base + lane];
            if (r_l >= 0 && r_l < max_rows) {
                j_l = clamp_index(pj[base + lane], J);
                k_l = clamp_index(pk[base + lane], K);
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
#pragma unroll 1
        for (int t0 = 0; t0 < cnt; t0 += kAhead) {     // warp-uniform
            float cv[kAhead], dv[kAhead];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {           // every gather first
                const int j = __shfl_sync(0xffffffffu, j_l, t0 + u);
                const int k = __shfl_sync(0xffffffffu, k_l, t0 + u);
                const bool use = j >= 0 && live;
                cv[u] = use ? __ldg(Cl + int64_t(j) * L) : 0.f;
                dv[u] = use ? __ldg(Dl + int64_t(k) * L) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
                const int t = t0 + u;
                const float v = __shfl_sync(0xffffffffu, v_l, t);
                if (t >= cnt) break;                     // warp-uniform
                acc += v * cv[u] * dv[u];
                if ((mask >> t) & 1u) {                  // a run ends here
                    const int row = __shfl_sync(0xffffffffu, r_l, t);
                    if (live) {
                        if (first && open_lo) head[edge] = acc;
                        else if (row >= 0 && row < max_rows)
                            Ap[int64_t(row) * L] = acc;
                    }
                    acc = 0.f;
                    first = false;
                }
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
        Ap[int64_t(last) * L] = acc;
    }
}

}  // namespace

extern "C" {

// rows, j, k, vals: (P, N); C: (J, L); D: (K, L); head, tail: (P, nseg, L)
// and group: (P, nseg / 64, L) f32 scratch with nseg = ceil(N / 256); A:
// (P, max_rows, L), zeroed.
int spmttkrp_coo(const int* rows, const int* j, const int* k,
                 const float* vals, const float* C, const float* D,
                 float* head, float* tail, float* group, float* A, int P,
                 int64_t N, int J, int K, int L, int max_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = (L + kWarp - 1) / kWarp;
    const int64_t nseg = (N + kSeg - 1) / kSeg;
    const int64_t warps = nseg * n_tiles;
    dim3 grid(unsigned((warps * kWarp + kThreads - 1) / kThreads), unsigned(P));
    spmttkrp_phase1_kernel<<<grid, kThreads, 0, s>>>(
        rows, j, k, vals, C, D, head, tail, A, N, J, K, L, max_rows, n_tiles,
        nseg);
    const int err = int(cudaGetLastError());
    if (err != 0 || nseg < 2) return err;
    return segment_fold::fold_rows<kSeg>(rows, head, tail, group, A, P, N, L,
                                         max_rows, nseg, s);
}

}  // extern "C"
