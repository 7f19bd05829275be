// SpAdd3 for Hopper (sm_90a): A(i, j) = B(i, j) + C(i, j) + D(i, j), the
// paper's fused three-way sparse add, in two forms.
//
// 1. spadd3_dense: the dense sum of three CSR operands (tile 1) or of three
//    BCSR operands of one block shape (br, bc). It replaces the TPU kernels
//    src/repro/kernels/spadd3.py:57 spadd3_dense_tiles (scalar) and
//    src/repro/kernels/bcsr.py:214 bcsr_spadd3 (blocked).
//    What bounds it on this card: bytes, and nearly all of them are the
//    dense output (n_rows x n_cols f32, written once); the operands are a
//    small fraction and the adds are one per stored value.
//    Design: the TPU kernels scatter with one-hot matmuls into (8, 128)
//    VMEM tiles because the TPU has no scatter. Here one block owns one
//    block-row (br output rows): it zeroes those rows with coalesced
//    stores, then adds B, C and D into them in that order, a barrier
//    between operands. Within one operand's row the columns are distinct
//    (the wrapper's contract), so no two threads touch one cell at once:
//    no float atomics, and the sum is (0 + B) + C + D on every run.
//
// 2. The compressed form on the lowered path, which is what the reference's
//    leaves (src/repro/kernels/ref.py:130-203, 277-339) return:
//    - spadd3_union_rows: the union of the three operands' sorted column
//      lists in every (piece, row) of the rows strategy's stacked CSR (or
//      BCSR) shards, written as one CSR over the P * R rows. Two launches,
//      count then fill, with an exclusive scan between them (done by the
//      caller). The work is cut into merge tasks of about `task` input
//      entries, not rows: a row of ~4 M entries would otherwise be one
//      thread's serial merge. A row's tasks split its column range at
//      values found by binary search (the smallest column c such that at
//      least j * task of the row's entries lie below c), so equal columns
//      of the three lists never straddle two tasks and each task merges
//      independently. A task sums a union entry as (B + C) + D, tiles
//      element by element.
//    - spadd3_union_runs: the nnz strategy's cross-chunk union. Its order
//      depends only on the add stream's coordinates, so the caller sorts
//      them once at lower time into a two-level CSR: run_ptr (one run per
//      output coordinate) over seg_ptr (one segment per chunk within a run)
//      over perm (stream slots in stream order). The kernel sums each
//      segment in stream order and the segments in chunk order, the
//      reference's order (per-chunk union, then the host dedupe); one
//      thread per output element (coordinate x tile cell).
//    What bounds both on this card: bytes (each stored value read once,
//    each union entry written once; one add per duplicate).
//    No float atomics anywhere: results repeat bit for bit.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Three operands' stacked shards: pos (P, R + 1) piece-local offsets,
// crd (P, N[t]) and vals (P, N[t], tile).
struct Three {
    const int* pos[3];
    const int* crd[3];
    const float* vals[3];
    int64_t N[3];
};

// First index in [lo, hi) of a sorted run whose value is >= v.
__device__ __forceinline__ int64_t lower_bound(const int* a, int64_t lo,
                                               int64_t hi, int64_t v) {
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (int64_t(__ldg(a + mid)) < v) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// grid (n_brows), block kThreads: block g owns rows [g*br, g*br + br).
__global__ void spadd3_dense_kernel(Three ops, float* __restrict__ out,
                                    int64_t n_rows, int64_t n_cols,
                                    int br, int bc) {
    const int64_t g = blockIdx.x;
    const int64_t r0 = g * br;
    const int64_t r1 = r0 + br < n_rows ? r0 + br : n_rows;
    float* rows = out + r0 * n_cols;
    for (int64_t i = threadIdx.x; i < (r1 - r0) * n_cols; i += blockDim.x)
        rows[i] = 0.f;
    __syncthreads();
    const int tile = br * bc;
    for (int t = 0; t < 3; ++t) {
        const int64_t lo = int64_t(__ldg(ops.pos[t] + g)) * tile;
        const int64_t hi = int64_t(__ldg(ops.pos[t] + g + 1)) * tile;
        for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
            const int64_t e = i / tile;
            const int k = int(i - e * tile);
            const int64_t row = r0 + k / bc;
            const int64_t col = int64_t(__ldg(ops.crd[t] + e)) * bc + k % bc;
            if (row < r1 && col >= 0 && col < n_cols)
                out[row * n_cols + col] += __ldg(ops.vals[t] + i);
        }
        __syncthreads();   // the operands add in the order B, C, D
    }
}

// One (piece, row)'s three column lists: [lo[t], hi[t]) of crd[t].
struct Row {
    const int* crd[3];
    const float* vals[3];
    int64_t lo[3], hi[3];
};

__device__ Row load_row(const Three& ops, int R, int tile, int64_t g) {
    const int64_t p = g / R, r = g % R;
    Row w;
    for (int t = 0; t < 3; ++t) {
        const int* pp = ops.pos[t] + p * (R + 1);
        w.lo[t] = __ldg(pp + r);
        w.hi[t] = __ldg(pp + r + 1);
        w.crd[t] = ops.crd[t] + p * ops.N[t];
        w.vals[t] = ops.vals[t] + p * ops.N[t] * tile;
    }
    return w;
}

__device__ int64_t count_below(const Row& w, int64_t v) {
    int64_t n = 0;
    for (int t = 0; t < 3; ++t)
        n += lower_bound(w.crd[t], w.lo[t], w.hi[t], v) - w.lo[t];
    return n;
}

// The smallest column c with count_below(c) >= target, for
// 0 < target < the row's length.
__device__ int64_t split_value(const Row& w, int64_t target) {
    int64_t lo = INT64_MAX, hi = INT64_MIN;
    for (int t = 0; t < 3; ++t) {
        if (w.hi[t] > w.lo[t]) {
            const int64_t a = __ldg(w.crd[t] + w.lo[t]);
            const int64_t b = __ldg(w.crd[t] + w.hi[t] - 1) + 1;
            lo = a < lo ? a : lo;
            hi = b > hi ? b : hi;
        }
    }
    // count_below(lo) == 0 < target <= count_below(hi)
    while (hi - lo > 1) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (count_below(w, mid) >= target) hi = mid;
        else lo = mid;
    }
    return hi;
}

// Task t merges its slice of row g: counts the union entries (kFill false)
// or writes them at out_crd[at], out_vals[at * tile] (kFill true).
template <bool kFill>
__global__ void union_rows_kernel(Three ops, int R, int tile, int64_t task,
                                  const int64_t* __restrict__ task_off,
                                  int64_t n_flat, int64_t T,
                                  int* __restrict__ cnt,
                                  const int64_t* __restrict__ out_off,
                                  int* __restrict__ out_crd,
                                  float* __restrict__ out_vals) {
    const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= T) return;
    // the row: the last g with task_off[g] <= t
    int64_t lo = 0, hi = n_flat + 1;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (__ldg(task_off + mid) <= t) lo = mid + 1;
        else hi = mid;
    }
    const int64_t g = lo - 1;
    const int64_t j = t - __ldg(task_off + g);
    const int64_t n_tasks = __ldg(task_off + g + 1) - __ldg(task_off + g);
    const Row w = load_row(ops, R, tile, g);
    int64_t b[3], e[3];
    const int64_t v_lo = j > 0 ? split_value(w, j * task) : 0;
    const int64_t v_hi = j + 1 < n_tasks ? split_value(w, (j + 1) * task) : 0;
    for (int s = 0; s < 3; ++s) {
        b[s] = j > 0 ? lower_bound(w.crd[s], w.lo[s], w.hi[s], v_lo)
                     : w.lo[s];
        e[s] = j + 1 < n_tasks ? lower_bound(w.crd[s], w.lo[s], w.hi[s], v_hi)
                               : w.hi[s];
    }
    const int64_t at = kFill ? out_off[t] : 0;
    int64_t n = 0;
    while (true) {
        int64_t m = INT64_MAX;
        for (int s = 0; s < 3; ++s)
            if (b[s] < e[s]) {
                const int64_t c = __ldg(w.crd[s] + b[s]);
                m = c < m ? c : m;
            }
        if (m == INT64_MAX) break;
        if (kFill && tile == 1) {
            out_crd[at + n] = int(m);
            float acc = 0.f;
            for (int s = 0; s < 3; ++s)      // B, then C, then D
                for (; b[s] < e[s] && __ldg(w.crd[s] + b[s]) == m; ++b[s])
                    acc += __ldg(w.vals[s] + b[s]);
            out_vals[at + n] = acc;
        } else if (kFill) {
            out_crd[at + n] = int(m);
            float* dst = out_vals + (at + n) * tile;
            for (int k = 0; k < tile; ++k) dst[k] = 0.f;
            for (int s = 0; s < 3; ++s)      // B, then C, then D
                for (; b[s] < e[s] && __ldg(w.crd[s] + b[s]) == m; ++b[s]) {
                    const float* src = w.vals[s] + b[s] * tile;
                    for (int k = 0; k < tile; ++k) dst[k] += __ldg(src + k);
                }
        } else {
            for (int s = 0; s < 3; ++s)
                while (b[s] < e[s] && __ldg(w.crd[s] + b[s]) == m) ++b[s];
        }
        ++n;
    }
    if (!kFill) cnt[t] = int(n);
}

// One thread per (run u, tile cell k).
__global__ void union_runs_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ seg_ptr,
                                  const int* __restrict__ run_ptr,
                                  float* __restrict__ out, int64_t U,
                                  int tile) {
    const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= U * tile) return;
    const int64_t u = i / tile;
    const int k = int(i - u * tile);
    float total = 0.f;
    for (int s = __ldg(run_ptr + u); s < __ldg(run_ptr + u + 1); ++s) {
        float part = 0.f;
        for (int e = __ldg(seg_ptr + s); e < __ldg(seg_ptr + s + 1); ++e)
            part += __ldg(vals + int64_t(__ldg(perm + e)) * tile + k);
        total += part;
    }
    out[i] = total;
}

inline unsigned blocks_for(int64_t threads) {
    return unsigned((threads + kThreads - 1) / kThreads);
}

Three three(const int* pos1, const int* crd1, const float* v1, int64_t N1,
            const int* pos2, const int* crd2, const float* v2, int64_t N2,
            const int* pos3, const int* crd3, const float* v3, int64_t N3) {
    Three ops;
    ops.pos[0] = pos1; ops.pos[1] = pos2; ops.pos[2] = pos3;
    ops.crd[0] = crd1; ops.crd[1] = crd2; ops.crd[2] = crd3;
    ops.vals[0] = v1; ops.vals[1] = v2; ops.vals[2] = v3;
    ops.N[0] = N1; ops.N[1] = N2; ops.N[2] = N3;
    return ops;
}

}  // namespace

extern "C" {

// out: (n_rows, n_cols) f32; pos (n_brows + 1,) over block-rows of br rows.
int spadd3_dense(const int* pos1, const int* crd1, const float* v1,
                 const int* pos2, const int* crd2, const float* v2,
                 const int* pos3, const int* crd3, const float* v3,
                 float* out, int n_brows, int64_t n_rows, int64_t n_cols,
                 int br, int bc, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    spadd3_dense_kernel<<<unsigned(n_brows), kThreads, 0, s>>>(
        three(pos1, crd1, v1, 0, pos2, crd2, v2, 0, pos3, crd3, v3, 0),
        out, n_rows, n_cols, br, bc);
    return int(cudaGetLastError());
}

// fill == 0: cnt (T,) gets each task's union count; fill == 1: out_crd and
// out_vals get the union, task t's entries from out_off[t] on.
int spadd3_union_rows(const int* pos1, const int* crd1, const float* v1,
                      int64_t N1, const int* pos2, const int* crd2,
                      const float* v2, int64_t N2, const int* pos3,
                      const int* crd3, const float* v3, int64_t N3, int P,
                      int R, int tile, int64_t task, const int64_t* task_off,
                      int64_t T, int* cnt, const int64_t* out_off,
                      int* out_crd, float* out_vals, int fill, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Three ops = three(pos1, crd1, v1, N1, pos2, crd2, v2, N2,
                            pos3, crd3, v3, N3);
    const int64_t n_flat = int64_t(P) * R;
    if (fill)
        union_rows_kernel<true><<<blocks_for(T), kThreads, 0, s>>>(
            ops, R, tile, task, task_off, n_flat, T, cnt, out_off, out_crd,
            out_vals);
    else
        union_rows_kernel<false><<<blocks_for(T), kThreads, 0, s>>>(
            ops, R, tile, task, task_off, n_flat, T, cnt, out_off, out_crd,
            out_vals);
    return int(cudaGetLastError());
}

// out: (U, tile) f32.
int spadd3_union_runs(const float* vals, const int* perm, const int* seg_ptr,
                      const int* run_ptr, float* out, int64_t U, int tile,
                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    union_runs_kernel<<<blocks_for(U * tile), kThreads, 0, s>>>(
        vals, perm, seg_ptr, run_ptr, out, U, tile);
    return int(cudaGetLastError());
}

}  // extern "C"
