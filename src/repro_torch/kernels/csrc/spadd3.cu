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
//      BCSR) shards, written as one CSR over the P * R rows. Count, then
//      fill, with an exclusive scan between them (done by the caller). The
//      work is cut into merge tasks of about `task` input entries, not
//      rows, so a row of ~4 M entries spreads over many tasks: task j > 0
//      of a row starts at 1 + the (j * task)-th smallest column of the
//      row, so equal columns of the three lists never straddle two tasks.
//      A bounds pass (a thread per task) finds each task's row and where it
//      starts in each list, once, by a discarding k-th search. A warp then
//      merges a unit of consecutive tasks, up to 32 (most rows hold a few
//      entries, and a warp each would idle), by the key (task, column):
//      windows of each list staged in shared memory with coalesced loads,
//      two merge paths (B with C, then D) for the merged order, a ballot to
//      number the union entries, and in the fill lanes on (union entry,
//      tile cell) summing each entry in merged order, so loads and stores
//      are contiguous. A union entry sums as 0 + B's entries + C's + D's,
//      each in storage order, tiles element by element. (The first version
//      gave each task a thread that searched its bounds in both passes and
//      merged serially, its loads uncoalesced and a tile summed in device
//      memory: 3.05 + 14.63 ms scalar and 0.79 + 9.38 ms for (4, 4) tiles
//      over the 75.4 M- and 5.9 M-entry add streams at 2^21 rows, on an
//      NVIDIA H100 80GB HBM3 at 700 W.)
//    - spadd3_union_runs: the nnz strategy's cross-chunk union. Its order
//      depends only on the add stream's coordinates, so the caller sorts
//      them once at lower time into a two-level CSR: run_ptr (one run per
//      output coordinate) over seg_ptr (one segment per chunk within a run)
//      over perm (stream slots in stream order). The kernel sums each
//      segment in stream order and the segments in chunk order, the
//      reference's order (per-chunk union, then the host dedupe): 0 + each
//      segment's entries, then 0 + the segments. A warp takes 32
//      consecutive runs, whose index walk plan_runs lays out as three
//      contiguous slices (their run_ptr, the seg_ptr of their segments, the
//      perm of their entries): it reads each slice with coalesced loads
//      into shared memory, so no lane walks a chain of dependent loads.
//      Lanes then go on (run, tile quad), 16-byte gathers of the values
//      (or (run, tile cell) and 4-byte ones, where the tile is not a
//      multiple of 4 floats or the values' base is off a 16-byte boundary),
//      the first entries of four steps' runs gathered before any add, and
//      the 32 runs' sums leave as contiguous stores. Scalar values keep a
//      thread per run walking run_ptr -> seg_ptr -> perm -> vals, the
//      first version's kernel, which was faster there (PERF.md).
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
    int64_t lo[3], hi[3];
};

__device__ Row load_row(const Three& ops, int R, int64_t g) {
    const int64_t p = g / R, r = g % R;
    Row w;
    for (int t = 0; t < 3; ++t) {
        const int* pp = ops.pos[t] + p * (R + 1);
        w.lo[t] = __ldg(pp + r);
        w.hi[t] = __ldg(pp + r + 1);
        w.crd[t] = ops.crd[t] + p * ops.N[t];
    }
    return w;
}

// The k-th smallest column (1-based) of the entries of lists t in
// [st[t], hi[t]), 1 <= k <= their count, by discarding: with s = max(1,
// k / 3), the list whose s-th remaining column (or last, if shorter) is
// least (the earliest list on a tie) gives up that many columns, all of
// them among the k - 1 smallest, and k shrinks by as many: about
// log_1.5(k) rounds of three independent loads. st[t] ends where every
// column before it is at most the result.
__device__ int64_t kth_column(const Row& w, const int64_t* hi, int64_t k,
                              int64_t* st) {
    while (true) {
        const int64_t s = k / 3 > 1 ? k / 3 : 1;
        int64_t best = INT64_MAX, take = 0;
        int m = 0;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            const int64_t len = hi[t] - st[t];
            if (len > 0) {
                const int64_t a = k == 1 ? 1 : (s < len ? s : len);
                const int64_t v = __ldg(w.crd[t] + st[t] + a - 1);
                if (v < best) {
                    best = v;
                    m = t;
                    take = a;
                }
            }
        }
        if (k == 1) return best;
#pragma unroll
        for (int t = 0; t < 3; ++t)
            if (t == m) st[t] += take;
        k -= take;
    }
}

// v = 1 + the k-th smallest column of lists t in [b[t], hi[t]) (all
// columns before b[t] lie below it), and b[t] becomes each list's lower
// bound of v; the three searches run side by side.
__device__ int64_t split_in(const Row& w, const int64_t* hi, int64_t k,
                            int64_t* b) {
    const int64_t v = kth_column(w, hi, k, b) + 1;
    int64_t e[3] = {hi[0], hi[1], hi[2]};
    while (b[0] < e[0] || b[1] < e[1] || b[2] < e[2]) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            if (b[t] < e[t]) {
                const int64_t m = (b[t] + e[t]) >> 1;
                if (int64_t(__ldg(w.crd[t] + m)) < v) b[t] = m + 1;
                else e[t] = m;
            }
        }
    }
    return v;
}

// A thread per merge task t: its row g (the last g with task_off[g] <= t),
// where it starts and ends in each list (tbeg / tend, 3 per task) and its
// unit, (unit_at[g] + j * task) / task for task j of the row; ufirst[u]
// becomes the first task of unit u. Task j > 0 of a row starts at v_j =
// 1 + the (j * task)-th smallest column of the row, so equal columns never
// straddle two tasks. The lanes of a warp that split one row search
// together: the first and the last of them search the row's whole lists,
// the others only between those two results (v_j is non-decreasing in j),
// in a few cached lines.
__global__ void union_bounds_kernel(Three ops, int R, int64_t task,
                                    const int64_t* __restrict__ task_off,
                                    const int64_t* __restrict__ unit_at,
                                    int64_t n_flat, int64_t T,
                                    int* __restrict__ trow,
                                    int* __restrict__ tbeg,
                                    int* __restrict__ tend,
                                    int* __restrict__ tunit,
                                    int* __restrict__ ufirst) {
    const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x % 32;
    if (t - lane >= T) return;                        // warp-uniform
    // the row of task x: the last g with task_off[g] <= x
    auto row_of = [&](int64_t x) {
        int64_t lo = 0, hi = n_flat + 1;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (__ldg(task_off + mid) <= x) lo = mid + 1;
            else hi = mid;
        }
        return lo - 1;
    };
    auto unit_of = [&](int64_t x, int64_t row) {
        return (__ldg(unit_at + row) + (x - __ldg(task_off + row)) * task)
               / task;
    };
    int64_t g = -1, j = 0, u = -1;
    bool last = false;
    Row w{};
    if (t < T) {
        g = row_of(t);
        j = t - __ldg(task_off + g);
        last = t + 1 == __ldg(task_off + g + 1);
        u = unit_of(t, g);
        w = load_row(ops, R, g);
    }
    // task t - 1's unit: the lane before's, or found again by lane 0
    int64_t u_prev = __shfl_up_sync(0xffffffffu, u, 1);
    if (lane == 0 && t > 0 && t < T) u_prev = unit_of(t - 1, row_of(t - 1));
    // the lanes splitting one row, and its first and last of them
    const unsigned group = __match_any_sync(
        0xffffffffu, j > 0 ? g : -1 - int64_t(lane));
    const int lane_a = __ffs(group) - 1, lane_b = 31 - __clz(group);
    int64_t b[3] = {w.lo[0], w.lo[1], w.lo[2]};
    if (j > 0 && (lane == lane_a || lane == lane_b))
        split_in(w, w.hi, j * task, b);
    int64_t b_lo[3], b_hi[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        b_lo[s] = __shfl_sync(0xffffffffu, b[s], lane_a);
        b_hi[s] = __shfl_sync(0xffffffffu, b[s], lane_b);
    }
    if (j > 0 && lane != lane_a && lane != lane_b) {
        // v_j is v_a when at least j * task entries lie below it, else 1 +
        // the k-th smallest column of [b_lo, b_hi) for the k entries more
        // it needs (b_lo, b_hi: the lower bounds of lanes a's and b's v)
#pragma unroll
        for (int s = 0; s < 3; ++s) b[s] = b_lo[s];
        const int64_t n = b[0] - w.lo[0] + b[1] - w.lo[1] + b[2] - w.lo[2];
        if (n < j * task) split_in(w, b_hi, j * task - n, b);
    }
    if (t >= T) return;
    trow[t] = int(g);
    for (int s = 0; s < 3; ++s) {
        tbeg[3 * t + s] = int(b[s]);
        if (j > 0) tend[3 * (t - 1) + s] = int(b[s]);
        if (last) tend[3 * t + s] = int(w.hi[s]);
    }
    tunit[t] = int(u);
    if (t == 0 || u_prev != u) ufirst[u] = int(t);
}

// First i in [0, n) with a[i] >= x, a sorted, in shared memory.
__device__ __forceinline__ int lower_key(const int64_t* a, int n, int64_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

constexpr int kWin = 128;        // entries of each list staged per window
constexpr int kTaskWarps = kThreads / 32;
constexpr int64_t kColBias = int64_t(1) << 31;

constexpr int kBatch = 4;        // fill items a lane has in flight

// Where the values of staged entry `code` (list << 8 | index, as in the
// merged order) begin, vb[t] being list t's first staged value.
__device__ __forceinline__ const float* entry_val(const float* const* vb,
                                                  int code, int tile) {
    const int t = (code >> 8) & 3;
    const float* v = t == 0 ? vb[0] : (t == 1 ? vb[1] : vb[2]);
    return v + (code & 0xff) * tile;
}

// An entry's merge key: (task within the unit, column).
__device__ __forceinline__ int64_t merge_key(int k, int col) {
    return (int64_t(k) << 32) + (int64_t(col) + kColBias);
}

__device__ __forceinline__ int key_col(int64_t key) {
    return int((key & 0xffffffffll) - kColBias);
}

// The task (lane index) of position q of a list whose tasks' first
// positions lane k holds in tb, among tasks [ta, tz): the last k with
// tb[k] <= q. Warp-uniform call.
__device__ __forceinline__ int task_of(int tb, int ta, int tz, int64_t q) {
    int k = ta;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
        const int n = k + step;
        const int v = __shfl_sync(0xffffffffu, tb, n & 31);
        if (n < tz && v <= q) k = n;
    }
    return k;
}

// Merges sorted runs A (na entries) and B (nb) into out, A's entry first
// on equal keys, out[d] = the code of the d-th: lane l writes the outputs
// from d = l * n / 32 on, after finding how many of the first d come from
// A (a binary search along the diagonal), then one entry a step.
template <class KA, class KB, class CA, class CB>
__device__ __forceinline__ void merge_path(int lane, int na, int nb,
                                           uint16_t* out, KA ka, KB kb,
                                           CA ca, CB cb) {
    const int n = na + nb;
    const int d0 = lane * n / 32, d1 = (lane + 1) * n / 32;
    int lo = d0 > nb ? d0 - nb : 0, hi = d0 < na ? d0 : na;
    while (lo < hi) {
        const int i = (lo + hi) >> 1;
        if (ka(i) <= kb(d0 - 1 - i)) lo = i + 1;
        else hi = i;
    }
    int ia = lo, ib = d0 - lo;
    for (int d = d0; d < d1; ++d) {
        const bool from_a = ib >= nb || (ia < na && ka(ia) <= kb(ib));
        out[d] = uint16_t(from_a ? ca(ia++) : cb(ib++));
    }
}

// A warp per unit of consecutive merge tasks (at most 32: the caller's
// unit_at spaces tasks at least task / 32 apart), so a row of a few
// entries does not cost a warp of its own; each task belongs to one unit.
// Counts each task's union entries into cnt (kFill false) or writes them
// from out_crd[at], out_vals[at * tile] on (kFill true), at = out_off of
// the unit's first task. The tasks of one piece are contiguous in each
// list; their entries are merged in windows by the key (task, column): up
// to kWin entries of each list are staged in shared memory with coalesced
// loads, and the window takes the entries below L, the least key not
// staged of a list that did not fit (all of them if every list fit), so a
// union entry's entries are never split between windows. Two merge paths,
// B with C and then that with D, each lane merging its own stretch, give
// the merged order with equal keys in B, C, D order, each list in storage
// order; a union entry starts where the key changes, and a ballot numbers
// them. The fill sums each union entry's entries in merged order from 0, a
// lane per (union entry, tile cell), so consecutive lanes read and write
// consecutive floats. A column with more than kWin entries of one list in
// one task (only duplicates make one) is summed by lanes on tile cells,
// entry by entry.
// (At most 64 registers, so four blocks fit an SM: fewer warps made both
// passes slower on the card.)
template <bool kFill>
__global__ void __launch_bounds__(kThreads, 4)
union_rows_kernel(Three ops, int R, int tile, const int* __restrict__ trow,
                  const int* __restrict__ tbeg, const int* __restrict__ tend,
                  const int* __restrict__ tunit,
                  const int* __restrict__ ufirst, int64_t n_units,
                  int64_t T, int* __restrict__ cnt,
                  const int64_t* __restrict__ out_off,
                  int* __restrict__ out_crd, float* __restrict__ out_vals) {
    __shared__ int64_t keys_s[kTaskWarps][3 * kWin];
    // B and C merged, then all three: (list << 8) | index per entry
    __shared__ uint16_t bc_s[kTaskWarps][2 * kWin];
    __shared__ uint16_t order_s[kTaskWarps][3 * kWin];
    __shared__ uint16_t ustart_s[kFill ? kTaskWarps : 1][3 * kWin + 1];
    __shared__ int count_s[kFill ? 1 : kTaskWarps][32];
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t unit = int64_t(blockIdx.x) * kTaskWarps + wid;
    if (unit >= n_units) return;                      // warp-uniform
    const int t0 = __ldg(ufirst + unit);
    if (t0 < 0) return;                               // no task starts here
    const unsigned lower = (1u << lane) - 1;
    const int64_t tl = int64_t(t0) + lane;
    const int nk = __popc(__ballot_sync(
        0xffffffffu, tl < T && __ldg(tunit + tl) == int(unit)));
    // lane k < nk: task t0 + k's row and bounds
    int g = -1, tb[3] = {0, 0, 0}, te[3] = {0, 0, 0};
    if (lane < nk) {
        g = __ldg(trow + tl);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            tb[s] = __ldg(tbeg + 3 * tl + s);
            te[s] = __ldg(tend + 3 * tl + s);
        }
    }
    int64_t* keys = keys_s[wid];
    uint16_t* bc = bc_s[wid];
    uint16_t* order = order_s[wid];
    uint16_t* ustart = ustart_s[kFill ? wid : 0];
    int* count = count_s[kFill ? 0 : wid];
    if (!kFill) count[lane] = 0;
    const int64_t at = kFill ? __ldg(out_off + t0) : 0;
    int n_out = 0;
    for (int ta = 0; ta < nk;) {
        // the span [ta, tz): the unit's tasks of one piece
        const int p = __shfl_sync(0xffffffffu, g, ta) / R;
        const unsigned other = __ballot_sync(
            0xffffffffu, lane > ta && lane < nk && g / R != p);
        const int tz = other ? __ffs(other) - 1 : nk;
        int cur[3], end[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            cur[s] = __shfl_sync(0xffffffffu, tb[s], ta);
            end[s] = __shfl_sync(0xffffffffu, te[s], tz - 1);
        }
        // list s of piece p
        auto crd = [&](int s) { return ops.crd[s] + int64_t(p) * ops.N[s]; };
        auto val = [&](int s) {
            return ops.vals[s] + int64_t(p) * ops.N[s] * tile;
        };
        while (true) {
            int take[3], n[3];
#pragma unroll
            for (int s = 0; s < 3; ++s)
                take[s] = end[s] - cur[s] < kWin ? end[s] - cur[s] : kWin;
            if (take[0] + take[1] + take[2] == 0) break;
            // stage the window's keys: each list's columns loaded at once
            int64_t L = INT64_MAX;
#pragma unroll
            for (int s = 0; s < 3; ++s) {
                int col[kWin / 32];
#pragma unroll
                for (int m = 0; m < kWin / 32; ++m) {
                    const int i = m * 32 + lane;
                    col[m] = i < take[s] ? __ldg(crd(s) + cur[s] + i) : 0;
                }
                if (end[s] - cur[s] > kWin) {
                    const int q = cur[s] + kWin;
                    const int64_t key = merge_key(task_of(tb[s], ta, tz, q),
                                                  __ldg(crd(s) + q));
                    L = key < L ? key : L;
                }
#pragma unroll
                for (int m = 0; m < kWin / 32; ++m) {
                    if (m * 32 >= take[s]) break;         // warp-uniform
                    const int i = m * 32 + lane;
                    const int k = tz - ta == 1
                        ? ta : task_of(tb[s], ta, tz, cur[s] + i);
                    if (i < take[s]) keys[s * kWin + i] = merge_key(k, col[m]);
                }
            }
            __syncwarp();
#pragma unroll
            for (int s = 0; s < 3; ++s)
                n[s] = L == INT64_MAX ? take[s]
                                      : lower_key(keys + s * kWin, take[s],
                                                  L);
            const int nt = n[0] + n[1] + n[2];
            if (nt == 0) {
                // key L (task k, column c) holds more than kWin entries of
                // one list: it is the next union entry; its entries end at
                // each list's upper bound of c inside task k
                const int k = int(L >> 32), c = key_col(L);
                int e2[3];
#pragma unroll
                for (int s = 0; s < 3; ++s) {
                    const int k_end = __shfl_sync(0xffffffffu, te[s], k);
                    e2[s] = int(lower_bound(crd(s), cur[s],
                                            k_end > cur[s] ? k_end : cur[s],
                                            int64_t(c) + 1));
                }
                if (kFill) {
                    if (lane == 0) out_crd[at + n_out] = c;
                    for (int kk = lane; kk < tile; kk += 32) {
                        float acc = 0.f;
#pragma unroll
                        for (int s = 0; s < 3; ++s)  // B, then C, then D
                            for (int e = cur[s]; e < e2[s]; ++e)
                                acc += __ldg(val(s) + int64_t(e) * tile + kk);
                        out_vals[(at + n_out) * tile + kk] = acc;
                    }
                } else if (lane == 0) {
                    count[k] += 1;
                }
                ++n_out;
#pragma unroll
                for (int s = 0; s < 3; ++s) cur[s] = e2[s];
                __syncwarp();
                continue;
            }
            // the merged order: B with C, then that with D (merge paths,
            // earlier list first on equal keys)
            auto key = [&](int code) {
                return keys[(code >> 8) * kWin + (code & 0xff)];
            };
            merge_path(lane, n[0], n[1], bc,
                       [&](int i) { return keys[i]; },
                       [&](int i) { return keys[kWin + i]; },
                       [&](int i) { return i; },
                       [&](int i) { return (1 << 8) | i; });
            __syncwarp();
            merge_path(lane, n[0] + n[1], n[2], order,
                       [&](int i) { return key(bc[i]); },
                       [&](int i) { return keys[2 * kWin + i]; },
                       [&](int i) { return int(bc[i]); },
                       [&](int i) { return (2 << 8) | i; });
            __syncwarp();
            // union entry u starts at merged position ustart[u]: where the
            // key differs from the one before
            int U = 0;
            for (int r0 = 0; r0 < nt; r0 += 32) {
                const int r = r0 + lane;
                int64_t x = 0;
                bool first = false;
                if (r < nt) {
                    x = key(order[r]);
                    first = r == 0 || key(order[r - 1]) != x;
                }
                const unsigned b = __ballot_sync(0xffffffffu, first);
                if (kFill && first)
                    ustart[U + __popc(b & lower)] = uint16_t(r);
                else if (!kFill && first)
                    atomicAdd(count + int(x >> 32), 1);
                U += __popc(b);
            }
            if (kFill) {
                if (lane == 0) ustart[U] = uint16_t(nt);
                __syncwarp();
                const float* vb[3];
#pragma unroll
                for (int s = 0; s < 3; ++s)
                    vb[s] = val(s) + int64_t(cur[s]) * tile;
                for (int u = lane; u < U; u += 32) {
                    const int code = order[ustart[u]];
                    out_crd[at + n_out + u] = key_col(
                        keys[((code >> 8) & 3) * kWin + (code & 0xff)]);
                }
                // kBatch items a lane, the first three entries of each
                // loaded before any is added
                float* dst = out_vals + (at + n_out) * tile;
                const int items = U * tile;
                for (int it0 = 0; it0 < items; it0 += 32 * kBatch) {
                    float a[kBatch][3];
                    int rb[kBatch], re[kBatch], kc[kBatch];
#pragma unroll
                    for (int m = 0; m < kBatch; ++m) {
                        const int it = it0 + m * 32 + lane;
                        rb[m] = re[m] = kc[m] = 0;
                        if (it < items) {
                            const int u = it / tile;
                            kc[m] = it - u * tile;
                            rb[m] = ustart[u];
                            re[m] = ustart[u + 1];
                        }
#pragma unroll
                        for (int e = 0; e < 3; ++e)
                            a[m][e] = rb[m] + e < re[m]
                                ? __ldg(entry_val(vb, order[rb[m] + e], tile)
                                        + kc[m]) : 0.f;
                    }
#pragma unroll
                    for (int m = 0; m < kBatch; ++m) {
                        const int it = it0 + m * 32 + lane;
                        if (it >= items) continue;
                        float acc = 0.f + a[m][0];
                        if (rb[m] + 1 < re[m]) acc += a[m][1];
                        if (rb[m] + 2 < re[m]) acc += a[m][2];
                        for (int r = rb[m] + 3; r < re[m]; ++r)
                            acc += __ldg(entry_val(vb, order[r], tile)
                                         + kc[m]);
                        dst[it] = acc;
                    }
                }
            }
            n_out += U;
#pragma unroll
            for (int s = 0; s < 3; ++s) cur[s] += n[s];
            __syncwarp();
        }
        ta = tz;
    }
    if (!kFill) {
        __syncwarp();
        if (lane < nk) cnt[t0 + lane] = count[lane];
    }
}

// spadd3_union_runs, tiles of more than one float: a warp per 32
// consecutive runs u0 .. u0 + nu - 1.
// Their segments s0 .. s1 - 1 and entries e0 .. e1 - 1 are contiguous
// (plan_runs), so the warp stages seg_ptr[s0 .. s1] and perm[e0 .. e1) in
// shared memory, up to kSegCap + 1 and kPermCap of them (a longer walk
// reads the rest from device memory, in the same order). Item it of the
// warp is (run it / nq, element W (it % nq)), W = 4 floats (VEC) or 1, so
// the warp's items are its runs' output floats in order; a lane takes
// items lane, lane + 32, ... and gathers the first kAheadEnt entries of
// kAheadSteps items before any add. Each output float is
// 0 + (0 + the entries of segment 0 in order) + (0 + segment 1's) + ...,
// exactly union_runs_plain's order and that of union_runs_kernel below,
// so the bits are that kernel's.
constexpr int kRunWarps = kThreads / 32;
constexpr int kSegCap = 128;     // seg_ptr entries a warp stages, + 1
constexpr int kPermCap = 256;    // perm entries a warp stages
constexpr int kAheadSteps = 4;   // items a lane gathers for before adding
constexpr int kAheadEnt = 3;     // entries an item gathers ahead
static_assert(kAheadEnt == 3, "the add loop picks x[a][0..2] by hand");

template <bool VEC>
struct Lanes {
    using V = float;
    static constexpr int W = 1;
    __device__ static V zero() { return 0.f; }
    __device__ static V load(const float* p) { return __ldg(p); }
    __device__ static void add(V& a, V b) { a += b; }
    __device__ static void store(float* p, V v) { *p = v; }
};

template <>
struct Lanes<true> {
    using V = float4;
    static constexpr int W = 4;
    __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static V load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    __device__ static void add(V& a, V b) {
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
    }
    __device__ static void store(float* p, V v) {
        *reinterpret_cast<float4*>(p) = v;
    }
};

// At most 80 registers, so that three blocks (24 warps) fit an SM: the walk
// is latency-bound, and more warps hide more of it than more registers do
// (spadd3/bcsr/nnz device ms on an NVIDIA H100 80GB HBM3 at 700 W: 102
// registers, 16 warps 0.559; 80 registers and 56 bytes spilled, 24 warps
// 0.449; 64 registers, 32 warps 0.576).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
union_runs_warp_kernel(const float* __restrict__ vals,
                  const int* __restrict__ perm,
                  const int* __restrict__ seg_ptr,
                  const int* __restrict__ run_ptr, float* __restrict__ out,
                  int64_t U, int tile) {
    using L = Lanes<VEC>;
    using V = typename L::V;
    __shared__ int s_seg[kRunWarps][kSegCap + 1];
    __shared__ int s_perm[kRunWarps][kPermCap];
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int64_t u0 = (int64_t(blockIdx.x) * kRunWarps + w) * 32;
    if (u0 >= U) return;                              // warp-uniform
    const int nu = U - u0 < 32 ? int(U - u0) : 32;
    // the walk: run_ptr[u0 .. u0 + nu], then the two slices it bounds
    const int rp = lane < nu ? __ldg(run_ptr + u0 + lane) : 0;
    const int s0 = __shfl_sync(0xffffffffu, rp, 0);
    const int s1 = __ldg(run_ptr + u0 + nu);
    const int ns = s1 - s0 + 1;
    for (int i = lane; i < ns && i <= kSegCap; i += 32)
        s_seg[w][i] = __ldg(seg_ptr + s0 + i);
    __syncwarp();
    auto seg_at = [&](int s) {
        return s - s0 <= kSegCap ? s_seg[w][s - s0] : __ldg(seg_ptr + s);
    };
    const int e0 = s_seg[w][0];
    const int ne = seg_at(s1) - e0;
    for (int i = lane; i < ne && i < kPermCap; i += 32)
        s_perm[w][i] = __ldg(perm + e0 + i);
    __syncwarp();
    auto value = [&](int e, int k) {                  // entry e, float k..
        const int slot = e - e0 < kPermCap ? s_perm[w][e - e0]
                                           : __ldg(perm + e);
        return L::load(vals + int64_t(slot) * tile + k);
    };
    const int nq = tile / L::W;                       // items a run
    const int items = nu * nq;
    float* dst = out + u0 * tile;
    for (int it0 = 0; it0 < items; it0 += 32 * kAheadSteps) {
        int sb[kAheadSteps], se[kAheadSteps], eb[kAheadSteps];
        int k[kAheadSteps];
        V x[kAheadSteps][kAheadEnt];                  // every gather first
#pragma unroll
        for (int a = 0; a < kAheadSteps; ++a) {
            const int it = it0 + 32 * a + lane;
            const int run = it < items ? it / nq : nu - 1;
            const int next = __shfl_sync(0xffffffffu, rp, (run + 1) & 31);
            sb[a] = __shfl_sync(0xffffffffu, rp, run);
            se[a] = run + 1 < nu ? next : s1;
            k[a] = (it - run * nq) * L::W;
            eb[a] = seg_at(sb[a]);
            const int ee = seg_at(se[a]);
#pragma unroll
            for (int i = 0; i < kAheadEnt; ++i)
                x[a][i] = it < items && eb[a] + i < ee
                    ? value(eb[a] + i, k[a]) : L::zero();
        }
#pragma unroll
        for (int a = 0; a < kAheadSteps; ++a) {
            const int it = it0 + 32 * a + lane;
            if (it >= items) break;
            V total = L::zero();
            int e = eb[a];
            for (int s = sb[a]; s < se[a]; ++s) {
                V part = L::zero();
                for (const int end = seg_at(s + 1); e < end; ++e) {
                    const int i = e - eb[a];
                    V v = i == 0 ? x[a][0] : i == 1 ? x[a][1]
                        : i == 2 ? x[a][2] : value(e, k[a]);
                    L::add(part, v);
                }
                L::add(total, part);
            }
            L::store(dst + int64_t(it) * L::W, total);
        }
    }
}

// spadd3_union_runs, scalar values: one thread per run, the same order.
// (The warp kernel with lanes on runs took 1.70 ms of device time against
// this kernel's 0.64 on the spadd3/csr/nnz cell: its walk is four
// dependent loads for 32 floats of output; PERF.md.)
__global__ void union_runs_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ seg_ptr,
                                  const int* __restrict__ run_ptr,
                                  float* __restrict__ out, int64_t U) {
    const int64_t u = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (u >= U) return;
    float total = 0.f;
    for (int s = __ldg(run_ptr + u); s < __ldg(run_ptr + u + 1); ++s) {
        float part = 0.f;
        for (int e = __ldg(seg_ptr + s); e < __ldg(seg_ptr + s + 1); ++e)
            part += __ldg(vals + __ldg(perm + e));
        total += part;
    }
    out[u] = total;
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

// task_off (P * R + 1): each row's first task; unit_at (P * R + 1): the
// nominal position of each row's first task, tasks of one row task apart
// and of different rows at least task / 32 apart; n_units = ceil(the last
// nominal position / task); ufirst (n_units) filled with -1. fill ==
// 0: trow (T,), tbeg and tend (T, 3), tunit (T,) and ufirst get each
// task's row, bounds and unit and each unit's first task, then cnt (T,)
// each task's union count; fill == 1: out_crd and out_vals get the union,
// task t's entries from out_off[t] on.
int spadd3_union_rows(const int* pos1, const int* crd1, const float* v1,
                      int64_t N1, const int* pos2, const int* crd2,
                      const float* v2, int64_t N2, const int* pos3,
                      const int* crd3, const float* v3, int64_t N3, int P,
                      int R, int tile, int64_t task, const int64_t* task_off,
                      const int64_t* unit_at, int64_t T, int64_t n_units,
                      int* trow, int* tbeg, int* tend, int* tunit,
                      int* ufirst, int* cnt, const int64_t* out_off,
                      int* out_crd, float* out_vals, int fill,
                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Three ops = three(pos1, crd1, v1, N1, pos2, crd2, v2, N2,
                            pos3, crd3, v3, N3);
    const unsigned blocks = unsigned((n_units + kTaskWarps - 1)
                                     / kTaskWarps);
    if (fill) {
        union_rows_kernel<true><<<blocks, kThreads, 0, s>>>(
            ops, R, tile, trow, tbeg, tend, tunit, ufirst, n_units, T, cnt,
            out_off, out_crd, out_vals);
        return int(cudaGetLastError());
    }
    union_bounds_kernel<<<blocks_for(T), kThreads, 0, s>>>(
        ops, R, task, task_off, unit_at, int64_t(P) * R, T, trow,
        tbeg, tend, tunit, ufirst);
    const int err = int(cudaGetLastError());
    if (err != 0) return err;
    union_rows_kernel<false><<<blocks, kThreads, 0, s>>>(
        ops, R, tile, trow, tbeg, tend, tunit, ufirst, n_units, T, cnt,
        out_off, out_crd, out_vals);
    return int(cudaGetLastError());
}

// out: (U, tile) f32.
int spadd3_union_runs(const float* vals, const int* perm, const int* seg_ptr,
                      const int* run_ptr, float* out, int64_t U, int tile,
                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tile == 1) {
        union_runs_kernel<<<blocks_for(U), kThreads, 0, s>>>(
            vals, perm, seg_ptr, run_ptr, out, U);
        return int(cudaGetLastError());
    }
    // 16-byte gathers and stores need whole quads and aligned bases (a view
    // may start anywhere)
    const bool vec = tile % 4 == 0
                     && reinterpret_cast<uintptr_t>(vals) % 16 == 0
                     && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const unsigned blocks = unsigned((U + 32 * kRunWarps - 1)
                                     / (32 * kRunWarps));
    if (vec)
        union_runs_warp_kernel<true><<<blocks, kThreads, 0, s>>>(
            vals, perm, seg_ptr, run_ptr, out, U, tile);
    else
        union_runs_warp_kernel<false><<<blocks, kThreads, 0, s>>>(
            vals, perm, seg_ptr, run_ptr, out, U, tile);
    return int(cudaGetLastError());
}

}  // extern "C"
