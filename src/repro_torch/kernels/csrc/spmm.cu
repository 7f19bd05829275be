// SpMM leaf for Hopper (sm_90a): Y = B . C over the lowered path's stacked
// per-piece CSR row shards, batched over pieces.
//
// spmm_csr_rows replaces the TPU kernel src/repro/kernels/spmm.py:54
// spmm_ell (rows strategy).
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
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps per block

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

}  // extern "C"
