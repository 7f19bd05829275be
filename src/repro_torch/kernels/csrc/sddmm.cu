// SDDMM leaf for Hopper (sm_90a): out(p) = vals(p) . <C[rows(p), :], Dt[cols(p), :]>
// over the lowered path's stacked per-piece coordinate streams, batched over
// pieces. One kernel serves both strategies: the rows strategy passes a row
// block of C per piece (c_stride = max_rows * K), the nnz strategy one C
// shared by every piece (c_stride = 0).
//
// sddmm_coo replaces the TPU kernel src/repro/kernels/sddmm.py:45 sddmm_coo.
//
// What bounds it on this card: bytes. Each stored position reads its row,
// column and value (12 B), one K-row of C and one K-row of Dt, and writes
// one value; at K = 32 the 2K flops per position are an order of magnitude
// below the byte time in f32. Counted once per input, C and Dt are read
// once; in practice every position gathers its two K-rows, from L2 when the
// factors fit there and from device memory when they do not.
//
// What the design does about it: D is transposed once, at lower time, so
// both gathers read contiguous K-rows (the TPU kernel transposes D for the
// same reason, sddmm.py:59). One warp owns 32 consecutive positions of a
// piece: the lanes load the 32 (row, col, val) triples with one coalesced
// load each, then, position by position, the lanes own k (a loop over
// 32-wide k tiles for K != 32), so each gather is one coalesced 128-byte
// read at K = 32, and a fixed shuffle tree reduces the dot product. Lane t
// keeps the sum of position t, and the warp stores its 32 results at once.
// No float atomics: results repeat bit for bit. Indices are clamped into
// range; padded positions carry vals == 0.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;   // 8 warps per block, 32 positions per warp

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// grid (ceil(N / 256), P)
__global__ void sddmm_coo_kernel(const int* __restrict__ rows,
                                 const int* __restrict__ cols,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ C,
                                 const float* __restrict__ Dt,
                                 float* __restrict__ out,
                                 int64_t N, int n_c, int64_t c_stride,
                                 int m, int K) {
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int64_t base = int64_t(blockIdx.x) * kThreads
                         + (threadIdx.x / kWarp) * kWarp;
    if (base >= N) return;                       // warp-uniform
    const int64_t e = base + lane;
    const bool live = e < N;
    int r_l = 0, c_l = 0;
    float v_l = 0.f;
    if (live) {
        r_l = clamp_index(rows[p * N + e], n_c);
        c_l = clamp_index(cols[p * N + e], m);
        v_l = vals[p * N + e];
    }
    const float* Cp = C + p * c_stride;
    const int cnt = N - base < kWarp ? int(N - base) : kWarp;
    float mine = 0.f;
    for (int t = 0; t < cnt; ++t) {
        const int64_t r = __shfl_sync(0xffffffffu, r_l, t);
        const int64_t c = __shfl_sync(0xffffffffu, c_l, t);
        const float* crow = Cp + r * K;
        const float* drow = Dt + c * K;
        float acc = 0.f;
        for (int k = lane; k < K; k += kWarp)
            acc += __ldg(crow + k) * __ldg(drow + k);
        acc = warp_sum(acc);
        if (lane == t) mine = acc;
    }
    if (live) out[p * N + e] = v_l * mine;
}

}  // namespace

extern "C" {

// rows, cols, vals, out: (P, N); C: (n_c, K) shared (c_stride 0) or
// (P, n_c, K) (c_stride n_c * K); Dt: (m, K).
int sddmm_coo(const int* rows, const int* cols, const float* vals,
              const float* C, const float* Dt, float* out, int P, int64_t N,
              int n_c, int64_t c_stride, int m, int K, void* stream) {
    dim3 grid(unsigned((N + kThreads - 1) / kThreads), unsigned(P));
    sddmm_coo_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, cols, vals, C, Dt, out, N, n_c, c_stride, m, K);
    return int(cudaGetLastError());
}

}  // extern "C"
