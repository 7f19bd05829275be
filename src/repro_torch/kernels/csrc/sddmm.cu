// SDDMM leaf for Hopper (sm_90a): out(p) = vals(p) . <C[rows(p), :], Dt[cols(p), :]>
// over the lowered path's stacked per-piece coordinate streams, batched over
// pieces. One kernel serves both strategies: the rows strategy passes a row
// block of C per piece (c_stride = max_rows * K), the nnz strategy one C
// shared by every piece (c_stride = 0).
//
// sddmm_coo replaces the TPU kernel src/repro/kernels/sddmm.py:45 sddmm_coo.
//
// What bounds it on this card: bytes, and the latency of gathering them.
// Each stored position reads its row, column and value (12 B), one K-row
// of C and one K-row of Dt, and writes one value; at K = 32 the 2K flops
// per position are an order of magnitude below the byte time in f32.
// Counted once per input, C and Dt are read once; in practice every
// position gathers its two K-rows, from L2 when the factors fit there and
// from device memory when they do not (random columns of a Dt larger than
// L2), so a warp must keep many gathers in flight.
//
// What the design does about it: D is transposed once, at lower time, so
// both gathers read contiguous K-rows (the TPU kernel transposes D for the
// same reason, sddmm.py:59). A warp owns a round of 32 * V consecutive
// positions of a piece; its lanes load the round's (row, col, val) triples
// with one coalesced load each (V per lane). When K % 4 == 0 and C and Dt
// start on 16-byte boundaries, a group of G lanes takes each position
// (G = K / 4 rounded up to a power of two, at most 32), each lane loading
// a float4 of the C row and of the Dt row (looping over 4G-float k-tiles
// into a per-lane partial for K > 4G), so one warp step covers 32 / G
// positions. U steps are unrolled, all their gathers issued before any
// FMA or shuffle: 2U 16-byte loads a lane in flight. A fixed tree of
// log2(G) xor shuffles sums each group; lane t of the round then takes
// position t's sum by one shuffle per step, and the warp stores its
// results at once. Any other K, or an unaligned base, takes the scalar
// kernel: 32 positions a warp, one at a time, lanes on k, a 5-step tree.
// No float atomics: results repeat bit for bit. Indices are clamped into
// range; padded positions carry vals == 0, and out = vals * dot exactly
// (0 * inf stays NaN).
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;   // 8 warps per block
constexpr int kU = 4;           // warp steps unrolled (gathers in flight)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// grid (ceil(N / 256), P): a warp per 32 positions, lanes on k
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

// grid (ceil(N / (8 * 32 * V)), P), 256 threads: a warp per round of
// 32 * V positions, G lanes a position, U steps of 32 / G positions
// gathered at a time. Needs K % 4 == 0 and 16-byte aligned C and Dt.
template <int G, int U>
__global__ void __launch_bounds__(kThreads)
sddmm_group_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float* __restrict__ C, const float* __restrict__ Dt,
                   float* __restrict__ out, int64_t N, int n_c,
                   int64_t c_stride, int m, int K) {
    constexpr int S = kWarp / G;                 // positions a step
    constexpr int V = U > G ? U / G : 1;         // triples a lane holds
    constexpr int STEPS = V * G;                 // steps a round
    const int64_t p = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int gid = lane / G, q = lane % G;
    const int64_t base = (int64_t(blockIdx.x) * (kThreads / kWarp)
                          + threadIdx.x / kWarp) * (kWarp * V);
    if (base >= N) return;                       // warp-uniform
    int r_l[V], c_l[V];
    float v_l[V], mine[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const int64_t e = base + v * kWarp + lane;
        r_l[v] = c_l[v] = 0;
        v_l[v] = mine[v] = 0.f;
        if (e < N) {
            r_l[v] = clamp_index(rows[p * N + e], n_c);
            c_l[v] = clamp_index(cols[p * N + e], m);
            v_l[v] = vals[p * N + e];
        }
    }
    const float* Cp = C + p * c_stride;
#pragma unroll
    for (int s0 = 0; s0 < STEPS; s0 += U) {
        // step s, group gid: position s * S + gid of the round, held by
        // lane (s % G) * S + gid in its triple s / G
        const float* crow[U];
        const float* drow[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int s = s0 + u, src = (s % G) * S + gid;
            crow[u] = Cp + int64_t(__shfl_sync(0xffffffffu, r_l[s / G], src))
                           * K;
            drow[u] = Dt + int64_t(__shfl_sync(0xffffffffu, c_l[s / G], src))
                           * K;
        }
        float part[U];
#pragma unroll
        for (int u = 0; u < U; ++u) part[u] = 0.f;
        for (int k0 = 0; k0 < K; k0 += 4 * G) {
            const int k = k0 + 4 * q;
            const bool in = k < K;
            float4 a[U], b[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {        // every gather first
                const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
                a[u] = in ? __ldg(reinterpret_cast<const float4*>(crow[u] + k))
                          : z;
                b[u] = in ? __ldg(reinterpret_cast<const float4*>(drow[u] + k))
                          : z;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                part[u] = fmaf(a[u].x, b[u].x, part[u]);
                part[u] = fmaf(a[u].y, b[u].y, part[u]);
                part[u] = fmaf(a[u].z, b[u].z, part[u]);
                part[u] = fmaf(a[u].w, b[u].w, part[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1)
                part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
        }
        // lane t of triple v holds position v * 32 + t: step v * G + t / S,
        // group t % S, whose first lane is (t % S) * G
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int s = s0 + u;
            const float d = __shfl_sync(0xffffffffu, part[u], (lane % S) * G);
            if (lane / S == s % G) mine[s / G] = d;
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const int64_t e = base + v * kWarp + lane;
        if (e < N) out[p * N + e] = v_l[v] * mine[v];
    }
}

template <int G>
int launch_group(const int* rows, const int* cols, const float* vals,
                 const float* C, const float* Dt, float* out, int P,
                 int64_t N, int n_c, int64_t c_stride, int m, int K,
                 cudaStream_t s) {
    constexpr int V = kU > G ? kU / G : 1;
    const int64_t per_block = int64_t(kThreads / kWarp) * kWarp * V;
    dim3 grid(unsigned((N + per_block - 1) / per_block), unsigned(P));
    sddmm_group_kernel<G, kU><<<grid, kThreads, 0, s>>>(
        rows, cols, vals, C, Dt, out, N, n_c, c_stride, m, K);
    return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows, cols, vals, out: (P, N); C: (n_c, K) shared (c_stride 0) or
// (P, n_c, K) (c_stride n_c * K); Dt: (m, K).
int sddmm_coo(const int* rows, const int* cols, const float* vals,
              const float* C, const float* Dt, float* out, int P, int64_t N,
              int n_c, int64_t c_stride, int m, int K, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // float4 gathers need K % 4 == 0 and 16-byte aligned bases (a view
    // may start anywhere); each piece's C then starts aligned too
    const bool vec = K % 4 == 0
                     && reinterpret_cast<uintptr_t>(C) % 16 == 0
                     && reinterpret_cast<uintptr_t>(Dt) % 16 == 0;
    if (vec) {
        int g = 1;                               // K / 4 up to a power of 2
        while (g < kWarp && 4 * g < K) g <<= 1;
        switch (g) {
#define SDDMM_GROUP(G_)                                                       \
        case G_:                                                              \
            return launch_group<G_>(rows, cols, vals, C, Dt, out, P, N, n_c,  \
                                    c_stride, m, K, s);
        SDDMM_GROUP(1) SDDMM_GROUP(2) SDDMM_GROUP(4) SDDMM_GROUP(8)
        SDDMM_GROUP(16) SDDMM_GROUP(32)
#undef SDDMM_GROUP
        }
    }
    dim3 grid(unsigned((N + kThreads - 1) / kThreads), unsigned(P));
    sddmm_coo_kernel<<<grid, kThreads, 0, s>>>(
        rows, cols, vals, C, Dt, out, N, n_c, c_stride, m, K);
    return int(cudaGetLastError());
}

}  // extern "C"
