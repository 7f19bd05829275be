// The sLSTM recurrence of xlstm-125m for Hopper (sm_90a): the scan over
// time of one sLSTM layer, forward (slstm_fwd) and its reverse-time
// transpose (slstm_bwd), one launch each for the whole sequence.
//
// They replace no Pallas kernel: the reference's
// src/repro/models/xlstm.py:145 slstm_apply is a lax.scan of _slstm_step,
// and its jax.grad is that scan's transpose. Without them the port looped
// over time in Python, about 15 launches a step.
//
// What the step computes, per batch row b, head and unit j (hd units a
// head, d = H hd), with the input projections taken outside over the whole
// sequence (zx = x wz in x's dtype; ip, fp, op = x wi, x wf, x wo_gate in
// f32):
//   rec = h_{t-1} r[head]            (f32; r block-diagonal per head)
//   z   = tanh(zx + rec)             rounded as the plain loop rounds in x's
//                                    dtype (f32, bf16 or f16): rec, the sum
//                                    and the tanh
//   c_t = sigmoid(fp) c_{t-1} + exp(min(ip, 6)) z        (f32)
//   h_t = sigmoid(op) c_t / max(|c_t|, 1),   y_t = h_t in x's dtype.
//
// The recurrent product is summed in double and rounded once to f32, as
// the plain version takes it, so both round the same f32 rec to x's dtype:
// each product of two floats is exact in double and the sum's error is a
// few double ulps whatever its order, so the f32 result equals the plain
// version's float64 product rounded to float32 unless it lies within those
// ulps of an f32 rounding boundary. In bf16 a float32 sum in another order
// flips the rounding of rec now and then, and exp(ip) up to e^6 magnifies
// one flip past the tolerance.
//
// What bounds it on this card: neither bytes nor operations but the
// serial chain. Each step's hd x hd matrix-vector product needs the
// previous step's h, so a head's S steps run one after another. Bytes are
// small (zx, three f32 gates, y; 18 B a unit and step in bf16) and the
// FLOPs, 2 B S d hd, are well below the f32 rate at xlstm-125m's shapes.
// The recurrences of different (b, head) pairs (chains) are independent
// (r is block-diagonal per head).
//
// The cluster kernels (slstm_fwd_cluster up to hd 960, slstm_bwd_cluster
// up to 480): a thread-block cluster of C blocks owns one chain, and block
// s of it the output columns j in [s W, (s + 1) W), W = ceil(hd / C).
// - r widened once: before the time loop each thread loads its KT terms of
//   one column of r[head] and widens them to double into registers, so a
//   step's products are double FMAs on registers with no conversion. A
//   column's hd terms are split over KS lanes of one warp (k-slices; KS a
//   power of two, KT = ceil(hd / KS) rounded up to an instance: 8, 16, 24
//   or 32), k-pairs interleaved over the lanes so that the lanes' 16-byte
//   reads of h hit distinct banks. The KS partial sums are added by an xor
//   shuffle tree in a fixed order: every lane of the column holds the same
//   bits, and every run the same.
// - h exchanged through distributed shared memory: each block keeps the
//   whole h_{t-1} of its chain as double (widened once by its writer),
//   double-buffered. After the pointwise gate math for its columns, a block
//   stores its h_t slice into the other buffer of every block of the
//   cluster with st.async, each store counted (complete_tx) on the
//   receiving block's mbarrier of that buffer; a block waits for the
//   phase that holds all hd values of its vector, and one thread then
//   expects the next phase's bytes. At step t blocks read buffer t & 1 and
//   write (t + 1) & 1; a peer can write h_{t+1} into buffer t & 1 only once
//   it holds this block's whole h_t, which each live column computes after
//   its lanes read buffer t & 1, so the wait is the only sync a step. A
//   split cluster barrier a step (barrier.cluster.arrive.release /
//   wait.acquire) costs 0.53-0.77 us alone on the H100 and its release
//   waits for the step's global stores; the counted stores 0.22-0.35 us
//   (slstm_cluster_probe, scripts/slstm_shapes.py). The cluster barrier
//   runs once before the loop (the mbarriers initialised) and once after
//   (no block exits while a peer may still store into it).
// - A helper warp a block: the compute warps run only the chain (the
//   product, the pointwise math, the sends). The helper copies a step's
//   raw inputs (zx, ip, fp, op; the backward's cs, zs, ip, fp, op, gy)
//   with 4-byte cp.async kRaw - 1 steps ahead into its own slots, computes
//   the gates (and zx as float; the backward's c_{t-1}) into a ring of
//   kRing steps in shared memory, arriving on the slot's mbarrier, and
//   stores the outputs the compute warps left in the slot (y and the
//   states; the gradients), coalesced over the block's columns. Before
//   this split the warps that ran the chain also ran those copies,
//   loads, gate math and stores, about as long a step as the chain's own
//   product and pointwise math.
// - The rule for C (slstm_plan): C = 16 / 8 / 4 / 2 / 1, the largest power
//   of two with hd / C >= kMinCols columns a block, at most 16, then halved
//   while B H C exceeds the card's SMs or fewer than B H clusters of C
//   blocks can be resident at once (cudaOccupancyMaxActiveClusters), as
//   long as a block needs at most kClusterThreads threads. C = 16 needs
//   cudaFuncAttributeNonPortableClusterSizeAllowed. At xlstm-125m's hd 192
//   and B H = 8: C = 8, W = 24, KS = 8, KT = 24, 192 compute threads and
//   the helper a block, 64 SMs (C = 16 took 3.34 ms for the forward at
//   path 4k's shape against C = 8's 3.07: a wider cluster's exchange costs
//   more than its narrower blocks save; scripts/slstm_shapes.py). The
//   reduced configs' hd 16 takes C = 1 (one compute warp a chain).
// - r split between registers and shared memory (the forward past hd
//   kClusterMaxHd, up to kSplitMaxHd). Past 480 r's slice no longer fits
//   the registers of a 16-block cluster at KT <= 32 and kClusterThreads:
//   at hd 640 a block owns 40 columns, 25,600 terms (200 KB as double).
//   So a lane keeps kSplitKT = 32 of its terms in registers as double and
//   its KX others (k-pairs ks + i KS for i >= KT / 2, KX a multiple of 4)
//   in the block's shared memory, lane-major (term e of compute thread
//   tid at e . compute + tid, so a warp's read is 32 consecutive words),
//   as float widened to double at the FMA (float, chosen by measurement:
//   double terms were 7.6 % slower with the same bits). KS is the most lanes a column that kClusterThreads less
//   the helper warp allow (8 from hd 481 to 960 at C = 16), C the rule's
//   below. The products stay double FMAs on the same four chains, the
//   shuffle tree and the exchange are the ones above, and the double sum
//   is rounded once to f32, so y and the final (c, h) stay the plain
//   loop's bits. C follows the rule below. At hd 640 and C = 16 (2 and 6
//   chains on the H100): W = 40, KS = 8, KT 32 + KX 48, 320 compute
//   threads, 94,720 bytes of shared memory a block (the terms 60 KB);
//   where B H 16 passes the SMs or the card holds fewer than B H
//   clusters of 16 (10 chains) the rule halves C to 8: W = 80, KS = 4,
//   KT 32 + KX 128, 320 compute threads, 220,160 bytes (the terms 160
//   KB). C = 8 fits up
//   to hd 640; past it C stays 16 for any number of chains (the clusters
//   then run in waves). The widest head whose shape fits 227 KB at C = 16
//   is kSplitMaxHd = 960 (W 60, KX 88, 214 KB).
// Past those widths (the forward past kSplitMaxHd, the backward past
// kClusterMaxHd) the one-block kernels below (slstm_fwd_kernel,
// slstm_bwd_kernel) take the chain: a block per chain, a thread per unit,
// r[head] staged in shared memory or read from L2, h as double in shared
// memory, one __syncthreads a step.
//
// The backward walks t from S-1 to 0 with the same grids. It reads the
// c and z the forward saved for every step (and recomputes the gates from
// their pre-activations), carries dc and dh, and writes the gradients of
// zx and of the three pre-activations, then dc0 and dh0. dh_{t-1} = r
// dzpre_t is the same matrix-vector product against the transpose, which
// the wrapper passes (rT), so both directions read the matrix along a row;
// the cluster backward exchanges dzpre_t as the forward exchanges h_t.
// The gradient of r, the sum over (b, t) of h_{t-1}^T dzpre_t per head,
// is one batched product outside the kernel. It follows the conventions of
// PyTorch's autograd over the plain loop: clamp(max=6) passes no gradient
// above 6, clamp(|c|, min=1) passes it where |c| >= 1, abs has gradient 0
// at 0, and the gradients in x's dtype are rounded where autograd rounds
// them (the grad of z and of tanh's input).
//
// Every output is written once by one thread, with no atomics, so results
// repeat bit for bit (remat replays the forward and must find the same
// saved c and h).
//
// The entry points return cudaGetLastError() after their launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRing = 16;    // steps of prepared inputs and outputs a block keeps
constexpr int kRaw = 8;      // steps of raw input words the helper copies ahead
constexpr int kClusterThreads = 512; // most threads of a cluster block
constexpr int kMaxCluster = 16;
constexpr int kClusterMaxHd = 480;   // widest head of the cluster kernels
constexpr int kSplitMaxHd = 960;     // widest head of the split forward
constexpr int kSplitKT = 32;         // register terms a lane, split forward
constexpr int kMinCols = 24;         // columns a cluster block, at least
constexpr int kTerms = 24;           // KT a lane, at most where KS allows

template <typename T> struct Cvt;
template <> struct Cvt<float> {
    __device__ static float load(float v) { return v; }
    __device__ static float store(float v) { return v; }
    __device__ static float round(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
    __device__ static float load(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    __device__ static __nv_bfloat16 store(float v) {
        return __float2bfloat16_rn(v);
    }
    __device__ static float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
};
template <> struct Cvt<__half> {
    __device__ static float load(__half v) { return __half2float(v); }
    __device__ static __half store(float v) { return __float2half_rn(v); }
    __device__ static float round(float v) {
        return __half2float(__float2half_rn(v));
    }
};

template <typename T> constexpr int dtype_code();
template <> constexpr int dtype_code<float>() { return 0; }
template <> constexpr int dtype_code<__nv_bfloat16>() { return 1; }
template <> constexpr int dtype_code<__half>() { return 2; }

__device__ __forceinline__ float sigmoidf(float x) {
    return 1.0f / (1.0f + expf(-x));
}

struct Gates {
    float i, f, o;
};

__device__ __forceinline__ Gates gates(float ip, float fp, float op) {
    return {expf(fminf(ip, 6.0f)), sigmoidf(fp), sigmoidf(op)};
}

// The forward's pointwise step of one unit from the f32 product ``rec``:
// updates c, returns h and sets z (both kernels, so both give the plain
// loop's bits).
template <typename T>
__device__ __forceinline__ float fwd_point(float acc, float vz, Gates g,
                                           float& c, float& z) {
    const float rec = Cvt<T>::round(acc);
    z = Cvt<T>::round(tanhf(Cvt<T>::round(vz + rec)));
    c = __fadd_rn(__fmul_rn(g.f, c), __fmul_rn(g.i, z));
    const float n = fmaxf(fabsf(c), 1.0f);
    return __fmul_rn(g.o, __fdiv_rn(c, n));
}

struct BwdOut {
    float dop, dfp, dip, dpre;
};

// The backward's pointwise step of one unit at step t: dh the gradient of
// h_t (y's and the next step's), dc the carried gradient of c (updated),
// c = c_t, cp = c_{t-1}, z = z_t, vi = ip_t.
template <typename T>
__device__ __forceinline__ BwdOut bwd_point(float dh, float& dc, float c,
                                            float cp, float z, float vi,
                                            Gates ga) {
    BwdOut out;
    const float n = fmaxf(fabsf(c), 1.0f);
    const float q = __fdiv_rn(c, n);
    // h = o q, q = c / n, n = max(|c|, 1)
    out.dop = dh * q * (1.0f - ga.o) * ga.o;
    const float dq = dh * ga.o;
    float dct = dc + __fdiv_rn(dq, n);
    if (fabsf(c) >= 1.0f && c != 0.0f) {
        const float dn = __fdiv_rn(-dq * c, n * n);
        dct += c > 0.0f ? dn : -dn;
    }
    // c = f cp + i z, i = exp(min(ip, 6))
    out.dfp = dct * cp * (1.0f - ga.f) * ga.f;
    out.dip = vi <= 6.0f ? dct * z * ga.i : 0.0f;
    const float dz = Cvt<T>::round(dct * ga.i);
    out.dpre = Cvt<T>::round(dz * (1.0f - z * z));
    dc = dct * ga.f;
    return out;
}

// out = sum_k v[k] m[k][j] (m row-major, hd x hd), rounded once to f32
// from a double sum (four chains, to shorten the dependent one).
__device__ __forceinline__ float matvec_col(const double* v,
                                            const float* m, int hd, int j) {
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    int k = 0;
    for (; k + 4 <= hd; k += 4) {
        a0 = fma(v[k], (double)m[k * hd + j], a0);
        a1 = fma(v[k + 1], (double)m[(k + 1) * hd + j], a1);
        a2 = fma(v[k + 2], (double)m[(k + 2) * hd + j], a2);
        a3 = fma(v[k + 3], (double)m[(k + 3) * hd + j], a3);
    }
    for (; k < hd; ++k) a0 = fma(v[k], (double)m[k * hd + j], a0);
    return (float)((a0 + a1) + (a2 + a3));
}

// ---------------------------------------------------------------------------
// The one-block kernels (the forward past kSplitMaxHd, the backward past
// kClusterMaxHd)
// ---------------------------------------------------------------------------

// grid: one block per (b, head), blockIdx.x = b H + head. Shared memory:
// h double-buffered, widened to double once by its writer (2 hd doubles),
// r[head] (hd^2 floats, when kSmemR), c (hd floats).
// save: cs, hs, zs (B, S, d) hold every step's c, h and z; c_out, h_out
// (B, d) the final state.
template <typename T, bool kSmemR>
__global__ void slstm_fwd_kernel(
        const T* __restrict__ zx, const float* __restrict__ ip,
        const float* __restrict__ fp, const float* __restrict__ op,
        const float* __restrict__ r, const float* __restrict__ c0,
        const float* __restrict__ h0, T* __restrict__ y,
        float* __restrict__ c_out, float* __restrict__ h_out,
        float* __restrict__ cs, float* __restrict__ hs, T* __restrict__ zs,
        int S, int H, int hd, int save) {
    extern __shared__ double smem[];
    const int b = blockIdx.x / H, head = blockIdx.x % H;
    const int d = H * hd, tid = threadIdx.x, nthr = blockDim.x;
    const float* rg = r + (size_t)head * hd * hd;
    double* hbuf = smem;
    float* rs = reinterpret_cast<float*>(hbuf + 2 * hd);
    float* cbuf = rs + (kSmemR ? hd * hd : 0);
    const float* R = kSmemR ? rs : rg;
    if (kSmemR)
        for (int k = tid; k < hd * hd; k += nthr) rs[k] = rg[k];
    const size_t state = (size_t)b * d + (size_t)head * hd;
    for (int j = tid; j < hd; j += nthr) {
        hbuf[j] = h0[state + j];
        cbuf[j] = c0[state + j];
    }
    // the first unit's inputs, one step ahead
    const size_t row0 = (size_t)b * S * d + (size_t)head * hd;
    float nz = 0.f, ni = 0.f, nf = 0.f, no = 0.f;
    if (tid < hd && S > 0) {
        nz = Cvt<T>::load(zx[row0 + tid]);
        ni = ip[row0 + tid];
        nf = fp[row0 + tid];
        no = op[row0 + tid];
    }
    __syncthreads();
    for (int t = 0; t < S; ++t) {
        const double* hp = hbuf + (t & 1) * hd;
        double* hn = hbuf + ((t + 1) & 1) * hd;
        const size_t row = row0 + (size_t)t * d;
        for (int j = tid; j < hd; j += nthr) {
            float vz, vi, vf, vo;
            if (j == tid) {
                vz = nz; vi = ni; vf = nf; vo = no;
                if (t + 1 < S) {
                    nz = Cvt<T>::load(zx[row + d + j]);
                    ni = ip[row + d + j];
                    nf = fp[row + d + j];
                    no = op[row + d + j];
                }
            } else {
                vz = Cvt<T>::load(zx[row + j]);
                vi = ip[row + j];
                vf = fp[row + j];
                vo = op[row + j];
            }
            float c = cbuf[j], z;
            const float h = fwd_point<T>(matvec_col(hp, R, hd, j), vz,
                                         gates(vi, vf, vo), c, z);
            cbuf[j] = c;
            hn[j] = h;
            y[row + j] = Cvt<T>::store(h);
            if (save) {
                cs[row + j] = c;
                hs[row + j] = h;
                zs[row + j] = Cvt<T>::store(z);
            }
        }
        __syncthreads();
    }
    const double* hl = hbuf + (S & 1) * hd;
    for (int j = tid; j < hd; j += nthr) {
        c_out[state + j] = cbuf[j];
        h_out[state + j] = (float)hl[j];
    }
}

// grid as the forward's. Shared memory: dzpre double-buffered as double
// (2 hd), rT[head] (hd^2 floats, when kSmemR), the carries dc and dh
// (2 hd floats).
// gy (B, S, d) in x's dtype, gc and gh (B, d) the final state's
// gradients; any of them may be null (zero).
template <typename T, bool kSmemR>
__global__ void slstm_bwd_kernel(
        const T* __restrict__ gy, const float* __restrict__ gc,
        const float* __restrict__ gh, const float* __restrict__ ip,
        const float* __restrict__ fp, const float* __restrict__ op,
        const float* __restrict__ rT, const float* __restrict__ c0,
        const float* __restrict__ cs, const T* __restrict__ zs,
        T* __restrict__ dzx, float* __restrict__ dip,
        float* __restrict__ dfp, float* __restrict__ dop,
        float* __restrict__ dc0, float* __restrict__ dh0,
        int S, int H, int hd, int need_dh0) {
    extern __shared__ double smem[];
    const int b = blockIdx.x / H, head = blockIdx.x % H;
    const int d = H * hd, tid = threadIdx.x, nthr = blockDim.x;
    const float* rg = rT + (size_t)head * hd * hd;
    double* gbuf = smem;
    float* rs = reinterpret_cast<float*>(gbuf + 2 * hd);
    float* dcc = rs + (kSmemR ? hd * hd : 0);
    float* dhc = dcc + hd;
    const float* R = kSmemR ? rs : rg;
    if (kSmemR)
        for (int k = tid; k < hd * hd; k += nthr) rs[k] = rg[k];
    const size_t state = (size_t)b * d + (size_t)head * hd;
    for (int j = tid; j < hd; j += nthr) {
        dcc[j] = gc ? gc[state + j] : 0.0f;
        dhc[j] = gh ? gh[state + j] : 0.0f;
    }
    __syncthreads();
    const size_t row0 = (size_t)b * S * d + (size_t)head * hd;
    for (int t = S - 1; t >= 0; --t) {
        double* g = gbuf + (t & 1) * hd;
        const size_t row = row0 + (size_t)t * d;
        for (int j = tid; j < hd; j += nthr) {
            const float c = cs[row + j];
            const float cp = t > 0 ? cs[row - d + j] : c0[state + j];
            const float vi = ip[row + j];
            const float dh = (gy ? Cvt<T>::load(gy[row + j]) : 0.0f)
                             + dhc[j];
            float dc = dcc[j];
            const BwdOut o = bwd_point<T>(
                dh, dc, c, cp, Cvt<T>::load(zs[row + j]), vi,
                gates(vi, fp[row + j], op[row + j]));
            dop[row + j] = o.dop;
            dfp[row + j] = o.dfp;
            dip[row + j] = o.dip;
            dzx[row + j] = Cvt<T>::store(o.dpre);
            g[j] = o.dpre;
            dcc[j] = dc;
        }
        __syncthreads();
        if (t > 0 || need_dh0)
            for (int j = tid; j < hd; j += nthr)
                dhc[j] = matvec_col(g, R, hd, j);
    }
    __syncthreads();
    for (int j = tid; j < hd; j += nthr) {
        dc0[state + j] = dcc[j];
        if (need_dh0) dh0[state + j] = dhc[j];
    }
}

// ---------------------------------------------------------------------------
// The cluster kernels (hd <= kClusterMaxHd; the forward up to
// kSplitMaxHd)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
    unsigned n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return n;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v into the shared memory of cluster block ``rank`` at the address that
// ``local`` has in this block
__device__ __forceinline__ void st_cluster(uint32_t local, unsigned rank,
                                           double v) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("st.shared::cluster.f64 [%0], %1;"
                 :: "r"(remote), "d"(v) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The exchange by transaction count: a block's mbarrier completes a phase
// when its one local arrival (expect_tx of the phase's bytes) is in and the
// peers' st.async stores have delivered those bytes.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                     "\n\tselp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// v into cluster block ``rank``'s shared memory at the address ``local``
// has here, counted on that block's mbarrier at ``bar``'s address
__device__ __forceinline__ void st_async(uint32_t local, uint32_t bar,
                                         unsigned rank, double v) {
    uint32_t ra, rb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(ra) : "r"(local), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rb) : "r"(bar), "r"(rank));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64"
                 " [%0], %1, [%2];"
                 :: "r"(ra), "l"(__double_as_longlong(v)), "r"(rb)
                 : "memory");
}

// One input stream of the cluster kernels: a (B, S, d) tensor of
// ``size``-byte elements. The helper warp copies, each step, the aligned
// 4-byte word that holds a column's element (a 16-bit element may be
// either half of it; the word lies inside the tensor's allocation, whose
// granule is at least 4 bytes).
struct Stream {
    const unsigned char* base;    // null: the stream is absent
    int size;
};

__device__ __forceinline__ uintptr_t stream_addr(const Stream& s,
                                                 size_t elem) {
    return reinterpret_cast<uintptr_t>(s.base) + elem * (size_t)s.size;
}

// start the copies of one column's inputs at element ``elem`` into the
// NS words at shared address ``dst``
template <int NS>
__device__ __forceinline__ void fetch_column(const Stream (&st)[NS],
                                             size_t elem, uint32_t dst) {
#pragma unroll
    for (int a = 0; a < NS; ++a)
        if (st[a].base != nullptr)
            cp_async4(dst + 4u * a, reinterpret_cast<const void*>(
                stream_addr(st[a], elem) & ~uintptr_t(3)));
}

// the value of element ``elem`` of a stream of T from the word holding it
template <typename T> struct Word;
template <> struct Word<float> {
    __device__ static float get(uint32_t w, const Stream&, size_t) {
        return __uint_as_float(w);
    }
};
template <> struct Word<__nv_bfloat16> {
    __device__ static float get(uint32_t w, const Stream& s, size_t elem) {
        const bool hi = (stream_addr(s, elem) & 2) != 0;
        return __bfloat162float(__ushort_as_bfloat16(
            (unsigned short)(hi ? w >> 16 : w & 0xffffu)));
    }
};
template <> struct Word<__half> {
    __device__ static float get(uint32_t w, const Stream& s, size_t elem) {
        const bool hi = (stream_addr(s, elem) & 2) != 0;
        return __half2float(__ushort_as_half(
            (unsigned short)(hi ? w >> 16 : w & 0xffffu)));
    }
};

__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// The k-slice ks of one column's product: sum over k-pairs ks + i KS of
// v[k] rr[..], four chains, then the xor shuffle tree over the column's KS
// lanes (a fixed order; every lane gets the same bits). kSplit: the
// k-pairs i = KT / 2 .. KT / 2 + KX / 2 - 1 go on after the registers'
// with their terms from shared memory, term e at xs[e . stride], widened
// to double.
template <int KT, bool kSplit = false>
__device__ __forceinline__ double column_dot(const double* v,
                                             const double (&rr)[KT], int ks,
                                             int KS, const float* xs = nullptr,
                                             int KX = 0, int stride = 0) {
    const double2* v2 = reinterpret_cast<const double2*>(v);
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll
    for (int i = 0; i < KT / 2; i += 2) {
        const double2 p = v2[ks + i * KS];
        a0 = fma(p.x, rr[2 * i], a0);
        a1 = fma(p.y, rr[2 * i + 1], a1);
        if (i + 1 < KT / 2) {
            const double2 q = v2[ks + (i + 1) * KS];
            a2 = fma(q.x, rr[2 * i + 2], a2);
            a3 = fma(q.y, rr[2 * i + 3], a3);
        }
    }
    if constexpr (kSplit) {
        static_assert(KT % 4 == 0, "the shared pairs keep the chains' turn");
        const double2* vx = v2 + ks + (KT / 2) * KS;
#pragma unroll 2
        for (int e = 0; e < KX; e += 4) {
            const double2 p = vx[(e / 2) * KS];
            const double2 q = vx[(e / 2 + 1) * KS];
            a0 = fma(p.x, (double)xs[e * stride], a0);
            a1 = fma(p.y, (double)xs[(e + 1) * stride], a1);
            a2 = fma(q.x, (double)xs[(e + 2) * stride], a2);
            a3 = fma(q.y, (double)xs[(e + 3) * stride], a3);
        }
    }
    double acc = (a0 + a1) + (a2 + a3);
    for (int o = KS >> 1; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
    return acc;
}

// a thread's KT terms of column j of m (hd x hd, row-major), widened to
// double; zero past hd or for a dead column
template <int KT>
__device__ __forceinline__ void load_slice(double (&rr)[KT], const float* m,
                                           int hd, int j, bool live, int ks,
                                           int KS) {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int k = 2 * (ks + i * KS) + e;
            rr[2 * i + e] = (live && k < hd)
                            ? (double)m[(size_t)k * hd + j] : 0.0;
        }
    }
}

// a compute thread's KX terms past its KT registers (k-pairs ks + i KS,
// i >= KT / 2) of column j of m, into xs[e . stride]; zero past hd or for
// a dead column
template <int KT>
__device__ __forceinline__ void load_split(float* xs, int stride, int KX,
                                           const float* m, int hd, int j,
                                           bool live, int ks, int KS) {
    for (int e = 0; e < KX; ++e) {
        const int k = 2 * (ks + (KT / 2 + e / 2) * KS) + e % 2;
        xs[e * stride] = (live && k < hd) ? m[(size_t)k * hd + j] : 0.0f;
    }
}

// Per step and column: the forward's prepared inputs (zx as float and the
// gates i, f, o) and outputs (h, c, z); the backward's inputs (c_t,
// c_{t-1}, z, ip, the gates, gy) and outputs (dzpre, dip, dfp, dop).
constexpr int kFwdIn = 4, kFwdOut = 3, kFwdRaw = 4;
constexpr int kBwdIn = 8, kBwdOut = 4, kBwdRaw = 6;

// Shared memory of a cluster block: the exchanged vector double-buffered
// (2 HP doubles, HP = (KT + KX) KS >= hd, zero past hd), then kRing slots
// of W columns of prepared inputs and of outputs, then the helper's kRaw
// slots of W columns of raw words, then (the split forward) the compute
// threads' KX float terms each.
__host__ __device__ inline size_t cluster_smem(int KT, int KS, int W,
                                               bool backward, int KX = 0) {
    const int io = backward ? kBwdIn + kBwdOut : kFwdIn + kFwdOut;
    const int raw = backward ? kBwdRaw : kFwdRaw;
    const int compute = (W * KS + 31) / 32 * 32;
    return 2 * (size_t)(KT + KX) * KS * sizeof(double)
           + ((size_t)kRing * W * io + (size_t)kRaw * W * raw) * 4
           + (size_t)KX * compute * sizeof(float);
}

// Where a cluster block's thread stands. Compute threads: column col = tid
// / KS (unit j = rank W + col of the head) and k-slice ks = tid % KS;
// ``live`` for a column of the head; the warp runs the time loop when one
// of its columns is live. The last warp is the block's helper.
struct Lane {
    int C, rank, col, ks, j, W, ncols, live_ranks, compute;
    bool live, lead, warp_live, helper;
};

__device__ __forceinline__ Lane lane_of(int hd, int W, int KS) {
    Lane l;
    l.C = (int)cluster_blocks();
    l.rank = (int)cluster_rank();
    l.W = W;
    const int tid = threadIdx.x;
    l.compute = (int)blockDim.x - 32;
    l.helper = tid >= l.compute;
    l.col = tid / KS;
    l.ks = tid % KS;
    l.j = l.rank * W + l.col;
    l.ncols = max(0, min(W, hd - l.rank * W));
    l.live = !l.helper && l.col < l.ncols;
    l.lead = l.live && l.ks == 0;
    l.warp_live = !l.helper && (tid & ~31) / KS < l.ncols;
    l.live_ranks = min(l.C, (hd + W - 1) / W);
    return l;
}

// this lane's share of a step's exchange: v into unit j of buffer ``buf``
// (a shared address, HP doubles) of every live block, counted on that
// block's mbarrier ``bar``
__device__ __forceinline__ void send(const Lane& l, int KS, uint32_t buf,
                                     uint32_t bar, double v) {
    const uint32_t dst = buf + 8u * (uint32_t)l.j;
    for (int q = l.ks; q < l.live_ranks; q += KS) st_async(dst, bar, q, v);
}

// The block's barriers: the exchange's two (one a vector buffer), and a
// full and an empty one a ring slot (the helper fills slot s with step
// s's inputs and arrives on in_full[s]; each live compute warp arrives on
// out_full[s] once it wrote the step's outputs there).
struct Bars {
    uint64_t x[2], in_full[kRing], out_full[kRing];
};

__device__ __forceinline__ void init_bars(Bars& bars, const Lane& l,
                                          int KS, int first_sends,
                                          uint32_t bytes) {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < 2; ++i) mbar_init(smem_u32(&bars.x[i]));
    const int warps = (l.ncols * KS + 31) / 32;   // live compute warps
    for (int i = 0; i < kRing; ++i) {
        mbar_init(smem_u32(&bars.in_full[i]));
        mbar_init_count(smem_u32(&bars.out_full[i]), warps > 0 ? warps : 1);
    }
    mbar_init_fence();
    // the first two vectors' bytes (the later ones are expected by the
    // thread that waits for the phase before)
    if (first_sends > 0) mbar_expect(smem_u32(&bars.x[1]), bytes);
    if (first_sends > 1) mbar_expect(smem_u32(&bars.x[0]), bytes);
}

// The helper warp of a live block: lane i prepares columns i, i + 32, ...
// For iteration p it copies the raw words of p + kRaw - 1 (cp.async, its
// own slots), waits for those of p and p + 1, and writes p's prepared
// inputs into ring slot p % kRing; from iteration kRing on it first waits
// for the compute warps' outputs of p - kRing in that slot and stores
// them to device memory (coalesced over the block's columns).
template <int NRAW, int NIN, int NOUT, typename Prep, typename Store>
__device__ __forceinline__ void helper_loop(
        const Lane& l, int S, const Stream (&st)[NRAW], size_t rowj0,
        int d, bool backward, float* ring_in, float* ring_out,
        uint32_t raw_s, const uint32_t* raw, Bars& bars, Prep prep,
        Store store) {
    const int lane = threadIdx.x & 31, W = l.W;
    auto step_of = [&](int p) { return backward ? S - 1 - p : p; };
    auto fetch = [&](int p) {
        if (p < S)
            for (int col = lane; col < l.ncols; col += 32)
                fetch_column<NRAW>(st, rowj0 + col
                                   + (size_t)step_of(p) * d,
                                   raw_s + 4u * (uint32_t)(((p % kRaw) * W
                                                            + col) * NRAW));
        cp_async_commit();
    };
    for (int p = 0; p < kRaw - 1; ++p) fetch(p);
    for (int p = 0; p < S + kRing; ++p) {
        const int done = p - kRing;         // outputs to store
        if (done >= 0) {
            mbar_wait(smem_u32(&bars.out_full[done % kRing]),
                      (done / kRing) & 1);
            for (int col = lane; col < l.ncols; col += 32)
                store(ring_out + ((done % kRing) * W + col) * NOUT, col,
                      rowj0 + col + (size_t)step_of(done) * d);
        }
        if (p < S) {
            fetch(p + kRaw - 1);
            cp_async_wait<kRaw - 2>();      // p and p + 1 are in
            for (int col = lane; col < l.ncols; col += 32)
                prep(ring_in + ((p % kRing) * W + col) * NIN,
                     raw + ((p % kRaw) * W + col) * NRAW,
                     raw + (((p + 1) % kRaw) * W + col) * NRAW, col, p,
                     rowj0 + col + (size_t)step_of(p) * d);
            __syncwarp();
            if (lane == 0) mbar_arrive(smem_u32(&bars.in_full[p % kRing]));
        }
    }
}

// a compute warp's end of step t: the outputs it wrote into ring slot
// t % kRing handed to the helper
__device__ __forceinline__ void hand_over(Bars& bars, int t) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
        mbar_arrive(smem_u32(&bars.out_full[t % kRing]));
}

// grid: B H clusters of C blocks; cluster (b, head) = blockIdx.x / C. A
// block of roundup32(W KS) compute threads and one helper warp. Step t of
// a compute warp: wait for the step's prepared inputs (ring slot t %
// kRing), wait for h_{t-1} (buffer t & 1, its mbarrier's phase), take its
// k-slice of the product; all KS lanes of a live column then hold h_t, run
// the pointwise math and share the sends of h_t (to buffer (t + 1) & 1 of
// the live blocks; h_u is sent for u <= S - 2); lanes 0-2 write h, c and z
// into the slot, and the warp hands the slot to the helper, which stores
// y and the states. kSplit: the split forward, each compute thread's KX
// terms past its KT registers in shared memory as float.
template <typename T, int KT, bool kSplit = false>
__global__ void __launch_bounds__(kClusterThreads)
slstm_fwd_cluster(const T* __restrict__ zx, const float* __restrict__ ip,
                  const float* __restrict__ fp, const float* __restrict__ op,
                  const float* __restrict__ r, const float* __restrict__ c0,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ c_out, float* __restrict__ h_out,
                  float* __restrict__ cs, float* __restrict__ hs,
                  T* __restrict__ zs, int S, int H, int hd, int W, int KS,
                  int KX, int save) {
    extern __shared__ __align__(16) unsigned char cl_smem[];
    __shared__ Bars bars;
    const Lane l = lane_of(hd, W, KS);
    const int chain = blockIdx.x / l.C, b = chain / H, head = chain % H;
    if constexpr (!kSplit) KX = 0;
    const int d = H * hd, tid = threadIdx.x, HP = (KT + KX) * KS;
    double* hbuf = reinterpret_cast<double*>(cl_smem);
    float* ring_in = reinterpret_cast<float*>(hbuf + 2 * HP);
    float* ring_out = ring_in + kRing * W * kFwdIn;
    uint32_t* raw = reinterpret_cast<uint32_t*>(ring_out
                                                + kRing * W * kFwdOut);
    // the split terms, lane-major: term e of compute thread tid at e
    // compute + tid (the helper warp has none)
    float* xs = reinterpret_cast<float*>(raw + kRaw * W * kFwdRaw) + tid;
    const uint32_t hbuf_s = smem_u32(hbuf);
    const uint32_t x_s[2] = {smem_u32(&bars.x[0]), smem_u32(&bars.x[1])};
    const uint32_t bytes = 8u * (uint32_t)hd;
    const int last = S - 2;

    double rr[KT];
    load_slice<KT>(rr, r + (size_t)head * hd * hd, hd, l.j, l.live, l.ks,
                   KS);
    if constexpr (kSplit)
        if (!l.helper)
            load_split<KT>(xs, l.compute, KX, r + (size_t)head * hd * hd,
                           hd, l.j, l.live, l.ks, KS);
    const size_t state = (size_t)b * d + (size_t)head * hd;
    for (int k = tid; k < HP; k += blockDim.x) {
        hbuf[k] = k < hd ? (double)h0[state + k] : 0.0;
        hbuf[HP + k] = 0.0;
    }
    init_bars(bars, l, KS, last + 1, bytes);
    float c = l.live ? c0[state + l.j] : 0.0f;
    float h = l.live ? h0[state + l.j] : 0.0f;
    const size_t row0 = (size_t)b * S * d + (size_t)head * hd
                        + (size_t)l.rank * W;
    cluster_arrive();
    cluster_wait();
    if (l.helper && l.ncols > 0) {
        const Stream st[kFwdRaw] = {
            {reinterpret_cast<const unsigned char*>(zx), (int)sizeof(T)},
            {reinterpret_cast<const unsigned char*>(ip), 4},
            {reinterpret_cast<const unsigned char*>(fp), 4},
            {reinterpret_cast<const unsigned char*>(op), 4}};
        helper_loop<kFwdRaw, kFwdIn, kFwdOut>(
            l, S, st, row0, d, false, ring_in, ring_out,
            smem_u32(raw), raw, bars,
            [&](float* in, const uint32_t* w, const uint32_t*, int, int,
                size_t elem) {
                const Gates g = gates(__uint_as_float(w[1]),
                                      __uint_as_float(w[2]),
                                      __uint_as_float(w[3]));
                in[0] = Word<T>::get(w[0], st[0], elem);
                in[1] = g.i;
                in[2] = g.f;
                in[3] = g.o;
            },
            [&](const float* out, int, size_t elem) {
                y[elem] = Cvt<T>::store(out[0]);
                if (save) {
                    hs[elem] = out[0];
                    cs[elem] = out[1];
                    zs[elem] = Cvt<T>::store(out[2]);
                }
            });
    } else if (l.warp_live) {
        const float* my_in = ring_in + (size_t)min(l.col, W - 1) * kFwdIn;
        float* my_out = ring_out + (size_t)min(l.col, W - 1) * kFwdOut;
        for (int t = 0; t < S; ++t) {
            const int slot = t % kRing;
            mbar_wait(smem_u32(&bars.in_full[slot]), (t / kRing) & 1);
            const float4 in = *reinterpret_cast<const float4*>(
                my_in + slot * W * kFwdIn);
            if (t > 0) {
                mbar_wait(x_s[t & 1], ((t - 1) >> 1) & 1);
                if (tid == 0 && t + 1 <= last) mbar_expect(x_s[t & 1], bytes);
            }
            double acc;
            if constexpr (kSplit)
                acc = column_dot<KT, true>(hbuf + (t & 1) * HP, rr, l.ks, KS,
                                           xs, KX, l.compute);
            else
                acc = column_dot<KT>(hbuf + (t & 1) * HP, rr, l.ks, KS);
            if (l.live) {
                float z;
                h = fwd_point<T>((float)acc, in.x, Gates{in.y, in.z, in.w},
                                 c, z);
                if (t <= last)
                    send(l, KS, hbuf_s + 8u * (uint32_t)(((t + 1) & 1) * HP),
                         x_s[(t + 1) & 1], (double)h);
                float* out = my_out + slot * W * kFwdOut;
                if (l.ks == 0) out[0] = h;
                if (l.ks == (1 % KS)) out[1] = c;
                if (l.ks == (2 % KS)) out[2] = z;
            }
            hand_over(bars, t);
        }
    }
    cluster_arrive();
    cluster_wait();
    if (l.lead) {
        c_out[state + l.j] = c;
        h_out[state + l.j] = h;
    }
}

// grid and block as the forward's; iteration u walks step t = S - 1 - u,
// the exchanged vector is dzpre_t (sent for u <= S - 2, and u = S - 1 too
// when need_dh0: dh0's product); the helper prepares c_t, c_{t-1} (the
// next iteration's cs, or c0 at t = 0), z_t, ip_t, the gates and gy_t, and
// stores dzx, dip, dfp, dop.
template <typename T, int KT>
__global__ void __launch_bounds__(kClusterThreads)
slstm_bwd_cluster(const T* __restrict__ gy, const float* __restrict__ gc,
                  const float* __restrict__ gh, const float* __restrict__ ip,
                  const float* __restrict__ fp, const float* __restrict__ op,
                  const float* __restrict__ rT, const float* __restrict__ c0,
                  const float* __restrict__ cs, const T* __restrict__ zs,
                  T* __restrict__ dzx, float* __restrict__ dip,
                  float* __restrict__ dfp, float* __restrict__ dop,
                  float* __restrict__ dc0, float* __restrict__ dh0, int S,
                  int H, int hd, int W, int KS, int need_dh0) {
    extern __shared__ __align__(16) unsigned char cl_smem[];
    __shared__ Bars bars;
    const Lane l = lane_of(hd, W, KS);
    const int chain = blockIdx.x / l.C, b = chain / H, head = chain % H;
    const int d = H * hd, tid = threadIdx.x, HP = KT * KS;
    double* gbuf = reinterpret_cast<double*>(cl_smem);
    float* ring_in = reinterpret_cast<float*>(gbuf + 2 * HP);
    float* ring_out = ring_in + kRing * W * kBwdIn;
    uint32_t* raw = reinterpret_cast<uint32_t*>(ring_out
                                                + kRing * W * kBwdOut);
    const uint32_t gbuf_s = smem_u32(gbuf);
    const uint32_t x_s[2] = {smem_u32(&bars.x[0]), smem_u32(&bars.x[1])};
    const uint32_t bytes = 8u * (uint32_t)hd;
    const int last = need_dh0 ? S - 1 : S - 2;

    double rr[KT];
    load_slice<KT>(rr, rT + (size_t)head * hd * hd, hd, l.j, l.live, l.ks,
                   KS);
    for (int k = tid; k < 2 * HP; k += blockDim.x) gbuf[k] = 0.0;
    init_bars(bars, l, KS, last + 1, bytes);
    const size_t state = (size_t)b * d + (size_t)head * hd;
    float dc = (l.live && gc) ? gc[state + l.j] : 0.0f;
    float dhc = (l.live && gh) ? gh[state + l.j] : 0.0f;
    const size_t row0 = (size_t)b * S * d + (size_t)head * hd
                        + (size_t)l.rank * W;
    cluster_arrive();
    cluster_wait();
    float dh_last = dhc;
    if (l.helper && l.ncols > 0) {
        const Stream st[kBwdRaw] = {
            {reinterpret_cast<const unsigned char*>(cs), 4},
            {reinterpret_cast<const unsigned char*>(zs), (int)sizeof(T)},
            {reinterpret_cast<const unsigned char*>(ip), 4},
            {reinterpret_cast<const unsigned char*>(fp), 4},
            {reinterpret_cast<const unsigned char*>(op), 4},
            {reinterpret_cast<const unsigned char*>(gy), (int)sizeof(T)}};
        const float* c0b = c0 + state + (size_t)l.rank * W;
        helper_loop<kBwdRaw, kBwdIn, kBwdOut>(
            l, S, st, row0, d, true, ring_in, ring_out, smem_u32(raw), raw,
            bars,
            [&](float* in, const uint32_t* w, const uint32_t* wn, int col,
                int p, size_t elem) {
                const float vi = __uint_as_float(w[2]);
                const Gates g = gates(vi, __uint_as_float(w[3]),
                                      __uint_as_float(w[4]));
                in[0] = __uint_as_float(w[0]);
                in[1] = p < S - 1 ? __uint_as_float(wn[0]) : c0b[col];
                in[2] = Word<T>::get(w[1], st[1], elem);
                in[3] = vi;
                in[4] = g.i;
                in[5] = g.f;
                in[6] = g.o;
                in[7] = st[5].base ? Word<T>::get(w[5], st[5], elem) : 0.0f;
            },
            [&](const float* out, int, size_t elem) {
                dzx[elem] = Cvt<T>::store(out[0]);
                dip[elem] = out[1];
                dfp[elem] = out[2];
                dop[elem] = out[3];
            });
    } else if (l.warp_live) {
        const float* my_in = ring_in + (size_t)min(l.col, W - 1) * kBwdIn;
        float* my_out = ring_out + (size_t)min(l.col, W - 1) * kBwdOut;
        for (int u = 0; u < S; ++u) {
            const int slot = u % kRing;
            mbar_wait(smem_u32(&bars.in_full[slot]), (u / kRing) & 1);
            const float4 a = *reinterpret_cast<const float4*>(
                my_in + slot * W * kBwdIn);
            const float4 e = *reinterpret_cast<const float4*>(
                my_in + slot * W * kBwdIn + 4);
            if (u > 0) {
                mbar_wait(x_s[u & 1], ((u - 1) >> 1) & 1);
                if (tid == 0 && u + 1 <= last) mbar_expect(x_s[u & 1], bytes);
                dhc = (float)column_dot<KT>(gbuf + (u & 1) * HP, rr, l.ks,
                                            KS);
            }
            if (l.live) {
                // a = (c, c_{t-1}, z, ip), e = (i, f, o, gy)
                const BwdOut o = bwd_point<T>(e.w + dhc, dc, a.x, a.y, a.z,
                                              a.w, Gates{e.x, e.y, e.z});
                if (u <= last)
                    send(l, KS, gbuf_s + 8u * (uint32_t)(((u + 1) & 1) * HP),
                         x_s[(u + 1) & 1], (double)o.dpre);
                float* out = my_out + slot * W * kBwdOut;
                if (l.ks == 0) out[0] = o.dpre;
                if (l.ks == (1 % KS)) out[1] = o.dip;
                if (l.ks == (2 % KS)) out[2] = o.dfp;
                if (l.ks == (3 % KS)) out[3] = o.dop;
            }
            hand_over(bars, u);
        }
        dh_last = dhc;
        if (need_dh0 && S > 0) {
            mbar_wait(x_s[S & 1], ((S - 1) >> 1) & 1);
            dh_last = (float)column_dot<KT>(gbuf + (S & 1) * HP, rr, l.ks,
                                            KS);
        }
    }
    cluster_arrive();
    cluster_wait();
    if (l.lead) {
        dc0[state + l.j] = dc;
        if (need_dh0) dh0[state + l.j] = dh_last;
    }
}

// [cluster-step]: ``iters`` steps of an exchange alone, in ``grid / C``
// clusters of C blocks of roundup32(W KS) threads: each lane of W columns
// reads a double of the last step's vector, then stores one to its share
// of the C blocks' double-buffered vectors. mode 0: st.shared::cluster and
// one split cluster barrier a step; mode 1: st.async counted on each
// block's mbarrier of that buffer, each block waiting for its vector's
// bytes; mode 2: the split cluster barrier alone.
__global__ void __launch_bounds__(kClusterThreads)
slstm_cluster_probe_kernel(int W, int KS, int iters, int mode,
                           double* sink) {
    extern __shared__ __align__(16) unsigned char cl_smem[];
    __shared__ __align__(8) uint64_t bars[2];
    double* buf = reinterpret_cast<double*>(cl_smem);
    const int C = (int)cluster_blocks(), rank = (int)cluster_rank();
    const int col = threadIdx.x / KS, ks = threadIdx.x % KS;
    const int n = W * C;
    const uint32_t bar0 = smem_u32(&bars[0]), bar1 = smem_u32(&bars[1]);
    const uint32_t bytes = (uint32_t)n * sizeof(double);
    for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) buf[k] = 0.0;
    if (threadIdx.x == 0) {
        mbar_init(bar0);
        mbar_init(bar1);
        mbar_init_fence();
        if (iters > 1) mbar_expect(bar1, bytes);
        if (iters > 2) mbar_expect(bar0, bytes);
    }
    cluster_arrive();
    cluster_wait();
    double v = rank + col;
    for (int it = 0; it < iters; ++it) {
        const uint32_t bar_in = (it & 1) ? bar1 : bar0;
        const uint32_t bar_out = (it & 1) ? bar0 : bar1;
        if (mode == 1 && it > 0) {
            mbar_wait(bar_in, ((it - 1) >> 1) & 1);
            if (threadIdx.x == 0 && it + 2 < iters)
                mbar_expect(bar_in, bytes);
        }
        v = buf[(it & 1) * n + (col + 1) % n] + 1.0;
        if (col < W && mode != 2 && (mode == 0 || it + 1 < iters)) {
            const uint32_t dst = smem_u32(buf + ((it + 1) & 1) * n
                                          + rank * W + col);
            for (int q = ks; q < C; q += KS) {
                if (mode == 0) st_cluster(dst, q, v);
                else st_async(dst, bar_out, q, v);
            }
        }
        if (mode != 1) {
            cluster_arrive();
            cluster_wait();
        }
    }
    cluster_arrive();
    cluster_wait();
    if (threadIdx.x == 0) sink[blockIdx.x] = v;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int opt_in_limit() {
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 48 << 10;
    if (cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 48 << 10;
    return limit;
}

int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return 0;
    return n;
}

int threads_for(int hd) {
    int n = (hd + 31) / 32 * 32;
    return n > kMaxThreads ? kMaxThreads : n;
}

int round32(int n) { return (n + 31) / 32 * 32; }

// the dynamic shared memory of a one-block kernel: 2 hd doubles,
// ``floats`` floats and, when ``with_r``, r[head] (staged where this fits
// the opt-in limit)
size_t smem_bytes(int hd, int floats, bool with_r) {
    return 2 * (size_t)hd * sizeof(double)
           + ((with_r ? (size_t)hd * hd : 0) + floats) * sizeof(float);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
    if (smem <= (48u << 10)) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A cluster launch's shape: C blocks a chain of ``threads`` threads (the
// compute threads and the helper warp), W columns a block, KS k-slices of
// KT terms a column in registers and, the split forward, KX more a lane
// in shared memory as float (0 otherwise).
struct Plan {
    int C, KS, KT, W, threads, KX;
};

int kt_instance(int terms) {
    static const int kInstances[] = {8, 16, 24, 32};
    for (int kt : kInstances)
        if (terms <= kt) return kt;
    return 0;
}

// the shape for C blocks and KS k-slices (KS 0: the rule's, the smallest
// power of two with ceil(hd / KS) <= kTerms, halved while the compute
// threads exceed kClusterThreads less the helper warp and KT stays <= 32);
// false if it does not fit. Past kClusterMaxHd, the forward only, up to
// kSplitMaxHd: the split shape, KS (0: the rule's) the most lanes a column
// that the compute threads allow, kSplitKT terms a lane in registers and
// the rest, rounded up to a multiple of 4, in shared memory as float,
// within the card's opt-in shared memory beside the block's static
// barriers.
bool shape_for(int hd, int C, int KS, Plan* p, bool backward = false) {
    if (hd < 1 || C < 1 || C > kMaxCluster || (C & (C - 1))) return false;
    const int W = (hd + C - 1) / C;
    const int most = kClusterThreads - 32;      // the helper warp's room
    if (hd > kClusterMaxHd) {
        if (backward || hd > kSplitMaxHd) return false;
        if (KS == 0) {
            KS = 32;
            while (KS > 1 && round32(W * KS) > most) KS /= 2;
        }
        if (KS < 1 || KS > 32 || (KS & (KS - 1))) return false;
        const int compute = round32(W * KS);
        const int KX = ((hd + KS - 1) / KS + 3) / 4 * 4 - kSplitKT;
        if (compute > most || KX < 4
            || cluster_smem(kSplitKT, KS, W, false, KX) + sizeof(Bars)
                   > (size_t)opt_in_limit())
            return false;
        *p = {C, KS, kSplitKT, W, compute + 32, KX};
        return true;
    }
    if (KS == 0) {
        KS = 1;
        while ((hd + KS - 1) / KS > kTerms && KS < 32) KS *= 2;
        while (KS > 1 && round32(W * KS) > most
               && (hd + KS / 2 - 1) / (KS / 2) <= 32)
            KS /= 2;
    }
    if (KS < 1 || KS > 32 || (KS & (KS - 1))) return false;
    const int KT = kt_instance((hd + KS - 1) / KS);
    const int compute = round32(W * KS);
    if (KT == 0 || compute > most) return false;
    *p = {C, KS, KT, W, compute + 32, 0};
    return true;
}

// (the cluster kernels' static shared memory counts against the 48 KB a
// launch has without the opt-in, so the dynamic size is always set)
template <typename Kernel>
cudaError_t cluster_attrs(Kernel kernel, int C, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
}

template <typename Kernel>
cudaLaunchConfig_t cluster_config(Kernel, const Plan& p, int chains,
                                  size_t smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(chains * p.C);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// clusters of this shape the card holds at once (0 on any error)
template <typename Kernel>
int resident_clusters(Kernel kernel, const Plan& p, int chains,
                      size_t smem) {
    if (cluster_attrs(kernel, p.C, smem) != cudaSuccess) return 0;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(kernel, p, chains, smem,
                                            nullptr, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    return n;
}

template <typename T>
struct Kernels {
    template <int KT>
    static void* fwd() { return (void*)slstm_fwd_cluster<T, KT>; }
    template <int KT>
    static void* bwd() { return (void*)slstm_bwd_cluster<T, KT>; }
    // split: the split forward (KX > 0)
    static void* pick(bool backward, int KT, bool split) {
        if (split) {
            if (backward || KT != kSplitKT) return nullptr;
            return (void*)slstm_fwd_cluster<T, kSplitKT, true>;
        }
        switch (KT) {
            case 8: return backward ? bwd<8>() : fwd<8>();
            case 16: return backward ? bwd<16>() : fwd<16>();
            case 24: return backward ? bwd<24>() : fwd<24>();
            case 32: return backward ? bwd<32>() : fwd<32>();
            default: return nullptr;
        }
    }
};

void* cluster_kernel(int dtype, bool backward, int KT, bool split) {
    switch (dtype) {
        case 0: return Kernels<float>::pick(backward, KT, split);
        case 1: return Kernels<__nv_bfloat16>::pick(backward, KT, split);
        case 2: return Kernels<__half>::pick(backward, KT, split);
        default: return nullptr;
    }
}

// The rule for C (header comment), for ``chains`` = B H chains.
int plan(int chains, int hd, int dtype, bool backward, Plan* out) {
    int C = 1;
    while (C < kMaxCluster && hd / (2 * C) >= kMinCols) C *= 2;
    Plan p;
    while (!shape_for(hd, C, 0, &p, backward)) {  // too many threads a block
        if (C >= kMaxCluster) return int(cudaErrorInvalidValue);
        C *= 2;
    }
    const int sms = sm_count();
    while (C > 1) {
        const void* k = cluster_kernel(dtype, backward, p.KT, p.KX > 0);
        if (k == nullptr) return int(cudaErrorInvalidValue);
        const size_t smem = cluster_smem(p.KT, p.KS, p.W, backward, p.KX);
        const bool fits = chains * C <= sms
            && resident_clusters(k, p, chains, smem) >= chains;
        Plan q;
        if (fits || !shape_for(hd, C / 2, 0, &q, backward)) break;
        C /= 2;
        p = q;
    }
    *out = p;
    return 0;
}

// The shape the entry points launch for ``chains`` chains of width hd: the
// rule's cluster shape up to kClusterMaxHd (the forward up to kSplitMaxHd),
// else C = 0 (the one-block kernels, threads_for(hd) threads). Cached per
// device and shape: the rule asks the occupancy API.
int route(int chains, int hd, int dtype, bool backward, Plan* out) {
    if (hd > (backward ? kClusterMaxHd : kSplitMaxHd)) {
        *out = {0, 0, 0, 0, threads_for(hd), 0};
        return 0;
    }
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return int(e);
    static std::mutex mu;
    static std::map<std::array<int, 5>, Plan> plans;
    const std::array<int, 5> key = {dev, chains, hd, dtype, int(backward)};
    std::lock_guard<std::mutex> lock(mu);
    auto it = plans.find(key);
    if (it == plans.end()) {
        Plan p;
        const int err = plan(chains, hd, dtype, backward, &p);
        if (err) return err;
        it = plans.emplace(key, p).first;
    }
    *out = it->second;
    return 0;
}

int cluster_launch(const Plan& p, int dtype, bool backward, int chains,
                   void** args, cudaStream_t s) {
    const void* kernel = cluster_kernel(dtype, backward, p.KT, p.KX > 0);
    if (kernel == nullptr) return int(cudaErrorInvalidValue);
    const size_t smem = cluster_smem(p.KT, p.KS, p.W, backward, p.KX);
    int err = int(cluster_attrs(kernel, p.C, smem));
    if (err) return err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(kernel, p, chains, smem, s,
                                            attr);
    err = int(cudaLaunchKernelExC(&cfg, kernel, args));
    return err ? err : int(cudaGetLastError());
}

template <typename T>
int fwd(const void* zx, const void* ip, const void* fp, const void* op,
        const void* r, const void* c0, const void* h0, void* y, void* c_out,
        void* h_out, void* cs, void* hs, void* zs, int B, int S, int H,
        int hd, int save, Plan p, cudaStream_t s) {
    if (p.C > 0) {
        void* args[] = {&zx, &ip, &fp, &op, &r, &c0, &h0, &y, &c_out,
                        &h_out, &cs, &hs, &zs, &S, &H, &hd, &p.W, &p.KS,
                        &p.KX, &save};
        return cluster_launch(p, dtype_code<T>(), false, B * H, args, s);
    }
    const bool in_smem = smem_bytes(hd, hd, true) <= (size_t)opt_in_limit();
    const size_t smem = smem_bytes(hd, hd, in_smem);
    auto kernel = in_smem ? slstm_fwd_kernel<T, true>
                          : slstm_fwd_kernel<T, false>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<B * H, p.threads, smem, s>>>(
        static_cast<const T*>(zx), static_cast<const float*>(ip),
        static_cast<const float*>(fp), static_cast<const float*>(op),
        static_cast<const float*>(r), static_cast<const float*>(c0),
        static_cast<const float*>(h0), static_cast<T*>(y),
        static_cast<float*>(c_out), static_cast<float*>(h_out),
        static_cast<float*>(cs), static_cast<float*>(hs),
        static_cast<T*>(zs), S, H, hd, save);
    return int(cudaGetLastError());
}

template <typename T>
int bwd(const void* gy, const void* gc, const void* gh, const void* ip,
        const void* fp, const void* op, const void* rT, const void* c0,
        const void* cs, const void* zs, void* dzx, void* dip, void* dfp,
        void* dop, void* dc0, void* dh0, int B, int S, int H, int hd,
        int need_dh0, Plan p, cudaStream_t s) {
    if (p.C > 0) {
        void* args[] = {&gy, &gc, &gh, &ip, &fp, &op, &rT, &c0, &cs, &zs,
                        &dzx, &dip, &dfp, &dop, &dc0, &dh0, &S, &H, &hd,
                        &p.W, &p.KS, &need_dh0};
        return cluster_launch(p, dtype_code<T>(), true, B * H, args, s);
    }
    const bool in_smem = smem_bytes(hd, 2 * hd, true)
                         <= (size_t)opt_in_limit();
    const size_t smem = smem_bytes(hd, 2 * hd, in_smem);
    auto kernel = in_smem ? slstm_bwd_kernel<T, true>
                          : slstm_bwd_kernel<T, false>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<B * H, p.threads, smem, s>>>(
        static_cast<const T*>(gy), static_cast<const float*>(gc),
        static_cast<const float*>(gh), static_cast<const float*>(ip),
        static_cast<const float*>(fp), static_cast<const float*>(op),
        static_cast<const float*>(rT), static_cast<const float*>(c0),
        static_cast<const float*>(cs), static_cast<const T*>(zs),
        static_cast<T*>(dzx), static_cast<float*>(dip),
        static_cast<float*>(dfp), static_cast<float*>(dop),
        static_cast<float*>(dc0), static_cast<float*>(dh0), S, H, hd,
        need_dh0);
    return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shape slstm_fwd (backward 0) or slstm_bwd (1) launches for B H =
// ``chains`` chains of width hd in ``dtype``: *C blocks a chain (0: the
// one-block kernels, the forward past kSplitMaxHd, the backward past
// kClusterMaxHd), *KS k-slices a column and *KT terms a lane in registers
// (the header's rule; 0 for the one-block kernels), *threads a block, and
// *KX float terms a lane in shared memory (the split forward, else 0). A
// query: the entry points choose it themselves.
int slstm_plan(int chains, int hd, int dtype, int backward, int* C, int* KS,
               int* KT, int* threads, int* KX) {
    Plan p;
    const int err = route(chains, hd, dtype, backward != 0, &p);
    if (err) return err;
    *C = p.C;
    *KS = p.KS;
    *KT = p.KT;
    *threads = p.threads;
    *KX = p.KX;
    return 0;
}

// zx, y, zs: (B, S, d) in the activations' dtype (0 float32, 1 bf16,
// 2 f16); ip, fp, op, cs, hs: (B, S, d) f32; r: (H, hd, hd) f32; c0, h0,
// c_out, h_out: (B, d) f32; d = H hd; all contiguous. cs, hs and zs are
// written only when save is nonzero. B H >= 1. *cluster is set to the
// blocks a chain it launched with (slstm_plan's C; 0: the one-block
// kernel).
int slstm_fwd(const void* zx, const void* ip, const void* fp, const void* op,
              const void* r, const void* c0, const void* h0, void* y,
              void* c_out, void* h_out, void* cs, void* hs, void* zs, int B,
              int S, int H, int hd, int dtype, int save, int* cluster,
              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Plan p;
    const int err = route(B * H, hd, dtype, false, &p);
    if (err) return err;
    *cluster = p.C;
    switch (dtype) {
        case 0: return fwd<float>(zx, ip, fp, op, r, c0, h0, y, c_out, h_out,
                                  cs, hs, zs, B, S, H, hd, save, p, s);
        case 1: return fwd<__nv_bfloat16>(zx, ip, fp, op, r, c0, h0, y,
                                          c_out, h_out, cs, hs, zs, B, S, H,
                                          hd, save, p, s);
        case 2: return fwd<__half>(zx, ip, fp, op, r, c0, h0, y, c_out,
                                   h_out, cs, hs, zs, B, S, H, hd, save, p,
                                   s);
        default: return int(cudaErrorInvalidValue);
    }
}

// gy, zs, dzx: (B, S, d) in the activations' dtype; gc, gh (B, d) f32 or
// null; ip, fp, op, cs, dip, dfp, dop: (B, S, d) f32; rT: (H, hd, hd) f32,
// r transposed per head; c0, dc0, dh0: (B, d) f32. dh0 is written only
// when need_dh0 is nonzero. *cluster as slstm_fwd's.
int slstm_bwd(const void* gy, const void* gc, const void* gh, const void* ip,
              const void* fp, const void* op, const void* rT, const void* c0,
              const void* cs, const void* zs, void* dzx, void* dip, void* dfp,
              void* dop, void* dc0, void* dh0, int B, int S, int H, int hd,
              int dtype, int need_dh0, int* cluster, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Plan p;
    const int err = route(B * H, hd, dtype, true, &p);
    if (err) return err;
    *cluster = p.C;
    switch (dtype) {
        case 0: return bwd<float>(gy, gc, gh, ip, fp, op, rT, c0, cs, zs,
                                  dzx, dip, dfp, dop, dc0, dh0, B, S, H, hd,
                                  need_dh0, p, s);
        case 1: return bwd<__nv_bfloat16>(gy, gc, gh, ip, fp, op, rT, c0,
                                          cs, zs, dzx, dip, dfp, dop, dc0,
                                          dh0, B, S, H, hd, need_dh0, p, s);
        case 2: return bwd<__half>(gy, gc, gh, ip, fp, op, rT, c0, cs, zs,
                                   dzx, dip, dfp, dop, dc0, dh0, B, S, H, hd,
                                   need_dh0, p, s);
        default: return int(cudaErrorInvalidValue);
    }
}

// [cluster-step]: ``clusters`` clusters of C blocks, each running
// ``iters`` steps of the exchange of W columns over KS lanes a column by
// ``mode`` (slstm_cluster_probe_kernel); ``sink`` holds grid doubles.
int slstm_cluster_probe(int C, int W, int KS, int clusters, int iters,
                        int mode, void* sink, void* stream) {
    Plan p = {C, KS, 0, W, round32(W * KS), 0};
    if (C < 1 || C > kMaxCluster || p.threads > kClusterThreads)
        return int(cudaErrorInvalidValue);
    const size_t smem = 2 * (size_t)W * C * sizeof(double);
    auto kernel = slstm_cluster_probe_kernel;
    cudaError_t err = cluster_attrs(kernel, C, smem);
    if (err != cudaSuccess) return int(err);
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(
        kernel, p, clusters, smem, static_cast<cudaStream_t>(stream), attr);
    err = cudaLaunchKernelEx(&cfg, kernel, W, KS, iters, mode,
                             static_cast<double*>(sink));
    return err != cudaSuccess ? int(err) : int(cudaGetLastError());
}

}  // extern "C"
