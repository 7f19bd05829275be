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
//                                    dtype: rec, the sum and the tanh
//   c_t = sigmoid(fp) c_{t-1} + exp(min(ip, 6)) z        (f32)
//   h_t = sigmoid(op) c_t / max(|c_t|, 1),   y_t = h_t in x's dtype.
//
// The recurrent product is summed in double and rounded once to f32 (see
// matvec_col), as the plain version takes it, so both round the same f32
// rec to x's dtype.
//
// What bounds it on this card: neither bytes nor operations but the
// serial chain. Each step's hd x hd matrix-vector product needs the
// previous step's h, so a head's S steps run one after another. Bytes are
// small (zx, three f32 gates, y; 18 B a unit and step in bf16) and the
// FLOPs, 2 B S d hd, are well below the f32 rate at xlstm-125m's shapes.
//
// What the design does about it: the recurrences of different (b, head)
// pairs are independent (r is block-diagonal per head), so a block owns
// one pair and walks its S steps; a thread owns a unit (hd threads, rounded
// up to a warp; units are looped above 1024). r[head] is staged once in
// dynamic shared memory (hd 192: 147,456 B, opted in above 48 KB), or read
// from global memory (L2) where hd^2 floats do not fit. h_{t-1} lives in
// shared memory as double (its writer widens it once, so the product
// converts only r), double-buffered, so a step needs one __syncthreads. The
// next step's four inputs, which do not depend on h, are loaded into
// registers one step ahead, behind the matrix-vector product. With only
// B H blocks the card is mostly idle at small batch; splitting a head over
// several SMs (clusters) and shortening the step are later work.
//
// The backward walks t from S-1 to 0 with the same grid. It reads the
// c and z the forward saved for every step (and recomputes the gates from
// their pre-activations), carries dc and dh, and writes the gradients of
// zx and of the three pre-activations, then dc0 and dh0. dh_{t-1} = r
// dzpre_t is the same matrix-vector product against the transpose, which
// the wrapper passes (rT), so both kernels read the matrix along a row.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

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

__device__ __forceinline__ float sigmoidf(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// out = sum_k v[k] m[k][j] (m row-major, hd x hd), rounded once to f32
// from a double sum: each product of two floats is exact in double and the
// sum's error is a few double ulps whatever its order (four chains here, to
// shorten the dependent one), so the f32 result equals the plain version's
// float64 product rounded to float32 unless it lies within those ulps of an
// f32 rounding boundary. In bf16 a float32 sum in another order flips the
// rounding of rec now and then, and exp(ip) up to e^6 magnifies one flip
// past the tolerance.
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

struct Gates {
    float i, f, o;
};

__device__ __forceinline__ Gates gates(float ip, float fp, float op) {
    return {expf(fminf(ip, 6.0f)), sigmoidf(fp), sigmoidf(op)};
}

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
            const float rec = Cvt<T>::round(matvec_col(hp, R, hd, j));
            const float z = Cvt<T>::round(tanhf(Cvt<T>::round(vz + rec)));
            const Gates g = gates(vi, vf, vo);
            const float c = __fadd_rn(__fmul_rn(g.f, cbuf[j]),
                                      __fmul_rn(g.i, z));
            const float n = fmaxf(fabsf(c), 1.0f);
            const float h = __fmul_rn(g.o, __fdiv_rn(c, n));
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
            const float z = Cvt<T>::load(zs[row + j]);
            const float vi = ip[row + j];
            const Gates ga = gates(vi, fp[row + j], op[row + j]);
            const float dh = (gy ? Cvt<T>::load(gy[row + j]) : 0.0f)
                             + dhc[j];
            const float n = fmaxf(fabsf(c), 1.0f);
            const float q = __fdiv_rn(c, n);
            // h = o q, q = c / n, n = max(|c|, 1)
            dop[row + j] = dh * q * (1.0f - ga.o) * ga.o;
            const float dq = dh * ga.o;
            float dct = dcc[j] + __fdiv_rn(dq, n);
            if (fabsf(c) >= 1.0f && c != 0.0f) {
                const float dn = __fdiv_rn(-dq * c, n * n);
                dct += c > 0.0f ? dn : -dn;
            }
            // c = f cp + i z, i = exp(min(ip, 6))
            dfp[row + j] = dct * cp * (1.0f - ga.f) * ga.f;
            dip[row + j] = vi <= 6.0f ? dct * z * ga.i : 0.0f;
            const float dz = Cvt<T>::round(dct * ga.i);
            const float dpre = Cvt<T>::round(dz * (1.0f - z * z));
            dzx[row + j] = Cvt<T>::store(dpre);
            g[j] = dpre;
            dcc[j] = dct * ga.f;
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

int opt_in_limit() {
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 48 << 10;
    if (cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 48 << 10;
    return limit;
}

int threads_for(int hd) {
    int n = (hd + 31) / 32 * 32;
    return n > kMaxThreads ? kMaxThreads : n;
}

// the dynamic shared memory of a kernel: 2 hd doubles, ``floats`` floats
// and, when ``with_r``, r[head] (staged where this fits the opt-in limit)
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

template <typename T>
int fwd(const void* zx, const void* ip, const void* fp, const void* op,
        const void* r, const void* c0, const void* h0, void* y, void* c_out,
        void* h_out, void* cs, void* hs, void* zs, int B, int S, int H,
        int hd, int save, cudaStream_t s) {
    const bool in_smem = smem_bytes(hd, hd, true) <= (size_t)opt_in_limit();
    const size_t smem = smem_bytes(hd, hd, in_smem);
    auto kernel = in_smem ? slstm_fwd_kernel<T, true>
                          : slstm_fwd_kernel<T, false>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<B * H, threads_for(hd), smem, s>>>(
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
        int need_dh0, cudaStream_t s) {
    const bool in_smem = smem_bytes(hd, 2 * hd, true)
                         <= (size_t)opt_in_limit();
    const size_t smem = smem_bytes(hd, 2 * hd, in_smem);
    auto kernel = in_smem ? slstm_bwd_kernel<T, true>
                          : slstm_bwd_kernel<T, false>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<B * H, threads_for(hd), smem, s>>>(
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

// zx, y, zs: (B, S, d) in the activations' dtype (0 float32, 1 bf16);
// ip, fp, op, cs, hs: (B, S, d) f32; r: (H, hd, hd) f32; c0, h0,
// c_out, h_out: (B, d) f32; d = H hd; all contiguous. cs, hs and zs are
// written only when save is nonzero. B H >= 1.
int slstm_fwd(const void* zx, const void* ip, const void* fp, const void* op,
              const void* r, const void* c0, const void* h0, void* y,
              void* c_out, void* h_out, void* cs, void* hs, void* zs, int B,
              int S, int H, int hd, int dtype, int save, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return fwd<float>(zx, ip, fp, op, r, c0, h0, y, c_out, h_out,
                                  cs, hs, zs, B, S, H, hd, save, s);
        case 1: return fwd<__nv_bfloat16>(zx, ip, fp, op, r, c0, h0, y,
                                          c_out, h_out, cs, hs, zs, B, S, H,
                                          hd, save, s);
        default: return int(cudaErrorInvalidValue);
    }
}

// gy, zs, dzx: (B, S, d) in the activations' dtype; gc, gh (B, d) f32 or
// null; ip, fp, op, cs, dip, dfp, dop: (B, S, d) f32; rT: (H, hd, hd) f32,
// r transposed per head; c0, dc0, dh0: (B, d) f32. dh0 is written only
// when need_dh0 is nonzero.
int slstm_bwd(const void* gy, const void* gc, const void* gh, const void* ip,
              const void* fp, const void* op, const void* rT, const void* c0,
              const void* cs, const void* zs, void* dzx, void* dip, void* dfp,
              void* dop, void* dc0, void* dh0, int B, int S, int H, int hd,
              int dtype, int need_dh0, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return bwd<float>(gy, gc, gh, ip, fp, op, rT, c0, cs, zs,
                                  dzx, dip, dfp, dop, dc0, dh0, B, S, H, hd,
                                  need_dh0, s);
        case 1: return bwd<__nv_bfloat16>(gy, gc, gh, ip, fp, op, rT, c0,
                                          cs, zs, dzx, dip, dfp, dop, dc0,
                                          dh0, B, S, H, hd, need_dh0, s);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // extern "C"
