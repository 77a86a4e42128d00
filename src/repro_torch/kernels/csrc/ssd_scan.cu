// Mamba2 SSD (state-space duality) chunk scan, one CUDA kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py (ssd_scan,
// _kernel): x (B, S, H, P), dt (B, S, H) after the softplus, A (H,) < 0, B
// and C (B, S, N) shared by the heads, D (H,) -> y (B, S, H, P) and the final
// state (B, H, N, P).  For each chunk of L steps, with cum the running sum of
// dt * A inside the chunk and total = cum[L-1]:
//   (1) y_t  = sum_{s <= t} exp(cum[t] - cum[s]) (C_t . B_s) (x dt)_s
//   (2)      + exp(cum[t]) C_t . h           (the state carried in)
//   (3)      + D x_t
//   (4) h    = exp(total) h + sum_s exp(total - cum[s]) B_s (x) (x dt)_s.
// The state may start from a given h0 (a chunked continuation), where the
// TPU kernel starts from zero.  Arithmetic is float32 throughout, as in the
// TPU kernel (operands cast to f32, f32 products); y is rounded once to x's
// dtype.  exp is taken of cum[t] - cum[s] for t >= s only, never factored
// into exp(cum[t]) * exp(-cum[s]): cum reaches about -100 within a chunk at
// the serving path's decay, where exp(100) overflows and inf * 0 is NaN.
//
// Grid and parallelism.  One CTA per (P-tile of PT state columns, head,
// batch row); it walks the chunks in order, as the TPU grid's "arbitrary"
// chunk axis does, with the (N, PT) state tile in shared memory across
// chunks.  Columns of the state over P are independent (y[:, p] needs only
// x[:, p] and h[:, p]), so splitting P is free parallelism: mamba2 at B=1,
// H=48, P=64 gives 96 CTAs of PT=32.
//
// Shared memory (bytes), for N <= 128, L in {32, 64, 128}, PT in {16, 32}:
//   B^T and C^T chunks  2 * N * (L + 16 / sizeof(T)) * sizeof(T)   (in x's
//                       dtype; bf16 keeps them exact and halves the space)
//   M^T                 L * (L + 4) * 4
//   state, x * dt       (N + L) * PT * 4
//   cum, exp weights    3 * L * 4.
// At L = N = 128, PT = 32 that is 171,520 B in bf16 (one CTA an SM) and
// 237,056 B in f32, above the 232,448 B a CTA may have, so the wrapper takes
// PT = 16 there (220,672 B).  Rows of B^T, C^T and M^T are padded by 16
// bytes: row starts stay 16-byte aligned and strided reads spread over the
// banks.
//
// What bounds it on an H100: operations.  The work the function needs is
// C.B^T once per (batch row, chunk) over the causal pairs, and per (batch
// row, head, chunk) M.(x dt) over the causal pairs, C.h (2 L N P) and
// B^T.(x dt) (2 N L P): at mamba2's prefill of 6144 tokens (H=48, P=64,
// N=128, L=128) about 12 GFLOP, 0.18 ms at 67 TFLOP/s in f32, against 0.024
// ms for its 80 MB.  This simple kernel computes C.B^T in every CTA (96
// times over at that shape) and over the whole L x L square, and runs on
// CUDA cores with register tiles fed from shared memory; moving the
// products onto tensor cores (wgmma) and sharing C.B^T across heads is
// later work.
//
// Phases a chunk (256 threads): load B^T, C^T, x*dt and dt*A; one warp scans
// cum; M^T[s][t] = (t >= s) exp(cum[t] - cum[s]) (C.B^T)[t][s], TB x TB
// register tiles (TB = L / 16); y in TT x TP tiles (TT = L / 32, TP = PT /
// 8), written to device memory; the new state in 4 x TP tiles kept in
// registers until every thread has read the old one, then stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// the shared-memory budget, in bytes, of one CTA (see the note above)
long long smem_bytes(int N, int L, int PT, int elem) {
    const long long ld_t = L + 16 / elem;
    return 2LL * N * ld_t * elem + 4LL * L * (L + 4)
         + 4LL * (N + L) * PT + 4LL * 3 * L;
}

template <typename T, int L, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hf, int S, int H, int P, int N) {
    constexpr int LDT = L + 16 / (int)sizeof(T);   // B^T, C^T row length
    constexpr int LDM = L + 4;                     // M^T row length
    constexpr int TB = L / 16;                     // M tile: TB t x TB s
    constexpr int TT = L / 32;                     // y tile: TT t x TP p
    constexpr int TP = PT / 8;
    constexpr int E = L / 32;                      // cum elements a lane
    extern __shared__ __align__(16) unsigned char smem[];
    T* sBt = reinterpret_cast<T*>(smem);           // (N, LDT)
    T* sCt = sBt + (size_t)N * LDT;                // (N, LDT)
    float* sMt = reinterpret_cast<float*>(sCt + (size_t)N * LDT);  // (L, LDM)
    float* sH = sMt + L * LDM;                     // (N, PT) the state tile
    float* sX = sH + N * PT;                       // (L, PT) x * dt
    float* sCum = sX + L * PT;                     // (L,)
    float* sW = sCum + L;                          // exp(total - cum[s])
    float* sE = sW + L;                            // exp(cum[t])

    const int tid = threadIdx.x;
    const int p_base = blockIdx.x * PT;
    const int h = blockIdx.y;
    const long long b = blockIdx.z;
    const float a = A[h], d = D[h];
    const int nc = S / L;
    const long long tok = (long long)H * P;        // x / y stride a step
    const long long head = (long long)h * P + p_base;

    for (int i = tid; i < N * PT; i += kThreads) {
        const int n = i / PT, p = i % PT;
        sH[i] = (h0 != nullptr && p_base + p < P)
                    ? h0[((b * H + h) * N + n) * (long long)P + p_base + p]
                    : 0.0f;
    }

    for (int c = 0; c < nc; ++c) {
        const long long t0 = b * S + (long long)c * L;   // first step's row
        // ---- load: B and C transposed, dt * A, x * dt
        const T* gB = Bm + t0 * N;
        const T* gC = Cm + t0 * N;
        for (int i = tid; i < L * N; i += kThreads) {
            const int t = i / N, n = i % N;
            sBt[n * LDT + t] = gB[i];
            sCt[n * LDT + t] = gC[i];
        }
        const float* gdt = dt + t0 * H + h;
        for (int t = tid; t < L; t += kThreads)
            sCum[t] = gdt[(long long)t * H] * a;
        const T* gx = x + t0 * tok + head;
        for (int i = tid; i < L * PT; i += kThreads) {
            const int t = i / PT, p = i % PT;
            sX[i] = (p_base + p < P)
                        ? to_f(gx[t * tok + p]) * gdt[(long long)t * H]
                        : 0.0f;
        }
        __syncthreads();

        // ---- cum: each lane sums E consecutive steps, then a warp scan
        if (tid < 32) {
            float v[E];
            float run = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                run += sCum[tid * E + e];
                v[e] = run;
            }
            float incl = run;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float u = __shfl_up_sync(0xffffffffu, incl, o);
                if (tid >= o) incl += u;
            }
            float excl = __shfl_up_sync(0xffffffffu, incl, 1);
            if (tid == 0) excl = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) sCum[tid * E + e] = excl + v[e];
        }
        __syncthreads();
        const float total = sCum[L - 1];

        // ---- M^T[s][t] = (t >= s) exp(cum[t] - cum[s]) (C_t . B_s)
        for (int t = tid; t < L; t += kThreads) {
            sW[t] = expf(total - sCum[t]);
            sE[t] = expf(sCum[t]);
        }
        {
            const int s0 = (tid % 16) * TB, tq = (tid / 16) * TB;
            float acc[TB][TB];
#pragma unroll
            for (int i = 0; i < TB; ++i)
#pragma unroll
                for (int j = 0; j < TB; ++j) acc[i][j] = 0.0f;
            if (s0 < tq + TB) {                    // some t >= s in the tile
                for (int n = 0; n < N; ++n) {
                    float cv[TB], bv[TB];
#pragma unroll
                    for (int i = 0; i < TB; ++i) {
                        cv[i] = to_f(sCt[n * LDT + tq + i]);
                        bv[i] = to_f(sBt[n * LDT + s0 + i]);
                    }
#pragma unroll
                    for (int i = 0; i < TB; ++i)
#pragma unroll
                        for (int j = 0; j < TB; ++j)
                            acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
                }
            }
#pragma unroll
            for (int j = 0; j < TB; ++j)
#pragma unroll
                for (int i = 0; i < TB; ++i) {
                    const int t = tq + i, s = s0 + j;
                    sMt[s * LDM + t] =
                        t >= s ? expf(sCum[t] - sCum[s]) * acc[i][j] : 0.0f;
                }
        }
        __syncthreads();

        // ---- y = M.(x dt) + exp(cum) C.h + D x, rounded once
        {
            const int p0 = (tid % 8) * TP, tq = (tid / 8) * TT;
            float yi[TT][TP], yc[TT][TP];
#pragma unroll
            for (int i = 0; i < TT; ++i)
#pragma unroll
                for (int j = 0; j < TP; ++j) yi[i][j] = yc[i][j] = 0.0f;
            for (int s = 0; s < tq + TT; ++s) {    // M^T[s][t] = 0 for s > t
                float mv[TT], xv[TP];
#pragma unroll
                for (int i = 0; i < TT; ++i) mv[i] = sMt[s * LDM + tq + i];
#pragma unroll
                for (int j = 0; j < TP; ++j) xv[j] = sX[s * PT + p0 + j];
#pragma unroll
                for (int i = 0; i < TT; ++i)
#pragma unroll
                    for (int j = 0; j < TP; ++j)
                        yi[i][j] = fmaf(mv[i], xv[j], yi[i][j]);
            }
            for (int n = 0; n < N; ++n) {
                float cv[TT], hv[TP];
#pragma unroll
                for (int i = 0; i < TT; ++i)
                    cv[i] = to_f(sCt[n * LDT + tq + i]);
#pragma unroll
                for (int j = 0; j < TP; ++j) hv[j] = sH[n * PT + p0 + j];
#pragma unroll
                for (int i = 0; i < TT; ++i)
#pragma unroll
                    for (int j = 0; j < TP; ++j)
                        yc[i][j] = fmaf(cv[i], hv[j], yc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < TT; ++i) {
                const int t = tq + i;
                const float e = sE[t];
                const long long row = (t0 + t) * tok + head + p0;
#pragma unroll
                for (int j = 0; j < TP; ++j)
                    if (p_base + p0 + j < P)
                        y[row + j] = from_f<T>(yi[i][j] + yc[i][j] * e
                                               + d * to_f(x[row + j]));
            }
        }

        // ---- the new state, in registers until every old one is read
        float hn[4][TP];
        const int q0 = (tid % 8) * TP, n0 = (tid / 8) * 4;
        const bool own = n0 < N;                   // (N / 4) x 8 tiles
        if (own) {
            float st[4][TP];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < TP; ++j) st[i][j] = 0.0f;
            for (int s = 0; s < L; ++s) {
                const float w = sW[s];
                float xv[TP], bv[4];
#pragma unroll
                for (int j = 0; j < TP; ++j) xv[j] = w * sX[s * PT + q0 + j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    bv[i] = to_f(sBt[(n0 + i) * LDT + s]);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < TP; ++j)
                        st[i][j] = fmaf(bv[i], xv[j], st[i][j]);
            }
            const float carry = expf(total);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < TP; ++j)
                    hn[i][j] = carry * sH[(n0 + i) * PT + q0 + j] + st[i][j];
        }
        __syncthreads();              // every read of this chunk's tiles done
        if (own) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < TP; ++j)
                    sH[(n0 + i) * PT + q0 + j] = hn[i][j];
            if (c == nc - 1) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < TP; ++j)
                        if (p_base + q0 + j < P)
                            hf[((b * H + h) * N + n0 + i) * (long long)P
                               + p_base + q0 + j] = hn[i][j];
            }
        }
    }
}

template <typename T, int L, int PT>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* hf, int Bb, int S, int H,
                   int P, int N, cudaStream_t stream) {
    const long long smem = smem_bytes(N, L, PT, (int)sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, L, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((P + PT - 1) / PT), (unsigned)H, (unsigned)Bb);
    ssd_scan_kernel<T, L, PT><<<grid, kThreads, (size_t)smem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, (const float*)D, (const float*)h0, (T*)y, (float*)hf,
        S, H, P, N);
    return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_pt(int PT, const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* D,
                      const void* h0, void* y, void* hf, int Bb, int S, int H,
                      int P, int N, cudaStream_t s) {
    if (PT == 32)
        return launch<T, L, 32>(x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S, H, P,
                                N, s);
    if (PT == 16)
        return launch<T, L, 16>(x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S, H, P,
                                N, s);
    return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_l(int L, int PT, const void* x, const void* dt,
                     const void* A, const void* Bm, const void* Cm,
                     const void* D, const void* h0, void* y, void* hf, int Bb,
                     int S, int H, int P, int N, cudaStream_t s) {
    if (L == 128)
        return launch_pt<T, 128>(PT, x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S,
                                 H, P, N, s);
    if (L == 64)
        return launch_pt<T, 64>(PT, x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S, H,
                                P, N, s);
    if (L == 32)
        return launch_pt<T, 32>(PT, x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S, H,
                                P, N, s);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (elem: bytes of x's dtype).
long long ssd_scan_smem_bytes(int N, int L, int PT, int elem) {
    return smem_bytes(N, L, PT, elem);
}

// dtype code of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A, D, h0 and
// the final state are float32.  Every array is contiguous; h0 may be null
// (a zero state).  S is a multiple of L (32, 64 or 128), N a multiple of 4
// no larger than 128, PT 16 or 32.  Returns the CUDA error code of the
// attribute call or of the launch (0 = launched); an unknown dtype, chunk
// or tile returns cudaErrorInvalidValue.
int ssd_scan_forward(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* D,
                     const void* h0, void* y, void* hf, int Bb, int S, int H,
                     int P, int N, int L, int PT, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == 0)
        err = launch_l<float>(L, PT, x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S, H,
                              P, N, s);
    else if (dtype == 1)
        err = launch_l<__nv_bfloat16>(L, PT, x, dt, A, Bm, Cm, D, h0, y, hf,
                                      Bb, S, H, P, N, s);
    return (int)err;
}

const char* ssd_scan_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
