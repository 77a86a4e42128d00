// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes).
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
// TPU kernel starts from zero.  y is rounded once to x's dtype.  exp is taken
// of cum[t] - cum[s] for t >= s only, never factored into exp(cum[t]) *
// exp(-cum[s]): cum reaches about -100 within a chunk at the serving path's
// decay, where exp(100) overflows and inf * 0 is NaN.
//
// The TPU kernel walks the chunks in order on one core, the state carried
// in VMEM from one grid step to the next.  On an H100 that order leaves the
// SMs idle: the work that needs it is only (4)'s hand-off, elementwise over
// N x P.  Everything else of a chunk depends on that chunk alone.
//
// bf16 x, B, C: the tensor-core path, four launches a call.
//   (a) ssd_scan_cb_kernel, one CTA a (chunk, batch row): C.B^T once (the
//       heads share B and C), the causal 16 x 16 blocks only, f32 into an
//       (B, nc, L, L) scratch that stays in L2.
//   (b) ssd_scan_state_kernel, one CTA a (chunk, head, batch row, 64 state
//       columns): cum (one warp's scan), then the chunk's own state
//       S_c = sum_s B_s w_s (x) x_s, w_s = exp(total - cum[s]) dt_s, into an
//       (B, nc, H, N, P) f32 scratch, and total into (B, H, nc).
//   (c) ssd_scan_pass_kernel, one thread a (batch row, head, state element):
//       h_c = exp(total_c) h_{c-1} + S_c in chunk order, from h0 or zero,
//       each S_c replaced in place by the state entering chunk c; the last
//       h is the final state.  Only this pass runs in order, 8 chunks' loads
//       issued ahead.
//   (d) ssd_scan_out_kernel, one CTA a (chunk, head, batch row, 64 columns):
//       y = M'.x + exp(cum) C.h + D x, M'[t][s] = (t >= s) exp(cum[t] -
//       cum[s]) (C.B^T)[t][s] dt_s built in registers from (a)'s scratch.
// Every product runs on mma.sync m16n8k16 (bf16 in, f32 sums): C.B^T on the
// exact bf16 B and C, and x always as the exact bf16 operand, dt folded into
// the other side.  That other side is f32 (B_s w_s in (b), M' and h in (d)).
// One bf16 rounding of it would move the state by 2^-9 of its terms, where
// the state is held at 1e-4 of its scale, so each is split into a bf16 hi
// part and the bf16 rounding of the rest (hi + lo carry about 16 bits) and
// multiplied twice.  Sums stay f32.
//
// f32 x, B, C: the CUDA-core kernel ssd_scan_kernel, exact f32 throughout.
// f32 operands on the tensor cores would mean TF32 (10 bits) or a three-way
// split; no serving path scans in f32, so that path keeps the first design:
// one CTA per (P-tile of PT state columns, head, batch row) walking the
// chunks in order with the (N, PT) state tile in shared memory, C.B^T
// recomputed in every CTA, register tiles on CUDA cores.
//
// What bounds it on an H100.  Bytes: x, y, B, C and dt once, about 80 MB at
// mamba2's 6144-token prefill (H=48, P=64, N=128, L=128), 0.024 ms at 3.35
// TB/s; the products (12 GFLOP) take 0.012 ms at the bf16 tensor-core peak.
// The path moves more: the chunk states go through device memory three
// times (75 MB each at 6144 tokens; L2 holds 50 MB), and B, C and x are
// read by two kernels.
//
// Shared memory of the f32 kernel (bytes), for N <= 128, L in {32, 64, 128},
// PT in {16, 32}:
//   B^T and C^T chunks  2 * N * (L + 16 / sizeof(T)) * sizeof(T)
//   M^T                 L * (L + 4) * 4
//   state, x * dt       (N + L) * PT * 4
//   cum, exp weights    3 * L * 4;
// at L = N = 128 that is 237,056 B at PT = 32, above the 232,448 B a CTA may
// have, so the wrapper takes PT = 16 there (220,672 B).  Its phases a chunk
// (256 threads): load B^T, C^T, x*dt and dt*A; one warp scans cum; M^T[s][t]
// = (t >= s) exp(cum[t] - cum[s]) (C.B^T)[t][s] in TB x TB register tiles
// (TB = L / 16); y in TT x TP tiles (TT = L / 32, TP = PT / 8); the new
// state in 4 x TP tiles kept in registers until every thread has read the
// old one.  The tensor-core kernels' tiles have rows of a multiple of 16
// plus 8 bf16 (N and P zero-padded to 16 and 64), so a fragment's 8 rows
// fall on distinct banks: (a) 4 L (N + 8) B, (b) and (d) about 88 KB at
// L = N = 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
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


// ------------------------------------------------ the bf16 tensor-core path
using bf16 = __nv_bfloat16;
constexpr int kPT = 64;                 // state columns (of P) a CTA owns
constexpr int kLDP = kPT + 8;           // row length of a column tile

__host__ __device__ __forceinline__ int pad16(int n) {
    return (n + 15) & ~15;
}
// row lengths (elements) of the bf16 shared tiles: a multiple of 16 plus 8,
// so the 8 rows an ldmatrix phase (or a fragment load) touches fall on
// distinct banks
__host__ __device__ __forceinline__ int ld_of(int n) { return pad16(n) + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 or 8 bytes global -> shared without a register round trip; the
// destination is zero-filled (and src not read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
           | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float lo_f(uint32_t u) {
    return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
}
// the pair (a, b) as packed bf16 hi parts and the bf16 rounding of the
// rest: a = hi + lo + O(2^-17 |a|)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    hi = pack_bf16(a, b);
    lo = pack_bf16(a - lo_f(hi), b - hi_f(hi));
}
// the A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of a
// row-major bf16 matrix (K contiguous, ld elements a row), in shared or
// global memory
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       long long ld, int r0, int k0,
                                       int lane) {
    const bf16* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    a[0] = *reinterpret_cast<const uint32_t*>(p);
    a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}
// the B fragment (k in [k0, k0 + 16), n in [n0, n0 + 8)) of the product
// X . Y^T, read from Y's rows [n0, n0 + 8), K contiguous
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int n0, int k0,
                                       int lane) {
    const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    b0 = *reinterpret_cast<const uint32_t*>(p);
    b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}
// the A fragment (rows m in [m0, m0 + 16), k in [k0, k0 + 16)) of a
// product whose A is stored transposed, (k, m) row-major in shared memory
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int m0, int k0, int lane) {
    ldsm_x4_t(a, smem_u32(s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld
                          + m0 + ((lane >> 3) & 1) * 8));
}
// the B fragments of two n tiles (n0 and n0 + 8; k in [k0, k0 + 16)) of a
// product whose B is stored (k, n) row-major in shared memory: b[0], b[1]
// for the first tile, b[2], b[3] for the second
__device__ __forceinline__ void frag_b2_t(uint32_t (&b)[4], const bf16* s,
                                          int ld, int n0, int k0, int lane) {
    ldsm_x4_t(b, smem_u32(s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                          + n0 + (lane >> 4) * 8));
}

// cum[t] = sum_{u <= t} dt[u] a over the chunk, and dt itself, into shared
// memory: each lane of warp 0 sums L / 32 consecutive steps, then a warp
// scan.  The state and the output kernels both call this, so they see the
// same cum to the last bit.  Ends with __syncthreads.
template <int L>
__device__ __forceinline__ void chunk_cum(const float* gdt, int H, float a,
                                          float* sCum, float* sDt, int tid) {
    constexpr int E = L / 32;
    for (int t = tid; t < L; t += kThreads) {
        const float d = gdt[(long long)t * H];
        sDt[t] = d;
        sCum[t] = d * a;
    }
    __syncthreads();
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
}

// rows [0, L) of a (rows, N) bf16 matrix (row stride N, N a multiple of 4,
// 8-byte aligned) into a shared (L, ld) tile by cp.async, 16 bytes a copy
// where N is a multiple of 8 (and the base 16-byte aligned), else 8;
// columns [N, pad16(N)) zero.  The caller waits (cp_async_wait_all) and
// synchronises before reading the tile.
template <int L>
__device__ __forceinline__ void load_rows(bf16* s, int ld, const bf16* g,
                                          int N, int tid) {
    if ((N & 7) == 0 && ((uintptr_t)g & 15) == 0) {
        const int q8 = pad16(N) / 8;
        for (int i = tid; i < L * q8; i += kThreads) {
            const int t = i / q8, n = (i % q8) * 8;
            const bool ok = n < N;
            cp_async16(s + t * ld + n, ok ? g + (long long)t * N + n : g, ok);
        }
        return;
    }
    const int q4 = pad16(N) / 4;
    for (int i = tid; i < L * q4; i += kThreads) {
        const int t = i / q4, n = (i % q4) * 4;
        const bool ok = n < N;
        cp_async8(s + t * ld + n, ok ? g + (long long)t * N + n : g, ok);
    }
}

// (1) C.B^T of one chunk, once per (chunk, batch row): the causal 16 x 16
// blocks (s block <= t block) of the (L, L) product in f32, into cb.
template <int L>
__global__ void __launch_bounds__(kThreads)
ssd_scan_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   float* __restrict__ cb, int S, int N) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int NP = pad16(N), LDN = ld_of(N);
    bf16* sC = reinterpret_cast<bf16*>(smem);      // (L, LDN): t, n
    bf16* sB = sC + L * LDN;                       // (L, LDN): s, n
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c = blockIdx.x, nc = S / L;
    const long long b = blockIdx.y;
    const long long t0 = b * S + (long long)c * L;
    load_rows<L>(sC, LDN, Cm + t0 * N, N, tid);
    load_rows<L>(sB, LDN, Bm + t0 * N, N, tid);
    cp_async_wait_all();
    __syncthreads();
    float* out = cb + (b * nc + c) * (long long)L * L;
    for (int tb = warp; tb < L / 16; tb += kThreads / 32) {
        float acc[L / 8][4];
#pragma unroll
        for (int j = 0; j < L / 8; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        for (int k0 = 0; k0 < NP; k0 += 16) {
            uint32_t a[4];
            frag_a(a, sC, LDN, tb * 16, k0, lane);
#pragma unroll
            for (int j = 0; j < L / 8; ++j) {
                if (j < 2 * (tb + 1)) {            // s <= the block's last t
                    uint32_t b0, b1;
                    frag_b(b0, b1, sB, LDN, j * 8, k0, lane);
                    mma_bf16(acc[j], a, b0, b1);
                }
            }
        }
        const int t = tb * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < L / 8; ++j) {
            if (j < 2 * (tb + 1)) {
                const int s = j * 8 + 2 * (lane & 3);
                *reinterpret_cast<float2*>(out + t * L + s) =
                    make_float2(acc[j][0], acc[j][1]);
                *reinterpret_cast<float2*>(out + (t + 8) * L + s) =
                    make_float2(acc[j][2], acc[j][3]);
            }
        }
    }
}

// x's (L, kPT) tile of this head and column tile into shared (L, kLDP)
// rows, zero past P.  SPLIT: each element times scale[s] split into bf16
// hi + lo, all loads issued before the first store; else the exact bf16 by
// cp.async (the caller waits).  8-byte copies where P is a multiple of 4.
template <int L, bool SPLIT>
__device__ __forceinline__ void load_x(bf16* sh, bf16* sl, const bf16* gx,
                                       long long tok, int P, int p_base,
                                       const float* scale, int tid) {
    constexpr int Q = kPT / 4;                     // 4-column groups a row
    constexpr int IT = L * Q / kThreads;           // groups a thread
    if ((P & 3) == 0) {
        if (SPLIT) {
            uint2 v[IT];
#pragma unroll
            for (int it = 0; it < IT; ++it) {
                const int i = tid + it * kThreads;
                const int s = i / Q, p = (i % Q) * 4;
                v[it] = p_base + p < P ? *reinterpret_cast<const uint2*>(
                                             gx + s * tok + p)
                                       : make_uint2(0u, 0u);
            }
#pragma unroll
            for (int it = 0; it < IT; ++it) {
                const int i = tid + it * kThreads;
                const int s = i / Q, p = (i % Q) * 4;
                const float w = scale[s];
                uint2 h, l;
                split_pair(lo_f(v[it].x) * w, hi_f(v[it].x) * w, h.x, l.x);
                split_pair(lo_f(v[it].y) * w, hi_f(v[it].y) * w, h.y, l.y);
                *reinterpret_cast<uint2*>(sh + s * kLDP + p) = h;
                *reinterpret_cast<uint2*>(sl + s * kLDP + p) = l;
            }
        } else {
#pragma unroll
            for (int it = 0; it < IT; ++it) {
                const int i = tid + it * kThreads;
                const int s = i / Q, p = (i % Q) * 4;
                const bool ok = p_base + p < P;
                cp_async8(sh + s * kLDP + p, ok ? gx + s * tok + p : gx, ok);
            }
        }
    } else {
        for (int i = tid; i < L * kPT; i += kThreads) {
            const int s = i / kPT, p = i % kPT;
            const float v = p_base + p < P ? __bfloat162float(gx[s * tok + p])
                                           : 0.0f;
            if (SPLIT) {
                const float u = v * scale[s];
                const bf16 h = __float2bfloat16_rn(u);
                sh[s * kLDP + p] = h;
                sl[s * kLDP + p] = __float2bfloat16_rn(u - __bfloat162float(h));
            } else {
                sh[s * kLDP + p] = __float2bfloat16_rn(v);
            }
        }
    }
}

// (2) each chunk's own state, per (chunk, head, batch row, column tile):
// S_c = sum_s B_s (x) w_s x_s, w_s = exp(total - cum[s]) dt_s: B^T (exact
// bf16, from B's natural rows through ldmatrix.trans) times w x split into
// bf16 hi + lo (two MMAs); S_c into states (B, nc, H, N, P) and total into
// tot (B, H, nc).
template <int L>
__global__ void __launch_bounds__(kThreads)
ssd_scan_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      float* __restrict__ states, float* __restrict__ tot,
                      int S, int H, int P, int N) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int NP = pad16(N), LDN = ld_of(N);
    bf16* sB = reinterpret_cast<bf16*>(smem);      // (L, LDN): s, n
    bf16* sXh = sB + L * LDN;                      // (L, kLDP): s, p
    bf16* sXl = sXh + L * kLDP;
    float* sCum = reinterpret_cast<float*>(sXl + L * kLDP);
    float* sDt = sCum + L;
    float* sW = sDt + L;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nc = S / L, n_pt = (P + kPT - 1) / kPT;
    const int c = blockIdx.x / n_pt, p_base = (blockIdx.x % n_pt) * kPT;
    const int h = blockIdx.y;
    const long long b = blockIdx.z;
    const long long t0 = b * S + (long long)c * L;
    const long long tok = (long long)H * P;
    load_rows<L>(sB, LDN, Bm + t0 * N, N, tid);
    chunk_cum<L>(dt + t0 * H + h, H, A[h], sCum, sDt, tid);
    const float total = sCum[L - 1];
    for (int s = tid; s < L; s += kThreads)
        sW[s] = expf(total - sCum[s]) * sDt[s];
    __syncthreads();
    load_x<L, true>(sXh, sXl, x + t0 * tok + (long long)h * P + p_base, tok,
                    P, p_base, sW, tid);
    cp_async_wait_all();                           // B's rows
    __syncthreads();
    if (warp * 16 < NP) {
        float acc[kPT / 8][4];
#pragma unroll
        for (int j = 0; j < kPT / 8; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
        for (int k0 = 0; k0 < L; k0 += 16) {
            uint32_t a[4];
            frag_a_t(a, sB, LDN, warp * 16, k0, lane);
#pragma unroll
            for (int j = 0; j < kPT / 16; ++j) {
                uint32_t bh[4], bl[4];
                frag_b2_t(bh, sXh, kLDP, j * 16, k0, lane);
                frag_b2_t(bl, sXl, kLDP, j * 16, k0, lane);
                mma_bf16(acc[2 * j], a, bh[0], bh[1]);
                mma_bf16(acc[2 * j], a, bl[0], bl[1]);
                mma_bf16(acc[2 * j + 1], a, bh[2], bh[3]);
                mma_bf16(acc[2 * j + 1], a, bl[2], bl[3]);
            }
        }
        // a pair of columns a store where P is even
        float* out = states + ((b * nc + c) * H + h) * (long long)N * P;
        const int n = warp * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < kPT / 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int nn = n + r * 8;
                const int p = p_base + j * 8 + 2 * (lane & 3);
                float* o = out + (long long)nn * P + p;
                if (nn >= N) continue;
                if ((P & 1) == 0) {
                    if (p < P)
                        *reinterpret_cast<float2*>(o) =
                            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
                } else {
                    if (p < P) o[0] = acc[j][2 * r];
                    if (p + 1 < P) o[1] = acc[j][2 * r + 1];
                }
            }
    }
    if (tid == 0 && p_base == 0) tot[(b * H + h) * nc + c] = total;
}

// (3) the hand-off, in chunk order, per (batch row, head) and pair of
// state elements (N P is even): states[c] becomes the state entering chunk
// c, h_c = exp(total_c) h_{c-1} + S_c from h0 (or zero); the last one is
// the final state.  U chunks' loads are in flight at a time.
__global__ void __launch_bounds__(kThreads)
ssd_scan_pass_kernel(float* __restrict__ states, const float* __restrict__ tot,
                     const float* __restrict__ h0, float* __restrict__ hf,
                     int nc, int H, int NPel) {
    constexpr int U = 8;
    const int e = 2 * (blockIdx.x * kThreads + threadIdx.x);
    if (e >= NPel) return;
    const int h = blockIdx.y;
    const long long b = blockIdx.z;
    const long long bh = (b * H + h) * NPel + e;
    float2 hcur = h0 != nullptr ? *reinterpret_cast<const float2*>(h0 + bh)
                                : make_float2(0.0f, 0.0f);
    const float* tt = tot + (b * H + h) * nc;
    const long long cstride = (long long)H * NPel;
    float* st = states + (b * nc * H + h) * (long long)NPel + e;
    for (int c0 = 0; c0 < nc; c0 += U) {
        float2 sv[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (c0 + u < nc)
                sv[u] = *reinterpret_cast<const float2*>(
                    st + (c0 + u) * cstride);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (c0 + u < nc) {
                *reinterpret_cast<float2*>(st + (c0 + u) * cstride) = hcur;
                const float decay = expf(tt[c0 + u]);
                hcur.x = fmaf(decay, hcur.x, sv[u].x);
                hcur.y = fmaf(decay, hcur.y, sv[u].y);
            }
        }
    }
    *reinterpret_cast<float2*>(hf + bh) = hcur;
}

// (4) y per (chunk, head, batch row, column tile): the chunk's own term
// M'.x, M'[t][s] = (t >= s) exp(cum[t] - cum[s]) (C.B^T)[t][s] dt[s] split
// into hi + lo as the A operand (built in registers from cb, the next
// block's values loaded ahead), plus exp(cum[t]) C_t.h with C's fragments
// read from device memory (each warp owns its rows of t) and h (the state
// entering the chunk) split into hi + lo, plus D x; rounded once to bf16.
// Warps: L / 16 blocks of t, each over kPT / (8 / (L / 16)) columns.
template <int L>
__global__ void __launch_bounds__(kThreads)
ssd_scan_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Cm,
                    const float* __restrict__ D, const float* __restrict__ cb,
                    const float* __restrict__ states, bf16* __restrict__ y,
                    int S, int H, int P, int N) {
    constexpr int TB = L / 16;                     // t blocks
    constexpr int WP = (kThreads / 32) / TB;       // column groups
    constexpr int CW = kPT / WP;                   // columns a warp
    constexpr int NT = CW / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    const int NP = pad16(N);
    bf16* sHh = reinterpret_cast<bf16*>(smem);     // (NP, kLDP): n, p
    bf16* sHl = sHh + NP * kLDP;
    bf16* sX = sHl + NP * kLDP;                    // (L, kLDP): s, p
    float* sCum = reinterpret_cast<float*>(sX + L * kLDP);
    float* sDt = sCum + L;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nc = S / L, n_pt = (P + kPT - 1) / kPT;
    const int c = blockIdx.x / n_pt, p_base = (blockIdx.x % n_pt) * kPT;
    const int h = blockIdx.y;
    const long long b = blockIdx.z;
    const long long t0 = b * S + (long long)c * L;
    const long long tok = (long long)H * P;
    const float* hin = states + ((b * nc + c) * H + h) * (long long)N * P;
    const long long xoff = t0 * tok + (long long)h * P + p_base;
    load_x<L, false>(sX, nullptr, x + xoff, tok, P, p_base, nullptr, tid);
    if ((P & 3) == 0) {
        // every load issued before the first store: 8 float4 a thread at
        // N = 128
        constexpr int Q = kPT / 4;
        constexpr int IT = 128 * Q / kThreads;
        float4 v[IT];
#pragma unroll
        for (int it = 0; it < IT; ++it) {
            const int i = tid + it * kThreads;
            const int n = i / Q, p = (i % Q) * 4;
            v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (n < N && p_base + p < P)
                v[it] = *reinterpret_cast<const float4*>(
                    hin + (long long)n * P + p_base + p);
        }
#pragma unroll
        for (int it = 0; it < IT; ++it) {
            const int i = tid + it * kThreads;
            const int n = i / Q, p = (i % Q) * 4;
            if (n >= NP) break;
            uint2 hh, hl;
            split_pair(v[it].x, v[it].y, hh.x, hl.x);
            split_pair(v[it].z, v[it].w, hh.y, hl.y);
            *reinterpret_cast<uint2*>(sHh + n * kLDP + p) = hh;
            *reinterpret_cast<uint2*>(sHl + n * kLDP + p) = hl;
        }
    } else {
        for (int i = tid; i < NP * kPT; i += kThreads) {
            const int n = i / kPT, p = i % kPT;
            const float v = n < N && p_base + p < P
                                ? hin[(long long)n * P + p_base + p] : 0.0f;
            const bf16 hv = __float2bfloat16_rn(v);
            sHh[n * kLDP + p] = hv;
            sHl[n * kLDP + p] = __float2bfloat16_rn(v - __bfloat162float(hv));
        }
    }
    cp_async_wait_all();                           // x's tile
    chunk_cum<L>(dt + t0 * H + h, H, A[h], sCum, sDt, tid);

    const int tb = warp % TB, col0 = (warp / TB) * CW;
    const int g = lane >> 2, q = lane & 3;
    float yd[NT][4], yo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[j][e] = yo[j][e] = 0.0f;
    // the chunk's own term, over the s blocks up to the diagonal; each
    // thread's 4 C.B^T pairs of the next block are loaded ahead
    const float* cbc = cb + (b * nc + c) * (long long)L * L;
    const int ta = tb * 16 + g, tb8 = ta + 8;
    const float* row_a = cbc + ta * L + 2 * q;
    const float* row_b = cbc + tb8 * L + 2 * q;
    float2 nxt[4] = {*reinterpret_cast<const float2*>(row_a),
                     *reinterpret_cast<const float2*>(row_b),
                     *reinterpret_cast<const float2*>(row_a + 8),
                     *reinterpret_cast<const float2*>(row_b + 8)};
    for (int kb = 0; kb <= tb; ++kb) {
        const float2 cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
        if (kb < tb) {
            const int o = (kb + 1) * 16;
            nxt[0] = *reinterpret_cast<const float2*>(row_a + o);
            nxt[1] = *reinterpret_cast<const float2*>(row_b + o);
            nxt[2] = *reinterpret_cast<const float2*>(row_a + o + 8);
            nxt[3] = *reinterpret_cast<const float2*>(row_b + o + 8);
        }
        // A fragment order: (ta, s..s+1), (tb8, s..), (ta, s+8..), (tb8,
        // s+8..)
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int t = i & 1 ? tb8 : ta;
            const int s = kb * 16 + (i >> 1) * 8 + 2 * q;
            const float m0 = t >= s
                ? expf(sCum[t] - sCum[s]) * cur[i].x * sDt[s] : 0.0f;
            const float m1 = t >= s + 1
                ? expf(sCum[t] - sCum[s + 1]) * cur[i].y * sDt[s + 1] : 0.0f;
            split_pair(m0, m1, ah[i], al[i]);
        }
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
            uint32_t bx[4];
            frag_b2_t(bx, sX, kLDP, col0 + j * 16, kb * 16, lane);
            mma_bf16(yd[2 * j], ah, bx[0], bx[1]);
            mma_bf16(yd[2 * j], al, bx[0], bx[1]);
            mma_bf16(yd[2 * j + 1], ah, bx[2], bx[3]);
            mma_bf16(yd[2 * j + 1], al, bx[2], bx[3]);
        }
    }
    // the state carried in: C.h, C's rows of this warp straight from
    // device memory, KG k-steps' fragments loaded at a time
    constexpr int KG = 4;
    const bf16* gC = Cm + t0 * N;
    for (int kg = 0; kg < NP; kg += 16 * KG) {
        uint32_t a[KG][4];
#pragma unroll
        for (int u = 0; u < KG; ++u) {
            const int k0 = kg + 16 * u;
            if (k0 + 16 <= N) {
                frag_a(a[u], gC, N, tb * 16, k0, lane);
            } else {                               // the zero-padded edge
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int t = tb * 16 + g + (i & 1) * 8;
                    const int kk = k0 + 2 * q + (i >> 1) * 8;
                    a[u][i] = kk < N ? *reinterpret_cast<const uint32_t*>(
                                           gC + (long long)t * N + kk)
                                     : 0u;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < KG; ++u) {
            const int k0 = kg + 16 * u;
            if (k0 >= NP) break;
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
                uint32_t bh[4], bl[4];
                frag_b2_t(bh, sHh, kLDP, col0 + j * 16, k0, lane);
                frag_b2_t(bl, sHl, kLDP, col0 + j * 16, k0, lane);
                mma_bf16(yo[2 * j], a[u], bh[0], bh[1]);
                mma_bf16(yo[2 * j], a[u], bl[0], bl[1]);
                mma_bf16(yo[2 * j + 1], a[u], bh[2], bh[3]);
                mma_bf16(yo[2 * j + 1], a[u], bl[2], bl[3]);
            }
        }
    }
    // y = own + exp(cum) carried + D x, a pair of columns a store where P
    // is even
    const float d = D[h];
    const float ea = expf(sCum[ta]), eb = expf(sCum[tb8]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int t = r ? tb8 : ta;
            const float et = r ? eb : ea;
            const int p = col0 + j * 8 + 2 * q;
            const long long at = xoff + t * tok + p;
            const float v0 = yd[j][2 * r] + yo[j][2 * r] * et;
            const float v1 = yd[j][2 * r + 1] + yo[j][2 * r + 1] * et;
            if ((P & 1) == 0) {
                if (p_base + p < P) {
                    const uint32_t xv =
                        *reinterpret_cast<const uint32_t*>(x + at);
                    *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(
                        v0 + d * lo_f(xv), v1 + d * hi_f(xv));
                }
            } else {
                if (p_base + p < P)
                    y[at] = __float2bfloat16_rn(
                        v0 + d * __bfloat162float(x[at]));
                if (p_base + p + 1 < P)
                    y[at + 1] = __float2bfloat16_rn(
                        v1 + d * __bfloat162float(x[at + 1]));
            }
        }
}

// dynamic shared memory (bytes) of the tensor-core path's kernels
long long tc_smem_cb(int N, int L) { return 4LL * L * ld_of(N); }
long long tc_smem_state(int N, int L) {
    return 2LL * L * (ld_of(N) + 2 * kLDP) + 12LL * L;
}
long long tc_smem_out(int N, int L) {
    return 2LL * kLDP * (2 * pad16(N) + L) + 8LL * L;
}

template <typename K>
cudaError_t set_smem(K kernel, long long bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The tensor-core kernels' shared-memory limits, at the widest N: set once
// a chunk and device, not on every call (each attribute call costs host
// time on a path called once a layer and prefill).  A race sets them twice,
// which is harmless.
constexpr int kMaxDevices = 64;

template <int L>
cudaError_t set_tc_smem() {
    static bool done[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && done[dev]) return cudaSuccess;
    if ((err = set_smem(ssd_scan_cb_kernel<L>, tc_smem_cb(128, L))) !=
            cudaSuccess ||
        (err = set_smem(ssd_scan_state_kernel<L>, tc_smem_state(128, L))) !=
            cudaSuccess ||
        (err = set_smem(ssd_scan_out_kernel<L>, tc_smem_out(128, L))) !=
            cudaSuccess)
        return err;
    if (dev < kMaxDevices) done[dev] = true;
    return cudaSuccess;
}

template <int L>
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* D,
                      const void* h0, void* y, void* hf, void* cb,
                      void* states, void* tot, int Bb, int S, int H, int P,
                      int N, cudaStream_t stream) {
    const int nc = S / L, n_pt = (P + kPT - 1) / kPT;
    const long long s_cb = tc_smem_cb(N, L), s_st = tc_smem_state(N, L),
                    s_out = tc_smem_out(N, L);
    cudaError_t err = set_tc_smem<L>();
    if (err != cudaSuccess) return err;
    ssd_scan_cb_kernel<L><<<dim3(nc, Bb), kThreads, s_cb, stream>>>(
        (const bf16*)Bm, (const bf16*)Cm, (float*)cb, S, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 grid((unsigned)(nc * n_pt), (unsigned)H, (unsigned)Bb);
    ssd_scan_state_kernel<L><<<grid, kThreads, s_st, stream>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
        (float*)states, (float*)tot, S, H, P, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int NPel = N * P;
    ssd_scan_pass_kernel<<<dim3((NPel / 2 + kThreads - 1) / kThreads, H, Bb),
                           kThreads, 0, stream>>>(
        (float*)states, (const float*)tot, (const float*)h0, (float*)hf, nc,
        H, NPel);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_scan_out_kernel<L><<<grid, kThreads, s_out, stream>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Cm,
        (const float*)D, (const float*)cb, (const float*)states, (bf16*)y, S,
        H, P, N);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the f32 kernel needs (elem:
// bytes of x's dtype).
long long ssd_scan_smem_bytes(int N, int L, int PT, int elem) {
    return smem_bytes(N, L, PT, elem);
}

// The f32 CUDA-core kernel: x, B, C, y float32, like dt, A, D, h0 and the
// final state.  Every array is contiguous; h0 may be null (a zero state).
// S is a multiple of L (32, 64 or 128), N a multiple of 4 no larger than
// 128, PT 16 or 32.  Returns the CUDA error code of the attribute call or of
// the launch (0 = launched); an unknown chunk or tile returns
// cudaErrorInvalidValue.
int ssd_scan_forward(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* D,
                     const void* h0, void* y, void* hf, int Bb, int S, int H,
                     int P, int N, int L, int PT, void* stream) {
    return (int)launch_l<float>(L, PT, x, dt, A, Bm, Cm, D, h0, y, hf, Bb, S,
                                H, P, N, (cudaStream_t)stream);
}

// The bf16 tensor-core path: x, B, C, y bfloat16; dt, A, D, h0 and the
// final state float32; scratch cb (B, S / L, L, L), states (B, S / L, H, N,
// P) and tot (B, H, S / L), float32, allocated by the caller.  Contiguous
// arrays, h0 null or given; S a multiple of L (32, 64 or 128), 1 <= N <=
// 128.  Four launches on the stream; returns the first CUDA error (0 = all
// launched); an unknown chunk returns cudaErrorInvalidValue.
int ssd_scan_tc_forward(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* h0, void* y, void* hf, void* cb,
                        void* states, void* tot, int Bb, int S, int H, int P,
                        int N, int L, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    if (L == 128)
        err = launch_tc<128>(x, dt, A, Bm, Cm, D, h0, y, hf, cb, states, tot,
                             Bb, S, H, P, N, s);
    else if (L == 64)
        err = launch_tc<64>(x, dt, A, Bm, Cm, D, h0, y, hf, cb, states, tot,
                            Bb, S, H, P, N, s);
    else if (L == 32)
        err = launch_tc<32>(x, dt, A, Bm, Cm, D, h0, y, hf, cb, states, tot,
                            Bb, S, H, P, N, s);
    return (int)err;
}

const char* ssd_scan_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
