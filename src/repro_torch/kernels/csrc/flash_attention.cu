// Online-softmax (flash) attention with GQA, causal / sliding-window /
// kv_valid masks and logit soft-cap, one CUDA kernel for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention, _kernel): q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D) ->
// o (B, Hq, Sq, D), query head h reading kv head h / G (G = Hq / Hkv).
// Query i sits at position q_offset + i, key j at j; key j is visible to
// query i when j < Skv, j < kv_valid (if set), j <= q_pos (causal) and
// q_pos - j < window (if set).  s = (q . k) * scale, then
// cap * tanh(s / cap) (if set); softmax over the visible keys; a query with
// no visible key gives 0.  Inputs are float32 or bfloat16 (one dtype for
// q, k, v and o); sums run in float32 and p is rounded to v's dtype before
// P.V, as the Pallas kernel's p.astype(v.dtype) does.  q, k, v and o are
// strided views (any strides over B, H and S, unit stride over D), so the
// decoder passes its (B, S, H, D) projections as (B, H, S, D) views
// without copying them.  Any Sq and Skv (the ragged last block is masked),
// D up to 256.
//
// What bounds it on an H100: operations.  At the prefill's shapes (B=1,
// Hq=32, Hkv=8, D=80, window 4096, Sq up to 6144) the visible q-k pairs
// need 4 * Hq * D flops each (q.k and p.v), hundreds of flops a byte --
// far above the bf16 tensor core's ridge.
// What the design does about it (simply): one CTA of 256 threads a
// (b, h, block of 64 queries); the Q tile and, per step, a 64-key K and V
// tile sit in dynamic shared memory as float32 (213,760 B at D=256, so the
// attribute is set at every launch), and a 64 x 64 tile of p.  Thread
// (ty, tx) owns a 4 x 4 block of scores (rows 4ty.., columns tx + 16j),
// 16 FMAs for 8 shared loads a step of the dot product; the rows' max and
// sum are reduced over the 16 threads of a half-warp with shuffles; for
// P.V the thread owns rows 4ty.. and columns tx + 16c of the output in
// registers.  Key blocks wholly outside [q_first - window + 1, q_last] or
// past kv_valid are never loaded (the Pallas kernel's block skipping).
// Row strides in shared memory are odd, so the column-strided reads hit 16
// distinct banks.  CUDA cores only: no tensor cores, no TMA, no pipelining
// of the tile loads -- that is later work (ROADMAP).
//
// Numerics: expf/tanhf (no fast-math); masked scores are -inf and give
// p = 0; l sums the unrounded p, the P.V product uses p rounded to v's
// dtype; the output is acc / l rounded once to the output dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kPStride = kBK + 1;
constexpr unsigned kFull = 0xffffffffu;

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
// x rounded to T and back: p.astype(v.dtype) before the P.V product
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

__host__ __device__ __forceinline__ int odd_stride(int D) {
    return (D % 2 == 0) ? D + 1 : D;
}

__host__ __device__ __forceinline__ long long smem_floats(int D) {
    const int ld = odd_stride(D);
    return (long long)kBQ * ld + (long long)kBK * ld + (long long)kBK * D
           + (long long)kBQ * kPStride;
}

struct Strides {
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// NC: 16-column chunks of the head dimension a thread owns (D <= 16 * NC)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int G,
                       int Sq, int Skv, int D, Strides st, int causal,
                       int window, float cap, int q_offset, int kv_valid,
                       float scale) {
    extern __shared__ float smem[];
    const int ld = odd_stride(D);
    float* sQ = smem;
    float* sK = sQ + kBQ * ld;
    float* sV = sK + kBK * ld;
    float* sP = sV + kBK * D;

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
    const int q0 = blockIdx.x * kBQ;
    const int nq = min(kBQ, Sq - q0);
    const T* qp = q + b * st.qb + h * st.qh + (long long)q0 * st.qs;
    const T* kp = k + b * st.kb + hk * st.kh;
    const T* vp = v + b * st.vb + hk * st.vh;

    for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        sQ[r * ld + d] = r < nq ? to_f(qp[r * st.qs + d]) : 0.0f;
    }

    // keys any query of this block can see: [k_lo, k_hi)
    const int qpos0 = q_offset + q0;
    const int kv_lim = kv_valid >= 0 ? min(Skv, kv_valid) : Skv;
    int k_hi = kv_lim;
    if (causal) k_hi = min(k_hi, qpos0 + nq);
    const int k_lo = window > 0 ? max(0, qpos0 - window + 1) : 0;

    int qpos[4];
    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        qpos[i] = qpos0 + ty * 4 + i;
        m[i] = -INFINITY;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
    }

    for (int kb = (k_lo / kBK) * kBK; kb < k_hi; kb += kBK) {
        const int nk = min(kBK, Skv - kb);
        __syncthreads();                 // last step's tiles are consumed
        for (int i = tid; i < kBK * D; i += kThreads) {
            const int r = i / D, d = i - r * D;
            const bool ok = r < nk;
            sK[r * ld + d] = ok ? to_f(kp[(long long)(kb + r) * st.ks + d])
                                : 0.0f;
            sV[r * D + d] = ok ? to_f(vp[(long long)(kb + r) * st.vs + d])
                               : 0.0f;
        }
        __syncthreads();                 // Q, K, V tiles in place

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        for (int d = 0; d < D; ++d) {
            float a[4], bk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * ld + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float rmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = kb + tx + 16 * j;
                bool ok = kpos < kv_lim;
                if (causal) ok = ok && kpos <= qpos[i];
                if (window > 0) ok = ok && qpos[i] - kpos < window;
                float x = s[i][j] * scale;
                if (cap > 0.0f) x = cap * tanhf(x / cap);
                s[i][j] = ok ? x : -INFINITY;
                rmax = fmaxf(rmax, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, off));
            const float mnew = fmaxf(m[i], rmax);
            const bool none = mnew == -INFINITY;   // no visible key yet
            const float alpha = none ? 1.0f : expf(m[i] - mnew);
            float psum = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = (none || s[i][j] == -INFINITY)
                                    ? 0.0f : expf(s[i][j] - mnew);
                psum += p;
                sP[(ty * 4 + i) * kPStride + tx + 16 * j] = round_to<T>(p);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                psum += __shfl_xor_sync(kFull, psum, off);
            l[i] = l[i] * alpha + psum;
            m[i] = mnew;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();                 // the p tile in place

        for (int kk = 0; kk < nk; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * kPStride + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const int d = tx + 16 * c;
                if (d < D) {
                    const float vv = sV[kk * D + d];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][c] = fmaf(p[i], vv, acc[i][c]);
                }
            }
        }
    }

    T* op = o + b * st.ob + h * st.oh + (long long)q0 * st.os;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nq) continue;
        const float inv_l = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int d = tx + 16 * c;
            if (d < D)
                op[r * st.os + d] = from_f<T>(l[i] > 0.0f ? acc[i][c] * inv_l
                                                          : 0.0f);
        }
    }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int G, int Sq, int Skv, int D,
                   const Strides& st, int causal, int window, float cap,
                   int q_offset, int kv_valid, float scale,
                   cudaStream_t stream) {
    const long long smem = 4 * smem_floats(D);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq,
                    (unsigned)B);
    flash_attention_kernel<T, NC><<<grid, kThreads, (size_t)smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, G, Sq, Skv, D, st,
        causal, window, cap, q_offset, kv_valid, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int G, int Sq, int Skv, int D,
                     const Strides& st, int causal, int window, float cap,
                     int q_offset, int kv_valid, float scale,
                     cudaStream_t s) {
    const int nc = (D + 15) / 16;
#define FA_LAUNCH(N)                                                      \
    return launch<T, N>(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,     \
                        window, cap, q_offset, kv_valid, scale, s)
    if (nc <= 1) FA_LAUNCH(1);
    if (nc <= 2) FA_LAUNCH(2);
    if (nc <= 4) FA_LAUNCH(4);
    if (nc <= 8) FA_LAUNCH(8);
    if (nc <= 16) FA_LAUNCH(16);
#undef FA_LAUNCH
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs at head dimension D.
long long flash_attention_smem_bytes(int D) { return 4 * smem_floats(D); }

// strides: 12 element strides, (B, H, S) for q, k, v and o in that order;
// D has unit stride.  dtype: 0 = float32, 1 = bfloat16.  window <= 0 means
// none, cap <= 0 none, kv_valid < 0 none; causal is 0 or 1.  Returns the
// CUDA error code of the attribute call or of the launch (0 = launched);
// D > 256 or an unknown dtype returns cudaErrorInvalidValue.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                            int D, const long long* strides, int causal,
                            int window, float cap, int q_offset, int kv_valid,
                            float scale, int dtype, void* stream) {
    Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11]};
    const int G = Hq / Hkv;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == 0)
        err = dispatch<float>(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,
                              window, cap, q_offset, kv_valid, scale, s);
    else if (dtype == 1)
        err = dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, G, Sq, Skv, D, st,
                                      causal, window, cap, q_offset,
                                      kv_valid, scale, s);
    return (int)err;
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
