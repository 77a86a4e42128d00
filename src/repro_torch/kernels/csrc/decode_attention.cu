// Single-query (flash-decode) attention against a KV cache, one CUDA kernel
// for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py
// (decode_attention, _kernel): q (B, Hq, D), k, v (B, Hkv, S, D), kv_valid
// (B,) int32 -> o (B, Hq, D).  Row b's query sits at position
// kv_valid[b] - 1 and sees cache rows j < min(kv_valid[b], S) with
// kv_valid[b] - 1 - j < window (if set); s = (q . k) * scale, then
// cap * tanh(s / cap) (if set); softmax over those rows; a row with no
// visible key gives 0.  q and o are float32 or bfloat16, k and v float32
// or bfloat16, independently (an f32 decoder reads its bf16 cache); sums
// run in float32 and p is rounded to v's dtype before P.V, as the Pallas
// kernel does.  k and v are strided views (any strides over B, H and S,
// unit stride over D): the decoder passes its per-layer cache slice, laid
// out (B, S, Hkv, D), as a (B, Hkv, S, D) view and the kernel reads it
// where it lies -- a transposed copy would move the whole cache every
// layer of every step.
//
// What bounds it on an H100: bytes.  Each visible cache row is read once
// (2 * D elements for k and v of one kv head), against 4 * G * D flops for
// its G query heads: at G = 4, D = 80 in bf16 that is 4 flops a byte.  At
// 16 slots, Hkv = 8, a 4096-row window, a full step reads up to 16 * 8 *
// 4096 * 320 B = 168 MB a layer, 50 us at 3.35 TB/s.
// What the design does about it: one CTA a (slot, kv head) serves all G of
// its query heads from one load of each K/V row: the CTA copies a chunk of
// 32 * R visible rows of k and v into shared memory (4-byte words,
// neighbouring threads on neighbouring words, odd row strides), and warp
// (g, r) takes query head g over every R-th 32-row part of the chunk: lane
// j scores row j, the warp's max and sum go through shuffles, and each lane
// then accumulates the columns lane + 32c of p.v from shared memory.  The
// R partial (m, l, acc) of a head are merged through shared memory at the
// end.  R = 8 / G warps a head (256 threads), fewer where shared memory
// runs short.  Only rows in [kv_valid - window, kv_valid) are loaded: the
// CTA skips the rest of the cache, which is the same function.  Splitting S
// across CTAs (more CTAs than slots x kv heads), cp.async / TMA
// double-buffering and tensor cores are later work (ROADMAP).
//
// Numerics: expf/tanhf (no fast-math); l sums the unrounded p, P.V uses p
// rounded to v's dtype; the R partials merge with exp(m_r - M) weights;
// the output is acc / l rounded once to q's dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

// q . k over one cache row held as 4-byte words in shared memory
__device__ __forceinline__ float row_dot(const uint32_t* kr, const float* q,
                                         int D, float /*tag*/) {
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(q[d], __uint_as_float(kr[d]), acc);
    return acc;
}
__device__ __forceinline__ float row_dot(const uint32_t* kr, const float* q,
                                         int D, __nv_bfloat16 /*tag*/) {
    float acc = 0.0f;
    for (int w = 0; w < D / 2; ++w) {
        const uint32_t word = kr[w];
        const float lo = __uint_as_float(word << 16);
        const float hi = __uint_as_float(word & 0xffff0000u);
        acc = fmaf(q[2 * w], lo, acc);
        acc = fmaf(q[2 * w + 1], hi, acc);
    }
    return acc;
}

// Words of one cache row (D * sizeof(TKV) / 4) and its odd shared stride.
template <typename TKV> __host__ __device__ __forceinline__ int row_words(int D) {
    return D * (int)sizeof(TKV) / 4;
}
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

template <typename TKV>
__host__ __device__ __forceinline__ long long smem_bytes(int G, int R, int D) {
    const long long chunk = 32LL * R;
    return 4LL * ((long long)G * D + 2 * chunk * odd(row_words<TKV>(D))
                  + (long long)G * R * (D + 2));
}

struct Strides {
    long long qb, qh, kb, kh, ks, vb, vh, vs;   // elements
};

// NC: 32-column slots of the head dimension a lane owns (D <= 32 * NC)
template <typename TQ, typename TKV, int NC>
__global__ void decode_attention_kernel(
        const TQ* __restrict__ q, const TKV* __restrict__ k,
        const TKV* __restrict__ v, const int* __restrict__ kv_valid,
        TQ* __restrict__ o, int G, int R, int S, int D, Strides st,
        int window, float cap, float scale) {
    extern __shared__ float smem[];
    const int chunk = 32 * R;
    const int rw = row_words<TKV>(D), ldw = odd(rw);
    float* sq = smem;
    uint32_t* sK = reinterpret_cast<uint32_t*>(sq + G * D);
    uint32_t* sV = sK + chunk * ldw;
    float* comb = reinterpret_cast<float*>(sV + chunk * ldw);

    const int hk = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = warp / R, r = warp - g * R;

    for (int i = tid; i < G * D; i += nthr) {
        const int gg = i / D, d = i - gg * D;
        sq[i] = to_f(q[b * st.qb + (long long)(hk * G + gg) * st.qh + d]);
    }
    const int valid = kv_valid[b];
    const int hi = min(valid, S);
    const int lo = window > 0 ? max(0, valid - window) : 0;
    // 4-byte words; the wrapper checks every stride and pointer allows it
    const int wsz = (int)sizeof(TKV);
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(
        k + b * st.kb + hk * st.kh);
    const uint32_t* vw = reinterpret_cast<const uint32_t*>(
        v + b * st.vb + hk * st.vh);
    const long long ksw = st.ks * wsz / 4, vsw = st.vs * wsz / 4;
    const float* qg = sq + g * D;

    float m = -INFINITY, l = 0.0f, acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

    for (int c0 = lo; c0 < hi; c0 += chunk) {
        const int nr = min(chunk, hi - c0);
        __syncthreads();                 // the last chunk is consumed
        for (int i = tid; i < nr * rw; i += nthr) {
            const int rr = i / rw, w = i - rr * rw;
            sK[rr * ldw + w] = kw[(long long)(c0 + rr) * ksw + w];
            sV[rr * ldw + w] = vw[(long long)(c0 + rr) * vsw + w];
        }
        __syncthreads();                 // the chunk (and q) in place

        for (int part = r; part * 32 < nr; part += R) {
            const int row = part * 32 + lane;
            const bool ok = row < nr;
            float s = -INFINITY;
            if (ok) {
                float x = row_dot(sK + row * ldw, qg, D, TKV()) * scale;
                if (cap > 0.0f) x = cap * tanhf(x / cap);
                s = x;
            }
            const float mnew = fmaxf(m, warp_max(s));   // lane 0's row is ok
            const float alpha = expf(m - mnew);
            const float p = ok ? expf(s - mnew) : 0.0f;
            l = l * alpha + warp_sum(p);
            m = mnew;
            const float pr = round_to<TKV>(p);
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[c] *= alpha;
            const int n_rows = min(32, nr - part * 32);
            for (int jj = 0; jj < n_rows; ++jj) {
                const float pj = __shfl_sync(kFull, pr, jj);
                const TKV* vr = reinterpret_cast<const TKV*>(
                    sV + (part * 32 + jj) * ldw);
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const int d = lane + 32 * c;
                    if (d < D) acc[c] = fmaf(pj, to_f(vr[d]), acc[c]);
                }
            }
        }
    }

    // merge the R partial softmaxes of head g
    float* mine = comb + (g * R + r) * (D + 2);
    if (lane == 0) {
        mine[0] = m;
        mine[1] = l;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) mine[2 + d] = acc[c];
    }
    __syncthreads();
    if (r != 0) return;
    float M = -INFINITY;
    for (int rr = 0; rr < R; ++rr) M = fmaxf(M, comb[(g * R + rr) * (D + 2)]);
    float L = 0.0f, out[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) out[c] = 0.0f;
    for (int rr = 0; rr < R; ++rr) {
        const float* part = comb + (g * R + rr) * (D + 2);
        const float f = part[0] == -INFINITY ? 0.0f : expf(part[0] - M);
        L += part[1] * f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int d = lane + 32 * c;
            if (d < D) out[c] = fmaf(part[2 + d], f, out[c]);
        }
    }
    TQ* orow = o + ((long long)b * Hkv * G + hk * G + g) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) orow[d] = from_f<TQ>(L > 0.0f ? out[c] / L : 0.0f);
    }
}

template <typename TQ, typename TKV, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_valid, void* o, int B, int Hkv, int G,
                   int R, int S, int D, const Strides& st, int window,
                   float cap, float scale, cudaStream_t stream) {
    const long long smem = smem_bytes<TKV>(G, R, D);
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<TQ, TKV, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    decode_attention_kernel<TQ, TKV, NC>
        <<<dim3((unsigned)Hkv, (unsigned)B), 32 * G * R, (size_t)smem,
           stream>>>((const TQ*)q, (const TKV*)k, (const TKV*)v, kv_valid,
                     (TQ*)o, G, R, S, D, st, window, cap, scale);
    return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kv_valid, void* o, int B, int Hkv, int G,
                     int R, int S, int D, const Strides& st, int window,
                     float cap, float scale, cudaStream_t s) {
    const int nc = (D + 31) / 32;
#define DA_LAUNCH(N)                                                        \
    return launch<TQ, TKV, N>(q, k, v, kv_valid, o, B, Hkv, G, R, S, D, st, \
                              window, cap, scale, s)
    if (nc <= 1) DA_LAUNCH(1);
    if (nc <= 2) DA_LAUNCH(2);
    if (nc <= 4) DA_LAUNCH(4);
    if (nc <= 8) DA_LAUNCH(8);
#undef DA_LAUNCH
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs: G query heads a kv head,
// R warps a head, head dimension D, kv dtype code (0 = float32,
// 1 = bfloat16).
long long decode_attention_smem_bytes(int G, int R, int D, int kv_dtype) {
    return kv_dtype == 0 ? smem_bytes<float>(G, R, D)
                         : smem_bytes<__nv_bfloat16>(G, R, D);
}

// strides: 8 element strides, q (B, H), k (B, H, S), v (B, H, S); D has
// unit stride; o is a contiguous (B, Hq, D).  kv_valid is (B,) int32 on the
// device.  Dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 means
// none, cap <= 0 none.  Returns the CUDA error code of the attribute call
// or of the launch (0 = launched); D > 256 or an unknown dtype returns
// cudaErrorInvalidValue.
int decode_attention_forward(const void* q, const void* k, const void* v,
                             const void* kv_valid, void* o, int B, int Hq,
                             int Hkv, int S, int D, const long long* strides,
                             int window, float cap, float scale, int R,
                             int q_dtype, int kv_dtype, void* stream) {
    Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7]};
    const int G = Hq / Hkv;
    const int* kvv = (const int*)kv_valid;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    if (q_dtype == 0 && kv_dtype == 0)
        err = dispatch<float, float>(q, k, v, kvv, o, B, Hkv, G, R, S, D, st,
                                     window, cap, scale, s);
    else if (q_dtype == 0 && kv_dtype == 1)
        err = dispatch<float, __nv_bfloat16>(q, k, v, kvv, o, B, Hkv, G, R, S,
                                             D, st, window, cap, scale, s);
    else if (q_dtype == 1 && kv_dtype == 0)
        err = dispatch<__nv_bfloat16, float>(q, k, v, kvv, o, B, Hkv, G, R, S,
                                             D, st, window, cap, scale, s);
    else if (q_dtype == 1 && kv_dtype == 1)
        err = dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, kvv, o, B, Hkv,
                                                     G, R, S, D, st, window,
                                                     cap, scale, s);
    return (int)err;
}

const char* decode_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
