// RMSNorm over rows for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rmsnorm.py (rmsnorm,
// _kernel): x (R, D), w (D,) -> x * rsqrt(mean(x^2) + eps) * w, computed in
// float32 throughout and rounded once, to x's dtype, at the end.  x is
// float32 or bfloat16, w float32 or bfloat16, independently (the decoder
// keeps bf16 weights under a bf16 or f32 residual stream).
//
// What bounds it on an H100: bytes, and at decode the launch.  x is read
// once and written once, 4 flops an element: at the decoder's shapes (D =
// 2560, bf16) that is 2 * R * D * 2 B over 3.35 TB/s, 49 ns at R = 16
// slots, far below one launch, and 19 us at R = 6144 (a long prompt).  So
// the call's host path (the wrapper: checks, the output, the stream, the
// ctypes call) sets its time at decode, and the kernel's bandwidth at
// prefill.
//
// What the design does about it.  rmsnorm_vector_kernel: one warp a row
// (wpr = 2 or 4 warps for rows wider than 2560), 4 warps a CTA, so a CTA
// holds 4 / wpr rows and R = 6144 gives 1,536 CTAs; each lane loads 16-byte
// vectors of 8 elements through the read-only path, neighbouring lanes on
// neighbouring vectors, up to 10 of them, and keeps them in registers (80
// bf16 values a lane at D = 2560) between the sum of squares and the
// scaled write, so the row is read from device memory once; a bf16 w is
// read as vectors with it.  A warp that holds its row reduces with
// shuffles alone: no shared memory, no __syncthreads; wider rows add one
// shared-memory round.  The wrapper takes it where every load is 16-byte
// aligned (x's and w's base, x's row stride) and D is a multiple of 8, up
// to D = 10240; rmsnorm_general_kernel (one CTA of 256 threads a row,
// scalar loads strided over the row, read twice) takes every other shape.
// The wrapper, not a failure, picks the kernel.
//
// Numerics, both kernels: the sum of squares in float32 with fmaf, in
// another order than the plain version's mean (rounding level); the inverse
// is 1 / sqrtf(.) (correctly rounded, no rsqrtf approximation); the output
// is (x * inv) * w in float32, rounded once with round-to-nearest-even.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the general kernel's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kVecWarps = 4;       // the vector kernel's CTA: 4 warps
constexpr int kVec = 8;            // elements a vector
constexpr int kMaxVec = 10;        // vectors a lane keeps

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// 8 elements at a 16-byte aligned address, read through the read-only
// path: one 16-byte load for bf16, two for f32.  bf16 -> f32 is a shift of
// the bits (exact); no local array has its address taken, so the row stays
// in registers.
__device__ __forceinline__ uint4 ldg16(const void* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void unpack2(uint32_t u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
           | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <typename T> struct Vec8;
template <> struct Vec8<bf16> {
    uint4 r;
    __device__ __forceinline__ void load(const bf16* p) { r = ldg16(p); }
    __device__ __forceinline__ void get(float (&f)[kVec]) const {
        unpack2(r.x, f[0], f[1]);
        unpack2(r.y, f[2], f[3]);
        unpack2(r.z, f[4], f[5]);
        unpack2(r.w, f[6], f[7]);
    }
    __device__ __forceinline__ static void store(bf16* p,
                                                 const float (&f)[kVec]) {
        *reinterpret_cast<uint4*>(p) =
            make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                       pack2(f[4], f[5]), pack2(f[6], f[7]));
    }
};
template <> struct Vec8<float> {
    uint4 a, b;
    __device__ __forceinline__ void load(const float* p) {
        a = ldg16(p);
        b = ldg16(p + 4);
    }
    __device__ __forceinline__ void get(float (&f)[kVec]) const {
        f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
        f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
        f[4] = __uint_as_float(b.x); f[5] = __uint_as_float(b.y);
        f[6] = __uint_as_float(b.z); f[7] = __uint_as_float(b.w);
    }
    __device__ __forceinline__ static void store(float* p,
                                                 const float (&f)[kVec]) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(f[4], f[5], f[6], f[7]);
    }
};

// wpr warps a row, kVecWarps / wpr rows a CTA; lane l of the row's warp
// part holds vectors (i * wpr + part) * 32 + l, i < kMaxVec.  A bf16 w is
// loaded with the row, so the write needs no load; an f32 w (twice the
// registers) is loaded at the write.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kVecWarps * 32)
rmsnorm_vector_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      TX* __restrict__ out, int R, int D, long long x_stride,
                      float eps, int wpr) {
    constexpr bool kWEarly = sizeof(TW) == 2;
    __shared__ float red[kVecWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row = blockIdx.x * (kVecWarps / wpr) + warp / wpr;
    const int part = warp % wpr;
    const int nvec = D / kVec;
    const bool live = row < R;
    const TX* xr = x + (long long)row * x_stride;
    TX* orow = out + (long long)row * D;

    Vec8<TX> v[kMaxVec];
    Vec8<TW> wv[kWEarly ? kMaxVec : 1];
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
        const int vi = (i * wpr + part) * 32 + lane;
        if (live && vi < nvec) {
            v[i].load(xr + vi * kVec);
            if (kWEarly) wv[kWEarly ? i : 0].load(w + vi * kVec);
        }
    }
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
        const int vi = (i * wpr + part) * 32 + lane;
        if (live && vi < nvec) {
            float f[kVec];
            v[i].get(f);
            float vs = 0.0f;
#pragma unroll
            for (int k = 0; k < kVec; ++k) vs = fmaf(f[k], f[k], vs);
            ss += vs;
        }
    }
    ss = warp_sum(ss);
    if (wpr > 1) {                      // uniform over the CTA
        if (lane == 0) red[warp] = ss;
        __syncthreads();
        ss = 0.0f;
        for (int j = 0; j < wpr; ++j) ss += red[warp - part + j];
    }
    const float inv = 1.0f / sqrtf(ss / (float)D + eps);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
        const int vi = (i * wpr + part) * 32 + lane;
        if (live && vi < nvec) {
            float f[kVec], g[kVec];
            v[i].get(f);
            if (kWEarly) {
                wv[kWEarly ? i : 0].get(g);
            } else {
                Vec8<TW> wl;
                wl.load(w + vi * kVec);
                wl.get(g);
            }
#pragma unroll
            for (int k = 0; k < kVec; ++k) f[k] = f[k] * inv * g[k];
            Vec8<TX>::store(orow + vi * kVec, f);
        }
    }
}

// one CTA of 256 threads a row, scalar loads: any D, any row stride
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_general_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       TX* __restrict__ out, int D, long long x_stride,
                       float eps) {
    __shared__ float red[kWarps];
    const TX* xr = x + (long long)blockIdx.x * x_stride;
    TX* orow = out + (long long)blockIdx.x * D;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    float ss = 0.0f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
        const float v = to_f(xr[d]);
        ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (warp == 0) {
        float t = lane < kWarps ? red[lane] : 0.0f;
        t = warp_sum(t);
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    const float inv = 1.0f / sqrtf(red[0] / (float)D + eps);
    for (int d = threadIdx.x; d < D; d += kThreads)
        orow[d] = from_f<TX>(to_f(xr[d]) * inv * to_f(w[d]));
}

// warps a row for the vector kernel: the fewest (1, 2 or 4) whose lanes
// keep at most kMaxVec vectors each; 0 where D is too wide
int warps_per_row(int D) {
    const int nvec = D / kVec;
    for (int wpr = 1; wpr <= kVecWarps; wpr *= 2)
        if (nvec <= kMaxVec * 32 * wpr) return wpr;
    return 0;
}

template <typename TX, typename TW>
cudaError_t launch(bool vector, const void* x, const void* w, void* out,
                   int R, int D, long long x_stride, float eps,
                   cudaStream_t stream) {
    if (vector) {
        const int wpr = warps_per_row(D);
        if (wpr == 0 || D % kVec) return cudaErrorInvalidValue;
        const int rows = kVecWarps / wpr;
        rmsnorm_vector_kernel<TX, TW>
            <<<(unsigned)((R + rows - 1) / rows), kVecWarps * 32, 0,
               stream>>>(
                (const TX*)x, (const TW*)w, (TX*)out, R, D, x_stride, eps,
                wpr);
    } else {
        rmsnorm_general_kernel<TX, TW><<<(unsigned)R, kThreads, 0, stream>>>(
            (const TX*)x, (const TW*)w, (TX*)out, D, x_stride, eps);
    }
    return cudaGetLastError();
}

// dtype pair code: 2 * x's + w's, each 0 = float32, 1 = bfloat16
cudaError_t dispatch(bool vector, const void* x, const void* w, void* out,
                     int R, int D, long long x_stride, float eps, int code,
                     cudaStream_t s) {
    switch (code) {
    case 0: return launch<float, float>(vector, x, w, out, R, D, x_stride,
                                        eps, s);
    case 1: return launch<float, bf16>(vector, x, w, out, R, D, x_stride,
                                       eps, s);
    case 2: return launch<bf16, float>(vector, x, w, out, R, D, x_stride,
                                       eps, s);
    case 3: return launch<bf16, bf16>(vector, x, w, out, R, D, x_stride, eps,
                                      s);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (R, D) with row stride x_stride (elements) and unit stride along D; w
// (D,) contiguous; out (R, D) contiguous.  code = 2 * x's dtype + w's (0 =
// float32, 1 = bfloat16).  rmsnorm_vector needs 16-byte aligned x, w and
// out, x_stride times x's element size a multiple of 16 and D a multiple of
// 8 up to 10240; rmsnorm_general takes any shape.  Each returns the CUDA
// error code of its launch (0 = launched); an unknown code, or a D the
// vector kernel cannot hold, returns cudaErrorInvalidValue.
int rmsnorm_vector(const void* x, const void* w, void* out, int R, int D,
                   long long x_stride, float eps, int code, void* stream) {
    return (int)dispatch(true, x, w, out, R, D, x_stride, eps, code,
                         (cudaStream_t)stream);
}

int rmsnorm_general(const void* x, const void* w, void* out, int R, int D,
                    long long x_stride, float eps, int code, void* stream) {
    return (int)dispatch(false, x, w, out, R, D, x_stride, eps, code,
                         (cudaStream_t)stream);
}

const char* rmsnorm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
