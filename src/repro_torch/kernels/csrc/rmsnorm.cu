// RMSNorm over rows, one CUDA kernel for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rmsnorm.py (rmsnorm,
// _kernel): x (R, D), w (D,) -> x * rsqrt(mean(x^2) + eps) * w, computed in
// float32 throughout and rounded once, to x's dtype, at the end.  x is
// float32 or bfloat16, w float32 or bfloat16, independently (the decoder
// keeps bf16 weights under a bf16 or f32 residual stream).
//
// What bounds it on an H100: bytes.  A row is read twice by the CTA (the
// sum of squares, then the scaled write; the second read hits L1) and
// written once, 3 flops an element: at the decoder's shapes (R = 16 slots
// or a prompt's length, D = 2560, bf16) the work is 2 * R * D * 2 B of
// traffic over 3.35 TB/s -- 49 ns at R=16, where one launch costs more,
// and 19 us at R=6144.
// What the design does about it: one CTA of 256 threads a row, each thread
// striding over the row (neighbouring threads on neighbouring elements),
// the sum of squares reduced with warp shuffles and one shared-memory
// round, then each thread scales and writes the elements it read.  Nothing
// but the row's sum leaves registers.  Rows are independent, so R CTAs
// fill the card at prefill lengths; at decode (R = 16) the kernel is
// launch-bound and this design does not try to do better.
//
// Numerics: the sum of squares in float32 with fmaf, in another order than
// the plain version's mean (rounding level); the inverse is 1 / sqrtf(.)
// (correctly rounded, no rsqrtf approximation); the output is
// (x * inv) * w in float32, rounded once with round-to-nearest-even.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int D, long long x_stride,
               long long o_stride, float eps) {
    __shared__ float red[kThreads / 32];
    const TX* xr = x + (long long)blockIdx.x * x_stride;
    TX* orow = out + (long long)blockIdx.x * o_stride;
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
        float t = lane < kThreads / 32 ? red[lane] : 0.0f;
        t = warp_sum(t);
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    const float inv = 1.0f / sqrtf(red[0] / (float)D + eps);
    for (int d = threadIdx.x; d < D; d += kThreads)
        orow[d] = from_f<TX>(to_f(xr[d]) * inv * to_f(w[d]));
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int R, int D,
                   long long x_stride, long long o_stride, float eps,
                   cudaStream_t stream) {
    rmsnorm_kernel<TX, TW><<<(unsigned)R, kThreads, 0, stream>>>(
        (const TX*)x, (const TW*)w, (TX*)out, D, x_stride, o_stride, eps);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  x and out are (R, D) with row
// strides x_stride and o_stride (elements), unit stride along D; w (D,) is
// contiguous.  Returns the CUDA error code of the launch (0 = launched);
// an unknown dtype code returns cudaErrorInvalidValue.
int rmsnorm_forward(const void* x, const void* w, void* out, int R, int D,
                    long long x_stride, long long o_stride, float eps,
                    int x_dtype, int w_dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    if (x_dtype == 0 && w_dtype == 0)
        err = launch<float, float>(x, w, out, R, D, x_stride, o_stride, eps, s);
    else if (x_dtype == 0 && w_dtype == 1)
        err = launch<float, __nv_bfloat16>(x, w, out, R, D, x_stride,
                                           o_stride, eps, s);
    else if (x_dtype == 1 && w_dtype == 0)
        err = launch<__nv_bfloat16, float>(x, w, out, R, D, x_stride,
                                           o_stride, eps, s);
    else if (x_dtype == 1 && w_dtype == 1)
        err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, x_stride,
                                                   o_stride, eps, s);
    return (int)err;
}

const char* rmsnorm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
