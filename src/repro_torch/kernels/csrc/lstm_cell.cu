// One fused LSTM step, grouped, one CUDA kernel for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/lstm_cell.py
// (lstm_cell, _kernel): gates = x.Wx + h.Wh + b in the order i, f, g, o,
// then c' = sig(f) c + sig(i) tanh(g) and h' = sig(o) tanh(c').  The grouped
// form takes weights with a leading group axis G (or a group stride of 0
// when every group shares one set) and rows x (G, N, In), h and c (G, N, H).
// The Pallas function is G=1 with shared weights; the benchmark's legacy
// per-step lane (benchmarks/bench_control_plane.py, the vmap of the cell
// over Z targets) is one launch a step at G=Z, N=1.
//
// What bounds it on an H100: bytes.  On the lane each step reads every
// target's weights, (In + H + 1) * 4H floats = 44,800 B at In=5, H=50, for
// 2 * (In + H) * 4H = 22,000 operations: at Z=4096, 183.5 MB a step, 0.055
// ms at 3.35 TB/s, W times a forecast.  Re-reading them every step is what
// the whole-window kernel (lstm_seq.cu) removed; this lane keeps the cell
// to show that.
// What the design does about it: one CTA per (group, block of R rows)
// copies its group's weights once into shared memory, coalesced, so rows of
// one group share the read; thread (j, r) owns hidden unit j of row r and
// sums its four gate pre-activations at columns j, H+j, 2H+j, 3H+j in
// registers (neighbouring j read neighbouring shared-memory words, a row's
// threads read the same x and h word); the gate tensor never reaches device
// memory.  The simple form: no tensor cores, one group a CTA.
//
// Numerics: expf / tanhf (no fast-math); x.Wx then h.Wh then b, the order
// of the plain version and of lstm_seq.cu.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(1024)
lstm_cell_grouped_kernel(const float* __restrict__ Wx,
                         const float* __restrict__ Wh,
                         const float* __restrict__ b,
                         const float* __restrict__ h,
                         const float* __restrict__ c,
                         const float* __restrict__ x,
                         float* __restrict__ h_out,
                         float* __restrict__ c_out,
                         int N, int In, int H, int shared_weights) {
    extern __shared__ float smem[];
    const int H4 = 4 * H;
    const long long n_wx = (long long)In * H4;
    const long long n_wh = (long long)H * H4;
    const int R = blockDim.y;
    float* sWx = smem;
    float* sWh = sWx + n_wx;
    float* sb = sWh + n_wh;
    float* sh = sb + H4;                      // (R, H) rows' h
    float* sx = sh + R * H;                   // (R, In) rows' x

    const long long g = blockIdx.x;
    const long long wg = shared_weights ? 0 : g;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;
    const long long row0 = g * N + (long long)blockIdx.y * R;
    const int rows = min(R, N - (int)blockIdx.y * R);  // ragged last block

    const float* gWx = Wx + wg * n_wx;
    const float* gWh = Wh + wg * n_wh;
    const float* gb = b + wg * H4;
    for (long long i = tid; i < n_wx; i += nthr) sWx[i] = gWx[i];
#pragma unroll 4
    for (long long i = tid; i < n_wh; i += nthr) sWh[i] = gWh[i];
    for (int i = tid; i < H4; i += nthr) sb[i] = gb[i];
    for (int i = tid; i < rows * H; i += nthr) sh[i] = h[row0 * H + i];
    for (int i = tid; i < rows * In; i += nthr) sx[i] = x[row0 * In + i];
    __syncthreads();

    const int j = threadIdx.x;                // hidden unit
    const int r = threadIdx.y;                // row within the block
    if (r >= rows || j >= H) return;          // j >= H pads to a warp
    const float* xr = sx + r * In;
    const float* hr = sh + r * H;
    float xi = 0.0f, xf = 0.0f, xg = 0.0f, xo = 0.0f;
    for (int m = 0; m < In; ++m) {
        const float xv = xr[m];
        const float* w = sWx + m * H4 + j;
        xi = fmaf(xv, w[0], xi);
        xf = fmaf(xv, w[H], xf);
        xg = fmaf(xv, w[2 * H], xg);
        xo = fmaf(xv, w[3 * H], xo);
    }
    float hi = 0.0f, hf = 0.0f, hg = 0.0f, ho = 0.0f;
    for (int k = 0; k < H; ++k) {
        const float hv = hr[k];
        const float* w = sWh + k * H4 + j;
        hi = fmaf(hv, w[0], hi);
        hf = fmaf(hv, w[H], hf);
        hg = fmaf(hv, w[2 * H], hg);
        ho = fmaf(hv, w[3 * H], ho);
    }
    const float gi = sigmoid_f32(xi + hi + sb[j]);
    const float gf = sigmoid_f32(xf + hf + sb[H + j]);
    const float gg = tanhf(xg + hg + sb[2 * H + j]);
    const float go = sigmoid_f32(xo + ho + sb[3 * H + j]);
    const long long o = (row0 + r) * H + j;
    const float c2 = gf * c[o] + gi * gg;
    c_out[o] = c2;
    h_out[o] = go * tanhf(c2);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of R rows needs.
long long lstm_cell_smem_bytes(int In, int H, int rows) {
    const long long H4 = 4LL * H;
    return 4LL * ((long long)In * H4 + (long long)H * H4 + H4
                  + (long long)rows * (H + In));
}

// Launches the grouped step on `stream`: weights (G, ...) or, with
// shared_weights=1, one set read by every group; x (G, N, In), h, c and the
// outputs (G, N, H), all contiguous float32.  threads_x is the hidden width
// rounded up to a warp, rows the rows per CTA.  Returns the CUDA error code
// of the attribute call or of the launch (0 = launched).
int lstm_cell_grouped_f32(const void* Wx, const void* Wh, const void* b,
                          const void* h, const void* c, const void* x,
                          void* h_out, void* c_out, int G, int N, int In,
                          int H, int shared_weights, int threads_x, int rows,
                          void* stream) {
    const long long smem = lstm_cell_smem_bytes(In, H, rows);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)G, (unsigned)((N + rows - 1) / rows));
    const dim3 block((unsigned)threads_x, (unsigned)rows);
    lstm_cell_grouped_kernel<<<grid, block, (size_t)smem,
                               (cudaStream_t)stream>>>(
        (const float*)Wx, (const float*)Wh, (const float*)b, (const float*)h,
        (const float*)c, (const float*)x, (float*)h_out, (float*)c_out, N, In,
        H, shared_weights);
    return (int)cudaGetLastError();
}

const char* lstm_cell_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
