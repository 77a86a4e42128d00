// Grouped whole-window LSTM + ReLU-dense head, one CUDA kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/lstm_seq.py:
//   * lstm_seq          (_seq_pallas / _seq_kernel, shared weights), and
//   * lstm_seq_stacked  (_seq_stacked_pallas / _seq_stacked_kernel, one set
//                        of weights per row),
// and the vmap of lstm_seq over Z targets in the batched refit
// (src/repro/core/forecaster.py, _lstm_fit_stacked).  All three are one
// grouped forward: weights with a leading group axis G (or a group stride of
// 0 when every group shares one set), windows xs (G, N, W, M) -> (G, N, n_out).
// lstm_seq is G=1, N=B; lstm_seq_stacked is G=Z, N=1; the refit is G=Z, N=n.
//
// What bounds it on an H100 (f32 throughout, no tensor cores):
//   * the per-target forecast (G=Z, N=1) reads each target's weights once,
//     (M + H + 1) * 4H + (H + 1) * n_out floats = 45,820 B at H=50, M=5, for
//     0.07 MFLOP of work (h(-1) = 0, so a W-step window has W-1 recurrent
//     products): memory-bound (Z=4096: ~188 MB, ~56 us at 3.35 TB/s);
//   * the grouped refit forward (G=Z, N=16) does 16x the arithmetic on the
//     same bytes: ~4.8 GFLOP of f32 CUDA-core work at Z=4096, ~71 us at
//     67 TFLOP/s, so it is bound by operations;
//   * the shared-weight fit forward (G=1, N~116) is a few kB of work and is
//     bound by launch latency.
// What the design does about it: one CTA per (group, block of R rows) copies
// its group's weights once into shared memory, so each weight byte leaves
// device memory once per CTA however many rows and steps reuse it; h lives in
// shared memory and c in a register across all W steps, so no state goes back
// to device memory between steps (the TPU kernel kept both in VMEM scratch).
// Thread (j, r) owns hidden unit j of row r and computes the four gate
// pre-activations at columns j, H+j, 2H+j, 3H+j (_gates_step in the TPU
// kernel); neighbouring j read neighbouring shared-memory words, and every
// thread of a row reads the same h word (a broadcast).  This is the simple
// form: no tensor cores, no TMA, one group per CTA.  Packing several targets
// into one CTA and feeding the gate products to wgmma is later work.
//
// Numerics: expf/tanhf (no fast-math); sums accumulate x@Wx then h@Wh then
// add b, the order of the plain version.  Step 0 skips h@Wh, as the JAX
// package's stacked XLA path does: the plain version adds an exact 0 there
// for finite weights, so the result is the same.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(1024)
lstm_seq_grouped_kernel(const float* __restrict__ Wx,
                        const float* __restrict__ Wh,
                        const float* __restrict__ b,
                        const float* __restrict__ Wo,
                        const float* __restrict__ bo,
                        const float* __restrict__ xs,
                        float* __restrict__ out,
                        int N, int W, int M, int H, int n_out,
                        int shared_weights) {
    extern __shared__ float smem[];
    const int H4 = 4 * H;
    const long long n_wx = (long long)M * H4;
    const long long n_wh = (long long)H * H4;
    const long long n_wo = (long long)H * n_out;
    float* sWx = smem;
    float* sWh = sWx + n_wx;
    float* sb = sWh + n_wh;
    float* sWo = sb + H4;
    float* sbo = sWo + n_wo;
    float* sh = sbo + n_out;                  // (R, H) hidden state

    const long long g = blockIdx.x;           // group
    const long long wg = shared_weights ? 0 : g;
    const int R = blockDim.y;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;

    const float* gWx = Wx + wg * n_wx;
    const float* gWh = Wh + wg * n_wh;
    const float* gb = b + wg * H4;
    const float* gWo = Wo + wg * n_wo;
    const float* gbo = bo + wg * n_out;
    // h(-1) = 0, so a one-step window never reads Wh
    if (W > 1) {
#pragma unroll 4
        for (long long i = tid; i < n_wh; i += nthr) sWh[i] = gWh[i];
    }
    for (long long i = tid; i < n_wx; i += nthr) sWx[i] = gWx[i];
    for (int i = tid; i < H4; i += nthr) sb[i] = gb[i];
    for (long long i = tid; i < n_wo; i += nthr) sWo[i] = gWo[i];
    for (int i = tid; i < n_out; i += nthr) sbo[i] = gbo[i];
    for (int i = tid; i < R * H; i += nthr) sh[i] = 0.0f;
    __syncthreads();

    const int j = threadIdx.x;                // hidden unit
    const int r = threadIdx.y;                // row within the block
    const long long n = (long long)blockIdx.y * R + r;
    const bool row_ok = n < N;                // ragged last row block
    const bool unit_ok = row_ok && j < H;     // j >= H pads to a warp
    const float* x_row = xs + (g * N + n) * (long long)W * M;
    float* h_row = sh + r * H;

    float c = 0.0f;
    for (int t = 0; t < W; ++t) {
        float h_new = 0.0f;
        if (unit_ok) {
            const float* x = x_row + (long long)t * M;
            float xi = 0.0f, xf = 0.0f, xg = 0.0f, xo = 0.0f;
            for (int m = 0; m < M; ++m) {
                const float xv = __ldg(x + m);
                const float* w = sWx + m * H4 + j;
                xi = fmaf(xv, w[0], xi);
                xf = fmaf(xv, w[H], xf);
                xg = fmaf(xv, w[2 * H], xg);
                xo = fmaf(xv, w[3 * H], xo);
            }
            float hi = 0.0f, hf = 0.0f, hg = 0.0f, ho = 0.0f;
            if (t > 0) {                      // h(-1) = 0: no product at t=0
                for (int k = 0; k < H; ++k) {
                    const float hv = h_row[k];
                    const float* w = sWh + k * H4 + j;
                    hi = fmaf(hv, w[0], hi);
                    hf = fmaf(hv, w[H], hf);
                    hg = fmaf(hv, w[2 * H], hg);
                    ho = fmaf(hv, w[3 * H], ho);
                }
            }
            const float gi = sigmoid_f32(xi + hi + sb[j]);
            const float gf = sigmoid_f32(xf + hf + sb[H + j]);
            const float gg = tanhf(xg + hg + sb[2 * H + j]);
            const float go = sigmoid_f32(xo + ho + sb[3 * H + j]);
            c = gf * c + gi * gg;
            h_new = go * tanhf(c);
        }
        __syncthreads();                      // every read of h(t-1) done
        if (unit_ok) h_row[j] = h_new;
        __syncthreads();                      // h(t) visible to the row
    }

    if (row_ok) {
        float* o_row = out + (g * N + n) * (long long)n_out;
        for (int o = j; o < n_out; o += blockDim.x) {
            float acc = 0.0f;
            for (int k = 0; k < H; ++k)
                acc = fmaf(fmaxf(h_row[k], 0.0f), sWo[k * n_out + o], acc);
            o_row[o] = acc + sbo[o];
        }
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of R rows needs.
long long lstm_seq_smem_bytes(int M, int H, int n_out, int rows) {
    const long long H4 = 4LL * H;
    return 4LL * ((long long)M * H4 + (long long)H * H4 + H4
                  + (long long)H * n_out + n_out + (long long)rows * H);
}

// Launches the grouped forward on `stream`.  Weights are (G, ...) or, with
// shared_weights=1, one set read by every group.  threads_x is the hidden
// width rounded up to a warp, rows the rows per CTA.  Returns the CUDA error
// code of the attribute call or of the launch (0 = launched).
int lstm_seq_grouped_f32(const void* Wx, const void* Wh, const void* b,
                         const void* Wo, const void* bo, const void* xs,
                         void* out, int G, int N, int W, int M, int H,
                         int n_out, int shared_weights, int threads_x,
                         int rows, void* stream) {
    const long long smem = lstm_seq_smem_bytes(M, H, n_out, rows);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_seq_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)G, (unsigned)((N + rows - 1) / rows));
    const dim3 block((unsigned)threads_x, (unsigned)rows);
    lstm_seq_grouped_kernel<<<grid, block, (size_t)smem,
                              (cudaStream_t)stream>>>(
        (const float*)Wx, (const float*)Wh, (const float*)b,
        (const float*)Wo, (const float*)bo, (const float*)xs, (float*)out,
        N, W, M, H, n_out, shared_weights);
    return (int)cudaGetLastError();
}

const char* lstm_seq_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
