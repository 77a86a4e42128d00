// Grouped Attention-Double-LSTM forward + ReLU-dense head, one CUDA kernel
// for Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/attn_lstm_seq.py:
//   * attn_lstm_seq          (_attn_seq_pallas / _attn_seq_kernel, shared
//                             weights), and
//   * attn_lstm_seq_stacked  (_attn_seq_stacked_pallas /
//                             _attn_seq_stacked_kernel, weights per row),
// and the vmap of attn_lstm_seq over Z targets in the batched refit
// (src/repro/core/forecaster.py, _lstm_fit_stacked with arch="attn").  As in
// lstm_seq.cu all three are one grouped forward: nine weight leaves with a
// leading group axis G (group stride 0 when every group shares one set),
// windows xs (G, N, W, M) -> (G, N, n_out).  attn_lstm_seq is G=1, N=B;
// attn_lstm_seq_stacked is G=Z, N=1; the refit is G=Z, N windows.
//
// A row computes: LSTM-1 over the window, keeping every hidden state hs
// (W, H); q = h_W @ Wa; s_t = (sum_j hs[t,j] q_j) * H^-0.5; alpha =
// softmax(s) over the window; LSTM-2 over ctx[t] = alpha_t * hs[t]; then
// relu(h) @ Wo + bo.
//
// What bounds it on an H100 (f32 throughout, no tensor cores):
//   * the per-target forecast (G=Z, N=1) reads each target's weights once:
//     (M + 2H + 1) * 4H + H * 4H + H * H + 4H + (H + 1) * n_out floats
//     = 136,620 B at H=50, M=n_out=5, for about 0.49 MFLOP a row at W=8:
//     bound by bytes (Z=4096: ~560 MB, ~0.167 ms at 3.35 TB/s);
//   * the grouped refit forward (G=Z, N=12) does 12x the arithmetic on the
//     same bytes: ~24 GFLOP at Z=4096, ~0.36 ms at 67 TFLOP/s, bound by
//     operations;
//   * the shared-weight fit forward (G=1, N~111) and the scalar PPA's
//     forecast (G=1, N=1) are bound by launch latency.
// What the design does about it: one CTA per (group, block of R rows)
// stages its group's weights into dynamic shared memory in two parts that
// share one region -- Wx1, Wh1, b1, Wa (54.8 KB at H=50) for LSTM-1 and
// the query, then, after a barrier, Wx2, Wh2, b2, Wo, bo (81.8 KB) for
// LSTM-2 and the head -- so each weight byte leaves device memory once per
// CTA, and the region is 81.8 KB rather than 136.6 KB (two CTAs fit on an
// SM at small R).  Copies use 16-byte loads where both ends are aligned.
// The hidden history hs, the query, the scores/softmax and LSTM-2's
// double-buffered h live in shared memory per row, c in a register, so no
// state goes back to device memory.  LSTM-1 reads h(t-1) from hs and writes
// h(t) into the next slot, LSTM-2 ping-pongs between two h buffers: one
// barrier a step.  Thread (j, r) owns hidden unit j of row r (threads_x = H
// rounded up to a warp) and computes the four gate pre-activations at
// columns j, H+j, 2H+j, 3H+j.  The score sum over j spans two warps at
// H=50, so it goes through shared memory: q is written, a barrier, then
// one thread per (r, t) sums over j, and one thread per row softmaxes.
// Every __syncthreads() is reached by every thread, padded j >= H and
// ragged rows included: masking sits inside the barriers.  This is the
// simple form: no tensor cores, no TMA, one group per CTA; packing targets
// per CTA and wgmma are later work.
//
// Numerics: expf/tanhf (no fast-math).  Gate sums accumulate x@Wx, then
// h@Wh, then add b, the plain version's order; step 0 skips h@Wh
// (h(-1) = 0: the plain version adds an exact 0 there).  ctx[t,k] is the
// rounded product alpha_t * hs[t,k], as in the plain version; the score is
// the sum first and the scale H^-0.5 after it (ref.py's order); the
// softmax subtracts the row maximum before expf, as jax.nn.softmax does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ long long pad4(long long n) {
    return (n + 3) & ~3LL;
}

// Floats of the shared weight region: the larger of the two stages, each
// leaf padded to 16 bytes.
__host__ __device__ __forceinline__ long long weight_region(int M, int H,
                                                            int n_out) {
    const long long H4 = 4LL * H;
    const long long stage1 = pad4(M * H4) + pad4(H * H4) + pad4(H4)
                             + pad4((long long)H * H);
    const long long stage2 = 2 * pad4(H * H4) + pad4(H4)
                             + pad4((long long)H * n_out) + pad4(n_out);
    return stage1 > stage2 ? stage1 : stage2;
}

// Floats of one row's scratch: hs (W, H), q (H), LSTM-2's h (2, H) and
// alpha (W).
__host__ __device__ __forceinline__ long long row_floats(int W, int H) {
    return (long long)W * H + 3LL * H + W;
}

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// n floats from device memory into shared memory, spread over the CTA;
// 16-byte loads when both ends are 16-byte aligned.
__device__ __forceinline__ void stage_copy(float* dst,
                                           const float* __restrict__ src,
                                           long long n, int tid, int nthr) {
    if (((reinterpret_cast<uintptr_t>(dst)
          | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
        const long long n4 = n >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
        for (long long i = tid; i < n4; i += nthr) d4[i] = __ldg(s4 + i);
        for (long long i = (n4 << 2) + tid; i < n; i += nthr)
            dst[i] = __ldg(src + i);
    } else {
#pragma unroll 4
        for (long long i = tid; i < n; i += nthr) dst[i] = __ldg(src + i);
    }
}

// One LSTM step for hidden unit j: the gate pre-activations from K inputs
// and the previous hidden state h_prev (nullptr at step 0, where h(-1) = 0),
// then the cell update; returns h(t) and updates c.  LSTM-1 (kCtx false)
// reads its inputs from the window in device memory; LSTM-2 (kCtx true)
// reads ctx = a_t * hs[t] from shared memory, each product rounded as the
// plain version rounds it.
template <bool kCtx>
__device__ __forceinline__ float lstm_unit(const float* in, float a_t, int K,
                                           const float* sWx,
                                           const float* h_prev,
                                           const float* sWh, const float* sb,
                                           int H, int j, float& c) {
    const int H4 = 4 * H;
    float xi = 0.0f, xf = 0.0f, xg = 0.0f, xo = 0.0f;
    for (int k = 0; k < K; ++k) {
        float v;
        if constexpr (kCtx) v = a_t * in[k];
        else v = __ldg(in + k);
        const float* w = sWx + k * H4 + j;
        xi = fmaf(v, w[0], xi);
        xf = fmaf(v, w[H], xf);
        xg = fmaf(v, w[2 * H], xg);
        xo = fmaf(v, w[3 * H], xo);
    }
    float hi = 0.0f, hf = 0.0f, hg = 0.0f, ho = 0.0f;
    if (h_prev != nullptr) {
        for (int k = 0; k < H; ++k) {
            const float hv = h_prev[k];
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
    return go * tanhf(c);
}

__global__ void __launch_bounds__(1024)
attn_lstm_seq_grouped_kernel(const float* __restrict__ Wx1,
                             const float* __restrict__ Wh1,
                             const float* __restrict__ b1,
                             const float* __restrict__ Wa,
                             const float* __restrict__ Wx2,
                             const float* __restrict__ Wh2,
                             const float* __restrict__ b2,
                             const float* __restrict__ Wo,
                             const float* __restrict__ bo,
                             const float* __restrict__ xs,
                             float* __restrict__ out,
                             int N, int W, int M, int H, int n_out,
                             int shared_weights) {
    extern __shared__ __align__(16) float smem[];
    const int H4 = 4 * H;
    const long long n_wx1 = (long long)M * H4;
    const long long n_wh = (long long)H * H4;     // Wh1, Wx2, Wh2
    const long long n_wa = (long long)H * H;
    const long long n_wo = (long long)H * n_out;
    // stage 1 (LSTM-1 and the query) and stage 2 (LSTM-2 and the head)
    // share one region
    float* sWx1 = smem;
    float* sWh1 = sWx1 + pad4(n_wx1);
    float* sb1 = sWh1 + pad4(n_wh);
    float* sWa = sb1 + pad4(H4);
    float* sWx2 = smem;
    float* sWh2 = sWx2 + pad4(n_wh);
    float* sb2 = sWh2 + pad4(n_wh);
    float* sWo = sb2 + pad4(H4);
    float* sbo = sWo + pad4(n_wo);

    const int j = threadIdx.x;                // hidden unit
    const int r = threadIdx.y;                // row within the block
    const int R = blockDim.y;
    const int tid = r * blockDim.x + j;
    const int nthr = blockDim.x * R;
    float* hs = smem + weight_region(M, H, n_out) + r * row_floats(W, H);
    float* sq = hs + W * H;                   // query (H)
    float* h2 = sq + H;                       // LSTM-2's h, two buffers
    float* alpha = h2 + 2 * H;                // scores, then weights (W)

    const long long g = blockIdx.x;           // group
    const long long wg = shared_weights ? 0 : g;
    const long long n = (long long)blockIdx.y * R + r;
    const bool row_ok = n < N;                // ragged last row block
    const bool unit_ok = row_ok && j < H;     // j >= H pads to a warp
    const float* x_row = xs + (g * N + n) * (long long)W * M;

    // ---- stage 1: LSTM-1, keeping every hidden state in hs
    stage_copy(sWx1, Wx1 + wg * n_wx1, n_wx1, tid, nthr);
    if (W > 1) stage_copy(sWh1, Wh1 + wg * n_wh, n_wh, tid, nthr);
    stage_copy(sb1, b1 + wg * H4, H4, tid, nthr);
    stage_copy(sWa, Wa + wg * n_wa, n_wa, tid, nthr);
    __syncthreads();

    float c = 0.0f;
    for (int t = 0; t < W; ++t) {
        if (unit_ok)
            hs[t * H + j] = lstm_unit<false>(
                x_row + (long long)t * M, 1.0f, M, sWx1,
                t > 0 ? hs + (t - 1) * H : nullptr, sWh1, sb1, H, j, c);
        __syncthreads();                      // h(t) visible to the row
    }

    // ---- attention: q = h_W @ Wa
    if (unit_ok) {
        const float* h_last = hs + (W - 1) * H;
        float acc = 0.0f;
        for (int k = 0; k < H; ++k) acc = fmaf(h_last[k], sWa[k * H + j], acc);
        sq[j] = acc;
    }
    __syncthreads();                          // q written; stage 1 read

    // ---- stage 2 weights into the same region, and the scores
    stage_copy(sWx2, Wx2 + wg * n_wh, n_wh, tid, nthr);
    if (W > 1) stage_copy(sWh2, Wh2 + wg * n_wh, n_wh, tid, nthr);
    stage_copy(sb2, b2 + wg * H4, H4, tid, nthr);
    stage_copy(sWo, Wo + wg * n_wo, n_wo, tid, nthr);
    stage_copy(sbo, bo + wg * n_out, n_out, tid, nthr);
    const float scale = (float)(1.0 / sqrt((double)H));
    if (row_ok) {
        for (int t = j; t < W; t += blockDim.x) {
            const float* ht = hs + t * H;
            float s = 0.0f;
            for (int k = 0; k < H; ++k) s = fmaf(ht[k], sq[k], s);
            alpha[t] = s * scale;
        }
    }
    __syncthreads();                          // scores and stage 2 in place

    // ---- softmax over the window, the row maximum subtracted
    if (row_ok && j == 0) {
        float mx = alpha[0];
        for (int t = 1; t < W; ++t) mx = fmaxf(mx, alpha[t]);
        float sum = 0.0f;
        for (int t = 0; t < W; ++t) {
            const float e = expf(alpha[t] - mx);
            alpha[t] = e;
            sum += e;
        }
        for (int t = 0; t < W; ++t) alpha[t] = alpha[t] / sum;
    }
    __syncthreads();                          // alpha visible to the row

    // ---- LSTM-2 over ctx[t] = alpha_t * hs[t], then the head
    c = 0.0f;
    for (int t = 0; t < W; ++t) {
        if (unit_ok)
            h2[(t & 1) * H + j] = lstm_unit<true>(
                hs + t * H, alpha[t], H, sWx2,
                t > 0 ? h2 + ((t - 1) & 1) * H : nullptr, sWh2, sb2, H, j,
                c);
        __syncthreads();                      // h(t) visible to the row
    }

    if (row_ok) {
        const float* h_last = h2 + ((W - 1) & 1) * H;
        float* o_row = out + (g * N + n) * (long long)n_out;
        for (int o = j; o < n_out; o += blockDim.x) {
            float acc = 0.0f;
            for (int k = 0; k < H; ++k)
                acc = fmaf(fmaxf(h_last[k], 0.0f), sWo[k * n_out + o], acc);
            o_row[o] = acc + sbo[o];
        }
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of `rows` rows needs.
long long attn_lstm_seq_smem_bytes(int M, int H, int W, int n_out,
                                   int rows) {
    return 4LL * (weight_region(M, H, n_out) + (long long)rows
                  * row_floats(W, H));
}

// Launches the grouped forward on `stream`.  Weights are (G, ...) or, with
// shared_weights=1, one set read by every group; W >= 1.  threads_x is the
// hidden width rounded up to a warp, rows the rows per CTA.  Returns the
// CUDA error code of the attribute call or of the launch (0 = launched).
int attn_lstm_seq_grouped_f32(const void* Wx1, const void* Wh1,
                              const void* b1, const void* Wa,
                              const void* Wx2, const void* Wh2,
                              const void* b2, const void* Wo, const void* bo,
                              const void* xs, void* out, int G, int N, int W,
                              int M, int H, int n_out, int shared_weights,
                              int threads_x, int rows, void* stream) {
    const long long smem = attn_lstm_seq_smem_bytes(M, H, W, n_out, rows);
    cudaError_t err = cudaFuncSetAttribute(
        attn_lstm_seq_grouped_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)G, (unsigned)((N + rows - 1) / rows));
    const dim3 block((unsigned)threads_x, (unsigned)rows);
    attn_lstm_seq_grouped_kernel<<<grid, block, (size_t)smem,
                                   (cudaStream_t)stream>>>(
        (const float*)Wx1, (const float*)Wh1, (const float*)b1,
        (const float*)Wa, (const float*)Wx2, (const float*)Wh2,
        (const float*)b2, (const float*)Wo, (const float*)bo,
        (const float*)xs, (float*)out, N, W, M, H, n_out, shared_weights);
    return (int)cudaGetLastError();
}

const char* attn_lstm_seq_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
