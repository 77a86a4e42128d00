// Grouped Attention-Double-LSTM forward + ReLU-dense head for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/attn_lstm_seq.py:
//   * attn_lstm_seq          (_attn_seq_pallas / _attn_seq_kernel, shared
//                             weights: every fit forward, and the scalar
//                             PPA's one-window forecast), and
//   * attn_lstm_seq_stacked  (_attn_seq_stacked_pallas /
//                             _attn_seq_stacked_kernel, weights per row: the
//                             plane's per-target forecast),
// and the vmap of attn_lstm_seq over Z targets in the batched refit
// (src/repro/core/forecaster.py, _lstm_fit_stacked with arch="attn").  All
// three are one grouped forward: nine weight leaves with a leading group
// axis G (group stride 0 when every group shares one set), windows xs
// (G, N, W, M) -> (G, N, n_out).  attn_lstm_seq is G=1, N=B;
// attn_lstm_seq_stacked is G=Z, N=1; the refit is G=Z, N windows.
//
// A row computes: LSTM-1 over the window, keeping every hidden state hs
// (W, H); q = h_W @ Wa; s_t = (sum_j hs[t,j] q_j) * H^-0.5; alpha =
// softmax(s) over the window; LSTM-2 over ctx[t] = alpha_t * hs[t]; then
// relu(h) @ Wo + bo.
//
// What bounds each regime on an H100 (f32 on CUDA cores, no tensor cores:
// the f32 forecasts are held to 1e-5 of the JAX package's):
//   * the per-target forecast (G=Z, N=1) reads each target's weights once:
//     (M + 2H + 1) * 4H + H * 4H + H * H + 4H + (H + 1) * n_out floats
//     = 136,620 B at H=50, M=n_out=5, for about 0.49 MFLOP a row at W=8:
//     bound by bytes (Z=4096: ~560 MB, ~0.167 ms at 3.35 TB/s).  A target's
//     bytes must stream into each SM while it computes the one before.
//   * the grouped refit forward (G=Z, N=12) does 12x the arithmetic on the
//     same bytes: ~24 GFLOP at Z=4096, ~0.35 ms at 67 TFLOP/s, bound by
//     operations, and so by how many instructions each FMA drags along.
//   * the shared-weight fits (G=1, N=111 or 591) and the scalar PPA's
//     forecast (G=1, N=1) are bound by latency: 16 dependent recurrent
//     steps, and a launch.
//
// Three kernels, which the wrapper's launch_plan picks by a cost per work
// item measured on the card: attn_lstm_seq_reg_kernel (one row an item,
// each layer's weights in registers: the per-target forecast, the scalar
// PPA and the fits); attn_lstm_seq_tiled_kernel<RT> (RT rows an item,
// weights in shared memory: the refit, where a row costs it less); and
// attn_lstm_seq_general_kernel (the first port's kernel) for every shape
// whose two weight stages do not fit in one CTA side by side.
//
// Both new kernels run persistent CTAs (grid <= SMs x CTAs an SM) that
// walk work items: with weights per group, the groups g = blockIdx.x + i *
// gridDim.x and each group's items; with shared weights, the items of all
// groups, the one weight set copied once.  Both weight stages stay
// resident in separate regions: stage 1 (Wx1, Wh1, b1, Wa: 54.8 KB at
// H=50) and stage 2 (Wx2, Wh2, b2, Wo, bo: 81.8 KB), each with an
// mbarrier; a stage's copy for target i+1 is issued as soon as target i
// has read it, so it lands while target i computes.  The window rows of
// the next item are prefetched the same way (a third mbarrier).
//   Copies: one thread issues, for each leaf of a stage whose bit is set
// in bulk_mask, one cp.async.bulk (global -> shared, completion counted in
// bytes on the stage's mbarrier); no thread spends registers or issue
// slots on those bytes.  A bulk copy needs a 16-byte-aligned source and
// destination and a size that is a multiple of 16 bytes; the wrapper sets
// a leaf's bit only where its base address is 16-byte aligned and its size
// is a multiple of 16 bytes, so that every group's copy is aligned too
// (stage leaves start at 16-byte offsets).  The other leaves (Wo and bo at
// H=50, n_out=5; Wa at odd H) and the window rows go 4 bytes a thread by
// cp.async, which every thread then ties to the same mbarrier
// (cp.async.mbarrier.arrive.noinc): a stage's mbarrier expects blockDim.x
// + 1 arrivals and the bulk bytes.  Target i waits on both stages with
// parity i & 1, item k on the window barrier with parity k & 1.
//   Reuse of a stage: all reads of it end at a __syncthreads(), then the
// issuing thread runs fence.proxy.async.shared::cta before the bulk copy,
// so the async proxy's writes are ordered after the generic proxy's reads.
//
// The register kernel: eight lanes a hidden unit (32 * ceil(H / 4)
// threads, H <= 52); lane p of unit j holds the four gate columns j, H+j,
// 2H+j, 3H+j of rows k = p + 8m of a layer's stacked [Wx; Wh], loaded
// from the stage at the layer's start (only one layer's are live, so no
// register spills).  A step: each lane sums its rows against the inputs
// (one broadcast shared-memory load feeds four FMAs), three butterfly
// shuffles reduce the 4 x 8 partial sums so that each lane ends with one
// gate, each lane applies one sigmoid (the g gate's tanh as 2 s(2z) - 1),
// four shuffles gather i, f, g, o and every lane updates c; lane 0 writes
// h.  One barrier a step.  The attention runs a warp a time step.
// The tiled kernel: one thread a gate column (4H, rounded up to a warp)
// keeps RT rows' sums in registers, so one shared-memory load of a weight
// feeds RT FMAs; inputs load as 16-byte broadcasts; the pre-activations go
// through shared memory and threads (row, unit) apply the gates: two
// barriers a step.  Neighbouring columns load neighbouring words.
//
// Numerics: expf/tanhf (no fast-math).  A gate sum is the input segment's
// products plus the recurrent segment's (summed in another order than the
// plain version's matmuls: the tolerance against it is 1e-4), then the
// bias; h(-1) = 0.  The register kernel's tanh of the g gate is the exact
// identity 2 sigmoid(2z) - 1 in f32 (within a few 1e-7 of tanhf).  ctx[t,k]
// is the rounded product alpha_t * hs[t,k], as in the plain version; the
// score is the sum first and the scale H^-0.5 after it (ref.py's order);
// the softmax subtracts the row maximum before expf, as jax.nn.softmax
// does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;      // dynamic shared memory of a CTA
constexpr int kBarrierBytes = 128;    // the mbarriers, padded

__host__ __device__ __forceinline__ long long pad4(long long n) {
    return (n + 3) & ~3LL;
}

// Floats of stage 1 (Wx1, Wh1, b1, Wa) and of stage 2 (Wx2, Wh2, b2, Wo,
// bo), each leaf padded to 16 bytes.
__host__ __device__ __forceinline__ long long stage1_floats(int M, int H) {
    const long long H4 = 4LL * H;
    return pad4(M * H4) + pad4(H * H4) + pad4(H4) + pad4((long long)H * H);
}

__host__ __device__ __forceinline__ long long stage2_floats(int H,
                                                            int n_out) {
    const long long H4 = 4LL * H;
    return 2 * pad4(H * H4) + pad4(H4) + pad4((long long)H * n_out)
           + pad4(n_out);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------------ the general kernel
// Floats of the shared weight region: the larger of the two stages.
__host__ __device__ __forceinline__ long long weight_region(int M, int H,
                                                            int n_out) {
    const long long s1 = stage1_floats(M, H), s2 = stage2_floats(H, n_out);
    return s1 > s2 ? s1 : s2;
}

// Floats of one row's scratch: hs (W, H), q (H), LSTM-2's h (2, H) and
// alpha (W).
__host__ __device__ __forceinline__ long long row_floats(int W, int H) {
    return (long long)W * H + 3LL * H + W;
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

// The first port's kernel: one CTA per (group, block of R rows), thread
// (j, r) owns hidden unit j of row r; stage 1 is copied into the weight
// region, used, and then overwritten by stage 2.  Taken only by shapes
// whose two stages do not fit in one CTA side by side.
__global__ void __launch_bounds__(1024)
attn_lstm_seq_general_kernel(const float* __restrict__ Wx1,
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


// ------------------------------------------- copies for the new kernels
struct Leaves {
    const float* p[9];   // Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                     "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

// All of this thread's earlier cp.async copies arrive on bar when they land
// (the arrival is one of the barrier's expected ones).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Copies leaves [first, last) of weight set wg into dst, each leaf padded
// to 16 bytes: a leaf with its bit in bulk_mask by one bulk copy that
// thread 0 issues, the others 4 bytes a thread by cp.async.  Called by
// every thread of the CTA, after the __syncthreads() that ended the last
// reads of dst.
__device__ __forceinline__ void issue_stage(const Leaves& L,
                                            const int* n, int first,
                                            int last, long long wg,
                                            float* dst, unsigned bulk_mask,
                                            uint64_t* bar, int tid,
                                            int nthr) {
    if (tid == 0) {
        uint32_t bytes = 0;
        for (int l = first; l < last; ++l)
            if ((bulk_mask >> l) & 1) bytes += 4u * (uint32_t)n[l];
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
        // the generic proxy's reads of dst end before the async proxy's
        // writes begin
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        float* d = dst;
        for (int l = first; l < last; ++l) {
            if (((bulk_mask >> l) & 1) && n[l] > 0)
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::"
                    "complete_tx::bytes [%0], [%1], %2, [%3];"
                    :: "r"(smem_u32(d)), "l"(L.p[l] + wg * n[l]),
                       "r"(4u * (uint32_t)n[l]), "r"(smem_u32(bar))
                    : "memory");
            d += pad4(n[l]);
        }
    }
    float* d = dst;
    for (int l = first; l < last; ++l) {
        if (!((bulk_mask >> l) & 1)) {
            const float* s = L.p[l] + wg * n[l];
            for (int e = tid; e < n[l]; e += nthr)
                copy4_async(d + e, s + e);
        }
        d += pad4(n[l]);
    }
    cp_async_arrive(bar);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Work items of a CTA of the persistent grid: with shared weights the
// items of all groups (one weight set, "target" 0), else this CTA's groups
// (targets) times `per_group` items each.
struct Items {
    long long cta, grid, n_tg, n_items;
    int per_group, shared;

    __device__ Items(int G, int per_group_, int shared_)
        : cta(blockIdx.x), grid(gridDim.x), per_group(per_group_),
          shared(shared_) {
        if (shared) {
            const long long total = (long long)G * per_group;
            n_items = total > cta ? (total - cta + grid - 1) / grid : 0;
            n_tg = n_items > 0;
        } else {
            n_tg = G > cta ? (G - cta + grid - 1) / grid : 0;
            n_items = n_tg * per_group;
        }
    }
    // the weight set of target i
    __device__ long long weights(long long i) const {
        return shared ? 0 : cta + i * grid;
    }
    // item k -> group g, item b within the group, target i; whether it is
    // the first and the last item of its target
    __device__ void of(long long k, long long& g, int& b, long long& i,
                       bool& first, bool& last) const {
        if (shared) {
            const long long flat = cta + k * grid;
            g = flat / per_group;
            b = (int)(flat - g * per_group);
            i = 0;
            first = k == 0;
            last = k == n_items - 1;
        } else {
            i = k / per_group;
            b = (int)(k - i * per_group);
            g = cta + i * grid;
            first = b == 0;
            last = b == per_group - 1;
        }
    }
};

// -------------------------------------------------------- the tiled kernel
constexpr int kTiledMaxThreads = 256;

// Floats of the tiled kernel's scratch for `rows` rows: per row the window
// (W, Mp), the hidden history (W, Hp), LSTM-2's h, the query and c (Hp
// each), the softmax weights (pad4(W)); then the gate pre-activations
// (rows, 4H).
__host__ __device__ __forceinline__ long long tiled_smem(int M, int H, int W,
                                                         int n_out, int rows) {
    const long long Mp = pad4(M), Hp = pad4(H);
    const long long scratch = rows * (W * Mp + W * Hp + 3 * Hp + pad4(W))
                              + rows * 4LL * H;
    return kBarrierBytes
           + 4 * (stage1_floats(M, H) + stage2_floats(H, n_out) + scratch);
}

// acc[r] += sum over k < K of in[r * stride + k] * w[k * ldw + col] for
// the RT rows; in and stride are multiples of 4 floats, so the inputs load
// as 16-byte broadcasts.
template <int RT>
__device__ __forceinline__ void row_dot(float (&acc)[RT], const float* in,
                                        int stride, int K, const float* w,
                                        int ldw, int col) {
    constexpr int NA = RT >= 4 ? 1 : 4 / RT;   // partial sums a row
    float a[RT][NA];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < NA; ++q) a[r][q] = 0.0f;
    int k = 0;
#pragma unroll(RT >= 4 ? 1 : 2)
    for (; k + 4 <= K; k += 4) {
        const float* wk = w + k * ldw + col;
        const float w0 = wk[0], w1 = wk[ldw], w2 = wk[2 * ldw],
                    w3 = wk[3 * ldw];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(in + r * stride + k);
            a[r][0] = fmaf(v.x, w0, a[r][0]);
            a[r][1 % NA] = fmaf(v.y, w1, a[r][1 % NA]);
            a[r][2 % NA] = fmaf(v.z, w2, a[r][2 % NA]);
            a[r][3 % NA] = fmaf(v.w, w3, a[r][3 % NA]);
        }
    }
    for (; k < K; ++k) {
        const float wk = w[k * ldw + col];
#pragma unroll
        for (int r = 0; r < RT; ++r)
            a[r][0] = fmaf(in[r * stride + k], wk, a[r][0]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        float s = a[r][0];
#pragma unroll
        for (int q = 1; q < NA; ++q) s += a[r][q];
        acc[r] += s;
    }
}

// One LSTM step of RT rows.  Inputs: segment A (Ka floats a row at `a`,
// row stride sa) and the previous hidden state (H floats a row at hp, row
// stride sh; nullptr at step 0).  Thread col sums its gate column's
// products into zs, then threads (row, unit) apply the gates, update c
// (cs) and write h(t) to ho (row stride so).  Two barriers.
template <int RT>
__device__ __forceinline__ void lstm_step(const float* a, int sa, int Ka,
                                          const float* hp, int sh,
                                          const float* Wx, const float* Wh,
                                          const float* b, int H, float* zs,
                                          float* cs, float* ho, int so,
                                          int tid, int nthr) {
    const int H4 = 4 * H;
    const int Hp = (int)pad4(H);
    if (tid < H4) {
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
        row_dot<RT>(acc, a, sa, Ka, Wx, H4, tid);
        if (hp != nullptr) row_dot<RT>(acc, hp, sh, H, Wh, H4, tid);
#pragma unroll
        for (int r = 0; r < RT; ++r) zs[r * H4 + tid] = acc[r];
    }
    __syncthreads();                           // pre-activations in zs
    for (int p = tid; p < RT * H; p += nthr) {
        const int r = p / H, j = p - r * H;
        const float* z = zs + r * H4 + j;
        const float gi = sigmoid_f32(z[0] + b[j]);
        const float gf = sigmoid_f32(z[H] + b[H + j]);
        const float gg = tanhf(z[2 * H] + b[2 * H + j]);
        const float go = sigmoid_f32(z[3 * H] + b[3 * H + j]);
        const float c = hp != nullptr ? gf * cs[r * Hp + j] + gi * gg
                                      : gi * gg;
        cs[r * Hp + j] = c;
        ho[r * so + j] = go * tanhf(c);
    }
    __syncthreads();                           // h(t) visible to all
}

template <int RT>
__global__ void __launch_bounds__(kTiledMaxThreads, 1)
attn_lstm_seq_tiled_kernel(Leaves L, const float* __restrict__ xs,
                           float* __restrict__ out, int G, int N, int W,
                           int M, int H, int n_out, int shared_weights,
                           unsigned bulk_mask) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int NB = (N + RT - 1) / RT;         // row blocks a group
    const Items it(G, NB, shared_weights);
    if (it.n_items == 0) return;

    const int H4 = 4 * H;
    const int Mp = (int)pad4(M), Hp = (int)pad4(H), Wp = (int)pad4(W);
    const int n[9] = {M * H4, H * H4, H4, H * H, H * H4, H * H4, H4,
                      H * n_out, n_out};
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    uint64_t* bar_s1 = bars;                   // stage 1
    uint64_t* bar_s2 = bars + 1;               // stage 2
    uint64_t* bar_x = bars + 2;                // the window rows
    float* s1 = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
    float* s2 = s1 + stage1_floats(M, H);
    float* xw = s2 + stage2_floats(H, n_out);  // (RT, W, Mp)
    float* hs = xw + RT * W * Mp;              // (RT, W, Hp)
    float* h2 = hs + RT * W * Hp;              // (RT, Hp)
    float* sq = h2 + RT * Hp;                  // (RT, Hp)
    float* cs = sq + RT * Hp;                  // (RT, Hp)
    float* alpha = cs + RT * Hp;               // (RT, Wp)
    float* zs = alpha + RT * Wp;               // (RT, 4H)
    const float* sWx1 = s1;
    const float* sWh1 = sWx1 + pad4(n[0]);
    const float* sb1 = sWh1 + pad4(n[1]);
    const float* sWa = sb1 + pad4(n[2]);
    const float* sWx2 = s2;
    const float* sWh2 = sWx2 + pad4(n[4]);
    const float* sb2 = sWh2 + pad4(n[5]);
    const float* sWo = sb2 + pad4(n[6]);
    const float* sbo = sWo + pad4(n[7]);

    if (tid == 0) {
        mbar_init(bar_s1, nthr + 1);
        mbar_init(bar_s2, nthr + 1);
        mbar_init(bar_x, nthr);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // the window rows of item k into xw (rows past N zero-filled)
    auto issue_rows = [&](long long k) {
        long long g, i;
        int rb;
        bool first, last;
        it.of(k, g, rb, i, first, last);
        const int WM = W * M;
        for (int e = tid; e < RT * WM; e += nthr) {
            const int r = e / WM, rem = e - r * WM;
            const int t = rem / M, m = rem - t * M;
            const long long row = (long long)rb * RT + r;
            float* dst = xw + (r * W + t) * Mp + m;
            if (row < N) copy4_async(dst, xs + (g * N + row) * WM + rem);
            else *dst = 0.0f;
        }
        cp_async_arrive(bar_x);
    };

    issue_rows(0);
    issue_stage(L, n, 0, 4, it.weights(0), s1, bulk_mask, bar_s1, tid, nthr);
    issue_stage(L, n, 4, 9, it.weights(0), s2, bulk_mask, bar_s2, tid, nthr);

    const float scale = (float)(1.0 / sqrt((double)H));
    for (long long k = 0; k < it.n_items; ++k) {
        long long g, i;
        int rb;
        bool first, last;
        it.of(k, g, rb, i, first, last);
        if (first) mbar_wait(bar_s1, (uint32_t)(i & 1));
        mbar_wait(bar_x, (uint32_t)(k & 1));
        __syncthreads();                       // zero-filled rows visible

        // ---- LSTM-1, keeping every hidden state in hs
        for (int t = 0; t < W; ++t)
            lstm_step<RT>(xw + t * Mp, W * Mp, M,
                          t > 0 ? hs + (t - 1) * Hp : nullptr, W * Hp, sWx1,
                          sWh1, sb1, H, zs, cs, hs + t * Hp, W * Hp, tid,
                          nthr);

        // ---- attention: q = h_W @ Wa, the scores, the softmax, ctx
        for (int p = tid; p < RT * H; p += nthr) {
            const int r = p / H, j = p - r * H;
            const float* hl = hs + (r * W + W - 1) * Hp;
            float acc = 0.0f;
            for (int kk = 0; kk < H; ++kk)
                acc = fmaf(hl[kk], sWa[kk * H + j], acc);
            sq[r * Hp + j] = acc;
        }
        __syncthreads();                       // stage 1 and xw read
        if (k + 1 < it.n_items) issue_rows(k + 1);
        if (last && i + 1 < it.n_tg)
            issue_stage(L, n, 0, 4, it.weights(i + 1), s1, bulk_mask,
                        bar_s1, tid, nthr);
        for (int p = tid; p < RT * W; p += nthr) {
            const int r = p / W, t = p - r * W;
            const float* ht = hs + (r * W + t) * Hp;
            const float* q = sq + r * Hp;
            float s = 0.0f;
            for (int kk = 0; kk < H; ++kk) s = fmaf(ht[kk], q[kk], s);
            alpha[r * Wp + t] = s * scale;
        }
        __syncthreads();
        for (int r = tid; r < RT; r += nthr) {
            float* al = alpha + r * Wp;
            float mx = al[0];
            for (int t = 1; t < W; ++t) mx = fmaxf(mx, al[t]);
            float sum = 0.0f;
            for (int t = 0; t < W; ++t) {
                const float e = expf(al[t] - mx);
                al[t] = e;
                sum += e;
            }
            for (int t = 0; t < W; ++t) al[t] = al[t] / sum;
        }
        __syncthreads();
        for (int e = tid; e < RT * W * H; e += nthr) {
            const int rt = e / H, kk = e - rt * H;   // rt = r * W + t
            const int r = rt / W;
            hs[rt * Hp + kk] = alpha[r * Wp + rt - r * W] * hs[rt * Hp + kk];
        }
        if (first) mbar_wait(bar_s2, (uint32_t)(i & 1));
        __syncthreads();                       // ctx in hs

        // ---- LSTM-2 over ctx, then the head
        for (int t = 0; t < W; ++t)
            lstm_step<RT>(hs + t * Hp, W * Hp, H, t > 0 ? h2 : nullptr, Hp,
                          sWx2, sWh2, sb2, H, zs, cs, h2, Hp, tid, nthr);
        for (int p = tid; p < RT * n_out; p += nthr) {
            const int r = p / n_out, o = p - r * n_out;
            const long long row = (long long)rb * RT + r;
            if (row < N) {
                const float* hl = h2 + r * Hp;
                float acc = 0.0f;
                for (int kk = 0; kk < H; ++kk)
                    acc = fmaf(fmaxf(hl[kk], 0.0f), sWo[kk * n_out + o], acc);
                out[(g * N + row) * n_out + o] = acc + sbo[o];
            }
        }
        __syncthreads();                       // stage 2 read
        if (last && i + 1 < it.n_tg)
            issue_stage(L, n, 4, 9, it.weights(i + 1), s2, bulk_mask,
                        bar_s2, tid, nthr);
    }
}

// ----------------------------------------------------- the register kernel
constexpr int kRegParts = 8;                  // lanes a hidden unit
constexpr int kRegKM1 = 7;                    // LSTM-1 inputs a lane
constexpr int kRegKM2 = 13;                   // LSTM-2 inputs a lane
constexpr int kRegK1 = kRegParts * kRegKM1;   // M + H <= 56
constexpr int kRegK2 = kRegParts * kRegKM2;   // 2H <= 104
constexpr int kRegMaxThreads = 416;           // 32 * ceil(52 / 4)

// The register kernel's shared memory: both stages; the LSTM-1 inputs
// (W + 1, 56) -- row t holds x_t and h(t-1), row W holds h(W-1) --, the
// LSTM-2 inputs (W, 104) -- ctx_t and h2(t-1) --, LSTM-2's last h and the
// query (Hp each), the scores (32); then Wa, Wo and bo.
__host__ __device__ __forceinline__ long long reg_smem(int M, int H, int W,
                                                       int n_out) {
    const long long scratch = (W + 1LL) * kRegK1 + (long long)W * kRegK2
                              + 2 * pad4(H) + 32 + pad4((long long)H * H)
                              + pad4((long long)H * n_out) + pad4(n_out);
    return kBarrierBytes
           + 4 * (stage1_floats(M, H) + stage2_floats(H, n_out) + scratch);
}

// w[m][g] = W[p + 8m][g * H + j] of the K x 4H matrix W at `base` (rows
// p + 8m >= K, and every row where `ok` is false, take 0): a lane's four
// gate columns of every eighth row of a layer's stacked input and
// recurrent weights, kept in registers.  Every load reads a row inside W
// (the index is clamped), so none needs a branch.
template <int KM>
__device__ __forceinline__ void load_columns(float (&w)[KM][4],
                                             const float* base, int p, int K,
                                             int H, bool ok) {
    const int H4 = 4 * H;
    const int rows = ok ? K - p : 0;           // this lane's rows: 8m < rows
    const int mlast = rows > 0 ? (rows - 1) / kRegParts : 0;
    const float* col = base + min(p, K - 1) * H4;
#pragma unroll
    for (int m = 0; m < KM; ++m) {
        const float* r = col + min(m, mlast) * (kRegParts * H4);
        const float v0 = r[0], v1 = r[H], v2 = r[2 * H], v3 = r[3 * H];
        const bool in = kRegParts * m < rows;
        w[m][0] = in ? v0 : 0.0f;
        w[m][1] = in ? v1 : 0.0f;
        w[m][2] = in ? v2 : 0.0f;
        w[m][3] = in ? v3 : 0.0f;
    }
}

// One LSTM step for hidden unit j on its eight lanes: lane p sums inputs
// k = p + 8m (m < KM; zero-padded) against its four gate columns' weights
// in registers; three butterfly levels reduce the 4 x 8 partial sums so
// that lanes 0-1, 2-3, 4-5, 6-7 hold gates i, f, g, o; each lane applies
// one sigmoid (the g gate's tanh as 2 s(2z) - 1, no branch), four shuffles
// gather the gates, every lane updates c, and lane 0 writes h(t) to hout
// where `write`.  Every lane of the warp calls it (full-mask shuffles).
template <int KM>
__device__ __forceinline__ void reg_step(const float* in,
                                         const float (&w)[KM][4], float bq,
                                         float& c, bool first, int p, int q,
                                         int lane0, float* hout,
                                         bool write) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int m = 0; m < KM; ++m) {
        const float v = in[p + kRegParts * m];
        a0 = fmaf(v, w[m][0], a0);
        a1 = fmaf(v, w[m][1], a1);
        a2 = fmaf(v, w[m][2], a2);
        a3 = fmaf(v, w[m][3], a3);
    }
    const bool hi = p & 4, mid = p & 2;
    float k0 = hi ? a2 : a0, k1 = hi ? a3 : a1;
    const float s0 = hi ? a0 : a2, s1 = hi ? a1 : a3;
    k0 += __shfl_xor_sync(0xffffffffu, s0, 4);
    k1 += __shfl_xor_sync(0xffffffffu, s1, 4);
    float y = (mid ? k1 : k0) + __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 2);
    y += __shfl_xor_sync(0xffffffffu, y, 1);
    const float z = y + bq;
    const float sg = sigmoid_f32(q == 2 ? 2.0f * z : z);
    const float act = q == 2 ? 2.0f * sg - 1.0f : sg;
    const float gi = __shfl_sync(0xffffffffu, act, lane0);
    const float gf = __shfl_sync(0xffffffffu, act, lane0 + 2);
    const float gg = __shfl_sync(0xffffffffu, act, lane0 + 4);
    const float go = __shfl_sync(0xffffffffu, act, lane0 + 6);
    c = first ? gi * gg : gf * c + gi * gg;
    const float h = go * tanhf(c);
    if (write && p == 0) *hout = h;
}

__global__ void __launch_bounds__(kRegMaxThreads, 1)
attn_lstm_seq_reg_kernel(Leaves L, const float* __restrict__ xs,
                         float* __restrict__ out, int G, int N, int W, int M,
                         int H, int n_out, int shared_weights,
                         unsigned bulk_mask) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
    const int p = lane & 7;                    // inputs k = p + 8m
    const int lane0 = lane & ~7;
    const int j = warp * 4 + (lane >> 3);      // hidden unit
    const bool unit_ok = j < H;
    const int jj = unit_ok ? j : 0;
    // the gate this lane holds after the reduction
    const int q = ((p >> 2) & 1) * 2 + ((p >> 1) & 1);
    const Items it(G, N, shared_weights);      // an item is a row
    if (it.n_items == 0) return;

    const int H4 = 4 * H, Hp = (int)pad4(H), K1 = M + H;
    const int n[9] = {M * H4, H * H4, H4, H * H, H * H4, H * H4, H4,
                      H * n_out, n_out};
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    uint64_t* bar_s1 = bars;
    uint64_t* bar_s2 = bars + 1;
    uint64_t* bar_x = bars + 2;
    // one base and 32-bit offsets (in floats): few registers stay live.
    // [Wx; Wh] of each layer lie back to back (M * 4H and H * 4H are
    // multiples of 4), a (K, 4H) matrix at o_s1 and o_s2
    float* const sm = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
    const int o_b1 = (int)(pad4(n[0]) + pad4(n[1]));
    const int o_wa = o_b1 + (int)pad4(n[2]);
    const int o_s2 = o_wa + (int)pad4(n[3]);
    const int o_b2 = o_s2 + (int)(pad4(n[4]) + pad4(n[5]));
    const int o_wo = o_b2 + (int)pad4(n[6]), o_bo = o_wo + (int)pad4(n[7]);
    const int o_u1 = o_bo + (int)pad4(n[8]);   // (W + 1, 56)
    const int o_u2 = o_u1 + (W + 1) * kRegK1;  // (W, 104)
    const int o_hf = o_u2 + W * kRegK2;        // (Hp) LSTM-2's last h
    const int o_q = o_hf + Hp;                 // (Hp)
    const int o_sc = o_q + Hp;                 // (32)
    const int o_awa = o_sc + 32;               // (H, H)
    const int o_awo = o_awa + (int)pad4(n[3]); // (H, n_out)
    const int o_abo = o_awo + (int)pad4(n[7]); // (n_out)

    if (tid == 0) {
        mbar_init(bar_s1, nthr + 1);
        mbar_init(bar_s2, nthr + 1);
        mbar_init(bar_x, nthr);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the inputs' padding and h(-1) = 0 stay zero: nothing else writes them
    for (int e = tid; e < o_hf - o_u1; e += nthr) sm[o_u1 + e] = 0.0f;
    __syncthreads();

    // the window of item k into U1's x slots
    auto issue_row = [&](long long k) {
        long long g, i;
        int row;
        bool first, last;
        it.of(k, g, row, i, first, last);
        const float* x = xs + (g * N + row) * (long long)(W * M);
        for (int e = tid; e < W * M; e += nthr) {
            const int t = e / M;
            copy4_async(sm + o_u1 + t * kRegK1 + e - t * M, x + e);
        }
        cp_async_arrive(bar_x);
    };

    issue_row(0);
    issue_stage(L, n, 0, 4, it.weights(0), sm, bulk_mask, bar_s1, tid, nthr);
    issue_stage(L, n, 4, 9, it.weights(0), sm + o_s2, bulk_mask, bar_s2, tid,
                nthr);

    float c = 0.0f;
    const float scale = (float)(1.0 / sqrt((double)H));
    for (long long k = 0; k < it.n_items; ++k) {
        long long g, i;
        int row;
        bool first, last;
        it.of(k, g, row, i, first, last);
        if (first) {
            mbar_wait(bar_s1, (uint32_t)(i & 1));
            for (int e = tid; e < n[3]; e += nthr)
                sm[o_awa + e] = sm[o_wa + e];
        }
        mbar_wait(bar_x, (uint32_t)(k & 1));
        // LSTM-1's weights into registers; stage 1 is then free
        float w1[kRegKM1][4];
        load_columns<kRegKM1>(w1, sm + jj, p, K1, H, unit_ok);
        const float b1q = unit_ok ? sm[o_b1 + q * H + j] : 0.0f;
        __syncthreads();                       // stage 1 read; Wa, x in place
        if (last && i + 1 < it.n_tg)
            issue_stage(L, n, 0, 4, it.weights(i + 1), sm, bulk_mask, bar_s1,
                        tid, nthr);

        // ---- LSTM-1: row t of U1 holds x_t and h(t-1); h(t) to row t + 1
        for (int t = 0; t < W; ++t) {
            reg_step<kRegKM1>(sm + o_u1 + t * kRegK1, w1, b1q, c, t == 0, p,
                              q, lane0, sm + o_u1 + (t + 1) * kRegK1 + M + jj,
                              unit_ok);
            __syncthreads();                   // h(t) visible
        }
        if (k + 1 < it.n_items) issue_row(k + 1);

        // ---- attention: q = h(W-1) @ Wa on the lanes of each unit
        {
            const float* hl = sm + o_u1 + W * kRegK1 + M;
            float acc = 0.0f;
            for (int kk = p; kk < H; kk += kRegParts)
                acc = fmaf(hl[kk], sm[o_awa + kk * H + jj], acc);
            acc += __shfl_xor_sync(0xffffffffu, acc, 4);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            if (p == 0 && unit_ok) sm[o_q + j] = acc;
        }
        __syncthreads();
        // the scores, a warp a time step
        for (int t = warp; t < W; t += nwarps) {
            const float* ht = sm + o_u1 + (t + 1) * kRegK1 + M;
            float s = 0.0f;
            for (int kk = lane; kk < H; kk += 32)
                s = fmaf(ht[kk], sm[o_q + kk], s);
            s = warp_sum(s);
            if (lane == 0) sm[o_sc + t] = s * scale;
        }
        __syncthreads();
        // the softmax over the window (W <= 32), one warp
        if (warp == 0) {
            const float v = lane < W ? sm[o_sc + lane] : -INFINITY;
            float mx = v;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float e = lane < W ? expf(v - mx) : 0.0f;
            const float sum = warp_sum(e);
            if (lane < W) sm[o_sc + lane] = e / sum;
        }
        __syncthreads();
        // ctx_t = alpha_t * h(t) into U2, a warp a time step
        for (int t = warp; t < W; t += nwarps) {
            const float a_t = sm[o_sc + t];
            for (int kk = lane; kk < H; kk += 32)
                sm[o_u2 + t * kRegK2 + kk] =
                    a_t * sm[o_u1 + (t + 1) * kRegK1 + M + kk];
        }
        if (first) {
            mbar_wait(bar_s2, (uint32_t)(i & 1));
            for (int e = tid; e < n[7]; e += nthr)
                sm[o_awo + e] = sm[o_wo + e];
            for (int e = tid; e < n_out; e += nthr)
                sm[o_abo + e] = sm[o_bo + e];
        }
        // LSTM-2's weights into registers; stage 2 is then free
        float w2[kRegKM2][4];
        load_columns<kRegKM2>(w2, sm + o_s2 + jj, p, 2 * H, H, unit_ok);
        const float b2q = unit_ok ? sm[o_b2 + q * H + j] : 0.0f;
        __syncthreads();                       // ctx in U2; stage 2 read
        if (last && i + 1 < it.n_tg)
            issue_stage(L, n, 4, 9, it.weights(i + 1), sm + o_s2, bulk_mask,
                        bar_s2, tid, nthr);

        // ---- LSTM-2: row t of U2 holds ctx_t and h2(t-1); the last h to hf
        for (int t = 0; t < W; ++t) {
            const bool last_t = t + 1 == W;
            reg_step<kRegKM2>(sm + o_u2 + t * kRegK2, w2, b2q, c, t == 0, p,
                              q, lane0,
                              sm + (last_t ? o_hf : o_u2 + (t + 1) * kRegK2
                                                    + H) + jj,
                              unit_ok);
            __syncthreads();
        }

        // ---- the head: relu(h) @ Wo + bo, a warp an output
        for (int o = warp; o < n_out; o += nwarps) {
            float s = 0.0f;
            for (int kk = lane; kk < H; kk += 32)
                s = fmaf(fmaxf(sm[o_hf + kk], 0.0f),
                         sm[o_awo + kk * n_out + o], s);
            s = warp_sum(s);
            if (lane == 0) out[(g * N + row) * n_out + o] = s + sm[o_abo + o];
        }
        __syncthreads();                       // scratch and aux free
    }
}

template <int RT>
cudaError_t launch_tiled(const Leaves& L, const float* xs, float* out,
                         int G, int N, int W, int M, int H, int n_out,
                         int shared, unsigned bulk_mask, int grid,
                         cudaStream_t stream) {
    const int threads = (4 * H + 31) / 32 * 32;
    attn_lstm_seq_tiled_kernel<RT>
        <<<grid, threads, (size_t)tiled_smem(M, H, W, n_out, RT), stream>>>(
            L, xs, out, G, N, W, M, H, n_out, shared, bulk_mask);
    return cudaGetLastError();
}

Leaves leaves_of(const void* Wx1, const void* Wh1, const void* b1,
                 const void* Wa, const void* Wx2, const void* Wh2,
                 const void* b2, const void* Wo, const void* bo) {
    return Leaves{{(const float*)Wx1, (const float*)Wh1, (const float*)b1,
                   (const float*)Wa, (const float*)Wx2, (const float*)Wh2,
                   (const float*)b2, (const float*)Wo, (const float*)bo}};
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA of each kernel needs: the general
// kernel with `rows` rows, the tiled kernel with `rows` rows an item, the
// register kernel.
long long attn_lstm_seq_general_smem_bytes(int M, int H, int W, int n_out,
                                           int rows) {
    return 4LL * (weight_region(M, H, n_out) + (long long)rows
                  * row_floats(W, H));
}

long long attn_lstm_seq_tiled_smem_bytes(int M, int H, int W, int n_out,
                                         int rows) {
    return tiled_smem(M, H, W, n_out, rows);
}

long long attn_lstm_seq_reg_smem_bytes(int M, int H, int W, int n_out) {
    return reg_smem(M, H, W, n_out);
}

// Lets every kernel of the library use all of a CTA's shared memory on
// the current device: once per device, before the first launch there.
int attn_lstm_seq_prepare(void) {
    const void* fns[] = {(const void*)attn_lstm_seq_general_kernel,
                         (const void*)attn_lstm_seq_reg_kernel,
                         (const void*)attn_lstm_seq_tiled_kernel<1>,
                         (const void*)attn_lstm_seq_tiled_kernel<2>,
                         (const void*)attn_lstm_seq_tiled_kernel<4>,
                         (const void*)attn_lstm_seq_tiled_kernel<8>,
                         (const void*)attn_lstm_seq_tiled_kernel<12>};
    for (const void* f : fns) {
        const cudaError_t err = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// Launches the general kernel on `stream`: one CTA per (group, block of
// `rows` rows), threads_x the hidden width rounded up to a warp.  Weights
// are (G, ...) or, with shared_weights=1, one set read by every group.
// Returns the CUDA error code of the launch (0 = launched).
int attn_lstm_seq_general_f32(const void* Wx1, const void* Wh1,
                              const void* b1, const void* Wa,
                              const void* Wx2, const void* Wh2,
                              const void* b2, const void* Wo, const void* bo,
                              const void* xs, void* out, int G, int N, int W,
                              int M, int H, int n_out, int shared_weights,
                              int threads_x, int rows, void* stream) {
    const long long smem = attn_lstm_seq_general_smem_bytes(M, H, W, n_out,
                                                            rows);
    const dim3 grid((unsigned)G, (unsigned)((N + rows - 1) / rows));
    const dim3 block((unsigned)threads_x, (unsigned)rows);
    attn_lstm_seq_general_kernel<<<grid, block, (size_t)smem,
                                   (cudaStream_t)stream>>>(
        (const float*)Wx1, (const float*)Wh1, (const float*)b1,
        (const float*)Wa, (const float*)Wx2, (const float*)Wh2,
        (const float*)b2, (const float*)Wo, (const float*)bo,
        (const float*)xs, (float*)out, N, W, M, H, n_out, shared_weights);
    return (int)cudaGetLastError();
}

// Launches the tiled kernel with `rows` (1, 2, 4, 8 or 12) rows an item
// on `stream`: `grid` persistent CTAs of 4H threads rounded up to a warp
// (4H <= 256).  Bit l of bulk_mask sends leaf l (Wx1, Wh1, b1, Wa, Wx2,
// Wh2, b2, Wo, bo) by bulk copy; the caller sets it only where the leaf's
// base address is 16-byte aligned and its size a multiple of 16 bytes.
// Returns the CUDA error code of the launch (0 = launched; invalid value
// for a rows count without a kernel).
int attn_lstm_seq_tiled_f32(const void* Wx1, const void* Wh1, const void* b1,
                            const void* Wa, const void* Wx2, const void* Wh2,
                            const void* b2, const void* Wo, const void* bo,
                            const void* xs, void* out, int G, int N, int W,
                            int M, int H, int n_out, int shared_weights,
                            int rows, int bulk_mask, int grid, void* stream) {
    const Leaves L = leaves_of(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo);
    const float* x = (const float*)xs;
    float* o = (float*)out;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned m = (unsigned)bulk_mask;
    switch (rows) {
    case 1: return (int)launch_tiled<1>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, m, grid, s);
    case 2: return (int)launch_tiled<2>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, m, grid, s);
    case 4: return (int)launch_tiled<4>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, m, grid, s);
    case 8: return (int)launch_tiled<8>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, m, grid, s);
    case 12: return (int)launch_tiled<12>(L, x, o, G, N, W, M, H, n_out,
                                          shared_weights, m, grid, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// Launches the register kernel on `stream`: `grid` persistent CTAs of
// 32 * ceil(H / 4) threads, one row an item; H <= 52, M + H <= 56 and
// W <= 32 (invalid value otherwise); bulk_mask as for the tiled kernel.
int attn_lstm_seq_reg_f32(const void* Wx1, const void* Wh1, const void* b1,
                          const void* Wa, const void* Wx2, const void* Wh2,
                          const void* b2, const void* Wo, const void* bo,
                          const void* xs, void* out, int G, int N, int W,
                          int M, int H, int n_out, int shared_weights,
                          int bulk_mask, int grid, void* stream) {
    if (H < 1 || 2 * H > kRegK2 || M + H > kRegK1 || W > 32)
        return (int)cudaErrorInvalidValue;
    attn_lstm_seq_reg_kernel<<<grid, 32 * ((H + 3) / 4),
                               (size_t)reg_smem(M, H, W, n_out),
                               (cudaStream_t)stream>>>(
        leaves_of(Wx1, Wh1, b1, Wa, Wx2, Wh2, b2, Wo, bo), (const float*)xs,
        (float*)out, G, N, W, M, H, n_out, shared_weights,
        (unsigned)bulk_mask);
    return (int)cudaGetLastError();
}

const char* attn_lstm_seq_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
