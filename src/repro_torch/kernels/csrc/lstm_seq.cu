// Grouped whole-window LSTM + ReLU-dense head, and the one-step LSTM cell,
// for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * lstm_seq          (src/repro/kernels/lstm_seq.py, _seq_pallas /
//                        _seq_kernel, shared weights: every fit forward and
//                        predict_batch);
//   * lstm_seq_stacked  (the same file, _seq_stacked_pallas /
//                        _seq_stacked_kernel, one set of weights per row:
//                        the plane's per-target forecast);
//   * lstm_cell         (src/repro/kernels/lstm_cell.py, _kernel: one step,
//                        h and c in and out; the benchmark's per-step lane
//                        vmaps it over Z targets);
// and the vmap of lstm_seq over Z targets in the batched refit
// (src/repro/core/forecaster.py, _lstm_fit_stacked).  The sequence is one
// grouped forward: weights with a leading group axis G (group stride 0 when
// every group shares one set), windows xs (G, N, W, M) -> (G, N, n_out).
// lstm_seq is G=1, N=B; lstm_seq_stacked is G=Z, N=1; the refit is G=Z, N
// windows.  The cell is the same forward at W=1 with h and c read from
// memory and written back, and no head: x (G, N, In), h, c (G, N, H).
//
// What bounds each regime on an H100 (f32 on CUDA cores):
//   * the per-target forecast (G=Z, N=1) reads each target's weights once,
//     (M + H + 1) * 4H + (H + 1) * n_out floats = 45,820 B at H=50, M=5, for
//     0.07 MFLOP of work: bound by bytes (Z=4096: ~188 MB, ~56 us at 3.35
//     TB/s), so a target's bytes must stream into each SM while it computes
//     the one before.  The lane's cell step is the same at W=1 (44,800 B a
//     target, ~55 us a step).
//   * the grouped refit forward (G=Z, N=16) does 16x the arithmetic on the
//     same bytes: ~4.8 GFLOP at Z=4096, ~71 us at 67 TFLOP/s, bound by
//     operations, and so by how many instructions each FMA drags along.
//   * the shared-weight fits (G=1, N~115) and the cell at B=5 are bound by
//     latency: W dependent recurrent steps, and a launch.
//
// Three kernels (two for the cell), which the wrapper's launch_plan picks
// by a cost per work item measured on the card:
//   * lstm_seq_grouped_reg_kernel (and lstm_cell_grouped_reg_kernel, the
//     same body with the compile-time flag kCell): one row an item, the
//     weights in registers; the per-target forecast, the fits, the cell;
//   * lstm_seq_grouped_tiled_kernel<RT>: a thread owns the four gate columns
//     of one hidden unit for RT rows, the weights resident in shared memory;
//     the refit;
//   * lstm_seq_grouped_general_kernel and lstm_cell_grouped_general_kernel,
//     the first ports' kernels, for shapes neither new kernel takes (H > 52
//     for the register kernel, stages that do not fit).
//
// Both new kernels run persistent CTAs (grid <= SMs x CTAs an SM) that walk
// work items: with weights per group, the groups g = blockIdx.x + i *
// gridDim.x and each group's items, or, where there are fewer groups than
// CTAs, each group's items spread over the grid / G CTAs of that group
// (struct Items); with shared weights, the items of all groups, the one
// weight set copied once.  A group's weights (its "stage":
// Wx, Wh, b, Wo, bo, each padded to 16 bytes; Wx and Wh back to back form
// the stacked (M + H, 4H) matrix) land in one of `slots` stage slots, each
// with its own mbarrier; target i uses slot i % slots at parity
// (i / slots) & 1, and the copy of target i + slots is issued into the
// slot as soon as target i is done with it, so it lands while targets
// i + 1 ... compute.  The window rows of the next item are prefetched the
// same way (one more mbarrier).
//   Copies: one thread issues, for each leaf whose bit is set in bulk_mask,
// one cp.async.bulk (global -> shared, completion counted in bytes on the
// slot's mbarrier); no thread spends registers or issue slots on those
// bytes.  A bulk copy needs a 16-byte-aligned source and destination and a
// size that is a multiple of 16 bytes; the wrapper sets a leaf's bit only
// where its base address is 16-byte aligned and its size is a multiple of
// 16 bytes, so that every group's copy is aligned too.  The other leaves (Wo
// and bo at H=50, n_out=5) and the window rows go 4 bytes a thread by
// cp.async, which every thread then ties to the same mbarrier
// (cp.async.mbarrier.arrive.noinc): a slot's mbarrier expects blockDim.x + 1
// arrivals and the bulk bytes.
//   Reuse of a slot: all reads of it end at a __syncthreads(), then the
// issuing thread runs fence.proxy.async.shared::cta before the bulk copy, so
// the async proxy's writes are ordered after the generic proxy's reads.
//
// The register kernel: eight lanes a hidden unit (32 * ceil(H / 4)
// threads, H <= 52, M + H <= 56); lane p of unit j holds the four gate
// columns j, H+j, 2H+j, 3H+j of rows k = p + 8m of the stacked [Wx; Wh],
// loaded from the slot when a target starts (the slot is then free again,
// so the next copy is issued at once).  A step: each lane sums its rows
// against the inputs (one broadcast shared-memory load feeds four FMAs),
// three butterfly shuffles reduce the 4 x 8 partial sums so that each lane
// ends with one gate, each lane applies one sigmoid (the g gate's tanh as
// 2 s(2z) - 1), four shuffles gather i, f, g, o and every lane updates c;
// lane 0 writes h.  One barrier a step.  With shared weights the registers
// are loaded once per CTA.  The head (relu(h) @ Wo + bo) runs a warp an
// output from a copy of Wo and bo taken before the slot is reissued.
// The tiled kernel: thread (rg, j) owns the four gate columns of unit j for
// the RT rows of row group rg, so one weight load feeds RT FMAs and one
// 16-byte load of a row's h feeds sixteen; the gates, c (in registers) and
// h stay with the thread, h goes to a double-buffered shared array: one
// barrier a step.  Neighbouring units load neighbouring weight words.
//
// Numerics: expf/tanhf (no fast-math).  A gate sum is the input segment's
// products plus the recurrent segment's (summed in another order than the
// plain version's matmuls: the tolerance against it is 1e-4), then the
// bias; h(-1) = c(-1) = 0 for the sequence, so step 0 adds exact zeros
// (finite weights) or skips h.Wh.  The register kernel's tanh of the g gate
// is the exact identity 2 sigmoid(2z) - 1 in f32 (within a few 1e-7 of
// tanhf).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;      // dynamic shared memory of a CTA
constexpr int kMaxSlots = 3;          // weight-stage slots of a CTA
constexpr int kBarrierBytes = 128;    // the slots' and the window's mbarriers

__host__ __device__ __forceinline__ long long pad4(long long n) {
    return (n + 3) & ~3LL;
}

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------------ the general kernels
// The first port's sequence kernel: one CTA per (group, block of R rows); thread
// (j, r) owns hidden unit j of row r and computes its four gate
// pre-activations at columns j, H+j, 2H+j, 3H+j from the weights its CTA
// copied into shared memory; h lives in shared memory and c in a register
// across all W steps.
__global__ void __launch_bounds__(1024)
lstm_seq_grouped_general_kernel(const float* __restrict__ Wx,
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

// The first port's cell kernel: one CTA per (group, block of R rows) copies its
// group's weights and its rows' x and h into shared memory; thread (j, r)
// owns hidden unit j of row r.
__global__ void __launch_bounds__(1024)
lstm_cell_grouped_general_kernel(const float* __restrict__ Wx,
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

// ------------------------------------------- copies for the new kernels
// (the attention LSTM's helpers, csrc/attn_lstm_seq.cu)
struct Leaves {
    const float* p[5];   // Wx, Wh, b, Wo, bo (the cell: Wx, Wh, b)
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

// Copies the first `nl` leaves of weight set wg into dst, each leaf padded
// to 16 bytes: a leaf with its bit in bulk_mask by one bulk copy that
// thread 0 issues, the others 4 bytes a thread by cp.async.  Called by
// every thread of the CTA, after the __syncthreads() that ended the last
// reads of dst.
__device__ __forceinline__ void issue_stage(const Leaves& L, const int* n,
                                            int nl, long long wg, float* dst,
                                            unsigned bulk_mask, uint64_t* bar,
                                            int tid, int nthr) {
    if (tid == 0) {
        uint32_t bytes = 0;
        for (int l = 0; l < nl; ++l)
            if ((bulk_mask >> l) & 1) bytes += 4u * (uint32_t)n[l];
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
        // the generic proxy's reads of dst end before the async proxy's
        // writes begin
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        float* d = dst;
        for (int l = 0; l < nl; ++l) {
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
    for (int l = 0; l < nl; ++l) {
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

// Work items of a CTA of the persistent grid, in one of three modes:
//   * shared weights: the items of all groups (one weight set, "target" 0);
//   * weights per group, no fewer groups than CTAs: this CTA's groups
//     (targets) g = cta + i * grid, times `per_group` items each;
//   * weights per group, fewer groups than CTAs ("split", grid > G): group g
//     gets grid / G CTAs (the first grid % G groups one more); each loads
//     its group's weights once, as its only target, and walks the group's
//     items sub, sub + ctas, ... (sub: its rank among the group's CTAs).
//     A few groups of many items (an ensemble's E members x Z targets) then
//     fill the grid instead of running on G CTAs.
struct Items {
    long long cta, grid, n_tg, n_items;
    long long group, sub, ctas;   // split mode: the group, rank, CTAs of it
    int per_group, shared;
    bool split;

    __device__ Items(int G, int per_group_, int shared_)
        : cta(blockIdx.x), grid(gridDim.x), group(0), sub(0), ctas(1),
          per_group(per_group_), shared(shared_),
          split(!shared_ && (long long)gridDim.x > G) {
        if (shared) {
            const long long total = (long long)G * per_group;
            n_items = total > cta ? (total - cta + grid - 1) / grid : 0;
            n_tg = n_items > 0;
        } else if (split) {
            const long long base = grid / G, rem = grid - base * G;
            const long long wide = rem * (base + 1);   // the first rem groups'
            if (cta < wide) {
                ctas = base + 1;
                group = cta / ctas;
                sub = cta - group * ctas;
            } else {
                ctas = base;
                group = rem + (cta - wide) / base;
                sub = cta - wide - (group - rem) * base;
            }
            n_items = per_group > sub ? (per_group - sub + ctas - 1) / ctas
                                      : 0;
            n_tg = n_items > 0;
        } else {
            n_tg = G > cta ? (G - cta + grid - 1) / grid : 0;
            n_items = n_tg * per_group;
        }
    }
    // the weight set of target i
    __device__ long long weights(long long i) const {
        return shared ? 0 : split ? group : cta + i * grid;
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
        } else if (split) {
            g = group;
            b = (int)(sub + k * ctas);
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

// Floats of one weight stage: Wx, Wh, b (and for the sequence Wo, bo), each
// padded to 16 bytes.
__host__ __device__ __forceinline__ long long stage_floats(int M, int H,
                                                           int n_out,
                                                           bool cell) {
    const long long H4 = 4LL * H;
    const long long s = pad4(M * H4) + pad4(H * H4) + pad4(H4);
    return cell ? s : s + pad4((long long)H * n_out) + pad4(n_out);
}

// ----------------------------------------------------- the register kernel
constexpr int kRegParts = 8;                  // lanes a hidden unit
constexpr int kRegKM = 7;                     // inputs a lane
constexpr int kRegK = kRegParts * kRegKM;     // M + H <= 56
constexpr int kRegMaxThreads = 416;           // 32 * ceil(52 / 4)
constexpr int kRegMinCtas = 2;                // CTAs an SM (registers)

// The register kernel's shared memory: the barriers, `slots` stages, the
// inputs (W + 1, 56) -- row t holds x_t and h(t-1), row W holds h(W-1) --
// and, for the sequence, the copy of Wo and bo.
__host__ __device__ __forceinline__ long long reg_smem(int M, int H, int W,
                                                       int n_out, int slots,
                                                       bool cell) {
    const long long aux = cell ? 0
        : pad4((long long)H * n_out) + pad4(n_out);
    return kBarrierBytes
           + 4 * (slots * stage_floats(M, H, n_out, cell)
                  + (W + 1LL) * kRegK + aux);
}

// w[m][g] = W[p + 8m][g * H + j] of the K x 4H matrix W at `base` (rows
// p + 8m >= K, and every row where `ok` is false, take 0): a lane's four
// gate columns of every eighth row of the stacked input and recurrent
// weights, kept in registers.  Every load reads a row inside W (the index
// is clamped), so none needs a branch.
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
// gather the gates, and every lane updates c (c = i g where `first`, c(-1)
// being 0) and returns h.  Every lane of the warp calls it (full-mask
// shuffles).
template <int KM>
__device__ __forceinline__ float reg_step(const float* in,
                                          const float (&w)[KM][4], float bq,
                                          float& c, bool first, int p, int q,
                                          int lane0) {
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
    return go * tanhf(c);
}

// The register kernel's body.  The sequence (kCell false): xs (G, N, W, M)
// -> out (G, N, n_out).  The cell (kCell true): x = xs (G, N, M), h_in and
// c_in (G, N, H) -> h into out, c into c_out; W = 1, no head.
template <bool kCell>
__device__ __forceinline__ void reg_body(const Leaves& L,
                                         const float* __restrict__ xs,
                                         const float* __restrict__ h_in,
                                         const float* __restrict__ c_in,
                                         float* __restrict__ out,
                                         float* __restrict__ c_out, int G,
                                         int N, int W, int M, int H,
                                         int n_out, int shared_weights,
                                         int slots, unsigned bulk_mask) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    constexpr int NL = kCell ? 3 : 5;          // leaves of a stage
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

    const int H4 = 4 * H, K = M + H;
    const int n[5] = {M * H4, H * H4, H4, H * n_out, n_out};
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    uint64_t* bar_x = bars + kMaxSlots;
    // one base and 32-bit offsets (in floats): few registers stay live
    float* const sm = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
    const int sf = (int)stage_floats(M, H, n_out, kCell);
    const int o_b = (int)(pad4(n[0]) + pad4(n[1]));   // within a slot
    const int o_wo = o_b + (int)pad4(n[2]), o_bo = o_wo + (int)pad4(n[3]);
    const int o_u = slots * sf;                // (W + 1, 56)
    const int o_awo = o_u + (W + 1) * kRegK;   // (H, n_out) Wo's copy
    const int o_abo = o_awo + (int)pad4(n[3]); // (n_out)

    if (tid == 0) {
        for (int s = 0; s < slots; ++s) mbar_init(bars + s, nthr + 1);
        mbar_init(bar_x, nthr);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the inputs' padding and h(-1) = 0 stay zero: nothing else writes them
    for (int e = tid; e < (W + 1) * kRegK; e += nthr) sm[o_u + e] = 0.0f;
    __syncthreads();

    // the inputs of item k into row 0 (the cell: x and h) or into the x
    // slots of rows 0 .. W-1 (the sequence's window)
    auto issue_row = [&](long long k) {
        long long g, i;
        int row;
        bool first, last;
        it.of(k, g, row, i, first, last);
        const long long r = g * N + row;
        if constexpr (kCell) {
            for (int e = tid; e < K; e += nthr)
                copy4_async(sm + o_u + e,
                            e < M ? xs + r * M + e : h_in + r * H + e - M);
        } else {
            const float* x = xs + r * (long long)(W * M);
            for (int e = tid; e < W * M; e += nthr) {
                const int t = e / M;
                copy4_async(sm + o_u + t * kRegK + e - t * M, x + e);
            }
        }
        cp_async_arrive(bar_x);
    };

    issue_row(0);
    for (int s = 0; s < slots && s < it.n_tg; ++s)
        issue_stage(L, n, NL, it.weights(s), sm + s * sf, bulk_mask, bars + s,
                    tid, nthr);

    float w[kRegKM][4];
    float bq = 0.0f;
    for (long long k = 0; k < it.n_items; ++k) {
        long long g, i;
        int row;
        bool first, last;
        it.of(k, g, row, i, first, last);
        if (first) {
            // target i's weights into registers; its slot is then free
            const int s = (int)(i % slots);
            float* st = sm + s * sf;
            mbar_wait(bars + s, (uint32_t)((i / slots) & 1));
            load_columns<kRegKM>(w, st + jj, p, K, H, unit_ok);
            bq = unit_ok ? st[o_b + q * H + j] : 0.0f;
            if constexpr (!kCell) {
                for (int e = tid; e < n[3]; e += nthr)
                    sm[o_awo + e] = st[o_wo + e];
                for (int e = tid; e < n_out; e += nthr)
                    sm[o_abo + e] = st[o_bo + e];
            }
            __syncthreads();                   // the slot read
            if (i + slots < it.n_tg)
                issue_stage(L, n, NL, it.weights(i + slots), st, bulk_mask,
                            bars + s, tid, nthr);
        }
        mbar_wait(bar_x, (uint32_t)(k & 1));
        const long long r = g * N + row;

        if constexpr (kCell) {
            float c = unit_ok ? __ldg(c_in + r * H + jj) : 0.0f;
            const float h = reg_step<kRegKM>(sm + o_u, w, bq, c, false, p, q,
                                             lane0);
            if (unit_ok && p == 0) {
                out[r * H + j] = h;
                c_out[r * H + j] = c;
            }
            __syncthreads();                   // row 0 read
            if (k + 1 < it.n_items) issue_row(k + 1);
        } else {
            // row t of the inputs holds x_t and h(t-1); h(t) to row t + 1
            float c = 0.0f;
            for (int t = 0; t < W; ++t) {
                const float h = reg_step<kRegKM>(sm + o_u + t * kRegK, w, bq,
                                                 c, t == 0, p, q, lane0);
                if (unit_ok && p == 0)
                    sm[o_u + (t + 1) * kRegK + M + j] = h;
                __syncthreads();               // h(t) visible
            }
            if (k + 1 < it.n_items) issue_row(k + 1);
            // the head: relu(h(W-1)) @ Wo + bo, a warp an output
            for (int o = warp; o < n_out; o += nwarps) {
                float s = 0.0f;
                for (int kk = lane; kk < H; kk += 32)
                    s = fmaf(fmaxf(sm[o_u + W * kRegK + M + kk], 0.0f),
                             sm[o_awo + kk * n_out + o], s);
                s = warp_sum(s);
                if (lane == 0) out[r * n_out + o] = s + sm[o_abo + o];
            }
            __syncthreads();                   // h(W-1) and the copy read
        }
    }
}

__global__ void __launch_bounds__(kRegMaxThreads, kRegMinCtas)
lstm_seq_grouped_reg_kernel(Leaves L, const float* __restrict__ xs,
                            float* __restrict__ out, int G, int N, int W,
                            int M, int H, int n_out, int shared_weights,
                            int slots, unsigned bulk_mask) {
    reg_body<false>(L, xs, nullptr, nullptr, out, nullptr, G, N, W, M, H,
                    n_out, shared_weights, slots, bulk_mask);
}

__global__ void __launch_bounds__(kRegMaxThreads, kRegMinCtas)
lstm_cell_grouped_reg_kernel(Leaves L, const float* __restrict__ x,
                             const float* __restrict__ h,
                             const float* __restrict__ c,
                             float* __restrict__ h_out,
                             float* __restrict__ c_out, int G, int N, int In,
                             int H, int shared_weights, int slots,
                             unsigned bulk_mask) {
    reg_body<true>(L, x, h, c, h_out, c_out, G, N, 1, In, H, 0,
                   shared_weights, slots, bulk_mask);
}

// -------------------------------------------------------- the tiled kernel
constexpr int kTiledMaxThreads = 256;
constexpr int kTiledMinCtas = 2;

// The tiled kernel's shared memory for `rows` rows an item: the barriers,
// `slots` stages, the window (rows, W, Mp) and h, double-buffered (2, rows,
// Hp).
__host__ __device__ __forceinline__ long long tiled_smem(int M, int H, int W,
                                                         int n_out, int rows,
                                                         int slots) {
    return kBarrierBytes
           + 4 * (slots * stage_floats(M, H, n_out, false)
                  + (long long)rows * W * pad4(M) + 2LL * rows * pad4(H));
}

template <int RT>
__global__ void __launch_bounds__(kTiledMaxThreads, kTiledMinCtas)
lstm_seq_grouped_tiled_kernel(Leaves L, const float* __restrict__ xs,
                              float* __restrict__ out, int G, int N, int W,
                              int M, int H, int n_out, int shared_weights,
                              int groups, int slots, unsigned bulk_mask) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int R = RT * groups;                 // rows an item
    const Items it(G, (N + R - 1) / R, shared_weights);
    if (it.n_items == 0) return;

    const int H4 = 4 * H, Mp = (int)pad4(M), Hp = (int)pad4(H);
    const int n[5] = {M * H4, H * H4, H4, H * n_out, n_out};
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    uint64_t* bar_x = bars + kMaxSlots;
    float* const sm = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
    const int sf = (int)stage_floats(M, H, n_out, false);
    float* const xw = sm + slots * sf;         // (R, W, Mp)
    float* const hb = xw + R * W * Mp;         // (2, R, Hp)
    const int rg = tid / H, j = tid - rg * H;  // row group, hidden unit
    const bool active = rg < groups;

    if (tid == 0) {
        for (int s = 0; s < slots; ++s) mbar_init(bars + s, nthr + 1);
        mbar_init(bar_x, nthr);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // h(-1) = 0 is what a window of no step (W = 0) leaves for the head
    for (int e = tid; e < 2 * R * Hp; e += nthr) hb[e] = 0.0f;
    __syncthreads();

    // the window rows of item k into xw (rows past N zero-filled)
    auto issue_rows = [&](long long k) {
        long long g, i;
        int rb;
        bool first, last;
        it.of(k, g, rb, i, first, last);
        const int WM = W * M;
        for (int e = tid; e < R * WM; e += nthr) {
            const int r = e / WM, rem = e - r * WM;
            const int t = rem / M, m = rem - t * M;
            const long long row = (long long)rb * R + r;
            float* dst = xw + (r * W + t) * Mp + m;
            if (row < N) copy4_async(dst, xs + (g * N + row) * WM + rem);
            else *dst = 0.0f;
        }
        cp_async_arrive(bar_x);
    };

    issue_rows(0);
    for (int s = 0; s < slots && s < it.n_tg; ++s)
        issue_stage(L, n, 5, it.weights(s), sm + s * sf, bulk_mask, bars + s,
                    tid, nthr);

    for (long long k = 0; k < it.n_items; ++k) {
        long long g, i;
        int rb;
        bool first, last;
        it.of(k, g, rb, i, first, last);
        const int s = (int)(i % slots);
        float* const st = sm + s * sf;
        const float* sWx = st;
        const float* sWh = sWx + pad4(n[0]);
        const float* sb = sWh + pad4(n[1]);
        const float* sWo = sb + pad4(n[2]);
        const float* sbo = sWo + pad4(n[3]);
        if (first) mbar_wait(bars + s, (uint32_t)((i / slots) & 1));
        mbar_wait(bar_x, (uint32_t)(k & 1));
        __syncthreads();                       // zero-filled rows visible

        float c[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) c[r] = 0.0f;
        for (int t = 0; t < W; ++t) {
            if (active) {
                float acc[RT][4];
#pragma unroll
                for (int r = 0; r < RT; ++r)
                    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
                const float* xr = xw + (rg * RT * W + t) * Mp;
                for (int m = 0; m < M; ++m) {
                    const float* wm = sWx + m * H4 + j;
                    const float w0 = wm[0], w1 = wm[H], w2 = wm[2 * H],
                                w3 = wm[3 * H];
#pragma unroll
                    for (int r = 0; r < RT; ++r) {
                        const float v = xr[r * W * Mp + m];
                        acc[r][0] = fmaf(v, w0, acc[r][0]);
                        acc[r][1] = fmaf(v, w1, acc[r][1]);
                        acc[r][2] = fmaf(v, w2, acc[r][2]);
                        acc[r][3] = fmaf(v, w3, acc[r][3]);
                    }
                }
                if (t > 0) {                   // h(-1) = 0: no product
                    const float* hp = hb + (((t - 1) & 1) * R + rg * RT) * Hp;
                    int kk = 0;
                    for (; kk + 4 <= H; kk += 4) {
                        float wq[4][4];
#pragma unroll
                        for (int a = 0; a < 4; ++a) {
                            const float* wk = sWh + (kk + a) * H4 + j;
                            wq[a][0] = wk[0];
                            wq[a][1] = wk[H];
                            wq[a][2] = wk[2 * H];
                            wq[a][3] = wk[3 * H];
                        }
#pragma unroll
                        for (int r = 0; r < RT; ++r) {
                            const float4 v = *reinterpret_cast<const float4*>(
                                hp + r * Hp + kk);
                            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                            for (int a = 0; a < 4; ++a)
#pragma unroll
                                for (int q = 0; q < 4; ++q)
                                    acc[r][q] = fmaf(vv[a], wq[a][q],
                                                     acc[r][q]);
                        }
                    }
                    for (; kk < H; ++kk) {
                        const float* wk = sWh + kk * H4 + j;
                        const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H],
                                    w3 = wk[3 * H];
#pragma unroll
                        for (int r = 0; r < RT; ++r) {
                            const float v = hp[r * Hp + kk];
                            acc[r][0] = fmaf(v, w0, acc[r][0]);
                            acc[r][1] = fmaf(v, w1, acc[r][1]);
                            acc[r][2] = fmaf(v, w2, acc[r][2]);
                            acc[r][3] = fmaf(v, w3, acc[r][3]);
                        }
                    }
                }
                const float bi = sb[j], bf = sb[H + j], bg = sb[2 * H + j],
                            bo_ = sb[3 * H + j];
                float* ho = hb + ((t & 1) * R + rg * RT) * Hp + j;
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    const float gi = sigmoid_f32(acc[r][0] + bi);
                    const float gf = sigmoid_f32(acc[r][1] + bf);
                    const float gg = tanhf(acc[r][2] + bg);
                    const float go = sigmoid_f32(acc[r][3] + bo_);
                    c[r] = t == 0 ? gi * gg : gf * c[r] + gi * gg;
                    ho[r * Hp] = go * tanhf(c[r]);
                }
            }
            __syncthreads();                   // h(t) visible
        }
        if (k + 1 < it.n_items) issue_rows(k + 1);

        // the head: relu(h(W-1)) @ Wo + bo, a thread a (row, output)
        const float* hl = hb + ((W - 1) & 1) * R * Hp;
        for (int e = tid; e < R * n_out; e += nthr) {
            const int r = e / n_out, o = e - r * n_out;
            const long long row = (long long)rb * R + r;
            if (row < N) {
                float acc = 0.0f;
                for (int kk = 0; kk < H; ++kk)
                    acc = fmaf(fmaxf(hl[r * Hp + kk], 0.0f),
                               sWo[kk * n_out + o], acc);
                out[(g * N + row) * n_out + o] = acc + sbo[o];
            }
        }
        __syncthreads();                       // the slot and h read
        if (last && i + slots < it.n_tg)
            issue_stage(L, n, 5, it.weights(i + slots), st, bulk_mask,
                        bars + s, tid, nthr);
    }
}

template <int RT>
cudaError_t launch_tiled(const Leaves& L, const float* xs, float* out,
                         int G, int N, int W, int M, int H, int n_out,
                         int shared, int groups, int slots, unsigned mask,
                         int grid, cudaStream_t stream) {
    const int threads = (H * groups + 31) / 32 * 32;
    lstm_seq_grouped_tiled_kernel<RT>
        <<<grid, threads,
           (size_t)tiled_smem(M, H, W, n_out, RT * groups, slots), stream>>>(
            L, xs, out, G, N, W, M, H, n_out, shared, groups, slots, mask);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA of each kernel needs: the register
// kernel with `slots` stage slots (cell = 1: the cell's, W = 1, M = In, no
// head), the tiled kernel with `rows` rows an item, the general kernels
// with `rows` rows a CTA.
long long lstm_seq_reg_smem_bytes(int M, int H, int W, int n_out, int slots,
                                  int cell) {
    return reg_smem(M, H, W, n_out, slots, cell != 0);
}

long long lstm_seq_tiled_smem_bytes(int M, int H, int W, int n_out, int rows,
                                    int slots) {
    return tiled_smem(M, H, W, n_out, rows, slots);
}

long long lstm_seq_general_smem_bytes(int M, int H, int n_out, int rows) {
    const long long H4 = 4LL * H;
    return 4LL * ((long long)M * H4 + (long long)H * H4 + H4
                  + (long long)H * n_out + n_out + (long long)rows * H);
}

long long lstm_cell_general_smem_bytes(int In, int H, int rows) {
    const long long H4 = 4LL * H;
    return 4LL * ((long long)In * H4 + (long long)H * H4 + H4
                  + (long long)rows * (H + In));
}

// Lets every kernel of the library use all of a CTA's shared memory on
// the current device: once per device, before the first launch there.
int lstm_seq_prepare(void) {
    const void* fns[] = {(const void*)lstm_seq_grouped_reg_kernel,
                         (const void*)lstm_cell_grouped_reg_kernel,
                         (const void*)lstm_seq_grouped_tiled_kernel<2>,
                         (const void*)lstm_seq_grouped_tiled_kernel<4>,
                         (const void*)lstm_seq_grouped_tiled_kernel<8>,
                         (const void*)lstm_seq_grouped_general_kernel,
                         (const void*)lstm_cell_grouped_general_kernel};
    for (const void* f : fns) {
        const cudaError_t err = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// Launches the register kernel on `stream`: `grid` persistent CTAs of
// 32 * ceil(H / 4) threads, one row an item, `slots` (1 to 3) weight-stage
// slots; H <= 52 and M + H <= 56 (invalid value otherwise).  Bit l of
// bulk_mask sends leaf l (Wx, Wh, b, Wo, bo) by bulk copy; the caller sets
// it only where the leaf's base address is 16-byte aligned and its size a
// multiple of 16 bytes.  Returns the CUDA error code of the launch (0 =
// launched).
int lstm_seq_reg_f32(const void* Wx, const void* Wh, const void* b,
                     const void* Wo, const void* bo, const void* xs,
                     void* out, int G, int N, int W, int M, int H, int n_out,
                     int shared_weights, int slots, int bulk_mask, int grid,
                     void* stream) {
    if (H < 1 || H > 52 || M + H > kRegK || slots < 1 || slots > kMaxSlots)
        return (int)cudaErrorInvalidValue;
    const Leaves L{{(const float*)Wx, (const float*)Wh, (const float*)b,
                    (const float*)Wo, (const float*)bo}};
    lstm_seq_grouped_reg_kernel<<<grid, 32 * ((H + 3) / 4),
                                  (size_t)reg_smem(M, H, W, n_out, slots,
                                                   false),
                                  (cudaStream_t)stream>>>(
        L, (const float*)xs, (float*)out, G, N, W, M, H, n_out,
        shared_weights, slots, (unsigned)bulk_mask);
    return (int)cudaGetLastError();
}

// Launches the tiled kernel with `rows` (2, 4 or 8) rows a thread and
// `groups` row groups an item on `stream`: `grid` persistent CTAs of
// H * groups threads rounded up to a warp (at most 256), `slots` weight-
// stage slots; bulk_mask as for the register kernel.  Returns the CUDA
// error code of the launch (0 = launched; invalid value for a rows count
// without a kernel).
int lstm_seq_tiled_f32(const void* Wx, const void* Wh, const void* b,
                       const void* Wo, const void* bo, const void* xs,
                       void* out, int G, int N, int W, int M, int H,
                       int n_out, int shared_weights, int rows, int groups,
                       int slots, int bulk_mask, int grid, void* stream) {
    if (H < 1 || groups < 1 || H * groups > kTiledMaxThreads || slots < 1
        || slots > kMaxSlots)
        return (int)cudaErrorInvalidValue;
    const Leaves L{{(const float*)Wx, (const float*)Wh, (const float*)b,
                    (const float*)Wo, (const float*)bo}};
    const float* x = (const float*)xs;
    float* o = (float*)out;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned m = (unsigned)bulk_mask;
    switch (rows) {
    case 2: return (int)launch_tiled<2>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, groups, slots, m,
                                        grid, s);
    case 4: return (int)launch_tiled<4>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, groups, slots, m,
                                        grid, s);
    case 8: return (int)launch_tiled<8>(L, x, o, G, N, W, M, H, n_out,
                                        shared_weights, groups, slots, m,
                                        grid, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// Launches the general sequence kernel on `stream`: one CTA per (group,
// block of `rows` rows), threads_x the hidden width rounded up to a warp.
// Weights are (G, ...) or, with shared_weights=1, one set read by every
// group.  Returns the CUDA error code of the launch (0 = launched).
int lstm_seq_general_f32(const void* Wx, const void* Wh, const void* b,
                         const void* Wo, const void* bo, const void* xs,
                         void* out, int G, int N, int W, int M, int H,
                         int n_out, int shared_weights, int threads_x,
                         int rows, void* stream) {
    const dim3 grid((unsigned)G, (unsigned)((N + rows - 1) / rows));
    const dim3 block((unsigned)threads_x, (unsigned)rows);
    lstm_seq_grouped_general_kernel<<<
        grid, block, (size_t)lstm_seq_general_smem_bytes(M, H, n_out, rows),
        (cudaStream_t)stream>>>(
        (const float*)Wx, (const float*)Wh, (const float*)b,
        (const float*)Wo, (const float*)bo, (const float*)xs, (float*)out,
        N, W, M, H, n_out, shared_weights);
    return (int)cudaGetLastError();
}

// Launches the cell on the register kernel (W = 1, h and c read and
// written, no head) on `stream`: weights (G, ...) or, with
// shared_weights=1, one set read by every group; x (G, N, In), h, c and
// the outputs (G, N, H), all contiguous float32; `grid` persistent CTAs of
// 32 * ceil(H / 4) threads, H <= 52 and In + H <= 56 (invalid value
// otherwise); bulk_mask for Wx, Wh, b as for the sequence.  Returns the
// CUDA error code of the launch (0 = launched).
int lstm_cell_grouped_f32(const void* Wx, const void* Wh, const void* b,
                          const void* h, const void* c, const void* x,
                          void* h_out, void* c_out, int G, int N, int In,
                          int H, int shared_weights, int slots, int bulk_mask,
                          int grid, void* stream) {
    if (H < 1 || H > 52 || In + H > kRegK || slots < 1 || slots > kMaxSlots)
        return (int)cudaErrorInvalidValue;
    const Leaves L{{(const float*)Wx, (const float*)Wh, (const float*)b,
                    nullptr, nullptr}};
    lstm_cell_grouped_reg_kernel<<<grid, 32 * ((H + 3) / 4),
                                   (size_t)reg_smem(In, H, 1, 0, slots, true),
                                   (cudaStream_t)stream>>>(
        L, (const float*)x, (const float*)h, (const float*)c, (float*)h_out,
        (float*)c_out, G, N, In, H, shared_weights, slots,
        (unsigned)bulk_mask);
    return (int)cudaGetLastError();
}

// Launches the cell on the general kernel: one CTA per (group, block of
// `rows` rows), threads_x the hidden width rounded up to a warp.  Returns
// the CUDA error code of the launch (0 = launched).
int lstm_cell_general_f32(const void* Wx, const void* Wh, const void* b,
                          const void* h, const void* c, const void* x,
                          void* h_out, void* c_out, int G, int N, int In,
                          int H, int shared_weights, int threads_x, int rows,
                          void* stream) {
    const dim3 grid((unsigned)G, (unsigned)((N + rows - 1) / rows));
    const dim3 block((unsigned)threads_x, (unsigned)rows);
    lstm_cell_grouped_general_kernel<<<
        grid, block, (size_t)lstm_cell_general_smem_bytes(In, H, rows),
        (cudaStream_t)stream>>>(
        (const float*)Wx, (const float*)Wh, (const float*)b, (const float*)h,
        (const float*)c, (const float*)x, (float*)h_out, (float*)c_out, N, In,
        H, shared_weights);
    return (int)cudaGetLastError();
}

const char* lstm_seq_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
