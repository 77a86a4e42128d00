// Online-softmax (flash) attention with GQA, causal / sliding-window /
// kv_valid masks and logit soft-cap, for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes).  Two forward kernels, chosen by
// dtype, and the bf16 backward's three (at the end of the file).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention, _kernel): q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D) ->
// o (B, Hq, Sq, D), query head h reading kv head h / G (G = Hq / Hkv).
// Query i sits at position q_offset + i, key j at j; key j is visible to
// query i when j < Skv, j < kv_valid (if set), j <= q_pos (causal) and
// q_pos - j < window (if set).  s = (q . k) * scale, then
// cap * tanh(s / cap) (if set); softmax over the visible keys; a query with
// no visible key gives 0.  One dtype for q, k, v and o; sums run in float32
// and p is rounded to v's dtype before P.V, as the Pallas kernel's
// p.astype(v.dtype) does.  q, k, v and o are strided views (any strides
// over B, H and S, unit stride over D), so the decoder passes its (B, S, H,
// D) projections as (B, H, S, D) views without copying them.  Any Sq and
// Skv (the ragged last block is masked).
//
// What bounds it on an H100: operations.  At the prefill's shapes (B=1,
// Hq=32, Hkv=8, D=80, window 4096, Sq up to 6144) the visible q-k pairs
// need 4 * Hq * D flops each (q.k and p.v), hundreds of flops a byte --
// far above the ridge of the bf16 tensor cores (989 TFLOP/s).
//
// bfloat16: flash_attention_bf16_tc_kernel, FlashAttention-2 style on the
// tensor cores.  One CTA a (b, q head, block of queries): 8 warps and 128
// queries at D <= 128, 4 warps and 64 queries at D = 256 (its accumulator
// takes 128 registers a thread), 16 query rows a warp; the larger block
// halves the K/V bytes each query costs from L2.  The Q tile is copied
// into shared memory once; its mma A fragments stay in registers at
// D <= 128 and are read again by ldmatrix each step at D = 256.  At
// D = 80 the softmax takes a tile's 64 keys in two steps of 32, which
// keeps the thread at 128 registers (two CTAs an SM) without spills.
// K and V tiles of 64 keys (32 at D = 256) stream through a two-stage
// ring in shared memory (a third stage measured no faster), filled by
// 16-byte cp.async straight from the strided views in bf16, so the next
// tile's copy overlaps this tile's products.  Rows in shared memory are padded by 16 bytes, so the 8
// rows an ldmatrix phase reads fall on distinct banks (D = 80: 176-byte
// rows).  S = Q.K^T is mma.sync m16n8k16 bf16 -> f32; the online softmax
// runs on the accumulator fragments (row max and sum over the 4 lanes of a
// quad) in the base-2 domain: the max is taken of the raw scores and
// p = exp2(s * scale * log2(e) - m * scale * log2(e)), one FFMA and one
// ex2 a score.  P is rounded to bf16 in registers and fed back as the A
// operand of O += P.V, V's B fragments through ldmatrix.trans.  D is any
// multiple of 16 up to 256, zero-padded in shared memory to the next
// instantiated width (16, 32, 64, 80, 128, 256).  Key blocks outside
// [q_first - window + 1, q_last] or past kv_valid are never loaded, and
// blocks that every query of the CTA sees whole skip the per-element mask.
// wgmma, TMA and warp specialisation are not used (ROADMAP).
//
// float32: flash_attention_f32_kernel, exact, on CUDA cores.  Tensor cores
// would take f32 only as TF32 (10-bit mantissa), which moves the results
// the tests hold at 1e-4; the f32 path serves the CPU-parity configs, not
// the bf16 serving path.  One CTA of 256 threads a (b, h, 64 queries); the
// Q tile and each 64-key K and V tile in shared memory as float32 (odd row
// strides), a 4 x 4 block of scores a thread, P.V from a shared p tile.
//
// Numerics: masked scores are -inf and give p = 0; the rescale of the
// running sums is taken only when the new max is finite; l sums the
// unrounded p; the output is acc / l rounded once.  f32: expf/tanhf (no
// fast-math).  bf16: exp2f of the scaled difference in place of expf of
// the difference of scaled scores, which rounds differently by an ulp or
// two of p (far below the bf16 rounding of p before P.V); tanhf for the
// cap, after which the scale is 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Strides {
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// keys any query of rows [q0, q0 + nq) can see: [k_lo, k_hi)
struct KeyRange {
    int kv_lim, k_lo, k_hi;
};
__device__ __forceinline__ KeyRange key_range(int qpos0, int nq, int Skv,
                                              int causal, int window,
                                              int kv_valid) {
    KeyRange r;
    r.kv_lim = kv_valid >= 0 ? min(Skv, kv_valid) : Skv;
    r.k_hi = causal ? min(r.kv_lim, qpos0 + nq) : r.kv_lim;
    r.k_lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
    return r;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int kv_lim,
                                        int causal, int window) {
    return kpos < kv_lim && (!causal || kpos <= qpos)
           && (window <= 0 || qpos - kpos < window);
}

// ===================================================== float32, CUDA cores
constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kPStride = kBK + 1;

__host__ __device__ __forceinline__ int odd_stride(int D) {
    return (D % 2 == 0) ? D + 1 : D;
}

__host__ __device__ __forceinline__ long long f32_smem_bytes(int D) {
    const int ld = odd_stride(D);
    return 4 * ((long long)kBQ * ld + (long long)kBK * ld
                + (long long)kBK * D + (long long)kBQ * kPStride);
}

// NC: 16-column chunks of the head dimension a thread owns (D <= 16 * NC)
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int G, int Sq, int Skv, int D, Strides st,
                           int causal, int window, float cap, int q_offset,
                           int kv_valid, float scale) {
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
    const float* qp = q + b * st.qb + h * st.qh + (long long)q0 * st.qs;
    const float* kp = k + b * st.kb + hk * st.kh;
    const float* vp = v + b * st.vb + hk * st.vh;

    for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        sQ[r * ld + d] = r < nq ? qp[r * st.qs + d] : 0.0f;
    }

    const int qpos0 = q_offset + q0;
    const KeyRange kr = key_range(qpos0, nq, Skv, causal, window, kv_valid);

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

    for (int kb = (kr.k_lo / kBK) * kBK; kb < kr.k_hi; kb += kBK) {
        const int nk = min(kBK, Skv - kb);
        __syncthreads();                 // last step's tiles are consumed
        for (int i = tid; i < kBK * D; i += kThreads) {
            const int r = i / D, d = i - r * D;
            const bool ok = r < nk;
            sK[r * ld + d] = ok ? kp[(long long)(kb + r) * st.ks + d] : 0.0f;
            sV[r * D + d] = ok ? vp[(long long)(kb + r) * st.vs + d] : 0.0f;
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
                float x = s[i][j] * scale;
                if (cap > 0.0f) x = cap * tanhf(x / cap);
                s[i][j] = visible(kpos, qpos[i], kr.kv_lim, causal, window)
                              ? x : -INFINITY;
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
                sP[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
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

    float* op = o + b * st.ob + h * st.oh + (long long)q0 * st.os;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nq) continue;
        const float inv_l = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int d = tx + 16 * c;
            if (d < D) op[r * st.os + d] = l[i] > 0.0f ? acc[i][c] * inv_l
                                                       : 0.0f;
        }
    }
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int G, int Sq, int Skv, int D,
                       const Strides& st, int causal, int window, float cap,
                       int q_offset, int kv_valid, float scale,
                       cudaStream_t stream) {
    const long long smem = f32_smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq,
                    (unsigned)B);
    flash_attention_f32_kernel<NC><<<grid, kThreads, (size_t)smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, G, Sq,
        Skv, D, st, causal, window, cap, q_offset, kv_valid, scale);
    return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int G, int Sq, int Skv, int D,
                         const Strides& st, int causal, int window, float cap,
                         int q_offset, int kv_valid, float scale,
                         cudaStream_t s) {
    const int nc = (D + 15) / 16;
#define FA_F32(N)                                                         \
    return launch_f32<N>(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,    \
                         window, cap, q_offset, kv_valid, scale, s)
    if (nc <= 1) FA_F32(1);
    if (nc <= 2) FA_F32(2);
    if (nc <= 4) FA_F32(4);
    if (nc <= 8) FA_F32(8);
    if (nc <= 16) FA_F32(16);
#undef FA_F32
    return cudaErrorInvalidValue;
}

// ================================================= bfloat16, tensor cores
typedef __nv_bfloat16 bf16;
constexpr float kLog2e = 1.4426950408889634f;

// DP: the instantiated (padded) head dimension, a multiple of 16
template <int DP> struct Tc {
    static constexpr int WARPS = DP > 128 ? 4 : 8;  // 16 query rows each
    static constexpr int BQ = 16 * WARPS, THREADS = 32 * WARPS;
    static constexpr int BK = DP > 128 ? 32 : 64;   // keys a tile
    static constexpr int STAGES = 2;                // K, V ring depth
    static constexpr int LD = DP + 8;               // shared row, elements
    static constexpr bool QREG = DP <= 128;         // Q fragments in regs
    static constexpr int KSTEPS = DP / 16;          // 16-wide steps of q.k
    // keys a softmax step: two steps a tile at D = 80 keep the S
    // fragments to 16 registers, so the thread fits 128 registers (two
    // CTAs an SM) without spills
    static constexpr int SUB = DP == 80 ? 32 : BK;
    static constexpr int NT = SUB / 8;              // 8-key tiles of S
    static constexpr int DT = DP / 8;               // 8-column tiles of O
    static constexpr long long SMEM =
        2LL * LD * (BQ + 2 * STAGES * BK);          // Q, then K, V rings
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; zero-fills the destination when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
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
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, n) of a (rows, D) bf16 view at row stride gs (elements) into a
// shared tile of LD-element rows, 16 bytes a copy; rows [n, rows) are
// zero-filled.  D / 8 copies a row; all THREADS threads take part.
template <int LD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long gs, int n, int rows,
                                          int D, int tid) {
    const int cpr = D >> 3;
    const int dr = THREADS / cpr, dc = THREADS - dr * cpr;
    int r = tid / cpr, c = tid - r * cpr;
    const uint32_t s0 = smem_u32(s);
    while (r < rows) {
        const bool ok = r < n;
        cp_async16(s0 + (uint32_t)(r * LD + c * 8) * 2,
                   g + (ok ? (long long)r * gs : 0) + c * 8, ok);
        r += dr;
        c += dc;
        if (c >= cpr) {
            c -= cpr;
            ++r;
        }
    }
}

// the accumulator's rows scaled by the softmax's rescale factors
template <int DT>
__device__ __forceinline__ void rescale_rows(float (&acc)[DT][4], float a0,
                                             float a1) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
    }
}

// LSE: also write each query row's logsumexp in the kernel's base-2 domain,
// lse = m * mul + log2(l) (+inf for a row with no visible key), f32 (B, Hq,
// Sq) contiguous, so that p = exp2(x * mul - lse) for the backward; only the
// training forward runs it, the inference call the LSE = false instantiation
template <int DP, bool LSE>
__global__ void __launch_bounds__(Tc<DP>::THREADS)
flash_attention_bf16_tc_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, int G, int Sq, int Skv,
                               int D, Strides st, int causal, int window,
                               float cap, int q_offset, int kv_valid,
                               float scale, float* __restrict__ lse) {
    using C = Tc<DP>;
    constexpr int BK = C::BK, LD = C::LD, BQ = C::BQ, NTH = C::THREADS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + BQ * LD;                          // [STAGES][BK][LD]
    bf16* sV = sK + C::STAGES * BK * LD;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
    const int q0 = blockIdx.x * BQ;
    const int nq = min(BQ, Sq - q0);
    const bf16* qp = q + b * st.qb + h * st.qh + (long long)q0 * st.qs;
    const bf16* kp = k + b * st.kb + hk * st.kh;
    const bf16* vp = v + b * st.vb + hk * st.vh;

    const int qpos0 = q_offset + q0;
    const KeyRange kr = key_range(qpos0, nq, Skv, causal, window, kv_valid);
    const float mul = (cap > 0.0f ? 1.0f : scale) * kLog2e;
    const int kb0 = (kr.k_lo / BK) * BK;
    const int n_tiles = kr.k_hi > kb0 ? (kr.k_hi - kb0 + BK - 1) / BK : 0;

    // the padded columns [D, DP) stay zero: the copies never write them
    if (D < DP) {
        const int pad = DP - D, rows = BQ + 2 * C::STAGES * BK;
        for (int i = tid; i < rows * pad; i += NTH) {
            const int r = i / pad;
            sQ[r * LD + D + (i - r * pad)] = __float2bfloat16_rn(0.0f);
        }
        __syncthreads();
    }

    // tile i into ring stage i % STAGES, one commit group a tile (empty
    // past the last tile, so the group count stays uniform)
    auto load_kv = [&](int i) {
        if (i < n_tiles) {
            const int kb = kb0 + i * BK, stg = i % C::STAGES;
            load_tile<LD, NTH>(sK + stg * BK * LD, kp + (long long)kb * st.ks,
                               st.ks, min(BK, Skv - kb), BK, D, tid);
            load_tile<LD, NTH>(sV + stg * BK * LD, vp + (long long)kb * st.vs,
                               st.vs, min(BK, Skv - kb), BK, D, tid);
        }
        cp_async_commit();
    };
    load_tile<LD, NTH>(sQ, qp, st.qs, nq, BQ, D, tid);
#pragma unroll
    for (int i = 0; i < C::STAGES - 1; ++i) load_kv(i);   // Q with tile 0

    // this lane's two query rows within the CTA: r_a and r_a + 8
    const int r_a = warp * 16 + (lane >> 2);
    const int qpos_a = qpos0 + r_a, qpos_b = qpos_a + 8;
    const int q_last = qpos0 + nq - 1;
    float o_acc[C::DT][4];
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
        o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.0f;
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
    uint32_t qf[C::QREG ? C::KSTEPS : 1][4];
    const uint32_t q_frag = smem_u32(sQ + (warp * 16 + (lane & 15)) * LD
                                     + (lane >> 4) * 8);

    for (int t = 0; t < n_tiles; ++t) {
        const int kb = kb0 + t * BK;
        cp_async_wait<C::STAGES - 2>();      // tile t (and Q) copied
        __syncthreads();                     // ... by every thread, and
                                             // stage (t - 1) % STAGES free
        load_kv(t + C::STAGES - 1);          // overlaps this tile's work
        if constexpr (C::QREG) {
            if (t == 0) {
#pragma unroll
                for (int ks = 0; ks < C::KSTEPS; ++ks)
                    ldsm_x4(qf[ks], q_frag + ks * 32);
            }
        }
        // the CTA's queries see the whole tile: no per-element mask
        const bool whole = kb + BK <= kr.kv_lim
                           && (!causal || kb + BK - 1 <= qpos0)
                           && (window <= 0 || q_last - kb < window);
#pragma unroll 1
        for (int sb = 0; sb < BK / C::SUB; ++sb) {
            const int kbs = kb + sb * C::SUB;
            const bf16* sKt = sK + ((t % C::STAGES) * BK + sb * C::SUB) * LD;
            const bf16* sVt = sV + ((t % C::STAGES) * BK + sb * C::SUB) * LD;

            // S = Q K^T: 16 rows x SUB keys a warp
            float s[C::NT][4];
#pragma unroll
            for (int j = 0; j < C::NT; ++j)
                s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
            const uint32_t k_frag = smem_u32(
                sKt + ((lane & 7) + ((lane >> 4) << 3)) * LD
                + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int ks = 0; ks < C::KSTEPS; ++ks) {
                uint32_t a[4];
                if constexpr (C::QREG) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
                } else {
                    ldsm_x4(a, q_frag + ks * 32);
                }
#pragma unroll
                for (int n2 = 0; n2 < C::NT / 2; ++n2) {
                    uint32_t bb[4];
                    ldsm_x4(bb, k_frag + (n2 * 16 * LD + ks * 16) * 2);
                    mma_bf16(s[2 * n2], a, bb[0], bb[1]);
                    mma_bf16(s[2 * n2 + 1], a, bb[2], bb[3]);
                }
            }

            // cap (the scores stay unscaled without one), mask (unless
            // whole), then the online softmax of rows r_a (e = 0, 1) and
            // r_a + 8 (e = 2, 3) in the base-2 domain:
            // p = exp2(x * mul - m * mul), mul = scale * log2(e) (or
            // log2(e) after the cap), one FFMA and one ex2 a score
#pragma unroll
            for (int j = 0; j < C::NT; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[j][e];
                    if (cap > 0.0f) x = cap * tanhf(x * scale / cap);
                    if (!whole) {
                        const int kpos = kbs + j * 8 + 2 * (lane & 3) + (e & 1);
                        if (!visible(kpos, e < 2 ? qpos_a : qpos_b, kr.kv_lim,
                                     causal, window))
                            x = -INFINITY;
                    }
                    s[j][e] = x;
                }
            }
            float alpha[2];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                float mx = -INFINITY;
#pragma unroll
                for (int j = 0; j < C::NT; ++j)
                    mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
                const float mnew = fmaxf(m_r[rr], mx);
                const bool none = mnew == -INFINITY;     // no visible key yet
                alpha[rr] = none ? 1.0f : exp2f((m_r[rr] - mnew) * mul);
                // masked scores are -inf and give exp2(-inf) = 0; with no
                // visible key at all every score is -inf and the offset 0
                const float off = none ? 0.0f : -mnew * mul;
                float psum = 0.0f;
#pragma unroll
                for (int j = 0; j < C::NT; ++j) {
#pragma unroll
                    for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
                        const float p = exp2f(fmaf(s[j][e], mul, off));
                        s[j][e] = p;
                        psum += p;
                    }
                }
                psum += __shfl_xor_sync(kFull, psum, 1);
                psum += __shfl_xor_sync(kFull, psum, 2);
                l_r[rr] = l_r[rr] * alpha[rr] + psum;
                m_r[rr] = mnew;
            }
            rescale_rows(o_acc, alpha[0], alpha[1]);

            // O += P V: P (bf16, rounded here) is the A operand, 16 keys a
            // step
            const uint32_t v_frag = smem_u32(
                sVt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD
                + (lane >> 4) * 8);
#pragma unroll
            for (int kc = 0; kc < C::SUB / 16; ++kc) {
                const uint32_t a[4] = {
                    pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                    pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                    pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                    pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
                for (int d2 = 0; d2 < C::DT / 2; ++d2) {
                    uint32_t bb[4];
                    ldsm_x4_t(bb, v_frag + (kc * 16 * LD + d2 * 16) * 2);
                    mma_bf16(o_acc[2 * d2], a, bb[0], bb[1]);
                    mma_bf16(o_acc[2 * d2 + 1], a, bb[2], bb[3]);
                }
            }
        }
    }
    cp_async_wait<0>();                      // no copy outlives the CTA

    // o = acc / l, rounded once; rows past Sq and columns past D dropped
    bf16* op = o + b * st.ob + h * st.oh + (long long)q0 * st.os;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int r = r_a + 8 * rr;
        if (r >= nq) continue;
        const float inv = l_r[rr] > 0.0f ? 1.0f / l_r[rr] : 0.0f;
#pragma unroll
        for (int j = 0; j < C::DT; ++j) {
            const int col = j * 8 + 2 * (lane & 3);
            if (col < D)
                *reinterpret_cast<uint32_t*>(op + (long long)r * st.os + col) =
                    pack_bf16(o_acc[j][2 * rr] * inv,
                              o_acc[j][2 * rr + 1] * inv);
        }
        if constexpr (LSE) {
            if ((lane & 3) == 0)
                lse[((long long)b * gridDim.y + h) * Sq + q0 + r] =
                    l_r[rr] > 0.0f ? fmaf(m_r[rr], mul, log2f(l_r[rr]))
                                   : INFINITY;
        }
    }
}

template <int DP, bool LSE>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int G, int Sq, int Skv, int D,
                      const Strides& st, int causal, int window, float cap,
                      int q_offset, int kv_valid, float scale, float* lse,
                      cudaStream_t stream) {
    const int smem = (int)Tc<DP>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_tc_kernel<DP, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    constexpr int BQ = Tc<DP>::BQ;
    const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
    flash_attention_bf16_tc_kernel<DP, LSE><<<grid, Tc<DP>::THREADS, smem,
                                              stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, G, Sq, Skv,
        D, st, causal, window, cap, q_offset, kv_valid, scale, lse);
    return cudaGetLastError();
}

// the instantiated width a bf16 call at head dimension D runs at (0: none)
__host__ int tc_width(int D) {
    if (D <= 0 || D % 16 || D > 256) return 0;
    const int widths[] = {16, 32, 64, 80, 128, 256};
    for (int w : widths)
        if (D <= w) return w;
    return 0;
}

// lse null: the inference instantiation; else (D <= 128, the backward's
// widths) it also writes the logsumexp
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int G, int Sq, int Skv, int D,
                        const Strides& st, int causal, int window, float cap,
                        int q_offset, int kv_valid, float scale, float* lse,
                        cudaStream_t s) {
#define FA_TC(W)                                                          \
    case W:                                                               \
        return lse ? launch_tc<W, (W <= 128)>(q, k, v, o, B, Hq, G, Sq,   \
                                              Skv, D, st, causal, window, \
                                              cap, q_offset, kv_valid,    \
                                              scale, lse, s)              \
                   : launch_tc<W, false>(q, k, v, o, B, Hq, G, Sq, Skv,   \
                                         D, st, causal, window, cap,      \
                                         q_offset, kv_valid, scale,       \
                                         nullptr, s)
    switch (tc_width(D)) {
        FA_TC(16);
        FA_TC(32);
        FA_TC(64);
        FA_TC(80);
        FA_TC(128);
        FA_TC(256);
        default:
            return cudaErrorInvalidValue;
    }
#undef FA_TC
}

// ================================== bfloat16 backward, tensor cores
// FlashAttention-2's backward from the forward's saved per-row logsumexp,
// three launches a call, no atomics (the gradients are deterministic):
//   flash_attention_bwd_dsum_kernel: Di = rowsum(dO * O), f32, a warp a row;
//   flash_attention_bwd_dkdv_kernel: one CTA a 64-key tile of one kv head
//     (16 keys a warp), looping over the G query heads of its group and the
//     64-query tiles that see the tile (causal from the diagonal, window,
//     kv_valid, q_offset); per tile it recomputes S^T = K Q^T and
//     P^T = exp2(x * mul - lse), dP^T = V dO^T, dS^T = P^T (dP^T - Di)
//     (times 1 - (x / cap)^2 under a cap), then dV += P^T dO, dK += dS^T Q;
//     dK and dV are written once;
//   flash_attention_bwd_dq_kernel: one CTA a 64-query tile of one query
//     head (16 rows a warp), looping over the visible 64-key tiles:
//     S = Q K^T, P, dP = dO V^T, dS as above, dQ += dS K; dQ written once.
// Two products are recomputed against FA2's five (seven in all), the price
// of writing each gradient once without an f32 dQ scratch.  The products
// are mma.sync m16n8k16 bf16 -> f32: each 16-row product's accumulator
// fragments are the A operand of the next one (P^T and dS^T rounded to bf16
// in registers, as the forward's P), so P and dS never pass through shared
// memory; B operands come from shared tiles by ldmatrix (.trans where the
// operand's rows are the reduced dimension).  The streamed tiles (Q, dO,
// lse and Di; or K and V) take a two-stage cp.async ring.  The scale is
// applied to dQ and dK once, at the write; lse, Di and every sum are f32.
// The heaviest tiles launch first: under a causal mask the first key tiles
// and the last query tiles see the most of the other side.

// DP: the instantiated (padded) head dimension, a multiple of 16, <= 128
template <int DP> struct Bw {
    static constexpr int NWARP = 4, NTHR = 32 * NWARP;
    static constexpr int TILE = 16 * NWARP;   // rows of a CTA's own tile and
                                              // of each streamed tile
    static constexpr int STEP = 32;           // columns of S a register step
    static constexpr int LDS = DP + 8;        // shared row, elements
    static constexpr int KS = DP / 16, DTL = DP / 8, NTS = STEP / 8;
    // dK/dV re-reads its K and V fragments from shared memory each step
    // rather than holding them in registers, which lets three CTAs share an
    // SM at D <= 80 (at the training shape 8% faster at D = 80, 13% at 64,
    // bit for bit the same; at 128 the accumulators alone take 128 registers).
    // The CTAs an SM each kernel's launch bounds ask for; a thread then has
    // at most 65536 / (NTHR x CTAs) registers.
    static constexpr int KV_CTAS = DP <= 80 ? 3 : 2;
    static constexpr int Q_CTAS = DP <= 80 ? 3 : 2;
    // six tiles (the CTA's two and two stages of two streamed ones), then
    // two stages of lse and Di (dK/dV)
    static constexpr long long SMEM = 2LL * LDS * 6 * TILE + 4LL * 4 * TILE;
};

struct BwdStrides {
    // (B, H, S) element strides of q, k, v, o, dO, dq, dk, dv
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs,
        dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

// 4 bytes global -> shared; zero-fills the destination when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

// the padded columns [D, DP) of `rows` shared rows set to zero (the copies
// never write them)
template <int DP, int LD, int NTH>
__device__ __forceinline__ void zero_pad(bf16* s, int rows, int D, int tid) {
    if (D < DP) {
        const int pad = DP - D;
        for (int i = tid; i < rows * pad; i += NTH) {
            const int r = i / pad;
            s[r * LD + D + (i - r * pad)] = __float2bfloat16_rn(0.0f);
        }
    }
}

// Di = rowsum(dO * O) in f32 over rows (b, h, i), a warp a row
__global__ void __launch_bounds__(256)
flash_attention_bwd_dsum_kernel(const bf16* __restrict__ o,
                                const bf16* __restrict__ dout,
                                float* __restrict__ dsum, int Hq, int Sq,
                                int D, BwdStrides st, long long rows) {
    const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const long long bh = row / Sq;
    const int i = (int)(row - bh * Sq), h = (int)(bh % Hq);
    const long long b = bh / Hq;
    const bf16* op = o + b * st.ob + h * st.oh + (long long)i * st.os;
    const bf16* gp = dout + b * st.gb + h * st.gh + (long long)i * st.gs;
    float acc = 0.0f;
    for (int d = 2 * lane; d < D; d += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(op + d));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gp + d));
        acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) dsum[row] = acc;
}

// the score x (capped where a cap is set) of a raw product s, and the
// derivative of x by s * scale (1 without a cap)
__device__ __forceinline__ float capped(float s, float cap, float scale,
                                        float& dx) {
    if (cap > 0.0f) {
        const float x = cap * tanhf(s * scale / cap), t = x / cap;
        dx = 1.0f - t * t;
        return x;
    }
    dx = 1.0f;
    return s;
}

template <int DP>
__global__ void __launch_bounds__(Bw<DP>::NTHR, Bw<DP>::KV_CTAS)
flash_attention_bwd_dkdv_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int Hkv, int G, int Sq, int Skv, int D,
                                BwdStrides st, int causal, int window,
                                float cap, int q_offset, int kv_valid,
                                float scale) {
    using C = Bw<DP>;
    constexpr int T = C::TILE, LD = C::LDS, NTH = C::NTHR, STEP = C::STEP;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);
    bf16* sV = sK + T * LD;
    bf16* sQ = sV + T * LD;                          // [2][T][LD]
    bf16* sG = sQ + 2 * T * LD;                      // dO, [2][T][LD]
    float* sL = reinterpret_cast<float*>(sG + 2 * T * LD);   // lse, [2][T]
    float* sDi = sL + 2 * T;                                 // Di, [2][T]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.x / Hkv, hk = blockIdx.x - b * Hkv, Hq = Hkv * G;
    const int kb = blockIdx.y * T, nk = min(T, Skv - kb);
    const int kv_lim = kv_valid >= 0 ? min(Skv, kv_valid) : Skv;
    const int k_end = min(kb + nk, kv_lim);
    // the queries that see a key of [kb, k_end): [i_lo, i_hi)
    const int i_lo = causal ? max(0, kb - q_offset) : 0;
    const int i_hi = window > 0 ? min(Sq, k_end - 1 + window - q_offset) : Sq;
    const int n_qt = k_end > kb && i_hi > i_lo ? (i_hi - i_lo + T - 1) / T : 0;
    const int n_it = G * n_qt;                       // (head, query tile)s
    const float mul = (cap > 0.0f ? 1.0f : scale) * kLog2e;

    zero_pad<DP, LD, NTH>(sK, 6 * T, D, tid);
    if (D < DP) __syncthreads();

    auto load_q = [&](int it) {
        if (it < n_it) {
            const int g = it / n_qt, i0 = i_lo + (it - g * n_qt) * T;
            const int h = hk * G + g, n = min(T, Sq - i0), stg = it & 1;
            load_tile<LD, NTH>(sQ + stg * T * LD,
                               q + b * st.qb + h * st.qh
                                   + (long long)i0 * st.qs,
                               st.qs, n, T, D, tid);
            load_tile<LD, NTH>(sG + stg * T * LD,
                               dout + b * st.gb + h * st.gh
                                   + (long long)i0 * st.gs,
                               st.gs, n, T, D, tid);
            const int r = tid & (T - 1);             // NTH = 2 T
            const long long at = ((long long)b * Hq + h) * Sq + i0
                                 + (r < n ? r : 0);
            cp_async4(smem_u32((tid < T ? sL : sDi) + stg * T + r),
                      (tid < T ? lse : dsum) + at, r < n);
        }
        cp_async_commit();
    };
    load_tile<LD, NTH>(sK, k + b * st.kb + hk * st.kh + (long long)kb * st.ks,
                       st.ks, nk, T, D, tid);
    load_tile<LD, NTH>(sV, v + b * st.vb + hk * st.vh + (long long)kb * st.vs,
                       st.vs, nk, T, D, tid);
    load_q(0);                                       // with K and V

    // this warp's 16 keys: rows r0 .. r0 + 15 of the tile; a lane's two are
    // r0 + lane / 4 and that + 8
    const int r0 = warp * 16;
    const int kpos_a = kb + r0 + (lane >> 2);
    float dk_acc[C::DTL][4], dv_acc[C::DTL][4];
#pragma unroll
    for (int j = 0; j < C::DTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
    const int a_off = (r0 + (lane & 15)) * LD + (lane >> 4) * 8;
    const uint32_t k_a = smem_u32(sK + a_off), v_a = smem_u32(sV + a_off);
    // B fragments of a (query, d) tile: as is for K Q^T and V dO^T,
    // transposed for P^T dO and dS^T Q
    const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD
                      + ((lane >> 3) & 1) * 8;
    const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD
                      + (lane >> 4) * 8;

    for (int it = 0; it < n_it; ++it) {
        cp_async_wait<0>();                  // tile it (and K, V) copied
        __syncthreads();                     // ... by every thread, and the
                                             // other stage free
        load_q(it + 1);                      // overlaps this tile's work
        const int stg = it & 1, g = it / n_qt;
        const int i0 = i_lo + (it - g * n_qt) * T, qpos0 = q_offset + i0;
        // every query of the tile sees every key of this CTA's tile
        const bool whole = kb + T <= kv_lim && i0 + T <= Sq
                           && (!causal || kb + T - 1 <= qpos0)
                           && (window <= 0 || qpos0 + T - 1 - kb < window);
        const bf16* sQt = sQ + stg * T * LD;
        const bf16* sGt = sG + stg * T * LD;
        const float* sLt = sL + stg * T;
        const float* sDt = sDi + stg * T;
#pragma unroll 1
        for (int sb = 0; sb < T / STEP; ++sb) {
            // S^T = K Q^T and dP^T = V dO^T: 16 keys x STEP queries a warp
            float s[C::NTS][4], dp[C::NTS][4];
#pragma unroll
            for (int j = 0; j < C::NTS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
            const uint32_t q_b = smem_u32(sQt + sb * STEP * LD + b_off);
            const uint32_t g_b = smem_u32(sGt + sb * STEP * LD + b_off);
#pragma unroll
            for (int ks = 0; ks < C::KS; ++ks) {
                uint32_t ak[4], av[4];
                ldsm_x4(ak, k_a + ks * 32);
                ldsm_x4(av, v_a + ks * 32);
#pragma unroll
                for (int n2 = 0; n2 < C::NTS / 2; ++n2) {
                    uint32_t bb[4];
                    ldsm_x4(bb, q_b + (n2 * 16 * LD + ks * 16) * 2);
                    mma_bf16(s[2 * n2], ak, bb[0], bb[1]);
                    mma_bf16(s[2 * n2 + 1], ak, bb[2], bb[3]);
                    ldsm_x4(bb, g_b + (n2 * 16 * LD + ks * 16) * 2);
                    mma_bf16(dp[2 * n2], av, bb[0], bb[1]);
                    mma_bf16(dp[2 * n2 + 1], av, bb[2], bb[3]);
                }
            }
            // P^T and dS^T in place: element (key kpos_a + 8 (e / 2),
            // query sb STEP + 8 j + 2 (lane % 4) + e % 2)
#pragma unroll
            for (int j = 0; j < C::NTS; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = sb * STEP + j * 8 + 2 * (lane & 3) + (e & 1);
                    float dx;
                    const float x = capped(s[j][e], cap, scale, dx);
                    float p = exp2f(fmaf(x, mul, -sLt[qi]));
                    if (!whole && (i0 + qi >= Sq
                                   || !visible(kpos_a + 8 * (e >> 1),
                                               qpos0 + qi, kv_lim, causal,
                                               window)))
                        p = 0.0f;
                    s[j][e] = p;
                    dp[j][e] = p * (dp[j][e] - sDt[qi]) * dx;
                }
            }
            // dV += P^T dO and dK += dS^T Q, 16 queries a step
            const uint32_t g_t = smem_u32(sGt + sb * STEP * LD + t_off);
            const uint32_t q_t = smem_u32(sQt + sb * STEP * LD + t_off);
#pragma unroll
            for (int kc = 0; kc < STEP / 16; ++kc) {
                const uint32_t ap[4] = {
                    pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                    pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                    pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                    pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
                const uint32_t ad[4] = {
                    pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                    pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                    pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                    pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
                for (int d2 = 0; d2 < C::DTL / 2; ++d2) {
                    uint32_t bb[4];
                    ldsm_x4_t(bb, g_t + (kc * 16 * LD + d2 * 16) * 2);
                    mma_bf16(dv_acc[2 * d2], ap, bb[0], bb[1]);
                    mma_bf16(dv_acc[2 * d2 + 1], ap, bb[2], bb[3]);
                    ldsm_x4_t(bb, q_t + (kc * 16 * LD + d2 * 16) * 2);
                    mma_bf16(dk_acc[2 * d2], ad, bb[0], bb[1]);
                    mma_bf16(dk_acc[2 * d2 + 1], ad, bb[2], bb[3]);
                }
            }
        }
    }
    cp_async_wait<0>();                      // no copy outlives the CTA

    // dK (times the scale) and dV, rounded once; keys past Skv and columns
    // past D dropped; a tile no query sees writes zeros
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int kpos = kpos_a + 8 * rr;
        if (kpos >= Skv) continue;
        bf16* kp = dk + b * st.dkb + hk * st.dkh + (long long)kpos * st.dks;
        bf16* vp = dv + b * st.dvb + hk * st.dvh + (long long)kpos * st.dvs;
#pragma unroll
        for (int j = 0; j < C::DTL; ++j) {
            const int col = j * 8 + 2 * (lane & 3);
            if (col < D) {
                *reinterpret_cast<uint32_t*>(kp + col) =
                    pack_bf16(dk_acc[j][2 * rr] * scale,
                              dk_acc[j][2 * rr + 1] * scale);
                *reinterpret_cast<uint32_t*>(vp + col) =
                    pack_bf16(dv_acc[j][2 * rr], dv_acc[j][2 * rr + 1]);
            }
        }
    }
}

template <int DP>
__global__ void __launch_bounds__(Bw<DP>::NTHR, Bw<DP>::Q_CTAS)
flash_attention_bwd_dq_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              bf16* __restrict__ dq, int Hq, int G, int Sq,
                              int Skv, int D, BwdStrides st, int causal,
                              int window, float cap, int q_offset,
                              int kv_valid, float scale) {
    using C = Bw<DP>;
    constexpr int T = C::TILE, LD = C::LDS, NTH = C::NTHR, STEP = C::STEP;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sG = sQ + T * LD;                          // dO
    bf16* sK = sG + T * LD;                          // [2][T][LD]
    bf16* sV = sK + 2 * T * LD;                      // [2][T][LD]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.x / Hq, h = blockIdx.x - b * Hq, hk = h / G;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * T, nq = min(T, Sq - q0);
    const int qpos0 = q_offset + q0;
    const KeyRange kr = key_range(qpos0, nq, Skv, causal, window, kv_valid);
    const int kb0 = (kr.k_lo / T) * T;
    const int n_tiles = kr.k_hi > kb0 ? (kr.k_hi - kb0 + T - 1) / T : 0;
    const float mul = (cap > 0.0f ? 1.0f : scale) * kLog2e;
    const bf16* kp = k + b * st.kb + hk * st.kh;
    const bf16* vp = v + b * st.vb + hk * st.vh;

    zero_pad<DP, LD, NTH>(sQ, 6 * T, D, tid);
    if (D < DP) __syncthreads();

    auto load_kv = [&](int i) {
        if (i < n_tiles) {
            const int kb = kb0 + i * T, stg = i & 1;
            load_tile<LD, NTH>(sK + stg * T * LD, kp + (long long)kb * st.ks,
                               st.ks, min(T, Skv - kb), T, D, tid);
            load_tile<LD, NTH>(sV + stg * T * LD, vp + (long long)kb * st.vs,
                               st.vs, min(T, Skv - kb), T, D, tid);
        }
        cp_async_commit();
    };
    load_tile<LD, NTH>(sQ, q + b * st.qb + h * st.qh + (long long)q0 * st.qs,
                       st.qs, nq, T, D, tid);
    load_tile<LD, NTH>(sG, dout + b * st.gb + h * st.gh
                               + (long long)q0 * st.gs,
                       st.gs, nq, T, D, tid);
    load_kv(0);                                      // with Q and dO

    // this lane's two query rows: r_a and r_a + 8; a row past Sq takes
    // lse = +inf, so its p is 0
    const int r_a = warp * 16 + (lane >> 2);
    const int qpos_a = qpos0 + r_a, qpos_b = qpos_a + 8;
    float l_r[2], d_r[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int r = r_a + 8 * rr;
        const long long at = ((long long)b * Hq + h) * Sq + q0 + r;
        l_r[rr] = r < nq ? lse[at] : INFINITY;
        d_r[rr] = r < nq ? dsum[at] : 0.0f;
    }
    float dq_acc[C::DTL][4];
#pragma unroll
    for (int j = 0; j < C::DTL; ++j)
        dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.0f;
    uint32_t qf[C::KS][4], gf[C::KS][4];
    const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD
                      + ((lane >> 3) & 1) * 8;
    const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD
                      + (lane >> 4) * 8;
    const int q_last = qpos0 + nq - 1;

    for (int t = 0; t < n_tiles; ++t) {
        const int kb = kb0 + t * T, stg = t & 1;
        cp_async_wait<0>();                  // tile t (and Q, dO) copied
        __syncthreads();
        load_kv(t + 1);
        if (t == 0) {
#pragma unroll
            for (int ks = 0; ks < C::KS; ++ks) {
                ldsm_x4(qf[ks], smem_u32(sQ + a_off) + ks * 32);
                ldsm_x4(gf[ks], smem_u32(sG + a_off) + ks * 32);
            }
        }
        const bool whole = kb + T <= kr.kv_lim
                           && (!causal || kb + T - 1 <= qpos0)
                           && (window <= 0 || q_last - kb < window);
#pragma unroll 1
        for (int sb = 0; sb < T / STEP; ++sb) {
            const int kbs = kb + sb * STEP;
            const bf16* sKt = sK + (stg * T + sb * STEP) * LD;
            const bf16* sVt = sV + (stg * T + sb * STEP) * LD;
            // S = Q K^T and dP = dO V^T: 16 rows x STEP keys a warp
            float s[C::NTS][4], dp[C::NTS][4];
#pragma unroll
            for (int j = 0; j < C::NTS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
            const uint32_t k_b = smem_u32(sKt + b_off);
            const uint32_t v_b = smem_u32(sVt + b_off);
#pragma unroll
            for (int ks = 0; ks < C::KS; ++ks) {
#pragma unroll
                for (int n2 = 0; n2 < C::NTS / 2; ++n2) {
                    uint32_t bb[4];
                    ldsm_x4(bb, k_b + (n2 * 16 * LD + ks * 16) * 2);
                    mma_bf16(s[2 * n2], qf[ks], bb[0], bb[1]);
                    mma_bf16(s[2 * n2 + 1], qf[ks], bb[2], bb[3]);
                    ldsm_x4(bb, v_b + (n2 * 16 * LD + ks * 16) * 2);
                    mma_bf16(dp[2 * n2], gf[ks], bb[0], bb[1]);
                    mma_bf16(dp[2 * n2 + 1], gf[ks], bb[2], bb[3]);
                }
            }
            // P and dS in place: rows r_a (e = 0, 1) and r_a + 8 (e = 2, 3)
#pragma unroll
            for (int j = 0; j < C::NTS; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float dx;
                    const float x = capped(s[j][e], cap, scale, dx);
                    float p = exp2f(fmaf(x, mul, -l_r[e >> 1]));
                    if (!whole) {
                        const int kpos = kbs + j * 8 + 2 * (lane & 3) + (e & 1);
                        if (!visible(kpos, e < 2 ? qpos_a : qpos_b, kr.kv_lim,
                                     causal, window))
                            p = 0.0f;
                    }
                    dp[j][e] = p * (dp[j][e] - d_r[e >> 1]) * dx;
                }
            }
            // dQ += dS K, 16 keys a step
            const uint32_t k_t = smem_u32(sKt + t_off);
#pragma unroll
            for (int kc = 0; kc < STEP / 16; ++kc) {
                const uint32_t a[4] = {
                    pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                    pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                    pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                    pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
                for (int d2 = 0; d2 < C::DTL / 2; ++d2) {
                    uint32_t bb[4];
                    ldsm_x4_t(bb, k_t + (kc * 16 * LD + d2 * 16) * 2);
                    mma_bf16(dq_acc[2 * d2], a, bb[0], bb[1]);
                    mma_bf16(dq_acc[2 * d2 + 1], a, bb[2], bb[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

    // dQ times the scale, rounded once; rows past Sq dropped
    bf16* dqp = dq + b * st.dqb + h * st.dqh + (long long)q0 * st.dqs;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int r = r_a + 8 * rr;
        if (r >= nq) continue;
#pragma unroll
        for (int j = 0; j < C::DTL; ++j) {
            const int col = j * 8 + 2 * (lane & 3);
            if (col < D)
                *reinterpret_cast<uint32_t*>(dqp + (long long)r * st.dqs
                                             + col) =
                    pack_bf16(dq_acc[j][2 * rr] * scale,
                              dq_acc[j][2 * rr + 1] * scale);
        }
    }
}

template <int DP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                       int Sq, int Skv, int D, const BwdStrides& st,
                       int causal, int window, float cap, int q_offset,
                       int kv_valid, float scale, cudaStream_t stream) {
    using C = Bw<DP>;
    const int smem = (int)C::SMEM, G = Hq / Hkv;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dkdv_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            flash_attention_bwd_dq_kernel<DP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 g_kv((unsigned)(B * Hkv), (unsigned)((Skv + C::TILE - 1)
                                                    / C::TILE));
    flash_attention_bwd_dkdv_kernel<DP><<<g_kv, C::NTHR, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        lse, dsum, (bf16*)dk, (bf16*)dv, Hkv, G, Sq, Skv, D, st, causal,
        window, cap, q_offset, kv_valid, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 g_q((unsigned)(B * Hq), (unsigned)((Sq + C::TILE - 1)
                                                  / C::TILE));
    flash_attention_bwd_dq_kernel<DP><<<g_q, C::NTHR, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        lse, dsum, (bf16*)dq, Hq, G, Sq, Skv, D, st, causal, window, cap,
        q_offset, kv_valid, scale);
    return cudaGetLastError();
}

// the instantiated width of the backward at head dimension D (0: none)
__host__ int bwd_width(int D) {
    const int w = tc_width(D);
    return w <= 128 ? w : 0;
}

long long bwd_smem_bytes(int D) {
    switch (bwd_width(D)) {
        case 16: return Bw<16>::SMEM;
        case 32: return Bw<32>::SMEM;
        case 64: return Bw<64>::SMEM;
        case 80: return Bw<80>::SMEM;
        case 128: return Bw<128>::SMEM;
        default: return 0;
    }
}

cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* dsum, void* dq, void* dk, void* dv,
                         int B, int Hq, int Hkv, int Sq, int Skv, int D,
                         const BwdStrides& st, int causal, int window,
                         float cap, int q_offset, int kv_valid, float scale,
                         cudaStream_t s) {
#define FA_BWD(W)                                                          \
    case W:                                                                \
        return launch_bwd<W>(q, k, v, dout, lse, dsum, dq, dk, dv, B, Hq,  \
                             Hkv, Sq, Skv, D, st, causal, window, cap,     \
                             q_offset, kv_valid, scale, s)
    switch (bwd_width(D)) {
        FA_BWD(16);
        FA_BWD(32);
        FA_BWD(64);
        FA_BWD(80);
        FA_BWD(128);
        default:
            return cudaErrorInvalidValue;
    }
#undef FA_BWD
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs at head dimension D for a
// dtype (0 = float32, 1 = bfloat16); 0 where the kernel does not take D.
long long flash_attention_smem_bytes(int D, int dtype) {
    if (dtype == 0) return D > 0 && D <= 256 ? f32_smem_bytes(D) : 0;
    switch (tc_width(D)) {
        case 16: return Tc<16>::SMEM;
        case 32: return Tc<32>::SMEM;
        case 64: return Tc<64>::SMEM;
        case 80: return Tc<80>::SMEM;
        case 128: return Tc<128>::SMEM;
        case 256: return Tc<256>::SMEM;
        default: return 0;
    }
}

// strides: 12 element strides, (B, H, S) for q, k, v and o in that order;
// D has unit stride.  dtype: 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the tensor-core kernel: D a multiple of 16, base pointers and
// strides 16-byte aligned, as the wrapper checks).  window <= 0 means none,
// cap <= 0 none, kv_valid < 0 none; causal is 0 or 1.  lse: null, or (bf16
// at D <= 128 only) a contiguous f32 (B, Hq, Sq) buffer for each row's base-2
// logsumexp, for the backward.  Returns the CUDA error code of the
// attribute call or of the launch (0 = launched); a shape or dtype the
// kernels do not take returns cudaErrorInvalidValue.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                            int D, const long long* strides, int causal,
                            int window, float cap, int q_offset, int kv_valid,
                            float scale, int dtype, void* stream,
                            float* lse) {
    Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11]};
    const int G = Hq / Hkv;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    if (lse && bwd_width(D) == 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0 && !lse)
        err = dispatch_f32(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,
                           window, cap, q_offset, kv_valid, scale, s);
    else if (dtype == 1)
        err = dispatch_tc(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,
                          window, cap, q_offset, kv_valid, scale, lse, s);
    return (int)err;
}

// Bytes of dynamic shared memory a backward CTA needs at head dimension D
// (bf16; 0 where the backward kernels do not take D: above 128).
long long flash_attention_bwd_smem_bytes(int D) { return bwd_smem_bytes(D); }

// The bf16 backward from the training forward's outputs o and lse: dq, dk,
// dv of a loss with gradient dout at o.  strides: 24 element strides, (B,
// H, S) for q, k, v, o, dout, dq, dk, dv in that order (D unit stride;
// 16-byte aligned base pointers and strides, as the wrapper checks; dq,
// dk, dv are written in full).  dsum: f32 (B, Hq, Sq) scratch for Di; lse
// as the forward wrote it.  Options as the forward's.  Three launches on
// the stream; returns the first CUDA error code (0 = launched), or
// cudaErrorInvalidValue at a D the kernels do not take.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* dsum, void* dq,
                             void* dk, void* dv, int B, int Hq, int Hkv,
                             int Sq, int Skv, int D,
                             const long long* strides, int causal,
                             int window, float cap, int q_offset,
                             int kv_valid, float scale, void* stream) {
    if (bwd_width(D) == 0 || Hkv <= 0 || Hq % Hkv)
        return cudaErrorInvalidValue;
    BwdStrides st;
    memcpy(&st, strides, sizeof st);
    cudaStream_t s = (cudaStream_t)stream;
    const long long rows = (long long)B * Hq * Sq;
    flash_attention_bwd_dsum_kernel<<<(unsigned)((rows + 7) / 8), 256, 0,
                                      s>>>((const bf16*)o, (const bf16*)dout,
                                           dsum, Hq, Sq, D, st, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)dispatch_bwd(q, k, v, dout, lse, dsum, dq, dk, dv, B, Hq, Hkv,
                             Sq, Skv, D, st, causal, window, cap, q_offset,
                             kv_valid, scale, s);
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
