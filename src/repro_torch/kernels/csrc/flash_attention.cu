// Online-softmax (flash) attention with GQA, causal / sliding-window /
// kv_valid masks and logit soft-cap, for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes).  Two kernels, chosen by dtype.
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

template <int DP>
__global__ void __launch_bounds__(Tc<DP>::THREADS)
flash_attention_bf16_tc_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, int G, int Sq, int Skv,
                               int D, Strides st, int causal, int window,
                               float cap, int q_offset, int kv_valid,
                               float scale) {
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
    }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int G, int Sq, int Skv, int D,
                      const Strides& st, int causal, int window, float cap,
                      int q_offset, int kv_valid, float scale,
                      cudaStream_t stream) {
    const int smem = (int)Tc<DP>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    constexpr int BQ = Tc<DP>::BQ;
    const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
    flash_attention_bf16_tc_kernel<DP><<<grid, Tc<DP>::THREADS, smem,
                                         stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, G, Sq, Skv,
        D, st, causal, window, cap, q_offset, kv_valid, scale);
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

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int G, int Sq, int Skv, int D,
                        const Strides& st, int causal, int window, float cap,
                        int q_offset, int kv_valid, float scale,
                        cudaStream_t s) {
#define FA_TC(W)                                                          \
    case W:                                                               \
        return launch_tc<W>(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal, \
                            window, cap, q_offset, kv_valid, scale, s)
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
// cap <= 0 none, kv_valid < 0 none; causal is 0 or 1.  Returns the CUDA
// error code of the attribute call or of the launch (0 = launched); a
// shape or dtype the kernels do not take returns cudaErrorInvalidValue.
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
        err = dispatch_f32(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,
                           window, cap, q_offset, kv_valid, scale, s);
    else if (dtype == 1)
        err = dispatch_tc(q, k, v, o, B, Hq, G, Sq, Skv, D, st, causal,
                          window, cap, q_offset, kv_valid, scale, s);
    return (int)err;
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
