// Single-query (flash-decode) attention against a KV cache, split over the
// cache rows, one CUDA kernel for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes).
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
// its G query heads: at G = 4, D = 80 in bf16 that is 4 flops a byte.  On
// the serving path (16 slots, Hkv = 8, window 4096, kv_valid 1..8192) the
// visible rows are 123 MB, 37 us at 3.35 TB/s -- too little work for one
// CTA a (slot, kv head): 128 CTAs on 132 SMs, each walking up to 4096 rows
// alone, leave the copy engines idle while the longest slots finish.
//
// What the design does about it: split-KV.  Each (slot, kv head)'s
// visible rows [lo, hi) = [max(0, kv_valid - window), min(kv_valid, S))
// are cut into n_splits runs of `run` rows, [lo + s * run, ...), where the
// host picks n_splits and run from S and the window alone (kv_valid lives
// on the device; decode_attention.py::split_plan, about 256 rows a run):
// grid (Hkv, n_splits, B), 8 x 16 x 16 = 2,048 CTAs on the serving path,
// of which 1,536 hold rows.  Each CTA of 4 warps serves all G query heads
// of its kv head from one load of each row: tiles of 32 rows of k and v
// stream through a two-stage ring in shared memory (22.5 KB at D = 80, so
// nine CTAs fit an SM), filled by 16-byte cp.async straight from the
// strided cache view, so the next tile's copy overlaps this tile's
// products.  Rows are padded by 16 bytes in shared memory
// (bank-conflict-free row reads).  A warp takes one query head (G <= 4;
// then R = 4 / G warps share a head, each every R-th tile) or up to four
// (G <= 16, heads w, w + 4, ...).  Scores and P.V stay on CUDA cores (4
// flops a byte): lane j scores row j of the tile with 8 independent
// partial sums, the warp's max and sum go through shuffles; for P.V, one
// lane a 16-byte chunk of a row (10 lanes at D = 80 in bf16) and
// 32 / (lanes a row) rows at once, the row groups' sums added by shuffles
// at the end.  Each (warp's share of a) split writes its partial softmax
// (m, l, acc) in float32 to scratch; the last CTA of a (slot, kv head) to
// arrive -- an atomicInc ticket that wraps to 0 itself, so no per-call
// zeroing -- merges the partials with weights exp(m_s - M) (an empty
// split, m = -inf, weighs 0) and writes o.  One launch a call.
//
// Numerics: expf/tanhf (no fast-math); l sums the unrounded p, P.V uses p
// rounded to v's dtype; the output is sum_s w_s acc_s / sum_s w_s l_s
// rounded once to q's dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4, kThreads = 32 * kWarps;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// one 16-byte chunk of a cache row as float32 (8 bf16 or 4 f32 values)
template <typename TKV> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void get(const unsigned char* p,
                                               float (&x)[8]) {
        const uint4 w = *reinterpret_cast<const uint4*>(p);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[2 * i] = __uint_as_float(ws[i] << 16);
            x[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
        }
    }
    __device__ __forceinline__ static float round(float x) {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
};
template <> struct Chunk<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void get(const unsigned char* p,
                                               float (&x)[4]) {
        const float4 w = *reinterpret_cast<const float4*>(p);
        x[0] = w.x;
        x[1] = w.y;
        x[2] = w.z;
        x[3] = w.w;
    }
    __device__ __forceinline__ static float round(float x) { return x; }
};

struct Strides {
    long long qb, qh, kb, kh, ks, vb, vh, vs;   // elements
};

// rows a tile: one a lane of a warp (a 64-row tile was slower: fewer CTAs
// fit an SM)
constexpr int kTileRows = 32;

__host__ __device__ __forceinline__ long long smem_bytes(int G, int D,
                                                         int es_kv,
                                                         int n_parts) {
    const int ldb = D * es_kv + 16;
    const long long ring = 2LL * 2 * kTileRows * ldb;
    const long long merge = 4LL * G * (3 * n_parts + 1);
    return (ring > merge ? ring : merge) + 4LL * G * D;
}

// CPL: 16-byte chunks of a row a lane accumulates in P.V (2 only for f32
// rows over 512 bytes); HPW: query heads a warp serves (1: G <= 4, 4:
// G <= 16)
template <typename TKV, int CPL, int HPW>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const void* __restrict__ q,
                              const TKV* __restrict__ k,
                              const TKV* __restrict__ v,
                              const int* __restrict__ kv_valid,
                              void* __restrict__ o, float* part,
                              unsigned* __restrict__ tickets, int G, int S,
                              int D, Strides st, int window, float cap,
                              float scale, int run, int q_bf16) {
    using CK = Chunk<TKV>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int es = (int)sizeof(TKV);
    const int ldb = D * es + 16, TR = kTileRows;
    unsigned char* sK = smem;                            // [2][TR] rows
    unsigned char* sV = sK + 2 * TR * ldb;
    const int Hkv = gridDim.x, n_splits = gridDim.y;
    const int R = G >= kWarps ? 1 : kWarps / G;         // warps a head
    const int n_parts = n_splits * R;                    // partials a head
    const long long ring = 4LL * TR * ldb;
    const long long merge = 4LL * G * (3 * n_parts + 1);
    float* sq = reinterpret_cast<float*>(smem + (ring > merge ? ring
                                                              : merge));

    const int hk = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int bh = b * Hkv + hk;

    for (int i = tid; i < G * D; i += kThreads) {
        const int gg = i / D, d = i - gg * D;
        const long long off = b * st.qb + (long long)(hk * G + gg) * st.qh + d;
        sq[i] = q_bf16 ? __bfloat162float(
                             reinterpret_cast<const __nv_bfloat16*>(q)[off])
                       : reinterpret_cast<const float*>(q)[off];
    }

    // this split's rows: [r0, r0 + nr) of the visible [lo, hi)
    const int valid = kv_valid[b];
    const int hi = min(valid, S);
    const int lo = window > 0 ? max(0, valid - window) : 0;
    const int r0 = lo + split * run;
    const int nr = max(0, min(hi, r0 + run) - r0);

    // this warp's heads: g0 + kWarps * i (G >= 4), or head g0, part r of R
    const int g0 = G >= kWarps ? warp : warp / R;
    const int r = G >= kWarps ? 0 : warp - g0 * R;
    const bool active = g0 < G;

    // P.V: Lr lanes a row, each a 16-byte chunk (and chunk + Lr), RP rows
    // at once; lane = slot * Lr + lc, slots >= RP idle
    const int cpr = D * es / 16;                         // chunks a row
    const int Lr = min(cpr, 32), RP = 32 / Lr;
    const int slot = lane / Lr, lc = lane - slot * Lr;
    float m[HPW], l[HPW], acc[HPW][CPL][CK::N];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
        m[hh] = -INFINITY;
        l[hh] = 0.0f;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int e = 0; e < CK::N; ++e) acc[hh][c][e] = 0.0f;
    }

    const unsigned char* kbase = reinterpret_cast<const unsigned char*>(
        k + b * st.kb + hk * st.kh + (long long)r0 * st.ks);
    const unsigned char* vbase = reinterpret_cast<const unsigned char*>(
        v + b * st.vb + hk * st.vh + (long long)r0 * st.vs);
    const long long ksb = st.ks * es, vsb = st.vs * es;
    const int n_tiles = (nr + TR - 1) / TR;
    auto load = [&](int t) {
        const int rows = min(TR, nr - t * TR), stage = t & 1;
        const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
        int rr = tid / cpr, c = tid - rr * cpr;
        const uint32_t k0 = smem_u32(sK + stage * TR * ldb);
        const uint32_t v0 = smem_u32(sV + stage * TR * ldb);
        while (rr < rows) {
            const long long row = (long long)t * TR + rr;
            cp_async16(k0 + rr * ldb + c * 16, kbase + row * ksb + c * 16);
            cp_async16(v0 + rr * ldb + c * 16, vbase + row * vsb + c * 16);
            rr += dr;
            c += dc;
            if (c >= cpr) {
                c -= cpr;
                ++rr;
            }
        }
        cp_async_commit();
    };
    if (n_tiles > 0) load(0);

    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            load(t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                  // tile t (and q) in place
        const int rows = min(TR, nr - t * TR);
        const unsigned char* tK = sK + (t & 1) * TR * ldb;
        const unsigned char* tV = sV + (t & 1) * TR * ldb;
        if (active && t % R == r) {           // R warps share a head
            const int row = lane;
            const bool ok = row < rows;
            // scores of this lane's row for the warp's heads: CK::N
            // independent partial sums a head (one a chunk position), so
            // the FMAs of a row do not wait on each other
            float s[HPW];
#pragma unroll
            for (int hh = 0; hh < HPW; ++hh) s[hh] = 0.0f;
            if (ok) {
                const unsigned char* kr = tK + row * ldb;
                float sp[HPW][CK::N];
#pragma unroll
                for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
                    for (int e = 0; e < CK::N; ++e) sp[hh][e] = 0.0f;
                for (int c = 0; c < cpr; ++c) {
                    float x[CK::N];
                    CK::get(kr + c * 16, x);
#pragma unroll
                    for (int hh = 0; hh < HPW; ++hh) {
                        const int g = g0 + kWarps * hh;
                        if (g >= G) break;
                        const float* qg = sq + g * D + c * CK::N;
#pragma unroll
                        for (int e = 0; e < CK::N; ++e)
                            sp[hh][e] = fmaf(qg[e], x[e], sp[hh][e]);
                    }
                }
#pragma unroll
                for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
                    for (int e = 0; e < CK::N; ++e) s[hh] += sp[hh][e];
            }
            float pr[HPW];
#pragma unroll
            for (int hh = 0; hh < HPW; ++hh) pr[hh] = 0.0f;
#pragma unroll
            for (int hh = 0; hh < HPW; ++hh) {
                if (g0 + kWarps * hh >= G) break;
                float x = s[hh] * scale;
                if (cap > 0.0f) x = cap * tanhf(x / cap);
                x = ok ? x : -INFINITY;
                const float mnew = fmaxf(m[hh], warp_max(x));  // lane 0 is ok
                const float alpha = expf(m[hh] - mnew);
                const float pv = ok ? expf(x - mnew) : 0.0f;
                l[hh] = l[hh] * alpha + warp_sum(pv);
                m[hh] = mnew;
                pr[hh] = CK::round(pv);
#pragma unroll
                for (int c = 0; c < CPL; ++c)
#pragma unroll
                    for (int e = 0; e < CK::N; ++e) acc[hh][c][e] *= alpha;
            }
            // P.V: rows j0 + slot, RP at a time; lane lc of a row takes
            // chunks lc and lc + Lr
            for (int j0 = 0; j0 < rows; j0 += RP) {
                const int jj = j0 + slot;
                const bool take = slot < RP && jj < rows;
                float pj[HPW];
#pragma unroll
                for (int hh = 0; hh < HPW; ++hh)
                    pj[hh] = __shfl_sync(kFull, pr[hh], jj & 31);
                if (!take) continue;
                const unsigned char* vr = tV + jj * ldb;
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                    const int ch = lc + c * Lr;
                    if (ch < cpr) {
                        float x[CK::N];
                        CK::get(vr + ch * 16, x);
#pragma unroll
                        for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
                            for (int e = 0; e < CK::N; ++e)
                                acc[hh][c][e] = fmaf(pj[hh], x[e],
                                                     acc[hh][c][e]);
                    }
                }
            }
        }
        __syncthreads();                  // stage t & 1 is consumed
    }

    // this warp's partials: part[((bh * n_parts + split * R + r) * G + g)
    // * (D + 2)] = m, l, acc[0..D); slot 0 sums the RP slots' sums
    if (active) {
#pragma unroll
        for (int hh = 0; hh < HPW; ++hh) {
            const int g = g0 + kWarps * hh;
            if (g >= G) break;
#pragma unroll
            for (int c = 0; c < CPL; ++c)
#pragma unroll
                for (int e = 0; e < CK::N; ++e) {
                    float tot = acc[hh][c][e];
                    for (int sl = 1; sl < RP; ++sl)
                        tot += __shfl_sync(kFull, acc[hh][c][e],
                                           (lane + sl * Lr) & 31);
                    acc[hh][c][e] = tot;
                }
            float* pp = part + (((long long)bh * n_parts + split * R + r) * G
                                + g) * (D + 2);
            if (lane == 0) {
                pp[0] = m[hh];
                pp[1] = l[hh];
            }
            if (slot == 0) {
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                    const int ch = lc + c * Lr;
                    if (ch < cpr) {
#pragma unroll
                        for (int e = 0; e < CK::N; ++e)
                            pp[2 + ch * CK::N + e] = acc[hh][c][e];
                    }
                }
            }
        }
    }

    // the last CTA of this (slot, kv head) merges every split's partials
    __shared__ unsigned s_last;
    __threadfence();
    __syncthreads();
    if (tid == 0)
        s_last = atomicInc(tickets + bh, (unsigned)(n_splits - 1))
                 == (unsigned)(n_splits - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // every partial's (m, l) into shared memory at once, then a thread a
    // head turns them into weights, then every thread sums acc columns
    const float* pb = part + (long long)bh * n_parts * G * (D + 2);
    const int np = n_parts * G;                          // partial (s, g)
    float* sm = reinterpret_cast<float*>(smem);          // [n_parts][G] m
    float* sl = sm + np;                                 // ... l
    float* wts = sl + np;                                // ... weights
    float* sL = wts + np;                                // [G] sum w l
    for (int i = tid; i < np; i += kThreads) {
        sm[i] = __ldcg(pb + (long long)i * (D + 2));
        sl[i] = __ldcg(pb + (long long)i * (D + 2) + 1);
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
        float M = -INFINITY;
        for (int s = 0; s < n_parts; ++s) M = fmaxf(M, sm[s * G + g]);
        float L = 0.0f;
        for (int s = 0; s < n_parts; ++s) {
            const float ms = sm[s * G + g];
            const float w = ms == -INFINITY ? 0.0f : expf(ms - M);
            wts[s * G + g] = w;
            L = fmaf(sl[s * G + g], w, L);
        }
        sL[g] = L;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
        const int g = i / D, d = i - g * D;
        float a = 0.0f;
#pragma unroll 4
        for (int s = 0; s < n_parts; ++s)      // an empty split's acc is 0
            a = fmaf(__ldcg(pb + ((long long)s * G + g) * (D + 2) + 2 + d),
                     wts[s * G + g], a);
        const float L = sL[g];
        const float out = L > 0.0f ? a / L : 0.0f;
        const long long off = ((long long)bh * G + g) * D + d;
        if (q_bf16)
            reinterpret_cast<__nv_bfloat16*>(o)[off] = __float2bfloat16_rn(out);
        else
            reinterpret_cast<float*>(o)[off] = out;
    }
}

template <typename TKV, int CPL, int HPW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_valid, void* o, float* part,
                   unsigned* tickets, int B, int Hkv, int G, int S, int D,
                   const Strides& st, int window, float cap, float scale,
                   int n_splits, int run, int q_bf16, cudaStream_t stream) {
    const int R = G >= kWarps ? 1 : kWarps / G;
    const long long smem = smem_bytes(G, D, (int)sizeof(TKV), n_splits * R);
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split_kernel<TKV, CPL, HPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    decode_attention_split_kernel<TKV, CPL, HPW>
        <<<dim3((unsigned)Hkv, (unsigned)n_splits, (unsigned)B), kThreads,
           (size_t)smem, stream>>>(q, (const TKV*)k, (const TKV*)v, kv_valid,
                                   o, part, tickets, G, S, D, st, window, cap,
                                   scale, run, q_bf16);
    return cudaGetLastError();
}

template <typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kv_valid, void* o, float* part,
                     unsigned* tickets, int B, int Hkv, int G, int S, int D,
                     const Strides& st, int window, float cap, float scale,
                     int n_splits, int run, int q_bf16, cudaStream_t s) {
    const int cpl = (D * (int)sizeof(TKV) / 16 + 31) / 32;
#define DA_LAUNCH(C, H)                                                    \
    return launch<TKV, C, H>(q, k, v, kv_valid, o, part, tickets, B, Hkv,  \
                             G, S, D, st, window, cap, scale, n_splits, run, \
                             q_bf16, s)
    if (G <= kWarps) {
        if (cpl == 1) DA_LAUNCH(1, 1);
        if constexpr (sizeof(TKV) == 4)         // f32 rows over 512 bytes
            if (cpl == 2) DA_LAUNCH(2, 1);
    } else if (G <= 4 * kWarps) {
        if (cpl == 1) DA_LAUNCH(1, 4);
        if constexpr (sizeof(TKV) == 4)
            if (cpl == 2) DA_LAUNCH(2, 4);
    }
#undef DA_LAUNCH
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs: G query heads a kv head,
// head dimension D, kv dtype code (0 = float32, 1 = bfloat16), n_splits
// splits of the rows.
long long decode_attention_smem_bytes(int G, int D, int kv_dtype,
                                      int n_splits) {
    const int R = G >= kWarps ? 1 : kWarps / G;
    return smem_bytes(G, D, kv_dtype == 0 ? 4 : 2, n_splits * R);
}

// strides: 8 element strides, q (B, H), k (B, H, S), v (B, H, S); D has
// unit stride; o is a contiguous (B, Hq, D); k and v rows are read 16
// bytes at a time (D * element size, base pointers and strides multiples
// of 16, as the wrapper checks).  kv_valid is (B,) int32 on the device.
// part is float32 scratch of B * Hkv * n_splits * R * G * (D + 2) values
// (R = 4 / G warps a head when G < 4, else 1); tickets is B * Hkv
// unsigned ints, zero before the first call (each call leaves them zero);
// two launches that may overlap (two streams) need their own.
// n_splits splits of `run` rows cover the longest visible range.  Dtype
// codes: 0 = float32, 1 = bfloat16.  window <= 0 means none, cap <= 0
// none.  Returns the CUDA error code of the attribute call or of the
// launch (0 = launched); D > 256, G > 16 or an unknown dtype returns
// cudaErrorInvalidValue.
int decode_attention_forward(const void* q, const void* k, const void* v,
                             const void* kv_valid, void* o, void* part,
                             void* tickets, int B, int Hq, int Hkv, int S,
                             int D, const long long* strides, int window,
                             float cap, float scale, int n_splits, int run,
                             int q_dtype, int kv_dtype, void* stream) {
    Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7]};
    const int G = Hq / Hkv;
    const int* kvv = (const int*)kv_valid;
    cudaStream_t s = (cudaStream_t)stream;
    if ((q_dtype != 0 && q_dtype != 1) || n_splits < 1 || run < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaErrorInvalidValue;
    if (kv_dtype == 0)
        err = dispatch<float>(q, k, v, kvv, o, (float*)part,
                              (unsigned*)tickets, B, Hkv, G, S, D, st,
                              window, cap, scale, n_splits, run, q_dtype, s);
    else if (kv_dtype == 1)
        err = dispatch<__nv_bfloat16>(q, k, v, kvv, o, (float*)part,
                                      (unsigned*)tickets, B, Hkv, G, S, D, st,
                                      window, cap, scale, n_splits, run,
                                      q_dtype, s);
    return (int)err;
}

const char* decode_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
