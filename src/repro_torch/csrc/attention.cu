// Block-wise (flash) attention for Hopper (sm_90a): online softmax with f32
// accumulation over KV tiles; GQA, causal / sliding-window / bidirectional-
// prefix masks, tanh soft-capping and a query offset.  Two variants, picked
// by the caller from the inputs' dtype:
//
//   flash_mma_kernel  bf16 inputs: the products on the tensor cores
//                     (mma.sync m16n8k16, bf16 in, f32 accumulate);
//   flash_f32_kernel  f32 inputs: the products on the CUDA cores in f32
//                     (TF32 would round the inputs to 10 mantissa bits).
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py flash_attention.
// The TPU kernel runs a (B*Hq, q tile, KV tile) grid in order, keeping the
// running max, normaliser and accumulator in VMEM scratch across the KV axis
// and feeding the MXU 128-wide tiles.  Here one thread block owns one
// (batch*head, q tile) and sweeps the KV tiles itself, so no state crosses
// blocks.
//
// What bounds it on an H100: operations.  Causal T = 4096, 32 heads,
// D = 128 is ~137 GFLOP of visible work against ~84 MB of bytes, so in
// bf16 the tensor cores' rate is the limit (0.139 ms at 989 TFLOP/s), far
// above what the CUDA cores can give (2.05 ms at 67 TFLOP/s in f32).  The
// bf16 variant is built in the FlashAttention-2 shape for that:
//
// * each warp owns 16 query rows, a block 4 warps (BQ = 64, BK = 32);
//   S = Q K^T of a [BQ, BK] tile is formed
//   by mma.sync from fragments that ldmatrix reads out of shared memory,
//   which holds bf16 as stored (never widened);
// * the scores stay in the f32 accumulator fragments: scale, soft cap, mask
//   and the online softmax run in registers, the row max takes two quad
//   shuffles, the row sum is kept per thread and reduced once at the end;
//   no score goes to shared memory and the softmax needs no block barrier.
//   The softmax runs in base 2 (scores times scale * log2(e), one ex2 on
//   the special-function unit per score), so that the exponentials do not
//   compete with the products for issue slots;
// * each pair of m16n8 score fragments is the A fragment of one m16n8k16
//   product, so P is converted to bf16 in registers and multiplied by V
//   (fragments by ldmatrix.trans); O accumulates in f32 registers.  P goes
//   in two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), with one product
//   each: P in one bf16 (2^-9 relative per weight) broke the f32 oracle's
//   bf16 tolerance on a D = 256 case, hi + lo keeps ~2^-17 for half again
//   the products;
// * K and V tiles arrive by 16-byte cp.async.cg copies into a ring of two
//   stages: the next visited tile is in flight while this one is used.
//   Shared rows are padded by 16 bytes, which makes every ldmatrix free of
//   bank conflicts for any padded D (a multiple of 16);
// * the scale is applied to the f32 scores after the product, as the
//   oracle does (D^-0.5 folded into bf16 Q would be rounded); the one
//   rounding the oracle does not make is that of P's lo part;
// * the q tiles run heaviest first (q tile n_qt - 1 - blockIdx.y, B*Hq on
//   blockIdx.x), so the causal grid ends on short blocks and the q heads of
//   one KV group run side by side (their K/V stay in L2).
//
// Masks follow the oracle repro/kernels/ref.py attention_ref: a KV tile is
// skipped only when no key in it is visible to any row of the q tile, and a
// tile that holds prefix keys is never skipped.  Inside a visited tile a
// warp skips the products when no key is visible to its 16 rows (an exact
// skip: it would add p = 0 with alpha = 1), and applies the per-element mask
// only on tiles that straddle an edge (the diagonal, the window's lower edge,
// the prefix edge, the ragged end of Tk).  Masked probabilities are exactly
// 0; the output is acc / max(l, 1e-30) rounded once to the output dtype.
//
// The next redesign is wgmma with TMA and warp specialisation (a producer
// warp keeping the ring full, consumer warpgroups on 64-row tiles).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_F (-1e30f)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ bool visible(int qp, int kp, int Tk, bool causal,
                                        int window, int prefix) {
    if (kp >= Tk) return false;
    if (!causal) return true;
    bool c = kp <= qp;
    if (window > 0) c = c && (kp > qp - window);
    if (prefix > 0) c = c || (kp < prefix);
    return c;
}

// Some key of [k0, k_last] is visible to some query of [qp0, qp1]: the skip
// rule of kernels.attention.visited_tiles.
__device__ __forceinline__ bool tile_needed(int k0, int k_last, int qp0,
                                            int qp1, bool causal, int window,
                                            int prefix) {
    return !causal || (prefix > 0 && k0 < prefix)
           || (k0 <= qp1 && (window <= 0 || k_last > qp0 - window));
}

// ---------------------------------------------------------------------------
// f32 variant: CUDA cores
// ---------------------------------------------------------------------------
//
// One block owns one (64-row q tile, batch*head) and sweeps 32-key tiles.
// Q and one K/V tile sit in shared memory, the 64 x 32 score tile is
// computed by the block's own loop (8 scores per thread, float4 reads along
// D), and the running max / normaliser live in registers of the 4 threads
// that share a row, with that row's accumulator split over them by columns
// of D (D / 4 registers each).  D is padded to a multiple of 4 in shared
// memory only; D <= 256.

#define F_BQ 64
#define F_BK 32
#define F_NT 256
#define F_SS (F_BK + 4)      // score-tile row stride (conflict-free rows)

static size_t f32_smem_bytes(int Dp) {
    return sizeof(float) * ((size_t)F_BQ * Dp + (size_t)F_BK * (Dp + 4)
                            + (size_t)F_BK * Dp + (size_t)F_BQ * F_SS);
}

template <int DMAX>
__global__ void __launch_bounds__(F_NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int* __restrict__ visited, int Tq, int Tk, int Hq, int Hkv,
                 int D, float scale, float softcap, int causal, int window,
                 int prefix, int q_offset) {
    extern __shared__ float4 smem4[];
    const int Dp = (D + 3) & ~3;
    float* sQ = (float*)smem4;                 // [BQ][Dp]
    float* sK = sQ + F_BQ * Dp;                // [BK][Dp + 4]
    float* sV = sK + F_BK * (Dp + 4);          // [BK][Dp]
    float* sS = sV + F_BK * Dp;                // [BQ][SS]
    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * F_BQ;
    const int bh = blockIdx.y;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int64_t q_row = (int64_t)Hq * D, k_row = (int64_t)Hkv * D;
    const float* qb = q + ((int64_t)b * Tq) * q_row + (int64_t)h * D;
    const float* kb = k + ((int64_t)b * Tk) * k_row + (int64_t)hk * D;
    const float* vb = v + ((int64_t)b * Tk) * k_row + (int64_t)hk * D;

    for (int i = tid; i < F_BQ * Dp; i += F_NT) {
        int r = i / Dp, d = i - r * Dp, t = q0 + r;
        sQ[i] = (t < Tq && d < D) ? qb[t * q_row + d] : 0.0f;
    }

    // score phase: rows 2*ty + {0,1}, columns tx + 8*{0..3}
    const int ty = tid >> 3, tx = tid & 7;
    // row phase and PV: row r, a quarter of its columns / of D
    const int r = tid >> 2, part = tid & 3;
    const int qp_r = q_offset + q0 + r;
    float m_run = NEG_F, l_run = 0.0f;
    float acc[DMAX / 16][4];
#pragma unroll
    for (int i = 0; i < DMAX / 16; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

    const int qp0 = q_offset + q0;
    const int qp1 = q_offset + min(q0 + F_BQ, Tq) - 1;
    const int n_kt = (Tk + F_BK - 1) / F_BK;
    int n_visited = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * F_BK;
        const int k_last = min(k0 + F_BK, Tk) - 1;
        if (!tile_needed(k0, k_last, qp0, qp1, causal, window, prefix))
            continue;                          // uniform over the block
        ++n_visited;
        __syncthreads();                       // previous tile fully used
        for (int i = tid; i < F_BK * Dp; i += F_NT) {
            int rr = i / Dp, d = i - rr * Dp, t = k0 + rr;
            bool ok = t < Tk && d < D;
            sK[rr * (Dp + 4) + d] = ok ? kb[t * k_row + d] : 0.0f;
            sV[rr * Dp + d] = ok ? vb[t * k_row + d] : 0.0f;
        }
        __syncthreads();

        float s[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        const float4* q4 = (const float4*)sQ;
        const float4* k4 = (const float4*)sK;
        const int dq = Dp >> 2, dk = (Dp + 4) >> 2;
        for (int d4 = 0; d4 < dq; ++d4) {
            float4 qa = q4[(2 * ty) * dq + d4];
            float4 qc = q4[(2 * ty + 1) * dq + d4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float4 kk = k4[(tx + 8 * j) * dk + d4];
                s[0][j] += qa.x * kk.x; s[0][j] += qa.y * kk.y;
                s[0][j] += qa.z * kk.z; s[0][j] += qa.w * kk.w;
                s[1][j] += qc.x * kk.x; s[1][j] += qc.y * kk.y;
                s[1][j] += qc.z * kk.z; s[1][j] += qc.w * kk.w;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            int row = 2 * ty + i, qp = q_offset + q0 + row;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int col = tx + 8 * j;
                float val = s[i][j] * scale;
                if (softcap > 0.0f) val = softcap * tanhf(val / softcap);
                sS[row * F_SS + col] = visible(qp, k0 + col, Tk, causal,
                                               window, prefix) ? val : NEG_F;
            }
        }
        __syncthreads();

        // online softmax over this tile, 4 threads per row
        float vals[F_BK / 4];
        float mx = NEG_F;
#pragma unroll
        for (int c4 = 0; c4 < F_BK / 4; ++c4) {
            vals[c4] = sS[r * F_SS + part + 4 * c4];
            mx = fmaxf(mx, vals[c4]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < F_BK / 4; ++c4) {
            int col = part + 4 * c4;
            float p = visible(qp_r, k0 + col, Tk, causal, window, prefix)
                      ? expf(vals[c4] - m_new) : 0.0f;
            sS[r * F_SS + col] = p;
            sum += p;
        }
        sum += __shfl_xor_sync(FULL_MASK, sum, 1);
        sum += __shfl_xor_sync(FULL_MASK, sum, 2);
        const float alpha = expf(m_run - m_new);
        l_run = l_run * alpha + sum;
        m_run = m_new;
#pragma unroll
        for (int i = 0; i < DMAX / 16; ++i) {
            acc[i][0] *= alpha; acc[i][1] *= alpha;
            acc[i][2] *= alpha; acc[i][3] *= alpha;
        }
        __syncwarp();                          // row r's p written by its warp

        const float4* v4 = (const float4*)sV;
        for (int c = 0; c < F_BK; ++c) {
            float p = sS[r * F_SS + c];
#pragma unroll
            for (int i = 0; i < DMAX / 16; ++i) {
                int dcol = 16 * i + 4 * part;
                if (dcol < Dp) {
                    float4 vv = v4[(c * Dp + dcol) >> 2];
                    acc[i][0] += p * vv.x; acc[i][1] += p * vv.y;
                    acc[i][2] += p * vv.z; acc[i][3] += p * vv.w;
                }
            }
        }
    }

    const int t = q0 + r;
    if (t < Tq) {
        const float l = fmaxf(l_run, 1e-30f);
        float* ob = out + ((int64_t)b * Tq + t) * q_row + (int64_t)h * D;
#pragma unroll
        for (int i = 0; i < DMAX / 16; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int dcol = 16 * i + 4 * part + e;
                if (dcol < D) ob[dcol] = acc[i][e] / l;
            }
    }
    if (visited && tid == 0)
        visited[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = n_visited;
}

template <int DMAX>
static int launch_f32(const float* q, const float* k, const float* v,
                      float* out, int* visited, int B, int Tq, int Tk, int Hq,
                      int Hkv, int D, float scale, float softcap, int causal,
                      int window, int prefix, int q_offset,
                      cudaStream_t stream) {
    static bool attr_set = false;
    auto kern = flash_f32_kernel<DMAX>;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)f32_smem_bytes(DMAX));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    dim3 grid((Tq + F_BQ - 1) / F_BQ, B * Hq);
    kern<<<grid, F_NT, f32_smem_bytes((D + 3) & ~3), stream>>>(
        q, k, v, out, visited, Tq, Tk, Hq, Hkv, D, scale, softcap, causal,
        window, prefix, q_offset);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 variant: tensor cores
// ---------------------------------------------------------------------------

#define LOG2E_F 1.4426950408889634f

// 2^x on the special-function unit (~2 ulp; 2^-huge = +0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// (x, y) as two bf16 pairs: hi = bf16(x, y) and lo = bf16(x - hi, y - hi)
// (the differences are exact in f32)
__device__ __forceinline__ void pack_split(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

// The tile shape (kernels.attention.variant repeats it): 4 warps, 64 q
// rows, 32-key tiles.  At D = 128 a thread holds ~160 registers and a block
// 52 KB of shared memory, so three blocks share an SM and hide each other's
// barrier waits; with 64-key tiles two fit, with 8 warps and 128 rows one.
template <int DP> struct MmaTile {
    static constexpr int BQ = 64;
    static constexpr int BK = 32;
    static constexpr int NT = BQ / 16 * 32;      // one warp per 16 rows
    static constexpr int LD = DP + 8;            // shared row: +16 bytes
    static constexpr size_t SMEM =
        sizeof(__nv_bfloat16) * ((size_t)BQ * LD + 4 * (size_t)BK * LD);
};

// Rows [row0, row0 + n_rows) of a [T, ld] bf16 head slice into a shared
// [n_rows][LD] tile, zero beyond T and beyond D.  vec: 16-byte cp.async
// copies (D % 8 == 0 and 16-byte aligned rows); else scalar loads.
template <int DP, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t ld, int row0, int n_rows,
                                          int T, int D, bool vec) {
    constexpr int LD = DP + 8, CH = DP / 8;
    if (vec) {
        for (int i = threadIdx.x; i < n_rows * CH; i += NT) {
            int rr = i / CH, c = i - rr * CH, t = row0 + rr;
            bool ok = t < T && c * 8 < D;
            const __nv_bfloat16* g = ok ? src + t * ld + c * 8 : src;
            cp_async16(dst + rr * LD + c * 8, g, ok ? 16 : 0);
        }
    } else {
        for (int i = threadIdx.x; i < n_rows * DP; i += NT) {
            int rr = i / DP, d = i - rr * DP, t = row0 + rr;
            dst[rr * LD + d] = (t < T && d < D) ? src[t * ld + d]
                                                : __float2bfloat16_rn(0.0f);
        }
    }
}

template <int DP>
__global__ void __launch_bounds__(MmaTile<DP>::NT)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int* __restrict__ visited,
                 int Tq, int Tk, int Hq, int Hkv, int D, float scale,
                 float softcap, int causal, int window, int prefix,
                 int q_offset, int vec) {
    constexpr int BQ = MmaTile<DP>::BQ, BK = MmaTile<DP>::BK;
    constexpr int NT = MmaTile<DP>::NT, LD = MmaTile<DP>::LD;
    constexpr int NS = BK / 8;     // score n-tiles per warp row block
    constexpr int NO = DP / 8;     // output n-tiles
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sK = sQ + BQ * LD;            // [2][BK][LD]
    __nv_bfloat16* sV = sK + 2 * BK * LD;        // [2][BK][LD]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int bh = blockIdx.x;
    const int n_qt = gridDim.y;
    const int qt = n_qt - 1 - blockIdx.y;        // heaviest q tiles first
    const int q0 = qt * BQ;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int64_t q_row = (int64_t)Hq * D, k_row = (int64_t)Hkv * D;
    const __nv_bfloat16* qb = q + ((int64_t)b * Tq) * q_row + (int64_t)h * D;
    const __nv_bfloat16* kb = k + ((int64_t)b * Tk) * k_row + (int64_t)hk * D;
    const __nv_bfloat16* vb = v + ((int64_t)b * Tk) * k_row + (int64_t)hk * D;
    const bool is_causal = causal != 0;
    // the softmax runs in base 2: scores times log2(e), exponentials by ex2
    const float scale2 = scale * LOG2E_F;

    const int qp0 = q_offset + q0;
    const int qp1 = q_offset + min(q0 + BQ, Tq) - 1;
    // this warp's rows (clamped to Tq; a warp wholly beyond Tq idles)
    const int wr0 = q0 + 16 * warp;
    const bool warp_rows = wr0 < Tq;
    const int wqp0 = q_offset + wr0;
    const int wqp1 = q_offset + min(wr0 + 16, Tq) - 1;
    const int qp_a = q_offset + wr0 + g, qp_b = qp_a + 8;   // rows g, g + 8
    const int n_kt = (Tk + BK - 1) / BK;

    auto next_tile = [&](int kt) {
        for (++kt; kt < n_kt; ++kt)
            if (tile_needed(kt * BK, min(kt * BK + BK, Tk) - 1, qp0, qp1,
                            is_causal, window, prefix))
                break;
        return kt;
    };

    load_rows<DP, NT>(sQ, qb, q_row, q0, BQ, Tq, D, vec);
    int kt = next_tile(-1);
    if (kt < n_kt) {
        load_rows<DP, NT>(sK, kb, k_row, kt * BK, BK, Tk, D, vec);
        load_rows<DP, NT>(sV, vb, k_row, kt * BK, BK, Tk, D, vec);
    }
    cp_async_commit();

    float o[NO][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
    float m_a = NEG_F, m_b = NEG_F, l_a = 0.0f, l_b = 0.0f;
    int n_visited = 0;

    for (int stage = 0; kt < n_kt; stage ^= 1) {
        const int nxt = next_tile(kt);
        if (nxt < n_kt) {
            load_rows<DP, NT>(sK + (stage ^ 1) * BK * LD, kb, k_row,
                              nxt * BK, BK, Tk, D, vec);
            load_rows<DP, NT>(sV + (stage ^ 1) * BK * LD, vb, k_row,
                              nxt * BK, BK, Tk, D, vec);
        }
        cp_async_commit();
        cp_async_wait<1>();                    // this tile (and Q) landed
        __syncthreads();
        ++n_visited;

        const int k0 = kt * BK, k_last = min(k0 + BK, Tk) - 1;
        const __nv_bfloat16* tK = sK + stage * BK * LD;
        const __nv_bfloat16* tV = sV + stage * BK * LD;
        if (warp_rows && tile_needed(k0, k_last, wqp0, wqp1, is_causal,
                                     window, prefix)) {
            // ---- S = Q K^T on the tensor cores ----------------------------
            float s[NS][4];
#pragma unroll
            for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
                uint32_t a[4];
                ldsm_x4(a, sQ + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                               + kk * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int j2 = 0; j2 < NS / 2; ++j2) {
                    uint32_t bk[4];
                    ldsm_x4(bk, tK + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                                    + kk * 16 + ((lane >> 3) & 1) * 8);
                    mma_bf16(s[2 * j2], a, bk[0], bk[1]);
                    mma_bf16(s[2 * j2 + 1], a, bk[2], bk[3]);
                }
            }
            // ---- scale, soft cap, edge mask, online softmax --------------
            const bool full = k0 + BK <= Tk
                && (!is_causal || k_last < prefix
                    || (k_last <= wqp0 && (window <= 0 || k0 > wqp1 - window)));
            float mx_a = NEG_F, mx_b = NEG_F;
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float val = softcap > 0.0f
                        ? softcap * tanhf(s[j][e] * scale / softcap) * LOG2E_F
                        : s[j][e] * scale2;
                    if (!full) {
                        int kp = k0 + 8 * j + 2 * tq + (e & 1);
                        if (!visible(e < 2 ? qp_a : qp_b, kp, Tk, is_causal,
                                     window, prefix))
                            val = NEG_F;
                    }
                    s[j][e] = val;
                    if (e < 2) mx_a = fmaxf(mx_a, val);
                    else mx_b = fmaxf(mx_b, val);
                }
            mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, 1));
            mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, 2));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, 1));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, 2));
            const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
            const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
            m_a = mn_a; m_b = mn_b;
            float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float mn = e < 2 ? mn_a : mn_b;
                    // masked entries are exactly 0, also while the row has
                    // seen no visible key (m = -1e30)
                    float p = (full || s[j][e] != NEG_F)
                              ? ex2(s[j][e] - mn) : 0.0f;
                    s[j][e] = p;
                    if (e < 2) sum_a += p; else sum_b += p;
                }
            l_a = l_a * al_a + sum_a;
            l_b = l_b * al_b + sum_b;
#pragma unroll
            for (int i = 0; i < NO; ++i) {
                o[i][0] *= al_a; o[i][1] *= al_a;
                o[i][2] *= al_b; o[i][3] *= al_b;
            }
            // ---- O += P V on the tensor cores ------------------------------
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t a[4], a_lo[4];
                pack_split(s[2 * kk][0], s[2 * kk][1], a[0], a_lo[0]);
                pack_split(s[2 * kk][2], s[2 * kk][3], a[1], a_lo[1]);
                pack_split(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], a_lo[2]);
                pack_split(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], a_lo[3]);
#pragma unroll
                for (int n2 = 0; n2 < DP / 16; ++n2) {
                    uint32_t bv[4];
                    ldsm_x4_trans(bv, tV + (kk * 16 + (lane & 7)
                                            + ((lane >> 3) & 1) * 8) * LD
                                         + n2 * 16 + (lane >> 4) * 8);
                    mma_bf16(o[2 * n2], a, bv[0], bv[1]);
                    mma_bf16(o[2 * n2 + 1], a, bv[2], bv[3]);
                    mma_bf16(o[2 * n2], a_lo, bv[0], bv[1]);
                    mma_bf16(o[2 * n2 + 1], a_lo, bv[2], bv[3]);
                }
            }
        }
        __syncthreads();                       // stage free for the next load
        kt = nxt;
    }
    cp_async_wait<0>();

    // ---- epilogue: reduce the row sums over the quad, write bf16 ----------
    l_a += __shfl_xor_sync(FULL_MASK, l_a, 1);
    l_a += __shfl_xor_sync(FULL_MASK, l_a, 2);
    l_b += __shfl_xor_sync(FULL_MASK, l_b, 1);
    l_b += __shfl_xor_sync(FULL_MASK, l_b, 2);
    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    const int ta = wr0 + g, tb = ta + 8;
    __nv_bfloat16* oa = out + ((int64_t)b * Tq + ta) * q_row + (int64_t)h * D;
    __nv_bfloat16* ob = oa + 8 * q_row;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
        const int d = 8 * i + 2 * tq;
        if (d >= D) continue;
        const bool two = d + 1 < D;
        if (ta < Tq) {
            oa[d] = __float2bfloat16_rn(o[i][0] * inv_a);
            if (two) oa[d + 1] = __float2bfloat16_rn(o[i][1] * inv_a);
        }
        if (tb < Tq) {
            ob[d] = __float2bfloat16_rn(o[i][2] * inv_b);
            if (two) ob[d + 1] = __float2bfloat16_rn(o[i][3] * inv_b);
        }
    }
    if (visited && tid == 0)
        visited[(int64_t)bh * n_qt + qt] = n_visited;
}

template <int DP>
static int launch_mma(const void* q, const void* k, const void* v, void* out,
                      int* visited, int B, int Tq, int Tk, int Hq, int Hkv,
                      int D, float scale, float softcap, int causal,
                      int window, int prefix, int q_offset,
                      cudaStream_t stream) {
    using Tile = MmaTile<DP>;
    static bool attr_set = false;
    auto kern = flash_mma_kernel<DP>;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)Tile::SMEM);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const int vec = D % 8 == 0
        && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    dim3 grid(B * Hq, (Tq + Tile::BQ - 1) / Tile::BQ);
    kern<<<grid, Tile::NT, Tile::SMEM, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, visited, Tq, Tk, Hq,
        Hkv, D, scale, softcap, causal, window, prefix, q_offset, vec);
    return (int)cudaGetLastError();
}

// f32 q, k, v and out.  visited may be NULL; otherwise it receives, per
// block, the number of KV tiles visited (index q tile + n_qt * (b*Hq + h)).
extern "C" int flash_attention_f32_launch(
        const void* q, const void* k, const void* v, void* out, int* visited,
        int B, int Tq, int Tk, int Hq, int Hkv, int D, float scale,
        float softcap, int causal, int window, int prefix, int q_offset,
        void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float *fq = (const float*)q, *fk = (const float*)k,
                *fv = (const float*)v;
    float* fo = (float*)out;
    int Dp = (D + 3) & ~3;
    if (Dp <= 64)
        return launch_f32<64>(fq, fk, fv, fo, visited, B, Tq, Tk, Hq, Hkv, D,
                              scale, softcap, causal, window, prefix,
                              q_offset, s);
    if (Dp <= 128)
        return launch_f32<128>(fq, fk, fv, fo, visited, B, Tq, Tk, Hq, Hkv,
                               D, scale, softcap, causal, window, prefix,
                               q_offset, s);
    if (Dp <= 256)
        return launch_f32<256>(fq, fk, fv, fo, visited, B, Tq, Tk, Hq, Hkv,
                               D, scale, softcap, causal, window, prefix,
                               q_offset, s);
    return (int)cudaErrorInvalidValue;
}

// bf16 q, k, v and out; D is padded in shared memory to 16, 32, 64, 128 or
// 256.  visited as above.
extern "C" int flash_attention_bf16_launch(
        const void* q, const void* k, const void* v, void* out, int* visited,
        int B, int Tq, int Tk, int Hq, int Hkv, int D, float scale,
        float softcap, int causal, int window, int prefix, int q_offset,
        void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define FLASH_MMA(DP)                                                        \
    if (D <= DP)                                                             \
        return launch_mma<DP>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, D,  \
                              scale, softcap, causal, window, prefix,        \
                              q_offset, s);
    FLASH_MMA(16)
    FLASH_MMA(32)
    FLASH_MMA(64)
    FLASH_MMA(128)
    FLASH_MMA(256)
#undef FLASH_MMA
    return (int)cudaErrorInvalidValue;
}
