// Block-wise (flash) attention for Hopper (sm_90a): online softmax with f32
// accumulation over KV tiles; GQA, causal / sliding-window / bidirectional-
// prefix masks, tanh soft-capping and a query offset.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py flash_attention.
// The TPU kernel runs a (B*Hq, q tile, KV tile) grid in order, keeping the
// running max, normaliser and accumulator in VMEM scratch across the KV axis
// and feeding the MXU 128-wide tiles.  Here one thread block owns one
// (batch*head, 64-row q tile) and sweeps the KV tiles itself: the Q tile and
// one K/V tile sit in shared memory as f32, the 64 x 32 score tile is
// computed by the block's own loop (8 scores per thread, float4 reads along
// D), and the running max / normaliser live in registers of the 4 threads
// that share a row, with that row's accumulator split over them by columns
// of D (D / 4 registers each).  D is padded to a multiple of 4 in shared
// memory only; D <= 256.
//
// Masks follow the oracle repro/kernels/ref.py attention_ref: a KV tile is
// skipped only when no key in it is visible to any row of the q tile, and a
// tile that holds prefix keys is never skipped.  Masked scores are -1e30 and
// their probabilities exactly 0, so a row whose first visited tile is fully
// masked keeps m = -1e30, l = 0 until a visible key arrives.  The output is
// acc / max(l, 1e-30) rounded once to the output dtype.
//
// What bounds it on an H100: operations.  Causal T = 4096, 32 heads,
// D = 128 is ~137 GFLOP of visible work against ~84 MB of bytes.  This
// first version does its products on the CUDA cores in f32 (shared-memory
// reads feed the FMAs); wgmma on the tensor cores is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BQ 64
#define BK 32
#define NT 256
#define SS (BK + 4)          // score-tile row stride (conflict-free rows)
#define NEG_F (-1e30f)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool visible(int qp, int kp, int Tk, bool causal,
                                        int window, int prefix) {
    if (kp >= Tk) return false;
    if (!causal) return true;
    bool c = kp <= qp;
    if (window > 0) c = c && (kp > qp - window);
    if (prefix > 0) c = c || (kp < prefix);
    return c;
}

static size_t smem_bytes(int Dp) {
    return sizeof(float) * ((size_t)BQ * Dp + (size_t)BK * (Dp + 4)
                            + (size_t)BK * Dp + (size_t)BQ * SS);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             int* __restrict__ visited, int Tq, int Tk, int Hq, int Hkv,
             int D, float scale, float softcap, int causal, int window,
             int prefix, int q_offset) {
    extern __shared__ float4 smem4[];
    const int Dp = (D + 3) & ~3;
    float* sQ = (float*)smem4;                 // [BQ][Dp]
    float* sK = sQ + BQ * Dp;                  // [BK][Dp + 4]
    float* sV = sK + BK * (Dp + 4);            // [BK][Dp]
    float* sS = sV + BK * Dp;                  // [BQ][SS]
    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int64_t q_row = (int64_t)Hq * D, k_row = (int64_t)Hkv * D;
    const T* qb = q + ((int64_t)b * Tq) * q_row + (int64_t)h * D;
    const T* kb = k + ((int64_t)b * Tk) * k_row + (int64_t)hk * D;
    const T* vb = v + ((int64_t)b * Tk) * k_row + (int64_t)hk * D;

    for (int i = tid; i < BQ * Dp; i += NT) {
        int r = i / Dp, d = i - r * Dp, t = q0 + r;
        sQ[i] = (t < Tq && d < D) ? to_f32(qb[t * q_row + d]) : 0.0f;
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
    const int qp1 = q_offset + min(q0 + BQ, Tq) - 1;
    const int n_kt = (Tk + BK - 1) / BK;
    int n_visited = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        const int k_last = min(k0 + BK, Tk) - 1;
        bool need = !causal || (prefix > 0 && k0 < prefix)
                    || (k0 <= qp1 && (window <= 0 || k_last > qp0 - window));
        if (!need) continue;                   // uniform over the block
        ++n_visited;
        __syncthreads();                       // previous tile fully used
        for (int i = tid; i < BK * Dp; i += NT) {
            int rr = i / Dp, d = i - rr * Dp, t = k0 + rr;
            bool ok = t < Tk && d < D;
            sK[rr * (Dp + 4) + d] = ok ? to_f32(kb[t * k_row + d]) : 0.0f;
            sV[rr * Dp + d] = ok ? to_f32(vb[t * k_row + d]) : 0.0f;
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
                sS[row * SS + col] = visible(qp, k0 + col, Tk, causal,
                                             window, prefix) ? val : NEG_F;
            }
        }
        __syncthreads();

        // online softmax over this tile, 4 threads per row
        float vals[BK / 4];
        float mx = NEG_F;
#pragma unroll
        for (int c4 = 0; c4 < BK / 4; ++c4) {
            vals[c4] = sS[r * SS + part + 4 * c4];
            mx = fmaxf(mx, vals[c4]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < BK / 4; ++c4) {
            int col = part + 4 * c4;
            float p = visible(qp_r, k0 + col, Tk, causal, window, prefix)
                      ? expf(vals[c4] - m_new) : 0.0f;
            sS[r * SS + col] = p;
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
        for (int c = 0; c < BK; ++c) {
            float p = sS[r * SS + c];
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
        T* ob = out + ((int64_t)b * Tq + t) * q_row + (int64_t)h * D;
#pragma unroll
        for (int i = 0; i < DMAX / 16; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int dcol = 16 * i + 4 * part + e;
                if (dcol < D) store(&ob[dcol], acc[i][e] / l);
            }
    }
    if (visited && tid == 0)
        visited[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = n_visited;
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int* visited, int B, int Tq, int Tk, int Hq, int Hkv,
                  int D, float scale, float softcap, int causal, int window,
                  int prefix, int q_offset, cudaStream_t stream) {
    static bool attr_set = false;
    auto kern = flash_kernel<T, DMAX>;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(DMAX));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
    kern<<<grid, NT, smem_bytes((D + 3) & ~3), stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, visited, Tq, Tk, Hq,
        Hkv, D, scale, softcap, causal, window, prefix, q_offset);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int* visited, int B, int Tq, int Tk, int Hq, int Hkv,
                    int D, float scale, float softcap, int causal,
                    int window, int prefix, int q_offset,
                    cudaStream_t stream) {
    int Dp = (D + 3) & ~3;
    if (Dp <= 64)
        return launch<T, 64>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, D,
                             scale, softcap, causal, window, prefix,
                             q_offset, stream);
    if (Dp <= 128)
        return launch<T, 128>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, D,
                              scale, softcap, causal, window, prefix,
                              q_offset, stream);
    if (Dp <= 256)
        return launch<T, 256>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, D,
                              scale, softcap, causal, window, prefix,
                              q_offset, stream);
    return (int)cudaErrorInvalidValue;
}

// dtype code: 0 = f32, 1 = bf16 (q, k, v and out share it).  visited may be
// NULL; otherwise it receives, per block, the number of KV tiles visited.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* out, int* visited,
        int B, int Tq, int Tk, int Hq, int Hkv, int D, float scale,
        float softcap, int causal, int window, int prefix, int q_offset,
        int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, D,
                               scale, softcap, causal, window, prefix,
                               q_offset, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, out, visited, B, Tq, Tk, Hq,
                                       Hkv, D, scale, softcap, causal,
                                       window, prefix, q_offset, s);
    return (int)cudaErrorInvalidValue;
}
