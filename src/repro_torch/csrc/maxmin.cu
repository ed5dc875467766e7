// Max-min fair-share kernels for Hopper (sm_90a): the whole progressive
// filling in one thread block (maxmin_solve), and one round's per-spreader
// headroom over a grid of blocks (fill_stats).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   repro/kernels/maxmin.py  maxmin_solve (_solve_kernel)  and
//   repro/kernels/maxmin.py  fill_stats   (_kernel).
// The TPU kernels turn each segmented sum into one-hot MXU contractions.
// Here every segmented sum is a serial walk over its segment in ascending
// flow index, starting from +0.0, so each sum adds the same terms in the
// same order as the plain PyTorch version (index_add_ on the CPU) and the
// JAX reference's segment_sum: the rates are bit-identical to the plain
// version and identical from run to run.  No float atomics anywhere.
//
// What bounds them on an H100: at the engine's sizes (C ~ 5k flows, S ~ 6k
// spreaders) the work is a few hundred kilobytes per call, so one launch
// (a few microseconds) and the dependent rounds inside the single block
// bound maxmin_solve; fill_stats is bound by its launch and its O(S*C)
// shared-memory scan.  Neither touches the tensor cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math: the freeze test and the headroom division must round
// as the plain version does).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#define BIG_F 3.0e38f
#define FULL_MASK 0xffffffffu
#define SOLVE_THREADS 1024

__device__ __forceinline__ float block_min(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int nw = (blockDim.x + 31) >> 5;
    v = (threadIdx.x < nw) ? red[threadIdx.x] : BIG_F;
    if (warp == 0)
        for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
    if (threadIdx.x == 0) red[0] = v;
    __syncthreads();
    float out = red[0];
    __syncthreads();
    return out;
}

__device__ __forceinline__ int block_sum_int(int v, int* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int nw = (blockDim.x + 31) >> 5;
    v = (threadIdx.x < nw) ? red[threadIdx.x] : 0;
    if (warp == 0)
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    if (threadIdx.x == 0) red[0] = v;
    __syncthreads();
    int out = red[0];
    __syncthreads();
    return out;
}

// In-place inclusive prefix sum of a[0..n) by one block: each thread scans a
// contiguous chunk, the chunk totals are scanned across the block.
__device__ void block_inclusive_scan(int* a, int n, int* red) {
    int per = (n + blockDim.x - 1) / blockDim.x;
    int lo = threadIdx.x * per;
    int hi = min(lo + per, n);
    int run = 0;
    for (int i = lo; i < hi; ++i) { run += a[i]; a[i] = run; }
    // exclusive scan of the chunk totals
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int v = run;
    for (int o = 1; o < 32; o <<= 1) {
        int u = __shfl_up_sync(FULL_MASK, v, o);
        if (lane >= o) v += u;
    }
    __syncthreads();
    if (lane == 31) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int nw = (blockDim.x + 31) >> 5;
        int w = (lane < nw) ? red[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            int u = __shfl_up_sync(FULL_MASK, w, o);
            if (lane >= o) w += u;
        }
        red[lane] = w;   // inclusive over warps
    }
    __syncthreads();
    int offset = v - run + (warp > 0 ? red[warp - 1] : 0);
    for (int i = lo; i < hi; ++i) a[i] += offset;
    __syncthreads();
}

// Stable grouping of the live flows by segment id, done by one warp: flows
// are taken 32 at a time in index order, lanes that share a segment are
// ranked by lane, so every segment lists its flows in ascending index.
__device__ void warp_stable_fill(const int* __restrict__ seg_of,
                                 const uint8_t* __restrict__ live, int C,
                                 int* cursor, int* csr) {
    int lane = threadIdx.x & 31;
    unsigned lt = (1u << lane) - 1u;
    for (int base = 0; base < C; base += 32) {
        int j = base + lane;
        bool valid = (j < C) && live[j];
        int seg = valid ? seg_of[j] : -1;
        unsigned group = __match_any_sync(FULL_MASK, seg);
        int leader = __ffs(group) - 1;
        int start = 0;
        if (valid && lane == leader) {
            start = cursor[seg];
            cursor[seg] = start + __popc(group);
        }
        start = __shfl_sync(FULL_MASK, start, leader);
        if (valid) csr[start + __popc(group & lt)] = j;
        __syncwarp();
    }
}

// Dynamic shared memory: perf[S] dp[S] dc[S] offp[S+1] offc[S+1].
extern "C" size_t maxmin_solve_smem_bytes(int S) {
    return (size_t)3 * S * sizeof(float) + (size_t)2 * (S + 1) * sizeof(int);
}

__global__ void __launch_bounds__(SOLVE_THREADS)
maxmin_solve_kernel(const int* __restrict__ prov, const int* __restrict__ cons,
                    const float* __restrict__ p_l,
                    const uint8_t* __restrict__ live,
                    const float* __restrict__ perf_g,
                    float* r,                // [C] out, also the carry
                    float* df,               // [C] scratch
                    uint8_t* unfrozen,       // [C] scratch
                    int* csr_p, int* csr_c,  // [C] scratch
                    int C, int S, int max_iters, float thr_scale) {
    extern __shared__ float smem[];
    float* perf = smem;
    float* dp = perf + S;
    float* dc = dp + S;
    int* offp = reinterpret_cast<int*>(dc + S);
    int* offc = offp + S + 1;
    __shared__ float red_f[32];
    __shared__ int red_i[32];

    const int tid = threadIdx.x, nt = blockDim.x;

    // ---- once per call: CSR of the live flows by provider and consumer ----
    for (int s = tid; s <= S; s += nt) { offp[s] = 0; offc[s] = 0; }
    for (int s = tid; s < S; s += nt) perf[s] = perf_g[s];
    __syncthreads();
    int n_live = 0;
    for (int j = tid; j < C; j += nt) {
        uint8_t l = live[j];
        unfrozen[j] = l;
        r[j] = 0.0f;
        if (l) {
            atomicAdd(&offp[prov[j] + 1], 1);   // integer counts only
            atomicAdd(&offc[cons[j] + 1], 1);
            ++n_live;
        }
    }
    __syncthreads();
    block_inclusive_scan(offp, S + 1, red_i);
    block_inclusive_scan(offc, S + 1, red_i);
    int* curp = reinterpret_cast<int*>(dp);   // dp/dc double as cursors here
    int* curc = reinterpret_cast<int*>(dc);
    for (int s = tid; s < S; s += nt) { curp[s] = offp[s]; curc[s] = offc[s]; }
    __syncthreads();
    if (tid < 32) warp_stable_fill(prov, live, C, curp, csr_p);
    else if (tid < 64) warp_stable_fill(cons, live, C, curc, csr_c);
    __syncthreads();
    int n_unfrozen = block_sum_int(n_live, red_i);

    // ---- progressive filling rounds --------------------------------------
    for (int it = 0; it < max_iters && n_unfrozen > 0; ++it) {
        // per-spreader headroom: committed rate and unfrozen count, each
        // summed over the segment in ascending flow index
        for (int s = tid; s < S; s += nt) {
            float com = 0.0f, cnt = 0.0f;
            for (int k = offp[s]; k < offp[s + 1]; ++k) {
                int j = csr_p[k];
                com = __fadd_rn(com, r[j]);
                if (unfrozen[j]) cnt = __fadd_rn(cnt, 1.0f);
            }
            dp[s] = cnt > 0.0f
                ? __fdiv_rn(fmaxf(__fsub_rn(perf[s], com), 0.0f), fmaxf(cnt, 1.0f))
                : BIG_F;
            com = 0.0f; cnt = 0.0f;
            for (int k = offc[s]; k < offc[s + 1]; ++k) {
                int j = csr_c[k];
                com = __fadd_rn(com, r[j]);
                if (unfrozen[j]) cnt = __fadd_rn(cnt, 1.0f);
            }
            dc[s] = cnt > 0.0f
                ? __fdiv_rn(fmaxf(__fsub_rn(perf[s], com), 0.0f), fmaxf(cnt, 1.0f))
                : BIG_F;
        }
        __syncthreads();
        // per-flow increment headroom and the global increment delta
        float m = BIG_F;
        for (int j = tid; j < C; j += nt) {
            float d = BIG_F;
            if (unfrozen[j]) {
                d = fminf(dp[prov[j]], dc[cons[j]]);
                d = fminf(d, fmaxf(__fsub_rn(p_l[j], r[j]), 0.0f));
            }
            df[j] = d;
            m = fminf(m, d);
        }
        float delta = block_min(m, red_f);
        if (!(isfinite(delta) && delta < BIG_F)) delta = 0.0f;
        float thr = __fadd_rn(__fmul_rn(delta, thr_scale), 1e-12f);
        // raise the unfrozen flows, freeze those whose constraint bound
        int left = 0;
        for (int j = tid; j < C; j += nt) {
            if (unfrozen[j]) {
                r[j] = __fadd_rn(r[j], delta);
                if (df[j] <= thr) unfrozen[j] = 0;
                else ++left;
            }
        }
        n_unfrozen = block_sum_int(left, red_i);
    }
}

// One round's per-spreader headroom: one thread per spreader scans every
// flow (staged through shared memory a tile at a time) in index order.
#define FILL_THREADS 256
#define FILL_TILE 1024

__global__ void __launch_bounds__(FILL_THREADS)
fill_stats_kernel(const int* __restrict__ prov, const int* __restrict__ cons,
                  const float* __restrict__ r, const uint8_t* __restrict__ live,
                  const uint8_t* __restrict__ unfrozen,
                  const float* __restrict__ perf,
                  float* __restrict__ dp, float* __restrict__ dc, int C, int S) {
    __shared__ int tp[FILL_TILE];
    __shared__ int tc[FILL_TILE];
    __shared__ float tr[FILL_TILE];
    __shared__ float tu[FILL_TILE];
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    float com_p = 0.0f, cnt_p = 0.0f, com_c = 0.0f, cnt_c = 0.0f;
    for (int base = 0; base < C; base += FILL_TILE) {
        int n = min(FILL_TILE, C - base);
        for (int k = threadIdx.x; k < n; k += blockDim.x) {
            int j = base + k;
            tp[k] = prov[j];
            tc[k] = cons[j];
            tr[k] = live[j] ? r[j] : 0.0f;
            tu[k] = unfrozen[j] ? 1.0f : 0.0f;
        }
        __syncthreads();
        if (s < S) {
            for (int k = 0; k < n; ++k) {
                if (tp[k] == s) { com_p = __fadd_rn(com_p, tr[k]); cnt_p = __fadd_rn(cnt_p, tu[k]); }
                if (tc[k] == s) { com_c = __fadd_rn(com_c, tr[k]); cnt_c = __fadd_rn(cnt_c, tu[k]); }
            }
        }
        __syncthreads();
    }
    if (s < S) {
        float pf = perf[s];
        dp[s] = cnt_p > 0.0f
            ? __fdiv_rn(fmaxf(__fsub_rn(pf, com_p), 0.0f), fmaxf(cnt_p, 1.0f)) : BIG_F;
        dc[s] = cnt_c > 0.0f
            ? __fdiv_rn(fmaxf(__fsub_rn(pf, com_c), 0.0f), fmaxf(cnt_c, 1.0f)) : BIG_F;
    }
}

extern "C" int maxmin_solve_launch(const int* prov, const int* cons,
                                   const float* p_l, const uint8_t* live,
                                   const float* perf, float* r, float* df,
                                   uint8_t* unfrozen, int* csr_p, int* csr_c,
                                   int C, int S, int max_iters,
                                   float thr_scale, void* stream) {
    size_t smem = maxmin_solve_smem_bytes(S);
    cudaError_t err = cudaFuncSetAttribute(
        maxmin_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    maxmin_solve_kernel<<<1, SOLVE_THREADS, smem, (cudaStream_t)stream>>>(
        prov, cons, p_l, live, perf, r, df, unfrozen, csr_p, csr_c, C, S,
        max_iters, thr_scale);
    return (int)cudaGetLastError();
}

extern "C" int fill_stats_launch(const int* prov, const int* cons,
                                 const float* r, const uint8_t* live,
                                 const uint8_t* unfrozen, const float* perf,
                                 float* dp, float* dc, int C, int S,
                                 void* stream) {
    int blocks = (S + FILL_THREADS - 1) / FILL_THREADS;
    fill_stats_kernel<<<blocks, FILL_THREADS, 0, (cudaStream_t)stream>>>(
        prov, cons, r, live, unfrozen, perf, dp, dc, C, S);
    return (int)cudaGetLastError();
}
