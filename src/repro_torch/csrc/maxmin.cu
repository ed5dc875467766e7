// Max-min fair-share kernels for Hopper (sm_90a): the whole progressive
// filling in one thread block (maxmin_solve), and, above its size gate, the
// round-wise path: a plan of the flows built once per solve (fill_plan) and
// one round's per-spreader headroom walked over it (fill_round).
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
// Both paths group the flows by segment the same way (block_inclusive_scan
// over the counts, then warp_stable_fill): a stable CSR per side, provider
// and consumer, each segment listing its flows in ascending index.
//
// The plan keeps only the flows that can contribute, live | unfrozen when
// it is built, and that drop is exact: a sum starts from +0.0, and from
// that start an accumulator is never -0.0; a flow that is neither live nor
// unfrozen adds +0.0 to the committed sum and 0 to the count; and adding
// +-0.0 to a value that is not -0.0 leaves it unchanged.  Within one solve
// provider, consumer and live do not change and unfrozen stays a subset of
// live, so one plan from live serves every round.
//
// What bounds them on an H100: at the engine's sizes (C ~ 5-10k flows,
// S ~ 6-14k spreaders) the work is a few hundred kilobytes per call, so one
// launch (a few microseconds) and the dependent rounds inside the single
// block bound maxmin_solve.  fill_round is bound by its launch and by the
// serial walk of the longest segment (its gathers are issued ahead of the
// adds, so only the f32 adds are serial); fill_plan by its one block's
// count, scan and the warps' stable fill.  None touches the tensor cores.
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

// Stable grouping by segment id of flows base .. base + n - 1, done by one
// warp: seg_at(i) is flow base + i's segment, or -1 to leave it out.  Flows
// are taken 32 at a time in index order, lanes that share a segment are
// ranked by lane, so every segment lists its flows in ascending index.  The
// next 32 flows' ids are read while this batch is placed, so only the
// cursor updates are serial.
template <class SegAt>
__device__ void warp_stable_fill(SegAt seg_at, int n, int base, int* cursor,
                                 int* csr) {
    int lane = threadIdx.x & 31;
    unsigned lt = (1u << lane) - 1u;
    int seg = lane < n ? seg_at(lane) : -1;
    for (int i0 = 0; i0 < n; i0 += 32) {
        int in = i0 + 32 + lane;
        int seg_next = in < n ? seg_at(in) : -1;
        bool valid = seg >= 0;
        unsigned group = __match_any_sync(FULL_MASK, seg);
        int leader = __ffs(group) - 1;
        int start = 0;
        if (valid && lane == leader) {
            start = cursor[seg];
            cursor[seg] = start + __popc(group);
        }
        start = __shfl_sync(FULL_MASK, start, leader);
        if (valid) csr[start + __popc(group & lt)] = base + i0 + lane;
        __syncwarp();
        seg = seg_next;
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
    if (tid < 32)
        warp_stable_fill([=](int j) { return live[j] ? prov[j] : -1; }, C, 0,
                         curp, csr_p);
    else if (tid < 64)
        warp_stable_fill([=](int j) { return live[j] ? cons[j] : -1; }, C, 0,
                         curc, csr_c);
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

// ---- the round-wise path --------------------------------------------------

#define PLAN_THREADS 1024
#define PLAN_CHUNK 4096     // flows staged in shared memory per fill step
#define ROUND_THREADS 256

// Dynamic shared memory of one plan: the flows' staged segment ids, two
// [PLAN_CHUNK] vectors, and, unless they live in global scratch, the two
// count / offset / cursor vectors [S+1].
static size_t fill_plan_smem_bytes(int S, int cnt_in_smem) {
    return (size_t)2 * PLAN_CHUNK * sizeof(int)
           + (cnt_in_smem ? (size_t)2 * (S + 1) * sizeof(int) : 0);
}

// The plan: a stable CSR of the flows with live | unfrozen (unfrozen may be
// NULL), by provider (offp [S+1], csrp) and by consumer (offc, csrc).  One
// block: integer counts by atomics, a block scan into offsets, then one warp
// per side fills its CSR from segment ids that the whole block stages in
// shared memory, PLAN_CHUNK flows at a time (the warps' reads then wait on
// no global load).  The counts are 2 (S+1) ints of shared memory when they
// fit, else global scratch.
__global__ void __launch_bounds__(PLAN_THREADS)
fill_plan_kernel(const int* __restrict__ prov, const int* __restrict__ cons,
                 const uint8_t* __restrict__ live,
                 const uint8_t* __restrict__ unfrozen,
                 int* __restrict__ offp, int* __restrict__ csrp,
                 int* __restrict__ offc, int* __restrict__ csrc,
                 int* scratch, int C, int S) {
    extern __shared__ int plan_smem[];
    __shared__ int red_i[32];
    int* stage_p = plan_smem;                  // [PLAN_CHUNK]
    int* stage_c = stage_p + PLAN_CHUNK;       // [PLAN_CHUNK]
    int* cntp = scratch ? scratch : stage_c + PLAN_CHUNK;
    int* cntc = cntp + S + 1;
    const int tid = threadIdx.x, nt = blockDim.x;
    auto keep = [live, unfrozen](int j) {
        return live[j] != 0 || (unfrozen && unfrozen[j] != 0);
    };
    for (int s = tid; s <= S; s += nt) { cntp[s] = 0; cntc[s] = 0; }
    __syncthreads();
    for (int j = tid; j < C; j += nt)
        if (keep(j)) {
            atomicAdd(&cntp[prov[j] + 1], 1);   // integer counts only
            atomicAdd(&cntc[cons[j] + 1], 1);
        }
    __syncthreads();
    block_inclusive_scan(cntp, S + 1, red_i);
    block_inclusive_scan(cntc, S + 1, red_i);
    for (int s = tid; s <= S; s += nt) { offp[s] = cntp[s]; offc[s] = cntc[s]; }
    __syncthreads();
    // cnt[s] is now segment s's start: the fill's cursor
    for (int base = 0; base < C; base += PLAN_CHUNK) {
        const int n = min(PLAN_CHUNK, C - base);
        for (int i = tid; i < n; i += nt) {
            const int j = base + i;
            const bool k = keep(j);
            stage_p[i] = k ? prov[j] : -1;
            stage_c[i] = k ? cons[j] : -1;
        }
        __syncthreads();
        if (tid < 32)
            warp_stable_fill([=](int i) { return stage_p[i]; }, n, base,
                             cntp, csrp);
        else if (tid < 64)
            warp_stable_fill([=](int i) { return stage_c[i]; }, n, base,
                             cntc, csrc);
        __syncthreads();
    }
}

// Committed rate and unfrozen count of one segment, added in plan order
// (ascending flow index) from +0.0.  Indices, then flags and rates, are
// loaded four ahead of the adds, so only the adds form a chain.
__device__ __forceinline__ float segment_headroom(
        const int* __restrict__ off, const int* __restrict__ csr,
        const float* __restrict__ r, const uint8_t* __restrict__ live,
        const uint8_t* __restrict__ unfrozen, float perf, int s) {
    const int e = off[s + 1];
    int k = off[s];
    float com = 0.0f;
    int cnt = 0;
    for (; k + 4 <= e; k += 4) {
        int j[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) j[u] = csr[k + u];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            float rv = r[j[u]];
            v[u] = live[j[u]] ? rv : 0.0f;
            cnt += unfrozen[j[u]];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) com = __fadd_rn(com, v[u]);
    }
    for (; k < e; ++k) {
        int j = csr[k];
        float rv = r[j];
        com = __fadd_rn(com, live[j] ? rv : 0.0f);
        cnt += unfrozen[j];
    }
    // the count is an integer below 2**24: its f32 sum is exact
    const float c = (float)cnt;
    return cnt > 0 ? __fdiv_rn(fmaxf(__fsub_rn(perf, com), 0.0f), fmaxf(c, 1.0f))
                   : BIG_F;
}

// One round's per-spreader headroom over a plan: one thread per spreader
// walks its provider and its consumer segment.
__global__ void __launch_bounds__(ROUND_THREADS)
fill_round_kernel(const int* __restrict__ offp, const int* __restrict__ csrp,
                  const int* __restrict__ offc, const int* __restrict__ csrc,
                  const float* __restrict__ r,
                  const uint8_t* __restrict__ live,
                  const uint8_t* __restrict__ unfrozen,
                  const float* __restrict__ perf,
                  float* __restrict__ dp, float* __restrict__ dc, int S) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const float pf = perf[s];
    dp[s] = segment_headroom(offp, csrp, r, live, unfrozen, pf, s);
    dc[s] = segment_headroom(offc, csrc, r, live, unfrozen, pf, s);
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

extern "C" int fill_plan_launch(const int* prov, const int* cons,
                                const uint8_t* live, const uint8_t* unfrozen,
                                int* offp, int* csrp, int* offc, int* csrc,
                                int* scratch, int C, int S, void* stream) {
    size_t smem = fill_plan_smem_bytes(S, scratch == nullptr);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            fill_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    fill_plan_kernel<<<1, PLAN_THREADS, smem, (cudaStream_t)stream>>>(
        prov, cons, live, unfrozen, offp, csrp, offc, csrc, scratch, C, S);
    return (int)cudaGetLastError();
}

extern "C" int fill_round_launch(const int* offp, const int* csrp,
                                 const int* offc, const int* csrc,
                                 const float* r, const uint8_t* live,
                                 const uint8_t* unfrozen, const float* perf,
                                 float* dp, float* dc, int S, void* stream) {
    int blocks = (S + ROUND_THREADS - 1) / ROUND_THREADS;
    fill_round_kernel<<<blocks, ROUND_THREADS, 0, (cudaStream_t)stream>>>(
        offp, csrp, offc, csrc, r, live, unfrozen, perf, dp, dc, S);
    return (int)cudaGetLastError();
}
