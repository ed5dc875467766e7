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
// The solve works on the live flows only.  One block ranks them with one
// scan (each thread a contiguous chunk of flows), copies the L live flows
// in ascending index into shared memory (global scratch when L exceeds
// SOLVE_SMEM_FLOWS, with the arrays read at scattered places kept in shared
// memory up to SOLVE_HOT_FLOWS), and sorts them twice by the key (segment, rank): a
// stable grouping by provider and by consumer that lists only the touched
// spreaders (one warp sorts in registers up to 32 live flows).  Each round
// then runs a thread per touched segment (its sum in ascending flow
// index), a thread per live flow (its headroom), one min (a warp redux)
// and the freeze, on only the warps that 2 L threads fill: up to 16 live
// flows one warp with no barrier, else three named barriers a round over
// those warps.  Nothing is of size S.  Min and the clamp propagate NaN as
// torch.minimum / torch.clamp_min and torch.min do, in the solve and in
// fill_round alike: both take a segment's headroom from one walk
// (segment_walk), so the two routes of the engine's maxmin_rates give the
// same rates for any inputs, NaN included.  The part after the ranking is
// compiled three times, once for each placement of its arrays, so that
// each copy addresses shared arrays as shared (a pointer that may point to
// either space would make every access a generic one).
//
// The plan of the round-wise path keeps only the flows that can
// contribute, live | unfrozen when it is built, and that drop is exact: a
// sum starts from +0.0, and from that start an accumulator is never -0.0;
// a flow that is neither live nor unfrozen adds +0.0 to the committed sum
// and 0 to the count; and adding +-0.0 to a value that is not -0.0 leaves
// it unchanged.  Within one solve provider, consumer and live do not
// change and unfrozen stays a subset of live, so one plan from live serves
// every round.
//
// What bounds them on an H100: at the engine's sizes (C ~ 5-10k flows,
// S ~ 6-14k spreaders, a few dozen live flows) each call moves a few to a
// few hundred kilobytes, which 3.35 TB/s moves in well under a
// microsecond, so latency bounds all three: the launch, the dependent
// global round trips and the block barriers.  The solve makes three
// dependent global round trips before its rounds (live, then the live
// flows' ids and p_l, then their spreaders' perf) and runs its rounds from
// shared memory, each one dependent chain of a few hundred instructions on
// as few warps as the live flows fill.  Above SOLVE_SMEM_FLOWS live flows
// its one SM's load unit bounds it: the walks gather rates and headroom at
// scattered places, which shared memory serves a bank at a time where L1
// would take a sector a lane.  fill_round is bound by its launch
// and the serial walk of its longest segment (gathers issued ahead of the
// adds); fill_plan by its one block's count, scan and the warps' stable
// fill.  None touches the tensor cores.
//
// The lane axis: each launch solves B independent problems of one shape,
// lane b's arrays at b times the row length (b * C flows, b * S
// spreaders, b * (S + 1) offsets).  The solve and the plan run one block a
// lane (blockIdx.x), the round a row of blocks a lane (blockIdx.y), and the
// solve's workspace holds one slice a lane.  A block reads and writes its
// own lane only, and computes exactly what the single problem's launch
// computes on that row: B = 1 is that launch.  A batch of B lanes costs
// one launch where B problems cost B, which is what a host-bound engine
// pass needs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math: the freeze test and the headroom division must round
// as the plain version does).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "nan_math.cuh"

typedef unsigned long long u64;

// Headroom of one segment: its members' committed rates and unfrozen flags
// added in their listed order (ascending flow index) from +0.0, then
// clamp_min(perf - committed, 0) / count, or BIG_F with no unfrozen member.
// at(m) is the m-th member's index into rate and unfrozen; the indices,
// then the rates and flags, are loaded four ahead of the adds, so only the
// adds form a chain.
template <class At, class Rate, class Unfrozen>
__device__ __forceinline__ float segment_walk(int m, int end, float perf,
                                              At at, Rate rate,
                                              Unfrozen unfrozen) {
    float com = 0.0f;
    int cnt = 0;
    for (; m + 4 <= end; m += 4) {
        int j[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) j[u] = at(m + u);
#pragma unroll
        for (int u = 0; u < 4; ++u) { v[u] = rate(j[u]); cnt += unfrozen(j[u]); }
#pragma unroll
        for (int u = 0; u < 4; ++u) com = __fadd_rn(com, v[u]);
    }
    for (; m < end; ++m) {
        const int j = at(m);
        com = __fadd_rn(com, rate(j));
        cnt += unfrozen(j);
    }
    // the count is an integer below 2**24: its f32 value is exact
    return cnt > 0 ? __fdiv_rn(clamp0(__fsub_rn(perf, com)), (float)cnt) : BIG_F;
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

// ---- the fused solve -------------------------------------------------------

#define SOLVE_THREADS 1024
#define SOLVE_SMEM_FLOWS 1024   // live flows held in shared memory
// live flows whose rates, flags and headroom (13 bytes a flow) fit the same
// shared memory while the rest of their arrays sit in the workspace
#define SOLVE_HOT_FLOWS 5120
#define KEY_PAD 0xffffffffffffffffull

__host__ __device__ constexpr long long pow2_at_least(long long n) {
    long long p = 1;
    while (p < n) p <<= 1;
    return p;
}

// The solve's arrays for up to `cap` live flows.  A key is (segment << 32 |
// live rank); a run is the sorted keys of one segment, and its head is its
// first sorted position.
struct SolveArrays {
    u64* key_p;            // [pow2(cap)] provider keys, sorted in place
    u64* key_c;            // [pow2(cap)] consumer keys
    int* idx;              // [cap] flow index of each live flow, ascending
    float* pl;             // [cap] p_l of each live flow
    float* rl;             // [cap] its rate, the carry of the rounds
    float* df;             // [cap] its headroom in this round
    int* slot_p;           // [cap] head of its provider run
    int* slot_c;           // [cap] head of its consumer run
    int* end_p;            // [cap] at a head: one past its run; else 0
    int* end_c;
    float* perf_p;         // [cap] at a head: the spreader's perf
    float* perf_c;
    float* d_p;            // [cap] at a head: this round's headroom
    float* d_c;
    uint8_t* uf;           // [cap] unfrozen
};

__host__ __device__ constexpr size_t solve_arrays_bytes(long long cap) {
    return (size_t)(2 * pow2_at_least(cap) * sizeof(u64) + cap * (12 * 4 + 1));
}
static_assert(13 * SOLVE_HOT_FLOWS <= solve_arrays_bytes(SOLVE_SMEM_FLOWS),
              "the hot arrays must fit the solve's shared memory");

__device__ __forceinline__ SolveArrays carve(char* base, long long cap) {
    SolveArrays a;
    const long long kcap = pow2_at_least(cap);
    a.key_p = reinterpret_cast<u64*>(base);
    a.key_c = a.key_p + kcap;
    int* w = reinterpret_cast<int*>(a.key_c + kcap);
    a.idx = w;                                   w += cap;
    a.pl = reinterpret_cast<float*>(w);          w += cap;
    a.rl = reinterpret_cast<float*>(w);          w += cap;
    a.df = reinterpret_cast<float*>(w);          w += cap;
    a.slot_p = w;                                w += cap;
    a.slot_c = w;                                w += cap;
    a.end_p = w;                                 w += cap;
    a.end_c = w;                                 w += cap;
    a.perf_p = reinterpret_cast<float*>(w);      w += cap;
    a.perf_c = reinterpret_cast<float*>(w);      w += cap;
    a.d_p = reinterpret_cast<float*>(w);         w += cap;
    a.d_c = reinterpret_cast<float*>(w);         w += cap;
    a.uf = reinterpret_cast<uint8_t*>(w);
    return a;
}

// The arrays of a solve of SOLVE_SMEM_FLOWS to SOLVE_HOT_FLOWS live flows:
// those that every round reads at scattered places (the rates and flags,
// gathered by each segment's walk, and the headroom, gathered by each
// flow) in shared memory, the rest, read in order, in the workspace.  One
// block's L1 serves scattered loads a sector at a time, which at a few
// thousand live flows costs more than the rounds' arithmetic.
__device__ __forceinline__ SolveArrays carve_hot(char* global, long long cap,
                                                 char* shared) {
    SolveArrays a = carve(global, cap);
    a.rl = reinterpret_cast<float*>(shared);
    a.d_p = a.rl + SOLVE_HOT_FLOWS;
    a.d_c = a.d_p + SOLVE_HOT_FLOWS;
    a.uf = reinterpret_cast<uint8_t*>(a.d_c + SOLVE_HOT_FLOWS);
    return a;
}

// Exclusive prefix sum of one int per thread across the block, with the
// block's total; one barrier (every warp scans the warp totals itself).
__device__ __forceinline__ int block_exclusive_scan(int v, int* red, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        int u = __shfl_up_sync(FULL_MASK, x, o);
        if (lane >= o) x += u;
    }
    if (lane == 31) red[warp] = x;
    __syncthreads();
    int w = lane < nw ? red[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
        int u = __shfl_up_sync(FULL_MASK, w, o);
        if (lane >= o) w += u;
    }
    *total = __shfl_sync(FULL_MASK, w, 31);
    int before = __shfl_sync(FULL_MASK, w, (warp + 31) & 31);
    return (warp > 0 ? before : 0) + x - v;
}

// Ascending sort of key[0..L), L <= N <= 32, N a power of two, by one warp
// in registers (a bitonic network over N lanes, padded with KEY_PAD): no
// block barrier.
__device__ __forceinline__ void warp_sort(u64* key, int L, int N) {
    const int lane = threadIdx.x & 31;
    u64 v = lane < L ? key[lane] : KEY_PAD;
    for (int size = 2; size <= N; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const u64 o = __shfl_xor_sync(FULL_MASK, v, stride);
            const bool up = (lane & size) == 0;
            const bool lower = (lane & stride) == 0;
            v = (lower == up) ? (v < o ? v : o) : (v < o ? o : v);
        }
    if (lane < L) key[lane] = v;
}

// Ascending bitonic sort of kp[0..N) and kc[0..N) together by the block, N a
// power of two (the keys past the live flows hold KEY_PAD).
__device__ __forceinline__ void block_sort(u64* kp, u64* kc, long long N) {
    const long long half = N >> 1;
    for (long long size = 2; size <= N; size <<= 1)
        for (long long stride = size >> 1; stride > 0; stride >>= 1) {
            for (long long t = threadIdx.x; t < N; t += blockDim.x) {
                const bool c = t >= half;
                const long long p = c ? t - half : t;
                const long long i = 2 * p - (p & (stride - 1));
                u64* key = c ? kc : kp;
                const u64 x = key[i], y = key[i + stride];
                if ((x > y) == ((i & size) == 0)) { key[i] = y; key[i + stride] = x; }
            }
            __syncthreads();
        }
}

// Barrier of the first W warps of the block: a warp barrier for one warp,
// else named barrier 1 over 32 W threads (the other warps have exited).
__device__ __forceinline__ void round_sync(int W) {
    if (W == 1) __syncwarp();
    else asm volatile("bar.sync 1, %0;" :: "r"(W << 5) : "memory");
}

// Everything after the ranking, on arrays `a` (in shared memory, in the
// global scratch, or split between them: the caller calls it once for
// each, so that each copy is compiled for its memory spaces).  Thread `tid` holds the live flows of its
// chunk [lo, hi), the first of rank k.
__device__ __forceinline__ void solve_live(
        const SolveArrays a, int L, int k, int lo, int hi,
        const int* __restrict__ prov, const int* __restrict__ cons,
        const float* __restrict__ p_l, const uint8_t* __restrict__ live,
        const float* __restrict__ perf, float* __restrict__ r,
        int max_iters, float thr_scale, int* red_i, float* red_f) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
    // ---- copy the live flows out in ascending index; r = 0 for the others
    for (int j = lo; j < hi; ++j) {
        if (live[j]) {
            a.idx[k] = j;
            a.pl[k] = p_l[j];
            a.rl[k] = 0.0f;
            a.uf[k] = 1;
            a.key_p[k] = ((u64)(unsigned)prov[j] << 32) | (unsigned)k;
            a.key_c[k] = ((u64)(unsigned)cons[j] << 32) | (unsigned)k;
            ++k;
        } else {
            r[j] = 0.0f;
        }
    }
    // ---- group by provider and by consumer: sort by (segment, rank) ------
    const long long N = pow2_at_least(L);
    if (N > 32)
        for (long long i = L + tid; i < N; i += nt) a.key_p[i] = a.key_c[i] = KEY_PAD;
    __syncthreads();
    if (N <= 32) {
        if (warp == 0) warp_sort(a.key_p, L, (int)N);
        else if (warp == 1) warp_sort(a.key_c, L, (int)N);
    } else {
        block_sort(a.key_p, a.key_c, N);
    }
    __syncthreads();
    // ---- from here on only the warps that the live flows need take part:
    // one warp (no barrier at all) up to 16 live flows ----------------------
    const int W = min(nw, (2 * L + 31) >> 5);
    if (warp >= W) return;
    const int nr = W << 5;
    // ---- runs: each head finds its end, points its flows at itself and
    // gathers its spreader's perf (the only reads of perf) -----------------
    for (int i = tid; i < 2 * L; i += nr) {
        const bool c = i >= L;
        const int s = c ? i - L : i;
        const u64* key = c ? a.key_c : a.key_p;
        const unsigned seg = (unsigned)(key[s] >> 32);
        int end = 0;
        if (s == 0 || (unsigned)(key[s - 1] >> 32) != seg) {
            int* slot = c ? a.slot_c : a.slot_p;
            end = s;
            do {
                slot[(unsigned)key[end]] = s;
                ++end;
            } while (end < L && (unsigned)(key[end] >> 32) == seg);
            (c ? a.perf_c : a.perf_p)[s] = perf[seg];
        }
        (c ? a.end_c : a.end_p)[s] = end;
    }
    round_sync(W);

    // ---- progressive filling rounds ----------------------------------------
    int left = L;
    for (int it = 0; it < max_iters && left > 0; ++it) {
        // per touched spreader: headroom from its run
        for (int i = tid; i < 2 * L; i += nr) {
            const bool c = i >= L;
            const int s = c ? i - L : i;
            const int end = (c ? a.end_c : a.end_p)[s];
            if (end) {
                const u64* key = c ? a.key_c : a.key_p;
                (c ? a.d_c : a.d_p)[s] = segment_walk(
                    s, end, (c ? a.perf_c : a.perf_p)[s],
                    [key](int m) { return (int)(unsigned)key[m]; },
                    [rl = a.rl](int q) { return rl[q]; },
                    [uf = a.uf](int q) { return (int)uf[q]; });
            }
        }
        round_sync(W);
        // per live flow: increment headroom; the min over them is delta
        float m = BIG_F;
        for (int q = tid; q < L; q += nr) {
            const float dp = a.d_p[a.slot_p[q]], dc = a.d_c[a.slot_c[q]];
            const float room = clamp0(__fsub_rn(a.pl[q], a.rl[q]));
            const float d = a.uf[q] ? nan_min(nan_min(dp, dc), room) : BIG_F;
            a.df[q] = d;
            m = nan_min(m, d);
        }
        float delta = warp_min(m);
        if (W > 1) {
            if (lane == 0) red_f[warp] = delta;
            round_sync(W);
            delta = warp_min(lane < W ? red_f[lane] : BIG_F);
        }
        if (!(isfinite(delta) && delta < BIG_F)) delta = 0.0f;
        const float thr = __fadd_rn(__fmul_rn(delta, thr_scale), 1e-12f);
        // raise the unfrozen flows, freeze those whose constraint bound
        int nleft = 0;
        for (int q = tid; q < L; q += nr) {
            if (a.uf[q]) {
                a.rl[q] = __fadd_rn(a.rl[q], delta);
                if (a.df[q] <= thr) a.uf[q] = 0;
                else ++nleft;
            }
        }
        left = __reduce_add_sync(FULL_MASK, nleft);
        if (W > 1) {
            if (lane == 0) red_i[warp] = left;
            round_sync(W);
            left = __reduce_add_sync(FULL_MASK, lane < W ? red_i[lane] : 0);
        } else {
            __syncwarp();
        }
    }
    for (int q = tid; q < L; q += nr) r[a.idx[q]] = a.rl[q];
}

// Bytes of one lane's slice of the solve's workspace: the arrays of all C
// flows, rounded up so that every lane's slice starts 256-byte aligned.
__host__ __device__ constexpr size_t solve_lane_bytes(long long C) {
    return (solve_arrays_bytes(C) + 255) & ~(size_t)255;
}

// One block a lane: said to ptxas, which otherwise caps the registers at
// 32 with the three placements inlined, and spills.
__global__ void __launch_bounds__(SOLVE_THREADS, 1)
maxmin_solve_kernel(const int* __restrict__ prov, const int* __restrict__ cons,
                    const float* __restrict__ p_l,
                    const uint8_t* __restrict__ live,
                    const float* __restrict__ perf,
                    float* __restrict__ r,   // [B, C] out
                    char* scratch,           // the arrays when L > SOLVE_SMEM_FLOWS
                    int C, int S, int max_iters, float thr_scale) {
    extern __shared__ __align__(16) char solve_smem[];
    __shared__ int red_i[32];
    __shared__ float red_f[32];
    const int tid = threadIdx.x, nt = blockDim.x;
    // this block's lane
    const size_t lane = blockIdx.x;
    prov += lane * C;
    cons += lane * C;
    p_l += lane * C;
    live += lane * C;
    perf += lane * S;
    r += lane * C;
    if (scratch) scratch += lane * solve_lane_bytes(C);

    // ---- rank the live flows: a contiguous chunk of flows per thread ------
    const int per = (C + nt - 1) / nt;
    const int lo = min(tid * per, C), hi = min(lo + per, C);
    int n = 0;
    for (int j = lo; j < hi; ++j) n += live[j] != 0;
    int L;
    const int k = block_exclusive_scan(n, red_i, &L);
    if (L == 0) {
        for (int j = lo; j < hi; ++j) r[j] = 0.0f;
    } else if (L <= SOLVE_SMEM_FLOWS) {
        solve_live(carve(solve_smem, SOLVE_SMEM_FLOWS), L, k, lo, hi, prov,
                   cons, p_l, live, perf, r, max_iters, thr_scale, red_i, red_f);
    } else if (L <= SOLVE_HOT_FLOWS) {
        solve_live(carve_hot(scratch, C, solve_smem), L, k, lo, hi, prov,
                   cons, p_l, live, perf, r, max_iters, thr_scale, red_i, red_f);
    } else {
        solve_live(carve(scratch, C), L, k, lo, hi, prov, cons, p_l, live,
                   perf, r, max_iters, thr_scale, red_i, red_f);
    }
}

// ---- the round-wise path --------------------------------------------------
// (lane offsets as in the solve: the plan's block and the round's row of
// blocks each read and write one lane)

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
    const size_t lane = blockIdx.x;
    prov += lane * C;
    cons += lane * C;
    live += lane * C;
    if (unfrozen) unfrozen += lane * C;
    offp += lane * (S + 1);
    offc += lane * (S + 1);
    csrp += lane * C;
    csrc += lane * C;
    if (scratch) scratch += lane * 2 * (S + 1);
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

// Headroom of segment s of a plan: the flows that are not live add +0.0.
__device__ __forceinline__ float segment_headroom(
        const int* __restrict__ off, const int* __restrict__ csr,
        const float* __restrict__ r, const uint8_t* __restrict__ live,
        const uint8_t* __restrict__ unfrozen, float perf, int s) {
    return segment_walk(
        off[s], off[s + 1], perf, [csr](int k) { return csr[k]; },
        [r, live](int j) { return live[j] ? r[j] : 0.0f; },
        [unfrozen](int j) { return (int)unfrozen[j]; });
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
                  float* __restrict__ dp, float* __restrict__ dc, int C,
                  int S) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const size_t lane = blockIdx.y;
    offp += lane * (S + 1);
    offc += lane * (S + 1);
    csrp += lane * C;
    csrc += lane * C;
    r += lane * C;
    live += lane * C;
    unfrozen += lane * C;
    perf += lane * S;
    dp += lane * S;
    dc += lane * S;
    const float pf = perf[s];
    dp[s] = segment_headroom(offp, csrp, r, live, unfrozen, pf, s);
    dc[s] = segment_headroom(offc, csrc, r, live, unfrozen, pf, s);
}

// Bytes of global scratch a lane of a solve of C flows needs: the arrays of
// all C flows when more than SOLVE_SMEM_FLOWS of them could be live, else
// none.  A launch of B lanes takes B times this.
extern "C" size_t maxmin_solve_scratch_bytes(int C) {
    return C > SOLVE_SMEM_FLOWS ? solve_lane_bytes(C) : 0;
}

#define MAX_DEVICES 64

extern "C" int maxmin_solve_launch(const int* prov, const int* cons,
                                   const float* p_l, const uint8_t* live,
                                   const float* perf, float* r, char* scratch,
                                   int C, int S, int B, int max_iters,
                                   float thr_scale, void* stream) {
    // the shared-memory opt-in is a property of the function on a device:
    // set it once per device, not at every launch
    static bool opted_in[MAX_DEVICES] = {};
    const size_t smem = solve_arrays_bytes(SOLVE_SMEM_FLOWS);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
        err = cudaFuncSetAttribute(
            maxmin_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
    maxmin_solve_kernel<<<B, SOLVE_THREADS, smem, (cudaStream_t)stream>>>(
        prov, cons, p_l, live, perf, r, scratch, C, S, max_iters, thr_scale);
    return (int)cudaGetLastError();
}

extern "C" int fill_plan_launch(const int* prov, const int* cons,
                                const uint8_t* live, const uint8_t* unfrozen,
                                int* offp, int* csrp, int* offc, int* csrc,
                                int* scratch, int C, int S, int B,
                                void* stream) {
    size_t smem = fill_plan_smem_bytes(S, scratch == nullptr);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            fill_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    fill_plan_kernel<<<B, PLAN_THREADS, smem, (cudaStream_t)stream>>>(
        prov, cons, live, unfrozen, offp, csrp, offc, csrc, scratch, C, S);
    return (int)cudaGetLastError();
}

extern "C" int fill_round_launch(const int* offp, const int* csrp,
                                 const int* offc, const int* csrc,
                                 const float* r, const uint8_t* live,
                                 const uint8_t* unfrozen, const float* perf,
                                 float* dp, float* dc, int C, int S, int B,
                                 void* stream) {
    dim3 grid((S + ROUND_THREADS - 1) / ROUND_THREADS, B);
    fill_round_kernel<<<grid, ROUND_THREADS, 0, (cudaStream_t)stream>>>(
        offp, csrp, offc, csrc, r, live, unfrozen, perf, dp, dc, C, S);
    return (int)cudaGetLastError();
}
