// Event-horizon reduction for Hopper (sm_90a): min(cand[mask]), or 3e38
// when no lane is masked in, of one vector or of each of B rows of one
// length (one engine lane a row) in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/horizon.py masked_min
// (_kernel and _kernel_small).  The TPU kernel streams (8, 128) blocks
// through VMEM with a carried running-min scratch.  Here the vector is
// read four lanes at a time, as one 16-byte load of cand and one 4-byte
// load of the mask, with neighbouring threads on neighbouring words (each
// warp load is one contiguous 512- or 128-byte span).  A thread issues the
// loads of its U = 4 words before its first min and keeps one running
// minimum per word; a warp redux (an order-preserving int key) and one
// shared-memory pass combine them.  Lanes before the first 16-byte
// boundary of cand and after the last whole word go through a scalar head
// and tail; when the mask is not 4-byte aligned where cand is 16-byte
// aligned (a view may start anywhere), every lane goes the scalar way.  Up
// to SINGLE_BLOCK_LANES lanes take one block; a longer vector takes a grid
// of one loop a thread in the same launch, whose last block to finish (an
// atomic ticket after a __threadfence) reduces the blocks' partial minima.
// The result stays on the device.  Rows are the grid's y extent: row b's
// blocks read cand and mask from b * n on, write out[b], and count on a
// ticket of their own in the workspace; each row computes what the
// one-vector launch computes on it (the alignment checks are the row's
// own), so B = 1 is that launch.
//
// What bounds it on an H100: the engine's horizon vector is ~10k lanes
// (f32 candidates + bool mask, ~50 KB), which 3.35 TB/s moves in a few
// hundredths of a microsecond; the launch and one dependent round trip to
// memory bound it, so the design issues every load at once, coalesced.
// At that size one block beats a grid: the ticket's atomic and the second
// reduction cost more than one SM's extra reads.
// A NaN lane that is masked in propagates, as jnp.min / torch.min do.
//
// The kernel keeps no state between calls.  The grid path's ticket and
// partial minima live in a workspace that the caller allocates for each
// call (MIN_WORKSPACE_BYTES); the launch function zeroes its ticket on the
// call's stream just before the kernel, so calls on concurrent streams, or
// in separate branches of a CUDA graph, each count on a ticket of their own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nan_math.cuh"

#define MIN_THREADS 1024
#define U 4                          // 4-lane words a thread loads at once
#define BLOCK_LANES (MIN_THREADS * U * 4)
#define SINGLE_BLOCK_LANES 65536     // up to here one block (4 loops)
#define MAX_BLOCKS 264

// the grid path's workspace of a row: a ticket, then one partial minimum a
// block
#define MIN_WORKSPACE_BYTES (4 * (1 + MAX_BLOCKS))

// four lanes of cand under four mask bytes (bool: 0 or 1)
__device__ __forceinline__ float min4(float m, float4 c, unsigned k) {
    m = nan_min(m, (k & 0xffu) ? c.x : BIG_F);
    m = nan_min(m, (k & 0xff00u) ? c.y : BIG_F);
    m = nan_min(m, (k & 0xff0000u) ? c.z : BIG_F);
    return nan_min(m, (k & 0xff000000u) ? c.w : BIG_F);
}

__global__ void __launch_bounds__(MIN_THREADS)
masked_min_kernel(const float* __restrict__ cand,
                  const uint8_t* __restrict__ mask, float* __restrict__ out,
                  unsigned* ws, int n) {
    __shared__ float red[32];
    __shared__ bool last;
    const size_t row = blockIdx.y;
    cand += row * n;
    mask += row * n;
    out += row;
    if (ws) ws += row * (MIN_WORKSPACE_BYTES / 4);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int gs = gridDim.x * blockDim.x;

    // the words start at cand's first 16-byte boundary; the mask must sit
    // on a 4-byte one there
    const int head = (int)(((16u - ((uintptr_t)cand & 15u)) & 15u) >> 2);
    const bool vec = head <= n && (((uintptr_t)mask + head) & 3u) == 0;
    const int words = vec ? (n - head) >> 2 : 0;
    const int tail = vec ? head + (words << 2) : 0;   // scalar from here on
    const float4* c4 = reinterpret_cast<const float4*>(cand + head);
    const unsigned* k4 = reinterpret_cast<const unsigned*>(mask + head);

    float m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) m[u] = BIG_F;
    for (int base = g; base < words; base += U * gs) {
        float4 c[U];
        unsigned k[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int f = base + u * gs;
            k[u] = 0u;
            if (f < words) {
                c[u] = c4[f];
                k[u] = k4[f];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (k[u]) m[u] = min4(m[u], c[u], k[u]);
    }
    if (vec)
        for (int i = g; i < head; i += gs)
            if (mask[i]) m[0] = nan_min(m[0], cand[i]);
    for (int i = tail + g; i < n; i += gs)
        if (mask[i]) m[1] = nan_min(m[1], cand[i]);

    float v = nan_min(nan_min(m[0], m[1]), nan_min(m[2], m[3]));
    v = warp_min(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = warp_min(lane < (int)(blockDim.x >> 5) ? red[lane] : BIG_F);
        if (lane == 0) {
            if (gridDim.x == 1) {
                out[0] = v;
            } else {
                reinterpret_cast<float*>(ws + 1)[blockIdx.x] = v;
                __threadfence();
                last = atomicAdd(ws, 1u) == gridDim.x - 1;
            }
        }
    }
    if (gridDim.x == 1) return;
    __syncthreads();
    if (last && warp == 0) {   // every other block's partial is written
        __threadfence();
        float w = BIG_F;
        for (int b = lane; b < (int)gridDim.x; b += 32)
            w = nan_min(w, __ldcg(reinterpret_cast<float*>(ws + 1) + b));
        w = warp_min(w);
        if (lane == 0) out[0] = w;
    }
}

// rows rows of n lanes each; out[rows].  ws: rows * MIN_WORKSPACE_BYTES of
// device memory when n > SINGLE_BLOCK_LANES (the grid path), else unused
// and may be NULL.
extern "C" int masked_min_launch(const float* cand, const uint8_t* mask,
                                 float* out, void* ws, int n, int rows,
                                 void* stream) {
    long long blocks = 1;
    if (n > SINGLE_BLOCK_LANES) {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        blocks = ((long long)n + BLOCK_LANES - 1) / BLOCK_LANES;
        if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
        // every row's ticket to 0 (the partials need no clearing)
        const cudaError_t err = cudaMemsetAsync(
            ws, 0, (size_t)rows * MIN_WORKSPACE_BYTES, (cudaStream_t)stream);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)blocks, (unsigned)rows);
    masked_min_kernel<<<grid, MIN_THREADS, 0, (cudaStream_t)stream>>>(
        cand, mask, out, static_cast<unsigned*>(ws), n);
    return (int)cudaGetLastError();
}

// The launch floor, for measurement: a kernel that does nothing, behind a C
// function of masked_min_launch's signature (the same ctypes marshalling).
__global__ void empty_kernel() {}

extern "C" int empty_launch(const float* cand, const uint8_t* mask,
                            float* out, void* ws, int n, int rows,
                            void* stream) {
    (void)cand; (void)mask; (void)out; (void)ws; (void)n; (void)rows;
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
