// Event-horizon reduction for Hopper (sm_90a): scalar min(cand[mask]), or
// 3e38 when no lane is masked in.
//
// Replaces the Pallas TPU kernel repro/kernels/horizon.py masked_min
// (_kernel and _kernel_small).  The TPU kernel streams (8, 128) blocks
// through VMEM with a carried running-min scratch; here one block of 1024
// threads strides over the vector, each thread keeps a running min in a
// register, and a warp-shuffle tree plus one shared-memory pass combine
// them.  The result stays on the device (the caller never reads it back).
//
// What bounds it on an H100: the engine's horizon vector is ~10k lanes
// (f32 candidates + bool mask, ~50 KB), which 3.35 TB/s moves in a few
// hundredths of a microsecond; the launch (several microseconds) bounds it.
// A NaN lane that is masked in propagates, as jnp.min / torch.min do.

#include <cuda_runtime.h>
#include <stdint.h>

#define BIG_F 3.0e38f
#define FULL_MASK 0xffffffffu
#define MIN_THREADS 1024

__device__ __forceinline__ float nan_min(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fminf(a, b);
}

__global__ void __launch_bounds__(MIN_THREADS)
masked_min_kernel(const float* __restrict__ cand,
                  const uint8_t* __restrict__ mask, float* __restrict__ out,
                  int n) {
    __shared__ float red[32];
    float m = BIG_F;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        if (mask[i]) m = nan_min(m, cand[i]);
    for (int o = 16; o > 0; o >>= 1)
        m = nan_min(m, __shfl_xor_sync(FULL_MASK, m, o));
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (warp == 0) {
        int nw = (blockDim.x + 31) >> 5;
        m = (lane < nw) ? red[lane] : BIG_F;
        for (int o = 16; o > 0; o >>= 1)
            m = nan_min(m, __shfl_xor_sync(FULL_MASK, m, o));
        if (lane == 0) out[0] = m;
    }
}

extern "C" int masked_min_launch(const float* cand, const uint8_t* mask,
                                 float* out, int n, void* stream) {
    masked_min_kernel<<<1, MIN_THREADS, 0, (cudaStream_t)stream>>>(
        cand, mask, out, n);
    return (int)cudaGetLastError();
}
