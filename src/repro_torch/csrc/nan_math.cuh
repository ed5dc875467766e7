// Device helpers shared by maxmin.cu and horizon.cu: the NaN-propagating
// min, clamp and warp min that make a kernel agree with torch.minimum,
// torch.clamp_min and torch.min (a NaN in wins).  kernels/_build.py hashes
// every header here with each source, so an edit rebuilds both libraries.
#pragma once

#include <limits.h>

#define BIG_F 3.0e38f
#define FULL_MASK 0xffffffffu

// min that returns NaN when either input is NaN, in one instruction (PTX
// min.NaN, sm_80 and later); the NaN that comes back is the canonical one
__device__ __forceinline__ float nan_min(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// torch.clamp_min(x, 0.0f): NaN and -0.0 pass through
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// The min of a warp's floats in one redux: each float maps to an int whose
// signed order is the float order, and every NaN to INT_MIN, which wins as
// a NaN wins nan_min (the NaN that comes back is the canonical one).
__device__ __forceinline__ float warp_min(float v) {
    const int i = __float_as_int(v);
    const int key = v != v ? INT_MIN : (i >= 0 ? i : i ^ 0x7fffffff);
    const int m = __reduce_min_sync(FULL_MASK, key);
    return m == INT_MIN ? __int_as_float(0x7fc00000)
                        : __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}
