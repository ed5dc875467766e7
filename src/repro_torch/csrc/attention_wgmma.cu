// bf16 flash attention redesigned for Hopper (sm_90a): TMA loads into a
// shared-memory ring guarded by mbarriers, warpgroup wgmma products, and a
// producer warp beside two consumer warpgroups that take turns on the tensor
// cores.  Head dims 64 and 128; kernels.attention.variant routes bf16 inputs
// with those D here, every other bf16 D to flash_mma_kernel in attention.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py flash_attention
// and computes what the oracle repro/kernels/ref.py attention_ref computes:
// f32 online softmax, GQA, causal / sliding-window / bidirectional-prefix
// masks, tanh soft-capping, a query offset and a scale.
//
// What bounds it on an H100: operations.  Causal T = 4096, 32 heads, D = 128
// is ~137 GFLOP against ~84 MB, 0.139 ms at 989 TFLOP/s of bf16; P's two
// bf16 parts (below) make the tensor cores' work 1.5 times that.  Beside the
// products every score costs softmax work on the CUDA cores and one ex2 on
// the special-function unit (three with a softcap), which at D = 128 is of
// the order of the tensor cores' work per score.  The design:
//
// * a block owns one (batch*head, 128-row q tile): 3 warpgroups of 128
//   threads.  Warpgroup 0 is the producer: after setmaxnreg.dec one thread
//   of it issues every TMA load (Q once; K and V tiles of 128 keys into a
//   ring of up to 4 stages, full/empty mbarriers a stage, K and V apart so
//   that S can start before V lands).  Boxes are 64 columns (128 bytes)
//   wide with the 128-byte swizzle, so a D = 128 tile is two column blocks.
//   Rows beyond Tq / Tk come in as TMA zero-fill; the 4-D maps ([B, T, H,
//   D]) keep a box inside its batch and head;
// * warpgroups 1 and 2 (setmaxnreg.inc) each own 64 q rows.  S = Q K^T is
//   wgmma m64n128k16 with both operands in shared memory (K-major); P goes
//   from the S accumulator registers straight into the A operand of
//   O += P V (m64nDk16), with V read MN-major (transposed) from shared
//   memory; O stays in f32 registers.  KV tiles of BK = 128 keys: the ring
//   holds 3 stages at D = 128 and 4 at D = 64;
// * the two consumers take turns on the tensor cores (two named barriers):
//   a turn issues P_{j-1} V_{j-1} and S_j = Q K_j^T and hands over, then
//   runs the softmax of S_j while the other warpgroup's products run.  P V
//   completes before S is issued, so that P's registers are free for S: a
//   thread has 168 (ptxas allocates the launch's count whatever setmaxnreg
//   says), and S, P's parts and O together take 160 at D = 64 and 192 at
//   D = 128;
// * P goes to P V in two bf16 parts, hi = bf16(p) and lo = bf16(p - hi),
//   one product each, as in flash_mma_kernel: P in one bf16 broke
//   chip_smoke's FLASH_TOL at the full-width rows;
// * the softmax has one instantiation each for softcap or not and edge tile
//   or not (Softmax::tile), so that no test runs in the loop over the
//   scores; it runs in base 2 (one ex2 a score), the scale applied to the
//   f32 scores as the oracle does (off the edges folded into the
//   exponent's FFMA);
// * the softcap's tanh is 1 - 2 / (1 + 2^(2y log2 e)): one ex2.approx and
//   one rcp.approx (each ~2^-22 relative) instead of the multi-instruction
//   tanhf; tests/test_torch_flash_wgmma.py bounds its error in f32;
// * the q tiles run heaviest first (q tile n_qt - 1 - blockIdx.y, B*Hq on
//   blockIdx.x), so a causal grid ends on short blocks, and the q heads of
//   one KV group run side by side: each block loads its KV head's tiles
//   itself and the group's other heads find them in L2 (no block shares a
//   K/V load between q heads).
//
// ptxas serialises the wgmma pipeline (info C7515 / C7518 in the build log)
// when plain instructions touch an accumulator between a wgmma and its wait:
// pin() keeps the compiler's arithmetic on O, P and S on its side of the
// fences and waits, and P V is issued from one place only (the loop runs a
// last turn with P V alone).
//
// Masks follow the oracle, as flash_mma_kernel does: a KV tile is skipped
// only when no key in it is visible to any row of the 128-row q tile
// (kernels.attention.visited_tiles with bq = 128, bk = BK), a tile that
// holds prefix keys is never skipped, and the per-element mask runs only on
// tiles that straddle an edge for the warpgroup's 64 rows.  Masked
// probabilities are exactly 0; the output is acc / max(l, 1e-30) rounded
// once to bf16 and no row beyond Tq is stored.  visited receives one count
// a block.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_F (-1e30f)
#define FULL_MASK 0xffffffffu
#define LOG2E_F 1.4426950408889634f

static constexpr int BQ = 128;      // q rows a block: two warpgroups of 64
static constexpr int BK = 128;      // keys a KV tile
static constexpr int NT = 384;      // producer warpgroup + two consumers
static constexpr int BOX = 64;      // columns a TMA box (128 bytes of bf16)
static constexpr int BAR_TURN = 1;  // named barriers 1, 2: consumer 0's, 1's
                                    // turn on the tensor cores
static constexpr int P_PARTS = 2;   // P's bf16 parts, hi and lo

template <int D> struct WgTile {
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    // as many K/V stages as fit in a block's 227 KB beside Q, the 1 KB
    // alignment and the barriers, at most 4
    static constexpr int FIT = (232448 - 1024 - 256 - Q_BYTES)
                               / (2 * KV_BYTES);
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static constexpr int BARS = 1 + 4 * STAGES;      // full_q, full/empty k, v
    static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES
                                   + 8 * BARS;
};

// the skip rule of kernels.attention.visited_tiles
__device__ __forceinline__ bool tile_needed(int k0, int k_last, int qp0,
                                            int qp1, bool causal, int window,
                                            int prefix) {
    return !causal || (prefix > 0 && k0 < prefix)
           || (k0 <= qp1 && (window <= 0 || k_last > qp0 - window));
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; its bytes count toward the barrier's transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
           "r"(c3) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the stride between 64-column blocks; K-major:
// unused), stride byte offset 1024 (eight 128-byte rows).  Tiles start on
// 1024-byte boundaries, so the base offset is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
           | ((uint64_t)(1024 >> 4) << 32)
           | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed group of this warpgroup has completed
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that a wgmma reads or writes in place with respect to the
// fence and wait around it (the compiler would otherwise be free to move
// plain arithmetic on them across those asm statements, and ptxas then
// serialises the wgmma pipeline)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int A, int B>
__device__ __forceinline__ void pin(uint32_t (&r)[A][B][4]) {
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                asm volatile("" : "+r"(r[a][b][i]) :: "memory");
}

// d (m64n128, f32) = (scale_d ? d : 0) + A (64 x 16, K-major, shared)
// * B (16 x 128, K-major, shared); both by descriptor
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n128, f32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major
// in shared memory, by descriptor)
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64],
                                                 const uint32_t* a,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "n"(1));
}

// d (m64n64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major
// in shared memory, by descriptor)
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                 const uint32_t* a,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "n"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a,
                                             uint64_t db) {
    wgmma_rs_n64_mn(o, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
    wgmma_rs_n128_mn(o, a, db);
}

// (x, y) as bf16 pairs: hi = bf16(x, y), lo = bf16(x - hi, y - hi)
__device__ __forceinline__ void pack_split(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

// S (m64n128) = Q K^T of one warpgroup's 64 rows: q_base and k_base are the
// first column blocks of the Q rows and of the K tile; 16 columns of D a step
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_base,
                                        uint32_t k_base) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;          // 16 columns of 64
        wgmma_ss_n128(s, desc_sw128(q_base + (kk / 4) * BQ * 128 + off, 16),
                      desc_sw128(k_base + (kk / 4) * BK * 128 + off, 16),
                      kk > 0);
    }
    wgmma_commit();
}

// O += P V of one KV tile: P from registers (each part of its bf16 split),
// V MN-major from v_base, 16 keys (2048 bytes) a step, its two column
// blocks BK * 128 bytes apart
template <int D>
__device__ __forceinline__ void issue_pv(
        float (&o)[D / 2], const uint32_t (&p)[P_PARTS][BK / 16][4],
        uint32_t v_base) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_sw128(v_base + kk * 16 * 128, BK * 128);
#pragma unroll
        for (int part = 0; part < P_PARTS; ++part)
            wgmma_pv<D>(o, p[part][kk], dv);
    }
    wgmma_commit();
}

// The mask of one thread's scores on an edge tile: its columns start at
// kp0 (+ 8 j + {0, 1}), its two rows are at positions qp_a and qp_a + 8
struct Mask {
    int kp0, qp_a, Tk;
    bool causal;
    int window, prefix;

    __device__ __forceinline__ bool visible(int qp, int kp) const {
        bool ok = kp < Tk;
        if (causal) {
            bool c = kp <= qp && (window <= 0 || kp > qp - window);
            ok = ok && (c || kp < prefix);
        }
        return ok;
    }
};

// The online softmax of one warpgroup's rows: each thread holds two rows
// (a: g, b: g + 8) of the running max m (in base-2 units) and its share of
// the row sum l.
struct Softmax {
    float m_a, m_b, l_a, l_b;
    float scale2;   // scale * log2(e)
    float cap2;     // softcap * log2(e)
    float c_y;      // 2 * scale / softcap * log2(e)

    // Scores s (the S accumulator) to probabilities in place; returns the
    // factors al_a, al_b by which O's rows are rescaled.  CAP: soft-capped
    // logits cap * tanh(y) * log2(e), y = s * scale / cap, as
    // cap log2(e) - 2 cap log2(e) / (1 + 2^(2 y log2(e))).  EDGE: the
    // per-element mask, masked probabilities exactly 0 (also while a row has
    // seen no visible key, m = -1e30).  Off the edge without a soft cap the
    // scale goes into the exponent's FFMA.
    template <bool CAP, bool EDGE, int N>
    __device__ __forceinline__ void tile(float (&s)[N], const Mask& mk,
                                         float& al_a, float& al_b) {
        float mx_a = NEG_F, mx_b = NEG_F;
#pragma unroll
        for (int j = 0; j < N / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float v = s[4 * j + e];
                if (CAP)
                    v = fmaf(-2.0f * cap2, rcp(1.0f + ex2(v * c_y)), cap2);
                else if (EDGE) v *= scale2;
                if (EDGE && !mk.visible(e < 2 ? mk.qp_a : mk.qp_a + 8,
                                        mk.kp0 + 8 * j + (e & 1)))
                    v = NEG_F;
                s[4 * j + e] = v;
                if (e < 2) mx_a = fmaxf(mx_a, v);
                else mx_b = fmaxf(mx_b, v);
            }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, 2));
        if (!CAP && !EDGE) {
            // the max of raw scores, scaled: scaling by a positive constant
            // and rounding keep the order
            mx_a *= scale2;
            mx_b *= scale2;
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        al_a = ex2(m_a - mn_a);
        al_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
        for (int j = 0; j < N / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float mn = e < 2 ? mn_a : mn_b;
                const float v = s[4 * j + e];
                float pv;
                if (!CAP && !EDGE) pv = ex2(fmaf(v, scale2, -mn));
                else if (EDGE) pv = v != NEG_F ? ex2(v - mn) : 0.0f;
                else pv = ex2(v - mn);
                s[4 * j + e] = pv;
                if (e < 2) sum_a += pv;
                else sum_b += pv;
            }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
    }
};

// ---- the kernel ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int* __restrict__ visited,
                   int Tq, int Tk, int Hq, int Hkv, float scale, float softcap,
                   int causal, int window, int prefix, int q_offset) {
    using Tile = WgTile<D>;
    constexpr int STAGES = Tile::STAGES, NCB = D / BOX;
    constexpr int NS = BK / 8;            // n8 chunks of a score row block
    constexpr int NO = D / 8;             // n8 chunks of an output row block
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sQ = base;                            // [NCB][BQ][64]
    const uint32_t sK = sQ + Tile::Q_BYTES;         // [STAGES][NCB][BK][64]
    const uint32_t sV = sK + STAGES * Tile::KV_BYTES;    // the same
    const uint32_t bars = sV + STAGES * Tile::KV_BYTES;
    const uint32_t full_q = bars;
    auto full_k = [&](int s) { return bars + 8 * (1 + s); };
    auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
    auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
    auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

    const int bh = blockIdx.x;
    const int n_qt = gridDim.y;
    const int qt = n_qt - 1 - blockIdx.y;            // heaviest q tiles first
    const int q0 = qt * BQ;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const bool is_causal = causal != 0;
    const int qp0 = q_offset + q0;
    const int qp1 = q_offset + min(q0 + BQ, Tq) - 1;
    const int n_kt = (Tk + BK - 1) / BK;
    auto needed = [&](int kt) {
        return tile_needed(kt * BK, min(kt * BK + BK, Tk) - 1, qp0, qp1,
                           is_causal, window, prefix);
    };

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k(s), 1);
            mbar_init(full_v(s), 1);
            mbar_init(empty_k(s), 8);     // one arrival a consumer warp
            mbar_init(empty_v(s), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the role split: warp-uniform, one if / else whose branches never meet
    // again, so that setmaxnreg moves registers from the producer to the
    // consumers (40 + 2 x 232 a thread of 128 = the block's 168 x 384)
    const int wg = __shfl_sync(FULL_MASK, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        // ---- producer: one thread issues every load ------------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            mbar_expect_tx(full_q, Tile::Q_BYTES);
            for (int cb = 0; cb < NCB; ++cb)
                tma_load_4d(sQ + cb * BQ * 128, &tm_q, full_q, cb * BOX, h,
                            q0, b);
            int i = 0;
            for (int kt = 0; kt < n_kt; ++kt) {
                if (!needed(kt)) continue;
                const int s = i % STAGES, ph = (i / STAGES) & 1;
                const uint32_t k_dst = sK + s * Tile::KV_BYTES;
                const uint32_t v_dst = sV + s * Tile::KV_BYTES;
                mbar_wait(empty_k(s), ph ^ 1);
                mbar_expect_tx(full_k(s), Tile::KV_BYTES);
                for (int cb = 0; cb < NCB; ++cb)
                    tma_load_4d(k_dst + cb * BK * 128, &tm_k, full_k(s),
                                cb * BOX, hk, kt * BK, b);
                mbar_wait(empty_v(s), ph ^ 1);
                mbar_expect_tx(full_v(s), Tile::KV_BYTES);
                for (int cb = 0; cb < NCB; ++cb)
                    tma_load_4d(v_dst + cb * BK * 128, &tm_v, full_v(s),
                                cb * BOX, hk, kt * BK, b);
                ++i;
            }
        }
    } else {
        // ---- consumers: warpgroup c owns q rows [64c, 64c + 64) of the tile
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int c = wg - 1;
        const int tid = threadIdx.x - 128 * wg;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, tq = lane & 3;
        const int wr0 = q0 + 64 * c;            // the warpgroup's first row
        const int wqp0 = q_offset + wr0;
        const int wqp1 = q_offset + max(min(wr0 + 64, Tq), wr0 + 1) - 1;
        const int qp_a = wqp0 + 16 * warp + g;  // this thread's first row
        // the softmax runs in base 2: scores times log2(e), exponentials by
        // ex2
        const float scale2 = scale * LOG2E_F;
        // softcap: cap * tanh(y) * log2(e), y = s * scale / cap, as
        // cap log2(e) - 2 cap log2(e) / (1 + 2^(2 y log2(e)))
        const float cap2 = softcap * LOG2E_F;
        const float c_y =
            softcap > 0.0f ? 2.0f * scale / softcap * LOG2E_F : 0.0f;

        float o[NO * 4];
        #pragma unroll
        for (int i = 0; i < NO * 4; ++i) o[i] = 0.0f;
        float s[NS * 4];
        uint32_t p[P_PARTS][BK / 16][4];
        Softmax sm{NEG_F, NEG_F, 0.0f, 0.0f, scale2, cap2, c_y};

        mbar_wait(full_q, 0);
        if (c == 1) named_arrive(BAR_TURN);     // consumer 0 goes first
        named_sync(BAR_TURN + c);
        const uint32_t q_base = sQ + (64 * c) * 128;
        // one turn a visited tile, and a last turn that only adds P V: the
        // loop is the one place that issues P V, so O keeps one register
        // assignment (a second P V site after the loop made ptxas move O
        // inside the wgmma pipeline and serialise it)
        auto next_tile = [&](int kt) {
            for (++kt; kt < n_kt && !needed(kt); ++kt) {}
            return kt;
        };
        int i = 0, prev = 0;
        for (int kt = next_tile(-1);; kt = next_tile(kt)) {
            const bool more = kt < n_kt;
            const int st = i % STAGES, ph = (i / STAGES) & 1;
            if (more) mbar_wait(full_k(st), ph);
            // ---- this turn: O += P_{i-1} V_{i-1}, which completes and
            // frees P's registers, then S_i = Q K_i^T; the other
            // warpgroup's softmax runs under both (S issued first, with a
            // wait for S alone, serialised the pipeline in every form that
            // was tried)
            pin(o); pin(p); pin(s);
            wgmma_fence();
            if (i > 0) {
                issue_pv<D>(o, p, sV + prev * Tile::KV_BYTES);
                wgmma_wait_all();
                pin(o);
                if (lane == 0) mbar_arrive(empty_v(prev));
            }
            if (!more) break;
            issue_s<D>(s, q_base, sK + st * Tile::KV_BYTES);
            named_arrive(BAR_TURN + (1 - c));         // the other's turn
            wgmma_wait_all();
            pin(s);
            if (lane == 0) mbar_arrive(empty_k(st));

            // ---- scale, soft cap, edge mask, online softmax ---------------
            // (one instantiation each for softcap or not and edge tile or not,
            // so that no test runs inside the loop over the scores)
            const int k0 = kt * BK, k_last = min(k0 + BK, Tk) - 1;
            const bool edge = !(k0 + BK <= Tk
                && (!is_causal || k_last < prefix
                    || (k_last <= wqp0
                        && (window <= 0 || k0 > wqp1 - window))));
            const Mask mask{k0 + 2 * tq, qp_a, Tk, is_causal, window, prefix};
            float al_a, al_b;
            if (softcap > 0.0f) {
                if (edge) sm.tile<true, true>(s, mask, al_a, al_b);
                else sm.tile<true, false>(s, mask, al_a, al_b);
            } else {
                if (edge) sm.tile<false, true>(s, mask, al_a, al_b);
                else sm.tile<false, false>(s, mask, al_a, al_b);
            }
            #pragma unroll
            for (int j = 0; j < NO; ++j) {
                o[4 * j] *= al_a; o[4 * j + 1] *= al_a;
                o[4 * j + 2] *= al_b; o[4 * j + 3] *= al_b;
            }
            // P as the A operand of the next turn's P V: the accumulator
            // layout of two n8 chunks is the register layout of one k16
            // slice of A
            #pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const float* x = s + 8 * kk;
                pack_split(x[0], x[1], p[0][kk][0], p[1][kk][0]);
                pack_split(x[2], x[3], p[0][kk][1], p[1][kk][1]);
                pack_split(x[4], x[5], p[0][kk][2], p[1][kk][2]);
                pack_split(x[6], x[7], p[0][kk][3], p[1][kk][3]);
            }
            mbar_wait(full_v(st), ph);
            named_sync(BAR_TURN + c);                      // my next turn
            prev = st;
            ++i;
        }
        // consumer 1 takes no turn after this one: only consumer 0 hands over
        if (c == 0) named_arrive(BAR_TURN + 1);

        // ---- epilogue: reduce the row sums over the quad, write bf16 ---
        float l_a = sm.l_a, l_b = sm.l_b;
        l_a += __shfl_xor_sync(FULL_MASK, l_a, 1);
        l_a += __shfl_xor_sync(FULL_MASK, l_a, 2);
        l_b += __shfl_xor_sync(FULL_MASK, l_b, 1);
        l_b += __shfl_xor_sync(FULL_MASK, l_b, 2);
        const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
        const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
        const int64_t q_row = (int64_t)Hq * D;
        const int ta = wr0 + 16 * warp + g, tb = ta + 8;
        __nv_bfloat16* oa =
            out + ((int64_t)b * Tq + ta) * q_row + (int64_t)h * D;
        __nv_bfloat16* ob = oa + 8 * q_row;
        #pragma unroll
        for (int j = 0; j < NO; ++j) {
            const int d = 8 * j + 2 * tq;
            if (ta < Tq)
                *reinterpret_cast<__nv_bfloat162*>(oa + d) =
                    __floats2bfloat162_rn(o[4 * j] * inv_a,
                                          o[4 * j + 1] * inv_a);
            if (tb < Tq)
                *reinterpret_cast<__nv_bfloat162*>(ob + d) =
                    __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                          o[4 * j + 3] * inv_b);
        }
        if (visited && c == 0 && tid == 0)
            visited[(int64_t)bh * n_qt + qt] = i;
    }
}

// ---- host side: tensor maps and the launch ---------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
static EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// [B, T, H, D] bf16 as a 4-D map (D innermost), boxes of 64 columns x
// `rows` rows of one (batch, head), 128-byte swizzle, zero fill outside
static CUresult make_map(CUtensorMap* map, EncodeTiled enc, const void* ptr,
                         int B, int T, int H, int D, int rows) {
    cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                          (cuuint64_t)B};
    cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                             (cuuint64_t)T * H * D * 2};
    cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(ptr), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
           int* visited, int B, int Tq, int Tk, int Hq, int Hkv, float scale,
           float softcap, int causal, int window, int prefix, int q_offset,
           cudaStream_t stream) {
    static bool attr_set = false;
    auto kern = flash_wgmma_kernel<D>;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)WgTile<D>::SMEM);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    EncodeTiled enc = encode_tiled();
    if (!enc) return (int)cudaErrorSymbolNotFound;
    CUtensorMap mq, mk, mv;
    CUresult r = make_map(&mq, enc, q, B, Tq, Hq, D, BQ);
    if (r == CUDA_SUCCESS) r = make_map(&mk, enc, k, B, Tk, Hkv, D, BK);
    if (r == CUDA_SUCCESS) r = make_map(&mv, enc, v, B, Tk, Hkv, D, BK);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
    dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
    kern<<<grid, NT, WgTile<D>::SMEM, stream>>>(
        mq, mk, mv, (__nv_bfloat16*)out, visited, Tq, Tk, Hq, Hkv, scale,
        softcap, causal, window, prefix, q_offset);
    return (int)cudaGetLastError();
}

// bf16 q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D], out like q, all contiguous
// with 16-byte aligned bases; D = 64 or 128.  visited may be NULL; otherwise
// it receives, per block, the number of KV tiles visited (index q tile +
// ceil(Tq / 128) * (b*Hq + h)).  Returns a CUDA error code, or 100000 + the
// driver's code when a tensor map cannot be made.
extern "C" int flash_attention_wgmma_launch(
        const void* q, const void* k, const void* v, void* out, int* visited,
        int B, int Tq, int Tk, int Hq, int Hkv, int D, float scale,
        float softcap, int causal, int window, int prefix, int q_offset,
        void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (D == 64)
        return launch<64>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, scale,
                          softcap, causal, window, prefix, q_offset, s);
    if (D == 128)
        return launch<128>(q, k, v, out, visited, B, Tq, Tk, Hq, Hkv, scale,
                           softcap, causal, window, prefix, q_offset, s);
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at head dim D (bytes), 0 for another D
extern "C" int flash_attention_wgmma_smem_bytes(int D) {
    return D == 64 ? (int)WgTile<64>::SMEM
                   : D == 128 ? (int)WgTile<128>::SMEM : 0;
}
