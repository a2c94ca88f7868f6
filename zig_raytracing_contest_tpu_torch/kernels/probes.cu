// CUDA kernels for Hopper (sm_90a): the JAX package's three trace
// micro-benchmarks, each computing what its Pallas probe computes.
//
// Replaces the Pallas probes:
//   micro_trace_kernel   <- scripts/micro_trace.py:156 run (make_kernel :80,
//                           _tail :62): the nearest front-facing hit over the
//                           flat loop of a small bank, the "vpu" transform,
//                           with or without u/v extraction and a tile cull
//   micro_bf16_kernel    <- scripts/micro_bf16.py:74 build (_sweep_kernel
//                           :31): ``iters`` sweeps of the transform in f32 or
//                           bf16 with an f32 tail and a min fold of t
//   probe_gather_kernel  <- scripts/probe_gather.py:36 run (kernel :24): a
//                           per-lane 2-D gather from an (8, 128) i32 page,
//                           column then row, ``reps`` times
//
// micro_trace_kernel.  What bounds it: instruction issue.  Built with
// --fmad=false (below), every product and sum of the test takes its own
// issue slot, so the card's 67 TFLOP/s (an FMA counted as two operations)
// gives it at most half that rate.  The full test for every pair (R = 2^18
// rays x 1024 triangles) issues ~71 instructions a pair, an IEEE divide
// among them, though three quarters of the pairs fail the det test or t >
// 0; and an early-out on one lane saves nothing, since on these random
// rays a warp's 32 lanes nearly always include one that goes on.  Design:
// a staged test with the divide last.  Stage 1, for every swept pair: dw,
// the det test, ow, the sign test of t = -ow/dw > 0 and, once a lane of
// the warp has a hit, the test against the ray's running best
// (beyond_best), ~26 instructions; each lane keeps its survivors of a
// block of 64 triangles in two mask registers.  Stage 2 (stage2_block):
// dw and ow again, ou, ov, du, dv, the divide, u, v and the rest of the
// test, first in rounds, one survivor a lane on its own ray, while 16 or
// more lanes have survivors left; then the tail, compacted: each lane
// lists up to 8 survivors in the warp's list in shared memory and the list
// runs 32 at a time, an entry a lane, its ray read by __shfl_sync from the
// lane that holds it.  Rounds alone run as many as the busiest lane needs,
// 1.85x the mean on these rays, since whether a ray faces the bank is
// shared by its pairs; the tail cuts that to ~1.1x.  Every quantity is
// computed op for op as the full test computes it, and stage 1 drops only
// a pair the full test rejects or one whose t exceeds the best, so the
// bits are the full test's.  A hit is folded into shared memory by a
// 64-bit atomicMin of (t bits << 32 | idx): the least (t, idx), which is
// the flat loop's winner (ascending index, replace on a strictly smaller
// t) in any order of the fold; u and v of the winner are recomputed at the
// end.  Compacting every survivor into full warps through a per-warp queue
// (ballot, prefix count, 16-byte entries, stage 2 on 32 entries) kept the
// bits but cost ~20 instructions a triangle to push and ~80 a batch, and
// took 1.09-1.15x the time of the full test for every pair (PERF.md).  The tile cull is a
// template switch.  none: a warp sweeps its own 32 rays over every tile.
// warp: a warp sweeps its rays over a tile when __any_sync finds one of
// them passing the tile's slab test against its best (the Hopper
// counterpart of the TPU's block-wide ``@pl.when(jnp.any(hit))``,
// unmasked): every ray of the warp takes the tile.  lane: the block lists
// the rays whose own slab test passes and its warps take them 32 at a time
// (a tile's triangles cut into slices when there are fewer chunks than
// warps), so the work follows passing rays and not passing warps.  The
// block stages each tile of the field-major (16, Tp) bank in shared memory
// as one 80-byte row per triangle, stage 1's five fields in the first 16
// bytes and the last float, a thread's 13 loads in flight together.  The
// MXU transforms of the script (``mxu``, ``mxu2``) have no counterpart.
//
// micro_bf16_kernel.  What bounds it: instruction issue, as micro_trace's
// (65,536 triangle tests a sweep of 128 triangles x 512 lanes).  512 lanes,
// one thread each, would occupy 4 of the 132 SMs, and the price per sweep
// would then be the latency of one thread's loop.  The fold is a min over
// positive t, which is exact and does not depend on its order, so the
// iterations are cut into BF16_SPLITS chunks run by separate blocks (grid.y:
// 4 x 1024 blocks of 128 lanes, ~31 a SM; 256 chunks left a SM 31 warps
// and took 1.12x the time), each block a chunk for 128 lanes, and each
// thread folds its chunk's minimum into the output with one atomicMin on
// the f32 bits (non-negative floats and +inf order as their bit patterns
// do).  atomicMin and not a second pass: one launch, no (chunks, lanes)
// scratch, and the same result in any order.  The wrapper fills the
// output with +inf first.  Each sweep is the staged test without the test
// against the best (every sweep costs the same, so the slope between two
// iteration counts prices one), a hit folding min t into a shared word per
// ray with atomicMin.  f32: micro_trace's stage 1 and stage2_block.  bf16:
// stage 1 in the working type, each lane its ray against every pair of
// the tile (one bf16x2 instruction transforms both triangles), and
// __ballot_sync gives each triangle the mask of rays that survive it;
// stage 2 turns the warp around: lane l holds pair l of a group of 32 in
// registers and takes one surviving ray of each of its two triangles a
// round, read by __shfl_sync and packed into the two halves of one bf16x2
// operand, so one instruction transforms both survivors and stage 2 reads
// no shared memory.  The sweep's tile is staged in shared memory: f32 as
// micro_trace's rows; bf16 as one 80-byte row per pair of triangles (rows
// 0-11 as __nv_bfloat162 pairs, stage 1's four first, row 12 as two
// floats).  The bf16 products and sums round once each (mul.rn.bf16x2 /
// add.rn.bf16x2: the .rn forbids contraction into an FMA), as PyTorch's
// bf16 ops round them.  The tensor cores are not used: they add exact
// products in f32, where the function rounds each bf16 product and sum.
//
// probe_gather_kernel.  What bounds it on this card: nothing of the card's
// rates.  The function moves 16 KB and does two int32 additions per
// element and rep (an 8x128 page, 2^20 additions at reps 512: 0.03 us at
// 33.5 TOP/s), far less than one launch costs (~1.8 us queued), so the
// time is the launches and the latency of the reps loop.  The TPU probe
// gathers one (8, 128) tile on one core; the first port did the same on
// one SM (smem: one block) or on one warp scheduler (shfl: one warp), the
// reps one after another, 223 and 1510 SM cycles a rep, the other SMs
// idle.  But the output is a sum of independent reps, and int32 addition
// wraps mod 2^32, so any order of the sum gives the same bits.  Design:
// the wrapper cuts [0, reps) into ``chunks`` chunks of ``per`` reps
// (probes/probe_gather.py rep_chunks, a chunk a slot of the card: an SM
// for smem, a warp scheduler for shfl), chunk c the reps [c·per, min(reps,
// (c+1)·per)).  "smem": a block of 1024 threads a chunk, thread (s, l) one
// element; per rep each thread writes its element of page + r to shared
// memory, reads the element its column index names (row s), writes it,
// and reads the element its row index names (column l): two indexed
// shared-memory loads per rep that nothing can hoist, since the arrays are
// rewritten every rep.  "shfl": a warp a chunk, GATHER_WARPS warps a
// block; a warp holds the page in registers, thread t the columns t, t+32,
// t+64, t+96 of all 8 rows; the column gather is __shfl_sync of page + r
// from lane c mod 32 of each of the four column registers, selected by c
// / 32, and the row gather stays in the thread (an 8-way select over its
// own registers).  The chunks' sums are folded into ``out`` by atomic adds
// (red.global.add), which the launcher zeroes first on the same stream
// (a memset: a second launch, ~1.8 us of the call); the shfl form adds its
// warps' sums in shared memory first, so each block adds 1024 words, not
// each warp (with the reps taken out, 512 one-warp blocks took 1.8x the
// time of 128 blocks of four warps: PERF.md).
// A single chunk (reps 1) runs the one-block kernel, which stores its sum
// and needs no zeroing.  With ``cycles``, thread 0 of each chunk adds the
// SM clock cycles of its reps loop: the sum over chunks, which grows with
// reps as one block's did.
//
// Parity with the plain PyTorch versions (probes/*.py): built with
// --fmad=false, so every a*b+c rounds twice, as PyTorch's separate
// elementwise ops round it; ties in micro_trace are settled as the flat
// loop settles them (ascending index, replace on a strictly smaller t).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MT_EPSILON 1e-8f
#define MICRO_MAX_TILE 256
#define BF16_TILE 128
#define BF16_SPLITS 1024
#define ZRC_NOTHING_LAUNCHED (-1)
#define FULL_MASK 0xffffffffu
// probe_gather's shfl form: warps (chunks) a block, one per scheduler
#define GATHER_WARPS 4
// micro_trace's margin on the running best, 1 + 2^-20, and the least
// normal float
#define PRUNE_MARGIN 1.00000095367431640625f
#define FLT_NORMAL_MIN 1.17549435082228750797e-38f
// A staged triangle (or bf16 pair) row: ROW words, 80 bytes, so that the
// 16-byte loads of stage 2, each lane its own row, fall in distinct banks
// for any eight consecutive rows (5 chunks of 16 bytes a row, 5 prime to 8).
#define ROW 20
// The slot of tri_data row r in a staged row, nibble r: [0..3] M6 M7 M8
// c11 (the w row, stage 1), [4..7] M0 M1 M2 c9 (u), [8..11] M3 M4 M5 c10
// (v), [12] |n|^2.
#define ROW_SLOT 0xC3B7210A98654ULL
// The word of row r (< 12) in a staged bf16 pair row, nibble r: words 0-3
// rows 6 7 8 11 (stage 1), 4-5 row 12 of both triangles as f32, 8-11 rows
// 0 1 2 9, 12-15 rows 3 4 5 10.
#define PAIR_WORD 0x3FB210EDCA98ULL
// stage2_block: the rounds on each lane's own ray stop when fewer
// than TAIL_LANES lanes have survivors left; a pass of the tail lists up to
// TAIL_TAKE survivors a lane
#define TAIL_LANES 16
#define TAIL_TAKE 8
// (+inf bits << 32 | 0): no hit, t = +inf, idx 0
#define NO_HIT_KEY (0x7f800000ull << 32)

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ------------------------------------------------------ the staged test
// The transform-form test (det = -dw |n|^2 >= 1e-8, t = -ow/dw > 0, u, v >=
// 0, u + v <= 1) in two stages, each quantity computed op for op as the
// full test computes it: ou = M0 o0 + M1 o1 + M2 o2 + c9, du = M0 d0 + M1
// d1 + M2 d2 (v: M3 M4 M5 c10, w: M6 M7 M8 c11), t, u = ou + t du, v = ov +
// t dv.

// Stage 1's verdict on dw and ow: the det test and the sign test of t > 0
// (ow nonzero, ow and dw of opposite signs; a NaN ow passes it and fails
// stage 2).  A pair it rejects fails the full test.
__device__ __forceinline__ bool front_and_ahead(float dw, float ow, float n_sq) {
    return -dw * n_sq >= MT_EPSILON && (__float_as_int(ow) ^ __float_as_int(dw)) < 0 &&
           ow != 0.0f;
}

// dw and ow from the w row (M6 M7 M8 c11).
__device__ __forceinline__ void transform_w(float4 w, const float o[3], const float d[3],
                                            float& dw, float& ow) {
    dw = w.x * d[0] + w.y * d[1] + w.z * d[2];
    ow = w.x * o[0] + w.y * o[1] + w.z * o[2] + w.w;
}

// Stage 1 from the w row and |n|^2.
__device__ __forceinline__ bool stage1(float4 w, float n_sq, const float o[3],
                                       const float d[3], float& dw, float& ow) {
    transform_w(w, o, d, dw, ow);
    return front_and_ahead(dw, ow, n_sq);
}

// The rest of the test from the six transformed values.
__device__ __forceinline__ bool tail_test(float ou, float ov, float du, float dv, float dw,
                                          float ow, float& t, float& u, float& v) {
    t = -ow / dw;
    u = ou + t * du;
    v = ov + t * dv;
    return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// Stage 2 from the u row (M0 M1 M2 c9), the v row and stage 1's dw, ow.
__device__ __forceinline__ bool stage2(float4 a, float4 b, const float o[3], const float d[3],
                                       float dw, float ow, float& t, float& u, float& v) {
    const float ou = a.x * o[0] + a.y * o[1] + a.z * o[2] + a.w;
    const float ov = b.x * o[0] + b.y * o[1] + b.z * o[2] + b.w;
    const float du = a.x * d[0] + a.y * d[1] + a.z * d[2];
    const float dv = b.x * d[0] + b.y * d[1] + b.z * d[2];
    return tail_test(ou, ov, du, dv, dw, ow, t, u, v);
}

// micro_trace's test against the running best bt.  Stage 1 also drops a
// pair when |ow| >= p = rn(bq |dw|) with bq = rn(bt (1 + 2^-20)), while p
// is a normal float (or +inf): then |ow| / |dw| >= bt (1 + 2^-20)(1 -
// 2^-24)^2 > bt (1 + 2^-22), more than an ulp above bt, so t = rn(-ow/dw)
// > bt and the pair cannot win, whatever the order of the fold.  A
// subnormal bt loses the margin in its rounding: bq is +inf there, as for
// bt = +inf, and only an infinite |ow|, which the full test never accepts,
// is dropped.
__device__ __forceinline__ float prune_bound(float bt) {
    return bt >= FLT_NORMAL_MIN ? bt * PRUNE_MARGIN : INFINITY;
}

__device__ __forceinline__ bool beyond_best(float dw, float ow, float bq) {
    const float p = bq * fabsf(dw);
    return fabsf(ow) >= p && p >= FLT_NORMAL_MIN;
}

// Stage rows 0-12 of triangles s0 .. s0 + n - 1 of the field-major (16,
// tp) bank into ``dst`` as one ROW-float row per triangle (ROW_SLOT): a
// thread stages a triangle at a time, its 13 loads in flight together.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int tp, int s0, int n) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float x[13];
#pragma unroll
        for (int r = 0; r < 13; ++r) x[r] = __ldg(src + (size_t)r * tp + s0 + c);
#pragma unroll
        for (int r = 0; r < 13; ++r) dst[c * ROW + (int)((ROW_SLOT >> (4 * r)) & 15)] = x[r];
    }
}

// The next set bit of a ray mask, taken off it (0 for an empty mask).
__device__ __forceinline__ int take_next(unsigned& m) {
    const int j = m ? __ffs(m) - 1 : 0;
    m &= m - 1;
    return j;
}

// ---------------------------------------------------------- micro_trace

enum { CULL_NONE = 0, CULL_LANE = 1, CULL_WARP = 2 };

// Slab test of tile j's box (_cull_mask): a NaN (0 * inf) never culls.
__device__ __forceinline__ bool box_passes(const float* __restrict__ bb, int nt, int j,
                                           const float o[3], const float inv[3],
                                           float best) {
    float tx1 = (__ldg(bb + 0 * nt + j) - o[0]) * inv[0];
    float tx2 = (__ldg(bb + 3 * nt + j) - o[0]) * inv[0];
    float ty1 = (__ldg(bb + 1 * nt + j) - o[1]) * inv[1];
    float ty2 = (__ldg(bb + 4 * nt + j) - o[1]) * inv[1];
    float tz1 = (__ldg(bb + 2 * nt + j) - o[2]) * inv[2];
    float tz2 = (__ldg(bb + 5 * nt + j) - o[2]) * inv[2];
    float tmin = nan_max(nan_max(nan_min(tx1, tx2), nan_min(ty1, ty2)),
                         nan_min(tz1, tz2));
    float tmax = nan_min(nan_min(nan_max(tx1, tx2), nan_max(ty1, ty2)),
                         nan_max(tz1, tz2));
    return !((tmin > tmax) || (tmax <= 0.0f) || (tmin >= best));
}

// Byte offsets of micro_trace_kernel's dynamic shared memory: the staged
// tile (ROW floats a triangle), the warps' tail lists, the rays' best keys
// and, for the lane cull, the rays (8 floats a slot: o, d), the list of
// passing rays and its two counts.
struct MtSmem {
    int tail, best, ray, list, count, bytes;
};

__host__ __device__ inline MtSmem mt_smem(int threads, int tile, bool lane_cull) {
    MtSmem s;
    s.tail = tile * ROW * 4;
    s.best = s.tail + threads * TAIL_TAKE * 4;
    s.ray = s.best + threads * 8;
    s.list = s.ray + (lane_cull ? threads * 32 : 0);
    s.count = s.list + (lane_cull ? threads * 4 : 0);
    s.bytes = s.count + 8;
    return s;
}

__device__ __forceinline__ float best_t(const unsigned long long* s_best, int slot) {
    // the high word of the key, read afresh (other warps fold into it)
    return __int_as_float(reinterpret_cast<const volatile int*>(s_best + slot)[1]);
}

// The key a hit is folded with: (t bits, idx) in lexicographic order.
__device__ __forceinline__ unsigned long long hit_key(float t, int idx) {
    return (unsigned long long)__float_as_uint(t) << 32 | (unsigned)idx;
}

// The next survivor of a lane's two masks (bits 0-31 and 32-63 of a
// block), taken off them: its place in the block (31 when both are empty).
__device__ __forceinline__ int take_next2(unsigned& m0, unsigned& m1) {
    const bool lo = m0 != 0u;
    const unsigned m = lo ? m0 : m1;
    const unsigned rest = m & (m - 1u);
    m0 = lo ? rest : m0;
    m1 = lo ? m1 : rest;
    return (lo ? -1 : 31) + __ffs(m);
}

// Stage 1 of triangles ks .. ks + n - 1 (n <= 32) of the staged tile
// against this lane's ray (with the test against the best bq when
// kPrune): the mask of its survivors.
template <bool kPrune>
__device__ __forceinline__ unsigned stage1_mask(const float* s_tri, int ks, int n,
                                                const float o[3], const float d[3], float bq) {
    unsigned m = 0u, bit = 1u;
#pragma unroll 4
    for (int kk = 0; kk < n; ++kk) {
        const float* row = s_tri + ROW * (ks + kk);
        float dw, ow;
        if (stage1(*reinterpret_cast<const float4*>(row), row[12], o, d, dw, ow) &&
            !(kPrune && beyond_best(dw, ow, bq)))
            m |= bit;
        bit <<= 1;
    }
    return m;
}

// Stage 2 of the survivors (masks m0, m1) of a block of kn <= 64 triangles
// from kb: in rounds, one a lane on its own ray (o, d, ray slot), while
// TAIL_LANES or more lanes have survivors left; then the tail: each lane
// lists up to TAIL_TAKE of its survivors in the warp's ``tail`` list
// (shared memory) and the list runs 32 at a time, an entry a lane, its ray
// read by __shfl_sync from the lane that holds it.  ``fold(k, o, d, slot,
// valid)`` runs stage 2 of triangle k for that ray and folds a hit,
// returning whether it hit; called by every lane, ``valid`` on the lanes
// that hold a survivor.  True when a lane of the warp hit.
template <class Fold>
__device__ __forceinline__ bool stage2_block(unsigned m0, unsigned m1, int kb, int kn,
                                             const float o[3], const float d[3], int slot,
                                             int* tail, Fold fold) {
    const int lane = threadIdx.x & 31;
    bool hit = false;
    while (__popc(__ballot_sync(FULL_MASK, (m0 | m1) != 0u)) >= TAIL_LANES) {
        const bool valid = (m0 | m1) != 0u;
        hit |= fold(kb + min(take_next2(m0, m1), kn - 1), o, d, slot, valid);
    }
    while (__any_sync(FULL_MASK, (m0 | m1) != 0u)) {
        // list up to TAIL_TAKE survivors a lane (lane | triangle << 5)
        const int cnt = min(__popc(m0) + __popc(m1), TAIL_TAKE);
        int at = cnt;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, at, s);
            if (lane >= s) at += y;
        }
        const int total = __shfl_sync(FULL_MASK, at, 31);
        at -= cnt;
        for (int c = 0; c < cnt; ++c) tail[at + c] = lane | (kb + take_next2(m0, m1)) << 5;
        __syncwarp();
        for (int e0 = 0; e0 < total; e0 += 32) {
            const int e = tail[min(e0 + lane, total - 1)];
            const int el = e & 31;
            const float eo[3] = {__shfl_sync(FULL_MASK, o[0], el),
                                 __shfl_sync(FULL_MASK, o[1], el),
                                 __shfl_sync(FULL_MASK, o[2], el)};
            const float ed[3] = {__shfl_sync(FULL_MASK, d[0], el),
                                 __shfl_sync(FULL_MASK, d[1], el),
                                 __shfl_sync(FULL_MASK, d[2], el)};
            hit |= fold(e >> 5, eo, ed, __shfl_sync(FULL_MASK, slot, el), e0 + lane < total);
        }
        __syncwarp();  // the list is read before it is written again
    }
    return __any_sync(FULL_MASK, hit);
}

// Triangles k0 .. k1 - 1 of the staged tile (Morton index base + k)
// against this lane's ray (``on``; ray slot, o, d), 64 at a time: stage 1
// of the block into two masks of this lane's survivors (``stage1_mask``),
// then stage 2 of them (``stage2_block``); a hit is folded into
// s_best[slot of the ray].
__device__ __forceinline__ void mt_sweep(bool on, int slot, const float o[3],
                                         const float d[3], int k0, int k1,
                                         const float* s_tri, unsigned long long* s_best,
                                         int base, int* tail) {
    auto fold = [&](int k, const float* eo, const float* ed, int es, bool valid) {
        const float4* row = reinterpret_cast<const float4*>(s_tri + ROW * k);
        float dw, ow, t, u, v;
        transform_w(row[0], eo, ed, dw, ow);
        if (!stage2(row[1], row[2], eo, ed, dw, ow, t, u, v) || !valid) return false;
        atomicMin(s_best + es, hit_key(t, base + k));
        return true;
    };
    float bq = on ? prune_bound(best_t(s_best, slot)) : 0.0f;
    for (int kb = k0; kb < k1; kb += 64) {
        const int kn = min(64, k1 - kb);
        unsigned m0, m1;
        if (__any_sync(FULL_MASK, bq < INFINITY)) {  // a lane of the warp has a best
            m0 = stage1_mask<true>(s_tri, kb, min(32, kn), o, d, bq);
            m1 = kn > 32 ? stage1_mask<true>(s_tri, kb + 32, kn - 32, o, d, bq) : 0u;
        } else {  // bq = +inf: the test against the best drops only |ow| = +inf
            m0 = stage1_mask<false>(s_tri, kb, min(32, kn), o, d, bq);
            m1 = kn > 32 ? stage1_mask<false>(s_tri, kb + 32, kn - 32, o, d, bq) : 0u;
        }
        if (!on) m0 = m1 = 0u;
        if (stage2_block(m0, m1, kb, kn, o, d, slot, tail, fold) && on)
            bq = prune_bound(best_t(s_best, slot));
    }
}

// The chunks of 32 listed rays are shared out to nwarps warps in slices
// of the tile: the count s <= 8 of slices that gives the busiest warp the
// least work, ceil(chunks s / nwarps) / s chunk-tiles (the least such s).
__device__ __forceinline__ int slice_count(int chunks, int nwarps) {
    int best = 1, num = (chunks + nwarps - 1) / nwarps, den = 1;
    for (int s = 2; s <= 8; ++s) {
        const int c = (chunks * s + nwarps - 1) / nwarps;
        if (c * den < num * s) {
            best = s;
            num = c;
            den = s;
        }
    }
    return best;
}

// Nearest hit of every column of a (16, R) state over the nt tiles of
// ``tile`` triangles -> aux (8, R) [u, v, t, streams, alive, 0, 0, 0] (u, v
// stay 0 without kUV) and idx (1, R) Morton index (0 on a miss).  As the
// TPU kernel, the sweep does not look at the alive row: only the cull does.
template <int kCull, bool kUV>
__global__ void __launch_bounds__(512)
    micro_trace_kernel(const float* __restrict__ tri, int tp, const float* __restrict__ bbox,
                       int nt, int tile, const float* __restrict__ state,
                       float* __restrict__ aux, int* __restrict__ idx_out, int R) {
    extern __shared__ __align__(16) unsigned char mt_shared[];
    const MtSmem lay = mt_smem(blockDim.x, tile, kCull == CULL_LANE);
    float* s_tri = reinterpret_cast<float*>(mt_shared);
    unsigned long long* s_best = reinterpret_cast<unsigned long long*>(mt_shared + lay.best);
    float* s_ray = reinterpret_cast<float*>(mt_shared + lay.ray);
    int* s_list = reinterpret_cast<int*>(mt_shared + lay.list);
    int* s_count = reinterpret_cast<int*>(mt_shared + lay.count);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    int* s_tail = reinterpret_cast<int*>(mt_shared + lay.tail) + warp * 32 * TAIL_TAKE;
    const int i = blockIdx.x * blockDim.x + tid;
    const bool in = i < R;
    const size_t n = (size_t)R;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    bool active = false;
    if (in) {
        for (int a = 0; a < 3; ++a) {
            o[a] = state[a * n + i];
            d[a] = state[(3 + a) * n + i];
        }
        active = state[12 * n + i] > 0.0f;
    }
    if (kCull == CULL_LANE) {
        *reinterpret_cast<float4*>(s_ray + 8 * tid) = make_float4(o[0], o[1], o[2], d[0]);
        *reinterpret_cast<float4*>(s_ray + 8 * tid + 4) = make_float4(d[1], d[2], 0.0f, 0.0f);
        if (tid < 2) s_count[tid] = 0;
    }
    s_best[tid] = NO_HIT_KEY;
    const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
    for (int j = 0; j < nt; ++j) {
        __syncthreads();  // the previous tile's sweeps are done
        stage_rows(s_tri, tri, tp, j * tile, tile);
        bool pass = false;
        if (kCull != CULL_NONE) pass = active && box_passes(bbox, nt, j, o, inv, best_t(s_best, tid));
        if (kCull == CULL_LANE) {
            // list the passing rays: count j & 1, the other zeroed for tile j + 1
            const unsigned m = __ballot_sync(FULL_MASK, pass);
            int at = 0;
            if (lane == 0 && m) at = atomicAdd(s_count + (j & 1), __popc(m));
            at = __shfl_sync(FULL_MASK, at, 0);
            if (pass) s_list[at + __popc(m & ((1u << lane) - 1u))] = tid;
            if (tid == 0) s_count[(j + 1) & 1] = 0;
        }
        __syncthreads();  // the tile is staged, the list complete
        if (kCull == CULL_LANE) {
            // 32 listed rays to a warp, in slices of the tile when the
            // chunks are fewer than the warps
            const int listed = s_count[j & 1];
            const int chunks = (listed + 31) >> 5;
            const int slices = slice_count(chunks, nwarps);
            for (int item = warp; item < chunks * slices; item += nwarps) {
                const int c = item / slices, s = item - c * slices;
                const bool on = c * 32 + lane < listed;
                const int slot = on ? s_list[c * 32 + lane] : 0;
                const float4 r0 = *reinterpret_cast<const float4*>(s_ray + 8 * slot);
                const float2 r1 = *reinterpret_cast<const float2*>(s_ray + 8 * slot + 4);
                const float ro[3] = {r0.x, r0.y, r0.z}, rd[3] = {r0.w, r1.x, r1.y};
                mt_sweep(on, slot, ro, rd, s * tile / slices, (s + 1) * tile / slices, s_tri,
                         s_best, j * tile, s_tail);
            }
        } else if (kCull == CULL_NONE || __any_sync(FULL_MASK, pass)) {
            mt_sweep(in, tid, o, d, 0, tile, s_tri, s_best, j * tile, s_tail);
        }
    }
    __syncthreads();  // every fold is done
    if (!in) return;
    const unsigned long long key = s_best[tid];
    const float bt = __int_as_float((int)(key >> 32));
    const int bi = (int)(unsigned)key;
    float bu = 0.0f, bv = 0.0f;
    if (kUV && bt < INFINITY) {
        // the winner's u, v, recomputed from its rows as the sweep computed them
        const float* c = tri + bi;
        const size_t p = (size_t)tp;
        const float4 w = make_float4(__ldg(c + 6 * p), __ldg(c + 7 * p), __ldg(c + 8 * p),
                                     __ldg(c + 11 * p));
        const float4 a = make_float4(__ldg(c), __ldg(c + p), __ldg(c + 2 * p), __ldg(c + 9 * p));
        const float4 b = make_float4(__ldg(c + 3 * p), __ldg(c + 4 * p), __ldg(c + 5 * p),
                                     __ldg(c + 10 * p));
        float dw, ow, t;
        transform_w(w, o, d, dw, ow);
        stage2(a, b, o, d, dw, ow, t, bu, bv);
    }
    aux[0 * n + i] = bu;
    aux[1 * n + i] = bv;
    aux[2 * n + i] = bt;
    aux[3 * n + i] = state[13 * n + i];
    aux[4 * n + i] = state[12 * n + i];
    aux[5 * n + i] = 0.0f;
    aux[6 * n + i] = 0.0f;
    aux[7 * n + i] = 0.0f;
    idx_out[i] = bi;
}

// ----------------------------------------------------------- micro_bf16

__device__ __forceinline__ __nv_bfloat162 bmul2(__nv_bfloat162 a, __nv_bfloat162 b) {
    // __hmul2 rounded once, never contracted with a following add
    uint32_t r;
    asm("mul.rn.bf16x2 %0, %1, %2;"
        : "=r"(r)
        : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
    return *reinterpret_cast<__nv_bfloat162*>(&r);
}

__device__ __forceinline__ __nv_bfloat162 badd2(__nv_bfloat162 a, __nv_bfloat162 b) {
    // __hadd2 rounded once
    uint32_t r;
    asm("add.rn.bf16x2 %0, %1, %2;"
        : "=r"(r)
        : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
    return *reinterpret_cast<__nv_bfloat162*>(&r);
}

__device__ __forceinline__ __nv_bfloat162 as_b2(uint32_t w) {
    return *reinterpret_cast<__nv_bfloat162*>(&w);
}

// m0 x0 + m1 x1 + m2 x2 in bf16x2, each product and sum rounded
__device__ __forceinline__ __nv_bfloat162 bdot3(uint32_t m0, uint32_t m1, uint32_t m2,
                                                const __nv_bfloat162 x[3]) {
    return badd2(badd2(bmul2(as_b2(m0), x[0]), bmul2(as_b2(m1), x[1])), bmul2(as_b2(m2), x[2]));
}

// Sweeps i0 .. i1 - 1 (tile i mod nt) for lane blockIdx.x * 128 +
// threadIdx.x, folded into best[lane] (f32 bits) with atomicMin.
template <bool kBF16>
__global__ void __launch_bounds__(BF16_TILE)
    micro_bf16_kernel(const float* __restrict__ bank, int nt, const void* __restrict__ state_v,
                      int L, int iters, int chunk, int* __restrict__ best_bits) {
    __shared__ __align__(16) float s_tile[BF16_TILE * ROW];
    __shared__ int s_best[BF16_TILE];
    __shared__ int s_tails[BF16_TILE * TAIL_TAKE];  // the warps' tail lists (f32)
    const int tid = threadIdx.x, lane = tid & 31;
    int* s_tail = s_tails + (tid & ~31) * TAIL_TAKE;
    const int ray = blockIdx.x * blockDim.x + tid;
    const bool in = ray < L;
    const int i0 = blockIdx.y * chunk;
    const int i1 = min(iters, i0 + chunk);
    const int cols = nt * BF16_TILE;
    float r32[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    __nv_bfloat162 r16[6];
    for (int a = 0; a < 6; ++a) {
        if (kBF16) {
            const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(state_v);
            __nv_bfloat16 x = in ? st[(size_t)a * L + ray] : __float2bfloat16_rn(0.0f);
            r16[a] = __halves2bfloat162(x, x);
        } else if (in) {
            r32[a] = reinterpret_cast<const float*>(state_v)[(size_t)a * L + ray];
        }
    }
    // the block's best t per ray, folded by stage 2 from any lane of the warp
    s_best[tid] = __float_as_int(INFINITY);
    // f32: stage 2 of triangle k against a ray of the warp, its hit folded
    // into s_best
    auto fold_f32 = [&](int k, const float* eo, const float* ed, int es, bool valid) {
        const float4* row = reinterpret_cast<const float4*>(s_tile + ROW * k);
        float dw, ow, t, u, v;
        transform_w(row[0], eo, ed, dw, ow);
        if (!stage2(row[1], row[2], eo, ed, dw, ow, t, u, v) || !valid) return false;
        atomicMin(s_best + es, __float_as_int(t));
        return true;
    };
    // Stage 2 of a pair (rows w, a, b as bf16 pairs): a ray of each
    // triangle's mask a round, the two packed into the halves of one bf16x2
    // operand (the first triangle's ray low, the second's high).
    auto stage2_bf16 = [&](unsigned rays0, unsigned rays1, uint4 w, uint4 a, uint4 b) {
        while (__any_sync(FULL_MASK, (rays0 | rays1) != 0u)) {
            const bool valid0 = rays0 != 0u, valid1 = rays1 != 0u;
            const int j0 = take_next(rays0), j1 = take_next(rays1);
            __nv_bfloat162 eo[3], ed[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const uint32_t x = *reinterpret_cast<const uint32_t*>(&r16[c]);
                const uint32_t y = *reinterpret_cast<const uint32_t*>(&r16[3 + c]);
                eo[c] = as_b2(__byte_perm(__shfl_sync(FULL_MASK, x, j0),
                                          __shfl_sync(FULL_MASK, x, j1), 0x5410));
                ed[c] = as_b2(__byte_perm(__shfl_sync(FULL_MASK, y, j0),
                                          __shfl_sync(FULL_MASK, y, j1), 0x5410));
            }
            const __nv_bfloat162 dw = bdot3(w.x, w.y, w.z, ed);
            const __nv_bfloat162 ow = badd2(bdot3(w.x, w.y, w.z, eo), as_b2(w.w));
            const __nv_bfloat162 ou = badd2(bdot3(a.x, a.y, a.z, eo), as_b2(a.w));
            const __nv_bfloat162 ov = badd2(bdot3(b.x, b.y, b.z, eo), as_b2(b.w));
            const __nv_bfloat162 du = bdot3(a.x, a.y, a.z, ed);
            const __nv_bfloat162 dv = bdot3(b.x, b.y, b.z, ed);
            float t, u, v;
            if (tail_test(__low2float(ou), __low2float(ov), __low2float(du), __low2float(dv),
                          __low2float(dw), __low2float(ow), t, u, v) &&
                valid0)
                atomicMin(s_best + ((tid & ~31) | j0), __float_as_int(t));
            if (tail_test(__high2float(ou), __high2float(ov), __high2float(du),
                          __high2float(dv), __high2float(dw), __high2float(ow), t, u, v) &&
                valid1)
                atomicMin(s_best + ((tid & ~31) | j1), __float_as_int(t));
        }
    };
    for (int it = i0; it < i1; ++it) {
        const int s0 = (it % nt) * BF16_TILE;
        __syncthreads();  // every warp is done with the previous tile
        if (kBF16) {
            // a thread a triangle c: its rows as the c & 1 half of pair c >> 1
            __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(s_tile);
            const int c = threadIdx.x;
            float x[13];
#pragma unroll
            for (int r = 0; r < 13; ++r) x[r] = __ldg(bank + (size_t)r * cols + s0 + c);
#pragma unroll
            for (int r = 0; r < 12; ++r)
                h[(c >> 1) * 2 * ROW + 2 * (int)((PAIR_WORD >> (4 * r)) & 15) + (c & 1)] =
                    __float2bfloat16_rn(x[r]);
            s_tile[(c >> 1) * ROW + 4 + (c & 1)] = x[12];
        } else {
            stage_rows(s_tile, bank, cols, s0, BF16_TILE);
        }
        __syncthreads();
        if (kBF16) {
            // two groups of 32 pairs, a pair a lane in stage 2
            for (int pb = 0; pb < BF16_TILE / 2; pb += 32) {
                unsigned rays0 = 0, rays1 = 0;
#pragma unroll 4
                for (int q = 0; q < 32; ++q) {
                    const float* prow = s_tile + ROW * (pb + q);
                    const uint4 w = *reinterpret_cast<const uint4*>(prow);
                    const float2 n2 = *reinterpret_cast<const float2*>(prow + 4);
                    const __nv_bfloat162 dw2 = bdot3(w.x, w.y, w.z, r16 + 3);
                    const __nv_bfloat162 ow2 = badd2(bdot3(w.x, w.y, w.z, r16), as_b2(w.w));
                    const unsigned m0 = __ballot_sync(
                        FULL_MASK,
                        in && front_and_ahead(__low2float(dw2), __low2float(ow2), n2.x));
                    const unsigned m1 = __ballot_sync(
                        FULL_MASK,
                        in && front_and_ahead(__high2float(dw2), __high2float(ow2), n2.y));
                    if (lane == q) {
                        rays0 = m0;
                        rays1 = m1;
                    }
                }
                const uint4* prow = reinterpret_cast<const uint4*>(s_tile + ROW * (pb + lane));
                stage2_bf16(rays0, rays1, prow[0], prow[2], prow[3]);
            }
        } else {
            for (int kb = 0; kb < BF16_TILE; kb += 64) {
                const unsigned m0 = stage1_mask<false>(s_tile, kb, 32, r32, r32 + 3, 0.0f);
                const unsigned m1 = stage1_mask<false>(s_tile, kb + 32, 32, r32, r32 + 3, 0.0f);
                stage2_block(in ? m0 : 0u, in ? m1 : 0u, kb, 64, r32, r32 + 3, tid, s_tail,
                             fold_f32);
            }
        }
    }
    __syncthreads();  // every fold is done
    if (in && i1 > i0) atomicMin(best_bits + ray, s_best[tid]);
}

// --------------------------------------------------------- probe_gather

// A chunk's sum into its output word: with kFold an atomic add into the
// zeroed output (no return: red.global.add), else (the grid is one chunk)
// a store.
template <bool kFold>
__device__ __forceinline__ void fold_int(int* dst, int v) {
    if (kFold)
        atomicAdd(dst, v);
    else
        *dst = v;
}

template <bool kFold>
__device__ __forceinline__ void fold_cycles(long long* cycles, long long v) {
    if (kFold)
        atomicAdd(reinterpret_cast<unsigned long long*>(cycles), (unsigned long long)v);
    else
        *cycles = v;
}

// One (8, 128) page; block c adds take(take(page + r, col, axis=1), row,
// axis=0) over its chunk of reps, r in [c·per, min(reps, (c+1)·per)), into
// ``out``.
template <bool kFold>
__global__ void probe_gather_smem_kernel(const int* __restrict__ page,
                                         const int* __restrict__ col,
                                         const int* __restrict__ row, int reps, int per,
                                         int* __restrict__ out,
                                         long long* __restrict__ cycles) {
    __shared__ int s_y[1024];
    __shared__ int s_z[1024];
    const int e = threadIdx.x;  // element (e / 128, e % 128)
    const int s = e >> 7, l = e & 127;
    const int r0 = blockIdx.x * per;
    const int r1 = min(reps, r0 + per);
    const int p = page[e];
    const int src_y = s * 128 + col[e];  // take(., col, axis=1)
    const int src_z = row[e] * 128 + l;  // take(., row, axis=0)
    int acc = 0;
    const long long c0 = clock64();
    for (int r = r0; r < r1; ++r) {
        s_y[e] = p + r;
        __syncthreads();
        s_z[e] = s_y[src_y];
        __syncthreads();
        acc += s_z[src_z];
    }
    const long long c1 = clock64();
    fold_int<kFold>(out + e, acc);
    if (cycles && e == 0) fold_cycles<kFold>(cycles, c1 - c0);
}

// The same, a chunk a warp (chunk blockIdx.x · warps + warp, none past
// ``reps``): thread t holds columns t + 32 q (q < 4) of the 8 rows in
// registers.  With kFold the block's warps add their sums in shared
// memory first, so each block folds 1024 words into ``out``.
template <bool kFold>
__global__ void probe_gather_shfl_kernel(const int* __restrict__ page,
                                         const int* __restrict__ col,
                                         const int* __restrict__ row, int reps, int per,
                                         int* __restrict__ out,
                                         long long* __restrict__ cycles) {
    __shared__ int s_acc[kFold ? 1024 : 1];
    const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = (blockIdx.x * (blockDim.x >> 5) + warp) * per;
    const int r1 = min(reps, r0 + per);
    int p[8][4], c[8][4], rw[8][4], acc[8][4];
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int e = s * 128 + q * 32 + t;
            p[s][q] = page[e];
            c[s][q] = col[e];
            rw[s][q] = row[e];
            acc[s][q] = 0;
        }
    const long long c0 = clock64();
    for (int r = r0; r < r1; ++r) {
        int z[8][4];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            int y[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) y[q] = p[s][q] + r;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                int src = c[s][q];
                int v0 = __shfl_sync(FULL_MASK, y[0], src & 31);
                int v1 = __shfl_sync(FULL_MASK, y[1], src & 31);
                int v2 = __shfl_sync(FULL_MASK, y[2], src & 31);
                int v3 = __shfl_sync(FULL_MASK, y[3], src & 31);
                int hi = src >> 5;
                z[s][q] = hi == 0 ? v0 : hi == 1 ? v1 : hi == 2 ? v2 : v3;
            }
        }
#pragma unroll
        for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                int src = rw[s][q];
                int w = z[0][q];
#pragma unroll
                for (int k = 1; k < 8; ++k) w = src == k ? z[k][q] : w;
                acc[s][q] += w;
            }
    }
    const long long c1 = clock64();
    if (cycles && t == 0) fold_cycles<kFold>(cycles, c1 - c0);
    if (!kFold) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) out[s * 128 + q * 32 + t] = acc[s][q];
        return;
    }
    // warp 0 stores, the others add; then the block's threads fold
    if (warp == 0) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) s_acc[s * 128 + q * 32 + t] = acc[s][q];
    }
    __syncthreads();
    if (warp != 0) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) atomicAdd(s_acc + s * 128 + q * 32 + t, acc[s][q]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 1024; e += blockDim.x) atomicAdd(out + e, s_acc[e]);
}

// ------------------------------------------------------------ launchers
// Plain C entry points for ctypes (kernels/__init__.py).  They launch on
// the caller's stream, allocate nothing, and return cudaGetLastError(), or
// ZRC_NOTHING_LAUNCHED when the work is empty.

template <int kCull, bool kUV>
static cudaError_t launch_micro_trace_variant(int blocks, int threads, cudaStream_t st,
                                              const float* tri, int tp, const float* bbox,
                                              int nt, int tile, const float* state,
                                              float* aux, int* idx, int R) {
    const int smem = mt_smem(threads, tile, kCull == CULL_LANE).bytes;
    cudaError_t err = cudaFuncSetAttribute(micro_trace_kernel<kCull, kUV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    micro_trace_kernel<kCull, kUV><<<blocks, threads, smem, st>>>(tri, tp, bbox, nt, tile,
                                                                  state, aux, idx, R);
    return cudaGetLastError();
}

template <int kCull>
static cudaError_t launch_micro_trace_cull(bool uv, int blocks, int threads, cudaStream_t st,
                                           const float* tri, int tp, const float* bbox, int nt,
                                           int tile, const float* state, float* aux, int* idx,
                                           int R) {
    if (uv)
        return launch_micro_trace_variant<kCull, true>(blocks, threads, st, tri, tp, bbox, nt,
                                                       tile, state, aux, idx, R);
    return launch_micro_trace_variant<kCull, false>(blocks, threads, st, tri, tp, bbox, nt,
                                                    tile, state, aux, idx, R);
}

extern "C" int zrc_micro_trace(const float* tri, int tp, const float* bbox, int nt,
                               int tile, const float* state, int cull, int extract_uv,
                               int threads, float* aux, int* idx, int R, int device,
                               void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    if (tile <= 0 || tile > MICRO_MAX_TILE || threads % 32 || threads < 32 || threads > 512)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    bool uv = extract_uv != 0;
    if (cull == CULL_NONE)
        return (int)launch_micro_trace_cull<CULL_NONE>(uv, blocks, threads, st, tri, tp, bbox,
                                                       nt, tile, state, aux, idx, R);
    if (cull == CULL_LANE)
        return (int)launch_micro_trace_cull<CULL_LANE>(uv, blocks, threads, st, tri, tp, bbox,
                                                       nt, tile, state, aux, idx, R);
    if (cull == CULL_WARP)
        return (int)launch_micro_trace_cull<CULL_WARP>(uv, blocks, threads, st, tri, tp, bbox,
                                                       nt, tile, state, aux, idx, R);
    return (int)cudaErrorInvalidValue;
}

extern "C" int zrc_micro_bf16(const float* bank, int nt, const void* state, int bf16,
                              int lanes, int iters, float* best, int device,
                              void* stream) {
    if (lanes <= 0 || iters <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int chunks = BF16_SPLITS < iters ? BF16_SPLITS : iters;
    int chunk = (iters + chunks - 1) / chunks;
    dim3 grid((lanes + BF16_TILE - 1) / BF16_TILE, (iters + chunk - 1) / chunk);
    cudaStream_t st = (cudaStream_t)stream;
    int* bits = reinterpret_cast<int*>(best);
    if (bf16)
        micro_bf16_kernel<true><<<grid, BF16_TILE, 0, st>>>(bank, nt, state, lanes, iters,
                                                             chunk, bits);
    else
        micro_bf16_kernel<false><<<grid, BF16_TILE, 0, st>>>(bank, nt, state, lanes, iters,
                                                              chunk, bits);
    return (int)cudaGetLastError();
}

// ``chunks`` chunks of ``per`` reps (chunks · per >= reps): smem a block
// each, shfl a warp each in blocks of GATHER_WARPS warps.  One chunk runs
// the one-block kernel, which stores; more are folded by atomic adds into
// ``out`` and ``cycles``, zeroed on the stream first.
extern "C" int zrc_probe_gather_chunks(const int* page, const int* col, const int* row,
                                       int reps, int chunks, int per, int shfl, int* out,
                                       long long* cycles, int device, void* stream) {
    if (reps < 0 || chunks < 1 || per < 0 || (long long)chunks * per < reps)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    if (chunks == 1) {
        if (shfl)
            probe_gather_shfl_kernel<false><<<1, 32, 0, st>>>(page, col, row, reps, per, out,
                                                               cycles);
        else
            probe_gather_smem_kernel<false><<<1, 1024, 0, st>>>(page, col, row, reps, per,
                                                                 out, cycles);
        return (int)cudaGetLastError();
    }
    err = cudaMemsetAsync(out, 0, 1024 * sizeof(int), st);
    if (err == cudaSuccess && cycles) err = cudaMemsetAsync(cycles, 0, sizeof(long long), st);
    if (err != cudaSuccess) return (int)err;
    if (shfl)
        probe_gather_shfl_kernel<true>
            <<<(chunks + GATHER_WARPS - 1) / GATHER_WARPS, 32 * GATHER_WARPS, 0, st>>>(
                page, col, row, reps, per, out, cycles);
    else
        probe_gather_smem_kernel<true><<<chunks, 1024, 0, st>>>(page, col, row, reps, per,
                                                                 out, cycles);
    return (int)cudaGetLastError();
}

extern "C" const char* zrc_probes_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
