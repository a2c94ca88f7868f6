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
// micro_trace_kernel.  What bounds it: operations, ~42 f32 operations per
// ray per triangle of every swept tile against 64 bytes of state in and 36
// out per ray (R = 2^18 rays over 1024 triangles: 0.17 ms of operations
// without a cull, 8 us of bytes).  Design: one thread per ray, its best hit
// in registers; the block stages each tile of the field-major (16, Tp)
// bank in shared memory as one 16-float row per triangle, so a triangle is
// four broadcast 16-byte loads that every thread of the block shares.  The
// TPU kernel sweeps a whole 512/1024-lane block when any lane of it passes
// the tile's slab test (``@pl.when(jnp.any(hit))``, unmasked); here the cull
// is a template switch: none (every tile), lane (each thread's own slab
// test) or warp (a warp sweeps the tile when __any_sync finds a lane of it
// passing, the Hopper counterpart of the TPU's block-wide test, and every
// lane of that warp takes the update, as the TPU's block does).  The MXU
// transforms of the script (``mxu``, ``mxu2``) have no counterpart here.
//
// micro_bf16_kernel.  What bounds it: operations, 65,536 triangle tests of
// ~42 operations per sweep (128 triangles x 512 lanes).  512 lanes, one
// thread each, would occupy 4 of the 132 SMs, and the price per sweep
// would then be the latency of one thread's loop.  The fold is a min over
// positive t, which is exact and does not depend on its order, so the
// iterations are cut into BF16_SPLITS chunks run by separate blocks (grid.y:
// 4 x 256 blocks of 128 lanes fill the 132 SMs several times over), each
// block a chunk for 128 lanes, and each thread folds its chunk's minimum
// into the output with one atomicMin on the f32 bits (non-negative floats
// and +inf order as their bit patterns do).  atomicMin and not a second
// pass: one launch, no (chunks, lanes) scratch, and the same result in any
// order.  The wrapper fills the output with +inf first.  Each sweep's tile
// is staged in shared memory: f32 as one 16-float row per triangle; bf16 as
// one 64-byte row per pair of triangles (rows 0-11 as __nv_bfloat162
// pairs, row 12 as two floats), so one bf16x2 instruction transforms two
// triangles for the thread's ray.  The bf16 products and sums round once
// each (mul.rn.bf16x2 / add.rn.bf16x2: the .rn forbids contraction into an
// FMA), as PyTorch's bf16 ops round them.
//
// probe_gather_kernel.  What bounds it: the latency of one block; the
// function moves 16 KB and does ~2 integer additions per element and rep.
// The TPU probe gathers one (8, 128) tile on one core; so does each form
// here, on one SM.  "smem": a block of 1024 threads, thread (s, l) one
// element; per rep each thread writes its element of page + r to shared
// memory, reads the element its column index names (row s), writes it,
// and reads the element its row index names (column l): two indexed
// shared-memory loads per rep that nothing can hoist, since the arrays are
// rewritten every rep.  "shfl": one warp holds the page in registers,
// thread t the columns t, t+32, t+64, t+96 of all 8 rows; the column
// gather is __shfl_sync from lane c mod 32 of each of the four column
// registers, selected by c / 32, and the row gather stays in the thread (an
// 8-way select over its own registers).
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
#define BF16_SPLITS 256
#define ZRC_NOTHING_LAUNCHED (-1)

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
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

// Stage rows 0-12 of triangles s0 .. s0 + n - 1 of the field-major (16,
// tp) bank into ``dst`` as one 16-float row per triangle.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int tp, int s0, int n) {
    for (int k = threadIdx.x; k < 13 * n; k += blockDim.x) {
        int r = k / n, c = k - r * n;
        dst[c * 16 + r] = __ldg(src + (size_t)r * tp + s0 + c);
    }
}

// The transform-form test of one triangle (rows a, b, c, |n|^2 of a staged
// 16-float row: a = M0 M1 M2 M3, b = M4 M5 M6 M7, c = M8 c9 c10 c11).
struct TriHit {
    float t, u, v;
    bool ok;
};

__device__ __forceinline__ TriHit tri_test(const float* row, const float o[3],
                                           const float d[3]) {
    const float4* m4 = reinterpret_cast<const float4*>(row);
    float4 a = m4[0], b = m4[1], c = m4[2];
    float n_sq = row[12];
    float ou = a.x * o[0] + a.y * o[1] + a.z * o[2] + c.y;
    float ov = a.w * o[0] + b.x * o[1] + b.y * o[2] + c.z;
    float ow = b.z * o[0] + b.w * o[1] + c.x * o[2] + c.w;
    float du = a.x * d[0] + a.y * d[1] + a.z * d[2];
    float dv = a.w * d[0] + b.x * d[1] + b.y * d[2];
    float dw = b.z * d[0] + b.w * d[1] + c.x * d[2];
    TriHit h;
    h.t = -ow / dw;
    h.u = ou + h.t * du;
    h.v = ov + h.t * dv;
    float det = -dw * n_sq;
    h.ok = (det >= MT_EPSILON) && (h.u >= 0.0f) && (h.v >= 0.0f) &&
           (h.u + h.v <= 1.0f) && (h.t > 0.0f);
    return h;
}

// Nearest hit of every column of a (16, R) state over the nt tiles of
// ``tile`` triangles -> aux (8, R) [u, v, t, streams, alive, 0, 0, 0] (u, v
// stay 0 without kUV) and idx (1, R) Morton index (0 on a miss).  As the
// TPU kernel, the sweep does not look at the alive row: only the cull does.
template <int kCull, bool kUV>
__global__ void micro_trace_kernel(const float* __restrict__ tri, int tp,
                                   const float* __restrict__ bbox, int nt, int tile,
                                   const float* __restrict__ state,
                                   float* __restrict__ aux, int* __restrict__ idx_out,
                                   int R) {
    __shared__ __align__(16) float s_tri[MICRO_MAX_TILE * 16];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
    const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
    float bt = INFINITY, bu = 0.0f, bv = 0.0f;
    int bi = 0;
    for (int j = 0; j < nt; ++j) {
        bool sweep = true;
        if (kCull != CULL_NONE) {
            bool pass = active && box_passes(bbox, nt, j, o, inv, bt);
            sweep = kCull == CULL_LANE ? pass : __any_sync(0xffffffffu, pass);
        }
        __syncthreads();  // every thread is done with the previous tile
        stage_rows(s_tri, tri, tp, j * tile, tile);
        __syncthreads();
        if (!sweep) continue;
        for (int k = 0; k < tile; ++k) {
            TriHit h = tri_test(s_tri + 16 * k, o, d);
            if (h.ok && h.t < bt) {
                bt = h.t;
                bu = h.u;
                bv = h.v;
                bi = j * tile + k;
            }
        }
    }
    if (!in) return;
    aux[0 * n + i] = kUV ? bu : 0.0f;
    aux[1 * n + i] = kUV ? bv : 0.0f;
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

// The f32 tail of _sweep_kernel: t, u, v, the det test and the positive
// t, or +inf.
__device__ __forceinline__ float sweep_tail(float ou, float ov, float ow, float du,
                                            float dv, float dw, float n_sq) {
    float t = -ow / dw;
    float u = ou + t * du;
    float v = ov + t * dv;
    float det = -dw * n_sq;
    bool ok = (det >= MT_EPSILON) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
              (t > 0.0f);
    return ok ? t : INFINITY;
}

// Sweeps i0 .. i1 - 1 (tile i mod nt) for lane blockIdx.x * 128 +
// threadIdx.x, folded into best[lane] (f32 bits) with atomicMin.
template <bool kBF16>
__global__ void micro_bf16_kernel(const float* __restrict__ bank, int nt,
                                  const void* __restrict__ state_v, int L, int iters,
                                  int chunk, int* __restrict__ best_bits) {
    __shared__ __align__(16) float s_tile[BF16_TILE * 16];
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = lane < L;
    const int i0 = blockIdx.y * chunk;
    const int i1 = min(iters, i0 + chunk);
    const int cols = nt * BF16_TILE;
    float r32[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    __nv_bfloat162 r16[6];
    for (int a = 0; a < 6; ++a) {
        if (kBF16) {
            const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(state_v);
            __nv_bfloat16 x = in ? st[(size_t)a * L + lane] : __float2bfloat16_rn(0.0f);
            r16[a] = __halves2bfloat162(x, x);
        } else if (in) {
            r32[a] = reinterpret_cast<const float*>(state_v)[(size_t)a * L + lane];
        }
    }
    float best = INFINITY;
    for (int it = i0; it < i1; ++it) {
        const int s0 = (it % nt) * BF16_TILE;
        __syncthreads();  // every thread is done with the previous tile
        if (kBF16) {
            // pair p = triangles (2p, 2p + 1): words 0-11 rows 0-11 as
            // bf16 pairs, words 12-13 row 12 of both as f32
            __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(s_tile);
            for (int k = threadIdx.x; k < 13 * BF16_TILE; k += blockDim.x) {
                int r = k / BF16_TILE, c = k - r * BF16_TILE;
                float x = __ldg(bank + (size_t)r * cols + s0 + c);
                if (r < 12)
                    h[(c >> 1) * 32 + 2 * r + (c & 1)] = __float2bfloat16_rn(x);
                else
                    s_tile[(c >> 1) * 16 + 12 + (c & 1)] = x;
            }
        } else {
            stage_rows(s_tile, bank, cols, s0, BF16_TILE);
        }
        __syncthreads();
        if (!in) continue;
        if (kBF16) {
            for (int p = 0; p < BF16_TILE / 2; ++p) {
                const uint4* w = reinterpret_cast<const uint4*>(s_tile + 16 * p);
                uint4 w0 = w[0], w1 = w[1], w2 = w[2];
                float2 n2 = *reinterpret_cast<const float2*>(s_tile + 16 * p + 12);
                uint32_t words[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y,
                                      w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
                __nv_bfloat162 m[12];
                for (int r = 0; r < 12; ++r)
                    m[r] = *reinterpret_cast<__nv_bfloat162*>(&words[r]);
                __nv_bfloat162 ou = badd2(badd2(badd2(bmul2(m[0], r16[0]), bmul2(m[1], r16[1])),
                                                bmul2(m[2], r16[2])), m[9]);
                __nv_bfloat162 ov = badd2(badd2(badd2(bmul2(m[3], r16[0]), bmul2(m[4], r16[1])),
                                                bmul2(m[5], r16[2])), m[10]);
                __nv_bfloat162 ow = badd2(badd2(badd2(bmul2(m[6], r16[0]), bmul2(m[7], r16[1])),
                                                bmul2(m[8], r16[2])), m[11]);
                __nv_bfloat162 du = badd2(badd2(bmul2(m[0], r16[3]), bmul2(m[1], r16[4])),
                                          bmul2(m[2], r16[5]));
                __nv_bfloat162 dv = badd2(badd2(bmul2(m[3], r16[3]), bmul2(m[4], r16[4])),
                                          bmul2(m[5], r16[5]));
                __nv_bfloat162 dw = badd2(badd2(bmul2(m[6], r16[3]), bmul2(m[7], r16[4])),
                                          bmul2(m[8], r16[5]));
                float t0 = sweep_tail(__low2float(ou), __low2float(ov), __low2float(ow),
                                      __low2float(du), __low2float(dv), __low2float(dw),
                                      n2.x);
                float t1 = sweep_tail(__high2float(ou), __high2float(ov), __high2float(ow),
                                      __high2float(du), __high2float(dv), __high2float(dw),
                                      n2.y);
                best = fminf(best, fminf(t0, t1));
            }
        } else {
            for (int k = 0; k < BF16_TILE; ++k) {
                TriHit h = tri_test(s_tile + 16 * k, r32, r32 + 3);
                best = fminf(best, h.ok ? h.t : INFINITY);
            }
        }
    }
    if (in && i1 > i0) atomicMin(best_bits + lane, __float_as_int(best));
}

// --------------------------------------------------------- probe_gather

// One (8, 128) int32 page; ``out`` = sum over r < reps of
// take(take(page + r, col, axis=1), row, axis=0).  With ``cycles``, thread
// 0 writes the SM clock cycles its reps loop took: a latency-bound block's
// time follows the SM clock, which a lightly loaded card lowers.
__global__ void probe_gather_smem_kernel(const int* __restrict__ page,
                                         const int* __restrict__ col,
                                         const int* __restrict__ row, int reps,
                                         int* __restrict__ out,
                                         long long* __restrict__ cycles) {
    __shared__ int s_y[1024];
    __shared__ int s_z[1024];
    const int e = threadIdx.x;  // element (e / 128, e % 128)
    const int s = e >> 7, l = e & 127;
    const int p = page[e];
    const int src_y = s * 128 + col[e];  // take(., col, axis=1)
    const int src_z = row[e] * 128 + l;  // take(., row, axis=0)
    int acc = 0;
    const long long c0 = clock64();
    for (int r = 0; r < reps; ++r) {
        s_y[e] = p + r;
        __syncthreads();
        s_z[e] = s_y[src_y];
        __syncthreads();
        acc += s_z[src_z];
    }
    out[e] = acc;
    if (cycles && e == 0) *cycles = clock64() - c0;
}

// The same in one warp: thread t holds columns t + 32 q (q < 4) of the 8
// rows in registers.
__global__ void probe_gather_shfl_kernel(const int* __restrict__ page,
                                         const int* __restrict__ col,
                                         const int* __restrict__ row, int reps,
                                         int* __restrict__ out,
                                         long long* __restrict__ cycles) {
    const int t = threadIdx.x;
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
    for (int r = 0; r < reps; ++r) {
        int z[8][4];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            int y[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) y[q] = p[s][q] + r;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                int src = c[s][q];
                int v0 = __shfl_sync(0xffffffffu, y[0], src & 31);
                int v1 = __shfl_sync(0xffffffffu, y[1], src & 31);
                int v2 = __shfl_sync(0xffffffffu, y[2], src & 31);
                int v3 = __shfl_sync(0xffffffffu, y[3], src & 31);
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
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) out[s * 128 + q * 32 + t] = acc[s][q];
    if (cycles && t == 0) *cycles = clock64() - c0;
}

// ------------------------------------------------------------ launchers
// Plain C entry points for ctypes (kernels/__init__.py).  They launch on
// the caller's stream, allocate nothing, and return cudaGetLastError(), or
// ZRC_NOTHING_LAUNCHED when the work is empty.

template <int kCull>
static void launch_micro_trace_cull(bool uv, int blocks, int threads, cudaStream_t st,
                                    const float* tri, int tp, const float* bbox, int nt,
                                    int tile, const float* state, float* aux, int* idx,
                                    int R) {
    if (uv)
        micro_trace_kernel<kCull, true><<<blocks, threads, 0, st>>>(
            tri, tp, bbox, nt, tile, state, aux, idx, R);
    else
        micro_trace_kernel<kCull, false><<<blocks, threads, 0, st>>>(
            tri, tp, bbox, nt, tile, state, aux, idx, R);
}

extern "C" int zrc_micro_trace(const float* tri, int tp, const float* bbox, int nt,
                               int tile, const float* state, int cull, int extract_uv,
                               int threads, float* aux, int* idx, int R, int device,
                               void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    if (tile <= 0 || tile > MICRO_MAX_TILE) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    bool uv = extract_uv != 0;
    if (cull == CULL_NONE)
        launch_micro_trace_cull<CULL_NONE>(uv, blocks, threads, st, tri, tp, bbox, nt,
                                           tile, state, aux, idx, R);
    else if (cull == CULL_LANE)
        launch_micro_trace_cull<CULL_LANE>(uv, blocks, threads, st, tri, tp, bbox, nt,
                                           tile, state, aux, idx, R);
    else if (cull == CULL_WARP)
        launch_micro_trace_cull<CULL_WARP>(uv, blocks, threads, st, tri, tp, bbox, nt,
                                           tile, state, aux, idx, R);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
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

extern "C" int zrc_probe_gather(const int* page, const int* col, const int* row, int reps,
                                int shfl, int* out, long long* cycles, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    if (shfl)
        probe_gather_shfl_kernel<<<1, 32, 0, st>>>(page, col, row, reps, out, cycles);
    else
        probe_gather_smem_kernel<<<1, 1024, 0, st>>>(page, col, row, reps, out, cycles);
    return (int)cudaGetLastError();
}

extern "C" const char* zrc_probes_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
