// CUDA kernels for Hopper (sm_90a): ray generation, nearest hit, shading
// and the beam-sort key, one thread per ray; the traces sweep a tile that
// few lanes of a warp reach with the whole warp.
//
// Replaces the Pallas kernels of the JAX package:
//   path_trace_gen_kernel  <- zig_raytracing_contest_tpu/render/fused.py:1031
//                             path_trace_gen (_make_path_kernel_gen :981)
//   path_trace_kernel      <- zig_raytracing_contest_tpu/render/fused.py:1111
//                             path_trace_fused (_make_path_kernel :727)
//   trace_emit_kernel      <- zig_raytracing_contest_tpu/ops/mxu_intersect.py:1555
//                             trace_emit_aux (_make_trace_kernel_t_rec :1326,
//                             _make_trace_kernel_t :1309)
//   trace_stream_kernel    <- the same call's streaming kernel
//                             (_make_trace_kernel_t_hbm :1344, body :1380);
//                             trace_stream_kernel<kShade> and
//                             trace_emit_kernel<kShade> also the shading
//                             round and the extensions of render_wave's XLA
//                             branch over the bake (XLA fusions and gathers
//                             inside the jitted wave)
//   shade_kernel           <- zig_raytracing_contest_tpu/render/fused.py:1191
//                             shade_fused (_make_shade1_kernel :668)
//   texel_fetch_kernel     <- scripts/check_paged_tpu.py:57 run_fetch (the
//                             paged texel fetch fused._fetch_paged :401 with
//                             the clamp reconciliation _paged_corners :545)
//   sort_key_kernel        <- tests/test_fused.py:988 (the pallas_call
//                             around fused._emit_sort_key :915)
// and, for code the JAX package leaves to XLA,
//   ray_sort_key_kernel    <- zig_raytracing_contest_tpu/render/wavefront.py:125
//                             _ray_sort_key (the host beam-sort key, one
//                             XLA fusion inside the jitted wave)
//   grid_walk_kernel       <- zig_raytracing_contest_tpu/render/wavefront.py:360
//                             trace_wave (the grid's DDA walk, a
//                             jax.lax.while_loop inside the jitted wave);
//                             grid_walk_kernel<true> also the shading round
//                             of render_wave's XLA branch (XLA fusions and
//                             gathers inside the jitted wave)
// with the shared device functions
//   gen_ray        <- fused._gen_rays (:844)
//   trace_nearest_warp <- mxu_intersect._trace_body_resident (:1027), the
//                     flat tile loop with _cull_any (:782) and _tile_update
//                     (:443), for the 32 rays of a warp; the whole-path
//                     kernels, for every scene
//   advance_walk   <- mxu_intersect._tree_traverse (:1191) with
//                     _cull_entry_batch (:786), a per-ray binary walk of
//                     the tile heap (trace_emit) or of the group heap
//                     (trace_stream), whose leaves re-cull their group and
//                     cull its tiles (visit_group / process_group
//                     :1418-1517; it also covers _front_to_back_groups
//                     :869, which visits a block's groups nearest first
//                     below 16 groups)
//   warp_sweep     <- mxu_intersect._intersect_tile (:287) and
//                     _tile_update (:443) for one ray, a warp on one tile
//   shade_surface  <- fused._shade1_body (:595): _prep_math (:110, non-tiled)
//                     and _shade_live (:245)
//   emit_sort_key  <- fused._emit_sort_key (:915)
//
// Which loop each kernel takes: the whole-path kernels take the flat tile
// loop for every scene they serve (at most 2^15 padded triangles, 256
// tiles).  The JAX kernels walk their tile heap from 16 tiles up; on the
// H100 that walk was slower than the flat loop at every tile count of the
// whole path (PERF.md), so it is not carried here.  The per-bounce kernels
// serve scenes past 2^15 padded triangles: trace_emit walks the tile heap,
// trace_stream (past 2^17 padded triangles) the heap of 8-tile groups, and
// the winner record is one direct load per ray after the walk (the JAX
// kernels' deferred _extract_winner_records :590).
// What bounds the two traces on this card: operations, ~42 f32 operations
// per triangle of every swept tile and ~24 per box tested, over a state of
// 64 bytes in and 132 out per ray.  A triangle test issues ~85-95
// instructions (no FMA under --fmad=false, an IEEE divide), so with every
// lane busy the reachable ceiling is ~1/4 of that bound.  Bounce-1 rays are
// incoherent.  With one thread per ray doing everything (the earlier
// design, commit 542c68f) the warp issued the union of its 32 lanes' tile
// sweeps (128-256 serial tests per lane) while the other lanes waited,
// each thread kept a 32-entry stack in local memory, and lanes loaded
// different tiles' 64-byte rows at each float4 load (16 L1 wavefronts a
// load).  A warp that walks one ray at a
// time (the whole warp on each decision) made the walk's control serial:
// 1.9x slower than that on the beam-sorted bounce 0 (PERF.md).  So here
// each lane walks its own ray (advance_walk: its stack in shared memory,
// 24 entries of node and entry t per thread), in rounds: every lane walks
// to the next tile its ray must sweep, then the warp sweeps the asked
// tiles one after the other, each with all 32 lanes (warp_sweep: tile/32
// triangles per lane, read from the field-major rows, so a load is 128
// contiguous bytes), and hands the result to the asking lane.  Control
// runs 32 rays wide, sweeps 32 triangles wide, and no lane sweeps alone.
// The visit order and the arithmetic are the per-ray walk's, so t, u, v,
// idx and the counts are the same bits as before.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md, both designs on the same rays):
// --large bounce 1 6.27 ms (the earlier design: 15.72), 500k bounce 1
// 12.61 ms (57.44), against bounds of 0.73 and 1.44 ms.  The TPU's
// streaming kernel DMAs each surviving group's tiles through a
// double-buffered VMEM scratch because its core cannot read the bank in
// HBM directly; here the warp reads a tile's rows from device memory
// through L1/L2, so the two traces differ only in the heap they walk and
// the leaf they visit.
// shade_kernel is bound by bytes: 256 bytes of state, aux and record per
// ray in and 64 out, coalesced (thread i owns column i), against ~150
// operations per live ray.
//
// The whole-path kernels (path_trace_gen_kernel, path_trace_kernel): what
// bounds them is the trace, ~42 f32 operations per ray per triangle of
// every tile whose box the ray's slab test passes; the state (16 floats in,
// 16 out per ray) is a few bytes per operation.  Triangles, tile boxes and
// the texel bank are read-only and shared by all rays, so they stay in
// L1/L2 (the official scene has 1024 padded triangles of 64 B).  Each
// thread owns one ray, its state in registers, over its bounces; the
// warp's lanes stay to the end (a dead ray or a lane past R traces and
// shades nothing, but joins every ballot), so the 32 rays of a warp run
// the flat tile loop together (trace_nearest_warp).  Per tile each lane
// culls the box against its own best t and the warp ballots the passes.
// The one-thread-per-ray loop (commit 048022c) let every lane that passed
// sweep the tile's 128 triangles while the lanes that culled it waited: on
// the Duck's bounces 1-3 only 74%, 72% and 33% of the lanes of a sweep had
// a ray that passed the tile (walk_check.flat_occupancy).  Here a tile that
// at least LANE_LOOP_MIN lanes pass is still swept that way (its loads are
// broadcasts: the lanes read the same row at once; unrolled by 4); a tile
// fewer lanes pass is swept once per passing lane by the whole warp
// (warp_sweep: tile/32 triangles a lane from the field-major rows, then
// two min reductions), in ascending lane order.  Coherent bounce-0 warps,
// whose lanes pass the same tiles, keep the lane loop.  Both sweeps pass
// over a back-facing triangle before the divide.  At most 64 registers
// (8 blocks an SM), no spills.  The same bits as the one-thread-per-ray
// loop, in less time at every bounce of the official and Duck waves
// (PERF.md).  The TPU kernel's one-hot matmuls become
// direct loads: the winner's 24-float record is read once after the tile
// loop (a miss reads zeros), texels are float4 loads from the row-major
// (P, 4) bank.  No shared-memory staging, wgmma or TMA.
//
// Parity with the PyTorch twins (render/fused.py): every a*b+c is rounded
// twice, as PyTorch's separate elementwise ops round it; the library builds
// this file with --fmad=false for that.  Min/max that the twin takes with
// torch.minimum/maximum propagate NaN here too (nan_min/nan_max).  Ties:
// the triangle loop runs in ascending Morton index and replaces the best hit
// only on a strictly smaller t, which is the lexicographic minimum of
// (t, index) that the JAX kernels compute per tile and across tiles.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

struct ZrcScene {
    const float4* tri;       // (Tp, 16) f32: M (9), c (3), |n|^2, pad
    const float* tile_bbox;  // (6, nt) f32: min xyz, max xyz per real tile
    const float4* rec;       // (Tp, 24) f32 packed shade records
    const float4* bank;      // (P, 4) f32 u16-valued RGBA texels
    int nt;                  // real tiles (the loop bound)
    int tile;                // triangles per tile
    int num_texels;          // P
    int emissive_dummy;      // every emissive texture is 1x1
    const float* tri_rows;   // (16, Tp) f32: the same transforms, field-major
    int tp;                  // Tp
};

struct ZrcGen {
    const float* par;        // (32,) f32: fused.PAR_* rows
    int x_base;
    int y_base;
    int tile_base;
    unsigned int seed;
    int spp;
    int width;
    int img_w;
    int img_h;
    int tiles_x;             // 0 = raster slot order, else 32x32 pixel tiles
};

// State rows (fused.py module docstring).
enum {
    S_OX = 0, S_DX = 3, S_TR = 6, S_RR = 9,
    S_ALIVE = 12, S_STREAMS = 13, S_SEG = 14, S_KEY = 15, S_ROWS = 16
};
// Packed record columns (scene/types.py PCOL_*).
enum { P_NRM = 0, P_UV = 9, P_BASE = 15, P_EMIS = 19, P_COLS = 24 };
// Shade table columns (scene/types.py COL_*): the XLA shading path's rows.
enum { COL_NRM = 0, COL_UV = 9, COL_BASE_DESC = 15, COL_EMIS_DESC = 23, SHADE_COLS = 32 };
// Gen parameter rows (fused.py PAR_*).
enum { PAR_ORIGIN = 0, PAR_LLC = 3, PAR_RIGHT = 6, PAR_UP = 9,
       PAR_BMIN = 12, PAR_SCALE = 15 };

#define FLT_EPS 1.1920928955078125e-07f
#define MT_EPSILON 1e-8f
#define TWO_PI 6.283185307179586f

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// ----------------------------------------------------------------- RNG
// ops/rng.py: lowbias32 finalizer, per-(stream, tag, word) draws.

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x;
}

__device__ __forceinline__ uint32_t draw_bits(uint32_t streams, int tag, int word) {
    uint32_t t = (uint32_t)tag * 2u + 1u;
    uint32_t w = (uint32_t)word * 0x9E3779B9u + 0x6A09E667u;
    return mix32(streams ^ (t * 0xB5297A4Du) ^ w);
}

__device__ __forceinline__ float u01(uint32_t b) {
    return ((float)(int)(b >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// ------------------------------------------------------------ gen_ray
// Wave slot i -> (pixel, sample); integer division equals the JAX kernel's
// exact f32 divmod for every i < 2^23 (pipeline wave sizing).  The RNG
// stream keys on the RASTER global ray id.  Padding pixels are born dead.

__device__ void gen_ray(const ZrcGen& g, int i, float s[S_ROWS]) {
    const float* par = g.par;
    int qi = i / g.spp;
    int smp = i - qi * g.spp;
    int x, y;
    if (g.tiles_x) {
        int tile = g.tile_base + qi / 1024;
        int w_in = qi % 1024;
        x = (tile % g.tiles_x) * 32 + w_in % 32;
        y = (tile / g.tiles_x) * 32 + w_in / 32;
    } else {
        int row_off = g.x_base + qi;
        x = row_off % g.width;
        y = g.y_base + row_off / g.width;
    }
    bool in_range = x < g.img_w && y < g.img_h;
    uint32_t gid = (uint32_t)((y * g.width + x) * g.spp + smp);
    uint32_t streams = mix32(gid ^ (g.seed * 0x9E3779B9u) ^ 0x85EBCA6Bu);
    float sx = (float)x + u01(draw_bits(streams, 0, 0));
    float sy = (float)y + u01(draw_bits(streams, 0, 1));
    float dr[3];
    for (int a = 0; a < 3; ++a)
        dr[a] = par[PAR_LLC + a] + par[PAR_RIGHT + a] * sx + par[PAR_UP + a] * sy;
    float inv_len = 1.0f / sqrtf(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]);
    for (int a = 0; a < 3; ++a) {
        s[S_OX + a] = par[PAR_ORIGIN + a];
        s[S_DX + a] = dr[a] * inv_len;
        s[S_TR + a] = 1.0f;
        s[S_RR + a] = 0.0f;
    }
    s[S_ALIVE] = in_range ? 1.0f : 0.0f;
    s[S_STREAMS] = __uint_as_float(streams);
    s[S_SEG] = 0.0f;
    s[S_KEY] = 0.0f;
}

// ----------------------------------------------------- tile tests

struct Hit {
    float t;  // +inf on a miss
    float u;
    float v;
    int idx;  // Morton index of the winner, 0 on a miss
};

// Slab test of real tile j against the ray and its running best t
// (_cull_mask): a NaN (0 * inf) never culls.
__device__ __forceinline__ bool tile_passes(const float* bb, int nt, int j,
                                            const float o[3], const float inv[3],
                                            float best) {
    float tx1 = (bb[0 * nt + j] - o[0]) * inv[0];
    float tx2 = (bb[3 * nt + j] - o[0]) * inv[0];
    float ty1 = (bb[1 * nt + j] - o[1]) * inv[1];
    float ty2 = (bb[4 * nt + j] - o[1]) * inv[1];
    float tz1 = (bb[2 * nt + j] - o[2]) * inv[2];
    float tz2 = (bb[5 * nt + j] - o[2]) * inv[2];
    float tmin = nan_max(nan_max(nan_min(tx1, tx2), nan_min(ty1, ty2)),
                         nan_min(tz1, tz2));
    float tmax = nan_min(nan_min(nan_max(tx1, tx2), nan_max(ty1, ty2)),
                         nan_max(tz1, tz2));
    bool miss = (tmin > tmax) || (tmax <= 0.0f) || (tmin >= best);
    return !miss;
}

// Sweep the triangles of tile j in ascending Morton index, in the transform
// form (mxu_intersect._intersect_tile), skipping Morton index ``prev`` (-1:
// none); a hit replaces ``h`` only on a strictly smaller t.  A triangle the
// ray sees from behind (det below MT_EPSILON) is passed over before the
// divide: its t, u and v would be discarded.  The lanes of a warp test the
// same triangle at once and mostly see it from the same side, so a warp
// skips the divide and u, v of most back-facing triangles.
__device__ __forceinline__ void sweep_tile(const ZrcScene& sc, int j,
                                           const float o[3], const float d[3],
                                           int prev, Hit& h) {
    int s = j * sc.tile;
#pragma unroll 4
    for (int k = 0; k < sc.tile; ++k) {
        int gi = s + k;
        const float4* m4 = sc.tri + 4 * (size_t)gi;
        float4 a = __ldg(m4), b = __ldg(m4 + 1), c = __ldg(m4 + 2);
        float n_sq = __ldg(m4 + 3).x;
        // rows: a = M00 M01 M02 M10, b = M11 M12 M20 M21,
        //       c = M22 c0 c1 c2
        float ou = a.x * o[0] + a.y * o[1] + a.z * o[2] + c.y;
        float ov = a.w * o[0] + b.x * o[1] + b.y * o[2] + c.z;
        float ow = b.z * o[0] + b.w * o[1] + c.x * o[2] + c.w;
        float du = a.x * d[0] + a.y * d[1] + a.z * d[2];
        float dv = a.w * d[0] + b.x * d[1] + b.y * d[2];
        float dw = b.z * d[0] + b.w * d[1] + c.x * d[2];
        float det = -dw * n_sq;
        if (!(det >= MT_EPSILON)) continue;
        float t = -ow / dw;
        float u = ou + t * du;
        float v = ov + t * dv;
        bool ok = (u >= 0.0f) && (v >= 0.0f) &&
                  (u + v <= 1.0f) && (t > 0.0f) && (gi != prev);
        if (ok && t < h.t) {
            h.t = t;
            h.u = u;
            h.v = v;
            h.idx = gi;
        }
    }
}

// ---------------------------------------------------------- trace walk
// The per-bounce traces walk an implicit heap (mxu_intersect._build_heap:
// node n's children are 2n and 2n+1, leaf p2 + j is tile or group j; empty
// subtrees hold the always-miss box), each lane the walk of its own ray,
// and sweep tiles as a warp: a lane that reaches a tile hands it to the
// warp, whose 32 lanes split the tile's triangles.  The heap depth is
// log2(p2) <= TREE_STACK (the launcher's bound); the walk pushes at most
// one node per level.
#define FULL_MASK 0xffffffffu
#define TRACE_THREADS 128  // threads per block of the two traces
#define TREE_STACK 24

// NaN-propagating min / max in one instruction each (sm_80+).  The walk
// uses them only in comparisons, where they decide as nan_min / nan_max do
// (the two differ at most in the sign of a zero result).
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// One ray: origin, direction, its reciprocal, and the Morton index it may
// not hit (-1: none).
struct TraceRay {
    float o[3];
    float d[3];
    float inv[3];
    int prev;
};

// (tmin, tmax) of the slab test of column n of a (6, stride) box array,
// with the roundings of tile_passes / _cull_mask.
__device__ __forceinline__ void slab(const float* bb, int stride, int n,
                                     const TraceRay& r, float& tmin, float& tmax) {
    float tx1 = (__ldg(bb + 0 * stride + n) - r.o[0]) * r.inv[0];
    float tx2 = (__ldg(bb + 3 * stride + n) - r.o[0]) * r.inv[0];
    float ty1 = (__ldg(bb + 1 * stride + n) - r.o[1]) * r.inv[1];
    float ty2 = (__ldg(bb + 4 * stride + n) - r.o[1]) * r.inv[1];
    float tz1 = (__ldg(bb + 2 * stride + n) - r.o[2]) * r.inv[2];
    float tz2 = (__ldg(bb + 5 * stride + n) - r.o[2]) * r.inv[2];
    tmin = max_nan(max_nan(min_nan(tx1, tx2), min_nan(ty1, ty2)), min_nan(tz1, tz2));
    tmax = min_nan(min_nan(max_nan(tx1, tx2), max_nan(ty1, ty2)), max_nan(tz1, tz2));
}

// The cull of _cull_mask against the running best t (a NaN never culls).
__device__ __forceinline__ bool box_passes(const float* bb, int stride, int n,
                                           const TraceRay& r, float best, float& tmin) {
    float tmax;
    slab(bb, stride, n, r, tmin, tmax);
    return !((tmin > tmax) || (tmax <= 0.0f) || (tmin >= best));
}

// Entry t of heap node n for the ray, or +inf when the box is culled
// against ``best``; a negative or NaN entry (origin inside the box, or on
// a slab plane) reads 0, as in _cull_entry_batch.
__device__ __forceinline__ float node_entry(const float* tree, int stride, int n,
                                            const TraceRay& r, float best) {
    float tmin;
    if (!box_passes(tree, stride, n, r, best, tmin)) return INFINITY;
    return tmin >= 0.0f ? tmin : 0.0f;
}

// Sweep tile j for one ray (``r``, the same on every lane of the warp):
// lane l tests triangles l, l + 32, ... in ascending order with
// sweep_tile's arithmetic and keeps the first at its smallest t; the warp
// then takes the smallest t over its lanes and, at that t, the lowest index
// (two min reductions), which is the winner of the ascending loop, and
// replaces ``h`` only on a strictly smaller t.  Returns whether it did.
// ``kBackFirst`` passes over a back-facing triangle before the divide, as
// sweep_tile does (the whole-path kernels; in the per-bounce traces the
// branch cost 2-5% at bounce 0, PERF.md).
template <bool kBackFirst>
__device__ __forceinline__ bool warp_sweep(const ZrcScene& sc, int j, const TraceRay& r,
                                           int lane, Hit& h) {
    const int s = j * sc.tile;
    float bt = INFINITY, bu = 0.0f, bv = 0.0f;
    int bi = 0;
#pragma unroll 4
    for (int k = lane; k < sc.tile; k += 32) {
        int gi = s + k;
        float m[13];  // rows of tri_rows: neighbouring lanes, neighbouring words
#pragma unroll
        for (int f = 0; f < 13; ++f) m[f] = __ldg(sc.tri_rows + (size_t)f * sc.tp + gi);
        float ou = m[0] * r.o[0] + m[1] * r.o[1] + m[2] * r.o[2] + m[9];
        float ov = m[3] * r.o[0] + m[4] * r.o[1] + m[5] * r.o[2] + m[10];
        float ow = m[6] * r.o[0] + m[7] * r.o[1] + m[8] * r.o[2] + m[11];
        float du = m[0] * r.d[0] + m[1] * r.d[1] + m[2] * r.d[2];
        float dv = m[3] * r.d[0] + m[4] * r.d[1] + m[5] * r.d[2];
        float dw = m[6] * r.d[0] + m[7] * r.d[1] + m[8] * r.d[2];
        float n_sq = m[12];
        float det = -dw * n_sq;
        if (kBackFirst && !(det >= MT_EPSILON)) continue;
        float t = -ow / dw;
        float u = ou + t * du;
        float v = ov + t * dv;
        bool ok = (det >= MT_EPSILON) && (u >= 0.0f) && (v >= 0.0f) &&
                  (u + v <= 1.0f) && (t > 0.0f) && (gi != r.prev);
        if (ok && t < bt) {
            bt = t;
            bu = u;
            bv = v;
            bi = gi;
        }
    }
    if (!__any_sync(FULL_MASK, bt < h.t)) return false;
    // a hit has t > 0, so its bits order as its value; +inf marks none
    unsigned tb = __float_as_uint(bt);
    unsigned t_min = __reduce_min_sync(FULL_MASK, tb);
    int i_min = __reduce_min_sync(FULL_MASK, tb == t_min ? bi : INT_MAX);
    int src = __ffs(__ballot_sync(FULL_MASK, tb == t_min && bi == i_min)) - 1;
    h.t = __uint_as_float(t_min);
    h.idx = i_min;
    h.u = __shfl_sync(FULL_MASK, bu, src);
    h.v = __shfl_sync(FULL_MASK, bv, src);
    return true;
}

// Tiles of the flat loop that at least this many lanes of a warp pass are
// swept lane-parallel (sweep_tile on each passing lane); a tile fewer lanes
// pass is swept by the whole warp once per passing lane (warp_sweep).  0 or
// 1: always the lane loop (the one-thread-per-ray loop); 33: always the
// warp.  Set by measurement on the official and Duck waves (PERF.md).
#define LANE_LOOP_MIN 20

// Nearest front-facing hit of the warp's 32 rays over the flat tile loop,
// each skipping its Morton index ``prev`` (-1: none); every lane of the
// warp calls it, an ``active`` one for its ray.  Tiles go in ascending
// order; each lane culls tile j against its own best after tile j - 1, so
// a ray sees its tiles and its triangles in the order of the one-ray loop
// and replaces its best only on a strictly smaller t, whichever way a tile
// is swept: the same t, u, v and winner.  ``swept`` (the same in every
// lane) gets the tiles the warp's rays swept added, ``lane_tiles`` the
// tiles it swept lane-parallel and ``warp_sweeps`` the passing lanes it
// swept a tile for with the whole warp.
__device__ Hit trace_nearest_warp(const ZrcScene& sc, bool active, const float o[3],
                                  const float d[3], int prev, int lane,
                                  unsigned& swept, unsigned& lane_tiles,
                                  unsigned& warp_sweeps) {
    TraceRay r;
    for (int a = 0; a < 3; ++a) {
        r.o[a] = o[a];
        r.d[a] = d[a];
        r.inv[a] = 1.0f / d[a];
    }
    r.prev = prev;
    Hit h = {INFINITY, 0.0f, 0.0f, 0};
    for (int j = 0; j < sc.nt; ++j) {
        bool mine = active && tile_passes(sc.tile_bbox, sc.nt, j, r.o, r.inv, h.t);
        unsigned pass = __ballot_sync(FULL_MASK, mine);
        if (!pass) continue;
        const unsigned passing = __popc(pass);
        swept += passing;
        if (passing >= LANE_LOOP_MIN) {
            ++lane_tiles;
            if (mine) sweep_tile(sc, j, r.o, r.d, prev, h);
            continue;
        }
        warp_sweeps += passing;
        do {
            int k = __ffs(pass) - 1;
            pass &= pass - 1u;
            TraceRay rk;
            for (int a = 0; a < 3; ++a) {
                rk.o[a] = __shfl_sync(FULL_MASK, r.o[a], k);
                rk.d[a] = __shfl_sync(FULL_MASK, r.d[a], k);
            }
            rk.prev = __shfl_sync(FULL_MASK, prev, k);
            Hit hk = {__shfl_sync(FULL_MASK, h.t, k), 0.0f, 0.0f, 0};
            bool better = warp_sweep<true>(sc, j, rk, lane, hk);
            if (lane == k && better) h = hk;
        } while (pass);
    }
    return h;
}

// The heap a per-bounce trace walks: the tile heap (``gbox`` null: leaf
// p2 + j is tile j) or the group heap (leaf p2 + g is group g, whose box is
// column g of the (6, ng) ``gbox`` and whose tiles are g * group_tiles ..
// min((g + 1) * group_tiles, nt) - 1).
struct ZrcHeap {
    const float* tree;       // (6, 2 * p2) f32 implicit heap
    const float* gbox;       // (6, ng) f32 group boxes, or null
    int p2;
    int ng;
    int group_tiles;
};

// Where one lane's walk stands.  Its stack lives in shared memory, entry s
// at stack_n / stack_e[s * TRACE_THREADS + threadIdx.x].
struct LaneWalk {
    int node;   // the node to visit next (0: pop)
    int sp;     // stack entries
    int gk;     // the next tile of the group being visited to cull
    int gend;   // and the end of its real tiles
    int req;    // the tile the lane asks the warp to sweep (-1: none)
    bool done;
};

// Advance one lane's walk, in the order of the per-ray walk of
// _tree_traverse, to its next tile sweep (``w.req``) or to its end
// (``w.done``), against its running best t.  Both children of a node are
// tested against the best; the nearer descends, the farther is pushed with
// its entry t and skipped when popped at or behind the best.  A tile leaf
// asks for a sweep; a group leaf re-culls its box against the best
// (visit_group), then culls its real tiles in ascending order, each against
// the best of its turn, asking for a sweep of each that passes
// (process_group: tiles >= nt in the last group are never read).
// ``tested`` counts the boxes tested (heap nodes, group re-culls, tile
// boxes).
template <bool kGroups>
__device__ void advance_walk(const ZrcScene& sc, const ZrcHeap& hp, const TraceRay& r,
                             float best, LaneWalk& w, int* stack_n, float* stack_e,
                             int& tested) {
    const int p2 = hp.p2;
    const int stride = 2 * p2;
    const int me = threadIdx.x;
    float tmin;
    while (!w.done && w.req < 0) {
        if (kGroups && w.gk < w.gend) {
            ++tested;
            int jt = w.gk++;
            if (box_passes(sc.tile_bbox, sc.nt, jt, r, best, tmin)) w.req = jt;
        } else if (w.node >= p2) {
            int j = w.node - p2;
            w.node = 0;
            if (!kGroups) {
                if (j < sc.nt) w.req = j;
            } else if (j < hp.ng) {
                ++tested;
                if (box_passes(hp.gbox, hp.ng, j, r, best, tmin)) {
                    w.gk = j * hp.group_tiles;
                    w.gend = min(w.gk + hp.group_tiles, sc.nt);
                }
            }
        } else if (w.node > 0) {
            int c = 2 * w.node;
            float e0 = node_entry(hp.tree, stride, c, r, best);
            float e1 = node_entry(hp.tree, stride, c + 1, r, best);
            tested += 2;
            bool p0 = e0 < INFINITY, p1 = e1 < INFINITY;
            if (p0 && p1) {
                bool right_first = e1 < e0;
                stack_n[w.sp * TRACE_THREADS + me] = right_first ? c : c + 1;
                stack_e[w.sp * TRACE_THREADS + me] = right_first ? e0 : e1;
                ++w.sp;
                w.node = right_first ? c + 1 : c;
            } else {
                w.node = p0 ? c : (p1 ? c + 1 : 0);
            }
        } else if (w.sp > 0) {
            --w.sp;
            if (stack_e[w.sp * TRACE_THREADS + me] < best)
                w.node = stack_n[w.sp * TRACE_THREADS + me];
        } else {
            w.done = true;
        }
    }
}

// -------------------------------------------------------- shade_bounce

// Texel indices of one axis (fused._texel_pair): repeat wraps the floored
// fraction, clamp clamps floor(size * c) to [0, size - 1].
__device__ __forceinline__ void texel_pair(float c, float size, bool repeat,
                                           int& i1, int& i2) {
    float fc = c - floorf(c);
    float r1 = nan_min(floorf(size * fc), size - 1.0f);
    float r2 = r1 + 1.0f;
    if (r2 >= size) r2 = r2 - size;
    float cc = floorf(size * fminf(fmaxf(c, -8.0e9f), 8.0e9f));
    float c1 = nan_min(nan_max(cc, 0.0f), size - 1.0f);
    float c2 = nan_min(nan_max(cc + 1.0f, 0.0f), size - 1.0f);
    i1 = (int)(repeat ? r1 : c1);
    i2 = (int)(repeat ? r2 : c2);
}

// Four bilinear corner indices [p11, p21, p12, p22] of descriptor column d.
__device__ __forceinline__ void tex_indices(const float r[P_COLS], int d,
                                            float tc_u, float tc_v, int idx[4]) {
    float wf = fabsf(r[d + 1]);
    float hf = fabsf(r[d + 2]);
    int x1, x2, y1, y2;
    texel_pair(tc_u, wf, r[d + 1] < 0.0f, x1, x2);
    texel_pair(tc_v, hf, r[d + 2] < 0.0f, y1, y2);
    int off = (int)r[d];
    int w = (int)wf;
    idx[0] = off + y1 * w + x1;
    idx[1] = off + y1 * w + x2;
    idx[2] = off + y2 * w + x1;
    idx[3] = off + y2 * w + x2;
}

__device__ __forceinline__ float4 texel(const ZrcScene& sc, int i, float scale) {
    i = min(max(i, 0), sc.num_texels - 1);
    float4 p = __ldg(sc.bank + i);
    return make_float4(p.x * scale, p.y * scale, p.z * scale, p.w * scale);
}

__device__ __forceinline__ float bilerp(float p11, float p21, float p12,
                                        float p22, float fu, float fv) {
    float r1 = p11 * (1.0f - fu) + p21 * fu;
    float r2 = p12 * (1.0f - fu) + p22 * fu;
    return r1 * (1.0f - fv) + r2 * fv;
}

// Sky on a miss (src/stage3.zig:144-150); the ray dies.
__device__ void shade_sky(float s[S_ROWS]) {
    float sky_t = 0.5f * (s[S_DX + 1] + 1.0f);
    s[S_RR + 0] = s[S_RR + 0] + s[S_TR + 0] * (1.0f - 0.5f * sky_t);
    s[S_RR + 1] = s[S_RR + 1] + s[S_TR + 1] * (1.0f - 0.3f * sky_t);
    s[S_RR + 2] = s[S_RR + 2] + s[S_TR + 2];
    s[S_ALIVE] = 0.0f;
    s[S_SEG] = s[S_SEG] + 1.0f;
    s[S_KEY] = 0.0f;
}

// One bounce of shading for a live ray that hit at (t, u, v) the triangle
// whose packed record is ``r`` (_shade_live after _prep_math).
__device__ void shade_surface(const ZrcScene& sc, float s[S_ROWS],
                              const float r[P_COLS], float u, float v, float t,
                              int bounce) {
    float w0 = 1.0f - u - v;
    float tc_u = r[P_UV + 0] * w0 + r[P_UV + 2] * u + r[P_UV + 4] * v;
    float tc_v = r[P_UV + 1] * w0 + r[P_UV + 3] * u + r[P_UV + 5] * v;
    float nx = r[P_NRM + 0] * w0 + r[P_NRM + 3] * u + r[P_NRM + 6] * v;
    float ny = r[P_NRM + 1] * w0 + r[P_NRM + 4] * u + r[P_NRM + 7] * v;
    float nz = r[P_NRM + 2] * w0 + r[P_NRM + 5] * u + r[P_NRM + 8] * v;
    float fu = fabsf(tc_u - truncf(tc_u));
    float fv = fabsf(tc_v - truncf(tc_v));

    int bi[4];
    tex_indices(r, P_BASE, tc_u, tc_v, bi);
    float bs = r[P_BASE + 3];
    float4 p11 = texel(sc, bi[0], bs), p21 = texel(sc, bi[1], bs);
    float4 p12 = texel(sc, bi[2], bs), p22 = texel(sc, bi[3], bs);
    float ar = bilerp(p11.x, p21.x, p12.x, p22.x, fu, fv);
    float ag = bilerp(p11.y, p21.y, p12.y, p22.y, fu, fv);
    float ab = bilerp(p11.z, p21.z, p12.z, p22.z, fu, fv);
    float opacity = bilerp(p11.w, p21.w, p12.w, p22.w, fu, fv);
    float es = r[P_EMIS + 3];
    float er, eg, eb;
    if (sc.emissive_dummy) {
        float4 e = texel(sc, (int)r[P_EMIS], es);
        er = e.x;
        eg = e.y;
        eb = e.z;
    } else {
        int ei[4];
        tex_indices(r, P_EMIS, tc_u, tc_v, ei);
        float4 e11 = texel(sc, ei[0], es), e21 = texel(sc, ei[1], es);
        float4 e12 = texel(sc, ei[2], es), e22 = texel(sc, ei[3], es);
        er = bilerp(e11.x, e21.x, e12.x, e22.x, fu, fv);
        eg = bilerp(e11.y, e21.y, e12.y, e22.y, fu, fv);
        eb = bilerp(e11.z, e21.z, e12.z, e22.z, fu, fv);
    }

    // stochastic alpha (tag 2b+1) and diffuse scatter (tag 2b+2)
    uint32_t streams = __float_as_uint(s[S_STREAMS]);
    bool pass_through = u01(draw_bits(streams, 2 * bounce + 1, 0)) > opacity;
    int g_tag = 2 * bounce + 2;
    float u1 = u01(draw_bits(streams, g_tag, 0));
    float u2 = u01(draw_bits(streams, g_tag, 1));
    float u3 = u01(draw_bits(streams, g_tag, 2));
    float u4 = u01(draw_bits(streams, g_tag, 3));
    float r1 = sqrtf(-2.0f * logf(u1));
    float r2 = sqrtf(-2.0f * logf(u3));
    float gx = r1 * cosf(TWO_PI * u2);
    float gy = r1 * sinf(TWO_PI * u2);
    float gz = r2 * cosf(TWO_PI * u4);
    float g_inv = rsqrtf(gx * gx + gy * gy + gz * gz);
    float swx = nx + gx * g_inv;
    float swy = ny + gy * g_inv;
    float swz = nz + gz * g_inv;
    float s_inv = rsqrtf(swx * swx + swy * swy + swz * swz);

    if (!pass_through) {
        s[S_RR + 0] = s[S_RR + 0] + s[S_TR + 0] * er;
        s[S_RR + 1] = s[S_RR + 1] + s[S_TR + 1] * eg;
        s[S_RR + 2] = s[S_RR + 2] + s[S_TR + 2] * eb;
        s[S_TR + 0] = s[S_TR + 0] * ar;
        s[S_TR + 1] = s[S_TR + 1] * ag;
        s[S_TR + 2] = s[S_TR + 2] * ab;
    }
    // re-origin at t + FLT_EPSILON (an absolute nudge, src/stage3.zig:209)
    float t_step = t + FLT_EPS;
    for (int a = 0; a < 3; ++a)
        s[S_OX + a] = s[S_OX + a] + s[S_DX + a] * t_step;
    if (!pass_through) {
        s[S_DX + 0] = swx * s_inv;
        s[S_DX + 1] = swy * s_inv;
        s[S_DX + 2] = swz * s_inv;
    }
    s[S_ALIVE] = 1.0f;
    s[S_SEG] = s[S_SEG] + 1.0f;
    s[S_KEY] = 0.0f;
}

// One bounce of shading for a live ray that traced ``h``: the winner's
// record is read from the scene's table (a miss reads none).
__device__ void shade_bounce(const ZrcScene& sc, float s[S_ROWS], const Hit& h,
                             int bounce) {
    if (!(h.t < INFINITY)) {
        shade_sky(s);
        return;
    }
    float r[P_COLS];
    const float4* rp = sc.rec + 6 * (size_t)h.idx;
    for (int q = 0; q < 6; ++q) {
        float4 x = __ldg(rp + q);
        r[4 * q + 0] = x.x;
        r[4 * q + 1] = x.y;
        r[4 * q + 2] = x.z;
        r[4 * q + 3] = x.w;
    }
    shade_surface(sc, s, r, h.u, h.v, h.t, bounce);
}

// ------------------------------------------------------- emit_sort_key
// (dead, 6-D interleaved Morton of origin x scene-exit point) as int32;
// |d| is clamped to >= 1e-12 before the slab test.

__device__ int emit_sort_key(const float* par, const float s[S_ROWS]) {
    int dead = s[S_ALIVE] <= 0.0f ? 1 : 0;
    float far = 0.0f;
    float dd[3];
    for (int a = 0; a < 3; ++a) {
        float d = s[S_DX + a];
        d = d >= 0.0f ? nan_max(d, 1e-12f) : nan_min(d, -1e-12f);
        dd[a] = d;
        float bmin = par[PAR_BMIN + a];
        float span = 32.0f / par[PAR_SCALE + a];
        float inv = 1.0f / d;
        float ta = (bmin - s[S_OX + a]) * inv;
        float tb = (bmin + span - s[S_OX + a]) * inv;
        float fa = nan_max(ta, tb);
        far = a == 0 ? fa : nan_min(far, fa);
    }
    float texit = nan_max(far, 0.0f);
    int key = 0;
    for (int a = 0; a < 3; ++a) {
        float scale = par[PAR_SCALE + a];
        float rel = (s[S_OX + a] - par[PAR_BMIN + a]) * scale;
        int q = (int)nan_min(nan_max(rel, 0.0f), 31.0f);
        float ex = rel + dd[a] * texit * scale;
        int dq = (int)nan_min(nan_max(ex, 0.0f), 31.0f);
        for (int b = 0; b < 5; ++b) {
            key |= ((q >> b) & 1) << (6 * b + 2 * a);
            key |= ((dq >> b) & 1) << (6 * b + 2 * a + 1);
        }
    }
    return (dead << 30) | key;
}

// ------------------------------------------------------------- kernels

// Bounces [bounce0, bounce0 + n) of the lane's ray, for every lane of the
// warp (the trace is the warp's): a lane whose ray is dead, or that has no
// ray, traces and shades nothing.  ``prev`` is excluded at the first bounce
// (-1: none); each later bounce excludes the one before.  Returns the last
// traced winner (``idx`` if the ray never traced).  The warp adds to
// ``counts`` its rays alive at each bounce's trace, the tiles they swept
// and the boxes they tested (the flat loop culls every tile for a live
// ray), summed over the bounces: the sums of the per-bounce trace's aux
// rows 4-6, one atomicAdd each; and to ``sweeps`` the flat loop's tiles
// swept lane-parallel and passing lanes swept by the whole warp.
__device__ int run_bounces(const ZrcScene& sc, float s[S_ROWS], int bounce0,
                           int n, int prev, int idx, unsigned long long* counts,
                           unsigned long long* sweeps) {
    const int lane = threadIdx.x & 31;
    // the warp's, the same in every lane
    unsigned alive = 0, swept = 0, lane_tiles = 0, warp_sweeps = 0;
    for (int b = bounce0; b < bounce0 + n; ++b) {
        bool live = s[S_ALIVE] > 0.0f;
        const unsigned lives = __popc(__ballot_sync(FULL_MASK, live));
        if (!lives) break;
        alive += lives;
        float o[3] = {s[S_OX], s[S_OX + 1], s[S_OX + 2]};
        float d[3] = {s[S_DX], s[S_DX + 1], s[S_DX + 2]};
        Hit h = trace_nearest_warp(sc, live, o, d, prev, lane, swept, lane_tiles,
                                   warp_sweeps);
        if (live) {
            shade_bounce(sc, s, h, b);
            idx = h.idx;
            prev = idx;
        }
    }
    if (lane == 0 && alive) {
        atomicAdd(counts, (unsigned long long)alive);
        atomicAdd(counts + 1, (unsigned long long)swept);
        atomicAdd(counts + 2, (unsigned long long)alive * (unsigned)sc.nt);
        atomicAdd(sweeps, (unsigned long long)lane_tiles);
        atomicAdd(sweeps + 1, (unsigned long long)warp_sweeps);
    }
    return idx;
}

// Threads per block of every kernel but the two per-bounce traces.
constexpr int kThreads = 128;

// The whole-path kernels hold 8 blocks an SM (at most 64 registers a
// thread: 32 of its 64 warps), without spills (PERF.md).  A lane past R is
// born dead.
__global__ void __launch_bounds__(kThreads, 8) path_trace_gen_kernel(
                                      ZrcScene sc, ZrcGen g, int max_bounce,
                                      int emit_key, float* __restrict__ state_out,
                                      int* __restrict__ idx_out,
                                      unsigned long long* __restrict__ counts,
                                      unsigned long long* __restrict__ sweeps, int R) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < R;
    float s[S_ROWS];
    gen_ray(g, i, s);
    if (!in) s[S_ALIVE] = 0.0f;
    int idx = run_bounces(sc, s, 0, max_bounce, -1, 0, counts, sweeps);
    if (!in) return;
    if (emit_key) s[S_KEY] = __int_as_float(emit_sort_key(g.par, s));
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) state_out[(size_t)f * R + i] = s[f];
    if (idx_out) idx_out[i] = idx;
}

__global__ void __launch_bounds__(kThreads, 8) path_trace_kernel(
                                  ZrcScene sc, const float* __restrict__ state_in,
                                  const int* __restrict__ prev, int bounce0,
                                  int max_bounce, float* __restrict__ state_out,
                                  int* __restrict__ idx_out,
                                  unsigned long long* __restrict__ counts,
                                  unsigned long long* __restrict__ sweeps, int R) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < R;
    float s[S_ROWS];
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) s[f] = in ? state_in[(size_t)f * R + i] : 0.0f;
    int p = in && prev ? prev[i] : -1;
    int idx = run_bounces(sc, s, bounce0, max_bounce, p, prev ? p : 0, counts, sweeps);
    if (!in) return;
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) state_out[(size_t)f * R + i] = s[f];
    if (idx_out) idx_out[i] = idx;
}

// ------------------------------------------------- per-bounce kernels
// The per-bounce pipeline (scenes past REC_EMIT_MAX_TRIS padded triangles)
// runs one trace and one shade launch per bounce, with a beam sort between
// bounces done by PyTorch.  State, aux and records are field-major (rows of
// R floats), so thread i reads and writes column i: coalesced.

// The walk of the warp's rays, every lane of the warp calling it with its
// ray ``mine`` (origin, direction, reciprocal and the Morton index it may
// not hit), its best hit ``h`` (+inf) and its walk ``w`` (done, or started
// at the root: walk_start).  Each lane walks its ray (advance_walk); in
// rounds, every lane of the warp walks to its next tile, then the warp
// sweeps the tiles the lanes asked for, one after the other, all 32 lanes
// on each (warp_sweep), until every walk has ended.  ``h`` ends as the
// lane's nearest hit; ``swept`` and ``tested`` get the tiles it swept and
// the boxes it tested.
template <bool kGroups>
__device__ __forceinline__ void walk_warp(const ZrcScene& sc, const ZrcHeap& hp,
                                          const TraceRay& mine, int lane, Hit& h, LaneWalk& w,
                                          int& swept, int& tested, int* stack_n, float* stack_e) {
    while (true) {
        advance_walk<kGroups>(sc, hp, mine, h.t, w, stack_n, stack_e, tested);
        unsigned asks = __ballot_sync(FULL_MASK, w.req >= 0);
        if (!asks) break;
        do {
            int k = __ffs(asks) - 1;
            asks &= asks - 1u;
            TraceRay r;
            for (int a = 0; a < 3; ++a) {
                r.o[a] = __shfl_sync(FULL_MASK, mine.o[a], k);
                r.d[a] = __shfl_sync(FULL_MASK, mine.d[a], k);
            }
            r.prev = __shfl_sync(FULL_MASK, mine.prev, k);
            int j = __shfl_sync(FULL_MASK, w.req, k);
            Hit hk = {__shfl_sync(FULL_MASK, h.t, k), 0.0f, 0.0f, 0};
            bool better = warp_sweep<false>(sc, j, r, lane, hk);
            if (lane == k) {
                if (better) h = hk;
                ++swept;
                w.req = -1;
            }
        } while (asks);
    }
}

// Start a lane's walk at the heap's root (one box tested).
__device__ __forceinline__ void walk_start(const ZrcHeap& hp, const TraceRay& mine, LaneWalk& w,
                                           int& tested) {
    tested = 1;
    w.node = node_entry(hp.tree, 2 * hp.p2, 1, mine, INFINITY) < INFINITY ? 1 : 0;
    w.done = false;
}

// Nearest hit of every ray of a (16, R) state -> aux (8, R) [u, v, t,
// streams, alive, tiles swept, boxes tested, 0], idx (R,) Morton index and,
// when ``rec_out`` is given, the winner's 24-float record read from the
// field-major (24, table_cols) ``table`` (zeros on a miss).  A dead ray
// traces nothing: t = +inf, idx = 0.  Thread i owns column i (coalesced
// loads and stores) and walks its ray (walk_warp).  The warp adds its rays
// alive, tiles swept and boxes tested (aux rows 4-6 of its lanes, as
// integers) to counts[0..2], one atomicAdd each.  Launched with
// TRACE_THREADS threads per block.
template <bool kGroups>
__device__ void trace_warp(const ZrcScene& sc, const ZrcHeap& hp,
                           const float* __restrict__ state,
                           const int* __restrict__ prev,
                           const float* __restrict__ table, int table_cols,
                           float* __restrict__ aux, int* __restrict__ idx_out,
                           float* __restrict__ rec_out,
                           unsigned long long* __restrict__ counts, int R) {
    __shared__ int stack_n[TREE_STACK * TRACE_THREADS];
    __shared__ float stack_e[TREE_STACK * TRACE_THREADS];
    const size_t n = (size_t)R;
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < R;
    float alive = in ? state[S_ALIVE * n + i] : 0.0f;
    TraceRay mine = {};
    mine.prev = -1;
    Hit h = {INFINITY, 0.0f, 0.0f, 0};
    LaneWalk w = {0, 0, 0, 0, -1, true};
    int swept = 0, tested = 0;
    if (alive > 0.0f) {
        for (int a = 0; a < 3; ++a) {
            mine.o[a] = state[(S_OX + a) * n + i];
            mine.d[a] = state[(S_DX + a) * n + i];
            mine.inv[a] = 1.0f / mine.d[a];
        }
        if (prev) mine.prev = prev[i];
        walk_start(hp, mine, w, tested);
    }
    walk_warp<kGroups>(sc, hp, mine, lane, h, w, swept, tested, stack_n, stack_e);
    const unsigned live = __popc(__ballot_sync(FULL_MASK, alive > 0.0f));
    const unsigned tiles = __reduce_add_sync(FULL_MASK, (unsigned)swept);
    const unsigned boxes = __reduce_add_sync(FULL_MASK, (unsigned)tested);
    if (lane == 0 && live) {
        atomicAdd(counts, (unsigned long long)live);
        atomicAdd(counts + 1, (unsigned long long)tiles);
        atomicAdd(counts + 2, (unsigned long long)boxes);
    }
    if (!in) return;
    aux[0 * n + i] = h.u;
    aux[1 * n + i] = h.v;
    aux[2 * n + i] = h.t;
    aux[3 * n + i] = state[S_STREAMS * n + i];
    aux[4 * n + i] = alive;
    aux[5 * n + i] = (float)swept;
    aux[6 * n + i] = (float)tested;
    aux[7 * n + i] = 0.0f;
    idx_out[i] = h.idx;
    if (rec_out) {
        bool hit = h.t < INFINITY;
        for (int k = 0; k < P_COLS; ++k)
            rec_out[k * n + i] =
                hit ? __ldg(table + (size_t)k * table_cols + h.idx) : 0.0f;
    }
}

// Resident scenes: the walk of the tile heap.
__global__ void __launch_bounds__(TRACE_THREADS, 8) trace_emit_kernel(ZrcScene sc, ZrcHeap hp,
                                  const float* __restrict__ state,
                                  const int* __restrict__ prev,
                                  const float* __restrict__ table, int table_cols,
                                  float* __restrict__ aux, int* __restrict__ idx_out,
                                  float* __restrict__ rec_out,
                                  unsigned long long* __restrict__ counts, int R) {
    trace_warp<false>(sc, hp, state, prev, table, table_cols, aux, idx_out, rec_out, counts, R);
}

// Streaming scenes: the walk of the group heap.
__global__ void __launch_bounds__(TRACE_THREADS, 8) trace_stream_kernel(ZrcScene sc, ZrcHeap hp,
                                    const float* __restrict__ state,
                                    const int* __restrict__ prev,
                                    const float* __restrict__ table, int table_cols,
                                    float* __restrict__ aux, int* __restrict__ idx_out,
                                    float* __restrict__ rec_out,
                                    unsigned long long* __restrict__ counts, int R) {
    trace_warp<true>(sc, hp, state, prev, table, table_cols, aux, idx_out, rec_out, counts, R);
}

// One bounce of shading of a (16, R) state from the trace's aux and
// records.  A dead ray's 16 rows pass through; a live ray gets the sky on a
// miss, else the surface shade with the same device code (and so the same
// roundings) as path_trace_kernel.
__global__ void shade_kernel(ZrcScene sc, const float* __restrict__ state_in,
                             const float* __restrict__ aux,
                             const float* __restrict__ rec, int bounce,
                             float* __restrict__ state_out, int R) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    const size_t n = (size_t)R;
    float s[S_ROWS];
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) s[f] = state_in[f * n + i];
    if (s[S_ALIVE] > 0.0f) {
        float t = aux[2 * n + i];
        if (!(t < INFINITY)) {
            shade_sky(s);
        } else {
            float r[P_COLS];
#pragma unroll
            for (int k = 0; k < P_COLS; ++k) r[k] = rec[k * n + i];
            shade_surface(sc, s, r, aux[0 * n + i], aux[1 * n + i], t, bounce);
        }
    }
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) state_out[f * n + i] = s[f];
}

// ------------------------------------------------------------- probes
// Counterparts of the two TPU probes of this path (a paged texel fetch and
// the whole-path kernels' sort key), each a thin kernel around the device
// function the path kernels use, so the function is held to its plain
// version on its own.

struct ZrcTexture {
    int off;       // first texel in the row-major bank
    int w;
    int h;
    int repeat_u;  // 1: repeat wrap on x, 0: clamp
    int repeat_v;
};

// The four bilinear corners of base texel base[i] of texture ``tx``: self,
// +x, +y, +xy, the neighbours under the texture's wrap mode (repeat: (x+1)
// mod w; clamp: min(x+1, w-1)), as _paged_corner_maps bakes them.  At a
// clamp edge the neighbour is the texel itself, loaded twice, which is
// the collapsed corner _paged_corners selects.  Row 4·corner + channel of
// ``out`` (16, B) holds the u16-valued texel of ``texel`` (the shade's
// loader, scale 1); a lane that is not demanded reads 0 (bound by bytes:
// 4 B of index and 1 B of demand in, 64 B out, 4 float4 loads per lane).
__global__ void texel_fetch_kernel(ZrcScene sc, ZrcTexture tx,
                                   const int* __restrict__ base,
                                   const bool* __restrict__ demand,
                                   float* __restrict__ out, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    float4 c[4] = {};
    if (demand[i]) {
        int local = base[i] - tx.off;
        int y = local / tx.w;
        int x = local - y * tx.w;
        int nx = tx.repeat_u ? (x + 1 == tx.w ? 0 : x + 1) : min(x + 1, tx.w - 1);
        int ny = tx.repeat_v ? (y + 1 == tx.h ? 0 : y + 1) : min(y + 1, tx.h - 1);
        c[0] = texel(sc, tx.off + y * tx.w + x, 1.0f);
        c[1] = texel(sc, tx.off + y * tx.w + nx, 1.0f);
        c[2] = texel(sc, tx.off + ny * tx.w + x, 1.0f);
        c[3] = texel(sc, tx.off + ny * tx.w + nx, 1.0f);
    }
    const size_t n = (size_t)B;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        out[(4 * k + 0) * n + i] = c[k].x;
        out[(4 * k + 1) * n + i] = c[k].y;
        out[(4 * k + 2) * n + i] = c[k].z;
        out[(4 * k + 3) * n + i] = c[k].w;
    }
}

// emit_sort_key of every column of a (16, R) state into key[i] (bound by
// bytes: 28 B of state in and 4 B out per lane against ~80 operations).
__global__ void sort_key_kernel(const float* __restrict__ state,
                                const float* __restrict__ par,
                                int* __restrict__ key, int R) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    float s[S_ROWS];
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) s[f] = state[(size_t)f * R + i];
    key[i] = emit_sort_key(par, s);
}

// The host beam-sort key (render/wavefront.py ray_sort_key_ref, the JAX
// package's _ray_sort_key) of one lane: (dead << 30) | 6-D Morton code of
// the origin x the point where the ray leaves the scene box.  Equal to the
// twin bit for bit, so the twin's order of operations and roundings stand:
// (o - bmin) / span and 1 / d are IEEE divisions, o + d * texit rounds
// twice (--fmad=false).  NaNs: the slab's fmax drops one (fmaxf), the min
// over the axes, the clamp of texit and the clamps to [0, 31] keep one
// (torch.minimum / clamp), and (int) of a NaN is 0, as PyTorch's cast on
// the card (cvt.rzi).  Dead lanes are keyed from whatever they hold, as
// the twin keys them.
__device__ __forceinline__ int host_sort_key(const float o[3], const float d[3], float alive,
                                             const float bmin[3], const float bmax[3],
                                             const float span[3]) {
    float far[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float inv = 1.0f / d[a];
        float ta = (bmin[a] - o[a]) * inv;
        float tb = (bmax[a] - o[a]) * inv;
        far[a] = fmaxf(ta, tb);
    }
    int dead = alive <= 0.0f ? 1 : 0;
    float texit = nan_max(nan_min(nan_min(far[0], far[1]), far[2]), 0.0f);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float rel = (o[a] - bmin[a]) / span[a];
        int q = (int)nan_min(nan_max(rel * 32.0f, 0.0f), 31.0f);
        float ex = (o[a] + d[a] * texit - bmin[a]) / span[a];
        int dq = (int)nan_min(nan_max(ex * 32.0f, 0.0f), 31.0f);
#pragma unroll
        for (int b = 0; b < 5; ++b) {
            k |= ((q >> b) & 1) << (6 * b + 2 * a);
            k |= ((dq >> b) & 1) << (6 * b + 2 * a + 1);
        }
    }
    return (dead << 30) | k;
}

// Lanes a thread of ray_sort_key_kernel: float2 rows, one int2 store (4
// lanes, float4 and int4, measured slower: PERF.md).
constexpr int kSortKeyLanes = 2;

// Lane j of a row (j known at compile time once unrolled: a register,
// where indexing the struct's memory would spill it).
__device__ __forceinline__ float component(const float2& v, int j) {
    return j == 0 ? v.x : v.y;
}
__device__ __forceinline__ int2 pack_keys(const int (&k)[2]) { return make_int2(k[0], k[1]); }

// host_sort_key of every column of a (16, R) state into key[i],
// kSortKeyLanes consecutive lanes a thread.  Bound by bytes: 28 B of
// state in and 4 B out per lane.  A thread reads each of its seven rows
// (origin, direction, alive) with one vector load and writes its keys with
// one vector store, so R must be a multiple of the lanes and the state and
// key aligned to a vector (launch_ray_sort_key refuses anything else).
__global__ void __launch_bounds__(kThreads) ray_sort_key_kernel(
        const float* __restrict__ state, const float* __restrict__ bbox_min,
        const float* __restrict__ bbox_max, int* __restrict__ key, int R) {
    constexpr int L = kSortKeyLanes;
    using F = float2;
    using I = int2;
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= R / L) return;
    const size_t n = (size_t)R;
    float bmin[3], bmax[3], span[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        bmin[a] = bbox_min[a];
        bmax[a] = bbox_max[a];
        span[a] = nan_max(bmax[a] - bmin[a], 1e-30f);
    }
    F rows[7];
#pragma unroll
    for (int f = 0; f < 6; ++f) rows[f] = reinterpret_cast<const F*>(state + (S_OX + f) * n)[q];
    rows[6] = reinterpret_cast<const F*>(state + S_ALIVE * n)[q];
    int k[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const float o[3] = {component(rows[0], j), component(rows[1], j), component(rows[2], j)};
        const float d[3] = {component(rows[3], j), component(rows[4], j), component(rows[5], j)};
        k[j] = host_sort_key(o, d, component(rows[6], j), bmin, bmax, span);
    }
    reinterpret_cast<I*>(key)[q] = pack_keys(k);
}

// ------------------------------------------------------------ grid walk
// grid_walk_kernel: the nearest hit of each ray by the uniform grid's DDA
// and Moller-Trumbore, the JAX package's trace_wave
// (zig_raytracing_contest_tpu/render/wavefront.py:360, a jax.lax.while_loop
// at :423 that XLA runs over the whole wave until every lane is done),
// equal bit for bit to render/wavefront.py trace_wave_ref.  A ray's walk is
// a sequence of iterations: each tests up to GRID_TRI_BATCH references of
// its cell in order (a strictly smaller t wins, the first of equal ones
// stays, as the twin's argmin) and, once the cell is exhausted, steps the
// DDA (axis table {2,1,2,1,2,2,0,0}, the exit cell gives +inf); the ray is
// done when its best t is at most the crossing t (leaving the grid: inf <=
// inf).  The loop's iteration count is the largest ray's: each lane keeps
// the largest of the rays it walked, then a warp max and one atomicMax a
// warp.  Every ray's iterations are summed into ``it_sum`` the same way (a
// lane's sum, a warp sum, one atomicAdd a warp).  A lane keeps
// both in its slots of shared memory, not in registers, and the kernel is
// held to 7 blocks an SM (at most 72 registers): the occupancy the walk had
// before it summed its iterations (kept in registers the sum took it to
// 76 registers, 6 blocks an SM and 5-7% more time a wave; PERF.md §6).
// No host synchronisation.
// Parity: the twin's order of operations, each op rounded once
// (--fmad=false), IEEE divides, NaN-keeping min/max in the slab test,
// (long long) of a float as PyTorch's cast on the card (cvt.rzi).
// What bounds it on this card.  The work is small (the --large terrain's
// 128^3 grid: ~18-28 triangle tests and ~86-131 DDA steps a walking ray,
// ~50 us of f32 operations for 1.8M rays), but the instructions issued are
// many: 94-98% of the steps enter an empty cell, each step is a chain of
// compares and selects, and a triangle test (~75 instructions under
// --fmad=false, an IEEE divide) holds the whole warp while one lane runs
// it.  The design of commit 8108396 (one thread a ray to its end) issued
// ~60 instructions a step and its warps waited for their longest ray and
// for any lane's tests (1.1 / 2.7 / 3.3 ms at bounces 0 / 1 / 2 of the
// --large frame on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  Here:
// * a lean step: the cell's index and each axis's steps left are kept, so
//   a step is three compares, two selects and one update, not the index
//   recomputed and the exit cell compared;
// * the lanes are refilled as their rays finish (persistent warps with
//   dynamic ray fetch, Aila and Laine, HPG 2009): about enough blocks to
//   fill the card; a warp takes 32 ray positions at a time from a global
//   counter (iterations[1], one atomicAdd) and hands them out once
//   GRID_REFILL_MIN of its lanes are idle (a ray's set-up, 15 IEEE
//   divides, then runs for several lanes at once); each ray writes its own
//   output slot;
// * the warp tests together: between passes of GRID_PASS iterations, when
//   at most GRID_COOP_MAX lanes stand at an occupied cell, their cells'
//   references are spread over the 32 lanes (grid_coop_tests) and the
//   others wait; with more, as on a coherent primary wave, each lane tests
//   its own (grid_iteration).
// Measured against other designs on the --large frame's waves (PERF.md):
// an occupancy bitmap (a bit a cell, or a 2^3-brick map in shared memory)
// that spares an empty cell its range load made every design slower (more
// instructions a step; the range load's latency was hidden), waiting for
// several lanes before testing lost to the cooperative tests, walking
// bounces 1-2 in a cell-coherent order did not make the walk faster, and
// one thread a ray with the lean step, the fastest on the coherent
// bounce-0 wave (0.73 against 1.05 ms), lost the most at bounces 1-2 (2.19
// / 2.76 against 1.40 / 1.46 ms).  Those builds are in commit b6739df's
// path_trace.cu and probes/grid_walk.py.
//
// The shaded walk, grid_walk_kernel<true> (zrc_grid_walk_shaded): the XLA
// shading path's whole wave on a grid scene with no extension on, in B + 1
// launches for B bounces, which replace render_wave_xla's per-bounce
// PyTorch shade (~450 gathers and elementwise ops over the whole wave a
// bounce, dead lanes included) and are equal to it bit for bit.  The wave's
// ray state stays on the device between the launches (ZrcGridWave): origin,
// direction, throughput, radiance and segments, and the previous hit (t, u,
// v and the reference, the walk's own outputs); the streams are recomputed
// from the generator's scalars (wave_stream), which launch 0 also makes the
// primary rays from (wave_primary_ray).  At
// launch b a lane that takes ray r first shades r's hit of bounce b - 1 as
// shade_and_scatter and the wave's updates do (the sky on a miss, which
// ends the ray; else the shade table's row of the reference's unique
// triangle, the two bilinear samples of ops/texture.py, the alpha draw and
// the Gaussian, the radiance, throughput, origin and direction), then walks
// bounce b from the new origin with that triangle excluded, exactly as the
// walk alone does; launch 0 makes and walks the primary rays, launch B
// only shades.
// A ray is alive at launch b when it walked at every launch before (its
// segments equal b), so a ray that ended costs one load, and a lane shades
// beside the other lanes the warp hands rays to at once.

#define GRID_TRI_BATCH 4
#define GRID_THREADS 128
// iterations of each lane's walk between two looks at the warp
#define GRID_PASS 8
// the most lanes at an occupied cell whose tests the warp shares
#define GRID_COOP_MAX 20
// the idle lanes a warp waits for before it hands out new rays
#define GRID_REFILL_MIN 8
// the blocks an SM holds: bounds the walk's registers (65536 / (7 * 128))
#define GRID_BLOCKS_PER_SM 7
// the blocks an SM holds of the shaded walk, whose take shades a ray (at
// most 102 registers; 4 to 7 measured on the --large frame's wave, PERF.md:
// 5 the fastest, with a spill of 60 bytes)
#define GRID_SHADE_BLOCKS_PER_SM 5

struct ZrcGrid {
    const float4* tri;   // (D + 1, 12) f32: v0 xyz, e1 x | e1 yz, e2 xy | e2 z,
                         // dup_to_tri as int bits, 0, 0
    const int2* cells;   // (C, 2) int32: each cell's [begin, end) of references
    float bmin[3];
    float bmax[3];
    float cell[3];       // cell size
    int res[3];
    int num_cells;       // C
};

// The shaded walk's wave: the rays' state, kept on the device between the
// wave's launches, and what the shade reads.
struct ZrcGridWave {
    float* orig;                  // (R, 3) f32: each ray's origin
    float* dir;                   // (R, 3) f32: its direction
    float* thr;                   // (R, 3) f32: its throughput
    float* rows4;                 // (4, R) f32: radiance (rows 0-2), segments (row 3)
    ZrcGen gen;                   // the primary rays and the streams (wave_primary_ray)
    const float4* shade;          // (T, 8) float4: the shade table, 32 f32 a triangle
    const float4* bank;           // (P, 4) f32: the texel bank (color_data)
    int num_texels;               // P
    int bounce;                   // b: this launch shades bounce b - 1's hits
    int walk;                     // b < B: then walks bounce b
    unsigned long long* alive;    // one uint64: += the rays this launch walks
};

// linalg.moller_trumbore (ops/linalg.py): pvec, det, 1/det, u, qvec, v, t,
// dot products as (a0 b0 + a1 b1) + a2 b2.
__device__ __forceinline__ bool mt_hit(const float o[3], const float d[3], float4 a,
                                       float4 b, float4 c, float& t, float& u, float& v) {
    const float v0[3] = {a.x, a.y, a.z};
    const float e1[3] = {a.w, b.x, b.y};
    const float e2[3] = {b.z, b.w, c.x};
    float p0 = d[1] * e2[2] - d[2] * e2[1];
    float p1 = d[2] * e2[0] - d[0] * e2[2];
    float p2 = d[0] * e2[1] - d[1] * e2[0];
    float det = e1[0] * p0 + e1[1] * p1 + e1[2] * p2;
    float inv = 1.0f / det;
    float tv0 = o[0] - v0[0], tv1 = o[1] - v0[1], tv2 = o[2] - v0[2];
    u = (tv0 * p0 + tv1 * p1 + tv2 * p2) * inv;
    float q0 = tv1 * e1[2] - tv2 * e1[1];
    float q1 = tv2 * e1[0] - tv0 * e1[2];
    float q2 = tv0 * e1[1] - tv1 * e1[0];
    v = (d[0] * q0 + d[1] * q1 + d[2] * q2) * inv;
    t = (e2[0] * q0 + e2[1] * q1 + e2[2] * q2) * inv;
    return det >= MT_EPSILON && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

__device__ __forceinline__ int grid_cell_lin(const ZrcGrid& g, const int c[3]) {
    int lin = (c[2] * g.res[1] + c[1]) * g.res[0] + c[0];
    return min(max(lin, 0), g.num_cells - 1);
}

// One lane's walk: its ray, the DDA state, the best hit and the references
// of the current cell still to test ([cursor, end)).
struct GridLane {
    int ray;             // the ray's slot, -1 when the lane has none
    float o[3], d[3];
    float t_delta[3], t_next[3];
    int lin;             // the cell's index, (z ry + y) rx + x
    int left[3];         // steps along each axis before the exit cell
    int stride[3];       // what a step along each axis adds to lin
    float best_t, best_u, best_v;
    int best_i;
    int cursor, end;
    long long ex;
    int it;              // this ray's iterations
};

// Enter the lane's cell: its references, [cursor, end).
__device__ __forceinline__ void grid_enter(const ZrcGrid& g, GridLane& L) {
    const int2 range = g.cells[L.lin];
    L.cursor = range.x;
    L.end = range.y;
}

// Take ray r: the slab test and dda.dda_setup, then enter its first cell.
// A ray that misses the box, or (the walk alone) is not active, is written
// out at once (t +inf, u v 0, reference 0) and false returned.  The walk
// alone reads ray r of ``orig``, ``dir`` and ``exclude``; the shaded walk
// passes the ray's own origin and direction (3 floats each) and sets L.ex
// itself.
template <bool kShade>
__device__ __forceinline__ bool grid_setup(const ZrcGrid& g, const float* __restrict__ orig,
                                           const float* __restrict__ dir,
                                           const bool* __restrict__ active,
                                           const long long* __restrict__ exclude, int r,
                                           GridLane& L, float* __restrict__ t_out,
                                           float* __restrict__ u_out, float* __restrict__ v_out,
                                           long long* __restrict__ idx_out) {
    L.ray = r;
    L.it = 0;
    L.best_t = INFINITY;
    L.best_u = L.best_v = 0.0f;
    L.best_i = 0;
    const size_t at = kShade ? 0 : 3 * (size_t)r;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        L.o[a] = orig[at + a];
        L.d[a] = dir[at + a];
    }
    // linalg.ray_bbox_intersection: narrowing y then z
    bool sign[3];
    float near_[3], far_[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        sign[a] = L.d[a] < 0.0f;
        near_[a] = ((sign[a] ? g.bmax[a] : g.bmin[a]) - L.o[a]) / L.d[a];
        far_[a] = ((sign[a] ? g.bmin[a] : g.bmax[a]) - L.o[a]) / L.d[a];
    }
    float tmin = near_[0], tmax = far_[0];
    bool miss = tmin > far_[1] || tmax < near_[1];
    tmin = nan_max(tmin, near_[1]);
    tmax = nan_min(tmax, far_[1]);
    miss = miss || tmin > far_[2] || tmax < near_[2];
    tmin = nan_max(tmin, near_[2]);
    if (miss || (!kShade && !active[r])) {
        t_out[r] = INFINITY;
        u_out[r] = 0.0f;
        v_out[r] = 0.0f;
        idx_out[r] = 0;
        return false;
    }
    // dda.dda_setup
    const float t_entry = nan_max(tmin, 0.0f);
    int cell[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        L.t_delta[a] = fabsf(g.cell[a] / L.d[a]);
        float hit_local = (L.o[a] + L.d[a] * t_entry) - g.bmin[a];
        long long c = (long long)(hit_local / g.cell[a]);
        c = c < 0 ? 0 : c;
        c = c < g.res[a] - 1 ? c : g.res[a] - 1;
        cell[a] = (int)c;
        float next_cell = (float)(cell[a] + (sign[a] ? 0 : 1));
        L.t_next[a] = t_entry + (next_cell * g.cell[a] - hit_local) / L.d[a];
        L.left[a] = sign[a] ? cell[a] : g.res[a] - 1 - cell[a];
    }
    L.lin = grid_cell_lin(g, cell);  // (in range: the clamp changes nothing)
    L.stride[0] = sign[0] ? -1 : 1;
    L.stride[1] = sign[1] ? -g.res[0] : g.res[0];
    L.stride[2] = sign[2] ? -g.res[0] * g.res[1] : g.res[0] * g.res[1];
    if (!kShade) L.ex = exclude != nullptr ? exclude[r] : 0;
    grid_enter(g, L);
    return true;
}

// ---------------------------------------------------- the shaded walk's take

// A bank index of ops/texture.py: (offset + y w + x) in int32 as PyTorch
// computes it (wrapping), clamped to [0, P - 1] before the load.
__device__ __forceinline__ float4 bank_texel(const float4* __restrict__ bank, int P, int off,
                                             int w, int x, int y) {
    const int i = (int)((unsigned)off + (unsigned)y * (unsigned)w + (unsigned)x);
    return __ldg(bank + min(max(i, 0), P - 1));
}

// ops/texture.py _texel_pair, of one axis: repeat wraps the floored
// fraction; clamp clips c to ±(2^31 - 2) (as f32: ±2^31; torch.clamp keeps
// NaN), floors size·c and clamps it and its successor to [lo, hi].
__device__ __forceinline__ void bank_axis(float c, float size, float lo, float hi, bool repeat,
                                          int& i1, int& i2) {
    const float fc = c - floorf(c);
    const float r1 = nan_min(floorf(size * fc), size - 1.0f);
    float r2 = r1 + 1.0f;
    if (r2 >= size) r2 = r2 - size;
    const float cl = c != c ? c : fminf(fmaxf(c, -2147483648.0f), 2147483648.0f);
    const float cc = floorf(size * cl);
    const float c1 = nan_min(nan_max(cc, lo), hi);
    const float c2 = nan_min(nan_max(cc + 1.0f, lo), hi);
    i1 = (int)(repeat ? r1 : c1);
    i2 = (int)(repeat ? r2 : c2);
}

// ops/texture.py sample_texture at one point of the f32 bank: the
// descriptor [offset, w, h, u_min, u_max, v_min, v_max] (repeat: sentinel
// bounds, a negative lower one); the weights frac(u) = |u - trunc(u)| of
// the raw uv.
__device__ __forceinline__ float4 sample_bank(const float4* __restrict__ bank, int P,
                                              const float* desc, float u, float v) {
    int x1, x2, y1, y2;
    bank_axis(u, desc[1], desc[3], desc[4], desc[3] < 0.0f, x1, x2);
    bank_axis(v, desc[2], desc[5], desc[6], desc[5] < 0.0f, y1, y2);
    const int off = (int)desc[0], w = (int)desc[1];
    const float4 p11 = bank_texel(bank, P, off, w, x1, y1);
    const float4 p21 = bank_texel(bank, P, off, w, x2, y1);
    const float4 p12 = bank_texel(bank, P, off, w, x1, y2);
    const float4 p22 = bank_texel(bank, P, off, w, x2, y2);
    const float fu = fabsf(u - truncf(u)), fv = fabsf(v - truncf(v));
    return make_float4(bilerp(p11.x, p21.x, p12.x, p22.x, fu, fv),
                       bilerp(p11.y, p21.y, p12.y, p22.y, fu, fv),
                       bilerp(p11.z, p21.z, p12.z, p22.z, fu, fv),
                       bilerp(p11.w, p21.w, p12.w, p22.w, fu, fv));
}

// linalg.normalize: a · (1 / length(a)), the length's square root
// correctly rounded and the reciprocal an IEEE division.
__device__ __forceinline__ void normalize3(float a[3]) {
    const float inv = 1.0f / __fsqrt_rn(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
    a[0] = a[0] * inv;
    a[1] = a[1] * inv;
    a[2] = a[2] * inv;
}

// The shaded waves' primary rays (wavefront.xla_primary_rays), made by
// their first launch when it takes lane i of a raster-order wave whose
// first pixel (x_base, y_base) is its slot base; ``g``'s tile fields are
// unused.  Lane i's stream keys on its global ray id slot_base·spp + i,
// wrapped to 32 bits as ops/rng.py ray_streams masks it; every launch
// recomputes it (a few integer ops) instead of reading it from memory.
__device__ __forceinline__ uint32_t wave_stream(const ZrcGen& g, int i) {
    const uint32_t gid =
        ((uint32_t)g.y_base * (uint32_t)g.width + (uint32_t)g.x_base) * (uint32_t)g.spp +
        (uint32_t)i;
    return mix32(gid ^ (g.seed * 0x9E3779B9u) ^ 0x85EBCA6Bu);
}

// Lane i's origin and direction: wave_pixel_coords' pixel, the jitter of
// the stream's tag 0, normalize(llc + right sx + up sy) (each op rounded
// once, as the PyTorch ops round it).
__device__ __forceinline__ void wave_primary_ray(const ZrcGen& g, int i, float o[3],
                                                 float d[3]) {
    const unsigned row_off = (unsigned)g.x_base + (unsigned)(i / g.spp);
    const float x = (float)(row_off % (unsigned)g.width);
    const float y = (float)((long long)g.y_base + (long long)(row_off / (unsigned)g.width));
    const uint32_t s = wave_stream(g, i);
    const float sx = x + u01(draw_bits(s, 0, 0));
    const float sy = y + u01(draw_bits(s, 0, 1));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        o[a] = __ldg(g.par + PAR_ORIGIN + a);
        d[a] = (__ldg(g.par + PAR_LLC + a) + __ldg(g.par + PAR_RIGHT + a) * sx) +
               __ldg(g.par + PAR_UP + a) * sy;
    }
    normalize3(d);
}

// The shaded walk takes ray r at launch b = w.bounce: a ray that ended
// before is passed over; a live ray first shades its hit of bounce b - 1
// (render_wave_xla's shade_and_scatter and updates: the sky on a miss,
// which ends it), then, if b < B, counts a segment and walks bounce b with
// that hit's triangle excluded.  Returns true when the ray walks on (L
// holds it); ``walks``: the ray was alive at this launch's trace.
__device__ __forceinline__ bool grid_shade_take(const ZrcGrid& g, const ZrcGridWave& w, int r,
                                                int R, GridLane& L, float* __restrict__ t_out,
                                                float* __restrict__ u_out,
                                                float* __restrict__ v_out,
                                                long long* __restrict__ idx_out, bool& walks) {
    float* const seg = w.rows4 + 3 * (size_t)R + r;
    float* const rad = w.rows4 + r;  // radiance channel a at rad[a R]
    float* const thr = w.thr + 3 * (size_t)r;
    float* const orig = w.orig + 3 * (size_t)r;
    float* const dir = w.dir + 3 * (size_t)r;
    const int b = w.bounce;
    walks = false;
    float o[3], d[3];
    long long ex = 0;
    if (b == 0) {
        // the primary ray, kept for the later launches: throughput 1, no
        // radiance yet
        wave_primary_ray(w.gen, r, o, d);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            orig[a] = o[a];
            dir[a] = d[a];
            thr[a] = 1.0f;
            rad[a * (size_t)R] = 0.0f;
        }
        if (!w.walk) *seg = 0.0f;
    } else {
        if (*seg != (float)b) return false;  // ended at an earlier launch
        float tr[3], rr[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            o[a] = orig[a];
            d[a] = dir[a];
            tr[a] = thr[a];
            rr[a] = rad[a * (size_t)R];
        }
        const float t = t_out[r];
        if (t == INFINITY) {
            // linalg.env_color: white (1 - s) + (0.5, 0.7, 1.0) s, s = (d.y + 1) / 2
            const float s = 0.5f * (d[1] + 1.0f);
            const float one = 1.0f - s;
            const float env[3] = {one + 0.5f * s, one + 0.7f * s, one + 1.0f * s};
#pragma unroll
            for (int a = 0; a < 3; ++a) rad[a * (size_t)R] = rr[a] + tr[a] * env[a];
            return false;
        }
        const float u = u_out[r], v = v_out[r];
        const int tri = __float_as_int(__ldg(g.tri + 3 * (size_t)idx_out[r] + 2).y);
        float row[SHADE_COLS];
        const float4* rp = w.shade + (SHADE_COLS / 4) * (size_t)tri;
#pragma unroll
        for (int q = 0; q < SHADE_COLS / 4; ++q) {
            const float4 x = __ldg(rp + q);
            row[4 * q + 0] = x.x;
            row[4 * q + 1] = x.y;
            row[4 * q + 2] = x.z;
            row[4 * q + 3] = x.w;
        }
        // _interpolate: v0 (1 - u - v) + v1 u + v2 v
        const float w0 = 1.0f - u - v;
        const float tc_u = row[COL_UV + 0] * w0 + row[COL_UV + 2] * u + row[COL_UV + 4] * v;
        const float tc_v = row[COL_UV + 1] * w0 + row[COL_UV + 3] * u + row[COL_UV + 5] * v;
        float n[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            n[a] = row[COL_NRM + a] * w0 + row[COL_NRM + 3 + a] * u + row[COL_NRM + 6 + a] * v;
        const float4 base = sample_bank(w.bank, w.num_texels, row + COL_BASE_DESC, tc_u, tc_v);
        const float4 emis = sample_bank(w.bank, w.num_texels, row + COL_EMIS_DESC, tc_u, tc_v);
        // stochastic alpha (tag 2b' + 1) and the Gaussian (tag 2b' + 2) of
        // the hit's bounce b' = b - 1: ops/rng.py uniform and normal3
        const uint32_t streams = wave_stream(w.gen, r);
        const bool through = u01(draw_bits(streams, 2 * b - 1, 0)) > base.w;
        const int g_tag = 2 * b;
        const float u1 = u01(draw_bits(streams, g_tag, 0));
        const float u2 = u01(draw_bits(streams, g_tag, 1));
        const float u3 = u01(draw_bits(streams, g_tag, 2));
        const float u4 = u01(draw_bits(streams, g_tag, 3));
        const float r1 = __fsqrt_rn(-2.0f * logf(u1));
        const float r2 = __fsqrt_rn(-2.0f * logf(u3));
        float gs[3] = {r1 * cosf(TWO_PI * u2), r1 * sinf(TWO_PI * u2), r2 * cosf(TWO_PI * u4)};
        normalize3(gs);
        float sc[3] = {n[0] + gs[0], n[1] + gs[1], n[2] + gs[2]};
        normalize3(sc);
        // the hit: emissive and albedo unless the ray passes through, then
        // the re-origin at t + FLT_EPSILON (src/stage3.zig:209)
        const float em[3] = {emis.x, emis.y, emis.z};
        const float al[3] = {base.x, base.y, base.z};
        const float t_step = t + FLT_EPS;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            rad[a * (size_t)R] = rr[a] + (through ? 0.0f : tr[a] * em[a]);
            if (!through) thr[a] = tr[a] * al[a];
            o[a] = o[a] + d[a] * t_step;
            if (!through) d[a] = sc[a];
            orig[a] = o[a];
            dir[a] = d[a];
        }
        ex = tri;
    }
    if (!w.walk) return false;
    *seg = (float)(b + 1);
    walks = true;
    L.ex = ex;
    return grid_setup<true>(g, o, d, nullptr, nullptr, r, L, t_out, u_out, v_out, idx_out);
}

// grid_shade_take, and a lane left without a ray gets every field of L
// set: no field of the lane's last ray then lives through the shade, whose
// values take its registers (the --large frame's wave 2% faster, PERF.md).
__device__ __forceinline__ bool grid_take_shaded(const ZrcGrid& g, const ZrcGridWave& w, int r,
                                                 int R, GridLane& L, float* __restrict__ t_out,
                                                 float* __restrict__ u_out,
                                                 float* __restrict__ v_out,
                                                 long long* __restrict__ idx_out, bool& walks) {
    if (grid_shade_take(g, w, r, R, L, t_out, u_out, v_out, idx_out, walks)) return true;
    L.ray = -1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        L.o[a] = L.d[a] = L.t_delta[a] = L.t_next[a] = 0.0f;
        L.left[a] = L.stride[a] = 0;
    }
    L.lin = L.best_i = L.cursor = L.end = L.it = 0;
    L.best_t = L.best_u = L.best_v = 0.0f;
    L.ex = 0;
    return false;
}

// One iteration of the lane's walk: up to GRID_TRI_BATCH tests, then, once
// the cell is exhausted, one DDA step.  Returns true when the ray is done
// (its result is then written out).
__device__ __forceinline__ bool grid_iteration(const ZrcGrid& g, bool has_ex, GridLane& L,
                                               float* __restrict__ t_out,
                                               float* __restrict__ u_out,
                                               float* __restrict__ v_out,
                                               long long* __restrict__ idx_out) {
    ++L.it;
    if (L.cursor < L.end) {
#pragma unroll
        for (int j = 0; j < GRID_TRI_BATCH; ++j) {
            if (L.cursor < L.end) {
                const float4* row = g.tri + 3 * (size_t)L.cursor;
                float4 ra = row[0], rb = row[1], rc = row[2];
                float t, u, v;
                bool ok = mt_hit(L.o, L.d, ra, rb, rc, t, u, v) && t > 0.0f;
                if (has_ex) ok = ok && (long long)__float_as_int(rc.y) != L.ex;
                if (ok && t < L.best_t) {
                    L.best_t = t;
                    L.best_u = u;
                    L.best_v = v;
                    L.best_i = L.cursor;
                }
                ++L.cursor;
            }
        }
        if (L.cursor < L.end) return false;
    }
    // cell-advance phase: dda.dda_next on the smallest crossing
    const float t0 = L.t_next[0], t1 = L.t_next[1], t2 = L.t_next[2];
    // the axis table {2,1,2,1,2,2,0,0} of k = 4 (t0<t1) + 2 (t0<t2) + (t1<t2)
    // as two predicates: axis 0 for k 6 and 7, axis 1 for k 1 and 3; at the
    // exit cell (no step left) t_cross is +inf and best_t (never NaN) <= it
    const bool lt01 = t0 < t1;
    const bool ax = lt01 && t0 < t2;
    const bool ay = !lt01 && t1 < t2;
    const float t_cross = ax ? t0 : ay ? t1 : t2;
    const int left = ax ? L.left[0] : ay ? L.left[1] : L.left[2];
    if (left == 0 || L.best_t <= t_cross) {
        t_out[L.ray] = L.best_t;
        u_out[L.ray] = L.best_u;
        v_out[L.ray] = L.best_v;
        idx_out[L.ray] = L.best_i;
        return true;
    }
    const int a = ax ? 0 : ay ? 1 : 2;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        if (a == b) {
            L.t_next[b] = L.t_next[b] + L.t_delta[b];
            --L.left[b];
            L.lin += L.stride[b];
        }
    }
    grid_enter(g, L);
    return false;
}

// The tests of every lane of the warp that stands at an occupied cell, all
// n of its cell's references at once, spread over the warp's 32 lanes:
// item k of the W = sum n pending (lane, reference) pairs goes to lane
// k mod 32, which takes the owner's ray by shuffles and posts a hit as
// (t bits, reference) to the owner's 64-bit key by atomicMin in shared
// memory.  t > 0, so the bits order as the values, and the smallest key is
// the first reference of the smallest t: the hit the owner's own loop
// (strictly smaller t wins) would keep.  The owner then takes it where it
// beats its best t (u and v from one more test of that reference), counts
// the cell's ceil(n / GRID_TRI_BATCH) iterations but the last (the step's)
// and leaves the cell exhausted.
__device__ __forceinline__ void grid_coop_tests(const ZrcGrid& g, bool has_ex, GridLane& L,
                                                unsigned long long* s_key, unsigned lane) {
    const int n = L.ray >= 0 && L.cursor < L.end ? L.end - L.cursor : 0;
    int scan = n;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, scan, off);
        if (lane >= (unsigned)off) scan += v;
    }
    const int total = __shfl_sync(FULL_MASK, scan, 31);
    s_key[lane] = ~0ull;
    __syncwarp();
    for (int base = 0; base < total; base += 32) {
        const int k = base + (int)lane;
        int owner = 0;  // the lanes whose prefix sum is at most k
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
            if (__shfl_sync(FULL_MASK, scan, owner + step - 1) <= k) owner += step;
        const int first = __shfl_sync(FULL_MASK, L.cursor - (scan - n), owner);
        float o[3], d[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            o[a] = __shfl_sync(FULL_MASK, L.o[a], owner);
            d[a] = __shfl_sync(FULL_MASK, L.d[a], owner);
        }
        const long long ex = __shfl_sync(FULL_MASK, L.ex, owner);
        if (k < total) {
            const int ref = first + k;
            const float4* row = g.tri + 3 * (size_t)ref;
            const float4 ra = row[0], rb = row[1], rc = row[2];
            float t, u, v;
            bool ok = mt_hit(o, d, ra, rb, rc, t, u, v) && t > 0.0f;
            if (has_ex) ok = ok && (long long)__float_as_int(rc.y) != ex;
            if (ok)
                atomicMin(s_key + owner,
                          ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)ref);
        }
    }
    __syncwarp();
    if (n > 0) {
        const unsigned long long key = s_key[lane];
        if (key != ~0ull && __uint_as_float((unsigned)(key >> 32)) < L.best_t) {
            const int ref = (int)(unsigned)key;
            const float4* row = g.tri + 3 * (size_t)ref;
            mt_hit(L.o, L.d, row[0], row[1], row[2], L.best_t, L.best_u, L.best_v);
            L.best_i = ref;
        }
        L.it += (n + GRID_TRI_BATCH - 1) / GRID_TRI_BATCH - 1;
        L.cursor = L.end;
    }
    __syncwarp();
}

// iterations[0] (the loop's count) and iterations[1] (the positions handed
// out) must hold 0; ``it_sum`` (one uint64) gets every ray's iterations
// added.  The walk alone (kShade false) reads its rays from orig, dir,
// active and exclude; the shaded walk (kShade true) from ``w``, whose
// ``alive`` gets the rays the launch walks added, and t, u, v and idx hold
// the previous launch's hits when it starts.
template <bool kShade>
__global__ void __launch_bounds__(GRID_THREADS,
                                  kShade ? GRID_SHADE_BLOCKS_PER_SM : GRID_BLOCKS_PER_SM)
grid_walk_kernel(ZrcGrid g, const float* __restrict__ orig, const float* __restrict__ dir,
                 const bool* __restrict__ active, const long long* __restrict__ exclude,
                 float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
                 long long* __restrict__ idx_out, int* __restrict__ iterations,
                 unsigned long long* __restrict__ it_sum, int R, ZrcGridWave w) {
    const bool has_ex = kShade ? w.bounce > 0 : exclude != nullptr;
    const unsigned lane = threadIdx.x & 31;
    __shared__ unsigned long long s_keys[GRID_THREADS];
    unsigned long long* s_key = s_keys + (threadIdx.x & ~31u);
    // each lane's most iterations of a ray, and its rays' iterations summed
    // (shared memory: two more registers would cost the kernel a block an SM)
    __shared__ unsigned s_max[GRID_THREADS], s_sum[GRID_THREADS];
    s_max[threadIdx.x] = s_sum[threadIdx.x] = 0u;
    GridLane L;
    L.ray = -1;
    L.cursor = L.end = 0;
    const unsigned below = (1u << lane) - 1u;
    int pool = 0, pool_end = 0;  // positions this warp took and has not handed out
    bool more = true;            // the counter may still hold positions
    unsigned warp_alive = 0;     // the shaded walk: the rays this warp walked
    for (;;) {
        // hand positions to the idle lanes; a ray that misses the box or is
        // not active is written at once and its lane asks again
        unsigned idle = __ballot_sync(FULL_MASK, L.ray < 0);
        while (idle != 0 && more && (__popc(idle) >= GRID_REFILL_MIN || idle == FULL_MASK)) {
            if (pool == pool_end) {
                int base = 0;
                if (lane == 0) base = atomicAdd(iterations + 1, 32);
                base = __shfl_sync(FULL_MASK, base, 0);
                if (base >= R) {
                    more = false;
                    break;
                }
                pool = base;
                pool_end = min(base + 32, R);
            }
            const int n = min(__popc(idle), pool_end - pool);
            const int rank = __popc(idle & below);
            bool walks = false;
            if (L.ray < 0 && rank < n) {
                const bool took =
                    kShade ? grid_take_shaded(g, w, pool + rank, R, L, t_out, u_out, v_out,
                                              idx_out, walks)
                           : grid_setup<false>(g, orig, dir, active, exclude, pool + rank, L,
                                               t_out, u_out, v_out, idx_out);
                if (!took) L.ray = -1;
            }
            if (kShade) warp_alive += __popc(__ballot_sync(FULL_MASK, walks));
            pool += n;
            idle = __ballot_sync(FULL_MASK, L.ray < 0);
        }
        if (idle == FULL_MASK) break;
        // at most GRID_COOP_MAX lanes at an occupied cell: they test together
        // and every lane walks until it enters one; more: each tests its own
        const int at_cells = __popc(__ballot_sync(FULL_MASK, L.ray >= 0 && L.cursor < L.end));
        const bool coop = at_cells <= GRID_COOP_MAX;
        if (coop && at_cells > 0) grid_coop_tests(g, has_ex, L, s_key, lane);
        // up to GRID_PASS iterations of each lane's walk
        bool run = L.ray >= 0;
        for (int m = 0; run && m < GRID_PASS; ++m) {
            if (grid_iteration(g, has_ex, L, t_out, u_out, v_out, idx_out)) {
                s_max[threadIdx.x] = max(s_max[threadIdx.x], (unsigned)L.it);
                s_sum[threadIdx.x] += L.it;
                L.ray = -1;
                break;
            }
            run = !coop || L.cursor == L.end;
        }
    }
    const int warp_max = (int)__reduce_max_sync(FULL_MASK, s_max[threadIdx.x]);
    if (lane == 0 && warp_max > 0) atomicMax(iterations, warp_max);
    unsigned long long warp_sum = s_sum[threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        warp_sum += __shfl_down_sync(FULL_MASK, warp_sum, off);
    if (lane == 0 && warp_sum > 0) atomicAdd(it_sum, warp_sum);
    if (kShade && lane == 0 && warp_alive > 0)
        atomicAdd(w.alive, (unsigned long long)warp_alive);
}

// ---------------------------------------------------- the bake's shaded trace
// trace_stream_kernel<kShade> and trace_emit_kernel<kShade>
// (zrc_trace_shaded): the XLA shading path's wave on a baked scene with an
// extension on (nee, russian_roulette, pbr), in 2B launches of the bake's
// trace for B bounces.  They replace render_wave_xla's per-bounce PyTorch
// shade and extensions (the shade table's, the texels' and the light
// table's row gathers and a few hundred elementwise ops over the whole
// wave a bounce, dead lanes included) and are equal to it bit for bit.
// The wave's state stays on the device between the launches
// (ZrcTraceWave); the streams are recomputed from the generator's scalars
// (wave_stream).  Bounce b is the two traces render_wave_xla makes, each
// lane the ray of its thread, walked as trace_warp walks it (walk_warp):
// * the nearest launch (TRACE_NEAREST): at b = 0 a lane makes its primary
//   ray (wave_primary_ray) and keeps it; a live lane first rolls Russian
//   roulette (from b = 2, tag TAG_RR + b: it dies, or its throughput is
//   divided by its chance), counts its segment, then traces its ray with
//   the previous hit excluded and keeps the hit;
// * the shadow launch (TRACE_SHADOW): a live lane shades its hit: the sky
//   on a miss, which ends the ray; else the shade table's row, the base
//   and emissive samples, the alpha draw and the Gaussian
//   (shade_and_scatter), pbr_scatter, the emissive term (not counted after
//   a NEE sample) and NEE's light sample (sample_direct_light); it then
//   traces the shadow ray where the sample faces the surface and the light,
//   and adds the sample's radiance where nothing nearer than the light was
//   hit.  A lane that traces nothing keeps only its place in the warp.
// The work counters are the two traces' (rays, tiles, boxes), added as
// trace_warp adds them, and the specular bounces, a ballot a warp.
// Parity: render_wave_xla's ops in its order and with PyTorch's roundings
// on the card: a sum over the last axis of an (R, 3) tensor is
// (a0 + a2) + a1 (two threads an output, the first adding elements 0 and
// 2); a division by a Python float multiplies by its f32 reciprocal; a
// Python constant is its double rounded to f32; torch.rsqrt is rsqrtf.

#define TAG_RR (1 << 20)
#define TAG_NEE (1 << 21)
#define TAG_PBR (1 << 22)
// the blocks an SM holds of either shaded form (TRACE_THREADS threads
// each): at most 80 registers, no spills.  Measured on the sponza-720p-ext
// wave (PERF.md): the nearest form at 8 blocks (64 registers) 1.8% slower
// a wave, at 7 (72) as fast as 6; the shadow form spills at 7 and 8, is
// the same code at 5 and takes 92 registers at 4, no faster.
#define TRACE_SHADED_BLOCKS_PER_SM 6

enum { TRACE_NEAREST = 1, TRACE_SHADOW = 2 };
// each lane's flags: its ray is alive; its next emissive hit counts (NEE)
enum { WAVE_ALIVE = 1, WAVE_EMISSIVE = 2 };

struct ZrcTraceWave {
    float* orig;                  // (R, 3) f32: each ray's origin
    float* dir;                   // (R, 3) f32: its direction
    float* thr;                   // (R, 3) f32: its throughput
    float* rows4;                 // (4, R) f32: radiance (rows 0-2), segments (row 3)
    ZrcGen gen;                   // the primary rays and the streams (wave_primary_ray)
    float* hit;                   // (3, R) f32: t, u, v of its last nearest hit
    int* idx;                     // (R,) int32: that hit's Morton index
    unsigned char* flags;         // (R,) uint8: WAVE_ALIVE | WAVE_EMISSIVE
    const float4* shade;          // (T, 8) float4: the shade table, 32 f32 a triangle
    const float4* bank;           // (P, 4) f32: the texel bank (color_data)
    int num_texels;               // P
    const long long* perm;        // (Tp,) int64: Morton position -> triangle
    const float* mr;              // (T, 2) f32 metallic, roughness; null: pbr off
    const long long* light_tri;   // (L,) int64: NEE's lights (extensions.LightSet)
    const float* light_v0;        // (L, 3) f32
    const float* light_e1;        // (L, 3) f32
    const float* light_e2;        // (L, 3) f32
    const float* light_n;         // (L, 3) f32
    const float* light_cdf;       // (L,) f32
    const float* light_area;      // (1,) f32
    int lights;                   // L; 0: NEE off
    int bounce;                   // b
    int roulette;                 // Russian roulette on
    unsigned long long* counts;   // (8,) uint64: the wave's work counters
};

// What a shadow launch's lane keeps across its walk: the radiance NEE adds
// and the t a hit must reach for the light to be seen.
struct ShadowCarry {
    float contrib[3];
    float lim;
};

__device__ __forceinline__ float torch_sum3(float a0, float a1, float a2) {
    return (a0 + a2) + a1;
}

// ops/rng.py normal3 (Box-Muller): three normals of the (stream, tag) draw.
__device__ __forceinline__ void normal3_draw(uint32_t streams, int tag, float g[3]) {
    const float u1 = u01(draw_bits(streams, tag, 0));
    const float u2 = u01(draw_bits(streams, tag, 1));
    const float u3 = u01(draw_bits(streams, tag, 2));
    const float u4 = u01(draw_bits(streams, tag, 3));
    const float r1 = __fsqrt_rn(-2.0f * logf(u1));
    const float r2 = __fsqrt_rn(-2.0f * logf(u3));
    g[0] = r1 * cosf(TWO_PI * u2);
    g[1] = r1 * sinf(TWO_PI * u2);
    g[2] = r2 * cosf(TWO_PI * u4);
}

// The nearest launch's take of lane i < R (render_wave_xla before its
// trace): false when the ray is dead or dies by Russian roulette; else its
// segment is counted and ``ray`` holds it, the previous hit excluded.
// Launch 0 makes the primary ray (wave_primary_ray), keeps it for the
// later launches and sets its throughput, radiance, segments and flags.
__device__ __forceinline__ bool nearest_take(const ZrcTraceWave& w, int i, int R,
                                             TraceRay& ray) {
    const size_t n = (size_t)R;
    const int b = w.bounce;
    float* const thr = w.thr + 3 * (size_t)i;
    float* const seg = w.rows4 + 3 * n + i;
    if (b == 0) {
        wave_primary_ray(w.gen, i, ray.o, ray.d);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            w.orig[3 * (size_t)i + a] = ray.o[a];
            w.dir[3 * (size_t)i + a] = ray.d[a];
            thr[a] = 1.0f;
            w.rows4[a * n + i] = 0.0f;
        }
        w.flags[i] = WAVE_ALIVE | WAVE_EMISSIVE;
        *seg = 1.0f;
    } else {
        const unsigned char f = w.flags[i];
        if (!(f & WAVE_ALIVE)) return false;
        if (w.roulette && b >= 2) {
            // extensions.roulette: p = clamp(max T, 0.05, 1), survive if u < p
            const float tr[3] = {thr[0], thr[1], thr[2]};
            const float p =
                nan_min(nan_max(nan_max(nan_max(tr[0], tr[1]), tr[2]), (float)0.05), 1.0f);
            if (!(u01(draw_bits(wave_stream(w.gen, i), TAG_RR + b, 0)) < p)) {
                w.flags[i] = f & ~WAVE_ALIVE;
                return false;
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) thr[a] = tr[a] / p;
        }
        *seg = *seg + 1.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            ray.o[a] = w.orig[3 * (size_t)i + a];
            ray.d[a] = w.dir[3 * (size_t)i + a];
        }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) ray.inv[a] = 1.0f / ray.d[a];
    ray.prev = b > 0 ? w.idx[i] : -1;
    return true;
}

// NEE's light sample of a shaded lane (extensions.sample_direct_light) at
// the hit point ``x`` with the interpolated normal ``nrm``: the light by a
// binary search of the area cdf (torch.searchsorted, side "left", clamped
// to the last light), a uniform point on it, the direction and distance to
// it.  Returns whether the sample faces the surface and the light; then
// ``ray`` is the shadow ray (from x lifted along the unit normal) and
// ``carry`` what it adds if nothing nearer than the light is hit.
__device__ __forceinline__ bool light_sample(const ZrcTraceWave& w, uint32_t streams, int b,
                                             const float x[3], const float nrm[3],
                                             const float tr[3], const float al[3],
                                             TraceRay& ray, ShadowCarry& carry) {
    const int tag = TAG_NEE + 4 * b;
    const float u_sel = u01(draw_bits(streams, tag, 0));
    const float u_a = u01(draw_bits(streams, tag + 1, 0));
    const float u_b = u01(draw_bits(streams, tag + 2, 0));
    int lo = 0, hi = w.lights;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(__ldg(w.light_cdf + mid) >= u_sel)) lo = mid + 1;
        else hi = mid;
    }
    const size_t li = (size_t)min(lo, w.lights - 1);
    const float su = __fsqrt_rn(u_a);
    const float b1 = su * (1.0f - u_b);
    const float b2 = su * u_b;
    float wi[3], ln[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float y = (__ldg(w.light_v0 + 3 * li + a) + __ldg(w.light_e1 + 3 * li + a) * b1) +
                        __ldg(w.light_e2 + 3 * li + a) * b2;
        wi[a] = y - x[a];
        ln[a] = __ldg(w.light_n + 3 * li + a);
    }
    const float dist_sq = torch_sum3(wi[0] * wi[0], wi[1] * wi[1], wi[2] * wi[2]);
    const float dist = __fsqrt_rn(dist_sq);
    const float div = nan_max(dist, (float)1e-20);
    const float r = rsqrtf(torch_sum3(nrm[0] * nrm[0], nrm[1] * nrm[1], nrm[2] * nrm[2]));
    float nn[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        wi[a] = wi[a] / div;
        nn[a] = nrm[a] * r;
    }
    const float cos_x = torch_sum3(nn[0] * wi[0], nn[1] * wi[1], nn[2] * wi[2]);
    const float cos_y = torch_sum3(ln[0] * -wi[0], ln[1] * -wi[1], ln[2] * -wi[2]);
    if (!(cos_x > 0.0f && cos_y > 0.0f && dist_sq > (float)1e-12)) return false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        ray.o[a] = x[a] + nn[a] * (float)1e-4;
        ray.d[a] = wi[a];
        ray.inv[a] = 1.0f / wi[a];
    }
    ray.prev = -1;
    // the light's emissive texture at the sample's uv
    const float* lrow = reinterpret_cast<const float*>(w.shade + (SHADE_COLS / 4) *
                                                       (size_t)__ldg(w.light_tri + li));
    const float w0 = (1.0f - b1) - b2;
    const float tu = (lrow[COL_UV + 0] * w0 + lrow[COL_UV + 2] * b1) + lrow[COL_UV + 4] * b2;
    const float tv = (lrow[COL_UV + 1] * w0 + lrow[COL_UV + 3] * b1) + lrow[COL_UV + 5] * b2;
    const float4 le = sample_bank(w.bank, w.num_texels, lrow + COL_EMIS_DESC, tu, tv);
    // albedo / pi x Le x G / pdf_area, pdf_area = 1 / total_area
    const float g = (cos_x * cos_y) / nan_max(dist_sq, (float)1e-12);
    const float scale = (g * __ldg(w.light_area)) * (1.0f / (float)3.141592653589793);
    const float lev[3] = {le.x, le.y, le.z};
#pragma unroll
    for (int a = 0; a < 3; ++a) carry.contrib[a] = ((tr[a] * al[a]) * lev[a]) * scale;
    carry.lim = dist * (float)(1.0 - 1e-3);
    return true;
}

// The shadow launch's take of lane i < R (render_wave_xla from its
// shade_and_scatter to the step): a live ray shades its hit of bounce b
// and steps to its next segment.  Returns whether it traces a shadow ray
// (``ray``, ``carry``); ``spec``: the hit was shaded and reflected
// specularly.
__device__ __forceinline__ bool shadow_take(const ZrcTraceWave& w, int i, int R,
                                            TraceRay& ray, ShadowCarry& carry, bool& spec) {
    const size_t n = (size_t)R;
    const int b = w.bounce;
    spec = false;
    const unsigned char f = w.flags[i];
    if (!(f & WAVE_ALIVE)) return false;
    float* const rad = w.rows4 + i;  // radiance channel a at rad[a n]
    float* const thr = w.thr + 3 * (size_t)i;
    float* const orig = w.orig + 3 * (size_t)i;
    float* const dir = w.dir + 3 * (size_t)i;
    float tr[3], rr[3], o[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        tr[a] = thr[a];
        rr[a] = rad[a * n];
        o[a] = orig[a];
        d[a] = dir[a];
    }
    const float t = w.hit[i];
    if (t == INFINITY) {
        // linalg.env_color: white (1 - s) + (0.5, 0.7, 1.0) s, s = (d.y + 1) / 2
        const float s = 0.5f * (d[1] + 1.0f);
        const float one = 1.0f - s;
        const float env[3] = {one + 0.5f * s, one + 0.7f * s, one + 1.0f * s};
#pragma unroll
        for (int a = 0; a < 3; ++a) rad[a * n] = rr[a] + tr[a] * env[a];
        w.flags[i] = f & ~WAVE_ALIVE;
        return false;
    }
    const float u = w.hit[n + i], v = w.hit[2 * n + i];
    const long long tri = w.perm[w.idx[i]];
    float row[SHADE_COLS];
    const float4* rp = w.shade + (SHADE_COLS / 4) * (size_t)tri;
#pragma unroll
    for (int q = 0; q < SHADE_COLS / 4; ++q) {
        const float4 c = __ldg(rp + q);
        row[4 * q + 0] = c.x;
        row[4 * q + 1] = c.y;
        row[4 * q + 2] = c.z;
        row[4 * q + 3] = c.w;
    }
    // _interpolate: v0 (1 - u - v) + v1 u + v2 v
    const float w0 = 1.0f - u - v;
    const float tc_u = row[COL_UV + 0] * w0 + row[COL_UV + 2] * u + row[COL_UV + 4] * v;
    const float tc_v = row[COL_UV + 1] * w0 + row[COL_UV + 3] * u + row[COL_UV + 5] * v;
    float nrm[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        nrm[a] = row[COL_NRM + a] * w0 + row[COL_NRM + 3 + a] * u + row[COL_NRM + 6 + a] * v;
    const float4 base = sample_bank(w.bank, w.num_texels, row + COL_BASE_DESC, tc_u, tc_v);
    const float4 emis = sample_bank(w.bank, w.num_texels, row + COL_EMIS_DESC, tc_u, tc_v);
    // stochastic alpha (tag 2b + 1) and the diffuse direction (Gaussian tag 2b + 2)
    const uint32_t streams = wave_stream(w.gen, i);
    const bool shaded = !(u01(draw_bits(streams, 2 * b + 1, 0)) > base.w);
    float sc[3];
    normal3_draw(streams, 2 * b + 2, sc);
    normalize3(sc);
#pragma unroll
    for (int a = 0; a < 3; ++a) sc[a] = nrm[a] + sc[a];
    normalize3(sc);
    // the re-origin at t + FLT_EPSILON (src/stage3.zig:209)
    const float t_step = t + FLT_EPS;
    float x[3], nd[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        x[a] = o[a] + d[a] * t_step;
        nd[a] = shaded ? sc[a] : d[a];
    }
    const bool nee = w.lights > 0;
    bool emissive = f & WAVE_EMISSIVE;
    const float em[3] = {emis.x, emis.y, emis.z};
    const float al[3] = {base.x, base.y, base.z};
    if (shaded && (emissive || !nee)) {
#pragma unroll
        for (int a = 0; a < 3; ++a) rr[a] = rr[a] + tr[a] * em[a];
    }
    bool take_spec = false;
    if (w.mr != nullptr) {
        // pbr_scatter: with probability ``metallic`` the mirror direction
        // perturbed by ``roughness``, unless it falls below the surface
        const float metallic = __ldg(w.mr + 2 * tri), rough = __ldg(w.mr + 2 * tri + 1);
        const float dn2 = 2.0f * torch_sum3(d[0] * nrm[0], d[1] * nrm[1], d[2] * nrm[2]);
        float sp[3], jt[3];
        normal3_draw(streams, TAG_PBR + 2 * b, jt);
        normalize3(jt);
#pragma unroll
        for (int a = 0; a < 3; ++a) sp[a] = (d[a] - dn2 * nrm[a]) + rough * jt[a];
        normalize3(sp);
        const bool below = torch_sum3(sp[0] * nrm[0], sp[1] * nrm[1], sp[2] * nrm[2]) <= 0.0f;
        take_spec = u01(draw_bits(streams, TAG_PBR + 2 * b + 1, 0)) < metallic && !below;
        if (shaded && take_spec) {
#pragma unroll
            for (int a = 0; a < 3; ++a) nd[a] = sp[a];
        }
    }
    spec = shaded && take_spec;
    bool facing = false;
    if (nee && shaded) {
        // a lane that NEE samples does not count its next emissive hit
        if (!take_spec) facing = light_sample(w, streams, b, x, nrm, tr, al, ray, carry);
        emissive = take_spec;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        rad[a * n] = rr[a];
        if (shaded) thr[a] = tr[a] * al[a];
        orig[a] = x[a];
        dir[a] = nd[a];
    }
    w.flags[i] = WAVE_ALIVE | (emissive ? WAVE_EMISSIVE : 0);
    return facing;
}

// One launch of the bake's shaded wave: every lane of the warp takes its
// ray (nearest_take / shadow_take), the warp walks them (walk_warp), and a
// lane keeps its nearest hit or adds its light's radiance.  The warp adds
// its rays traced, tiles swept and boxes tested to counts[0..2] (nearest)
// or [4..6] (shadow), and a shadow launch its specular bounces to [7].
template <bool kGroups, int kShade>
__device__ __forceinline__ void trace_warp_shaded(const ZrcScene& sc, const ZrcHeap& hp,
                                                  const ZrcTraceWave& w, int R) {
    __shared__ int stack_n[TREE_STACK * TRACE_THREADS];
    __shared__ float stack_e[TREE_STACK * TRACE_THREADS];
    const size_t n = (size_t)R;
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    TraceRay mine = {};
    mine.prev = -1;
    ShadowCarry carry = {};
    bool live = false, spec = false;
    if (i < R)
        live = kShade == TRACE_NEAREST ? nearest_take(w, i, R, mine)
                                       : shadow_take(w, i, R, mine, carry, spec);
    unsigned long long* const counts = w.counts + (kShade == TRACE_NEAREST ? 0 : 4);
    if (kShade == TRACE_SHADOW) {
        const unsigned specs = __popc(__ballot_sync(FULL_MASK, spec));
        if (lane == 0 && specs) atomicAdd(w.counts + 7, (unsigned long long)specs);
    }
    Hit h = {INFINITY, 0.0f, 0.0f, 0};
    LaneWalk lw = {0, 0, 0, 0, -1, true};
    int swept = 0, tested = 0;
    if (live) walk_start(hp, mine, lw, tested);
    walk_warp<kGroups>(sc, hp, mine, lane, h, lw, swept, tested, stack_n, stack_e);
    const unsigned lives = __popc(__ballot_sync(FULL_MASK, live));
    const unsigned tiles = __reduce_add_sync(FULL_MASK, (unsigned)swept);
    const unsigned boxes = __reduce_add_sync(FULL_MASK, (unsigned)tested);
    if (lane == 0 && lives) {
        atomicAdd(counts, (unsigned long long)lives);
        atomicAdd(counts + 1, (unsigned long long)tiles);
        atomicAdd(counts + 2, (unsigned long long)boxes);
    }
    if (!live) return;
    if (kShade == TRACE_NEAREST) {
        w.hit[i] = h.t;
        w.hit[n + i] = h.u;
        w.hit[2 * n + i] = h.v;
        w.idx[i] = h.idx;
    } else if (h.t >= carry.lim) {
#pragma unroll
        for (int a = 0; a < 3; ++a) w.rows4[a * n + i] = w.rows4[a * n + i] + carry.contrib[a];
    }
}

// The shaded forms of the two traces, under the plain forms' names.
template <int kShade>
__global__ void __launch_bounds__(TRACE_THREADS, TRACE_SHADED_BLOCKS_PER_SM)
trace_emit_kernel(ZrcScene sc, ZrcHeap hp, ZrcTraceWave w, int R) {
    trace_warp_shaded<false, kShade>(sc, hp, w, R);
}

template <int kShade>
__global__ void __launch_bounds__(TRACE_THREADS, TRACE_SHADED_BLOCKS_PER_SM)
trace_stream_kernel(ZrcScene sc, ZrcHeap hp, ZrcTraceWave w, int R) {
    trace_warp_shaded<true, kShade>(sc, hp, w, R);
}

// ------------------------------------------------------------ launchers
// Plain C entry points for ctypes (kernels/__init__.py).  They launch on
// the caller's stream, allocate nothing, and return cudaGetLastError(), or
// ZRC_NOTHING_LAUNCHED when the work is empty.
//
// The trace kernels always count their work, into the counters their entry
// point takes (``counts`` / ``it_sum``), or into zrc_discard when that
// pointer is null.

#define ZRC_NOTHING_LAUNCHED (-1)

// The counters of the launches given none: written, never read.
__device__ unsigned long long zrc_discard[8];

// ``counts``, or zrc_discard on the current device when it is null.
static cudaError_t counts_or_discard(unsigned long long** counts) {
    if (*counts) return cudaSuccess;
    return cudaGetSymbolAddress((void**)counts, zrc_discard);
}

// ``counts``: null, or three uint64 the kernel adds the rays alive at each
// bounce's trace, the tiles swept and the boxes tested to; ``sweeps``:
// null, or two uint64 it adds the flat loop's tiles swept lane-parallel
// and passing lanes swept by the whole warp to.
extern "C" int zrc_path_trace_gen(const ZrcScene* sc, const ZrcGen* g,
                                  int max_bounce, int emit_key, float* state_out,
                                  int* idx_out, unsigned long long* counts,
                                  unsigned long long* sweeps, int R, int device,
                                  void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = counts_or_discard(&counts);
    if (err == cudaSuccess) err = counts_or_discard(&sweeps);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + kThreads - 1) / kThreads;
    path_trace_gen_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *sc, *g, max_bounce, emit_key, state_out, idx_out, counts, sweeps, R);
    return (int)cudaGetLastError();
}

// ``counts`` and ``sweeps`` as zrc_path_trace_gen's.
extern "C" int zrc_path_trace(const ZrcScene* sc, const float* state_in,
                              const int* prev, int bounce0, int max_bounce,
                              float* state_out, int* idx_out,
                              unsigned long long* counts, unsigned long long* sweeps,
                              int R, int device, void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = counts_or_discard(&counts);
    if (err == cudaSuccess) err = counts_or_discard(&sweeps);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + kThreads - 1) / kThreads;
    path_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *sc, state_in, prev, bounce0, max_bounce, state_out, idx_out, counts, sweeps, R);
    return (int)cudaGetLastError();
}

// A heap with group boxes launches trace_stream_kernel, else
// trace_emit_kernel, TRACE_THREADS threads per block.  ``counts``: null, or
// three uint64 the kernel adds the rays alive, tiles swept and boxes tested
// to.
extern "C" int zrc_trace_emit(const ZrcScene* sc, const ZrcHeap* hp,
                              const float* state, const int* prev,
                              const float* table, int table_cols, float* aux,
                              int* idx_out, float* rec_out,
                              unsigned long long* counts, int R, int device,
                              void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    if (hp->p2 < 1 || hp->p2 > (1 << TREE_STACK) || (hp->gbox && hp->group_tiles < 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = counts_or_discard(&counts);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + TRACE_THREADS - 1) / TRACE_THREADS;
    if (hp->gbox)
        trace_stream_kernel<<<blocks, TRACE_THREADS, 0, (cudaStream_t)stream>>>(
            *sc, *hp, state, prev, table, table_cols, aux, idx_out, rec_out, counts, R);
    else
        trace_emit_kernel<<<blocks, TRACE_THREADS, 0, (cudaStream_t)stream>>>(
            *sc, *hp, state, prev, table, table_cols, aux, idx_out, rec_out, counts, R);
    return (int)cudaGetLastError();
}

extern "C" int zrc_shade(const ZrcScene* sc, const float* state_in,
                         const float* aux, const float* rec, int bounce,
                         float* state_out, int R, int device, void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + kThreads - 1) / kThreads;
    shade_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *sc, state_in, aux, rec, bounce, state_out, R);
    return (int)cudaGetLastError();
}

extern "C" int zrc_texel_fetch(const ZrcScene* sc, const ZrcTexture* tx,
                               const int* base, const bool* demand, float* out,
                               int B, int device, void* stream) {
    if (B <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (B + kThreads - 1) / kThreads;
    texel_fetch_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *sc, *tx, base, demand, out, B);
    return (int)cudaGetLastError();
}

extern "C" int zrc_sort_key(const float* state, const float* par, int* key, int R,
                            int device, void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + kThreads - 1) / kThreads;
    sort_key_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(state, par, key, R);
    return (int)cudaGetLastError();
}

extern "C" int zrc_ray_sort_key(const float* state, const float* bbox_min,
                                const float* bbox_max, int* key, int R, int device,
                                void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int threads = R / kSortKeyLanes;
    int blocks = (threads + kThreads - 1) / kThreads;
    ray_sort_key_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        state, bbox_min, bbox_max, key, R);
    return (int)cudaGetLastError();
}

// Blocks of grid_walk_kernel<kShade> to launch for R rays on ``device``:
// about as many as the card holds at once (its occupancy, read once a
// device and instantiation).
template <bool kShade>
static cudaError_t grid_blocks(int R, int device, int* blocks) {
    static int resident[64];  // blocks the card holds at once, by device (0: not read)
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (resident[device] == 0) {
        int sms = 0, per_sm = 0;
        cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_walk_kernel<kShade>,
                                                            GRID_THREADS, 0);
        if (err != cudaSuccess) return err;
        resident[device] = sms * (per_sm > 0 ? per_sm : 1);
    }
    *blocks = min((R + GRID_THREADS - 1) / GRID_THREADS, resident[device]);
    return cudaSuccess;
}

// iterations must hold two zeros (the loop's count, the ray counter) before
// the launch; it_sum is null (zrc_discard) or one uint64 that the rays'
// iterations are added to.
extern "C" int zrc_grid_walk(const ZrcGrid* g, const float* orig, const float* dir,
                             const bool* active, const long long* exclude, float* t,
                             float* u, float* v, long long* idx, int* iterations,
                             unsigned long long* it_sum, int R, int device,
                             void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = counts_or_discard(&it_sum);
    int blocks = 0;
    if (err == cudaSuccess) err = grid_blocks<false>(R, device, &blocks);
    if (err != cudaSuccess) return (int)err;
    grid_walk_kernel<false><<<blocks, GRID_THREADS, 0, (cudaStream_t)stream>>>(
        *g, orig, dir, active, exclude, t, u, v, idx, iterations, it_sum, R, ZrcGridWave{});
    return (int)cudaGetLastError();
}

// Launch ``bounce`` of a shaded wave of B = ``bounces`` bounces (0..B: B
// launches in turn make the wave): ``w`` holds the wave's state (its
// ``bounce``, ``walk`` and ``alive`` are set here), t, u, v and idx the
// hits, iterations two zeros; ``counts`` is null (zrc_discard) or the
// wave's four uint64 work counters (rays alive, tiles, boxes, walk
// iterations), of which the launch adds to the first and the last.
extern "C" int zrc_grid_walk_shaded(const ZrcGrid* g, const ZrcGridWave* w, float* t, float* u,
                                    float* v, long long* idx, int* iterations,
                                    unsigned long long* counts, int bounce, int bounces, int R,
                                    int device, void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    if (bounce < 0 || bounce > bounces) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = counts_or_discard(&counts);
    int blocks = 0;
    if (err == cudaSuccess) err = grid_blocks<true>(R, device, &blocks);
    if (err != cudaSuccess) return (int)err;
    ZrcGridWave wave = *w;
    wave.bounce = bounce;
    wave.walk = bounce < bounces;
    wave.alive = counts;
    grid_walk_kernel<true><<<blocks, GRID_THREADS, 0, (cudaStream_t)stream>>>(
        *g, nullptr, nullptr, nullptr, nullptr, t, u, v, idx, iterations, counts + 3, R, wave);
    return (int)cudaGetLastError();
}

// Launch one of the 2B launches of the bake's shaded wave
// (wavefront.render_wave_shaded_trace): bounce ``bounce``'s nearest launch
// (``shadow`` 0) or its shadow launch (1), of trace_stream_kernel when the
// heap has group boxes, else of trace_emit_kernel, TRACE_THREADS threads a
// block.  ``w`` holds the wave's state, its bounce and its ``counts``:
// null (zrc_discard) or the wave's eight uint64 work counters
// (wavefront.WORK_COUNTERS).
extern "C" int zrc_trace_shaded(const ZrcScene* sc, const ZrcHeap* hp, const ZrcTraceWave* w,
                                int shadow, int R, int device, void* stream) {
    if (R <= 0) return ZRC_NOTHING_LAUNCHED;
    if (hp->p2 < 1 || hp->p2 > (1 << TREE_STACK) || (hp->gbox && hp->group_tiles < 1) ||
        w->bounce < 0)
        return (int)cudaErrorInvalidValue;
    ZrcTraceWave wave = *w;
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = counts_or_discard(&wave.counts);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (R + TRACE_THREADS - 1) / TRACE_THREADS;
    const cudaStream_t s = (cudaStream_t)stream;
    if (hp->gbox && shadow)
        trace_stream_kernel<TRACE_SHADOW><<<blocks, TRACE_THREADS, 0, s>>>(*sc, *hp, wave, R);
    else if (hp->gbox)
        trace_stream_kernel<TRACE_NEAREST><<<blocks, TRACE_THREADS, 0, s>>>(*sc, *hp, wave, R);
    else if (shadow)
        trace_emit_kernel<TRACE_SHADOW><<<blocks, TRACE_THREADS, 0, s>>>(*sc, *hp, wave, R);
    else
        trace_emit_kernel<TRACE_NEAREST><<<blocks, TRACE_THREADS, 0, s>>>(*sc, *hp, wave, R);
    return (int)cudaGetLastError();
}

// An empty kernel, one block of one thread: what a launch through this
// interface costs the card when nothing runs (the launch floor the probes'
// times are read against).
__global__ void empty_kernel() {}

extern "C" int zrc_empty(int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* zrc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
