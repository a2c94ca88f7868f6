// Whole-path CUDA kernels for Hopper (sm_90a): ray generation, nearest hit,
// shading and the beam-sort key, one thread per ray.
//
// Replaces the two whole-path Pallas kernels of the JAX package:
//   path_trace_gen_kernel  <- zig_raytracing_contest_tpu/render/fused.py:1031
//                             path_trace_gen (_make_path_kernel_gen :981)
//   path_trace_kernel      <- zig_raytracing_contest_tpu/render/fused.py:1111
//                             path_trace_fused (_make_path_kernel :727)
// with the shared device functions
//   gen_ray        <- fused._gen_rays (:844)
//   trace_nearest  <- mxu_intersect._trace_body_resident (:1027), flat tile
//                     loop with _cull_any (:782) and _tile_update (:443)
//   shade_bounce   <- fused._shade1_body (:595): _prep_math (:110, non-tiled)
//                     and _shade_live (:245)
//   emit_sort_key  <- fused._emit_sort_key (:915)
//
// What bounds it on this card: the trace, ~40 f32 operations per ray per
// triangle of every tile whose box the ray's slab test passes; the state
// (16 floats in, 16 out per ray) is a few bytes per operation.  Triangles,
// tile boxes and the texel bank are read-only and shared by all rays, so
// they stay in L1/L2 (the official scene has 1024 padded triangles of 64 B).
// Design: one thread per ray with its state in registers, looping over its
// bounces and stopping when it dies, so dead rays cost nothing.  The TPU
// kernel's one-hot matmuls become direct loads: the winner's 24-float
// record is read once after the tile loop (a miss reads zeros), texels are
// float4 loads from the row-major (P, 4) bank.  No shared-memory staging,
// wgmma or TMA yet.
//
// Parity with the PyTorch twins (render/fused.py): every a*b+c is rounded
// twice, as PyTorch's separate elementwise ops round it; the library builds
// this file with --fmad=false for that.  Min/max that the twin takes with
// torch.minimum/maximum propagate NaN here too (nan_min/nan_max).  Ties:
// the triangle loop runs in ascending Morton index and replaces the best hit
// only on a strictly smaller t, which is the lexicographic minimum of
// (t, index) that the JAX kernels compute per tile and across tiles.

#include <cuda_runtime.h>
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

// ------------------------------------------------------- trace_nearest

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

// Nearest front-facing hit over the flat tile loop, in the transform form
// (mxu_intersect._intersect_tile), skipping Morton index ``prev`` (-1: none).
__device__ Hit trace_nearest(const ZrcScene& sc, const float o[3],
                             const float d[3], int prev) {
    float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
    Hit h = {INFINITY, 0.0f, 0.0f, 0};
    for (int j = 0; j < sc.nt; ++j) {
        if (!tile_passes(sc.tile_bbox, sc.nt, j, o, inv, h.t)) continue;
        int s = j * sc.tile;
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
            float t = -ow / dw;
            float u = ou + t * du;
            float v = ov + t * dv;
            float det = -dw * n_sq;
            bool ok = (det >= MT_EPSILON) && (u >= 0.0f) && (v >= 0.0f) &&
                      (u + v <= 1.0f) && (t > 0.0f) && (gi != prev);
            if (ok && t < h.t) {
                h.t = t;
                h.u = u;
                h.v = v;
                h.idx = gi;
            }
        }
    }
    return h;
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

// One bounce of shading for a live ray that traced ``h`` (_shade_live).
__device__ void shade_bounce(const ZrcScene& sc, float s[S_ROWS], const Hit& h,
                             int bounce) {
    bool missed = !(h.t < INFINITY);
    float dy = s[S_DX + 1];
    if (missed) {
        // sky (src/stage3.zig:144-150); the ray dies
        float sky_t = 0.5f * (dy + 1.0f);
        s[S_RR + 0] = s[S_RR + 0] + s[S_TR + 0] * (1.0f - 0.5f * sky_t);
        s[S_RR + 1] = s[S_RR + 1] + s[S_TR + 1] * (1.0f - 0.3f * sky_t);
        s[S_RR + 2] = s[S_RR + 2] + s[S_TR + 2];
        s[S_ALIVE] = 0.0f;
        s[S_SEG] = s[S_SEG] + 1.0f;
        s[S_KEY] = 0.0f;
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
    float u = h.u, v = h.v;
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
    float t_step = h.t + FLT_EPS;
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

// Bounces [bounce0, bounce0 + n) of one ray.  ``prev`` is excluded at the
// first bounce (-1: none); each later bounce excludes the one before.
// Returns the last traced winner (``idx`` if the ray never traced).
__device__ int run_bounces(const ZrcScene& sc, float s[S_ROWS], int bounce0,
                           int n, int prev, int idx) {
    for (int b = bounce0; b < bounce0 + n; ++b) {
        if (!(s[S_ALIVE] > 0.0f)) break;
        float o[3] = {s[S_OX], s[S_OX + 1], s[S_OX + 2]};
        float d[3] = {s[S_DX], s[S_DX + 1], s[S_DX + 2]};
        Hit h = trace_nearest(sc, o, d, prev);
        shade_bounce(sc, s, h, b);
        idx = h.idx;
        prev = idx;
    }
    return idx;
}

__global__ void path_trace_gen_kernel(ZrcScene sc, ZrcGen g, int max_bounce,
                                      int emit_key, float* __restrict__ state_out,
                                      int* __restrict__ idx_out, int R) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    float s[S_ROWS];
    gen_ray(g, i, s);
    int idx = run_bounces(sc, s, 0, max_bounce, -1, 0);
    if (emit_key) s[S_KEY] = __int_as_float(emit_sort_key(g.par, s));
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) state_out[(size_t)f * R + i] = s[f];
    if (idx_out) idx_out[i] = idx;
}

__global__ void path_trace_kernel(ZrcScene sc, const float* __restrict__ state_in,
                                  const int* __restrict__ prev, int bounce0,
                                  int max_bounce, float* __restrict__ state_out,
                                  int* __restrict__ idx_out, int R) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    float s[S_ROWS];
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) s[f] = state_in[(size_t)f * R + i];
    int p = prev ? prev[i] : -1;
    int idx = run_bounces(sc, s, bounce0, max_bounce, p, prev ? p : 0);
#pragma unroll
    for (int f = 0; f < S_ROWS; ++f) state_out[(size_t)f * R + i] = s[f];
    if (idx_out) idx_out[i] = idx;
}

// ------------------------------------------------------------ launchers
// Plain C entry points for ctypes (kernels/__init__.py).  They launch on
// the caller's stream, allocate nothing, and return cudaGetLastError().

static const int kThreads = 128;

extern "C" int zrc_path_trace_gen(const ZrcScene* sc, const ZrcGen* g,
                                  int max_bounce, int emit_key, float* state_out,
                                  int* idx_out, int R, int device, void* stream) {
    if (R <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + kThreads - 1) / kThreads;
    path_trace_gen_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *sc, *g, max_bounce, emit_key, state_out, idx_out, R);
    return (int)cudaGetLastError();
}

extern "C" int zrc_path_trace(const ZrcScene* sc, const float* state_in,
                              const int* prev, int bounce0, int max_bounce,
                              float* state_out, int* idx_out, int R, int device,
                              void* stream) {
    if (R <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + kThreads - 1) / kThreads;
    path_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *sc, state_in, prev, bounce0, max_bounce, state_out, idx_out, R);
    return (int)cudaGetLastError();
}

extern "C" const char* zrc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
