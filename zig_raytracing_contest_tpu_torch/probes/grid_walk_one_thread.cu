// grid_walk_kernel as the renderer ran it at commit 8108396: one thread
// walks one ray to its end, and every DDA step waits on the gathered
// 8-byte range of the cell it enters, empty or not.  A probe fixture: the
// design the walk of kernels/path_trace.cu is timed against in one call on
// one card (probes/grid_walk.py, chip_smoke.py phase k), through the same
// C entry point zrc_grid_walk, with iterations[0] the loop's iteration
// count.  It reads ZrcGrid as path_trace.cu lays it out; a change to that
// layout, or the walk's next redesign, retires this file (and phase k's
// timing of it) rather than carrying it along.  Build it with the
// renderer's flags (kernels.NVCC_FLAGS: --fmad=false).

#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu
#define MT_EPSILON 1e-8f

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

#define GRID_TRI_BATCH 4
#define GRID_THREADS 128

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

__global__ void __launch_bounds__(GRID_THREADS) grid_walk_kernel(
        ZrcGrid g, const float* __restrict__ orig, const float* __restrict__ dir,
        const bool* __restrict__ active, const long long* __restrict__ exclude,
        float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
        long long* __restrict__ idx_out, int* __restrict__ iterations, int R) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    int it = 0;  // this lane's iterations (0: no walk)
    if (i < R) {
        float o[3], d[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            o[a] = orig[3 * (size_t)i + a];
            d[a] = dir[3 * (size_t)i + a];
        }
        float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
        int best_i = 0;
        // linalg.ray_bbox_intersection: narrowing y then z
        bool sign[3];
        float near_[3], far_[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            sign[a] = d[a] < 0.0f;
            near_[a] = ((sign[a] ? g.bmax[a] : g.bmin[a]) - o[a]) / d[a];
            far_[a] = ((sign[a] ? g.bmin[a] : g.bmax[a]) - o[a]) / d[a];
        }
        float tmin = near_[0], tmax = far_[0];
        bool miss = tmin > far_[1] || tmax < near_[1];
        tmin = nan_max(tmin, near_[1]);
        tmax = nan_min(tmax, far_[1]);
        miss = miss || tmin > far_[2] || tmax < near_[2];
        tmin = nan_max(tmin, near_[2]);
        if (!miss && active[i]) {
            // dda.dda_setup
            const float t_entry = nan_max(tmin, 0.0f);
            int cell[3], stp[3], ext[3];
            float t_delta[3], t_next[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                stp[a] = sign[a] ? -1 : 1;
                ext[a] = sign[a] ? 0 : g.res[a] - 1;
                t_delta[a] = fabsf(g.cell[a] / d[a]);
                float hit_local = (o[a] + d[a] * t_entry) - g.bmin[a];
                long long c = (long long)(hit_local / g.cell[a]);
                c = c < 0 ? 0 : c;
                c = c < g.res[a] - 1 ? c : g.res[a] - 1;
                cell[a] = (int)c;
                float next_cell = (float)(cell[a] + (sign[a] ? 0 : 1));
                t_next[a] = t_entry + (next_cell * g.cell[a] - hit_local) / d[a];
            }
            int2 range = g.cells[grid_cell_lin(g, cell)];
            int cursor = range.x, end = range.y;
            const bool has_ex = exclude != nullptr;
            const long long ex = has_ex ? exclude[i] : 0;
            for (;;) {
                ++it;
                // triangle phase: up to GRID_TRI_BATCH references in order
#pragma unroll
                for (int j = 0; j < GRID_TRI_BATCH; ++j) {
                    if (cursor < end) {
                        const float4* row = g.tri + 3 * (size_t)cursor;
                        float4 ra = row[0], rb = row[1], rc = row[2];
                        float t, u, v;
                        bool ok = mt_hit(o, d, ra, rb, rc, t, u, v) && t > 0.0f;
                        if (has_ex) ok = ok && (long long)__float_as_int(rc.y) != ex;
                        if (ok && t < best_t) {
                            best_t = t;
                            best_u = u;
                            best_v = v;
                            best_i = cursor;
                        }
                        ++cursor;
                    }
                }
                if (cursor < end) continue;
                // cell-advance phase: dda.dda_next on the smallest crossing
                const float t0 = t_next[0], t1 = t_next[1], t2 = t_next[2];
                const int k = (t0 < t1 ? 4 : 0) + (t0 < t2 ? 2 : 0) + (t1 < t2 ? 1 : 0);
                const int axis = (0xa66 >> (2 * k)) & 3;  // {2,1,2,1,2,2,0,0}
                bool at_exit = false;
                float t_cross = 0.0f;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    if (a == axis) {
                        at_exit = cell[a] == ext[a];
                        t_cross = at_exit ? INFINITY : t_next[a];
                        if (!at_exit) {
                            cell[a] += stp[a];
                            t_next[a] = t_next[a] + t_delta[a];
                        }
                    }
                }
                if (best_t <= t_cross) break;
                range = g.cells[grid_cell_lin(g, cell)];
                cursor = range.x;
                end = range.y;
            }
        }
        t_out[i] = best_t;
        u_out[i] = best_u;
        v_out[i] = best_v;
        idx_out[i] = best_i;
    }
    const int warp_max = __reduce_max_sync(FULL_MASK, it);
    if ((threadIdx.x & 31) == 0 && warp_max > 0) atomicMax(iterations, warp_max);
}

extern "C" int zrc_grid_walk(const ZrcGrid* g, const float* orig, const float* dir,
                             const bool* active, const long long* exclude, float* t,
                             float* u, float* v, long long* idx, int* iterations, int R,
                             int device, void* stream) {
    if (R <= 0) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (R + GRID_THREADS - 1) / GRID_THREADS;
    grid_walk_kernel<<<blocks, GRID_THREADS, 0, (cudaStream_t)stream>>>(
        *g, orig, dir, active, exclude, t, u, v, idx, iterations, R);
    return (int)cudaGetLastError();
}

extern "C" const char* zrc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
