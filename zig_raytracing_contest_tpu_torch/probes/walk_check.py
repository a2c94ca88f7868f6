"""The per-bounce trace's tile-heap walk against the flat tile loop, lane by lane.

``trace_emit_kernel`` (kernels/path_trace.cu, ``advance_walk`` with
``warp_sweep``) finds each ray's nearest hit by a per-ray walk of the tile
heap, nearest child first;
its plain twin ``mxu_intersect.nearest_hit_ref`` sweeps the tiles in
ascending order.  Both cull a tile whose box the ray enters at or behind
the running best t, so they visit tiles in different orders and must still
find the same nearest t; where two triangles are hit at that same t, the
walk keeps the first it swept and the flat loop the lower index (the tie
rule of ROADMAP.md's parity rules).

``differing_lanes`` runs both on one state and, for every lane whose t or
winner differs, recomputes both winners alone with ``triangle_hit_ref``:
a lane where both are hit at one t is a tie; any other is a fault of the
walk.  ``walk_heap_ref`` repeats the kernel's walk for one ray in NumPy
float32 (each operation rounded once, as the kernel, built with
``--fmad=false``, rounds it) and lists the tiles it sweeps with the best t
at each, which shows how a differing lane arose; it also repeats
``trace_stream_kernel``'s walk of the group heap, and ``walk_lanes`` /
``lanes_off_walk`` hold either kernel to it bit for bit (chip_smoke.py).
``warp_sweep_ref`` models the kernels' split of a tile over a warp, and
``flat_warp_ref`` the whole-path kernels' flat loop of one warp (each tile
swept lane-parallel or by the warp, by how many lanes pass it);
``flat_occupancy`` reads from it how busy that loop keeps a warp's lanes.

The wave is the whole-path frame's bounce-0 wave of 522,240 rays from pixel
tile 920 (1920x1080, 3 spp, 32x32 tiled slot order) and its bounce-1 wave
(``path_trace_gen``'s output sorted on its key, with the previous hit).
``run_checks`` takes the terrain of side 90 (``large_scene(side=90)``, 127
tiles of 128); ``--all`` adds the Duck-class GLB at details 0.5, 1.0, 1.4
and 1.85 and the terrains of sides 60 and 126 (21 to 249 tiles).  Run on
the card:

    python -m zig_raytracing_contest_tpu_torch.probes.walk_check [--all]

(``--device cpu`` runs the twin against itself on a 4096-ray slice.)
"""

from __future__ import annotations

import argparse
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..ops import mxu_intersect as mi
from ..render import fused
from ..render.pipeline import prepare_scene, slot_geometry
from ..render.wavefront import build_gen_par, sort_state_payload

SPP, WAVE, SEED = 3, 1 << 19, 0
BASE_SLOT = 1024 * 920
TERRAIN_SIDE = 90
ALL_SCENES = (("terrain", 90), ("duck", 0.5), ("duck", 1.0), ("duck", 1.4),
              ("duck", 1.85), ("terrain", 60), ("terrain", 126))
CPU_RAYS = 4096  # the wave's first lanes on the CPU (the twin is slow there)


def scene_path(kind: str, size, tmp: Path) -> tuple[str, dict]:
    """(path, prepare_scene keywords) of one scene at 1920x1080."""
    if kind == "terrain":
        from ..scene.procedural import large_scene

        path = large_scene(tmp / f"terrain_{size}.gltf", side=int(size))
        return str(path), {"camera_name": "Camera 1", "width": 1920, "height": 1080}
    from ..scene.duck import write_duck_glb

    path = write_duck_glb(tmp / f"duck_{size}.glb", tex_size=512, detail=size)
    return str(path), {"height": 1080}


def load(kind: str, size, tmp: Path, device):
    """(scene, camera) of one scene on ``device``."""
    path, kw = scene_path(kind, size, tmp)
    cfg = Config(grid_resolution=(8, 8, 8), num_samples=SPP, max_bounce=4,
                 wave_size=WAVE, seed=SEED)
    scene, cam, _ = prepare_scene(path, cfg, device=device, **kw)
    return scene, cam


def wave_rays(rays: int | None = None) -> int:
    """Rays of the whole-path frame's full wave (or ``rays``)."""
    return rays or WAVE // (SPP * 1024) * (SPP * 1024)


def bounce0_state(scene, cam, rays: int | None = None):
    """(state, (par, meta, gen)): the first ``rays`` lanes (default all) of
    the bounce-0 wave from pixel tile 920, as path_trace_gen makes them,
    and the generator's arguments."""
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    _, tiles_x = slot_geometry(cam.width, cam.height, True)
    gen = fused.GenParams(spp=SPP, width=cam.width, img_w=cam.width, img_h=cam.height,
                          tiles_x=tiles_x)
    meta = (BASE_SLOT, BASE_SLOT % cam.width, BASE_SLOT // cam.width, SEED,
            BASE_SLOT // 1024, 0, 0, 0)
    return fused.gen_rays_ref(par, meta, wave_rays(rays), gen), (par, meta, gen)


def bounce1_state(scene, cam, rays: int | None = None):
    """(state, prev) of the bounce-1 wave: path_trace_gen's bounce 0 sorted
    on its key, with each ray's winner as the previous hit."""
    _, (par, meta, gen) = bounce0_state(scene, cam, rays)
    st, idx = fused.path_trace_gen(scene, par, meta, wave_rays(rays), 1, gen,
                                   emit_key=True, emit_idx=True)
    _, st1, (prev,) = sort_state_payload(st[15].contiguous().view(torch.int32), st, (idx,))
    return st1, prev


def differing_lanes(scene, state: torch.Tensor, prev: torch.Tensor | None = None) -> dict:
    """The walk (``trace_emit_aux``: trace_emit_kernel on a CUDA scene)
    against the flat loop (``nearest_hit_ref``) on ``state``: the live rays
    and, per lane whose t or winner differs, both (t, idx) pairs and both
    winners recomputed alone (hit, t)."""
    aux, idx, _ = mi.trace_emit_aux(scene, state, None, prev)
    live = state[12] > 0
    t_f, i_f, _, _, _ = mi.nearest_hit_ref(
        scene.tri_data, scene.tile_bbox, scene.tile, state[0:3], state[3:6], live,
        None if prev is None else prev.long())
    t_w, i_w = aux[2], idx.long()
    lanes = ((t_w != t_f) | (i_w != i_f)).nonzero()[:, 0]
    rows = []
    if lanes.numel():
        o, d = state[0:3, lanes], state[3:6, lanes]
        hw, tw, _, _ = mi.triangle_hit_ref(scene.tri_data, o, d, i_w[lanes])
        hf, tf, _, _ = mi.triangle_hit_ref(scene.tri_data, o, d, i_f[lanes])
        for k, lane in enumerate(lanes.tolist()):
            rows.append({
                "lane": lane,
                "walk": (float(t_w[lane]), int(i_w[lane])),
                "flat": (float(t_f[lane]), int(i_f[lane])),
                "walk_winner_alone": (bool(hw[k]), float(tw[k])),
                "flat_winner_alone": (bool(hf[k]), float(tf[k])),
                "tie": bool(hw[k] and hf[k] and tw[k] == tf[k] and t_w[lane] == t_f[lane]),
                "ray": [float(x) for x in state[0:6, lane].tolist()],
            })
    return {"rays": state.shape[1], "live": int(live.sum()), "lanes": rows}


def _nan_min(a, b):
    return np.float32(np.nan) if (a != a or b != b) else min(a, b)


def _nan_max(a, b):
    return np.float32(np.nan) if (a != a or b != b) else max(a, b)


def _slab(box, o, inv):
    """(tmin, tmax) of the kernel's slab test of the (6,) ``box``."""
    t1 = [(box[a] - o[a]) * inv[a] for a in range(3)]
    t2 = [(box[3 + a] - o[a]) * inv[a] for a in range(3)]
    tmin = _nan_max(_nan_max(_nan_min(t1[0], t2[0]), _nan_min(t1[1], t2[1])),
                    _nan_min(t1[2], t2[2]))
    tmax = _nan_min(_nan_min(_nan_max(t1[0], t2[0]), _nan_max(t1[1], t2[1])),
                    _nan_max(t1[2], t2[2]))
    return tmin, tmax


def _transform(tri_data: np.ndarray, lo: int, hi: int, o, d, prev: int):
    """(ok, t, u, v) of triangles lo .. hi - 1 for one ray, with the
    kernel's arithmetic (sweep_tile) in NumPy float32."""
    f32 = np.float32
    m = tri_data[:13, lo:hi].astype(f32)
    with np.errstate(all="ignore"):
        ou = m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[9]
        ov = m[3] * o[0] + m[4] * o[1] + m[5] * o[2] + m[10]
        ow = m[6] * o[0] + m[7] * o[1] + m[8] * o[2] + m[11]
        du = m[0] * d[0] + m[1] * d[1] + m[2] * d[2]
        dv = m[3] * d[0] + m[4] * d[1] + m[5] * d[2]
        dw = m[6] * d[0] + m[7] * d[1] + m[8] * d[2]
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        ok = ((-dw * m[12] >= f32(mi.MT_EPSILON)) & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t > 0))
    ok &= np.arange(lo, hi) != prev
    return ok, t, u, v


def sweep_tile_ref(tri_data: np.ndarray, tile: int, j: int, o, d, prev: int,
                   best: dict) -> None:
    """``sweep_tile``: tile j's triangles in ascending index, each hit
    replacing ``best`` (t, idx, u, v) only on a strictly smaller t."""
    ok, t, u, v = _transform(tri_data, j * tile, (j + 1) * tile, o, d, prev)
    for k in np.nonzero(ok)[0]:
        if t[k] < best["t"]:
            best.update(t=t[k], idx=j * tile + int(k), u=u[k], v=v[k])


def warp_sweep_ref(tri_data: np.ndarray, tile: int, j: int, o, d, prev: int,
                   best: dict) -> None:
    """``warp_sweep``: the same tile split over 32 lanes (lane l takes
    triangles l, l + 32, ... in ascending order, keeping the first at its
    smallest t), then the warp's two min reductions (the smallest t bits
    over the lanes, then the lowest index among the lanes at that t); the
    winner replaces ``best`` only on a strictly smaller t."""
    ok, t, u, v = _transform(tri_data, j * tile, (j + 1) * tile, o, d, prev)
    lane_best = []
    for lane in range(32):
        bt, bi, bu, bv = np.float32(np.inf), 0, np.float32(0), np.float32(0)
        for k in range(lane, tile, 32):
            if ok[k] and t[k] < bt:
                bt, bi, bu, bv = t[k], j * tile + k, u[k], v[k]
        lane_best.append((bt, bi, bu, bv))
    if not any(bt < best["t"] for bt, _, _, _ in lane_best):
        return
    bits = [int(np.float32(bt).view(np.uint32)) for bt, _, _, _ in lane_best]
    t_min = min(bits)
    i_min = min(lane_best[lane][1] if bits[lane] == t_min else 2**31 - 1
                for lane in range(32))
    (src,) = [lane for lane in range(32)
              if bits[lane] == t_min and lane_best[lane][1] == i_min]
    bt, bi, bu, bv = lane_best[src]
    best.update(t=bt, idx=bi, u=bu, v=bv)


# What flat_occupancy prices a warp sweep at, in lane-loop triangle
# iterations beyond its tile/32 tests a lane: the two min reductions, the
# shuffles of the asking ray and the any-vote (path_trace.cu warp_sweep).
WARP_SWEEP_EXTRA = 2


def lane_loop_min() -> int:
    """The LANE_LOOP_MIN of kernels/path_trace.cu (its #define)."""
    from .. import kernels

    src = kernels.SOURCES["path_trace"].read_text()
    (value,) = re.findall(r"^#define LANE_LOOP_MIN (\d+)$", src, re.M)
    return int(value)


def flat_warp_ref(tri_data: np.ndarray, tile_bbox: np.ndarray, tile: int, o, d,
                  live, prev, lane_loop_min: int) -> dict:
    """The flat tile loop of one warp (kernels/path_trace.cu
    ``trace_nearest_warp``) in NumPy float32: ``o``, ``d`` (3, n) and
    ``live`` (n,), ``prev`` (n,) (-1: none) for the warp's n <= 32 lanes
    (a short warp's missing lanes have no ray).  Tiles in ascending order:
    each live lane culls tile j against its own best (the kernel's slab
    test), then, when at least ``lane_loop_min`` lanes pass, each passing
    lane sweeps it (``sweep_tile_ref``), else the warp sweeps it once for
    each passing lane in ascending lane order (``warp_sweep_ref``).
    Returns per lane t, u, v (f32), idx and ``passed`` (tiles it passed,
    int), and per warp ``pops`` (the passing lanes of each tile that any
    lane passed), ``lane_tiles`` (tiles swept lane-parallel) and
    ``warp_sweeps`` (warp sweeps run)."""
    f32 = np.float32
    o = np.asarray(o, f32)
    d = np.asarray(d, f32)
    live = np.asarray(live, bool)
    n = live.shape[0]
    if n > 32:
        raise ValueError(f"a warp has at most 32 lanes, not {n}")
    with np.errstate(all="ignore"):
        inv = f32(1.0) / d
    best = [{"t": f32(np.inf), "idx": 0, "u": f32(0), "v": f32(0)} for _ in range(n)]
    passed = np.zeros(n, np.int64)
    pops, lane_tiles, warp_sweeps = [], 0, 0
    for j in range(tile_bbox.shape[1]):
        box = tile_bbox[:, j].astype(f32)
        bt = np.array([b["t"] for b in best], f32)
        with np.errstate(all="ignore"):
            t1 = [(box[a] - o[a]) * inv[a] for a in range(3)]
            t2 = [(box[3 + a] - o[a]) * inv[a] for a in range(3)]
            # np.minimum / np.maximum propagate NaN as nan_min / nan_max do
            lo = [np.minimum(t1[a], t2[a]) for a in range(3)]
            hi = [np.maximum(t1[a], t2[a]) for a in range(3)]
            tmin = np.maximum(np.maximum(lo[0], lo[1]), lo[2])
            tmax = np.minimum(np.minimum(hi[0], hi[1]), hi[2])
            mine = live & ~((tmin > tmax) | (tmax <= 0) | (tmin >= bt))
        lanes = np.nonzero(mine)[0]
        if not lanes.size:
            continue
        passed += mine
        pops.append(int(lanes.size))
        if lanes.size >= lane_loop_min:
            lane_tiles += 1
            sweep = sweep_tile_ref
        else:
            warp_sweeps += int(lanes.size)
            sweep = warp_sweep_ref
        for k in lanes:
            sweep(tri_data, tile, j, o[:, k], d[:, k], int(prev[k]), best[k])
    return {"t": np.array([b["t"] for b in best], f32),
            "u": np.array([b["u"] for b in best], f32),
            "v": np.array([b["v"] for b in best], f32),
            "idx": np.array([b["idx"] for b in best], np.int64),
            "passed": passed, "pops": pops, "lane_tiles": lane_tiles,
            "warp_sweeps": warp_sweeps}


def flat_warps(scene, state: torch.Tensor, prev: torch.Tensor | None, warps,
               lane_loop_min: int) -> dict:
    """``flat_warp_ref`` on each warp w of ``warps`` of a (16, R) ``state``
    (lanes 32w .. 32w + 31, fewer in a short last warp; ``prev`` (R,) or
    None): the lanes, per lane t, u, v, idx, passed as NumPy arrays (what a
    whole-path trace gives them), and the warps' pops, lane_tiles and
    warp_sweeps summed (pops concatenated)."""
    tri = scene.tri_data.cpu().numpy()
    bb = scene.tile_bbox.cpu().numpy()
    R = state.shape[1]
    lanes = [ln for w in warps for ln in range(32 * int(w), min(32 * int(w) + 32, R))]
    st = state[:, lanes].cpu().numpy()
    pv = np.full(len(lanes), -1) if prev is None else prev[lanes].cpu().numpy()
    out = {k: [] for k in ("t", "u", "v", "idx", "passed", "pops")}
    out.update(lane_tiles=0, warp_sweeps=0)
    at = 0
    for w in warps:
        n = min(32 * int(w) + 32, R) - 32 * int(w)
        sl = slice(at, at + n)
        at += n
        res = flat_warp_ref(tri, bb, scene.tile, st[0:3, sl], st[3:6, sl], st[12, sl] > 0,
                            pv[sl], lane_loop_min)
        for k in ("t", "u", "v", "idx", "passed", "pops"):
            out[k].append(np.asarray(res[k]))
        out["lane_tiles"] += res["lane_tiles"]
        out["warp_sweeps"] += res["warp_sweeps"]
    for k in ("t", "u", "v", "idx", "passed", "pops"):
        out[k] = np.concatenate(out[k]) if out[k] else np.zeros(0)
    out["lanes"] = np.array(lanes, np.int64)
    return out


def flat_occupancy(scene, state: torch.Tensor, prev: torch.Tensor | None,
                   warps: int = 64, loop_min: int | None = None) -> dict:
    """How busy the whole-path trace keeps a warp's lanes on one wave:
    ``flat_warps`` on ``warps`` warps spread evenly over the (16, R)
    ``state``.  ``passed``: tiles passed per live ray; ``swept``: tiles a
    warp swept in the one-thread-per-ray loop (any lane passed); ``busy``:
    the share of lane-iterations of those sweeps that tested a passing
    lane's triangles (passed tiles over 32 x swept tiles); ``iters``:
    serial triangle iterations per warp, that loop's (swept x tile)
    against this loop's at ``loop_min`` (default the kernel's
    LANE_LOOP_MIN): each lane-parallel tile ``tile`` iterations, each warp
    sweep tile/32 + WARP_SWEEP_EXTRA; ``lane_tiles`` and ``warp_sweeps``:
    that loop's tiles swept lane-parallel and warp sweeps, summed over the
    warps (the whole-path kernels' counters of the same names).  Every way
    of sweeping gives the same bests, so the same culls: the replay runs
    the lane loop and prices the other from its passing-lane counts."""
    L = lane_loop_min() if loop_min is None else loop_min
    R = state.shape[1]
    nw = -(-R // 32)
    picks = sorted({int(k * nw // warps) for k in range(warps)})
    res = flat_warps(scene, state, prev, picks, 0)
    live = state[12, res["lanes"]].cpu().numpy() > 0
    pops = np.asarray(res["pops"], np.int64)
    tile, n = scene.tile, len(picks)
    lane_tiles = int((pops >= L).sum())
    warp_sweeps = int(pops[pops < L].sum())
    return {
        "warps": n, "lanes": len(res["lanes"]), "live": int(live.sum()),
        "passed": float(res["passed"][live].sum()) / max(int(live.sum()), 1),
        "swept": pops.size / n,
        "busy": float(pops.sum()) / max(32.0 * pops.size, 1.0),
        "iters": (pops.size * tile / n,
                  (lane_tiles * tile + warp_sweeps * (tile / 32 + WARP_SWEEP_EXTRA)) / n),
        "lane_loop_min": L, "lane_tiles": lane_tiles, "warp_sweeps": warp_sweeps,
    }


def walk_heap_ref(tri_data: np.ndarray, tile_bbox: np.ndarray, tree: np.ndarray,
                  tile: int, o, d, prev: int = -1, gbox: np.ndarray | None = None,
                  group_tiles: int = 0) -> dict:
    """The walk of trace_emit_kernel / trace_stream_kernel
    (kernels/path_trace.cu: ``advance_walk``, each tile swept by
    ``warp_sweep``) for one ray, in NumPy float32: the tile heap ``tree``
    (``gbox`` None: leaf p2 + j is tile j) or the group heap (leaf p2 + g is
    group g, box ``gbox[:, g]``, tiles g·group_tiles .. min((g + 1)·
    group_tiles, nt) - 1, each culled against the running best and swept
    in ascending order once the group's box passes).  Returns the nearest
    hit (t, idx, u, v), the tiles swept in order, each with the best t
    before its sweep, and ``tested``, the boxes tested as the kernel counts
    them (heap nodes, group re-culls, every real tile of a passing group)."""
    f32 = np.float32
    o = [f32(x) for x in o]
    d = [f32(x) for x in d]
    with np.errstate(all="ignore"):
        inv = [f32(1.0) / x for x in d]
    nt, p2 = tile_bbox.shape[1], tree.shape[1] // 2
    best = {"t": f32(np.inf), "idx": 0, "u": f32(0), "v": f32(0)}
    swept = []
    tested = 1

    def passes(box):
        with np.errstate(all="ignore"):
            tmin, tmax = _slab(box, o, inv)
        return not (tmin > tmax or tmax <= 0 or tmin >= best["t"]), tmin

    def entry(n):
        ok, tmin = passes(tree[:, n])
        if not ok:
            return f32(np.inf)
        return tmin if tmin >= 0 else f32(0)

    def sweep(j):
        swept.append((j, float(best["t"])))
        sweep_tile_ref(tri_data, tile, j, o, d, prev, best)

    stack = []
    node = 1 if entry(1) < np.inf else 0
    while node:
        if node >= p2:
            j = node - p2
            if gbox is None:
                if j < nt:
                    sweep(j)
            elif j < gbox.shape[1]:
                tested += 1
                if passes(gbox[:, j])[0]:
                    for jt in range(j * group_tiles, min((j + 1) * group_tiles, nt)):
                        tested += 1
                        if passes(tile_bbox[:, jt])[0]:
                            sweep(jt)
            node = 0
        else:
            c = 2 * node
            e0, e1 = entry(c), entry(c + 1)
            tested += 2
            if e0 < np.inf and e1 < np.inf:
                right_first = e1 < e0
                stack.append((c if right_first else c + 1, e0 if right_first else e1))
                node = c + 1 if right_first else c
            else:
                node = c if e0 < np.inf else (c + 1 if e1 < np.inf else 0)
        while node == 0 and stack:
            n, e = stack.pop()
            if e < best["t"]:
                node = n
    return {"t": float(best["t"]), "idx": best["idx"], "u": float(best["u"]),
            "v": float(best["v"]), "swept": swept, "tested": tested}


def walk_lanes(scene, state: torch.Tensor, prev: torch.Tensor | None, lanes,
               groups: bool) -> dict:
    """``walk_heap_ref`` on each lane of ``lanes`` of a (16, R) ``state``
    (``prev`` (R,) or None) over the scene's group heap (``groups``: as
    trace_stream_kernel) or tile heap (as trace_emit_kernel): (len(lanes),)
    NumPy arrays t, u, v (f32), idx, swept, tested (int), what aux rows 2,
    0, 1, rows 5-6 and idx of those kernels hold (a dead lane: t = +inf,
    the rest 0)."""
    tri = scene.tri_data.cpu().numpy()
    bb = scene.tile_bbox.cpu().numpy()
    if groups:
        tree = scene.group_tree_bbox.cpu().numpy()
        heap = {"gbox": scene.group_bbox.cpu().numpy(), "group_tiles": scene.group_tiles}
    else:
        tree, heap = scene.tree_bbox.cpu().numpy(), {}
    lanes = [int(x) for x in lanes]
    st = state[:, lanes].cpu().numpy()
    pv = [-1] * len(lanes) if prev is None else prev[lanes].cpu().tolist()
    out = {k: np.zeros(len(lanes), np.float32) for k in ("t", "u", "v")}
    out.update({k: np.zeros(len(lanes), np.int64) for k in ("idx", "swept", "tested")})
    out["t"][:] = np.inf
    for n in range(len(lanes)):
        if not st[12, n] > 0:
            continue
        w = walk_heap_ref(tri, bb, tree, scene.tile, st[0:3, n], st[3:6, n], int(pv[n]),
                          **heap)
        for k in ("t", "u", "v", "idx", "tested"):
            out[k][n] = w[k]
        out["swept"][n] = len(w["swept"])
    return out


def lanes_off_walk(aux: torch.Tensor, idx: torch.Tensor, want: dict, lanes) -> int:
    """Lanes of ``lanes`` where a trace kernel's aux rows 0-2 (bits), 5-6 or
    idx differ from ``walk_lanes``' ``want``."""
    lanes = torch.as_tensor([int(x) for x in lanes], dtype=torch.long)
    a = aux[:, lanes.to(aux.device)].cpu()
    got_bits = a[0:3].contiguous().view(torch.int32).numpy()
    want_bits = np.stack([want["u"], want["v"], want["t"]]).view(np.int32)
    off = (got_bits != want_bits).any(axis=0)
    off |= a[5].numpy() != want["swept"]
    off |= a[6].numpy() != want["tested"]
    off |= idx[lanes.to(idx.device)].cpu().numpy() != want["idx"]
    return int(off.sum())


def flat_tile_entries(tile_bbox: np.ndarray, o, d, tiles) -> dict:
    """The kernel's slab tmin of each tile in ``tiles`` for one ray."""
    f32 = np.float32
    o = [f32(x) for x in o]
    with np.errstate(all="ignore"):
        inv = [f32(1.0) / f32(x) for x in d]
        return {j: float(_slab(tile_bbox[:, j], o, inv)[0]) for j in tiles}


def explain(scene, row: dict, prev: int = -1) -> str:
    """How one differing lane arose: the walk's tiles in order with the
    best t before each, and the box entries of both winners' tiles."""
    tri = scene.tri_data.cpu().numpy()
    bb = scene.tile_bbox.cpu().numpy()
    tree = scene.tree_bbox.cpu().numpy()
    o, d = row["ray"][0:3], row["ray"][3:6]
    w = walk_heap_ref(tri, bb, tree, scene.tile, o, d, prev)
    tw, tf = row["walk"][1] // scene.tile, row["flat"][1] // scene.tile
    ent = flat_tile_entries(bb, o, d, sorted({tw, tf}))
    return (f"walk_heap_ref (t {w['t']!r}, idx {w['idx']}) swept "
            f"{[(j, t) for j, t in w['swept']]}; box entry of the walk's winner tile "
            f"{tw}: {ent[tw]!r}, of the flat winner's tile {tf}: {ent[tf]!r}")


def format_lane(row: dict) -> str:
    hw, tw = row["walk_winner_alone"]
    hf, tf = row["flat_winner_alone"]
    bits = " ".join(f"{np.float32(x).view(np.uint32):08x}" for x in row["ray"])
    return (f"lane {row['lane']}: walk (t {row['walk'][0]!r}, idx {row['walk'][1]}), "
            f"flat (t {row['flat'][0]!r}, idx {row['flat'][1]}); alone: walk winner hit "
            f"{hw} at {tw!r}, flat winner hit {hf} at {tf!r}; "
            f"{'a tie at equal t' if row['tie'] else 'NOT a tie'}; ray o, d bits {bits}")


def run_checks(device, scenes=(("terrain", TERRAIN_SIDE),), bounces=(0,),
               explain_lanes: bool = True) -> list:
    """Each (scene, bounce) wave on ``device``: a list of (label, result of
    ``differing_lanes``, explanation lines).  On the CPU the wave is cut to
    its first CPU_RAYS lanes."""
    device = torch.device(device)
    rays = CPU_RAYS if device.type == "cpu" else None
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for kind, size in scenes:
            scene, cam = load(kind, size, Path(tmp), device)
            for bounce in bounces:
                if bounce == 0:
                    state, prev = bounce0_state(scene, cam, rays)[0], None
                else:
                    state, prev = bounce1_state(scene, cam, rays)
                res = differing_lanes(scene, state, prev)
                notes = []
                if explain_lanes:
                    for row in res["lanes"]:
                        p = -1 if prev is None else int(prev[row["lane"]])
                        notes.append(explain(scene, row, p))
                label = (f"{kind} {size} ({scene.tile_bbox.shape[1]} tiles), bounce "
                         f"{bounce}")
                out.append((label, res, notes))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--all", action="store_true",
                   help="all seven whole-path scenes, bounces 0 and 1")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: PyTorch sees no CUDA card; pass --device cpu")
    scenes = ALL_SCENES if args.all else (("terrain", TERRAIN_SIDE),)
    faults = 0
    for label, res, notes in run_checks(args.device, scenes, (0, 1) if args.all else (0,)):
        n_tie = sum(r["tie"] for r in res["lanes"])
        n_bad = len(res["lanes"]) - n_tie
        faults += n_bad
        print(f"{'FAIL' if n_bad else 'PASS'} {label}: {len(res['lanes'])} of {res['rays']} "
              f"lanes differ ({res['live']} live), {n_tie} ties at equal t, {n_bad} not")
        for row, note in zip(res["lanes"], notes):
            print("  " + format_lane(row))
            print("    " + note)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
