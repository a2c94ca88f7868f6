"""Nearest hit over a 4-tile bank, in the variants of the trace's tile loop.

The counterpart of the JAX package's trace micro-benchmark
(scripts/micro_trace.py ``run``): a bank of 1024 random triangles baked in
tiles of 256 (``make_bank``) and R = 2^18 random rays (``make_state``);
for every ray the nearest front-facing hit over the flat loop of the four
tiles, with no previous-hit exclusion, into aux (8, R) [u, v, t, streams,
alive, 0, 0, 0] and idx (1, R).  The variants: u/v extraction on or off
(rows 0-1 stay 0 when off), the tile cull (``none``; ``lane``: each ray's
own slab test; ``warp``: a warp of 32 rays sweeps a tile when any of its
rays passes, and every ray of it takes the update, as the TPU kernel's
lane block does), and the threads per block of ``micro_trace_kernel``
(kernels/probes.cu), in place of the TPU kernel's lane block.  The
script's MXU transforms (``mxu``, ``mxu2``) have no counterpart.

``micro_trace_ref`` is the plain version (the tile loop of
``mxu_intersect.nearest_hit_ref``, widened to the variant's cull);
``micro_trace_staged_ref`` models the kernel's staged test (the same bits,
and the pairs each stage takes), ``boundary_inputs`` builds the staged
test's boundary cases; the yardstick
is the per-bounce trace ``mxu_intersect.trace_emit_aux`` on the same bank
and rays (trace_emit_kernel, a walk of the 4-tile heap).  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.micro_trace

(``--device cpu`` runs the plain version against itself on the first
CPU_RAYS rays.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels
from ..ops import mxu_intersect as mi
from ..scene.types import TorchScene
from ..utils.timing import best_ms, cuda_ms

R = 1 << 18
T = 1024  # 4 tiles
TILE = mi.TRI_TILE
CULLS = kernels.MICRO_TRACE_CULLS
THREADS = (128, 256, 512)
WARP = 32
CPU_RAYS = 4096


def make_bank(seed: int = 0) -> mi.MXUTriangles:
    """The script's bank: 1024 triangles drawn from ``seed``, baked in
    tiles of 256 (tri_data (16, 2048), tile_bbox (6, 4))."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-8, 8, (T, 3))
    e1 = rng.uniform(-0.5, 0.5, (T, 3))
    e2 = rng.uniform(-0.5, 0.5, (T, 3))
    return mi.bake_triangles(v0, e1, e2)


def make_state(seed: int = 1) -> np.ndarray:
    """The script's (16, R) f32 state: origins in [-8, 8]^3, unit
    directions, throughput 1, every ray alive."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (3, R)).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    st = np.zeros((16, R), np.float32)
    st[0:3] = o
    st[3:6] = d
    st[6:9] = 1.0
    st[12] = 1.0
    return st


def _sweep_all(passed: torch.Tensor) -> torch.Tensor:
    """Cull ``none``: every ray sweeps every tile."""
    return torch.ones_like(passed)


def _sweep_warp(passed: torch.Tensor) -> torch.Tensor:
    """Cull ``warp``: every ray of a 32-ray group one of whose rays passes."""
    groups = torch.nn.functional.pad(passed, (0, -passed.shape[0] % WARP)).view(-1, WARP)
    return groups.any(dim=1, keepdim=True).expand(-1, WARP).reshape(-1)[:passed.shape[0]]


_WIDEN = {"none": _sweep_all, "lane": None, "warp": _sweep_warp}


def micro_trace_ref(tri_data: torch.Tensor, tile_bbox: torch.Tensor, tile: int,
                    state: torch.Tensor, extract_uv: bool = True, cull: str = "lane",
                    return_swept: bool = False):
    """Plain version of ``micro_trace``: (aux (8, R), idx (1, R) int32) and,
    with ``return_swept``, the tiles each ray swept (R,) f32.  The flat loop
    of ``mxu_intersect.nearest_hit_ref``, every tile swept for the rays the
    cull lets through (``none``: every ray, alive or not, as the TPU
    kernel's unmasked update; ``lane``: the live rays whose slab test
    passes; ``warp``: every ray of a 32-ray group one of whose rays
    passes)."""
    if cull not in CULLS:
        raise ValueError(f"cull {cull!r} not one of {CULLS}")
    t, idx, u, v, swept = mi.nearest_hit_ref(tri_data, tile_bbox, tile, state[0:3],
                                             state[3:6], state[12] > 0.0,
                                             widen=_WIDEN[cull])
    zero = torch.zeros_like(t)
    aux = torch.stack([u if extract_uv else zero, v if extract_uv else zero, t,
                       state[13], state[12], zero, zero, zero])
    out = aux, idx.to(torch.int32)[None, :]
    return out + (swept,) if return_swept else out


# The staged test of micro_trace_kernel (kernels/probes.cu): its margin on
# the running best, 1 + 2^-20, and the least normal float.
PRUNE_MARGIN = 1.0 + 2.0 ** -20
FLT_NORMAL_MIN = float(np.finfo(np.float32).tiny)
# rays per step of the staged model (bounds its (rays, tile) temporaries)
_STAGED_CHUNK = 1 << 13


def front_and_ahead(dw: torch.Tensor, ow: torch.Tensor, n_sq: torch.Tensor) -> torch.Tensor:
    """Stage 1's verdict on dw and ow (``front_and_ahead``): the det test
    -dw·|n|² >= 1e-8 and the sign test of t = -ow/dw > 0 (ow nonzero, ow
    and dw of opposite sign bits; a NaN ow passes it and fails stage 2)."""
    opposite = (ow.view(torch.int32) ^ dw.view(torch.int32)) < 0
    return (-dw * n_sq >= mi.MT_EPSILON) & opposite & (ow != 0.0)


def prune_bound(bt: torch.Tensor) -> torch.Tensor:
    """bq of the test against the running best bt (``prune_bound``):
    rn(bt·(1 + 2^-20)) for a normal bt, +inf for a subnormal one."""
    return torch.where(bt >= FLT_NORMAL_MIN, bt * PRUNE_MARGIN, torch.inf)


def beyond_best(dw: torch.Tensor, ow: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """The pairs stage 1 drops against the best (``beyond_best``): |ow| >=
    p = rn(bq·|dw|) while p is normal or +inf, so t = rn(-ow/dw) > bt."""
    p = bq * dw.abs()
    return (ow.abs() >= p) & (p >= FLT_NORMAL_MIN)


def stage1_keeps(dw: torch.Tensor, ow: torch.Tensor, n_sq: torch.Tensor,
                 bt: torch.Tensor) -> torch.Tensor:
    """Whether micro_trace_kernel's stage 1 passes a pair (dw, ow, |n|²) of
    a ray whose best so far is bt on to stage 2."""
    return front_and_ahead(dw, ow, n_sq) & ~beyond_best(dw, ow, prune_bound(bt))


def _staged_chunk(rows, tile_bbox, tile, o, d, active, widen, counts):
    """``micro_trace_staged_ref`` on one chunk of rays: (t, idx, u, v)."""
    R = o.shape[1]
    dev = o.device
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=torch.float32, device=dev)
    best_v = torch.zeros(R, dtype=torch.float32, device=dev)
    inv = [1.0 / d[a] for a in range(3)]
    ids = torch.arange(tile, device=dev)
    for j in range(tile_bbox.shape[1]):
        passed = mi.cull_mask_ref(tile_bbox[:, j], o, inv, best_t, active)
        counts["boxes"] += int(active.sum())
        if widen is not None:
            passed = widen(passed)
        lanes = passed.nonzero()[:, 0]
        if lanes.numel() == 0:
            continue
        m = [r[None, j * tile:(j + 1) * tile] for r in rows]
        ox, oy, oz = (o[a, lanes, None] for a in range(3))
        dx, dy, dz = (d[a, lanes, None] for a in range(3))
        # stage 1, every swept pair
        dw = m[6] * dx + m[7] * dy + m[8] * dz
        ow = m[6] * ox + m[7] * oy + m[8] * oz + m[11]
        s1 = front_and_ahead(dw, ow, m[12])
        # the full test where the sign and det tests pass; the exact best
        # before each pair (the flat loop's order) for the test against it
        r, k = s1.nonzero(as_tuple=True)
        mk = [x[0, k] for x in m]
        pox, poy, poz, pdx, pdy, pdz = (c[r, 0] for c in (ox, oy, oz, dx, dy, dz))
        ou = mk[0] * pox + mk[1] * poy + mk[2] * poz + mk[9]
        ov = mk[3] * pox + mk[4] * poy + mk[5] * poz + mk[10]
        du = mk[0] * pdx + mk[1] * pdy + mk[2] * pdz
        dv = mk[3] * pdx + mk[4] * pdy + mk[5] * pdz
        t = -ow[r, k] / dw[r, k]
        u = ou + t * du
        v = ov + t * dv
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        t_ok = torch.full_like(dw, torch.inf)
        t_ok[r[ok], k[ok]] = t[ok]
        before = torch.cummin(t_ok, dim=1).values.roll(1, dims=1)
        before[:, 0] = torch.inf
        before = torch.minimum(before, best_t[lanes, None])
        stage2 = s1 & ~beyond_best(dw, ow, prune_bound(before))
        counts["swept"] += dw.numel()
        counts["stage2"] += int(stage2.sum())
        counts["hits"] += int((stage2 & (t_ok < torch.inf)).sum())
        # the tile's fold over the pairs stage 2 ran, as the flat loop's
        t_tile = torch.where(stage2, t_ok, torch.inf)
        tile_min = t_tile.min(dim=1).values
        cand = torch.where(t_tile <= tile_min[:, None], ids[None, :], tile).min(dim=1).values
        better = tile_min < best_t[lanes]
        win = lanes[better]
        best_t[win] = tile_min[better]
        best_i[win] = j * tile + cand[better]
        if bool(better.any()):
            at = torch.full_like(dw, -1, dtype=torch.int64)
            at[r, k] = torch.arange(r.numel(), device=dev)
            pick = at[better.nonzero()[:, 0], cand[better]]
            best_u[win] = u[pick]
            best_v[win] = v[pick]
    return best_t, best_i, best_u, best_v


def micro_trace_staged_ref(tri_data: torch.Tensor, tile_bbox: torch.Tensor, tile: int,
                           state: torch.Tensor, extract_uv: bool = True, cull: str = "lane"):
    """Plain model of micro_trace_kernel's staged order: ((aux (8, R), idx
    (1, R) int32), counts).  Stage 1 (dw, the det and sign tests, ow, the
    test against the best) for every pair the cull sweeps, stage 2 (ou, ov,
    du, dv, t, u, v) for the pairs it passes on, each value computed as
    ``micro_trace_ref`` computes it; the best each pair is tested against
    is the exact best of the triangles before it (the kernel's may be
    older, never smaller, so its stage 2 takes at least ``stage2`` pairs).
    counts: "swept" pairs, "stage2" pairs, "hits" (pairs the full test
    accepts among them) and "boxes" (slab tests: a live ray and a tile)."""
    if cull not in CULLS:
        raise ValueError(f"cull {cull!r} not one of {CULLS}")
    R = state.shape[1]
    rows = tri_data[:13]
    counts = {"swept": 0, "stage2": 0, "hits": 0, "boxes": 0}
    out = [torch.empty(R, dtype=dt, device=state.device)
           for dt in (torch.float32, torch.int64, torch.float32, torch.float32)]
    active = state[12] > 0.0
    for c0 in range(0, R, _STAGED_CHUNK):
        sl = slice(c0, min(c0 + _STAGED_CHUNK, R))
        res = _staged_chunk(rows, tile_bbox, tile, state[0:3, sl], state[3:6, sl],
                            active[sl], _WIDEN[cull], counts)
        for dst, src in zip(out, res):
            dst[sl] = src
    t, idx, u, v = out
    zero = torch.zeros_like(t)
    aux = torch.stack([u if extract_uv else zero, v if extract_uv else zero, t,
                       state[13], state[12], zero, zero, zero])
    return (aux, idx.to(torch.int32)[None, :]), counts


def survivor_balance(tri_data: torch.Tensor, state: torch.Tensor, block: int = 64) -> dict:
    """How stage 1's survivors (the det and sign tests, every pair) spread
    over warps of 32 rays and blocks of ``block`` triangles of the real
    columns of ``tri_data``: "share", the surviving pairs; the stage-2
    rounds a triangle when each lane runs its own survivors ("lane": the
    busiest lane of the warp sets them), when each lane runs one triangle's
    ("triangle", blocks of 32) and when every survivor is packed into full
    warps ("full": the share itself)."""
    m = tri_data[:13]
    o, d = state[0:3], state[3:6]
    dw = m[6][None] * d[0][:, None] + m[7][None] * d[1][:, None] + m[8][None] * d[2][:, None]
    ow = (m[6][None] * o[0][:, None] + m[7][None] * o[1][:, None]
          + m[8][None] * o[2][:, None] + m[11][None])
    s1 = front_and_ahead(dw, ow, m[12][None])
    R, T = s1.shape
    w = s1[:R // WARP * WARP, :T // block * block].reshape(R // WARP, WARP, -1, block)
    lane = w.sum(-1).max(dim=1).values.float().mean() / block
    tri = s1[:R // WARP * WARP, :T // 32 * 32].reshape(R // WARP, WARP, -1, 32).sum(1)
    return {"share": float(s1.float().mean()), "lane": float(lane),
            "triangle": float(tri.max(dim=2).values.float().mean() / 32),
            "full": float(s1.float().mean())}


def boundary_inputs():
    """The staged test's boundary cases as micro_trace's inputs (NumPy):
    (tri_data (16, Tp), tile_bbox (6, nt), tile, state (16, R)).  Ray c has
    o = (0, c, 0), d = (1, 0, 0), so each of its triangles' rows give dw =
    M6 and ow = c11 exactly, and u = v = 0.25 for ray c alone (M1 = 1, c9 =
    0.25 - c, M4 = -1, c10 = 0.25 + c); every box holds every ray.  The
    cases, in index order within a ray: a first hit, then t a few ulps
    either side of it, equal to it and past the margin (dw = -1 and dw =
    -3), in both orders; ow = +0, -0,
    of dw's sign; det at 1e-8 and an ulp below; a best of 1e-30 and then
    products bt·|dw| that are subnormal; a subnormal best; a best of 1e30
    and a product that overflows; an infinite ow; NaN in dw, ow, |n|² and
    u's row; rays with no hit at all."""
    f32 = np.float32

    def ulps(x, k):
        x = f32(x)
        for _ in range(abs(k)):
            x = np.nextafter(x, f32(np.inf) if k > 0 else f32(-np.inf), dtype=f32)
        return x

    five = [(-1.0, 5.0, 1.0)] + [(-1.0, ulps(5.0, k), 1.0) for k in (-3, -1, 0, 1, 2, 8, 64)]
    five.append((-1.0, 6.0, 1.0))
    fifteen = [(-3.0, ulps(15.0, k), 1.0) for k in (4, -2, 0, 1, -5, 3)]
    cases = [
        five, five[::-1], fifteen, fifteen[::-1],
        [(-1.0, 0.0, 1.0), (-1.0, -0.0, 1.0), (-1.0, -2.0, 1.0), (1.0, 2.0, 1.0),
         (-1.0, 4.0, 1.0)],
        [(f32(-1e-8), f32(3e-8), 1.0), (f32(-1e-8), f32(3e-8), ulps(1.0, -1)),
         (-1.0, 7.0, f32(1e-8)), (-1.0, 6.5, ulps(1e-8, -1))],
        [(-1.0, f32(1e-30), 1.0), (f32(-1e-10), ulps(f32(1e-40), 1), 1000.0),
         (f32(-1e-10), ulps(f32(1e-40), -1), 1000.0), (f32(-1e-10), f32(1e-40), 1000.0)],
        [(-1.0, f32(1e-40), 1.0), (-1.0, ulps(f32(1e-40), -1), 1.0),
         (-2.0, f32(2e-40), 1.0)],
        [(-1.0, f32(1e30), 1.0), (f32(-1e10), f32(3e38), 1.0), (f32(-1e10), f32(3.2e38), 1.0),
         (-1.0, np.inf, 1.0), (-1.0, f32(9e29), 1.0)],
        [(np.nan, 1.0, 1.0), (-1.0, np.nan, 1.0), (-1.0, 1.0, np.nan), ("u", -1.0, 2.0),
         (-1.0, 3.0, 1.0)],
        [(-1.0, -1.0, 1.0), (1.0, -1.0, 1.0)],
    ]
    tile = 32
    tris = [(c, *tri) for c, case in enumerate(cases) for tri in case]
    nt = -(-len(tris) // tile)
    tri_data = np.zeros((16, nt * tile), f32)
    tri_data[6] = 1.0  # padding: dw = 1, det fails
    for i, (c, dw, ow, n_sq) in enumerate(tris):
        tri_data[1, i], tri_data[9, i] = 1.0, 0.25 - c
        tri_data[4, i], tri_data[10, i] = -1.0, 0.25 + c
        if dw == "u":  # NaN in the u row
            dw, tri_data[0, i] = -1.0, np.nan
        tri_data[6, i], tri_data[11, i], tri_data[12, i] = dw, ow, n_sq
    tile_bbox = np.zeros((6, nt), f32)
    tile_bbox[0:3], tile_bbox[3:6] = -1e30, 1e30
    R = len(cases) + 3  # and rays that meet nothing
    state = np.zeros((16, R), f32)
    state[1] = np.arange(R)
    state[3] = 1.0
    state[12] = 1.0
    state[12, -1] = 0.0  # a dead ray
    return tri_data, tile_bbox, tile, state


def micro_trace(tri_data: torch.Tensor, tile_bbox: torch.Tensor, tile: int,
                state: torch.Tensor, extract_uv: bool = True, cull: str = "lane",
                threads: int = 256):
    """Nearest front-facing hit of every column of ``state`` (16, R) over
    the flat loop of the field-major (16, Tp) ``tri_data`` in tiles of
    ``tile`` with boxes ``tile_bbox`` (6, nt): (aux (8, R), idx (1, R)
    int32).  A CUDA state launches micro_trace_kernel with ``threads`` per
    block, a CPU state runs ``micro_trace_ref``."""
    if state.device.type == "cpu":
        return micro_trace_ref(tri_data, tile_bbox, tile, state, extract_uv, cull)
    if state.device.type != "cuda":
        raise ValueError(f"no micro_trace kernel for device {state.device}")
    aux = torch.empty((8, state.shape[1]), dtype=torch.float32, device=state.device)
    idx = torch.empty((1, state.shape[1]), dtype=torch.int32, device=state.device)
    kernels.launch_micro_trace(tri_data, tile_bbox, tile, state, cull, extract_uv, threads,
                               aux, idx)
    return aux, idx


def trace_scene(tris: mi.MXUTriangles, device) -> TorchScene:
    """The bank as a scene for ``mxu_intersect.trace_emit_aux`` (the
    yardstick): no records, a one-texel bank."""
    return TorchScene(
        tri_data=torch.from_numpy(tris.tri_data),
        tile_bbox=torch.from_numpy(tris.tile_bbox),
        tree_bbox=torch.from_numpy(tris.tree_bbox),
        group_bbox=torch.from_numpy(tris.group_bbox),
        group_tree_bbox=torch.from_numpy(tris.group_tree_bbox),
        perm=torch.from_numpy(tris.perm.astype(np.int64)),
        rec_table=torch.zeros((24, tris.tri_data.shape[1])),
        bank=torch.zeros((1, 4)),
        bbox_min=torch.full((3,), -8.5),
        bbox_max=torch.full((3,), 8.5),
        tile=tris.tile,
        emissive_dummy=True,
        group_tiles=tris.group_tiles,
        bank_resident=True,
    ).to(device)


def compare(tri_data, state, got, want) -> tuple[int, int, float]:
    """(mismatched lanes, tied lanes, largest |diff| of rows 0-2 where the
    winners agree and hit) of ``got`` against ``want`` (each (aux, idx)):
    aux rows 2 onward bit for bit on every lane, rows 0-1 where the winners
    agree; a lane whose winners differ counts as tied when the ``got``
    winner, recomputed alone with ``triangle_hit_ref``, is hit at
    ``want``'s t (with ``got``'s u, v when they are extracted), and as
    mismatched otherwise."""
    (ga, gi), (wa, wi) = got, want
    bits = lambda a: a.view(torch.int32)
    bad = (bits(ga[2:]) != bits(wa[2:])).any(dim=0)
    same = gi[0] == wi[0]
    bad |= (bits(ga[0:2]) != bits(wa[0:2])).any(dim=0) & same
    tied = 0
    if not bool(same.all()):
        lane = (~same).nonzero()[:, 0]
        hit, t, u, v = mi.triangle_hit_ref(tri_data, state[0:3, lane], state[3:6, lane],
                                           gi[0, lane])
        good = hit & (t == wa[2, lane])
        if bool(ga[0:2].any()):  # u, v extracted
            good &= (u == ga[0, lane]) & (v == ga[1, lane])
        bad[lane[~good]] = True
        tied = int(good.sum())
    fin = same & torch.isfinite(wa[2])
    err = float((ga[0:3, fin] - wa[0:3, fin]).abs().max()) if bool(fin.any()) else 0.0
    return int(bad.sum()), tied, err


def variants():
    """Every (extract_uv, cull, threads) the kernel takes."""
    return [(uv, cull, th) for uv in (True, False) for cull in CULLS for th in THREADS]


def run_checks(device) -> list:
    """Each variant's kernel against its plain version on ``device`` (the
    full R rays on the card, the first CPU_RAYS on the CPU), and the
    yardstick ``trace_emit_aux`` against the plain version (aux rows 0-4):
    a list of (label, rays, mismatched lanes, tied lanes, largest
    |diff|)."""
    device = torch.device(device)
    tris = make_bank(0)
    st = make_state(1)
    if device.type == "cpu":
        st = np.ascontiguousarray(st[:, :CPU_RAYS])
    state = torch.from_numpy(st).to(device)
    tri = torch.from_numpy(tris.tri_data).to(device)
    bbox = torch.from_numpy(tris.tile_bbox).to(device)
    n = state.shape[1]
    out = []
    plain = {}
    for uv, cull, th in variants():
        if (uv, cull) not in plain:
            plain[uv, cull] = micro_trace_ref(tri, bbox, tris.tile, state, uv, cull)
        got = micro_trace(tri, bbox, tris.tile, state, uv, cull, th)
        out.append((f"extract_uv={int(uv)} cull={cull} threads={th}", n,
                    *compare(tri, state, got, plain[uv, cull])))
    aux, idx, _ = mi.trace_emit_aux(trace_scene(tris, device), state)
    want = plain[True, "lane"]
    flat = (want[0][:5], want[1])
    yard = (aux[0:5], idx[None, :])
    out.append(("trace_emit_aux (yardstick, rows 0-4)", n, *compare(tri, state, yard, flat)))
    return out


def boundary_checks(device) -> list:
    """Each variant's kernel against its plain version on the staged
    test's boundary cases (``boundary_inputs``): a list of (label, rays,
    mismatched lanes, tied lanes)."""
    tri_data, tile_bbox, tile, state = boundary_inputs()
    tri, bbox, st = (torch.from_numpy(a).to(device) for a in (tri_data, tile_bbox, state))
    out = []
    for uv, cull, th in variants():
        got = micro_trace(tri, bbox, tile, st, uv, cull, th)
        bad, tied, _ = compare(tri, st, got, micro_trace_ref(tri, bbox, tile, st, uv, cull))
        out.append((f"boundary cases extract_uv={int(uv)} cull={cull} threads={th}",
                    st.shape[1], bad, tied))
    return out


def time_variants(device="cuda") -> dict:
    """Card times: every variant and the yardstick trace_emit_aux (best of
    5 rounds of 5 launches), keyed (extract_uv, cull, threads) and
    "trace_emit_aux"; the plain version with u/v per cull (one call), keyed
    ("plain", cull); with the tiles the lane cull sweeps (summed over the
    rays) and the box tests, for the bound."""
    device = torch.device(device)
    tris = make_bank(0)
    state = torch.from_numpy(make_state(1)).to(device)
    tri = torch.from_numpy(tris.tri_data).to(device)
    bbox = torch.from_numpy(tris.tile_bbox).to(device)
    scene = trace_scene(tris, device)
    ms = {v: best_ms(lambda v=v: micro_trace(tri, bbox, tris.tile, state, *v), 5)
          for v in variants()}
    ms["trace_emit_aux"] = best_ms(lambda: mi.trace_emit_aux(scene, state), 5)
    for cull in CULLS:
        ms["plain", cull] = cuda_ms(
            lambda cull=cull: micro_trace_ref(tri, bbox, tris.tile, state, True, cull), 1)
    swept = micro_trace_ref(tri, bbox, tris.tile, state, return_swept=True)[2]
    return {"ms": ms, "rays": state.shape[1], "tiles_swept": float(swept.sum()),
            "boxes": float((state[12] > 0).sum()) * bbox.shape[1]}


def label(key) -> str:
    """The printed name of a ``time_variants`` key."""
    if isinstance(key, str):
        return key
    if key[0] == "plain":
        return f"plain version, extract_uv=1 cull={key[1]}"
    return f"extract_uv={int(key[0])} cull={key[1]} threads={key[2]}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: PyTorch sees no CUDA card; pass --device cpu")
    failures = 0
    for name, n, bad, tied, _ in run_checks(args.device):
        failures += bool(bad)
        print(f"{'FAIL' if bad else 'PASS'} {name}: {bad} of {n} lanes differ, "
              f"{tied} tied")
    if args.device == "cuda":
        res = time_variants()
        for key, ms in res["ms"].items():
            print(f"{label(key)}: {ms:.4f} ms at {res['rays']} rays")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
