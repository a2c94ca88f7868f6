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
``mxu_intersect.nearest_hit_ref``, widened to the variant's cull); the yardstick
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
