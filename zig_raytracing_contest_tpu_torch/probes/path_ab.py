"""Two builds of the whole-path kernels on the same waves: bits and time.

``path_trace_gen_kernel`` and ``path_trace_kernel`` of this checkout's
kernels/path_trace.cu against those of another path_trace.cu whose
``zrc_path_trace_gen`` and ``zrc_path_trace`` take the same arguments (an
earlier commit's, written out by ``git show
<commit>:zig_raytracing_contest_tpu_torch/kernels/path_trace.cu``, or a
variant of this one), on the full waves of chip_smoke.py's two whole-path
frames: the official frame (the bench scene, 1920x1080, 3 spp, wave 5 of
12: 522,240 rays) and the Duck (the Duck-class GLB, the wave from pixel
tile 920).  The three calls of the main path's wave: ``path_trace_gen``
(bounce 0, key, idx), ``path_trace_fused`` at bounce 1 after the sort on
the key (with the previous hit) and at bounces 2-3 after the resort on the
host key; each call's input is made by this checkout's kernels.  Both
builds run each call; the 16 state rows and idx must be equal as bits, or
the run fails.  Then each build is timed on it in alternating pairs
(other, this, this, other; CUDA events over REPS launches after a warmup).
Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.path_ab --against OTHER.cu \\
        [--against VARIANT.cu ...] [--build-dir DIR]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import kernels
from ..config import Config
from ..render import fused
from ..render.pipeline import prepare_scene, slot_geometry
from ..render.wavefront import build_gen_par, ray_sort_key, sort_state_payload
from ..scene.duck import write_duck_glb
from ..scene.procedural import bench_scene
from ..utils.timing import cuda_ms
from .trace_ab import card_line, print_ptxas

# the official frame of chip_smoke.py (SPP, MAX_BOUNCE, WAVE) and its Duck
SPP, BOUNCES, WAVE, SEED = 3, 4, 1 << 19, 0
FULL_WAVE = WAVE // (SPP * 1024) * (SPP * 1024)  # 522,240 rays
DUCK_DETAIL, DUCK_TEX = 1.0, 512
REPS = 10
KERNELS = ("path_trace_gen_kernel", "path_trace_kernel")


def scenes(tmp: Path, device) -> list:
    """(label, scene, camera, first slot of the wave) of the two frames."""
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=SPP, max_bounce=BOUNCES,
                 wave_size=WAVE, seed=SEED)
    official, cam, _ = prepare_scene(str(bench_scene(tmp / "bench.gltf")), cfg,
                                     camera_name="Camera 1", width=1920, height=1080,
                                     device=device)
    duck = write_duck_glb(tmp / "duck.glb", tex_size=DUCK_TEX, detail=DUCK_DETAIL)
    dscene, dcam, _ = prepare_scene(str(duck), cfg, height=1080, device=device)
    return [("official", official, cam, 5 * (FULL_WAVE // SPP)),
            ("Duck", dscene, dcam, 1024 * 920)]


def wave_calls(scene, cam, slot_base: int, R: int) -> tuple:
    """The main path's three calls of one wave as (label, launch) pairs,
    and the alive rows of the bounce-1 and bounce-2 inputs:
    ``launch(lib, state_out, idx_out)`` runs the call with ``lib`` (None:
    this checkout's build).  The inputs of bounce 1 and bounces 2-3 are
    made by this checkout's kernels, as the main path makes them."""
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    _, tiles_x = slot_geometry(cam.width, cam.height, True)
    gen = fused.GenParams(spp=SPP, width=cam.width, img_w=cam.width, img_h=cam.height,
                          tiles_x=tiles_x)
    meta = (slot_base, slot_base % cam.width, slot_base // cam.width, SEED,
            slot_base // 1024, 0, 0, 0)
    st0, idx0 = fused.path_trace_gen(scene, par, meta, R, 1, gen, emit_key=True,
                                     emit_idx=True)
    _, st1, (prev1,) = sort_state_payload(st0[15].contiguous().view(torch.int32), st0,
                                          (idx0,))
    s1, i1 = fused.path_trace_fused(scene, st1, 1, bounce0=1, prev=prev1, emit_idx=True)
    _, st2, (prev2,) = sort_state_payload(ray_sort_key(scene, s1), s1, (i1,))
    return [
        ("bounce 0 (path_trace_gen_kernel)",
         lambda lib, so, io: kernels.launch_path_trace_gen(scene, par, meta, gen, 1, True,
                                                           so, io, lib)),
        ("bounce 1 (path_trace_kernel)",
         lambda lib, so, io: kernels.launch_path_trace(scene, st1, prev1, 1, 1, so, io, lib)),
        ("bounces 2-3 (path_trace_kernel)",
         lambda lib, so, io: kernels.launch_path_trace(scene, st2, prev2, 2, BOUNCES - 2,
                                                       so, io, lib)),
    ], st1[12], st2[12]


def compare(launch, R: int, other, device) -> dict:
    """Both builds on one call: the lanes where a state row (any of 16, as
    bits) or idx differ, and each build's ms in the order other, this,
    this, other."""
    outs = {name: (torch.empty((16, R), dtype=torch.float32, device=device),
                   torch.empty(R, dtype=torch.int32, device=device))
            for name in ("other", "this")}
    libs = {"other": other, "this": None}
    ms = {name: [] for name in outs}
    for name in ("other", "this", "this", "other"):
        ms[name].append(cuda_ms(lambda: launch(libs[name], *outs[name]), REPS))
    (so, io), (st, it) = outs["other"], outs["this"]
    off = (so.view(torch.int32) != st.view(torch.int32)).any(dim=0) | (io != it)
    return {"lanes_off": int(off.sum()), "ms": ms}


def build_others(sources, build_dir: Path) -> dict:
    """Each other path_trace.cu built into its own directory and this
    checkout's (one nvcc each, all started together), the others loaded;
    prints their ptxas lines."""
    dirs = [build_dir / str(k) for k in range(len(sources))]
    jobs = [("path_trace_other", src, d) for src, d in zip(sources, dirs)]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        list(pool.map(lambda a: kernels.build(*a), [("path_trace",), *jobs]))
    others = {}
    for src, d in zip(sources, dirs):
        others[src.name] = kernels.load_trace_library(src, d)
        print_ptxas(src.name, kernels.build_log("path_trace_other", src), KERNELS)
    return others


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", required=True, type=Path, action="append",
                   help="another path_trace.cu (same zrc_path_trace_gen and "
                        "zrc_path_trace arguments); may be given more than once")
    p.add_argument("--build-dir", type=Path, default=None,
                   help="where to build them (default: a temporary directory)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("PyTorch sees no CUDA card: both builds run on the card")
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    R = FULL_WAVE
    faults = 0
    with tempfile.TemporaryDirectory() as tmp:
        others = build_others(args.against, args.build_dir or Path(tmp) / "b")
        kernels.load()
        print_ptxas("this", kernels.build_log("path_trace"), KERNELS)
        for label, scene, cam, slot_base in scenes(Path(tmp), dev):
            calls, live1, live2 = wave_calls(scene, cam, slot_base, R)
            print(f"{label}: {R} rays from slot {slot_base}; live at bounce 1 "
                  f"{int(live1.sum())}, at bounce 2 {int(live2.sum())}")
            for (what, launch) in calls:
                for name, other in others.items():
                    res = compare(launch, R, other, dev)
                    faults += res["lanes_off"]
                    o, t = res["ms"]["other"], res["ms"]["this"]
                    ratio = (o[0] + o[1]) / (t[0] + t[1])
                    print(f"  {label} {what}: lanes where a state row (16, bits) or idx "
                          f"differ: {res['lanes_off']}; {name} {o[0]:.4f}, {o[1]:.4f} ms, "
                          f"this {t[0]:.4f}, {t[1]:.4f} ms (order {name}, this, this, "
                          f"{name}), {name} / this {ratio:.3f} ({card})")
            del scene, calls
            torch.cuda.empty_cache()
    print("FAIL" if faults else "PASS")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
