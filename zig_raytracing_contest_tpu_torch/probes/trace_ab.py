"""Two builds of the per-bounce traces on the same waves: bits and time.

``trace_emit_kernel`` and ``trace_stream_kernel`` of this checkout's
kernels/path_trace.cu against those of another path_trace.cu whose
``zrc_trace_emit`` takes the same arguments (an earlier commit's, written
out by ``git show <commit>:zig_raytracing_contest_tpu_torch/kernels/path_trace.cu``),
on the bounce-0 and bounce-1 waves of chip_smoke.py's three per-bounce
frames: ``--large`` (``large_scene()``, trace_emit_kernel), 500k
(``large_scene(side=500)``, trace_stream_kernel) and 2-Mtexel (the
``--large`` geometry with a 2048x1024 noise texture, trace_emit_kernel with
its own record table).  Bounce 0 is the frame's wave (1280x720, 2 spp:
1,843,200 rays) made and beam-sorted by the port on the card, bounce 1 that
wave after its trace, shade and sort with the previous hit.  Both builds
trace each wave with records (bounce 1 with the previous hits); aux (all 8
rows, as bits), idx and the records must be equal, or the run fails.  Then
each build is timed on it in alternating pairs (other, this, this, other;
CUDA events over 5 launches after a warmup).  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.trace_ab --against OTHER.cu \
        [--build-dir DIR]
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .. import kernels
from ..config import Config
from ..ops import mxu_intersect as mi
from ..render import fused
from ..render.pipeline import prepare_scene
from ..render.wavefront import build_gen_par, gen_rays_raster, ray_sort_key, sort_state_payload
from ..scene.procedural import big_texture_scene, large_scene
from ..utils.timing import cuda_ms

# the --large frame of bench.py (chip_smoke.py's L_*), its 500k row's side
# and the 2-Mtexel bank's texture
WIDTH, HEIGHT, SPP, BOUNCES, WAVE, SEED = 1280, 720, 2, 3, 1 << 21, 0
SIDE_500K, TEX_W, TEX_H = 500, 2048, 1024
REPS = 5


def bounce_waves(scene, cam, rays: int, spp: int = SPP, seed: int = SEED):
    """The main path's first two bounces of one wave of ``rays`` on the
    card's kernels (gen, sort, trace, shade, sort with the previous hit,
    trace, shade).  Returns (state, aux, idx, rec, shaded) of bounce 0 and
    (state, prev, aux, idx, rec, shaded) of bounce 1."""
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    st0 = gen_rays_raster(par, seed, 0, rays, spp, cam.width)
    _, st0, _ = sort_state_payload(ray_sort_key(scene, st0), st0)
    a0, i0, r0 = mi.trace_emit_aux(scene, st0, scene.rec_table)
    s0 = fused.shade_fused(scene, st0, a0, i0, 0, r0)
    _, st1, (prev,) = sort_state_payload(ray_sort_key(scene, s0), s0, (i0,))
    a1, i1, r1 = mi.trace_emit_aux(scene, st1, scene.rec_table, prev)
    s1 = fused.shade_fused(scene, st1, a1, i1, 1, r1)
    return (st0, a0, i0, r0, s0), (st1, prev, a1, i1, r1, s1)


def scene_paths(tmp: Path) -> list:
    """(label, glTF path) of the three per-bounce frames."""
    return [
        ("--large", large_scene(tmp / "large.gltf")),
        ("500k", large_scene(tmp / "large500.gltf", side=SIDE_500K)),
        ("2-Mtexel", big_texture_scene(large_scene(tmp / "bank.gltf"), SEED, TEX_W, TEX_H)),
    ]


def compare(scene, state, prev, other) -> dict:
    """Both builds' trace of ``state`` (with ``prev`` and records; ``other``
    a ``kernels.load_trace_library``): the lanes where aux (any of 8 rows,
    as bits), idx or the record differ, and each build's ms in the order
    other, this, this, other."""
    dev = state.device
    R = state.shape[1]
    streams = mi.streams_bank(scene)
    launch = kernels.launch_trace_stream if streams else kernels.launch_trace_emit
    outs = {name: (torch.empty((8, R), dtype=torch.float32, device=dev),
                   torch.empty(R, dtype=torch.int32, device=dev),
                   torch.empty((24, R), dtype=torch.float32, device=dev))
            for name in ("other", "this")}
    libs = {"other": other, "this": None}

    def run(name):
        return lambda: launch(scene, state, prev, scene.rec_table, *outs[name],
                              lib=libs[name])

    ms = {name: [] for name in outs}
    for name in ("other", "this", "this", "other"):
        ms[name].append(cuda_ms(run(name), REPS))
    (ao, io, ro), (at, it, rt) = outs["other"], outs["this"]
    off = ((ao.view(torch.int32) != at.view(torch.int32)).any(dim=0)
           | (io != it) | (ro.view(torch.int32) != rt.view(torch.int32)).any(dim=0))
    live = state[12] > 0
    return {"kernel": "trace_stream_kernel" if streams else "trace_emit_kernel",
            "rays": R, "live": int(live.sum()), "lanes_off": int(off.sum()),
            "ms": ms, "swept": float(at[5][live].mean()), "tested": float(at[6][live].mean())}


def print_ptxas(name: str, log: str,
                kernel_names=("trace_emit_kernel", "trace_stream_kernel")) -> None:
    """The ptxas lines (registers, stack frame, spills) of the kernels
    ``kernel_names`` (default: the two traces) in a build's log."""
    cur = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in kernel_names if k in line), None)
        elif cur and ("registers" in line or "spill" in line):
            print(f"  {name} {cur}: {line.strip()}")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", required=True, type=Path, action="append",
                   help="another path_trace.cu (same zrc_trace_emit arguments); "
                        "may be given more than once")
    p.add_argument("--build-dir", type=Path, default=None,
                   help="where to build it (default: a temporary directory)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("PyTorch sees no CUDA card: both builds run on the card")
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    faults = 0
    with tempfile.TemporaryDirectory() as tmp:
        others = {}
        for k, src in enumerate(args.against):
            others[src.name] = kernels.load_trace_library(
                src, (args.build_dir or Path(tmp) / "b") / str(k))
            print_ptxas(src.name, kernels.build_log("path_trace_other", src))
        kernels.load()
        print_ptxas("this", kernels.build_log("path_trace"))
        cfg = Config(grid_resolution=(128, 128, 128), num_samples=SPP, max_bounce=BOUNCES,
                     wave_size=WAVE, seed=SEED)
        for label, path in scene_paths(Path(tmp)):
            scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                          width=WIDTH, height=HEIGHT, device=dev)
            (st0, *_), (st1, prev, *_) = bounce_waves(scene, cam, WIDTH * HEIGHT * SPP)
            for (bounce, state, pv), (name, other) in itertools.product(
                    ((0, st0, None), (1, st1, prev)), others.items()):
                res = compare(scene, state, pv, other)
                faults += res["lanes_off"]
                o, t = res["ms"]["other"], res["ms"]["this"]
                ratio = (o[0] + o[1]) / (t[0] + t[1])
                print(f"{label}, bounce {bounce}, {res['kernel']}: rays {res['rays']}, live "
                      f"{res['live']}, lanes where aux (8 rows, bits), idx or record "
                      f"differ: {res['lanes_off']}; per live ray tiles swept "
                      f"{res['swept']:.2f}, boxes tested {res['tested']:.2f}; {name} "
                      f"{o[0]:.3f}, {o[1]:.3f} ms, this {t[0]:.3f}, {t[1]:.3f} ms (order "
                      f"{name}, this, this, {name}), {name} / this {ratio:.3f} ({card})")
            del scene, st0, st1, prev
            torch.cuda.empty_cache()
    print("FAIL" if faults else "PASS")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
