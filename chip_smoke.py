#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path (zig_raytracing_contest_tpu_torch) the way a
user does, on the official bench frame: the bench scene, 1920×1080, 3 spp,
4 bounces, waves of 2^19 rays.  Phases, each of which exits non-zero when
it fails:

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from kernels/path_trace.cu (nvcc) and print the build
   time and ptxas report;
3. build the bench scene with the port's own procedural module;
4. hold each kernel against its plain PyTorch twin on the card, on the same
   inputs and in the main path's order (bounce 0, sort, bounce 1, resort,
   bounces 2-3): one wave of 2^16 rays, then one full wave of the main path
   (522240 rays), timing both at the full wave;
5. render a 320×180, 3 spp, 4-bounce frame with the kernels and with the
   twins and hold them to the golden gates;
6. render the official frame: a warmup, then 5 timed renders; the kernel
   launch counts of these renders show the main path ran the kernels;
7. profile one more official frame: device time by kernel and the
   device's idle share.

Run from the repository root: ``python3 chip_smoke.py``.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, its largest difference from the twin
and its time beside the twin's.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SPP = 3
MAX_BOUNCE = 4
WAVE = 1 << 19
SEED = 0
SOURCE = "zig_raytracing_contest_tpu_torch/kernels/path_trace.cu"
# (kernel, wrapper, TPU kernel it replaces)
KERNELS = [
    ("path_trace_gen_kernel", "path_trace_gen",
     "zig_raytracing_contest_tpu/render/fused.py:1031"),
    ("path_trace_kernel", "path_trace_fused",
     "zig_raytracing_contest_tpu/render/fused.py:1111"),
]
# Kernel vs twin: rows 12-15 (alive, streams, segments, key) and the winner
# index exactly; value rows 0-11 to f32 rounding of libm differences;
# direction rows (3-5, after rsqrt/log/sin/cos) to 1e-5.
RTOL, ATOL, DIR_ATOL = 3e-6, 1e-6, 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def compare(name, k_state, k_idx, t_state, t_idx):
    """Mismatch counts and the largest value difference, kernel vs twin."""
    import torch

    exact_rows = (k_state[12:16].view(torch.int32) != t_state[12:16].view(torch.int32))
    n_exact = int(exact_rows.any(dim=0).sum())
    n_idx = 0 if k_idx is None else int((k_idx != t_idx).sum())
    ok_val = torch.isclose(k_state[0:12], t_state[0:12], rtol=RTOL, atol=ATOL)
    ok_dir = torch.isclose(k_state[3:6], t_state[3:6], rtol=0.0, atol=DIR_ATOL)
    ok_val[3:6] = ok_dir
    n_val = int((~ok_val).any(dim=0).sum())
    err = float((k_state[0:12] - t_state[0:12]).abs().max())
    print(f"  {name}: rays {k_state.shape[1]}, mismatched rows 12-15: {n_exact}, "
          f"idx: {n_idx}, rows 0-11 beyond tolerance: {n_val}, "
          f"max |diff| rows 0-11: {err:.3e}")
    if n_exact or n_idx or n_val:
        fail(f"{name} disagrees with its plain twin")
    return err


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_frame(render_scene, scene, cam, cfg, card) -> None:
    """Where one official frame's time goes: torch.profiler's CUDA kernel
    time by name against the frame's wall time (the rest is device idle)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_scene(scene, cam, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if str(e.device_type).endswith("CUDA") and e.device_time_total > 0
    ]
    busy_ms = sum(k[0] for k in kernels)
    if not kernels:
        print(f"profile: frame wall {wall_ms:.1f} ms; device time not measured")
        return
    print(f"profile: frame wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(k[1] for k in kernels)} device ops ({card})")
    for ms, n, key in sorted(kernels, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  x{n:<5d} {key[:80]}")


def main() -> int:
    import torch

    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.pipeline import (
        prepare_scene,
        render_scene,
        slot_geometry,
    )
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        ray_sort_key,
        sort_state_payload,
    )
    from zig_raytracing_contest_tpu_torch.scene.procedural import bench_scene

    # 2. build
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.BUILD_INFO['seconds']} s)")
    for line in kernels.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    # 3. the bench scene, through the port
    tmp = tempfile.TemporaryDirectory()
    path = bench_scene(Path(tmp.name) / "bench.gltf")
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=SPP,
                 max_bounce=MAX_BOUNCE, wave_size=WAVE, seed=SEED)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=1920, height=1080, device=dev)
    print(f"scene: tri_data {tuple(scene.tri_data.shape)}, tiles "
          f"{scene.tile_bbox.shape[1]}, texels {scene.bank.shape[0]}, "
          f"emissive_dummy {scene.emissive_dummy}")

    # 4. kernels vs twins on the card
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    num_slots, tiles_x = slot_geometry(1920, 1080)
    gen = fused.GenParams(spp=SPP, width=1920, img_w=1920, img_h=1080,
                          tiles_x=tiles_x)
    quantum = SPP * 1024
    full_wave = WAVE // quantum * quantum
    errs = {"path_trace_gen": 0.0, "path_trace_fused": 0.0}
    timing = {}
    for R, slot_base in ((1 << 16, 1024 * 900), (full_wave, 5 * (full_wave // SPP))):
        meta = (slot_base, slot_base % 1920, slot_base // 1920, SEED,
                slot_base // 1024, 0, 0, 0)
        args = (scene, par, meta, R, 1, gen)
        k_state, k_idx = fused.path_trace_gen(*args, emit_key=True, emit_idx=True)
        t_state, t_idx = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True)
        torch.cuda.synchronize()
        errs["path_trace_gen"] = max(errs["path_trace_gen"], compare(
            "path_trace_gen (bounce 0, key, idx)", k_state, k_idx, t_state, t_idx))
        key = k_state[15].contiguous().view(torch.int32)
        _, st, (idx_s,) = sort_state_payload(key, k_state, (k_idx,))
        k2, ki2 = fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx_s, emit_idx=True)
        t2, ti2 = fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx_s,
                                             emit_idx=True)
        torch.cuda.synchronize()
        errs["path_trace_fused"] = max(errs["path_trace_fused"], compare(
            "path_trace_fused (bounce 1 after the sort, prev)", k2, ki2, t2, ti2))
        # the main path's last call: resort on the host key, bounces 2-3
        _, st2, (idx2,) = sort_state_payload(ray_sort_key(scene, k2), k2, (ki2,))
        k3 = fused.path_trace_fused(scene, st2, 2, bounce0=2, prev=idx2)
        t3 = fused.path_trace_fused_ref(scene, st2, 2, bounce0=2, prev=idx2)
        torch.cuda.synchronize()
        errs["path_trace_fused"] = max(errs["path_trace_fused"], compare(
            "path_trace_fused (bounces 2-3 after the resort, prev)", k3, None, t3, None))
        if R == full_wave:
            timing["path_trace_gen"] = (
                cuda_ms(lambda: fused.path_trace_gen(*args, emit_key=True, emit_idx=True), 5),
                cuda_ms(lambda: fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True), 2),
            )
            timing["path_trace_fused"] = (
                cuda_ms(lambda: fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx_s,
                                                       emit_idx=True), 5),
                cuda_ms(lambda: fused.path_trace_fused_ref(scene, st, 1, bounce0=1,
                                                           prev=idx_s, emit_idx=True), 2),
            )
    for name, (k_ms, p_ms) in timing.items():
        print(f"  {name} at {full_wave} rays: kernel {k_ms:.3f} ms, plain twin "
              f"{p_ms:.3f} ms ({card})")

    # 5. a small frame, kernels vs twins
    small_cfg = Config(num_samples=SPP, max_bounce=MAX_BOUNCE, seed=SEED)
    s_scene, s_cam, _ = prepare_scene(str(path), small_cfg, camera_name="Camera 1",
                                      width=320, height=180, device=dev)
    img_k, st_k = render_scene(s_scene, s_cam, small_cfg)
    img_t, st_t = render_scene(s_scene, s_cam, small_cfg, plain=True)
    diff = abs(img_k.astype(int) - img_t.astype(int))
    frac, mean = float((diff > 2).mean()), float(diff.mean())
    seg_rel = abs(st_k.segments - st_t.segments) / max(st_t.segments, 1)
    print(f"frame 320x180: diff>2 on {frac:.4%} of channels, mean |diff| {mean:.4f}, "
          f"segments {st_k.segments} vs {st_t.segments} ({seg_rel:.4%})")
    if not (frac < 0.06 and mean < 1.5 and seg_rel < 0.005):
        fail("320x180 frame: kernels and twins disagree beyond the golden gates")
    if img_k.shape != (180, 320, 3):
        fail(f"frame shape {img_k.shape}")

    # 6. the official frame, through the main path
    fused.reset_launches()
    img, stats = render_scene(scene, cam, cfg)  # warmup
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        img, stats = render_scene(scene, cam, cfg)
        torch.cuda.synchronize()
        rates.append(stats.segments / (time.perf_counter() - t0) / 1e6)
    launches = dict(fused.LAUNCHES)
    if img.shape != (1080, 1920, 3) or not 0 < float(img.mean()) < 255:
        fail(f"official frame: shape {img.shape}, mean {float(img.mean())}")
    num_waves = -(-num_slots * SPP // full_wave)
    for name in ("path_trace_gen", "path_trace_fused"):
        if launches[name] == 0:
            fail(f"{name}: the main path launched no kernel")
    if launches["path_trace_gen"] != 6 * num_waves:
        fail(f"path_trace_gen launched {launches['path_trace_gen']} times, "
             f"expected {6 * num_waves}")
    med, best = statistics.median(rates), max(rates)
    spread = (max(rates) - min(rates)) / med * 100
    print(f"official 1920x1080 {SPP} spp {MAX_BOUNCE} bounces: median {med:.3f} "
          f"Mrays/s, best {best:.3f}, spread {spread:.1f}%, segments "
          f"{stats.segments}, waves {num_waves} of {full_wave} rays ({card})")
    print("  reps Mrays/s: " + ", ".join(f"{r:.3f}" for r in rates))
    profile_frame(render_scene, scene, cam, cfg, card)

    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[wrapper], "max_abs_err": errs[wrapper],
         "ms": timing[wrapper][0], "plain_ms": timing[wrapper][1]}
        for kname, wrapper, replaces in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
