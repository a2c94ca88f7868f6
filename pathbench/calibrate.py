"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process.

For every ``--seeds`` seed the program renders the cell's frame as the
window does (the warm-up, the capture, then a replay of the frame's CUDA
graph, whose image is judged) and ``compare.judge`` holds it to the
float32 frame of the cell's reference (``spec.load_reference``, as a run
finds it).  For every ``--control-seeds`` seed the control, that
reference computed in bfloat16 (the precision below the float32 the
renderer states), is put in the program's place and judged the same way:
it has to come out not correct.  The lower reading of a number is the
largest of the program's, the upper the smallest of the control's.

Run from the checkout's root, on the card:

    python -m pathbench.calibrate --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

It prints one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pathbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma-separated seeds of the program")
    p.add_argument("--control-seeds", default="", help="comma-separated seeds of the control")
    args = p.parse_args(argv)

    from pathbench import compare, harness, spec
    from pathbench.scenes import scene_file

    harness.set_build_dirs()
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene

    if not torch.cuda.is_available():
        print("pathbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    workload = spec.load_workload(args.workload)
    tr = workload.traffic
    path = scene_file(workload.config, harness.cache_root())
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    scene, camera, _ = prepare_scene(str(path), harness.program_config(tr, 0),
                                     workload.config["camera"], tr.width, tr.height,
                                     device="cuda")
    ref = spec.load_reference(workload.reference).prepare(workload, path, "cuda")

    def judged(frame, seed):
        t = time.perf_counter()
        image, segments = ref.render(seed)
        ref_s = time.perf_counter() - t
        ok, _, checks = compare.judge([frame], image, segments, None, workload)
        row = {"seed": seed, "correct": ok, "ref_s": ref_s,
               **{k: v["value"] for k, v in checks.items()}}
        print(json.dumps(row), file=sys.stderr, flush=True)
        return row

    out = {"workload": args.workload, "program": [], "control": []}
    for seed in seeds:
        cfg = harness.program_config(tr, seed)
        for _ in range(2):  # warm-up, capture
            render_scene(scene, camera, cfg)
        kernels.reset_launches()
        image, stats = render_scene(scene, camera, cfg)  # a replay, as in the window
        row = judged((0, image, stats.segments), seed)
        row["launched"] = sorted(k for k, v in kernels.LAUNCHES.items() if v)
        scene.frame_cache().clear()
        out["program"].append(row)
    for seed in controls:
        low, low_segments = ref.render(seed, torch.bfloat16)
        out["control"].append(judged((0, low, low_segments), seed))
    for key in ("image_mad", "segments_gap"):
        if out["program"]:
            out[f"lower_{key}"] = max(r[key] for r in out["program"])
        if out["control"]:
            out[f"upper_{key}"] = min(r[key] for r in out["control"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
