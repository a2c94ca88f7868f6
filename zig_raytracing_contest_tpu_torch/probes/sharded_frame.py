"""The official frame sharded against ``render_scene``, on the card, for
this checkout and, in the same call, another one (its parent, say).

Renders the bench's ``official`` row (1920×1080, 3 spp, 4 bounces, waves
of 2^19 rays) on cuda:0 and times in turns, after two warmups each:
``render_scene``; ``render_scene_sharded`` over ``make_mesh()``; over 4
tiles on cuda:0; and, where the checkout's sharded frame takes
``graph=``, over 4 tiles with ``graph=False`` (the eager loop).  Each
frame is timed by the host clock to ``torch.cuda.synchronize()``.  One
line of JSON after ``sharded_frame:`` gives each run's median Mrays/s,
best, spread and every rep, whether every sharded image equalled
``render_scene``'s bit for bit with equal segments, and the card.

    python zig_raytracing_contest_tpu_torch/probes/sharded_frame.py [--rounds 7]
    # another checkout beside this one, each side in its own process, in
    # turns (other, this, this, other); e.g. the parent from git archive:
    python zig_raytracing_contest_tpu_torch/probes/sharded_frame.py --against _chip/parent

The package is imported from ``--root`` (default: this checkout), so the
probe measures a checkout that predates it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TAG = "sharded_frame: "


def measure(root: Path, rounds: int) -> dict:
    """The timed rounds of one checkout (its package imported from
    ``root``) in this process."""
    sys.path[0] = str(root)
    import inspect
    import tempfile
    import time

    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch import bench
    from zig_raytracing_contest_tpu_torch.parallel import sharding
    from zig_raytracing_contest_tpu_torch.render import pipeline

    if not torch.cuda.is_available():
        raise SystemExit("this probe measures the card: PyTorch sees no CUDA card")
    dev = torch.device("cuda", 0)
    row = bench.ROW["official"]
    with tempfile.TemporaryDirectory() as d:
        path, _ = bench.write_scene(row, Path(d))
        p = bench.prepare(row, dev, path)
    scene, cam, cfg = p.scene, p.camera, p.config
    four = (dev,) * 4
    runs = {"render_scene": lambda: pipeline.render_scene(scene, cam, cfg),
            "sharded make_mesh()": lambda: sharding.render_scene_sharded(
                scene, cam, cfg, sharding.make_mesh()),
            "sharded 4 tiles": lambda: sharding.render_scene_sharded(scene, cam, cfg, four)}
    if "graph" in inspect.signature(sharding.render_scene_sharded).parameters:
        runs["sharded 4 tiles eager"] = lambda: sharding.render_scene_sharded(
            scene, cam, cfg, four, graph=False)
    want, st = runs["render_scene"]()
    same = True
    for fn in runs.values():
        for _ in range(2):
            img, st_m = fn()
            same &= bool(np.array_equal(img, want)) and st_m.segments == st.segments
    rates = {k: [] for k in runs}
    for _ in range(rounds):
        for k, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, st_m = fn()
            torch.cuda.synchronize()
            rates[k].append(st_m.segments / (time.perf_counter() - t0) / 1e6)
            same &= bool(np.array_equal(img, want)) and st_m.segments == st.segments
    out = {"root": str(root), "card": bench.card_line(), "segments": st.segments,
           "bit_identical": same}
    for k, r in rates.items():
        med = statistics.median(r)
        out[k] = {"median": med, "best": max(r), "spread": (max(r) - min(r)) / med,
                  "reps": r}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose package is measured")
    ap.add_argument("--against", type=Path,
                    help="another checkout, measured in turns with this one")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    if args.against is None:
        print(TAG + json.dumps(measure(args.root.resolve(), args.rounds)), flush=True)
        return 0
    lines = []
    for root in (args.against, args.root, args.root, args.against):
        got = subprocess.run([sys.executable, __file__, "--root", str(root.resolve()),
                              "--rounds", str(args.rounds)], capture_output=True, text=True)
        if got.returncode:
            sys.stderr.write(got.stderr)
            return got.returncode
        line = [x for x in got.stdout.splitlines() if x.startswith(TAG)][-1]
        print(line, flush=True)
        lines.append(json.loads(line[len(TAG):]))
    for side, pair in (("other", lines[0::3]), ("this", lines[1:3])):
        for k in pair[0]:
            if isinstance(pair[0][k], dict):
                print(f"{side} {k}: medians " + " / ".join(f"{r[k]['median']:.3f}"
                                                         for r in pair) + " Mrays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
