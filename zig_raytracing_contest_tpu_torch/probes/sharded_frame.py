"""The official frame sharded against ``render_scene``, on the card.

Renders the bench's ``official`` row (1920×1080, 3 spp, 4 bounces, waves
of 2^19 rays) on cuda:0 and times in turns, after two warmups each:
``render_scene``; ``render_scene_sharded`` over ``make_mesh()``; over 4
tiles on cuda:0; and over 4 tiles with ``graph=False`` (the eager loop).
Each frame is timed by the host clock to ``torch.cuda.synchronize()``.
One line of JSON after ``sharded_frame:`` gives each run's median
Mrays/s, best, spread and every rep, whether every sharded image equalled
``render_scene``'s bit for bit with equal segments, and the card.

    python -m zig_raytracing_contest_tpu_torch.probes.sharded_frame [--rounds 7]

To compare with another checkout (its parent, say), run the same command
in each, in turns, in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import bench
from ..parallel import sharding
from ..render import pipeline

TAG = "sharded_frame: "


def measure(rounds: int) -> dict:
    """The timed rounds of this checkout, in this process."""
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
            "sharded 4 tiles": lambda: sharding.render_scene_sharded(scene, cam, cfg, four),
            "sharded 4 tiles eager": lambda: sharding.render_scene_sharded(
                scene, cam, cfg, four, graph=False)}
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
    out = {"card": bench.card_line(), "segments": st.segments, "bit_identical": same}
    for k, r in rates.items():
        med = statistics.median(r)
        out[k] = {"median": med, "best": max(r), "spread": (max(r) - min(r)) / med,
                  "reps": r}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    print(TAG + json.dumps(measure(args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
