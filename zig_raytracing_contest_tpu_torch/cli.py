"""Command-line entry point, flag-compatible with the reference binary.

Reference CLI (src/main.zig:33-39): ``--in`` (default input.gltf), ``--out``
(default output.png), ``--camera`` (name), ``--width``, ``--height``.
Extras, as in the JAX package's CLI: ``--config`` (path to config.json,
default ./config.json), ``--devices`` (device count; only 1 is supported so
far), ``--log-level`` and ``--profile`` (a torch.profiler trace of the
render).  The render runs on the CUDA card when PyTorch sees one, else on
the CPU with the kernels' plain twins.

Run: ``python -m zig_raytracing_contest_tpu_torch --in scene.gltf --out out.png``.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zig_raytracing_contest_tpu_torch",
        description="glTF path tracer (PyTorch + CUDA)",
    )
    p.add_argument("--in", dest="in_path", default="input.gltf")
    p.add_argument("--out", dest="out_path", default="output.png")
    p.add_argument("--camera", default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--config", default="config.json")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--log-level", default="INFO")
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a torch.profiler Chrome trace of the run to DIR",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(levelname)s: %(message)s",
    )
    import torch

    from .config import Config
    from .render.pipeline import render_file

    config = Config.load(args.config)
    if args.devices is not None and args.devices > 1:
        raise NotImplementedError(
            "multi-device pixel tiling (--devices > 1) is ROADMAP queue 1 item 13"
        )
    # The CUDA kernels when PyTorch sees a card, else their CPU twins.
    device = "cuda" if torch.cuda.is_available() else "cpu"
    log = logging.getLogger("zig_raytracing_contest_tpu_torch")
    log.info("Device: %s", device)

    profiler = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()

    stats = render_file(
        args.in_path,
        args.out_path,
        config,
        camera_name=args.camera,
        width=args.width,
        height=args.height,
        device=device,
    )

    if profiler is not None:
        import os

        profiler.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))

    mrays = stats.segments / max(stats.phases.get("render", 1e-9), 1e-9) / 1e6
    log.info("Traced %d segments (%.2f Mrays/s)", stats.segments, mrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
