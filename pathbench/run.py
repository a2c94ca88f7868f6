"""The benchmark of the port: one run of one cell on the CUDA card.

Run from the checkout's root:

    python -m pathbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints one JSON line last on its standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit)
and the checks again as the last lines of its standard error, after the
card's name and power limit (read once the window has closed, outside
``setup_s``).  With
``--trace 0`` the metrics are the end-to-end ones (``mrays_s``,
``frame_ms_p95``, ``setup_s``), with ``--trace 1`` the cell's per-layer
metrics from a traced window.  Without a CUDA card it exits 2 and prints
no result; where this process holds JAX or the JAX package once the
window has closed, it exits 3 and prints no result.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pathbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell: pathbench/workloads/<name>.json")
    p.add_argument("--seed", type=int, required=True, help="the frame's sample seed")
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    args = p.parse_args(argv)

    from pathbench import harness, spec

    harness.set_build_dirs()
    import torch

    workload = spec.load_workload(args.workload)
    chips = next((w.get("chips", 1) for w in spec.benchmark().get("workloads", [])
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pathbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"cell {workload.name}, seed {args.seed}", file=sys.stderr)
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = harness.loaded_forbidden()
    if found:
        print(f"pathbench: this process holds {found} after the window", file=sys.stderr)
        return 3
    from pathbench.card import card_line

    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    result["device"]["card"] = card
    harness.emit(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
