"""Two builds of the trace micro-benchmarks on the same inputs: bits and time.

``micro_trace_kernel`` and ``micro_bf16_kernel`` of this checkout's
kernels/probes.cu against those of another probes.cu whose
``zrc_micro_trace`` and ``zrc_micro_bf16`` take the same arguments (an
earlier commit's, written out by ``git show
<commit>:zig_raytracing_contest_tpu_torch/kernels/probes.cu``, or a variant
of this one; ``--against`` may be given more than once), on the probes'
own inputs: micro_trace's bank and 2^18 rays
in every variant (u/v extraction, cull none / lane / warp, 128 / 256 / 512
threads), micro_bf16's bank and 512 rays in f32 and bf16 at 16,384 and
65,536 iterations.  Both builds run each variant; their outputs (aux's 8
rows and idx, or the best t, as bits) must be equal, or the run fails.
Then each build is timed on it in alternating pairs (other, this, this,
other; CUDA events over REPS launches after a warmup; micro_bf16's
launches include the +inf fill of the output they fold into), and
micro_bf16's price per sweep is the slope between the two counts.  Run on
the card:

    python -m zig_raytracing_contest_tpu_torch.probes.probe_ab --against OTHER.cu \\
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
from ..utils.timing import cuda_ms
from . import micro_bf16, micro_trace
from .trace_ab import card_line, print_ptxas

REPS = 5
KERNELS = ("micro_trace_kernel", "micro_bf16_kernel")
ORDER = ("other", "this", "this", "other")


def trace_calls(device) -> list:
    """(label, launch, outputs) of every micro_trace variant on the probe's
    bank and rays: ``launch(lib, aux, idx)``; ``outputs()`` a fresh (aux,
    idx) pair."""
    tris = micro_trace.make_bank(0)
    state = torch.from_numpy(micro_trace.make_state(1)).to(device)
    tri = torch.from_numpy(tris.tri_data).to(device)
    bbox = torch.from_numpy(tris.tile_bbox).to(device)
    R = state.shape[1]

    def outputs():
        return (torch.empty((8, R), dtype=torch.float32, device=device),
                torch.empty((1, R), dtype=torch.int32, device=device))

    return [(f"micro_trace {micro_trace.label((uv, cull, th))}",
             lambda lib, aux, idx, v=(uv, cull, th): kernels.launch_micro_trace(
                 tri, bbox, tris.tile, state, v[1], v[0], v[2], aux, idx, lib),
             outputs)
            for uv, cull, th in micro_trace.variants()]


def sweep_calls(device) -> list:
    """(label, launch, outputs) of micro_bf16 per working type and count:
    ``launch(lib, best)`` fills ``best`` with +inf and folds into it."""
    bank, states = micro_bf16.device_inputs(device)
    L = micro_bf16.LB

    def outputs():
        return (torch.empty((1, L), dtype=torch.float32, device=device),)

    def launch(lib, best, state, iters):
        best.fill_(float("inf"))
        kernels.launch_micro_bf16(bank, state, iters, best, lib)

    return [(f"micro_bf16 {str(dt).split('.')[1]} iters={iters}",
             lambda lib, best, st=states[dt], it=iters: launch(lib, best, st, it), outputs)
            for dt in micro_bf16.DTYPES for iters in (micro_bf16.ITERS_LO, micro_bf16.ITERS_HI)]


def compare(launch, outputs, other) -> dict:
    """Both builds on one call: the lanes (columns) where an output differs
    as bits, and each build's ms in the order other, this, this, other."""
    outs = {"other": outputs(), "this": outputs()}
    libs = {"other": other, "this": None}
    ms = {name: [] for name in outs}
    for name in ORDER:
        ms[name].append(cuda_ms(lambda: launch(libs[name], *outs[name]), REPS))
    off = None
    for a, b in zip(outs["other"], outs["this"]):
        d = (a.view(torch.int32) != b.view(torch.int32)).any(dim=0)
        off = d if off is None else off | d
    return {"lanes_off": int(off.sum()), "lanes": int(off.numel()), "ms": ms}


def build_others(sources, build_dir: Path) -> dict:
    """Each other probes.cu built into its own directory under
    ``build_dir`` beside this checkout's (one nvcc each, all started
    together), loaded, by file name."""
    dirs = [build_dir / str(k) for k in range(len(sources))]
    jobs = [("probes",)] + [("probes_other", src, d) for src, d in zip(sources, dirs)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda a: kernels.build(*a), jobs))
    return {src.name: kernels.load_probes_library(src, d) for src, d in zip(sources, dirs)}


def run(other, device) -> list:
    """Every call of both kernels through both builds: a list of (label,
    ``compare`` result)."""
    return [(label, compare(launch, outputs, other))
            for label, launch, outputs in trace_calls(device) + sweep_calls(device)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", required=True, type=Path, action="append",
                   help="another probes.cu (same zrc_micro_trace and zrc_micro_bf16 "
                        "arguments); may be given more than once")
    p.add_argument("--build-dir", type=Path, default=None,
                   help="where to build them (default: a temporary directory)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("PyTorch sees no CUDA card: both builds run on the card")
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    lo, hi = micro_bf16.ITERS_LO, micro_bf16.ITERS_HI
    faults = 0
    with tempfile.TemporaryDirectory() as tmp:
        others = build_others(args.against, args.build_dir or Path(tmp) / "b")
        kernels.load_probes()
        for src in args.against:
            print_ptxas(src.name, kernels.build_log("probes_other", src), KERNELS)
        print_ptxas("this", kernels.build_log("probes"), KERNELS)
        for name, other in others.items():
            results = run(other, dev)
            for label, res in results:
                faults += res["lanes_off"]
                o, t = res["ms"]["other"], res["ms"]["this"]
                print(f"{label}: {res['lanes_off']} of {res['lanes']} lanes differ (bits); "
                      f"{name} {o[0]:.4f}, {o[1]:.4f} ms, this {t[0]:.4f}, {t[1]:.4f} ms "
                      f"(order {name}, this, this, {name}), {name} / this "
                      f"{(o[0] + o[1]) / (t[0] + t[1]):.3f} ({card})")
            res = dict(results)
            for dt in ("float32", "bfloat16"):
                a = res[f"micro_bf16 {dt} iters={lo}"]["ms"]
                b = res[f"micro_bf16 {dt} iters={hi}"]["ms"]
                slope = {who: (sum(b[who]) - sum(a[who])) / 2 * 1e3 / (hi - lo) for who in a}
                print(f"micro_bf16 {dt} per (128x{micro_bf16.LB}) sweep: {name} "
                      f"{slope['other']:.5f} us, this {slope['this']:.5f} us ({card})")
    print("FAIL" if faults else "PASS")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
