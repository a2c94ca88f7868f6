"""Two builds of the probe kernels on the same inputs: bits and time.

``micro_trace_kernel``, ``micro_bf16_kernel`` and ``probe_gather_kernel``
of this checkout's kernels/probes.cu against those of another probes.cu
whose ``zrc_micro_trace`` and ``zrc_micro_bf16`` take the same arguments
(an earlier commit's, written out by ``git show
<commit>:zig_raytracing_contest_tpu_torch/kernels/probes.cu``, or a variant
of this one; ``--against`` may be given more than once), on the probes'
own inputs: micro_trace's bank and 2^18 rays in every variant (u/v
extraction, cull none / lane / warp, 128 / 256 / 512 threads),
micro_bf16's bank and 512 rays in f32 and bf16 at 16,384 and 65,536
iterations, probe_gather's page in both forms at reps 1, 64 and 512 (an
earlier build without the chunked entry point runs each call in one
block).  Both builds run each call;
their outputs (as bits) must be equal, or the run fails.  Then each build
is timed on it in alternating pairs (other, this, this, other): the trace
micro-benchmarks by CUDA events over REPS launches after a warmup
(micro_bf16's launches include the +inf fill of the output they fold
into), the gather calls, which take a few microseconds, by
``queued_ms`` (QUEUED calls queued behind a spin, so the host's launch
gap is not timed); micro_bf16's price per sweep is the slope between the
two counts.  ``--only`` keeps the calls whose label holds one of the
given words.  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.probe_ab --against OTHER.cu \\
        [--against VARIANT.cu ...] [--only probe_gather ...] [--build-dir DIR]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import kernels
from ..utils.timing import cuda_ms, queued_ms
from . import micro_bf16, micro_trace, probe_gather
from .trace_ab import card_line, print_ptxas

REPS = 5
QUEUED = 20
KERNELS = ("micro_trace_kernel", "micro_bf16_kernel", "probe_gather_smem_kernel",
           "probe_gather_shfl_kernel")
ORDER = ("other", "this", "this", "other")


def events(fn) -> float:
    return cuda_ms(fn, REPS)


def queued(fn) -> float:
    return queued_ms(fn, QUEUED)


def trace_calls(device) -> list:
    """(label, launch, outputs, timer) of every micro_trace variant on the
    probe's bank and rays: ``launch(lib, aux, idx)``; ``outputs()`` a fresh
    (aux, idx) pair; ``timer(fn)`` the ms of a call."""
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
             outputs, events)
            for uv, cull, th in micro_trace.variants()]


def sweep_calls(device) -> list:
    """(label, launch, outputs, timer) of micro_bf16 per working type and
    count: ``launch(lib, best)`` fills ``best`` with +inf and folds into
    it."""
    bank, states = micro_bf16.device_inputs(device)
    L = micro_bf16.LB

    def outputs():
        return (torch.empty((1, L), dtype=torch.float32, device=device),)

    def launch(lib, best, state, iters):
        best.fill_(float("inf"))
        kernels.launch_micro_bf16(bank, state, iters, best, lib)

    return [(f"micro_bf16 {str(dt).split('.')[1]} iters={iters}",
             lambda lib, best, st=states[dt], it=iters: launch(lib, best, st, it), outputs,
             events)
            for dt in micro_bf16.DTYPES for iters in (micro_bf16.ITERS_LO, micro_bf16.ITERS_HI)]


def gather_calls(device) -> list:
    """(label, launch, outputs, timer) of probe_gather per form and reps on
    the probe's page, over this checkout's chunks (``launch(lib, out)``)."""
    page, col, row = (torch.from_numpy(a).to(device) for a in probe_gather.make_inputs())

    def outputs():
        return (torch.empty((8, 128), dtype=torch.int32, device=device),)

    def launch(lib, out, reps, form):
        chunks, per = probe_gather.rep_chunks(reps, probe_gather.slots(form, device))
        kernels.launch_probe_gather(page, col, row, reps, chunks, per, form, out, None, lib)

    return [(f"probe_gather {form} reps={reps}",
             lambda lib, out, r=reps, f=form: launch(lib, out, r, f), outputs, queued)
            for form in probe_gather.FORMS for reps in probe_gather.REPS]


def compare(launch, outputs, timer, other) -> dict:
    """Both builds on one call: the lanes (columns) where an output differs
    as bits, and each build's ms in the order other, this, this, other."""
    outs = {"other": outputs(), "this": outputs()}
    libs = {"other": other, "this": None}
    ms = {name: [] for name in outs}
    for name in ORDER:
        ms[name].append(timer(lambda: launch(libs[name], *outs[name])))
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


def keep(calls, only) -> list:
    return [c for c in calls if not only or any(w in c[0] for w in only)]


def report(name: str, results, card: str) -> int:
    """Print each call's bits and times against build ``name``; the lanes
    that differ, summed."""
    faults = 0
    for label, res in results:
        faults += res["lanes_off"]
        o, t = res["ms"]["other"], res["ms"]["this"]
        print(f"{label}: {res['lanes_off']} of {res['lanes']} lanes differ (bits); "
              f"{name} {o[0]:.5f}, {o[1]:.5f} ms, this {t[0]:.5f}, {t[1]:.5f} ms "
              f"(order {name}, this, this, {name}), {name} / this "
              f"{(o[0] + o[1]) / (t[0] + t[1]):.3f} ({card})")
    res = dict(results)
    lo, hi = micro_bf16.ITERS_LO, micro_bf16.ITERS_HI
    for dt in ("float32", "bfloat16"):
        a, b = res.get(f"micro_bf16 {dt} iters={lo}"), res.get(f"micro_bf16 {dt} iters={hi}")
        if a and b:
            a, b = a["ms"], b["ms"]
            slope = {who: (sum(b[who]) - sum(a[who])) / 2 * 1e3 / (hi - lo) for who in a}
            print(f"micro_bf16 {dt} per (128x{micro_bf16.LB}) sweep: {name} "
                  f"{slope['other']:.5f} us, this {slope['this']:.5f} us ({card})")
    return faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", required=True, type=Path, action="append",
                   help="another probes.cu (same zrc_micro_trace and zrc_micro_bf16 "
                        "arguments); may be given more than once")
    p.add_argument("--only", action="append", default=[],
                   help="run only the calls whose label holds this word (repeatable)")
    p.add_argument("--build-dir", type=Path, default=None,
                   help="where to build them (default: a temporary directory)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("PyTorch sees no CUDA card: both builds run on the card")
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    faults = 0
    with tempfile.TemporaryDirectory() as tmp:
        others = build_others(args.against, args.build_dir or Path(tmp) / "b")
        kernels.load_probes()
        for src in args.against:
            print_ptxas(src.name, kernels.build_log("probes_other", src), KERNELS)
        print_ptxas("this", kernels.build_log("probes"), KERNELS)
        calls = keep(trace_calls(dev) + sweep_calls(dev) + gather_calls(dev), args.only)
        for name, other in others.items():
            results = [(label, compare(launch, outputs, timer, other))
                       for label, launch, outputs, timer in calls]
            faults += report(name, results, card)
    print("FAIL" if faults else "PASS")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
