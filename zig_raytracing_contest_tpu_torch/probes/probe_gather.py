"""A per-lane 2-D gather from one (8, 128) int32 page, repeated, priced per pair.

The counterpart of the JAX package's gather probe (scripts/probe_gather.py
``run``), which asks how fast a TPU core composes two same-shape gathers
(the paged texel fetch's column-then-row fetch): with the page an (8, 128)
``arange`` and ``col`` in [0, 128), ``row`` in [0, 8) drawn from seed 0,

    out = sum over r < reps of take(take(page + r, col, axis=1), row, axis=0)

for reps 1, 64 and 512, checked against the script's NumPy expectation
(``expected``); a gather pair's price is the slope of the time over reps,
and of the SM clock cycles the kernel counts (``loop_cycles``), which do
not move with the card's clock.
``probe_gather_kernel`` (kernels/probes.cu) has two forms: ``smem`` (a
block of 1024 threads, the page and the first gather's result in shared
memory, two indexed loads per rep) and ``shfl`` (a warp, the page in
registers, the column gather by __shfl_sync).  The reps are independent
and int32 addition wraps, so the wrapper spreads them over the card:
``rep_chunks`` cuts [0, reps) into a chunk a slot (SLOTS_PER_SM slots an
SM: a block of 1024 threads an SM for smem, a warp a scheduler for shfl),
folded into the output by atomic adds.
``probe_gather_ref`` is the plain version, ``probe_gather_chunked_ref``
the same sum taken chunk by chunk; two ``torch.gather`` calls are the
library's way to one pair.  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.probe_gather

(``--device cpu`` runs the plain version against the expectation.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels
from ..utils.timing import queued_ms

REPS = (1, 64, 512)
FORMS = kernels.PROBE_GATHER_FORMS
# chunks a streaming multiprocessor takes: one 1024-thread block (smem), a
# warp for each of its four warp schedulers (shfl): of the multiples of the
# SM count in SLOT_SWEEP, the fastest at reps 512 on an H100 (PERF.md)
SLOTS_PER_SM = {"smem": 1, "shfl": 4}
# the multiples of the SM count that main() times at reps 512
SLOT_SWEEP = (1, 2, 4, 8)


def rep_chunks(reps: int, slots: int) -> tuple[int, int]:
    """(chunks, per): [0, ``reps``) cut into at most ``slots`` chunks of
    ``per`` reps, chunk c the reps [c·per, min(reps, (c+1)·per)), none
    empty; one chunk of no reps when ``reps`` is 0."""
    if reps < 0 or slots < 1:
        raise ValueError(f"{reps} repetitions over {slots} slots")
    if reps == 0:
        return 1, 0
    per = -(-reps // min(reps, slots))
    return -(-reps // per), per


def chunk_ranges(reps: int, chunks: int, per: int) -> list:
    """The (first, stop) reps of each chunk, as the kernel's blocks take
    them."""
    return [(c * per, min(reps, (c + 1) * per)) for c in range(chunks)]


def slots(form: str, device) -> int:
    """The slots of ``form`` on the card ``device``: SLOTS_PER_SM per SM."""
    return SLOTS_PER_SM[form] * torch.cuda.get_device_properties(device).multi_processor_count


def make_inputs(seed: int = 0):
    """The script's page, col and row, (8, 128) int32 NumPy arrays."""
    pg = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    rng = np.random.default_rng(seed)
    col = rng.integers(0, 128, (8, 128), dtype=np.int32)
    row = rng.integers(0, 8, (8, 128), dtype=np.int32)
    return pg, col, row


def expected(pg: np.ndarray, col: np.ndarray, row: np.ndarray, reps: int) -> np.ndarray:
    """The script's NumPy expectation: w[s, l] = pg[row[s, l], col[row[s,
    l], l]] + r summed over r < reps."""
    exp = np.zeros((8, 128), np.int64)
    for s in range(8):
        for lane in range(128):
            r0 = row[s, lane]
            exp[s, lane] = pg[r0, col[r0, lane]]
    return exp * reps + sum(range(reps))


def probe_gather_ref(page: torch.Tensor, col: torch.Tensor, row: torch.Tensor,
                     reps: int, first: int = 0) -> torch.Tensor:
    """Plain version of ``probe_gather``: the reps loop of two gathers,
    over the reps [``first``, ``reps``)."""
    c, r = col.long(), row.long()
    acc = torch.zeros_like(page)
    for rep in range(first, reps):
        z = torch.gather(page + rep, 1, c)
        acc += torch.gather(z, 0, r)
    return acc


def probe_gather_chunked_ref(page: torch.Tensor, col: torch.Tensor, row: torch.Tensor,
                             reps: int, slots: int) -> torch.Tensor:
    """The sum as the kernel takes it: ``probe_gather_ref`` of each chunk
    of ``rep_chunks(reps, slots)``, the partials added in int32."""
    acc = torch.zeros_like(page)
    for first, stop in chunk_ranges(reps, *rep_chunks(reps, slots)):
        acc += probe_gather_ref(page, col, row, stop, first)
    return acc


def probe_gather(page: torch.Tensor, col: torch.Tensor, row: torch.Tensor, reps: int,
                 form: str = "smem", n_slots: int | None = None,
                 cycles=None) -> torch.Tensor:
    """Sum over r < ``reps`` of take(take(page + r, col, axis=1), row,
    axis=0) for (8, 128) int32 ``page``, ``col``, ``row``.  A CUDA page
    launches probe_gather_kernel in ``form`` ("smem" or "shfl") over
    ``rep_chunks(reps, n_slots)`` (default ``slots(form, page.device)``),
    with ``cycles`` as ``kernels.launch_probe_gather``; a CPU page runs
    ``probe_gather_ref``."""
    if page.device.type == "cpu":
        return probe_gather_ref(page, col, row, reps)
    if page.device.type != "cuda":
        raise ValueError(f"no probe_gather kernel for device {page.device}")
    chunks, per = rep_chunks(reps, slots(form, page.device) if n_slots is None else n_slots)
    out = torch.empty((8, 128), dtype=torch.int32, device=page.device)
    kernels.launch_probe_gather(page, col, row, reps, chunks, per, form, out, cycles)
    return out


def library_pair(page: torch.Tensor, col: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """One gather pair by two torch.gather calls (the library yardstick,
    not used by the port); ``col``, ``row`` int64."""
    return torch.gather(torch.gather(page, 1, col), 0, row)


def run_checks(device) -> list:
    """Each form at each of REPS on ``device`` against the plain version
    and the NumPy expectation, exactly: a list of (label, elements,
    mismatched elements)."""
    device = torch.device(device)
    pg, col, row = make_inputs()
    t = [torch.from_numpy(a).to(device) for a in (pg, col, row)]
    out = []
    for reps in REPS:
        want = expected(pg, col, row, reps)
        plain = probe_gather_ref(*t, reps).cpu().numpy()
        if not np.array_equal(plain.astype(np.int64), want):
            raise AssertionError(f"probe_gather_ref disagrees with NumPy at reps={reps}")
        forms = FORMS if device.type == "cuda" else ("plain",)
        for form in forms:
            got = probe_gather(*t, reps, form).cpu().numpy()
            out.append((f"{form} reps={reps}", want.size,
                        int((got.astype(np.int64) != want).sum())))
    return out


def loop_cycles(page, col, row, reps: int, form: str) -> int:
    """SM clock cycles of the kernel's reps loop, summed over its chunks,
    the least of 5 launches."""
    cycles = torch.empty(1, dtype=torch.int64, device=page.device)
    best = None
    for _ in range(5):
        probe_gather(page, col, row, reps, form, cycles=cycles)
        best = int(cycles) if best is None else min(best, int(cycles))
    return best


def time_forms(device="cuda") -> dict:
    """Card times of each form at each of REPS: the SM clock cycles of the
    reps loop summed over the chunks and their slope per gather pair (reps
    1 to 512), which do not depend on the clock a lightly loaded card runs
    at; and the device time per call (20 calls queued behind a spin,
    ``queued_ms``) and its slope per pair in microseconds.  Then the plain
    version at reps 1 and the library's pair (two torch.gather calls),
    timed the same way."""
    device = torch.device(device)
    pg, col, row = (torch.from_numpy(a).to(device) for a in make_inputs())
    res = {}
    for form in FORMS:
        cyc = {r: loop_cycles(pg, col, row, r, form) for r in REPS}
        ms = {r: queued_ms(lambda r=r: probe_gather(pg, col, row, r, form), 20)
              for r in REPS}
        res[form] = {"ms": ms, "us_per_pair": (ms[512] - ms[1]) * 1e3 / 511,
                     "cycles": cyc, "cycles_per_pair": (cyc[512] - cyc[1]) / 511,
                     "chunks": {r: rep_chunks(r, slots(form, device)) for r in REPS}}
    res["plain_ms"] = queued_ms(lambda: probe_gather_ref(pg, col, row, 1), 20)
    c, r = col.long(), row.long()
    res["library_ms"] = queued_ms(lambda: library_pair(pg, c, r), 20)
    return res


def time_slots(device="cuda", reps: int = REPS[-1]) -> dict:
    """Device time per call of each form at ``reps`` over SLOT_SWEEP
    multiples of the SM count as its slots (``queued_ms``): {form: {slots:
    ms}}."""
    device = torch.device(device)
    pg, col, row = (torch.from_numpy(a).to(device) for a in make_inputs())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {form: {k * sms: queued_ms(lambda n=k * sms: probe_gather(pg, col, row, reps,
                                                                      form, n), 20)
                   for k in SLOT_SWEEP}
            for form in FORMS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: PyTorch sees no CUDA card; pass --device cpu")
    failures = 0
    for label, n, bad in run_checks(args.device):
        failures += bool(bad)
        print(f"{'FAIL' if bad else 'PASS'} {label}: {bad} of {n} elements differ")
    if args.device == "cuda":
        res = time_forms()
        for form in FORMS:
            ms = res[form]["ms"]
            print(f"{form}: " + ", ".join(f"reps={r} {ms[r] * 1e3:.2f} us" for r in REPS)
                  + f" -> {res[form]['us_per_pair'] * 1e3:.2f} ns per gather pair; "
                  f"{res[form]['cycles_per_pair']:.1f} SM cycles per pair")
        print(f"plain (reps=1) {res['plain_ms'] * 1e3:.2f} us; two torch.gather calls "
              f"{res['library_ms'] * 1e3:.2f} us per pair")
        for form, by_slots in time_slots().items():
            print(f"{form} at reps={REPS[-1]} by slots: " + ", ".join(
                f"{n} ({rep_chunks(REPS[-1], n)[0]} chunks) {ms * 1e3:.2f} us"
                for n, ms in by_slots.items()))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
