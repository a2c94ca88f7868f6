"""The trace sweep's operation mix with an f32 or a bf16 transform, priced per sweep.

The counterpart of the JAX package's bf16 micro-benchmark
(scripts/micro_bf16.py ``build``): a bank of 64 tiles of 128 triangles
(13, 8192) f32 and 512 rays (6, 512) in the working type; ``iters`` sweeps,
sweep i over tile i mod 64: the transform in the working type (each
product and sum rounded to it), then in f32 t, u, v, the det test and a
min fold of the positive t into ``best`` (1, 512) f32.  A sweep's price is
the slope of the time between ITERS_LO and ITERS_HI iterations, in which a
launch's fixed cost cancels.

``micro_bf16_kernel`` (kernels/probes.cu) cuts the iterations into 256
chunks run by separate blocks and folds each lane's minimum with atomicMin
on the f32 bits; ``micro_bf16_ref`` is the plain version,
``micro_bf16_staged_ref`` models the kernel's staged test (the same bits,
and the pairs each stage takes).  Sweep i reads
tile i mod 64 and a min is idempotent, so ``iters`` sweeps give the min
over the first min(iters, 64) tiles: the plain version computes that, so
its time is that of 64 sweeps whatever ``iters`` is.
Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.micro_bf16

(``--device cpu`` runs the plain version against itself.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels
from . import micro_trace
from ..utils.timing import best_ms, cuda_ms

K = kernels.MICRO_BF16_TILE  # triangles per tile
NT = 64  # distinct tiles in the bank
LB = 512  # lanes (rays)
ITERS_LO, ITERS_HI = 16384, 65536
DTYPES = (torch.float32, torch.bfloat16)
_CHUNK_TILES = 8  # tiles per step of the plain version


def make_inputs(seed: int = 0):
    """The script's bank (13, NT·K) f32 and f32 state (6, LB), as NumPy."""
    g = np.random.default_rng(seed)
    bank = g.uniform(-2, 2, (13, NT * K)).astype(np.float32)
    st = np.zeros((6, LB), np.float32)
    st[0:3] = g.uniform(-8, 8, (3, LB))
    d = g.standard_normal((3, LB))
    st[3:6] = d / np.linalg.norm(d, axis=0, keepdims=True)
    return bank, st


def micro_bf16_ref(bank: torch.Tensor, state: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of ``micro_bf16``: (1, L) f32 min over the first
    min(iters, nt) tiles of each lane's positive hit t (+inf if none)."""
    dt = state.dtype
    nt = bank.shape[1] // K
    tiles = min(iters, nt)
    ox, oy, oz, dx, dy, dz = (state[a][None, :] for a in range(6))
    best = torch.full((state.shape[1],), float("inf"), dtype=torch.float32,
                      device=state.device)
    for t0 in range(0, tiles, _CHUNK_TILES):
        rows = bank[:, t0 * K:min(tiles, t0 + _CHUNK_TILES) * K]
        m = [rows[r][:, None].to(dt) for r in range(12)]
        ou = (m[0] * ox + m[1] * oy + m[2] * oz + m[9]).float()
        ov = (m[3] * ox + m[4] * oy + m[5] * oz + m[10]).float()
        ow = (m[6] * ox + m[7] * oy + m[8] * oz + m[11]).float()
        du = (m[0] * dx + m[1] * dy + m[2] * dz).float()
        dv = (m[3] * dx + m[4] * dy + m[5] * dz).float()
        dw = (m[6] * dx + m[7] * dy + m[8] * dz).float()
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        det = -dw * rows[12][:, None]
        ok = (det >= 1e-8) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        t = torch.where(ok, t, float("inf"))
        best = torch.minimum(best, t.min(dim=0).values)
    return best[None, :]


def micro_bf16_staged_ref(bank: torch.Tensor, state: torch.Tensor, iters: int):
    """Plain model of micro_bf16_kernel's staged order: (best (1, L) f32,
    counts).  Stage 1 (dw, ow in the working type, the det and sign tests)
    for every pair, stage 2 (ou, ov, du, dv in the working type, t, u, v in
    f32) for the pairs it passes on, each value computed as
    ``micro_bf16_ref`` computes it.  counts, over the ``iters`` sweeps
    (sweep i over tile i mod nt): "swept" pairs, "stage2" pairs and "hits"
    (pairs the full test accepts)."""
    dt = state.dtype
    nt = bank.shape[1] // K
    ox, oy, oz, dx, dy, dz = (state[a][None, :] for a in range(6))
    best = torch.full((state.shape[1],), float("inf"), dtype=torch.float32,
                      device=state.device)
    counts = {"swept": 0, "stage2": 0, "hits": 0}
    for j in range(min(iters, nt)):
        sweeps = (iters - j + nt - 1) // nt  # the sweeps over tile j
        rows = bank[:, j * K:(j + 1) * K]
        m = [rows[r][:, None].to(dt) for r in range(12)]
        dw = (m[6] * dx + m[7] * dy + m[8] * dz).float()
        ow = (m[6] * ox + m[7] * oy + m[8] * oz + m[11]).float()
        s1 = micro_trace.front_and_ahead(dw, ow, rows[12][:, None])
        k, lane = s1.nonzero(as_tuple=True)
        mk = [x[k, 0] for x in m]
        pox, poy, poz, pdx, pdy, pdz = (c[0, lane] for c in (ox, oy, oz, dx, dy, dz))
        ou = (mk[0] * pox + mk[1] * poy + mk[2] * poz + mk[9]).float()
        ov = (mk[3] * pox + mk[4] * poy + mk[5] * poz + mk[10]).float()
        du = (mk[0] * pdx + mk[1] * pdy + mk[2] * pdz).float()
        dv = (mk[3] * pdx + mk[4] * pdy + mk[5] * pdz).float()
        t = -ow[k, lane] / dw[k, lane]
        u = ou + t * du
        v = ov + t * dv
        ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        best.scatter_reduce_(0, lane[ok], t[ok], "amin")
        counts["swept"] += sweeps * dw.numel()
        counts["stage2"] += sweeps * int(s1.sum())
        counts["hits"] += sweeps * int(ok.sum())
    return best[None, :], counts


def boundary_inputs():
    """The staged test's boundary cases as micro_bf16's inputs (NumPy):
    (bank (13, 128), state (6, L) f32).  The rays and rows of
    ``micro_trace.boundary_inputs`` (ray c: o = (0, c, 0), d = (1, 0, 0);
    dw = M6, ow = c11): ow = ±0, ow of dw's sign, det at 1e-8 and below,
    subnormal and huge t, an infinite ow and NaN rows; values are exact in
    bf16 where the case needs them so."""
    tri_data, _, _, st16 = micro_trace.boundary_inputs()
    bank = np.zeros((13, K), np.float32)
    n = min(K, tri_data.shape[1])
    bank[:, :n] = tri_data[:13, :n]
    bank[6, n:] = 1.0  # padding: dw = 1, det fails
    return bank, np.ascontiguousarray(st16[0:6])


def micro_bf16(bank: torch.Tensor, state: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` sweeps of ``bank`` (13, nt·128) f32 against the rays of
    ``state`` (6, L) f32 or bf16, the transform in ``state``'s type: the
    min positive t per lane, (1, L) f32.  A CUDA state launches
    micro_bf16_kernel, a CPU state runs ``micro_bf16_ref``."""
    if state.device.type == "cpu":
        return micro_bf16_ref(bank, state, iters)
    if state.device.type != "cuda":
        raise ValueError(f"no micro_bf16 kernel for device {state.device}")
    best = torch.full((1, state.shape[1]), float("inf"), dtype=torch.float32,
                      device=state.device)
    kernels.launch_micro_bf16(bank, state, iters, best)
    return best


def device_inputs(device, seed: int = 0):
    """(bank, {dtype: state}) on ``device``."""
    bank, st = make_inputs(seed)
    st32 = torch.from_numpy(st).to(device)
    return torch.from_numpy(bank).to(device), {dt: st32.to(dt) for dt in DTYPES}


def bf16_error(best32: torch.Tensor, best16: torch.Tensor) -> tuple[float, int]:
    """(largest relative error of the bf16 best t where both hit, lanes
    whose hit flips: one finds a hit, the other none)."""
    f32, f16 = torch.isfinite(best32), torch.isfinite(best16)
    both = f32 & f16
    rel = ((best16[both] - best32[both]).abs() / best32[both]).max() if bool(both.any()) else 0
    return float(rel), int((f32 != f16).sum())


def run_checks(device) -> list:
    """The kernel against its plain version on ``device`` for each working
    type at ITERS_LO and ITERS_HI iterations, bit for bit: a list of (label,
    lanes, mismatched lanes)."""
    device = torch.device(device)
    bank, states = device_inputs(device)
    out = []
    for dt in DTYPES:
        want = micro_bf16_ref(bank, states[dt], NT)
        for iters in (ITERS_LO, ITERS_HI):
            got = micro_bf16(bank, states[dt], iters)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            out.append((f"{str(dt).split('.')[1]} iters={iters}", LB, bad))
    return out


def boundary_checks(device) -> list:
    """The kernel against its plain version on the staged test's boundary
    cases (``boundary_inputs``) in each working type, at 1 and 3 sweeps of
    the one tile, bit for bit: a list of (label, lanes, mismatched lanes)."""
    bank, st = (torch.from_numpy(a).to(device) for a in boundary_inputs())
    out = []
    for dt in DTYPES:
        for iters in (1, 3):
            got = micro_bf16(bank, st.to(dt), iters)
            want = micro_bf16_ref(bank, st.to(dt), iters)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            out.append((f"boundary cases {str(dt).split('.')[1]} iters={iters}",
                        st.shape[1], bad))
    return out


def time_sweeps(device="cuda") -> dict:
    """Card times per working type: the kernel at ITERS_LO and ITERS_HI
    iterations (best of 5 single launches), the slope per (128 x 512)
    sweep in microseconds, the plain version (one call, which sweeps the
    64 distinct tiles once) and its time per sweep, and the bf16 best t's
    error against f32."""
    device = torch.device(device)
    bank, states = device_inputs(device)
    res = {}
    for dt in DTYPES:
        name = str(dt).split(".")[1]
        ms = {it: best_ms(lambda it=it: micro_bf16(bank, states[dt], it), 1)
              for it in (ITERS_LO, ITERS_HI)}
        plain_ms = cuda_ms(lambda: micro_bf16_ref(bank, states[dt], ITERS_HI), 1)
        res[name] = {
            "ms": ms,
            "us_per_sweep": (ms[ITERS_HI] - ms[ITERS_LO]) * 1e3 / (ITERS_HI - ITERS_LO),
            "plain_ms": plain_ms,
            "plain_us_per_sweep": plain_ms * 1e3 / NT,
        }
    res["bf16_error"] = bf16_error(micro_bf16_ref(bank, states[torch.float32], NT),
                                   micro_bf16_ref(bank, states[torch.bfloat16], NT))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: PyTorch sees no CUDA card; pass --device cpu")
    failures = 0
    for label, lanes, bad in run_checks(args.device):
        failures += bool(bad)
        print(f"{'FAIL' if bad else 'PASS'} {label}: {bad} of {lanes} lanes differ")
    if args.device == "cuda":
        res = time_sweeps()
        for name in ("float32", "bfloat16"):
            r = res[name]
            print(f"{name}: t({ITERS_LO})={r['ms'][ITERS_LO]:.4f} ms  "
                  f"t({ITERS_HI})={r['ms'][ITERS_HI]:.4f} ms  -> "
                  f"{r['us_per_sweep']:.5f} us per (128x{LB}) sweep; plain "
                  f"{r['plain_us_per_sweep']:.3f} us per sweep")
        rel, flips = res["bf16_error"]
        print(f"bf16 best t against f32: max relative error {rel:.3e}, {flips} of {LB} "
              f"lanes flip")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
