"""The beam-sort keys' kernels, held against their plain versions.

The counterpart of the JAX package's ``_emit_sort_key`` harness
(tests/test_fused.py, a pallas_call that writes the key of a (16, 256)
state into row 15).  ``sort_key_kernel`` (kernels/path_trace.cu) writes
``emit_sort_key`` of every column of a (16, R) state, the device function
``path_trace_gen_kernel`` runs after bounce 0; its plain version is
``render.fused.sort_key_ref``.  The host key of the mid-path resort
(``render.wavefront.ray_sort_key``) is compared too: it rounds
(o - bmin) / span · 32 where the kernel key rounds (o - bmin) · (32 /
span), and divides by the raw direction where the kernel clamps |d| to
1e-12, so the two may put a ray one cell apart at a cell boundary.

``ray_sort_key_kernel`` computes the host key itself (the JAX package's
``_ray_sort_key``, fused by XLA into the jitted wave) and must equal its
twin ``wavefront.ray_sort_key_ref`` bit for bit; ``edge_lanes`` builds the
lanes where that is hardest: zero direction components with the origin on
a box face, a flat scene box, ±inf slab times and dead lanes holding
garbage (NaN, ±inf, huge and subnormal values).

``run_checks`` holds sort_key_kernel on a 256-lane state drawn from a seed
(lanes 5-8 dead, as in the JAX harness), and ray_sort_key_kernel on the
same state and on each case of ``edge_lanes``.  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.sort_key

(``--device cpu`` runs the plain version against itself.)
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import kernels
from ..render import fused, wavefront

LANES = 256
DEAD = slice(5, 9)


def sort_key(state: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """The beam-sort key (R,) int32 of every column of ``state`` (16, R)
    under the gen parameters ``par`` (32,) (fused.PAR_* rows).  A CUDA
    state launches sort_key_kernel, a CPU state runs ``fused.sort_key_ref``."""
    if state.device.type == "cpu":
        return fused.sort_key_ref(state, par)
    if state.device.type != "cuda":
        raise ValueError(f"no sort key kernel for device {state.device}")
    key = torch.empty(state.shape[1], dtype=torch.int32, device=state.device)
    kernels.launch_sort_key(state, par, key)
    return key


def gen_par(bbox_min: torch.Tensor, bbox_max: torch.Tensor) -> torch.Tensor:
    """(32,) gen parameters with a zero camera and the scene box's key
    quantization (what ``wavefront.build_gen_par`` writes into rows 12-17)."""
    span = torch.clamp_min(bbox_max - bbox_min, 1e-30)
    par = torch.zeros(32, dtype=torch.float32, device=bbox_min.device)
    par[fused.PAR_BMIN:fused.PAR_BMIN + 3] = bbox_min
    par[fused.PAR_SCALE:fused.PAR_SCALE + 3] = 32.0 / span
    return par


def probe_state(lanes: int = LANES, seed: int = 0):
    """A (16, lanes) state of rays drawn from ``seed`` with origins in the
    box [-1, 1]^3 and unit directions, lanes 5-8 dead; with the box as
    (bbox_min, bbox_max) f32 tensors."""
    rng = np.random.default_rng(seed)
    state = np.zeros((16, lanes), np.float32)
    state[0:3] = rng.uniform(-1.0, 1.0, (3, lanes))
    d = rng.normal(size=(3, lanes))
    state[3:6] = d / np.linalg.norm(d, axis=0)
    state[12] = 1.0
    state[12, DEAD] = 0.0
    box = (torch.full((3,), -1.0), torch.full((3,), 1.0))
    return torch.from_numpy(state), box


def host_key(state: torch.Tensor, bbox_min, bbox_max) -> torch.Tensor:
    """``wavefront.ray_sort_key`` of ``state`` in the box."""
    return wavefront.ray_sort_key(SimpleNamespace(bbox_min=bbox_min, bbox_max=bbox_max),
                                  state)


EDGE_CASES = ("face_zero_dir", "flat_box", "inf_slabs", "dead_garbage")
# what a dead lane may hold where a live one holds a position or direction
GARBAGE = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 1e-40, -1e-40, 0.0, -0.0,
                    3.0, -7.5], np.float32)


def edge_lanes(case: str, lanes: int = 1024, seed: int = 0):
    """A (16, lanes) f32 state and its scene box (bbox_min, bbox_max) (3,)
    f32, as NumPy arrays drawn from ``seed``, for one of EDGE_CASES:

    * ``face_zero_dir``: origins on a face of the box (one axis at bmin or
      bmax), that axis's direction component 0 (0 · inf = NaN slab times);
    * ``flat_box``: a box of zero span on y, origins on its plane and
      directions with y = 0 on most lanes (both slab times NaN);
    * ``inf_slabs``: one to three direction components 0 or subnormal
      (1 / d = ±inf), origins inside and outside the box on those axes;
    * ``dead_garbage``: dead lanes (and a few with a NaN alive) whose
      origins and directions hold GARBAGE values."""
    rs = np.random.default_rng(seed)
    bmin = np.array([-1.0, 0.0, -2.0], np.float32)
    bmax = np.array([2.0, 3.0, 1.0], np.float32)
    state = np.zeros((16, lanes), np.float32)
    o = rs.uniform(bmin - 0.5, bmax + 0.5, (lanes, 3)).astype(np.float32)
    d = rs.standard_normal((lanes, 3)).astype(np.float32)
    alive = (rs.uniform(size=lanes) < 0.8).astype(np.float32)
    rows = np.arange(lanes)
    if case == "face_zero_dir":
        axis = rs.integers(0, 3, lanes)
        face = np.where(rs.uniform(size=lanes) < 0.5, bmin[axis], bmax[axis])
        o[rows, axis] = face
        d[rows, axis] = 0.0
        second = rs.uniform(size=lanes) < 0.25  # a second zero component
        d[rows[second], (axis[second] + 1) % 3] = 0.0
    elif case == "flat_box":
        bmax[1] = bmin[1] = 0.5
        o[rs.uniform(size=lanes) < 0.7, 1] = 0.5
        d[rs.uniform(size=lanes) < 0.6, 1] = 0.0
    elif case == "inf_slabs":
        zero = rs.uniform(size=(lanes, 3)) < 0.45
        d[zero] = np.where(rs.uniform(size=int(zero.sum())) < 0.8, 0.0,
                           np.float32(1e-40)).astype(np.float32)
        d[rows[:lanes // 16]] = 0.0  # the whole direction 0: texit +inf
    elif case == "dead_garbage":
        o = rs.choice(GARBAGE, (lanes, 3))
        d = rs.choice(GARBAGE, (lanes, 3))
        alive = np.where(rs.uniform(size=lanes) < 0.9, 0.0, np.nan).astype(np.float32)
    else:
        raise ValueError(f"case {case!r} not one of {EDGE_CASES}")
    state[0:3] = o.T
    state[3:6] = d.T
    state[6:9] = 1.0
    state[12] = alive
    state[13] = rs.standard_normal(lanes).astype(np.float32)
    return state, bmin, bmax


def ray_sort_key_differs(state, bbox_min, bbox_max) -> int:
    """Lanes where ``wavefront.ray_sort_key`` (the kernel on a CUDA state)
    differs from ``ray_sort_key_ref``."""
    box = SimpleNamespace(bbox_min=bbox_min, bbox_max=bbox_max)
    got = wavefront.ray_sort_key(box, state)
    return int((got != wavefront.ray_sort_key_ref(box, state)).sum())


def check(state, par, bbox_min, bbox_max) -> tuple[int, int]:
    """(lanes where the kernel key differs from ``sort_key_ref``, lanes
    where it differs from the host key)."""
    got = sort_key(state, par)
    n_ref = int((got != fused.sort_key_ref(state, par)).sum())
    n_host = int((got != host_key(state, bbox_min, bbox_max)).sum())
    return n_ref, n_host


def run_checks(device) -> list:
    """The 256-lane check on ``device``: a list of (label, lanes, lanes
    differing from sort_key_ref, lanes differing from the host key)."""
    device = torch.device(device)
    state, (bmin, bmax) = probe_state()
    state, bmin, bmax = state.to(device), bmin.to(device), bmax.to(device)
    n_ref, n_host = check(state, gen_par(bmin, bmax), bmin, bmax)
    return [(f"{LANES} lanes, lanes 5-8 dead", LANES, n_ref, n_host)]


def run_host_key_checks(device) -> list:
    """ray_sort_key_kernel against ray_sort_key_ref on ``device``: the
    256-lane state and every case of ``edge_lanes``, a list of (label,
    lanes, lanes differing)."""
    device = torch.device(device)
    state, (bmin, bmax) = probe_state()
    out = [(f"{LANES} lanes, lanes 5-8 dead", LANES,
            ray_sort_key_differs(state.to(device), bmin.to(device), bmax.to(device)))]
    for case in EDGE_CASES:
        st, lo, hi = (torch.from_numpy(a).to(device) for a in edge_lanes(case))
        out.append((f"edge lanes {case}", st.shape[1], ray_sort_key_differs(st, lo, hi)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: PyTorch sees no CUDA card; pass --device cpu")
    failures = 0
    for label, lanes, n_ref, n_host in run_checks(args.device):
        failures += bool(n_ref or n_host)
        print(f"{'FAIL' if n_ref or n_host else 'PASS'} {label}: {n_ref} of {lanes} "
              f"lanes differ from sort_key_ref, {n_host} from the host key")
    for label, lanes, n in run_host_key_checks(args.device):
        failures += bool(n)
        print(f"{'FAIL' if n else 'PASS'} ray_sort_key, {label}: {n} of {lanes} lanes "
              f"differ from ray_sort_key_ref")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
