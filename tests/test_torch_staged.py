"""The staged triangle test of the trace micro-benchmark kernels, on the CPU.

``micro_trace_kernel`` and ``micro_bf16_kernel`` (kernels/probes.cu) split
the transform-form test into stage 1 (dw, the det test, ow, the sign of t
and, in micro_trace, a test against the ray's running best) and stage 2
(ou, ov, du, dv, the divide, u, v) for the pairs stage 1 passes on.  Their
plain models (``micro_trace_staged_ref``, ``micro_bf16_staged_ref``) take
the same order; here they are held to the plain versions bit for bit on
the probes' inputs and on built boundary cases, and the stage-1 predicate
(``stage1_keeps``) is shown never to drop a pair the full test accepts
with a t at or below the best: by hypothesis over random f32 values and on
each boundary (ow = ±0, ow of dw's sign, det at 1e-8, t a few ulps either
side of a finite best, products bt·|dw| that are subnormal or overflow,
NaN).  The CUDA kernels on the same boundary cases: tests/test_torch_cuda.py.
Run on the CPU: ``python -m pytest tests/test_torch_staged.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from zig_raytracing_contest_tpu_torch.probes import micro_bf16, micro_trace

LANES = 4096
F32 = np.float32
EPS = F32(1e-8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test (other pytest workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trace_inputs():
    """The probe's bank and its first LANES rays, as tensors."""
    tris = micro_trace.make_bank(0)
    state = np.ascontiguousarray(micro_trace.make_state(1)[:, :LANES])
    return (torch.from_numpy(tris.tri_data), torch.from_numpy(tris.tile_bbox), tris.tile,
            torch.from_numpy(state))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("extract_uv", [True, False], ids=["uv", "no_uv"])
@pytest.mark.parametrize("cull", micro_trace.CULLS)
def test_micro_trace_staged_matches_plain(trace_inputs, cull, extract_uv):
    """The staged model's aux and idx equal micro_trace_ref's bit for bit;
    stage 2 takes a quarter of the swept pairs or fewer, and every hit is
    among them."""
    tri, bbox, tile, state = trace_inputs
    (aux, idx), counts = micro_trace.micro_trace_staged_ref(tri, bbox, tile, state, extract_uv,
                                                            cull)
    want_aux, want_idx = micro_trace.micro_trace_ref(tri, bbox, tile, state, extract_uv, cull)
    np.testing.assert_array_equal(_bits(aux), _bits(want_aux))
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    hits = int(torch.isfinite(want_aux[2]).sum())
    assert hits > 100, "the rays must hit the bank"
    assert counts["hits"] >= hits
    assert 0.15 < counts["stage2"] / counts["swept"] < 0.3, counts
    every = LANES * bbox.shape[1] * tile  # the pairs of a sweep without a cull
    if cull == "lane":
        assert counts["swept"] < 0.6 * every
    else:
        assert counts["swept"] == every
    assert counts["boxes"] == LANES * bbox.shape[1]


@pytest.mark.parametrize("iters", [64, 100])
@pytest.mark.parametrize("dtype", micro_bf16.DTYPES, ids=["f32", "bf16"])
def test_micro_bf16_staged_matches_plain(dtype, iters):
    """The staged model's best t equals micro_bf16_ref's bit for bit, in
    f32 and bf16; its pair counts follow the sweeps (tile i mod 64)."""
    bank, states = micro_bf16.device_inputs("cpu")
    best, counts = micro_bf16.micro_bf16_staged_ref(bank, states[dtype], iters)
    want = micro_bf16.micro_bf16_ref(bank, states[dtype], iters)
    np.testing.assert_array_equal(_bits(best), _bits(want))
    assert counts["swept"] == iters * micro_bf16.K * micro_bf16.LB
    assert 0.2 < counts["stage2"] / counts["swept"] < 0.3, counts
    assert counts["hits"] > 0


@pytest.fixture(scope="module")
def boundary():
    """The boundary cases as micro_trace's inputs, as tensors."""
    tri_data, tile_bbox, tile, state = micro_trace.boundary_inputs()
    return (torch.from_numpy(tri_data), torch.from_numpy(tile_bbox), tile,
            torch.from_numpy(state))


@pytest.mark.parametrize("cull", micro_trace.CULLS)
def test_micro_trace_boundary_cases(boundary, cull):
    """On the boundary cases the staged model equals micro_trace_ref bit
    for bit: the winners are the nearest of each ray's cases (the ties and
    the ulps either side of the best settled as the flat loop settles
    them), and the test against the best drops some pairs."""
    tri, bbox, tile, state = boundary
    (aux, idx), counts = micro_trace.micro_trace_staged_ref(tri, bbox, tile, state, True, cull)
    want_aux, want_idx = micro_trace.micro_trace_ref(tri, bbox, tile, state, True, cull)
    np.testing.assert_array_equal(_bits(aux), _bits(want_aux))
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    t = want_aux[2].numpy()
    assert (t[:10] < np.inf).all() and (t[10:] == np.inf).all()
    assert t[0] == t[1] == _ulps(5.0, -3)  # the nearer of the ulps, either order
    # the test against the best drops pairs whose det and sign tests pass
    m = tri[:13]
    live = state[12] > 0
    o, d = state[0:3, live], state[3:6, live]
    dw = m[6][None, :] * d[0][:, None] + m[7][None, :] * d[1][:, None] + m[8][None, :] * d[2][:, None]
    ow = (m[6][None, :] * o[0][:, None] + m[7][None, :] * o[1][:, None]
          + m[8][None, :] * o[2][:, None] + m[11][None, :])
    signs = int(micro_trace.front_and_ahead(dw, ow, m[12][None, :]).sum())
    if cull != "lane":
        assert counts["stage2"] < signs


@pytest.mark.parametrize("dtype", micro_bf16.DTYPES, ids=["f32", "bf16"])
def test_micro_bf16_boundary_cases(dtype):
    """On the boundary cases the staged model of micro_bf16 equals
    micro_bf16_ref bit for bit in f32 and bf16."""
    bank, state = (torch.from_numpy(a) for a in micro_bf16.boundary_inputs())
    state = state.to(dtype)
    best, _ = micro_bf16.micro_bf16_staged_ref(bank, state, 3)
    want = micro_bf16.micro_bf16_ref(bank, state, 3)
    np.testing.assert_array_equal(_bits(best), _bits(want))
    assert int(torch.isfinite(want).sum()) == 10


def _accepted_by_full_test(dw, ow, n_sq, bt):
    """The part of the full test stage 1 can see: det >= 1e-8 and 0 < t =
    rn(-ow/dw) <= bt, t finite (u and v depend on other rows; an infinite t
    makes u = ou + t·du NaN or infinite, and then u, v >= 0 and u + v <= 1
    cannot all hold)."""
    t = -ow / dw
    return (-dw * n_sq >= EPS) & (t > 0.0) & (t <= bt) & torch.isfinite(t)


def _f32(*xs):
    return [torch.tensor(np.asarray(x, F32).reshape(-1)) for x in xs]


def _ulps(x, k):
    x = F32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, F32(np.inf) if k > 0 else F32(-np.inf), dtype=F32)
    return x


FLOATS = st.floats(width=32, allow_nan=True, allow_infinity=True)
BESTS = st.floats(width=32, min_value=0.0, allow_nan=False, allow_infinity=True)


@settings(max_examples=300, deadline=None, database=None)
@given(dw=arrays(F32, 64, elements=FLOATS), ow=arrays(F32, 64, elements=FLOATS),
       n_sq=arrays(F32, 64, elements=FLOATS), bt=arrays(F32, 64, elements=BESTS))
def test_stage1_never_drops_a_winner(dw, ow, n_sq, bt):
    """Random f32 values, NaN and infinities among them: every pair the
    full test accepts with t <= bt passes stage 1, so dropping the rest
    changes no winner whatever the order of the fold."""
    dw, ow, n_sq, bt = _f32(dw, ow, n_sq, bt)
    accepted = _accepted_by_full_test(dw, ow, n_sq, bt)
    assert not bool((accepted & ~micro_trace.stage1_keeps(dw, ow, n_sq, bt)).any())


@settings(max_examples=300, deadline=None, database=None)
@given(bt=st.floats(width=32, min_value=float(F32(1e-30)), max_value=float(F32(1e30))),
       dw=st.floats(width=32, min_value=float(F32(1e-12)), max_value=float(F32(1e12))),
       k=st.integers(min_value=-40, max_value=40))
def test_stage1_near_a_finite_best(bt, dw, k):
    """ow = rn(bt·|dw|) moved k ulps (t within a few ulps of bt, either
    side): a pair the full test accepts with t <= bt passes stage 1."""
    with np.errstate(over="ignore"):
        ow = _ulps(F32(bt) * F32(dw), k)
    d, o, n, b = _f32(-F32(dw), ow, 1.0 / F32(dw) * 2.0, bt)
    accepted = _accepted_by_full_test(d, o, n, b)
    assert not bool((accepted & ~micro_trace.stage1_keeps(d, o, n, b)).any())


# (dw, ow, |n|², bt, whether stage 1 passes the pair on)
BOUNDARY = {
    "ow +0": (-1.0, 0.0, 1.0, np.inf, False),
    "ow -0": (-1.0, -0.0, 1.0, np.inf, False),
    "ow of dw's sign": (-1.0, -2.0, 1.0, np.inf, False),
    "dw and ow positive": (1.0, 2.0, 1.0, np.inf, False),
    "front-facing ahead": (-1.0, 2.0, 1.0, np.inf, True),
    "back-facing ahead": (1.0, -2.0, -1.0, np.inf, True),
    "det at 1e-8": (-1.0, 2.0, EPS, np.inf, True),
    "det an ulp below 1e-8": (-1.0, 2.0, _ulps(EPS, -1), np.inf, False),
    "t an ulp below bt": (-1.0, _ulps(5.0, -1), 1.0, 5.0, True),
    "t equal to bt": (-1.0, 5.0, 1.0, 5.0, True),
    "t an ulp above bt": (-1.0, _ulps(5.0, 1), 1.0, 5.0, True),
    "t past the margin": (-1.0, _ulps(5.0, 64), 1.0, 5.0, False),
    "t at 6 of 5": (-3.0, 18.0, 1.0, 5.0, False),
    "t an ulp below bt, dw = -3": (-3.0, _ulps(15.0, -1), 1.0, 5.0, True),
    "subnormal product, t below bt": (F32(-1e-10), _ulps(F32(1e-40), -1), 1e3, 1e-30, True),
    "subnormal product, t far past bt": (F32(-1e-10), F32(1e-38), 1e3, 1e-30, True),
    "subnormal best": (-1.0, _ulps(F32(1e-40), 1), 1.0, F32(1e-40), True),
    "overflowing product": (F32(-1e10), F32(3e38), 1.0, 1e30, True),
    "infinite ow, no best": (-1.0, np.inf, 1.0, np.inf, False),
    "infinite best": (-1.0, F32(3e38), 1.0, np.inf, True),
    "NaN dw": (np.nan, 2.0, 1.0, np.inf, False),
    "NaN ow": (-1.0, np.nan, 1.0, np.inf, True),
    "NaN |n|²": (-1.0, 2.0, np.nan, np.inf, False),
}


@pytest.mark.parametrize("case", list(BOUNDARY), ids=list(BOUNDARY))
def test_stage1_boundary(case):
    """Each boundary of stage 1: its verdict, and no pair the full test
    accepts with t <= bt dropped."""
    *vals, keeps = BOUNDARY[case]
    dw, ow, n_sq, bt = _f32(*vals)
    got = micro_trace.stage1_keeps(dw, ow, n_sq, bt)
    assert bool(got[0]) == keeps
    assert not bool((_accepted_by_full_test(dw, ow, n_sq, bt) & ~got).any())


def test_boundary_checks_on_the_cpu():
    """The probes' boundary checks run on the CPU (where the wrappers take
    the plain versions): every variant, no lane off."""
    trace = micro_trace.boundary_checks("cpu")
    assert len(trace) == 18 and all(bad == tied == 0 for _, _, bad, tied in trace)
    sweeps = micro_bf16.boundary_checks("cpu")
    assert len(sweeps) == 4 and all(bad == 0 for _, _, bad in sweeps)


def test_build_report_kept_beside_the_library(tmp_path, monkeypatch):
    """chip_smoke.py fails a kernel that spills by reading its build's ptxas
    report: the report is kept beside the library, so a process that finds
    the library built still reads it (a stand-in nvcc writes both)."""
    from zig_raytracing_contest_tpu_torch import kernels

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "while [ $# -gt 1 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    "echo 'ptxas info    : Compiling entry function micro_bf16_kernel'\n"
                    "echo '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads'\n"
                    "touch \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_INFO", {})
    lib = kernels.build("probes", build_dir=tmp_path / "b")
    assert lib.exists() and "spill stores" in kernels.build_log("probes", build_dir=tmp_path / "b")
    kernels.BUILD_INFO.clear()  # another process: the library is there, the report beside it
    assert kernels.build(
        "probes", build_dir=tmp_path / "b") == lib and kernels.BUILD_INFO == {}
    assert "micro_bf16_kernel" in kernels.build_log("probes", build_dir=tmp_path / "b")
    assert kernels.build_log("path_trace", build_dir=tmp_path / "b") == ""


def test_survivor_balance(trace_inputs):
    """The spread of stage 1's survivors on the probe's rays: a quarter of
    the pairs survive; a lane that runs its own survivors needs more rounds
    than full warps would (the busiest lane of a warp sets them), and a
    lane that runs one triangle's more again."""
    tri, _, _, state = trace_inputs
    sb = micro_trace.survivor_balance(tri[:, :micro_trace.T], state)
    assert 0.2 < sb["share"] < 0.3 and sb["full"] == sb["share"]
    assert sb["full"] < sb["lane"] < sb["triangle"]
