"""The grid walk as one kernel, and the XLA shading path as one frame call,
on the CPU.

* ``trace_wave_ref`` (the twin of grid_walk_kernel): its results and work
  counters (references tested, cells entered, the loop's iteration count)
  equal a scalar walk of each ray written here in the reference's shape
  (Scene.traceRay, src/stage3.zig:152-186: every triangle of a cell, then
  one DDA step), in NumPy f32 scalars, on the edge rays of
  ``probes.grid_walk.edge_rays`` (axis-parallel rays, origins on cell
  faces and inside the grid, zero directions, inactive lanes), with and
  without the previous-hit exclusion; and the JAX package's
  ``trace_wave`` run op by op, bit for bit;
* ``kernels.launch_grid_walk`` and ``kernels.launch_grid_walk_shaded``
  check their operands and refuse CPU tensors before they load anything
  (no silent fallback), and the CPU path never reaches them;
* the grid's kernel operands hold the grid's values bit for bit;
* ``FramePlan.key`` tells the extensions apart, ``graph_route`` sends the
  XLA shading path's frames to the graph, and a grid frame with NEE
  through the graph route (a stub capture) equals its eager frame;
* ``render_wave_rows`` sends a grid wave with no extension on a card to
  the shaded walk (``render_wave_grid``), a baked wave with an extension
  on a card to the shaded trace (``render_wave_shaded_trace``) and every
  other XLA-path wave to ``render_wave_xla``; the CPU never reaches the
  shaded kernels.

grid_walk_kernel itself, and its shaded walk, run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase k).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_frame import stub_capture
from test_torch_grid import _scenes

from zig_raytracing_contest_tpu.render.wavefront import trace_wave as jax_trace_wave
from zig_raytracing_contest_tpu_torch import kernels
from zig_raytracing_contest_tpu_torch.config import Config, ExtFlags
from zig_raytracing_contest_tpu_torch.probes.grid_walk import edge_rays
from zig_raytracing_contest_tpu_torch.render import pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc

F = np.float32
INF = F(np.inf)
AXIS_MAP = (2, 1, 2, 1, 2, 2, 0, 0)  # src/linalg.zig:483


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test, beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i64(x) -> int:
    """A float's int64 cast as PyTorch's on the CPU: truncation, and
    INT64_MIN for NaN, ±inf and out-of-range values."""
    if not np.isfinite(x) or abs(float(x)) >= 2.0**63:
        return -(2**63)
    return int(x)


def _mt(o, d, v0, e1, e2):
    """Möller–Trumbore in f32 scalars, op by op (ops/linalg.py)."""
    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    p = cross(d, e2)
    det = dot(e1, p)
    inv = F(1) / det
    tv = tuple(o[a] - v0[a] for a in range(3))
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    valid = det >= F(1e-8) and u >= 0 and u <= 1 and v >= 0 and u + v <= 1
    return valid, t, u, v


def scalar_walk(g, o, d, active, exclude, visited: set):
    """One ray through the grid ``g`` (NumPy arrays) in the reference's
    shape: enter the box, then per cell test every reference in order and
    step the DDA, until the best t is at most the crossing t → (t, u, v,
    reference, references tested, cells entered, iterations, cells entered
    that hold references), where a cell of n references takes max(1,
    ceil(n / 4)) iterations of the JAX loop (four tests an iteration, the
    step in the iteration that empties the cell).  The cells entered are
    added to ``visited``."""
    best = (INF, F(0), F(0), 0)
    if not active:
        return best + (0, 0, 0, 0)
    o = tuple(F(x) for x in o)
    d = tuple(F(x) for x in d)
    sign = [d[a] < 0 for a in range(3)]
    near = [(g["bmax"][a] if sign[a] else g["bmin"][a]) - o[a] for a in range(3)]
    far = [(g["bmin"][a] if sign[a] else g["bmax"][a]) - o[a] for a in range(3)]
    near = [near[a] / d[a] for a in range(3)]
    far = [far[a] / d[a] for a in range(3)]
    tmin, tmax = near[0], far[0]
    miss = tmin > far[1] or tmax < near[1]
    tmin, tmax = np.maximum(tmin, near[1]), np.minimum(tmax, far[1])
    miss = miss or tmin > far[2] or tmax < near[2]
    tmin = np.maximum(tmin, near[2])
    if miss:
        return best + (0, 0, 0, 0)
    t_entry = np.maximum(tmin, F(0))
    res, cs = g["res"], g["cs"]
    cell, t_next, t_delta = [0] * 3, [F(0)] * 3, [F(0)] * 3
    for a in range(3):
        hit_local = (o[a] + d[a] * t_entry) - g["bmin"][a]
        cell[a] = min(max(_i64(hit_local / cs[a]), 0), int(res[a]) - 1)
        t_delta[a] = np.abs(cs[a] / d[a])
        nxt = F(cell[a] + (0 if sign[a] else 1))
        t_next[a] = t_entry + (nxt * cs[a] - hit_local) / d[a]
    tests = cells = iterations = occupied = 0
    while True:
        cells += 1
        lin = (cell[2] * int(res[1]) + cell[1]) * int(res[0]) + cell[0]
        lin = min(max(lin, 0), len(g["begin"]) - 1)
        visited.add(lin)
        b, e = int(g["begin"][lin]), int(g["end"][lin])
        occupied += e > b
        for ref in range(b, e):
            tests += 1
            valid, t, u, v = _mt(o, d, g["v0"][ref], g["e1"][ref], g["e2"][ref])
            if (valid and t > 0 and t < best[0]
                    and (exclude is None or g["dup"][ref] != exclude)):
                best = (t, u, v, ref)
        iterations += max(1, -(-(e - b) // 4))
        t0, t1, t2 = t_next
        axis = AXIS_MAP[(t0 < t1) * 4 + (t0 < t2) * 2 + (t1 < t2)]
        if cell[axis] == (0 if sign[axis] else int(res[axis]) - 1):
            t_cross = INF
        else:
            t_cross = t_next[axis]
            cell[axis] += -1 if sign[axis] else 1
            t_next[axis] = t_next[axis] + t_delta[axis]
        if best[0] <= t_cross:
            return best + (tests, cells, iterations, occupied)


def _grid_arrays(scene) -> dict:
    g = scene.grid
    p = g.params
    return {"bmin": p.bbox_min.numpy(), "bmax": p.bbox_max.numpy(), "res": p.resolution.numpy(),
            "cs": p.cell_size.numpy(), "begin": g.cell_begin.numpy(), "end": g.cell_end.numpy(),
            "v0": g.tri_v0.numpy(), "e1": g.tri_e1.numpy(), "e2": g.tri_e2.numpy(),
            "dup": g.dup_to_tri.numpy()}


@pytest.mark.parametrize("name", ["cornell", "fuzz202"])
@pytest.mark.parametrize("exclusion", [False, True])
def test_twin_work_equals_scalar_walk(name, exclusion, tmp_path):
    """trace_wave_ref against scalar_walk on 480 edge rays: t, u, v bits,
    the reference, each ray's tests and cells, the cells any ray entered
    and the loop's iteration count (the largest ray's) all equal; the rays
    reach what they are built for (axis-parallel walks, hits, misses,
    several cells)."""
    _, _, _, _, tg, _ = _scenes(name, tmp_path)
    o, d, act = edge_rays(tg.grid.params, 480, seed=5)
    ex = None
    if exclusion:
        ex = torch.from_numpy(np.random.default_rng(1).integers(
            0, int(tg.grid.dup_to_tri.max()) + 1, 480))
    got = wavefront.trace_wave_ref(tg, o, d, act, ex, work=True)
    g = _grid_arrays(tg)
    visited = set()
    with np.errstate(all="ignore"):
        want = [scalar_walk(g, o[i].numpy(), d[i].numpy(), bool(act[i]),
                            None if ex is None else int(ex[i]), visited) for i in range(480)]
    t, u, v, ref, tests, cells, its, occupied = (np.array(c) for c in zip(*want))
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32), t.astype(F).view(np.uint32))
    np.testing.assert_array_equal(got.u.numpy().view(np.uint32), u.astype(F).view(np.uint32))
    np.testing.assert_array_equal(got.v.numpy().view(np.uint32), v.astype(F).view(np.uint32))
    np.testing.assert_array_equal(got.dup_idx.numpy(), ref)
    np.testing.assert_array_equal(got.work.tests.numpy(), tests)
    np.testing.assert_array_equal(got.work.cells.numpy(), cells)
    np.testing.assert_array_equal(got.work.occupied.numpy(), occupied)
    assert 0 < occupied.sum() < cells.sum()
    assert int(got.iterations) == its.max() > 0
    assert got.iterations.dtype == torch.int32 and got.iterations.dim() == 0
    walked = cells > 0
    assert np.isfinite(t).sum() > 10 and (walked & ~np.isfinite(t)).sum() > 20
    assert (walked & ((d.numpy() == 0).any(axis=1))).sum() > 20 and cells.max() > 3
    assert set(got.work.visited.nonzero()[:, 0].tolist()) == visited


@pytest.mark.parametrize("name", ["cornell", "fuzz303"])
def test_trace_wave_ref_matches_jax_on_edge_rays(name, tmp_path):
    """trace_wave_ref against the JAX trace_wave run op by op
    (jax.disable_jit) on 256 edge rays, with and without the exclusion:
    t, u, v bits and the reference equal."""
    _, _, jg, _, tg, _ = _scenes(name, tmp_path)
    o, d, act = edge_rays(tg.grid.params, 256, seed=9)
    ex = np.random.default_rng(2).integers(0, int(tg.grid.dup_to_tri.max()) + 1, 256)
    for exclude in (None, ex):
        got = wavefront.trace_wave_ref(tg, o, d, act,
                                       None if exclude is None else torch.from_numpy(exclude))
        kw = {} if exclude is None else {"exclude": jnp.asarray(exclude)}
        with jax.disable_jit():
            want = jax_trace_wave(jg, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                  jnp.asarray(act.numpy()), **kw)
        for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b).view(np.uint32))
        np.testing.assert_array_equal(got.dup_idx.numpy(), np.asarray(want.dup_idx))
        assert np.isfinite(np.asarray(want.t)).sum() > 10


def test_kernel_operands_hold_the_grid(tmp_path):
    """GridScene.kernel_operands: each row holds the reference's v0, e1, e2
    and unique id as bits, the cell ranges the grid's, the parameters its
    f32 values; made once."""
    _, _, _, _, tg, _ = _scenes("cornell", tmp_path)
    g = tg.grid
    ops = g.kernel_operands()
    assert ops is g.kernel_operands()
    assert ops.tri.shape == (g.num_refs + 1, 12) and ops.tri.dtype == torch.float32
    bits = ops.tri.view(torch.int32)
    for k, part in enumerate((g.tri_v0, g.tri_e1, g.tri_e2)):
        assert torch.equal(bits[:, 3 * k:3 * k + 3], part.view(torch.int32))
    assert torch.equal(bits[:, 9].to(torch.int64), g.dup_to_tri)
    assert (bits[:, 10:] == 0).all()
    assert torch.equal(ops.cells.to(torch.int64), torch.stack([g.cell_begin, g.cell_end], 1))
    assert ops.cells.dtype == torch.int32
    assert ops.resolution == tuple(g.params.resolution.tolist())
    for mine, theirs in ((ops.bbox_min, g.params.bbox_min), (ops.cell_size, g.params.cell_size)):
        assert np.array_equal(np.float32(mine), theirs.numpy())


def _walk_args(R=8, **over):
    ops = SimpleNamespace(tri=torch.zeros(5, 12), cells=torch.zeros(8, 2, dtype=torch.int32),
                          bbox_min=(0.0,) * 3, bbox_max=(1.0,) * 3, cell_size=(0.5,) * 3,
                          resolution=(2, 2, 2))
    args = dict(grid=ops, orig=torch.zeros(R, 3), direction=torch.ones(R, 3),
                active=torch.ones(R, dtype=torch.bool), exclude=None, t_out=torch.empty(R),
                u_out=torch.empty(R), v_out=torch.empty(R),
                idx_out=torch.empty(R, dtype=torch.int64),
                iterations=torch.zeros(2, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("over, match", [
    ({}, "needs CUDA tensors"),
    ({"orig": torch.zeros(8, 3, dtype=torch.float64)}, "orig has dtype"),
    ({"direction": torch.zeros(8, 4)}, "direction has shape"),
    ({"active": torch.ones(8)}, "active has dtype"),
    ({"exclude": torch.zeros(8, dtype=torch.int32)}, "exclude has dtype"),
    ({"idx_out": torch.empty(8, dtype=torch.int32)}, "idx_out has dtype"),
    ({"iterations": torch.zeros(1, dtype=torch.int32)}, "iterations has shape"),
    ({"orig": torch.zeros(3, 8).T}, "orig is not contiguous"),
    ({"grid": SimpleNamespace(tri=torch.zeros(5, 12), cells=torch.zeros(7, 2, dtype=torch.int32),
                              bbox_min=(0.0,) * 3, bbox_max=(1.0,) * 3, cell_size=(0.5,) * 3,
                              resolution=(2, 2, 2))}, "7 cell ranges"),
    ({"orig": torch.zeros(1, 3).expand(kernels.GRID_MAX_RAYS + 1, 3)}, "rays: at most"),
], ids=["cpu", "orig_dtype", "dir_shape", "active_dtype", "exclude_dtype", "idx_dtype",
        "iterations_shape", "strided", "cells", "rays"])
def test_launch_grid_walk_refuses(over, match, monkeypatch):
    """Every check runs before the library loads: CPU tensors and wrong
    dtypes, shapes or strides raise ValueError, and nothing is built or
    counted (no silent fallback to the twin)."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kernels.launch_grid_walk(**_walk_args(**over))
    assert kernels.LAUNCHES["grid_walk"] == 0


def _shaded_args(**over):
    """Arguments of kernels.launch_grid_walk_shaded on CPU tensors (8 rays, a
    2×2×2 grid of 5 references, a shade table of 3 triangles, 4 texels, the
    generator of a 5-pixel-wide image from slot 3, 2 spp)."""
    R = 8
    args = dict(_walk_args(), shade=torch.zeros(3, 32), bank=torch.zeros(4, 4),
                par=torch.zeros(32), width=5, spp=2, slot_base=3, seed=2**40 + 7,
                direction=torch.ones(R, 3), thr=torch.empty(R, 3), rows4=torch.empty(4, R),
                bounce=1, bounces=3, counts=torch.zeros(4, dtype=torch.int64))
    del args["active"], args["exclude"]
    args.update(over)
    return args


@pytest.mark.parametrize("over, match", [
    ({}, "needs CUDA tensors"),
    ({"bounce": 4}, "launch 4 of a wave of 3 bounces"),
    ({"rows4": torch.empty(8, 4)}, "rows4 has shape"),
    ({"shade": torch.zeros(3, 24)}, "shade has shape"),
    ({"counts": torch.zeros(3, dtype=torch.int64)}, "counts has shape"),
    ({"bank": torch.zeros(17)[1:].view(4, 4)}, "bank is not 16-byte aligned"),
    ({"spp": 0}, "0 samples a pixel"),
    ({"width": 0}, "width 0"),
    ({"slot_base": -1}, "slot base -1"),
    ({"slot_base": 5 << 31}, "row 2147483648 past"),
    ({"par": torch.zeros(32, device="meta")}, "par on meta"),
    ({"par": torch.zeros(16)}, "par has shape"),
    ({"par": torch.zeros(32, dtype=torch.float64)}, "par has dtype"),
], ids=["cpu", "bounce", "rows4_shape", "shade_shape", "counts_shape", "bank_aligned",
        "spp", "width", "slot_base", "slot_row", "par_device", "par_shape", "par_dtype"])
def test_launch_grid_walk_shaded_refuses(over, match, monkeypatch):
    """The shaded walk's launcher checks every operand before the library
    loads, as launch_grid_walk does: CPU tensors, a launch past the wave's
    bounces, wrong shapes, dtypes or alignment raise ValueError, and nothing
    is built or counted."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kernels.launch_grid_walk_shaded(**_shaded_args(**over))
    assert kernels.LAUNCHES["grid_walk"] == 0


@pytest.mark.parametrize("flag", ["nee", "russian_roulette", "pbr"])
def test_frame_plan_key_has_extension_flags(flag, tmp_path):
    """One grid scene at one size with and without an extension: the plans
    differ in their key and nowhere else, so the two frames take two
    FrameGraphs."""
    path = tproc.cornell_like_box(tmp_path / "box.gltf")
    base = dict(grid_resolution=(8, 8, 8), num_samples=1, max_bounce=2, backend="grid")
    scene, cam, _ = pipeline.prepare_scene(str(path), Config(**base), width=32, height=32,
                                           device="cpu")
    plain = pipeline.frame_plan(scene, cam, Config(**base))
    ext = pipeline.frame_plan(scene, cam, Config(**base, **{flag: True}))
    assert plain.key != ext.key and plain.key[:-1] == ext.key[:-1]
    assert ext.ext == ExtFlags(**{flag: True}) and plain.ext == ExtFlags()
    assert pipeline.frame_graph(scene, plain) is not pipeline.frame_graph(scene, ext)


@pytest.mark.parametrize("case, want", [
    (dict(kind="grid", device="cuda"), True),
    (dict(kind="baked", device="cuda", ext=ExtFlags(nee=True, russian_roulette=True,
                                                     pbr=True)), True),
    (dict(kind="grid", device="cuda", plain=True), False),
    (dict(kind="grid", device="cuda", progressive=True), False),
    (dict(kind="grid", device="cpu"), False),
], ids=["grid_cuda", "ext_cuda", "grid_plain", "grid_progressive", "grid_cpu"])
def test_graph_route_takes_the_xla_path(case, want):
    """A grid scene and a frame with every extension replay a graph on a
    card (stub scenes); plain, progressive and CPU frames do not."""
    scene = SimpleNamespace(device=torch.device(case["device"]),
                            tri_data=torch.empty(16, 8) if case["kind"] == "baked" else None)
    assert pipeline.graph_route(scene, case.get("ext"), case.get("plain", False),
                                case.get("progressive", False)) == want


_EXTS = {"none": ExtFlags(), "nee": ExtFlags(nee=True),
         "russian_roulette": ExtFlags(russian_roulette=True), "pbr": ExtFlags(pbr=True)}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
@pytest.mark.parametrize("ext", list(_EXTS))
@pytest.mark.parametrize("kind", ["grid", "baked"])
def test_wave_route_shades_in_the_walk_only_on_a_bare_grid_card(kind, ext, plain, device,
                                                                 monkeypatch):
    """Which route ``render_wave_rows`` sends a wave down (stub scenes): the
    shaded walk (``render_wave_grid``) for a grid scene with no extension,
    through the kernels, on a card; the shaded trace
    (``render_wave_shaded_trace``) for a baked scene with an extension on,
    through the kernels, on a card; ``render_wave_xla`` for every other wave
    of the XLA shading path (an extension on the grid; ``plain``; the CPU);
    a baked scene with no extension none of them.  The shaded kernels'
    entry points are made to raise, and no route reaches them."""
    class Took(Exception):
        pass

    def route(name):
        def take(*a, **k):
            raise Took(name)
        return take

    def refuse(*a, **k):
        raise AssertionError("the route reached the shaded walk's kernel")

    monkeypatch.setattr(kernels, "launch_grid_walk_shaded", refuse)
    monkeypatch.setattr(kernels, "launch_trace_shaded", refuse)
    monkeypatch.setattr(wavefront, "render_wave_grid", route("walk"))
    monkeypatch.setattr(wavefront, "render_wave_shaded_trace", route("trace"))
    monkeypatch.setattr(wavefront, "render_wave_xla", route("xla"))
    monkeypatch.setattr(wavefront, "render_wave_whole_path", route("bake"))
    monkeypatch.setattr(wavefront, "render_wave_per_bounce", route("bake"))
    scene = SimpleNamespace(device=torch.device(device), bank_resident=True,
                            tri_data=None if kind == "grid" else torch.empty(16, 8))
    flags = _EXTS[ext]
    card = device == "cuda" and not plain
    if ext == "none":
        want = ("walk" if card else "xla") if kind == "grid" else "bake"
    else:
        want = "trace" if card and kind == "baked" else "xla"
    assert wavefront.shaded_walk(scene, flags, plain) == (want == "walk")
    assert wavefront.shaded_trace(scene, flags, plain) == (want == "trace")
    with pytest.raises(Took) as took:
        wavefront.render_wave_rows(scene, torch.zeros(32), 64, 48, 2, 3, 0, 64 * 48, 1024, 1,
                                   0, plain=plain, ext=flags)
    assert took.value.args[0] == want


def test_cpu_grid_path_never_reaches_the_kernel(tmp_path, monkeypatch):
    """On the CPU the grid walk is the twin: with launch_grid_walk, the
    shaded walk's launcher and the library's loader made to raise,
    trace_any (plain or not) and grid frames with and without NEE and RR
    render; trace_wave on a CPU wave is the twin's result, its iteration
    count a 0-d int32 on the CPU."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(kernels, "launch_grid_walk", refuse)
    monkeypatch.setattr(kernels, "launch_grid_walk_shaded", refuse)
    monkeypatch.setattr(kernels, "load", refuse)
    cam, _, _, _, tg, _ = _scenes("cornell", tmp_path)
    o, d, act = edge_rays(tg.grid.params, 128, seed=3)
    a = wavefront.trace_any(tg, o, d, act)
    b = wavefront.trace_any(tg, o, d, act, plain=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    hit = wavefront.trace_wave(tg, o, d, act)
    assert hit.iterations.device.type == "cpu" and hit.iterations.dtype == torch.int32
    assert torch.equal(hit.t, wavefront.trace_wave_ref(tg, o, d, act).t)
    path = tproc.cornell_like_box(tmp_path / "box2.gltf")
    cfg = Config(grid_resolution=(8, 8, 8), num_samples=1, max_bounce=3, backend="grid",
                 nee=True, russian_roulette=True)
    scene, c, _ = pipeline.prepare_scene(str(path), cfg, width=32, height=24, device="cpu")
    for ext in (dict(nee=True, russian_roulette=True), {}):
        frame_cfg = Config(grid_resolution=(8, 8, 8), num_samples=1, max_bounce=3,
                           backend="grid", **ext)
        img, st = pipeline.render_scene(scene, c, frame_cfg)
        assert img.shape == (24, 32, 3) and st.segments > 0


def test_grid_nee_frames_through_the_graph_route(tmp_path, monkeypatch):
    """A grid frame with NEE and RR through the graph route on the CPU (the
    stub capture of tests/test_torch_frame.py): warm-up, capture and replay,
    replay each equal the eager frame bit for bit, image and segments; the
    same scene without NEE takes its own FrameGraph and equals its own
    eager frame."""
    captures = []

    def capture(fn, device):
        captures.append(device)
        return stub_capture(fn, device)

    monkeypatch.setattr(pipeline, "graph_route", lambda *a, **k: True)
    monkeypatch.setattr(pipeline, "capture_cuda_graph", capture)
    path = tproc.cornell_like_box(tmp_path / "box.gltf")
    base = dict(grid_resolution=(8, 8, 8), num_samples=2, max_bounce=3, seed=4,
                backend="grid", wave_size=1 << 11)
    scene, cam, _ = pipeline.prepare_scene(str(path), Config(**base), width=40, height=30,
                                           device="cpu")
    for cfg in (Config(**base, nee=True, russian_roulette=True), Config(**base)):
        want, want_st = pipeline.render_scene(scene, cam, cfg, graph=False)
        for _ in range(3):
            img, st = pipeline.render_scene(scene, cam, cfg)
            np.testing.assert_array_equal(img, want)
            assert st.segments == want_st.segments
    assert len(captures) == 2
    graphs = [v for v in scene.frame_cache().values() if isinstance(v, pipeline.FrameGraph)]
    assert len(graphs) == 2 and all(g.frames == 3 for g in graphs)


def test_walk_work_counts_occupied_cells():
    """WalkWork.occupied on a scene counted by hand: a floor triangle in
    z = 0 and a small one at the far top corner, on a 4×1×4 grid (cells 1
    unit in x, 1/4 in z), the floor in the four cells of layer z 0 and the
    corner triangle in cell (3, 0, 3).  Three rays along +x that hit
    nothing (parallel to both triangles) walk layer 2 (no occupied cell),
    layer 3 (one) and layer 0 (four): 12 cells entered, 5 occupied."""
    from zig_raytracing_contest_tpu_torch.grid.builder import build_grid
    from zig_raytracing_contest_tpu_torch.scene.types import grid_scene

    pos = np.array([[[0, 0, 0], [4, 0, 0], [0, 1, 0]],
                    [[3.9, 0.9, 1], [4, 0.9, 1], [4, 1, 1]]], np.float32)
    g = grid_scene(build_grid(pos, (4, 1, 4)), pos)
    lin = lambda x, z: z * 4 + x  # noqa: E731
    want = {lin(x, 0) for x in range(4)} | {lin(3, 3)}
    assert set((g.cell_end > g.cell_begin).nonzero()[:, 0].tolist()) == want
    scene = SimpleNamespace(grid=g)
    o = torch.tensor([[-1.0, 0.5, 0.6], [-1.0, 0.95, 0.9], [-1.0, 0.5, 0.1]])
    d = torch.tensor([[1.0, 0.0, 0.0]] * 3)
    got = wavefront.trace_wave_ref(scene, o, d, torch.ones(3, dtype=torch.bool), work=True)
    assert torch.isinf(got.t).all()
    assert got.work.cells.tolist() == [4, 4, 4]
    assert got.work.occupied.tolist() == [0, 1, 4]
    assert int(got.work.occupied.sum()) == 5 and int(got.work.cells.sum()) == 12
