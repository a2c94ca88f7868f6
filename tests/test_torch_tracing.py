"""The port's spans and work counters.

* ``render_scene``'s host spans (``PhaseTimers``) land in a
  ``torch.profiler`` trace as ``zrc.*`` ranges, read by the benchmark's
  trace reader, nested in the caller's range and in their parent; with no
  profiler recording, no range is opened;
* a frame's work counters: the rays alive summed over the bounces equal
  its segments, and the lanes issued its waves × wave size × bounces, on
  the XLA shading path over the grid and over the bake, on the per-bounce
  streaming pipeline and on the whole path, each counting 0 for work its
  route does not do; ``kernels.COUNTERS`` sums them over frames and
  ``reset_launches()`` clears it, beside ``LAUNCHES``, whose keys do not
  change;
* the grid walk's twin sums each ray's iterations as a hand count on a
  tiny grid says.

The CUDA cases (a replayed frame's counters equal its eager frame's; the
walk kernel's iteration sum and the trace kernels' counts against the
twins or their own aux; graph frames bit for bit the eager ones, two
cameras through one graph; a replayed frame's host, from its camera to
its graph's launch, making no device op, and one synchronisation) skip
without a card.  This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only CUDA PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathbench import devtrace
from zig_raytracing_contest_tpu_torch import kernels
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect
from zig_raytracing_contest_tpu_torch.ops.dda import GridParams
from zig_raytracing_contest_tpu_torch.render import pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene.types import GridScene

W, H = 64, 32  # 2 spp: 4096 rays, two full waves of 2048
SPANS = ("zrc.render.plan", "zrc.render.par", "zrc.render.waves", "zrc.render.to_host")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test, beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    return tproc.bench_scene(tmp_path_factory.mktemp("trace") / "b.gltf", num_objects=40)


def prepare(path, route, device="cpu", monkeypatch=None, **cfg):
    """(scene, camera, config) of the small bench scene through ``route``:
    "grid" (the XLA shading path's grid walk), "stream" (the per-bounce
    pipeline streaming the group heap, the thresholds lowered before the
    bake), "whole" (the whole-path tile kernels) or "ext" (Russian
    roulette: the XLA shading path over the bake's tile heap)."""
    if route == "stream":
        for mod, name in ((mxu_intersect, "REC_EMIT_MAX_TRIS"),
                          (mxu_intersect, "VMEM_RESIDENT_MAX_TRIS"),
                          (wavefront, "SORT_MIN_TRIS")):
            monkeypatch.setattr(mod, name, 64)
    if route == "ext":
        cfg["russian_roulette"] = True
    config = Config(num_samples=2, max_bounce=3, wave_size=2048, seed=11,
                    backend="grid" if route == "grid" else "auto", grid_resolution=(8, 8, 8),
                    **cfg)
    scene, cam, _ = pipeline.prepare_scene(str(path), config, camera_name="Camera 1",
                                           width=W, height=H, device=device)
    want = {"grid": "XLA shading, grid", "stream": "streaming, sorted",
            "whole": "whole path", "ext": "XLA shading, tile heap"}[route]
    assert wavefront.regime(scene, config.ext_flags) == want
    return scene, cam, config


def test_spans_land_in_the_profiler_trace_in_order(scene_file, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    scene, cam, cfg = prepare(scene_file, "grid")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.FRAME_LABEL):
            _, stats = pipeline.render_scene(scene, cam, cfg)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = devtrace.read_trace(path)
    spans = {name: (s, e) for s, e, name in trace.host if name.startswith("zrc.")}
    assert set(spans) >= {"zrc.render", *SPANS}
    render = spans["zrc.render"]
    assert trace.start <= render[0] and render[1] <= trace.end
    inner = [spans[n] for n in SPANS]
    assert all(render[0] <= s and e <= render[1] for s, e in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))  # one after the other
    assert set(stats.phases) >= {"render", *(n[len("zrc."):] for n in SPANS)}


def test_no_profiler_opens_no_range(scene_file, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    scene, cam, cfg = prepare(scene_file, "grid")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, stats = pipeline.render_scene(scene, cam, cfg)
    assert stats.phases["render.waves"] > 0 and "render.replay" not in stats.phases


def test_compile_spans_sum_inside_the_compile_phase(scene_file):
    config = Config(num_samples=1, max_bounce=1, backend="grid", grid_resolution=(8, 8, 8))
    _, _, timers = pipeline.prepare_scene(str(scene_file), config, camera_name="Camera 1",
                                          width=8, height=8, device="cpu")
    ph = timers.phases
    assert {"load", "preprocess", "compile", "compile.grid", "compile.bake"} <= set(ph)
    assert ph["compile.grid"] + ph["compile.bake"] <= ph["compile"]


@pytest.mark.parametrize("route", ["grid", "stream", "whole", "ext"])
def test_rays_alive_add_up_to_the_segments(scene_file, monkeypatch, route):
    scene, cam, cfg = prepare(scene_file, route, monkeypatch=monkeypatch)
    plan = pipeline.frame_plan(scene, cam, cfg)
    assert plan.num_waves == 2 and plan.waves_run == 2  # full waves: no lane past the image
    _, stats = pipeline.render_scene(scene, cam, cfg)
    c = stats.counters
    assert set(c) == {"segments", "lanes", *wavefront.WORK_COUNTERS}
    assert c["segments"] == stats.segments == c["alive"] > 0
    assert c["lanes"] == 2 * 2048 * 3
    if route == "grid":  # no tiles; the walk's iterations
        assert c["tiles"] == c["boxes"] == 0
        assert c["walk_iterations"] >= c["alive"]
    else:  # no walk; the twins' flat loop tests every tile box of a live ray
        assert c["walk_iterations"] == 0
        assert c["boxes"] == c["alive"] * scene.tile_bbox.shape[1]
        assert 0 < c["tiles"] <= c["boxes"]


def test_the_registry_sums_frames_beside_the_launches(scene_file):
    keys = set(kernels.LAUNCHES)
    scene, cam, cfg = prepare(scene_file, "grid")
    kernels.reset_launches()
    assert kernels.COUNTERS == {"frames": 0}
    _, first = pipeline.render_scene(scene, cam, cfg)
    _, second = pipeline.render_scene(scene, cam, cfg)
    assert first.counters == second.counters
    assert kernels.COUNTERS == {"frames": 2, **{k: 2 * v for k, v in first.counters.items()}}
    assert set(kernels.LAUNCHES) == keys
    kernels.reset_launches()
    assert kernels.COUNTERS == {"frames": 0}
    assert set(kernels.LAUNCHES) == keys and not any(kernels.LAUNCHES.values())


def hand_grid(device="cpu"):
    """A 4×1×1 grid of unit cells over [0, 4]×[0, 1]×[0, 1] whose cells hold
    0, 5, 2 and 0 references, every one the triangle x = 1.5, y + z <= 1,
    facing -x."""
    p0, p1, p2 = (1.5, 0.0, 0.0), (1.5, 0.0, 1.0), (1.5, 1.0, 0.0)
    rows = 7 + 1  # references and the pad row

    def rows_of(v):
        return torch.tensor([v] * rows, dtype=torch.float32)

    grid = GridScene(
        params=GridParams(torch.tensor([0.0, 0.0, 0.0]), torch.tensor([4.0, 1.0, 1.0]),
                          torch.tensor([4, 1, 1]), torch.tensor([1.0, 1.0, 1.0])),
        cell_begin=torch.tensor([0, 0, 5, 7]), cell_end=torch.tensor([0, 5, 7, 7]),
        tri_v0=rows_of(p0), tri_e1=rows_of(np.subtract(p1, p0).tolist()),
        tri_e2=rows_of(np.subtract(p2, p0).tolist()),
        dup_to_tri=torch.zeros(rows, dtype=torch.int64))
    return SimpleNamespace(grid=grid.to(device) if device != "cpu" else grid)


# (origin, direction, active, iterations by hand): a cell of n references
# takes max(1, ceil(n / 4)) iterations, the last one stepping; a ray is done
# at the step where its hit lies before the crossing, or at the exit cell
HAND_RAYS = [
    ((-1.0, 0.8, 0.8), (1.0, 0.0, 0.0), True, 1 + 2 + 1 + 1),  # misses, crosses 4 cells
    ((-1.0, 0.2, 0.2), (1.0, 0.0, 0.0), True, 1 + 2),  # hits at x = 1.5 in cell 1
    ((-1.0, 0.2, 0.2), (1.0, 0.0, 0.0), False, 0),  # not active
    ((3.5, 0.8, 0.8), (-1.0, 0.0, 0.0), True, 1 + 1 + 2 + 1),  # from cell 3 back to 0
    ((-1.0, 5.0, 5.0), (1.0, 0.0, 0.0), True, 0),  # misses the grid's box
]


def hand_rays(device="cpu"):
    o = torch.tensor([r[0] for r in HAND_RAYS], dtype=torch.float32, device=device)
    d = torch.tensor([r[1] for r in HAND_RAYS], dtype=torch.float32, device=device)
    a = torch.tensor([r[2] for r in HAND_RAYS], device=device)
    return o, d, a


def test_the_walk_twin_sums_iterations_as_counted_by_hand():
    scene = hand_grid()
    o, d, a = hand_rays()
    for i, ray in enumerate(HAND_RAYS):
        it_sum = torch.zeros(1, dtype=torch.int64)
        hit = wavefront.trace_wave_ref(scene, o[i:i + 1], d[i:i + 1], a[i:i + 1],
                                       it_sum=it_sum)
        assert int(it_sum) == ray[3] == int(hit.iterations)
    it_sum = torch.full((1,), 7, dtype=torch.int64)  # added to, not overwritten
    hit = wavefront.trace_wave_ref(scene, o, d, a, it_sum=it_sum)
    assert int(it_sum) == 7 + sum(r[3] for r in HAND_RAYS)
    assert int(hit.iterations) == max(r[3] for r in HAND_RAYS)
    assert torch.isfinite(hit.t).tolist() == [False, True, False, False, False]
    assert hit.t[1].item() == 2.5


# ------------------------------------------------------------------ card


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["grid", "stream", "whole", "ext"])
def test_graph_frames_count_and_render_as_the_eager_frame_on_cuda(scene_file, monkeypatch,
                                                                  route):
    """Warm-up, capture and two replays against graph=False: images and
    segments bit for bit, counters equal, the spans of each kind."""
    dev = card()
    scene, cam, cfg = prepare(scene_file, route, device=dev, monkeypatch=monkeypatch)
    want, eager = pipeline.render_scene(scene, cam, cfg, graph=False)
    assert eager.counters["alive"] == eager.segments
    for span in ("render.eager", "render.capture", "render.replay", "render.replay"):
        timers = pipeline.PhaseTimers()
        img, st = pipeline.render_scene(scene, cam, cfg, timers=timers)
        assert span in timers.phases
        np.testing.assert_array_equal(img, want)
        assert st.segments == eager.segments and st.counters == eager.counters


def moved(cam):
    """The camera moved and turned a little: another image of the scene."""
    return SimpleNamespace(width=cam.width, height=cam.height,
                           origin=cam.origin + np.float32([0.4, -0.2, 0.3]),
                           lower_left_corner=cam.lower_left_corner + np.float32([0.1, 0.05, 0]),
                           right=cam.right, up=cam.up)


LAUNCHING = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cudaStreamSynchronize")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["grid", "stream", "whole", "ext"])
def test_a_replayed_frame_launches_its_graph_first_on_cuda(scene_file, monkeypatch, route,
                                                           tmp_path):
    """Two cameras alternated through one graph (warm-up, capture, two
    replays) render bit for bit as their eager frames, each frame's camera
    staged.  Under torch.profiler a replayed frame runs no aten op
    and no launching or synchronising runtime call from the start of
    ``zrc.render.par`` to ``cudaGraphLaunch``, and synchronises once, in
    ``image_to_host`` (``zrc.render.to_host``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = card()
    scene, cam, cfg = prepare(scene_file, route, device=dev, monkeypatch=monkeypatch)
    cams = (cam, moved(cam))
    want = [pipeline.render_scene(scene, c, cfg, graph=False) for c in cams]
    assert not np.array_equal(want[0][0], want[1][0])
    for i in range(4):
        img, st = pipeline.render_scene(scene, cams[i % 2], cfg)
        np.testing.assert_array_equal(img, want[i % 2][0])
        assert st.counters == want[i % 2][1].counters
    entry = pipeline.frame_graph(scene, pipeline.frame_plan(scene, cam, cfg))
    assert entry.replay is not None and entry.frames == entry.staged == 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.FRAME_LABEL):
            img, st = pipeline.render_scene(scene, cams[1], cfg)
    np.testing.assert_array_equal(img, want[1][0])
    assert entry.frames == entry.staged == 5
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = devtrace.read_trace(path)
    host = [h for h in trace.host if trace.start <= h[0] <= trace.end]
    spans = {name: (s, e) for s, e, name in host if name.startswith("zrc.")}
    (launch,) = [s for s, _, name in host if name == "cudaGraphLaunch"]
    before = [name for s, _, name in host if spans["zrc.render.par"][0] <= s < launch]
    assert not [n for n in before if n.startswith("aten::") or n.startswith(LAUNCHING)], before
    syncs = [s for s, _, name in host if name == "cudaStreamSynchronize"]
    to_host = spans["zrc.render.to_host"]
    assert len(syncs) == 1 and to_host[0] <= syncs[0] <= to_host[1]


@pytest.mark.cuda
def test_walk_kernel_sums_iterations_as_the_twin_on_cuda(scene_file):
    dev = card()
    scene = hand_grid(dev)
    o, d, a = hand_rays(dev)
    got = torch.zeros(1, dtype=torch.int64, device=dev)
    hit = wavefront.trace_wave(scene, o, d, a, it_sum=got)
    assert int(got) == sum(r[3] for r in HAND_RAYS)
    assert int(hit.iterations) == max(r[3] for r in HAND_RAYS)
    gscene, cam, cfg = prepare(scene_file, "grid", device=dev)
    par = wavefront.build_gen_par(gscene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    o, d, _ = wavefront.xla_primary_rays(par, W, 2, 0, W * H * 2, 3)
    a = torch.arange(o.shape[0], device=dev) % 7 != 0
    sums = []
    for walk in (wavefront.trace_wave, wavefront.trace_wave_ref):
        s = torch.zeros(1, dtype=torch.int64, device=dev)
        hit = walk(gscene, o, d, a, it_sum=s)
        sums.append((int(s), int(hit.iterations), hit.t.cpu()))
    assert sums[0][:2] == sums[1][:2] and sums[0][0] > 0
    assert torch.equal(sums[0][2], sums[1][2])


@pytest.mark.cuda
def test_trace_kernel_counts_are_its_aux_sums_on_cuda(scene_file, monkeypatch):
    dev = card()
    scene, cam, cfg = prepare(scene_file, "stream", device=dev, monkeypatch=monkeypatch)
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    state = wavefront.gen_rays_raster(par, 3, 0, W * H * 2, 2, W)
    state[12, ::5] = 0.0  # some lanes dead
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    aux, _, _ = mxu_intersect.trace_emit_aux(scene, state, counts=counts)
    want = [int((aux[4] > 0).sum()), int(aux[5].to(torch.int64).sum()),
            int(aux[6].to(torch.int64).sum())]
    assert counts.tolist() == want and want[0] == int((state[12] > 0).sum())
    plain, _, _ = mxu_intersect.trace_emit_aux(scene, state)  # no counts: the same aux
    assert torch.equal(aux.view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
def test_whole_path_kernels_count_as_the_twins_on_cuda(scene_file):
    """path_trace_gen's and path_trace's counters against the twins': the
    rays alive and the boxes (every tile's, for a live ray) exactly; the
    tiles swept exactly from the same input state (bounce 1 after the
    sort), and within a thousandth from the generator's rays (which may
    differ from the twin's in the last bits)."""
    from zig_raytracing_contest_tpu_torch.render import fused

    dev = card()
    scene, cam, cfg = prepare(scene_file, "whole", device=dev)
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    R = W * H * 2
    gen = fused.GenParams(spp=2, width=W, img_w=W, img_h=H, tiles_x=0)
    args = (scene, par, (0, 0, 0, 11, 0, 0, 0, 0), R, 1, gen)
    got = {k: torch.zeros(3, dtype=torch.int64, device=dev) for k in ("k0", "t0", "k1", "t1")}
    st, idx = fused.path_trace_gen(*args, emit_key=True, emit_idx=True, counts=got["k0"])
    fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True, counts=got["t0"])
    _, st, (idx,) = wavefront.sort_state_payload(st[15].contiguous().view(torch.int32), st,
                                                 (idx,))
    fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx, counts=got["k1"])
    fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx, counts=got["t1"])
    k0, t0, k1, t1 = (got[k].tolist() for k in ("k0", "t0", "k1", "t1"))
    nt = scene.tile_bbox.shape[1]
    assert k0[0] == t0[0] == R and k0[2] == t0[2] == R * nt
    assert t0[1] > 0 and abs(k0[1] - t0[1]) <= t0[1] // 1000
    assert k1 == t1 and 0 < k1[0] < R and k1[2] == k1[0] * nt
