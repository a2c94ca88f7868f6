"""The whole-frame device call and the host beam-sort key, on the CPU.

* ``ray_sort_key_ref`` (the twin of ray_sort_key_kernel) against the JAX
  package's ``_ray_sort_key`` bit for bit on the built lanes of
  ``probes.sort_key.edge_lanes``: zero direction components with the
  origin on a box face, a flat scene box, ±inf slab times, dead lanes
  holding garbage;
* ``_render_frame_waves`` (what the card captures into one CUDA graph a
  frame, run eagerly here) against the wave-by-wave loop it replaced, image
  and segments bit for bit, in the whole path and the sorted per-bounce
  pipeline; and a sorted per-bounce frame through the graph route against
  the JAX package's whole-frame call (``render_frame_chunk_emit``);
* the graph route with a stub in place of the capture: two cameras through
  one cache entry, ``kernels.LAUNCHES`` per replay, a capture error; a
  graph frame's staged camera bank against ``build_gen_par`` bit for bit
  (the benchmark cells' cameras and random ones), and two cameras
  alternated through ``render_frame_graph`` against their eager frames.

The stub stands in for ``capture_cuda_graph``: it runs the function once
(the capture) and on each replay runs it again into the captured outputs
with the Python launch counts left as they were, as a CUDA graph's replay
launches without passing through the launchers.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathbench import spec
from pathbench.scenes import load_writer
from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
from zig_raytracing_contest_tpu.render.pipeline import render_scene as jax_render
from zig_raytracing_contest_tpu.render.wavefront import _ray_sort_key
from zig_raytracing_contest_tpu_torch import kernels
from zig_raytracing_contest_tpu_torch.config import Config, ExtFlags
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
from zig_raytracing_contest_tpu_torch.probes.sort_key import EDGE_CASES, edge_lanes
from zig_raytracing_contest_tpu_torch.render import fused, pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene.camera import load_camera
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test, beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- host key


@pytest.mark.parametrize("case", EDGE_CASES)
def test_ray_sort_key_ref_matches_jax_on_edge_lanes(case):
    """Bit for bit.  XLA:CPU computes with subnormals flushed to zero, so
    the twin runs here in the same mode (torch.set_flush_denormal); on the
    card the kernel and PyTorch's CUDA ops both keep subnormals, and the
    chip check holds the kernel to the twin on the same lanes there."""
    state, bmin, bmax = edge_lanes(case, seed=11)
    want = np.asarray(_ray_sort_key(
        SimpleNamespace(grid=SimpleNamespace(bbox_min=jnp.asarray(bmin),
                                             bbox_max=jnp.asarray(bmax))),
        jnp.asarray(state)))
    box = SimpleNamespace(bbox_min=torch.from_numpy(bmin), bbox_max=torch.from_numpy(bmax))
    assert torch.set_flush_denormal(True)
    try:
        got = wavefront.ray_sort_key_ref(box, torch.from_numpy(state)).numpy()
        wrapped = wavefront.ray_sort_key(box, torch.from_numpy(state)).numpy()
    finally:
        torch.set_flush_denormal(False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wrapped, got)  # the CPU wrapper is the twin


def test_edge_lanes_reach_the_nan_and_inf_slabs():
    """The cases reach what they are built for: NaN slab times, a NaN exit
    time (flat box, garbage), an infinite exit time (a zero direction)."""
    def texit(case):
        st, lo, hi = (torch.from_numpy(a) for a in edge_lanes(case))
        o, d = st[0:3], st[3:6]
        inv = 1.0 / d
        far = torch.fmax((lo[:, None] - o) * inv, (hi[:, None] - o) * inv)
        return far, torch.clamp_min(torch.minimum(torch.minimum(far[0], far[1]), far[2]), 0.0)

    far, _ = texit("face_zero_dir")
    assert far.isinf().any()
    for case in ("flat_box", "dead_garbage"):
        assert texit(case)[1].isnan().sum() > 100, case
    assert texit("inf_slabs")[1].isinf().sum() > 50


def test_ray_sort_key_refuses_other_devices():
    state = torch.zeros((16, 8), device="meta")
    box = SimpleNamespace(bbox_min=torch.zeros(3), bbox_max=torch.ones(3))
    with pytest.raises(ValueError, match="no sort key kernel"):
        wavefront.ray_sort_key(box, state)


@pytest.mark.parametrize("case, match", [
    ("cpu", "needs CUDA tensors"),
    ("odd", "R = 1023 is odd"),
    ("state_offset", "state is not 8-byte aligned"),
    ("key_offset", "key_out is not 8-byte aligned"),
    ("key_dtype", "key_out has dtype"),
])
def test_launch_ray_sort_key_refuses(case, match, monkeypatch):
    """launch_ray_sort_key takes two lanes a thread (float2 rows, int2
    store): an odd R or a state or key that is not 8-byte aligned raises
    ValueError, as do CPU tensors and a wrong dtype, before the library
    loads, and nothing is counted."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    R = 1023 if case == "odd" else 1024
    state = torch.zeros(16 * R + 1)[1:].view(16, R) if case == "state_offset" \
        else torch.zeros(16, R)
    key = torch.zeros(R + 1, dtype=torch.int32)[1:] if case == "key_offset" \
        else torch.zeros(R, dtype=torch.int64 if case == "key_dtype" else torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kernels.launch_ray_sort_key(state, torch.zeros(3), torch.ones(3), key)
    assert kernels.LAUNCHES["ray_sort_key"] == 0


# ------------------------------------------------------------ frame pieces


@pytest.mark.parametrize("w,h", [(96, 64), (70, 45), (33, 100)])
def test_device_slot_map_equals_numpy(w, h):
    _, tiles_x = pipeline.slot_geometry(w, h, True)
    cache = {}
    scene = SimpleNamespace(device=torch.device("cpu"), frame_cache=lambda: cache)
    got = pipeline.device_slot_map(scene, w, h, tiles_x)
    np.testing.assert_array_equal(got.numpy(), pipeline.slot_of_pixel(w, h, tiles_x))
    assert pipeline.device_slot_map(scene, w, h, tiles_x) is got  # built once
    assert pipeline.device_slot_map(scene, w, h, 0) is None


@pytest.mark.parametrize("scene_kind, device, plain, progressive, ext, want", [
    ("baked", "cuda", False, False, None, True),
    ("baked", "cpu", False, False, None, False),
    ("baked", "cuda", True, False, None, False),
    ("baked", "cuda", False, True, None, False),
    ("baked", "cuda", False, False, ExtFlags(nee=True), True),
    ("grid", "cuda", False, False, None, True),
])
def test_graph_route(scene_kind, device, plain, progressive, ext, want):
    """Frames on a card replay a graph in every regime, the XLA shading
    path's (an extension on, or a grid scene) included; CPU, plain and
    progressive frames run wave by wave."""
    scene = SimpleNamespace(device=torch.device(device),
                            tri_data=torch.empty(16, 8) if scene_kind == "baked" else None)
    assert pipeline.graph_route(scene, ext, plain, progressive) == want


@pytest.fixture(scope="module")
def bench_path(tmp_path_factory):
    return tproc.bench_scene(tmp_path_factory.mktemp("frame") / "b.gltf", num_objects=20)


def _prepare(path, cfg, **cam_kw):
    cam_kw = cam_kw or dict(camera_name="Camera 1", width=70, height=45)
    return pipeline.prepare_scene(str(path), cfg, device="cpu", **cam_kw)[:2]


PER_BOUNCE_SORTED = ((tmi, "REC_EMIT_MAX_TRIS", 512), (wavefront, "SORT_MIN_TRIS", 512))


def _wave_loop(scene, cam, cfg):
    """The wave-by-wave loop of render_scene before the whole-frame call:
    the NumPy slot map, every wave's rows summed into the framebuffer, the
    image encoded and copied to the host."""
    w, h, spp = cam.width, cam.height, cfg.num_samples
    num_slots, tiles_x = pipeline.slot_geometry(w, h, wavefront.whole_path_regime(scene))
    total = num_slots * spp
    quantum = spp * 1024
    wave_size = max(quantum, min(cfg.wave_size, total + quantum - 1) // quantum * quantum)
    num_waves = -(-total // wave_size)
    wp = wave_size // spp
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right,
                                  cam.up)
    fb = torch.zeros((3, num_waves * wp), dtype=torch.float32)
    perm = torch.from_numpy(pipeline.slot_of_pixel(w, h, tiles_x)) if tiles_x else None
    segments = torch.zeros((), dtype=torch.int64)
    for wave in range(num_waves):
        rows3, segs = wavefront.render_wave_rows(scene, par, w, h, spp, cfg.max_bounce,
                                                 wave * wp, num_slots, wave_size, cfg.seed,
                                                 tiles_x)
        fb[:, wave * wp:(wave + 1) * wp] += rows3.reshape(3, wp, spp).sum(dim=2)
        segments += segs
    img = pipeline.finalize_image_rows(fb, w * h, spp, perm)
    return img.numpy().reshape(h, w, 3), int(segments), num_waves


@pytest.mark.parametrize("regime", ["whole path", "per-bounce, sorted"])
def test_frame_waves_equal_the_wave_loop(bench_path, regime, monkeypatch):
    """_render_frame_waves (through render_scene on the CPU) equals the
    wave-by-wave loop bit for bit, over several waves with a ragged last
    one; 4 bounces, so the whole path resorts on the host key."""
    if regime != "whole path":
        for mod, name, value in PER_BOUNCE_SORTED:
            monkeypatch.setattr(mod, name, value)
    cfg = Config(num_samples=2, max_bounce=4, seed=7, wave_size=1 << 11)
    scene, cam = _prepare(bench_path, cfg)
    assert wavefront.regime(scene) == regime
    keys = []
    monkeypatch.setattr(wavefront, "ray_sort_key",
                        lambda s, st, f=wavefront.ray_sort_key: keys.append(1) or f(s, st))
    want_img, want_segs, num_waves = _wave_loop(scene, cam, cfg)
    calls = len(keys)
    assert num_waves > 2 and calls >= num_waves
    img, st = pipeline.render_scene(scene, cam, cfg)
    assert len(keys) == 2 * calls  # the host key ran on the same waves
    assert st.segments == want_segs
    np.testing.assert_array_equal(img, want_img)


# ---------------------------------------------------------- the graph route


def stub_capture(fn, device):
    """Stands in for capture_cuda_graph: (replay, outputs, pool bytes)."""
    out = fn()

    def replay():
        before = dict(kernels.LAUNCHES)
        for dst, src in zip(out, fn()):
            dst.copy_(src)
        kernels.add_launches({k: before[k] - n for k, n in kernels.LAUNCHES.items()})

    return replay, out, 0


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """render_scene takes the graph route on the CPU, with stub_capture;
    the captures made are listed."""
    captures = []

    def capture(fn, device):
        captures.append(device)
        return stub_capture(fn, device)

    monkeypatch.setattr(pipeline, "graph_route", lambda *a, **k: True)
    monkeypatch.setattr(pipeline, "capture_cuda_graph", capture)
    return captures


def _camera_2(cam):
    """The camera moved and turned a little: another image of the scene."""
    return SimpleNamespace(width=cam.width, height=cam.height,
                           origin=np.asarray(cam.origin) + np.float32([0.4, -0.2, 0.3]),
                           lower_left_corner=np.asarray(cam.lower_left_corner)
                           + np.float32([0.1, 0.05, 0.0]),
                           right=cam.right, up=cam.up)


def test_two_cameras_through_one_graph_entry(bench_path, graph_on_cpu):
    """Frames of two cameras through one FrameGraph: the first runs eagerly,
    the second captures and replays, the third replays; each equals its
    camera's eager frame, so the replay reads the refreshed ``par``."""
    cfg = Config(num_samples=2, max_bounce=4, seed=3, wave_size=1 << 12)
    scene, cam = _prepare(bench_path, cfg)
    cam2 = _camera_2(cam)
    want = {id(c): pipeline.render_scene(scene, c, cfg, graph=False) for c in (cam, cam2)}
    assert not np.array_equal(want[id(cam)][0], want[id(cam2)][0])
    for i, c in enumerate((cam, cam2, cam, cam2)):
        img, st = pipeline.render_scene(scene, c, cfg)
        np.testing.assert_array_equal(img, want[id(c)][0])
        assert st.segments == want[id(c)][1].segments
        assert len(graph_on_cpu) == (0 if i == 0 else 1)
    entries = [v for v in scene.frame_cache().values() if isinstance(v, pipeline.FrameGraph)]
    assert len(entries) == 1 and entries[0].frames == entries[0].staged == 4
    # another frame key (another seed) takes its own entry
    pipeline.render_scene(scene, cam, Config(num_samples=2, max_bounce=4, seed=4,
                                             wave_size=1 << 12))
    assert sum(isinstance(v, pipeline.FrameGraph) for v in scene.frame_cache().values()) == 2


def _cell_camera(config, height, tmp_path, **args):
    """The camera of a benchmark configuration's scene file at its cell's
    height (the writers place it apart from ``detail`` and the textures)."""
    cfg = spec.load_config(config)
    path = tmp_path / cfg["file"]
    load_writer(cfg["writer"])(path, **{**cfg["writer_args"], **args})
    return load_camera(load_gltf(path), cfg["camera"], None, height)


def _random_camera(seed, dtype):
    rng = np.random.default_rng(seed)
    vec = [rng.normal(0.0, 10.0 ** rng.integers(-2, 4), 3).astype(dtype) for _ in range(4)]
    return SimpleNamespace(origin=vec[0], lower_left_corner=vec[1], right=vec[2], up=vec[3])


CAMERAS = {
    "sponza": lambda tmp: _cell_camera("sponza_interior", 720, tmp, detail=0.05, tex=48),
    "duck": lambda tmp: _cell_camera("duck_room", 1080, tmp, tex_size=16),
    "random-f32": lambda tmp: _random_camera(29, np.float32),
    "random-f64": lambda tmp: _random_camera(2**31 + 29, np.float64),  # rounded to f32 both ways
}
BOXES = {  # (bbox_min, bbox_max): the Sponza stand-in's hall, and one flat along y
    "hall": ([-15.25, -0.125, -6.0625], [15.0, 10.5, 6.1875]),
    "flat": ([-3.0, 2.0, -0.5], [7.0, 2.0, 9.0]),
}


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("which", list(CAMERAS))
def test_staged_bank_equals_build_gen_par(which, box, tmp_path):
    """A FrameGraph's ``par`` after its scene fill, with a frame's staged
    camera laid into rows 0-11 as the frame's first device op lays it,
    equals ``build_gen_par`` bit for bit; staging the camera touches no
    row of ``par``."""
    lo, hi = BOXES[box]
    scene = SimpleNamespace(device=torch.device("cpu"), bbox_min=torch.tensor(lo),
                            bbox_max=torch.tensor(hi))
    assert len(set(np.subtract(hi, lo).tolist())) == 3  # not a cube
    cam = CAMERAS[which](tmp_path)
    entry = pipeline.FrameGraph(scene)
    filled = entry.par.clone()
    entry.set_camera(cam)
    assert entry.staged == 1
    assert torch.equal(entry.par.view(torch.int32), filled.view(torch.int32))
    assert not entry.par[:12].any()
    entry.par[:12].copy_(entry.staging)
    want = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    assert want.dtype == entry.par.dtype == torch.float32
    assert torch.equal(entry.par.view(torch.int32), want.view(torch.int32))


def test_staged_camera_never_goes_stale(bench_path, monkeypatch):
    """Two cameras alternated through one frame key by render_frame_graph,
    with a stub capture whose replay reruns the captured function: each
    frame's image and tally equal its camera's eager frame, the warm-up's
    as well; the counter reads one more each frame, the warm-up's too."""
    monkeypatch.setattr(pipeline, "capture_cuda_graph", stub_capture)
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=1 << 12)
    scene, cam = _prepare(bench_path, cfg)
    cam2 = _camera_2(cam)
    plan = pipeline.frame_plan(scene, cam, cfg)
    assert plan.key == pipeline.frame_plan(scene, cam2, cfg).key
    want = {}
    for c in (cam, cam2):
        img, st = pipeline.render_scene(scene, c, cfg, graph=False)
        want[id(c)] = img, [st.segments, *(st.counters[k] for k in wavefront.WORK_COUNTERS)]
    assert not np.array_equal(want[id(cam)][0], want[id(cam2)][0])
    entry = pipeline.frame_graph(scene, plan)
    for i, c in enumerate((cam, cam2, cam, cam2)):
        _, img, tally = pipeline.render_frame_graph(scene, plan, c, entry=entry)
        img, tally = pipeline.image_to_host(img, tally, plan)
        np.testing.assert_array_equal(img, want[id(c)][0])
        assert tally == want[id(c)][1]
        assert entry.frames == entry.staged == i + 1
    assert entry.replay is not None


def test_launch_counts_per_replay(bench_path, graph_on_cpu, monkeypatch):
    """kernels.LAUNCHES after N graph frames equals its value after N eager
    frames: the capture takes its counts back out, each replay adds the
    graph's.  The CPU twins count nothing, so counting stand-ins wrap the
    whole path's gen call and the host key."""
    for attr, name in ((fused, "path_trace_gen"), (wavefront, "ray_sort_key")):
        real = getattr(attr, name)

        def counted(*a, _real=real, _name=name, **k):
            kernels.add_launches({_name: 1})
            return _real(*a, **k)

        monkeypatch.setattr(attr, name, counted)
    cfg = Config(num_samples=2, max_bounce=4, seed=3, wave_size=1 << 12)
    scene, cam = _prepare(bench_path, cfg)
    counts = {}
    for graph in (False, True):
        kernels.reset_launches()
        for _ in range(4):
            pipeline.render_scene(scene, cam, cfg, graph=graph)
        counts[graph] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    num_waves = pipeline.frame_plan(scene, cam, cfg).num_waves
    assert counts[False] == counts[True] == {"path_trace_gen": 4 * num_waves,
                                             "ray_sort_key": 4 * num_waves}
    entry = pipeline.frame_graph(scene, pipeline.frame_plan(scene, cam, cfg))
    assert entry.launches == {"path_trace_gen": num_waves, "ray_sort_key": num_waves}


def test_capture_error_raises(bench_path, monkeypatch):
    """A capture that fails raises out of render_scene; nothing falls back
    to the eager loop."""
    def broken(fn, device):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(pipeline, "graph_route", lambda *a, **k: True)
    monkeypatch.setattr(pipeline, "capture_cuda_graph", broken)
    cfg = Config(num_samples=1, max_bounce=2, wave_size=1 << 12)
    scene, cam = _prepare(bench_path, cfg)
    pipeline.render_scene(scene, cam, cfg)  # the eager warm-up
    with pytest.raises(RuntimeError, match="capture failed"):
        pipeline.render_scene(scene, cam, cfg)


def test_graph_frame_matches_jax_whole_frame(tmp_path, graph_on_cpu, monkeypatch):
    """A sorted per-bounce frame of a small --large terrain through the
    graph route (capture and replay) against the JAX package's whole-frame
    device call (render_frame_chunk_emit chunks) bit for bit."""
    path = tproc.large_scene(tmp_path / "l.gltf", side=48)
    cam_kw = dict(camera_name="Camera 1", width=64, height=36)
    jcfg = JConfig(grid_resolution=(8, 8, 8), num_samples=2, max_bounce=3, seed=5)
    js, jcam, _ = jax_prepare(str(path), jcfg, **cam_kw)
    jimg, jst = jax_render(js, jcam, jcfg, use_fused=False)
    monkeypatch.setattr(tmi, "REC_EMIT_MAX_TRIS", 4096)
    monkeypatch.setattr(wavefront, "SORT_MIN_TRIS", 4096)
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=1 << 12)
    scene, cam = _prepare(path, cfg, **cam_kw)
    assert wavefront.regime(scene) == "per-bounce, sorted"
    for _ in range(3):  # warm-up, capture and replay, replay
        img, st = pipeline.render_scene(scene, cam, cfg)
        assert st.segments == jst.segments
        np.testing.assert_array_equal(img, jimg)
    assert len(graph_on_cpu) == 1
