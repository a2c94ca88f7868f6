"""The bake's shaded trace (``wavefront.render_wave_shaded_trace``: 2B
launches of the shaded trace_stream_kernel or trace_emit_kernel a wave of
B bounces) against its twin ``render_wave_xla``.

On the CPU (tier-1):

* ``shaded_trace`` admits a wave on a card, with the bake, an extension
  on and not ``plain``; the CPU, ``plain``, the grid and a wave with no
  extension keep their routes, and ``shade_bank`` names the route;
* ``kernels.launch_trace_shaded`` checks every operand of the wave and
  refuses CPU tensors before it loads anything, and counts nothing;
* a CPU frame with every extension never reaches the shaded trace.

On the card (``-m cuda``; this file imports neither JAX nor the JAX
package): on the seeded scene of tests/test_torch_ext_reference.py, over
the tile heap (trace_emit) and forced to stream (trace_stream), for
``nee``, ``russian_roulette`` and ``pbr`` each alone and all three, the
shaded trace's wave equals ``render_wave_xla``'s on the same wave bit for
bit (radiance and segments), every work counter is equal and the wave
launches its trace 2B times and nothing else; with NEE on a scene that
emits nothing, too.
"""

from types import SimpleNamespace

import pytest
import torch

from zig_raytracing_contest_tpu_torch import kernels
from zig_raytracing_contest_tpu_torch.config import Config, ExtFlags
from zig_raytracing_contest_tpu_torch.render import pipeline, wavefront
from zig_raytracing_contest_tpu_torch.render.extensions import LightSet

_EXTS = {"none": ExtFlags(), "nee": ExtFlags(nee=True),
         "russian_roulette": ExtFlags(russian_roulette=True), "pbr": ExtFlags(pbr=True),
         "all": ExtFlags(nee=True, russian_roulette=True, pbr=True)}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
@pytest.mark.parametrize("ext", list(_EXTS))
@pytest.mark.parametrize("kind", ["grid", "baked"])
def test_which_waves_shade_in_the_trace(kind, ext, plain, device):
    """``shaded_trace`` on stub scenes: a baked scene, an extension on,
    through the kernels, on a card; never on the CPU, with ``plain``, on the
    grid or with no extension.  ``shade_bank`` names each XLA-path route."""
    scene = SimpleNamespace(device=torch.device(device), bank_resident=True,
                            tri_data=None if kind == "grid" else torch.empty(16, 8))
    flags = _EXTS[ext]
    want = kind == "baked" and ext != "none" and not plain and device == "cuda"
    assert wavefront.shaded_trace(scene, flags, plain) == want
    assert not (want and wavefront.shaded_walk(scene, flags, plain))
    if not plain and wavefront.xla_path(scene, flags):
        names = {"trace": "sampler in the trace", "walk": "sampler in the walk"}
        route = "trace" if want else ("walk" if wavefront.shaded_walk(scene, flags) else "xla")
        assert wavefront.shade_bank(scene, flags) == names.get(route, "XLA sampler")


def _lights(L=2, **over):
    f = dict(tri=torch.zeros(L, dtype=torch.int64), v0=torch.zeros(L, 3), e1=torch.zeros(L, 3),
             e2=torch.zeros(L, 3), normal=torch.zeros(L, 3), cdf=torch.ones(L),
             total_area=torch.ones(1))
    f.update(over)
    return LightSet(**f)


def _shaded_args(R=8, **over):
    """Arguments of kernels.launch_trace_shaded on CPU tensors: a stub bake
    of 3 triangles (4 padded), 4 texels, 8 rays (the generator of a
    5-pixel-wide image from slot 3, 2 spp), two lights, ``pbr``'s table and
    the counters."""
    scene = SimpleNamespace(shade_table=torch.zeros(3, 32), color_data=torch.zeros(4, 4),
                            perm=torch.zeros(4, dtype=torch.int64))
    args = dict(scene=scene, groups=True, par=torch.zeros(32), width=5, spp=2, slot_base=3,
                seed=2**40 + 7, orig=torch.zeros(R, 3), direction=torch.ones(R, 3),
                thr=torch.empty(R, 3), rows4=torch.empty(4, R), hit=torch.empty(3, R),
                idx=torch.empty(R, dtype=torch.int32), flags=torch.empty(R, dtype=torch.uint8),
                bounce=1, shadow=True, lights=_lights(), mr=torch.zeros(3, 2), roulette=True,
                counts=torch.zeros(8, dtype=torch.int64))
    for k, v in over.items():
        if k in ("shade_table", "color_data", "perm"):
            setattr(scene, k, v)
        else:
            args[k] = v
    return args


@pytest.mark.parametrize("over, match", [
    ({}, "needs CUDA tensors"),
    ({"lights": None, "mr": None, "counts": None}, "needs CUDA tensors"),
    ({"bounce": -1}, "bounce -1"),
    ({"orig": torch.zeros(8, 3, dtype=torch.float64)}, "orig has dtype"),
    ({"direction": torch.zeros(8, 4)}, "direction has shape"),
    ({"thr": torch.zeros(3, 8).T}, "thr is not contiguous"),
    ({"rows4": torch.empty(8, 4)}, "rows4 has shape"),
    ({"hit": torch.empty(8, 3)}, "hit has shape"),
    ({"idx": torch.empty(8, dtype=torch.int64)}, "idx has dtype"),
    ({"flags": torch.empty(8, dtype=torch.bool)}, "flags has dtype"),
    ({"shade_table": torch.zeros(3, 24)}, "shade has shape"),
    ({"color_data": torch.zeros(17)[1:].view(4, 4)}, "bank is not 16-byte aligned"),
    ({"perm": torch.zeros(4, dtype=torch.int32)}, "perm has dtype"),
    ({"mr": torch.zeros(2, 2)}, "mr has shape"),
    ({"lights": _lights(cdf=torch.ones(3))}, "lights.cdf has shape"),
    ({"lights": _lights(tri=torch.zeros(2, dtype=torch.int32))}, "lights.tri has dtype"),
    ({"lights": _lights(normal=torch.zeros(2, 4))}, "lights.normal has shape"),
    ({"lights": _lights(L=0)}, "no light"),
    ({"counts": torch.zeros(4, dtype=torch.int64)}, "counts has shape"),
    ({"orig": torch.zeros(0, 3)}, "0 rays"),
    ({"spp": 0}, "0 samples a pixel"),
    ({"width": 0}, "width 0"),
    ({"slot_base": -1}, "slot base -1"),
    ({"slot_base": 5 << 31}, "row 2147483648 past"),
    ({"par": torch.zeros(32, device="meta")}, "par on meta"),
    ({"par": torch.zeros(16)}, "par has shape"),
    ({"par": torch.zeros(32, dtype=torch.float64)}, "par has dtype"),
], ids=["cpu", "cpu_bare", "bounce", "orig_dtype", "dir_shape", "thr_strided", "rows4_shape",
        "hit_shape", "idx_dtype", "flags_dtype", "shade_shape", "bank_aligned", "perm_dtype",
        "mr_shape", "cdf_shape", "light_tri_dtype", "light_normal_shape", "no_light",
        "counts_shape", "no_rays", "spp", "width", "slot_base", "slot_row", "par_device",
        "par_shape", "par_dtype"])
def test_launch_trace_shaded_refuses(over, match, monkeypatch):
    """The shaded trace's launcher checks every operand before the library
    loads, as the grid walk's launchers do: CPU tensors, wrong shapes,
    dtypes, strides, devices or alignment, an empty light set or wave, a
    negative bounce, ``spp`` or a width below 1 and a negative slot base
    raise ValueError, and nothing is built or counted."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kernels.launch_trace_shaded(**_shaded_args(**over))
    assert kernels.LAUNCHES["trace_stream"] == kernels.LAUNCHES["trace_emit"] == 0


def test_cpu_extension_frames_never_reach_the_shaded_trace(tmp_path, monkeypatch):
    """A CPU frame of the seeded scene with every extension takes
    ``render_wave_xla``: with the shaded trace's launcher and the library's
    loader made to raise, it renders, and ``shaded_trace`` refuses it."""
    from test_torch_ext_reference import write_scene

    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(kernels, "launch_trace_shaded", refuse)
    monkeypatch.setattr(kernels, "load", refuse)
    cfg = Config(num_samples=1, max_bounce=3, wave_size=1 << 10, nee=True,
                 russian_roulette=True, pbr=True)
    scene, cam, _ = pipeline.prepare_scene(str(write_scene(tmp_path / "ext.gltf")), cfg,
                                           camera_name="Camera 1", width=32, height=16,
                                           device="cpu")
    assert not wavefront.shaded_trace(scene, cfg.ext_flags)
    img, st = pipeline.render_scene(scene, cam, cfg)
    assert img.shape == (16, 32, 3) and st.segments > 32 * 16


# ------------------------------------------------------------------- card

def _card_wave(tmp_path, light=True, width=160, height=80, spp=2):
    """The seeded scene of tests/test_torch_ext_reference.py on the card
    and its camera scalars → (scene, par)."""
    from test_torch_ext_reference import write_scene

    cfg = Config(num_samples=spp)
    scene, cam, _ = pipeline.prepare_scene(str(write_scene(tmp_path / "ext.gltf", light)), cfg,
                                           camera_name="Camera 1", width=width, height=height,
                                           device="cuda")
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    return scene, par


def _equal_waves(scene, par, ext, bounces, rays, width=160, spp=2, seed=2**31 + 2401,
                 slot_base=0):
    """The shaded trace's wave and ``render_wave_xla``'s on the same rays:
    lanes whose radiance or segment bits differ, both waves' counters, the
    launches of the shaded wave, and its rows4."""
    counts = {k: torch.zeros(len(wavefront.WORK_COUNTERS), dtype=torch.int64, device="cuda")
              for k in ("trace", "xla")}
    kernels.reset_launches()
    got = wavefront.render_wave_shaded_trace(scene, par, width, spp, bounces, slot_base, rays,
                                             seed, ext, counts["trace"])
    launched = kernels.launches_since({k: 0 for k in kernels.LAUNCHES})
    want = wavefront.render_wave_xla(scene, par, width, spp, bounces, slot_base, rays, seed,
                                     ext, counts=counts["xla"])
    torch.cuda.synchronize()
    assert got.shape == want.shape == (4, rays)
    differ = (got.view(torch.int32) != want.view(torch.int32)).any(dim=0)
    return differ, counts, launched, got


# The waves of the card tests: (rays, the generator's width, spp and slot
# base): the frame's first wave, a ragged one, and waves off the frame's
# first at spp 1 and 3, one of a width that does not divide it (the pixel
# walk wraps rows), and one pixel's 2^20 + 3 samples, whose global ray ids
# (slot base · spp + lane) pass 2^32 and wrap.
_WAVES = {"full": (160 * 80 * 2, 160, 2, 0), "ragged": (160 * 80 * 2 - 37, 160, 2, 0),
          "spp1_slot": (5000, 160, 1, 1037), "spp3_slot_width": (3 * 3000 + 1, 157, 3, 4099),
          "wrap32": (4096, 160, (1 << 20) + 3, 4099)}


@pytest.mark.cuda
@pytest.mark.parametrize("wave", list(_WAVES))
@pytest.mark.parametrize("heap", ["trace_emit", "trace_stream"])
@pytest.mark.parametrize("ext", ["nee", "russian_roulette", "pbr", "all"])
def test_shaded_trace_equals_xla_wave_on_cuda(tmp_path, monkeypatch, ext, heap, wave):
    """The shaded trace's wave (4 bounces: 8 launches of the heap's trace,
    the first making the primary rays) against ``render_wave_xla`` on the
    card, on the seeded scene over the tile heap and forced to stream
    (VMEM_RESIDENT_MAX_TRIS lowered below its padded triangles), on each
    wave of ``_WAVES``: radiance and segments bit for bit, the eight work
    counters equal, 2B launches of the one trace kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi

    scene, par = _card_wave(tmp_path)
    if heap == "trace_stream":
        monkeypatch.setattr(mi, "VMEM_RESIDENT_MAX_TRIS", scene.tri_data.shape[1] - 1)
    assert mi.streams_bank(scene) == (heap == "trace_stream")
    flags = _EXTS[ext]
    assert wavefront.shaded_trace(scene, flags) and not wavefront.shaded_trace(scene, flags, True)
    rays, width, spp, slot_base = _WAVES[wave]
    differ, counts, launched, got = _equal_waves(scene, par, flags, 4, rays, width, spp,
                                                 slot_base=slot_base)
    assert int(differ.sum()) == 0, (ext, heap, int(differ.sum()), differ.nonzero()[:4, 0].tolist())
    assert torch.equal(counts["trace"], counts["xla"]), (counts["trace"], counts["xla"])
    assert launched == {heap: 8}
    c = dict(zip(wavefront.WORK_COUNTERS, counts["trace"].tolist()))
    assert c["alive"] == int(got[3].sum()) > rays
    assert (c["shadow_rays"] > 0) == flags.nee and (c["specular"] > 0) == flags.pbr
    assert c["tiles"] > 0 and c["boxes"] > 0


@pytest.mark.cuda
def test_shaded_trace_with_nee_and_no_emitter_on_cuda(tmp_path):
    """NEE on a scene that emits nothing (no light table): the shaded
    trace's wave equals ``render_wave_xla``'s bit for bit, traces no shadow
    ray and still launches twice a bounce."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    scene, par = _card_wave(tmp_path, light=False)
    assert scene.lights is None
    flags = ExtFlags(nee=True, russian_roulette=True)
    differ, counts, launched, _ = _equal_waves(scene, par, flags, 3, 160 * 80 * 2)
    assert int(differ.sum()) == 0
    assert torch.equal(counts["trace"], counts["xla"]), (counts["trace"], counts["xla"])
    assert int(counts["trace"][4]) == 0 and launched == {"trace_emit": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("wave", list(_WAVES))
@pytest.mark.parametrize("route", ["walk", "trace"])
def test_first_launch_makes_the_primary_rays_on_cuda(tmp_path, route, wave):
    """The first launch of a shaded wave makes each lane's primary ray:
    launch 0 of the shaded walk (the seeded scene on the grid) and the
    nearest launch of bounce 0 of the shaded trace (on its bake) leave
    ``orig`` and ``direction`` equal to ``xla_primary_rays``' bit for bit,
    and the throughput 1, on each wave of ``_WAVES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from test_torch_ext_reference import write_scene

    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect

    rays, width, spp, slot_base = _WAVES[wave]
    seed = 2**31 + 2401
    cfg = Config(num_samples=2, backend="grid" if route == "walk" else "auto")
    scene, cam, _ = pipeline.prepare_scene(str(write_scene(tmp_path / "ext.gltf")), cfg,
                                           camera_name="Camera 1", width=160, height=80,
                                           device="cuda")
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    f32 = dict(dtype=torch.float32, device="cuda")
    orig, direction, thr = (torch.full((rays, 3), float("nan"), **f32) for _ in range(3))
    rows4 = torch.empty((4, rays), **f32)
    if route == "walk":
        assert wavefront.shaded_walk(scene)
        t, u, v = (torch.empty(rays, **f32) for _ in range(3))
        idx = torch.empty(rays, dtype=torch.int64, device="cuda")
        kernels.launch_grid_walk_shaded(scene.grid.kernel_operands(), scene.shade_table,
                                        scene.color_data, par, width, spp, slot_base, seed,
                                        orig, direction, thr, rows4, t, u, v, idx,
                                        torch.zeros(2, dtype=torch.int32, device="cuda"), 0, 2)
    else:
        assert wavefront.shaded_trace(scene, ExtFlags(nee=True))
        hit = torch.empty((3, rays), **f32)
        idx = torch.empty(rays, dtype=torch.int32, device="cuda")
        flags = torch.empty(rays, dtype=torch.uint8, device="cuda")
        kernels.launch_trace_shaded(scene, mxu_intersect.streams_bank(scene), par, width, spp,
                                    slot_base, seed, orig, direction, thr, rows4, hit, idx,
                                    flags, 0, False)
    o, d, _ = wavefront.xla_primary_rays(par, width, spp, slot_base, rays, seed)
    torch.cuda.synchronize()
    assert torch.equal(orig.view(torch.int32), o.contiguous().view(torch.int32))
    differ = (direction.view(torch.int32) != d.view(torch.int32)).any(dim=1)
    assert int(differ.sum()) == 0, (route, wave, differ.nonzero()[:4, 0].tolist())
    assert torch.equal(thr, torch.ones_like(thr))
