"""The CUDA kernels against their plain PyTorch twins, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only CUDA PyTorch and nvcc.  There, from the repository root
(tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Elsewhere the tests skip: a CUDA kernel has no CPU mode.
chip_smoke.py runs the same comparisons at the shapes of the official and
``--large`` frames.
"""

from pathlib import Path

import pytest
import torch

from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc


@pytest.mark.cuda
def test_kernels_match_twins_on_cuda(tmp_path):
    """Rows 12-15 and the winner index exactly; value rows to f32 rounding
    (direction rows carry the libm ULPs of rsqrt/log/sin/cos: 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        sort_state_payload,
    )

    path = tproc.bench_scene(tmp_path / "b.gltf", num_objects=60)
    cfg = Config(num_samples=3, max_bounce=4)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=160, height=96, device="cuda")
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(3, 160, 160, 96, tiles_x=5)
    R = 15 * 1024 * 3
    args = (scene, par, (0,) * 8, R, 1, gen)
    k, ki = fused.path_trace_gen(*args, emit_key=True, emit_idx=True)
    t, ti = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True)
    assert torch.equal(k[12:16].view(torch.int32), t[12:16].view(torch.int32))
    assert torch.equal(ki, ti)
    torch.testing.assert_close(k[0:12], t[0:12], rtol=3e-6, atol=1e-5)
    _, st, (idx,) = sort_state_payload(k[15].contiguous().view(torch.int32), k, (ki,))
    k2 = fused.path_trace_fused(scene, st, 3, bounce0=1, prev=idx)
    t2 = fused.path_trace_fused_ref(scene, st, 3, bounce0=1, prev=idx)
    # (row 13 holds RNG streams as f32 bit patterns, some of them NaN)
    assert torch.equal(k2[12:16].view(torch.int32), t2[12:16].view(torch.int32))
    torch.testing.assert_close(k2[0:12], t2[0:12], rtol=3e-6, atol=1e-5)


@pytest.mark.cuda
def test_per_bounce_kernels_match_twins_on_cuda(tmp_path):
    """trace_emit_aux: aux rows 3-4 and t exactly; where the winners agree
    u, v and the record exactly (elsewhere two triangles tie at that t, and
    the tree walk and the flat loop break the tie by their visit orders).
    shade_fused: rows 12-15 exactly, value rows to f32 rounding (direction
    rows carry the libm ULPs of rsqrt/log/sin/cos: 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        gen_rays_raster,
        ray_sort_key,
        sort_state_payload,
    )

    path = tproc.large_scene(tmp_path / "l.gltf", side=48)
    cfg = Config(num_samples=2, max_bounce=3)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=96, height=64, device="cuda")
    assert scene.tile_bbox.shape[1] == 37  # the tree walk, not the flat loop
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    state = gen_rays_raster(par, 0, 0, 96 * 64 * 2, 2, 96)
    prev = None
    kernels.reset_launches()
    for bounce in range(3):
        extra = () if prev is None else (prev,)
        _, state, extra = sort_state_payload(ray_sort_key(scene, state), state, extra)
        prev = extra[0] if extra else None
        ka, ki, kr = mi.trace_emit_aux(scene, state, scene.rec_table, prev)
        ta, ti, tr = mi.trace_emit_aux_ref(scene, state, scene.rec_table, prev)
        assert torch.equal(ka[3:5].view(torch.int32), ta[3:5].view(torch.int32))
        assert torch.equal(ka[2], ta[2])
        same = ki == ti
        assert float(same.float().mean()) > 0.99
        assert torch.equal(ka[0:2][:, same], ta[0:2][:, same])
        assert torch.equal(kr[:, same], tr[:, same])
        # a tie: the kernel's winner is hit at the twin's t, with its own
        # u, v and record, and is not the excluded triangle
        w = ki[~same]
        hit, tw, uw, vw = mi.triangle_hit_ref(scene.tri_data, state[0:3, ~same],
                                              state[3:6, ~same], w)
        assert bool(hit.all()) and torch.equal(tw, ta[2][~same])
        assert torch.equal(uw, ka[0][~same]) and torch.equal(vw, ka[1][~same])
        assert torch.equal(kr[:, ~same], scene.rec_table[:, w.long()])
        if prev is not None:
            assert not bool((w == prev[~same]).any())
        k = fused.shade_fused(scene, state, ka, ki, bounce, kr)
        t = fused.shade_fused_ref(scene, state, ka, ki, bounce, kr)
        assert torch.equal(k[12:16].view(torch.int32), t[12:16].view(torch.int32))
        torch.testing.assert_close(k[0:12], t[0:12], rtol=3e-6, atol=1e-5)
        state, prev = k, ki
    assert kernels.LAUNCHES["trace_emit"] == kernels.LAUNCHES["shade"] == 3
    assert kernels.LAUNCHES["trace_stream"] == 0


@pytest.mark.cuda
def test_trace_stream_kernel_matches_twin_on_cuda(tmp_path, monkeypatch):
    """trace_stream_kernel on a small terrain forced to stream
    (VMEM_RESIDENT_MAX_TRIS lowered below its 5120 padded triangles): 37
    tiles in 5 groups, the last one short of tiles, so the group heap has 8
    leaves, 3 of them empty.  The same parity rule as trace_emit_aux, and
    only the streaming kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        gen_rays_raster,
        ray_sort_key,
        sort_state_payload,
    )

    path = tproc.large_scene(tmp_path / "l.gltf", side=48)
    cfg = Config(num_samples=2, max_bounce=3)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=96, height=64, device="cuda")
    assert scene.group_bbox.shape[1] == 5 and scene.group_tree_bbox.shape[1] == 16
    monkeypatch.setattr(mi, "VMEM_RESIDENT_MAX_TRIS", 4096)
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    state = gen_rays_raster(par, 0, 0, 96 * 64 * 2, 2, 96)
    _, state, _ = sort_state_payload(ray_sort_key(scene, state), state)
    kernels.reset_launches()
    for prev in (None, mi.trace_emit_aux_ref(scene, state)[1]):
        ka, ki, kr = mi.trace_emit_aux(scene, state, scene.rec_table, prev)
        ta, ti, tr = mi.trace_emit_aux_ref(scene, state, scene.rec_table, prev)
        assert torch.equal(ka[3:5].view(torch.int32), ta[3:5].view(torch.int32))
        assert torch.equal(ka[2], ta[2])
        same = ki == ti
        assert float(same.float().mean()) > 0.99
        assert torch.equal(ka[0:2][:, same], ta[0:2][:, same])
        assert torch.equal(kr[:, same], tr[:, same])
        w = ki[~same]
        hit, tw, _, _ = mi.triangle_hit_ref(scene.tri_data, state[0:3, ~same],
                                            state[3:6, ~same], w)
        assert bool(hit.all()) and torch.equal(tw, ta[2][~same])
        assert bool((ka[5] <= scene.tile_bbox.shape[1]).all())
    assert kernels.LAUNCHES["trace_stream"] == 2
    assert kernels.LAUNCHES["trace_emit"] == 0


@pytest.mark.cuda
def test_whole_path_tree_walk_matches_twins_on_cuda(tmp_path):
    """The whole-path kernels on a Duck-class scene of 21 tiles, past the
    JAX kernels' TREE_MIN_TILES = 16, take the flat tile loop as the twins
    do: bounce 0 (key, idx), bounce 1 and bounces 1-3 held to the twins with
    rows 12-15 and the winner index exactly and value rows to f32 rounding
    (direction rows 1e-5), as on the bench scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        sort_state_payload,
        trace_walk,
    )
    from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb

    path = write_duck_glb(tmp_path / "duck.glb", tex_size=64, detail=0.5)
    cfg = Config(num_samples=3, max_bounce=4)
    scene, cam, _ = prepare_scene(str(path), cfg, height=108, device="cuda")
    assert scene.tile_bbox.shape[1] == 21 and trace_walk(scene) == "flat"
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(3, 192, 192, 108, tiles_x=6)
    R = 24 * 1024 * 3
    args = (scene, par, (0, 0, 0, 7, 0, 0, 0, 0), R, 1, gen)
    kernels.reset_launches()
    k, ki = fused.path_trace_gen(*args, emit_key=True, emit_idx=True)
    t, ti = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True)
    _, st, (idx,) = sort_state_payload(k[15].contiguous().view(torch.int32), k, (ki,))
    k1, ki1 = fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx, emit_idx=True)
    t1, ti1 = fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx, emit_idx=True)
    k3 = fused.path_trace_fused(scene, st, 3, bounce0=1, prev=idx)
    t3 = fused.path_trace_fused_ref(scene, st, 3, bounce0=1, prev=idx)
    assert torch.equal(ki, ti) and torch.equal(ki1, ti1)
    for a, b in ((k, t), (k1, t1), (k3, t3)):
        # (row 13 holds RNG streams as f32 bit patterns, some of them NaN)
        assert torch.equal(a[12:16].view(torch.int32), b[12:16].view(torch.int32))
        torch.testing.assert_close(a[0:12], b[0:12], rtol=3e-6, atol=1e-5)
    assert kernels.LAUNCHES["path_trace_gen"] == 1 and kernels.LAUNCHES["path_trace"] == 2


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_cuda():
    """texel_fetch_kernel on the paged-fetch check's banks and index
    patterns, and sort_key_kernel on 256 lanes (lanes 5-8 dead), each bit
    for bit equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.probes import check_fetch, sort_key

    kernels.reset_launches()
    fetch = check_fetch.run_checks("cuda")
    assert len(fetch) == 10 and all(bad == 0 for _, _, bad in fetch), fetch
    keys = sort_key.run_checks("cuda")
    assert all(n_ref == n_host == 0 for _, _, n_ref, n_host in keys), keys
    assert kernels.LAUNCHES["texel_fetch"] == 10 and kernels.LAUNCHES["sort_key"] == 1


@pytest.mark.cuda
def test_trace_probe_kernels_match_plain_on_cuda():
    """micro_trace_kernel in its 18 variants (u/v extraction, cull none /
    lane / warp, 128 / 256 / 512 threads) on the probe's 2^18 rays, with no
    lane off and no tie (both sweep the flat loop in ascending order);
    micro_bf16_kernel in f32 and bf16 at 16,384 and 65,536 iterations and
    probe_gather_kernel in both forms at reps 1, 64 and 512, each bit for
    bit equal to its plain version; the launch counts of the checks, per
    variant, and none for empty work; the gather's cycle count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.probes import micro_bf16, micro_trace, probe_gather

    kernels.reset_launches()
    trace = micro_trace.run_checks("cuda")
    assert len(trace) == 19 and all(bad == 0 for _, _, bad, _, _ in trace), trace
    assert all(tied == 0 for _, _, _, tied, _ in trace[:18]), trace
    sweeps = micro_bf16.run_checks("cuda")
    assert len(sweeps) == 4 and all(bad == 0 for _, _, bad in sweeps), sweeps
    gathers = probe_gather.run_checks("cuda")
    assert len(gathers) == 6 and all(bad == 0 for _, _, bad in gathers), gathers
    assert all(kernels.LAUNCHES[f"micro_trace_{c}"] == 6 for c in micro_trace.CULLS)
    assert kernels.LAUNCHES["micro_bf16_f32"] == kernels.LAUNCHES["micro_bf16_bf16"] == 2
    assert all(kernels.LAUNCHES[f"probe_gather_{f}"] == 3 for f in probe_gather.FORMS)
    # empty work launches nothing and counts nothing
    bank, states = micro_bf16.device_inputs("cuda")
    assert torch.isinf(micro_bf16.micro_bf16(bank, states[torch.float32], 0)).all()
    assert kernels.LAUNCHES["micro_bf16_f32"] == 2
    # the SM cycles of the gather's reps loop grow with the reps
    page = [torch.from_numpy(a).cuda() for a in probe_gather.make_inputs()]
    for form in probe_gather.FORMS:
        c1, c512 = (probe_gather.loop_cycles(*page, r, form) for r in (1, 512))
        assert 0 < c1 < c512, (form, c1, c512)


@pytest.mark.cuda
def test_probe_gather_chunks_on_cuda():
    """probe_gather_kernel in both forms at reps 1, 64 and 512 over one
    chunk, the default slots and 1, 4 and 8 slots an SM, each equal to the
    script's NumPy expectation exactly; the cycle count is counted both in
    one chunk (stored) and over many (summed by atomic adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.probes import probe_gather

    pg, col, row = probe_gather.make_inputs()
    page = [torch.from_numpy(a).cuda() for a in (pg, col, row)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for form in probe_gather.FORMS:
        for reps in probe_gather.REPS:
            want = torch.from_numpy(probe_gather.expected(pg, col, row, reps))
            for n in (1, None, sms, 4 * sms, 8 * sms):
                got = probe_gather.probe_gather(*page, reps, form, n)
                assert torch.equal(got.cpu().long(), want), (form, reps, n)
        one, many = (torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(2))
        probe_gather.probe_gather(*page, 512, form, 1, cycles=one)
        probe_gather.probe_gather(*page, 512, form, 4 * sms, cycles=many)
        assert 0 < int(one) and 0 < int(many), (form, int(one), int(many))


@pytest.mark.cuda
def test_staged_probe_kernels_on_boundary_cases_on_cuda():
    """micro_trace_kernel in its 18 variants and micro_bf16_kernel in f32
    and bf16 on the staged test's boundary cases (ow = ±0, ow of dw's sign,
    det at 1e-8, t a few ulps either side of the best, subnormal and
    overflowing products bt·|dw|, NaN rows; probes/micro_trace.py
    ``boundary_inputs``), bit for bit equal to their plain versions, no
    tie between the winners."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.probes import micro_bf16, micro_trace

    trace = micro_trace.boundary_checks("cuda")
    assert len(trace) == 18 and all(bad == tied == 0 for _, _, bad, tied in trace), trace
    sweeps = micro_bf16.boundary_checks("cuda")
    assert len(sweeps) == 4 and all(bad == 0 for _, _, bad in sweeps), sweeps


@pytest.mark.cuda
def test_tile_heap_walk_matches_flat_loop_on_cuda():
    """trace_emit_kernel's walk of the tile heap against the flat loop on
    the whole-path frame's bounce-0 wave of the side-90 terrain (127 tiles,
    pixel tile 920, 522,240 rays): every lane where the two differ is a
    tie, both winners hit alone at one t; lane 94331 (a ray through the
    diagonal of a terrain quad, whose two triangles lie in tiles 89 and 90)
    is one of them, with the walk's winner 11530 and the flat loop's 11519
    (tests/test_torch_probes.py holds it against the JAX package)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.probes import walk_check

    ((label, res, _),) = walk_check.run_checks("cuda", explain_lanes=False)
    assert res["rays"] == 522240 and res["live"] > 0, label
    assert all(row["tie"] for row in res["lanes"]), res["lanes"]
    lanes = {row["lane"]: row for row in res["lanes"]}
    assert lanes[94331]["walk"][1] == 11530 and lanes[94331]["flat"][1] == 11519


@pytest.mark.cuda
def test_trace_kernels_equal_walk_replay_on_cuda(tmp_path, monkeypatch):
    """trace_emit_kernel (tile heap, 37 tiles) and trace_stream_kernel (the
    same terrain forced to stream: 5 groups) against walk_check's replay of
    their walk (walk_heap_ref), at bounce 0 (sorted) and bounce 1 with the
    previous hit: u, v, t bits, idx, tiles swept and boxes tested equal on
    2048 lanes spread over the wave, tie lanes included (the replay breaks a
    tie as the kernels do, by the walk's order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.probes import walk_check
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        gen_rays_raster,
        ray_sort_key,
        sort_state_payload,
    )

    path = tproc.large_scene(tmp_path / "l.gltf", side=48)
    cfg = Config(num_samples=2, max_bounce=3)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=96, height=64, device="cuda")
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    state = gen_rays_raster(par, 0, 0, 96 * 64 * 2, 2, 96)
    _, state, _ = sort_state_payload(ray_sort_key(scene, state), state)
    R = state.shape[1]
    lanes = list(range(0, R, R // 2048))[:2048]
    kernels.reset_launches()
    for groups in (False, True):
        if groups:
            monkeypatch.setattr(mi, "VMEM_RESIDENT_MAX_TRIS", 4096)
        for prev in (None, mi.trace_emit_aux_ref(scene, state)[1]):
            aux, idx, _ = mi.trace_emit_aux(scene, state, None, prev)
            want = walk_check.walk_lanes(scene, state, prev, lanes, groups)
            assert int((torch.from_numpy(want["t"]) < float("inf")).sum()) > 200
            assert walk_check.lanes_off_walk(aux, idx, want, lanes) == 0, (groups, prev)
    assert kernels.LAUNCHES["trace_emit"] == kernels.LAUNCHES["trace_stream"] == 2


@pytest.mark.cuda
def test_whole_path_kernels_with_dead_lanes_on_cuda(tmp_path):
    """The whole-path kernels where their warps are mostly idle: a wave of
    R = 24,653 slots (R % 128 = 77, so the last block is short) over an
    image 20 pixels tall, whose padding slots are born dead (most of the
    wave); then bounces 1-3 of the sorted wave with 80% of its rays killed.
    Rows 12-15 and the winner index exactly, value rows to f32 rounding
    (direction rows 1e-5), against the twins, on the Duck-class scene of 21
    tiles (its warps sweep tiles both lane-parallel and by the warp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        sort_state_payload,
    )
    from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb

    path = write_duck_glb(tmp_path / "duck.glb", tex_size=64, detail=0.5)
    cfg = Config(num_samples=3, max_bounce=4)
    scene, cam, _ = prepare_scene(str(path), cfg, height=108, device="cuda")
    assert scene.tile_bbox.shape[1] == 21
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(3, 192, 192, 20, tiles_x=6)
    R = 8 * 1024 * 3 + 77
    assert R % 128 == 77
    args = (scene, par, (0, 0, 0, 5, 0, 0, 0, 0), R, 1, gen)
    kernels.reset_launches()
    k, ki = fused.path_trace_gen(*args, emit_key=True, emit_idx=True)
    t, ti = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True)
    live = int((t[12] > 0).sum())
    assert 0 < live < R // 2
    _, st, (idx,) = sort_state_payload(k[15].contiguous().view(torch.int32), k, (ki,))
    st = st.clone()
    gen_kill = torch.Generator().manual_seed(3)
    st[12] = torch.where(torch.rand(R, generator=gen_kill).to(st.device) < 0.8, 0.0, st[12])
    assert 0 < int((st[12] > 0).sum()) < live
    k3, ki3 = fused.path_trace_fused(scene, st, 3, bounce0=1, prev=idx, emit_idx=True)
    t3, ti3 = fused.path_trace_fused_ref(scene, st, 3, bounce0=1, prev=idx, emit_idx=True)
    assert torch.equal(ki, ti) and torch.equal(ki3, ti3)
    for a, b in ((k, t), (k3, t3)):
        # (row 13 holds RNG streams as f32 bit patterns, some of them NaN)
        assert torch.equal(a[12:16].view(torch.int32), b[12:16].view(torch.int32))
        torch.testing.assert_close(a[0:12], b[0:12], rtol=3e-6, atol=1e-5)
    assert kernels.LAUNCHES["path_trace_gen"] == 1 and kernels.LAUNCHES["path_trace"] == 1


def _large_xla_waves(tmp_path, backend, rays, device, **grid):
    """The --large terrain (bench.py --large: side 224, Camera 1 at
    1280×720, 2 spp) with ``backend`` (and ``grid_resolution`` when given),
    and its first ``rays`` primary rays as the XLA shading path makes them:
    (scene, orig, dirs, streams) on ``device``."""
    from zig_raytracing_contest_tpu_torch.render.wavefront import build_gen_par, xla_primary_rays

    path = tproc.large_scene(tmp_path / "l.gltf")
    cfg = Config(num_samples=2, max_bounce=3, backend=backend, **grid)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=1280,
                                  height=720, device=device)
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    o, d, streams = xla_primary_rays(par, 1280, 2, 0, rays, 0)
    return scene, o.contiguous(), d, streams


@pytest.mark.cuda
def test_xla_path_nearest_hit_kernel_matches_twin_on_cuda(tmp_path):
    """The XLA shading path's nearest hit on a scene with the MXU bake
    (``trace_any``, which launches trace_emit_kernel) against the flat twin
    (``plain=True``) on a 65,536-ray bounce-1 wave of the --large terrain,
    the previous hit excluded: t exactly; where the winners agree u, v and
    the unique triangle exactly; elsewhere a tie (the kernel's winner hit
    alone at the twin's t, not the excluded triangle) on under 1e-4 of the
    lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.ops.mxu_intersect import triangle_hit_ref
    from zig_raytracing_contest_tpu_torch.render.wavefront import shade_and_scatter, trace_any

    R = 1 << 16
    scene, o, d, streams = _large_xla_waves(tmp_path, "auto", R, "cuda")
    live = torch.ones(R, dtype=torch.bool, device="cuda")
    t, u, v, tri, prev = trace_any(scene, o, d, live)
    new_o, new_d, *_, through, missed, _ = shade_and_scatter(scene, o, d, t, u, v, tri,
                                                             streams, 0)
    live = ~missed
    assert 0.5 * R < int(live.sum()) < R
    kernels.reset_launches()
    k = trace_any(scene, new_o, new_d, live, exclude=prev)
    assert kernels.LAUNCHES["trace_emit"] == 1
    p = trace_any(scene, new_o, new_d, live, exclude=prev, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    same = k[4] == p[4]
    for a, b in ((k[1], p[1]), (k[2], p[2]), (k[3], p[3])):
        assert torch.equal(a[same], b[same])
    lane = (~same).nonzero()[:, 0]
    assert lane.numel() <= 1e-4 * R
    if lane.numel():
        w = k[4][lane]
        hit, t_w, _, _ = triangle_hit_ref(scene.tri_data, new_o[lane].T, new_d[lane].T, w)
        assert (hit & (t_w == p[0][lane]) & (w != prev[lane])).all()


@pytest.mark.cuda
def test_grid_trace_matches_cpu_on_cuda(tmp_path):
    """The grid walk on the card (grid_walk_kernel) against the walk on the
    CPU (its twin), the --large terrain's 128³ grid: 4096 primary rays,
    then their bounce-1 rays (scattered on the CPU) with the previous hit
    excluded: t, u, v and the triangle equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.render.wavefront import shade_and_scatter, trace_any

    R = 4096
    scene, o, d, streams = _large_xla_waves(tmp_path, "grid", R, "cuda")
    cpu = scene.to("cpu")
    o, d, streams = o.cpu(), d.cpu(), streams.cpu()
    live, prev = torch.ones(R, dtype=torch.bool), None
    for bounce in range(2):
        a = trace_any(cpu, o, d, live, exclude=prev)
        b = trace_any(scene, o.cuda(), d.cuda(), live.cuda(),
                      exclude=None if prev is None else prev.cuda())
        for x, y in zip(a, b):
            assert torch.equal(x, y.cpu())
        assert int(torch.isfinite(a[0]).sum()) > R // 4
        o, d, *_, missed, _ = shade_and_scatter(cpu, o, d, *a[:4], streams, bounce)
        live, prev = ~missed & live, a[4]


@pytest.mark.cuda
def test_sharded_frame_matches_render_scene_on_cuda(tmp_path):
    """The official scene at 320×180 (3 spp, 4 bounces, waves of 2^14 rays)
    over 4 tiles on cuda:0 against render_scene: bit-identical, equal
    segments, the whole-path kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import numpy as np

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.parallel.sharding import render_scene_sharded
    from zig_raytracing_contest_tpu_torch.render.pipeline import render_scene

    path = tproc.bench_scene(tmp_path / "b.gltf")
    cfg = Config(num_samples=3, max_bounce=4, wave_size=1 << 14)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=320,
                                  height=180, device="cuda")
    single, st_s = render_scene(scene, cam, cfg)
    kernels.reset_launches()
    dev = torch.device("cuda", 0)
    sharded, st_m = render_scene_sharded(scene, cam, cfg, (dev,) * 4)
    np.testing.assert_array_equal(single, sharded)
    assert st_s.segments == st_m.segments
    assert kernels.LAUNCHES["path_trace_gen"] > 0 and kernels.LAUNCHES["path_trace"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_kind", ["4 tiles", "make_mesh"])
def test_sharded_graph_frame_on_cuda(tmp_path, mesh_kind):
    """The sharded frame as one CUDA graph a card, over (cuda:0,) * 4 and
    make_mesh(): two graph frames launch what two eager frames
    (graph=False) launch; the third call, a replay, equals render_scene
    and the eager sharded frame bit for bit with equal segments, and so
    does a second camera through the same graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import types

    import numpy as np

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.parallel import sharding
    from zig_raytracing_contest_tpu_torch.render import pipeline

    scene, cam, cfg = _graph_scenes(tmp_path)
    mesh = (torch.device("cuda", 0),) * 4 if mesh_kind == "4 tiles" else sharding.make_mesh()
    cam2 = types.SimpleNamespace(width=cam.width, height=cam.height,
                                 origin=np.asarray(cam.origin) + np.float32([0.4, -0.2, 0.3]),
                                 lower_left_corner=cam.lower_left_corner, right=cam.right,
                                 up=cam.up)
    counts = {}
    for graph in (False, True):
        kernels.reset_launches()
        for _ in range(2):
            eager = sharding.render_scene_sharded(scene, cam, cfg, mesh, graph=graph)
        counts[graph] = dict(kernels.LAUNCHES)
    assert counts[True] == counts[False] and counts[True]["path_trace_gen"] > 0
    plans = sharding.device_plans(scene, cam, cfg, mesh)
    graphs = [pipeline.frame_graph(sharding.replica(scene, d), p) for d, p in plans.items()]
    assert all(g.replay is not None and g.pool_bytes > 0 for g in graphs)
    for c in (cam, cam2):
        single, st_s = pipeline.render_scene(scene, c, cfg)
        img, st = sharding.render_scene_sharded(scene, c, cfg, mesh)
        np.testing.assert_array_equal(img, single)
        assert st.segments == st_s.segments
        if c is cam:
            np.testing.assert_array_equal(img, eager[0])
            assert st.segments == eager[1].segments
    assert not np.array_equal(single, eager[0])
    # make_mesh() on one card is render_scene's plan: one graph, its frames too
    shared = plans[mesh[0]] == pipeline.frame_plan(scene, cam, cfg)
    assert all(g.frames == (6 if shared else 4) for g in graphs)


@pytest.mark.cuda
def test_ray_sort_key_kernel_matches_twin_on_cuda(tmp_path):
    """ray_sort_key_kernel equals ray_sort_key_ref bit for bit: on the full
    bounce-1 wave of a whole-path frame (the mid resort's input), on a sorted
    per-bounce wave, and on every case of probes.sort_key.edge_lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.probes.sort_key import (
        EDGE_CASES,
        edge_lanes,
        ray_sort_key_differs,
    )
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        gen_rays_raster,
        ray_sort_key,
        ray_sort_key_ref,
    )

    path = tproc.bench_scene(tmp_path / "b.gltf", num_objects=60)
    cfg = Config(num_samples=3, max_bounce=4)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=160, height=96, device="cuda")
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(3, 160, 160, 96, tiles_x=5)
    R = 15 * 1024 * 3
    state = fused.path_trace_gen(scene, par, (0,) * 8, R, 2, gen)
    raster = gen_rays_raster(par, 0, 0, R, 3, 160)
    kernels.reset_launches()
    for st in (state, raster):
        assert torch.equal(ray_sort_key(scene, st), ray_sort_key_ref(scene, st))
    assert kernels.LAUNCHES["ray_sort_key"] == 2
    for case in EDGE_CASES:
        st, lo, hi = (torch.from_numpy(a).cuda() for a in edge_lanes(case))
        assert ray_sort_key_differs(st, lo, hi) == 0, case


def _graph_scenes(tmp_path):
    """The bench scene at 160×96 in the whole path and, with the thresholds
    lowered below its 1024 padded triangles, in the sorted per-bounce
    pipeline (the thresholds are read at call time: the caller sets them)."""
    path = tproc.bench_scene(tmp_path / "b.gltf", num_objects=60)
    cfg = Config(num_samples=3, max_bounce=4, wave_size=1 << 14)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=160, height=96, device="cuda")
    return scene, cam, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["whole path", "per-bounce, sorted"])
def test_graph_frame_matches_eager_on_cuda(tmp_path, monkeypatch, regime):
    """render_scene's CUDA graph frames (warm-up, capture, replays) equal
    the eager loop's (graph=False) bit for bit, image and segments, for two
    cameras through one cache entry; kernels.LAUNCHES after N graph frames
    equals its value after N eager frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import types

    import numpy as np

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import pipeline, wavefront

    if regime != "whole path":
        monkeypatch.setattr(mi, "REC_EMIT_MAX_TRIS", 512)
        monkeypatch.setattr(wavefront, "SORT_MIN_TRIS", 512)
    scene, cam, cfg = _graph_scenes(tmp_path)
    assert wavefront.regime(scene) == regime
    cam2 = types.SimpleNamespace(width=cam.width, height=cam.height,
                                 origin=np.asarray(cam.origin) + np.float32([0.4, -0.2, 0.3]),
                                 lower_left_corner=cam.lower_left_corner, right=cam.right,
                                 up=cam.up)
    counts = {}
    want = {}
    for graph in (False, True):
        kernels.reset_launches()
        for c in (cam, cam2, cam, cam2):
            img, st = pipeline.render_scene(scene, c, cfg, graph=graph)
            if not graph:
                want[id(c)] = (img, st.segments)
            else:
                np.testing.assert_array_equal(img, want[id(c)][0])
                assert st.segments == want[id(c)][1]
        counts[graph] = dict(kernels.LAUNCHES)
    assert counts[True] == counts[False]
    assert counts[True]["ray_sort_key"] > 0
    assert not np.array_equal(want[id(cam)][0], want[id(cam2)][0])
    entry = pipeline.frame_graph(scene, pipeline.frame_plan(scene, cam, cfg))
    assert entry.replay is not None and entry.frames == 4 and entry.pool_bytes > 0


@pytest.mark.cuda
@pytest.mark.parametrize("resolution", [(128, 128, 128), (37, 5, 64)], ids=["128", "odd"])
def test_grid_walk_kernel_matches_twin_on_cuda(tmp_path, resolution):
    """grid_walk_kernel (trace_wave on the card) against trace_wave_ref on
    the --large terrain's 128³ grid and on a 37×5×64 grid of it (rows no
    multiple of 32 cells): the full 1,843,200-ray bounce-0 wave and
    its bounce-1 and bounce-2 waves with the previous hit excluded, then
    65,536 edge rays (probes.grid_walk.edge_rays) with and without an
    exclusion: t, u, v bits, the reference and the iteration count equal;
    one launch a walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.probes.grid_walk import edge_rays, walk_differs
    from zig_raytracing_contest_tpu_torch.render.wavefront import shade_and_scatter

    R = 1280 * 720 * 2
    scene, o, d, streams = _large_xla_waves(tmp_path, "grid", R, "cuda",
                                            grid_resolution=resolution)
    live, prev = torch.ones(R, dtype=torch.bool, device="cuda"), None
    for bounce in range(3):
        kernels.reset_launches()
        off, k_it, t_it, res = walk_differs(scene, o, d, live, prev)
        assert kernels.LAUNCHES["grid_walk"] == 1
        assert off == 0 and k_it == t_it > 0, (bounce, off, k_it, t_it)
        assert int(torch.isfinite(res.t).sum()) > (R // 4 if bounce < 2 else R // 8)
        tri = scene.grid.dup_to_tri[res.dup_idx]
        o, d, *_, missed, _ = shade_and_scatter(scene, o, d, res.t, res.u, res.v, tri,
                                                streams, bounce)
        o = o.contiguous()
        live, prev = live & ~missed, tri
    eo, ed, ea = (x.cuda() for x in edge_rays(scene.grid.params, 1 << 16, seed=7))
    ex = torch.randint(0, scene.grid.num_refs, (1 << 16,), device="cuda")
    for exclude in (None, scene.grid.dup_to_tri[ex]):
        off, k_it, t_it, _ = walk_differs(scene, eo, ed, ea, exclude)
        assert off == 0 and k_it == t_it > 0


def _xla_frame_scene(tmp_path, kind):
    """A 320×180 frame of the XLA shading path: the --large terrain on its
    128³ grid ("grid"), the --large terrain with every extension ("ext"),
    the Cornell box with NEE and Russian roulette ("cornell"), or a 160×90
    frame of the 500k terrain's streaming bake with NEE and Russian roulette
    ("stream": trace_stream_kernel with records off)."""
    if kind == "cornell":
        path = tproc.cornell_like_box(tmp_path / "box.gltf")
        cfg = Config(num_samples=4, max_bounce=4, seed=2, nee=True, russian_roulette=True)
        cam_kw = {}
    elif kind == "stream":
        from zig_raytracing_contest_tpu_torch.render import wavefront

        path = tproc.large_scene(tmp_path / "l500.gltf", side=500)
        cfg = Config(num_samples=2, max_bounce=3, seed=2, nee=True, russian_roulette=True)
        scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=160,
                                      height=90, device="cuda")
        assert wavefront.regime(scene, cfg.ext_flags) == "XLA shading, group heap"
        return scene, cam, cfg
    else:
        path = tproc.large_scene(tmp_path / "l.gltf")
        ext = dict(nee=True, russian_roulette=True, pbr=True) if kind == "ext" else {}
        cfg = Config(num_samples=2, max_bounce=3, backend="grid" if kind == "grid" else "auto",
                     **ext)
        cam_kw = dict(camera_name="Camera 1")
    scene, cam, _ = prepare_scene(str(path), cfg, width=320, height=180, device="cuda",
                                  **cam_kw)
    return scene, cam, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "ext", "cornell", "stream"])
def test_xla_graph_frame_matches_eager_on_cuda(tmp_path, kind):
    """The XLA shading path's frames as one CUDA graph (warm-up, capture,
    replays) against the eager loop (graph=False), for two cameras through
    one cache entry: every pixel and the segment count equal, and
    kernels.LAUNCHES after the graph frames as after the eager ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import types

    import numpy as np

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import pipeline

    scene, cam, cfg = _xla_frame_scene(tmp_path, kind)
    assert pipeline.graph_route(scene, cfg.ext_flags)
    cam2 = types.SimpleNamespace(width=cam.width, height=cam.height,
                                 origin=np.asarray(cam.origin) + np.float32([0.3, 0.1, 0.2]),
                                 lower_left_corner=cam.lower_left_corner, right=cam.right,
                                 up=cam.up)
    counts, want = {}, {}
    for graph in (False, True):
        kernels.reset_launches()
        for c in (cam, cam2, cam, cam2):
            img, st = pipeline.render_scene(scene, c, cfg, graph=graph)
            if not graph:
                want[id(c)] = (img, st.segments)
            else:
                np.testing.assert_array_equal(img, want[id(c)][0])
                assert st.segments == want[id(c)][1]
        counts[graph] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert counts[True] == counts[False]
    assert set(counts[True]) == {"grid": {"grid_walk"},
                                 "stream": {"trace_stream"}}.get(kind, {"trace_emit"})
    assert not np.array_equal(want[id(cam)][0], want[id(cam2)][0])
    entry = pipeline.frame_graph(scene, pipeline.frame_plan(scene, cam, cfg))
    assert entry.replay is not None and entry.frames == 4


@pytest.mark.cuda
def test_extension_frames_take_their_own_graph_on_cuda(tmp_path):
    """One grid scene at one size rendered with and without NEE: two frame
    keys, two captured graphs, each frame equal to its own eager frame, and
    the two frames differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import numpy as np

    from zig_raytracing_contest_tpu_torch.render import pipeline

    path = tproc.cornell_like_box(tmp_path / "box.gltf")
    base = dict(grid_resolution=(16, 16, 16), num_samples=2, max_bounce=3, backend="grid")
    scene, cam, _ = prepare_scene(str(path), Config(**base), width=160, height=90,
                                  device="cuda")
    imgs = []
    for cfg in (Config(**base, nee=True), Config(**base)):
        want, want_st = pipeline.render_scene(scene, cam, cfg, graph=False)
        for _ in range(3):
            img, st = pipeline.render_scene(scene, cam, cfg)
            np.testing.assert_array_equal(img, want)
            assert st.segments == want_st.segments
        imgs.append(want)
        assert pipeline.frame_graph(scene, pipeline.frame_plan(scene, cam, cfg)).replay
    assert not np.array_equal(imgs[0], imgs[1])
    graphs = [v for v in scene.frame_cache().values() if isinstance(v, pipeline.FrameGraph)]
    assert len(graphs) == 2


def _shaded_wave_scene(tmp_path, case):
    """A grid scene and the camera scalars of one wave of it, for the
    shaded walk against ``render_wave_xla``: (scene, par, width, spp, seed).
    "large": the --large terrain's 128³ grid at 1280×720, 2 spp; "alpha":
    the alpha asset (OPAQUE, MASK and BLEND quads: pass-through lanes) on a
    16³ grid at 128×96, 4 spp; "miss": the --large terrain with a camera
    above its box looking up, so that every primary ray misses."""
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import build_gen_par

    if case == "alpha":
        path = Path(__file__).parent / "assets" / "alpha_modes.gltf"
        cfg = Config(grid_resolution=(16, 16, 16), num_samples=4, backend="grid")
        scene, cam, _ = prepare_scene(str(path), cfg, width=128, height=96, device="cuda")
        width, spp = 128, 4
    else:
        path = tproc.large_scene(tmp_path / "l.gltf")
        cfg = Config(num_samples=2, backend="grid")
        scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=1280,
                                      height=720, device="cuda")
        width, spp = 1280, 2
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    if case == "miss":
        top = scene.grid.params.bbox_max.to("cuda")
        par[fused.PAR_ORIGIN: fused.PAR_ORIGIN + 3] = top + 1.0
        par[fused.PAR_LLC: fused.PAR_LLC + 3] = torch.tensor([-0.5, 1.0, -0.5])
        par[fused.PAR_RIGHT: fused.PAR_RIGHT + 3] = torch.tensor([1.0 / width, 0.0, 0.0])
        par[fused.PAR_UP: fused.PAR_UP + 3] = torch.tensor([0.0, 0.0, 1.0 / 720])
    return scene, par, width, spp, 5 if case == "alpha" else 2300000121


@pytest.mark.cuda
@pytest.mark.parametrize("case, bounces, rays, gen", [
    ("large", 3, 1280 * 720 * 2, {}),
    ("large", 1, 1 << 16, {}),
    ("large", 2, (1 << 16) + 17, {}),
    ("alpha", 3, 128 * 96 * 4 - 5, {}),
    ("miss", 2, 4099, {}),
    ("large", 2, (1 << 16) + 17, dict(spp=1, slot_base=1280 * 300 + 611)),
    ("large", 2, 3 * 40000 + 2, dict(spp=3, slot_base=987654, width=1277)),
    ("large", 1, 1 << 16, dict(spp=(1 << 20) + 3, slot_base=4099)),
    ("alpha", 3, 128 * 96 * 3 - 5, dict(spp=3, slot_base=4099, width=123)),
], ids=["large_3b_full", "large_1b", "large_2b_ragged", "alpha_3b_ragged", "miss_2b",
        "large_2b_spp1_slot", "large_2b_spp3_slot_width", "large_1b_wrap32",
        "alpha_3b_spp3_slot_width"])
def test_shaded_walk_equals_xla_wave_on_cuda(tmp_path, case, bounces, rays, gen):
    """The shaded walk's wave (``render_wave_grid``: B + 1 launches of
    grid_walk_kernel<true>, the first making the primary rays) against
    ``render_wave_xla`` on the card (the walk alone, then the PyTorch
    shade) on the same wave: radiance and segments bit for bit, and the
    rays alive and walk iterations they add to the work counters equal; the
    alpha asset's wave has pass-through lanes, the "miss" wave only misses.
    ``gen`` moves the wave off its frame's first: another ``spp``, a slot
    base other than 0, a width that does not divide the wave (the pixel
    walk wraps rows), one pixel's 2^20 + 3 samples (global ray ids past
    2^32, which wrap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf

    scene, par, width, spp, seed = _shaded_wave_scene(tmp_path, case)
    width, spp = gen.get("width", width), gen.get("spp", spp)
    slot_base = gen.get("slot_base", 0)
    assert wf.shaded_walk(scene) and not wf.shaded_walk(scene, plain=True)
    counts = {k: torch.zeros(len(wf.WORK_COUNTERS), dtype=torch.int64, device="cuda")
              for k in ("walk", "xla")}
    kernels.reset_launches()
    got = wf.render_wave_grid(scene, par, width, spp, bounces, slot_base, rays, seed,
                              counts["walk"])
    assert kernels.launches_since({k: 0 for k in kernels.LAUNCHES}) == {"grid_walk": bounces + 1}
    want = wf.render_wave_xla(scene, par, width, spp, bounces, slot_base, rays, seed,
                              counts=counts["xla"])
    torch.cuda.synchronize()
    assert got.shape == want.shape == (4, rays)
    differ = (got.view(torch.int32) != want.view(torch.int32)).any(dim=0)
    assert int(differ.sum()) == 0, (case, int(differ.sum()), differ.nonzero()[:4, 0].tolist())
    assert torch.equal(counts["walk"], counts["xla"]), (counts["walk"], counts["xla"])
    segments = int(want[3].sum())
    assert int(counts["walk"][0]) == segments > 0
    if case == "miss":
        assert segments == rays and int(counts["walk"][3]) == 0
    else:
        assert segments > rays or bounces == 1
        assert int(counts["walk"][3]) > 0
    if case == "alpha" and not gen:
        o, d, streams = wf.xla_primary_rays(par, width, spp, 0, rays, seed)
        hit = wf.trace_wave(scene, o.contiguous(), d, torch.ones(rays, dtype=torch.bool,
                                                                   device="cuda"))
        tri = scene.grid.dup_to_tri[hit.dup_idx]
        *_, through, missed, _ = wf.shade_and_scatter(scene, o, d, hit.t, hit.u, hit.v, tri,
                                                      streams, 0)
        assert int((through & ~missed).sum()) > 0


@pytest.mark.cuda
def test_grid_frame_launches_only_the_shaded_walk_on_cuda(tmp_path):
    """A grid frame of the --large terrain at 320×180 (2 spp, 3 bounces, waves
    of 2^15 rays: four waves, the last one short) on the card, eager and as
    its CUDA graph: grid_walk_kernel alone, B + 1 = 4 launches a wave, and
    the graph's frames equal the eager one bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import numpy as np

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import pipeline

    path = tproc.large_scene(tmp_path / "l.gltf")
    cfg = Config(num_samples=2, max_bounce=3, backend="grid", wave_size=1 << 15)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=320,
                                  height=180, device="cuda")
    plan = pipeline.frame_plan(scene, cam, cfg)
    assert plan.waves_run == 4
    kernels.reset_launches()
    want, st = pipeline.render_scene(scene, cam, cfg, graph=False)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"grid_walk": 4 * 4}
    for _ in range(3):
        img, st_g = pipeline.render_scene(scene, cam, cfg)
        np.testing.assert_array_equal(img, want)
        assert st_g.segments == st.segments
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"grid_walk": 4 * 4 * 4}


@pytest.mark.cuda
def test_duck_wave_counters_equal_the_twins_on_cuda(tmp_path):
    """The benchmark's duck_room scene (pathbench/configs/duck_room.json)
    at the duck-1080p cell's frame, on one full wave of 522,240 rays from
    32x32 pixel tile 920 (it crosses the duck): bounce 0
    (path_trace_gen_kernel), bounce 1 after the sort and bounces 2-3 after
    the resort (path_trace_kernel, from the kernel's state) add to the
    wave's ten WORK_COUNTERS what the twins add on the same input: the
    eight older (the rays alive, tiles and boxes; zeros elsewhere) and the
    flat loop's lane_tiles and warp_sweeps, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import json

    from zig_raytracing_contest_tpu_torch.ops.mxu_intersect import LANE_LOOP_MIN
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf
    from zig_raytracing_contest_tpu_torch.render.pipeline import slot_geometry
    from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb

    root = Path(__file__).resolve().parents[1]
    duck = json.loads((root / "pathbench" / "configs" / "duck_room.json").read_text())
    path = write_duck_glb(tmp_path / "duck.glb", **duck["writer_args"])
    cfg = Config(num_samples=3, max_bounce=4, wave_size=1 << 19)
    scene, cam, _ = prepare_scene(str(path), cfg, duck["camera"], None, 1080, device="cuda")
    assert wf.regime(scene) == "whole path" and cam.width == 1920
    par = wf.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    _, tiles_x = slot_geometry(1920, 1080, True)
    gen = fused.GenParams(spp=3, width=1920, img_w=1920, img_h=1080, tiles_x=tiles_x)
    R, slot_base = 522240, 1024 * 920
    meta = (slot_base, slot_base % 1920, slot_base // 1920, 2**31 + 2711, slot_base // 1024,
            0, 0, 0)
    counts = {k: torch.zeros(len(wf.WORK_COUNTERS), dtype=torch.int64, device="cuda")
              for k in ("kernel", "twin")}

    def work(side):
        return {"counts": counts[side][wf.NEAREST], "sweeps": counts[side][wf.FLAT]}

    st, idx = fused.path_trace_gen(scene, par, meta, R, 1, gen, emit_key=True, emit_idx=True,
                                   **work("kernel"))
    fused.path_trace_gen_ref(scene, par, meta, R, 1, gen, emit_key=True, emit_idx=True,
                             **work("twin"))
    _, st, (idx,) = wf.sort_state_payload(st[15].contiguous().view(torch.int32), st, (idx,))
    st1, idx1 = fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx, emit_idx=True,
                                       **work("kernel"))
    fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx, emit_idx=True,
                               **work("twin"))
    _, st2, (idx2,) = wf.sort_state_payload(wf.ray_sort_key(scene, st1), st1, (idx1,))
    fused.path_trace_fused(scene, st2, 2, bounce0=2, prev=idx2, **work("kernel"))
    fused.path_trace_fused_ref(scene, st2, 2, bounce0=2, prev=idx2, **work("twin"))
    torch.cuda.synchronize()
    got = dict(zip(wf.WORK_COUNTERS, counts["kernel"].tolist()))
    want = dict(zip(wf.WORK_COUNTERS, counts["twin"].tolist()))
    assert got == want
    nt = scene.tile_bbox.shape[1]
    assert got["alive"] > R and got["boxes"] == got["alive"] * nt
    assert got["lane_tiles"] > 0 and got["warp_sweeps"] > 0
    assert LANE_LOOP_MIN * got["lane_tiles"] + got["warp_sweeps"] <= got["tiles"]
    assert got["tiles"] <= 32 * got["lane_tiles"] + got["warp_sweeps"]
