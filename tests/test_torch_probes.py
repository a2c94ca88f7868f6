"""The trace micro-benchmarks' plain versions against the JAX probes.

Each probe of the port (``probes/micro_trace.py``, ``probes/micro_bf16.py``,
``probes/probe_gather.py``) has a plain PyTorch version beside its CUDA
kernel.  Here the plain versions are held against the JAX package's probe
scripts (scripts/micro_trace.py, micro_bf16.py, probe_gather.py), each
script's own kernel function run through ``pl.pallas_call(...,
interpret=True)`` on the CPU, on the same inputs.  The last test holds the
one lane where the per-bounce trace's tile-heap walk and the flat loop
chose different winners against the JAX package's own walk.

Tolerances: XLA:CPU contracts the transform's multiply-adds into FMAs and
PyTorch does not (tests/test_torch_trace.py), so t is held to rtol 1e-6 plus
atol 1e-6 (one f32 ULP at the bank's coordinate scale), u and v to atol
1e-5 (widened on lanes with large transform terms, see
``test_micro_trace_matches_jax``), and the winner exactly wherever the
nearest and second-nearest hit are more than 1e-6·t apart.  bf16: see
``test_micro_bf16_matches_jax``.
Run on the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_probes.py``.
"""

import importlib.util
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_trace import _two_nearest

from zig_raytracing_contest_tpu_torch.probes import micro_bf16, micro_trace, probe_gather

ROOT = Path(__file__).resolve().parent.parent
LANES, LANE_BLOCK = 2048, 512


def _script(name: str):
    """scripts/<name>.py, imported as it is."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    """The script's bank and the first LANES rays of its state, from each
    package: (script module, JAX bank, JAX state, port bank, port state)."""
    script = _script("micro_trace")
    jtris = script.make_bank(0)
    jstate = script.make_state(1)[:, :LANES]
    tris = micro_trace.make_bank(0)
    state = micro_trace.make_state(1)[:, :LANES]
    return script, jtris, jstate, tris, state


def test_micro_trace_inputs_match_the_script(trace_inputs):
    """The port's bank and rays equal the script's, array for array."""
    _, jtris, jstate, tris, state = trace_inputs
    np.testing.assert_array_equal(np.asarray(jstate), state)
    np.testing.assert_array_equal(np.asarray(jtris.tri_data), tris.tri_data)
    np.testing.assert_array_equal(np.asarray(jtris.tile_bbox), tris.tile_bbox)
    assert tris.tri_data.shape == (16, 2048) and tris.tile_bbox.shape == (6, 4)


@pytest.mark.parametrize("extract_uv", [True, False], ids=["uv", "no_uv"])
@pytest.mark.parametrize("jax_cull,cull", [(False, "none"), (True, "lane"), (True, "warp")],
                         ids=["none", "lane", "warp"])
def test_micro_trace_matches_jax(trace_inputs, extract_uv, jax_cull, cull):
    """The script's "vpu" kernel at lane block 512 against the plain
    version: rows 3-7 exactly (streams, alive, zeros), the hit mask
    exactly, t, u, v to the tolerances above (u, v both zero without
    extraction), the winner exactly where t does not tie.  The JAX cull
    sweeps a 512-lane block when any lane passes; the port's "lane" and
    "warp" culls sweep fewer lanes; a cull never changes the nearest hit."""
    script, jtris, jstate, tris, state = trace_inputs
    call = pl.pallas_call(
        script.make_kernel("vpu", extract_uv, jax_cull),
        grid=(LANES // LANE_BLOCK,),
        in_specs=[pl.BlockSpec((16, LANE_BLOCK), lambda i: (0, i)),
                  pl.BlockSpec(jtris.tri_data.shape, lambda i: (0, 0)),
                  pl.BlockSpec(jtris.tile_bbox.shape, lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((8, LANE_BLOCK), lambda i: (0, i)),
                   pl.BlockSpec((1, LANE_BLOCK), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((8, LANES), jnp.float32),
                   jax.ShapeDtypeStruct((1, LANES), jnp.int32)],
        interpret=True)
    jaux, jidx = (np.asarray(a) for a in call(jstate, jtris.tri_data, jtris.tile_bbox))
    aux, idx = micro_trace.micro_trace(torch.from_numpy(tris.tri_data),
                                       torch.from_numpy(tris.tile_bbox), tris.tile,
                                       torch.from_numpy(state), extract_uv, cull)
    aux, idx = aux.numpy(), idx.numpy()
    np.testing.assert_array_equal(aux[3:8].view(np.uint32), jaux[3:8].view(np.uint32))
    hit = np.isfinite(jaux[2])
    np.testing.assert_array_equal(np.isfinite(aux[2]), hit)
    assert hit.sum() > 50, "the rays must hit the bank (73 of the 2048 do)"
    np.testing.assert_allclose(aux[2][hit], jaux[2][hit], rtol=1e-6, atol=1e-6)
    if extract_uv:
        # u, v to atol 1e-5, widened where the transform's terms are large
        # (origins up to 8 from a 0.5-edge triangle: sums of ~240 that
        # cancel into u) by 4 f32 ULPs of those terms, the rule
        # tests/test_torch_per_bounce.py applies to t
        m = tris.tri_data[:, jidx[0][hit]]
        o, d, t = state[0:3, hit], state[3:6, hit], jaux[2][hit]
        for k, rows in ((0, (0, 1, 2, 9)), (1, (3, 4, 5, 10))):
            terms = (sum(np.abs(m[rows[a]] * o[a]) for a in range(3)) + np.abs(m[rows[3]])
                     + t * sum(np.abs(m[rows[a]] * d[a]) for a in range(3)))
            err = np.abs(aux[k][hit] - jaux[k][hit])
            assert (err <= 1e-5 + 4 * np.finfo(np.float32).eps * terms).all()
            assert (err <= 1e-5).mean() > 0.9
    else:
        assert not aux[0:2].any() and not jaux[0:2].any()
    orig, dirs = state[0:3].T, state[3:6].T
    t1, t2 = _two_nearest(SimpleNamespace(mxu=tris), orig, dirs)
    with np.errstate(invalid="ignore"):
        clear = hit & ~(np.abs(t2 - t1) <= 1e-6 * t1)
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(idx[0][clear], jidx[0][clear])
    np.testing.assert_array_equal(idx[0][~hit], 0)


def _jax_sweep(script, bank, state, iters, dtype):
    """The script's _sweep_kernel through pallas_call in interpret mode."""
    call = pl.pallas_call(partial(script._sweep_kernel, iters=iters, dtype=dtype),
                          out_shape=jax.ShapeDtypeStruct((1, script.LB), jnp.float32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(bank), jnp.asarray(state, dtype)))


@pytest.mark.parametrize("iters", [64, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_micro_bf16_matches_jax(dtype, iters):
    """The script's sweep kernel against the plain version on the script's
    inputs (bank (13, 8192), 512 rays), compared in f32.  f32: the hit mask
    exactly, best t to rtol 1e-6 + atol 1e-6.  bf16: the port rounds each
    product and sum of the transform to bf16 (as the kernel does), XLA:CPU
    may keep them in f32 (excess precision) and contracts them, and the
    terms (up to ~50) cancel into t, where a bf16 ULP of them is ~0.25; so
    over 90% of the lanes where both hit hold t to a relative 2^-6 (97% at
    64 iterations), and at most 2% of the lanes flip between a hit and
    none (1.2%).  For scale: bf16 against f32, either package, differs by
    a median 0.7% and flips 6% of the lanes.  64 and 192 iterations give
    the same output (sweep i reads tile i mod 64, a min is idempotent)."""
    script = _script("micro_bf16")
    assert (script.K, script.NT, script.LB) == (micro_bf16.K, micro_bf16.NT, micro_bf16.LB)
    bank, st = micro_bf16.make_inputs(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _jax_sweep(script, bank, st, iters, jdt)[0]
    got = micro_bf16.micro_bf16(torch.from_numpy(bank), torch.from_numpy(st).to(tdt),
                                iters).numpy()[0]
    again = micro_bf16.micro_bf16(torch.from_numpy(bank), torch.from_numpy(st).to(tdt),
                                  64 if iters != 64 else 192).numpy()[0]
    np.testing.assert_array_equal(got.view(np.uint32), again.view(np.uint32))
    hit, jhit = np.isfinite(got), np.isfinite(want)
    assert jhit.sum() > micro_bf16.LB // 4
    if dtype == "float32":
        np.testing.assert_array_equal(hit, jhit)
        np.testing.assert_allclose(got[hit], want[hit], rtol=1e-6, atol=1e-6)
        return
    both = hit & jhit
    assert (hit != jhit).mean() <= 0.02
    assert (np.abs(got[both] - want[both]) <= 2.0 ** -6 * want[both]).mean() > 0.9


@pytest.mark.parametrize("reps", [1, 64])
def test_probe_gather_matches_jax(reps):
    """The script's gather kernel in interpret mode, the plain version and
    the script's NumPy expectation agree exactly; the probe's CPU entry
    point reports no mismatch."""
    script = _script("probe_gather")
    pg, col, row = probe_gather.make_inputs(0)
    call = pl.pallas_call(lambda a, b, c, o: script.kernel(a, b, c, o, reps),
                          out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
                          interpret=True)
    want = np.asarray(call(jnp.asarray(pg), jnp.asarray(col), jnp.asarray(row)))
    got = probe_gather.probe_gather(*(torch.from_numpy(a) for a in (pg, col, row)), reps)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want.astype(np.int64),
                                  probe_gather.expected(pg, col, row, reps))
    assert all(bad == 0 for _, _, bad in probe_gather.run_checks("cpu"))


@pytest.mark.parametrize("slots", [1, 3, 132, 264, 528])
@pytest.mark.parametrize("reps", [1, 2, 63, 64, 65, 512, 4096])
def test_rep_chunks_cover_each_rep_once(reps, slots):
    """The kernel's chunks of [0, reps) over ``slots``: at most one a slot,
    none empty, every rep in exactly one, in order; chunks · per covers
    reps, as the launcher requires."""
    chunks, per = probe_gather.rep_chunks(reps, slots)
    assert 1 <= chunks <= min(reps, slots) and chunks * per >= reps
    ranges = probe_gather.chunk_ranges(reps, chunks, per)
    assert all(stop > first for first, stop in ranges)
    assert [r for first, stop in ranges for r in range(first, stop)] == list(range(reps))


def test_rep_chunks_edges():
    """No reps: one empty chunk (the kernel stores zeros); reps 1 one chunk
    whatever the slots; a negative count or no slot raises."""
    assert probe_gather.rep_chunks(0, 132) == (1, 0)
    assert probe_gather.chunk_ranges(0, 1, 0) == [(0, 0)]
    assert probe_gather.rep_chunks(1, 528) == (1, 1)
    assert probe_gather.rep_chunks(512, 132) == (128, 4)
    for reps, slots in ((-1, 4), (4, 0)):
        with pytest.raises(ValueError):
            probe_gather.rep_chunks(reps, slots)


@pytest.mark.parametrize("reps", [1, 64, 512])
def test_probe_gather_chunked_matches_jax(reps):
    """The sum as the kernel takes it, probe_gather_ref of each chunk added
    in int32 (over one chunk and an H100's 132 and 528 slots), equals the
    script's gather kernel in interpret mode and the NumPy expectation
    exactly."""
    script = _script("probe_gather")
    pg, col, row = probe_gather.make_inputs(0)
    call = pl.pallas_call(lambda a, b, c, o: script.kernel(a, b, c, o, reps),
                          out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
                          interpret=True)
    want = np.asarray(call(jnp.asarray(pg), jnp.asarray(col), jnp.asarray(row)))
    np.testing.assert_array_equal(want.astype(np.int64),
                                  probe_gather.expected(pg, col, row, reps))
    t = [torch.from_numpy(a) for a in (pg, col, row)]
    for slots in (1, 132, 528):
        got = probe_gather.probe_gather_chunked_ref(*t, reps, slots)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# The lane of the side-90 terrain's bounce-0 wave (pixel tile 920, 1920x1080,
# 3 spp) where the tile-heap walk and the flat loop choose different
# winners: the ray's o, d bits, both winners and their common t.
TIE_LANE = 94331
TIE_RAY_BITS = (0x00000000, 0x40900000, 0x41180000, 0x3F01FC76, 0xBE9D6111, 0xBF4E072C)
TIE_T_BITS = 0x416C6867
TIE_FLAT_IDX, TIE_WALK_IDX = 11519, 11530


def test_walk_tie_lane_matches_jax(tmp_path):
    """The walk's one differing lane is a tie: the flat loop's winner (tile
    89) and the walk's (tile 90), the two triangles of one terrain quad, are
    both hit alone at the same t, on their shared edge.  The port's gen
    twin makes the ray's bits; its replay of the kernel's walk
    (``walk_check.walk_heap_ref``) keeps the walk's winner; the JAX
    package's ``trace_emit_aux`` in interpret mode, which walks its tile
    heap (127 tiles, past TREE_MIN_TILES = 16), finds the same t (to the
    tolerances above; it is bit for bit here) and the walk's winner."""
    from zig_raytracing_contest_tpu.config import Config as JConfig
    from zig_raytracing_contest_tpu.ops import mxu_intersect as jmi
    from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
    from zig_raytracing_contest_tpu_torch.probes import walk_check

    scene, cam = walk_check.load("terrain", walk_check.TERRAIN_SIDE, tmp_path, "cpu")
    assert scene.tile_bbox.shape[1] == 127
    state = walk_check.bounce0_state(scene, cam, TIE_LANE + 1)[0]
    ray = state[:, TIE_LANE:TIE_LANE + 1].contiguous()
    assert tuple(ray[0:6, 0].view(torch.int32).tolist()) == tuple(
        np.array(TIE_RAY_BITS, np.uint32).view(np.int32).tolist())
    t, i, _, _, _ = tmi.nearest_hit_ref(scene.tri_data, scene.tile_bbox, scene.tile,
                                        ray[0:3], ray[3:6], ray[12] > 0)
    assert int(i[0]) == TIE_FLAT_IDX and int(t.view(torch.int32)[0]) == TIE_T_BITS
    walk = walk_check.walk_heap_ref(scene.tri_data.numpy(), scene.tile_bbox.numpy(),
                                    scene.tree_bbox.numpy(), scene.tile,
                                    ray[0:3, 0].tolist(), ray[3:6, 0].tolist())
    assert walk["idx"] == TIE_WALK_IDX
    assert np.float32(walk["t"]).view(np.uint32) == TIE_T_BITS
    hit, t_alone, _, _ = tmi.triangle_hit_ref(
        scene.tri_data, ray[0:3].expand(3, 2), ray[3:6].expand(3, 2),
        torch.tensor([TIE_FLAT_IDX, TIE_WALK_IDX]))
    assert bool(hit.all()) and (t_alone.view(torch.int32) == TIE_T_BITS).all()
    assert abs(int(scene.perm[TIE_FLAT_IDX]) - int(scene.perm[TIE_WALK_IDX])) == 1

    js, _, _ = jax_prepare(str(tmp_path / f"terrain_{walk_check.TERRAIN_SIDE}.gltf"),
                           JConfig(grid_resolution=(8, 8, 8)), camera_name="Camera 1",
                           width=1920, height=1080)
    assert js.mxu.tile_bbox.shape[1] >= jmi.TREE_MIN_TILES
    lanes = np.zeros((16, 1024), np.float32)
    lanes[:, 0] = ray[:, 0].numpy()  # every other lane dead
    aux, idx = jmi.trace_emit_aux(js.mxu, jnp.asarray(lanes), interpret=True)[:2]
    t_jax, idx_jax = np.asarray(aux)[2, 0], int(np.asarray(idx)[0])
    np.testing.assert_allclose(t_jax, float(t[0]), rtol=1e-6, atol=1e-6)
    assert idx_jax == TIE_WALK_IDX
