"""Probe kernels: single device functions of the whole path and the trace
micro-benchmarks, held on their own against their plain PyTorch versions.

* ``check_fetch``: ``texel_fetch_kernel``, the texel loader of the shade
  (the counterpart of the JAX package's paged-fetch check,
  scripts/check_paged_tpu.py);
* ``sort_key``: ``sort_key_kernel``, the beam-sort key the whole-path
  kernels emit (the counterpart of the JAX package's ``_emit_sort_key``
  harness in tests/test_fused.py);
* ``micro_trace``: ``micro_trace_kernel``, the nearest hit over a 4-tile
  bank in the tile loop's variants (scripts/micro_trace.py);
* ``micro_bf16``: ``micro_bf16_kernel``, the sweep's operation mix with an
  f32 or bf16 transform, priced per sweep (scripts/micro_bf16.py);
* ``probe_gather``: ``probe_gather_kernel``, a 2-D gather pair from one
  (8, 128) page in shared memory or by shuffles (scripts/probe_gather.py);
* ``walk_check``: trace_emit_kernel's tile-heap walk against the flat loop
  lane by lane, with a NumPy replay of the walk for one ray;
* ``grid_walk``: grid_walk_kernel against its twin on a wave and on built
  edge rays, the bound of a wave's walk, and the shaded walk against
  ``render_wave_xla`` (helpers of chip_smoke.py and the tests; no entry
  point of its own);
* ``sharded_frame``: the official frame sharded beside ``render_scene``,
  timed in turns.

Each module with an entry point runs on the card by default: ``python -m
zig_raytracing_contest_tpu_torch.probes.check_fetch`` (``--device cpu``
runs the plain version against itself).
"""
