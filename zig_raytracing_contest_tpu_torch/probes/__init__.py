"""Probe kernels: single device functions of the whole path, held on their
own against their plain PyTorch versions.

* ``check_fetch``: ``texel_fetch_kernel``, the texel loader of the shade
  (the counterpart of the JAX package's paged-fetch check,
  scripts/check_paged_tpu.py);
* ``sort_key``: ``sort_key_kernel``, the beam-sort key the whole-path
  kernels emit (the counterpart of the JAX package's ``_emit_sort_key``
  harness in tests/test_fused.py).

Each module runs on the card by default: ``python -m
zig_raytracing_contest_tpu_torch.probes.check_fetch`` (``--device cpu``
runs the plain version against itself).
"""
