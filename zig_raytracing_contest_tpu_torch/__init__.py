"""PyTorch/CUDA port of the zig_raytracing_contest_tpu glTF path tracer.

The JAX package ``zig_raytracing_contest_tpu`` is the reference; this
package mirrors its module names, imports ``torch`` and never ``jax``, and
runs its whole-path and per-bounce kernels as CUDA C++ on an NVIDIA Hopper
card (kernels/path_trace.cu), or as their plain PyTorch twins on the CPU
when the caller asks for the CPU.

Run: ``python -m zig_raytracing_contest_tpu_torch --in scene.gltf --out out.png``
(add ``--device cpu`` on a host without a card).
"""

__version__ = "0.1.0"
