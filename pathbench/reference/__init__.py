"""The references of the benchmark, in NumPy and PyTorch: the frame a
cell's program must produce, worked out again from the scene file, the
camera and the seed.  They import nothing of the program.

A reference is a module ``reference/<name>.py`` that a cell names in its
workload file (``"reference": "<name>"``; ``plain`` where it names none).
Like a scene writer or a metric reader, a reference is added as a file of
its own, and no file here changes.  It declares

* ``EXTENSIONS``: the traffic extensions (``nee``, ``russian_roulette``,
  ``pbr``) its estimator computes; a cell whose traffic names one it does
  not declare is refused when the cell is loaded, before any set-up;
* ``prepare(workload, path, device)``: given the cell (its configuration
  and traffic, extensions included), the scene file's path and the
  device, an object with ``render(seed, dtype=None)`` → (the frame as
  (height, width, 3) uint8 on the host, traced segments), in float32 or
  in ``dtype`` (the control's lower precision), ``grid_size()`` →
  (cells, triangle references) at the traffic's grid, and ``triangles``.

A reference is loaded as a module of this package, so it may import the
shared parts relatively: ``scene`` (its own glTF reading, which a
reference may extend from the file's path) and ``render`` (upstream's
plain path tracer).  ``plain`` is that tracer over that reading.
"""
