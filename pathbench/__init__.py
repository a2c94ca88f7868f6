"""The benchmark of the PyTorch/CUDA port: one run of one cell
(``python -m pathbench.run``), driven by the data under ``configs/``,
``traffic/``, ``workloads/`` and ``metrics/``, with its own scene writers
(``scenes/``) and plain reference renderer (``reference/``)."""
