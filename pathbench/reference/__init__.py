"""The plain reference renderer of the benchmark: its own glTF reading
(``scene``) and path tracer (``render``), in NumPy and PyTorch.  It
imports nothing of the program."""
