"""The benchmark's data: configurations, traffic, cells and metric readers,
each found by its name in a file of its own.

* ``configs/<config>.json``: a scene as users render it: its source, the
  writer (``scenes/<writer>.py``) and its arguments, the file it writes
  and the camera, with what was ``assumed`` and ``reduced``;
* ``traffic/<traffic>.json``: the frame asked of the system: its size,
  samples per pixel, bounces, wave, backend, grid and extensions;
* ``workloads/<cell>.json``: one cell: its configuration and traffic, the
  CUDA kernels its frame must launch (no more and no fewer), the trace
  kernels its roofline reads, the limits of the comparison that decides
  ``correct``, and the ``reference`` it is held to (``plain`` where the
  key is absent);
* ``reference/<reference>.py``: a reference renderer (``EXTENSIONS``, the
  traffic extensions it computes, and ``prepare(workload, path, device)``
  → an object with ``render(seed, dtype=None)``, ``grid_size()`` and
  ``triangles``; ``reference/__init__.py`` says more).  A cell whose
  traffic names an extension its reference does not declare is refused
  when it is loaded;
* ``metrics/<metric>.py``: the reader of one per-layer metric (``UNIT``
  and ``read(reading)``, which returns None where it finds nothing).

Adding a cell, a configuration (with a scene writer of its own), a
traffic mix, a reference or a metric adds files; no file here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent  # the benchmark's own directory
CHECKOUT = ROOT.parent  # where BENCHMARK.json and the program live
PLAIN = "plain"  # the reference of a cell that names none


@dataclass(frozen=True)
class Traffic:
    name: str
    width: int | None
    height: int
    spp: int
    bounces: int
    wave: int
    backend: str
    grid_resolution: tuple
    extensions: tuple

    @property
    def triangle_test(self) -> str:
        """The form of the triangle test the backend computes: Möller–Trumbore
        on the grid, the baked transform otherwise."""
        return "mt" if self.backend == "grid" else "transform"


@dataclass(frozen=True)
class Workload:
    name: str
    config: dict
    traffic: Traffic
    kernels: tuple
    trace_kernels: tuple
    limits: dict
    reference: str = PLAIN  # reference/<reference>.py


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def load_config(name: str, root: Path = ROOT) -> dict:
    cfg = _json(root / "configs" / f"{name}.json")
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def load_traffic(name: str, root: Path = ROOT) -> Traffic:
    raw = _json(root / "traffic" / f"{name}.json")
    return Traffic(name, raw["width"], int(raw["height"]), int(raw["spp"]),
                   int(raw["bounces"]), int(raw["wave"]), raw["backend"],
                   tuple(raw["grid_resolution"]), tuple(raw.get("extensions", ())))


def load_workload(name: str, root: Path = ROOT) -> Workload:
    """Cell ``name``; refused where its traffic names an extension that its
    reference does not compute."""
    raw = _json(root / "workloads" / f"{name}.json")
    wl = Workload(name, load_config(raw["config"], root), load_traffic(raw["traffic"], root),
                  tuple(raw["kernels"]), tuple(raw["trace_kernels"]), dict(raw["limits"]),
                  raw.get("reference", PLAIN))
    declared = tuple(load_reference(wl.reference, root).EXTENSIONS)
    missing = [e for e in wl.traffic.extensions if e not in declared]
    if missing:
        raise ValueError(f"cell {name}: traffic {wl.traffic.name} names extension(s) "
                         f"{', '.join(missing)}, which reference {wl.reference} does not "
                         f"compute (it declares {declared})")
    return wl


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # as an import would: dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


@functools.cache
def _reference_module(path: Path):
    return _module(f"{__package__}.reference.{path.stem}", path)


def load_reference(name: str, root: Path = ROOT):
    """The module of reference ``name`` (``EXTENSIONS``, ``prepare``),
    loaded once a process as a module of ``pathbench.reference`` so that
    it imports the reference's shared parts relatively."""
    path = root / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference {name}: {path}")
    module = _reference_module(path)
    if not hasattr(module, "EXTENSIONS") or not callable(getattr(module, "prepare", None)):
        raise TypeError(f"reference/{name}.py declares no EXTENSIONS and prepare()")
    return module


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name}: {path}")
    return _module(f"pathbench_metric_{name.replace('.', '_')}", path)


def benchmark(checkout: Path = CHECKOUT) -> dict:
    return _json(checkout / "BENCHMARK.json")


def per_layer_metrics(cell: str, bench: dict) -> list:
    """The per-layer metric entries of BENCHMARK.json that ``cell`` reports."""
    return [m for m in bench.get("per_layer", [])
            if "workloads" not in m or cell in m["workloads"]]
