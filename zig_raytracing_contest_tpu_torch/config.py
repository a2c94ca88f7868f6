"""Run configuration: config.json + CLI flags, reference key-compatible.

A copy of ``zig_raytracing_contest_tpu/config.py``: the same keys, the same
defaults and the same validation, so one ``config.json`` drives both
packages.  Quality knobs come from ``config.json`` — exactly the reference's
keys ``grid_resolution`` (3-array), ``num_threads`` (nullable; host decode
pool size here), ``num_samples``, ``max_bounce`` (src/main.zig:56-71,
config.json:1-6) — and per-run I/O via CLI flags
``--in/--out/--camera/--width/--height`` (src/main.zig:33-39).  Extras
(wave_size, seed, progressive, backend, the extensions, debug_checks) are
optional keys the reference never had; unknown keys are rejected like Zig's
std.json default (src/main.zig:65) except the documented extras.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import NamedTuple

REFERENCE_KEYS = {"grid_resolution", "num_threads", "num_samples", "max_bounce"}
EXTRA_INT_KEYS = {"wave_size", "seed", "progressive_every"}
EXTRA_STR_KEYS = {"backend"}
EXTRA_BOOL_KEYS = {"nee", "russian_roulette", "pbr", "debug_checks"}
EXTRA_KEYS = EXTRA_INT_KEYS | EXTRA_STR_KEYS | EXTRA_BOOL_KEYS


class ExtFlags(NamedTuple):
    """The opt-in rendering extensions (NEE, Russian roulette, PBR)."""

    nee: bool = False
    russian_roulette: bool = False
    pbr: bool = False

    @property
    def any(self) -> bool:
        return self.nee or self.russian_roulette or self.pbr


@dataclass
class Config:
    grid_resolution: tuple[int, int, int] = (128, 128, 128)
    # In the reference ``num_threads`` sizes the render thread pool
    # (src/main.zig:90).  Here the render runs on the device, so the knob
    # keeps its host-side meaning: the load-time image-decode pool
    # (src/stage1.zig:98-107; scene/gltf.py).  ``null`` means autodetect.
    num_threads: int | None = None
    num_samples: int = 3
    max_bounce: int = 4
    # Extras:
    wave_size: int = 1 << 20  # rays in flight per wave
    seed: int = 0
    progressive_every: int = 0  # waves between intermediate PNG dumps (0=off)
    backend: str = "auto"  # intersection backend: auto | mxu | grid
    # Extensions — OFF by default (render/extensions.py; the XLA shading path).
    nee: bool = False
    russian_roulette: bool = False
    pbr: bool = False
    # Debug mode: a non-finite radiance check on the framebuffer before PNG
    # encode (a NaN would otherwise clamp silently at gamma encode).
    debug_checks: bool = False

    @property
    def host_threads(self) -> int:
        return self.num_threads or os.cpu_count() or 1

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        unknown = set(raw) - REFERENCE_KEYS - EXTRA_KEYS
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        missing = REFERENCE_KEYS - set(raw)
        if missing:
            raise ValueError(f"missing config keys: {sorted(missing)}")
        gr = raw["grid_resolution"]
        if not (isinstance(gr, list) and len(gr) == 3):
            raise ValueError("grid_resolution must be a 3-array")
        cfg = cls(
            grid_resolution=tuple(int(x) for x in gr),
            num_threads=raw["num_threads"],
            num_samples=int(raw["num_samples"]),
            max_bounce=int(raw["max_bounce"]),
        )
        for key in EXTRA_INT_KEYS & set(raw):
            setattr(cfg, key, int(raw[key]))
        for key in EXTRA_STR_KEYS & set(raw):
            setattr(cfg, key, str(raw[key]))
        for key in EXTRA_BOOL_KEYS & set(raw):
            setattr(cfg, key, bool(raw[key]))
        return cfg

    @property
    def ext_flags(self) -> ExtFlags:
        return ExtFlags(
            nee=self.nee, russian_roulette=self.russian_roulette, pbr=self.pbr
        )

