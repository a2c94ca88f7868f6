"""The plain reference: upstream's estimator (``render``'s docstring) over
the reference's own reading of the cell's scene file (``scene``).  It
computes no traffic extension.  A cell whose workload file names no
``reference`` is held to it."""

from __future__ import annotations

import numpy as np
import torch

from . import render as ref_render
from . import scene as ref_scene

EXTENSIONS = ()


class PlainReference:
    """The cell's scene, camera and grid as the reference reads them, on
    the device."""

    def __init__(self, workload, path, device):
        tr = workload.traffic
        self.traffic = tr
        self.scene, self.camera = ref_scene.read_scene(path, workload.config["camera"],
                                                       tr.width, tr.height)
        self.device_scene = ref_render.upload(self.scene, device, tr.triangle_test)
        self.triangles = self.scene.num_triangles

    def render(self, seed: int, dtype=None):
        """(image, segments) of the cell's frame at ``seed``, in float32 or
        in ``dtype``."""
        tr = self.traffic
        return ref_render.render(self.device_scene, self.camera, tr.spp, tr.bounces, seed,
                                 dtype or torch.float32)

    def grid_size(self) -> tuple:
        """(cells, triangle references) of the reference's binning at the
        traffic's grid resolution; (0, 0) off the grid backend."""
        tr = self.traffic
        if tr.backend != "grid":
            return 0, 0
        grid = ref_render.build_grid(self.device_scene.tri.new_tensor(self.scene.positions),
                                     tr.grid_resolution)
        return int(np.prod(tr.grid_resolution)), grid.num_refs


prepare = PlainReference
