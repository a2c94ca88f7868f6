"""What a run hands the per-layer metric readers: the cell, the frames of
the window, the program's set-up phases, the traced window and the work
the reference worked out for one frame."""

from __future__ import annotations

from dataclasses import dataclass

from .devtrace import DeviceTrace, kernel_base
from .spec import Workload


@dataclass
class Reading:
    workload: Workload
    frames: int  # frames completed in the window
    phases: dict  # seconds of prepare_scene's phases (the program's timers)
    trace: DeviceTrace | None  # the traced window, or None
    rays: int  # primary rays of one frame: pixels x samples
    segments: int  # traced segments of one frame, by the reference
    triangles: int  # the scene's triangles, by the reference's reading
    grid_cells: int  # cells of the traffic's grid resolution
    grid_refs: int  # triangle references of that grid, by the reference's binning

    def device_ms_per_frame(self, names) -> float | None:
        """Device ms a frame of the operations whose kernel name is in
        ``names`` (``<kernel>_kernel`` of each), or None untraced."""
        if self.trace is None or not self.trace.frames:
            return None
        want = {f"{k}_kernel" for k in names}
        total = sum(e - s for s, e, n in self.trace.ops if kernel_base(n) in want)
        return total * 1e-3 / self.trace.frames
