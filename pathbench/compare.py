"""The comparison that decides ``correct``: the frames the window produced
against the reference's frame of the same scene, camera and seed.

Numbers compared, each with the limit the cell's workload file gives:

* ``image_mad``: the mean absolute difference over every channel of the
  8-bit image, the worst of the frames checked (a frame of another shape
  reads 255);
* ``segments_gap``: |segments - reference's| / reference's, the worst of
  the frames checked;
* ``kernels_unexpected``: kernels launched and not in the cell's list, or
  listed and not launched (limit 0; read on a CUDA card only).
"""

from __future__ import annotations

import numpy as np


def image_mad(image: np.ndarray, ref: np.ndarray) -> float:
    if image.shape != ref.shape:
        return 255.0
    return float(np.abs(image.astype(np.int16) - ref.astype(np.int16)).mean())


def segments_gap(segments: int, ref: int) -> float:
    return abs(int(segments) - int(ref)) / max(int(ref), 1)


def judge(frames, ref_image, ref_segments, launched, workload):
    """(correct, failed frames, checks) of the checked ``frames`` ((index,
    image, segments) each); ``launched`` the kernels the window launched
    (None where no card counts them)."""
    limits = workload.limits
    failed, mad, gap = 0, 0.0, 0.0
    for _, image, segments in frames:
        m = image_mad(image, ref_image)
        g = segments_gap(segments, ref_segments)
        failed += int(m > limits["image_mad"] or g > limits["segments_gap"])
        mad, gap = max(mad, m), max(gap, g)
    checks = {"image_mad": {"value": mad, "limit": limits["image_mad"]},
              "segments_gap": {"value": gap, "limit": limits["segments_gap"]}}
    ok = bool(frames) and failed == 0
    if launched is not None:
        odd = set(launched) ^ set(workload.kernels)
        checks["kernels_unexpected"] = {"value": len(odd), "limit": 0}
        ok = ok and not odd
    return ok, failed, checks
