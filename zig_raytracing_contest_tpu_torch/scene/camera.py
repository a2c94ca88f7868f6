"""Perspective camera resolution — reference-exact basis and error cases.

Mirrors stage1.loadCamera (src/stage1.zig:309-371).  Parity-critical
convention (SURVEY.md §3.5): ``up = cross(fwd, right)`` points world-*down*,
so buffer row 0 is the top image row and rays are generated as
``normalize(lower_left_corner + right*(x+ξ) + up*(y+ξ))``
(src/stage3.zig:27-35) with a fixed origin.  ``lower_left_corner`` is kept
as a name for parity; it is the top-left in world space.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gltf import Gltf, GltfError


@dataclass
class Camera:
    width: int
    height: int
    origin: np.ndarray  # (3,) f32
    lower_left_corner: np.ndarray  # (3,) f32
    right: np.ndarray  # (3,) f32
    up: np.ndarray  # (3,) f32  (world-down: screen-space y-down)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _find_camera_index(gltf: Gltf, camera_name: str | None) -> int:
    # src/stage1.zig:282-296
    cameras = gltf.doc.get("cameras", [])
    if not cameras:
        raise GltfError("NoCamerasAtAll")
    if camera_name is None:
        return 0
    for i, cam in enumerate(cameras):
        if cam.get("name") == camera_name:
            return i
    raise GltfError("CameraNotFound")


def _find_camera_node(gltf: Gltf, camera_idx: int) -> int:
    # src/stage1.zig:298-307 — first node referencing the camera, no
    # multi-instance handling (same limitation as the reference).
    for i, node in enumerate(gltf.doc.get("nodes", [])):
        if node.get("camera") == camera_idx:
            return i
    raise GltfError("CameraNodeNotFound")


def load_camera(
    gltf: Gltf,
    camera_name: str | None = None,
    width: int | None = None,
    height: int | None = None,
) -> Camera:
    """Resolve the render camera, reproducing the reference's strict w/h
    rules (src/stage1.zig:319-342): exactly one of width/height must come
    from the CLI when the glTF camera has an aspect ratio, both when it
    doesn't, and at least one always."""
    camera_idx = _find_camera_index(gltf, camera_name)
    node_idx = _find_camera_node(gltf, camera_idx)
    cam = gltf.doc["cameras"][camera_idx]

    if cam.get("type") != "perspective":
        raise GltfError("OnlyPerspectiveCamerasSupported")
    persp = cam["perspective"]
    aspect = persp.get("aspectRatio")

    if width is None and height is None:
        raise GltfError("OutputImgSizeIsNotSpecified")
    elif width is not None and height is not None:
        if aspect is not None:
            raise GltfError("CameraHasAspectRatio")
        w, h = width, height
    else:
        if aspect is None:
            raise GltfError("CameraHasntAspectRatio")
        w = width if width is not None else int(np.float32(height) * np.float32(aspect))
        h = height if height is not None else int(np.float32(width) / np.float32(aspect))

    f_w, f_h = np.float32(w), np.float32(h)

    matrix = gltf.global_transform(node_idx).astype(np.float32)
    origin = matrix[:3, 3]
    fwd = _normalize(-matrix[:3, 2])
    world_up = np.asarray([0.0, 1.0, 0.0], np.float32)
    right = _normalize(np.cross(fwd, world_up))
    up = np.cross(fwd, right)  # unit by construction; points world-down

    focal_length = (f_h / 2) / np.tan(np.float32(persp["yfov"]) / 2)
    lower_left_corner = fwd * focal_length - right * (f_w / 2) - up * (f_h / 2)

    return Camera(
        width=int(w),
        height=int(h),
        origin=origin.astype(np.float32),
        lower_left_corner=lower_left_corner.astype(np.float32),
        right=right.astype(np.float32),
        up=up.astype(np.float32),
    )
