"""The Duck-class room's writer: a frozen copy of the port's
``write_duck_glb`` and its meshes and textures
(``zig_raytracing_contest_tpu_torch/scene/duck.py``): a parametric rubber
duck (lathed body, head, beak, tail, eyes) with a mottled body texture,
on a checker floor inside three walls under a 2.5 m emitting ceiling
quad, and a 16:9 camera.  9,576 duck triangles at ``detail=1``, 4,198 at
``detail=0.66``; the room adds 10.  ``write`` is ``write_duck_glb``."""

from __future__ import annotations

import numpy as np

from .glb import WRAP_REPEAT, GlbWriter, uv_sphere


def cone(nu=24, length=1.0, r0=0.35, r1=0.02, flatten=1.0):
    """Open cone along +x with vertical flattening (beak/tail)."""
    u = np.linspace(0, 2 * np.pi, nu + 1)
    xs = np.linspace(0, length, 8)
    uu, xx = np.meshgrid(u, xs)
    r = r0 + (r1 - r0) * (xx / length)
    y = np.cos(uu) * r * flatten
    z = np.sin(uu) * r
    pos = np.stack([xx, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack(
        [np.full_like(uu, (r0 - r1) / length), np.cos(uu) / max(flatten, 1e-3),
         np.sin(uu)], -1
    ).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    uvs = np.stack([uu / (2 * np.pi), xx / length], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(7):
        for i in range(nu):
            a = j * (nu + 1) + i
            b = a + nu + 1
            idx += [a, a + 1, b, a + 1, b + 1, b]
    return pos, nrm, uvs, np.asarray(idx, np.uint16)


def quad_mesh(center, uax, vax, uv_scale=1.0):
    c = np.asarray(center, np.float32)
    ua = np.asarray(uax, np.float32)
    va = np.asarray(vax, np.float32)
    pos = np.stack([c - ua - va, c + ua - va, c + ua + va, c - ua + va])
    n = np.cross(ua, va)
    n = (n / np.linalg.norm(n)).astype(np.float32)
    nrm = np.tile(n, (4, 1))
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    return pos, nrm, uvs, np.asarray([0, 1, 2, 0, 2, 3], np.uint16)


def duck_texture(size=512, seed=11):
    """Mottled-yellow body texture (value-noise octaves)."""
    r = np.random.default_rng(seed)
    acc = np.zeros((size, size))
    for octave in (8, 16, 32, 64):
        grid = r.uniform(-1, 1, (octave + 1, octave + 1))
        ys = np.linspace(0, octave, size, endpoint=False)
        xs = np.linspace(0, octave, size, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (
            grid[y0][:, x0] * (1 - fy) * (1 - fx)
            + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0] * fy * (1 - fx)
            + grid[y0 + 1][:, x0 + 1] * fy * fx
        )
        acc += g * (8.0 / octave)
    acc /= np.abs(acc).max()
    rgba = np.empty((size, size, 4), np.uint8)
    rgba[..., 0] = np.clip(235 + 18 * acc, 0, 255)
    rgba[..., 1] = np.clip(200 + 34 * acc, 0, 255)
    rgba[..., 2] = np.clip(40 + 28 * acc, 0, 255)
    rgba[..., 3] = 255
    return rgba


def checker_texture(size=256):
    t = np.zeros((size, size, 4), np.uint8)
    c = ((np.arange(size)[:, None] // 32 + np.arange(size)[None, :] // 32) % 2).astype(bool)
    t[c] = [200, 205, 210, 255]
    t[~c] = [70, 80, 95, 255]
    t[..., 3] = 255
    return t


def write_duck_glb(path, tex_size=512, detail=1.0):
    """Write the Duck-class GLB to ``path``.  ~12k triangles at detail=1;
    ``tex_size`` is the body texture's side."""
    w = GlbWriter()
    duck_tex = w.add_png_texture(duck_texture(tex_size), wrap=WRAP_REPEAT)
    floor_tex = w.add_png_texture(checker_texture(), wrap=WRAP_REPEAT)
    body_mat = w.add_material(base_texture=duck_tex)
    beak_mat = w.add_material(base_factor=(0.95, 0.45, 0.08, 1.0))
    eye_mat = w.add_material(base_factor=(0.05, 0.05, 0.06, 1.0))
    floor_mat = w.add_material(base_texture=floor_tex)
    wall_mat = w.add_material(base_factor=(0.62, 0.64, 0.68, 1.0))
    light_mat = w.add_material(base_factor=(0, 0, 0, 1), emissive=(7.0, 6.6, 6.0))

    def seg(n):
        return max(8, int(n * detail))

    def body_squash(p):
        # Egg the body: widen the chest, taper the rear, lift the breast.
        q = p.copy()
        q[..., 1] += 0.18 * np.clip(p[..., 0], 0, 1) ** 2
        q[..., 2] *= 1.0 - 0.15 * np.clip(-p[..., 0], 0, 1)
        return q

    parts = [  # (mesh arrays, material, node TRS)
        (uv_sphere(seg(64), seg(40), radii=(1.35, 0.95, 1.05), squash=body_squash),
         body_mat, dict(translation=(0, 0.95, 0))),
        (uv_sphere(seg(48), seg(32), radii=(0.52, 0.55, 0.48)),
         body_mat, dict(translation=(0.95, 1.95, 0))),
        (cone(seg(24), length=0.55, r0=0.27, r1=0.05, flatten=0.45),
         beak_mat, dict(translation=(1.32, 1.85, 0))),
        # tail: rotated 150° about z (pointing back-up), quaternion xyzw
        (cone(seg(20), length=0.7, r0=0.3, r1=0.03, flatten=0.8),
         body_mat, dict(translation=(-1.15, 1.25, 0),
                        rotation=(0, 0, float(np.sin(2.62 / 2)),
                                  float(np.cos(2.62 / 2))))),
    ]
    for side in (-1, 1):
        parts.append((uv_sphere(seg(16), seg(12), radii=(0.07, 0.07, 0.07)),
                      eye_mat, dict(translation=(1.25, 2.12, 0.27 * side))))

    duck_children = []
    for (pos, nrm, uvs, idx), mat, trs in parts:
        mesh = w.add_mesh(pos, nrm, uvs, idx, mat)
        duck_children.append(w.add_node(mesh=mesh, root=False, **trs))
    # Whole duck under one node: rotated 35° about Y, scaled 1.2.
    ang = np.deg2rad(35.0)
    w.add_node(children=duck_children,
               rotation=(0, float(np.sin(ang / 2)), 0, float(np.cos(ang / 2))),
               scale=(1.2, 1.2, 1.2))

    # Room: textured floor, walls, ceiling light.
    S = 7.0
    for center, ua, va, mat, uv_s in [
        ((0, 0, 0), (S, 0, 0), (0, 0, -S), floor_mat, 6.0),
        ((0, 6.5, 0), (2.5, 0, 0), (0, 0, 2.5), light_mat, 1.0),
        ((0, 3, -S), (S, 0, 0), (0, 3.5, 0), wall_mat, 1.0),
        ((-S, 3, 0), (0, 0, S), (0, 3.5, 0), wall_mat, 1.0),
        ((S, 3, 0), (0, 0, -S), (0, 3.5, 0), wall_mat, 1.0),
    ]:
        pos, nrm, uvs, idx = quad_mesh(center, ua, va, uv_s)
        w.add_node(mesh=w.add_mesh(pos, nrm, uvs, idx, mat))

    # Camera at +z looking at the duck, aspect 16:9 so --height alone
    # resolves the width (Duck.glb-style).
    cam = w.add_camera(yfov=0.7, aspect=16 / 9)
    eye = np.asarray([4.2, 3.0, 5.5])
    target = np.asarray([0, 1.3, 0])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    # Camera -z axis = fwd (glTF convention); build the node rotation.
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.stack([right, up, -fwd], axis=1)  # columns = camera axes
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    qw = np.sqrt(max(0.0, 1 + tr)) / 2
    qx = (m[2, 1] - m[1, 2]) / (4 * qw)
    qy = (m[0, 2] - m[2, 0]) / (4 * qw)
    qz = (m[1, 0] - m[0, 1]) / (4 * qw)
    w.add_node(camera=cam, translation=eye.tolist(),
               rotation=(float(qx), float(qy), float(qz), float(qw)))
    return w.write(path)


write = write_duck_glb  # the entry that scenes.load_writer finds
