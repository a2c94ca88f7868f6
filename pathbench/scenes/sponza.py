"""The Sponza-class interior's writer: a frozen copy of the port's
``write_sponza_glb`` and its texture generators
(``zig_raytracing_contest_tpu_torch/scene/sponza.py``): a 30x10x12 atrium
with colonnades, arches, alpha-MASK banners and grilles, 22 procedural
textures and emissive skylight and sconces; 160,968 triangles at
``detail=1.25``, 261,966 at ``detail=1.595``.  ``write`` is
``write_sponza_glb``."""

from __future__ import annotations

import logging

import numpy as np

from .glb import WRAP_CLAMP, GlbWriter, uv_sphere

log = logging.getLogger("pathbench")

# ---------------------------------------------------------------------------
# Procedural textures (each a REAL decoded PNG in the GLB).
# ---------------------------------------------------------------------------


def _value_noise(size, octaves, seed, amp=1.0):
    r = np.random.default_rng(seed)
    acc = np.zeros((size, size))
    for octave in octaves:
        grid = r.uniform(-1, 1, (octave + 1, octave + 1))
        s = np.linspace(0, octave, size, endpoint=False)
        i0 = s.astype(int)
        f = s - i0
        fy, fx = f[:, None], f[None, :]
        g = (
            grid[i0][:, i0] * (1 - fy) * (1 - fx)
            + grid[i0][:, i0 + 1] * (1 - fy) * fx
            + grid[i0 + 1][:, i0] * fy * (1 - fx)
            + grid[i0 + 1][:, i0 + 1] * fy * fx
        )
        acc += g * (octaves[0] / octave) * amp
    return acc / np.abs(acc).max()


def _to_rgba(rgb):
    rgba = np.empty((*rgb.shape[:2], 4), np.uint8)
    rgba[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    rgba[..., 3] = 255
    return rgba


def marble(size, base, vein, seed):
    n = _value_noise(size, (4, 8, 16, 32), seed)
    x = np.linspace(0, 6 * np.pi, size)
    veins = np.abs(np.sin(x[None, :] + 4.0 * n))
    k = (veins**0.6)[..., None]
    rgb = np.asarray(vein) + (np.asarray(base) - np.asarray(vein)) * k
    return _to_rgba(rgb + 12 * n[..., None])


def brick(size, mortar, face, seed, rows=12):
    y = np.arange(size)[:, None] * rows // size
    shift = (y % 2) * (size // rows // 2)
    xs = (np.arange(size)[None, :] + shift) * rows // size
    bx = (np.arange(size)[None, :] + shift) % (size // rows)
    by = np.arange(size)[:, None] % (size // rows)
    m = (bx < 2) | (by < 2)
    r = np.random.default_rng(seed)
    jitter = r.uniform(-18, 18, (rows + 1, rows * 2 + 2))
    rgb = np.where(
        m[..., None], np.asarray(mortar), np.asarray(face) + jitter[y, xs][..., None]
    )
    rgb = rgb + 10 * _value_noise(size, (16, 32), seed + 1)[..., None]
    return _to_rgba(rgb)


def plaster(size, base, seed):
    n = _value_noise(size, (6, 12, 24, 48), seed)
    return _to_rgba(np.asarray(base) + 22 * n[..., None])


def mosaic(size, seed, tiles=24):
    r = np.random.default_rng(seed)
    pal = r.uniform(60, 220, (tiles, tiles, 3))
    iy = np.arange(size) * tiles // size
    ix = np.arange(size) * tiles // size
    rgb = pal[iy][:, ix]
    gy = np.arange(size)[:, None] % (size // tiles) < 2
    gx = np.arange(size)[None, :] % (size // tiles) < 2
    rgb = np.where((gy | gx)[..., None], 30.0, rgb)
    return _to_rgba(rgb)


def fresco(size, seed):
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size))
    rad = np.sqrt(xx**2 + yy**2)
    ang = np.arctan2(yy, xx)
    bands = 0.5 + 0.5 * np.sin(rad * 18 + 3 * np.sin(ang * 6))
    base = np.asarray([188, 168, 128]) + 60 * (bands[..., None] - 0.5)
    base += 16 * _value_noise(size, (8, 16), seed)[..., None]
    return _to_rgba(base)


def fabric(size, color, seed, fringe=True):
    """Banner cloth: woven stripes; bottom 12% is an alpha fringe (MASK)."""
    n = _value_noise(size, (32, 64), seed, 0.5)
    stripe = 0.85 + 0.15 * np.sin(np.arange(size) * 2 * np.pi / 24)
    rgb = np.asarray(color) * stripe[:, None, None] + 14 * n[..., None]
    # woven cross-threads
    rgb *= (0.93 + 0.07 * np.sin(np.arange(size) * np.pi / 2))[None, :, None]
    rgba = _to_rgba(rgb)
    if fringe:
        h0 = int(size * 0.88)
        strip_w = max(2, size // 32)
        cut = ((np.arange(size) // strip_w) % 2).astype(bool)
        rgba[h0:, cut, 3] = 0
    return rgba


def wood(size, seed):
    n = _value_noise(size, (3, 6, 12), seed)
    x = np.linspace(0, 14 * np.pi, size)
    grain = 0.5 + 0.5 * np.sin(x[None, :] + 5.5 * n)
    rgb = np.asarray([96, 62, 36]) + 42 * grain[..., None]
    return _to_rgba(rgb)


def grille(size, seed):
    """Window lattice: opaque bars on a transparent field (MASK)."""
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[..., :3] = 35
    step = size // 8
    bar = np.zeros(size, bool)
    for k in range(0, size, step):
        bar[k : k + 3] = True
    m = bar[:, None] | bar[None, :]
    rgba[m, 3] = 255
    rgba[m, 0:3] = 40
    return rgba


def gold_trim(size, seed):
    n = _value_noise(size, (8, 24), seed)
    bands = 0.6 + 0.4 * np.sin(np.arange(size) * 2 * np.pi / (size // 4))
    rgb = np.asarray([205, 160, 60]) * bands[:, None, None] + 18 * n[..., None]
    return _to_rgba(rgb)


# ---------------------------------------------------------------------------
# Geometry helpers (vectorized; u16 indices => < 64k verts per mesh).
# ---------------------------------------------------------------------------


def grid_mesh(nu, nv):
    """Unit-square (u,v) grid: uvs + u16 indices, positions to be mapped."""
    u = np.linspace(0, 1, nu + 1, dtype=np.float32)
    v = np.linspace(0, 1, nv + 1, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    j, i = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    a = (j * (nu + 1) + i).ravel()
    idx = np.stack(
        [a, a + nu + 1, a + 1, a + 1, a + nu + 1, a + nu + 2], axis=1
    ).ravel()
    return uu, vv, np.asarray(idx, np.uint16)


def displaced_panel(center, uax, vax, nu, nv, bump, seed, uv_scale=1.0):
    """Tessellated quad panel with small normal-direction displacement —
    keeps walls from being two flat triangles, adds realistic tri counts."""
    uu, vv, idx = grid_mesh(nu, nv)
    c = np.asarray(center, np.float64)
    ua = np.asarray(uax, np.float64)
    va = np.asarray(vax, np.float64)
    nax = np.cross(ua, va)
    nax /= np.linalg.norm(nax)
    h = bump * _value_noise_grid(nu + 1, nv + 1, seed)
    pos = (
        c[None, None]
        + (uu[..., None] * 2 - 1) * ua[None, None]
        + (vv[..., None] * 2 - 1) * va[None, None]
        + h[..., None] * nax[None, None]
    )
    nrm = np.tile(nax.astype(np.float32), (pos.shape[0] * pos.shape[1], 1))
    uvs = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32) * uv_scale
    return pos.reshape(-1, 3).astype(np.float32), nrm, uvs, idx


def _value_noise_grid(nx, ny, seed, octave=6):
    r = np.random.default_rng(seed)
    g = r.uniform(-1, 1, (octave + 1, octave + 1))
    sx = np.linspace(0, octave, nx, endpoint=False)
    sy = np.linspace(0, octave, ny, endpoint=False)
    ix, iy = sx.astype(int), sy.astype(int)
    fx, fy = sx - ix, sy - iy
    return (
        g[iy][:, ix] * (1 - fy)[:, None] * (1 - fx)[None, :]
        + g[iy][:, ix + 1] * (1 - fy)[:, None] * fx[None, :]
        + g[iy + 1][:, ix] * fy[:, None] * (1 - fx)[None, :]
        + g[iy + 1][:, ix + 1] * fy[:, None] * fx[None, :]
    )


def cylinder(nu, nv, radius, height, r_profile=None):
    """Vertical open cylinder; r_profile(t in 0..1) scales the radius."""
    uu, vv, idx = grid_mesh(nu, nv)
    ang = uu * 2 * np.pi
    r = radius * (r_profile(vv) if r_profile is not None else 1.0)
    x = np.cos(ang) * r
    z = np.sin(ang) * r
    y = vv * height
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], -1)
    nrm = nrm.reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu * 4, vv * 3], -1).reshape(-1, 2).astype(np.float32)
    return pos, nrm, uvs, idx


def box_mesh(sx, sy, sz, uv_scale=1.0):
    """Axis-aligned box centered at origin (y from 0), 12 tris."""
    pos_l, nrm_l, uv_l, idx_l = [], [], [], []
    faces = [
        ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (1, 0, 0), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
    ]
    half = np.asarray([sx / 2, sy / 2, sz / 2])
    base = 0
    for n, ua, va in faces:
        n = np.asarray(n, np.float64)
        ua = np.asarray(ua, np.float64)
        va = np.asarray(va, np.float64)
        c = n * half + np.asarray([0, sy / 2, 0])
        corners = [
            c - ua * half - va * half,
            c + ua * half - va * half,
            c + ua * half + va * half,
            c - ua * half + va * half,
        ]
        corners = [k * np.abs(ua + va) + c * np.abs(n) for k in corners]
        pos_l += corners
        nrm_l += [n] * 4
        uv_l += [[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]]
        idx_l += [base, base + 1, base + 2, base, base + 2, base + 3]
        base += 4
    return (
        np.asarray(pos_l, np.float32),
        np.asarray(nrm_l, np.float32),
        np.asarray(uv_l, np.float32),
        np.asarray(idx_l, np.uint16),
    )


def arch_ribbon(nu, nv, radius, width, thickness=0.0):
    """Half-torus-like arch in the xz=0 plane: a ribbon sweeping 180 deg
    (x = r cos a, y = r sin a), extruded along z by width."""
    uu, vv, idx = grid_mesh(nu, nv)
    a = uu * np.pi
    x = np.cos(a) * radius
    y = np.sin(a) * radius
    z = (vv * 2 - 1) * width / 2
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([-np.cos(a), -np.sin(a), np.zeros_like(a)], -1)
    nrm = nrm.reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu * 6, vv], -1).reshape(-1, 2).astype(np.float32)
    return pos, nrm, uvs, idx


def banner_mesh(nu, nv, w, h, wave):
    """Hanging cloth: vertical panel with a sinusoidal z-wave."""
    uu, vv, idx = grid_mesh(nu, nv)
    x = (uu * 2 - 1) * w / 2
    y = -vv * h
    z = wave * np.sin(uu * 3 * np.pi) * vv
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.tile(np.asarray([0, 0, 1], np.float32), (pos.shape[0], 1))
    uvs = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    return pos, nrm, uvs, idx


# ---------------------------------------------------------------------------
# Scene assembly.
# ---------------------------------------------------------------------------


def write_sponza_glb(path, detail: float = 1.0, tex: int = 192):
    w = GlbWriter()

    def seg(n):
        return max(4, int(round(n * detail)))

    # -- 21+ distinct textures ------------------------------------------------
    t_floor = w.add_png_texture(marble(256, (205, 198, 186), (120, 116, 110), 1))
    t_mosaic = w.add_png_texture(mosaic(tex, 2), wrap=WRAP_CLAMP)
    t_col = [
        w.add_png_texture(marble(tex, (214, 206, 196), (150, 140, 128), 3 + k))
        for k in range(4)
    ]
    t_brick = [
        w.add_png_texture(brick(tex, (168, 160, 150), (172, 120, 90), 10)),
        w.add_png_texture(brick(tex, (160, 154, 146), (150, 104, 82), 11)),
    ]
    t_plaster = [
        w.add_png_texture(plaster(tex, (196, 182, 162), 20)),
        w.add_png_texture(plaster(tex, (184, 174, 160), 21)),
    ]
    t_fresco = w.add_png_texture(fresco(256, 30), wrap=WRAP_CLAMP)
    banner_colors = [
        (170, 40, 40), (40, 80, 160), (40, 130, 60),
        (180, 140, 40), (120, 50, 140), (190, 90, 30),
    ]
    t_banner = [
        w.add_png_texture(fabric(tex, c, 40 + k), wrap=WRAP_CLAMP)
        for k, c in enumerate(banner_colors)
    ]
    t_wood = w.add_png_texture(wood(tex, 50))
    t_grille = w.add_png_texture(grille(128, 60))
    t_trim = w.add_png_texture(gold_trim(tex, 70))
    t_stone = [
        w.add_png_texture(marble(tex, (150, 148, 144), (96, 94, 92), 80)),
        w.add_png_texture(brick(tex, (120, 118, 114), (136, 130, 122), 81, rows=8)),
    ]

    # -- materials -------------------------------------------------------------
    m_floor = w.add_material(base_texture=t_floor)
    m_mosaic = w.add_material(base_texture=t_mosaic)
    m_col = [w.add_material(base_texture=t) for t in t_col]
    m_brick = [w.add_material(base_texture=t) for t in t_brick]
    m_plaster = [w.add_material(base_texture=t) for t in t_plaster]
    m_fresco = w.add_material(base_texture=t_fresco)
    m_banner = [
        w.add_material(base_texture=t, alpha_mode="MASK", alpha_cutoff=0.5)
        for t in t_banner
    ]
    m_wood = w.add_material(base_texture=t_wood)
    m_grille = w.add_material(
        base_texture=t_grille, alpha_mode="MASK", alpha_cutoff=0.5
    )
    m_trim = w.add_material(base_texture=t_trim)
    m_stone = [w.add_material(base_texture=t) for t in t_stone]
    m_sky = w.add_material(base_factor=(0, 0, 0, 1), emissive=(9.0, 8.6, 8.0))
    m_sconce = w.add_material(base_factor=(0, 0, 0, 1), emissive=(14.0, 9.0, 4.0))
    m_pot = w.add_material(base_factor=(0.45, 0.28, 0.18, 1.0))

    def put(mesh_arrays, mat, **trs):
        pos, nrm, uvs, idx = mesh_arrays
        w.add_node(mesh=w.add_mesh(pos, nrm, uvs, idx, mat), **trs)

    # -- hall shell (interior faces only; normals point inward) ---------------
    HX, HY, HZ = 15.0, 10.0, 6.0  # half-x, height, half-z
    fl = seg(110)
    put(
        displaced_panel((0, 0, 0), (HX, 0, 0), (0, 0, -HZ), fl, seg(44), 0.02, 100,
                        uv_scale=10.0),
        m_floor,
    )
    # mosaic center strip (slightly raised so it wins the z-fight)
    put(
        displaced_panel((0, 0.012, 0), (HX * 0.6, 0, 0), (0, 0, -HZ * 0.3),
                        seg(70), seg(20), 0.0, 101, uv_scale=1.0),
        m_mosaic,
    )
    # ceiling (fresco), with an emissive skylight strip down the middle
    put(
        displaced_panel((0, HY, 0), (HX, 0, 0), (0, 0, HZ), seg(90), seg(36),
                        0.02, 102, uv_scale=1.0),
        m_fresco,
    )
    put(
        displaced_panel((0, HY - 0.02, 0), (HX * 0.7, 0, 0), (0, 0, HZ * 0.18),
                        seg(20), seg(4), 0.0, 103),
        m_sky,
    )
    # long walls: brick below, plaster above
    for zs, flip in ((-HZ, 1), (HZ, -1)):
        put(
            displaced_panel((0, 2.25, zs), (HX * flip, 0, 0), (0, 2.25, 0),
                            seg(110), seg(18), 0.03, 110 + flip, uv_scale=6.0),
            m_brick[0 if flip > 0 else 1],
        )
        put(
            displaced_panel((0, 7.25, zs), (HX * flip, 0, 0), (0, 2.75, 0),
                            seg(110), seg(20), 0.03, 120 + flip, uv_scale=5.0),
            m_plaster[0 if flip > 0 else 1],
        )
    # end walls
    for xs, flip in ((-HX, -1), (HX, 1)):
        put(
            displaced_panel((xs, HY / 2, 0), (0, 0, HZ * flip), (0, HY / 2, 0),
                            seg(44), seg(36), 0.03, 130 + flip, uv_scale=4.0),
            m_stone[0 if flip > 0 else 1],
        )
    # wooden door on the -x end wall
    put(
        displaced_panel((-HX + 0.05, 1.6, 0), (0, 0, 1.2), (0, 1.6, 0),
                        seg(12), seg(12), 0.01, 140),
        m_wood,
    )

    # -- colonnades ------------------------------------------------------------
    n_cols = 9
    xs = np.linspace(-HX + 2.5, HX - 2.5, n_cols)
    col_cyl = cylinder(
        seg(36), seg(26), 0.42, 6.0,
        r_profile=lambda v: 1.0 - 0.12 * v + 0.06 * np.sin(v * np.pi),
    )
    base_box = box_mesh(1.2, 0.5, 1.2, uv_scale=2.0)
    cap_box = box_mesh(1.1, 0.4, 1.1, uv_scale=2.0)
    for zc in (-3.4, 3.4):
        for k, xc in enumerate(xs):
            put(base_box, m_stone[k % 2], translation=(xc, 0, zc))
            put(col_cyl, m_col[k % 4], translation=(xc, 0.5, zc))
            put(cap_box, m_trim, translation=(xc, 6.5, zc))
        # arches between consecutive capitals
        gap = xs[1] - xs[0]
        arch = arch_ribbon(seg(40), seg(6), gap / 2 - 0.18, 0.85)
        for k in range(n_cols - 1):
            put(
                arch, m_brick[k % 2],
                translation=(float((xs[k] + xs[k + 1]) / 2), 6.9, zc),
            )
        # balcony ledge above the colonnade
        put(
            displaced_panel((0, 7.6, zc), (HX - 2.0, 0, 0), (0, 0, 0.55),
                            seg(90), seg(5), 0.01, 150, uv_scale=8.0),
            m_trim,
        )

    # -- banners (two-sided: MASK alpha, reference back-face culls) -----------
    bn = banner_mesh(seg(22), seg(18), 1.3, 2.6, 0.22)
    bpos, bnrm, buv, bidx = bn
    bn_back = (bpos, -bnrm, buv, bidx[::-1].copy())
    for k in range(6):
        xc = float(xs[1 + k * (n_cols - 2) // 5])
        zc = -3.4 if k % 2 else 3.4
        put(bn, m_banner[k], translation=(xc, 6.4, zc * 0.88))
        put(bn_back, m_banner[k], translation=(xc, 6.4, zc * 0.88))

    # -- window grilles on the upper walls (MASK lattice) ----------------------
    gr = banner_mesh(seg(8), seg(8), 1.6, 1.6, 0.0)
    gpos, gnrm, guv, gidx = gr
    for k in range(4):
        xc = float(np.linspace(-HX + 4, HX - 4, 4)[k])
        for zc in (-HZ + 0.1, HZ - 0.1):
            put((gpos, gnrm, guv, gidx), m_grille, translation=(xc, 9.2, zc))

    # -- pots + sconces ---------------------------------------------------------
    pot = uv_sphere(seg(28), seg(20), radii=(0.5, 0.62, 0.5))
    for k in range(6):
        xc = float(np.linspace(-HX + 3.5, HX - 3.5, 6)[k])
        zc = 2.2 if k % 2 else -2.2
        put(pot, m_pot, translation=(xc, 0.6, zc))
    sconce = box_mesh(0.25, 0.25, 0.12)
    for k in range(5):
        xc = float(np.linspace(-HX + 3, HX - 3, 5)[k])
        for zc in (-HZ + 0.15, HZ - 0.15):
            put(sconce, m_sconce, translation=(xc, 4.6, zc))

    # -- camera: inside, looking down the hall --------------------------------
    cam = w.add_camera(yfov=0.9, aspect=16 / 9, name="Camera 1")
    eye = np.asarray([-HX + 1.8, 2.4, 1.6])
    target = np.asarray([HX, 3.2, -0.5])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.stack([right, up, -fwd], axis=1)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    qw = np.sqrt(max(0.0, 1 + tr)) / 2
    qx = (m[2, 1] - m[1, 2]) / (4 * qw)
    qy = (m[0, 2] - m[2, 0]) / (4 * qw)
    qz = (m[1, 0] - m[0, 1]) / (4 * qw)
    w.add_node(camera=cam, translation=eye.tolist(),
               rotation=(float(qx), float(qy), float(qz), float(qw)))

    out = w.write(path)
    tris = sum(
        w.accessors[p["indices"]]["count"] // 3
        for mesh in w.meshes
        for p in mesh["primitives"]
    )
    log.info("sponza: %d triangles, %d materials, %d textures -> %s", tris,
             len(w.materials), len(w.textures), out)
    return out


write = write_sponza_glb  # the entry that scenes.load_writer finds
