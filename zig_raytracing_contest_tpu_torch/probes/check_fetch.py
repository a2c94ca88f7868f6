"""The texel fetch of the shade, held against a plain PyTorch gather.

The counterpart of the JAX package's paged-fetch check
(scripts/check_paged_tpu.py ``run_fetch``), which drives the paged texel
fetch (render/fused.py ``_fetch_paged``) through a minimal kernel: base
texel indices and a demand mask in, the four bilinear corners of each base
texel (self, +x, +y, +xy under the texture's wrap mode) × four channels
out.  A TPU kernel cannot gather, so the JAX package bakes each texel's
corners beside it in pages and loops over the pages a lane block demands;
here ``texel_fetch_kernel`` (kernels/path_trace.cu) loads the corners from
the row-major (P, 4) bank through the shade's own ``texel()`` loader, and
``texel_fetch_ref`` is the same fetch as a PyTorch gather.  At a clamp edge
the neighbour is the texel itself, loaded twice: the collapsed corner that
the JAX package's ``_paged_corners`` selects.

``run_checks`` holds the kernel to its plain version on the check's three
banks (1024 + 64, 3·2048/2 and 5·2048 texels of one texture, repeat on x,
clamp on y) and three index patterns (sequential, random, page-straddle),
every 7th lane not demanded, and on a clamp-clamp texture read at its
edges.  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.check_fetch

(``--device cpu`` runs the plain version against itself.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import kernels

PAGE_TEXELS = 2048  # the JAX package's page (scene/types.py PAGE_TEXELS)
BANK_TEXELS = (1024 + 64, 3 * PAGE_TEXELS // 2, 5 * PAGE_TEXELS)
LANES = 1024
TEX_W = 32


def corner_indices(texture, base: torch.Tensor) -> torch.Tensor:
    """(4, B) int64 bank indices of the corners self, +x, +y, +xy of each
    base texel of ``texture`` (off, w, h, repeat_u, repeat_v): the
    neighbour wraps under repeat and clamps at the last texel under clamp
    (the JAX package's ``_paged_corner_maps``)."""
    off, w, h, rep_u, rep_v = (int(x) for x in texture)
    local = base.to(torch.int64) - off
    y = torch.div(local, w, rounding_mode="floor")
    x = local - y * w
    nx = (x + 1) % w if rep_u else torch.clamp_max(x + 1, w - 1)
    ny = (y + 1) % h if rep_v else torch.clamp_max(y + 1, h - 1)
    return torch.stack([off + y * w + x, off + y * w + nx, off + ny * w + x,
                        off + ny * w + nx])


def texel_fetch_ref(bank: torch.Tensor, texture, base: torch.Tensor,
                    demand: torch.Tensor) -> torch.Tensor:
    """Plain version of ``texel_fetch``: a gather of the four corners,
    clamped into the bank as the shade's loader clamps."""
    idx = corner_indices(texture, base).clamp(0, bank.shape[0] - 1)
    px = torch.where(demand[None, :, None], bank[idx], 0.0)  # (4, B, 4)
    return px.permute(0, 2, 1).reshape(16, base.shape[0])


def texel_fetch(bank: torch.Tensor, texture, base: torch.Tensor,
                demand: torch.Tensor) -> torch.Tensor:
    """The four bilinear corners of each base texel ``base`` (B,) int32 of
    ``texture`` (off, w, h, repeat_u, repeat_v) in the u16-valued (P, 4)
    ``bank``: (16, B) f32, row 4·corner + channel; lanes where ``demand``
    (B,) bool is False read 0.  A CUDA bank launches texel_fetch_kernel, a
    CPU bank runs ``texel_fetch_ref``."""
    if bank.device.type == "cpu":
        return texel_fetch_ref(bank, texture, base, demand)
    if bank.device.type != "cuda":
        raise ValueError(f"no texel fetch kernel for device {bank.device}")
    out = torch.empty((16, base.shape[0]), dtype=torch.float32, device=bank.device)
    kernels.launch_texel_fetch(bank, texture, base, demand, out)
    return out


def make_bank(n_texels: int, seed: int = 0):
    """A synthetic bank of one TEX_W-wide texture of u16 texels (repeat on
    x, clamp on y), as the JAX check's ``make_bank`` draws it: ((P, 4) f32
    u16-valued bank as NumPy, texture (off, w, h, repeat_u, repeat_v))."""
    rng = np.random.default_rng(seed)
    h = max(1, n_texels // TEX_W)
    tex = rng.integers(0, 1 << 16, size=(h * TEX_W, 4)).astype(np.uint16)
    return tex.astype(np.float32), (0, TEX_W, h, 1, 0)


def index_cases(num_texels: int, lanes: int = LANES) -> dict:
    """The JAX check's index patterns over a bank of ``num_texels``: name ->
    (B,) int32 base indices."""
    rng = np.random.default_rng(7)
    return {
        "sequential": np.arange(lanes, dtype=np.int32) % num_texels,
        "random": rng.integers(0, num_texels, lanes).astype(np.int32),
        "page-straddle": (np.arange(lanes, dtype=np.int32) * 37) % num_texels,
    }


def demand_mask(lanes: int = LANES) -> np.ndarray:
    """Every lane demanded but every 7th (dead or missed lanes)."""
    demand = np.ones(lanes, bool)
    demand[::7] = False
    return demand


def clamp_edge_case(texture, lanes: int = LANES, seed: int = 3) -> np.ndarray:
    """Base indices of a clamp-clamp ``texture`` where its corners collapse
    (the last column and the last row), topped up with random texels."""
    off, w, h = (int(x) for x in texture[:3])
    edges = np.concatenate([off + np.arange(h) * w + (w - 1),
                            off + (h - 1) * w + np.arange(w)])
    rng = np.random.default_rng(seed)
    fill = off + rng.integers(0, w * h, max(lanes - edges.size, 0))
    return np.concatenate([edges, fill])[:lanes].astype(np.int32)


def check(bank, texture, base, demand) -> int:
    """Lanes where ``texel_fetch`` and ``texel_fetch_ref`` differ in any of
    the 16 rows (bit for bit)."""
    got = texel_fetch(bank, texture, base, demand)
    want = texel_fetch_ref(bank, texture, base, demand)
    return int((got.view(torch.int32) != want.view(torch.int32)).any(dim=0).sum())


def run_checks(device) -> list:
    """Every case of the check on ``device``: a list of (label, lanes,
    mismatched lanes)."""
    device = torch.device(device)
    out = []
    demand = torch.from_numpy(demand_mask()).to(device)
    for n in BANK_TEXELS:
        bank_np, texture = make_bank(n)
        bank = torch.from_numpy(bank_np).to(device)
        for name, base_np in index_cases(bank.shape[0]).items():
            base = torch.from_numpy(base_np).to(device)
            out.append((f"{n} texels / {name}", LANES, check(bank, texture, base, demand)))
        if n == BANK_TEXELS[-1]:
            clamp = (0, TEX_W, texture[2], 0, 0)
            base = torch.from_numpy(clamp_edge_case(clamp)).to(device)
            out.append((f"{n} texels / clamp edges", LANES,
                        check(bank, clamp, base, demand)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: PyTorch sees no CUDA card; pass --device cpu")
    failures = 0
    for label, lanes, bad in run_checks(args.device):
        failures += bool(bad)
        print(f"{'FAIL' if bad else 'PASS'} {label}: {bad} of {lanes} lanes differ")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
