"""The benchmark's own tests run on the CPU; a test that needs the card
takes the ``card`` fixture, which skips it where PyTorch sees none.  Tiny
frames render the port's small procedural scene (``tiny_contest``)."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="session")
def tiny_contest():
    """A configuration of the port's small procedural scene: 40 two-sided
    quads over a textured floor under an emissive panel."""
    return {"name": "tiny_contest", "source": "the port's own bench_scene",
            "writer": "procedural",
            "writer_args": {"num_objects": 40, "seed": 42, "two_sided": True},
            "file": "bench.gltf", "camera": "Camera 1", "assumed": {}, "reduced": []}
