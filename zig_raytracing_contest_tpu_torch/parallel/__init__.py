"""Multi-device pixel tiling (``sharding``)."""

from . import sharding  # noqa: F401
