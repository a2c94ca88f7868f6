"""bake_s: seconds of the program's scene preparation (``prepare_scene``):
load, preprocess and compile, the grid build included, from the
program's own phase timers.  Layer: scene and bake; moves setup_s."""

UNIT = "s"


def read(reading):
    phases = reading.phases or {}
    parts = [phases[k] for k in ("load", "preprocess", "compile") if k in phases]
    return sum(parts) if parts else None
