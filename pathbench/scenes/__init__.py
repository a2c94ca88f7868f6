"""The benchmark's scenes: the writers, one file each
(``scenes/<writer>.py``, whose ``write(path, **args)`` writes the scene),
found by the name a configuration gives, and the cache of written scene
files inside the checkout, one directory a configuration."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's own directory


def load_writer(name: str, root: Path = ROOT):
    """The ``write`` function of ``scenes/<name>.py`` under ``root``; the
    file may import the benchmark's own scene modules relatively."""
    path = root / "scenes" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no scene writer {name}: {path}")
    spec = importlib.util.spec_from_file_location(f"pathbench.scenes.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.write


def scene_file(config: dict, cache: Path, root: Path = ROOT) -> Path:
    """The configuration's scene file under ``cache/<config>/``, written by
    its writer on first use.  The directory is written whole under a
    temporary name and renamed into place, so a run never reads a part of
    it; its ``writer.json`` records what wrote it."""
    final = cache / config["name"]
    stamp = {"writer": config["writer"], "args": config["writer_args"]}
    marker = final / "writer.json"
    if marker.is_file() and json.loads(marker.read_text()) == stamp:
        return final / config["file"]
    if final.exists():
        shutil.rmtree(final)
    tmp = cache / f".{config['name']}.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    load_writer(config["writer"], root)(tmp / config["file"], **config["writer_args"])
    (tmp / "writer.json").write_text(json.dumps(stamp))
    os.replace(tmp, final)
    return final / config["file"]
