"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared by their
whole top-level part, since the port's name begins with the JAX
package's."""

import ast

import pytest

from pathbench import spec

JAX = {"jax", "jaxlib", "flax", "zig_raytracing_contest_tpu"}
PROGRAM = "zig_raytracing_contest_tpu_torch"
MODULES = sorted(p for p in spec.ROOT.rglob("*.py") if "_cache" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_the_check_compares_whole_names():
    tree = ast.parse("import zig_raytracing_contest_tpu_torch.render\nimport jax.numpy\n")
    path_names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            path_names |= {a.name.split(".", 1)[0] for a in node.names}
    assert path_names & JAX == {"jax"}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((spec.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert "pathbench" not in top_level_imports(path)


def test_a_process_running_the_port_holds_no_jax():
    """The harness's own check, in a fresh process that loads the
    benchmark, its reference and the port's render pipeline: nothing of
    JAX; a module named ``jax.numpy`` is caught, the port is not."""
    import subprocess
    import sys

    code = (
        "import sys, types\n"
        "from pathbench import harness, calibrate\n"
        "from pathbench.reference import plain, render, scene\n"
        "from zig_raytracing_contest_tpu_torch.render import pipeline\n"
        "from zig_raytracing_contest_tpu_torch import kernels\n"
        "print(harness.loaded_forbidden())\n"
        "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
        "print(harness.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.CHECKOUT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split("\n")
    assert out[:2] == ["[]", "['jax']"]
