"""The C entry points of the CUDA sources against their ctypes bindings.

``kernels.ENTRY_POINTS`` declares each ``extern "C"`` function of
kernels/path_trace.cu and kernels/probes.cu once: its return type and its
argument types, in order.  ctypes passes whatever the table says, so a
parameter added, dropped or moved in C and not in the table would reach
the kernel as a shifted argument, silently.  Here each source is parsed
for its exported functions and every one is held to the table: bound
under its name, with as many argument types as it has parameters, each a
pointer where the C parameter is one (a pointer to the struct of the same
name where it is a ``Zrc*`` struct) and an int where it is an int, and
nothing bound that the source does not export.  No nvcc or card needed.
"""

import ctypes
import re

import pytest

from zig_raytracing_contest_tpu_torch import kernels

_EXTERN = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(zrc_\w+)\s*\(([^)]*)\)\s*\{')


def exported(source: str) -> dict:
    """name -> (return type, [parameter types]) of every ``extern "C"``
    function of ``kernels.SOURCES[source]``."""
    out = {}
    for ret, name, params in _EXTERN.findall(kernels.SOURCES[source].read_text()):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if p and p != "void":
                types.append(re.sub(r"\s*\b\w+$", "", p))  # drop the parameter's name
        out[name] = (" ".join(ret.split()), types)
    return out


def _cases():
    for source, table in sorted(kernels.ENTRY_POINTS.items()):
        for name in sorted(set(exported(source)) | set(table)):
            yield pytest.param(source, name, id=f"{source}-{name}")


def _matches(c_type: str, argtype) -> bool:
    """Whether the ctypes ``argtype`` passes the C type ``c_type``."""
    struct = re.search(r"\b(Zrc\w+)\s*\*", c_type)
    if struct:
        return getattr(argtype, "_type_", None) is getattr(kernels, struct.group(1))
    if "*" in c_type:
        return argtype is ctypes.c_void_p
    return c_type == "int" and argtype is ctypes.c_int


@pytest.mark.parametrize("source, name", list(_cases()))
def test_entry_point_bound_as_exported(source, name):
    c = exported(source)
    table = kernels.ENTRY_POINTS[source]
    assert name in c, f"{name} is bound but {source}.cu exports no such function"
    assert name in table, f"{source}.cu exports {name}, which ENTRY_POINTS does not bind"
    ret, params = c[name]
    restype, argtypes = table[name]
    assert len(argtypes) == len(params), (name, params, argtypes)
    for i, (c_type, argtype) in enumerate(zip(params, argtypes)):
        assert _matches(c_type, argtype), f"{name} argument {i}: {c_type} bound as {argtype}"
    assert restype is (ctypes.c_char_p if ret == "const char*" else ctypes.c_int), (ret, restype)


def test_every_source_is_bound():
    """ENTRY_POINTS has a table for each source, and each source exports
    at least its error-string function."""
    assert set(kernels.ENTRY_POINTS) == set(kernels.SOURCES)
    for source in kernels.SOURCES:
        assert any(n.endswith("error_string") for n in exported(source)), source
