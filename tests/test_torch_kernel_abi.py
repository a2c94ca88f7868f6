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
nothing bound that the source does not export.  The ``Zrc*`` structs the
entry points take are held to their ctypes mirrors the same way: the same
fields in the same order, each a pointer, an int, an unsigned int, a float
array or the nested struct of the same name.  No nvcc or card needed.
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


_STRUCT = re.compile(r"^struct (Zrc\w+) \{(.*?)^\};", re.S | re.M)


def structs(source: str) -> dict:
    """name -> [(C type, field name, array length or 0)] of every ``Zrc*``
    struct of ``kernels.SOURCES[source]``."""
    out = {}
    for name, body in _STRUCT.findall(kernels.SOURCES[source].read_text()):
        fields = []
        for decl in re.sub(r"//[^\n]*", "", body).split(";"):
            decl = " ".join(decl.split())
            if decl:
                m = re.fullmatch(r"(.+?)\s*\b(\w+)(?:\[(\d+)\])?", decl)
                fields.append((m.group(1), m.group(2), int(m.group(3) or 0)))
        out[name] = fields
    return out


def _field_matches(c_type: str, n: int, ctype) -> bool:
    """Whether the ctypes field type ``ctype`` lays out the C field."""
    if n:
        return getattr(ctype, "_length_", None) == n and _field_matches(c_type, 0, ctype._type_)
    if "*" in c_type:
        return ctype is ctypes.c_void_p
    scalar = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint, "float": ctypes.c_float}
    if c_type in scalar:
        return ctype is scalar[c_type]
    return ctype is getattr(kernels, c_type, None)


def _struct_cases():
    for source in sorted(kernels.SOURCES):
        for name in sorted(structs(source)):
            yield pytest.param(source, name, id=f"{source}-{name}")


@pytest.mark.parametrize("source, name", list(_struct_cases()))
def test_struct_mirrored_field_by_field(source, name):
    c = structs(source)[name]
    mirror = getattr(kernels, name, None)
    assert mirror is not None, f"{source}.cu declares {name}, which kernels does not mirror"
    fields = mirror._fields_
    assert [f[1] for f in c] == [f[0] for f in fields], (name, c, fields)
    for (c_type, field, n), (_, ctype) in zip(c, fields):
        assert _field_matches(c_type, n, ctype), f"{name}.{field}: {c_type} mirrored as {ctype}"


def test_every_mirror_is_a_struct_of_the_sources():
    """Each ``Zrc*`` ctypes class of kernels mirrors a struct of a source,
    and the shaded waves carry the generator whole (``ZrcGen``)."""
    declared = {n for source in kernels.SOURCES for n in structs(source)}
    mirrors = {n for n, v in vars(kernels).items()
               if n.startswith("Zrc") and isinstance(v, type)
               and issubclass(v, ctypes.Structure)}
    assert mirrors == declared, (mirrors, declared)
    for wave in ("ZrcGridWave", "ZrcTraceWave"):
        assert dict(getattr(kernels, wave)._fields_)["gen"] is kernels.ZrcGen
