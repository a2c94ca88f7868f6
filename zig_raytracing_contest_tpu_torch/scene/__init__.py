from . import camera, geometry, gltf, materials, types  # noqa: F401
