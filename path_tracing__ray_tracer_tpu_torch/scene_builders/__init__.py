"""Scene construction (parity with the reference ``scene_builders/``)."""

from .custom_scene_builder import CustomSceneBuilder  # noqa: F401
from .mesh_scene_builder import MeshSceneBuilder  # noqa: F401
