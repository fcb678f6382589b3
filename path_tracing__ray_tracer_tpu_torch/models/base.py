"""Renderer contract and registry (port of the JAX package's ``models/base.py``).

Every renderer implements ``render() -> PIL.Image`` plus
``get_capabilities()`` and registers itself under a string key at import
time (reference ``renderers/base_renderer.py:7-51``).  The port registers the
reference's ``cuda_*`` names as canonical and the JAX package's ``tpu_*``
names as aliases.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Type

from ..core.camera import Camera
from ..core.scene import RenderSettings, Scene


class BaseRenderer(ABC):
    """One render mode: owns its physics variant and its scene-compilation
    conventions."""

    def __init__(self, name: str):
        self.name = name

    # -- contract -------------------------------------------------------------
    @abstractmethod
    def render(self, scene: Scene, camera: Camera, settings: RenderSettings):
        """Render the scene and return a ``PIL.Image`` (top-down rows)."""

    @abstractmethod
    def get_capabilities(self) -> List[str]:
        """Feature strings this renderer supports."""

    # -- conveniences -----------------------------------------------------------
    def get_name(self) -> str:
        return self.name

    def supports(self, feature: str) -> bool:
        return feature in self.get_capabilities()

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "capabilities": self.get_capabilities()}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"


class RendererFactory:
    """String-keyed registry; renderer modules self-register when imported."""

    _renderers: Dict[str, Type[BaseRenderer]] = {}
    _aliases: Dict[str, str] = {}

    @classmethod
    def register(cls, name: str, renderer_class: Type[BaseRenderer]) -> None:
        cls._renderers[name] = renderer_class

    @classmethod
    def register_alias(cls, alias: str, target: str) -> None:
        cls._aliases[alias] = target

    @classmethod
    def resolve(cls, name: str) -> str:
        """Canonical renderer name for ``name`` (aliases followed once)."""
        return cls._aliases.get(name, name)

    @classmethod
    def create(cls, name: str, **kwargs) -> BaseRenderer:
        canonical = cls.resolve(name)
        try:
            renderer_class = cls._renderers[canonical]
        except KeyError:
            raise ValueError(f"Unknown renderer: {name}") from None
        return renderer_class(**kwargs)

    @classmethod
    def list_available(cls) -> List[str]:
        """Every accepted name — canonical renderers first, then aliases."""
        return [*cls._renderers, *cls._aliases]
