"""Component registry: name -> instance, with the lifecycle hooks.

Port of `rag_inference_pipeline_tpu/core/registry.py:1-112`: `register`
calls `load()` at once (unless `load=False`); aliases resolve to a
registered name (the same errors on a collision or a missing target);
`start_all` starts in registration order, `stop_all` and `unload_all` go
in reverse order and log and swallow a failure; `health()` maps each name
to its `is_loaded`.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class Component:
    """Optional base class; duck typing is enough to register."""

    def load(self) -> None:  # blocking weight/index load and warm-up
        pass

    def unload(self) -> None:
        pass

    async def start(self) -> None:  # background workers
        pass

    async def stop(self) -> None:
        pass

    @property
    def is_loaded(self) -> bool:
        return True


class ComponentRegistry:
    def __init__(self) -> None:
        self._components: Dict[str, Any] = {}
        self._aliases: Dict[str, str] = {}
        self._order: List[str] = []

    def register(self, name: str, component: Any, *, load: bool = True) -> Any:
        if name in self._components:
            raise ValueError(f"component '{name}' already registered")
        self._components[name] = component
        self._order.append(name)
        if load and hasattr(component, "load"):
            logger.info("loading component %s (%s)", name, type(component).__name__)
            component.load()
        return component

    def alias(self, alias: str, target: str) -> None:
        if alias in self._components or alias in self._aliases:
            raise ValueError(f"alias '{alias}' collides with existing name")
        if target not in self._components:
            raise KeyError(f"alias target '{target}' not registered")
        self._aliases[alias] = target

    def get(self, name: str) -> Any:
        name = self._aliases.get(name, name)
        return self._components[name]

    def get_optional(self, name: str) -> Optional[Any]:
        try:
            return self.get(name)
        except KeyError:
            return None

    def __contains__(self, name: str) -> bool:
        return name in self._components or name in self._aliases

    @property
    def names(self) -> List[str]:
        return list(self._order)

    async def start_all(self) -> None:
        for name in self._order:
            comp = self._components[name]
            if hasattr(comp, "start"):
                res = comp.start()
                if inspect.isawaitable(res):
                    await res

    async def stop_all(self) -> None:
        for name in reversed(self._order):
            comp = self._components[name]
            if hasattr(comp, "stop"):
                try:
                    res = comp.stop()
                    if inspect.isawaitable(res):
                        await res
                except Exception:  # noqa: BLE001 — shutdown must not cascade
                    logger.exception("error stopping component %s", name)

    def unload_all(self) -> None:
        for name in reversed(self._order):
            comp = self._components[name]
            if hasattr(comp, "unload"):
                try:
                    comp.unload()
                except Exception:  # noqa: BLE001
                    logger.exception("error unloading component %s", name)

    def health(self) -> dict[str, bool]:
        """Each component's readiness, in registration order."""
        return {
            name: bool(getattr(self._components[name], "is_loaded", True))
            for name in self._order
        }
