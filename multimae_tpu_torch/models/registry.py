"""Model registry: a global name -> factory table (counterpart of
multimae_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict

_ENTRYPOINTS: Dict[str, Callable[..., Any]] = {}


def register_model(fn: Callable[..., Any]) -> Callable[..., Any]:
    _ENTRYPOINTS[fn.__name__] = fn
    return fn


def list_models() -> list[str]:
    return sorted(_ENTRYPOINTS)


def create_model(name: str, **kwargs: Any) -> Any:
    """Instantiate a registered model configuration by name."""
    if name not in _ENTRYPOINTS:
        raise RuntimeError(f"Unknown model: {name}. Known: {list_models()}")
    return _ENTRYPOINTS[name](**kwargs)
