"""Serving: the engine and its generation loop."""
from .engine import Engine, ServeState, generate

__all__ = ["Engine", "ServeState", "generate"]
