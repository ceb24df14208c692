"""Dense transformer decode path."""
from .transformer import Model

__all__ = ["Model"]
