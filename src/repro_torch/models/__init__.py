"""The transformer of the dense and MoE families (``Model``)."""
from .transformer import Model

__all__ = ["Model"]
