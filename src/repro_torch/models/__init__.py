"""The transformer of every ported family (``Model``) and the decode-state
tree helpers."""
from .transformer import Model, tree_leaves, tree_paths

__all__ = ["Model", "tree_leaves", "tree_paths"]
