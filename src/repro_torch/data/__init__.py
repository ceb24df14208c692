"""Synthetic data pipeline (numpy; the same batches as the JAX package)."""
from .synthetic import DataIterator, DataState, SyntheticCorpus, zipf_probs

__all__ = ["DataIterator", "DataState", "SyntheticCorpus", "zipf_probs"]
