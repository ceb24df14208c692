"""Estimators, the block-IVF index, decode plans and the backend registry."""
