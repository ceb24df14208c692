"""Observability: the device-resident serving metrics (``metrics``)."""
