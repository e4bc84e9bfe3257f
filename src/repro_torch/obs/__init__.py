"""Telemetry hooks of the port (the rest of ``repro.obs`` comes later)."""
from .metrics import (MetricsBuffer, install_buffer, record_metrics,
                      update_ratio)

__all__ = ["MetricsBuffer", "install_buffer", "record_metrics",
           "update_ratio"]
