"""Config helpers (port of ``esc_tpu/utils/config.py::read_yaml``)."""

from __future__ import annotations

__all__ = ["read_yaml"]


def read_yaml(path: str) -> dict:
    """Parse a YAML config. PyYAML is imported here, not at module import,
    so the rest of the port runs without it."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)
