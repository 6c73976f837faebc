"""Helpers shared by the port: env parsing, paths, device choice."""

from . import env, tree
from .device import resolve_device

__all__ = ["env", "tree", "resolve_device"]
