"""Canonical parameter-path formatting.

Weights are keyed by the same ``"blocks/attn/wq"``-style path in the port and
in the JAX package, so compression reports and per-leaf plans line up.
"""
from __future__ import annotations


def path_str(path) -> str:
    """Render a sequence of dict keys (or indices) as a ``/``-joined string."""
    return "/".join(str(p) for p in path)
