"""The program's params tree, drawn on the device from the seed: every
leaf of the configuration's reference layout, one draw per leaf and layer
(``reference.<family>.initial_params``), so the reference can draw any
layer again by itself."""
from __future__ import annotations

from typing import Any, Dict


def program_params(ref, cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Dense float32 params in the program's nested layout (stacked
    ``(L, ...)`` block leaves)."""
    tree: Dict[str, Any] = {}
    for path, t in ref.initial_params(cfg, seed, device).items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree
