"""Carry weights across from numpy into the port's tensors.

``params_from_numpy`` takes a params tree as nested dicts of numpy arrays —
the JAX package's trees after ``np.asarray`` on every leaf — and returns the
same tree of torch tensors on ``device``.  A compressed leaf travels as a
dict ``{"mags", "signs", "scale", "meta"}`` (``meta`` holding ``k``, ``m``
and the other static fields of ``FormsLinearParams``) and comes out as a
:class:`~repro_torch.forms.linear.FormsLinearParams`;
``forms_leaf_from_numpy`` converts one such leaf.  The bridge sees numpy
only: converting the reference's arrays is the caller's step.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.forms.linear import FormsLinearParams

_FORMS_KEYS = {"mags", "signs", "scale", "meta"}
_META_FIELDS = ("k", "m", "orig_shape", "policy", "out_dtype", "encoding", "bits")


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in numpy form
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def forms_leaf_from_numpy(mags: np.ndarray, signs: np.ndarray, scale: np.ndarray,
                          meta: Mapping[str, Any],
                          device: Union[str, torch.device] = DEFAULT_DEVICE
                          ) -> FormsLinearParams:
    """One compressed leaf from its numpy planes and static fields."""
    dev = resolve_device(device)
    unknown = set(meta) - set(_META_FIELDS)
    if unknown:
        raise ValueError(f"unknown FormsLinearParams fields {sorted(unknown)}")
    kw: Dict[str, Any] = {k: meta[k] for k in _META_FIELDS if k in meta}
    if kw.get("orig_shape") is not None:
        kw["orig_shape"] = tuple(kw["orig_shape"])
    return FormsLinearParams(mags=_tensor(mags, dev), signs=_tensor(signs, dev),
                             scale=_tensor(scale, dev), **kw)


def params_from_numpy(tree: Any, device: Union[str, torch.device] = DEFAULT_DEVICE) -> Any:
    """A nested dict of numpy arrays (and compressed-leaf dicts) as tensors."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        if set(tree) == _FORMS_KEYS:
            return forms_leaf_from_numpy(tree["mags"], tree["signs"], tree["scale"],
                                         tree["meta"], dev)
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)
