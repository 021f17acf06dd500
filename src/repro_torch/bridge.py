"""Carry weights across from numpy into the port's tensors.

``params_from_numpy`` takes a params tree as nested dicts of numpy arrays —
the JAX package's trees after ``np.asarray`` on every leaf — and returns the
same tree of torch tensors on ``device``.  A compressed leaf travels as a
dict ``{"mags", "signs", "scale", "meta"}`` (``meta`` holding ``k``, ``m``
and the other static fields of ``FormsLinearParams``) and comes out as a
:class:`~repro_torch.forms.linear.FormsLinearParams`;
``forms_leaf_from_numpy`` converts one such leaf.  ``train_state_from_numpy``
carries a whole training state across (params, AdamW moments, ADMM
variables, the error-feedback buffer), so both packages can take the next
step from one state.  The bridge sees numpy only: converting the
reference's arrays is the caller's step.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core.admm import AdmmLayerState
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.forms.linear import FormsLinearParams
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState

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


_ADMM_FIELDS = ("z", "u", "signs", "row_mask", "col_mask", "scale")


def train_state_from_numpy(state: Mapping[str, Any],
                           device: Union[str, torch.device] = DEFAULT_DEVICE):
    """A :class:`~repro_torch.training.train_loop.TrainState` from numpy.

    ``state`` holds ``params`` (a numpy tree), ``opt`` (``step``, ``mu``,
    ``nu`` and, for int8 moments, ``mu_scale``/``nu_scale`` trees; the
    codes stay int8), ``step``, ``admm`` (None or ``{path: {z, u, signs,
    row_mask, col_mask, scale}}``, any of the last four None), ``grad_err``
    (None or a tree) and ``seed``, which seeds the generator of the int8
    compression noise (the reference's PRNG key has no torch counterpart).
    """
    dev = resolve_device(device)
    conv = lambda t: None if t is None else params_from_numpy(t, dev)  # noqa: E731
    o = state["opt"]
    opt = AdamWState(step=_tensor(np.asarray(o["step"], np.int32), dev), mu=conv(o["mu"]),
                     nu=conv(o["nu"]), mu_scale=conv(o.get("mu_scale")),
                     nu_scale=conv(o.get("nu_scale")))
    admm: Optional[Dict[str, AdmmLayerState]] = None
    if state.get("admm") is not None:
        admm = {path: AdmmLayerState(**{f: conv(leaf.get(f)) for f in _ADMM_FIELDS})
                for path, leaf in state["admm"].items()}
    rng = torch.Generator(device=dev)
    rng.manual_seed(int(state.get("seed", 0)))
    return TrainState(params=params_from_numpy(state["params"], dev), opt=opt,
                      step=_tensor(np.asarray(state["step"], np.int32), dev), admm=admm,
                      grad_err=conv(state.get("grad_err")), rng=rng)
