"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  A CUDA
device that is not there raises; nothing moves to the CPU on its own — the
CPU runs only when the caller asks for it (as the tests do).  The one
exception is a trace on fake tensors (``FakeTensorMode``, the dry run's
``launch/dryrun.py``): it allocates nothing and launches nothing, so it may
name ``cuda`` where no card is present.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch-mode stack."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not fake_mode_active():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
