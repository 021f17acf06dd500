"""Device meshes for explicit-SPMD serving: one process per device.

``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` with the
reference's axes, ``("data", "model")`` or ``("pod", "data", "model")``,
over NCCL on ``cuda`` and gloo on ``cpu``.  It joins the process group
that is already there (one started by ``torchrun``, whose environment
names the address, the rank and the world size, or by
:func:`spawn_cpu_world`), or makes a world of one.  A mesh larger than
the world, or than the devices present, is refused by name: it never
becomes a smaller mesh or the CPU.

The reference's ``force_host_device_count`` (fake XLA host devices) has no
torch counterpart; :func:`spawn_cpu_world` takes its place: ``n`` gloo
processes on the CPU, which ``serve --fake-devices`` and the tests use.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig

PRODUCTION_SINGLE_POD = MeshConfig(pods=1, data=16, model=16)
PRODUCTION_MULTI_POD = MeshConfig(pods=2, data=16, model=16)


def _axes(cfg: MeshConfig):
    if cfg.pods > 1:
        return (cfg.pods, cfg.data, cfg.model), ("pod", "data", "model")
    return (cfg.data, cfg.model), ("data", "model")


def _join_world(device: str, size: int) -> None:
    """Join (or, alone, start) the default process group on ``device``'s
    backend."""
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs CUDA, which is not available; pass "
                               "device='cpu' for a gloo mesh on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, which this torch lacks")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()!r}; a "
                               f"{device} mesh needs {backend!r}")
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun's environment
        dist.init_process_group(backend)
        return
    if size != 1:
        raise RuntimeError(
            f"a {size}-device mesh needs {size} processes: start them with torchrun "
            f"(or spawn_cpu_world on the CPU); this process is alone")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)


def make_mesh(cfg: MeshConfig, device: str = "cuda") -> Any:
    """A ``DeviceMesh`` of ``cfg``'s shape over the world (the elastic
    scaling entry point).  The world must hold exactly ``cfg.num_devices``
    processes; on ``cuda`` each takes the card of its local rank, and a
    mesh larger than the cards present is refused."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = _axes(cfg)
    _join_world(device, cfg.num_devices)
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise RuntimeError(f"mesh {dict(zip(names, shape))} needs {cfg.num_devices} "
                           f"processes, the world holds {world}")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        n_cards = torch.cuda.device_count()
        if local >= n_cards:
            raise RuntimeError(f"rank {dist.get_rank()} wants card {local}, but only "
                               f"{n_cards} are present (NCCL takes one rank per card)")
        torch.cuda.set_device(local)
    return init_device_mesh(device, shape, mesh_dim_names=names)


def single_device_mesh(device: str = "cuda") -> Any:
    """Trivial ``data=1, model=1`` mesh for tests/examples on one device."""
    return make_mesh(MeshConfig(pods=1, data=1, model=1), device=device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> Any:
    """The assigned production meshes: 16x16 single-pod, 2x16x16 multi-pod
    (256 or 512 ranks); a smaller world is refused by name."""
    cfg = PRODUCTION_MULTI_POD if multi_pod else PRODUCTION_SINGLE_POD
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < cfg.num_devices:
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh needs "
            f"{cfg.num_devices} ranks, the world holds {world}")
    return make_mesh(cfg, device=device)


def parse_mesh_arg(arg: str) -> MeshConfig:
    """Parse a ``--mesh`` CLI value like ``"data=2,model=4"`` into a
    :class:`MeshConfig` (axes default to 1; ``pod=``/``pods=`` accepted)."""
    sizes = {"pods": 1, "data": 1, "model": 1}
    alias = {"pod": "pods", "pods": "pods", "data": "data", "model": "model"}
    for part in arg.split(","):
        if not part.strip():
            continue
        name, sep, value = part.partition("=")
        key = alias.get(name.strip())
        if key is None or not sep or not value.strip().isdigit() \
                or int(value) < 1:
            raise ValueError(
                f"bad --mesh entry {part!r}: expected axis=size with axis "
                f"in {sorted(set(alias))} and size a positive integer "
                f"(e.g. \"data=2,model=4\")")
        sizes[key] = int(value)
    return MeshConfig(**sizes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world_entry(rank: int, n: int, port: int, timeout_s: Optional[float], fn: Callable,
                 args: tuple) -> None:
    import datetime
    torch.set_num_threads(1)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n, **kw)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_world(n: int, fn: Callable, *args: Any, max_procs: Optional[int] = None,
                    timeout_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``n`` processes joined in a gloo world on the
    CPU (rank = process index), and wait for them; a failing rank fails the
    call.  ``fn`` must be importable (a module-level function).  ``n``
    beyond ``max_procs`` (default: the CPU count) is refused, never
    shrunk.  ``timeout_s`` bounds every collective (a rank that failed
    leaves the others waiting no longer than that)."""
    import torch.multiprocessing as mp
    limit = max_procs if max_procs is not None else (os.cpu_count() or 1)
    if n < 1 or n > limit:
        raise ValueError(f"a {n}-process CPU world is more than the {limit} processes "
                         f"this machine is allowed")
    mp.spawn(_world_entry, args=(n, _free_port(), timeout_s, fn, args), nprocs=n, join=True)
