"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` source has a plain C interface and compiles on its
own into ``build/repro_torch_kernels/<name>-<hash>.so`` under the checkout
(a directory ``.gitignore`` lists).  The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is built at import: the first call that launches a kernel builds it.
Each :func:`build` that compiles is the span ``rt.kernels.build``: its
``sources`` attribute names what it compiled, its ``ptxas`` attribute holds
each built source's compiler report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List

from repro_torch import obs

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def refuse_fake(kernel: str, *ts) -> None:
    """Raise when a kernel's wrapper is reached with fake tensors (a trace
    under ``FakeTensorMode``): the kernel cannot run there, and its plain
    version would stand in for it unseen."""
    from torch._subclasses.fake_tensor import is_fake
    if any(is_fake(t) for t in ts):
        raise RuntimeError(f"{kernel} reached with fake tensors: a kernel of the port "
                           "does not run under FakeTensorMode, and its plain version "
                           "does not stand in for it")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: List[str]) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together; raises with the compiler's output on error."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    ptxas: Dict[str, str] = {}       # each built source's compiler report
    errors = []
    with obs.span("rt.kernels.build", sources=todo, ptxas=ptxas):
        procs = []
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed on {name}.cu:\n{out}")
                continue
            os.replace(tmp, library_path(name))
            ptxas[name] = out
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
