"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package, ``msgpack`` or
``ml_dtypes``, and its entry points run on the card unless the caller asks
for the CPU."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving.engine import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 15
    bad = [(str(p.relative_to(ROOT)), mod) for p in PORT_FILES for mod in _imported_modules(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert bad == []


def test_port_imports_neither_msgpack_nor_ml_dtypes():
    """The card's machine has neither: the checkpoint codec is the port's own."""
    bad = [(str(p.relative_to(ROOT)), mod) for p in PORT_FILES for mod in _imported_modules(p)
           if mod.split(".")[0] in ("msgpack", "ml_dtypes")]
    assert bad == []
    assert ROOT / "src" / "repro_torch" / "checkpoint" / "manager.py" in PORT_FILES


def test_no_kernel_toolchain_is_touched_at_import():
    """Importing the port compiles nothing: triton and the build run only
    inside a call that launches a kernel."""
    for path in PORT_FILES:
        mods = set(_imported_modules(path))
        assert "triton" not in mods, path
        tree = ast.parse(path.read_text())
        top_calls = [n for n in tree.body if isinstance(n, ast.Expr)
                     and isinstance(n.value, ast.Call)]
        assert not top_calls or path.name == "chip_smoke.py", path


def test_cuda_is_the_default_and_never_silently_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    model = registry.build(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, params, max_len=32, batch_slots=2, page_size=8)
    assert ServingEngine(model, params, max_len=32, batch_slots=2, page_size=8,
                         device="cpu").device.type == "cpu"


def test_other_families_name_their_roadmap_item():
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.build(cfg, device="cpu")
