"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package, ``msgpack`` or
``ml_dtypes``, and its entry points run on the card unless the caller asks
for the CPU."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from repro_torch.configs import ARCH_NAMES, MLAConfig, get_reduced
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


@pytest.mark.parametrize("module", ["core/crossbar.py", "core/perfmodel.py", "forms/autobits.py",
                                    "configs/shapes.py", "analysis/roofline.py",
                                    "analysis/opcount.py", "analysis/report.py",
                                    "launch/dryrun.py"])
def test_the_hardware_model_and_autobits_are_the_ports_own(module):
    """The hardware model imports no JAX in the reference either, nor do
    the dry run's shapes, roofline and report; the port still keeps its own
    copies, autobits takes the hardware model from there, and the dry run
    counts with its own analysis."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    mods = set(_imported_modules(path))
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                                      "ml_dtypes")}
    if module == "forms/autobits.py":
        assert "repro_torch.core" in mods and "torch.utils.flop_counter" in mods
    if module == "launch/dryrun.py":
        assert "repro_torch.analysis" in mods and "torch.utils.flop_counter" in mods


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
    """Every family of the JAX package is ported, so ``registry.build``
    refuses none of its archs (there is no ROADMAP item left to name): the
    recurrent families build without a paged path, and the VLM prefix
    (phi-3-vision) builds with ``("tokens", "patch_embeds")``, whose
    ``make_inputs(g, 2, 16)`` gives 8 text tokens after 8 patch positions."""
    assert not hasattr(registry, "_NOT_PORTED")
    for arch in ARCH_NAMES:
        assert registry.build(get_reduced(arch), device="cpu").config.name.startswith(arch)
    for arch in ("xlstm-350m", "zamba2-2.7b"):
        model = registry.build(get_reduced(arch), device="cpu")
        assert not model.padded_prefill and not model.supports_paged
        assert model.init_paged_cache is None and model.decode_paged is None
    vlm = registry.build(get_reduced("phi-3-vision-4.2b"), device="cpu")
    assert vlm.input_fields == ("tokens", "patch_embeds") and vlm.supports_paged
    g = torch.Generator()
    g.manual_seed(0)
    batch = vlm.make_inputs(g, 2, 16)
    assert batch["tokens"].shape == (2, 8) and batch["tokens"].dtype == torch.int32
    assert batch["patch_embeds"].shape == (2, 8, 64)
    assert batch["patch_embeds"].dtype == torch.float32
    mla = dataclasses.replace(get_reduced("olmoe-1b-7b"), mla=MLAConfig())
    assert registry.build(mla, device="cpu").padded_prefill is False
    assert registry.build(get_reduced("olmoe-1b-7b"), device="cpu").padded_prefill is False
    whisper = registry.build(get_reduced("whisper-small"), device="cpu")
    assert whisper.input_fields == ("frames", "tokens") and whisper.padded_prefill


@pytest.mark.parametrize("module", ["reliability/encoding.py", "reliability/faults.py",
                                    "reliability/health.py", "models/moe.py",
                                    "configs/olmoe_1b_7b.py", "models/whisper.py",
                                    "configs/deepseek_v3_671b.py",
                                    "configs/whisper_small.py", "models/ssm_common.py",
                                    "models/xlstm.py", "models/zamba.py",
                                    "configs/xlstm_350m.py", "configs/zamba2_2_7b.py",
                                    "models/cnn.py", "configs/paper_cnns.py",
                                    "launch/cnn_pipeline.py",
                                    "configs/phi_3_vision_4_2b.py"])
def test_reliability_and_moe_are_the_ports_own(module):
    """The fault injector is host numpy in the reference too; the port keeps
    its own copy and draws from numpy, never from JAX."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    mods = set(_imported_modules(path))
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                                      "ml_dtypes")}
    if module.startswith("reliability/") and module != "reliability/health.py":
        assert "numpy" in mods


@pytest.mark.parametrize("module", ["distributed/__init__.py", "distributed/context.py",
                                    "distributed/sharding.py", "distributed/moe_dispatch.py",
                                    "launch/mesh.py", "launch/train.py",
                                    "training/train_loop.py", "training/optimizer.py",
                                    "training/grad_compress.py", "core/admm.py",
                                    "checkpoint/manager.py"])
def test_the_mesh_modules_are_the_ports_own(module):
    """The mesh modules and the sharded training path (the launcher, the
    train step, the optimizer, the compression, ADMM, checkpoints) import
    neither JAX nor the JAX package: the rule table, the scanned prefixes,
    the FSDP threshold and ``MeshConfig`` are the port's own copies."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    mods = set(_imported_modules(path))
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                                      "ml_dtypes")}


def test_mesh_entry_points_default_to_cuda(monkeypatch):
    """make_mesh and single_device_mesh default to a cuda mesh and refuse
    without CUDA rather than falling back to gloo on the CPU; a CPU world
    larger than allowed is refused, never shrunk; an engine on a mesh of
    another device type is refused."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA, which is not available"):
        M.make_mesh(MeshConfig(data=1, model=1))
    with pytest.raises(RuntimeError, match="CUDA, which is not available"):
        M.single_device_mesh()
    with pytest.raises(ValueError, match="more than the 2 processes"):
        M.spawn_cpu_world(4, print, max_procs=2)
    with pytest.raises(RuntimeError, match="needs 4 processes"):
        M.make_mesh(MeshConfig(data=2, model=2), device="cpu")
