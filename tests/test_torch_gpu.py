"""The port's CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one; they import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import polarized_matmul as pm

# decided when the test runs, not at import: every worker collects the same tests
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel runs only on a card")


def _mk(seed, M, K, N, m, levels=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    mags = rng.randint(0, levels, (K, N)).astype(np.uint8 if levels <= 256 else np.int32)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int8)
    scale = np.full((1, N), 0.0123, np.float32)
    return x, mags, signs, scale


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("M,K,N,levels", [(4, 1536, 256, 256), (64, 1536, 1536, 256),
                                          (7, 1544, 250, 256), (4, 512, 128, 1024),
                                          (67, 264, 1030, 256)])
@pytest.mark.gpu
@needs_card
def test_cuda_kernel_matches_plain(M, K, N, levels):
    dev = torch.device("cuda")
    x, mags, signs, scale = [t.to(dev) for t in _torch(*_mk(5, M, K, N, 8, levels))]
    before = pm.polarized_matmul.launches
    got = pm.polarized_matmul(x, mags, signs, scale, 8)
    torch.cuda.synchronize()
    assert pm.polarized_matmul.launches == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    want = ref.ref_polarized_matmul_fast(x, mags, signs, scale, 8)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@needs_card
def test_cuda_wrapper_raises_instead_of_falling_back():
    dev = torch.device("cuda")
    x, mags, signs, scale = [t.to(dev) for t in _torch(*_mk(6, 4, 16, 8, 8))]
    with pytest.raises(TypeError):
        pm.polarized_matmul(x.double(), mags, signs, scale, 8)
    with pytest.raises(ValueError, match="contiguous"):
        pm.polarized_matmul(x, mags.t().contiguous().t(), signs, scale, 8)


@pytest.mark.gpu
@needs_card
def test_engine_on_the_card_goes_through_the_kernel():
    """A reduced qwen2 served on the card: every projection of every model
    call launches the kernel (7 per layer), and the tokens are in range."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_reduced("qwen2-1.5b")
    model = build(cfg, device="cuda")
    eng = ServingEngine(model, model.init(0), forms=True, max_len=32, batch_slots=2,
                        page_size=8, decode_block=2, device="cuda")
    rng = np.random.RandomState(0)
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 5), max_new_tokens=5)
            for i in range(3)]
    before = pm.polarized_matmul.launches
    results = eng.run(reqs)
    calls = len(results) + eng.stats()["rounds"] * eng.decode_block
    assert pm.polarized_matmul.launches - before == 7 * cfg.num_layers * calls
    assert all(len(r.tokens) == 5 and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in results)


@pytest.mark.gpu
@needs_card
def test_cuda_launches_on_two_streams_keep_their_own_tickets():
    """Split-K launches on two streams that may overlap: each stream has its
    own slice tickets, so both results match the plain version."""
    dev = torch.device("cuda")
    ins = [[t.to(dev) for t in _torch(*_mk(seed, 4, 8960, 1536, 8))] for seed in (7, 8)]
    torch.backends.cuda.matmul.allow_tf32 = False
    want = [ref.ref_polarized_matmul_fast(*a, 8) for a in ins]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(pm.polarized_matmul(*ins[i], 8))
    torch.cuda.synchronize()
    for i in range(2):
        for g in got[i]:
            assert float((g - want[i]).abs().max()) <= 1e-4 * float(want[i].abs().max())


@pytest.mark.gpu
@needs_card
def test_forms_leaf_on_the_card_never_bypasses_the_kernel():
    """A FORMS leaf on the card goes to the kernel or raises: a stacked
    leaf is refused by linear(), and wload() does not rebuild it densely."""
    from repro_torch import forms
    from repro_torch.models import layers

    w = torch.randn(2, 16, 8, device="cuda")
    leaf = forms.compress_tree({"mlp": {"up": w}}, forms.FormsSpec())[0]["mlp"]["up"]
    x = torch.randn(3, 16, device="cuda")
    with pytest.raises(ValueError, match="2-D weight"):
        layers.linear({"up": leaf}, "up", x, torch.float32)
    with pytest.raises(NotImplementedError, match="kernel"):
        layers.wload({"up": leaf}, "up", torch.float32)
    before = pm.polarized_matmul.launches
    layers.linear({"up": leaf.layer(0)}, "up", x, torch.float32)
    assert pm.polarized_matmul.launches == before + 1
