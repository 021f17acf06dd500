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


@pytest.mark.parametrize("M,K,N,levels", [(1, 1536, 1536, 256), (4, 1536, 256, 256),
                                          (4, 1536, 8960, 256), (4, 8960, 1536, 256),
                                          (4, 1536, 1536, 1024), (7, 1544, 250, 256),
                                          (7, 8960, 1536, 256)])
@pytest.mark.gpu
@needs_card
def test_f32_kernel_takes_bf16_x_in_one_launch_with_the_widened_bits(M, K, N, levels):
    """Below TC_MIN_ROWS, bf16 x goes straight into the f32 kernel: one
    launch and no widening copy (the profiler sees one kernel launch per
    call), its result equal bit for bit to the f32 launch on x.float(), two
    launches equal, and the skip launch on half-dead x equal to the dense
    one."""
    from torch.profiler import ProfilerActivity, profile

    assert M < pm.TC_MIN_ROWS
    dev = torch.device("cuda")
    x, mags, signs, scale = [t.to(dev) for t in _torch(*_mk(11, M, K, N, 8, levels))]
    x[:, 256:512] = 0.0
    xb = x.to(torch.bfloat16)
    got = pm.polarized_matmul(xb, mags, signs, scale, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        before = pm.polarized_matmul.launches
        again = pm.polarized_matmul(xb, mags, signs, scale, 8)
        torch.cuda.synchronize()
    assert pm.polarized_matmul.launches == before + 1
    assert sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel") == 1
    assert torch.equal(got, again)
    assert torch.equal(got, pm.polarized_matmul(xb.float(), mags, signs, scale, 8))
    assert torch.equal(pm.polarized_matmul_skip(xb, mags, signs, scale, 8), got)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = ref.ref_polarized_matmul_fast(xb, mags, signs, scale, 8)
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


def _split(cfg, prefills, steps, slots):
    """Launches of the [f32, tensor-core] kernels for a bf16 dense model's
    prefills (M = bucket, 8 here) and decode steps (M = slots), by the
    route at each of a layer's 7 projections (q, k, v, o, gate, up, down)."""
    hd = cfg.head_dim
    cols = [cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd, cfg.d_model,
            cfg.d_ff, cfg.d_ff, cfg.d_model]
    out = [0, 0]
    for calls, M in ((prefills, 8), (steps, slots)):
        for N in cols:
            out[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", M, N)] += (
                cfg.num_layers * calls)
    return out


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
    kernels = (pm.polarized_matmul, pm.polarized_matmul_tc)
    before = [k.launches for k in kernels]
    results = eng.run(reqs)
    steps = eng.stats()["rounds"] * eng.decode_block
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert launched == _split(cfg, len(results), steps, eng.slots)
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


@pytest.mark.parametrize("M,K,N,m", [(16, 1536, 256, 8), (64, 1536, 1536, 8),
                                     (67, 264, 1030, 8), (256, 1536, 256, 16),
                                     (20, 774, 40, 3)])
@pytest.mark.gpu
@needs_card
def test_tensor_core_kernel_matches_plain(M, K, N, m):
    """bf16 x at M >= TC_MIN_ROWS takes the tensor-core kernel: within 1e-4
    of the plain version (the products are exact in bf16), two launches
    equal bit for bit."""
    dev = torch.device("cuda")
    x, mags, signs, scale = [t.to(dev) for t in _torch(*_mk(9, M, K, N, m))]
    x = x.to(torch.bfloat16)
    before = (pm.polarized_matmul.launches, pm.polarized_matmul_tc.launches)
    got = pm.polarized_matmul(x, mags, signs, scale, m)
    again = pm.polarized_matmul(x, mags, signs, scale, m)
    torch.cuda.synchronize()
    assert (pm.polarized_matmul.launches, pm.polarized_matmul_tc.launches) == (
        before[0], before[1] + 2)
    assert torch.equal(got, again)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = ref.ref_polarized_matmul_fast(x, mags, signs, scale, m)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
@pytest.mark.gpu
@needs_card
def test_tensor_core_skip_equals_dense(frac):
    """The tensor-core kernel's mask (64-row tiles): with whole K slices of
    x zero, the skip launch equals the dense one bit for bit."""
    dev = torch.device("cuda")
    M, K, N = 64, 8960, 1536
    x, mags, signs, scale = [t.to(dev) for t in _torch(*_mk(10, M, K, N, 8))]
    x = x.to(torch.bfloat16)
    S = -(-K // pm._KC)
    for k in ([] if frac == 0 else range(S) if frac == 1 else range(1, S, 2)):
        x[:, k * pm._KC:(k + 1) * pm._KC] = 0
    mask = pm.tile_mask(x, mags.dtype, N)
    assert tuple(mask.shape) == (1, S)
    before = pm.polarized_matmul_tc_skip.launches
    skip = pm.polarized_matmul_skip(x, mags, signs, scale, 8, mask=mask)
    dense = pm.polarized_matmul(x, mags, signs, scale, 8)
    torch.cuda.synchronize()
    assert pm.polarized_matmul_tc_skip.launches == before + 1
    assert torch.equal(skip, dense)


def _dead_tiles(x, frac):
    """Zero the first ``frac`` of the kernel's (row tile, K slice) tiles of x."""
    M, K = x.shape
    bm, kc = pm.tile_rows(M), pm._KC
    tiles = [(i, k) for i in range(-(-M // bm)) for k in range(-(-K // kc))]
    for i, k in tiles[:int(round(frac * len(tiles)))]:
        x[i * bm:(i + 1) * bm, k * kc:(k + 1) * kc] = 0.0
    return x


@pytest.mark.parametrize("M,K,N", [(4, 1536, 1536), (4, 8960, 1536), (64, 1536, 256),
                                   (7, 1544, 250)])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
@pytest.mark.gpu
@needs_card
def test_skip_kernel_equals_dense_kernel(M, K, N, frac):
    """The block-skip launch equals the dense launch bit for bit, whatever
    share of the tiles is dead, and counts as a skip-kernel launch."""
    dev = torch.device("cuda")
    x, mags, signs, scale = _mk(9, M, K, N, 8)
    x, mags, signs, scale = [t.to(dev) for t in _torch(_dead_tiles(x, frac), mags, signs, scale)]
    dense = pm.polarized_matmul(x, mags, signs, scale, 8)
    before = pm.polarized_matmul_skip.launches
    skip = pm.polarized_matmul_skip(x, mags, signs, scale, 8)
    torch.cuda.synchronize()
    assert pm.polarized_matmul_skip.launches == before + 1
    assert torch.equal(skip, dense)


@pytest.mark.parametrize("M,dead", [(1, 0.8), (4, 0.8), (4, 0.0)])
@pytest.mark.gpu
@needs_card
def test_compact_on_the_card_never_syncs(M, dead):
    """Fragment compaction on the card, where it engages (80% of the
    fragments dead in every row) and where it falls back (dense x): the
    result matches the plain version, the call never waits on the card, and
    its bits are those of the launch the device flag chose (the gathered
    product sums in another order than the full one)."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    K, N, m = 8960, 1536, 8
    x, mags, signs, scale = _mk(10, M, K, N, m)
    rng = np.random.RandomState(11)
    x = x * np.repeat(rng.rand(1, K // m) >= dead, m, axis=1).astype(np.float32)
    x, mags, signs, scale = [t.to(dev) for t in _torch(x, mags, signs, scale)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.polarized_matmul(x, mags, signs, scale, m=m, zero_skip="compact",
                                   zero_skip_keep=0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = ref.ref_polarized_matmul_fast(x, mags, signs, scale, m)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    xg, mg, sg, n_live, keep = ops.gather_live_fragments(x, mags, signs, m, 0.5)
    gathered = pm.polarized_matmul(xg, mg, sg, scale, m)
    full = pm.polarized_matmul(x, mags, signs, scale, m)
    chosen, other = (gathered, full) if dead else (full, gathered)
    assert (int(n_live) <= keep) == bool(dead)
    assert torch.equal(got, chosen) and not torch.equal(got, other)


def _bitserial_case(*values, id=None):
    return pytest.param(*values, id=id or "-".join(map(str, values[:6])))


@pytest.mark.parametrize("M,K,N,m,input_bits,adc_bits,cells_of", [
    _bitserial_case(4, 1536, 1536, 8, 16, None, "codes"),
    _bitserial_case(4, 8960, 256, 8, 16, 4, "codes"),
    _bitserial_case(5, 200, 70, 4, 8, 3, "codes"),
    _bitserial_case(3, 512, 64, 16, 12, None, "codes"),
    _bitserial_case(4, 1520, 256, 40, 16, None, "codes", id="m40"),
    _bitserial_case(4, 1520, 256, 40, 16, 4, "codes", id="m40-clipped"),
    _bitserial_case(4, 1536, 256, 8, 16, 7, "wide", id="cells-past-cell-bits"),
    _bitserial_case(4, 1536, 256, 8, 16, 5, "20bits", id="20-weight-bits"),
    _bitserial_case(64, 1536, 8960, 8, 16, None, "codes", id="M64-1536x8960"),
])
@pytest.mark.gpu
@needs_card
def test_bitserial_kernel_equals_plain(M, K, N, m, input_bits, adc_bits, cells_of):
    """acc and eic equal the plain version exactly, including results that
    wrap int32; with an ideal ADC and 2-bit cells of the codes acc is the
    exact integer product.  Also m = 40 (a fragment over two k32 chunks),
    cells past 2^cell_bits - 1 (read whole) and 5 cells of 4 bits."""
    from repro_torch.core.zeroskip import fragment_eic
    from repro_torch.kernels import bitserial_crossbar as bx

    dev = torch.device("cuda")
    rng = np.random.RandomState(12)
    x = rng.randint(0, 2 ** input_bits, (M, K)).astype(np.float32)
    x[:, :m] = 0.0
    mcodes = rng.randint(0, 256, (K, N)).astype(np.int32)
    cell_bits = 2
    if cells_of == "codes":
        cells = np.stack([(mcodes >> (2 * c)) & 3 for c in range(4)])
    elif cells_of == "wide":
        cells = rng.randint(0, 256, (4, K, N)).astype(np.int32)
    else:
        cell_bits = 4
        cells = rng.randint(0, 16, (5, K, N)).astype(np.int32)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int8)
    tx, tm, tc, ts = [t.to(dev) for t in _torch(x, mcodes, cells.astype(np.uint8), signs)]
    before = bx.bitserial_crossbar.launches
    acc, eic = bx.bitserial_crossbar(tx, tc, ts, m=m, input_bits=input_bits,
                                     cell_bits=cell_bits, adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert bx.bitserial_crossbar.launches == before + 1
    want, _ = ref.ref_bitserial_crossbar(tx, tc, ts, m, input_bits, cell_bits,
                                         adc_bits=adc_bits)
    assert torch.equal(acc, want)
    assert torch.equal(eic, fragment_eic(tx, m, input_bits))
    if adc_bits is None and cells_of == "codes":
        assert torch.equal(acc, ref.ref_exact_int_matmul(tx, tm, ts, m))


@pytest.mark.gpu
@needs_card
def test_bitserial_kernel_refuses_cells_that_are_not_uint8():
    """The kernel reads uint8 cells: a plane of a wider dtype is refused on
    the card, not cut to its low byte."""
    from repro_torch.kernels import bitserial_crossbar as bx

    dev = torch.device("cuda")
    x = torch.ones((2, 16), dtype=torch.int32, device=dev)
    cells = torch.ones((4, 16, 8), dtype=torch.uint8, device=dev)
    signs = torch.ones((2, 8), dtype=torch.int8, device=dev)
    bx.bitserial_crossbar(x, cells, signs, m=8, input_bits=4)
    with pytest.raises(ValueError, match="uint8 cells"):
        bx.bitserial_crossbar(x, cells.to(torch.int32), signs, m=8, input_bits=4)


@pytest.mark.gpu
@needs_card
def test_engine_block_skip_tokens_equal_dense_on_the_card():
    """A reduced qwen2 with ReLU and 50% fragment sparsity served on the
    card: zero_skip="block" gives the dense engine's tokens and runs every
    projection through the skip kernel."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.forms import FormsSpec
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), mlp_act="relu", act_sparsity=0.5,
                              act_fragment=8)
    model = build(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, 5) for _ in range(3)]
    tokens = {}
    for mode in ("off", "block"):
        eng = ServingEngine(model, params, spec=FormsSpec(), zero_skip=mode, max_len=32,
                            batch_slots=2, page_size=8, decode_block=2, device="cuda")
        skip_kernels = (pm.polarized_matmul_skip, pm.polarized_matmul_tc_skip)
        before = [k.launches for k in skip_kernels]
        res = eng.run([Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
        tokens[mode] = {r.uid: r.tokens for r in res}
        steps = eng.stats()["rounds"] * eng.decode_block
        skips = [k.launches - b for k, b in zip(skip_kernels, before)]
        want = _split(cfg, len(res), steps, eng.slots)
        assert skips == (want if mode == "block" else [0, 0])
    assert tokens["block"] == tokens["off"]


@pytest.mark.gpu
@needs_card
def test_speculative_engine_on_the_card_equals_the_cpu():
    """A reduced f32 qwen2 (FORMS target, 4-bit FORMS draft) served
    speculatively on the card and on the CPU from the same tree: the same
    greedy tokens and acceptance, and the f32 kernel launched 7 x layers
    times per model call: two prefills per admission, kk + 1 draft calls
    and one verify per round of width kk."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.forms import FormsLinearParams, FormsSpec, compress_tree
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, FormsLinearParams):
            return dataclasses.replace(tree, mags=tree.mags.to(dev), signs=tree.signs.to(dev),
                                       scale=tree.scale.to(dev))
        return tree.to(dev)

    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), dtype="float32")
    tree, _ = compress_tree(build(cfg, device="cpu").init(0), FormsSpec(m=8, bits=8))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(3, 12)) for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(build(cfg, device=dev), to(tree, dev), spec=FormsSpec(m=8, bits=8),
                            speculate=True, draft_k=3, draft_bits=4, max_len=32,
                            batch_slots=2, page_size=8, device=dev)
        before = pm.polarized_matmul.launches
        res = eng.run([Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)])
        calls = 2 * len(res) + sum(kk + 2 for kk in eng.runner.round_widths)
        out[dev] = ({r.uid: r.tokens for r in res}, eng.stats()["speculate"],
                    pm.polarized_matmul.launches - before, 7 * cfg.num_layers * calls)
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == out["cuda"][3]


def _polarize_input(seed, shape, m):
    """Random values with the edge cases planted in every layer: a fragment
    summing to exactly 0, one of -0.0 entries, one holding a NaN."""
    v = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    for layer in v.reshape(-1, *shape[-2:]):
        layer[:m, 0] = np.tile([0.5, -0.5], m)[:m] if m % 2 == 0 else 0.0
        layer[:m, 1] = -0.0
        layer[m + 1, 2] = np.nan
    return torch.from_numpy(v)


@pytest.mark.parametrize("shape,m", [((3, 64, 300), 4), ((2, 1536, 256), 8),
                                     ((1536, 8960), 8), ((2, 96, 40), 16), ((2, 40, 33), 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.gpu
@needs_card
def test_polarize_kernel_equals_plain_bit_for_bit(shape, m, dtype):
    """Kernel #4 on the card: one launch per (stacked) leaf, outputs and
    signs equal to the plain version bit for bit, for both rules."""
    from repro_torch.kernels import admm_polarize as kpol

    v = _polarize_input(3, shape, m).to("cuda", dtype)
    for rule in ("sum", "energy"):
        before = kpol.admm_polarize.launches
        out, signs = kpol.admm_polarize(v, m=m, rule=rule)
        torch.cuda.synchronize()
        assert kpol.admm_polarize.launches == before + 1
        want, want_s = ref.ref_admm_polarize(v, m, rule)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(bits), want.view(bits))
        assert torch.equal(signs, want_s)


@pytest.mark.gpu
@needs_card
def test_polarize_wrapper_raises_instead_of_falling_back():
    from repro_torch.kernels import admm_polarize as kpol

    v = torch.randn(16, 8, device="cuda")
    with pytest.raises(TypeError):
        kpol.admm_polarize(v.double(), m=8, rule="sum")
    with pytest.raises(ValueError, match="contiguous"):
        kpol.admm_polarize(v.t(), m=4, rule="sum")


@pytest.mark.parametrize("slots,route", [(1, "f32"), (2, "tc")])
@pytest.mark.gpu
@needs_card
def test_prefill_chunk_on_both_routes_matches_plain(slots, route):
    """A (slots, 8) chunk of a bf16 FORMS model: M = slots x 8 takes the f32
    kernel at 8 rows and the tensor-core kernel at 16; the chunk's logits
    agree with the CPU's plain versions on the same codes, and its token is
    the one ``prefill_chunk`` samples."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.forms import FormsLinearParams, FormsSpec, compress_tree, default_spec
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, FormsLinearParams):
            return dataclasses.replace(tree, mags=tree.mags.to(dev), signs=tree.signs.to(dev),
                                       scale=tree.scale.to(dev))
        return tree.to(dev)

    cfg = get_reduced("qwen2-1.5b")
    spec = FormsSpec(m=8, bits=8)
    tree, _ = compress_tree(build(cfg, device="cpu").init(0), spec)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (slots, 8)).astype(np.int32)
    pos = np.zeros(slots, np.int32)
    tables = np.arange(1, slots * 4 + 1, dtype=np.int32).reshape(slots, 4)
    cols = np.full(slots, 7, np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(build(cfg, device=dev), to(tree, dev), spec=spec, max_len=32,
                            batch_slots=slots, page_size=8, slo={"prefill_chunk": 8},
                            device=dev)
        r = eng.runner
        kernels = (pm.polarized_matmul, pm.polarized_matmul_tc)
        before = [k.launches for k in kernels]
        with torch.inference_mode(), default_spec(spec):
            logits, _ = r.model.decode_paged(r.params, torch.tensor(toks, device=dev),
                                             r.model.init_paged_cache(slots * 4 + 1, 8),
                                             torch.tensor(pos, device=dev),
                                             torch.tensor(tables, device=dev))
        launched = [k.launches - b for k, b in zip(kernels, before)]
        tok = r.prefill_chunk(toks, pos, tables, cols, np.zeros(slots, np.float32))
        out[dev] = (logits[:, -1].float().cpu(), tok, launched)
    per_call = 7 * cfg.num_layers
    assert out["cuda"][2] == ([per_call, 0] if route == "f32" else [0, per_call])
    assert out["cpu"][2] == [0, 0]
    card, cpu = out["cuda"][0], out["cpu"][0]
    assert float((card - cpu).abs().max()) <= 3e-2 * float(cpu.abs().max())
    assert list(out["cuda"][1]) == card.argmax(-1).tolist()
    assert eng.runner.chunk_widths == [8]


@pytest.mark.gpu
@needs_card
def test_checkpoint_restores_onto_the_card(tmp_path):
    """A compressed tree and a train state saved from the CPU restore onto
    ``cuda`` bit for bit (the generator as a CUDA generator), and the
    restored tree serves the tokens of the same tree moved to the card."""
    import dataclasses
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.forms import FormsSpec, compress_tree, spec_from_meta
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.training import train_loop

    cfg = get_reduced("qwen2-1.5b")
    spec = FormsSpec(m=8, bits=8)
    tree, _ = compress_tree(build(cfg, device="cpu").init(0), spec)
    ckpt.save(str(tmp_path / "serve"), tree, step=1, extra_meta=dataclasses.asdict(spec))
    spec2 = spec_from_meta(ckpt.read_meta(str(tmp_path / "serve"))["extra"])
    model = build(cfg, device="cuda")
    template, _ = compress_tree(model.init(1), spec2)
    got, _ = ckpt.restore(str(tmp_path / "serve"), template, device="cuda")
    leaves = ckpt.tree_leaves(got)
    assert all(x.is_cuda for x in leaves)
    for a, b in zip(leaves, ckpt.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    moved, _ = ckpt.restore(str(tmp_path / "serve"), template)
    reqs = [Request(uid=i, prompt=np.arange(3 + i, 9 + i), max_new_tokens=6) for i in range(2)]
    run = lambda t: {r.uid: r.tokens for r in ServingEngine(  # noqa: E731
        model, t, spec=spec2, max_len=32, batch_slots=2, page_size=8, device="cuda").run(reqs)}
    assert run(got) == run(moved)

    tcfg = TrainConfig(moment_dtype="bfloat16", admm_enabled=True, admm_update_every=2)
    state, table = train_loop.init_train_state(build(cfg, device="cpu"), tcfg)
    state = train_loop.maybe_admm_update(state, table, tcfg, 2)
    ckpt.save(str(tmp_path / "train"), state, step=2)
    fresh, _ = train_loop.init_train_state(model, tcfg, seed=3)
    back, step = ckpt.restore(str(tmp_path / "train"),
                              train_loop.restore_template(fresh, table, tcfg, 2))
    assert step == 2 and back.rng.device.type == "cuda"
    assert back.rng.initial_seed() == state.rng.initial_seed()
    for a, b in zip(ckpt.tree_leaves(back), ckpt.tree_leaves(state)):
        if isinstance(a, torch.Tensor):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)
