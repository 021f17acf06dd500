"""The yardstick's arithmetic against hand counts."""
import pytest

from port_bench.harness import yardstick as Y

QWEN2 = dict(num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
             d_ff=8960, vocab_size=151936)
# the 7 projections of one qwen2-1.5b layer: (K, N)
SHAPES = [(1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
          (1536, 8960), (1536, 8960), (8960, 1536)]


@pytest.mark.parametrize("m_rows", [4, 4096])
def test_one_qwen2_layer_of_forms_matmuls(m_rows):
    flops = bytes_ = 0
    for k, n in SHAPES:
        f, b = Y.forms_mm_work(m_rows, k, n, 2, 1, 8)
        flops += f
        bytes_ += b
    params = sum(k * n for k, n in SHAPES)
    assert params == 46_792_704
    assert flops == 2 * m_rows * params
    # codes 1 B each, a sign byte per 8 rows, a f32 scale per column,
    # bf16 x in, f32 y out
    x_in = 2 * m_rows * sum(k for k, _ in SHAPES)
    y_out = 4 * m_rows * sum(n for _, n in SHAPES)
    scales = 4 * sum(n for _, n in SHAPES)
    assert bytes_ == params + params // 8 + scales + x_in + y_out
    # the least time is taken call by call: at M = 4 every call is bound
    # by its bytes; at M = 4096 the wide ones by their operations, the two
    # 256-column ones (k, v) by their bytes
    calls = [Y.forms_mm_work(m_rows, k, n, 2, 1, 8) for k, n in SHAPES]
    t = sum(Y.ideal_s(f, b) for f, b in calls)
    if m_rows == 4:
        assert t == pytest.approx(bytes_ / Y.PEAK_BYTES)
    else:
        bound = [f / Y.PEAK_FLOPS >= b / Y.PEAK_BYTES for f, b in calls]
        assert bound == [True, False, False, True, True, True, True]
        assert t > max(flops / Y.PEAK_FLOPS, bytes_ / Y.PEAK_BYTES)


def test_causal_attention_counts_the_causal_half():
    f, b = Y.causal_attention_work(1, 4096, 12, 2, 128)
    assert f == 4 * 12 * 128 * 4096 * 4097 / 2
    assert b == 2 * 4096 * 128 * (2 * 12 + 2 * 2)


def test_decode_attention_counts_each_querys_context():
    # two slots at positions 9 and 99: contexts of 10 and 100 positions
    f, b = Y.decode_attention_work(110, 110, 2, 12, 2, 128)
    assert f == 4 * 12 * 128 * 110
    assert b == 2 * (2 * 2 * 128 * 110 + 2 * 12 * 128 * 2)


def test_moe_counts_only_routed_work_and_hit_experts():
    f, b = Y.moe_work(tokens=32, d=2048, f=1024, n_experts=64, top_k=8, hit=10, frag=8)
    assert f == 2 * 32 * 2048 * 64 + 6 * 32 * 8 * 2048 * 1024
    # gate and up (2048 x 1024) and down (1024 x 2048): codes, a sign byte
    # per 8 rows, a f32 scale per column
    per_expert = (2 * (2048 * 1024 + 256 * 1024 + 4 * 1024)
                  + (1024 * 2048 + 128 * 2048 + 4 * 2048))
    assert b == 2 * 2 * 32 * 2048 + 4 * 2048 * 64 + 10 * per_expert


def test_roofline_share_sums_ideal_times_over_device_time():
    work = [(Y.PEAK_FLOPS * 1e-3, 0.0), (0.0, Y.PEAK_BYTES * 2e-3)]
    assert Y.roofline_share(work, 6e-3) == pytest.approx(50.0)
    assert Y.roofline_share(work, 0.0) is None
    assert Y.roofline_share([], 1.0) is None


def test_serve_model_flops_by_hand():
    cfg = dict(QWEN2)
    per_layer = 46_792_704
    # one request: 3 prompt tokens, 2 generated: 4 tokens through the layers
    got = Y.serve_model_flops(cfg, [(3, 2)])
    want = (2 * 28 * per_layer * 4 + 2 * 1536 * 151936 * 2
            + 4 * 28 * 12 * 128 * (1 + 2 + 3 + 4))
    assert got == want


def test_train_model_flops_by_hand():
    got = Y.train_model_flops(dict(QWEN2), batch=4, seq=4096)
    want = (6 * 4 * 4096 * (28 * 46_792_704 + 1536 * 151936)
            + 3 * 4 * 28 * 12 * 128 * 4 * 4096 * 4097 / 2)
    assert got == want


def _spans(**state):
    from port_bench.harness.spans import Spans
    sp = Spans()
    sp.state.update(state)
    return sp


def _span(name):
    from port_bench.harness import spans as SP
    from port_bench.harness.spec import BENCH_DIR
    return SP.span_module(name, BENCH_DIR)


def test_a_padded_prefill_counts_the_prompt_not_the_bucket():
    import torch

    n, bucket = 2500, 4096
    sp = _spans()
    _span("prefill_slot").before(sp, None, 0, list(range(n)))
    q = torch.zeros(1, bucket, 12, 128, dtype=torch.bfloat16)
    kv = torch.zeros(1, bucket, 2, 128, dtype=torch.bfloat16)
    assert _span("attn_prefill").work(sp, None, q, kv, kv) == Y.causal_attention_work(
        1, n, 12, 2, 128)
    f, _ = _span("attn_prefill").work(sp, None, q, kv, kv)
    assert f == 4 * 12 * 128 * n * (n + 1) / 2
    x = torch.zeros(bucket, 1536, dtype=torch.bfloat16)
    mags = torch.zeros(1536, 8960, dtype=torch.uint8)
    assert _span("forms_mm").work(sp, None, x, mags, None, None, m=8) == Y.forms_mm_work(
        n, 1536, 8960, 2, 1, 8)
    head = torch.zeros(1, 1536, dtype=torch.bfloat16)       # the last row's head
    assert _span("forms_mm").work(sp, None, head, mags, None, None, m=8)[0] == 2 * 1536 * 8960
    _span("prefill_slot").after(sp, 7, None, 0, list(range(n)))
    assert sp.counters["prefill_tokens"] == n and "prefill_len" not in sp.state


def test_a_decode_round_counts_the_active_slots():
    import types

    import torch

    sp = _spans()
    active = [True, False, True, False]
    runner = types.SimpleNamespace(device="cpu")
    with sp.record():
        _span("decode_round").before(sp, runner, None, None, None, active=active)
        x = torch.zeros(4, 1536, dtype=torch.bfloat16)
        mags = torch.zeros(1536, 256, dtype=torch.uint8)
        assert _span("forms_mm").work(sp, None, x, mags, None, None, m=8) == Y.forms_mm_work(
            2, 1536, 256, 2, 1, 8)
        q = torch.zeros(4, 1, 12, 128, dtype=torch.bfloat16)
        cache = torch.zeros(4, 64, 2, 128, dtype=torch.bfloat16)
        pos = torch.tensor([9, 50, 99, 3])
        f, b = _span("attn_decode").work(sp, None, q, cache, cache, pos)
        # slots 0 and 2: contexts of 10 and 64 (the cache's rows) positions
        assert (float(f), float(b)) == Y.decode_attention_work(74, 74, 2, 12, 2, 128)
        # the router's top-2 of the four slots: the inactive ones' experts
        # (5, 6, 7) are not counted as hit
        idx = torch.tensor([[0, 1], [5, 6], [1, 2], [7, 5]])
        _span("top_k").after(sp, (None, idx), torch.zeros(4, 8), 2)
        assert int(sp.state["experts_hit"]) == 3
    _span("decode_round").after(sp, (torch.zeros(4, 4),))
    assert sp.counters["decode_steps"] == 4 and "active" not in sp.state
