"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, with the model's widths, the engine and the mix shrunk."""
from port_bench.harness import spec as S

TINY_MODELS = {
    "qwen2-1.5b": dict(num_layers=2, d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
                       d_ff=96, vocab_size=256),
    "olmoe-1b-7b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                        d_ff=64, vocab_size=256, num_experts=8, experts_per_token=2,
                        moe_d_ff=64, capacity_factor=4.0),
}


# a tiny model's norms carry more rounding than the cell's (fewer elements
# to average), so the median leaf's first-gradient gap gets a limit of its
# own here: tiny runs read 4e-4 to 9e-4, the fp8 control 2e-3 to 1e-2
TINY_LIMITS = {"qwen2-1.5b.admm-train": {"grad1_gap_med": 0.0025}}


def tiny_cell(name: str, model: str = "", **where) -> S.Cell:
    """The cell ``name`` (``where``: ``bench``/``root`` as ``load_cell``
    takes them) at a tiny size: the tiny widths of ``model`` (by default
    the cell's configuration)."""
    cell = S.load_cell(name, **where)
    cell.config["port"].update(TINY_MODELS[model or cell.config["name"]])
    cell.limits.update(TINY_LIMITS.get(name, {}))
    mix = cell.traffic
    if mix["driver"] == "serve_offline":
        mix["engine"].update(batch_slots=4, max_len=128)
        mix.update(batch_requests=6, prompt_len=[8, 60], out_len=[3, 9])
    else:
        mix.update(batch=2, seq_len=64)
    return cell
