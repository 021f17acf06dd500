"""Serving MLA (deepseek-v3 with its MTP module) and whisper on a data=2,
model=2 gloo world on the CPU, against the one-device port and the JAX
package.

One world, every check inside it (process start costs seconds).  The
reference's single-device greedy tokens are computed once per model in the
pytest process (JAX is imported there only: the ranks import this module,
which imports the port alone at its top) and handed to the ranks with the
bridged weights.  Each rank also serves the port's unsharded engine: the
sharded greedy tokens must equal both, on the paged cache, the dense slot
cache (``page_size=0``), the speculative engine (4-bit draft, K=4) and the
fleet with chunked prefill, for reduced deepseek-v3 (float32, its latent
caches in float32 as the reference's serving tests hold them, capacity
factor 64 so that no expert drops a token on either side), reduced
whisper-small (4 heads: the local-heads route) and a 3-head whisper (the
all-heads route; its page pool replicates the heads and its dense cache
splits the sequence: context-parallel decode).  Whisper also serves
against a random encoder output written into both engines' caches (the
sharded engine's ``enc_out`` holds each rank's slots and half of ``d``).
No rank holds a whole copy of ``kv_up``, ``xattn/wq`` or the ``c_kv`` pool.
Block zero-skip and a mixed-precision plan compose with the mesh for both
families, the health monitor for deepseek-v3 (the sharded tokens equal the
unsharded engine's; whisper's monitor is refused on one device already).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import MeshConfig
from repro_torch.forms import FormsSpec, compress_tree, compressed_paths
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world
from repro_torch.models.registry import build
from repro_torch.serving.engine import Request, ServingEngine

PROMPTS = [[1, 2, 3], [2, 2, 3, 5], [3, 2, 3], [4, 2, 3, 7, 1]]
NEW = 6
TIMEOUT_S = 180
BASE = {"deepseek": "deepseek-v3-671b", "whisper": "whisper-small", "heads3": "whisper-small"}
MODES = {
    "paged": dict(page_size=8),
    "dense": dict(page_size=0),
    "speculative": dict(page_size=8, speculate=True, draft_k=4, draft_bits=4),
    "fleet": dict(page_size=4, slo={"prefill_chunk": 4, "step_token_budget": 8}),
}


# per-leaf widths (and one m=16 leaf that still shards K at whole
# fragments) over the engine's FORMS spec
MIXED = {"deepseek": lambda spec: {"mla/q_up": spec.with_bits(4),
                                   "moe/shared_up": spec.with_bits(2)},
         "whisper": lambda spec: {"xattn/wq": spec.with_bits(4), "mlp/up": spec.with_bits(2),
                                  "attn/wo": dataclasses.replace(spec, m=16, bits=6)}}


def _cfg(name, base):
    cfg = dataclasses.replace(base, dtype="float32")
    if name == "deepseek":
        return dataclasses.replace(cfg, capacity_factor=64.0)
    if name == "heads3":
        return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    return cfg


def _requests(cls=Request):
    return [cls(uid=i, prompt=np.array(p), max_new_tokens=NEW) for i, p in enumerate(PROMPTS)]


def _f32_caches(model, dtype):
    """``model`` (either package's) with its caches made in ``dtype``."""
    init, paged = model.init_cache, model.init_paged_cache
    return dataclasses.replace(
        model, init_cache=lambda b, n: init(b, n, dtype=dtype),
        init_paged_cache=lambda p, s, slots, n: paged(p, s, slots, n, dtype=dtype))


# ---------------------------------------------------------------------------
# the ranks (this module's top imports only the port)
# ---------------------------------------------------------------------------

def _tokens(eng):
    return {str(r.uid): list(r.tokens) for r in eng.run(_requests())}


def _write_enc(eng, enc):
    """The global encoder output ``enc`` (slots, max_len, d) into an
    engine's cache: this rank's piece under the cache's spec on a mesh."""
    from repro_torch.distributed.context import local_slice
    if eng.paged:
        leaf = eng.cache.dense["enc_out"]
        spec = eng.cache_shardings.dense["enc_out"].spec if eng.ctx is not None else ()
    else:
        leaf = eng.cache["enc_out"]
        spec = eng.cache_shardings["enc_out"].spec if eng.ctx is not None else ()
    piece = local_slice(enc, spec, eng.ctx) if eng.ctx is not None else enc
    with torch.inference_mode():
        leaf.copy_(piece.to(leaf.dtype))
    return list(leaf.shape)


def _world(path, out):
    """The data=2, model=2 world: every check of this file."""
    import torch.distributed as dist

    blob = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    res = {}

    def check(name, got, *wants):
        res[name] = {"got": got, "ok": all(got == w for w in wants)}

    for name in ("deepseek", "whisper", "heads3"):
        m = build(_cfg(name, get_reduced(BASE[name])), device="cpu")
        if name == "deepseek":
            m = _f32_caches(m, torch.float32)
        p = blob["params"][name]
        want = blob["want"][name]
        kw = dict(max_len=32, batch_slots=4, device="cpu", forms=True, spec=FormsSpec(m=8))
        for mode, extra in MODES.items():
            if name == "heads3" and mode not in ("paged", "dense"):
                continue
            plain = _tokens(ServingEngine(m, p, **kw, **extra))
            eng = ServingEngine(m, p, **kw, **extra, mesh=mesh)
            got = _tokens(eng)
            check(f"{name}/{mode}", got, plain, want)
            if mode == "fleet":
                res[f"{name}/fleet_chunks"] = eng.stats()["slo"]["chunked_prefill"]["calls"]
            if mode == "speculative":
                res[f"{name}/drafted"] = eng.stats()["speculate"]["drafted"]
            if mode == "paged":
                blocks = eng.params["blocks" if name == "deepseek" else "dec_blocks"]
                if name == "deepseek":
                    kv_up = blocks["mla"]["kv_up"]
                    res["deepseek/kv_up"] = [list(kv_up.mags.shape), list(kv_up.shard[0].shape)]
                    pool = eng.cache.pool["c_kv"]
                    res["deepseek/c_kv_pool"] = [list(pool.shape), list(pool.shard.shape)]
                    res["deepseek/k_rope_spec"] = list(eng.cache_shardings.pool["k_rope"].spec)
                    res["deepseek/mtp_proj"] = list(eng.params["mtp"]["proj"].mags.shape)
                else:
                    wq = blocks["xattn"]["wq"]
                    res[f"{name}/xattn_wq"] = [list(wq.mags.shape), list(wq.shard[0].shape)]
                    res[f"{name}/pool_spec"] = list(eng.cache_shardings.pool["k"].spec)
                    res[f"{name}/enc_spec"] = list(eng.cache_shardings.dense["enc_out"].spec)
            if mode == "dense" and name != "deepseek":
                res[f"{name}/dense_spec"] = list(eng.cache_shardings["k"].spec)
        if name != "heads3":
            # block zero-skip, a mixed-precision plan and the health monitor
            # compose with the mesh: the sharded tokens equal the plain ones
            from repro_torch.reliability import HealthConfig
            spec = FormsSpec(m=8)
            extras = {"zero_skip_block": dict(zero_skip="block"),
                      "mixed": dict(plan=MIXED[name](spec))}
            if name == "deepseek":
                # (whisper's frames are no token prompt: both packages' monitors
                # refuse it on one device too)
                extras["health"] = dict(health=HealthConfig(probe_every=2,
                                                            drift_threshold=1e-3))
            for mode, extra in extras.items():
                plain = _tokens(ServingEngine(m, p, **kw, page_size=8, **extra))
                eng = ServingEngine(m, p, **kw, page_size=8, **extra, mesh=mesh)
                check(f"{name}/{mode}", _tokens(eng), plain)
                if mode == "health":
                    h = eng.stats()["health"]
                    res[f"{name}/health_stats"] = [h["probes"], h["repairs"], h["last_drift"]]
                if mode == "mixed":
                    res[f"{name}/mixed_bits"] = sorted(
                        {leaf.bits for leaf in compressed_paths(eng.params).values()})
        if name != "deepseek":
            # a random encoder context in both engines' caches
            enc = torch.from_numpy(blob["enc"])
            for mode in ("paged", "dense"):
                a = ServingEngine(m, p, **kw, **MODES[mode])
                b = ServingEngine(m, p, **kw, **MODES[mode], mesh=mesh)
                _write_enc(a, enc)
                res[f"{name}/enc_local_{mode}"] = _write_enc(b, enc)
                check(f"{name}/enc_out_{mode}", _tokens(b), _tokens(a))
                res[f"{name}/enc_moves_{mode}"] = res[f"{name}/enc_out_{mode}"]["got"] != want

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(every, f)


# ---------------------------------------------------------------------------
# the pytest side: the reference's tokens, the world, the assertions
# ---------------------------------------------------------------------------

def _jax_side():
    """Bridged weights of the reference's init and the reference's
    single-device paged tokens on the port's codes, per model."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.models.registry import build as jax_build
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.bridge import params_from_numpy
    from torch_parity_util import to_numpy
    from test_torch_mesh import _to_jax

    params, want = {}, {}
    for name, arch in BASE.items():
        jm = jax_build(_cfg(name, jax_reduced(arch)))
        params[name] = params_from_numpy(to_numpy(jm.init(jax.random.PRNGKey(0))),
                                         device="cpu")
        comp, _ = compress_tree(params[name], FormsSpec(m=8))
        if name == "deepseek":
            # the reference's bf16 absorbed decode needs a CPU bf16 dot this
            # box's XLA lacks: its serving runs on f32 latent caches
            jm = _f32_caches(jm, jnp.float32)
        eng = JEngine(jm, _to_jax(comp), max_len=32, batch_slots=4, page_size=8)
        want[name] = {str(r.uid): list(map(int, r.tokens)) for r in eng.run(_requests(JRequest))}
    enc = np.random.RandomState(5).normal(0, 1, (4, 32, 64)).astype(np.float32)
    return params, want, enc


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_mla_whisper")
    params, want, enc = _jax_side()
    path = str(d / "blob.pt")
    torch.save({"params": params, "want": want, "enc": enc}, path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f), want


CHECKS = ([f"{n}/{m}" for n in ("deepseek", "whisper") for m in MODES]
          + ["heads3/paged", "heads3/dense"])
COMPOSED = [f"{n}/{m}" for n in ("deepseek", "whisper")
            for m in ("zero_skip_block", "mixed")] + ["deepseek/health"]


@pytest.mark.parametrize("check", CHECKS)
def test_sharded_tokens_equal_unsharded_and_reference(world, check):
    """On every rank the data=2,model=2 engine's greedy tokens equal the
    port's unsharded engine's and the reference's single-device tokens."""
    ranks, want = world
    for r, res in enumerate(ranks):
        assert res[check]["ok"], (r, check, res[check], want[check.split("/")[0]])
        assert all(len(t) == NEW for t in res[check]["got"].values())
    assert len({json.dumps(res[check]["got"], sort_keys=True) for res in ranks}) == 1


@pytest.mark.parametrize("check", COMPOSED)
def test_zero_skip_mixed_plans_and_health_compose_with_the_mesh(world, check):
    """Block zero-skip, a mixed-precision plan (2-, 4-, 6- and 8-bit leaves,
    one at m=16) and deepseek-v3's health monitor (probes every 2 rounds, no
    fault) on the mesh: the sharded tokens equal the unsharded engine's, the plan's
    widths are served, the probes see a drift of 0 and repair nothing."""
    ranks, _ = world
    for res in ranks:
        assert res[check]["ok"], (check, res[check])
        name = check.split("/")[0]
        if check.endswith("mixed"):
            assert res[f"{name}/mixed_bits"] == ([2, 4, 8] if name == "deepseek"
                                                 else [2, 4, 6, 8])
        if check.endswith("health"):
            probes, repairs, drift = res[f"{name}/health_stats"]
            assert probes >= 2 and repairs == 0 and drift == 0.0
    assert len({json.dumps(res[check]["got"], sort_keys=True) for res in ranks}) == 1


def test_speculative_and_fleet_modes_ran_their_own_paths(world):
    """The speculative engines drafted and the fleets chunked their
    prefills, on the mesh as off it."""
    for res in world[0]:
        for name in ("deepseek", "whisper"):
            assert res[f"{name}/drafted"] > 0 and res[f"{name}/fleet_chunks"] > 0


def test_no_rank_holds_a_whole_copy_of_kv_up_xattn_wq_or_the_latent_pool(world):
    """kv_up and xattn/wq hold half their columns on each rank; the c_kv
    pool half its pages (data) and half its kv_lora_rank (model), the
    shared rope key replicated over model; the MTP module's proj (no rule)
    whole."""
    for res in world[0]:
        (loc, glob) = res["deepseek/kv_up"]
        assert loc[-1] * 2 == glob[-1] and loc[-2] == glob[-2]
        (loc, glob) = res["deepseek/c_kv_pool"]
        assert loc[1] * 2 == glob[1] and loc[-1] * 2 == glob[-1] == 16
        assert res["deepseek/k_rope_spec"] == [None, "data"]
        assert res["deepseek/mtp_proj"] == [128, 64]
        for name in ("whisper", "heads3"):
            (loc, glob) = res[f"{name}/xattn_wq"]
            assert loc[-1] * 2 == glob[-1]


def test_whisper_cache_layouts_and_a_written_encoder_context(world):
    """The 4-head pool splits its heads over model and the 3-head one
    replicates them; the 3-head dense cache splits its sequence; enc_out
    holds each rank's 2 slots and 32 of d's 64 columns; with a random
    encoder output written into both engines the sharded tokens equal the
    unsharded ones and differ from the zero-context tokens."""
    for res in world[0]:
        assert res["whisper/pool_spec"] == [None, "data", None, "model"]
        assert res["heads3/pool_spec"] == [None, "data"]
        assert res["whisper/dense_spec"] == [None, "data", None, "model"]
        assert res["heads3/dense_spec"] == [None, "data", "model"]
        for name in ("whisper", "heads3"):
            assert res[f"{name}/enc_spec"] == ["data", None, "model"]
            for mode in ("paged", "dense"):
                assert res[f"{name}/enc_out_{mode}"]["ok"], (name, mode)
                assert res[f"{name}/enc_local_{mode}"] == [2, 32, 32]
                assert res[f"{name}/enc_moves_{mode}"]
