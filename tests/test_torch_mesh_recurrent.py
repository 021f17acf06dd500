"""Serving the recurrent families (xLSTM, Zamba2) on a data=2, model=2 gloo
world on the CPU, against the one-device port and the JAX package.

One world, every check inside it (process start costs seconds).  The
reference's single-device greedy tokens are computed once per model in the
pytest process (JAX is imported there only: the ranks import this module,
which imports the port alone at its top) and handed to the ranks with the
bridged weights.  Each rank also serves the port's unsharded engine: the
sharded greedy tokens must equal both on the dense slot cache
(``page_size=0``), with ``page_size=8`` asked for (the recurrent families
fall back to the dense cache), with ``speculate=True`` (falls back to plain
decoding), with block zero-skip, a mixed-precision plan and the health
monitor, for reduced xlstm-350m and zamba2-2.7b in float32.  Two Zamba2
variants take the other layouts: 3 KV heads (the shared block runs all
heads on a K/V cache split along its sequence: context-parallel decode)
and 3 SSM heads (``d_model`` 48, ``ssm_head_dim`` 32: the ``ssm`` state
replicates over ``model`` while ``conv`` still splits ``d_in``).  The
layouts: xLSTM's states hold the rank's slots and every head; Zamba2's
``ssm`` half its SSM heads, ``conv`` half of ``d_in``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import MeshConfig
from repro_torch.forms import FormsSpec, compressed_paths
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world
from repro_torch.models.registry import build
from repro_torch.serving.engine import Request, ServingEngine

PROMPTS = [[1, 2, 3], [2, 2, 3, 5], [3, 2, 3], [4, 2, 3, 7, 1]]
NEW = 6
TIMEOUT_S = 180
BASE = {"xlstm": "xlstm-350m", "zamba": "zamba2-2.7b", "kv3": "zamba2-2.7b",
        "ssm3": "zamba2-2.7b"}
MODES = {
    "dense": dict(page_size=0),
    "paged_asked": dict(page_size=8),
    "speculative": dict(page_size=8, speculate=True, draft_k=4, draft_bits=4),
}
VARIANT_MODES = ("dense", "paged_asked")

# per-leaf widths (and one m=16 leaf) over the engine's FORMS spec
MIXED = {"xlstm": lambda spec: {"mlstm/wq": spec.with_bits(4), "slstm/wz": spec.with_bits(2),
                                "mlstm/wout": dataclasses.replace(spec, m=16, bits=6)},
         "zamba": lambda spec: {"blocks/in_proj": spec.with_bits(4),
                                "mlp/up": spec.with_bits(2),
                                "attn/wo": dataclasses.replace(spec, m=16, bits=6)}}


def _cfg(name, base):
    cfg = dataclasses.replace(base, dtype="float32")
    if name == "kv3":
        return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    if name == "ssm3":
        return dataclasses.replace(cfg, d_model=48, ssm_head_dim=32)
    return cfg


def _requests(cls=Request):
    return [cls(uid=i, prompt=np.array(p), max_new_tokens=NEW) for i, p in enumerate(PROMPTS)]


# ---------------------------------------------------------------------------
# the ranks (this module's top imports only the port)
# ---------------------------------------------------------------------------

def _tokens(eng):
    return {str(r.uid): list(r.tokens) for r in eng.run(_requests())}


def _shape(t):
    return list(t.shape)


def _spec(sh):
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def _world(path, out):
    """The data=2, model=2 world: every check of this file."""
    import torch.distributed as dist
    from repro_torch.reliability import HealthConfig

    blob = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    res = {}

    def check(name, got, *wants):
        res[name] = {"got": got, "ok": all(got == w for w in wants)}

    for name, arch in BASE.items():
        m = build(_cfg(name, get_reduced(arch)), device="cpu")
        p = blob["params"][name]
        want = blob["want"][name]
        kw = dict(max_len=32, batch_slots=4, device="cpu", forms=True, spec=FormsSpec(m=8))
        for mode, extra in MODES.items():
            if name in ("kv3", "ssm3") and mode not in VARIANT_MODES:
                continue
            plain = _tokens(ServingEngine(m, p, **kw, **extra))
            eng = ServingEngine(m, p, **kw, **extra, mesh=mesh)
            check(f"{name}/{mode}", _tokens(eng), plain, want)
            res[f"{name}/{mode}/fallback"] = [eng.paged, eng.speculative]
            if mode != "dense":
                continue
            cache, shs = eng.cache, eng.cache_shardings
            if name == "xlstm":
                res["xlstm/mlstm_state"] = [_shape(cache["layer1"]),
                                            list(cache["layer1"].shard.shape),
                                            _spec(shs["layer1"])]
                res["xlstm/slstm_state"] = [[_shape(t) for t in cache["layer0"]],
                                            [_spec(s) for s in shs["layer0"]]]
                wi = eng.params["blocks"][1]["mlstm"]["wi"]
                wout = eng.params["blocks"][1]["mlstm"]["wout"]
                res["xlstm/wi_wout"] = [_shape(wi.mags), _shape(wout.mags),
                                        any(e is not None for s in wout.shard
                                            for e in s.spec)]
            else:
                res[f"{name}/cache"] = {k: [_shape(cache[k]), list(cache[k].shard.shape)
                                            if hasattr(cache[k], "shard") else None,
                                            _spec(shs[k])] for k in cache}
                res[f"{name}/in_proj"] = [_shape(eng.params["blocks"]["in_proj"].mags),
                                          eng.params["blocks"]["in_proj"].shard is not None
                                          and any(e is not None for s in
                                                  eng.params["blocks"]["in_proj"].shard
                                                  for e in s.spec)]
        if name in ("xlstm", "zamba"):
            # block zero-skip, a mixed-precision plan and the health monitor
            # compose with the mesh: the sharded tokens equal the plain ones
            spec = FormsSpec(m=8)
            extras = {"zero_skip_block": dict(zero_skip="block"),
                      "mixed": dict(plan=MIXED[name](spec)),
                      "health": dict(health=HealthConfig(probe_every=2,
                                                         drift_threshold=1e-3))}
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
    single-device tokens (its dense-cache fallback) on the port's codes,
    per model."""
    import jax
    from repro.configs import get_reduced as jax_reduced
    from repro.models.registry import build as jax_build
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.bridge import params_from_numpy
    from repro_torch.forms import compress_tree
    from torch_parity_util import to_numpy
    from test_torch_mesh import _to_jax

    params, want = {}, {}
    for name, arch in BASE.items():
        jm = jax_build(_cfg(name, jax_reduced(arch)))
        params[name] = params_from_numpy(to_numpy(jm.init(jax.random.PRNGKey(0))),
                                         device="cpu")
        comp, _ = compress_tree(params[name], FormsSpec(m=8))
        eng = JEngine(jm, _to_jax(comp), max_len=32, batch_slots=4, page_size=8)
        assert not eng.paged
        want[name] = {str(r.uid): list(map(int, r.tokens)) for r in eng.run(_requests(JRequest))}
    return params, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_recurrent")
    params, want = _jax_side()
    path = str(d / "blob.pt")
    torch.save({"params": params, "want": want}, path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f), want


CHECKS = ([f"{n}/{m}" for n in ("xlstm", "zamba") for m in MODES]
          + [f"{n}/{m}" for n in ("kv3", "ssm3") for m in VARIANT_MODES])
COMPOSED = [f"{n}/{m}" for n in ("xlstm", "zamba")
            for m in ("zero_skip_block", "mixed", "health")]


@pytest.mark.parametrize("check", CHECKS)
def test_sharded_tokens_equal_unsharded_and_reference(world, check):
    """On every rank the data=2,model=2 engine's greedy tokens equal the
    port's unsharded engine's and the reference's single-device tokens;
    the paged cache and speculation asked for fall back to the dense cache
    and plain decoding, on the mesh as off it."""
    ranks, want = world
    for r, res in enumerate(ranks):
        assert res[check]["ok"], (r, check, res[check], want[check.split("/")[0]])
        assert all(len(t) == NEW for t in res[check]["got"].values())
        assert res[f"{check}/fallback"] == [False, False]
    assert len({json.dumps(res[check]["got"], sort_keys=True) for res in ranks}) == 1


@pytest.mark.parametrize("check", COMPOSED)
def test_zero_skip_mixed_plans_and_health_compose_with_the_mesh(world, check):
    """Block zero-skip, a mixed-precision plan (2-, 4-, 6- and 8-bit leaves,
    one at m=16) and the health monitor (probes every 2 rounds, no fault)
    on the mesh: the sharded tokens equal the unsharded engine's, the plan's
    widths are served, the probes see a drift of 0 and repair nothing."""
    ranks, _ = world
    for res in ranks:
        assert res[check]["ok"], (check, res[check])
        name = check.split("/")[0]
        if check.endswith("mixed"):
            assert res[f"{name}/mixed_bits"] == [2, 4, 6, 8]
        if check.endswith("health"):
            probes, repairs, drift = res[f"{name}/health_stats"]
            assert probes >= 2 and repairs == 0 and drift == 0.0
    assert len({json.dumps(res[check]["got"], sort_keys=True) for res in ranks}) == 1


def test_xlstm_states_hold_the_ranks_slots_and_every_head(world):
    """The mLSTM state (B, H, dk, dk+1) and each sLSTM buffer (B, d) split
    their slots over data only: 2 of 4 slots, both heads, all of d; wi
    (N = 2 heads) holds one column per model rank, wout stays whole."""
    for res in world[0]:
        loc, glob, spec = res["xlstm/mlstm_state"]
        assert loc == [2, 2, 32, 33] and glob == [4, 2, 32, 33] and spec == ["data"]
        shapes, specs = res["xlstm/slstm_state"]
        assert shapes == [[2, 64]] * 3 and specs == [["data"]] * 3
        wi, wout, wout_split = res["xlstm/wi_wout"]
        assert wi[-1] == 1 and wout == [64, 64] and not wout_split


def test_zamba_ssm_heads_conv_channels_and_kv_layouts(world):
    """Zamba2's ssm holds half its 8 SSM heads and conv half of d_in (128);
    the Mamba weights stay whole (no rule splits blocks/in_proj); the
    shared block's K/V split their heads, or (3 KV heads) their sequence;
    with 3 SSM heads ssm replicates over model and conv still splits."""
    for res in world[0]:
        c = res["zamba/cache"]
        assert c["ssm"][0] == [4, 2, 4, 16, 16] and c["ssm"][2] == [None, "data", "model"]
        assert c["conv"][0] == [4, 2, 3, 64] and c["conv"][2] == [None, "data", None, "model"]
        assert c["attn_k"][2] == [None, "data", None, "model"]
        assert res["zamba/in_proj"] == [[4, 64, 296], False]
        assert res["kv3/cache"]["attn_k"][2] == [None, "data", "model"]
        assert res["kv3/cache"]["attn_k"][0] == [2, 2, 16, 3, 16]
        s = res["ssm3/cache"]
        assert s["ssm"][0] == [4, 2, 3, 16, 32] and s["ssm"][2] == [None, "data"]
        assert s["conv"][0] == [4, 2, 3, 48] and s["conv"][2] == [None, "data", None, "model"]
