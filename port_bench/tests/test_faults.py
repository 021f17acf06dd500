"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (tiny cells on the CPU), the rest
of the run is driven as the benchmark drives it."""
import dataclasses
import time

import pytest

from port_bench.harness import spec as S
from port_bench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 7


def _run(name):
    cell = tiny_cell(name)
    return S.driver(cell.traffic["driver"]).measure(cell, SEED, 0.3, False,
                                                    time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", ["qwen2-1.5b.longprompt", "olmoe-1b-7b.decode"])
def test_a_token_altered_where_it_is_sampled(name, monkeypatch):
    from repro_torch.serving import engine

    real = engine.sample_on_device

    def altered(logits, temps, generator):
        return (real(logits, temps, generator) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_on_device", altered)
    m = _run(name)
    assert not m.correct, m.checks


@pytest.mark.parametrize("name", ["qwen2-1.5b.longprompt", "olmoe-1b-7b.decode"])
def test_half_of_the_requests_left_out(name, monkeypatch):
    from repro_torch.serving.engine import ServingEngine

    real = ServingEngine.run
    monkeypatch.setattr(ServingEngine, "run", lambda self, reqs: real(self, reqs[::2]))
    m = _run(name)
    assert m.failed > 0 and not m.correct


def test_a_train_step_that_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.training import optimizer

    monkeypatch.setattr(optimizer, "adamw_update", lambda params, grads, state, cfg, lr_fn=None:
                        (params, dataclasses.replace(state, step=state.step + 1)))
    m = _run("qwen2-1.5b.admm-train")
    assert m.readings["change_gap"] == pytest.approx(1.0)
    assert not m.correct


def test_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.training import train_loop

    monkeypatch.setattr(train_loop, "shard_batch",
                        lambda batch, ctx: {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    m = _run("qwen2-1.5b.admm-train")
    assert not m.correct, m.readings
