"""PyTorch port vs the JAX package: temperature sampling as a distribution.

The port draws by Gumbel-max with a ``torch.Generator``
(``repro_torch.serving.engine.sample_on_device``), the reference by
``jax.random.categorical`` (``repro.serving.engine._sample_on_device``):
the two cannot agree draw for draw, so each is held to
``softmax(logits / T)`` and to the other by chi-square tests.  Fixed logit
rows (numpy, seed 0) at temperatures 0.5, 1 and 2, 20,000 draws per row in
each package, one call each.  The tests fail below a p-value of 1e-4: a
correct sampler fails one of them about once in 10^4 seeds, and the seeds
here are fixed.  Temperature 0 takes the argmax in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.serving.engine import _sample_on_device as jax_sample
from repro_torch.serving.engine import sample_on_device as torch_sample

P_MIN = 1e-4
DRAWS = 20_000
TEMPS = (0.5, 1.0, 2.0)
V = 6


def _logits():
    return np.random.RandomState(0).uniform(-1.0, 1.0, (3, V)).astype(np.float32)


def _draw_both(logits, temps):
    """Each package's samples for every row of ``logits`` at ``temps``:
    (port, reference) int arrays of shape (rows, DRAWS)."""
    rows = logits.shape[0]
    big = np.repeat(logits, DRAWS, axis=0)
    t = np.repeat(np.asarray(temps, np.float32), DRAWS)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    port = torch_sample(torch.from_numpy(big), torch.from_numpy(t), gen).numpy()
    ref = np.asarray(jax.jit(jax_sample)(jnp.asarray(big), jnp.asarray(t),
                                         jax.random.PRNGKey(0)))
    return port.reshape(rows, DRAWS), ref.reshape(rows, DRAWS)


@pytest.fixture(scope="module")
def draws():
    logits = _logits()
    rows = np.concatenate([logits] * len(TEMPS))
    temps = [t for t in TEMPS for _ in range(logits.shape[0])]
    port, ref = _draw_both(rows, temps)
    return rows, temps, port, ref


def _softmax(z):
    e = np.exp(z - z.max())
    return e / e.sum()


@pytest.mark.parametrize("package", ["port", "reference"])
def test_sampled_frequencies_follow_the_tempered_softmax(draws, package):
    rows, temps, port, ref = draws
    samples = port if package == "port" else ref
    for r, (logit, t) in enumerate(zip(rows, temps)):
        counts = np.bincount(samples[r], minlength=V)
        expected = _softmax(logit.astype(np.float64) / t) * DRAWS
        assert expected.min() >= 5, "a bin too thin for the chi-square test"
        p = stats.chisquare(counts, expected).pvalue
        assert p >= P_MIN, (package, t, counts.tolist(), expected.round(1).tolist(), p)


def test_port_and_reference_frequency_tables_agree(draws):
    rows, temps, port, ref = draws
    for r, t in enumerate(temps):
        table = np.stack([np.bincount(port[r], minlength=V), np.bincount(ref[r], minlength=V)])
        p = stats.chi2_contingency(table).pvalue
        assert p >= P_MIN, (t, table.tolist(), p)


def test_temperature_zero_takes_the_argmax_in_both():
    logits = _logits()
    port, ref = _draw_both(logits, [0.0] * logits.shape[0])
    want = logits.argmax(axis=1)[:, None]
    assert (port == want).all() and (ref == want).all()
