"""The traffic generator: the same seed gives the same traffic; another
seed the same sizes and gaps in another order; the frozen samplers are
the port's."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import flexbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from flexbench.lib import samplers
from flexbench.lib import traffic as TR

ROOT = Path(__file__).resolve().parents[2]
CELLS = sorted(p.stem for p in (ROOT / "flexbench" / "workloads").glob(
    "*.json"))
SEEDS = (2 ** 31 + 11, 5)


def traffic(cell):
    return json.loads((ROOT / "flexbench" / "workloads" /
                       f"{cell}.json").read_text())


def sizes(items):
    return [(len(i.prompt), i.max_new) for i in items]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_traffic(cell):
    t = traffic(cell)
    a, b = (TR.items(t, SEEDS[0], 32000, 40.0) for _ in range(2))
    assert sizes(a) == sizes(b)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    if t["loop"] == "open":
        assert np.array_equal(TR.arrivals(t, SEEDS[0], 40.0),
                              TR.arrivals(t, SEEDS[0], 40.0))


@pytest.mark.parametrize("cell", CELLS)
def test_another_seed_reorders_the_same_work(cell):
    t = traffic(cell)
    a, b = (TR.items(t, s, 32000, 40.0) for s in SEEDS)
    assert sizes(a) != sizes(b)
    k = TR.block(t)
    for b0 in range(0, len(a) - k + 1, k):
        blk = slice(b0, b0 + k)
        assert Counter(sizes(a)[blk]) == Counter(sizes(b)[blk])
    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    assert all(lo <= n <= hi for n, _ in sizes(a))
    if t["loop"] == "open":
        x, y = (TR.arrivals(t, s, 40.0) for s in SEEDS)
        assert not np.array_equal(x, y)
        ends = np.arange(k - 1, len(x), k)
        np.testing.assert_allclose(x[ends], y[ends], rtol=1e-12)


def test_closed_loop_clients_start_evenly_over_the_ramp():
    t = {"clients": 4, "ramp_s": 2.0}
    np.testing.assert_allclose(TR.client_starts(t), [0.0, 0.5, 1.0, 1.5])


def test_frozen_samplers_match_the_ports():
    from repro_torch.traffic import arrivals, lengths
    for name in ("poisson", "uniform"):
        a = samplers.arrivals(name, np.random.default_rng(3), 50, 4.0)
        b = arrivals.make_arrivals(name, np.random.default_rng(3), 50, 4.0)
        np.testing.assert_array_equal(a, b)
    a = samplers.arrivals("gamma", np.random.default_rng(3), 50, 4.0, cv=3.0)
    b = arrivals.make_arrivals("gamma", np.random.default_rng(3), 50, 4.0,
                               cv=3.0)
    np.testing.assert_array_equal(a, b)
    for cv in (0.0, 0.6, 1.0):
        a = samplers.lengths("lognormal", np.random.default_rng(4), 50, 900,
                             cv=cv)
        b = lengths.make_lengths("lognormal", np.random.default_rng(4), 50,
                                 900, cv=cv)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        samplers.arrivals("nope", np.random.default_rng(0), 3, 1.0)
