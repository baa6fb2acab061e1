"""The port's budgeted host tier and tiered store against the JAX
reference's, on the CPU.

Both sides are numpy, so every sequence must agree bit for bit: CLOCK
residency, eviction order and pins (``HostTier``), the block budget
(``MemoryBudget``), and the block charges and headroom of
``TieredFeatureStore`` over an in-RAM matrix and over the streaming
source of an out-of-core dataset.
"""
import numpy as np
import pytest

from repro.graph import datasets as rds
from repro.graph.partition import partition_graph as ref_partition
from repro.store import HostTier as RefHostTier
from repro.store import MemoryBudget as RefBudget
from repro.store import TieredFeatureStore as RefStore
from repro.train import worker as rworker
from repro_torch.graph import datasets as pds
from repro_torch.graph.partition import partition_graph
from repro_torch.store import HostTier, MemoryBudget, TieredFeatureStore
from repro_torch.train import worker as pworker
from _jax_release import release_jax_executables  # noqa: F401


def _host_state(t):
    return (t.resident.copy(), t.ref.copy(), t.pinned.copy(), t.hand,
            t.n_resident, t.evictions, t.peak_resident,
            t.pinned_over_budget)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("budget_blocks", [None, 1, 3, 7])
def test_host_tier_sequence_equal(budget_blocks):
    """A seeded sequence of touches and pins: the same blocks fetched, the
    same residency, reference bits, hand, evictions and pins each call."""
    rng = np.random.default_rng(11 + (budget_blocks or 0))
    ref, port = RefHostTier(1000, 64, budget_blocks), \
        HostTier(1000, 64, budget_blocks)
    for _ in range(200):
        ids = rng.integers(0, 1000, rng.integers(0, 40))
        if rng.random() < 0.2:
            ref.pin(ids)
            port.pin(ids)
        else:
            np.testing.assert_array_equal(port.touch(ids), ref.touch(ids))
        _assert_same(_host_state(port), _host_state(ref))
        np.testing.assert_array_equal(
            port.is_resident(np.arange(port.n_blocks)),
            ref.is_resident(np.arange(ref.n_blocks)))
    if budget_blocks is not None:
        assert port.evictions > 0


@pytest.mark.parametrize("host_bytes,chunk_rows,bytes_per_row", [
    (None, 2048, 256.0), (1e6, 256, 256.0), (1.0, 4096, 384.0),
    (5.5e5, 128, 5732.0), (0.0, 1, 0.0),
])
def test_budget_blocks_and_unlimited_equal(host_bytes, chunk_rows,
                                           bytes_per_row):
    ref = RefBudget(host_bytes=host_bytes, chunk_rows=chunk_rows)
    port = MemoryBudget(host_bytes=host_bytes, chunk_rows=chunk_rows)
    assert port.unlimited == ref.unlimited == (host_bytes is None)
    assert port.budget_blocks(bytes_per_row) \
        == ref.budget_blocks(bytes_per_row)


def _stores(dataset, frac, chunk_rows):
    """(reference store, port store) of partition 0 at a host budget of
    ``frac`` of the feature matrix, laid out as the workers lay it out."""
    rgraph = rds.materialize(dataset, seed=0)
    pgraph = pds.materialize(dataset, seed=0)
    owner = ref_partition(rgraph, 4, seed=0)
    np.testing.assert_array_equal(partition_graph(pgraph, 4, seed=0), owner)
    n_feat = (rgraph.features.shape[1] if rgraph.features is not None
              else rgraph.feature_source.n_feat)
    host = frac * rgraph.n_nodes * n_feat * 4
    ref = rworker.build_store(rgraph, owner, 0, 4, budget=RefBudget(
        host_bytes=host, chunk_rows=chunk_rows))
    port = pworker.build_store(pgraph, owner, 0, 4, budget=MemoryBudget(
        host_bytes=host, chunk_rows=chunk_rows))
    assert isinstance(ref, RefStore) and isinstance(port, TieredFeatureStore)
    return ref, port, owner


@pytest.mark.parametrize("dataset,frac,chunk_rows", [
    ("reddit", 0.2, 256),          # an in-RAM matrix
    ("ooc_community", 0.3, 256),   # the streaming out-of-core source
    ("ooc_community", 0.05, 1024),
])
def test_tiered_store_touch_sequence_equal(dataset, frac, chunk_rows):
    """Pins and touches of seeded id sets: equal ``BlockCharge``s, counters
    and headroom after every call, and equal rows."""
    ref, port, owner = _stores(dataset, frac, chunk_rows)
    assert (port.features is None) == (dataset == "ooc_community")
    np.testing.assert_array_equal(port.order, ref.order)
    rng = np.random.default_rng(5)
    n = len(owner)
    for i in range(60):
        ids = rng.integers(0, n, rng.integers(1, 400))
        if i % 7 == 0:             # a few pinned blocks, as a plan's
            ref.pin_window(ids[:8])
            port.pin_window(ids[:8])
            continue
        a, b = ref.touch(ids), port.touch(ids)
        np.testing.assert_array_equal(b.per_owner_rows, a.per_owner_rows)
        assert (b.local_rows, b.n_blocks, b.empty) \
            == (a.local_rows, a.n_blocks, a.empty)
        assert port.tier_stats.counts() == ref.tier_stats.counts()
        assert port.headroom() == ref.headroom()
    assert port.tier_stats.evictions > 0
    ids = rng.integers(0, n, 50)
    np.testing.assert_array_equal(port.peek_rows(ids), ref.peek_rows(ids))


def test_unlimited_store_charges_nothing():
    """No host budget: ``touch`` returns None, headroom stays 1.0, and the
    counters stay zero, as the reference's."""
    graph = pds.materialize("ooc_community", seed=0)
    owner = partition_graph(graph, 4, seed=0)
    store = pworker.build_store(graph, owner, 0, 4, budget=MemoryBudget())
    assert store.host is None
    assert store.touch(np.arange(100)) is None
    store.pin_window(np.arange(100))
    assert store.headroom() == 1.0
    assert set(store.tier_stats.counts().values()) == {0}
