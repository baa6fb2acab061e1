"""The EmbeddingBag operand format and the device tier's hit path, on the
CPU.

``BagFormat.from_numpy`` builds the kernel's operands in numpy (stable
sort, bag offsets, range checks) and moves them in one copy; here it is
held against the tensor wrapper's ``torch.sort``/``searchsorted``, and
the plain version over it against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it). The trainer's input rows, assembled
from the host rows and the device tier's rows left on the device, are held
bit for bit against the host overlay of every input row. The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag_pallas
from repro_torch.core import controller as ctl
from repro_torch.core import dqn
from repro_torch.core.windowed_cache import DoubleBufferedCache
from repro_torch.device import to_device_packed
from repro_torch.kernels.embedding_bag import (
    BagFormat,
    bag_launch,
    bag_plain,
    bag_sum,
    embedding_bag,
)
from repro_torch.kernels.embedding_bag.ops import sort_bags
from repro_torch.store import DevicePayloadTier, MemoryBudget
from repro_torch.store import device_tier as device_tier_mod
from repro_torch.train import gnn_trainer as gt
from repro_torch.train.compute import InputRows
from repro_torch.train.worker import TrainerWorker
from _jax_release import release_jax_executables  # noqa: F401


def _bits(x):
    """The float32 bits of a tensor or array, for bit-for-bit equality
    (which tells -0.0 from +0.0)."""
    return np.asarray(x, np.float32).view(np.int32)


# (L, n_bags, segment layout)
FORMAT_CASES = [
    (40, 10, "random"),        # unsorted, duplicates
    (300, 32, "random"),
    (12, 20, "gaps"),          # sorted, with empty bags between
    (9, 4, "one_bag"),         # every lookup in one bag
    (5, 8, "reversed"),        # descending: the sort moves every lookup
    (0, 6, "random"),          # no lookups: every bag empty
    (0, 0, "random"),          # no bags at all
    (64, 64, "arange"),        # the device tier's gather
]


def _lookups(n_lookups, n_bags, layout, rows=50, seed=0):
    rng = np.random.default_rng(seed + 31 * n_lookups + n_bags)
    idx = rng.integers(0, rows, n_lookups).astype(np.int32)
    w = rng.standard_normal(n_lookups).astype(np.float32)
    if layout == "random":
        seg = rng.integers(0, max(n_bags, 1), n_lookups)
    elif layout == "gaps":
        seg = np.sort(rng.choice(np.arange(0, n_bags, 3), n_lookups))
    elif layout == "one_bag":
        seg = np.full(n_lookups, n_bags // 2)
    elif layout == "reversed":
        seg = np.arange(n_lookups)[::-1] % n_bags
    else:
        seg = np.arange(n_lookups)
    return idx, seg.astype(np.int32), w


class TestBagFormat:
    @pytest.mark.parametrize("n_lookups,n_bags,layout", FORMAT_CASES)
    def test_matches_the_tensor_wrappers_sort(self, n_lookups, n_bags,
                                              layout):
        """from_numpy's stable argsort and searchsorted give the tensor
        wrapper's torch.sort and searchsorted operands exactly."""
        idx, seg, w = _lookups(n_lookups, n_bags, layout)
        fmt = BagFormat.from_numpy(idx, seg, n_bags, w, "cpu")
        t_idx, t_w, t_off = sort_bags(torch.as_tensor(idx),
                                      torch.as_tensor(seg), n_bags,
                                      torch.as_tensor(w))
        assert fmt.idx.dtype == fmt.offsets.dtype == torch.int32
        assert fmt.w.dtype == torch.float32
        assert fmt.n_bags == n_bags
        np.testing.assert_array_equal(fmt.idx.numpy(), t_idx.numpy())
        np.testing.assert_array_equal(_bits(fmt.w), _bits(t_w))
        np.testing.assert_array_equal(fmt.offsets.numpy(), t_off.numpy())
        assert fmt.offsets[0] == 0 and fmt.offsets[-1] == n_lookups
        assert fmt.n_rows == (int(idx.max()) + 1 if n_lookups else 0)
        assert fmt.max_len == (
            int(np.bincount(seg, minlength=n_bags).max()) if n_lookups else 0)

    def test_unit_weights_by_default(self):
        fmt = BagFormat.from_numpy([3, 1, 2], [0, 1, 2], 3, None, "cpu")
        np.testing.assert_array_equal(fmt.w.numpy(), np.ones(3, np.float32))
        np.testing.assert_array_equal(fmt.offsets.numpy(), [0, 1, 2, 3])

    @pytest.mark.parametrize("indices,segments,n_bags", [
        ([0, -1, 2], [0, 1, 2], 3),     # a negative index
        ([0, 1, 2], [0, 1, 3], 3),      # a segment past the last bag
        ([0, 1, 2], [0, -1, 1], 3),     # a negative segment
        ([0, 1], [0, 0], 0),            # lookups but no bags
        ([0, 2**31], [0, 1], 2),        # an index that int32 cannot hold
    ])
    def test_range_checks_raise_index_error(self, indices, segments, n_bags):
        with pytest.raises(IndexError):
            BagFormat.from_numpy(np.asarray(indices, np.int64), segments,
                                 n_bags, None, "cpu")

    def test_index_past_the_table_raises_at_the_call(self):
        fmt = BagFormat.from_numpy([0, 7], [0, 1], 2, None, "cpu")
        assert fmt.n_rows == 8
        with pytest.raises(IndexError):
            bag_sum(fmt, torch.zeros((7, 4)))
        assert bag_sum(fmt, torch.zeros((8, 4))).shape == (2, 4)

    @pytest.mark.parametrize("indices,segments,weights", [
        ([0, 1, 2], [0, 1], None),
        ([[0, 1]], [[0, 1]], None),
        ([0, 1, 2], [0, 1, 2], [1.0, 2.0]),
    ])
    def test_shape_checks_raise_value_error(self, indices, segments,
                                            weights):
        with pytest.raises(ValueError):
            BagFormat.from_numpy(indices, segments, 3, weights, "cpu")

    def test_one_copy_views_share_a_buffer(self):
        """idx, w and offsets are views of one packed buffer, so one
        host-to-device copy moves them."""
        fmt = BagFormat.from_numpy([4, 5, 6], [2, 0, 1], 3, [1.0, 2.0, 3.0],
                                   "cpu")
        base = fmt.idx.untyped_storage().data_ptr()
        assert fmt.w.untyped_storage().data_ptr() == base
        assert fmt.offsets.untyped_storage().data_ptr() == base

    def test_kernel_launch_refuses_a_cpu_table(self):
        """No fallback: bag_launch launches the CUDA kernel or raises."""
        fmt = BagFormat.from_numpy([0, 1], [0, 1], 2, None, "cpu")
        with pytest.raises(ValueError, match="CUDA"):
            bag_launch(fmt, torch.zeros((2, 4)), torch.empty((2, 4)))


class TestPlainOverFormat:
    @pytest.mark.parametrize("n,rows,dim", [(1, 10, 8), (37, 50, 16),
                                            (200, 300, 64), (129, 130, 6)])
    def test_gather_bit_equal_to_pallas(self, n, rows, dim):
        """The device tier's gather, unpadded: n bags of one unit-weight
        lookup; bit-equal to table[idx] and to the Pallas kernel."""
        rng = np.random.default_rng(n + rows)
        table = rng.standard_normal((rows, dim)).astype(np.float32)
        table[0, 0] = -0.0   # a sign the gather must keep
        idx = rng.integers(0, rows, n).astype(np.int32)
        idx[0] = 0
        seg = np.arange(n, dtype=np.int32)
        got = bag_sum(BagFormat.from_numpy(idx, seg, n, None, "cpu"),
                      torch.as_tensor(table)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(table[idx]))
        pallas = np.asarray(embedding_bag_pallas(
            jnp.asarray(table), idx, seg, n, interpret=True))
        np.testing.assert_array_equal(got, pallas)

    @pytest.mark.parametrize("n_lookups,n_bags,layout",
                             [c for c in FORMAT_CASES if c[0]])
    def test_weighted_bags_match_pallas(self, n_lookups, n_bags, layout):
        idx, seg, w = _lookups(n_lookups, n_bags, layout)
        table = np.random.default_rng(7).standard_normal(
            (50, 16)).astype(np.float32)
        fmt = BagFormat.from_numpy(idx, seg, n_bags, w, "cpu")
        got = bag_plain(fmt, torch.as_tensor(table)).numpy()
        want = np.asarray(embedding_bag_pallas(
            jnp.asarray(table), idx, seg, n_bags, weights=jnp.asarray(w),
            interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        wrapper = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                                torch.as_tensor(seg), n_bags,
                                torch.as_tensor(w)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(wrapper))

    def test_no_lookups_gives_zero_bags(self):
        fmt = BagFormat.from_numpy(np.empty(0, np.int32),
                                   np.empty(0, np.int32), 5, None, "cpu")
        got = bag_sum(fmt, torch.ones((3, 4)))
        assert got.shape == (5, 4) and not got.any()


def test_to_device_packed_round_trip():
    arrays = [np.arange(5, dtype=np.int32),
              np.random.default_rng(0).standard_normal((3, 7)).astype(
                  np.float32),
              np.zeros((0, 6), np.float32), np.arange(3, dtype=np.int64)]
    got = to_device_packed(arrays, "cpu")
    for a, t in zip(arrays, got):
        assert t.dtype == torch.from_numpy(a).dtype and t.shape == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
        assert t.data_ptr() % 16 == 0


class TestDeviceTier:
    def _tier(self, n=64, d=8, capacity=24, seed=0):
        rng = np.random.default_rng(seed)
        table = rng.standard_normal((n, d)).astype(np.float32)
        cache = DoubleBufferedCache(capacity, np.zeros(n, np.int64),
                                    n_owners=1)
        tier = DevicePayloadTier(cache, n_feat=d, device="cpu")
        hot = np.sort(rng.choice(n, size=capacity, replace=False))
        plan = cache.plan_window([hot], weights=np.ones(1))
        tier.load(plan, peek_fn=lambda ids: table[np.asarray(ids)])
        cache.swap(plan)
        return tier, table, hot

    def test_device_is_required(self):
        cache = DoubleBufferedCache(4, np.zeros(8, np.int64), n_owners=1)
        with pytest.raises(TypeError):
            DevicePayloadTier(cache, n_feat=2)

    @pytest.mark.parametrize("n_ids", [1, 5, 23, 40])
    def test_gather_is_unpadded_and_stays_on_the_device(self, n_ids,
                                                        monkeypatch):
        """n hits make a BagFormat of exactly n bags (no power-of-two
        pad) of arange segments and unit weights, and the rows come back
        as a tensor on the tier's device, bit-equal to the table's."""
        tier, table, _ = self._tier()
        seen = []

        def spy(fmt, tab):
            seen.append(fmt)
            return bag_sum(fmt, tab)

        monkeypatch.setattr(device_tier_mod, "bag_sum", spy)
        ids = np.random.default_rng(n_ids).choice(len(table), size=n_ids)
        hit, rows = tier.gather(ids)
        assert isinstance(rows, torch.Tensor)
        assert rows.device == tier.device and rows.shape == (hit.sum(), 8)
        np.testing.assert_array_equal(_bits(rows), _bits(table[ids[hit]]))
        if hit.any():
            (fmt,) = seen
            assert fmt.n_bags == fmt.idx.shape[0] == int(hit.sum())
            assert fmt.max_len == 1   # the kernel's unit-bag instance
            np.testing.assert_array_equal(fmt.offsets.numpy(),
                                          np.arange(fmt.n_bags + 1))
            np.testing.assert_array_equal(fmt.w.numpy(), 1.0)
        else:
            assert not seen

    def test_gather_slots_returns_host_rows(self):
        tier, table, hot = self._tier()
        got = tier.gather_slots(np.array([3, 0, 3]))
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, table[hot[[3, 0, 3]]])


class TestInputPlacement:
    @pytest.mark.parametrize("n,n_dev,x_rows", [(40, 17, 64), (40, 0, 40),
                                                (33, 33, 128), (1, 0, 128)])
    def test_place_input_bit_equal_to_pad_input(self, n, n_dev, x_rows):
        """Host rows and device rows placed at their positions give the
        same padded input, bit for bit, as padding every row on the
        host."""
        from repro_torch.train.compute import ComputeEngine

        rng = np.random.default_rng(n + n_dev)
        x = rng.standard_normal((n, 5)).astype(np.float32)
        x[0, 1] = -0.0
        dev_pos = np.sort(rng.choice(n, size=n_dev, replace=False))
        host = np.ones(n, bool)
        host[dev_pos] = False
        host_pos = np.flatnonzero(host)
        x_in = InputRows(x[host_pos], host_pos,
                         torch.as_tensor(x[dev_pos]), dev_pos)
        eng = ComputeEngine.__new__(ComputeEngine)
        eng.device = torch.device("cpu")
        eng.mcfg = type("Cfg", (), {"d_in": 5})()
        got = eng.input_rows(x_in, x_rows)
        want = eng.pad_input(x, x_rows)
        assert got.shape == want.shape == (x_rows, 5)
        np.testing.assert_array_equal(_bits(got), _bits(want))


MAIN_PATH = dict(method="greendygnn", compute="measured", scenario=None,
                 async_pipeline=False, trace=False, batch_size=2000,
                 n_epochs=1, warmup_epochs=1, steps_per_epoch=4, seed=0)


def test_worker_input_bit_equal_to_host_overlay():
    """On the main path's configuration with device="cpu", the input the
    SAGE step sees, placed from the host rows and the device tier's
    rows, is bit-equal to padding ``store.peek_rows`` of every input node
    (the host overlay it replaces), and device rows do reach it."""
    qnet = dqn.init_qnet(torch.Generator().manual_seed(0),
                         ctl.state_dim(3), ctl.n_actions(3))
    cfg = gt.RunConfig(**MAIN_PATH, q_fn=dqn.q_fn_of(qnet),
                       mem_budget=MemoryBudget(device_payloads=True),
                       device="cpu")
    w = TrainerWorker(cfg, gt.build_trace(cfg))
    eng = w.engine
    step = eng.step
    checked = []

    def spy(mb, x_in, key=None):
        epoch, s = key
        _, x_rows, _ = eng.prepare(mb, key)
        nodes = w.traces[epoch][s]
        want = eng.pad_input(
            np.asarray(w.store.peek_rows(nodes), np.float32), x_rows)
        got = eng.input_rows(x_in, x_rows)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        checked.append(len(x_in.device_pos))
        return step(mb, x_in, key)

    eng.step = spy
    w.begin_epoch(0)
    for s in range(cfg.steps_per_epoch):
        w.step(0, s)
    w.end_epoch(0)
    assert len(checked) == cfg.steps_per_epoch
    assert sum(checked) > 0
    assert sum(checked) == w.store.tier_stats.device_hits
