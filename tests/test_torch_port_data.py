"""The port's input-pipeline helpers (``horovod_tpu_torch/data.py``)
against the reference's (``horovod_tpu/data.py``, ``tests/test_data.py``'s
five classes).

The same seeded numpy arrays go through both packages: equal padded
batches, masks and step counts.  ``masked_mean`` takes torch tensors.
The multi-rank cases (the JOIN negotiation, ``global_masked_mean`` and
its gradient, the join recipe's train step against the numpy gradient
over the real rows) run on a 2-rank gloo world
(``tests/torch_port_workers.py``).
"""

import numpy as np
import pytest
import torch

from horovod_tpu import data as J
from horovod_tpu_torch import data as D
from horovod_tpu_torch.data import ShardedBatchIterator, masked_mean, pad_batch

import torch_port_workers as workers


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


class TestPadBatch:
    @pytest.mark.parametrize("n,size,value", [(3, 3, 0), (2, 4, 9),
                                              (0, 2, -1), (5, 8, 0)])
    def test_equals_the_reference(self, n, size, value):
        x = np.random.RandomState(n).randn(n, 3).astype(np.float32)
        _same(pad_batch(x, size, pad_value=value),
              J.pad_batch(x, size, pad_value=value))

    def test_pads_tail(self):
        p, m = pad_batch(np.ones((2, 3)), 4, pad_value=9)
        assert p.shape == (4, 3)
        np.testing.assert_array_equal(m, [1, 1, 0, 0])
        assert (p[2:] == 9).all()

    def test_oversize_raises(self):
        with pytest.raises(ValueError):
            pad_batch(np.ones((5, 1)), 4)


class TestMaskedMean:
    def test_ignores_padding(self):
        vals = torch.tensor([1.0, 2.0, 100.0, 100.0])
        mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
        assert float(masked_mean(vals, mask)) == pytest.approx(1.5)

    def test_all_masked_is_finite(self):
        assert np.isfinite(float(masked_mean(torch.full((2,), 5.0),
                                             np.zeros(2, np.float32))))

    def test_equals_the_reference(self):
        import jax.numpy as jnp

        rs = np.random.RandomState(4)
        vals = rs.randn(37).astype(np.float32)
        mask = (rs.rand(37) > 0.3).astype(np.float32)
        ref = float(J.masked_mean(jnp.asarray(vals), jnp.asarray(mask)))
        got = float(masked_mean(torch.from_numpy(vals), mask))
        assert got == pytest.approx(ref, rel=1e-6)


class TestShardedBatchIterator:
    @pytest.mark.parametrize("n,bs,world,shuffle,drop", [
        (10, 4, 1, False, False), (12, 2, 2, False, False),
        (13, 4, 2, True, False), (29, 3, 3, True, True)])
    def test_batches_equal_the_reference(self, n, bs, world, shuffle, drop):
        x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        y = np.arange(n, dtype=np.int32)
        for rank in range(world):
            kw = dict(batch_size=bs, rank=rank, world=world,
                      shuffle=shuffle, seed=5, drop_remainder=drop)
            a, b = ShardedBatchIterator(x, y, **kw), \
                J.ShardedBatchIterator(x, y, **kw)
            assert len(a) == len(b)
            for _ in range(2):                 # two epochs
                _same(list(a), list(b))

    def test_covers_all_rows_with_padding(self):
        batches = list(ShardedBatchIterator(np.arange(10), batch_size=4))
        assert len(batches) == 3
        assert batches[-1][1].sum() == 2
        seen = np.concatenate([xb[mask.astype(bool)]
                               for (xb,), mask in batches])
        assert sorted(seen) == list(range(10))

    def test_mismatched_arrays_raise(self):
        with pytest.raises(ValueError):
            ShardedBatchIterator(np.ones(3), np.ones(4), batch_size=2)


class TestJoinedBatchIterator:
    @pytest.mark.parametrize("rows,bs,negotiated", [(20, 4, 9), (0, 2, 2),
                                                     (5, 8, 1)])
    def test_equals_the_reference(self, monkeypatch, rows, bs, negotiated):
        for mod in (D, J):
            monkeypatch.setattr(mod, "negotiate_steps",
                                lambda n: max(n, negotiated))
        x = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
        y = np.ones((rows,), np.float32)
        a, b = D.JoinedBatchIterator(x, y, batch_size=bs, shuffle=True,
                                     seed=2), \
            J.JoinedBatchIterator(x, y, batch_size=bs, shuffle=True, seed=2)
        assert (len(a), a.local_steps) == (len(b), b.local_steps)
        _same(list(a), list(b))

    def test_epoch_renegotiates_for_peers(self, monkeypatch):
        calls = {"n": 0}

        def fake_negotiate(local):
            calls["n"] += 1
            return [2, 2, 5][min(calls["n"] - 1, 2)]

        monkeypatch.setattr(D, "negotiate_steps", fake_negotiate)
        it = D.JoinedBatchIterator(np.ones((4, 2), np.float32), batch_size=2)
        assert len(it) == 2
        assert len(list(it)) == 2
        assert len(list(it)) == 5
        assert len(it) == 5
        assert calls["n"] == 3

    def test_ragged_ranks_negotiate_the_maximum(self, world):
        """Rank 0 holds 5 rows, rank 1 11: both iterate 6 steps of 2
        (ceil(11 / 2)), rank 0 joined with zero masks after its 3."""
        rows = [np.arange(5 * 3, dtype=np.float32).reshape(5, 3),
                np.arange(11 * 3, dtype=np.float32).reshape(11, 3)]
        res = world.run("joined_mean", per_rank=[{"rows": r} for r in rows],
                        batch_size=2)
        for r, local in zip(res, (3, 6)):
            assert (r["len"], r["local"]) == (6, local)
            assert r["negotiated"] == 2
        assert [float(m.sum()) for m in res[0]["masks"]] == \
            [2, 2, 1, 0, 0, 0]


class TestGlobalMaskedMean:
    def test_means_and_gradients_over_ragged_ranks(self, world):
        """Each step's ``global_masked_mean`` is the mean of the real rows
        of both ranks' batches, and its gradient is psum's transpose: each
        rank's rows get (ranks / real rows) per real row, zero on
        padding."""
        rs = np.random.RandomState(1)
        rows = [rs.randn(5, 3).astype(np.float32),
                rs.randn(11, 3).astype(np.float32)]
        res = world.run("joined_mean", per_rank=[{"rows": r} for r in rows],
                        batch_size=2)
        for s in range(6):
            vals, count = 0.0, 0.0
            for r, x in zip(res, rows):
                m = r["masks"][s]
                real = x[2 * s:2 * s + int(m.sum())]
                vals += real.sum()
                count += m.sum()
            want = vals / max(count, 1.0)
            for r in res:
                assert r["means"][s] == pytest.approx(want, rel=1e-5,
                                                      abs=1e-6)
                np.testing.assert_allclose(
                    r["grads"][s],
                    np.broadcast_to((2.0 / max(count, 1.0)) *
                                    r["masks"][s][:, None], (2, 3)),
                    rtol=1e-6)

    def test_exact_ragged_gradients_match_numpy(self, world):
        """The join recipe: one ``make_train_step`` SGD step (op Average)
        over a ragged batch, loss ``global_masked_mean``, equals the numpy
        gradient step over the real rows (the reference's tolerance)."""
        rng = np.random.RandomState(0)
        X = rng.randn(8, 3).astype(np.float32)
        Y = rng.randn(8, 1).astype(np.float32)
        mask = np.ones((8,), np.float32)
        mask[-5:] = 0.0
        lr = 0.1
        res = world.run("global_mean_step", x=X * mask[:, None],
                        y=Y * mask[:, None], mask=mask, lr=lr)
        real = mask.astype(bool)
        w0 = np.zeros((3, 1), np.float32)
        grad = 2.0 * X[real].T @ (X[real] @ w0 - Y[real]) / real.sum()
        exp_loss = float(np.mean(np.sum((X[real] @ w0 - Y[real]) ** 2, -1)))
        for r in res:
            np.testing.assert_allclose(r["w"], (w0 - lr * grad).T,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(r["loss"], exp_loss, rtol=1e-5)
