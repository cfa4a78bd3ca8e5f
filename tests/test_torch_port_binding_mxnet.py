"""The port's MXNet binding (``horovod_tpu_torch/mxnet/``) against the
reference's (``horovod_tpu.mxnet``; ``tests/test_mxnet_api.py``).

MXNet is retired upstream and not installed: both packages run against
the reference's own fixture, ``tests/mxnet_shim.py`` (numpy only), the
NDArray / ``gluon.Trainer`` / optimizer surface the bindings touch.
Every test of ``tests/test_mxnet_api.py`` is mirrored with the same
inputs through both packages and compared **bit for bit** (one worker:
the reference's 8 CPU slots of one controller, the port's world of one
on the CPU).  On a 2-rank gloo world (``tests/torch_port_workers.py``,
the shim installed in each rank's process), ``DistributedTrainer.step``
applies the mean of the ranks' gradients, and the in-place allreduce and
broadcast agree with their sums.
"""

import sys

import numpy as np
import pytest

import horovod_tpu_torch as core
import mxnet_shim
import torch_port_workers as workers


def _drop_bindings():
    for m in list(sys.modules):
        if m.startswith(("horovod_tpu.mxnet", "horovod_tpu_torch.mxnet")):
            del sys.modules[m]


@pytest.fixture(scope="module")
def session():
    core.init(device="cpu")
    yield
    core.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


@pytest.fixture()
def mx(session):
    mod = mxnet_shim.install()
    _drop_bindings()
    yield mod
    mxnet_shim.uninstall()
    _drop_bindings()


def _both():
    import horovod_tpu.mxnet as ref
    import horovod_tpu_torch.mxnet as port

    return port, ref


def _same(a, b):
    """Bit for bit: NDArray or list of them, dtype, shape and values."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    x, y = a.asnumpy(), b.asnumpy()
    assert x.dtype == y.dtype and x.shape == y.shape, (x, y)
    np.testing.assert_array_equal(x, y)


def test_import_gated_without_mxnet():
    mxnet_shim.uninstall()
    _drop_bindings()
    with pytest.raises(ImportError, match="mxnet"):
        import horovod_tpu_torch.mxnet  # noqa: F401


class TestMpiOps:
    @pytest.mark.parametrize("op", ["Sum", "Average", "Min", "Max",
                                    "Product", "Adasum"])
    def test_allreduce_out_of_place(self, mx, op):
        port, ref = _both()
        x = np.arange(6, dtype=np.float32).reshape(2, 3) + 0.5
        got, want = (b.allreduce(mx.nd.array(x), op=getattr(b, op))
                     for b in (port, ref))
        assert isinstance(got, mx.nd.NDArray)
        _same(got, want)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                       np.int64])
    def test_allreduce_in_place_writes_back(self, mx, dtype):
        port, ref = _both()
        out = []
        for b in (port, ref):
            x = mx.nd.array(np.full((3,), 3, dtype))
            got = b.allreduce_(x, op=b.Sum, prescale_factor=1.0,
                               postscale_factor=2.0)
            assert got is x
            out.append(x)
        _same(*out)

    def test_grouped_allreduce(self, mx):
        port, ref = _both()
        xs = [np.full((2, 2), float(i + 1), np.float32) for i in range(3)]
        got, want = (b.grouped_allreduce([mx.nd.array(x) for x in xs],
                                         op=b.Sum) for b in (port, ref))
        _same(got, want)
        arrays = {}
        for name, b in (("port", port), ("ref", ref)):
            arrays[name] = [mx.nd.array(x) for x in xs]
            out = b.grouped_allreduce_(arrays[name], op=b.Average,
                                       postscale_factor=0.5)
            assert all(o is a for o, a in zip(out, arrays[name]))
        _same(arrays["port"], arrays["ref"])

    def test_async_handles(self, mx):
        port, ref = _both()
        out = []
        for b in (port, ref):
            x = mx.nd.array(np.arange(4, dtype=np.float32))
            h = b.allreduce_async_(x, op=b.Sum, postscale_factor=3.0)
            b.synchronize(h)
            assert b.poll(h)
            out.append(x)
        _same(*out)

    def test_allgather_broadcast_alltoall(self, mx):
        port, ref = _both()
        x = np.arange(4, dtype=np.float32).reshape(2, 2)
        for fn in (lambda b: b.allgather(mx.nd.array(x)),
                   lambda b: b.broadcast(mx.nd.array(x), root_rank=0),
                   lambda b: b.reducescatter(mx.nd.array(x), op=b.Sum)):
            _same(fn(port), fn(ref))
        got, want = (b.alltoall(mx.nd.array(x), mx.nd.array(np.array([2.0])))
                     for b in (port, ref))
        _same(got, want)
        assert list(got[1].asnumpy().astype(int)) == [2]

    def test_broadcast_parameters(self, mx):
        port, ref = _both()
        out = []
        for b in (port, ref):
            params = {
                "w": mx.Parameter("w", np.ones((2, 2), np.float32),
                                  np.zeros((2, 2), np.float32)),
                "b": mx.nd.array(np.arange(2, dtype=np.float32)),
            }
            b.broadcast_parameters(params, root_rank=0)   # in place
            out.append([params["w"].list_data()[0], params["b"]])
        _same(*out)
        assert port.broadcast_object({"k": 1}) == ref.broadcast_object(
            {"k": 1}) == {"k": 1}


class TestDistributedTrainer:
    @pytest.mark.parametrize("predivide", [1.0, 4.0])
    def test_step_applies_averaged_grads(self, mx, predivide):
        port, ref = _both()
        out = []
        for b in (port, ref):
            p = mx.Parameter("w", np.zeros((4,), np.float32),
                             np.array([8.0, 1.0, -3.0, 0.25], np.float32))
            trainer = b.DistributedTrainer(
                {"w": p}, "sgd", {"learning_rate": 0.5},
                gradient_predivide_factor=predivide)
            trainer.step(batch_size=1)
            out.append(p.list_data()[0])
        _same(*out)
        np.testing.assert_allclose(out[0].asnumpy(),
                                   [-4.0, -0.5, 1.5, -0.125])

    def test_num_groups_batches_grouped_calls(self, mx):
        port, ref = _both()
        out = []
        for b in (port, ref):
            ps = {f"p{i}": mx.Parameter(f"p{i}", np.zeros(3, np.float32),
                                        np.full(3, i + 1.0, np.float32))
                  for i in range(5)}
            trainer = b.DistributedTrainer(ps, "sgd",
                                           {"learning_rate": 1.0},
                                           num_groups=2)
            trainer.step(batch_size=1)
            out.append([p.list_data()[0] for p in ps.values()])
        _same(*out)

    def test_compression_other_than_none_is_refused(self, mx):
        """The binding reduces gradients uncompressed: a compressor it
        would not apply raises instead of going unused."""
        from horovod_tpu_torch.ops.compression import Compression

        port, _ = _both()
        for ok in (None, Compression.none):
            p = mx.Parameter("w", np.zeros(2, np.float32),
                             np.ones(2, np.float32))
            port.DistributedTrainer({"w": p}, "sgd", {"learning_rate": 1.0},
                                    compression=ok).step(batch_size=1)
            np.testing.assert_array_equal(p.list_data()[0].asnumpy(),
                                          [-1.0, -1.0])
        for bad in (Compression.fp16, Compression.int8):
            with pytest.raises(NotImplementedError, match="uncompressed"):
                port.DistributedTrainer({}, "sgd", {"learning_rate": 1.0},
                                        compression=bad)

    def test_optimizer_object_with_params_rejected(self, mx):
        for b in _both():
            with pytest.raises(ValueError, match="optimizer_params"):
                b.DistributedTrainer({}, mx.optimizer.SGD(),
                                     {"learning_rate": 1.0})


def test_two_ranks_trainer_applies_the_mean_gradient(world):
    """Rank r's gradient is ``g * (r + 1)``: SGD(lr) moves the weight by
    ``-lr * 1.5 g``; the in-place Sum is ``3 x`` and the broadcast rank
    0's ``x``."""
    g = np.random.RandomState(4).randn(5).astype(np.float32)
    x = np.random.RandomState(5).randn(2, 3).astype(np.float32)
    res = world.run("mxnet_trainer", grad=g, x=x, lr=0.25)
    for r in res:
        np.testing.assert_allclose(r["weight"], -0.25 * 1.5 * g, rtol=1e-6)
        np.testing.assert_array_equal(r["weight"], res[0]["weight"])
        np.testing.assert_array_equal(r["sum"], x * 3)
        np.testing.assert_array_equal(r["broadcast"], x)
