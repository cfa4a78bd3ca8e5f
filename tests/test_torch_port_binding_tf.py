"""The port's TF and Keras bindings (``horovod_tpu_torch/tensorflow/``,
``horovod_tpu_torch/keras/``) against the reference's
(``horovod_tpu.tensorflow``, ``horovod_tpu.keras``;
``tests/test_tf_api.py`` but its ``TestJitCompile``, and the TF and
Keras classes of ``tests/test_elastic_frameworks.py``).

At one worker, in-process, bit for bit: the collectives eagerly and
inside ``tf.function`` (alltoall's splits too), the weights after
``model.fit`` on the same seeded Keras model and data, the gradient
tape, ``num_groups``, ``backward_passes_per_step`` with ``None``
gradients, the four callbacks, and ``TensorFlowKerasState``'s commit,
restore, sync, ``save_to`` and ``load_from`` (a bf16 variable too).
Under ``jit_compile=True`` the allgather's error is pinned (dense
allreduce compiles through the TF-XLA adapter, held in
``tests/test_torch_port_tf_xla.py``).  The dense allreduce's routes:
the bridge when eager, the adapter's op in graphs, and, with the
adapter made unavailable, ``tf.py_function`` in a plain graph (bit for
bit the reference's) and an error naming the load failure under
``jit_compile=True``.  On a 2-rank gloo world
(``tests/torch_port_workers.py``, TF imported in each rank's own
process): a Keras MLP fit through the port's binding against the same
model stepped in one process on the concatenated batch (1e-6).  In a
subprocess with tensorflow, keras, ml_dtypes, jax and ``horovod_tpu``
hidden: every port module outside ``tensorflow/`` and ``keras/``
imports, ``python -m horovod_tpu_torch.analysis`` runs, and
``import horovod_tpu_torch.tensorflow`` raises an ``ImportError`` that
names tensorflow (``horovod_tpu_torch.mxnet`` one that names mxnet).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import tensorflow as tf

import horovod_tpu.keras as ref_keras
import horovod_tpu.tensorflow as ref
import horovod_tpu_torch.keras as hk
import horovod_tpu_torch.tensorflow as hvd
import horovod_tpu_torch.tensorflow.keras as hvdk

import torch_port_workers as workers

BINDINGS = {"ref": ref, "port": hvd}


@pytest.fixture(scope="module")
def session():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Two ranks, spawned first so that their import of tensorflow
    overlaps the in-process tests."""
    w = workers.World(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    w.submit("import_tensorflow")
    yield w
    w.close()


@pytest.fixture(scope="module", autouse=True)
def reference_without_its_xla_adapter():
    """The reference as it runs where its TF-XLA adapter is unavailable
    (``xla_ops.available()`` False: every collective on its py_function
    bridge), the mode the port's binding has; it also spares the
    adapter's first trace."""
    import horovod_tpu.tensorflow.xla_ops as xla_ops

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xla_ops, "available", lambda: False)
        yield


def _same(a, b):
    """Bit for bit: type (IndexedSlices or tensor), dtype, shape and
    every element."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, tf.IndexedSlices):
        assert isinstance(b, tf.IndexedSlices)
        _same(a.values, b.values)
        _same(a.indices, b.indices)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    np.testing.assert_array_equal(a, b)


def _both(fn):
    return fn(hvd), fn(ref)


def _mlp_weights(d_in=3, d_out=2, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(d_in, 16) * 0.5).astype(np.float32),
            (rng.randn(16) * 0.1).astype(np.float32),
            (rng.randn(16, d_out) * 0.5).astype(np.float32),
            (rng.randn(d_out) * 0.1).astype(np.float32)]


def _mlp(d_in=3, d_out=2, seed=0):
    model = workers.keras_mlp(d_in, d_out)
    model.set_weights(_mlp_weights(d_in, d_out, seed))
    return model


def _data(n=16, d_in=3, d_out=2, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d_in).astype(np.float32),
            rng.randn(n, d_out).astype(np.float32))


# --- the collectives ------------------------------------------------------------

@pytest.mark.usefixtures("session")
class TestSingleWorkerOps:
    def test_world(self):
        assert hvd.size() == ref.size() == 1
        assert hvd.rank() == ref.rank() == 0
        assert hk.size() == 1 and hvdk.rank() == 0

    @pytest.mark.parametrize("op", [hvd.Average, hvd.Sum, hvd.Min, hvd.Max,
                                    hvd.Product, hvd.Adasum])
    def test_allreduce_identity(self, op):
        t = tf.reshape(tf.range(6, dtype=tf.float32) + 1, (2, 3))
        _same(*_both(lambda b: b.allreduce(t, op=op)))

    @pytest.mark.parametrize("dtype", [tf.float32, tf.float64, tf.float16,
                                       tf.bfloat16, tf.int32, tf.int64])
    def test_allreduce_dtypes(self, dtype):
        t = tf.cast(tf.range(4) + 1, dtype)
        _same(*_both(lambda b: b.allreduce(t, op=b.Sum)))
        _same(*_both(lambda b: b.allreduce(t, op=b.Average)))

    def test_allreduce_scalar(self):
        got, want = _both(lambda b: b.allreduce(tf.constant(3.0)))
        _same(got, want)
        assert got.shape == ()

    def test_allreduce_scales(self):
        t = tf.constant([1.0, -2.0, 3.5])
        _same(*_both(lambda b: b.allreduce(t, op=b.Sum, prescale_factor=2.0,
                                           postscale_factor=0.25)))

    @pytest.mark.parametrize("comp", ["fp16", "true_fp16"])
    def test_allreduce_compression(self, comp):
        t = tf.constant(np.random.RandomState(0).randn(5).astype(np.float32))
        got, want = _both(lambda b: b.allreduce(
            t, op=b.Sum, compression=getattr(b.Compression, comp)))
        _same(got, want)
        assert got.dtype == tf.float32
        assert not np.array_equal(got.numpy(), t.numpy())

    def test_grouped_allreduce(self):
        ts = [tf.ones((2,)), tf.range(3, dtype=tf.float32),
              tf.constant([1, 2], tf.int32)]
        _same(*_both(lambda b: b.grouped_allreduce(ts, op=b.Sum)))
        _same(*_both(lambda b: b.grouped_allreduce(
            ts, compression=b.Compression.fp16)))

    def test_allgather_and_broadcast(self):
        t = tf.reshape(tf.range(6, dtype=tf.float32), (3, 2))
        _same(*_both(lambda b: b.allgather(t)))
        _same(*_both(lambda b: b.grouped_allgather([t, t[:1]])))
        i = tf.constant([1, 2, 3], dtype=tf.int32)
        _same(*_both(lambda b: b.broadcast(i, root_rank=0)))

    def test_alltoall(self):
        t = tf.range(4, dtype=tf.float32)
        _same(*_both(lambda b: b.alltoall(t)))
        _same(*_both(lambda b: b.alltoall(tf.range(3, dtype=tf.float32),
                                          splits=tf.constant([3]))))

    def test_reducescatter(self):
        _same(*_both(lambda b: b.reducescatter(
            tf.range(4, dtype=tf.float32), op=b.Sum)))
        ts = [tf.range(4, dtype=tf.float32), tf.ones((2, 3))]
        _same(*_both(lambda b: b.grouped_reducescatter(ts, op=b.Sum)))

    def test_allreduce_indexed_slices(self):
        g = tf.IndexedSlices(values=tf.ones((2, 3)) * 3,
                             indices=tf.constant([0, 2]),
                             dense_shape=tf.constant([4, 3]))
        _same(*_both(lambda b: b.allreduce(g, prescale_factor=0.5)))
        with pytest.raises(NotImplementedError, match="IndexedSlices"):
            hvd.allreduce(g, op=hvd.Adasum)

    def test_barrier_and_join(self):
        hvd.barrier()
        assert hvd.join() == hvd.size() - 1 == 0

    def test_objects(self):
        assert hvd.broadcast_object({"a": 1}) == {"a": 1}
        assert hvd.allgather_object(7) == [7]

    def test_inside_tf_function(self):
        def step(x):
            return [b.allreduce(x, op=b.Sum) for b in (hvd, ref)]

        out, want = tf.function(step)(tf.constant([1.0, 2.0]))
        _same(out, want)

    def test_collectives_chain_in_trace_order(self):
        """Inside a graph each collective waits for the previous one (the
        allreduce is the TF-XLA adapter's op, the allgather a
        ``tf.py_function``)."""
        @tf.function
        def step(x):
            a = hvd.allreduce(x, op=hvd.Sum)
            b = hvd.allgather(x)
            return a, b

        graph = step.get_concrete_function(
            tf.TensorSpec([2], tf.float32)).graph
        calls = [op for op in graph.get_operations()
                 if op.type in ("HvdTpuTorchAllreduce", "EagerPyFunc")]
        assert [op.type for op in calls] == ["HvdTpuTorchAllreduce",
                                             "EagerPyFunc"]
        assert calls[0] in calls[1].control_inputs
        a, b = step(tf.constant([1.0, 2.0]))
        _same(a, b)

    def test_alltoall_splits_inside_tf_function(self):
        @tf.function
        def step(x, s):
            return [b.alltoall(x, splits=s) for b in (hvd, ref)]

        got, want = step(tf.range(3, dtype=tf.float32), tf.constant([3]))
        _same(got, want)

    def test_broadcast_variables(self):
        for b in BINDINGS.values():
            v = tf.Variable([1.0, 2.0])
            f = tf.Variable([True, False])
            w = tf.Variable(tf.cast([1.5, -2.0], tf.bfloat16))
            b.broadcast_variables([v, f, w], root_rank=0)
            np.testing.assert_array_equal(v.numpy(), [1.0, 2.0])
            assert f.numpy().tolist() == [True, False]
            assert w.numpy().tolist() == [1.5, -2.0]


@pytest.mark.usefixtures("session")
class TestOpConstants:
    def test_world_fact_ops(self):
        for b in BINDINGS.values():
            assert int(b.size_op()) == 1
            assert int(b.rank_op()) == 0
            assert int(b.local_rank_op()) == 0
            assert int(b.process_set_included_op()) == 1
            assert b.size_op().dtype == tf.int32
        # The reference counts its mesh's slots (8); the port's ranks are
        # processes.
        assert int(hvd.local_size_op()) == hvd.local_size() == 1

    def test_ops_usable_in_graph(self):
        @tf.function
        def f(x):
            return x * tf.cast(hvd.size_op(), tf.float32) + \
                tf.cast(hvd.rank_op(), tf.float32)

        assert float(f(tf.constant(3.0))) == 3.0


@pytest.mark.usefixtures("session")
class TestJitCompileError:
    """Under ``jit_compile=True`` the TF-XLA adapter covers dense allreduce
    only: a collective outside it raises, naming the way out."""

    @pytest.mark.parametrize("kind", ["allgather"])
    def test_collective_under_jit_compile_names_the_adapter(self, kind):
        @tf.function(jit_compile=True)
        def f(x):
            return hvd.allgather(x)

        with pytest.raises(NotImplementedError,
                           match=r"jit_compile=True\) the TF-XLA adapter "
                                 r"\(tensorflow/xla_ops.py\) covers dense "
                                 r"allreduce only; densify sparse gradients "
                                 r"\(sparse_as_dense=True\) or trace this "
                                 r"collective with a plain tf.function"):
            f(tf.ones((2,)))


@pytest.fixture()
def adapter_unavailable(monkeypatch):
    """The port as it runs where its TF-XLA adapter did not build."""
    from horovod_tpu_torch.tensorflow import xla_ops

    monkeypatch.setattr(xla_ops, "available", lambda: False)
    monkeypatch.setattr(xla_ops, "load_error",
                        lambda: "g++ exited with status 1")


def _graph_collectives(fn, *specs):
    graph = tf.function(fn).get_concrete_function(*specs).graph
    return [op.type for op in graph.get_operations()
            if op.type in ("HvdTpuTorchAllreduce", "EagerPyFunc")]


@pytest.mark.usefixtures("session")
class TestAdapterRoutes:
    """Which route a dense allreduce takes: the bridge when eager, the
    adapter's op inside a graph where it loaded, ``tf.py_function`` in a
    plain graph where it did not, and an error naming the load failure
    under ``jit_compile=True`` then."""

    def test_eager_calls_take_the_bridge(self, monkeypatch):
        from horovod_tpu_torch.tensorflow import mpi_ops, xla_ops

        def no_op(*_args, **_kwargs):
            raise AssertionError("an eager call took the adapter's route")

        monkeypatch.setattr(xla_ops, "allreduce", no_op)
        monkeypatch.setattr(mpi_ops, "_native_bridge", no_op)
        t = tf.constant([1.0, -2.0, 3.5])
        ts = [t, tf.constant([1, 2], tf.int32)]
        _same(*_both(lambda b: b.allreduce(t, op=b.Sum,
                                           prescale_factor=2.0)))
        _same(*_both(lambda b: b.grouped_allreduce(ts, op=b.Sum)))

    def test_graphs_take_the_adapter_where_it_loaded(self):
        assert _graph_collectives(
            lambda x, y: hvd.grouped_allreduce([x, y], op=hvd.Sum),
            tf.TensorSpec([3], tf.float32),
            tf.TensorSpec([2], tf.int32)) == ["HvdTpuTorchAllreduce"] * 2

    @pytest.mark.usefixtures("adapter_unavailable")
    def test_plain_graphs_take_py_function_without_the_adapter(self):
        x = tf.constant([1.0, -2.0, 3.5])
        i = tf.constant([1, 2], tf.int32)
        v = tf.Variable([0.5, 1.5, -1.0])

        def step(b):
            def f(x, i):
                with tf.GradientTape() as tape:
                    loss = tf.reduce_sum(v * v * x)
                grad = b.DistributedGradientTape(tape).gradient(loss, v)
                return ([b.allreduce(x, op=b.Sum, postscale_factor=0.5)]
                        + b.grouped_allreduce([x, i], op=b.Sum) + [grad])
            return f

        specs = (tf.TensorSpec([3], tf.float32), tf.TensorSpec([2], tf.int32))
        assert set(_graph_collectives(step(hvd), *specs)) == {"EagerPyFunc"}
        _same(tf.function(step(hvd))(x, i), tf.function(step(ref))(x, i))

    @pytest.mark.usefixtures("adapter_unavailable")
    @pytest.mark.parametrize("kind", ["allreduce", "grouped"])
    def test_jit_compile_without_the_adapter_names_its_load_error(self,
                                                                  kind):
        @tf.function(jit_compile=True)
        def f(x):
            if kind == "allreduce":
                return hvd.allreduce(x, name="dense")
            return hvd.grouped_allreduce([x, x], name="dense")[0]

        with pytest.raises(NotImplementedError,
                           match=r"dense: inside tf.function\(jit_compile="
                                 r"True\) a dense allreduce needs the TF-XLA "
                                 r"adapter \(tensorflow/xla_ops.py\), which "
                                 r"did not load: g\+\+ exited with status 1"):
            f(tf.ones((2,)))

    def test_jit_compile_names_a_dtype_the_adapter_does_not_take(self):
        @tf.function(jit_compile=True)
        def f(x):
            return hvd.allreduce(x, op=hvd.Sum, name="bytes")

        with pytest.raises(NotImplementedError,
                           match=r"bytes: .* which does not take uint8"):
            f(tf.ones((2,), tf.uint8))


# --- the optimizer and the tape ---------------------------------------------------

def _fit(b, opt_fn, *, compression="none", num_groups=0, bpps=1,
         epochs=2, callbacks_fn=None):
    model = _mlp()
    opt = b.DistributedOptimizer(
        opt_fn(), compression=getattr(b.Compression, compression),
        num_groups=num_groups, backward_passes_per_step=bpps)
    model.compile(optimizer=opt, loss="mse", jit_compile=False)
    x, y = _data()
    cbs = callbacks_fn(b) if callbacks_fn else None
    hist = model.fit(x, y, epochs=epochs, batch_size=4, shuffle=False,
                     verbose=0, callbacks=cbs)
    return model, hist


_FIT_CASES = {
    "sgd": (lambda: tf.keras.optimizers.SGD(0.1), "none", 0, 1),
    "adam-fp16": (lambda: tf.keras.optimizers.Adam(1e-2), "fp16", 0, 1),
    "sgd-momentum-groups2": (
        lambda: tf.keras.optimizers.SGD(0.1, momentum=0.9), "none", 2, 1),
    "adam-bpps2": (lambda: tf.keras.optimizers.Adam(1e-2), "none", 0, 2),
}


@pytest.mark.usefixtures("session")
class TestDistributedOptimizer:
    @pytest.mark.parametrize("case", sorted(_FIT_CASES))
    def test_fit_weights_bitwise(self, case):
        opt_fn, comp, groups, bpps = _FIT_CASES[case]
        (m, h), (rm, rh) = _both(lambda b: _fit(
            b, opt_fn, compression=comp, num_groups=groups, bpps=bpps))
        _same(m.get_weights(), rm.get_weights())
        assert h.history["loss"] == rh.history["loss"]
        assert not np.array_equal(m.get_weights()[0], _mlp_weights()[0])

    def test_wraps_and_applies(self):
        outs = []
        for b in (hvd, ref):
            m = _mlp()
            opt = b.DistributedOptimizer(tf.keras.optimizers.SGD(0.1))
            assert isinstance(opt, tf.keras.optimizers.SGD)
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(m(tf.ones((1, 3))))
            grads = tape.gradient(loss, m.trainable_variables)
            opt.apply_gradients(zip(grads, m.trainable_variables))
            outs.append(m.get_weights())
        _same(outs[0], outs[1])

    def test_num_groups_negative_rejected_and_double_wrap(self):
        m = _mlp()
        opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                       num_groups=-1)
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(m(tf.ones((1, 3))))
        grads = tape.gradient(loss, m.trainable_variables)
        with pytest.raises(ValueError, match="num_groups"):
            opt.apply_gradients(zip(grads, m.trainable_variables))
        wrapped = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.1))
        with pytest.raises(ValueError, match="already distributed"):
            hvd.DistributedOptimizer(wrapped)

    @pytest.mark.parametrize("num_groups", [0, 2])
    def test_gradient_tape(self, num_groups):
        def grads(b):
            m = _mlp()
            x, y = _data()
            with b.DistributedGradientTape(tf.GradientTape(),
                                           num_groups=num_groups) as tape:
                loss = tf.reduce_mean((m(x) - y) ** 2)
            return tape.gradient(loss, m.trainable_variables)

        _same(*_both(grads))

    def test_gradient_tape_indexed_slices(self):
        def grads(b):
            tf.keras.utils.set_random_seed(0)
            emb = tf.keras.layers.Embedding(10, 3)
            emb.build((None,))
            emb.embeddings.assign(
                np.random.RandomState(0).randn(10, 3).astype(np.float32))
            with b.DistributedGradientTape(tf.GradientTape()) as tape:
                loss = tf.reduce_sum(emb(tf.constant([1, 4, 4])) ** 2)
            return tape.gradient(loss, [emb.embeddings])

        got, want = _both(grads)
        assert isinstance(got[0], tf.IndexedSlices)
        _same(got, want)

    def test_backward_passes_per_step(self):
        outs = []
        for b in (hvd, ref):
            m = _mlp()
            opt = b.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                         backward_passes_per_step=2)
            w0 = m.get_weights()
            g1 = [tf.ones_like(v) for v in m.trainable_variables]
            g2 = [3.0 * tf.ones_like(v) for v in m.trainable_variables]
            opt.apply(g1, m.trainable_variables)        # accumulated only
            _same(m.get_weights(), w0)
            opt.apply(g2, m.trainable_variables)        # the mean applied
            opt.apply(g1, m.trainable_variables)        # accumulated again
            outs.append(m.get_weights())
        _same(outs[0], outs[1])
        np.testing.assert_allclose(outs[0][1], _mlp_weights()[1] - 0.2,
                                   atol=1e-6)

    def test_backward_passes_with_none_grad(self):
        outs = []
        for b in (hvd, ref):
            m = _mlp()
            extra = tf.Variable([1.0], name="unconnected")
            opt = b.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                         backward_passes_per_step=2)
            g = [tf.ones_like(v) for v in m.trainable_variables] + [None]
            opt.apply(g, m.trainable_variables + [extra])
            opt.apply(g, m.trainable_variables + [extra])
            np.testing.assert_array_equal(extra.numpy(), [1.0])
            outs.append(m.get_weights())
        _same(outs[0], outs[1])


# --- callbacks ----------------------------------------------------------------------

_CALLBACKS = {
    "broadcast": lambda b: [
        b.keras.callbacks.BroadcastGlobalVariablesCallback(root_rank=0)],
    "metric_average": lambda b: [b.keras.callbacks.MetricAverageCallback()],
    "warmup": lambda b: [b.keras.callbacks.LearningRateWarmupCallback(
        initial_lr=0.1, warmup_epochs=2)],
    "schedule": lambda b: [b.keras.callbacks.LearningRateScheduleCallback(
        initial_lr=0.1, multiplier=lambda e: 0.5 ** e, staircase=True)],
}


@pytest.mark.usefixtures("session")
class TestKerasCallbacks:
    @pytest.mark.parametrize("which", sorted(_CALLBACKS))
    def test_fit_with_callback_bitwise(self, which):
        def sgd():
            return tf.keras.optimizers.SGD(0.1, momentum=0.9)

        (m, h), (rm, rh) = _both(lambda b: _fit(
            b, sgd, epochs=3, callbacks_fn=_CALLBACKS[which]))
        _same(m.get_weights(), rm.get_weights())
        assert h.history == rh.history
        assert float(m.optimizer.learning_rate.numpy()) == \
            float(rm.optimizer.learning_rate.numpy())

    def test_momentum_correction(self):
        from horovod_tpu.tensorflow.keras.callbacks import _set_lr as ref_set
        from horovod_tpu_torch.tensorflow.keras.callbacks import _set_lr

        outs = []
        for set_lr in (_set_lr, ref_set):
            v = tf.Variable([1.0, 2.0])
            opt = tf.keras.optimizers.SGD(0.1, momentum=0.9)
            opt.build([v])
            opt.apply([tf.ones((2,))], [v])
            set_lr(opt, 0.2, momentum_correction=True)
            outs.append([x.numpy() for x in opt.variables])
        _same(outs[0], outs[1])

    def test_standalone_keras_alias(self):
        assert hk.DistributedOptimizer is hvdk.DistributedOptimizer
        assert hk.callbacks is hvdk.callbacks
        assert set(n for n in dir(ref_keras) if not n.startswith("_")) <= \
            set(dir(hk))


# --- elastic --------------------------------------------------------------------------

def _compiled(seed=0, bf16_head=False):
    if bf16_head:
        model = tf.keras.Sequential([
            tf.keras.Input(shape=(3,)),
            tf.keras.layers.Dense(16, activation="tanh"),
            tf.keras.layers.Dense(2, dtype="bfloat16")])
        model.set_weights([np.asarray(w, v.dtype) for w, v in
                           zip(_mlp_weights(seed=seed), model.weights)])
    else:
        model = _mlp(seed=seed)
    opt = tf.keras.optimizers.SGD(0.1, momentum=0.9)
    model.compile(optimizer=opt, loss="mse", jit_compile=False)
    return model, opt


@pytest.mark.usefixtures("session")
class TestTensorFlowKerasState:
    def test_commit_restore_roundtrip(self):
        from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState

        model, opt = _compiled()
        x, y = _data()
        model.fit(x, y, epochs=1, verbose=0, shuffle=False)
        state = TensorFlowKerasState(model=model, optimizer=opt,
                                     batch=2, epoch=1)
        w1 = [w.copy() for w in model.get_weights()]
        model.set_weights([w + 100.0 for w in model.get_weights()])
        state.batch = 77
        state.restore()
        _same(model.get_weights(), w1)
        assert state.batch == 2 and state.epoch == 1

    def test_sync(self):
        from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState

        model, opt = _compiled()
        x, y = _data()
        model.fit(x, y, epochs=1, verbose=0, shuffle=False)
        w = model.get_weights()
        state = TensorFlowKerasState(model=model, optimizer=opt, batch=3)
        state.sync()
        _same(model.get_weights(), w)
        assert state.batch == 3

    def test_restore_resets_late_created_slot_vars(self):
        from horovod_tpu_torch.tensorflow.elastic import (
            _NON_STATE_HINTS, TensorFlowKerasState, _named_optimizer_variables,
        )

        model, opt = _compiled()
        state = TensorFlowKerasState(model=model, optimizer=opt, batch=0)
        x, y = _data()
        model.fit(x, y, epochs=1, verbose=0, shuffle=False)
        late = [(k, v) for k, v in _named_optimizer_variables(opt)
                if k not in state._opt_saved]
        assert late
        state.restore()
        for key, var in late:
            if any(h in key for h in _NON_STATE_HINTS):
                assert float(np.asarray(var)) != 0.0, key
            else:
                np.testing.assert_array_equal(np.asarray(var), 0.0,
                                              err_msg=key)

    def test_restore_matches_by_name_against_the_reference(self):
        """Commit after a step, train on, restore: both states put every
        committed variable back by name; the two models agree bit for
        bit."""
        from horovod_tpu.tensorflow.elastic import \
            TensorFlowKerasState as RefState
        from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState

        outs = []
        for cls in (TensorFlowKerasState, RefState):
            model, opt = _compiled()
            x, y = _data()
            model.fit(x, y, epochs=1, verbose=0, shuffle=False)
            state = cls(model=model, optimizer=opt, batch=0)
            model.fit(x, y, epochs=2, verbose=0, shuffle=False)
            state.restore()
            outs.append(model.get_weights()
                        + [np.array(v) for v in opt.variables])
        _same(outs[0], outs[1])

    def test_durable_roundtrip_with_a_bf16_variable(self, tmp_path):
        from horovod_tpu_torch.checkpoint import Checkpointer
        from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState

        model, opt = _compiled(bf16_head=True)
        x, y = _data()
        model.fit(x, y, epochs=1, verbose=0, shuffle=False)
        assert any(w.dtype == tf.bfloat16.as_numpy_dtype
                   for w in model.get_weights())
        state = TensorFlowKerasState(model=model, optimizer=opt, batch=5)
        want = [w.copy() for w in model.get_weights()]
        want_opt = {k: v.copy() for k, v in state._opt_saved.items()}
        ckpt = Checkpointer(str(tmp_path))
        state.save_to(ckpt, step=1)

        model2, opt2 = _compiled(seed=3, bf16_head=True)
        model2.fit(x, y, epochs=1, verbose=0, shuffle=False)
        state2 = TensorFlowKerasState(model=model2, optimizer=opt2, batch=0)
        state2.load_from(ckpt, step=1)
        _same(model2.get_weights(), want)
        assert state2.batch == 5
        for key, var in state2._opt_saved.items():
            _same(var, want_opt[key])


@pytest.mark.usefixtures("session")
def test_elastic_keras_callbacks():
    from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState
    from horovod_tpu_torch.tensorflow.keras.elastic import (
        CommitStateCallback, KerasState, UpdateBatchStateCallback,
        UpdateEpochStateCallback,
    )

    assert KerasState is TensorFlowKerasState
    model, _ = _compiled()
    state = TensorFlowKerasState(model=model, batch=0, epoch=0)
    commits = []
    orig_commit = state.commit
    state.commit = lambda: (commits.append(True), orig_commit())[1]
    x, y = _data(32)
    model.fit(x, y, batch_size=8, epochs=2, verbose=0, callbacks=[
        CommitStateCallback(state, batches_per_commit=2),
        UpdateBatchStateCallback(state),
        UpdateEpochStateCallback(state),
    ])
    assert len(commits) == 4
    assert state.epoch == 2
    assert state.batch == 0


# --- two ranks --------------------------------------------------------------------------

def test_keras_fit_two_ranks_matches_one_process_on_the_concatenated_batch(
        world):
    """Each rank fits its half (batches of 4, in order); one process fits
    the same model with plain SGD on batches of 8, each the two ranks'
    batches of that step concatenated: the weights agree to 1e-6."""
    x, y = _data(32, 4, 2, seed=3)
    weights = _mlp_weights(4, 2, seed=2)
    world.collect("import_tensorflow")
    res = world.run("keras_fit", x=x, y=y, weights=weights, lr=0.05,
                    epochs=2, batch_size=4)
    for a, b in zip(res[0], res[1]):
        np.testing.assert_array_equal(a, b)
    order = np.concatenate([np.r_[4 * k:4 * k + 4, 16 + 4 * k:20 + 4 * k]
                            for k in range(4)])
    model = workers.keras_mlp(4, 2)
    model.set_weights(weights)
    model.compile(optimizer=tf.keras.optimizers.SGD(0.05), loss="mse",
                  jit_compile=False)
    model.fit(x[order], y[order], epochs=2, batch_size=8, shuffle=False,
              verbose=0)
    for got, want in zip(res[0], model.get_weights()):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- what a host without tensorflow sees ---------------------------------------------------

_ISOLATED = textwrap.dedent("""
    import importlib, pkgutil, runpy, sys
    for name in ("tensorflow", "keras", "ml_dtypes", "jax", "horovod_tpu"):
        sys.modules[name] = None
    import horovod_tpu_torch
    import horovod_tpu_torch.torch as hvd
    assert hvd.DistributedOptimizer and hvd.SyncBatchNorm
    skipped = ("horovod_tpu_torch.tensorflow", "horovod_tpu_torch.keras",
               "horovod_tpu_torch.mxnet")
    n = 0
    for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                   "horovod_tpu_torch."):
        if m.name.startswith(skipped) or m.name.endswith("__main__"):
            continue
        importlib.import_module(m.name)
        n += 1
    for name in skipped:
        try:
            importlib.import_module(name)
        except ImportError as e:
            assert ("mxnet" if name.endswith("mxnet") else "tensorflow") \
                in str(e), e
        else:
            raise AssertionError(name + " imported without tensorflow")
    print("modules", n)
    sys.argv = ["hvdlint"]
    try:
        runpy.run_module("horovod_tpu_torch.analysis", run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e.code
""")


def test_isolation_without_tensorflow():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert int(out.stdout.split("modules")[1].split()[0]) > 100
    assert "clean" in out.stdout
