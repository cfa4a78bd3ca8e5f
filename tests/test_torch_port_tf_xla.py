"""The port's TF-XLA adapter (``horovod_tpu_torch/tensorflow/xla_ops.py``
with ``native/src/tf_xla_ops.cc``) against the reference's
(``horovod_tpu/tensorflow/xla_ops.py``; ``tests/test_tf_api.py``'s
``TestJitCompile``).

TF freezes its XLA kernel registry at the first XLA compile of a
process, so the ``jit_compile=True`` cases run in a fresh interpreter
that imports both ``horovod_tpu.tensorflow`` and
``horovod_tpu_torch.tensorflow`` (both adapters preload, under distinct
op and custom-call names) before anything compiles.  It runs every case
through both packages on the same numpy inputs and returns the results;
the tests compare them **bit for bit** (one worker: the reference's 8
CPU slots of one controller, the port's world of one on the CPU), and
check that each compiled graph holds its package's own op.  The Keras
case fits the same seeded MLP under ``model.compile(...,
jit_compile=True)`` through each package's ``DistributedOptimizer``:
equal losses and weights.  On a 2-rank gloo world
(``tests/torch_port_workers.py``), a real reduction through the op:
every dtype (f32, f64, f16, bf16, i32, i64) × op (Sum, Average, Min,
Max, Product), the float dtypes' pre- and post-scaled Sum and Average,
a mixed-dtype grouped call (the per-dtype concatenation and split) and
Adasum alone and grouped, each compiled equal to the eager call bit for
bit and to a numpy oracle (exact on small integers; Adasum within 1e-6
of the float64 pair rule).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_port_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import tensorflow as tf
    import horovod_tpu
    import horovod_tpu.tensorflow as ref
    import horovod_tpu.tensorflow.keras as ref_keras
    import horovod_tpu_torch.tensorflow as port
    import horovod_tpu_torch.tensorflow.keras as port_keras
    from horovod_tpu.tensorflow import xla_ops as ref_xla
    from horovod_tpu_torch.tensorflow import xla_ops as port_xla
    import torch_port_workers as workers

    horovod_tpu.init()
    port.init(device="cpu")
    BINDINGS = {"port": (port, port_keras, "HvdTpuTorchAllreduce"),
                "ref": (ref, ref_keras, "HvdTpuAllreduce")}
    rng = np.random.RandomState(0)
    A = rng.randn(3, 5).astype(np.float32)
    B = rng.randn(7).astype(np.float32)
    I = rng.randint(-50, 50, size=(4,)).astype(np.int32)
    DTYPES = ("float32", "float64", "float16", "bfloat16", "int32", "int64")

    def arrays(out):
        if isinstance(out, (list, tuple)):
            return [arrays(o) for o in out]
        return (out.dtype.name, np.asarray(out.numpy()).tolist()
                if out.dtype == tf.bfloat16 else np.asarray(out.numpy()))

    def compiled(fn, *args):
        f = tf.function(fn, jit_compile=True)
        ops = {op.type for op in f.get_concrete_function(
            *args).graph.get_operations()}
        return arrays(f(*args)), sorted(o for o in ops
                                        if o.startswith("HvdTpu"))

    def case_allreduce(b, dtype, op):
        x = tf.cast(tf.constant(A * 4), dtype)
        return compiled(lambda v: b.allreduce(v, op=getattr(b, op)) * 2, x)

    def case_grouped_and_tape(b):
        v = tf.Variable(A)
        w = tf.Variable(B)

        def step():
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(v * v) + tf.reduce_sum(w * w * w)
            tape = b.DistributedGradientTape(tape)
            gv, gw = tape.gradient(loss, [v, w])
            return (gv, gw) + tuple(b.grouped_allreduce([v, w], op=b.Sum))

        return compiled(step)

    def case_mixed(b):
        return compiled(lambda x, y: b.grouped_allreduce([x, y], op=b.Sum),
                        tf.constant(A), tf.constant(I))

    def case_fp16(b):
        return compiled(lambda x: b.allreduce(
            x, op=b.Average, compression=b.Compression.fp16),
            tf.constant(A * 1000))

    def case_adasum(b):
        return compiled(lambda x, y: b.grouped_allreduce([x, y],
                                                         op=b.Adasum),
                        tf.constant(A), tf.constant(B))

    def case_keras(b, k):
        x, y = workers_data()
        model = workers.keras_mlp(4, 2)
        model.set_weights(mlp_weights())
        model.compile(optimizer=k.DistributedOptimizer(
            tf.keras.optimizers.SGD(0.05)), loss="mse", jit_compile=True)
        h = model.fit(x, y, epochs=3, batch_size=4, shuffle=False,
                      verbose=0)
        return ([("loss", np.asarray(h.history["loss"], np.float64))]
                + [("w", w) for w in model.get_weights()]), []

    def workers_data():
        r = np.random.RandomState(1)
        return (r.randn(16, 4).astype(np.float32),
                r.randn(16, 2).astype(np.float32))

    def mlp_weights():
        r = np.random.RandomState(2)
        return [(r.randn(4, 16) * 0.5).astype(np.float32),
                (r.randn(16) * 0.1).astype(np.float32),
                (r.randn(16, 2) * 0.5).astype(np.float32),
                (r.randn(2) * 0.1).astype(np.float32)]

    def case_allgather(b):
        try:
            compiled(lambda x: b.allgather(x), tf.constant(A))
        except Exception as e:
            return [("error", type(e).__name__ + ": " + str(e))], []
        return [("error", "")], []

    out = {"available": {"port": port_xla.available(),
                         "ref": ref_xla.available()},
           "load_error": port_xla.load_error(),
           # At one worker every op is the identity: the step's x * 2.
           "identity": {d: arrays(tf.cast(tf.constant(A * 4), d) * 2)
                        for d in DTYPES}}
    for name, (b, k, own) in BINDINGS.items():
        res = {}
        for dtype in DTYPES:
            for op in ("Sum", "Average", "Min", "Max", "Product"):
                try:
                    got = case_allreduce(b, dtype, op)
                except Exception as e:
                    got = type(e).__name__ + ": " + str(e)
                res[f"allreduce-{dtype}-{op}"] = got
        res["grouped-tape"] = case_grouped_and_tape(b)
        res["mixed-dtype-grouped"] = case_mixed(b)
        res["fp16"] = case_fp16(b)
        res["adasum-grouped"] = case_adasum(b)
        res["keras-fit"] = case_keras(b, k)
        res["allgather"] = case_allgather(b)
        out[name] = res
        out[name + "-own"] = own
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    port.shutdown()
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two ranks, spawned first so that their import of tensorflow
    overlaps the subprocess."""
    w = workers.World(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    w.submit("import_tensorflow")
    yield w
    w.close()


@pytest.fixture(scope="module")
def results(world, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tf_xla") / "out.pkl")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]),
        "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, path], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _same(a, b):
    """Bit for bit: (dtype name, values) pairs, nested in lists."""
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a[0] == b[0], (a, b)
    x, y = np.asarray(a[1]), np.asarray(b[1])
    assert x.dtype == y.dtype and x.shape == y.shape, (a, b)
    np.testing.assert_array_equal(x, y)


def test_both_adapters_load(results):
    assert results["available"] == {"port": True, "ref": True}, \
        results["load_error"]


_ALLREDUCE = [f"allreduce-{d}-{op}"
              for d in ("float32", "float64", "float16", "bfloat16",
                        "int32", "int64")
              for op in ("Sum", "Average", "Min", "Max", "Product")]


# The reference's host tier fails Min and Max on bfloat16 (numpy has no
# bfloat16, and its reduction meets ml_dtypes' void-typed view); the
# port's result is then held to the identity alone.
_REFERENCE_FAILS = {"allreduce-bfloat16-Min", "allreduce-bfloat16-Max"}


@pytest.mark.parametrize("case", _ALLREDUCE)
def test_jit_compiled_allreduce_matches_the_reference(results, case):
    """Each dtype and op: the compiled step's output is the identity's
    (one worker) and the reference's, bit for bit, and each compiled
    graph holds its own package's adapter op only."""
    got, got_ops = results["port"][case]
    _same(got, results["identity"][case.split("-")[1]])
    assert got_ops == [results["port-own"]]
    want = results["ref"][case]
    if case in _REFERENCE_FAILS:
        assert "Invalid integer data type" in want, want
        return
    _same(got, want[0])
    assert want[1] == [results["ref-own"]]


@pytest.mark.parametrize("case", [
    "grouped-tape", "mixed-dtype-grouped", "fp16", "adasum-grouped"])
def test_jit_compiled_collective_matches_the_reference(results, case):
    """The compiled step's outputs equal the reference's bit for bit, and
    each compiled graph holds its own package's adapter op only."""
    (got, got_ops), (want, want_ops) = (results["port"][case],
                                        results["ref"][case])
    _same(got, want)
    assert got_ops == [results["port-own"]]
    assert want_ops == [results["ref-own"]]


def test_keras_fit_with_jit_compile_matches_the_reference(results):
    (got, _), (want, _) = results["port"]["keras-fit"], \
        results["ref"]["keras-fit"]
    _same(got, want)
    losses = got[0][1]
    assert losses[-1] < losses[0], losses


def test_allgather_under_jit_compile_stays_the_boundary(results):
    """Outside the adapter's scope: the port raises its own message where
    the reference fails in TF's ``EagerPyFunc``."""
    got = results["port"]["allgather"][0][0][1]
    assert got.startswith("NotImplementedError"), got
    assert ("the TF-XLA adapter (tensorflow/xla_ops.py) covers dense "
            "allreduce only" in got), got
    assert "sparse_as_dense=True" in got and "EagerPyFunc" not in got
    assert "EagerPyFunc" in results["ref"]["allgather"][0][0][1]


def _adasum_pair(a, b):
    """Adasum of two float64 vectors (the reference's pair rule)."""
    dot, asq, bsq = np.dot(a, b), np.dot(a, a), np.dot(b, b)
    return (1.0 - dot / (2 * asq)) * a + (1.0 - dot / (2 * bsq)) * b


def _oracle(a, b, dtype, op, scales=(1.0, 1.0)):
    """``op`` over the two ranks' values in numpy, in float64 then cast:
    exact for the small integers and power-of-two scales used."""
    pre, post = scales
    x, y = a.astype(np.float64) * pre, b.astype(np.float64) * pre
    if op == "Sum":
        r = x + y
    elif op == "Average":
        r = (np.floor_divide(x + y, 2) if dtype.startswith("int")
             else (x + y) / 2)
    else:
        r = {"Min": np.minimum, "Max": np.maximum,
             "Product": np.multiply}[op](x, y)
    want = r * post
    return want.astype(np.float32 if dtype == "bfloat16" else dtype)


@pytest.fixture(scope="module")
def two_ranks(world):
    """Both ranks' dense allreduces of every dtype × op, the scaled float
    cases, the mixed-dtype grouped calls and Adasum, under ``jit_compile=
    True`` and eagerly (``tests/torch_port_workers.py::tf_xla_allreduce``)."""
    world.collect("import_tensorflow")
    rng = np.random.RandomState(3)
    a = rng.randint(-4, 5, size=(6, 5)).astype(np.float32)
    b = rng.randint(-4, 5, size=(6, 5)).astype(np.float32)
    v = rng.randn(40).astype(np.float32)
    w = rng.randn(40).astype(np.float32)
    return (a, b, v, w), world.run("tf_xla_allreduce", a=a, b=b, v=v, w=w)


def test_two_ranks_jit_compiled_allreduce_equals_the_eager_sum(two_ranks):
    """Every output of the compiled step equals the eager call's bit for
    bit, on both ranks, and both ranks hold the same values."""
    _, res = two_ranks
    keys = sorted(res[0]["eager"])
    assert len(keys) == 6 * 5 + 4 * 2 + 2 * 6 + 3
    for r in res:
        assert r["ops"] == ["HvdTpuTorchAllreduce"], r["ops"]
        assert sorted(r["jit"]) == keys
        for key in keys:
            got, want = r["jit"][key], r["eager"][key]
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    for key in keys:
        np.testing.assert_array_equal(res[0]["jit"][key], res[1]["jit"][key],
                                      err_msg=key)


@pytest.mark.parametrize("dtype", workers.TF_XLA_DTYPES)
def test_two_ranks_jit_compiled_ops_match_numpy(two_ranks, dtype):
    """Each op over the two ranks' small integers, alone and in the
    mixed-dtype grouped call, and each float dtype's scaled Sum and
    Average: exactly the numpy oracle's, dtype kept."""
    (a, b, _, _), res = two_ranks
    jit = res[0]["jit"]
    for op in workers.TF_XLA_OPS:
        want = _oracle(a, b, dtype, op)
        got = jit[f"{dtype}-{op}"]
        assert got.dtype == want.dtype, (dtype, op)
        np.testing.assert_array_equal(got, want, err_msg=f"{dtype}-{op}")
    for op in ("Sum", "Average"):
        np.testing.assert_array_equal(jit[f"mixed-{op}-{dtype}"],
                                      _oracle(a, b, dtype, op),
                                      err_msg=f"mixed-{op}-{dtype}")
    if not dtype.startswith("int"):
        for op, scales in workers.TF_XLA_SCALES.items():
            np.testing.assert_array_equal(
                jit[f"{dtype}-{op}-scaled"], _oracle(a, b, dtype, op, scales),
                err_msg=f"{dtype}-{op}-scaled")


def test_two_ranks_jit_compiled_adasum_matches_numpy(two_ranks):
    """Adasum of two f32 vectors, alone and grouped with an f64 copy (one
    op a tensor): within 1e-6 of the float64 pair rule (f32's rounding of
    the dot products and the combination)."""
    (_, _, v, w), res = two_ranks
    jit = res[0]["jit"]
    want = _adasum_pair(v.astype(np.float64), w.astype(np.float64))
    assert not np.allclose(want, v + w)
    for key in ("adasum", "adasum-grouped-float32"):
        assert jit[key].dtype == np.float32
        np.testing.assert_allclose(jit[key], want, rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_array_equal(jit["adasum"], jit["adasum-grouped-float32"])
    # The core combines in f32 whatever the dtype (the reference's rule),
    # so the f64 copy holds the f32 result's bits.
    assert jit["adasum-grouped-float64"].dtype == np.float64
    np.testing.assert_array_equal(jit["adasum-grouped-float64"],
                                  jit["adasum"].astype(np.float64))
