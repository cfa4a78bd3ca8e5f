"""Shared set-up of the serving parity tests (``test_torch_port_serve_*``).

The reference's serving fixture (``tests/test_serving.py``): a GPT of 2
layers, d_model 32, 2 heads, vocab 97, a 32-position table, f32
activations and parameters, weights from ``PRNGKey(0)``.  The port's
GPT gets the same weights through ``load_jax_params``, so the two
engines serve one model.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig

from horovod_tpu_torch.models import GPT, GPTConfig, load_jax_params

# The fixture's matrices are tiny: intra-op threads only contend with the
# other test workers, and the drills' deadlines are wall-clock times.
torch.set_num_threads(1)

KEY = b"k" * 32
VOCAB = 97
CFG = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_ff=64,
           max_seq_len=32)
ENGINE_DEFAULTS = dict(max_slots=2, prefill_buckets=(8, 16), max_seq_len=32)


def jax_pair(cfg=None, seed: int = 0):
    """(flax GPT, its params) at the fixture's shape (or ``cfg``)."""
    cfg = dict(CFG, **(cfg or {}))
    model = JaxGPT(JaxGPTConfig(**cfg, dtype=jnp.float32,
                                param_dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def torch_model(params, cfg=None) -> GPT:
    """The port's GPT on the CPU holding ``params``."""
    model = GPT(GPTConfig(**dict(CFG, **(cfg or {})), dtype=torch.float32),
                device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return model


@functools.lru_cache(maxsize=None)
def fixture():
    """(flax GPT, params, port GPT): the module-wide model of a test
    file (built once a process)."""
    jm, params = jax_pair()
    return jm, params, torch_model(params)


def greedy_reference(model: GPT, prompt, n_tokens: int):
    """Naive full-forward argmax loop over the port's GPT — the
    decode-correctness oracle."""
    seq = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n_tokens):
            logits = model(torch.tensor([seq]))
            tok = int(logits[0, -1].argmax())
            out.append(tok)
            seq.append(tok)
    return out


def run_engine(engine, slot, prompt, n_tokens, sampling_cls, **kw):
    """``n_tokens`` from one request in ``slot`` (released after)."""
    toks = [engine.start(slot, prompt, sampling_cls(
        max_new_tokens=n_tokens, **kw))]
    while len(toks) < n_tokens:
        toks.extend(engine.step()[slot])
    engine.release(slot)
    return toks[:n_tokens]


def pump(batcher, reqs, max_steps: int = 500):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            return
        batcher.step()
    raise AssertionError("requests did not complete")


def drive(batcher, until, timeout: float = 60.0):
    t0 = time.monotonic()
    while not until():
        batcher.step()
        assert time.monotonic() - t0 < timeout, "drive timed out"


def first_own_index(ref, start: int = 1):
    """The first index ``i >= start`` whose token appears nowhere
    before it in ``ref``: a stop token there ends generation exactly at
    ``i`` (a token seen earlier would end it sooner)."""
    for i in range(start, len(ref)):
        if ref[i] not in ref[:i]:
            return i
    return None
