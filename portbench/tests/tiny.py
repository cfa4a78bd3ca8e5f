"""A benchmark of tiny cells on the CPU, as files: a copy of
``portbench/`` with tiny configurations, traffic and cells added, and a
``BENCHMARK.json`` that lists them.  Nothing here is special-cased by the
harness: the cells are found by their names, as later cells are."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
OPTIMIZER = {"lr": 0.001, "weight_decay": 0.01, "betas": [0.9, 0.999],
             "eps": 1e-08}

CONFIGS = {
    "tiny-gpt": {"family": "gpt2", "source": "tiny", "n_layer": 2,
                 "n_embd": 64, "n_head": 4, "n_positions": 32, "n_ctx": 32,
                 "vocab_size": 128, "initializer_range": 0.02,
                 "reduced": [],
                 "assumed": {"n_inner": 256, "layer_norm_epsilon": 1e-06},
                 "optimizer": OPTIMIZER},
    "tiny-bert": {"family": "bert", "source": "tiny",
                  "num_hidden_layers": 2, "hidden_size": 64,
                  "num_attention_heads": 4, "intermediate_size": 256,
                  "max_position_embeddings": 32, "type_vocab_size": 2,
                  "vocab_size": 128, "initializer_range": 0.02,
                  "reduced": [], "assumed": {"layer_norm_eps": 1e-06},
                  "optimizer": OPTIMIZER},
}
TRAFFIC = {
    "tiny-lm": {"kind": "causal_lm", "batch_per_rank": 2, "seq_len": 32,
                "pool_batches": 4, "token_low": 0},
    "tiny-mlm": {"kind": "masked_lm", "batch_per_rank": 4, "seq_len": 32,
                 "pool_batches": 4, "token_low": 5, "cls_token": 1,
                 "sep_token": 2, "mask_token": 3, "mask_share": 0.15,
                 "replace": {"mask": 0.8, "random": 0.1, "keep": 0.1}},
}
# Set as the cells' limits are, from calibrate.py's readings on the CPU:
# 12 seeds of the program, 3 of the control and of each fault (PERF.md).
CELLS = {
    "tiny-gpt.lm": ("tiny-gpt", "tiny-lm", 1, "int8", True,
                    {"loss_gap": 0.002, "grad_gap": 0.009,
                     "change_gap": 0.005}),
    "tiny-gpt.lm2": ("tiny-gpt", "tiny-lm", 2, "int8", True,
                     {"loss_gap": 0.0013, "grad_gap": 0.05,
                      "change_gap": 0.01}),
    "tiny-bert.mlm": ("tiny-bert", "tiny-mlm", 1, "fp16", False,
                      {"loss_gap": 0.0015, "grad_gap": 0.013,
                       "change_gap": 0.007}),
}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """A checkout-like directory: the benchmark's files, the tiny cells,
    and the port linked in from this checkout."""
    (tmp / "horovod_tpu_torch").symlink_to(BENCH.parent / "horovod_tpu_torch")
    shutil.copytree(BENCH, tmp / "portbench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    base = tmp / "portbench"
    for name, cfg in CONFIGS.items():
        _write(base / "configs" / f"{name}.json", cfg)
    for name, traffic in TRAFFIC.items():
        _write(base / "traffic" / f"{name}.json", traffic)
    for name, (_, _, _, comp, ef, lim) in CELLS.items():
        _write(base / "workloads" / f"{name}.json",
               {"wire": {"compression": comp, "error_feedback": ef},
                "checked_steps": 3, "timing_steps": 2, "trace_steps": 2,
                "reference_rows": 1, "limits": dict(lim, change_gap_worst=None)})
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": chips,
         "why": "a tiny cell on the CPU"}
        for n, (c, t, chips, *_) in CELLS.items()]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    _write(tmp / "BENCHMARK.json", bench)
    return tmp


def spec(root: Path, cell: str, **kw) -> dict:
    import time

    return dict(dict(root=str(root), cell=cell, seed=2**31 + 7, seconds=0.5,
                     trace=False, device="cpu", t0=time.time(), mode="run"),
                **kw)
