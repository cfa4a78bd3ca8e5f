"""Estimator parameters.

Counterpart of ``horovod_tpu/spark/common/params.py`` (reference:
``horovod/spark/common/params.py``, the pyspark ``Params`` mixin of the
shared estimator knobs: num_proc, batch_size, epochs, store, feature and
label columns...).  Without pyspark: plain attributes with the
reference's ``setFooBar`` / ``getFooBar`` accessors, so estimator code
is the same with or without Spark.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class EstimatorParams:
    """Shared estimator knobs with reference getter/setter names
    (``setNumProc``/``getNumProc`` etc. — camelCase per pyspark ML)."""

    _PARAMS: Dict[str, Any] = {
        "num_proc": None,
        "batch_size": 32,
        "epochs": 1,
        "backward_passes_per_step": 1,
        "store": None,
        "loss": None,
        "metrics": [],
        "feature_cols": ["features"],
        "label_cols": ["label"],
        "validation": None,
        "sample_weight_col": None,
        "compress_sparse": False,
        "shuffle_buffer_size": None,
        "verbose": 1,
        "run_id": None,
        "train_steps_per_epoch": None,
        "validation_steps_per_epoch": None,
    }

    def __init__(self, **kwargs: Any) -> None:
        self._values: Dict[str, Any] = dict(self._PARAMS)
        for k, v in kwargs.items():
            if k not in self._values:
                raise TypeError(f"unknown estimator param {k!r}; valid: "
                                f"{sorted(self._values)}")
            self._values[k] = v

    def _get(self, name: str) -> Any:
        return self._values[name]

    def _set(self, name: str, value: Any) -> "EstimatorParams":
        if name not in self._values:
            raise TypeError(f"unknown estimator param {name!r}")
        self._values[name] = value
        return self

    def __getattr__(self, item: str):
        # setFooBar / getFooBar accessors, reference (pyspark ML) style.
        if item.startswith(("set", "get")) and len(item) > 3:
            snake = _camel_to_snake(item[3:])
            if snake in self._PARAMS:
                if item.startswith("set"):
                    return lambda value: self._set(snake, value)
                return lambda: self._get(snake)
        raise AttributeError(item)

    def param_values(self) -> Dict[str, Any]:
        return dict(self._values)


def _camel_to_snake(name: str) -> str:
    out: List[str] = []
    for ch in name:
        if ch.isupper() and out:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
