"""Model and data stores for the Spark estimators.

Counterpart of ``horovod_tpu/spark/common/store.py`` (reference:
``horovod/spark/common/store.py``): a ``Store`` says where the
intermediate training data, checkpoints and final models live; the
estimator writes prepared data there and the workers read it back.  The
layout is the reference's, so a store written by either package reads
the same in the other.  The filesystem store covers local, NFS and
FUSE-mounted paths; HDFS and S3 drivers are not built in and raise.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Optional


class Store:
    """Reference API: ``get_train_data_path``, ``get_val_data_path``,
    ``get_checkpoint_path``, ``get_logs_path``, ``saving_runs``…"""

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path

    # -- layout ---------------------------------------------------------------

    def get_train_data_path(self, idx: Optional[Any] = None) -> str:
        return self._sub("intermediate_train_data", idx)

    def get_val_data_path(self, idx: Optional[Any] = None) -> str:
        return self._sub("intermediate_val_data", idx)

    def get_test_data_path(self, idx: Optional[Any] = None) -> str:
        return self._sub("intermediate_test_data", idx)

    def get_runs_path(self) -> str:
        return os.path.join(self.prefix_path, "runs")

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self.get_runs_path(), run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def _sub(self, name: str, idx: Optional[Any]) -> str:
        p = os.path.join(self.prefix_path, name)
        return p if idx is None else os.path.join(p, str(idx))

    # -- IO (subclass responsibility) -----------------------------------------

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def read_serialized(self, path: str) -> Any:
        return pickle.loads(self.read(path))

    def write_serialized(self, path: str, obj: Any) -> None:
        self.write(path, pickle.dumps(obj))

    @staticmethod
    def create(prefix_path: str) -> "Store":
        """Reference: ``Store.create(path)`` dispatches on scheme."""
        if prefix_path.startswith(("hdfs://", "s3://", "s3a://")):
            raise ValueError(
                f"{prefix_path!r}: HDFS/S3 stores are not available in this "
                "build; mount the bucket (gcsfuse) and use a local path, or "
                "subclass Store")
        return FilesystemStore(prefix_path)


class FilesystemStore(Store):
    """Local/NFS/FUSE-mounted filesystem store (reference:
    ``LocalStore``/``FilesystemStore``)."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


LocalStore = FilesystemStore
