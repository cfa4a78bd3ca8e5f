"""The RPC layer's shared secret.

Counterpart of ``horovod_tpu/runner/common/secret.py`` (Horovod's
``runner/common/util/secret.py``): the launcher mints a random key and
passes it to every worker in the environment (``HVD_TPU_SECRET_KEY``);
every RPC frame is HMAC-signed with it, so a peer without the key cannot
get a pickled payload unpickled.
"""

from __future__ import annotations

import base64
import os

# The variable that carries the key from the launcher to its workers
# (the reference's HOROVOD_SECRET_KEY).
SECRET_ENV = "HVD_TPU_SECRET_KEY"

DIGEST_LEN = 32  # sha256


def make_secret_key() -> bytes:
    return base64.b64encode(os.urandom(32))


def secret_from_env() -> bytes:
    key = os.environ.get(SECRET_ENV)
    if not key:
        raise RuntimeError(
            f"{SECRET_ENV} is not set; the launcher must pass the RPC "
            "secret to every task")
    return key.encode()
