"""Runner support: the launcher-minted HMAC key (:mod:`.secret`), the
HMAC-signed control-plane RPC (:mod:`.network`) and safe subprocess
execution (:mod:`.safe_shell_exec`).  Counterpart of
``horovod_tpu/runner/common`` (Horovod's ``horovod/runner/common``)."""
