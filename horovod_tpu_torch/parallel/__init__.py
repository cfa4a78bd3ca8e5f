from .ring_attention import full_attention  # noqa: F401
