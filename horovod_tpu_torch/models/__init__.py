from .transformer import (  # noqa: F401
    GPT, GPTConfig, lm_loss_fn, load_jax_params,
)
