"""The model zoo: GPT, ResNet, VGG-16, Inception-V3, BERT and an MLP.

Counterparts of ``horovod_tpu/models`` with the reference's parameter
names and layouts (``load_jax_params`` copies a flax tree one to one).
Each model is built on this rank's card unless ``device="cpu"`` asks
for the CPU.
"""

from .bert import (  # noqa: F401
    BertConfig,
    BertEncoder,
    BertForMaskedLM,
    BertForSequenceClassification,
    classification_loss_fn,
    masked_lm_loss_fn,
)
from .convnets import InceptionV3, VGG16  # noqa: F401
from .layers import load_jax_params  # noqa: F401
from .mlp import MLP  # noqa: F401
from .resnet import ResNet18, ResNet50, ResNet101, SyncBatchNorm  # noqa: F401
from .transformer import GPT, GPTConfig, lm_loss_fn  # noqa: F401
