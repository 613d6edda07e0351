"""Model zoo of the port (counterpart of ``horovod_tpu/models``): ResNet,
the Transformer LM, the MNIST convnet and the ViT, with
``params_from_flax`` to carry a flax model's weights into any of them."""

from horovod_tpu_torch.models.carry import params_from_flax  # noqa: F401
from horovod_tpu_torch.models.mnist import MnistConvNet  # noqa: F401
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig, TransformerLM, apply_rope, best_attention,
    causal_attention, lm_loss, lm_loss_from_hidden,
)
from horovod_tpu_torch.models.vit import (  # noqa: F401
    ViT, ViT_B16, ViT_S16, ViTConfig,
)

__all__ = [
    "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
    "TransformerConfig", "TransformerLM", "MnistConvNet",
    "ViT", "ViTConfig", "ViT_S16", "ViT_B16",
]
