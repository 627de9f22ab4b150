"""Models for model-in-the-loop workloads (config 5: ViT feature
extraction embedded as a Map function)."""

from reflow_tpu_torch.models.vit import (VIT_B_16, VIT_TINY, init_vit,
                                         vit_flops, vit_forward)

__all__ = ["init_vit", "vit_forward", "vit_flops", "VIT_B_16", "VIT_TINY"]
