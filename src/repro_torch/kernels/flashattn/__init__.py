from repro_torch.kernels.flashattn.ops import flash_attention

__all__ = ["flash_attention"]
