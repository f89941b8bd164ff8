from repro_torch.kernels.bloom.ops import (bloom_build, bloom_probe,
                                           bloom_transfer)

__all__ = ["bloom_build", "bloom_probe", "bloom_transfer"]
