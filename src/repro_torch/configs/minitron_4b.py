"""minitron-4b — width/depth-pruned nemotron; squared-ReLU MLP.
[arXiv:2407.14679; 32L d_model=3072 24H kv=8 d_ff=9216 vocab=256000]
"""
from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", d_model=3072, n_layers=32, vocab_size=256_000,
    d_ff=9216,
    attn=AttnConfig(num_heads=24, num_kv_heads=8, head_dim=128),
    act="relu2", norm="rmsnorm", context_class="full",
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", d_model=96, n_layers=4, vocab_size=512,
    d_ff=288,
    attn=AttnConfig(num_heads=6, num_kv_heads=2, head_dim=16),
    act="relu2", norm="rmsnorm", context_class="full",
)
