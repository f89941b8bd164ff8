"""starcoder2-7b — dense, GQA kv=4, RoPE, GeLU, LayerNorm.
[arXiv:2402.19173; 32L d_model=4608 36H kv=4 d_ff=18432 vocab=49152]
"""
from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", d_model=4608, n_layers=32, vocab_size=49_152,
    d_ff=18_432,
    attn=AttnConfig(num_heads=36, num_kv_heads=4, head_dim=128),
    act="gelu", norm="layernorm", context_class="full",
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", d_model=144, n_layers=4, vocab_size=512,
    d_ff=576,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=36),
    act="gelu", norm="layernorm", context_class="full",
)
