"""command-r-35b — dense, GQA kv=8, no biases.
[hf:CohereForAI/c4ai-command-r-v01; 40L d_model=8192 64H kv=8 d_ff=22528
 vocab=256000]
"""
from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", d_model=8192, n_layers=40, vocab_size=256_000,
    d_ff=22_528,
    attn=AttnConfig(num_heads=64, num_kv_heads=8, head_dim=128),
    act="swiglu", norm="layernorm", context_class="full",
)

SMOKE = ModelConfig(
    name="command-r-35b-smoke", d_model=128, n_layers=4, vocab_size=512,
    d_ff=352,
    attn=AttnConfig(num_heads=8, num_kv_heads=2, head_dim=16),
    act="swiglu", norm="layernorm", context_class="full",
)
