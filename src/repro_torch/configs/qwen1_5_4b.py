"""qwen1.5-4b — dense, GQA (kv=20 => MHA-like), QKV bias, RoPE.
[hf:Qwen/Qwen1.5-4B; 40L d_model=2560 20H kv=20 d_ff=6912 vocab=151936]
"""
from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", d_model=2560, n_layers=40, vocab_size=151_936,
    d_ff=6912,
    attn=AttnConfig(num_heads=20, num_kv_heads=20, head_dim=128,
                    qkv_bias=True),
    act="swiglu", norm="rmsnorm", context_class="full",
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke", d_model=128, n_layers=4, vocab_size=512,
    d_ff=352,
    attn=AttnConfig(num_heads=4, num_kv_heads=4, head_dim=32,
                    qkv_bias=True),
    act="swiglu", norm="rmsnorm", context_class="full",
)
