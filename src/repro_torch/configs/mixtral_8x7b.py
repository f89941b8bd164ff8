"""mixtral-8x7b — 8-expert top-2 MoE, sliding-window attention.
[arXiv:2401.04088; 32L d_model=4096 32H kv=8 d_ff=14336 vocab=32000]
SWA window 4096 bounds the decode KV cache => long_500k runs.
"""
from repro_torch.models.common import AttnConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", d_model=4096, n_layers=32, vocab_size=32_000,
    d_ff=14_336,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    sliding_window=4096),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14_336,
                  every_n_layers=1),
    act="swiglu", norm="rmsnorm", context_class="window",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", d_model=128, n_layers=4, vocab_size=512,
    d_ff=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=32,
                    sliding_window=64),
    moe=MoEConfig(capacity_factor=4.0, num_experts=4, top_k=2, d_ff_expert=256,
                  every_n_layers=1),
    act="swiglu", norm="rmsnorm", context_class="window",
)
