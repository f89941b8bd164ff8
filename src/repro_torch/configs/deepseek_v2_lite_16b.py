"""deepseek-v2-lite-16b — MLA (kv_lora=512) + fine-grained MoE.
[arXiv:2405.04434; 27L d_model=2048 16H d_ff_expert=1408 vocab=102400,
 64 routed experts top-6 + 2 shared, first layer dense]
Assignment-line note (DESIGN.md §5): the bracket text says "160 routed",
the explicit field says 64e — we follow the field (64 routed, top-6).
"""
from repro_torch.models.common import AttnConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", d_model=2048, n_layers=27,
    vocab_size=102_400, d_ff=10_944,   # dense first layer (V2-Lite value)
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                    kv_lora_rank=512, rope_head_dim=64),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, every_n_layers=1, first_dense=1),
    act="swiglu", norm="rmsnorm", context_class="full",
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", d_model=128, n_layers=3,
    vocab_size=512, d_ff=384,
    attn=AttnConfig(num_heads=4, num_kv_heads=4, head_dim=32,
                    kv_lora_rank=64, rope_head_dim=16),
    moe=MoEConfig(capacity_factor=4.0, num_experts=4, top_k=2, d_ff_expert=96,
                  num_shared=1, every_n_layers=1, first_dense=1),
    act="swiglu", norm="rmsnorm", context_class="full",
)
