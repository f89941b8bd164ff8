"""jamba-1.5-large-398b — hybrid mamba+attention 7:1, MoE 16e top-2.
[arXiv:2403.19887; 72L d_model=8192 64H kv=8 d_ff=24576 vocab=65536]
Block period 8 = [attn, mamba x7]; MoE every 2nd layer. SSM state + only
9 attention layers carry KV => long_500k runs (DESIGN.md §5).
"""
from repro_torch.models.common import (AttnConfig, MambaConfig, MoEConfig,
                                 ModelConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", d_model=8192, n_layers=72,
    vocab_size=65_536, d_ff=24_576,
    attn=AttnConfig(num_heads=64, num_kv_heads=8, head_dim=128),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24_576,
                  every_n_layers=2),
    block_pattern=("attn",) + ("mamba",) * 7,
    act="swiglu", norm="rmsnorm", context_class="state",
)

SMOKE = ModelConfig(
    name="jamba-smoke", d_model=128, n_layers=8, vocab_size=512,
    d_ff=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=32),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                      chunk=32),
    moe=MoEConfig(capacity_factor=4.0, num_experts=4, top_k=2, d_ff_expert=256,
                  every_n_layers=2),
    block_pattern=("attn",) + ("mamba",) * 7,
    act="swiglu", norm="rmsnorm", context_class="state",
)
