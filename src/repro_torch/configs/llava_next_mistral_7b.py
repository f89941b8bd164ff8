"""llava-next-mistral-7b — mistral backbone + anyres vision stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; 32L d_model=4096 32H kv=8
 d_ff=14336 vocab=32000]
The vision tower is a STUB: input_specs() provides precomputed patch
embeddings [B, P, d_model] which are projected and prepended to the text
sequence (no loss on patch positions).
"""
from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", d_model=4096, n_layers=32,
    vocab_size=32_000, d_ff=14_336,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128),
    frontend="vision_stub", num_patches=576,
    act="swiglu", norm="rmsnorm", context_class="full",
)

SMOKE = ModelConfig(
    name="llava-smoke", d_model=128, n_layers=4, vocab_size=512,
    d_ff=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=32),
    frontend="vision_stub", num_patches=8,
    act="swiglu", norm="rmsnorm", context_class="full",
)
