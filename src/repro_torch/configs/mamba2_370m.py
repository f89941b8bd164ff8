"""mamba2-370m — attention-free SSD (state-space duality) stack.
[arXiv:2405.21060; 48L d_model=1024 vocab=50280 ssm_state=128]
Pure mixer blocks (no MLP), tied embeddings, O(1) decode state.
"""
from repro_torch.models.common import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", d_model=1024, n_layers=48, vocab_size=50_280,
    d_ff=0, attn=None,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    block_pattern=("mamba",), tie_embeddings=True,
    act="swiglu", norm="rmsnorm", context_class="state",
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", d_model=128, n_layers=4, vocab_size=512,
    d_ff=0, attn=None,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                      chunk=32),
    block_pattern=("mamba",), tie_embeddings=True,
    act="swiglu", norm="rmsnorm", context_class="state",
)
