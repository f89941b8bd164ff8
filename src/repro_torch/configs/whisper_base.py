"""whisper-base — encoder-decoder; conv frontend STUB provides frame
embeddings [B, 1500, d_model].
[arXiv:2212.04356; 6L(+6L enc) d_model=512 8H d_ff=2048 vocab=51865]
"""
from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", d_model=512, n_layers=6, vocab_size=51_865,
    d_ff=2048,
    attn=AttnConfig(num_heads=8, num_kv_heads=8, head_dim=64),
    n_enc_layers=6, enc_seq_len=1500, frontend="audio_stub",
    act="gelu", norm="layernorm", context_class="full",
)

SMOKE = ModelConfig(
    name="whisper-smoke", d_model=64, n_layers=2, vocab_size=512,
    d_ff=128,
    attn=AttnConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    n_enc_layers=2, enc_seq_len=16, frontend="audio_stub",
    act="gelu", norm="layernorm", context_class="full",
)
