"""hubert-xlarge [audio] — encoder-only, wav2vec2-family arch.
[arXiv:2106.07447]

The CNN waveform frontend is a STUB per the assignment: `input_specs`
provides precomputed frame embeddings (B, S, d_model). No decode shapes
(encoder-only). Integrated into iPDB as a TABULAR executor (DESIGN.md
§Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, vocab_size=504,
    num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, mlp_act="gelu", causal=False,
    norm_type="layernorm",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=40,
                          num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96)
