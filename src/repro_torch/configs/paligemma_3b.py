"""paligemma-3b [vlm] — SigLIP + gemma backbone. [arXiv:2407.07726; hf]

The SigLIP vision tower is a STUB per the assignment: `input_specs`
provides 256 precomputed patch embeddings, prepended with prefix-LM
(bidirectional) masking. 8 query heads cannot shard over the 16-way model
axis; attention stays replicated over `model` (FFN/vocab carry TP) —
sequence-parallel attention is the recorded hillclimb alternative.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, vocab_size=257216,
    num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_act="silu",
    tie_embeddings=True, scale_embed=True,
    num_prefix_tokens=256,
    norm_type="rmsnorm",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=1, head_dim=16,
                          d_ff=96, num_prefix_tokens=8)
