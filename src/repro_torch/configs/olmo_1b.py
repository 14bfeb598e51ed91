"""olmo-1b [dense] — non-parametric LN. [arXiv:2402.00838; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, vocab_size=50304,
    num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=8192,
    norm_type="nonparam_ln", mlp_act="silu", tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96)
