"""yi-6b [dense] — llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, vocab_size=64000,
    num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008,
    rope_theta=5e6, norm_type="rmsnorm", mlp_act="silu",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96)
