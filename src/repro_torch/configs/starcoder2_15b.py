"""starcoder2-15b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, vocab_size=49152,
    num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, mlp_act="gelu",
    rope_theta=1e5, norm_type="layernorm",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96)
