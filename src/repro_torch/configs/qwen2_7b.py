"""qwen2-7b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]

28 query heads do not divide the 16-way model axis; `padded_heads` pads to
32 (whole GQA groups, zero-weight extra heads — function-preserving, +14%
attention FLOPs, recorded in the roofline useful-ratio).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, vocab_size=152064,
    num_heads=28, num_kv_heads=4, head_dim=128, qkv_bias=True,
    d_ff=18944,
    rope_theta=1e6, norm_type="rmsnorm", mlp_act="silu",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96)
