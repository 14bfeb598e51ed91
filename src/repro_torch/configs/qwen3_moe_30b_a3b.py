"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, vocab_size=151936,
    num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=768, num_experts=128, top_k=8,
    rope_theta=1e6, norm_type="rmsnorm", mlp_act="silu",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          d_ff=32, num_experts=8, top_k=2)
