"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, vocab_size=32768,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, num_experts=8, top_k=2,
    sliding_window=4096,                 # per assignment: SWA variant
    rope_theta=1e6, norm_type="rmsnorm", mlp_act="silu",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          d_ff=96, num_experts=4, top_k=2, sliding_window=16)
