"""hymba-1.5b [hybrid] — parallel attn+mamba heads. [arXiv:2411.13676; hf]

Simplifications noted in DESIGN.md: meta-tokens omitted; all layers use the
same SWA window (1024) + parallel SSM heads; combination is an unweighted
mean of the two branch outputs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, vocab_size=32001,
    num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, ssm_state=16, ssm_conv=4, ssm_expand=2,
    sliding_window=1024,
    norm_type="rmsnorm", mlp_act="silu",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288,
                          num_heads=5, num_kv_heads=5, head_dim=8,
                          d_ff=96, ssm_state=8, sliding_window=16)
