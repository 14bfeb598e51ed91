"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free. [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    norm_type="rmsnorm",
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, vocab_size=288, ssm_state=8)
