"""Architecture registry: --arch <id> resolves here (the JAX package's
`repro.configs`, copied)."""
from repro_torch.configs.base import ModelConfig, reduced

from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.configs.qwen15_32b import CONFIG as QWEN15_32B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as MOONSHOT
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2_13B
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_27B

REGISTRY = {c.name: c for c in [
    MINITRON_8B, YI_34B, QWEN15_32B, GEMMA3_27B, MOONSHOT, DEEPSEEK_V3,
    WHISPER_LARGE_V3, PIXTRAL_12B, MAMBA2_13B, ZAMBA2_27B,
]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs():
    return sorted(REGISTRY)
