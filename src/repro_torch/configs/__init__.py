from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, ApproxConfig, ModelConfig, get_config, EXACT, RAPID,
)
