from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_configs,
)
