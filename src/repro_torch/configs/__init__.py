from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_configs,
)
