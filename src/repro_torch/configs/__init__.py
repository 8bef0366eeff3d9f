"""Config registry: the 10 assigned architectures (the port's own copy
of the JAX package's ``configs``: data only, the same fields and values)."""
from .base import INPUT_SHAPES, ArchConfig, InputShape

from . import (chatglm3_6b, falcon_mamba_7b, granite_moe_3b_a800m,
               llama4_scout_17b_a16e, qwen2_1_5b, qwen2_5_14b, qwen2_72b,
               qwen2_vl_7b, recurrentgemma_9b, seamless_m4t_large_v2)

_MODULES = [recurrentgemma_9b, llama4_scout_17b_a16e, chatglm3_6b,
            qwen2_vl_7b, qwen2_72b, granite_moe_3b_a800m, falcon_mamba_7b,
            qwen2_5_14b, seamless_m4t_large_v2, qwen2_1_5b]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[:-len("-reduced")]).reduced()
    if name not in REGISTRY:
        raise ValueError(f"unknown arch {name!r}; "
                         f"choose from {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs() -> list[str]:
    return list(REGISTRY)


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "REGISTRY",
           "get_config", "list_configs"]
