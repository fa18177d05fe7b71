from repro_torch.configs.base import (
    ArchConfig, MoEConfig, MLAConfig, SSMConfig, RWKVConfig,
    EncDecConfig, HybridConfig, ShapeConfig, SHAPES,
)
from repro_torch.configs.registry import (
    arch_ids, get_arch, get_shape, all_cells, cell_is_runnable,
)
