"""The assigned architectures' configs and the (arch x shape) registry."""
from repro_torch.configs.registry import ARCHS, SHAPES, cell_runnable, get_config, list_archs, runnable_cells

__all__ = ["ARCHS", "SHAPES", "cell_runnable", "get_config", "list_archs", "runnable_cells"]
