from repro_torch.configs.base import ARCHS, SHAPES, get_arch, get_reduced

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_reduced"]
