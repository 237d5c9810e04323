"""Training data (counterpart of ``open_clip_tpu/data``): the synthetic dataset."""

from .datasets import DataInfo, SyntheticDataset, get_data

__all__ = ["DataInfo", "SyntheticDataset", "get_data"]
