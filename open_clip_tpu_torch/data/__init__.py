"""Data (counterpart of ``open_clip_tpu/data``): synthetic sources, webdataset tar
shards, CSV files and ImageNet-style class folders."""

from .datasets import CsvDataset, DataInfo, SyntheticDataset, get_data, make_imagenet_val
from .wds import WdsConfig, WdsPipeline, expand_urls, iterate_tar_samples

__all__ = ["CsvDataset", "DataInfo", "SyntheticDataset", "get_data", "make_imagenet_val",
           "WdsConfig", "WdsPipeline", "expand_urls", "iterate_tar_samples"]
