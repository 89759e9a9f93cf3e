"""The port's data pipeline: filelists, frame samplers, decoders (with the
C++ FFmpeg decode core), the host transforms (with the C++ RandAugment
core), the video datasets, the loader with its host-to-card transfer, and
the device-side I420 unpack."""

from devias_tpu_torch.data.datasets import DataConfig, VideoDataset, build_dataset, knn_build_dataset
from devias_tpu_torch.data.filelist import FilelistEntry, read_filelist
from devias_tpu_torch.data.loader import DataLoader, device_prefetch
from devias_tpu_torch.data.yuv import i420_to_rgb

__all__ = ["DataConfig", "DataLoader", "FilelistEntry", "VideoDataset", "build_dataset", "device_prefetch",
           "i420_to_rgb", "knn_build_dataset", "read_filelist"]
