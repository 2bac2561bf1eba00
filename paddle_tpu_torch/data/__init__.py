"""Data ingestion (``paddle_tpu/data``): reader combinators, datasets,
device feeding, the native MultiSlot feed and sequence packing."""

from paddle_tpu_torch.data import datasets, packing, reader
from paddle_tpu_torch.data.feeder import DataFeeder, device_iterator

__all__ = ["datasets", "reader", "packing", "DataFeeder", "device_iterator"]
