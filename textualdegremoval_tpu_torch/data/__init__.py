from textualdegremoval_tpu_torch.data.datasets import imread_f32
from textualdegremoval_tpu_torch.data.guidance import (
    PairedLQHQDataset, ReferenceGenerationDataset, UnpairedLQHQDataset,
)
from textualdegremoval_tpu_torch.data.pairing import scan_images

__all__ = ["imread_f32", "scan_images", "UnpairedLQHQDataset",
           "PairedLQHQDataset", "ReferenceGenerationDataset"]
