"""Host-side data layer: datasets and the device prefetch pipeline."""
from .datasets import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CIFARClassification,
    FolderClassification,
    MNISTClassification,
    SVHNClassification,
    SyntheticClassification,
    build_classification_dataset,
    download_data,
    random_resized_crop,
)
from .pipeline import prefetch_to_device
from .randaugment import RandAugment

__all__ = ["SyntheticClassification", "FolderClassification", "CIFARClassification",
           "MNISTClassification", "SVHNClassification", "build_classification_dataset",
           "random_resized_crop", "RandAugment", "download_data", "IMAGENET_MEAN",
           "IMAGENET_STD", "prefetch_to_device"]
