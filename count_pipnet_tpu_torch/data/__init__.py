"""Host data pipeline of the port: datasets, augmentation, the threaded
loader and the dataset registry (copies of the JAX package's
framework-free host modules)."""

from .datasets import (ImageFolder, Subset, TransformedDataset,
                       TwoAugDataset, stratified_split)
from .loader import DataLoader, make_weighted_sample_weights
from .registry import (DATASET_RECIPES, get_data, get_dataloaders,
                       validate_dataset_paths)

__all__ = ["get_data", "get_dataloaders", "validate_dataset_paths",
           "DATASET_RECIPES", "ImageFolder", "TwoAugDataset",
           "TransformedDataset", "Subset", "stratified_split", "DataLoader",
           "make_weighted_sample_weights"]
