"""Dataset, loader, wire format and synthetic scenes."""
from .dataset import IMAGE_HEIGHT, CamLocDataset, CamLocItem
from .pipeline import Loader, images_from_wire, images_to_wire, to_grayscale
from .synthetic import synth_sample, write_fake_dataset

__all__ = [
    "IMAGE_HEIGHT",
    "CamLocDataset",
    "CamLocItem",
    "Loader",
    "images_from_wire",
    "images_to_wire",
    "synth_sample",
    "to_grayscale",
    "write_fake_dataset",
]
