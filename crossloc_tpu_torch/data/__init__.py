"""Dataset, loader, wire format, augmentation, label means and synthetic scenes."""
from .augment import (
    AugmentConfig,
    AugmentDraws,
    augment_batch,
    color_jitter,
    draw_augmentation,
    normalize_images,
    pp_shift_for_translation,
    rotation_z_pose,
)
from .dataset import IMAGE_HEIGHT, CamLocDataset, CamLocItem, decoder_line, trim_semantic_label
from .means import get_label_mean
from .pipeline import Loader, device_prefetch, images_from_wire, images_to_wire, to_grayscale
from .synthetic import synth_sample, write_fake_dataset

__all__ = [
    "IMAGE_HEIGHT",
    "AugmentConfig",
    "AugmentDraws",
    "CamLocDataset",
    "CamLocItem",
    "Loader",
    "augment_batch",
    "color_jitter",
    "decoder_line",
    "device_prefetch",
    "draw_augmentation",
    "get_label_mean",
    "images_from_wire",
    "images_to_wire",
    "normalize_images",
    "pp_shift_for_translation",
    "rotation_z_pose",
    "synth_sample",
    "to_grayscale",
    "trim_semantic_label",
    "write_fake_dataset",
]
