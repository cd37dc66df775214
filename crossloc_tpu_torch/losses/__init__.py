"""Task losses and the label helpers shared with the metrics."""
from .common import (
    ae2xyz,
    get_nodata_value,
    logits_to_radian,
    reduce_loss,
    valid_label_mask,
    xyz2ae,
)
from .coord import CoordLossConfig, scene_coords_loss
from .depth import DepthLossConfig, depth_loss
from .normal import NormalLossConfig, normal_loss
from .semantics import NUM_CLASSES, semantics_loss

__all__ = ["CoordLossConfig", "DepthLossConfig", "NUM_CLASSES", "NormalLossConfig", "ae2xyz",
           "depth_loss", "get_nodata_value", "logits_to_radian", "normal_loss", "reduce_loss",
           "scene_coords_loss", "semantics_loss", "valid_label_mask", "xyz2ae"]
