"""Task losses and the label helpers shared with the metrics."""
from .common import get_nodata_value, reduce_loss, valid_label_mask
from .coord import CoordLossConfig, scene_coords_loss

__all__ = ["CoordLossConfig", "get_nodata_value", "reduce_loss", "scene_coords_loss",
           "valid_label_mask"]
