"""Label helpers shared by the losses and the metrics."""
from .common import get_nodata_value, valid_label_mask

__all__ = ["get_nodata_value", "valid_label_mask"]
