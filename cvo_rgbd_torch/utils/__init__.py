"""Host-side point-cloud preprocessing (numpy)."""

from cvo_rgbd_torch.utils.downsample import grid_downsample, range_filter
from cvo_rgbd_torch.utils.edge import canny_edges, edge_filter

__all__ = ["grid_downsample", "range_filter", "canny_edges", "edge_filter"]
