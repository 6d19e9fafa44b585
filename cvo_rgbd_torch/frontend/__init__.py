"""Port of the JAX package's frontend: RGB-D frame -> padded PointCloud."""

from cvo_rgbd_torch.frontend.camera import CAMERAS, CameraInfo
from cvo_rgbd_torch.frontend.pipeline import make_frontend, process_frame

__all__ = ["CAMERAS", "CameraInfo", "make_frontend", "process_frame"]
