"""Port of the JAX package's frontend: RGB-D frame -> padded PointCloud."""

from cvo_rgbd_torch.frontend.pipeline import make_frontend

__all__ = ["make_frontend"]
