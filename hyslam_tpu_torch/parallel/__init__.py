"""Several ranks over ``torch.distributed`` (counterpart of
``hyslam_tpu/parallel``): process meshes, and bundle adjustment distributed
by a Schur-complement reduction all-reduced over the ranks (keyframes
replicated, landmark and observation blocks sharded), with the edge-sharded
pose graph and camera-sharded extraction beside it. The reference is one
process; this is the scale-out the JAX package adds, on process groups in
place of a device mesh. Every rank calls every function with the whole
inputs, after ``torch.distributed.init_process_group``."""

from hyslam_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from hyslam_tpu_torch.parallel.dist_ba import distributed_bundle_adjustment  # noqa: F401
