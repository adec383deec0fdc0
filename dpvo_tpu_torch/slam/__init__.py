"""DPV-SLAM backends of the port: proximity loop closure (``proximity``)."""

from dpvo_tpu_torch.slam.proximity import edges_loop, reduce_edges  # noqa: F401
