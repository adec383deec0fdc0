"""DPV-SLAM backends of the port: proximity loop closure (``proximity``) and
classic loop closure (``long_term``: ``retrieval``, ``pgo``)."""

from dpvo_tpu_torch.slam.proximity import edges_loop, reduce_edges  # noqa: F401
