"""The multi-device layer on ``torch.distributed`` (the port of
``dpvo_tpu/parallel``): a (data, edge) mesh of processes, one device each.
``edge_range`` (or, in training, ``edge_split`` and ``owned_edges``) /
``local_clips`` / ``replicate`` stand where the JAX package's
``edge_shard`` / ``data_sharding`` / ``replicated`` do. There is
no ``mesh_context``: a mesh is passed as ``mesh=`` (``DPVO``,
``make_train_step``, ``dist_gba``, ``dist_ba_delta``)."""

from dpvo_tpu_torch.parallel.dist_ba import dist_ba_delta  # noqa: F401
from dpvo_tpu_torch.parallel.shard import (all_sum, edge_range, edge_rank,  # noqa: F401
                                           edge_split, local_clips, make_mesh, owned_edges,
                                           replicate)
