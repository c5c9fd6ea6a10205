"""The parallel layer: the device mesh and its collectives (in one process,
or across the ranks of a ``torch.distributed`` group: ``multihost``),
ring attention over a sequence-parallel mesh (sequence-parallel
calibration), and tensor-parallel layouts, placement and block forwards
(the TP trunk and, in ``serving/tp_engine.py``, the TP engines)."""
from .mesh import Mesh, make_mesh
from .multihost import MultihostConfig, global_mesh, init_multihost
from .ring_attention import SPMesh, ring_attention, ring_attention_local
from .sharding import (
    COL_PARALLEL, ROW_PARALLEL, block_specs, model_specs, shard_params)
from .tp_forward import make_tp_forward, make_tp_model_forward

__all__ = ["Mesh", "make_mesh", "MultihostConfig", "global_mesh",
           "init_multihost", "SPMesh", "ring_attention",
           "ring_attention_local", "ROW_PARALLEL", "COL_PARALLEL",
           "block_specs", "model_specs", "shard_params", "make_tp_forward",
           "make_tp_model_forward"]
