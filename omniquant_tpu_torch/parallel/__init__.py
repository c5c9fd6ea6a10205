"""The parallel layer: ring attention over a sequence-parallel mesh (a
sequence of devices), which sequence-parallel calibration runs."""
from .ring_attention import SPMesh, ring_attention, ring_attention_local

__all__ = ["SPMesh", "ring_attention", "ring_attention_local"]
