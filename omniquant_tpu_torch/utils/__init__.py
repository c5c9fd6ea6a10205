from .checkpoint import load_pytree, save_pytree
from .convert import from_jax_params, load_packed_npz
from .logging import create_logger
from .profiling import PROFILER, Profiler, device_memory_stats, phase, trace
