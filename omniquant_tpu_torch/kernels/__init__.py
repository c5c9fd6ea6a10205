"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions, one module each. Each wrapper counts its kernel launches
in its ``launches`` attribute; ``quant_matmul`` also counts its prefill
tile's launches on pairs words in ``launches_prefill`` (m > 32) and its
launches on planar words, by tile, in ``launches_planar_decode`` (m <= 32)
and ``launches_planar_prefill`` (m > 32)."""
from . import decode_attention, flash_attention, kv_update, quant_matmul

KERNEL_WRAPPERS = {
    "quant_matmul": quant_matmul.quant_matmul,
    "flash_attention": flash_attention.flash_attention,
    "kv_cache_prefill_write": kv_update.kv_cache_prefill_write,
    "kv_cache_write": kv_update.kv_cache_write,
    "kv_cache_write_span": kv_update.kv_cache_write_span,
    "decode_attention_int8": decode_attention.decode_attention_int8,
    "quant_matmul_int": quant_matmul.quant_matmul_int,
    "_unpack_to_int8": quant_matmul._unpack_to_int8,
    "_quant_matmul_int_dense": quant_matmul._quant_matmul_int_dense,
}

# count name -> (wrapper, attribute)
_COUNTERS = {name: (f, "launches") for name, f in KERNEL_WRAPPERS.items()}
_COUNTERS["quant_matmul_prefill"] = (quant_matmul.quant_matmul,
                                     "launches_prefill")
_COUNTERS["quant_matmul_planar_decode"] = (quant_matmul.quant_matmul,
                                           "launches_planar_decode")
_COUNTERS["quant_matmul_planar_prefill"] = (quant_matmul.quant_matmul,
                                            "launches_planar_prefill")


def launch_counts() -> dict:
    """{count name: kernel launches since the last reset}: one per wrapper,
    quant_matmul's pairs prefill launches, and its planar launches by
    tile."""
    return {name: getattr(f, attr) for name, (f, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for f, attr in _COUNTERS.values():
        setattr(f, attr, 0)
