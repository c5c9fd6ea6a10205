"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions, one module each. Each wrapper counts its kernel launches
in its ``launches`` attribute."""
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


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {name: f.launches for name, f in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for f in KERNEL_WRAPPERS.values():
        f.launches = 0
