from .engine import KVCache, LlamaEngine, fuse_packed
from .export import pack_model
from .sampling import sample_tokens
