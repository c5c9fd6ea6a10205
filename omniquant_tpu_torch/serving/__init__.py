from .dp_serving import DPServingCoordinator
from .engine import (
    FalconEngine, KVCache, LlamaEngine, OPTEngine, fuse_packed)
from .export import pack_model
from .sampling import sample_tokens
from .spec_decode import SpecDecoder, layer_skip_params
from .tp_engine import (
    TP_ENGINES, TPFalconEngine, TPLlamaEngine, TPOPTEngine)
