from . import llama
from .common import NO_ACT_QUANT, ActQuantSpec, causal_mask
from .registry import FAMILIES, LLAMA, ModelFamily, get_family
