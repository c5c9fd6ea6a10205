from . import falcon, llama, opt
from .common import NO_ACT_QUANT, ActQuantSpec, causal_mask
from .registry import FAMILIES, FALCON, LLAMA, OPT, ModelFamily, get_family
