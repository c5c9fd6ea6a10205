from .quantizer import (
    CLIPMIN,
    QuantConfig,
    dequantize_weight_int,
    fake_quant_act,
    quantize_weight_int,
    weight_scale_zp,
)
from .packing import (
    PackedWeight,
    default_layout,
    dequantize_packed,
    pack_codes,
    pack_tile,
    pack_weight,
    unpack_codes,
    vals_per_word,
)
