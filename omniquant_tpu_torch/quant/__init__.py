from .quantizer import (
    CLIPMIN,
    QuantConfig,
    dequantize_weight_int,
    clamp_ste,
    fake_quant_act,
    fake_quant_weight,
    init_lwc_params,
    quantize_weight_int,
    round_ste,
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
