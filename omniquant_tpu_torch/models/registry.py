"""Model-family registry: LLaMA, OPT and Falcon.

Counterpart of ``omniquant_tpu/models/registry.py``: the uniform interface
the calibration engine, the evaluator and the serving engine use."""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import falcon, llama, opt


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    linear_names: tuple
    block_forward: Callable
    effective_block_weights: Callable
    init_let_params: Callable
    init_lwc_params_block: Callable
    init_params: Callable
    from_hf_state_dict: Callable
    embed: Callable
    head: Callable
    forward: Callable
    let_scale_keys: tuple  # linears whose input act scales seed LET init
    supports_let: bool = True


LLAMA = ModelFamily(
    name="llama",
    config_cls=llama.LlamaConfig,
    linear_names=llama.LINEAR_NAMES,
    block_forward=llama.block_forward,
    effective_block_weights=llama.effective_block_weights,
    init_let_params=llama.init_let_params,
    init_lwc_params_block=llama.init_lwc_params_block,
    init_params=llama.init_params,
    from_hf_state_dict=llama.from_hf_state_dict,
    embed=lambda params, tokens, cfg: llama.embed(params, tokens),
    head=llama.head,
    forward=llama.forward,
    let_scale_keys=llama.LET_SCALE_KEYS,
)

OPT = ModelFamily(
    name="opt",
    config_cls=opt.OPTConfig,
    linear_names=opt.LINEAR_NAMES,
    block_forward=opt.block_forward,
    effective_block_weights=opt.effective_block_weights,
    init_let_params=opt.init_let_params,
    init_lwc_params_block=opt.init_lwc_params_block,
    init_params=opt.init_params,
    from_hf_state_dict=opt.from_hf_state_dict,
    embed=opt.embed,
    head=opt.head,
    forward=opt.forward,
    let_scale_keys=opt.LET_SCALE_KEYS,
)

FALCON = ModelFamily(
    name="falcon",
    config_cls=falcon.FalconConfig,
    linear_names=falcon.LINEAR_NAMES,
    block_forward=falcon.block_forward,
    effective_block_weights=falcon.effective_block_weights,
    init_let_params=falcon.init_let_params,
    init_lwc_params_block=falcon.init_lwc_params_block,
    init_params=falcon.init_params,
    from_hf_state_dict=falcon.from_hf_state_dict,
    embed=falcon.embed,
    head=falcon.head,
    forward=falcon.forward,
    let_scale_keys=(),
    supports_let=False,  # LWC only: effective_block_weights rejects LET
)

FAMILIES = {"llama": LLAMA, "opt": OPT, "falcon": FALCON}


def get_family(net_or_model_name: str) -> ModelFamily:
    """Family dispatch by substring of the model name."""
    low = net_or_model_name.lower()
    if "llama" in low:
        return LLAMA
    if "opt" in low:
        return OPT
    if "falcon" in low:
        return FALCON
    raise ValueError(
        f"unsupported model family for '{net_or_model_name}' "
        "(supported: llama, opt, falcon)")
