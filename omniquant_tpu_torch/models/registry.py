"""Model-family registry (the LLaMA family only in this port so far).

Counterpart of ``omniquant_tpu/models/registry.py``, restricted to the
inference entries the serving path uses."""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import llama


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    linear_names: tuple
    block_forward: Callable
    init_params: Callable
    embed: Callable
    head: Callable
    forward: Callable


LLAMA = ModelFamily(
    name="llama",
    config_cls=llama.LlamaConfig,
    linear_names=llama.LINEAR_NAMES,
    block_forward=llama.block_forward,
    init_params=llama.init_params,
    embed=lambda params, tokens, cfg: llama.embed(params, tokens),
    head=llama.head,
    forward=llama.forward,
)

FAMILIES = {"llama": LLAMA}


def get_family(net_or_model_name: str) -> ModelFamily:
    """Family dispatch by substring of the model name."""
    if "llama" in net_or_model_name.lower():
        return LLAMA
    raise ValueError(
        f"unsupported model family for '{net_or_model_name}' "
        "(ported so far: llama)")
