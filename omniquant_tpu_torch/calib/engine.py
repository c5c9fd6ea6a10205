"""Block-wise OmniQuant calibration with LWC and LET.

Counterpart of ``omniquant_tpu/calib/engine.py::calibrate``. For each block
in turn:

1. the full-precision block maps the fp inputs to its outputs (the
   targets), one window at a time, overwriting the buffer in place;
2. the trainables start (LET scales/shifts from the act stats, LWC factors
   at 4.0, or the values of a resumed npz) and AdamW, with one learning
   rate for the LET group and one for the LWC group, minimises the f32 MSE
   between the block run with ``effective_block_weights`` on the quantized
   inputs and the targets, ``epochs`` passes over the windows in batches;
   the stored LET scales are truncated (|s| >= 1e-2) before every step;
3. the fold: LET folded into the norms and linears, the weights hard
   fake-quantized, each linear's (scale, zero) recorded for packing;
4. the folded block, with the activation quantizers on, maps the
   quantized inputs to the next block's, in place.

Everything is f32 by default (``buffer_dtype``), under no_grad except the
train step, and no graph outlives its step. ``offload_layers`` keeps every
block on the host and one on the device at a time. Sequence-parallel
calibration is not part of this package.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models.common import ActQuantSpec, causal_mask, embedding_device
from ..models.registry import ModelFamily
from ..quant.quantizer import QuantConfig, fake_quant_weight, weight_scale_zp
from ..quant.transform import _truncate_fwd_value
from ..utils.checkpoint import load_pytree, save_pytree


@dataclasses.dataclass
class CalibConfig:
    """Hyperparameters (the reference OmniQuant's defaults; 20 epochs as
    in its published scripts)."""

    wbits: int = 4
    abits: int = 16
    group_size: Optional[int] = None
    symmetric: bool = False
    lwc: bool = True
    let: bool = False
    alpha: float = 0.5
    epochs: int = 20
    nsamples: int = 128
    batch_size: int = 1
    let_lr: float = 5e-3
    lwc_lr: float = 1e-2
    wd: float = 0.0
    aug_loss: bool = False
    buffer_dtype: torch.dtype = torch.float32
    offload_layers: bool = False  # blocks on the host, one on the device
    output_dir: Optional[str] = None
    resume: Optional[str] = None

    @property
    def weight_quant_config(self) -> Optional[QuantConfig]:
        if self.wbits >= 16:
            return None
        return QuantConfig(n_bits=self.wbits, symmetric=self.symmetric,
                           group_size=self.group_size, lwc=self.lwc)

    @property
    def act_quant_spec(self) -> ActQuantSpec:
        return ActQuantSpec.from_bits(self.abits)


def _to(tree, device):
    """``tree`` with every tensor on ``device`` (dicts and lists rebuilt)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _resumed(template, saved, device):
    """``saved`` (numpy leaves) as tensors shaped like ``template``."""
    if isinstance(template, dict):
        return {k: _resumed(v, saved[k], device) for k, v in template.items()}
    return torch.as_tensor(saved, dtype=template.dtype, device=device).clone()


def _embed_all(family, params, model_cfg, tokens, dtype, device):
    """Layer-0 inputs of every window, embedded 8 windows at a time."""
    emb = {k: v for k, v in params.items() if k != "layers"}
    emb_device = embedding_device(params)
    parts = []
    for i in range(0, tokens.shape[0], 8):
        t = tokens[i: i + 8]
        x = family.embed(emb, t.to(emb_device), model_cfg)
        parts.append(x.to(device=device, dtype=dtype or x.dtype))
    return torch.cat(parts)


def _blockwise(family, layer, xs, model_cfg, mask, positions, spec=None):
    """Map every window of ``xs`` through the block, one at a time, in
    place."""
    kw = {} if spec is None else {"spec": spec}
    for j in range(xs.shape[0]):
        y, _ = family.block_forward(layer, xs[j: j + 1], model_cfg, mask,
                                    positions, **kw)
        xs[j: j + 1] = y
    return xs


def _truncate_stored_let(let: dict) -> None:
    """The stored LET scales truncated in place (|s| >= 1e-2), as the
    reference does before every step; ``effective_block_weights``' own
    truncation is then the identity on them."""
    with torch.no_grad():
        for k, v in let.items():
            if "smooth_scale" in k:
                v.copy_(_truncate_fwd_value(v, 1e-2))


def _fold(family, layer, trainable, wcfg, model_cfg):
    """LET folded into the block and its weights hard fake-quantized, plus
    each linear's (scale, zero) grid; under no_grad."""
    lwc = trainable.get("lwc") or None
    smoothed = family.effective_block_weights(
        layer, None, None, trainable.get("let") or None, model_cfg,
        quantize=False)
    qparams = {}
    if wcfg is not None:
        for name in family.linear_names:
            w = smoothed[name]["weight"]
            lw = lwc.get(name) if lwc else None
            scale, rzp = weight_scale_zp(w, wcfg, lw)
            qparams[name] = {"scale": scale, "zero": rzp}
            smoothed[name] = dict(smoothed[name])
            smoothed[name]["weight"] = fake_quant_weight(w, wcfg, lw)
    return smoothed, qparams


def calibrate(family: ModelFamily, params: dict, model_cfg, calib_tokens,
              cc: CalibConfig, act_scales: Optional[list] = None,
              act_shifts: Optional[list] = None, logger=None,
              progress_cb: Optional[Callable] = None,
              device="cuda", timings: Optional[dict] = None) -> tuple:
    """Calibrate ``params['layers']`` block by block, in place, on
    ``device``; ``calib_tokens`` is (nsamples, seqlen) integer.

    Returns (params, omni_parameters): the folded params, and {layer index:
    {'let': ..., 'lwc': ..., 'qparams': {linear: {'scale', 'zero'}}}}, the
    trainables and grid ``pack_model`` takes. ``progress_cb(layer, epoch,
    mean loss)`` is called after every epoch. LET starts from ``act_scales``
    and, for every family but LLaMA (whose shifts start at zero), from
    ``act_shifts``.

    ``timings``, when a dict, receives host-clock seconds around work that
    ends in a device synchronisation (which it adds: one per train step):
    lists ``step_s`` (every train step), ``fp_pass_s``, ``propagate_s``
    and ``layer_s`` (one per layer)."""
    log = logger.info if logger else (lambda *a: None)
    device = resolve_device(device)

    def clock():
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def record(key, t0):
        if timings is not None:
            timings.setdefault(key, []).append(clock() - t0)

    tokens = torch.as_tensor(calib_tokens, device=device)
    n, seqlen = tokens.shape
    if n != cc.nsamples:
        raise ValueError(f"{n} calibration windows, nsamples={cc.nsamples}")
    wcfg = cc.weight_quant_config
    spec = cc.act_quant_spec
    bs = cc.batch_size
    f32 = torch.float32

    with torch.no_grad():
        quant_inps = _embed_all(family, params, model_cfg, tokens,
                                cc.buffer_dtype, device)
    fp_inps = quant_inps.clone()
    fp_inps_2 = quant_inps.clone() if cc.aug_loss else None
    mask = causal_mask(seqlen, seqlen, dtype=cc.buffer_dtype, device=device)
    positions = torch.arange(seqlen, device=device)

    def loss_fn(trainable, layer, qin, fp_out, fp_out_2):
        eff = family.effective_block_weights(
            layer, wcfg, trainable.get("lwc") or None,
            trainable.get("let") or None, model_cfg)
        out, _ = family.block_forward(eff, qin, model_cfg, mask, positions,
                                      spec)
        out = out.to(f32)
        loss = (out - fp_out.to(f32)).pow(2).mean()
        if fp_out_2 is not None:
            loss = loss + (out - fp_out_2.to(f32)).pow(2).mean()
        return loss

    if cc.let and not family.supports_let:
        log(f"WARNING: {family.name} does not support LET "
            "(reference is LWC-only for this family); proceeding without it")

    omni_parameters = {}
    if cc.resume:
        omni_parameters = {int(k): v
                           for k, v in load_pytree(cc.resume).items()}
        log(f"resumed omni parameters for {len(omni_parameters)} layers")

    layers = params["layers"]
    if cc.offload_layers:
        layers = params["layers"] = [_to(b, "cpu") for b in layers]

    for i in range(len(layers)):
        t_layer = clock()
        log(f"=== Start quantize layer {i} ===")
        layer = _to(layers[i], device)

        if cc.epochs > 0:
            t_fp = clock()
            with torch.no_grad():
                _blockwise(family, layer, fp_inps, model_cfg, mask, positions)
                if cc.aug_loss:
                    # the fp block applied to the quantized trajectory
                    fp_inps_2.copy_(quant_inps)
                    _blockwise(family, layer, fp_inps_2, model_cfg, mask,
                               positions)
            record("fp_pass_s", t_fp)

        trainable = {}
        if cc.let and family.supports_let:
            scales_i = act_scales[i] if act_scales is not None else None
            shifts_i = act_shifts[i] if act_shifts is not None else None
            if family.name == "llama":
                trainable["let"] = family.init_let_params(
                    layer, model_cfg, scales_i, alpha=cc.alpha)
            else:
                trainable["let"] = family.init_let_params(
                    layer, model_cfg, scales_i, shifts_i, alpha=cc.alpha)
        if cc.lwc and wcfg is not None:
            trainable["lwc"] = family.init_lwc_params_block(layer, wcfg)
        for group, saved in omni_parameters.get(i, {}).items():
            if group in trainable:
                trainable[group] = _resumed(trainable[group], saved, device)

        if cc.epochs > 0 and trainable:
            groups = [{"params": _leaves(trainable[g]), "lr": lr}
                      for g, lr in (("let", cc.let_lr), ("lwc", cc.lwc_lr))
                      if g in trainable]
            all_ps = [p for g in groups for p in g["params"]]
            for p in all_ps:
                p.requires_grad_(True)
            # optax.adamw's update, m_hat / (sqrt(v_hat) + eps) plus the
            # decoupled decay, with every constant passed (torch's default
            # weight decay is 1e-2, optax's 1e-4)
            opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=cc.wd)
            for epoch in range(cc.epochs):
                losses, norms = [], []
                for j in range(cc.nsamples // bs):
                    idx = j * bs
                    t_step = clock()
                    if "let" in trainable:
                        _truncate_stored_let(trainable["let"])
                    loss = loss_fn(
                        trainable, layer, quant_inps[idx: idx + bs],
                        fp_inps[idx: idx + bs],
                        fp_inps_2[idx: idx + bs] if cc.aug_loss else None)
                    loss.backward()
                    for p in all_ps:  # optax steps every leaf
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    with torch.no_grad():
                        norms.append(torch.sqrt(sum(
                            p.grad.pow(2).sum() for p in all_ps)))
                    opt.step()
                    opt.zero_grad(set_to_none=True)
                    losses.append(loss.detach())
                    del loss
                    record("step_s", t_step)
                # one host sync per epoch
                loss_mean = torch.stack(losses).mean().item()
                norm_mean = torch.stack(norms).mean().item()
                log(f"layer {i} iter {epoch} loss:{loss_mean:.6e} "
                    f"norm:{norm_mean:.6e}")
                if not math.isfinite(loss_mean):
                    log("Loss is NAN, stopping training")
                    break
                if progress_cb:
                    progress_cb(i, epoch, loss_mean)
            for p in all_ps:
                p.requires_grad_(False)
            del opt, groups, all_ps

        with torch.no_grad():
            if trainable or wcfg is not None:
                folded, qparams = _fold(family, layer, trainable, wcfg,
                                        model_cfg)
            else:
                folded, qparams = layer, {}
            if cc.epochs > 0:
                t_prop = clock()
                _blockwise(family, folded, quant_inps, model_cfg, mask,
                           positions, spec)
                record("propagate_s", t_prop)
        layers[i] = _to(folded, "cpu") if cc.offload_layers else folded
        del layer, folded
        omni_parameters[i] = dict(trainable)
        if qparams:
            omni_parameters[i]["qparams"] = qparams
        if cc.output_dir:
            save_pytree(f"{cc.output_dir}/omni_parameters.npz",
                        {str(k): v for k, v in omni_parameters.items()})
        record("layer_s", t_layer)
        log(f"layer {i} done in {time.perf_counter() - t_layer:.1f}s")

    params["layers"] = layers
    return params, omni_parameters
