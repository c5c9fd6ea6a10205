"""Convert the reference's omni-parameter checkpoints to the npz resume format:
the port's counterpart of ``omniquant_tpu/utils/import_reference.py`` (and,
as ``python -m omniquant_tpu_torch.utils.import_reference PTH NPZ``, of
``scripts/import_reference_omniparams.py``), writing the same npz.

The reference distributes learned LWC/LET parameters as
`omni_parameters.pth`: `{layer_idx: OrderedDict[name -> tensor]}` where the
names come from `omni_state_dict` (reference models/int_llama_layer.py:357-363
— every `named_parameters()` entry containing "smooth" or "bound_factor"),
saved per layer during calibration (reference quantize/omniquant.py:249-250).
That file is also the model-zoo distribution format (HF `ChenMnZ/OmniQuant`,
reference README.md:45-48), so converting it is the bridge between "weights
arrive" and the `--epochs 0 --resume` ppl-parity reproduction recipe
(reference README.md:105-116; docs/parity_reproduction.md here).

Name mapping (verified against the reference's registration sites):
  * LET: the reference registers `{qkv,fc1,out}_smooth_{scale,shift}` and
    `qkt_smooth_scale` directly on the decoder layer (quantize/omniquant.py:
    182-197) — identical to our `init_let_params` keys; values are
    per-channel 1-D.
  * LWC: torch names are module paths ending in
    `<linear>.weight_quantizer.{up,low}bound_factor` (quantize/quantizer.py:
    62-73); ours are `{lwc: {<linear>: {upbound_factor, lowbound_factor}}}`
    keyed by the LAST path component (`self_attn.q_proj` -> `q_proj`), which
    is unique within a block for all three families (models/*.py
    LINEAR_NAMES). Shapes are (num_groups, 1) on both sides.

The output loads through `calibrate(resume=...)` (calib/engine.py) and
`python -m omniquant_tpu_torch --epochs 0 --resume` (or JAX's `main.py`).

Command line:

    python -m omniquant_tpu_torch.utils.import_reference \
        omni_parameters.pth omni_parameters.npz
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np


def _to_numpy(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):  # torch tensor
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def convert_omni_state(sd: Dict[Any, Dict[str, Any]]) -> Dict[int, dict]:
    """{layer_idx: {torch_name: tensor}} -> {layer_idx: {'let':..., 'lwc':...}}.

    Accepts torch tensors or ndarrays as leaves (so tests can run it on
    plain numpy dicts); unknown parameter names raise rather than being
    silently dropped — an omni checkpoint with extra entries is a format
    drift we want to hear about.
    """
    out: Dict[int, dict] = {}
    for li, layer_sd in sd.items():
        let: Dict[str, np.ndarray] = {}
        lwc: Dict[str, Dict[str, np.ndarray]] = {}
        for name, t in layer_sd.items():
            arr = _to_numpy(t)
            if "smooth" in name:
                let[name] = arr.reshape(-1)
            elif "bound_factor" in name:
                parts = name.split(".")
                if len(parts) < 3 or parts[-2] != "weight_quantizer":
                    raise ValueError(
                        f"unrecognized LWC parameter path {name!r} (expected "
                        "'<module>.weight_quantizer.<up|low>bound_factor')")
                linear = parts[-3]
                lwc.setdefault(linear, {})[parts[-1]] = arr.reshape(-1, 1)
            else:
                raise ValueError(
                    f"unrecognized omni parameter {name!r} in layer {li} "
                    "(expected '*smooth*' or '*bound_factor')")
        entry: dict = {}
        if let:
            entry["let"] = let
        if lwc:
            entry["lwc"] = lwc
        out[int(li)] = entry
    return out


def convert_file(pth_path: str, npz_path: str) -> Dict[int, dict]:
    """torch-load a reference omni_parameters.pth and write the npz resume
    file consumed by `calibrate(resume=...)` / `main.py --resume`."""
    import torch

    from .checkpoint import save_pytree

    sd = torch.load(pth_path, map_location="cpu")
    converted = convert_omni_state(sd)
    save_pytree(npz_path, {str(k): v for k, v in converted.items()})
    return converted


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="convert a reference omni_parameters.pth to the npz "
                    "resume format")
    ap.add_argument("pth", help="reference omni_parameters.pth (torch)")
    ap.add_argument("npz", help="output .npz resume file")
    args = ap.parse_args(argv)
    converted = convert_file(args.pth, args.npz)
    n_let = sum("let" in v for v in converted.values())
    n_lwc = sum("lwc" in v for v in converted.values())
    print(f"converted {len(converted)} layers "
          f"({n_lwc} with LWC, {n_let} with LET) -> {args.npz}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
