"""omniquant_tpu_torch: the PyTorch/CUDA port of ``omniquant_tpu``.

Serves packed W4A16 LLaMA models on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``csrc/``). The JAX package stays the reference
this one is held against; nothing here imports it or JAX.

Entry points (``LlamaEngine``, ``pack_model``, ``utils.convert``) default to
``device="cuda"`` and run on the CPU only when asked to.
"""

__version__ = "0.1.0"


def resolve_device(device) -> "torch.device":
    """The torch.device for ``device``; raises when CUDA is asked for and
    there is no usable card (the entry points never fall back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
