"""The port stands alone: none of its modules, nor chip_smoke.py, loads JAX
or the JAX package; and its entry points never fall back to the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import omniquant_tpu_torch
names = ["omniquant_tpu_torch"]
for m in pkgutil.walk_packages(omniquant_tpu_torch.__path__,
                               "omniquant_tpu_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "omniquant_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_jax_or_jax_package_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for sub in ("quant.packing", "kernels.quant_matmul", "kernels._build",
                "kernels.tolerance", "kernels.decode_attention",
                "serving.engine", "serving.spec_decode", "utils.convert",
                "models.llama", "models.common", "calib", "calib.engine",
                "calib.act_stats", "calib.data", "quant.transform",
                "utils.checkpoint", "models.opt", "eval", "eval.ppl",
                "utils.logging", "cli", "__main__", "eval.harness",
                "eval.harness.base", "eval.harness.caching",
                "eval.harness.categories", "eval.harness.datasets_local",
                "eval.harness.evaluator", "eval.harness.metrics",
                "eval.harness.remote", "eval.harness.tasks",
                "eval.harness.tasks_bias", "eval.harness.tasks_blimp",
                "eval.harness.tasks_gen", "eval.harness.tasks_glue",
                "eval.harness.tasks_math", "eval.harness.tasks_pile",
                "eval.harness.tasks_qa", "eval.harness.tasks_translation",
                "decontamination", "decontamination.janitor",
                "decontamination.decontaminate", "generate_act_stats",
                "parallel", "parallel.ring_attention", "parallel.mesh",
                "parallel.sharding", "parallel.tp_forward",
                "serving.tp_engine", "parallel.multihost",
                "serving.dp_serving"):
        assert f"omniquant_tpu_torch.{sub}" in res["modules"]


def test_every_kernel_source_is_built_and_counted():
    """Each csrc/*.cu is in the build's source list, and the integer path's
    three wrappers count their launches under the JAX kernels' names."""
    from omniquant_tpu_torch.kernels import KERNEL_WRAPPERS, _build

    srcs = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert srcs == sorted(_build.SOURCES)
    assert "quant_matmul_int" in srcs
    for name in ("quant_matmul_int", "_unpack_to_int8",
                 "_quant_matmul_int_dense"):
        assert KERNEL_WRAPPERS[name].__name__ == name
        assert KERNEL_WRAPPERS[name].launches == 0


def test_default_device_raises_without_a_card():
    """Entry points default to device='cuda' and raise where there is no
    card; they run on the CPU only when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from omniquant_tpu_torch import resolve_device
    from omniquant_tpu_torch.calib import (
        CalibConfig, calibrate, collect_act_stats)
    from omniquant_tpu_torch.models import LLAMA, falcon, llama, opt
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import LlamaEngine, OPTEngine, pack_model
    from omniquant_tpu_torch.utils import from_jax_params

    cfg = llama.LlamaConfig(vocab_size=32, hidden_size=128,
                            intermediate_size=256, num_hidden_layers=1,
                            num_attention_heads=2, num_key_value_heads=2)
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(gen, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_model(LLAMA, params, QuantConfig(n_bits=4, group_size=128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"w": params["embed_tokens"].numpy()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.from_hf_state_dict({}, cfg)
    ocfg = opt.OPTConfig(vocab_size=32, hidden_size=128, ffn_dim=256,
                         num_hidden_layers=1, num_attention_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.init_params(gen, ocfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OPTEngine(opt.init_params(gen, ocfg, device="cpu"), ocfg)
    tokens = np.zeros((1, 8), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(LLAMA, params, cfg, tokens, CalibConfig(nsamples=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect_act_stats(LLAMA, params, cfg, tokens)
    from omniquant_tpu_torch.eval.harness import TorchLM, run_tasks

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchLM(LLAMA, params, cfg, tokenizer=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tasks(LLAMA, params, cfg, None, ["piqa"])
    from omniquant_tpu_torch.parallel import Mesh, make_mesh
    from omniquant_tpu_torch.serving import (
        TPFalconEngine, TPLlamaEngine, TPOPTEngine)

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(tp=2)
    cuda2 = Mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPLlamaEngine(params, cfg, cuda2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPOPTEngine(opt.init_params(gen, ocfg, device="cpu"), ocfg, cuda2)
    fcfg = falcon.FalconConfig(vocab_size=32, hidden_size=128,
                               num_hidden_layers=1, num_attention_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPFalconEngine(falcon.init_params(gen, fcfg, device="cpu"), fcfg,
                       cuda2)
    assert resolve_device("cpu") == torch.device("cpu")
