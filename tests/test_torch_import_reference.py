"""The port's converter of the reference's omni_parameters.pth
(``omniquant_tpu_torch/utils/import_reference.py``) against the JAX
package's, on a state dict in the reference's format built here with torch
tensors ({layer: OrderedDict[name -> tensor]}: LET's ``*smooth*`` entries,
LWC's ``<module>.weight_quantizer.<up|low>bound_factor``), at tiny-llama's
shapes.

The converted trees and npz files equal JAX's bit for bit; unknown names
raise with JAX's messages; the command line prints the JAX script's line;
and the port's CLI resuming the converted npz at ``--epochs 0`` gives the
fake-quant model and the perplexity of JAX's ``main.py`` on the same npz,
within the tolerances of tests/test_torch_cli.py's resume tests (perplexity
1e-5 relative, weights 1e-6).
"""
import collections
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_cli import (COMMON, MAIN, REPO, _dirs, carried_load_model,
                            j_load_pytree)

from omniquant_tpu.utils import import_reference as jimp
from omniquant_tpu_torch import cli
from omniquant_tpu_torch.utils import import_reference as timp

_LWC_GROUPS = {  # tiny-llama (hidden 64, inter 128, 2 kv heads of 16), g32
    "self_attn.q_proj": 128, "self_attn.k_proj": 64, "self_attn.v_proj": 64,
    "self_attn.o_proj": 128, "mlp.gate_proj": 256, "mlp.up_proj": 256,
    "mlp.down_proj": 256}
_LET = {"qkv_smooth_scale": 64, "qkv_smooth_shift": 64,
        "fc1_smooth_scale": 64, "fc1_smooth_shift": 64,
        "out_smooth_scale": 32, "out_smooth_shift": 32,
        "qkt_smooth_scale": 32}


def reference_state(seed=0, layers=2) -> dict:
    """A reference-format omni state: LET scales near 1, shifts near 0,
    LWC factors around the reference's init of 4."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(layers):
        layer = collections.OrderedDict()
        for name, n in _LET.items():
            base = 0.0 if "shift" in name else 1.0
            layer[name] = torch.from_numpy(
                (base + 0.1 * rng.standard_normal(n)).astype(np.float32))
        for mod, g in _LWC_GROUPS.items():
            for f in ("upbound_factor", "lowbound_factor"):
                layer[f"{mod}.weight_quantizer.{f}"] = torch.from_numpy(
                    rng.uniform(2.0, 5.0, (g, 1)).astype(np.float32))
        sd[i] = layer
    return sd


def _same_tree(got, want):
    assert type(got) is type(want) or isinstance(got, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_convert_matches_jax(tmp_path):
    sd = reference_state()
    _same_tree(timp.convert_omni_state(sd), jimp.convert_omni_state(sd))
    torch.save(sd, tmp_path / "omni_parameters.pth")
    got = timp.convert_file(str(tmp_path / "omni_parameters.pth"),
                            str(tmp_path / "port.npz"))
    want = jimp.convert_file(str(tmp_path / "omni_parameters.pth"),
                             str(tmp_path / "jax.npz"))
    _same_tree(got, want)
    _same_tree(j_load_pytree(str(tmp_path / "port.npz")),
               j_load_pytree(str(tmp_path / "jax.npz")))
    assert set(got[0]["lwc"]) == {m.split(".")[-1] for m in _LWC_GROUPS}


@pytest.mark.parametrize("name", [
    "self_attn.q_proj.scales",                     # neither LET nor LWC
    "upbound_factor",                              # no module path
    "self_attn.q_proj.quantizer.upbound_factor"])  # not weight_quantizer
def test_unknown_names_raise_as_jax(name):
    sd = {0: collections.OrderedDict({name: torch.ones(4, 1)})}
    with pytest.raises(ValueError) as want:
        jimp.convert_omni_state(sd)
    with pytest.raises(ValueError) as got:
        timp.convert_omni_state(sd)
    assert str(got.value) == str(want.value)


def test_command_line_prints_the_scripts_line(tmp_path):
    pth = tmp_path / "omni_parameters.pth"
    torch.save(reference_state(layers=3), pth)
    out = subprocess.run(
        [sys.executable, "-m", "omniquant_tpu_torch.utils.import_reference",
         str(pth), str(tmp_path / "o.npz")], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == (
        f"converted 3 layers (3 with LWC, 3 with LET) -> {tmp_path / 'o.npz'}")


def test_epochs0_resume_gives_main_pys_model(tmp_path):
    """The converted npz resumed at --epochs 0 by the port's CLI and by
    main.py (the same synthetic weights): the same fake-quant model and
    perplexity."""
    torch.save(reference_state(), tmp_path / "omni_parameters.pth")
    npz = str(tmp_path / "omni_parameters.npz")
    timp.convert_file(str(tmp_path / "omni_parameters.pth"), npz)
    args = COMMON + ["--net", "tiny-llama", "--epochs", "0", "--resume", npz]
    want = MAIN.main(args + ["--save_dir", str(tmp_path / "jsave")]
                     + _dirs(tmp_path, "jax"))
    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "load_model", carried_load_model)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = cli.main(args + ["--save_dir", str(tmp_path / "tsave")]
                       + _dirs(tmp_path, "port"))
    finally:
        mp.undo()
        torch.set_num_threads(n)
    np.testing.assert_allclose(got["synthetic"], want["synthetic"],
                               rtol=1e-5)
    jw = j_load_pytree(str(tmp_path / "jsave" / "model_fakequant.npz"))
    tw = j_load_pytree(str(tmp_path / "tsave" / "model_fakequant.npz"))
    # the resumed LET scales are folded: the norm's ones divided by them
    norm = tw["layers"][0]["input_layernorm"]["weight"]
    scale = reference_state()[0]["qkv_smooth_scale"].numpy()
    np.testing.assert_allclose(norm, 1.0 / scale, rtol=1e-6)
    for a, b in zip(jw["layers"], tw["layers"]):
        assert sorted(a) == sorted(b)
        for name in a:
            for leaf in ("weight", "bias"):
                x, y = a[name].get(leaf), b[name].get(leaf)
                assert (x is None) == (y is None), (name, leaf)
                if x is not None:
                    np.testing.assert_allclose(
                        y, x, rtol=1e-6, atol=1e-6 * np.abs(x).max(),
                        err_msg=f"{name}.{leaf}")
