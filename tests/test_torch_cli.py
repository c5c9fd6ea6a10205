"""The port's command line (``python -m omniquant_tpu_torch``, cli.py)
against the repository's ``main.py``, on the CPU (``--platform cpu``).

For tiny-opt, tiny-llama and tiny-falcon, ``main.py`` calibrates (W4A16 g32 LWC + LET,
1 epoch of 4 synthetic windows of 64 tokens), evaluates the synthetic
perplexity, saves the model and serves a prompt greedily. The port's CLI
then starts from the same weights (``cli.load_model`` patched to return
JAX's ``init_params(PRNGKey(seed))`` carried across), collects its own
activation statistics (equal to the act_scales/act_shifts.npz main.py
wrote) or reads main.py's (``--act-scales``/``--act-shifts``), and
resumes JAX's omni_parameters.npz with ``--epochs 0``: its perplexity
equals main.py's within 1e-5 relative (f32) and its generated text is
main.py's. With
``--real_quant --save_dir`` it writes files that the JAX package's
``load_pytree`` reads and that equal main.py's (packed words bit for bit,
the fake-quant weights to the f32 ulps of the LWC sigmoid), and it serves
the packed model, which gives the text of JAX's engine on main.py's
packed model. Falcon is LWC only: asked for LET, both calibrate without
it (the act statistics are still collected and written, as main.py does).
Unported flags exit naming the ROADMAP item; a net with no synthetic
config and no checkpoint exits as main.py does.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from omniquant_tpu.models import get_family as j_get_family
from omniquant_tpu.serving.engine import FalconEngine as JFalconEngine
from omniquant_tpu.serving.engine import LlamaEngine as JLlamaEngine
from omniquant_tpu.serving.engine import OPTEngine as JOPTEngine
from omniquant_tpu.utils.checkpoint import load_pytree as j_load_pytree
from omniquant_tpu_torch import cli
from omniquant_tpu_torch.models import get_family
from omniquant_tpu_torch.utils import from_jax_params

REPO = pathlib.Path(__file__).resolve().parent.parent
PROMPT = "The quick brown fox"
COMMON = ["--platform", "cpu", "--synthetic", "--wbits", "4", "--abits",
          "16", "--group_size", "32", "--lwc", "--let", "--nsamples", "4",
          "--seqlen", "64", "--eval_ppl", "--serve_prompt", PROMPT,
          "--max_new_tokens", "8"]


def _main_py():
    """The repository's main.py, loaded by path (a main.py elsewhere on
    sys.path would shadow it)."""
    spec = importlib.util.spec_from_file_location("_repo_main_cli",
                                                  REPO / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAIN = _main_py()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny and many; under the test suite's
    parallel workers, several intra-op threads per op made such runs up
    to 100 times slower on a shared CPU (tests/test_torch_cli.py's CLI
    run: 60 s against 0.6 s on one thread). One thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried_load_model(args, logger, device):
    """cli.load_model's shape, with JAX main.py's synthetic weights."""
    jfam = j_get_family(args.net)
    jparams = jfam.init_params(jax.random.PRNGKey(args.seed),
                               jfam.config_cls(**MAIN.TINY_CONFIGS[args.net]))
    fam = get_family(args.net)
    cfg = fam.config_cls(**cli.TINY_CONFIGS[args.net])
    tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        jparams, is_leaf=lambda a: a is None)
    return (fam, cfg, from_jax_params(tree, device=device),
            cli.CharTokenizer(cfg.vocab_size))


def _dirs(d, who):
    return ["--output_dir", str(d / f"{who}_out"),
            "--cache_dir", str(d / f"{who}_cache")]


@pytest.fixture(scope="module", params=["tiny-opt", "tiny-llama",
                                        "tiny-falcon"])
def runs(request, tmp_path_factory):
    net = request.param
    d = tmp_path_factory.mktemp(net)
    want = MAIN.main(COMMON + ["--net", net, "--epochs", "1", "--real_quant",
                               "--save_dir", str(d / "jsave")]
                     + _dirs(d, "jax"))
    resume = ["--epochs", "0", "--resume",
              str(d / "jax_out" / "omni_parameters.npz")]
    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "load_model", carried_load_model)
    try:
        got = cli.main(COMMON + ["--net", net] + resume + _dirs(d, "port"))
        stats = [arg for k in ("scales", "shifts") for arg in (
            f"--act-{k}", str(d / "jax_out" / f"act_{k}.npz"))]
        packed = cli.main(COMMON + ["--net", net, "--real_quant",
                                    "--save_dir", str(d / "tsave")] + resume
                          + stats + _dirs(d, "port_rq"))
    finally:
        mp.undo()
    return dict(net=net, dir=d, want=want, got=got, packed=packed)


def test_parser_matches_main_py():
    """Every dest of main.py's parser, with its default, apart from
    --platform (cuda or cpu here; main.py's names a JAX platform)."""
    want = {a.dest: a.default for a in MAIN.build_parser()._actions}
    got = {a.dest: a.default for a in cli.build_parser()._actions}
    assert sorted(got) == sorted(want)
    assert got.pop("platform") == "cuda"
    want.pop("platform")
    assert got == want
    flags = {s for a in MAIN.build_parser()._actions for s in a.option_strings}
    assert flags == {s for a in cli.build_parser()._actions
                     for s in a.option_strings}
    assert cli.TINY_CONFIGS == MAIN.TINY_CONFIGS
    tok = cli.CharTokenizer(256)
    assert tok.encode(PROMPT) == MAIN.CharTokenizer(256).encode(PROMPT)
    assert tok.decode([0, 65, 300]) == MAIN.CharTokenizer(256).decode(
        [0, 65, 300])


@pytest.mark.parametrize("flags,item", [
    (["--tasks", "piqa"], "item 8"), (["--eval_cache", "x.db"], "item 8"),
    (["--tp", "2"], "item 9"), (["--sp", "2"], "item 9"),
    (["--num_processes", "2"], "item 9"),
    (["--export_autogptq"], "item 10")])
def test_unported_flags_exit(flags, item):
    with pytest.raises(SystemExit, match=f"not ported yet: .*{item}"):
        cli.main(["--platform", "cpu", "--synthetic"] + flags)


def _spec_line(out_dir):
    """The spec-decode acceptance line of a run's log file."""
    lines = [ln for f in sorted(out_dir.glob("log_*.txt"))
             for ln in f.read_text().splitlines()
             if "spec-decode acceptance" in ln]
    assert len(lines) == 1, lines
    return lines[0][lines[0].index("spec-decode acceptance"):]


def test_spec_decode_serves_main_pys_text(tmp_path):
    """--spec_decode 2 --draft_layers 1 on tiny-llama (16-bit weights, so
    nothing is calibrated; JAX's weights carried across): the greedy text
    of main.py's run, and its acceptance line (rate, accepted/proposed)."""
    args = ["--platform", "cpu", "--synthetic", "--net", "tiny-llama",
            "--wbits", "16", "--abits", "16", "--serve_prompt", PROMPT,
            "--max_new_tokens", "16", "--spec_decode", "2",
            "--draft_layers", "1"]
    want = MAIN.main(args + _dirs(tmp_path, "jax"))
    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "load_model", carried_load_model)
    try:
        got = cli.main(args + _dirs(tmp_path, "port"))
    finally:
        mp.undo()
    assert got == want and len(got["generation"]) == 16
    line = _spec_line(tmp_path / "port_out")
    assert line == _spec_line(tmp_path / "jax_out")
    assert "/" in line and not line.endswith("(0/0)")


@pytest.mark.parametrize("synthetic", [False, True])
def test_falcon_7b_without_a_checkpoint_exits_as_main_py(tmp_path,
                                                         synthetic):
    """--net falcon-7b is a Falcon now (no "not ported" exit): with no
    --model and no --synthetic, or with --synthetic (no tiny config of
    that name), the port exits with main.py's message."""
    args = ["--platform", "cpu", "--net", "falcon-7b", "--wbits", "16",
            "--abits", "16", "--output_dir", str(tmp_path / "out"),
            "--cache_dir", str(tmp_path / "cache")]
    args += ["--synthetic"] if synthetic else []
    with pytest.raises(SystemExit) as want:
        MAIN.main(args)
    with pytest.raises(SystemExit) as got:
        cli.main(args)
    assert str(got.value) == str(want.value)
    assert ("--synthetic supports nets" if synthetic
            else "need --model") in str(got.value)


def test_no_card_exits_without_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default platform is usable")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--synthetic", "--wbits", "16", "--abits", "16"])


def test_debug_nans_is_scoped_to_the_run(tmp_path):
    """--debug_nans turns anomaly detection on for the run only; a run with
    nothing to quantize, evaluate or serve returns empty results."""
    assert not torch.is_anomaly_enabled()
    seen = []
    real = cli._run

    def spy(*a):
        seen.append(torch.is_anomaly_enabled())
        return real(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "_run", spy)
    try:
        got = cli.main(["--platform", "cpu", "--synthetic", "--wbits", "16",
                        "--abits", "16", "--debug_nans", "--output_dir",
                        str(tmp_path / "out"), "--cache_dir",
                        str(tmp_path / "cache")])
    finally:
        mp.undo()
    assert got == {} and seen == [True]
    assert not torch.is_anomaly_enabled()


def test_offload_layers_passes_through(tmp_path):
    """--offload_layers is ported (calibrate keeps the blocks on the host,
    one on the device at a time): the same results as without it."""
    base = ["--platform", "cpu", "--synthetic", "--net", "tiny-llama",
            "--wbits", "3", "--abits", "16", "--group_size", "32", "--lwc",
            "--epochs", "1", "--nsamples", "2", "--seqlen", "64",
            "--eval_ppl", "--limit", "4", "--cache_dir",
            str(tmp_path / "cache")]
    got = [cli.main(base + extra + ["--output_dir", str(tmp_path / str(i))])
           for i, extra in enumerate(([], ["--offload_layers"]))]
    assert got[0] == got[1] and np.isfinite(got[0]["synthetic"])


def test_ppl_and_generation_match_main_py(runs):
    want, got = runs["want"], runs["got"]
    assert sorted(got) == sorted(want) == ["generation", "synthetic"]
    np.testing.assert_allclose(got["synthetic"], want["synthetic"], rtol=1e-5)
    assert got["generation"] == want["generation"]
    assert len(got["generation"]) == 8


def test_act_stats_files_match_main_py(runs):
    """act_scales.npz / act_shifts.npz the port collects and writes equal
    main.py's (per-layer, per-linear f32 statistics) read by JAX."""
    d = runs["dir"]
    for k in ("scales", "shifts"):
        want = j_load_pytree(str(d / "jax_out" / f"act_{k}.npz"))
        got = j_load_pytree(str(d / "port_out" / f"act_{k}.npz"))
        assert len(got) == len(want) == 2
        for gl, wl in zip(got, want):
            assert sorted(gl) == sorted(wl)
            for name in wl:
                np.testing.assert_allclose(gl[name], wl[name], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{k} {name}")
    assert not (d / "port_rq_out" / "act_scales.npz").exists()


def test_save_dir_matches_main_py(runs):
    """model_fakequant.npz, model_packed.npz and config.json read by JAX's
    load_pytree: packed words, zero points, per-linear metadata and the
    config equal main.py's; float leaves to f32 ulps."""
    d = runs["dir"]
    for name in ("model_fakequant.npz", "model_packed.npz"):
        want = j_load_pytree(str(d / "jsave" / name))
        got = j_load_pytree(str(d / "tsave" / name))
        flat_w = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: x is None or hasattr(x, "qweight"))
        flat_g = jax.tree.leaves(
            got, is_leaf=lambda x: x is None or hasattr(x, "qweight"))
        assert len(flat_w) == len(flat_g)
        for (path, a), b in zip(flat_w, flat_g):
            where = name + jax.tree_util.keystr(path)
            if a is None:
                assert b is None, where
            elif hasattr(a, "qweight"):
                for f in ("bits", "group_size", "in_features",
                          "out_features", "tile_k", "layout"):
                    assert getattr(b, f) == getattr(a, f), (where, f)
                np.testing.assert_array_equal(b.qweight, a.qweight)
                np.testing.assert_array_equal(b.zeros, a.zeros)
                np.testing.assert_allclose(b.scales, a.scales, rtol=1e-6)
                assert (a.bias is None) == (b.bias is None), where
            else:
                assert b.dtype == a.dtype, where
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=1e-6 * np.abs(a).max(),
                                           err_msg=where)
    with open(d / "jsave" / "config.json") as f:
        want = json.load(f)
    with open(d / "tsave" / "config.json") as f:
        assert json.load(f) == want


def test_real_quant_serves_the_packed_model(runs):
    """--real_quant: the port serves its packed model; JAX's engine on
    main.py's model_packed.npz (bf16, greedy) gives the same text. The
    perplexity is still the fake-quant model's."""
    jfam = j_get_family(runs["net"])
    jcfg = jfam.config_cls(**MAIN.TINY_CONFIGS[runs["net"]])
    packed = jax.tree.map(
        lambda a: None if a is None else jax.numpy.asarray(a),
        j_load_pytree(str(runs["dir"] / "jsave" / "model_packed.npz")),
        is_leaf=lambda a: a is None)
    engine = {"opt": JOPTEngine, "llama": JLlamaEngine,
              "falcon": JFalconEngine}[jfam.name]
    eng = engine(packed, jcfg, max_batch=1, max_len=2048)
    tok = MAIN.CharTokenizer(jcfg.vocab_size)
    want = tok.decode(eng.generate(tok.encode(PROMPT), max_new_tokens=8))
    assert runs["packed"]["generation"] == want
    np.testing.assert_allclose(runs["packed"]["synthetic"],
                               runs["want"]["synthetic"], rtol=1e-5)


def test_module_entry_prints_results_json_last(tmp_path):
    """``python -m omniquant_tpu_torch`` in a subprocess: the results JSON
    is the last line of standard output; the datasets with no local copy
    are skipped with main.py's log line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "omniquant_tpu_torch", "--platform", "cpu",
         "--synthetic", "--net", "tiny-opt", "--wbits", "16", "--abits",
         "16", "--seqlen", "128", "--eval_ppl", "--limit", "3",
         "--serve_prompt", "hi", "--max_new_tokens", "4",
         "--output_dir", str(tmp_path / "out"), "--cache_dir",
         str(tmp_path / "cache"), "--profile_dir", str(tmp_path / "prof")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(last) == ["generation", "synthetic"]
    assert np.isfinite(last["synthetic"]) and len(last["generation"]) == 4
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
