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
the fake-quant weights to the f32 ulps of the LWC sigmoid; with
``--export_autogptq`` a model_autogptq.pt equal to main.py's), and it serves
the packed model, which gives the text of JAX's engine on main.py's
packed model. Falcon is LWC only: asked for LET, both calibrate without
it (the act statistics are still collected and written, as main.py does).
``--sp 2`` calibrates sequence-parallel as main.py's ``--sp 2`` does,
``--tp 2`` evaluates (16-bit, W4A4 and W6A6 activations) and serves as
main.py's ``--tp 2`` does, and two processes under ``--num_processes 2
--tp 2`` (one shard each) print the single-process ``--tp 2`` run's
results, with ``--coordinator``/``--process_id`` or, launched with
torchrun's variables, without them (then also calibrating with the ``--sp
2`` ring across the two processes). A net with no synthetic config and no
checkpoint exits as main.py does. ``--tasks`` (piqa and
lambada_openai, both packages' task download patched to the same injected
docs) gives main.py's task results; a second ``--eval_cache`` run, and a
run on main.py's db, are served from the db without one LM call; and
``python -m omniquant_tpu_torch.generate_act_stats`` writes the npz files
of the repository's generate_act_stats.py.
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
# test_sp_calibrates_as_main_py: the port's --sp 2 perplexity against
# main.py's --sp 2 run and the port's run without --sp (measured 4.8e-7
# relative to each)
SP_PPL_RTOL = 1e-5
# test_tp_serves_and_evaluates_as_main_py: the TP trunk's perplexity against
# main.py's --tp 2 (GSPMD over the plain forward) and the port's --tp 1,
# with 16-bit and with W4A4/W6A6 activations (their ranges all-reduced)
TP_PPL_RTOL = 1e-5


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
                               "--export_autogptq",
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
                                    "--export_autogptq",
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


_QUANT = {"w16": ["--wbits", "16", "--abits", "16"],
          # per-channel round to nearest (no calibration steps), the
          # activation quantizers of main.py's --abits
          "w4a4": ["--wbits", "4", "--abits", "4", "--epochs", "0",
                   "--nsamples", "2", "--seqlen", "64"],
          "w6a6": ["--wbits", "6", "--abits", "6", "--epochs", "0",
                   "--nsamples", "2", "--seqlen", "64"]}


@pytest.mark.parametrize("net,quant", [
    pytest.param(net, quant, id=net if quant == "w16" else f"{net}-{quant}")
    for net in ("tiny-llama", "tiny-falcon") for quant in _QUANT])
def test_tp_serves_and_evaluates_as_main_py(tmp_path, net, quant):
    """--tp 2 (JAX's weights carried across; 16-bit, or W4A4/W6A6 at
    --epochs 0): perplexity through the tensor-parallel trunk, with the
    activation quantizers, within TP_PPL_RTOL of main.py's --tp 2 and of
    the port's --tp 1; at 16 bits the TP engine's greedy text is --tp 1's
    and main.py's (--tp_overlap 2 too); the mesh of 2 CPU shards is
    logged."""
    args = ["--platform", "cpu", "--synthetic", "--net", net,
            "--eval_ppl"] + _QUANT[quant]
    if quant == "w16":
        args += ["--serve_prompt", PROMPT, "--max_new_tokens", "8"]
    want = main_py_on_conftest_devices(args + ["--tp", "2"]
                                       + _dirs(tmp_path, "jax"))
    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "load_model", carried_load_model)
    try:
        got = cli.main(args + ["--tp", "2"] + _dirs(tmp_path, "port"))
        one = cli.main(args + _dirs(tmp_path, "one"))
        if quant == "w16":
            lap = cli.main(args + ["--tp", "2", "--tp_overlap", "2"]
                           + _dirs(tmp_path, "lap"))
    finally:
        mp.undo()
    assert sorted(got) == sorted(want) == (
        ["generation", "synthetic"] if quant == "w16" else ["synthetic"])
    if quant == "w16":
        assert got["generation"] == one["generation"] == want["generation"]
        assert lap == got
    assert got["synthetic"] == pytest.approx(want["synthetic"],
                                             rel=TP_PPL_RTOL)
    assert got["synthetic"] == pytest.approx(one["synthetic"],
                                             rel=TP_PPL_RTOL)
    needle = "tensor-parallel over tp=2"
    assert _log_lines(tmp_path / "port_out", needle)[0] == (
        f"{needle}: ['cpu', 'cpu']")


_LAUNCHERS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", "SLURM_JOB_ID",
              "OMPI_MCA_orte_hnp_uri")


def test_num_processes_serves_as_one_process_tp(tmp_path):
    """--num_processes 2 --tp 2 on tiny-llama: two processes (a gloo group
    over localhost, one TP shard each) print the results JSON of the
    single-process --tp 2 run, perplexity and text alike; only rank 0
    writes --save_dir, and each rank logs to its own file. Beside it, two
    processes launched with torchrun's variables and no --coordinator or
    --process_id, which also calibrate W4A16 LWC with the --sp 2 ring
    across them: the single-process --sp 2 --tp 2 run's text, its
    perplexity within SP_PPL_RTOL (the ranks sum the loss and gradients in
    another order), and the SP mesh logged over both ranks."""
    args = ["--platform", "cpu", "--synthetic", "--net", "tiny-llama",
            "--wbits", "16", "--abits", "16", "--eval_ppl", "--serve_prompt",
            PROMPT, "--max_new_tokens", "8", "--tp", "2"]
    sp_args = args[:5] + ["--wbits", "4", "--abits", "16", "--group_size",
                          "32", "--lwc", "--epochs", "1", "--nsamples", "4",
                          "--seqlen", "64"] + args[9:] + ["--sp", "2"]
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in _LAUNCHERS}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port, port_sp = _free_port(), _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "omniquant_tpu_torch", *args,
         "--num_processes", "2", "--coordinator", f"localhost:{port}",
         "--process_id", str(r), "--save_dir", str(tmp_path / "mp_save")]
        + _dirs(tmp_path, "mp"), cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    procs += [subprocess.Popen(
        [sys.executable, "-m", "omniquant_tpu_torch", *sp_args,
         "--num_processes", "2"] + _dirs(tmp_path, "sp"), cwd=tmp_path,
        env=dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port_sp),
                 RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    one = cli.main(args + _dirs(tmp_path, "one"))
    one_sp = cli.main(sp_args + _dirs(tmp_path, "one_sp"))
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-4000:]
        got = json.loads(out.strip().splitlines()[-1])
        if i < 2:
            assert got == one
        else:
            assert got["generation"] == one_sp["generation"]
            assert got["synthetic"] == pytest.approx(one_sp["synthetic"],
                                                     rel=SP_PPL_RTOL)
    needle = "sequence-parallel calibration over 2 devices"
    assert _log_lines(tmp_path / "sp_out", needle) == [
        f"{needle} (ring attention, seqlen 64): ['cpu', 'cpu'] on ranks "
        "[0, 1]"] * 2
    assert sorted(one) == ["generation", "synthetic"]
    assert sorted(f.name for f in (tmp_path / "mp_save").iterdir()) == [
        "config.json", "model_fakequant.npz"]
    needle = "tensor-parallel over tp=2"
    for r in range(2):
        logs = list((tmp_path / "mp_out").glob(f"log_*_rank{r}.txt"))
        assert len(logs) == 1
        assert [ln[ln.index(needle):] for ln in logs[0].read_text(
        ).splitlines() if needle in ln] == [
            f"{needle}: ['cpu', 'cpu'] on ranks [0, 1]"]


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tp_refusals(tmp_path, monkeypatch):
    """Heads that do not split exit before anything runs; so do
    --num_processes without --coordinator and --process_id where no
    launcher's variables are set (naming those it looked for), and an --sp
    that does not split over the processes."""
    base = ["--platform", "cpu", "--synthetic", "--net", "tiny-llama"]
    for k in _LAUNCHERS + ("SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="looked for torchrun's MASTER_ADDR"
                                         ".*SLURM's SLURM_JOB_ID"):
        cli.main(base + ["--num_processes", "2"] + _dirs(tmp_path, "n"))
    with pytest.raises(SystemExit, match="--sp 3 does not split over 2"):
        cli.main(base + ["--num_processes", "2", "--sp", "3"])
    with pytest.raises(ValueError, match="do not divide into tp=3"):
        cli.main(base + ["--tp", "3", "--wbits", "16", "--abits", "16",
                         "--serve_prompt", "hi"] + _dirs(tmp_path, "p"))


def _log_lines(out_dir, needle):
    return [ln[ln.index(needle):] for f in sorted(out_dir.glob("log_*.txt"))
            for ln in f.read_text().splitlines() if needle in ln]


def main_py_on_conftest_devices(argv):
    """main.py's run of ``argv``. main.py asks JAX for --sp or --tp virtual
    CPU devices, which JAX refuses once its backend is up; the conftest's 8
    already hold its mesh."""
    update = jax.config.update

    def keep_the_conftest_devices(name, value):
        if name == "jax_num_cpu_devices" and len(jax.devices()) >= value:
            return
        update(name, value)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.config, "update", keep_the_conftest_devices)
    try:
        return MAIN.main(argv)
    finally:
        mp.undo()


def test_sp_calibrates_as_main_py(tmp_path):
    """--sp 2 on tiny-llama (W4A16 g32 LWC + LET, 1 epoch of 4 windows of 64
    tokens, JAX's weights carried across): sequence-parallel calibration on
    a mesh of 2 CPU shards, logged as main.py logs its mesh; the perplexity
    within SP_PPL_RTOL of main.py's --sp 2 run (two calibrations, each
    summing in its own order) and of the port's own run without --sp, and
    main.py's generated text."""
    args = COMMON + ["--net", "tiny-llama", "--epochs", "1"]
    want = main_py_on_conftest_devices(args + ["--sp", "2"]
                                       + _dirs(tmp_path, "jax"))
    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "load_model", carried_load_model)
    try:
        got = cli.main(args + ["--sp", "2"] + _dirs(tmp_path, "port"))
        one = cli.main(args + _dirs(tmp_path, "one"))
    finally:
        mp.undo()
    needle = "sequence-parallel calibration over 2 devices"
    assert len(_log_lines(tmp_path / "jax_out", needle)) == 1
    assert _log_lines(tmp_path / "port_out", needle) == [
        f"{needle} (ring attention, seqlen 64): ['cpu', 'cpu']"]
    assert got["generation"] == want["generation"]
    assert sorted(got) == sorted(want) == ["generation", "synthetic"]
    assert got["synthetic"] == pytest.approx(want["synthetic"],
                                             rel=SP_PPL_RTOL)
    assert got["synthetic"] == pytest.approx(one["synthetic"],
                                             rel=SP_PPL_RTOL)


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


def test_autogptq_checkpoint_matches_main_py(runs, tmp_path):
    """--real_quant --export_autogptq: the port's model_autogptq.pt holds
    main.py's tensors name for name: the integer ones (qweight, qzeros,
    g_idx) bit for bit, the f16 ones (scales, biases, norms, embeddings)
    bit for bit or one f16 step apart, as the f32 values they round agree
    to f32 ulps (test_save_dir_matches_main_py). The port's exporter on
    main.py's own model_packed.npz writes main.py's file bit for bit."""
    from omniquant_tpu_torch.serving.export_autogptq import (
        save_autogptq_checkpoint)
    from omniquant_tpu_torch.utils import load_packed_npz

    d = runs["dir"]
    want = torch.load(str(d / "jsave" / "model_autogptq.pt"),
                      weights_only=True)
    got = torch.load(str(d / "tsave" / "model_autogptq.pt"),
                     weights_only=True)
    assert sorted(got) == sorted(want)
    assert any(k.endswith(".qweight") for k in want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype != torch.float16:
            assert torch.equal(g, w), k
            continue
        step = torch.nextafter(w.abs(), torch.tensor(
            float("inf"), dtype=w.dtype)) - w.abs()
        assert ((g.float() - w.float()).abs() <= step.float()).all(), k
    save_autogptq_checkpoint(
        get_family(runs["net"]).name,
        load_packed_npz(str(d / "jsave" / "model_packed.npz"), device="cpu"),
        str(tmp_path / "from_jax_pack.pt"))
    again = torch.load(str(tmp_path / "from_jax_pack.pt"), weights_only=True)
    assert sorted(again) == sorted(want)
    for k, w in want.items():
        assert again[k].dtype == w.dtype and torch.equal(again[k], w), k


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


TASK_ARGS = ["--platform", "cpu", "--synthetic", "--net", "tiny-opt",
             "--nsamples", "2", "--seqlen", "64", "--tasks",
             "piqa,lambada_openai", "--num_fewshot", "1"]


@pytest.fixture
def task_docs_injected(monkeypatch):
    """Both packages' piqa and lambada_openai read the same injected docs
    instead of downloading them."""
    import omniquant_tpu.eval.harness.tasks as j_tasks
    import omniquant_tpu_torch.eval.harness.tasks as t_tasks

    from test_torch_harness import task_docs

    docs = task_docs(seed=4)
    for mod in (j_tasks, t_tasks):
        for cls, name in ((mod.PIQA, "piqa"),
                          (mod.LambadaOpenAI, "lambada_openai")):
            monkeypatch.setattr(
                cls, "download",
                lambda self, _d=docs[name]: setattr(self, "_data", _d))


@pytest.mark.parametrize("quant", [["--wbits", "16", "--abits", "16"],
                                   ["--wbits", "4", "--abits", "16",
                                    "--group_size", "32", "--epochs", "0"]],
                         ids=["w16", "w4_rtn"])
def test_tasks_match_main_py(tmp_path, task_docs_injected, monkeypatch,
                             quant):
    """--tasks on tiny-opt (JAX's weights carried across; W4 round to
    nearest at --epochs 0): main.py's results, versions and config."""
    from test_torch_harness import assert_results_match

    want = MAIN.main(TASK_ARGS + quant + _dirs(tmp_path, "jax"))
    monkeypatch.setattr(cli, "load_model", carried_load_model)
    got = cli.main(TASK_ARGS + quant + _dirs(tmp_path, "port"))
    assert sorted(got) == sorted(want) == ["config", "results", "versions"]
    assert_results_match(got, want)


def test_eval_cache_serves_repeat_runs(tmp_path, task_docs_injected,
                                       monkeypatch):
    """--eval_cache: the port's second run, and a run on the db main.py
    wrote (the same fingerprint), are served without one LM call; a
    --real_quant run (the packed model in bf16, another fingerprint) on the
    db the port's fake-quant run wrote is not served from it."""
    from omniquant_tpu_torch.eval.harness import TorchLM

    flags = TASK_ARGS + ["--wbits", "4", "--abits", "16", "--group_size",
                         "32", "--epochs", "0"]
    monkeypatch.setattr(cli, "load_model", carried_load_model)
    first = cli.main(flags + ["--eval_cache", str(tmp_path / "port.db")]
                     + _dirs(tmp_path, "a"))
    want = MAIN.main(flags + ["--eval_cache", str(tmp_path / "jax.db")]
                     + _dirs(tmp_path, "jax"))

    calls = []

    def counted(reqtype, fn):
        def call(self, requests):
            calls.append(reqtype)
            return fn(self, requests)
        return call

    for reqtype in ("loglikelihood", "loglikelihood_rolling", "greedy_until"):
        monkeypatch.setattr(TorchLM, reqtype,
                            counted(reqtype, getattr(TorchLM, reqtype)))
    again = cli.main(flags + ["--eval_cache", str(tmp_path / "port.db")]
                     + _dirs(tmp_path, "b"))
    assert again == first
    served = cli.main(flags + ["--eval_cache", str(tmp_path / "jax.db")]
                      + _dirs(tmp_path, "c"))
    assert served == want
    assert calls == [], "the cache should have served these requests"
    cli.main(flags + ["--real_quant", "--eval_cache",
                      str(tmp_path / "port.db")] + _dirs(tmp_path, "d"))
    assert "loglikelihood" in calls, "a --real_quant run was served"


@pytest.mark.parametrize("net", ["tiny-opt", "tiny-llama"])
def test_generate_act_stats_matches_the_jax_script(tmp_path, monkeypatch,
                                                   net):
    """The port's generate_act_stats (JAX's weights carried across) writes
    <net>_scales.npz and <net>_shifts.npz equal to the repository's
    generate_act_stats.py's, at test_act_stats_files_match_main_py's
    tolerance."""
    from omniquant_tpu_torch import generate_act_stats

    spec = importlib.util.spec_from_file_location(
        "_repo_generate_act_stats", REPO / "generate_act_stats.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = ["--synthetic", "--net", net, "--nsamples", "4", "--seqlen", "64"]
    script.main(args + ["--output_dir", str(tmp_path / "jax")])
    monkeypatch.setattr(cli, "load_model", carried_load_model)
    generate_act_stats.main(args + ["--platform", "cpu", "--output_dir",
                                    str(tmp_path / "port")])
    for k in ("scales", "shifts"):
        want = j_load_pytree(str(tmp_path / "jax" / f"{net}_{k}.npz"))
        got = j_load_pytree(str(tmp_path / "port" / f"{net}_{k}.npz"))
        assert len(got) == len(want) == 2
        for gl, wl in zip(got, want):
            assert sorted(gl) == sorted(wl)
            for name in wl:
                np.testing.assert_allclose(gl[name], wl[name], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{k} {name}")
