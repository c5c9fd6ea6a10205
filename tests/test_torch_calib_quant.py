"""The quantizer's calibration half (quant/quantizer.py: round_ste,
clamp_ste, init_lwc_params, fake_quant_weight, fake_quant_act's gradient)
and the optimizer the calibration uses, against the JAX package on the
CPU, on numpy-seeded inputs.

JAX runs op by op here, not under jit: XLA's fusions move last bits of
the forward (a division may become a product), and with them codes on a
rounding tie and the gradients that pass a code on qmin or qmax. Forward
values are held bit for bit. XLA's and PyTorch's sigmoid differ in
the last bits on about 0.4 % of inputs (up to 3 ulps), so the LWC factors
of a bit-exact case are drawn where the two sigmoids agree. Gradients are
held against ``jax.grad`` of the same scalar (sum of the output times a
fixed random tensor) to 1e-5 of the largest gradient: both are sums of the
same terms in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from omniquant_tpu.quant import quantizer as jq
from omniquant_tpu_torch.quant import quantizer as tq

GRAD_RTOL = 1e-5


def _agreeing_factors(rng, shape):
    """LWC factors around the 4.0 init, redrawn where XLA's sigmoid and
    PyTorch's differ."""
    f = (4.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    while True:
        bad = (np.asarray(jax.nn.sigmoid(jnp.asarray(f)))
               != torch.sigmoid(torch.from_numpy(f)).numpy())
        if not bad.any():
            return f
        f[bad] = (4.0 + 2.0 * rng.standard_normal(bad.sum())).astype(
            np.float32)


def _assert_grad_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30),
        err_msg=what)


def _grid_weight(rng, out_f, in_f, bits):
    """A weight on an exact grid, (c - z) * 2^-6, in which every row holds
    codes 0 and qmax: without clipping each of its codes lands exactly on
    an integer, the row's extremes exactly on qmin and qmax."""
    qmax = 2 ** bits - 1
    codes = rng.integers(0, qmax + 1, size=(out_f, in_f))
    codes[:, 0], codes[:, 1] = 0, qmax
    z = rng.integers(0, qmax + 1, size=(out_f, 1))
    return ((codes - z) * 2.0 ** -6).astype(np.float32)


WEIGHT_CASES = [
    # (bits, group_size, symmetric, in_features, lwc, weight)
    *[(b, g, False, 128, True, "normal") for b in (2, 3, 4, 8)
      for g in (None, 16, 64)],
    *[(b, g, False, 128, False, "grid") for b in (2, 3, 4, 8)
      for g in (None, 16)],
    (4, 16, True, 40, True, "normal"),    # symmetric deficiency (pad 8)
    (3, 64, True, 100, False, "normal"),  # symmetric deficiency (pad 28)
    (4, None, True, 128, True, "normal"),
]


@pytest.mark.parametrize("bits,group_size,symmetric,in_f,lwc,kind",
                         WEIGHT_CASES)
def test_fake_quant_weight_matches_jax(bits, group_size, symmetric, in_f,
                                       lwc, kind):
    rng = np.random.default_rng(bits * 1000 + (group_size or 0) + in_f)
    out_f = 8
    w = (_grid_weight(rng, out_f, in_f, bits) if kind == "grid" else
         (rng.standard_normal((out_f, in_f)) * 0.05).astype(np.float32))
    jcfg = jq.QuantConfig(n_bits=bits, group_size=group_size,
                          symmetric=symmetric, lwc=lwc)
    tcfg = tq.QuantConfig(n_bits=bits, group_size=group_size,
                          symmetric=symmetric, lwc=lwc)
    n_groups = tcfg.num_groups((out_f, in_f))
    up = _agreeing_factors(rng, (n_groups, 1))
    low = _agreeing_factors(rng, (n_groups, 1))
    r = rng.standard_normal((out_f, in_f)).astype(np.float32)

    def jfun(w_, up_, low_):
        lwc_p = {"upbound_factor": up_, "lowbound_factor": low_} if lwc \
            else None
        return jq.fake_quant_weight(w_, jcfg, lwc_p)

    args = (jnp.asarray(w), jnp.asarray(up), jnp.asarray(low))
    want = jfun(*args)
    jgrads = jax.grad(lambda *b: jnp.sum(jfun(*b) * r), argnums=(0, 1, 2))(
        *args)

    tw, tup, tlow = (torch.tensor(a, requires_grad=True) for a in (w, up, low))
    lwc_p = {"upbound_factor": tup, "lowbound_factor": tlow} if lwc else None
    got = tq.fake_quant_weight(tw, tcfg, lwc_p)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(r)).sum().backward()
    _assert_grad_close(tw.grad.numpy(), jgrads[0], "d/dw")
    if lwc:
        _assert_grad_close(tup.grad.numpy(), jgrads[1], "d/d upbound")
        _assert_grad_close(tlow.grad.numpy(), jgrads[2], "d/d lowbound")
    if kind == "grid":
        # the extremes sit exactly on qmin/qmax: the clamp passes their
        # gradient (1 on [qmin, qmax] inclusive), jnp.clip's would halve it
        assert np.asarray(jgrads[0])[:, :2].any()
    # the recorded grid and the hard codes are JAX's too
    t_scale, t_zero = tq.weight_scale_zp(tw.detach(), tcfg, lwc_p)
    j_scale, j_zero = jq.weight_scale_zp(args[0], jcfg, {
        "upbound_factor": args[1], "lowbound_factor": args[2]}
        if lwc else None)
    np.testing.assert_array_equal(t_scale.detach().numpy(),
                                  np.asarray(j_scale))
    np.testing.assert_array_equal(t_zero.detach().numpy(), np.asarray(j_zero))


def test_lwc_requires_factors():
    cfg = tq.QuantConfig(n_bits=4, lwc=True)
    with pytest.raises(ValueError, match="lwc_params"):
        tq.fake_quant_weight(torch.zeros(4, 8), cfg)
    assert tq.fake_quant_weight(
        torch.ones(4, 8), tq.QuantConfig(n_bits=16)).eq(1).all()


@pytest.mark.parametrize("shape,group_size", [((16, 128), None),
                                              ((4, 96), 32),
                                              ((8, 40), 16)])
def test_init_lwc_params_matches_jax(shape, group_size):
    sym = shape[1] % (group_size or shape[1]) != 0
    jl = jq.init_lwc_params(jq.QuantConfig(n_bits=4, group_size=group_size,
                                           symmetric=sym), shape)
    tl = tq.init_lwc_params(tq.QuantConfig(n_bits=4, group_size=group_size,
                                           symmetric=sym), shape,
                            device="cpu")
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))


def test_round_and_clamp_ste():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.49, 0.5, 1.5, 2.5, 3.7],
                     requires_grad=True)
    want = np.asarray(jq.round_ste(jnp.asarray(x.detach().numpy())))
    y = tq.round_ste(x)
    np.testing.assert_array_equal(y.detach().numpy(), want)  # half to even
    y.sum().backward()
    assert x.grad.eq(1).all()
    x.grad = None
    c = tq.clamp_ste(x, -1.0, 2.0)
    np.testing.assert_array_equal(
        c.detach().numpy(),
        np.asarray(jq.clamp_ste(jnp.asarray(x.detach().numpy()), -1.0, 2.0)))
    c.sum().backward()
    assert x.grad.eq(1).all()


ACT_CASES = [(4, None, "minmax"), (6, None, "minmax"), (8, None, "minmax"),
             (4, 16, "minmax"), (8, None, "fix0to1"), (4, None, "fix0to1")]


@pytest.mark.parametrize("bits,group_size,metric", ACT_CASES)
def test_fake_quant_act_grad_matches_jax(bits, group_size, metric):
    """The straight-through gradient through the codes and through the
    per-token scale (and its zero point, which has none)."""
    rng = np.random.default_rng(bits + (group_size or 0))
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    if metric == "fix0to1":
        x = np.abs(x) / np.abs(x).max()
    r = rng.standard_normal(x.shape).astype(np.float32)
    jcfg = jq.QuantConfig(n_bits=bits, group_size=group_size, metric=metric)
    tcfg = tq.QuantConfig(n_bits=bits, group_size=group_size, metric=metric)
    want = jq.fake_quant_act(jnp.asarray(x), jcfg)
    jg = jax.grad(lambda b: jnp.sum(jq.fake_quant_act(b, jcfg) * r))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = tq.fake_quant_act(tx, tcfg)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(r)).sum().backward()
    _assert_grad_close(tx.grad.numpy(), jg, "d/dx")
    # the gap this closes: a plain torch.round passes no gradient
    assert tx.grad.abs().sum() > 0


def _fake_quant_act_before(x, cfg):
    """fake_quant_act as the port had it before its gradient: the serving
    path's ops."""
    if cfg.metric == "fix0to1":
        q = 2 ** cfg.n_bits - 1
        return torch.round(x * q) / q
    xmin = x.amin(dim=-1, keepdim=True)
    xmax = x.amax(dim=-1, keepdim=True)
    scale, rzp = tq._scale_zp(xmin, xmax, cfg)
    x_int = torch.clamp(torch.round(x / scale) + rzp, cfg.qmin, cfg.qmax)
    return (x_int - rzp) * scale


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bits,metric", [(4, "minmax"), (6, "minmax"),
                                         (8, "fix0to1")])
def test_fake_quant_act_serving_path_unchanged(bits, metric):
    """Where autograd records nothing (the engine), fake_quant_act gives
    the same bits with the same ops as before: no launch is added."""
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((3, 7, 128)).astype(np.float32))
    if metric == "fix0to1":
        x = x.abs() / x.abs().max()
    cfg = tq.QuantConfig(n_bits=bits, metric=metric)
    for grad_mode in (torch.no_grad, torch.enable_grad):
        with grad_mode():
            with _Ops() as now:
                got = tq.fake_quant_act(x, cfg)
            with _Ops() as before:
                want = _fake_quant_act_before(x, cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert now.ops == before.ops


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_optax(wd):
    """torch.optim.AdamW as the calibration builds it (two groups, betas
    (0.9, 0.999), eps 1e-8, weight_decay given) takes optax.adamw's steps:
    m_hat / (sqrt(v_hat) + eps) with the decay decoupled, to f32 rounding
    (rtol 1e-6)."""
    rng = np.random.default_rng(int(wd * 10))
    init = {"let": rng.standard_normal(6).astype(np.float32),
            "lwc": (4 + rng.standard_normal((3, 1))).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** -i).astype(
        np.float32) for k, v in init.items()} for i in range(5)]
    lrs = {"let": 5e-3, "lwc": 1e-2}
    opt = optax.multi_transform(
        {k: optax.adamw(lr, weight_decay=wd) for k, lr in lrs.items()},
        lambda tree: {k: k for k in tree})
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in init.items()}
    topt = torch.optim.AdamW([{"params": [tp[k]], "lr": lr}
                              for k, lr in lrs.items()],
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        topt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6)
