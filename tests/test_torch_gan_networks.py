"""PyTorch port, the GAN networks and losses against the JAX package.

Small nets (a ``resnet_6blocks`` generator at ngf 8, discriminators at ndf
8, 32x32 images), both packages from one ``numpy_init(..., init="gan")``
tree; JAX runs jitted with the variables as arguments, as the train steps
run it. Tolerances, each measured here:

* discriminators, forward and backward (the input's gradient and each
  parameter's), train and eval, ``norm`` batch and none: 1e-5 relative to
  each tensor's largest value (measured <= 1e-6: the float32 convs sum in
  other orders);
* ``gan_loss`` in all three modes and ``l1``: within ``SUM_ULPS`` float32
  ulps of the mean of the terms' magnitudes (measured <= 1.1; 0-9 ulps of
  the loss itself, 31 for wgangp over 7,200 logits, where the sum cancels).
  The port sums exactly and rounds once; XLA's CPU mean adds in float32 in
  an order that depends on the shape (sequentially at 900 elements, in 32
  lanes at 3,072), so no one order of float32 adds reproduces it; vanilla's
  ``log1p`` and ``exp`` are each library's;
* ``gradient_penalty`` with an injected alpha, and its gradient with
  respect to D's parameters (the double backward): 1e-5 relative;
* the generator's FP32 forward, train and eval, with its BN statistics:
  1e-5 relative; QAT and QAT_FROZEN module by module on JAX's inputs:
  equal but for at most ``QAT_MOVED`` of the values, moved by one step of
  their grid (a value on a rounding boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu.gan import networks as jnet
from frostnet_tpu.nn import FP32 as J_FP32, QAT as J_QAT, QAT_FROZEN as J_QAT_FROZEN
from frostnet_tpu.utils.losses import l1 as jax_l1
from frostnet_tpu_torch.gan import networks as tnet
from frostnet_tpu_torch.nn import FP32, QAT, QAT_FROZEN, QuantStub
from frostnet_tpu_torch.quant import from_jax_variables, model_variables, numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables
from frostnet_tpu_torch.utils.losses import l1

pytestmark = pytest.mark.usefixtures("few_threads")
NGF, NDF, SIZE = 8, 8, 32
REL = 1e-5
SUM_ULPS = 8
# QAT modules fed JAX's inputs: the share of outputs moved by a grid step
# (a value on a rounding boundary, the float sums in other orders)
QAT_MOVED = 1e-3
# QAT train, module by module: each module's observers snap to its input's
# extremes, and where a conv's float sum puts an extreme an ulp apart the
# module's grid moves and most of its codes with it (2 of 15 modules
# measured, each output within one step); the observers within OBS_REL of
# their range (measured 1.3e-4)
QAT_GRIDS_MOVED = 4
OBS_REL = 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mean_ulps(got, want, terms):
    """|got - want| in float32 ulps of the mean magnitude of the summed terms."""
    scale = np.abs(np.asarray(terms, np.float64)).mean() * np.finfo(np.float32).eps
    return abs(float(got) - float(want)) / scale


def _images(seed, channels=3, batch=2, size=SIZE):
    return np.clip(np.random.RandomState(seed).randn(batch, size, size, channels) * 0.5,
                   -1, 1).astype(np.float32)


def _pair(make_port, make_jax, seed=0):
    """(port net, jax net, jax variables) from one GAN numpy init."""
    net = make_port()
    tree = numpy_init(net, seed, init="gan")
    from_jax_variables(net, tree)
    return net, make_jax(), jax_variables(tree)


D_CASES = [("basic", "batch", 6), ("basic", "none", 3), ("n_layers", "batch", 3),
           ("pixel", "batch", 6), ("pixel", "none", 3)]


@pytest.mark.parametrize("netD,norm,nc", D_CASES, ids=[f"{a}-{b}" for a, b, _ in D_CASES])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_forward_backward(netD, norm, nc, train):
    net, jnet_d, v = _pair(lambda: tnet.define_d(NDF, netD, n_layers=2, norm=norm, input_nc=nc),
                           lambda: jnet.define_d(NDF, netD, n_layers=2, norm=norm))
    x = _images(1, nc)
    if not train and norm == "batch":  # eval reads running statistics: give them values
        rng = np.random.RandomState(3)
        for k in list(v["batch_stats"]):
            st = v["batch_stats"][k]
            st = {"mean": jnp.asarray(rng.randn(*st["mean"].shape).astype(np.float32) * 0.1),
                  "var": jnp.asarray(rng.uniform(0.5, 2, st["var"].shape).astype(np.float32))}
            v["batch_stats"][k] = st
            getattr(net, k).mean.copy_(torch.tensor(np.asarray(st["mean"])))
            getattr(net, k).var.copy_(torch.tensor(np.asarray(st["var"])))

    def jloss(params, xx):
        vv = {**v, "params": params}
        if train and "batch_stats" in v:
            out, upd = jnet_d.apply(vv, xx, train=True, mutable=["batch_stats"])
        else:
            out, upd = jnet_d.apply(vv, xx, train=train), {}
        return jnp.sum(out * out), (out, upd)

    (_, (jout, jupd)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = net(xt, train=train)
    (out * out).sum().backward()
    assert out.shape == jout.shape
    assert _rel(out.detach(), jout) <= REL
    assert _rel(xt.grad, jgx) <= REL
    grads = flatten_variables({"params": jax.tree.map(np.asarray, jgp)})
    mine = {k: t for k, t in model_variables(net).items()}
    for k, want in grads.items():
        assert _rel(mine[k].grad, want) <= REL, k
    if train and "batch_stats" in jupd:
        for k, want in flatten_variables({"batch_stats": jax.tree.map(
                np.asarray, jupd["batch_stats"])}).items():
            np.testing.assert_allclose(mine[k].detach().numpy(), want, rtol=REL, atol=1e-7,
                                       err_msg=k)


def test_discriminator_layout_and_norm_check():
    d = tnet.define_d(64, "basic", norm="none", input_nc=3)
    assert [n for n, _ in d.named_children()] == ["conv0", "conv1", "conv2", "conv3", "out"]
    assert not any(n.endswith(".mean") for n, _ in d.named_buffers())  # no BN
    assert not hasattr(d.conv1, "bias")  # bias-free middle convs without BN
    p = tnet.define_d(64, "pixel", norm="batch", input_nc=6)
    assert not hasattr(p.out, "bias") and hasattr(p.conv0, "bias")
    with pytest.raises(ValueError, match="norm must be batch|none"):
        tnet.define_d(norm="instance")
    with pytest.raises(ValueError, match="unknown discriminator"):
        tnet.define_d(netD="unet")
    with pytest.raises(ValueError, match="not supported"):
        tnet.define_g(netG="unet_256")


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("shape", [(1, 30, 30, 1), (8, 30, 30, 1), (2, 14, 14, 1)])
def test_gan_loss_matches_jax(mode, real, shape):
    pred = (np.random.RandomState(sum(shape)).randn(*shape) * 2).astype(np.float32)
    want = float(jax.jit(lambda p: jnet.gan_loss(p, real, mode))(jnp.asarray(pred)))
    got = float(tnet.gan_loss(torch.as_tensor(pred), real, mode))
    p, t = pred.astype(np.float64), float(real)
    terms = {"lsgan": (p - t) ** 2, "wgangp": p,
             "vanilla": np.maximum(p, 0) - p * t + np.log1p(np.exp(-np.abs(p)))}[mode]
    assert _mean_ulps(got, want, terms) <= SUM_ULPS, (got, want)


def test_gan_loss_unknown_mode():
    with pytest.raises(ValueError, match="unknown gan_mode"):
        tnet.gan_loss(torch.zeros(2), True, "hinge")


@pytest.mark.parametrize("shape", [(1, 32, 32, 3), (2, 32, 32, 3), (1, 64, 64, 2)])
def test_l1_matches_jax(shape):
    rng = np.random.RandomState(len(shape) + shape[1])
    a, b = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    want = float(jax.jit(jax_l1)(jnp.asarray(a), jnp.asarray(b)))
    got = float(l1(torch.as_tensor(a), torch.as_tensor(b)))
    assert _mean_ulps(got, want, a.astype(np.float64) - b) <= SUM_ULPS, (got, want)


def test_gradient_penalty_and_its_double_backward():
    """The penalty and d(penalty)/d(params) through the double backward, with
    alpha injected into both packages; and the alpha draw from a generator."""
    net, jnet_d, v = _pair(lambda: tnet.define_d(NDF, "basic", norm="none", input_nc=3),
                           lambda: jnet.define_d(NDF, "basic", norm="none"))
    real, fake = _images(2), _images(3)
    alpha = np.random.RandomState(4).rand(2, 1, 1, 1).astype(np.float32)

    def jpen(params):
        dv = {**v, "params": params}
        return jnet.gradient_penalty(lambda vv, x: jnet_d.apply(vv, x), dv, jnp.asarray(real),
                                     jnp.asarray(fake), None)

    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape: jnp.asarray(alpha)
        want, jgrads = jax.jit(jax.value_and_grad(jpen))(v["params"])
    finally:
        jax.random.uniform = orig
    got = tnet.gradient_penalty(lambda x: net(x), torch.as_tensor(real), torch.as_tensor(fake),
                                alpha=torch.as_tensor(alpha))
    got.backward()
    assert abs(float(got.detach()) / float(want) - 1) <= REL
    mine = model_variables(net)
    for k, w in flatten_variables({"params": jax.tree.map(np.asarray, jgrads)}).items():
        g = mine[k].grad  # None where the penalty does not depend on it (the output bias)
        assert _rel(torch.zeros_like(mine[k]) if g is None else g, w) <= REL, k
    g = torch.Generator().manual_seed(5)
    drawn = tnet.gradient_penalty(lambda x: net(x), torch.as_tensor(real),
                                  torch.as_tensor(fake), generator=g)
    again = tnet.gradient_penalty(lambda x: net(x), torch.as_tensor(real),
                                  torch.as_tensor(fake), generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(drawn) and float(drawn) == float(again)


def _generator_pair(**kw):
    return _pair(lambda: tnet.define_g(ngf=NGF, netG="resnet_6blocks", **kw),
                 lambda: jnet.define_g(ngf=NGF, netG="resnet_6blocks", **kw))


@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "float"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_fp32_forward_and_bn_statistics(quantized, train):
    net, jg, v = _generator_pair(quantized=quantized)
    x = _images(5)
    mutable = ["batch_stats"] if train else False
    jout = jax.jit(lambda vv, xx: jg.apply(vv, xx, mode=J_FP32, train=train, mutable=mutable))(
        v, jnp.asarray(x))
    jout, upd = jout if train else (jout, {})
    out = net(torch.as_tensor(x), FP32, train=train)
    assert _rel(out.detach(), jout) <= REL
    if train:
        mine = model_variables(net)
        for k, w in flatten_variables({"batch_stats": jax.tree.map(
                np.asarray, upd["batch_stats"])}).items():
            np.testing.assert_allclose(mine[k].detach().numpy(), w, rtol=REL, atol=1e-7,
                                       err_msg=k)
    if not quantized:
        assert not any(k.startswith("quant/") for k in model_variables(net))


def _jax_module_io(model, variables, x, **kw):
    """(output, {top-level module: (its input, its output)}, updates) of one
    jitted JAX forward."""
    import flax.linen as fnn

    def fn(vv, xx):
        io = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            path = context.module.scope.path
            if context.method_name == "__call__" and len(path) == 1:
                io[path[0]] = (args[0], out)
            return out

        with fnn.intercept_methods(record):
            out, upd = model.apply(vv, xx, **kw)
        return out, io, upd

    out, io, upd = jax.jit(fn)(variables, jnp.asarray(x))
    return out, {k: (np.asarray(a), np.asarray(o)) for k, (a, o) in io.items()}, upd


def _module_call(net, name, x, mode, train):
    mod = getattr(net, name)
    x = torch.as_tensor(x)
    if name.startswith("block"):
        return mod(x, mode, train)
    if name == "quant" or name.startswith("requant"):
        return mod(x, mode)
    return mod(x, mode, train)


@pytest.mark.parametrize("phase", ["QAT-train", "QAT_FROZEN"])
def test_generator_qat_modules_fed_the_same_input(phase):
    """QAT and QAT_FROZEN, module by module: each top-level module of the
    port, given the input its JAX twin got, gives its output within one step
    of its grid. QAT_FROZEN (JAX's observers): no more than ``QAT_MOVED`` of
    the values move (measured 0). QAT train (fresh observers): all but
    ``QAT_GRIDS_MOVED`` modules equal to 1e-5 of their range, the observers
    within ``OBS_REL``. The whole forward is chaotic between the packages
    (one grid moved, and the next blocks carry it: 7% of the output's range
    after six blocks here), so it is held module by module, as
    tests/test_torch_qat.py holds the layers."""
    net, jg, v = _generator_pair()
    x = _images(6)
    if phase == "QAT_FROZEN":  # observers and BN statistics from a QAT train forward
        _, upd = jax.jit(lambda vv, xx: jg.apply(vv, xx, mode=J_QAT, train=True,
                                                 mutable=["batch_stats", "quant"]))(
            v, jnp.asarray(x))
        v = {**v, **upd}
        from_jax_variables(net, jax.tree.map(np.asarray, v))
        out, io, _ = _jax_module_io(jg, v, _images(8), mode=J_QAT_FROZEN, mutable=[])
        mode, train = QAT_FROZEN, False
    else:
        out, io, upd = _jax_module_io(jg, v, x, mode=J_QAT, train=True,
                                      mutable=["batch_stats", "quant"])
        mode, train = QAT, True
    names = [n for n, _ in net.named_children()]
    assert sorted(io) == sorted(names)
    exact = 0
    for name in names:
        xin, want = io[name]
        got = _module_call(net, name, xin, mode, train).detach().numpy()
        span = max(float(np.abs(want).max()), 1e-6)
        moved = np.abs(got - want) > 1e-5 * span
        mod = getattr(net, name)
        obs = (mod.skip_add.act if name.startswith("block") else
               mod.act if isinstance(mod, QuantStub) else getattr(mod, "act_obs", None))
        step = (float(obs.max_val) - float(obs.min_val)) / 255 if obs is not None else 0.0
        exact += int(not moved.any())
        assert np.abs(got - want).max() <= 1.01 * step + 1e-5 * span, name
        if phase == "QAT_FROZEN":
            assert moved.mean() <= QAT_MOVED, (name, moved.mean())
    if phase == "QAT-train":
        assert exact >= len(names) - QAT_GRIDS_MOVED
        mine = {k: float(v) for k, v in model_variables(net).items() if k.startswith("quant/")}
        want = {k: float(w) for k, w in flatten_variables({"quant": upd["quant"]}).items()}
        assert sorted(mine) == sorted(want)
        for k in (k for k in want if k.endswith(".min_val")):
            hi = k[:-len(".min_val")] + ".max_val"
            span = want[hi] - want[k]
            err = max(abs(mine[k] - want[k]), abs(mine[hi] - want[hi])) / span
            assert err <= OBS_REL, k


def test_dropout_draws_from_the_generator():
    """``use_dropout``: a 0.5 dropout between a block's convs in train mode
    only, drawn from the given generator (same seed, same output)."""
    net = tnet.define_g(ngf=NGF, netG="resnet_6blocks", use_dropout=True, quantized=False)
    x = torch.as_tensor(_images(7))
    a = net(x, FP32, train=True, generator=torch.Generator().manual_seed(1))
    b = net(x, FP32, train=True, generator=torch.Generator().manual_seed(1))
    c = net(x, FP32, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = tnet.define_g(ngf=NGF, netG="resnet_6blocks", quantized=False)
    plain.load_state_dict(net.state_dict())
    assert torch.equal(net(x, FP32), plain(x, FP32))  # eval: no dropout


def test_gan_init_distribution():
    """The port's own init (a torch.Generator) and the numpy one draw the
    GAN distribution: kernels N(0, 0.02), BN scales 1 + 0.02 N, zero biases."""
    net = tnet.define_g(ngf=16, netG="resnet_9blocks", generator=torch.Generator().manual_seed(3))
    kernels = torch.cat([p.reshape(-1) for n, p in net.named_parameters()
                         if n.endswith("kernel")])
    scales = torch.cat([p for n, p in net.named_parameters() if n.endswith(".scale")])
    assert abs(float(kernels.std()) - 0.02) < 1e-3 and abs(float(kernels.mean())) < 1e-3
    assert abs(float(scales.mean()) - 1) < 5e-3 and abs(float(scales.std()) - 0.02) < 5e-3
    assert all(float(p.abs().max()) == 0 for n, p in net.named_parameters()
               if n.endswith("bias") or n.endswith("bias_bn"))
    tree = flatten_variables(numpy_init(net, 0, init="gan"))
    k = np.concatenate([v.reshape(-1) for n, v in tree.items() if n.endswith("/kernel")])
    assert abs(k.std() - 0.02) < 1e-3
    bs = [v for n, v in tree.items() if n.startswith("batch_stats/") and n.endswith("/var")]
    assert all((v == 1).all() for v in bs)  # running variances stay 1


def test_numpy_gan_init_draw_order():
    """One RandomState in sorted key order, the pair (G, D) drawn in turn."""
    g, d = tnet.define_g(ngf=4), tnet.define_d(ndf=4, input_nc=6)
    tg, td = numpy_init((g, d), 7, init="gan")
    rng = np.random.RandomState(7)
    for tree, net in ((tg, g), (td, d)):
        flat = flatten_variables(tree)
        for key in sorted(model_variables(net)):
            leaf = key.rsplit("/", 1)[1]
            if leaf == "kernel":
                want = (rng.standard_normal(flat[key].shape) * 0.02).astype(np.float32)
            elif leaf == "scale" and key.startswith("params/"):
                want = (1.0 + 0.02 * rng.standard_normal(flat[key].shape)).astype(np.float32)
            else:
                continue
            np.testing.assert_array_equal(flat[key], want, err_msg=key)
    with pytest.raises(ValueError, match="kaiming|gan"):
        numpy_init(g, 0, init="xavier")
