"""PyTorch port, the quant-aware layers in their float phases, against JAX.

``QuantStub``, ``QAdd`` and ``QCat`` in QAT are an add or a concatenate and
one observe + fake-quant site, so they are held bit for bit. ``QConvBNAct``
runs a float convolution (torch on the CPU here, XLA there: the sums are
taken in other orders) and BatchNorm, so it is held to bands, each stated
with its reason; the observers and BN statistics must step exactly once per
forward. The JAX module is jitted with its variables as runtime arguments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.quant.export import flatten_variables, from_jax_variables, model_variables

MODES = {"FP32": (jnn.FP32, tnn.FP32), "QAT": (jnn.QAT, tnn.QAT),
         "QAT_FROZEN": (jnn.QAT_FROZEN, tnn.QAT_FROZEN)}
# (name, cin, cout, kernel, stride, groups, act, use_bn)
CONVS = [("stem", 3, 16, 3, 2, 1, "relu", True), ("depthwise", 24, 24, 5, 1, 24, "relu", True),
         ("reduce", 48, 24, 1, 1, 1, None, True), ("classifier", 32, 10, 1, 1, 1, None, False)]
# Bands. Float32 convolutions differ by reassociation (relative ~1e-6 of
# each output; BN divides by the batch std, which keeps it relative).
REL_FLOAT = 2e-5
# A fake-quantized output can move by one quantum where the two packages'
# pre-quantization values fall on either side of a rounding boundary: at
# most one quantum, on few elements.
FLIP_FRACTION = 0.01


def _conv_case(cfg, seed, observed):
    name, cin, cout, k, s, g, act, use_bn = cfg
    rng = np.random.RandomState(seed)
    params = {"kernel": (rng.randn(k, k, cin // g, cout) * np.sqrt(2.0 / (k * k * cout)))
              .astype(np.float32)}
    bs = {}
    if use_bn:
        params.update(scale=(rng.rand(cout) + 0.5).astype(np.float32),
                      bias_bn=(rng.randn(cout) * 0.1).astype(np.float32))
        bs = {"mean": (rng.randn(cout) * 0.1).astype(np.float32),
              "var": (rng.rand(cout) + 0.5).astype(np.float32)}
    else:
        params["bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
    if observed:
        quant = {"w_obs": jq.ObserverState(np.float32(-0.4), np.float32(0.45)),
                 "act_obs": jq.ObserverState(np.float32(-1.0 if act is None else 0.0),
                                             np.float32(2.5))}
    else:
        quant = {"w_obs": jq.ObserverState(np.float32(np.inf), np.float32(-np.inf)),
                 "act_obs": jq.ObserverState(np.float32(np.inf), np.float32(-np.inf))}
    x = rng.randn(4, 12, 12, cin).astype(np.float32)
    if name != "stem":
        x = np.maximum(x, 0)
    return {"params": params, "batch_stats": bs, "quant": quant}, x


def _jax_conv(cfg, variables, x, mode, train):
    name, cin, cout, k, s, g, act, use_bn = cfg
    mod = jnn.QConvBNAct(cout, k, strides=s, padding=(k - 1) // 2, groups=g, act=act,
                         use_bn=use_bn, use_bias=not use_bn)

    def f(v, xx, w):
        def loss(params):
            y, upd = mod.apply({**v, "params": params}, xx, mode=mode, train=train,
                               mutable=["batch_stats", "quant"])
            return jnp.sum(y * w), (y, upd)

        (_, (y, upd)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
        return y, upd, grads

    return jax.jit(f)


# (phase, observers already calibrated?): a fresh observer snaps to the batch
PHASES = [("QAT-train", False), ("QAT-train", True), ("QAT-eval", True),
          ("QAT_FROZEN-train", True), ("FP32-train", False), ("FP32-eval", False)]


@pytest.mark.parametrize("phase,observed", PHASES,
                         ids=[f"{p}-{'observed' if o else 'fresh'}" for p, o in PHASES])
@pytest.mark.parametrize("cfg", CONVS, ids=[c[0] for c in CONVS])
def test_qconvbnact_matches_jax_within_bands(cfg, phase, observed):
    mode_name, train = phase.split("-")[0], phase.endswith("train")
    jmode, tmode = MODES[mode_name]
    variables, x = _conv_case(cfg, seed=len(phase) + 7 * observed, observed=observed)
    name, cin, cout, k, s, g, act, use_bn = cfg
    w = np.random.RandomState(5).randn(4, (12 - 1) // s + 1, (12 - 1) // s + 1, cout) \
        .astype(np.float32)
    jy, upd, jgrads = _jax_conv(cfg, variables, x, jmode, train)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), jnp.asarray(w))

    conv = tnn.QConvBNAct(cin, cout, k, strides=s, padding=(k - 1) // 2, groups=g, act=act,
                          use_bn=use_bn, use_bias=not use_bn)
    from_jax_variables(conv, variables)
    y = conv(torch.as_tensor(x), tmode, train)
    (y * torch.as_tensor(w)).sum().backward()
    jy = np.asarray(jy)
    got = y.detach().numpy()
    assert got.shape == jy.shape and got.dtype == np.float32

    new = {**variables, **jax.tree.map(np.asarray, upd)}
    want_vars = flatten_variables(new)
    mine = {k_: v.detach().numpy() for k_, v in model_variables(conv).items()}
    for key, want in want_vars.items():
        if key.startswith("params/"):
            continue
        was = flatten_variables(variables)[key]
        steps = jmode.observe if key.startswith("quant/") else train
        if steps:  # one step of an EMA on values that agree to REL_FLOAT
            np.testing.assert_allclose(mine[key], want, rtol=REL_FLOAT, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(want, was, err_msg=f"{key} stepped in JAX")
            np.testing.assert_array_equal(mine[key], was, err_msg=f"{key} stepped")

    diff = np.abs(got - jy)
    # BN subtracts the batch mean: errors scale with the tensor, not the element
    near = diff <= REL_FLOAT * np.abs(jy).max()
    if jmode.fake_quant:
        # the grids agree to REL_FLOAT (their observers do); flipped codes
        # are one quantum apart
        s_act, _ = tq.calculate_qparams_traced(conv.act_obs.live(), conv.qconfig.activation)
        assert (~near).mean() <= FLIP_FRACTION, (~near).mean()
        assert diff.max() <= float(s_act) * 1.0001, (diff.max(), float(s_act))
    else:
        assert near.all(), diff.max()
    # gradients: the STE masks agree except at flipped elements, so compare
    # the whole gradient in relative L2
    for pname, jg in jgrads.items():
        tg = getattr(conv, pname).grad.numpy()
        err = np.linalg.norm(tg - np.asarray(jg)) / max(np.linalg.norm(np.asarray(jg)), 1e-12)
        assert err < 1e-3, (pname, err)


@pytest.mark.parametrize("mode", ["QAT", "QAT_FROZEN", "FP32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_stub_qadd_qcat_match_jax(mode, dtype):
    """The observe + fake-quant sites of the boundary and the binary ops,
    bit for bit. In bf16 the QAdd is left out: the port rounds the bf16 sum
    to bf16, as the module's code says, while XLA on the CPU keeps it in
    float32 inside the fused site (its default excess precision), so the
    observed max can differ by a bf16 ulp."""
    jmode, tmode = MODES[mode]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                           torch.bfloat16)
    rng = np.random.RandomState(3)
    a = (rng.randn(2, 8, 8, 16) * 2).astype(np.float32)
    b = np.maximum(rng.randn(2, 8, 8, 16), 0).astype(np.float32)
    obs = {"act": jq.ObserverState(np.float32(-2.0), np.float32(3.0))}
    tree = {"quant": obs}

    def run_jax(mod, *args):
        f = jax.jit(lambda v, *xs: mod.apply(v, *xs, mode=jmode, mutable=["quant"]))
        return f(jax.tree.map(jnp.asarray, tree), *args)

    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    ta, tb = torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt)
    cases = [(jnn.QuantStub(), (ja,), tnn.QuantStub(), (ta,)),
             (jnn.QCat(), ([ja, jb],), tnn.QCat(), ([ta, tb],))]
    if dtype == "float32":
        cases.append((jnn.QAdd(), (ja, jb), tnn.QAdd(), (ta, tb)))
    for jmod, jargs, tmod, targs in cases:
        jy, upd = run_jax(jmod, *jargs)
        from_jax_variables(tmod, tree)
        y = tmod(*targs, tmode)
        assert y.dtype == tdt
        np.testing.assert_array_equal(y.to(torch.float32).numpy(),
                                      np.asarray(jnp.asarray(jy).astype(jnp.float32)))
        st = upd["quant"]["act"]
        assert float(tmod.act.min_val) == float(st.min_val)
        assert float(tmod.act.max_val) == float(st.max_val)


def test_bf16_block_output_dtype():
    """In a bf16 model each block's output is stored in bf16, its BN and
    fake-quant arithmetic in float32 (frostnet_tpu/nn/conv.py:565-574)."""
    conv = tnn.QConvBNAct(8, 16, 3, padding=1, dtype=torch.bfloat16)
    from_jax_variables(conv, {"params": {"kernel": np.random.RandomState(0).randn(3, 3, 8, 16)
                                         .astype(np.float32) * 0.1,
                                         "scale": np.ones(16, np.float32),
                                         "bias_bn": np.zeros(16, np.float32)},
                              "batch_stats": {"mean": np.zeros(16, np.float32),
                                              "var": np.ones(16, np.float32)},
                              "quant": {"w_obs": tq.init_observer(), "act_obs": tq.init_observer()}})
    x = torch.randn(2, 6, 6, 8)
    for mode in (tnn.FP32, tnn.QAT, tnn.QAT_FROZEN):
        y = conv(x, mode, train=True)
        assert y.dtype == torch.bfloat16 and y.shape == (2, 6, 6, 16)
    assert conv.kernel.dtype == torch.float32 and conv.mean.dtype == torch.float32
