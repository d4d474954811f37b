"""The INT8 conv routes that ``QConvBNAct.prepare_int8`` once refused,
against the JAX package's frozen ``QConvBNAct`` (``frostnet_tpu/nn/conv.py``
INT8 branch), each layer built alone in both packages:

* a padded 1x1 conv: the codes padded with the input's zero point, the
  strided slice, then the matmul kernel's operand (its plain version here);
* a dilated grouped conv: the grouped route's exact int32 sum with the
  taps ``dilation`` apart (JAX's ``rhs_dilation``);
* depthwise convs whose kernel is not square or whose padding is not
  'same': the shifted taps at any kh, kw and padding.

No registered model reaches them. Every code is bit-equal to JAX
``freeze()`` of the same variables, in qnnpack and fbgemm.
"""
import pytest

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.quant import get_qconfig
from test_torch_blocks import _block_input, _block_tree, _calibrate_jax, _int8_compare

pytestmark = pytest.mark.usefixtures("few_threads")

# (name, cin, cout, kernel, stride, padding, dilation, groups, act, route)
ROUTES = [
    ("padded_1x1", 16, 24, 1, 1, 1, 1, 1, "relu", "matmul"),
    ("padded_1x1_s2_pair", 16, 24, 1, 2, (2, 1), 1, 1, None, "matmul"),
    ("dilated_grouped", 16, 32, 3, 1, 2, 2, 4, "relu", "grouped"),
    ("dilated_grouped_s2", 16, 16, 3, 2, 1, 3, 2, "relu6", "grouped"),
    ("depthwise_3x5", 16, 16, (3, 5), 1, (1, 2), 1, 16, "relu", "depthwise"),
    ("depthwise_valid_s2", 16, 16, 3, 2, 0, 1, 16, None, "depthwise"),
    ("depthwise_1x3_dilated", 16, 16, (1, 3), 1, (0, 1), 2, 16, "relu", "depthwise"),
]


def _pair(cfg, backend):
    _, cin, cout, k, s, p, d, g, act, _ = cfg
    kw = dict(strides=s, padding=p, dilation=d, groups=g, act=act)
    jmod = jnn.QConvBNAct(cout, k, qconfig=jq.get_qconfig(backend), **kw)
    port = tnn.QConvBNAct(cin, cout, k, qconfig=get_qconfig(backend), **kw)
    return jmod, port


@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
@pytest.mark.parametrize("cfg", ROUTES, ids=lambda c: c[0])
def test_route_codes_bit_equal_to_jax_freeze(cfg, backend):
    jmod, port = _pair(cfg, backend)
    q, grid, xf = _block_input(cfg[1], 301, size=13)
    tree = _calibrate_jax(jmod, _block_tree(port, 302), xf, {"train": False})
    flips, worst, _ = _int8_compare(jmod, port, tree, q, grid, {"train": False})
    assert port._route == cfg[9]
    assert flips == 0, (flips, worst)
