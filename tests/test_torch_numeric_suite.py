"""PyTorch port, the numeric suite (per-layer INT8 vs QAT_FROZEN) against JAX.

``frostnet_quant_small_0_35`` at 32x32, 10 classes, calibrated in JAX
(random init and two QAT forwards), fbgemm and qnnpack; the port is filled
with the same variables. ``compare_modes`` must give the rows of JAX's: the
same paths (JAX's module names, ``<output>`` the model) and shapes, the
worst error within one output quantum of JAX's on every quantized row,
``max_abs`` within one quantum too, and the SQNR within ``SQNR_DB`` where
either is below ``SQNR_EXACT``. Measured here: no row below it in either
package. JAX reports every row exact (inf); the port reports some fbgemm
rows at about 138 dB, where its frozen grid's scale is one float32 ulp from
the traced grid that JAX's suite and the QAT_FROZEN pass use (max_quanta
4e-6). Layers only one mode calls are warned about and excluded, as in JAX;
a fused model is compared unfused and is left as it was.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import calibrated_jax_variables, few_threads  # noqa: F401 - a fixture
from frostnet_tpu.quant.numeric_suite import compare_modes as jax_compare_modes
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.quant import freeze, from_jax_variables, get_qconfig
from frostnet_tpu_torch.quant.numeric_suite import (LayerReport, _walk, cli, compare_modes,
                                                    format_report)

NAME, SIZE = "frostnet_quant_small_0_35", 32
SQNR_DB = 0.5  # |port - JAX| per row, where either is below SQNR_EXACT
# above it a row differs by the scale's last bit only: the port's INT8 runs
# frozen, on the folded grids, JAX's suite on the traced ones
SQNR_EXACT = 100.0


@pytest.mark.parametrize("backend", ["fbgemm", "qnnpack"])
def test_rows_match_jax(backend, few_threads):  # noqa: F811
    model, variables, images = calibrated_jax_variables(NAME, backend, SIZE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's Dropout_0 runs in one mode only
        want = {r.path: r for r in jax_compare_modes(model, variables, jnp.asarray(images))}
    port = create_model(NAME, num_classes=10, qconfig=get_qconfig(backend), fuse_int8=True)
    from_jax_variables(port, {k: v for k, v in variables.items()})
    serving = freeze(port, "cpu", SIZE)
    served = serving(images)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port's modules all run in both modes
        rows = compare_modes(port, images)
    got = {r.path: r for r in rows}
    assert set(got) == set(want)
    assert len(got) > 80
    for path, r in got.items():
        w = want[path]
        assert r.shape == w.shape, path
        assert (r.scale is None) == (w.scale is None), path
        if r.scale is not None:
            # JAX's suite runs INT8 with the variables as jit arguments, so its
            # grids come from the traced qparams: an ulp from the frozen ones
            assert r.scale == pytest.approx(w.scale, rel=1e-6, abs=0), path
            assert abs(r.max_quanta - w.max_quanta) <= 1.0, path
            assert abs(r.max_abs - w.max_abs) <= r.scale, path
        if min(r.sqnr_db, w.sqnr_db) < SQNR_EXACT:
            print(f"{backend} {path}: SQNR {r.sqnr_db:.3f} dB, JAX {w.sqnr_db:.3f} dB")
            assert abs(r.sqnr_db - w.sqnr_db) <= SQNR_DB, path
    assert [r.sqnr_db for r in rows] == sorted(r.sqnr_db for r in rows)
    # the frozen fused model passed in is untouched: it still serves fused
    assert all(b.fuse_int8 for b in port.blocks)
    assert torch.equal(serving(images), served)


def test_walk_suffixes_repeated_calls_and_tuples():
    t = torch.zeros(1)
    out = {}
    _walk((t,), "a", out)
    _walk((t, t), "b", out)
    _walk(((t, t),), "c", out)
    _walk((t,), "", out)
    assert sorted(out) == ["<output>", "a", "b#0", "b#1", "c#0", "c#1"]


def test_format_and_cli(capsys, few_threads):  # noqa: F811
    rows = [LayerReport("a/b", (1, 2), float("inf"), 0.0, 0.0, 0.1),
            LayerReport("c", (3,), 12.34, 0.5, None, None)]
    text = format_report(rows, 1).splitlines()
    assert len(text) == 2 and text[1].split()[-2:] == ["0", "0.0"] and "inf" in text[1]
    rows = cli(["--model", NAME, "--num_classes", "10", "--image_size", "32", "--batch_size",
                "2", "--calib_batches", "1", "--top", "3", "--device", "cpu"])
    assert len(capsys.readouterr().out.splitlines()) == 4 and len(rows) > 80
