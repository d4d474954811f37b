"""The port's detection core against the JAX package, on the CPU.

Priors, ``SyntheticDetection`` batches, the VOC reader and mAP are
bit-equal; prior matching gives equal integer targets (the matched truth
behind ``conf_t``) and loc targets within ``boxes.LOG_EXP_ULPS`` float32
ulps (XLA's CPU ``log`` against torch's); the hard-negative rank equals JAX's
``argsort(argsort(-x))`` on tie-heavy values; the MultiBox loss agrees
within 2e-6 relative; ``nms_fixed`` keeps the same boxes on JAX's own
inputs, ties in score included; ``detect`` within ``LOG_EXP_ULPS`` of JAX's
boxes with equal keep masks. The JAX side runs jitted.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu.detection import anchors as ja, boxes as jb, data as jd, evaluate as je
from frostnet_tpu.detection import losses as jl, nms as jn
from frostnet_tpu_torch.detection import anchors as ta, boxes as tb, data as td
from frostnet_tpu_torch.detection import evaluate as te, losses as tl, nms as tn

pytestmark = pytest.mark.usefixtures("few_threads")
PRIORS = np.array(ja.make_priors(ja.VOC_CFG))


def _ulps(a, b):
    """float32 ulps between ``a`` and ``b``, elementwise (sign-aware ints)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


_jax_match = jax.jit(lambda b, l, v: jb.batched_match_priors(b, l, v, PRIORS, 0.5, (0.1, 0.2)))


def _close(got, want):
    """Within ``LOG_EXP_ULPS`` float32 ulps of 1 (or of the value, where it
    is larger): a difference of the log/exp, or of an FMA, before a
    cancellation stays that small in absolute terms."""
    tol = tb.LOG_EXP_ULPS * np.spacing(np.float32(1.0)) * np.maximum(1.0, np.abs(want))
    return float((np.abs(got - want) / tol).max())


def _gt(seed, batch=4, max_gt=50):
    """Seeded padded truths with a duplicate box (a tie that the later
    truth wins) and a fully padded image."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    labels = np.zeros((batch, max_gt), np.int32)
    valid = np.zeros((batch, max_gt), bool)
    for b in range(batch - 1):
        n = rng.randint(1, 12)
        xy = rng.rand(n, 2) * 0.7
        wh = rng.rand(n, 2) * 0.3 + 0.02
        boxes[b, :n] = np.concatenate([xy, np.clip(xy + wh, 0, 1)], 1)
        labels[b, :n] = rng.randint(0, 20, n)
        valid[b, :n] = True
        if n > 1:
            boxes[b, n - 1] = boxes[b, 0]
    return boxes, labels, valid


@pytest.mark.parametrize("name", sorted(ja.CONFIGS))
def test_priors_bit_equal(name):
    want = ja.make_priors(ja.CONFIGS[name])
    got = ta.make_priors(ta.CONFIGS[name])
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert {k: v for k, v in ta.CONFIGS[name].items()} == ja.CONFIGS[name]
    assert len(PRIORS) == 8732


def test_geometry_against_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(40, 4).astype(np.float32)
    a[:, 2:] += a[:, :2]
    pf = np.asarray(jax.jit(jb.point_form)(PRIORS))
    np.testing.assert_array_equal(tb.point_form(torch.as_tensor(PRIORS)).numpy(), pf)
    np.testing.assert_array_equal(tb.center_form(torch.as_tensor(a)).numpy(),
                                  np.asarray(jax.jit(jb.center_form)(a)))
    want = np.asarray(jax.jit(jb.jaccard)(a, pf))
    got = tb.jaccard(torch.as_tensor(a), torch.as_tensor(pf)).numpy()
    assert _ulps(got, want).max() <= tb.IOU_ULPS


@pytest.mark.parametrize("seed", [0, 1])
def test_match_priors_against_jax(seed):
    """Equal integer targets; loc targets within LOG_EXP_ULPS ulps."""
    boxes, labels, valid = _gt(seed)
    loc_j, conf_j = _jax_match(boxes, labels, valid)
    loc_t, conf_t = tb.batched_match_priors(torch.as_tensor(boxes), torch.as_tensor(labels),
                                            torch.as_tensor(valid), torch.as_tensor(PRIORS))
    np.testing.assert_array_equal(conf_t.numpy(), np.asarray(conf_j))
    assert (conf_t.numpy() > 0).sum() > 50
    assert _close(loc_t.numpy(), np.asarray(loc_j)) <= 1
    one_l, one_c = tb.match_priors(*(torch.as_tensor(v[0]) for v in (boxes, labels, valid)),
                                   torch.as_tensor(PRIORS))
    np.testing.assert_array_equal(one_c.numpy(), conf_t[0].numpy())


def test_duplicate_truths_later_wins():
    """Two identical truths claim the same best prior; the later one (its
    label) wins it, as the reference's sequential loop overwrites."""
    boxes = np.zeros((1, 3, 4), np.float32)
    boxes[0, :2] = [0.2, 0.2, 0.5, 0.6]
    labels = np.array([[3, 7, 0]], np.int32)
    valid = np.array([[True, True, False]])
    _, conf = tb.batched_match_priors(torch.as_tensor(boxes), torch.as_tensor(labels),
                                      torch.as_tensor(valid), torch.as_tensor(PRIORS))
    _, conf_j = _jax_match(boxes, labels, valid)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(conf_j))
    # the forced best priors go to the later truth (label 7 -> 8), the
    # others over the threshold to the first maximum (label 3 -> 4)
    assert set(np.unique(conf.numpy())) == {0, 4, 8}


def test_encode_decode_against_jax():
    rng = np.random.RandomState(3)
    loc = (rng.randn(2, len(PRIORS), 4) * 0.8).astype(np.float32)
    got = tb.decode(torch.as_tensor(loc), torch.as_tensor(PRIORS)).numpy()
    want = np.asarray(jax.jit(jb.decode)(loc, PRIORS))
    assert _close(got, want) <= 1
    matched = np.clip(want[0], 0.0, 1.0)
    matched[:, 2:] = np.maximum(matched[:, 2:], matched[:, :2] + 1e-3)
    got = tb.encode(torch.as_tensor(matched), torch.as_tensor(PRIORS)).numpy()
    want = np.asarray(jax.jit(jb.encode)(matched, PRIORS))
    assert _close(got, want) <= 1


def test_smooth_l1_against_jax():
    from frostnet_tpu.utils.losses import smooth_l1 as jsl
    from frostnet_tpu_torch.utils.losses import smooth_l1

    rng = np.random.RandomState(4)
    a, b = (rng.randn(500).astype(np.float32) * 2 for _ in range(2))
    for beta in (1.0, 0.5):
        np.testing.assert_array_equal(
            smooth_l1(torch.as_tensor(a), torch.as_tensor(b), beta).numpy(),
            np.asarray(jax.jit(jsl, static_argnums=2)(a, b, beta)))


def test_negative_rank_ties_like_jax():
    """Quarter-step values and the positives' zeros: thousands of ties,
    ordered by prior index as JAX's stable argsort orders them."""
    rng = np.random.RandomState(5)
    x = (np.round(rng.rand(4, len(PRIORS)) * 4) / 4).astype(np.float32)
    x[rng.rand(*x.shape) < 0.1] = 0.0
    want = np.asarray(jax.jit(lambda v: jnp.argsort(jnp.argsort(-v, axis=1), axis=1))(x))
    np.testing.assert_array_equal(tl.negative_rank(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("logits", ["random", "constant"])
def test_multibox_loss_against_jax(logits):
    """Random logits, and constant ones (every negative's loss ties)."""
    boxes, labels, valid = _gt(6)
    rng = np.random.RandomState(7)
    loc = (rng.randn(4, len(PRIORS), 4) * 0.5).astype(np.float32)
    conf = (rng.randn(4, len(PRIORS), 21) if logits == "random"
            else np.zeros((4, len(PRIORS), 21))).astype(np.float32)
    want = jax.jit(jl.multibox_loss)(loc, conf, boxes, labels, valid, PRIORS)
    lt, ct = torch.tensor(loc, requires_grad=True), torch.tensor(conf, requires_grad=True)
    got = tl.multibox_loss(lt, ct, *(torch.as_tensor(v) for v in (boxes, labels, valid)),
                           torch.as_tensor(PRIORS))
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 2e-6 * abs(float(w)), (g.item(), float(w))
    # the gradients (the mined mask decides which priors get one)
    gj = jax.jit(jax.grad(lambda lo, co: sum(jl.multibox_loss(lo, co, boxes, labels, valid,
                                                              PRIORS)), argnums=(0, 1)))(loc, conf)
    sum(got).backward()
    for g, w in zip((lt.grad, ct.grad), gj):
        np.testing.assert_array_equal(g.numpy() != 0, np.asarray(w) != 0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-7)


def _jax_decoded(seed, batch=2):
    rng = np.random.RandomState(seed)
    loc = (rng.randn(batch, len(PRIORS), 4) * 0.3).astype(np.float32)
    logits = (rng.randn(batch, len(PRIORS), 21) * 3).astype(np.float32)
    scores = np.asarray(jax.nn.softmax(logits, axis=-1))
    return loc, scores


@pytest.mark.parametrize("top_k", [50, 200])
def test_nms_fixed_keeps_what_jax_keeps(top_k):
    """On JAX's decoded boxes, with scores rounded to 1/64 (many equal
    scores: ``lax.top_k``'s lower-index-first order) and exact ones."""
    loc, scores = _jax_decoded(8)
    boxes = np.asarray(jax.jit(jb.decode)(loc[0], PRIORS))
    for s in (scores[0, :, 5], np.round(scores[0, :, 9] * 64) / 64):
        s = s.astype(np.float32)
        jbx, jsc, jk = jax.jit(jn.nms_fixed, static_argnums=(2, 3))(boxes, s, 0.45, top_k)
        tbx, tsc, tk = tn.nms_fixed(torch.as_tensor(boxes), torch.as_tensor(s), 0.45, top_k)
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        np.testing.assert_array_equal(tbx.numpy(), np.asarray(jbx))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert 0 < tk.numpy().sum() < top_k


@pytest.mark.parametrize("conf_thresh,top_k", [(0.01, 200), (0.25, 50)])
def test_detect_against_jax(conf_thresh, top_k):
    loc, scores = _jax_decoded(9)
    want = np.asarray(jax.jit(jn.detect, static_argnums=(3, 4, 5))(
        loc, scores, PRIORS, conf_thresh, 0.45, top_k))
    got = tn.detect(torch.as_tensor(loc), torch.as_tensor(scores), torch.as_tensor(PRIORS),
                    conf_thresh, 0.45, top_k).numpy()
    assert got.shape == want.shape == (2, 21, top_k, 5)
    np.testing.assert_array_equal(got[..., 0] > 0, want[..., 0] > 0)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert _close(got[..., 1:], want[..., 1:]) <= 1
    assert (want[..., 0] > 0).sum() > 20


def _records(seed, num_classes=21, images=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(images):
        dets = np.zeros((num_classes, 30, 5), np.float32)
        n = rng.randint(1, 8)
        xy = rng.rand(n, 2) * 0.6
        gt = np.concatenate([xy, xy + rng.rand(n, 2) * 0.3 + 0.05], 1).astype(np.float32)
        gl = rng.randint(0, num_classes - 1, n).astype(np.int32)
        for c in range(1, num_classes):
            k = rng.randint(0, 12)
            dets[c, :k, 0] = np.sort(rng.rand(k))[::-1]
            base = gt[rng.randint(0, n, k)] + rng.randn(k, 4).astype(np.float32) * 0.03
            dets[c, :k, 1:] = base
        out.append((dets, gt, gl))
    return out


def test_map_bit_equal():
    """``match_detections``, ``aps_from_records`` and ``voc_ap`` (both
    metrics) give the JAX package's numbers bit for bit."""
    res = []
    for mod in (je, te):
        dets, npos = [[] for _ in range(21)], np.zeros(21, np.int64)
        for d, gt, gl in _records(10):
            mod.match_detections(dets, npos, d, gt, gl, 21, 0.5)
        res.append((dets, npos, mod.aps_from_records(dets, npos, 21)))
    (dj, nj, aj), (dt, nt, at) = res
    assert dj == dt and np.array_equal(nj, nt) and np.array_equal(aj, at)
    assert (aj > 0).sum() > 5
    rng = np.random.RandomState(11)
    rec, prec = np.sort(rng.rand(50)), rng.rand(50)
    for m07 in (True, False):
        assert je.voc_ap(rec, prec, m07) == te.voc_ap(rec, prec, m07)


def test_synthetic_batches_bit_equal():
    a = list(jd.SyntheticDetection(20, 300, 8, 4, seed=3))
    b = list(td.SyntheticDetection(20, 300, 8, 4, seed=3))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert set(x) == set(y) == {"image", "boxes", "labels", "valid"}
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_ssd_augment_against_jax():
    """The whole train pipeline (photometric, expand, crop, mirror, resize,
    BGR mean subtraction) from one RandomState state, over several draws."""
    rng_img = np.random.RandomState(12)
    img = rng_img.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    boxes = np.array([[10, 12, 60, 70], [50, 20, 110, 85]], np.float32)
    labels = np.array([3, 14], np.int32)
    for seed in range(6):
        outs = [m.ssd_augment(img, boxes.copy(), labels.copy(), np.random.RandomState(seed))
                for m in (jd, td)]
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(*(m.pad_targets(boxes / 120, labels) for m in (jd, td))):
        np.testing.assert_array_equal(x, y)


def test_voc_reader_bit_equal(tmp_path):
    """A two-image VOCdevkit tree: both readers' batches bit for bit."""
    from PIL import Image

    base = tmp_path / "VOC2007"
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(base / d)
    rng = np.random.RandomState(13)
    for i, name in enumerate(("000001", "000002")):
        Image.fromarray(rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)).save(
            base / "JPEGImages" / f"{name}.jpg")
        objs = "".join(
            f"<object><name>{c}</name><difficult>{d}</difficult><bndbox><xmin>{5 + i}</xmin>"
            f"<ymin>6</ymin><xmax>{40 + i}</xmax><ymax>50</ymax></bndbox></object>"
            for c, d in (("dog", 0), ("car", 1), ("person", 0)))
        (base / "Annotations" / f"{name}.xml").write_text(f"<annotation>{objs}</annotation>")
    (base / "ImageSets" / "Main" / "trainval.txt").write_text("000001\n000002\n")
    for train in (True, False):
        a, b = (list(m.VOCDetection(str(tmp_path), image_sets=(("2007", "trainval"),),
                                    batch_size=2, train=train, seed=1)) for m in (jd, td))
        assert len(a) == len(b) == 1
        for k in a[0]:
            np.testing.assert_array_equal(a[0][k], b[0][k])
