"""The port's ``io.ImageRecordIter`` (mxnet_tpu_torch) against the
reference's (mxnet_tpu), on the CPU, over a ``.rec`` of 40 JPEGs of 56-72
px that the test writes (labels 0-39), ``data_shape`` (3, 48, 48), batch 16
(so the third batch is padded):

- every batch bit for bit the reference's: sequential with the last
  batch padded by row 0, with ``resize``, and with ``shuffle`` +
  ``rand_crop`` + ``rand_mirror`` at ``preprocess_threads=1`` from one
  numpy seed (the global generator, or ``rng=RandomState``), with the
  mean/std normalisation; shuffling without an index (with its warning);
  ``round_batch`` accepted and ignored;
- with 3 decode threads the labels come in the same order as with 1;
- a reset mid-epoch, with decodes in flight, gives the full epoch again;
- ``num_parts=2`` gives an exact disjoint cover, the reference's parts, in
  index and sequential modes; a bad ``part_index`` raises;
- an undecodable record and a bad magic reach the consumer as errors;
- no decode or producer thread is left after ``close()`` or after the
  iterator is dropped, and a closed iterator raises until ``reset``;
- the slice as a whole: a small conv net (3x3 conv, BatchNorm, relu,
  pooling, FC, ``SoftmaxOutput``) through ``Module.fit`` for 2 batches of
  20 from ``ImageRecordIter``, the FC weight set by ``Variable(init=)``:
  losses and parameters within rtol 1e-4 of the reference's.

A ``cuda`` test holds the batches on ``gpu(0)`` against the ``cpu()``
ones.
"""
import contextlib
import gc
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

N_IMG, SHAPE, BATCH = 40, (3, 48, 48), 16
MEAN_STD = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                std_r=58.393, std_g=57.12, std_b=57.375)
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def _photo(r, h, w):
    """A smooth BGR image with a rectangle and a disc on it."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx, ph = r.uniform(0.02, 0.12, 3)
        img[..., c] = 128 + 80 * np.sin(fy * y + fx * x + 6 * ph)
    y0, x0 = r.randint(0, h // 2), r.randint(0, w // 2)
    img[y0:y0 + h // 4, x0:x0 + w // 3] = r.uniform(0, 255, 3)
    cy, cx, rad = r.randint(0, h), r.randint(0, w), r.randint(5, 15)
    img[(y - cy) ** 2 + (x - cx) ** 2 < rad ** 2] = r.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write(path, n=N_IMG, bad=None, seed=0):
    r = np.random.RandomState(seed)
    rec, idx = str(path) + ".rec", str(path) + ".idx"
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for k in range(n):
        h, wd = r.randint(56, 73, 2)
        header = tmx.recordio.IRHeader(0, float(k), k, 0)
        if k == bad:
            w.write_idx(k, tmx.recordio.pack(header, b"not a jpeg"))
        else:
            w.write_idx(k, tmx.recordio.pack_img(header, _photo(r, h, wd)))
    w.close()
    return rec, idx


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("imgrec") / "img")


@contextlib.contextmanager
def _iter(pkg, rec_path, **kw):
    extra = {"ctx": tmx.cpu()} if pkg is tmx and "ctx" not in kw else {}
    it = pkg.io.ImageRecordIter(rec_path, SHAPE, kw.pop("batch_size", BATCH),
                                **kw, **extra)
    try:
        yield it
    finally:
        it.close()


def _drain(pkg, rec_path, seed=None, **kw):
    if seed is not None:
        np.random.seed(seed)
    with _iter(pkg, rec_path, **kw) as it:
        return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gd, wd)


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("imgrec-decode", "imgrec-producer"))]


def _assert_no_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _threads(), _threads()


def test_sequential_batches_match_with_padded_last(rec):
    got = _drain(tmx, rec[0], preprocess_threads=2, **MEAN_STD)
    _assert_same(got, _drain(mx, rec[0], preprocess_threads=2, **MEAN_STD))
    assert [p for _, _, p in got] == [0, 0, 8]
    data, label, _ = got[2]
    np.testing.assert_array_equal(label[:8], np.arange(32, 40))
    for row in range(8, 16):                 # the padding repeats row 0
        np.testing.assert_array_equal(data[row], data[0])
        assert label[row] == label[0]
    assert data.dtype == np.float32 and data.shape == (16,) + SHAPE


def test_resize_and_index_match(rec):
    kw = dict(path_imgidx=rec[1], resize=60, preprocess_threads=3)
    _assert_same(_drain(tmx, rec[0], **kw), _drain(mx, rec[0], **kw))


@pytest.mark.parametrize("port_rng", ["global", "RandomState"])
def test_random_arms_match_at_one_thread(rec, port_rng):
    kw = dict(path_imgidx=rec[1], shuffle=True, rand_crop=True,
              rand_mirror=True, preprocess_threads=1, **MEAN_STD)
    want = _drain(mx, rec[0], seed=7, **kw)
    if port_rng == "global":
        got = _drain(tmx, rec[0], seed=7, **kw)
    else:
        got = _drain(tmx, rec[0], rng=np.random.RandomState(7), **kw)
    _assert_same(got, want)
    labels = np.concatenate([lab[:BATCH - p] for _, lab, p in got])
    assert sorted(labels) == list(range(N_IMG))
    assert list(labels) != list(range(N_IMG))


def test_three_threads_keep_the_label_order(rec):
    kw = dict(path_imgidx=rec[1], shuffle=True, rand_crop=True,
              rand_mirror=True)
    one = _drain(tmx, rec[0], seed=3, preprocess_threads=1, **kw)
    three = _drain(tmx, rec[0], seed=3, preprocess_threads=3, **kw)
    for (_, a, pa), (_, b, pb) in zip(one, three):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    g = np.random.default_rng(5)
    gen = _drain(tmx, rec[0], rng=g, preprocess_threads=1, **kw)
    again = _drain(tmx, rec[0], rng=np.random.default_rng(5),
                   preprocess_threads=1, **kw)
    _assert_same(gen, again)


def test_shuffle_without_index_loads_into_memory(rec):
    with pytest.warns(UserWarning, match="into memory"):
        got = _drain(tmx, rec[0], seed=11, shuffle=True)
    with pytest.warns(UserWarning):
        want = _drain(mx, rec[0], seed=11, shuffle=True)
    _assert_same(got, want)


def test_round_batch_is_ignored(rec):
    _assert_same(_drain(tmx, rec[0], round_batch=False),
                 _drain(tmx, rec[0], round_batch=True))


def test_reset_mid_epoch_with_decodes_in_flight(rec):
    want = _drain(mx, rec[0], preprocess_threads=3)
    with _iter(tmx, rec[0], preprocess_threads=3, prefetch_buffer=2) as it:
        next(it)
        it.reset()
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in it]
        it.reset()
        _assert_same([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                      for b in it], want)
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["index", "sequential"])
def test_num_parts_is_an_exact_disjoint_cover(rec, mode):
    kw = {"path_imgidx": rec[1]} if mode == "index" else {}
    seen = []
    for part in range(2):
        got = _drain(tmx, rec[0], num_parts=2, part_index=part, **kw)
        _assert_same(got, _drain(mx, rec[0], num_parts=2, part_index=part,
                                 **kw))
        seen.append([int(v) for _, lab, p in got for v in lab[:BATCH - p]])
    assert not set(seen[0]) & set(seen[1])
    assert sorted(seen[0] + seen[1]) == list(range(N_IMG))
    if mode == "index":
        assert seen[0] == list(range(20))
    else:
        assert seen[0] == list(range(0, N_IMG, 2))


def test_bad_part_index_raises(rec):
    for pkg in (tmx, mx):
        with pytest.raises(pkg.MXNetError, match="part_index 2 out of range"):
            pkg.io.ImageRecordIter(rec[0], SHAPE, BATCH, num_parts=2,
                                   part_index=2)


def test_corrupt_record_and_bad_magic_reach_the_consumer(tmp_path):
    rec_path, _ = _write(tmp_path / "bad", n=24, bad=20)
    with _iter(tmx, rec_path, preprocess_threads=2) as it:
        assert next(it).pad == 0
        with pytest.raises(tmx.MXNetError, match="cannot decode"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)
    raw = bytearray(open(rec_path, "rb").read())
    raw[0] ^= 0xFF
    (tmp_path / "magic.rec").write_bytes(bytes(raw))
    with _iter(tmx, str(tmp_path / "magic.rec")) as it:
        with pytest.raises(tmx.MXNetError, match="magic"):
            next(it)
    _assert_no_threads()


def test_no_thread_left_after_close_or_drop(rec):
    it = tmx.io.ImageRecordIter(rec[0], SHAPE, BATCH, preprocess_threads=3,
                                ctx=tmx.cpu())
    next(it)
    assert _threads()
    it.close()
    _assert_no_threads()
    with pytest.raises(tmx.MXNetError, match="after close"):
        next(it)
    it.reset()                               # reset brings it back
    assert len(list(it)) == 3
    it.close()
    _assert_no_threads()
    it = tmx.io.ImageRecordIter(rec[0], SHAPE, BATCH, preprocess_threads=3,
                                ctx=tmx.cpu())
    next(it)
    del it
    gc.collect()
    _assert_no_threads()


def _convnet(pkg, classes=N_IMG):
    s = pkg.sym
    x = s.Convolution(s.var("data"), kernel=(3, 3), pad=(1, 1),
                      num_filter=8, no_bias=True, name="conv0")
    x = s.BatchNorm(x, fix_gamma=False, name="bn0")
    x = s.Activation(x, act_type="relu", name="relu0")
    x = s.Pooling(x, kernel=(4, 4), stride=(4, 4), pool_type="max",
                  name="pool")
    w = s.Variable("fc_weight", init=pkg.init.Constant(0.01))
    x = s.FullyConnected(s.Flatten(x, name="flat"), weight=w,
                         num_hidden=classes, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def test_module_fit_from_image_record_iter_matches_reference(rec,
                                                             monkeypatch):
    """Two batches of 20, SGD with momentum; the conv weights from one
    numpy seed, the FC weight from its variable's ``Constant(0.01)``."""
    monkeypatch.delenv("MXNET_CKPT_DIR", raising=False)
    net = _convnet(mx)
    arg_shapes, _, _ = net.infer_shape(data=(20,) + SHAPE)
    r = np.random.default_rng(1)
    seeded = {n: (0.2 * r.standard_normal(s)).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n.startswith(("conv", "bn"))}
    out = {}
    for pkg in (mx, tmx):
        c = {} if pkg is mx else {"ctx": tmx.cpu()}
        losses = []
        with _iter(pkg, rec[0], batch_size=20, preprocess_threads=2,
                   **MEAN_STD) as it:
            mod = pkg.mod.Module(_convnet(pkg), context=[pkg.cpu()])
            mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                      "wd": 1e-4},
                    arg_params={k: pkg.nd.array(v, **c)
                                for k, v in seeded.items()},
                    allow_missing=True,
                    batch_end_callback=lambda p: losses.append(
                        p.eval_metric.get_name_value()[0][1]))
        arg, aux = mod.get_params()
        out[pkg] = (losses, {k: v.asnumpy() for k, v in {**arg,
                                                         **aux}.items()})
    (tl, tp), (jl, jp) = out[tmx], out[mx]
    assert len(tl) == 2 and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=PARAM_RTOL)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.cuda
def test_batches_on_the_card_equal_the_cpu_batches(rec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 18 feeds "
                    "ResNet-50 from ImageRecordIter on the H100")
    kw = dict(path_imgidx=rec[1], shuffle=True, rand_crop=True,
              rand_mirror=True, preprocess_threads=1, **MEAN_STD)
    want = _drain(tmx, rec[0], rng=np.random.RandomState(2), **kw)
    with _iter(tmx, rec[0], rng=np.random.RandomState(2), ctx=tmx.gpu(0),
               **kw) as it:
        got = []
        for b in it:
            assert b.data[0]._data.is_cuda and b.label[0]._data.is_cuda
            got.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    _assert_same(got, want)
