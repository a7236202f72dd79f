"""The port's data iterators, metrics, callbacks, overlapped loop, local
kvstore and checkpoint files (mxnet_tpu_torch) against the reference's
(mxnet_tpu), on the CPU, from the same seeded numpy inputs.

- every metric and ``metric.create`` form: ``get_name_value`` within rtol
  1e-6 (float64 on the host in both);
- ``NDArrayIter`` with ``last_batch_handle`` pad, discard and roll_over,
  shuffled from numpy's global generator seeded alike, or from ``rng=``;
  ``PrefetchingIter`` over two iterators with renames and three workers;
  ``ResizeIter``; ``SyntheticLMIter``'s ``num_parts``: the same batches
  (exact), pads and descriptors;
- ``OverlappedLoop``/``run_epoch``: the same order of tails;
- callbacks: ``Speedometer``, ``log_train_metric``, ``ProgressBar`` log
  lines; ``do_checkpoint`` files that the reference loads;
- the local kvstore: push of a list (summed), pull into several arrays,
  as the reference;
- ``model.save_checkpoint``/``load_checkpoint`` across the packages, and
  ``FeedForward.fit``/``predict`` against the reference's.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.train_loop  # noqa: F401  (mx.train_loop)
import mxnet_tpu_torch as tmx

CPU = {"ctx": tmx.cpu()}


def _np(arrays):
    return [a.asnumpy() for a in arrays]


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
def _metric_inputs(kind, r):
    if kind == "class":
        return ([r.integers(0, 5, 12).astype(np.float32)],
                [r.dirichlet(np.ones(5), 12).astype(np.float32)])
    if kind == "binary":
        return ([r.integers(0, 2, 20).astype(np.float32)],
                [r.dirichlet(np.ones(2), 20).astype(np.float32)])
    if kind == "regress":
        return ([r.standard_normal((6, 3)).astype(np.float32)],
                [r.standard_normal((6, 3)).astype(np.float32)])
    return ([r.standard_normal(6).astype(np.float32)],
            [r.standard_normal(6).astype(np.float32)])


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(1)).sum()), label.shape[0]


METRICS = [
    ("acc", (), {}, "class"),
    ("top_k_accuracy", (), {"top_k": 3}, "class"),
    ("f1", (), {}, "binary"),
    ("mcc", (), {}, "binary"),
    ("perplexity", (), {"ignore_label": 2}, "class"),
    ("mae", (), {}, "regress"),
    ("mse", (), {}, "regress"),
    ("rmse", (), {}, "regress"),
    ("ce", (), {}, "class"),
    ("nll_loss", (), {}, "class"),
    ("pearsoncorrelation", (), {}, "vector"),
    ("loss", (), {}, "vector"),
    ("torch", (), {}, "vector"),
    ("caffe", (), {}, "vector"),
    (_feval, (), {"name": "absdiff"}, "class"),
    (["acc", "ce", "top_k_accuracy"], (), {}, "class"),
]


@pytest.mark.parametrize("case", range(len(METRICS)),
                         ids=["%d-%s" % (i, m[0] if isinstance(m[0], str)
                                         else type(m[0]).__name__)
                              for i, m in enumerate(METRICS)])
def test_metric_matches_reference(case):
    """Two updates of seeded labels and predictions, then a reset and one
    more: the same names and values (rtol 1e-6)."""
    spec, args, kwargs, kind = METRICS[case]
    r = np.random.default_rng(case)
    feeds = [_metric_inputs(kind, r) for _ in range(3)]
    got = []
    for pkg, c in ((mx, {}), (tmx, CPU)):
        m = pkg.metric.create(spec, *args, **kwargs)
        vals = []
        for i, (labels, preds) in enumerate(feeds):
            if i == 2:
                m.reset()
            m.update([pkg.nd.array(l, **c) for l in labels],
                     [pkg.nd.array(p, **c) for p in preds])
            vals.append(m.get_name_value())
        got.append(vals)
    for t, j in zip(*reversed(got)):
        assert [n for n, _ in t] == [n for n, _ in j]
        np.testing.assert_allclose([v for _, v in t], [v for _, v in j],
                                   rtol=1e-6)


def test_metric_update_dict_and_config():
    m = tmx.metric.create("acc", output_names=["softmax_output"])
    m.update_dict({"softmax_label": tmx.nd.array([1, 0], **CPU)},
                  {"softmax_output": tmx.nd.array([[0.1, 0.9], [0.2, 0.8]],
                                                  **CPU)})
    assert m.get() == ("accuracy", 0.5)
    assert m.get_config()["metric"] == "Accuracy"
    with pytest.raises(tmx.MXNetError):
        tmx.metric.create("no-such-metric")


# --------------------------------------------------------------------------
# iterators
# --------------------------------------------------------------------------
def _epochs(it, n):
    out = []
    for _ in range(n):
        out.append([(_np(b.data), _np(b.label), b.pad) for b in it])
        it.reset()
    return out


def _same_epochs(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            for x, y in zip(da + la, db + lb):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
def test_ndarray_iter_matches_reference(handle, shuffle):
    """10 rows, batches of 4, three epochs: the same batches and pads."""
    r = np.random.default_rng(1)
    X = {"a": r.standard_normal((10, 3)).astype(np.float32),
         "b": np.arange(10, dtype=np.float32)}
    Y = r.integers(0, 3, 10).astype(np.float32)
    runs = []
    for pkg, c in ((mx, {}), (tmx, CPU)):
        np.random.seed(4)
        it = pkg.io.NDArrayIter(X, Y, batch_size=4, shuffle=shuffle,
                                last_batch_handle=handle, **c)
        runs.append((it.provide_data, it.provide_label, _epochs(it, 3)))
    (jd, jl, je), (td, tl, te) = runs
    assert td == jd and tl == jl
    _same_epochs(te, je)


def test_ndarray_iter_explicit_rng():
    X = np.arange(24, dtype=np.float32).reshape(12, 2)
    a = tmx.io.NDArrayIter(X, batch_size=4, shuffle=True,
                           rng=np.random.default_rng(0), **CPU)
    b = tmx.io.NDArrayIter(X, batch_size=4, shuffle=True,
                           rng=np.random.default_rng(0), **CPU)
    _same_epochs(_epochs(a, 2), _epochs(b, 2))
    with pytest.raises(tmx.MXNetError):
        tmx.io.NDArrayIter(X, batch_size=2, last_batch_handle="wrap", **CPU)


def test_prefetching_and_resize_iters_match_reference():
    """Two NDArrayIters joined and renamed, three workers, two epochs; a
    ResizeIter of 5 batches over a 3-batch iterator."""
    r = np.random.default_rng(2)
    X1 = r.standard_normal((9, 2)).astype(np.float32)
    X2 = r.standard_normal((9, 3)).astype(np.float32)
    Y = np.arange(9, dtype=np.float32)
    runs = []
    for pkg, c in ((mx, {}), (tmx, CPU)):
        its = [pkg.io.NDArrayIter(X1, Y, batch_size=4, **c),
               pkg.io.NDArrayIter(X2, Y, batch_size=4, data_name="x2",
                                  label_name="l2", **c)]
        pre = pkg.io.PrefetchingIter(its, rename_data=[{"data": "x1"}, {}],
                                     num_workers=3)
        res = pkg.io.ResizeIter(pkg.io.NDArrayIter(X1, Y, batch_size=4, **c),
                                5)
        runs.append(([d.name for d in pre.provide_data],
                     [d.name for d in pre.provide_label],
                     _epochs(pre, 2), _epochs(res, 2)))
    (jd, jl, jp, jr), (td, tl, tp, tr) = runs
    assert td == jd == ["x1", "x2"] and tl == jl
    _same_epochs(tp, jp)
    _same_epochs(tr, jr)


def test_prefetching_iter_places_and_raises():
    class Boom(tmx.io.DataIter):
        provide_data = provide_label = []

        def next(self):
            raise ValueError("boom")

    X = np.ones((4, 2), np.float32)
    pre = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(X, batch_size=2, **CPU),
                                 device=tmx.cpu())
    assert pre.iter_next() and pre.getdata()[0].context == tmx.cpu()
    assert pre.getpad() == 0
    pre.close()
    bad = tmx.io.PrefetchingIter(Boom(2))
    with pytest.raises(ValueError, match="boom"):
        next(bad)
    with pytest.raises(StopIteration):
        next(bad)


def test_synthetic_lm_iter_parts_match_reference():
    kw = dict(batch_size=4, num_batches=3, seed=5, num_parts=2,
              part_index=1)
    jit = mx.io.SyntheticLMIter(50, 6, **kw)
    tit = tmx.io.SyntheticLMIter(50, 6, **kw, **CPU)
    assert tit.provide_data == jit.provide_data
    assert tit.batch_size == 2
    _same_epochs(_epochs(tit, 1), _epochs(jit, 1))


# --------------------------------------------------------------------------
# the overlapped loop, callbacks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_overlapped_loop_matches_reference(depth, monkeypatch):
    def trace(pkg):
        log = []
        loop = pkg.train_loop.OverlappedLoop(depth)
        for i in range(5):
            log.append(("push", i, len(loop)))
            loop.push(lambda i=i: log.append(("tail", i)))
        loop.drain()
        n = pkg.train_loop.run_epoch(range(4), lambda b: b * 10,
                                     lambda h, i: log.append((h, i)), depth)
        return log, n

    assert trace(tmx) == trace(mx)
    monkeypatch.setenv("MXNET_IO_OVERLAP_DEPTH", "5")
    assert tmx.train_loop.default_overlap_depth() == \
        mx.train_loop.default_overlap_depth() == 5


def test_callbacks_log_as_the_reference(caplog, tmp_path, monkeypatch):
    """Speedometer (its clock pinned), log_train_metric and ProgressBar
    write the same lines; do_checkpoint writes files the reference
    loads."""
    lines = {}
    for pkg, c in ((mx, {}), (tmx, CPU)):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(pkg.callback.time, "time", lambda: next(clock))
        m = pkg.metric.create("acc")
        m.update([pkg.nd.array([1, 0], **c)],
                 [pkg.nd.array([[0.2, 0.8], [0.3, 0.7]], **c)])
        cbs = [pkg.callback.Speedometer(8, frequent=2, auto_reset=False),
               pkg.callback.log_train_metric(2),
               pkg.callback.ProgressBar(4, length=8)]
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for i in range(5):
                for cb in cbs:
                    cb(pkg.callback.BatchEndParam(0, i, m))
        lines[pkg] = [r.getMessage() for r in caplog.records]
    assert lines[tmx] == lines[mx] and len(lines[tmx]) > 5
    net = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2,
                                 name="fc")
    arg = {"fc_weight": tmx.nd.array(np.eye(2, 3), **CPU),
           "fc_bias": tmx.nd.array([1.0, 2.0], **CPU)}
    cb = tmx.callback.do_checkpoint(str(tmp_path / "cb"), period=2)
    cb(0, net, arg, {})
    assert not (tmp_path / "cb-0001.params.npz").exists()
    cb(1, net, arg, {})
    sym, jarg, jaux = mx.model.load_checkpoint(str(tmp_path / "cb"), 2)
    assert sym.list_arguments() == net.list_arguments() and not jaux
    np.testing.assert_array_equal(jarg["fc_bias"].asnumpy(), [1.0, 2.0])


# --------------------------------------------------------------------------
# kvstore, checkpoints, FeedForward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["local", "device"])
def test_local_kvstore_matches_reference(kind):
    r = np.random.default_rng(3)
    init = r.standard_normal((3, 2)).astype(np.float32)
    pushes = [[r.standard_normal((3, 2)).astype(np.float32)
               for _ in range(3)] for _ in range(2)]
    got = []
    for pkg, c in ((mx, {}), (tmx, CPU)):
        kv = pkg.kvstore.create(kind)
        assert kv.type == kind
        kv.init("w", pkg.nd.array(init, **c))
        outs = []
        for vals in pushes:
            kv.push("w", [pkg.nd.array(v, **c) for v in vals])
            dst = [pkg.nd.zeros((3, 2), **c), pkg.nd.zeros((3, 2), **c)]
            kv.pull("w", out=dst)
            outs.append(_np(dst))
        got.append(outs)
    np.testing.assert_allclose(np.array(got[1]), np.array(got[0]),
                               rtol=1e-6)
    kv = tmx.kvstore.create("local")
    with pytest.raises(tmx.MXNetError):
        kv.push("missing", tmx.nd.zeros(2, **CPU))


def _fc_net(pkg):
    s = pkg.sym
    x = s.FullyConnected(s.var("data"), num_hidden=3, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def test_checkpoint_files_across_packages(tmp_path):
    r = np.random.default_rng(4)
    arg = {"fc_weight": r.standard_normal((3, 4)).astype(np.float32),
           "fc_bias": r.standard_normal(3).astype(np.float32)}
    aux = {"bn_moving_mean": r.standard_normal(2).astype(np.float32)}
    mx.model.save_checkpoint(str(tmp_path / "j"), 7, _fc_net(mx),
                             {k: mx.nd.array(v) for k, v in arg.items()},
                             {k: mx.nd.array(v) for k, v in aux.items()})
    sym, targ, taux = tmx.model.load_checkpoint(str(tmp_path / "j"), 7,
                                                tmx.cpu())
    assert sym.list_arguments() == _fc_net(mx).list_arguments()
    for src, dst in ((arg, targ), (aux, taux)):
        assert sorted(dst) == sorted(src)
        for k in src:
            np.testing.assert_array_equal(dst[k].asnumpy(), src[k])
    tmx.model.save_checkpoint(str(tmp_path / "t"), 8, sym, targ, taux)
    jsym, jarg, jaux = mx.model.load_checkpoint(str(tmp_path / "t"), 8)
    assert jsym.tojson() == mx.sym.load(str(tmp_path / "j-symbol.json")) \
        .tojson()
    for k in arg:
        np.testing.assert_array_equal(jarg[k].asnumpy(), arg[k])


def test_feedforward_matches_reference(monkeypatch):
    """``FeedForward.fit`` over numpy arrays (shuffled by numpy's global
    generator, seeded alike) for 2 epochs, then ``predict``: parameters
    and predictions within 1e-5."""
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    r = np.random.default_rng(5)
    X = r.standard_normal((16, 4)).astype(np.float32)
    Y = r.integers(0, 3, 16).astype(np.float32)
    w = (0.3 * r.standard_normal((3, 4))).astype(np.float32)
    got = []
    for pkg, c, ctx in ((mx, {}, mx.cpu()), (tmx, CPU, tmx.cpu())):
        np.random.seed(6)
        ff = pkg.model.FeedForward(
            _fc_net(pkg), ctx=ctx, num_epoch=2, numpy_batch_size=8,
            arg_params={"fc_weight": pkg.nd.array(w, **c),
                        "fc_bias": pkg.nd.zeros(3, **c)},
            optimizer_params={"learning_rate": 0.5})
        if pkg is mx:       # the reference's fit always batches by 128
            ff.fit(mx.io.NDArrayIter(X, Y, batch_size=8, shuffle=True))
        else:
            ff.fit(X, Y)
        got.append((ff.arg_params["fc_weight"].asnumpy(),
                    ff.predict(pkg.io.NDArrayIter(X, batch_size=8, **c))))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-5, atol=1e-6)
