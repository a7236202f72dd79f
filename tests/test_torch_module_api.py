"""The rest of the classic Module API of the port (mxnet_tpu_torch) against
the reference's (mxnet_tpu), on the CPU, at small sizes.

- ``mod.SequentialModule`` of two Modules, the MLP of
  ``example/module/sequential_module.py`` split in two (a feature Module
  and a ``SoftmaxOutput`` head added with ``take_labels``), ``fit`` for
  one epoch of 3 batches from the same seeded weights: parameters within
  rtol 1e-4, atol 1e-6, the training accuracy equal, ``score`` within
  1e-6;
- ``mod.PythonLossModule`` after a Module (a ``SequentialModule`` of an
  FC Module and the loss head), 2 SGD steps: parameters within rtol 1e-4;
  alone, as ``tests/test_module.py::test_python_loss_module`` drives it:
  output shapes, the scores passed through, the softmax-CE gradient and a
  ``grad_func``'s, against the reference's;
- ``Executor.backward`` after a training ``forward`` (from the kept graph,
  and recomputed after a weight changed in between) against the
  reference's, within rtol 1e-5;
- ``Executor.arg_arrays``/``grad_arrays``/``aux_arrays`` in the
  reference's order and shapes, and ``reshape``: the same arrays kept
  where the shape holds (weights, moving statistics), new ones where it
  changes (data) and new gradients, as the reference's; the bucketed LM's
  symbol (its ``zeros`` initial states) reshaped to another sequence
  length;
- ``Symbol.attr`` and ``infer_shape_partial`` with one input unknown,
  equal to the reference's;
- ``io.CSVIter`` (with and without ``round_batch``, a label file),
  ``MNISTIter`` (idx files written by the test, one gzipped; flat and
  not, shuffled from one numpy seed) and ``LibSVMIter`` (a padded last
  batch), every batch equal to the reference's.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def _ctx(pkg):
    return {} if pkg is mx else {"ctx": tmx.cpu()}


def _moons(n, seed=0):
    """``make_data`` of example/module/sequential_module.py."""
    rng = np.random.RandomState(seed)
    half = n // 2
    t = rng.uniform(0, np.pi, half)
    x0 = np.stack([np.cos(t), np.sin(t)], 1)
    x1 = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    x = np.concatenate([x0, x1]).astype(np.float32)
    x += rng.randn(*x.shape).astype(np.float32) * 0.1
    y = np.concatenate([np.zeros(half), np.ones(half)]).astype(np.float32)
    idx = rng.permutation(n)
    return x[idx], y[idx]


def _seeded(shapes, seed):
    r = np.random.default_rng(seed)
    return {k: (0.5 * r.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def _sequential(pkg):
    s = pkg.sym
    feat = s.Activation(s.FullyConnected(s.var("data"), num_hidden=32,
                                         name="feat"), act_type="relu")
    head = s.SoftmaxOutput(s.FullyConnected(s.var("data"), num_hidden=2,
                                            name="head"),
                           s.var("softmax_label"), name="softmax")
    ctx = [pkg.cpu()]
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(feat, data_names=("data",), label_names=(),
                           context=ctx))
    seq.add(pkg.mod.Module(head, data_names=("data",),
                           label_names=("softmax_label",), context=ctx),
            take_labels=True, auto_wiring=True)
    return seq


def test_sequential_module_fits_as_reference():
    x, y = _moons(96)
    params = _seeded({"feat_weight": (32, 2), "feat_bias": (32,),
                      "head_weight": (2, 32), "head_bias": (2,)}, seed=1)
    res = {}
    for pkg in (mx, tmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=32, **_ctx(pkg))
        seq = _sequential(pkg)
        metric = pkg.metric.Accuracy()
        seq.fit(it, eval_metric=metric, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: pkg.nd.array(v, **_ctx(pkg))
                            for k, v in params.items()}, num_epoch=1)
        arg, aux = seq.get_params()
        score = seq.score(it, pkg.metric.Accuracy())
        res[pkg] = (arg, metric.get()[1], dict(score)["accuracy"],
                    seq.get_outputs()[0].asnumpy(),
                    [d.shape for d in seq._modules[1].data_shapes])
    _assert_params(res[tmx][0], res[mx][0])
    assert res[tmx][1] == res[mx][1]
    assert abs(res[tmx][2] - res[mx][2]) <= 1e-6
    np.testing.assert_allclose(res[tmx][3], res[mx][3], rtol=1e-5,
                               atol=1e-6)
    assert res[tmx][4] == res[mx][4] == [(32, 32)]


def test_python_loss_module_after_a_module():
    r = np.random.default_rng(2)
    data = [(r.standard_normal((4, 5)).astype(np.float32),
             r.integers(0, 3, 4).astype(np.float32)) for _ in range(2)]
    params = _seeded({"fc_weight": (3, 5), "fc_bias": (3,)}, seed=3)
    got = {}
    for pkg in (mx, tmx):
        s = pkg.sym
        scores = s.FullyConnected(s.var("data"), num_hidden=3, name="fc")
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(scores, label_names=(),
                               context=[pkg.cpu()]))
        seq.add(pkg.mod.python_module.PythonLossModule(), take_labels=True)
        seq.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        seq.init_params(arg_params={k: pkg.nd.array(v, **_ctx(pkg))
                                    for k, v in params.items()})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        for xb, yb in data:
            seq.forward(pkg.io.DataBatch([pkg.nd.array(xb, **_ctx(pkg))],
                                         [pkg.nd.array(yb, **_ctx(pkg))]),
                        is_train=True)
            seq.backward()
            seq.update()
        got[pkg] = seq.get_params()[0]
    _assert_params(got[tmx], got[mx])
    assert float(np.abs(got[tmx]["fc_weight"].asnumpy()
                        - params["fc_weight"]).max()) > 1e-3


def test_python_loss_module_alone_matches_reference():
    scores = np.array([[2.0, 1.0, 0.0]] * 4, np.float32)
    labels = np.array([0, 1, 2, 0], np.float32)
    res = {}
    for pkg in (mx, tmx):
        c = _ctx(pkg)
        batch = pkg.io.DataBatch([pkg.nd.array(scores, **c)],
                                 [pkg.nd.array(labels, **c)])
        m = pkg.mod.PythonLossModule()
        m.bind(data_shapes=[(4, 3)], label_shapes=[(4,)])
        m.init_params()
        m.forward(batch, is_train=True)
        assert m.get_outputs()[0] is batch.data[0]
        m.backward()
        m2 = pkg.mod.PythonLossModule(
            grad_func=lambda s, l: np.full(s.shape, 2.0, np.float32))
        m2.bind(data_shapes=[(4, 3)], label_shapes=[(4,)])
        m2.forward(batch, is_train=True)
        m2.backward()
        res[pkg] = (m.output_shapes, m.get_input_grads()[0].asnumpy(),
                    m2.get_input_grads()[0].asnumpy(), m.get_params())
    assert res[tmx][0] == res[mx][0] == [("pyloss_output", (4, 3))]
    np.testing.assert_allclose(res[tmx][1], res[mx][1], rtol=1e-6)
    np.testing.assert_array_equal(res[tmx][2], res[mx][2])
    assert res[tmx][3] == res[mx][3] == ({}, {})


def _bn_net(pkg):
    s = pkg.sym
    x = s.FullyConnected(s.var("data"), num_hidden=6, name="fc1")
    x = s.BatchNorm(x, fix_gamma=False, name="bn")
    x = s.FullyConnected(x, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(x, name="softmax")


def _views(ex, names):
    return [(n, None if a is None else a.shape)
            for n, a in zip(names, ex)]


def test_executor_arrays_and_reshape_match_reference():
    res = {}
    for pkg in (mx, tmx):
        net = _bn_net(pkg)
        ex = net.simple_bind(pkg.cpu(), grad_req={"fc1_weight": "write",
                                                  "fc2_weight": "write",
                                                  "bn_gamma": "write"},
                             data=(4, 5), softmax_label=(4,))
        args, auxs = net.list_arguments(), net.list_auxiliary_states()
        order = (_views(ex.arg_arrays, args), _views(ex.grad_arrays, args),
                 _views(ex.aux_arrays, auxs))
        new = ex.reshape(data=(7, 5), softmax_label=(7,))
        kept = {n: new.arg_dict[n] is ex.arg_dict[n] for n in args}
        kept.update({n: new.aux_dict[n] is ex.aux_dict[n] for n in auxs})
        grads_new = all(new.grad_dict[n] is not ex.grad_dict[n]
                        for n in new.grad_dict)
        res[pkg] = (order, kept, grads_new, sorted(new.grad_dict),
                    _views(new.arg_arrays, args))
    assert res[tmx] == res[mx]
    assert not res[tmx][1]["data"] and res[tmx][1]["fc1_weight"]
    assert res[tmx][1]["bn_moving_mean"]


def test_executor_backward_after_forward_matches_reference():
    """A training forward's graph serves the next backward; after a weight
    changes the backward recomputes at the new weight, as the reference's
    always does."""
    r = np.random.default_rng(6)
    x = r.standard_normal((4, 5)).astype(np.float32)
    y = r.integers(0, 3, 4).astype(np.float32)
    w1, w2 = (r.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    grads = {}
    for pkg in (mx, tmx):
        s = pkg.sym
        net = s.SoftmaxOutput(s.FullyConnected(s.var("data"), num_hidden=3,
                                               name="fc"), name="softmax")
        ex = net.simple_bind(pkg.cpu(), grad_req={"fc_weight": "write",
                                                  "fc_bias": "write"},
                             data=(4, 5), softmax_label=(4,))
        ex.arg_dict["fc_weight"][:] = w1
        got = []
        for w in (None, w2):
            ex.forward(is_train=True, data=x, softmax_label=y)
            if w is not None:
                ex.arg_dict["fc_weight"][:] = w
            ex.backward()
            got.append(ex.grad_dict["fc_weight"].asnumpy())
        grads[pkg] = got
    for g, want in zip(grads[tmx], grads[mx]):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-7)


def test_bucketed_lm_executor_reshapes_to_another_length():
    from test_torch_bucketing import sym_gen_of
    res = {}
    for pkg in (mx, tmx):
        net, _, _ = sym_gen_of(pkg)(5)
        ex = net.simple_bind(pkg.cpu(), data=(8, 5), softmax_label=(8, 5))
        new = ex.reshape(data=(8, 10), softmax_label=(8, 10))
        res[pkg] = ({n: (new.arg_dict[n] is ex.arg_dict[n],
                         new.arg_dict[n].shape) for n in ex.arg_dict},
                    net.infer_shape_partial(data=(8, 10)))
    assert res[tmx] == res[mx]
    assert res[tmx][0]["lstm_parameters"][0]
    # the port's reshaped executor runs at the new length
    net, _, _ = sym_gen_of(tmx)(5)
    ex = net.simple_bind(tmx.cpu(), data=(8, 5), softmax_label=(8, 5))
    out = ex.reshape(data=(8, 10), softmax_label=(8, 10)).forward(
        data=np.ones((8, 10), np.float32),
        softmax_label=np.ones((8, 10), np.float32))[0]
    assert out.shape == (80, 64)


def test_symbol_attr_and_infer_shape_partial_match_reference():
    res = {}
    for pkg in (mx, tmx):
        s = pkg.sym
        w = s.var("w", attr={"lr_mult": "0.5"})
        fc = s.FullyConnected(s.var("a"), w, num_hidden=4, no_bias=True,
                              name="fc")
        out = fc + s.var("b")
        res[pkg] = (w.attr("lr_mult"), w.attr("missing"),
                    fc.attr("num_hidden"),
                    s.Group([fc, out]).attr("num_hidden"),
                    out.infer_shape_partial(a=(2, 3)),
                    out.infer_shape_partial(b=(2, 4)),
                    out.infer_shape_partial(a=(2, 3), b=(2, 4)))
    assert res[tmx] == res[mx]
    assert res[tmx][4][1] == [None]
    with pytest.raises(tmx.MXNetError):
        out.infer_shape(a=(2, 3))


def _write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def _all_batches(it):
    out = []
    for b in it:
        out.append((b.pad, [a.asnumpy() for a in b.data],
                    [a.asnumpy() for a in b.label]))
    return out


def _same(a, b):
    assert len(a) == len(b) > 0
    for (pa, da, la), (pb, db, lb) in zip(a, b):
        assert pa == pb
        for u, v in zip(da + la, db + lb):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("round_batch", [True, False],
                         ids=["round", "discard"])
def test_csv_iter_matches_reference(tmp_path, round_batch):
    r = np.random.default_rng(4)
    np.savetxt(tmp_path / "d.csv", r.standard_normal((10, 6)),
               delimiter=",")
    np.savetxt(tmp_path / "l.csv", r.integers(0, 3, (10, 1)), delimiter=",")
    got = {}
    for pkg in (mx, tmx):
        it = pkg.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                            data_shape=(2, 3),
                            label_csv=str(tmp_path / "l.csv"),
                            batch_size=4, round_batch=round_batch,
                            **_ctx(pkg))
        got[pkg] = (_all_batches(it), it.provide_data, it.provide_label)
    _same(got[tmx][0], got[mx][0])
    assert got[tmx][1:] == got[mx][1:]
    assert (got[tmx][0][-1][0] == 2) == round_batch


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_matches_reference(tmp_path, flat):
    r = np.random.default_rng(5)
    _write_idx(tmp_path / "img", r.integers(0, 256, (20, 4, 5)))
    _write_idx(tmp_path / "lab.gz", r.integers(0, 10, (20,)), gz=True)
    got = {}
    for pkg in (mx, tmx):
        np.random.seed(8)
        it = pkg.io.MNISTIter(image=str(tmp_path / "img"),
                              label=str(tmp_path / "lab"), batch_size=6,
                              flat=flat, **_ctx(pkg))
        got[pkg] = _all_batches(it)
        it.reset()
        got[pkg] += _all_batches(it)
    _same(got[tmx], got[mx])
    assert len(got[tmx]) == 6


def test_libsvm_iter_matches_reference(tmp_path):
    lines = ["1 0:0.5 3:1.5", "0 1:2.0", "2 2:-1 4:3 5:0.25", "1",
             "0 0:1 5:1"]
    (tmp_path / "d.svm").write_text("\n".join(lines) + "\n")
    got = {}
    for pkg in (mx, tmx):
        it = pkg.io.LibSVMIter(data_libsvm=str(tmp_path / "d.svm"),
                               data_shape=(6,), batch_size=2, **_ctx(pkg))
        got[pkg] = (_all_batches(it), it.provide_data, it.provide_label)
    _same(got[tmx][0], got[mx][0])
    assert got[tmx][1:] == got[mx][1:]
    assert got[tmx][0][-1][0] == 1
