"""Port Symbol (mxnet_tpu_torch.symbol) vs mxnet_tpu.symbol.

Graph JSON written by either package loads in the other with equal
arguments, auxiliary states and inferred shapes, and the port's ResNet-50
get_symbol gives the example's argument and aux names and shapes at
full width.  Auto-generated node names differ between the packages (each
numbers its own nodes), so graphs are compared by argument names.
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import resnet as tresnet

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example_resnet():
    path = os.path.join(_REPO, "example", "image-classification", "symbols",
                        "resnet.py")
    spec = importlib.util.spec_from_file_location("_example_resnet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph(sym):
    """A small graph over every op the serving slice ports."""
    data = sym.var("data")
    c = sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                        no_bias=True, name="c0")
    b = sym.BatchNorm(c, fix_gamma=False, name="bn0")
    a = sym.Activation(b, act_type="relu")
    s = sym.Convolution(a, num_filter=8, kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1), no_bias=True, name="c1")
    p = sym.Pooling(a, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    r = s + p
    f = sym.Flatten(sym.Pooling(r, global_pool=True, kernel=(4, 4),
                                pool_type="avg"))
    fc = sym.FullyConnected(f, num_hidden=5, name="fc")
    return sym.SoftmaxOutput(fc, sym.var("softmax_label"), name="softmax")


def _signature(s, shape):
    args, outs, auxs = s.infer_shape(data=shape)
    return (s.list_arguments(), s.list_auxiliary_states(), s.list_outputs(),
            [tuple(x) for x in args], [tuple(x) for x in outs],
            [tuple(x) for x in auxs])


def test_reference_json_loads_in_port():
    ref = _graph(mx.sym)
    port = tmx.sym.load_json(ref.tojson())
    assert _signature(port, (2, 3, 8, 8)) == _signature(ref, (2, 3, 8, 8))


def test_port_json_loads_in_reference():
    port = _graph(tmx.sym)
    ref = mx.sym.load_json(port.tojson())
    assert _signature(ref, (2, 3, 8, 8)) == _signature(port, (2, 3, 8, 8))


def test_port_json_round_trips_unchanged():
    port = _graph(tmx.sym)
    js = port.tojson()
    assert tmx.sym.load_json(js).tojson() == js


def test_internals_and_softmax_head():
    net = _graph(tmx.sym)
    fc = net.get_internals()["fc_output"]
    head = tmx.sym.softmax(fc, axis=1)
    assert "softmax_label" not in head.list_arguments()
    assert net.get_internals()["bn0_output0"].list_outputs() == ["bn0_output0"]
    _, outs, _ = head.infer_shape(data=(2, 3, 8, 8))
    assert outs == [(2, 5)]


def test_resnet50_matches_example_symbol():
    ex = _example_resnet().get_symbol(num_classes=1000, num_layers=50)
    port = tresnet.get_symbol(num_classes=1000, num_layers=50)
    assert port.list_arguments() == ex.list_arguments()
    assert port.list_auxiliary_states() == ex.list_auxiliary_states()
    p_args, p_outs, p_auxs = port.infer_shape(data=(1, 3, 224, 224))
    e_args, e_outs, e_auxs = ex.infer_shape(data=(1, 3, 224, 224))
    assert [tuple(s) for s in p_args] == [tuple(s) for s in e_args]
    assert [tuple(s) for s in p_auxs] == [tuple(s) for s in e_auxs]
    assert [tuple(s) for s in p_outs] == [tuple(s) for s in e_outs] \
        == [(1, 1000)]
    n_params = sum(int(np.prod(s)) for n, s in
                   zip(port.list_arguments(), p_args)
                   if n not in ("data", "softmax_label"))
    assert 25_000_000 < n_params < 26_000_000
    assert sum(1 for n in port.list_arguments()
               if n.endswith("_conv2_weight")) == 16


@pytest.mark.parametrize("given", [{}, {"data": "float16"},
                                   {"data": np.int32}])
def test_infer_type_gives_the_references_numpy_types(given):
    """``infer_type`` gives what the reference gives: ``np.dtype`` for a
    given argument, ``np.float32`` for the rest, so code written against
    the reference can build numpy arrays from ``arg_types``."""
    def types(sym):
        s = sym.BatchNorm(sym.FullyConnected(sym.var("data"), num_hidden=2,
                                             name="fc"), name="bn")
        return s.infer_type(**given), s.infer_shape(data=(3, 4))[0]
    (port_args, port_outs, port_auxs), shapes = types(tmx.sym)
    ref_args, ref_outs, ref_auxs = types(mx.sym)[0]
    assert port_args == ref_args and port_outs == ref_outs \
        and port_auxs == ref_auxs
    assert [type(t) for t in port_args + port_outs + port_auxs] == \
        [type(t) for t in ref_args + ref_outs + ref_auxs]
    assert [np.zeros(s, t).dtype for s, t in zip(shapes, port_args)] == \
        [np.dtype(t) for t in ref_args]


def test_infer_type_bfloat16_is_ndarrays_dtype_and_binds():
    """bfloat16, which numpy lacks, is what ``NDArray.dtype`` gives
    (``torch.bfloat16``), and ``simple_bind`` binds the given types."""
    import torch
    s = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2, name="fc")
    args, _, _ = s.infer_type(data="bfloat16")
    ex = s.simple_bind(ctx=tmx.cpu(), data=(3, 4),
                       type_dict={"data": "bfloat16", "fc_weight": "float16"})
    assert args[0] == ex.arg_dict["data"].dtype == torch.bfloat16
    assert ex.arg_dict["fc_weight"].dtype == np.dtype("float16")
    assert ex.arg_dict["fc_bias"].dtype == np.dtype("float32")
