"""``sym.Variable``'s ``lr_mult``, ``wd_mult``, ``init`` and ``dtype`` in the
port (mxnet_tpu_torch) against the reference (mxnet_tpu), on the CPU, and
the top-level names and keywords the port shares with the reference.

The graph is ``FullyConnected(num_hidden=3)`` on a ``fc_weight`` variable
that carries the attribute, then ``SoftmaxOutput``; data (8, 4) from
``RandomState(0).randn``, labels ``arange(8) % 3``; ``Module.init_params(
Constant(0.25))`` and one SGD step at lr 0.5, wd 0.1:

- ``init=Constant(0.5)`` on the variable wins over the Module's
  initializer: the weight starts at 0.5, exactly as the reference's;
- ``lr_mult=0`` keeps the weight where it started, ``wd_mult=0`` drops its
  weight decay: the step's parameters within rtol 1e-4 of the reference's;
- a reference JSON whose variable carries ``__init__`` loads into the port
  and initialises as the reference does (exactly), and the port writes the
  same attributes into its own JSON;
- ``dtype`` is stored as the reference stores it (``__dtype__``).
"""
import inspect
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-6


def _graph(pkg, **var_kwargs):
    s = pkg.sym
    w = s.Variable("fc_weight", **var_kwargs)
    fc = s.FullyConnected(s.Variable("data"), weight=w, num_hidden=3,
                          name="fc")
    return s.SoftmaxOutput(fc, s.Variable("softmax_label"), name="softmax")


def _module(pkg, symbol):
    ctx = {} if pkg is mx else {"context": [tmx.cpu()]}
    m = pkg.mod.Module(symbol, **ctx)
    m.bind(data_shapes=[("data", (8, 4))],
           label_shapes=[("softmax_label", (8,))])
    m.init_params(pkg.init.Constant(0.25))
    return m


def _step(pkg, m):
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = (np.arange(8) % 3).astype(np.float32)
    ctx = {} if pkg is mx else {"ctx": tmx.cpu()}
    m.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.5, "wd": 0.1})
    m.forward_backward(pkg.io.DataBatch([pkg.nd.array(x, **ctx)],
                                        [pkg.nd.array(y, **ctx)]))
    m.update()
    return m


def _params(m):
    arg, _ = m.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def test_variable_init_wins_over_module_initializer():
    got = _params(_module(tmx, _graph(tmx, init=tmx.init.Constant(0.5))))
    want = _params(_module(mx, _graph(mx, init=mx.init.Constant(0.5))))
    np.testing.assert_array_equal(got["fc_weight"], want["fc_weight"])
    np.testing.assert_array_equal(got["fc_weight"], np.full((3, 4), 0.5))
    np.testing.assert_array_equal(got["fc_bias"], want["fc_bias"])


@pytest.mark.parametrize("var_kwargs", [{"lr_mult": 0}, {"wd_mult": 0},
                                        {"lr_mult": 2, "wd_mult": 0.5}])
def test_variable_lr_and_wd_mult_steer_the_update(var_kwargs):
    got = _params(_step(tmx, _module(tmx, _graph(tmx, **var_kwargs))))
    want = _params(_step(mx, _module(mx, _graph(mx, **var_kwargs))))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if var_kwargs.get("lr_mult") == 0:
        np.testing.assert_array_equal(got["fc_weight"], 0.25)


def test_reference_json_with_init_loads_into_the_port():
    ref_sym = _graph(mx, init=mx.init.Constant(0.5), lr_mult=0)
    port_sym = tmx.sym.load_json(ref_sym.tojson())
    got = _step(tmx, _module(tmx, port_sym))
    want = _step(mx, _module(mx, ref_sym))
    for k, v in _params(want).items():
        np.testing.assert_array_equal(_params(got)[k], v, err_msg=k)


def test_variable_attributes_are_stored_as_the_reference_stores_them():
    kw = dict(shape=(3, 4), lr_mult=0.5, wd_mult=2, dtype="float16",
              stype="default")

    def attrs(pkg):
        sym = _graph(pkg, init=pkg.init.Xavier(magnitude=2), **kw)
        node = [n for n in json.loads(sym.tojson())["nodes"]
                if n["name"] == "fc_weight"][0]
        return node["attrs"], sym.attr_dict()["fc_weight"]

    assert attrs(tmx) == attrs(mx)
    assert attrs(tmx)[0]["__init__"] == \
        '["xavier", {"rnd_type": "uniform", "factor_type": "avg", ' \
        '"magnitude": 2}]'
    assert attrs(tmx)[0]["__dtype__"] == "float16"


def test_init_desc_routes_by_name_and_by_attribute():
    arr = tmx.nd.zeros((2, 3), ctx=tmx.cpu())
    tmx.init.Constant(0.25)(tmx.init.InitDesc("x_weight"), arr)
    np.testing.assert_array_equal(arr.asnumpy(), 0.25)
    tmx.init.Constant(0.25)(tmx.init.InitDesc(
        "x_bias", {"__init__": tmx.init.Constant(3.0).dumps()}), arr)
    np.testing.assert_array_equal(arr.asnumpy(), 3.0)
    tmx.init.Constant(0.25)(tmx.init.InitDesc(
        "x_gamma", {"__init__": "one"}), arr)
    np.testing.assert_array_equal(arr.asnumpy(), 1.0)
    assert str(tmx.init.InitDesc("x_weight", {"a": "1"})) == "x_weight"


TOP_LEVEL = ["recordio", "image", "img", "NDArray", "Symbol", "Executor",
             "executor", "KVStore", "kvstore_create", "NameManager",
             "FeedForward", "OverlappedLoop", "serving"]


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_name_exists_as_in_the_reference(name):
    assert hasattr(mx, name)
    assert hasattr(tmx, name), name


def test_kvstore_create_makes_a_local_store():
    kv = tmx.kvstore_create("local")
    assert isinstance(kv, tmx.KVStore) and kv.type == "local"


KEYWORDS = [
    ("mod.Module.__init__", "state_names"),
    ("mod.Module.__init__", "compression_params"),
    ("executor.Executor.backward", "is_train"),
    ("model.save_checkpoint", "remove_amp_cast"),
]


def _resolve(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("path,keyword", KEYWORDS)
def test_reference_keyword_in_port_signature(path, keyword):
    assert keyword in inspect.signature(_resolve(mx, path)).parameters
    assert keyword in inspect.signature(_resolve(tmx, path)).parameters


def test_module_accepts_and_ignores_state_names_and_compression():
    m = tmx.mod.Module(_graph(tmx), context=[tmx.cpu()], state_names=[],
                       compression_params={"type": "2bit"})
    assert m.data_names == ["data"]
