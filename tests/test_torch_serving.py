"""The serving slice as a whole: the port's ModelServer on the CPU vs
mxnet_tpu's Predictor, on a narrow pre-activation ResNet built from
``residual_unit`` (32 px, batch 1-4) with seeded numpy weights; plus the
``.params`` interchange, the default context, the scheduler's admission
rules and the package's import boundary.

Tolerance: rtol = atol = 1e-4 on the served probabilities (fp32 on both
sides; the sums run in another order).
"""
import ast
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.resnet import residual_unit
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import (AdmissionError, DeadlineExceededError,
                                     ModelServer, QueueFullError, Request,
                                     SloScheduler)
from mxnet_tpu_torch.weights import from_jax_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def _mini_resnet():
    sym = tmx.sym
    data = sym.var("data")
    body = sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           no_bias=True, name="conv0")
    body = residual_unit(body, 16, (1, 1), False, "stage1_unit1")
    body = residual_unit(body, 16, (1, 1), True, "stage1_unit2")
    body = residual_unit(body, 32, (2, 2), False, "stage2_unit1")
    body = residual_unit(body, 32, (1, 1), False, "stage3_unit1",
                         bottle_neck=False)
    body = sym.Activation(sym.BatchNorm(body, fix_gamma=False, name="bn1"),
                          act_type="relu")
    pool = sym.Pooling(body, global_pool=True, kernel=(16, 16),
                       pool_type="avg")
    fc = sym.FullyConnected(sym.Flatten(pool), num_hidden=10, name="fc1")
    return sym.softmax(fc, axis=1)


def _params(net, seed=0):
    args, _, auxs = net.infer_shape(data=(1, 3, 32, 32))
    r = np.random.default_rng(seed)
    out = {}
    for n, s in zip(net.list_arguments(), args):
        if n == "data":
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:])) if len(s) > 1 else 0.1
        v = r.standard_normal(s) * scale
        if n.endswith("_gamma"):
            v = 1.0 + v
        out["arg:" + n] = v.astype(np.float32)
    for n, s in zip(net.list_auxiliary_states(), auxs):
        v = (r.uniform(0.5, 1.5, s) if n.endswith("_moving_var")
             else r.standard_normal(s) * 0.1)
        out["aux:" + n] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def mini():
    net = _mini_resnet()
    return net.tojson(), _params(net)


def _jax_reference(js, params, images):
    pred = JaxPredictor(js, {k: mx.nd.array(v) for k, v in params.items()},
                        ctx=mx.cpu(), input_shapes={"data": images.shape})
    return pred.forward(data=images)[0].asnumpy()


def test_served_answers_match_reference_predictor(mini):
    js, params = mini
    rows = [1, 3, 2, 4]
    images = np.random.default_rng(1).standard_normal(
        (sum(rows), 3, 32, 32)).astype(np.float32)
    want = _jax_reference(js, params, images)
    server = ModelServer(js, from_jax_params(params, cpu()),
                         {"data": (3, 32, 32)}, ctx=cpu(), max_batch_size=4,
                         batch_timeout_ms=1.0).start()
    try:
        offsets = np.cumsum([0] + rows)
        reqs = [server.submit({"data": images[offsets[i]:offsets[i + 1]]},
                              slo_class=("realtime", "standard", "batch")[i % 3])
                for i in range(len(rows))]
        got = np.concatenate([r.result(60)[0] for r in reqs])
    finally:
        server.stop()
    assert server.stats()["buckets"] == [1, 2, 4]
    assert server.batches >= 2          # 10 rows never fit one bucket of 4
    assert got.shape == (10, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_reference_params_file_loads_as_path_and_bytes(mini, tmp_path):
    js, params = mini
    path = str(tmp_path / "mini.params")
    mx.nd.save(path, {k: mx.nd.array(v) for k, v in params.items()})
    images = np.random.default_rng(2).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    want = _jax_reference(js, params, images)
    with open(path + ".npz", "rb") as f:
        blob = f.read()
    for source in (path, blob):
        pred = Predictor(js, source, ctx=cpu(), input_shapes={"data": (2, 3, 32, 32)})
        got = pred.forward(data=images)[0].asnumpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        small = pred.reshape({"data": (1, 3, 32, 32)})
        np.testing.assert_allclose(small.forward(data=images[:1])[0].asnumpy(),
                                   want[:1], rtol=TOL, atol=TOL)


def test_port_save_loads_in_reference(tmp_path):
    arrays = {"arg:w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "aux:m": np.ones(4, np.float32)}
    path = str(tmp_path / "port.params")
    tmx.nd.save(path, {k: tmx.nd.array(v, cpu()) for k, v in arrays.items()})
    loaded = mx.nd.load(path)
    assert sorted(loaded) == sorted(arrays)
    back = tmx.nd.load(path, ctx=cpu())
    assert all(v.context == cpu() for v in back.values())
    for k, v in arrays.items():
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)


def test_missing_aux_state_raises(mini):
    js, params = mini
    partial = {k: v for k, v in params.items() if k != "aux:bn1_moving_var"}
    with pytest.raises(MXNetError, match="bn1_moving_var"):
        Predictor(js, from_jax_params(partial, cpu()), ctx=cpu(),
                  input_shapes={"data": (1, 3, 32, 32)})


def test_default_context_raises_without_cuda(mini, monkeypatch):
    js, params = mini
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(MXNetError, match="ctx=cpu"):
        Predictor(js, params, input_shapes={"data": (1, 3, 32, 32)})


def test_load_lands_on_the_current_context(tmp_path, monkeypatch):
    """``nd.load`` with no context puts arrays on ``current_context()``, as
    the reference does: the CPU inside ``with cpu():``, and without a card
    and without a CPU scope it raises rather than falling back."""
    path = str(tmp_path / "w.params")
    tmx.nd.save(path, {"w": tmx.nd.array(np.arange(3.0), cpu())})
    with cpu():
        back = tmx.nd.load(path)
    assert back["w"].context == cpu()
    np.testing.assert_array_equal(back["w"].asnumpy(), np.arange(3.0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(MXNetError, match="ctx=cpu"):
        tmx.nd.load(path)


def test_expired_request_is_dropped_before_execution(mini):
    js, params = mini
    server = ModelServer(js, from_jax_params(params, cpu()),
                         {"data": (3, 32, 32)}, ctx=cpu(), max_batch_size=2)
    req = server.submit({"data": np.zeros((3, 32, 32), np.float32)},
                        deadline_ms=0.001)
    server.start(warmup=False)
    try:
        with pytest.raises(DeadlineExceededError):
            req.result(30)
    finally:
        server.stop()
    assert req.outcome == "deadline" and server.batches == 0


def test_scheduler_sheds_lowest_class_first():
    sched = SloScheduler((1, 2), 2, 0.0, queue_depth=4)

    def req(cls):
        return Request({"data": np.zeros((1, 1))}, 1, slo_class=cls)

    sched.put(req("batch"))
    sched.put(req("standard"))
    sched.put(req("standard"))           # at occupancy 0.5: sheds batch only
    with pytest.raises(AdmissionError):
        sched.put(req("batch"))
    sched.put(req("realtime"))
    with pytest.raises(QueueFullError):
        sched.put(req("realtime"))
    first = sched.get_batch()
    assert [r.slo_class for r in first] == ["realtime", "standard"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "mxnet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(f, _REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    scanned = {os.path.relpath(f, _REPO) for f in files}
    for module in ("ops/hopper_rnn.py", "ops/rnn.py", "ops/reduce.py",
                   "gluon/rnn/rnn_layer.py", "gluon/loss.py",
                   "ops/hopper_attention.py", "ops/nn.py", "ops/matrix.py",
                   "ops/elemwise.py", "ops/init_random.py",
                   "ops/optimizer_ops.py", "models/configs.py",
                   "models/transformer.py", "symbol/symbol.py", "executor.py",
                   "io.py", "optimizer.py", "module/base_module.py",
                   "module/executor_group.py", "module/module.py",
                   "fused_step.py", "initializer.py", "weights.py",
                   "parallel/__init__.py", "parallel/mesh.py",
                   "parallel/_compat.py", "parallel/ring_attention.py",
                   "parallel/tensor_parallel.py", "parallel/moe.py",
                   "parallel/pipeline.py", "recordio.py", "image.py",
                   "autograd.py", "attribute.py", "cached_op.py",
                   "ndarray/ndarray.py", "ndarray/register.py",
                   "gluon/block.py", "gluon/parameter.py",
                   "gluon/trainer.py", "module/bucketing_module.py"):
        assert os.path.join("mxnet_tpu_torch", module) in scanned
    assert len(files) > 10 and not bad
