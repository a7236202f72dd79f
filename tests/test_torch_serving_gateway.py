"""The rest of the serving gateway in the port (mxnet_tpu_torch) against the
reference (mxnet_tpu), on the CPU: ``ServingConfig``'s ``MXNET_SERVING_*``
defaults, ``ModelServer.swap_params`` (atomic between batches, answers
equal to a fresh server's on the new weights), ``Predictor.
copy_params_from`` (one copy of the weights across the bucket
predictors), ``ModelRegistry`` and the HTTP endpoint (routing, 404, 413,
429 with Retry-After), on ``tests/test_torch_serving.py``'s narrow
pre-activation ResNet and a linear model, both packages fed the same seeded
numpy weights.

Tolerance: rtol = atol = 1e-4 on served probabilities against the
reference (fp32 on both sides; the sums run in another order); answers of
two port servers on the same weights are compared bit for bit.
"""
import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, serving
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import (ModelRegistry, ModelServer,
                                     ServingConfig, ServingError,
                                     UnknownModelError)
from mxnet_tpu_torch.weights import from_jax_params

from test_torch_serving import _mini_resnet, _params

TOL = 1e-4
SHAPE = (3, 32, 32)
N_IMAGES = 8
ENV = {"MXNET_SERVING_MAX_BATCH": "16",
       "MXNET_SERVING_BATCH_TIMEOUT_MS": "3.5",
       "MXNET_SERVING_QUEUE_DEPTH": "64", "MXNET_SERVING_DEADLINE_MS": "250",
       "MXNET_SERVING_WORKERS": "2", "MXNET_SERVING_BUCKETS": "1,4,16",
       "MXNET_SERVING_SHED_BATCH_AT": "0.4",
       "MXNET_SERVING_SHED_STANDARD_AT": "0.7",
       "MXNET_SERVING_RETRY_AFTER_MS": "75"}
CONFIG_KEYS = ("max_batch_size", "batch_buckets", "batch_timeout_ms",
               "queue_depth", "default_deadline_ms", "num_workers",
               "shed_batch_at", "shed_standard_at", "retry_after_ms")


@pytest.fixture(scope="module")
def mini():
    """The narrow ResNet's JSON, two seeded weight sets, images, and the
    reference Predictor's probabilities on each set."""
    net = _mini_resnet()
    js = net.tojson()
    sets = [_params(net, seed=0), _params(net, seed=1)]
    images = np.random.default_rng(3).standard_normal(
        (N_IMAGES,) + SHAPE).astype(np.float32)
    refs = []
    for p in sets:
        pred = JaxPredictor(js, {k: mx.nd.array(v) for k, v in p.items()},
                            ctx=mx.cpu(), input_shapes={"data": images.shape})
        refs.append(pred.forward(data=images)[0].asnumpy())
    assert np.abs(refs[0] - refs[1]).max() > 100 * TOL
    return js, sets, images, refs


def _linear(pkg, scale):
    """data (n, 8) -> FC4 without bias, W = scale * ones."""
    out = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=4,
                                 no_bias=True, name="fc")
    return out.tojson(), {"fc_weight": np.full((4, 8), scale, np.float32)}


def _config(pkg, kwargs):
    c = pkg.serving.ServingConfig(**kwargs)
    return {k: getattr(c, k) for k in CONFIG_KEYS}


@pytest.mark.parametrize("env,kwargs", [
    ({}, {}),
    (ENV, {}),
    (ENV, {"max_batch_size": 4, "queue_depth": 8, "num_workers": 1,
           "retry_after_ms": 10.0}),
], ids=["unset", "env", "args_over_env"])
def test_serving_config_defaults_match_reference(monkeypatch, env, kwargs):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _config(tmx, kwargs)
    assert got == _config(mx, kwargs)
    if env:
        assert got["batch_buckets"] == (1, 4, 16) and got["num_workers"] == \
            kwargs.get("num_workers", 2)


def test_mesh_server_is_not_ported_yet(mini):
    js, sets, _, _ = mini
    with pytest.raises(ServingError, match="not ported yet"):
        ModelServer(js, from_jax_params(sets[0], cpu()), {"data": SHAPE},
                    ctx=cpu(), mesh=object())


def _bucket_tensors(server, name):
    return {id(p._executor.arg_dict[name]._data)
            for p in server._predictors.values()}


def test_swap_params_is_atomic_and_matches_a_fresh_server(mini):
    """Four clients race 4 swaps between the two weight sets (each swap
    after 6 more answers, so at least 2 requests run on every set): every
    answer matches the reference on one set, and every request of one
    executed batch the same set.  After the last swap the server answers as
    a fresh server on those weights, bit for bit, from one copy of each
    weight shared by its bucket predictors."""
    js, sets, images, refs = mini
    server = ModelServer(js, from_jax_params(sets[0], cpu()),
                         {"data": SHAPE}, ctx=cpu(), max_batch_size=N_IMAGES,
                         batch_timeout_ms=2.0).start()
    batches, answers, errors = [], [], []
    done = threading.Event()
    execute = server._execute

    def recording_execute(live):
        batches.append(list(live))      # holds them: ids stay unique
        execute(live)

    server._execute = recording_execute

    def client(c):
        try:
            i = 0
            while not done.is_set():
                k = (c + 2 * i) % N_IMAGES
                req = server.submit({"data": images[k]})
                answers.append((req, k, req.result(60)[0][0]))
                i += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    def wait_for(n):
        t0 = time.monotonic()
        while len(answers) < n and not errors:
            assert time.monotonic() - t0 < 60, "clients stalled"
            time.sleep(0.001)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        for i in range(4):
            wait_for(len(answers) + 6)
            server.swap_params(sets[(i + 1) % 2])
        wait_for(len(answers) + 6)
        done.set()
        for t in threads:
            t.join(60)
        assert not errors, errors
        weight_set = {}
        for req, k, got in answers:
            match = [s for s in (0, 1) if np.allclose(got, refs[s][k],
                                                      rtol=TOL, atol=TOL)]
            assert len(match) == 1, "answer for image %d matches %s" % (
                k, match)
            weight_set[id(req)] = match[0]
        for batch in batches:
            assert len({weight_set[id(r)] for r in batch
                        if id(r) in weight_set}) <= 1, \
                "a batch mixed two weight sets"
        assert set(weight_set.values()) == {0, 1}
        got = server.predict({"data": images})[0]
    finally:
        done.set()
        server.stop()
    fresh = ModelServer(js, from_jax_params(sets[0], cpu()),
                        {"data": SHAPE}, ctx=cpu(),
                        max_batch_size=N_IMAGES).start()
    try:
        want = fresh.predict({"data": images})[0]
    finally:
        fresh.stop()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, refs[0], rtol=TOL, atol=TOL)
    for name in ("fc1_weight", "stage1_unit1_conv2_weight"):
        assert len(_bucket_tensors(server, name)) == 1


def test_copy_params_from_leaves_one_copy(mini):
    """``Predictor.copy_params_from`` writes the new weights into the bound
    arrays, which every bucket predictor shares, re-points the shared dicts
    at them and releases the old tensors; the forward equals the
    reference's after its own ``copy_params_from``."""
    js, sets, images, refs = mini
    shapes = {"data": (N_IMAGES,) + SHAPE}
    pred = Predictor(js, from_jax_params(sets[0], cpu()), ctx=cpu(),
                     input_shapes=shapes)
    small = pred.reshape({"data": (1,) + SHAPE})
    old = weakref.ref(pred._executor.arg_dict["fc1_weight"]._data)
    new = {k[4:]: v for k, v in sets[1].items() if k.startswith("arg:")}
    new_aux = {k[4:]: v for k, v in sets[1].items() if k.startswith("aux:")}
    pred.copy_params_from(new, new_aux)
    gc.collect()
    assert old() is None, "the old weights are still held"
    for name, arr in pred._executor.arg_dict.items():
        if name == "data":
            continue
        assert arr is pred._arg_params[name] is \
            small._executor.arg_dict[name]
    for name, arr in pred._executor.aux_dict.items():
        assert arr is pred._aux_params[name] is small._executor.aux_dict[name]
    got = pred.forward(data=images)[0].asnumpy()
    jpred = JaxPredictor(js, {k: mx.nd.array(v) for k, v in sets[0].items()},
                         ctx=mx.cpu(), input_shapes=shapes)
    jpred.copy_params_from({k: mx.nd.array(v) for k, v in new.items()},
                           {k: mx.nd.array(v) for k, v in new_aux.items()})
    want = jpred.forward(data=images)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(small.forward(data=images[:1])[0].asnumpy(),
                               want[:1], rtol=TOL, atol=TOL)


# keys of the reference server's stats and health that wait for the mesh
# Predictor and the telemetry hooks; the port adds its executed-batch count
NOT_PORTED_KEYS = {"mesh", "programs", "memory", "post_warmup_compiles"}
PORT_ONLY_KEYS = {"batches"}


def _registries(mini):
    """The port's registry serving the narrow ResNet and two linear models,
    the reference's serving the same two linear models."""
    js, sets, _, _ = mini
    reg = ModelRegistry()
    reg.register("resnet", js, from_jax_params(sets[0], cpu()),
                 {"data": SHAPE}, ctx=cpu(), max_batch_size=2,
                 batch_timeout_ms=1.0)
    jreg = jserving.ModelRegistry()
    for name, scale in (("linear", 1.0), ("double", 2.0)):
        ljs, lp = _linear(tmx, scale)
        reg.register(name, ljs, from_jax_params(lp, cpu()), {"data": (8,)},
                     ctx=cpu(), max_batch_size=2, batch_timeout_ms=1.0)
        ljs, lp = _linear(mx, scale)
        jreg.register(name, ljs, {k: mx.nd.array(v) for k, v in lp.items()},
                      {"data": (8,)}, max_batch_size=2, batch_timeout_ms=1.0)
    return reg, jreg


def test_registry_routes_and_reports_like_the_reference(mini):
    js, sets, images, refs = mini
    reg, jreg = _registries(mini)
    try:
        assert reg.models() == ["double", "linear", "resnet"] \
            and "resnet" in reg and len(reg) == 3
        got = reg.predict({"data": images[:2]}, model="resnet")[0]
        np.testing.assert_allclose(got, refs[0][:2], rtol=TOL, atol=TOL)
        x = np.arange(16, dtype=np.float32).reshape(2, 8)
        for name in ("linear", "double"):
            np.testing.assert_array_equal(
                reg.predict({"data": x}, model=name)[0],
                jreg.predict({"data": x}, model=name)[0])
        for r, err in ((reg, UnknownModelError),
                       (jreg, jserving.UnknownModelError)):
            with pytest.raises(err, match="ghost"):
                r.predict({"data": x}, model="ghost")
            with pytest.raises(err, match="name required"):
                r.predict({"data": x})
        reg.swap_params("resnet", sets[1])
        np.testing.assert_allclose(
            reg.predict({"data": images[:2]}, model="resnet")[0],
            refs[1][:2], rtol=TOL, atol=TOL)
        st, jst = reg.stats(), jreg.stats()
        assert set(st) == set(jst) == {"models"}
        h, jh = reg.health(), jreg.health()
        assert set(h) == set(jh) and h["status"] == jh["status"] == "serving"
        assert h["causes"] == jh["causes"] == []
        for got_doc, want_doc in ((st["models"]["linear"],
                                   jst["models"]["linear"]),
                                  (h["models"]["linear"],
                                   jh["models"]["linear"])):
            assert set(got_doc) - PORT_ONLY_KEYS <= set(want_doc)
            assert set(want_doc) - set(got_doc) <= NOT_PORTED_KEYS
            for k in ("model", "buckets", "max_batch_size", "queue_capacity",
                      "started", "warmed"):
                assert got_doc[k] == want_doc[k], k
        with pytest.raises(ServingError, match="already registered"):
            reg.register("linear", *_linear(tmx, 2.0), {"data": (8,)},
                         ctx=cpu())
        for name in ("linear", "double"):
            reg.unregister(name)
        with pytest.raises(UnknownModelError):
            reg.unregister("linear")
        assert reg.models() == ["resnet"]
        got = reg.predict({"data": images[:1]})[0]
        np.testing.assert_allclose(got, refs[1][:1], rtol=TOL, atol=TOL)
    finally:
        reg.stop_all()
        jreg.stop_all()
    assert len(reg) == 0


def _post(port, doc, path="/predict"):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def test_http_endpoint_matches_reference(mini):
    """Both packages' endpoints on port 0 over their registries: predict,
    404 for an unknown model or a missing name, 413 for a body over the
    limit, 429 with Retry-After when the batch class is shed; the port's
    ResNet answers match the reference Predictor."""
    js, sets, images, refs = mini
    reg, jreg = _registries(mini)
    limit = 200_000
    ports = {}
    try:
        ports["port"] = serving.start_http_server(reg, port=0,
                                                  max_body_bytes=limit)
        ports["ref"] = jserving.start_http_server(jreg, port=0,
                                                  max_body_bytes=limit)
        status, out, _ = _post(ports["port"], {
            "inputs": {"data": images[:2].tolist()}, "model": "resnet"})
        assert status == 200 and out["rows"] == 2
        np.testing.assert_allclose(np.array(out["outputs"][0]), refs[0][:2],
                                   rtol=TOL, atol=TOL)
        x = {"inputs": {"data": [1.0] * 8}}
        big = dict(x, model="linear", pad="x" * (limit + 1))
        for side in ("port", "ref"):
            port = ports[side]
            status, out, _ = _post(port, dict(x, model="linear"))
            assert status == 200 and out["outputs"] == [[[8.0] * 4]], side
            status, out, _ = _post(port, dict(x, model="ghost"))
            assert status == 404 and "ghost" in out["error"], side
            status, out, _ = _post(port, x)
            assert status == 404 and "name required" in out["error"], side
            status, out, _ = _post(port, big)
            assert status == 413 and out["outcome"] == "too_large", side
            status, out, _ = _post(port, dict(x, model="linear",
                                              slo_class="vip"))
            assert status == 400 and "slo_class" in out["error"], side
            assert _get(port, "/models") == (200, {"models": sorted(
                (reg if side == "port" else jreg).models())})
            assert _get(port, "/healthz")[0] == 200
            assert _get(port, "/nowhere")[0] == 404
        for side, r in (("port", reg), ("ref", jreg)):
            srv = r.get("linear")
            # pin the health-driven floor so the forced one below holds
            srv._admission_checked_at = time.monotonic() + 60.0
            srv._batcher.set_shed_floor(1)
            status, out, headers = _post(ports[side], dict(
                x, model="linear", slo_class="batch"))
            assert status == 429 and out["outcome"] == "shed", side
            assert float(headers["Retry-After"]) == pytest.approx(0.05)
            status, _, _ = _post(ports[side], dict(
                x, model="linear", slo_class="realtime"))
            assert status == 200, side
        status, st = _get(ports["port"], "/stats")
        assert status == 200 and set(st["models"]) == set(reg.models())
    finally:
        serving.stop_http_server()
        jserving.stop_http_server()
        reg.stop_all()
        jreg.stop_all()
    with pytest.raises(OSError):
        _get(ports["port"], "/healthz")
