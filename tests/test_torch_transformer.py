"""The transformer LM slice as a whole: ``models.transformer_lm`` bound and
trained through ``Module`` and its fused step, in the port (mxnet_tpu_torch)
against the reference (mxnet_tpu), on the CPU.

- ``transformer_lm``'s argument names and shapes, and its JSON, equal the
  reference's, and each package loads the other's JSON;
- ``SyntheticLMIter`` gives the reference's batches;
- the port's functional block (``block_apply``) equals the reference's from
  the same seeded parameters;
- three SGD-momentum steps of the ``tiny`` config at T = 128, batch 2 (T a
  multiple of 128, so that the reference's attention takes its Pallas
  kernels, run by the interpreter), from the reference Module's weights
  carried over by ``weights.from_jax_module``: each loss within rtol 1e-5,
  every parameter after the third step within 1e-4;
- the port's fused step against its eager path (``MXNET_TPU_FUSED_STEP=0``)
  within rtol 1e-5, and an eval forward (kernel 3's path) giving the
  training forward's loss.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_config as jget_config
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.ops import pallas_attention as pa
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import get_config, transformer as ttfm
from mxnet_tpu_torch.weights import from_jax_module

T, BATCH, STEPS = 128, 2, 3
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
OPT = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _interpret_mode():
    pa.INTERPRET = True
    yield
    pa.INTERPRET = False


def _cfg(pkg_get):
    return pkg_get("tiny", seq_len=T)


def test_transformer_lm_graph_matches_reference():
    # fresh name counters on both sides: the unnamed mean node is named
    # from them ("mean0")
    with mx.name.NameManager():
        jnet = jtfm.transformer_lm(_cfg(jget_config))
    with tmx.name.NameManager():
        tnet = ttfm.transformer_lm(_cfg(get_config))
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_outputs() == jnet.list_outputs()
    shapes = {"data": (BATCH, T), "softmax_label": (BATCH, T)}
    jargs, jouts, _ = jnet.infer_shape(**shapes)
    targs, touts, _ = tnet.infer_shape(**shapes)
    assert [tuple(s) for s in targs] == [tuple(s) for s in jargs]
    assert [tuple(s) for s in touts] == [tuple(s) for s in jouts]
    tjson, jjson = json.loads(tnet.tojson()), json.loads(jnet.tojson())
    for tn, jn in zip(tjson.pop("nodes"), jjson.pop("nodes")):
        assert tn == jn
    assert tjson == jjson
    assert tnet.attr_dict() == jnet.attr_dict()
    back = tmx.sym.load_json(jnet.tojson())
    assert back.tojson() == tnet.tojson()
    assert mx.sym.load_json(tnet.tojson()).list_arguments() == \
        jnet.list_arguments()


def test_synthetic_lm_iter_matches_reference():
    kw = dict(batch_size=3, num_batches=4, seed=5)
    jit = mx.io.SyntheticLMIter(50, 16, **kw)
    tit = tmx.io.SyntheticLMIter(50, 16, ctx=tmx.cpu(), **kw)
    assert tit.provide_data == jit.provide_data
    assert tit.provide_label == jit.provide_label
    n = 0
    for jb, tb in zip(jit, tit):
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())
        n += 1
    assert n == 4
    with pytest.raises(StopIteration):
        next(tit)


def test_block_apply_matches_reference():
    cfg = get_config("tiny", seq_len=16)
    jparams = jtfm.init_block_params(jget_config("tiny", seq_len=16),
                                     np.random.RandomState(3))
    tparams = ttfm.init_block_params(cfg, np.random.RandomState(3))
    for k, v in tparams.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]))
    x = np.random.RandomState(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    got = ttfm.block_apply(cfg, tparams, torch.from_numpy(x))
    want = jtfm.block_apply(jget_config("tiny", seq_len=16), jparams, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _seeded_params(net, seed):
    """Seeded weights for every parameter: N(0, 0.02) weights and
    embeddings, gammas near one, betas and biases near zero."""
    r = np.random.default_rng(seed)
    args, _, _ = net.infer_shape(data=(BATCH, T), softmax_label=(BATCH, T))
    out = {}
    for name, shape in zip(net.list_arguments(), args):
        if name in ("data", "softmax_label"):
            continue
        v = r.standard_normal(shape) * 0.02
        if name.endswith("_gamma"):
            v += 1.0
        out[name] = v.astype(np.float32)
    return out


def _jax_module(net, params):
    mod = mx.mod.Module(net, context=[mx.cpu(0)])
    mod.bind(data_shapes=[("data", (BATCH, T))],
             label_shapes=[("softmax_label", (BATCH, T))])
    mod.init_params(initializer=None,
                    arg_params={k: mx.nd.array(v) for k, v in params.items()})
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(OPT))
    return mod


def _port_module(net):
    mod = tmx.mod.Module(net, context=[tmx.cpu()])
    mod.bind(data_shapes=[("data", (BATCH, T))],
             label_shapes=[("softmax_label", (BATCH, T))])
    return mod


def _train(mod, it):
    losses = []
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
        losses.append(float(mod.get_outputs()[0].asnumpy().ravel()[0]))
    return losses


def test_module_steps_match_reference():
    cfg = _cfg(jget_config)
    jnet = jtfm.transformer_lm(cfg)
    jmod = _jax_module(jnet, _seeded_params(jnet, seed=0))

    tmod = _port_module(ttfm.transformer_lm(_cfg(get_config)))
    from_jax_module(jmod, tmx.cpu(), tmod)
    tmod.init_optimizer(kvstore="local", optimizer="sgd",
                        optimizer_params=dict(OPT))

    kw = dict(batch_size=BATCH, num_batches=STEPS, seed=0)
    jlosses = _train(jmod, mx.io.SyntheticLMIter(cfg.vocab_size, T, **kw))
    tlosses = _train(tmod, tmx.io.SyntheticLMIter(cfg.vocab_size, T,
                                                  ctx=tmx.cpu(), **kw))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    jarg, _ = jmod.get_params()
    targ, _ = tmod.get_params()
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        np.testing.assert_allclose(targ[k].asnumpy(), jarg[k].asnumpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


def test_from_jax_module_checks_names_and_shapes():
    jnet = jtfm.transformer_lm(_cfg(jget_config))
    jmod = _jax_module(jnet, _seeded_params(jnet, seed=1))
    arg, aux = from_jax_module(jmod, tmx.cpu())
    assert sorted(arg) == sorted(n for n in jnet.list_arguments()
                                 if n not in ("data", "softmax_label"))
    assert aux == {}
    other = _port_module(ttfm.transformer_lm(get_config("tiny", seq_len=T,
                                                        d_ff=128)))
    with pytest.raises(tmx.MXNetError, match="shape"):
        from_jax_module(jmod, tmx.cpu(), other)


def _port_losses(monkeypatch, fused, params):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1" if fused else "0")
    net = ttfm.transformer_lm(_cfg(get_config))
    mod = _port_module(net)
    mod.init_params(initializer=None, arg_params=params)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(OPT, wd=1e-3))
    it = tmx.io.SyntheticLMIter(256, T, batch_size=BATCH, num_batches=STEPS,
                                seed=2, ctx=tmx.cpu())
    return _train(mod, it), mod


def test_fused_step_matches_eager_path(monkeypatch):
    net = ttfm.transformer_lm(_cfg(get_config))
    params = {k: tmx.nd.array(v, tmx.cpu())
              for k, v in _seeded_params(net, seed=4).items()}
    fused, fmod = _port_losses(monkeypatch, True, params)
    eager, emod = _port_losses(monkeypatch, False, params)
    np.testing.assert_allclose(fused, eager, rtol=LOSS_RTOL)
    fp, ep = fmod.get_params()[0], emod.get_params()[0]
    for k in fp:
        np.testing.assert_allclose(fp[k].asnumpy(), ep[k].asnumpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    # only the eager path fills grad_dict
    ex = emod._exec_group.execs[0]
    assert float(np.abs(ex.grad_dict["tfm_lm_head_weight"].asnumpy()).max()) > 0
    # an eval forward of the trained Module gives its training forward's loss
    it = tmx.io.SyntheticLMIter(256, T, batch_size=BATCH, num_batches=1,
                                seed=9, ctx=tmx.cpu())
    batch = next(it)
    fmod.forward(batch, is_train=False)
    eval_loss = fmod.get_outputs()[0].asnumpy()
    fmod.forward(batch, is_train=True)
    np.testing.assert_allclose(eval_loss, fmod.get_outputs()[0].asnumpy(),
                               rtol=1e-6)
