"""Gluon's files in the port (``save_parameters``/``load_parameters``, the
``save_params``/``load_params`` aliases, ``ParameterDict.save``/``load``,
``export`` and ``SymbolBlock.imports``) against the reference, both ways,
on the CPU; with ``summary``'s text and ``Constant``.

Each package writes and reads the npz container of ``nd.save``, so a file
written by one loads in the other.  Nets are built in a fresh
``NameManager`` on each side, so their prefixed names agree.  The
reference's weights are seeded numpy values (BatchNorm's moving
statistics too); the port receives them through the reference's own
files.  Forwards are compared within 1e-5 (fp32, sums in another order).
"""
import contextlib
import io
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.gluon  # noqa: F401
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon  # noqa: F401
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(pkg):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.MaxPool2D(2),
                    nn.Dense(5))
    return net


X = np.random.default_rng(0).uniform(-1, 1, (2, 3, 8, 8)) \
    .astype(np.float32)


def _seeded_ref(seed=1):
    """The reference net with seeded weights and moving statistics."""
    net = _net(mx)
    net.initialize()
    net(mx.nd.array(X))
    r = np.random.default_rng(seed)
    for name, p in net.collect_params().items():
        v = r.uniform(0.5, 1.5, p.shape) if name.endswith("_var") \
            else r.standard_normal(p.shape) * 0.3
        p.set_data(mx.nd.array(v.astype(np.float32)))
    return net


def _port(x=X):
    return tmx.nd.array(x, ctx=cpu())


def _fwd_ref(net, x=X):
    return net(mx.nd.array(x)).asnumpy()


def _fwd_port(net, x=X):
    return net(_port(x)).asnumpy()


def test_reference_save_parameters_loads_in_the_port(tmp_path):
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    net = _net(tmx)
    net.load_parameters(f, ctx=cpu())
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(ref._collect_params_with_prefix())
    np.testing.assert_allclose(_fwd_port(net), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)
    net.hybridize()
    np.testing.assert_allclose(_fwd_port(net), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)


def test_port_save_parameters_loads_in_the_reference(tmp_path):
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    net = _net(tmx)
    net.load_parameters(f, ctx=cpu())
    g = str(tmp_path / "port.params")
    net.save_parameters(g)
    assert os.path.exists(g + ".npz")
    back = _net(mx)
    back.load_parameters(g)
    np.testing.assert_allclose(_fwd_ref(back), _fwd_port(net), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_legacy_save_params_arm(tmp_path, writer):
    """``save_params`` writes full names less the prefix; a file without
    dots goes to ``collect_params().load`` with the block's prefix."""
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    src = ref
    if writer == "port":
        src = _net(tmx)
        src.load_parameters(f, ctx=cpu())
    legacy = str(tmp_path / "legacy.params")
    src.save_params(legacy)
    for pkg in (mx, tmx):
        loaded = pkg.nd.load(legacy) if pkg is mx else \
            pkg.nd.load(legacy, ctx=cpu())
        assert not any("." in k for k in loaded)
        assert all(not k.startswith("hybridsequential0_") for k in loaded)
    net = _net(tmx)
    net.load_params(legacy, ctx=cpu())
    np.testing.assert_allclose(_fwd_port(net), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)
    back = _net(mx)
    back.load_parameters(legacy)
    np.testing.assert_allclose(_fwd_ref(back), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)


def test_parameter_dict_save_load_prefixes(tmp_path):
    ref = _seeded_ref()
    f = str(tmp_path / "pd.params")
    ref.collect_params().save(f, strip_prefix="hybridsequential0_")
    net = _net(tmx)
    net.collect_params().load(f, ctx=cpu(),
                              restore_prefix="hybridsequential0_")
    np.testing.assert_allclose(_fwd_port(net), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)
    with pytest.raises(MXNetError, match="cannot strip"):
        net.collect_params().save(f, strip_prefix="other_")
    with pytest.raises(MXNetError, match="does not start with"):
        net.collect_params().load(f, ctx=cpu(), restore_prefix="other_")
    g = str(tmp_path / "port.params")
    net.collect_params().save(g)
    back = _net(mx)
    back.collect_params().load(g, ctx=mx.cpu())
    np.testing.assert_allclose(_fwd_ref(back), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)


def test_missing_and_extra_names_raise(tmp_path):
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    small = _net(tmx)
    del small._children["4"]          # no Dense: the file has extra names
    with pytest.raises(MXNetError, match="not present"):
        small.load_parameters(f, ctx=cpu())
    small.load_parameters(f, ctx=cpu(), ignore_extra=True)
    big = _net(tmx)
    with big.name_scope():
        big.add(tmx.gluon.nn.Dense(3))
    with pytest.raises(MXNetError, match="missing"):
        big.load_parameters(f, ctx=cpu())
    big.load_parameters(f, ctx=cpu(), allow_missing=True)
    assert big.collect_params()["hybridsequential0_dense1_weight"] \
        ._data is None


def test_load_writes_in_place_where_the_parameter_lives(tmp_path):
    """A second load keeps the arrays (and a Trainer's view of them)."""
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    net = _net(tmx)
    net.initialize(ctx=cpu())
    net(_port())
    before = {k: p.data() for k, p in net.collect_params().items()}
    net.load_parameters(f)
    for k, p in net.collect_params().items():
        assert p.data() is before[k]
    np.testing.assert_allclose(_fwd_port(net), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)


def _exported(pkg, tmp_path, net):
    net.hybridize()
    net(mx.nd.array(X) if pkg is mx else _port())
    path = str(tmp_path / ("ref" if pkg is mx else "port"))
    net.export(path, epoch=3)
    return path + "-symbol.json", path + "-0003.params"


def test_reference_export_imports_in_the_port(tmp_path):
    ref = _seeded_ref()
    sym, params = _exported(mx, tmp_path, ref)
    for k in tmx.nd.load(params, ctx=cpu()):
        assert k.startswith("arg:") or k.startswith("aux:")
    sb = tmx.gluon.SymbolBlock.imports(sym, ["data"], params, ctx=cpu())
    assert sorted(sb.collect_params()) == sorted(ref.collect_params())
    aux = [k for k, p in sb.collect_params().items() if p.grad_req == "null"]
    assert sorted(aux) == ["hybridsequential0_batchnorm0_running_mean",
                           "hybridsequential0_batchnorm0_running_var"]
    np.testing.assert_allclose(_fwd_port(sb), _fwd_ref(ref), rtol=TOL,
                               atol=TOL)


def test_port_export_imports_in_the_reference(tmp_path):
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    net = _net(tmx)
    net.load_parameters(f, ctx=cpu())
    with pytest.raises(MXNetError, match="hybridize"):
        net.export(str(tmp_path / "early"))
    sym, params = _exported(tmx, tmp_path, net)
    sb = mx.gluon.SymbolBlock.imports(sym, ["data"], params)
    np.testing.assert_allclose(_fwd_ref(sb), _fwd_port(net), rtol=TOL,
                               atol=TOL)
    mine = tmx.gluon.SymbolBlock.imports(sym, ["data"], params, ctx=cpu())
    np.testing.assert_allclose(_fwd_port(mine), _fwd_port(net), rtol=TOL,
                               atol=TOL)


LENET = (os.path.join(REPO, "models", "digits-lenet-symbol.json"),
         os.path.join(REPO, "models", "digits-lenet-0020.params.npz"))
INPUTS = ["data", "softmax_label"]     # the checkpoint's SoftmaxOutput head


def test_symbol_block_imports_the_repo_lenet():
    x = np.random.default_rng(3).uniform(0, 1, (4, 1, 8, 8)) \
        .astype(np.float32)
    label = np.arange(4, dtype=np.float32)
    ref = mx.gluon.SymbolBlock.imports(LENET[0], INPUTS, LENET[1])
    net = tmx.gluon.SymbolBlock.imports(LENET[0], INPUTS, LENET[1],
                                        ctx=cpu())
    want = ref(mx.nd.array(x), mx.nd.array(label)).asnumpy()
    got = net(_port(x), _port(label)).asnumpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(MXNetError, match="missing"):
        tmx.gluon.SymbolBlock.imports(LENET[0], ["data"], LENET[1],
                                      ctx=cpu())


def test_symbol_block_composes_on_a_symbol():
    """Called on Symbols, a SymbolBlock puts its graph on those inputs."""
    net = tmx.gluon.SymbolBlock.imports(LENET[0], INPUTS, LENET[1],
                                        ctx=cpu())
    x = tmx.sym.var("images")
    out = net(x * 2.0, tmx.sym.var("labels"))
    assert "images" in out.list_arguments()
    assert "data" not in out.list_arguments()
    v = np.random.default_rng(4).uniform(0, 1, (2, 1, 8, 8)) \
        .astype(np.float32)
    label = np.zeros(2, np.float32)
    args = {k: p.data() for k, p in net.collect_params().items()}
    args.update(images=_port(v), labels=_port(label))
    ex = out.bind(cpu(), args)
    np.testing.assert_allclose(ex.forward()[0].asnumpy(),
                               net(_port(2.0 * v), _port(label)).asnumpy(),
                               rtol=TOL, atol=TOL)


def _summary(pkg, net, x):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        net.summary(x)
    return buf.getvalue()


def test_summary_text_matches_reference(tmp_path):
    """The same table, but for the convolution's count: the reference's
    Conv2D declares no weight shape (``_infer_weight_shape`` gives None,
    ROADMAP.md Queue 3) and a load leaves it so, which counts 0 there;
    the port counts its 112, as upstream MXNet does."""
    ref = _seeded_ref()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    net = _net(tmx)
    net.load_parameters(f, ctx=cpu())
    ref2 = _net(mx)
    ref2.load_parameters(f)
    want = _summary(mx, ref2, mx.nd.array(X)).splitlines()
    got = _summary(tmx, net, _port()).splitlines()
    assert len(got) == len(want) == 13
    differ = [(g, w) for g, w in zip(got, want) if g != w]
    assert [g.split() for g, _ in differ] == [
        ["Conv2D-1", "(2,", "4,", "8,", "8)", "112"],
        ["Total", "params:", "453"]]
    assert [w.split()[-1] for _, w in differ] == ["0", "341"]


def test_constant_and_get_constant():
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = {}
    for pkg in (mx, tmx):
        class Scale(pkg.gluon.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.c = self.params.get_constant("c", value)

            def hybrid_forward(self, F, x, c):
                return F.broadcast_mul(x, c)

        with pkg.name.NameManager():
            blk = Scale()
        ctx = mx.cpu() if pkg is mx else cpu()
        blk.initialize(ctx=ctx)
        c = blk.params.get_constant("c")
        assert isinstance(c, pkg.gluon.Constant)
        assert c.grad_req == "null"
        assert c.name == "scale0_c"
        x = pkg.nd.array(np.ones((2, 3), np.float32), ctx=ctx)
        outs[pkg] = blk(x).asnumpy()
        blk.hybridize()
        np.testing.assert_array_equal(blk(x).asnumpy(), outs[pkg])
    np.testing.assert_array_equal(outs[tmx], value)
    np.testing.assert_array_equal(outs[tmx], outs[mx])
    # a constant named like a bias keeps its value, as upstream MXNet's
    # does; the reference's initializer zeroes it by its name (ROADMAP.md
    # Queue 3)
    for pkg, want in ((tmx, [1.0, 2.0]), (mx, [0.0, 0.0])):
        c = pkg.gluon.ParameterDict("p_").get_constant("scale_bias",
                                                       [1.0, 2.0])
        c.initialize(ctx=mx.cpu() if pkg is mx else cpu())
        np.testing.assert_array_equal(c.data().asnumpy(), want)
    pd = tmx.gluon.ParameterDict("p_")
    with pytest.raises(MXNetError, match="no constant"):
        pd.get_constant("missing")
    pd.get("w", shape=(1,))
    with pytest.raises(MXNetError, match="not a constant"):
        pd.get_constant("w", [1.0])


def test_parameter_stype_and_shared_params():
    p = tmx.gluon.Parameter("w", shape=(2,))
    assert p.stype == "default"
    with pytest.raises(MXNetError, match="Queue 1 item 9"):
        tmx.gluon.Parameter("w", shape=(2,), stype="row_sparse")
    with tmx.name.NameManager():
        a = tmx.gluon.nn.Dense(3, in_units=2)
        b = tmx.gluon.nn.Dense(3, in_units=2, params=a.collect_params())
    assert b.weight is a.weight and b.bias is a.bias
    assert a.prefix != b.prefix
    assert list(a.collect_params(".*weight")) == ["dense0_weight"]


def test_unseeded_initialization_repeats(monkeypatch):
    """Before any ``random.seed`` the port draws from seed 0, as the
    reference's global seed starts at 0: a block initialized in a fresh
    process gets the same weights in every run (ROADMAP.md Queue 3)."""
    draws = []
    for seeded in (False, True):
        monkeypatch.setattr(tmx.random, "_seed", None)
        monkeypatch.setattr(tmx.random, "_gens", {})
        monkeypatch.setattr(tmx.random, "_seeds", None)
        if seeded:
            tmx.random.seed(0)
        with tmx.name.NameManager():
            net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=cpu())
        draws.append((net.weight.data().asnumpy(), tmx.random.next_seed()))
    np.testing.assert_array_equal(draws[0][0], draws[1][0])
    assert draws[0][1] == draws[1][1]
