"""The samplers of ``mxnet_tpu/ops/init_random.py`` and
``misc_parity.py`` in the port, and ``nd.random``/``sym.random`` on them,
on the CPU.

The reference draws from threefry streams and the port from PyTorch's
generators, so no draw is compared with the reference's.  Instead:

- shapes and dtypes equal the reference's for the same call (scalar
  parameters, per-element parameter arrays, multinomial over 1-D and 2-D
  probabilities);
- one ``mx.random.seed`` gives the same draws twice, another seed others;
- 20,000 draws fit their distribution: a Kolmogorov-Smirnov test against
  ``scipy.stats`` for the continuous ones and a chi-square test of the
  counts for the discrete ones, each with a p-value above 1e-4;
- ``get_prob``'s log-probabilities and their gradient equal the
  reference's ``log(pick(data, draw))`` for the port's draws.
"""
import numpy as np
import pytest
import scipy.stats as st

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu

N = 20000
P_MIN = 1e-4          # the fit tests' p-value bound


def _c():
    return {"ctx": cpu()}


def _arr(pkg, x):
    return pkg.nd.array(np.asarray(x, np.float32),
                        **({} if pkg is mx else _c()))


# (id, call(pkg, shape) -> NDArray, scipy distribution, discrete)
SAMPLERS = [
    ("uniform", lambda p, s, **k: p.nd.random.uniform(-1, 3, shape=s, **k),
     st.uniform(-1, 4), False),
    ("normal", lambda p, s, **k: p.nd.random.normal(2, 3, shape=s, **k),
     st.norm(2, 3), False),
    ("randn", lambda p, s, **k: p.nd.random.randn(*s, loc=1, scale=2, **k),
     st.norm(1, 2), False),
    ("gamma", lambda p, s, **k: p.nd.random.gamma(2.5, 1.5, shape=s, **k),
     st.gamma(2.5, scale=1.5), False),
    ("exponential",
     lambda p, s, **k: p.nd.random.exponential(2.0, shape=s, **k),
     st.expon(scale=0.5), False),
    ("poisson", lambda p, s, **k: p.nd.random.poisson(4.0, shape=s, **k),
     st.poisson(4.0), True),
    ("negative_binomial",
     lambda p, s, **k: p.nd.random.negative_binomial(3, 0.4, shape=s, **k),
     st.nbinom(3, 0.4), True),
    ("generalized_negative_binomial",
     lambda p, s, **k: p.nd.random.generalized_negative_binomial(
         2.0, 0.5, shape=s, **k),
     st.nbinom(2.0, 0.5), True),   # r = 1 / alpha, p = 1 / (1 + mu alpha)
    ("randint", lambda p, s, **k: p.nd.random.randint(-5, 7, shape=s, **k),
     st.randint(-5, 7), True),
]


def _fit_pvalue(x, dist, discrete):
    if not discrete:
        return st.kstest(x, dist.cdf).pvalue
    values, counts = np.unique(x.astype(np.int64), return_counts=True)
    lo, hi = int(dist.ppf(1e-6)), int(dist.ppf(1 - 1e-6))
    support = np.arange(lo, hi + 1)
    observed = np.array([counts[values == v].sum() for v in support],
                        np.float64)
    expected = dist.pmf(support) * len(x)
    keep = expected >= 5
    observed, expected = observed[keep], expected[keep]
    rest = len(x) - expected.sum()
    if rest >= 5:               # the tails, one bin
        observed = np.append(observed, len(x) - observed.sum())
        expected = np.append(expected, rest)
    return st.chisquare(observed, expected * observed.sum()
                        / expected.sum()).pvalue


@pytest.mark.parametrize("name,call,dist,discrete", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_draws_fit_the_distribution(name, call, dist, discrete):
    tmx.random.seed(11)
    x = call(tmx, (N,), ctx=cpu()).asnumpy()
    assert _fit_pvalue(x, dist, discrete) > P_MIN


@pytest.mark.parametrize("name,call", [(s[0], s[1]) for s in SAMPLERS],
                         ids=[s[0] for s in SAMPLERS])
def test_one_seed_one_stream(name, call):
    draws = []
    for seed in (3, 3, 4):
        tmx.random.seed(seed)
        draws.append(call(tmx, (64,), ctx=cpu()).asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])


@pytest.mark.parametrize("name,call", [(s[0], s[1]) for s in SAMPLERS],
                         ids=[s[0] for s in SAMPLERS])
def test_shape_and_dtype_match_reference(name, call):
    for shape in ((3, 4), ()):
        if name == "randn" and shape == ():
            continue
        want = call(mx, shape)
        got = call(tmx, shape, ctx=cpu())
        assert got.shape == want.shape
        assert got.asnumpy().dtype == want.asnumpy().dtype


# per-element parameter arrays: (id, call(pkg, a, b) with a/b NDArrays,
# scipy distribution of the row at the parameters' first element)
PARAMS_A, PARAMS_B = [2.0, 5.0], [3.0, 0.5]
PER_ELEMENT = [
    ("sample_uniform", lambda p, a, b, s: p.nd.random.uniform(a, b, shape=s),
     lambda a, b: st.uniform(a, b - a), False, ([-1.0, 0.0], [3.0, 2.0])),
    ("sample_normal", lambda p, a, b, s: p.nd.random.normal(a, b, shape=s),
     lambda a, b: st.norm(a, b), False, (PARAMS_A, PARAMS_B)),
    ("sample_gamma", lambda p, a, b, s: p.nd.random.gamma(a, b, shape=s),
     lambda a, b: st.gamma(a, scale=b), False, (PARAMS_A, PARAMS_B)),
    ("sample_exponential",
     lambda p, a, b, s: p.nd.sample_exponential(a, shape=s),
     lambda a, b: st.expon(scale=1 / a), False, (PARAMS_A, PARAMS_B)),
    ("sample_poisson", lambda p, a, b, s: p.nd.sample_poisson(a, shape=s),
     lambda a, b: st.poisson(a), True, (PARAMS_A, PARAMS_B)),
    ("sample_negative_binomial",
     lambda p, a, b, s: p.nd.sample_negative_binomial(a, b, shape=s),
     lambda a, b: st.nbinom(a, b), True, ([3.0, 2.0], [0.4, 0.7])),
    ("sample_generalized_negative_binomial",
     lambda p, a, b, s: p.nd.sample_generalized_negative_binomial(
         a, b, shape=s),
     lambda a, b: st.nbinom(1 / b, 1 / (1 + a * b)), True,
     (PARAMS_A, PARAMS_B)),
]


@pytest.mark.parametrize("name,call,dist,discrete,params", PER_ELEMENT,
                         ids=[s[0] for s in PER_ELEMENT])
def test_per_element_samplers(name, call, dist, discrete, params):
    """Each element of the parameter arrays draws ``shape`` samples: the
    reference's shape and dtype, the rows' distributions, the seed's
    stream."""
    a, b = params
    want = call(mx, _arr(mx, a), _arr(mx, b), (3,))
    got = call(tmx, _arr(tmx, a), _arr(tmx, b), (3,))
    assert got.shape == want.shape == (2, 3)
    assert got.asnumpy().dtype == want.asnumpy().dtype
    tmx.random.seed(12)
    x = call(tmx, _arr(tmx, a), _arr(tmx, b), (N // 2,)).asnumpy()
    for row in range(2):
        assert _fit_pvalue(x[row], dist(a[row], b[row]), discrete) > P_MIN
    tmx.random.seed(12)
    again = call(tmx, _arr(tmx, a), _arr(tmx, b), (N // 2,)).asnumpy()
    np.testing.assert_array_equal(x, again)


@pytest.mark.parametrize("probs,shape", [
    ([0.1, 0.2, 0.3, 0.4], ()), ([0.1, 0.2, 0.3, 0.4], (5,)),
    ([[0.5, 0.25, 0.25], [0.1, 0.1, 0.8]], (4, 2)),
])
def test_multinomial_get_prob_matches_reference(probs, shape):
    """Draws of the reference's shape and dtype; with ``get_prob`` the
    log-probabilities and their gradient in the probabilities equal the
    reference's ``log(pick(data, draw))`` on the same draws."""
    p = np.asarray(probs, np.float32)
    want = mx.nd.random.multinomial(_arr(mx, p), shape=shape)
    data = _arr(tmx, p)
    data.attach_grad()
    tmx.random.seed(13)
    with tmx.autograd.record():
        draws, logp = tmx.nd.random.multinomial(data, shape=shape,
                                                get_prob=True)
    logp.backward()
    assert draws.shape == want.shape == logp.shape
    assert draws.asnumpy().dtype == want.asnumpy().dtype == np.int32
    d = draws.asnumpy().astype(np.int64)
    rdata = _arr(mx, p)
    rdata.attach_grad()
    with mx.autograd.record():
        lp = mx.nd.log(rdata)
        if p.ndim == 1:
            ref = mx.nd.take(lp, mx.nd.array(d.reshape(-1))).reshape(d.shape)
        else:
            flat = d.reshape(p.shape[0], -1)
            ref = mx.nd.stack(*[mx.nd.pick(lp, mx.nd.array(flat[:, j]),
                                           axis=-1)
                                for j in range(flat.shape[1])], axis=1)
            ref = ref.reshape(d.shape)
    ref.backward()
    np.testing.assert_allclose(logp.asnumpy(), ref.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(data.grad.asnumpy(), rdata.grad.asnumpy(),
                               rtol=1e-6)


def test_multinomial_frequencies():
    p = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    tmx.random.seed(14)
    d = tmx.nd.random.multinomial(_arr(tmx, p), shape=(N,)).asnumpy()
    counts = np.bincount(d, minlength=4)
    assert st.chisquare(counts, p * N).pvalue > P_MIN


def test_shuffle_permutes_the_first_axis():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    outs = []
    for seed in (5, 5, 6):
        tmx.random.seed(seed)
        outs.append(tmx.nd.random.shuffle(_arr(tmx, x)).asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(np.sort(outs[0][:, 0]), x[:, 0])
    np.testing.assert_array_equal(outs[0][:, 1] - outs[0][:, 0], 1.0)
    assert mx.nd.random.shuffle(_arr(mx, x)).shape == outs[0].shape


def test_out_and_autograd():
    """``out=`` takes the draw; normal with NDArray parameters records
    under ``autograd``: d(sum)/d(loc) is the draws per element,
    d(sum)/d(scale) the standard normal draws' sum."""
    dst = tmx.nd.zeros((5,), ctx=cpu())
    tmx.random.seed(2)
    tmx.nd.random.uniform(2, 3, shape=(5,), out=dst)
    v = dst.asnumpy()
    assert ((v >= 2) & (v < 3)).all()
    loc, scale = _arr(tmx, [1.0, -1.0]), _arr(tmx, [2.0, 0.5])
    loc.attach_grad()
    scale.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.random.normal(loc, scale, shape=(7,))
    y.backward()
    eps = (y.asnumpy() - loc.asnumpy()[:, None]) / scale.asnumpy()[:, None]
    np.testing.assert_allclose(loc.grad.asnumpy(), [7.0, 7.0])
    np.testing.assert_allclose(scale.grad.asnumpy(), eps.sum(1), rtol=1e-5)


def test_graph_samplers():
    """``sym.random`` nodes draw on the executor's device: with no inputs
    (``eval`` of a graph with no arguments), with Symbol parameters (the
    per-element ops), and in a training executor from its per-step
    generators."""
    out = tmx.sym.random.uniform(2, 3, shape=(4, 5)).eval(cpu())[0]
    assert out.shape == (4, 5) and out.context == cpu()
    v = out.asnumpy()
    assert ((v >= 2) & (v < 3)).all()
    mu, sigma = tmx.sym.var("mu"), tmx.sym.var("sigma")
    s = tmx.sym.random.normal(mu, sigma, shape=(3,)) + 0
    got = s.eval(cpu(), mu=_arr(tmx, [0.0, 100.0]),
                 sigma=_arr(tmx, [1e-3, 1e-3]))[0].asnumpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got[1], 100.0, atol=0.1)
    x = tmx.sym.var("x")
    noisy = x + tmx.sym.random.normal(shape=(2, 3))
    ex = noisy.simple_bind(cpu(), x=(2, 3))
    a = ex.forward(is_train=True)[0].asnumpy()
    b = ex.forward(is_train=True)[0].asnumpy()
    assert not np.array_equal(a, b)
    assert tmx.sym.random.multinomial(tmx.sym.var("p"), shape=(2,)) \
        .infer_shape(p=(3, 4))[1] == [(3, 2)]


@pytest.mark.parametrize("name,kwargs,want", [
    ("linspace", dict(start=-1, stop=2, num=7), None),
    ("linspace", dict(start=0, stop=1, num=4, endpoint=False), None),
    ("eye", dict(N=4, M=6, k=-1), None),
    ("eye", dict(N=3, dtype="int32"), None),
])
def test_linspace_eye_match_reference(name, kwargs, want):
    w = getattr(mx.nd, name)(**kwargs).asnumpy()
    g = getattr(tmx.nd, name)(ctx=cpu(), **kwargs).asnumpy()
    assert g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
