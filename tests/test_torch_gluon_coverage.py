"""Gluon's public names in the port against the reference's, on the CPU.

For each namespace (``gluon``, ``gluon.nn``, ``gluon.contrib.nn``,
``gluon.data``, ``gluon.utils``, ``gluon.model_zoo.vision``) and class
(``Block``, ``HybridBlock``, ``Parameter``, ``ParameterDict``, ``Trainer``,
``gluon.loss``, ``gluon.contrib``), the reference's public names that the
port lacks are exactly ROADMAP.md Queue 1's, each tagged with its item.  A
public name is one without a leading underscore whose object is a module
or is defined in the reference's own ``gluon`` package (imports such as
``math`` or ``NDArray`` are not Gluon's names).  A name ported later
leaves ``MISSING``; a name the reference gains, or one the port drops,
fails the test.
"""
import inspect

import pytest

import mxnet_tpu as mx
import mxnet_tpu.gluon  # noqa: F401
import mxnet_tpu.gluon.contrib.nn  # noqa: F401
import mxnet_tpu.gluon.data.vision  # noqa: F401
import mxnet_tpu.gluon.utils  # noqa: F401
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon  # noqa: F401

#: the reference's names the port lacks: (namespace, name) -> Queue 1 item
MISSING = {
    ("Trainer", "fit_epoch"): 6,
    ("loss", "CTCLoss"): 9,
    ("contrib", "rnn"): 5,
}

NAMESPACES = {
    "gluon": lambda g: g,
    "nn": lambda g: g.nn,
    "contrib": lambda g: g.contrib,
    "contrib.nn": lambda g: g.contrib.nn,
    "data": lambda g: g.data,
    "data.vision": lambda g: g.data.vision,
    "data.vision.transforms": lambda g: g.data.vision.transforms,
    "utils": lambda g: g.utils,
    "loss": lambda g: g.loss,
    "model_zoo": lambda g: g.model_zoo,
    "model_zoo.vision": lambda g: g.model_zoo.vision,
    "Block": lambda g: g.Block,
    "HybridBlock": lambda g: g.HybridBlock,
    "SymbolBlock": lambda g: g.SymbolBlock,
    "Parameter": lambda g: g.Parameter,
    "ParameterDict": lambda g: g.ParameterDict,
    "Trainer": lambda g: g.Trainer,
}


def _public(obj, package):
    names = set()
    for n in dir(obj):
        if n.startswith("_"):
            continue
        v = getattr(obj, n)
        if inspect.ismodule(v):
            if v.__name__.startswith(package):
                names.add(n)
        elif inspect.isclass(obj) or getattr(v, "__module__", "") \
                .startswith(package):
            names.add(n)
    return names


@pytest.mark.parametrize("space", sorted(NAMESPACES))
def test_only_queue_1_names_are_missing(space):
    get = NAMESPACES[space]
    ref = _public(get(mx.gluon), "mxnet_tpu.gluon")
    port = {n for n in dir(get(tmx.gluon)) if not n.startswith("_")}
    assert ref
    missing = {n for n in ref if n not in port}
    assert missing == {n for (s, n) in MISSING if s == space}


def test_missing_names_are_still_reference_names():
    for (space, name), item in MISSING.items():
        assert hasattr(NAMESPACES[space](mx.gluon), name)
        assert not hasattr(NAMESPACES[space](tmx.gluon), name)
        assert item in (5, 6, 9)
