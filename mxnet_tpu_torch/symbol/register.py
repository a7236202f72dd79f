"""Generate ``sym.<op>`` constructors from the op registry (counterpart of
``mxnet_tpu/symbol/register.py``).  Symbol arguments, positional or by
keyword, become graph inputs; everything else becomes node attrs."""
from __future__ import annotations

from ..ops.registry import OPS
from .symbol import Symbol, _create


def _make_fn(op_name):
    op = OPS[op_name]

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_inputs = []
        for a in args:
            if isinstance(a, Symbol):
                sym_inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and \
                    isinstance(a[0], Symbol):
                sym_inputs.extend(a)
            else:
                # positional scalar params fill declared params in order
                for k in op.params:
                    if k not in kwargs:
                        kwargs[k] = a
                        break
        kw_syms = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        for k in kw_syms:
            kwargs.pop(k)
        if kw_syms:
            if op.arg_names:
                slots = {n: i for i, n in enumerate(op.arg_names)}
                total = max((slots.get(k, -1) for k in kw_syms), default=-1)
                ins = list(sym_inputs) + [None] * (
                    max(0, total + 1 - len(sym_inputs)))
                for k, v in kw_syms.items():
                    i = slots.get(k)
                    if i is None:
                        ins.append(v)
                    elif ins[i] is not None:
                        raise TypeError(
                            "op %s: input %r given both positionally and "
                            "by keyword" % (op_name, k))
                    else:
                        ins[i] = v
                sym_inputs = ins
            else:
                sym_inputs.extend(kw_syms.values())
        return _create(op_name, sym_inputs, kwargs, name, attr=attr)

    fn.__name__ = op_name
    fn.__qualname__ = op_name
    fn.__doc__ = op.doc
    return fn


def populate(module_dict):
    for name in list(OPS):
        if name not in module_dict:
            module_dict[name] = _make_fn(name)
