"""Pretrained weights (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``).  The port downloads
nothing: a model's file ``<name>-<hash>.params`` (or ``.params.npz``, the
npz container) is looked for under ``root`` (default ``~/.mxnet/models``),
then in the repository's ``models/``; a missing one raises with the
expected name."""
from __future__ import annotations

import os

__all__ = ["get_model_file", "purge"]


def _repo_models_dir():
    return os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
        "models"))


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """The path of ``name``'s pretrained parameter file."""
    root = os.path.expanduser(root or os.path.join("~", ".mxnet", "models"))
    for d in (root, _repo_models_dir()):
        for fname in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            if fname.startswith(name + "-") and fname.endswith(
                    (".params", ".params.npz")):
                return os.path.join(d, fname)
    raise FileNotFoundError(
        "pretrained model file for %r not found under %s or %s; the port "
        "downloads nothing: place '%s-<hash>.params' there by hand"
        % (name, root, _repo_models_dir(), name))


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Remove the parameter files under ``root``."""
    root = os.path.expanduser(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
