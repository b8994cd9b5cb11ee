"""Pretrained weights on local disk (counterpart of
mxnet_tpu/gluon/model_zoo/model_store.py: `get_model_file` :71, `purge`
:106).

`get_model_file` finds a checkpoint already under `root`
(``~/.mxnet/models`` by default): the sha1-pinned
``<name>-<sha1[:8]>.params`` the reference publishes (its sha1 checked),
else ``<name>.params``, else any ``<name>-*.params``. Nothing is fetched
over a network: a missing file raises RuntimeError. The files are the
reference's ``.params`` format, which `HybridBlock.load_parameters`
reads.
"""
from __future__ import annotations

import hashlib
import os

__all__ = ["get_model_file", "load_pretrained", "purge"]

# sha1 pins of the published checkpoints (model_store.py:27)
_MODEL_SHA1 = {name: checksum for checksum, name in [
    ("44335d1f0046b328243b32a26a4fbd62d9057b45", "alexnet"),
    ("f27dbf2dbd5ce9a80b102d89c7483342cd33cb31", "densenet121"),
    ("b6c8a95717e3e761bd88d145f4d0a214aaa515dc", "densenet161"),
    ("2603f878403c6aa5a71a124c4a3307143d6820e9", "densenet169"),
    ("1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb", "densenet201"),
    ("ed47ec45a937b656fcc94dabde85495bbef5ba1f", "inceptionv3"),
    ("9f83e440996887baf91a6aff1cccc1c903a64274", "mobilenet0.25"),
    ("8e9d539cc66aa5efa71c4b6af983b936ab8701c3", "mobilenet0.5"),
    ("529b2c7f4934e6cb851155b22c96c9ab0a7c4dc2", "mobilenet0.75"),
    ("6b8c5106c730e8750bcd82ceb75220a3351157cd", "mobilenet1.0"),
    ("a0666292f0a30ff61f857b0b66efc0228eb6a54b", "resnet18_v1"),
    ("48216ba99a8b1005d75c0f3a0c422301a0473233", "resnet34_v1"),
    ("0aee57f96768c0a2d5b23a6ec91eb08dfb0a45ce", "resnet50_v1"),
    ("d988c13d6159779e907140a638c56f229634cb02", "resnet101_v1"),
    ("671c637a14387ab9e2654eafd0d493d86b1c8579", "resnet152_v1"),
    ("a81db45fd7b7a2d12ab97cd88ef0a5ac48b8f657", "resnet18_v2"),
    ("9d6b80bbc35169de6b6edecffdd6047c56fdd322", "resnet34_v2"),
    ("ecdde35339c1aadbec4f547857078e734a76fb49", "resnet50_v2"),
    ("18e93e4f48947e002547f50eabbcc9c83e516aa6", "resnet101_v2"),
    ("f2695542de38cf7e71ed58f02893d82bb409415e", "resnet152_v2"),
    ("264ba4970a0cc87a4f15c96e25246a1307caf523", "squeezenet1.0"),
    ("33ba0f93753c83d86e1eb397f38a667eaf2e9376", "squeezenet1.1"),
    ("dd221b160977f36a53f464cb54648d227c707a05", "vgg11"),
    ("ee79a8098a91fbe05b7a973fed2017a6117723a8", "vgg11_bn"),
    ("6bc5de58a05a5e2e7f493e2d75a580d83efde38c", "vgg13"),
    ("7d97a06c3c7a1aecc88b6e7385c2b373a249e95e", "vgg13_bn"),
    ("e660d4569ccb679ec68f1fd3cce07a387252a90a", "vgg16"),
    ("7f01cf050d357127a73826045c245041b0df7363", "vgg16_bn"),
    ("ad2f660d101905472b83590b59708b71ea22b2e5", "vgg19"),
]}

_DEFAULT_ROOT = os.path.join("~", ".mxnet", "models")


def _sha1_of(path):
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def get_model_file(name, root=_DEFAULT_ROOT):
    """The path of the checkpoint for model `name` under `root`."""
    root = os.path.expanduser(root or _DEFAULT_ROOT)
    pinned = _MODEL_SHA1.get(name)
    if os.path.isdir(root):
        if pinned:
            cached = os.path.join(root, "%s-%s.params" % (name, pinned[:8]))
            if os.path.exists(cached):
                if _sha1_of(cached) != pinned:
                    raise RuntimeError(
                        "checkpoint %s fails its sha1 pin (%s != %s)"
                        % (cached, _sha1_of(cached), pinned))
                return cached
        exact = os.path.join(root, "%s.params" % name)
        if os.path.exists(exact):
            return exact
        for fname in sorted(os.listdir(root)):
            if fname.startswith(name + "-") and fname.endswith(".params"):
                return os.path.join(root, fname)
    raise RuntimeError(
        "no checkpoint for %r under %s: this package reads local files "
        "only; place the reference-format %s.params there" % (name, root,
                                                              name))


def load_pretrained(net, name, root=None, ctx=None):
    """Load the local checkpoint `name` into `net` (on `ctx`, default
    the current context)."""
    net.load_parameters(get_model_file(name, root=root or _DEFAULT_ROOT),
                        ctx=ctx)


def purge(root=_DEFAULT_ROOT):
    """Remove the cached checkpoints under `root` (model_store.py:106)."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
