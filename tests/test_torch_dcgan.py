"""The repository's DCGAN loop (``example/gluon/dcgan.py``) in the port
against the reference, on the CPU.

The example's own ``build_nets`` builds the generator and the
discriminator in each package (its ``nn`` swapped for the port's):
``Dense``, ``HybridLambda`` (a reshape), ``Conv2DTranspose``,
``LeakyReLU``, ``Conv2D`` and ``Flatten``, hybridized.  The reference's
nets get seeded Normal(0.02) weights, which reach the port through the
reference's ``save_parameters`` files.  Three steps of the example's loop
follow in each package, with two Adam ``Trainer``s, the generator's output
``detach``ed for the discriminator's step, on the example's real batches
and the same numpy latents (the packages' samplers draw differently by
design, ROADMAP.md Queue 3).  The losses agree within rtol 1e-4 at every
step (fp32; Adam divides by sqrt(v) + eps, which magnifies rounding in
the first steps' tiny second moments), and the generator's last weights
within 1e-4 of their largest |value|.
"""
import importlib.util
import os

import numpy as np

import mxnet_tpu as mx
import mxnet_tpu.gluon  # noqa: F401
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon  # noqa: F401
from mxnet_tpu_torch import cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
BATCH, NZ, SIZE, STEPS = 8, 16, 16, 3


def _example():
    spec = importlib.util.spec_from_file_location(
        "dcgan_example", os.path.join(REPO, "example", "gluon", "dcgan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nets(example, pkg):
    old = example.nn
    example.nn = pkg.gluon.nn
    try:
        with pkg.name.NameManager():
            return example.build_nets()
    finally:
        example.nn = old


def _seed_reference(net, x, path, seed):
    net.initialize()
    net.infer_shape(mx.nd.array(x))
    r = np.random.default_rng(seed)
    for name, p in net.collect_params().items():
        v = r.normal(0.0, 0.02, p.shape) if name.endswith("_weight") \
            else np.zeros(p.shape)
        p.set_data(mx.nd.array(v.astype(np.float32)))
        p._finish_deferred_init()
    net.save_parameters(path)


def _train(example, pkg, nets, latents):
    ctx = {} if pkg is mx else {"ctx": cpu()}
    netG, netD = nets
    netG.hybridize()
    netD.hybridize()
    loss_fn = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainerG = pkg.gluon.Trainer(netG.collect_params(), "adam",
                                 {"learning_rate": 0.02, "beta1": 0.5})
    trainerD = pkg.gluon.Trainer(netD.collect_params(), "adam",
                                 {"learning_rate": 0.02, "beta1": 0.5})
    ones = pkg.nd.ones((BATCH,), **ctx)
    zeros = pkg.nd.zeros((BATCH,), **ctx)
    losses = []
    batches = example.real_batches(BATCH * STEPS, SIZE, BATCH, seed=0)
    for real, z in zip(batches, latents):
        realn = pkg.nd.array(real, **ctx)
        z = pkg.nd.array(z, **ctx)
        with pkg.autograd.record():
            fake = netG(z)
            out_r = netD(realn).reshape((-1,))
            out_f = netD(fake.detach()).reshape((-1,))
            errD = (loss_fn(out_r, ones) + loss_fn(out_f, zeros)).mean()
        errD.backward()
        trainerD.step(1)
        with pkg.autograd.record():
            errG = loss_fn(netD(fake).reshape((-1,)), ones).mean()
        errG.backward()
        trainerG.step(1)
        losses.append((float(errD.asnumpy()), float(errG.asnumpy())))
    weights = {k: p.data().asnumpy() for k, p in
               netG.collect_params().items()}
    return np.array(losses), weights


def test_dcgan_loop_matches_reference(tmp_path):
    example = _example()
    latents = np.random.default_rng(0).standard_normal(
        (STEPS, BATCH, NZ)).astype(np.float32)
    ref = _nets(example, mx)
    pG, pD = str(tmp_path / "g.params"), str(tmp_path / "d.params")
    _seed_reference(ref[0], latents[0], pG, 1)
    _seed_reference(ref[1], np.zeros((BATCH, 1, SIZE, SIZE), np.float32), pD,
                    2)
    port = _nets(example, tmx)
    port[0].load_parameters(pG, ctx=cpu())
    port[1].load_parameters(pD, ctx=cpu())
    want, wref = _train(example, mx, ref, latents)
    got, wport = _train(example, tmx, port, latents)
    assert np.isfinite(got).all() and got.shape == (STEPS, 2)
    np.testing.assert_allclose(got, want, rtol=TOL)
    for k in wref:
        err = np.abs(wport[k] - wref[k]).max() / np.abs(wref[k]).max()
        assert err <= TOL, (k, err)
