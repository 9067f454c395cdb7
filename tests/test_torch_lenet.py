"""The port's LeNet-5 against the reference's, from the same weights.

Weights go across with `params_from_jax`; images and labels are made with
numpy.  rtol 1e-5 / atol 1e-5: XLA's and PyTorch's CPU convolutions sum in
different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.fed import methods as jmethods
from repro.models import lenet as jlenet
from repro_torch.fed import methods as tmethods
from repro_torch.models import lenet as tlenet
from repro_torch.weights import params_from_jax

RTOL = ATOL = 1e-5


def _setup(seed, image_size=32, channels=3, n_classes=10, b=6):
    jcfg = jlenet.LeNetConfig(n_classes, image_size, channels)
    tcfg = tlenet.LeNetConfig(n_classes, image_size, channels)
    jp = jlenet.init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, image_size, image_size, channels)
                                 ).astype(np.float32)
    labels = rng.integers(0, n_classes, b).astype(np.int32)
    return jcfg, tcfg, jp, tp, images, labels


@pytest.mark.parametrize("shape", [(32, 3, 10), (28, 1, 62)])
def test_init_matches_reference_shapes(shape):
    s, c, k = shape
    jp = jlenet.init(jlenet.LeNetConfig(k, s, c), jax.random.PRNGKey(0))
    tp = tlenet.init(tlenet.LeNetConfig(k, s, c),
                     torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape, key
        assert tp[key].dtype == torch.float32
    assert tlenet.HEAD_KEYS == jlenet.HEAD_KEYS


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_loss_accuracy_match_reference(seed):
    jcfg, tcfg, jp, tp, images, labels = _setup(seed)
    logits = tlenet.forward(tcfg, tp, torch.from_numpy(images))
    jlogits = jlenet.forward(jcfg, jp, jnp.asarray(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    tb = dict(images=torch.from_numpy(images),
              labels=torch.from_numpy(labels.astype(np.int64)))
    jb = dict(images=jnp.asarray(images), labels=jnp.asarray(labels))
    np.testing.assert_allclose(float(tlenet.loss_fn(tcfg, tp, tb)),
                               float(jlenet.loss_fn(jcfg, jp, jb)),
                               rtol=RTOL, atol=ATOL)
    assert float(tlenet.accuracy(tcfg, tp, tb)) == pytest.approx(
        float(jlenet.accuracy(jcfg, jp, jb)))


def test_grayscale_28px_logits_match_reference():
    jcfg, tcfg, jp, tp, images, _ = _setup(2, 28, 1, 62)
    np.testing.assert_allclose(
        tlenet.forward(tcfg, tp, torch.from_numpy(images)).numpy(),
        np.asarray(jlenet.forward(jcfg, jp, jnp.asarray(images))),
        rtol=RTOL, atol=ATOL)


def test_per_microbatch_gradients_match_reference():
    k, b = 4, 5
    jcfg, tcfg, jp, tp, images, labels = _setup(3, b=k * b)
    images = images.reshape(k, b, 32, 32, 3)
    labels = labels.reshape(k, b)
    jtask = jmethods.Task(loss=lambda p, bt: jlenet.loss_fn(jcfg, p, bt))
    ttask = tmethods.Task(loss=lambda p, bt: tlenet.loss_fn(tcfg, p, bt))
    jg = jmethods._microbatch_grads(
        jtask, jp, dict(images=jnp.asarray(images),
                        labels=jnp.asarray(labels)))
    # the port's cohort form: one client, K microbatches
    tg = tmethods._microbatch_grads(
        ttask, tp, dict(images=torch.from_numpy(images)[None],
                        labels=torch.from_numpy(labels.astype(np.int64))[None]))
    for key in jp:
        np.testing.assert_allclose(tg[key][0].numpy(), np.asarray(jg[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # the same gradients one microbatch at a time, without vmap
    g0 = grad(ttask.loss)(tp, dict(
        images=torch.from_numpy(images[0]),
        labels=torch.from_numpy(labels[0].astype(np.int64))))
    for key in jp:
        np.testing.assert_allclose(g0[key].numpy(), tg[key][0, 0].numpy(),
                                   rtol=RTOL, atol=ATOL)


# One fresh process set up as this module is (both packages' `fed`
# imported, JAX's CPU client started by the reference's init), then the
# port's first CPU forward against its second on the same tensors.
_FIRST_CALL = r"""
import jax, numpy as np, torch
from repro.fed import methods as _jm
from repro_torch.fed import methods as _tm
from repro.models import lenet as jlenet
from repro_torch.models import lenet as tlenet
from repro_torch.weights import params_from_jax
cfg = tlenet.LeNetConfig()
params = params_from_jax(jax.tree.map(np.asarray, jlenet.init(
    jlenet.LeNetConfig(), jax.random.PRNGKey(0))))
images = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (6, 32, 32, 3)).astype(np.float32))
a = tlenet.forward(cfg, params, images)
b = tlenet.forward(cfg, params, images)
print("EQUAL" if torch.equal(a, b) else
      f"DIFFER {float((a - b).abs().max()):.3e}")
"""


def test_first_cpu_forward_equals_later_ones_in_fresh_processes():
    """In some fresh processes that had imported JAX, the first CPU forward
    took other bits than the second (torch.tanh through MKL's vmsTanh; see
    the module docstring of `repro_torch.models.lenet`).  Eight processes
    at once, each must give the same bits twice."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(8)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.strip().splitlines()[-1])
    assert outs == ["EQUAL"] * len(procs), outs
