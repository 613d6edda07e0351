"""The port's MNIST convnet and ViT (horovod_tpu_torch.models.mnist, .vit)
against the flax reference, on the CPU, with one set of weights.

Weights and images are made with numpy from a seed and carried into both
models. In fp32 the tolerances are the reference's own: 2e-5 on forward
values, 1e-4 on gradients. The bf16 ViT rounds activations at every
stage, in another order in XLA and in torch, so it is held to the bound of
the Transformer LM's bf16 parity test (tests/test_torch_transformer.py):
logits within 2.5% of their largest magnitude, loss within 1e-2. The
reference's weights and results are computed in the worker pool of
``tests/torch_refpool.py`` (``_jobs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import mnist as ref_mnist
from horovod_tpu.models import vit as ref_vit
from horovod_tpu_torch.models import mnist, params_from_flax, vit
from tests import torch_refpool

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
VIT = dict(image_size=32, patch_size=4, num_classes=10, embed_dim=32,
           num_layers=2, num_heads=2)


def _random_params(fmodel, images, seed):
    """Flax params of ``fmodel`` drawn with numpy: kernels of std
    1/sqrt(fan_in) (DenseGeneral's input axes lead, its output axes
    trail), norm scales in [0.5, 1.5], everything else of std 0.1."""
    shapes = jax.eval_shape(lambda x: fmodel.init(jax.random.key(0), x),
                            images)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        names = [p.key for p in path]
        if names[-1] == "kernel":
            lead = s.ndim - 1
            if s.ndim == 3:
                lead = 2 if names[-2] == "out" else 1
            return rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:lead]))
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.randn(*s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: draw(p, s).astype(np.float32), shapes)


def _xent(logits, labels, n):
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits)
                             * jax.nn.one_hot(labels, n), axis=-1))


def _mnist_inputs():
    rng = np.random.RandomState(0)
    return rng.rand(4, 28, 28, 1).astype(np.float32), rng.randint(0, 10, 4)


def _vit_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, 2))


def _fp32_ref(name):
    """A worker's job: the numpy weights of the flax model ``name``
    ("mnist" or "vit") and its fp32 loss, logits and gradients on them,
    on the host."""
    if name == "mnist":
        fmodel, (images, labels) = ref_mnist.MnistConvNet(), _mnist_inputs()
    else:
        fmodel = ref_vit.ViT(ref_vit.ViTConfig(dtype=jnp.float32, **VIT))
        images, labels = _vit_inputs(1)
    params = _random_params(fmodel, jnp.asarray(images), seed=images.shape[1])

    def loss_fn(p):
        logits = fmodel.apply({"params": p}, jnp.asarray(images))
        return _xent(logits, labels, logits.shape[-1]), logits

    (loss_ref, logits_ref), grads_ref = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jax.device_get((params, float(loss_ref), logits_ref, grads_ref))


def _bf16_ref():
    """A worker's job: the numpy weights of the bf16 ViT with one head
    and the reference's logits on them."""
    images, _ = _vit_inputs(2)
    fmodel = ref_vit.ViT(ref_vit.ViTConfig(dtype=jnp.bfloat16,
                                           **dict(VIT, num_heads=1)))
    params = _random_params(fmodel, jnp.asarray(images), seed=2)
    return params, np.asarray(jax.jit(fmodel.apply)({"params": params},
                                                    jnp.asarray(images)))


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    return [((__name__, "mnist"), _fp32_ref, ("mnist",)),
            ((__name__, "vit"), _fp32_ref, ("vit",)),
            ((__name__, "vit_bf16"), _bf16_ref, ())]


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def _check_fp32(name, model, images, labels):
    """Logits, loss and every parameter gradient of ``model`` (carrying
    the numpy weights) against the flax model ``name`` in fp32."""
    params, loss_ref, logits_ref, grads_ref = torch_refpool.result(
        (__name__, name))
    state = params_from_flax(params)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    logits = model(torch.tensor(images))
    loss = F.cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), atol=FWD_TOL)
    np.testing.assert_allclose(loss.item(), loss_ref, atol=FWD_TOL)
    grads = params_from_flax(grads_ref)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   atol=GRAD_TOL, err_msg=name)


def test_mnist_convnet_matches_reference():
    images, labels = _mnist_inputs()
    _check_fp32("mnist", mnist.MnistConvNet(device="cpu"), images, labels)


def test_vit_matches_reference_in_fp32():
    images, labels = _vit_inputs(1)
    _check_fp32("vit", vit.ViT(vit.ViTConfig(dtype=torch.float32, **VIT),
                               device="cpu"), images, labels)


def test_vit_matches_reference_within_bf16_rounding():
    # One head of 32: flax divides the query by sqrt(32) rounded to bf16.
    shape = dict(VIT, num_heads=1)
    images, labels = _vit_inputs(2)
    params, logits_ref = torch_refpool.result((__name__, "vit_bf16"))
    model = vit.ViT(vit.ViTConfig(dtype=torch.bfloat16, **shape),
                    device="cpu")
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        logits = model(torch.tensor(images))
    assert logits.dtype == torch.float32
    logits = logits.numpy()
    assert np.all(np.isfinite(logits))
    err = np.abs(logits - logits_ref).max()
    assert err <= 0.025 * np.abs(logits_ref).max(), err
    loss_ref = float(_xent(jnp.asarray(logits_ref), labels, 10))
    loss = F.cross_entropy(torch.tensor(logits), torch.tensor(labels)).item()
    assert abs(loss - loss_ref) <= 1e-2


def test_vit_presets_have_the_reference_widths():
    fields = ("image_size", "patch_size", "num_classes", "embed_dim",
              "num_layers", "num_heads", "mlp_ratio")
    # ViT_B16 is ViTConfig's defaults in both packages.
    cfg, ref_cfg = vit.ViTConfig(), ref_vit.ViTConfig()
    assert [getattr(cfg, f) for f in fields] == \
        [getattr(ref_cfg, f) for f in fields]
    assert cfg.dtype == torch.bfloat16
