"""The port's ResNet (horovod_tpu_torch.models.resnet) against the flax
reference, on the CPU, with one set of weights.

Weights, running statistics and images are made with numpy from a seed
(BatchNorm scales away from the reference's zero init, so that every
residual branch carries gradient) and carried into both models. In fp32
the tolerances are the reference's own: 2e-5 on forward values (logits,
loss, running statistics) and 1e-4 on gradients. Narrow models (4
filters, one block per stage) at an even (32) and an odd (33) image size
hold the "SAME" padding rule, which is asymmetric at stride 2 on even
inputs only.

Cross-replica BatchNorm: two gloo ranks with half the batch each take one
``DistributedOptimizer`` step that equals the single-process step on the
whole batch (1e-5), and the same step with the backward's allreduce of the
statistics' gradient taken out does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import resnet as ref
from horovod_tpu_torch.models import params_from_flax
from horovod_tpu_torch.models import resnet as port
from tests.test_torch_train_step import _spawn_world

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
NARROW = dict(stage_sizes=[1, 1], num_filters=4, num_classes=10)


def _random_variables(fmodel, images, seed):
    """A flax variables tree of ``fmodel`` drawn with numpy: kernels of
    std 1/sqrt(fan_in), norm scales in [0.5, 1.5], biases and running
    means of std 0.1, running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda x: fmodel.init(jax.random.key(0), x,
                                                  train=True), images)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.randn(*s.shape) / np.sqrt(fan_in)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.randn(*s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: draw(p, s).astype(np.float32), shapes)


def _inputs(size, seed, batch=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, size, size, 3).astype(np.float32),
            rng.randint(0, 10, batch))


def _xent(logits, labels):
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits)
                             * jax.nn.one_hot(labels, 10), axis=-1))


@pytest.mark.parametrize("block,size", [("BottleneckBlock", 32),
                                        ("BasicBlock", 33)])
def test_train_step_and_eval_match_reference(block, size):
    images, labels = _inputs(size, seed=size)
    fmodel = ref.ResNet(block_cls=getattr(ref, block), dtype=jnp.float32,
                        **NARROW)
    variables = _random_variables(fmodel, jnp.asarray(images), seed=size)

    def loss_fn(params):
        logits, updates = fmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        return _xent(logits, labels), (logits, updates["batch_stats"])

    (loss_ref, (logits_ref, stats_ref)), grads_ref = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    eval_ref = jax.jit(lambda v: fmodel.apply(v, jnp.asarray(images),
                                              train=False))(
        {"params": variables["params"], "batch_stats": stats_ref})

    model = port.ResNet(block_cls=getattr(port, block), dtype=torch.float32,
                        device="cpu", **NARROW)
    state = params_from_flax(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    logits = model(torch.tensor(images))
    loss = F.cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), atol=FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=FWD_TOL)
    grads = params_from_flax(jax.device_get(grads_ref))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   atol=GRAD_TOL, err_msg=name)
    stats = params_from_flax({"params": {},
                              "batch_stats": jax.device_get(stats_ref)})
    now = model.state_dict()
    for name, value in stats.items():
        assert not torch.equal(value, state[name]), name
        np.testing.assert_allclose(now[name].numpy(), value.numpy(),
                                   atol=FWD_TOL, err_msg=name)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(images)).numpy(),
                                   np.asarray(eval_ref), atol=FWD_TOL)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (33, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
])
def test_same_padding_follows_lax(size, kernel, stride, pads):
    from jax import lax
    from horovod_tpu_torch.models.layers import same_pads
    assert same_pads(size, kernel, stride) == pads
    assert lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME") == \
        [pads]


def test_fresh_weights_follow_flax_initialisers():
    model = port.ResNet(block_cls=port.BottleneckBlock, device="cpu",
                        generator=torch.Generator().manual_seed(3),
                        stage_sizes=[1, 1], num_filters=16)
    block = model.BottleneckBlock_1
    assert torch.all(block.BatchNorm_2.scale == 0)
    assert torch.all(block.BatchNorm_0.scale == 1)
    assert torch.all(block.norm_proj.bias == 0)
    assert torch.all(block.BatchNorm_0.var == 1)
    w = block.Conv_1.weight.detach()           # fan_in 3 * 3 * 32
    std = 1 / np.sqrt(w[0].numel())
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.all(model.head.bias == 0)


_BN_WORKER = r"""
import sys, torch, torch.nn.functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet as R
out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
data = torch.load(f"{out}/init.pt")
half = slice(2 * r, 2 * r + 2)
results = {}
for variant in ("synced", "no_backward_sync"):
    if variant == "no_backward_sync":
        R._pmean_grad = lambda grad, axis: grad
    model = R.ResNet(block_cls=R.BottleneckBlock, dtype=torch.float32,
                     axis_name="data", device="cpu", stage_sizes=[1, 1],
                     num_filters=4, num_classes=10)
    model.load_state_dict(data["state"])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    F.cross_entropy(model(data["images"][half]),
                    data["labels"][half]).backward()
    opt.step()
    results[variant] = {
        "state": model.state_dict(),
        "momentum": [opt.state[p]["momentum_buffer"]
                     for p in model.parameters()]}
torch.save(results, f"{out}/{r}.pt")
hvd.shutdown()
"""


@pytest.fixture(scope="module", autouse=True)
def bn_world(tmp_path_factory):
    """Starts the two ranks of the cross-replica test before the module's
    other tests run, so that their start-up (torch's imports) overlaps
    them; the test joins them."""
    out = tmp_path_factory.mktemp("bn_world")
    images, labels = _inputs(16, seed=5)
    fmodel = ref.ResNet(block_cls=ref.BottleneckBlock, dtype=jnp.float32,
                        **NARROW)
    state = params_from_flax(_random_variables(fmodel, jnp.asarray(images),
                                               seed=5))
    data = {"state": state, "images": torch.tensor(images),
            "labels": torch.tensor(labels)}
    torch.save(data, out / "init.pt")
    from tests.torch_worlds import Worlds
    spawned = Worlds(60.0)
    try:
        _spawn_world(spawned, out, "bn", worker=_BN_WORKER)
        yield out, data, spawned
    finally:
        spawned.close()


def test_cross_replica_batchnorm_step_equals_whole_batch_step(bn_world):
    out, data, spawned = bn_world
    model = port.ResNet(block_cls=port.BottleneckBlock, dtype=torch.float32,
                        device="cpu", **NARROW)
    model.load_state_dict(data["state"])
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    F.cross_entropy(model(data["images"]), data["labels"]).backward()
    opt.step()
    want = model.state_dict()
    want_momentum = [opt.state[p]["momentum_buffer"]
                     for p in model.parameters()]
    rcs, _, logs = spawned.wait("bn")
    assert rcs == [0, 0], "\n".join(logs)

    def worst(got):
        errs = [(got["state"][k] - want[k]).abs().max().item() for k in want]
        errs += [(a - b).abs().max().item()
                 for a, b in zip(got["momentum"], want_momentum)]
        return max(errs)

    for r in range(2):
        results = torch.load(out / f"{r}.pt")
        assert worst(results["synced"]) <= 1e-5
        # Without the backward's allreduce each rank differentiates only
        # its own loss through the shared statistics: the test sees it.
        assert worst(results["no_backward_sync"]) > 1e-3
