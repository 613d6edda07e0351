"""The port's training step (hvd.init, DistributedOptimizer, broadcasts,
TransformerLM, chunked loss) against the reference's, on the CPU.

- World size 1: three ``DistributedOptimizer(SGD(momentum=0.9))`` steps of
  the port equal three steps of ``horovod_tpu.jax.DistributedOptimizer(
  optax.sgd(momentum=0.9))`` inside a shard_map over a size-1 mesh, from
  the same weights on the same batches (losses 2e-5, parameters 1e-5 of
  their update).
- World size 2 (two processes, gloo): one data-parallel step equals the
  single-process step on the concatenated batch, ``broadcast_parameters``
  from root 1 gives every rank root 1's weights, and a ``Compression.bf16``
  step stays within bf16 rounding of the gradients of the uncompressed one.

The reference's steps run in the worker pool of ``tests/torch_refpool.py``
(``_jobs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu.jax as ref_hvd
from horovod_tpu import spmd as ref_spmd
from horovod_tpu.compat import jaxshim
from horovod_tpu.models import transformer as ref
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import params_from_flax
from horovod_tpu_torch.models import transformer as port
from tests import torch_refpool

SHAPE = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
             mlp_ratio=4, max_seq_len=32)
LR = 0.1


def _batches(n, rows=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (rows, 32)) for _ in range(n)]


def _loss(model, tokens):
    hidden = model(tokens, return_hidden=True)
    return port.lm_loss_from_hidden(hidden, model.lm_head.weight.t(),
                                    tokens, chunk=16)


@pytest.fixture
def cpu_world():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """The two-rank gloo worlds (uncompressed and bf16 on the wire),
    started at once under one deadline (``tests/torch_worlds.py``); the
    first test asks for them, so that they run while it does."""
    from tests.torch_worlds import Worlds
    spawned = Worlds(60.0)
    try:
        dirs = {mode: tmp_path_factory.mktemp(f"gloo_{mode}")
                for mode in ("none", "bf16")}
        for mode, out in dirs.items():
            _spawn_world(spawned, out, mode)
        yield spawned, dirs
    finally:
        spawned.close()


def _optax_ref():
    """A worker's job: the reference's initial weights, then three steps
    of ``DistributedOptimizer(optax.sgd(momentum=0.9))`` inside a
    shard_map over a size-1 mesh on ``_batches(3)``: (initial weights,
    each step's loss, final weights), on the host."""
    batches = _batches(3)
    fmodel = ref.TransformerLM(ref.TransformerConfig(dtype=jnp.float32,
                                                     **SHAPE))
    params = fmodel.init(jax.random.key(0),
                         jnp.asarray(batches[0], jnp.int32))["params"]
    tx = ref_hvd.DistributedOptimizer(optax.sgd(LR, momentum=0.9),
                                      axis="data")
    mesh = ref_spmd.create_mesh({"data": 1}, devices=jax.devices()[:1])

    def loss_fn(p, t):
        hidden = fmodel.apply({"params": p}, t, return_hidden=True)
        return ref.lm_loss_from_hidden(hidden, p["lm_head"]["kernel"], t,
                                       chunk=16)

    def step(p, opt_state, t):
        loss, grads = jax.value_and_grad(loss_fn)(p, t)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    step = jax.jit(jaxshim.shard_map(
        step, mesh=mesh, in_specs=(P(), P(), P("data")),
        out_specs=(P(), P(), P())))
    start = jax.device_get(params)
    opt_state = tx.init(params)
    losses = []
    for tokens in batches:
        params, opt_state, loss_ref = step(params, opt_state,
                                           jnp.asarray(tokens, jnp.int32))
        losses.append(float(loss_ref))
    return start, losses, jax.device_get(params)


def _jobs():
    """The reference result the module's tests read, as a
    ``torch_refpool`` job."""
    return [((__name__, "optax"), _optax_ref, ())]


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_world_size_one_steps_match_optax_reference(cpu_world, gloo_worlds):
    batches = _batches(3)
    start_ref, losses_ref, params = torch_refpool.result((__name__, "optax"))
    model = port.TransformerLM(port.TransformerConfig(dtype=torch.float32,
                                                      **SHAPE), device="cpu")
    start = params_from_flax(start_ref)
    model.load_state_dict(start)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9))
    hvd.broadcast_parameters(model, root_rank=0)

    for tokens, loss_ref in zip(batches, losses_ref):
        opt.zero_grad()
        loss = _loss(model, torch.tensor(tokens))
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), loss_ref, atol=2e-5)
    theirs = params_from_flax(params)
    for name, p in model.named_parameters():
        moved = (theirs[name] - start[name]).abs().max().item()
        assert moved > 0, name
        err = (p.detach() - theirs[name]).abs().max().item()
        assert err <= 1e-5 * max(moved, 1.0), (name, err, moved)


def test_allreduce_ops_and_scales_at_world_size_one(cpu_world):
    spmd = hvd.spmd
    x = torch.arange(4.0)
    assert torch.equal(spmd.allreduce(x), x)
    assert torch.equal(spmd.allreduce(x, op=spmd.Max), x)
    assert torch.equal(spmd.allreduce(x, op=spmd.Sum, prescale_factor=2.0,
                                      postscale_factor=0.5), x)
    assert torch.equal(spmd.allgather(x), x)
    assert torch.equal(spmd.broadcast(x, root_rank=0), x)
    assert (hvd.rank(), hvd.size(), spmd.mesh_rank(), spmd.mesh_size()) == \
        (0, 1, 0, 1)
    with pytest.raises(ValueError):
        spmd.allreduce(x, op=7)
    with pytest.raises(ValueError):
        spmd.create_mesh({"data": 2})


def test_predivide_factor_keeps_the_mean(cpu_world):
    w = torch.nn.Parameter(torch.ones(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   gradient_predivide_factor=4.0)
    w.grad = torch.tensor([1.0, 2.0, 3.0])
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), [0.0, -1.0, -2.0],
                               atol=1e-6)


_WORKER = r"""
import sys, numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as T
out, mode = sys.argv[1], sys.argv[2]
hvd.init(device="cpu")
r = hvd.rank()
cfg = T.TransformerConfig(dtype=torch.float32, vocab_size=256, num_layers=2,
                          num_heads=4, head_dim=16, mlp_ratio=4,
                          max_seq_len=32)
model = T.TransformerLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(100 + r))
hvd.broadcast_parameters(model, root_rank=1)
init = {k: v.clone() for k, v in model.state_dict().items()}
tokens = np.random.RandomState(7).randint(0, 256, (4, 32))
t = torch.tensor(tokens[2 * r:2 * r + 2])
comp = hvd.Compression.bf16 if mode == "bf16" else hvd.Compression.none
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=%r, momentum=0.9),
    compression=comp)
hidden = model(t, return_hidden=True)
T.lm_loss_from_hidden(hidden, model.lm_head.weight.t(), t,
                      chunk=16).backward()
opt.step()
hvd.broadcast_optimizer_state(opt, root_rank=0)
torch.save({"init": init, "after": model.state_dict()}, f"{out}/{r}.pt")
hvd.shutdown()
""" % LR


def _spawn_world(spawned, out_dir, mode, worker=_WORKER):
    """Two ranks of a gloo world, each running ``worker`` with the
    arguments ``out_dir`` and ``mode`` (``tests/torch_worlds.py``)."""
    from tests.torch_worlds import child_env
    port_no = spawned.reserve_port()
    envs = [child_env(HOROVOD_RANK=r, HOROVOD_SIZE=2,
                      HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                      HOROVOD_CONTROLLER_PORT=port_no) for r in range(2)]
    spawned.start(mode, out_dir, [["-c", worker, out_dir, mode]] * 2, envs)


def test_two_rank_gloo_step_equals_single_process_step(gloo_worlds):
    spawned, worlds = gloo_worlds
    for mode in worlds:
        rcs, _, logs = spawned.wait(mode)
        assert rcs == [0, 0], "\n".join(logs)

    # The single-process step on the concatenated batch, from root 1's
    # weights.
    cfg = port.TransformerConfig(dtype=torch.float32, **SHAPE)
    model = port.TransformerLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(101))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    tokens = np.random.RandomState(7).randint(0, 256, (4, 32))
    _loss(model, torch.tensor(tokens)).backward()
    opt.step()
    want = model.state_dict()

    ranks = [torch.load(worlds["none"] / f"{r}.pt") for r in range(2)]
    for name in want:
        for got in ranks:
            assert torch.equal(got["init"][name], start[name]), name
            np.testing.assert_allclose(got["after"][name].numpy(),
                                       want[name].numpy(), atol=1e-6,
                                       err_msg=name)
        assert torch.equal(ranks[0]["after"][name], ranks[1]["after"][name])

    # bf16 on the wire rounds each gradient to 8 significant bits before
    # the sum and again after it: the update may differ from the exact one
    # by 2^-7 of the largest update, plus float noise.
    compressed = torch.load(worlds["bf16"] / "0.pt")["after"]
    for name in want:
        step = (want[name] - start[name]).abs().max().item()
        err = (compressed[name] - want[name]).abs().max().item()
        assert err <= 2 ** -7 * step + 1e-7, (name, err, step)
