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
"""

import os
import socket
import subprocess
import sys

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def test_world_size_one_steps_match_optax_reference(cpu_world):
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

    model = port.TransformerLM(port.TransformerConfig(dtype=torch.float32,
                                                      **SHAPE), device="cpu")
    start = params_from_flax(jax.device_get(params))
    model.load_state_dict(start)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9))
    hvd.broadcast_parameters(model, root_rank=0)

    opt_state = tx.init(params)
    for tokens in batches:
        params, opt_state, loss_ref = step(params, opt_state,
                                           jnp.asarray(tokens, jnp.int32))
        opt.zero_grad()
        loss = _loss(model, torch.tensor(tokens))
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), float(loss_ref), atol=2e-5)
    theirs = params_from_flax(jax.device_get(params))
    for name, p in model.named_parameters():
        moved = (theirs[name] - start[name]).abs().max().item()
        assert moved > 0, name
        err = (p.detach() - theirs[name]).abs().max().item()
        assert err <= 1e-5 * max(moved, 1.0), (name, err, moved)


def test_allreduce_ops_and_scales_at_world_size_one(cpu_world):
    x = torch.arange(4.0)
    assert torch.equal(hvd.allreduce(x), x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Max), x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                                     postscale_factor=0.5), x)
    assert torch.equal(hvd.allgather(x), x)
    assert torch.equal(hvd.broadcast(x, root_rank=0), x)
    assert (hvd.rank(), hvd.size(), hvd.mesh_rank(), hvd.mesh_size()) == \
        (0, 1, 0, 1)
    with pytest.raises(ValueError):
        hvd.allreduce(x, op=7)
    with pytest.raises(ValueError):
        hvd.create_mesh({"data": 2})


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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_world(out_dir, mode, worker=_WORKER):
    """Two ranks of a gloo world, each running ``worker`` with the
    arguments ``out_dir`` and ``mode``."""
    port_no = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port_no),
                   GLOO_SOCKET_IFNAME="lo",
                   PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker, str(out_dir), mode], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs):
    for p in procs:
        try:
            out, _ = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out


def test_two_rank_gloo_step_equals_single_process_step(tmp_path):
    worlds = {mode: (tmp_path / mode, None) for mode in ("none", "bf16")}
    for mode, (out, _) in worlds.items():
        out.mkdir()
        worlds[mode] = (out, _spawn_world(out, mode))
    for out, procs in worlds.values():
        _join(procs)

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

    ranks = [torch.load(worlds["none"][0] / f"{r}.pt") for r in range(2)]
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
    compressed = torch.load(worlds["bf16"][0] / "0.pt")["after"]
    for name in want:
        step = (want[name] - start[name]).abs().max().item()
        err = (compressed[name] - want[name]).abs().max().item()
        assert err <= 2 ** -7 * step + 1e-7, (name, err, step)
