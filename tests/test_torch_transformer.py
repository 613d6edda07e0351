"""The port's Transformer LM (horovod_tpu_torch.models.transformer) against
the flax reference, on the CPU, with one set of weights.

Shapes are those of ``__graft_entry__._tiny_config`` (vocab 256, 2 layers,
4 heads of 16, MLP x4, 32 positions). In fp32 the tolerances are the
reference's own: 2e-5 on forward values, 1e-4 on gradients. The bf16 case
rounds activations at every layer, in another order in XLA and in torch,
so it is held to a looser bound stated beside it. The reference's weights
and results are computed in the worker pool of ``tests/torch_refpool.py``
(``_jobs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as ref
from horovod_tpu_torch.models import params_from_flax
from horovod_tpu_torch.models import transformer as port
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
SEQ = 32


def _configs(jdtype, tdtype):
    shape = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
                 mlp_ratio=4, max_seq_len=SEQ)
    return (ref.TransformerConfig(dtype=jdtype, **shape),
            port.TransformerConfig(dtype=tdtype, **shape))


JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _flax(jdtype, seed):
    """(flax model, flax params, tokens as numpy)."""
    jcfg, _ = _configs(JDTYPES[jdtype], None)
    tokens = np.random.RandomState(seed).randint(0, 256, (2, SEQ))
    fmodel = ref.TransformerLM(jcfg)
    params = fmodel.init(jax.random.key(seed),
                         jnp.asarray(tokens, jnp.int32))["params"]
    return fmodel, params, tokens


def _init_ref(jdtype, seed):
    """A worker's job: the flax model's initial weights, on the host."""
    return jax.device_get(_flax(jdtype, seed)[1])


def _pair(jdtype="float32", tdtype=torch.float32, seed=0):
    """(flax params on the host, torch model with the same weights,
    tokens as numpy)."""
    _, tcfg = _configs(JDTYPES[jdtype], tdtype)
    tokens = np.random.RandomState(seed).randint(0, 256, (2, SEQ))
    params = torch_refpool.result((__name__, "init", jdtype, seed))
    tmodel = port.TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return params, tmodel, tokens


def _logits_ref():
    """A worker's job: the fp32 reference's logits and loss, seed 0."""
    fmodel, params, tokens = _flax("float32", 0)
    jt = jnp.asarray(tokens, jnp.int32)
    logits_ref = fmodel.apply({"params": params}, jt)
    return np.asarray(logits_ref), float(ref.lm_loss(logits_ref, jt))


def _chunked_ref(chunk):
    """A worker's job: the reference's chunked loss and its gradients,
    seed 1, from one compilation of the whole reference (op-by-op
    dispatch compiles each of its primitives on first use)."""
    fmodel, params, tokens = _flax("float32", 1)
    jt = jnp.asarray(tokens, jnp.int32)

    def loss_fn(p):
        hidden = fmodel.apply({"params": p}, jt, return_hidden=True)
        return ref.lm_loss_from_hidden(hidden, p["lm_head"]["kernel"], jt,
                                       chunk=chunk)

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss_ref), jax.device_get(grads_ref)


def _bf16_ref():
    """A worker's job: the bf16 reference's logits, seed 2."""
    fmodel, params, tokens = _flax("bfloat16", 2)
    return np.asarray(fmodel.apply({"params": params},
                                   jnp.asarray(tokens, jnp.int32)))


def _rope_ref():
    """A worker's job: the reference's rope and dense attention on
    ``test_apply_rope_and_dense_attention_match_reference``'s inputs."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(24) + 5, (2, 24)).astype(np.int32)
    q, k, v = (rng.randn(2, 24, 3, 16).astype(np.float32) for _ in range(3))
    return (np.asarray(ref.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
            [np.asarray(ref.causal_attention(*map(jnp.asarray, (q, k, v)),
                                             causal))
             for causal in (True, False)])


CHUNKS = [31, 8, 10]


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    return ([((__name__, "init", t, seed), _init_ref, (t, seed))
             for t, seed in (("float32", 0), ("float32", 1),
                             ("bfloat16", 2))]
            + [((__name__, "logits"), _logits_ref, ())]
            + [((__name__, "chunked", c), _chunked_ref, (c,))
               for c in CHUNKS]
            + [((__name__, "bf16"), _bf16_ref, ()),
               ((__name__, "rope"), _rope_ref, ())])


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_params_from_flax_covers_every_parameter():
    params, tmodel, _ = _pair()
    state = params_from_flax(params)
    assert set(state) == set(tmodel.state_dict())
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tmodel.parameters())


def test_logits_and_lm_loss_match_reference():
    _, tmodel, tokens = _pair()
    logits_ref, loss_ref = torch_refpool.result((__name__, "logits"))
    logits = tmodel(torch.tensor(tokens))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), atol=FWD_TOL)
    np.testing.assert_allclose(
        port.lm_loss(logits, torch.tensor(tokens)).item(),
        loss_ref, atol=FWD_TOL)


@pytest.mark.parametrize("chunk", CHUNKS, ids=["one_chunk",
                                            "divides", "ragged"])
def test_chunked_loss_and_gradients_match_reference(chunk):
    # S - 1 = 31 positions are predicted: chunk 10 leaves a ragged tail.
    _, tmodel, tokens = _pair(seed=1)
    loss_ref, grads_ref = torch_refpool.result((__name__, "chunked", chunk))
    tt = torch.tensor(tokens)
    hidden = tmodel(tt, return_hidden=True)
    loss = port.lm_loss_from_hidden(hidden, tmodel.lm_head.weight.t(), tt,
                                    chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_ref, atol=FWD_TOL)
    np.testing.assert_allclose(
        loss.item(), port.lm_loss(tmodel(tt), tt).item(), atol=FWD_TOL)
    grads = params_from_flax(grads_ref)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   atol=GRAD_TOL, err_msg=name)


def test_bf16_model_matches_reference_within_bf16_rounding():
    # bf16 keeps 8 significant bits: each of the ~10 rounded stages per
    # layer may differ by one step (2^-8 relative) between XLA and torch.
    # Bound: logits within 2.5% of their largest magnitude (0.7-0.8% seen
    # on seeds 2-4), loss within 1e-2 of the reference's.
    _, tmodel, tokens = _pair("bfloat16", torch.bfloat16, seed=2)
    jt = jnp.asarray(tokens, jnp.int32)
    logits_ref = torch_refpool.result((__name__, "bf16"))
    logits = tmodel(torch.tensor(tokens)).detach().numpy()
    assert np.all(np.isfinite(logits))
    err = np.abs(logits - logits_ref).max()
    assert err <= 0.025 * np.abs(logits_ref).max(), err
    loss_ref = float(ref.lm_loss(jnp.asarray(logits_ref), jt))
    loss = port.lm_loss(torch.tensor(logits), torch.tensor(tokens)).item()
    assert abs(loss - loss_ref) <= 1e-2


def test_apply_rope_and_dense_attention_match_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(24) + 5, (2, 24)).astype(np.int32)
    rope_ref, attention_ref = torch_refpool.result((__name__, "rope"))
    np.testing.assert_allclose(
        port.apply_rope(torch.tensor(x), torch.tensor(pos)).numpy(),
        rope_ref, atol=FWD_TOL)
    q, k, v = (rng.randn(2, 24, 3, 16).astype(np.float32) for _ in range(3))
    for causal, theirs in zip((True, False), attention_ref):
        np.testing.assert_allclose(
            port.causal_attention(*map(torch.tensor, (q, k, v)),
                                  causal).numpy(), theirs, atol=FWD_TOL)


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _configs(jnp.float32, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TransformerLM(tcfg)
