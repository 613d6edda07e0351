"""The port's Transformer LM (horovod_tpu_torch.models.transformer) against
the flax reference, on the CPU, with one set of weights.

Shapes are those of ``__graft_entry__._tiny_config`` (vocab 256, 2 layers,
4 heads of 16, MLP x4, 32 positions). In fp32 the tolerances are the
reference's own: 2e-5 on forward values, 1e-4 on gradients. The bf16 case
rounds activations at every layer, in another order in XLA and in torch,
so it is held to a looser bound stated beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as ref
from horovod_tpu_torch.models import params_from_flax
from horovod_tpu_torch.models import transformer as port
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
SEQ = 32


def _configs(jdtype, tdtype):
    shape = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
                 mlp_ratio=4, max_seq_len=SEQ)
    return (ref.TransformerConfig(dtype=jdtype, **shape),
            port.TransformerConfig(dtype=tdtype, **shape))


def _pair(jdtype=jnp.float32, tdtype=torch.float32, seed=0):
    """(flax model, flax params, torch model with the same weights,
    tokens as numpy)."""
    jcfg, tcfg = _configs(jdtype, tdtype)
    tokens = np.random.RandomState(seed).randint(0, 256, (2, SEQ))
    fmodel = ref.TransformerLM(jcfg)
    params = fmodel.init(jax.random.key(seed),
                         jnp.asarray(tokens, jnp.int32))["params"]
    tmodel = port.TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.device_get(params)))
    return fmodel, params, tmodel, tokens


def test_params_from_flax_covers_every_parameter():
    _, params, tmodel, _ = _pair()
    state = params_from_flax(jax.device_get(params))
    assert set(state) == set(tmodel.state_dict())
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tmodel.parameters())


def test_logits_and_lm_loss_match_reference():
    fmodel, params, tmodel, tokens = _pair()
    jt = jnp.asarray(tokens, jnp.int32)
    logits_ref = fmodel.apply({"params": params}, jt)
    logits = tmodel(torch.tensor(tokens))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), atol=FWD_TOL)
    np.testing.assert_allclose(
        port.lm_loss(logits, torch.tensor(tokens)).item(),
        float(ref.lm_loss(logits_ref, jt)), atol=FWD_TOL)


@pytest.mark.parametrize("chunk", [31, 8, 10], ids=["one_chunk",
                                                    "divides", "ragged"])
def test_chunked_loss_and_gradients_match_reference(chunk):
    # S - 1 = 31 positions are predicted: chunk 10 leaves a ragged tail.
    fmodel, params, tmodel, tokens = _pair(seed=1)
    jt = jnp.asarray(tokens, jnp.int32)

    def loss_fn(p):
        hidden = fmodel.apply({"params": p}, jt, return_hidden=True)
        return ref.lm_loss_from_hidden(hidden, p["lm_head"]["kernel"], jt,
                                       chunk=chunk)

    # One compilation of the whole reference, where op-by-op dispatch
    # compiles each of its primitives on first use.
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(params)
    tt = torch.tensor(tokens)
    hidden = tmodel(tt, return_hidden=True)
    loss = port.lm_loss_from_hidden(hidden, tmodel.lm_head.weight.t(), tt,
                                    chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=FWD_TOL)
    np.testing.assert_allclose(
        loss.item(), port.lm_loss(tmodel(tt), tt).item(), atol=FWD_TOL)
    grads = params_from_flax(jax.device_get(grads_ref))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   atol=GRAD_TOL, err_msg=name)


def test_bf16_model_matches_reference_within_bf16_rounding():
    # bf16 keeps 8 significant bits: each of the ~10 rounded stages per
    # layer may differ by one step (2^-8 relative) between XLA and torch.
    # Bound: logits within 2.5% of their largest magnitude (0.7-0.8% seen
    # on seeds 2-4), loss within 1e-2 of the reference's.
    fmodel, params, tmodel, tokens = _pair(jnp.bfloat16, torch.bfloat16,
                                           seed=2)
    jt = jnp.asarray(tokens, jnp.int32)
    logits_ref = np.asarray(fmodel.apply({"params": params}, jt))
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
    np.testing.assert_allclose(
        port.apply_rope(torch.tensor(x), torch.tensor(pos)).numpy(),
        np.asarray(ref.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=FWD_TOL)
    q, k, v = (rng.randn(2, 24, 3, 16).astype(np.float32) for _ in range(3))
    for causal in (True, False):
        np.testing.assert_allclose(
            port.causal_attention(*map(torch.tensor, (q, k, v)),
                                  causal).numpy(),
            np.asarray(ref.causal_attention(*map(jnp.asarray, (q, k, v)),
                                            causal)), atol=FWD_TOL)


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _configs(jnp.float32, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TransformerLM(tcfg)
