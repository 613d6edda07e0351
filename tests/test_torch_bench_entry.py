"""The port's bench step functions and entry point, on the CPU.

- ``entry(device="cpu")`` with the reference entry's weights carried over
  gives the reference's logits within bf16 rounding (the bound of the
  Transformer LM's bf16 parity test: 2.5% of the largest magnitude).
- The bench's ResNet and Transformer step functions train at world size 1
  over gloo (the cross-replica BatchNorm's allreduce runs): the loss is
  finite and falls on the fixed batch, and ``counted_flops`` counts the
  step's matrix products and convolutions.
- The peak table knows the H100 SXM and refuses a card it does not know.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
import horovod_tpu_torch as hvd
from horovod_tpu_torch import bench
from horovod_tpu_torch.entry import entry
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.models.resnet import BasicBlock, ResNet


@pytest.fixture
def cpu_world():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_entry_matches_reference_entry():
    ref_fn, (ref_params, ref_tokens) = ref_entry.entry()
    want = np.asarray(jax.jit(ref_fn)(ref_params, ref_tokens))
    fn, (params, tokens) = entry(device="cpu")
    carried = params_from_flax(jax.device_get(ref_params))
    assert set(carried) == set(params)
    with torch.no_grad():
        got = fn(carried, tokens)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 0.025 * np.abs(want).max(), err
    # The example arguments run too: the model's own weights.
    assert torch.isfinite(fn(*(params, tokens))).all()


def _falls(step, n=3):
    losses = [step().item() for _ in range(n)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    return losses


def test_classifier_step_trains_a_resnet_with_cross_replica_batchnorm(
        cpu_world):
    model = ResNet(stage_sizes=[1, 1], block_cls=BasicBlock, num_filters=4,
                   num_classes=10, dtype=torch.float32, axis_name="data",
                   device="cpu")
    step = bench.classifier_step(model, batch=4, image_size=32)
    _falls(step)
    # stem 7x7x3x4 at 16x16, 3x3 convs at 8x8 and 4x4, the projection,
    # the head; forward, input gradients (not the stem's) and weight
    # gradients.
    macs = (16 * 16 * 49 * 3 * 4 + 2 * 8 * 8 * 9 * 4 * 4
            + 4 * 4 * 9 * 4 * 8 + 4 * 4 * 9 * 8 * 8 + 4 * 4 * 4 * 8
            + 8 * 10)
    stem = 16 * 16 * 49 * 3 * 4
    assert bench.counted_flops(step) == 2 * 4 * (3 * macs - stem)


def test_transformer_step_trains(cpu_world):
    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=4,
                            head_dim=16, max_seq_len=32,
                            dtype=torch.float32)
    step, model = bench.transformer_step(cfg, batch=2, device="cpu")
    _falls(step)
    assert bench.counted_flops(step) > 0
    assert bench.flash_flops(cfg, 2) == 2 * 18 * (2 * 4 * 32 * 32 // 2) * 16


def test_peaks_know_the_h100_and_refuse_other_cards():
    assert bench.card_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        bench.card_peaks("NVIDIA A100-SXM4-80GB")
