"""Synthetic training bench of the port, on the card.

Counterpart of the root ``bench.py``: the same two legs in one JSON line,
with the framework in the measured loop the way a user runs it
(``hvd.init``, ``DistributedOptimizer`` around SGD with momentum,
``broadcast_parameters`` at start, one process per card)::

    python -m horovod_tpu_torch.bench

1. **ResNet-50** (``bench.py:182-344``): batch ``HVD_BENCH_BATCH`` (256)
   per card of 224x224 images drawn from a seeded normal in bf16, labels
   0, cross-replica BatchNorm over the ``data`` axis, SGD lr 0.01
   momentum 0.9, mean softmax cross-entropy. ``value`` is images/s per
   card and ``vs_baseline`` divides it by 103.55, the reference's
   published per-device readout. ``mfu`` counts 3 x 2 x 4.089e9 model
   FLOPs per image (4.089 G multiply-adds per forward image, 2 FLOPs
   each, the backward twice the forward) against the card's bf16 dense
   peak.
2. **Transformer LM** (``bench.py:85-179``): vocab 32000, 12 layers, 16
   heads of 128, S = ``HVD_BENCH_LM_SEQ`` (2048), batch
   ``HVD_BENCH_LM_BATCH`` (4) per card, bf16 compute over fp32 weights,
   the flash kernels, the chunked loss; model FLOPs per token
   6 x matmul parameters + 12 x L x S x d (the reference's convention).

``hfu`` and ``flops_ratio_executed_vs_model`` come from
``torch.utils.flop_counter.FlopCounterMode`` over one untimed step: it
counts the matrix products and convolutions that run through PyTorch
(forward, backward and the loss's recompute), not elementwise work. It
cannot see inside the flash kernels, so the Transformer leg adds their
operations (2 x D per visible (q, k) pair and product: two products
forward, three for dq, four for dk/dv). Where the counter finds nothing
the fields are left out and ``cost_analysis_unavailable`` says why. The
reference's bytes-based roofline fields (``bench.py:325-344``) come from
XLA's cost analysis of the compiled step; eager PyTorch has no count of
the bytes a step moves, so they are left out.

Peaks come from a table keyed by the card's name (public spec sheets); a
card not in it raises. Times are host-clock medians of chunks of steps
that end in a ``.item()`` (``utils.timing``). The steps are made by plain
functions, so that ``chip_smoke.py`` drives the program this bench times.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models import (
    ResNet50, TransformerConfig, TransformerLM, lm_loss_from_hidden,
)
from horovod_tpu_torch.utils.timing import steady_state_sec_per_step

BASELINE_IMG_PER_SEC_PER_DEVICE = 103.55
RESNET50_MACS_PER_IMAGE = 4.089e9

# Dense bf16 FLOP/s and memory bytes/s of one card, by
# torch.cuda.get_device_name(), from the vendor's spec sheets.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),   # H100 SXM
}


def card_peaks(name: str) -> Tuple[float, float]:
    """(bf16 dense FLOP/s, memory bytes/s) of the card called ``name``."""
    if name not in PEAKS:
        raise ValueError(f"no peak rates known for the card {name!r}; "
                         f"known cards: {sorted(PEAKS)}")
    return PEAKS[name]


def classifier_step(model: torch.nn.Module, batch: int,
                    image_size: int = 224,
                    seed: int = 0) -> Callable[[], torch.Tensor]:
    """One training step of the image classifier ``model`` (ResNet, ViT)
    per call on a fixed batch: images
    [batch, image_size, image_size, 3] of a normal drawn in the model's
    dtype from ``seed``, labels 0, SGD lr 0.01 momentum 0.9 behind
    ``DistributedOptimizer``, parameters broadcast from rank 0. Needs
    ``hvd.init()``. The step returns the loss, detached. cuDNN picks each
    convolution's algorithm by timing it on first use, as fixed-shape
    training does."""
    device = next(model.parameters()).device
    torch.backends.cudnn.benchmark = True
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn(batch, image_size, image_size, 3, generator=g,
                         device=device, dtype=model.dtype)
    labels = torch.zeros(batch, dtype=torch.long, device=device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        axis="data")
    hvd.broadcast_parameters(model, root_rank=0)
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def transformer_step(cfg: TransformerConfig, batch: int, seed: int = 0,
                     device=None):
    """(step, model): one training step of a ``TransformerLM(cfg)`` with
    weights from ``seed`` per call, on a fixed batch of ``batch`` rows of
    random tokens per rank (this rank's slice of one draw for the whole
    world), the chunked loss, SGD lr 0.01 momentum 0.9 behind
    ``DistributedOptimizer``, parameters broadcast from rank 0. Needs
    ``hvd.init()``. The step returns the loss, detached."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    model = TransformerLM(cfg, device=device, generator=g)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        axis="data")
    hvd.broadcast_parameters(model, root_rank=0)
    tokens = torch.randint(0, cfg.vocab_size,
                           (batch * hvd.size(), cfg.max_seq_len),
                           generator=g, device=device)
    tokens = tokens[hvd.rank() * batch:(hvd.rank() + 1) * batch]

    def step():
        opt.zero_grad(set_to_none=True)
        hidden = model(tokens, return_hidden=True)
        loss = lm_loss_from_hidden(hidden, model.lm_head.weight.t(), tokens)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, model


def counted_flops(step: Callable[[], torch.Tensor]) -> float:
    """FLOPs of the matrix products and convolutions of one ``step()``,
    as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        step()
    return float(counter.get_total_flops())


def flash_flops(cfg: TransformerConfig, batch: int) -> float:
    """Operations of one training step's flash kernels, which
    ``FlopCounterMode`` cannot see: per layer, 2 x D per visible (q, k)
    pair (S^2 / 2, causal) for each of the 2 + 3 + 4 products of the
    forward, dq and dk/dv kernels."""
    s = cfg.max_seq_len
    pairs = batch * cfg.num_heads * s * s // 2
    return cfg.num_layers * (4 + 6 + 8) * pairs * cfg.head_dim


def _executed(result: Dict, hw_flops: float, model_flops: float, sec: float,
              peak: float) -> None:
    if hw_flops > 0:
        result["hfu"] = round(hw_flops / sec / peak, 4)
        result["flops_ratio_executed_vs_model"] = round(
            hw_flops / model_flops, 3)
    else:
        result["cost_analysis_unavailable"] = (
            "FlopCounterMode counted no operations in the step")


def bench_resnet(peak: float) -> Dict:
    batch = int(os.environ.get("HVD_BENCH_BATCH", "256"))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     axis_name="data")
    step = classifier_step(model, batch)
    torch.cuda.reset_peak_memory_stats()
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=5, chunks=5, chunk_steps=25)
    memory = torch.cuda.max_memory_allocated()
    hw_flops = counted_flops(step)
    model_flops = 3 * 2 * RESNET50_MACS_PER_IMAGE * batch
    per_card = batch / sec
    result = {
        "metric": "resnet50_hvd_train_images_per_sec_per_chip",
        "value": round(per_card, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(per_card / BASELINE_IMG_PER_SEC_PER_DEVICE, 3),
        "mfu": round(model_flops / sec / peak, 4),
        "framework_in_loop": True,
        "n_devices": hvd.size(),
        "sec_per_step": round(sec, 4),
        "max_memory_allocated_GiB": round(memory / 2**30, 2),
    }
    _executed(result, hw_flops, model_flops, sec, peak)
    return result


def bench_transformer(peak: float) -> Dict:
    batch = int(os.environ.get("HVD_BENCH_LM_BATCH", "4"))
    seq = int(os.environ.get("HVD_BENCH_LM_SEQ", "2048"))
    cfg = TransformerConfig(vocab_size=32000, num_layers=12, num_heads=16,
                            head_dim=128, max_seq_len=seq,
                            dtype=torch.bfloat16)
    step, model = transformer_step(cfg, batch)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=5, chunks=4, chunk_steps=15)
    memory = torch.cuda.max_memory_allocated()
    hw_flops = counted_flops(step) + flash_flops(cfg, batch)
    d = cfg.embed_dim
    # Matrix parameters: all but the embedding table (a gather).
    p_mm = n_params - cfg.vocab_size * d
    model_flops = batch * seq * (6 * p_mm + 12 * cfg.num_layers * seq * d)
    result = {
        "config": f"L{cfg.num_layers} d{d} S{seq} B{batch} "
                  f"V{cfg.vocab_size}",
        "n_params_M": round(n_params / 1e6, 1),
        "tokens_per_sec": round(batch * seq / sec),
        "sec_per_step": round(sec, 4),
        "mfu": round(model_flops / sec / peak, 4),
        "max_memory_allocated_GiB": round(memory / 2**30, 2),
    }
    _executed(result, hw_flops, model_flops, sec, peak)
    return result


def main() -> None:
    hvd.init()
    name = torch.cuda.get_device_name()
    peak, _ = card_peaks(name)
    result = bench_resnet(peak)
    torch.cuda.empty_cache()
    lm = bench_transformer(peak)
    result["transformer_hvd_train_mfu"] = lm["mfu"]
    result["transformer"] = lm
    result["device"] = name
    if hvd.rank() == 0:
        print(json.dumps(result))
    hvd.shutdown()


if __name__ == "__main__":
    main()
