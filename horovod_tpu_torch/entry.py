"""Entry point of the port: the flagship model's forward step.

Counterpart of ``__graft_entry__.entry`` (:24-47). ``entry()`` returns
``(fn, example_args)``: ``fn(params, tokens)`` is the forward of a tiny
``TransformerLM`` (vocab 256, 2 layers, 4 heads of 16, MLP x4, 32
positions, bf16 compute) as a function of its parameters, the form the
reference's ``model.apply`` has, and ``example_args`` holds the model's
own parameters and a [2, 32] batch of zero tokens::

    from horovod_tpu_torch.entry import entry
    fn, args = entry()              # CUDA unless device="cpu"
    logits = fn(*args)              # [2, 32, 256] fp32

On the card, head dim 16 runs the forward on the sm90 kernel (narrow
rows); a backward through it takes the sm90 dq and dk/dv (narrow rows
too).

The reference's ``dryrun_multichip`` and ``run_multichip`` drive the
Trainer over a data x seq x model mesh with ring attention, tensor
parallelism and mixture-of-experts layers; the port has none of these
yet (ROADMAP A8), so they are not here.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models import TransformerConfig, TransformerLM


def tiny_config() -> TransformerConfig:
    return TransformerConfig(vocab_size=256, num_layers=2, num_heads=4,
                             head_dim=16, mlp_ratio=4, max_seq_len=32,
                             dtype=torch.bfloat16)


def entry(device=None):
    """-> (fn, example_args): the flagship model's forward as a function
    of its parameters, with example arguments on ``device``."""
    device = resolve_device(device)
    model = TransformerLM(tiny_config(), device=device)
    params = {name: p.detach() for name, p in model.named_parameters()}
    tokens = torch.zeros((2, 32), dtype=torch.long, device=device)

    def fn(params, tokens):
        return torch.func.functional_call(model, params, (tokens,))

    return fn, (params, tokens)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
