"""Cycles per eager step at size 1, the port against the JAX package, on
the CPU.

Both packages' hook-driven ``DistributedOptimizer`` train the same tiny
TransformerLM on the same batches, each through its own negotiated
runtime at the response cache's defaults; the script prints, per step,
each runtime's cycles, its cached cycles so far and its cache hits so
far. It shows how the reference's cache behaves under a burst of
gradient hooks, which the port's is held to:

    JAX_PLATFORMS=cpu python tests/torch_cache_cycles.py [--steps 6]
"""

import argparse
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LM = dict(vocab_size=64, num_layers=6, num_heads=2, head_dim=8,
          mlp_ratio=2, max_seq_len=16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    import horovod_tpu as ref_hvd
    import horovod_tpu.torch as ref_torch
    from horovod_tpu.common import basics as ref_basics
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.torch import eager
    hvd.init(device="cpu")
    ref_hvd.init()
    try:
        mine = T.TransformerLM(T.TransformerConfig(dtype=torch.float32,
                                                   **LM), device="cpu",
                               generator=torch.Generator().manual_seed(3))
        theirs = copy.deepcopy(mine)
        runs = [(eager.DistributedOptimizer, mine, basics.runtime(),
                 lambda rt: rt.stats["cycles"]),
                (ref_torch.DistributedOptimizer, theirs,
                 ref_basics.runtime(), lambda rt: rt._cycle_count)]
        runs = [(wrap(torch.optim.SGD(m.parameters(), lr=0.1,
                                      momentum=0.9),
                      named_parameters=m.named_parameters()), m, rt, count)
                for wrap, m, rt, count in runs]
        print(f"{len(list(mine.parameters()))} gradients per step; per "
              f"step: cycles, cached cycles so far, cache hits so far")
        rng = np.random.RandomState(5)
        for i in range(args.steps):
            tokens = torch.tensor(rng.randint(0, LM["vocab_size"],
                                              (2, LM["max_seq_len"])))
            row = []
            for opt, model, rt, count in runs:
                c0 = count(rt)
                opt.zero_grad()
                hidden = model(tokens, return_hidden=True)
                T.lm_loss_from_hidden(hidden, model.lm_head.weight.t(),
                                      tokens, chunk=8).backward()
                opt.step()
                st = rt.negotiation_cache_stats()
                row.append(f"{count(rt) - c0:4d} {st['cached_cycles']:5d} "
                           f"{st['hits']:5d}")
            print(f"step {i + 1}: port {row[0]} | reference {row[1]}")
    finally:
        hvd.shutdown()
        ref_hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
