"""Which collectives gloo takes on CUDA tensors, and its allreduce rate.

The process-group plane (``ops/process_group_ops.py``) renders with gloo
when two ranks share one card, which NCCL refuses. This starts two ranks
on card 0 over a gloo group and runs every collective the plane issues
on CUDA tensors (all_reduce in each dtype it takes, the gather and
scatter forms, all_to_all_single, broadcast, barrier, and an all_reduce
on a side stream), checking each result against its closed form, then
times a 256 MiB fp32 all_reduce (the mean of 3, copies between the card
and the host included). Run from the root of a checkout, on the card:

    python3 horovod_tpu_torch/tools/gloo_cuda_probe.py
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
import warnings

N_BIG = 1 << 26   # fp32 elements of the timed all_reduce (256 MiB)


def _probe(rank, port, out):
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    g = dist.new_group([0, 1], backend="gloo")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lines = []

    def check(name, fn, want):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                got = fn()
                torch.cuda.synchronize()
                ok = got == want
                verdict = "ok" if ok else f"WRONG {got} != {want}"
            except Exception as e:  # noqa: BLE001 -- the probe's result
                ok, verdict = False, f"FAIL {type(e).__name__}: {e}"
        warned = [str(w.message)[:60] for w in caught]
        lines.append(f"{name}: {verdict}"
                     + (f" (warnings: {warned})" if warned else ""))
        return ok

    def reduced(dtype):
        x = torch.full((5,), rank + 1, dtype=dtype, device=dev)
        dist.all_reduce(x, group=g)
        return x.tolist()

    ok = True
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64, torch.int32, torch.int64, torch.uint8,
                  torch.int8):
        ok &= check(f"all_reduce {dtype}", lambda: reduced(dtype), [3] * 5)

    def gathered():
        y = torch.empty(6, device=dev)
        dist.all_gather_into_tensor(
            y, torch.full((3,), rank + 1.0, device=dev), group=g)
        return y.tolist()
    ok &= check("all_gather_into_tensor", gathered, [1.0] * 3 + [2.0] * 3)

    def scattered():
        y = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(
            y, torch.arange(4.0, device=dev) * (rank + 1), group=g)
        return y.tolist()
    ok &= check("reduce_scatter_tensor", scattered,
                [[0.0, 3.0], [6.0, 9.0]][rank])

    def exchanged():
        y = torch.empty(4, device=dev)
        dist.all_to_all_single(y, torch.arange(4.0, device=dev) + 100 * rank,
                               group=g)
        return y.tolist()
    ok &= check("all_to_all_single", exchanged,
                [[0.0, 1.0, 100.0, 101.0], [2.0, 3.0, 102.0, 103.0]][rank])

    def broadcast():
        x = torch.full((3,), rank * 10.0, device=dev, dtype=torch.float64)
        dist.broadcast(x, src=1, group=g)
        return x.tolist()
    ok &= check("broadcast", broadcast, [10.0] * 3)
    ok &= check("barrier", lambda: dist.barrier(group=g), None)

    def side_stream():
        s = torch.cuda.Stream()
        x = torch.full((1 << 20,), rank + 1.0, device=dev)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            dist.all_reduce(x, group=g)
        torch.cuda.current_stream().wait_stream(s)
        return x[:2].tolist()
    ok &= check("all_reduce on a side stream", side_stream, [3.0, 3.0])

    x = torch.ones(N_BIG, device=dev)
    dist.all_reduce(x, group=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(x, group=g)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / 3
    lines.append(f"all_reduce fp32 {N_BIG * 4 / 2**20:.0f} MiB: {sec:.3f} s "
                 f"({N_BIG * 4 / sec / 1e9:.2f} GB/s)")
    with open(os.path.join(out, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    dist.destroy_process_group()
    if not ok:
        sys.exit(1)


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_probe, args=(port, out), nprocs=2, join=True)
        for r in range(2):
            print(f"rank {r}:")
            with open(os.path.join(out, f"rank{r}.txt")) as f:
                print(f.read(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
