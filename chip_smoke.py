"""Smoke test of the PyTorch port (horovod_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc for sm_90a):

    python3 chip_smoke.py [--seed 0] [--layers 12] [--warmup 2] [--steps 5]

Phases (any failure ends the run with a nonzero exit and no result line):

1. Card and build: prints the card's name and power limit, builds the
   flash-attention kernels from horovod_tpu_torch/csrc with nvcc and
   prints the build time.
2. Kernels against their plain PyTorch versions, on the card. Each
   kernel takes the design ``flash_attention._design`` gives it: the
   tensor-core kernels (sm90: bf16 and fp16, the forward at head dims
   1-512, on the caller's tensors at every multiple of 8 past 32, dq and
   dk/dv at 1-256, D 16 and 32 on the narrow-row builds; the stream
   design, bf16 and fp16, the forward past D 512 and dq and dk/dv past
   D 256; tf32, every fp32 head dim through 3xTF32 for all three
   kernels, on their narrow builds at D 16 and 32 up to D 32; stream and
   the wider tf32 builds streamed over D); the fp32-FMA (simt) kernels,
   which no route runs any more (built past D 512 in 64-column chunks of
   the head dim), are forced beside them: a bf16 case at the main shape
   and every case where a tensor-core kernel serves.
   Cases: the main path's shape (B=4, S=2048, H=16, D=128, bf16,
   causal), a non-causal, two offset, a D=64
   and a short ragged case, fp32 at two shapes (the main one with the
   simt kernels beside the tf32 ones) and at three with unequal lengths
   and offsets (D 128, 320 and 640), each case of C4_CASES at B=2,
   S=1024, H=8, causal, through the dispatchers (bf16, fp16 and fp32 at
   D 16 and 32; fp16 at D 64/128/256/512/640; bf16 at D 80, 96 and
   200, all three sm90 kernels on the caller's tensors at the next built
   head dim, and 256; fp32 at D 256; bf16 and fp32 at D 320, 384, 512 and
   640), the Gemma-7B geometry (B=2, S=2048, H=16, D=256,
   bf16, causal), the entry's shape (B=2, S=32, H=4, D=16, bf16, causal),
   and ROADMAP C6's ragged lengths on every design
   (RAGGED_DESIGNS: B=2, H=2, Sq = Sk = 100 and Sq 100 / Sk 127, causal,
   with offsets); wherever a tensor-core kernel serves, its simt kernel
   is checked on the same inputs too. Wherever the fused 16-bit backward
   serves (bf16 and fp16 at D 33-128: the main shape, d64, the C4 cases
   at D 64-128, the ragged bf16 D 128 lengths), it runs on the same
   inputs, lse and delta as the sm90 dq and dk/dv (which no route runs
   there any more): its dq held to the plain dq at DQ_ATOL with the
   16-bit operands' allowance of ``_flash_bwd_sm90_plain`` (dq summed per
   128-key kv tile), its dk and dv bit for bit the sm90 dk/dv's, and at
   the main shape a plain dq with one 128-key kv tile (keys 1024-1151,
   one add of the fused kernel) left out must fail the bound. In every
   case the backward's pre-pass kernel (lse and delta from the forward's
   o, m, l and do) is held to its plain version: lse within 1e-6 of |m|
   + |log l| (+inf on dead rows, equal), delta within 1e-5 of the sum of
   |do o|.
   Each element is held to the bound of
   horovod_tpu_torch/utils/tolerance.py: |mine - plain| <= atol + rtol *
   max|plain row| + step * |plain| (+ 2 * max over the row of |plain_b -
   plain| for the sm90 kernels), a row being the last axis (D for o and
   the gradients; m and l are held element by element). atol is 1e-6,
   and 1e-5 for the sm90 dq, whose row of a query that sees one key is
   pure rounding noise (utils/tolerance.py says why). Both versions
   compute in fp32 from the same inputs, in another summation order:
   rtol 2e-5 (o, m, l) or 1e-4 (gradients). bf16 outputs are rounded to
   bf16 by both, step = 2^-7; fp16 outputs step = 2^-10; fp32 outputs
   have step 0. The 16-bit tensor-core kernels also feed p (and ds) to
   the tensor cores in the input's 16-bit type; plain_b is the plain
   version that rounds there too (``operands``), and twice its effect in
   the row is allowed. The tf32 kernels have no such allowance: the
   forward is held to the fp32 bound as it stands, dq (atol 1e-5, as the
   sm90 dq) and dk/dv to the plain versions that take their products as
   three tf32 products (``operands=TF32X3``). The tf32 forward runs its
   128-column build up to D 128 and its wide build (256-column parts, P
   through shared memory) past it, so every fp32 C4 case past 128 (D 256,
   320, 384, 512, 640), fp32 D 640 with unequal lengths and offsets and
   RAGGED_DESIGNS' fp32 D 640 hold the wide build to the fp32 bound. The
   tf32 dk/dv likewise runs its 64-column build up to D 128 and its wide
   build (128-column parts, P^T and dS^T through shared memory) past it,
   and the tf32 dq its 128-column build up to D 128 and its wide build
   (256-column parts, dS through shared memory) past it: the same fp32
   cases past 128, and fp32 D 320 and 640 with unequal lengths and
   offsets, hold them to the TF32X3 plain versions (dq at DQ_ATOL).
   The bound must show its power: at the main shape a plain result with
   one kv tile (keys 1024-1151 of the forward, keys 1024-1087 of dq) or
   one q tile (queries 1536-1599 of dk and dv) left out must fail it; at
   the Gemma-7B geometry the same with the D 256 forward's 64-key tile
   (keys 1024-1087) and the D 256 dq's 32-key stage (keys 1024-1055); and
   at bf16 D 512 (C4 shape) with one 32-key stage of the D 512 forward
   (keys 512-543); at bf16 D 640 with one 64-key stage of the stream
   forward and dq (keys 512-575) and with one 64-column region of the
   head dim left out of the logits of the forward and dq (q and k zeroed
   in columns 256-319), and with one 64-query tile (queries 512-575) and
   the same region left out of the stream dk/dv's dk and dv, each by more
   than 10 times the bound; at bf16 D 96 with columns 64-95 of q and k
   (the region that straddles d) left out of the in-place forward's
   logits and with the build's scale, 1/sqrt(128), in place of
   1/sqrt(96), and the same two for the in-place dq, dk and dv (columns
   64-95 left out of s), by more than 10 times too, and at bf16 D 200
   with columns 192-199 (the part of the D 256 build's last box below d)
   left out of the logits of the in-place dq and the wide dk/dv
   (``flash_dkv_sm90_wide``), by more than 10 times; at the fp32 main
   shape with one
   64-key stage of
   the tf32 forward and dq (keys 1024-1087) and one 64-query tile of the
   tf32 dk/dv (queries 1536-1599), and at fp32 D 640 with one 32-column
   region of the head dim left out of the logits of the forward, dq, dk
   and dv (columns 256-287) and with columns 384-511 of O left out of the
   forward's P V (the last two 64-column pieces of the wide build's
   second 256-column part) and with columns 448-511 of dk and dv left out
   (the second 64-column piece of the wide dk/dv's fourth 128-column
   part, the piece its producer issues last in each tile) and with
   columns 448-511 or 576-639 of dq left out (the last 64-column piece of
   the wide dq's second 256-column part, the piece its producer issues
   last in a tile, and a piece of its 128-column remainder), each of which
   must fail by more than 10 times the bound; at
   bf16 D 16 and 32 (C4 shape) with 64 keys of the narrow forward and dq
   (keys 512-575), the keys of one kv tile that the narrow forward's last
   consumer warpgroup takes (keys 704-767) and one 64-query tile of the
   narrow dk/dv (queries 512-575), by more than 10 times too; at fp32 D
   16 and 32 (C4 shape) with one 32-key stage of the narrow tf32 forward
   (keys 512-543) and the keys of one kv tile that its last consumer
   warpgroup takes (keys 736-767), one 64-key stage of the narrow tf32 dq
   (keys 512-575) and one that its last warpgroup takes (keys 704-767),
   and one 32-query stage of the narrow tf32 dk/dv (queries 512-543) and
   one that its last warpgroup takes in the first kv tile (queries
   736-767), by more than LOST_FP32_BY times; at
   the ragged length 100 with the
   ragged tile (keys 64-99) left out of the forward and dq.
3. A small model checked against the dense reference: a 2-layer fp32
   TransformerLM gives the same loss and gradients through the flash
   kernels as through dense attention (2e-5 and 1e-4).
4. The main path at full width: hvd.init(), the bench's TransformerLM
   (vocab 32000, 12 layers, 16 heads of 128, S=2048; fp32 weights, bf16
   compute) with random weights from --seed, DistributedOptimizer(SGD
   lr 0.01, momentum 0.9), broadcast_parameters, and training steps on
   one fixed batch of 4 x 2048 random tokens. The loss must be finite and
   fall, and the path must launch the sm90 forward, the backward's
   pre-pass and the fused backward once per layer per step, and no other
   flash kernel (the sm90 dq and dk/dv and the simt kernels never).
   One more step runs under torch.profiler and prints its device time by
   kernel.
4b. The same step at Gemma-7B's attention widths (16 heads of 256, d
   4096, MLP x4; google/gemma-7b config.json), vocab 32000, S=2048, batch
   2, bf16 compute with fp32 weights, its 28 layers cut to 2 to fit the
   run: the loss must be finite and fall, and each layer and step must
   launch the sm90 forward, dq and dk/dv and the backward's pre-pass once
   and no other flash kernel.
   Phases 4 and 4b print their seconds per step beside the recorded ones
   (RECORDED_STEP_S).
4e. The same step at Phi-3-mini's attention widths (32 heads of 96,
   hidden 3072; microsoft/Phi-3-mini-4k-instruct config.json), vocab
   32000, S 2048, batch 2, bf16, its 32 layers cut to 2: the loss finite
   and falling, and each layer and step launching the sm90 forward (on
   the caller's tensors at D 96), the backward's pre-pass and the fused
   backward (on the caller's tensors too, on the build of 128) once and no
   other flash kernel.
4c. Phase 4's model in fp32 (``TransformerConfig(dtype=torch.float32)``),
   depth cut to 2, batch 4, S 2048, 4 steps (1 warm-up, 2 timed, 1
   profiled): the loss must be finite and fall, the tf32 forward, dq and
   dk/dv and the backward's pre-pass must each launch once per layer per
   step (2 a step) and no other flash kernel; prints the seconds per step.
4d. The entry's flagship model (horovod_tpu_torch/entry.py: bf16, 4 heads
   of 16, S 32, batch 2, 2 layers): its forward through ``entry()``'s own
   function on the card against the same weights and tokens on the CPU
   (logits within 2.5% of their largest magnitude, ENTRY_LOGITS_TOL says
   why), for the entry's example tokens and for tokens from --seed, each
   call launching the sm90 forward twice and no other flash kernel; then
   4 training steps of the same configuration through the bench's step
   (as phase 4): the loss finite and falling, the sm90 forward, dq and
   dk/dv and the backward's pre-pass once per layer per step and no
   other.
5. The kernels' times, each a mean of 20 launches: the sm90 kernels at
   the main path's shape in bf16 (printed beside the times PERF.md
   recorded before dq took fp16 and D 256, RECORDED_MAIN_MS), the fp32
   kernels there (the tf32 forward, dq and dk/dv, each with its
   pre-pass, which is also timed apart (prepass_ms), and the simt ones;
   the tf32 forward's rows name its build, part_cols 128 or 256, or 16
   and 32 for the narrow builds at fp32 D 16 and 32, and
   print its factor against SDPA's forward; the tf32 dk/dv's rows name
   theirs, part_cols 64 or 128, and the tf32 dq's theirs, 128 or 256, or
   16 and 32 for the narrow builds),
   each C4 case at its phase-2
   shape and the
   Gemma-7B geometry through the dispatchers (padding copies included),
   and beside every tensor-core kernel the simt kernel it replaces on the
   same inputs, which it must beat
   (and the backward as flash_attention_bwd runs it: at bf16 D 260 and
   fp16 D 20, where it pads, padded once for both kernels against its
   two kernels padded apart; at bf16 D 80, 96 and 200, where it reads the
   caller's tensors, against the same builds on copies padded once to
   them, each kernel also apart; every pair bit-equal; the fp32 route,
   one pre-pass then the tf32 dq and dk/dv, against SDPA's backward alone
   with the pre-pass alone beside it (TF32_ROUTES: C4 D 16 and 32, where
   the narrow builds must beat the simt dq and dk/dv together, C4 D 256,
   320, 384, 512 and 640 on the wide builds, and the main shape); then
   the sm90 dq and dk/dv together, and the fused backward beside them
   where it serves (its bound: five products), against SDPA's backward
   alone; then the 16-bit backward route whole, flash_attention_bwd (the
   pre-pass, then the fused backward, or dq and dk/dv at Gemma-7B's D
   256), against SDPA's backward alone and against the route before the
   fused kernel (torch's lse and delta, then the sm90 dq and dk/dv) in
   turns, at the main shape, Phi-3-mini's, C4 bf16 D 80 and Gemma-7B's
   (BWD_ROUTES)); the fused backward's rows and the pre-pass's carry the
   same keys as the others (the pre-pass has no library call: null);
   each beside the plain version, the PyTorch library call computing the
   same function in the same dtype (scaled_dot_product_attention, timed
   here only as a yardstick) and the bound: the larger of the operations
   the function needs (2 x D per visible (q, k) pair and matrix product:
   two products forward, three for dq, four for dk/dv) over the card's
   dense peak for the input type (989 TFLOP/s bf16 and fp16, 67 TFLOP/s
   fp32; for the tf32 forward three such products over 494.7 TFLOP/s
   dense tf32, with the 67 TFLOP/s bound beside it as bound_fma_ms; so
   for the tf32 dq and dk/dv) and the bytes in and out over its memory
   rate (3.35 TB/s). At D 16 and 32 the simt kernels and the tensor-core
   ones that replace them (the sm90 kernels at 16 bits, the narrow tf32
   kernels at fp32) are printed beside SDPA; the entry's shape is timed
   too.
6. Small vision models, the card against the CPU: a narrow fp32 ResNet
   (bottleneck blocks, 8 filters) and a 2-layer ViT with the same
   weights on both (TF32 off) give the same logits, loss, parameter
   gradients and BatchNorm running statistics within 1e-4 + 1e-4 x |cpu|.
7. The bench's ResNet-50 leg at full width, through the bench's own
   step (horovod_tpu_torch.bench.classifier_step): batch 256 of 224x224
   bf16 images from --seed, labels 0, cross-replica BatchNorm over the
   data axis, SGD lr 0.01 momentum 0.9; --warmup and --steps steps, then
   one profiled step whose device time is grouped as convolutions,
   matrix products, nccl and other. Prints images/s, MFU (3 x 2 x
   4.089e9 model FLOPs per image over 989 TFLOP/s) and peak memory; the
   loss must be finite and fall, and no flash kernel may launch.
8. ViT-B/16 at 224x224, batch 64, bf16, through the same step and with
   the same checks.
9. The negotiated runtime at full width on one card: hvd.init() builds
   it with a LocalController. The main path's Transformer-LM (phase 4's
   configuration and seed) takes 5 steps with the in-step
   DistributedOptimizer, then 5 with the hook-driven
   ``torch.eager.DistributedOptimizer`` four times: with the response
   cache off (HOROVOD_CACHE_CAPACITY=0) and on (the default: 1024 slots,
   speculation on), each on a quiet host and under a controlled load (2
   Python processes spinning, pinned with os.sched_setaffinity to this
   process's CPUs, started and stopped here; one that dies is a
   failure). Each run's losses and every parameter after the last step
   must equal the in-step run's (at size 1 both averages are
   identities). Prints the seconds per step of each, a profiled step of
   the in-step and the quiet cache-on runs (device busy and idle), and
   per step the cycles (cached and speculative among them), the
   responses and tensors per response, the negotiation time per cycle,
   the runtime thread's busy time and its burst holds, then a table of
   the four runs. The quiet cache-on run must run cached cycles, and
   its rank 0 timeline (HOROVOD_TIMELINE) must hold NEGOTIATE_ALLREDUCE,
   NEGOTIATE_CACHED, ALLREDUCE, QUEUE, COLLECTIVE and CYCLE_START; at
   size 1 no fusion buffer exists (the local plane, like the
   reference's, hands the tensors back), so MEMCPY_IN_FUSION_BUFFER is
   held in phase 10's timeline. Then the depth-2 model takes 5 eager
   steps on the whole batch of 4: phase 10's reference.
10. A two-rank world on one card: the script starts a second process of
   itself as rank 1 (both ranks on cuda:0; NCCL refuses two ranks on one
   device). Both ranks take the process-group plane out of their backend
   lists, so the runtime's socket star carries the CUDA tensors. CUDA
   tensors go through every collective against their closed-form values
   exactly; mismatched dtypes across the ranks raise on both and the
   world works afterwards; 5 times under one name, a tensor that a chain
   of 16 fp32 matmuls of 8192^2 x 256 writes right before
   ``allreduce_async`` (the stream still busy, which is checked) arrives
   holding the chain's result (the ready event), and at least one of
   those rounds must be a speculative cycle of the response cache,
   whose pack waits on the same event; the depth-2 LM at full width
   takes 5 eager steps on 2 rows per rank, of which steps 3-5 must run
   speculative cycles (a mask speculates only after a pure-hit cycle of
   it was granted in full), and which must agree with phase 9's
   whole-batch steps: the mean of the ranks' losses within 1e-4 of the
   loss (relative), every parameter within 2^-6 of its largest update
   (the ranks' weight gradients are rounded to bf16 on 2 rows each, the
   whole batch's once on 4: 2^-8 of a gradient apart), the two ranks'
   parameters equal. Rank 0's timeline must hold
   MEMCPY_IN_FUSION_BUFFER, NEGOTIATE_CACHED and NEGOTIATE_CACHED_FUSED.
   Prints the seconds per step, the cycle counts and the bytes moved
   between the card and the host.
11. The same world through the process-group plane
   (horovod_tpu_torch/ops/process_group_ops.py): the ranks must agree on
   its gloo rendering (one card, two ranks), every check of phase 10
   must hold, no CUDA tensor may reach the star (its card<->host bytes
   stay 0 from init on) and the plane must have served responses; the
   plane is not fused-cycle-reducible, so steps 3-5 must run cached
   cycles and no speculative one (the two-round bitmask path); the
   losses and parameters must equal phase 10's bit for bit (a sum of two
   fp32 terms has one order), or else phase 10's bounds against the
   whole batch, and the script says which held. Prints the seconds per
   step, the loop's busy ms and the responses per step (per backend)
   beside phase 10's. The nccl rendering needs a card per rank and is
   not run here. Phases 9-11 run with the heartbeat at its defaults.
12. Wire dtypes on the card, every rank a child process of the script
   (``--child``): phase 10's two-rank star world with
   HOROVOD_COMPRESSION=bf16 on both ranks, and a two-rank int8 world,
   started together. CUDA fp32 (and fp64) tensors go through every
   compressed collective (allreduce summed, averaged, scaled and fused,
   allgather, reducescatter, and 6 steps under one name: speculative
   cycles at bf16, an error-feedback chain at int8) and must equal the
   port's CPU codec's closed forms on the same inputs bit for bit;
   bf16, int32 and the broadcast pass uncompressed. int8's residuals on
   the card must equal the CPU's. The bf16 world's depth-2 LM takes
   phase 10's 5 eager steps: the ranks' parameters equal, each loss
   within 2^-6 of its move since step 1 plus 1e-4 of it of phase 10's
   (the argument is at ``wire_phase``), and the card->host bytes exactly
   phase 10's less 2 bytes per fp32 gradient element of the model (in
   both phases leaving out the packs of speculative bids the world
   answered the classic way, which pack their batch again: the
   runtime's ``spec_unused_bytes``, printed).
13. The abort on the card: two three-rank worlds of child processes on
   CUDA tensors (heartbeat interval 0.3 s, timeout 3 s), started
   together. Three ops into the gradient allreduces of the LM's first
   eager step (mid-allreduce), rank 1's loop hangs for 8 s in one and
   rank 1 is SIGKILLed in the other. Both survivors of each must raise
   WorldAbortedError naming rank 1 within the timeout plus 4 s of the
   time rank 1 stamped at its fault (the hang's not before the
   timeout); rank 2 learns it only from the coordinator's ABORT. Prints
   the seconds each took. Every survivor's flight recorder
   (HOROVOD_TPU_FLIGHT_DIR, a directory of the world's under the work
   directory) must leave one postmortem whose header and ``abort`` event
   name rank 1.
14. The observability planes on the card: phase 10's two-rank world
   through the star again, its LM's eager steps only, with the metrics
   plane (HOROVOD_TPU_METRICS=1, an ephemeral HOROVOD_TPU_METRICS_PORT,
   a JSONL log) and the trace plane (HOROVOD_TPU_TRACE) on, their files
   under the work directory. The losses and parameters must equal phase
   10's bit for bit; on rank 0 the world's cached and speculative cycles
   must equal the sums of the ranks' ``runtime.stats``, its
   hvd_cycles_total the sum of the snapshots it folded (each a rank's
   stats["cycles"] when taken), and ``GET /metrics`` the same numbers;
   the trace must hold one track per rank with the same round numbers on
   the batches both ranks ran. Prints seconds per step with the planes
   on against phase 10's, with them off.

The last two lines are the JSON ``kernels`` line (the kernels at their
main shapes, then the entry's shape, each C4 case and the Gemma-7B
geometry as ``<kernel>.<tag>``, a row per kernel and design; launches are
those of phase 4 for bf16 D 128, of phase 4b for bf16 D 256, of phase 4e
for bf16 D 96, of phase 4c for fp32 D 128, of phase 4d for the entry's
rows, else 0)
and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Dense peaks by input type (fp32 without the tensor cores), and the dense
# tf32 rate that the fp32 forward's tensor-core design (3xTF32) runs at.
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": 67e12}
PEAK_TF32_FLOPS = 494.7e12
# Clock cycles per millisecond that ``time_ms``'s spin assumes: the
# H100's top SM clock (1.98 GHz) rounded up, so that a spin lasts at
# least as long as it is asked to.
SPIN_CYCLES_PER_MS = 2_000_000
MAIN = dict(b=4, s=2048, h=16, d=128)
# The head dims and dtypes past the kernels' first set (ROADMAP.md C4 and
# the sm90 kernels' fp16, D 33-256 and the forward's D 257-512): (tag,
# dtype name, head dim), each checked in phase 2 and timed in phase 5 at
# this shape, causal, through the dispatchers (a head dim no kernel of a
# design is built for runs at the next one that is: on the sm90 kernels
# D 80 and 96 at 128, D 200 at 256 and the forward's D 320 at 384, on the
# caller's tensors; on the simt ones zero-padded, D 80 at 96). Where a
# kernel takes the sm90 design, its simt kernel is checked and timed
# beside it.
C4_SHAPE = dict(b=2, s=1024, h=8)
C4_CASES = (("bf16_d16", "bfloat16", 16), ("fp32_d16", "float32", 16),
            ("bf16_d32", "bfloat16", 32), ("fp32_d32", "float32", 32),
            ("fp16_d16", "float16", 16), ("fp16_d32", "float16", 32),
            ("fp16_d64", "float16", 64), ("fp16_d128", "float16", 128),
            ("fp16_d256", "float16", 256), ("bf16_d96", "bfloat16", 96),
            ("bf16_d80", "bfloat16", 80), ("bf16_d200", "bfloat16", 200),
            ("bf16_d256", "bfloat16", 256), ("fp32_d256", "float32", 256),
            ("bf16_d384", "bfloat16", 384), ("fp32_d384", "float32", 384),
            ("bf16_d320", "bfloat16", 320), ("fp32_d320", "float32", 320),
            ("bf16_d512", "bfloat16", 512), ("fp32_d512", "float32", 512),
            ("fp16_d512", "float16", 512),
            ("bf16_d640", "bfloat16", 640), ("fp16_d640", "float16", 640),
            ("fp32_d640", "float32", 640))
# The kernels the main path (bf16, D=128) runs: the sm90 forward, the
# backward's lse and delta pre-pass and the fused backward (dq, dk and dv
# in one launch, 16-bit D 33-128); the sm90 dq and dk/dv there, and the
# simt kernels, which no route runs, must not launch.
MAIN_PATH_KERNELS = ("flash_fwd_sm90", "flash_bwd_prep", "flash_bwd_sm90")
# The kernels of a 16-bit backward outside the fused kernel's head dims
# (D <= 32, 129-256): the sm90 dq and dk/dv, and the pre-pass.
PAIR_PATH_KERNELS = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90",
                     "flash_bwd_prep")
# Phase 4b's model: the attention widths of Gemma-7B (16 heads of 256, d
# 4096, MLP x4; google/gemma-7b config.json), vocab 32000, S 2048, batch
# 2, its 28 layers cut to 2. bf16 at D 256 runs the three sm90 kernels
# (the dq and dk/dv pair: past the fused backward's head dims).
GEMMA = dict(b=2, s=2048, h=16, d=256)
GEMMA_LAYERS = (28, 2)
GEMMA_PATH_KERNELS = PAIR_PATH_KERNELS
# Phase 4e's model: the attention widths of Phi-3-mini (32 heads of 96,
# hidden 3072; microsoft/Phi-3-mini-4k-instruct config.json), vocab 32000,
# S 2048, batch 2, its 32 layers cut to 2. bf16 at D 96 runs the sm90
# forward and the fused backward on the caller's tensors (the builds of
# 128).
PHI3 = dict(b=2, s=2048, h=32, d=96)
PHI3_LAYERS = (32, 2)
PHI3_PATH_KERNELS = MAIN_PATH_KERNELS
# The main shape's sm90 kernels and the seconds per step of phases 4 and
# 4b as PERF.md records them before dq took fp16 and D 256 (H100 80GB
# HBM3, 700 W): phases 4, 4b and 5 print this run's beside them.
RECORDED_MAIN_MS = {"flash_fwd_sm90": 0.1950, "flash_dq_sm90": 0.2328,
                    "flash_dkv_sm90": 0.3432}
RECORDED_STEP_S = {"main path": 0.2112, "gemma": 0.1408}
# The narrow sm90 forward's times before its kv tiles were split among
# warpgroups (PERF.md, the same card): at the C4 shape and the entry's;
# phase 5 prints this run's beside them.
RECORDED_NARROW_FWD_MS = {"bf16_d16": 0.0185, "bf16_d32": 0.0193,
                          "fp16_d16": 0.0186, "fp16_d32": 0.0193,
                          "entry": 0.0049}
# Keys and queries left out of a plain result by the lost-tile checks:
# one kv tile of the forward (128 rows at D 128, 64 at D 256, 32 at D
# 512, 64 on the stream and tf32 designs), one kv stage of dq (64 keys at
# D 128, on the narrow, stream and tf32 designs, 32 at D 256), one q tile
# of dk/dv (64 queries); ``fwd_columns`` and ``bwd_columns``: one region
# of the head dim (64 16-bit or 32 fp32 columns) left out of the logits
# of the forward, and of dq, dk and dv (the kernels streamed over D among
# them: the stream and tf32 designs sum them region by region);
# ``fwd_scale`` and ``bwd_scale``: the logits of the forward, and of dq,
# dk and dv, scaled for that head dim instead of the true one (the
# in-place sm90 kernels run the build of another);
# ``fwd_pv_columns``: columns of O left out of P V (a wide tf32 forward
# that lost a P V piece or read the wrong columns of V^T);
# ``dkv_columns``: columns of dk and dv left out (zero: a wide tf32 dk/dv
# that lost an output piece or stored it in the wrong columns);
# ``dq_columns``: column ranges of dq left out one at a time (zero: a wide
# tf32 dq that lost an output piece or stored it in the wrong columns);
# ``bwd``: the keys of one 128-key kv tile left out of dq, the part of dq
# that the fused backward adds as one (a lost or doubled add).
# The fp32 entries, those of the tf32 kernels, must be rejected at more
# than LOST_FP32_BY times the bound.
LOST_MAIN = dict(fwd=(1024, 1152), dq=(1024, 1088), dkv=(1536, 1600),
                 bwd=(1024, 1152))
LOST_MAIN_FP32 = dict(fwd=(1024, 1088), dq=(1024, 1088), dkv=(1536, 1600))
LOST_FP32_BY = 10.0
# The narrow sm90 kernels (16-bit D 16 and 32): 64 keys of the forward
# and dq and one 64-query tile of dk/dv left out must be rejected at more
# than this many times the bound (a wrong swizzle or tile offset loses at
# least that much).
LOST_NARROW_BY = 10.0
# The narrow forward deals a q tile's 64-key kv tiles round-robin among
# its 4 consumer warpgroups (kNarrowKv, kNarrowSplit in
# csrc/flash_fwd_sm90.cu): ``fwd_last_warpgroup`` leaves out the keys of
# one tile that the last warpgroup takes (tile 11 of the C4 shape's 16,
# keys 704-767; its tiles are 3, 7, 11 and 15), whose partial O and l
# reach the output only through the warpgroups' combine.
NARROW_LAST_WARPGROUP_KEYS = (704, 768)
# The narrow tf32 forward (fp32 D 16 and 32) deals its 32-key kv tiles
# round-robin among 4 consumer warpgroups (kNarrowKv, kNarrowSplit in
# csrc/flash_fwd_tf32_narrow_sm90.cu): keys 736-767 are tile 23 of the C4
# shape's 32, the last warpgroup's (its tiles are 3, 7, ..., 31), whose
# partial O, m and l reach the output only through the combine; 512-543 is
# one kv stage. The narrow tf32 dq deals its 64-key kv stages round-robin
# among 2 warpgroups (kDqKv, kDqSplit in csrc/flash_bwd_tf32_narrow_sm90.cu):
# keys 704-767 are stage 11, the last warpgroup's, and 512-575 one stage;
# dk/dv deals its 32-query stages among 3 (kDkvQ, kDkvSplit) from the first
# stage a kv tile sees, so in the first kv tile stage u goes to warpgroup
# u % 3: queries 736-767 are stage 23, the last warpgroup's there, and
# 512-543 one stage.
TF32_NARROW_LAST_WARPGROUP_KEYS = (736, 768)
TF32_NARROW_LOST = dict(fwd=(512, 544),
                        fwd_last_warpgroup=TF32_NARROW_LAST_WARPGROUP_KEYS,
                        dq=(512, 576), dq_last_warpgroup=(704, 768),
                        dkv=(512, 544),
                        dkv_last_warpgroup=TF32_NARROW_LAST_WARPGROUP_KEYS)
LOST_D256 = dict(fwd=(1024, 1088), dq=(1024, 1056), dkv=(1536, 1600))
LOST_C4 = {"bf16_d16": dict(fwd=(512, 576), dq=(512, 576), dkv=(512, 576),
                            fwd_last_warpgroup=NARROW_LAST_WARPGROUP_KEYS,
                            by=LOST_NARROW_BY),
           "bf16_d32": dict(fwd=(512, 576), dq=(512, 576), dkv=(512, 576),
                            fwd_last_warpgroup=NARROW_LAST_WARPGROUP_KEYS,
                            by=LOST_NARROW_BY),
           "fp32_d16": TF32_NARROW_LOST,
           "fp32_d32": TF32_NARROW_LOST,
           "bf16_d512": dict(fwd=(512, 544)),
           "bf16_d640": dict(fwd=(512, 576), fwd_columns=(256, 320),
                             dq=(512, 576), dkv=(512, 576),
                             bwd_columns=(256, 320), by=10.0),
           # the in-place forward, dq and dk/dv: the region that straddles
           # d lost, and the build's scale (1/sqrt(128)) taken for the
           # true D's
           "bf16_d96": dict(fwd_columns=(64, 96), fwd_scale=128,
                            bwd_columns=(64, 96), bwd_scale=128, by=10.0),
           # the in-place dq and the wide dk/dv at D 200: the straddling
           # box of the D 256 build (columns 192-199 below d) lost
           "bf16_d200": dict(bwd_columns=(192, 200), by=10.0),
           # the tf32 forward's wide build: columns 384-511, the last
           # two P V pieces of its second 256-column part, left out of P V;
           # the wide dk/dv: columns 448-511, the second piece of its
           # fourth 128-column part (the piece issued last in a tile); the
           # wide dq: columns 448-511, the last 64-column piece of its
           # second 256-column part (the piece its producer issues last in
           # a tile), and 576-639, a piece of its 128-column remainder
           "fp32_d640": dict(fwd_columns=(256, 288),
                             fwd_pv_columns=(384, 512),
                             bwd_columns=(256, 288),
                             dkv_columns=(448, 512),
                             dq_columns=((448, 512), (576, 640)))}
# ROADMAP C6: lengths under 128 that are no multiple of 64 (a full first
# tile and a ragged second one), on every design: (dtype name, head dim)
# at B 2, H 2, causal, Sq = Sk = 100 (q_offset 16; keys 64-99, the
# ragged tile, left out of the forward and dq must fail the bound) and Sq
# 100, Sk 127 (q_offset 27: the diagonal through both ragged ends).
RAGGED_DESIGNS = (("bfloat16", 32), ("float32", 32), ("bfloat16", 128),
                  ("bfloat16", 256), ("bfloat16", 640), ("float32", 128),
                  ("float32", 640), ("bfloat16", 16), ("float16", 32))
RAGGED_LENGTHS = ((100, 100, 16, dict(fwd=(64, 100), dq=(64, 100))),
                  (100, 127, 27, None))
# Phase 5's backward at the C4 shape through flash_attention_bwd: (tag,
# dtype name, head dim) where it pads (a row of 260 bf16 values, 520
# bytes, is no TMA stride: the stream dq and dk/dv at 320; fp16 D 20 runs
# the narrow builds of 32), and where the sm90 dq and dk/dv read the
# caller's tensors (D 80 and 96 on the builds of 128, D 200 on 256).
BWD_PADDED = (("bf16_d260", "bfloat16", 260), ("fp16_d20", "float16", 20))
BWD_IN_PLACE = (("bf16_d80", "bfloat16", 80), ("bf16_d96", "bfloat16", 96),
                ("bf16_d200", "bfloat16", 200))
# Phase 4c: phase 4's model in fp32 (the forward, dq and dk/dv on tf32),
# depth cut to 2, batch 4, S 2048, 4 steps (1 warm-up, 2 timed, 1
# profiled).
FP32_LM = dict(layers=2, warmup=1, steps=2)
FP32_PATH_KERNELS = ("flash_fwd_tf32", "flash_dq_tf32", "flash_dkv_tf32",
                     "flash_bwd_prep")
# Phase 4d: the entry's flagship model (horovod_tpu_torch/entry.py: bf16,
# 4 heads of 16, S 32, batch 2, 2 layers), its forward on the card against
# the CPU, then training steps (1 warm-up, 2 timed, 1 profiled). Head dim
# 16 runs the narrow sm90 forward, dq and dk/dv.
ENTRY = dict(b=2, s=32, h=4, d=16)
ENTRY_PATH_KERNELS = PAIR_PATH_KERNELS
ENTRY_STEPS = dict(warmup=1, steps=2)
# The entry's logits on the card against the CPU, elementwise: both run the
# same bf16 model from the same weights and tokens and differ only in where
# a bf16 rounding falls (p rounded for the tensor cores on the card, other
# summation orders in cuBLAS and the CPU's products). Each of the ~10
# rounded stages of a layer may move a value by one bf16 step (2^-8 of
# it), so over 2 layers the logits are held within 2.5% of their largest
# magnitude: the bound tests/test_torch_transformer.py and
# tests/test_torch_bench_entry.py hold the port's bf16 model to the
# reference's with.
ENTRY_LOGITS_TOL = 0.025


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """The card's milliseconds per call of ``fn``: the mean of ``reps``
    calls between two CUDA events. A spin on the card holds the start
    event until the host has queued every call, so that the calls run
    back to back and the host's own time per call (Python, dispatch,
    descriptor encoding) stays out of a time it would otherwise swamp at
    small shapes. The spin lasts twice the host's time for the calls, as
    the last warm-up call took it; where the start event had passed
    before the host was done, the spin is made four times longer, twice
    at most, and then the time is taken as the events fell."""
    import torch
    host_ms = 1.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    spin_ms = 2 * reps * host_ms + 1
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            break
        spin_ms *= 4
    return start.elapsed_time(end) / reps


def check_close(label, mine, plain, rtol, step=0.0, atol=1e-6, rows=True,
                plain_b=None, must_fail=False, fail_by=1.0) -> float:
    """Holds every element of ``mine`` to the bound of utils/tolerance.py;
    returns the largest absolute error. With ``must_fail``, ``mine`` is a
    deliberately wrong result and the bound must reject it, by more than
    ``fail_by`` times the bound."""
    from horovod_tpu_torch.utils import tolerance
    max_err, ratio = tolerance.worst(mine, plain, rtol, atol=atol,
                                     step=step, rows=rows, plain_b=plain_b)
    ok = math.isfinite(max_err) and ratio <= (fail_by if must_fail else 1.0)
    if must_fail:
        verdict = ("PASSED (too loose)" if ok else
                   f"rejected, as it must be (over {fail_by:g}x)")
    else:
        verdict = "ok" if ok else "FAIL"
    print(f"  {label:<34} max_abs_err={max_err:.3e} "
          f"worst err/tol={ratio:.3f} (rtol={rtol:g} of the "
          f"{'row' if rows else 'element'}, step={step:g}"
          f"{', 2x 16-bit-operand gap' if plain_b is not None else ''}) "
          f"{verdict}")
    if must_fail and ok:
        raise AssertionError(f"{label}: the bound cannot see a lost tile "
                             f"(err/tol {ratio:.3f})")
    if not must_fail and not ok:
        raise AssertionError(f"{label}: an element is {ratio:.3f} times "
                             f"its tolerance")
    return max_err


def fwd_without_keys(fa, q, k, v, lo, hi, qo=0, ko=0):
    """The plain causal forward with keys lo..hi-1 left out: two plain
    calls over the kept keys, merged through their (m, l) stats (one when
    hi is the last key)."""
    q, k, v = q.float(), k.float(), v.float()
    o1, m1, l1 = fa._flash_fwd_plain(q, k[:, :lo], v[:, :lo], True, qo, ko)
    if hi >= k.shape[1]:
        return o1
    o2, m2, l2 = fa._flash_fwd_plain(q, k[:, hi:], v[:, hi:], True, qo,
                                     ko + hi)
    m = m1.maximum(m2)
    w1, w2 = l1 * (m1 - m).exp(), l2 * (m2 - m).exp()
    w1, w2, l = (x.transpose(1, 2)[..., None] for x in (w1, w2, w1 + w2))
    return (o1 * w1 + o2 * w2) / l


def fwd_without_columns(fa, q, k, v, lo, hi):
    """The plain causal forward's o with columns lo..hi-1 of the head dim
    left out of the logits (q and k zeroed there): a streamed kernel that
    lost one region of D."""
    q, k = q.float().clone(), k.float().clone()
    q[..., lo:hi] = 0
    k[..., lo:hi] = 0
    return fa._flash_fwd_plain(q, k, v.float(), True, 0, 0)[0]


def fwd_without_pv_columns(fa, q, k, v, lo, hi):
    """The plain causal forward's o with columns lo..hi-1 of the head dim
    left out of P V (v zeroed there, so o is 0 in them): a kernel that
    lost the P V product of those columns of O."""
    v = v.float().clone()
    v[..., lo:hi] = 0
    return fa._flash_fwd_plain(q.float(), k.float(), v, True, 0, 0)[0]


def dq_without_keys(fa, q, k, v, do, lse, delta, lo, hi, qo=0, ko=0,
                    operands=None):
    """The plain causal dq with keys lo..hi-1 left out: dq is a sum over
    keys, so it is the plain dq over keys [:lo] plus that over keys [hi:]
    at k_offset hi, with the whole attention's lse and delta."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    dq = fa._flash_dq_plain(q, k[:, :lo], v[:, :lo], do, lse, delta, True,
                            qo, ko, operands=operands)
    if hi < k.shape[1]:
        dq = dq + fa._flash_dq_plain(q, k[:, hi:], v[:, hi:], do, lse,
                                     delta, True, qo, ko + hi,
                                     operands=operands)
    return dq


def bwd_without_columns(fa, q, k, v, do, lse, delta, lo, hi):
    """The plain causal dq, dk and dv with columns lo..hi-1 of the head dim
    left out of the logits (q and k zeroed there for s alone): a streamed
    backward kernel that lost one region of D from its sum for S."""
    qz, kz = q.float().clone(), k.float().clone()
    qz[..., lo:hi] = 0
    kz[..., lo:hi] = 0
    s, allowed = fa._scores(qz, kz, True, 0, 0,
                            scale=fa._softmax_scale(q.shape[-1]))
    p = (s - lse[..., None]).exp() * allowed
    dp = fa._product("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * fa._softmax_scale(q.shape[-1])
    return (fa._product("bhqk,bkhd->bqhd", ds, k),
            fa._product("bhqk,bqhd->bkhd", ds, q),
            fa._product("bhqk,bqhd->bkhd", p, do))


def dq_without_columns(dq, lo, hi):
    """dq with columns lo..hi-1 of the head dim left out (zero): a kernel
    that lost the output product of those columns."""
    dq = dq.clone()
    dq[..., lo:hi] = 0
    return dq


def dkv_without_columns(dk, dv, lo, hi):
    """dk and dv with columns lo..hi-1 of the head dim left out (zero): a
    kernel that lost the output product of those columns."""
    dk, dv = dk.clone(), dv.clone()
    dk[..., lo:hi] = 0
    dv[..., lo:hi] = 0
    return dk, dv


def kernel_name(fa, kern, design, tag=None):
    """A kernel's row name: its launch counter (flash_fwd, flash_fwd_sm90,
    flash_fwd_tf32, ...) with .tag for a case off the main shape."""
    name = fa.counter_name(kern, design)
    return name if tag is None else f"{name}.{tag}"


def kernel_case(fa, torch, name, b, s, h, d, dtype, causal, qo=0, ko=0,
                seed=0, design=None, lost=None, kernels=None, tag=None,
                sk=None):
    """Runs ``kernels`` (of fwd, dq, dkv) and their plain versions on one
    input set (``sk`` keys, default ``s``); returns {row name:
    max_abs_err}. ``design`` forces one design (default: ``fa._design``
    per kernel); every launch goes through ``fa._launch``, which pads a
    head dim no kernel of the design is built for. ``lost`` (LOST_MAIN,
    LOST_D256, ...) adds the checks that a plain result with one tile (or
    one region of the head dim) left out fails the bound, for each kernel
    it names (by more than LOST_FP32_BY times on fp32)."""
    from horovod_tpu_torch.utils.tolerance import DQ_ATOL, step_of
    g = torch.Generator(device="cuda").manual_seed(seed)
    sk = sk or s
    q, k, v, do = (torch.randn(b, n, h, d, generator=g, device="cuda")
                   .to(dtype) for n in (s, sk, sk, s))
    kernels = kernels or fa.KERNELS
    designs = {kern: design or fa._design(dtype, d, kern)
               for kern in fa.KERNELS}
    print(f"case {name}: B={b} Sq={s} Sk={sk} H={h} D={d} "
          f"{str(dtype)[6:]} causal={causal} q_offset={qo} k_offset={ko} "
          f"designs " + ", ".join(f"{kern} {designs[kern]}"
                                  for kern in kernels))
    # The operand rounding of each 16-bit tensor-core kernel (sm90,
    # stream): p and ds in the input's type. The fp32 kernels on the tensor
    # cores (tf32) are held to the fp32 bound with no such allowance: the
    # forward against the fp32 plain version, dq and dk/dv against the
    # plain versions that take their products as three tf32 products.
    rounded = {kern: dtype if designs[kern] in ("sm90", "stream") else None
               for kern in fa.KERNELS}
    tf32 = {kern: fa.TF32X3 if designs[kern] == "tf32" else None
            for kern in fa.KERNELS}
    fail_by = LOST_FP32_BY if dtype == torch.float32 else 1.0
    if lost and "by" in lost:
        fail_by = lost["by"]
    fwd_args = (q, k, v, causal, qo, ko)
    o_p, m_p, l_p = fa._flash_fwd_plain(*fwd_args)
    lse = fa._lse_from_stats(m_p, l_p)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    plain_args = (q, k, v, do, lse, delta, causal, qo, ko)
    out = {}
    if "fwd" in kernels:
        out["fwd"] = fa._launch("fwd", designs["fwd"], (q, k, v), causal, qo,
                                ko)
    if "dq" in kernels:
        out["dq"] = fa._launch("dq", designs["dq"], (q, k, v, do), lse, delta,
                               causal, qo, ko)
    if "dkv" in kernels:
        out["dkv"] = fa._launch("dkv", designs["dkv"], (q, k, v, do), lse,
                                delta, causal, qo, ko)
    # The fused backward where it serves (16-bit D 33-128), on the same
    # inputs, lse and delta as the pair.
    fused = (design is None and {"dq", "dkv"} <= set(kernels)
             and fa._fused_bwd(dtype, d))
    if fused:
        out["bwd"] = fa._launch("bwd", "sm90", (q, k, v, do), lse, delta,
                                causal, qo, ko)
    if design is None and "dq" in kernels:
        out["prep"] = fa._bwd_prep(*(x.contiguous()
                                     for x in (o_p, do, m_p, l_p)))[:2]
    torch.cuda.synchronize()
    step = step_of(dtype)
    errs = {}
    if "fwd" in kernels:
        o, m, l = out.pop("fwd")
        o_b = (fa._flash_fwd_plain(*fwd_args, operands=rounded["fwd"])[0]
               if rounded["fwd"] else None)
        errs[kernel_name(fa, "fwd", designs["fwd"], tag)] = max(
            check_close("forward o", o, o_p, 2e-5, step, plain_b=o_b),
            check_close("forward m", m, m_p, 2e-5, atol=1e-5, rows=False),
            check_close("forward l", l, l_p, 2e-5, rows=False))
        for key, what in (("fwd", ""),
                          ("fwd_last_warpgroup", ", the last warpgroup's")):
            if not (lost and key in lost):
                continue
            lo, hi = lost[key]
            check_close(f"forward o, keys {lo}-{hi - 1}{what} left out",
                        fwd_without_keys(fa, q, k, v, lo, hi, qo, ko), o_p,
                        2e-5, step, plain_b=o_b, must_fail=True,
                        fail_by=fail_by)
        if lost and "fwd_columns" in lost:
            lo, hi = lost["fwd_columns"]
            check_close(f"forward o, columns {lo}-{hi - 1} left out",
                        fwd_without_columns(fa, q, k, v, lo, hi), o_p, 2e-5,
                        step, plain_b=o_b, must_fail=True, fail_by=fail_by)
        if lost and "fwd_pv_columns" in lost:
            lo, hi = lost["fwd_pv_columns"]
            check_close(f"forward o, columns {lo}-{hi - 1} left out of P V",
                        fwd_without_pv_columns(fa, q, k, v, lo, hi), o_p,
                        2e-5, step, plain_b=o_b, must_fail=True,
                        fail_by=fail_by)
        if lost and "fwd_scale" in lost:
            dim = lost["fwd_scale"]
            check_close(f"forward o, scale of head dim {dim}",
                        fa._flash_fwd_plain(*fwd_args,
                                            scale=fa._softmax_scale(dim))[0],
                        o_p, 2e-5, step, plain_b=o_b, must_fail=True,
                        fail_by=fail_by)
        del o, m, l, o_b
    if "prep" in out:
        # The pre-pass kernel against its plain version (the lse and delta
        # above): lse within 1e-6 of |m| + |log l| (+inf where l = 0,
        # equal), delta within 1e-5 of the sum of |do o| (another order of
        # the same fp32 sum).
        lse_k, delta_k = out.pop("prep")
        dead = torch.isinf(lse)
        live_l = torch.where(l_p > 0, l_p, torch.ones_like(l_p))
        terms = m_p.abs() + live_l.log().abs()
        size = (do.float() * o_p.float()).abs().sum(-1).transpose(1, 2)
        lse_err = (lse_k - lse).abs()[~dead]
        # (a floor of 1e-30 keeps 0 / 0 out of the ratios)
        ratio = max((lse_err / (1e-6 * terms[~dead] + 1e-30)).max().item()
                    if lse_err.numel() else 0.0,
                    ((delta_k - delta).abs() / (1e-5 * size + 1e-30))
                    .max().item())
        same_dead = torch.equal(torch.isinf(lse_k), dead)
        err = max(lse_err.max().item() if lse_err.numel() else 0.0,
                  (delta_k - delta).abs().max().item())
        print(f"  {'pre-pass lse, delta':<34} max_abs_err={err:.3e} worst "
              f"err/tol={ratio:.3f} (lse 1e-6 of |m| + |log l|, delta 1e-5 "
              f"of sum |do o|; dead rows +inf: {same_dead}) "
              f"{'ok' if ratio <= 1 and same_dead else 'FAIL'}")
        if not (ratio <= 1 and same_dead):
            raise AssertionError(f"the backward's pre-pass differs from its "
                                 f"plain version ({ratio:.3f} of the bound)")
        errs[kernel_name(fa, "bwd", "prep", tag)] = err
    del o_p, m_p, l_p
    if fused:
        # The fused backward: dq to the fp32 plain dq with the bound of the
        # sm90 dq (DQ_ATOL; the 16-bit operands' allowance from
        # _flash_bwd_sm90_plain, whose dq sums 128-key kv tiles apart), dk
        # and dv bit for bit the sm90 dk/dv's on the same inputs.
        dq_f, dk_f, dv_f = out.pop("bwd")
        dk_s, dv_s = out["dkv"]
        if not (torch.equal(dk_f, dk_s) and torch.equal(dv_f, dv_s)):
            raise AssertionError("the fused backward's dk and dv differ "
                                 "from flash_dkv_sm90's")
        dq_p = fa._flash_dq_plain(*plain_args)
        dq_b = fa._flash_bwd_sm90_plain(*plain_args, operands=dtype)[0]
        err = check_close("fused dq", dq_f, dq_p, 1e-4, step_of(dtype),
                          atol=DQ_ATOL, plain_b=dq_b)
        print(f"  {'fused dk, dv':<34} bit-equal to flash_dkv_sm90's")
        if lost and "bwd" in lost:
            lo, hi = lost["bwd"]
            check_close(f"fused dq, keys {lo}-{hi - 1} left out",
                        dq_without_keys(fa, q, k, v, do, lse, delta, lo, hi,
                                        qo, ko),
                        dq_p, 1e-4, step_of(dtype), atol=DQ_ATOL,
                        plain_b=dq_b, must_fail=True)
        errs[kernel_name(fa, "bwd", "sm90", tag)] = err
        del dq_f, dk_f, dv_f, dq_p, dq_b
    if "dq" in kernels:
        dq = out.pop("dq")
        dq_p = fa._flash_dq_plain(*plain_args, operands=tf32["dq"])
        dq_b = (fa._flash_dq_plain(*plain_args, operands=rounded["dq"])
                if rounded["dq"] else None)
        dq_atol = 1e-6 if designs["dq"] == "simt" else DQ_ATOL
        errs[kernel_name(fa, "dq", designs["dq"], tag)] = check_close(
            "dq", dq, dq_p, 1e-4, step, atol=dq_atol, plain_b=dq_b)
        for key, what in (("dq", ""),
                          ("dq_last_warpgroup", ", the last warpgroup's")):
            if not (lost and key in lost):
                continue
            lo, hi = lost[key]
            check_close(f"dq, keys {lo}-{hi - 1}{what} left out",
                        dq_without_keys(fa, q, k, v, do, lse, delta, lo, hi,
                                        qo, ko, tf32["dq"]),
                        dq_p, 1e-4, step, atol=dq_atol, plain_b=dq_b,
                        must_fail=True, fail_by=fail_by)
        if lost and "bwd_columns" in lost:
            lo, hi = lost["bwd_columns"]
            check_close(f"dq, columns {lo}-{hi - 1} left out of s",
                        bwd_without_columns(fa, q, k, v, do, lse, delta, lo,
                                            hi)[0], dq_p, 1e-4, step,
                        atol=dq_atol, plain_b=dq_b, must_fail=True,
                        fail_by=fail_by)
        for lo, hi in (lost or {}).get("dq_columns", ()):
            check_close(f"dq, columns {lo}-{hi - 1} left out",
                        dq_without_columns(dq_p, lo, hi), dq_p, 1e-4, step,
                        atol=dq_atol, plain_b=dq_b, must_fail=True,
                        fail_by=fail_by)
        if lost and "bwd_scale" in lost:
            dim = lost["bwd_scale"]
            check_close(f"dq, scale of head dim {dim}",
                        fa._flash_dq_plain(*plain_args,
                                           scale=fa._softmax_scale(dim)),
                        dq_p, 1e-4, step, atol=dq_atol, plain_b=dq_b,
                        must_fail=True, fail_by=fail_by)
        del dq, dq_p, dq_b
    if "dkv" in kernels:
        dk, dv = out.pop("dkv")
        dk_p, dv_p = fa._flash_dkv_plain(*plain_args, operands=tf32["dkv"])
        dk_b, dv_b = (fa._flash_dkv_plain(*plain_args,
                                          operands=rounded["dkv"])
                      if rounded["dkv"] else (None, None))
        errs[kernel_name(fa, "dkv", designs["dkv"], tag)] = max(
            check_close("dk", dk, dk_p, 1e-4, step, plain_b=dk_b),
            check_close("dv", dv, dv_p, 1e-4, step, plain_b=dv_b))
        for key, what in (("dkv", ""),
                          ("dkv_last_warpgroup", ", the last warpgroup's")):
            if not (lost and key in lost):
                continue
            # Zero do and delta on one q tile: p * do and ds vanish
            # there, which leaves that tile out of dk and dv exactly.
            lo, hi = lost[key]
            do_x, delta_x = do.clone(), delta.clone()
            do_x[:, lo:hi] = 0
            delta_x[:, :, lo:hi] = 0
            dk_x, dv_x = fa._flash_dkv_plain(q, k, v, do_x, lse, delta_x,
                                             causal, qo, ko)
            check_close(f"dk, queries {lo}-{hi - 1}{what} left out", dk_x,
                        dk_p, 1e-4, step, plain_b=dk_b, must_fail=True,
                        fail_by=fail_by)
            check_close(f"dv, queries {lo}-{hi - 1}{what} left out", dv_x,
                        dv_p, 1e-4, step, plain_b=dv_b, must_fail=True,
                        fail_by=fail_by)
        wrong = {}
        if lost and "bwd_columns" in lost:
            lo, hi = lost["bwd_columns"]
            wrong[f"columns {lo}-{hi - 1} left out of s"] = (
                bwd_without_columns(fa, q, k, v, do, lse, delta, lo, hi)[1:])
        if lost and "bwd_scale" in lost:
            dim = lost["bwd_scale"]
            wrong[f"scale of head dim {dim}"] = fa._flash_dkv_plain(
                *plain_args, scale=fa._softmax_scale(dim))
        if lost and "dkv_columns" in lost:
            lo, hi = lost["dkv_columns"]
            wrong[f"columns {lo}-{hi - 1} left out"] = dkv_without_columns(
                dk_p, dv_p, lo, hi)
        for what, (dk_x, dv_x) in wrong.items():
            check_close(f"dk, {what}", dk_x, dk_p, 1e-4, step, plain_b=dk_b,
                        must_fail=True, fail_by=fail_by)
            check_close(f"dv, {what}", dv_x, dv_p, 1e-4, step, plain_b=dv_b,
                        must_fail=True, fail_by=fail_by)
    torch.cuda.empty_cache()
    return errs


def tensor_core_kernels_of(fa, dtype, d):
    """The kernels (of fwd, dq, dkv) that take a tensor-core design (sm90,
    stream, tf32) here rather than simt."""
    return tuple(kern for kern in fa.KERNELS
                 if fa._design(dtype, d, kern) != "simt")


def kernel_checks(torch, fa):
    """Phase 2: every case against its plain version; returns the
    {row name: max_abs_err} of the rows phase 5 times."""
    bf16, fp32 = torch.bfloat16, torch.float32
    kernel_case(fa, torch, "main_simt", **MAIN, dtype=bf16, causal=True,
                seed=7, design="simt")
    errs = kernel_case(fa, torch, "main", **MAIN, dtype=bf16, causal=True,
                       lost=LOST_MAIN)
    kernel_case(fa, torch, "noncausal", 2, 256, 4, 128, bf16, False, seed=1)
    kernel_case(fa, torch, "q_offset", 1, 512, 4, 128, bf16, True, qo=128,
                seed=2)
    kernel_case(fa, torch, "dead_rows", 1, 256, 4, 128, bf16, True, ko=192,
                seed=3)
    kernel_case(fa, torch, "d64", 2, 512, 8, 64, bf16, True, seed=4)
    kernel_case(fa, torch, "short_ragged", 2, 40, 3, 64, bf16, True, seed=8)
    kernel_case(fa, torch, "fp32", 2, 512, 4, 128, fp32, True, qo=64,
                seed=5)
    # Unequal lengths with offsets on the tf32 kernels (a ring shard's kv
    # longer than its queries; a non-causal kv shorter).
    kernel_case(fa, torch, "fp32_kv_longer", 2, 512, 4, 128, fp32, True,
                qo=256, sk=768, seed=9)
    kernel_case(fa, torch, "fp32_d640_kv_shorter", 2, 384, 4, 640, fp32,
                False, ko=64, sk=256, seed=10)
    kernel_case(fa, torch, "fp32_d320_kv_longer", 2, 256, 4, 320, fp32, True,
                qo=256, sk=512, seed=12)
    # The fp32 rows of the kernels line carry the fp32 errors at the main
    # shape, the inputs phase 5 times them on: the tf32 forward, dq and
    # dk/dv (with a lost 64-key stage and 64-query tile) and the simt
    # kernels beside them.
    # (The pre-pass's untagged row is the bf16 main shape's.)
    fp32_errs = kernel_case(fa, torch, "main_fp32", **MAIN, dtype=fp32,
                            causal=True, seed=6, lost=LOST_MAIN_FP32)
    fp32_errs.pop(kernel_name(fa, "bwd", "prep"))
    errs.update(fp32_errs)
    errs.update(kernel_case(fa, torch, "main_fp32 on simt", **MAIN,
                            dtype=fp32, causal=True, seed=6, design="simt"))
    # The entry's shape (phase 4d's path): the narrow sm90 forward, dq and
    # dk/dv.
    errs.update(kernel_case(fa, torch, "entry", **ENTRY, dtype=bf16,
                            causal=True, seed=11, tag="entry"))
    # ROADMAP C6: a ragged second tile on every design.
    for i, (dt, d) in enumerate(RAGGED_DESIGNS):
        for sq, sk, qo, lost in RAGGED_LENGTHS:
            kernel_case(fa, torch, f"ragged_{dt}_d{d}", 2, sq, 2, d,
                        getattr(torch, dt), True, qo=qo, sk=sk,
                        seed=40 + i, lost=lost)
    cases = [(tag, getattr(torch, dt), dict(C4_SHAPE, d=d), LOST_C4.get(tag))
             for tag, dt, d in C4_CASES]
    # The Gemma-7B geometry, with the lost-tile checks at D 256's tiles.
    cases.append(("gemma", bf16, GEMMA, LOST_D256))
    for i, (tag, dtype, shape, lost) in enumerate(cases):
        errs.update(kernel_case(fa, torch, tag, **shape, dtype=dtype,
                                causal=True, seed=20 + i, lost=lost, tag=tag))
        tc = tensor_core_kernels_of(fa, dtype, shape["d"])
        if tc:
            errs.update(kernel_case(fa, torch, f"{tag} on simt", **shape,
                                    dtype=dtype, causal=True, seed=20 + i,
                                    design="simt", kernels=tc, tag=tag))
    return errs


def small_model_check(torch, seed):
    """Loss and gradients of a 2-layer fp32 model through the kernels
    equal those through dense attention."""
    from horovod_tpu_torch.models import (
        TransformerConfig, TransformerLM, causal_attention,
        lm_loss_from_hidden)
    losses, grads = [], []
    for attention_fn in (None, causal_attention):
        cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                                head_dim=64, max_seq_len=256,
                                dtype=torch.float32,
                                attention_fn=attention_fn)
        g = torch.Generator(device="cuda").manual_seed(seed)
        model = TransformerLM(cfg, device="cuda", generator=g)
        tokens = torch.randint(0, 512, (2, 256), generator=g, device="cuda")
        hidden = model(tokens, return_hidden=True)
        loss = lm_loss_from_hidden(hidden, model.lm_head.weight.t(), tokens,
                                   chunk=100)
        loss.backward()
        losses.append(loss.detach())
        grads.append(torch.cat([p.grad.flatten()
                                for p in model.parameters()]))
    print("small model: flash path vs dense attention, fp32")
    check_close("loss", losses[0], losses[1], 2e-5)
    check_close("parameter gradients", grads[0], grads[1], 1e-4)


# Kernel-name fragments of each group of the profiled step's breakdown;
# a kernel goes to the first group one of whose fragments its name holds.
LM_GROUPS = {"flash attention kernels": ("flash_",),
             "matrix products": ("gemm", "cutlass", "xmma", "nvjet"),
             "nccl": ("nccl",)}
CONV_GROUPS = {"convolutions": ("conv", "fprop", "dgrad", "wgrad",
                                "implicit"),
               "matrix products": ("gemm", "cutlass", "xmma", "nvjet"),
               "nccl": ("nccl",)}


def check_falling(values):
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"the loss is not finite: {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the loss did not fall on the repeated "
                             f"batch: {values}")


def profiled_step(torch, step):
    """Runs ``step()`` once under torch.profiler; returns the profile and
    the step's host time."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        step().item()
        wall = time.perf_counter() - t0
    return prof, wall


def print_breakdown(prof, wall, groups):
    """Device time of one profiled step by kernel, in ``groups``, beside
    that step's host time ``wall`` (its complement is the device's idle
    share)."""
    from torch.autograd import DeviceType
    # Kernels only: a CPU op's self device time repeats its kernels'.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print("  profiled step: the profiler recorded no device time "
              "(breakdown not measured)")
        return
    by_group = {g: [] for g in list(groups) + ["other"]}
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        name = e.key.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), "other")
        by_group[group].append(e)
    # The device's and the host's clocks differ: a busy time above the
    # host time reads as no idle share.
    idle = max(0.0, 1 - total_us / 1e6 / wall)
    print(f"  profiled step: device busy {total_us / 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms host time (idle {idle:.1%})")
    for group, members in by_group.items():
        us = sum(e.self_device_time_total for e in members)
        launches = sum(e.count for e in members)
        print(f"    {group:<26} {us / 1e3:9.2f} ms  {us / total_us:6.1%}  "
              f"{launches} launches")
        # The largest kernels of the group, so that its contents show.
        for e in members[:3]:
            print(f"      {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"x{e.count:<4} {e.key[:90]}")


def lm_path(torch, hvd, args, card, label, cfg, b, path_kernels, was,
            warmup=None, steps=None):
    """hvd.init(), the bench's training step of ``cfg`` on ``b`` rows
    (bench.transformer_step: random weights from --seed,
    DistributedOptimizer, SGD), ``warmup`` and ``steps`` timed steps
    (default --warmup and --steps) and one profiled step. The loss must
    be finite and fall, and each kernel of ``path_kernels`` must launch
    once per layer per step and no other flash kernel at all. Prints the
    seconds per step beside ``was``, the recorded one (if any). Returns
    the launch counts."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils.timing import steady_state_sec_per_step

    hvd.init()
    s = cfg.max_seq_len
    train, model = bench.transformer_step(cfg, b, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    losses = []

    def step():
        losses.append(train())
        return losses[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    warmup = args.warmup if warmup is None else warmup
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=warmup,
                                    chunks=args.steps if steps is None
                                    else steps, chunk_steps=1)
    prof, wall = profiled_step(torch, step)
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    print(f"{label}: L{cfg.num_layers} d{cfg.embed_dim} ({cfg.num_heads} "
          f"heads of {cfg.head_dim}) S{s} B{b} V{cfg.vocab_size} "
          f"{str(cfg.dtype)[6:]}, {n_params / 1e6:.1f}M parameters, "
          f"{len(values)} steps ({warmup} warm-up)")
    print(f"  losses: {' '.join(f'{x:.4f}' for x in values)}")
    print(f"  launches: {counts}")
    # Model FLOPs as bench.py counts them: 6 x matmul parameters (all but
    # the embedding table) + 12 x L x S x d per token.
    model_flops = b * s * (6 * (n_params - cfg.vocab_size * cfg.embed_dim)
                           + 12 * cfg.num_layers * s * cfg.embed_dim)
    print(f"  sec/step {sec:.4f}, tokens/s {b * s / sec:.0f}, "
          f"model TFLOP/s {model_flops / sec / 1e12:.1f} "
          f"(MFU {model_flops / sec / PEAK_BF16_FLOPS:.1%} of 989 bf16), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    if was is not None:
        print(f"  sec/step {sec:.4f} against {was} recorded before dq took "
              f"fp16 and D 256 ({sec / was:.3f}x)")
    print_breakdown(prof, wall, LM_GROUPS)
    check_falling(values)
    want = cfg.num_layers * len(values)
    expected = {name: (want if name in path_kernels else 0)
                for name in counts}
    if counts != expected:
        raise AssertionError(f"expected {want} launches ({cfg.num_layers} "
                             f"per step) of each of {path_kernels} and "
                             f"none of the others, got {counts}")
    hvd.shutdown()
    del model, train
    torch.cuda.empty_cache()
    return counts


def main_path(torch, hvd, args, card):
    """Phase 4: the bench's LM at full width."""
    from horovod_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(num_layers=args.layers, dtype=torch.bfloat16,
                            **LM_FULL)
    return lm_path(torch, hvd, args, card, "main path", cfg, MAIN["b"],
                   MAIN_PATH_KERNELS, RECORDED_STEP_S["main path"])


def phi3_path(torch, hvd, args, card):
    """Phase 4e: the LM at Phi-3-mini's attention widths, depth cut."""
    from horovod_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(vocab_size=32000, num_layers=PHI3_LAYERS[1],
                            num_heads=PHI3["h"], head_dim=PHI3["d"],
                            max_seq_len=PHI3["s"], dtype=torch.bfloat16)
    label = (f"Phi-3-mini attention widths (microsoft/Phi-3-mini-4k-instruct "
             f"config.json), depth cut from {PHI3_LAYERS[0]} to "
             f"{PHI3_LAYERS[1]} layers")
    return lm_path(torch, hvd, args, card, label, cfg, PHI3["b"],
                   PHI3_PATH_KERNELS, None)


def gemma_path(torch, hvd, args, card):
    """Phase 4b: the LM at Gemma-7B's attention widths, depth cut."""
    from horovod_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(vocab_size=32000, num_layers=GEMMA_LAYERS[1],
                            num_heads=GEMMA["h"], head_dim=GEMMA["d"],
                            max_seq_len=GEMMA["s"], dtype=torch.bfloat16)
    label = (f"Gemma-7B attention widths (google/gemma-7b config.json), "
             f"depth cut from {GEMMA_LAYERS[0]} to {GEMMA_LAYERS[1]} layers")
    return lm_path(torch, hvd, args, card, label, cfg, GEMMA["b"],
                   GEMMA_PATH_KERNELS, RECORDED_STEP_S["gemma"])


def fp32_path(torch, hvd, args, card):
    """Phase 4c: phase 4's model in fp32, depth cut to 2: the forward, dq
    and dk/dv on the tf32 kernels."""
    from horovod_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(num_layers=FP32_LM["layers"], dtype=torch.float32,
                            **LM_FULL)
    label = (f"fp32 LM (phase 4's widths), depth cut from {args.layers} to "
             f"{FP32_LM['layers']} layers")
    return lm_path(torch, hvd, args, card, label, cfg, MAIN["b"],
                   FP32_PATH_KERNELS, None, warmup=FP32_LM["warmup"],
                   steps=FP32_LM["steps"])


def entry_path(torch, hvd, args, card):
    """Phase 4d: the entry's flagship model (horovod_tpu_torch/entry.py,
    bf16 at head dim 16). Its forward on the card, through ``entry()``'s
    own function, against the same weights and tokens on the CPU
    (ENTRY_LOGITS_TOL), for the entry's example tokens and for tokens from
    --seed; each call must launch the sm90 forward twice (once a layer)
    and no other flash kernel. Then the bench's training step of the same
    configuration through lm_path. Returns the forward's launch counts of
    one call and the training steps' counts."""
    from horovod_tpu_torch.entry import entry, tiny_config
    from horovod_tpu_torch.parallel import flash_attention as fa
    fn_cpu, (params, tokens) = entry(device="cpu")
    fn_card, _ = entry()
    g = torch.Generator().manual_seed(args.seed)
    seeded = torch.randint(0, tiny_config().vocab_size, tokens.shape,
                           generator=g)
    card_params = {name: p.cuda() for name, p in params.items()}
    print(f"entry forward (bf16, {tiny_config().num_heads} heads of "
          f"{tiny_config().head_dim}, S {tokens.shape[1]}, batch "
          f"{tokens.shape[0]}): the card against the CPU, |card - cpu| <= "
          f"{ENTRY_LOGITS_TOL} x max|cpu|")
    counts = None
    for label, toks in (("example tokens", tokens), ("seeded tokens", seeded)):
        with torch.no_grad():
            want = fn_cpu(params, toks)
            fa.reset_launch_counts()
            got = fn_card(card_params, toks.cuda())
            torch.cuda.synchronize()
            counts = fa.launch_counts()
        err = (got.cpu() - want).abs().max().item()
        tol = ENTRY_LOGITS_TOL * want.abs().max().item()
        ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
              and err <= tol)
        print(f"  {label:<15} logits {tuple(got.shape)} max |card - cpu| "
              f"{err:.4e} (tolerance {tol:.4e}, {err / tol:.3f} of it) "
              f"launches {counts}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"entry forward on the card: {label} "
                                 f"differ from the CPU by {err:.4e} "
                                 f"(tolerance {tol:.4e})")
        want_counts = dict.fromkeys(counts, 0)
        want_counts["flash_fwd_sm90"] = tiny_config().num_layers
        if counts != want_counts:
            raise AssertionError(f"entry forward launched {counts}, "
                                 f"expected {want_counts}")
    steps = lm_path(torch, hvd, args, card, "entry config training",
                    tiny_config(), ENTRY["b"], ENTRY_PATH_KERNELS, None,
                    **ENTRY_STEPS)
    return counts, steps


def vision_small_check(torch, seed):
    """A narrow fp32 ResNet and ViT with the same weights on the card
    (TF32 off) and on the CPU: logits, loss, every parameter gradient
    and the BatchNorm running statistics of one training pass agree
    within 1e-4 + 1e-4 |cpu| element by element."""
    import copy
    import torch.nn.functional as F
    from horovod_tpu_torch.models import vit
    from horovod_tpu_torch.models import resnet

    def train_pass(model, images, labels):
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        out = {"logits": logits.detach(), "loss": loss.detach()}
        out.update({n: p.grad for n, p in model.named_parameters()})
        out.update(dict(model.named_buffers()))
        return {k: v.cpu() for k, v in out.items()}

    builds = {
        "resnet (bottleneck, 8 filters)": lambda: resnet.ResNet(
            stage_sizes=[1, 1], block_cls=resnet.BottleneckBlock,
            num_filters=8, num_classes=10, dtype=torch.float32,
            device="cpu", generator=torch.Generator().manual_seed(seed)),
        "vit (2 layers, d 64)": lambda: vit.ViT(vit.ViTConfig(
            image_size=32, patch_size=4, num_classes=10, embed_dim=64,
            num_layers=2, num_heads=4, dtype=torch.float32), device="cpu",
            generator=torch.Generator().manual_seed(seed)),
    }
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(4, 32, 32, 3, generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    print("small vision models: the card against the CPU, fp32")
    for label, build in builds.items():
        cpu_model = build()
        card_model = copy.deepcopy(cpu_model).to("cuda")
        want = train_pass(cpu_model, images, labels)
        got = train_pass(card_model, images.cuda(), labels.cuda())
        ratio = max(((got[k] - want[k]).abs()
                     / (1e-4 + 1e-4 * want[k].abs())).max().item()
                    for k in want)
        print(f"  {label:<34} {len(want)} tensors, worst err/tol "
              f"{ratio:.3f} {'ok' if ratio <= 1 else 'FAIL'}")
        if not ratio <= 1:
            raise AssertionError(f"{label}: the card and the CPU differ "
                                 f"({ratio:.3f} of the tolerance)")


def classifier_leg(torch, hvd, args, card, label, build, batch,
                   macs_per_image=None):
    """``steps`` timed training steps (after ``warmup``) of the image
    classifier ``build()`` through the bench's ``classifier_step`` at 224x224,
    then one profiled step. The loss must be finite and fall, and no
    flash kernel may launch. Prints images/s, MFU where the model's
    multiply-adds per image are known, peak memory and the profiled
    step's device time by group."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.utils.timing import steady_state_sec_per_step

    hvd.init()
    model = build()
    train = bench.classifier_step(model, batch, seed=args.seed)
    losses = []

    def step():
        losses.append(train())
        return losses[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    sec = steady_state_sec_per_step(step, lambda loss: loss.item(),
                                    warmup_steps=args.warmup,
                                    chunks=args.steps, chunk_steps=1)
    prof, wall = profiled_step(torch, step)
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{label}: batch {batch} of 224x224, {n_params / 1e6:.2f}M "
          f"parameters, {len(values)} steps ({args.warmup} warm-up)")
    print(f"  losses: {' '.join(f'{x:.4f}' for x in values)}")
    mfu = ""
    if macs_per_image is not None:
        flops = 3 * 2 * macs_per_image * batch
        mfu = (f", model TFLOP/s {flops / sec / 1e12:.1f} (MFU "
               f"{flops / sec / PEAK_BF16_FLOPS:.1%} of 989 bf16)")
    print(f"  sec/step {sec:.4f}, images/s {batch / sec:.1f}{mfu}, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB  [{card}]")
    print_breakdown(prof, wall, CONV_GROUPS)
    check_falling(values)
    if any(counts.values()):
        raise AssertionError(f"{label} launched flash kernels: {counts}")
    hvd.shutdown()
    del model, train, step
    torch.cuda.empty_cache()


# The tf32 builds by kernel and by the output columns a CTA owns
# (part_cols; at D 16 and 32 the narrow builds own the whole head dim):
# the CUDA kernel that runs there, named on the kernels line.
TF32_BUILDS = {"fwd": {128: "flash_fwd_stream<float>",
                       256: "flash_fwd_tf32_wide"},
               "dq": {128: "flash_bwd_tf32<false>",
                      256: "flash_dq_tf32_wide"},
               "dkv": {64: "flash_bwd_tf32<true>",
                       128: "flash_dkv_tf32_wide"}}
TF32_NARROW_BUILDS = {"fwd": "flash_fwd_tf32_narrow",
                      "dq": "flash_bwd_tf32_narrow<false>",
                      "dkv": "flash_bwd_tf32_narrow<true>"}


def kernel_rows(torch, fa, b, s, h, d, dtype, design=None, kernels=None,
                tag=None, seed=1, prep=True):
    """{row name: ms, plain_ms, library_ms, bound_ms, bound_by, flops} of
    ``kernels`` on one causal input set of this shape and dtype, each the
    card's mean of 20 launches through ``fa._launch`` (padding included;
    ``time_ms``) with
    ``design`` (default: ``fa._design`` per kernel); the library call is
    scaled_dot_product_attention on [B, H, S, D] copies of the same
    inputs, in the same dtype. The plain version is the one phase 2 holds
    the kernel to (for the tf32 dq and dk/dv, its TF32X3 products); the
    tf32 times hold their pre-pass, timed apart as prepass_ms: the
    forward's (the first step of its C entry), and the backward's, which
    each standalone dq and dk/dv launch runs for itself (in fa._flash_bwd
    one pre-pass serves both; tf32_route_times times that route). The tf32
    forward's row names its build by the columns of O a CTA owns
    (part_cols: 128, or 256 past D 128; D at the narrow builds of 16 and
    32), the tf32 dq's by the columns of dQ (128, or 256 past D 128; D at
    the narrow builds) and the tf32 dk/dv's by the columns of dK and dV
    (64, or 128 past D 128; D at the narrow builds), and each tf32 row
    by its CUDA kernel too (build: TF32_BUILDS). With no ``design``, the
    fused backward's row where it serves (16-bit D 33-128; five products,
    7 tensors moved) and, with ``prep``, the pre-pass's (o and do read,
    lse and delta written: bytes; no PyTorch call computes both, so its
    library_ms is null)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, m, l = fa._flash_fwd(q, k, v, True, 0, 0)
    lse = fa._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kernels = kernels or fa.KERNELS
    designs = {kern: design or fa._design(dtype, d, kern)
               for kern in fa.KERNELS}
    calls = {
        "fwd": (lambda: fa._launch("fwd", designs["fwd"], (q, k, v), True,
                                   0, 0),
                lambda: fa._flash_fwd_plain(q, k, v, True, 0, 0)),
        "dq": (lambda: fa._launch("dq", designs["dq"], (q, k, v, do), lse,
                                  delta, True, 0, 0),
               lambda: fa._flash_dq_plain(q, k, v, do, lse, delta, True, 0,
                                          0, operands=tf32_ops["dq"])),
        "dkv": (lambda: fa._launch("dkv", designs["dkv"], (q, k, v, do), lse,
                                   delta, True, 0, 0),
                lambda: fa._flash_dkv_plain(q, k, v, do, lse, delta, True,
                                            0, 0, operands=tf32_ops["dkv"]))}
    tf32_ops = {kern: fa.TF32X3 if designs[kern] == "tf32" else None
                for kern in fa.KERNELS}
    if design is None and fa._fused_bwd(dtype, d):
        calls["bwd"] = (lambda: fa._launch("bwd", "sm90", (q, k, v, do), lse,
                                           delta, True, 0, 0),
                        lambda: fa._flash_bwd_sm90_plain(
                            q, k, v, do, lse, delta, True, 0, 0,
                            operands=dtype))
        designs["bwd"] = "sm90"
        tf32_ops["bwd"] = None
        kernels = tuple(kernels) + ("bwd",)
    ms = {fn: time_ms(calls[fn][0], 20) for fn in kernels}
    plain = {fn: time_ms(calls[fn][1], 5) for fn in kernels}
    prepass = dict.fromkeys(kernels)
    if any(designs[fn] == "tf32" for fn in kernels if fn != "fwd"):
        prepass["dq"] = prepass["dkv"] = time_ms(
            lambda: fa._on_padded_head_dim(
                lambda *t, scale=None: fa._tf32_bwd_split(*t), (q, k, v, do),
                design="tf32", kernel="dq"), 20)
    if "fwd" in kernels and designs["fwd"] == "tf32":
        prepass["fwd"] = time_ms(lambda: fa._on_padded_head_dim(
            lambda *t, scale=None: fa._tf32_fwd_split(*t), (q, k, v),
            design="tf32", kernel="fwd"), 20)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))

    def fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(
            dot)
    lib_fwd_bwd = time_ms(fwd_bwd, 20)
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), 20)

    bh, elt = b * h, q.element_size()
    tensor = b * s * h * d * elt
    stats = b * h * s * 4
    # 2 x D operations per visible (q, k) pair (half of them, causal) for
    # each matrix product the function needs: s and p.v forward; s, dp
    # and ds.k for dq; s, dp, p^T.do and ds^T.q for dk/dv.
    flops = {"fwd": 4 * bh * s * s * d // 2,
             "dq": 6 * bh * s * s * d // 2,
             "dkv": 8 * bh * s * s * d // 2,
             "bwd": 10 * bh * s * s * d // 2}   # the fused kernel: five
    moved = {"fwd": 4 * tensor + 2 * stats,      # q k v in, o m l out
             "dq": 5 * tensor + 2 * stats,       # q k v do lse delta, dq
             "dkv": 6 * tensor + 2 * stats,      # ... dk dv out
             "bwd": 7 * tensor + 2 * stats}      # ... dq dk dv out
    peak = PEAK_FLOPS[str(dtype)[6:]]
    rows = {}
    for fn in kernels:
        # The tf32 design does three tf32 products where fp32 does one:
        # its bound is those at the tf32 rate; the FMA-rate bound of the
        # fp32 products rides along (bound_fma_ms).
        tf32 = designs[fn] == "tf32"
        op_ms = (3 * flops[fn] / PEAK_TF32_FLOPS if tf32
                 else flops[fn] / peak) * 1e3
        byte_ms = moved[fn] / PEAK_BYTES_PER_S * 1e3
        row = dict(
            ms=ms[fn], plain_ms=plain[fn],
            library_ms=lib_fwd if fn == "fwd" else lib_fwd_bwd,
            bound_ms=max(op_ms, byte_ms),
            bound_by="operations" if op_ms >= byte_ms else "bytes",
            flops=flops[fn])
        if tf32:
            row["bound_fma_ms"] = max(flops[fn] / peak * 1e3, byte_ms)
            row["prepass_ms"] = prepass[fn]
        if tf32:
            part = {"fwd": fa.tf32_fwd_part, "dq": fa.tf32_dq_part,
                    "dkv": fa.tf32_dkv_part}[fn](
                        fa.padded_head_dim(d, "tf32", fn))
            row["part_cols"] = part
            row["build"] = (TF32_NARROW_BUILDS[fn] if d <= 32
                            else TF32_BUILDS[fn][part])
        if fn != "fwd":
            row["library_bwd_only_ms"] = lib_bwd
        # The dtype and head dim of the call, which name the LM path
        # whose launches the row carries.
        row["call"] = (str(dtype)[6:], d)
        rows[kernel_name(fa, fn, designs[fn], tag)] = row
    if design is None and prep:
        # The pre-pass: o, do, m, l read, lse and delta written; a multiply
        # and an add a value of o and do, on the fp32 pipe.
        n = fa._fused_bwd_counters(q) if fa._fused_bwd(dtype, d) else 0
        prep_ms = time_ms(lambda: fa._bwd_prep(o, do, m, l, n), 20)
        op_ms = 2 * b * s * h * d / PEAK_FLOPS["float32"] * 1e3
        byte_ms = (2 * tensor + 4 * stats) / PEAK_BYTES_PER_S * 1e3
        rows[kernel_name(fa, "bwd", "prep", tag)] = dict(
            ms=prep_ms,
            plain_ms=time_ms(lambda: fa._bwd_stats_plain(o, do, m, l), 20),
            library_ms=None, bound_ms=max(op_ms, byte_ms),
            bound_by="operations" if op_ms >= byte_ms else "bytes",
            flops=2 * b * s * h * d, call=(str(dtype)[6:], d))
    del q, k, v, do, o, qt, kt, vt, dot, qg, kg, vg, out
    torch.cuda.empty_cache()
    return rows


def kernel_times(torch, fa):
    """Every kernel's row: the sm90 kernels at the main path's shape in
    bf16, the entry's shape's kernels (phase 4d), the fp32 ones at the
    main shape (the tf32 forward, dq and dk/dv, and the simt ones beside
    them), each C4 case at its shape and the Gemma-7B geometry, with the
    simt kernel beside every case that a tensor-core one serves. Prints
    the tensor-core rows against their simt ones (and the tf32
    backward's against SDPA's backward, the plain version and the
    bound), the rows at D <= 32, simt and tensor-core, against SDPA, and
    the narrow sm90 forward's rows (C4, the entry's shape) beside SDPA,
    the bound and their times before the kv tiles were split among
    warpgroups."""
    rows = {}
    rows.update(kernel_rows(torch, fa, **MAIN, dtype=torch.bfloat16))
    # The entry's shape (phase 4d), the kernels its path runs.
    rows.update(kernel_rows(torch, fa, **ENTRY, dtype=torch.bfloat16,
                            tag="entry"))
    rows.update(kernel_rows(torch, fa, **MAIN, dtype=torch.float32,
                            prep=False))
    rows.update(kernel_rows(torch, fa, **MAIN, dtype=torch.float32,
                            design="simt"))
    pairs = [(None, torch.float32, MAIN["d"], kern) for kern in fa.KERNELS]
    cases = [(tag, getattr(torch, dt), dict(C4_SHAPE, d=d))
             for tag, dt, d in C4_CASES]
    cases.append(("gemma", torch.bfloat16, GEMMA))
    for tag, dtype, shape in cases:
        rows.update(kernel_rows(torch, fa, **shape, dtype=dtype, tag=tag))
        tc = tensor_core_kernels_of(fa, dtype, shape["d"])
        if tc:
            rows.update(kernel_rows(torch, fa, **shape, dtype=dtype,
                                    design="simt", kernels=tc, tag=tag))
            pairs += [(tag, dtype, shape["d"], kern) for kern in tc]
    print("tensor-core kernels against the simt kernels they replace, same "
          "inputs (ms of the card, CUDA-event means of 20 launches; the "
          "stream dq and the tf32 backward (with its pre-pass) beside "
          "SDPA's backward alone, the plain version and the bound, for "
          "tf32 3xTF32 / FMA; the tf32 forward (with its pre-pass) beside "
          "SDPA's forward, its pre-pass alone and its build):")
    slower = []
    for tag, dtype, d, kern in pairs:
        design = fa._design(dtype, d, kern)
        row = rows[kernel_name(fa, kern, design, tag)]
        new, old = row["ms"], rows[kernel_name(fa, kern, "simt", tag)]["ms"]
        more = ""
        if design in ("stream", "tf32") and kern != "fwd":
            more = (f"  SDPA bwd {row['library_bwd_only_ms']:.4f} "
                    f"({new / row['library_bwd_only_ms']:.2f}x)  plain "
                    f"{row['plain_ms']:.3f}  bound {row['bound_ms']:.4f}")
        if design == "tf32" and kern != "fwd":
            more += (f" / {row['bound_fma_ms']:.4f}  pre-pass "
                     f"{row['prepass_ms']:.4f}")
        if design == "tf32" and kern != "fwd":
            more += (f"  {row['part_cols']}-column parts" if d > 32
                     else f"  narrow build of {row['part_cols']}")
        if design == "tf32" and kern == "fwd":
            build = (f"{row['part_cols']}-column parts" if d > 32
                     else f"narrow build of {row['part_cols']}")
            more = (f"  SDPA {row['library_ms']:.4f} "
                    f"({new / row['library_ms']:.2f}x)  pre-pass "
                    f"{row['prepass_ms']:.4f}  {build}  bound "
                    f"{row['bound_ms']:.4f} / {row['bound_fma_ms']:.4f}")
        print(f"  {tag or 'main fp32':<10} {kern:<4} {design:<6} {new:8.4f}  "
              f"simt {old:8.4f}  {old / new:6.1f}x{more}")
        if not new < old:
            slower.append((tag, kern))
    print("kernels at D <= 32 against SDPA (forward; backward alone), ms: "
          "the simt kernel, and the tensor-core one where it serves:")
    for tag, dtype, shape in cases:
        if shape["d"] > 32:
            continue
        for kern in fa.KERNELS:
            design = fa._design(dtype, shape["d"], kern)
            line = f"  {tag:<10} {kern:<4}"
            for des in dict.fromkeys(("simt", design)):
                row = rows[kernel_name(fa, kern, des, tag)]
                lib = row["library_ms" if kern == "fwd" else
                          "library_bwd_only_ms"]
                line += (f"  {des} {row['ms']:8.4f} ({row['ms'] / lib:.2f}x "
                         f"SDPA {lib:.4f})")
            print(f"{line}  bound {row['bound_ms']:.4f}")
    for tag, was in RECORDED_NARROW_FWD_MS.items():
        row = rows[kernel_name(fa, "fwd", "sm90", tag)]
        print(f"  narrow forward {tag:<8} {row['ms']:.4f} ms ("
              f"{row['ms'] / row['library_ms']:.2f}x SDPA "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}; "
              f"recorded before the split: {was} ms, {row['ms'] / was:.3f}x)")
    for name, was in RECORDED_MAIN_MS.items():
        print(f"  main shape {name}: {rows[name]['ms']:.4f} ms (recorded "
              f"before: {was} ms, {rows[name]['ms'] / was:.3f}x)")
    backward_pad_times(torch, fa)
    slower += tf32_route_times(torch, fa)
    print("the sm90 dq and dk/dv together, and the fused backward where it "
          "serves (16-bit D 33-128), against SDPA's backward alone, same "
          "inputs (ms; the fused kernel's bound of five products):")
    for tag, dtype, shape in [(None, torch.bfloat16, MAIN)] + cases:
        names = [kernel_name(fa, kern, fa._design(dtype, shape["d"], kern),
                             tag) for kern in ("dq", "dkv")]
        if shape["d"] <= 32 or not all("_sm90" in n for n in names):
            continue
        dq, dkv = (rows[n] for n in names)
        lib = dq["library_bwd_only_ms"]
        line = (f"  {tag or 'main':<10} dq {dq['ms']:.4f} + dk/dv "
                f"{dkv['ms']:.4f} = {dq['ms'] + dkv['ms']:.4f}  SDPA bwd "
                f"{lib:.4f} ({(dq['ms'] + dkv['ms']) / lib:.2f}x)")
        fused = rows.get(kernel_name(fa, "bwd", "sm90", tag))
        if fused:
            line += (f"; fused {fused['ms']:.4f} ({fused['ms'] / lib:.2f}x "
                     f"SDPA, {fused['ms'] / (dq['ms'] + dkv['ms']):.3f}x the "
                     f"pair; bound {fused['bound_ms']:.4f}, "
                     f"{fused['bound_ms'] / fused['ms']:.1%} of it)")
        print(line)
    bwd_route_times(torch, fa)
    if slower:
        raise AssertionError(f"tensor-core kernels slower than the simt "
                             f"ones they replace: {slower}")
    return rows


# Phase 5's fp32 backward route (``fa._flash_bwd``: one pre-pass, then the
# tf32 dq and dk/dv): (tag, shape) at the C4 shape's D 16 and 32 (the
# narrow builds), D 256-640 (the wide dq and dk/dv) and the main shape.
TF32_ROUTES = tuple((f"fp32_d{d}", dict(C4_SHAPE, d=d))
                    for d in (16, 32, 256, 320, 384, 512, 640)) + (
    ("main fp32", MAIN),)


def tf32_route_times(torch, fa):
    """The fp32 backward route as ``fa._flash_bwd`` runs it (one pre-pass,
    then the tf32 dq and dk/dv; TF32_ROUTES), CUDA-event means of 20
    calls, against SDPA's backward alone on the same inputs, with the
    pre-pass alone and the builds of dq and dk/dv beside it, and at D <=
    32 the simt dq and dk/dv the narrow builds replaced; returns the cases
    where the route is not faster than those simt kernels."""
    import torch.nn.functional as F
    print("the fp32 backward route (_flash_bwd: pre-pass, dq, dk/dv) "
          "against SDPA's backward alone, same inputs (ms):")
    slower = []
    for tag, shape in TF32_ROUTES:
        d = shape["d"]
        q, k, v, do, o, m, l = _c4_backward(torch, fa, torch.float32, d,
                                            shape)
        lse, delta = _bwd_stats(fa, do, o, m, l)
        args = (q, k, v, do, lse, delta, True, 0, 0)
        if {fa._design(torch.float32, d, kern) for kern in ("dq", "dkv")} \
                != {"tf32"}:
            raise AssertionError(f"{tag}: dq and dk/dv should run tf32")
        route = time_ms(lambda: fa._flash_bwd(*args), 20)
        pre = time_ms(lambda: fa._tf32_bwd_split(q, k, v, do), 20)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in
                           (q, k, v, do))
        qg, kg, vg = (x.requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), 20)
        built = fa.padded_head_dim(d, "tf32", "dq")
        line = (f"  {tag:<10} route {route:.4f} ({route / sdpa:.2f}x SDPA "
                f"bwd {sdpa:.4f}; pre-pass {pre:.4f} of it; dq "
                f"{fa.tf32_dq_part(built)}-column parts, dk/dv "
                f"{fa.tf32_dkv_part(built)})")
        if d <= 32:
            simt = (time_ms(lambda: fa._launch("dq", "simt", args[:4],
                                               *args[4:]), 20)
                    + time_ms(lambda: fa._launch("dkv", "simt", args[:4],
                                                 *args[4:]), 20))
            line += (f"  simt dq + dk/dv {simt:.4f} ({simt / route:.1f}x "
                     f"the route)")
            if not route < simt:
                slower.append((tag, "route"))
        print(line, flush=True)
        del q, k, v, do, o, m, l, qt, kt, vt, dot, qg, kg, vg, out
        torch.cuda.empty_cache()
    return slower


# Phase 5's 16-bit backward route as flash_attention_bwd runs it, against
# SDPA's backward alone and the parent's route: (tag, shape) at the main
# shape, Phi-3-mini's (D 96), the C4 shape at bf16 D 80 (the fused
# backward) and Gemma-7B's (D 256: the sm90 dq and dk/dv).
BWD_ROUTES = (("main", MAIN), ("phi3", PHI3), ("bf16_d80", dict(C4_SHAPE, d=80)),
              ("gemma", GEMMA))


def bwd_route_times(torch, fa):
    """flash_attention_bwd whole at bf16 (the pre-pass, then the fused
    backward or the sm90 dq and dk/dv; BWD_ROUTES), CUDA-event means of 20
    calls, against SDPA's backward alone on the same inputs and against
    the route before the fused kernel and the pre-pass (torch's lse and
    delta, then the sm90 dq and dk/dv: ``_flash_bwd`` with the pair's
    launchers alone), in turns in this run; the pre-pass alone beside
    them."""
    import torch.nn.functional as F
    pair = {key: fn for key, fn in fa._LAUNCHERS.items()
            if key != ("bwd", "sm90")}
    print("the bf16 backward route (flash_attention_bwd: pre-pass, then the "
          "fused backward or dq and dk/dv) against SDPA's backward alone and "
          "the route before (torch's lse and delta, then the sm90 dq and "
          "dk/dv), same inputs (ms):")
    for tag, shape in BWD_ROUTES:
        d = shape["d"]
        q, k, v, do, o, m, l = _c4_backward(torch, fa, torch.bfloat16, d,
                                            shape)

        def route():
            return fa.flash_attention_bwd(q, k, v, o, m, l, do)

        def before():
            lse, delta = fa._bwd_stats_plain(o, do, m, l)
            return fa._flash_bwd(q, k, v, do, lse, delta, True, 0, 0,
                                 launchers=pair)
        t = [time_ms(f, 20) for f in (route, before, before, route)]
        now, was = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        n = fa._fused_bwd_counters(q) if fa._fused_bwd(q.dtype, d) else 0
        pre = time_ms(lambda: fa._bwd_prep(o, do, m, l, n), 20)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in
                           (q, k, v, do))
        qg, kg, vg = (x.requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), 20)
        kind = "fused" if n else "dq + dk/dv"
        print(f"  {tag:<10} B{shape['b']} S{shape['s']} H{shape['h']} D{d} "
              f"({kind}): route {now:.4f} ({now / sdpa:.2f}x SDPA bwd "
              f"{sdpa:.4f}; pre-pass {pre:.4f} of it); before {was:.4f} "
              f"({was / sdpa:.2f}x; {was / now:.3f}x the route)", flush=True)
        del q, k, v, do, o, m, l, qt, kt, vt, dot, qg, kg, vg, out
        torch.cuda.empty_cache()


def _c4_backward(torch, fa, dtype, d, shape=C4_SHAPE):
    """Phase 5's backward inputs at the C4 shape (or ``shape``'s B, S and
    H) and head dim d: q, k, v, do and the forward's o, m, l."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(shape["b"], shape["s"], shape["h"], d,
                               generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    return (q, k, v, do, *fa._flash_fwd(q, k, v, True, 0, 0))


def _bwd_stats(fa, do, o, m, l):
    """lse and delta as flash_attention_bwd makes them: the pre-pass."""
    return fa._bwd_prep(o, do, m.float(), l.float())[:2]


def _bit_equal(torch, label, mine, theirs):
    for a, b in zip(mine, theirs):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: gradients differ by "
                f"{(a.float() - b.float()).abs().max().item()}")


def backward_pad_times(torch, fa):
    """The backward as flash_attention_bwd runs it at the C4 shape, with
    the lse and delta pre-pass, CUDA-event means of 20 calls:
    - where it pads (BWD_PADDED: q, k, v and do zero-padded once for dq
      and dk/dv), against the two kernels launched apart through
      fa._launch, each padding its own copies;
    - where the sm90 backward reads the caller's tensors (BWD_IN_PLACE:
      the fused backward at bf16 D 80 and 96, the sm90 dq and dk/dv at D
      200), against the same builds on copies padded once to them with
      the true D's scale and sliced back (the route before they read in
      place), and each kernel in place against that padded route and
      against its build alone on copies padded beforehand (what the pad
      and slice copies cost, apart from the kernel).
    lse and delta come from the pre-pass, as flash_attention_bwd makes
    them. Each pair must give the same gradients bit for bit (one order of
    sums: each CTA owns its dk and dv, the fused kernel adds dq's parts in
    a fixed order; the padded columns are zeros either way), which holds
    the entry the model runs to the kernels that phase 2 checks one by
    one."""
    print("backward with a padded head dim: padded once against padded "
          "for each kernel apart (ms):")
    for tag, dt, d in BWD_PADDED:
        dtype = getattr(torch, dt)
        designs = {kern: fa._design(dtype, d, kern) for kern in ("dq", "dkv")}
        built = {fa._run_head_dim(d, designs[kern], kern) for kern in designs}
        if d in built or len(built) != 1:
            raise AssertionError(f"{tag}: expected one padded head dim for "
                                 f"dq and dk/dv, got {sorted(built)}")
        q, k, v, do, o, m, l = _c4_backward(torch, fa, dtype, d)

        def apart():
            lse, delta = _bwd_stats(fa, do, o, m, l)
            dq, (dk, dv) = (fa._launch(kern, designs[kern], (q, k, v, do),
                                       lse, delta, True, 0, 0)
                            for kern in ("dq", "dkv"))
            return dq, dk, dv
        def once():
            return fa.flash_attention_bwd(q, k, v, o, m, l, do)
        _bit_equal(torch, f"{tag}: the backward padded once against the "
                   f"kernels padded apart", once(), apart())
        once_ms, apart_ms = time_ms(once, 20), time_ms(apart, 20)
        print(f"  {tag:<10} {designs['dq']} at {sorted(built)}: once "
              f"{once_ms:.4f}, apart {apart_ms:.4f} "
              f"({apart_ms / once_ms:.2f}x)")
        del q, k, v, do, o, m, l
    print("backward in place against padded once to the same build (ms; "
          "each kernel in place (the fused backward at D 80 and 96), padded "
          "with its copies, and its build alone on copies padded "
          "beforehand):")
    for tag, dt, d in BWD_IN_PLACE:
        dtype = getattr(torch, dt)
        # The fused backward at 16-bit D 33-128, the sm90 dq and dk/dv past
        # it.
        fns = ({"bwd": fa._flash_bwd_sm90} if fa._fused_bwd(dtype, d) else
               {"dq": fa._flash_dq_sm90, "dkv": fa._flash_dkv_sm90})
        if not all(fa._reads_in_place(d, "sm90", kern) for kern in fns):
            raise AssertionError(f"{tag}: the sm90 backward should read the "
                                 f"caller's tensors")
        built = fa.padded_head_dim(d, "sm90", next(iter(fns)))
        q, k, v, do, o, m, l = _c4_backward(torch, fa, dtype, d)
        lse, delta = _bwd_stats(fa, do, o, m, l)
        padded = fa._pad_head_dim((q, k, v, do), built)
        scale = fa._softmax_scale(d)
        args = (lse, delta, True, 0, 0)

        def padded_once():
            lse, delta = _bwd_stats(fa, do, o, m, l)
            cut = fa._pad_head_dim((q, k, v, do), built)
            outs = [fa._at_head_dim(fn, cut, d, lse, delta, True, 0, 0)
                    for fn in fns.values()]
            if len(outs) == 1:
                return outs[0]
            dq, (dk, dv) = outs
            return dq, dk, dv

        def in_place():
            return fa.flash_attention_bwd(q, k, v, o, m, l, do)
        _bit_equal(torch, f"{tag}: the backward in place against padded "
                   f"once", in_place(), padded_once())
        line = (f"  {tag:<10} at {built}: in place "
                f"{time_ms(in_place, 20):.4f}, padded once "
                f"{time_ms(padded_once, 20):.4f};")
        for kern, fn in fns.items():
            mine = time_ms(lambda: fa._launch(kern, "sm90", (q, k, v, do),
                                              *args), 20)
            pad = time_ms(lambda: fa._at_head_dim(
                fn, fa._pad_head_dim((q, k, v, do), built), d, *args), 20)
            alone = time_ms(lambda: fn(*padded, *args, scale=scale), 20)
            line += (f"  {kern if kern != 'bwd' else 'fused'} {mine:.4f} "
                     f"(padded {pad:.4f}, build alone {alone:.4f})")
        print(line)
        del q, k, v, do, o, m, l, padded
    torch.cuda.empty_cache()


# The full-width LM of phase 4 (bench.py's), at a depth given per phase.
LM_FULL = dict(vocab_size=32000, num_heads=16, head_dim=128,
               max_seq_len=MAIN["s"])
# Eager steps of phases 10 and 11 (and of phase 9's whole-batch
# reference): a mask may speculate only after a pure-hit cycle of that
# mask was granted in full, so steps 1-2 learn the steady sets and steps
# 3-5 may run speculative cycles.
WORLD_STEPS = 5
# Rounds of phase 10's and 11's ready-event check under one name.
READY_ROUNDS = 5


def check_timeline(path, required):
    """The timeline file at ``path`` must hold every event name in
    ``required``."""
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)}
    missing = [n for n in required if n not in names]
    print(f"  timeline: {len(names)} event names; holds "
          f"{', '.join(required)}: "
          f"{'ok' if not missing else 'FAIL, missing ' + str(missing)}")
    if missing:
        raise AssertionError(f"timeline {path} lacks {missing}")


def timed_steps(step, n):
    """Runs ``n`` steps, each ended by its loss's ``.item()``; returns
    the losses and each step's host seconds."""
    losses, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(step().item())
        secs.append(time.perf_counter() - t0)
    return losses, secs


def runtime_counts():
    from horovod_tpu_torch.common import basics
    return dict(basics.runtime().stats)


def print_negotiation(before, after, steps):
    """Prints the runtime's counts per step; returns them per step:
    cycles, cached_cycles, spec_cycles, responses, busy_ms (the loop's
    negotiation and execution, burst holds left out) and by_backend."""
    d = {k: after[k] - before.get(k, 0) for k in after}
    per_cycle_ms = d["negotiate_s"] / max(1, d["cycles"]) * 1e3
    negotiate_ms, execute_ms = (d["negotiate_s"] / steps * 1e3,
                                d["execute_s"] / steps * 1e3)
    by_backend = {k.split(".", 1)[1]: v / steps for k, v in d.items()
                  if k.startswith("responses.") and v}
    print(f"  runtime: {d['cycles'] / steps:.1f} cycles per step "
          f"({d['cached_cycles'] / steps:.1f} cached, "
          f"{d['spec_cycles'] / steps:.1f} speculative; "
          f"{d['spec_bids'] / steps:.1f} bids, {d['spec_denials']} denied), "
          f"{d['responses'] / steps:.1f} responses per step "
          f"({', '.join(f'{k} {v:.1f}' for k, v in by_backend.items())}), "
          f"{d['tensors'] / max(1, d['responses']):.2f} tensors per "
          f"response, negotiation {per_cycle_ms:.3f} ms per cycle; the "
          f"loop's thread busy {negotiate_ms + execute_ms:.1f} ms per step "
          f"(negotiation {negotiate_ms:.1f}, execution {execute_ms:.1f}), "
          f"burst holds {d['hold_s'] / steps * 1e3:.1f} ms per step; cache "
          f"hits {d['cache_hits']}, misses {d['cache_misses']}, evictions "
          f"{d['cache_evictions']}")
    return {"cycles": d["cycles"] / steps,
            "cached_cycles": d["cached_cycles"] / steps,
            "spec_cycles": d["spec_cycles"] / steps,
            "responses": d["responses"] / steps,
            "busy_ms": negotiate_ms + execute_ms, "by_backend": by_backend}


class HostLoad:
    """``k`` Python processes spinning on this process's CPUs
    (``os.sched_setaffinity``), started and stopped by the caller: the
    controlled host load of phase 9. A spinner that is not running when
    it is stopped is a failure."""

    def __init__(self, k: int):
        self.cpus = sorted(os.sched_getaffinity(0))
        code = (f"import os; os.sched_setaffinity(0, {self.cpus!r})\n"
                f"while True: pass")
        self.procs = [subprocess.Popen([sys.executable, "-c", code])
                      for _ in range(k)]

    def stop(self):
        dead = [p.poll() for p in self.procs if p.poll() is not None]
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if dead:
            raise AssertionError(f"a load process ended early: exit "
                                 f"codes {dead}")


def eager_run(torch, hvd, bench, cfg, args, cache: bool, profile=False):
    """One ``hvd.init()`` with the response cache on (the default) or
    off (HOROVOD_CACHE_CAPACITY=0), 5 eager steps of the full-width LM;
    returns (losses, seconds per step, parameters, runtime counts before
    and after, profile or None)."""
    if not cache:
        os.environ["HOROVOD_CACHE_CAPACITY"] = "0"
    hvd.init()
    try:
        step, model = bench.transformer_step(cfg, MAIN["b"], seed=args.seed,
                                             eager=True)
        torch.cuda.synchronize()
        before = runtime_counts()
        losses, secs = timed_steps(step, 5)
        after = runtime_counts()
        params = [p.detach().clone() for p in model.parameters()]
        prof = profiled_step(torch, step) if profile else None
        del step, model
    finally:
        hvd.shutdown()
        os.environ.pop("HOROVOD_CACHE_CAPACITY", None)
    torch.cuda.empty_cache()
    return losses, secs, params, before, after, prof


def eager_runtime_phase(torch, hvd, args, card, workdir):
    """Phase 9: the eager (hook-driven, negotiated) optimizer against the
    in-step one at full width on one card, with the response cache off
    and on, on a quiet host and under a controlled load; returns phase
    10's whole-batch reference (losses, initial and final parameters on
    the host)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import TransformerConfig
    timeline = os.path.join(workdir, "timeline_size1.json")
    cfg = TransformerConfig(num_layers=args.layers, dtype=torch.bfloat16,
                            **LM_FULL)
    b = MAIN["b"]
    hvd.init()
    try:
        step, model = bench.transformer_step(cfg, b, seed=args.seed)
        torch.cuda.synchronize()
        losses0, secs0 = timed_steps(step, 5)
        params0 = [p.detach().clone() for p in model.parameters()]
        prof0 = profiled_step(torch, step)
        del step, model
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    print(f"eager runtime, size 1: L{cfg.num_layers} d{cfg.embed_dim} "
          f"S{cfg.max_seq_len} B{b} V{cfg.vocab_size}, 5 steps each from "
          f"seed {args.seed}  [{card}]")
    print(f"  in-step  losses {' '.join(f'{x:.6f}' for x in losses0)}; "
          f"sec/step {statistics.median(secs0[1:]):.4f} (median of steps "
          f"2-5; step 1 {secs0[0]:.3f})")
    print_breakdown(*prof0, LM_GROUPS)
    del prof0
    rows = []
    for load in (0, 2):
        for cache in (False, True):
            label = (f"eager, cache {'on' if cache else 'off'}, "
                     f"{f'{load} spinners' if load else 'quiet'}")
            quiet_on = cache and not load
            if quiet_on:
                os.environ.update(HOROVOD_TIMELINE=timeline,
                                  HOROVOD_TIMELINE_MARK_CYCLES="1")
            spin = HostLoad(load) if load else None
            try:
                losses, secs, params, before, after, prof = eager_run(
                    torch, hvd, bench, cfg, args, cache, profile=quiet_on)
            finally:
                if spin is not None:
                    spin.stop()
                for k in ("HOROVOD_TIMELINE",
                          "HOROVOD_TIMELINE_MARK_CYCLES"):
                    os.environ.pop(k, None)
            sec = statistics.median(secs[1:])
            print(f"  {label}: losses "
                  f"{' '.join(f'{x:.6f}' for x in losses)}; sec/step "
                  f"{sec:.4f} (median of steps 2-5; step 1 {secs[0]:.3f})"
                  + (f"; load on CPUs {spin.cpus}" if spin else ""))
            per = print_negotiation(before, after, 5)
            if prof is not None:
                print_breakdown(*prof, LM_GROUPS)
            same = losses == losses0 and all(
                torch.equal(a, c) for a, c in zip(params0, params))
            print(f"    eager == in-step (5 losses, {len(params0)} "
                  f"parameters): {'ok' if same else 'FAIL'}")
            if not same:
                worst = max((a - c).abs().max().item()
                            for a, c in zip(params0, params))
                raise AssertionError(
                    f"{label}: the eager steps differ from the in-step "
                    f"ones: losses {losses0} vs {losses}, largest "
                    f"parameter difference {worst:.3e}")
            rows.append((label, sec, per))
            if quiet_on:
                on = per
            del params
            torch.cuda.empty_cache()
    print("  phase 9 summary (per step): cycles, cached cycles, "
          "responses, the loop's busy ms, seconds")
    for label, sec, per in rows:
        print(f"    {label:<30} {per['cycles']:7.1f} "
              f"{per['cached_cycles']:7.1f} {per['responses']:7.1f} "
              f"{per['busy_ms']:8.1f} {sec:.4f}")
    if not on["cached_cycles"] > 0:
        raise AssertionError("the cache-on eager steps ran no cached cycle")
    check_timeline(timeline, ("NEGOTIATE_ALLREDUCE", "NEGOTIATE_CACHED",
                              "ALLREDUCE", "QUEUE", "COLLECTIVE",
                              "CYCLE_START"))
    del params0
    # Phase 10's reference: one rank, the whole batch of 4, 5 steps.
    hvd.init()
    try:
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        step, model = bench.transformer_step(cfg2, 4, seed=args.seed,
                                             eager=True)
        init = [p.detach().to("cpu", copy=True) for p in model.parameters()]
        losses, _ = timed_steps(step, WORLD_STEPS)
        ref = (losses, init, [p.detach().to("cpu", copy=True)
                             for p in model.parameters()])
        del step, model
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    return ref


def world_check(torch, label, got, want):
    ok = (got.dtype == want.dtype and got.device == want.device
          and got.shape == want.shape and torch.equal(got, want))
    print(f"    {label:<40} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: got {got} want {want}")


def two_rank_world(torch, hvd, args, rank, port, workdir, ref=None,
                   mode="star", star_run=None):
    """Phases 10 (``mode="star"``) and 11 (``"plane"``), run by both
    ranks of a world of two on one card. Only the runtime's ops run (NCCL
    refuses two ranks on one device). Phase 10 takes the process-group
    plane out of the backend list on both ranks before any CUDA op, so
    that the socket star carries the CUDA tensors; phase 11 leaves it in,
    and the ranks agree on its gloo rendering at the first CUDA op.
    Rank 0 returns (the ranks' losses, its parameters, the step
    numbers); phase 11 holds them to phase 10's (``star_run``)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                      HOROVOD_CONTROLLER_PORT=str(port))
    timeline = os.path.join(workdir, f"timeline_size2_{mode}.json")
    if rank == 0:
        os.environ.update(HOROVOD_TIMELINE=timeline,
                          HOROVOD_TIMELINE_MARK_CYCLES="1")
    hvd.init()
    try:
        rt = basics.runtime()
        if mode == "star":
            rt.op_manager.backends = [b for b in rt.op_manager.backends
                                      if b.name != "process_group"]
        star = next(b for b in rt.op_manager.backends if b.name == "socket")
        plane = next((b for b in rt.op_manager.backends
                      if b.name == "process_group"), None)
        star_bytes = (star.bytes_to_host, star.bytes_from_host)
        dev = torch.device("cuda", torch.cuda.current_device())
        via = "the socket star" if mode == "star" else \
            "the process-group plane"
        print(f"two-rank world through {via}: rank {hvd.rank()} of "
              f"{hvd.size()} on {dev}")
        print("  collectives on CUDA tensors, against closed forms:")
        c = lambda *a: world_check(torch, *a)  # noqa: E731
        x = torch.full((4, 3), float(rank + 1), device=dev)
        c("allreduce sum fp32", hvd.allreduce(x, op=hvd.Sum, name="w.ar"),
          torch.full((4, 3), 3.0, device=dev))
        c("allreduce average fp32", hvd.allreduce(x, name="w.avg"),
          torch.full((4, 3), 1.5, device=dev))
        xb = (torch.arange(64, device=dev) + rank).bfloat16()
        c("allreduce sum bf16", hvd.allreduce(xb, op=hvd.Sum, name="w.bf"),
          (2 * torch.arange(64, device=dev) + 1).bfloat16())
        c("allgather, dim 0 of 1 and 2 rows",
          hvd.allgather(torch.full((rank + 1, 2), float(rank), device=dev),
                        name="w.ag"),
          torch.tensor([[0.0, 0], [1, 1], [1, 1]], device=dev))
        c("broadcast from rank 1, fp64",
          hvd.broadcast(torch.full((3, 3), rank * 10.0, device=dev,
                                   dtype=torch.float64), 1, name="w.bc"),
          torch.full((3, 3), 10.0, device=dev, dtype=torch.float64))
        c("alltoall", hvd.alltoall(torch.arange(4.0, device=dev)
                                   + 100 * rank, name="w.a2a"),
          torch.tensor([0.0, 1, 100, 101], device=dev) + 2 * rank)
        c("reducescatter", hvd.reducescatter(
            torch.arange(6.0, device=dev) * (rank + 1), name="w.rs"),
          torch.arange(6.0, device=dev)[3 * rank:3 * rank + 3] * 3)
        outs = hvd.grouped_allreduce(
            [torch.full((16 + i,), (rank + 1.0) * (i + 1), device=dev)
             for i in range(6)], op=hvd.Sum, name="w.grp")
        for i, o in enumerate(outs):
            c(f"grouped member {i} (one fused response)", o,
              torch.full((16 + i,), 3.0 * (i + 1), device=dev))

        print("  negative probe: float32 on rank 0, float64 on rank 1")
        try:
            hvd.allreduce(torch.ones(3, device=dev,
                                     dtype=(torch.float32, torch.float64)
                                     [rank]), name="w.mm")
        except hvd.HorovodInternalError as e:
            print(f"    raised on rank {rank}: {str(e)[:70]}")
        else:
            raise AssertionError("mismatched dtypes did not raise")
        c("the world works afterwards", hvd.allreduce(
            torch.ones(3, device=dev), op=hvd.Sum, name="w.after"),
          torch.full((3,), 2.0, device=dev))
        if plane is not None:
            print(f"    the plane's agreed rendering: {plane.rendering}")
            if plane.rendering != "gloo":
                raise AssertionError(f"two ranks on one card must render "
                                     f"with gloo, not {plane.rendering}")

        print(f"  ready event: 16 chained 8192^2 x 256 fp32 matmuls write x "
              f"right before allreduce_async, {READY_ROUNDS} times under "
              f"one name (the later rounds replay from the response cache"
              f"{', speculatively' if mode == 'star' else ''})")
        g = torch.Generator(device=dev).manual_seed(args.seed + 7)
        a = torch.randn(8192, 8192, generator=g, device=dev) / 90.5
        y0 = torch.randn(8192, 256, generator=g, device=dev)
        spec0 = runtime_counts()["spec_cycles"]
        for i in range(READY_ROUNDS):
            torch.cuda.synchronize()
            y = y0 * (i + 1)
            for _ in range(16):
                y = torch.tanh(a @ y)
            x = y[:, 0] * (rank + 1)
            busy = not torch.cuda.current_stream().query()
            h = hvd.allreduce_async(x, op=hvd.Sum, name="w.ready")
            got = hvd.synchronize(h).clone()
            torch.cuda.synchronize()
            xs = hvd.allgather(x.cpu()[None], name="w.ready.x")
            c(f"round {i + 1}: the stream busy at the enqueue ({busy}), the "
              f"result the matmuls'", got, (xs[0] + xs[1]).to(dev))
            if not busy:
                raise AssertionError("the matmuls ended before the "
                                     "enqueue: the check would show nothing")
        spec = runtime_counts()["spec_cycles"] - spec0
        print(f"    speculative cycles in these rounds: {spec}")
        if mode == "star" and not spec > 0:
            raise AssertionError("no round ran a speculative cycle: the "
                                 "ready event of its pack went unchecked")

        print(f"  the LM at full width, depth 2, 2 rows per rank, "
              f"{WORLD_STEPS} eager steps:")
        cfg = TransformerConfig(num_layers=2, dtype=torch.bfloat16,
                                **LM_FULL)
        step, model = bench.transformer_step(cfg, 2, seed=args.seed,
                                             eager=True)
        torch.cuda.synchronize()
        before = runtime_counts()
        to_host, from_host = star.bytes_to_host, star.bytes_from_host
        losses, secs = timed_steps(step, 2)
        middle = runtime_counts()
        more, more_secs = timed_steps(step, WORLD_STEPS - 2)
        losses, secs = losses + more, secs + more_secs
        print(f"    losses {' '.join(f'{v:.6f}' for v in losses)}; sec/step "
              f"{' '.join(f'{v:.3f}' for v in secs)}")
        # A speculative bid the world answers the classic way is packed
        # again: its first pack's bytes are left out of the comparison
        # with phase 12's (printed beside them).
        unused = runtime_counts()["spec_unused_bytes"] \
            - before["spec_unused_bytes"]
        to_host_total = star.bytes_to_host - to_host - unused
        print(f"    star bytes card->host "
              f"{(star.bytes_to_host - to_host) / WORLD_STEPS:.4g} "
              f"({unused / WORLD_STEPS:.4g} of them in unused speculative "
              f"bids) and "
              f"host->card "
              f"{(star.bytes_from_host - from_host) / WORLD_STEPS:.4g} per "
              f"step")
        per_step = print_negotiation(before, runtime_counts(), WORLD_STEPS)
        late = {k: runtime_counts()[k] - middle[k]
                for k in ("cached_cycles", "spec_cycles")}
        print(f"    steps 3-{WORLD_STEPS}: {late['cached_cycles']} cached "
              f"cycles, {late['spec_cycles']} speculative")
        if mode == "star" and not late["spec_cycles"] > 0:
            raise AssertionError("no speculative cycle in steps 3-5 "
                                 "through the star")
        if mode == "plane" and (late["spec_cycles"] != 0
                                or not late["cached_cycles"] > 0):
            raise AssertionError("through the plane the steps must run "
                                 "cached cycles and no speculative one")
        if plane is not None:
            moved = (star.bytes_to_host - star_bytes[0],
                     star.bytes_from_host - star_bytes[1])
            served = rt.stats.get("responses.process_group", 0)
            print(f"    CUDA bytes through the star since init: {moved} "
                  f"(must be 0); responses the plane served: {served}")
            if moved != (0, 0) or not served:
                raise AssertionError("a CUDA response went through the "
                                     "star, or none through the plane")
        params = [p.detach().to("cpu", copy=True) for p in model.parameters()]
        sums = torch.stack([p.double().sum() for p in params])
        every = hvd.allgather(sums[None], name="w.sums")
        all_losses = hvd.allgather(torch.tensor([losses]), name="w.losses")
        del step, model
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                  "HOROVOD_CONTROLLER_ADDR", "HOROVOD_CONTROLLER_PORT",
                  "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES"):
            os.environ.pop(k, None)
    if rank != 0:
        return None
    # Under gloo the plane unpacks on a finalizer thread, which leaves
    # the loop's timeline be: no MEMCPY_OUT_FUSION_BUFFER there.
    check_timeline(timeline, ("NEGOTIATE_ALLREDUCE", "ALLREDUCE",
                              "MEMCPY_IN_FUSION_BUFFER", "CYCLE_START",
                              "NEGOTIATE_CACHED")
                   + (("MEMCPY_OUT_FUSION_BUFFER", "NEGOTIATE_CACHED_FUSED")
                      if mode == "star" else ()))
    run = (all_losses, params, (secs, per_step), to_host_total)
    if star_run is not None:
        s_losses, s_params, (s_secs, s_per), _ = star_run
        print(f"  plane against star: sec/step "
              f"{' '.join(f'{v:.3f}' for v in secs)} against "
              f"{' '.join(f'{v:.3f}' for v in s_secs)}; the loop busy "
              f"{per_step['busy_ms']:.1f} against {s_per['busy_ms']:.1f} ms "
              f"per step; {per_step['responses']:.1f} against "
              f"{s_per['responses']:.1f} responses per step")
        same = torch.equal(all_losses, s_losses) and all(
            torch.equal(a, b) for a, b in zip(params, s_params))
        print(f"  losses and parameters equal to phase 10's star run bit "
              f"for bit: {same}" + ("" if same else "; the phase-10 bounds "
                                     "against the whole batch hold "
                                     "instead (below)"))
        if same:
            return run
    ref_losses, ref_init, ref_after = ref
    mean = all_losses.mean(0).tolist()
    loss_err = max(abs(m - r) / abs(r) for m, r in zip(mean, ref_losses))
    ratio = max(((p - q).abs().max() / (q - i).abs().max()).item()
                for p, q, i in zip(params, ref_after, ref_init))
    same = torch.equal(every[0], every[1])
    print(f"  against one rank on the whole batch: losses "
          f"{' '.join(f'{v:.6f}' for v in ref_losses)}, the ranks' mean "
          f"within {loss_err:.2e} of them (bound 1e-4); every parameter "
          f"within {ratio:.2e} of its largest update (bound 2^-6 = "
          f"{2 ** -6:.2e}); the two ranks' parameters equal: {same}")
    if not (loss_err <= 1e-4 and ratio <= 2 ** -6 and same):
        raise AssertionError("the two-rank steps do not agree with the "
                             "whole-batch steps")
    return run


def start_rank1(args, port, workdir, mode):
    """Phase 10's or 11's rank 1: this script again, with its output in
    a log."""
    log = open(os.path.join(workdir, f"rank1_{mode}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed",
         str(args.seed), "--world-rank1", str(port), workdir, mode],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def world_of_two(torch, hvd, args, workdir, ref, mode, star_run=None):
    """Rank 0 here, rank 1 in a process of its own; returns rank 0's
    run."""
    port = free_port()
    rank1 = start_rank1(args, port, workdir, mode)
    try:
        run = two_rank_world(torch, hvd, args, 0, port, workdir, ref, mode,
                             star_run)
        rank1.wait(timeout=300)
    finally:
        if rank1.poll() is None:
            rank1.kill()
            rank1.wait()
    if rank1.returncode != 0:
        with open(os.path.join(workdir, f"rank1_{mode}.log")) as f:
            print(f.read()[-4000:])
        raise AssertionError(f"rank 1 exited with {rank1.returncode}")
    return run


# Phases 12 and 13 run their ranks as children of this script (the main
# process keeps no runtime of theirs): ``chip_smoke.py --child KIND RANK
# SIZE PORT DIR`` with KIND wire-bf16, wire-int8, abort-hang or
# abort-kill. The abort worlds take the heartbeat knobs of the
# reference's multi-process tests (tests/test_multiprocess.py:624-627).
ABORT_HB = {"HOROVOD_HEARTBEAT_INTERVAL": "0.3",
            "HOROVOD_HEARTBEAT_TIMEOUT": "3"}
# Detection latency a survivor may take past the heartbeat timeout: a
# ping slice, the 0.25 s sweep for a queued notice, the teardown, three
# processes sharing the card and the host.
ABORT_SLACK_S = 4.0
# Phase 12's steps under one name (the speculative cycle, or int8's
# error-feedback chain).
WIRE_STEADY = 6


def wire_inputs(torch, rank, size, seed):
    """Rank ``rank``'s phase-12 inputs on the CPU, from a seed: every
    rank makes every rank's, for the CPU codec's closed forms."""
    g = torch.Generator().manual_seed(seed * 1000 + rank)
    x = {"a": torch.randn(1 << 20, generator=g) * (rank + 1),
         "b": torch.randn(4099, generator=g),
         "g0": torch.randn(17, generator=g),
         "g1": torch.randn(1 << 16, generator=g) * 10,
         "g2": torch.randn(5, generator=g) * 1e-3,
         "d": torch.randn(5000, generator=g, dtype=torch.float64),
         "i": torch.randint(-1000, 1000, (50,), generator=g,
                            dtype=torch.int32),
         "ag": torch.randn(rank + 1, 3, generator=g),
         "rs": torch.randn(size * 256, 2, generator=g)}
    for k in range(WIRE_STEADY):
        x[f"s{k}"] = torch.randn(3 << 12, generator=g)
    return x


def wire_closed_forms(torch, xs, verdict, rank):
    """Every phase-12 output of rank ``rank``, from the port's CPU codec
    on all ranks' inputs (``xs``), as the star computes them: the
    prescale, the cast or the int8 quantization (with each rank's error
    feedback), the coordinator's sum in rank order, the decompression
    and the postscale. Returns (outputs, each rank's error feedback)."""
    from horovod_tpu_torch.common import wire_dtype as wd
    from horovod_tpu_torch.ops.backend import scale, scale_
    from horovod_tpu_torch.ops.socket_ops import _accumulate
    size = len(xs)
    efs = [wd.ErrorFeedback() for _ in range(size)]
    floats = (torch.float32, torch.float64)

    def allreduce(parts, pre=1.0, post=1.0, key=None):
        parts = [scale(p.reshape(-1), pre) for p in parts]
        dt, n = parts[0].dtype, parts[0].numel()
        w = verdict if dt in floats else wd.WIRE_NONE
        if w == wd.WIRE_NONE:
            acc = parts[0].clone()
            for p in parts[1:]:
                _accumulate(acc, p)
        elif w == wd.WIRE_INT8:
            qs = [wd.quantize_ef(p, ef, key) for p, ef in zip(parts, efs)]
            acc = wd.dequantize(wd.reduce_wire(qs[0], qs[1:], w, dt, n),
                                dt, n)
        else:
            ws = [wd.compress(p, w) for p in parts]
            acc = wd.decompress(wd.reduce_wire(ws[0], ws[1:], w, dt, n), w,
                                dt, n)
        scale_(acc, post)
        return acc

    def reducescatter(parts, post):
        flat = [p.reshape(-1) for p in parts]
        n = flat[0].numel()
        per = n // size
        mine = slice(rank * per, (rank + 1) * per)
        if verdict == wd.WIRE_INT8:
            acc = wd.dequantize(wd.quantize(flat[0]), flat[0].dtype, n)
            for p in flat[1:]:
                acc += wd.dequantize(wd.quantize(p), p.dtype, n)
            res = wd.dequantize(wd.quantize(acc[mine]), acc.dtype, per)
        elif verdict != wd.WIRE_NONE:
            ws = [wd.compress(p, verdict) for p in flat]
            acc = wd.reduce_wire(ws[0], ws[1:], verdict, flat[0].dtype, n)
            res = wd.decompress(acc[mine], verdict, flat[0].dtype, per)
        else:
            acc = flat[0].clone()
            for p in flat[1:]:
                acc += p
            res = acc[mine].clone()
        scale_(res, post)
        return res.view((per // parts[0].shape[1],) + parts[0].shape[1:])

    want = {"ar_sum": allreduce([x["a"] for x in xs], key=("p12.ar_sum",)),
            "ar_avg": allreduce([x["a"] for x in xs], post=1.0 / size,
                                key=("p12.ar_avg",)),
            "ar_scaled": allreduce([x["b"] for x in xs], 0.5, 3.0,
                                   key=("p12.ar_scaled",))}
    names = ("p12.grp.0", "p12.grp.1", "p12.grp.2")
    fused = allreduce([torch.cat([x["g0"], x["g1"], x["g2"]]) for x in xs],
                      key=names)
    at = 0
    for i in range(3):
        n = xs[0][f"g{i}"].numel()
        want[f"grp{i}"] = fused[at:at + n]
        at += n
    want["ar_f64"] = allreduce([x["d"] for x in xs], key=("p12.ar_f64",))
    want["ar_bf16"] = allreduce([x["a"].bfloat16() for x in xs])
    want["ar_int"] = allreduce([x["i"] for x in xs])
    agw = wd.allgather_wire(verdict)
    want["ag"] = torch.cat([
        x["ag"] if agw == wd.WIRE_NONE else wd.decompress(
            wd.compress(x["ag"].reshape(-1), agw), agw, torch.float32,
            x["ag"].numel()).view(x["ag"].shape) for x in xs])
    want["rs"] = reducescatter([x["rs"] for x in xs], 1.0)
    want["rs_avg"] = reducescatter([x["rs"] for x in xs], 1.0 / size)
    want["bc"] = xs[1]["a"]
    for k in range(WIRE_STEADY):
        want[f"s{k}"] = allreduce([x[f"s{k}"] for x in xs],
                                  key=("p12.steady",))
    return want, efs


def child_env(rank, size, port, extra=()):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                      HOROVOD_CONTROLLER_PORT=str(port), **dict(extra))


def star_only(hvd):
    """The runtime's socket star, with the process-group plane taken out
    of the backend list (NCCL refuses two ranks on one card): phase
    10's arrangement."""
    from horovod_tpu_torch.common import basics
    rt = basics.runtime()
    rt.op_manager.backends = [b for b in rt.op_manager.backends
                              if b.name != "process_group"]
    return rt, next(b for b in rt.op_manager.backends if b.name == "socket")


def wire_child(torch, hvd, args, rank, size, port, workdir, wire):
    """One rank of phase 12's world: every collective on CUDA tensors
    under HOROVOD_COMPRESSION=``wire``, held bit for bit to the CPU
    codec's closed forms; at bf16 the depth-2 full-width LM's eager
    steps (phase 10's). Writes its numbers to
    ``wire-<wire>-<rank>.json``."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.common import wire_dtype as wd
    from horovod_tpu_torch.models import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    child_env(rank, size, port, {"HOROVOD_COMPRESSION": wire})
    hvd.init()
    result = {"rank": rank}
    try:
        rt, star = star_only(hvd)
        dev = rt.device or torch.device("cpu")  # the CPU: a rehearsal
        xs = [wire_inputs(torch, r, size, args.seed) for r in range(size)]
        verdict = wd.wire_code_of(wire)
        want, efs = wire_closed_forms(torch, xs, verdict, rank)
        x = {k: v.to(dev) for k, v in xs[rank].items()}
        got = {"ar_sum": hvd.allreduce(x["a"], op=hvd.Sum, name="p12.ar_sum"),
               "ar_avg": hvd.allreduce(x["a"], name="p12.ar_avg"),
               "ar_scaled": hvd.allreduce(
                   x["b"], op=hvd.Sum, name="p12.ar_scaled",
                   prescale_factor=0.5, postscale_factor=3.0)}
        for i, o in enumerate(hvd.grouped_allreduce(
                [x["g0"], x["g1"], x["g2"]], op=hvd.Sum, name="p12.grp")):
            got[f"grp{i}"] = o
        got["ar_f64"] = hvd.allreduce(x["d"], op=hvd.Sum, name="p12.ar_f64")
        got["ar_bf16"] = hvd.allreduce(x["a"].bfloat16(), op=hvd.Sum,
                                       name="p12.ar_bf16")
        got["ar_int"] = hvd.allreduce(x["i"], op=hvd.Sum, name="p12.ar_int")
        got["ag"] = hvd.allgather(x["ag"], name="p12.ag")
        got["rs"] = hvd.reducescatter(x["rs"], name="p12.rs")
        got["rs_avg"] = hvd.reducescatter(x["rs"], name="p12.rs_avg",
                                          op=hvd.Average)
        got["bc"] = hvd.broadcast(x["a"], 1, name="p12.bc")
        spec0 = rt.stats["spec_cycles"]
        for k in range(WIRE_STEADY):
            got[f"s{k}"] = hvd.allreduce(x[f"s{k}"], op=hvd.Sum,
                                         name="p12.steady")
        torch.cuda.synchronize()
        bad = [k for k in want if not (
            got[k].device == dev and got[k].dtype == want[k].dtype
            and got[k].shape == want[k].shape
            and torch.equal(got[k].cpu().view(torch.uint8),
                            want[k].contiguous().view(torch.uint8)))]
        result.update(collectives=len(want), bad=bad,
                      spec_cycles=rt.stats["spec_cycles"] - spec0)
        if verdict == wd.WIRE_INT8:
            mine = {k: v.cpu() for k, v in star._ef._residuals.items()}
            theirs = efs[rank]._residuals
            result["residuals"] = len(theirs)
            result["residuals_equal"] = sorted(mine) == sorted(theirs) and \
                all(torch.equal(mine[k], theirs[k]) for k in theirs)
        else:
            cfg = TransformerConfig(num_layers=2, dtype=torch.bfloat16,
                                    **LM_FULL)
            step, model = bench.transformer_step(cfg, 2, seed=args.seed,
                                                 eager=True)
            torch.cuda.synchronize()
            n_fp32 = sum(p.numel() for p in model.parameters()
                         if p.requires_grad and p.dtype == torch.float32)
            to_host, from_host = star.bytes_to_host, star.bytes_from_host
            before = runtime_counts()
            losses, secs = timed_steps(step, WORLD_STEPS)
            after = runtime_counts()
            unused = after["spec_unused_bytes"] - before["spec_unused_bytes"]
            result.update(
                losses=losses, secs=secs, n_fp32=n_fp32, unused=unused,
                to_host=star.bytes_to_host - to_host - unused,
                from_host=star.bytes_from_host - from_host,
                lm_spec_cycles=after["spec_cycles"] - before["spec_cycles"],
                sums=[p.detach().double().sum().item()
                      for p in model.parameters()])
            del step, model
    finally:
        hvd.shutdown()
    with open(os.path.join(workdir, f"wire-{wire}-{rank}.json"), "w") as f:
        json.dump(result, f)


def abort_child(torch, hvd, args, rank, size, port, workdir, mode):
    """One rank of phase 13's world: the depth-2 full-width LM's eager
    steps on CUDA tensors, rank 1 faulted (``mode`` hang or kill) three
    ops into the first step's gradient allreduces. Rank 1 stamps the
    time its fault fires; each rank writes what it raised, and when, to
    ``abort-<mode>-<rank>.json``."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.common import faults
    from horovod_tpu_torch.models import TransformerConfig
    child_env(rank, size, port, dict(
        ABORT_HB, HOROVOD_TPU_FLIGHT_DIR=flight_dir(workdir, mode)))
    hvd.init()
    rt, _ = star_only(hvd)
    cfg = TransformerConfig(num_layers=2, dtype=torch.bfloat16, **LM_FULL)
    step, model = bench.transformer_step(cfg, 2, seed=args.seed, eager=True)
    result = {"rank": rank, "losses": []}
    stamp = os.path.join(workdir, f"abort-{mode}-fired")
    if rank == 1:
        fire = faults._apply

        def stamped(fault, runtime):
            with open(stamp, "w") as f:
                f.write(repr(time.time()))
            fire(fault, runtime)

        faults._apply = stamped
        faults.install(mode, at_op=rt._op_count + 3, seconds=8)
    try:
        for _ in range(WORLD_STEPS):
            result["losses"].append(step().item())
        result["raised"] = None
    except hvd.HorovodInternalError as e:
        result.update(raised=type(e).__name__, at=time.time(),
                      origin=getattr(e, "origin_rank", None),
                      message=str(e)[:300])
    del step, model
    if rt.device is not None:
        result["peak_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    hvd.shutdown()
    with open(os.path.join(workdir, f"abort-{mode}-{rank}.json"), "w") as f:
        json.dump(result, f)


def start_children(args, kind, size, port, workdir, ranks):
    # This process's cached blocks go back to the card first: the
    # children of phases 12 and 13 share it (six at once in phase 13).
    import torch
    torch.cuda.empty_cache()
    procs = {}
    for r in ranks:
        log = open(os.path.join(workdir, f"{kind}-{r}.log"), "w")
        procs[r] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed",
             str(args.seed), "--child", kind, str(r), str(size), str(port),
             workdir], stdout=log, stderr=subprocess.STDOUT)
        log.close()
    return procs


def wait_children(procs, workdir, kind, timeout, expect_rc=None):
    """Waits for every child (killing all of them if one outlasts
    ``timeout``); a return code other than ``expect_rc[rank]`` (0 by
    default) is a failure, shown with the child's log."""
    expect_rc = expect_rc or {}
    deadline = time.monotonic() + timeout
    try:
        for r, p in procs.items():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in procs.items():
        if p.returncode != expect_rc.get(r, 0):
            with open(os.path.join(workdir, f"{kind}-{r}.log")) as f:
                print(f.read()[-4000:])
            raise AssertionError(f"{kind} rank {r} exited with "
                                 f"{p.returncode}")


def wire_phase(torch, args, workdir, star_run):
    """Phase 12: wire dtypes on the card. Phase 10's two-rank star world
    with HOROVOD_COMPRESSION=bf16 on both ranks and a two-rank int8
    world, started together; the bf16 world's LM steps held to phase
    10's (``star_run``)."""
    t0 = time.perf_counter()
    worlds = {w: start_children(args, f"wire-{w}", 2, free_port(), workdir,
                                (0, 1)) for w in ("bf16", "int8")}
    res = {}
    for w, procs in worlds.items():
        wait_children(procs, workdir, f"wire-{w}", 600)
        res[w] = [json.load(open(os.path.join(workdir, f"wire-{w}-{r}.json")))
                  for r in (0, 1)]
    print(f"wire dtypes on the card: two ranks each of a bf16 and an int8 "
          f"world through the socket star ({time.perf_counter() - t0:.1f} s "
          f"for both, started together)")
    for w in ("bf16", "int8"):
        for r in (0, 1):
            out = res[w][r]
            extra = (f", error-feedback residuals ({out['residuals']}) equal "
                     f"to the CPU's: {out['residuals_equal']}"
                     if w == "int8" else "")
            print(f"  {w} rank {r}: {out['collectives'] - len(out['bad'])} "
                  f"of {out['collectives']} outputs bit-equal to the CPU "
                  f"codec's closed forms; {out['spec_cycles']} speculative "
                  f"cycles in {WIRE_STEADY} steps under one name" + extra)
            if out["bad"]:
                raise AssertionError(f"{w} rank {r}: {out['bad']} differ "
                                     f"from the CPU codec")
            if w == "int8" and not (out["residuals_equal"]
                                    and out["spec_cycles"] == 0):
                raise AssertionError("int8: residuals differ from the CPU's, "
                                     "or a cycle speculated")
            if w == "bf16" and not out["spec_cycles"] > 0:
                raise AssertionError("bf16: no speculative cycle")
    s_losses, _, (s_secs, _), s_to_host = star_run
    b0, b1 = res["bf16"]
    n = b0["n_fp32"]
    want_bytes = s_to_host - 2 * n * WORLD_STEPS
    print(f"  the LM at full width, depth 2, 2 rows per rank, {WORLD_STEPS} "
          f"eager steps, bf16 on the wire: sec/step "
          f"{' '.join(f'{v:.3f}' for v in b0['secs'])} (phase 10: "
          f"{' '.join(f'{v:.3f}' for v in s_secs)}); {b0['lm_spec_cycles']} "
          f"speculative cycles")
    print(f"    card->host bytes per step {b0['to_host'] / WORLD_STEPS:.6g} "
          f"(phase 10: {s_to_host / WORLD_STEPS:.6g}; less 2 bytes for each "
          f"of the model's {n} fp32 gradient elements: "
          f"{want_bytes / WORLD_STEPS:.6g}), unused speculative bids left "
          f"out ({b0['unused'] / WORLD_STEPS:.6g} per step here); host->card "
          f"{b0['from_host'] / WORLD_STEPS:.6g}")
    if not b0["to_host"] == b1["to_host"] == want_bytes:
        raise AssertionError(f"card->host bytes {b0['to_host']}, "
                             f"{b1['to_host']}; want {want_bytes}")
    # The bound: each rank's fp32 gradient and the sum are rounded to bf16
    # once each (2^-9 relative apiece), so every element of the averaged
    # gradient, and so of each update, is off by at most 2^-8 of it. The
    # loss moves from its first step by the updates (gradient times
    # update, all of one sign under SGD), so it moves off phase 10's by
    # at most 2^-8 of that move to first order: held to 2^-6 of it, plus
    # phase 10's own 1e-4 of the loss for the order of bf16 sums.
    worst = 0.0
    for r, b in enumerate((b0, b1)):
        ref = s_losses[r].tolist()
        for k, (got, was) in enumerate(zip(b["losses"], ref)):
            bound = 2 ** -6 * abs(was - ref[0]) + 1e-4 * abs(was)
            worst = max(worst, abs(got - was) / bound)
        print(f"    rank {r} losses "
              f"{' '.join(f'{v:.6f}' for v in b['losses'])} (phase 10: "
              f"{' '.join(f'{v:.6f}' for v in ref)})")
    same = b0["sums"] == b1["sums"]
    print(f"    worst loss difference {worst:.3f} of its bound (2^-6 of the "
          f"loss's move since step 1 plus 1e-4 of the loss); the two ranks' "
          f"parameters equal: {same}")
    if not (worst <= 1.0 and same):
        raise AssertionError("the bf16 wire's steps leave phase 10's bound, "
                             "or the ranks' parameters differ")


def flight_dir(workdir, mode):
    """Where phase 13's ``mode`` world leaves its flight dumps."""
    return os.path.join(workdir, f"flight-{mode}")


def flight_dump(workdir, mode, rank):
    """The records of rank ``rank``'s one flight dump of phase 13's
    ``mode`` world: the header, then the ring's events."""
    d = flight_dir(workdir, mode)
    files = [f for f in os.listdir(d)
             if f.startswith(f"hvd-flight-rank{rank}.pid")]
    if len(files) != 1:
        raise AssertionError(f"{mode}: rank {rank} left {len(files)} flight "
                             f"dumps in {sorted(os.listdir(d))}")
    with open(os.path.join(d, files[0])) as f:
        return [json.loads(line) for line in f]


def abort_phase(torch, args, workdir):
    """Phase 13: the abort on the card. A three-rank world in which rank
    1's loop hangs in the LM's eager steps and one in which rank 1 is
    killed mid-allreduce, started together: both survivors of each must
    raise WorldAbortedError naming rank 1 within the heartbeat timeout
    plus ABORT_SLACK_S of the fault."""
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    print(f"  (the card's free memory before the children start: "
          f"{free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB)")
    for m in ("hang", "kill"):
        os.makedirs(flight_dir(workdir, m))
    worlds = {m: start_children(args, f"abort-{m}", 3, free_port(), workdir,
                                (0, 1, 2)) for m in ("hang", "kill")}
    for m, procs in worlds.items():
        wait_children(procs, workdir, f"abort-{m}", 300,
                      {1: -9} if m == "kill" else None)
    timeout = float(ABORT_HB["HOROVOD_HEARTBEAT_TIMEOUT"])
    print(f"abort on the card: three ranks on one card, the LM's eager steps, "
          f"heartbeat interval {ABORT_HB['HOROVOD_HEARTBEAT_INTERVAL']} s and "
          f"timeout {timeout:g} s ({time.perf_counter() - t0:.1f} s for both "
          f"worlds, started together)")
    for m in ("hang", "kill"):
        with open(os.path.join(workdir, f"abort-{m}-fired")) as f:
            fired = float(f.read())
        for r in (0, 2):
            with open(os.path.join(workdir, f"abort-{m}-{r}.json")) as f:
                out = json.load(f)
            took = out["at"] - fired if out.get("at") else float("nan")
            via = "its own deadline or socket" if r == 0 else \
                "the coordinator's ABORT"
            print(f"  {m}: rank {r} raised {out['raised']} naming rank "
                  f"{out['origin']} {took:.2f} s after the fault (through "
                  f"{via}; bound {timeout + ABORT_SLACK_S:g} s); its peak "
                  f"card memory {out.get('peak_gib', 0.0):.1f} GiB")
            if not (out["raised"] == "WorldAbortedError"
                    and out["origin"] == 1
                    and took < timeout + ABORT_SLACK_S):
                raise AssertionError(f"{m}: rank {r}: {out}")
            if m == "hang" and took < timeout - 0.5:
                raise AssertionError(f"hang: rank {r} aborted before the "
                                     f"deadline could have seen the hang")
            head, *events = flight_dump(workdir, m, r)
            aborts = [e for e in events if e["ev"] == "abort"]
            print(f"    its flight dump: cause {head['cause'][:60]!r}, "
                  f"origin {head['origin']}, {head['events']} events, the "
                  f"last round {max((e['cycle'] for e in events), default=0)}"
                  f", abort events naming rank "
                  f"{[e.get('arg') for e in aborts]}")
            if not (head["origin"] == 1 and aborts
                    and all(e.get("arg") == 1 for e in aborts)):
                raise AssertionError(f"{m}: rank {r}'s flight dump: "
                                     f"{head}, {aborts}")
        if m == "hang":
            with open(os.path.join(workdir, "abort-hang-1.json")) as f:
                out = json.load(f)
            print(f"  hang: rank 1, awake after 8 s, raised {out['raised']} "
                  f"naming rank {out['origin']}")
            if out["raised"] not in ("WorldAbortedError",
                                     "HorovodInternalError"):
                raise AssertionError(f"hang: rank 1: {out}")


# Phase 14's planes: metrics snapshots and trace batches every 50 ms.
PLANES_INTERVAL_S = "0.05"
# The world series that stop with the steps: rank 0 holds them to the
# sums of the ranks' own counts.
PLANES_SUMMED = {"hvd_cached_cycles_total": "cached_cycles",
                 "hvd_fused_spec_cycles_total": "spec_cycles"}


def planes_world(torch, hvd, args, rank, port, workdir):
    """Phase 14, run by both ranks of a world of two on one card: phase
    10's star world with the metrics and trace planes on, the LM's eager
    steps only. Rank 0 returns (the ranks' losses, its parameters, the
    step seconds, what it read of the planes)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    trace = os.path.join(workdir, "trace_size2.json")
    log = os.path.join(workdir, "metrics_size2.jsonl")
    knobs = dict(HOROVOD_TPU_METRICS="1", HOROVOD_TPU_METRICS_PORT="0",
                 HOROVOD_TPU_METRICS_ADDR="127.0.0.1",
                 HOROVOD_TPU_METRICS_INTERVAL=PLANES_INTERVAL_S,
                 HOROVOD_TPU_METRICS_LOG=log, HOROVOD_TPU_TRACE=trace,
                 HOROVOD_TPU_TRACE_INTERVAL=PLANES_INTERVAL_S)
    child_env(rank, 2, port, knobs)
    hvd.init()
    read = {}
    try:
        rt, _ = star_only(hvd)
        cfg = TransformerConfig(num_layers=2, dtype=torch.bfloat16,
                                **LM_FULL)
        step, model = bench.transformer_step(cfg, 2, seed=args.seed,
                                             eager=True)
        torch.cuda.synchronize()
        before = runtime_counts()
        losses, secs = timed_steps(step, WORLD_STEPS)
        per_step = print_negotiation(before, runtime_counts(), WORLD_STEPS)
        params = [p.detach().to("cpu", copy=True) for p in model.parameters()]
        del step, model
        all_losses = hvd.allgather(torch.tensor([losses]), name="w.losses")
        st = dict(rt.stats)
        mine = torch.tensor([[float(st[k]) for k in PLANES_SUMMED.values()]
                             + [float(st["cycles"])]], dtype=torch.float64)
        ranks = hvd.allgather(mine, name="p14.counts")
        if rank == 0:
            read = read_planes(hvd, rt, ranks)
        # the worker's shutdown would end the world under rank 0's reads
        hvd.barrier()
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                  "HOROVOD_CONTROLLER_ADDR", "HOROVOD_CONTROLLER_PORT",
                  *knobs):
            os.environ.pop(k, None)
    if rank != 0:
        return None
    read["trace"] = read_trace(trace, 2)
    read["busy_ms"] = per_step["busy_ms"]
    with open(log) as f:
        lines = f.read().splitlines()
    read["log_lines"] = len(lines)
    if not lines or "hvd_cycles_total" not in json.loads(lines[-1])["world"]:
        raise AssertionError(f"the JSONL log {log} holds no world view")
    return all_losses, params, secs, read


def folded_cycles(agg):
    """({rank: hvd_cycles_total of the latest snapshot rank 0 holds of
    it}, the world's hvd_cycles_total), read with no frame folded in
    between (a rank's count rises with every round, so equal reads
    before and after the world's fold mean it folded those)."""
    def latest():
        with agg._lock:
            out = {r: snap["hvd_cycles_total"]["v"]
                   for r, (_, snap, _) in agg._owners.items()}
            out[0] = agg._local["hvd_cycles_total"]["v"]
        return out
    while True:
        before = latest()
        world = agg.world()["hvd_cycles_total"]["v"]
        if latest() == before:
            return before, world


def read_planes(hvd, rt, ranks):
    """Rank 0's checks of the world view, polled until every rank's
    latest snapshot is from its last gather or later (a worker's comes
    with its next interval): the summed series equal to the ranks'
    counts, hvd_cycles_total equal to the sum of the snapshots folded,
    and GET /metrics equal to hvd.metrics()."""
    import urllib.request
    want = {n: float(ranks[:, i].sum())
            for i, n in enumerate(PLANES_SUMMED)}
    at_gather = {r: float(c) for r, c in enumerate(ranks[:, -1].tolist())}
    agg = rt._aggregator
    deadline = time.monotonic() + 10.0
    while True:
        view = hvd.metrics()
        world = view["world"]
        got = {n: world.get(n, {}).get("v") for n in want}
        folded, cycles = folded_cycles(agg)
        fresh = folded.keys() == at_gather.keys() and all(
            folded[r] >= c for r, c in at_gather.items())
        if (got == want and world["hvd_ranks_reporting"]["v"] == 2
                and fresh) or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{view['http_port']}/metrics",
        timeout=10).read().decode()
    scraped = {line.split(" ")[0]: float(line.split(" ")[1])
               for line in text.splitlines()
               if line.split(" ")[0] in want}
    print(f"  world view on rank 0: {got} against the ranks' sums {want}; "
          f"hvd_cycles_total {cycles:g} = the folded snapshots {folded} "
          f"(stats[\"cycles\"] at the ranks' last gather: {at_gather}); "
          f"GET /metrics on port {view['http_port']}: {scraped}; "
          f"straggler: {rt._straggler.report_line()!r}")
    if not (got == want and scraped == want and fresh
            and cycles == sum(folded.values())):
        raise AssertionError("the world view is not the sum of the ranks'")
    return {"world": got, "cycles": cycles, "folded": folded,
            "port": view["http_port"], "series": len(world)}


def read_trace(path, size):
    """The merged trace's checks: a track per rank, the round numbers of
    each rank's ROUND spans rising, and the batches both ranks executed
    the classic way stamped with the same rounds (a worker's tail may
    miss the file: the shorter sequence is compared)."""
    with open(path) as f:
        events = json.load(f)
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    spans = [e for e in events if e.get("ph") in ("X", "i")]
    rounds = {r: [e["args"]["wc"] for e in spans
                  if e["pid"] == r and e["name"] == "ROUND"]
              for r in range(size)}
    execs = {r: [(e["name"], e["args"]["wc"]) for e in spans
                 if e["pid"] == r and e["name"] != "ROUND"]
             for r in range(size)}
    n = min(len(v) for v in execs.values())
    print(f"  trace {os.path.basename(path)}: tracks {names}, "
          f"{len(spans)} spans, ROUND spans per rank "
          f"{[len(v) for v in rounds.values()]}, executed batches per rank "
          f"{[len(v) for v in execs.values()]}, the first {n} on the same "
          f"rounds: {all(v[:n] == execs[0][:n] for v in execs.values())}")
    if not (names == {r: f"rank {r}" for r in range(size)} and n > 0
            and all(v and v == sorted(set(v)) for v in rounds.values())
            and all(v[:n] == execs[0][:n] for v in execs.values())):
        raise AssertionError(f"the merged trace {path} is not one world "
                             f"trace")
    return {"spans": len(spans), "same_rounds": n}


def planes_phase(torch, hvd, args, workdir, star_run):
    """Phase 14: rank 0 here, rank 1 in a process of its own; the steps
    held to phase 10's (``star_run``) bit for bit."""
    t0 = time.perf_counter()
    port = free_port()
    rank1 = start_rank1(args, port, workdir, "planes")
    try:
        all_losses, params, secs, read = planes_world(
            torch, hvd, args, 0, port, workdir)
        rank1.wait(timeout=300)
    finally:
        if rank1.poll() is None:
            rank1.kill()
            rank1.wait()
    if rank1.returncode != 0:
        with open(os.path.join(workdir, "rank1_planes.log")) as f:
            print(f.read()[-4000:])
        raise AssertionError(f"rank 1 exited with {rank1.returncode}")
    s_losses, s_params, (s_secs, s_per), _ = star_run
    same = torch.equal(all_losses, s_losses) and all(
        torch.equal(a, b) for a, b in zip(params, s_params))
    on, off = statistics.median(secs[2:]), statistics.median(s_secs[2:])
    print(f"observability planes on the card ({card_line()}): phase 10's "
          f"two-rank star world, metrics every {PLANES_INTERVAL_S} s and "
          f"the world trace on ({time.perf_counter() - t0:.1f} s)")
    print(f"  sec/step with the planes on "
          f"{' '.join(f'{v:.3f}' for v in secs)} against phase 10's off "
          f"{' '.join(f'{v:.3f}' for v in s_secs)}; steps 3-{WORLD_STEPS} "
          f"median {on:.4f} against {off:.4f} s ({on - off:+.4f} s, "
          f"{(on - off) / off:+.2%} per step); the loop's thread busy "
          f"{read['busy_ms']:.1f} against {s_per['busy_ms']:.1f} ms per "
          f"step")
    print(f"  losses and parameters equal to phase 10's bit for bit: {same}")
    if not same:
        raise AssertionError("the planes changed the steps' results")
    return read


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    # Internal: run as rank 1 of phase 10's, 11's or 14's world (port,
    # work directory, "star", "plane" or "planes").
    ap.add_argument("--world-rank1", nargs=3,
                    metavar=("PORT", "DIR", "MODE"), help=argparse.SUPPRESS)
    # Internal: run as a rank of phase 12's or 13's worlds.
    ap.add_argument("--child", nargs=5,
                    metavar=("KIND", "RANK", "SIZE", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _cuda
    from horovod_tpu_torch.parallel import flash_attention as fa
    if args.world_rank1:
        port, workdir, mode = args.world_rank1
        if mode == "planes":
            planes_world(torch, hvd, args, 1, int(port), workdir)
        else:
            two_rank_world(torch, hvd, args, 1, int(port), workdir,
                           mode=mode)
        return 0
    if args.child:
        kind, rank, size, port, workdir = args.child
        child = wire_child if kind.startswith("wire-") else abort_child
        child(torch, hvd, args, int(rank), int(size), int(port), workdir,
              kind.split("-", 1)[1])
        return 0

    # Phase 1: card and build.
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _cuda.load()
    built = "nvcc ran" if _cuda.build_seconds is not None else \
        "library already built"
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({built})")

    # Phase 2: kernels against their plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = kernel_checks(torch, fa)

    # Phase 3: a small model against the dense reference.
    small_model_check(torch, args.seed)

    # Phase 4: the main path.
    counts = main_path(torch, hvd, args, card)

    # Phase 4b: the LM at Gemma-7B's attention widths (D 256).
    gemma_counts = gemma_path(torch, hvd, args, card)

    # Phase 4c: the LM in fp32 (the tf32 kernels), depth cut.
    fp32_counts = fp32_path(torch, hvd, args, card)

    # Phase 4d: the entry's model (bf16, head dim 16): the narrow kernels.
    entry_fwd_counts, entry_counts = entry_path(torch, hvd, args, card)

    # Phase 4e: the LM at Phi-3-mini's attention widths (D 96).
    phi3_counts = phi3_path(torch, hvd, args, card)

    # Phase 5: times.
    rows = kernel_times(torch, fa)

    # Phase 6: small vision models, the card against the CPU.
    vision_small_check(torch, args.seed)

    # Phase 7: the bench's ResNet-50 leg at full width.
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import ResNet50, ViT_B16
    g = torch.Generator(device="cuda")
    classifier_leg(torch, hvd, args, card, "resnet50 (bf16, cross-replica "
                   "BatchNorm over data)", lambda: ResNet50(
                       num_classes=1000, dtype=torch.bfloat16,
                       axis_name="data", generator=g.manual_seed(args.seed)),
                   batch=256, macs_per_image=bench.RESNET50_MACS_PER_IMAGE)

    # Phase 8: ViT-B/16.
    classifier_leg(torch, hvd, args, card, "vit_b16 (bf16)",
                   lambda: ViT_B16(generator=g.manual_seed(args.seed)),
                   batch=64)

    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as workdir:
        # Phase 9: the negotiated runtime at size 1.
        ref = eager_runtime_phase(torch, hvd, args, card, workdir)
        # Phase 10: a two-rank world on this card, through the star.
        star_run = world_of_two(torch, hvd, args, workdir, ref, "star")
        # Phase 11: the same world through the process-group plane.
        world_of_two(torch, hvd, args, workdir, ref, "plane", star_run)
        # Phase 12: wire dtypes on the card.
        wire_phase(torch, args, workdir, star_run)
        # Phase 13: the abort on the card.
        abort_phase(torch, args, workdir)
        # Phase 14: the observability planes on the card.
        planes_phase(torch, hvd, args, workdir, star_run)
    csrc, ref = "horovod_tpu_torch/csrc/", \
        "horovod_tpu/parallel/flash_attention.py:"
    sources = {"flash_fwd": ("flash_fwd.cu", "58"),
               "flash_fwd_sm90": ("flash_fwd_sm90.cu", "58"),
               "flash_fwd_stream": ("flash_fwd_stream_sm90.cu", "58"),
               "flash_fwd_tf32": ("flash_fwd_stream_sm90.cu", "58"),
               "flash_dq": ("flash_bwd.cu", "204"),
               "flash_dq_sm90": ("flash_dq_sm90.cu", "204"),
               "flash_dq_stream": ("flash_dq_stream_sm90.cu", "204"),
               "flash_dq_tf32": ("flash_bwd_tf32_sm90.cu", "204"),
               "flash_dkv": ("flash_bwd.cu", "236"),
               "flash_dkv_sm90": ("flash_dkv_sm90.cu", "236"),
               "flash_dkv_stream": ("flash_dkv_stream_sm90.cu", "236"),
               "flash_dkv_tf32": ("flash_bwd_tf32_sm90.cu", "236"),
               # dq's and dk/dv's kernels in one, and the jnp lse and delta
               # of the reference's flash_attention_bwd (no Pallas kernel)
               "flash_bwd_sm90": ("flash_bwd_sm90.cu", "204, :236"),
               "flash_bwd_prep": ("flash_bwd_sm90.cu", "462-471, :498-499")}
    # A row's launches are those of its kernel on the path that runs its
    # dtype and head dim: bf16 D 128 on phase 4, bf16 D 256 on phase 4b,
    # bf16 D 96 on phase 4e, fp32 D 128 on phase 4c; the rows at the
    # entry's shape those of phase 4d (the forward: one call of the entry's
    # forward; dq, dk/dv and the pre-pass: its training steps); the other
    # head dims (the C4 cases at D 16 and 32 among them) run on no main
    # path. The sm90 dq and dk/dv at bf16 D 96 and 128 are timed beside
    # the fused backward that took their place there: 0 launches.
    paths = {("bfloat16", MAIN["d"]): counts,
             ("bfloat16", GEMMA["d"]): gemma_counts,
             ("bfloat16", PHI3["d"]): phi3_counts,
             ("float32", MAIN["d"]): fp32_counts}
    entry_rows = {"flash_fwd_sm90": entry_fwd_counts,
                  "flash_dq_sm90": entry_counts,
                  "flash_dkv_sm90": entry_counts,
                  "flash_bwd_prep": entry_counts}
    kernels = []
    for name, r in rows.items():
        base, _, tag = name.partition(".")
        src, replaces = sources[base]
        call = r.pop("call")
        if base == "flash_fwd_tf32" and call[1] <= 32:
            src = "flash_fwd_tf32_narrow_sm90.cu"  # the narrow builds
        if base in ("flash_dq_tf32", "flash_dkv_tf32") and call[1] <= 32:
            src = "flash_bwd_tf32_narrow_sm90.cu"
        flops = r.pop("flops")
        launches = (entry_rows[base][base] if tag == "entry"
                    else paths.get(call, {}).get(base, 0))
        kernels.append(dict(name=name, route="cuda", source=csrc + src,
                            replaces=ref + replaces, launches=launches,
                            max_abs_err=errs[name], **r))
        # The sm90 forward's rate and share of its bound beside its time.
        rate = (f", {flops / r['ms'] / 1e9:.0f} TFLOP/s, "
                f"{r['bound_ms'] / r['ms']:.1%} of the bound"
                if base == "flash_fwd_sm90" else "")
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f}")
        print(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
              f"library {lib}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}{rate}), {launches} launches")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
