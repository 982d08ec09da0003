#!/usr/bin/env python3
"""On-card smoke check of tpu_mpi_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--against LABEL=DIR ...]

(``--against`` also builds the ``fused_reduce.cu`` and ``ring.cu`` of the
tree at DIR, a checkout of an earlier commit, holds its fold and
reduce-scatter kernels bitwise to this tree's and times them in phase 6's
turns; an entry of that tree with or without a route argument.)

Needs one CUDA card (an H100 is what the port targets) and ``nvcc``; it
imports torch, numpy and the port, never jax or tpu_mpi. Phases, each
fatal on failure:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every kernel library from ``tpu_mpi_torch/csrc`` with nvcc
   (sm_90a), one nvcc per source, all started together;
3. kernels against their plain PyTorch versions on the card, bitwise
   (floats compared as raw bits, NaN positions as masks), over every dtype
   and op each kernel takes (uint16, uint32 and uint64 among them, as
   random bits) with NaN and signed-zero inputs for MAX/MIN:
   the fused fold at n in {2, 4, 5, 17} and sizes 1, 127, 4097, 2^26+3;
   the three ring kernels at n in {2, 4, 5, 8} and per-rank sizes 1, 127,
   4097, 8229, 4198400, 2^26+3 (reduce-scatter and allgather on shards of
   ceil(size/n)), the reduce-scatter kernel on both its routes (staged
   and direct); the fold's numpy rules (``NUMPY_SUM/PROD/MAX/MIN``, the
   serve tier's steps) on float16/32/64, random and special operands
   (quiet and signalling NaNs with payloads, infinities, signed zeros),
   bit for bit with NaN payloads; non-contiguous operands must raise;
   the fold's two routes, each forced through ``via``, at n in {1 into an
   out, 2, 4, 5, 16, 17}, every dtype and op, counts 1, 3, 127, 4097,
   2^20+5 on the direct route and rounded up to whole 16-byte words on
   both, views at a 1-element offset (the direct route, chosen; the
   staged one refused), ``out`` aliasing operand 0, ``out`` aliasing each
   operand k of 17 (float32 and int64, SUM and MAX), float32[2^26] at n 4
   and 17;
4. host main path: ``spmd_run`` on 4 rank threads — Init, COMM_WORLD, a
   ``DeviceBuffer`` of float32[2^26] per rank from a numpy seed, repeated
   ``MPI.Allreduce(x, y, MPI.SUM, comm)`` (the repeats arm the auto-arm
   lane), ``Allreduce_init`` Start/Wait rounds, ``Reduce`` to root 0 — with
   every result bitwise equal to the plain fold, every tensor on cuda, the
   fold kernel launched once per operation, each launch on its staged
   route, and the chained-fold count still;
5. in-graph path: ``xla.make_mesh({"x": 4})`` on the card, the same
   float32[2^26] per rank stacked to (4, 2^26): the DDP-shaped
   ``ring_allreduce``, the FSDP round trip ``ring_reduce_scatter`` to
   (4, 2^24) shards and ``ring_allgather`` back, and ``xla.allreduce``,
   ``xla.reduce_scatter``, ``xla.allgather`` — every result bitwise equal
   to its plain version and on cuda, every ring kernel's launch count
   rising (every reduce-scatter on the staged route), the fold launched
   twice, both on its staged route, the callable-ring and chained-fold
   counts still;
6. times with CUDA events at the main paths' shapes: each kernel, its
   bound, its plain version, one PyTorch call computing the same function
   as the library yardstick (timed only; the port never calls it), a 1 GiB
   ``copy_`` bandwidth control, and the host-lane ``MPI.Allreduce`` per op;
   the fold in turns on the host operands and on the stacked rows with
   ``xs.sum(0)`` on the stacked (4, 2^26) tensor (its yardstick), its own
   direct route and the ``--against`` trees' kernels, with
   ``torch.stack(xs).sum(0)`` beside the host operands; tiny folds
   (float32[8] x 4, float64[1] x 2) per call and per span on each route
   that takes them;
   ``ring_reduce_scatter`` in turns with ``xs.view(n, n, per).sum(0)`` and
   with its own direct route, ``ring_allgather`` in turns with
   ``expand(n, -1).contiguous()`` and ``repeat(n, 1)``;
7. build: ``permute.cu``, ``ring_attention.cu`` and
   ``ring_attention_sm90.cu`` join phase 2's parallel build;
8. the new kernels against their plain versions: the permute and
   all-to-all kernels bitwise at n in {2, 4, 5, 8} and per-rank sizes 1,
   127, 4096, 4097, 2^22+3 over every dtype of the fold phases, with a
   partial permutation; ring attention elementwise within
   ``attention.allowed_error`` at n in {1, 2, 4}, causal and not, float32
   and bfloat16, t_local in {8, 72, 256}, d in {8, 36, 64, 128}, on each of
   its three routes (bfloat16 with d % 8 == 0: the sm90 kernel and the
   mma.sync kernel; d = 36: mma.sync; float32: FMA), each
   call counted on the route it should take; non-contiguous input, a
   non-permutation, a CPU/CUDA mix and float16 must raise;
9. model path: the flagship transformer (benchmarks/flagship_probe.py's
   configuration: d_model 1024, 16 heads, 8 layers, d_ff 4096, vocab
   32768, bfloat16, random weights from a seeded generator) serves 3
   requests of (8, 1024) tokens from a numpy seed through
   ``transformer_forward(..., sp_axis="sp")`` on ``{"sp": 4}``: logits and
   the greedy next token of each sequence, every tensor on cuda, 8
   ring-attention launches per request, all 24 on the sm90 route, no fold,
   ring or chained launch;
   the logits against the same port's forward without sp (plain dense
   attention) within a stated bfloat16 tolerance and share of agreeing
   greedy tokens, once more in float32 with TF32 off; one request through
   ``tp_axis="tp"`` on ``{"tp": 4}`` (16 fold launches) against the single
   forward;
10. recipes: ``ulysses_attention`` at the model's attention shapes (4
   all-to-all launches) against ``parallel.ring_attention``;
   ``pipeline_forward`` of the 8 layers on ``{"pp": 4}`` with 8
   microbatches of (1, 1024) (11 permute launches) against the layers in
   sequence; ``moe_dispatch_combine`` on ``{"ep": 4}`` with 2048 tokens a
   rank, capacity 1024 and one flagship FFN expert a rank (2 all-to-all
   launches, dropped rows exact zeros); a periodic ``halo_exchange`` on
   ``{"x": 4}`` (2 permute launches);
11. each new kernel against its plain version on the inputs the paths
   give it (the pipeline hop and the MoE dispatch buffer bitwise, the
   model's (4, 128, 256, 64) bfloat16 attention operands within
   ``attention.allowed_error``, on the sm90 route and on the mma.sync
   kernel it replaced there), then times with CUDA events of each at
   those shapes, its bound, its plain version and its library yardstick,
   in the same run: the sm90 kernel per call and its span, the mma.sync
   kernel's span, SDPA per call and its span (a line says so when the
   profiler recorded none of SDPA's kernels); the
   permute per call in turns with ``xs[inverse_perm]``, and its span, and
   both spans with the L2 flushed before each call, in turns; the
   model path's ms per request, tokens/s and device idle share under
   ``torch.profiler``; 11b. the Moonlight cell's kernels at its
   shapes: ``attention.attend`` at (1, 64, 4096) with q/k head dim 192 and
   v head dim 128 (one sm90 launch on its 192/128 route, within
   ``attention.allowed_error``), its backward ``attention.backward`` (one
   call of the backward kernel, within 2^-5 of each gradient's largest
   magnitude of ``attention_backward``) and ``xla.alltoall`` on the cell's
   padded MoE exchange (4, 4, 6756, 2048) bfloat16 (one all-to-all launch,
   bitwise), each timed beside its bound, its plain version and a library
   call, and a ``kernels`` entry of each;
12. training at the flagship width: ``transformer_train_step`` on
   ``{"sp": 4}``, 3 steps of batch 8 x 1024 (labels the tokens shifted by
   one, lr 1e-3; eager, captured into a CUDA graph, replayed: 1 capture and 2
   replays in the model block): the launch table counts the eager step and
   the capture, 16 ring-attention launches, all sm90, 16 backward calls at
   "64/64", one fold launch per parameter tensor and one for the loss per
   counted step, no chained fold, and none for the replay; a profiled
   replay runs 8 ``ring_attention_sm90_kernel``, 8
   ``attention_backward_sm90_kernel`` and 51 ``fused_fold_kernel_*`` by
   name; finite losses, step 0's loss against the dense single-device
   step; an eager step against a replayed one, three of each in turns
   (host clock to a synchronise); one float32
   sp step and one float32 tp step against the dense autograd step (TF32
   off; the largest update difference relative to the update); one bfloat16
   step on ``{"tp": 4}`` (4 L fold launches); ``DDPTrainer`` and
   ``FSDPTrainer`` on 4 rank threads fed the dense step's gradients of each
   rank's (2, 1024) quarter, 20 steps, 25 MiB buckets: bitwise equal
   float64 parameters, every bucket folded by the kernel, every persistent
   round checked across ranks by its key (plan id, round, count, dtype;
   at least 20 x 34 rounds), FSDP's optimizer state 1/4 of DDP's; then
   times: ms per sp step (CUDA events), tokens/s, device
   busy time per step and the top kernels (profiler), the step's spec-sheet
   bound, the plain attention backward per call against SDPA's
   forward+backward on the gathered (8, 16, 1024, 64), the backward kernel
   at the sp shape (4, 128, 256, 64) held to the plain one and timed in
   turns with it and SDPA (the 3 sp steps make 24 of its calls, all at
   "64/64"), ms per DDP and FSDP step.

13. point-to-point and Cartesian topology on 4 rank threads: (a) the
   float32[2^26] operands of phase 4 (and bfloat16 and int32 [2^24]
   messages from the seed) through a ring ``Sendrecv`` of raw tensors and
   of ``DeviceBuffer``s, ``Isend``/``Irecv`` + ``Waitall``, 3
   ``Send_init``/``Recv_init`` rounds and an 8-partition
   ``Psend_init``/``Precv_init`` exchange: every received tensor on cuda
   and bitwise equal to what was sent, no raw receive sharing a sender's
   storage, the DeviceBuffer receives sharing the sender's tensor and
   keeping it after the sender's cell write; then ms per ring round (raw
   against the 4 GiB it moves at the spec rate and at the copy control's
   rate; DeviceBuffer, which moves none), µs per 8-byte round trip of a
   CUDA tensor and of a numpy array, ms per 256 MiB CUDA tensor sent as an
   object; (b) ``examples/06-jacobi.py`` at 16384 x 16384 float32 over
   ``Cart_create(comm, 1, [4], [False], False)``, 50 sweeps of two halo
   ``Sendrecv`` and ``Allreduce(res, MPI.MAX, cart)`` of a one-element CUDA
   tensor: the grid and every residual bitwise equal to the same sweeps on
   the whole grid in one thread, exactly 50 fold launches and no chained
   fold; then ms per sweep (wall clock and CUDA events), device busy per
   sweep under the profiler and the host's share; (c)
   ``Neighbor_allgather``/``Neighbor_alltoall`` on a 2 x 2 non-periodic
   Cart with 1 MiB blocks, bitwise against the plain gather, PROC_NULL
   slots zero or untouched.

14. one-sided RMA, MPI-IO and checkpoints on 4 rank threads: (a) windows
   over the float32[2^26] operands of phase 4, once as raw CUDA tensors
   and once as ``DeviceBuffer``s: a fence epoch of Puts of 2^24-element
   blocks into the right neighbour's window and one of Gets from the left
   neighbour's, an int32 Accumulate SUM from every rank into rank 0, a
   float32 Accumulate one origin per epoch against the plain fold, 1000
   ``Fetch_and_op`` SUMs a rank on rank 0's int64 counter (4000, every
   fetched value once), the dynamic window of test_fetch_and_op_dynamic on
   raw CUDA tensors, and on raw CUDA tensors each rank's Accumulate SUM,
   Get_accumulate REPLACE, Put and Get of 2^24 elements whose origin
   overlaps the target range at displacement 2, each against plain PyTorch
   on a copy: all bitwise, one fold launch per CUDA accumulate and
   none chained; then ms per Put and Get epoch against the bytes bound, us
   per 8-byte Put, Get and Fetch_and_op, ms per 8-byte Put into a 256 MiB
   DeviceBuffer window (the cell copies on write); (b) ``write_at_all`` of
   each rank's CUDA tensor into one 1 GiB file and ``read_at_all`` back into
   fresh CUDA tensors, bitwise, and a strided vector-view read of 1 MiB a
   rank, bitwise, with write and read GB/s; (c) phase 12's ``DDPTrainer``
   and ``FSDPTrainer`` at the flagship width: save after step 1, a fresh
   trainer on the same 4 ranks loads and takes step 2 (bitwise the
   uninterrupted step 2), a 2-rank trainer loads the 4-rank file (bitwise
   the saved state), with save and load seconds and GB/s. Every file lives
   in a temporary directory and is deleted in any case.

15. meshes of several axes at the flagship width (the stacked layout: one
   rank dim per mesh axis), batch 8 x 1024 from the numpy seed, lr 1e-3,
   3 bfloat16 steps on one batch each (losses finite and falling), every
   launch of every kernel counted a step against the count the code gives:
   (a) ``{"dp": 2, "tp": 2, "sp": 2}``: one request through
   ``transformer_forward(..., tp_axis="tp", sp_axis="sp")`` against the
   dense forward (phase 9's bfloat16 bounds; 8 sm90 attention and 16 fold
   launches), ``transformer_train_step`` (8 attention, 83 fold launches a
   step on its eager step and its capture, none on its replay), a float32 step against the dense autograd step of the (dp, sp)
   blocks; (b) ``transformer_pp_moe_train_step`` on ``{"dp": 2, "pp": 2,
   "ep": 2}``, 2 experts, 4 microbatches, capacity 1024 (9 permute, 80
   all-to-all, 20 fold launches a step), a float32 step against a plain
   dense MoE model (every expert on one device, layers in sequence, the
   loss scaled by n_pp as the step's transposed pp psum scales it); (c)
   ``transformer_4d_train_step`` on ``{"dp": 2, "tp": 2, "sp": 2, "pp":
   2}`` (20 attention, 9 permute, 91 fold launches a step), a float32 step
   against the dense step; (d) ``halo_exchange`` over ``{"cy": 2, "cx":
   4}`` at 16 MiB a rank, periodic and not, bitwise against rolls (4
   permute launches each); then for each step ms (CUDA events), tokens/s,
   device busy ms (profiler), the layout copies the collectives make (count,
   bytes, ms replayed alone), peak device memory, and the new backward
   launches (the inverse permute, the exchanged cotangent) against their
   forwards.

16. the multi-process tier: ``python -m tpu_mpi_torch.launcher -n 4
   --procs`` on the card (four OS processes, four CUDA contexts on one
   card), each rank with phase 4's float32[2^26] operand as a CUDA tensor:
   ``Allreduce`` SUM forced by ``TPU_MPI_COLL_ALGO`` on the ring,
   Rabenseifner, recursive-doubling and star tiers at 2^26 and on the shm
   tier at 8 KiB (the star monolithic, ``TPU_MPI_PIPELINE_MIN_BYTES=0``,
   so that its root folds the tensors with the kernel: one fold launch a
   star op at the root, none elsewhere), each result bitwise the
   rank-ordered plain fold (the ring: its own segment order) and served by
   the forced tier's runner; ``Bcast``, ``Allgather``, ``Alltoall`` and a
   ring ``Sendrecv`` of CUDA tensors; a fence epoch of ``Put``/``Get``/
   ``Accumulate`` on windows over CUDA tensors; ``Comm_spawn`` of 2
   children that Allreduce with the parents over the merged intercomm.
   Every result a CUDA tensor, bitwise as expected, no chained fold. Times:
   ms per 2^26 Allreduce a tier with its device-to-host and host-to-device
   staging timed apart, µs per 8-byte Allreduce and 8-byte Sendrecv round
   trip, seconds to start the 4-process world with the native transport
   library uncached and cached. Each rank writes one JSON line; a rank
   that fails, times out or disagrees fails the phase.

17. the serve tier on the card (``benchmarks/serve_scale_sweep.py``'s
   fleet): (a) a threads broker, 4 rank threads, ``device="cuda"``, the
   events transport, ``RLIMIT_NOFILE`` raised to its hard limit: the
   sweep's 8000 tenants cut to 2000 for time (the fair queue sweeps every
   lease a pop; fewer still if the limit allows fewer: two descriptors a
   tenant) attached with the pipelined handshake, each 2 Allreduce SUM of its own
   float32[8]; 16 tenants on float32[64] for 2 s (Jain's index); 200
   float32[4096] ops on the zero-copy lane (copies/op <= 1), pvars on and
   rendered by ``python -m tpu_mpi_torch.stats``; 10 ops of four
   float32[2^24] parts, the ms split into H2D, the fold kernel, D2H and
   the rest; every reply bitwise the rank-ordered fold, exactly one fold
   launch an op (the auto-arm lane included), no chained fold; the
   ``METRICS`` text through ``parse_prometheus``; a client process that
   attaches by ``MPI.Init(session=addr)`` and Allreduces a CUDA tensor;
   float32[8] latency on ``device="cuda"`` against ``device="cpu"``;
   the pool's staging (a buffer kept per rank and shape, which arms the
   auto-arm lane) against a tensor made for every op, on float32[8] and
   float32[4096]; (b) a procs broker, 4 pool processes on the card:
   float32[8] and 4 x float32[2^24] bitwise, one fold launch an op at the
   star root, startup seconds. Also on the threads broker: NaN payloads
   from two ranks, zeros of both signs, inf - inf and 0 * inf in
   float16/32/64[4099] parts under SUM, PROD, MIN and MAX, every reply
   bit for bit numpy's rank-ordered fold on this host (the JAX broker's
   reply), one fold launch each.

18. the inference engine at the flagship's width (``FLAGSHIP``, float32
   shards, max_seq 1024, random weights from the seed) on a threads broker
   of 4 rank threads, ``device="cuda"``, driven by
   ``benchmarks/infer_sweep.py``'s traffic: open-loop 2, 10 and 50
   requests/s for 3 s each, 12-token prompts, 8 new tokens, a 1500 ms SLO,
   in the ``row_loop`` and ``prefix_share`` lanes (a shared 24-token
   system prompt, spec_k 8). Every prompt's streams are one stream in a
   lane; a check set of 6 prompts streams bit for bit the same in both
   lanes, batched and staggered (a check request evicted at its SLO
   deadline, never scheduled, is asked again on its lease up to
   ``INFER_CHECK_RETRIES`` times, the retries counted); two prompts' streams equal the
   ``device="cpu"`` engine's with the same weights and every sampled
   row's final-row logits within ``INFER_LOGIT_TOL`` (the smallest
   top-1/top-2 margin printed); meanwhile one tenant's 50 Allreduce SUM
   of float32[4096] on the pool reply bitwise, one fold launch each.
   Reported per load point: latency p50/p99, per-request and aggregate
   tokens/s, MoE rounds a token, the KV prefix hit rate, SLO evictions;
   and one decode step's CUDA launches and device busy share (profiler),
   device-to-host copies a token, weight and KV bytes a rank, peak
   device memory.

19. an elastic resize under load: ``benchmarks/elastic_sweep.py``'s
   traffic (30 arrivals/s for 6 s, 10 Allreduce of float64[512] a
   tenant 5 ms apart) on a ``device="cuda"`` broker with
   ``elastic=True`` and the engine live; at a third of the run the
   failure verdict for the highest rank lands at an engine step boundary
   while a generation streams. Zero tenants dropped, every reply the
   rank-ordered fold bit for bit, the generation spanning the resize
   streams as an undisturbed one; the resize ms, attach and op p50/p99
   (steady and during the resize) and the rebinds.

20. the analysis tier with ``TPU_MPI_TRACE=1`` on the card: (a) the main
   path traced, 4 rank threads Allreducing phase 4's float32[2^26]
   operands as raw CUDA tensors (22 a rank, each bitwise the plain fold,
   one fold launch each), dumped (``TPU_MPI_TRACE_DUMP``) and merged into
   a Chrome trace (one row a rank, an Allreduce slice a rank an op, fold
   slices): ``verify_trace`` finds nothing, ``explore`` one schedule or
   more, no deadlock, no orphan, not truncated; the host lane's ms per op
   untraced and traced, in turns; (b) ``defect_buffer_reuse``'s program
   on a raw CUDA tensor gives T206 at its Isend's line,
   ``defect_dtype_mismatch``'s on float32/float64 CUDA tensors T202 in
   the words the numpy program gets, ``defect_deadlock_cycle``'s the
   DeadlockError dump; ms per Isend check of a 64 MiB tensor; (c) ``python
   -m tpu_mpi_torch.analyze verify`` of the dump exits 0, ``explore`` of
   ``defect_wildcard_deadlock``'s dump exits 1 with T210; (d) the lint and
   the lock lint over ``tpu_mpi_torch/`` and ``examples/`` find nothing,
   in seconds printed.

21. (a) 0-d operands and complex MAX/MIN on 4 rank threads, with CUDA
   raw tensors and ``DeviceBuffer``s: the 0-d ``Allreduce``, ``Scan``,
   ``Exscan``, ``bcast`` and ``Sendrecv`` of float32, int64 and bfloat16,
   each of shape () and the bits of the rank-ordered fold on the host (the
   fold kernel on 0-d operands first held to its plain version), one fold
   launch per 0-d ``Allreduce``; complex64/complex128 ``Allreduce`` MAX and
   MIN and a complex-window ``Accumulate`` MAX with NaN (payloads included)
   and signed-zero elements, bit for bit numpy's ``np.maximum``/
   ``np.minimum`` in rank order, each a chained fold; (b) every example of
   ``tpu_mpi_torch/examples/`` on the card as a user runs it: through the
   launcher's ``main`` (``tpurun-torch``) with no ``--sim`` (``-n 4``; 8
   for 05, 2 for 09; 11 also ``-n 4 --procs`` with rank 1 killed at sweep
   30, exit 66) or as a plain script (12, 13), ``EXAMPLE_WORKERS`` at a
   time, each in a temporary directory: its exit code, the line it
   asserts or prints, its wall seconds and the fold and ring launches of
   the launching process, added to the ``kernels`` line's counts.

Card comparisons run with TF32 off and bfloat16 reduced-precision
reductions off (``torch.backends.cuda.matmul``), set at the start.

It prints the card line, phase 17's ``serve`` JSON line, phases 18-19's
``infer``/``elastic`` JSON line, phase 20's ``analysis`` JSON line, phase
21's ``phase21`` JSON line, the ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that.
"""

from __future__ import annotations

import json
import operator
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
N_MAIN = 1 << 26            # float32[2^26] = 256 MiB per rank
NRANKS = 4
ALLREDUCE_CALLS = 6         # > auto_arm_threshold (4): arms the lane
INIT_ROUNDS = 3
TIMED_ITERS = 20
WARMUP = 3
PARITY_NS = (2, 4, 5, 17)
PARITY_SIZES = (1, 127, 4097)
BIG_SIZE = (1 << 26) + 3
BIG_NS = (4, 17)
# the fold kernel's two routes, each forced: n = 1 folds into an out; the
# counts are ragged (direct only) and rounded up to whole 16-byte words
# (both routes)
ROUTES = ("staged", "direct")
ROUTE_NS = (1, 2, 4, 5, 16, 17)
ROUTE_COUNTS = (1, 3, 127, 4097, (1 << 20) + 5)
ROUTE_BIG = 1 << 26
# every operand k of ALIAS_N as the fold's out, on both routes
ALIAS_N, ALIAS_DTYPES = 17, ("float32", "int64")
FOLD_TURNS = 5              # readings of each call in phase 6's fold turns
TINY_ITERS = 200            # launches a reading of the tiny folds
RING_NS = (2, 4, 5, 8)
# 4198400 gives blocks of whole 16-byte words at every n and dtype, so the
# reduce-scatter kernel takes its staged route over many tiles
RING_SIZES = (1, 127, 4097, 8229, 4198400, BIG_SIZE)
DTYPES = ("float32", "float64", "float16", "bfloat16", "int8", "int16",
          "int32", "int64", "uint8", "bool")
# phase 3 also folds the unsigned types torch itself does not fold
FOLD_DTYPES = DTYPES + ("uint16", "uint32", "uint64")
ALL_OPS = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR")
# the fold's numpy rules (the serve tier's), on float16/32/64
NUMPY_OPS = ("NUMPY_SUM", "NUMPY_PROD", "NUMPY_MAX", "NUMPY_MIN")
PERMUTE_NS = (2, 4, 5, 8)
# odd sizes take the narrow words; 4096 elements (and shards of them) the
# 16-byte words of every dtype
PERMUTE_SIZES = (1, 127, 4096, 4097, (1 << 22) + 3)
ATTN_NS = (1, 2, 4)
ATTN_TS = (8, 72, 256)
ATTN_DS = (8, 36, 64, 128)     # 36: the bfloat16 head dim off the sm90 route
ATTN_BH = 2
# benchmarks/flagship_probe.py:34-35, nothing cut
FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096)
BATCH, SEQ, SP = 8, 1024, 4
REQUESTS = 3
# the sp logits against the dense forward: bfloat16 rounds every layer's
# activations, and the two attentions round P and their sums at other
# places, so the logits (of order 1) drift apart by a few bfloat16 ulps
MODEL_TOL = {"bfloat16": 0.125, "float32": 1e-4}
MODEL_AGREE = {"bfloat16": 0.95, "float32": 0.999}
RECIPE_TOL = 3e-2       # bfloat16 recipes against their references
MOE_TOKENS, MOE_CAPACITY = 2048, 1024
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}   # spec sheet, dense
# the Moonlight cell's shapes (portbench moonlight.ep4.b4x4096): one
# latent-attention launch for 4 ranks x 16 heads, (ranks, batch-heads, t,
# q/k dim, v dim); one MoE exchange padded to the cell's mean block
# (ranks, ranks, rows a block, d), and the rows it routes, 4 x 4096 x 6
MLA_SHAPE = (1, 64, 4096, 192, 128)
MOE_EXCHANGE = (4, 6756, 2048)
MOE_ROUTED_ROWS = 4 * 4096 * 6
# phase 12: training at the flagship width (benchmarks/flagship_probe.py's lr)
TRAIN_STEPS, TRAIN_LR = 3, 1e-3
TRAIN_TRAINER_STEPS, TRAIN_BUCKET_BYTES = 20, 25 << 20
# step 0's bfloat16 loss against the dense step's: both average the same
# float32 cross-entropy of logits that drift by a few bfloat16 ulps
# (MODEL_TOL) at single positions, so the means of 8192 positions agree
# far closer than one logit
TRAIN_LOSS_TOL = 0.02
# the float32 step's updates against the dense step's, relative to the
# largest update of each tensor: float32 sums in other orders through
# eight layers; at lr 1 the update stands clear of the parameter's own
# float32 rounding
TRAIN_LR_F32, TRAIN_F32_TOL = 1.0, 1e-3
# phase 13: point-to-point and Cartesian topology on rank threads
P2P_SIDE = 1 << 24          # the bfloat16 and int32 messages, elements
P2P_PARTS = 8
P2P_ROUNDS = 3              # Send_init / Recv_init rounds
P2P_RING_ITERS = 10         # timed ring rounds (median)
PINGPONG = 1000             # 8-byte round trips
OBJECT_ITERS = 3            # 256 MiB object send/recv (median)
JACOBI_N = 16384            # global grid JACOBI_N x JACOBI_N float32, 1 GiB
JACOBI_SWEEPS = 50
JACOBI_TIMED = 20
NEIGHBOR_COUNT = 1 << 18    # float32 blocks of 1 MiB
# phase 14: one-sided RMA, MPI-IO and checkpoints
RMA_BLOCK = 1 << 24         # float32 elements a rank Puts or Gets an epoch
RMA_INT = 1 << 24           # int32 Accumulate windows, elements
FETCHES = 1000              # Fetch_and_op SUMs a rank on rank 0's counter
RMA_EPOCH_ITERS = 5         # timed Put and Get epochs (median)
RMA_SMALL_ITERS = 200       # timed 8-byte ops on raw-tensor windows
RMA_CELL_ITERS = 20         # ... on DeviceBuffer windows (copy on write)
OVERLAP_SHIFT = 2           # target displacement of the overlapping origins
IO_STRIDED = 1 << 18        # float32 elements a rank reads through a strided view
# phase 15: meshes of several axes, the flagship's width and batch
MESH_A = {"dp": 2, "tp": 2, "sp": 2}
MESH_B = {"dp": 2, "pp": 2, "ep": 2}
MESH_C = {"dp": 2, "tp": 2, "sp": 2, "pp": 2}
MESH_D = {"cy": 2, "cx": 4}
MULTI_MICRO = 4             # microbatches of the pipelined steps
MOE_EXPERTS = 2             # one a rank of ep
HALO_SIDE = 2048            # float32 2048 x 2048 = 16 MiB a rank
MULTI_TIMED = 3             # timed steps (CUDA events)
# phase 16: the multi-process tier, 4 rank processes on the one card
PROC_TIERS = ("ring", "rabenseifner", "rdouble", "star")   # at float32[2^26]
PROC_SHM_ELEMS = 2048       # float32: the shm tier's 8 KiB
PROC_ITERS = 3              # timed float32[2^26] Allreduce ops a tier
PROC_SMALL_ITERS = 300      # timed 8-byte ops and 8 KiB shm ops
# phase 17: the serve tier (benchmarks/serve_scale_sweep.py's defaults:
# --tenants 8000, --ops 2, --drivers 32, --fair-tenants 16)
SERVE_TOKEN = "chip-smoke"
SERVE_TENANTS = 8000        # cut to what RLIMIT_NOFILE allows, if less
# cut for time: the fair queue's DRR sweep visits every leased tenant a
# pop, so ops/s falls as the fleet grows; 8000 tenants took the phase
# 412 s on an NVIDIA H100 80GB HBM3 at 700 W (16000 ops at 78.7 ops/s,
# PERF.md §6), 2000 take it about 94 s
SERVE_FLEET_CUT = 2000
SERVE_OPS = 2               # Allreduce SUM of float32[8] a tenant
SERVE_DRIVERS = 32
SERVE_FAIR_TENANTS, SERVE_FAIR_S = 16, 2.0      # float32[64], 2 s (sweep: 5)
SERVE_ZC_REPS = 200         # float32[4096] on the zero-copy lane
SERVE_BULK = 1 << 24        # float32 a rank part: 64 MiB
SERVE_BULK_OPS = 10
SERVE_LAT_OPS = 300         # one tenant's sequential float32[8] ops
SERVE_PROCS_SMALL = 20      # procs broker: float32[8] ops
SERVE_PROCS_BULK = 2        # ... and 4 x float32[2^24] ops
SERVE_AB_OPS, SERVE_AB_WARM = 150, 20   # the staging A/B, a block of ops
# phase 18: the inference engine at the flagship's width
# (benchmarks/infer_sweep.py's defaults: 4 ranks, loads 2, 10, 50 req/s for
# 3 s each, 12-token prompts, 8 new tokens, a 1500 ms SLO, lanes row_loop
# and prefix_share; the model is benchmarks/flagship_probe.py's, float32)
INFER_LOADS = (2.0, 10.0, 50.0)
INFER_DURATION = 3.0
INFER_PROMPT, INFER_NEW = 12, 8
INFER_SLO_MS = 1500
INFER_MAX_CLIENTS = 48
INFER_MAX_SEQ = 1024
INFER_MODES = {
    "row_loop": {"vectorized": False, "spec_k": 1, "prefix_share": False},
    "prefix_share": {"vectorized": True, "spec_k": 8, "prefix_share": True},
}
INFER_SYS_PROMPT = [(11 * j + 5) % 64 for j in range(24)]
INFER_TENANT_OPS = 50       # float32[4096] Allreduce SUM beside the engine
INFER_COMPARE = 2           # prompts held against the CPU engine
# the card's final-row logits against the CPU engine's: float32 sums of
# 1024 and 4096 products in other orders (cuBLAS, the CPU BLAS) through 8
# layers; the logits are of order 1
INFER_LOGIT_TOL = 1e-3
INFER_PROFILE_DECODES = 8
# a check-set request evicted at the SLO deadline is asked again this often
INFER_CHECK_RETRIES = 3
# phase 19: an elastic resize under load (benchmarks/elastic_sweep.py's
# defaults: 30 arrivals/s for 6 s, 4 KiB float64 ops, 10 a tenant 5 ms
# apart, 32 clients at once, the highest rank's verdict at a third of the
# run), with the engine live and a generation spanning the resize
ELASTIC_RPS, ELASTIC_DURATION = 30.0, 6.0
ELASTIC_NBYTES, ELASTIC_OPS, ELASTIC_OP_INTERVAL = 1 << 12, 10, 0.005
ELASTIC_MAX_CLIENTS = 32
ELASTIC_GEN_NEW = 48
PROC_RMA = 1 << 22          # window, Allgather and Alltoall elements a rank
PROC_SPAWN = 1 << 20        # float32 elements of the merged-world Allreduce
PROC_TIMEOUT = 600          # seconds the 4-process world may take
# phase 20: the analysis tier (TPU_MPI_TRACE=1) on the main path's operands
ANALYSIS_OPS = 20           # timed Allreduce SUMs a rank, after 2 warm-up ops
ANALYSIS_TURNS = 3          # untraced / traced turns of the host lane
ISEND_CHECK_BYTES = 64 << 20
ANALYSIS_CHECK_ITERS = 10


# phase 21: 0-d operands of these dtypes; complex elements of every NaN
# and signed-zero kind numpy's complex MAX/MIN orders
ZERO_D_DTYPES = ("float32", "int64", "bfloat16")
COMPLEX_SPECIALS = (complex(np.nan, 0.0), complex(0.0, np.nan),
                    complex(0.0, 0.0), complex(-0.0, 0.0), complex(0.0, -0.0),
                    complex(1.0, 2.0), complex(1.0, 3.0),
                    complex(-np.inf, np.nan))
# the examples on the card: (name, launcher arguments or None for plain
# python, extra environment, exit code, the line each asserts or prints);
# 11's second run kills rank 1 at sweep 30 and exits 66, shrunk and done
EXAMPLES = (
    ("01-hello", ["-n", "4"], {}, 0, r"Hello world, I am rank 3 of 4"),
    ("02-broadcast", ["-n", "4"], {}, 0,
     r"rank = 3, A = \[1\. \+2\.j 2\. \+4\.j 3\. \+6\.j 4\. \+8\.j 5\.\+10\.j\]"),
    ("03-reduce", ["-n", "4"], {}, 0, r"sum of ranks = 6"),
    ("04-sendrecv", ["-n", "4"], {}, 0,
     r"0: Received 3 -> 0 = \[3\. 3\. 3\. 3\.\]"),
    ("05-ingraph", ["-n", "8"], {}, 0,
     r"in-graph psum over 8 devices: \[112\. 120\. 128\. 136\.\]"),
    ("06-jacobi", ["-n", "4"], {}, 0,
     r"converged after 1338 sweeps \(residual < 0\.0001\); "
     r"total heat = 839\.053"),
    ("07-overlap", ["-n", "4"], {}, 0,
     r"overlap ok: 4 ranks, local=[\d.]+, grad sum=10"),
    ("08-checkpoint", ["-n", "4"], {}, 0,
     r"checkpointed \+ restored 4 shards of 1024 f64 each: ok"),
    ("09-partitioned", ["-n", "2"], {}, 0,
     r"consumer: processed every partition on arrival, checksum ok"),
    ("10-observability", ["-n", "4"], {}, 0,
     r"p2p: 1 sends / 8 B out, 1 recvs / 8 B in"),
    ("11-jacobi-ft", ["-n", "4"], {}, 0,
     r"converged after 1338 sweeps on 4 rank\(s\) \(residual < 0\.0001\); "
     r"total heat = 839\.053"),
    ("11-jacobi-ft", ["-n", "4", "--procs"],
     {"TPU_MPI_HEARTBEAT_MS": "100", "TPU_MPI_FT_KILL_SWEEP": "30"}, 66,
     r"converged after 1338 sweeps on 3 rank\(s\) \(residual < 0\.0001\); "
     r"total heat = 839\.053"),
    ("12-serve", None, {}, 0,
     r"done: two tenants, one warm pool, disjoint namespaces"),
    ("13-moe-serve", None, {}, 0,
     r"done: batched and solo greedy decode agree bitwise"),
    ("14-ddp-train", ["-n", "4"], {}, 0,
     r"trained 6 steps on 4 rank\(s\); loss [\d.]+ -> [\d.]+"),
)
EXAMPLE_TIMEOUT = 240
EXAMPLE_WORKERS = 3         # one at a time took phase 21b 161.9 s, two 82.2 s


def kernel_counts():
    """The kernel layer's one table of launch counts: ``kernel_counts()[key]``
    reads a key of ``perfvars.kernels_snapshot()``, ``kernel_counts().reset()``
    zeroes every count."""
    from tpu_mpi_torch.kernels._build import counts
    return counts


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[0].strip()
    if not line:
        raise RuntimeError("nvidia-smi printed no card")
    return line


# ---------------------------------------------------------------------------
# 3. kernel against plain
# ---------------------------------------------------------------------------

def _int_view(t):
    import torch
    return {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]


def same_bits(a, b) -> bool:
    """Bitwise equality; for floats, NaN positions must match and every
    other element must match bit for bit (so +0 and -0 differ). Unsigned
    types wider than a byte compare as their signed views (torch has no
    compare kernels for them)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype in (torch.uint16, torch.uint32, torch.uint64):
        return bool(torch.equal(a.view(_int_view(a)), b.view(_int_view(b))))
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    keep = ~na
    return bool(torch.equal(a[keep].view(_int_view(a)),
                            b[keep].view(_int_view(b))))


def max_abs_err(a, b) -> float:
    import torch
    if a.dtype in (torch.uint16, torch.uint32, torch.uint64):
        return 0.0 if same_bits(a, b) else float("inf")
    if not a.dtype.is_floating_point:
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
    keep = ~(torch.isnan(a) | torch.isnan(b))
    d = (a[keep].to(torch.float64) - b[keep].to(torch.float64)).abs()
    d = torch.nan_to_num(d, nan=0.0, posinf=0.0)   # inf - inf where both inf
    return float(d.max()) if d.numel() else 0.0


def operands(dtype, n: int, size: int, device, gen):
    """n seeded operands of one dtype, stacked to (n, size): normal floats,
    integers across the whole range of the narrow types (so SUM and PROD
    wrap), random bits of the unsigned types, 0/1 bools."""
    import torch
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        width = torch.empty((), dtype=dtype).element_size()
        return torch.randint(0, 256, (n, size * width), generator=gen,
                             device=device, dtype=torch.uint8).view(dtype)
    if dtype.is_floating_point:
        return torch.randn(n, size, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, (n, size), generator=gen,
                             device=device).bool()
    info = torch.iinfo(dtype)
    lo, hi = (info.min, info.max) if info.bits <= 16 else (-1000, 1000)
    return torch.randint(lo, hi + 1, (n, size), generator=gen, device=device,
                         dtype=torch.int64).to(dtype)


def special_operands(dtype, n: int, size: int, device, gen):
    """(n, size) operands drawn from {NaN, -0, +0, -1, 1}: the MAX/MIN edge
    cases."""
    import torch
    pool = torch.tensor([float("nan"), -0.0, 0.0, -1.0, 1.0], device=device,
                        dtype=dtype)
    return pool[torch.randint(0, 5, (n, size), generator=gen, device=device)]


def exact_bits(a, b) -> bool:
    """Bit-for-bit equality of two float tensors, NaN payloads and signs
    included (the serve tier's replies carry numpy's NaN bits)."""
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(a.view(_int_view(a)), b.view(_int_view(b)))))


# float16/32/64 bit patterns of the numpy rules' edge cases: quiet and
# signalling NaNs of both signs with payloads, then the smallest subnormal
NUMPY_NAN_BITS = {
    "float16": (0x7E12, 0xFE34, 0x7C05, 0xFC21, 0x0001),
    "float32": (0x7FC01234, 0xFFC05678, 0x7F800005, 0xFF800021, 0x00000001),
    "float64": (0x7FF8000000001234, 0xFFF8000000005678, 0x7FF0000000000005,
                0xFFF0000000000021, 0x0000000000000001),
}


def numpy_special_operands(dtype, n: int, size: int, device, gen):
    """(n, size) operands drawn from NUMPY_NAN_BITS, infinities, signed
    zeros, the largest finite value and numbers: every case of the
    numpy rules' NaN, invalid-operation and tie steps."""
    import torch
    name = str(dtype).split(".")[1]
    bits = np.array(NUMPY_NAN_BITS[name], np.dtype(name).str.replace("f", "u"))
    nans = torch.from_numpy(bits.view(np.dtype(name)))
    plain = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0, 1.5, -2.25,
                          torch.finfo(dtype).max], dtype=dtype)
    pool = torch.cat([nans, plain]).to(device)
    return pool[torch.randint(0, pool.numel(), (n, size), generator=gen,
                              device=device)]


def check_parity(fr, device, sizes=PARITY_SIZES, ns=PARITY_NS,
                 big_size=BIG_SIZE, big_ns=BIG_NS) -> dict:
    """Kernel against plain on every case; returns counts and the largest
    absolute difference seen (0.0 when every case is bitwise)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dtypes = [getattr(torch, d) for d in FOLD_DTYPES]
    cases, worst = 0, 0.0

    def one(xs, op, what, exact=False):
        nonlocal cases, worst
        xs = list(xs)
        want = fr.fused_multi_reduce_plain(xs, op)
        got = fr.fused_multi_reduce(xs, op)
        torch.cuda.synchronize()
        if not (exact_bits if exact else same_bits)(got, want):
            raise AssertionError(f"kernel != plain: {what} "
                                 f"max_abs_err={max_abs_err(got, want)}")
        worst = max(worst, max_abs_err(got, want))
        cases += 1

    for dtype in dtypes:
        ops = [op for op in ALL_OPS if fr.supports(op, dtype)]
        for size in sizes:
            for n in ns:
                xs = operands(dtype, n, size, device, gen)
                for op in ops:
                    one(xs, op, f"{dtype} {op} n={n} size={size}")
        for n in big_ns:
            xs = operands(dtype, n, big_size, device, gen)
            for op in ops:
                one(xs, op, f"{dtype} {op} n={n} size={big_size}")
            del xs
        if dtype.is_floating_point:
            for size in (*sizes, big_size):
                for n in ns:
                    xs = special_operands(dtype, n, size, device, gen)
                    for op in ("MAX", "MIN"):
                        one(xs, op, f"{dtype} {op} NaN/±0 n={n} size={size}")
        if fr.supports("NUMPY_SUM", dtype):
            # the serve tier's numpy rules: every NaN payload, bit for bit
            for size, nn in [(size, ns) for size in sizes] + [(big_size,
                                                               big_ns[:1])]:
                for n in nn:
                    for xs in (operands(dtype, n, size, device, gen),
                               numpy_special_operands(dtype, n, size, device,
                                                      gen)):
                        for op in NUMPY_OPS:
                            one(list(xs), op, f"{dtype} {op} n={n} "
                                f"size={size}", exact=True)
                    del xs

    # what the kernel does not take raises instead of running
    x = torch.randn(2 * 4097, device=device, generator=gen)
    strided = [x[::2], x[1::2]]
    try:
        fr.fused_multi_reduce(strided, "SUM")
    except ValueError:
        pass
    else:
        raise AssertionError("a non-contiguous operand did not raise")
    return {"cases": cases, "max_abs_err": worst}


def check_fold_routes(fr, device, ns=ROUTE_NS, counts=ROUTE_COUNTS,
                      big=ROUTE_BIG) -> dict:
    """Each route of the fold kernel, forced through the wrapper's ``via``,
    against the plain version, bitwise (the numpy rules bit for bit): every
    dtype and op at each n (n = 1 into an ``out``), ragged counts on the
    direct route and the same counts rounded up to whole 16-byte words on
    both; views at a 1-element storage offset (the direct route, chosen
    and refused the staged one); ``out`` aliasing operand 0 on both, and
    every operand k of ALIAS_N (float32 and int64, SUM and MAX; k = 16 is
    past the first launch); and ``big`` float32 elements at n 4 and 17 on
    both. Returns the cases,
    the largest absolute difference and the launches by route."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    kernel_counts().reset()
    cases, worst = 0, 0.0

    def one(xs, op, way, what, out=None, chosen=False):
        """One fold on ``way``: forced, or (``chosen``) the wrapper's pick."""
        nonlocal cases, worst
        want = fr.fused_multi_reduce_plain(xs, op)
        if out is not None and any(out.data_ptr() == x.data_ptr() for x in xs):
            want = want.clone()
        before = kernel_counts()["fold_route_launches"][way]
        got = fr.fused_multi_reduce(xs, op, out=out, via=None if chosen else way)
        torch.cuda.synchronize()
        if kernel_counts()["fold_route_launches"][way] != before + 1:
            raise AssertionError(f"fold on {way} not counted there: {what}")
        if out is not None and got is not out:
            raise AssertionError(f"fold did not fill its out: {what}")
        if not (exact_bits if op.startswith("NUMPY") else same_bits)(got, want):
            raise AssertionError(f"fold kernel != plain on the {way} route: {what} "
                                 f"max_abs_err={max_abs_err(got, want)}")
        worst = max(worst, max_abs_err(got, want))
        cases += 1

    def refuses_staged(xs, what):
        try:
            fr.fused_multi_reduce(xs, "SUM", out=torch.empty_like(xs[0]), via="staged")
        except ValueError:
            return
        raise AssertionError(f"the staged route took {what}")

    for dname in FOLD_DTYPES:
        dtype = getattr(torch, dname)
        ops = [op for op in ALL_OPS + NUMPY_OPS if fr.supports(op, dtype)]
        v = 16 // dtype.itemsize
        for n in ns:
            for count in counts:
                words = -(-count // v) * v
                for size, ways in {count: ("direct",), words: ROUTES}.items():
                    # each operand its own allocation (16-byte aligned)
                    xs = [x.clone() for x in operands(dtype, n, size, device,
                                                      gen).unbind(0)]
                    if size % v:
                        refuses_staged(xs, f"{dname} n={n} size={size}")
                    for op in ops:
                        for way in ways:
                            one(xs, op, way, f"{dname} {op} n={n} size={size}",
                                out=torch.empty_like(xs[0]))
                # views at a 1-element offset: the direct route, chosen
                base = operands(dtype, n + 1, count + 1, device, gen)
                xs = [base[k, 1:] for k in range(n)]
                if fr.route(xs, base[n, 1:]) != "direct":
                    raise AssertionError(f"offset views staged: {dname} n={n}")
                refuses_staged(xs, f"offset views {dname} n={n} size={count}")
                for op in ops:
                    one(xs, op, "direct", f"offset {dname} {op} n={n} size={count}",
                        out=base[n, 1:], chosen=True)
            # out aliasing operand 0 on both routes (n = 17: a chained launch)
            for way in ROUTES:
                for op in ("SUM", "MAX"):
                    xs = [x.clone() for x in operands(dtype, n, 4096 * v, device,
                                                      gen).unbind(0)]
                    one(xs, op, way, f"{dname} {op} n={n} into operand 0",
                        out=xs[0])
    # out aliasing every operand k of 17 on both routes: past the first
    # launch's 16 (k = 16) the wrapper folds fresh and copies in
    for dname in ALIAS_DTYPES:
        dtype = getattr(torch, dname)
        v = 16 // dtype.itemsize
        for k in range(ALIAS_N):
            for way in ROUTES:
                for op in ("SUM", "MAX"):
                    xs = [x.clone() for x in operands(dtype, ALIAS_N, 4096 * v,
                                                      device, gen).unbind(0)]
                    one(xs, op, way, f"{dname} {op} n={ALIAS_N} into operand "
                        f"{k}", out=xs[k])
    for n in (4, 17):
        for size, ways in ((big, ROUTES), (big + 3, ("direct",))):
            xs = [torch.randn(size, generator=gen, device=device) for _ in range(n)]
            for way in ways:
                for op in ("SUM", "NUMPY_SUM"):
                    one(xs, op, way, f"float32 {op} n={n} size={size}",
                        out=torch.empty_like(xs[0]))
            del xs
    routes = dict(kernel_counts()["fold_route_launches"])
    if min(routes.values()) < 1:
        raise AssertionError(f"a fold route went untested: {routes}")
    return {"cases": cases, "max_abs_err": worst, "routes": routes}


def check_ring_parity(MPI, ring, device, ns=RING_NS, sizes=RING_SIZES) -> dict:
    """Each ring kernel against its plain version on every case; returns
    per-kernel case counts and largest absolute differences."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    cases = dict.fromkeys(ring.REPLACES, 0)
    worst = dict.fromkeys(ring.REPLACES, 0.0)
    kernel_counts().reset()

    def one(name, got, want, what):
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"{name} kernel != plain: {what} "
                                 f"max_abs_err={max_abs_err(got, want)}")
        worst[name] = max(worst[name], max_abs_err(got, want))
        cases[name] += 1

    def reductions(xs, blocks, ops, what):
        for name in ops:
            op = getattr(MPI, name)
            combine = ring._combine_fn(op)[1]
            one("ring_allreduce", ring.ring_allreduce(xs, op),
                ring.ring_allreduce_plain(xs, combine), f"{name} {what}")
            one("ring_reduce_scatter", ring.ring_reduce_scatter(blocks, op),
                ring.ring_reduce_scatter_plain(blocks, combine),
                f"{name} {what}")

    for dname in FOLD_DTYPES:
        dtype = getattr(torch, dname)
        ops = [op for op in ALL_OPS if ring.supports(op, dtype)]
        for size in sizes:
            for n in ns:
                per = -(-size // n)
                what = f"{dname} n={n} size={size}"
                xs = operands(dtype, n, size, device, gen)
                blocks = operands(dtype, n, n * per, device, gen)
                reductions(xs, blocks, ops, what)
                shards = operands(dtype, n, per, device, gen)
                one("ring_allgather", ring.ring_allgather(shards),
                    ring.ring_allgather_plain(shards), what)
                if dtype.is_floating_point:
                    xs = special_operands(dtype, n, size, device, gen)
                    blocks = special_operands(dtype, n, n * per, device, gen)
                    reductions(xs, blocks, ("MAX", "MIN"), f"NaN/±0 {what}")
                del xs, blocks, shards

    # what the kernels do not take raises instead of running
    x = torch.randn(4, 2 * 4097, device=device, generator=gen)
    for call in (lambda: ring.ring_allreduce(x[:, ::2], "sum"),
                 lambda: ring.ring_reduce_scatter(x[:, ::2], "sum"),
                 lambda: ring.ring_allgather(x[:, ::2])):
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError("a non-contiguous stacked tensor did not raise")
    routes = dict(kernel_counts()["ring_route_launches"])
    if min(routes.values()) < 1:
        raise AssertionError(f"a reduce-scatter route went untested: {routes}")
    return {"cases": cases, "max_abs_err": worst, "routes": routes}


# ---------------------------------------------------------------------------
# 4. host main path
# ---------------------------------------------------------------------------

def host_operands(n_elems: int, nranks: int) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(n_elems, dtype=np.float32)
            for _ in range(nranks)]


def main_path(MPI, host: list, device) -> dict:
    """Drive the port through its user entry points on ``len(host)`` rank
    threads; assert every result against the plain fold, bitwise."""
    import torch
    from tpu_mpi_torch.kernels import fused_reduce as fr
    nranks = len(host)
    want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(h).to(device) for h in host], "SUM")

    def on_device(t, what):
        if t.device.type != torch.device(device).type:
            raise AssertionError(f"{what} is on {t.device}, not {device}")

    def check(t, what):
        on_device(t, what)
        if not same_bits(t, want):
            raise AssertionError(f"{what} differs from the plain fold")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(host[r], device=device)
        y = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        on_device(x.value, "x")
        on_device(y.value, "y")
        for i in range(ALLREDUCE_CALLS):
            MPI.Allreduce(x, y, MPI.SUM, comm)
            check(y.value, f"Allreduce call {i}")
        z = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        req = MPI.Allreduce_init(x, z, MPI.SUM, comm)
        slots = []
        for i in range(INIT_ROUNDS):
            MPI.Start(req)
            MPI.Wait(req)
            check(z.value, f"Allreduce_init round {i}")
            slots.append(z.value.data_ptr())
        red = MPI.Reduce(x, MPI.SUM, 0, comm)
        if r == 0:
            check(red.value, "Reduce at root")
        elif red is not None:
            raise AssertionError("Reduce returned a result off the root")
        MPI.Finalize()
        return slots

    slots = MPI.spmd_run(body, nranks, timeout=600)
    # the persistent lane writes into preallocated slots (two per rank's
    # registration) and never reuses round k's slot in round k+1
    for s in slots:
        if any(a == b for a, b in zip(s, s[1:])) or len(set(s)) > 2 * nranks:
            raise AssertionError(f"Allreduce_init slots misused: {s}")
    return {"ops": ALLREDUCE_CALLS + INIT_ROUNDS + 1}


# ---------------------------------------------------------------------------
# 5. in-graph path
# ---------------------------------------------------------------------------

def ingraph_path(MPI, xla, xs) -> dict:
    """The in-graph tier's entry points on the stacked (n, count) tensor:
    the DDP-shaped ring allreduce, the FSDP round trip (ring reduce-scatter
    to shards, ring allgather back), and the xla collectives."""
    import torch
    n = xs.shape[0]
    out = {"ring_allreduce": xla.ring_allreduce(xs, "sum")}
    out["ring_reduce_scatter"] = xla.ring_reduce_scatter(xs, "sum")
    out["ring_allgather"] = xla.ring_allgather(
        out["ring_reduce_scatter"]).reshape(n, -1)
    out["xla.allreduce"] = xla.allreduce(xs, MPI.SUM, axis="x")
    out["xla.reduce_scatter"] = xla.reduce_scatter(xs, MPI.SUM, axis="x")
    out["xla.allgather"] = xla.allgather(out["xla.reduce_scatter"], axis="x",
                                         tiled=True)
    torch.cuda.synchronize()
    return out


def check_ingraph(ring, fr, xs, out: dict) -> float:
    """Every in-graph result against its plain version, bitwise and on the
    card; returns the largest absolute difference (0.0 when bitwise)."""
    import torch
    n, count = xs.shape
    left = fr.fused_multi_reduce_plain(list(xs), "SUM")
    shards = ring.ring_reduce_scatter_plain(xs, operator.add)
    want = {
        "ring_allreduce": ring.ring_allreduce_plain(xs, operator.add),
        "ring_reduce_scatter": shards,
        "ring_allgather": ring.ring_allgather_plain(shards).reshape(n, -1),
        "xla.allreduce": left.expand(n, count),
        "xla.reduce_scatter": left.view(n, count // n),
        "xla.allgather": left.expand(n, count),
    }
    worst = 0.0
    for name, got in out.items():
        if got.device.type != "cuda":
            raise AssertionError(f"{name} result is on {got.device}")
        if not same_bits(got, want[name]):
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"max_abs_err={max_abs_err(got, want[name])}")
        worst = max(worst, max_abs_err(got, want[name]))
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = TIMED_ITERS, warmup: int = WARMUP) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def host_lane_ms(MPI, host: list, device, iters: int = TIMED_ITERS) -> float:
    """Wall time per host-lane ``MPI.Allreduce`` on the rank threads,
    ending in a device synchronise (rank 0's clock)."""
    import torch

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(host[r], device=device)
        y = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        for _ in range(WARMUP + 2):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        t0 = time.perf_counter()
        for _ in range(iters):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        dt = time.perf_counter() - t0
        MPI.Finalize()
        return dt

    return max(MPI.spmd_run(body, len(host), timeout=600)) / iters * 1e3


def host_lane_profile(MPI, host: list, device, logdir: str,
                      iters: int = 10) -> dict:
    """A ``torch.profiler`` trace (``MPI.profile_trace``, held by rank 0)
    over ``iters`` host-lane Allreduce ops: the device's busy share of the
    window, from the kernel, memcpy and memset spans of the Chrome trace."""
    import torch

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(host[r], device=device)
        y = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        for _ in range(WARMUP + 2):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        with MPI.profile_trace(logdir):
            t0 = time.perf_counter()
            for _ in range(iters):
                MPI.Allreduce(x, y, MPI.SUM, comm)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
            MPI.Barrier(comm)
        MPI.Finalize()
        return window_us

    window_us = MPI.spmd_run(body, len(host), timeout=600)[0]
    trace = max((os.path.join(logdir, f) for f in os.listdir(logdir)),
                key=os.path.getmtime)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    fold = [e for e in spans if "fused_fold_kernel" in e.get("name", "")]
    busy_us = sum(float(e["dur"]) for e in spans)
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3,
            "fold_ms": sum(float(e["dur"]) for e in fold) / 1e3,
            "fold_spans": len(fold), "iters": iters, "trace": trace}


def bound(nbytes: int, flops: int, caps: dict) -> tuple:
    """The least time the card could take: bytes at the spec HBM rate or
    float32 operations at the spec peak, whichever is larger."""
    bytes_ms = nbytes / (caps["hbm_gbps"] * 1e9) * 1e3
    ops_ms = flops / (caps["fp32_tflops"] * 1e12) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def turns(kernel, library, readings: int = 3, others: dict = None) -> dict:
    """Kernel and library call timed in turns, ``readings`` of each, and of
    each of ``others`` (name -> call), the order reversed every other turn
    (kernel, library, others..., then back): the medians, and every reading
    for the spread (``<name>_ms`` and ``<name>_ms_turns`` for the others)."""
    calls = {"": kernel, "library_": library, **{f"{k}_": f for k, f in
                                                  (others or {}).items()}}
    got = {k: [] for k in calls}
    order = list(calls)
    for i in range(readings):
        for k in (order if i % 2 == 0 else order[::-1]):
            got[k].append(time_ms(calls[k]))
    out = {}
    for k, ms in got.items():
        out[f"{k}ms"] = float(np.median(ms))
        out[f"{k}ms_turns"] = ms
    return out


def reduce_scatter_from(lib, xs):
    """``ring_reduce_scatter(xs, "sum")`` through another tree's build of
    ``ring.cu``, uncounted: an entry that takes no route (the form before
    the staged route) or one that does (given the staged route, which
    phase 5 holds the in-graph operands to)."""
    from tpu_mpi_torch.kernels import _build
    from tpu_mpi_torch.kernels.fold_ops import DTYPE_CODE, OP_CODE
    n = xs.shape[0]
    out = xs.new_empty((n, xs.shape[1] // n))
    routed = hasattr(lib.load(), "tmt_ring_reduce_scatter_tile")
    _build.call(lib.fn("tmt_ring_reduce_scatter"), xs.device, "ring_reduce_scatter",
                xs.data_ptr(), out.data_ptr(), n, out.shape[1], DTYPE_CODE[xs.dtype],
                OP_CODE["SUM"], *((0,) if routed else ()))
    return out


def fold_from(lib, xs, out):
    """``fused_multi_reduce(xs, "SUM", out=out)`` through another tree's
    build of ``fused_reduce.cu``, uncounted: an entry that takes no route
    (the design before the staged route) or one that does (given the route
    this tree's wrapper picks)."""
    import ctypes
    from tpu_mpi_torch.kernels import _build, fused_reduce as fr
    from tpu_mpi_torch.kernels.fold_ops import DTYPE_CODE, OP_CODE
    routed = hasattr(lib.load(), "tmt_fused_reduce_tile")
    ptrs = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    _build.call(lib.fn("tmt_fused_reduce"), xs[0].device, "fused_multi_reduce",
                ptrs, len(xs), out.data_ptr(), xs[0].numel(),
                DTYPE_CODE[xs[0].dtype], OP_CODE["SUM"],
                *((fr.ROUTES.index(fr.route(xs, out)),) if routed else ()))
    return out


def fold_times(fr, xl: list, xs, caps: dict, against: dict, logdir: str) -> dict:
    """The fold at the main paths' shape, n x float32[2^26]: on the host
    path's operands (``xl``, one tensor a rank) and on the rows of the
    stacked (n, 2^26) tensor ``xs`` (the in-graph path's), each in turns
    with ``xs.sum(0)`` (the same function over the same bytes in one
    PyTorch call: the library yardstick), the kernel's own direct route and
    other trees' kernels (``against``, each first held bitwise to this
    tree's); ``torch.stack(xl).sum(0)`` joins the host operands' turns.
    Then the tiny folds (the serve tier's float32[8] x 4, RMA's 8-byte
    float64[1] x 2) per call and per device span, on each route that
    takes them."""
    import torch
    n, count = xs.shape
    out = torch.empty_like(xl[0])
    rows = list(xs)
    want = fr.fused_multi_reduce_plain(xl, "SUM")
    for ops in (xl, rows):
        if fr.route(ops, out) != "staged":
            raise AssertionError("the main paths' fold operands would not stage")
        if not same_bits(fr.fused_multi_reduce(ops, "SUM", out=out), want):
            raise AssertionError("the fold at the main paths' shape != plain")
        for label, lib in against.items():
            if not same_bits(fold_from(lib["fold"], ops, out), want):
                raise AssertionError(f"fused_multi_reduce of {label} != this tree's")
    del want

    def kernel(ops, way=None):
        return lambda: fr.fused_multi_reduce(ops, "SUM", out=out, via=way)

    def others(ops):
        return {"direct": kernel(ops, "direct"),
                **{label: (lambda lib=lib: fold_from(lib["fold"], ops, out))
                   for label, lib in against.items()}}

    res = turns(kernel(xl), lambda: xs.sum(0), readings=FOLD_TURNS,
                others={**others(xl), "stack_sum": lambda: torch.stack(xl).sum(0)})
    res["rows"] = turns(kernel(rows), lambda: xs.sum(0), readings=FOLD_TURNS,
                        others=others(rows))
    res["plain_ms"] = time_ms(lambda: fr.fused_multi_reduce_plain(xl, "SUM"))
    res["bound"] = bound((n + 1) * count * xs.element_size(), (n - 1) * count, caps)
    res["staged_tile"] = fr.staged_tile(n, xs.dtype)
    gen = torch.Generator(device=xs.device)
    gen.manual_seed(SEED + 3)
    res["tiny"] = {}
    for name, dtype, m, size in (("serve float32[8] x 4", torch.float32, 4, 8),
                                 ("rma float64[1] x 2", torch.float64, 2, 1)):
        ops = [torch.randn(size, generator=gen, device=xs.device, dtype=dtype)
               for _ in range(m)]
        o = torch.empty_like(ops[0])
        ways = [w for w in ROUTES if w == "direct" or fr.route(ops, o) == w]
        calls = {w: (lambda w=w: fr.fused_multi_reduce(ops, "SUM", out=o, via=w))
                 for w in ways}
        got = {w: [] for w in ways}
        for i in range(3):
            for w in (ways if i % 2 == 0 else ways[::-1]):
                got[w].append(time_ms(calls[w], iters=TINY_ITERS))
        entry = {"chosen": fr.route(ops, o)}
        for w in ways:
            entry[f"{w}_ms"] = float(np.median(got[w]))
            entry[f"{w}_ms_turns"] = got[w]
            entry[f"{w}_span_ms"] = kernel_span_ms(calls[w], f"fused_fold_kernel_{w}",
                                                   logdir, iters=50)
        res["tiny"][name] = entry
    return res


def ring_times(ring, xs, shards, caps: dict, against: dict) -> dict:
    """Each ring kernel at the in-graph path's shapes: kernel, plain and
    library times (ms) and the bound. ``xs`` is (n, count) float32,
    ``shards`` (n, count / n). ``against`` maps a label to another tree's
    libraries, whose reduce-scatter kernel (``ring.cu``) joins the turns
    (after a bitwise check against this tree's)."""
    n, count = xs.shape
    size = xs.element_size()
    per = count // n
    want = ring.ring_reduce_scatter(xs, "sum")
    for label, lib in against.items():
        if not same_bits(reduce_scatter_from(lib["ring"], xs), want):
            raise AssertionError(f"ring_reduce_scatter of {label} != this tree's")
    del want
    return {
        "ring_allreduce": {
            "ms": time_ms(lambda: ring.ring_allreduce(xs, "sum")),
            "plain_ms": time_ms(lambda: ring.ring_allreduce_plain(xs, operator.add)),
            # the same n replicas in PyTorch calls; the bare reduction,
            # which writes no replicas, is the floor beside it
            "library_ms": time_ms(
                lambda: xs.sum(0, keepdim=True).expand(n, -1).contiguous()),
            "library_call": "xs.sum(0, keepdim=True).expand(n, -1).contiguous()",
            "floor_ms": time_ms(lambda: xs.sum(0)),
            "floor_call": "xs.sum(0) (writes no replicas)",
            "bound": bound(2 * n * count * size, (n - 1) * count, caps),
        },
        "ring_reduce_scatter": {
            # the kernel's direct route (16-byte loads, no staging) on the
            # same tiles, and other trees' kernels, in the same turns
            **turns(lambda: ring.ring_reduce_scatter(xs, "sum"),
                    lambda: xs.view(n, n, per).sum(0),
                    others={"direct": lambda: ring._reduce_scatter_kernel(
                        xs, "SUM", per, via="direct"),
                        **{label: (lambda lib=lib: reduce_scatter_from(lib["ring"], xs))
                           for label, lib in against.items()}}),
            "staged_tile": ring.staged_tile(n, xs.dtype),
            "plain_ms": time_ms(lambda: ring.ring_reduce_scatter_plain(
                xs, operator.add)),
            "library_call": "xs.view(n, n, per).sum(0)",
            "bound": bound((n + 1) * count * size, (n - 1) * count, caps),
        },
        "ring_allgather": {
            # the same n copies in one PyTorch call: expand's copy, with
            # repeat (a slower form of the same function) beside it
            **turns(lambda: ring.ring_allgather(shards),
                    lambda: shards.reshape(1, -1).expand(n, -1).contiguous(),
                    others={"repeat": lambda: shards.reshape(1, -1).repeat(n, 1)}),
            "plain_ms": time_ms(lambda: ring.ring_allgather_plain(shards)),
            "library_call": "shards.reshape(1, -1).expand(n, -1).contiguous()",
            "repeat_call": "shards.reshape(1, -1).repeat(n, 1)",
            "bound": bound((n + n * n) * per * size, 0, caps),
        },
    }


# ---------------------------------------------------------------------------
# 8. new kernels against plain
# ---------------------------------------------------------------------------

def _raises(call, what: str) -> None:
    try:
        call()
    except ValueError:
        return
    raise AssertionError(f"{what} did not raise")


def check_permute_parity(permute, device) -> dict:
    """The permute and all-to-all kernels against their plain versions,
    bitwise, on every case; returns per-kernel case counts."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    pick = np.random.default_rng(SEED + 2)
    cases = dict.fromkeys(permute.REPLACES, 0)

    def one(name, got, want, what):
        torch.cuda.synchronize()
        if got.device.type != "cuda" or not same_bits(got, want):
            raise AssertionError(f"{name} kernel != plain: {what}")
        cases[name] += 1

    for dname in DTYPES:
        dtype = getattr(torch, dname)
        for size in PERMUTE_SIZES:
            for n in PERMUTE_NS:
                what = f"{dname} n={n} size={size}"
                xs = operands(dtype, n, size, device, gen)
                perm = pick.permutation(n).tolist()
                partial = [-1 if d % 3 == 1 else (d + 1) % n for d in range(n)]
                one("collective_permute", permute.collective_permute(xs, perm),
                    permute.permute_rows_plain(xs, permute.inverse(perm, n)), what)
                one("collective_permute", permute.permute_rows(xs, partial),
                    permute.permute_rows_plain(xs, partial), f"partial {what}")
                blocks = operands(dtype, n, n * -(-size // n), device, gen)
                one("pairwise_alltoall", permute.pairwise_alltoall(blocks),
                    permute.pairwise_alltoall_plain(blocks), what)
                del xs, blocks
    x = torch.zeros(4, 2 * 4097, device=device)
    _raises(lambda: permute.collective_permute(x[:, ::2], [1, 2, 3, 0]),
            "a non-contiguous permute")
    _raises(lambda: permute.pairwise_alltoall(x[:, ::2]), "a non-contiguous alltoall")
    _raises(lambda: permute.collective_permute(x, [0, 0, 1, 2]), "a non-permutation")
    return {"cases": cases}


def attention_close(attention, got, q, k, v, *, causal: bool, what: str) -> tuple:
    """The kernel's output ``got`` against the plain version on the same
    inputs, elementwise within ``attention.allowed_error``; returns the
    largest absolute difference and the largest share of its bound any
    element used, or raises."""
    import torch
    scale = q.shape[-1] ** -0.5
    want = attention.ring_attention_plain(q, k, v, causal=causal, scale=scale)
    limit = attention.allowed_error(q, k, v, want, causal=causal, scale=scale)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err, share = float(diff.max()), float((diff / limit.clamp_min(1e-30)).max())
    if got.device.type != "cuda" or not bool((diff <= limit).all()):
        raise AssertionError(f"ring_attention kernel != plain: {what} "
                             f"max_abs_err={err}, {share} of the bound")
    return err, share


def check_attention_parity(attention, device) -> dict:
    """Each ring-attention route against the plain version within
    ``attention.allowed_error``, every call counted on the route it should
    take; returns the case count and, per dtype and route, the largest
    absolute difference and the largest share of the bound."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    cases, worst, shares = 0, {}, {}

    def one(key, way, call, q, k, v, causal, what):
        nonlocal cases
        before = dict(kernel_counts()["attention_route_launches"])
        got = call()
        err, share = attention_close(attention, got, q, k, v, causal=causal, what=what)
        moved = {r: kernel_counts()["attention_route_launches"][r] - before[r] for r in before}
        if moved != {r: int(r == way) for r in before}:
            raise AssertionError(f"{what}: launches by route {moved}, not one {way}")
        worst[key] = max(worst.get(key, 0.0), err)
        shares[key] = max(shares.get(key, 0.0), share)
        cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for n in ATTN_NS:
            for t in ATTN_TS:
                for d in ATTN_DS:
                    for causal in (True, False):
                        q, k, v = (torch.randn(n, ATTN_BH, t, d, generator=gen,
                                               device=device).to(dtype)
                                   for _ in range(3))
                        what = f"{dtype} n={n} t={t} d={d} causal={causal}"
                        way = attention.route(dtype, d, True)
                        one(f"{dname} {way}", way,
                            lambda: attention.ring_attention(q, k, v, causal=causal),
                            q, k, v, causal, what)
                        if way != "sm90":
                            continue
                        one(f"{dname} mma_sync", "mma_sync",
                            lambda: attention._launch(q, k, v, causal, d ** -0.5,
                                                      via="mma_sync"),
                            q, k, v, causal, f"{what} on mma.sync")
    q = torch.zeros(2, 2, 16, 8, device=device)
    _raises(lambda: attention.attend(q.transpose(1, 2), q.transpose(1, 2),
                                     q.transpose(1, 2), causal=True),
            "non-contiguous attention")
    _raises(lambda: attention.attend(q, q.cpu(), q, causal=True),
            "a CPU/CUDA mix")
    _raises(lambda: attention.attend(q.half(), q.half(), q.half(), causal=True),
            "float16 attention")
    return {"cases": cases, "max_abs_err": worst, "bound_share": shares}


# ---------------------------------------------------------------------------
# 9. model path
# ---------------------------------------------------------------------------

def stack_seq(tokens, n: int):
    """(b, T) -> stacked (n, b, T/n): rank r holds sequence block r."""
    b, t = tokens.shape
    return tokens.view(b, n, t // n).transpose(0, 1).contiguous()


def unstack_seq(logits):
    """Stacked (n, b, t, V) -> (b, n*t, V)."""
    n, b, t, v = logits.shape
    return logits.transpose(0, 1).reshape(b, n * t, v)


def float32_params(params: dict) -> dict:
    """A float32 copy of the model's weights."""
    return {"embed": params["embed"].float(), "ln_f": params["ln_f"].float(),
            "layers": [{k: w.float() for k, w in layer.items()}
                       for layer in params["layers"]]}


def compare_logits(got, want, what: str, dtype: str) -> dict:
    """Largest absolute difference and share of agreeing greedy tokens over
    every position; raises past the stated bounds."""
    err = max_abs_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: non-finite logits")
    if err > MODEL_TOL[dtype] or agree < MODEL_AGREE[dtype]:
        raise AssertionError(f"{what}: max_abs_err {err} (bound {MODEL_TOL[dtype]}), "
                             f"greedy agreement {agree} (bound {MODEL_AGREE[dtype]})")
    return {"max_abs_err": err, "greedy_agree": agree}


def serve(tr, cfg, params, requests: np.ndarray, device) -> list:
    """The model path: every request through the sp forward; returns
    (stacked logits, greedy next token of each sequence) per request."""
    import torch
    outs = []
    for req in requests:
        tokens = torch.from_numpy(req).to(device)
        logits = tr.transformer_forward(cfg, params, stack_seq(tokens, SP),
                                        sp_axis="sp")
        outs.append((logits, logits[-1, :, -1].argmax(-1)))
    torch.cuda.synchronize()
    return outs


def model_profile(tr, cfg, params, tokens, logdir: str, iters: int = 3) -> dict:
    """Device busy share of the window of ``iters`` sp requests under
    ``torch.profiler``: the union of kernel, memcpy and memset spans."""
    stacked = stack_seq(tokens, SP)
    return device_profile(lambda: tr.transformer_forward(cfg, params, stacked,
                                                         sp_axis="sp"),
                          logdir, "model_path", iters)


def device_profile(fn, logdir: str, name: str, iters: int = 3) -> dict:
    """``fn`` once, then ``iters`` calls under ``torch.profiler``: the
    window, the device's busy time (the union of kernel, memcpy and memset
    spans), the device time by kernel and the launches by kernel name per
    call, and the sm90 attention spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(logdir, exist_ok=True)
    trace = os.path.join(logdir, f"{name}.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    busy = busy_union_us(events)
    attn = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
            and "ring_attention_sm90_kernel" in e.get("name", "")]
    by_name: dict = {}
    launches: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = e.get("name", "")
            launches[name] = launches.get(name, 0) + 1 / iters
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + float(e["dur"]) / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"window_ms": window_us / 1e3, "busy_ms": busy / 1e3,
            "top_kernels_ms_per_request": [[k, round(v, 4)] for k, v in top],
            "attention_spans": len(attn),
            "attention_ms": sum(float(e["dur"]) for e in attn) / 1e3,
            "launches": launches, "iters": iters, "trace": trace}


# ---------------------------------------------------------------------------
# 10. recipes
# ---------------------------------------------------------------------------

def _stage_params(params: dict, n: int) -> list:
    """Pipeline stage params: slot j of rank r is layer r * per + j, each
    weight stacked over the ranks."""
    import torch
    layers = params["layers"]
    per = len(layers) // n
    return [{k: torch.stack([layers[r * per + j][k] for r in range(n)])
             for k in layers[0]} for j in range(per)]


def recipes(tr, par, cfg, params, device) -> dict:
    """Phase 10; returns per-recipe results and launch counts."""
    import torch
    rng = np.random.default_rng(SEED + 10)
    dt = cfg.dtype
    out = {}

    def counted(fn):
        kernel_counts().reset()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(kernel_counts()["permute_launches"]), kernel_counts()["attention_launches"]

    # Ulysses at the model's attention shapes
    b, h, tl, dh = BATCH, cfg.n_heads, SEQ // SP, cfg.head_dim
    q, k, v = (torch.from_numpy(rng.standard_normal((SP, b, h, tl, dh),
                                                    dtype=np.float32))
               .to(device=device, dtype=dt) for _ in range(3))
    uly, moves, attn = counted(lambda: par.ulysses_attention(q, k, v, axis="sp"))
    ring = par.ring_attention(q, k, v, axis="sp")
    out["ulysses"] = {"alltoall_launches": moves["pairwise_alltoall"],
                      "max_abs_err": max_abs_err(uly.float(), ring.float()),
                      "shape": list(q.shape)}
    if moves["pairwise_alltoall"] != 4 or attn:
        raise AssertionError(f"ulysses launched {moves} and {attn} attention")
    if out["ulysses"]["max_abs_err"] > RECIPE_TOL:
        raise AssertionError(f"ulysses != ring attention: {out['ulysses']}")
    out["ulysses_inputs"] = (q, k, v)

    # pipeline of the 8 layers, 2 a stage, 8 microbatches of (1, 1024)
    n = SP
    positions = torch.arange(SEQ, device=device)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1, SEQ))).to(device)
    mbs = params["embed"][tokens]                               # (8, 1, 1024, d)
    stages = _stage_params(params, n)

    def stage_fn(sp, x):
        ys = []
        for r in range(n):
            y = x[r]
            for slot in sp:
                y = tr._attn_ffn_block(cfg, {k: w[r] for k, w in slot.items()}, y,
                                       positions, tp_axis=None, sp_axis=None)
            ys.append(y)
        return torch.stack(ys)

    piped, moves, _ = counted(lambda: par.pipeline_forward(stage_fn, stages, mbs,
                                                           axis="pp"))
    seq = []
    for mb in mbs:
        y = mb
        for layer in params["layers"]:
            y = tr._attn_ffn_block(cfg, layer, y, positions, tp_axis=None,
                                   sp_axis=None)
        seq.append(y)
    seq = torch.stack(seq)
    out["pipeline"] = {"permute_launches": moves["collective_permute"],
                       "max_abs_err": max_abs_err(piped[-1].float(), seq.float()),
                       "microbatches": list(mbs.shape)}
    if moves["collective_permute"] != 8 + n - 1:
        raise AssertionError(f"pipeline launched {moves}")
    if out["pipeline"]["max_abs_err"] > RECIPE_TOL:
        raise AssertionError(f"pipeline != layers in sequence: {out['pipeline']}")
    out["pipeline_hop"] = piped[:, 0].contiguous()
    del piped, seq, mbs

    # MoE: one flagship FFN expert a rank, skewed routing so that expert 0
    # overflows its capacity
    d = cfg.d_model
    toks = torch.from_numpy(rng.standard_normal((n, MOE_TOKENS, d),
                                                dtype=np.float32)).to(device=device, dtype=dt)
    idx = torch.from_numpy(rng.choice(n, (n, MOE_TOKENS), p=[0.55, 0.25, 0.1, 0.1])
                           ).to(device)
    w_in = torch.stack([params["layers"][r]["w_in"] for r in range(n)])
    w_out = torch.stack([params["layers"][r]["w_out"] for r in range(n)])

    def expert(x):                                   # (n, n*capacity, d)
        import torch.nn.functional as F
        return torch.matmul(F.gelu(torch.matmul(x, w_in), approximate="tanh"), w_out)

    moe, moves, _ = counted(lambda: par.moe_dispatch_combine(
        toks, idx, expert, capacity=MOE_CAPACITY, axis="ep"))
    slot = torch.cumsum(torch.nn.functional.one_hot(idx, n), 1).gather(
        2, idx[..., None])[..., 0] - 1
    keep = slot < MOE_CAPACITY
    dropped = int((~keep).sum())
    want = torch.zeros_like(toks)
    for e in range(n):
        sel = keep & (idx == e)
        want[sel] = expert(toks[sel][None].expand(n, -1, -1).contiguous())[e]
    out["moe"] = {"alltoall_launches": moves["pairwise_alltoall"],
                  "dropped": dropped,
                  "max_abs_err": max_abs_err(moe.float(), want.float())}
    if moves["pairwise_alltoall"] != 2:
        raise AssertionError(f"moe launched {moves}")
    if dropped == 0 or not bool((moe[~keep] == 0).all()) \
            or bool(torch.signbit(moe[~keep]).any()):
        raise AssertionError("moe: dropped rows are not exact zeros")
    if out["moe"]["max_abs_err"] > RECIPE_TOL:
        raise AssertionError(f"moe kept rows differ from the experts: {out['moe']}")
    # the dispatch buffer the first all-to-all moved: each rank's kept
    # tokens in (destination, slot) order, zeros in the empty slots
    send = toks.new_zeros((n, n, MOE_CAPACITY, d))
    send[torch.arange(n, device=device)[:, None].expand(n, MOE_TOKENS)[keep],
         idx[keep], slot[keep]] = toks[keep]
    out["moe_send"] = send.reshape(n, -1)
    del moe, want, toks

    # periodic halo exchange on {"x": 4}
    grid = torch.from_numpy(rng.standard_normal((n, 512, 256), dtype=np.float32)
                            ).to(device)
    halo, moves, _ = counted(lambda: par.halo_exchange(grid, axes="x", halo=2))
    want = torch.cat([grid[..., -2:].roll(1, 0), grid, grid[..., :2].roll(-1, 0)], -1)
    out["halo"] = {"permute_launches": moves["collective_permute"],
                   "bitwise": same_bits(halo, want)}
    if moves["collective_permute"] != 2 or not out["halo"]["bitwise"]:
        raise AssertionError(f"halo exchange: {out['halo']}")
    return out


# ---------------------------------------------------------------------------
# 11. times of the new kernels
# ---------------------------------------------------------------------------

def kernel_span_ms(fn, needle, logdir: str, iters: int = 20, between=None,
                   exclude=None):
    """Mean device duration of the kernel spans whose name holds ``needle``
    over ``iters`` calls of ``fn``, under ``torch.profiler``: the kernel
    alone, without the wrapper's host time between launches. ``needle``
    None: the device time of all of a call's kernels (a library call, a
    yardstick only: None when the profiler saw no kernel of it), leaving
    out kernels whose name holds ``exclude`` (``between``'s own).
    ``between()`` runs before each call (an L2 flush)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    trace = os.path.join(logdir, f"{needle or 'library'}.json")
    for _ in range(2):          # the profiler now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            durs = [float(e["dur"]) for e in json.load(f).get("traceEvents", [])
                    if e.get("ph") == "X" and e.get("cat") == "kernel"
                    and (needle is None or needle in e.get("name", ""))
                    and not (exclude and exclude in e.get("name", ""))]
        if durs:
            return sum(durs) / (iters if needle is None else len(durs)) / 1e3
    if needle is None:
        return None
    raise AssertionError(f"the profiler saw no {needle} spans")


def new_kernel_times(permute, attention, hop, send, qkv, logdir: str) -> dict:
    """Each new kernel at the recipe and model shapes: first held against
    its plain version on the same inputs (raises on a mismatch), then
    kernel, plain and library times (ms) and the bound. ``hop`` is the
    pipeline's stacked activation (4, 1, 1024, d), ``send`` the MoE
    dispatch buffer, ``qkv`` the model's stacked (4, 8, 16, 256, 64)
    attention operands."""
    import torch
    import torch.nn.functional as F
    n = hop.shape[0]
    perm = [(r + 1) % n for r in range(n)]
    inv = torch.tensor(permute.inverse(perm, n), device=hop.device)
    src = permute.inverse(perm, n)
    per = send[0].numel() // n
    q, k, v = (x.reshape(n, -1, x.shape[-2], x.shape[-1]).contiguous() for x in qkv)
    _, bh, t, d = q.shape

    moved = {
        "collective_permute": (permute.collective_permute(hop, perm),
                               permute.permute_rows_plain(hop, src)),
        "pairwise_alltoall": (permute.pairwise_alltoall(send),
                              permute.pairwise_alltoall_plain(send)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in moved.items():
        if got.device.type != "cuda" or not same_bits(got, want):
            raise AssertionError(f"{name} kernel != plain at the path's shape "
                                 f"{list(want.shape)}")
    del moved
    attn_err, attn_share = attention_close(
        attention, attention.attend(q, k, v, causal=True), q, k, v, causal=True,
        what=f"the model's shape {list(q.shape)}")
    prev_err, prev_share = attention_close(
        attention, attention._launch(q, k, v, True, d ** -0.5, via="mma_sync"),
        q, k, v, causal=True, what=f"the model's shape {list(q.shape)} on mma.sync")
    main_parity = {"collective_permute": {"bitwise": True, "max_abs_err": 0.0},
                   "pairwise_alltoall": {"bitwise": True, "max_abs_err": 0.0},
                   "ring_attention": {"max_abs_err": attn_err,
                                      "bound_share": attn_share,
                                      "mma_sync_max_abs_err": prev_err,
                                      "mma_sync_bound_share": prev_share}}
    gathered = [x.view(n, BATCH, -1, t, d).permute(1, 2, 0, 3, 4)
                .reshape(BATCH, -1, n * t, d).contiguous() for x in qkv]
    dt = str(q.dtype).split(".")[1]
    flops = 4 * d * attention.causal_pairs(n, t) * bh
    hbm = 3.35e12                                     # spec sheet, bytes/s
    # the permute's per-call time is host time: taken in turns with the
    # library call, three of each, and the medians kept
    hop_ms, lib_ms = [], []
    for _ in range(3):
        hop_ms.append(time_ms(lambda: permute.collective_permute(hop, perm), iters=200))
        lib_ms.append(time_ms(lambda: hop[inv], iters=200))
    # the 8 MiB hop's 16 MiB of traffic stays in the 50 MB L2 across
    # back-to-back calls; its span with the L2 flushed before each call
    # (a 256 MiB memset between launches) is the one a bound can judge
    # (a 256 MiB fill between launches), taken in turns with the span of
    # the library call xs[inverse_perm] under the same flush
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=hop.device)
    cold, lib_cold = [], []
    for _ in range(3):
        cold.append(kernel_span_ms(lambda: permute.collective_permute(hop, perm),
                                   "permute_kernel", logdir,
                                   between=lambda: flush.zero_()))
        lib_cold.append(kernel_span_ms(lambda: hop[inv], None, logdir,
                                       between=lambda: flush.zero_(),
                                       exclude="FillFunctor"))
    del flush
    cold_span = sorted(cold)[1]
    lib_cold_span = (None if None in lib_cold else sorted(lib_cold)[1])
    previous = lambda: attention._launch(q, k, v, True, d ** -0.5,  # noqa: E731
                                         via="mma_sync")
    sdpa = lambda: F.scaled_dot_product_attention(*gathered, is_causal=True)  # noqa: E731
    times = {
        "collective_permute": {
            "ms": sorted(hop_ms)[1],
            "ms_turns": hop_ms,
            "span_ms": kernel_span_ms(lambda: permute.collective_permute(hop, perm),
                                      "permute_kernel", logdir),
            "span_l2_flushed_ms": cold_span,
            "span_l2_flushed_turns": cold,
            "library_span_l2_flushed_ms": lib_cold_span,
            "library_span_l2_flushed_turns": lib_cold,
            "plain_ms": time_ms(lambda: permute.permute_rows_plain(hop, src)),
            "library_ms": sorted(lib_ms)[1],
            "library_ms_turns": lib_ms,
            "library_call": "xs[inverse_perm]",
            "bound": (2 * hop.numel() * hop.element_size() / hbm * 1e3, "bytes"),
            "shape": list(hop.shape), "dtype": str(hop.dtype),
        },
        "pairwise_alltoall": {
            "ms": time_ms(lambda: permute.pairwise_alltoall(send)),
            "span_ms": kernel_span_ms(lambda: permute.pairwise_alltoall(send),
                                      "alltoall_kernel", logdir),
            "plain_ms": time_ms(lambda: permute.pairwise_alltoall_plain(send)),
            "library_ms": time_ms(lambda: send.view(n, n, per).transpose(0, 1)
                                  .contiguous()),
            "library_call": "xs.view(n, n, per).transpose(0, 1).contiguous()",
            "bound": (2 * send.numel() * send.element_size() / hbm * 1e3, "bytes"),
            "shape": list(send.shape), "dtype": str(send.dtype),
        },
        "ring_attention": {
            "ms": time_ms(lambda: attention.attend(q, k, v, causal=True)),
            "span_ms": kernel_span_ms(lambda: attention.attend(q, k, v, causal=True),
                                      "ring_attention_sm90_kernel", logdir),
            "previous_ms": time_ms(previous),
            "previous_span_ms": kernel_span_ms(previous, "ring_attention_kernel",
                                               logdir),
            "plain_ms": time_ms(lambda: attention.ring_attention_plain(
                q, k, v, causal=True, scale=d ** -0.5), iters=5),
            "library_ms": time_ms(sdpa),
            "library_span_ms": kernel_span_ms(sdpa, None, logdir),
            "library_call": "F.scaled_dot_product_attention(..., is_causal=True) "
                            "on the gathered (8, 16, 1024, 64)",
            "bound": max((4 * q.numel() * q.element_size() / hbm * 1e3, "bytes"),
                         (flops / (PEAK_TFLOPS[dt] * 1e12) * 1e3, "operations")),
            "shape": list(q.shape), "dtype": str(q.dtype), "flops": flops,
        },
    }
    for name in times:
        times[name]["main_parity"] = main_parity[name]
    return times


def attention_backward_times(attention, shape, device, logdir: str, *, sdpa) -> dict:
    """The attention backward kernel at ``shape`` (n, BH, t, d, dv), causal,
    bfloat16: first held against the plain ``attention_backward`` on the
    same q, k, v, o and dO within 2^-5 of each gradient's largest magnitude,
    one backward call a launch of the kernel (raises otherwise); then in
    turns the kernel call (its three launches), the library yardstick
    ``sdpa`` (F.scaled_dot_product_attention's forward and backward on the
    gathered sequence, or None where it refuses these head dims) and the
    plain version; the device span of the main launches a call, and the
    bound (2 (3 d + 2 dv) flops a causal pair at the bf16 peak, or q, k, v,
    o, dO and the three gradients once at the HBM peak)."""
    import torch
    n, bh, t, d, dv = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 23)
    q, k = (torch.randn(n, bh, t, d, generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    v, do = (torch.randn(n, bh, t, dv, generator=gen, device=device).to(torch.bfloat16)
             for _ in range(2))
    scale = d ** -0.5
    o, lse = attention.attend_saving_lse(q, k, v, causal=True, scale=scale)
    before = kernel_counts()["attention_backward_launches"]
    got = attention.backward(q, k, v, o, do, lse, causal=True, scale=scale)
    torch.cuda.synchronize()
    calls = kernel_counts()["attention_backward_launches"] - before
    if lse is None or calls != 1:
        raise AssertionError(f"attention backward at {shape}: {calls} kernel calls, not 1")
    want = attention.attention_backward(q, k, v, o, do, causal=True, scale=scale)
    rel = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        rel[name] = float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
    if max(rel.values()) > 2.0 ** -5:
        raise AssertionError(f"attention backward kernel != plain at {shape}: {rel} of each "
                             f"gradient's largest magnitude (bound 2^-5)")
    del got, want
    kernel = lambda: attention.backward(q, k, v, o, do, lse, causal=True, scale=scale)  # noqa: E731
    plain = lambda: attention.attention_backward(q, k, v, o, do, causal=True,  # noqa: E731
                                                 scale=scale)
    library = sdpa(q, k, v, do) if sdpa else None
    spans = {"dk_dv": kernel_span_ms(kernel, "attention_backward_sm90_kernel", logdir)}
    if d > 64:                              # the dQ pass of its own
        spans["dq"] = kernel_span_ms(kernel, "attention_backward_sm90_dq_kernel", logdir)
    got = turns(kernel, library or kernel, others={"plain": plain})
    flops = 2 * bh * attention.causal_pairs(n, t) * (3 * d + 2 * dv)
    nbytes = 2 * n * bh * t * (4 * d + 4 * dv)
    hbm = 3.35e12
    return {
        "ms": got["ms"], "ms_turns": got["ms_turns"],
        "library_ms": got["library_ms"] if library else None,
        "library_ms_turns": got["library_ms_turns"] if library else None,
        "library_call": "F.scaled_dot_product_attention(..., is_causal=True) forward and "
                        "backward on the gathered sequence",
        "plain_ms": got["plain_ms"], "plain_ms_turns": got["plain_ms_turns"],
        "span_ms": sum(spans.values()), "spans_ms": spans,
        "bound": max((nbytes / hbm * 1e3, "bytes"),
                     (flops / (PEAK_TFLOPS["bfloat16"] * 1e12) * 1e3, "operations")),
        "flops": flops, "shape": list(shape), "dtype": "torch.bfloat16",
        "main_parity": {"rel_err": rel, "bound": "2^-5 of each gradient's largest magnitude"},
    }


def sdpa_backward_yardstick(q, k, v, do):
    """F.scaled_dot_product_attention's causal forward and backward on the
    stacked (n, BH, t, d) blocks gathered into one (1, BH, n t, d) sequence
    (batch and heads as the fused backends take them): the library
    yardstick of the attention backward, or None where no SDPA backend
    takes these head dims."""
    import torch.nn.functional as F
    n, bh, t, _ = q.shape
    glob = [x.transpose(0, 1).reshape(1, bh, n * t, x.shape[-1]).contiguous() for x in (q, k, v)]
    leaves = [x.requires_grad_() for x in glob]
    dg = do.transpose(0, 1).reshape(1, bh, n * t, do.shape[-1]).contiguous()

    def call():
        F.scaled_dot_product_attention(*leaves, is_causal=True).backward(dg)

    try:
        call()
    except RuntimeError as e:
        log(f"F.scaled_dot_product_attention's backward at q/k {q.shape[-1]}, v "
            f"{v.shape[-1]} refused: {e}")
        return None
    return call


def moonlight_kernel_times(attention, permute, xla, device, logdir: str) -> dict:
    """Phase 11b: the kernels the Moonlight cell drives, at its shapes
    (``MLA_SHAPE``, ``MOE_EXCHANGE``; the attention backward by
    :func:`attention_backward_times`). Each is first held against its plain
    version on the same inputs and its call counted on its kernel alone
    (raises otherwise): the sm90 attention kernel's 192/128 route within
    ``attention.allowed_error``, the padded exchange through
    ``xla.alltoall`` bit for bit. Then kernel, plain and library times (ms)
    and the bound: the larger of operations and bytes for attention; for
    the exchange the routed rows' bytes read and written, as the cell's
    ``alltoall_roofline`` counts them, beside the padded buffer's."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 22)
    n, bh, t, dq, dv = MLA_SHAPE
    q, k = (torch.randn(n, bh, t, dq, generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn(n, bh, t, dv, generator=gen, device=device).to(torch.bfloat16)
    before = kernel_counts().snapshot()
    routes, dims = before["attention_route_launches"], before["attention_dims_launches"]
    got = attention.attend(q, k, v, causal=True)
    after = kernel_counts().snapshot()
    moved = {r: after["attention_route_launches"][r] - routes[r] for r in routes}
    dims_moved = {key: c - dims.get(key, 0) for key, c in after["attention_dims_launches"].items()
                  if c != dims.get(key, 0)}
    if moved != {r: int(r == "sm90") for r in routes} or dims_moved != {f"{dq}/{dv}": 1}:
        raise AssertionError(f"attention at {MLA_SHAPE}: launches by route {moved}, by "
                             f"dims {dims_moved}, not one sm90 launch at {dq}/{dv}")
    attn_err, attn_share = attention_close(attention, got, q, k, v, causal=True,
                                           what=f"the Moonlight cell's shape {MLA_SHAPE}")
    del got
    ranks, rows, d = MOE_EXCHANGE
    send = torch.randn(ranks, ranks, rows, d, generator=gen,
                       device=device).to(torch.bfloat16)

    def exchange():
        return xla.alltoall(send, axis="ep", mesh={"ep": ranks}, split_axis=0,
                            concat_axis=0, tiled=True)
    before = kernel_counts()["permute_launches"]["pairwise_alltoall"]
    got = exchange()
    if kernel_counts()["permute_launches"]["pairwise_alltoall"] - before != 1:
        raise AssertionError("the MoE exchange did not make one pairwise_alltoall launch")
    if not same_bits(got.reshape(ranks, -1), permute.pairwise_alltoall_plain(send)):
        raise AssertionError(f"pairwise_alltoall kernel != plain at the MoE exchange "
                             f"{list(send.shape)}")
    del got
    hbm = 3.35e12                                     # spec sheet, bytes/s
    flops = 2 * (dq + dv) * attention.causal_pairs(n, t) * bh
    sdpa = lambda: F.scaled_dot_product_attention(q[0], k[0], v[0],  # noqa: E731
                                                  is_causal=True)
    try:
        library_ms = time_ms(sdpa)
    except RuntimeError as e:                         # no SDPA backend at these dims
        library_ms = None
        log(f"phase 11b: F.scaled_dot_product_attention at q/k {dq}, v {dv} refused: {e}")
    padded = send.numel() * send.element_size()
    return {
        "ring_attention": {
            "ms": time_ms(lambda: attention.attend(q, k, v, causal=True)),
            "span_ms": kernel_span_ms(lambda: attention.attend(q, k, v, causal=True),
                                      "ring_attention_sm90_kernel", logdir),
            "plain_ms": time_ms(lambda: attention.ring_attention_plain(
                q, k, v, causal=True, scale=dq ** -0.5), iters=3),
            "library_ms": library_ms,
            "library_call": f"F.scaled_dot_product_attention(..., is_causal=True) on "
                            f"({bh}, {t}, {dq}/{dv})",
            "bound": max((2 * (dq + dv) * q.shape[-2] * bh * q.element_size() / hbm * 1e3,
                          "bytes"),
                         (flops / (PEAK_TFLOPS["bfloat16"] * 1e12) * 1e3, "operations")),
            "shape": list(MLA_SHAPE), "dtype": str(q.dtype), "flops": flops,
            "main_parity": {"max_abs_err": attn_err, "bound_share": attn_share},
        },
        "pairwise_alltoall": {
            "ms": time_ms(exchange),
            "span_ms": kernel_span_ms(exchange, "alltoall_kernel", logdir),
            "plain_ms": time_ms(lambda: permute.pairwise_alltoall_plain(send)),
            "library_ms": time_ms(lambda: send.transpose(0, 1).contiguous()),
            "library_call": "xs.transpose(0, 1).contiguous()",
            "bound": (2 * MOE_ROUTED_ROWS * d * send.element_size() / hbm * 1e3,
                      "bytes of the routed rows"),
            "padded_bound_ms": 2 * padded / hbm * 1e3,
            "shape": list(send.shape), "dtype": str(send.dtype),
            "main_parity": {"bitwise": True, "max_abs_err": 0.0},
        },
        "attention_backward": attention_backward_times(attention, MLA_SHAPE, device, logdir,
                                                       sdpa=sdpa_backward_yardstick),
    }


# ---------------------------------------------------------------------------
# 12. training at the flagship width
# ---------------------------------------------------------------------------

def flat_params(params: dict) -> dict:
    """The model's parameters by name, in forward order (embed, the layers,
    ln_f): the trainers' dictionary."""
    out = {"embed": params["embed"]}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": w for k, w in layer.items()})
    out["ln_f"] = params["ln_f"]
    return out


def nest_params(flat: dict, n_layers: int) -> dict:
    return {"embed": flat["embed"], "ln_f": flat["ln_f"],
            "layers": [{k.split(".")[2]: w for k, w in flat.items()
                        if k.startswith(f"layers.{i}.")} for i in range(n_layers)]}


def dense_step(tr, cfg, params: dict, tokens, labels, lr: float, shards: int):
    """The single-device autograd step a train step on ``shards`` sequence
    ranks computes: each shard's loss the mean over its own positions, their
    sum differentiated (the step psums the per-rank gradients), SGD as the
    step takes it; the loss the shards' mean. ``shards`` 1: the dense mean
    loss (the tp step's)."""
    import torch
    leaves = {k: w.detach().requires_grad_() for k, w in flat_params(params).items()}
    logits = tr.transformer_forward(cfg, nest_params(leaves, cfg.n_layers), tokens)
    t = tokens.shape[1] // shards
    losses = [tr._xent(logits[:, r * t:(r + 1) * t], labels[:, r * t:(r + 1) * t])
              for r in range(shards)]
    grads = torch.autograd.grad(sum(losses), list(leaves.values()))
    new = {k: (w.detach() - lr * g).to(w.dtype) for (k, w), g in zip(leaves.items(), grads)}
    return nest_params(new, cfg.n_layers), float(sum(losses).detach()) / shards


def update_error(before: dict, got: dict, want: dict) -> float:
    """The largest difference between two steps' parameter updates, per
    tensor relative to the reference update's largest element, over every
    tensor (float64 differences)."""
    worst = 0.0
    b, g, w = flat_params(before), flat_params(got), flat_params(want)
    for k in b:
        u_got = b[k].double() - g[k].double()
        u_want = b[k].double() - w[k].double()
        worst = max(worst, float((u_got - u_want).abs().max())
                    / max(float(u_want.abs().max()), 1e-30))
    return worst


def unshard_tp(tr, cfg, params: dict) -> dict:
    """The tp step's stacked shards back to the dense layout."""
    specs = tr.transformer_param_specs(cfg, "tp")

    def join(x, spec):
        if spec == (None, "tp"):
            return x.movedim(0, 1).reshape(x.shape[1], -1)
        if spec == ("tp", None):
            return x.reshape(-1, x.shape[-1])
        return x

    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "layers": [{k: join(w, sp[k]) for k, w in layer.items()}
                       for layer, sp in zip(params["layers"], specs["layers"])]}


def step_flops(cfg) -> float:
    """benchmarks/flagship_probe.py's analytic matmul FLOPs of one train step
    (3x the forward, attention counted unmasked)."""
    b, t, d, f, v = BATCH, SEQ, cfg.d_model, cfg.d_ff, cfg.vocab
    per_layer = 2 * b * t * d * 3 * d + 2 * 2 * b * t * t * d + 2 * b * t * d * d \
        + 2 * 2 * b * t * d * f
    return 3.0 * (cfg.n_layers * per_layer + 2 * b * t * d * v)


def counts() -> tuple:
    k = kernel_counts().snapshot()
    return (k["fold_launches"], k["attention_launches"],
            k["attention_route_launches"]["sm90"], k["chained_folds"])


def ddp_step_times(ddp_step, start: dict, layout: list, dtype, device,
                   caps: dict, logdir: str) -> dict:
    """The DDP trainer's pack and update kernels at the trainer's bucket
    layout (``layout``: each bucket's ``(base, count, names)`` in arrival
    order), one rank-step a call: every bucket packed from ``dtype``
    gradients of ``start``'s shapes, then one update over every bucket.
    Each is held bitwise to its plain version and to a library form on the
    same card tensors (raises on a mismatch), then timed in turns with them:
    ``torch.cat(out=)`` a bucket for the pack, five ``torch._foreach_*``
    calls over the buckets for the update. ``span_ms`` is the kernels'
    device time a call under the profiler; the bounds count 2 + 8 bytes an
    element for a bfloat16 pack and 40 for the update."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 21)
    f64 = dict(dtype=torch.float64, device=device)
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan")])
    grads = {}
    for name, w in start.items():
        g = torch.randn(w.shape, generator=gen, device=device).to(dtype)
        k = min(g.numel(), specials.numel())
        g.view(-1)[:k] = specials[:k].to(device=device, dtype=dtype)
        grads[name] = g
    parts = []
    for _, count, names in layout:
        off, ps = 0, []
        for name in names:
            ps.append((off, grads[name].numel(), grads[name]))
            off += grads[name].numel()
        if off != count:
            raise AssertionError(f"a bucket of {count} elements holds {off}")
        parts.append(ps)
    total = sum(count for _, count, _ in layout)
    sends = [torch.empty(count, **f64) for _, count, _ in layout]

    def pack():
        for dst, ps in zip(sends, parts):
            ddp_step.pack(dst, ps)

    def pack_plain():
        for dst, ps in zip(sends, parts):
            ddp_step.pack_plain(dst, ps)

    def pack_cat():
        for dst, ps in zip(sends, parts):
            torch.cat([g.reshape(-1) for _, _, g in ps], out=dst)

    pack()
    want = [dst.clone() for dst in sends]
    for label, fn in (("plain", pack_plain), ("library", pack_cat)):
        for dst in sends:
            dst.fill_(-7.0)
        fn()
        if not all(same_bits(a, b) for a, b in zip(want, sends)):
            raise AssertionError(f"ddp_pack_kernel != the {label} pack at the "
                                 f"trainer's buckets")
    del want
    chunks = sum(-(-len(ps) // ddp_step.SEG_MAX) for ps in parts)
    pack_bytes = total * (torch.finfo(dtype).bits // 8 + 8)
    res = {"pack": {
        **turns(pack, pack_cat, others={"plain": pack_plain}),
        "span_ms": kernel_span_ms(pack, "ddp_pack_kernel", logdir, iters=5) * chunks,
        "library_span_ms": kernel_span_ms(pack_cat, None, logdir, iters=5),
        "library_call": "torch.cat([g.reshape(-1) for g in parts], out=send) a bucket",
        "bound": bound(pack_bytes, 0, caps), "bytes": pack_bytes,
        "launches_a_call": chunks, "buckets": len(layout), "elements": total,
        "dtype": str(dtype)}}

    inv, mu, lr = 1.0 / NRANKS, 0.9, TRAIN_LR
    recvs = [torch.randn(count, generator=gen, **f64) for _, count, _ in layout]
    recvs[0][:5] = specials.to(**f64)
    uparts = [(base, count, r) for (base, count, _), r in zip(layout, recvs)]
    master0 = torch.randn(total, generator=gen, **f64)
    mom0 = torch.randn(total, generator=gen, **f64)
    mom0[:3] = torch.tensor([0.0, -0.0, -0.0], **f64)

    def foreach(master, momentum):
        ps = [master.narrow(0, b, c) for b, c, _ in uparts]
        ms = [momentum.narrow(0, b, c) for b, c, _ in uparts]

        def step():
            gs = torch._foreach_mul(recvs, inv)
            torch._foreach_mul_(ms, mu)
            torch._foreach_add_(ms, gs)
            torch._foreach_sub_(ps, torch._foreach_mul(ms, lr))
        return step

    want = (master0.clone(), mom0.clone())
    ddp_step.update(*want, uparts, inv, mu, lr)
    for label in ("plain", "library"):
        master, momentum = master0.clone(), mom0.clone()
        if label == "plain":
            ddp_step.update_plain(master, momentum, uparts, inv, mu, lr)
        else:
            foreach(master, momentum)()
        if not (same_bits(master, want[0]) and same_bits(momentum, want[1])):
            raise AssertionError(f"ddp_update_kernel != the {label} update at the "
                                 f"trainer's buckets")
        del master, momentum
    del want
    master, momentum = master0, mom0
    update = lambda: ddp_step.update(master, momentum, uparts, inv, mu, lr)  # noqa: E731
    plain = lambda: ddp_step.update_plain(master, momentum, uparts, inv, mu, lr)  # noqa: E731
    library = foreach(master, momentum)
    ulaunches = -(-len(uparts) // ddp_step.SEG_MAX)
    res["update"] = {
        **turns(update, library, others={"plain": plain}),
        "span_ms": kernel_span_ms(update, "ddp_update_kernel", logdir, iters=5)
        * ulaunches,
        "library_span_ms": kernel_span_ms(library, None, logdir, iters=5),
        "library_call": "torch._foreach_mul / _mul_ / _add_ / _mul / _sub_ over the "
                        "buckets' ranges",
        "bound": bound(40 * total, 5 * total, caps), "bytes": 40 * total,
        "launches_a_call": ulaunches, "buckets": len(layout), "elements": total,
        "dtype": "torch.float64"}
    return res


def train_phase(MPI, tr, xla, cfg, params, device, logdir: str, where: str,
                caps: dict) -> dict:
    """Phase 12: the sp and tp train steps, the trainers, and their times."""
    import torch
    import torch.nn.functional as F
    from tpu_mpi_torch import perfvars
    from tpu_mpi_torch.kernels import attention, ddp_step
    from tpu_mpi_torch.train import DDPTrainer, FSDPTrainer
    out = {}
    rng = np.random.default_rng(SEED + 12)
    batches = rng.integers(0, cfg.vocab, (TRAIN_STEPS, BATCH, SEQ))
    tokens = [torch.from_numpy(b).to(device) for b in batches]
    labels = [torch.from_numpy(np.roll(b, -1, axis=1)).to(device) for b in batches]
    n_tensors = 2 + 6 * cfg.n_layers

    # the sp step: 3 steps at the flagship width (eager, captured into a
    # CUDA graph, replayed), every launch counted
    step, _ = tr.transformer_train_step(cfg, xla.make_mesh({"sp": SP}), lr=TRAIN_LR)
    kernel_counts().reset()
    model0 = perfvars.model_snapshot()
    p, losses = params, []
    for tok, lab in zip(tokens, labels):
        p, loss = step(p, tok, lab)
        losses.append(loss)
    torch.cuda.synchronize()
    folds, attn, sm90, chained = counts()
    backward = dict(kernel_counts()["attention_backward_dims_launches"])
    model1 = perfvars.model_snapshot()
    graphs = {k: model1.get(k, 0) - model0.get(k, 0)
              for k in ("graph_captures", "graph_replays", "graph_copy_bytes")}
    losses = [float(x) for x in losses]
    out["sp"] = {"losses": losses, "fold_launches": folds,
                 "attention_launches": attn, "sm90_launches": sm90,
                 "backward_launches_by_dims": backward, **graphs}
    log(f"train: sp step x {TRAIN_STEPS} on {{'sp': {SP}}}, batch {BATCH}x{SEQ}, "
        f"lr {TRAIN_LR}: losses {losses}; ring_attention launches {attn} "
        f"({sm90} sm90), fold launches {folds} ({n_tensors} parameter tensors + "
        f"the loss, per step), chained folds {chained}; CUDA graph {graphs}")
    if graphs["graph_captures"] != 1 or graphs["graph_replays"] != TRAIN_STEPS - 1:
        raise AssertionError(f"train step: {graphs}, want 1 capture and "
                             f"{TRAIN_STEPS - 1} replays")
    # the table counts the wrappers' launches: the eager step's and the
    # capture's, not the replay's
    counted = TRAIN_STEPS - graphs["graph_replays"] + graphs["graph_captures"]
    if attn != counted * cfg.n_layers or sm90 != attn:
        raise AssertionError(f"train step: {attn} attention launches, {sm90} sm90, "
                             f"want {counted * cfg.n_layers}")
    dims = f"{cfg.head_dim}/{cfg.head_dim}"
    if backward != {dims: counted * cfg.n_layers}:
        raise AssertionError(f"train step: attention backward kernel calls by head dims "
                             f"{backward}, want {counted * cfg.n_layers} at {dims}")
    if folds != counted * (n_tensors + 1) or chained:
        raise AssertionError(f"train step: {folds} folds, {chained} chained")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train step: non-finite loss {losses}")
    # what a replay runs, by kernel name from a trace of one replay
    ran = device_profile(lambda: step(p, tokens[0], labels[0]), logdir, "train_replay",
                         1)["launches"]
    replayed = {part: sum(n for k, n in ran.items() if part in k)
                for part in ("ring_attention_sm90_kernel", "attention_backward_sm90_kernel",
                             "fused_fold_kernel")}
    out["sp"]["replay_launches"] = replayed
    log(f"train: one replayed sp step ran {replayed}")
    if replayed != {"ring_attention_sm90_kernel": cfg.n_layers,
                    "attention_backward_sm90_kernel": cfg.n_layers,
                    "fused_fold_kernel": n_tensors + 1}:
        raise AssertionError(f"train step: a replay ran {replayed}, want {cfg.n_layers} "
                             f"attention forwards and backwards, {n_tensors + 1} folds")
    # an eager step (a fresh step function's first call) against a replayed
    # one at this shape, in turns, host clock to a synchronise
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fresh = lambda: tr.transformer_train_step(  # noqa: E731
        cfg, xla.make_mesh({"sp": SP}), lr=TRAIN_LR)[0](p, tokens[0], labels[0])
    eager_ms, replay_ms = [], []
    for _ in range(3):
        eager_ms.append(timed(fresh))
        replay_ms.append(timed(lambda: step(p, tokens[0], labels[0])))
    out["sp"]["eager_step_ms"], out["sp"]["replayed_step_ms"] = eager_ms, replay_ms
    log(f"train: sp step eager {eager_ms} ms, replayed {replay_ms} ms (medians "
        f"{np.median(eager_ms):.3f} / {np.median(replay_ms):.3f}) {where}")
    sp_params = p
    del p

    # step 0 against the dense single-device step, bfloat16
    _, dense_loss = dense_step(tr, cfg, params, tokens[0], labels[0], TRAIN_LR, SP)
    out["sp"]["dense_loss"] = dense_loss
    out["sp"]["loss_err"] = abs(losses[0] - dense_loss)
    log(f"train: step-0 loss sp {losses[0]} vs dense {dense_loss} (|diff| "
        f"{out['sp']['loss_err']}, bound {TRAIN_LOSS_TOL})")
    if out["sp"]["loss_err"] > TRAIN_LOSS_TOL:
        raise AssertionError("train step: step-0 loss off the dense step's")

    # one float32 sp step against the dense autograd step, TF32 off
    cfg32 = tr.TransformerConfig(**FLAGSHIP, dtype=torch.float32)
    params32 = float32_params(params)
    step32, _ = tr.transformer_train_step(cfg32, xla.make_mesh({"sp": SP}),
                                          lr=TRAIN_LR_F32)
    got32, loss32 = step32(params32, tokens[0], labels[0])
    want32, dloss32 = dense_step(tr, cfg32, params32, tokens[0], labels[0],
                                 TRAIN_LR_F32, SP)
    out["sp_f32"] = {"update_err": update_error(params32, got32, want32),
                     "loss_err": abs(float(loss32) - dloss32)}
    del got32, want32
    log(f"train: float32 sp step vs the dense autograd step (TF32 off, lr "
        f"{TRAIN_LR_F32}): largest update difference {out['sp_f32']['update_err']} "
        f"of the update's size (bound {TRAIN_F32_TOL}), loss diff "
        f"{out['sp_f32']['loss_err']}")
    if out["sp_f32"]["update_err"] > TRAIN_F32_TOL:
        raise AssertionError("float32 sp step off the dense step")

    # the tp step: g forward, f backward, 4 L folds; then in float32 against
    # the dense step, as the sp step above
    tp_step, _ = tr.transformer_train_step(cfg, xla.make_mesh({"tp": SP}), lr=TRAIN_LR)
    shards = tr.shard_params(params, cfg, SP)
    kernel_counts().reset()
    _, loss_tp = tp_step(shards, tokens[0], labels[0])
    torch.cuda.synchronize()
    folds, attn, _, chained = counts()
    del shards
    tp32, _ = tr.transformer_train_step(cfg32, xla.make_mesh({"tp": SP}),
                                        lr=TRAIN_LR_F32)
    got32, loss32 = tp32(tr.shard_params(params32, cfg32, SP), tokens[0], labels[0])
    want32, dloss32 = dense_step(tr, cfg32, params32, tokens[0], labels[0],
                                 TRAIN_LR_F32, 1)
    out["tp"] = {"fold_launches": folds, "loss": float(loss_tp),
                 "update_err_f32": update_error(params32, unshard_tp(tr, cfg32, got32),
                                                want32),
                 "loss_err_f32": abs(float(loss32) - dloss32)}
    del params32, got32, want32
    log(f"train: tp step on {{'tp': {SP}}}: loss {float(loss_tp)}, fold launches "
        f"{folds}, attention {attn}, chained {chained}; float32 tp step vs the dense "
        f"autograd step: largest update difference {out['tp']['update_err_f32']} "
        f"of the update's size (bound {TRAIN_F32_TOL}), loss diff "
        f"{out['tp']['loss_err_f32']}")
    if folds != 4 * cfg.n_layers or chained or attn:
        raise AssertionError(f"tp step: {folds} folds, {chained} chained, {attn} attn")
    if out["tp"]["update_err_f32"] > TRAIN_F32_TOL or not np.isfinite(float(loss_tp)):
        raise AssertionError("tp step off the dense step")

    # DDP and FSDP: 4 rank threads, each the dense step's gradients on its
    # own (2, 1024) quarter of the batch
    torch.cuda.empty_cache()
    start = flat_params(params)
    per = BATCH // NRANKS
    spans = {"ddp": [], "fsdp": [], "ddp_folds": [], "fsdp_folds": []}

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        ddp = DDPTrainer(start, comm, lr=TRAIN_LR, bucket_bytes=TRAIN_BUCKET_BYTES,
                         device=device)
        fsdp = FSDPTrainer(start, comm, lr=TRAIN_LR, device=device)
        for s in range(TRAIN_TRAINER_STEPS):
            model = {k: w.to(cfg.dtype).requires_grad_() for k, w in ddp.params.items()}
            b = s % TRAIN_STEPS
            logits = tr.transformer_forward(cfg, nest_params(model, cfg.n_layers),
                                            tokens[b][r * per:(r + 1) * per])
            loss = tr._xent(logits, labels[b][r * per:(r + 1) * per])
            grads = dict(zip(model, torch.autograd.grad(loss, list(model.values()))))
            del model, logits, loss
            for name, trainer in (("ddp", ddp), ("fsdp", fsdp)):
                torch.cuda.synchronize()
                MPI.Barrier(comm)
                f0, t0 = kernel_counts()["fold_launches"], time.perf_counter()
                trainer.step((k, grads[k]) for k in reversed(list(grads)))
                torch.cuda.synchronize()
                MPI.Barrier(comm)
                if r == 0:
                    spans[name].append((time.perf_counter() - t0) * 1e3)
                    spans[f"{name}_folds"].append(kernel_counts()["fold_launches"] - f0)
            del grads
        same = all(same_bits(ddp.params[k], fsdp.params[k]) for k in start)
        layout = [(b.base, b.count, list(b.names)) for b in ddp.bucketer.buckets]
        return same, layout, ddp.opt_state_bytes(), fsdp.opt_state_bytes()

    from tpu_mpi_torch import _runtime
    kernel_counts().reset()
    stamped0 = _runtime.stamp_stats["rounds"]
    res = MPI.spmd_run(body, NRANKS, timeout=900)
    release_world_plans()
    chained = kernel_counts()["chained_folds"]
    stamped = _runtime.stamp_stats["rounds"] - stamped0
    same, layout, ddp_bytes, fsdp_bytes = res[0]
    nbuckets = len(layout)
    rank_steps = NRANKS * TRAIN_TRAINER_STEPS
    want_packs = rank_steps * sum(-(-len(names) // ddp_step.SEG_MAX)
                                  for _, _, names in layout)
    want_updates = rank_steps * -(-nbuckets // ddp_step.SEG_MAX)
    k = kernel_counts().snapshot()
    ddp_launches = {"pack": k["ddp_pack_launches"], "update": k["ddp_update_launches"],
                    "pack_copies": k["ddp_pack_copies"]}
    out["trainers"] = {"bitwise_equal": all(x[0] for x in res), "buckets": nbuckets,
                       "ddp_step_launches": ddp_launches,
                       "steps": TRAIN_TRAINER_STEPS, "stamped_rounds": stamped,
                       "ddp_ms": spans["ddp"], "fsdp_ms": spans["fsdp"],
                       "ddp_folds": spans["ddp_folds"], "fsdp_folds": spans["fsdp_folds"],
                       "opt_state_bytes": [ddp_bytes, fsdp_bytes]}
    log(f"train: DDP / FSDP on {NRANKS} rank threads, {TRAIN_TRAINER_STEPS} steps, "
        f"bucket_bytes {TRAIN_BUCKET_BYTES}: {nbuckets} buckets, fold launches per "
        f"step DDP {spans['ddp_folds']} FSDP {spans['fsdp_folds']}, chained "
        f"{chained}; rounds checked by key {stamped}; DDP == FSDP bitwise on "
        f"every rank: "
        f"{out['trainers']['bitwise_equal']}; opt_state_bytes DDP {ddp_bytes} "
        f"FSDP {fsdp_bytes}; ms per step DDP {spans['ddp']} FSDP {spans['fsdp']} "
        f"{where}")
    log(f"train: DDP pack launches {ddp_launches['pack']} (want {want_packs}: one "
        f"a bucket of at most {ddp_step.SEG_MAX} gradients), update launches "
        f"{ddp_launches['update']} (want {want_updates}), gradients copied before "
        f"the pack {ddp_launches['pack_copies']}, over {rank_steps} rank-steps")
    if not out["trainers"]["bitwise_equal"]:
        raise AssertionError("DDP and FSDP differ")
    if (ddp_launches["pack"], ddp_launches["update"], ddp_launches["pack_copies"]) \
            != (want_packs, want_updates, 0):
        raise AssertionError(f"the DDP trainer's kernels: {ddp_launches}, want "
                             f"{want_packs} packs, {want_updates} updates, 0 copies")
    if min(spans["ddp_folds"]) < nbuckets or chained:
        raise AssertionError("a DDP bucket left the fold kernel")
    if stamped < TRAIN_TRAINER_STEPS * nbuckets:
        raise AssertionError(f"{stamped} rounds checked by key for "
                             f"{TRAIN_TRAINER_STEPS} steps of {nbuckets} buckets")
    if fsdp_bytes * NRANKS != ddp_bytes:
        raise AssertionError("FSDP's optimizer state is not 1/n of DDP's")

    # the DDP trainer's kernels at its bucket layout, against plain and library
    torch.cuda.empty_cache()
    out["ddp_step"] = ddp_step_times(ddp_step, start, layout, cfg.dtype, device, caps,
                                     logdir)
    torch.cuda.empty_cache()
    for name, t in out["ddp_step"].items():
        log(f"train: DDP {name} at the trainer's {t['buckets']} buckets, "
            f"{t['elements']} elements ({t['dtype']}), one rank-step a call, == plain "
            f"and {t['library_call']} bitwise; in turns kernel {t['ms_turns']} ms, "
            f"library {t['library_ms_turns']} ms, plain {t['plain_ms_turns']} ms; "
            f"medians {t['ms']:.4f} / {t['library_ms']:.4f} / {t['plain_ms']:.4f}; "
            f"device time a call: kernels {t['span_ms']:.4f} ms "
            f"({t['launches_a_call']} launches), library {t['library_span_ms']} ms; "
            f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]}) {where}")

    # times: the sp step, its device work, the attention backward
    tok, lab = tokens[0], labels[0]
    step_ms = time_ms(lambda: step(sp_params, tok, lab), iters=5, warmup=1)
    sprof = device_profile(lambda: step(sp_params, tok, lab), logdir, "train_step", 2)
    flops = step_flops(cfg)
    bound_ms = flops / (PEAK_TFLOPS["bfloat16"] * 1e12) * 1e3
    out["times"] = {"step_ms": step_ms, "tokens_per_s": BATCH * SEQ / (step_ms * 1e-3),
                    "busy_ms": sprof["busy_ms"] / sprof["iters"],
                    "window_ms": sprof["window_ms"] / sprof["iters"],
                    "top_kernels": sprof["top_kernels_ms_per_request"],
                    "bound_ms": bound_ms, "flops": flops}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 12)
    shape = (SP, BATCH * cfg.n_heads, SEQ // SP, cfg.head_dim)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
                     for _ in range(4))
    d = cfg.head_dim
    o = attention.attend(q, k, v, causal=True)
    bwd_ms = time_ms(lambda: attention.attention_backward(
        q, k, v, o, dout, causal=True, scale=d ** -0.5), iters=10)
    fwd_ms = time_ms(lambda: attention.attend(q, k, v, causal=True), iters=10)
    gathered = [x.view(SP, BATCH, cfg.n_heads, -1, d).permute(1, 2, 0, 3, 4)
                .reshape(BATCH, cfg.n_heads, SEQ, d).contiguous().requires_grad_()
                for x in (q, k, v)]
    dgath = dout.view(SP, BATCH, cfg.n_heads, -1, d).permute(1, 2, 0, 3, 4) \
        .reshape(BATCH, cfg.n_heads, SEQ, d).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*gathered, is_causal=True).backward(dgath)

    sdpa_ms = time_ms(sdpa_fwd_bwd, iters=10)
    out["times"].update({"attention_backward_ms": bwd_ms, "attention_forward_ms": fwd_ms,
                         "sdpa_fwd_bwd_ms": sdpa_ms})
    out["attention_backward"] = attention_backward_times(
        attention, (SP, BATCH * cfg.n_heads, SEQ // SP, d, d), device, logdir,
        sdpa=sdpa_backward_yardstick)
    t = out["times"]
    log(f"train: sp step {step_ms:.4f} ms (CUDA events, 5 steps), "
        f"{t['tokens_per_s']:.1f} tokens/s; profiled 2 steps: device busy "
        f"{t['busy_ms']:.4f} ms per step of a {t['window_ms']:.4f} ms window; bound "
        f"{bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at the bf16 spec, spec-sheet "
        f"arithmetic) {where}")
    log(f"train: device time per step by kernel (profiler): {t['top_kernels']}")
    log(f"train: attention at {list(shape)} bf16 causal: backward (matmuls) "
        f"{bwd_ms:.4f} ms per call, kernel forward {fwd_ms:.4f} ms; SDPA forward+"
        f"backward on the gathered (8, 16, 1024, 64) {sdpa_ms:.4f} ms {where}")
    b = out["attention_backward"]
    lib = "not measured" if b["library_ms"] is None else f"{b['library_ms']:.4f} ms"
    log(f"train: attention backward kernel at {b['shape']}: against plain "
        f"{b['main_parity']['rel_err']}; in turns kernel {b['ms_turns']} ms, plain "
        f"{b['plain_ms_turns']} ms, SDPA forward+backward {b['library_ms_turns']} ms; "
        f"medians {b['ms']:.4f} / {b['plain_ms']:.4f} / {lib}; main launches' span "
        f"{b['span_ms']:.4f} ms; bound {b['bound'][0]:.4f} ms ({b['bound'][1]}); "
        f"kernel calls over the {TRAIN_STEPS} sp steps {out['sp']['backward_launches_by_dims']} "
        f"{where}")
    return out


# ---------------------------------------------------------------------------
# 13. point-to-point and Cartesian topology
# ---------------------------------------------------------------------------

def busy_union_us(events) -> float:
    """The device's busy time in a Chrome trace: the union of its kernel,
    memcpy and memset spans (µs)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def p2p_operands(host: list) -> tuple:
    """Each rank's bfloat16 (raw bits) and int32 messages, from SEED; the
    float32 messages are the host path's operands."""
    rng = np.random.default_rng(SEED + 13)
    bf16 = []
    for _ in host:
        bits = rng.integers(0, 1 << 16, P2P_SIDE, dtype=np.uint16)
        bits[(bits & 0x7F80) == 0x7F80] &= 0x807F       # no NaN or inf
        bf16.append(bits)
    ints = [rng.integers(-(1 << 20), 1 << 20, P2P_SIDE, dtype=np.int32)
            for _ in host]
    return bf16, ints


def p2p_exchange(MPI, host: list, device) -> dict:
    """Phase 13a: every point-to-point lane at the main path's size on
    len(host) rank threads, checked on the card: a ring Sendrecv of raw
    tensors and of DeviceBuffers, Isend/Irecv + Waitall, P2P_ROUNDS
    persistent rounds, a partitioned exchange of P2P_PARTS partitions.
    Every received tensor must be on the card and bitwise equal to what
    was sent; no received raw tensor may share storage with any sender's
    tensor; the DeviceBuffer receive shares the sender's tensor (zero
    copy), and a sender's write after the Wait reaches no receiver."""
    import torch
    n = len(host)
    bf16, ints = p2p_operands(host)
    sent_ptrs: dict = {}
    cell_ptrs: dict = {}

    def ptr(t):
        return t.untyped_storage().data_ptr()

    def expect(what, got, want):
        if got.device.type != torch.device(device).type:
            raise AssertionError(f"{what} received on {got.device}")
        if not same_bits(got, want):
            raise AssertionError(f"{what}: received tensor differs from the "
                                 f"one sent (max_abs_err {max_abs_err(got, want)})")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        nxt, prv = (r + 1) % n, (r - 1) % n
        x = torch.from_numpy(host[r]).to(device, copy=True)
        xb = MPI.from_numpy(bf16[r], device, torch.bfloat16)
        xi = torch.from_numpy(ints[r]).to(device, copy=True)
        want = torch.from_numpy(host[prv]).to(device, copy=True)
        want_b = MPI.from_numpy(bf16[prv], device, torch.bfloat16)
        want_i = torch.from_numpy(ints[prv]).to(device, copy=True)
        # raw tensors: the sender's snapshot and the receive copy
        y = torch.empty_like(x)
        st = MPI.Sendrecv(x, nxt, 0, y, prv, 0, comm)
        if (st.source, st.count) != (prv, x.numel()):
            raise AssertionError(f"Sendrecv status {st}")
        expect("ring Sendrecv, raw", y, want)
        # DeviceBuffers: zero copy, the cells copy on write
        dx = MPI.DeviceBuffer(x.clone(), device=device)
        dy = MPI.DeviceBuffer(torch.zeros_like(x), device=device)
        MPI.Sendrecv(dx, nxt, 1, dy, prv, 1, comm)
        expect("ring Sendrecv, DeviceBuffer", dy.value, want)
        # Isend / Irecv + Waitall
        yb, yi = torch.empty_like(xb), torch.empty_like(xi)
        MPI.Waitall([MPI.Irecv(yb, prv, 2, comm), MPI.Irecv(yi, prv, 3, comm),
                     MPI.Isend(xb, nxt, 2, comm), MPI.Isend(xi, nxt, 3, comm)])
        expect("Irecv bfloat16", yb, want_b)
        expect("Irecv int32", yi, want_i)
        # persistent rounds: the send buffer changes between rounds
        sbuf, rbuf = xi.clone(), torch.empty_like(xi)
        reqs = [MPI.Recv_init(rbuf, prv, 4, comm), MPI.Send_init(sbuf, nxt, 4, comm)]
        for k in range(P2P_ROUNDS):
            sbuf.add_(1)
            MPI.Startall(reqs)
            MPI.Waitall(reqs)
            expect(f"persistent round {k}", rbuf, want_i + (k + 1))
        # partitioned: each partition snapshotted at its Pready
        z = torch.empty_like(x)
        rreq = MPI.Precv_init(z, P2P_PARTS, prv, 5, comm)
        sreq = MPI.Psend_init(x, P2P_PARTS, nxt, 5, comm)
        MPI.Startall([rreq, sreq])
        for i in reversed(range(P2P_PARTS)):
            MPI.Pready(sreq, i)
        MPI.Waitall([sreq, rreq])
        expect("partitioned", z, want)
        # no received raw tensor shares storage with any rank's sent tensor;
        # the DeviceBuffer receive holds the sender's tensor
        sent_ptrs[r] = {ptr(t) for t in (x, xb, xi, sbuf)}
        cell_ptrs[r] = ptr(dx.value)
        MPI.Barrier(comm)
        sent = set().union(*sent_ptrs.values())
        aliased = [name for name, t in (("y", y), ("yb", yb), ("yi", yi),
                                        ("rbuf", rbuf), ("z", z))
                   if ptr(t) in sent]
        if aliased:
            raise AssertionError(f"rank {r}: {aliased} share a sender's storage")
        shares = ptr(dy.value) == cell_ptrs[prv]
        MPI.Barrier(comm)
        # writes after the Wait: raw in place, DeviceBuffer through its cell
        x.add_(1.0)
        dx.fill(-1.0)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        expect("raw receive after the sender's write", y, want)
        expect("DeviceBuffer receive after the sender's cell write", dy.value,
               want)
        MPI.Finalize()
        return shares

    shares = MPI.spmd_run(body, n, timeout=600)
    if not all(shares):
        raise AssertionError(f"a DeviceBuffer receive copied: {shares}")
    return {"ranks": n, "dtypes": ["float32", "bfloat16", "int32"],
            "float32_elems": int(host[0].size), "side_elems": P2P_SIDE,
            "partitions": P2P_PARTS, "persistent_rounds": P2P_ROUNDS}


def p2p_times(MPI, host: list, device) -> dict:
    """Phase 13a's times, rank 0's wall clock between barriers that follow
    a device synchronise: ms per ring Sendrecv round of the float32[2^26]
    tensors, raw and as DeviceBuffers (median of P2P_RING_ITERS); µs per
    round trip of an 8-byte CUDA tensor and of an 8-byte numpy array
    between ranks 0 and 1 (PINGPONG round trips); ms to send and receive a
    float32[2^26] CUDA tensor as an object (median of OBJECT_ITERS)."""
    import torch
    n = len(host)

    def between_barriers(comm, fn) -> float:
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        return time.perf_counter() - t0

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        nxt, prv = (r + 1) % n, (r - 1) % n
        x = torch.from_numpy(host[r]).to(device, copy=True)
        out = {}
        for name, a, b in (
                ("raw", x, torch.empty_like(x)),
                ("devicebuffer", MPI.DeviceBuffer(x.clone(), device=device),
                 MPI.DeviceBuffer(torch.zeros_like(x), device=device))):
            ts = [between_barriers(comm, lambda: MPI.Sendrecv(a, nxt, 0, b, prv,
                                                              0, comm))
                  for _ in range(WARMUP + P2P_RING_ITERS)]
            out[f"ring_{name}_ms"] = float(np.median(ts[WARMUP:])) * 1e3
        for name, make in (
                ("cuda", lambda: torch.zeros(1, dtype=torch.float64, device=device)),
                ("numpy", lambda: np.zeros(1))):
            a, b = make(), make()

            def pingpong():
                for _ in range(PINGPONG):
                    if r == 0:
                        MPI.Send(a, 1, 7, comm)
                        MPI.Recv(b, 1, 7, comm)
                    elif r == 1:
                        MPI.Recv(b, 0, 7, comm)
                        MPI.Send(b, 0, 7, comm)

            out[f"roundtrip_8B_{name}_us"] = between_barriers(comm, pingpong) \
                / PINGPONG * 1e6
        want0 = torch.from_numpy(host[0]).to(device, copy=True) if r == 1 else None
        got: list = []

        def object_message():
            if r == 0:
                MPI.send(x, 1, 8, comm)
            elif r == 1:
                got.append(MPI.recv(0, 8, comm)[0])

        ts = []
        for _ in range(OBJECT_ITERS):
            ts.append(between_barriers(comm, object_message))
            if got and (got[-1].device != want0.device
                        or not same_bits(got.pop(), want0)):
                raise AssertionError("object message: the tensor differs or "
                                     "came back elsewhere")
        out["object_256MiB_ms"] = float(np.median(ts)) * 1e3
        MPI.Finalize()
        return out

    return MPI.spmd_run(body, n, timeout=600)[0]


def jacobi_sweep(u, rows: int):
    """One five-point update of a slab's rows 1..rows: the new rows and
    their largest change, a one-element tensor."""
    new = u[1:rows + 1].clone()
    new[:, 1:-1] = 0.25 * (u[:rows, 1:-1] + u[2:, 1:-1]
                           + u[1:rows + 1, :-2] + u[1:rows + 1, 2:])
    return new, (new - u[1:rows + 1]).abs().max().reshape(1)


def jacobi(MPI, device, n: int, nranks: int, sweeps: int,
           logdir=None) -> list:
    """Phase 13b: examples/06-jacobi.py on the card, ``sweeps`` sweeps with
    no early stop. ``nranks`` rank threads over ``Cart_create(comm, 1,
    [nranks], [False], False)``; each holds a (n/nranks + 2, n) float32
    slab; a sweep is two halo ``Sendrecv`` over ``Cart_shift``, the
    five-point update in torch, and ``Allreduce(res, MPI.MAX, cart)`` of a
    one-element CUDA tensor. Per rank: its slab, its residuals, the wall
    time and (rank 0) the CUDA-event time of the sweeps; with ``logdir``,
    under ``MPI.profile_trace``."""
    import contextlib
    import torch
    rows = n // nranks

    def body():
        MPI.Init()
        cart = MPI.Cart_create(MPI.COMM_WORLD, 1, [nranks], [False], False)
        up, down = MPI.Cart_shift(cart, 0, 1)
        u = torch.zeros(rows + 2, n, device=device)
        if MPI.Comm_rank(cart) == 0:
            u[0] = 1.0                       # the fixed hot top edge
        res = []
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        MPI.Barrier(cart)
        trace = MPI.profile_trace(logdir) if logdir else contextlib.nullcontext()
        with trace:
            t0 = time.perf_counter()
            start.record()
            for _ in range(sweeps):
                MPI.Sendrecv(u[1], up, 0, u[rows + 1], down, 0, cart)
                MPI.Sendrecv(u[rows], down, 1, u[0], up, 1, cart)
                new, local = jacobi_sweep(u, rows)
                u[1:rows + 1] = new
                res.append(MPI.Allreduce(local, MPI.MAX, cart))
            # after the last Allreduce every rank's sweeps are on the stream
            stop.record()
            torch.cuda.synchronize()
            MPI.Barrier(cart)
            wall = time.perf_counter() - t0
        MPI.Finalize()
        return u[1:rows + 1], torch.cat(res), wall, start.elapsed_time(stop)

    return MPI.spmd_run(body, nranks, timeout=600)


def jacobi_whole(device, n: int, sweeps: int) -> tuple:
    """The same sweeps on the whole grid in one thread."""
    import torch
    u = torch.zeros(n + 2, n, device=device)
    u[0] = 1.0
    res = []
    for _ in range(sweeps):
        new, r = jacobi_sweep(u, n)
        u[1:n + 1] = new
        res.append(r)
    return u[1:n + 1], torch.cat(res)


def check_jacobi(out: list, whole: tuple) -> None:
    import torch
    grid, residuals = whole
    got = torch.cat([u for u, _, _, _ in out])
    if got.device != grid.device or not same_bits(got, grid):
        raise AssertionError(f"Jacobi grid differs from the one-thread sweeps "
                             f"(max_abs_err {max_abs_err(got, grid)})")
    for r, (_, res, _, _) in enumerate(out):
        if not same_bits(res, residuals):
            raise AssertionError(f"rank {r}'s Jacobi residuals differ from the "
                                 f"one-thread sweeps: {res.tolist()[:4]} vs "
                                 f"{residuals.tolist()[:4]}")


def neighbors(MPI, device) -> dict:
    """Phase 13c: ``Neighbor_allgather`` and ``Neighbor_alltoall`` on a 2 x 2
    non-periodic Cart with 1 MiB float32 blocks on the card, allocating and
    into a caller's buffer pre-filled with -7, against the plain gather of
    each neighbour's block, bitwise; PROC_NULL slots are zeros (allocating)
    or keep the -7 fill."""
    import torch
    c = NEIGHBOR_COUNT
    rng = np.random.default_rng(SEED + 14)
    blocks = [rng.standard_normal(c, dtype=np.float32) for _ in range(4)]
    a2a = [rng.standard_normal(4 * c, dtype=np.float32) for _ in range(4)]

    def body():
        MPI.Init()
        cart = MPI.Cart_create(MPI.COMM_WORLD, [2, 2], [False, False], False)
        r = MPI.Comm_rank(cart)
        nbrs = [*MPI.Cart_shift(cart, 0, 1), *MPI.Cart_shift(cart, 1, 1)]
        send = torch.from_numpy(blocks[r]).to(device, copy=True)
        send2 = torch.from_numpy(a2a[r]).to(device, copy=True)
        fill = torch.full((4 * c,), -7.0, device=device)
        outs = {"allgather": MPI.Neighbor_allgather(send, cart),
                "alltoall": MPI.Neighbor_alltoall(send2, c, cart)}
        into = {"allgather": fill.clone(), "alltoall": fill.clone()}
        MPI.Neighbor_allgather(send, into["allgather"], cart)
        MPI.Neighbor_alltoall(send2, into["alltoall"], c, cart)
        for name in outs:
            got, got_into = outs[name], into[name].view(4, c)
            if got.device != send.device or tuple(got.shape) != (4, c):
                raise AssertionError(f"Neighbor_{name}: {got.shape} on {got.device}")
            for i, nb in enumerate(nbrs):
                if nb == MPI.PROC_NULL:
                    want, want_into = torch.zeros(c, device=device), fill[:c]
                else:
                    src = blocks[nb] if name == "allgather" else \
                        a2a[nb][(i ^ 1) * c:((i ^ 1) + 1) * c]
                    want = want_into = torch.from_numpy(src).to(device, copy=True)
                if not (same_bits(got[i], want) and same_bits(got_into[i], want_into)):
                    raise AssertionError(f"rank {r} Neighbor_{name} slot {i} "
                                         f"(neighbour {nb}) differs")
        MPI.Finalize()
        return sum(nb == MPI.PROC_NULL for nb in nbrs)

    nulls = MPI.spmd_run(body, 4, timeout=600)
    return {"grid": [2, 2], "block_bytes": 4 * c, "proc_null_slots": sum(nulls)}


def p2p_phase(MPI, host: list, device, caps: dict,
              copy_gbps: float, logdir: str, where: str) -> dict:
    """Phase 13: (a) point-to-point at the main path's size, (b) the Jacobi
    halo loop at JACOBI_N, (c) the neighbourhood collectives; checks, then
    times. Returns the numbers for the kernels line; the Jacobi loop's
    fold launches under ``jacobi_launches``."""
    import torch
    t0 = time.perf_counter()
    kernel_counts().reset()
    exch = p2p_exchange(MPI, host, device)
    t_exch = time.perf_counter() - t0
    k = kernel_counts().snapshot()
    if k["fold_launches"] or k["chained_folds"]:
        raise AssertionError(f"point-to-point launched {k['fold_launches']} folds")
    log(f"13a point-to-point on {exch['ranks']} rank threads, float32[2^26] "
        f"raw and DeviceBuffer ring Sendrecv, Isend/Irecv bfloat16 and int32 "
        f"[2^24], {P2P_ROUNDS} Send_init/Recv_init rounds, {P2P_PARTS} "
        f"partitions: every received tensor on cuda and bitwise equal to what "
        f"was sent; no raw receive shares a sender's storage; the DeviceBuffer "
        f"receives share the sender's tensor and keep it after the sender's "
        f"cell write; raw receives unchanged by the sender's write in place "
        f"({t_exch:.1f} s)")
    t1 = time.perf_counter()
    times = p2p_times(MPI, host, device)
    t_times = time.perf_counter() - t1
    raw_bytes = 4 * host[0].nbytes * len(host)   # snapshot + receive copy, r+w
    raw_bound = raw_bytes / (caps["hbm_gbps"] * 1e9) * 1e3
    raw_copy = raw_bytes / (copy_gbps * 1e9) * 1e3
    log(f"13a ring Sendrecv round, {len(host)} ranks x float32[2^26]: raw "
        f"{times['ring_raw_ms']:.4f} ms (moves {raw_bytes} bytes: bound "
        f"{raw_bound:.4f} ms at {caps['hbm_gbps']:.0f} GB/s spec, "
        f"{raw_copy:.4f} ms at this run's copy rate); DeviceBuffer "
        f"{times['ring_devicebuffer_ms']:.4f} ms (moves 0 bytes: the cells "
        f"rebind; all host hand-off); median of {P2P_RING_ITERS} {where}")
    log(f"13a 8-byte round trip: CUDA tensor {times['roundtrip_8B_cuda_us']:.2f} "
        f"us, numpy {times['roundtrip_8B_numpy_us']:.2f} us ({PINGPONG} round "
        f"trips); send/recv of a 256 MiB CUDA tensor as an object "
        f"{times['object_256MiB_ms']:.2f} ms (through host bytes) {where} "
        f"({t_times:.1f} s)")

    nranks = len(host)
    t1 = time.perf_counter()
    kernel_counts().reset()
    out = jacobi(MPI, device, JACOBI_N, nranks, JACOBI_SWEEPS)
    folds, chained = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"]
    if folds != JACOBI_SWEEPS or chained:
        raise AssertionError(f"Jacobi: {folds} fold launches and {chained} "
                             f"chained folds for {JACOBI_SWEEPS} sweeps")
    check_jacobi(out, jacobi_whole(device, JACOBI_N, JACOBI_SWEEPS))
    first, last = out[0][1][0].item(), out[0][1][-1].item()
    del out
    log(f"13b Jacobi {JACOBI_N}x{JACOBI_N} float32 on a 1-d Cart of {nranks} "
        f"rank threads, {JACOBI_SWEEPS} sweeps: grid and every residual bitwise "
        f"equal to the one-thread sweeps; {folds} fold launches, 0 chained; "
        f"residual {first} -> {last} ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    timed = jacobi(MPI, device, JACOBI_N, nranks, JACOBI_TIMED)
    wall_ms = max(w for _, _, w, _ in timed) / JACOBI_TIMED * 1e3
    event_ms = timed[0][3] / JACOBI_TIMED
    del timed
    jdir = os.path.join(logdir, "jacobi")
    jacobi(MPI, device, JACOBI_N, nranks, JACOBI_TIMED, logdir=jdir)
    trace = max((os.path.join(jdir, f) for f in os.listdir(jdir)),
                key=os.path.getmtime)
    with open(trace) as f:
        busy_ms = busy_union_us(json.load(f).get("traceEvents", [])) / 1e3 \
            / JACOBI_TIMED
    sweep_bound = 2 * (JACOBI_N + 2) * JACOBI_N * 4 / (caps["hbm_gbps"] * 1e9) * 1e3
    host_share = 1 - busy_ms / wall_ms if busy_ms else None
    log(f"13b Jacobi per sweep ({JACOBI_TIMED} sweeps): wall {wall_ms:.4f} ms, "
        f"CUDA events {event_ms:.4f} ms, device busy {busy_ms:.4f} ms under the "
        f"profiler (host share {host_share}); bound {sweep_bound:.4f} ms (the "
        f"grid read and written once) {where} ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    nb = neighbors(MPI, device)
    log(f"13c Neighbor_allgather and Neighbor_alltoall on a 2x2 non-periodic "
        f"Cart, 1 MiB float32 blocks on cuda: bitwise equal to the plain gather; "
        f"{nb['proc_null_slots']} PROC_NULL slots zero (allocating) or "
        f"untouched (caller's buffer) ({time.perf_counter() - t1:.1f} s)")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 13 in {seconds:.1f} s")
    return {"jacobi_launches": folds, "exchange": exch, "times": times,
            "ring_raw_bytes": raw_bytes, "ring_raw_bound_ms": raw_bound,
            "ring_raw_copy_control_ms": raw_copy,
            "jacobi": {"n": JACOBI_N, "ranks": nranks, "sweeps": JACOBI_SWEEPS,
                       "sweep_wall_ms": wall_ms, "sweep_event_ms": event_ms,
                       "sweep_busy_ms": busy_ms, "host_share": host_share,
                       "sweep_bound_ms": sweep_bound},
            "neighbors": nb, "seconds": seconds}


# ---------------------------------------------------------------------------
# 14. one-sided RMA, MPI-IO and checkpoints
# ---------------------------------------------------------------------------

def _val(x):
    """A window's tensor: a raw tensor itself, a cell's current value."""
    return getattr(x, "value", x)


def rma_operands(host: list) -> dict:
    """14a's seeded inputs beside the host path's float32[2^26] windows:
    the int32 windows and origins of the concurrent Accumulate, and the
    float32 origins of the one-origin-per-epoch Accumulate."""
    rng = np.random.default_rng(SEED + 14)
    n = len(host)
    ints = [rng.integers(-(1 << 20), 1 << 20, RMA_INT, dtype=np.int32)
            for _ in range(n + 1)]
    floats = [rng.standard_normal(RMA_BLOCK).astype(np.float32) for _ in range(n)]
    return {"int_start": ints[0], "int_origins": ints[1:], "float_origins": floats}


def rma_checks(MPI, host: list, ops: dict, device, kind: str) -> dict:
    """14a on ``kind`` windows ('tensor': raw CUDA tensors, written in
    place; 'devicebuffer': cells that copy on write) over 4 rank threads,
    every check bitwise: a fence epoch of Puts of a RMA_BLOCK block into
    the right neighbour's window, a fence epoch of Gets from the left
    neighbour's; an int32 Accumulate SUM from every rank into rank 0; a
    float32 Accumulate, one origin per epoch, against the plain fold;
    FETCHES Fetch_and_op SUMs per rank on rank 0's int64 counter, which
    must end at n * FETCHES with every fetched value distinct; for raw
    tensors also test_fetch_and_op_dynamic's dynamic window and
    :func:`overlapping_origins`."""
    import torch
    from tpu_mpi_torch.kernels import fused_reduce as fr
    n, B = len(host), RMA_BLOCK
    wrap = (lambda t: t) if kind == "tensor" else \
        (lambda t: MPI.DeviceBuffer(t, device=device))
    fold_want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(host[0][B:2 * B]).to(device)]
        + [torch.from_numpy(o).to(device) for o in ops["float_origins"]], "SUM")
    int_want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(ops["int_start"]).to(device)]
        + [torch.from_numpy(o).to(device) for o in ops["int_origins"]], "SUM")

    def expect(what, got, want):
        if got.device.type != torch.device(device).type or not same_bits(got, want):
            raise AssertionError(f"14a {kind}: {what} differs")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        right, left = (r + 1) % n, (r - 1) % n
        main = wrap(torch.from_numpy(host[r]).to(device))
        win = MPI.Win_create(main, comm)
        origin = torch.from_numpy(host[r][:B]).to(device)
        MPI.Win_fence(0, win)
        MPI.Put(origin, B, right, 2 * B, win)
        MPI.Win_fence(0, win)
        back = torch.empty(B, dtype=torch.float32, device=device)
        MPI.Get(back, B, left, 2 * B, win)
        MPI.Win_fence(0, win)
        expect("Get from the left neighbour", back,
               torch.from_numpy(host[(r - 2) % n][:B]).to(device))
        want = torch.from_numpy(host[r]).to(device)
        want[2 * B:3 * B] = torch.from_numpy(host[left][:B]).to(device)
        expect("window after the Put epoch", _val(main), want)
        del want, back
        # float32: one origin per fence epoch, so the order is fixed
        facc = torch.from_numpy(ops["float_origins"][r]).to(device)
        for o in range(n):
            if o == r:
                MPI.Accumulate(facc, B, 0, B, MPI.SUM, win)
            MPI.Win_fence(0, win)
        if r == 0:
            expect("float32 Accumulate", _val(main)[B:2 * B], fold_want)
        # int32: every origin in one epoch, any order
        ibuf = wrap(torch.from_numpy(ops["int_start"]).to(device))
        iwin = MPI.Win_create(ibuf, comm)
        MPI.Win_fence(0, iwin)
        MPI.Accumulate(torch.from_numpy(ops["int_origins"][r]).to(device),
                       RMA_INT, 0, 0, MPI.SUM, iwin)
        MPI.Win_fence(0, iwin)
        if r == 0:
            expect("int32 Accumulate from every rank", _val(ibuf), int_want)
        # the shared counter
        counter = wrap(torch.zeros(1, dtype=torch.int64, device=device))
        cwin = MPI.Win_create(counter, comm)
        fetched = torch.empty(FETCHES, dtype=torch.int64, device=device)
        one = torch.ones(1, dtype=torch.int64, device=device)
        MPI.Win_fence(0, cwin)
        for i in range(FETCHES):
            MPI.Fetch_and_op(one, fetched[i:i + 1], 0, 0, MPI.SUM, cwin)
        MPI.Win_fence(0, cwin)
        total = int(_val(counter).item()) if r == 0 else None
        dynamic = dynamic_window(MPI, comm, device) if kind == "tensor" else None
        if kind == "tensor":
            overlapping_origins(MPI, comm, host[r], device)
        for w in (win, iwin, cwin):
            w.free()
        MPI.Finalize()
        return total, fetched.cpu(), dynamic

    out = MPI.spmd_run(body, n, timeout=600)
    total = out[0][0]
    seen = torch.cat([f for _, f, _ in out]).sort().values
    if total != n * FETCHES or not torch.equal(seen, torch.arange(n * FETCHES)):
        raise AssertionError(f"14a {kind}: counter {total}, fetched values not "
                             f"0..{n * FETCHES - 1} once each")
    return {"counter": total, "dynamic": out[0][2]}


def overlapping_origins(MPI, comm, start: np.ndarray, device) -> None:
    """14a on a raw CUDA tensor window of 2 RMA_BLOCK float32 (the head of
    the rank's host operand), each rank at its own: four fence epochs whose
    origin views the window's first RMA_BLOCK elements and whose target
    starts at OVERLAP_SHIFT (Get: the origin at OVERLAP_SHIFT, read from 0)
    — Accumulate SUM, Get_accumulate REPLACE into the window's second
    block, Put, Get. Each window is held bitwise to plain PyTorch on a copy
    taken before the epoch, which reads the source in full before writing
    (numpy's rule). Only the Accumulate launches the fold kernel."""
    import torch
    from tpu_mpi_torch.kernels import fused_reduce as fr
    r, B = MPI.Comm_rank(comm), RMA_BLOCK
    lo, hi = OVERLAP_SHIFT, OVERLAP_SHIFT + B
    w = torch.from_numpy(start[:2 * B]).to(device)
    win = MPI.Win_create(w, comm)

    def plain_accumulate(x):
        x[lo:hi] = fr.fused_multi_reduce_plain([x[lo:hi].clone(), x[:B].clone()],
                                               "SUM")

    def plain_get_accumulate(x):
        x[B:] = x[lo:hi].clone()
        x[lo:hi] = x[:B].clone()

    def plain_move(x):
        x[lo:hi] = x[:B].clone()

    epochs = {
        "Accumulate SUM": (lambda: MPI.Accumulate(w[:B], B, r, lo, MPI.SUM, win),
                           plain_accumulate),
        "Get_accumulate REPLACE": (lambda: MPI.Get_accumulate(
            w[:B], w[B:], B, r, lo, MPI.REPLACE, win), plain_get_accumulate),
        "Put": (lambda: MPI.Put(w[:B], B, r, lo, win), plain_move),
        "Get": (lambda: MPI.Get(w[lo:hi], B, r, 0, win), plain_move),
    }
    MPI.Win_fence(0, win)
    for what, (call, plain) in epochs.items():
        want = w.clone()
        plain(want)
        call()
        MPI.Win_fence(0, win)
        if not same_bits(w, want):
            raise AssertionError(f"14a tensor: {what} with an overlapping origin "
                                 f"differs from plain")
    win.free()


def dynamic_window(MPI, comm, device) -> list:
    """tests/test_onesided.py::test_fetch_and_op_dynamic on raw CUDA
    tensors: addresses from Get_address shared through a static window,
    Fetch_and_op REPLACE at byte addresses."""
    import torch
    r, n = MPI.Comm_rank(comm), MPI.Comm_size(comm)
    buf = torch.full((n,), r, dtype=torch.int64, device=device)
    if MPI.Get_address(buf) != buf.data_ptr():
        raise AssertionError("Get_address of a CUDA tensor is not its data_ptr")
    win = MPI.Win_create_dynamic(comm)
    MPI.Win_attach(win, buf)
    address_buf = np.zeros(1, dtype=np.int64)
    address_win = MPI.Win_create(address_buf, comm)
    MPI.Win_lock(MPI.LOCK_EXCLUSIVE, r, 0, address_win)
    address_buf[0] = MPI.Get_address(buf)
    MPI.Win_unlock(r, address_win)
    MPI.Barrier(comm)
    seen = []
    if r == 0:
        received = np.zeros(1, dtype=np.int64)
        to_send = np.zeros(1, dtype=np.int64)
        for t in range(n):
            address = np.zeros(1, dtype=np.int64)
            MPI.Win_lock(MPI.LOCK_EXCLUSIVE, t, 0, address_win)
            MPI.Get(address, t, address_win)
            MPI.Win_flush(t, address_win)
            to_send[0] = t + 5
            MPI.Win_lock(MPI.LOCK_EXCLUSIVE, t, 0, win)
            MPI.Fetch_and_op(to_send, received, t, int(address[0]) + t * 8,
                             MPI.REPLACE, win)
            MPI.Win_flush(t, win)
            seen.append(int(received[0]))
            MPI.Win_unlock(t, win)
            MPI.Win_unlock(t, address_win)
        if seen != list(range(n)):
            raise AssertionError(f"dynamic window fetched {seen}")
    MPI.Barrier(comm)
    if int(buf[r].item()) != r + 5:
        raise AssertionError("dynamic window: the REPLACE did not land")
    MPI.Barrier(comm)
    MPI.Win_detach(win, buf)
    win.free()
    address_win.free()
    return seen


def rma_times(MPI, host: list, device, kind: str) -> dict:
    """Times on ``kind`` windows over host's float32[2^26]: ms per Put
    epoch and per Get epoch (each rank moves RMA_BLOCK elements; fences
    included, ending in a device synchronise; median of RMA_EPOCH_ITERS),
    then rank 0 alone: us per 8-byte Put, Get and Fetch_and_op into rank
    1's windows (RMA_SMALL_ITERS each, ending in a synchronise)."""
    import torch
    n, B = len(host), RMA_BLOCK
    wrap = (lambda t: t) if kind == "tensor" else \
        (lambda t: MPI.DeviceBuffer(t, device=device))
    small = RMA_SMALL_ITERS if kind == "tensor" else RMA_CELL_ITERS

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        win = MPI.Win_create(wrap(torch.from_numpy(host[r]).to(device)), comm)
        counter = wrap(torch.zeros(1, dtype=torch.int64, device=device))
        cwin = MPI.Win_create(counter, comm)
        origin = torch.from_numpy(host[r][:B]).to(device)
        back = torch.empty(B, dtype=torch.float32, device=device)

        def epoch(fn):
            torch.cuda.synchronize()
            MPI.Barrier(comm)
            t0 = time.perf_counter()
            MPI.Win_fence(0, win)
            fn()
            MPI.Win_fence(0, win)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            MPI.Barrier(comm)
            return dt * 1e3

        put = [epoch(lambda: MPI.Put(origin, B, (r + 1) % n, 2 * B, win))
               for _ in range(RMA_EPOCH_ITERS + 1)][1:]
        get = [epoch(lambda: MPI.Get(back, B, (r - 1) % n, 2 * B, win))
               for _ in range(RMA_EPOCH_ITERS + 1)][1:]
        out = {"put_epoch_ms": put, "get_epoch_ms": get}
        MPI.Barrier(comm)
        if r == 0:
            x2 = torch.ones(2, dtype=torch.float32, device=device)
            y2 = torch.empty(2, dtype=torch.float32, device=device)
            one = torch.ones(1, dtype=torch.int64, device=device)
            got = torch.empty(1, dtype=torch.int64, device=device)
            ops = {"put_8B": lambda: MPI.Put(x2, 2, 1, 8, win),
                   "get_8B": lambda: MPI.Get(y2, 2, 1, 8, win),
                   "fetch_and_op_8B": lambda: MPI.Fetch_and_op(
                       one, got, 1, 0, MPI.SUM, cwin)}
            for name, fn in ops.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(small):
                    fn()
                torch.cuda.synchronize()
                out[f"{name}_us"] = (time.perf_counter() - t0) / small * 1e6
        MPI.Barrier(comm)
        win.free()
        cwin.free()
        MPI.Finalize()
        return out

    out = MPI.spmd_run(body, n, timeout=600)
    res = dict(out[0])
    res["put_epoch_ms"] = float(np.median([max(o["put_epoch_ms"][i] for o in out)
                                           for i in range(RMA_EPOCH_ITERS)]))
    res["get_epoch_ms"] = float(np.median([max(o["get_epoch_ms"][i] for o in out)
                                           for i in range(RMA_EPOCH_ITERS)]))
    res["small_iters"] = small
    return res


def io_phase(MPI, host: list, device, where: str) -> dict:
    """14b: each rank's float32[2^26] CUDA tensor written with write_at_all
    at rank x 256 MiB of one 1 GiB file in a temporary directory, read back
    with read_at_all into fresh CUDA tensors, bitwise; then a strided
    vector-filetype view read of IO_STRIDED elements (1 MiB) a rank, as
    tests/test_io.py::test_io_strided_filetype reads, bitwise. The file is
    deleted in any case."""
    import shutil
    import tempfile
    import torch
    n = len(host)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    path = os.path.join(tmp, "main.bin")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = torch.from_numpy(host[r]).to(device)
        fh = MPI.File.open(comm, path, read=True, write=True, create=True)
        try:
            MPI.File.set_view(fh, 0, MPI.FLOAT32, MPI.FLOAT32)
            torch.cuda.synchronize()
            MPI.Barrier(comm)
            t0 = time.perf_counter()
            MPI.File.write_at_all(fh, r * x.numel(), x)
            t1 = time.perf_counter()
            MPI.File.sync(fh)
            t2 = time.perf_counter()
            size = MPI.File.get_size(fh)
            back = torch.empty_like(x)
            MPI.Barrier(comm)
            t3 = time.perf_counter()
            MPI.File.read_at_all(fh, r * x.numel(), back)
            torch.cuda.synchronize()
            MPI.Barrier(comm)
            t4 = time.perf_counter()
            if back.device.type != torch.device(device).type or not same_bits(back, x):
                raise AssertionError(f"14b: rank {r} read back other bits")
            del back
            ft = MPI.Types.create_resized(
                MPI.Types.create_vector(1, 1, n, MPI.FLOAT32), 0, n * 4)
            MPI.File.set_view(fh, r * 4, MPI.FLOAT32, ft)
            strided = torch.empty(IO_STRIDED, dtype=torch.float32, device=device)
            MPI.Barrier(comm)
            t5 = time.perf_counter()
            MPI.File.read_at_all(fh, 0, strided)
            torch.cuda.synchronize()
            t6 = time.perf_counter()
            want = np.ascontiguousarray(host[0][r::n][:IO_STRIDED])
            if not same_bits(strided, torch.from_numpy(want).to(device)):
                raise AssertionError(f"14b: rank {r} strided view read differs")
        finally:
            fh.close()
        MPI.Finalize()
        return {"size": size, "write_s": t1 - t0, "sync_s": t2 - t1,
                "read_s": t4 - t3, "strided_s": t6 - t5}

    try:
        out = MPI.spmd_run(body, n, timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = sum(h.nbytes for h in host)
    if out[0]["size"] != total:
        raise AssertionError(f"14b: file of {out[0]['size']} bytes")
    write_s = max(o["write_s"] for o in out)
    sync_s = max(o["sync_s"] for o in out)
    read_s = max(o["read_s"] for o in out)
    strided_s = max(o["strided_s"] for o in out)
    res = {"file_bytes": total, "write_s": write_s, "sync_s": sync_s,
           "read_s": read_s, "write_gbps": total / write_s / 1e9,
           "write_sync_gbps": total / (write_s + sync_s) / 1e9,
           "read_gbps": total / read_s / 1e9,
           "staged_bytes": {"write": total, "read": total},
           "strided_elems": IO_STRIDED, "strided_ms": strided_s * 1e3}
    log(f"14b MPI-IO, {n} ranks x float32[2^26] CUDA tensors, one {total}-byte "
        f"file: write_at_all {write_s:.4f} s ({res['write_gbps']:.3f} GB/s; with "
        f"the sync {res['write_sync_gbps']:.3f} GB/s), read_at_all into fresh "
        f"CUDA tensors {read_s:.4f} s ({res['read_gbps']:.3f} GB/s, bitwise); "
        f"host staging {total} bytes each way (count x itemsize, no more); "
        f"strided vector-view read of {IO_STRIDED} float32 a rank "
        f"{strided_s * 1e3:.2f} ms, bitwise {where}")
    return res


def ckpt_grads(names: list, shapes: dict, step: int, rank: int, device):
    """Seeded float32 gradients on the card, in reverse-layer order, made
    lazily (each trainer copies one in before the next is drawn)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1400 + 10 * step + rank)
    return ((k, torch.randn(shapes[k], generator=gen, device=device))
            for k in reversed(names))


def release_world_plans() -> None:
    """Between runs, when no world is live: hold ``spmd_run`` to releasing
    the persistent-plan registrations of its run (the DDP trainers'
    buckets among them) when it returns, then collect, since a DDP trainer
    sits in reference cycles and its buckets and masters would otherwise
    stay on the card until the cyclic collector happens to run."""
    import gc
    import torch
    from tpu_mpi_torch import overlap
    left = overlap.registry.stats()["registrations"]
    if left:
        raise AssertionError(f"{left} plan registrations outlived their run")
    gc.collect()
    torch.cuda.empty_cache()


def ckpt_parts(tr) -> list:
    """A trainer's replicated state as flat float64 views: the params, then
    DDP's momentum (FSDP: its one padded param flat)."""
    if hasattr(tr, "_mom"):
        return [tr._flat[k] for k in tr.order] + [tr._mom[k] for k in tr.order]
    return [tr._flat]


def same_parts(parts: list, flat, chunk: int = 1 << 25) -> bool:
    """Whether the views ``parts``, end to end, equal ``flat`` bitwise,
    compared ``chunk`` elements at a time (four rank threads compare at
    once; a whole-state comparison would copy gigabytes each)."""
    off = 0
    for part in parts:
        for lo in range(0, part.numel(), chunk):
            piece = part[lo:lo + chunk]
            if not same_bits(piece, flat[off + lo:off + lo + piece.numel()]):
                return False
        off += part.numel()
    return off == flat.numel()


def ckpt_round(MPI, Trainer, start: dict, device, path: str, kw: dict) -> dict:
    """14c for one trainer class at the flagship width: take step 1, save,
    take step 2 (the uninterrupted run); a fresh trainer on the same
    NRANKS loads, takes step 2 and must equal it bitwise; a trainer on
    half the ranks loads the same file and must hold the saved state
    bitwise (the momentum re-cut for FSDP)."""
    import torch
    names = list(start)
    shapes = {k: tuple(v.shape) for k, v in start.items()}
    saved, after = {}, {}

    def timed(comm, fn):
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        return res, time.perf_counter() - t0

    def shard(tr):
        return tr._mshard.clone() if hasattr(tr, "_mshard") else None

    def uninterrupted():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        tr = Trainer(start, comm, device=device, **kw)
        tr.step(ckpt_grads(names, shapes, 1, r, device))
        _, save_s = timed(comm, lambda: tr.save(path))
        # the replicated state once (rank 0's), every rank's momentum shard
        saved[r] = (torch.cat(ckpt_parts(tr)) if r == 0 else None, shard(tr))
        tr.step(ckpt_grads(names, shapes, 2, r, device))
        after[r] = (torch.cat(ckpt_parts(tr)) if r == 0 else None, shard(tr))
        del tr
        MPI.Finalize()
        return save_s

    def resumed():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        tr = Trainer(start, comm, device=device, **kw)
        step, load_s = timed(comm, lambda: tr.load(path))
        tr.step(ckpt_grads(names, shapes, 2, r, device))
        mine = shard(tr)
        ok = step == 1 and same_parts(ckpt_parts(tr), after[0][0]) and (
            mine is None or same_bits(mine, after[r][1]))
        del tr, mine
        MPI.Finalize()
        return load_s, ok

    def resharded():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        tr = Trainer(start, comm, device=device, **kw)
        step, load_s = timed(comm, lambda: tr.load(path))
        mine = shard(tr)
        ok = step == 1 and same_parts(ckpt_parts(tr), saved[0][0])
        if mine is not None:      # the writers' momentum, re-cut for this world
            moms = torch.cat([saved[q][1] for q in range(NRANKS)])
            m = mine.numel()
            ok = ok and same_bits(mine, moms[r * m:(r + 1) * m])
            del moms
        del tr, mine
        MPI.Finalize()
        return load_s, ok

    f0, c0 = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"]
    try:
        save_s = max(MPI.spmd_run(uninterrupted, NRANKS, timeout=900))
        file_bytes = os.path.getsize(path)
        release_world_plans()
        res = MPI.spmd_run(resumed, NRANKS, timeout=900)
        k = kernel_counts().snapshot()
        folds, chained = k["fold_launches"] - f0, k["chained_folds"] - c0
        after.clear()
        release_world_plans()
        half = MPI.spmd_run(resharded, NRANKS // 2, timeout=900)
    finally:
        saved.clear()
        after.clear()
        if os.path.exists(path):
            os.remove(path)
        release_world_plans()
    load_s, reshard_s = max(s for s, _ in res), max(s for s, _ in half)
    return {"file_bytes": file_bytes, "save_s": save_s,
            "save_gbps": file_bytes / save_s / 1e9,
            "load_s": load_s, "load_gbps": file_bytes / load_s / 1e9,
            "reshard_load_s": reshard_s,
            "reshard_load_gbps": file_bytes / reshard_s / 1e9,
            "resume_bitwise": all(ok for _, ok in res),
            "reshard_bitwise": all(ok for _, ok in half),
            "fold_launches": folds, "chained_folds": chained}


def ckpt_phase(MPI, start: dict, device, where: str) -> dict:
    """14c: the phase-12 trainers' checkpoint round trip at the flagship
    width, DDP then FSDP, each file in a temporary directory deleted
    after its round."""
    import shutil
    import tempfile
    from tpu_mpi_torch.train import DDPTrainer, FSDPTrainer
    n_params = sum(int(v.numel()) for v in start.values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {"params": n_params}
    try:
        for name, cls, kw in (
                ("ddp", DDPTrainer, {"lr": TRAIN_LR, "bucket_bytes": TRAIN_BUCKET_BYTES}),
                ("fsdp", FSDPTrainer, {"lr": TRAIN_LR})):
            t = ckpt_round(MPI, cls, start, device, os.path.join(tmp, f"{name}.ckpt"), kw)
            out[name] = t
            log(f"14c {name.upper()} checkpoint at {n_params} parameters (float64 "
                f"masters + momentum, a {t['file_bytes']}-byte file): save "
                f"{t['save_s']:.3f} s ({t['save_gbps']:.3f} GB/s), load on "
                f"{NRANKS} ranks {t['load_s']:.3f} s ({t['load_gbps']:.3f} GB/s of "
                f"file; every rank reads every shard), resume step 2 bitwise "
                f"{t['resume_bitwise']}; {NRANKS // 2}-rank reshard load "
                f"{t['reshard_load_s']:.3f} s ({t['reshard_load_gbps']:.3f} GB/s), "
                f"bitwise {t['reshard_bitwise']}; fold launches in the steps "
                f"{t['fold_launches']}, chained {t['chained_folds']} {where}")
            if not (t["resume_bitwise"] and t["reshard_bitwise"]):
                raise AssertionError(f"14c {name}: a restored state differs")
            if t["chained_folds"] or not t["fold_launches"]:
                raise AssertionError(f"14c {name}: the steps left the fold kernel")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def rma_io_ckpt_phase(MPI, host: list, start: dict, device,
                      caps: dict, where: str) -> dict:
    """Phase 14: (a) one-sided RMA over raw CUDA tensors and DeviceBuffers,
    (b) MPI-IO at 1 GiB, (c) the trainers' checkpoints at the flagship
    width; checks, then times. The fold launches of (a)'s checked runs go
    to the kernels line as ``rma_launches``, (c)'s as ``ckpt_train_launches``."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    n, B = len(host), RMA_BLOCK
    ops = rma_operands(host)
    out = {"rma": {}}
    kernel_counts().reset()
    for kind in ("tensor", "devicebuffer"):
        f0 = kernel_counts()["fold_launches"]
        checks = rma_checks(MPI, host, ops, device, kind)
        launches = kernel_counts()["fold_launches"] - f0
        # one a CUDA accumulate: two Accumulate epochs and FETCHES
        # Fetch_and_op a rank, and the overlapping-origin Accumulate on raw
        # tensors
        expected = (2 + (kind == "tensor")) * n + n * FETCHES
        chained = kernel_counts()["chained_folds"]
        if launches != expected or chained:
            raise AssertionError(f"14a {kind}: {launches} fold launches for "
                                 f"{expected} CUDA accumulates, {chained} chained")
        out["rma"][kind] = {"launches": launches, "counter": checks["counter"]}
        log(f"14a RMA on {kind} windows, {n} rank threads x float32[2^26]: Put "
            f"and Get epochs of {B} elements a rank, int32 Accumulate from every "
            f"rank, float32 Accumulate one origin per epoch (== the plain fold), "
            f"{FETCHES} Fetch_and_op a rank (counter {checks['counter']}, every "
            f"fetched value once): all bitwise; {launches} fold launches = one per "
            f"CUDA accumulate, 0 chained"
            + (f"; dynamic window on raw CUDA tensors fetched {checks['dynamic']}; "
               f"overlapping origins (Accumulate SUM, Get_accumulate REPLACE, Put, "
               f"Get at displacement {OVERLAP_SHIFT}) == plain"
               if checks["dynamic"] is not None else ""))
    rma_launches = kernel_counts()["fold_launches"]
    release_world_plans()
    epoch_bytes = 2 * n * B * 4          # every rank's block read and written once
    epoch_bound = epoch_bytes / (caps["hbm_gbps"] * 1e9) * 1e3
    for kind in ("tensor", "devicebuffer"):
        t = rma_times(MPI, host, device, kind)
        t["epoch_bytes"], t["epoch_bound_ms"] = epoch_bytes, epoch_bound
        out["rma"][kind]["times"] = t
        release_world_plans()
        log(f"14a {kind} windows: Put epoch {t['put_epoch_ms']:.4f} ms, Get epoch "
            f"{t['get_epoch_ms']:.4f} ms (median of {RMA_EPOCH_ITERS}, fences "
            f"included; bound {epoch_bound:.4f} ms for {epoch_bytes} bytes at "
            f"{caps['hbm_gbps']:.0f} GB/s); rank 0 alone, 8 bytes: Put "
            f"{t['put_8B_us']:.2f} us, Get {t['get_8B_us']:.2f} us, Fetch_and_op "
            f"{t['fetch_and_op_8B_us']:.2f} us ({t['small_iters']} each) {where}")
    cell = out["rma"]["devicebuffer"]["times"]["put_8B_us"] / 1e3
    log(f"14a an 8-byte Put into a 256 MiB DeviceBuffer window: {cell:.4f} ms "
        f"(the cell copies on write: {2 * host[0].nbytes} bytes moved) {where}")
    out["rma"]["devicebuffer_put_8B_ms"] = cell
    out["io"] = io_phase(MPI, host, device, where)
    release_world_plans()
    kernel_counts().reset()
    out["ckpt"] = ckpt_phase(MPI, start, device, where)
    out["rma_launches"] = rma_launches
    out["ckpt_train_launches"] = (out["ckpt"]["ddp"]["fold_launches"]
                                  + out["ckpt"]["fsdp"]["fold_launches"])
    out["seconds"] = time.perf_counter() - t0
    out["device_bytes"] = {"at_start": mem0, "peak": torch.cuda.max_memory_allocated()}
    log(f"phase 14 in {out['seconds']:.1f} s; device memory allocated at its "
        f"start {mem0 / 2**30:.2f} GiB, peak {out['device_bytes']['peak'] / 2**30:.2f} GiB")
    return out


# ---------------------------------------------------------------------------
# 15. meshes of several axes at the flagship width
# ---------------------------------------------------------------------------

def multi_counts() -> dict:
    k = kernel_counts().snapshot()
    return {"folds": k["fold_launches"], "attention": k["attention_launches"],
            "sm90": k["attention_route_launches"]["sm90"],
            "permute": k["permute_launches"]["collective_permute"],
            "alltoall": k["permute_launches"]["pairwise_alltoall"],
            "chained": k["chained_folds"]}


def update_error_of(before: dict, got: dict, want: dict) -> float:
    """``update_error`` over dictionaries of tensors (any layout)."""
    worst = 0.0
    for k in before:
        u_got = before[k].double() - got[k].double()
        u_want = before[k].double() - want[k].double()
        worst = max(worst, float((u_got - u_want).abs().max())
                    / max(float(u_want.abs().max()), 1e-30))
    return worst


def stacked_to_flat(params: dict, n_layers: int) -> dict:
    """A layer-stacked dictionary (the 4-axis model's) as the flat model's
    (``layers`` a list)."""
    keys = ("ln1", "w_qkv", "w_proj", "ln2", "w_in", "w_out")
    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "layers": [{k: params[k][i] for k in keys} for i in range(n_layers)]}


def unshard_4d(tr, params: dict) -> dict:
    """The 4-axis step's tp shards (n_tp, L, ...) back to (L, ...)."""
    specs = tr.transformer_4d_specs("pp", "tp")
    out = {}
    for k, w in params.items():
        if specs[k] and specs[k][-1] == "tp":
            out[k] = w.movedim(0, -2).flatten(-2)
        elif len(specs[k]) > 1 and specs[k][1] == "tp":
            out[k] = w.movedim(0, 1).flatten(1, 2)
        else:
            out[k] = w
    return out


def dense_blocks_step(logits_fn, params: dict, tokens, labels, lr: float,
                      blocks: tuple, scale: float):
    """The single-device autograd step a multi-axis step computes: the
    loss of every (dp, sp) block of the batch the mean over its own
    positions, ``scale`` times their sum differentiated, SGD; the loss the
    blocks' mean. ``logits_fn(params, tokens)`` is the dense forward."""
    import torch
    leaves = {k: w.detach().requires_grad_() for k, w in params.items()}
    logits = logits_fn(leaves, tokens)
    n_dp, n_sp = blocks
    b, t = tokens.shape[0] // n_dp, tokens.shape[1] // n_sp
    losses = []
    for i in range(n_dp):
        for j in range(n_sp):
            lg = logits[i * b:(i + 1) * b, j * t:(j + 1) * t]
            lb = labels[i * b:(i + 1) * b, j * t:(j + 1) * t]
            logp = torch.log_softmax(lg, dim=-1)
            losses.append(-logp.gather(-1, lb[..., None])[..., 0].mean())
    total = sum(losses)
    grads = torch.autograd.grad(total * scale, list(leaves.values()))
    new = {k: (w.detach() - lr * g).to(w.dtype) for (k, w), g in zip(leaves.items(), grads)}
    return new, float(total.detach()) / len(losses)


def dense_moe_logits(tr, cfg, n_experts: int):
    """The plain dense MoE model of the pp x moe step: every layer in
    sequence, every expert on one device, each token through its argmax
    expert scaled by its gate probability. No token is dropped: a
    microbatch holds one sequence of SEQ tokens, and the step's capacity
    (2 x SEQ / n_experts per expert and source rank) takes all of them."""
    import torch
    import torch.nn.functional as F

    def logits(p, tokens):
        t = tokens.shape[1]
        positions = torch.arange(t, device=tokens.device)
        x = p["embed"][tokens]
        for i in range(cfg.n_layers):
            x = tr._attention(cfg, p["ln1"][i], p["w_qkv"][i], p["w_proj"][i], x,
                              positions, tp_axis=None, sp_axis=None)
            b, t, d = x.shape
            y = tr._rms_norm(x, p["ln2"][i]).reshape(b * t, d)
            gate = torch.softmax(y @ p["w_gate"][i], dim=-1)
            eidx = gate.argmax(-1)
            out = torch.zeros_like(y)
            for e in range(n_experts):
                rows = (eidx == e).nonzero()[:, 0]
                h = F.gelu(y[rows] @ p["w_in"][i, e], approximate="tanh")
                out = out.index_put((rows,), h @ p["w_out"][i, e])
            x = x + (out * gate.gather(-1, eidx[:, None])).reshape(b, t, d)
        return (tr._rms_norm(x, p["ln_f"]) @ p["embed"].T).to(torch.float32)

    return logits


def layout_copy_ms(xc, step, device) -> tuple:
    """The layout copies the collectives make in one step (recorded), then
    replayed alone with CUDA events: (count, bytes, ms per step)."""
    import torch
    xc.record_layout = []
    kernel_counts().reset()
    try:
        step()
        torch.cuda.synchronize()
        recorded = list(xc.record_layout)
    finally:
        xc.record_layout = None
    count, nbytes = kernel_counts()["layout_copies"], kernel_counts()["layout_copy_bytes"]
    srcs = [(torch.empty(shape, dtype=dtype, device=device), order)
            for shape, dtype, order in recorded]

    def replay():
        for x, order in srcs:
            x.permute(order + tuple(range(len(order), x.dim()))).contiguous()

    ms = time_ms(replay, iters=5, warmup=1) if srcs else 0.0
    del srcs
    return count, nbytes, ms


def backward_launch_times(xc, device) -> dict:
    """The new backward launches against their forwards, at the pp x moe
    step's shapes (bfloat16): the pipeline hop (the permute kernel with
    the inverse table) and the MoE exchange (the all-to-all kernel on the
    cotangent), each forward through its autograd function and backward
    through ``torch.autograd.grad`` (CUDA events per call)."""
    import torch
    hbm = 3.35e12                                     # spec sheet, bytes/s
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 15)
    n_dp, n_pp, n_ep = MESH_B.values()
    out = {}
    # a hop: (dp, pp, ep, b_m, t, d) over pp, as (n_pp, G * count) rows
    hop = torch.randn((n_pp, n_dp * n_ep * SEQ * FLAGSHIP["d_model"]), generator=gen,
                      device=device).to(torch.bfloat16).requires_grad_()
    src = tuple(xc._shift_sources(n_pp, 1))
    # the MoE exchange: (n_ep src, n_ep dst, G, capacity, d) blocks
    blocks = torch.randn((n_ep, n_ep, n_dp * n_pp, SEQ, FLAGSHIP["d_model"]),
                         generator=gen, device=device).to(torch.bfloat16).requires_grad_()
    for name, x, fwd in (("collective_permute", hop,
                          lambda: xc._PermuteRows.apply(hop, src)),
                         ("pairwise_alltoall", blocks,
                          lambda: xc._Exchange.apply(blocks))):
        y = fwd()
        g = torch.randn_like(y)
        got = torch.autograd.grad(y, x, g, retain_graph=True)[0]
        torch.cuda.synchronize()
        out[name] = {
            "shape": list(x.shape), "dtype": "bfloat16",
            "forward_ms": time_ms(fwd, iters=20),
            "backward_ms": time_ms(lambda: torch.autograd.grad(y, x, g,
                                                               retain_graph=True),
                                   iters=20),
            "bound_ms": 2 * x.numel() * x.element_size() / hbm * 1e3,
            "backward_shape": list(got.shape)}
        del y, g, got
    return out


def run_steps(step, params, tok, lab, steps: int, counters) -> tuple:
    """``steps`` SGD steps on one batch; the launches of each step."""
    import torch
    losses, per_step = [], []
    p = params
    for _ in range(steps):
        before = counters()
        p, loss = step(p, tok, lab)
        torch.cuda.synchronize()
        after = counters()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(float(loss))
    return p, losses, per_step


def check_launches(what: str, per_step: list, want: dict) -> None:
    for s, got in enumerate(per_step):
        for k, v in want.items():
            if got[k] != v:
                raise AssertionError(f"{what} step {s}: {got[k]} {k} launches, "
                                     f"the code gives {v} ({got})")


def multi_axis_phase(MPI, tr, xla, par, cfg, params, device, logdir: str,
                     where: str) -> dict:
    """Phase 15: the flagship on meshes of several axes — (a) dp x tp x sp
    forward and train step, (b) the pipelined MoE step, (c) the 4-axis
    step, (d) a halo exchange over two axes; launch counts asserted, float32
    steps against dense autograd, times."""
    import torch
    from tpu_mpi_torch.xla import collectives as xc
    t_phase = time.perf_counter()
    out = {}
    total = dict.fromkeys(("folds", "attention", "permute", "alltoall"), 0)

    def tally(*runs):
        for run in runs:
            for k in total:
                total[k] += run[k]

    L = cfg.n_layers
    counters = multi_counts
    rng = np.random.default_rng(SEED + 15)
    batch = rng.integers(0, cfg.vocab, (BATCH, SEQ))
    tok = torch.from_numpy(batch).to(device)
    lab = torch.from_numpy(np.roll(batch, -1, axis=1)).to(device)
    cfg32 = tr.TransformerConfig(**FLAGSHIP, dtype=torch.float32)

    def times(name, step, p, n_tokens, fresh=None):
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(p, tok, lab), iters=MULTI_TIMED, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: step(p, tok, lab), logdir, name, 2)
        # a replayed graph records no layout copies on the host, so they are
        # taken from the first (eager) call of a step built anew
        copies, copy_bytes, copy_ms = layout_copy_ms(
            xc, lambda: (fresh() if fresh else step)(p, tok, lab), device)
        return {"step_ms": ms, "tokens_per_s": n_tokens / (ms * 1e-3),
                "busy_ms": prof["busy_ms"] / prof["iters"],
                "window_ms": prof["window_ms"] / prof["iters"],
                "top_kernels": prof["top_kernels_ms_per_request"],
                "layout_copies": copies, "layout_copy_bytes": copy_bytes,
                "layout_copy_ms": copy_ms, "peak_bytes": peak}

    # -- (a) dp x tp x sp --------------------------------------------------
    n_tp, n_sp = MESH_A["tp"], MESH_A["sp"]
    shards = tr.shard_params(params, cfg, n_tp)
    kernel_counts().reset()
    before = counters()
    logits = tr.transformer_forward(cfg, shards, stack_seq(tok, n_sp), tp_axis="tp",
                                    sp_axis="sp")
    torch.cuda.synchronize()
    fwd = {k: v - before[k] for k, v in counters().items()}
    if tuple(logits.shape) != (n_tp, n_sp, BATCH, SEQ // n_sp, cfg.vocab):
        raise AssertionError(f"dp x tp x sp forward: logits {tuple(logits.shape)}")
    check = compare_logits(unstack_seq(logits[0]), tr.transformer_forward(cfg, params, tok),
                           "tp x sp vs dense forward", "bfloat16")
    del logits
    check_launches("tp x sp forward", [fwd], {"attention": L, "sm90": L, "folds": 2 * L,
                                              "permute": 0, "alltoall": 0, "chained": 0})
    step_a, _ = tr.transformer_train_step(cfg, xla.make_mesh(MESH_A), lr=TRAIN_LR)
    p_a, losses, per_step = run_steps(step_a, shards, tok, lab, TRAIN_STEPS, counters)
    want_a = {"attention": L, "sm90": L, "folds": 4 * L + (2 + 6 * L) + 1,
              "permute": 0, "alltoall": 0, "chained": 0}
    # the eager step and the capture launch through the wrappers; a replay
    # of the CUDA graph launches nothing the table counts
    check_launches("dp x tp x sp", per_step[:2], want_a)
    check_launches("dp x tp x sp replayed", per_step[2:], dict.fromkeys(want_a, 0))
    tally(fwd, *per_step)
    if not all(np.isfinite(losses)) or not all(a > b for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"dp x tp x sp: losses {losses} on one batch are not "
                             f"finite and falling")
    out["a"] = {"mesh": MESH_A, "forward_vs_dense": check, "forward_launches": fwd,
                "losses": losses, "launches_per_step": per_step[0]}
    out["a"]["times"] = times("train_dp_tp_sp", step_a, shards, BATCH * SEQ, lambda: (
        tr.transformer_train_step(cfg, xla.make_mesh(MESH_A), lr=TRAIN_LR)[0]))
    del p_a
    params32 = float32_params(params)
    step32, _ = tr.transformer_train_step(cfg32, xla.make_mesh(MESH_A), lr=TRAIN_LR_F32)
    got32, loss32 = step32(tr.shard_params(params32, cfg32, n_tp), tok, lab)
    want32, dloss32 = dense_blocks_step(
        lambda p, x: tr.transformer_forward(cfg32, nest_params(p, L), x),
        flat_params(params32), tok, lab, TRAIN_LR_F32, (MESH_A["dp"], n_sp), 1.0)
    out["a"]["f32_update_err"] = update_error_of(
        flat_params(params32), flat_params(unshard_tp(tr, cfg32, got32)), want32)
    out["a"]["f32_loss_err"] = abs(float(loss32) - dloss32)
    del got32, want32, params32, shards
    log(f"15a dp x tp x sp on {MESH_A}: forward (8, 1024) vs dense {check}, launches "
        f"{fwd}; {TRAIN_STEPS} steps on one batch, lr {TRAIN_LR}: losses {losses}, "
        f"launches a step {per_step[0]}; float32 step vs dense autograd: largest "
        f"update difference {out['a']['f32_update_err']} (bound {TRAIN_F32_TOL}), "
        f"loss diff {out['a']['f32_loss_err']}; times {out['a']['times']} {where}")
    if out["a"]["f32_update_err"] > TRAIN_F32_TOL:
        raise AssertionError("float32 dp x tp x sp step off the dense step")
    torch.cuda.empty_cache()

    # -- (b) pp x moe ------------------------------------------------------
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 16)
    moe = tr.transformer_pp_moe_init(gen, cfg, MOE_EXPERTS, device=device)
    step_b, _ = tr.transformer_pp_moe_train_step(cfg, xla.make_mesh(MESH_B), MOE_EXPERTS,
                                                 lr=TRAIN_LR, microbatches=MULTI_MICRO)
    kernel_counts().reset()
    p_b, losses, per_step = run_steps(step_b, moe, tok, lab, TRAIN_STEPS, counters)
    ticks = MULTI_MICRO + MESH_B["pp"] - 1
    L_local = L // MESH_B["pp"]
    want_b = {"attention": 0, "permute": 2 * ticks - 1,
              "alltoall": 4 * L_local * ticks, "folds": 5 * 2 + 2 * 2 + 2 + 4,
              "chained": 0}
    check_launches("pp x moe", per_step, want_b)
    tally(*per_step)
    if not all(np.isfinite(losses)) or not all(a > b for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"pp x moe: losses {losses} on one batch are not "
                             f"finite and falling")
    out["b"] = {"mesh": MESH_B, "experts": MOE_EXPERTS, "microbatches": MULTI_MICRO,
                "capacity": 2 * (BATCH // MESH_B["dp"] // MULTI_MICRO) * SEQ // MOE_EXPERTS,
                "losses": losses, "launches_per_step": per_step[0]}
    del p_b
    out["b"]["times"] = times("train_pp_moe", step_b, moe, BATCH * SEQ)
    cfg_moe32 = tr.TransformerConfig(**FLAGSHIP, dtype=torch.float32)
    moe32 = {k: w.float() for k, w in moe.items()}
    del moe
    step32, _ = tr.transformer_pp_moe_train_step(cfg_moe32, xla.make_mesh(MESH_B),
                                                 MOE_EXPERTS, lr=TRAIN_LR_F32,
                                                 microbatches=MULTI_MICRO)
    got32, loss32 = step32(moe32, tok, lab)
    torch.cuda.empty_cache()
    want32, dloss32 = dense_blocks_step(dense_moe_logits(tr, cfg_moe32, MOE_EXPERTS),
                                        moe32, tok, lab, TRAIN_LR_F32,
                                        (MESH_B["dp"], 1), MESH_B["pp"])
    out["b"]["f32_update_err"] = update_error_of(moe32, got32, want32)
    out["b"]["f32_loss_err"] = abs(float(loss32) - dloss32)
    del got32, want32, moe32
    log(f"15b pp x moe on {MESH_B}, {MOE_EXPERTS} experts, {MULTI_MICRO} microbatches, "
        f"capacity {out['b']['capacity']}: losses {losses}, launches a step "
        f"{per_step[0]}; float32 step vs the dense MoE model (x n_pp): largest update "
        f"difference {out['b']['f32_update_err']} (bound {TRAIN_F32_TOL}), loss diff "
        f"{out['b']['f32_loss_err']}; times {out['b']['times']} {where}")
    if out["b"]["f32_update_err"] > TRAIN_F32_TOL:
        raise AssertionError("float32 pp x moe step off the dense step")
    torch.cuda.empty_cache()

    # -- (c) dp x tp x sp x pp ---------------------------------------------
    gen.manual_seed(SEED + 17)
    p4 = tr.transformer_4d_init(gen, cfg, device=device)
    step_c, _ = tr.transformer_4d_train_step(cfg, xla.make_mesh(MESH_C), lr=TRAIN_LR,
                                             microbatches=MULTI_MICRO)
    cut4 = tr.shard_params(p4, cfg, MESH_C["tp"])
    kernel_counts().reset()
    p_c, losses, per_step = run_steps(step_c, cut4, tok, lab, TRAIN_STEPS, counters)
    ticks = MULTI_MICRO + MESH_C["pp"] - 1
    L_local = L // MESH_C["pp"]
    want_c = {"attention": L_local * ticks, "sm90": L_local * ticks,
              "permute": 2 * ticks - 1, "alltoall": 0,
              "folds": 4 * L_local * ticks + 2 + 6 + 3, "chained": 0}
    check_launches("4-axis", per_step, want_c)
    tally(*per_step)
    if not all(np.isfinite(losses)) or not all(a > b for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"4-axis: losses {losses} on one batch are not "
                             f"finite and falling")
    out["c"] = {"mesh": MESH_C, "microbatches": MULTI_MICRO, "losses": losses,
                "launches_per_step": per_step[0]}
    del p_c
    out["c"]["times"] = times("train_4d", step_c, cut4, BATCH * SEQ)
    del cut4
    p4_32 = {k: w.float() for k, w in p4.items()}
    del p4
    step32, _ = tr.transformer_4d_train_step(cfg32, xla.make_mesh(MESH_C),
                                             lr=TRAIN_LR_F32, microbatches=MULTI_MICRO)
    got32, loss32 = step32(tr.shard_params(p4_32, cfg32, MESH_C["tp"]), tok, lab)
    got32 = unshard_4d(tr, got32)
    torch.cuda.empty_cache()
    want32, dloss32 = dense_blocks_step(
        lambda p, x: tr.transformer_forward(cfg32, stacked_to_flat(p, L), x),
        p4_32, tok, lab, TRAIN_LR_F32, (MESH_C["dp"], MESH_C["sp"]), MESH_C["pp"])
    out["c"]["f32_update_err"] = update_error_of(p4_32, got32, want32)
    out["c"]["f32_loss_err"] = abs(float(loss32) - dloss32)
    del got32, want32, p4_32
    log(f"15c dp x tp x sp x pp on {MESH_C}, {MULTI_MICRO} microbatches: losses "
        f"{losses}, launches a step {per_step[0]}; float32 step vs dense autograd (x "
        f"n_pp): largest update difference {out['c']['f32_update_err']} (bound "
        f"{TRAIN_F32_TOL}), loss diff {out['c']['f32_loss_err']}; times "
        f"{out['c']['times']} {where}")
    if out["c"]["f32_update_err"] > TRAIN_F32_TOL:
        raise AssertionError("float32 4-axis step off the dense step")
    torch.cuda.empty_cache()

    # -- (d) halo exchange over two axes -----------------------------------
    cy, cx = MESH_D.values()
    grid = torch.from_numpy(rng.standard_normal((cy, cx, HALO_SIDE, HALO_SIDE),
                                                dtype=np.float32)).to(device)
    out["d"] = {"mesh": MESH_D, "rank_bytes": HALO_SIDE * HALO_SIDE * 4}
    for periodic in (True, False):
        kernel_counts().reset()
        got = par.halo_exchange(grid, axes=tuple(MESH_D), halo=1, periodic=periodic,
                                mesh=MESH_D)
        torch.cuda.synchronize()
        hops = kernel_counts()["permute_launches"]["collective_permute"]
        want = grid
        for dim in (0, 1):                    # rank dim of each axis
            sp_dim = 2 + dim                  # its spatial dim
            lo = want.narrow(sp_dim, 0, 1)
            hi = want.narrow(sp_dim, want.shape[sp_dim] - 1, 1)
            prev, nxt = hi.roll(1, dim), lo.roll(-1, dim)
            if not periodic:
                prev.select(dim, 0).zero_()
                nxt.select(dim, want.shape[dim] - 1).zero_()
            want = torch.cat([prev, want, nxt], dim=sp_dim)
        bitwise = same_bits(got, want)
        total["permute"] += hops
        out["d"]["periodic" if periodic else "open"] = {"permute_launches": hops,
                                                        "bitwise": bitwise}
        if hops != 4 or not bitwise or got.device.type != "cuda":
            raise AssertionError(f"two-axis halo exchange (periodic {periodic}): "
                                 f"{hops} permute launches, bitwise {bitwise}")
    del grid, got, want
    out["launches"] = total
    out["backward"] = backward_launch_times(xc, device)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"15d halo_exchange over {MESH_D} at 16 MiB a rank: {out['d']}; new backward "
        f"launches vs their forwards: {out['backward']} {where}")
    log(f"phase 15: launches on its paths {total}; in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 16. the multi-process tier: 4 rank processes on the one card
# ---------------------------------------------------------------------------

# The rank script the launcher runs (and the spawned children run): it only
# hands over to proc_rank_main below, in a fresh interpreter per rank.
PROC_SCRIPT = """import os, sys
sys.path.insert(0, {repo!r})
import chip_smoke
sys.exit(chip_smoke.proc_rank_main(sys.argv[1:]))
"""

# ProcChannel runners a forced Allreduce tier must be served by
PROC_RUNNER = {"ring": "_run_ring_allreduce",
               "rabenseifner": "_run_rabenseifner_allreduce",
               "rdouble": "_run_rdouble_allreduce", "star": "_run_star",
               "shm": "_run_shm"}


def _proc_device():
    import torch
    return torch.device("cuda", torch.cuda.current_device())


def _proc_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ring_fold(xs):
    """The JAX package's ring Allreduce bits (backend._run_ring_allreduce):
    segment i of n is folded in ring order from rank i, (x_i + x_{i+1}) +
    ... + x_{i-1}; not the rank-ordered fold's bits."""
    import torch
    n, total = len(xs), xs[0].numel()
    base, rem = divmod(total, n)
    out = torch.empty_like(xs[0])
    off = 0
    for i in range(n):
        size = base + (1 if i < rem else 0)
        acc = xs[i][off:off + size].clone()
        for k in range(1, n):
            acc += xs[(i + k) % n][off:off + size]
        out[off:off + size] = acc
        off += size
    return out


def _spawn_operands(n: int) -> list:
    rng = np.random.default_rng(SEED + 16)
    return [rng.standard_normal(n, dtype=np.float32) for _ in range(6)]


def _served_runners(B) -> list:
    """Record which ProcChannel runner serves each collective (appends the
    runner's name as it starts)."""
    served = []
    for name in set(PROC_RUNNER.values()):
        def wrap(fn, name=name):
            def run(self, *a, **k):
                served.append(name)
                return fn(self, *a, **k)
            return run
        setattr(B.ProcChannel, name, wrap(getattr(B.ProcChannel, name)))
    return served


def proc_rank_main(argv: list) -> int:
    """One rank process of phase 16 (argv: mode, outdir, elements): writes
    one JSON line to ``outdir`` and exits 0, or raises."""
    if os.environ.get("TPU_MPI_SPAWN_SPEC"):
        return _proc_child()
    mode, outdir, n = argv[0], argv[1], int(argv[2])
    if mode == "startup":
        return _proc_startup(outdir)
    return _proc_world(outdir, n)


def _proc_write(outdir: str, name: str, rec: dict) -> None:
    with open(os.path.join(outdir, f"{name}.json"), "w") as f:
        f.write(json.dumps(rec) + "\n")


def _proc_startup(outdir: str) -> int:
    import torch
    import tpu_mpi_torch as MPI
    t0 = time.perf_counter()
    MPI.Init()
    attach = time.perf_counter() - t0
    dev = _proc_device()
    torch.empty(1, device=dev)
    MPI.Barrier(MPI.COMM_WORLD)
    _proc_write(outdir, f"startup{MPI.Comm_rank(MPI.COMM_WORLD)}", {
        "attach_s": attach, "device": str(dev), "ready": time.time()})
    MPI.Finalize()
    return 0


def _proc_child() -> int:
    """A Comm_spawn'ed child: merge with the parents and Allreduce."""
    import torch
    import tpu_mpi_torch as MPI
    MPI.Init()
    outdir, n = MPI.spawn_argv()[1], int(MPI.spawn_argv()[2])
    dev = _proc_device()
    merged = MPI.Intercomm_merge(MPI.Comm_get_parent(), True)
    m = MPI.Comm_rank(merged)
    ops = [torch.from_numpy(a).to(dev) for a in _spawn_operands(n)]
    y = MPI.Allreduce(ops[m], MPI.SUM, merged)
    ok = y.device == dev and same_bits(y, _plain_sum(ops))
    _proc_write(outdir, f"child{m}", {"merged_rank": m, "device": str(dev),
                                      "bitwise": ok})
    MPI.free(merged)
    MPI.Finalize()
    if not ok:
        raise AssertionError(f"spawned child {m}: merged Allreduce differs")
    return 0


def _plain_sum(xs):
    """The rank-ordered left fold, the kernel's plain version."""
    from tpu_mpi_torch.kernels import fused_reduce as fr
    return fr.fused_multi_reduce_plain(xs, "SUM")


def _proc_world(outdir: str, n: int) -> int:
    import torch
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import backend as B, config
    from tpu_mpi_torch.kernels import fused_reduce as fr

    served = _served_runners(B)
    MPI.Init()
    comm = MPI.COMM_WORLD
    rank, size = MPI.Comm_rank(comm), MPI.Comm_size(comm)
    dev = _proc_device()
    xs = [torch.from_numpy(h).to(dev) for h in host_operands(n, size)]
    x = xs[rank]
    left, right = (rank - 1) % size, (rank + 1) % size
    want = {"left": fr.fused_multi_reduce_plain(xs, "SUM"),
            "ring": _ring_fold(xs)}
    rec = {"rank": rank, "device": str(dev), "tiers": {}, "checks": []}
    launches0 = kernel_counts()["fold_launches"]

    def set_algo(spec):
        if spec is None:
            os.environ.pop("TPU_MPI_COLL_ALGO", None)
        else:
            os.environ["TPU_MPI_COLL_ALGO"] = spec
        config.load(refresh=True)

    def check(got, expect, what):
        if not isinstance(got, torch.Tensor) or got.device != dev:
            raise AssertionError(f"rank {rank}: {what} is not a tensor on {dev}")
        if not same_bits(got, expect):
            raise AssertionError(f"rank {rank}: {what} differs from the "
                                 f"expected bits")
        rec["checks"].append(what)

    def timed(fn, iters):
        MPI.Barrier(comm)
        _proc_sync(dev)
        B.reset_staging()
        served.clear()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _proc_sync(dev)
        dt = time.perf_counter() - t0
        st, runners = dict(B.staging), sorted(set(served))
        MPI.Barrier(comm)
        return {"ms": dt / iters * 1e3,
                "d2h_ms": st["d2h_s"] / iters * 1e3,
                "h2d_ms": st["h2d_s"] / iters * 1e3,
                "d2h_copies": st["d2h"] / iters, "h2d_copies": st["h2d"] / iters,
                "d2h_mb": st["d2h_bytes"] / iters / 2**20,
                "h2d_mb": st["h2d_bytes"] / iters / 2**20,
                "runners": runners}

    # Allreduce SUM of the float32[n] operands on each forced tier, and of
    # an 8 KiB prefix on the shm tier
    for tier in PROC_TIERS + ("shm",):
        set_algo(f"allreduce={tier}")
        arg = x[:PROC_SHM_ELEMS] if tier == "shm" else x
        expect = want["ring" if tier == "ring" else "left"]
        if tier == "shm":
            expect = expect[:PROC_SHM_ELEMS]
        f0, c0 = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"]
        served.clear()
        check(MPI.Allreduce(arg, MPI.SUM, comm), expect, f"Allreduce {tier}")
        entry = {"launches": kernel_counts()["fold_launches"] - f0,
                 "chained": kernel_counts()["chained_folds"] - c0,
                 "served": list(served)}
        if served != [PROC_RUNNER[tier]]:
            raise AssertionError(f"rank {rank}: Allreduce {tier} served by "
                                 f"{served}")
        f0 = kernel_counts()["fold_launches"]
        iters = PROC_SMALL_ITERS if tier == "shm" else PROC_ITERS
        entry.update(timed(lambda: MPI.Allreduce(arg, MPI.SUM, comm), iters))
        entry["timed_launches"] = kernel_counts()["fold_launches"] - f0
        entry["iters"] = iters
        rec["tiers"][tier] = entry

    # 8-byte Allreduce on the tier the selection picks, and an 8-byte
    # Sendrecv round trip between ranks 0 and 1
    set_algo(None)
    small = x[:2].clone()
    rec["allreduce_8b"] = timed(lambda: MPI.Allreduce(small, MPI.SUM, comm),
                                PROC_SMALL_ITERS)
    rec["allreduce_8b"]["us"] = rec["allreduce_8b"]["ms"] * 1e3
    buf = torch.empty_like(small)
    peer = 1 - rank

    def round_trip():
        if rank == 0:
            MPI.Send(small, 1, 3, comm)
            MPI.Recv(buf, 1, 4, comm)
        elif rank == 1:
            MPI.Recv(buf, 0, 3, comm)
            MPI.Send(buf, 0, 4, comm)

    rec["sendrecv_8b"] = timed(round_trip, PROC_SMALL_ITERS)
    rec["sendrecv_8b"]["us_per_round_trip"] = rec["sendrecv_8b"]["ms"] * 1e3
    if rank < 2:
        check(buf, small if rank == 0 else xs[peer][:2], "8-byte round trip")

    # data movement of CUDA tensors
    check(MPI.Bcast(x.clone(), 1, comm), xs[1], "Bcast from rank 1")
    blk = min(PROC_RMA, n)
    check(MPI.Allgather(x[:blk], comm),
          torch.cat([xs[r][:blk] for r in range(size)]), "Allgather")
    seg = blk // size
    check(MPI.Alltoall(x[:blk], seg, comm),
          torch.cat([xs[s][rank * seg:(rank + 1) * seg] for s in range(size)]),
          "Alltoall")
    got = torch.empty_like(x)
    MPI.Sendrecv(x, right, 5, got, left, 5, comm)
    check(got, xs[left], "ring Sendrecv")
    rec["sendrecv_ring"] = timed(
        lambda: MPI.Sendrecv(x, right, 5, got, left, 5, comm), PROC_ITERS)

    # a fence epoch of Put, Get and Accumulate on windows over CUDA tensors
    f0 = kernel_counts()["fold_launches"]
    wf = torch.zeros(blk, dtype=torch.float32, device=dev)
    win = MPI.Win_create(wf, comm)
    MPI.Win_fence(0, win)
    MPI.Put(x[:blk], blk, right, 0, win)
    MPI.Win_fence(0, win)
    check(wf, xs[left][:blk], "Put into the right neighbour's window")
    back = torch.empty(blk, dtype=torch.float32, device=dev)
    MPI.Get(back, blk, right, 0, win)
    MPI.Win_fence(0, win)
    check(back, x[:blk], "Get from the right neighbour's window")
    win.free()
    ints = [(v[:blk] * 1000).to(torch.int32) for v in xs]
    wi = torch.zeros(blk, dtype=torch.int32, device=dev)
    win = MPI.Win_create(wi, comm)
    MPI.Win_fence(0, win)
    MPI.Accumulate(ints[rank], blk, 0, 0, MPI.SUM, win)
    MPI.Win_fence(0, win)
    if rank == 0:
        check(wi, sum(ints[1:], ints[0].clone()), "Accumulate SUM at rank 0")
    win.free()
    rec["rma_launches"] = kernel_counts()["fold_launches"] - f0

    # Comm_spawn of 2 children, Allreduce over the merged world at the star
    set_algo("allreduce=star")
    spawn_n = min(PROC_SPAWN, n)
    inter = MPI.Comm_spawn(os.path.join(outdir, "rank.py"),
                           ["child", outdir, str(spawn_n)], 2, comm)
    merged = MPI.Intercomm_merge(inter, False)
    m = MPI.Comm_rank(merged)
    ops = [torch.from_numpy(a).to(dev) for a in _spawn_operands(spawn_n)]
    f0 = kernel_counts()["fold_launches"]
    check(MPI.Allreduce(ops[m], MPI.SUM, merged), _plain_sum(ops),
          "merged-world Allreduce with 2 spawned children")
    rec["spawn"] = {"merged_size": MPI.Comm_size(merged),
                    "launches": kernel_counts()["fold_launches"] - f0}
    MPI.free(merged)
    MPI.free(inter)
    rec["fold_launches"] = kernel_counts()["fold_launches"] - launches0
    rec["chained"] = kernel_counts()["chained_folds"]
    _proc_write(outdir, f"rank{rank}", rec)
    MPI.Finalize()
    return 0


def _proc_launch(script: str, args: list, nprocs: int, timeout: float,
                 env: dict) -> tuple:
    cmd = [sys.executable, "-m", "tpu_mpi_torch.launcher", "-n", str(nprocs),
           "--procs", "--timeout", str(timeout)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd + [script] + args, capture_output=True, text=True,
                         timeout=timeout + 60, env=env,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"4-process world exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    return wall, res


def host_controls(n: int) -> dict:
    """What the host route's pieces cost in this one process, with no other
    rank process on the card or the cores: pageable copies of float32[n]
    and of 8 KiB off and onto the card, a host memcpy of float32[n] and a
    write of it into /dev/shm (the shm lane's spill), medians of 3."""
    import statistics
    import torch
    from tpu_mpi_torch import backend
    a = np.random.default_rng(SEED).standard_normal(n, dtype=np.float32)
    b = np.empty_like(a)
    out = {}

    def med(fn, reps=3):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    out["memcpy_gbps"] = a.nbytes / med(lambda: np.copyto(b, a)) / 1e9

    def spill():
        name = backend._shm_spill(memoryview(a))
        os.unlink(os.path.join(backend._SHM_DIR, name.decode()))
    out["shm_write_gbps"] = a.nbytes / med(spill) / 1e9
    dev = torch.device("cuda", 0)
    t = torch.from_numpy(a).to(dev)
    small = t[:2048].clone()
    host = torch.from_numpy(a)
    torch.cuda.synchronize()
    out["d2h_ms"] = med(lambda: t.cpu()) * 1e3
    out["h2d_ms"] = med(lambda: host.to(dev)) * 1e3
    out["d2h_8k_us"] = med(lambda: small.cpu(), 20) * 1e6
    out["h2d_8k_us"] = med(lambda: host[:2048].to(dev), 20) * 1e6
    del t, small
    return out


def proc_phase(n: int = N_MAIN, where: str = "") -> dict:
    """Phase 16: ``python -m tpu_mpi_torch.launcher -n 4 --procs`` on the
    card. Every rank's JSON line is read back; any failure, time out,
    disagreement or fold launch out of place raises."""
    import tempfile
    from tpu_mpi_torch import _native
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_MPI_")}
    # the star tier monolithic (its root folds the tensors with the kernel)
    # rather than chunk-pipelined (whose root folds host chunks)
    env["TPU_MPI_PIPELINE_MIN_BYTES"] = "0"
    out = {"nprocs": NRANKS, "elements": n}
    out["host_controls"] = host_controls(n)
    log(f"16 host route's pieces in one process, alone (medians of 3): "
        f"{out['host_controls']} {where}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procs_") as td:
        script = os.path.join(td, "rank.py")
        with open(script, "w") as f:
            f.write(PROC_SCRIPT.format(repo=repo))
        # startup of an empty 4-process world, native build first cold, then
        # cached (the library is rebuilt from the checkout's source)
        startup = {}
        for label in ("uncached", "cached"):
            if label == "uncached" and os.path.exists(_native._LIB):
                os.unlink(_native._LIB)
            wall, _ = _proc_launch(script, ["startup", td, "0"], NRANKS, 300,
                                   env)
            ranks = [json.load(open(os.path.join(td, f"startup{r}.json")))
                     for r in range(NRANKS)]
            startup[label] = {"wall_s": wall,
                              "attach_s": max(r["attach_s"] for r in ranks)}
        out["startup"] = startup
        log(f"16 startup of the 4-process world (launch to exit of an empty "
            f"Init/Barrier/Finalize): {startup} {where}")
        wall, res = _proc_launch(script, ["world", td, str(n)], NRANKS,
                                 PROC_TIMEOUT, env)
        ranks = [json.load(open(os.path.join(td, f"rank{r}.json")))
                 for r in range(NRANKS)]
        children = [json.load(open(os.path.join(td, f"child{m}.json")))
                    for m in (NRANKS, NRANKS + 1)]
    out["wall_s"] = wall
    devs = {r["device"] for r in ranks} | {c["device"] for c in children}
    if not all(d.startswith("cuda") for d in devs):
        raise AssertionError(f"rank processes ran on {devs}")
    if not all(c["bitwise"] for c in children):
        raise AssertionError("a spawned child's merged Allreduce differed")
    checks = {len(r["checks"]) for r in ranks}
    r0 = ranks[0]
    tiers = {}
    for tier in PROC_TIERS + ("shm",):
        e = r0["tiers"][tier]
        tiers[tier] = {k: e[k] for k in ("ms", "d2h_ms", "h2d_ms", "d2h_copies",
                                         "h2d_copies", "d2h_mb", "h2d_mb",
                                         "runners", "iters")}
        tiers[tier]["ms_by_rank"] = [r["tiers"][tier]["ms"] for r in ranks]
        tiers[tier]["fold_launches_by_rank"] = [
            r["tiers"][tier]["launches"] + r["tiers"][tier]["timed_launches"]
            for r in ranks]
    out["tiers"] = tiers
    # the fold kernel's launches, by rank: the star's root and every
    # rdouble rank fold each op's tensors, the host tiers launch nothing;
    # rank 0 folds the fence epoch's Accumulates and the merged world's
    # Allreduce
    ops = 1 + PROC_ITERS
    root = [1] + [0] * (NRANKS - 1)
    want = {tier: [0] * NRANKS for tier in tiers}
    want["star"] = [ops * r for r in root]
    want["rdouble"] = [ops] * NRANKS
    for tier, t in tiers.items():
        if t["fold_launches_by_rank"] != want[tier]:
            raise AssertionError(
                f"{tier} tier fold launches by rank "
                f"{t['fold_launches_by_rank']}, want {want[tier]}")
    launch_checks = {
        "rma": ([r["rma_launches"] for r in ranks], [NRANKS * r for r in root]),
        "spawn": ([r["spawn"]["launches"] for r in ranks], root),
        "total": ([r["fold_launches"] for r in ranks],
                  [sum(w[i] for w in want.values()) + (NRANKS + 1) * root[i]
                   for i in range(NRANKS)])}
    for what, (got, expect) in launch_checks.items():
        if got != expect:
            raise AssertionError(f"{what} fold launches by rank {got}, "
                                 f"want {expect}")
    chained = [r["chained"] for r in ranks]
    if any(chained):
        raise AssertionError(f"chained folds by rank {chained}")
    out["allreduce_8b_us"] = r0["allreduce_8b"]["us"]
    out["allreduce_8b_runners"] = r0["allreduce_8b"]["runners"]
    out["sendrecv_8b_us"] = r0["sendrecv_8b"]["us_per_round_trip"]
    out["sendrecv_ring_ms"] = r0["sendrecv_ring"]["ms"]
    out["sendrecv_ring_d2h_ms"] = r0["sendrecv_ring"]["d2h_ms"]
    out["sendrecv_ring_h2d_ms"] = r0["sendrecv_ring"]["h2d_ms"]
    out["rma_launches_by_rank"] = [r["rma_launches"] for r in ranks]
    out["spawn"] = {"merged_size": r0["spawn"]["merged_size"],
                    "root_launches": r0["spawn"]["launches"],
                    "children": len(children)}
    out["fold_launches_by_rank"] = [r["fold_launches"] for r in ranks]
    out["fold_launches"] = sum(out["fold_launches_by_rank"])
    out["checks_per_rank"] = sorted(checks)
    out["seconds"] = time.perf_counter() - t_phase
    for tier, t in tiers.items():
        log(f"16 Allreduce SUM {tier} float32["
            f"{PROC_SHM_ELEMS if tier == 'shm' else n}] x {NRANKS} processes: "
            f"{t['ms']:.4f} ms per op ({t['iters']} ops), of which rank 0's "
            f"D2H {t['d2h_ms']:.4f} ms ({t['d2h_copies']:.1f} copies, "
            f"{t['d2h_mb']:.1f} MiB) and H2D {t['h2d_ms']:.4f} ms "
            f"({t['h2d_copies']:.1f} copies); served by {t['runners']}; fold "
            f"launches by rank {t['fold_launches_by_rank']} {where}")
    log(f"16 8-byte Allreduce {out['allreduce_8b_us']:.2f} us "
        f"({out['allreduce_8b_runners']}), 8-byte Sendrecv round trip "
        f"{out['sendrecv_8b_us']:.2f} us, ring Sendrecv of float32[{n}] "
        f"{out['sendrecv_ring_ms']:.4f} ms (D2H {out['sendrecv_ring_d2h_ms']:.4f}"
        f", H2D {out['sendrecv_ring_h2d_ms']:.4f}) {where}")
    log(f"16 every result a tensor on {sorted(devs)} and bitwise as expected "
        f"({out['checks_per_rank']} checks a rank; Bcast, Allgather, Alltoall, "
        f"ring Sendrecv, a Put/Get/Accumulate fence epoch with fold launches "
        f"by rank {out['rma_launches_by_rank']}, Comm_spawn of 2 children "
        f"into a merged world of {out['spawn']['merged_size']}); fold "
        f"launches {out['fold_launches_by_rank']}, chained 0; phase 16 in "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 17. the serve tier on the card
# ---------------------------------------------------------------------------

SERVE_CLIENT = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import tpu_mpi_torch as MPI
MPI.Init(session={addr!r})
s = MPI.serve.current_session()
x = torch.linspace(-2.0, 3.0, 1024, device="cuda", dtype=torch.float32)
got = s.allreduce(x)
h = x.cpu().numpy()
want = ((h + h) + h) + h
MPI.Finalize()
print("SESSION", s.tenant, got.dtype, got.shape,
      got.tobytes() == want.tobytes(), flush=True)
"""


def _jain(xs) -> float:
    xs = [float(x) for x in xs]
    return sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs)) if any(xs) else 0.0


def _pctl(lat: list) -> dict:
    a = np.sort(np.asarray(lat)) * 1e3
    return {"p50_ms": float(a[len(a) // 2]),
            "p99_ms": float(a[min(len(a) - 1, int(len(a) * 0.99))]),
            "n": int(len(a))}


def _replicated_fold(x: np.ndarray, n: int = NRANKS) -> np.ndarray:
    out = x
    for _ in range(n - 1):
        out = out + x
    return out


def _frame(b) -> dict:
    return dict(b.stats()["serve_frame"])


def _frame_delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def serve_fleet(serve, b, tenants: int) -> dict:
    """serve_scale_sweep.py's fleet lane: ``tenants`` leases attached with
    the pipelined handshake, each running SERVE_OPS Allreduce SUM of its
    own float32[8] from SERVE_DRIVERS driver threads; every reply bitwise
    the rank-ordered fold."""
    import threading
    t0 = time.perf_counter()
    sessions = serve.attach_many(b.address, tenants, token=SERVE_TOKEN)
    attach_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 17)
    xs = rng.standard_normal((tenants, 8)).astype(np.float32)
    wants = [_replicated_fold(x).tobytes() for x in xs]
    lat, bad, errors = [], [], []
    lock = threading.Lock()

    def drive(k):
        mine = []
        try:
            for i in range(k, tenants, SERVE_DRIVERS):
                for _ in range(SERVE_OPS):
                    t1 = time.perf_counter()
                    got = sessions[i].allreduce(xs[i])
                    mine.append(time.perf_counter() - t1)
                    if got.tobytes() != wants[i]:
                        bad.append(i)
        except BaseException as e:       # noqa: BLE001 - reported below
            errors.append(repr(e))
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=drive, args=(k,), daemon=True)
               for k in range(SERVE_DRIVERS)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    op_s = time.perf_counter() - t1
    for s in sessions:                  # a mass hang-up, as the sweep does
        try:
            s._sock.close()
        except OSError:
            pass
        s._closed = True
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        with b._lease_lock:
            if not b._leases:
                break
        time.sleep(0.05)
    if errors or bad:
        raise AssertionError(f"fleet: {len(errors)} errors {errors[:3]}, "
                             f"{len(bad)} replies off the fold")
    if len(lat) != tenants * SERVE_OPS:
        raise AssertionError(f"fleet: {len(lat)} replies for "
                             f"{tenants * SERVE_OPS} ops")
    return {"tenants": tenants, "ops": len(lat), "drivers": SERVE_DRIVERS,
            "attach_s": attach_s, "attach_per_s": tenants / attach_s,
            "op_s": op_s, "ops_per_s": len(lat) / op_s,
            "op_latency": _pctl(lat)}


def serve_numpy_rules(serve, b) -> dict:
    """The parts of the serve card test through the broker, for every
    float dtype a tenant can send and every reduce: a NaN with a payload
    from rank 1, a negative NaN from rank 2, zeros of both signs against
    each other, inf - inf and 0 * inf, in a float[4099] part a rank. Each
    reply is held bit for bit to numpy's rank-ordered fold on this host,
    which is what the JAX broker replies."""
    import functools
    rng = np.random.default_rng(SEED + 17)
    ufuncs = {"sum": np.add, "prod": np.multiply, "min": np.minimum,
              "max": np.maximum}
    ops = 0
    with serve.attach(b.address, tenant="numpy-rules", token=SERVE_TOKEN) as s:
        for name in ("float16", "float32", "float64"):
            dt = np.dtype(name)
            u = np.dtype(dt.str.replace("f", "u"))
            nan1, nan2 = NUMPY_NAN_BITS[name][:2]
            parts = [rng.standard_normal(4099).astype(dt) for _ in range(NRANKS)]
            for i, p in enumerate(parts):
                p[1:3] = [-0.0, 0.0] if i % 2 == 0 else [0.0, -0.0]
                p[3] = (np.inf, -np.inf, 1.0, 1.0)[i]
                p[4] = (0.0, np.inf, 1.0, 1.0)[i]
            parts[1].view(u)[0] = nan1
            parts[2].view(u)[5] = nan2
            for red, uf in ufuncs.items():
                with np.errstate(all="ignore"):
                    want = functools.reduce(uf, parts)
                got = s.allreduce(parts, op=red)
                ops += 1
                if got.dtype != dt or got.tobytes() != want.tobytes():
                    bad = np.flatnonzero(got.view(u) != want.view(u))[:4]
                    raise AssertionError(
                        f"serve {red} {name}: reply differs from numpy's fold "
                        f"at {bad.tolist()}: {got.view(u)[bad].tolist()} vs "
                        f"{want.view(u)[bad].tolist()}")
    return {"ops": ops, "dtypes": ["float16", "float32", "float64"],
            "reduces": list(ufuncs), "size": 4099}


def serve_fairness(serve, b) -> dict:
    """SERVE_FAIR_TENANTS tenants hammer float32[64] Allreduces for
    SERVE_FAIR_S seconds; DRR should hand out near-equal counts."""
    import threading
    counts = [0] * SERVE_FAIR_TENANTS
    bad = []
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    want = _replicated_fold(x).tobytes()
    sessions = [serve.attach(b.address, tenant=f"fair{i}", token=SERVE_TOKEN)
                for i in range(SERVE_FAIR_TENANTS)]
    stop = time.perf_counter() + SERVE_FAIR_S

    def body(i):
        while time.perf_counter() < stop:
            if sessions[i].allreduce(x).tobytes() != want:
                bad.append(i)
            counts[i] += 1

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(SERVE_FAIR_TENANTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for s in sessions:
        s.detach()
    if bad:
        raise AssertionError(f"fairness: {len(bad)} replies off the fold")
    return {"tenants": SERVE_FAIR_TENANTS, "window_s": SERVE_FAIR_S,
            "ops_per_tenant": counts, "ops": sum(counts),
            "jain_index": _jain(counts)}


def serve_zero_copy(serve, b) -> dict:
    """The zero-copy frame lane: float32[4096] ops, copies per op read
    from the broker's serve_frame block (the sweep's gate: <= 1)."""
    x = np.arange(4096, dtype=np.float32) / 7
    want = _replicated_fold(x).tobytes()
    before = _frame(b)
    with serve.attach(b.address, tenant="zc", token=SERVE_TOKEN) as s:
        t0 = time.perf_counter()
        for _ in range(SERVE_ZC_REPS):
            if s.allreduce(x).tobytes() != want:
                raise AssertionError("zero-copy lane: reply off the fold")
        wall = time.perf_counter() - t0
    d = _frame_delta(_frame(b), before)
    cpo = d.get("copies", 0) / d["ops"] if d.get("ops") else 0.0
    if cpo > 1.0:
        raise AssertionError(f"zero-copy lane: {cpo} copies per op")
    return {"ops": SERVE_ZC_REPS, "copies_per_op": cpo,
            "frame_ops": d.get("ops", 0), "ops_per_s": SERVE_ZC_REPS / wall}


def serve_bulk(serve, b) -> tuple:
    """One tenant's four float32[2^24] parts (64 MiB a rank) SUM,
    SERVE_BULK_OPS times, each bitwise the fold; the ms per op with its
    host-to-device and device-to-host copies (the broker's serve_frame
    block). Returns the numbers and the parts (:func:`bulk_split` times
    the fold kernel on them once the phase's launches are counted)."""
    rng = np.random.default_rng(SEED + 171)
    parts = [rng.standard_normal(SERVE_BULK).astype(np.float32)
             for _ in range(NRANKS)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    before = _frame(b)
    walls = []
    with serve.attach(b.address, tenant="bulk", token=SERVE_TOKEN) as s:
        for _ in range(SERVE_BULK_OPS):
            t0 = time.perf_counter()
            got = s.allreduce(parts)
            walls.append((time.perf_counter() - t0) * 1e3)
            if got.tobytes() != want.tobytes():
                raise AssertionError("bulk op: reply off the fold")
    d = _frame_delta(_frame(b), before)
    ops = SERVE_BULK_OPS
    h2d_ms = d.get("h2d_ns", 0) / 1e6 / ops
    d2h_ms = d.get("d2h_ns", 0) / 1e6 / ops
    return {"ops": ops, "elements": SERVE_BULK,
            "op_ms": float(np.median(walls)), "op_ms_all": walls,
            "h2d_ms": h2d_ms, "h2d_copies": d.get("h2d", 0) / ops,
            "h2d_gbps": d.get("h2d_bytes", 0) / ops / (h2d_ms * 1e-3) / 1e9
            if h2d_ms else None,
            "d2h_ms": d2h_ms, "d2h_copies": d.get("d2h", 0) / ops}, parts


def bulk_split(bulk: dict, parts: list, fr, device) -> None:
    """The bulk op's fold kernel timed alone on its shapes (CUDA events),
    and the rest of the op: sockets, queueing and host work."""
    import torch
    xl = [torch.from_numpy(p).to(device) for p in parts]
    out = torch.empty_like(xl[0])
    bulk["fold_kernel_ms"] = time_ms(
        lambda: fr.fused_multi_reduce(xl, "SUM", out=out), iters=10)
    bulk["rest_ms"] = (bulk["op_ms"] - bulk["h2d_ms"] - bulk["fold_kernel_ms"]
                       - bulk["d2h_ms"])


def serve_latency(serve, device_kw: dict, ops: int = SERVE_LAT_OPS) -> dict:
    """One tenant's sequential float32[8] Allreduces on a fresh threads
    broker: p50/p99 ms per op."""
    b = serve.Broker(nranks=NRANKS, token=SERVE_TOKEN, transport="events",
                     **device_kw)
    b.run_in_thread()
    try:
        x = np.arange(8, dtype=np.float32)
        lat = []
        with serve.attach(b.address, tenant="lat", token=SERVE_TOKEN) as s:
            for _ in range(ops):
                t0 = time.perf_counter()
                s.allreduce(x)
                lat.append(time.perf_counter() - t0)
        return _pctl(lat[20:])
    finally:
        b.close()


def serve_staging_ab(serve, collective) -> dict:
    """The pool's staging (a buffer each rank keeps per (dtype, shape), so
    that a repeated op hands the collective the same tensor and the
    auto-arm lane arms) against a tensor made for every op: one tenant's
    sequential float32[8] and float32[4096] Allreduces on one threads
    broker, in blocks ordered kept, fresh, fresh, kept; p50/p99 ms per op
    and auto-armed hits for each, every reply bitwise."""
    import torch
    from tpu_mpi_torch.serve.broker import _Stager

    class Fresh(_Stager):
        def _buffer(self, rank, dtype, shape):
            return torch.empty(shape, dtype=dtype, device=self.device)

    b = serve.Broker(nranks=NRANKS, token=SERVE_TOKEN, transport="events",
                     device="cuda")
    b.run_in_thread()
    stagers = {"kept": b.pool.stager, "fresh": Fresh(b.pool.device)}
    out = {}
    try:
        with serve.attach(b.address, tenant="ab", token=SERVE_TOKEN) as s:
            for n in (8, 4096):
                x = (np.arange(n) % 7).astype(np.float32)
                want = _replicated_fold(x).tobytes()
                lat = {"kept": [], "fresh": []}
                hits = {"kept": 0, "fresh": 0}
                for mode in ("kept", "fresh", "fresh", "kept"):
                    b.pool.stager = stagers[mode]
                    for _ in range(SERVE_AB_WARM):
                        s.allreduce(x)
                    h0 = collective._plans.auto_hits
                    for _ in range(SERVE_AB_OPS):
                        t0 = time.perf_counter()
                        r = s.allreduce(x)
                        lat[mode].append(time.perf_counter() - t0)
                        if r.tobytes() != want:
                            raise AssertionError(f"staging A/B ({mode}): "
                                                 f"reply off the fold")
                    hits[mode] += collective._plans.auto_hits - h0
                out[f"float32[{n}]"] = {m: dict(_pctl(lat[m]),
                                                auto_armed_hits=hits[m])
                                        for m in lat}
    finally:
        b.pool.stager = stagers["kept"]
        b.close()
    return out


def serve_procs(serve, where: str) -> dict:
    """A procs broker: 4 pool processes on the card (a CUDA context each),
    float32[8] and float32[2^24] Allreduce bitwise, the fold-kernel
    launches each worker reports, and the broker's startup seconds."""
    t0 = time.perf_counter()
    b = serve.Broker(nranks=NRANKS, token=SERVE_TOKEN, backend="procs",
                     device="cuda")
    b.run_in_thread()
    startup_s = time.perf_counter() - t0
    try:
        pool = b.pool
        p = pool._await(pool._request(pool.healthy(), {"wop": "pvars"}),
                        60, "pvars")
        launches0 = {r: m["snapshot"]["kernels"]["fold_launches"]
                     for r, (m, _) in p.replies.items()}
        rng = np.random.default_rng(SEED + 172)
        small = rng.standard_normal(8).astype(np.float32)
        bulk = [rng.standard_normal(SERVE_BULK).astype(np.float32)
                for _ in range(NRANKS)]
        want_bulk = ((bulk[0] + bulk[1]) + bulk[2]) + bulk[3]
        lat, bulk_ms = [], []
        with serve.attach(b.address, tenant="procs", token=SERVE_TOKEN) as s:
            for _ in range(SERVE_PROCS_SMALL):
                t1 = time.perf_counter()
                if s.allreduce(small).tobytes() != \
                        _replicated_fold(small).tobytes():
                    raise AssertionError("procs pool: small reply off the fold")
                lat.append(time.perf_counter() - t1)
            for _ in range(SERVE_PROCS_BULK):
                t1 = time.perf_counter()
                if s.allreduce(bulk).tobytes() != want_bulk.tobytes():
                    raise AssertionError("procs pool: bulk reply off the fold")
                bulk_ms.append((time.perf_counter() - t1) * 1e3)
        p = pool._await(pool._request(pool.healthy(), {"wop": "pvars"}),
                        60, "pvars")
        launches = {r: m["snapshot"]["kernels"]["fold_launches"] - launches0[r]
                    for r, (m, _) in sorted(p.replies.items())}
    finally:
        b.close()
    ops = SERVE_PROCS_SMALL + SERVE_PROCS_BULK
    # the monolithic star: the root (pool rank 0) folds, once an op
    if launches.get(0) != ops or any(v for r, v in launches.items() if r):
        raise AssertionError(f"procs pool: fold launches by worker {launches} "
                             f"for {ops} ops")
    return {"startup_s": startup_s, "small_latency": _pctl(lat),
            "bulk_op_ms": bulk_ms, "fold_launches_by_worker": launches}


def serve_phase(MPI, collective, fr, device, where: str) -> dict:
    """Phase 17: the serve tier on the card. Raises on any reply off the
    rank-ordered fold, any op not folded by the kernel exactly once, or
    any fold that left the kernel."""
    import resource
    import tempfile
    from tpu_mpi_torch import config, perfvars, serve, stats
    from tpu_mpi_torch.serve.broker import _metrics_client
    t_phase = time.perf_counter()
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard == resource.RLIM_INFINITY:
        hard = 1 << 20
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    # a tenant holds two descriptors in this process: its session socket
    # and the broker's end of it
    by_fds = min(SERVE_TENANTS, (hard - 256) // 2)
    tenants = min(by_fds, SERVE_FLEET_CUT)
    out = {"nofile": [soft, hard], "tenants_asked": SERVE_TENANTS,
           "tenants_fds_allow": by_fds, "tenants": tenants}
    log(f"17 serve: RLIMIT_NOFILE {soft} -> {hard} allows {by_fds} tenants "
        f"(asked {SERVE_TENANTS}); fleet of {tenants}, cut for time "
        f"(SERVE_FLEET_CUT)")
    t0 = time.perf_counter()
    b = serve.Broker(nranks=NRANKS, token=SERVE_TOKEN, transport="events",
                     max_tenants=tenants + 64, device="cuda")
    b.run_in_thread()
    out["startup_s"] = time.perf_counter() - t0
    try:
        auto0 = collective._plans.auto_hits
        kernel_counts().reset()
        launches = {}
        out["fleet"] = serve_fleet(serve, b, tenants)
        launches["fleet"] = kernel_counts()["fold_launches"]
        out["fairness"] = serve_fairness(serve, b)
        launches["fairness"] = kernel_counts()["fold_launches"] - sum(launches.values())
        out["numpy_rules"] = serve_numpy_rules(serve, b)
        launches["numpy_rules"] = kernel_counts()["fold_launches"] - sum(launches.values())
        # pvars on for the zero-copy lane: the dumps `stats` renders below
        os.environ["TPU_MPI_PVARS"] = "1"
        config.load(refresh=True)
        try:
            out["zero_copy"] = serve_zero_copy(serve, b)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_stats_") as td:
                perfvars.dump(os.path.join(td, "pvars-rank0.json"), rank=0)
                cli = subprocess.run(
                    [sys.executable, "-m", "tpu_mpi_torch.stats", td],
                    capture_output=True, text=True, timeout=120,
                    cwd=os.path.dirname(os.path.abspath(__file__)))
        finally:
            os.environ.pop("TPU_MPI_PVARS", None)
            config.load(refresh=True)
        launches["zero_copy"] = kernel_counts()["fold_launches"] - sum(launches.values())
        if cli.returncode != 0 or "allreduce" not in cli.stdout:
            raise AssertionError(f"stats CLI on the phase's dumps: "
                                 f"{cli.returncode} {cli.stderr[-400:]}")
        out["bulk"], parts = serve_bulk(serve, b)
        launches["bulk"] = kernel_counts()["fold_launches"] - sum(launches.values())
        chained = kernel_counts()["chained_folds"]
        auto_hits = collective._plans.auto_hits - auto0
        parsed = stats.parse_prometheus(_metrics_client(b.address,
                                                        SERVE_TOKEN))
        if parsed.get("tpu_mpi_pool_nranks") != NRANKS:
            raise AssertionError("METRICS: no pool_nranks gauge")
        out["metrics_series"] = len(parsed)
        # (c) a separate client process attaches through Init(session=)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, TPU_MPI_SESSION_TOKEN=SERVE_TOKEN,
                   PYTHONPATH=repo)
        t0 = time.perf_counter()
        client = subprocess.run(
            [sys.executable, "-c", SERVE_CLIENT.format(repo=repo,
                                                       addr=b.address)],
            capture_output=True, text=True, timeout=300, env=env, cwd=repo)
        out["client_s"] = time.perf_counter() - t0
        if client.returncode != 0 or "True" not in client.stdout:
            raise AssertionError(f"session client: {client.returncode} "
                                 f"{client.stdout[-300:]} {client.stderr[-600:]}")
        out["client"] = client.stdout.strip()
        out["serve_frame"] = _frame(b)
    finally:
        b.close()
    ops = {"fleet": out["fleet"]["ops"], "fairness": out["fairness"]["ops"],
           "numpy_rules": out["numpy_rules"]["ops"],
           "zero_copy": SERVE_ZC_REPS, "bulk": SERVE_BULK_OPS}
    out["ops"] = ops
    out["fold_launches"] = launches
    out["auto_armed_hits"] = auto_hits
    out["chained_folds"] = chained
    if launches != ops or chained:
        raise AssertionError(f"serve: fold launches {launches} for ops {ops}, "
                             f"chained {chained}")
    bulk_split(out["bulk"], parts, fr, device)
    del parts
    out["latency_8"] = {"cuda": serve_latency(serve, {"device": "cuda"}),
                        "cpu": serve_latency(serve, {"device": "cpu"})}
    out["staging_ab"] = serve_staging_ab(serve, collective)
    out["procs"] = serve_procs(serve, where)
    out["seconds"] = time.perf_counter() - t_phase
    f, fa, z, bk = out["fleet"], out["fairness"], out["zero_copy"], out["bulk"]
    log(f"17a fleet: {f['tenants']} tenants attached at "
        f"{f['attach_per_s']:.1f}/s, {f['ops']} Allreduce float32[8] at "
        f"{f['ops_per_s']:.1f} ops/s, latency p50 {f['op_latency']['p50_ms']:.4f}"
        f" p99 {f['op_latency']['p99_ms']:.4f} ms, every reply bitwise {where}")
    log(f"17a fairness: {fa['tenants']} tenants x float32[64], {fa['ops']} ops "
        f"in {fa['window_s']} s, Jain {fa['jain_index']:.4f}; zero-copy "
        f"float32[4096]: {z['copies_per_op']:.3f} copies/op, "
        f"{z['ops_per_s']:.1f} ops/s {where}")
    log(f"17a bulk 4 x float32[2^24] SUM: {bk['op_ms']:.2f} ms/op = H2D "
        f"{bk['h2d_ms']:.2f} ({bk['h2d_copies']:.0f} copies) + fold kernel "
        f"{bk['fold_kernel_ms']:.4f} + D2H {bk['d2h_ms']:.2f} + rest "
        f"{bk['rest_ms']:.2f} {where}")
    lc, lh = out["latency_8"]["cuda"], out["latency_8"]["cpu"]
    log(f"17a float32[8] op, one tenant: device=cuda p50 {lc['p50_ms']:.4f} "
        f"p99 {lc['p99_ms']:.4f} ms; device=cpu p50 {lh['p50_ms']:.4f} p99 "
        f"{lh['p99_ms']:.4f} ms {where}")
    log(f"17a numpy rules: {out['numpy_rules']['ops']} Allreduce of NaN "
        f"payloads, signed zeros, inf - inf and 0 * inf over float16/32/64, "
        f"every reply bit for bit numpy's fold {where}")
    log(f"17 fold launches {launches} for ops {ops} (auto-armed hits "
        f"{auto_hits}), chained {chained}; stats CLI and METRICS "
        f"({out['metrics_series']} series) parse; client {out['client']!r}")
    for shape, ab in out["staging_ab"].items():
        log(f"17a staging {shape}: kept buffers p50 "
            f"{ab['kept']['p50_ms']:.4f} p99 {ab['kept']['p99_ms']:.4f} ms "
            f"({ab['kept']['auto_armed_hits']} auto-armed hits); a tensor an "
            f"op p50 {ab['fresh']['p50_ms']:.4f} p99 "
            f"{ab['fresh']['p99_ms']:.4f} ms ({ab['fresh']['auto_armed_hits']}"
            f" auto-armed hits) {where}")
    pr = out["procs"]
    log(f"17b procs broker: startup {pr['startup_s']:.1f} s, float32[8] p50 "
        f"{pr['small_latency']['p50_ms']:.4f} ms, float32[2^24] "
        f"{pr['bulk_op_ms']} ms, fold launches by worker "
        f"{pr['fold_launches_by_worker']} {where}")
    log(f"phase 17 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 18. inference at the flagship width; 19. an elastic resize under load
# ---------------------------------------------------------------------------

def _infer_prompt(mode: str, i: int) -> list:
    """benchmarks/infer_sweep.py's prompts: the sharing lane serves a
    common system prompt, the others disjoint prompts."""
    if INFER_MODES[mode]["prefix_share"]:
        return INFER_SYS_PROMPT + [(7 * i + j) % 64 for j in range(4)]
    return [(7 * i + j) % 64 for j in range(INFER_PROMPT)]


def _infer_broker(serve, cfg, mode: str, device: str, **kw):
    from tpu_mpi_torch import config
    os.environ["TPU_MPI_INFER_SLO_MS"] = str(INFER_SLO_MS)
    config.load(refresh=True)
    try:
        b = serve.Broker(nranks=NRANKS, token=SERVE_TOKEN, device=device,
                         max_tenants=INFER_MAX_CLIENTS + 16,
                         infer={"cfg": cfg, "seed": SEED,
                                **INFER_MODES[mode]}, **kw)
        b.run_in_thread()
    finally:
        os.environ.pop("TPU_MPI_INFER_SLO_MS", None)
        config.load(refresh=True)
    return b


def _generate(serve, b, prompt: list, max_new: int, tenant: str,
              on_token=None) -> list:
    with serve.attach(b.address, tenant=tenant, token=SERVE_TOKEN) as s:
        return s.generate(prompt, max_new=max_new, on_token=on_token)


def infer_point(serve, b, mode: str, rps: float, streams: dict) -> dict:
    """One open-loop load point (infer_sweep.py's run_point): a thread an
    arrival, its own lease, ``INFER_NEW`` greedy tokens asked. Every
    completed stream is filed under its prompt in ``streams``."""
    from tpu_mpi_torch.error import SLOExpiredError
    import threading
    n = max(1, int(round(rps * INFER_DURATION)))
    gate = threading.Semaphore(INFER_MAX_CLIENTS)
    lock = threading.Lock()
    lat, tps, evicted, errors = [], [], [0], []
    before = dict(b.stats()["infer"])
    t_start = time.perf_counter()

    def worker(i: int) -> None:
        delay = i / rps - (time.perf_counter() - t_start)
        if delay > 0:
            time.sleep(delay)
        prompt = _infer_prompt(mode, i)
        with gate:
            try:
                t0 = time.perf_counter()
                toks = _generate(serve, b, prompt, INFER_NEW, f"lp{rps}x{i}")
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
                    tps.append(len(toks) / dt)
                    streams.setdefault(tuple(prompt), set()).add(tuple(toks))
            except SLOExpiredError:
                with lock:
                    evicted[0] += 1
            except Exception as e:          # noqa: BLE001 - counted, raised below
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t_start
    if errors:
        raise AssertionError(f"18 {mode} at {rps} req/s: {len(errors)} "
                             f"generations failed untyped: {errors[:3]}")
    after = dict(b.stats()["infer"])
    d = {k: after[k] - before[k] for k in ("slo_hits", "slo_misses",
                                           "slo_evictions", "tokens")}
    rounds = after["decode"]["moe_rounds"] - before["decode"]["moe_rounds"]
    hit = after["kv"]["prefix_hit_tokens"] - before["kv"]["prefix_hit_tokens"]
    miss = (after["kv"]["prefix_miss_tokens"]
            - before["kv"]["prefix_miss_tokens"])
    return {"offered_load_rps": rps, "requests": n, "completed": len(lat),
            "evicted": evicted[0], "wall_s": wall,
            "latency": _pctl(lat) if lat else None,
            "p50_tokens_per_s": float(np.median(tps)) if tps else None,
            "p99_tokens_per_s": (float(np.sort(tps)[min(len(tps) - 1,
                                                         int(0.99 * len(tps)))])
                                 if tps else None),
            "delivered_tokens_per_s": len(lat) * INFER_NEW / wall,
            "rounds_per_token": rounds / d["tokens"] if d["tokens"] else None,
            "kv_prefix_hit_rate": hit / (hit + miss) if hit + miss else None,
            "broker_slo": d}


def _drain(b) -> None:
    deadline = time.time() + 120
    while time.time() < deadline:
        inf = b.stats()["infer"]
        if not inf["pending"] and not inf["active"]:
            return
        time.sleep(0.05)
    raise AssertionError("18: the engine did not drain in 120 s")


def infer_check_set(serve, b, prompts: list, stagger: float,
                    retries: list) -> list:
    """``prompts`` generated together (stagger 0) or one after another
    ``stagger`` s apart, each on its own lease: their streams in order.

    A request the engine evicts at its SLO deadline (the typed, retriable
    ``SLOExpiredError``: it was never scheduled, so it produced no token)
    is asked again on its lease, as the engine's clients are told to, up
    to ``INFER_CHECK_RETRIES`` times; each retry is appended to
    ``retries``. Any other error, or a request evicted past its retries,
    fails the phase."""
    import threading
    from tpu_mpi_torch.error import SLOExpiredError
    outs, errs = [None] * len(prompts), []

    def worker(i):
        try:
            time.sleep(stagger * i)
            with serve.attach(b.address, tenant=f"chk{i}",
                              token=SERVE_TOKEN) as s:
                for attempt in range(INFER_CHECK_RETRIES + 1):
                    try:
                        outs[i] = s.generate(prompts[i], max_new=INFER_NEW)
                        break
                    except SLOExpiredError:
                        if attempt == INFER_CHECK_RETRIES:
                            raise
                        retries.append(i)
                        time.sleep(0.1)
        except Exception as e:              # noqa: BLE001 - raised below
            errs.append(repr(e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    if errs:
        raise AssertionError(f"18 check set: {errs[:3]}")
    return outs


def tenant_interleave(serve, b, stop_after: int,
                      card: bool = True) -> dict:
    """One tenant's ``stop_after`` Allreduce SUM of four float32[4096]
    parts on the engine's pool while it generates: every reply bitwise the
    rank-ordered fold, and exactly one fold launch an op (the engine
    itself launches no fold)."""
    rng = np.random.default_rng(SEED + 18)
    parts = [rng.standard_normal(4096).astype(np.float32) for _ in range(NRANKS)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    lat = []
    with serve.attach(b.address, tenant="folds", token=SERVE_TOKEN) as s:
        f0, c0 = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"]
        for _ in range(stop_after):
            t0 = time.perf_counter()
            got = s.allreduce(parts)
            lat.append(time.perf_counter() - t0)
            if got.tobytes() != want.tobytes():
                raise AssertionError("18: a tenant reply off the rank-ordered "
                                     "fold while the engine ran")
        k = kernel_counts().snapshot()
        launches, chained = k["fold_launches"] - f0, k["chained_folds"] - c0
    if launches != (stop_after if card else 0) or chained:
        raise AssertionError(f"18: {launches} fold launches (chained {chained}) "
                             f"for {stop_after} tenant ops beside the engine")
    return {"ops": stop_after, "fold_launches": launches,
            "latency": _pctl(lat)}


def _trace_counts(events) -> dict:
    launches = sum(1 for e in events if e.get("ph") == "X"
                   and e.get("name") in ("cudaLaunchKernel",
                                         "cudaLaunchKernelExC",
                                         "cuLaunchKernel"))
    d2h = sum(1 for e in events if e.get("ph") == "X"
              and e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""))
    kernels = sum(1 for e in events if e.get("ph") == "X"
                  and e.get("cat") == "kernel")
    return {"launches": launches, "d2h_copies": d2h, "kernels": kernels,
            "busy_us": busy_union_us(events)}


def decode_step_profile(serve, b, logdir: str, card: bool = True) -> dict:
    """One request of a prompt profiled twice under ``torch.profiler``:
    with one new token (prefill only) and with 1 + INFER_PROFILE_DECODES
    (the same prefill and that many decode steps). The difference over the
    decode steps is one decode step's CUDA launches, device busy time and
    window; device-to-host copies are counted a token."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prompt = _infer_prompt("row_loop", 5)
    runs = {}
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    for new in (1, 1 + INFER_PROFILE_DECODES):
        _generate(serve, b, prompt, new, f"prof-warm{new}")
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _generate(serve, b, prompt, new, f"prof{new}")
            sync()
            window_us = (time.perf_counter() - t0) * 1e6
        os.makedirs(logdir, exist_ok=True)
        trace = os.path.join(logdir, f"infer_decode_{new}.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
        runs[new] = {**_trace_counts(events), "window_us": window_us,
                     "tokens": new}
    a, z = runs[1], runs[1 + INFER_PROFILE_DECODES]
    k = INFER_PROFILE_DECODES
    step = {key: (z[key] - a[key]) / k
            for key in ("launches", "kernels", "busy_us", "window_us",
                        "d2h_copies")}
    step["busy_share"] = (step["busy_us"] / step["window_us"]
                          if step["window_us"] > 0 else None)
    return {"decode_step": step, "prefill_only": a, "with_decodes": z,
            "d2h_per_token": z["d2h_copies"] / z["tokens"]}


def infer_card_vs_cpu(serve, b, cfg, mode: str) -> dict:
    """INFER_COMPARE prompts through the card engine ``b`` and through a
    ``device="cpu"`` engine with the same seed (the same weights: both draw
    them from a seeded CPU generator): streams equal, and every sampled
    row's final-row logits within INFER_LOGIT_TOL."""
    prompts = [_infer_prompt("row_loop", i) for i in range(INFER_COMPARE)]
    eng = b.infer_engine
    eng.logit_log = {}
    try:
        card = [_generate(serve, b, p, INFER_NEW, f"cmp{i}")
                for i, p in enumerate(prompts)]
        card_log = dict(eng.logit_log)
    finally:
        eng.logit_log = None
    t0 = time.perf_counter()
    cpu_b = _infer_broker(serve, cfg, mode, "cpu")
    try:
        cpu_b.infer_engine.logit_log = {}
        host = [_generate(serve, cpu_b, p, INFER_NEW, f"cmp{i}")
                for i, p in enumerate(prompts)]
        host_log = dict(cpu_b.infer_engine.logit_log)
    finally:
        cpu_b.close()
    cpu_s = time.perf_counter() - t0
    if card != host:
        raise AssertionError(f"18: card streams {card} != CPU engine {host}")
    a = np.stack([r for rid in sorted(card_log) for r in card_log[rid]])
    w = np.stack([r for rid in sorted(host_log) for r in host_log[rid]])
    if a.shape != w.shape:
        raise AssertionError(f"18: {a.shape} card logit rows, {w.shape} CPU")
    err = float(np.abs(a - w).max())
    top2 = np.sort(w, axis=1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    if not err <= INFER_LOGIT_TOL:
        raise AssertionError(f"18: card logits off the CPU engine's by {err} "
                             f"> {INFER_LOGIT_TOL}")
    return {"prompts": len(prompts), "rows": int(a.shape[0]),
            "max_abs_logit_err": err, "tolerance": INFER_LOGIT_TOL,
            "min_top1_top2_margin": margin, "streams": card,
            "cpu_engine_s": cpu_s}


def infer_phase(device, logdir: str, where: str) -> dict:
    """Phase 18: the inference engine at the flagship's width on the card,
    driven by infer_sweep.py's traffic in its two lanes, with the checks
    the module docstring lists. Raises on any of them."""
    import threading
    import torch
    from tpu_mpi_torch import serve
    from tpu_mpi_torch.models import transformer as tr
    t_phase = time.perf_counter()
    cfg = tr.TransformerConfig(**FLAGSHIP, max_seq=INFER_MAX_SEQ,
                               dtype=torch.float32)
    check_prompts = ([_infer_prompt("row_loop", i) for i in range(3)]
                     + [_infer_prompt("prefix_share", i) for i in range(3)])
    out = {"lanes": {}, "loads": list(INFER_LOADS), "slo_ms": INFER_SLO_MS,
           "cfg": {**FLAGSHIP, "max_seq": INFER_MAX_SEQ, "dtype": "float32"}}
    checks = {}
    kernel_counts().reset()
    folds = 0
    card = device.type == "cuda"
    for mode in INFER_MODES:
        if card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = _infer_broker(serve, cfg, mode, device.type)
        startup = time.perf_counter() - t0
        lane = {"engine": INFER_MODES[mode], "startup_s": startup}
        try:
            eng = b.infer_engine
            for st in eng._state.values():
                if any(t.device.type != device.type
                       for t in st["sp"].values()) \
                        or st["kv"].k.device.type != device.type:
                    raise AssertionError("18: an engine tensor is off the card")
            lane["bytes_per_rank"] = eng.memory_bytes()
            _generate(serve, b, _infer_prompt(mode, 0), 2, "warm")
            streams: dict = {}
            points = []
            for rps in INFER_LOADS:
                if mode == "row_loop" and rps == INFER_LOADS[1]:
                    box = {}
                    th = threading.Thread(target=lambda: box.update(
                        tenant_interleave(serve, b, INFER_TENANT_OPS, card)))
                    th.start()
                    points.append(infer_point(serve, b, mode, rps, streams))
                    th.join(timeout=300)
                    if "ops" not in box:
                        raise AssertionError("18: the interleaved tenant failed")
                    lane["tenant_interleave"] = box
                    folds += box["fold_launches"]
                else:
                    points.append(infer_point(serve, b, mode, rps, streams))
                _drain(b)
            split = {p: s for p, s in streams.items() if len(s) != 1}
            if split:
                raise AssertionError(f"18 {mode}: one prompt, several streams: "
                                     f"{list(split.items())[:2]}")
            lane["points"] = points
            lane["distinct_prompts"] = len(streams)
            retries: list = []
            batched = infer_check_set(serve, b, check_prompts, 0.0, retries)
            staggered = infer_check_set(serve, b, check_prompts, 0.05,
                                        retries)
            lane["check_slo_retries"] = len(retries)
            if batched != staggered:
                raise AssertionError(f"18 {mode}: batched {batched} != "
                                     f"staggered {staggered}")
            checks[mode] = batched
            if mode == "row_loop":
                lane["profile"] = decode_step_profile(serve, b, logdir, card)
                lane["card_vs_cpu"] = infer_card_vs_cpu(serve, b, cfg, mode)
            lane["stats"] = b.stats()["infer"]
            lane["peak_allocated_bytes"] = (torch.cuda.max_memory_allocated()
                                            if card else None)
        finally:
            b.close()
        out["lanes"][mode] = lane
    if checks["row_loop"] != checks["prefix_share"]:
        raise AssertionError(f"18: lanes differ: {checks}")
    if kernel_counts()["chained_folds"]:
        raise AssertionError("18: a fold left the kernel")
    out["check_streams"] = checks["row_loop"]
    out["fold_launches"] = kernel_counts()["fold_launches"]
    if out["fold_launches"] < folds:
        raise AssertionError(f"18: {out['fold_launches']} fold launches for {folds} ops")
    out["seconds"] = time.perf_counter() - t_phase
    for mode, lane in out["lanes"].items():
        for p in lane["points"]:
            lt = p["latency"] or {}
            log(f"18 {mode} {p['offered_load_rps']:g} req/s: {p['completed']}/"
                f"{p['requests']} done, {p['evicted']} SLO-evicted, latency p50 "
                f"{lt.get('p50_ms')} p99 {lt.get('p99_ms')} ms, per-request "
                f"tokens/s p50 {p['p50_tokens_per_s']} p99 "
                f"{p['p99_tokens_per_s']}, aggregate "
                f"{p['delivered_tokens_per_s']:.3f} tokens/s, MoE rounds a token "
                f"{p['rounds_per_token']}, KV prefix hit rate "
                f"{p['kv_prefix_hit_rate']} {where}")
        mem = lane["bytes_per_rank"]
        log(f"18 {mode}: startup {lane['startup_s']:.2f} s; bytes a rank "
            f"weights {sorted({m['weights'] for m in mem.values()})} KV "
            f"{sorted({m['kv'] for m in mem.values()})}; peak allocated "
            f"{lane['peak_allocated_bytes']} {where}")
    pr = out["lanes"]["row_loop"]["profile"]
    st = pr["decode_step"]
    log(f"18 one decode step (row_loop, profiler): {st['launches']:.1f} CUDA "
        f"launches, {st['kernels']:.1f} kernels, device busy "
        f"{st['busy_us'] / 1e3:.4f} ms of {st['window_us'] / 1e3:.4f} ms "
        f"(busy share {st['busy_share']}), {st['d2h_copies']:.1f} D2H copies; "
        f"{pr['d2h_per_token']:.2f} D2H copies a token over a request {where}")
    cv = out["lanes"]["row_loop"]["card_vs_cpu"]
    log(f"18 card vs CPU engine, {cv['prompts']} prompts: streams equal, "
        f"{cv['rows']} logit rows, max |err| {cv['max_abs_logit_err']:.3g} <= "
        f"{cv['tolerance']}, smallest top-1/top-2 margin "
        f"{cv['min_top1_top2_margin']:.4g} {where}")
    ti = out["lanes"]["row_loop"]["tenant_interleave"]
    log(f"18 tenant beside the engine: {ti['ops']} Allreduce float32[4096], "
        f"each bitwise, {ti['fold_launches']} fold launches, latency p50 "
        f"{ti['latency']['p50_ms']:.4f} p99 {ti['latency']['p99_ms']:.4f} ms; "
        f"check set streams equal across lanes and batching (SLO retries "
        f"{ {m: ln['check_slo_retries'] for m, ln in out['lanes'].items()} }); "
        f"phase 18 in {out['seconds']:.1f} s")
    return out


def elastic_phase(device, where: str) -> dict:
    """Phase 19: elastic_sweep.py's traffic on a ``device="cuda"`` broker
    with the engine live; the failure verdict for the highest rank lands
    mid-run, at an engine step boundary, while a generation streams."""
    import threading
    import torch
    from tpu_mpi_torch import config, serve
    from tpu_mpi_torch.error import PoolDegradedError, ServeBusyError
    from tpu_mpi_torch.models import transformer as tr
    t_phase = time.perf_counter()
    cfg = tr.TransformerConfig(**FLAGSHIP, max_seq=INFER_MAX_SEQ,
                               dtype=torch.float32)
    env = {"TPU_MPI_ELASTIC_INTERVAL_MS": "50", "TPU_MPI_ELASTIC_COOLDOWN_MS": "0"}
    os.environ.update(env)
    config.load(refresh=True)
    try:
        b = serve.Broker(nranks=NRANKS, token=SERVE_TOKEN, device=device.type,
                         max_tenants=ELASTIC_MAX_CLIENTS + 16, elastic=True,
                         infer={"cfg": cfg, "seed": SEED})
        b.run_in_thread()
    finally:
        for k in env:
            os.environ.pop(k, None)
        config.load(refresh=True)
    kill = NRANKS - 1
    prompt = _infer_prompt("row_loop", 11)
    try:
        before_stream = _generate(serve, b, prompt, ELASTIC_GEN_NEW, "undisturbed")
        n = int(round(ELASTIC_RPS * ELASTIC_DURATION))
        part = np.arange(ELASTIC_NBYTES // 8, dtype=np.float64)
        gate = threading.Semaphore(ELASTIC_MAX_CLIENTS)
        lock = threading.Lock()
        attach_ms, spans, retriable, dropped, bad = [], [], [0], [0], []
        window = {}
        gen_out, streamed, started = {}, [], threading.Event()

        def on_token(t):
            streamed.append(t)
            if len(streamed) >= 4:
                started.set()

        def spanning():
            try:
                gen_out["toks"] = _generate(serve, b, prompt, ELASTIC_GEN_NEW,
                                            "spanning", on_token=on_token)
            except Exception as e:          # noqa: BLE001 - raised below
                gen_out["err"] = repr(e)

        def worker(i):
            delay = i / ELASTIC_RPS - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            with gate:
                try:
                    ta = time.perf_counter()
                    s = serve.attach(b.address, tenant=f"el{i}",
                                     token=SERVE_TOKEN)
                    with lock:
                        attach_ms.append(time.perf_counter() - ta)
                except Exception:           # noqa: BLE001 - a drop
                    with lock:
                        dropped[0] += 1
                    return
                try:
                    want = _replicated_fold(part, len(s.ranks)).tobytes()
                    done, deadline = 0, time.perf_counter() + 60
                    while done < ELASTIC_OPS and time.perf_counter() < deadline:
                        ts = time.perf_counter()
                        try:
                            got = s.allreduce(part)
                            if got.tobytes() != want:
                                with lock:
                                    bad.append(i)
                            with lock:
                                spans.append((ts, time.perf_counter()))
                            done += 1
                        except (PoolDegradedError, ServeBusyError):
                            with lock:
                                retriable[0] += 1
                            time.sleep(0.05)
                        time.sleep(ELASTIC_OP_INTERVAL)
                    if done < ELASTIC_OPS:
                        with lock:
                            dropped[0] += 1
                except Exception:           # noqa: BLE001 - a drop
                    with lock:
                        dropped[0] += 1
                finally:
                    s.detach()

        def chaos():
            time.sleep(ELASTIC_DURATION / 3.0)
            gen_th.start()
            started.wait(120)
            # the verdict lands at an engine step boundary: a verdict during
            # a step fails that step's collectives, and the engine with them
            if not b._infer_sched.pause(timeout=30):
                window["unparked"] = True
            window["streamed_at_verdict"] = len(streamed)
            window["start"] = time.perf_counter()
            b.on_rank_failure(kill)
            deadline = time.time() + 120
            while time.time() < deadline:
                if (b.elastic_state["resizes"] >= 1
                        and not (b.pool.failed - b.pool.retired)):
                    break
                time.sleep(0.01)
            window["end"] = time.perf_counter()

        f0 = kernel_counts()["fold_launches"]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        gen_th = threading.Thread(target=spanning)
        killer = threading.Thread(target=chaos)
        for t in threads:
            t.start()
        killer.start()
        for t in threads:
            t.join(timeout=300)
        killer.join(timeout=300)
        gen_th.join(timeout=300)
        folds = kernel_counts()["fold_launches"] - f0
        after_stream = _generate(serve, b, prompt, ELASTIC_GEN_NEW, "after")
        resize = dict(b.elastic_state.get("last_resize") or {})
        state = {k: b.elastic_state[k] for k in ("resizes", "rebinds",
                                                 "failures")}
        engine_ranks = list(b.infer_engine.ranks)
    finally:
        b.close()
    if bad or dropped[0]:
        raise AssertionError(f"19: {dropped[0]} tenants dropped, replies off "
                             f"the fold for tenants {bad[:5]}")
    if "toks" not in gen_out:
        raise AssertionError(f"19: the spanning generation failed: {gen_out}")
    if not (gen_out["toks"] == before_stream == after_stream == streamed):
        raise AssertionError("19: the generation spanning the resize streamed "
                             "other tokens than an undisturbed one")
    if state["resizes"] < 1 or kill in engine_ranks or resize.get("grew", 0) < 1:
        raise AssertionError(f"19: no restore resize: {state} {resize} "
                             f"{engine_ranks}")
    if (window.get("unparked") or not window.get("end") or not spans
            or window["start"] > spans[-1][1]
            or not 0 < window["streamed_at_verdict"] < ELASTIC_GEN_NEW):
        raise AssertionError(f"19: the verdict did not land mid-run and "
                             f"mid-generation: {window}")
    w0 = window["start"] - ELASTIC_OP_INTERVAL
    w1 = window["end"] + ELASTIC_OP_INTERVAL
    during = [(b1 - a1) for a1, b1 in spans if b1 >= w0 and a1 <= w1]
    steady = [(b1 - a1) for a1, b1 in spans if not (b1 >= w0 and a1 <= w1)]
    out = {"tenants": n, "attaches_ok": len(attach_ms),
           "attach": _pctl(attach_ms), "ops": len(spans),
           "op_steady": _pctl(steady) if steady else None,
           "op_during_resize": _pctl(during) if during else None,
           "retriable_errors": retriable[0], "dropped_tenants": dropped[0],
           "resize_window_s": window["end"] - window["start"],
           "resize": resize, "state": state, "fold_launches": folds,
           "spanning_tokens": len(gen_out["toks"]),
           "streamed_at_verdict": window["streamed_at_verdict"],
           "engine_ranks": engine_ranks,
           "seconds": time.perf_counter() - t_phase}
    if device.type == "cuda" and folds < len(spans):
        raise AssertionError(f"19: {folds} fold launches for {len(spans)} ops")
    sd, du = out["op_steady"] or {}, out["op_during_resize"] or {}
    log(f"19 elastic: {n} tenants, {out['attaches_ok']} attached (p50 "
        f"{out['attach']['p50_ms']:.4f} p99 {out['attach']['p99_ms']:.4f} ms), "
        f"{len(spans)} ops bitwise, {retriable[0]} retriable errors, 0 dropped; "
        f"op p50/p99 steady {sd.get('p50_ms')}/{sd.get('p99_ms')} ms, during "
        f"the resize {du.get('p50_ms')}/{du.get('p99_ms')} ms ({du.get('n')} "
        f"ops); resize {resize.get('duration_ms')} ms (window "
        f"{out['resize_window_s']:.3f} s), grew {resize.get('grew')}, shrunk "
        f"{resize.get('shrunk')}, rebinds {resize.get('rebinds')}; a "
        f"{len(gen_out['toks'])}-token generation spanning it streamed "
        f"bitwise as undisturbed; engine ranks {engine_ranks}; phase 19 in "
        f"{out['seconds']:.1f} s {where}")
    return out


# ---------------------------------------------------------------------------
# 20. the analysis tier on the card
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _set_trace(on: bool, dump: str = "", deadlock_s: str = "") -> None:
    """Tracing on or off for the runs that follow: ``TPU_MPI_TRACE``, with
    ``TPU_MPI_TRACE_DUMP`` when ``dump`` names a prefix and
    ``TPU_MPI_DEADLOCK_TIMEOUT`` when ``deadlock_s`` is given."""
    from tpu_mpi_torch import config
    for key, val in (("TPU_MPI_TRACE", "1" if on else ""),
                     ("TPU_MPI_TRACE_DUMP", dump),
                     ("TPU_MPI_DEADLOCK_TIMEOUT", deadlock_s)):
        if val:
            os.environ[key] = val
        else:
            os.environ.pop(key, None)
    config.load(refresh=True)


def analysis_allreduce(MPI, host: list, device, ops: int,
                       chrome: str = "") -> float:
    """``ops`` host-lane ``MPI.Allreduce`` SUMs of raw tensors on
    ``len(host)`` rank threads, each result bitwise the plain fold; ms per
    op on rank 0's clock after two warm-up ops. With ``chrome`` a path,
    the ranks then merge their traces into a Chrome trace there."""
    import torch
    from tpu_mpi_torch.kernels import fused_reduce as fr
    want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(h).to(device) for h in host], "SUM")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = torch.from_numpy(host[r]).to(device)
        y = torch.empty_like(x)
        for _ in range(2):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        _sync(device)
        MPI.Barrier(comm)
        t0 = time.perf_counter()
        for _ in range(ops):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        _sync(device)
        MPI.Barrier(comm)
        dt = time.perf_counter() - t0
        if y.device.type != device.type or not same_bits(y, want):
            raise AssertionError(f"rank {r}: traced Allreduce differs from "
                                 f"the plain fold")
        if chrome:
            MPI.analyze.timeline.merge_trace(comm, chrome)
        MPI.Finalize()
        return dt

    return max(MPI.spmd_run(body, len(host), timeout=600)) / ops * 1e3


def check_chrome(path: str, nranks: int, ops: int) -> dict:
    """The merged Chrome trace: one row per rank, every rank's ``ops``
    Allreduce slices, and a fold slice inside some rank's slice of every
    one of those ops."""
    with open(path) as f:
        rec = json.load(f)
    evs = rec["traceEvents"]
    rows = {e["pid"]: e["args"]["name"] for e in evs
            if e["ph"] == "M" and e["name"] == "process_name"}
    if rows != {r: f"rank {r}" for r in range(nranks)}:
        raise AssertionError(f"chrome trace rows {rows}")
    slices = [e for e in evs if e["ph"] == "X" and e["cat"] == "coll"
              and e["name"].startswith("Allreduce")]
    folds = [e for e in evs if e["ph"] == "X" and e["cat"] == "phase"
             and e["name"] == "fold"]
    ops_by_rank = {r: sum(e["pid"] == r for e in slices) for r in range(nranks)}
    folded = {e["args"]["seq"] for e in slices
              if any(f["pid"] == e["pid"] and e["ts"] <= f["ts"]
                     and f["ts"] + f["dur"] <= e["ts"] + e["dur"] + 1e-3
                     for f in folds)}
    if set(ops_by_rank.values()) != {ops} or len(folded) != ops:
        raise AssertionError(f"chrome trace: Allreduce slices {ops_by_rank}, "
                             f"{len(folded)} ops with a fold slice, for {ops} "
                             f"ops a rank")
    if rec["otherData"]["schema"] != 2:
        raise AssertionError(f"chrome schema {rec['otherData']}")
    return {"rows": len(rows), "allreduce_slices": ops_by_rank,
            "ops_with_fold": len(folded), "fold_slices": len(folds),
            "events": len(evs)}


def defect_isend(MPI, device):
    """``defect_buffer_reuse``'s program on a raw tensor of ``device``."""
    import torch

    def body():
        comm = MPI.COMM_WORLD
        if MPI.Comm_rank(comm) == 0:
            payload = torch.ones(4, dtype=torch.float64, device=device)
            req = MPI.Isend(payload, 1, 3, comm)
            payload[0] = 99.0
            MPI.Wait(req)
        else:
            out = torch.zeros(4, dtype=torch.float64, device=device)
            MPI.Recv(out, 0, 3, comm)
        MPI.Barrier(comm)
    return body


DEFECT_ISEND_LINE = defect_isend.__code__.co_firstlineno + 8


def defect_dtype(MPI, make):
    """``defect_dtype_mismatch``'s program over ``make(numpy array)``."""
    def body():
        comm = MPI.COMM_WORLD
        if MPI.Comm_rank(comm) == 0:
            MPI.Bcast(make(np.zeros(4, dtype=np.float32)), 0, comm)
        else:
            MPI.Bcast(make(np.zeros(4, dtype=np.float64)), 0, comm)
    return body


def defect_cycle(MPI, device):
    """``defect_deadlock_cycle``'s program on raw tensors of ``device``."""
    import torch

    def body():
        comm = MPI.COMM_WORLD
        rank, size = MPI.Comm_rank(comm), MPI.Comm_size(comm)
        inbox = torch.zeros(1, device=device)
        MPI.Recv(inbox, (rank - 1) % size, 0, comm)
        MPI.Send(torch.ones(1, device=device), (rank + 1) % size, 0, comm)
    return body


def defect_wildcard(MPI, device):
    """``defect_wildcard_deadlock``'s program on raw tensors of ``device``:
    the recorded run is clean, another matching of its ANY_SOURCE receive
    deadlocks (T210)."""
    import torch

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        full = lambda v, n: torch.full((n,), v, device=device)  # noqa: E731
        if rank == 2:
            MPI.Send(full(2.0, 4), 0, 7, comm)
            MPI.Send(full(1.0, 1), 1, 9, comm)
        elif rank == 1:
            MPI.Recv(full(0.0, 1), 2, 9, comm)
            MPI.Send(full(1.0, 4), 0, 7, comm)
        elif rank == 0:
            MPI.Recv(full(0.0, 4), MPI.ANY_SOURCE, 7, comm)
            MPI.Recv(full(0.0, 4), 1, 7, comm)
        MPI.Barrier(comm)
        MPI.Finalize()
    return body


def _findings(MPI, body, nranks: int) -> tuple:
    """``body`` traced on ``nranks`` rank threads: the error (or None) and
    the verifier's findings as (code, file, line, message)."""
    err = None
    try:
        MPI.spmd_run(body, nranks, timeout=120)
    except Exception as e:          # noqa: BLE001 — the defects raise
        err = e
    diags = MPI.analyze.verify_trace(MPI.analyze.last_trace())
    return err, [(d.code, d.file, d.line, d.message) for d in diags]


def _cli(args: list, timeout: float = 120) -> tuple:
    """``python -m tpu_mpi_torch.analyze ARGS`` from the repo: exit code,
    output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_mpi_torch.analyze",
                           *args], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def isend_check_ms(device, nbytes: int, iters: int) -> dict:
    """The Isend check's cost on one ``nbytes`` tensor: its two checksums
    (at the Isend and at the Wait), each a device-to-host copy and a crc32
    on the host, against the copy alone; medians of ``iters``."""
    import torch
    from tpu_mpi_torch.analyze import events
    t = torch.randn(nbytes // 4, device=device)

    def median_ms(fn):
        fn()
        out = []
        for _ in range(iters):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))
    return {"bytes": nbytes,
            "check_ms": median_ms(lambda: (events._buf_crc(t),
                                           events._buf_crc(t))),
            "d2h_ms": median_ms(lambda: t.cpu()),
            "crc_ms": median_ms(lambda: events._buf_crc(t))}


def analysis_phase(MPI, host: list, device, where: str,
                   ops: int = ANALYSIS_OPS, turns: int = ANALYSIS_TURNS,
                   check_bytes: int = ISEND_CHECK_BYTES) -> dict:
    """Phase 20: the main path traced on the card, verified, explored and
    merged into a Chrome trace; defects on CUDA tensors; the dump through
    the analyze CLI; the lint and lock lint over the port and examples."""
    import tempfile
    import torch
    from tpu_mpi_torch.analyze import concurrency, lint
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    out: dict = {}
    try:
        # (1) the main path traced, dumped and merged
        prefix, chrome = os.path.join(tmp, "main"), os.path.join(tmp, "main.json")
        _set_trace(True, dump=prefix)
        kernel_counts().reset()
        try:
            traced_ms = analysis_allreduce(MPI, host, device, ops, chrome)
        finally:
            _set_trace(False)
        launches, chained = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"]
        # (a CPU rehearsal folds with the plain version: no launches)
        if (device.type == "cuda" and launches != ops + 2) or chained:
            raise AssertionError(f"traced main path: {launches} fold launches, "
                                 f"{chained} chained, for {ops + 2} ops")
        tr = MPI.analyze.last_trace()
        diags = MPI.analyze.verify_trace(tr)
        if diags:
            raise AssertionError("traced main path: "
                                 + "; ".join(map(str, diags)))
        t0 = time.perf_counter()
        res = MPI.analyze.explore.explore(tr)
        explore_s = time.perf_counter() - t0
        orphans = sum(d.code == "T211" for d in res.diagnostics)
        if res.deadlocks or orphans or res.truncated or res.schedules < 1 \
                or res.diagnostics:
            raise AssertionError(f"explore of the traced main path: {res}")
        out["main"] = {
            "ops_a_rank": ops + 2, "fold_launches": launches,
            "events": len(tr.events()), "explore": {
                "schedules": res.schedules, "transitions": res.transitions,
                "states": res.states, "deadlocks": res.deadlocks,
                "orphans": orphans, "truncated": res.truncated,
                "seconds": explore_s},
            "chrome": check_chrome(chrome, len(host), ops + 2),
            "traced_ms": traced_ms}
        # host-lane ms per op, untraced and traced in turns
        readings = {"untraced": [], "traced": []}
        turn_launches = {"untraced": [], "traced": []}
        for _ in range(turns):
            for mode in ("untraced", "traced"):
                _set_trace(mode == "traced")
                kernel_counts().reset()
                try:
                    readings[mode].append(analysis_allreduce(MPI, host, device,
                                                             ops))
                finally:
                    _set_trace(False)
                turn_launches[mode].append(kernel_counts()["fold_launches"])
        if device.type == "cuda" and min(n for v in turn_launches.values()
                                         for n in v) < ops + 2:
            raise AssertionError(f"fold launches by turn {turn_launches}, "
                                 f"{ops + 2} ops a turn")
        out["host_lane_ms_turns"] = readings
        out["fold_launches_by_turn"] = turn_launches
        out["host_lane_ms"] = {k: float(np.median(v)) for k, v in readings.items()}
        # (2) defects on CUDA tensors
        _set_trace(True, deadlock_s="2.0")
        try:
            err, got = _findings(MPI, defect_isend(MPI, device), 2)
            want = [("T206", os.path.abspath(__file__), DEFECT_ISEND_LINE)]
            if err or [(c, os.path.abspath(f), ln) for c, f, ln, _ in got] != want:
                raise AssertionError(f"Isend of a mutated {device.type} tensor: "
                                     f"{err!r} {got}")
            err, on_np = _findings(MPI, defect_dtype(MPI, lambda a: a), 2)
            err2, on_dev = _findings(MPI, defect_dtype(
                MPI, lambda a: torch.from_numpy(a).to(device)), 2)
            if err or err2 or [(c, m) for c, _, _, m in on_dev] \
                    != [(c, m) for c, _, _, m in on_np] \
                    or [c for c, *_ in on_np] != ["T202"]:
                raise AssertionError(f"dtype mismatch: numpy {on_np}, "
                                     f"{device.type} {on_dev}")
            err, _ = _findings(MPI, defect_cycle(MPI, device), NRANKS)
            msg = str(err)
            if type(err).__name__ != "DeadlockError" \
                    or "per-rank pending operations:" not in msg \
                    or "wait-for cycle: rank" not in msg \
                    or not all(f"world rank {r}: blocked" in msg
                               for r in range(NRANKS)):
                raise AssertionError(f"deadlock cycle on {device.type}: {err!r}")
        finally:
            _set_trace(False)
        out["defects"] = {"t206_line": DEFECT_ISEND_LINE,
                          "t202": on_dev[0][3], "deadlock_dump_lines":
                          msg.count("\n") + 1}
        out["isend_check"] = isend_check_ms(device, check_bytes,
                                            ANALYSIS_CHECK_ITERS)
        # (3) the dumps through the analyze CLI
        bad = os.path.join(tmp, "wildcard")
        _set_trace(True, dump=bad)
        try:
            MPI.spmd_run(defect_wildcard(MPI, device), NRANKS, timeout=120)
        finally:
            _set_trace(False)
        rc_v, text_v, s_v = _cli(["verify", prefix])
        rc_e, text_e, s_e = _cli(["explore", bad])
        if rc_v != 0 or "trace verifies clean" not in text_v:
            raise AssertionError(f"analyze verify {prefix}: rc {rc_v}\n{text_v}")
        if rc_e != 1 or "T210" not in text_e:
            raise AssertionError(f"analyze explore {bad}: rc {rc_e}\n{text_e}")
        out["cli"] = {"verify_rc": rc_v, "verify_s": s_v, "explore_rc": rc_e,
                      "explore_s": s_e}
        # (4) the static passes over the port and the examples
        root = os.path.dirname(os.path.abspath(__file__))
        trees = [os.path.join(root, "tpu_mpi_torch"), os.path.join(root, "examples")]
        static = {}
        for name, run in (("lint", lint.lint_paths),
                          ("locks", concurrency.lock_lint_paths)):
            t0 = time.perf_counter()
            found = run(trees)
            static[name] = {"diagnostics": len(found),
                            "seconds": time.perf_counter() - t0}
            if found:
                raise AssertionError(f"{name} over the port and examples: "
                                     + "; ".join(map(str, found[:5])))
        out["static"] = static
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    out["fold_launches"] = out["main"]["fold_launches"]
    out["seconds"] = time.perf_counter() - t_phase
    h = out["host_lane_ms"]
    log(f"analysis: traced main path {ops + 2} Allreduce a rank, "
        f"{out['fold_launches']} fold launches, verify clean, explore "
        f"{out['main']['explore']['schedules']} schedule(s) 0 deadlocks, chrome "
        f"{out['main']['chrome']}; host lane untraced {h['untraced']:.4f} / traced "
        f"{h['traced']:.4f} ms/op (turns {out['host_lane_ms_turns']}, fold "
        f"launches {out['fold_launches_by_turn']}); Isend check "
        f"of {check_bytes >> 20} MiB {out['isend_check']['check_ms']:.3f} ms "
        f"(D2H alone {out['isend_check']['d2h_ms']:.3f}); T206, T202, the "
        f"deadlock dump on {device.type}; CLI verify {out['cli']['verify_s']:.1f} s, "
        f"explore {out['cli']['explore_s']:.1f} s; lint {static['lint']['seconds']:.2f} "
        f"s, locks {static['locks']['seconds']:.2f} s; phase {out['seconds']:.1f} s "
        f"{where}")
    return out


# ---------------------------------------------------------------------------
# 21. 0-d operands and complex MAX/MIN on the card; the examples
# ---------------------------------------------------------------------------

def _bits(t) -> tuple:
    """A tensor's shape, dtype and bytes as the host reads them (bfloat16
    as its raw bits)."""
    from tpu_mpi_torch.buffers import to_numpy
    a = to_numpy(t)
    return a.shape, a.dtype.str, a.tobytes()


def _complex_specials(rank: int, dtype) -> np.ndarray:
    """Every pair of COMPLEX_SPECIALS over ranks 0 and 1 (rank r takes the
    list shifted by r per column), NaNs with payloads of their own on
    rank 1."""
    n = len(COMPLEX_SPECIALS)
    a = np.array([COMPLEX_SPECIALS[(i // n + rank * (i % n)) % n]
                  for i in range(n * n)], dtype=dtype)
    if rank == 1:
        bits = a.view(np.uint32 if a.dtype == np.complex64 else np.uint64)
        bits[np.isnan(a.view(a.real.dtype))] |= 0x15
    return a


def zero_d_complex_phase(MPI, fr, device) -> dict:
    """21a: on NRANKS rank threads, with CUDA raw tensors and cells: the
    0-d Allreduce, Scan, Exscan, bcast and Sendrecv of float32, int64 and
    bfloat16 (shape () and the bits of the rank-ordered fold on the host),
    one fold launch per 0-d Allreduce; complex64/complex128 Allreduce MAX
    and MIN and a complex-window Accumulate MAX with NaN and signed-zero
    elements, bit for bit numpy's ``np.maximum``/``np.minimum`` in rank
    order, each a chained fold (complex stays off the kernel)."""
    import functools
    import torch
    from tpu_mpi_torch.buffers import from_numpy

    def value(r, dt):
        return np.array(r * 3 + 1.5 if dt != "int64" else r * 3 + 1,
                        dtype=np.float32 if dt == "bfloat16" else dt)

    def as_dtype(a, dt):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(torch.bfloat16) if dt == "bfloat16" else t

    def host_fold(vals, dt):
        return functools.reduce(operator.add, [as_dtype(v, dt) for v in vals])

    kinds = {"tensor": lambda t: t.to(device),
             "cell": lambda t: MPI.DeviceBuffer(t, device=device)}
    dev_type = torch.device(device).type
    # the kernel itself on 0-d CUDA operands, against its plain version
    # (before the counts are reset: these launches are not the path's)
    for dt in ZERO_D_DTYPES:
        xs = [as_dtype(value(r, dt), dt).to(device) for r in range(NRANKS)]
        got = fr.fused_multi_reduce(xs, "SUM")
        if got.shape != () or _bits(got) != _bits(
                fr.fused_multi_reduce_plain(xs, "SUM")):
            raise AssertionError(f"0-d {dt} fold kernel != plain")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        left, right = (r - 1) % NRANKS, (r + 1) % NRANKS
        for kind, wrap in kinds.items():
            for dt in ZERO_D_DTYPES:
                x = wrap(as_dtype(value(r, dt), dt))
                vals = [value(k, dt) for k in range(NRANKS)]
                checks = {
                    "Allreduce": (MPI.Allreduce(x, MPI.SUM, comm),
                                  host_fold(vals, dt)),
                    "Scan": (MPI.Scan(x, MPI.SUM, comm),
                             host_fold(vals[:r + 1], dt)),
                    "Exscan": (MPI.Exscan(x, MPI.SUM, comm),
                               host_fold(vals[:max(r, 1)], dt)),
                    "bcast": (MPI.bcast(x if r == 0 else None, 0, comm),
                              as_dtype(vals[0], dt)),
                }
                y = wrap(as_dtype(np.zeros((), np.float32
                                           if dt == "bfloat16" else dt), dt))
                MPI.Sendrecv(x, right, 21, y, left, 21, comm)
                checks["Sendrecv"] = (y, as_dtype(vals[left], dt))
                for what, (got, want) in checks.items():
                    t = got.value if isinstance(got, MPI.DeviceBuffer) else got
                    if t.device.type != dev_type or _bits(t) != _bits(want):
                        raise AssertionError(
                            f"0-d {kind} {dt} {what} on rank {r}: {t!r} "
                            f"!= {want!r}")
            for dt in (np.complex64, np.complex128):
                xs = [_complex_specials(k, dt) for k in range(NRANKS)]
                x = wrap(torch.from_numpy(xs[r]))
                for opname, ufunc in (("MAX", np.maximum), ("MIN", np.minimum)):
                    got = MPI.Allreduce(x, getattr(MPI, opname), comm)
                    t = got.value if isinstance(got, MPI.DeviceBuffer) else got
                    if t.device.type != dev_type or _bits(t)[2] != \
                            functools.reduce(ufunc, xs).tobytes():
                        raise AssertionError(f"complex {kind} {dt.__name__} "
                                             f"Allreduce {opname} on rank {r}")
                w = wrap(torch.from_numpy(_complex_specials(r + 1, dt)))
                win = MPI.Win_create(w, comm)
                MPI.Win_fence(0, win)
                MPI.Accumulate(x, xs[r].size, right, 0, MPI.MAX, win)
                MPI.Win_fence(0, win)
                win.free()
                t = w.value if isinstance(w, MPI.DeviceBuffer) else w
                want = np.maximum(_complex_specials(r + 1, dt), xs[left])
                if t.device.type != dev_type or _bits(t)[2] != want.tobytes():
                    raise AssertionError(f"complex {kind} {dt.__name__} "
                                         f"Accumulate MAX on rank {r}")
        MPI.Finalize()

    kernel_counts().reset()
    chained0 = kernel_counts()["chained_folds"]
    t0 = time.perf_counter()
    MPI.spmd_run(body, NRANKS, timeout=300)
    seconds = time.perf_counter() - t0
    folds, chained = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"] - chained0
    want_folds = len(kinds) * len(ZERO_D_DTYPES)           # the Allreduces
    want_chained = len(kinds) * 2 * (2 + NRANKS)           # MAX, MIN, accumulates
    if folds != want_folds or chained != want_chained:
        raise AssertionError(f"phase 21a: {folds} fold launches (want "
                             f"{want_folds}), {chained} chained folds (want "
                             f"{want_chained})")
    return {"seconds": seconds, "fold_launches": folds,
            "chained_folds": chained, "zero_d_dtypes": list(ZERO_D_DTYPES),
            "kinds": list(kinds)}


# runs an example through the launcher's main() (the function tpurun-torch
# is) or as a plain script, then reports this process's kernel counts
EXAMPLE_RUNNER = """
import json, runpy, sys
from tpu_mpi_torch import launcher
from tpu_mpi_torch.kernels._build import counts
args = sys.argv[1:]
if args[0] == "--python":
    sys.argv = args[1:]
    runpy.run_path(args[1], run_name="__main__")
    rc = 0
else:
    rc = launcher.main(args)
sys.stderr.write("PHASE21 " + json.dumps({
    "folds": counts["fold_launches"], "ring_allreduce": counts["ring_launches"]["ring_allreduce"],
    "chained": counts["chained_folds"]}) + "\\n")
sys.exit(rc)
"""


def run_example(spec, repo: str, tmp: str) -> dict:
    """One example of EXAMPLES in its own temporary directory: its exit
    code, the line it asserts or prints, wall seconds and the kernel
    counts of the launching process."""
    import re
    name, args, extra, want_rc, pattern = spec
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_MPI_")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = tmp
    script = os.path.join(repo, "tpu_mpi_torch", "examples", f"{name}.py")
    cmd = [sys.executable, "-c", EXAMPLE_RUNNER,
           *(args if args is not None else ["--python"]), script]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT, cwd=repo, env={**env, **extra})
    seconds = time.perf_counter() - t0
    counts = re.findall(r"^PHASE21 (.*)$", res.stderr, re.M)
    line = re.search(pattern, res.stdout)
    if res.returncode != want_rc or line is None or not counts:
        raise AssertionError(
            f"example {name} {args}: rc {res.returncode} (want {want_rc}), "
            f"line {pattern!r} {'found' if line else 'missing'}\n"
            f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return {"example": name, "args": args, "env": extra, "rc": res.returncode,
            "seconds": seconds, "line": line.group(0),
            **json.loads(counts[-1])}


def examples_phase(where: str) -> list:
    """21b: every example of ``tpu_mpi_torch/examples`` on the card, as a
    user runs it (the launcher with no ``--sim``, or plain python for 12
    and 13), one process each, EXAMPLE_WORKERS at a time (each example's
    seconds include its share of the card and the host): exit code, the
    line it asserts or prints, wall seconds and the fold-kernel launches
    of the launching process (the rank threads'; a ``--procs`` run's ranks
    are processes of their own, not counted)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, str(i)) for i in range(len(EXAMPLES))]
        for d in dirs:
            os.mkdir(d)
        with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
            out = list(pool.map(lambda a: run_example(a[0], repo, a[1]),
                                zip(EXAMPLES, dirs)))
    for rec in out:
        log(f"example {rec['example']} {' '.join(rec['args'] or ['(python)'])}"
            f"{' ' + str(rec['env']) if rec['env'] else ''}: rc {rec['rc']} in "
            f"{rec['seconds']:.2f} s, {rec['line']!r}, fold launches "
            f"{rec['folds']}, ring_allreduce {rec['ring_allreduce']}, chained "
            f"{rec['chained']} {where}")
    return out


def against_libraries(_build, specs: list) -> dict:
    """``--against LABEL=DIR``: LABEL -> {"ring": the ``ring.cu``, "fold":
    the ``fused_reduce.cu``} of the tree at DIR (a checkout of another
    commit), built beside this tree's kernels. Each entry is typed with or
    without a route argument, as that tree has one."""
    import ctypes
    from pathlib import Path
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def bind_ring(lib):
        route = [i] if hasattr(lib, "tmt_ring_reduce_scatter_tile") else []
        lib.tmt_ring_reduce_scatter.argtypes = [p, p, i, i64, i, i, *route, p]
        lib.tmt_ring_reduce_scatter.restype = ctypes.c_int

    def bind_fold(lib):
        route = [i] if hasattr(lib, "tmt_fused_reduce_tile") else []
        lib.tmt_fused_reduce.argtypes = [ctypes.POINTER(p), i, p, i64, i, i,
                                         *route, p]
        lib.tmt_fused_reduce.restype = ctypes.c_int

    libs = {}
    for spec in specs:
        label, _, tree = spec.partition("=")
        csrc = Path(tree).resolve() / "tpu_mpi_torch" / "csrc"
        sources = (csrc / "ring.cu", csrc / "fused_reduce.cu")
        if not label or not all(src.exists() for src in sources):
            raise SystemExit(f"chip_smoke: --against LABEL=DIR, no {csrc}/"
                             f"ring.cu and fused_reduce.cu")
        libs[label] = {"ring": _build.Library(f"ring_{label}", sources[0], bind_ring),
                       "fold": _build.Library(f"fused_reduce_{label}", sources[1],
                                              bind_fold)}
    return libs


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--against", action="append", default=[], metavar="LABEL=DIR",
        help="also time the fused_multi_reduce and ring_reduce_scatter "
             "kernels of the tree at DIR (a checkout of another commit) in "
             "phase 6's turns")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective, xla
    from tpu_mpi_torch.implementations import capabilities
    from tpu_mpi_torch.kernels import _build, fused_reduce as fr, ring

    from tpu_mpi_torch import parallel as par
    from tpu_mpi_torch.kernels import attention, ddp_step, permute
    from tpu_mpi_torch.models import transformer as tr

    # every card comparison below: float32 matmuls in full float32, bfloat16
    # matmuls reduced in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card {card} | torch {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, bf16 reduced-precision "
        f"reduction {torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    where = f"[{card}]"

    t0 = time.perf_counter()
    against = against_libraries(_build, args.against)
    libs = (fr.LIBRARY, ring.LIBRARY, permute.LIBRARY, attention.LIBRARY,
            attention.LIBRARY_SM90, attention.LIBRARY_BACKWARD, ddp_step.LIBRARY,
            *(lib for tree in against.values()
                                      for lib in tree.values()))
    built = _build.build_all(libs)
    for lib in libs:
        lib.load()
    log(f"built {', '.join(p.name for p in built)} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")

    t0 = time.perf_counter()
    parity = check_parity(fr, device)
    log(f"fused fold kernel == plain, bitwise, on {parity['cases']} cases "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    fold_routes = check_fold_routes(fr, device)
    log(f"fused fold kernel == plain, bitwise, on both routes forced "
        f"({fold_routes['cases']} cases: ragged and whole-word counts, offset "
        f"views, out aliasing operand 0 and each operand of 17, n up to 17), "
        f"launches by route "
        f"{fold_routes['routes']} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ring_parity = check_ring_parity(MPI, ring, device)
    log(f"ring kernels == plain, bitwise, on {ring_parity['cases']} cases, "
        f"reduce-scatter launches by route {ring_parity['routes']} "
        f"({time.perf_counter() - t0:.1f} s)")

    # host main path
    host = host_operands(N_MAIN, NRANKS)
    auto_hits0 = collective._plans.auto_hits
    kernel_counts().reset()
    t0 = time.perf_counter()
    path = main_path(MPI, host, device)
    launches, chained = kernel_counts()["fold_launches"], kernel_counts()["chained_folds"]
    main_routes = dict(kernel_counts()["fold_route_launches"])
    log(f"host main path: {path['ops']} collectives on {NRANKS} rank threads in "
        f"{time.perf_counter() - t0:.1f} s; fold kernel launches {launches} by "
        f"route {main_routes}, chained folds {chained}, auto-armed hits "
        f"{collective._plans.auto_hits - auto_hits0}")
    if launches != path["ops"]:
        raise AssertionError(f"{launches} kernel launches for {path['ops']} "
                             f"collectives")
    if main_routes["staged"] != launches:
        raise AssertionError(f"a host-path fold left the staged route: {main_routes}")
    if chained != 0:
        raise AssertionError(f"{chained} folds left the kernel")
    if collective._plans.auto_hits == auto_hits0:
        raise AssertionError("repeated Allreduce never took the auto-armed lane")

    # in-graph path
    mesh = xla.make_mesh({"x": NRANKS})
    xs = torch.from_numpy(np.stack(host)).to(mesh.device)
    kernel_counts().reset()
    t0 = time.perf_counter()
    graph = ingraph_path(MPI, xla, xs)
    k = kernel_counts().snapshot()
    graph_folds, graph_rings = k["fold_launches"], k["ring_launches"]
    graph_routes, graph_fold_routes = k["ring_route_launches"], k["fold_route_launches"]
    callables, chained = k["callable_rings"], k["chained_folds"]
    log(f"in-graph path on {mesh}: {len(graph)} calls in "
        f"{time.perf_counter() - t0:.2f} s; ring launches {graph_rings}, fold "
        f"launches {graph_folds} by route {graph_fold_routes}, callable rings "
        f"{callables}, chained folds {chained}")
    if min(graph_rings.values()) < 1 or graph_folds != 2:
        raise AssertionError("the in-graph path did not launch every kernel once")
    if graph_fold_routes["staged"] != graph_folds:
        raise AssertionError(f"an in-graph fold left the staged route: "
                             f"{graph_fold_routes}")
    if graph_routes["staged"] != graph_rings["ring_reduce_scatter"]:
        raise AssertionError(f"an in-graph reduce-scatter left the staged route: "
                             f"{graph_routes}")
    if callables or chained:
        raise AssertionError("an in-graph reduction left its kernel")
    graph_err = check_ingraph(ring, fr, xs, graph)
    shards = graph["ring_reduce_scatter"]
    del graph

    # times at the main paths' shapes
    caps = capabilities()
    gib = 1 << 30
    src = torch.empty(gib, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    copy_gbps = 2 * gib / (copy_ms * 1e-3) / 1e9
    del src, dst
    logdir = str(_build.BUILD_DIR / "traces")
    # the host path's operands, one tensor per rank; the in-graph path
    # folds the rows of the stacked tensor instead
    xl = [torch.from_numpy(h).to(device) for h in host]
    fold = fold_times(fr, xl, xs, caps, against, logdir)
    kern_ms, plain_ms, lib_ms = fold["ms"], fold["plain_ms"], fold["library_ms"]
    bound_ms, bound_by = fold["bound"]
    nbytes = (NRANKS + 1) * N_MAIN * xl[0].element_size()
    rings = ring_times(ring, xs, shards, caps, against)
    del xl, xs, shards
    host_ms = host_lane_ms(MPI, host, device)
    algbw = N_MAIN * 4 / (host_ms * 1e-3) / 1e9
    prof = host_lane_profile(MPI, host, device, logdir)
    log(f"1 GiB copy_ {copy_ms:.4f} ms = {copy_gbps:.1f} GB/s read+write {where}")
    log(f"fold 4 x float32[2^26] (staged tile {fold['staged_tile']} elements): "
        f"kernel {kern_ms:.4f} ms ({nbytes / (kern_ms * 1e-3) / 1e9:.1f} GB/s, "
        f"{nbytes / (kern_ms * 1e-3) / 1e9 / copy_gbps:.3f} of the copy, "
        f"{bound_ms / kern_ms:.3f} of the bound), bound {bound_ms:.4f} ms (bytes at "
        f"the {caps['hbm_gbps']:.0f} GB/s spec), plain {plain_ms:.4f} ms, xs.sum(0) "
        f"on the stacked tensor {lib_ms:.4f} ms, torch.stack(xs).sum(0) "
        f"{fold['stack_sum_ms']:.4f} ms {where}")
    for what, t in (("host operands", fold), ("stacked rows", fold["rows"])):
        log(f"fold on the {what} in turns: kernel {t['ms_turns']} ms, xs.sum(0) "
            f"{t['library_ms_turns']} ms"
            + "".join(f", {label} {t[label + '_ms_turns']} ms"
                      for label in ("direct", *against, "stack_sum")
                      if label + "_ms_turns" in t)
            + f"; medians kernel {t['ms']:.4f}, xs.sum(0) {t['library_ms']:.4f}"
            + "".join(f", {label} {t[label + '_ms']:.4f}"
                      for label in ("direct", *against) if label + "_ms" in t)
            + f" ms {where}")
    for name, t in fold["tiny"].items():
        log(f"fold {name} (the wrapper picks {t['chosen']}): "
            + "; ".join(f"{w} {t[w + '_ms']:.4f} ms per call {t[w + '_ms_turns']}, "
                        f"span {t[w + '_span_ms']:.4f} ms"
                        for w in ROUTES if w + "_ms" in t)
            + f" {where}")
    for name, t in rings.items():
        gbps = t["bound"][0] * caps["hbm_gbps"] / t["ms"]
        log(f"{name} at the in-graph shapes: kernel {t['ms']:.4f} ms ({gbps:.1f} "
            f"GB/s, {gbps / copy_gbps:.3f} of the copy), bound {t['bound'][0]:.4f} "
            f"ms ({t['bound'][1]}), plain {t['plain_ms']:.4f} ms, "
            f"{t['library_call']} {t['library_ms']:.4f} ms {where}")
    rs, ag = rings["ring_reduce_scatter"], rings["ring_allgather"]
    log(f"ring_allreduce floor {rings['ring_allreduce']['floor_call']} "
        f"{rings['ring_allreduce']['floor_ms']:.4f} ms; ring_reduce_scatter in "
        f"turns (staged tile {rs['staged_tile']} elements): kernel "
        f"{rs['ms_turns']} ms, library {rs['library_ms_turns']} ms"
        + "".join(f", {label} {rs[label + '_ms_turns']} ms"
                  for label in ("direct", *against))
        + f" {where}")
    log(f"ring_allgather in turns: kernel {ag['ms_turns']} ms, "
        f"{ag['library_call']} {ag['library_ms_turns']} ms, {ag['repeat_call']} "
        f"{ag['repeat_ms_turns']} ms {where}")
    log(f"host-lane MPI.Allreduce float32[2^26] x {NRANKS} ranks: "
        f"{host_ms:.4f} ms/op, algbw {algbw:.1f} GB/s {where}")
    if prof["fold_spans"]:
        log(f"profiled host lane, {prof['iters']} ops: window "
            f"{prof['window_ms']:.4f} ms, device busy {prof['busy_ms']:.4f} ms "
            f"(idle share {1 - prof['busy_ms'] / prof['window_ms']:.3f}), fold "
            f"kernel {prof['fold_ms'] / prof['fold_spans']:.4f} ms x "
            f"{prof['fold_spans']} (profiler adds its own cost) {where}")
    else:
        log(f"profiled host lane: the trace shows no fold kernel spans, "
            f"device busy share not measured ({prof['trace']})")

    repo = fr.SOURCE.parents[2]
    kernels = [{
        "name": "fused_multi_reduce",
        "route": "cuda",
        "source": str(fr.SOURCE.relative_to(repo)),
        "replaces": fr.REPLACES,
        "launches": launches,
        "max_abs_err": max(parity["max_abs_err"], fold_routes["max_abs_err"],
                           graph_err),   # phase 6's folds are held bitwise too
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "library_call": "xs.sum(0) on the stacked (4, 2^26) tensor",
        "parity": "bitwise",
        "parity_cases": parity["cases"] + fold_routes["cases"],
        "parity_launches_by_route": fold_routes["routes"],
        "launches_by_route": {"host": main_routes, "ingraph": graph_fold_routes},
        "ingraph_launches": graph_folds,
        "ingraph_rows_ms": fold["rows"]["ms"],
        "staged_tile": fold["staged_tile"],
        **{k: v for k, v in fold.items() if k.endswith("_turns")
           or k in ("direct_ms", "stack_sum_ms", "rows", "tiny")
           or k.removesuffix("_ms") in against},
        "stack_sum_call": "torch.stack(xs).sum(0)",
        "copy_gbps": copy_gbps,
        "host_lane_ms": host_ms,
        "host_lane_algbw_gbps": algbw,
    }]
    for name, t in rings.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": str(ring.SOURCE.relative_to(repo)),
            "replaces": ring.REPLACES[name],
            "launches": graph_rings[name],
            "max_abs_err": max(ring_parity["max_abs_err"][name], graph_err),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "library_call": t["library_call"],
            "parity": "bitwise",
            "parity_cases": ring_parity["cases"][name],
            "copy_gbps": copy_gbps,
            **({"launches_by_route": graph_routes,
                "parity_launches_by_route": ring_parity["routes"]}
               if name == "ring_reduce_scatter" else {}),
            **{k: v for k, v in t.items() if k.endswith("_turns")
               or k in ("floor_ms", "floor_call", "staged_tile", "repeat_ms",
                        "repeat_call", "direct_ms")
               or k.removesuffix("_ms") in against},
        })

    # 8. the new kernels against their plain versions
    t0 = time.perf_counter()
    perm_parity = check_permute_parity(permute, device)
    log(f"permute and alltoall kernels == plain, bitwise, on "
        f"{perm_parity['cases']} cases ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    attn_parity = check_attention_parity(attention, device)
    log(f"ring attention kernel == plain within the elementwise bound "
        f"({attention.TOLERANCE_NOTE}) on {attn_parity['cases']} cases, "
        f"max_abs_err {attn_parity['max_abs_err']}, largest share of the bound "
        f"{attn_parity['bound_share']} ({time.perf_counter() - t0:.1f} s)")

    # 9. model path: 3 requests through the sp forward at the flagship width
    cfg = tr.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = tr.transformer_init(gen, cfg, device=device)
    n_params = sum(p.numel() for p in [params["embed"], params["ln_f"]]
                   + [w for layer in params["layers"] for w in layer.values()])
    requests = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (REQUESTS, BATCH, SEQ)).astype(np.int64)
    kernel_counts().reset()
    t0 = time.perf_counter()
    served = serve(tr, cfg, params, requests, device)
    serve_s = time.perf_counter() - t0
    k = kernel_counts().snapshot()
    model_launches, model_routes = k["attention_launches"], k["attention_route_launches"]
    others = (k["fold_launches"], sum(k["ring_launches"].values()), k["callable_rings"],
              k["chained_folds"], sum(k["permute_launches"].values()))
    log(f"model path: {REQUESTS} requests of ({BATCH}, {SEQ}) tokens through the "
        f"sp forward on {{'sp': {SP}}}, {n_params} parameters, in {serve_s:.2f} s "
        f"(first requests, build-free); ring_attention launches {model_launches} "
        f"by route {model_routes}; fold, ring, callable, chained, permute launches "
        f"{others}")
    if model_launches != REQUESTS * cfg.n_layers:
        raise AssertionError(f"{model_launches} ring-attention launches for "
                             f"{REQUESTS} requests of {cfg.n_layers} layers")
    if model_routes["sm90"] != model_launches:
        raise AssertionError(f"model-path attention left the sm90 kernel: "
                             f"{model_routes}")
    if any(others):
        raise AssertionError(f"the sp forward launched other kernels: {others}")
    sp_checks = []
    for req, (logits, nxt) in zip(requests, served):
        for tns in (logits, nxt):
            if tns.device.type != "cuda":
                raise AssertionError(f"model output on {tns.device}")
        if tuple(logits.shape) != (SP, BATCH, SEQ // SP, cfg.vocab) \
                or tuple(nxt.shape) != (BATCH,):
            raise AssertionError(f"model output shapes {logits.shape} {nxt.shape}")
        dense = tr.transformer_forward(cfg, params, torch.from_numpy(req).to(device))
        check = compare_logits(unstack_seq(logits), dense, "sp vs dense forward",
                               "bfloat16")
        check["next_tokens_agree"] = int((nxt == dense[:, -1].argmax(-1)).sum())
        sp_checks.append(check)
        del dense
    next_tokens = [nxt.tolist() for _, nxt in served]
    del served
    log(f"sp logits vs dense forward (bfloat16): {sp_checks}; next tokens "
        f"{next_tokens}")
    params32 = float32_params(params)
    cfg32 = tr.TransformerConfig(**FLAGSHIP, dtype=torch.float32)
    tok0 = torch.from_numpy(requests[0]).to(device)
    f32_check = compare_logits(
        unstack_seq(tr.transformer_forward(cfg32, params32, stack_seq(tok0, SP),
                                           sp_axis="sp")),
        tr.transformer_forward(cfg32, params32, tok0), "sp vs dense forward",
        "float32")
    del params32
    log(f"sp logits vs dense forward (float32, TF32 off): {f32_check}")
    kernel_counts().reset()
    tp_logits = tr.transformer_forward(cfg, tr.shard_params(params, cfg, SP), tok0,
                                       tp_axis="tp")
    torch.cuda.synchronize()
    tp_folds = kernel_counts()["fold_launches"]
    tp_check = compare_logits(tp_logits[SP - 1],
                              tr.transformer_forward(cfg, params, tok0),
                              "tp vs single forward", "bfloat16")
    del tp_logits
    log(f"tp forward on {{'tp': {SP}}}: fold launches {tp_folds}; vs single "
        f"forward {tp_check}")
    if tp_folds != 2 * cfg.n_layers:
        raise AssertionError(f"{tp_folds} fold launches for the tp forward")

    # 10. recipes
    t0 = time.perf_counter()
    rec = recipes(tr, par, cfg, params, device)
    log(f"recipes ({time.perf_counter() - t0:.1f} s): ulysses {rec['ulysses']}, "
        f"pipeline {rec['pipeline']}, moe {rec['moe']}, halo {rec['halo']}")

    # 11. times of the new kernels and of the model path
    new_times = new_kernel_times(permute, attention, rec["pipeline_hop"],
                                 rec["moe_send"], rec["ulysses_inputs"], logdir)
    del rec["pipeline_hop"], rec["moe_send"], rec["ulysses_inputs"]
    for name, t in new_times.items():
        log(f"{name} at {t['shape']} {t['dtype']}: kernel == plain on these "
            f"inputs {t['main_parity']}; kernel {t['ms']:.4f} ms per "
            f"call (CUDA events; {t['span_ms']:.4f} ms kernel span under the "
            f"profiler), bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]}), plain {t['plain_ms']:.4f} "
            f"ms, {t['library_call']} {t['library_ms']:.4f} ms {where}")
    # 11b. the kernels of the Moonlight cell at its shapes
    moon = moonlight_kernel_times(attention, permute, xla, device, logdir)
    for name, t in moon.items():
        lib = "not measured" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"11b {name} at {t['shape']} {t['dtype']}: kernel against plain "
            f"{t['main_parity']}; kernel {t['ms']:.4f} ms per call ({t['span_ms']:.4f} "
            f"ms kernel span), bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), plain "
            f"{t['plain_ms']:.4f} ms, {t['library_call']} {lib} {where}")
    ra, cp = new_times["ring_attention"], new_times["collective_permute"]
    log(f"ring_attention, same run: sm90 span {ra['span_ms']:.4f} ms "
        f"({ra['ms']:.4f} ms per call); mma.sync kernel span "
        f"{ra['previous_span_ms']:.4f} ms ({ra['previous_ms']:.4f} ms per call); "
        f"SDPA {ra['library_ms']:.4f} ms per call; bound {ra['bound'][0]:.4f} ms "
        f"{where}")
    if ra["library_span_ms"] is None:
        log("ring_attention: SDPA's kernel span NOT MEASURED in this run (the "
            "profiler recorded none of its kernels twice); compare the sm90 "
            "kernel's per-call time with SDPA's per-call time above instead")
    else:
        log(f"ring_attention, same run: sm90 span / SDPA span "
            f"{ra['span_ms']:.4f} / {ra['library_span_ms']:.4f} = "
            f"{ra['span_ms'] / ra['library_span_ms']:.3f}")
    log(f"collective_permute span with the L2 flushed before each call "
        f"{cp['span_l2_flushed_ms']:.4f} ms against the bytes bound "
        f"{cp['bound'][0]:.4f} ms (share {cp['bound'][0] / cp['span_l2_flushed_ms']:.3f}); "
        f"back to back {cp['span_ms']:.4f} ms {where}")
    if cp["library_span_l2_flushed_ms"] is None:
        log("collective_permute: xs[inverse_perm]'s span with the L2 flushed NOT "
            "MEASURED in this run (the profiler recorded none of its kernels)")
    else:
        log(f"collective_permute span with the L2 flushed, in turns: kernel "
            f"{cp['span_l2_flushed_turns']} ms, xs[inverse_perm] "
            f"{cp['library_span_l2_flushed_turns']} ms; medians "
            f"{cp['span_l2_flushed_ms']:.4f} / "
            f"{cp['library_span_l2_flushed_ms']:.4f} = "
            f"{cp['span_l2_flushed_ms'] / cp['library_span_l2_flushed_ms']:.3f} "
            f"{where}")
    log(f"collective_permute per call in turns: kernel {cp['ms_turns']} ms, "
        f"xs[inverse_perm] {cp['library_ms_turns']} ms; medians {cp['ms']:.4f} / "
        f"{cp['library_ms']:.4f} = {cp['ms'] / cp['library_ms']:.3f} {where}")
    stacked0 = stack_seq(tok0, SP)
    request_ms = time_ms(lambda: tr.transformer_forward(cfg, params, stacked0,
                                                        sp_axis="sp")
                         [-1, :, -1].argmax(-1), iters=10)
    tokens_per_s = BATCH * SEQ / (request_ms * 1e-3)
    mprof = model_profile(tr, cfg, params, tok0, logdir)
    idle = 1 - mprof["busy_ms"] / mprof["window_ms"]
    log(f"model path: {request_ms:.4f} ms per request of {BATCH}x{SEQ} tokens "
        f"(CUDA events, 10 requests), {tokens_per_s:.1f} tokens/s; profiled "
        f"{mprof['iters']} requests: window {mprof['window_ms']:.4f} ms, device "
        f"busy {mprof['busy_ms']:.4f} ms (idle share {idle:.3f}), ring attention "
        f"{mprof['attention_ms'] / max(1, mprof['attention_spans']):.4f} ms x "
        f"{mprof['attention_spans']}; device busy per request "
        f"{mprof['busy_ms'] / mprof['iters']:.4f} ms against {request_ms:.4f} ms "
        f"unprofiled {where}")
    log(f"model path, device time per request by kernel (profiler): "
        f"{mprof['top_kernels_ms_per_request']}")

    # 12. training at the flagship width
    t0 = time.perf_counter()
    train = train_phase(MPI, tr, xla, cfg, params, device, logdir, where, caps)
    log(f"training phase in {time.perf_counter() - t0:.1f} s")
    trainers = train["trainers"]
    train_folds = (train["sp"]["fold_launches"] + train["tp"]["fold_launches"]
                   + sum(trainers["ddp_folds"]) + sum(trainers["fsdp_folds"]))

    def entry(name, t, source, replaces, launches, err, parity, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                "library_call": t["library_call"], "parity": parity,
                "span_ms": t["span_ms"], "shape": t["shape"], "dtype": t["dtype"],
                "main_parity": t["main_parity"], **extra}

    rel = lambda path: str(path.relative_to(repo))    # noqa: E731
    kernels.append(entry(
        "pairwise_alltoall", new_times["pairwise_alltoall"], rel(permute.SOURCE),
        permute.REPLACES["pairwise_alltoall"],
        rec["ulysses"]["alltoall_launches"] + rec["moe"]["alltoall_launches"], 0.0,
        "bitwise", parity_cases=perm_parity["cases"]["pairwise_alltoall"],
        path="recipes: ulysses_attention + moe_dispatch_combine"))
    kernels.append(entry(
        "collective_permute", new_times["collective_permute"], rel(permute.SOURCE),
        permute.REPLACES["collective_permute"],
        rec["pipeline"]["permute_launches"] + rec["halo"]["permute_launches"], 0.0,
        "bitwise", parity_cases=perm_parity["cases"]["collective_permute"],
        path="recipes: pipeline_forward + halo_exchange",
        ms_turns=new_times["collective_permute"]["ms_turns"],
        span_l2_flushed_ms=new_times["collective_permute"]["span_l2_flushed_ms"],
        library_span_l2_flushed_ms=new_times["collective_permute"][
            "library_span_l2_flushed_ms"],
        library_ms_turns=new_times["collective_permute"]["library_ms_turns"]))
    kernels.append(entry(
        "ring_attention", new_times["ring_attention"], rel(attention.SOURCE_SM90),
        attention.REPLACES, model_launches + train["sp"]["attention_launches"],
        max(*attn_parity["max_abs_err"].values(),
            new_times["ring_attention"]["main_parity"]["max_abs_err"]),
        f"elementwise: {attention.TOLERANCE_NOTE}",
        launches_by_route=model_routes,
        previous_span_ms=new_times["ring_attention"]["previous_span_ms"],
        previous_ms=new_times["ring_attention"]["previous_ms"],
        library_span_ms=new_times["ring_attention"]["library_span_ms"],
        source_previous=rel(attention.SOURCE),
        parity_cases=attn_parity["cases"],
        max_abs_err_by_dtype=attn_parity["max_abs_err"],
        bound_share_by_dtype=attn_parity["bound_share"],
        path="model: transformer_forward(sp_axis='sp'), 3 requests",
        request_ms=request_ms, tokens_per_s=tokens_per_s, model_idle_share=idle,
        model_window_ms=mprof["window_ms"], model_busy_ms=mprof["busy_ms"],
        sp_vs_dense=sp_checks, sp_vs_dense_f32=f32_check, tp_vs_single=tp_check,
        train_launches=train["sp"]["attention_launches"],
        train_backward_ms=train["times"]["attention_backward_ms"],
        train_sdpa_fwd_bwd_ms=train["times"]["sdpa_fwd_bwd_ms"]))
    kernels.append(entry(
        "ring_attention.mla", moon["ring_attention"], rel(attention.SOURCE_SM90),
        attention.REPLACES, 1, moon["ring_attention"]["main_parity"]["max_abs_err"],
        f"elementwise: {attention.TOLERANCE_NOTE}", launches_by_route={"sm90": 1},
        launches_by_dims={"192/128": 1},
        path="phase 11b: attention.attend at the Moonlight cell's shape"))
    for name, t, calls, path in (
            ("attention_backward", train["attention_backward"],
             train["sp"]["backward_launches_by_dims"],
             f"train: the sp step's ring attention backward, {TRAIN_STEPS} steps"),
            ("attention_backward.mla", moon["attention_backward"], {"192/128": 1},
             "phase 11b: attention.backward at the Moonlight cell's shape")):
        kernels.append(entry(
            name, t, rel(attention.SOURCE_BACKWARD),
            "none (the JAX package's gradient is XLA's autodiff of its ring)",
            sum(calls.values()), max(t["main_parity"]["rel_err"].values()),
            "within 2^-5 of each gradient's largest magnitude of attention_backward "
            "(max_abs_err: the largest of the three relative errors)",
            launches_by_dims=calls, spans_ms=t["spans_ms"], ms_turns=t["ms_turns"],
            plain_ms_turns=t["plain_ms_turns"], library_ms_turns=t["library_ms_turns"],
            path=path))
    kernels.append(entry(
        "pairwise_alltoall.moe", moon["pairwise_alltoall"], rel(permute.SOURCE),
        permute.REPLACES["pairwise_alltoall"], 1, 0.0, "bitwise",
        padded_bound_ms=moon["pairwise_alltoall"]["padded_bound_ms"],
        path="phase 11b: xla.alltoall at the Moonlight cell's padded exchange"))
    for name, needle in (("pack", "ddp_pack_kernel"), ("update", "ddp_update_kernel")):
        t = train["ddp_step"][name]
        kernels.append({
            "name": needle, "route": "cuda", "source": rel(ddp_step.SOURCE),
            "replaces": "none (the DDP trainer's per-step pass, numpy on the host in "
                        "tpu_mpi/train)",
            "launches": trainers["ddp_step_launches"][name], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "library_call": t["library_call"], "parity": "bitwise",
            "span_ms": t["span_ms"], "library_span_ms": t["library_span_ms"],
            "dtype": t["dtype"], "buckets": t["buckets"], "elements": t["elements"],
            "launches_a_call": t["launches_a_call"],
            "path": f"train: DDPTrainer, {TRAIN_TRAINER_STEPS} steps on {NRANKS} rank "
                    f"threads; times one rank-step a call",
            **{k: v for k, v in t.items() if k.endswith("_turns")}})
    # 13. point-to-point and Cartesian topology on the rank threads
    p2p = p2p_phase(MPI, host, device, caps, copy_gbps, logdir,
                    where)
    # 14. one-sided RMA, MPI-IO and the trainers' checkpoints
    rma = rma_io_ckpt_phase(MPI, host, flat_params(params), device,
                            caps, where)
    # 15. meshes of several axes at the flagship width
    multi = multi_axis_phase(MPI, tr, xla, par, cfg, params, device, logdir, where)
    # 16. the multi-process tier: 4 rank processes on the card
    procs = proc_phase(N_MAIN, where=where)
    # 17. the serve tier: brokers on the card, a tenant fleet, a client
    served17 = serve_phase(MPI, collective, fr, device, where)
    print(json.dumps({"serve": served17}), flush=True)
    # 18. the inference engine at the flagship's width; 19. an elastic
    # resize of the live pool
    infer18 = infer_phase(device, logdir, where)
    elastic19 = elastic_phase(device, where)
    print(json.dumps({"infer": infer18, "elastic": elastic19},
                     default=str), flush=True)
    # 20. the analysis tier: the main path traced, defects on CUDA
    # tensors, the dumps through the analyze CLI, the static passes
    analysis20 = analysis_phase(MPI, host, device, where)
    print(json.dumps({"analysis": analysis20}), flush=True)
    # 21. 0-d operands and complex MAX/MIN on CUDA tensors and cells; the
    # examples through the launcher on the card
    t0 = time.perf_counter()
    zero21 = zero_d_complex_phase(MPI, fr, device)
    log(f"phase 21a: 0-d {zero21['zero_d_dtypes']} Allreduce/Scan/Exscan/"
        f"bcast/Sendrecv and complex MAX/MIN Allreduce and Accumulate with NaN "
        f"and signed-zero elements on {zero21['kinds']}, bit for bit, in "
        f"{zero21['seconds']:.2f} s; fold launches {zero21['fold_launches']}, "
        f"chained folds {zero21['chained_folds']} {where}")
    examples21 = examples_phase(where)
    seconds21 = time.perf_counter() - t0
    example_folds = sum(e["folds"] for e in examples21)
    example_rings = sum(e["ring_allreduce"] for e in examples21)
    log(f"phase 21 in {seconds21:.1f} s: {len(examples21)} example runs, "
        f"{sum(e['seconds'] for e in examples21):.1f} s, fold launches "
        f"{example_folds}, ring_allreduce launches {example_rings} {where}")
    print(json.dumps({"phase21": {"seconds": seconds21, "zero_d_complex": zero21,
                                  "examples": examples21}}), flush=True)
    kernels[0]["launches"] += zero21["fold_launches"] + example_folds
    kernels[0]["phase21_launches"] = zero21["fold_launches"] + example_folds
    ring_entry = next(k for k in kernels if k["name"] == "ring_allreduce")
    ring_entry["launches"] += example_rings
    ring_entry["example_launches"] = example_rings
    for entry_ in kernels:
        key = {"fused_multi_reduce": "folds", "ring_attention": "attention",
               "collective_permute": "permute",
               "pairwise_alltoall": "alltoall"}.get(entry_["name"])
        if key:
            entry_["launches"] += multi["launches"][key]
            entry_["multi_axis_launches"] = multi["launches"][key]
    kernels[0]["multi_axis"] = multi
    kernels[0]["tp_forward_launches"] = tp_folds
    kernels[0]["launches"] += (train_folds + p2p["jacobi_launches"]
                               + rma["rma_launches"] + rma["ckpt_train_launches"]
                               + procs["fold_launches"])
    serve_launches = (sum(served17["fold_launches"].values())
                      + served17["procs"]["fold_launches_by_worker"][0])
    kernels[0]["launches"] += (serve_launches + infer18["fold_launches"]
                               + elastic19["fold_launches"])
    kernels[0]["launches"] += analysis20["fold_launches"]
    kernels[0]["analysis_launches"] = analysis20["fold_launches"]
    kernels[0]["serve_launches"] = serve_launches
    kernels[0]["infer_launches"] = infer18["fold_launches"]
    kernels[0]["elastic_launches"] = elastic19["fold_launches"]
    kernels[0]["numpy_rules"] = {
        "parity": "bit for bit, NaN payloads included",
        "serve_ops": served17["numpy_rules"]["ops"]}
    kernels[0]["proc_launches"] = procs["fold_launches"]
    kernels[0]["procs"] = procs
    kernels[0]["rma_launches"] = rma["rma_launches"]
    kernels[0]["ckpt_train_launches"] = rma["ckpt_train_launches"]
    kernels[0]["rma_io_ckpt"] = rma
    kernels[0]["jacobi_launches"] = p2p["jacobi_launches"]
    kernels[0]["p2p"] = p2p
    kernels[0]["train_launches"] = train_folds
    kernels[0]["train"] = train
    print(card, flush=True)         # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
