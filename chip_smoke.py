#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                   # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal   # plain versions, tiny sizes, no card

Phases, one line or more each; any failure makes the run exit non-zero:

0. the card's name and power limit; builds the CUDA kernels from
   ``src/repro_torch/csrc`` and prints nvcc's ``-Xptxas -v`` report, then
   each decode-attention instantiation's registers and spills from it
   (G = 10's on a line of its own);
1. e2afs sqrt/rsqrt kernel vs its plain version: bit-identical (NaN as NaN)
   over every fp16 and bf16 pattern and the fp32 grid, plus the paper's
   Table 2 example (0x785A -> 0 10110 1000100001); the lean sqrt of the
   Sobel and K-means kernels bit-identical to the general one on every
   positive normal float32 from 1e-12 up (about 1.4 billion patterns); and
   the e2afs kernel's datapath bit-identical to the general one on every
   fp16, bf16 and float32 pattern (2^32 for float32), sqrt and rsqrt;
2. RMSNorm kernel vs plain version at the serving shapes of qwen3-4b and
   gemma3-1b (rows of 1152 and 256), bf16 and fp32, and two calls
   bit-identical;
3. decode-attention kernel vs plain version at the serving widths, bf16 and
   fp32, float and int8 caches, wrap off and on, mixed per-row positions,
   t = 576 and 4096, and at gemma3-1b's (one KV head of 4 query heads,
   head_dim 256, t = 512 and 2112), phase 16's groups (12 and 16 query
   heads on 4 KV heads, 6 on 8, head_dim 128), recurrentgemma-2b's (10
   query heads on 1, head_dim 256, bf16, float and int8 caches, t = 2048
   and 2112) and whisper-small's (12 KV heads of one query head, head_dim
   64, bf16, float and int8 caches, t = 192), two calls bit-identical;
   then the reference kernel's wider domain at b = 8: groups run padded
   (recurrentgemma-2b's rank on a 2-wide 'model' axis, G 5 at head_dim 256,
   t = 2112, a ring, bf16 and int8 caches; G 3 on 8 KV heads and G 7 on 4,
   head_dim 128, t = 576), in passes (G 48 on one KV head), float32 at G 10
   and head_dim 256, and lines of 10 and 12 vectors (G 1 on 32 KV heads,
   head_dim 80 and 96): max |diff|, two calls bit-identical, and the
   kernel's and SDPA's ms by CUDA events beside the byte bound;
4. the main paths, each with the launch counts set to 0 just before and read
   just after: (a) qwen3-4b at full width cut to 12 layers (SERVE_DEPTH;
   every qwen3-4b phase after it runs this model) serving batch 8 (prompt 512, 64
   greedy tokens, cache 576) on the kernels, held against the same weights
   and prompt on the plain versions (8 steps: the first-step logits and
   the first two tokens); (b) the sqrt-unit entry point
   ``get_unit("e2afs", kernel=True)`` on an activation-sized tensor,
   forward and backward (no launch in the backward), outputs and gradients
   held bit-identical to the plain route.  Then (c) a
   small float32 model on the card, kernels vs plain versions (identical
   tokens), with global attention and with every layer a 6-token sliding
   window (a 6-line ring cache, wrapped by the decode positions, and the
   decode-attention launches counted), and ``serve.generate`` at smoke
   width; (d) gemma3-1b at full width (26 layers, 5 window layers of 512 to
   1 global, bf16, batch 8, prompt 2048, 64 greedy tokens, cache 2112), the
   counts set to 0 just before and read just after (6,825 RMSNorm and 1,664
   decode-attention launches, 1,408 with wrap), held to the same contract
   against the plain versions, prefill ms and ms a step beside the decode
   floor reckoned from the weights and the cache;
5. times each kernel, its plain version and a PyTorch yardstick call, both as
   device time per call (torch.profiler) and with CUDA events around
   back-to-back calls, beside the kernel's bound; RMSNorm also at every
   serving shape of phase 2 in bf16 beside F.rms_norm, and decode attention
   also at t = 4096 beside SDPA, both at gemma3-1b's shapes as well, and
   decode attention at G = 12, 6 and 16 (t = 576, b = 8, bf16), at
   G = 10 (hd 256, t = 2048, b = 8, bf16, wrap) and at G = 1 (hd 64, 12
   KV heads, t = 192, b = 8, bf16) beside its plain version, SDPA and the
   byte bound; the e2afs kernel in float32, fp16 and bf16
   at the unit path's 10,485,760 elements, each call on a rotation of
   inputs and outputs over four times the L2, beside its first design;
6. times four full-width decode steps without and then under the profiler:
   the device's idle share of the unprofiled step, top kernels, and the
   device ms a step of decode attention and of RMSNorm by name;
7. Sobel kernel vs its plain version, bit-identical, from 3 x 3 to a
   2160 x 3840 frame;
8. K-means assignment kernel vs its plain version at 256^2 and 1920 x 1080
   pixels, K = 8 and 20, and on the batch of 16 x 512^2 at K = 20 that
   phase 9 quantises: equal assignments and counts, sums within 1e-6
   relative of float64 sums of the same assignments and within 2e-6 of the
   plain version (5e-5 for the batch, whose plain sums are the less exact),
   bit-identical from run to run;
9. the paper's evaluation path (``repro_torch.launch.paper``) on the card,
   with the launch counts set to 0 just before and read just after: Table 3
   equal to its CPU result, Table 4 (kernel route identical to the plain
   route on every image, the paper's PSNR ordering), Fig. 5 (the fused Lloyd
   run against the broadcast one: equal assignments, centroids within 2e-6;
   13 launches per image); then a 1920 x 1080 frame and a batch of 16 images
   of 512 x 512 quantised at K = 20 (wall ms, images/s);
10. the adam kernel vs its plain version, bit-identical on p, m and v: sizes
   1 to 2560 x 9728 (one ``wi_gate``), p and g in float32 and bfloat16,
   steps 1, 2 and 1000, m and v from zero and random, zeros in g; and
   bit-identical from run to run;
11. training qwen3-4b at full width cut to 8 layers (bf16 activations,
   E2AFS in every norm, ``remat="block"``, ``AdamWConfig(fused=True,
   sqrt_unit="e2afs")``, batch 4 x 2048 from ``SyntheticLM``): one warm-up
   step, then four timed steps with the launch counts set to 0 just before
   and read just after (adam launches = parameter tensors x steps; the
   unfused norms' e2afs_rsqrt launches = norms x 2 with block remat, x
   steps); ms/step,
   tokens/s, peak memory, a profiled step's device-busy and adam shares;
   the loss finite and, on the first batch, lower after the steps; one
   step's update on the kernel route bit-identical to the same update on
   the plain route (the clip once, then leaf by leaf);
    11b. the same for gemma3-1b at full width and full depth (26 layers,
   1.0 B parameters), its window layers on the banded chunks, one warm-up
   and two timed steps (no route comparison); 11c and 11d the same for
   mamba2-2.7b and recurrentgemma-2b at full width and depth (2.83 and
   2.89 B parameters, every constant-start leaf moved off its start), the
   launches counted by block: an SSD layer one norm, an RG-LRU layer two
   and one e2afs_sqrt, a window layer two, each twice under block remat;
12. ``launch.train.train_loop`` at smoke width on the card: an aborted and
   resumed run ends on the uninterrupted run's loss (rtol 1e-4);
   microbatches and compressed gradients train with finite losses;
13. the continuous-batching ``launch.engine.Engine``, run right after phase
   6 on the serving models of phases 4a and 4d, its decode chunk of 8
   steps captured once as a CUDA graph and replayed: (a) qwen3-4b with 8
   slots of 576 lines, 24 requests from seed 0 (prompts from {128, 256,
   512}, budgets from {16, 32, 64}, all arriving at 0); (b) gemma3-1b with
   8 slots of 2112 lines, 12 requests (prompts {512, 1000, 2048}, budgets
   {16, 64}).  Each: a replay bit-identical to the same chunk run eagerly
   from one pool state; ms a decode step replayed and eager, the idle
   share of a profiled replay; the trace served with the launch counts set
   to 0 just before and read just after (RMSNorm and decode attention
   exactly what the admissions and chunks imply); 8 requests (the longest
   prompts, then reused slots) token-identical alone in the pool; the
   first two tokens of every request equal to batch-1 ``solo_generate``,
   or parted at a near tie (the solo logit of the engine's token within 4
   ulps at max |logit| of the solo pick);
   makespan and tok/s beside ``run_static_baseline``'s.

14. faults and ladders, run right after phase 13: (a) the faulted E2AFS
   datapath on the card bit-identical to the CPU's on every fp16 and bf16
   pattern and the fp32 grid (both sites, a hashed and a pinned bit, rates
   1e-2 and 1.0), the fault hash's words equal, and the kernel route under
   faults: one launch, the output-register flip of the clean kernel output,
   equal to the plain faulted route wherever the clean output is normal;
   (b) phase 4a's model with the ladder ("e2afs", "esas", "exact"):
   ``decode_slots_scan`` over its 8 slots, 32 steps at levels [0, 1, 2, 0,
   1, 2, 0, 2], every row bit-identical to a run with all slots at its
   level, the all-"exact" run to ``exact_twin``, the all-0 run to the clean
   fused route (tokens, logits and cache: rung 0 runs the fused RMSNorm
   kernel); 49 RMSNorm and 12 decode-attention launches a step; ms a step
   eager; (c) the same model
   under ``sqrt_faults`` (sqrt_man 1e-3) and ``logits_hook`` (logit_nan
   1e-4): two runs bit-identical, rate 0 bit-identical to the clean route,
   the NaN positions the CPU's ``corrupt_logits``, and an ``Engine`` on the
   faulted config replaying its captured chunk bit-identical to the eager
   one; (d) after phase 12, phase 11's model and batch through one forward
   and backward with remat "block", "minimal" and "none" under torch's
   deterministic algorithms: identical loss and gradients, peak memory and
   ms of each.

15. the engine's robustness layers, run right after phase 14c on phase 4a's
   model with phase 13a's engine shape (8 slots of 576 lines, chunks of 8)
   and draw: (a) detectors on: a replay with the health columns
   bit-identical to the eager chunk, ms a replayed step with and without
   detectors in turns, 8 requests token-identical to the engine without
   them (the launch counts set to 0 just before and read just after);
   (b) ``logit_nan`` 3e-7 with one quarantine retry on 8 requests of 16
   tokens: ok or degraded, the ok ones token-identical to (a)'s, the
   degraded ones to ``solo_generate`` on ``exact_twin``, the counters
   agreeing; ``sqrt_exp`` bit 7 at 0.3 on 4: at least one degraded; (c)
   phase 14c's captured engine (``sqrt_man`` 1e-3): ms a step replayed,
   kernels and device time of a profiled replay; (d) ``dispatch`` 0.4:
   tokens identical, every fault retried, an outage before a replay
   raising ``DispatchFault`` with the pool untouched, then ``reset()`` and
   the same engine serving again; (e) 12 requests with a journal and
   ``snapshot_every_chunks=2``, killed at chunk 3 and resumed by
   ``Engine.resume``: every uid finished exactly once with the
   uninterrupted run's tokens, ms to write the snapshot and to
   resume, and the captured engine of (a) restored in place replaying
   bit-identical to its eager chunk; (f) ``python -m
   repro_torch.launch.kill_resume`` on the card, in two processes started
   before (b) and joined after it: a real SIGKILL at smoke width; (g) after
   (e), the accuracy SLO (``Engine(slo=AccuracySLO(...), telemetry=)``):
   canary stride None serving (a)'s 8 requests token-identical to (a)'s
   engine; stride 8 with budgets that never trip token-identical to that,
   canaries counted; a replay with canaries and mixed rungs bit-identical
   to the eager chunk, packed buffer included; under ``sqrt_man`` bit 21
   at rate 1.0 with stride 2 every slot demoted to "exact" and fresh
   requests in the demoted slots token-identical to each alone on
   ``exact_twin`` in a pool of the engine's shape; one telemetry record a
   chunk; ms a replayed step without an SLO and at strides None, 32 and 8,
   kernels a step of each graph, replay against eager with mixed rungs,
   capture ms a graph; (h) after (g), speculative decoding
   (``Engine(spec=SpecConfig(k=4))``, n-gram drafting) on phase 4a's model
   with phase 13a's shape and 24 requests: whether each projection of the
   verify block (8 slots x 5 rows) gives every row the 8-row product's bits
   (else it runs row by row) and the RMSNorm kernel's rows those of 8 rows;
   a replayed spec chunk bit-identical to the eager one, history included;
   ms a replayed spec step and kernels a step; the trace served with the
   launch counts set to 0 just before and read just after (decode attention
   12 x 5 a spec step), every request token-identical to 13a's engine, the
   tokens committed a slot's step, the acceptance rate, ms a committed
   token against 13a's ms a step, makespan and tok/s; then model drafting
   at k = 3 (qwen3-4b's config cut to 4 layers, weights from seed 1) on
   13a's first 8 requests, token-identical to 13a's, the draft model's
   launches counted; (i) the same on phase 4d's gemma3-1b with 13b's shape
   and 12 requests (the 512-line rings wrap and roll back), n-gram at k = 4.

16. the other families, run after 15i, one model on the card at a time
   (freed before the next; each sub-phase's peak memory printed), each
   with the counts set to 0 just before its main path and read just after:
   (a) starcoder2-15b at full width cut to 10 layers (LayerNorm, GELU MLP, 12
   query heads a KV head), e2afs, batch 8, prompt 512, 64 greedy tokens,
   cache 576, held to phase 4a's contract against the same weights on the
   plain versions (21 x 65 e2afs_rsqrt launches, one a LayerNorm; 10 x 64
   decode attention; no RMSNorm), prefill ms and ms a step beside the
   weight-read floor; then an ``Engine`` at 13a's shape and draw: a replay
   bit-identical to the eager chunk, its profile, the trace's launches, 8
   requests token-identical each alone in the pool, makespan and tok/s;
   (b) mixtral-8x22b at full width cut to 4 layers (8 experts of which 2,
   a window stack of 576-line rings) and (c) qwen3-moe-235b-a22b cut to 4
   layers (128 experts of which 8, qk-norm), the same contract held on one
   routing (the plain versions take the kernel route's expert choices; the
   flips of their own routing are printed), the prefill's drops and expert
   load, and for (c) 13a's engine; (d) internvl2-76b at full width cut to 2
   layers: ``forward`` over 1024 vision and 512 text tokens, batch 2, its
   5 e2afs_rsqrt launches counted, logits within 4 ulps of the plain route.

17. the recurrent families, after 16d, one model on the card at a time,
   each at full width cut to SERVE_DEPTH's depth, bf16, e2afs, weights from seed 0 with
   every constant-start leaf moved off its start (a fresh RG-LRU block
   computes nothing), the counts set to 0 just before its main path and read
   just after: (a) mamba2-2.7b (16 SSD layers, 80 heads; 1,105 RMSNorm
   launches) and (b) recurrentgemma-2b (6 RG-LRU and 3 window layers;
   1,235 RMSNorm, 390 ``e2afs_sqrt``, one an RG-LRU layer a forward, and
   192 decode attention at G = 10, all "wrap"), batch 8, prompt 2048, 64
   greedy tokens, cache 2112; first-step logits against the plain versions
   within the larger of 4 bf16 ulps and twice the plain versions' own
   spread under another order of the norms' sums (mamba2's full 64-layer stack
   carries a one-ulp norm difference past 4 ulps), the first token
   wherever the plain top-2 margin exceeds twice the diff (the count of such
   slots printed); then the same weights with float32 activations held to
   a fixed limit, decode attention on the kernel (recurrentgemma-2b: a
   float32 line of head_dim 256 at G = 10; a "wrap" launch a window layer a
   step, asserted): first-step logits within 4 bf16 ulps of the largest
   |logit| and the first two tokens 8 of 8; prefill ms and ms
   a step beside the floor of the bytes a step moves; then phase 13b's
   engine shape (8 slots of 2112, 12 requests, prompts {512, 1000, 2048}):
   a replay bit-identical to the eager chunk, its profile, the trace's
   launches, 8 requests token-identical alone, and canaries at stride 8
   that never trip serving the same tokens.

18. whisper-small, after 17b, at full width and depth (12 encoder and 12
   decoder layers, d 768, LayerNorm, GELU, sinusoidal positions), e2afs,
   weights from seed 0 with every constant-start leaf moved off its start:
   (a) seeded audio (8, 1500, 768), ``precompute_cross``, ``prefill`` of a
   128-token prompt and 64 greedy tokens (cache 192), the counts set to 0
   just before and read just after (an e2afs_rsqrt a LayerNorm: 25 for the
   encoder, 37 a decoder forward; decode attention at G = 1, head_dim 64,
   12 a step, none with wrap); first-step logits within 4 bf16 ulps of the
   same weights on the plain versions and the first two tokens 8 of 8, in
   bf16 and with float32 activations; the encoder's ms, prefill ms and ms a
   step beside the floor of the decoder weights, unembed, cross K/V and
   cache over 3.35 TB/s; one ``decode_slots_step(cross_kv=)`` captured as a
   CUDA graph, its replay bit-identical to the eager step, ms a step of
   each; two requests admitted at staggered steps each equal to itself
   alone; (b) training at batch 4 x 448 text tokens and 1500 audio frames,
   remat "block", fused AdamW, phase 11b's run (e2afs_rsqrt counted: the
   encoder's and the decoder's norms twice, the final norms once).

19. sharded serving, after 18b, on a one-device mesh: a one-rank NCCL
   process group and ``make_production_mesh(shape=(1, 1))`` (the host has
   one card; collectives across ranks are held on 4 gloo ranks on the
   CPU), destroyed at the end of the phase, on phase 4a's and 4d's models:
   (a) ``Engine(mesh=, rules=serve_rules(..., replicate_params=True))`` at
   13a's shape serving 13a's 24 requests, the counts set to 0 just before
   and read just after: tokens bit-identical to 13a's, RMSNorm and decode
   attention launches equal to 13a's, every pool DTensor on the placements
   ``serve_pool_shardings`` gives after the run, ms a replayed step and
   the makespan beside 13a's; (b) the same under the default
   tensor-parallel ``serve_rules`` (a one-wide 'model' axis splits no
   sum: the same tokens); (c) 13b's shape and 12 requests on gemma3-1b's
   ring cache in exact mode, tokens equal to 13b's, and the int8 cache at
   13a's shape on 8 requests equal to the unsharded int8 engine; (d) 12 of
   13a's requests with a journal and ``snapshot_every_chunks=2``, killed
   at chunk 3 and resumed by ``Engine.resume`` from one device onto the
   mesh and from the mesh onto one device: every uid finished exactly once
   with 13a's tokens; (e) phase 4a's model, prompt and shapes through
   ``lm.prefill``/``generate_scan`` with ``mesh=``: 4a's tokens; and
   ``serve.generate(mesh=)`` at smoke width and 4a's batch, prompt and
   length equal to it without; (f) phase 14c's faulted engine (``sqrt_man``
   1e-3 in every norm, 8 slots of 576 lines, its 8 requests) in exact mode
   and under the tensor-parallel rules: 14c's tokens (run in 15c), ms a
   replayed step beside 14c's; (g) phase 15g's SLO engines in exact mode:
   stride 8's tokens and canary counters, ms a replayed step beside 15g's,
   and the pressure run's demotions, rungs and probe tokens; (h) runs
   inside phases 16a-c, 17a-b and 18a (the mesh is made on first use
   there and destroyed at the end of 19): each family's model, prompt and
   shape as that phase built them (starcoder2-15b at 10 layers,
   mixtral-8x22b and qwen3-moe-235b-a22b at 4, mamba2-2.7b, recurrentgemma-2b,
   whisper-small) through ``lm.precompute_cross``/``prefill``/
   ``generate_scan(mesh=)`` under the default tensor-parallel rules: the
   first 16 of the phase's tokens, the kernels its main path launched, ms
   a step beside the phase's.
20. the tooling, after 14d: the kernel registry's seven names (the script
   refuses to start with ``REPRO_KERNEL_BACKEND`` other than "auto" or with
   ``REPRO_AUTOTUNE`` on, and gives the run an empty tune cache of its own,
   so every launch takes its tile's prior); each tiled kernel (e2afs
   sqrt/rsqrt, RMSNorm, Sobel, adam) at phase 5's shapes (and phase 4a's
   qk-norm rows): every candidate tile bit-identical to the default and
   timed (device time by the profiler, and CUDA events around 20 calls),
   a sweep into a temporary ``REPRO_TUNE_CACHE`` that persists its winner
   and a next call that is a cache hit launching it, an untuned call that
   launches today's tile (the spec's default), the roofline prior's pick
   printed beside the winner and today's launch, and the H100 model's step
   overhead fitted from this run; then, after the timed phases, a
   subprocess of its own (phase 19 held a real process group): a qwen3-4b
   decode step at 4a's shapes (batch 8, cache 576) counted by
   ``launch/op_cost.py`` on real tensors against ``dryrun.lower_cell`` of
   the same step on fake tensors on a one-rank mesh (dot flops equal,
   bytes within 1%, the same launches, the dry run's peak within
   0.8-1.25x the real ``max_memory_allocated``, and its step's own peak,
   less the arguments, within 0.8-1.25x the real step's increase over
   ``memory_allocated`` before it), its roofline memory term beside 13a's
   replayed step, and the dry run's CLI at production size: qwen3-4b
   ``decode_32k --mesh both`` and mamba2-2.7b ``long_500k --mesh single``,
   each ok; and a train step at phase 11's shape (qwen3-4b, 8 layers, batch
   4 x 2048, block remat, fused AdamW) counted on real tensors against
   ``lower_cell`` of the same step under ``train_rules`` on a one-rank mesh
   with the same ``AdamWConfig``: dot flops and launches equal, the dry
   run's peak within 5% of the real ``max_memory_allocated``;
21. the sharded train step on a one-device mesh, last: phase 11's
   config, start and batches, two steps unsharded and then two under
   ``train_rules`` on one NCCL rank (``place_train_state``,
   ``make_train_step(mesh=)``), each run with the launch counts set to 0
   just before and read just after: the losses, grad norms and every
   updated leaf of params, m and v bit-identical (a one-wide mesh splits
   no sum), the same launches (adam a leaf a step: no plain route), and
   ms a step beside phase 11's.

Before the last line it prints the card's name and power limit and one JSON
line of kernels; the last line is ``{"ok": true, "device": {...}}``.  Without
a card, or outside a checkout of the repository, it exits non-zero and
prints no result.  It imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
# bytes a rotation of inputs and outputs spans so that each call meets its
# data cold: four times the H100's 50 MB L2
COLD_BYTES = 4 * 50 * 2**20
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# Scalar pipes of the H100 SXM (Hopper white paper: 132 SMs, each with 128
# FP32 and 64 INT32 lanes, at the 1.98 GHz boost clock): a float32 add, mul
# or compare is one operation (the 67 TFLOP/s above counts an FMA as two),
# an integer operation runs on the INT32 lanes, and both share the SM's 128
# issue slots a clock.
FP32_OPS_PER_S = 132 * 128 * 1.98e9  # 33.45e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 16.73e12
# Integer operations of one E2AFS sqrt of a positive normal float32 w (both
# kernels clamp their input to at least 1e-9 or 1e-12 first, so no zero test
# is needed), at the fewest Hopper instructions the datapath allows: mantissa
# (LOP3), y_hi and exponent-parity predicates (2 LOP3), even path one +
# (man >> 1) then - C_EVEN under y_hi (LEA.HI, predicated IADD), odd path
# man + C_ODD under y_hi, t = one + (man >> 2), t + (t >> 1) (IADD, 2 LEA.HI),
# the select (SEL), ovf = res >> 24 and res >> ovf (2 SHF), exponent
# ((w >> 23) + 125) >> 1 + ovf (2 LEA.HI; (r >> 1) + bias without the parity
# select, one less for the compose), compose (exp << 23) + res (LEA).  The
# compiled count is read from the SASS in phase 5.
E2AFS_SQRT_INT_OPS = 14

# kmeans_assign's colour sums, relative: the kernel against float64 sums of
# the same assignments (its own rounding, a fixed tree: it read 7.1e-8 to
# 1.4e-7 at every shape of phase 8 on an H100), and the kernel against the
# plain version, whose float32 one-hot matmul sums in cuBLAS's order.  That
# order is the plain version's own error: one image read 2.9e-7 to 5.6e-7
# from float64, but the batched matmul of the 16 x 512^2 deployment batch
# read 2.86e-5, so the batch has a limit of its own, and the float64 limit
# above is what holds the kernel there.
KERNEL_SUMS_LIMIT = 1e-6
PLAIN_SUMS_LIMIT = 2e-6
PLAIN_BATCH_SUMS_LIMIT = 5e-5

# torch.profiler windows tried before a timing fails: on the H100 machines a
# window now and then sees no device time or misses a launch, at worst three
# windows in a row so far.
PROFILER_WINDOWS = 10
# decode steps of the plain-version reruns of phases 4a and 4d: their
# contract holds the first-step logits and the first two tokens (later
# tokens part on near ties by design, so their agreement is only printed)
PLAIN_STEPS = 8
# Depth of the full-width serving models that the run drives most: phase 4a's
# qwen3-4b (and every phase 13-15 and 19 that runs on it, and phase 20's
# subprocess), 16a's starcoder2-15b and 17's recurrent families.  At their
# published depths (36, 40, 64 and 26 layers) the phases took 855-1180 s on
# H100 hosts, too close to the run's 1200 s limit; at these the run aims at
# half of it.  Widths, shapes and the mix of layers stay; every launch count
# the phases hold follows cfg.n_layers.  Training (11-11d) keeps full depth.
SERVE_DEPTH = {"qwen3-4b": 12, "starcoder2-15b": 10, "mamba2-2.7b": 16,
               "recurrentgemma-2b": 9}

KERNELS = {
    "e2afs_sqrt": ("src/repro_torch/csrc/e2afs_sqrt.cu",
                   "src/repro/kernels/e2afs_sqrt/e2afs_sqrt.py:26"),
    "e2afs_rsqrt": ("src/repro_torch/csrc/e2afs_sqrt.cu",
                    "src/repro/kernels/e2afs_sqrt/e2afs_sqrt.py:26"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/rmsnorm.py:32"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/attention/attention.py:62"),
    "sobel": ("src/repro_torch/csrc/sobel.cu", "src/repro/kernels/sobel/sobel.py:23"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans/kmeans.py:30"),
    "adam": ("src/repro_torch/csrc/adam.cu", "src/repro/kernels/adam/adam.py:28"),
}

# the fused AdamW step moves 4 streams in and 3 out: float32 p, g, m, v in
# and p, m, v out, 28 bytes a parameter
ADAM_BYTES_PER_PARAM = 28


def cold(fn, inputs):
    """A call of fn on each input in turn, each output kept until its input
    comes round again: every call reads and writes memory that the
    len(inputs) - 1 calls before it did not touch."""
    outputs = [None] * len(inputs)
    turn = itertools.count()

    def call():
        i = next(turn) % len(inputs)
        outputs[i] = fn(inputs[i])
        return outputs[i]

    return call


def ops_bound_ms(fp_ops, int_ops):
    """Least time for these scalar operations: the INT32 lanes or the SM's
    issue slots, whichever is slower."""
    return max(int_ops / INT32_OPS_PER_S, (fp_ops + int_ops) / FP32_OPS_PER_S) * 1e3


# SASS opcodes by the pipe they issue to (the rest: loads, moves, branches)
SASS_FLOAT = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL"}
SASS_INT = {"IADD3", "VIADD", "IMAD", "LOP3", "SHF", "LEA", "SEL", "ISETP", "IMNMX", "VIMNMX",
            "PRMT", "SGXT", "BMSK", "IABS", "FLO", "POPC"}


def sass_per_pair(lib):
    """Compiled instructions per (pixel, centroid) pair of kmeans_assign's
    distance loop, from ``cuobjdump -sass`` of its library: the backward
    branch whose body holds the most FMULs is the unrolled loop over
    centroids, and every pair in it has exactly three FMULs (d0^2, d1^2,
    d2^2, which __fmul_rn keeps apart).  Returns (pairs in the body,
    {opcode: count per pair})."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    func = next(part for part in out.split("Function : ")[1:]
                if part.split(None, 1)[0].find("assign_kernel") >= 0)
    labels, insts = {}, []  # insts: (address, opcode, operands)
    for line in func.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = None  # the address of the next instruction
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);",
                     line)
        if m:
            addr = int(m.group(1), 16)
            for key, val in labels.items():
                if val is None:
                    labels[key] = addr
            insts.append((addr, m.group(2), m.group(3)))
    best = None
    for addr, op, args in insts:
        if op.split(".")[0] != "BRA":
            continue
        tgt = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", args)
        if not tgt:
            continue
        to = int(tgt.group(1), 16) if tgt.group(1) else labels.get(tgt.group(2))
        if to is None or to > addr:
            continue
        body = [o.split(".")[0] for a, o, _ in insts if to <= a <= addr]
        if best is None or body.count("FMUL") > best.count("FMUL"):
            best = body
    if not best or best.count("FMUL") % 3:
        raise RuntimeError("no loop with a multiple of three FMULs in assign_kernel's SASS")
    pairs = best.count("FMUL") // 3
    return pairs, {op: c / pairs for op, c in sorted(collections.Counter(best).items())}


def ptxas_summary(log):
    """Registers and spills of each decode_attention_kernel instantiation,
    read from nvcc's -Xptxas -v report: [{"kernel": "T, KV, G, NV", ...}]."""
    import re

    section = log.split("== nvcc decode_attention.cu", 1)[-1].split("== nvcc ", 1)[0]
    names = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8"}
    rows, current = [], None
    for line in section.splitlines():
        m = re.search(r"Function properties for (\S*decode_attention_kernel\S*)", line)
        if m:
            t = re.search(r"decode_attention_kernelI(13__nv_bfloat16|f)(S\d*_|13__nv_bfloat16|f|a)"
                          r"Li(\d+)ELi(\d+)E", m.group(1))
            if t:  # a substitution (S<n>_) repeats T
                kv = t.group(1) if t.group(2).startswith("S") else t.group(2)
                current = {"kernel": f"{names[t.group(1)]}, {names.get(kv, kv)}, G={t.group(3)}, "
                                     f"NV={t.group(4)}"}
                rows.append(current)
            else:
                current = None
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            current = None
    return [r for r in rows if "registers" in r]


def ulp_of(r):
    """One unit in the last place of each element of r, in r's own dtype."""
    import torch

    man_bits = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[r.dtype]
    _, e = torch.frexp(r.float())
    return torch.ldexp(torch.ones_like(r, dtype=torch.float32), e - 1 - man_bits)


def same_bits(a, b):
    """Elementwise: the same bits, or NaN in both."""
    import torch

    ib = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.view(ib) == b.view(ib)) | (torch.isnan(a) & torch.isnan(b))


def normal_mask(y):
    """Elementwise: a normal number in y's format."""
    import torch

    man_bits = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[y.dtype]
    exp_bits = {torch.bfloat16: 8, torch.float16: 5, torch.float32: 8}[y.dtype]
    ib = {2: torch.int16, 4: torch.int32}[y.element_size()]
    exp = (y.view(ib).to(torch.int64) >> man_bits) & ((1 << exp_bits) - 1)
    return (exp > 0) & (exp < (1 << exp_bits) - 1)


def trace(cfg, n, prompts, budgets):
    """n requests from seed 0, all arriving at 0: prompt lengths and budgets
    drawn from the given sets (phases 13 and 15 share the draw)."""
    import numpy as np

    from repro_torch.launch.engine import Request

    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.choice(prompts))).astype(
                np.int32), max_new_tokens=int(rng.choice(budgets))) for i in range(n)]


class Smoke:
    def __init__(self, rehearsal: bool):
        import torch

        self.torch = torch
        self.rehearsal = rehearsal
        self.dev = torch.device("cpu" if rehearsal else "cuda")
        self.failed = []
        self.rows = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep}
                     for name, (src, rep) in KERNELS.items()}
        self.card = "rehearsal on the CPU: no card"
        self.training = {}
        self.serving = self.gemma = None
        self.serve_tokens = None  # phase 4a's greedy tokens
        # phase 14c's faulted engine, phase 15a's engines, phase 15f's process
        self.faulted_engine = self.robust = self.sigkill = None
        self.anchor = None  # phase 15a's requests and tokens
        self.engine_runs = {}  # phases 13a's and 13b's traces, tokens and replayed ms a step
        self.spec_routes, self.spec_runs = {}, {}  # phases 15h/15i: GEMM routes, spec steps
        self.family = {}  # phase 16: serving numbers by model
        # phase 19f-g's references: 14c's faulted engine's tokens (15c), the
        # SLO engines' (15g)
        self.faulted_ref = self.slo_ref = None
        self.mesh = None  # the one-device mesh of 16-19 (:meth:`one_mesh`)
        self.tiles, self.dry = {}, None  # phase 20: tile times, the dry run's numbers

    # -- helpers -----------------------------------------------------------
    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:  # a failed phase fails the run; the next phases still report
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            self.failed.append(name)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, iters=30):
        """Mean ms per call from CUDA events (None in a rehearsal)."""
        if self.rehearsal:
            fn()
            return None
        torch = self.torch
        t_end = time.perf_counter() + 0.05  # warm-up: at least 3 calls and 50 ms
        n = 0
        while n < 3 or time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
            n += 1
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def profiled(self, fn, iters, every_launch=False):
        """Run fn iters times under torch.profiler; returns (host wall us,
        [(device us, calls, kernel name)] sorted, largest first).  Only
        device-side events: an operator's own entry repeats its kernels'.

        A profiler window on the card now and then comes back without device
        events, or with only some of a kernel's launches: such a window is
        thrown away and the calls run again, up to PROFILER_WINDOWS windows,
        and the run fails if none saw device time (with every_launch, if none
        saw every launch: each call launches the same kernels, so every
        count is a multiple of iters).  A CPU rehearsal takes one window."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([] if self.rehearsal else [ProfilerActivity.CUDA])
        for window in range(1, PROFILER_WINDOWS + 1):
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                self.sync()
                wall_us = (time.perf_counter() - t0) * 1e6
            rows = []
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(e, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(e, "self_cuda_time_total", 0.0)
                if dev_us > 0:
                    rows.append((dev_us, e.count, e.key))
            rows.sort(reverse=True)
            if self.rehearsal or rows and not (every_launch and
                                               any(r[1] % iters for r in rows)):
                return wall_us, rows
            print(f"  (profiler window {window} saw "
                  f"{'launch counts ' + str([r[1] for r in rows]) if rows else 'no device time'}"
                  f" for {iters} calls)")
        raise AssertionError(f"none of {PROFILER_WINDOWS} profiler windows saw "
                             f"{'every launch of the calls' if every_launch else 'device time'}")

    def device_ms(self, fn, iters=20):
        """Device time per call: the kernels' own time under torch.profiler,
        summed, over iters calls (None in a rehearsal).  Unlike CUDA events
        around back-to-back calls, it leaves out the host's launch gaps."""
        if self.rehearsal:
            return None
        fn()
        self.sync()
        _, rows = self.profiled(fn, iters, every_launch=True)
        return sum(r[0] for r in rows) / iters / 1e3

    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    # -- phase 0 -----------------------------------------------------------
    def p0_build(self):
        torch = self.torch
        if not self.rehearsal:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60)
            self.card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
                f"nvidia-smi failed: {smi.stderr.strip()}")
            print(f"card: {self.card}")
            print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.rehearsal:
            from repro_torch.kernels import _build

            print(_build.constants_header())
            return
        from repro_torch.kernels import _build

        report = _build.build()
        print(report.log)
        print(f"build: {report.seconds:.1f} s into {report.directory}")
        self.rows["decode_attention"]["ptxas"] = rows = ptxas_summary(report.log)
        print("decode_attention instantiations (T, KV, G, NV): registers, spill stores/loads "
              "bytes, from the -Xptxas -v report above:")
        for r in rows:
            print(f"  {r['kernel']}: {r['registers']} registers, {r['spill_stores']} / "
                  f"{r['spill_loads']} bytes spilled, {r['stack']} bytes stack")
        ten = [r for r in rows if "G=10," in r["kernel"]]
        print(f"  G = 10 (recurrentgemma-2b): {len(ten)} instantiations, registers "
              f"{sorted({r['registers'] for r in ten})}, spilled bytes "
              f"{sum(r['spill_stores'] + r['spill_loads'] for r in ten)}")
        if not ten:
            raise AssertionError("no G = 10 instantiation in the ptxas report")

    # -- phase 1 -----------------------------------------------------------
    def p1_e2afs(self):
        torch = self.torch
        from repro_torch.core.metrics import sampled_normal_values
        from repro_torch.kernels.e2afs_sqrt import ops, ref

        int_of = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
                  torch.float32: torch.int32}
        inputs = {
            "fp16": torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.float16),
            "bf16": torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16),
            "fp32 grid": sampled_normal_values(),
        }
        for label, x in inputs.items():
            x = x.to(self.dev)
            for fn, plain in ((ops.sqrt, ref.ref_sqrt), (ops.rsqrt, ref.ref_rsqrt)):
                y, r = fn(x), plain(x)
                self.sync()
                ib = int_of[x.dtype]
                same = (y.view(ib) == r.view(ib)) | (torch.isnan(y) & torch.isnan(r))
                bad = int((~same).sum())
                print(f"  e2afs {fn.__name__:5s} {label:9s} n={x.numel()}: {bad} differing patterns")
                if bad:
                    raise AssertionError(f"e2afs {fn.__name__} {label}: {bad} patterns differ")
        x = torch.tensor([0x785A], dtype=torch.int16).view(torch.float16).to(self.dev)
        bits = int(ops.sqrt(x).view(torch.int16).item()) & 0xFFFF
        print(f"  Table 2: sqrt(0x785A) -> {bits >> 15} {bits >> 10 & 31:05b} {bits & 1023:010b}")
        if bits != 0b0_10110_1000100001:
            raise AssertionError(f"Table 2 example gives {bits:#06x}")
        for name in ("e2afs_sqrt", "e2afs_rsqrt"):
            self.rows[name]["max_abs_err"] = 0.0
        # the lean sqrt of the Sobel and K-means kernels against the general
        # one, over every positive normal float32 pattern from 1e-12 to +inf
        # (excluded), in chunks of 2^28 on the card
        if self.rehearsal:
            print("  lean sqrt and kernel datapath vs general datapath: checks of the CUDA "
                  "datapath, not run on the CPU")
            return
        first, last, chunk = int(torch.tensor(1e-12).view(torch.int32)), 0x7F800000, 1 << 28
        bad = sum(ops.sqrt_normal_mismatches(lo, min(lo + chunk, last), self.dev)
                  for lo in range(first, last, chunk))
        print(f"  lean sqrt (sobel, kmeans_assign) vs general sqrt: {bad} of {last - first} "
              f"positive normal float32 patterns from 1e-12 up differ")
        if bad:
            raise AssertionError(f"the lean sqrt differs from the general one on {bad} patterns")
        # the elementwise kernel's datapath against the general one, on every
        # pattern of each format, by vectors and one value at a time
        for dtype in (torch.float16, torch.bfloat16, torch.float32):
            for rsqrt in (False, True):
                bad = ops.unit_mismatches(dtype, rsqrt=rsqrt, device=self.dev)
                total = 1 << torch.finfo(dtype).bits
                print(f"  kernel datapath {'rsqrt' if rsqrt else 'sqrt':5s} {str(dtype):14s} vs "
                      f"general datapath: {bad} of {total} patterns differ")
                if bad:
                    raise AssertionError(f"the kernel's {dtype} datapath differs on {bad} patterns")

    # -- phase 2 -----------------------------------------------------------
    def rms_inputs(self, rows, d, dtype, seed):
        torch = self.torch
        g = self.gen(seed)
        x = torch.randn(rows, d, generator=g, device=self.dev).to(dtype)
        s = (0.1 * torch.randn(d, generator=g, device=self.dev)).to(dtype)
        return x, s

    def p2_rmsnorm(self):
        torch = self.torch
        from repro_torch.kernels.rmsnorm import ops, ref

        # every shape the serving path gives the kernel: decode ln (b, d),
        # prefill ln (b * prompt, d), decode qk-norm (b * h, hd) and
        # (b * kv, hd), prefill qk-norm (b * prompt * h, hd) and
        # (b * prompt * kv, hd); and (b * 128, d)
        b, s_len, h, kv = (2, 16, 4, 2) if self.rehearsal else (8, 512, 32, 8)
        shapes = [(b, 2560), (b * 128, 2560), (b * s_len, 2560), (b * h, 128), (b * kv, 128),
                  (b * s_len * kv, 128), (b * s_len * h, 128)] + self.gemma_rms_shapes()
        worst = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            for rows, d in shapes:
                x, s = self.rms_inputs(rows, d, dtype, rows + d)
                for label, scale in (("scale", s), ("zero scale", torch.zeros_like(s))):
                    y, r = ops.rmsnorm(x, scale), ref.ref_rmsnorm(x, scale)
                    again = ops.rmsnorm(x, scale)
                    self.sync()
                    if not torch.equal(y, again):
                        raise AssertionError(f"rmsnorm {dtype} ({rows}, {d}): two calls differ")
                    diff = (y.float() - r.float()).abs()
                    err = float(diff.max())
                    ulps = float((diff / ulp_of(r)).max())
                    rel = float((diff / r.float().abs().clamp_min(1e-30)).max())
                    print(f"  rmsnorm {str(dtype):14s} ({rows}, {d}) {label:10s}: max |diff| "
                          f"{err:.3e}, {ulps:.2f} ulp, relative {rel:.2e}")
                    # Only the order of the float32 sum differs.  float32:
                    # within 1e-6 relative.  bf16: T(x * inv) within one ulp
                    # (zero scale shows it bare); the (1 + scale) multiply
                    # stretches that step and rounds again, so two ulps.
                    limit = 1.0 if label == "zero scale" else 2.0
                    if (ulps > limit) if dtype == torch.bfloat16 else (rel > 1e-6):
                        raise AssertionError(f"rmsnorm {dtype} ({rows}, {d}) {label} out of "
                                             f"tolerance")
                    if dtype == torch.bfloat16 and label == "scale":
                        worst = max(worst, err)
        self.rows["rmsnorm"]["max_abs_err"] = worst

    def gemma_rms_shapes(self):
        """The rows gemma3-1b's serving path gives the RMSNorm kernel (batch
        8, prompt 2048): decode and prefill layer norms of 1152, decode
        qk-norm rows of 256 (4 query heads, 1 KV head) and prefill ones."""
        b, s_len = (2, 24) if self.rehearsal else (8, 2048)
        return [(b, 1152), (b * s_len, 1152), (b * 4, 256), (b, 256), (b * s_len, 256),
                (b * s_len * 4, 256)]

    # -- phase 3 -----------------------------------------------------------
    def attn_inputs(self, b, h, kv, hd, t, dtype, quant, seed, pos=None):
        torch = self.torch
        g = self.gen(seed)
        q = torch.randn(b, h, hd, generator=g, device=self.dev).to(dtype)
        if quant:
            def ints():
                return torch.randint(-127, 128, (b, t, kv, hd), generator=g, device=self.dev,
                                     dtype=torch.int32).to(torch.int8)

            k, v = ints(), ints()
            ks = torch.rand(b, t, kv, generator=g, device=self.dev) * 0.02 + 1e-3
            vs = torch.rand(b, t, kv, generator=g, device=self.dev) * 0.02 + 1e-3
        else:
            k = torch.randn(b, t, kv, hd, generator=g, device=self.dev).to(dtype)
            v = torch.randn(b, t, kv, hd, generator=g, device=self.dev).to(dtype)
            ks = vs = None
        if pos is None:  # mixed rows: start, middle, last line, past the end
            pos = torch.tensor([0, 3, t // 2, t - 2, t - 1, t, t + 100, 3 * t][:b],
                               dtype=torch.int32, device=self.dev)
        return q, k, v, pos, ks, vs

    def p3_attention(self):
        torch = self.torch
        from repro_torch.kernels.attention import ops

        b, h, kv, hd = (4, 8, 2, 32) if self.rehearsal else (8, 32, 8, 128)
        lengths = (24, 64) if self.rehearsal else (576, 4096)
        for dtype in (torch.bfloat16, torch.float32):
            for t in lengths:
                for quant in (False, True):
                    for wrap in (False, True):
                        args = self.attn_inputs(b, h, kv, hd, t, dtype, quant, t + quant)
                        r = ops.ref_decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                        y = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                        again = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                        self.sync()
                        if not torch.equal(y, again):
                            raise AssertionError("decode attention: two calls differ")
                        split = ("" if self.rehearsal else
                                 " (S={chunks} of {chunk_lines} lines)".format(
                                     **ops.plan(*args[:2])))
                        self.check_attention(y, r, dtype, f"t={t:5d} int8={quant!s:5s} "
                                             f"wrap={wrap!s:5s}{split}")
                        if (dtype == torch.bfloat16 and t == lengths[0] and not quant
                                and not wrap):
                            self.rows["decode_attention"]["max_abs_err"] = float(
                                (y.float() - r.float()).abs().max())
        # gemma3-1b's decode layer: one KV head of four query heads, head_dim
        # 256 (a float32 line is 64 vectors, two a lane), a window layer's
        # 512-line ring and a global layer's 2112 lines
        b, h, kv, hd = (8, 4, 1, 256)
        for dtype in (torch.bfloat16, torch.float32):
            for t in ((24, 40) if self.rehearsal else (512, 2112)):
                for quant in (False, True):
                    for wrap in (False, True):
                        args = self.attn_inputs(b, h, kv, hd, t, dtype, quant, t + 3 + quant)
                        r = ops.ref_decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                        y = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                        again = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                        self.sync()
                        if not torch.equal(y, again):
                            raise AssertionError("decode attention: two calls differ")
                        split = ("" if self.rehearsal else
                                 " (S={chunks} of {chunk_lines} lines)".format(
                                     **ops.plan(*args[:2])))
                        self.check_attention(y, r, dtype, f"gemma3-1b kv=1 g=4 hd=256 t={t:5d} "
                                             f"int8={quant!s:5s} wrap={wrap!s:5s}{split}")
        # the groups of phase 16's models at hd 128: starcoder2-15b's 12 and
        # qwen3-moe-235b-a22b's 16 query heads on 4 KV heads, mixtral-8x22b's
        # 6 on 8 (G = 6 and 12 shuffle each head, 16 halves them)
        b, hd = (4, 32) if self.rehearsal else (8, 128)
        for g, kv in ((12, 4), (6, 8), (16, 4)):
            for dtype in (torch.bfloat16, torch.float32):
                for t in lengths:
                    for quant in (False, True):
                        for wrap in (False, True):
                            args = self.attn_inputs(b, g * kv, kv, hd, t, dtype, quant,
                                                    t + g + quant)
                            r = ops.ref_decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                            y = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                            again = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                            self.sync()
                            if not torch.equal(y, again):
                                raise AssertionError("decode attention: two calls differ")
                            split = ("" if self.rehearsal else
                                     " (S={chunks} of {chunk_lines} lines, {slots} slots a "
                                     "launch)".format(**ops.plan(*args[:2])))
                            self.check_attention(y, r, dtype, f"kv={kv} g={g:2d} hd={hd} "
                                                 f"t={t:5d} int8={quant!s:5s} "
                                                 f"wrap={wrap!s:5s}{split}")

        # recurrentgemma-2b's window layers: one KV head of 10 query heads
        # (per-head shuffles; the warps' partial outputs go through the ring
        # in two passes), head_dim 256, bf16, its 2048-line ring and 2112
        b, h, kv, hd = (8, 10, 1, 256)
        for t in ((24, 40) if self.rehearsal else (2048, 2112)):
            for quant in (False, True):
                for wrap in (False, True):
                    args = self.attn_inputs(b, h, kv, hd, t, torch.bfloat16, quant, t + 10 + quant)
                    r = ops.ref_decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                    y = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                    again = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                    self.sync()
                    if not torch.equal(y, again):
                        raise AssertionError("decode attention: two calls differ")
                    split = ("" if self.rehearsal else
                             " (S={chunks} of {chunk_lines} lines, {slots} slots a "
                             "launch)".format(**ops.plan(*args[:2])))
                    self.check_attention(y, r, torch.bfloat16, f"recurrentgemma-2b kv=1 g=10 "
                                         f"hd=256 t={t:5d} int8={quant!s:5s} "
                                         f"wrap={wrap!s:5s}{split}")

        # whisper-small's decoder self-attention: 12 KV heads of one query
        # head each (G = 1), head_dim 64 (8 lanes a bf16 line), b = 8, its
        # 192-line cache, bf16, float and int8 caches
        b, h, kv, hd, t = (8, 12, 12, 64, 24 if self.rehearsal else 192)
        for quant in (False, True):
            for wrap in (False, True):
                args = self.attn_inputs(b, h, kv, hd, t, torch.bfloat16, quant, t + 12 + quant)
                r = ops.ref_decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                y = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                again = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                self.sync()
                if not torch.equal(y, again):
                    raise AssertionError("decode attention: two calls differ")
                split = ("" if self.rehearsal else
                         " (S={chunks} of {chunk_lines} lines, {slots} slots a "
                         "launch)".format(**ops.plan(*args[:2])))
                self.check_attention(y, r, torch.bfloat16, f"whisper-small kv=12 g=1 hd=64 "
                                     f"t={t:5d} int8={quant!s:5s} wrap={wrap!s:5s}{split}")

        self.attention_domain()

    def attention_domain(self):
        """decode_attention.cu over the reference kernel's shape domain at b =
        8: groups it runs padded (recurrentgemma-2b's rank on a 2-wide
        'model' axis, G 5 as 6; Llama-3.2-3B's G 3 as 4; Qwen2.5-7B's G 7 as
        8), in passes (G 48 over one KV head: three of 16), float32 at G 10
        and head_dim 256 (two vectors a lane), and lines of 10 and 12 vectors
        (phi-2's head_dim 80, Phi-3-mini's 96).  Each shape: max |diff| from
        the plain version (wrap off and on, mixed per-row positions), a
        bit-identical second call, then at every line live the kernel's and
        SDPA's ms per call by CUDA events over copies of the cache that
        stream past the L2, beside the byte bound."""
        torch = self.torch
        F = torch.nn.functional
        from repro_torch.kernels.attention import ops

        rows = self.rows["decode_attention"]["domain_shapes"] = []
        # (label, kv, g, hd, t, dtype, int8 cache, ring)
        shapes = (("recurrentgemma-2b rank (model 2)", 1, 5, 256, 2112, torch.bfloat16, False,
                   True),
                  ("recurrentgemma-2b rank (model 2)", 1, 5, 256, 2112, torch.bfloat16, True,
                   True),
                  ("recurrentgemma-2b float32", 1, 10, 256, 2112, torch.float32, False, True),
                  ("Llama-3.2-3B", 8, 3, 128, 576, torch.bfloat16, False, False),
                  ("Qwen2.5-7B", 4, 7, 128, 576, torch.bfloat16, False, False),
                  ("multi-query", 1, 48, 128, 576, torch.bfloat16, False, False),
                  ("phi-2", 32, 1, 80, 576, torch.bfloat16, False, False),
                  ("Phi-3-mini", 32, 1, 96, 576, torch.bfloat16, False, False))
        b = 8
        for label, kv, g, hd, t, dtype, quant, ring in shapes:
            if self.rehearsal:
                t = 40
            h, err = g * kv, 0.0
            for wrap in (False, True):
                args = self.attn_inputs(b, h, kv, hd, t, dtype, quant, t + g + hd + quant)
                r = ops.ref_decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                y = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                again = ops.decode_attention(*args, scale=hd**-0.5, wrap=wrap)
                self.sync()
                if not torch.equal(y, again):
                    raise AssertionError(f"decode attention {label}: two calls differ")
                split = ("" if self.rehearsal else
                         " (S={chunks} of {chunk_lines} lines, {passes} pass(es) as G={group}, "
                         "{slots} slots a launch)".format(**ops.plan(*args[:2])))
                self.check_attention(y, r, dtype, f"{label} kv={kv} g={g} hd={hd} t={t} "
                                     f"int8={quant} wrap={wrap}{split}")
                err = max(err, float((y.float() - r.float()).abs().max()))
            # the timed call: every line live (a ring wrapped at its last step)
            pos = torch.full((b,), t + 100 if ring else t - 1, dtype=torch.int32,
                             device=self.dev)
            size = 1 if quant else torch.finfo(dtype).bits // 8
            cache_bytes = 2 * b * t * kv * hd * size + (2 * b * t * kv * 4 if quant else 0)
            copies = 1 if self.rehearsal else max(1, -(-100_000_000 // cache_bytes))
            sets = [self.attn_inputs(b, h, kv, hd, t, dtype, quant, 90 + i, pos=pos)
                    for i in range(copies)]
            it = {"i": 0}

            def rotating(fn, sets=sets, it=it):
                def call():
                    a = sets[it["i"] % len(sets)]
                    it["i"] += 1
                    return fn(a)
                return call

            mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=self.dev)
            # SDPA on the cache in q's dtype (an int8 cache dequantized first)
            lib_sets = [(a[0], a[1].to(dtype), a[2].to(dtype)) if quant else a for a in sets]
            lib_it = {"i": 0}

            def sdpa(a, mask=mask):
                return F.scaled_dot_product_attention(a[0][:, :, None], a[1].transpose(1, 2),
                                                      a[2].transpose(1, 2), attn_mask=mask,
                                                      enable_gqa=True)

            nbytes = 2 * b * h * hd * torch.finfo(dtype).bits // 8 + cache_bytes + b * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * b * h * t * hd / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
            bnd = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            at = {"shape": label, "b": b, "kv": kv, "g": g, "hd": hd, "t": t,
                  "dtype": str(dtype), "int8": quant, "wrap": ring, "max_abs_err": err,
                  "bound_ms": bnd[0], "bound_by": bnd[1],
                  "ms": self.time_ms(rotating(
                      lambda a, w=ring: ops.decode_attention(*a, scale=hd**-0.5, wrap=w))),
                  "library_ms": self.time_ms(rotating(sdpa, lib_sets, lib_it))}
            if not self.rehearsal:
                at.update({k: v for k, v in ops.plan(sets[0][0], sets[0][1]).items()
                           if k != "workspace"})
            rows.append(at)
            share = f"{bnd[0] / at['ms']:.3f}" if at["ms"] else "not measured"
            print(f"  decode_attention {label} b={b} h={h} kv={kv} hd={hd} t={t} {dtype} "
                  f"int8={quant} wrap={ring} ({copies} cache copies): events ms per call: "
                  f"kernel {at['ms']}, SDPA {at['library_ms']}; bound {bnd[0]:.6f} ms "
                  f"({bnd[1]}); bound / kernel {share} ({self.card})")
            del sets, lib_sets

    def check_attention(self, y, r, dtype, label):
        torch = self.torch
        diff = (y.float() - r.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            ok = torch.allclose(y, r, atol=1e-5, rtol=1e-5)
            limit = "atol 1e-5, rtol 1e-5"
        else:
            # Only the order of the float32 sums differs and bf16 rounds the
            # weights and outputs after them: within two bf16 ulps at each
            # (slot, head) row's largest output.  One cache line dropped or
            # doubled moves a row by several.
            row = r.float().abs().amax(dim=-1, keepdim=True).to(dtype)
            ulps = float((diff / ulp_of(row)).max())
            ok = ulps <= 2.0
            limit = f"{ulps:.2f} row ulps, limit 2"
        print(f"  decode_attention {str(dtype):14s} {label}: max |diff| {err:.3e} ({limit}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("decode attention disagrees with its plain version")

    # -- phase 4 -----------------------------------------------------------
    def p4_serve(self):
        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.models import lm

        cfg = self.serve_config("qwen3-4b")
        batch, prompt_len, gen_len = (2, 16, 4) if self.rehearsal else (8, 512, 64)
        cache_len = prompt_len + gen_len
        print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab} -> {cfg.padded_vocab}, "
              f"{cfg.act_dtype}; batch {batch}, prompt {prompt_len}, {gen_len} new tokens, "
              f"cache {cache_len}")
        t0 = time.perf_counter()
        model = lm.init(cfg, self.gen(0), device=self.dev)
        self.sync()
        print(f"  init: {lm.param_count(model) / 1e9:.3f} B parameters in "
              f"{time.perf_counter() - t0:.1f} s")
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=self.gen(1),
                               device=self.dev)

        def run(c, n):
            cache = lm.init_cache(c, batch, cache_len, device=self.dev)
            self.sync()
            t_a = time.perf_counter()
            logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
            self.sync()
            t_b = time.perf_counter()
            toks, _, _ = lm.generate_scan(model, c, cache, logits[:, -1:].argmax(-1),
                                          prompt_len, n)
            self.sync()
            return logits, toks, t_b - t_a, time.perf_counter() - t_b

        run(cfg, 2)  # warm-up: cuBLAS handles, allocator, kernel libraries loaded
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        logits, toks, pf_s, dec_s = run(cfg, gen_len)  # the main path
        counts = dispatch.launch_counts()
        peak = torch.cuda.max_memory_allocated() if not self.rehearsal else None
        print(f"  main path launches: {counts}")
        want = {"rmsnorm": (4 * cfg.n_layers + 1) * (1 + gen_len),
                "decode_attention": cfg.n_layers * gen_len}
        self.rows["rmsnorm"]["launches"] = counts["rmsnorm"]
        self.rows["decode_attention"]["launches"] = counts["decode_attention"]
        print(f"  prefill {pf_s * 1e3:.1f} ms; decode {dec_s / gen_len * 1e3:.2f} ms/step, "
              f"{batch * gen_len / dec_s:.1f} tok/s; peak memory "
              f"{peak / 2**30 if peak is not None else float('nan'):.2f} GiB (host clock with "
              f"synchronize; {self.card})")

        plain_len = min(PLAIN_STEPS, gen_len)
        prev = dispatch.set_backend("reference")
        try:
            ref_logits, ref_toks, rpf_s, rdec_s = run(cfg.replace(decode_kernel="reference"),
                                                      plain_len)
        finally:
            dispatch.set_backend(prev)
        print(f"  plain versions: prefill {rpf_s * 1e3:.1f} ms; decode "
              f"{rdec_s / plain_len * 1e3:.2f} ms/step ({plain_len} steps)")
        if not self.rehearsal and (counts["rmsnorm"] != want["rmsnorm"]
                                   or counts["decode_attention"] != want["decode_attention"]):
            raise AssertionError(f"launch counts {counts}, want {want}")
        if not self.rehearsal and dispatch.launch_counts() != counts:
            raise AssertionError("the plain-version run launched a kernel")
        if tuple(logits.shape) != (batch, 1, cfg.vocab) or tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"shapes: logits {tuple(logits.shape)}, tokens {tuple(toks.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite first-step logits")
        diff = float((logits.float() - ref_logits.float()).abs().max())
        top = ref_logits.float().abs().max()
        limit = 4 * float(ulp_of(top.reshape(1).to(ref_logits.dtype)))
        agree = float((toks[:, :plain_len] == ref_toks).float().mean())
        first = [int((toks[:, i] == ref_toks[:, i]).sum()) for i in range(min(2, gen_len))]
        print(f"  kernels vs plain versions: first-step logits max |diff| {diff:.4g} "
              f"(limit {limit:.4g}: 4 {ref_logits.dtype} ulps at max |logit| {float(top):.4g}); "
              f"first two generated tokens agree {first} of {batch}; greedy token agreement "
              f"{agree:.3f} over {ref_toks.numel()} tokens")
        # Only sum orders differ in the norms and attention: the logits stay
        # within a few ulps, and the prefill argmax and the first decode
        # step's token agree in every slot.  Later tokens may part on near
        # ties, which then compound.
        if diff > limit:
            raise AssertionError("full-width logits disagree with the plain versions")
        if first != [batch] * len(first):
            raise AssertionError(f"first generated tokens disagree: {first} of {batch}")
        self.serving = (cfg, model, prompt, logits[:, -1:].argmax(-1), batch, prompt_len,
                        cache_len)
        self.serve_tokens = toks

    def p4_unit(self):
        """The sqrt-unit entry point on an activation-sized tensor, forward
        and backward: one launch a kernel, none in the backward; outputs and
        gradients bit-identical to the plain route's."""
        torch = self.torch
        from repro_torch.core import get_unit
        from repro_torch.kernels import dispatch

        shape = (2, 16, 64) if self.rehearsal else (8, 512, 2560)
        x = torch.rand(shape, generator=self.gen(2), device=self.dev) * 4.0 + 1e-3
        ct = torch.randn(shape, generator=self.gen(3), device=self.dev)

        def run(unit):
            outs, grads = [], []
            for op in (unit.sqrt, unit.rsqrt):
                xt = x.clone().requires_grad_(True)
                y = op(xt)
                y.backward(ct)
                outs.append(y.detach())
                grads.append(xt.grad)
            self.sync()
            return outs, grads

        dispatch.reset_launch_counts()
        outs, grads = run(get_unit("e2afs", kernel=True))
        counts = dispatch.launch_counts()
        print(f"  unit path {tuple(shape)} float32, forward and backward, launches: {counts}")
        for name in ("e2afs_sqrt", "e2afs_rsqrt"):
            self.rows[name]["launches"] = counts[name]
        if not self.rehearsal and (counts["e2afs_sqrt"] != 1 or counts["e2afs_rsqrt"] != 1):
            raise AssertionError(f"unit path launches {counts}")
        plain_outs, plain_grads = run(get_unit("e2afs"))
        for label, out, plain, grad, plain_grad in zip(("sqrt", "rsqrt"), outs, plain_outs, grads,
                                                       plain_grads):
            same = (out.view(torch.int32) == plain.view(torch.int32)) | (
                torch.isnan(out) & torch.isnan(plain))
            bad = int((~same).sum())
            bad_grad = int((grad.view(torch.int32) != plain_grad.view(torch.int32)).sum())
            finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(grad).all())
            print(f"  unit {label:5s} vs plain route at {tuple(shape)}: {bad} outputs and "
                  f"{bad_grad} gradients of {x.numel()} differ; all finite: {finite}")
            if bad or bad_grad or not finite:
                raise AssertionError(f"unit path {label} differs from the plain route")

    def p4_small(self):
        """A small float32 model on the card: kernels vs plain versions give
        identical greedy tokens, with global attention and with every layer
        a 6-token sliding window; then serve.generate at smoke width."""
        torch = self.torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.kernels import dispatch
        from repro_torch.launch import serve
        from repro_torch.models import lm

        cfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="e2afs",
                               decode_kernel="fused")
        model = lm.init(cfg, self.gen(3), device=self.dev)
        prompt_len, gen_len, cache_len = 12, 16, 28
        prompt = torch.randint(0, cfg.vocab, (4, prompt_len), generator=self.gen(4),
                               device=self.dev)
        window = cfg.replace(block_pattern=("window",), window=6).validate()
        for label, base, lines in (("global", cfg, cache_len), ("window 6", window, 6)):
            outs = []
            for backend, route in (("auto", "fused"), ("reference", "reference")):
                prev = dispatch.set_backend(backend)
                try:
                    c = base.replace(decode_kernel=route)
                    cache = lm.init_cache(c, 4, cache_len, device=self.dev)
                    logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
                    dispatch.reset_launch_counts()
                    toks, _, _ = lm.generate_scan(model, c, cache, logits[:, -1:].argmax(-1),
                                                  prompt_len, gen_len)
                    self.sync()
                    outs.append((logits, toks, cache["k"].shape[2],
                                 dispatch.launch_counts()["decode_attention"]))
                finally:
                    dispatch.set_backend(prev)
            diff = float((outs[0][0] - outs[1][0]).abs().max())
            same = bool(torch.equal(outs[0][1], outs[1][1]))
            want = 0 if self.rehearsal else cfg.n_layers * gen_len
            print(f"  smoke float32 {label}: {outs[0][2]} cache lines (want {lines}; positions "
                  f"0-{prompt_len + gen_len - 1}), logits max |diff| {diff:.3e} (atol 1e-4), "
                  f"tokens identical: {same}; decode_attention launches {outs[0][3]} on the "
                  f"kernel route (want {want}), {outs[1][3]} on the plain route")
            if diff > 1e-4 or not same:
                raise AssertionError(f"small float32 model ({label}): kernels disagree with "
                                     "plain versions")
            if outs[0][2] != lines or outs[1][2] != lines:
                raise AssertionError(f"small float32 model ({label}): cache of "
                                     f"{outs[0][2]} lines, want {lines}")
            if outs[0][3] != want or outs[1][3] != 0:
                raise AssertionError(f"small float32 model ({label}): decode_attention "
                                     f"launches {outs[0][3]} and {outs[1][3]}")
        for mode in serve.MODES:
            serve.generate("qwen3-4b", mode=mode, reps=1, device=self.dev)

    def p4_gemma(self):
        """gemma3-1b at full width on the kernels: five window layers (a ring
        of 512 lines) to one global (2112 lines), held against the same
        weights and prompt on the plain versions."""
        torch = self.torch
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.kernels import dispatch
        from repro_torch.models import lm

        if self.rehearsal:
            cfg = get_smoke_config("gemma3-1b", sqrt_unit="e2afs", decode_kernel="fused")
            batch, prompt_len, gen_len = 2, 24, 4
        else:
            cfg = get_config("gemma3-1b", sqrt_unit="e2afs", decode_kernel="fused")
            batch, prompt_len, gen_len = 8, 2048, 64
        cache_len = prompt_len + gen_len
        windows = cfg.blocks.count("window")
        print(f"  {cfg.name}: {cfg.n_layers} layers ({windows} window of {cfg.window}, "
              f"{cfg.n_layers - windows} global), d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab} -> "
              f"{cfg.padded_vocab} (tied), {cfg.act_dtype}; batch {batch}, prompt {prompt_len}, "
              f"{gen_len} new tokens, cache {cache_len}")
        t0 = time.perf_counter()
        model = lm.init(cfg, self.gen(0), device=self.dev)
        self.sync()
        n_params = lm.param_count(model)
        print(f"  init: {n_params / 1e9:.4f} B parameters in {time.perf_counter() - t0:.1f} s")
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=self.gen(1),
                               device=self.dev)

        def run(c, n):
            cache = lm.init_cache(c, batch, cache_len, device=self.dev)
            self.sync()
            t_a = time.perf_counter()
            logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
            self.sync()
            t_b = time.perf_counter()
            toks, _, cache = lm.generate_scan(model, c, cache, logits[:, -1:].argmax(-1),
                                              prompt_len, n)
            self.sync()
            return logits, toks, cache, t_b - t_a, time.perf_counter() - t_b

        run(cfg, 2)  # warm-up
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        logits, toks, cache, pf_s, dec_s = run(cfg, gen_len)  # the main path
        counts, details = dispatch.launch_counts(), dispatch.launch_details()
        peak = torch.cuda.max_memory_allocated() if not self.rehearsal else None
        lines = [layer["k"].shape[1] for layer in cache]
        want_lines = [min(cache_len, cfg.window) if b == "window" else cache_len
                      for b in cfg.blocks]
        want = {"rmsnorm": (4 * cfg.n_layers + 1) * (1 + gen_len),
                "decode_attention": cfg.n_layers * gen_len}
        want_details = {"decode_attention wrap": windows * gen_len,
                        "decode_attention no wrap": (cfg.n_layers - windows) * gen_len}
        print(f"  main path launches: rmsnorm {counts['rmsnorm']} (want {want['rmsnorm']}), "
              f"decode_attention {counts['decode_attention']} (want "
              f"{want['decode_attention']}): {details} (want {want_details})")
        print(f"  cache lines by layer: {lines}")
        self.rows["rmsnorm"]["gemma3_1b_launches"] = counts["rmsnorm"]
        self.rows["decode_attention"]["gemma3_1b_launches"] = counts["decode_attention"]
        self.rows["decode_attention"]["gemma3_1b_launch_details"] = details
        # decode floor: every weight read once a step (the tied embedding as
        # the unembed) and every cache line of every layer (the kernel reads
        # the whole buffer and masks)
        cache_bytes = sum(t.numel() * t.element_size() for layer in cache for t in layer.values())
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        floor_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
        self.gemma_serving = {"prefill_ms": pf_s * 1e3, "ms_per_step": dec_s / gen_len * 1e3,
                              "tok_s": batch * gen_len / dec_s, "floor_ms": floor_ms,
                              "peak_gib": peak / 2**30 if peak is not None else None}
        print(f"  prefill {pf_s * 1e3:.1f} ms; decode {dec_s / gen_len * 1e3:.2f} ms/step, "
              f"{batch * gen_len / dec_s:.1f} tok/s; decode floor {floor_ms:.3f} ms/step "
              f"({weight_bytes / 1e9:.3f} GB of weights + {cache_bytes / 1e9:.3f} GB of cache "
              f"over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak memory "
              f"{peak / 2**30 if peak is not None else float('nan'):.2f} GiB (host clock with "
              f"synchronize; {self.card})")

        plain_len = min(PLAIN_STEPS, gen_len)
        prev = dispatch.set_backend("reference")
        try:
            ref_logits, ref_toks, _, rpf_s, rdec_s = run(cfg.replace(decode_kernel="reference"),
                                                         plain_len)
        finally:
            dispatch.set_backend(prev)
        print(f"  plain versions: prefill {rpf_s * 1e3:.1f} ms; decode "
              f"{rdec_s / plain_len * 1e3:.2f} ms/step ({plain_len} steps)")
        if lines != want_lines:
            raise AssertionError(f"cache lines {lines}, want {want_lines}")
        if not self.rehearsal and (counts["rmsnorm"] != want["rmsnorm"]
                                   or counts["decode_attention"] != want["decode_attention"]
                                   or details != want_details):
            raise AssertionError(f"launch counts {counts} {details}, want {want} {want_details}")
        if not self.rehearsal and dispatch.launch_counts() != counts:
            raise AssertionError("the plain-version run launched a kernel")
        if tuple(logits.shape) != (batch, 1, cfg.vocab) or tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"shapes: logits {tuple(logits.shape)}, tokens {tuple(toks.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite first-step logits")
        diff = float((logits.float() - ref_logits.float()).abs().max())
        top = ref_logits.float().abs().max()
        limit = 4 * float(ulp_of(top.reshape(1).to(ref_logits.dtype)))
        agree = float((toks[:, :plain_len] == ref_toks).float().mean())
        first = [int((toks[:, i] == ref_toks[:, i]).sum()) for i in range(min(2, gen_len))]
        print(f"  kernels vs plain versions: first-step logits max |diff| {diff:.4g} "
              f"(limit {limit:.4g}: 4 {ref_logits.dtype} ulps at max |logit| {float(top):.4g}); "
              f"first two generated tokens agree {first} of {batch}; greedy token agreement "
              f"{agree:.3f} over {ref_toks.numel()} tokens")
        # the phase 4a contract
        if diff > limit:
            raise AssertionError("gemma3-1b logits disagree with the plain versions")
        if first != [batch] * len(first):
            raise AssertionError(f"first generated tokens disagree: {first} of {batch}")
        print("  gemma3-1b decode profile:")
        self.profile_decode(cfg, model, prompt, logits[:, -1:].argmax(-1), batch, prompt_len,
                            cache_len, top=8)
        self.gemma = (cfg, model)

    # -- phase 6 -----------------------------------------------------------
    def p6_profile(self):
        """Four full-width decode steps of qwen3-4b (after the counted run),
        timed without the profiler and then under it."""
        self.profile_decode(*self.serving, top=14)

    def profile_decode(self, cfg, model, prompt, tok, batch, prompt_len, cache_len, *, top):
        """Four decode steps after a prefill, timed without the profiler and
        then under it: the device's idle share of the unprofiled step, the
        ``top`` kernels, and the device ms a step of decode attention and of
        RMSNorm by name."""
        from repro_torch.models import lm

        cache = lm.init_cache(cfg, batch, cache_len, device=self.dev)
        _, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
        lm.decode_step(model, cfg, cache, tok, prompt_len)  # warm
        self.sync()
        steps = 4
        pos = itertools.cycle(range(prompt_len + 1, cache_len))

        def step():
            lm.decode_step(model, cfg, cache, tok, next(pos))

        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        self.sync()
        plain_us = (time.perf_counter() - t0) * 1e6
        wall_us, rows = self.profiled(step, steps)
        busy = sum(r[0] for r in rows)
        print(f"  {steps} decode steps: {plain_us / steps / 1e3:.3f} ms/step unprofiled, "
              f"{wall_us / steps / 1e3:.3f} under the profiler; device busy "
              f"{busy / steps / 1e3:.3f} ms/step; idle share {1 - busy / plain_us:.3f} of the "
              f"unprofiled step ({1 - busy / wall_us:.3f} of the profiled one); {self.card}")
        for dev_us, count, key in rows[:top]:
            print(f"    {dev_us / steps / 1e3:9.4f} ms/step  {count / steps:7.1f} calls/step  "
                  f"{key[:90]}")
        for name in ("decode_attention", "rmsnorm"):  # every launch of each, by name
            mine = [r for r in rows if name in r[2]]
            print(f"  {name}: {sum(r[0] for r in mine) / steps / 1e3:.4f} device ms/step in "
                  f"{sum(r[1] for r in mine) / steps:.1f} kernel launches/step "
                  f"({', '.join(sorted({r[2].split('<')[0] for r in mine}))})")
        if not self.rehearsal and busy <= 0:
            raise AssertionError("the profiler saw no device time")

    # -- phase 13 ----------------------------------------------------------
    def p13a_engine(self):
        """The continuous-batching engine on qwen3-4b at full width (phase
        4a's model): 8 slots of 576 lines, chunks of 8 steps, 24 requests."""
        if self.rehearsal:
            shape = dict(slots=4, cache_len=40, n_requests=8, prompts=(3, 5, 12), budgets=(2, 4, 7))
        else:
            shape = dict(slots=8, cache_len=576, n_requests=24, prompts=(128, 256, 512),
                         budgets=(16, 32, 64))
        self.engine_phase(*self.serving[:2], chunk=8, key="engine_qwen3_4b_launches", **shape)

    def p13b_engine_gemma(self):
        """The same on gemma3-1b at full width (phase 4d's model): 8 slots of
        2112 lines (the window layers' rings of 512), 12 requests."""
        if self.rehearsal:
            shape = dict(slots=4, cache_len=40, n_requests=6, prompts=(3, 12, 20), budgets=(2, 7))
        else:
            shape = dict(slots=8, cache_len=2112, n_requests=12, prompts=(512, 1000, 2048),
                         budgets=(16, 64))
        self.engine_phase(*self.gemma, chunk=8, key="engine_gemma3_1b_launches", **shape)

    def solo_logits(self, model, cfg, prompt, cache_len, step):
        """The logits of step ``step`` (0: the prefill's last, 1: the first
        decode step's) of :func:`solo_generate`'s batch-1 run, by its ops."""
        torch = self.torch
        from repro_torch.models import lm

        with torch.no_grad():
            cache = lm.init_cache(cfg, 1, cache_len, device=self.dev)
            prompt = torch.as_tensor(prompt, dtype=torch.int32, device=self.dev)[None]
            logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
            if step:
                logits, _ = lm.decode_step(model, cfg, cache, logits[:, -1:].argmax(dim=-1),
                                           prompt.shape[1])
        return logits[0, -1]

    def engine_phase(self, cfg, model, *, slots, cache_len, chunk, n_requests, prompts, budgets,
                     key):
        """``launch.engine.Engine`` over a slot pool, its decode chunk one
        captured CUDA graph.  A trace of requests from seed 0 (prompt lengths
        and budgets drawn from the given sets, all arriving at 0):

        * a replay of the graph bit-identical to the same chunk run eagerly,
          from one pool state (the first ``slots`` requests admitted);
        * ms a decode step replayed and eager, and the device's idle share of
          a profiled replay;
        * the trace served with the launch counts set to 0 just before and
          read just after: RMSNorm and decode-attention launches equal to
          what the admissions and chunks imply, every request complete;
        * eight requests (the longest prompts, then requests in reused
          slots) token-identical to the same request alone in the pool;
        * against batch-1 ``solo_generate`` of two tokens: the first two
          tokens equal, or parted only at a near tie (the solo run's logit
          of the engine's token within 4 ulps at max |logit| of its own
          pick: the decode-attention split and cuBLAS's sum order depend on
          the batch, so tokens may part on near ties);
        * ``run_static_baseline`` on the same trace, its tok/s beside the
          engine's."""
        import numpy as np

        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import Engine, Request, run_static_baseline, solo_generate
        from repro_torch.models import lm

        reqs = trace(cfg, n_requests, prompts, budgets)
        windows = cfg.blocks.count("window")
        per_forward = 4 * cfg.n_layers + 1  # RMSNorm launches: 2 norms + qk-norms a layer, ln_f
        print(f"  {cfg.name}: {slots} slots of {cache_len} lines, chunks of {chunk} steps; "
              f"{n_requests} requests, prompts {sorted(set(len(r.prompt) for r in reqs))}, "
              f"budgets {sorted(set(r.max_new_tokens for r in reqs))}, "
              f"{sum(r.max_new_tokens for r in reqs)} tokens in all")
        eng = Engine(model, cfg, num_slots=slots, cache_len=cache_len, chunk=chunk)
        t0 = time.perf_counter()
        eng.warmup(prompt_lens=prompts)
        self.sync()
        print(f"  warmup (one admission a prompt length, one chunk eagerly and its capture): "
              f"{time.perf_counter() - t0:.2f} s; graph captured: {bool(eng._graphs)}")
        if not self.rehearsal and not eng._graphs:
            raise AssertionError("the decode chunk was not captured")

        # a replay against the eager chunk, from one pool state
        restore = self.replay_equals_eager(eng, reqs[:slots])

        # ms a step: replays (CUDA events) and eager chunks (host clock)
        restore()
        replay_ms = self.time_ms(eng._decode_chunk, iters=4)
        restore()
        self.sync()
        t0 = time.perf_counter()
        for _ in range(2):
            eng._chunk_eager()
        self.sync()
        eager_ms = (time.perf_counter() - t0) / 2 * 1e3
        restore()
        wall_us, rows = self.profiled(eng._decode_chunk, 1, every_launch=True)
        busy = sum(r[0] for r in rows)
        replay_us = replay_ms * 1e3 if replay_ms else float("nan")
        print(f"  ms a decode step: graphed {replay_us / chunk / 1e3:.3f} (CUDA events around 4 "
              f"replays), eager {eager_ms / chunk:.3f} (host clock); a profiled replay: device "
              f"busy {busy / chunk / 1e3:.3f} ms a step, idle share {1 - busy / replay_us:.3f} of "
              f"the unprofiled replay ({1 - busy / wall_us:.3f} of the profiled one, "
              f"{wall_us / chunk / 1e3:.3f} ms a step); {self.card}")
        for dev_us, count, name in rows[:8]:
            print(f"    {dev_us / chunk / 1e3:9.4f} ms/step  {count / chunk:7.1f} calls/step  "
                  f"{name[:90]}")

        # the main path: the trace through Engine.run
        eng.reset()
        self.sync()
        dispatch.reset_launch_counts()
        done = eng.run(reqs)
        counts, details = dispatch.launch_counts(), dispatch.launch_details()
        stats = eng.stats
        steps = stats["decode_chunks"] * chunk
        want = {"rmsnorm": per_forward * (n_requests + steps),
                "decode_attention": cfg.n_layers * steps}
        want_details = {"decode_attention wrap": windows * steps} if windows else {}
        if cfg.n_layers > windows:
            want_details["decode_attention no wrap"] = (cfg.n_layers - windows) * steps
        self.rows["rmsnorm"][key] = counts["rmsnorm"]
        self.rows["decode_attention"][key] = counts["decode_attention"]
        print(f"  Engine.run: makespan {stats['makespan_s']:.3f} s, {stats['total_tokens']} "
              f"tokens, {stats['tok_s']:.1f} tok/s, {stats['decode_chunks']} chunks (at the "
              f"replay's ms a step: {steps * replay_us / chunk / 1e6:.3f} s of decode, the rest "
              f"{n_requests} admissions and the host); "
              f"launches: rmsnorm {counts['rmsnorm']} (want {want['rmsnorm']}: {n_requests} "
              f"admissions + {steps} steps, {per_forward} each), decode_attention "
              f"{counts['decode_attention']} (want {want['decode_attention']}), {details}")
        if not self.rehearsal and (counts["rmsnorm"] != want["rmsnorm"]
                                   or counts["decode_attention"] != want["decode_attention"]
                                   or details != want_details):
            raise AssertionError(f"launch counts {counts} {details}, want {want} {want_details}")
        if stats["n_ok"] != n_requests:
            raise AssertionError(f"not every request completed: {stats}")
        for r in reqs:
            toks = done[r.uid].tokens
            if len(toks) != r.max_new_tokens or toks.min() < 0 or toks.max() >= cfg.vocab:
                raise AssertionError(f"request {r.uid}: {len(toks)} tokens of "
                                     f"{r.max_new_tokens}, range {toks.min()}-{toks.max()}")

        # the same requests alone in the pool
        longest = max(len(r.prompt) for r in reqs)
        order = sorted(reqs, key=lambda r: (len(r.prompt) < longest, r.uid < slots, r.uid))
        picked = order[:4] + [r for r in order[4:] if r.uid >= slots][:4]
        chosen = {r.uid for r in picked}
        picked += [r for r in order[4:] if r.uid not in chosen][:8 - len(picked)]
        same = 0
        for r in picked:
            eng.reset()
            alone = eng.run([r])[r.uid].tokens
            same += int(np.array_equal(alone, done[r.uid].tokens))
        print(f"  alone in the pool: {same} of {len(picked)} requests token-identical (uids "
              f"{[r.uid for r in picked]}: prompt {longest} first, then reused slots, uid >= "
              f"{slots})")
        if (len(picked) < min(8, n_requests) or same != len(picked)
                or len(picked[0].prompt) != longest or not any(r.uid >= slots for r in picked)):
            raise AssertionError("staggered requests differ from the same requests alone")

        # the lock-step baseline on the same trace
        _, base = run_static_baseline(model, cfg, reqs, num_slots=slots)
        print(f"  run_static_baseline: makespan {base['makespan_s']:.3f} s, {base['tok_s']:.1f} "
              f"tok/s (engine {stats['tok_s']:.1f}, {stats['tok_s'] / base['tok_s']:.2f}x)")

        # batch-1 solo runs of the first two tokens; where a request parts
        # from its solo run, the solo run's logits at the first parting step
        # must make it a near tie: the engine's token within phase 4a's 4
        # ulps at max |logit| of the solo run's own pick
        first, parted = 0, []
        for r in reqs:
            solo = solo_generate(model, cfg, r.prompt, 2, cache_len=cache_len)[:2]
            got = done[r.uid].tokens[:2]
            if np.array_equal(solo, got):
                first += 1
                continue
            at = int(np.flatnonzero(solo != got)[0])
            step_logits = self.solo_logits(model, cfg, r.prompt, cache_len, at)
            if int(step_logits.argmax()) != int(solo[at]):
                raise AssertionError(f"request {r.uid}: the solo run is not reproducible")
            lg = step_logits.float()
            limit = 4 * float(ulp_of(lg.abs().max().reshape(1).to(step_logits.dtype)))
            parted.append((r.uid, at, float(lg[int(solo[at])] - lg[int(got[at])]), limit))
        print(f"  against batch-1 solo_generate: first two tokens equal in {first} of "
              f"{n_requests} requests; parted (uid, step, solo logit gap to the engine's "
              f"token, limit): {[(u, a, round(g, 5), round(m, 5)) for u, a, g, m in parted]}")
        if any(gap > limit for _, _, gap, limit in parted):
            raise AssertionError("first two tokens differ from batch-1 solo runs beyond a "
                                 "near tie")
        self.engine_runs[key] = dict(reqs=reqs, done=done, stats=stats,
                                     step_ms=replay_us / chunk / 1e3, shape=dict(
                                         slots=slots, cache_len=cache_len, chunk=chunk,
                                         prompts=prompts))

    def replay_equals_eager(self, eng, reqs=()):
        """Admit ``reqs`` (one a slot) into the engine's pool, then run one
        chunk eagerly and one replay of its captured graph from that pool
        state: every pool tensor (with speculation, the history and the
        draft cache too) and the packed buffer (tokens, emission, liveness,
        and with detectors the health columns) bit-identical, or the phase
        fails.  Returns a function that restores the state."""
        torch = self.torch
        from repro_torch.models import lm

        for slot, req in enumerate(reqs):
            eng._admit(req, slot, 0.0)
        state = lm.pool_tensors(eng.pool) + eng._spec_tensors()
        start = [t.clone() for t in state]

        def restore():
            for t, s0 in zip(state, start):
                t.copy_(s0)

        def outcome(run):
            restore()
            run()
            self.sync()
            return [t.clone() for t in state] + [eng._packed.clone()]

        eager = outcome(eng._chunk_eager)
        graphed = outcome(eng._decode_chunk)
        differ = [i for i, (a, b) in enumerate(zip(graphed, eager))
                  if not torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                                     b.view(torch.uint8) if b.is_floating_point() else b)]
        print(f"  replayed chunk vs eager chunk from one pool state: {len(differ)} of "
              f"{len(eager)} tensors differ (tokens, emitted, tok, pos, active, remaining, "
              f"every cache tensor{', health' if eng.detectors else ''}"
              f"{', canaries' if eng._canary is not None else ''}"
              f"{', history, accepted drafts, spec steps' if eng.spec is not None else ''}"
              f"{', draft cache' if eng._dcache is not None else ''})")
        if differ:
            raise AssertionError(f"the graphed chunk differs from the eager one: tensors {differ}")
        return restore

    # -- phase 14 ----------------------------------------------------------
    def p14a_fault_datapath(self):
        """The seeded fault model on the card: the faulted E2AFS datapath
        bit-identical to the CPU's (every fp16 and bf16 pattern, the float32
        grid; both sites, a hashed and a pinned bit, rates 1e-2 and 1.0),
        the hash's words equal, and the kernel route under faults: one
        launch, the output-register flip of the clean kernel output, equal
        to the plain faulted route wherever the clean output is normal."""
        torch = self.torch
        from repro_torch.core import e2afs, faults, get_unit
        from repro_torch.core.metrics import sampled_normal_values
        from repro_torch.kernels import dispatch

        specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), -2.0,
                                 1e-40, -1e-40])
        inputs = {
            "fp16": torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.float16),
            "bf16": torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16),
            "fp32 grid": torch.cat([sampled_normal_values(), specials]),
        }
        cases = [("sqrt_man", 1e-2, None), ("sqrt_man", 1.0, 3), ("sqrt_exp", 1e-2, None),
                 ("sqrt_exp", 1.0, 2)]
        for label, x in inputs.items():
            xd = x.to(self.dev)
            for op in ("sqrt", "rsqrt"):
                fn = getattr(e2afs, f"e2afs_{op}")
                bad = struck = 0
                for site, rate, bit in cases:
                    cfg = faults.FaultConfig(site, rate, seed=2**33 + 7, bit=bit)
                    cpu = fn(x, faults=cfg)
                    bad += int((~same_bits(fn(xd, faults=cfg).cpu(), cpu)).sum())
                    struck += int((~same_bits(cpu, fn(x))).sum())
                print(f"  faulted e2afs {op:5s} {label:9s} n={x.numel()}, {len(cases)} fault "
                      f"cases: {bad} patterns differ from the CPU ({struck} struck)")
                if bad or not struck:
                    raise AssertionError(f"faulted e2afs {op} {label}: {bad} differ, {struck} struck")

        words = torch.randint(-2**31, 2**31, (1 << 20,), generator=torch.Generator().manual_seed(0),
                              dtype=torch.int64).to(torch.int32)
        bad = int((faults._mix32(words.to(torch.int64).to(self.dev) & 0xFFFFFFFF).cpu()
                   != faults._mix32(words.to(torch.int64) & 0xFFFFFFFF)).sum())
        for seed in (0, 7, 2**32 + 5, -3):
            bad += int((faults._entropy(words.to(self.dev), seed).cpu()
                        != faults._entropy(words, seed)).sum())
            bad += int((faults.fault_mask(words.to(self.dev), 0.3, seed).cpu()
                        != faults.fault_mask(words, 0.3, seed)).sum())
        print(f"  fault hash: _mix32, per-element entropy and fault_mask over 2^20 words and 4 "
              f"seeds: {bad} words differ from the CPU")
        if bad:
            raise AssertionError(f"the fault hash differs on the card: {bad} words")

        for label, x in inputs.items():
            xd = x.to(self.dev)
            for op in ("sqrt", "rsqrt"):
                launches, flip_bad, normal_bad, normals = [], 0, 0, 0
                for site, rate, bit in cases:
                    cfg = faults.FaultConfig(site, rate, seed=5, bit=bit)
                    dispatch.reset_launch_counts()
                    y = getattr(get_unit("e2afs", kernel=True, faults=cfg), op)(xd)
                    launches.append(dispatch.launch_counts()[f"e2afs_{op}"])
                    clean = getattr(get_unit("e2afs", kernel=True), op)(xd)
                    flip_bad += int((~same_bits(y, faults.flip_float_bits(clean, cfg))).sum())
                    normal = normal_mask(clean)
                    plain = getattr(get_unit("e2afs", faults=cfg), op)(xd)
                    normal_bad += int((~same_bits(y[normal], plain[normal])).sum())
                    normals += int(normal.sum())
                print(f"  kernel route under faults, {op:5s} {label:9s}: launches {launches}; "
                      f"{flip_bad} differ from flip_float_bits of the clean kernel output; "
                      f"{normal_bad} of {normals} with a normal clean output differ from the "
                      f"plain faulted route")
                if flip_bad or normal_bad or (not self.rehearsal and launches != [1] * len(cases)):
                    raise AssertionError(f"kernel route under faults, {op} {label}")

    def slot_decode(self, model, cfg, cache, tok, start, steps, *, levels=None, hook=None):
        """``lm.decode_slots_scan`` over a copy of a prefilled cache (every
        slot live at ``start``, a budget of ``steps``), timed by the host
        clock with synchronize.  ``hook`` wraps the step's logits hook; the
        float32 logits after it are recorded.  Returns (tokens, logits
        (b, steps, vocab), cache, ms a step)."""
        torch = self.torch
        from repro_torch.models import lm

        cache = {k: v.clone() for k, v in cache.items()}
        b, dev = tok.shape[0], tok.device
        logits = []

        def record(lg):
            lg = hook(lg) if hook is not None else lg
            logits.append(lg.clone())
            return lg

        args = (tok.clone(), torch.full((b,), start, dtype=torch.int32, device=dev),
                torch.ones(b, dtype=torch.bool, device=dev),
                torch.full((b,), steps, dtype=torch.int32, device=dev))
        self.sync()
        t0 = time.perf_counter()
        toks = lm.decode_slots_scan(model, cfg, cache, *args, steps, unit_levels=levels,
                                    logits_hook=record)[0]
        self.sync()
        return toks, torch.stack(logits, 1), cache, (time.perf_counter() - t0) / steps * 1e3

    def launches_a_step(self, model, cfg, cache, tok, pos, levels=None):
        """Device kernels one eager decode step launches (a profiled
        ``decode_step`` on a copy of the cache), and their device ms."""
        from repro_torch.models import lm

        cache = {k: v.clone() for k, v in cache.items()}
        _, rows = self.profiled(lambda: lm.decode_step(model, cfg, cache, tok, pos,
                                                       unit_levels=levels), 1)
        return sum(r[1] for r in rows), sum(r[0] for r in rows) / 1e3

    def p14b_ladder(self):
        """The accuracy-SLO ladder ("e2afs", "esas", "exact") on phase 4a's
        model: ``decode_slots_scan`` over its 8 slots from one prefilled
        cache, 32 steps at levels [0, 1, 2, 0, 1, 2, 0, 2], held row by row
        against runs with every slot at one level; the all-"exact" run
        against ``exact_twin``; the all-0 run bit-identical to the clean
        fused route (rung 0 is that route); launch counts and ms a decode
        step eager."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.models import lm

        cfg, model, prompt, _, batch, prompt_len, cache_len = self.serving
        steps = 4 if self.rehearsal else 32
        lcfg = cfg.replace(sqrt_ladder=("e2afs", "esas", "exact")).validate()
        levels = torch.tensor([0, 1, 2, 0, 1, 2, 0, 2][:batch], dtype=torch.int32,
                              device=self.dev)
        cache = lm.init_cache(cfg, batch, cache_len, device=self.dev)
        logits, cache = lm.prefill(model, cfg, cache, prompt, last_logit_only=True)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        self.slot_decode(model, lcfg, cache, tok, prompt_len, 2, levels=levels)  # warm-up
        dispatch.reset_launch_counts()
        mixed = self.slot_decode(model, lcfg, cache, tok, prompt_len, steps, levels=levels)
        counts = dispatch.launch_counts()
        uniform = [self.slot_decode(model, lcfg, cache, tok, prompt_len, steps,
                                    levels=torch.full_like(levels, lv)) for lv in range(3)]
        twin = self.slot_decode(model, lm.exact_twin(lcfg), cache, tok, prompt_len, steps)
        clean = self.slot_decode(model, cfg, cache, tok, prompt_len, steps)
        per_step = {k: v / steps for k, v in counts.items() if v}
        want = {"rmsnorm": 4 * cfg.n_layers + 1, "decode_attention": cfg.n_layers}
        print(f"  {cfg.name}, batch {batch}, prompt {prompt_len}, {steps} steps, levels "
              f"{levels.tolist()}: launches a step {per_step} (want {want}: rung 0 of every "
              f"norm on the fused RMSNorm kernel, the other rungs unfused)")
        pos = torch.full((batch,), prompt_len, dtype=torch.int32, device=self.dev)
        k_ladder, ms_ladder = self.launches_a_step(model, lcfg, cache, tok, pos, levels)
        k_clean, ms_clean = self.launches_a_step(model, cfg, cache, tok, pos)
        print(f"  device kernels a decode step: ladder {k_ladder} ({ms_ladder:.3f} device ms), "
              f"clean fused {k_clean} ({ms_clean:.3f} device ms)")
        print(f"  ms a decode step eager (host clock with synchronize; {self.card}): mixed "
              f"levels {mixed[3]:.2f}, all 0 {uniform[0][3]:.2f}, all 1 {uniform[1][3]:.2f}, "
              f"all 2 {uniform[2][3]:.2f}, exact_twin {twin[3]:.2f}, clean fused {clean[3]:.2f}")
        leaks = []
        for i, lv in enumerate(levels.tolist()):
            want_row = uniform[lv]
            if not (torch.equal(mixed[0][i], want_row[0][i])
                    and bool(same_bits(mixed[1][i], want_row[1][i]).all())
                    and all(bool(same_bits(mixed[2][k][:, i], want_row[2][k][:, i]).all())
                            for k in cache)):
                leaks.append(i)
        def same_run(a, b):
            return (torch.equal(a[0], b[0]) and bool(same_bits(a[1], b[1]).all())
                    and all(bool(same_bits(a[2][k], b[2][k]).all()) for k in cache))

        twin_same = same_run(twin, uniform[2])
        clean_same = same_run(uniform[0], clean)
        print(f"  rows vs all-one-level runs: {batch - len(leaks)} of {batch} rows bit-identical "
              f"(tokens, logits, cache); all-2 run vs exact_twin: "
              f"{'bit-identical' if twin_same else 'DIFFERENT'}; all-0 run vs the clean fused "
              f"route: {'bit-identical' if clean_same else 'DIFFERENT'}")
        if not self.rehearsal and per_step != {k: float(v) for k, v in want.items() if v}:
            raise AssertionError(f"ladder launches {per_step}, want {want}")
        if leaks or not twin_same or not clean_same:
            raise AssertionError(f"rows leak across levels: {leaks}; exact_twin same: "
                                 f"{twin_same}; all-0 same as the clean route: {clean_same}")

    def p14c_faults(self):
        """Seeded faults on phase 4a's model: ``sqrt_faults=FaultConfig(
        "sqrt_man", 1e-3, seed=7)`` in every norm's E2AFS datapath (prefill
        and decode) and NaN logits from ``logits_hook(FaultConfig(
        "logit_nan", 1e-4, seed=3))``: two runs bit-identical, rate 0
        bit-identical to the clean fused route, the NaN positions the CPU's
        ``corrupt_logits`` of the pre-hook logits; then an ``Engine`` on the
        faulted config, its replayed chunk bit-identical to the eager one."""
        torch = self.torch
        from repro_torch.core import faults
        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import Engine, Request
        from repro_torch.models import lm

        cfg, model, prompt, _, batch, prompt_len, cache_len = self.serving
        steps = 4 if self.rehearsal else 32
        # the rehearsal's tiny model needs higher rates for a strike to land
        sqrt_rate, nan_rate = (5e-2, 1e-2) if self.rehearsal else (1e-3, 1e-4)
        fcfg = cfg.replace(sqrt_faults=faults.FaultConfig("sqrt_man", sqrt_rate,
                                                          seed=7)).validate()
        hook_cfg = faults.FaultConfig("logit_nan", nan_rate, seed=3)
        hook = faults.logits_hook(hook_cfg)

        def run(c, h):
            pre = []

            def spy(lg):
                pre.append(lg.clone())
                return h(lg) if h is not None else lg

            cache = lm.init_cache(c, batch, cache_len, device=self.dev)
            self.sync()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
            self.sync()
            pf_ms = (time.perf_counter() - t0) * 1e3
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            out = self.slot_decode(model, c, cache, tok, prompt_len, steps, hook=spy)
            return out + (torch.stack(pre, 1), logits, pf_ms)

        run(fcfg, hook)  # warm-up
        dispatch.reset_launch_counts()
        first = run(fcfg, hook)
        counts = {k: v for k, v in dispatch.launch_counts().items() if v}
        again = run(fcfg, hook)
        zero = run(cfg.replace(sqrt_faults=faults.FaultConfig("sqrt_man", 0.0, seed=7)), None)
        clean = run(cfg, None)
        replay = (torch.equal(first[0], again[0]) and bool(same_bits(first[1], again[1]).all())
                  and all(bool(same_bits(first[2][k], again[2][k]).all()) for k in first[2])
                  and bool(same_bits(first[5], again[5]).all()))
        rate0 = (torch.equal(zero[0], clean[0]) and bool(same_bits(zero[1], clean[1]).all())
                 and all(bool(same_bits(zero[2][k], clean[2][k]).all()) for k in clean[2]))
        pre = first[4].cpu()
        want_nan = torch.stack([torch.isnan(faults.corrupt_logits(pre[:, i], hook_cfg))
                                for i in range(steps)], 1)
        got_nan = torch.isnan(first[1].cpu())
        nan_bad = int((want_nan != got_nan).sum())
        struck_prefill = float((first[5].float() - clean[5].float()).abs().max())
        print(f"  {cfg.name} under sqrt_man {sqrt_rate} (seed 7) and logit_nan {nan_rate} (seed 3), "
              f"batch "
              f"{batch}, prompt {prompt_len}, {steps} steps: launches {counts} (no RMSNorm "
              f"kernel and no e2afs launch: every norm on the faulted datapath)")
        print(f"  two runs bit-identical: {replay}; rate 0 vs clean fused route bit-identical: "
              f"{rate0}; NaN positions vs the CPU's corrupt_logits of the pre-hook logits: "
              f"{nan_bad} of {got_nan.numel()} differ ({int(got_nan.sum())} NaN); faults move "
              f"the prefill logits by up to {struck_prefill:.4g}; tokens equal to the clean "
              f"run's {float((first[0] == clean[0]).float().mean()):.3f}")
        print(f"  ms (host clock with synchronize; {self.card}): prefill faulted "
              f"{first[6]:.1f}, clean {clean[6]:.1f}; a decode step faulted {first[3]:.2f}, "
              f"clean {clean[3]:.2f}")
        if not (replay and rate0) or nan_bad or not int(got_nan.sum()):
            raise AssertionError("faults are not replayable, or rate 0 is not the clean route, "
                                 "or NaN positions differ")
        if not self.rehearsal and (counts.get("rmsnorm") or counts.get("e2afs_rsqrt")
                                   or counts.get("decode_attention") != cfg.n_layers * steps):
            raise AssertionError(f"faulted route launches {counts}")

        eng = Engine(model, fcfg, num_slots=batch, cache_len=cache_len, chunk=8)
        eng.warmup(prompt_lens=(prompt_len,))
        if not self.rehearsal and not eng._graphs:
            raise AssertionError("the faulted decode chunk was not captured")
        reqs = [Request(uid=i, prompt=prompt[i].cpu().numpy().astype("int32"),
                        max_new_tokens=steps) for i in range(batch)]
        self.faulted_engine = (eng, self.replay_equals_eager(eng, reqs), reqs)

    # -- phase 15 ----------------------------------------------------------
    def robust_shape(self):
        """Phase 15's engine: phase 13a's shape (8 slots of 576 lines, chunks
        of 8, its trace's prompt lengths and budgets), or the rehearsal's."""
        if self.rehearsal:
            return dict(slots=4, cache_len=40, prompts=(3, 5, 12), budgets=(2, 4, 7))
        return dict(slots=8, cache_len=576, prompts=(128, 256, 512), budgets=(16, 32, 64))

    def robust_engine(self, **kw):
        from repro_torch.launch.engine import Engine

        cfg, model = self.serving[:2]
        sh = self.robust_shape()
        return Engine(model, cfg, num_slots=sh["slots"], cache_len=sh["cache_len"], chunk=8, **kw)

    def p15a_detectors(self):
        """Detectors on, no faults, on phase 4a's model: a replay with the
        health columns bit-identical to the eager chunk; ms a replayed step
        with and without detectors, in turns; phase 13a's first 8 requests
        served with the launch counts set to 0 just before and read just
        after, token-identical to the same engine without detectors."""
        import numpy as np

        from repro_torch.kernels import dispatch

        cfg = self.serving[0]
        sh = self.robust_shape()
        reqs = trace(cfg, 8, sh["prompts"], sh["budgets"])
        engines = {"on": self.robust_engine(), "off": self.robust_engine(detectors=False)}
        restore = {}
        for name, eng in engines.items():
            eng.warmup(prompt_lens=sh["prompts"])
            if not self.rehearsal and not eng._graphs:
                raise AssertionError(f"detectors {name}: the decode chunk was not captured")
            print(f"  detectors {name}:")
            restore[name] = self.replay_equals_eager(eng, reqs[:sh["slots"]])
        ms = {"on": [], "off": []}
        for name in ("on", "off", "off", "on"):
            restore[name]()
            t = self.time_ms(engines[name]._decode_chunk, iters=4)
            ms[name].append(round(t / 8, 4) if t is not None else None)
        print(f"  ms a replayed decode step (CUDA events around 4 replays, in turns on, off, "
              f"off, on; {self.card}): detectors on {ms['on']}, off {ms['off']}")
        done, counts = {}, None
        for name, eng in engines.items():
            eng.reset()
            self.sync()
            dispatch.reset_launch_counts()
            done[name] = eng.run(reqs)
            if name == "on":
                counts, stats = dispatch.launch_counts(), dict(eng.stats)
        steps = stats["decode_chunks"] * 8
        want = {"rmsnorm": (4 * cfg.n_layers + 1) * (len(reqs) + steps),
                "decode_attention": cfg.n_layers * steps}
        self.rows["rmsnorm"]["engine_detectors_launches"] = counts["rmsnorm"]
        self.rows["decode_attention"]["engine_detectors_launches"] = counts["decode_attention"]
        same = sum(np.array_equal(done["on"][r.uid].tokens, done["off"][r.uid].tokens)
                   for r in reqs)
        print(f"  Engine.run with detectors, {len(reqs)} requests: {stats['n_ok']} ok, "
              f"faults_detected {stats['faults_detected']}, makespan {stats['makespan_s']:.3f} s, "
              f"{stats['tok_s']:.1f} tok/s; launches rmsnorm {counts['rmsnorm']}, "
              f"decode_attention {counts['decode_attention']} (want {want}); {same} of "
              f"{len(reqs)} requests token-identical to the engine without detectors")
        if not self.rehearsal and any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"launch counts {counts}, want {want}")
        if same != len(reqs) or stats["n_ok"] != len(reqs) or stats["faults_detected"]:
            raise AssertionError("detectors changed the tokens or tripped without faults")
        self.robust = (reqs, done["on"], engines["on"])
        self.anchor = (reqs, done["on"])  # phase 15g's reference tokens

    def p15b_logit_faults(self):
        """NaN logits (``logit_nan``, seed 1, one quarantine retry) on phase
        15a's 8 requests at budgets of 16: every request ok or degraded, the
        ok ones token-identical to phase 15a's, the degraded ones to
        ``solo_generate`` on ``exact_twin``, the counters agreeing with the
        statuses; then ``sqrt_exp`` faults (bit 7, rate 0.3) on 4 of them: at
        least one degraded, token-identical to the exact solo run."""
        import numpy as np

        from repro_torch.core.faults import FaultConfig
        from repro_torch.launch.engine import Request, solo_generate
        from repro_torch.models import lm

        cfg, model = self.serving[:2]
        sh = self.robust_shape()
        clean_reqs, clean, _ = self.robust
        budget = 4 if self.rehearsal else 16
        reqs = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=budget) for r in clean_reqs]
        # a request trips with about 1 - exp(-vocab x budget x rate): half at 3e-7
        rate = 0.73 / (cfg.vocab * budget) if self.rehearsal else 3e-7
        ecfg = lm.exact_twin(cfg)

        def exact_solo(r):
            return solo_generate(model, ecfg, r.prompt, r.max_new_tokens,
                                 cache_len=sh["cache_len"])

        eng = self.robust_engine(faults=FaultConfig("logit_nan", rate, seed=1),
                                 quarantine_retries=1)
        eng.warmup(prompt_lens=sh["prompts"])
        t0 = time.perf_counter()
        done = eng.run(reqs)
        run_s = time.perf_counter() - t0
        st = eng.stats
        degraded = [r for r in reqs if done[r.uid].status == "degraded"]
        ok = [r for r in reqs if done[r.uid].status == "ok"]
        exact_same = sum(np.array_equal(exact_solo(r), done[r.uid].tokens) for r in degraded)
        ok_same = 0
        for r in ok:
            n = min(len(done[r.uid].tokens), len(clean[r.uid].tokens))
            ok_same += int(np.array_equal(done[r.uid].tokens[:n], clean[r.uid].tokens[:n]))
        trips = sum(c.trips for c in done.values())
        print(f"  logit_nan rate {rate:.3g} (seed 1; a request trips with about "
              f"{1 - math.exp(-cfg.vocab * budget * rate):.2f}), quarantine_retries 1, "
              f"{len(reqs)} requests of {budget}: statuses "
              f"{[(u, c.status, c.trips) for u, c in sorted(done.items())]}; faults_detected "
              f"{st['faults_detected']}, quarantine_retries {st['quarantine_retries']}, "
              f"exact_fallbacks {st['exact_fallbacks']}; {ok_same} of {len(ok)} ok requests "
              f"token-identical to phase 15a's, {exact_same} of {len(degraded)} degraded ones to "
              f"the exact solo run; {run_s:.2f} s")
        if (any(c.status not in ("ok", "degraded") for c in done.values())
                or exact_same != len(degraded) or ok_same != len(ok)
                or st["faults_detected"] != trips
                or st["exact_fallbacks"] != len(degraded)
                or st["quarantine_retries"] != trips - len(degraded)
                or st["n_ok"] + st["n_degraded"] != len(reqs)):
            raise AssertionError(f"logit faults: {st}")
        if not trips:
            raise AssertionError("the seeded schedule tripped no request")
        del eng

        eng = self.robust_engine(faults=FaultConfig("sqrt_exp", rate=0.3, seed=2, bit=7))
        t0 = time.perf_counter()
        done = eng.run(reqs[:4])
        run_s = time.perf_counter() - t0
        degraded = [r for r in reqs[:4] if done[r.uid].status == "degraded"]
        exact_same = sum(np.array_equal(exact_solo(r), done[r.uid].tokens) for r in degraded)
        print(f"  sqrt_exp rate 0.3 bit 7 (seed 2), 4 requests: statuses "
              f"{[(u, c.status, c.trips) for u, c in sorted(done.items())]}; {exact_same} of "
              f"{len(degraded)} degraded ones token-identical to the exact solo run; {run_s:.2f} s "
              f"(the faulted chunk's eager run and capture included)")
        if (not degraded or exact_same != len(degraded)
                or any(c.status not in ("ok", "degraded") for c in done.values())):
            raise AssertionError(f"sqrt_exp faults: {eng.stats}")

    def p15c_faulted_replay(self):
        """Phase 14c's captured engine (``sqrt_man`` 1e-3, seed 7, in every
        norm): ms a decode step replayed (and again from fresh admissions,
        as 19f times the mesh's), beside phase 14c's eager step; the
        kernels and device time of one step from the same engine with chunks
        of one step, its captured step bit-identical to the eager one and
        profiled (reading a profile of the 8-step replay, 238,560 kernel
        events, took about 25 s)."""
        from repro_torch.launch.engine import Engine

        if self.faulted_engine is None:
            raise AssertionError("phase 14c built no faulted engine")
        eng, restore, reqs = self.faulted_engine
        self.faulted_engine = None
        restore()
        ms = self.time_ms(eng._decode_chunk, iters=4)
        step = (ms if ms is not None else float("nan")) / eng.chunk
        eng.reset()
        done = eng.run(reqs)  # phase 19f's reference tokens
        stats = dict(eng.stats)
        eng.reset()  # and its reference ms: timed from fresh admissions, as 19f times the mesh's
        for slot, req in enumerate(reqs[:eng.num_slots]):
            eng._admit(req, slot, 0.0)
        admitted = self.time_ms(eng._decode_chunk, iters=4)
        admitted = (admitted if admitted is not None else float("nan")) / eng.chunk
        self.faulted_ref = dict(cfg=eng.cfg, reqs=reqs, done=done, stats=stats,
                                step_ms=admitted, shape=dict(slots=eng.num_slots,
                                                         cache_len=eng.cache_len,
                                                         chunk=eng.chunk,
                                                         prompts=(len(reqs[0].prompt),)))
        one = Engine(eng.model, eng.cfg, num_slots=eng.num_slots, cache_len=eng.cache_len,
                     chunk=1)
        del eng, restore
        one.warmup(prompt_lens=(len(reqs[0].prompt),))
        self.replay_equals_eager(one, reqs)()
        wall_us, rows = self.profiled(one._decode_chunk, 1, every_launch=True)
        busy = sum(r[0] for r in rows)
        launches = sum(r[1] for r in rows)
        print(f"  {one.cfg.name} under {one.cfg.sqrt_faults}, {one.num_slots} slots: "
              f"{step:.3f} ms a decode step replayed (CUDA events around 4 replays of 8 steps; "
              f"{admitted:.4f} from fresh admissions, 19f's reference); "
              f"a profiled one-step replay: {launches} kernels, device busy {busy / 1e3:.3f} ms "
              f"({busy / launches if launches else 0:.2f} us a kernel), idle share "
              f"{1 - busy / (step * 1e3):.3f} of the 8-step replay's step; {self.card}")
        for dev_us, count, name in rows[:6]:
            print(f"    {dev_us / 1e3:9.4f} ms  {count:7d} calls  {name[:90]}")

    def p15d_dispatch(self):
        """Dispatch faults at rate 0.4 (seed 5) on phase 15a's requests:
        tokens identical to phase 15a's, every fault retried; an outage
        (rate 1.0, ``max_dispatch_retries=2``) struck before a replay raises
        ``DispatchFault`` with every pool tensor untouched; after ``reset()``
        the same engine serves the trace again, with the same counters."""
        import numpy as np

        from repro_torch.core.faults import DispatchFault, DispatchFaultInjector, FaultConfig
        from repro_torch.models import lm

        sh = self.robust_shape()
        reqs, clean, _ = self.robust
        eng = self.robust_engine(faults=FaultConfig("dispatch", rate=0.4, seed=5))
        eng.warmup(prompt_lens=sh["prompts"])

        def serve():
            done = eng.run(reqs)
            same = sum(np.array_equal(done[r.uid].tokens, clean[r.uid].tokens) for r in reqs)
            return same, eng.stats["dispatch_faults"], eng.stats["dispatch_retries"]

        first = serve()
        for slot, r in enumerate(reqs[:sh["slots"]]):
            eng._admit(r, slot, 0.0)
        eng._decode_chunk()
        self.sync()
        before = [t.clone() for t in lm.pool_tensors(eng.pool)] + [eng._packed.clone()]
        schedule, eng._injector = eng._injector, DispatchFaultInjector(
            FaultConfig("dispatch", rate=1.0))
        eng.max_dispatch_retries = 2
        try:
            eng._decode_chunk()
            raised = None
        except DispatchFault as e:
            raised = str(e)
        self.sync()
        after = list(lm.pool_tensors(eng.pool)) + [eng._packed]
        untouched = all(bool(same_bits(a, b).all()) if a.is_floating_point() else
                        self.torch.equal(a, b) for a, b in zip(after, before))
        eng._injector, eng.max_dispatch_retries = schedule, 3
        eng.reset()
        again = serve()
        print(f"  dispatch rate 0.4 (seed 5): {first[0]} of {len(reqs)} requests token-identical "
              f"to phase 15a's, dispatch_faults {first[1]}, dispatch_retries {first[2]}; an "
              f"outage before a replay raised {raised!r}, pool untouched: {untouched}; after "
              f"reset(): {again[0]} of {len(reqs)} identical, faults {again[1]}, retries "
              f"{again[2]}")
        if (first[0] != len(reqs) or not first[1] or first[1] != first[2] or raised is None
                or not untouched or again != first):
            raise AssertionError("dispatch faults changed the result or the pool")

    def p15e_kill_resume(self):
        """A 12-request trace of phase 13a's draw with a journal and
        ``snapshot_every_chunks=2``, killed at ``max_chunks=3`` and resumed
        into a new engine by ``Engine.resume``: every uid finished exactly
        once, tokens identical to the uninterrupted run; ms to write the
        full-width snapshot and to resume, and a captured engine restored in
        place replaying bit-identical to the eager chunk."""
        import tempfile

        import numpy as np

        from repro_torch.launch.engine import Engine
        from repro_torch.launch.kill_resume import audit
        from repro_torch.models import lm

        cfg, model = self.serving[:2]
        sh = self.robust_shape()
        # the rehearsal's short budgets end within a chunk: more requests there
        reqs = trace(cfg, 20 if self.rehearsal else 12, sh["prompts"], sh["budgets"])
        warm = self.robust[2]  # phase 15a's engine, its chunk captured
        self.robust = None
        warm.reset()
        full = warm.run(reqs)
        with tempfile.TemporaryDirectory(prefix="engine-snapshot-") as tmp:
            snap, jpath = Path(tmp) / "snap", Path(tmp) / "journal.jsonl"
            eng = self.robust_engine(snapshot_dir=snap, snapshot_every_chunks=2, journal=jpath)
            write, write_ms = eng.snapshot, []

            def timed_snapshot(*args, **kw):
                self.sync()
                t0 = time.perf_counter()
                path = write(*args, **kw)
                write_ms.append((time.perf_counter() - t0) * 1e3)
                return path

            eng.snapshot = timed_snapshot
            seg1 = eng.run(reqs, max_chunks=3)
            killed = eng.stats["killed"]
            pool_bytes = sum(t.numel() * t.element_size() for t in lm.pool_tensors(eng.pool))
            disk_bytes = sum(f.stat().st_size for f in (snap / "step-2").iterdir())
            del eng
            self.sync()
            t0 = time.perf_counter()
            eng = Engine.resume(model, cfg, snap, journal=jpath)
            self.sync()
            resume_ms = (time.perf_counter() - t0) * 1e3
            restored = sum(o is not None for o in eng._owner)
            seg2 = eng.run([])
            failures = audit(jpath, reqs, {u: c.tokens for u, c in full.items()})
            print(f"  {len(reqs)} requests, killed at chunk 3 ({killed}; {len(seg1)} finished "
                  f"before), the snapshot of chunk 2 resumed with {restored} slots in flight and "
                  f"{eng.stats['journal_replays']} journal replays, {len(seg2)} finished after; "
                  f"against the uninterrupted run, every uid finished exactly once with its "
                  f"tokens: {failures or 'yes'}")
            print(f"  snapshot write {write_ms} ms for {pool_bytes} pool bytes ({disk_bytes} on "
                  f"disk); Engine.resume (a new engine, the restore and the journal replay) "
                  f"{resume_ms:.1f} ms (host clock with synchronize; {self.card})")
            if not killed or failures or len(write_ms) != 1:
                raise AssertionError("kill and resume is not exactly-once and token-identical")
            del eng
            warm.reset()
            self.sync()
            t0 = time.perf_counter()
            warm._restore_snapshot(snap, 2, Engine._read_snapshot_meta(snap, 2))
            self.sync()
            restore_ms = (time.perf_counter() - t0) * 1e3
            print(f"  restore in place into phase 15a's captured engine: {restore_ms:.1f} ms")
            self.replay_equals_eager(warm)
        del warm
        if not self.rehearsal:
            self.torch.cuda.empty_cache()

    def p15g_slo(self):
        """The accuracy SLO on phase 4a's model, phase 13a's engine shape (8
        slots of 576 lines, chunks of 8) and phase 15a's 8 requests:

        * (a) ``canary_stride=None``: tokens identical to phase 15a's engine;
        * (b) stride 8, budgets that never trip: tokens identical to (a)'s,
          canaries counted, the launch counts set to 0 just before and read
          just after (RMSNorm: every admission and step; decode attention:
          every step and canary step); (e) one telemetry record a chunk;
        * (c) a replay with canaries and rungs [0, 1, ...] bit-identical to
          the eager chunk, the packed buffer included, and its ms against
          the eager chunk's;
        * ms a replayed step without an SLO and at strides None, 32 and 8
          (CUDA events around the lifetime clock's 4-chunk cycle, in turns),
          kernels a step of each graph (a profiled replay each), capture
          ms a graph and the graphs captured;
        * (d) ``sqrt_man`` bit 21 at rate 1.0 with stride 2 and no
          promotion: every slot demotes to "exact" in its first chunk, and
          fresh requests in the demoted slots are token-identical to each
          alone in a pool of the engine's shape on ``exact_twin``."""
        import tempfile

        import numpy as np

        from repro_torch.core.faults import FaultConfig
        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import AccuracySLO, Engine, Request
        from repro_torch.launch.telemetry import read_telemetry
        from repro_torch.models import lm

        if self.anchor is None:
            raise AssertionError("phase 15a left no reference tokens")
        reqs, anchor = self.anchor
        self.anchor = None
        cfg, model = self.serving[:2]
        sh = self.robust_shape()
        slots, chunk = sh["slots"], 8
        per_forward = 4 * cfg.n_layers + 1
        quiet = dict(rel_err_budget=1e9, divergence_budget=None, promote_after=None)
        capture_ms = []

        def build(warm=True, **kw):
            eng = self.robust_engine(**kw)
            capture = eng._capture

            def timed(fire):
                self.sync()
                t0 = time.perf_counter()
                capture(fire)
                self.sync()
                capture_ms.append(round((time.perf_counter() - t0) * 1e3, 1))

            eng._capture = timed
            if warm:
                eng.warmup(prompt_lens=sh["prompts"])
            return eng

        def tokens_same(a, b, uids):
            return sum(np.array_equal(a[u].tokens, b[u].tokens) for u in uids)

        uids = [r.uid for r in reqs]
        with tempfile.TemporaryDirectory(prefix="engine-telemetry-") as tmp:
            tpath = Path(tmp) / "telemetry.jsonl"
            engines = {"no SLO": build(),
                       "stride None": build(slo=AccuracySLO(canary_stride=None)),
                       "stride 32": build(slo=AccuracySLO(canary_stride=32, **quiet)),
                       "stride 8": build(slo=AccuracySLO(canary_stride=8, **quiet),
                                         telemetry=tpath)}
            graphs = {name: sorted(e._graphs) for name, e in engines.items()}
            print(f"  graphs captured by warmup (firing patterns): {graphs}; capture ms a graph "
                  f"(its eager chunk on a side stream and the capture, host clock) {capture_ms}")
            want_graphs = {"no SLO": [()], "stride None": [()], "stride 32": [(), (0,)],
                           "stride 8": [(0,)]}
            if not self.rehearsal and graphs != want_graphs:
                raise AssertionError(f"graphs {graphs}, want {want_graphs}")

            # (a) the anchor, (b) read-only canaries with the launch counts
            done_a = engines["stride None"].run(reqs)
            same_a = tokens_same(done_a, anchor, uids)
            e8 = engines["stride 8"]
            self.sync()
            dispatch.reset_launch_counts()
            done_b = e8.run(reqs)
            counts = dispatch.launch_counts()
            st = dict(e8.stats)
            same_b = tokens_same(done_b, done_a, uids)
            chunks = st["decode_chunks"]
            want = {"rmsnorm": per_forward * (len(reqs) + chunks * chunk),
                    "decode_attention": cfg.n_layers * (chunks * chunk + chunks)}
            self.rows["rmsnorm"]["engine_slo_launches"] = counts["rmsnorm"]
            self.rows["decode_attention"]["engine_slo_launches"] = counts["decode_attention"]
            recs = read_telemetry(tpath)
        print(f"  (a) stride None: {same_a} of {len(reqs)} requests token-identical to phase "
              f"15a's engine; (b) stride 8: {same_b} of {len(reqs)} token-identical to (a), "
              f"{st['canary_checks']} canaries, {st['canary_divergences']} divergences, max "
              f"relative logit error {st['canary_max_rel_err']:.4g}, {st['demotions']} "
              f"demotions; {chunks} chunks, launches rmsnorm {counts['rmsnorm']}, "
              f"decode_attention {counts['decode_attention']} (want {want}: step 0 of every "
              f"chunk fires); (e) {len(recs)} telemetry records, "
              f"{sum(r['tokens'] for r in recs)} tokens, "
              f"{sum(r['canary_checks'] for r in recs)} canaries in them")
        if same_a != len(reqs) or same_b != len(reqs):
            raise AssertionError("the SLO engine's tokens part from the SLO-free engine's")
        if not st["canary_checks"] or st["demotions"]:
            raise AssertionError(f"read-only canaries: {st}")
        if not self.rehearsal and any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"launch counts {counts}, want {want}")
        if (len(recs) != chunks or sum(r["tokens"] for r in recs) != st["total_tokens"]
                or sum(r["canary_checks"] for r in recs) != st["canary_checks"]):
            raise AssertionError("the telemetry stream does not add up to the run")

        # (c) a replay with canaries and mixed rungs against the eager chunk
        for slot in range(slots):
            e8._set_level(slot, slot % 2)
        e8._write_levels()
        restore = self.replay_equals_eager(e8, reqs[:slots])
        restore()
        self.sync()
        t0 = time.perf_counter()
        e8._chunk_eager()
        self.sync()
        eager_ms = (time.perf_counter() - t0) * 1e3
        restore()
        replay_ms = self.time_ms(e8._decode_chunk, iters=4)
        if replay_ms is not None:
            print(f"  rungs {e8.unit_levels}: an eager chunk {eager_ms / chunk:.3f} ms a step "
                  f"(host clock), replayed {replay_ms / chunk:.3f} (CUDA events around 4 "
                  f"replays): {eager_ms / replay_ms:.1f}x")

        # ms a replayed step and kernels a step, from one admitted pool state
        restores = {}
        for name, eng in engines.items():
            eng.reset()
            for slot, r in enumerate(reqs[:slots]):
                eng._admit(r, slot, 0.0)
            start = [t.clone() for t in lm.pool_tensors(eng.pool)]
            restores[name] = lambda eng=eng, start=start: [
                t.copy_(s0) for t, s0 in zip(lm.pool_tensors(eng.pool), start)]

        def cycle(eng):
            """The chunks of the lifetime clock's cycle: 4 (stride 32), or one
            chunk where every chunk fires alike."""
            n = 4 if len(eng._patterns()) > 1 else 1

            def run():
                for k in range(n):
                    eng._chunks_total = k
                    eng._decode_chunk()
            return run, n

        ms = {name: [] for name in engines}
        for name in list(engines) + list(engines)[::-1]:
            restores[name]()
            run, n = cycle(engines[name])
            t = self.time_ms(run, iters=4 // n)
            ms[name].append(round(t / (n * chunk), 4) if t is not None else None)
        print(f"  ms a replayed decode step (CUDA events around 4 chunks, stride 32's over the "
              f"lifetime clock's 4-chunk cycle, in turns; {self.card}): {ms}")
        self.slo_ref = dict(reqs=reqs, shape=dict(sh, chunk=chunk), done=done_b, stats=st,
                            step_ms=ms["stride 8"][0] or float("nan"))
        for name, eng in engines.items():
            for fire in eng._patterns():
                restores[name]()
                eng._chunks_total = next(k for k in range(4) if eng._firing(k) == fire)
                _, rows = self.profiled(eng._decode_chunk, 1, every_launch=True)
                print(f"  {name}, canary steps {list(fire)}: "
                      f"{sum(r[1] for r in rows) / chunk:.1f} kernels a step, device busy "
                      f"{sum(r[0] for r in rows) / chunk / 1e3:.3f} ms a step (a profiled replay)")
        del engines, restores, e8

        # (d) demotion under pressure, then fresh requests on the exact rung
        ed = build(warm=False, faults=FaultConfig("sqrt_man", 1.0, seed=7, bit=21),
                   slo=AccuracySLO(canary_stride=2, rel_err_budget=0.05, divergence_budget=0,
                                   promote_after=None))
        t0 = time.perf_counter()
        ed.run([Request(uid=100 + i, prompt=r.prompt, max_new_tokens=chunk)
                for i, r in enumerate(reqs[:slots])])
        first = dict(ed.stats)
        probes = [Request(uid=200 + i, prompt=r.prompt, max_new_tokens=2 * chunk)
                  for i, r in enumerate(reqs[:slots])]
        done_d = ed.run(probes)
        run_s = time.perf_counter() - t0
        names = ed.unit_names
        ex = Engine(model, lm.exact_twin(ed.cfg), num_slots=slots, cache_len=sh["cache_len"],
                    chunk=chunk)
        del ed
        same_d = 0
        for r in probes:
            ex.reset()
            alone = ex.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)])
            same_d += int(np.array_equal(alone[r.uid].tokens, done_d[r.uid].tokens))
        print(f"  (d) sqrt_man bit 21 at rate 1.0, stride 2: {first['demotions']} demotions, "
              f"{first['canary_checks']} canaries, max relative error "
              f"{first['canary_max_rel_err']:.4g} in the first {first['decode_chunks']} chunks; "
              f"rungs {names}; {same_d} of {len(probes)} fresh requests in the demoted slots "
              f"token-identical to each alone on exact_twin; {run_s:.2f} s (the faulted "
              f"chunk's capture included)")
        if names != ("exact",) * slots or first["demotions"] != slots or same_d != len(probes):
            raise AssertionError(f"demotion under pressure: {first}")
        self.slo_ref["pressure"] = dict(first=first, names=names, probes=probes, done=done_d)
        del ex
        if not self.rehearsal:
            self.torch.cuda.empty_cache()

    def p15f_start(self):
        """Start ``python -m repro_torch.launch.kill_resume`` on this device
        in the background: a child process serving at smoke width is
        SIGKILLed mid-serve and resumed in its parent.  It runs beside phase
        15b, whose checks are token equalities (its two processes' start
        would add about 18 s alone); phase 15f joins it before 15c times
        anything."""
        env = dict(os.environ, PYTHONPATH=str(SRC) + (
            os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""))
        self.sigkill = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.kill_resume", "--device", self.dev.type],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def p15f_sigkill(self):
        """Join the SIGKILL smoke of :meth:`p15f_start`: exactly once and
        token-identical in the parent, or the phase fails."""
        t0, proc = self.sigkill
        self.sigkill = None
        try:
            out, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for line in out.splitlines():
            print(f"  {line}")
        print(f"  exit code {proc.returncode} {time.perf_counter() - t0:.1f} s after its start "
              f"(two processes, beside phase 15b)")
        if proc.returncode != 0:
            raise AssertionError("the SIGKILL smoke failed")

    def p14d_remat(self):
        """Phase 11's training model and first batch (qwen3-4b, 8 layers, bf16,
        e2afs norms) through one forward and backward with remat "block",
        "minimal" and "none", under torch's deterministic algorithms: the
        loss and every gradient bit-identical across the three (the
        embedding's scattered gradient, if not, within one bf16 ulp); peak
        memory, ms and e2afs launches of each."""
        torch = self.torch
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.kernels import dispatch
        from repro_torch.launch.steps import loss_fn
        from repro_torch.models import lm

        kw = dict(n_layers=8, sqrt_unit="e2afs")
        if self.rehearsal:
            cfg, batch, seq = get_smoke_config("qwen3-4b", **kw), 2, 64
        else:
            cfg, batch, seq = get_config("qwen3-4b", **kw), 4, 2048
            torch.cuda.empty_cache()
        model = lm.init(cfg, self.gen(0), device=self.dev, trainable=True)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
        b = {k: torch.from_numpy(a).to(self.dev) for k, a in data.batch(0).items()}
        params = dict(model.named_parameters())

        def step(c):
            for p in params.values():
                p.grad = None
            total, _ = loss_fn(model, c, b)
            total.backward()
            return total.detach()

        ref, bad, near = None, [], []
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for mode in ("block", "minimal", "none"):
                c = cfg.replace(remat=mode)
                step(c)  # warm-up
                self.sync()
                base = torch.cuda.memory_allocated() if not self.rehearsal else 0
                if not self.rehearsal:
                    torch.cuda.reset_peak_memory_stats()
                dispatch.reset_launch_counts()
                t0 = time.perf_counter()
                loss = step(c)
                self.sync()
                ms = (time.perf_counter() - t0) * 1e3
                counts = {k: v for k, v in dispatch.launch_counts().items() if v}
                peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if not self.rehearsal \
                    else float("nan")
                print(f"  remat {mode:7s}: loss {float(loss):.6f}, {ms:.1f} ms a forward and "
                      f"backward (host clock with synchronize), peak {peak:.2f} GiB above the "
                      f"{base / 2**30:.2f} GiB of parameters and gradients held; launches "
                      f"{counts}; {self.card}")
                grads = {n: p.grad.detach().cpu() for n, p in params.items()}
                if ref is None:
                    ref = (loss.cpu(), grads)
                    continue
                if not torch.equal(loss.cpu().view(torch.int32), ref[0].view(torch.int32)):
                    bad.append(f"{mode}: loss")
                for n, g in grads.items():
                    if torch.equal(g.view(torch.int32), ref[1][n].view(torch.int32)):
                        continue
                    off = float(((g - ref[1][n]).abs() / ulp_of(ref[1][n].to(
                        torch.bfloat16)).float().clamp_min(1e-45)).max())
                    (near if n == "embed" and off <= 1.0 else bad).append(f"{mode}: {n}")
        finally:
            torch.use_deterministic_algorithms(prev)
            for p in params.values():
                p.grad = None
        print(f"  against remat block: {len(bad)} leaves or losses differ "
              f"({bad[:4]}); within one bf16 ulp, not bit-identical: {near}")
        if bad:
            raise AssertionError(f"remat modes give other gradients: {bad[:8]}")

    # -- phase 5 -----------------------------------------------------------
    def p5_times(self):
        torch = self.torch
        F = torch.nn.functional
        from repro_torch.kernels.attention import ops as attn_ops
        from repro_torch.kernels.e2afs_sqrt import ops as e_ops
        from repro_torch.kernels.e2afs_sqrt import ref as e_ref
        from repro_torch.kernels.rmsnorm import ops as r_ops
        from repro_torch.kernels.rmsnorm import ref as r_ref

        def bound(nbytes, flops, dtype):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

        def record(name, kern, plain, bound_pair, lib, shape_note):
            """ms, plain_ms, library_ms: device time per call (profiler);
            *events_ms: CUDA events around back-to-back calls, the host's
            launch rate included."""
            row = self.rows[name]
            row.update(ms=self.device_ms(kern), plain_ms=self.device_ms(plain),
                       bound_ms=bound_pair[0], bound_by=bound_pair[1],
                       library_ms=self.device_ms(lib) if lib else None,
                       events_ms=self.time_ms(kern), plain_events_ms=self.time_ms(plain),
                       library_events_ms=self.time_ms(lib) if lib else None)
            print(f"  {name:16s} {shape_note}: device ms per call: kernel {row['ms']}, plain "
                  f"{row['plain_ms']}, library {row['library_ms']}; events ms per call: kernel "
                  f"{row['events_ms']}, plain {row['plain_events_ms']}, library "
                  f"{row['library_events_ms']}; bound {bound_pair[0]:.6f} ms ({bound_pair[1]})")

        # e2afs: the unit path's shape in each format, every call on inputs
        # and outputs that the calls before it left cold (a rotation over at
        # least 4x the L2), beside the first design, the plain version and
        # torch.sqrt / torch.rsqrt (exact: another function, the same bytes)
        # on the same rotation; the float32 row goes into the kernels line.
        # Then the float32 call on one input, as timed before the rotation.
        shape = (2, 16, 64) if self.rehearsal else (8, 512, 2560)
        n = math.prod(shape)
        for name, rsqrt, kern, plain, lib in (
                ("e2afs_sqrt", False, e_ops.sqrt, e_ref.ref_sqrt, torch.sqrt),
                ("e2afs_rsqrt", True, e_ops.rsqrt, e_ref.ref_rsqrt, torch.rsqrt)):
            row = self.rows[name]
            row["formats"] = []
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                size = torch.finfo(dtype).bits // 8
                sets = 2 if self.rehearsal else -(-COLD_BYTES // (2 * n * size))
                xs = [(torch.rand(shape, generator=self.gen(30 + i), device=self.dev) * 4.0
                       + 1e-3).to(dtype) for i in range(sets)]
                first = functools.partial(e_ops.scalar_design, rsqrt=rsqrt)
                at = {"dtype": str(dtype), "elements": n, "sets": sets,
                      "ms": self.device_ms(cold(kern, xs)),
                      "first_design_ms": self.device_ms(cold(first, xs)),
                      "plain_ms": self.device_ms(cold(plain, xs)),
                      "library_ms": self.device_ms(cold(lib, xs)),
                      "bound_ms": 2 * n * size / HBM_BYTES_PER_S * 1e3}
                share = (f"{at['bound_ms'] / at['ms']:.3f}" if at["ms"] else "not measured")
                print(f"  {name} {tuple(shape)} {str(dtype):14s} cold ({sets} sets): device ms "
                      f"per call: kernel {at['ms']}, first design {at['first_design_ms']}, plain "
                      f"{at['plain_ms']}, {lib.__name__} {at['library_ms']}; bound "
                      f"{at['bound_ms']:.6f} ms (bytes); bound / kernel {share}")
                row["formats"].append(at)
                if dtype == torch.float32:
                    row.update(ms=at["ms"], plain_ms=at["plain_ms"], library_ms=at["library_ms"],
                               bound_ms=at["bound_ms"], bound_by="bytes",
                               events_ms=self.time_ms(cold(kern, xs)),
                               library_events_ms=self.time_ms(cold(lib, xs)))
                del xs
            x = torch.rand(shape, generator=self.gen(2), device=self.dev) * 4.0 + 1e-3
            row.update(unrotated_ms=self.device_ms(lambda k=kern: k(x)),
                       unrotated_library_ms=self.device_ms(lambda f=lib: f(x)))
            print(f"  {name} {tuple(shape)} float32 on one input (not rotated): device ms per "
                  f"call: kernel {row['unrotated_ms']}, {lib.__name__} "
                  f"{row['unrotated_library_ms']}; events ms per call (cold): kernel "
                  f"{row['events_ms']}, {lib.__name__} {row['library_events_ms']}")

        # rmsnorm: the decode layer-norm shape, bf16, in the kernels line;
        # then every serving shape of phase 2 in bf16, each beside its byte
        # bound and F.rms_norm (exact rsqrt: another function, same work)
        b, s_len, h, kv = (2, 16, 4, 2) if self.rehearsal else (8, 512, 32, 8)
        rms_shapes = [(b, 2560), (b * h, 128), (b * kv, 128), (b * s_len, 2560),
                      (b * s_len * kv, 128), (b * s_len * h, 128)]
        rows, d = rms_shapes[0]
        xs, s = self.rms_inputs(rows, d, torch.bfloat16, 7)
        weight = 1.0 + s
        record("rmsnorm", lambda: r_ops.rmsnorm(xs, s), lambda: r_ref.ref_rmsnorm(xs, s),
               bound((2 * rows * d + d) * 2, 4 * rows * d, "bfloat16"),
               lambda: F.rms_norm(xs, (d,), weight=weight, eps=1e-6), f"({rows}, {d}) bfloat16")
        self.rows["rmsnorm"]["shapes"] = []
        for rows, d in rms_shapes:
            xs, s = self.rms_inputs(rows, d, torch.bfloat16, 7 + rows)
            weight = 1.0 + s
            at = {"shape": [rows, d],
                  "ms": self.device_ms(lambda: r_ops.rmsnorm(xs, s)),
                  "bound_ms": bound((2 * rows * d + d) * 2, 4 * rows * d, "bfloat16")[0],
                  "library_ms": self.device_ms(
                      lambda: F.rms_norm(xs, (d,), weight=weight, eps=1e-6))}
            self.rows["rmsnorm"]["shapes"].append(at)
            print(f"  rmsnorm ({rows}, {d}) bfloat16: device ms per call: kernel {at['ms']}, "
                  f"F.rms_norm {at['library_ms']}; bound {at['bound_ms']:.6f} ms (bytes)")
        # gemma3-1b's rows, the same way, plus events and the plain version
        self.rows["rmsnorm"]["gemma3_shapes"] = []
        for rows, d in self.gemma_rms_shapes():
            xs, s = self.rms_inputs(rows, d, torch.bfloat16, 70 + rows + d)
            weight = 1.0 + s
            at = {"shape": [rows, d],
                  "ms": self.device_ms(lambda: r_ops.rmsnorm(xs, s)),
                  "events_ms": self.time_ms(lambda: r_ops.rmsnorm(xs, s)),
                  "plain_ms": self.device_ms(lambda: r_ref.ref_rmsnorm(xs, s)),
                  "bound_ms": bound((2 * rows * d + d) * 2, 4 * rows * d, "bfloat16")[0],
                  "library_ms": self.device_ms(
                      lambda: F.rms_norm(xs, (d,), weight=weight, eps=1e-6))}
            self.rows["rmsnorm"]["gemma3_shapes"].append(at)
            print(f"  rmsnorm gemma3-1b ({rows}, {d}) bfloat16: device ms per call: kernel "
                  f"{at['ms']}, plain {at['plain_ms']}, F.rms_norm {at['library_ms']}; events ms: "
                  f"kernel {at['events_ms']}; bound {at['bound_ms']:.6f} ms (bytes)")

        # decode attention: one decode step's layer at the serving widths,
        # every cache line live (the last step), at the serving cache (576,
        # in the kernels line) and at 4096; enough copies of the cache to
        # stream more than twice the 50 MB L2 between repeats.
        b, h, kv, hd = (2, 8, 2, 32) if self.rehearsal else (8, 32, 8, 128)
        g = h // kv
        self.rows["decode_attention"]["lengths"] = []
        for t in ((24, 40) if self.rehearsal else (576, 4096)):
            pos = torch.full((b,), t - 1, dtype=torch.int32, device=self.dev)
            one = self.attn_inputs(b, h, kv, hd, t, torch.bfloat16, False, 11, pos=pos)
            cache_bytes = 2 * one[1].numel() * 2
            copies = 1 if self.rehearsal else max(1, -(-100_000_000 // cache_bytes))
            sets = [one] + [self.attn_inputs(b, h, kv, hd, t, torch.bfloat16, False, 12 + i,
                                             pos=pos) for i in range(copies - 1)]
            it = {"i": 0}

            def rotating(fn, sets=sets, it=it):
                def call():
                    a = sets[it["i"] % len(sets)]
                    it["i"] += 1
                    return fn(a)
                return call

            mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=self.dev)

            def sdpa(a, mask=mask):  # (b, h, 1, hd) against (b, kv, t, hd) views of the cache
                return F.scaled_dot_product_attention(a[0][:, :, None], a[1].transpose(1, 2),
                                                      a[2].transpose(1, 2), attn_mask=mask,
                                                      enable_gqa=True)

            nbytes = (b * h * hd * 2) * 2 + cache_bytes + b * 4
            bnd = bound(nbytes, 4 * b * h * t * hd, "bfloat16")
            kern = rotating(lambda a: attn_ops.decode_attention(*a, scale=hd**-0.5))
            note = f"b={b} h={h} kv={kv} hd={hd} t={t} bfloat16 (g={g}, {copies} cache copies)"
            at = {"t": t, "bound_ms": bnd[0]}
            if not self.rehearsal:
                at.update(attn_ops.plan(one[0], one[1]))
                at.pop("workspace")
                note += (f", S={at['chunks']} chunks of {at['chunk_lines']} lines, "
                         f"{at['slots']} slots a launch")
            if t == 576 or (self.rehearsal and t == 24):
                record("decode_attention", kern,
                       rotating(lambda a: attn_ops.ref_decode_attention(*a, scale=hd**-0.5)),
                       bnd, rotating(sdpa), note)
                at.update(ms=self.rows["decode_attention"]["ms"],
                          library_ms=self.rows["decode_attention"]["library_ms"])
            else:
                at.update(ms=self.device_ms(kern), library_ms=self.device_ms(rotating(sdpa)))
                print(f"  decode_attention {note}: device ms per call: kernel {at['ms']}, SDPA "
                      f"{at['library_ms']}; bound {bnd[0]:.6f} ms ({bnd[1]})")
            self.rows["decode_attention"]["lengths"].append(at)

        # gemma3-1b's decode layer (b 8, one KV head of 4 query heads, head_dim
        # 256): a window layer's wrapped 512-line ring and a global layer's
        # 2112 lines at the last step, in bf16 (the serving path) and float32
        # (two vectors a lane), each beside its byte bound and SDPA
        b, h, kv, hd = 8, 4, 1, 256
        self.rows["decode_attention"]["gemma3_shapes"] = []
        ring, full = (24, 40) if self.rehearsal else (512, 2112)
        for dtype, t in itertools.product((torch.bfloat16, torch.float32), (ring, full)):
            wrap = t == ring  # the window layer's ring, wrapped at the last step
            last = full - 1 if wrap else t - 1
            pos = torch.full((b,), last, dtype=torch.int32, device=self.dev)
            size = torch.finfo(dtype).bits // 8
            cache_bytes = 2 * b * t * kv * hd * size
            copies = 1 if self.rehearsal else max(1, -(-100_000_000 // cache_bytes))
            sets = [self.attn_inputs(b, h, kv, hd, t, dtype, False, 40 + i, pos=pos)
                    for i in range(copies)]
            it = {"i": 0}

            def rotating(fn, sets=sets, it=it):
                def call():
                    a = sets[it["i"] % len(sets)]
                    it["i"] += 1
                    return fn(a)
                return call

            mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=self.dev)

            def sdpa(a, mask=mask):
                return F.scaled_dot_product_attention(a[0][:, :, None], a[1].transpose(1, 2),
                                                      a[2].transpose(1, 2), attn_mask=mask,
                                                      enable_gqa=True)

            nbytes = (b * h * hd * size) * 2 + cache_bytes + b * 4
            bnd = bound(nbytes, 4 * b * h * t * hd,
                        "bfloat16" if dtype == torch.bfloat16 else "float32")
            at = {"dtype": str(dtype), "t": t, "wrap": wrap, "bound_ms": bnd[0],
                  "ms": self.device_ms(rotating(
                      lambda a, w=wrap: attn_ops.decode_attention(*a, scale=hd**-0.5, wrap=w))),
                  "events_ms": self.time_ms(rotating(
                      lambda a, w=wrap: attn_ops.decode_attention(*a, scale=hd**-0.5, wrap=w))),
                  "plain_ms": self.device_ms(rotating(
                      lambda a, w=wrap: attn_ops.ref_decode_attention(*a, scale=hd**-0.5,
                                                                      wrap=w))),
                  "library_ms": self.device_ms(rotating(sdpa))}
            if not self.rehearsal:
                plan = attn_ops.plan(sets[0][0], sets[0][1])
                at.update(chunks=plan["chunks"], chunk_lines=plan["chunk_lines"])
            self.rows["decode_attention"]["gemma3_shapes"].append(at)
            print(f"  decode_attention gemma3-1b b={b} h={h} kv={kv} hd={hd} t={t} {dtype} "
                  f"wrap={wrap} ({copies} cache copies, S={at.get('chunks')}): device ms per "
                  f"call: kernel {at['ms']}, plain {at['plain_ms']}, SDPA {at['library_ms']}; "
                  f"events ms: kernel {at['events_ms']}; bound {bnd[0]:.6f} ms ({bnd[1]})")

        # phase 16's groups at t = 576, b = 8, bf16, every line live: the
        # kernel, its plain version and SDPA beside the byte bound
        self.rows["decode_attention"]["wide_groups"] = []
        b, hd, t = (2, 32, 24) if self.rehearsal else (8, 128, 576)
        for model_name, g, kv in (("starcoder2-15b", 12, 4), ("mixtral-8x22b", 6, 8),
                                  ("qwen3-moe-235b-a22b", 16, 4)):
            h = g * kv
            pos = torch.full((b,), t - 1, dtype=torch.int32, device=self.dev)
            cache_bytes = 2 * b * t * kv * hd * 2
            copies = 1 if self.rehearsal else max(1, -(-100_000_000 // cache_bytes))
            sets = [self.attn_inputs(b, h, kv, hd, t, torch.bfloat16, False, 50 + i, pos=pos)
                    for i in range(copies)]
            it = {"i": 0}

            def rotating(fn, sets=sets, it=it):
                def call():
                    a = sets[it["i"] % len(sets)]
                    it["i"] += 1
                    return fn(a)
                return call

            mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=self.dev)

            def sdpa(a, mask=mask):
                return F.scaled_dot_product_attention(a[0][:, :, None], a[1].transpose(1, 2),
                                                      a[2].transpose(1, 2), attn_mask=mask,
                                                      enable_gqa=True)

            nbytes = (b * h * hd * 2) * 2 + cache_bytes + b * 4
            bnd = bound(nbytes, 4 * b * h * t * hd, "bfloat16")
            at = {"model": model_name, "g": g, "kv": kv, "b": b, "t": t, "hd": hd,
                  "bound_ms": bnd[0], "bound_by": bnd[1],
                  "ms": self.device_ms(rotating(
                      lambda a: attn_ops.decode_attention(*a, scale=hd**-0.5))),
                  "plain_ms": self.device_ms(rotating(
                      lambda a: attn_ops.ref_decode_attention(*a, scale=hd**-0.5))),
                  "library_ms": self.device_ms(rotating(sdpa))}
            if not self.rehearsal:
                plan = attn_ops.plan(sets[0][0], sets[0][1])
                at.update(chunks=plan["chunks"], chunk_lines=plan["chunk_lines"])
            self.rows["decode_attention"]["wide_groups"].append(at)
            share = f"{bnd[0] / at['ms']:.3f}" if at["ms"] else "not measured"
            print(f"  decode_attention {model_name} b={b} h={h} kv={kv} hd={hd} t={t} bfloat16 "
                  f"(g={g}, {copies} cache copies, S={at.get('chunks')}): device ms per call: "
                  f"kernel {at['ms']}, plain {at['plain_ms']}, SDPA {at['library_ms']}; bound "
                  f"{bnd[0]:.6f} ms ({bnd[1]}); bound / kernel {share}")

        # recurrentgemma-2b's window layer at b = 8, t = 2048 (its ring), bf16,
        # wrap, and whisper-small's decoder self-attention (12 KV heads of one
        # query head each, head_dim 64) at b = 8, t = 192, bf16, every line
        # live: each beside its plain version, SDPA and the byte bound
        for key, model_name, (b, h, kv, hd, t), wrap in (
                ("g10", "recurrentgemma-2b",
                 (2, 10, 1, 256, 24) if self.rehearsal else (8, 10, 1, 256, 2048), True),
                ("g1_hd64", "whisper-small",
                 (2, 12, 12, 64, 24) if self.rehearsal else (8, 12, 12, 64, 192), False)):
            pos = torch.full((b,), t + 100 if wrap else t - 1, dtype=torch.int32,
                             device=self.dev)
            cache_bytes = 2 * b * t * kv * hd * 2
            copies = 1 if self.rehearsal else max(1, -(-100_000_000 // cache_bytes))
            sets = [self.attn_inputs(b, h, kv, hd, t, torch.bfloat16, False, 70 + i, pos=pos)
                    for i in range(copies)]
            it = {"i": 0}

            def rotating(fn, sets=sets, it=it):
                def call():
                    a = sets[it["i"] % len(sets)]
                    it["i"] += 1
                    return fn(a)
                return call

            mask = torch.ones(b, 1, 1, t, dtype=torch.bool, device=self.dev)

            def sdpa(a, mask=mask):
                return F.scaled_dot_product_attention(a[0][:, :, None], a[1].transpose(1, 2),
                                                      a[2].transpose(1, 2), attn_mask=mask,
                                                      enable_gqa=True)

            nbytes = (b * h * hd * 2) * 2 + cache_bytes + b * 4
            bnd = bound(nbytes, 4 * b * h * t * hd, "bfloat16")
            at = {"model": model_name, "g": h // kv, "kv": kv, "b": b, "t": t, "hd": hd,
                  "wrap": wrap, "bound_ms": bnd[0], "bound_by": bnd[1],
                  "ms": self.device_ms(rotating(
                      lambda a, w=wrap: attn_ops.decode_attention(*a, scale=hd**-0.5, wrap=w))),
                  "events_ms": self.time_ms(rotating(
                      lambda a, w=wrap: attn_ops.decode_attention(*a, scale=hd**-0.5, wrap=w))),
                  "plain_ms": self.device_ms(rotating(
                      lambda a, w=wrap: attn_ops.ref_decode_attention(*a, scale=hd**-0.5,
                                                                      wrap=w))),
                  "library_ms": self.device_ms(rotating(sdpa))}
            if not self.rehearsal:
                plan = attn_ops.plan(sets[0][0], sets[0][1])
                at.update(chunks=plan["chunks"], chunk_lines=plan["chunk_lines"])
            self.rows["decode_attention"][key] = at
            share = f"{bnd[0] / at['ms']:.3f}" if at["ms"] else "not measured"
            print(f"  decode_attention {model_name} b={b} h={h} kv={kv} hd={hd} t={t} bfloat16 "
                  f"wrap={wrap} (g={h // kv}, {copies} cache copies, S={at.get('chunks')}): "
                  f"device ms per call: kernel {at['ms']}, plain {at['plain_ms']}, SDPA "
                  f"{at['library_ms']}; events ms: kernel {at['events_ms']}; bound "
                  f"{bnd[0]:.6f} ms ({bnd[1]}); bound / kernel {share} ({self.card})")
            del sets

        # sobel: a 2160 x 3840 frame.  No PyTorch call computes the E2AFS
        # magnitude: library_ms is None, and F.conv2d + torch.sqrt (another
        # function) is printed as a near-yardstick only.
        from repro_torch.kernels.kmeans import ops as k_ops
        from repro_torch.kernels.kmeans import ref as k_ref
        from repro_torch.kernels.sobel import ops as s_ops
        from repro_torch.kernels.sobel import ref as s_ref

        h, w = (108, 192) if self.rehearsal else (2160, 3840)
        img = torch.rand(h, w, generator=self.gen(13), device=self.dev) * 255
        taps = torch.tensor([[[[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]],
                             [[[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]]]],
                            device=self.dev)

        def conv_sqrt():
            gxy = F.conv2d(img[None, None], taps)[0]
            return torch.sqrt(torch.clamp(gxy[0] * gxy[0] + gxy[1] * gxy[1], min=1e-12))

        out_px = (h - 2) * (w - 2)
        t_bytes = (h * w + out_px) * 4 / HBM_BYTES_PER_S * 1e3
        # per output: 18 tap products and 18 sums, gx^2 + gy^2 (3), the
        # clamp (1) in float32; the E2AFS sqrt on the INT32 lanes
        t_ops = ops_bound_ms(out_px * 40, out_px * E2AFS_SQRT_INT_OPS)
        record("sobel", lambda: s_ops.sobel_magnitude(img), lambda: s_ref.ref_sobel(img),
               (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"), None,
               f"({h}, {w}) float32")
        self.rows["sobel"]["yardstick"] = "F.conv2d + torch.sqrt (another function)"
        self.rows["sobel"]["yardstick_ms"] = self.device_ms(conv_sqrt)

        # kmeans_assign: the 1920 x 1080 frame, K = 20.  Yardstick, again
        # another function: torch.cdist + argmin.
        px, cent = self.pixels(self.frame(), 20, 20)
        n, k = px.shape[0], cent.shape[0]
        t_bytes = (n * 3 * 4 + k * 3 * 4 + n * 4 + k * 4 * 4) / HBM_BYTES_PER_S * 1e3
        # per (pixel, centroid): 3 differences, 3 squares, 2 sums, the clamp
        # and the argmin compare in float32 (10); the E2AFS sqrt and the two
        # argmin selects (best distance, index) on the INT32 lanes
        t_ops = ops_bound_ms(n * k * 10, n * k * (E2AFS_SQRT_INT_OPS + 2))
        record("kmeans_assign", lambda: k_ops.kmeans_assign(px, cent),
               lambda: k_ref.ref_kmeans_assign(px, cent),
               (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"), None,
               f"N={n} (frame {self.frame().shape[1]}x{self.frame().shape[0]}) K={k} float32")
        self.rows["kmeans_assign"]["yardstick"] = "torch.cdist + argmin (another function)"
        self.rows["kmeans_assign"]["yardstick_ms"] = self.device_ms(
            lambda: torch.cdist(px, cent).argmin(1))
        if not self.rehearsal:
            from repro_torch.kernels import _build

            try:
                pairs, per_pair = sass_per_pair(_build.build().libraries["kmeans_assign"])
            except Exception as exc:  # a reading, not a check: report and go on
                print(f"  kmeans_assign SASS: not read ({exc!r})")
            else:
                ints = sum(c for op, c in per_pair.items() if op in SASS_INT)
                floats = sum(c for op, c in per_pair.items() if op in SASS_FLOAT)
                self.rows["kmeans_assign"]["sass_per_pair"] = {
                    "int": ints, "float": floats, "all": sum(per_pair.values())}
                print(f"  kmeans_assign SASS of the distance loop ({pairs} pairs a pass): per "
                      f"pair {ints:.3f} integer, {floats:.3f} float, "
                      f"{sum(per_pair.values()):.3f} in all; bound counts "
                      f"{E2AFS_SQRT_INT_OPS + 2} integer and 10 float; "
                      + ", ".join(f"{op} {c:.3f}" for op, c in per_pair.items()))
        for name in ("sobel", "kmeans_assign"):
            print(f"  {name} near-yardstick {self.rows[name]['yardstick']}: device ms per call "
                  f"{self.rows[name]['yardstick_ms']}")

        # adam: one wi_gate leaf of qwen3-4b (2560 x 9728), float32 p and g.
        # torch.optim.AdamW(fused=True) is another function (exact sqrt, the
        # decay applied before the step): a yardstick, not library_ms.
        from repro_torch.kernels.adam import ops as a_ops
        from repro_torch.kernels.adam import ref as a_ref

        shape = (256, 97) if self.rehearsal else (2560, 9728)
        p, g, m, v, sched = self.adam_inputs(shape, torch.float32, torch.float32, 1000, False, 21)
        hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
        record("adam", lambda: a_ops.adam_update(p, g, m, v, sched, **hyper),
               lambda: a_ref.ref_adam_update(p, g, m, v, sched, **hyper),
               (p.numel() * ADAM_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3, "bytes"), None,
               f"{shape} float32")
        w = torch.nn.Parameter(p.clone())
        w.grad = g.clone()
        fused = dict(fused=True) if self.dev.type == "cuda" else {}
        opt = torch.optim.AdamW([w], lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                                **fused)
        opt.step()
        self.rows["adam"]["yardstick"] = ("torch.optim.AdamW(fused=True) (another function: "
                                          "exact sqrt, decay before the step)")
        self.rows["adam"]["yardstick_ms"] = self.device_ms(opt.step)
        print(f"  adam near-yardstick {self.rows['adam']['yardstick']}: device ms per call "
              f"{self.rows['adam']['yardstick_ms']}")
        from repro_torch.configs import get_config
        from repro_torch.models import lm

        meta = lm.LM(get_config("qwen3-4b", n_layers=8), device="meta", trainable=True)
        n = lm.param_count(meta)
        print(f"  adam bound of one training step of qwen3-4b at 8 layers: {n} parameters x "
              f"{ADAM_BYTES_PER_PARAM} B = {n * ADAM_BYTES_PER_PARAM / 1e9:.2f} GB, "
              f"{n * ADAM_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3:.3f} ms")

    # -- shared inputs of phases 5, 7-9 ----------------------------------------
    def frame(self):
        """One RGB frame of the deployment size (1920 x 1080; tiny in a
        rehearsal): the peppers stand-in drawn at the frame's width, cropped."""
        import numpy as np
        from repro_torch.apps.images import rgb_test_image

        if getattr(self, "_frame", None) is None:
            h, w = (54, 96) if self.rehearsal else (1080, 1920)
            self._frame = np.ascontiguousarray(rgb_test_image("peppers", w)[:h])
        return self._frame

    def stack(self):
        """The deployment batch: 16 images of 512 x 512 (tiny in a
        rehearsal), the four stand-ins in four rotations each."""
        import numpy as np
        from repro_torch.apps.images import IMAGE_NAMES, rgb_test_image

        if getattr(self, "_stack", None) is None:
            side = 32 if self.rehearsal else 512
            self._stack = np.stack([np.rot90(rgb_test_image(name, side), r)
                                    for name in IMAGE_NAMES for r in range(4)])
        return self._stack

    def pixels(self, rgb, k, seed):
        from repro_torch.apps.kmeans import init_centroids

        pix = self.torch.as_tensor(rgb.reshape(-1, 3)).to(self.dev, self.torch.float32)
        return pix.contiguous(), init_centroids(pix, seed, k).contiguous()

    # -- phase 15h/15i: speculative decoding ------------------------------
    def p15h_spec(self):
        """Speculative decoding on phase 4a's model, phase 13a's engine shape
        and trace (n-gram drafting, k = 4), then model drafting at k = 3 on
        13a's first 8 requests, the draft qwen3-4b's config cut to 4 layers
        with random weights from seed 1 (see :meth:`spec_phase`)."""
        from repro_torch.models import lm

        cfg, model = self.serving[:2]
        dcfg = cfg.replace(n_layers=1 if self.rehearsal else 4)
        self.spec_phase(cfg, model, "engine_qwen3_4b_launches", k=4,
                        draft=(lm.init(dcfg, self.gen(1), device=self.dev), dcfg))

    def p15i_spec_gemma(self):
        """The same on phase 4d's gemma3-1b with phase 13b's shape and trace
        (prompts past the 512-line window: the rings wrap and roll back),
        n-gram drafting at k = 4."""
        self.spec_phase(*self.gemma, "engine_gemma3_1b_launches", k=4)

    def gemm_rows(self, cfg, model, b, sq):
        """For each projection of a verify block of ``sq`` rows over ``b``
        slots (QKV, ``wo``, the MLP's three, the unembed), whether one
        ``b * sq``-row product gives every row the bits of the ``b``-row
        product (``layers.rowwise``: where not, the verify multiplies row by
        row); and the RMSNorm kernel's rows over ``b * sq`` rows against
        ``b`` rows, at the layer norms' and the qk-norms' widths."""
        torch = self.torch
        from repro_torch.layers import rowwise
        from repro_torch.layers.norms import rmsnorm_cfg

        layer, dt = model.layers[0], model.embed.dtype
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.d_head
        weights = {"wq": layer.attn.wq.reshape(d, -1), "wk": layer.attn.wk.reshape(d, -1),
                   "wv": layer.attn.wv.reshape(d, -1), "wo": layer.attn.wo.reshape(h * hd, -1),
                   "wi_gate": layer.mlp.wi_gate, "wi_up": layer.mlp.wi_up,
                   "mlp wo": layer.mlp.wo, "unembed": model.unembed_matrix()}
        gen = self.gen(7)
        out = {}
        for name, w in weights.items():
            x = torch.randn((b, sq, w.shape[0]), generator=gen, device=self.dev).to(dt)
            out[name] = rowwise.batched_rows_equal(x, w)
        norms = {}
        for name, shape, scale in (("ln", (b, sq, d), layer.ln1),
                                   ("qk-norm", (b, sq, h, hd), layer.attn.q_norm)):
            x = torch.randn(shape, generator=gen, device=self.dev).to(dt)
            whole = rmsnorm_cfg(scale, x, cfg)
            rows = torch.stack([rmsnorm_cfg(scale, x[:, j].contiguous(), cfg)
                                for j in range(sq)], dim=1)
            norms[name] = bool(torch.equal(whole.view(torch.int16 if dt == torch.bfloat16
                                                      else torch.int32),
                                           rows.view(torch.int16 if dt == torch.bfloat16
                                                     else torch.int32)))
        print(f"  GEMM row bits at b = {b}, {sq} rows a slot ({dt}; True: the batched rows "
              f"equal the {b}-row product, one product a projection; False: row by row): "
              f"{out}; RMSNorm kernel rows of {b * sq} equal to rows of {b}: {norms}")
        if not all(norms.values()):
            raise AssertionError(f"the RMSNorm kernel's rows depend on the row count: {norms}")
        return out

    def spec_phase(self, cfg, model, key, *, k, draft=None):
        """``Engine(spec=SpecConfig(k=k))`` on phase 13's engine shape and
        trace (``key`` names the non-speculative run):

        * the GEMM row-bits check of the verify's projections
          (:meth:`gemm_rows`);
        * a replayed spec chunk bit-identical to the eager one from one pool
          state (history included), ms a replayed spec step (CUDA events)
          and kernels a step (a profiled replay);
        * the trace served with the launch counts set to 0 just before and
          read just after: decode attention n_layers * (k+1) a spec step,
          RMSNorm once a forward (every admission and spec step); every
          request token-identical to phase 13's non-speculative engine;
          mean tokens committed a slot's step, the acceptance rate, ms a
          committed token against phase 13's ms a step, makespan and tok/s;
        * with ``draft = (model, cfg)``: model drafting at k-1 on the
          trace's first 8 requests, token-identical to phase 13's, the draft
          model's launches counted too."""
        import numpy as np

        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import Engine, SpecConfig

        base = self.engine_runs.get(key)
        if base is None:
            raise AssertionError(f"phase 13 left no run under {key}")
        reqs, sh = base["reqs"], base["shape"]
        slots, chunk = sh["slots"], sh["chunk"]
        per_forward = 4 * cfg.n_layers + 1
        windows = cfg.blocks.count("window")
        routes = self.gemm_rows(cfg, model, slots, k + 1)
        self.spec_routes[cfg.name] = routes
        eng = Engine(model, cfg, num_slots=slots, cache_len=sh["cache_len"], chunk=chunk,
                     spec=SpecConfig(k=k))
        t0 = time.perf_counter()
        eng.warmup(prompt_lens=sh["prompts"])
        self.sync()
        print(f"  {cfg.name}, k = {k}, n-gram drafting: warmup (one admission a prompt length, "
              f"a spec chunk eagerly and its capture) {time.perf_counter() - t0:.2f} s; graph "
              f"captured: {bool(eng._graphs)}")
        if not self.rehearsal and not eng._graphs:
            raise AssertionError("the spec chunk was not captured")
        restore = self.replay_equals_eager(eng, reqs[:slots])
        restore()
        replay_ms = self.time_ms(eng._decode_chunk, iters=4)
        restore()
        wall_us, rows = self.profiled(eng._decode_chunk, 1, every_launch=True)
        kernels = sum(r[1] for r in rows) / chunk
        busy = sum(r[0] for r in rows) / chunk / 1e3

        eng.reset()
        self.sync()
        dispatch.reset_launch_counts()
        done = eng.run(reqs)
        counts, details = dispatch.launch_counts(), dispatch.launch_details()
        st = eng.stats
        steps = st["decode_chunks"] * chunk
        want = {"rmsnorm": per_forward * (len(reqs) + steps),
                "decode_attention": cfg.n_layers * (k + 1) * steps}
        want_details = {"decode_attention wrap": windows * (k + 1) * steps} if windows else {}
        if cfg.n_layers > windows:
            want_details["decode_attention no wrap"] = (cfg.n_layers - windows) * (k + 1) * steps
        name = key.replace("engine_", "engine_spec_")
        self.rows["rmsnorm"][name] = counts["rmsnorm"]
        self.rows["decode_attention"][name] = counts["decode_attention"]
        same = sum(np.array_equal(done[r.uid].tokens, base["done"][r.uid].tokens) for r in reqs)
        committed = 1 + st["accepted_per_step"]  # tokens a slot's spec step commits, mean
        step_ms = replay_ms / chunk if replay_ms is not None else float("nan")
        print(f"  ms a replayed spec step {step_ms:.3f} (CUDA events around 4 replays; "
              f"phase 13's plain step {base['step_ms']:.3f}), {kernels:.0f} kernels a step, "
              f"device busy {busy:.3f} ms a step (a profiled replay); {self.card}")
        for dev_us, count, kname in rows[:8]:
            print(f"    {dev_us / chunk / 1e3:9.4f} ms/step  {count / chunk:7.1f} calls/step  "
                  f"{kname[:90]}")
        print(f"  Engine.run: {len(reqs)} requests, {same} token-identical to phase 13's "
              f"engine; {st['spec_steps']} slot spec steps, {st['spec_accepted']} drafts "
              f"accepted: {committed:.3f} tokens committed a slot's step, acceptance rate "
              f"{st['acceptance_rate']:.3f}; ms a committed token {step_ms / committed:.3f} "
              f"against {base['step_ms']:.3f} a plain step; makespan {st['makespan_s']:.3f} s, "
              f"{st['tok_s']:.1f} tok/s (phase 13: {base['stats']['makespan_s']:.3f} s, "
              f"{base['stats']['tok_s']:.1f} tok/s); {st['decode_chunks']} chunks; launches "
              f"rmsnorm {counts['rmsnorm']}, decode_attention {counts['decode_attention']} "
              f"(want {want}), {details}")
        if same != len(reqs) or st["n_ok"] != len(reqs):
            raise AssertionError(f"speculative tokens differ from phase 13's: {same} of "
                                 f"{len(reqs)} identical")
        if not self.rehearsal and (any(counts[n] != v for n, v in want.items())
                                   or details != want_details):
            raise AssertionError(f"launch counts {counts} {details}, want {want} {want_details}")
        self.spec_runs[cfg.name] = dict(step_ms=step_ms, plain_ms=base["step_ms"],
                                        committed=committed, kernels=kernels)
        del eng
        if draft is None:
            return

        dmodel, dcfg = draft
        kd, sub = k - 1, reqs[:8]
        eng = Engine(model, cfg, num_slots=slots, cache_len=sh["cache_len"], chunk=chunk,
                     spec=SpecConfig(k=kd, draft="model"), draft_model=draft)
        eng.warmup(prompt_lens=sorted({len(r.prompt) for r in sub}))
        self.sync()
        restore = self.replay_equals_eager(eng, sub[:slots])
        restore()
        replay_ms = self.time_ms(eng._decode_chunk, iters=4)
        eng.reset()
        self.sync()
        dispatch.reset_launch_counts()
        done = eng.run(sub)
        counts = dispatch.launch_counts()
        st = eng.stats
        steps = st["decode_chunks"] * chunk
        d_forward = 4 * dcfg.n_layers + 1
        want = {"rmsnorm": per_forward * (len(sub) + steps)
                + d_forward * (len(sub) + steps * (kd + 1)),
                "decode_attention": steps * (cfg.n_layers * (kd + 1)
                                             + dcfg.n_layers * (2 * kd + 1))}
        self.rows["rmsnorm"][name + "_draft_model"] = counts["rmsnorm"]
        self.rows["decode_attention"][name + "_draft_model"] = counts["decode_attention"]
        same = sum(np.array_equal(done[r.uid].tokens, base["done"][r.uid].tokens) for r in sub)
        committed = 1 + st["accepted_per_step"]
        step_ms = replay_ms / chunk if replay_ms is not None else float("nan")
        print(f"  draft model ({dcfg.n_layers} layers, seed 1), k = {kd}, {len(sub)} requests: "
              f"{same} token-identical to phase 13's engine; ms a replayed spec step "
              f"{step_ms:.3f}, {committed:.3f} tokens committed a slot's step, acceptance rate "
              f"{st['acceptance_rate']:.3f}, ms a committed token {step_ms / committed:.3f}; "
              f"makespan {st['makespan_s']:.3f} s, {st['tok_s']:.1f} tok/s; launches rmsnorm "
              f"{counts['rmsnorm']}, decode_attention {counts['decode_attention']} (want {want})")
        if same != len(sub) or st["n_ok"] != len(sub):
            raise AssertionError(f"draft-model tokens differ from phase 13's: {same} of "
                                 f"{len(sub)} identical")
        if not self.rehearsal and any(counts[n] != v for n, v in want.items()):
            raise AssertionError(f"launch counts {counts}, want {want}")

    # -- phase 16: the LayerNorm, MoE and vision families ------------------
    def p16a_starcoder2(self):
        """starcoder2-15b at full width cut to SERVE_DEPTH's 10 layers
        (LayerNorm, GELU MLP, 12 query heads a KV head) on the kernels, held to phase 4a's contract
        against the plain versions; then an ``Engine`` at phase 13a's
        shape and draw."""
        self.family_phase(self.serve_config("starcoder2-15b"), engine=True)

    def p16b_mixtral(self):
        """mixtral-8x22b at full width cut to 4 layers (8 experts of which 2,
        a uniform window stack: rings of min(576, 4096) lines): phase 4a's
        contract, the prefill's drops and expert load."""
        from repro_torch.configs import get_config, get_smoke_config

        kw = dict(sqrt_unit="e2afs", decode_kernel="fused")
        cfg = (get_smoke_config("mixtral-8x22b", **kw) if self.rehearsal else
               get_config("mixtral-8x22b", n_layers=4, **kw))
        self.family_phase(cfg, engine=False)

    def p16c_qwen3_moe(self):
        """qwen3-moe-235b-a22b at full width cut to 4 layers (128 experts of
        which 8, qk-norm): phase 4a's contract, the drops and load; then an
        ``Engine`` at phase 13a's shape (the routing inside the captured
        chunk)."""
        from repro_torch.configs import get_config, get_smoke_config

        kw = dict(sqrt_unit="e2afs", decode_kernel="fused")
        cfg = (get_smoke_config("qwen3-moe-235b-a22b", **kw) if self.rehearsal else
               get_config("qwen3-moe-235b-a22b", n_layers=4, **kw))
        self.family_phase(cfg, engine=True)

    def norm_launches(self, cfg):
        """(kernel, launches a forward of one token position or prompt) of
        the model's norms: RMSNorm kernels (two a layer, qk-norm two more,
        the final norm), or for LayerNorm one e2afs_rsqrt a norm."""
        if cfg.norm == "layernorm":
            return "e2afs_rsqrt", 2 * cfg.n_layers + 1
        return "rmsnorm", 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)

    def free(self):
        """Collect what a sub-phase dropped and return the card's cached
        blocks (one model of phase 16 on the card at a time)."""
        import gc

        gc.collect()
        if not self.rehearsal:
            self.torch.cuda.empty_cache()

    def family_phase(self, cfg, *, engine):
        """Phase 4a's serving contract for one family at full width: batch 8,
        prompt 512, 64 greedy tokens, cache 576 on the kernels; the launch
        counts set to 0 just before and read just after and held to what
        the code implies; first-step logits within 4 ulps at max |logit| of
        the same weights on the plain versions and the first two tokens
        equal in every slot; prefill ms and ms a step beside the
        weight-read floor; with experts, the prefill's dropped choices and
        expert load; with ``engine``, phase 13a's engine.  Peak memory."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.layers import moe
        from repro_torch.models import lm

        batch, prompt_len, gen_len = (2, 16, 4) if self.rehearsal else (8, 512, 64)
        cache_len = prompt_len + gen_len
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        experts = (f", {cfg.moe.n_experts} experts of which {cfg.moe.top_k} (d_ff "
                   f"{cfg.moe.d_ff_expert}, capacity factor {cfg.moe.capacity_factor})"
                   if cfg.moe else f", d_ff {cfg.d_ff} ({cfg.mlp_act})")
        print(f"  {cfg.name}: {cfg.n_layers} layers ({', '.join(sorted(set(cfg.blocks)))}"
              f"{f' of {cfg.window}' if cfg.window else ''}), d {cfg.d_model}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads} (G = {cfg.n_heads // cfg.n_kv_heads}), {cfg.norm}"
              f"{', qk-norm' if cfg.qk_norm else ''}{experts}, vocab {cfg.vocab}, "
              f"{cfg.act_dtype}; batch {batch}, prompt {prompt_len}, {gen_len} new tokens, cache "
              f"{cache_len}")
        t0 = time.perf_counter()
        model = lm.init(cfg, self.gen(0), device=self.dev)
        self.sync()
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"  init: {lm.param_count(model) / 1e9:.4f} B parameters ({weight_bytes / 1e9:.2f} "
              f"GB) in {time.perf_counter() - t0:.1f} s")
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=self.gen(1),
                               device=self.dev)

        def run(c, n):
            cache = lm.init_cache(c, batch, cache_len, device=self.dev)
            self.sync()
            t_a = time.perf_counter()
            logits, cache = lm.prefill(model, c, cache, prompt, last_logit_only=True)
            self.sync()
            t_b = time.perf_counter()
            toks, _, cache = lm.generate_scan(model, c, cache, logits[:, -1:].argmax(-1),
                                              prompt_len, n)
            self.sync()
            return logits, toks, cache, t_b - t_a, time.perf_counter() - t_b

        run(cfg, 2)  # warm-up
        norm_kernel, per_forward = self.norm_launches(cfg)
        dispatch.reset_launch_counts()
        logits, toks, cache, pf_s, dec_s = run(cfg, gen_len)  # the main path
        counts, details = dispatch.launch_counts(), dispatch.launch_details()
        want = dict.fromkeys(dispatch.KNOWN, 0)
        want.update({norm_kernel: per_forward * (1 + gen_len),
                     "decode_attention": cfg.n_layers * gen_len})
        key = cfg.name.replace("-", "_").replace(".", "_") + "_launches"
        for name in (norm_kernel, "decode_attention"):
            self.rows[name][key] = counts[name]
        print(f"  main path launches: {counts} {details} (want {want})")
        lines = (cache if isinstance(cache, list) else [cache])[0]["k"].shape[-3]
        floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
        print(f"  prefill {pf_s * 1e3:.1f} ms; decode {dec_s / gen_len * 1e3:.3f} ms/step, "
              f"{batch * gen_len / dec_s:.1f} tok/s; weight-read floor {floor_ms:.3f} ms/step "
              f"({weight_bytes / 1e9:.2f} GB over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); cache "
              f"lines a layer {lines} (host clock with synchronize; {self.card})")
        self.family[cfg.name] = {"prefill_ms": pf_s * 1e3, "ms_per_step": dec_s / gen_len * 1e3,
                                 "tok_s": batch * gen_len / dec_s, "floor_ms": floor_ms}
        self.mesh_family(cfg, model, prompt, toks, cache_len, dec_s / gen_len * 1e3, counts)

        def plain(record=None, replay=None):
            """The plain versions' run; with experts, each call's choices
            appended to ``record``, or taken in order from ``replay``."""
            prev, plain_route = dispatch.set_backend("reference"), moe.route

            def routed(router, x, k, cap, choices=None):
                out = plain_route(router, x, k, cap, replay.pop(0) if replay else None)
                if record is not None:
                    record.append(out[2])
                return out

            moe.route = routed
            dispatch.reset_launch_counts()
            try:
                out = run(cfg.replace(decode_kernel="reference"), gen_len)
            finally:
                dispatch.set_backend(prev)
                moe.route = plain_route
            if not self.rehearsal and any(dispatch.launch_counts().values()):
                raise AssertionError(f"the plain-version run launched a kernel: "
                                     f"{dispatch.launch_counts()}")
            return out

        flips = ""
        if cfg.moe is None:
            ref_logits, ref_toks, _, rpf_s, rdec_s = plain()
        else:
            # A routing choice between near-equal probabilities flips when a
            # bf16 hidden state rounds one ulp apart (the fused RMSNorm sums
            # in another order), and moves that token's output by whole
            # units: the kernels are held against the plain versions on the
            # kernel route's routing, and the free run's flips are printed.
            kernel_choices, plain_choices = [], []
            plain_route = moe.route

            def recording(router, x, k, cap, choices=None):
                out = plain_route(router, x, k, cap, choices)
                kernel_choices.append(out[2])
                return out

            moe.route = recording
            try:
                again, again_toks, _, _, _ = run(cfg, gen_len)
            finally:
                moe.route = plain_route
            if not (torch.equal(again, logits) and torch.equal(again_toks, toks)):
                raise AssertionError("two runs of the kernel route differ")
            free_logits, free_toks, _, _, _ = plain(record=plain_choices)
            pre = cfg.n_layers  # the prefill's calls come first, one a layer
            differ = sum(int((a != b).sum()) for a, b in zip(kernel_choices[:pre],
                                                              plain_choices[:pre]))
            total = sum(a.numel() for a in kernel_choices[:pre])
            flips = (f"; the plain versions' own routing: {differ} of {total} prefill choices "
                     f"differ, first-step logits max |diff| "
                     f"{float((free_logits.float() - logits.float()).abs().max()):.4g}, greedy "
                     f"token agreement {float((free_toks == toks).float().mean()):.3f}")
            self.family[cfg.name]["prefill_flips"] = (differ, total)
            pinned = list(kernel_choices)
            ref_logits, ref_toks, _, rpf_s, rdec_s = plain(replay=pinned)
            if pinned or len(kernel_choices) != cfg.n_layers * (1 + gen_len):
                raise AssertionError(f"{len(kernel_choices)} routing calls recorded, "
                                     f"{len(pinned)} not replayed")
        print(f"  plain versions: prefill {rpf_s * 1e3:.1f} ms; decode "
              f"{rdec_s / gen_len * 1e3:.3f} ms/step{flips}")
        if not self.rehearsal and (counts != want):
            raise AssertionError(f"launch counts {counts}, want {want}")
        if lines != min(cache_len, cfg.window or cache_len):
            raise AssertionError(f"{lines} cache lines a layer")
        if tuple(logits.shape) != (batch, 1, cfg.vocab) or tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"shapes: logits {tuple(logits.shape)}, tokens "
                                 f"{tuple(toks.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite first-step logits")
        diff = float((logits.float() - ref_logits.float()).abs().max())
        top = ref_logits.float().abs().max()
        limit = 4 * float(ulp_of(top.reshape(1).to(ref_logits.dtype)))
        first = [int((toks[:, i] == ref_toks[:, i]).sum()) for i in range(min(2, gen_len))]
        print(f"  kernels vs plain versions{' on one routing' if cfg.moe else ''}: first-step "
              f"logits max |diff| {diff:.4g} (limit "
              f"{limit:.4g}: 4 {ref_logits.dtype} ulps at max |logit| {float(top):.4g}); first "
              f"two generated tokens agree {first} of {batch}; greedy token agreement "
              f"{float((toks == ref_toks).float().mean()):.3f} over {toks.numel()} tokens")
        if diff > limit:
            raise AssertionError(f"{cfg.name} logits disagree with the plain versions")
        if first != [batch] * len(first):
            raise AssertionError(f"first generated tokens disagree: {first} of {batch}")

        if cfg.moe is not None:  # the prefill's routing, layer by layer, outside the counts
            stats, plain_apply = [], lm.moe_apply

            def counting(p, c, x, *, capacity_factor):
                cap = moe.capacity(c, x.shape[1], capacity_factor)
                _, _, idx, _, keep = moe.route(p.router, x, c.moe.top_k, cap)
                load = torch.zeros(c.moe.n_experts, dtype=torch.int64, device=x.device)
                load.index_add_(0, idx[keep].flatten(), torch.ones_like(idx[keep].flatten()))
                stats.append((int((~keep).sum()), keep.numel(), cap, load.cpu()))
                return plain_apply(p, c, x, capacity_factor=capacity_factor)

            lm.moe_apply = counting
            try:
                lm.prefill(model, cfg, lm.init_cache(cfg, batch, cache_len, device=self.dev),
                           prompt, last_logit_only=True)
            finally:
                lm.moe_apply = plain_apply
            dropped = sum(s[0] for s in stats)
            total = sum(s[1] for s in stats)
            print(f"  prefill routing ({batch} rows of {prompt_len} tokens, capacity "
                  f"{stats[0][2]} a row and expert): {dropped} of {total} choices dropped "
                  f"({dropped / total:.4f})")
            for i, (d, n, _, load) in enumerate(stats):
                lf = load.float()
                print(f"    layer {i}: dropped {d} of {n}; kept choices an expert: min "
                      f"{int(load.min())}, max {int(load.max())}, mean {float(lf.mean()):.1f}, "
                      f"cv {float(lf.std() / lf.mean()):.3f}, idle experts "
                      f"{int((load == 0).sum())} of {cfg.moe.n_experts}")
            self.family[cfg.name]["dropped"] = (dropped, total)
        if engine:
            self.family_engine(cfg, model, key)
        peak = torch.cuda.max_memory_allocated() / 2**30 if not self.rehearsal else float("nan")
        print(f"  peak memory of the sub-phase {peak:.2f} GiB ({self.card})")
        del model, cache, logits, ref_logits
        self.free()

    def family_engine(self, cfg, model, key):
        """Phase 13a's engine on a family's model: 8 slots of 576 lines,
        chunks of 8, 13a's draw of 24 requests; a replay bit-identical to
        the eager chunk from one pool state; the trace served with the
        counts set to 0 just before and read just after (norm and
        decode-attention launches what the admissions and chunks imply);
        8 requests token-identical each alone in a pool of the engine's
        shape; makespan and tok/s."""
        import numpy as np

        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import Engine

        if self.rehearsal:
            slots, cache_len, n, prompts, budgets = 4, 40, 8, (3, 5, 12), (2, 4, 7)
        else:
            slots, cache_len, n, prompts, budgets = 8, 576, 24, (128, 256, 512), (16, 32, 64)
        chunk = 8
        reqs = trace(cfg, n, prompts, budgets)
        eng = Engine(model, cfg, num_slots=slots, cache_len=cache_len, chunk=chunk)
        t0 = time.perf_counter()
        eng.warmup(prompt_lens=prompts)
        self.sync()
        print(f"  engine: {slots} slots of {cache_len} lines, chunks of {chunk}; warmup "
              f"{time.perf_counter() - t0:.2f} s; graph captured: {bool(eng._graphs)}")
        if not self.rehearsal and not eng._graphs:
            raise AssertionError("the decode chunk was not captured")
        restore = self.replay_equals_eager(eng, reqs[:slots])
        restore()
        replay_ms = self.time_ms(eng._decode_chunk, iters=4)
        restore()
        wall_us, rows = self.profiled(eng._decode_chunk, 1, every_launch=True)
        busy = sum(r[0] for r in rows)
        print(f"  ms a decode step replayed: "
              f"{replay_ms / chunk if replay_ms else float('nan'):.3f} (CUDA events around 4 "
              f"replays); a profiled replay: {sum(r[1] for r in rows) / chunk:.0f} kernels and "
              f"{busy / chunk / 1e3:.3f} device ms a step ({self.card}); by kernel:")
        for dev_us, count, name in rows[:10]:
            print(f"    {dev_us / chunk / 1e3:9.4f} ms/step  {count / chunk:7.1f} calls/step  "
                  f"{name[:90]}")
        eng.reset()
        self.sync()
        norm_kernel, per_forward = self.norm_launches(cfg)
        dispatch.reset_launch_counts()
        done = eng.run(reqs)
        counts = dispatch.launch_counts()
        st = eng.stats
        steps = st["decode_chunks"] * chunk
        want = {norm_kernel: per_forward * (n + steps), "decode_attention": cfg.n_layers * steps}
        got = {k: counts[k] for k in want}
        self.rows["decode_attention"]["engine_" + key] = counts["decode_attention"]
        self.rows[norm_kernel]["engine_" + key] = counts[norm_kernel]
        print(f"  Engine.run: {n} requests, makespan {st['makespan_s']:.3f} s, "
              f"{st['total_tokens']} tokens, {st['tok_s']:.1f} tok/s, {st['decode_chunks']} "
              f"chunks; launches {got} (want {want}: {n} admissions + {steps} steps)")
        self.family[cfg.name].update(engine_tok_s=st["tok_s"], makespan_s=st["makespan_s"],
                                     replay_ms_per_step=replay_ms / chunk if replay_ms else None)
        if not self.rehearsal and got != want:
            raise AssertionError(f"engine launch counts {got}, want {want}")
        if st["n_ok"] != n:
            raise AssertionError(f"not every request completed: {st}")
        longest = max(len(r.prompt) for r in reqs)
        order = sorted(reqs, key=lambda r: (len(r.prompt) < longest, r.uid < slots, r.uid))
        picked = order[:4] + [r for r in order[4:] if r.uid >= slots][:4]
        chosen = {r.uid for r in picked}
        picked += [r for r in order[4:] if r.uid not in chosen][:8 - len(picked)]
        same = 0
        for r in picked:
            eng.reset()
            same += int(np.array_equal(eng.run([r])[r.uid].tokens, done[r.uid].tokens))
        print(f"  alone in the pool: {same} of {len(picked)} requests token-identical (uids "
              f"{[r.uid for r in picked]})")
        if same != len(picked) or len(picked) < min(8, n):
            raise AssertionError("staggered requests differ from the same requests alone")

    def p16d_internvl(self):
        """internvl2-76b at full width cut to 2 layers: the training forward
        over 1024 vision tokens and 512 text tokens, batch 2, e2afs, its
        unfused norms on the e2afs_rsqrt kernel (5 launches) against the
        plain route: logits within phase 4a's 4 ulps at max |logit|."""
        torch = self.torch
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.kernels import dispatch
        from repro_torch.models import lm

        if self.rehearsal:
            cfg = get_smoke_config("internvl2-76b", sqrt_unit="e2afs")
            batch, text = 2, 12
        else:
            cfg = get_config("internvl2-76b", n_layers=2, sqrt_unit="e2afs")
            batch, text = 2, 512
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        model = lm.init(cfg, self.gen(0), device=self.dev)
        inputs = {"tokens": torch.randint(0, cfg.vocab, (batch, text), generator=self.gen(1),
                                          device=self.dev),
                  "vision": torch.randn(batch, cfg.vision_tokens, cfg.d_model,
                                        generator=self.gen(2), device=self.dev).to(torch.bfloat16)}
        print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, vocab {cfg.vocab}; {lm.param_count(model) / 1e9:.3f} B "
              f"parameters; batch {batch}, {cfg.vision_tokens} vision + {text} text tokens")
        with torch.no_grad():
            lm.forward(model, cfg, inputs)  # warm-up
            self.sync()
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            logits, _ = lm.forward(model, cfg, inputs)  # the main path
            self.sync()
            ms = (time.perf_counter() - t0) * 1e3
            counts = dispatch.launch_counts()
            prev = dispatch.set_backend("reference")
            try:
                ref, _ = lm.forward(model, cfg, inputs)
            finally:
                dispatch.set_backend(prev)
        want = dict.fromkeys(dispatch.KNOWN, 0)
        want["e2afs_rsqrt"] = 2 * cfg.n_layers + 1
        self.rows["e2afs_rsqrt"]["internvl2_76b_forward_launches"] = counts["e2afs_rsqrt"]
        diff = float((logits.float() - ref.float()).abs().max())
        top = ref.float().abs().max()
        limit = 4 * float(ulp_of(top.reshape(1).to(ref.dtype)))
        peak = torch.cuda.max_memory_allocated() / 2**30 if not self.rehearsal else float("nan")
        print(f"  forward {ms:.1f} ms (host clock with synchronize); launches {counts} (want "
              f"{want}); logits {tuple(logits.shape)} over the text positions; kernel route vs "
              f"plain route max |diff| {diff:.4g} (limit {limit:.4g}: 4 {ref.dtype} ulps at max "
              f"|logit| {float(top):.4g}; bit-identical: {bool(torch.equal(logits, ref))}); "
              f"peak memory {peak:.2f} GiB ({self.card})")
        if tuple(logits.shape) != (batch, text, cfg.padded_vocab):
            raise AssertionError(f"logits {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
        if not self.rehearsal and counts != want:
            raise AssertionError(f"launch counts {counts}, want {want}")
        if diff > limit:
            raise AssertionError("internvl2-76b's kernel route disagrees with the plain route")
        del model, logits, ref, inputs
        self.free()

    # -- phase 17: the recurrent families -------------------------------------
    def p17a_mamba2(self):
        """mamba2-2.7b at full width cut to SERVE_DEPTH's 16 SSD layers (80
        heads) on the kernels; see :meth:`recurrent_phase`."""
        self.recurrent_phase(self.serve_config("mamba2-2.7b"))

    def p17b_recurrentgemma(self):
        """recurrentgemma-2b at full width cut to SERVE_DEPTH's 9 layers (6
        RG-LRU and 3 window layers of 2048, G = 10 at head_dim 256); see
        :meth:`recurrent_phase`."""
        self.recurrent_phase(self.serve_config("recurrentgemma-2b"))

    def serve_config(self, arch):
        """``arch`` at full width and SERVE_DEPTH's depth, e2afs, the fused
        decode kernel (smoke width in a rehearsal)."""
        from repro_torch.configs import get_config, get_smoke_config

        kw = dict(sqrt_unit="e2afs", decode_kernel="fused")
        if self.rehearsal:
            return get_smoke_config(arch, **kw)
        return get_config(arch, n_layers=SERVE_DEPTH[arch], **kw)

    def move_constant_starts(self, model, seed):
        """Move every leaf that starts at a constant (norm scales, the
        mixers' conv_w, lam, a_log, dt_bias, d_skip) off it by 0.3 x a
        seeded normal: a fresh RG-LRU block computes nothing (its conv_w
        starts at zero), and a comparison on it would hold whatever ran."""
        torch = self.torch
        from repro_torch.models import lm

        g = self.gen(seed)
        leaves = lm.constant_start_parameters(model)
        with torch.no_grad():
            for _, p in leaves:
                p.add_((0.3 * torch.randn(p.shape, generator=g, device=self.dev)).to(p.dtype))
        return len(leaves)

    def recurrent_phase(self, cfg):
        """A recurrent family at full width and SERVE_DEPTH's depth, bf16, e2afs, weights
        from seed 0 with the constant starts moved (seed 1): batch 8, prompt
        2048, 64 greedy tokens, cache 2112, the launch counts set to 0 just
        before and read just after (RMSNorm a norm a forward, ``e2afs_sqrt``
        one an RG-LRU layer a forward, decode attention one a window layer a
        step, all "wrap"), the first-step logits and tokens against the same
        weights on the plain versions in bf16 (a limit set by the plain
        versions' own spread) and in float32 activations (a fixed limit of 4
        bf16 ulps, the first two tokens 8 of 8), prefill ms and ms a step
        beside the floor of the
        bytes a step must move; then phase 13b's engine shape (8 slots of
        2112 lines, 12 requests, prompts {512, 1000, 2048}, budgets {16,
        64}): a replay bit-identical to the eager chunk, its profile, the
        trace's launches, 8 requests token-identical each alone, makespan
        and tok/s, and canaries at stride 8 with budgets that never trip
        serving the same tokens.  Peak memory."""
        import numpy as np

        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import AccuracySLO, Engine
        from repro_torch.models import lm

        batch, prompt_len, gen_len = (2, 20, 4) if self.rehearsal else (8, 2048, 64)
        cache_len = prompt_len + gen_len
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        blocks = cfg.blocks
        n_rglru, n_window = blocks.count("rglru"), blocks.count("window")
        norms = sum(1 if b == "ssd" else 2 for b in blocks) + 1
        mix = {b: blocks.count(b) for b in sorted(set(blocks))}
        heads = (f" (window {cfg.window}, G = {cfg.n_heads // cfg.n_kv_heads}, hd {cfg.d_head})"
                 if n_window else "")
        print(f"  {cfg.name}: {cfg.n_layers} layers {mix}{heads}, d {cfg.d_model}, vocab "
              f"{cfg.vocab}, {cfg.act_dtype}; batch {batch}, prompt "
              f"{prompt_len}, {gen_len} new tokens, cache {cache_len}")
        t0 = time.perf_counter()
        model = lm.init(cfg, self.gen(0), device=self.dev)
        moved = self.move_constant_starts(model, 1)
        self.sync()
        params = dict(model.named_parameters())
        weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
        # a decode step reads every weight once, but of an untied embedding
        # table only its 8 rows
        step_weights = weight_bytes - (0 if cfg.tie_embeddings else
                                       params["embed"].numel() * params["embed"].element_size())
        print(f"  init: {lm.param_count(model) / 1e9:.4f} B parameters ({weight_bytes / 1e9:.2f} "
              f"GB) in {time.perf_counter() - t0:.1f} s; {moved} constant-start leaves moved off "
              f"their starts (seed 1): the weights are random, the comparisons hold a live "
              f"recurrence")
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=self.gen(2),
                               device=self.dev)

        def run(c, n, m=model):
            cache = lm.init_cache(c, batch, cache_len, device=self.dev)
            self.sync()
            t_a = time.perf_counter()
            logits, cache = lm.prefill(m, c, cache, prompt, last_logit_only=True)
            self.sync()
            t_b = time.perf_counter()
            toks, _, cache = lm.generate_scan(m, c, cache, logits[:, -1:].argmax(-1),
                                              prompt_len, n)
            self.sync()
            return logits, toks, cache, t_b - t_a, time.perf_counter() - t_b

        run(cfg, 2)  # warm-up
        dispatch.reset_launch_counts()
        logits, toks, cache, pf_s, dec_s = run(cfg, gen_len)  # the main path
        counts, details = dispatch.launch_counts(), dispatch.launch_details()
        want = dict.fromkeys(dispatch.KNOWN, 0)
        want.update({"rmsnorm": norms * (1 + gen_len), "e2afs_sqrt": n_rglru * (1 + gen_len),
                     "decode_attention": n_window * gen_len})
        want_details = {"decode_attention wrap": n_window * gen_len} if n_window else {}
        key = cfg.name.replace("-", "_").replace(".", "_") + "_launches"
        for name in ("rmsnorm", "e2afs_sqrt", "decode_attention"):
            self.rows[name][key] = counts[name]
        print(f"  main path launches: {counts} {details} (want {want} {want_details})")
        leaves = cache if isinstance(cache, list) else [cache]
        state_bytes = sum(t.numel() * t.element_size() for c in leaves for k, t in c.items()
                          if k not in ("k", "v"))
        ring_bytes = sum(t.numel() * t.element_size() for c in leaves for k, t in c.items()
                         if k in ("k", "v"))
        # a step reads the weights, reads and writes every state, reads the rings
        floor_ms = (step_weights + 2 * state_bytes + ring_bytes) / HBM_BYTES_PER_S * 1e3
        step_ms = dec_s / gen_len * 1e3
        print(f"  prefill {pf_s * 1e3:.1f} ms; decode {step_ms:.3f} ms/step (eager), "
              f"{batch * gen_len / dec_s:.1f} tok/s; floor {floor_ms:.3f} ms/step "
              f"({step_weights / 1e9:.3f} GB of weights, 2 x {state_bytes / 1e9:.3f} GB of "
              f"state, {ring_bytes / 1e9:.3f} GB of rings over {HBM_BYTES_PER_S / 1e12:.2f} "
              f"TB/s) (host clock with synchronize; {self.card})")
        self.family[cfg.name] = {"prefill_ms": pf_s * 1e3, "ms_per_step": step_ms,
                                 "tok_s": batch * gen_len / dec_s, "floor_ms": floor_ms}
        self.mesh_family(cfg, model, prompt, toks, cache_len, step_ms, counts)

        from repro_torch.core import get_unit
        from repro_torch.kernels.rmsnorm import ops as rms_ops

        def summed_in_float64(x, scale, *, sqrt_unit="e2afs", eps=1e-6):
            """The plain RMSNorm with its mean square summed in float64 (then
            float32): the same function, summed in another order."""
            ms = ((x.double() ** 2).sum(dim=-1, keepdim=True) / x.shape[-1]).float()
            inv = get_unit(sqrt_unit).rsqrt(ms + eps)
            return (x.float() * inv).to(x.dtype) * (1.0 + scale.to(x.dtype))

        def plain(c=cfg, n=gen_len, m=model, other_order=False):
            prev, ref_rmsnorm = dispatch.set_backend("reference"), rms_ops.ref_rmsnorm
            if other_order:
                rms_ops.ref_rmsnorm = summed_in_float64
            dispatch.reset_launch_counts()
            try:
                out = run(c.replace(decode_kernel="reference"), n, m)
            finally:
                dispatch.set_backend(prev)
                rms_ops.ref_rmsnorm = ref_rmsnorm
            if not self.rehearsal and any(dispatch.launch_counts().values()):
                raise AssertionError(f"the plain-version run launched a kernel: "
                                     f"{dispatch.launch_counts()}")
            return out

        ref_logits, ref_toks, _, rpf_s, rdec_s = plain()
        print(f"  plain versions: prefill {rpf_s * 1e3:.1f} ms; decode "
              f"{rdec_s / gen_len * 1e3:.3f} ms/step")
        # how far the plain versions move under another order of the norms'
        # sums: a deep bf16 recurrence carries a one-ulp norm difference on
        alt_logits, alt_toks = plain(other_order=True)[:2]
        spread = float((alt_logits.float() - ref_logits.float()).abs().max())
        steady = (alt_toks[:, :2] == ref_toks[:, :2]).all(dim=1)
        print(f"  plain versions against themselves with the norms' mean square summed in "
              f"float64: first-step logits max |diff| {spread:.4g}; first two tokens agree in "
              f"{int(steady.sum())} of {batch} slots; greedy token agreement "
              f"{float((alt_toks == ref_toks).float().mean()):.3f}")
        if not self.rehearsal and (counts != want or details != want_details):
            raise AssertionError(f"launch counts {counts} {details}, want {want} {want_details}")
        if tuple(logits.shape) != (batch, 1, cfg.vocab) or tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"shapes: logits {tuple(logits.shape)}, tokens "
                                 f"{tuple(toks.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite first-step logits")
        diff = float((logits.float() - ref_logits.float()).abs().max())
        top = ref_logits.float().abs().max()
        ulps4 = 4 * float(ulp_of(top.reshape(1).to(ref_logits.dtype)))
        limit = max(ulps4, 2 * spread)
        first = [int((toks[:, i] == ref_toks[:, i]).sum()) for i in range(min(2, gen_len))]
        # the first token is the argmax of the first-step logits: it must
        # agree wherever the plain top-2 margin exceeds twice the logits' diff
        top2 = ref_logits[:, -1].float().topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
        held = bool((toks[:, 0] == ref_toks[:, 0])[decided].all())
        print(f"  bf16 kernels vs plain versions: first-step logits max |diff| {diff:.4g} (limit "
              f"{limit:.4g}: the larger of 4 {ref_logits.dtype} ulps at max |logit| "
              f"{float(top):.4g}, {ulps4:.4g}, and twice the plain versions' own spread); first "
              f"two generated tokens agree {first} of {batch} (the plain versions with "
              f"themselves: {int(steady.sum())} of {batch}); the first token in every one of "
              f"the {int(decided.sum())} slots whose top-2 margin exceeds twice the diff: "
              f"{held}; greedy token agreement {float((toks == ref_toks).float().mean()):.3f} "
              f"over {toks.numel()} tokens")
        self.family[cfg.name].update(first_logit_diff=diff, ulps4=ulps4, plain_spread=spread,
                                     first_two=first, steady_slots=int(steady.sum()),
                                     decided_slots=int(decided.sum()))
        if diff > limit:
            raise AssertionError(f"{cfg.name} logits disagree with the plain versions")
        if not held:
            raise AssertionError(f"first generated tokens disagree: {first} of {batch}")
        del cache, ref_logits, alt_logits
        self.free()

        # a hold whose limit does not scale with the run: the same weights
        # with float32 activations, where the stack no longer amplifies a
        # bf16 rounding flip into the logits, on the same prompt; first-step
        # logits within 4 bf16 ulps of the largest |logit| and the first two
        # tokens 8 of 8.  The served side decodes attention on the kernel
        # (recurrentgemma-2b: a float32 line of head_dim 256, G = 10, two
        # vectors a lane), one "wrap" launch a window layer a step
        cfg32 = cfg.replace(act_dtype="float32")
        m32 = lm.init(cfg32, self.gen(0), device=self.dev)
        with torch.no_grad():
            for a, b in zip(m32.parameters(), model.parameters()):
                a.copy_(b)
        dispatch.reset_launch_counts()
        logits32, toks32 = run(cfg32, 2, m32)[:2]
        launched32 = {k: v for k, v in dispatch.launch_counts().items() if v}
        attn32 = {k: v for k, v in dispatch.launch_details().items()
                  if k.startswith("decode_attention")}
        want32 = {"decode_attention wrap": n_window * 2} if n_window else {}
        print(f"  float32 run's decode_attention launches {attn32} (want {want32}: "
              f"{n_window} window layers x 2 steps)")
        if not self.rehearsal and attn32 != want32:
            raise AssertionError(f"float32 decode_attention launches {attn32}, want {want32}")
        ref32, rtoks32 = plain(cfg32, 2, m32)[:2]
        diff32 = float((logits32 - ref32).abs().max())
        top32 = ref32.abs().max().reshape(1)
        ulps4_32 = 4 * float(ulp_of(top32.to(torch.bfloat16)))
        first32 = [int((toks32[:, i] == rtoks32[:, i]).sum()) for i in range(2)]
        print(f"  float32 activations, kernels {launched32} vs plain versions: first-step logits "
              f"max |diff| {diff32:.4g} ({diff32 / float(ulp_of(top32)):.1f} float32 ulps; limit "
              f"4 bfloat16 ulps at max |logit| {float(top32):.4g}, {ulps4_32:.4g}); first two "
              f"generated tokens agree {first32} of {batch}")
        self.family[cfg.name].update(f32_logit_diff=diff32, f32_ulps4=ulps4_32,
                                     f32_first_two=first32)
        if not bool(torch.isfinite(logits32).all()) or diff32 > ulps4_32:
            raise AssertionError(f"{cfg.name} float32 logits disagree with the plain versions")
        if first32 != [batch, batch]:
            raise AssertionError(f"float32 first two tokens disagree: {first32} of {batch}")
        del m32, logits32, ref32
        self.free()

        # phase 13b's engine shape
        if self.rehearsal:
            slots, e_len, n, prompts, budgets = 4, 40, 6, (3, 10, 20), (2, 6)
        else:
            slots, e_len, n, prompts, budgets = 8, 2112, 12, (512, 1000, 2048), (16, 64)
        chunk = 8
        reqs = trace(cfg, n, prompts, budgets)
        eng = Engine(model, cfg, num_slots=slots, cache_len=e_len, chunk=chunk)
        t0 = time.perf_counter()
        eng.warmup(prompt_lens=prompts)
        self.sync()
        print(f"  engine: {slots} slots of {e_len} lines, chunks of {chunk}; {n} requests, prompts "
              f"{sorted(set(len(r.prompt) for r in reqs))}, budgets "
              f"{sorted(set(r.max_new_tokens for r in reqs))}; warmup "
              f"{time.perf_counter() - t0:.2f} s; graph captured: {bool(eng._graphs)}")
        if not self.rehearsal and not eng._graphs:
            raise AssertionError("the decode chunk was not captured")
        restore = self.replay_equals_eager(eng, reqs[:slots])
        restore()
        replay_ms = self.time_ms(eng._decode_chunk, iters=4)
        restore()
        wall_us, rows = self.profiled(eng._decode_chunk, 1, every_launch=True)
        busy = sum(r[0] for r in rows)
        replay_us = replay_ms * 1e3 if replay_ms else float("nan")
        print(f"  ms a decode step replayed: {replay_us / chunk / 1e3:.3f} (CUDA events around 4 "
              f"replays; floor {floor_ms:.3f}); a profiled replay: "
              f"{sum(r[1] for r in rows) / chunk:.0f} kernels and {busy / chunk / 1e3:.3f} device "
              f"ms a step, idle share {1 - busy / replay_us:.3f} of the unprofiled replay "
              f"({self.card}); by kernel:")
        for dev_us, count, name in rows[:10]:
            print(f"    {dev_us / chunk / 1e3:9.4f} ms/step  {count / chunk:7.1f} calls/step  "
                  f"{name[:90]}")
        eng.reset()
        self.sync()
        dispatch.reset_launch_counts()
        done = eng.run(reqs)
        counts = dispatch.launch_counts()
        st = eng.stats
        steps = st["decode_chunks"] * chunk
        want = {"rmsnorm": norms * (n + steps), "e2afs_sqrt": n_rglru * (n + steps),
                "decode_attention": n_window * steps}
        got = {k: counts[k] for k in want}
        for name in want:
            self.rows[name]["engine_" + key] = counts[name]
        print(f"  Engine.run: makespan {st['makespan_s']:.3f} s, {st['total_tokens']} tokens, "
              f"{st['tok_s']:.1f} tok/s, {st['decode_chunks']} chunks; launches {got} (want "
              f"{want}: {n} admissions + {steps} steps)")
        self.family[cfg.name].update(engine_tok_s=st["tok_s"], makespan_s=st["makespan_s"],
                                     replay_ms_per_step=replay_us / chunk / 1e3)
        if not self.rehearsal and got != want:
            raise AssertionError(f"engine launch counts {got}, want {want}")
        if st["n_ok"] != n:
            raise AssertionError(f"not every request completed: {st}")
        longest = max(len(r.prompt) for r in reqs)
        order = sorted(reqs, key=lambda r: (len(r.prompt) < longest, r.uid < slots, r.uid))
        picked = order[:4] + [r for r in order[4:] if r.uid >= slots][:4]
        chosen = {r.uid for r in picked}
        picked += [r for r in order[4:] if r.uid not in chosen][:8 - len(picked)]
        same = 0
        for r in picked:
            eng.reset()
            same += int(np.array_equal(eng.run([r])[r.uid].tokens, done[r.uid].tokens))
        print(f"  alone in the pool: {same} of {len(picked)} requests token-identical (uids "
              f"{[r.uid for r in picked]})")
        if same != len(picked) or len(picked) < min(8, n):
            raise AssertionError("staggered requests differ from the same requests alone")
        del eng
        self.free()
        quiet = AccuracySLO(canary_stride=8, rel_err_budget=1e9, divergence_budget=None,
                            promote_after=None)
        slo = Engine(model, cfg, num_slots=slots, cache_len=e_len, chunk=chunk, slo=quiet)
        slo.warmup(prompt_lens=prompts)
        canaried = slo.run(reqs)
        same = sum(np.array_equal(canaried[r.uid].tokens, done[r.uid].tokens) for r in reqs)
        print(f"  canaries at stride 8 (budgets that never trip): {same} of {n} requests "
              f"token-identical to the engine without an SLO; {slo.stats['canary_checks']} "
              f"canaries, max relative logit error {slo.stats['canary_max_rel_err']:.4g}, graphs "
              f"{sorted(slo._graphs)}")
        if same != n or not slo.stats["canary_checks"]:
            raise AssertionError("the canaries changed the served tokens")
        peak = torch.cuda.max_memory_allocated() / 2**30 if not self.rehearsal else float("nan")
        print(f"  peak memory of the sub-phase {peak:.2f} GiB ({self.card})")
        del slo, model, logits
        self.free()

    # -- phase 18 ----------------------------------------------------------
    def whisper(self, **kw):
        """whisper-small (the smoke config in a rehearsal), e2afs."""
        from repro_torch.configs import get_config, get_smoke_config

        return (get_smoke_config if self.rehearsal else get_config)(
            "whisper-small", sqrt_unit="e2afs", **kw)

    def p18a_whisper_serve(self):
        """whisper-small at full width and depth (12 encoder and 12 decoder
        layers, d 768, LayerNorm, GELU, sinusoidal positions), bf16, weights
        from seed 0 with every constant-start leaf moved off its start (seed
        1): seeded audio (8, 1500, 768), ``precompute_cross`` then
        ``prefill`` (128-token prompt) then ``generate_scan`` (64 greedy
        tokens, cache 192), the launch counts set to 0 just before and read
        just after (an e2afs_rsqrt a LayerNorm: 25 in the encoder, 37 a
        decoder forward; decode attention at G = 1, head_dim 64, 12 a step,
        none with wrap); first-step logits within 4 bf16 ulps of the same
        weights on the plain versions and the first two tokens 8 of 8, and
        the same with float32 activations; the encoder's ms, prefill ms and
        ms a step beside the floor of the bytes a step moves; one
        ``decode_slots_step(cross_kv=)`` captured as a CUDA graph, its replay
        bit-identical to the eager step, ms a step of each; two requests
        admitted at staggered steps each equal to itself alone."""
        torch = self.torch
        from repro_torch.kernels import dispatch
        from repro_torch.models import lm

        cfg = self.whisper(decode_kernel="fused")
        batch, prompt_len, gen_len = (8, 6, 4) if self.rehearsal else (8, 128, 64)
        cache_len = prompt_len + gen_len
        frames = cfg.encoder.n_ctx
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        print(f"  {cfg.name}: {cfg.encoder.n_layers} encoder and {cfg.n_layers} decoder layers, "
              f"d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head}, d_ff "
              f"{cfg.d_ff} ({cfg.mlp_act}), {cfg.norm}, {cfg.pos} positions, vocab {cfg.vocab}, "
              f"{cfg.act_dtype}; audio ({batch}, {frames}, {cfg.d_model}), prompt {prompt_len}, "
              f"{gen_len} new tokens, cache {cache_len}")
        t0 = time.perf_counter()
        model = lm.init(cfg, self.gen(0), device=self.dev)
        moved = self.move_constant_starts(model, 1)
        self.sync()
        params = dict(model.named_parameters())
        weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
        print(f"  init: {lm.param_count(model) / 1e9:.4f} B parameters ({weight_bytes / 1e9:.3f} "
              f"GB) in {time.perf_counter() - t0:.1f} s; {moved} constant-start leaves moved off "
              f"their starts (seed 1)")
        audio = torch.randn(batch, frames, cfg.d_model, generator=self.gen(2), device=self.dev)
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=self.gen(3),
                               device=self.dev)

        def run(c, n, m=model):
            self.sync()
            t_a = time.perf_counter()
            ckv, _ = lm.precompute_cross(m, c, audio)
            self.sync()
            t_b = time.perf_counter()
            cache = lm.init_cache(c, batch, cache_len, device=self.dev)
            logits, cache = lm.prefill(m, c, cache, prompt, cross_kv=ckv, last_logit_only=True)
            self.sync()
            t_c = time.perf_counter()
            toks, _, cache = lm.generate_scan(m, c, cache, logits[:, -1:].argmax(-1), prompt_len,
                                              n, cross_kv=ckv)
            self.sync()
            return (logits, toks, ckv, cache, t_b - t_a, t_c - t_b,
                    time.perf_counter() - t_c)

        def plain(c, n, m=model):
            prev = dispatch.set_backend("reference")
            dispatch.reset_launch_counts()
            try:
                out = run(c.replace(decode_kernel="reference"), n, m)
            finally:
                dispatch.set_backend(prev)
            if not self.rehearsal and any(dispatch.launch_counts().values()):
                raise AssertionError(f"the plain-version run launched a kernel: "
                                     f"{dispatch.launch_counts()}")
            return out

        run(cfg, 2)  # warm-up
        dispatch.reset_launch_counts()
        logits, toks, ckv, cache, enc_s, pf_s, dec_s = run(cfg, gen_len)  # the main path
        counts, details = dispatch.launch_counts(), dispatch.launch_details()
        enc_norms, dec_norms = 2 * cfg.encoder.n_layers + 1, 3 * cfg.n_layers + 1
        want = dict.fromkeys(dispatch.KNOWN, 0)
        want.update({"e2afs_rsqrt": enc_norms + dec_norms * (1 + gen_len),
                     "decode_attention": cfg.n_layers * gen_len})
        for name in ("e2afs_rsqrt", "decode_attention"):
            self.rows[name]["whisper_small_launches"] = counts[name]
        want_details = {"decode_attention no wrap": cfg.n_layers * gen_len}
        print(f"  main path launches: {counts} {details} (want {want} {want_details}: "
              f"{enc_norms} encoder norms, {dec_norms} a decoder forward)")
        if not self.rehearsal and (counts != want or details != want_details):
            raise AssertionError(f"launch counts {counts} {details}, want {want} {want_details}")
        # a step reads the decoder's weights (of the embedding only its 8
        # rows), every layer's cross K/V and its cache
        dec_weights = sum(p.numel() * p.element_size() for n, p in params.items()
                          if n.startswith(("layers.", "unembed", "ln_f")))
        ckv_bytes = sum(t.numel() * t.element_size() for t in ckv.values())
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        floor_ms = (dec_weights + ckv_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
        step_ms = dec_s / gen_len * 1e3
        print(f"  encoder (precompute_cross) {enc_s * 1e3:.1f} ms; prefill {pf_s * 1e3:.1f} ms; "
              f"decode {step_ms:.3f} ms/step (eager), {batch * gen_len / dec_s:.1f} tok/s; floor "
              f"{floor_ms:.4f} ms/step ({dec_weights / 1e9:.3f} GB of decoder weights and "
              f"unembed, {ckv_bytes / 1e9:.3f} GB of cross K/V, {cache_bytes / 1e9:.4f} GB of "
              f"cache over {HBM_BYTES_PER_S / 1e12:.2f} TB/s) (host clock with synchronize; "
              f"{self.card})")
        self.family[cfg.name] = {"encoder_ms": enc_s * 1e3, "prefill_ms": pf_s * 1e3,
                                 "ms_per_step": step_ms, "tok_s": batch * gen_len / dec_s,
                                 "floor_ms": floor_ms}
        self.mesh_family(cfg, model, prompt, toks, cache_len, step_ms, counts, audio=audio)
        if tuple(logits.shape) != (batch, 1, cfg.vocab) or tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"shapes: logits {tuple(logits.shape)}, tokens "
                                 f"{tuple(toks.shape)}")
        if tuple(ckv["ck"].shape) != (cfg.n_layers, batch, frames, cfg.n_kv_heads, cfg.d_head):
            raise AssertionError(f"cross K/V {tuple(ckv['ck'].shape)}")

        # phase 4a's contract against the plain versions, in bf16 and with
        # float32 activations on the same weights (the float32 cache of
        # head_dim 64 has a decode-attention kernel too)
        m32 = lm.init(cfg.replace(act_dtype="float32"), self.gen(0), device=self.dev)
        with torch.no_grad():
            for a, b in zip(m32.parameters(), model.parameters()):
                a.copy_(b)
        for label, c, m in (("bfloat16", cfg, model),
                            ("float32", cfg.replace(act_dtype="float32"), m32)):
            if c is cfg:
                got, got_toks, got_ckv = logits, toks, ckv
            else:
                dispatch.reset_launch_counts()
                got, got_toks, got_ckv = run(c, 2, m)[:3]
                launched = dispatch.launch_counts()
                if not self.rehearsal and (launched["e2afs_rsqrt"] != enc_norms + 3 * dec_norms
                                           or launched["decode_attention"] != 2 * cfg.n_layers):
                    raise AssertionError(f"float32 launches {launched}")
            ref, ref_toks, rckv, _, renc_s, rpf_s, rdec_s = plain(c, got_toks.shape[1], m)
            diff = float((got.float() - ref.float()).abs().max())
            top = ref.float().abs().max().reshape(1)
            limit = 4 * float(ulp_of(top.to(torch.bfloat16)))
            ckv_diff = max(float((t.float() - rckv[k].float()).abs().max())
                           for k, t in got_ckv.items())
            first = [int((got_toks[:, i] == ref_toks[:, i]).sum()) for i in range(2)]
            print(f"  {label} activations, kernels vs plain versions (plain: encoder "
                  f"{renc_s * 1e3:.1f} ms, prefill {rpf_s * 1e3:.1f} ms, decode "
                  f"{rdec_s / max(1, got_toks.shape[1]) * 1e3:.3f} ms/step): first-step logits "
                  f"max |diff| {diff:.4g} (limit {limit:.4g}: 4 bf16 ulps at max |logit| "
                  f"{float(top):.4g}); cross K/V max |diff| {ckv_diff:.4g}; first two generated "
                  f"tokens agree {first} of {batch}")
            self.family[cfg.name][f"{label}_logit_diff"] = diff
            self.family[cfg.name][f"{label}_first_two"] = first
            if not bool(torch.isfinite(got).all()) or diff > limit:
                raise AssertionError(f"{label} logits disagree with the plain versions")
            if first != [batch, batch]:
                raise AssertionError(f"{label} first two tokens disagree: {first} of {batch}")
        del m32, cache
        self.free()

        # one decode_slots_step over the pool with the pool's cross K/V,
        # captured as a CUDA graph: its replay bit-identical to the eager step
        pool = lm.init_pool_state(cfg, batch, cache_len, device=self.dev)
        pool_ckv = {k: torch.zeros_like(t) for k, t in ckv.items()}
        slots = torch.arange(batch, device=self.dev)
        first_logits, _ = lm.prefill_into_slots(model, cfg, pool["cache"], prompt, slots,
                                                cross_kv=ckv, pool_cross_kv=pool_ckv)
        pool["tok"].copy_(first_logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
        pool["pos"].fill_(prompt_len)
        pool["active"].fill_(True)
        pool["remaining"].fill_(10**6)
        out_toks = torch.zeros((batch, 1), dtype=torch.int32, device=self.dev)
        out_emit = torch.zeros((batch, 1), dtype=torch.bool, device=self.dev)
        state = lm.pool_tensors(pool) + [out_toks, out_emit]
        start = [t.clone() for t in state]

        def restore():
            for t, s0 in zip(state, start):
                t.copy_(s0)

        def step():
            lm.decode_slots_step(model, cfg, pool, out_toks, out_emit, 0, cross_kv=pool_ckv)

        def outcome(fn):
            restore()
            fn()
            self.sync()
            return [t.clone() for t in state]

        eager = outcome(step)
        if self.rehearsal:
            graphed = outcome(step)
            replay = step
        else:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with dispatch.capture_launches() as launches, torch.cuda.graph(graph):
                step()

            def replay():
                graph.replay()
                dispatch.replay_launches(launches)

            graphed = outcome(replay)
            print(f"  captured step launches: {launches.counts} {launches.details}")
            if (launches.counts["decode_attention"] != cfg.n_layers
                    or launches.counts["e2afs_rsqrt"] != dec_norms):
                raise AssertionError(f"the captured step launches {launches.counts}")
        differ = [i for i, (a, b) in enumerate(zip(graphed, eager))
                  if not torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                                     b.view(torch.uint8) if b.is_floating_point() else b)]
        moved_state = any(not torch.equal(a, b) for a, b in zip(eager, start))
        restore()
        eager_ms = self.time_ms(step, iters=20)
        restore()
        replay_ms = self.time_ms(replay, iters=20)
        restore()
        print(f"  decode_slots_step(cross_kv=) replayed vs eager from one pool state: "
              f"{len(differ)} of {len(eager)} tensors differ (every pool tensor, the step's "
              f"tokens and emission); ms a step eager {eager_ms}, replayed {replay_ms} (CUDA "
              f"events around 20 steps; floor {floor_ms:.4f}; {self.card})")
        self.family[cfg.name].update(eager_step_ms=eager_ms, replay_step_ms=replay_ms)
        if differ or not moved_state:
            raise AssertionError(f"the graphed step differs from the eager one: {differ}")
        restore()
        _, rows = self.profiled(replay, 1, every_launch=True)
        restore()
        busy = sum(r[0] for r in rows) / 1e3
        print(f"  a profiled replay: {sum(r[1] for r in rows)} kernels, {busy:.3f} device ms, "
              f"idle share {1 - busy / replay_ms if replay_ms else float('nan'):.3f} of the "
              f"unprofiled replay ({self.card}); by kernel:")
        for dev_us, count, name in rows[:10]:
            print(f"    {dev_us / 1e3:9.4f} ms  {count:5d} calls  {name[:100]}")
        del pool, graphed, eager, start, state

        # two requests admitted at staggered steps (rows 0 and 1 of the
        # audio and prompt, into slots 2 and 5 at steps 0 and 3), each equal
        # to itself alone in a pool of the same shape
        budget = 4 if self.rehearsal else 16

        def slot_run(admit):
            pool = lm.init_pool_state(cfg, batch, cache_len, device=self.dev)
            pool_ckv = {k: torch.zeros_like(t) for k, t in ckv.items()}
            toks = torch.zeros((batch, 3 + budget), dtype=torch.int32, device=self.dev)
            emit = torch.zeros((batch, 3 + budget), dtype=torch.bool, device=self.dev)
            for i in range(3 + budget):
                for r, (slot, at) in admit.items():
                    if at != i:
                        continue
                    sl = torch.tensor([slot], device=self.dev)
                    lg, _ = lm.prefill_into_slots(model, cfg, pool["cache"], prompt[r:r + 1], sl,
                                                  cross_kv={k: t[:, r:r + 1] for k, t in
                                                            ckv.items()},
                                                  pool_cross_kv=pool_ckv)
                    pool["tok"][slot] = lg[0, -1].argmax().to(torch.int32)
                    pool["pos"][slot] = prompt_len
                    pool["active"][slot] = True
                    pool["remaining"][slot] = budget
                lm.decode_slots_step(model, cfg, pool, toks, emit, i, cross_kv=pool_ckv)
            return {r: toks[slot][emit[slot]].tolist() for r, (slot, _) in admit.items()}

        both = slot_run({0: (2, 0), 1: (5, 3)})
        alone = [slot_run({r: (slot, 0)})[r] for r, slot in ((0, 2), (1, 5))]
        same = [both[r] == alone[r] and len(alone[r]) == budget for r in (0, 1)]
        print(f"  staggered requests (slots 2 and 5, admitted at steps 0 and 3, {budget} tokens "
              f"each) equal to each alone in the pool: {same}")
        if not all(same):
            raise AssertionError("staggered requests differ from the same requests alone")
        peak = torch.cuda.max_memory_allocated() / 2**30 if not self.rehearsal else float("nan")
        print(f"  peak memory of the sub-phase {peak:.2f} GiB ({self.card})")
        del model, ckv, logits
        self.free()

    def p18b_whisper_train(self):
        """whisper-small training at full width and depth: batch 4 x 448
        text tokens and 1500 seeded audio frames a row, remat "block", fused
        AdamW, one warm-up and two timed steps (phase 11b's run)."""
        torch = self.torch

        cfg = self.whisper(remat="block")
        batch, seq = (2, 64) if self.rehearsal else (4, 448)
        frames = cfg.encoder.n_ctx

        def audio(i):
            g = self.gen(100 + i)
            return {"audio": torch.randn(batch, frames, cfg.d_model, generator=g,
                                         device=self.dev)}

        print(f"  {cfg.name}: audio ({batch}, {frames}, {cfg.d_model}) a batch beside its text "
              f"tokens")
        self.train_phase(cfg, batch, seq, timed=2, compare_routes=False,
                         launches_key="whisper_small_launches", move_constants=True, extra=audio)

    # -- phase 19 ----------------------------------------------------------
    def p19_mesh(self):
        """Sharded serving on the one-device mesh (:meth:`one_mesh`, made
        by phase 16a's 19h or here), destroyed at the end.  On
        phase 4a's and 4d's models with phase 13's shapes and traces:
        (a) exact mode against 13a's tokens, launches and ms a step, the
        pool's placements kept; (b) the default tensor-parallel rules, the
        same tokens (a one-wide 'model' axis splits no sum); (c) 13b's ring
        cache in exact mode, and the int8 cache at 13a's shape against the
        unsharded int8 engine; (d) snapshots resumed across mesh shapes;
        (e) ``lm.prefill``/``generate_scan`` with ``mesh=`` on phase 4a's
        model and prompt against 4a's tokens, and ``serve.generate`` with
        ``mesh=`` against it without; (f) phase 14c's faulted engine and
        (g) phase 15g's SLO engines (:meth:`mesh_faults`,
        :meth:`mesh_slo`).  (h) ran in phases 16-18 (:meth:`mesh_family`)."""
        import torch.distributed as dist

        try:
            mesh = self.one_mesh()
            self.mesh_engines(mesh)
            self.mesh_resume(mesh)
            self.mesh_generate(mesh)
            self.mesh_faults(mesh)
            self.mesh_slo(mesh)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            self.mesh = None

    def one_mesh(self):
        """The one-device mesh of phases 16-19: a one-rank process group
        (NCCL on the card; this host has one card) and
        ``make_production_mesh(shape=(1, 1))``, made on first use and
        destroyed at the end of phase 19."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_production_mesh

        if self.mesh is None:
            if dist.is_initialized():
                raise AssertionError("a process group exists before the mesh phases")
            self.mesh = make_production_mesh(shape=(1, 1), device=self.dev)
            print(f"  mesh {dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))} on "
                  f"{dist.get_backend()}, world size {dist.get_world_size()} ({self.card})")
        return self.mesh

    def same_tokens(self, done, ref, uids=None):
        import numpy as np

        uids = sorted(ref) if uids is None else uids
        return sum(int(np.array_equal(done[u].tokens, ref[u].tokens)) for u in uids), len(uids)

    def mesh_engine(self, cfg, model, mesh, rules, run, *, reqs, label, warm=True, ref="13's",
                    **kw):
        """An Engine on ``mesh`` by ``rules`` at ``run``'s shape serving
        ``reqs`` (warmed up and captured first), the counts set to 0 just
        before the trace and read just after.  Returns (engine, done,
        counts, ms a replayed step)."""
        from repro_torch.distributed import sharding
        from repro_torch.kernels import dispatch
        from repro_torch.launch.engine import Engine
        from repro_torch.models import lm

        sh = run["shape"]
        eng = Engine(model, cfg, num_slots=sh["slots"], cache_len=sh["cache_len"],
                     chunk=sh["chunk"], mesh=mesh, rules=rules, **kw)
        if warm:
            eng.warmup(prompt_lens=sh["prompts"])
        self.sync()
        dispatch.reset_launch_counts()
        done = eng.run(reqs)
        counts = dispatch.launch_counts()
        want = sharding.serve_pool_tree(eng._pool_sh)
        kept = all(dt.placements == s.placements and dt.to_local().data_ptr() == t.data_ptr()
                   for dt, s, t in zip(lm.pool_tensors(eng._dpool), lm.pool_tensors(want),
                                       lm.pool_tensors(eng.pool)))
        step_ms = None
        if warm and not self.rehearsal:
            eng.reset()
            for slot, req in enumerate(reqs[:sh["slots"]]):
                eng._admit(req, slot, 0.0)
            step_ms = self.time_ms(eng._decode_chunk, iters=4) / sh["chunk"]
        print(f"  {label}: makespan {eng.stats['makespan_s']:.3f} s ({ref} "
              f"{run['stats']['makespan_s']:.3f}), {eng.stats['tok_s']:.1f} tok/s, "
              f"{eng.stats['decode_chunks']} chunks ({ref} {run['stats']['decode_chunks']}); "
              f"ms a replayed step {step_ms if step_ms is None else round(step_ms, 4)} ({ref} "
              f"{run['step_ms']:.4f}); launches {counts}; pool placements kept: {kept} "
              f"({self.card})")
        if not kept:
            raise AssertionError(f"{label}: the pool left its placements")
        return eng, done, counts, step_ms

    def mesh_engines(self, mesh):
        from repro_torch.distributed.sharding import serve_rules
        from repro_torch.launch.engine import Engine

        q13 = self.engine_runs["engine_qwen3_4b_launches"]
        g13 = self.engine_runs["engine_gemma3_1b_launches"]
        cfg, model = self.serving[:2]
        for mode, rules in (("19a exact", serve_rules(cfg, mesh, replicate_params=True)),
                            ("19b tensor parallel", serve_rules(cfg, mesh))):
            eng, done, counts, step_ms = self.mesh_engine(cfg, model, mesh, rules, q13,
                                                          reqs=q13["reqs"], label=mode)
            same, n = self.same_tokens(done, q13["done"])
            want = {k: self.rows[k]["engine_qwen3_4b_launches"]
                    for k in ("rmsnorm", "decode_attention")}
            got = {k: counts[k] for k in want}
            print(f"  {mode}: {same} of {n} requests token-identical to 13a's; rmsnorm and "
                  f"decode_attention launches {got} (13a's {want})")
            key = "mesh_exact_launches" if mode.startswith("19a") else "mesh_tp_launches"
            for k, v in got.items():
                self.rows[k][key] = v
            if same != n or (not self.rehearsal and got != want):
                raise AssertionError(f"{mode}: tokens or launches differ from phase 13a's")
            if step_ms is not None:
                self.engine_runs[key] = dict(step_ms=step_ms, makespan_s=eng.stats["makespan_s"])
            del eng
            self.free()

        gcfg, gmodel = self.gemma
        eng, done, counts, _ = self.mesh_engine(
            gcfg, gmodel, mesh, serve_rules(gcfg, mesh, replicate_params=True), g13,
            reqs=g13["reqs"], label="19c gemma3-1b ring, exact")
        same, n = self.same_tokens(done, g13["done"])
        print(f"  19c gemma3-1b: {same} of {n} requests token-identical to 13b's")
        if same != n:
            raise AssertionError("19c: the ring cache on the mesh differs from 13b's tokens")
        del eng
        self.free()

        reqs = q13["reqs"][:8]
        sh = q13["shape"]
        plain = Engine(model, cfg, num_slots=sh["slots"], cache_len=sh["cache_len"],
                       chunk=sh["chunk"], quantized_kv=True)
        plain.warmup(prompt_lens=sh["prompts"])
        ref = plain.run(reqs)
        del plain
        eng, done, _, _ = self.mesh_engine(
            cfg, model, mesh, serve_rules(cfg, mesh, replicate_params=True), q13, reqs=reqs,
            label="19c int8 cache, exact", quantized_kv=True)
        same, n = self.same_tokens(done, ref)
        print(f"  19c int8: {same} of {n} requests token-identical to the unsharded int8 "
              f"engine")
        if same != n:
            raise AssertionError("19c: the int8 cache on the mesh differs from the unsharded")
        del eng
        self.free()

    def mesh_resume(self, mesh):
        """19d: 13a's draw killed mid-trace and resumed across mesh shapes:
        a one-device snapshot onto the mesh, a mesh snapshot onto no mesh;
        every uid finished exactly once with 13a's tokens."""
        import tempfile

        from repro_torch.distributed.sharding import serve_rules
        from repro_torch.launch.engine import Engine
        from repro_torch.launch.kill_resume import audit

        q13 = self.engine_runs["engine_qwen3_4b_launches"]
        cfg, model = self.serving[:2]
        sh = q13["shape"]
        reqs = q13["reqs"][:12]
        exact = serve_rules(cfg, mesh, replicate_params=True)
        tokens = {r.uid: q13["done"][r.uid].tokens for r in reqs}
        kw = dict(num_slots=sh["slots"], cache_len=sh["cache_len"], chunk=sh["chunk"])
        # the rehearsal's trace ends within two chunks: cut it at the first
        kill, every = (1, 1) if self.rehearsal else (3, 2)
        for label, first, then in (("one device -> mesh", None, mesh),
                                   ("mesh -> one device", mesh, None)):
            with tempfile.TemporaryDirectory(prefix="mesh-snapshot-") as tmp:
                snap, jpath = Path(tmp) / "snap", Path(tmp) / "journal.jsonl"
                eng = Engine(model, cfg, snapshot_dir=snap, snapshot_every_chunks=every,
                             journal=jpath, mesh=first, rules=exact if first else None, **kw)
                seg1 = eng.run(reqs, max_chunks=kill)
                killed = eng.stats["killed"]
                del eng
                self.free()
                t0 = time.perf_counter()
                eng = Engine.resume(model, cfg, snap, journal=jpath, mesh=then,
                                    rules=exact if then else None)
                self.sync()
                resume_ms = (time.perf_counter() - t0) * 1e3
                restored = sum(o is not None for o in eng._owner)
                seg2 = eng.run([])
                failures = audit(jpath, reqs, tokens)
                print(f"  19d {label}: killed at chunk {kill} ({killed}; {len(seg1)} finished "
                      f"before), resumed with {restored} slots in flight in {resume_ms:.1f} ms, "
                      f"{len(seg2)} finished after; every uid exactly once with 13a's tokens: "
                      f"{failures or 'yes'} ({self.card})")
                if not killed or failures:
                    raise AssertionError(f"19d {label}: not exactly-once with 13a's tokens")
                del eng
                self.free()

    def mesh_generate(self, mesh):
        """19e: phase 4a's model, prompt and shapes through ``lm.prefill`` and
        ``lm.generate_scan`` with ``mesh=`` (the calls ``serve.generate``
        makes): 4a's tokens; and ``serve.generate`` with ``mesh=`` at smoke
        width and 4a's batch, prompt and length against it without."""
        torch = self.torch
        from repro_torch.distributed import sharding
        from repro_torch.launch import serve
        from repro_torch.models import lm

        cfg, model, prompt, _, batch, prompt_len, cache_len = self.serving
        gen_len = cache_len - prompt_len
        rules = sharding.serve_rules(cfg, mesh)
        local = sharding.place_model(model, cfg, mesh, rules)
        like = lm.init_cache(cfg, batch, cache_len, abstract=True)
        cache = sharding.local_tree(sharding.zeros_tree(like, sharding.shardings_for(
            lm.cache_specs(cfg), mesh, rules, like)))
        logits, cache = lm.prefill(local, cfg, cache, prompt, last_logit_only=True, mesh=mesh,
                                   rules=rules)
        toks, _, _ = lm.generate_scan(local, cfg, cache, logits[:, -1:].argmax(-1), prompt_len,
                                      gen_len, mesh=mesh, rules=rules)
        same = bool(torch.equal(toks, self.serve_tokens))
        del local, cache
        kw = dict(batch=batch, prompt_len=prompt_len, gen_len=gen_len, reps=1, verbose=False,
                  device=self.dev)
        on_mesh, stats = serve.generate("qwen3-4b", mesh=mesh, **kw)
        plain, _ = serve.generate("qwen3-4b", **kw)
        print(f"  19e lm.prefill/generate_scan(mesh=) on 4a's model: tokens identical to 4a's: "
              f"{same}; serve.generate(mesh=) at smoke width, batch {batch}, prompt "
              f"{prompt_len}, {gen_len} tokens: identical to it without: "
              f"{bool(torch.equal(on_mesh, plain))} ({stats['decode_ms_per_token']:.3f} ms a "
              f"token on the mesh; {self.card})")
        if not same or not torch.equal(on_mesh, plain):
            raise AssertionError("19e: mesh serving differs from phase 4a's tokens")
        self.free()

    def mesh_faults(self, mesh):
        """19f: phase 14c's faulted engine (``sqrt_man`` 1e-3, seed 7, in
        every norm; 8 slots of 576 lines, chunks of 8, its 8 requests of
        512 tokens and 32 steps) on the mesh under exact and tensor-parallel
        rules: tokens identical to 14c's engine (run in 15c), ms a replayed
        step beside 14c's (15c's CUDA events)."""
        from repro_torch.distributed.sharding import serve_rules

        ref = self.faulted_ref
        if ref is None:
            raise AssertionError("phase 15c left no faulted engine run")
        cfg, model = ref["cfg"], self.serving[1]
        for label, rules in (("19f faulted engine, exact", serve_rules(cfg, mesh,
                                                                       replicate_params=True)),
                             ("19f faulted engine, tensor parallel", serve_rules(cfg, mesh))):
            eng, done, counts, step_ms = self.mesh_engine(
                cfg, model, mesh, rules, ref, reqs=ref["reqs"], label=label, ref="14c's")
            same, n = self.same_tokens(done, ref["done"])
            print(f"  {label}: {same} of {n} requests token-identical to 14c's engine under "
                  f"{cfg.sqrt_faults}")
            if same != n or counts.get("rmsnorm"):
                raise AssertionError(f"{label}: tokens differ from 14c's, or a fused norm ran")
            key = "mesh_faulted_exact_launches" if "exact" in label else "mesh_faulted_tp_launches"
            self.rows["decode_attention"][key] = counts["decode_attention"]
            self.engine_runs[label] = dict(step_ms=step_ms, ref_ms=ref["step_ms"])
            del eng
            self.free()

    def mesh_slo(self, mesh):
        """19g: phase 15g's SLO engines on the mesh in exact mode: (b)'s
        canaries at stride 8 with budgets that never trip, tokens and canary
        counters identical to 15g's, ms a replayed step beside 15g's; (d)'s
        pressure (``sqrt_man`` bit 21 at rate 1.0, stride 2): the same
        demotions, rungs and probe tokens."""
        from repro_torch.core.faults import FaultConfig
        from repro_torch.distributed.sharding import serve_rules
        from repro_torch.launch.engine import AccuracySLO, Request

        ref = self.slo_ref
        if ref is None or "pressure" not in ref:
            raise AssertionError("phase 15g left no SLO runs")
        cfg, model = self.serving[:2]
        exact = serve_rules(cfg, mesh, replicate_params=True)
        quiet = AccuracySLO(canary_stride=8, rel_err_budget=1e9, divergence_budget=None,
                            promote_after=None)
        run = dict(shape=ref["shape"], stats=ref["stats"], step_ms=ref["step_ms"])
        eng, done, counts, step_ms = self.mesh_engine(
            cfg, model, mesh, exact, run, reqs=ref["reqs"], label="19g SLO stride 8, exact",
            ref="15g's", slo=quiet)
        same, n = self.same_tokens(done, ref["done"])
        keys = ("canary_checks", "canary_divergences", "demotions", "promotions")
        st = {k: eng.stats[k] for k in keys}
        want = {k: ref["stats"][k] for k in keys}
        print(f"  19g stride 8: {same} of {n} requests token-identical to 15g's; counters {st} "
              f"(15g's {want}); max relative logit error {eng.stats['canary_max_rel_err']:.4g} "
              f"(15g's {ref['stats']['canary_max_rel_err']:.4g})")
        if same != n or st != want:
            raise AssertionError("19g: the SLO engine on the mesh differs from 15g's")
        for k in ("rmsnorm", "decode_attention"):
            self.rows[k]["mesh_slo_launches"] = counts[k]
        self.engine_runs["19g SLO"] = dict(step_ms=step_ms, ref_ms=ref["step_ms"])
        del eng
        self.free()

        p = ref["pressure"]
        sh, chunk = ref["shape"], ref["shape"]["chunk"]
        from repro_torch.launch.engine import Engine

        ed = Engine(model, cfg, num_slots=sh["slots"], cache_len=sh["cache_len"], chunk=chunk,
                    faults=FaultConfig("sqrt_man", 1.0, seed=7, bit=21),
                    slo=AccuracySLO(canary_stride=2, rel_err_budget=0.05, divergence_budget=0,
                                    promote_after=None), mesh=mesh, rules=exact)
        ed.run([Request(uid=100 + i, prompt=r.prompt, max_new_tokens=chunk)
                for i, r in enumerate(ref["reqs"][:sh["slots"]])])
        first = {k: ed.stats[k] for k in keys}
        want = {k: p["first"][k] for k in keys}
        done_d = ed.run(p["probes"])
        same, n = self.same_tokens(done_d, p["done"], [r.uid for r in p["probes"]])
        trails = sum(done_d[r.uid].unit_trips == p["done"][r.uid].unit_trips for r in p["probes"])
        print(f"  19g pressure: counters {first} (15g's {want}); rungs {ed.unit_names}; probes "
              f"{same} of {n} token-identical to 15g's, {trails} rung trails identical")
        if first != want or ed.unit_names != p["names"] or same != n or trails != n:
            raise AssertionError("19g: demotion on the mesh differs from 15g's")
        del ed
        self.free()

    def mesh_family(self, cfg, model, prompt, toks, cache_len, ms_per_step, counts, *,
                    audio=None):
        """19h, inside the family's phase (16a-c, 17a-b, 18a): its model,
        prompt (and audio) placed on the one-device mesh by the default
        tensor-parallel rules, through ``lm.precompute_cross``/``prefill``/
        ``generate_scan(mesh=)`` for 16 greedy tokens, the counts set to 0
        just before and read just after: the first 16 of the phase's
        tokens, the kernels the phase's main path launched (``counts``), ms
        a step (host clock, eager) beside the phase's."""
        from repro_torch.distributed import sharding
        from repro_torch.kernels import dispatch
        from repro_torch.models import lm

        n = 4 if self.rehearsal else 16
        mesh = self.one_mesh()
        batch, prompt_len = prompt.shape
        rules = sharding.serve_rules(cfg, mesh)
        local = sharding.place_model(model, cfg, mesh, rules)  # aliases: one device holds all
        like = lm.init_cache(cfg, batch, cache_len, abstract=True)
        cache = sharding.local_tree(sharding.zeros_tree(like, sharding.shardings_for(
            lm.cache_specs(cfg), mesh, rules, like)))
        self.sync()
        dispatch.reset_launch_counts()
        ckv = (None if audio is None else
               lm.precompute_cross(local, cfg, audio, mesh=mesh, rules=rules)[0])
        logits, cache = lm.prefill(local, cfg, cache, prompt, cross_kv=ckv, last_logit_only=True,
                                   mesh=mesh, rules=rules)
        self.sync()
        t0 = time.perf_counter()
        got, _, _ = lm.generate_scan(local, cfg, cache, logits[:, -1:].argmax(-1), prompt_len, n,
                                     cross_kv=ckv, mesh=mesh, rules=rules)
        self.sync()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        mesh_counts = dispatch.launch_counts()
        same = bool(self.torch.equal(got, toks[:, :n]))
        ran = sorted(k for k, v in counts.items() if v)
        print(f"  19h {cfg.name} on the one-device mesh, default tensor-parallel rules: {n} "
              f"greedy tokens identical to the phase's: {same}; launches "
              f"{ {k: v for k, v in mesh_counts.items() if v} } (the phase's kernels {ran}); "
              f"{step_ms:.3f} ms a step on the mesh (the phase's {ms_per_step:.3f}; host clock "
              f"with synchronize, eager; {self.card})")
        self.family[cfg.name]["mesh_ms_per_step"] = step_ms
        del local, cache, ckv
        if not same:
            raise AssertionError(f"19h {cfg.name}: tokens on the mesh differ from its phase's")
        if not self.rehearsal and sorted(k for k, v in mesh_counts.items() if v) != ran:
            raise AssertionError(f"19h {cfg.name}: the mesh run launched {mesh_counts}, the "
                                 f"phase's main path {ran}")

    # -- phase 7 -----------------------------------------------------------
    def p7_sobel(self):
        torch = self.torch
        from repro_torch.apps.images import IMAGE_NAMES, test_image
        from repro_torch.kernels.sobel import ops, ref

        n = 32 if self.rehearsal else 256
        frames = [(54, 96), (108, 192)] if self.rehearsal else [(1080, 1920), (2160, 3840)]
        cases = [(f"random {h}x{w}", (h, w)) for h, w in [(3, 3), (67, 93), (34, 131)] + frames]
        cases[3:3] = [(f"{name} {n}x{n}", name) for name in IMAGE_NAMES]
        for label, spec in cases:
            if isinstance(spec, str):
                img = torch.as_tensor(test_image(spec, n)).to(self.dev, torch.float32)
            else:
                img = torch.rand(spec, generator=self.gen(spec[0] + spec[1]), device=self.dev) * 255
            y, r = ops.sobel_magnitude(img), ref.ref_sobel(img)
            self.sync()
            bad = int((y.view(torch.int32) != r.view(torch.int32)).sum())
            print(f"  sobel {label:22s}: {bad} of {y.numel()} pixels differ from the plain version")
            if bad or tuple(y.shape) != (img.shape[0] - 2, img.shape[1] - 2):
                raise AssertionError(f"sobel {label}: not bit-identical to its plain version")
        self.rows["sobel"]["max_abs_err"] = 0.0

    # -- phase 8 -----------------------------------------------------------
    def p8_kmeans(self):
        torch = self.torch
        from repro_torch.apps.images import rgb_test_image
        from repro_torch.apps.kmeans import init_centroids
        from repro_torch.kernels.kmeans import ops, ref

        def rel_to(a, b):
            return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

        n = 32 if self.rehearsal else 256
        cases = []
        for label, rgb in ((f"peppers {n}x{n}", rgb_test_image("peppers", n)),
                           ("frame {}x{}".format(*self.frame().shape[:2]), self.frame())):
            for k in (8, 20):
                cases.append((label, *self.pixels(rgb, k, k), PLAIN_SUMS_LIMIT))
        # the deployment batch at the shapes phase 9 gives the kernel, with
        # the centroids kmeans_quantize_batch starts from
        stack = self.stack()
        bpx = torch.as_tensor(stack.reshape(len(stack), -1, 3)).to(self.dev, torch.float32)
        bcent = torch.stack([init_centroids(bpx[i], i, 20) for i in range(len(stack))])
        cases.append(("batch {} x {}x{}".format(*stack.shape[:3]), bpx.contiguous(),
                      bcent.contiguous(), PLAIN_BATCH_SUMS_LIMIT))
        worst = 0.0
        for label, px, cent, plain_limit in cases:
            k = cent.shape[-2]
            got = ops.kmeans_assign(px, cent)
            again = ops.kmeans_assign(px, cent)
            ra, rs, rc = ref.ref_kmeans_assign(px, cent)
            onehot = torch.nn.functional.one_hot(ra.long(), k).double()
            exact = onehot.transpose(-1, -2) @ px.double()  # float64 sums, same assignments
            self.sync()
            flips = int((got[0] != ra).sum())
            counts_equal = bool(torch.equal(got[2], rc))
            rel = rel_to(got[1], rs)
            rel_k, rel_p = rel_to(got[1].double(), exact), rel_to(rs.double(), exact)
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            print(f"  kmeans_assign {label:22s} K={k:2d} N={px.shape[-2]}: {flips} assignments "
                  f"differ, counts equal {counts_equal}, sums max relative diff {rel:.3e} "
                  f"(limit {plain_limit:.0e}); against float64 sums of the same assignments: "
                  f"kernel {rel_k:.3e} (limit {KERNEL_SUMS_LIMIT:.0e}), plain {rel_p:.3e}; "
                  f"rerun bit-identical {same}")
            if (flips or not counts_equal or rel > plain_limit or rel_k > KERNEL_SUMS_LIMIT
                    or not same):
                raise AssertionError(f"kmeans_assign {label} K={k} disagrees with its plain "
                                     "version or with the float64 sums")
            worst = max(worst, float((got[1] - rs).abs().max()))
        self.rows["kmeans_assign"]["max_abs_err"] = worst

    # -- phase 9 -----------------------------------------------------------
    def p9_paper(self):
        import numpy as np

        torch = self.torch
        from repro_torch.apps import kmeans, sobel
        from repro_torch.apps.images import IMAGE_NAMES, rgb_test_image, test_image
        from repro_torch.apps.metrics_img import psnr
        from repro_torch.core import error_metrics, get_unit
        from repro_torch.kernels import dispatch
        from repro_torch.launch import paper

        n = 64 if self.rehearsal else 256
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        t3 = paper.table3(device=self.dev)
        t4 = paper.table4(device=self.dev, n=n)
        f5 = paper.fig5(device=self.dev, n=n)
        self.sync()
        wall = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        print(f"  paper path launches: {counts}; {wall:.2f} s wall (host clock, image metrics "
              f"on the host; {self.card})")
        want = {"sobel": len(IMAGE_NAMES), "kmeans_assign": 13}
        self.rows["sobel"]["launches"] = counts["sobel"]
        self.rows["kmeans_assign"]["launches"] = counts["kmeans_assign"]
        if not self.rehearsal and any(counts[name] != c for name, c in want.items()):
            raise AssertionError(f"paper path launches {counts}, want {want}")

        # Table 3: the card against the CPU plain run, equal
        for name in paper.UNITS + ("e2afs_rsqrt",):
            op, refn = ("rsqrt", "rsqrt") if name == "e2afs_rsqrt" else ("sqrt", "sqrt")
            unit = get_unit(name.split("_")[0])
            cpu = error_metrics(getattr(unit, op), reference=refn, device="cpu")
            if t3[name] != cpu:
                raise AssertionError(f"Table 3 {name}: card {t3[name]} != CPU {cpu}")
        print("  Table 3: every row equal to its CPU plain result")
        # Table 4: kernel route identical to the plain route; the ordering
        for name in IMAGE_NAMES:
            img = test_image(name, n)
            if not (sobel.edge_map(img, "e2afs", use_kernel=True, device=self.dev)
                    == sobel.edge_map(img, "e2afs", device=self.dev)).all():
                raise AssertionError(f"Table 4 {name}: kernel route differs from the plain route")
        avg = {u: float(np.mean([t4[name][u]["psnr"] for name in IMAGE_NAMES]))
               for u in paper.UNITS}
        bar = t4["barbara"]
        print(f"  Table 4: kernel route identical to the plain route on all {len(IMAGE_NAMES)} "
              f"images; average PSNR cwaha8 {avg['cwaha8']:.3f} > e2afs {avg['e2afs']:.3f} > esas "
              f"{avg['esas']:.3f}")
        if not (avg["cwaha8"] > avg["e2afs"] > avg["esas"]
                and bar["cwaha8"]["psnr"] > bar["e2afs"]["psnr"] > bar["esas"]["psnr"]):
            raise AssertionError("Table 4: the paper's PSNR ordering does not hold")
        # Fig. 5: the paper path's fused Lloyd run (13 launches an image)
        # against the broadcast run from the same starting centroids.  Equal
        # assignments make every centroid the mean of the same pixels, so the
        # centroids differ only as the sums do (the sums' limit of phase 8).
        rgb = rgb_test_image("peppers", n)
        pix = torch.as_tensor(rgb.reshape(-1, 3)).to(self.dev, torch.float32)
        start = kmeans.init_centroids(pix, 0, 20)  # kmeans_quantize's seed and K
        dispatch.reset_launch_counts()
        c_f, a_f = kmeans.lloyd(pix, start, iters=12, fused=True)
        one = dispatch.launch_counts()["kmeans_assign"]
        c_b, a_b = kmeans.lloyd(pix, start, iters=12, fused=False)
        flips = int((a_f != a_b).sum())
        crel = float(((c_f - c_b).abs() / c_b.abs().clamp_min(1e-30)).max())
        quant = c_f[a_f.long()].reshape(rgb.shape).cpu().numpy().astype(np.float64)
        p_fused = psnr(rgb.mean(-1), quant.mean(-1))
        print(f"  Fig. 5 e2afs: fused against broadcast, {flips} of {a_f.numel()} assignments "
              f"differ, centroids max relative diff {crel:.3e} (limit {PLAIN_SUMS_LIMIT:.0e}); "
              f"fused PSNR {p_fused:.6f} dB, the paper path's {f5['e2afs']['psnr']:.6f}; "
              f"{one} kmeans_assign launches for one image")
        if flips or crel > PLAIN_SUMS_LIMIT or (not self.rehearsal and one != 13):
            raise AssertionError("Fig. 5: fused and broadcast disagree, or launches != 13")
        if p_fused != f5["e2afs"]["psnr"]:
            raise AssertionError("Fig. 5: this fused run is not the paper path's")
        if not all(np.isfinite(r["psnr"]) and 0 < r["ssim"] <= 1 for r in f5.values()):
            raise AssertionError("Fig. 5: a PSNR or SSIM out of range")

        # deployment size: a 1920 x 1080 frame, then 16 images of 512 x 512
        frame, stack = self.frame(), self.stack()
        for label, run, count in (
                ("frame {}x{}".format(*frame.shape[:2]),
                 lambda: kmeans.kmeans_quantize(frame, fused=True, device=self.dev), 1),
                ("batch {} x {}x{}".format(*stack.shape[:3]),
                 lambda: kmeans.kmeans_quantize_batch(stack, device=self.dev), len(stack))):
            run()  # warm-up
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            quant, cent = run()
            wall = time.perf_counter() - t0
            launches = dispatch.launch_counts()["kmeans_assign"]
            _, rows = self.profiled(run, 1)
            busy = sum(r[0] for r in rows) / 1e3
            kernels = sum(r[0] for r in rows if "assign" in r[2] or "reduce" in r[2]) / 1e3
            print(f"  K-means K=20, 12 iterations, {label}: {wall * 1e3:.2f} ms wall, "
                  f"{count / wall:.2f} images/s, {launches} kernel launches (host clock, numpy in "
                  f"and out; {self.card}); device busy {busy:.3f} ms in a profiled repeat, "
                  f"kmeans_assign {kernels:.3f} ms")
            if not self.rehearsal and launches != 13:
                raise AssertionError(f"{label}: {launches} launches, want 13")
            if not np.isfinite(quant).all() or quant.min() < 0 or quant.max() > 255:
                raise AssertionError(f"{label}: quantised values out of range")

    # -- phase 10 ----------------------------------------------------------
    def adam_inputs(self, shape, p_dtype, g_dtype, step, zero_state, seed):
        """(p, g, m, v, sched) on the card: g with every 7th entry 0, m and v
        zero or random (0 together where a row never had a gradient), sched
        = [3e-4, 1 - 0.9**step, 1 - 0.95**step] from the optimizer's own
        schedule code."""
        torch = self.torch
        from repro_torch.optim import AdamWConfig
        from repro_torch.optim.adamw import bias_corrections

        gen = self.gen(seed)
        p = torch.randn(shape, generator=gen, device=self.dev).to(p_dtype)
        g = (torch.randn(shape, generator=gen, device=self.dev) * 0.01).to(g_dtype)
        g.view(-1)[::7] = 0
        if zero_state:
            m = torch.zeros(shape, device=self.dev)
            v = torch.zeros(shape, device=self.dev)
        else:
            m = torch.randn(shape, generator=gen, device=self.dev) * 1e-3
            v = torch.rand(shape, generator=gen, device=self.dev) * 1e-5
            m.view(-1)[::11] = 0
            v.view(-1)[::11] = 0
        b1c, b2c = bias_corrections(AdamWConfig(), torch.tensor(step, device=self.dev))
        sched = torch.stack([torch.tensor(3e-4, device=self.dev), b1c, b2c]).contiguous()
        return p, g, m, v, sched

    def p10_adam(self):
        torch = self.torch
        from repro_torch.kernels.adam import ops, ref

        hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
        sizes = [(1,), (127,), (128,), (2560,), (4097,),
                 (256, 97) if self.rehearsal else (2560, 9728)]
        dtypes = (torch.float32, torch.bfloat16)
        n_cases = bad_cases = 0
        for shape, p_dt, g_dt, step, zero in itertools.product(sizes, dtypes, dtypes, (1, 2, 1000),
                                                               (True, False)):
            p, g, m, v, sched = self.adam_inputs(shape, p_dt, g_dt, step, zero, len(shape) + step)
            want = ref.ref_adam_update(p, g, m, v, sched, **hyper)
            runs = []
            for _ in range(2):  # the kernel twice, from the same inputs
                args = [t.clone() for t in (p, m, v)]
                ops.adam_update(args[0], g, args[1], args[2], sched, **hyper)
                runs.append(args)
            self.sync()
            diffs = []
            for i, name in enumerate("pmv"):
                ib = torch.int16 if runs[0][i].dtype == torch.bfloat16 else torch.int32
                bits = runs[0][i].view(ib)
                diffs.append(int((bits != want[i].view(ib)).sum()))
                diffs.append(int((bits != runs[1][i].view(ib)).sum()))
            n_cases += 1
            if any(diffs):
                bad_cases += 1
                print(f"  adam {shape} p {p_dt} g {g_dt} step {step} zero state {zero}: "
                      f"differing (vs plain, run to run) p {diffs[:2]} m {diffs[2:4]} "
                      f"v {diffs[4:]}")
        print(f"  adam: {n_cases} cases (sizes {[s for s in sizes]}, p and g in float32 and "
              f"bfloat16, steps 1/2/1000, m and v zero and random): {bad_cases} not bit-identical "
              f"to the plain version or from run to run")
        if bad_cases:
            raise AssertionError(f"adam: {bad_cases} of {n_cases} cases differ")
        self.rows["adam"]["max_abs_err"] = 0.0

    # -- phase 11 ----------------------------------------------------------
    def p11_train(self):
        from repro_torch.configs import get_config, get_smoke_config

        self.serving = self.gemma = None  # phases 4a's and 4d's serving models
        kw = dict(n_layers=8, sqrt_unit="e2afs", remat="block")
        if self.rehearsal:
            cfg, batch, seq = get_smoke_config("qwen3-4b", **kw), 2, 64
        else:
            cfg, batch, seq = get_config("qwen3-4b", **kw), 4, 2048
        self.train_phase(cfg, batch, seq, timed=4, compare_routes=True, launches_key="launches")

    def p11b_train_gemma(self):
        """gemma3-1b at full width and full depth (26 layers: 1.0 B float32
        parameters, 16 GB of p, g, m and v), its window layers on the banded
        chunks."""
        from repro_torch.configs import get_config, get_smoke_config

        kw = dict(sqrt_unit="e2afs", remat="block")
        if self.rehearsal:
            cfg, batch, seq = get_smoke_config("gemma3-1b", **kw), 2, 64
        else:
            cfg, batch, seq = get_config("gemma3-1b", **kw), 4, 2048
        self.train_phase(cfg, batch, seq, timed=2, compare_routes=False,
                         launches_key="gemma3_1b_launches")

    def p11c_train_mamba2(self):
        """mamba2-2.7b at full width and depth (64 SSD layers, 2.83 B float32
        parameters: 45 GB of p, g, m and v before activations)."""
        self.train_recurrent("mamba2-2.7b", "mamba2_2_7b_launches")

    def p11d_train_recurrentgemma(self):
        """recurrentgemma-2b at full width and depth (18 RG-LRU and 8 window
        layers, 2.89 B float32 parameters), the RG-LRU's sqrt on the
        e2afs_sqrt kernel under the backward pass."""
        self.train_recurrent("recurrentgemma-2b", "recurrentgemma_2b_launches")

    def train_recurrent(self, arch, launches_key):
        """Phase 11b's training run for a recurrent family, every
        constant-start leaf moved off its start (seed 1; a fresh RG-LRU block
        computes nothing), batch 4 x 2048, one warm-up and two timed steps."""
        from repro_torch.configs import get_config, get_smoke_config

        kw = dict(sqrt_unit="e2afs", remat="block")
        if self.rehearsal:
            cfg, batch, seq = get_smoke_config(arch, **kw), 2, 64
        else:
            cfg, batch, seq = get_config(arch, **kw), 4, 2048
        self.train_phase(cfg, batch, seq, timed=2, compare_routes=False,
                         launches_key=launches_key, move_constants=True)

    def train_launches(self, cfg):
        """(e2afs_rsqrt, e2afs_sqrt) launches of one training step, counted
        by block: an "ssd" layer has one norm, an "rglru" layer two and one
        sqrt, an attention layer two norms, its qk-norms two more, and in an
        encoder-decoder its lnx and its cross attention's qk-norms; an
        encoder layer two norms and its qk-norms.  Under block remat every
        layer's forward runs twice (again in the backward's recompute); the
        final norms (ln_f, enc_ln_f) run once.  The unit's kernel route has
        a plain-torch backward that launches nothing (ROADMAP C.14)."""
        qk = 2 * cfg.qk_norm
        cross = 1 + qk if cfg.kind == "encdec" else 0
        per_block = {"ssd": 1, "rglru": 2, "global": 2 + qk + cross, "window": 2 + qk + cross}
        remat = 2 if cfg.remat == "block" else 1
        rsqrt = remat * sum(per_block[b] for b in cfg.blocks) + 1
        if cfg.kind == "encdec":
            rsqrt += remat * (2 + qk) * cfg.encoder.n_layers + 1
        return rsqrt, remat * cfg.blocks.count("rglru")

    def train_phase(self, cfg, batch, seq, *, timed, compare_routes, launches_key,
                    move_constants=False, extra=None):
        """One warm-up step, then ``timed`` steps with the launch counts set
        to 0 just before and read just after (adam launches = parameter
        tensors x steps, kept in the adam row under ``launches_key``; the
        norms' e2afs_rsqrt and the RG-LRU's e2afs_sqrt by block, see
        :meth:`train_launches`); ms/step, tokens/s, peak memory, a profiled
        step's device-busy and adam shares and device time by kind; the loss
        finite and, on the first batch, lower after the steps.
        ``move_constants``: every constant-start leaf moved off its start
        first (seed 1).  ``extra(i)``: more entries of batch ``i`` (an
        encoder-decoder's audio frames).  ``compare_routes``: then one step's
        update on the kernel route bit-identical to the plain route's."""
        torch = self.torch
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.kernels import dispatch
        from repro_torch.launch.steps import loss_fn, make_train_step
        from repro_torch.models import lm
        from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm_clip

        self.free()
        # a fixed rate (the cosine over 10,000 steps barely moves in 6); the
        # rehearsal's tiny model needs a larger one to move in 6 steps
        lr = 3e-3 if self.rehearsal else 3e-4
        opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, fused=True, sqrt_unit="e2afs")
        t0 = time.perf_counter()
        model = lm.init(cfg, self.gen(0), device=self.dev, trainable=True)
        if move_constants:
            self.move_constant_starts(model, 1)
        opt = adamw_init(model)
        n_params, n_tensors = lm.param_count(model), len(list(model.parameters()))
        self.sync()
        print(f"  {cfg.name} at {cfg.n_layers} layers: d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab} -> "
              f"{cfg.padded_vocab}; {n_params / 1e9:.4f} B float32 parameters in {n_tensors} "
              f"tensors; {cfg.act_dtype} activations, sqrt {cfg.sqrt_unit}, remat {cfg.remat}; "
              f"batch {batch} x {seq}; init {time.perf_counter() - t0:.1f} s")
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))

        def batch_at(i):
            out = {k: torch.from_numpy(a).to(self.dev) for k, a in data.batch(i).items()}
            return dict(out, **extra(i)) if extra else out

        step_fn = make_train_step(cfg, opt_cfg)
        losses, lrs = [], []

        def step(i):
            nonlocal model, opt
            model, opt, metrics = step_fn(model, opt, batch_at(i))
            losses.append(float(metrics["loss"]))  # waits for the step
            lrs.append(float(metrics["lr"]))

        step(0)  # warm-up
        if not self.rehearsal:
            torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(1, 1 + timed):
            step(i)
        wall = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        peak = torch.cuda.max_memory_allocated() if not self.rehearsal else None
        self.rows["adam"][launches_key] = counts["adam"]
        ms = wall / timed * 1e3
        print(f"  main path launches over {timed} steps: {counts}")
        print(f"  losses {[round(x, 4) for x in losses]}; lr {lrs}")
        print(f"  {ms:.1f} ms/step, {batch * seq / (wall / timed):.1f} tokens/s, peak memory "
              f"{peak / 2**30 if peak is not None else float('nan'):.2f} GiB (host clock with "
              f"synchronize; {self.card})")
        if not self.rehearsal and counts["adam"] != n_tensors * timed:
            raise AssertionError(f"adam launches {counts['adam']}, want {n_tensors} x {timed}")
        # every norm of the forward runs its rsqrt on the e2afs kernel route
        # (and every RG-LRU its sqrt), and block remat runs each layer's
        # forward again in the backward
        rsqrt, sqrt = self.train_launches(cfg)
        want_rsqrt, want_sqrt = rsqrt * timed, sqrt * timed
        self.rows["e2afs_rsqrt"][f"train_{launches_key}"] = counts["e2afs_rsqrt"]
        if sqrt:
            self.rows["e2afs_sqrt"][f"train_{launches_key}"] = counts["e2afs_sqrt"]
        print(f"  e2afs_rsqrt launches of the unfused training norms: {counts['e2afs_rsqrt']} "
              f"(want {want_rsqrt}: {rsqrt} a step x {timed} steps); e2afs_sqrt of the "
              f"RG-LRUs: {counts['e2afs_sqrt']} (want {want_sqrt}: {sqrt} a step, none in the "
              f"backward)")
        if not self.rehearsal and (counts["e2afs_rsqrt"] != want_rsqrt or counts["rmsnorm"]
                                   or counts["e2afs_sqrt"] != want_sqrt):
            raise AssertionError(f"training launches {counts}, want {want_rsqrt} "
                                 f"e2afs_rsqrt, {want_sqrt} e2afs_sqrt and no rmsnorm")

        # a profiled step: device-busy share and the adam kernels' share
        _, rows = self.profiled(lambda: step(1 + timed), 1)
        busy = sum(r[0] for r in rows) / 1e3
        adam_ms = sum(r[0] for r in rows if "adam_kernel" in r[2]) / 1e3
        bound = n_params * ADAM_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3
        print(f"  profiled step: device busy {busy:.2f} ms = {busy / ms:.3f} of the unprofiled "
              f"step; adam kernels {adam_ms:.3f} ms ({adam_ms / max(busy, 1e-9):.4f} of busy; "
              f"bound {bound:.3f} ms for {n_params * ADAM_BYTES_PER_PARAM / 1e9:.2f} GB)")
        groups = {}
        matmul = ("gemm", "nvjet", "xmma", "cutlass")
        for dev_us, count, key in rows:
            low = key.lower()
            group = ("adam" if "adam_kernel" in low else
                     "matrix products" if any(t in low for t in matmul) else
                     "copies and casts" if "copy" in low else
                     "reductions" if "reduce" in low else "other elementwise")
            groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        print("  device ms by kind: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                   sorted(groups.items(), key=lambda kv: -kv[1])))
        for dev_us, count, key in rows[:14]:
            print(f"    {dev_us / 1e3:9.3f} ms  {count:6d} calls  {key[:160]}")
        # the first batch's loss again, after the steps: on the same
        # batch, the fall is not hidden by batch-to-batch noise
        with torch.no_grad():
            again = float(loss_fn(model, cfg, batch_at(0))[0])
        print(f"  loss on the first batch: {losses[0]:.4f} at step 1, {again:.4f} after "
              f"{len(losses)} steps")
        if not all(math.isfinite(x) for x in losses + [again]):
            raise AssertionError(f"non-finite loss: {losses}, {again}")
        if not again < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses[0]} -> {again}")
        self.training[cfg.name] = {"ms_per_step": ms, "tok_s": batch * seq / (wall / timed),
                                   "peak_gib": peak / 2**30 if peak is not None else None,
                                   "busy_ms": busy, "adam_ms": adam_ms, "device_ms": groups}
        if not compare_routes:
            return

        # one step's update on the kernel route against the same update on
        # the plain route, from the same parameters and gradients.  The
        # step's clip (shared code, no kernel) runs once; then each leaf is
        # updated on both routes, the plain one on a copy, so that only one
        # leaf's copy and the plain datapath's temporaries sit beside the
        # 25 GB of training state.
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        total, _ = loss_fn(model, cfg, batch_at(2 + timed))
        total.backward()
        grads = {n: p.grad for n, p in params.items()}
        global_norm_clip(grads, opt_cfg.clip_norm, opt_cfg.sqrt_unit)
        leaf_cfg = dataclasses.replace(opt_cfg, clip_norm=None)
        dispatch.reset_launch_counts()
        bad = []
        for n, p in params.items():
            with torch.no_grad():
                twin = [t.detach().clone() for t in (p, opt["m"][n], opt["v"][n])]
            adamw_update(leaf_cfg, {n: grads[n]},
                         {"m": {n: opt["m"][n]}, "v": {n: opt["v"][n]}, "step": opt["step"]},
                         {n: p})
            prev = dispatch.set_backend("reference")
            try:
                adamw_update(leaf_cfg, {n: grads[n]},
                             {"m": {n: twin[1]}, "v": {n: twin[2]}, "step": opt["step"]},
                             {n: twin[0]})
            finally:
                dispatch.set_backend(prev)
            for a, b in zip((p, opt["m"][n], opt["v"][n]), twin):
                if not torch.equal(a.detach().view(torch.int32), b.view(torch.int32)):
                    bad.append(n)
            del twin
        opt["step"] = opt["step"] + 1
        self.sync()
        print(f"  one step, kernel route vs plain route: {len(bad)} of {len(params)} parameter "
              f"tensors differ in p, m or v ({dispatch.launch_counts()['adam']} adam launches)")
        if bad:
            raise AssertionError(f"kernel and plain routes differ: {bad[:5]}")
        for p in params.values():
            p.grad = None

    # -- phase 21 ----------------------------------------------------------
    def p21_sharded_train(self):
        """Phase 11's training under ``train_rules`` on a one-device mesh
        (one NCCL rank, destroyed at the end) against the same two steps
        unsharded, one run after the other: the first run's p, m and v stay
        on the card (19 GB) beside the second run's state, gradients and
        activations, and are compared there."""
        import torch.distributed as dist

        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.distributed.sharding import (place_batch, place_train_state,
                                                      train_rules)
        from repro_torch.kernels import dispatch
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import lm
        from repro_torch.optim import AdamWConfig, adamw_init

        torch = self.torch
        kw = dict(n_layers=8, sqrt_unit="e2afs", remat="block")
        if self.rehearsal:
            cfg, batch, seq = get_smoke_config("qwen3-4b", **kw), 2, 64
        else:
            cfg, batch, seq = get_config("qwen3-4b", **kw), 4, 2048
        # phase 11's optimizer and data
        opt_cfg = AdamWConfig(lr=3e-3 if self.rehearsal else 3e-4, warmup_steps=1, fused=True,
                              sqrt_unit="e2afs")
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
        batches = [{k: torch.from_numpy(a).to(self.dev) for k, a in data.batch(i).items()}
                   for i in range(2)]

        def run(mesh):
            self.free()
            model = lm.init(cfg, self.gen(0), device=self.dev, trainable=True)
            rules, feed = None, batches
            if mesh is None:
                opt = adamw_init(model)
            else:
                rules = train_rules(cfg, mesh)
                model, opt = place_train_state(model, cfg, mesh, rules)
                feed = [place_batch(b, mesh, rules) for b in batches]  # the rank's rows
            step = make_train_step(cfg, opt_cfg, mesh=mesh, rules=rules)
            metrics, ms = [], []
            dispatch.reset_launch_counts()
            for b in feed:
                self.sync()
                t0 = time.perf_counter()
                model, opt, m = step(model, opt, b)
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: m[k].detach() for k in ("loss", "grad_norm")})
            counts = dispatch.launch_counts()
            state = {"params": {n: p.detach() for n, p in model.named_parameters()},
                     "m": opt["m"], "v": opt["v"], "step": opt["step"]}
            return metrics, counts, ms, state

        plain = run(None)
        try:
            mesh = make_production_mesh(shape=(1, 1), device=self.dev)
            print(f"  mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{dist.get_backend()}, world size {dist.get_world_size()} ({self.card})")
            sharded = run(mesh)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        n_tensors = len(plain[3]["params"])
        rsqrt, _ = self.train_launches(cfg)
        want = {"adam": n_tensors * 2, "e2afs_rsqrt": rsqrt * 2}
        for label, (metrics, counts, ms, _) in (("unsharded", plain), ("train_rules", sharded)):
            print(f"  {label}: losses {[float(m['loss']) for m in metrics]}, grad norms "
                  f"{[float(m['grad_norm']) for m in metrics]}, ms a step "
                  f"{[round(x, 1) for x in ms]}, launches { {k: v for k, v in counts.items() if v} }")
        ref_ms = self.training.get(cfg.name, {}).get("ms_per_step")
        print(f"  ms a step (the second): train_rules {sharded[2][1]:.1f}, unsharded "
              f"{plain[2][1]:.1f}, phase 11's {ref_ms if ref_ms is None else round(ref_ms, 1)} "
              f"(host clock with synchronize; {self.card})")
        same = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))  # noqa: E731
        bad = [f"{part}/{n}" for part in ("params", "m", "v") for n, t in plain[3][part].items()
               if not same(t, sharded[3][part][n])]
        same_metrics = all(same(a[k], b[k]) for a, b in zip(plain[0], sharded[0]) for k in a)
        print(f"  after 2 steps: {len(bad)} of {3 * n_tensors} leaves of params, m and v differ "
              f"from the unsharded step's; losses and grad norms "
              f"{'bit-identical' if same_metrics else 'DIFFER'}; steps "
              f"{int(plain[3]['step'])} / {int(sharded[3]['step'])}")
        del plain[3]["params"], sharded[3]["params"]
        self.rows["adam"]["mesh_train_launches"] = sharded[1]["adam"]
        self.rows["e2afs_rsqrt"]["mesh_train_launches"] = sharded[1]["e2afs_rsqrt"]
        self.training["mesh " + cfg.name] = {"ms_per_step": sharded[2][1],
                                             "unsharded_ms": plain[2][1]}
        if bad or not same_metrics:
            raise AssertionError(f"the one-device sharded step differs: {bad[:5]}")
        if sharded[1] != plain[1]:
            raise AssertionError(f"launches differ: {sharded[1]} vs {plain[1]}")
        if not self.rehearsal and any(sharded[1][k] != v for k, v in want.items()):
            raise AssertionError(f"launches {sharded[1]}, want {want}")

    # -- phase 20 ----------------------------------------------------------
    def p20_tooling(self):
        """The kernel registry's seven names; each tiled kernel's candidates
        at phase 5's shapes bit-identical to the default and timed, a sweep
        into a temporary tune cache and the cache hit after it, the prior's
        pick beside the winner and today's launch; then, in a subprocess,
        the dry run held against a real qwen3-4b decode step, and two
        production-size dry-run cells (:func:`tooling_child`).  Last, so the
        subprocess shares the card and the host with no timed phase."""
        torch = self.torch
        import tempfile

        from repro_torch.core import hw_model
        from repro_torch.kernels import dispatch, tuning
        from repro_torch.kernels.adam import ops as adam_ops
        from repro_torch.kernels.e2afs_sqrt import ops as e_ops
        from repro_torch.kernels.rmsnorm import ops as r_ops
        from repro_torch.kernels.sobel import ops as s_ops

        names = dispatch.registered()
        print(f"  registered: {names}; {dispatch.ENV_BACKEND}="
              f"{os.environ.get(dispatch.ENV_BACKEND)}")
        if names != tuple(sorted(dispatch.KNOWN)) or len(names) != 7:
            raise AssertionError(f"the registry holds {names}")
        chip = None if self.rehearsal else hw_model.chip_for_device(self.dev)
        g = self.gen(20)

        def inputs(name, shape, dtype):
            dt = getattr(torch, dtype)
            if self.rehearsal:
                shape = tuple(min(n, 64) for n in shape)
            if name.startswith("e2afs"):
                x = (torch.rand(shape, generator=g, device=self.dev) * 100).to(dt)
                x.view(-1)[:4] = torch.tensor([0.0, -1.0, float("inf"), float("nan")]).to(dt)
                return (x,), {}
            if name == "rmsnorm":
                x = torch.randn(shape, generator=g, device=self.dev).to(dt)
                return (x, (torch.randn(shape[-1:], generator=g, device=self.dev) * .1).to(dt)), {}
            if name == "sobel":
                return (torch.rand(shape, generator=g, device=self.dev) * 255,), {}
            p, gr, m = (torch.randn(shape, generator=g, device=self.dev) for _ in range(3))
            v = torch.rand(shape, generator=g, device=self.dev) * .01
            return (p, gr, m * .1, v, torch.tensor([1e-3, .5, .25], device=self.dev)), {}

        kernel = {"e2afs_sqrt": e_ops._sqrt, "e2afs_rsqrt": e_ops._rsqrt,
                  "rmsnorm": r_ops.rmsnorm, "sobel": s_ops.sobel_magnitude,
                  "adam": adam_ops.adam_update}

        def call(name, args, block=None, tune=None, copies=True):
            """The kernel's outputs; adam updates copies of p, m and v (or,
            to be timed, the operands themselves, ``copies=False``)."""
            if name == "adam" and copies:
                p, gr, m, v, sched = args
                return kernel[name](p.clone(), gr, m.clone(), v.clone(), sched, block=block,
                                    tune=tune)
            out = kernel[name](*args, block=block, tune=tune)
            return out if name == "adam" else (out,)

        def bits(ts):
            return [t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
                    for t in ts]

        tmp = tempfile.mkdtemp(prefix="tune-")
        saved = os.environ.get(tuning.ENV_CACHE)
        os.environ[tuning.ENV_CACHE] = os.path.join(tmp, "kernel_tune.json")
        self.tiles = {}
        try:
            for name, cases in TILE_SHAPES.items():
                spec = dispatch.get(name).tiling
                for shape, dtype in cases:
                    args, _ = inputs(name, shape, dtype)
                    label = f"{name} {dtype} {shape}"
                    want = bits(call(name, args, block=spec.default))
                    if self.rehearsal:  # no kernel: the plain version, every tile the same
                        print(f"  {label}: candidates {spec.candidates} (rehearsal)")
                        continue
                    times, events = {}, {}
                    for cand in spec.candidates:
                        got = bits(call(name, args, block=cand))
                        if not all(torch.equal(a, b) for a, b in zip(got, want)):
                            raise AssertionError(f"{label}: tile {cand} changes the bits")
                        timed = [t.clone() for t in args] if name == "adam" else args
                        # device time (the profiler): CUDA events around
                        # back-to-back calls of a microsecond kernel time the
                        # host's launches as much as the kernel
                        times[cand] = self.device_ms(
                            lambda c=cand: call(name, timed, block=c, copies=False))
                        events[cand] = self.time_ms(
                            lambda c=cand: call(name, timed, block=c, copies=False), iters=20)
                    prior, admissible = tuning.roofline_plan(
                        spec.candidates, spec.default, args, chip=chip, geometry=spec.geometry)
                    # today's launch: the default (RMSNorm's (0,): the rows a
                    # group its .cu source chooses from the SM count)
                    today = tuple(spec.default)
                    # a cache of this shape's own: shapes of one size bucket
                    # share a key, and each is swept here
                    os.environ[tuning.ENV_CACHE] = os.path.join(
                        tmp, f"tune-{len(self.tiles)}.json")
                    dispatch.forget_choices()
                    call(name, args)  # untuned, nothing cached: today's launch
                    untuned = dispatch.last_blocks()[name]
                    if untuned != today:
                        raise AssertionError(f"{label}: an untuned call launched {untuned}, "
                                             f"today's launch is {today}")
                    dispatch.forget_choices()
                    call(name, args, tune=True)  # the sweep, into the temporary cache
                    key = tuning.problem_key(name, args)
                    entry = json.loads(Path(os.environ[tuning.ENV_CACHE]).read_text())[
                        "entries"][key]
                    winner = tuple(entry["block"])
                    dispatch.forget_choices()
                    tuning._mem.clear()  # the next call reads the cache from disk

                    def no_sweep(*a, **k):
                        raise AssertionError("a sweep ran on a cache hit")

                    real_sweep, tuning.sweep = tuning.sweep, no_sweep
                    try:
                        call(name, args)
                    finally:
                        tuning.sweep = real_sweep
                    hit = dispatch.last_blocks()[name]
                    print(f"  {label}: device ms a call by tile (profiler, 20 calls) "
                          + ", ".join(f"{c} {t:.5f}" for c, t in times.items())
                          + "; CUDA events around 20 calls "
                          + ", ".join(f"{c} {t:.5f}" for c, t in events.items())
                          + f"; all bit-identical to {spec.default}; today's launch "
                          f"{today} (an untuned call's), roofline prior {prior} (admissible "
                          f"{admissible}), sweep winner {winner} "
                          f"({ {k: round(v, 2) for k, v in entry['timings_us'].items()} } us by "
                          f"the sweep's CUDA events), cache hit launched {hit}")
                    if hit != winner:
                        raise AssertionError(f"{label}: the cache hit launched {hit}, the "
                                             f"sweep's winner is {winner}")
                    self.tiles[label] = dict(times={str(c): t for c, t in times.items()},
                                             events={str(c): t for c, t in events.items()},
                                             prior=prior, winner=winner, today=today)
            if not self.rehearsal:  # the H100 model's step overhead, fitted from this run
                x, scale = inputs("rmsnorm", (8, 2560), "bfloat16")[0]
                t = self.device_ms(lambda: r_ops.rmsnorm(x, scale))
                moved = 2 * x.numel() * 2 + scale.numel() * 2
                fit = (t * 1e-3 - moved / hw_model.H100_SXM.hbm_bw) / 8
                print(f"  step overhead fitted from this run's (8, 2560) bf16 RMSNorm "
                      f"({t:.5f} ms device time, 8 blocks): {fit:.4g} s; the model's "
                      f"{hw_model.H100_SXM.step_overhead_s:.4g} s ({self.card})")
        finally:
            dispatch.forget_choices()
            if saved is None:
                os.environ.pop(tuning.ENV_CACHE, None)
            else:
                os.environ[tuning.ENV_CACHE] = saved

        self.free()  # the subprocess trains phase 11's model: return this process's cache
        tmp = tempfile.mkdtemp(prefix="tooling-")
        out_path, log = os.path.join(tmp, "tooling.json"), os.path.join(tmp, "tooling.log")
        env = dict(os.environ, PYTHONPATH=str(SRC) + (
            os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""))
        t0 = time.perf_counter()
        with open(log, "w") as sink:
            proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--tooling-child", out_path]
                + (["--cpu-rehearsal"] if self.rehearsal else []),
                env=env, stdout=sink, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for line in Path(log).read_text().splitlines()[-40:]:
            print(f"  | {line}")
        print(f"  the subprocess ended {time.perf_counter() - t0:.1f} s after its start")
        if proc.returncode != 0:
            raise AssertionError(f"the tooling subprocess failed (exit {proc.returncode})")
        res = json.loads(Path(out_path).read_text())
        real, dry = res["real"], res["dry"]
        ratio = dry["peak_bytes"] / real["peak_bytes"] if real["peak_bytes"] else None
        step_ratio = (dry["step_peak_bytes"] / real["step_peak_bytes"]
                      if real["step_peak_bytes"] else None)
        print(f"  qwen3-4b decode step, batch 8, cache 576: real op_cost flops "
              f"{real['flops']:.6g}, bytes "
              f"{real['bytes']:.6g}, launches {real['launches']}, peak "
              f"{real['peak_bytes']} (the step's increase {real['step_peak_bytes']}); dry run "
              f"flops {dry['flops']:.6g}, bytes {dry['bytes']:.6g}, launches {dry['launches']}, "
              f"peak {dry['peak_bytes']} (x{ratio if ratio is None else round(ratio, 4)} of "
              f"the real peak), less the arguments {dry['step_peak_bytes']} "
              f"(x{step_ratio if step_ratio is None else round(step_ratio, 4)} of the real "
              f"step's increase), lowered in {dry['seconds']:.1f} s")
        step_ms = self.engine_runs.get("engine_qwen3_4b_launches", {}).get("step_ms")
        print(f"  roofline memory_s {dry['roofline']['memory_s'] * 1e3:.5f} ms a step "
              f"(compute {dry['roofline']['compute_s'] * 1e3:.5f} ms) beside phase 13a's "
              f"replayed step {step_ms} ms ({self.card})")
        for name, rec in sorted(res["cells"].items()):
            r = rec.get("roofline", {})
            print(f"  dry-run cell {name}: {rec['status'][:80]}, {rec.get('n_chips')} chips, "
                  f"{rec.get('seconds')} s, peak {rec.get('memory', {}).get('peak_estimate_bytes')}"
                  f" B, dominant {r.get('dominant')}, compute {r.get('compute_s')} s, memory "
                  f"{r.get('memory_s')} s, collective {r.get('collective_s')} s, quantized_kv "
                  f"{rec.get('quantized_kv')}, launches {rec.get('launches')}")
        print(f"  CLI seconds: {res['cell_seconds']}")
        treal, tdry = res["train_real"], res["train_dry"]
        tratio = tdry["peak_bytes"] / treal["peak_bytes"] if treal["peak_bytes"] else None
        print(f"  qwen3-4b train step, 8 layers, batch 4 x 2048, fused AdamW: real op_cost "
              f"flops {treal['flops']:.6g}, bytes {treal['bytes']:.6g}, launches "
              f"{treal['launches']}, peak {treal['peak_bytes']} (the step's increase "
              f"{treal['step_peak_bytes']}); dry run under train_rules on one rank: flops "
              f"{tdry['flops']:.6g}, bytes {tdry['bytes']:.6g}, launches {tdry['launches']}, "
              f"peak {tdry['peak_bytes']} (x{tratio if tratio is None else round(tratio, 4)} of "
              f"the real peak), less the arguments {tdry['step_peak_bytes']}, collectives "
              f"{tdry['collectives']}, roofline {tdry['roofline']}, lowered in "
              f"{tdry['seconds']:.1f} s ({self.card})")
        self.dry = res
        if len(res["cells"]) != 3 or any(r["status"] != "ok" for r in res["cells"].values()):
            raise AssertionError("a production dry-run cell is not ok")
        if self.rehearsal:
            return
        if dry["flops"] != real["flops"]:
            raise AssertionError(f"dot flops {dry['flops']} (dry) != {real['flops']} (real)")
        if abs(dry["bytes"] - real["bytes"]) > DRY_BYTES_RTOL * real["bytes"]:
            raise AssertionError("bytes differ by more than 1%")
        if dry["launches"] != real["launches"]:
            raise AssertionError("the dry run's launches differ from the real step's")
        if not DRY_PEAK_RANGE[0] <= ratio <= DRY_PEAK_RANGE[1]:
            raise AssertionError(f"the dry run's peak is x{ratio:.3f} of the real step's")
        if not DRY_PEAK_RANGE[0] <= step_ratio <= DRY_PEAK_RANGE[1]:
            raise AssertionError(f"the dry run's step peak (less the arguments) is "
                                 f"x{step_ratio:.3f} of the real step's increase")
        if tdry["flops"] != treal["flops"] or tdry["launches"] != treal["launches"]:
            raise AssertionError("the dry train cell's flops or launches differ from the real "
                                 "step's")
        if abs(tratio - 1.0) > DRY_TRAIN_PEAK_RTOL:
            raise AssertionError(f"the dry train cell's peak is x{tratio:.4f} of the real step's")

    # -- phase 12 ----------------------------------------------------------
    def p12_resume(self):
        import tempfile

        import numpy as np

        from repro_torch.launch.train import train_loop

        kw = dict(steps=12, seq=32, batch=2, ckpt_every=6, log_every=1000, device=self.dev)
        with tempfile.TemporaryDirectory() as tmp:
            _, _, full = train_loop(ckpt_dir=f"{tmp}/full", **kw)
            train_loop(ckpt_dir=f"{tmp}/int", abort_after=6, **kw)
            _, _, resumed = train_loop(ckpt_dir=f"{tmp}/int", **kw)
        rel = abs(resumed[-1] - full[-1]) / abs(full[-1])
        print(f"  resume: uninterrupted last loss {full[-1]:.6f}, aborted at 6 and resumed "
              f"{resumed[-1]:.6f} ({len(resumed)} steps after the restart), relative diff "
              f"{rel:.2e} (limit 1e-4)")
        if len(resumed) != 6 or not rel <= 1e-4:
            raise AssertionError("resume is not exact")
        for label, extra in (("microbatches=2", dict(microbatches=2)),
                             ("compress=True", dict(compress=True))):
            _, _, losses = train_loop(steps=6, seq=32, batch=4, log_every=1000, device=self.dev,
                                      **extra)
            print(f"  {label}: losses {[round(x, 4) for x in losses]}")
            if len(losses) != 6 or not np.isfinite(losses).all():
                raise AssertionError(f"{label}: non-finite loss")


# -- phase 20: the kernel registry, tiles, the tune cache and the dry run ---
# tile checks run at phase 5's shapes (phase 4a's for the qk-norms)
TILE_SHAPES = {
    "e2afs_sqrt": [((8, 512, 2560), "float32"), ((8, 512, 2560), "bfloat16")],
    "e2afs_rsqrt": [((8, 512, 2560), "float32")],
    "rmsnorm": [((8, 2560), "bfloat16"), ((256, 128), "bfloat16"), ((65536, 256), "bfloat16"),
                ((131072, 128), "bfloat16")],
    "sobel": [((2160, 3840), "float32")],
    "adam": [((2560, 9728), "float32")],
}
# the dry run's peak against the real step's (the totals, and each less
# the arguments), and its bytes
DRY_PEAK_RANGE = (0.8, 1.25)
DRY_BYTES_RTOL = 0.01
# a train cell's peak against the real train step's
DRY_TRAIN_PEAK_RTOL = 0.05


def tooling_child(out_path: str, rehearsal: bool) -> int:
    """Phase 20's subprocess (its own: phase 19 holds a real process group).
    A decode step of phase 4a's qwen3-4b (SERVE_DEPTH's layers) at its
    shapes (batch 8, cache 576) on real
    tensors, counted by ``launch/op_cost.py``, and ``dryrun.lower_cell`` of
    the same step on fake tensors on a one-rank mesh; then the dry run's CLI
    at production size (qwen3-4b decode_32k on both meshes, mamba2-2.7b
    long_500k on one).  Writes its numbers to ``out_path`` as JSON."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm

    out = {}
    dev = torch.device("cpu" if rehearsal else "cuda")
    # phase 4a's config: SERVE_DEPTH's layers at full width
    over = dict(decode_kernel="fused") | ({} if rehearsal else
                                          {"n_layers": SERVE_DEPTH["qwen3-4b"]})
    cfg = (get_smoke_config if rehearsal else get_config)("qwen3-4b", sqrt_unit="e2afs", **over)
    batch, cache_len = (2, 40) if rehearsal else (8, 576)
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cache = lm.init_cache(cfg, batch, cache_len, device=dev)
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    step = make_serve_step(cfg)
    step(model, cache, tokens, cache_len - 1)  # warm-up: plans, handles, tiles
    base = None
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the arguments, and the warm-up's leftovers
    before = dispatch.launch_counts()
    _, real = op_cost.count(step, model, cache, tokens, cache_len - 1)
    peak = None
    if not rehearsal:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    out["real"] = dict(flops=real.flops, bytes=real.bytes, launches={
        k: n - before[k] for k, n in dispatch.launch_counts().items() if n != before[k]},
        peak_bytes=peak, step_peak_bytes=None if rehearsal else peak - base)
    del model, cache
    if not rehearsal:
        torch.cuda.empty_cache()

    # a train step at phase 11's shape (8 layers, batch 4 x 2048, block
    # remat, fused AdamW), counted on real tensors after a warm-up step
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    tcfg = (get_smoke_config if rehearsal else get_config)(
        "qwen3-4b", sqrt_unit="e2afs", n_layers=8, remat="block")
    tb, ts = (2, 64) if rehearsal else (4, 2048)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, fused=True, sqrt_unit="e2afs")
    model = lm.init(tcfg, torch.Generator(device=dev).manual_seed(0), device=dev, trainable=True)
    opt = adamw_init(model)
    data = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=ts, global_batch=tb, seed=0))
    tbatch = {k: torch.from_numpy(a).to(dev) for k, a in data.batch(0).items()}
    tbatch.setdefault("loss_mask", torch.ones(tbatch["labels"].shape, device=dev))
    train = make_train_step(tcfg, opt_cfg)
    train(model, opt, tbatch)  # warm-up
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    before = dispatch.launch_counts()
    _, treal = op_cost.count(train, model, opt, tbatch)
    tpeak = None
    if not rehearsal:
        torch.cuda.synchronize()
        tpeak = torch.cuda.max_memory_allocated()
    out["train_real"] = dict(flops=treal.flops, bytes=treal.bytes, launches={
        k: n - before[k] for k, n in dispatch.launch_counts().items() if n != before[k]},
        peak_bytes=tpeak, step_peak_bytes=None if rehearsal else tpeak - base)
    del model, opt, tbatch
    if not rehearsal:
        torch.cuda.empty_cache()

    dryrun._join_fake_group(512 if not rehearsal else 8)
    case = ShapeCase("decode_32k", cache_len, batch, "decode")
    t0 = time.perf_counter()
    rec = dryrun.lower_cell("qwen3-4b", "decode_32k", "single", mesh_shape=(1, 1), case=case,
                            smoke=rehearsal, extra_overrides=over)
    out["dry"] = dict(flops=rec["flops_per_device"], bytes=rec["bytes_per_device"],
                      launches=rec["launches"], peak_bytes=rec["memory"]["peak_estimate_bytes"],
                      step_peak_bytes=rec["memory"]["step_peak_bytes"],
                      roofline=rec["roofline"], seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rec = dryrun.lower_cell("qwen3-4b", "train_4k", "single", mesh_shape=(1, 1),
                            case=ShapeCase("train_4k", ts, tb, "train"), smoke=rehearsal,
                            extra_overrides=dict(n_layers=8, remat="block"), opt_cfg=opt_cfg)
    out["train_dry"] = dict(flops=rec["flops_per_device"], bytes=rec["bytes_per_device"],
                            launches=rec["launches"],
                            peak_bytes=rec["memory"]["peak_estimate_bytes"],
                            step_peak_bytes=rec["memory"]["step_peak_bytes"],
                            collectives=rec["collectives"], roofline=rec["roofline"],
                            seconds=time.perf_counter() - t0)
    cells = {}
    outdir = Path(out_path).with_suffix(".cells")
    for args in (["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh", "both"],
                 ["--arch", "mamba2-2.7b", "--shape", "long_500k", "--mesh", "single"]):
        t0 = time.perf_counter()
        dryrun.main(args + ["--out", str(outdir)] + (["--smoke"] if rehearsal else []))
        cells[" ".join(args)] = time.perf_counter() - t0
    out["cells"] = {path.stem: json.loads(path.read_text()) for path in outdir.glob("*.json")}
    out["cell_seconds"] = cells
    Path(out_path).write_text(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU with the plain versions at tiny sizes; "
                         "never prints the ok line")
    ap.add_argument("--tooling-child", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} is missing; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if args.tooling_child:
        return tooling_child(args.tooling_child, args.cpu_rehearsal)
    backend = os.environ.get("REPRO_KERNEL_BACKEND", "auto")
    if backend != "auto" or os.environ.get("REPRO_AUTOTUNE", "0").lower() not in (
            "0", "", "false", "off"):
        print(f"error: REPRO_KERNEL_BACKEND={backend!r}, REPRO_AUTOTUNE="
              f"{os.environ.get('REPRO_AUTOTUNE')!r}: the smoke run drives the kernels with "
              f"the tiles' priors; unset both", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import tempfile

    # a tune cache of this run's own, empty: every launch takes its prior
    # (phase 20 sweeps into one of its own)
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tempfile.mkdtemp(prefix="smoke-tune-"),
                                                  "kernel_tune.json")
    import torch

    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("error: no CUDA device; this smoke run needs the card "
              "(--cpu-rehearsal rehearses it on the CPU)", file=sys.stderr)
        return 2
    smoke = Smoke(args.cpu_rehearsal)
    smoke.phase("0 build", smoke.p0_build)
    smoke.phase("1 e2afs", smoke.p1_e2afs)
    smoke.phase("2 rmsnorm", smoke.p2_rmsnorm)
    smoke.phase("3 decode_attention", smoke.p3_attention)
    smoke.phase("4a serve qwen3-4b", smoke.p4_serve)
    smoke.phase("4b sqrt unit", smoke.p4_unit)
    smoke.phase("4c small model + serve.generate", smoke.p4_small)
    smoke.phase("4d serve gemma3-1b", smoke.p4_gemma)
    smoke.phase("5 times", smoke.p5_times)
    smoke.phase("6 profile", smoke.p6_profile)
    smoke.phase("13a engine qwen3-4b", smoke.p13a_engine)  # on phase 4a's model
    smoke.phase("13b engine gemma3-1b", smoke.p13b_engine_gemma)  # on phase 4d's model
    smoke.phase("14a fault datapath", smoke.p14a_fault_datapath)
    smoke.phase("14b ladder qwen3-4b", smoke.p14b_ladder)  # on phase 4a's model
    smoke.phase("14c faults qwen3-4b", smoke.p14c_faults)  # on phase 4a's model
    smoke.phase("15a detectors qwen3-4b", smoke.p15a_detectors)  # on phase 4a's model
    smoke.phase("15f SIGKILL smoke started", smoke.p15f_start)  # runs beside 15b
    smoke.phase("15b logit faults qwen3-4b", smoke.p15b_logit_faults)
    smoke.phase("15f SIGKILL smoke", smoke.p15f_sigkill)
    smoke.phase("15c faulted replay qwen3-4b", smoke.p15c_faulted_replay)  # 14c's engine
    smoke.phase("15d dispatch faults qwen3-4b", smoke.p15d_dispatch)
    smoke.phase("15e kill and resume qwen3-4b", smoke.p15e_kill_resume)
    smoke.phase("15g accuracy SLO qwen3-4b", smoke.p15g_slo)  # on phase 4a's model
    smoke.phase("15h speculative qwen3-4b", smoke.p15h_spec)  # on phase 4a's model
    smoke.phase("15i speculative gemma3-1b", smoke.p15i_spec_gemma)  # on phase 4d's model
    smoke.phase("16a serve starcoder2-15b", smoke.p16a_starcoder2)
    smoke.phase("16b serve mixtral-8x22b", smoke.p16b_mixtral)
    smoke.phase("16c serve qwen3-moe-235b-a22b", smoke.p16c_qwen3_moe)
    smoke.phase("16d forward internvl2-76b", smoke.p16d_internvl)
    smoke.phase("17a serve mamba2-2.7b", smoke.p17a_mamba2)
    smoke.phase("17b serve recurrentgemma-2b", smoke.p17b_recurrentgemma)
    smoke.phase("18a serve whisper-small", smoke.p18a_whisper_serve)
    smoke.phase("18b train whisper-small", smoke.p18b_whisper_train)
    smoke.phase("19 sharded serving, one-device mesh", smoke.p19_mesh)  # 4a's, 4d's, 13's
    smoke.phase("7 sobel", smoke.p7_sobel)
    smoke.phase("8 kmeans_assign", smoke.p8_kmeans)
    smoke.phase("9 paper", smoke.p9_paper)
    smoke.phase("10 adam", smoke.p10_adam)
    smoke.phase("11 train qwen3-4b", smoke.p11_train)
    smoke.phase("11b train gemma3-1b", smoke.p11b_train_gemma)
    smoke.phase("11c train mamba2-2.7b", smoke.p11c_train_mamba2)
    smoke.phase("11d train recurrentgemma-2b", smoke.p11d_train_recurrentgemma)
    smoke.phase("12 train_loop resume", smoke.p12_resume)
    smoke.phase("14d remat", smoke.p14d_remat)
    smoke.phase("20 tooling", smoke.p20_tooling)  # its subprocess beside no timed phase
    smoke.phase("21 sharded train qwen3-4b, one-device mesh", smoke.p21_sharded_train)
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(smoke.card)
    print(json.dumps({"kernels": list(smoke.rows.values())}))
    if args.cpu_rehearsal:
        print("rehearsal done (no result line without the card)")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
