#!/usr/bin/env python3
"""Chip check of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` and, on the card:

  1. prints the build time, the compiler's register/spill report and the
     card's name and power limit;
  2. holds the device cipher (``csrc/rng.cuh``) against the Random123
     known answers and against the host cipher on 1M random counters;
  3. holds ``mh_chain`` (the operand kernel, ``cim`` operands) against its
     plain version with tolerance 0, at V = 49,155 (granite-3 8B's vocab:
     the row is staged in shared memory) and V = 256,000 (minitron 4B's:
     the row is gathered from global memory);
  4. does the same for ``mh_chain_fused`` with a per-column step base;
     then holds both at the shapes the chain-tile design must get right:
     C = 1, ragged chain and step tiles, K = 0 and 1, nbits 1, 8, 16, 18
     and 32, V at, below and above the longest staged row, odd V with odd
     rows, cc < C with step bases wrapping past 2^31, B = 1, with a word
     past 2^31 in every case;
  5. holds ``gibbs_chain`` and ``gibbs_chain_fused`` (``csrc/gibbs.cu``,
     the band kernel under its two draws) against their plain versions
     with tolerance 0 on an odd 7 x 9 Ising lattice and a 6 x 8 spin
     glass, with a per-lattice parity and step base that differ between
     lattices; then ``gibbs_chain_fused`` on odd 5 x 7 and 3 x 5 lattices,
     at K = 1, on a spin glass cut into bands of several rows, past the
     flush of its uint8 flip counts (K = 300), and on 16 lattices of
     1024 x 1024 under lat_b = 4 (more than one cooperative launch), all
     with per-lattice step bases of mixed parity; then ``gibbs_chain`` at
     its timed shapes (``OPERAND_SHAPES``: 1024 x 1024 x 4 for both
     models, 256 x 256, odd 255 x 257, 16 lattices of 1024 x 1024 in two
     launches) with u off the cipher's 2^-24 grid and parities of both
     colours; each call must launch once per lattice group;
  6. drives the MH main path, ``engine.submit(RunPlan)`` on a (64, 49155)
     table with 256 chains per row, for ``cim`` and ``fused`` with the
     executor chosen by ``auto``, counting each kernel's launches, and
     checks acceptance, resume and a small input against the CPU path;
     then ``sample_tokens`` (one chain per row, C = 1) and
     ``num_chains=4`` for ``cim`` and ``fused`` (chains folded into
     C = 1024 columns).  Each of these paths records its first launch's
     operands, and the kernel is held against its plain version there;
  7. drives the Gibbs paths, ``workloads.build(...).run(key)`` through
     ``engine.submit(RunPlan)`` with ``backend="pallas"``: the main path,
     ``fused`` on 1024 x 1024 lattices (B = 4, beta = 0.4407, 1,024
     half-sweeps in 64-step chunks, ``thin:16``) for ``ising`` and
     ``spin_glass``; ``cim`` and ``host`` on a 256 x 256 Ising lattice
     (B = 1, 16-step chunks); ``host`` at the full width (1024 x 1024,
     B = 4, 64 half-sweeps in 16-step chunks, ``thin:16``: the operand
     kernel's main path); ``num_chains=4`` under ``fused`` (256 x 256,
     B = 2).  Each path's first launch is held against the plain version
     there; ``submit(513) + resume(511)`` must equal ``submit(1024)``, a
     small lattice must give the same result on the card and the CPU, and
     chain 2 of the 4-chain run must equal a solo run with
     ``chain_id=2``;
  8. holds ``msxor`` (``csrc/msxor.cu``, the MSXOR debias fold) against
     its plain version with tolerance 0, both outputs (words, uniforms),
     for n_stages 1-5 on odd M (777, 4,099), at the Fig. 9 shape
     (8, 400,000) and at (8, 2^24), on random bit patterns with bit 31
     set in half the words (and on their int32 patterns for odd M);
  9. drives the Fig. 9 path (``benchmarks/table_fig9_msxor.py:41-53``):
     ``bitcell.raw_random_words(PRNGKey(1), p, (8, 400,000))`` on the card
     for p = 0.40, 0.45, debiased by ``msxor_fold`` (the kernel), with the
     per-bit bias of the result (worst < 0.005, about 6 sigma), a
     (8, 4,096) draw held against the CPU's word for word;
 10. drives the macro (``core.macro.CIMMacro``): the quickstart
     (``examples/quickstart.py``: the paper GMM, 8 bits, burn-in 500,
     50,000 samples) and the Fig. 17 cases at 100,000 samples (GMM 8-bit,
     MGD 12-bit on (-4, 4)^2), with the TV distance to the exact grid
     probabilities, the acceptance rate, the card's wall time and the
     28 nm model's energy and time (model outputs, not the card's); and
     the macro at the JAX test's size on the card and the CPU, equal;
 11. drives the ``gmm`` workload (``workloads.build("gmm", ...,
     backend="pallas")`` at its defaults: 64 chains, 2,048 steps, 32-step
     chunks) under ``cim`` and ``fused``, counting the MH kernels'
     launches, holding the first launch against the plain version, and a
     smoke-size run on the card against the CPU;
 12. times each kernel with CUDA events beside its plain version and its
     two bounds, at every shape above (``msxor`` with its input read from
     HBM: the launches rotate among copies that together exceed the L2;
     every kernel also by the profiler's device time, the Gibbs ones with
     their launches a call), the MH kernels' row staging alone (K = 0),
     checks that the MH wrappers put no device kernel or copy but
     ``mh_chain_kernel`` in the profiler's trace, exactly one a call, times
     ``sample_tokens``, and profiles one segment of each main path (the
     whole Gibbs ``fused`` and full-width ``host`` paths, the MH ``fused``
     path at 4 and 16 chunks, which must make the same host-to-device
     copies: none in the chunk loop);
 13. reads the instruction mix of the band kernel's per-site loops from
     the library's SASS (``cuobjdump``) and the issue-limited time it
     sets at the main shape.

Phases 14-19 run between 11 and 12, so that the kernel records of 12
count their launches:

 14. ``kernel_entry_points`` (B = 64, V = 49,155, C = 256, K = 64):
     ``mh_sample_with_rng`` (one ``mh_chain`` launch) equals ``mh_sample``
     on ``generate_randomness``'s block (32-bit flips and uniforms) and
     the plain version; ``sample_tokens_fused`` equals
     ``engine.sample_tokens`` with ``execution="pallas"``;
 15. ``resume_mh``: ``run_resumable`` on the MH main path (1,024 steps,
     ``thin:64``, a checkpoint every 256 steps) under ``fused`` and
     ``cim``, once whole under telemetry (bytes and seconds per save) and
     once killed after its second save and finished by a second call;
     both equal one unsegmented submit at tolerance 0; the wall time of
     each beside the submit's;
 16. ``resume_gibbs``: the same for ``ising`` 1024 x 1024 x 4 under
     ``fused`` (1,024 half-sweeps, ``thin:256``) against ``wl.run``;
 17. ``checkpoint_roundtrip``: ``RunHandle.save``, then
     ``load_checkpoint_tree`` and ``load_checkpoint(device=)`` give back
     the handle's arrays; a corrupted leaf is refused on ``verify=True``;
     a plan with another key is refused by its fingerprint;
 18. ``telemetry``: the ``fused`` main path with telemetry on and off
     gives the same words, a traced submit does not wait for the card and
     records one ``engine.submit`` span, submits are timed with the
     tracer off and on in turns, the exported JSONL trace validates, and
     the counters ``checkpoint_saves_total`` and ``resume_segments_total``
     equal the saves made;
 19. ``chains_mesh``: a one-rank ``nccl`` ``DeviceMesh`` on the card
     shards MH ``fused`` with ``num_chains=4`` (C = 1,024 columns), equal
     to the unsharded run word for word; ``make_chains_mesh()`` is None
     on one card.

Phase 38 runs right after 19:

 38. ``compiled_submit``: ``engine.submit(plan, compiled=True)`` (a CUDA
     graph captured once per signature, then replayed) on MH ``cim`` and
     ``fused`` at the main path's shape, Gibbs ``fused`` on ``ising``
     1024 x 1024 x 4 and phase 19's one-rank ``nccl`` chains mesh: one
     direct submit, three compiled ones (the third on another key, the
     same signature) and a direct one on that key.  The ``jit_cache``
     verdicts are ``miss, hit, hit``; every compiled result equals its
     direct one bit for bit and the first two are unchanged after the
     third; the kernel's launch count is the same on both paths; a replay
     under the profiler makes one ``cudaGraphLaunch`` and no kernel-launch
     call.  It prints the direct, capture and replay seconds, both busy
     shares, the bytes the program holds, and the bytes left once the
     engines are dropped.

Phases 20-23 (tempering and serving) run between 19 and 12 as well:

 20. ``tempering_gibbs``: ``ReplicaExchange`` on the ``spin_glass``
     workload at 1024 x 1024 x 4 (``fused``, ``pallas``), 8 replicas of
     ``Ladder.geometric(8, 0.25, 1.0)``, 256 half-sweeps, swaps every 16,
     ``thin:64``: one band launch per replica segment, the first scaled
     launch held against its plain version, the busy share under the
     profiler, a 1-replica ladder against a plain submit; tempered
     256 x 256 runs hold the other (draw, logit) pairs' first scaled
     launch; the scaled and unscaled band kernels on the same operands at
     1024 x 1024 x 4, K = 16 (timed in 12);
 21. ``tempering_mh``: 4 replicas on the MH main path's table (1,024
     steps, swaps every 64, ``fused``), its first scaled launch held, a
     1-replica ladder against a plain submit; a reduced exchange (32 x 32
     spin glass, a (4, 300) table; 4 replicas, 64 steps) on the card
     against the CPU port, the CPU run asserted free of tie events;
 22. ``anneal``: ``Annealer.geometric(8, 32, 0.25, 4.0)`` on the glass
     (the best energy), and a 4 x 4 glass against its exhaustive ground
     state;
 23. ``serving``: a ``Scheduler`` (4 slots, ``fused``, ``pallas``)
     serving 12 ``gmm`` requests at their defaults and 8 ``ising``
     requests at 1024 x 1024 x 2 (256-480 half-sweeps, ``thin:64``) with
     staggered arrivals: one kernel launch per chunk and class, every
     request equal to its solo run on the card, slots reused; warm bursts
     with the port's pinned ``non_blocking`` retirement copies and with a
     blocking copy, in turns; then a ``cim`` class at smoke size.  Each
     chunk of a kernel class is a replay of its ``(seg, collect)``
     program (a CUDA graph; the first call of a signature captures it);
 41. ``compiled_serving``: the ``serving`` phase's ``fused`` burst and
     its ``cim`` burst, each served cold and warm through the classes'
     programs and through each advance's eager body (set in place of
     the advance by the phase, not a user's switch), one scheduler a
     path, the paths in turns: every request equal on both paths and to its solo
     run at tolerance 0, one kernel launch a chunk and class, a class's
     programs its distinct ``(seg, collect)``, a replay at step bases
     other than its capture's after a mid-flight join; burst and
     per-chunk host seconds, capture seconds and bytes a program, and two
     traced chunks of each class on each path, in turns (graph launches,
     kernel-launch calls, the card's busy share).

Phases 24-28 (the autotuner, the CLIs, the serving mesh) run after 23,
and phase 42 right after 28:

 24. ``autotune_mh``: ``samplers.autotune_config`` on the MH main path
     (B = 64, V = 49,155, C = 256, ``fused``, ``execution="auto"``: scan
     and the kernel in the grid), with a fresh cache; each candidate's
     rate, the tuner's seconds and the device bytes left once its
     engines (and their captured graphs) are gone; a second call must hit the cache with
     an equal config; the tuned engine's 1,024-step stream must equal the
     incumbent's;
 25. ``autotune_gibbs``: the same for ``ising`` 1024 x 1024 x 4 under
     ``fused`` with ``backend="pallas"`` (the band kernel, chunks 16, 32,
     64, 256), the stream ``thin:16``;
 26. ``cli_sample``: ``repro_torch.launch.sample.main`` in this process on
     ``ising`` 1024 x 1024 x 4 (``fused`` and ``host``, 1,024 steps,
     ``--thin 16``), ``gmm`` at its defaults (``fused``, ``cim``), the
     spin glass at 1024 x 1024 x 4 under ``--ladder 8`` (64 steps: the CLI
     keeps every replica's rows) and ``--anneal 8`` (256 steps),
     ``--autotune`` and ``--trace`` (validated by ``launch.monitor``);
 27. ``cli_serve_engine``: ``serve_engine.main`` on a ``gmm,ising`` burst
     at the workloads' defaults (12 requests, 4 slots, ``pallas``,
     ``fused``, Poisson arrivals at 200/s), printing its footer row;
 28. ``serving_mesh``: a ``Scheduler(execution="scan")`` on a one-rank
     ``nccl`` ``DeviceMesh`` serves a mixed burst at the serving phase's
     shapes (4 ``gmm`` requests of 512 steps at their default widths, 2
     ``ising`` requests of 256 steps at 1024 x 1024 x 2, one shape class)
     equal to the unsharded one request for request, each chunk a replay
     of its ``(seg, collect)`` program with the all-gather inside, then
     both are timed warm in turns; under ``pallas`` the mesh is refused;
 42. ``compiled_scan``: the scan-side programs against their twins.
     Serving: phase 28's burst (``fused``, full width) and phase 23's
     ``cim`` smoke burst on one 4-slot ``gmm`` + ``ising`` scan class,
     cold and warm through the class's programs and through its
     advance's eager body, in turns: every request equal on both paths
     and to its solo scan run at tolerance 0, one program a ``(seg,
     collect)`` captured once, cut into a graph for every slot's every
     member (a section) of which a chunk replays the occupied slots'
     own, replays at other step bases and slot layouts after a
     mid-flight join, two traced chunks a path.  Tempering: a
     ``ReplicaExchange`` under scan (8 replicas, ``Ladder.geometric(8,
     0.25, 1.0)``, 16-step segments, 64 steps) on the spin glass at
     1024 x 1024 x 4 (``collect="last"``) and at 64 x 64 (``"all"``), and
     a 4-replica ``TableTarget`` MH ladder (``"all"``), through the
     segment programs and through direct submits, cold and warm: every
     run equal to its twin, one program a replica and segment length.
     It prints host seconds a chunk or segment, kernel-launch calls and
     the busy share of traced chunks and runs, and each program's
     capture seconds, node count and bytes held.

Each path of 24-27 counts its launches from 0 and holds each kernel's
first launch there against its plain version (tolerance 0).

Phase 29 (the LLM server, ``launch/serve.py``) runs after 28:

 29. ``serve_lm``: granite-3 8B at full width and depth (40 layers,
     d_model 4,096, bfloat16, V = 49,155) through
     ``launch/serve.py:main`` (8 requests, 4 slots, prompts of 128-130
     tokens, 32 generated, ``--sampler mcmc``, ``--backend auto``): one
     ``mh_chain`` launch per sample (8 admissions and every decode step),
     the first held against its plain version (tolerance 0), tokens/s and
     acceptance; the same burst under ``greedy`` and ``categorical``; a
     server built here, its parameter bytes and peak memory, prefill and,
     step by step, the model's and the sampler's milliseconds beside the
     step's bound, and one decode step's device busy share and kernel
     count under the profiler; the head's bfloat16 product against the
     widened one; then the model cut to 2 layers in float32, made on the
     CPU and copied to the card: prefill and 3 greedy decode steps at
     B = 2 with prompts of 12 and 17 tokens, card against CPU (logits
     within ``LLM_LOGIT_TOL``, tokens equal where the top-two gap exceeds
     the difference) and packed against solo on the card.

Phases 30-32 (the MoE, SSM and hybrid families, ``launch/serve.py``) run
after 29, each with phase 29's burst through ``launch/serve.py:main`` at
full width and depth (qwen3's depth cut) in bfloat16 (8 requests, 4 slots, prompts of 128-130
tokens, 32 generated), the previous model freed first.  Every prefill,
decode step and sample of a burst is timed between two synchronisations:
tokens/s, samples and ``mh_chain`` launches (equal under ``mcmc``, the
first held against its plain version at tolerance 0 and timed in 12),
acceptance, prefill ms, the model's and ``_sample``'s ms a step beside
the step's bytes bound, peak memory.  Then the model cut to 2 layers in
float32, made on the card and copied to the CPU, card against CPU
(logits within ``LLM_LOGIT_TOL``, greedy tokens equal where the top-two
gap exceeds the difference, the same experts chosen):

 30. ``serve_lm_moe``: qwen3-moe-30b-a3b (cut to 12 of its 48 layers,
     ``DEPTH_CUTS``; d_model 2,048, 128
     experts top-8, V = 151,936: ``mh_chain`` gathers its row) under
     ``mcmc`` and ``greedy``, with each prefill's capacity drops and the
     experts each decode step's layers use, and the step's bound if only
     those experts were read; the cut on prompts of 12 and 17 tokens,
     packed against solo on the card too;
 31. ``serve_lm_ssm``: mamba2-1.3b under ``mcmc``; the cut on one prompt
     of 130 tokens, one chunk of the SSD whose accumulated decay passes
     ~88 (where the reference's unmasked exponent overflows): finite
     logits, and a full-width layer's chunked output against its step
     recurrence on the card within ``SSM_LAYER_RTOL``;
 32. ``serve_lm_hybrid``: hymba-1.5b under ``mcmc``, and the same
     130-token check.

Phases 33-35 (the VLM and audio families, and training) run after 32,
each at full width and depth in bfloat16 with random weights from a seed:

 33. ``serve_lm_vlm``: phi-3-vision-4.2b (32 layers, d_model 3,072, 576
     image tokens before each prompt, V = 32,064).  ``launch/serve.py:main``
     at this width must raise on its first prefill (its cache, prompt + 2
     + gen + 8 rows, leaves out the image tokens, as the reference's
     does); then phase 29's burst through a ``BatchedServer`` whose cache
     holds 576 + 130 + 32 + 8 rows, under ``mcmc`` and ``greedy``, with
     phase 30's numbers; the cut (2 layers, float32) card against CPU and
     float64 on prompts of 12 and 17 tokens after seeded patch
     embeddings, packed against solo;
 34. ``serve_lm_audio``: whisper-large-v3 (32 encoder layers over 1,500
     frames, 32 decoder layers with cross-attention, V = 51,866) through
     ``launch/serve.py:main``, the same numbers and the cross cache's
     bytes; the cut (2 + 2 layers) on seeded frames, held in float64 on
     the card against float64 on the CPU and packed against solo
     (``AUDIO_F64_TOL``), its float32 run reported;
 35. ``train_lm``: ``launch/train.py:main --arch hymba_1p5b --steps 6
     --batch 8 --seq 1024 --n-micro 2`` (Markov data; each block
     recomputed in the backward pass): per step the loss, the gradient
     norm and the synchronised seconds beside the step's FLOP bound, peak
     memory, every loss, gradient norm and parameter finite; then
     ``make_decode_sample_step`` on the trained weights, its ``mh_chain``
     launch held against its plain version (tolerance 0); then the model
     cut to 2 layers in float32 trains 2 AdamW steps on the card and on
     the CPU from the same weights and batches: losses, gradient norms
     and parameters within the tolerances stated beside
     ``TRAIN_LOSS_TOL``.  The launcher's steps are its compiled program
     (one capture, then replays): the first step's seconds are the
     capture's;
 40. ``compiled_train``: ``run_training``'s step (``train.compiled_step``)
     on each of ``CT_CASES`` (hymba-1.5b at phase 35's shape; qwen3-moe
     cut to 2 layers at full width, 2 x 256 tokens, its routing captured):
     from one state saved to pinned host memory, ``CT_STEPS`` eager steps,
     the state restored in place, ``CT_STEPS`` compiled steps; every
     step's metrics and a bitwise digest of the state after it, and the
     whole state (parameters, moments, step) at the end, equal the eager
     twin's at tolerance 0; a replayed step makes one ``cudaGraphLaunch``
     and calls neither ``lm.train_loss`` nor ``adamw_update`` from the
     host.  It prints both paths' step seconds, the capture's seconds,
     the bytes the program holds, graph launches and kernel-launch calls
     a step and the busy share (profiler) beside the FLOP and state-bytes
     bounds, and the optimizer's share of an eager step.

 36. ``mesh_lm``: the distributed layer on a one-rank ``nccl`` DeviceMesh
     ("pod", "data", "model") of shape (1, 1, 1): (a) hymba-1.5b at full
     width and depth trains ``MESH_STEPS`` compressed-pod steps
     (``make_train_step(compress_pods=True, mesh=...)``, ZeRO axes, phase
     35's batch), each leaf's reduced gradient and new error state held
     against the plain one-pod ``compressed_mean_one_pod`` on the same
     gradients (tolerance 0), the pod all-reduce's payload int32 words and
     float32 scales, losses finite; the steps' seconds, the payload, the
     error state's bytes and the peak; (b) granite-3 8B at full width cut
     to 2 layers under ``rules_for_config``: ``train_loss``, a prefill and
     a decode step with the cache sharded over its sequence, each equal
     to the same call without a mesh (tolerance 0); (c) ``moe_ffn_ep`` at
     one qwen3-moe-30b layer's full width against ``moe_ffn_local``,
     forward and gradients (tolerance 0); (d) ``make_decode_sample_step``
     on (a)'s model under the mesh: one ``mh_chain`` launch, held against
     its plain version (tolerance 0).
 37. ``dryrun``: the multi-pod dry run (``repro_torch.launch.dryrun``) in
     child processes started after the build, so that its fake process
     groups and fake tensors never meet this process's real ones: (a) the
     CLI on the production meshes, ``--arch granite3_8b --shape
     decode_32k --decode-sample`` on 256 fake ranks as 16 x 16 and as 32
     x 8 (``--mesh 32x8``: granite's 8 KV heads divide 8 model ranks
     there, not 16), which must reach the MH operator
     ``repro_torch::mh_chain``'s fake implementation, and ``--multi-pod
     --compress-pods --arch hymba_1p5b --shape train_4k`` on 512 (2 x 16
     x 16), each report ``ok`` with its FLOPs, bytes, collective bytes by
     kind, argument and peak GB per device, trace seconds, max RSS and
     roofline terms; the decode-sample cells are printed beside the JAX
     package's counts of the same cells (``DRYRUN_JAX``: counts, not
     times) and must hold its plan: FLOPs equal within 1e-9 relative,
     all-gather bytes under ``DRYRUN_MAX_ALL_GATHER`` (the embedding
     table's shard alone is 2.5e7 and 5.1e7 bytes), no all-gather whose
     operand is made from a parameter (``collective_ops``' fourth
     field) and collective bytes at most ``DRYRUN_MAX_COLLECTIVE_RATIO``
     times JAX's; the 16 x 16 cell traced again with ``--device cpu``
     (``DRYRUN_CPU_TWIN``) must give the card's FLOPs and collective
     bytes, kind by kind (the plan does not depend on the device); (b)
     the train step
     of phase 35 (8 x 1,024 tokens, 2 microbatches) and the decode step of
     phase 29 (B = 4) on a 1 x 1 fake mesh against what those phases
     measured: the parameters' and AdamW state's bytes equal the real
     tensors' (tolerance 0); the FLOPs against the FLOP formula of phases
     35 and 29, the peak against phase 35's measured peak and the roofline
     terms against the measured step times are printed.

Each phase prints one JSON line; any failure raises and exits non-zero.
The second-to-last line lists the kernels; the last line is the device
record.  Without a CUDA device, or without the repository around it, it
exits non-zero and prints no result.
"""

import atexit
import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit non-tensor peak of the H100 SXM data sheet (67 TFLOP/s float32),
# taken for 32-bit integer operations too: no lower bound is looser
ALU_OPS_PER_S = 67e12
# 32-bit integer add, bitwise and shift results per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions"
# throughput table), on the integer ALU
INT_OPS_PER_CLOCK_PER_SM = 64
# Results per clock per SM of the other units a warp scheduler feeds on
# compute capability 9.0: the multiply-add unit, which also takes integer
# adds and shifts issued as IMAD, and the four schedulers' issue slots
# (one warp instruction a clock each).  int_bound_ms is the larger of the
# operations only the ALU does (logic, rotates, compares, selects) over
# its rate and all integer operations over both units' rates, times the
# SMs and the card's maximum SM clock (nvidia-smi clocks.max.sm)
FMA_OPS_PER_CLOCK_PER_SM = 64
ISSUE_PER_CLOCK_PER_SM = 128
# Threefry-2x32-20 block: key schedule 2, initial adds 2, 20 rounds of
# add/rotate/xor, 5 key injections of 3 adds
THREEFRY_OPS = 2 + 2 + 20 * 3 + 5 * 3
THREEFRY_ALU_OPS = 1 + 20 * 2  # of which ALU only: k0 ^ k1 ^ parity, rotates, XORs
# the same block where only x0 is kept and the key and salt word are the
# same for every site of a half-sweep (the band kernel's draw): the counter
# add; round 1's add and xor (x1's rotate is common); rounds 2-19; round
# 20's add (its x1 is not used); 4 key injections of 2 adds (the constant
# folded into the key word) and the last one's add to x0
THREEFRY_SITE_OPS = 1 + 2 + 18 * 3 + 1 + 4 * 2 + 1
THREEFRY_SITE_ALU_OPS = 1 + 18 * 2  # round 1's XOR, rounds 2-19's rotates and XORs
KEY_SCHEDULE_OPS, KEY_SCHEDULE_ALU_OPS = 2, 1  # of THREEFRY_OPS: k0 ^ k1 ^ parity
FLIP_PLANE_OPS = 3  # a flip bit-plane's compare, shift and OR, all ALU
STEP_OPS = 20  # XOR-propose, lookup, subtract, exp, compares, selects, count
STEP_FP_OPS = 6  # of which float: the subtract, min, exp, flush, u < e, isfinite
STEP_ALU_OPS = 12  # and of the integer ones all but the lookup's address and the count
# one active Gibbs site of the operand kernel: four neighbour spins and
# sums, the logit, 1/(1+exp), the compare, select and flip count
GIBBS_OPS = 20
GIBBS_FP_OPS = 18  # of which float: all but the select and the flip count
GIBBS_ALU_OPS = 1  # the select
# one active site of the band kernel beside its draw (integer): the shift
# to 24 bits, the neighbour count (3 adds), the threshold compare, the
# flip test and count
BAND_SITE_INT_OPS = 7
BAND_SITE_ALU_OPS = 3  # of which ALU only: the shift, the compare, the flip test
# and the spin glass's float work a site: four spins (2 each), four
# products, four sums, the doubling, the sigmoid (negate, exp, add,
# divide) and the threshold (scale, ceil, convert)
GLASS_SITE_FP_OPS = 8 + 4 + 4 + 1 + 4 + 3

B, V, C, K = 64, 49_155, 256, 64        # granite-3 8B vocab, phase 3-5 shape
B_WIDE, V_WIDE, NBITS_WIDE = 8, 256_000, 18  # minitron 4B vocab
N_STEPS = 1024
SEED = 2024

LAT, LAT_B, G_CHUNK, G_THIN = 1024, 4, 64, "thin:16"  # the Gibbs main path
OP_LAT, OP_CHUNK, OP_STEPS = 256, 16, 256             # cim / host Gibbs paths
HOST_FULL_STEPS = 64  # the full-width host path: LAT x LAT x LAT_B, OP_CHUNK chunks
# the operand kernel's timed shapes: (where, B, H, W, K, spin glass)
OPERAND_SHAPES = (
    ("1024x1024 B=4 K=16 ising", LAT_B, LAT, LAT, OP_CHUNK, False),
    ("1024x1024 B=4 K=16 spin glass", LAT_B, LAT, LAT, OP_CHUNK, True),
    ("256x256 B=1 K=16 ising", 1, OP_LAT, OP_LAT, OP_CHUNK, False),
    ("255x257 B=2 K=16 ising (odd periodic)", 2, 255, 257, OP_CHUNK, False),
    ("1024x1024 B=16 K=4 ising (two groups)", 16, LAT, LAT, 4, False),
)
MC_LAT, MC_B, MC_CHAINS = 256, 2, 4                   # num_chains=4 Gibbs path
BETA = 0.4407  # the 2-D Ising critical coupling
FIG9_M, BIG_M = 400_000, 1 << 24  # the Fig. 9 draw's columns, a size past the L2
# bytes of inputs among which a timed kernel rotates, 4x the H100's 50 MB
# L2, so that each launch reads its input from HBM as its bound assumes
COLD_BYTES = 200e6
FIG17_N = 100_000  # benchmarks/table_fig17_sampling.py:N_SAMPLES
RESUME_THIN, RESUME_EVERY = "thin:64", 256       # the resumable MH runs (N_STEPS steps)
G_RESUME_THIN, G_RESUME_EVERY = "thin:256", 256  # the resumable Gibbs run
TELEMETRY_REPS = 15  # fused MH submits timed with telemetry off and on, in turns
# replica exchange on the full-width spin glass (LAT x LAT x LAT_B, fused)
T_REPLICAS, T_STEPS, T_SWAP, T_THIN = 8, 256, 16, "thin:64"
T_SCALE = 0.25 ** (2 / 7)  # beta of replica 2 of the exchange's Ladder.geometric(8, 0.25, 1.0)
T_MH_REPLICAS, T_MH_SWAP, T_MH_THIN = 4, 64, "thin:64"  # on the MH main path's table
# the serving burst: gmm at its defaults, ising at LAT x LAT with S_BATCH
# lattices a request, so that 4 slots' lattices fit one cooperative launch
S_GMM, S_ISING, S_BATCH = 12, 8, 2
# the tuner on the MH main path: the JAX defaults (256 steps, best of 3)
TUNE_MH_STEPS, TUNE_MH_REPEATS = 256, 3
CLI_LADDER_STEPS = 64  # the sample CLI's ladder: 8 replicas x 1024 x 1024 x 4, all rows kept
# the mesh burst under scan: the serving burst's shapes with fewer requests
# and steps (scan runs ~1 ms of host-driven torch ops a step: 4 gmm requests
# of 2,048 steps took 9-12 s a burst on the H100); one warm pair in turns
M_GMM, M_GMM_STEPS, M_ISING, M_ISING_STEPS, MESH_TURNS = 4, 512, 2, 256, 1
# tempering under scan through its segment programs (phase 42): the spin
# glass at LAT x LAT x LAT_B with collect "last" ("all" would keep 16 GiB of
# rows), a SCAN_T_SMALL lattice with "all", and a TableTarget MH ladder
SCAN_T_REPLICAS, SCAN_T_STEPS, SCAN_T_SWAP, SCAN_T_SMALL = 8, 64, 16, 64
SCAN_MH_B, SCAN_MH_V, SCAN_MH_C = 16, 4096, 64
# the LLM server: granite-3 8B at full width and depth (bfloat16) through
# launch/serve.py:main; then decode steps timed one by one
LLM_ARCH, LLM_REQUESTS, LLM_SLOTS, LLM_PROMPT, LLM_GEN = "granite3_8b", 8, 4, 128, 32
LLM_TIMED_STEPS = 16
BF16_OPS_PER_S = 989e12  # H100 SXM dense bfloat16 tensor-core peak
# card against CPU: the same model cut to 2 layers in float32, B = 2
# prompts of these lengths, 3 greedy decode steps; logits (about N(0, 1)
# under the init rule) within LLM_LOGIT_TOL, stated before the first run
LLM_CHECK_LAYERS, LLM_CHECK_LENS, LLM_CHECK_STEPS, LLM_LOGIT_TOL = 2, (12, 17), 3, 1e-3
# the head's bfloat16 product with float32 results (torch.mm's out_dtype)
# against the widened float32 product, relative to the largest logit
LLM_HEAD_RTOL = 1e-4
# phases 30-32: the MoE, SSM and hybrid families at full width and depth
# through launch/serve.py:main (the burst of phase 29), each cut to 2 layers
# in float32 for its card-against-CPU check: qwen3-moe on prompts of
# LLM_CHECK_LENS, packed and solo; the SSM and hybrid on one prompt of
# FAMILY_SSM_PROMPT tokens, one chunk of the SSD whose accumulated decay
# passes ~88, where the reference's unmasked exponent overflows
FAMILY_PHASES = (  # (phase, arch, samplers of the full-width bursts)
    ("serve_lm_moe", "qwen3_moe_30b", ("mcmc", "greedy")),  # depth cut: DEPTH_CUTS
    ("serve_lm_ssm", "mamba2_1p3b", ("mcmc",)),
    ("serve_lm_hybrid", "hymba_1p5b", ("mcmc",)),
)
FAMILY_SSM_PROMPT = 130
# earlier phases served at full width but cut in depth (layers of the
# full config), so that the script stays near its time aim with phases
# 33-36: qwen3-moe's 48 layers (61.09 GB, 36-56 s a phase at full depth;
# 23-35 s at 12 layers, before phase 36 came)
DEPTH_CUTS = {"qwen3_moe_30b": 8}
# a full-width Mamba-2 layer's chunked output against its step recurrence on
# the card (float32, one 130-token chunk), relative to the largest output:
# the CPU gives 2.2e-6 (mamba2) and 1.3e-6 (hymba)
SSM_LAYER_RTOL = 1e-5
# the cuts' float32 logits on the card against a float64 run of the same
# weights on the CPU: within LLM_LOGIT_TOL, or within this factor of the
# CPU's own float32 error where a near one-hot attention magnifies rounding
# past it (hymba's cut: 1.7e-3 card against CPU in PR 21's first run; the
# CPU's float32 4.8e-4 from float64 on other weights of the same cut)
FAMILY_F32_FACTOR = 4
# phases 33-34: phi-3-vision through a BatchedServer whose cache holds its 576
# image tokens (main's prompt + 2 + gen + 8 rows do not, and main raises, as
# the reference's does), whisper through launch/serve.py:main; each with the
# burst of phase 29 and, cut to 2 layers (and 2 encoder layers) in float32,
# card against CPU on prompts of LLM_CHECK_LENS with seeded patch embeddings
# or frames
VLM_ARCH, AUDIO_ARCH = "phi3_vision_4p2b", "whisper_large_v3"
# whisper's cut is held in float64 on the card against float64 on the CPU
# (and packed against solo in float64), within AUDIO_F64_TOL; its float32
# card run is reported beside the CPU's.  Under the init rule every
# attention is near one-hot (query and key projections scaled
# 1/sqrt(heads), scores in the hundreds), and over 1,500 frames the cut
# magnifies float32 rounding about 10^5-fold: its float32 logits were 0.16
# and 0.043 apart card against CPU in two runs on the H100 (frames from
# SEED, then seed 3), near ties either way, while float64's rounding is
# 2^29 times finer.  The frames come from AUDIO_CHECK_SEED
AUDIO_CHECK_SEED = 3
AUDIO_F64_TOL = 1e-6
VLM_MAX_LEN = 576 + (LLM_PROMPT + 2) + LLM_GEN + 8
# phase 39: each server of phases 29-34 serves CS_REQUESTS requests of
# CS_GEN tokens on LLM_SLOTS slots (CS_GEN steps, the slots refilled, then
# CS_GEN more), every step held against its eager twin; then CS_TIMED
# replayed decodes, samples and steps are timed
CS_REQUESTS, CS_GEN, CS_TIMED = 2 * LLM_SLOTS, 4, 8
# phase 35: launch/train.py:main on hymba-1.5b at full width and depth
# (bfloat16, Markov data), then make_decode_sample_step on its weights; the
# cut (2 layers, float32) trains TRAIN_CHECK_STEPS AdamW steps on the card,
# on the CPU and in float64 on the CPU from the same weights, and the card
# is held to the float64 run as the serving cuts are: each loss within
# TRAIN_LOSS_TOL, each gradient norm within TRAIN_GNORM_RTOL relative, each
# parameter leaf's RMS difference within TRAIN_PARAM_RMS_RTOL of its
# update's RMS, or within FAMILY_F32_FACTOR times the CPU's own float32
# error where that is larger; no parameter past 2 x the summed lr (Adam
# moves one by up to lr a step, whatever sign its near-zero gradient takes).
# The cut's near one-hot attention magnifies rounding: its gradients were
# 3.3e-3 of the largest apart card against CPU in the card's first test
# (tests/test_torch_gpu.py), the CPU's float32 1.5e-3 from float64
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = "hymba_1p5b", 6, 8, 1024, 2
TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL, TRAIN_PARAM_RMS_RTOL = 1e-4, 1e-4, 1e-3
# phase 40: run_training's step on each case (arch, layers kept or None for
# the full depth, rows, sequence, microbatches): CT_STEPS eager steps from
# one state, the state restored from pinned host memory, CT_STEPS compiled
# steps (a capture, then replays), every step at tolerance 0
CT_STEPS = 3
CT_CASES = ((TRAIN_ARCH, None, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO),
            ("qwen3_moe_30b", 2, 2, 256, 1))
# phase 36: compressed-pod steps of hymba-1.5b at phase 35's batch; granite-3
# 8B cut to MESH_RULES_LAYERS layers, a batch of MESH_RULES_BATCH x
# MESH_RULES_SEQ tokens, a prefill of MESH_PROMPT and MESH_DECODE steps;
# moe_ffn_ep on MESH_MOE_TOKENS rows of MESH_MOE_SEQ tokens
MESH_STEPS, MESH_RULES_LAYERS, MESH_RULES_BATCH, MESH_RULES_SEQ = 2, 2, 2, 256
MESH_PROMPT, MESH_DECODE, MESH_MOE_ROWS, MESH_MOE_SEQ = 64, 2, 2, 128
# phase 37, the dry run: (a) its CLI on the production meshes (256 and 512
# fake ranks in one process each, fake tensors on the card): (name, mesh
# directory, report name, arguments); (b) the same steps on a 1 x 1 fake
# mesh at the shapes phases 35 and 29 ran, against what they measured.
# The three children start after the build, at low priority with one
# thread each, and phase 37 collects them last; each must end within
# DRYRUN_TIMEOUT_S of the script's start (the 512-rank train_4k cell traced
# for 451 s alone and 623 s beside phases 2-36 on the card's hosts)
DRYRUN_CLI = (
    ("granite_decode_sample", "16x16", "granite-3-8b__decode_32k",
     ["--arch", "granite3_8b", "--shape", "decode_32k", "--decode-sample"]),
    ("granite_decode_sample_32x8", "32x8", "granite-3-8b__decode_32k",
     ["--mesh", "32x8", "--arch", "granite3_8b", "--shape", "decode_32k", "--decode-sample"]),
    ("hymba_pods", "pod2_16x16", "hymba-1.5b__train_4k",
     ["--multi-pod", "--compress-pods", "--arch", "hymba_1p5b", "--shape", "train_4k"]),
)
# the 16 x 16 decode-sample cell again with ``--device cpu``: the plan must
# not depend on the device, so its collective bytes equal the card's, kind
# by kind: (name, the card's cell, mesh directory, report name, arguments)
DRYRUN_CPU_TWIN = ("granite_decode_sample_cpu", "granite_decode_sample", "16x16",
                   "granite-3-8b__decode_32k__cpu",
                   ["--arch", "granite3_8b", "--shape", "decode_32k", "--decode-sample",
                    "--device", "cpu", "--tag", "cpu"])
DRYRUN_TIMEOUT_S = 1100
# The JAX package's own dry run of the decode-sample cells, per device, by
# mesh directory: ``python -m repro.launch.dryrun --arch granite3_8b
# --shape decode_32k --decode-sample [--mesh 32x8]`` on the CPU (jax
# 0.9.0).  These are XLA's counts of the reference's plan, not times; the
# port's cells must hold its FLOPs, gather no weight, and move at most
# DRYRUN_MAX_COLLECTIVE_RATIO times its collective bytes.
DRYRUN_JAX = {
    "16x16": {"flops": 23942135808, "all-reduce": 21185572, "all-gather": 983040,
              "collective-permute": 7200, "total": 22175812},
    "32x8": {"flops": 18908971008, "all-reduce": 7971348, "all-gather": 491520,
             "collective-permute": 3472, "total": 8466340},
}
DRYRUN_MAX_ALL_GATHER, DRYRUN_MAX_COLLECTIVE_RATIO = 3e6, 1.25
LLM_MAX_LEN = LLM_PROMPT + 2 + LLM_GEN + 8  # launch/serve.py:main's sizing (phase 29)


def emit(**record):
    print(json.dumps(record), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def start_dryrun_children(out: Path) -> dict:
    """Phase 37's children, started at low priority with one thread each:
    ``{name: (process, log path)}``; each is killed if still running when
    the script exits."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    commands = {name: [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                       "--out-dir", str(out)]
                for name, *_, args in (*DRYRUN_CLI, DRYRUN_CPU_TWIN)}
    commands["phase_shapes"] = [sys.executable, str(ROOT / "chip_smoke.py"),
                                "--dryrun-phase-shapes", str(out)]
    children = {}
    for name, cmd in commands.items():
        log = out / f"{name}.log"
        with open(log, "w") as fh:
            children[name] = (subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=fh,
                                               stderr=subprocess.STDOUT,
                                               preexec_fn=lambda: os.nice(10)), log)
    atexit.register(lambda: [p.kill() for p, _ in children.values() if p.poll() is None])
    return children


def dryrun_phase_shapes(out: str) -> int:
    """Phase 37 (b)'s child: the dry run's train and decode steps on a 1 x 1
    fake mesh at the shapes phases 35 and 29 run for real (hymba-1.5b, 8 x
    1,024 tokens in 2 microbatches; granite-3 8B, B = 4 against a cache of
    ``LLM_MAX_LEN`` rows), fake tensors on the card; writes both reports."""
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.launch import dryrun

    configs.SHAPES["train_lm"] = configs.ShapeSpec("train_lm", TRAIN_SEQ, TRAIN_BATCH, "train")
    configs.SHAPES["serve_lm"] = configs.ShapeSpec("serve_lm", LLM_MAX_LEN, LLM_SLOTS, "decode")
    make, _, world = dryrun.mesh_for("1x1", False, "cuda")
    with dryrun.fake_group(world):
        mesh = make()
        reports = {
            "train_lm": dryrun.run_cell(TRAIN_ARCH, "train_lm", mesh, cfg=dataclasses.replace(
                configs.get_config(TRAIN_ARCH), train_microbatches=TRAIN_MICRO), device="cuda"),
            "serve_lm": dryrun.run_cell(LLM_ARCH, "serve_lm", mesh, device="cuda"),
        }
        del mesh
    with open(Path(out) / "phase_shapes.json", "w") as fh:
        json.dump(reports, fh)
    return 0 if all(r["status"] == "ok" for r in reports.values()) else 1


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Profiler sessions: all of them, those run again because their trace
# came back empty or short of the kernels the run launched, what the empty
# and short ones held, and the least (kernel start - its launch call's
# start) over every traced launch: below 0, it is how far the profiler
# placed a kernel before its own launch on the host's clock; and the lead
# runs' launches whose kernel the trace lacks
PROFILER = dict(sessions=0, rerun=0, incomplete=[], min_kernel_minus_launch_us=None,
                lead_launches_lost=0)
# The card idle between the lead run and the measured one, and after it.
# The profiler keeps only kernels inside its capture window on the host's
# clock, and on the H100's machine it placed kernels up to milliseconds
# off their launches (tools/profiler_clock.py; PERF.md, Open questions)
PAD_S = 0.1


class Device(NamedTuple):
    """A kernel or copy on the card, from the profiler's trace."""
    name: str
    self_device_time_total: float  # microseconds


def traced(torch, run, match=None, launched=None, cpu=False, attempts=5, host_calls=None):
    """Profile ``run`` twice in one session, ``PAD_S`` of idle card after
    each: the first run (the lead) warms up and is left out, because the
    card's profiler has lost the first kernel of a session (PERF.md, Open
    questions).  Returns the device records (name, microseconds) of the
    kernels and copies launched by the second run, by the CUDA runtime's
    correlation ids, and its wall milliseconds.  With ``match`` and
    ``launched`` (a function that reads a kernel launch count), they must
    hold exactly as many kernels whose name contains ``match`` as the count
    grew by in the second run: a session whose trace is short is recorded,
    with the launches whose kernels it lacks, and run again, at most
    ``attempts`` times in all; the script fails if none is complete or one
    holds more kernels than were launched.  ``host_calls``, a list, gets the
    names of the second run's host events (runtime calls and, with
    ``cpu``, PyTorch's operators) in the session kept."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    on_card = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        PROFILER["sessions"] += 1
        with profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            mark_ns = time.time_ns()
            n0 = launched() if launched else 0
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PAD_S)
        want = launched() - n0 if launched else 0
        raw = prof.profiler.kineto_results.events()
        kernel_ids = {e.correlation_id() for e in raw if e.device_type() == on_card}
        PROFILER["lead_launches_lost"] += sum(
            e.device_type() != on_card and "Launch" in e.name() and e.start_ns() <= mark_ns
            and e.correlation_id() not in kernel_ids for e in raw)
        host = sorted((e for e in raw if e.device_type() != on_card and e.start_ns() > mark_ns),
                      key=lambda e: e.start_ns())
        ids = {e.correlation_id() for e in host} - {0}
        on = [e for e in raw if e.device_type() == on_card and e.correlation_id() in ids]
        device = [Device(e.name(), e.duration_ns() / 1e3) for e in on]
        start = {e.correlation_id(): e.start_ns() for e in on}
        calls = [e for e in host if "Launch" in e.name()]
        lead = [(start[c.correlation_id()] - c.start_ns()) / 1e3
                for c in calls if c.correlation_id() in start]
        low = PROFILER["min_kernel_minus_launch_us"]
        PROFILER["min_kernel_minus_launch_us"] = min(
            lead + ([] if low is None else [low]), default=None)
        found = sum(match in e.name for e in device) if match else 0
        check(found <= want, f"the trace holds {found} {match} for {want} launches")
        if device and found == want:
            break
        PROFILER["rerun"] += 1
        PROFILER["incomplete"].append(dict(
            match=match, launched=want, found=found, events=len(device),
            runtime_launches=len(calls),
            launches_without_kernel=[i for i, c in enumerate(calls)
                                     if c.correlation_id() not in start],
            kernel_minus_launch_us=[min(lead), max(lead)] if lead else None,
            names=sorted({e.name[:50] for e in device}),
            device_us=[round(e.self_device_time_total, 1) for e in device]))
        emit(phase="profiler_incomplete", **PROFILER["incomplete"][-1])
    check(device and found == want, f"{attempts} profiler sessions: {len(device)} device "
          f"events, {found} {match} for {want} launches in the last")
    if host_calls is not None:
        host_calls.extend(e.name() for e in host)
    return device, wall_ms


def device_ms(torch, fn, reps, match, launched):
    """Device time per call of ``fn``: the summed time of the kernels whose
    name contains ``match`` in the profiler's trace of ``reps`` calls, over
    ``reps``; the trace must hold every kernel the calls launched, as
    ``launched`` counts them (``traced``)."""
    def run():
        for _ in range(reps):
            fn()

    events = traced(torch, run, match, launched)[0]
    return sum(e.self_device_time_total for e in events if match in e.name) / reps / 1e3


@contextlib.contextmanager
def first_launches(mod, pick=None):
    """Record a copy of the operands of each kernel's first launch (the
    first for which ``pick(args, kw)`` holds, with ``pick``) while a path
    runs; every launch still goes through the real kernel."""
    seen = {}
    names = tuple(mod.LAUNCHES)
    real = {n: getattr(mod, f"_launch_{n}") for n in names}

    def recording(name):
        def launch(*args, **kw):
            if name not in seen and (pick is None or pick(args, kw)):
                seen[name] = (
                    tuple(a.clone() if hasattr(a, "clone") else a for a in args),
                    dict(kw),
                )
            return real[name](*args, **kw)
        return launch

    for n in names:
        setattr(mod, f"_launch_{n}", recording(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(mod, f"_launch_{n}", real[n])


# SASS classes: the integer ALU (logic, shifts, compares, selects, adds as
# IADD3), the multiply-add unit (IMAD and its moves and adds, VIADD, float
# arithmetic); loads and stores and the rest take only an issue slot
ALU_OPCODES = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IABS", "IMNMX",
               "FLO", "POPC", "BMSK", "SGXT", "PLOP3", "MOV", "FSETP", "FSEL", "I2F", "F2I"}
FMA_OPCODES = {"IMAD", "IMUL", "VIADD", "FFMA", "FADD", "FMUL"}


def sass_loops(cuobjdump, library_path, *names):
    """The innermost loops of the kernel whose mangled name contains every
    one of ``names``, from ``cuobjdump -sass`` of the built library: for
    each loop (a backward branch and its target) its address range and its
    instructions per iteration by class, with its funnel-shift rotates,
    shared stores and 16-byte streaming stores counted apart."""
    import re

    out = subprocess.run([cuobjdump, "-sass", library_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    body = next((part for part in out.split("Function : ")[1:]
                 if all(n in part.split("\n", 1)[0] for n in names)), None)
    check(body is not None, f"no kernel named {names} in the SASS of {library_path}")
    instr = [
        (int(m[1], 16), m[2], m[3])
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)([^;]*);",
                             body)
    ]
    ranges = []
    for addr, op, args in instr:
        target = re.search(r"0x([0-9a-f]+)", args)
        if op == "BRA" and target and int(target[1], 16) < addr:
            ranges.append((int(target[1], 16), addr))
    inner = [r for r in ranges
             if not any(o != r and r[0] <= o[0] and o[1] <= r[1] for o in ranges)]
    loops = []
    for lo, hi in sorted(inner):
        ops = [(op, args) for addr, op, args in instr if lo <= addr <= hi]
        base = [op.split(".")[0] for op, _ in ops]
        loops.append(dict(
            start=hex(lo), end=hex(hi), instructions=len(ops),
            alu=sum(b in ALU_OPCODES for b in base),
            fma=sum(b in FMA_OPCODES for b in base),
            rotates=sum(op.startswith("SHF.L.W") for op, _ in ops),
            shared_stores=sum(b == "STS" for b in base),
            vector_stores=sum(op.startswith("STG.E.EF.128") for op, _ in ops),
        ))
    return loops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gibbs_cost(name, args, kw):
    """Bytes and operations a Gibbs kernel call needs (each input read
    once, each output written once; the active site-steps of these
    parities): (bytes, all ops, integer ops, ALU-only ops, shape)."""
    fused = name == "gibbs_chain_fused"
    init_, logit, start = args[0], args[4 if fused else 2], args[3]
    b, h, w = init_.shape
    k = kw["n_steps"] if fused else args[1].shape[0]
    sites = b * h * w
    colour = {0: (h * w + 1) // 2, 1: h * w // 2}  # sites of each colour
    active = sum(colour[(p0 + j) % 2] for p0 in start.tolist() for j in range(k))
    nbytes = 4 * (2 * sites + k * sites + b)  # init, flips, samples, parity/t0
    if hasattr(logit, "j_right"):  # a SpinGlassLogit
        nbytes += 8 * h * w  # the couplings
    scaled = logit.scale != 1.0  # a tempered replica: one more multiply a site
    if name == "gibbs_chain":
        nbytes += 4 * k * sites  # the uniforms
        ops = (GIBBS_OPS + scaled) * active
        int_ops = (GIBBS_OPS - GIBBS_FP_OPS) * active
        alu = GIBBS_ALU_OPS * active
    else:
        nbytes += 8 * b  # the key words
        # a draw and the flip per active site, a step key per lattice
        # and half-sweep; the Ising flip is a table lookup, the spin
        # glass's is float work
        int_ops = (THREEFRY_SITE_OPS + BAND_SITE_INT_OPS) * active + THREEFRY_OPS * k * b
        alu = ((THREEFRY_SITE_ALU_OPS + BAND_SITE_ALU_OPS) * active
               + THREEFRY_ALU_OPS * k * b)
        glass = hasattr(logit, "j_right")
        ops = int_ops + ((GLASS_SITE_FP_OPS + scaled) * active if glass else 0)
    return nbytes, ops, int_ops, alu, dict(B=b, H=h, W=w, K=k, active_site_steps=active,
                                      scale=logit.scale,
                                      **({"lat_b": kw["lat_b"]} if kw else {}))


def operand_uniforms(torch, gen, shape):
    """float32 uniforms off the cipher's 2^-24 grid where they can be
    (below 1/2): float64 draws rounded to float32."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float64).float()


def lattice_logit(torch, gref, gen, h, w, glass):
    """The Ising spec at the critical coupling, or a spin glass with ±1
    couplings drawn from ``gen``."""
    if not glass:
        return gref.IsingLogit(BETA, 0.05)
    j = (torch.randint(0, 2, (2, h, w), generator=gen, device=gen.device) * 2 - 1).float()
    return gref.SpinGlassLogit(j[0].contiguous(), j[1].contiguous(), field=0.1)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not all((SRC / "repro_torch" / "csrc" / s).is_file()
               for s in ("mh.cu", "gibbs.cu", "msxor.cu")):
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import prng, samplers, telemetry, workloads
    from repro_torch.checkpoint import (
        checkpoint_nbytes,
        latest_step,
        load_checkpoint,
        load_checkpoint_tree,
        run_resumable,
    )
    from repro_torch.core import bitcell, energy, msxor, targets
    from repro_torch.distributed import sharding
    from repro_torch.core.macro import CIMMacro, MacroConfig
    from repro_torch.kernels import _build, rng
    from repro_torch.kernels.gibbs import gibbs as gk
    from repro_torch.kernels.gibbs import ref as gref
    from repro_torch.kernels.mh import mh, ref
    from repro_torch.kernels.mh import ops as mh_ops
    from repro_torch.kernels.msxor import msxor as xk
    from repro_torch.kernels.msxor import ops as xops
    from repro_torch.kernels.msxor import ref as xref
    from repro_torch.launch import mesh as tmesh
    from repro_torch.workloads import gmm as gmm_wl

    def reset_launches():
        mh.reset_launches()
        gk.reset_launches()
        xk.reset_launches()

    def launches_now():
        return {**mh.LAUNCHES, **gk.LAUNCHES, **xk.LAUNCHES}

    t_start = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = smi()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = max_sm_clock_hz()
    int_ops_per_s = (INT_OPS_PER_CLOCK_PER_SM + FMA_OPS_PER_CLOCK_PER_SM) * sms * clock_hz
    alu_ops_per_s = INT_OPS_PER_CLOCK_PER_SM * sms * clock_hz

    def int_bound_ms(ops, alu_ops):
        return max(ops / int_ops_per_s, alu_ops / alu_ops_per_s) * 1e3

    # 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    ptxas = [
        line.strip() for line in info["log"].splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
    emit(
        phase="build", seconds=info["seconds"], cached=info["cached"],
        wall_s=time.perf_counter() - t0, ptxas=ptxas, card=card,
        kind=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, sms=sms, max_sm_clock_mhz=clock_hz / 1e6,
        int_ops_per_s=int_ops_per_s, alu_ops_per_s=alu_ops_per_s,
        band_limits_1024=gk.band_limits(dev.index, LAT),
    )
    # phase 37's dry runs, in child processes (fake tensors and fake process
    # groups never meet this process's real ones); collected at the end
    dry_dir = ROOT / "build" / "chip_smoke_dryrun"
    dry_children = start_dryrun_children(dry_dir)
    dry_refs = {}  # what phases 29 and 35 measured, for phase 37 (b)
    burst_tokens_per_s = {}  # phases 29-34's mcmc bursts, for phase 39

    # 2. cipher ----------------------------------------------------------
    kat = [
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for key, ctr, out in kat:
        y = rng.threefry2x32_device(*(torch.tensor([w], device=dev) for w in (*key, *ctr)))
        check((int(y[0]), int(y[1])) == out, f"Threefry known answer {out} failed: {y}")
    words = [
        torch.randint(0, 2**32, (1 << 20,), generator=gen, device=dev, dtype=torch.int64)
        for _ in range(4)
    ]
    d0, d1 = rng.threefry2x32_device(*words)
    h0, h1 = rng.threefry2x32(*words)
    bad = int((d0 != h0).sum() + (d1 != h1).sum())
    check(bad == 0, f"device cipher differs from the host cipher on {bad} words")
    emit(phase="cipher", known_answers=len(kat), counters=1 << 20, mismatches=bad)

    # 3-4. kernels against their plain versions ---------------------------
    wrapper_of = {"mh_chain": mh.mh_chain, "mh_chain_fused": mh.mh_chain_fused,
                  "gibbs_chain": gk.gibbs_chain, "gibbs_chain_fused": gk.gibbs_chain_fused}
    plain_of = {"mh_chain": ref.mh_chain_ref, "mh_chain_fused": ref.mh_chain_fused_ref,
                "gibbs_chain": gref.gibbs_chain_ref,
                "gibbs_chain_fused": gref.gibbs_chain_fused_ref}
    launch_of = {"mh_chain": mh._launch_mh_chain,
                 "mh_chain_fused": mh._launch_mh_chain_fused,
                 "gibbs_chain": gk._launch_gibbs_chain,
                 "gibbs_chain_fused": gk._launch_gibbs_chain_fused}
    ties_of = {"mh_chain": ref.tie_events, "gibbs_chain": gref.chain_ties}
    max_err = {name: 0.0 for name in wrapper_of}
    cases = []  # (kernel, where, args, kw): every shape held and timed

    def hold(name, where, args, kw, record=True):
        """The kernel against its plain version on the same operands, at
        tolerance 0; records the case for timing.  Returns (mismatched
        words, largest difference, accept or flip count per step)."""
        s_, a = wrapper_of[name](*args, **kw)
        rs, ra = plain_of[name](*args, **kw)
        err = max((float((x - y).abs().max()) for x, y in ((s_, rs), (a, ra)) if x.numel()),
                  default=0.0)
        diff = int((s_ != rs).sum()) + int((a != ra).sum())
        ties = ties_of[name](*args) if diff and name in ties_of else []
        max_err[name] = max(max_err[name], err)
        check(diff == 0, f"{name} differs from its plain version at {where}: "
              f"{diff} words, max |err| {err}, tie events {len(ties)}")
        check(s_.dtype == rs.dtype and s_.shape == rs.shape, f"{name} at {where}: "
              f"samples {s_.dtype} {tuple(s_.shape)}, plain {rs.dtype} {tuple(rs.shape)}")
        if record:
            cases.append((name, where, args, kw))
        return diff, err, float(a.sum()) / max(a.numel() * s_.shape[0], 1)

    def from_launch(args):
        """A recorded launch's int32-coded words back to int64 words (the
        Gibbs launches; the MH launches take the int64 words as they are)."""
        return tuple(
            _build.from_u32_bits(a) if getattr(a, "dtype", None) == torch.int32 else a
            for a in args
        )

    def table_of(b, v):
        return torch.randn(b, v, generator=gen, device=dev) * 3

    cim = samplers.CIMRandomness(p_bfr=0.45, rng_p_bfr=0.45)
    p_u32 = rng.threshold_u32(0.45)
    for b, v, nbits in ((B, V, 16), (B_WIDE, V_WIDE, NBITS_WIDE)):
        table = table_of(b, v)
        init = torch.randint(0, v, (b, C), generator=gen, device=dev)
        flips, u = cim.chunk(prng.PRNGKey(SEED, device=dev), 0, K, (b, C), nbits)
        k0c, k1c = (
            torch.randint(0, 2**32, (C,), generator=gen, device=dev) for _ in range(2)
        )
        t0c = torch.randint(0, 2**31 - K, (C,), generator=gen, device=dev)
        where = f"V={v}"
        diff, err, rate = hold("mh_chain", where, (table, init, flips, u, nbits), {})
        emit(phase="mh_chain", B=b, V=v, C=C, K=K, nbits=nbits, mismatches=diff,
             max_abs_err=err, accept_rate=rate, row_bytes=4 * v)
        kw = dict(nbits=nbits, n_steps=K, cc=C, p_u32=p_u32)
        diff, err, rate = hold("mh_chain_fused", where, (table, init, k0c, k1c, t0c), kw)
        emit(phase="mh_chain_fused", B=b, V=v, C=C, K=K, nbits=nbits, mismatches=diff,
             max_abs_err=err, accept_rate=rate,
             t0_min=int(t0c.min()), t0_max=int(t0c.max()))

    # the chain-tile design at the shapes it must get right: one chain a
    # row, ragged chain and step tiles, K = 0 and 1, every nbits template
    # and the generic one, rows at and around the shared-memory limit,
    # unaligned rows and their first and last words, folded columns with
    # step bases wrapping past 2^31
    limit = mh.staged_vocab(dev.index)
    for where, (b, v, c, k, nbits, cc) in {
        "C=1 (sample_tokens)": (B, V, 1, K, 16, 1),
        "ragged C and K": (B, 301, 300, 37, 16, 300),
        "K=0": (4, 500, 100, 0, 8, 100),
        "K=1": (4, 500, 100, 1, 8, 100),
        "nbits 1": (3, 2, 70, 20, 1, 70),
        "nbits 8": (4, 256, 64, 32, 8, 64),
        "nbits 16": (B, V, C, 16, 16, C),
        "nbits 18": (B_WIDE, 70_001, C, 12, 18, C),
        "nbits 32": (2, 1001, 50, 20, 32, 25),
        "V at the staged limit": (3, limit, 40, 9, 16, 40),
        "V below the staged limit": (3, limit - 1, 40, 9, 16, 40),
        "V above the staged limit": (3, limit + 1, 40, 9, 16, 40),
        "odd V, odd b": (5, 1003, 33, 19, 10, 33),
        "cc < C": (3, 777, 96, 21, 16, 24),
        "B=1 (gmm)": (1, 256, 64, 32, 8, 64),
        "row ends": (5, 1003, 64, 30, 3, 64),
        "row ends at the staged limit": (4, limit, 64, 30, 3, 64),
    }.items():
        table = table_of(b, v)
        init = torch.randint(0, v, (b, c), generator=gen, device=dev)
        if "row ends" in where:  # the ragged head and tail of unaligned rows
            j = torch.arange(c, device=dev) % 8
            init[:] = torch.where(torch.arange(c, device=dev) % 2 == 0, j, v - 1 - j)
        init[0, 0] = 2**32 - 1  # outside the table: -inf until a finite move
        flips = torch.randint(0, 2**nbits, (k, b, c), generator=gen, device=dev)
        u = torch.randint(0, 2**16, (k, b, c), generator=gen, device=dev) / 2**16
        k0c, k1c = (
            torch.randint(0, 2**32, (c,), generator=gen, device=dev) for _ in range(2)
        )
        t0c = 2**31 - 5 + torch.randint(0, 9, (c,), generator=gen, device=dev)
        d1, e1, r1 = hold("mh_chain", where, (table, init, flips, u, nbits), {}, record=False)
        kw = dict(nbits=nbits, n_steps=k, cc=cc, p_u32=p_u32)
        d2, e2, r2 = hold("mh_chain_fused", where, (table, init, k0c, k1c, t0c), kw,
                          record=False)
        emit(phase="mh_tile_shapes", where=where, B=b, V=v, C=c, K=k, nbits=nbits, cc=cc,
             staged=v <= limit, mismatches=[d1, d2], max_abs_err=[e1, e2],
             accept_rate=[r1, r2])
    del table, init, flips, u

    # 5. the Gibbs kernels against their plain versions ---------------------
    for h, w, glass in ((7, 9, False), (6, 8, True)):
        b, k = 3, 24
        init = torch.randint(0, 2, (b, h, w), generator=gen, device=dev)
        u = torch.rand((k, b, h, w), generator=gen, device=dev)
        logit = lattice_logit(torch, gref, gen, h, w, glass)
        parity0 = torch.tensor([0, 1, 1], device=dev)
        t0b = torch.tensor([3, 2**31 - 7, -4], device=dev)  # differ, and wrap mod 2^32
        k0b, k1b = (torch.randint(0, 2**32, (b,), generator=gen, device=dev) for _ in range(2))
        where = f"{h}x{w} {'spin glass' if glass else 'ising'}"
        d1, e1, r1 = hold("gibbs_chain", where, (init, u, logit, parity0), {})
        d2, e2, r2 = hold("gibbs_chain_fused", where, (init, k0b, k1b, t0b, logit),
                          dict(n_steps=k, lat_b=2))
        emit(phase="gibbs_kernels", lattice=where, B=b, K=k, parity0=parity0.tolist(),
             t0b=t0b.tolist(), lat_b=2, mismatches=[d1, d2], max_abs_err=[e1, e2],
             flips_per_site_step=[r1, r2])

    # the band kernel at the shapes its design must get right: odd wraps,
    # K = 1, bands of several rows, the uint8 flush, more than one group
    for where, b, h, w, k, glass, lat_b in (
        ("5x7 odd", 3, 5, 7, 24, False, 2),
        ("3x5 odd", 2, 3, 5, 17, False, 1),
        ("64x96 K=1", 4, 64, 96, 1, False, 4),
        ("33x40 spin glass", 3, 33, 40, 30, True, 3),
        ("256x256 K=300", 2, 256, 256, 300, False, 2),
        ("16 x 1024x1024 lat_b=4", 16, LAT, LAT, 16, False, 4),
    ):
        init = torch.randint(0, 2, (b, h, w), generator=gen, device=dev)
        k0b, k1b = (torch.randint(0, 2**32, (b,), generator=gen, device=dev) for _ in range(2))
        t0b = torch.tensor([3, -4, 2**31 - 7, 10] * (b // 4 + 1), device=dev)[:b]
        logit = lattice_logit(torch, gref, gen, h, w, glass)
        groups = gk.plan_groups(b, h, w, **gk.band_limits(dev.index, w))
        gk.reset_launches()
        diff, err, rate = hold("gibbs_chain_fused", where, (init, k0b, k1b, t0b, logit),
                               dict(n_steps=k, lat_b=lat_b))
        launched = gk.LAUNCHES["gibbs_chain_fused"]
        check(launched == len(groups), f"{where}: {launched} launches for {len(groups)} groups")
        emit(phase="gibbs_band_kernel", lattice=where, B=b, K=k, lat_b=lat_b,
             t0b_parity=[int(x) % 2 for x in t0b.tolist()], groups=[g._asdict() for g in groups],
             launches=launched, mismatches=diff, max_abs_err=err, flips_per_site_step=rate)
        del init

    # the operand draw of the band kernel at its timed shapes, with u off
    # the cipher's 2^-24 grid (float64 draws rounded to float32): the flip
    # is u < p in floats
    for where, b, h, w, k, glass in OPERAND_SHAPES:
        init = torch.randint(0, 2, (b, h, w), generator=gen, device=dev)
        u = operand_uniforms(torch, gen, (k, b, h, w))
        parity0 = torch.arange(b, device=dev) % 2
        logit = lattice_logit(torch, gref, gen, h, w, glass)
        groups = gk.plan_groups(b, h, w, **gk.band_limits(dev.index, w))
        gk.reset_launches()
        diff, err, rate = hold("gibbs_chain", where, (init, u, logit, parity0), {})
        launched = gk.LAUNCHES["gibbs_chain"]
        check(launched == len(groups), f"{where}: {launched} launches for {len(groups)} groups")
        emit(phase="gibbs_operand_kernel", lattice=where, B=b, K=k,
             parity0=parity0.tolist()[:4], groups=[g._asdict() for g in groups],
             launches=launched, mismatches=diff, max_abs_err=err, flips_per_site_step=rate,
             off_grid_uniforms=int((u * 2**24 != torch.floor(u * 2**24)).sum()))
        del init, u

    # 6. the MH main path -----------------------------------------------------
    logits = table_of(B, V)
    init = torch.randint(0, V, (B, C), generator=gen, device=dev)
    kernel_of = {"cim": "mh_chain", "fused": "mh_chain_fused"}
    main_launches = {}
    path_s = {}
    for randomness in ("cim", "fused"):
        eng = samplers.MHEngine(samplers.EngineConfig(randomness=randomness))
        check(eng.device.type == "cuda", "the engine did not default to the card")
        target = samplers.TableTarget(logits)
        plan = samplers.RunPlan(target=target, n_steps=N_STEPS, init_words=init, seed=SEED)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        full = eng.submit(plan)
        torch.cuda.synchronize()
        path_s[randomness] = time.perf_counter() - t0
        launches = launches_now()
        main_launches[kernel_of[randomness]] = launches[kernel_of[randomness]]
        check(launches[kernel_of[randomness]] > 0,
              f"the {randomness} main path launched no {kernel_of[randomness]}")
        rate = float(full.acceptance_rate)
        check(0.0 < rate < 1.0, f"acceptance {rate} not in (0, 1)")
        check(tuple(full.samples.shape) == (N_STEPS, B, C), "wrong sample shape")
        check(bool((full.samples < V).all()), "a kept state lies outside the table")
        check(torch.equal(full.final_logp, target.log_prob(full.final_words)),
              "final_logp is not the table's log-prob of final_words")
        check(bool(torch.isfinite(full.final_logp).all()), "non-finite final_logp")
        half = eng.submit(plan.replace(n_steps=N_STEPS // 2))
        rest = half.resume(N_STEPS // 2)
        exact = (
            torch.equal(torch.cat([half.samples, rest.samples]), full.samples)
            and torch.equal(rest.final_words, full.final_words)
            and torch.equal(rest.final_logp, full.final_logp)
            and torch.equal(half.accept_count + rest.accept_count, full.accept_count)
        )
        check(exact, f"{randomness}: submit(512) + resume(512) != submit(1024)")
        emit(phase="main_path", randomness=randomness, execution="auto",
             B=B, V=V, C=C, n_steps=N_STEPS, launches=launches,
             acceptance_rate=rate, resume_bit_exact=exact, seconds=path_s[randomness],
             chain_steps_per_s=N_STEPS * B * C / path_s[randomness])

        # a small input, against the CPU path (the plain versions)
        small = {}
        for device in ("cuda", "cpu"):
            e = samplers.MHEngine(samplers.EngineConfig(randomness=randomness), device=device)
            t = samplers.TableTarget(logits[:4, :300].to(device))
            small[device] = e.submit(
                samplers.RunPlan(target=t, n_steps=40, init_words=init[:4, :16].cpu(), seed=7)
            )
        same = all(
            torch.equal(getattr(small["cuda"], f).cpu(), getattr(small["cpu"], f))
            for f in ("samples", "accept_count", "final_words", "final_logp")
        )
        check(same, f"{randomness}: the card and the CPU disagree on a small input")
        emit(phase="small_input", randomness=randomness, card_equals_cpu=same)

    launches_by_path = {f"main_path_{r}": {k: main_launches.get(k, 0)} for r, k
                        in kernel_of.items()}

    eng = samplers.MHEngine(samplers.EngineConfig())
    key = prng.PRNGKey(SEED, device=dev)
    reset_launches()
    with first_launches(mh) as seen:
        tokens, res = eng.sample_tokens(key, logits, n_steps=256)
    launches = launches_now()
    launches_by_path["sample_tokens"] = launches
    check(launches["mh_chain"] > 0, "sample_tokens launched no mh_chain")
    check(tuple(tokens.shape) == (B,) and bool(((tokens >= 0) & (tokens < V)).all()),
          "sample_tokens gave tokens outside the vocabulary")
    args, kw = seen["mh_chain"]
    check(tuple(args[1].shape) == (B, 1), f"sample_tokens ran {tuple(args[1].shape)}")
    diff, err, _ = hold("mh_chain", "sample_tokens (C=1)", from_launch(args), kw)
    token_ms = []
    for _ in range(6):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.sample_tokens(key, logits, n_steps=256)
        torch.cuda.synchronize()
        token_ms.append((time.perf_counter() - t0) * 1e3)
    token_ms = sorted(token_ms[1:])
    emit(phase="sample_tokens", B=B, V=V, C=1, n_steps=256, launches=launches,
         acceptance_rate=float(res.acceptance_rate), mismatches=diff, max_abs_err=err,
         wall_ms_median=token_ms[len(token_ms) // 2], wall_ms_min=token_ms[0])

    for randomness in ("cim", "fused"):
        name = kernel_of[randomness]
        cfg = samplers.EngineConfig(randomness=randomness, num_chains=4)
        plan = samplers.RunPlan(
            target=samplers.TableTarget(logits), n_steps=256,
            init_words=init.expand(4, B, C), seed=SEED,
        )
        reset_launches()
        with first_launches(mh) as seen:
            multi = samplers.MHEngine(cfg).submit(plan)
        launches = launches_now()
        launches_by_path[f"num_chains_{randomness}"] = launches
        check(launches[name] > 0, f"num_chains=4 ({randomness}) launched no {name}")
        check(tuple(multi.samples.shape) == (4, 256, B, C), "wrong multi-chain shape")
        solo = samplers.MHEngine(samplers.EngineConfig(randomness=randomness)).submit(
            plan.replace(init_words=init, chain_id=2)
        )
        check(torch.equal(multi.samples[2], solo.samples),
              f"{randomness}: chain 2 != solo chain_id=2")
        args, kw = seen[name]
        check(tuple(args[1].shape) == (B, 4 * C) and kw.get("cc", C) == C,
              f"num_chains=4 ({randomness}) did not fold the chains into the columns")
        diff, err, _ = hold(name, f"num_chains=4 {randomness} (C={4 * C})",
                            from_launch(args), kw)
        emit(phase="num_chains", randomness=randomness, num_chains=4, B=B, V=V,
             C=C, kernel_C=4 * C, cc=kw.get("cc"), n_steps=256, launches=launches,
             acceptance_rate=float(multi.acceptance_rate), chain2_equals_solo=True,
             mismatches=diff, max_abs_err=err)

    # 7. the Gibbs paths ------------------------------------------------------
    g_kernel_of = {"host": "gibbs_chain", "cim": "gibbs_chain", "fused": "gibbs_chain_fused"}
    g_main = {}  # kernel -> (path, launches) of the path that gives its row
    g_path_s = {}

    def gibbs_path(path, name, randomness, **kw):
        """Build and run one Gibbs workload on the card through
        ``engine.submit``, counting launches over the run alone; holds the
        kernel against its plain version at the first launch."""
        if name == "ising":
            kw = dict(beta=BETA, **kw)
        wl = workloads.build(name, prng.PRNGKey(SEED, device=dev), randomness=randomness,
                             backend="pallas", **kw)
        check(wl.engine.device.type == "cuda", "the workload's engine is not on the card")
        kernel = g_kernel_of[randomness]
        torch.cuda.synchronize()
        reset_launches()
        with first_launches(gk) as seen:
            t0 = time.perf_counter()
            res = wl.run(prng.PRNGKey(SEED + 1, device=dev))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = launches_now()
        launches_by_path[path] = launches
        check(launches[kernel] > 0, f"{path} launched no {kernel}")
        warm = []  # again, warm: the median of three runs, since a run on a
        for _ in range(3):  # shared host now and then stalls
            t0 = time.perf_counter()
            wl.run(prng.PRNGKey(SEED + 1, device=dev))
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        warm_seconds = sorted(warm)[1]
        args, kw_ = seen[kernel]
        diff, err, _ = hold(kernel, f"{path} first launch", from_launch(args), kw_)
        b, h, w = wl.init_words.shape[-3:]
        chains = wl.engine.config.num_chains
        rate = float(res.acceptance_rate)
        check(0.0 < rate <= 0.5, f"{path}: flip rate {rate} not in (0, 0.5]")
        check(bool(((res.samples == 0) | (res.samples == 1)).all()), f"{path}: a spin not 0/1")
        check(bool(torch.isfinite(res.final_logp).all()) and bool((res.final_logp <= 0).all()),
              f"{path}: final_logp is not a finite log-probability")
        stat = wl.series(res)
        check(bool(np.isfinite(stat).all()), f"{path}: non-finite {wl.meta['statistic']}")
        kept = stat.shape[0] - wl.kept_burn_in()
        g_path_s[path] = warm_seconds
        emit(phase="main_path_gibbs", path=path, workload=name, randomness=randomness,
             execution="pallas", lattice=f"{h}x{w}", B=b, num_chains=chains,
             n_steps=wl.n_steps, chunk_steps=wl.engine.config.chunk_steps,
             collect=wl.engine.config.collect, launches=launches,
             kernel_launches=launches[kernel],
             first_launch_mismatches=diff, max_abs_err=err, seconds=seconds,
             warm_seconds=warm_seconds, warm_runs_seconds=warm,
             site_steps_per_s=wl.n_steps * chains * b * h * w / warm_seconds, flip_rate=rate,
             statistic=wl.meta["statistic"], stat_mean=float(stat.mean()),
             stat_last=stat[-1].tolist()[:8],
             diagnostics=wl.diagnostics(res) if kept >= 4  # split R-hat needs 4 rows
             else f"{kept} kept rows after burn-in, too few for the diagnostics")
        return wl, res, kernel, launches[kernel]

    main_kw = dict(height=LAT, width=LAT, batch=LAT_B, n_steps=N_STEPS, chunk_steps=G_CHUNK,
                   collect=G_THIN)
    wl, full, kernel, n = gibbs_path("main_path_gibbs_ising_fused", "ising", "fused", **main_kw)
    g_main[kernel] = ("main_path_gibbs_ising_fused", n)
    plan = wl.plan(prng.PRNGKey(SEED + 1, device=dev))
    half = wl.engine.submit(plan.replace(n_steps=513))
    rest = half.resume(511)
    exact = (
        torch.equal(torch.cat([half.samples, rest.samples]), full.samples)
        and torch.equal(rest.final_words, full.final_words)
        and torch.equal(rest.final_logp, full.final_logp)
        and torch.equal(half.accept_count + rest.accept_count, full.accept_count)
    )
    check(exact, "ising fused: submit(513) + resume(511) != submit(1024)")
    emit(phase="gibbs_resume", workload="ising", randomness="fused", split=[513, 511],
         kept_rows=[half.samples.shape[0], rest.samples.shape[0]], resume_bit_exact=exact)
    del wl, full, half, rest
    gibbs_path("main_path_gibbs_spin_glass_fused", "spin_glass", "fused", **main_kw)
    op_kw = dict(height=OP_LAT, width=OP_LAT, batch=1, n_steps=OP_STEPS, chunk_steps=OP_CHUNK)
    for randomness in ("cim", "host"):
        gibbs_path(f"main_path_gibbs_ising_{randomness}", "ising", randomness, **op_kw)
    # the operand kernel's main path: host uniforms at the full width
    host_kw = dict(height=LAT, width=LAT, batch=LAT_B, n_steps=HOST_FULL_STEPS,
                   chunk_steps=OP_CHUNK, collect=G_THIN)
    _, _, kernel, n = gibbs_path("main_path_gibbs_ising_host_full", "ising", "host", **host_kw)
    g_main[kernel] = ("main_path_gibbs_ising_host_full", n)
    mc_kw = dict(height=MC_LAT, width=MC_LAT, batch=MC_B, n_steps=OP_STEPS,
                 chunk_steps=G_CHUNK, num_chains=MC_CHAINS)
    wl, multi, _, _ = gibbs_path("num_chains_gibbs_fused", "ising", "fused", **mc_kw)
    solo = workloads.build(
        "ising", prng.PRNGKey(SEED, device=dev), randomness="fused", backend="pallas",
        beta=BETA, **{**mc_kw, "num_chains": 1},
    )
    solo_res = solo.engine.submit(
        solo.plan(prng.PRNGKey(SEED + 1, device=dev), init_words=wl.init_words[2], chain_id=2)
    ).result
    same = all(torch.equal(getattr(multi, f)[2], getattr(solo_res, f))
               for f in ("samples", "accept_count", "final_words", "final_logp"))
    check(same, "ising fused: chain 2 of 4 != solo chain_id=2")
    emit(phase="gibbs_num_chains", num_chains=MC_CHAINS, chain2_equals_solo=same)
    del wl, multi, solo_res

    # a small lattice, on the card and on the CPU (the plain versions)
    for name, randomness in (("ising", "host"), ("ising", "cim"), ("ising", "fused"),
                             ("spin_glass", "fused")):
        small = {}
        shape = dict(height=7, width=9) if name == "ising" else dict(height=6, width=8)
        for device in ("cuda", "cpu"):
            wl = workloads.build(name, prng.PRNGKey(3), randomness=randomness,
                                 backend="pallas", batch=2, n_steps=40, chunk_steps=9,
                                 device=device, **shape)
            small[device] = wl.engine.submit(wl.plan(prng.PRNGKey(4), step0=5))
        same = all(
            torch.equal(getattr(small["cuda"], f).cpu(), getattr(small["cpu"], f))
            for f in ("samples", "accept_count", "final_words")
        )
        close = torch.allclose(small["cuda"].final_logp.cpu(), small["cpu"].final_logp,
                               rtol=4 * 2**-23, atol=0)
        check(same and close, f"{name} {randomness}: the card and the CPU disagree")
        emit(phase="gibbs_small_input", workload=name, randomness=randomness,
             card_equals_cpu=same, final_logp_within_4_ulp=close)

    # 8. the MSXOR kernel against its plain version ----------------------------
    msxor_err = 0.0
    msxor_cases = []  # (where, raw, n_stages, to_uniform): every shape held and timed

    def hold_msxor(where, raw, n_stages, to_uniform, record=True):
        """``msxor`` against its plain version on the same words, at
        tolerance 0; returns the largest difference."""
        nonlocal msxor_err
        got = xk.msxor(raw, n_stages, to_uniform)
        plain = (xref.msxor_uniform_ref if to_uniform else xref.msxor_fold_ref)(raw, n_stages)
        err = float((got.double() - plain.double()).abs().max())
        diff = int((got != plain).sum())
        msxor_err = max(msxor_err, err)
        check(diff == 0 and got.shape == plain.shape,
              f"msxor differs from its plain version at {where}: {diff} words, max |err| {err}")
        if record:
            msxor_cases.append((where, raw, n_stages, to_uniform))
        return err

    def bit_patterns(g, m):
        """(G, M) random uint32 words; bit 31 is set in half of them, whose
        int32 patterns are negative."""
        return torch.randint(0, 2**32, (g, m), generator=gen, device=dev, dtype=torch.int64)

    for n_stages in range(1, 6):
        for m in (777, 4099):
            raw = bit_patterns(1 << n_stages, m)
            errs = [hold_msxor(f"G={1 << n_stages}, M={m}", words, n_stages, u, record=False)
                    for words in (raw, _build.to_u32_bits(raw)) for u in (False, True)]
            emit(phase="msxor_kernel", n_stages=n_stages, G=1 << n_stages, M=m,
                 max_abs_err=errs, bit31_words=int((raw >= 2**31).sum()))
    for m, label in ((FIG9_M, "Fig. 9 shape"), (BIG_M, "(8, 2^24)")):
        raw = bit_patterns(8, m)
        errs = [hold_msxor(f"{label} {'uniform' if u else 'fold'}", raw, 3, u)
                for u in (False, True)]
        emit(phase="msxor_kernel", n_stages=3, G=8, M=m, max_abs_err=errs,
             bit31_words=int((raw >= 2**31).sum()))
        del raw

    # 9. the Fig. 9 path: biased raw words debiased by the kernel -----------
    card_draw, cpu_draw = (bitcell.raw_random_words(prng.PRNGKey(1, device=d), 0.40, (8, 4096))
                           for d in (dev, "cpu"))
    check(torch.equal(card_draw.cpu(), cpu_draw),
          "the (8, 4096) draw differs on the card and the CPU")
    torch.cuda.synchronize()
    reset_launches()
    fig9 = []
    with first_launches(xk) as seen_fig9:
        for p in (0.40, 0.45):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = bitcell.raw_random_words(prng.PRNGKey(1, device=dev), p, (8, FIG9_M), nbits=32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = xops.msxor_fold(raw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            shifts = torch.arange(32, device=dev)
            means = ((out[None, :] >> shifts[:, None]) & 1).double().mean(dim=1)
            fig9.append(dict(p_bfr=p, raw=raw, out=out, draw_ms=(t1 - t0) * 1e3,
                             fold_ms=(t2 - t1) * 1e3, bit_means=means.tolist()))
    fig9_launches = launches_now()
    check(fig9_launches["msxor"] > 0, "the Fig. 9 path launched no msxor")
    for row in fig9:
        means = np.array(row.pop("bit_means"))
        raw, out = row.pop("raw"), row.pop("out")
        worst = float(np.abs(means - 0.5).max())
        raw_ones = float(((raw[None] >> torch.arange(32, device=dev)[:, None, None]) & 1)
                         .double().mean())
        check(worst < 0.005, f"Fig. 9 p={row['p_bfr']}: worst bit bias {worst} >= 0.005")
        check(torch.equal(out, xref.msxor_fold_ref(raw, 3)),
              f"Fig. 9 p={row['p_bfr']}: the fold differs from its plain version")
        emit(phase="fig9_msxor", **row, empirical_lambda_mean=float(means.mean()),
             worst_bit_bias=worst, raw_bit_mean=raw_ones,
             debias_error_analytic=msxor.debias_error(row["p_bfr"], 3),
             launches=fig9_launches, small_draw_card_equals_cpu=True)
    args, kw = seen_fig9["msxor"]
    check(tuple(args[0].shape) == (8, FIG9_M), f"the Fig. 9 launch ran {tuple(args[0].shape)}")
    hold_msxor("Fig. 9 path first launch", args[0], kw["n_stages"], kw["to_uniform"],
               record=False)
    del raw, out

    # 10. the macro: the quickstart and Fig. 17 ---------------------------------
    def tv_distance(words, probs):
        counts = np.bincount(np.asarray(words).reshape(-1), minlength=probs.size)
        return float(0.5 * np.abs(counts / counts.sum() - probs).sum())

    def macro_stats(stats):
        return dict(acceptance_rate=stats.acceptance_rate, n_samples=stats.n_samples,
                    n_steps=stats.n_steps, model_28nm_energy_pj=stats.energy_pj,
                    model_28nm_energy_per_sample_pj=stats.energy_per_sample_pj,
                    model_28nm_time_s=stats.modeled_time_s,
                    model_28nm_samples_per_s=stats.throughput_samples_per_s)

    gmm = targets.GaussianMixture.paper_gmm()
    gmm_codec = targets.GridCodec(nbits=8, dim=1, lo=(-10.0,), hi=(10.0,))
    mgd = targets.MultivariateGaussian.paper_mgd()
    mgd_codec = targets.GridCodec(nbits=12, dim=2, lo=(-4.0, -4.0), hi=(4.0, 4.0))
    macro = CIMMacro(MacroConfig(nbits=8, burn_in=500))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts, stats = macro.sample_points(prng.PRNGKey(0, device=dev), gmm, gmm_codec, 50_000)
    wall = time.perf_counter() - t0
    check(pts.shape == (50_000, 1) and bool(np.isfinite(pts).all()), "quickstart: bad points")
    tv = tv_distance(gmm_codec.encode(torch.from_numpy(pts)).numpy(),
                     targets.reference_grid_probs(gmm, gmm_codec))
    check(tv < 0.06, f"quickstart: TV distance {tv} >= 0.06")
    check(0.05 < stats.acceptance_rate < 0.95, f"quickstart: acceptance {stats.acceptance_rate}")
    emit(phase="macro", case="quickstart_gmm_8bit", samples=50_000, burn_in=500,
         tv_distance=tv, card_wall_s=wall, chain_steps_per_s=stats.n_steps / wall,
         **macro_stats(stats))
    for name, density, codec, tv_max in (("gmm", gmm, gmm_codec, 0.05),
                                         ("mgd", mgd, mgd_codec, 0.2)):
        m = CIMMacro(MacroConfig(nbits=codec.nbits, burn_in=500))
        log_prob = targets.discretized_target(density, codec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words, stats = m.sample(prng.PRNGKey(2, device=dev), log_prob, FIG17_N)
        wall = time.perf_counter() - t0
        tv = tv_distance(words, targets.reference_grid_probs(density, codec))
        check(words.shape == (FIG17_N,) and int(words.max()) < 1 << codec.nbits,
              f"fig17 {name}: bad words")
        check(tv < tv_max, f"fig17 {name}: TV distance {tv} >= {tv_max}")
        emit(phase="macro", case=f"fig17_{name}_{codec.nbits}bit", samples=FIG17_N,
             burn_in=500, tv_distance=tv, card_wall_s=wall,
             chain_steps_per_s=stats.n_steps / wall,
             model_28nm_time_s_32bit=energy.time_for_samples_s(FIG17_N, nbits=32),
             **macro_stats(stats))
    runs = [CIMMacro(MacroConfig(nbits=8, burn_in=200), device=d).sample_points(
        prng.PRNGKey(9), gmm, gmm_codec, n_samples=2000) for d in (dev, "cpu")]
    same = np.array_equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    check(same, "macro: the card and the CPU disagree at the JAX test's size")
    emit(phase="macro_small_input", nbits=8, burn_in=200, samples=2000, card_equals_cpu=same,
         acceptance_rate=runs[0][1].acceptance_rate)

    # 11. the gmm workload on the MH kernels ------------------------------------
    gmm_kernel_of = {"cim": "mh_chain", "fused": "mh_chain_fused"}
    gmm_probs = gmm_wl.reference_probs(8)
    for randomness, kernel in gmm_kernel_of.items():
        wl = workloads.build("gmm", prng.PRNGKey(SEED, device=dev), randomness=randomness,
                             backend="pallas")
        check(wl.engine.device.type == "cuda", "the gmm workload's engine is not on the card")
        torch.cuda.synchronize()
        reset_launches()
        with first_launches(mh) as seen:
            t0 = time.perf_counter()
            res = wl.run(prng.PRNGKey(SEED + 1, device=dev))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = launches_now()
        path = f"gmm_{randomness}"
        launches_by_path[path] = launches
        check(launches[kernel] > 0, f"{path} launched no {kernel}")
        args, kw = seen[kernel]
        diff, err, _ = hold(kernel, f"{path} first launch", from_launch(args), kw)
        rate = float(res.acceptance_rate)
        check(0.0 < rate < 1.0, f"{path}: acceptance {rate}")
        kept = res.samples[wl.burn_in:].reshape(-1).cpu().numpy()
        tv = tv_distance(kept, gmm_probs)
        check(tv < 0.08, f"{path}: TV distance {tv} >= 0.08")
        small = {}
        for device in (dev, "cpu"):
            w = workloads.build("gmm", prng.PRNGKey(3), randomness=randomness,
                                backend="pallas", smoke=True, device=device)
            small[str(device)] = w.run(prng.PRNGKey(4))
        a, b = small.values()
        same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                   for f in ("samples", "accept_count", "final_words", "final_logp"))
        check(same, f"{path}: the card and the CPU disagree at smoke size")
        emit(phase="gmm", randomness=randomness, execution="pallas", chains=64,
             n_steps=wl.n_steps, chunk_steps=wl.engine.config.chunk_steps, launches=launches,
             first_launch_mismatches=diff, max_abs_err=err, acceptance_rate=rate,
             tv_distance=tv, seconds=seconds,
             chain_steps_per_s=wl.n_steps * 64 / seconds, smoke_card_equals_cpu=same)
        del wl, res

    # 14-19. the run-state layer: the kernel-level MH entry points,
    # checkpointed resumable runs, checkpoints, telemetry and the chains
    # mesh.  Checkpoints go under build/ (ignored by git) and are removed
    fields = ("samples", "accept_count", "acceptance_rate", "final_words", "final_logp")

    def same_result(a, b):
        return a.n_steps == b.n_steps and all(
            getattr(a, f).dtype == getattr(b, f).dtype and torch.equal(getattr(a, f), getattr(b, f))
            for f in fields)

    ckpt_root = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt_root.mkdir(parents=True)

    # 14. kernel_entry_points: mh_sample_with_rng and sample_tokens_fused
    key = prng.PRNGKey(SEED + 2, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rng_samples, rng_acc = mh_ops.mh_sample_with_rng(key, logits, K, chains=C)
    torch.cuda.synchronize()
    rng_s = time.perf_counter() - t0
    rng_launches = launches_now()
    launches_by_path["kernel_entry_points_mh_sample_with_rng"] = rng_launches
    check(rng_launches["mh_chain"] == 1, f"mh_sample_with_rng launched {rng_launches}")
    rnd = mh_ops.generate_randomness(key, K, B, C, 0.45)
    check(tuple(rnd.u.shape) == (K, B, C) and int(rnd.flips.max()) >= 2**16,
          "generate_randomness did not draw a (K, B, C) block of 32-bit words")
    start = torch.argmax(logits, dim=-1)[:, None].expand(B, C).contiguous()
    block = mh_ops.mh_sample(logits, start, rnd.flips, rnd.u, nbits=16)
    check(torch.equal(block[0], rng_samples) and torch.equal(block[1], rng_acc),
          "mh_sample_with_rng differs from mh_sample on generate_randomness's block")
    diff, err, rate = hold("mh_chain", "mh_sample_with_rng block",
                           (logits, start, rnd.flips, rnd.u, 16), {}, record=False)
    del rnd, block, rng_samples, rng_acc, start
    reset_launches()
    t0 = time.perf_counter()
    tok_f, rate_f = mh_ops.sample_tokens_fused(key, logits, n_steps=K)
    torch.cuda.synchronize()
    tok_s = time.perf_counter() - t0
    tok_launches = launches_now()
    launches_by_path["kernel_entry_points_sample_tokens_fused"] = tok_launches
    check(tok_launches["mh_chain"] > 0, "sample_tokens_fused launched no mh_chain")
    tok_e, res_e = samplers.MHEngine(samplers.EngineConfig(execution="pallas")).sample_tokens(
        key, logits, n_steps=K)
    check(torch.equal(tok_f, tok_e) and torch.equal(rate_f, res_e.acceptance_rate),
          "sample_tokens_fused differs from engine.sample_tokens(execution='pallas')")
    emit(phase="kernel_entry_points", B=B, V=V, C=C, K=K, nbits=16, u_bits=32,
         mh_sample_with_rng_launches=rng_launches, mh_sample_with_rng_s=rng_s,
         equals_mh_sample_on_block=True, plain_mismatches=diff, max_abs_err=err,
         accept_rate=rate, sample_tokens_fused_launches=tok_launches,
         sample_tokens_fused_s=tok_s, sample_tokens_fused_equals_engine=True,
         acceptance_rate=float(rate_f))

    # 15-16. resumable runs: each killed after its second segment and
    # finished by a second call on the same directory, and once
    # uninterrupted under telemetry (the saves' bytes and seconds), both
    # against one unsegmented run at tolerance 0
    class Preempted(Exception):
        pass

    def die_after(segments, every):
        def on_segment(done, total, handle):
            if done == segments * every:
                raise Preempted
        return on_segment

    def resume_phase(path, kernel, eng, plan, run_one, every):
        """(record, the uninterrupted handle) of one resumable path."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = run_one()
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        tr = telemetry.enable()
        reset_launches()
        t0 = time.perf_counter()
        whole = run_resumable(eng, plan, directory=str(ckpt_root / path), every=every)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        launches = launches_now()
        telemetry.disable()
        launches_by_path[path] = launches
        check(launches[kernel] > 0, f"{path} launched no {kernel}")
        saves = [e for e in tr.events() if e.name == "checkpoint.save"]
        segs = [e for e in tr.events() if e.name == "run_resumable.segment"]
        n_seg = -(-int(plan.n_steps) // every)
        check(len(saves) == len(segs) == n_seg, f"{path}: {len(saves)} saves, {len(segs)} "
              f"segment logs for {n_seg} segments")
        check(same_result(whole.result, one), f"{path}: run_resumable != one submit")
        killed = ckpt_root / f"{path}_killed"
        try:
            run_resumable(eng, plan, directory=str(killed), every=every,
                          on_segment=die_after(2, every))
            check(False, f"{path}: the run was not killed")
        except Preempted:
            pass
        check(latest_step(str(killed)) == int(plan.step0) + 2 * every,
              f"{path}: the kill did not follow the second save")
        t0 = time.perf_counter()
        resumed = run_resumable(eng, plan, directory=str(killed), every=every)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        check(same_result(resumed.result, one), f"{path}: killed + resumed != one submit")
        save_bytes = [e.meta["bytes"] for e in saves]
        save_s = [e.dur_us / 1e6 for e in saves]
        # the host's side of the segments' submits (kernels queued, not waited for)
        submit_s = sum(e.dur_us for e in tr.events() if e.name == "engine.submit") / 1e6
        record = dict(
            n_steps=int(plan.n_steps), every=every, segments=n_seg, launches=launches,
            kernel_launches=launches[kernel], unsegmented_s=one_s, resumable_s=whole_s,
            overhead_s=whole_s - one_s, overhead_ratio=whole_s / one_s,
            resumed_after_kill_s=resumed_s, save_bytes=save_bytes, save_s=save_s,
            bytes_written=sum(save_bytes), seconds_in_saves=sum(save_s),
            seconds_in_submits=submit_s,
            seconds_elsewhere=whole_s - sum(save_s) - submit_s,  # copies to the host, waits
            bytes_per_save=sum(save_bytes) / len(saves), seconds_per_save=sum(save_s) / len(saves),
            final_checkpoint_bytes=checkpoint_nbytes(
                str(ckpt_root / path / f"step_{int(plan.step0) + int(plan.n_steps):08d}")),
            killed_after_segments=2, bit_exact=True)
        return record, whole

    resume_runs = {}
    for randomness in ("fused", "cim"):
        eng = samplers.MHEngine(samplers.EngineConfig(randomness=randomness))
        plan = samplers.RunPlan(target=samplers.TableTarget(logits), n_steps=N_STEPS,
                                init_words=init, seed=SEED, collect=RESUME_THIN)
        record, whole = resume_phase(f"resume_mh_{randomness}", kernel_of[randomness], eng, plan,
                                     lambda: eng.submit(plan).result, RESUME_EVERY)
        resume_runs[randomness] = (eng, plan, whole)
        check(tuple(whole.samples.shape) == (N_STEPS // int(RESUME_THIN[5:]), B, C),
              "resume_mh: wrong kept shape")
        emit(phase="resume_mh", randomness=randomness, B=B, V=V, C=C, nbits=16,
             collect=RESUME_THIN, **record)
    wl = workloads.build("ising", prng.PRNGKey(SEED, device=dev), randomness="fused",
                         backend="pallas", beta=BETA, height=LAT, width=LAT, batch=LAT_B,
                         n_steps=N_STEPS, chunk_steps=G_CHUNK, collect=G_RESUME_THIN)
    g_key = prng.PRNGKey(SEED + 1, device=dev)
    record, whole = resume_phase("resume_gibbs", "gibbs_chain_fused", wl.engine, wl.plan(g_key),
                                 lambda: wl.run(g_key), G_RESUME_EVERY)
    check(tuple(whole.samples.shape) == (N_STEPS // int(G_RESUME_THIN[5:]), LAT_B, LAT, LAT),
          "resume_gibbs: wrong kept shape")
    emit(phase="resume_gibbs", workload="ising", randomness="fused", lattice=f"{LAT}x{LAT}",
         B=LAT_B, chunk_steps=G_CHUNK, collect=G_RESUME_THIN, **record)
    del wl, whole

    # 17. checkpoint_roundtrip: RunHandle.save and both loads, a corrupted
    # leaf refused, a plan with another key refused by its fingerprint
    eng, plan, whole = resume_runs["fused"]
    handle = eng.submit(plan.replace(n_steps=256, collect=None))
    directory = str(ckpt_root / "handle")
    t0 = time.perf_counter()
    path = handle.save(directory)
    save_s = time.perf_counter() - t0
    tree, manifest = load_checkpoint_tree(directory, handle.progress, verify=True)
    host_equal = (np.array_equal(tree["words"], handle.final_words.cpu().numpy())
                  and np.array_equal(tree["acc"], handle.accept_count.cpu().numpy())
                  and np.array_equal(tree["logp"], handle.final_logp.cpu().numpy()))
    check(host_equal, "load_checkpoint_tree differs from the saved handle")
    check(manifest["extra"]["fingerprint"] == handle.plan.fingerprint(eng),
          "the saved fingerprint is not the plan's")
    like = {"acc": handle.accept_count, "logp": handle.final_logp, "words": handle.final_words}
    back, _ = load_checkpoint(directory, handle.progress, like, device=dev)
    check(all(back[k].device == v.device and back[k].dtype == v.dtype and torch.equal(back[k], v)
              for k, v in like.items()), "load_checkpoint(device=) differs from the handle")
    leaf = Path(path) / manifest["leaves"][-1]["file"]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0x40
    leaf.write_bytes(bytes(raw))
    try:
        load_checkpoint_tree(directory, handle.progress, verify=True)
        check(False, "a corrupted leaf was read")
    except IOError:
        pass
    try:
        run_resumable(eng, plan.replace(seed=SEED + 7), directory=str(ckpt_root / "resume_mh_fused"),
                      every=RESUME_EVERY)
        check(False, "a plan with another key resumed a checkpoint")
    except ValueError as e:
        check("different run" in str(e), f"unexpected refusal: {e}")
    emit(phase="checkpoint_roundtrip", step=handle.progress, save_s=save_s,
         bytes=checkpoint_nbytes(path), leaves=[(e["key"], e["dtype"], e["shape"])
                                                for e in manifest["leaves"]],
         host_equal=True, device_equal=True, corrupted_leaf_refused=True,
         other_key_refused=True)
    del handle, back, whole

    # 18. telemetry: the stream with telemetry on and off, one span a
    # submit, no wait for the card inside a traced submit, the export
    # validates, the counters count the saves
    eng = samplers.MHEngine(samplers.EngineConfig(randomness="fused"))
    plan = samplers.RunPlan(target=samplers.TableTarget(logits), n_steps=N_STEPS,
                            init_words=init, seed=SEED)
    off = eng.submit(plan).result
    real_sync, waits = torch.cuda.synchronize, []
    torch.cuda.synchronize = lambda *a, **k: (waits.append(1), real_sync(*a, **k))[1]
    tr = telemetry.enable()
    try:
        on = eng.submit(plan).result
    finally:
        torch.cuda.synchronize = real_sync
    check(not waits, f"a traced submit waited for the card {len(waits)} times")
    check(same_result(on, off), "the stream differs with telemetry on")
    wall = {"off": [], "on": []}
    for _ in range(TELEMETRY_REPS):
        for mode in ("off", "on"):
            telemetry.TRACER.enabled = mode == "on"  # enable() would clear the trace
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.submit(plan)
            torch.cuda.synchronize()
            wall[mode].append((time.perf_counter() - t0) * 1e3)
    spans = [e for e in tr.events() if e.name == "engine.submit"]
    check(len(spans) == 1 + TELEMETRY_REPS, f"{len(spans)} engine.submit spans for "
          f"{1 + TELEMETRY_REPS} traced submits")
    trace_path = str(ckpt_root / "run.trace.jsonl")
    telemetry.REGISTRY.reset()
    run_resumable(eng, plan, directory=str(ckpt_root / "telemetry"), every=RESUME_EVERY)
    n_events = tr.export_jsonl(trace_path)
    problems = telemetry.validate_jsonl(trace_path)
    telemetry.disable()
    check(problems == [], f"the exported trace is invalid: {problems[:3]}")
    saves_total = telemetry.REGISTRY.counter("checkpoint_saves_total").value()
    segments_total = telemetry.REGISTRY.counter("resume_segments_total").value()
    n_saves = N_STEPS // RESUME_EVERY
    check(saves_total == segments_total == n_saves, f"counters {saves_total}, {segments_total} "
          f"for {n_saves} saves")
    med = {m: sorted(v)[len(v) // 2] for m, v in wall.items()}
    emit(phase="telemetry", randomness="fused", B=B, V=V, C=C, n_steps=N_STEPS,
         bit_identical_on_off=True, waits_in_traced_submit=len(waits),
         engine_submit_spans=len(spans), span_enqueue_ms_median=sorted(
             e.dur_us / 1e3 for e in spans)[len(spans) // 2],
         submit_wall_ms_median_off=med["off"], submit_wall_ms_median_on=med["on"],
         submit_wall_ms_off=wall["off"], submit_wall_ms_on=wall["on"],
         trace_events=n_events, trace_valid=True, checkpoint_saves_total=saves_total,
         resume_segments_total=segments_total, saves_made=n_saves)
    del off, on

    # 19. chains_mesh: a one-rank nccl DeviceMesh shards num_chains=4
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    check(tmesh.make_chains_mesh() is None, "make_chains_mesh() built a mesh on one card")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=dev)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        spec = sharding.spec_for(("chains",), shape=(4,), mesh=mesh)
        check(spec == ("data",), f"the chains rule resolved to {spec}")
        check(tmesh.make_chains_mesh() is None and tmesh.mesh_chip_count(mesh) == 1,
              "make_chains_mesh() built a mesh on one rank")
        cfg = samplers.EngineConfig(randomness="fused", num_chains=4)
        plan = samplers.RunPlan(target=samplers.TableTarget(logits), n_steps=256,
                                init_words=init.expand(4, B, C), seed=SEED)
        unsharded = samplers.MHEngine(cfg).submit(plan).result
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samplers.MHEngine(cfg).submit(plan)
        torch.cuda.synchronize()
        unsharded_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        sharded = samplers.MHEngine(cfg).submit(plan.replace(mesh=mesh)).result
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        launches = launches_now()
        launches_by_path["chains_mesh"] = launches
        check(launches["mh_chain_fused"] > 0, "the sharded run launched no mh_chain_fused")
        check(same_result(sharded, unsharded), "the sharded run differs from the unsharded one")
    finally:
        dist.destroy_process_group()
    emit(phase="chains_mesh", backend="nccl", ranks=1, mesh_dims=["data"], spec=list(spec),
         num_chains=4, B=B, V=V, C=C, kernel_C=4 * C, n_steps=256, launches=launches,
         seconds=mesh_s, unsharded_seconds=unsharded_s, equals_unsharded=True,
         make_chains_mesh_one_card=None)
    del unsharded, sharded
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # 38. compiled_submit: submit(compiled=True) captures a CUDA graph once
    # per signature and replays it after that
    def compiled_case(case, eng, plan, other, kernel, match):
        """One direct submit, then three compiled ones (the third on
        another key: the same signature); a direct submit on that key."""
        counter = (mh if kernel.startswith("mh") else gk).LAUNCHES

        def timed(fn):
            torch.cuda.synchronize()
            n0 = counter[kernel]
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, counter[kernel] - n0

        direct, direct_s, direct_n = timed(lambda: eng.submit(plan).result)
        tr = telemetry.enable()
        runs = [timed(lambda p=p: eng.submit(p, compiled=True).result)
                for p in (plan, plan, other)]
        verdicts = [e.meta.get("jit_cache") for e in tr.events() if e.name == "engine.submit"]
        telemetry.disable()
        kept = [{f: getattr(r, f).clone() for f in fields} for r, _, _ in runs[:2]]
        other_direct = eng.submit(other).result
        check(verdicts == ["miss", "hit", "hit"], f"{case}: jit_cache verdicts {verdicts}")
        check(all(same_result(r, direct) for r, _, _ in runs[:2]),
              f"{case}: a compiled submit differs from the direct one")
        check(same_result(runs[2][0], other_direct),
              f"{case}: the replay on another key differs from the direct submit")
        check(not torch.equal(runs[2][0].final_words, direct.final_words),
              f"{case}: another key gave the same final words")
        check(all(torch.equal(k[f], getattr(r, f)) for k, (r, _, _) in zip(kept, runs)
                  for f in fields), f"{case}: a later replay changed a returned result")
        check([n for _, _, n in runs] == [direct_n] * 3,
              f"{case}: {kernel} counted {[n for _, _, n in runs]}, direct {direct_n}")
        busy = {}
        calls = []
        for mode, fn, host in (("direct", lambda: eng.submit(plan), None),
                               ("replay", lambda: eng.submit(plan, compiled=True), calls)):
            # the CUDA runtime's calls only: with PyTorch's operators traced
            # too, a direct cim run's trace matched 19 MH kernels to its 16
            # launches
            events, wall_ms = traced(torch, fn, match, lambda: counter[kernel],
                                     host_calls=host)
            busy[mode] = sum(e.self_device_time_total for e in events) / 1e3 / wall_ms
        graph_launches = sum(n == "cudaGraphLaunch" for n in calls)
        kernel_calls = sorted({n for n in calls if "Launch" in n and n != "cudaGraphLaunch"})
        check(graph_launches == 1 and not kernel_calls,
              f"{case}: a replay made {graph_launches} graph launches and {kernel_calls}")
        ((sig, program),) = eng._compiled.items()
        emit(phase="compiled_submit", case=case, verdicts=verdicts, bit_equal_direct=True,
             first_results_unchanged=True, direct_s=direct_s, capture_s=runs[0][1],
             replay_s=[runs[1][1], runs[2][1]], direct_busy_share=busy["direct"],
             replay_busy_share=busy["replay"], launches_direct=direct_n,
             launches_per_submit=[n for _, _, n in runs], replay_graph_launches=graph_launches,
             replay_kernel_launch_calls=len(kernel_calls),
             replay_memcpy_calls=sum(n == "cudaMemcpyAsync" for n in calls),
             replay_syncs=sum("Synchronize" in n for n in calls), entry_bytes=program.nbytes,
             signature={k: v for k, v in sig._asdict().items() if k not in ("target", "mesh")})
        launches_by_path[f"compiled_submit_{case}"] = {kernel: direct_n}

    gc.collect()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_allocated(dev)
    mh_plan = samplers.RunPlan(target=samplers.TableTarget(logits), n_steps=N_STEPS,
                               init_words=init, seed=SEED)
    for randomness in ("cim", "fused"):
        compiled_case(f"mh_{randomness}", samplers.MHEngine(
            samplers.EngineConfig(randomness=randomness)), mh_plan,
            mh_plan.replace(seed=SEED + 7), kernel_of[randomness], "mh_chain_kernel")
    wl = workloads.build("ising", prng.PRNGKey(SEED, device=dev), randomness="fused",
                         backend="pallas", beta=BETA, **main_kw)
    g_plan = wl.plan(prng.PRNGKey(SEED + 1, device=dev))
    compiled_case("gibbs_ising_fused", wl.engine, g_plan,
                  g_plan.replace(key=prng.PRNGKey(SEED + 7, device=dev)), "gibbs_chain_fused",
                  "gibbs_band_kernel")
    del wl
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=dev)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
        # a contiguous init: an expanded one is copied into the graph's input by a kernel
        m_plan = samplers.RunPlan(target=samplers.TableTarget(logits), n_steps=256,
                                  init_words=init.expand(4, B, C).contiguous(), seed=SEED,
                                  mesh=mesh)
        compiled_case("chains_mesh", samplers.MHEngine(samplers.EngineConfig(
            randomness="fused", num_chains=4)), m_plan, m_plan.replace(seed=SEED + 7),
            "mh_chain_fused", "mh_chain_kernel")
    finally:
        dist.destroy_process_group()
    del mh_plan, g_plan, m_plan, mesh  # the plans hold their init words
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="compiled_submit_memory", allocated_before=held0,
         allocated_after_engines_dropped=torch.cuda.memory_allocated(dev),
         bytes_left=torch.cuda.memory_allocated(dev) - held0)

    # 20. tempering_gibbs: replica exchange on the full-width spin glass ---------
    from repro_torch import serving, tempering
    from repro_torch.workloads.spin_glass import SpinGlass, exhaustive_ground_state

    def scaled_spec(args, kw):  # a Gibbs launch of a tempered replica
        return next(a for a in args if hasattr(a, "scale")).scale != 1.0

    def same_words(a, b):
        return a.shape == b.shape and torch.equal(a, b)

    glass_wl = workloads.build("spin_glass", prng.PRNGKey(SEED, device=dev), randomness="fused",
                               backend="pallas", height=LAT, width=LAT, batch=LAT_B,
                               collect=T_THIN, chunk_steps=T_SWAP)
    glass = glass_wl.target
    ladder = tempering.Ladder.geometric(T_REPLICAS, 0.25, 1.0)
    rex = tempering.ReplicaExchange(ladder, glass_wl.engine, swap_every=T_SWAP)
    t_init = glass_wl.init_words.expand(T_REPLICAS, *glass_wl.init_words.shape)
    tkey = prng.PRNGKey(SEED + 2, device=dev)
    rex.run(tkey, glass, T_STEPS, t_init)  # the first run makes the scaled targets
    torch.cuda.synchronize()
    reset_launches()
    with first_launches(gk, pick=scaled_spec) as seen:
        t0 = time.perf_counter()
        tres = rex.run(tkey, glass, T_STEPS, t_init)
        torch.cuda.synchronize()
        t_seconds = time.perf_counter() - t0
    launches = launches_now()
    launches_by_path["tempering_gibbs"] = launches
    segments = T_REPLICAS * (T_STEPS // T_SWAP)
    groups = gk.plan_groups(LAT_B, LAT, LAT, **gk.band_limits(dev.index, LAT))
    check(launches["gibbs_chain_fused"] == segments * len(groups),
          f"tempering_gibbs: {launches['gibbs_chain_fused']} band launches for {segments} "
          f"segments of {len(groups)} group(s)")
    args, kw = seen["gibbs_chain_fused"]
    diff, err, _ = hold("gibbs_chain_fused", "tempering_gibbs first scaled launch",
                        from_launch(args), kw, record=False)
    kept = T_STEPS // 64
    check(tuple(tres.samples.shape) == (T_REPLICAS, kept, LAT_B, LAT, LAT),
          f"tempering_gibbs samples {tuple(tres.samples.shape)}")
    check(bool(((tres.final_words == 0) | (tres.final_words == 1)).all()), "a spin not 0/1")
    check(bool(torch.isfinite(tres.final_logp).all()), "non-finite tempered final_logp")
    summary = tres.swap.summary()
    check(summary["swap_events"] == T_STEPS // T_SWAP - 1, f"swap events {summary}")
    # CUDA activity only: with the host's operators traced too, their ids
    # matched some of the lead run's kernels (155 band kernels for 128
    # launches in the first try)
    events, wall_ms = traced(torch, lambda: rex.run(tkey, glass, T_STEPS, t_init),
                             "gibbs_band_kernel", lambda: gk.LAUNCHES["gibbs_chain_fused"])
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    band_ms = sum(e.self_device_time_total for e in events if "gibbs_band" in e.name) / 1e3
    # a 1-replica ladder is a plain submit
    one = tempering.ReplicaExchange(tempering.Ladder((1.0,)), glass_wl.engine,
                                    swap_every=T_SWAP).run(tkey, glass, T_STEPS,
                                                           glass_wl.init_words[None])
    plain = glass_wl.engine.submit(glass_wl.plan(tkey, n_steps=T_STEPS)).result
    one_ok = all(same_words(getattr(one, f)[0], getattr(plain, f))
                 for f in ("samples", "accept_count", "final_words"))
    check(one_ok, "tempering_gibbs: a 1-replica ladder differs from a plain submit")
    emit(phase="tempering_gibbs", workload="spin_glass", randomness="fused", execution="pallas",
         lattice=f"{LAT}x{LAT}", B=LAT_B, replicas=T_REPLICAS, betas=list(ladder.betas),
         n_steps=T_STEPS, swap_every=T_SWAP, collect=T_THIN, seconds=t_seconds,
         site_steps_per_s=T_REPLICAS * T_STEPS * LAT_B * LAT * LAT / t_seconds,
         submits=segments, launches=launches, band_launches_per_segment=len(groups),
         first_scaled_launch_scale=args[4].scale, first_scaled_launch_mismatches=diff,
         max_abs_err=err, swap=summary, flip_rate=float(tres.acceptance_rate),
         profiled_wall_ms=wall_ms, device_busy_ms=busy_ms, band_kernel_ms=band_ms,
         device_busy_share=busy_ms / wall_ms, one_replica_equals_plain=one_ok)
    del tres, one, plain

    # the scaled band kernel's first launch on the other (draw, logit) pairs,
    # through tempered runs at 256 x 256
    for name, randomness in (("ising", "host"), ("ising", "fused"), ("spin_glass", "host")):
        wl = workloads.build(name, prng.PRNGKey(SEED, device=dev), randomness=randomness,
                             backend="pallas", height=OP_LAT, width=OP_LAT, batch=2,
                             chunk_steps=OP_CHUNK, **({"beta": BETA} if name == "ising" else {}))
        small_rex = tempering.ReplicaExchange(tempering.Ladder.geometric(4, 0.25, 1.0),
                                              wl.engine, swap_every=OP_CHUNK)
        kernel = g_kernel_of[randomness]
        reset_launches()
        with first_launches(gk, pick=scaled_spec) as seen:
            res = small_rex.run(tkey, wl.target, 4 * OP_CHUNK,
                                wl.init_words.expand(4, *wl.init_words.shape))
        launches = launches_now()
        launches_by_path[f"tempering_{name}_{randomness}"] = launches
        check(launches[kernel] == 16, f"tempering {name} {randomness}: {launches}")
        args, kw = seen[kernel]
        diff, err, _ = hold(kernel, f"tempering {name} {randomness} first scaled launch",
                            from_launch(args), kw, record=False)
        emit(phase="tempering_first_scaled_launch", workload=name, randomness=randomness,
             kernel=kernel, lattice=f"{OP_LAT}x{OP_LAT}", B=2, replicas=4,
             n_steps=4 * OP_CHUNK, launches=launches, mismatches=diff, max_abs_err=err,
             swap=res.swap.summary())
        del wl, res

    # the scaled specialisations beside the unscaled ones, on the same
    # operands at the full width (timed in phase 12)
    for glass_logit in (False, True):
        logit = lattice_logit(torch, gref, gen, LAT, LAT, glass_logit)
        scaled = dataclasses.replace(logit, scale=T_SCALE)
        init_ = torch.randint(0, 2, (LAT_B, LAT, LAT), generator=gen, device=dev)
        u = operand_uniforms(torch, gen, (OP_CHUNK, LAT_B, LAT, LAT))
        parity0 = torch.arange(LAT_B, device=dev) % 2
        k0b, k1b = (torch.randint(0, 2**32, (LAT_B,), generator=gen, device=dev)
                    for _ in range(2))
        t0b = torch.tensor([0, 1, 16, 33], device=dev)
        where = f"1024x1024 B=4 K=16 {'spin glass' if glass_logit else 'ising'}"
        d = [hold("gibbs_chain", f"{where} scale {T_SCALE}", (init_, u, scaled, parity0), {})[0]]
        for spec, tag in ((scaled, f"scale {T_SCALE}"), (logit, "scale 1")):
            d.append(hold("gibbs_chain_fused", f"{where} {tag}", (init_, k0b, k1b, t0b, spec),
                          dict(n_steps=OP_CHUNK, lat_b=LAT_B))[0])
        emit(phase="scaled_band_kernel", lattice=where, scale=T_SCALE,
             mismatches={"gibbs_chain scaled": d[0], "gibbs_chain_fused scaled": d[1],
                         "gibbs_chain_fused unscaled": d[2]})
        del init_, u

    # 21. tempering_mh: replica exchange on the granite-3 8B table ------------
    base_table = samplers.TableTarget(logits)
    mh_eng = samplers.MHEngine(samplers.EngineConfig(randomness="fused", collect=T_MH_THIN))
    mh_ladder = tempering.Ladder.geometric(T_MH_REPLICAS, 0.25, 1.0)
    mrex = tempering.ReplicaExchange(mh_ladder, mh_eng, swap_every=T_MH_SWAP)
    m_init = init.expand(T_MH_REPLICAS, B, C)
    mrex.run(tkey, base_table, N_STEPS, m_init)
    torch.cuda.synchronize()
    reset_launches()
    with first_launches(mh, pick=lambda a, k: a[0].data_ptr() != logits.data_ptr()) as seen:
        t0 = time.perf_counter()
        mres = mrex.run(tkey, base_table, N_STEPS, m_init)
        torch.cuda.synchronize()
        m_seconds = time.perf_counter() - t0
    launches = launches_now()
    launches_by_path["tempering_mh"] = launches
    m_segments = T_MH_REPLICAS * (N_STEPS // T_MH_SWAP)
    check(launches["mh_chain_fused"] == m_segments,
          f"tempering_mh: {launches['mh_chain_fused']} launches for {m_segments} segments")
    args, kw = seen["mh_chain_fused"]
    diff, err, _ = hold("mh_chain_fused", "tempering_mh first scaled launch", args, kw,
                        record=False)
    check(bool((mres.final_words < V).all()) and bool(torch.isfinite(mres.final_logp).all()),
          "tempering_mh: a final state outside the table")
    m_summary = mres.swap.summary()
    one = tempering.ReplicaExchange(tempering.Ladder((1.0,)), mh_eng, swap_every=T_MH_SWAP).run(
        tkey, base_table, N_STEPS, init[None])
    plain = mh_eng.submit(samplers.RunPlan(target=base_table, n_steps=N_STEPS, init_words=init,
                                           key=tkey)).result
    one_ok = all(same_words(getattr(one, f)[0], getattr(plain, f))
                 for f in ("samples", "accept_count", "final_words", "final_logp"))
    check(one_ok, "tempering_mh: a 1-replica ladder differs from a plain submit")
    emit(phase="tempering_mh", B=B, V=V, C=C, randomness="fused", execution="pallas",
         replicas=T_MH_REPLICAS, betas=list(mh_ladder.betas), n_steps=N_STEPS,
         swap_every=T_MH_SWAP, collect=T_MH_THIN, seconds=m_seconds,
         chain_steps_per_s=T_MH_REPLICAS * N_STEPS * B * C / m_seconds, submits=m_segments,
         launches=launches, first_scaled_launch_mismatches=diff, max_abs_err=err,
         swap=m_summary, acceptance_rate=float(mres.acceptance_rate),
         one_replica_equals_plain=one_ok)
    del mres, one, plain

    # a reduced exchange on the card against the same run on the CPU port,
    # each asserted free of tie events first
    for what in ("spin_glass", "table"):
        runs = {}
        for device in ("cpu", "cuda"):
            if what == "spin_glass":
                target = SpinGlass.bimodal(prng.PRNGKey(1, device=device), 32, 32)
                ini = target.random_init(prng.PRNGKey(2, device=device), 2)
                cfg = samplers.EngineConfig(update="gibbs", randomness="fused",
                                            execution="pallas", chunk_steps=16)
            else:
                cpu_gen = torch.Generator().manual_seed(SEED)
                target = samplers.TableTarget(
                    (torch.randn(4, 300, generator=cpu_gen) * 3).to(device))
                ini = torch.randint(0, 300, (4, 16), generator=cpu_gen).to(device)
                cfg = samplers.EngineConfig(randomness="fused", execution="pallas",
                                            chunk_steps=16)
            beta_min = 0.95 if what == "spin_glass" else 0.7  # swaps that accept
            rx = tempering.ReplicaExchange(tempering.Ladder.geometric(4, beta_min, 1.0),
                                           samplers.MHEngine(cfg, device=device),
                                           swap_every=16)
            args_ = (prng.PRNGKey(5), target, 64, ini.expand(4, *ini.shape))
            if device == "cpu":
                ties = rx.tie_events(*args_)
                check(ties == {"moves": 0, "swaps": 0}, f"tie events {ties} ({what})")
            runs[device] = rx.run(*args_)
        fields = ("samples", "accept_count", "final_words", "final_logp")
        same = all(torch.equal(getattr(runs["cuda"], f).cpu(), getattr(runs["cpu"], f))
                   for f in fields)
        sw = [runs[d].swap for d in ("cuda", "cpu")]
        same_swaps = all(np.array_equal(getattr(sw[0], f), getattr(sw[1], f))
                         for f in ("attempts", "accepts", "events", "round_trips"))
        check(same and same_swaps, f"tempered {what}: the card and the CPU disagree")
        emit(phase="tempering_card_equals_cpu", target=what, replicas=4, n_steps=64,
             tie_events=0, card_equals_cpu=True, swap=sw[0].summary())
    del runs

    # 22. anneal: the geometric schedule on the full-width spin glass --------
    annealer = tempering.Annealer.geometric(8, 32, 0.25, 4.0)
    reset_launches()
    t0 = time.perf_counter()
    ares = annealer.run(tkey, glass, glass_wl.init_words, engine=glass_wl.engine)
    torch.cuda.synchronize()
    a_seconds = time.perf_counter() - t0
    launches = launches_now()
    launches_by_path["anneal"] = launches
    check(launches["gibbs_chain_fused"] > 0, "anneal launched no gibbs_chain_fused")
    check(torch.equal(glass.energy(ares.best_words), ares.best_energy),
          "the annealer's best words do not give its best energy")
    init_energy = glass.energy(glass_wl.init_words)
    check(bool((ares.best_energy < init_energy).all()), "annealing found nothing better")
    m4 = SpinGlass.bimodal(prng.PRNGKey(1, device=dev), 4, 4)
    i4 = m4.random_init(prng.PRNGKey(2, device=dev), 2)
    ground, _ = exhaustive_ground_state(m4)
    r4 = tempering.Annealer.geometric(8, 32, 0.4, 4.0).run(
        prng.PRNGKey(0, device=dev), m4, i4, engine=samplers.MHEngine(samplers.EngineConfig(
            update="gibbs", randomness="fused", execution="pallas", chunk_steps=16)))
    best4 = float(r4.best_energy.min())
    check(best4 == ground, f"4x4 anneal best {best4} != exhaustive ground {ground}")
    emit(phase="anneal", workload="spin_glass", lattice=f"{LAT}x{LAT}", B=LAT_B,
         betas=list(annealer.betas), steps_per_beta=32, seconds=a_seconds, launches=launches,
         best_energy=ares.best_energy.tolist(), init_energy=init_energy.tolist(),
         energy_per_site=(ares.best_energy / (LAT * LAT)).tolist(),
         acceptance_rate=float(ares.acceptance_rate), small_4x4_best=best4,
         small_4x4_exhaustive_ground=ground)
    del ares

    # 23. serving: a packed burst of gmm and ising requests --------------------
    s_kw = {"height": LAT, "width": LAT, "batch": S_BATCH}

    def burst():
        return ([serving.ServeRequest(rid=i, workload="gmm", seed=100 + i, t_arrive=0.004 * i)
                 for i in range(S_GMM)]
                + [serving.ServeRequest(rid=S_GMM + j, workload="ising", n_steps=256 + 32 * j,
                                        seed=200 + j, collect="thin:64",
                                        t_arrive=0.002 + 0.006 * j)
                   for j in range(S_ISING)])

    def serve(randomness, smoke, wkw, reqs, copy=None):
        """A scheduler serving ``reqs``; the kernel launches of every
        advance_chunk of a class with an occupied slot are recorded.
        ``copy`` stands in for the executor's host copy (the blocking
        comparison)."""
        sched = serving.Scheduler(n_slots=4, randomness=randomness, execution="pallas",
                                  smoke=smoke, workload_kwargs=wkw)
        per_chunk = {}
        for name in ("gmm", "ising"):
            ex = sched.executor_for(name)
            real, per_chunk[name] = ex.advance_chunk, []

            def counted(real=real, out=per_chunk[name], ex=ex):
                if not ex.active_count:  # an idle class advances nothing
                    return real()
                n0 = sum(launches_now().values())
                done = real()
                out.append(sum(launches_now().values()) - n0)
                return done
            ex.advance_chunk = counted
        saved = serving.executor.to_host
        if copy is not None:
            serving.executor.to_host = copy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = sched.serve(reqs)
            seconds = time.perf_counter() - t0
        finally:
            serving.executor.to_host = saved
        return sched, done, per_chunk, seconds

    def solo(req, randomness, smoke, wkw):
        k_init, k_run = prng.split(prng.PRNGKey(req.seed, device=dev))
        wl = workloads.build(req.workload, k_init, randomness=randomness, backend="pallas",
                             smoke=smoke, **(wkw if req.workload == "ising" else {}))
        return wl.engine.run(k_run, wl.target, req.n_steps or wl.n_steps, wl.init_words,
                             collect=req.collect)

    def served_equals_solo(done, randomness, smoke, wkw):
        for req in done:
            ref_ = solo(req, randomness, smoke, wkw)
            ok = (np.array_equal(req.samples, ref_.samples.cpu().numpy())
                  and np.array_equal(req.final_words, ref_.final_words.cpu().numpy())
                  and np.array_equal(req.accept_count, ref_.accept_count.cpu().numpy())
                  and np.array_equal(req.final_logp, ref_.final_logp.cpu().numpy()))
            check(ok, f"served request {req.rid} ({req.workload}, seed {req.seed}) != its "
                  "solo run")
        return True

    reset_launches()
    sched, done, per_chunk, cold_s = serve("fused", False, s_kw, burst())
    launches_by_path["serving"] = launches_now()
    check(len(done) == S_GMM + S_ISING, f"served {len(done)} requests")
    check(all(n == 1 for v in per_chunk.values() for n in v),
          f"packed chunks launched {per_chunk}, not one kernel each")
    exact = served_equals_solo(done, "fused", False, s_kw)
    reused = len({(r.workload, r.slot) for r in done}) < len(done)
    check(reused, "no slot was reused")
    # warm: the port's copies (pinned, non_blocking, an event), then a
    # blocking copy at the same place, then the port's again
    timing = {}
    for mode in ("async", "blocking", "async"):
        tr = telemetry.enable()
        _, again, _, secs = serve("fused", False, s_kw, burst(),
                                  copy=(lambda t: serving.dispatch.HostCopy(t.cpu()))
                                  if mode == "blocking" else None)
        spans = tr.events()
        telemetry.disable()
        timing.setdefault(mode, []).append(dict(
            seconds=secs, latency=serving.latency_summary(again),
            finalize_ms=sum(e.dur_us for e in spans if e.name == "serving.finalize") / 1e3,
            stall_ms=sum(e.dur_us for e in spans if e.name == "serving.pipeline_stall") / 1e3))
        same = {r.rid: r for r in again}
        check(all(np.array_equal(same[r.rid].samples, r.samples)
                  and np.array_equal(same[r.rid].final_words, r.final_words) for r in done),
              f"a warm {mode} burst differs from the first")
    emit(phase="serving", randomness="fused", execution="pallas", n_slots=4,
         requests={"gmm": S_GMM, "ising": S_ISING}, ising=s_kw, ising_n_steps=[256, 480],
         ising_collect="thin:64", gmm_defaults={"chains": 64, "n_steps": 2048},
         shape_classes=sched.shape_classes, chunks=[len(v) for v in per_chunk.values()],
         kernel_launches_per_chunk={k: sorted(set(v)) for k, v in per_chunk.items()},
         launches=launches_by_path["serving"], served_equals_solo=exact, slots_reused=reused,
         cold_seconds=cold_s, latency=serving.latency_summary(done), warm=timing,
         advance_signatures=sched.compiled_programs)
    del sched, done

    # one cim class at smoke size, against the solo runs
    cim_reqs = [serving.ServeRequest(rid=0, workload="gmm", n_steps=24, seed=1, collect="all"),
                serving.ServeRequest(rid=1, workload="ising", n_steps=20, seed=2, collect="all",
                                     t_arrive=0.001),
                serving.ServeRequest(rid=2, workload="gmm", n_steps=16, seed=3,
                                     collect="thin:4", t_arrive=0.002),
                serving.ServeRequest(rid=3, workload="ising", n_steps=12, seed=4,
                                     collect="last", t_arrive=0.003)]
    reset_launches()
    sched, done, per_chunk, secs = serve("cim", True, {}, cim_reqs)
    launches_by_path["serving_cim"] = launches_now()
    check(all(n == 1 for v in per_chunk.values() for n in v),
          f"cim packed chunks launched {per_chunk}")
    exact = served_equals_solo(done, "cim", True, {})
    emit(phase="serving_cim", randomness="cim", execution="pallas", smoke=True,
         requests=len(done), launches=launches_now(), seconds=secs, served_equals_solo=exact,
         kernel_launches_per_chunk={k: sorted(set(v)) for k, v in per_chunk.items()})
    del sched, done, glass_wl, glass, rex

    # 41. compiled_serving: the kernel advances' programs against their eager body
    from repro_torch import compiled as adv_compiled

    def instrument(sched, eager):
        """Record each class's advance calls (signature, step bases, hit or
        capture, host seconds) and each chunk's host seconds and kernel
        launches; with ``eager`` the class's advance is its eager body."""
        rec = {}
        for name in ("gmm", "ising"):
            ex = sched.executor_for(name)
            programs = ex._advance.programs
            real_adv = ex._advance.eager if eager else ex._advance
            real_chunk = ex.advance_chunk
            r = rec[name] = dict(calls=[], chunk_s=[], launches=[], programs=programs)

            def advance(words, keys, step0s, *, seg, collect, real=real_adv, r=r):
                hit = (seg, collect) in r["programs"]
                t0 = time.perf_counter()
                out = real(words, keys, step0s, seg=seg, collect=collect)
                r["calls"].append(dict(sig=(seg, collect), step0s=step0s.tolist(), hit=hit,
                                       host_s=time.perf_counter() - t0))
                return out

            def chunk(real=real_chunk, ex=ex, r=r):
                if not ex.active_count:  # an idle class advances nothing
                    return real()
                n0 = sum(launches_now().values())
                t0 = time.perf_counter()
                done = real()
                r["chunk_s"].append(time.perf_counter() - t0)
                r["launches"].append(sum(launches_now().values()) - n0)
                return done

            if not eager:
                advance.programs = programs  # advance_compiles reads it
            ex._advance, ex.advance_chunk = advance, chunk
        return rec

    def timed_serve(sched, reqs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.serve(reqs)
        seconds = time.perf_counter() - t0
        return seconds

    def compiled_serving_case(case, randomness, smoke, wkw, make_reqs, trace_steps):
        """``make_reqs()`` on 4 slots a class, through the programs and
        through the eager body, one scheduler a path, in turns: programs
        cold, eager cold, programs warm, eager warm; then a chunk of each
        class traced on each path, twice, with 4 requests of
        ``trace_steps`` steps in its slots."""
        runs = {}
        for path in ("programs", "eager"):
            sched = serving.Scheduler(n_slots=4, randomness=randomness, execution="pallas",
                                      smoke=smoke, workload_kwargs=wkw)
            runs[path] = dict(sched=sched, rec=instrument(sched, path == "eager"),
                              captures=[], seconds={}, served={})
        real_capture = adv_compiled.capture

        def capture(fn, inputs, device, what, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_capture(fn, inputs, device, what, *args, **kw)
            torch.cuda.synchronize()
            runs["programs"]["captures"].append((what, time.perf_counter() - t0))
            return out

        adv_compiled.capture = capture
        try:
            for burst in ("cold", "warm"):
                for path, run in runs.items():
                    reqs = make_reqs()
                    torch.cuda.synchronize()
                    counted = burst == "cold" and path == "programs"
                    if counted:
                        reset_launches()
                    run["seconds"][burst] = timed_serve(run["sched"], reqs)
                    torch.cuda.synchronize()
                    if counted:
                        launches_by_path[f"compiled_serving_{case}"] = launches_now()
                    run["served"][burst] = reqs
        finally:
            adv_compiled.capture = real_capture
        fields = ("samples", "final_words", "accept_count", "final_logp")
        for path, run in runs.items():
            where = f"compiled_serving {case} {path}"
            rec = run["rec"]
            check(all(n == 1 for v in rec.values() for n in v["launches"]),
                  f"{where}: chunks launched {[v['launches'] for v in rec.values()]}")
            for a, b in zip(run["served"]["cold"], run["served"]["warm"]):
                check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields),
                      f"{where}: request {a.rid} differs between the cold and warm bursts")
        for burst in ("cold", "warm"):
            for a, b in zip(runs["programs"]["served"][burst], runs["eager"]["served"][burst]):
                check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields),
                      f"compiled_serving {case}: request {a.rid} ({burst}) differs from its "
                      "eager twin")
        run = runs["programs"]
        for name, v in run["rec"].items():
            sigs = {c["sig"] for c in v["calls"]}
            check(len(v["programs"]) == len(sigs)
                  and all(p.graph is not None for p in v["programs"].values()),
                  f"compiled_serving {case} {name}: {len(v['programs'])} programs for {sigs}")
            check(sum(not c["hit"] for c in v["calls"]) == len(sigs),
                  f"compiled_serving {case} {name}: captured more than once a signature")
        check(run["sched"].compiled_programs == sum(len(v["programs"])
                                                    for v in run["rec"].values()),
              f"compiled_serving {case}: {run['sched'].compiled_programs} signatures counted")
        exact = served_equals_solo(run["served"]["cold"], randomness, smoke, wkw)
        # a replay at other step bases than its capture's, after a mid-flight join
        captured_at, rejoined = {}, 0
        for name, v in run["rec"].items():
            for c in v["calls"]:
                if not c["hit"]:
                    captured_at[(name, c["sig"])] = c["step0s"]
                elif (c["step0s"] != captured_at[(name, c["sig"])] and 0 in c["step0s"]
                      and max(c["step0s"]) > 0):
                    rejoined += 1
        paths = {}
        for path, run in runs.items():
            per_class = {}
            for name, v in run["rec"].items():
                # a chunk of a known signature: a replay, or an eager chunk
                # after the signature's first
                seen, known = set(), []
                for c, chunk_s in zip(v["calls"], v["chunk_s"]):
                    if c["hit"] if path == "programs" else c["sig"] in seen:
                        known.append((chunk_s, c["host_s"]))
                    seen.add(c["sig"])
                per_class[name] = dict(
                    chunks=len(v["calls"]), known_signature_chunks=len(known),
                    signatures=sorted({c["sig"] for c in v["calls"]}),
                    kernel_launches_per_chunk=sorted(set(v["launches"])),
                    chunk_host_s_median=float(np.median([k[0] for k in known])),
                    advance_host_s_median=float(np.median([k[1] for k in known])),
                    advance_host_s_range=[min(k[1] for k in known), max(k[1] for k in known)])
                if path == "programs":
                    per_class[name].update(
                        programs=len(v["programs"]),
                        program_bytes={f"{k[0]},{k[1]}": p.nbytes
                                       for k, p in v["programs"].items()})
            paths[path] = dict(cold_burst_s=run["seconds"]["cold"],
                               warm_burst_s=run["seconds"]["warm"],
                               capture_s=run["captures"], classes=per_class)
        # one chunk of each class traced on each path, twice, the paths in
        # turns (the first trace of a run pays for new pinned host blocks);
        # its 4 slots filled at step 0 and one chunk run first (a new
        # signature is captured there); thin:64 keeps one row a slot every
        # other 32-step chunk, as the burst's ising requests do, so the
        # traced chunks copy alike to pinned memory on both paths
        for turn in range(2):
            for path, run in runs.items():
                for name in ("gmm", "ising"):
                    ex = run["sched"].executor_for(name)
                    for i in range(4):
                        ex.admit(serving.ServeRequest(
                            rid=1000 + i, workload=name, seed=300 + 10 * turn + i,
                            n_steps=trace_steps, collect="thin:64"))
                    ex.advance_chunk()
                    calls = []
                    events, wall_ms = traced(
                        torch, ex.advance_chunk,
                        "mh_chain_kernel" if name == "gmm" else "gibbs_band_kernel",
                        lambda: sum(launches_now().values()), host_calls=calls)
                    while ex.active_count:
                        ex.advance_chunk()
                    ex.drain()
                    busy = sum(e.self_device_time_total for e in events) / 1e3
                    paths[path]["classes"][name].setdefault("traced_chunks", []).append(dict(
                        wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                        graph_launches=sum(c == "cudaGraphLaunch" for c in calls),
                        kernel_launch_calls=sum("Launch" in c and c != "cudaGraphLaunch"
                                                for c in calls),
                        memcpy_calls=sum("Memcpy" in c for c in calls)))
        graph_launches = [t["graph_launches"] for k in ("gmm", "ising")
                          for t in paths["programs"]["classes"][k]["traced_chunks"]]
        check(graph_launches == [1] * 4,
              f"compiled_serving {case}: traced chunks made {graph_launches} graph launches")
        emit(phase="compiled_serving", case=case, randomness=randomness, smoke=smoke,
             n_slots=4, requests=len(runs["programs"]["served"]["cold"]), bit_equal_eager=True,
             served_equals_solo=exact, replays_after_a_join_at_other_step0s=rejoined,
             launches=launches_by_path[f"compiled_serving_{case}"], **paths)
        return rejoined

    def cim_burst():
        return [serving.ServeRequest(rid=r.rid, workload=r.workload, n_steps=r.n_steps,
                                     seed=r.seed, collect=r.collect, t_arrive=r.t_arrive)
                for r in cim_reqs]

    t_phase = time.perf_counter()
    rejoined = compiled_serving_case("fused", "fused", False, s_kw, burst, 32 * 16)
    rejoined += compiled_serving_case("cim", "cim", True, {}, cim_burst, 32 * 16)
    check(rejoined > 0, "no chunk replayed a program at other step bases after a join")
    emit(phase="compiled_serving_total", seconds=time.perf_counter() - t_phase)

    # 24-28. the autotuner, the CLIs and the serving mesh ---------------------
    from repro_torch.launch import monitor as cli_monitor
    from repro_torch.launch import sample as cli_sample
    from repro_torch.launch import serve_engine as cli_serve

    scratch = ROOT / "build" / "chip_smoke_cli"  # tuner caches and traces
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)

    def hold_first(seen, kernel, where):
        """The path's first launch of ``kernel`` against its plain version
        (not added to the timed cases)."""
        check(kernel in seen, f"{where} launched no {kernel}")
        args, kw = seen[kernel]
        return hold(kernel, f"{where} first launch", from_launch(args), kw, record=False)[:2]

    @contextlib.contextmanager
    def path_run(path):
        """Count a path's launches from 0 and record each kernel's first
        launch; the counts land in ``launches_by_path``."""
        torch.cuda.synchronize()
        reset_launches()
        with first_launches(mh) as seen_mh, first_launches(gk) as seen_gk:
            seen = {}
            yield seen
            torch.cuda.synchronize()
        seen.update(seen_mh)
        seen.update(seen_gk)
        launches_by_path[path] = launches_now()

    def tune_phase(path, kernel, cfg, target, init_words, plan, **kw):
        """``autotune_config`` twice on one cache (measured, then a hit);
        the tuned engine's stream against the incumbent's."""
        cache = str(scratch / f"{path}.json")
        gc.collect()
        torch.cuda.empty_cache()
        held0 = torch.cuda.memory_allocated(dev)
        with path_run(path) as seen:
            t0 = time.perf_counter()
            tuned, res = samplers.autotune_config(cfg, target, init_words, cache_path=cache, **kw)
            tune_s = time.perf_counter() - t0
        launches = launches_by_path[path]
        check(launches[kernel] > 0, f"{path} launched no {kernel}")
        diff, err = hold_first(seen, kernel, path)
        # each candidate's engine, and with it its captured graph, is gone
        # once the recorded first launches are
        del seen
        gc.collect()
        torch.cuda.empty_cache()
        bytes_left = torch.cuda.memory_allocated(dev) - held0
        check(res.source == "measured", f"{path}: {res.source}")
        check(res.candidates[0][:3] == (cfg.chunk_steps, cfg.block_c, "pallas"),
              f"{path}: the incumbent is not candidate 0: {res.candidates[0]}")
        check({c[1] for c in res.candidates} == {cfg.block_c}, f"{path}: a block_c axis")
        check(res.steps_per_s == max(c[3] for c in res.candidates)
              and res.steps_per_s >= res.baseline_steps_per_s, f"{path}: not the argmax")
        t0 = time.perf_counter()
        tuned2, res2 = samplers.autotune_config(cfg, target, init_words, cache_path=cache, **kw)
        hit_s = time.perf_counter() - t0
        check(res2.source == "cache" and tuned2 == tuned, f"{path}: no cache hit")
        a = samplers.MHEngine(cfg).submit(plan).result
        b = samplers.MHEngine(tuned).submit(plan).result
        check(same_result(a, b), f"{path}: the tuned stream differs from the incumbent's")
        emit(phase=path, launches=launches, first_launch_mismatches=diff, max_abs_err=err,
             incumbent=list(res.candidates[0][:3]), tuned=[res.chunk_steps, res.block_c,
                                                          res.execution],
             # the tuner's rate: steps x state elements (chains or sites) a second
             candidates=[dict(chunk_steps=c[0], block_c=c[1], execution=c[2],
                              steps_per_s=c[3]) for c in res.candidates],
             tuned_over_incumbent=res.steps_per_s / res.baseline_steps_per_s,
             tune_seconds=tune_s, cache_hit_seconds=hit_s, stream_n_steps=plan.n_steps,
             stream_collect=plan.collect or "all", tuned_stream_equals_incumbent=True,
             tuner_kw=kw, compiled_bytes_left=bytes_left)
        return res

    # 24. autotune_mh: the MH main path's table, fused, auto (scan and pallas)
    mh_cfg = samplers.EngineConfig(randomness="fused")
    mh_target = samplers.TableTarget(logits)
    res = tune_phase("autotune_mh", "mh_chain_fused", mh_cfg, mh_target, init,
                     samplers.RunPlan(target=mh_target, n_steps=N_STEPS, init_words=init,
                                      seed=SEED),
                     n_steps=TUNE_MH_STEPS, repeats=TUNE_MH_REPEATS)
    check({c[2] for c in res.candidates} == {"scan", "pallas"}, "autotune_mh: one executor")

    # 25. autotune_gibbs: ising 1024 x 1024 x 4, fused, pinned to the kernels
    wl = workloads.build("ising", prng.PRNGKey(SEED, device=dev), randomness="fused",
                         backend="pallas", height=LAT, width=LAT, batch=LAT_B, beta=BETA)
    tune_phase("autotune_gibbs", "gibbs_chain_fused", wl.engine.config, wl.target,
               wl.init_words, wl.plan(prng.PRNGKey(SEED + 1, device=dev), n_steps=N_STEPS,
                                      collect=G_THIN))
    del wl

    # 26. cli_sample: repro_torch.launch.sample.main in this process
    lattice = ["--height", str(LAT), "--width", str(LAT), "--batch", str(LAT_B)]

    def ising_argv(randomness):
        return ["--workload", "ising", *lattice, "--randomness", randomness, "--backend",
                "pallas", "--steps", str(N_STEPS), "--thin", "16"]

    ising_main = ising_argv("fused")
    glass_kw = ["--workload", "spin_glass", *lattice, "--randomness", "fused", "--backend",
                "pallas"]
    trace_path = str(scratch / "sample.trace.jsonl")
    cli_runs = {
        "ising_fused": (ising_main, "gibbs_chain_fused"),
        "ising_host": (ising_argv("host"), "gibbs_chain"),
        "gmm_fused": (["--workload", "gmm", "--randomness", "fused"], "mh_chain_fused"),
        "gmm_cim": (["--workload", "gmm", "--randomness", "cim"], "mh_chain"),
        # the CLI keeps every replica's every row (it refuses --thin with a
        # ladder): 256 MB a step at this width, so the ladder runs CLI_LADDER_STEPS
        "spin_glass_ladder": ([*glass_kw, "--steps", str(CLI_LADDER_STEPS), "--ladder",
                               str(T_REPLICAS), "--swap-every", str(T_SWAP)],
                              "gibbs_chain_fused"),
        "spin_glass_anneal": ([*glass_kw, "--steps", str(T_STEPS), "--anneal", "8"],
                              "gibbs_chain_fused"),
        "ising_autotune": ([*ising_main, "--autotune", "--autotune-cache",
                            str(scratch / "cli.json")], "gibbs_chain_fused"),
        "ising_trace": ([*ising_main, "--trace", trace_path], "gibbs_chain_fused"),
    }
    for name, (argv, kernel) in cli_runs.items():
        path = f"cli_sample_{name}"
        with path_run(path) as seen:
            t0 = time.perf_counter()
            row = cli_sample.main(argv)
            seconds = time.perf_counter() - t0
        launches = launches_by_path[path]
        check(launches[kernel] > 0, f"{path} launched no {kernel}")
        diff, err = hold_first(seen, kernel, path)
        rate = row.get("flip_rate", row.get("acceptance_rate"))
        check(0.0 < rate < 1.0, f"{path}: rate {rate}")
        check(all(np.isfinite(v) for v in row.values() if isinstance(v, float)),
              f"{path}: a non-finite field in {row}")
        emit(phase="cli_sample", run=name, argv=argv, launches=launches,
             first_launch_mismatches=diff, max_abs_err=err, seconds=seconds, row=row)
    check(cli_monitor.main(["--check", trace_path]) == 0, "the CLI's trace does not validate")
    header, events = cli_monitor.read_events(trace_path)
    spans = cli_monitor.summarize_events(events)
    check(any(r["span"] == "engine.submit" for r in spans), "no engine.submit span traced")
    cli_monitor.main([trace_path])
    emit(phase="cli_monitor", trace=trace_path.split("/")[-1], valid=True, events=len(events),
         spans=spans)

    # 27. cli_serve_engine: a mixed burst at the workloads' own defaults
    with path_run("cli_serve_engine") as seen:
        t0 = time.perf_counter()
        row = cli_serve.main(["--workload", "gmm,ising", "--backend", "pallas", "--randomness",
                              "fused", "--slots", "4", "--requests", "12", "--poisson-rate",
                              "200"])
        seconds = time.perf_counter() - t0
    launches = launches_by_path["cli_serve_engine"]
    holds = {k: hold_first(seen, k, "cli_serve_engine")
             for k in ("mh_chain_fused", "gibbs_chain_fused")}
    check(row["n_requests"] == 12 and row["shape_classes"] == 2, f"cli_serve_engine: {row}")
    emit(phase="cli_serve_engine", launches=launches, seconds=seconds, row=row,
         first_launch_mismatches={k: v[0] for k, v in holds.items()},
         max_abs_err={k: v[1] for k, v in holds.items()})
    shutil.rmtree(scratch, ignore_errors=True)

    # 28. serving_mesh: the scan class's slot axis on a one-rank nccl mesh
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=dev)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))

        def mesh_burst():
            """The serving phase's shapes under scan: gmm at its default
            widths, ising at LAT x LAT x S_BATCH, in one shape class."""
            return ([serving.ServeRequest(rid=i, workload="gmm", n_steps=M_GMM_STEPS,
                                          seed=100 + i, t_arrive=0.004 * i)
                     for i in range(M_GMM)]
                    + [serving.ServeRequest(rid=M_GMM + j, workload="ising",
                                            n_steps=M_ISING_STEPS, seed=200 + j,
                                            collect="thin:64", t_arrive=0.002 + 0.006 * j)
                       for j in range(M_ISING)])

        def mesh_serve(mesh_):
            sched = serving.Scheduler(n_slots=4, randomness="fused", execution="scan",
                                      smoke=False, workload_kwargs=s_kw, mesh=mesh_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = sched.serve(mesh_burst())
            return {r.rid: r for r in done}, time.perf_counter() - t0, sched

        plain, mesh_cold_s, plain_sched = mesh_serve(None)
        n_classes = plain_sched.shape_classes
        del plain_sched
        reset_launches()
        sharded, mesh_s, mesh_sched = mesh_serve(mesh)
        launches_by_path["serving_mesh"] = launches_now()
        # the sharded class call, its all-gather included, runs as the
        # programs of its (seg, collect) signatures (the ising member's
        # join rebuilt the advance, whose first programs were freed, so
        # more signatures were counted than are held)
        mesh_programs = {f"{k[0]},{k[1]}": p for ex in mesh_sched.executors.values()
                         for k, p in ex._advance.programs.items()}
        mesh_signatures = mesh_sched.compiled_programs
        check(mesh_programs and all(p.graph is not None for p in mesh_programs.values())
              and mesh_signatures >= len(mesh_programs),
              f"serving_mesh: {mesh_signatures} signatures, programs "
              f"{ {k: p.graph is not None for k, p in mesh_programs.items()} }")
        mesh_programs = {k: dict(graphs=len(p.graph.pieces), sections=len(p.sections),
                                 bytes=p.nbytes) for k, p in mesh_programs.items()}
        del mesh_sched
        check(len(sharded) == M_GMM + M_ISING, f"served {len(sharded)} requests on the mesh")
        for rid, r in sharded.items():
            check(all(np.array_equal(getattr(r, f), getattr(plain[rid], f)) for f in
                      ("samples", "final_words", "accept_count", "final_logp")),
                  f"mesh request {rid} differs from the unsharded one")
        # warm, in turns: unsharded, mesh
        warm = {"unsharded": [], "mesh": []}
        for _ in range(MESH_TURNS):
            for name, m_ in (("unsharded", None), ("mesh", mesh)):
                warm[name].append(mesh_serve(m_)[1])
        try:
            serving.Scheduler(n_slots=4, execution="pallas", smoke=True,
                              mesh=mesh).executor_for("gmm")
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "mesh" in refused, "a mesh under pallas was not refused")
    finally:
        dist.destroy_process_group()
    emit(phase="serving_mesh", backend="nccl", ranks=1, execution="scan", n_slots=4,
         requests={"gmm": M_GMM, "ising": M_ISING}, ising=s_kw, gmm_n_steps=M_GMM_STEPS,
         ising_n_steps=M_ISING_STEPS,
         shape_classes=n_classes, equals_unsharded=True, cold_unsharded_seconds=mesh_cold_s,
         first_mesh_seconds=mesh_s, warm_seconds=warm, mesh_programs=mesh_programs,
         mesh_signatures=mesh_signatures,
         launches=launches_by_path["serving_mesh"], pallas_refused=refused)

    # 42. compiled_scan: the scan class advance's and tempering's scan segment
    # programs against their eager twins -----------------------------------
    t_phase = time.perf_counter()
    scan_captures = []
    real_capture = adv_compiled.capture

    def timed_capture(fn, inputs, device, what, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adv_compiled.KEEP_GRAPHS = True  # to count every program's nodes
        try:
            program, result = real_capture(fn, inputs, device, what, *args, **kw)
        finally:
            adv_compiled.KEEP_GRAPHS = False
        torch.cuda.synchronize()
        scan_captures.append(dict(what=what, seconds=time.perf_counter() - t0,
                                  nodes=program.nodes, bytes=program.nbytes,
                                  sections=len(program.sections),
                                  section_nodes=sum(program.sections.values())))
        return program, result

    def scan_instrument(sched, eager):
        """Make the gmm + ising shape class (both members before any
        request) and record its advance calls (signature, step bases,
        capture or replay, host seconds) and each chunk's host seconds;
        with ``eager`` the class's advance is its eager body."""
        ex = sched.executor_for("gmm")
        check(sched.executor_for("ising") is ex and len(ex.members) == 2,
              "compiled_scan: gmm and ising are not one shape class")
        programs = ex._advance.programs
        real_adv = ex._advance.eager if eager else ex._advance
        real_chunk = ex.advance_chunk
        rec = dict(calls=[], chunk_s=[], programs=programs, ex=ex)

        def advance(words, logp, keys, step0s, *, seg, collect, layout):
            hit = (seg, collect) in programs
            t0 = time.perf_counter()
            out = real_adv(words, logp, keys, step0s, seg=seg, collect=collect, layout=layout)
            rec["calls"].append(dict(sig=(seg, collect), step0s=step0s.tolist(), hit=hit,
                                     layout=layout, host_s=time.perf_counter() - t0))
            return out

        def chunk():
            if not ex.active_count:
                return real_chunk()
            t0 = time.perf_counter()
            done = real_chunk()
            rec["chunk_s"].append(time.perf_counter() - t0)
            return done

        if not eager:
            advance.programs = programs  # advance_compiles reads it
        ex._advance, ex.advance_chunk = advance, chunk
        return rec

    def scan_solo(req, randomness, smoke, wkw):
        k_init, k_run = prng.split(prng.PRNGKey(req.seed, device=dev))
        wl = workloads.build(req.workload, k_init, randomness=randomness, backend="scan",
                             smoke=smoke, **(wkw if req.workload == "ising" else {}))
        return wl.engine.run(k_run, wl.target, req.n_steps or wl.n_steps, wl.init_words,
                             collect=req.collect)

    served_fields = ("samples", "final_words", "accept_count", "final_logp")

    def scan_serving_case(case, randomness, smoke, wkw, make_reqs, trace_steps):
        """``make_reqs()`` on one 4-slot gmm + ising scan class, through the
        programs and through the eager body, one scheduler a path, in
        turns: programs cold, eager cold, programs warm, eager warm; then
        two chunks traced on each path, in turns, with 2 gmm and 2 ising
        requests of ``trace_steps`` steps in the slots."""
        runs = {}
        for path in ("programs", "eager"):
            sched = serving.Scheduler(n_slots=4, randomness=randomness, execution="scan",
                                      smoke=smoke, workload_kwargs=wkw)
            runs[path] = dict(sched=sched, rec=scan_instrument(sched, path == "eager"),
                              seconds={}, served={})
        del scan_captures[:]
        adv_compiled.capture = timed_capture
        try:
            for burst in ("cold", "warm"):
                for path, run in runs.items():
                    reqs = make_reqs()
                    run["seconds"][burst] = timed_serve(run["sched"], reqs)
                    torch.cuda.synchronize()
                    run["served"][burst] = reqs
        finally:
            adv_compiled.capture = real_capture
        captures = list(scan_captures)
        where = f"compiled_scan serving {case}"
        for path, run in runs.items():
            for a, b in zip(run["served"]["cold"], run["served"]["warm"]):
                check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in served_fields),
                      f"{where} {path}: request {a.rid} differs between the cold and warm bursts")
        for burst in ("cold", "warm"):
            for a, b in zip(runs["programs"]["served"][burst], runs["eager"]["served"][burst]):
                check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in served_fields),
                      f"{where}: request {a.rid} ({burst}) differs from its eager twin")
        for req in runs["programs"]["served"]["cold"]:
            ref_ = scan_solo(req, randomness, smoke, wkw)
            check(all(np.array_equal(getattr(req, f), getattr(ref_, f).cpu().numpy())
                      for f in served_fields),
                  f"{where}: request {req.rid} ({req.workload}) != its solo scan run")
        rec = runs["programs"]["rec"]
        sigs = {c["sig"] for c in rec["calls"]}
        check(len(rec["programs"]) == len(sigs) == len(captures)
              and all(p.graph is not None for p in rec["programs"].values()),
              f"{where}: {len(rec['programs'])} programs, {len(captures)} captures for {sigs}")
        check(sum(not c["hit"] for c in rec["calls"]) == len(sigs),
              f"{where}: captured more than once a signature")
        check(runs["programs"]["sched"].compiled_programs == len(sigs),
              f"{where}: {runs['programs']['sched'].compiled_programs} signatures counted")
        captured_at, rejoined, relaid = {}, 0, 0
        for c in rec["calls"]:
            if not c["hit"]:
                captured_at[c["sig"]] = (c["step0s"], c["layout"])
                continue
            if c["step0s"] != captured_at[c["sig"]][0] and max(c["step0s"]) > 0:
                rejoined += 1
            relaid += c["layout"] != captured_at[c["sig"]][1]
        paths = {}
        for path, run in runs.items():
            r_ = run["rec"]
            seen, known = set(), []
            for c, chunk_s in zip(r_["calls"], r_["chunk_s"]):
                if c["hit"] if path == "programs" else c["sig"] in seen:
                    known.append((chunk_s, c["host_s"]))
                seen.add(c["sig"])
            paths[path] = dict(
                cold_burst_s=run["seconds"]["cold"], warm_burst_s=run["seconds"]["warm"],
                chunks=len(r_["calls"]), known_signature_chunks=len(known),
                signatures=sorted({c["sig"] for c in r_["calls"]}),
                chunk_host_s_median=float(np.median([k[0] for k in known])),
                advance_host_s_median=float(np.median([k[1] for k in known])),
                advance_host_s_range=[min(k[1] for k in known), max(k[1] for k in known)])
        paths["programs"]["captures"] = captures
        for turn in range(2):
            for path, run in runs.items():
                ex = run["rec"]["ex"]
                for i, name in enumerate(("gmm", "gmm", "ising", "ising")):
                    ex.admit(serving.ServeRequest(rid=1000 + i, workload=name,
                                                  seed=300 + 10 * turn + i, n_steps=trace_steps,
                                                  collect="thin:64"))
                ex.advance_chunk()
                calls = []
                events, wall_ms = traced(torch, ex.advance_chunk, host_calls=calls)
                while ex.active_count:
                    ex.advance_chunk()
                ex.drain()
                busy = sum(e.self_device_time_total for e in events) / 1e3
                paths[path].setdefault("traced_chunks", []).append(dict(
                    wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                    graph_launches=sum(c == "cudaGraphLaunch" for c in calls),
                    kernel_launch_calls=sum("Launch" in c and c != "cudaGraphLaunch"
                                            for c in calls),
                    memcpy_calls=sum("Memcpy" in c for c in calls)))
        # a traced chunk has 4 slots occupied: it replays their 4 sections
        # and the graphs between sections
        graph_launches = [t["graph_launches"] for t in paths["programs"]["traced_chunks"]]
        between = {sum(k is None for k, _, _ in p.graph.pieces) for p in rec["programs"].values()}
        check(all(g - 4 in between for g in graph_launches),
              f"{where}: traced chunks made {graph_launches} graph launches, "
              f"{between} graphs between sections")
        emit(phase="compiled_scan", part="serving", case=case, randomness=randomness,
             smoke=smoke, n_slots=4, members=["gmm", "ising"], ising=wkw or "smoke",
             requests=len(runs["programs"]["served"]["cold"]), bit_equal_eager=True,
             served_equals_solo=True, replays_at_other_step0s=rejoined,
             replays_at_other_layouts=relaid,
             layouts=sorted({str(c["layout"]) for c in rec["calls"]}), **paths)
        return rejoined, relaid

    rejoined, relaid = scan_serving_case("fused", "fused", False, s_kw, mesh_burst, 32 * 4)
    more = scan_serving_case("cim", "cim", True, {}, cim_burst, 32 * 4)
    check(rejoined + more[0] > 0, "compiled_scan: no chunk replayed a program at other step bases")
    check(relaid + more[1] > 0, "compiled_scan: no chunk replayed a program at another layout")

    def scan_tempering_case(case, eng, target, init, n_steps, swap, ladder, trace):
        """A ``ReplicaExchange`` under scan through its segment programs and
        through direct submits (``exchange._segment_body`` at the host's
        int step: the twin), in turns, cold then warm; with ``trace`` one
        run of each path traced."""
        from repro_torch.tempering import exchange

        rex = tempering.ReplicaExchange(ladder, eng, swap_every=swap)
        inits = init.expand(ladder.num_replicas, *init.shape)
        tkey_ = prng.PRNGKey(SEED + 5, device=dev)
        seg_s = {"programs": [], "direct": []}
        real_seg = exchange._scan_segment

        def segment(path):
            def run_segment(programs_, engine, target_, n, cid, key_, init_, step):
                t0 = time.perf_counter()
                if path == "programs":
                    out = real_seg(programs_, engine, target_, n, cid, key_, init_, step)
                else:
                    out = exchange._segment_body(engine, target_, n, cid, key_, init_, step)
                seg_s[path].append(time.perf_counter() - t0)
                return out
            return run_segment

        results, seconds, programs = {}, {}, rex._programs
        del scan_captures[:]
        adv_compiled.capture = timed_capture
        try:
            for turn in ("cold", "warm"):
                for path in ("programs", "direct"):
                    exchange._scan_segment = segment(path)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    results[turn, path] = rex.run(tkey_, target, n_steps, inits)
                    torch.cuda.synchronize()
                    seconds[turn, path] = time.perf_counter() - t0
            traced_runs = {}
            if trace:
                for path in ("programs", "direct"):
                    exchange._scan_segment = segment(path)
                    calls = []
                    events, wall_ms = traced(
                        torch, lambda: rex.run(tkey_, target, n_steps, inits), host_calls=calls)
                    busy = sum(e.self_device_time_total for e in events) / 1e3
                    traced_runs[path] = dict(
                        wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                        graph_launches=sum(c == "cudaGraphLaunch" for c in calls),
                        kernel_launch_calls=sum("Launch" in c and c != "cudaGraphLaunch"
                                                for c in calls))
        finally:
            exchange._scan_segment = real_seg
            adv_compiled.capture = real_capture
        where = f"compiled_scan tempering {case}"
        fields = ("samples", "accept_count", "final_words", "final_logp")
        for turn in ("cold", "warm"):
            a, b = results[turn, "programs"], results[turn, "direct"]
            check(all(same_words(getattr(a, f), getattr(b, f)) for f in fields)
                  and a.swap.summary() == b.swap.summary()
                  and all(np.array_equal(getattr(a.swap, f), getattr(b.swap, f))
                          for f in ("attempts", "accepts", "events", "round_trips")),
                  f"{where}: the {turn} run differs from its direct-submit twin")
        check(all(same_words(getattr(results["cold", "programs"], f),
                             getattr(results["warm", "programs"], f)) for f in fields),
              f"{where}: the warm run differs from the cold one")
        lengths = {min(swap, n_steps - s) for s in range(0, n_steps, swap)}
        want = ladder.num_replicas * len(lengths)
        check(len(programs) == want == len(scan_captures)
              and all(p.graph is not None for p in programs.values())
              and len({p.graph.pool() for p in programs.values()}) == 1,
              f"{where}: {len(programs)} programs, {len(scan_captures)} captures, want {want}")
        held_bytes = sum(p.nbytes for p in programs.values())
        res = results["cold", "programs"]
        check(bool(torch.isfinite(res.final_logp).all()), f"{where}: non-finite final_logp")
        n_seg = ladder.num_replicas * len(range(0, n_steps, swap))
        emit(phase="compiled_scan", part="tempering", case=case, replicas=ladder.num_replicas,
             betas=list(ladder.betas), n_steps=n_steps, swap_every=swap,
             collect=eng.config.collect, state=list(init.shape), bit_equal_direct=True,
             programs=len(programs), captures=list(scan_captures),
             run_s={f"{t},{p}": v for (t, p), v in seconds.items()},
             segment_host_s_median={
                 p: float(np.median(v[-n_seg:])) for p, v in seg_s.items()},
             segment_host_s_range={p: [min(v[-n_seg:]), max(v[-n_seg:])]
                                   for p, v in seg_s.items()},
             programs_bytes_held=held_bytes, swap=res.swap.summary(), traced=traced_runs)
        programs.clear()

    sg_wl = workloads.build("spin_glass", prng.PRNGKey(SEED, device=dev), randomness="fused",
                            backend="scan", height=LAT, width=LAT, batch=LAT_B, collect="last",
                            chunk_steps=SCAN_T_SWAP)
    scan_tempering_case("spin_glass_full_width_last", sg_wl.engine, sg_wl.target,
                        sg_wl.init_words, SCAN_T_STEPS, SCAN_T_SWAP,
                        tempering.Ladder.geometric(SCAN_T_REPLICAS, 0.25, 1.0), trace=True)
    del sg_wl
    sg_small = workloads.build("spin_glass", prng.PRNGKey(SEED + 1, device=dev),
                               randomness="fused", backend="scan", height=SCAN_T_SMALL,
                               width=SCAN_T_SMALL, batch=LAT_B, collect="all",
                               chunk_steps=SCAN_T_SWAP)
    scan_tempering_case(f"spin_glass_{SCAN_T_SMALL}_all", sg_small.engine, sg_small.target,
                        sg_small.init_words, SCAN_T_STEPS, SCAN_T_SWAP,
                        tempering.Ladder.geometric(SCAN_T_REPLICAS, 0.25, 1.0), trace=False)
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 3)
    t_table = samplers.TableTarget(
        torch.randn((SCAN_MH_B, SCAN_MH_V), generator=gen_t, device=dev) * 2)
    t_words = torch.argmax(t_table.table, -1)[:, None].expand(SCAN_MH_B, SCAN_MH_C)
    scan_tempering_case("table_mh_all", samplers.MHEngine(samplers.EngineConfig(
        randomness="fused", execution="scan", chunk_steps=SCAN_T_SWAP, collect="all")),
        t_table, t_words.contiguous(), SCAN_T_STEPS, SCAN_T_SWAP,
        tempering.Ladder.geometric(T_MH_REPLICAS, 0.25, 1.0), trace=False)
    emit(phase="compiled_scan_total", seconds=time.perf_counter() - t_phase)

    # 29. serve_lm: granite-3 8B at full width through launch/serve.py ---------
    def serve_lm_phase():
        """Phase 29; its names stay out of the phases after it."""
        t_phase = time.perf_counter()
        from repro_torch import configs as llm_configs
        from repro_torch.core import token_sampler as llm_ts
        from repro_torch.launch import serve as cli_llm
        from repro_torch.models import lm as llm

        gcfg = llm_configs.get_config(LLM_ARCH)
        llm_argv = ["--arch", LLM_ARCH, "--requests", str(LLM_REQUESTS), "--slots",
                    str(LLM_SLOTS), "--prompt-len", str(LLM_PROMPT), "--gen", str(LLM_GEN)]
        llm_rows = {}
        for sampler in ("mcmc", "greedy", "categorical"):
            path = f"serve_lm_{sampler}"
            torch.cuda.empty_cache()
            # each path captures its own sampler programs: a replay of one
            # captured before calls no launch wrapper to record
            llm_ts.clear_cache()
            with path_run(path) as seen:
                t0 = time.perf_counter()
                row = cli_llm.main([*llm_argv, "--sampler", sampler])
                main_s = time.perf_counter() - t0
            launches = launches_by_path[path]
            streams = row.pop("streams")
            check(row["device"].startswith("cuda"), f"{path} ran on {row['device']}")
            check(len(streams) == LLM_REQUESTS and all(
                len(t) == LLM_GEN + 1 and all(0 <= x < gcfg.vocab_size for x in t)
                for t in streams.values()), f"{path}: streams {streams}")
            check(row["tokens"] == LLM_REQUESTS * (LLM_GEN + 1), f"{path}: {row}")
            want = row["samples"] if sampler == "mcmc" else 0
            check(launches == {**{k: 0 for k in launches}, "mh_chain": want},
                  f"{path}: launches {launches}, {want} mh_chain wanted (one a sample)")
            record = dict(phase="serve_lm", argv=llm_argv, main_s=main_s, **row,
                          launches=launches)
            if sampler == "mcmc":  # the first launch is also timed in 12
                check("mh_chain" in seen, f"{path} launched no mh_chain")
                args, kw = seen["mh_chain"]
                diff, err, _ = hold("mh_chain", f"{path} first launch", from_launch(args), kw)
                record.update(first_launch_mismatches=diff, max_abs_err=err)
                check(0.0 < row["acceptance"] < 1.0, f"{path}: acceptance {row['acceptance']}")
            llm_rows[sampler] = row
            if sampler == "mcmc":
                burst_tokens_per_s[LLM_ARCH] = row["tokens_per_s"]
            emit(**record)
            del seen

        # a server built here: memory, prefill, and decode steps timed one by one
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        max_len = LLM_PROMPT + 2 + LLM_GEN + 8  # main's sizing
        server = cli_llm.BatchedServer(gcfg, cli_llm.ServeConfig(
            n_slots=LLM_SLOTS, max_len=max_len, gen_tokens=LLM_GEN, sampler="mcmc"))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        model = server.model
        param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        embed_bytes = model.embed.numel() * model.embed.element_size()
        n_params = sum(p.numel() for p in model.parameters())
        check(param_bytes == 2 * n_params and n_params == gcfg.padded_vocab * gcfg.d_model * 2
              + gcfg.n_layers * (gcfg.layer_params() + 2 * gcfg.d_model) + gcfg.d_model,
              f"{n_params} parameters, {param_bytes} bytes")
        rs = np.random.default_rng(SEED)
        prompts = [rs.integers(0, gcfg.vocab_size, LLM_PROMPT + i % 3) for i in range(LLM_SLOTS)]
        prefill_ms = []
        with torch.inference_mode():
            for slot, prompt in enumerate(prompts):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                server._prefill_slot(slot, cli_llm.Request(rid=slot, prompt=prompt))
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            server.last_tokens = torch.randint(0, gcfg.vocab_size, (LLM_SLOTS, 1), generator=gen,
                                               device=dev, dtype=torch.int32)

            def llm_model_step():
                logits, server.cache = llm.decode_step(model, gcfg, server.last_tokens,
                                                       server.cache)
                return logits

            def llm_step():
                tokens = server._sample(llm_model_step())
                server.last_tokens = tokens[:, None]

            model_ms, sample_ms = [], []
            for _ in range(LLM_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = llm_model_step()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tokens = server._sample(logits)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                server.last_tokens = tokens[:, None]
                model_ms.append((t1 - t0) * 1e3)
                sample_ms.append((t2 - t1) * 1e3)
            # the head's bfloat16 product (float32 results) against the widened one
            hidden = torch.randn((LLM_SLOTS, gcfg.d_model), generator=gen, device=dev).to(
                torch.bfloat16)
            head = llm.head_logits(model, gcfg, hidden)
            wide = hidden.float() @ model.lm_head.float()
            wide[:, gcfg.vocab_size:] = -1e30
            head_err = float((head - wide)[:, :gcfg.vocab_size].abs().max())
            head_scale = float(wide[:, :gcfg.vocab_size].abs().max())
            check(head.dtype == torch.float32 and head_err <= LLM_HEAD_RTOL * head_scale,
                  f"head product: max |err| {head_err} for logits up to {head_scale}")
            del wide, head
            step_events, step_wall_ms = traced(torch, llm_step, "mh_chain_kernel",
                                               lambda: mh.LAUNCHES["mh_chain"], cpu=True)
            model_events, model_wall_ms = traced(torch, llm_model_step, cpu=True)
        peak_bytes = torch.cuda.max_memory_allocated()
        smax, b_ = max_len, LLM_SLOTS
        kv_bytes = 2 * gcfg.n_layers * b_ * smax * gcfg.n_kv_heads * gcfg.d_head * 2
        body = gcfg.n_layers * gcfg.layer_params()
        head_ops = 2 * gcfg.d_model * gcfg.padded_vocab
        attn_ops = 4 * gcfg.n_layers * gcfg.n_heads * gcfg.d_head  # x query x key positions
        step_bytes = param_bytes - embed_bytes + kv_bytes
        step_ops = b_ * (2 * body + head_ops + attn_ops * smax)
        plen = LLM_PROMPT + 2
        prefill_ops = 2 * body * plen + head_ops + attn_ops * plen * plen
        step_bound = max(step_bytes / HBM_BYTES_PER_S, step_ops / BF16_OPS_PER_S) * 1e3
        prefill_bound = max((param_bytes - embed_bytes) / HBM_BYTES_PER_S,
                            prefill_ops / BF16_OPS_PER_S) * 1e3
        busy = sum(e.self_device_time_total for e in step_events) / 1e3
        model_busy = sum(e.self_device_time_total for e in model_events) / 1e3
        emit(phase="serve_lm_steps", arch=LLM_ARCH, layers=gcfg.n_layers, d_model=gcfg.d_model,
             vocab=gcfg.vocab_size, dtype=str(gcfg.param_dtype), parameters=n_params,
             param_bytes=param_bytes, max_memory_allocated=peak_bytes, server_init_s=init_s,
             prompt_lens=[len(p) for p in prompts], prefill_ms=prefill_ms,
             prefill_bound_ms=prefill_bound, prefill_ops=prefill_ops,
             decode_model_ms=model_ms, decode_sample_ms=sample_ms,
             decode_model_ms_median=float(np.median(model_ms)),
             decode_sample_ms_median=float(np.median(sample_ms)),
             decode_step_bound_ms=step_bound, decode_step_bytes=step_bytes,
             decode_step_ops=step_ops,
             decode_step_bound_by="bytes" if step_bytes / HBM_BYTES_PER_S
             >= step_ops / BF16_OPS_PER_S else "operations",
             traced_step_wall_ms=step_wall_ms, traced_step_busy_ms=busy,
             traced_step_busy_share=busy / step_wall_ms, traced_step_device_events=len(step_events),
             traced_model_wall_ms=model_wall_ms, traced_model_busy_ms=model_busy,
             traced_model_busy_share=model_busy / model_wall_ms,
             traced_model_device_events=len(model_events),
             head_max_abs_err=head_err, head_max_logit=head_scale,
             tokens_per_s={k: r["tokens_per_s"] for k, r in llm_rows.items()},
             acceptance=llm_rows["mcmc"]["acceptance"])
        dry_refs["serve_lm"] = dict(param_bytes=param_bytes, kv_bytes=kv_bytes,
                                    step_ops=step_ops, step_bytes=step_bytes,
                                    model_ms_median=float(np.median(model_ms)))
        del server, model, logits, tokens
        torch.cuda.empty_cache()

        # the model cut to 2 layers in float32: card against CPU, packed against solo
        cfg2 = dataclasses.replace(gcfg, n_layers=LLM_CHECK_LAYERS, dtype="float32",
                                   param_dtype_str="float32", cache_dtype_str="float32")
        t0 = time.perf_counter()
        host_model = llm.init_lm(cfg2, seed=SEED, device="cpu")
        card_model = llm.LM(cfg2, device=dev)
        card_model.load_state_dict(host_model.state_dict())
        copy_s = time.perf_counter() - t0
        check_prompts = [rs.integers(0, gcfg.vocab_size, n) for n in LLM_CHECK_LENS]
        v_ = gcfg.vocab_size

        def greedy_logits(model_, device, rows):
            """Per-row prefills spliced into one cache with a (B,) index, then
            greedy decode steps: the logits of every step, on the host."""
            max_len_ = max(LLM_CHECK_LENS) + LLM_CHECK_STEPS + 1
            with torch.inference_mode():
                cache = llm.init_cache(cfg2, len(rows), max_len_, device)
                cache["index"] = torch.zeros(len(rows), dtype=torch.int32, device=device)
                first = []
                for r, i in enumerate(rows):
                    prompt = torch.as_tensor(check_prompts[i], dtype=torch.int32, device=device)
                    row_logits, row = llm.prefill(model_, cfg2, {"tokens": prompt[None]},
                                                  llm.init_cache(cfg2, 1, max_len_, device))
                    for name in ("k", "v"):
                        cache["layers"][name][:, r:r + 1] = row["layers"][name]
                    cache["index"][r] = row["index"]
                    first.append(row_logits[0])
                out = [torch.stack(first)]
                for _ in range(LLM_CHECK_STEPS):
                    tokens = out[-1][:, :v_].argmax(-1).to(torch.int32)
                    step_logits, cache = llm.decode_step(model_, cfg2, tokens[:, None], cache)
                    out.append(step_logits)
            return [x[:, :v_].cpu() for x in out]

        def agree(a, b, what):
            """Largest logit difference of two runs, and their greedy tokens
            equal at every step whose top-two gap exceeds it (a step with a
            smaller gap fails: the seed must then be replaced)."""
            diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
            for t, (x, y) in enumerate(zip(a, b)):
                top = torch.topk(x, 2).values
                gap = float((top[:, 0] - top[:, 1]).min())
                check(gap > diff, f"{what}: a near tie at step {t} (gap {gap}, difference {diff}): "
                      f"replace SEED")
                check(torch.equal(x.argmax(-1), y.argmax(-1)), f"{what}: greedy tokens differ at "
                      f"step {t}")
            return diff

        t0 = time.perf_counter()
        host_run = greedy_logits(host_model, torch.device("cpu"), [0, 1])
        host_s = time.perf_counter() - t0
        card_run = greedy_logits(card_model, dev, [0, 1])
        card_cpu_diff = agree(card_run, host_run, "card against CPU")
        check(card_cpu_diff <= LLM_LOGIT_TOL, f"card against CPU: max |logit difference| "
              f"{card_cpu_diff} > {LLM_LOGIT_TOL}")
        solo = [greedy_logits(card_model, dev, [i]) for i in (0, 1)]
        solo_run = [torch.cat([solo[0][t], solo[1][t]]) for t in range(LLM_CHECK_STEPS + 1)]
        packed_diff = agree(card_run, solo_run, "packed against solo on the card")
        check(packed_diff <= LLM_LOGIT_TOL, f"packed against solo: {packed_diff} > {LLM_LOGIT_TOL}")
        emit(phase="serve_lm_card_equals_cpu", layers=LLM_CHECK_LAYERS, d_model=cfg2.d_model,
             dtype="float32", prompt_lens=list(LLM_CHECK_LENS), decode_steps=LLM_CHECK_STEPS,
             max_logit=max(float(x.abs().max()) for x in host_run),
             card_cpu_max_abs_diff=card_cpu_diff, packed_solo_max_abs_diff=packed_diff,
             tolerance=LLM_LOGIT_TOL, greedy_tokens=[x.argmax(-1).tolist() for x in card_run],
             build_and_copy_s=copy_s, cpu_run_s=host_s)
        del host_model, card_model, host_run, card_run, solo, solo_run
        torch.cuda.empty_cache()
        emit(phase="serve_lm_total", seconds=time.perf_counter() - t_phase)

    serve_lm_phase()

    # 30-32. the MoE, SSM and hybrid families through launch/serve.py ------------
    @contextlib.contextmanager
    def recorded_routes(llm_moe, routes):
        """Keep each MoE layer's chosen experts (on their device) in
        ``routes`` while a run goes; restores the router on exit.  A decode
        program's capture records nothing (its tensors are the graph's,
        which every replay overwrites), and a replay runs no Python: a
        served burst records its prefills and each server's first, eager,
        decode step (phase 39 records every step's experts eagerly)."""
        real = llm_moe.route

        def route(*args, **kw):
            out = real(*args, **kw)
            if not torch.cuda.is_current_stream_capturing():
                routes.append(out[1])
            return out

        llm_moe.route = route
        try:
            yield
        finally:
            llm_moe.route = real

    @contextlib.contextmanager
    def served_calls(cli_llm, llm, timers, info):
        """Time every prefill, decode step and sample of a burst, each
        between two synchronisations (``timers``, ms), and note the served
        model's and cache's bytes once (``info``).  A decode step is the
        server's ``_decode`` (its compiled program: the capture on the
        first step, a replay after; a synchronisation inside
        ``lm.decode_step`` would fail the capture).  Restores all on exit."""
        real = (llm.prefill, cli_llm.BatchedServer._decode, cli_llm.BatchedServer._sample)

        def timed(fn, key):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                timers[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        timed_sample = timed(real[2], "sample")

        def sample(server, logits):
            if not info:
                model, layers = server.model, server.cache["layers"]
                ssm_part = layers if server.cfg.family == "ssm" else layers.get("ssm", {})
                leaves, ssm_leaves, cross_leaves = [], [], []
                llm.tree_map(leaves.append, layers)
                llm.tree_map(ssm_leaves.append, ssm_part)
                llm.tree_map(cross_leaves.append, layers.get("cross", {}))
                nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
                info.update(
                    param_bytes=nbytes(model.parameters()),
                    parameters=sum(p.numel() for p in model.parameters()),
                    embed_bytes=nbytes([model.embed]),
                    # what a decode step reads: the decoder's blocks, the
                    # final norm and the head (not the embedding table, the
                    # frontend stubs' projections or whisper's encoder)
                    decode_param_bytes=nbytes(p for n, p in model.named_parameters()
                                              if n.split(".")[0] in ("layers", "final_norm",
                                                                     "lm_head")),
                    cache_bytes=nbytes(leaves), ssm_cache_bytes=nbytes(ssm_leaves),
                    cross_cache_bytes=nbytes(cross_leaves))
            return timed_sample(server, logits)

        llm.prefill, cli_llm.BatchedServer._decode = (timed(real[0], "prefill"),
                                                      timed(real[1], "model"))
        cli_llm.BatchedServer._sample = sample
        try:
            yield
        finally:
            llm.prefill, cli_llm.BatchedServer._decode, cli_llm.BatchedServer._sample = real

    def served_burst(cli_llm, fcfg, sampler, max_len):
        """``launch/serve.py:main``'s burst through a ``BatchedServer`` of the
        given cache length (the VLM's holds its image tokens): the same
        prompts, admission loop and summary row."""
        server = cli_llm.BatchedServer(fcfg, cli_llm.ServeConfig(
            n_slots=LLM_SLOTS, max_len=max_len, gen_tokens=LLM_GEN, sampler=sampler), device=dev)
        rs = np.random.default_rng(0)
        queue = [cli_llm.Request(rid=rid, prompt=rs.integers(0, fcfg.vocab_size,
                                                            size=LLM_PROMPT + rid % 3))
                 for rid in range(LLM_REQUESTS)]
        finished, steps = [], 0
        torch.cuda.synchronize()
        t0 = time.time()
        while queue or server.active():
            while queue and server.free_slot() is not None:
                server.submit(server.free_slot(), queue.pop(0))
            finished.extend(server.step())
            steps += 1
        torch.cuda.synchronize()
        dt = time.time() - t0
        tokens = sum(len(r.out_tokens) for r in finished)
        acceptance = float(np.mean(server.acceptance)) if server.acceptance else None
        return {"requests": LLM_REQUESTS, "slots": LLM_SLOTS, "sampler": sampler,
                "backend": "auto", "device": str(server.device), "tokens": tokens,
                "seconds": dt, "tokens_per_s": tokens / dt, "decode_steps": steps,
                "samples": LLM_REQUESTS + steps, "acceptance": acceptance, "max_len": max_len,
                "streams": {r.rid: list(r.out_tokens) for r in finished}}

    @contextlib.contextmanager
    def depth_cut(arch):
        """The configs' ``get_config(arch)`` with ``DEPTH_CUTS[arch]``
        layers (every width kept) while the phase runs; restored on exit."""
        from repro_torch import configs as llm_configs

        real = llm_configs.get_config
        if arch in DEPTH_CUTS:
            llm_configs.get_config = lambda name: (
                dataclasses.replace(real(name), n_layers=DEPTH_CUTS[arch])
                if name == arch else real(name))
        try:
            yield
        finally:
            llm_configs.get_config = real

    def serve_family_phase(phase, arch, samplers_, max_len=None):
        """Phases 30-34; their names stay out of the phases after them.
        With ``max_len`` the burst runs through a ``BatchedServer`` with a
        cache that long, else through ``launch/serve.py:main``."""
        import gc

        t_phase = time.perf_counter()
        from repro_torch import configs as llm_configs
        from repro_torch.core import token_sampler as llm_ts
        from repro_torch.launch import serve as cli_llm
        from repro_torch.models import lm as llm
        from repro_torch.models import moe as llm_moe
        from repro_torch.models import ssm as llm_ssm

        fcfg = llm_configs.get_config(arch)
        argv = ["--arch", arch, "--requests", str(LLM_REQUESTS), "--slots", str(LLM_SLOTS),
                "--prompt-len", str(LLM_PROMPT), "--gen", str(LLM_GEN)]
        is_moe = fcfg.family == "moe"
        has_ssm = fcfg.family in ("ssm", "hybrid")
        if max_len is not None:
            # main's cache, prompt + 2 + gen + 8 rows, leaves out the VLM's
            # image tokens: its first prefill raises, as the reference's does
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                cli_llm.main([*argv, "--sampler", "greedy"])
                raised = None
            except ValueError as e:
                raised = str(e)
            check(raised is not None and "longer than the buffer" in raised,
                  f"{phase}: main at full width did not refuse its short cache: {raised}")
            emit(phase=f"{phase}_main_refuses", argv=argv, error=raised,
                 main_max_len=LLM_PROMPT + 2 + LLM_GEN + 8,
                 prefill_rows=fcfg.n_image_tokens + LLM_PROMPT,
                 seconds=time.perf_counter() - t0)
            gc.collect()
            torch.cuda.empty_cache()
        for sampler in samplers_:
            path = f"{phase}_{sampler}"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            timers, routes, info = {"prefill": [], "model": [], "sample": []}, [], {}
            llm_ts.clear_cache()  # the path captures its own sampler programs
            with served_calls(cli_llm, llm, timers, info), recorded_routes(llm_moe, routes), \
                    path_run(path) as seen:
                t0 = time.perf_counter()
                if max_len is None:
                    row = cli_llm.main([*argv, "--sampler", sampler])
                else:
                    row = served_burst(cli_llm, fcfg, sampler, max_len)
                main_s = time.perf_counter() - t0
            peak_bytes = torch.cuda.max_memory_allocated()
            launches = launches_by_path[path]
            streams = row.pop("streams")
            check(row["device"].startswith("cuda"), f"{path} ran on {row['device']}")
            check(len(streams) == LLM_REQUESTS and all(
                len(t) == LLM_GEN + 1 and all(0 <= x < fcfg.vocab_size for x in t)
                for t in streams.values()), f"{path}: streams {streams}")
            check(row["tokens"] == LLM_REQUESTS * (LLM_GEN + 1), f"{path}: {row}")
            want = row["samples"] if sampler == "mcmc" else 0
            check(launches == {**{k: 0 for k in launches}, "mh_chain": want},
                  f"{path}: launches {launches}, {want} mh_chain wanted (one a sample)")
            check(len(timers["prefill"]) == LLM_REQUESTS
                  and len(timers["model"]) == row["decode_steps"]
                  and len(timers["sample"]) == row["samples"], f"{path}: timers {timers}")
            # the step's bound: the decoder's weights but the embedding, and
            # the cache (whisper's cross K/V included), read once; the SSM
            # state and conv inputs written once
            n_layers = fcfg.n_layers
            step_bytes = (info["decode_param_bytes"] + info["cache_bytes"]
                          + info["ssm_cache_bytes"])
            record = dict(phase=phase, arch=arch, path=path, argv=argv, main_s=main_s, **row,
                          launches=launches, layers=n_layers, d_model=fcfg.d_model,
                          vocab=fcfg.vocab_size, dtype=str(fcfg.param_dtype),
                          parameters=info["parameters"], param_bytes=info["param_bytes"],
                          max_memory_allocated=peak_bytes,
                          prefill_ms=timers["prefill"],
                          decode_model_ms_median=float(np.median(timers["model"])),
                          decode_model_ms_range=[min(timers["model"]), max(timers["model"])],
                          sample_ms_median=float(np.median(timers["sample"])),
                          decode_step_bytes=step_bytes,
                          decode_step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                          decode_step_bound_by="bytes", cache_bytes=info["cache_bytes"])
            if fcfg.is_encdec:
                record.update(cross_cache_bytes=info["cross_cache_bytes"],
                              encoder_layers=fcfg.n_encoder_layers,
                              encoder_len=fcfg.encoder_len)
            if fcfg.family == "vlm":
                record.update(image_tokens=fcfg.n_image_tokens)
            if is_moe:  # capacity drops of each prefill, experts used a decode step
                e, k = fcfg.n_experts, fcfg.moe_top_k
                ids = torch.arange(e, device=dev)
                per_call = []
                for experts in routes:
                    b, s = experts.shape[:2]
                    counts = (experts.reshape(b, -1)[..., None] == ids).sum(1)  # (B, E)
                    cap = llm_moe.capacity(s, e, k, fcfg.moe_capacity_factor)
                    per_call.append((s, int((counts - cap).clamp_min(0).sum()),
                                     int((counts.sum(0) > 0).sum())))
                prefills = [per_call[i:i + n_layers] for i in range(0, len(per_call), n_layers)
                            if per_call[i][0] > 1]
                steps = [per_call[i:i + n_layers] for i in range(0, len(per_call), n_layers)
                         if per_call[i][0] == 1]
                # one eager decode step a burst: the decode program's warm-up
                check(len(prefills) == LLM_REQUESTS and len(steps) == 1
                      and len(per_call) == n_layers * (LLM_REQUESTS + 1),
                      f"{path}: {len(per_call)} routed layers")
                expert_bytes = 3 * fcfg.d_model * fcfg.d_ff * fcfg.param_dtype.itemsize
                used_bound = [(step_bytes - expert_bytes * sum(e - u for _, _, u in st))
                              / HBM_BYTES_PER_S * 1e3 for st in steps]
                distinct = [float(np.mean([u for _, _, u in st])) for st in steps]
                record.update(
                    prefill_capacity_drops=[[sum(d for _, d, _ in pf), pf[0][0] * k * n_layers]
                                            for pf in prefills],
                    prefill_capacity=llm_moe.capacity(LLM_PROMPT, e, k, fcfg.moe_capacity_factor),
                    decode_steps_routed=len(steps),
                    decode_capacity_drops=sum(d for st in steps for _, d, _ in st),
                    decode_distinct_experts_per_layer_mean=distinct,
                    decode_distinct_experts_per_layer_max=max(u for st in steps
                                                              for _, _, u in st),
                    decode_step_used_experts_bound_ms_median=float(np.median(used_bound)),
                    decode_step_used_experts_bound_ms_range=[min(used_bound), max(used_bound)])
                check(record["decode_capacity_drops"] == 0, f"{path}: a decode step dropped")
            if sampler == "mcmc":  # the first launch is also timed in 12
                burst_tokens_per_s[arch] = row["tokens_per_s"]
                check("mh_chain" in seen, f"{path} launched no mh_chain")
                args, kw = seen["mh_chain"]
                diff, err, _ = hold("mh_chain", f"{path} first launch", from_launch(args), kw)
                record.update(first_launch_mismatches=diff, max_abs_err=err,
                              first_launch_shape=list(args[0].shape))
                check(0.0 < row["acceptance"] < 1.0, f"{path}: acceptance {row['acceptance']}")
            emit(**record)
            del seen, routes

        # the model cut to 2 layers in float32: card against CPU (and, with
        # two prompts, packed against solo on the card)
        gc.collect()
        torch.cuda.empty_cache()
        cfg2 = dataclasses.replace(
            fcfg, n_layers=LLM_CHECK_LAYERS, dtype="float32", param_dtype_str="float32",
            cache_dtype_str="float32",
            global_layers=tuple(g for g in fcfg.global_layers if g < LLM_CHECK_LAYERS),
            n_encoder_layers=min(fcfg.n_encoder_layers, LLM_CHECK_LAYERS))
        t0 = time.perf_counter()
        card_model = llm.init_lm(cfg2, seed=SEED, device=dev)
        host_model = llm.LM(cfg2, device="cpu")
        host_model.load_state_dict(card_model.state_dict())
        copy_s = time.perf_counter() - t0
        rs = np.random.default_rng(SEED)
        lens = (FAMILY_SSM_PROMPT,) if has_ssm else LLM_CHECK_LENS
        check_prompts = [rs.integers(0, fcfg.vocab_size, n) for n in lens]
        v_ = fcfg.vocab_size
        # the frontend stubs' inputs of each prompt, from a seed on the host
        host_gen = torch.Generator().manual_seed(AUDIO_CHECK_SEED if fcfg.is_encdec else SEED)
        check_extras = [{
            **({"image_embeds": torch.randn((1, fcfg.n_image_tokens, fcfg.image_embed_dim),
                                            generator=host_gen)}
               if fcfg.family == "vlm" else {}),
            **({"frames": torch.randn((1, fcfg.encoder_len, fcfg.frame_dim), generator=host_gen)}
               if fcfg.is_encdec else {}),
        } for _ in lens]

        def greedy_logits(model_, device, rows, cfg_=cfg2):
            """Per-row prefills spliced into one cache with a (B,) index, then
            greedy decode steps: the logits of every step and the experts
            chosen, on the host."""
            max_len_ = cfg_.n_image_tokens + max(lens) + LLM_CHECK_STEPS + 1
            chosen = []
            with torch.inference_mode(), recorded_routes(llm_moe, chosen):
                cache = llm.init_cache(cfg_, len(rows), max_len_, device)
                cache["index"] = torch.zeros(len(rows), dtype=torch.int32, device=device)
                first = []
                for r, i in enumerate(rows):
                    prompt = torch.as_tensor(check_prompts[i], dtype=torch.int32, device=device)
                    batch = {"tokens": prompt[None],
                             **{k: x.to(device) for k, x in check_extras[i].items()}}
                    row_logits, row = llm.prefill(model_, cfg_, batch,
                                                  llm.init_cache(cfg_, 1, max_len_, device))

                    def splice(shared, new):
                        shared[:, r:r + 1] = new

                    llm.tree_map(splice, cache["layers"], row["layers"])
                    cache["index"][r] = row["index"]
                    first.append(row_logits[0])
                out = [torch.stack(first)]
                for _ in range(LLM_CHECK_STEPS):
                    tokens = out[-1][:, :v_].argmax(-1).to(torch.int32)
                    step_logits, cache = llm.decode_step(model_, cfg_, tokens[:, None], cache)
                    out.append(step_logits)
            return [x[:, :v_].cpu() for x in out], [x.cpu() for x in chosen]

        def agree(a, b, what):
            """Largest logit difference of two runs, and their greedy tokens
            equal at every step whose top-two gap exceeds it (a step with a
            smaller gap fails: the seed must then be replaced)."""
            diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
            for t, (x, y) in enumerate(zip(a, b)):
                top = torch.topk(x, 2).values
                gap = float((top[:, 0] - top[:, 1]).min())
                check(gap > diff, f"{what}: a near tie at step {t} (gap {gap}, difference {diff}): "
                      f"replace SEED")
                check(torch.equal(x.argmax(-1), y.argmax(-1)), f"{what}: greedy tokens differ at "
                      f"step {t}")
            return diff

        rows_ = list(range(len(lens)))
        t0 = time.perf_counter()
        host_run, host_routes = greedy_logits(host_model, torch.device("cpu"), rows_)
        host_s = time.perf_counter() - t0
        card_run, card_routes = greedy_logits(card_model, dev, rows_)
        check(all(bool(torch.isfinite(x).all()) for x in card_run + host_run),
              f"{phase}: non-finite logits")
        # routing is discrete: the card must choose the CPU's experts (a
        # difference is a near tie of router probabilities: replace SEED)
        check(len(card_routes) == len(host_routes) and all(
            torch.equal(a, b) for a, b in zip(card_routes, host_routes)),
            f"{phase}: the card's experts differ from the CPU's")
        if not fcfg.is_encdec:
            card_cpu_diff = agree(card_run, host_run, "card against CPU")
        else:  # whisper's float32 cut is chaotic (AUDIO_CHECK_F64): reported
            card_cpu_diff = max(float((x - y).abs().max()) for x, y in zip(card_run, host_run))
        # the same weights in float64 on the CPU: the float32 runs' own
        # rounding, which a near one-hot attention over random weights
        # magnifies; the card must be within LLM_LOGIT_TOL of it, or within
        # FAMILY_F32_FACTOR times the CPU's float32 error where that is larger
        cfg64 = dataclasses.replace(cfg2, dtype="float64", param_dtype_str="float64",
                                    cache_dtype_str="float64")
        exact_model = llm.LM(cfg64, device="cpu")
        exact_model.load_state_dict({k: v.double() for k, v in host_model.state_dict().items()})
        exact_run, exact_routes = greedy_logits(exact_model, torch.device("cpu"), rows_, cfg64)
        if fcfg.is_encdec:
            # whisper is held in float64 on both sides, packed against solo too
            card64 = llm.LM(cfg64, device=dev)
            card64.load_state_dict(exact_model.state_dict())
            card64_run, _ = greedy_logits(card64, dev, rows_, cfg64)
            f64_diff = agree(card64_run, exact_run, "float64 card against float64 CPU")
            check(f64_diff <= AUDIO_F64_TOL, f"{phase}: float64 card against float64 CPU: "
                  f"{f64_diff} > {AUDIO_F64_TOL}")
            solo64 = [greedy_logits(card64, dev, [i], cfg64)[0] for i in rows_]
            solo64_run = [torch.cat([s_[t] for s_ in solo64])
                          for t in range(LLM_CHECK_STEPS + 1)]
            packed64_diff = agree(card64_run, solo64_run, "float64 packed against solo on the card")
            check(packed64_diff <= AUDIO_F64_TOL, f"{phase}: float64 packed against solo: "
                  f"{packed64_diff} > {AUDIO_F64_TOL}")
            del card64, card64_run, solo64, solo64_run
        del exact_model
        check(len(exact_routes) == len(host_routes) and all(
            torch.equal(a, b) for a, b in zip(exact_routes, host_routes)),
            f"{phase}: float64 chooses other experts than float32 (a near tie: replace SEED)")
        cpu_err = max(float((x.double() - y).abs().max()) for x, y in zip(host_run, exact_run))
        card_err = max(float((x.double() - y).abs().max()) for x, y in zip(card_run, exact_run))
        tol = max(LLM_LOGIT_TOL, FAMILY_F32_FACTOR * cpu_err)
        if not fcfg.is_encdec:
            agree(host_run, [x.float() for x in exact_run], "float32 against float64 on the CPU")
            check(card_err <= tol, f"card against float64: max |logit difference| {card_err} > "
                  f"{tol} (the CPU's float32 {cpu_err})")
        record = dict(phase=f"{phase}_card_equals_cpu", arch=arch, layers=LLM_CHECK_LAYERS,
                      d_model=cfg2.d_model, dtype="float32", prompt_lens=list(lens),
                      decode_steps=LLM_CHECK_STEPS,
                      max_logit=max(float(x.abs().max()) for x in host_run),
                      card_cpu_max_abs_diff=card_cpu_diff, card_float64_max_abs_diff=card_err,
                      cpu_float64_max_abs_diff=cpu_err, tolerance=tol,
                      greedy_tokens=[x.argmax(-1).tolist() for x in card_run],
                      routed_layers=len(card_routes), build_and_copy_s=copy_s,
                      cpu_run_s=host_s)
        if fcfg.is_encdec:
            record.update(tolerance=None, float32_tolerance_rule_not_applied=True,
                          float64_card_cpu_max_abs_diff=f64_diff,
                          float64_packed_solo_max_abs_diff=packed64_diff,
                          float64_tolerance=AUDIO_F64_TOL)
        elif len(lens) > 1:
            solo = [greedy_logits(card_model, dev, [i])[0] for i in rows_]
            solo_run = [torch.cat([s_[t] for s_ in solo]) for t in range(LLM_CHECK_STEPS + 1)]
            packed_diff = agree(card_run, solo_run, "packed against solo on the card")
            check(packed_diff <= LLM_LOGIT_TOL,
                  f"packed against solo: {packed_diff} > {LLM_LOGIT_TOL}")
            record["packed_solo_max_abs_diff"] = packed_diff
        if has_ssm:
            # one full-width Mamba-2 layer over the prompt's one chunk: the
            # chunked SSD (masked before its exponent) against the recurrence
            layer = card_model.layers[0]["mamba"]
            with torch.inference_mode():
                x = torch.randn((1, FAMILY_SSM_PROMPT, cfg2.d_model), generator=gen, device=dev)
                chunked, _ = llm_ssm.mamba2_full(layer, x, cfg2)
                recurrence = llm_ssm.mamba2_reference(layer, x, cfg2)
                dt = llm_ssm._softplus(llm_ssm._project(layer, x)[4].float() + layer["dt_bias"])
                decay = float((dt * torch.exp(layer["A_log"])).sum(1).max())
            scale = float(recurrence.abs().max())
            layer_diff = float((chunked - recurrence).abs().max())
            check(bool(torch.isfinite(chunked).all()), f"{phase}: the chunked SSD is not finite")
            check(decay > 88.0, f"{phase}: the chunk's decay {decay} does not pass 88")
            check(layer_diff <= SSM_LAYER_RTOL * scale, f"{phase}: chunked against the "
                  f"recurrence {layer_diff} > {SSM_LAYER_RTOL} x {scale}")
            record.update(ssm_chunk=min(cfg2.ssm_chunk, FAMILY_SSM_PROMPT),
                          max_chunk_decay=decay, layer_chunked_vs_recurrence=layer_diff,
                          layer_max_output=scale, layer_rtol=SSM_LAYER_RTOL)
            del x, chunked, recurrence, dt
        emit(**record)
        del host_model, card_model, host_run, card_run, host_routes, card_routes, exact_run
        gc.collect()
        torch.cuda.empty_cache()
        emit(phase=f"{phase}_total", seconds=time.perf_counter() - t_phase)

    @contextlib.contextmanager
    def recorded_train_steps(cli_train, record):
        """Time every train step ``launch/train.py`` runs (its
        ``compiled_step``: a capture or a replay on the card, the direct
        step on the CPU) between two synchronisations and keep its metrics
        on the host (``record``); yields a dict whose ``"programs"`` is the
        run's program cache; restores ``compiled_step`` on exit."""
        real, seen = cli_train.compiled_step, {}

        def run(programs, step_fn, model, opt, batch, n_micro, device):
            seen["programs"] = programs
            sync = model.embed.is_cuda
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_programs = len(programs)
            out = real(programs, step_fn, model, opt, batch, n_micro, device)
            if sync:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            record.append(dict(seconds=seconds, captured=len(programs) > n_programs,
                               **{k: float(out[k]) for k in (
                                   "loss", "grad_norm", "lr", "tokens", "ce_loss")}))
            return out

        cli_train.compiled_step = run
        try:
            yield seen
        finally:
            cli_train.compiled_step = real

    def train_lm_phase():
        """Phase 35; its names stay out of the phases after it."""
        import gc

        t_phase = time.perf_counter()
        from repro_torch import configs as llm_configs
        from repro_torch.core import token_sampler as llm_ts
        from repro_torch.launch import train as cli_train
        from repro_torch.models import lm as llm
        from repro_torch.optim import adamw as llm_adamw
        from repro_torch.training import step as llm_step

        # AdamW's fused multiply-adds (torch.addcmul) must round once on the
        # card, as XLA's contracted ones do: against the emulation
        fma_args = [torch.randn(1 << 22, generator=gen, device=dev) for _ in range(3)]
        fma_mismatches = int((llm_adamw.fma(*fma_args) != prng._fma32(*fma_args)).sum())
        check(fma_mismatches == 0, f"torch.addcmul is not one rounding on the card: "
              f"{fma_mismatches} of {1 << 22} differ from the fused multiply-add")
        del fma_args
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tcfg = llm_configs.get_config(TRAIN_ARCH)
        argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--n-micro", str(TRAIN_MICRO)]
        steps = []
        with recorded_train_steps(cli_train, steps) as seen_run, path_run("train_lm_steps"):
            t0 = time.perf_counter()
            row = cli_train.main(argv)
            main_s = time.perf_counter() - t0
        (train_program,) = seen_run["programs"].values()
        check(train_program.graph is not None and [x["captured"] for x in steps] == [True] + [
            False] * (TRAIN_STEPS - 1), f"train_lm: {len(seen_run['programs'])} programs, "
              f"captures {[x['captured'] for x in steps]}")
        peak_bytes = torch.cuda.max_memory_allocated()
        model, opt = row["model"], row["opt_state"]
        check(launches_by_path["train_lm_steps"] == {k: 0 for k in launches_by_path[
            "train_lm_steps"]}, f"training launched {launches_by_path['train_lm_steps']}")
        check(len(steps) == TRAIN_STEPS and row["losses"] == [x["loss"] for x in steps],
              f"train_lm: {len(steps)} steps recorded, losses {row['losses']}")
        check(all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]) for x in steps),
              f"train_lm: a loss or gradient is not finite: {steps}")
        check(all(x["tokens"] == TRAIN_BATCH * TRAIN_SEQ for x in steps), f"train_lm: {steps}")
        check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
              "train_lm: a parameter is not finite")
        check(int(opt["step"]) == TRAIN_STEPS, f"train_lm: optimizer step {int(opt['step'])}")
        n_params = sum(p.numel() for p in model.parameters())
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
        param_bytes = nbytes(model.parameters())
        moment_bytes = nbytes(opt["m"].values()) + nbytes(opt["v"].values())
        tokens = TRAIN_BATCH * TRAIN_SEQ
        # the step's arithmetic: 6 N a token for the forward and backward
        # products and 2 N more for the blocks recomputed in the backward
        # pass, plus attention's scores and values over every key block
        # (JAX's formulation masks, never skips): 4 B S^2 h dh a layer
        # forward, four times over with the backward and the recompute
        model_flops = 8 * n_params * tokens
        attn_flops = 16 * TRAIN_BATCH * TRAIN_SEQ ** 2 * tcfg.n_heads * tcfg.d_head * (
            tcfg.n_layers)
        bound_s = (model_flops + attn_flops) / BF16_OPS_PER_S
        warm = [x["seconds"] for x in steps[1:]]
        emit(phase="train_lm", argv=argv, main_s=main_s, arch=TRAIN_ARCH, layers=tcfg.n_layers,
             fma_mismatches=fma_mismatches,
             d_model=tcfg.d_model, dtype=str(tcfg.param_dtype), parameters=n_params,
             param_bytes=param_bytes, moment_bytes=moment_bytes,
             accumulator_bytes=4 * n_params if TRAIN_MICRO > 1 else 0,
             max_memory_allocated=peak_bytes, tokens_per_step=tokens, steps=steps,
             compiled=True, capture_step_s=steps[0]["seconds"],
             program_bytes=train_program.nbytes,
             step_s_median_after_first=float(np.median(warm)), step_s_range=[min(warm), max(warm)],
             flop_bound_s=bound_s, model_flops=model_flops, attention_flops=attn_flops,
             bound_by="operations", tokens_per_s_median=tokens / float(np.median(warm)),
             launches=launches_by_path["train_lm_steps"])
        dry_refs["train_lm"] = dict(
            param_bytes=param_bytes, moment_bytes=moment_bytes,
            opt_step_bytes=opt["step"].numel() * opt["step"].element_size(),
            max_memory_allocated=peak_bytes, model_flops=model_flops, attention_flops=attn_flops,
            step_s_median=float(np.median(warm)))

        # make_decode_sample_step on the trained weights: one mh_chain launch
        b_, plen = 4, 16
        prompt = torch.randint(0, tcfg.vocab_size, (b_, plen), generator=gen, device=dev,
                               dtype=torch.int32)
        cache = llm.init_cache(tcfg, b_, plen + 8, dev)
        _, cache = llm.prefill(model, tcfg, {"tokens": prompt}, cache)
        decode_sample = llm_step.make_decode_sample_step(tcfg)
        llm_ts.clear_cache()  # the sample is captured here, its first launch recorded
        with path_run("train_lm") as seen:
            tokens_, cache, acc = decode_sample(model, prompt[:, -1:], cache,
                                                prng.PRNGKey(SEED, device=dev))
        launches = launches_by_path["train_lm"]
        check(launches == {**{k: 0 for k in launches}, "mh_chain": 1},
              f"train_lm decode-sample: launches {launches}")
        check(tuple(tokens_.shape) == (b_, 1) and bool(((tokens_ >= 0)
                                                        & (tokens_ < tcfg.vocab_size)).all()),
              f"train_lm decode-sample: tokens {tokens_.tolist()}")
        args, kw = seen["mh_chain"]
        diff, err, _ = hold("mh_chain", "train_lm decode-sample first launch", from_launch(args),
                            kw)
        emit(phase="train_lm_decode_sample", batch=b_, prompt_len=plen,
             tokens=tokens_[:, 0].tolist(), acceptance=float(acc), launches=launches,
             first_launch_mismatches=diff, max_abs_err=err,
             first_launch_shape=list(args[0].shape), cache_index=int(cache["index"]))
        del model, opt, row, cache, seen, args, kw, train_program, seen_run
        gc.collect()
        torch.cuda.empty_cache()

        # the model cut to 2 layers in float32: two AdamW steps on the card,
        # on the CPU, and in float64 on the CPU (its optimizer state float32,
        # as AdamW keeps it), from the same weights and batches
        cfg2 = dataclasses.replace(tcfg, n_layers=LLM_CHECK_LAYERS, dtype="float32",
                                   param_dtype_str="float32", cache_dtype_str="float32",
                                   global_layers=tuple(g for g in tcfg.global_layers
                                                       if g < LLM_CHECK_LAYERS))
        cfg64 = dataclasses.replace(cfg2, dtype="float64", param_dtype_str="float64",
                                    cache_dtype_str="float64")
        host_model = llm.init_lm(cfg2, seed=SEED, device="cpu")
        start = {n: p.detach().double().clone() for n, p in host_model.named_parameters()}
        runs = {}
        for where, cfg_, device in (("card", cfg2, "cuda"), ("cpu", cfg2, "cpu"),
                                    ("float64", cfg64, "cpu")):
            model_ = llm.LM(cfg_, device=device)
            model_.load_state_dict({k: v.to(cfg_.param_dtype)
                                    for k, v in host_model.state_dict().items()})
            record = []
            t0 = time.perf_counter()
            with recorded_train_steps(cli_train, record):
                cli_train.run_training(cli_train.TrainRun(
                    cfg=cfg_, steps=TRAIN_CHECK_STEPS, global_batch=TRAIN_CHECK_BATCH,
                    seq_len=TRAIN_CHECK_SEQ, n_micro=TRAIN_MICRO, seed=SEED, log_every=100,
                    device=device), model=model_)
            params = {n: p.detach().cpu().double() for n, p in model_.named_parameters()}
            runs[where] = (record, params, time.perf_counter() - t0)
            del model_
        ref_steps, ref_params, _ = runs["float64"]
        lr_sum = sum(x["lr"] for x in ref_steps)
        errs = {}
        for where in ("card", "cpu"):
            steps_, params, _ = runs[where]
            rms = {}
            for n, p in params.items():
                update_rms = float((ref_params[n] - start[n]).square().mean().sqrt())
                rms[n] = (float((p - ref_params[n]).square().mean().sqrt()), update_rms)
            errs[where] = dict(
                loss=max(abs(a["loss"] - b["loss"]) for a, b in zip(steps_, ref_steps)),
                gnorm=max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                          for a, b in zip(steps_, ref_steps)),
                param_max=max(float((p - ref_params[n]).abs().max()) for n, p in params.items()),
                rms=rms)
        card_e, cpu_e = errs["card"], errs["cpu"]
        loss_tol = max(TRAIN_LOSS_TOL, FAMILY_F32_FACTOR * cpu_e["loss"])
        gnorm_tol = max(TRAIN_GNORM_RTOL, FAMILY_F32_FACTOR * cpu_e["gnorm"])
        check(card_e["loss"] <= loss_tol, f"train cut: losses {card_e['loss']} from float64, "
              f"past {loss_tol}")
        check(card_e["gnorm"] <= gnorm_tol, f"train cut: grad norms {card_e['gnorm']} from "
              f"float64 (relative), past {gnorm_tol}")
        worst_leaf, worst_ratio = None, 0.0
        for n, (card_rms, update_rms) in card_e["rms"].items():
            allowed = max(TRAIN_PARAM_RMS_RTOL * update_rms,
                          FAMILY_F32_FACTOR * cpu_e["rms"][n][0])
            ratio = card_rms / allowed if allowed > 0 else (0.0 if card_rms == 0 else np.inf)
            if ratio > worst_ratio:
                worst_leaf, worst_ratio = n, ratio
        check(worst_ratio <= 1.0, f"train cut: {worst_leaf}'s difference from float64 is "
              f"{worst_ratio} of its allowance")
        check(card_e["param_max"] <= 2 * lr_sum, f"train cut: a parameter {card_e['param_max']}"
              f" from float64, past 2 x the summed lr {lr_sum}")
        emit(phase="train_lm_card_equals_cpu", arch=TRAIN_ARCH, layers=LLM_CHECK_LAYERS,
             dtype="float32", steps=TRAIN_CHECK_STEPS, batch=TRAIN_CHECK_BATCH,
             seq=TRAIN_CHECK_SEQ, n_micro=TRAIN_MICRO,
             losses={w: [x["loss"] for x in r[0]] for w, r in runs.items()},
             grad_norms={w: [x["grad_norm"] for x in r[0]] for w, r in runs.items()},
             card_loss_err=card_e["loss"], cpu_loss_err=cpu_e["loss"], loss_tolerance=loss_tol,
             card_grad_norm_rel_err=card_e["gnorm"], cpu_grad_norm_rel_err=cpu_e["gnorm"],
             grad_norm_tolerance=gnorm_tol,
             card_param_max_abs_err=card_e["param_max"],
             cpu_param_max_abs_err=cpu_e["param_max"], lr_sum=lr_sum,
             worst_param_leaf=worst_leaf, worst_param_share_of_allowance=worst_ratio,
             seconds={w: r[2] for w, r in runs.items()})
        del runs, ref_params, errs
        del host_model, start
        gc.collect()
        torch.cuda.empty_cache()
        emit(phase="train_lm_total", seconds=time.perf_counter() - t_phase)

    def compiled_train_case(arch, layers, rows, seq, n_micro):
        """Phase 40 on one case; its names stay out of the phases after it."""
        import gc
        import operator

        from repro_torch import compiled as llm_compiled
        from repro_torch import configs as llm_configs
        from repro_torch.data import DataConfig, SyntheticTokenPipeline
        from repro_torch.launch import train as cli_train
        from repro_torch.models import lm as llm
        from repro_torch.optim import adamw_init
        from repro_torch.training import step as llm_step

        t_case = time.perf_counter()
        cfg = llm_configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = cli_train.TrainRun(cfg=cfg, steps=CT_STEPS, global_batch=rows, seq_len=seq,
                                 n_micro=n_micro, seed=SEED)
        model = llm.init_lm(cfg, SEED, dev)
        opt_cfg, step_fn = cli_train.run_step_fn(run)
        opt = adamw_init(model, opt_cfg)
        data = SyntheticTokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                 global_batch=rows, seed=SEED), device=dev)
        batches = [data.host_batch(t) for t in range(CT_STEPS + 2)]  # 2 more traced
        tensors = cli_train.state_tensors(model, opt)
        where = f"compiled_train {arch}"

        @torch.no_grad()
        def to_host(ts):
            """Copies of ``ts`` in pinned host memory, one flat buffer a dtype."""
            sizes = collections.Counter()
            for t in ts:
                sizes[t.dtype] += t.numel()
            flat = {dt: torch.empty(n, dtype=dt, pin_memory=True) for dt, n in sizes.items()}
            at, out = collections.Counter(), []
            for t in ts:
                h = flat[t.dtype][at[t.dtype]:at[t.dtype] + t.numel()].view(t.shape)
                at[t.dtype] += t.numel()
                out.append(h.copy_(t, non_blocking=True))
            torch.cuda.synchronize()
            return out

        words = {4: torch.int32, 2: torch.int16}

        @torch.no_grad()
        def digest(ts):
            """Each tensor's bits as integers: their int64 sum and sum of
            squares (wrapping), a fingerprint of the state that any changed
            bit almost surely moves."""
            out = []
            for t in ts:
                w = t.reshape(-1).view(words[t.element_size()]).long()
                out.append(torch.stack([w.sum(), (w * w).sum()]))
            return torch.stack(out)

        def synced(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # the eager twin: CT_STEPS steps from the saved state, the
        # optimizer's share of each timed
        t0 = time.perf_counter()
        start = to_host(tensors)
        save_s = time.perf_counter() - t0
        real_update, real_loss, real_capture = (llm_step.adamw_update, llm.train_loss,
                                                llm_compiled.capture)
        optimizer_s, eager_s, eager_metrics, eager_digests = [], [], [], []

        def timed_update(*args, **kw):
            out, seconds = synced(lambda: real_update(*args, **kw))
            optimizer_s.append(seconds)
            return out

        llm_step.adamw_update = timed_update
        try:
            for t in range(CT_STEPS):
                (_, _, m), seconds = synced(lambda: step_fn(model, opt, batches[t]))
                eager_s.append(seconds)
                eager_metrics.append({k: m[k].clone() for k in cli_train.METRICS})
                eager_digests.append(digest(tensors))
        finally:
            llm_step.adamw_update = real_update
        eager_end = to_host(tensors)
        t0 = time.perf_counter()
        with torch.no_grad():
            for t, h in zip(tensors, start):
                t.copy_(h, non_blocking=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del start
        check(all(map(operator.is_, tensors, cli_train.state_tensors(model, opt))),
              f"{where}: the state's tensors were replaced")

        # the compiled steps: the first captures, the others replay
        programs, captures = {}, []
        host_calls = {"train_loss": 0, "adamw_update": 0}

        def capture(*args, **kw):
            out, seconds = synced(lambda: real_capture(*args, **kw))
            captures.append(seconds)
            return out

        def counted(fn, name):
            def run_(*args, **kw):
                host_calls[name] += 1
                return fn(*args, **kw)
            return run_

        compiled_s, compiled_metrics, compiled_digests = [], [], []
        llm_compiled.capture = capture
        try:
            for t in range(CT_STEPS):
                if t == 1:  # the replays: no model or optimizer call from the host
                    llm.train_loss = counted(real_loss, "train_loss")
                    llm_step.adamw_update = counted(real_update, "adamw_update")
                m, seconds = synced(lambda: cli_train.compiled_step(
                    programs, step_fn, model, opt, batches[t], n_micro, dev))
                compiled_s.append(seconds)
                compiled_metrics.append(m)
                compiled_digests.append(digest(tensors))
            peak_bytes = torch.cuda.max_memory_allocated()
            for t in range(CT_STEPS):
                check(all(torch.equal(compiled_metrics[t][k], eager_metrics[t][k])
                          for k in cli_train.METRICS),
                      f"{where} step {t}: metrics {compiled_metrics[t]} against the eager "
                      f"twin's {eager_metrics[t]}")
                check(torch.equal(compiled_digests[t], eager_digests[t]),
                      f"{where} step {t}: the state's digest differs from the eager twin's")
            differing = [i for i, (t, h) in enumerate(zip(tensors, eager_end))
                         if not torch.equal(t, h.to(dev, non_blocking=True))]
            check(not differing, f"{where}: {len(differing)} state tensors differ from the "
                  f"eager twin's after {CT_STEPS} steps (first {differing[:4]})")
            del eager_end
            # one replayed step and one eager step under the profiler
            calls = []
            events, wall_ms = traced(torch, lambda: cli_train.compiled_step(
                programs, step_fn, model, opt, batches[CT_STEPS], n_micro, dev),
                host_calls=calls)
        finally:
            llm_compiled.capture = real_capture
            llm.train_loss, llm_step.adamw_update = real_loss, real_update
        check(host_calls == {"train_loss": 0, "adamw_update": 0},
              f"{where}: a replayed step called {host_calls} from the host")
        graph_launches = sum(n == "cudaGraphLaunch" for n in calls)
        check(graph_launches == 1 and len(programs) == 1 and len(captures) == 1,
              f"{where}: a replayed step made {graph_launches} graph launches; "
              f"{len(programs)} programs, {len(captures)} captures")
        eager_calls = []
        eager_events, eager_wall_ms = traced(
            torch, lambda: step_fn(model, opt, batches[CT_STEPS + 1]), host_calls=eager_calls)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        eager_busy = sum(e.self_device_time_total for e in eager_events) / 1e3
        by_kernel = collections.defaultdict(lambda: [0.0, 0])  # the replay's device ms
        for e in events:
            by_kernel[e.name[:100]][0] += e.self_device_time_total / 1e3
            by_kernel[e.name[:100]][1] += 1
        (sig, program), = programs.items()

        # the bounds: 6 N a token forward and backward plus 2 N recomputed
        # (N the parameters a token meets: top_k of n_experts experts),
        # attention as phase 35 counts it; and the state read and written
        # once with the batch read
        n_params = sum(p.numel() for p in model.parameters())
        expert = sum(p.numel() for n, p in model.named_parameters() if ".moe.w_" in n)
        active = n_params - expert + (expert * cfg.moe_top_k / cfg.n_experts if expert else 0)
        tokens = rows * seq
        model_flops = 8 * active * tokens
        attn_flops = 16 * rows * seq ** 2 * cfg.n_heads * cfg.d_head * cfg.n_layers
        flop_bound_s = (model_flops + attn_flops) / BF16_OPS_PER_S
        state_bytes = sum(t.numel() * t.element_size() for t in tensors)
        batch_bytes = sum(x.numel() * x.element_size() for x in batches[0].values())
        state_bound_s = (2 * state_bytes + batch_bytes) / HBM_BYTES_PER_S
        emit(phase="compiled_train", arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
             rows=rows, seq=seq, n_micro=n_micro, steps=CT_STEPS, parameters=n_params,
             active_parameters=active, signature=str(sig), bit_equal_eager=True,
             metrics=[{k: float(v) for k, v in m.items()} for m in compiled_metrics],
             eager_step_s=eager_s, eager_optimizer_s=optimizer_s,
             compiled_step_s=compiled_s, capture_call_s=captures[0],
             replay_step_s_median=float(np.median(compiled_s[1:])),
             eager_step_s_median=float(np.median(eager_s)),
             program_bytes=program.nbytes, state_bytes=state_bytes,
             max_memory_allocated=peak_bytes, save_s=save_s, restore_s=restore_s,
             traced_replay_wall_ms=wall_ms, traced_replay_busy_ms=busy,
             traced_replay_busy_share=busy / wall_ms, replay_device_events=len(events),
             replay_device_ms_by_kernel=sorted(([n, ms, k] for n, (ms, k) in by_kernel.items()),
                                               key=lambda x: -x[1])[:15],
             traced_eager_wall_ms=eager_wall_ms, traced_eager_busy_ms=eager_busy,
             traced_eager_busy_share=eager_busy / eager_wall_ms,
             replay_graph_launches=graph_launches,
             replay_kernel_launch_calls=sum("Launch" in n and n != "cudaGraphLaunch"
                                            for n in calls),
             replay_memcpy_calls=sum("Memcpy" in n for n in calls),
             eager_kernel_launch_calls=sum("Launch" in n for n in eager_calls),
             flop_bound_s=flop_bound_s, model_flops=model_flops, attention_flops=attn_flops,
             state_bytes_bound_s=state_bound_s, bound_by="operations"
             if flop_bound_s >= state_bound_s else "bytes", host_calls_in_replays=host_calls,
             case_s=time.perf_counter() - t_case)
        del model, opt, tensors, programs, program, batches, data, step_fn
        del eager_metrics, compiled_metrics, eager_digests, compiled_digests, events
        gc.collect()
        torch.cuda.empty_cache()
        getattr(torch._C, "_host_emptyCache", lambda: None)()  # the pinned copies

    def mesh_lm_phase():
        """Phase 36; its names stay out of the phases after it."""
        import gc

        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor

        from repro_torch import configs as llm_configs
        from repro_torch.core import token_sampler as llm_ts
        from repro_torch.distributed import compression
        from repro_torch.distributed import sharding as llm_sharding
        from repro_torch.models import lm as llm
        from repro_torch.models import moe as llm_moe
        from repro_torch.models.layers import activation
        from repro_torch.optim import adamw as llm_adamw
        from repro_torch.training import step as llm_step

        t_phase = time.perf_counter()

        def whole(t):
            return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                                rank=0, device_id=dev)
        try:
            mesh = DeviceMesh("cuda", [[[0]]], mesh_dim_names=("pod", "data", "model"))

            # (a) the compressed-pod step at full width and depth
            tcfg = llm_configs.get_config(TRAIN_ARCH)
            model = llm.init_lm(tcfg, seed=SEED, device=dev)
            step_fn = llm_step.make_train_step(
                tcfg, axes_tree=model.param_axes,
                step_cfg=llm_step.TrainStepConfig(n_micro=TRAIN_MICRO, compress_pods=True),
                mesh=mesh)
            with llm_sharding.use_mesh(mesh):
                llm_sharding.distribute_params(model, mesh)
                opt = llm_adamw.adamw_init(model)
                err = compression.init_error_state(dict(model.named_parameters()))
            n_params = sum(p.numel() for p in model.parameters())
            n_leaves = len(dict(model.named_parameters()))
            err_bytes = sum(e.to_local().numel() * 4 for e in err.values())
            held, real = [], llm_step.compressed_pmean
            compress_s, hold_s = [], []

            def held_pmean(grads, err_, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                red, new_err = real(grads, err_, **kw)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for n, g in grads.items():  # leaf by leaf: one leaf's copies at a time
                    pr, pe = compression.compressed_mean_one_pod({n: g.to_local()},
                                                                 {n: err_[n].to_local()})
                    held.append(int((pr[n] != red[n].to_local()).sum())
                                + int((pe[n] != new_err[n].to_local()).sum()))
                    del pr, pe
                torch.cuda.synchronize()
                compress_s.append(t1 - t0)
                hold_s.append(time.perf_counter() - t1)
                return red, new_err

            steps = []
            llm_step.compressed_pmean = held_pmean
            compression.PAYLOAD.clear()
            try:
                with path_run("mesh_lm_steps"):
                    for t in range(MESH_STEPS):
                        toks = torch.randint(0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                                             generator=gen, device=dev)
                        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        model, opt, metrics, err = step_fn(model, opt, batch, err)
                        torch.cuda.synchronize()
                        # the step's seconds without the check against the
                        # plain version, which runs inside it
                        steps.append(dict(seconds=time.perf_counter() - t0 - hold_s[-1],
                                          compress_s=compress_s[-1], hold_s=hold_s[-1],
                                          **{k: float(metrics[k]) for k in (
                                              "loss", "grad_norm", "tokens")}))
            finally:
                llm_step.compressed_pmean = real
            peak_bytes = torch.cuda.max_memory_allocated()
            payload = dict(compression.PAYLOAD)
            check(len(held) == MESH_STEPS * n_leaves and not any(held),
                  f"mesh_lm: the compressed step differs from the plain one-pod version in "
                  f"{sum(held)} values over {len(held)} leaf checks")
            check(payload == {"int32": MESH_STEPS * 4 * n_params,
                              "float32": MESH_STEPS * 4 * n_leaves},
                  f"mesh_lm: the pod all-reduce sent {payload}")
            check(all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]) for x in steps),
                  f"mesh_lm: a loss or gradient norm is not finite: {steps}")
            check(all(x["tokens"] == TRAIN_BATCH * TRAIN_SEQ for x in steps), f"mesh_lm: {steps}")
            check(launches_by_path["mesh_lm_steps"] == {k: 0 for k in launches_by_path[
                "mesh_lm_steps"]}, f"mesh_lm steps launched {launches_by_path['mesh_lm_steps']}")
            emit(phase="mesh_lm_compressed_step", arch=TRAIN_ARCH, layers=tcfg.n_layers,
                 mesh={"pod": 1, "data": 1, "model": 1}, backend="nccl", parameters=n_params,
                 leaves=n_leaves, batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_micro=TRAIN_MICRO,
                 steps=steps, payload_bytes=payload, error_state_bytes=err_bytes,
                 max_memory_allocated=peak_bytes, leaf_checks=len(held),
                 values_differing_from_plain=sum(held), tolerance=0)

            # (d) one sampled token through make_decode_sample_step on (a)'s model
            b_, plen = 4, 16
            prompt = torch.randint(0, tcfg.vocab_size, (b_, plen), generator=gen, device=dev,
                                   dtype=torch.int32)
            with llm_sharding.use_mesh(mesh), llm_sharding.use_rules(
                    llm_sharding.rules_for_config(tcfg)):
                cache = llm.init_cache(tcfg, b_, plen + 8, dev)
                _, cache = llm.prefill(model, tcfg, {"tokens": prompt}, cache)
                decode_sample = llm_step.make_decode_sample_step(tcfg)
                # phase 35 captured this signature's sampler: capture it
                # again here, under the mesh, so that its first launch is
                # recorded
                llm_ts.clear_cache()
                with path_run("mesh_lm") as seen:
                    tokens_, cache, acc = decode_sample(model, prompt[:, -1:], cache,
                                                        prng.PRNGKey(SEED, device=dev))
            launches = launches_by_path["mesh_lm"]
            check(launches == {**{k: 0 for k in launches}, "mh_chain": 1},
                  f"mesh_lm decode-sample: launches {launches}")
            check(tuple(tokens_.shape) == (b_, 1) and bool(
                ((tokens_ >= 0) & (tokens_ < tcfg.vocab_size)).all()),
                f"mesh_lm decode-sample: tokens {tokens_.tolist()}")
            args, kw = seen["mh_chain"]
            diff, merr, _ = hold("mh_chain", "mesh_lm decode-sample first launch",
                                 from_launch(args), kw)
            emit(phase="mesh_lm_decode_sample", batch=b_, prompt_len=plen,
                 tokens=tokens_[:, 0].tolist(), acceptance=float(acc), launches=launches,
                 first_launch_mismatches=diff, max_abs_err=merr,
                 cache_placements=[str(p) for p in cache["layers"]["attn"]["k"].placements])
            del model, opt, err, cache, seen, args, kw, step_fn
            gc.collect()
            torch.cuda.empty_cache()

            # (b) the model rules on one rank: granite-3 8B at full width, 2 layers
            gcfg = dataclasses.replace(llm_configs.get_config(LLM_ARCH),
                                       n_layers=MESH_RULES_LAYERS)
            gmodel = llm.init_lm(gcfg, seed=SEED, device=dev)
            toks = torch.randint(0, gcfg.vocab_size, (MESH_RULES_BATCH, MESH_RULES_SEQ),
                                 generator=gen, device=dev)

            def rules_run():
                with torch.no_grad():
                    loss, _ = llm.train_loss(gmodel, gcfg, {"tokens": toks, "labels": toks})
                cache_ = llm.init_cache(gcfg, MESH_RULES_BATCH, MESH_PROMPT + MESH_DECODE, dev)
                out = [loss]
                logits, cache_ = llm.prefill(gmodel, gcfg, {"tokens": toks[:, :MESH_PROMPT]},
                                             cache_)
                out.append(logits)
                for i in range(MESH_DECODE):
                    logits, cache_ = llm.decode_step(
                        gmodel, gcfg, toks[:, MESH_PROMPT + i:MESH_PROMPT + i + 1], cache_)
                    out.append(logits)
                out.append(cache_["layers"]["k"])
                torch.cuda.synchronize()
                return out

            t0 = time.perf_counter()
            plain = rules_run()
            plain_s = time.perf_counter() - t0
            with llm_sharding.use_mesh(mesh), llm_sharding.use_rules(
                    llm_sharding.rules_for_config(gcfg)):
                llm_sharding.distribute_params(gmodel, mesh)
                t0 = time.perf_counter()
                meshed = rules_run()
                mesh_s = time.perf_counter() - t0
                on_card = all(isinstance(t, DTensor) and t.is_cuda for t in meshed) and all(
                    isinstance(p, DTensor) and p.is_cuda for p in gmodel.parameters())
                cache_pl = [str(p) for p in meshed[-1].placements]
                meshed = [whole(t) for t in meshed]
            rules_diff = [int((a != b).sum()) for a, b in zip(plain, meshed)]
            check(on_card, "mesh_lm rules: a result or parameter is not a DTensor on the card")
            check(not any(rules_diff), f"mesh_lm rules: values differing from the run without "
                  f"a mesh: {rules_diff} (loss, prefill, decode steps, cache)")
            emit(phase="mesh_lm_rules", arch=LLM_ARCH, layers=MESH_RULES_LAYERS,
                 d_model=gcfg.d_model, dtype=str(gcfg.param_dtype), batch=MESH_RULES_BATCH,
                 seq=MESH_RULES_SEQ, prompt=MESH_PROMPT, decode_steps=MESH_DECODE,
                 rules=dict(gcfg.sharding_overrides), cache_placements=cache_pl,
                 values_differing=rules_diff, tolerance=0, loss=float(plain[0]),
                 seconds=mesh_s, no_mesh_seconds=plain_s)
            del gmodel, plain, meshed
            gc.collect()
            torch.cuda.empty_cache()

            # (c) moe_ffn_ep at one qwen3-moe-30b layer's full width
            qcfg = llm_configs.get_config("qwen3_moe_30b")
            params = dict(llm_moe.init_moe(gen, qcfg, device=dev))
            x = torch.randn((MESH_MOE_ROWS, MESH_MOE_SEQ, qcfg.d_model), generator=gen,
                            device=dev).to(qcfg.param_dtype)
            dout = torch.randn(x.shape, generator=gen, device=dev).to(qcfg.param_dtype)
            leaves = [x.requires_grad_(True), *(p.requires_grad_(True) for p in params.values())]
            y, _ = llm_moe.moe_ffn_local(params, x, qcfg, activation(qcfg.act))
            want = [y.detach(), *torch.autograd.grad(y, leaves, dout)]
            with llm_sharding.use_mesh(mesh):
                holder = torch.nn.Module()
                holder.moe = torch.nn.ParameterDict(params)
                holder.param_axes = {f"moe.{n}": p.logical_axes for n, p in params.items()}
                llm_sharding.distribute_params(holder, mesh)
                placed = dict(holder.moe.items())
                xd = llm_sharding.shard(x.detach(), ("batch", "seq", "embed")).requires_grad_(True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                yd, _ = llm_moe.moe_ffn_ep(placed, xd, qcfg, activation(qcfg.act), mesh)
                got = [yd, *torch.autograd.grad(
                    yd, [xd, *placed.values()], llm_sharding.shard(dout, ("batch", "seq",
                                                                          "embed")))]
                got = [whole(t) for t in got]
                torch.cuda.synchronize()
                ep_s = time.perf_counter() - t0
            ep_diff = [int((a != b).sum()) for a, b in zip(want, got)]
            check(not any(ep_diff), f"mesh_lm moe_ffn_ep: values differing from moe_ffn_local: "
                  f"{ep_diff} (out, dx, router, gate, up, down)")
            emit(phase="mesh_lm_moe_ep", arch="qwen3_moe_30b", experts=qcfg.n_experts,
                 top_k=qcfg.moe_top_k, d_model=qcfg.d_model, d_ff=qcfg.d_ff,
                 rows=MESH_MOE_ROWS, seq=MESH_MOE_SEQ, dtype=str(qcfg.param_dtype),
                 values_differing=ep_diff, tolerance=0, seconds=ep_s)
            del params, placed, holder, want, got, x, dout, leaves
        finally:
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        emit(phase="mesh_lm_total", seconds=time.perf_counter() - t_phase)

    def dryrun_phase():
        """Phase 37: collect the dry-run children started after the build."""
        from repro_torch.launch import roofline

        t_phase = time.perf_counter()
        for name, (proc, log) in dry_children.items():
            try:
                rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                                     - t_start)))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = "timeout"
            tail = log.read_text()[-3000:]
            check(rc == 0, f"dryrun child {name} ended with {rc}: {tail}")
        waited_s = time.perf_counter() - t_phase

        def gb(x):
            return x / 1e9

        def summary(r):
            """A report's numbers per device, and its roofline terms."""
            mem, hc = r["memory_analysis"], r["hlo_cost"]
            rl = roofline.analyse(r)["roofline"]
            return dict(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"], chips=r["chips"],
                kind=r["kind"], flops=hc["flops"], bytes=hc["bytes"],
                bytes_upper=hc["bytes_upper"], collectives=hc["collectives"],
                argument_gb=gb(mem["argument_size_bytes"]),
                peak_gb=gb(mem["argument_size_bytes"] + mem["temp_size_bytes"]),
                temp_gb=gb(mem["temp_size_bytes"]), argument_bytes=r["argument_bytes"],
                trace_s=r["trace_s"], rss_gb_before=gb(r["rss_bytes_before"]),
                max_rss_gb=gb(r["max_rss_bytes"]),
                device_allocated_bytes=r.get("device_allocated_bytes"),
                custom_ops=r["custom_ops"], roofline_compute_s=rl["compute_s"],
                roofline_memory_s=rl["memory_s"], roofline_collective_s=rl["collective_s"],
                roofline_dominant=rl["dominant"], useful_flops_ratio=rl["useful_flops_ratio"])

        def hold_jax_plan(name, r, jax_counts):
            """The decode-sample cell against the JAX package's counts: its
            FLOPs, its gathers and its collective total; returns what is
            printed beside the cell."""
            flops, coll = r["hlo_cost"]["flops"], r["hlo_cost"]["collectives"]
            gathered = coll.get("all-gather", 0)
            ratio = coll.get("total", 0) / jax_counts["total"]
            check(abs(flops - jax_counts["flops"]) <= 1e-9 * jax_counts["flops"],
                  f"dryrun {name}: FLOPs {flops} against JAX's {jax_counts['flops']}")
            check(gathered < DRYRUN_MAX_ALL_GATHER,
                  f"dryrun {name}: all-gather bytes {gathered} (a weight gathered?)")
            check(ratio <= DRYRUN_MAX_COLLECTIVE_RATIO,
                  f"dryrun {name}: collective bytes {coll} are {ratio:.3f}x JAX's {jax_counts}")
            weights = sorted({w for kind, _, _, w in r["collective_ops"]
                              if kind == "all-gather" and w is not None})
            check(not weights, f"dryrun {name}: weights all-gathered: {weights}")
            by_op = collections.Counter()
            for kind, nbytes, shape, _ in r["collective_ops"]:
                by_op[kind, str(shape)] += nbytes
            return dict(jax_counts=jax_counts, jax_counts_are="the JAX package's dry run on "
                        "the CPU (jax 0.9.0): XLA's counts, not times",
                        flops_over_jax=flops / jax_counts["flops"], collectives_over_jax=ratio,
                        largest_collectives=[[k, sh, b] for (k, sh), b in by_op.most_common(6)])

        # (a) the CLI on the production meshes
        card_reports = {}
        for name, mesh_dir, report_name, args in DRYRUN_CLI:
            r = card_reports[name] = json.loads(
                (dry_dir / mesh_dir / f"{report_name}.json").read_text())
            check(r["status"] == "ok" and r["device"] == "cuda",
                  f"dryrun {name}: {r.get('status')} {r.get('error')}")
            check(r["chips"] == (512 if "--multi-pod" in args else 256), f"dryrun {name}: {r}")
            beside = {}
            if "--decode-sample" in args:  # the MH kernel's fake implementation, once
                check(r["custom_ops"] == {"repro_torch::mh_chain": 1},
                      f"dryrun {name}: custom operators reached {r['custom_ops']}")
                beside = hold_jax_plan(name, r, DRYRUN_JAX[mesh_dir])
            emit(phase="dryrun_cli", cell=name, argv=args, **summary(r), **beside)
        name, twin, mesh_dir, report_name, args = DRYRUN_CPU_TWIN
        r = json.loads((dry_dir / mesh_dir / f"{report_name}.json").read_text())
        check(r["status"] == "ok" and r["device"] == "cpu",
              f"dryrun {name}: {r.get('status')} {r.get('error')}")
        card_coll = card_reports[twin]["hlo_cost"]["collectives"]
        cpu_coll = r["hlo_cost"]["collectives"]
        check(cpu_coll == card_coll and r["hlo_cost"]["flops"] == card_reports[twin][
            "hlo_cost"]["flops"], f"dryrun {name}: collective bytes {cpu_coll} on the CPU "
              f"against the card's {card_coll}")
        emit(phase="dryrun_cpu_twin", cell=name, twin=twin, argv=args,
             flops=r["hlo_cost"]["flops"], collectives=cpu_coll, card_collectives=card_coll,
             collectives_differing_bytes=0, trace_s=r["trace_s"])

        # (b) phases 35 and 29's steps on a 1 x 1 fake mesh against what they measured
        shapes = json.loads((dry_dir / "phase_shapes.json").read_text())
        tr, ref_t = shapes["train_lm"], dry_refs["train_lm"]
        args_b = tr["argument_bytes"]
        real_opt = ref_t["moment_bytes"] + ref_t["opt_step_bytes"]
        check(args_b["params"] == ref_t["param_bytes"] and args_b["opt"] == real_opt,
              f"dryrun train_lm: argument bytes {args_b} against the real parameters "
              f"{ref_t['param_bytes']} and AdamW state {real_opt} (tolerance 0)")
        s_t = summary(tr)
        formula = ref_t["model_flops"] + ref_t["attention_flops"]
        emit(phase="dryrun_train_lm", **s_t, real_param_bytes=ref_t["param_bytes"],
             real_opt_bytes=real_opt, argument_bytes_differing=0,
             flops_over_formula=s_t["flops"] / formula, formula_flops=formula,
             peak_over_measured=(s_t["peak_gb"] * 1e9) / ref_t["max_memory_allocated"],
             measured_peak_gb=gb(ref_t["max_memory_allocated"]),
             measured_step_s_median=ref_t["step_s_median"],
             roofline_bound_s=max(s_t["roofline_compute_s"], s_t["roofline_memory_s"],
                                  s_t["roofline_collective_s"]))
        sv, ref_s = shapes["serve_lm"], dry_refs["serve_lm"]
        s_s = summary(sv)
        emit(phase="dryrun_serve_lm", **s_s,
             real_param_and_cache_bytes=ref_s["param_bytes"] + ref_s["kv_bytes"],
             flops_over_formula=s_s["flops"] / ref_s["step_ops"], formula_flops=ref_s["step_ops"],
             measured_model_ms_median=ref_s["model_ms_median"],
             roofline_bound_ms=1e3 * max(s_s["roofline_compute_s"], s_s["roofline_memory_s"],
                                         s_s["roofline_collective_s"]))
        shutil.rmtree(dry_dir, ignore_errors=True)
        emit(phase="dryrun_total", seconds=time.perf_counter() - t_phase, waited_s=waited_s)

    for phase_, arch_, samplers_ in FAMILY_PHASES:
        with depth_cut(arch_):
            serve_family_phase(phase_, arch_, samplers_)

    # 33-34. the VLM and audio families ----------------------------------------
    serve_family_phase("serve_lm_vlm", VLM_ARCH, ("mcmc", "greedy"), max_len=VLM_MAX_LEN)
    serve_family_phase("serve_lm_audio", AUDIO_ARCH, ("mcmc", "greedy"))

    # 39. compiled_serve: the server's decode and sampler programs ---------------
    def compiled_serve_case(arch, max_len):
        """One full-width server (qwen3-moe at its DEPTH_CUTS depth) serving
        CS_REQUESTS requests of CS_GEN tokens on LLM_SLOTS slots through its
        decode program and the sampler's programs: every step (the slots
        refilled halfway) is held at tolerance 0 against eager calls of
        ``lm.decode_step`` and the sampler on clones of the state before
        it, and every sample against the eager sampler on its logits;
        then the replayed and eager steps are timed and traced."""
        import gc

        from repro_torch import compiled as llm_compiled
        from repro_torch import configs as llm_configs
        from repro_torch.core import token_sampler as llm_ts
        from repro_torch.launch import serve as cli_llm
        from repro_torch.models import lm as llm
        from repro_torch.models import moe as llm_moe

        t_case = time.perf_counter()
        with depth_cut(arch):
            fcfg = llm_configs.get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        llm_ts.clear_cache()
        server = cli_llm.BatchedServer(fcfg, cli_llm.ServeConfig(
            n_slots=LLM_SLOTS, max_len=max_len, gen_tokens=CS_GEN, sampler="mcmc"), device=dev)
        scfg, model, v = server.sampler_cfg, server.model, fcfg.vocab_size
        captures = []
        real_capture = llm_compiled.capture

        def capture(fn, inputs, device, what, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_capture(fn, inputs, device, what, *args, **kw)
            torch.cuda.synchronize()
            captures.append((what.split("(")[0].strip(), time.perf_counter() - t0))
            return out

        samples, decoded = [], []
        real_sample, real_decode = server._sample, server._decode

        def sample(logits):  # each sample's key, logits, tokens and acceptance
            key = server.key
            tokens = real_sample(logits)
            # a clone: the step keeps these tokens as last_tokens, into
            # which a later admission writes its first token
            samples.append((key, logits, tokens.clone(), server.acceptance[-1]))
            return tokens

        def decode():
            decoded.append(real_decode())
            return decoded[-1]

        def eager_sample(key, logits):
            engine = samplers.MHEngine(scfg.engine_config(), device=dev)
            return llm_ts._sample(engine, scfg, prng.split(key)[1], logits[:, :v], None)

        def leaves_of(cache_layers):
            out = []
            llm.tree_map(out.append, cache_layers)
            return out

        server._sample, server._decode = sample, decode
        rs = np.random.default_rng(SEED)
        queue = [cli_llm.Request(rid=rid, prompt=rs.integers(0, v, size=LLM_PROMPT + rid % 3))
                 for rid in range(CS_REQUESTS)]
        step_ms, eager_model_ms, eager_sample_ms, routes, n_steps = [], [], [], [], 0
        llm_compiled.capture = capture
        try:
            with torch.inference_mode():
                while queue or server.active():
                    while queue and server.free_slot() is not None:
                        server.submit(server.free_slot(), queue.pop(0))
                    leaves = leaves_of(server.cache["layers"])
                    state = ([x.clone() for x in leaves], server.cache["index"].clone(),
                             server.last_tokens.clone(), server.key)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    server.step()
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    n_steps += 1
                    # the same step eagerly on the clones
                    clones, index, tokens, key = state
                    layers = llm.tree_map(lambda _: clones.pop(0), server.cache["layers"])
                    with recorded_routes(llm_moe, routes):
                        t0 = time.perf_counter()
                        logits_e, cache_e = llm.decode_step(model, fcfg, tokens,
                                                            {"index": index, "layers": layers})
                        torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    res_e = eager_sample(key, logits_e)
                    torch.cuda.synchronize()
                    eager_model_ms.append((t1 - t0) * 1e3)
                    eager_sample_ms.append((time.perf_counter() - t1) * 1e3)
                    where = f"compiled_serve {arch} step {n_steps}"
                    check(torch.equal(decoded[-1], logits_e), f"{where}: logits differ")
                    check(all(map(torch.equal, leaves_of(server.cache["layers"]),
                                  leaves_of(layers))), f"{where}: the cache layers differ")
                    check(torch.equal(server.cache["index"], cache_e["index"]),
                          f"{where}: the index differs")
                    check(torch.equal(server.last_tokens[:, 0], res_e.tokens)
                          and server.acceptance[-1] == float(res_e.acceptance_rate),
                          f"{where}: the sample differs")
                    del state, clones, layers, cache_e, logits_e
            with torch.inference_mode():
                for key, logits, tokens, acceptance in samples:
                    res_e = eager_sample(key, logits)
                    check(torch.equal(tokens, res_e.tokens)
                          and acceptance == float(res_e.acceptance_rate),
                          f"compiled_serve {arch}: a sample (B = {len(tokens)}) differs")
        finally:
            llm_compiled.capture = real_capture
        check(n_steps >= 8 and len(server._programs) == 1 and llm_ts.cache_size() == 2,
              f"compiled_serve {arch}: {n_steps} steps, {len(server._programs)} decode and "
              f"{llm_ts.cache_size()} sampler programs")
        # timed: the replayed programs and whole steps (the slots idle: a
        # step decodes and samples every row whatever its state), no
        # model or sampler call from the host meanwhile
        del server._sample, server._decode  # the class's methods again
        host_calls = {"decode_step": 0, "sample_tokens": 0}
        real_model, real_chain = llm.decode_step, samplers.MHEngine.sample_tokens

        def counted(fn, name):
            def run(*args, **kw):
                host_calls[name] += 1
                return fn(*args, **kw)
            return run

        def timed(fn):
            out = []
            for _ in range(CS_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return out

        llm.decode_step = counted(real_model, "decode_step")
        samplers.MHEngine.sample_tokens = counted(real_chain, "sample_tokens")
        try:
            with torch.inference_mode():
                replay_model_ms = timed(server._decode)
                logits = server._decode()
                replay_sample_ms = timed(lambda: server._sample(logits))
                replay_step_ms = timed(server.step)
                calls = []
                events, wall_ms = traced(torch, server.step, "mh_chain_kernel",
                                         lambda: mh.LAUNCHES["mh_chain"], host_calls=calls)
        finally:
            llm.decode_step, samplers.MHEngine.sample_tokens = real_model, real_chain
        check(host_calls == {"decode_step": 0, "sample_tokens": 0},
              f"compiled_serve {arch}: a replayed step called {host_calls} from the host")
        graph_launches = sum(n == "cudaGraphLaunch" for n in calls)
        kernel_calls = sum("Launch" in n and n != "cudaGraphLaunch" for n in calls)
        check(graph_launches == 2, f"compiled_serve {arch}: a step made {graph_launches} graph "
              f"launches")
        # the eager step on the server's state, traced too
        with torch.inference_mode():
            eager_calls = []
            state = {"index": server.cache["index"].clone(),
                     "layers": llm.tree_map(torch.clone, server.cache["layers"])}

            def eager_step():
                logits_, _ = llm.decode_step(model, fcfg, server.last_tokens, dict(state))
                eager_sample(server.key, logits_)

            eager_events, eager_wall_ms = traced(torch, eager_step, "mh_chain_kernel",
                                                 lambda: mh.LAUNCHES["mh_chain"],
                                                 host_calls=eager_calls)
            del state
        busy = sum(e.self_device_time_total for e in events) / 1e3
        eager_busy = sum(e.self_device_time_total for e in eager_events) / 1e3
        (decode_program,) = server._programs.values()
        record = dict(
            phase="compiled_serve", arch=arch, layers=fcfg.n_layers, d_model=fcfg.d_model,
            vocab=v, max_len=max_len, requests=CS_REQUESTS, gen=CS_GEN, steps=n_steps,
            bit_equal_eager=True, samples_checked=len(samples),
            step_ms=step_ms, step_ms_replayed_median=float(np.median(step_ms[1:])),
            eager_model_ms_median=float(np.median(eager_model_ms)),
            eager_sample_ms_median=float(np.median(eager_sample_ms)),
            replay_model_ms_median=float(np.median(replay_model_ms)),
            replay_sample_ms_median=float(np.median(replay_sample_ms)),
            replay_step_ms_median=float(np.median(replay_step_ms)),
            replay_step_ms_range=[min(replay_step_ms), max(replay_step_ms)],
            traced_step_wall_ms=wall_ms, traced_step_busy_ms=busy,
            traced_step_busy_share=busy / wall_ms,
            traced_eager_step_wall_ms=eager_wall_ms, traced_eager_step_busy_ms=eager_busy,
            traced_eager_step_busy_share=eager_busy / eager_wall_ms,
            step_graph_launches=graph_launches, step_kernel_launch_calls=kernel_calls,
            eager_step_kernel_launch_calls=sum("Launch" in n for n in eager_calls),
            step_memcpy_calls=sum("Memcpy" in n for n in calls),
            capture_s=captures, decode_program_bytes=decode_program.nbytes,
            sampler_program_bytes={str(sig.logits[0]): p.nbytes
                                   for sig, p in llm_ts._PROGRAMS.items()},
            sampler_program_mh_chain=[p.launches[0]["mh_chain"]
                                      for p in llm_ts._PROGRAMS.values()],
            burst_tokens_per_s=burst_tokens_per_s.get(arch),
            case_s=time.perf_counter() - t_case)
        if fcfg.family == "moe":  # each step's experts, from its eager twin
            e = fcfg.n_experts
            ids = torch.arange(e, device=dev)
            per_step = [routes[i:i + fcfg.n_layers] for i in range(0, len(routes), fcfg.n_layers)]
            check(len(per_step) == n_steps, f"compiled_serve {arch}: {len(routes)} routed layers")
            distinct = [[int(((x.reshape(x.shape[0], -1)[..., None] == ids).sum((0, 1)) > 0)
                              .sum()) for x in st] for st in per_step]
            record.update(decode_distinct_experts_per_layer_mean=[float(np.mean(d))
                                                                  for d in distinct],
                          decode_distinct_experts_per_layer_max=max(max(d) for d in distinct))
        emit(**record)
        del server, model, logits, samples, decoded, routes
        llm_ts.clear_cache()
        gc.collect()
        torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    for arch_, max_len_ in ((LLM_ARCH, LLM_MAX_LEN), *((a, LLM_MAX_LEN) for _, a, _ in
                                                       FAMILY_PHASES),
                            (VLM_ARCH, VLM_MAX_LEN), (AUDIO_ARCH, LLM_MAX_LEN)):
        compiled_serve_case(arch_, max_len_)
    emit(phase="compiled_serve_total", seconds=time.perf_counter() - t_phase)

    # 35. train_lm: launch/train.py at full width and depth ----------------------
    train_lm_phase()

    # 40. compiled_train: run_training's step as a CUDA graph, against eager ---
    t_phase = time.perf_counter()
    for case_ in CT_CASES:
        compiled_train_case(*case_)
    emit(phase="compiled_train_total", seconds=time.perf_counter() - t_phase)

    # 36. mesh_lm: the distributed layer on a one-rank nccl mesh ----------------
    mesh_lm_phase()

    # 12. timing --------------------------------------------------------------
    # The table (12.6 MB at V = 49,155) stays in the 50 MB L2 between
    # launches, as it does between the engine's chunks.

    def mh_cost(name, args, kw):
        table, init_ = args[0], args[1]
        b, v = table.shape
        c = init_.shape[-1]
        k = kw["n_steps"] if kw else args[2].shape[0]
        nbits = kw["nbits"] if kw else args[4]
        steps = k * b * c
        # the table, int64 init words and samples, int32 accept counts
        nbytes = 4 * b * v + 12 * b * c + 8 * steps
        if name == "mh_chain":
            nbytes += 12 * steps  # int64 flip words and float32 uniforms
            ops = STEP_OPS * steps
            alu = STEP_ALU_OPS * steps
        else:
            nbytes += 24 * c  # int64 per-column key words and step base
            # a chain-step's nbits flip draws and its uniform keep only x0,
            # and the B rows of a column share its step key (a block with
            # the draws' key schedule), each plane's salt word and x1's
            # first rotate; the column key's schedule is once a column
            keys = k * c
            ops = (steps * ((nbits + 1) * THREEFRY_SITE_OPS + FLIP_PLANE_OPS * nbits + STEP_OPS)
                   + keys * (THREEFRY_OPS + 2 * (nbits + 1)) + KEY_SCHEDULE_OPS * c)
            alu = (steps * ((nbits + 1) * THREEFRY_SITE_ALU_OPS + FLIP_PLANE_OPS * nbits
                            + STEP_ALU_OPS)
                   + keys * (THREEFRY_ALU_OPS + (nbits + 1)) + KEY_SCHEDULE_ALU_OPS * c)
        shape = dict(B=b, V=v, C=c, K=k, nbits=nbits, **({"cc": kw["cc"]} if kw else {}))
        return nbytes, ops, ops - STEP_FP_OPS * steps, alu, shape

    shapes = {name: [] for name in wrapper_of}
    for name, where, args, kw in cases:
        cost = gibbs_cost if name.startswith("gibbs") else mh_cost
        nbytes, ops, int_ops, alu, shape = cost(name, args, kw)
        bound, bound_by = bound_ms(nbytes, ops)
        coded = args if name.startswith("mh") else tuple(  # the Gibbs launches' int32 words
            _build.to_u32_bits(a) if getattr(a, "dtype", None) == torch.int64 else a
            for a in args
        )
        big = nbytes > 1e8  # the 1024 x 1024 main-path launches
        row = dict(
            where=where, **shape,
            ms=time_ms(torch, lambda: wrapper_of[name](*args, **kw), 5 if big else 20),
            kernel_ms=time_ms(torch, lambda: launch_of[name](*coded, **kw), 5 if big else 20),
            plain_ms=time_ms(torch, lambda: plain_of[name](*args, **kw), 2 if big else 3),
            bound_ms=bound, bound_by=bound_by, int_bound_ms=int_bound_ms(int_ops, alu),
            bytes=nbytes, ops=ops, int_ops=int_ops, alu_ops=alu,
        )
        if name.startswith("gibbs"):
            gk.reset_launches()
            wrapper_of[name](*args, **kw)
            row["kernel_launches_per_call"] = gk.LAUNCHES[name]
            row["device_ms"] = device_ms(
                torch, lambda: launch_of[name](*coded, **kw), 5 if big else 20,
                "gibbs_band_kernel", lambda: gk.LAUNCHES[name])
            row["device_over_bound"] = row["device_ms"] / bound
        if name.startswith("mh"):
            row["device_ms"] = device_ms(
                torch, lambda: launch_of[name](*coded, **kw), 20, "mh_chain_kernel",
                lambda: mh.LAUNCHES[name])
        shapes[name].append(row)
        emit(phase="timing", kernel=name, **row)

    # the MH kernels at the main shape: the row staging alone (one launch at
    # K = 0), and one wrapper call is one device kernel, with no conversion
    for name in ("mh_chain", "mh_chain_fused"):
        where, args, kw = next((w, a, k) for n, w, a, k in cases if n == name)
        args0 = list(args)
        if name == "mh_chain":
            args0[2], args0[3] = args[2][:0], args[3][:0]
        kw0 = dict(kw, n_steps=0) if kw else kw
        main = shapes[name][0]
        main["staging_device_ms"] = device_ms(
            torch, lambda: launch_of[name](*args0, **kw0), 20, "mh_chain_kernel",
            lambda: mh.LAUNCHES[name])
        calls, grew = 20, []

        def run():
            n0 = mh.LAUNCHES[name]
            for _ in range(calls):
                wrapper_of[name](*args, **kw)
            grew.append(mh.LAUNCHES[name] - n0)

        names = [e.name for e in traced(torch, run, "mh_chain_kernel",
                                        lambda: mh.LAUNCHES[name])[0]]
        check(grew[-1] == calls and len(names) == calls,
              f"{calls} {name} calls counted {grew[-1]} launches and ran {len(names)} device "
              f"kernels and copies ({sorted(set(names))}), not {calls} mh_chain_kernel")
        main["device_kernels"] = sorted(set(names))
        emit(phase="mh_one_kernel", kernel=name, where=where, calls=calls,
             device_kernels=main["device_kernels"], kernels_in_trace=len(names),
             staging_device_ms=main["staging_device_ms"], device_ms=main["device_ms"])

    # 13. the band kernel's per-site loops in SASS ------------------------------
    # Each active site takes one iteration of a draw loop (its Threefry
    # block and flip, into a register bit) and one of a write loop (its
    # spin and flip count into shared memory); the band's store loop
    # writes 4 sites (of both colours) an iteration.  The interior rows'
    # loops are the main shape's.
    loops = sass_loops(str(Path(_build._nvcc()).with_name("cuobjdump")), info["path"],
                       "gibbs_band_kernel", "FusedDraw", "IsingLogit")
    draws = [i for i, loop in enumerate(loops) if loop["rotates"] >= 19]
    check(draws, f"no Threefry loop (19 rotates) in the band kernel's SASS: {loops}")
    write = next((i for i in range(draws[-1] + 1, len(loops))
                  if loops[i]["shared_stores"] >= 2), None)
    store = next((i for i in range(draws[-1] + 1, len(loops))
                  if loops[i]["vector_stores"]), None)
    check(write is not None and store is not None,
          f"no write or store loop after the draw loop in the band kernel's SASS: {loops}")
    per_site = {key: loops[draws[-1]][key] + loops[write][key] + loops[store][key] / 2
                for key in ("instructions", "alu", "fma")}
    clocks = max(per_site["alu"] / INT_OPS_PER_CLOCK_PER_SM,
                 per_site["fma"] / FMA_OPS_PER_CLOCK_PER_SM,
                 per_site["instructions"] / ISSUE_PER_CLOCK_PER_SM)
    g_path = g_main["gibbs_chain_fused"][0]
    g_row = next(x for x in shapes["gibbs_chain_fused"] if x["where"] == f"{g_path} first launch")
    g_row["issue_bound_ms"] = g_row["active_site_steps"] * clocks / (sms * clock_hz) * 1e3
    emit(phase="sass_band_kernel", kernel="gibbs_band_kernel<FusedDraw, IsingLogit>",
         draw_loop=loops[draws[-1]], write_loop=loops[write], store_loop=loops[store],
         per_active_site=per_site, issue_clocks_per_site_per_sm=clocks,
         active_site_steps=g_row["active_site_steps"], issue_bound_ms=g_row["issue_bound_ms"],
         int_bound_ms=g_row["int_bound_ms"], device_ms=g_row["device_ms"],
         device_over_issue_bound=g_row["device_ms"] / g_row["issue_bound_ms"])
    sources = {"mh": "src/repro_torch/csrc/mh.cu", "gibbs": "src/repro_torch/csrc/gibbs.cu"}
    replaces = {
        "mh_chain": "src/repro/kernels/mh/mh.py:35",
        "mh_chain_fused": "src/repro/kernels/mh/mh.py:125",
        "gibbs_chain": "src/repro/kernels/gibbs/gibbs.py:37",
        "gibbs_chain_fused": "src/repro/kernels/gibbs/gibbs.py:136",
    }
    kernels = []
    for name in wrapper_of:
        if name.startswith("gibbs"):
            path, launches = g_main[name]
            main = next(s for s in shapes[name] if s["where"] == f"{path} first launch")
        else:  # the MH main path's shape: B=64, V=49,155, C=256
            path, launches, main = f"main_path_{name}", main_launches[name], shapes[name][0]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name.split("_")[0]],
            replaces=replaces[name], launches=launches, max_abs_err=max_err[name],
            ms=main["ms"], kernel_ms=main["kernel_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            int_bound_ms=main["int_bound_ms"], library_ms=None,
            **{k: main[k] for k in ("device_ms", "staging_device_ms", "device_kernels",
                                    "kernel_launches_per_call", "issue_bound_ms")
               if k in main},
            main_path=path, main_shape=main["where"],
            launches_by_path={p: n[name] for p, n in launches_by_path.items()
                              if n.get(name)},
            shapes=shapes[name],
        ))

    # the MSXOR kernel: bytes-bound, G * M * 8 bytes of int64 words in and
    # M * 8 (words) or M * 4 (uniforms) out.  The Fig. 9 input (25.6 MB)
    # would stay in the 50 MB L2 between launches and beat an HBM bound, so
    # every timed call takes the next of copies that together exceed the L2
    msxor_shapes = []
    for where, raw, n_stages, to_uniform in msxor_cases:
        g, m = raw.shape
        nbytes = g * m * 8 + m * (4 if to_uniform else 8)
        ops = m * ((g - 1) + (3 if to_uniform else 0))  # XORs, shift, convert, scale
        int_ops = m * ((g - 1) + (1 if to_uniform else 0))  # XORs, shift
        bound, bound_by = bound_ms(nbytes, ops)
        raws = [raw] + [raw.clone() for _ in range(int(COLD_BYTES // raw.nbytes))]
        nxt = itertools.cycle(raws).__next__
        big = m > FIG9_M
        msxor_shapes.append(dict(
            where=where, G=g, M=m, to_uniform=to_uniform, input_copies=len(raws),
            ms=time_ms(torch, lambda: xk.msxor(nxt(), n_stages, to_uniform), 20 if big else 50),
            kernel_ms=time_ms(torch, lambda: xk._launch_msxor(
                nxt(), n_stages=n_stages, to_uniform=to_uniform), 20 if big else 200),
            plain_ms=time_ms(torch, lambda: (
                xref.msxor_uniform_ref if to_uniform else xref.msxor_fold_ref)(nxt(), n_stages),
                5 if big else 20),
            bound_ms=bound, bound_by=bound_by, int_bound_ms=int_bound_ms(int_ops, int_ops),
            bytes=nbytes, ops=ops, int_ops=int_ops,
        ))
        # the launch from Python takes longer than the kernel at the Fig. 9
        # shape; the profiler's device time is the kernel's own
        dev_ms = device_ms(torch, lambda: xk._launch_msxor(
            nxt(), n_stages=n_stages, to_uniform=to_uniform), 20, "msxor_kernel",
            lambda: xk.LAUNCHES["msxor"])
        msxor_shapes[-1].update(device_ms=dev_ms,
                                device_rate_TBps=nbytes / dev_ms / 1e9,
                                device_over_bound=dev_ms / bound)
        del raws, nxt
    main = next(x for x in msxor_shapes if x["where"] == "Fig. 9 shape fold")
    kernels.append(dict(
        name="msxor", route="cuda", source="src/repro_torch/csrc/msxor.cu",
        replaces="src/repro/kernels/msxor/msxor.py:32", launches=fig9_launches["msxor"],
        max_abs_err=msxor_err, ms=main["ms"], kernel_ms=main["kernel_ms"],
        device_ms=main["device_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], int_bound_ms=main["int_bound_ms"],
        device_over_bound=main["device_over_bound"], library_ms=None,
        library_none_reason="no single PyTorch call XOR-reduces over an axis",
        main_path="fig9_msxor", main_shape="(8, 400000) fold",
        launches_by_path={"fig9_msxor": fig9_launches["msxor"]}, shapes=msxor_shapes,
    ))
    del msxor_cases
    emit(phase="fig9_breakdown", raw_draw_ms=[r["draw_ms"] for r in fig9],
         fold_wrapper_ms=[r["fold_ms"] for r in fig9], msxor_ms=main["ms"],
         msxor_kernel_ms=main["kernel_ms"], msxor_device_ms=main["device_ms"])

    # where the main path's time goes: operand draws vs the kernel, and the
    # device's busy share over one profiled 256-step submit per backend
    draw_ms = time_ms(
        torch, lambda: cim.chunk(prng.PRNGKey(SEED, device=dev), 0, K, (B, C), 16), 3
    )
    emit(phase="cim_breakdown", chunk_steps=K, operand_draw_ms=draw_ms,
         kernel_ms=kernels[0]["ms"], main_path_ms_per_chunk={
             r: path_s[r] * 1e3 / (N_STEPS // K) for r in path_s})

    def profiled(run, match, launched, **record):
        """One run under the profiler after a lead run, whose trace holds
        every kernel named ``match`` that it launched (``traced``):
        wall time, device busy time and share, the kernels that took the
        most, and the host-to-device copies; returns the record."""
        events, wall_ms = traced(torch, run, match, launched, cpu=True)
        by_kernel, calls = {}, {}
        for e in events:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.self_device_time_total / 1e3
            calls[e.name] = calls.get(e.name, 0) + 1
        busy_ms = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
        out = dict(phase="profile", **record, wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
                   device_busy_share=busy_ms / wall_ms,
                   top_kernels_ms=[[name[:100], ms] for name, ms in top],
                   htod_copies=sum(n for name, n in calls.items() if "HtoD" in name),
                   mh_kernel_launches=sum(n for name, n in calls.items()
                                          if "mh_chain_kernel" in name))
        emit(**out)
        return out

    mh_profiles = {}
    for randomness, n_steps in (("cim", 256), ("fused", 256), ("fused", N_STEPS)):
        eng = samplers.MHEngine(samplers.EngineConfig(randomness=randomness))
        plan = samplers.RunPlan(
            target=samplers.TableTarget(logits), n_steps=n_steps, init_words=init, seed=SEED
        )
        mh_profiles[randomness, n_steps] = profiled(
            lambda: eng.submit(plan), "mh_chain_kernel", lambda: sum(mh.LAUNCHES.values()),
            randomness=randomness, n_steps=n_steps)
    # the fused chunk loop copies nothing from the host: a submit of 16
    # chunks makes as many host-to-device copies as one of 4 (the set-up's)
    short, full = mh_profiles["fused", 256], mh_profiles["fused", N_STEPS]
    check(short["mh_kernel_launches"] == 256 // K and full["mh_kernel_launches"] == N_STEPS // K,
          f"fused submits launched {short['mh_kernel_launches']} and "
          f"{full['mh_kernel_launches']} MH kernels")
    check(full["htod_copies"] == short["htod_copies"],
          f"the fused chunk loop copies from the host: {short['htod_copies']} copies in "
          f"{256 // K} chunks, {full['htod_copies']} in {N_STEPS // K}")
    emit(phase="mh_fused_chunk_loop", chunks=[256 // K, N_STEPS // K],
         htod_copies=[short["htod_copies"], full["htod_copies"]],
         htod_copies_in_chunk_loop=0, wall_ms_profiled=full["wall_ms_profiled"],
         device_busy_share=full["device_busy_share"])

    # the Gibbs paths: per-chunk wall time against the kernel call alone
    by_name = {k["name"]: k for k in kernels}
    emit(phase="gibbs_breakdown", main_path_ms_per_chunk={
        "ising_fused": g_path_s["main_path_gibbs_ising_fused"] * 1e3 / (N_STEPS // G_CHUNK),
        "spin_glass_fused": g_path_s["main_path_gibbs_spin_glass_fused"] * 1e3
        / (N_STEPS // G_CHUNK),
        "ising_cim": g_path_s["main_path_gibbs_ising_cim"] * 1e3 / (OP_STEPS // OP_CHUNK),
        "ising_host": g_path_s["main_path_gibbs_ising_host"] * 1e3 / (OP_STEPS // OP_CHUNK),
        "ising_host_full": g_path_s["main_path_gibbs_ising_host_full"] * 1e3
        / (HOST_FULL_STEPS // OP_CHUNK),
    }, gibbs_chain_fused_ms=by_name["gibbs_chain_fused"]["ms"],
        gibbs_chain_fused_kernel_ms=by_name["gibbs_chain_fused"]["kernel_ms"],
        gibbs_chain_fused_device_ms=by_name["gibbs_chain_fused"]["device_ms"],
        gibbs_chain_ms=by_name["gibbs_chain"]["ms"],
        gibbs_chain_kernel_ms=by_name["gibbs_chain"]["kernel_ms"],
        gibbs_chain_device_ms=by_name["gibbs_chain"]["device_ms"])
    # both entry points launch the band kernel once per lattice group
    for randomness, kw in (
        ("fused", main_kw), ("cim", dict(op_kw, n_steps=64)), ("host", host_kw),
    ):
        wl = workloads.build("ising", prng.PRNGKey(SEED, device=dev), randomness=randomness,
                             backend="pallas", beta=BETA, **kw)
        name = g_kernel_of[randomness]
        profiled(lambda: wl.run(prng.PRNGKey(SEED + 1, device=dev)), "gibbs_band_kernel",
                 lambda: gk.LAUNCHES[name], workload="ising",
                 randomness=randomness, lattice=f"{kw['height']}x{kw['width']}",
                 B=kw["batch"], n_steps=kw["n_steps"], chunk_steps=kw["chunk_steps"])
        del wl

    emit(phase="profiler_sessions", **PROFILER)

    # 37. dryrun: the multi-pod dry run and the roofline ------------------------
    dryrun_phase()
    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-phase-shapes"]:
        sys.exit(dryrun_phase_shapes(sys.argv[2]))
    sys.exit(main())
