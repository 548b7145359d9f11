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
     blocking copy, in turns; then a ``cim`` class at smoke size.

Phases 24-28 (the autotuner, the CLIs, the serving mesh) run after 23:

 24. ``autotune_mh``: ``samplers.autotune_config`` on the MH main path
     (B = 64, V = 49,155, C = 256, ``fused``, ``execution="auto"``: scan
     and the kernel in the grid), with a fresh cache; each candidate's
     rate and the tuner's seconds; a second call must hit the cache with
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
     equal to the unsharded one request for request, then both are timed
     warm in turns; under ``pallas`` the mesh is refused.

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
full width and depth in bfloat16 (8 requests, 4 slots, prompts of 128-130
tokens, 32 generated), the previous model freed first.  Every prefill,
decode step and sample of a burst is timed between two synchronisations:
tokens/s, samples and ``mh_chain`` launches (equal under ``mcmc``, the
first held against its plain version at tolerance 0 and timed in 12),
acceptance, prefill ms, the model's and ``_sample``'s ms a step beside
the step's bytes bound, peak memory.  Then the model cut to 2 layers in
float32, made on the card and copied to the CPU, card against CPU
(logits within ``LLM_LOGIT_TOL``, greedy tokens equal where the top-two
gap exceeds the difference, the same experts chosen):

 30. ``serve_lm_moe``: qwen3-moe-30b-a3b (48 layers, d_model 2,048, 128
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

Each phase prints one JSON line; any failure raises and exits non-zero.
The second-to-last line lists the kernels; the last line is the device
record.  Without a CUDA device, or without the repository around it, it
exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import itertools
import json
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
    ("serve_lm_moe", "qwen3_moe_30b", ("mcmc", "greedy")),
    ("serve_lm_ssm", "mamba2_1p3b", ("mcmc",)),
    ("serve_lm_hybrid", "hymba_1p5b", ("mcmc",)),
)
FAMILY_SSM_PROMPT = 130
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


def traced(torch, run, match=None, launched=None, cpu=False, attempts=5):
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
    holds more kernels than were launched."""
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
        with path_run(path) as seen:
            t0 = time.perf_counter()
            tuned, res = samplers.autotune_config(cfg, target, init_words, cache_path=cache, **kw)
            tune_s = time.perf_counter() - t0
        launches = launches_by_path[path]
        check(launches[kernel] > 0, f"{path} launched no {kernel}")
        diff, err = hold_first(seen, kernel, path)
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
             tuner_kw=kw)
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
            return {r.rid: r for r in done}, time.perf_counter() - t0, sched.shape_classes

        plain, mesh_cold_s, n_classes = mesh_serve(None)
        reset_launches()
        sharded, mesh_s, _ = mesh_serve(mesh)
        launches_by_path["serving_mesh"] = launches_now()
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
         first_mesh_seconds=mesh_s, warm_seconds=warm,
         launches=launches_by_path["serving_mesh"], pallas_refused=refused)

    # 29. serve_lm: granite-3 8B at full width through launch/serve.py ---------
    def serve_lm_phase():
        """Phase 29; its names stay out of the phases after it."""
        t_phase = time.perf_counter()
        from repro_torch import configs as llm_configs
        from repro_torch.launch import serve as cli_llm
        from repro_torch.models import lm as llm

        gcfg = llm_configs.get_config(LLM_ARCH)
        llm_argv = ["--arch", LLM_ARCH, "--requests", str(LLM_REQUESTS), "--slots",
                    str(LLM_SLOTS), "--prompt-len", str(LLM_PROMPT), "--gen", str(LLM_GEN)]
        llm_rows = {}
        for sampler in ("mcmc", "greedy", "categorical"):
            path = f"serve_lm_{sampler}"
            torch.cuda.empty_cache()
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
        ``routes`` while a run goes; restores the router on exit."""
        real = llm_moe.route

        def route(*args, **kw):
            out = real(*args, **kw)
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
        model's and cache's bytes once (``info``).  Restores all on exit."""
        real = (llm.prefill, llm.decode_step, cli_llm.BatchedServer._sample)

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
                leaves, ssm_leaves = [], []
                llm.tree_map(leaves.append, layers)
                llm.tree_map(ssm_leaves.append, ssm_part)
                info.update(
                    param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
                    parameters=sum(p.numel() for p in model.parameters()),
                    embed_bytes=model.embed.numel() * model.embed.element_size(),
                    cache_bytes=sum(t.numel() * t.element_size() for t in leaves),
                    ssm_cache_bytes=sum(t.numel() * t.element_size() for t in ssm_leaves))
            return timed_sample(server, logits)

        llm.prefill, llm.decode_step = timed(real[0], "prefill"), timed(real[1], "model")
        cli_llm.BatchedServer._sample = sample
        try:
            yield
        finally:
            llm.prefill, llm.decode_step, cli_llm.BatchedServer._sample = real

    def serve_family_phase(phase, arch, samplers_):
        """Phases 30-32; their names stay out of the phases after them."""
        import gc

        t_phase = time.perf_counter()
        from repro_torch import configs as llm_configs
        from repro_torch.launch import serve as cli_llm
        from repro_torch.models import lm as llm
        from repro_torch.models import moe as llm_moe
        from repro_torch.models import ssm as llm_ssm

        fcfg = llm_configs.get_config(arch)
        argv = ["--arch", arch, "--requests", str(LLM_REQUESTS), "--slots", str(LLM_SLOTS),
                "--prompt-len", str(LLM_PROMPT), "--gen", str(LLM_GEN)]
        is_moe = fcfg.family == "moe"
        for sampler in samplers_:
            path = f"{phase}_{sampler}"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            timers, routes, info = {"prefill": [], "model": [], "sample": []}, [], {}
            with served_calls(cli_llm, llm, timers, info), recorded_routes(llm_moe, routes), \
                    path_run(path) as seen:
                t0 = time.perf_counter()
                row = cli_llm.main([*argv, "--sampler", sampler])
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
            # the step's bound: the weights but the embedding, and the cache,
            # read once; the SSM state and conv inputs written once
            n_layers = fcfg.n_layers
            step_bytes = (info["param_bytes"] - info["embed_bytes"] + info["cache_bytes"]
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
                          decode_step_bound_by="bytes")
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
                check(len(prefills) == LLM_REQUESTS and len(steps) == row["decode_steps"]
                      and len(per_call) == n_layers * (LLM_REQUESTS + row["decode_steps"]),
                      f"{path}: {len(per_call)} routed layers")
                expert_bytes = 3 * fcfg.d_model * fcfg.d_ff * fcfg.param_dtype.itemsize
                used_bound = [(step_bytes - expert_bytes * sum(e - u for _, _, u in st))
                              / HBM_BYTES_PER_S * 1e3 for st in steps]
                distinct = [float(np.mean([u for _, _, u in st])) for st in steps]
                record.update(
                    prefill_capacity_drops=[[sum(d for _, d, _ in pf), pf[0][0] * k * n_layers]
                                            for pf in prefills],
                    prefill_capacity=llm_moe.capacity(LLM_PROMPT, e, k, fcfg.moe_capacity_factor),
                    decode_capacity_drops=sum(d for st in steps for _, d, _ in st),
                    decode_distinct_experts_per_layer_mean=distinct,
                    decode_distinct_experts_per_layer_max=max(u for st in steps
                                                              for _, _, u in st),
                    decode_step_used_experts_bound_ms_median=float(np.median(used_bound)),
                    decode_step_used_experts_bound_ms_range=[min(used_bound), max(used_bound)])
                check(record["decode_capacity_drops"] == 0, f"{path}: a decode step dropped")
            if sampler == "mcmc":  # the first launch is also timed in 12
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
            global_layers=tuple(g for g in fcfg.global_layers if g < LLM_CHECK_LAYERS))
        t0 = time.perf_counter()
        card_model = llm.init_lm(cfg2, seed=SEED, device=dev)
        host_model = llm.LM(cfg2, device="cpu")
        host_model.load_state_dict(card_model.state_dict())
        copy_s = time.perf_counter() - t0
        rs = np.random.default_rng(SEED)
        lens = LLM_CHECK_LENS if is_moe else (FAMILY_SSM_PROMPT,)
        check_prompts = [rs.integers(0, fcfg.vocab_size, n) for n in lens]
        v_ = fcfg.vocab_size

        def greedy_logits(model_, device, rows, cfg_=cfg2):
            """Per-row prefills spliced into one cache with a (B,) index, then
            greedy decode steps: the logits of every step and the experts
            chosen, on the host."""
            max_len_ = max(lens) + LLM_CHECK_STEPS + 1
            chosen = []
            with torch.inference_mode(), recorded_routes(llm_moe, chosen):
                cache = llm.init_cache(cfg_, len(rows), max_len_, device)
                cache["index"] = torch.zeros(len(rows), dtype=torch.int32, device=device)
                first = []
                for r, i in enumerate(rows):
                    prompt = torch.as_tensor(check_prompts[i], dtype=torch.int32, device=device)
                    row_logits, row = llm.prefill(model_, cfg_, {"tokens": prompt[None]},
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
        card_cpu_diff = agree(card_run, host_run, "card against CPU")
        # the same weights in float64 on the CPU: the float32 runs' own
        # rounding, which a near one-hot attention over random weights
        # magnifies; the card must be within LLM_LOGIT_TOL of it, or within
        # FAMILY_F32_FACTOR times the CPU's float32 error where that is larger
        cfg64 = dataclasses.replace(cfg2, dtype="float64", param_dtype_str="float64",
                                    cache_dtype_str="float64")
        exact_model = llm.LM(cfg64, device="cpu")
        exact_model.load_state_dict({k: v.double() for k, v in host_model.state_dict().items()})
        exact_run, exact_routes = greedy_logits(exact_model, torch.device("cpu"), rows_, cfg64)
        del exact_model
        check(len(exact_routes) == len(host_routes) and all(
            torch.equal(a, b) for a, b in zip(exact_routes, host_routes)),
            f"{phase}: float64 chooses other experts than float32 (a near tie: replace SEED)")
        agree(host_run, [x.float() for x in exact_run], "float32 against float64 on the CPU")
        cpu_err = max(float((x.double() - y).abs().max()) for x, y in zip(host_run, exact_run))
        card_err = max(float((x.double() - y).abs().max()) for x, y in zip(card_run, exact_run))
        tol = max(LLM_LOGIT_TOL, FAMILY_F32_FACTOR * cpu_err)
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
        if len(lens) > 1:
            solo = [greedy_logits(card_model, dev, [i])[0] for i in rows_]
            solo_run = [torch.cat([s_[t] for s_ in solo]) for t in range(LLM_CHECK_STEPS + 1)]
            packed_diff = agree(card_run, solo_run, "packed against solo on the card")
            check(packed_diff <= LLM_LOGIT_TOL,
                  f"packed against solo: {packed_diff} > {LLM_LOGIT_TOL}")
            record["packed_solo_max_abs_diff"] = packed_diff
        if not is_moe:
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

    for phase_, arch_, samplers_ in FAMILY_PHASES:
        serve_family_phase(phase_, arch_, samplers_)

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
    sys.exit(main())
