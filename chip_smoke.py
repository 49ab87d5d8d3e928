#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no phase carries on after one):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the full tick kernel (ops/csrc/full_tick.cu: the ring launch B1
   and the obs launch B3), the learner kernel (ops/csrc/td_adam.cu, a
   library for each net of LEARNER_CASES) and the env kernel
   (ops/csrc/env_kernel.cu: the feature-major tick B4 and the row-major
   step B5, one library for each board of STEP_BOARDS and TICK_BOARDS, and
   for the jnp engine's observation on the bench board, window and global
   at k = 1 and 4) from the sources, every library in one ``nvcc`` wave,
   and print their
   ptxas lines (registers, spill bytes, stack), the tick kernel's shared
   memory and blocks per SM, the env kernel's block shape and its B4 and
   B5 blocks per SM, and for each learner case the cluster size, the
   shared memory a CTA, the batch tile, what is staged and the clusters
   the card holds at once (held against ``learner_kernel.batch_plan``);
2b. hold the draw kernel (ops/csrc/draws.cu, ``draws.draw``: ``rng.split``,
   ``random_bits``, ``uniform`` and ``randint`` of a CUDA key) against the
   plain versions (``rng.split_plain``, ...) in every mode at every round
   count on the main path's shapes (one key into 65,538, 65,536 keys
   split in two, a strided view of split children, uniform fields of 4 x
   65,536 and 65,536 x 81, randint at batch 8 with a host and a device
   bound and its edge bounds), and the ring sample kernel
   (``draws.ring_sample`` via ``fused_tick.ring_gather_batch``) against
   ``ring_gather_batch_plain`` at the bench's ring for one drone and four,
   bf16 and f32, keyed and from host offsets; and the replays' modes of
   the ring sample kernel (``draws.stream_sample`` via ``StreamReplay.
   sample_batch`` on phase 10's StreamReplay of 5 x 65,536 slots,
   ``draws.buffer_sample`` via ``ReplayBuffer.sample_batch`` on the jnp
   CLI's 100,000 transitions, feature- and row-major) against
   ``sample_batch_plain``, cold, filling and wrapped, keyed with device
   words, host words and from host offsets: all bitwise, one launch a
   call; then time each over DRAW_LAUNCHES launches of a prebuilt block
   (DRAW_TIMED; the samples at 294 x 16) beside its plain version, its
   bound and an empty launch. The phases after it rely on these draws
   (the plain versions' key splits on the card among them);
3. hold the tick kernel against its plain PyTorch version on the card, at
   the bench width (65,536 envs, grid 9, 4 drones, window radius 3), for
   the (16,16) and (128,64) nets and f32 and bf16 rings, over 8 ticks with
   a reset tick: env outputs bitwise (the charge channel within 1.3e-7),
   actions equal wherever the plain Q-values are not a near tie;
3b. hold the learner kernel (B6's entry point, ``learn_tick_fused``)
   against its plain version (``td_adam_plain``) for every net and batch
   of LEARNER_CASES (the bench nets, (8), (32,16) and (100,), which 16
   CTAs do not divide, at batch 1, 8 and 256, and (512,), whose params
   are read from device memory, at 8 and 256): 6 learner ticks (learn
   off at tick 2, sync on even ticks, decay every third), each from the
   kernel's state after the tick before: ε bitwise, the Adam count equal,
   the loss within rtol 1e-5 (at batch 1 plus ``learner_kernel.
   loss_slack``, the effect of 8 ULPs on each Q-value read; exactly -1
   when not learning), params / mu / nu / target within rtol 1e-5, atol
   1e-6 except where the plain gradient is a cancellation (counted and
   printed), untouched leaves bitwise where a flag is off; then one tick
   of the in-kernel TD path (``full_tick_fused_ring`` with ``td_hparams``)
   against the two plain versions;
3c. hold B3 (``full_tick_fused``) against ``full_tick_plain`` at 65,536
   envs for both nets over 8 ticks with a reset tick, ε = 0.5: env
   outputs bitwise, the charge channel within 1.3e-7, actions equal
   outside near ties, ``obs_t`` untouched; then B3 as the full engine
   launches it, with the push into a StreamReplay of STREAM_CAPACITY
   slots (``replay=``) at its last, first and middle push and the next
   observation over ``obs_t``, for both nets at k = 1 and COLLECT, 3
   ticks with a reset: the replay's four leaves bitwise, ``obs_t`` the
   returned observation and bitwise but the charge channel, env outputs
   bitwise;
3d. hold B4 (``tick_fused``) against ``tick_plain`` at 65,536 envs for 8
   ticks of actions drawn on the card on grid 9 with 4 drones, and for 3
   on the tight board (grid 5, 2 drones) and on grid 16 with 25 drones:
   everything bitwise but the charge channel (within 1.3e-7);
3e. hold B5 (``step_kernel.step_batch_fused``) against ``core.step_batch``
   at 65,536 envs on grid 9 with 4 drones, a tight board (grid 5, 2
   drones: more respawn slots than vacant cells), a 400-cell board (grid
   20), the evaluator's 20-participant arena (grid 20, 20 drones) and 48
   drones on a nearly full board (grid 22): all bitwise (the charge and
   reward error is measured); then drive the entry point for 100 steps on
   grid 9 (launches = steps);
3j. hold B5 with the jnp engine's observation (``step_batch_fused`` with
   ``collect`` = k) against its plain version (``core.step_batch`` +
   ``observe_batch``) at 1, 7, 64 and 100 envs, window and global, k = 1
   and 4, 4 ticks each with episode ends, the key as a chunk row's words
   and as a host key: state, rewards and dones bitwise, the observation
   bitwise but the charge channel (within 1.3e-7), one launch a call;
   then time the window build at 1, 64 and 65,536 envs beside its plain
   version and bound;
3f. ``DQN.init_state(key)`` on the card equals the CPU draw bitwise (the
   JAX package's initial nets, drawn on the CPU and copied);
4. drive the trainer's main path (``dronerl_tpu_torch.train``'s ring
   chunk, ``build_chunk_ring``: one CUDA graph replay a tick, the graphs
   captured in the warm-up chunk) at the bench configuration for both
   nets: the tick kernel's launch count (a replay counts the launches its
   graph holds) must equal the ticks, losses be finite, params move and ε
   decay; report obs/s, the tick kernel's time per launch and its plain
   version's;
4b. drive the ``in_kernel_td`` main path the same way: both kernels'
   launch counts equal the ticks, the loss -1 at tick 0 and finite and
   >= 0 after, the Adam count ticks - 1; report its obs/s beside phase
   4's, the learner kernel's time per launch (learn, and learn + sync),
   its plain version's, an empty launch of its cluster (the floor a
   launch costs), and the autograd
   learner's (``train_step_t`` + ``apply_schedules``) host and device time
   on the same batch;
4c. drive the full engine (``build_train_step_full`` over a StreamReplay of
   1,048,576 slots, ``--memory_size 1000000`` rounded up to 16 env-batches)
   the same way for both nets, as the CLI runs it (``train.Chunk``: one
   CUDA graph replay a tick): B3's launch count equals the ticks and its
   pushes (``full_tick_fused.pushes``) its launches, the learner kernel's
   the trained ticks (no other kernel launches), losses
   finite once trained, params move, ε decays, the replay full; report
   its obs/s beside phase 4's;
4d. drive the fused engine (``build_train_step_fused``, dense) on the same
   configuration, as a chunk: B4's launches equal the ticks (no B3
   push), the learner kernel's the trained ticks; report its obs/s;
4e. run the CLI (``dronerl_tpu_torch.train.main``) at ``--num_envs 16384``
   with the default memory size (114,688 slots > 4 x 16,384): it must
   choose the full engine, and B3's launches equal its steps, the learner
   kernel's its trained steps;
4f. run the CLI at ``--num_envs 64 --num_steps 30``: it must choose the jnp
   engine over a row-major ReplayBuffer (its env step route B5 with the
   observation, once a tick; its sample kernel and the learner kernel
   once a trained tick), give finite losses once trained and decay ε;
   report its obs/s; then drive the same engine's tick for 30 ticks: the
   same launches, the params move;
   then time B1, B3, B4 and B5 per launch (CUDA events over launches of a
   prebuilt argument block; B1 also by wrapper calls; B4 on every board
   of TICK_BOARDS, B5 on every board of STEP_BOARDS), their plain
   versions and their bounds (the tick kernel's layers but the last at
   the tensor-core rate, the all-CUDA-core bound beside it);
3g. the conv family and the global observation (CHAIN_CASES, nets drawn
   from PRNGKey(0) as ``--seed 0`` draws them): B1 (bf16 ring) and B3
   with dqn-agent-5's conv chain on the window, and on the global 9 x 9
   board with a dense (16,16) net, that conv chain, and a conv of 32
   channels whose activations live in device memory, and on the global
   16 x 16 board whose observation does too, 3 ticks each with a reset
   at 65,536 envs against their plain versions; B4 with the global
   observation on grids 9 and 16. Phase 2 prints each library's variant,
   shared memory, scratch and blocks per SM, and fails where the card's
   layout differs from ``fused_tick.tick_layout``;
4g. drive CHAIN_DRIVES (the ring and full engines with those chains, the
   fused engine with the conv module and with the global dense net) for
   CHAIN_DRIVE ticks each, every count zeroed just before: the engine's
   kernel launches once a tick and no other kernel launches; then time
   each B1/B3 chain launch and B4 beside its plain version and bound;
4h. run the CLI with ``--network_type conv --conv_matmul`` at 16,384 envs
   (the full engine: B3's launches equal its steps) and with
   ``--network_type conv --wrapper global`` at 64 (the jnp engine: B5 once
   a tick, its sample once a trained tick);
3i. ``collect_drones > 1`` and ``--fast_rng``'s round counts (CASES_3I: the
   window with 4 drones collected and the global board with 2, each at
   --fast_rng off (20, None), actor (20, 8) and full (8, None), and one
   drone at actor and full): B1 on bf16 and f32 rings, B3 and B4 against
   their plain versions at 65,536 envs for both nets, 8 ticks with a reset
   tick: env outputs bitwise, every one of the k observation row groups
   bitwise but the charge channel (within 1.3e-7), actions equal outside
   near ties; then every build timed over 50 launches of a prebuilt block
   beside the k = 1, 20-round build on the same state, with its bound
   (the observation's rows read once and its k row groups written, the
   hashes at their round counts), its ptxas line, layout variant and
   blocks per SM (phase 2 fails where one of these builds spills);
4i. drive the ring engine (default and ``in_kernel_td``), the full engine
   (memory 1,000,000) and the fused engine with ``--collect_drones 4`` at
   65,536 envs, and with one drone the ring and full engines at
   ``--fast_rng actor`` and ``full`` and the fused engine at ``full``,
   each as phase 4 measures it (obs/s beside phase 4's); every other
   build of 3i for COLLECT_DRIVE ticks; the CLI with ``--collect_drones
   4`` at 16,384 envs (``--memory_size 1000000``: the full engine) and at
   64 (the jnp engine): launches equal ticks, B3's pushes its launches,
   losses finite, params move, ε decays, the replay takes E · k
   transitions a tick;
5. the trainer's lifecycle through ``train.train(parse_args(...))`` at the
   bench configuration (65,536 envs, memory 100,000, bf16 ring: the ring
   engine, whose chunks the CLI runs as CUDA graphs), for LIFE_RUNS (warm-started from dqn-agent-3, (128,64) from
   --seed, and the warm start with ``--in_kernel_td``):
5a. 300 ticks in 2 chunks of 150 with an eval of 5 seeds x 1,000 steps
   before the second and at the end, both checkpoints and the train
   state: B1 launches once a tick, B2 once a trained tick (once a tick
   with ``--in_kernel_td``) and nothing else does; then 150
   ticks, a train state, a resume and 150 more: the final carry equals the
   whole run's tensor for tensor, bitwise; prints obs/s beside phase 4's,
   the eval times and means;
5b. the checkpoints written on the card load on the CPU through the
   port's reader and give the card's params' Q-values on 1,024 seeded
   observations bitwise; the warm start puts dqn-agent-3's params into
   the online and target nets bitwise;
5c. ``evaluate_checkpoints`` over the five baselines (10 seeds x 1,000
   steps) on the card and on the CPU: the actions agree step by step up
   to the first near tie of each episode (the CPU's best-minus-second Q
   gap at most 1e-5 of max |q|); prints both score vectors beside the JAX
   package's CPU lock and each episode's first parting step;
6. multi-GPU training (``parallel/``) and the periphery:
6a. the CLI with ``--use_sharding`` at world size 1 over NCCL at the bench
   configuration, 150 ticks each, as the CLI runs them (the trainer's
   ``train.Chunk``: one CUDA graph replay a tick, the gradient all-reduce
   captured inside): the sharded ring engine (memory 100,000)
   and the sharded fused engine over B3 (memory 1,000,000) for both nets,
   and over B4 with a conv net: the engine's kernel launches once a tick
   and nothing else launches, one gradient all-reduce for each trained
   tick, finite losses, ε decays; obs/s beside phase 4's, and the
   all-reduce's time a trained tick for both nets;
6e. (on 6a's mesh) a world-1 NCCL ``DistributedTrainer``'s chunk
   (``build_chunk(...).chunk``) against its eager ticks for each local
   engine (MG_CHUNK_CASES: ring and full at 65,536 envs with both nets,
   fused with the conv actor (B4) at 65,536, jnp at 64), 2 chunks of 50
   ticks with a train state saved and restored between, graphed and
   eager from the same carry: every carry tensor, its numbers and every
   output bitwise, B1/B3/B4 launched once a tick either way (the jnp
   engine B5), the learner kernel never (a grouped tick's learner is
   autograd, its all-reduce between the backward pass and Adam) and one
   all-reduce a trained tick either way; logs the
   graphs, the capture mode and seconds and both ways' ms a tick (no
   profiler: the phase stays short);
6b. two ranks on the one card over gloo (``parallel.launch.spawn``): the
   sharded ring, fused-dense (B3) and fused-conv (B4) engines at 2 x 256
   envs for 12 ticks (a reset every 5) in lockstep with the same ranks'
   plain versions on the CPU (each tick from the card's state): env state,
   the next observation and the tick's scalars bitwise but the charge
   channel (within 1.3e-7), except where drone 0's action parts at a near
   tie of the CPU's Q-values; losses within rtol 1e-5, params within atol
   1e-5; the ranks' params bitwise equal; then the ring engine at 2 x
   32,768 envs for 150 ticks: obs/s, launches, and the all-reduce on CUDA
   and on CPU tensors (gloo's staging through the host);
6c. each rank saves its train state after 6 ticks; 6 more equal a restore
   and 6 more, bitwise, on both ranks; then the trainer's chunk over gloo
   runs eager rows (no graph): 2 chunks of 6 ticks equal 12 eager ticks
   bitwise;
6d. ``benchmark.py``'s phase split (Default, 4 drones, 256 envs, 100
   steps) and ``DeliveryDronesEnv`` for 100 steps on the card against the
   CPU, beside the card's name and power limit; then what NCCL says to
   two ranks on one card (information);
7. the repo's last entry points and locks:
7a. ``scripts/torch_numerics_lock.py``'s scenario (256 envs, 64 ticks,
   bf16 ring, ε pinned at 1.0) through B1 and the default learner on B2:
   launches 64 and 64 in 64, Tier A
   (the env state's and the reward trace's SHA-256 digests, the ring's
   summary) equal to the JAX package's TPU record
   (``scripts/tpu_numerics_lock.json``) and to the plain path's on the
   CPU, Tier B inside the card's own record
   (``scripts/torch_numerics_lock.json``); prints the largest Tier B
   difference from the CPU's plain run (the autograd learner);
7b. ``scripts/torch_evaluate_agent.py`` on dqn-agent-3 on the card (the
   arena's plain env core: no kernel launches); six finite scores; where
   PIL is missing the episode video is skipped (the evaluator, like the
   JAX package's, raises without it);
7c. ``scripts/torch_create_baselines.py`` at EP_BASELINE_STEPS steps into
   ``output/chip_smoke/baselines``: five checkpoints that the evaluator
   loads and scores;
7d. the CLI with ``--tensorboard_dir`` at the bench configuration
   without tensorboard (blocked if it is installed): it warns
   "tensorboard unavailable; skipping TB logging", writes no TB files and
   completes, B1 launching once a tick, B2 once a trained tick;
   then the learner kernel's bound at batch 256 (B6) for both nets, and
   the phase's seconds;
8. the bench program and its companions, each a subprocess of the
   checkout: ``python -m dronerl_tpu_torch.bench`` at BENCH_ENV (3 repeats
   of the (16,16) metrics, 2 of the (128,64) ones, 1 call of 200 ticks a
   repeat, each a graphed chunk): exit 0, ``correct: true`` (its lockstep
   check of the graphed chunk against the eager tick included), the card
   as its device, the graphs it captured, B1's and B2's
   launches equal to each metric's timed ticks (every timed tick trains,
   on the default path too), each obs/s logged beside phase
   4's with its quartiles and the traced run's device busy share; then
   one row each of ``scripts/torch_ring_bench.py`` (65,536 envs),
   ``torch_config5_bench.py`` (grid 16, 8 drones, 32,768 envs, one
   drone collected) and ``torch_scaling_bench.py`` (world size 1 over
   NCCL, the fused engine over B3 at 256 envs): exit 0, finite obs/s on
   the card, the scaling rank's B3 launches equal to its timed ticks;
9. the graphed ring chunk: for both nets, on the default path and on
   ``in_kernel_td``, at the bench configuration, 2 chunks of 150 ticks
   (a reset at tick 100, 30 syncs, 60 decays, every slot) with a train
   state saved and restored between them, through ``build_chunk_ring``
   (one CUDA graph replay a tick) and through its eager tick from the same
   carry: every carry tensor and output bitwise, B1 and B2 (the default
   learner's trained ticks, all of them here, or in_kernel_td's) launched
   once a tick either way; logs both ways' obs/s, host ms a tick and the
   device's busy share (20 profiled ticks each);
10. the jnp, full and fused engines' chunks (``train.Chunk``, the CLI's on
   one card) with the CLI's nets and schedule but a reset every 50 ticks
   (ENGINE_CASES): the jnp engine at 1 env (memory 100,000) and at 64
   (1,024 slots, wrapping), the full engine at 65,536 envs and the fused
   engine with the CLI's default conv net at 65,536, each over a
   StreamReplay of 5 env-batches that wraps; 2 chunks of 50 ticks with a
   train state saved and restored between, graphed and eager from the
   same carry: every carry tensor, the replay's cursor and size and every
   output bitwise, B3, B4 and (the jnp engine) B5 launched once a tick
   either way, the replay's sample kernel once a trained tick either way,
   the learner kernel once a trained tick of the dense net's jnp and
   full engines (none for the fused engine's conv net, which stays on
   autograd); logs the graphs, capture seconds, both ways' obs/s, ms a
   tick, device ms, launches a tick and busy share; then the
   host's walk of a 100,000-tick jnp chunk (the CLI's ``--max_scan_steps``)
   and the CLI at its defaults, which must run the jnp engine as graphs;
Phase 4 fails unless the ring sample launches once a tick on the ring
engine, 4c/4d unless their StreamReplay sample launches once a trained
tick, the draw kernel on the fused engine (its opponents and actor; the
full engine's sample draws in the sample kernel) and the ring sample on
neither; phases 9, 10 and 6e log the draw kernel's
four counters (draws, the ring's, the StreamReplay's and the
ReplayBuffer's samples) a tick of both ways beside B1-B5's, phase 9
fails unless the ring sample launches once a tick either way and phase
10 unless the jnp and fused engines launch the draw kernel and each
engine's replay sample launches once a trained tick either way.
Then print the kernel table line (phase 6a's launches of B1, B3 and B4 as
``*_sharded`` entries, each kernel compared with its plain version and
timed in place on a world-1 sharded trainer's carry at 6a's shapes, with
6b's launches of the same builds per rank and 6e's graphed ones,
``launches_6e_chunk``; B1's entries also carry
phase 7's launches, ``launches_7a_numerics_lock`` and
``launches_7d_cli_tensorboard``, and with B2's phase 8's,
``launches_8_bench``; B2's ``launches`` are phase 4's default path's and
4b's ``in_kernel_td`` ones (``launches_4_default``,
``launches_4b_in_kernel_td``), beside 4c's and 4d's
(``launches_4c_full_engine``, ``launches_4d_fused_engine``) and the
graphed chunks' of phases 9 and 10 (``launches_9_chunk``,
``launches_10_chunk``); the ``draw`` entry's launches are phases 4c and
4d's, the ``ring_sample`` entry's phase 4's, each with
``launches_9_chunk``, ``launches_10_chunk`` and ``launches_6e_chunk``,
the graphed chunks' launches of those phases; the ``stream_sample``
entry's 4c and 4d's, the ``buffer_sample`` entry's 4f's CLI run's, each
with the same chunk keys; ``step_observe``, B5 with the jnp engine's
observation, 4f's CLI run's, with ``launches_10_chunk`` and
``launches_6e_chunk``),
the card line, and the result line last. CLI runs write their run dirs
under ``output/chip_smoke/`` (removed at the end).

It imports nothing of JAX and nothing of the JAX package.
"""

import copy
import ctypes
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

GRID, DRONES, RADIUS = 9, 4, 3
NUM_ENVS = 65536
CAPACITY = 131072          # the bench's ring: max(ceil(1e5 / E) * E, 2E)
BATCH = 8
RESET_EVERY = 100
NETS = ((16, 16), (128, 64))
STREAM_CAPACITY = 1048576  # ceil(1e6 / E) * E: --memory_size 1000000
CLI_ENVS, CLI_STEPS = 16384, 30
# B5's boards (grid, drones): the bench's, a tight one (more respawn slots
# than vacant cells), 400 cells, the evaluator's arena for 20 participants
# (dronerl_tpu/evaluator/evaluator.py arena_params(20)), and 48 drones on a
# nearly full board (480 objects on 484 cells).
STEP_BOARDS = ((GRID, DRONES), (5, 2), (20, DRONES), (20, 20), (22, 48))
# B4's boards: the bench's, the tight one, and grid 16 with 25 drones (the
# tick kernels' limits are 256 cells and 32 drones).
TICK_BOARDS = ((GRID, DRONES), (5, 2), (16, 25))
STEP_COMPARE = 3
STEP_DRIVE = 100
# Phase 3j: B5 with the jnp engine's observation at STEP_OBS_ENVS envs (the
# CLI's default of 1, 7 below the JAX gate's 8, phase 10's 64 and 100, a
# partial last tile), window and global, STEP_OBS_K drones collected,
# STEP_OBS_TICKS ticks each; then timed at STEP_OBS_TIMED envs.
STEP_OBS_ENVS = (1, 7, 64, 100)
STEP_OBS_K = (1, 4)
STEP_OBS_TICKS = 4
STEP_OBS_TIMED = (1, 64, NUM_ENVS)
BLOCK_LAUNCHES = 50
COMPARE_TICKS = 8
COMPARE_RESET_TICK = 4
LEARNER_TICKS = 6
# The learner kernel's cases (net, batch): the bench nets, a one-layer net
# whose 8 units leave half of 16 CTAs without a unit, (32,16) and (100,),
# which 16 CTAs do not divide, each at batch 1, the bench's 8 and 256 (the
# batch read from device memory, in tiles of columns where the rows of
# the whole batch do not fit); and (512,), too wide to stage its params.
LEARNER_CASES = tuple(
    (h, b) for h in ((16, 16), (128, 64), (8,), (32, 16), (100,))
    for b in (8, 1, 256)) + (((512,), 8), ((512,), 256))
EMPTY_LAUNCHES = 200
JNP_ENVS, JNP_STEPS = 64, 30
# The conv family and the global observation (phases 3g, 4g, 4h). CONV5 is
# dqn-agent-5's architecture (dronerl_tpu/evaluator/baselines/
# dqn-agent-5.safetensors: Conv_0 3x3, 6 -> 8 channels, padding 1, then
# Dense 16 and the output); CONV32 one conv of 32 channels and no dense
# layer, whose 2,592 hidden units on the global 9 x 9 board do not fit a
# block's shared memory. A case is (wrapper, grid, net); its nets run
# with --conv_matmul (the im2col chain in the tick kernels) and, for the
# fused engine, without it.
CONV5 = dict(network_type="conv", conv_dense_layers=(16,), conv_layers=(
    {"kernel_size": 3, "out_channels": 8, "padding": 1, "stride": 1},))
CONV32 = dict(network_type="conv", conv_dense_layers=(), conv_layers=(
    {"kernel_size": 3, "out_channels": 32, "padding": 1, "stride": 1},))
CHAIN_CASES = {
    "window_conv5": ("window", GRID, CONV5),
    "global_dense": ("global", GRID, dict(hidden_layers=(16, 16))),
    "global_conv5": ("global", GRID, CONV5),
    "global_conv32": ("global", GRID, CONV32),
    # The observation tile itself does not fit shared memory (1,536 rows).
    "global16_dense": ("global", 16, dict(hidden_layers=(16, 16))),
}
# The trainer drives of phase 4g: (case, engine), the fused engine's conv
# net without --conv_matmul.
CHAIN_DRIVES = (
    ("window_conv5", "ring"), ("window_conv5", "full"),
    ("window_conv5", "fused"),
    ("global_dense", "ring"), ("global_dense", "full"),
    ("global_dense", "fused"),
    ("global_conv5", "ring"), ("global_conv5", "full"),
    ("global_conv32", "ring"), ("global_conv32", "full"),
    ("global16_dense", "ring"))
CHAIN_TICKS = 3            # phase 3g: ticks of each kernel against plain
CHAIN_DRIVE = 12           # phase 4g: ticks of each drive
CHAIN_STREAM = 4 * NUM_ENVS + NUM_ENVS  # a StreamReplay past the ring gate
CLI_CONV_STEPS = 5
# collect_drones > 1 and --fast_rng's round counts (phases 3i and 4i): the
# window with all 4 drones collected and the global board with 2, each at
# --fast_rng off (20, None), actor (20, 8) and full (8, None); B4 takes
# the env side's count only (no actor), so it builds at 20 and 8.
COLLECT_CASES = (("window", 4), ("global", 2))
ROUND_MODES = {"off": (20, None), "actor": (20, 8), "full": (8, None)}
COLLECT = 4                # phase 4i's --collect_drones
# Phase 3i's cases (view, k, mode): COLLECT_CASES at every mode, and one
# drone at the reduced-round modes (one drone at "off" is phase 3's).
CASES_3I = tuple((view, k, mode) for view, k in COLLECT_CASES
                 for mode in ROUND_MODES) + (
    ("window", 1, "actor"), ("window", 1, "full"))
FAST_RNG_DRIVES = (("ring", "actor"), ("ring", "full"), ("full", "actor"),
                   ("full", "full"), ("fused", "full"))
COLLECT_DRIVE = 12         # phase 4i: ticks of each drive of a 3i build
WARMUP_TICKS = 10
REPEATS = 3
TICKS_PER_REPEAT = 100
TIMED_LAUNCHES = 20
PLAIN_LAUNCHES = 3
LEARNER_LAUNCHES = 200
LEARNER_PLAIN_LAUNCHES = 100
PROFILED_CALLS = 20
CHARGE_ATOL = 1.3e-7
NEAR_TIE = 1e-5
LEARNER_RTOL, LEARNER_ATOL = 1e-5, 1e-6
TD_HPARAMS = (0.9, 1e-3, 0.9, 0.999, 1e-8)  # gamma, lr, Adam b1, b2, eps
# Phase 5, the trainer's lifecycle through the CLI at the bench's
# configuration (nothing cut): LIFE_STEPS ticks in chunks of LIFE_CHUNK
# with an eval of LIFE_EVALS seeds x LIFE_EVAL_STEPS before the second and
# at the end; then LIFE_CHUNK ticks, a train state, a resume and
# LIFE_CHUNK more. epsilon's decay is pinned: the derived one depends on
# --num_steps.
LIFE_STEPS, LIFE_CHUNK = 300, 150
LIFE_EVALS, LIFE_EVAL_STEPS = 5, 1000
LIFE_BASE = ["--num_envs", str(NUM_ENVS), "--grid_size", str(GRID),
             "--n_drones", str(DRONES), "--window_radius", str(RADIUS),
             "--batch_size", str(BATCH), "--reset_env_every",
             str(RESET_EVERY), "--memory_size", "100000",
             "--ring_obs_dtype", "bfloat16", "--epsilon_decay", "0.995",
             "--seed", "0"]
BASELINES = os.path.join("dronerl_tpu_torch", "evaluator", "baselines")
AGENT_3 = os.path.join(BASELINES, "dqn-agent-3.safetensors")
# (name, CLI flags, net): dqn-agent-3 is dense (16,16), the bench's first
# net.
LIFE_RUNS = (
    ("warm3", ["--load_from_checkpoint", AGENT_3], (16, 16)),
    ("seed128x64", ["--hidden_layers", "128", "64"], (128, 64)),
    ("warm3_in_kernel_td", ["--load_from_checkpoint", AGENT_3,
                            "--in_kernel_td"], (16, 16)),
)
# Phases 9 and 10: CHUNKS chunks of each case's ticks, graphed and eager,
# then TRACE profiled ticks each way. Phase 9: 150 ticks a chunk (a reset
# at tick 100, 30 syncs, 60 decays, every slot). Phase 10: 50 ticks a
# chunk, a reset every RESET_10 (at ticks 0 and 50, the second one
# training) of ENGINE_CASES (engine, envs, memory, CLI flags): the jnp
# engine at one env with the CLI's memory (no wrap) and at 64 with 1,024
# slots (a wrap every 16 ticks), the full engine at
# 65,536 and the fused engine with the CLI's default conv net at 65,536,
# each over a StreamReplay of 5 env-batches (past the ring gate's 4; a
# wrap every 5 ticks).
CHUNKS, TRACE = 2, 20
CHUNK_9_TICKS, CHUNK_10_TICKS, RESET_10 = 150, 50, 50
ENGINE_CASES = (("jnp", 1, 100_000, ()), ("jnp", 64, 1_000, ()),
                ("full", NUM_ENVS, 5 * NUM_ENVS, ()),
                ("fused", NUM_ENVS, 5 * NUM_ENVS,
                 ("--network_type", "conv")))
LIFE_PROBE = 1024          # 5b: seeded observations for the Q-values
# 5c: the JAX package's CPU scores of the five baselines' round robin
# (tests/test_evaluator_regression.py), printed beside the port's.
JAX_CPU_LOCK = (-56.02, -72.12, -58.05, -52.30, -46.46)
# Phase 6, multi-GPU training. 6a: the CLI with --use_sharding at world
# size 1 (NCCL) at the bench configuration, MG_TICKS ticks a run: (engine,
# --memory_size, net flags, the kernel, the nets). 6b: MG_RANKS ranks on
# the one card over gloo, MG_SMALL envs a rank for MG_COMPARE_TICKS ticks
# in lockstep with the plain versions (MG_CASES: name, engine, net, the
# kernel), then the ring engine at MG_BIG envs a rank for MG_BIG_TICKS
# ticks; 6c saves a rank's train state after MG_RESUME_AT ticks. 6e: a
# world-1 NCCL trainer's chunk against its eager ticks, CHUNKS x
# CHUNK_10_TICKS ticks with a reset every RESET_10, for each local engine:
# (engine, envs, --memory_size a shard, net; None the CLI's conv net).
MG_TICKS = 150
MG_CLI_RUNS = (("ring", "100000", [], "full_tick_ring", NETS),
               ("fused", "1000000", [], "full_tick", NETS),
               ("fused", "1000000", ["--network_type", "conv"], "tick",
                (None,)))
MG_REPLACES = {
    "full_tick_ring": ("dronerl_tpu/parallel/distributed.py:417 "
                       "(full_tick_fused_ring per shard)"),
    "full_tick": ("dronerl_tpu/parallel/distributed.py:320 (full_tick_fused "
                  "per shard)"),
    "tick": "dronerl_tpu/parallel/distributed.py:337 (tick_fused per shard)",
}
MG_RANKS, MG_SMALL, MG_COMPARE_TICKS, MG_RESET = 2, 256, 12, 5
MG_BIG, MG_BIG_TICKS, MG_RESUME_AT = 32768, 150, 6
MG_NET = dict(epsilon_start=0.5, epsilon_decay=0.995, epsilon_decay_every=5,
              target_update_interval=10, gamma=0.9)
MG_CASES = (
    ("ring", "ring", dict(MG_NET, hidden_layers=(16, 16)), "full_tick_ring"),
    ("fused_dense", "fused", dict(MG_NET, hidden_layers=(16, 16)),
     "full_tick"),
    ("fused_conv", "fused", dict(
        MG_NET, network_type="conv", conv_dense_layers=(16,),
        conv_layers=({"out_channels": 8, "kernel_size": 3, "stride": 1,
                      "padding": 1},)), "tick"),
)
MG_CHUNK_CASES = (("ring", NUM_ENVS, 100_000, (16, 16)),
                  ("ring", NUM_ENVS, 100_000, (128, 64)),
                  ("fused", NUM_ENVS, 5 * NUM_ENVS, (16, 16)),
                  ("fused", NUM_ENVS, 5 * NUM_ENVS, (128, 64)),
                  ("fused", NUM_ENVS, 5 * NUM_ENVS, None),
                  ("jnp", 64, 1_000, (16, 16)))
MG_REDUCES = 200           # all-reduce calls timed
MG_BENCH_STEPS = 100       # 6d: benchmark.py's steps
MG_GYM_STEPS = 100         # 6d: DeliveryDronesEnv steps, card vs CPU
MG_PROBE_SECONDS = 90      # NCCL with two ranks on one card
# Phase 7, the repo's last entry points and locks: 7c trains the five
# baselines EP_BASELINE_STEPS steps each and scores them over
# EP_SCORE_SEEDS x EP_SCORE_STEPS; 7d runs the CLI with --tensorboard_dir
# for EP_CLI_STEPS steps; the learner bound at EP_LEARNER_BATCH (B6's
# batch) is printed for both nets.
EP_BASELINE_STEPS = 200
EP_SCORE_SEEDS, EP_SCORE_STEPS = (1, 2), 100
EP_CLI_STEPS = 20
EP_LEARNER_BATCH = 256
# Phase 8: the bench program's environment (its other sizes are its
# defaults: 65,536 envs, 200 ticks a call), the companions' ticks a call
# and repeats, and config 5's board (built in phase 2's wave).
BENCH_ENV = {"DRONERL_BENCH_REPEATS": "3", "DRONERL_BENCH_REPEATS_BIG": "2",
             "DRONERL_BENCH_CALLS": "1"}
BENCH_SCRIPTS = (("torch_ring_bench", ["--envs", str(NUM_ENVS), "--calls",
                                       "1"]),
                 ("torch_config5_bench", ["--collect", "1", "--calls", "1"]),
                 ("torch_scaling_bench", ["--world_sizes", "1"]))
BENCH_SCRIPT_STEPS = 50
BENCH_SCRIPT_REPEATS = 2
CONFIG5_BOARD = (16, 8)
# H100 SXM published peaks: HBM bytes/s and
# f32 FLOP/s on the CUDA cores. Integer hash operations are counted at
# the f32 rate too, a rate no lower than the card's int32 rate, so the
# bound stays a lower bound.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# The full tick kernel's dense layers but the last run on the tensor
# cores as bf16 mma.sync products with f32 accumulation, so their FLOPs
# are counted at the dense bf16 rate, times the products the f32-accurate
# scheme needs: W in three bf16 pieces against the bf16 ring's exact
# observations (B1's first layer: 3 products), and f32 operands (B3's
# observations, the hidden activations) split in three as well (6
# products of order <= 2^-16). The output layer's FLOPs count at
# PEAK_F32. The old bound, every FLOP at PEAK_F32, is printed beside it.
PEAK_BF16 = 989e12
FIRST_LAYER_PRODUCTS = {"bf16": 3, "f32": 6}
HIDDEN_PRODUCTS = 6
OPS_PER_HASH = 79          # threefry2x32-20: 20 rounds x 3 + 5 x 3 + 4
# Phase 2b: the draw kernel timed over DRAW_LAUNCHES launches of a
# prebuilt block at the main path's shapes (mode, keys, counters): the
# replay sample's randint at batch 8 with its bound read by pointer, the
# plain tick's split of one key into E + 2 keys, a uniform field of 4 x E
# from one key and the env core's split of E keys in two; the ring
# sample at the bench's ring (294 rows, 2 x 8 columns gathered).
DRAW_LAUNCHES = 200
# Phase 2b's replays: the StreamReplay of phase 10's full engine
# (SAMPLE_STREAM_BATCHES env-batches) and the ReplayBuffer of the jnp CLI's
# default --memory_size (SAMPLE_ROWS transitions).
SAMPLE_STREAM_BATCHES = 5
SAMPLE_ROWS = 100_000
DRAW_TIMED = (("randint", 1, BATCH), ("split", 1, NUM_ENVS + 2),
              ("uniform", 1, 4 * NUM_ENVS), ("split", NUM_ENVS, 2))
# The draw kernel's launch counters (ops/draws.py): the draws, the ring's
# sample and the StreamReplay's and ReplayBuffer's samples.
DRAW_NAMES = ("draw", "ring_sample", "stream_sample", "buffer_sample")
# The phases whose graphed chunks' launches of those the kernel line
# reports: {phase: {name: launches}}, filled by graphed_vs_eager.
GRAPHED_DRAWS = {}
ADAM_OPS = 13              # per parameter: m 3, v 4, the update 6
SYNC_OPS = 3               # per parameter: tau p + (1 - tau) t


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def want_launches(train, n, kernel, ticks, learner, trained):
    """The launches (the keys of the counts ``n``) that a run of ``ticks``
    ticks must make: ``kernel`` (None: no tick kernel) once a tick, the
    learner kernel by the run's route (``Tick.learner``, a CLI run's
    ``learner``): once a tick on ``in_kernel_td``, once a ``trained`` tick
    on the kernel, never on autograd; nothing else."""
    want = dict.fromkeys(n, 0)
    if kernel:
        want[kernel] = ticks
    want["td_adam"] = {train.KERNEL: trained,
                       train.IN_KERNEL_TD: ticks}.get(learner, 0)
    return want


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dronerl_tpu_torch")):
        fail("the dronerl_tpu_torch package is not beside this script")
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dronerl_tpu_torch import replay, rng, train
    from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
    from dronerl_tpu_torch.env import core
    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.ops import (
        _build, draws, fused_tick, learner_kernel, step_kernel)
    from dronerl_tpu_torch.train import build_train_step_ring, init_ring_carry

    counters = {"full_tick_ring": fused_tick.full_tick_fused_ring,
                "td_adam": learner_kernel.td_adam,
                "full_tick": fused_tick.full_tick_fused,
                "tick": fused_tick.tick_fused,
                "step": step_kernel.step_batch_fused}
    # The draws' counts are read apart (draw_counts): every phase's check
    # that no other kernel launches is about B1-B5.
    draw_counters = {name: getattr(draws, name) for name in DRAW_NAMES}

    def zero_counts():
        for fn in (*counters.values(), *draw_counters.values()):
            fn.launches = 0
        fused_tick.full_tick_fused.pushes = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def draw_counts():
        return {k: fn.launches for k, fn in draw_counters.items()}

    runs = os.path.join(here, "output", "chip_smoke")
    shutil.rmtree(runs, ignore_errors=True)

    def cli(argv):
        """The CLI without the final eval, its run dir under ``runs``."""
        return train.main(argv + ["--skip_final_eval", "--run_dir",
                                  os.path.join(runs, "cli")])

    device = torch.device("cuda", 0)
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch: {device_kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # --- 2. build ------------------------------------------------------------
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    obs_dim = fused_tick.obs_rows(params)
    widths = {h: (obs_dim, *h, 5) for h in NETS}
    boards = {b: EnvParams(grid_size=b[0], n_drones=b[1],
                           window_radius=RADIUS)
              for b in dict.fromkeys(STEP_BOARDS + TICK_BOARDS)}
    learner_nets = dict.fromkeys(h for h, _ in LEARNER_CASES)
    learner_configs = [_build.learner_config((obs_dim, *h, 5))
                       for h in learner_nets]
    chain_cases = {}  # case -> (env, agent with --conv_matmul, its state)
    for case, (wrapper, grid, net) in CHAIN_CASES.items():
        cp = EnvParams(grid_size=grid, n_drones=DRONES, window_radius=RADIUS,
                       wrapper=wrapper)
        agent = DQN(DQNConfig(
            **net, conv_matmul=net.get("network_type") == "conv",
            epsilon_decay_every=5, target_update_interval=10, gamma=0.9),
            cp, device=device)
        chain_cases[case] = (cp, agent, agent.init_state(rng.PRNGKey(0)))
    cli_conv = DQN(DQNConfig(network_type="conv", conv_matmul=True), params,
                   device=device)
    cli_chain = fused_tick.flatten_net_params(
        cli_conv.init_state(rng.PRNGKey(0)).params, cli_conv.net_spec)
    configs = ([_build.tick_config(params, widths[h]) for h in NETS]
               + learner_configs
               + [_build.env_config(p) for p in boards.values()]
               + [_build.env_config(step_obs_params(w), k)
                  for w in ("window", "global") for k in STEP_OBS_K]
               + [fused_tick.kernel_config(cp, fused_tick.flatten_net_params(
                   st.params, agent.net_spec))
                  for cp, agent, st in chain_cases.values()]
               + [_build.env_config(cp) for cp, _, _ in chain_cases.values()
                  if cp.wrapper == "global"]
               + [fused_tick.kernel_config(params, cli_chain)]
               + [_build.draw_config()])
    # Phases 3i and 4i: every (view, k, mode, net) build, the env builds,
    # the k = 1 builds of the fast-RNG drives and of the global board.
    collect_params = {view: EnvParams(grid_size=GRID, n_drones=DRONES,
                                      window_radius=RADIUS, wrapper=view)
                      for view, _ in COLLECT_CASES}
    collect_widths = {(view, h): (fused_tick.obs_rows(cp), *h, 5)
                      for view, cp in collect_params.items() for h in NETS}
    configs += [_build.tick_config(collect_params[view],
                                   collect_widths[(view, h)], k, *rounds)
                for view, k in COLLECT_CASES
                for rounds in ROUND_MODES.values() for h in NETS]
    configs += [_build.env_config(collect_params[view], k, rr)
                for view, k in COLLECT_CASES for rr in (20, 8)]
    configs += [_build.tick_config(params, widths[h], 1, *ROUND_MODES[mode])
                for mode in ("actor", "full") for h in NETS]
    configs += [_build.env_config(params, 1, 8)]
    configs += [_build.tick_config(collect_params["global"],
                                   collect_widths[("global", h)])
                for h in NETS]
    configs += [_build.tick_config(
        EnvParams(grid_size=CONFIG5_BOARD[0], n_drones=CONFIG5_BOARD[1],
                  window_radius=RADIUS), widths[NETS[0]])]  # phase 8
    t0 = time.perf_counter()
    built = _build.build(configs)
    log(f"built {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s (per build: "
        f"{[round(s, 1) for s in built.values()]})")
    for cfg in dict.fromkeys(configs):
        ptxas = [ln.strip() for ln in _build.build_log(cfg).splitlines()
                 if "registers" in ln or "spill" in ln]
        tag = tuple(int(v) for k, v in cfg[1]
                    if k.startswith("DR_DIM") and v != "0")[1:-1]
        if cfg[0] == _build.ENV_SOURCE:
            tag = dict(cfg[1])["DR_GRID"], dict(cfg[1])["DR_NDRONES"]
        if "DR_GLOBAL" in dict(cfg[1]):
            tag = ("global", *tag)
        options = tuple(f"{name}={dict(cfg[1])[d]}" for d, name in (
            ("DR_COLLECT", "k"), ("DR_RNG_ROUNDS", "rounds"),
            ("DR_ACTOR_ROUNDS", "actor_rounds")) if d in dict(cfg[1]))
        log(f"ptxas {cfg[0]} {tag + options}: " + " | ".join(ptxas))
        if options and any(not ln.startswith("0 bytes stack frame, 0 bytes "
                                             "spill stores, 0 bytes spill")
                           for ln in ptxas if "spill" in ln):
            fail(f"{cfg[0]} {tag + options}: a spill or a stack frame")
        if cfg[0] == _build.LEARNER_SOURCE:
            net_w = (obs_dim, *tag, 5)
            for bsz in [b for h, b in LEARNER_CASES if h == tag]:
                shape = learner_kernel.launch_shape(cfg, bsz)
                plan = learner_kernel.batch_plan(net_w, bsz)
                got = (shape["tile"], bool(shape["staged"]),
                       bool(shape["params_staged"]), shape["smem_bytes"])
                if got != tuple(plan):
                    fail(f"learner {tag} batch {bsz}: launch {got} != "
                         f"learner_kernel.batch_plan {tuple(plan)}")
                log(f"learner kernel {tag} batch {bsz}: a cluster of "
                    f"{shape['cluster']} CTAs of {shape['threads']} threads, "
                    f"{shape['smem_bytes']} B dynamic shared memory a CTA, "
                    f"tiles of {shape['tile']} columns, the batch "
                    f"{'staged' if shape['staged'] else 'read'}, the params "
                    f"{'staged' if shape['params_staged'] else 'read'}, "
                    f"{shape['max_active_clusters']} clusters at once")
        if cfg[0] == _build.TICK_SOURCE:
            tick_params = EnvParams(
                grid_size=int(dict(cfg[1])["DR_GRID"]),
                n_drones=int(dict(cfg[1])["DR_NDRONES"]),
                window_radius=RADIUS, wrapper="global"
                if "DR_GLOBAL" in dict(cfg[1]) else "window")
            net_w = tuple(int(v) for k, v in cfg[1]
                          if k.startswith("DR_DIM") and v != "0")
            for bf16 in (True, False):
                smem, blocks, scratch = fused_tick.kernel_occupancy(cfg, bf16)
                mirror = fused_tick.tick_layout(tick_params, net_w, bf16)
                if (smem, scratch) != (mirror["smem_bytes"],
                                       mirror["scratch_bytes"]):
                    fail(f"full tick kernel {net_w}: shared memory, scratch "
                         f"{smem}, {scratch} != fused_tick.tick_layout "
                         f"{mirror}")
                log(f"full tick kernel {tick_params.wrapper} grid "
                    f"{tick_params.grid_size} {net_w} "
                    f"{'bf16' if bf16 else 'f32'} obs: variant "
                    f"{mirror['variant']}, {smem} B dynamic shared memory a "
                    f"block, {scratch} B device-memory scratch a block, "
                    f"{blocks} resident blocks an SM")
        elif cfg[0] == _build.ENV_SOURCE:
            shape = fused_tick.env_block_shape(cfg)
            log(f"env kernel {tag}: blocks of {shape['envs']} envs and "
                f"{shape['threads']} threads, {shape['smem_bytes']} B "
                f"dynamic shared memory; resident blocks an SM: B4 "
                f"{shape['tick_blocks_per_sm']} (-1: beyond the tick's "
                f"limits), B5 {shape['step_blocks_per_sm']}")

    # --- 2b. the draw and ring sample kernels against their plain versions -
    draw_entries = draw_phase(torch, card)

    def make_agent(hidden, seed, env=params):
        cfg = DQNConfig(hidden_layers=hidden, epsilon_decay_every=5,
                        target_update_interval=10, gamma=0.9)
        agent = DQN(cfg, env, device=device)
        return agent, agent.init_state(torch.Generator().manual_seed(seed))

    def fresh_env(seed, dtype):
        state = core.reset_batch(rng.PRNGKey(seed).to(device), params,
                                 NUM_ENVS)
        ring = torch.zeros((obs_dim, 2 * NUM_ENVS), dtype=dtype,
                           device=device)
        ring[:, :NUM_ENVS] = core.observe_batch(state, params, 1).reshape(
            NUM_ENVS, obs_dim).t().to(dtype)
        return fused_tick.to_tstate(state), ring

    def check_actions(tag, cp, chain, step_key, actions, obs_in, read, eps,
                      rounds=(20, None)):
        """The kernel's actions against the plain actor's (its keys and
        uniforms at ``rounds``) outside near ties of the plain Q-values;
        returns the near-tie count."""
        keys = rng.split_plain(step_key.to(device), NUM_ENVS + 2,
                               rounds[0])
        act_p, q = fused_tick.plain_actions(
            keys[NUM_ENVS], obs_in, read, chain, eps, cp, NUM_ENVS,
            fused_tick.actor_rounds(*rounds))
        top2 = q.topk(2, dim=0).values
        tie = (top2[0] - top2[1]) <= NEAR_TIE * q.abs().amax(dim=0)
        differ = (actions != act_p).any(dim=0)
        if bool((differ & ~tie).any()):
            fail(f"{tag}: {int((differ & ~tie).sum())} actions differ "
                 "outside near ties")
        return int(tie.sum())

    def check_env(tag, out_k, out_p, ring, ring_plain, read, write,
                  step_key, net, eps):
        """Phase 3's contract for one tick: returns (charge error, near
        ties)."""
        for name, a, b in zip(fused_tick.TState._fields, out_k[0], out_p[0]):
            if not torch.equal(a, b):
                fail(f"{tag}: state {name} differs")
        for name, i in (("rewards", 1), ("dones", 2)):
            if not torch.equal(out_k[i], out_p[i]):
                fail(f"{tag}: {name} differ")
        obs_k = ring[:, write:write + NUM_ENVS].float().reshape(
            -1, 6, NUM_ENVS)
        obs_p = ring_plain[:, write:write + NUM_ENVS].float().reshape(
            -1, 6, NUM_ENVS)
        ch = torch.arange(6, device=device) != 4
        if not torch.equal(obs_k[:, ch], obs_p[:, ch]):
            fail(f"{tag}: observation channels differ")
        charge_err = float((obs_k[:, 4] - obs_p[:, 4]).abs().max())
        if charge_err > CHARGE_ATOL:
            fail(f"{tag}: charge channel off by {charge_err}")
        if not torch.equal(ring[:, read:read + NUM_ENVS],
                           ring_plain[:, read:read + NUM_ENVS]):
            fail(f"{tag}: the read columns changed")
        return charge_err, check_actions(tag, params, net, step_key,
                                         out_k[3], ring_plain, read, eps)

    # --- 3. the tick kernel against its plain version ----------------------
    max_err = {}
    for hidden in NETS:
        max_err[hidden] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"net {hidden} ring {str(dtype)[6:]}"
            _, ag = make_agent(hidden, 1)
            tstate, ring = fresh_env(2, dtype)
            eps = torch.tensor(0.5, device=device)
            key = rng.PRNGKey(3)
            near_ties = 0
            for t in range(COMPARE_TICKS):
                key, step_key = rng.split(key, 2)
                read, write = (t % 2) * NUM_ENVS, ((t + 1) % 2) * NUM_ENVS
                do_reset = t == COMPARE_RESET_TICK
                ring_plain = ring.clone()
                out_k = fused_tick.full_tick_fused_ring(
                    step_key, tstate, ring, read, write, ag.params.flat(), eps,
                    do_reset, params)
                out_p = fused_tick.full_tick_ring_plain(
                    step_key, tstate, ring_plain, read, write,
                    ag.params.flat(),
                    eps, do_reset, params, actions_override=out_k[3])
                torch.cuda.synchronize()
                err, ties = check_env(f"{tag} tick {t}", out_k, out_p, ring,
                                      ring_plain, read, write, step_key,
                                      ag.params.flat(), eps)
                max_err[hidden] = max(max_err[hidden], err)
                near_ties += ties
                tstate = out_k[0]
            log(f"kernel == plain: {tag}, {COMPARE_TICKS} ticks (reset at "
                f"{COMPARE_RESET_TICK}); env bitwise, charge <= "
                f"{CHARGE_ATOL}; near-tie envs {near_ties}")

    # --- 3b. the learner kernel against its plain version ------------------
    def make_batch(seed, bsz=BATCH):
        """A batch in the replay gather's layout (obs and next_obs column
        slices of one (obs_dim, 2B) tensor), from a fixed seed."""
        g = torch.Generator().manual_seed(seed)
        both = (torch.rand((obs_dim, 2 * bsz), generator=g) < 0.3).float()
        rewards = torch.tensor([-1.0, 0.0, 1.0, -0.1])[
            torch.randint(0, 4, (bsz,), generator=g)]
        both, rewards = both.to(device), rewards.to(device)
        return {
            "obs": both[:, :bsz], "next_obs": both[:, bsz:],
            "actions": torch.randint(0, 5, (bsz,), generator=g,
                                     dtype=torch.int32).to(device),
            "rewards": rewards,
            "dones": (torch.rand(bsz, generator=g) < 0.2).float().to(
                device),
        }

    def leaves(st):
        return [x.detach() for x in st.params.flat() + st.target_params.flat()
                + st.opt_state.mu + st.opt_state.nu]

    def check_learner(tag, st, ref, before, cancelled, flags):
        """The learner's contract for one tick, kernel state ``st`` against
        plain state ``ref``, both from ``before``: returns (max abs error,
        cancelled elements beyond the tolerance)."""
        learn, sync = flags
        if st.opt_state.count != ref.opt_state.count:
            fail(f"{tag}: Adam count {st.opt_state.count} != "
                 f"{ref.opt_state.count}")
        n = len(cancelled)
        err, outliers = 0.0, 0
        for i, (k, p, b) in enumerate(zip(leaves(st), leaves(ref),
                                          leaves(before))):
            name = ("params", "target", "mu", "nu")[i // n] + f"_{i % n}"
            if ((i // n == 1 and not sync) or (i // n != 1 and not learn)) \
                    and not torch.equal(k, b):
                fail(f"{tag}: {name} changed with its flag off")
            diff = (k - p).abs()
            bad = diff > LEARNER_ATOL + LEARNER_RTOL * p.abs()
            if bool((bad & ~cancelled[i % n]).any()):
                fail(f"{tag}: {name}: {int((bad & ~cancelled[i % n]).sum())}"
                     f" elements beyond rtol {LEARNER_RTOL}, atol "
                     f"{LEARNER_ATOL} (max {float(diff.max())})")
            outliers += int(bad.sum())
            err = max(err, float(diff.max()))
        return err, outliers

    def check_loss(tag, loss, ref_loss, learn, slack):
        if not learn:
            if float(loss) != -1.0:
                fail(f"{tag}: loss {float(loss)} with learn off")
            return 0.0
        lk, lp = float(loss), float(ref_loss)
        if not abs(lk - lp) <= LEARNER_RTOL * abs(lp) + slack:
            fail(f"{tag}: loss {lk} vs plain {lp} (slack {slack})")
        return abs(lk - lp)

    def learner_ticks(hidden, bsz):
        """LEARNER_TICKS ticks of B6's entry point (``learn_tick_fused``)
        against the plain version: returns (final state, max abs err)."""
        agent, st = make_agent(hidden, 6)
        cfg = agent.config
        err, outliers, cancelled_total = 0.0, 0, 0
        for t in range(LEARNER_TICKS):
            tag = f"learner net {hidden} batch {bsz} tick {t}"
            learn, sync, dec = t != 2, t % 2 == 0, t % 3 == 0
            batch = make_batch(100 + t, bsz)
            _, grads, scales = learner_kernel.td_gradients(
                batch, st.params, st.target_params, cfg.gamma,
                with_scales=True)
            cancelled = learner_kernel.cancellations(grads, scales)
            cancelled_total += sum(int(c.sum()) for c in cancelled)
            # One TD error is the whole loss at batch 1: a cancellation of
            # Q-values that each learner sums in its own order.
            slack = learner_kernel.loss_slack(
                batch, st.params, st.target_params, cfg.gamma) if bsz == 1 \
                else 0.0
            before, ref = copy.deepcopy(st), copy.deepcopy(st)
            kw = dict(learn=learn, sync_target=sync, decay_eps=dec,
                      gamma=cfg.gamma, lr=cfg.learning_rate, tau=cfg.tau,
                      eps_decay=cfg.epsilon_decay, eps_end=cfg.epsilon_end)
            ref_loss = learner_kernel.td_adam_plain(
                batch, ref.params, ref.target_params, ref.opt_state.mu,
                ref.opt_state.nu, ref.opt_state.count, epsilon=ref.epsilon,
                **kw)
            if learn:
                ref.opt_state.count += 1
            st, loss = learner_kernel.learn_tick_fused(
                batch, st, learn, sync, dec, cfg)
            torch.cuda.synchronize()
            if not torch.equal(st.epsilon, ref.epsilon):
                fail(f"{tag}: epsilon {float(st.epsilon)} vs plain "
                     f"{float(ref.epsilon)}")
            if torch.equal(st.epsilon, before.epsilon) == dec:
                fail(f"{tag}: epsilon decay flag {dec} not honoured")
            e, o = check_learner(tag, st, ref, before, cancelled,
                                 (learn, sync))
            err = max(err, e, check_loss(tag, loss, ref_loss, learn, slack))
            outliers += o
        log(f"learner kernel == plain: net {hidden} batch {bsz}, "
            f"{LEARNER_TICKS} ticks (learn/sync/decay flags as "
            f"tests/test_learner_kernel.py); max abs err {err:.3e}; "
            f"cancellation elements {cancelled_total}, of which beyond the "
            f"tolerance {outliers}")
        return st, err

    learner_err, learner_state = {}, {}
    for hidden, bsz in LEARNER_CASES:
        st, err = learner_ticks(hidden, bsz)
        if hidden in NETS and bsz == BATCH:
            learner_err[hidden], learner_state[hidden] = err, st
    for hidden in NETS:
        st, err = learner_state[hidden], learner_err[hidden]
        # One tick of the in-kernel TD path: the tick kernel, then the
        # learner kernel, against the two plain versions.
        tag = f"td tick net {hidden} ring bfloat16"
        tstate, ring = fresh_env(5, torch.bfloat16)
        eps = torch.tensor(0.5, device=device)
        step_key = rng.PRNGKey(8)
        batch = make_batch(200)
        _, grads, scales = learner_kernel.td_gradients(
            batch, st.params, st.target_params, TD_HPARAMS[0],
            with_scales=True)
        cancelled = learner_kernel.cancellations(grads, scales)
        before, ref = copy.deepcopy(st), copy.deepcopy(st)
        ring_plain = ring.clone()
        adam = st.opt_state
        out_k = fused_tick.full_tick_fused_ring(
            step_key, tstate, ring, 0, NUM_ENVS, st.params.flat(), eps, False,
            params, td_hparams=TD_HPARAMS, td_batch=batch,
            td_aux=(st.params, st.target_params, adam.mu, adam.nu, True,
                    adam.count))
        out_p = fused_tick.full_tick_ring_plain(
            step_key, tstate, ring_plain, 0, NUM_ENVS, ref.params.flat(), eps,
            False, params, actions_override=out_k[3])
        gamma, lr, b1, b2, adam_eps = TD_HPARAMS
        ref_loss = learner_kernel.td_adam_plain(
            batch, ref.params, ref.target_params, ref.opt_state.mu,
            ref.opt_state.nu, ref.opt_state.count, learn=True,
            sync_target=False, decay_eps=False, epsilon=None, gamma=gamma,
            lr=lr, b1=b1, b2=b2, adam_eps=adam_eps)
        torch.cuda.synchronize()
        charge_err, ties = check_env(tag, out_k, out_p, ring, ring_plain, 0,
                                     NUM_ENVS, step_key,
                                     before.params.flat(), eps)
        max_err[hidden] = max(max_err[hidden], charge_err)
        e, o = check_learner(tag, st, ref, before, cancelled, (True, False))
        e = max(e, check_loss(tag, out_k[8], ref_loss, True, 0.0))
        learner_err[hidden] = max(err, e)
        log(f"td tick == plain pair: net {hidden}; env bitwise, charge "
            f"{charge_err:.3e}, near-tie envs {ties}; learner max abs err "
            f"{e:.3e}, cancellations beyond the tolerance {o}")

    def check_obs(tag, obs_k, obs_p):
        """Observations bitwise but the charge channel: returns its
        error."""
        obs_k = obs_k.float().reshape(-1, 6, obs_k.shape[-1])
        obs_p = obs_p.float().reshape(-1, 6, obs_p.shape[-1])
        ch = torch.arange(6, device=device) != 4
        if not torch.equal(obs_k[:, ch], obs_p[:, ch]):
            fail(f"{tag}: observation channels differ")
        charge_err = float((obs_k[:, 4] - obs_p[:, 4]).abs().max())
        if charge_err > CHARGE_ATOL:
            fail(f"{tag}: charge channel off by {charge_err}")
        return charge_err

    def check_state(tag, out_k, out_p, fields):
        for name, a, b in zip(fields, out_k, out_p):
            if not torch.equal(a, b):
                fail(f"{tag}: {name} differs")

    # --- 3c. B3 (the full tick's obs launch) against its plain version -------
    def fresh_obs(seed):
        state = core.reset_batch(rng.PRNGKey(seed).to(device), params,
                                 NUM_ENVS)
        obs_t = core.observe_batch(state, params, 1).reshape(
            NUM_ENVS, obs_dim).t().contiguous()
        return fused_tick.to_tstate(state), obs_t

    full_err = {}
    for hidden in NETS:
        tag = f"B3 net {hidden}"
        _, ag = make_agent(hidden, 1)
        tstate, obs_t = fresh_obs(2)
        eps = torch.tensor(0.5, device=device)
        key = rng.PRNGKey(3)
        near_ties, full_err[hidden] = 0, 0.0
        for t in range(COMPARE_TICKS):
            key, step_key = rng.split(key, 2)
            do_reset = t == COMPARE_RESET_TICK
            before = obs_t.clone()
            out_k = fused_tick.full_tick_fused(step_key, tstate, obs_t,
                                               ag.params.flat(), eps,
                                               do_reset,
                                               params)
            out_p = fused_tick.full_tick_plain(
                step_key, tstate, obs_t, ag.params.flat(), eps, do_reset,
                params,
                actions_override=out_k[3])
            torch.cuda.synchronize()
            check_state(f"{tag} tick {t}", out_k[0] + out_k[1:3],
                        out_p[0] + out_p[1:3], fused_tick.TState._fields
                        + ("rewards", "dones"))
            full_err[hidden] = max(full_err[hidden], check_obs(
                f"{tag} tick {t}", out_k[4], out_p[4]))
            if not torch.equal(obs_t, before):
                fail(f"{tag} tick {t}: obs_t was written")
            near_ties += check_actions(f"{tag} tick {t}", params,
                                       ag.params.flat(), step_key, out_k[3],
                                       obs_t, 0, eps)
            tstate, obs_t = out_k[0], out_k[4]
        log(f"B3 == plain: net {hidden}, {COMPARE_TICKS} ticks (reset at "
            f"{COMPARE_RESET_TICK}); env bitwise, charge max err "
            f"{full_err[hidden]:.3e}; near-tie envs {near_ties}")

    # B3 as the full engine launches it: the push into the StreamReplay
    # inside the launch, the next observation over obs_t.
    gen = torch.Generator().manual_seed(5)
    noise = replay_store(torch, gen, device, obs_dim, STREAM_CAPACITY, False)
    for hidden in NETS:
        _, ag = make_agent(hidden, 1)
        for k in (1, COLLECT):
            tag = f"B3 push net {hidden} k={k}"
            state = core.reset_batch(rng.PRNGKey(12).to(device), params,
                                     NUM_ENVS)
            tstate = fused_tick.to_tstate(state)
            obs_k = train._stacked_obs(state, params, k)
            storage = {n: t.clone() for n, t in noise.items()}
            cols = k * NUM_ENVS
            starts = (STREAM_CAPACITY - cols, 0,
                      STREAM_CAPACITY // 2 // cols * cols)
            eps = torch.tensor(0.5, device=device)
            key, near_ties = rng.PRNGKey(13), 0
            for t, start in enumerate(starts):
                key, step_key = rng.split(key, 2)
                do_reset = t == 1
                obs_in = obs_k.clone()
                obs_p = obs_k.clone()
                storage_p = {n: v.clone() for n, v in storage.items()}
                out_k = fused_tick.full_tick_fused(
                    step_key, tstate, obs_k, ag.params.flat(), eps, do_reset,
                    params, collect=k, replay=(storage, start))
                out_p = fused_tick.full_tick_plain(
                    step_key, tstate, obs_p, ag.params.flat(), eps, do_reset,
                    params, actions_override=out_k[3], collect=k,
                    replay=(storage_p, start))
                torch.cuda.synchronize()
                ttag = f"{tag} tick {t} start {start}"
                if out_k[4] is not obs_k or out_p[4] is not obs_p:
                    fail(f"{ttag}: the next observation is not obs_t")
                check_state(ttag, out_k[0] + out_k[1:4],
                            out_p[0] + out_p[1:4], fused_tick.TState._fields
                            + ("rewards", "dones", "actions"))
                full_err[hidden] = max(full_err[hidden],
                                       check_obs(ttag, obs_k, obs_p))
                for name in storage:
                    if not torch.equal(storage[name], storage_p[name]):
                        fail(f"{ttag}: the replay's {name} differ")
                near_ties += check_actions(ttag, params, ag.params.flat(),
                                           step_key, out_k[3], obs_in, 0,
                                           eps)
                tstate = out_k[0]
            log(f"B3 push == plain: net {hidden} k={k}, {len(starts)} ticks "
                f"(reset at 1) at starts {starts} of a {STREAM_CAPACITY}-"
                f"slot replay; replay bitwise, obs_t the next observation, "
                f"env bitwise, charge max err {full_err[hidden]:.3e}; "
                f"near-tie envs {near_ties}")
    del noise, storage, storage_p

    # --- 3d. B4 (the env tick) against its plain version --------------------
    tick_err = 0.0
    for board in TICK_BOARDS:
        bp = boards[board]
        ticks = COMPARE_TICKS if board == (GRID, DRONES) else STEP_COMPARE
        tstate = fused_tick.to_tstate(core.reset_batch(
            rng.PRNGKey(4).to(device), bp, NUM_ENVS))
        key = rng.PRNGKey(5)
        for t in range(ticks):
            tag = f"B4 board {board} tick {t}"
            key, act_key, step_key = rng.split(key, 3)
            actions = rng.randint(act_key.to(device), (bp.n_drones, NUM_ENVS),
                                  0, 5)
            out_k = fused_tick.tick_fused(step_key, tstate, actions, bp)
            out_p = fused_tick.tick_plain(step_key, tstate, actions, bp)
            torch.cuda.synchronize()
            check_state(tag, out_k[0] + out_k[1:3], out_p[0] + out_p[1:3],
                        fused_tick.TState._fields + ("rewards", "dones"))
            tick_err = max(tick_err, check_obs(tag, out_k[3], out_p[3]))
            tstate = out_k[0]
        log(f"B4 == plain: board (grid, drones) {board}, {ticks} ticks of "
            f"random actions at {NUM_ENVS} envs; env bitwise, charge max "
            f"err {tick_err:.3e}")

    # --- 3e. B5 (the row-major step) against core.step_batch ----------------
    row_fields = ("ground", "air_x", "air_y", "carrying_package", "charge")
    step_err = 0.0
    for board in STEP_BOARDS:
        bp = boards[board]
        states = core.reset_batch(rng.PRNGKey(6).to(device), bp, NUM_ENVS)
        key = rng.PRNGKey(7)
        for t in range(STEP_COMPARE):
            key, act_key, step_key = rng.split(key, 3)
            actions = rng.randint(act_key.to(device), (NUM_ENVS, bp.n_drones),
                                  0, 5)
            out_k = step_kernel.step_batch_fused(step_key, states, actions,
                                                 bp)
            out_p = step_kernel.step_batch_plain(step_key, states, actions,
                                                 bp)
            torch.cuda.synchronize()
            check_state(f"B5 board {board} step {t}",
                        [getattr(out_k[0], f) for f in row_fields]
                        + list(out_k[1:]),
                        [getattr(out_p[0], f) for f in row_fields]
                        + list(out_p[1:]), row_fields + ("rewards", "dones"))
            step_err = max(step_err, *(
                float((a - b).abs().max()) for a, b in (
                    (out_k[0].charge, out_p[0].charge),
                    (out_k[1], out_p[1]))))
            states = out_k[0]
        log(f"B5 == core.step_batch: board (grid, drones) {board}, "
            f"{STEP_COMPARE} steps at {NUM_ENVS} envs; all bitwise (charge "
            f"and reward max err {step_err:.3e})")

    # The step entry point on the bench board, as a user drives it.
    states = core.reset_batch(rng.PRNGKey(8).to(device), params, NUM_ENVS)
    key = rng.PRNGKey(9)
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(STEP_DRIVE):
        key, act_key, step_key = rng.split(key, 3)
        actions = rng.randint(act_key.to(device), (NUM_ENVS, DRONES), 0, 5)
        states, rewards, dones = step_kernel.step_batch_fused(
            step_key, states, actions, params)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEP_DRIVE
    step_launches = counts()
    if step_launches["step"] != STEP_DRIVE or sum(
            step_launches.values()) != STEP_DRIVE:
        fail(f"step entry point: launches {step_launches} in {STEP_DRIVE} "
             "steps")
    if not bool(torch.isfinite(rewards).all()):
        fail("step entry point: non-finite rewards")
    log(f"step entry point: {STEP_DRIVE} steps, launches {step_launches}, "
        f"env steps/s {NUM_ENVS / step_s:.1f} (with the randint of the "
        f"actions on the card; {1e3 * step_s:.4f} ms a step) on {card}")

    # --- 3j. B5 with the jnp engine's observation against its plain version
    step_observe = step_observation(torch, card)

    # --- 3f. the initial nets: the card's init equals the CPU draw ----------
    for hidden in NETS:
        cfg = DQNConfig(hidden_layers=hidden)
        st_card = DQN(cfg, params, device=device).init_state(rng.PRNGKey(3))
        st_cpu = DQN(cfg, params, device="cpu").init_state(rng.PRNGKey(3))
        for a, b in zip(st_card.params.flat() + st_card.target_params.flat(),
                        st_cpu.params.flat() + st_cpu.target_params.flat()):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                fail(f"init net {hidden}: the card's init_state(key) is not "
                     "the CPU draw")
    log(f"init_state(PRNGKey(3)) on the card == the CPU draw, bitwise, nets "
        f"{list(NETS)}")

    # --- 3g. the conv family and the global observation: B1, B3, B4 --------
    def fresh_chain_env(cp, seed):
        state = core.reset_batch(rng.PRNGKey(seed).to(device), cp, NUM_ENVS)
        return fused_tick.to_tstate(state), core.observe_batch(
            state, cp, 1).reshape(NUM_ENVS, -1).t().contiguous()

    env_fields = fused_tick.TState._fields + ("rewards", "dones")
    chain_err = {}  # (case, "ring" / "full" / "tick") -> charge error
    for case, (cp, agent, st) in chain_cases.items():
        chain = fused_tick.flatten_net_params(st.params, agent.net_spec)
        eps = torch.tensor(0.5, device=device)
        variant = {bf16: fused_tick.tick_layout(
            cp, fused_tick.chain_widths(chain), bf16)["variant"]
            for bf16 in (True, False)}
        for launch in ("ring", "full"):
            tstate, obs0 = fresh_chain_env(cp, 2)
            if launch == "ring":
                obs = torch.zeros((obs0.shape[0], 2 * NUM_ENVS),
                                  dtype=torch.bfloat16, device=device)
                obs[:, :NUM_ENVS] = obs0.to(torch.bfloat16)
            else:
                obs = obs0
            key, err, ties = rng.PRNGKey(3), 0.0, 0
            for t in range(CHAIN_TICKS):
                tag = f"{case} {launch} tick {t}"
                key, step_key = rng.split(key, 2)
                do_reset = t == 1
                if launch == "ring":
                    read, write = (t % 2) * NUM_ENVS, ((t + 1) % 2) * NUM_ENVS
                    obs_plain = obs.clone()
                    out_k = fused_tick.full_tick_fused_ring(
                        step_key, tstate, obs, read, write, chain, eps,
                        do_reset, cp)
                    out_p = fused_tick.full_tick_ring_plain(
                        step_key, tstate, obs_plain, read, write, chain, eps,
                        do_reset, cp, actions_override=out_k[3])
                    torch.cuda.synchronize()
                    next_k = obs[:, write:write + NUM_ENVS]
                    next_p = obs_plain[:, write:write + NUM_ENVS]
                    if not torch.equal(obs[:, read:read + NUM_ENVS],
                                       obs_plain[:, read:read + NUM_ENVS]):
                        fail(f"{tag}: the read columns changed")
                    obs_in = obs_plain
                else:
                    read, before = 0, obs.clone()
                    out_k = fused_tick.full_tick_fused(
                        step_key, tstate, obs, chain, eps, do_reset, cp)
                    out_p = fused_tick.full_tick_plain(
                        step_key, tstate, obs, chain, eps, do_reset, cp,
                        actions_override=out_k[3])
                    torch.cuda.synchronize()
                    next_k, next_p, obs_in = out_k[4], out_p[4], obs
                    if not torch.equal(obs, before):
                        fail(f"{tag}: obs_t was written")
                check_state(tag, out_k[0] + out_k[1:3], out_p[0] + out_p[1:3],
                            env_fields)
                err = max(err, check_obs(tag, next_k, next_p))
                ties += check_actions(tag, cp, chain, step_key, out_k[3],
                                      obs_in, read, eps)
                tstate = out_k[0]
                if launch == "full":
                    obs = out_k[4]
            chain_err[(case, launch)] = err
            log(f"{case} {'B1' if launch == 'ring' else 'B3'} == plain "
                f"({cp.wrapper} grid {cp.grid_size}, chain "
                f"{fused_tick.chain_widths(chain)}, variant "
                f"{variant[launch == 'ring']}): {CHAIN_TICKS} ticks (reset "
                f"at 1) at {NUM_ENVS} envs; env bitwise, charge max err "
                f"{err:.3e}; near-tie envs {ties}")
    for case in ("global_dense", "global16_dense"):
        cp = chain_cases[case][0]
        tstate, _ = fresh_chain_env(cp, 4)
        key, err = rng.PRNGKey(5), 0.0
        for t in range(CHAIN_TICKS):
            tag = f"B4 {case} tick {t}"
            key, act_key, step_key = rng.split(key, 3)
            actions = rng.randint(act_key.to(device), (DRONES, NUM_ENVS), 0,
                                  5)
            out_k = fused_tick.tick_fused(step_key, tstate, actions, cp)
            out_p = fused_tick.tick_plain(step_key, tstate, actions, cp)
            torch.cuda.synchronize()
            check_state(tag, out_k[0] + out_k[1:3], out_p[0] + out_p[1:3],
                        env_fields)
            err = max(err, check_obs(tag, out_k[3], out_p[3]))
            tstate = out_k[0]
        chain_err[(case, "tick")] = err
        log(f"B4 == plain: {case} (global grid {cp.grid_size}), "
            f"{CHAIN_TICKS} ticks of random actions at {NUM_ENVS} envs; env "
            f"bitwise, charge max err {err:.3e}")

    # --- 3i. collect_drones > 1 and the fast-RNG round counts: B1, B3, B4 ---
    def stacked_env(cp, k, seed):
        """Fresh envs and the first k drones' observations (k · obs_dim, E)
        f32, drone-major."""
        state = core.reset_batch(rng.PRNGKey(seed).to(device), cp, NUM_ENVS)
        return fused_tick.to_tstate(state), core.observe_batch(
            state, cp, k).reshape(NUM_ENVS, -1).t().contiguous()

    # (view, k, mode, net, launch) -> the charge channel's largest error;
    # launch is "ring" (B1, on a bf16 ring and on an f32 one), "full" (B3)
    # or "tick" (B4, net None).
    collect_err = {}
    for view, k, mode in CASES_3I:
        cp, rounds = collect_params[view], ROUND_MODES[mode]
        kw = dict(collect=k, rng_rounds=rounds[0],
                  actor_rng_rounds=rounds[1])
        for hidden in NETS:
            _, ag = make_agent(hidden, 1, cp)
            chain = ag.params.flat()
            eps = torch.tensor(0.5, device=device)
            for launch in ("ring bf16", "ring f32", "full"):
                tstate, obs = stacked_env(cp, k, 2)
                if launch != "full":
                    ring = torch.zeros(
                        (obs.shape[0], 2 * NUM_ENVS), device=device,
                        dtype=torch.bfloat16 if launch == "ring bf16"
                        else torch.float32)
                    ring[:, :NUM_ENVS] = obs.to(ring.dtype)
                key, err, ties = rng.PRNGKey(3), 0.0, 0
                for t in range(COMPARE_TICKS):
                    tag = f"3i {view} k={k} {mode} {hidden} {launch} t{t}"
                    key, step_key = rng.split(key, 2)
                    do_reset = t == COMPARE_RESET_TICK
                    if launch != "full":
                        read = (t % 2) * NUM_ENVS
                        write = ((t + 1) % 2) * NUM_ENVS
                        ring_plain = ring.clone()
                        out_k = fused_tick.full_tick_fused_ring(
                            step_key, tstate, ring, read, write, chain,
                            eps, do_reset, cp, **kw)
                        out_p = fused_tick.full_tick_ring_plain(
                            step_key, tstate, ring_plain, read, write,
                            chain, eps, do_reset, cp,
                            actions_override=out_k[3], **kw)
                        torch.cuda.synchronize()
                        next_k = ring[:, write:write + NUM_ENVS]
                        next_p = ring_plain[:, write:write + NUM_ENVS]
                        if not torch.equal(
                                ring[:, read:read + NUM_ENVS],
                                ring_plain[:, read:read + NUM_ENVS]):
                            fail(f"{tag}: the read columns changed")
                        obs_in = ring_plain
                    else:
                        read, before = 0, obs.clone()
                        out_k = fused_tick.full_tick_fused(
                            step_key, tstate, obs, chain, eps, do_reset,
                            cp, **kw)
                        out_p = fused_tick.full_tick_plain(
                            step_key, tstate, obs, chain, eps, do_reset,
                            cp, actions_override=out_k[3], **kw)
                        torch.cuda.synchronize()
                        next_k, next_p, obs_in = out_k[4], out_p[4], obs
                        if not torch.equal(obs, before):
                            fail(f"{tag}: obs_t was written")
                    if next_k.shape[0] != k * fused_tick.obs_rows(cp):
                        fail(f"{tag}: {next_k.shape[0]} observation rows")
                    check_state(tag, out_k[0] + out_k[1:3],
                                out_p[0] + out_p[1:3], env_fields)
                    # Every one of the k row groups.
                    err = max(err, check_obs(tag, next_k, next_p))
                    ties += check_actions(tag, cp, chain, step_key,
                                          out_k[3], obs_in, read, eps,
                                          rounds)
                    tstate = out_k[0]
                    if launch == "full":
                        obs = out_k[4]
                name = "ring" if launch != "full" else "full"
                collect_err[(view, k, mode, hidden, name)] = max(
                    err, collect_err.get((view, k, mode, hidden, name),
                                         0.0))
                log(f"3i {'B1' if name == 'ring' else 'B3'} == plain: "
                    f"{view} k={k} --fast_rng {mode} {rounds} net "
                    f"{hidden} {launch}: {COMPARE_TICKS} ticks (reset at "
                    f"{COMPARE_RESET_TICK}) at {NUM_ENVS} envs; env "
                    f"bitwise, {k} row groups, charge max err "
                    f"{err:.3e}; near-tie envs {ties}")
        if mode == "actor":
            continue  # B4 has no actor: its build at "off"'s 20 rounds
        tstate, _ = stacked_env(cp, k, 4)
        key, err = rng.PRNGKey(5), 0.0
        for t in range(COMPARE_TICKS):
            tag = f"3i B4 {view} k={k} {mode} t{t}"
            key, act_key, step_key = rng.split(key, 3)
            actions = rng.randint(act_key.to(device),
                                  (DRONES, NUM_ENVS), 0, 5)
            out_k = fused_tick.tick_fused(step_key, tstate, actions, cp,
                                          k, rounds[0])
            out_p = fused_tick.tick_plain(step_key, tstate, actions, cp,
                                          k, rounds[0])
            torch.cuda.synchronize()
            check_state(tag, out_k[0] + out_k[1:3],
                        out_p[0] + out_p[1:3], env_fields)
            err = max(err, check_obs(tag, out_k[3], out_p[3]))
            tstate = out_k[0]
        collect_err[(view, k, mode, None, "tick")] = err
        log(f"3i B4 == plain: {view} k={k} rng_rounds {rounds[0]}: "
            f"{COMPARE_TICKS} ticks of random actions at {NUM_ENVS} "
            f"envs; env bitwise, {k} row groups, charge max err "
            f"{err:.3e}")

    # 3i's timings: every new build over BLOCK_LAUNCHES launches of a
    # prebuilt block (every env greedy), beside the k = 1, 20-round build
    # of the same view and net on the same state.
    collect_timing = {}
    states = {view: stacked_env(collect_params[view], COLLECT, 6)
              for view, _ in COLLECT_CASES}
    bases = {}
    for view, k, mode in CASES_3I:
        cp = collect_params[view]
        tstate, obs = states[view]
        for hidden in NETS + (None,):
            if hidden is None and mode == "actor":
                continue  # B4's build at "actor" is "off"'s
            chain = None if hidden is None else make_agent(
                hidden, 1, cp)[1].params.flat()
            for part in ("ring", "full") if hidden else ("tick",):
                if (view, hidden, part) not in bases:
                    bases[(view, hidden, part)] = time_collect_kernel(
                        torch, _build, fused_tick, rng, cp, chain, 1,
                        ROUND_MODES["off"], part, tstate, obs, card)["ms"]
                timing = time_collect_kernel(
                    torch, _build, fused_tick, rng, cp, chain, k,
                    ROUND_MODES[mode], part, tstate, obs, card)
                collect_timing[(view, k, mode, hidden, part)] = timing
                base = bases[(view, hidden, part)]
                log(f"3i {part} {view} k={k} {mode} net {hidden}: "
                    f"{timing['ms']:.4f} ms/launch against {base:.4f} for "
                    f"k=1 at 20 rounds (same call, same state), "
                    f"{timing['ms'] / base:.3f}x")

    # --- 4. the main path, and 4b. the in_kernel_td main path --------------
    def run_ticks(tag, tick, carry, chunk=None):
        """Warm-up and timed repeats of a trainer's tick (or with
        ``chunk``, a repeat's ticks as one chunk) with every launch count
        zeroed just before: returns (carry, losses, median tick seconds,
        repeats, ticks, launch counts, rewards, ε)."""

        def run(carry, n):
            if chunk is not None:
                carry, (rewards, eps, loss) = chunk(carry, n)
                return carry, rewards[-1], eps[-1], list(loss)
            out = []
            for _ in range(n):
                carry, (rewards, eps, loss) = tick(carry)
                out.append(loss)
            return carry, rewards, eps, out

        zero_counts()
        seconds = []
        carry, rewards, eps, losses = run(carry, WARMUP_TICKS)
        torch.cuda.synchronize()
        for _ in range(REPEATS):
            # A capture in a repeat (a signature first met there, such as
            # a later reset) is set-up: out of the time.
            t0, c0 = time.perf_counter(), chunk.capture_s if chunk else 0.0
            carry, rewards, eps, more = run(carry, TICKS_PER_REPEAT)
            losses += more
            torch.cuda.synchronize()
            captures = chunk.capture_s - c0 if chunk else 0.0
            seconds.append(time.perf_counter() - t0 - captures)
        ticks = WARMUP_TICKS + REPEATS * TICKS_PER_REPEAT
        if carry[-1] != ticks:
            fail(f"{tag}: step counter {carry[-1]} != {ticks}")
        losses = torch.stack(losses)
        if not bool(torch.isfinite(losses).all()):
            fail(f"{tag}: a loss is not finite")
        if not bool(torch.isfinite(rewards).all()):
            fail(f"{tag}: non-finite rewards")
        if not float(eps) < 1.0:
            fail(f"{tag}: epsilon did not decay")
        return (carry, losses, statistics.median(seconds) / TICKS_PER_REPEAT,
                seconds, ticks, counts(), rewards, eps)

    def drive(hidden, in_kernel_td):
        """Run the trainer's main path, the ring engine's chunk (one CUDA
        graph replay a tick; the warm-up chunk captures the graphs):
        returns (agent, carry, losses, median tick seconds, ticks, launch
        counts)."""
        agent, _ = make_agent(hidden, 0)
        chunk = train.build_chunk_ring(agent, params, NUM_ENVS, CAPACITY,
                                       BATCH, RESET_EVERY,
                                       in_kernel_td=in_kernel_td)
        carry = init_ring_carry(agent, params, NUM_ENVS, CAPACITY,
                                rng.PRNGKey(0), obs_dtype=torch.bfloat16,
                                batch_size=BATCH, in_kernel_td=in_kernel_td)
        fused_tick.prepare_kernel(params, carry[3].params.flat(),
                                  in_kernel_td=in_kernel_td)
        torch.cuda.synchronize()

        p0 = [p.detach().clone() for p in carry[3].params.flat()]
        tag = f"net {hidden}" + (" in_kernel_td" if in_kernel_td else "")
        carry, losses, tick_s, seconds, ticks, n, rewards, eps = run_ticks(
            tag, None, carry, chunk)
        drawn = draw_counts()
        launches = (n["full_tick_ring"], n["td_adam"])
        trained = int((losses >= 0).sum())
        want = want_launches(train, n, "full_tick_ring", ticks,
                             chunk.tick.learner, trained)
        if (chunk.tick.learner not in (train.KERNEL, train.IN_KERNEL_TD)
                or n != want):
            fail(f"{tag}: learner {chunk.tick.learner}, launches {n} in "
                 f"{ticks} ticks, {trained} trained (want {want})")
        if drawn["ring_sample"] != ticks:
            fail(f"{tag}: {drawn['ring_sample']} ring sample launches in "
                 f"{ticks} ticks")
        path_draws[tag] = drawn
        if all(torch.equal(a, b) for a, b in zip(p0, carry[3].params.flat())):
            fail(f"{tag}: the params did not move")
        log(f"main path {tag}: {ticks} ticks as chunks ({chunk.graphs} "
            f"graphs captured in {chunk.capture_s:.2f} s), learner "
            f"{chunk.tick.learner}, launches (B1, B2) {launches} "
            f"({trained} trained ticks), draws {drawn}, loss "
            f"{float(losses[-1]):.5f}, eps "
            f"{float(eps):.4f}, "
            f"obs/s {NUM_ENVS / tick_s:.1f} (median of {REPEATS} x "
            f"{TICKS_PER_REPEAT} ticks; tick {1e3 * tick_s:.4f} ms; "
            f"repeats {[round(s, 4) for s in seconds]} s) on {card}")
        return agent, carry, losses, tick_s, ticks, launches

    def drive_stream(hidden, engine):
        """Run a StreamReplay engine ("full": B3, "fused": B4) at the bench
        configuration with a replay of STREAM_CAPACITY slots, as the CLI
        runs it: its chunk (one CUDA graph replay a tick). Returns (agent,
        carry, median tick seconds, its kernel's launches)."""
        agent, _ = make_agent(hidden, 0)
        buf = replay.StreamReplay(STREAM_CAPACITY, BATCH, stride=NUM_ENVS)
        build = {"full": train.build_train_step_full,
                 "fused": train.build_train_step_fused}[engine]
        chunk = train.Chunk(build(agent, buf, params, NUM_ENVS,
                                  RESET_EVERY))
        carry = train.init_stream_carry(agent, params, NUM_ENVS, buf,
                                        rng.PRNGKey(0))
        fused_tick.prepare_kernel(
            params, carry[3].params.flat() if engine == "full" else None,
            env_tick=engine == "fused")
        torch.cuda.synchronize()
        p0 = [p.detach().clone() for p in carry[3].params.flat()]
        tag = f"{engine} engine net {hidden}"
        carry, losses, tick_s, seconds, ticks, n, rewards, eps = run_ticks(
            tag, None, carry, chunk)
        kernel = {"full": "full_tick", "fused": "tick"}[engine]
        # Each of the full engine's B3 launches pushes; the fused engine's
        # B4 leaves its push to push_many.
        pushes = fused_tick.full_tick_fused.pushes
        if pushes != (n["full_tick"] if engine == "full" else 0):
            fail(f"{tag}: {pushes} B3 pushes, {n['full_tick']} B3 launches")
        if chunk.tick.learner != train.KERNEL or n != want_launches(
                train, n, kernel, ticks, chunk.tick.learner,
                int((losses >= 0).sum())):
            fail(f"{tag}: learner {chunk.tick.learner}, launches {n} in "
                 f"{ticks} ticks")
        learned[(hidden, engine)] = n["td_adam"]
        drawn = path_draws[tag] = draw_counts()
        # The fused engine draws its opponents and its ε-greedy actions
        # every tick (the full engine's sample draws in its own kernel).
        if ((engine == "fused" and drawn["draw"] == 0)
                or drawn["ring_sample"] != 0
                or drawn["stream_sample"] != int((losses >= 0).sum())):
            fail(f"{tag}: draws {drawn} in {ticks} ticks")
        if float(losses[0]) != -1.0 or bool((losses[1:] < 0).any()):
            fail(f"{tag}: tick 0 trained or a later tick did not")
        if all(torch.equal(a, b) for a, b in zip(p0, carry[3].params.flat())):
            fail(f"{tag}: the params did not move")
        bstate = carry[4]
        if (bstate.size, bstate.cursor) != (
                STREAM_CAPACITY, ticks * NUM_ENVS % STREAM_CAPACITY):
            fail(f"{tag}: replay size {bstate.size}, cursor "
                 f"{bstate.cursor} after {ticks} pushes")
        log(f"{tag}: {ticks} ticks as chunks ({chunk.graphs} graphs "
            f"captured in {chunk.capture_s:.2f} s), learner "
            f"{chunk.tick.learner}, launches {n}, B3 pushes {pushes}, "
            f"draws {drawn}, loss "
            f"{float(losses[-1]):.5f}, eps {float(eps):.4f}, obs/s "
            f"{NUM_ENVS / tick_s:.1f} (median of {REPEATS} x "
            f"{TICKS_PER_REPEAT} ticks; tick {1e3 * tick_s:.4f} ms; repeats "
            f"{[round(s, 4) for s in seconds]} s; replay "
            f"{STREAM_CAPACITY} slots) on {card}")
        return agent, carry, tick_s, n[kernel]

    kernels, learners, obs_per_s, path_draws = [], [], {}, {}
    learned = {}  # (net, path) -> the learner kernel's launches
    for hidden in NETS:
        agent, carry, losses, tick_s, ticks, launches = drive(hidden, False)
        obs_per_s[hidden] = NUM_ENVS / tick_s
        learned[(hidden, "default")] = launches[1]
        if bool((losses < 0).any()):
            fail(f"net {hidden}: a tick did not train")
        ms, plain_ms, bound_ms, bound_by = time_kernel(
            torch, _build, fused_tick, rng, agent, carry, hidden, card)
        kernels.append({
            "name": "full_tick_ring_" + "x".join(str(h) for h in hidden),
            "route": "cuda",
            "source": "dronerl_tpu_torch/ops/csrc/full_tick.cu",
            "replaces": "dronerl_tpu/ops/fused_tick.py:757 (_full_kernel)",
            "launches": launches[0],
            "max_abs_err": max_err[hidden],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })

    for hidden in NETS:
        agent, carry, losses, tick_s, ticks, launches = drive(hidden, True)
        tag = f"net {hidden} in_kernel_td"
        if launches[1] != ticks:
            fail(f"{tag}: {launches[1]} learner launches in {ticks} ticks")
        if float(losses[0]) != -1.0 or bool((losses[1:] < 0).any()):
            fail(f"{tag}: tick 0 trained or a later tick did not")
        if carry[3].opt_state.count != ticks - 1:
            fail(f"{tag}: Adam count {carry[3].opt_state.count} != "
                 f"{ticks - 1}")
        log(f"obs/s {tag} {NUM_ENVS / tick_s:.1f} vs the default path "
            f"{obs_per_s[hidden]:.1f} (one run, {card})")
        timing = time_learner(torch, learner_kernel, agent, carry,
                              make_batch(300), card)
        learners.append({
            "name": "td_adam_" + "x".join(str(h) for h in hidden),
            "route": "cuda",
            "source": "dronerl_tpu_torch/ops/csrc/td_adam.cu",
            "replaces": ("dronerl_tpu/ops/fused_tick.py:893 (_full_kernel "
                         "TD branch); dronerl_tpu/ops/learner_kernel.py:44 "
                         "(_learner_kernel); on the default path the "
                         "learner XLA fuses, dronerl_tpu/train.py:533-541"),
            "launches": learned[(hidden, "default")] + launches[1],
            "launches_4_default": learned[(hidden, "default")],
            "launches_4b_in_kernel_td": launches[1],
            "max_abs_err": learner_err[hidden],
            **timing,
            "library_ms": None,
        })

    # --- 4c. the full engine, 4d. the fused engine ---------------------------
    stream = []
    for hidden in NETS:
        name = "x".join(str(h) for h in hidden)
        agent, carry, tick_s, launches = drive_stream(hidden, "full")
        log(f"obs/s full engine net {hidden} {NUM_ENVS / tick_s:.1f} vs the "
            f"ring engine {obs_per_s[hidden]:.1f} (one run, {card})")
        timing = time_obs_kernel(torch, _build, fused_tick, rng, agent,
                                 carry, hidden, card)
        stream.append({
            "name": "full_tick_" + name,
            "route": "cuda",
            "source": "dronerl_tpu_torch/ops/csrc/full_tick.cu",
            "replaces": ("dronerl_tpu/ops/fused_tick.py:1145 (_full_kernel "
                         "via full_tick_fused)"),
            "launches": launches,
            "max_abs_err": full_err[hidden],
            **timing,
            "library_ms": None,
        })
    fused_launches = 0
    for hidden in NETS:
        _, carry, tick_s, launches = drive_stream(hidden, "fused")
        fused_launches += launches
        log(f"obs/s fused engine net {hidden} {NUM_ENVS / tick_s:.1f} vs "
            f"the ring engine {obs_per_s[hidden]:.1f} (one run, {card})")
    timing = time_env_tick(torch, _build, fused_tick, rng, carry[1], params,
                           card)
    for board in TICK_BOARDS[1:]:
        bp = boards[board]
        time_env_tick(torch, _build, fused_tick, rng, fused_tick.to_tstate(
            core.reset_batch(rng.PRNGKey(10).to(device), bp, NUM_ENVS)), bp,
            card)
    for entry, hidden in zip(learners, NETS):
        entry.update(launches_4c_full_engine=learned[(hidden, "full")],
                     launches_4d_fused_engine=learned[(hidden, "fused")])
    stream.append({
        "name": "tick",
        "route": "cuda",
        "source": "dronerl_tpu_torch/ops/csrc/env_kernel.cu",
        "replaces": ("dronerl_tpu/ops/fused_tick.py:704 (_tick_kernel via "
                     "tick_fused)"),
        "launches": fused_launches,
        "max_abs_err": tick_err,
        **timing,
        "library_ms": None,
    })
    for board in STEP_BOARDS:
        bp = boards[board]
        timing = time_step(torch, _build, step_kernel, core, rng, bp, card)
        if board == (GRID, DRONES):
            stream.append({
                "name": "step",
                "route": "cuda",
                "source": "dronerl_tpu_torch/ops/csrc/env_kernel.cu",
                "replaces": ("dronerl_tpu/ops/step_kernel.py:186 "
                             "(_step_kernel via step_batch_fused)"),
                "launches": step_launches["step"],
                "max_abs_err": step_err,
                **timing,
                "library_ms": None,
            })

    # --- 4e. the CLI chooses the full engine past the ring gate --------------
    zero_counts()
    metrics = cli(["--num_envs", str(CLI_ENVS), "--num_steps",
                          str(CLI_STEPS)])
    n = counts()
    if metrics["engine"] != "full":
        fail(f"CLI at {CLI_ENVS} envs chose the {metrics['engine']} engine")
    if metrics["learner"] != train.KERNEL or n != want_launches(
            train, n, "full_tick", CLI_STEPS, metrics["learner"],
            metrics["trained_ticks"]):
        fail(f"CLI: learner {metrics['learner']}, launches {n} in "
             f"{CLI_STEPS} steps, {metrics['trained_ticks']} trained")
    if metrics["td_loss_mean"] is None or not math.isfinite(
            metrics["td_loss_mean"]):
        fail(f"CLI: td loss {metrics['td_loss_mean']}")
    slots = math.ceil(100_000 / CLI_ENVS) * CLI_ENVS
    log(f"CLI --num_envs {CLI_ENVS} (memory 100000 -> {slots} slots): "
        f"engine {metrics['engine']}, learner {metrics['learner']}, "
        f"launches {n}, obs/s "
        f"{metrics['obs_per_sec']:.1f} over {CLI_STEPS} steps (with "
        f"warm-up), on {metrics['device']}")

    # --- 4f. the CLI's jnp engine below 128 envs ----------------------------
    zero_counts()
    metrics = cli(["--num_envs", str(JNP_ENVS), "--num_steps",
                          str(JNP_STEPS)])
    n, jnp_draws = counts(), draw_counts()
    if metrics["engine"] != "jnp":
        fail(f"CLI at {JNP_ENVS} envs chose the {metrics['engine']} engine")
    if (metrics["learner"] != train.KERNEL
            or metrics["env_step"] != train.KERNEL
            or n != want_launches(train, n, "step", JNP_STEPS,
                                  metrics["learner"],
                                  metrics["trained_ticks"])
            or jnp_draws["buffer_sample"] != metrics["trained_ticks"]):
        fail(f"jnp engine: learner {metrics['learner']}, env step "
             f"{metrics['env_step']}, kernel launches {n}, draws "
             f"{jnp_draws}, {metrics['trained_ticks']} trained ticks")
    step_observe["launches"] = n["step"]
    jnp_sampled = jnp_draws["buffer_sample"]
    if metrics["td_loss_mean"] is None or not math.isfinite(
            metrics["td_loss_mean"]):
        fail(f"jnp engine: td loss {metrics['td_loss_mean']}")
    if not metrics["epsilon"] < 1.0:
        fail("jnp engine: epsilon did not decay")
    agent, _ = make_agent(NETS[0], 0)
    buf = replay.ReplayBuffer(math.ceil(100_000 / JNP_ENVS) * JNP_ENVS,
                              BATCH, uniform_pushes=True)
    tick = train.build_train_step(agent, buf, params, JNP_ENVS, RESET_EVERY)
    carry = train.init_jnp_carry(agent, params, JNP_ENVS, buf,
                                 rng.PRNGKey(0))
    p0 = [p.detach().clone() for p in carry[3].params.flat()]
    losses = []
    zero_counts()
    for _ in range(JNP_STEPS):
        carry, (_, _, loss) = tick(carry)
        losses.append(loss)
    losses = torch.stack(losses)
    if counts()["step"] != JNP_STEPS or draw_counts()["buffer_sample"] != int(
            (losses >= 0).sum()):
        fail(f"jnp engine tick: launches {counts()}, draws {draw_counts()} "
             f"in {JNP_STEPS} ticks")
    if not bool(torch.isfinite(losses).all()) or bool((losses[1:] < 0).any()):
        fail(f"jnp engine tick: losses {losses.tolist()}")
    if all(torch.equal(a, b) for a, b in zip(p0, carry[3].params.flat())):
        fail("jnp engine tick: the params did not move")
    log(f"CLI --num_envs {JNP_ENVS}: engine {metrics['engine']}, learner "
        f"{metrics['learner']}, env step {metrics['env_step']}, kernel "
        f"launches {n}, buffer samples {jnp_sampled} "
        f"({metrics['trained_ticks']} trained ticks), loss "
        f"{metrics['td_loss_mean']:.5f}, eps "
        f"{metrics['epsilon']:.4f}, obs/s {metrics['obs_per_sec']:.1f} over "
        f"{JNP_STEPS} steps (with warm-up), on {metrics['device']}; its tick "
        f"driven {JNP_STEPS} times: params moved, losses finite")

    # --- 4g. the conv family and the global observation on the engines ----
    def drive_chain(case, engine):
        """CHAIN_DRIVE ticks of an engine at NUM_ENVS envs on a case, every
        launch count zeroed just before: the engine's kernel launches once a
        tick and no other kernel launches, losses finite, the params move,
        ε decays. Returns (carry, its kernel's launches, the actor chain
        after the run)."""
        cp, agent, _ = chain_cases[case]
        if engine == "fused" and agent.net_spec is not None:
            agent = DQN(dataclasses.replace(agent.config, conv_matmul=False),
                        cp, device=device)
        if engine == "ring":
            tick = build_train_step_ring(agent, cp, NUM_ENVS, CAPACITY,
                                         BATCH, RESET_EVERY)
            carry = init_ring_carry(agent, cp, NUM_ENVS, CAPACITY,
                                    rng.PRNGKey(0), obs_dtype=torch.bfloat16)
        else:
            buf = replay.StreamReplay(CHAIN_STREAM, BATCH, stride=NUM_ENVS)
            build = {"full": train.build_train_step_full,
                     "fused": train.build_train_step_fused}[engine]
            tick = build(agent, buf, cp, NUM_ENVS, RESET_EVERY)
            carry = train.init_stream_carry(agent, cp, NUM_ENVS, buf,
                                            rng.PRNGKey(0))
        fused_tick.prepare_kernel(
            cp, None if engine == "fused" else fused_tick.flatten_net_params(
                carry[3].params, agent.net_spec), env_tick=engine == "fused")
        torch.cuda.synchronize()
        p0 = [p.detach().clone() for p in carry[3].params.flat()]
        tag = f"{case} {engine} engine"
        losses = []
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(CHAIN_DRIVE):
            carry, (rewards, eps, loss) = tick(carry)
            losses.append(loss)
        torch.cuda.synchronize()
        tick_s = (time.perf_counter() - t0) / CHAIN_DRIVE
        n = counts()
        kernel = {"ring": "full_tick_ring", "full": "full_tick",
                  "fused": "tick"}[engine]
        losses = torch.stack(losses)
        if n != want_launches(train, n, kernel, CHAIN_DRIVE, tick.learner,
                              int((losses >= 0).sum())):
            fail(f"{tag}: learner {tick.learner}, launches {n} in "
                 f"{CHAIN_DRIVE} ticks")
        if not bool(torch.isfinite(losses).all()) or not bool(
                (losses >= 0).any()):
            fail(f"{tag}: losses {losses.tolist()}")
        if not bool(torch.isfinite(rewards).all()) or not float(eps) < 1.0:
            fail(f"{tag}: rewards not finite or epsilon did not decay")
        if all(torch.equal(a, b) for a, b in zip(p0, carry[3].params.flat())):
            fail(f"{tag}: the params did not move")
        log(f"{tag}: {CHAIN_DRIVE} ticks (a reset at tick 0), learner "
            f"{tick.learner}, launches {n}, "
            f"loss {float(losses[-1]):.5f}, eps {float(eps):.4f}, "
            f"{1e3 * tick_s:.3f} ms a tick with warm-up, on {card}")
        chain = None if engine == "fused" else fused_tick.flatten_net_params(
            carry[3].params, agent.net_spec)
        return carry, n[kernel], chain

    for case, engine in CHAIN_DRIVES:
        carry, launches, chain = drive_chain(case, engine)
        cp = chain_cases[case][0]
        if cp.wrapper == "global":
            replaces = ("dronerl_tpu/ops/fused_tick.py:{} ({}, with "
                        "_encode_obs_global :538)")
        else:
            replaces = "dronerl_tpu/ops/fused_tick.py:{} ({})"
        if engine == "fused":
            timing = time_env_tick(torch, _build, fused_tick, rng, carry[1],
                                   cp, card)
            stream.append({
                "name": f"tick_{case}_fused_engine",
                "route": "cuda",
                "source": "dronerl_tpu_torch/ops/csrc/env_kernel.cu",
                "replaces": replaces.format(704, "_tick_kernel via "
                                            "tick_fused"),
                "launches": launches,
                "max_abs_err": chain_err.get((case, "tick"), tick_err),
                **timing,
                "library_ms": None,
            })
            continue
        timing = time_chain_kernel(torch, _build, fused_tick, rng, cp, chain,
                                   carry, engine, card)
        stream.append({
            "name": f"full_tick{'_ring' if engine == 'ring' else ''}_{case}",
            "route": "cuda",
            "source": "dronerl_tpu_torch/ops/csrc/full_tick.cu",
            "replaces": replaces.format(
                757, "_full_kernel" if engine == "ring" else
                "_full_kernel via full_tick_fused"),
            "launches": launches,
            "max_abs_err": chain_err[(case, engine)],
            **timing,
            "library_ms": None,
        })

    # --- 4h. the CLI with conv nets and the global observation --------------
    zero_counts()
    metrics = cli(["--num_envs", str(CLI_ENVS), "--num_steps",
                          str(CLI_CONV_STEPS), "--network_type", "conv",
                          "--conv_matmul"])
    n = counts()
    if metrics["engine"] != "full":
        fail(f"CLI conv at {CLI_ENVS} envs chose {metrics['engine']}")
    if n != want_launches(train, n, "full_tick", CLI_CONV_STEPS,
                          metrics["learner"], metrics["trained_ticks"]):
        fail(f"CLI conv: learner {metrics['learner']}, launches {n} in "
             f"{CLI_CONV_STEPS} steps")
    if metrics["td_loss_mean"] is None or not math.isfinite(
            metrics["td_loss_mean"]):
        fail(f"CLI conv: td loss {metrics['td_loss_mean']}")
    log(f"CLI --network_type conv --conv_matmul --num_envs {CLI_ENVS}: "
        f"engine {metrics['engine']}, learner {metrics['learner']}, "
        f"launches {n}, loss "
        f"{metrics['td_loss_mean']:.5f}, obs/s {metrics['obs_per_sec']:.1f} "
        f"over {CLI_CONV_STEPS} steps (with warm-up), on {metrics['device']}")
    zero_counts()
    metrics = cli(["--num_envs", str(JNP_ENVS), "--num_steps",
                          str(CLI_CONV_STEPS), "--network_type", "conv",
                          "--wrapper", "global"])
    n = counts()
    if metrics["engine"] != "jnp" or n != want_launches(
            train, n, "step", CLI_CONV_STEPS, metrics["learner"],
            metrics["trained_ticks"]) or draw_counts()["buffer_sample"] != \
            metrics["trained_ticks"]:
        fail(f"CLI conv global at {JNP_ENVS} envs: engine "
             f"{metrics['engine']}, learner {metrics['learner']}, launches "
             f"{n}, draws {draw_counts()}")
    if metrics["td_loss_mean"] is None or not math.isfinite(
            metrics["td_loss_mean"]):
        fail(f"CLI conv global: td loss {metrics['td_loss_mean']}")
    log(f"CLI --network_type conv --wrapper global --num_envs {JNP_ENVS}: "
        f"engine {metrics['engine']}, learner {metrics['learner']}, kernel "
        f"launches {n}, loss "
        f"{metrics['td_loss_mean']:.5f}, obs/s {metrics['obs_per_sec']:.1f} "
        f"over {CLI_CONV_STEPS} steps, on {metrics['device']}")

    # --- 4i. collect_drones > 1 and --fast_rng on the engines ----------------
    def drive_collect(cp, hidden, engine, k, mode, in_kernel_td=False,
                      measure=False):
        """An engine at NUM_ENVS envs with ``collect_drones`` = k and
        --fast_rng ``mode``, every launch count zeroed just before: its
        kernel launches once a tick (with ``in_kernel_td`` the learner
        kernel too) and no other kernel launches, losses finite, the params
        move, ε decays, a StreamReplay takes E · k transitions a tick. With
        ``measure`` the warm-up and timed repeats of phase 4 (obs/s beside
        phase 4's), else COLLECT_DRIVE ticks. Returns its kernel's
        launches."""
        rr, ar = ROUND_MODES[mode]
        agent, _ = make_agent(hidden, 0, cp)
        if engine == "ring":
            tick = build_train_step_ring(
                agent, cp, NUM_ENVS, CAPACITY, BATCH, RESET_EVERY, k,
                in_kernel_td=in_kernel_td, rng_rounds=rr,
                actor_rng_rounds=ar)
            carry = init_ring_carry(
                agent, cp, NUM_ENVS, CAPACITY, rng.PRNGKey(0),
                obs_dtype=torch.bfloat16, batch_size=BATCH,
                in_kernel_td=in_kernel_td, collect_drones=k)
        else:
            buf = replay.StreamReplay(STREAM_CAPACITY, BATCH,
                                      stride=NUM_ENVS * k)
            if engine == "full":
                tick = train.build_train_step_full(
                    agent, buf, cp, NUM_ENVS, RESET_EVERY, k, rr, ar)
            else:
                tick = train.build_train_step_fused(
                    agent, buf, cp, NUM_ENVS, RESET_EVERY, k, rr)
                ar = None
            carry = train.init_stream_carry(agent, cp, NUM_ENVS, buf,
                                            rng.PRNGKey(0), k)
        fused_tick.prepare_kernel(
            cp, None if engine == "fused" else carry[3].params.flat(),
            in_kernel_td=in_kernel_td, env_tick=engine == "fused",
            collect=k, rng_rounds=rr, actor_rng_rounds=ar)
        torch.cuda.synchronize()
        p0 = [p.detach().clone() for p in carry[3].params.flat()]
        tag = (f"4i {engine} engine{' in_kernel_td' if in_kernel_td else ''}"
               f" {cp.wrapper} k={k} --fast_rng {mode} net {hidden}")
        if measure:
            carry, losses, tick_s, _, ticks, n, _, eps = run_ticks(
                tag, tick, carry)
        else:
            zero_counts()
            losses = []
            t0 = time.perf_counter()
            for _ in range(COLLECT_DRIVE):
                carry, (rewards, eps, loss) = tick(carry)
                losses.append(loss)
            torch.cuda.synchronize()
            tick_s = (time.perf_counter() - t0) / COLLECT_DRIVE
            ticks, n, losses = COLLECT_DRIVE, counts(), torch.stack(losses)
            if not bool(torch.isfinite(losses).all()) or not bool(
                    torch.isfinite(rewards).all()) or not float(eps) < 1.0:
                fail(f"{tag}: losses {losses.tolist()}, eps {float(eps)}")
        kernel = {"ring": "full_tick_ring", "full": "full_tick",
                  "fused": "tick"}[engine]
        if n != want_launches(train, n, kernel, ticks, tick.learner,
                              int((losses >= 0).sum())):
            fail(f"{tag}: learner {tick.learner}, launches {n} in {ticks} "
                 "ticks")
        if not bool((losses >= 0).any()):
            fail(f"{tag}: no tick trained")
        if all(torch.equal(a, b) for a, b in zip(p0, carry[3].params.flat())):
            fail(f"{tag}: the params did not move")
        if fused_tick.full_tick_fused.pushes != n["full_tick"]:
            fail(f"{tag}: {fused_tick.full_tick_fused.pushes} B3 pushes, "
                 f"{n['full_tick']} B3 launches")
        if engine != "ring":
            pushed = ticks * NUM_ENVS * k
            if (carry[4].size, carry[4].cursor) != (
                    min(pushed, STREAM_CAPACITY), pushed % STREAM_CAPACITY):
                fail(f"{tag}: replay size {carry[4].size}, cursor "
                     f"{carry[4].cursor} after {ticks} pushes")
        log(f"{tag}: {ticks} ticks, launches {n}, loss "
            f"{float(losses[-1]):.5f}, eps {float(eps):.4f}, obs/s "
            f"{NUM_ENVS / tick_s:.1f} ({NUM_ENVS * k / tick_s:.1f} "
            f"transitions/s; tick {1e3 * tick_s:.4f} ms"
            f"{'' if measure else ' with warm-up'}) vs phase 4's ring "
            f"engine {obs_per_s[hidden]:.1f} obs/s, on {card}")
        return n[kernel]

    collect_launches = {}  # (view, k, mode, net, part) -> launches

    def count(view, k, mode, hidden, engine, launches):
        key = ((view, k, mode, None, "tick") if engine == "fused" else
               (view, k, mode, hidden, engine))
        collect_launches[key] = collect_launches.get(key, 0) + launches

    window = collect_params["window"]
    for hidden in NETS:  # the main drives at --collect_drones 4, measured
        for engine, td in (("ring", False), ("ring", True), ("full", False),
                           ("fused", False)):
            count("window", COLLECT, "off", hidden, engine, drive_collect(
                window, hidden, engine, COLLECT, "off", td, measure=True))
        for engine, mode in FAST_RNG_DRIVES:  # --fast_rng at one drone
            count("window", 1, mode, hidden, engine, drive_collect(
                window, hidden, engine, 1, mode, measure=True))
    for key in collect_timing:  # every other build of 3i, driven once
        if key not in collect_launches:
            view, k, mode, hidden, part = key
            engine = {"ring": "ring", "full": "full", "tick": "fused"}[part]
            count(view, k, mode, hidden, engine, drive_collect(
                collect_params[view], hidden or NETS[0], engine, k, mode))
    for argv, engine in ((["--num_envs", str(CLI_ENVS), "--memory_size",
                           "1000000"], "full"),
                         (["--num_envs", str(JNP_ENVS)], "jnp")):
        zero_counts()
        metrics = cli(argv + ["--num_steps", str(CLI_STEPS),
                                     "--collect_drones", str(COLLECT)])
        n = counts()
        if metrics["engine"] != engine:
            fail(f"CLI --collect_drones {COLLECT} {argv}: engine "
                 f"{metrics['engine']}")
        if n != want_launches(train, n, "full_tick" if engine == "full"
                              else "step", CLI_STEPS, metrics["learner"],
                              metrics["trained_ticks"]):
            fail(f"CLI --collect_drones {COLLECT} {argv}: learner "
                 f"{metrics['learner']}, launches {n}")
        if metrics["td_loss_mean"] is None or not math.isfinite(
                metrics["td_loss_mean"]):
            fail(f"CLI --collect_drones {COLLECT}: td loss "
                 f"{metrics['td_loss_mean']}")
        if engine == "full":
            count("window", COLLECT, "off", NETS[0], "full", n["full_tick"])
        log(f"CLI --collect_drones {COLLECT} {' '.join(argv)}: engine "
            f"{metrics['engine']}, launches {n}, loss "
            f"{metrics['td_loss_mean']:.5f}, obs/s "
            f"{metrics['obs_per_sec']:.1f} over {CLI_STEPS} steps (with "
            f"warm-up), on {metrics['device']}")

    for key, timing in collect_timing.items():
        view, k, mode, hidden, part = key
        if collect_launches.get(key, 0) == 0:
            fail(f"4i: the build {key} was not driven")
        rounds = ROUND_MODES[mode] if part != "tick" else (
            ROUND_MODES[mode][0], None)
        what = {"ring": "757 (_full_kernel", "full": "1145 (_full_kernel "
                "via full_tick_fused", "tick": "704 (_tick_kernel via "
                "tick_fused"}[part]
        encoder = ("_encode_obs_global :538" if view == "global" else
                   "_encode_obs_window :580")
        net = "" if hidden is None else "_" + "x".join(map(str, hidden))
        prefix = {"ring": "full_tick_ring", "full": "full_tick",
                  "tick": "tick"}[part]
        stream.append({
            "name": f"{prefix}_{view}_k{k}_{mode}{net}",
            "route": "cuda",
            "source": ("dronerl_tpu_torch/ops/csrc/env_kernel.cu"
                       if part == "tick" else
                       "dronerl_tpu_torch/ops/csrc/full_tick.cu"),
            "replaces": (f"dronerl_tpu/ops/fused_tick.py:{what}, collect={k}"
                         f" with {encoder}, rng_rounds={rounds[0]}, "
                         f"actor_rng_rounds={rounds[1]}; threefry2x32 "
                         "dronerl_tpu/ops/step_kernel.py:75)"),
            "launches": collect_launches[key],
            "max_abs_err": collect_err[key],
            **timing,
            "library_ms": None,
        })

    # --- 5. the trainer's lifecycle: checkpoints, resume, evaluation -------
    lifecycle(torch, train, zero_counts, counts, card, obs_per_s, runs)

    # --- 6. multi-GPU training: the sharded engines, then the periphery -----
    sharded = multi_gpu(torch, train, zero_counts, counts, card, obs_per_s,
                        runs, {e["name"]: e
                               for e in kernels + stream + [step_observe]})

    # --- 7. the last entry points and locks ---------------------------------
    entry_points(torch, train, zero_counts, counts, card, runs, here,
                 kernels, device)

    # --- 8. the bench program and its companions ----------------------------
    bench_program(here, runs, device_kind, card, obs_per_s,
                  kernels + learners)

    # --- 9. the graphed ring chunk against the eager tick --------------------
    learned_9 = graphed_chunk(torch, train, zero_counts, counts, card,
                              obs_per_s, runs)

    # --- 10. the jnp, full and fused engines' chunks against their ticks ----
    chunks_10 = engine_chunks(torch, train, zero_counts, counts, card, runs)
    shutil.rmtree(runs, ignore_errors=True)
    for entry, hidden in zip(learners, NETS):  # the graphed chunks' B2
        entry["launches_9_chunk"] = learned_9[hidden]
        # Phase 10 runs the CLI's net, (16,16).
        entry["launches_10_chunk"] = sum(
            r["launches"]["td_adam"] for key, r in chunks_10.items()
            if key != "walk_s" and hidden == NETS[0])

    # B5 with the observation: the jnp engine's CLI run (4f) is its main
    # path's, beside phase 10's graphed jnp chunks.
    step_observe["launches_10_chunk"] = sum(
        r["launches"]["step"] for key, r in chunks_10.items()
        if key != "walk_s")
    if step_observe["launches"] == 0:
        fail("step_observe: launched no time on its main path")
    # The draws' main paths: the StreamReplay engines' chunks (4c, 4d) for
    # the draw kernel and their sample, the ring engine's (phase 4) for the
    # ring sample, the jnp engine's CLI run (4f) for the ReplayBuffer's.
    stream_tags = [tag for tag in path_draws
                   if tag.startswith(("full", "fused"))]
    main_path = {
        "draw": sum(path_draws[tag]["draw"] for tag in stream_tags),
        "ring_sample": sum(d["ring_sample"] for tag, d in path_draws.items()
                           if tag not in stream_tags),
        "stream_sample": sum(path_draws[tag]["stream_sample"]
                             for tag in stream_tags),
        "buffer_sample": jnp_sampled}
    for entry in draw_entries:
        entry["launches"] = main_path[entry["name"]]
        entry.update({f"launches_{phase}_chunk": seen[entry["name"]]
                      for phase, seen in GRAPHED_DRAWS.items()})
        if entry["launches"] == 0:
            fail(f"{entry['name']}: launched no time on its main path")
    print(json.dumps({"kernels": kernels + learners + stream
                      + [step_observe] + sharded + draw_entries}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}), flush=True)


def draw_phase(torch, card):
    """Phase 2b: the draw kernel (``draws.draw``) and the ring sample
    kernel (``draws.ring_sample``) against their plain versions on the
    card, bitwise: every mode at every round count on the main path's
    shapes (a lone key, E keys, a strided view of split children; randint
    with host bounds, a bound below minval and a device bound), and the
    ring sample at the bench's ring for one drone and four, bf16 and f32,
    keyed and from host offsets, the base slot wrapping. Then each timed
    over DRAW_LAUNCHES launches of a prebuilt block (DRAW_TIMED, the
    ring sample at 294 x 16), beside its plain version, its bound and an
    empty launch. Returns the kernel line's two entries but their
    launches."""
    from dronerl_tpu_torch import replay, rng
    from dronerl_tpu_torch.ops import _build, draws, fused_tick

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    err = dict.fromkeys(DRAW_NAMES, 0.0)

    def hold(name, tag, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"2b {tag}: {got.dtype} {tuple(got.shape)} against the "
                 f"plain {want.dtype} {tuple(want.shape)}")
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            fail(f"2b {tag}: the kernel differs from its plain version")
        err[name] = max(err[name], float(
            (got.double() - want.double()).abs().max()))

    key = rng.PRNGKey(7).to(device)
    keys = rng.split_plain(key, NUM_ENVS)
    children = rng.split_plain(keys[:6].reshape(2, 3, 2), 2)[..., 1, :]
    bound = torch.tensor(CAPACITY, dtype=torch.int32, device=device)
    cases = [("split", key, (NUM_ENVS + 2,)), ("split", keys, (2,)),
             ("split", children, (3,)), ("bits", key, (4096,)),
             ("uniform", key, (4, NUM_ENVS)), ("uniform", keys, (81,)),
             ("randint", key, (BATCH,), 0, CAPACITY),
             ("randint", key, (BATCH,), 0, bound),
             ("randint", key, (DRONES, NUM_ENVS), 0, 5),
             ("randint", keys[:9], (2, 3), 5, -4),
             ("randint", children, (7,), -(2 ** 31) + 1, 2 ** 31 - 1)]
    plain = {"split": lambda k, shape, r: rng.split_plain(k, shape[0], r),
             "bits": rng.random_bits_plain, "uniform": rng.uniform_plain}
    public = {"split": lambda k, shape, r: rng.split(k, shape[0], r),
              "bits": rng.random_bits, "uniform": rng.uniform}
    compared = 0
    for rounds in rng.ROUNDS:
        for mode, k, shape, *lohi in cases:
            tag = f"{mode} keys {tuple(k.shape)} shape {shape}{lohi or ''} " \
                  f"rounds {rounds}"
            before = draws.draw.launches
            if mode == "randint":
                got = rng.randint(k, shape, *lohi, rounds)
                want = rng.randint_plain(k, shape, *lohi, rounds)
            else:
                got = public[mode](k, shape, rounds)
                want = plain[mode](k, shape, rounds)
            if draws.draw.launches != before + 1:
                fail(f"2b {tag}: {draws.draw.launches - before} launches")
            hold("draw", tag, got, want)
            compared += 1
    torch.cuda.synchronize()
    log(f"2b draw kernel == plain, bitwise: {compared} draws ({len(cases)} "
        f"shapes x rounds {rng.ROUNDS}), one launch each; on {card}")

    capacity, nb = CAPACITY, CAPACITY // NUM_ENVS
    gen = torch.Generator().manual_seed(0)
    for k in (1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            rows = k * fused_tick.obs_rows(bench_params())
            ring = torch.randn((rows, capacity), generator=gen).to(device,
                                                                   dtype)
            shape = (capacity,) if k == 1 else (k, capacity)
            scalars = (torch.randint(0, 5, shape, generator=gen,
                                     dtype=torch.int32).to(device),
                       torch.randn(shape, generator=gen).to(device),
                       torch.randint(0, 2, shape, generator=gen,
                                     dtype=torch.int8).to(device))
            common = dict(num_envs=NUM_ENVS, capacity=capacity,
                          batch_size=BATCH * k, collect=k,
                          obs_dim=rows // k)
            for seed, valid, base in ((1, (nb - 1) * NUM_ENVS, 1),
                                      (2, 1, 0), (3, 0, 1)):
                want = fused_tick.ring_gather_batch_plain(
                    rng.PRNGKey(seed), ring, *scalars, valid, base, **common)
                before = draws.ring_sample.launches
                for where in ("device", "host"):
                    sample_key = rng.PRNGKey(seed)
                    if where == "device":
                        sample_key = sample_key.to(device)
                    got = fused_tick.ring_gather_batch(
                        sample_key, ring, *scalars, valid, base, **common)
                    for name in want:
                        hold("ring_sample", f"ring sample k {k} {dtype} "
                             f"seed {seed} {where} key {name}", got[name],
                             want[name])
                if draws.ring_sample.launches != before + 2:
                    fail("2b ring sample: not one launch a sample")
            del ring, scalars
    torch.cuda.synchronize()
    log(f"2b ring sample kernel == ring_gather_batch_plain, bitwise: k 1 and "
        f"4, bf16 and f32 rings of {capacity} columns, keyed and from host "
        f"offsets, 3 samples each (the base slot wrapping); on {card}")

    # The replays' modes: the StreamReplay of phase 10's full engine (5
    # env-batches of the bench's 294 rows) and the jnp engine's ReplayBuffer
    # at the CLI's 100,000 transitions, each cold, filling and wrapped.
    obs_dim = fused_tick.obs_rows(bench_params())
    stream_buf = replay.StreamReplay(SAMPLE_STREAM_BATCHES * NUM_ENVS, BATCH,
                                     NUM_ENVS)
    rows_buf = replay.ReplayBuffer(SAMPLE_ROWS, BATCH, uniform_pushes=True)
    stores = {"stream": replay_store(torch, gen, device, obs_dim,
                                     stream_buf.capacity, False),
              "rows": replay_store(torch, gen, device, obs_dim,
                                   rows_buf.capacity, True)}
    sampled = 0
    for seed, (cursor, size) in enumerate((
            (NUM_ENVS, NUM_ENVS), (3 * NUM_ENVS, 3 * NUM_ENVS),
            (2 * NUM_ENVS, stream_buf.capacity))):
        state = replay.ReplayState(stores["stream"], cursor, size)
        words = (max(size - NUM_ENVS, 1),  # a chunk row's bound and base
                 cursor if size == stream_buf.capacity else 0)
        skey = rng.PRNGKey(40 + seed)
        want = stream_buf.sample_batch_plain(skey, state)
        before = draws.stream_sample.launches
        for where, got in (
                ("device words", stream_buf.sample_batch(
                    skey.to(device), state, *(torch.tensor(
                        w, dtype=torch.int32, device=device)
                        for w in words))),
                ("host words", stream_buf.sample_batch(skey.to(device),
                                                       state)),
                ("host offsets", stream_buf.sample_batch(skey, state))):
            for name in want:
                hold("stream_sample", f"stream sample size {size} {where} "
                     f"{name}", got[name], want[name])
        if draws.stream_sample.launches != before + 3:
            fail("2b stream sample: not one launch a sample")
        sampled += 3
    for seed, size in enumerate((9, 3 * SAMPLE_ROWS // 5, SAMPLE_ROWS)):
        state = replay.ReplayState(stores["rows"], size % SAMPLE_ROWS, size)
        skey = rng.PRNGKey(50 + seed)
        for feature_major in (True, False):
            want = rows_buf.sample_batch_plain(skey, state,
                                               feature_major=feature_major)
            before = draws.buffer_sample.launches
            for where, got in (
                    ("device bound", rows_buf.sample_batch(
                        skey.to(device), state, torch.tensor(
                            size, dtype=torch.int32, device=device),
                        feature_major)),
                    ("host bound", rows_buf.sample_batch(
                        skey.to(device), state, None, feature_major)),
                    ("host offsets", rows_buf.sample_batch(
                        skey, state, None, feature_major))):
                for name in want:
                    hold("buffer_sample", f"buffer sample size {size} "
                         f"feature-major {feature_major} {where} {name}",
                         got[name], want[name])
            if draws.buffer_sample.launches != before + 3:
                fail("2b buffer sample: not one launch a sample")
            sampled += 3
    torch.cuda.synchronize()
    log(f"2b the replays' sample modes == sample_batch_plain, bitwise: "
        f"{sampled} samples of the StreamReplay ({stream_buf.capacity} "
        f"slots of {obs_dim} rows, stride {NUM_ENVS}) and the ReplayBuffer "
        f"({SAMPLE_ROWS} transitions, feature- and row-major), cold, filling "
        f"and wrapped, keyed with device words, host words and host "
        f"offsets; one launch a sample; on {card}")

    # Timings over prebuilt blocks, beside the plain versions, the bounds
    # and an empty launch of the draw kernel's block.
    lib = _build.load(_build.draw_config())
    stream = torch.cuda.current_stream().cuda_stream
    lib.draws_empty_launch.argtypes = [ctypes.c_void_p]
    lib.draws_empty_launch.restype = ctypes.c_int
    empty_ms = cuda_ms(torch, lambda: lib.draws_empty_launch(stream),
                       DRAW_LAUNCHES)
    timed = {}
    for mode, num_keys, count in DRAW_TIMED:
        k = key if num_keys == 1 else keys
        extra = dict(span=1, bound=bound) if mode == "randint" else {}
        block, _out, _operands = draws._draw_args(k, count, mode, **extra)
        ms = time_block(torch, lib, "draw_launch", block, DRAW_LAUNCHES)
        if mode == "randint":
            def plain_fn():
                return rng.randint_plain(key, (count,), 0, bound)
        else:
            def plain_fn(mode=mode, k=k, count=count):
                return plain[mode](k, (count,), 20)
        plain_ms = cuda_ms(torch, plain_fn, PLAIN_LAUNCHES)
        # A hash an output; randint two, plus the two split children that
        # every output of a key shares.
        outputs = num_keys * count
        hashes = (2 * num_keys + 2 * outputs if mode == "randint"
                  else outputs)
        out_bytes = outputs * {"split": 16, "bits": 8, "uniform": 4,
                               "randint": 4}[mode]
        bound_ms, bound_by = roofline(out_bytes + 16 * num_keys,
                                      hashes * hash_ops(20))
        tag = f"{mode} {num_keys} x {count}"
        timed[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        log(f"2b draw {tag}: {ms:.5f} ms/launch ({DRAW_LAUNCHES} launches "
            f"of one block), plain {plain_ms:.4f} ms; bound {bound_ms:.6f} "
            f"ms ({bound_by}: {out_bytes + 16 * num_keys} B, "
            f"{hashes * hash_ops(20)} operations); an empty launch "
            f"{empty_ms:.5f} ms; on {card}")

    obs_dim = fused_tick.obs_rows(bench_params())
    ring = torch.randn((obs_dim, capacity), generator=gen).to(
        device, torch.bfloat16)
    scalars = (torch.zeros(capacity, dtype=torch.int32, device=device),
               torch.zeros(capacity, device=device),
               torch.zeros(capacity, dtype=torch.int8, device=device))
    sample_key = rng.PRNGKey(5).to(device)
    block, _batch, _operands = draws._ring_sample_args(
        sample_key, ring, *scalars, (nb - 1) * NUM_ENVS, NUM_ENVS,
        num_envs=NUM_ENVS, capacity=capacity, batch_size=BATCH,
        obs_dim=obs_dim)
    sample_ms = time_block(torch, lib, "ring_sample_launch", block,
                           DRAW_LAUNCHES)
    sample_plain_ms = cuda_ms(torch, lambda: fused_tick.ring_gather_batch_plain(
        sample_key, ring, *scalars, (nb - 1) * NUM_ENVS, 1,
        num_envs=NUM_ENVS, capacity=capacity, batch_size=BATCH,
        obs_dim=obs_dim), PLAIN_LAUNCHES)
    values = 2 * obs_dim * BATCH
    sample_bytes = values * (2 + 4) + BATCH * (9 + 12) + 16
    sample_ops = (2 + 2 * BATCH) * hash_ops(20)    # randint's, one key
    sample_bound, sample_by = roofline(sample_bytes, sample_ops)
    log(f"2b ring sample {obs_dim} x {2 * BATCH} (bf16 ring, keyed): "
        f"{sample_ms:.5f} ms/launch ({DRAW_LAUNCHES} launches of one block), "
        f"plain {sample_plain_ms:.4f} ms; bound {sample_bound:.6f} ms "
        f"({sample_by}: {sample_bytes} B, {sample_ops} operations); an empty "
        f"launch {empty_ms:.5f} ms; on {card}")
    # The replays' modes at the same shapes, keyed, their words on the card.
    modes = {}
    for name, buf, store, extra, layout in (
            ("stream_sample", stream_buf, stores["stream"],
             dict(stride=NUM_ENVS), ()),
            ("buffer_sample", rows_buf, stores["rows"], dict(
                next_rows=stores["rows"]["next_obs"], rows_out=False),
             (True,))):  # feature-major, the learner kernel's batch
        state = replay.ReplayState(store, 0, buf.capacity)
        word = torch.tensor(buf.capacity - extra.get("stride", 0),
                            dtype=torch.int32, device=device)
        zero = torch.tensor(0, dtype=torch.int32, device=device)
        block, _batch, _operands = draws._replay_sample_args(
            sample_key, store["obs"], [store[n] for n in (
                "actions", "rewards", "dones")], word, zero,
            batch_size=BATCH, **extra)
        ms = time_block(torch, lib, "ring_sample_launch", block,
                        DRAW_LAUNCHES)
        plain_ms = cuda_ms(torch, lambda buf=buf, state=state, word=word,
                           layout=layout: buf.sample_batch_plain(
                               sample_key, state, word, *layout),
                           PLAIN_LAUNCHES)
        # 2B rows of obs_dim f32 read and written, the scalars (9 B) read
        # and written as f32 (12 B), the key and two words.
        values = 2 * obs_dim * BATCH
        mode_bytes = values * 8 + BATCH * (9 + 12) + 16 + 8
        mode_bound, mode_by = roofline(mode_bytes, sample_ops)
        modes[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": mode_bound,
                       "bound_by": mode_by}
        log(f"2b {name} {obs_dim} x {2 * BATCH} (f32, keyed, its words read "
            f"by pointer): {ms:.5f} ms/launch ({DRAW_LAUNCHES} launches of "
            f"one block), plain {plain_ms:.4f} ms; bound {mode_bound:.6f} ms "
            f"({mode_by}: {mode_bytes} B, {sample_ops} operations); an empty "
            f"launch {empty_ms:.5f} ms; on {card}")
    del stores
    log(f"phase 2b took {time.perf_counter() - t_phase:.1f} s on {card}")
    head = timed[f"randint 1 x {BATCH}"]
    return [{
        "name": "draw",
        "route": "cuda",
        "source": "dronerl_tpu_torch/ops/csrc/draws.cu",
        "replaces": ("no Pallas kernel: jax.random's threefry outside the "
                     "kernels, e.g. dronerl_tpu/ops/fused_tick.py:1485 "
                     "(jax.random.randint)"),
        "launches": 0,
        "max_abs_err": err["draw"],
        **head,
        "library_ms": None,
        "empty_ms": empty_ms,
        "cases": timed,
    }, {
        "name": "ring_sample",
        "route": "cuda",
        "source": "dronerl_tpu_torch/ops/csrc/draws.cu",
        "replaces": ("no Pallas kernel: ring_gather_batch's randint and "
                     "gathers, dronerl_tpu/ops/fused_tick.py:1470"),
        "launches": 0,
        "max_abs_err": err["ring_sample"],
        "ms": sample_ms,
        "plain_ms": sample_plain_ms,
        "bound_ms": sample_bound,
        "bound_by": sample_by,
        "library_ms": None,
        "empty_ms": empty_ms,
    }, {
        "name": "stream_sample",
        "route": "cuda",
        "source": "dronerl_tpu_torch/ops/csrc/draws.cu",
        "replaces": ("no Pallas kernel: StreamReplay.sample's randint and "
                     "gathers, dronerl_tpu/replay.py:258"),
        "launches": 0,
        "max_abs_err": err["stream_sample"],
        **modes["stream_sample"],
        "library_ms": None,
        "empty_ms": empty_ms,
    }, {
        "name": "buffer_sample",
        "route": "cuda",
        "source": "dronerl_tpu_torch/ops/csrc/draws.cu",
        "replaces": ("no Pallas kernel: the ReplayBuffer's sample, randint "
                     "and gathers, dronerl_tpu/replay.py:103 and :399"),
        "launches": 0,
        "max_abs_err": err["buffer_sample"],
        **modes["buffer_sample"],
        "library_ms": None,
        "empty_ms": empty_ms,
    }]


def replay_store(torch, gen, device, obs_dim, capacity, rows):
    """Random transitions on the card: obs (and next_obs) (capacity,
    obs_dim) rows or (obs_dim, capacity) columns, actions, rewards and
    dones (capacity,)."""
    shape = (capacity, obs_dim) if rows else (obs_dim, capacity)
    store = {"obs": torch.randn(shape, generator=gen).to(device),
             "actions": torch.randint(0, 5, (capacity,), generator=gen,
                                      dtype=torch.int32).to(device),
             "rewards": torch.randn((capacity,), generator=gen).to(device),
             "dones": (torch.rand((capacity,), generator=gen)
                       < 0.3).to(device)}
    if rows:
        store["next_obs"] = torch.randn(shape, generator=gen).to(device)
    return store


def bench_params():
    """The bench's env (grid 9, 4 drones, window radius 3)."""
    from dronerl_tpu_torch.env.types import EnvParams
    return EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)


def roofline(total_bytes, ops):
    """The least time in ms of moving ``total_bytes`` and doing ``ops``
    integer operations (at PEAK_F32, as every hash of the kernel line is
    priced), and which of the two bounds it."""
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def graphed_vs_eager(torch, train, zero_counts, counts, tag, chunk, fresh,
                     length, expect, state_path, device, trace=True):
    """``chunk`` (one CUDA graph replay a tick) against its eager tick
    (``chunk.tick``) from the carry ``fresh(0)``: CHUNKS chunks of
    ``length`` ticks each way, a train state saved after each chunk but
    the last and restored into ``fresh(1)``, every launch count zeroed
    just before each way and equal to ``expect`` just after; every carry
    tensor, the carry's numbers and the outputs (rewards, ε, loss)
    bitwise; finite losses, some trained, ε decayed. Then, with
    ``trace``, TRACE ticks of each way under ``torch.profiler`` for the
    device's busy share, launches a tick and longest kernels.
    Returns each way's stats (obs/s, host and wall ms a tick, device ms a
    tick, busy share, launches a tick, the four longest kernels) and the
    carry's numbers."""
    from dronerl_tpu_torch.interop import train_state_io
    from dronerl_tpu_torch.ops import draws
    from dronerl_tpu_torch.utils import profiling

    def eager_chunk(carry, n):
        outs = []
        for _ in range(n):
            carry, out = chunk.tick(carry)
            outs.append(out)
        return carry, tuple(torch.stack(o) for o in zip(*outs))

    carry = fresh(0)
    ticks = CHUNKS * length
    runs_out, stats = {}, {}
    for way, run in (("graphed", chunk), ("eager", eager_chunk)):
        c = copy.deepcopy(carry) if way == "graphed" else carry
        torch.cuda.synchronize()
        zero_counts()
        outs, host_s, wall_s = [], 0.0, 0.0
        for i in range(CHUNKS):
            # The captures are set-up: out of the times, reported apart.
            t0, c0 = time.perf_counter(), chunk.capture_s
            c, out = run(c, length)
            captures = chunk.capture_s - c0 if way == "graphed" else 0
            host_s += time.perf_counter() - t0 - captures
            torch.cuda.synchronize()
            wall_s += time.perf_counter() - t0 - captures
            outs.append(out)
            if i + 1 < CHUNKS:
                train_state_io.save(state_path, c)
                c = train_state_io.restore(state_path, fresh(1))
        n = counts()
        if n != expect:
            fail(f"{tag}: {way} launches {n}, want {expect}")
        runs_out[way] = (c, tuple(torch.cat(o) for o in zip(*outs)))
        num_envs = outs[0][0].shape[1]
        stats[way] = {"obs_per_s": num_envs * ticks / wall_s,
                      "host_ms": 1e3 * host_s / ticks,
                      "tick_ms": 1e3 * wall_s / ticks,
                      "draws": {name: getattr(draws, name).launches
                                for name in DRAW_NAMES}}
    seen = GRAPHED_DRAWS.setdefault(tag.split()[0],
                                    dict.fromkeys(DRAW_NAMES, 0))
    for name, n in stats["graphed"]["draws"].items():
        seen[name] += n
    (cg, og), (ce, oe) = runs_out["graphed"], runs_out["eager"]
    got, want = (train_state_io.leaves(x) for x in (cg, ce))
    if got[1] != want[1] or set(got[0]) != set(want[0]):
        fail(f"{tag}: the carries' numbers or paths differ: {got[1]} vs "
             f"{want[1]}")
    differ = [p for p, t in want[0].items() if not torch.equal(got[0][p], t)]
    differ += [name for name, a, b in zip(("rewards", "epsilon", "loss"),
                                          og, oe) if not torch.equal(a, b)]
    if differ:
        fail(f"{tag}: graphed and eager differ in {differ[:12]}")
    if (not bool(torch.isfinite(og[2]).all()) or not bool((og[2] >= 0).any())
            or float(og[1][-1]) >= 1.0):
        fail(f"{tag}: a loss is not finite, no tick trained or epsilon did "
             "not decay")
    for way, run, c in (("graphed", chunk, cg), ("eager", eager_chunk, ce)):
        if not trace:
            break
        c, prof = profiling.profiled_ticks(lambda x: run(x, TRACE), c, 1,
                                           device)
        kernels = profiling.device_kernels(prof, TRACE)
        device_ms = sum(k[1] for k in kernels)
        stats[way].update(device_ms=device_ms,
                          busy=device_ms / stats[way]["tick_ms"],
                          launches=sum(k[2] for k in kernels),
                          top=[(name[:40], round(ms, 4), calls)
                               for name, ms, calls in kernels[:4]])
    return stats, want[1]


def log_ways(tag, stats, chunk, ticks, expect, numbers, card, beside=""):
    def way(w):
        traced = (f", device {w['device_ms']:.4f} ms, busy {w['busy']:.4f}, "
                  f"{w['launches']:.1f} launches a tick, the longest "
                  f"(name, ms, calls a tick) {w['top']}"
                  if "busy" in w else ", not traced")
        drawn = ", ".join(f"{name} {n / ticks:.2f}"
                          for name, n in w["draws"].items())
        return (f"{w['obs_per_s']:.1f} obs/s, host {w['host_ms']:.4f} ms a "
                f"tick, tick {w['tick_ms']:.4f} ms{traced}, launches a tick "
                f"{drawn}")

    log(f"{tag}: {CHUNKS} x {ticks // CHUNKS} ticks with a train state saved "
        f"and restored between, graphed == eager bitwise (the carry's "
        f"tensors and numbers {numbers}; rewards, epsilon, loss); launches "
        f"{expect} each way; {chunk.graphs} graphs captured in "
        f"{chunk.capture_s:.3f} s; graphed {way(stats['graphed'])}; eager "
        f"{way(stats['eager'])}{beside}; on {card}")


def graphed_chunk(torch, train, zero_counts, counts, card, obs_per_s, runs,
                  device=None):
    """Phase 9: the ring engine's chunk on the card (one CUDA graph replay
    a tick) against the eager tick, for both nets on the default path and
    on ``in_kernel_td`` at the bench configuration: CHUNKS chunks of
    CHUNK_9_TICKS ticks, graphed and eager from the same carry
    (:func:`graphed_vs_eager`); B1 counted once a graphed tick, B2 once
    a trained one on the default path (the learner kernel on the same
    tick's batch) and once a tick on ``in_kernel_td``. Returns B2's
    launches a way by net."""
    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
    from dronerl_tpu_torch.env.types import EnvParams

    t_phase = time.perf_counter()
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    state_path = os.path.join(runs, "chunk9.safetensors")
    os.makedirs(runs, exist_ok=True)
    device = device or torch.device("cuda", 0)
    ticks = CHUNKS * CHUNK_9_TICKS
    learned = dict.fromkeys(NETS, 0)  # B2's launches a way
    for hidden in NETS:
        for td in (False, True):
            tag = f"9 net {hidden}" + (" in_kernel_td" if td else "")
            agent = DQN(DQNConfig(hidden_layers=hidden,
                                  epsilon_decay_every=5,
                                  target_update_interval=10, gamma=0.9),
                        params, device=device)

            def fresh(seed):
                return train.init_ring_carry(
                    agent, params, NUM_ENVS, CAPACITY, rng.PRNGKey(seed),
                    obs_dtype=torch.bfloat16, batch_size=BATCH,
                    in_kernel_td=td)

            chunk = train.build_chunk_ring(agent, params, NUM_ENVS,
                                           CAPACITY, BATCH, RESET_EVERY,
                                           in_kernel_td=td)
            if chunk.tick.learner != (train.IN_KERNEL_TD if td
                                      else train.KERNEL):
                fail(f"{tag}: learner {chunk.tick.learner}")
            trained = sum(chunk.tick.signature(step).trains
                          for step in range(ticks))
            expect = want_launches(train, counts(), "full_tick_ring", ticks,
                                   chunk.tick.learner, trained)
            learned[hidden] += expect["td_adam"]
            stats, numbers = graphed_vs_eager(
                torch, train, zero_counts, counts, tag, chunk, fresh,
                CHUNK_9_TICKS, expect, state_path, device)
            if any(stats[w]["draws"]["ring_sample"] != ticks for w in stats):
                fail(f"{tag}: ring sample launches "
                     f"{[stats[w]['draws'] for w in stats]} in {ticks} "
                     "ticks each way")
            log_ways(tag, stats, chunk, ticks, expect, numbers, card,
                     f"; phase 4's default path {obs_per_s[hidden]:.1f} "
                     "obs/s")
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return learned


def engine_chunks(torch, train, zero_counts, counts, card, runs, device=None):
    """Phase 10: the jnp, full and fused engines' chunks (one CUDA graph
    replay a tick) against their eager ticks (:func:`graphed_vs_eager`)
    for each case of ENGINE_CASES, with the CLI's net and schedule: B3,
    B4 and (the jnp engine's step route) B5 counted once a tick either
    way; the replay's sample kernel (the ReplayBuffer's or the
    StreamReplay's) once a trained tick either way; B2, the default
    learner of the dense net (jnp and full), once a trained tick either
    way, the conv net's (fused) none. Then the
    host's walk of a CLI chunk (``--max_scan_steps``' default of 100,000
    ticks) on the jnp engine, and the CLI at its
    defaults (the jnp engine at one env), which must run its chunk as
    graphs. Returns each case's stats."""
    from dronerl_tpu_torch import replay, rng
    from dronerl_tpu_torch.agents.dqn import DQN
    from dronerl_tpu_torch.ops import fused_tick

    t_phase = time.perf_counter()
    state_path = os.path.join(runs, "chunk10.safetensors")
    os.makedirs(runs, exist_ok=True)
    device = device or torch.device("cuda", 0)
    results = {}
    for engine, num_envs, memory, flags in ENGINE_CASES:
        t_case = time.perf_counter()
        args = train.parse_args(["--num_envs", str(num_envs),
                                 "--memory_size", str(memory), *flags])
        params = train.env_params_from_args(args)
        agent = DQN(train.agent_config_from_args(args), params,
                    device=device)
        push = num_envs
        capacity = max(-(-memory // push) * push, 2 * push)
        if engine == "jnp":
            buf = replay.ReplayBuffer(-(-memory // push) * push, BATCH,
                                      uniform_pushes=True)
            tick = train.build_train_step(agent, buf, params, num_envs,
                                          RESET_10)
            init = train.init_jnp_carry
        else:
            buf = replay.StreamReplay(capacity, BATCH, stride=push)
            build = {"full": train.build_train_step_full,
                     "fused": train.build_train_step_fused}[engine]
            tick = build(agent, buf, params, num_envs, RESET_10)
            init = train.init_stream_carry
            fused_tick.prepare_kernel(
                params, None if engine == "fused" else
                fused_tick.flatten_net_params(
                    agent.init_state(rng.PRNGKey(0)).params, agent.net_spec),
                env_tick=engine == "fused")
        if train.choose_engine(args, params) != engine:
            fail(f"10 {engine}: the CLI would choose "
                 f"{train.choose_engine(args, params)} at {flags}")

        def fresh(seed):
            return init(agent, params, num_envs, buf, rng.PRNGKey(seed))

        tag = (f"10 {engine} engine {num_envs} envs memory {memory} "
               f"({args.network_type} net)")
        chunk = train.Chunk(tick)
        ticks = CHUNKS * CHUNK_10_TICKS
        kernel = {"jnp": "step", "full": "full_tick", "fused": "tick"}[engine]
        if (tick.learner == train.KERNEL) != (args.network_type == "dense"):
            fail(f"{tag}: learner {tick.learner}")
        if engine == "jnp" and tick.env_step != train.KERNEL:
            fail(f"{tag}: env step {tick.env_step}")
        trained = sum(sig.trains for sig in chunk.table(fresh(0), ticks)[1])
        expect = want_launches(train, counts(), kernel, ticks, tick.learner,
                               trained)
        stats, numbers = graphed_vs_eager(
            torch, train, zero_counts, counts, tag, chunk, fresh,
            CHUNK_10_TICKS, expect, state_path, device)
        if engine != "full" and stats["graphed"]["draws"]["draw"] == 0:
            fail(f"{tag}: the graphed chunk launched no draw")
        sampler = "buffer_sample" if engine == "jnp" else "stream_sample"
        if any(stats[w]["draws"][sampler] != trained
               or stats[w]["draws"]["ring_sample"] for w in stats):
            fail(f"{tag}: sample launches "
                 f"{[stats[w]['draws'] for w in stats]}, {trained} trained "
                 f"ticks each way")
        log_ways(tag, stats, chunk, ticks, expect, numbers, card,
                 f"; learner {tick.learner}; replay of {buf.capacity} "
                 f"slots, wrapped "
                 f"{ticks * push // buf.capacity} times; the case took "
                 f"{time.perf_counter() - t_case:.1f} s")
        results[(engine, num_envs)] = dict(
            stats, graphs=chunk.graphs, capture_s=chunk.capture_s,
            launches=expect)
        del chunk, tick, buf
        torch.cuda.empty_cache()

    # The host's walk of one CLI chunk at --max_scan_steps' default.
    args = train.parse_args([])
    agent = DQN(train.agent_config_from_args(args),
                train.env_params_from_args(args), device=device)
    buf = replay.ReplayBuffer(args.memory_size, BATCH, uniform_pushes=True)
    chunk = train.Chunk(train.build_train_step(
        agent, buf, agent.env_params, 1, args.reset_env_every))
    carry = train.init_jnp_carry(agent, agent.env_params, 1, buf,
                                 rng.PRNGKey(0))
    t0 = time.perf_counter()
    rows, sigs, _ = chunk.table(carry, args.max_scan_steps)
    walk_s = time.perf_counter() - t0
    log(f"10 the host's walk of a {args.max_scan_steps}-tick jnp chunk: "
        f"{walk_s:.3f} s ({1e6 * walk_s / args.max_scan_steps:.2f} us a "
        f"tick), {len(set(sigs))} signatures, a table of {rows.nbytes} "
        f"bytes; on {card}")
    del rows, sigs, chunk, carry, buf

    # The CLI at its defaults: the jnp engine at one env, graphed.
    metrics = train.main(["--skip_final_eval", "--run_dir",
                          os.path.join(runs, "cli10")])
    if (metrics["engine"] != "jnp" or not metrics.get("graphs")
            or metrics["learner"] != train.KERNEL
            or metrics["env_step"] != train.KERNEL):
        fail(f"10 the CLI at its defaults: engine {metrics['engine']}, "
             f"graphs {metrics.get('graphs')}, learner {metrics['learner']}, "
             f"env step {metrics['env_step']}")
    steps = train.parse_args([]).num_steps
    log(f"10 the CLI at its defaults ({steps} steps, 1 env, memory "
        "100000): the jnp engine as a graphed chunk (its env step on "
        "B5), "
        f"{metrics['graphs']} graphs captured in {metrics['capture_s']:.3f} "
        f"s, the learner kernel on {metrics['trained_ticks']} trained "
        f"ticks; {1e3 * metrics['time_taken'] / steps:.4f} ms a tick with the "
        f"walk and the captures, "
        f"{1e3 * (metrics['time_taken'] - metrics['capture_s']) / steps:.4f}"
        f" ms without the captures; loss {metrics['td_loss_mean']:.5f}, eps "
        f"{metrics['epsilon']:.4f}; on {card}")
    results["walk_s"] = walk_s
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return results


def lifecycle(torch, train, zero_counts, counts, card, obs_per_s, runs):
    """Phase 5: the CLI's lifecycle on the card at the bench configuration
    (5a), its checkpoints read back on the CPU (5b) and the competition
    arena on the card against the CPU (5c)."""
    from dronerl_tpu_torch.agents.dqn import DQN
    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.evaluator import evaluator
    from dronerl_tpu_torch.interop import safetensors_io

    here = os.path.dirname(os.path.abspath(__file__))
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    eval_seconds = []
    evaluate = train.evaluate

    def timed_evaluate(*args):
        t0 = time.perf_counter()
        out = evaluate(*args)
        torch.cuda.synchronize()
        eval_seconds.append(time.perf_counter() - t0)
        return out

    train.evaluate = timed_evaluate

    def run(name, argv, ticks, td):
        """One CLI run, every count zeroed just before: returns its
        metrics, wall seconds and run dir; fails unless B1 launched once a
        tick, B2 once a trained tick (the learner kernel's route; with
        in-kernel TD once a tick) and nothing else did."""
        run_dir = os.path.join(runs, name)
        zero_counts()
        t0 = time.perf_counter()
        metrics = train.train(train.parse_args(
            LIFE_BASE + argv + ["--run_dir", run_dir]))
        seconds = time.perf_counter() - t0
        n = counts()
        want = want_launches(train, n, "full_tick_ring", ticks,
                             metrics["learner"], metrics["trained_ticks"])
        route = train.IN_KERNEL_TD if td else train.KERNEL
        if (metrics["engine"] != "ring" or metrics["learner"] != route
                or n != want):
            fail(f"5a {name}: engine {metrics['engine']}, learner "
                 f"{metrics['learner']}, launches {n}, want {want}")
        return metrics, seconds, run_dir, n

    state_file = train.TRAIN_STATE_FILE
    gen = torch.Generator().manual_seed(0)
    probe = (torch.rand((LIFE_PROBE, 294), generator=gen) < 0.3).float()
    probe[:, 4::6] = torch.randint(0, 101, (LIFE_PROBE, 49),
                                   generator=gen) / 100.0  # charge
    for name, flags, hidden in LIFE_RUNS:
        td = "--in_kernel_td" in flags
        metrics, seconds, whole_dir, n = run(name, flags + [
            "--num_steps", str(LIFE_STEPS), "--max_scan_steps",
            str(LIFE_CHUNK), "--eval_while_training", "--num_evals",
            str(LIFE_EVALS), "--num_eval_steps", str(LIFE_EVAL_STEPS),
            "--save_final_checkpoint", "--save_train_state"], LIFE_STEPS, td)
        evals = eval_seconds[-2:]
        if len(eval_seconds) < 2 or not math.isfinite(
                metrics["eval_reward_mean"]):
            fail(f"5a {name}: evals {eval_seconds}, metrics {metrics}")
        half, half_s, half_dir, _ = run(name + "_half1", flags + [
            "--num_steps", str(LIFE_CHUNK), "--skip_final_eval",
            "--save_train_state"], LIFE_CHUNK, td)
        _, _, resumed_dir, _ = run(name + "_half2", flags + [
            "--num_steps", str(LIFE_CHUNK), "--skip_final_eval",
            "--save_train_state", "--resume_from",
            os.path.join(half_dir, state_file)], LIFE_CHUNK, td)
        a, meta_a = safetensors_io.read(os.path.join(whole_dir, state_file))
        b, meta_b = safetensors_io.read(os.path.join(resumed_dir, state_file))
        differ = sorted(k for k in a if k not in b or not torch.equal(
            a[k], b[k]))
        if set(a) != set(b) or meta_a != meta_b or differ:
            worst = {k: float((a[k].double() - b[k].double()).abs().max())
                     for k in differ[:12] if k in b and a[k].dtype.is_floating_point}
            fail(f"5a {name}: the resumed carry differs from the whole "
                 f"run's: {differ[:12]} (max abs {worst}; numbers "
                 f"{meta_a.get('numbers')} vs {meta_b.get('numbers')})")
        log(f"5a {name}: {LIFE_STEPS} ticks x {NUM_ENVS} envs, launches "
            f"{ {k: v for k, v in n.items() if v} }; obs/s "
            f"{metrics['obs_per_sec']:.1f} over the 2 chunks (the eval "
            f"before the second included), {half['obs_per_sec']:.1f} over "
            f"{LIFE_CHUNK} ticks without eval, phase 4's default path "
            f"{obs_per_s[hidden]:.1f}; evals of {LIFE_EVALS} seeds x "
            f"{LIFE_EVAL_STEPS} steps {[round(e, 3) for e in evals]} s, "
            f"final agent {metrics['eval_reward_mean']:.4f} +- "
            f"{metrics['eval_reward_std']:.4f}; run {seconds:.1f} s; "
            f"{LIFE_CHUNK} + save + resume + {LIFE_CHUNK} equals the whole "
            f"run bitwise ({len(a)} tensors, {meta_a['numbers']}) on {card}")

        # --- 5b. its checkpoints on the CPU ---------------------------------
        cpu_agent = DQN(train.agent_config_from_args(train.parse_args(
            LIFE_BASE + flags)), params, "cpu")
        if "--load_from_checkpoint" in flags:
            cpu_agent = DQN.restore(os.path.join(here, AGENT_3), params,
                                    "cpu")[0]
        card_net = cpu_agent.make_net()
        with torch.no_grad():
            for i, p in enumerate(card_net.flat()):
                p.copy_(a[f"3.params.{i}"])
            want = cpu_agent.q_values(card_net, probe)
            for fmt in ("jax", "torch"):
                path = os.path.join(
                    whole_dir, f"agent_{LIFE_STEPS}_steps_{fmt}.safetensors")
                agent, net = DQN.restore(path, params, "cpu")
                got = agent.q_values(net, probe)
                if not torch.equal(got, want):
                    fail(f"5b {name} {fmt}: Q-values differ from the card's "
                         f"params by {float((got - want).abs().max())}")
        log(f"5b {name}: both checkpoints load on the CPU with the card's "
            f"params; Q-values on {LIFE_PROBE} seeded observations bitwise")
        if "--load_from_checkpoint" in flags:
            check_warm_start(torch, train, params, flags, name)

    train.evaluate = evaluate
    # --- 5c. the competition arena on the card and the CPU -------------------
    paths = [os.path.join(here, BASELINES, f"dqn-agent-{i}.safetensors")
             for i in range(1, 6)]
    t0 = time.perf_counter()
    card_run = evaluator.evaluate_checkpoints(paths, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_run = evaluator.evaluate_checkpoints(paths, device="cpu")
    cpu_s = time.perf_counter() - t0
    firsts = []
    for ep, seed in enumerate(evaluator.EPISODE_SEEDS):
        diff = (card_run["actions"][:, ep] != cpu_run["actions"][:, ep]).any(
            axis=-1)
        ties = (cpu_run["q_gap"][:, ep] <= NEAR_TIE).any(axis=-1)
        first_div = int(diff.argmax()) if diff.any() else None
        first_tie = int(ties.argmax()) if ties.any() else None
        if first_div is not None and (first_tie is None
                                      or first_div < first_tie):
            fail(f"5c seed {seed}: the card's actions part from the CPU's "
                 f"at step {first_div}, before the first near tie "
                 f"({first_tie})")
        at_tie = first_div is not None and bool(
            (cpu_run["q_gap"][first_div, ep] <= NEAR_TIE)[
                card_run["actions"][first_div, ep]
                != cpu_run["actions"][first_div, ep]].all())
        firsts.append((seed, first_div, first_tie, at_tie))
    rounded = lambda v: [round(float(x), 4) for x in v]  # noqa: E731
    log(f"5c round robin of the five baselines, {len(paths)} drones on grid "
        f"{evaluator.arena_params(len(paths)).grid_size}, "
        f"{len(evaluator.EPISODE_SEEDS)} seeds x "
        f"{evaluator.TOTAL_EPISODE_STEPS} steps: card mean "
        f"{rounded(card_run['mean'])} std {rounded(card_run['std'])} in "
        f"{card_s:.2f} s; CPU mean {rounded(cpu_run['mean'])} std "
        f"{rounded(cpu_run['std'])} in {cpu_s:.2f} s; the JAX CPU lock "
        f"{list(JAX_CPU_LOCK)} (information); per seed (seed, first step "
        f"where the actions part or None, first near tie on the CPU, the "
        f"parting agents at a near tie there): {firsts}; on {card}")


# --- 6. multi-GPU training ----------------------------------------------------

def multi_gpu(torch, train, zero_counts, counts, card, obs_per_s, runs,
              timed):
    """Phase 6: the sharded engines. 6a the CLI with ``--use_sharding`` at
    world size 1 over NCCL; 6b and 6c two ranks on the one card over gloo
    (``parallel.launch.spawn``), lockstep against the plain versions, and
    a per-rank train state; 6d the periphery; then what NCCL says to two
    ranks on one card. Returns the kernel line's sharded entries: 6a's
    launches, each kernel compared and timed in place on a 6a trainer's
    carry (``sharded_in_place``), and 6b's launches of the same builds."""
    from dronerl_tpu_torch.agents import dqn as dqn_mod
    from dronerl_tpu_torch.parallel import launch, mesh as mesh_mod

    t_phase = time.perf_counter()
    # --- 6a ---------------------------------------------------------------
    mesh = mesh_mod.make_env_mesh(device="cuda")
    backend = torch.distributed.get_backend(mesh.group)
    entries = []
    for engine, memory, net_flags, kernel, nets in MG_CLI_RUNS:
        for hidden in nets:
            flags = net_flags + (["--hidden_layers", *map(str, hidden)]
                                 if hidden else [])
            zero_counts()
            dqn_mod.all_reduce_mean.calls = 0
            t0 = time.perf_counter()
            metrics = train.main(LIFE_BASE + flags + [
                "--use_sharding", "--num_steps", str(MG_TICKS),
                "--memory_size", memory, "--skip_final_eval", "--run_dir",
                os.path.join(runs, "sharded")])
            seconds = time.perf_counter() - t0
            n = counts()
            calls = dqn_mod.all_reduce_mean.calls
            tag = f"6a sharded {engine} {' '.join(flags)}"
            if (metrics["engine"] != f"sharded-{engine}"
                    or metrics["world_size"] != 1):
                fail(f"{tag}: engine {metrics['engine']}, world "
                     f"{metrics.get('world_size')}")
            if n[kernel] != MG_TICKS or sum(n.values()) != MG_TICKS:
                fail(f"{tag}: launches {n} in {MG_TICKS} ticks")
            if not 0 < metrics["trained_ticks"] == calls:
                fail(f"{tag}: {calls} all-reduces for "
                     f"{metrics['trained_ticks']} trained ticks")
            if metrics["td_loss_mean"] is None or not math.isfinite(
                    metrics["td_loss_mean"]) or not metrics["epsilon"] < 1.0:
                fail(f"{tag}: loss {metrics['td_loss_mean']}, epsilon "
                     f"{metrics['epsilon']}")
            beside = (f"phase 4's single-card ring engine "
                      f"{obs_per_s[hidden]:.1f}" if hidden else
                      "phase 4d's fused engine above")
            log(f"{tag}: {backend} world 1, {MG_TICKS} ticks x {NUM_ENVS} "
                f"envs, launches { {k: v for k, v in n.items() if v} }, "
                f"{calls} all-reduces for {metrics['trained_ticks']} trained "
                f"ticks, loss {metrics['td_loss_mean']:.5f}, eps "
                f"{metrics['epsilon']:.4f}; obs/s "
                f"{metrics['obs_per_sec']:.1f} (the CLI's clock over "
                f"{MG_TICKS} ticks, warm-up included) beside {beside}; run "
                f"{seconds:.1f} s on {card}")
            base = timed[kernel + ("_" + "x".join(map(str, hidden))
                                   if hidden else "")]
            entries.append(dict(
                name=base["name"] + "_sharded", route=base["route"],
                source=base["source"], replaces=MG_REPLACES[kernel] + "; "
                + base["replaces"], launches=n[kernel],
                **sharded_in_place(torch, mesh, engine, kernel, hidden,
                                   int(memory), f"{tag} in place", card),
                library_ms=None))
    for hidden in NETS:  # the learner's all-reduce: grads and loss
        size = 1 + sum(i * o + o for i, o in zip((294, *hidden),
                                                 (*hidden, 5)))
        buf = torch.zeros(size, device="cuda")
        reduce = lambda: dqn_mod.all_reduce_mean([buf], mesh.group)  # noqa
        dev_ms = cuda_ms(torch, reduce, MG_REDUCES)
        log(f"6a all-reduce of the net {hidden}'s {size} floats over "
            f"{backend} at world 1: {dev_ms:.5f} ms a trained tick (CUDA "
            f"events over {MG_REDUCES} calls), host "
            f"{host_ms(torch, reduce, MG_REDUCES):.5f} ms; on {card}")
    # --- 6e ---------------------------------------------------------------
    chunk_launches = sharded_chunks(torch, train, zero_counts, counts, card,
                                    runs, mesh)
    for entry in entries:  # 6e's graphed launches of the same builds
        entry["launches_6e_chunk"] = sum(
            n for name, n in chunk_launches.items()
            if timed[name]["name"] + "_sharded" == entry["name"])
    # The jnp engine's B5 has no sharded entry: its own gets 6e's launches.
    timed["step_observe"]["launches_6e_chunk"] = chunk_launches.get(
        "step_observe", 0)
    torch.distributed.destroy_process_group()

    # --- 6b, 6c -----------------------------------------------------------
    t0 = time.perf_counter()
    ranks = launch.spawn(rank_6b, MG_RANKS, (os.path.join(runs, "6c"),),
                         device="cuda", backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    for name, _, _, kernel in MG_CASES:
        got = [r["cases"][name] for r in ranks]
        for r, g in zip(ranks, got):
            want = {k: 0 for k in g["launches"]}
            want[kernel] = MG_COMPARE_TICKS
            if g["launches"] != want:
                fail(f"6b {name} rank {r['rank']}: launches {g['launches']}")
            if g["calls"] != 2 * g["trained"] or not g["trained"]:
                fail(f"6b {name} rank {r['rank']}: {g['calls']} all-reduces "
                     f"for {g['trained']} trained ticks on the card and the "
                     "CPU")
        for a, b in zip(got[0]["params"], got[1]["params"]):
            if not torch.equal(a, b):
                fail(f"6b {name}: the ranks' params differ")
        log(f"6b {name}: 2 ranks x {MG_SMALL} envs on {ranks[0]['device']} "
            f"(gloo), {MG_COMPARE_TICKS} ticks (reset every {MG_RESET}) in "
            f"lockstep with the plain versions on the CPU: launches "
            f"{[g['launches'][kernel] for g in got]}, trained ticks "
            f"{got[0]['trained']}, env state, rewards and dones bitwise but "
            f"at near ties {[g['ties'] for g in got]} (max charge-channel "
            f"error {max(g['charge_err'] for g in got):.3g}), loss max rel "
            f"err {max(g['loss_err'] for g in got):.3g}, params max abs err "
            f"{max(g['param_err'] for g in got):.3g}; the ranks' params "
            "bitwise equal")
    big = [r["big"] for r in ranks]
    log(f"6b sharded ring engine, 2 ranks x {MG_BIG} envs on one card over "
        f"gloo, {MG_BIG_TICKS} ticks: B1 launches "
        f"{[b['launches'] for b in big]}, obs/s (both ranks' envs) "
        f"{[round(b['obs_per_s'], 1) for b in big]}, all-reduce "
        f"{[round(b['reduce_ms'], 4) for b in big]} ms a trained tick for "
        f"CUDA tensors vs {[round(b['reduce_cpu_ms'], 4) for b in big]} ms "
        f"for CPU tensors (the staging through the host), on {card}")
    for entry in entries:  # 6b's launches of the same builds, per rank
        for name, _, cfg, kernel in MG_CASES:
            if entry["name"] == timed[kernel + ("_16x16" if kernel != "tick"
                                                else "")]["name"] + "_sharded":
                entry["launches_6b_two_ranks"] = [
                    r["cases"][name]["launches"][kernel]
                    + (r["big"]["launches"] if kernel == "full_tick_ring"
                       else 0) for r in ranks]
    log(f"6c per-rank train states: 6 ticks, save, 6 more equals a restore "
        f"of the save and 6 more, bitwise, on both ranks "
        f"({ranks[0]['resume_tensors']} tensors each); the trainer's chunk "
        f"over gloo on the card: eager rows, graphs "
        f"{[r['gloo_chunk_graphs'] for r in ranks]}, 2 x {MG_RESUME_AT} "
        f"ticks equal to {2 * MG_RESUME_AT} eager ticks bitwise; 6b+6c took "
        f"{spawn_s:.1f} s, the ranks' start included")

    # --- 6d ---------------------------------------------------------------
    from dronerl_tpu_torch import benchmark
    from dronerl_tpu_torch.env.gymapi import DeliveryDronesEnv

    t0 = time.perf_counter()
    row = benchmark.bench_config("Default", {}, DRONES, MG_BENCH_STEPS,
                                 benchmark.NUM_ENVS, "cuda")
    log(f"6d benchmark.py Default, {DRONES} drones, {benchmark.NUM_ENVS} "
        f"envs, {MG_BENCH_STEPS} steps: env {row['env_steps_per_s']:.1f} "
        f"steps/s, act {row['act_steps_per_s']:.1f}, learn "
        f"{row['learn_steps_per_s']:.1f} it/s, full loop "
        f"{row['fused_obs_per_s']:.1f} obs/s ({time.perf_counter() - t0:.1f}"
        f" s) on {benchmark.device_line(torch.device('cuda', 0))}")
    envs = [DeliveryDronesEnv({"n_drones": DRONES, "grid_size": GRID},
                              device=d) for d in ("cuda", "cpu")]
    obs = [e.reset(seed=0)[0] for e in envs]
    moves = torch.randint(0, 5, (MG_GYM_STEPS, DRONES),
                          generator=torch.Generator().manual_seed(0))
    t_gym = [0.0, 0.0]
    for t in range(MG_GYM_STEPS + 1):
        for i in range(DRONES):
            a, b = obs[0][i], obs[1][i]
            if not ((a[..., :4] == b[..., :4]).all()
                    and (a[..., 5] == b[..., 5]).all()
                    and abs(a[..., 4] - b[..., 4]).max() <= CHARGE_ATOL):
                fail(f"6d DeliveryDronesEnv: drone {i}'s observation on the "
                     f"card differs from the CPU's at step {t}")
        if t == MG_GYM_STEPS:
            break
        action = {i: int(m) for i, m in enumerate(moves[t])}
        out = []
        for j, env in enumerate(envs):
            t0 = time.perf_counter()
            out.append(env.step(action))
            t_gym[j] += time.perf_counter() - t0
        if out[0][1:3] != out[1][1:3]:
            fail(f"6d DeliveryDronesEnv: rewards or dones differ at step {t}")
        obs = [o[0] for o in out]
    if envs[0].render() != envs[1].render():
        fail("6d DeliveryDronesEnv: the boards differ")
    log(f"6d DeliveryDronesEnv {MG_GYM_STEPS} steps on the card equal the "
        f"CPU's (observations, rewards, dones, the board): {t_gym[0]:.2f} s "
        f"on {card}, {t_gym[1]:.2f} s on the CPU")

    # --- NCCL with two ranks on one card ------------------------------------
    try:
        launch.spawn(rank_nccl_probe, 2, (), device="cuda", backend="nccl",
                     timeout=MG_PROBE_SECONDS)
        said = "it ran an all-reduce"
    except RuntimeError as err:  # NCCL's refusal is the expected outcome
        lines = [ln.strip() for ln in str(err).splitlines()]
        said = " | ".join(ln for ln in lines if "Duplicate GPU" in ln
                          or ln.startswith("torch.distributed."))[:600]
        said = said or lines[0]
    log(f"6 NCCL with two ranks on one card: {said}")
    log(f"phase 6 took {time.perf_counter() - t_phase:.1f} s by the log's "
        "clock")
    return entries


def load_script(here, name):
    """``scripts/<name>.py`` of the checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_points(torch, train, zero_counts, counts, card, runs, here,
                 kernels, device):
    """Phase 7: 7a the numerics lock (B1 against the TPU record's Tier A
    and the card's record's Tier B), 7b the competition CLI, 7c the
    baseline creator, 7d the CLI with ``--tensorboard_dir`` and no
    tensorboard. Adds B1's launches of 7a and 7d to ``kernels``' B1
    entries."""
    import importlib.util
    import logging

    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.evaluator import evaluator
    from dronerl_tpu_torch.ops import fused_tick

    def only(n, kernel, want, tag, learner=0):
        """Fail unless ``kernel`` launched ``want`` times, the learner
        kernel ``learner`` times and nothing else launched."""
        expected = {key: want if key == kernel else 0 for key in n}
        expected["td_adam"] = learner
        if n != expected:
            fail(f"{tag}: launches {n}, want {expected}")

    b1 = {e["name"]: e for e in kernels
          if e["name"].startswith("full_tick_ring_")}
    flags = ["--device", device.type]
    seconds = {}
    t_phase = time.perf_counter()

    # --- 7a ---------------------------------------------------------------
    t0 = time.perf_counter()
    lock = load_script(here, "torch_numerics_lock")
    zero_counts()
    now = lock.run_scenario(device)
    n = counts()
    # The scenario's ring holds a batch from its first tick: every tick
    # trains, with the learner kernel.
    only(n, "full_tick_ring", lock.STEPS, "7a numerics lock", lock.STEPS)
    errs = lock.check(now)
    if errs:
        fail("7a numerics lock: " + "; ".join(errs))
    cpu = lock.run_scenario(torch.device("cpu"))
    cpu_errs = lock.check(cpu, card=False)
    if cpu_errs:
        fail("7a the plain path's Tier A: " + "; ".join(cpu_errs))
    b1["full_tick_ring_16x16"]["launches_7a_numerics_lock"] = (
        n["full_tick_ring"])
    with open(lock.RECORD) as f:
        meta = json.load(f)["meta"]
    seconds["7a"] = time.perf_counter() - t0
    log(f"7a numerics lock ({lock.NUM_ENVS} envs, {lock.STEPS} ticks, bf16 "
        f"ring, eps 1.0): B1 launches {n['full_tick_ring']}, B2 "
        f"{n['td_adam']} in {lock.STEPS}; Tier A (digests "
        f"{sorted(now['int_digests'])}, "
        f"ring sum {now['env_floats']['ring_sum']}, non-zero "
        f"{now['env_floats']['ring_nonzero']}) equals the TPU record's, and "
        f"the plain path's on the CPU; Tier B inside the card's record "
        f"({meta['nvidia_smi']}, torch {meta['torch_version']}); largest "
        f"Tier B difference from the CPU's plain run "
        f"{lock.tier_b_max_diff(now, cpu):.6g} (loss tail "
        f"{now['learner']['loss_tail_mean']:.6g} vs "
        f"{cpu['learner']['loss_tail_mean']:.6g}); {seconds['7a']:.1f} s "
        f"on {card}")

    # --- 7b ---------------------------------------------------------------
    t0 = time.perf_counter()
    competition = load_script(here, "torch_evaluate_agent")
    has_pil = importlib.util.find_spec("PIL") is not None
    render = evaluator.DroneRacerEvaluator._render_first_episode
    if not has_pil:  # the scores alone: the video needs PIL
        evaluator.DroneRacerEvaluator._render_first_episode = (
            lambda self, paths, names, output_path: None)
    zero_counts()
    try:
        result = competition.main([
            os.path.join(here, AGENT_3), "--video_output_path",
            os.path.join(runs, "episode0.mp4"), *flags])
    finally:
        evaluator.DroneRacerEvaluator._render_first_episode = render
    only(counts(), None, 0, "7b competition CLI")
    if len(result["all_scores"]) != 6 or not all(
            math.isfinite(v) for v in result["all_scores"].values()):
        fail(f"7b competition CLI: scores {result['all_scores']}")
    seconds["7b"] = time.perf_counter() - t0
    video = result["media_video_path"]
    log(f"7b torch_evaluate_agent.py {AGENT_3}: score "
        f"{result['score']:.3f} ± {result['score_secondary']:.3f}, video "
        f"{os.path.relpath(video, here) if has_pil else 'skipped (no PIL)'}"
        f", {seconds['7b']:.1f} s on {card}")

    # --- 7c ---------------------------------------------------------------
    t0 = time.perf_counter()
    creator = load_script(here, "torch_create_baselines")
    out = os.path.join(runs, "baselines")
    trained = []  # each run's learner kernel steps
    stepped = []  # each run's step kernel launches (the jnp engine's route)
    run_train = train.train

    def recorded(args):
        metrics = run_train(args)
        trained.append(metrics["trained_ticks"]
                       if metrics["learner"] == train.KERNEL else 0)
        stepped.append(args.num_steps
                       if metrics["env_step"] == train.KERNEL else 0)
        return metrics

    train.train = recorded
    zero_counts()
    try:
        written = creator.main(["--num_steps", str(EP_BASELINE_STEPS),
                                "--out_dir", out, *flags])
    finally:
        train.train = run_train
    only(counts(), "step", sum(stepped),
         "7c baseline creator (the jnp engine)", sum(trained))
    judge = evaluator.DroneRacerEvaluator(answer_folder_path=out,
                                          device=device.type)
    scores = evaluator.evaluate_checkpoints(
        list(judge.participating_agents.values()), EP_SCORE_SEEDS,
        EP_SCORE_STEPS, device=device.type)
    if len(written) != 5 or not all(
            math.isfinite(float(v))
            for v in scores["episode_scores"].reshape(-1)):
        fail(f"7c baseline creator: {written}, {scores['episode_scores']}")
    seconds["7c"] = time.perf_counter() - t0
    log(f"7c torch_create_baselines.py --num_steps {EP_BASELINE_STEPS}: "
        f"{len(written)} checkpoints under {os.path.relpath(out, here)} "
        f"(learner kernel steps a run {trained}), "
        f"loaded by the evaluator, scores over {len(EP_SCORE_SEEDS)} x "
        f"{EP_SCORE_STEPS} steps {[round(float(v), 3) for v in scores['mean']]}"
        f"; {seconds['7c']:.1f} s on {card}")

    # --- 7d ---------------------------------------------------------------
    t0 = time.perf_counter()
    installed = importlib.util.find_spec("tensorboard") is not None
    # Blocked where it is installed, so that the run meets what C3 is about.
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] == "tensorboard"
             or m.startswith("torch.utils.tensorboard")}
    sys.modules["tensorboard"] = None
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    metrics_logger = logging.getLogger("dronerl_tpu_torch.utils.metrics")
    metrics_logger.addHandler(handler)
    tb_dir = os.path.join(runs, "tb")
    try:
        zero_counts()
        metrics = train.main(LIFE_BASE + flags + [
            "--num_steps", str(EP_CLI_STEPS), "--tensorboard_dir", tb_dir,
            "--skip_final_eval", "--run_dir", os.path.join(runs, "tb_run")])
        n = counts()
    finally:
        metrics_logger.removeHandler(handler)
        del sys.modules["tensorboard"]
        sys.modules.update(saved)
    if metrics["learner"] != train.KERNEL:
        fail(f"7d CLI --tensorboard_dir: learner {metrics['learner']}")
    only(n, "full_tick_ring", EP_CLI_STEPS, "7d CLI --tensorboard_dir",
         metrics["trained_ticks"])
    if warnings != ["tensorboard unavailable; skipping TB logging"]:
        fail(f"7d CLI --tensorboard_dir: warnings {warnings}")
    if os.path.exists(tb_dir) or metrics["td_loss_mean"] is None or not (
            math.isfinite(metrics["td_loss_mean"])):
        fail(f"7d CLI --tensorboard_dir: {metrics}")
    b1["full_tick_ring_16x16"]["launches_7d_cli_tensorboard"] = (
        n["full_tick_ring"])
    seconds["7d"] = time.perf_counter() - t0
    log(f"7d CLI --tensorboard_dir with tensorboard "
        f"{'blocked' if installed else 'not installed'}: warned "
        f"{warnings!r} and completed {EP_CLI_STEPS} steps (engine "
        f"{metrics['engine']}, B1 launches {n['full_tick_ring']}, B2 "
        f"{n['td_adam']}, loss "
        f"{metrics['td_loss_mean']:.5f}); {seconds['7d']:.1f} s on {card}")

    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    obs_dim = fused_tick.obs_rows(params)
    for hidden in NETS:
        bound = learner_bound((obs_dim, *hidden, 5), EP_LEARNER_BATCH, False)
        log(f"learner kernel (B6) net {hidden} at batch {EP_LEARNER_BATCH}: "
            f"bound {bound[0]:.6f} ms ({bound[1]}: {bound[2]} B, {bound[3]} "
            f"FLOP), without sync")
    log(f"phase 7 took {time.perf_counter() - t_phase:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")


def bench_program(here, runs, device_kind, card, obs_per_s, entries):
    """Phase 8: the bench (``python -m dronerl_tpu_torch.bench``) and one
    row of each companion script, each a subprocess of the checkout. Adds
    the bench's B1 and B2 launches to ``entries`` (``launches_8_bench``)."""
    from dronerl_tpu_torch import bench

    t_phase = time.perf_counter()
    os.makedirs(runs, exist_ok=True)

    def run(argv, env=None):
        proc = subprocess.run([sys.executable, *argv], cwd=here,
                              env={**os.environ, **(env or {})},
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"8: {' '.join(argv)} exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return proc.stdout

    line = json.loads(run(["-m", "dronerl_tpu_torch.bench"],
                          BENCH_ENV).strip().splitlines()[-1])
    if line.get("correct") is not True:
        fail(f"8: the bench's line says correct {line.get('correct')}: "
             f"{json.dumps(line['checks'])[:3000]}")
    device = line["device"]
    if device["platform"] != "gpu" or device["kind"] != device_kind:
        fail(f"8: the bench ran on {device}, not {device_kind}")
    metrics = {m["metric"]: m for m in [line] + line["extra_metrics"]}
    by_name = {e["name"]: e for e in entries}
    for net, hidden in bench.NETS.items():
        name = "x".join(map(str, hidden))
        for td in (False, True):
            m = metrics.get(bench.metric_name(net, NUM_ENVS, td))
            if m is None:
                fail(f"8: no {bench.metric_name(net, NUM_ENVS, td)} in the "
                     "bench's line")
            # Every timed tick trains, on the default path too.
            ticks = m["repeats"] * m["steps_per_repeat"]
            want = {"full_tick_ring": ticks, "td_adam": ticks}
            if m["launches"] != want:
                fail(f"8: {m['metric']}: launches {m['launches']}, want "
                     f"{want}")
            for entry, key in ((f"full_tick_ring_{name}", "full_tick_ring"),
                               (f"td_adam_{name}", "td_adam")):
                by_name[entry]["launches_8_bench"] = (
                    by_name[entry].get("launches_8_bench", 0)
                    + m["launches"][key])
            split = line["per_layer"][m["metric"]]
            log(f"8 bench {m['metric']}: {m['value']:.1f} obs/s (median of "
                f"{m['repeats']} x {m['steps_per_repeat']} ticks; q1-q3 "
                f"{m['q1_s']:.4f}-{m['q3_s']:.4f} s) vs phase 4's "
                f"default path {obs_per_s[hidden]:.1f}; launches "
                f"{m['launches']}; {m['graphs']} graphs captured in "
                f"{m['capture_s']:.3f} s; build {m['build_s']} s, warm-up "
                f"{m['warmup_s']:.2f} s, peak {m['peak_mem_bytes']} B; "
                f"traced: busy {split['device_busy_share']:.4f}, device ms "
                f"a tick {split['device_ms']:.4f}, launches a tick "
                f"{split['launches_per_tick']:.1f}; on {card}")

    for name, extra in BENCH_SCRIPTS:
        out = os.path.join(runs, f"{name}.json")
        run([os.path.join("scripts", f"{name}.py"), *extra, "--steps",
             str(BENCH_SCRIPT_STEPS), "--repeats", str(BENCH_SCRIPT_REPEATS),
             "--out", out])
        with open(out) as f:
            rows = json.load(f)
        for row in rows:
            obs = row.get("obs_per_sec")
            if (row["device"]["kind"] != device_kind or obs is None
                    or not math.isfinite(obs) or obs <= 0):
                fail(f"8: {name}: row {json.dumps(row)[:2000]}")
            if name == "torch_scaling_bench":
                want = BENCH_SCRIPT_REPEATS * BENCH_SCRIPT_STEPS
                got = row["ranks"][0]["launches"]
                if (got[row["local_engine"]] != want
                        or sum(got.values()) != want):
                    fail(f"8: {name}: launches {got}, want {want} of "
                         f"{row['local_engine']}")
            brief = {k: v for k, v in row.items()
                     if k not in ("device", "ranks", "repeat_s")}
            log(f"8 {name}: {json.dumps(brief)}")
    log(f"phase 8 took {time.perf_counter() - t_phase:.1f} s on {card}")


def sharded_chunks(torch, train, zero_counts, counts, card, runs, mesh):
    """Phase 6e: each case of MG_CHUNK_CASES on a world-1
    ``DistributedTrainer`` over ``mesh`` (NCCL): its chunk (one CUDA graph
    replay a tick, the all-reduce captured inside) against its eager
    ticks (:func:`graphed_vs_eager`), the all-reduces counted beside the
    kernels' launches. Returns the graphed launches by the kernel line's
    name of each build."""
    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.agents import dqn as dqn_mod
    from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.ops import fused_tick
    from dronerl_tpu_torch.parallel.distributed import DistributedTrainer

    t_phase = time.perf_counter()
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    state_path = os.path.join(runs, "chunk6e.safetensors")
    os.makedirs(runs, exist_ok=True)
    ticks = CHUNKS * CHUNK_10_TICKS

    def zero():
        zero_counts()
        dqn_mod.all_reduce_mean.calls = 0

    def count():
        return dict(counts(), all_reduce=dqn_mod.all_reduce_mean.calls)

    launches = {}
    for engine, num_envs, memory, hidden in MG_CHUNK_CASES:
        t_case = time.perf_counter()
        net = (dict(hidden_layers=hidden) if hidden
               else dict(network_type="conv"))
        agent = DQN(DQNConfig(epsilon_decay_every=5, target_update_interval=10,
                              gamma=0.9, **net), params, device=mesh.device)
        trainer = DistributedTrainer(
            agent, params, mesh, num_envs=num_envs,
            buffer_capacity_per_shard=memory, batch_size_per_shard=BATCH,
            reset_env_every=RESET_10, engine=engine)
        local = trainer.local_engine
        if local != "jnp":
            fused_tick.prepare_kernel(
                params, None if local == "fused" else
                fused_tick.flatten_net_params(
                    agent.init_state(rng.PRNGKey(0)).params, agent.net_spec),
                env_tick=local == "fused")
        chunk = trainer.build_chunk(CHUNK_10_TICKS).chunk
        tag = (f"6e sharded {engine} ({local}) {num_envs} envs memory "
               f"{memory} net {hidden or 'conv'}")
        backend = torch.distributed.get_backend(mesh.group)
        if not chunk.graphed:
            fail(f"{tag}: a chunk over {backend} would not capture graphs")
        if not chunk.tick.learner.startswith(train.AUTOGRAD):
            fail(f"{tag}: learner {chunk.tick.learner} on a grouped tick")

        def fresh(seed):
            return trainer.init_carry(rng.PRNGKey(seed))

        kernel = {"ring": "full_tick_ring", "full": "full_tick",
                  "fused": "tick", "jnp": "step"}[local]
        if local == "jnp" and chunk.tick.env_step != train.KERNEL:
            fail(f"{tag}: env step {chunk.tick.env_step}")
        expect = {k: 0 for k in count()}
        expect[kernel] = ticks
        expect["all_reduce"] = sum(
            sig.trains for sig in chunk.table(fresh(0), ticks)[1])
        stats, numbers = graphed_vs_eager(
            torch, train, zero, count, tag, chunk, fresh, CHUNK_10_TICKS,
            expect, state_path, mesh.device, trace=False)
        log_ways(tag, stats, chunk, ticks, expect, numbers, card,
                 f"; {backend} world {mesh.world_size}, capture mode "
                 f"{chunk.capture_mode}, learner autograd (a group); the "
                 f"case took {time.perf_counter() - t_case:.1f} s")
        name = {"tick": "tick", "step": "step_observe"}.get(
            kernel, kernel + "_" + "x".join(map(str, hidden or ())))
        launches[name] = launches.get(name, 0) + ticks
        del chunk, trainer, agent
        torch.cuda.empty_cache()
    log(f"phase 6e took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def sharded_in_place(torch, mesh, engine, kernel, hidden, memory, tag,
                     card):
    """Phase 6a's kernel in place: a world-1 ``DistributedTrainer`` on
    ``mesh`` at the CLI run's configuration (the bench board, NUM_ENVS
    envs, the net ``hidden`` or the CLI's conv net, ``memory``), 3 ticks,
    then one launch of the kernel's wrapper on the carry against its
    plain version on the same inputs (ε = 0.5): env state, rewards and
    dones bitwise, the observation bitwise but the charge channel (within
    CHARGE_ATOL), B1/B3's actions equal to the plain actor's outside near
    ties; then the kernel timed on the carry as phases 3-4 time it.
    Returns the kernel line's max_abs_err and timing keys."""
    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.ops import _build, fused_tick
    from dronerl_tpu_torch.parallel.distributed import DistributedTrainer

    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    decay = dict(epsilon_decay=0.995, epsilon_decay_every=5)  # the CLI's
    cfg = (DQNConfig(hidden_layers=hidden, **decay) if hidden
           else DQNConfig(network_type="conv", **decay))
    agent = DQN(cfg, params, device=mesh.device)
    trainer = DistributedTrainer(
        agent, params, mesh, num_envs=NUM_ENVS,
        buffer_capacity_per_shard=memory, batch_size_per_shard=BATCH,
        reset_env_every=RESET_EVERY, engine=engine)
    if trainer.local_engine != {"full_tick_ring": "ring", "full_tick": "full",
                                "tick": "fused"}[kernel]:
        fail(f"{tag}: local engine {trainer.local_engine}")
    carry = trainer.init_carry(rng.PRNGKey(0))
    tick = trainer.build_tick()
    for _ in range(3):
        carry, _ = tick(carry)
    torch.cuda.synchronize()
    key, eps = rng.PRNGKey(7), torch.tensor(0.5, device=mesh.device)
    chain = carry[3].params.flat()
    if kernel == "full_tick_ring":
        tstate, ring = carry[1]
        ring_plain = ring.clone()
        out_k = fused_tick.full_tick_fused_ring(
            key, tstate, ring, 0, NUM_ENVS, chain, eps, False, params)
        out_p = fused_tick.full_tick_ring_plain(
            key, tstate, ring_plain, 0, NUM_ENVS, chain, eps, False, params,
            actions_override=out_k[3])
        obs = (ring[:, NUM_ENVS:2 * NUM_ENVS],
               ring_plain[:, NUM_ENVS:2 * NUM_ENVS])
        obs_in = ring
    elif kernel == "full_tick":
        tstate, obs_in = carry[1], carry[2]
        out_k = fused_tick.full_tick_fused(key, tstate, obs_in, chain, eps,
                                           False, params)
        out_p = fused_tick.full_tick_plain(key, tstate, obs_in, chain, eps,
                                           False, params,
                                           actions_override=out_k[3])
        obs = out_k[4], out_p[4]
    else:
        tstate = carry[1]
        actions = rng.randint(rng.PRNGKey(8).to(mesh.device),
                              (DRONES, NUM_ENVS), 0, 5)
        out_k = fused_tick.tick_fused(key, tstate, actions, params)
        out_p = fused_tick.tick_plain(key, tstate, actions, params)
        obs = out_k[3], out_p[3]
    torch.cuda.synchronize()
    for name, a, b in zip(fused_tick.TState._fields + ("rewards", "dones"),
                          out_k[0] + out_k[1:3], out_p[0] + out_p[1:3]):
        if not torch.equal(a, b):
            fail(f"{tag}: {name} differs from the plain version's")
    obs_k, obs_p = (o.float().reshape(-1, 6, NUM_ENVS) for o in obs)
    ch = torch.arange(6, device=mesh.device) != 4
    if not torch.equal(obs_k[:, ch], obs_p[:, ch]):
        fail(f"{tag}: observation channels differ from the plain version's")
    err = float((obs_k[:, 4] - obs_p[:, 4]).abs().max())
    if err > CHARGE_ATOL:
        fail(f"{tag}: charge channel off by {err}")
    ties = 0
    if kernel != "tick":
        keys = rng.split_plain(key.to(mesh.device), NUM_ENVS + 2)
        act_p, q = fused_tick.plain_actions(
            keys[NUM_ENVS], obs_in, 0, chain, eps, params, NUM_ENVS,
            fused_tick.actor_rounds(20, None))
        top2 = q.topk(2, dim=0).values
        tie = (top2[0] - top2[1]) <= NEAR_TIE * q.abs().amax(dim=0)
        differ = (out_k[3] != act_p).any(dim=0)
        if bool((differ & ~tie).any()):
            fail(f"{tag}: {int((differ & ~tie).sum())} actions differ from "
                 "the plain actor's outside near ties")
        ties = int(tie.sum())
    log(f"{tag}: one launch == plain at {NUM_ENVS} envs; env bitwise, "
        f"charge max err {err:.3e}, near-tie envs {ties}")
    if kernel == "full_tick_ring":
        ms, plain_ms, bound_ms, bound_by = time_kernel(
            torch, _build, fused_tick, rng, agent, carry, hidden, card)
        timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
    elif kernel == "full_tick":
        timing = time_obs_kernel(torch, _build, fused_tick, rng, agent,
                                 carry, hidden, card)
    else:
        timing = time_env_tick(torch, _build, fused_tick, rng, carry[1],
                               params, card)
    return dict(max_abs_err=err, **timing)


def _tensors(node):
    """The tensors of a carry in a fixed order (nets by ``flat()``)."""
    import torch

    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif hasattr(node, "flat"):
        yield from node.flat()
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _tensors(getattr(node, f.name))


def _numbers(carry):
    """The carry's host numbers: the step, a replay's cursor and size, the
    Adam count."""
    nums = [carry[-1], carry[3].opt_state.count]
    if hasattr(carry[4], "cursor"):
        nums += [carry[4].cursor, carry[4].size]
    return nums


def rank_6b(state_dir, device="cuda"):
    """One of phase 6b's two ranks, both on the card over gloo: MG_CASES
    each in lockstep with the plain versions on the CPU (the card's carry
    copied to the CPU replica before each tick; env state, next
    observation and this tick's scalars per env bitwise, but the charge
    channel, except where drone 0's action differs at a near tie of the
    CPU's Q-values; the learner within phase 3's limits), the ring engine
    at MG_BIG envs timed, the all-reduce on CUDA and CPU tensors, and
    6c's save and resume."""
    import torch
    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.agents import dqn as dqn_mod
    from dronerl_tpu_torch.agents.dqn import DQN, DQNConfig
    from dronerl_tpu_torch.env.types import EnvParams
    from dronerl_tpu_torch.interop import train_state_io
    from dronerl_tpu_torch.ops import fused_tick
    from dronerl_tpu_torch.parallel import mesh as mesh_mod
    from dronerl_tpu_torch.parallel.distributed import DistributedTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.make_env_mesh(device=device)
    cpu_mesh = dataclasses.replace(mesh, device=torch.device("cpu"))
    params = EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS)
    kernels = {"full_tick_ring": fused_tick.full_tick_fused_ring,
               "full_tick": fused_tick.full_tick_fused,
               "tick": fused_tick.tick_fused}
    out = {"rank": mesh.rank, "device": str(mesh.device), "cases": {}}

    def make(cfg, engine, m, num_envs, memory):
        agent = DQN(DQNConfig(**cfg), params, device=m.device)
        trainer = DistributedTrainer(
            agent, params, m, num_envs=MG_RANKS * num_envs,
            buffer_capacity_per_shard=memory, batch_size_per_shard=BATCH // 2,
            reset_env_every=MG_RESET, engine=engine)
        return agent, trainer

    for name, engine, cfg, kernel in MG_CASES:
        memory = MG_SMALL * (4 if engine == "ring" else 8)
        agent, card = make(cfg, engine, mesh, MG_SMALL, memory)
        cpu_agent, cpu = make(cfg, engine, cpu_mesh, MG_SMALL, memory)
        carry = card.init_carry(rng.PRNGKey(0))
        ref = cpu.init_carry(rng.PRNGKey(0))
        for a, b in zip(_tensors(carry), _tensors(ref)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{name}: the init carries differ")
        tick, cpu_tick = card.build_tick(), cpu.build_tick()
        for fn in kernels.values():
            fn.launches = 0
        dqn_mod.all_reduce_mean.calls = 0
        stats = dict(ties=0, charge_err=0.0, loss_err=0.0, param_err=0.0,
                     trained=0)
        for t in range(MG_COMPARE_TICKS):
            with torch.no_grad():
                for a, b in zip(_tensors(ref), _tensors(carry)):
                    a.copy_(b)
            q, slot = _pre_tick(torch, cpu_agent, ref, engine, MG_SMALL)
            carry, (_, _, loss) = tick(carry)
            ref, (_, _, cpu_loss) = cpu_tick(ref)
            _lockstep(torch, name, t, carry, ref, loss, cpu_loss, q, slot,
                      engine, MG_SMALL, stats)
        torch.cuda.synchronize()
        out["cases"][name] = dict(
            stats, launches={k: fn.launches for k, fn in kernels.items()},
            calls=dqn_mod.all_reduce_mean.calls,
            params=[p.detach().cpu() for p in carry[3].params.flat()])

    # the ring engine at MG_BIG envs a rank, timed
    agent, big = make(MG_CASES[0][2], "ring", mesh, MG_BIG, 100_000 // 2)
    carry = big.init_carry(rng.PRNGKey(0))
    tick = big.build_tick()
    for _ in range(WARMUP_TICKS):
        carry, _ = tick(carry)
    torch.cuda.synchronize()
    fused_tick.full_tick_fused_ring.launches = 0
    t0 = time.perf_counter()
    for _ in range(MG_BIG_TICKS):
        carry, (rewards, eps, loss) = tick(carry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (bool(torch.isfinite(loss)) and float(eps) < 1.0):
        raise AssertionError(f"6b big ring: loss {loss}, eps {eps}")
    size = 1 + sum(p.numel() for p in carry[3].params.flat())
    reduce_ms = []
    for d in (device, "cpu"):
        buf = torch.zeros(size, device=d)
        reduce_ms.append(host_ms(torch, lambda: dqn_mod.all_reduce_mean(
            [buf], mesh.group), MG_REDUCES))
    out["big"] = dict(
        launches=fused_tick.full_tick_fused_ring.launches,
        obs_per_s=MG_RANKS * MG_BIG * MG_BIG_TICKS / seconds,
        reduce_ms=reduce_ms[0], reduce_cpu_ms=reduce_ms[1])

    # 6c: a rank-local train state, saved and resumed on the card
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, f"rank{mesh.rank}.safetensors")
    shard = (mesh.rank, mesh.world_size)
    _, trainer = make(MG_CASES[0][2], "ring", mesh, MG_SMALL, 4 * MG_SMALL)
    tick = trainer.build_tick()
    carry = trainer.init_carry(rng.PRNGKey(1))
    for _ in range(MG_RESUME_AT):
        carry, _ = tick(carry)
    train_state_io.save(path, carry, shard=shard)
    for _ in range(MG_RESUME_AT):
        carry, _ = tick(carry)
    resumed = train_state_io.restore(
        path, trainer.init_carry(rng.PRNGKey(2)), shard=shard)
    for _ in range(MG_RESUME_AT):
        resumed, _ = tick(resumed)
    whole, again = list(_tensors(carry)), list(_tensors(resumed))
    if len(whole) != len(again) or any(not torch.equal(a, b) for a, b in zip(
            whole, again)) or _numbers(carry) != _numbers(resumed):
        raise AssertionError("6c: the resumed carry differs")
    out["resume_tensors"] = len(whole)

    # 6c: the trainer's chunk over gloo: eager rows, equal to eager ticks
    chunk = trainer.build_chunk(MG_RESUME_AT)
    if chunk.chunk.graphed:
        raise AssertionError("6c: a chunk over gloo would capture graphs")
    rows, ticks = (trainer.init_carry(rng.PRNGKey(3)) for _ in range(2))
    for _ in range(2):
        rows, _ = chunk(rows)
    for _ in range(2 * MG_RESUME_AT):
        ticks, _ = tick(ticks)
    if any(not torch.equal(a, b) for a, b in zip(
            _tensors(rows), _tensors(ticks))) or _numbers(rows) != _numbers(
            ticks) or not torch.equal(rows[0], ticks[0]):
        raise AssertionError("6c: the gloo chunk's rows differ from the "
                             "eager ticks")
    out["gloo_chunk_graphs"] = chunk.chunk.graphs
    return out


def _pre_tick(torch, agent, carry, engine, num_envs):
    """The CPU replica's Q-values of drone 0 before a tick (for the near
    ties) and where this tick's scalars land: the ring's read slot, or
    the replay's cursor."""
    step = carry[-1]
    if engine == "ring":
        nb = carry[1][1].shape[1] // num_envs
        slot = (step % nb) * num_envs
        obs = carry[1][1][:agent.obs_dim, slot:slot + num_envs].float()
    else:
        slot = carry[4].cursor
        obs = carry[2][:agent.obs_dim]
    with torch.no_grad():
        return agent.q_values_t(carry[3].params, obs), slot


def _lockstep(torch, name, t, carry, ref, loss, cpu_loss, q, slot, engine,
              num_envs, stats):
    """One tick of the card (``carry``) against the CPU replica (``ref``)
    from the same state; raises outside phase 3's limits."""
    tag = f"6b {name} tick {t}"
    if engine == "ring":
        nb = carry[1][1].shape[1] // num_envs
        write = ((t + 1) % nb) * num_envs
        obs_pairs = [(carry[1][1][:, write:write + num_envs],
                      ref[1][1][:, write:write + num_envs])]
        state_pairs = list(zip(carry[1][0], ref[1][0]))
        scalars = [(a[..., slot:slot + num_envs], b[..., slot:slot + num_envs])
                   for a, b in zip(carry[2], ref[2])]
    else:
        obs_pairs = [(carry[2], ref[2])]
        state_pairs = list(zip(carry[1], ref[1]))
        scalars = [(carry[4].storage[k][..., slot:slot + num_envs],
                    ref[4].storage[k][..., slot:slot + num_envs])
                   for k in ("actions", "rewards", "dones")]
    bad = torch.zeros(num_envs, dtype=torch.bool)
    for a, b in state_pairs + scalars:
        a = a.cpu()
        bad |= (a != b).reshape(-1, num_envs).any(0)
    for a, b in obs_pairs:
        a = a.float().cpu().reshape(-1, 6, num_envs)
        b = b.float().reshape(-1, 6, num_envs)
        ch = torch.arange(6) != 4
        bad |= (a[:, ch] != b[:, ch]).reshape(-1, num_envs).any(0)
        err = (a[:, 4] - b[:, 4]).abs()
        bad |= (err > CHARGE_ATOL).any(0)
        stats["charge_err"] = max(stats["charge_err"],
                                  float(err[:, ~bad].max()) if (~bad).any()
                                  else 0.0)
    if bad.any():
        acts = scalars[0]
        differs = (acts[0].cpu() != acts[1]).reshape(-1, num_envs)[0]
        top = q.topk(2, dim=0).values
        tie = (top[0] - top[1]) <= NEAR_TIE * q.abs().max(0).values
        if not bool((differs & tie)[bad].all()):
            envs = bad.nonzero().flatten()[:8].tolist()
            raise AssertionError(f"{tag}: envs {envs} differ from the CPU's "
                                 "outside a near tie")
        stats["ties"] += int(bad.sum())
    if _numbers(carry) != _numbers(ref) or not torch.equal(
            carry[0], ref[0]):
        raise AssertionError(f"{tag}: the step, rng or counts differ")
    loss, cpu_loss = float(loss), float(cpu_loss)
    if (loss < 0) != (cpu_loss < 0) or (cpu_loss >= 0 and abs(
            loss - cpu_loss) > 1e-5 * abs(cpu_loss)):
        raise AssertionError(f"{tag}: loss {loss} vs the CPU's {cpu_loss}")
    if cpu_loss >= 0:
        stats["trained"] += 1
        stats["loss_err"] = max(stats["loss_err"], abs(loss - cpu_loss) / max(
            abs(cpu_loss), 1e-30))
    if not torch.equal(carry[3].epsilon.cpu(), ref[3].epsilon):
        raise AssertionError(f"{tag}: epsilon differs")
    for net in ("params", "target_params"):
        for a, b in zip(getattr(carry[3], net).flat(),
                        getattr(ref[3], net).flat()):
            err = float((a.detach().cpu() - b.detach()).abs().max())
            stats["param_err"] = max(stats["param_err"], err)
            if err > 1e-5:
                raise AssertionError(f"{tag}: {net} differ by {err}")


def rank_nccl_probe():
    """An all-reduce over NCCL with this rank's card (both ranks on one)."""
    import torch

    buf = torch.ones(4, device="cuda")
    torch.distributed.all_reduce(buf)
    torch.cuda.synchronize()
    return float(buf[0])


def check_warm_start(torch, train, params, flags, name):
    """5b: the warm start the trainer makes (``train._warm_start``, the
    agent's init from --seed, ``state_with_params``) puts dqn-agent-3's
    params into the online and target nets on the card, bitwise."""
    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.agents.dqn import DQN
    from dronerl_tpu_torch.interop import safetensors_io
    from dronerl_tpu_torch.interop.from_jax import qnet_from_flax

    args = train.parse_args(LIFE_BASE + flags)
    config, warm = train._warm_start(args, train.agent_config_from_args(args))
    agent = DQN(config, params, "cuda")
    state = agent.init_state(rng.PRNGKey(args.seed))
    agent.state_with_params(state, qnet_from_flax(
        warm, agent.device, params.obs_shape, config.conv_specs()))
    src = safetensors_io.load_file(args.load_from_checkpoint)
    leaves = []
    for i in range(len(state.params.kernels)):
        leaves += [src[f"params.Dense_{i}.kernel"], src[f"params.Dense_{i}.bias"]]
    for net in (state.params, state.target_params):
        for p, want in zip(net.flat(), leaves):
            if not torch.equal(p.detach().cpu(), torch.from_numpy(want)):
                fail(f"5b {name}: the warm-started net is not dqn-agent-3's")
    log(f"5b {name}: the warm-started online and target nets on the card "
        f"equal dqn-agent-3's params bitwise "
        f"({sum(int(x.size) for x in leaves)} values)")


def cuda_ms(torch, fn, count):
    """Device time per call of ``fn`` over ``count`` calls, by CUDA
    events, after one warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(count):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def actor_ops(widths, scheme):
    """Operations of the Q forward of NUM_ENVS envs: (seconds at the peak
    rates with the layers but the last on the tensor cores, the first in
    ``scheme``'s products, seconds with every FLOP at PEAK_F32, FLOPs)."""
    flops = [NUM_ENVS * 2 * i * o for i, o in zip(widths, widths[1:])]
    tensor = FIRST_LAYER_PRODUCTS[scheme] * flops[0] / PEAK_BF16
    if len(flops) > 1:
        tensor += (HIDDEN_PRODUCTS * sum(flops[1:-1]) / PEAK_BF16
                   + flops[-1] / PEAK_F32)
    return tensor, sum(flops) / PEAK_F32, sum(flops)


def time_kernel(torch, _build, fused_tick, rng, agent, carry, hidden, card):
    """Time one tick's kernel on the main path's shapes after its run (ε =
    0: every env runs the greedy actor, the most work a tick can need):
    ``BLOCK_LAUNCHES`` launches of one prebuilt argument block (the
    kernel's time), wrapper calls (the wrapper's host work included) and
    the plain version; work out the kernel's bound."""
    params = agent.env_params
    _rng, (tstate, ring), _s, ag, _aux, _step = carry
    n, c = params.n_drones, params.num_cells
    eps = torch.tensor(0.0, device=ring.device)
    args = (rng.PRNGKey(7), tstate, ring, 0, NUM_ENVS, ag.params.flat(), eps,
            False, params)
    # _outs owns the block's output buffers: alive while it is launched.
    block, _outs = fused_tick._kernel_args(*args)
    lib = _build.load(fused_tick.kernel_config(params, ag.params.flat()))
    ms = time_block(torch, lib, "full_tick_ring_launch", block,
                    BLOCK_LAUNCHES)
    wrapper_ms = cuda_ms(torch,
                         lambda: fused_tick.full_tick_fused_ring(*args),
                         TIMED_LAUNCHES)
    plain_ms = cuda_ms(torch, lambda: fused_tick.full_tick_ring_plain(*args),
                       PLAIN_LAUNCHES)

    widths = (ring.shape[0], *hidden, 5)
    weight_bytes = 4 * sum(i * o + o for i, o in zip(widths, widths[1:]))
    state_bytes = NUM_ENVS * (c + n * (4 + 4 + 1 + 4))
    out_bytes = NUM_ENVS * n * (4 + 1 + 4)
    total_bytes = (2 * ring.shape[0] * NUM_ENVS * ring.element_size()
                   + 2 * state_bytes + out_bytes + weight_bytes + 4)
    hashes = NUM_ENVS * (4 + (n + 1) + 2 * c)
    t_actor, t_actor_f32, flops = actor_ops(
        widths, "bf16" if ring.element_size() == 2 else "f32")
    t_hash = OPS_PER_HASH * hashes / PEAK_F32
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = (t_actor + t_hash) * 1e3
    old_bound = max(t_bytes, (t_actor_f32 + t_hash) * 1e3)
    log(f"kernel net {hidden}: {ms:.4f} ms/launch ({BLOCK_LAUNCHES} launches "
        f"of one block), wrapper calls {wrapper_ms:.4f} ms/call, plain "
        f"{plain_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms (bytes "
        f"{total_bytes} -> {t_bytes:.4f} ms, ops {flops} FLOP with the "
        f"hidden layers on the tensor cores + {OPS_PER_HASH} x {hashes} hash -> "
        f"{t_ops:.4f} ms); all-CUDA-core bound {old_bound:.4f} ms; on {card}")
    return ms, plain_ms, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def time_chain_kernel(torch, _build, fused_tick, rng, cp, chain, carry,
                      engine, card):
    """B1 (``engine`` "ring", on the ring engine's bf16 ring) or B3
    ("full", on its f32 obs_t) with the actor ``chain``, after a drive,
    every env greedy (ε = 0): ``BLOCK_LAUNCHES`` launches of one prebuilt
    block, the plain version over ``PLAIN_LAUNCHES`` calls, and the bound:
    the observation read and written, the state, the weights; the chain's
    layers but the last at the tensor-core rate and the hashes."""
    device = carry[3].epsilon.device
    eps = torch.tensor(0.0, device=device)
    if engine == "ring":
        tstate, obs = carry[1]
        args = (rng.PRNGKey(7), tstate, obs, 0, NUM_ENVS, chain, eps, False,
                cp)
        fill, plain = fused_tick._kernel_args, fused_tick.full_tick_ring_plain
        entry, scheme = "full_tick_ring_launch", "bf16"
    else:
        tstate, obs = carry[1], carry[2]
        args = (rng.PRNGKey(7), tstate, obs, chain, eps, False, cp)
        fill, plain = fused_tick._full_args, fused_tick.full_tick_plain
        entry, scheme = "full_tick_launch", "f32"
    widths = fused_tick.chain_widths(chain)
    weight_bytes = 4 * sum(i * o + o for i, o in zip(widths, widths[1:]))
    t_actor, t_actor_f32, flops = actor_ops(widths, scheme)
    n, c = cp.n_drones, cp.num_cells
    obs_bytes = 2 * widths[0] * NUM_ENVS * obs.element_size()
    bound_args = (n, c, obs_bytes, weight_bytes + 4, flops,
                  4 + (n + 1) + 2 * c)
    log(f"{cp.wrapper} grid {cp.grid_size} chain {widths} {entry}: "
        f"all-CUDA-core bound {env_bound(*bound_args)[0]:.5f} ms")
    return time_env_kernel(
        torch, f"{entry} {cp.wrapper} grid {cp.grid_size} chain {widths}",
        _build.load(fused_tick.kernel_config(cp, chain)), entry, fill, plain,
        args, env_bound(*bound_args, flop_seconds=t_actor), card)


def hash_ops(rounds: int) -> int:
    """Integer operations of one Threefry-2x32 hash of ``rounds`` rounds:
    3 a round, 3 a key injection (one every 4 rounds), 4 to start and
    finish (OPS_PER_HASH at 20)."""
    return 3 * rounds + 3 * (rounds // 4) + 4


def env_bound(n, c, obs_bytes, extra_bytes=0, flops=0, hashes_per_env=0,
              flop_seconds=None, hash_ops_per_env=None, num_envs=NUM_ENVS):
    """The least time of one env kernel launch at ``num_envs`` envs: the state
    read and written once (ground C bytes, per drone x, y, carry, charge),
    the actions read (4 B a drone) and rewards and dones written (5 B a
    drone), ``obs_bytes`` of observations read or written, plus
    ``extra_bytes``; the operations: ``flops`` (at PEAK_F32, or in
    ``flop_seconds``) and the threefry hashes at OPS_PER_HASH each (or
    ``hash_ops_per_env`` operations an env, for hashes of other round
    counts). Returns (ms, "bytes" or "operations", bytes, operations)."""
    state_bytes = num_envs * (c + n * (4 + 4 + 1 + 4))
    io_bytes = num_envs * n * (4 + 4 + 1)
    total_bytes = 2 * state_bytes + io_bytes + obs_bytes + extra_bytes
    if hash_ops_per_env is None:
        hash_ops_per_env = OPS_PER_HASH * hashes_per_env
    ops = flops + hash_ops_per_env * num_envs
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    if flop_seconds is not None:
        t_ops += (flop_seconds - flops / PEAK_F32) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", total_bytes, ops)


def time_collect_kernel(torch, _build, fused_tick, rng, cp, chain, k, rounds,
                        part, tstate, obs, card):
    """A build of phase 3i on a fresh state, every env greedy (ε = 0): B1
    (``part`` "ring", a bf16 ring of two env-batches), B3 ("full") or B4
    ("tick", actions drawn on the card, ``chain`` None) with ``collect`` =
    k and ``rounds`` (rng_rounds, actor_rng_rounds), timed by
    ``time_env_kernel``. The bound: the observation's first row group read
    (B1, B3) and its k row groups written, the state, the weights; the
    actor's FLOPs as phase 4 counts them; the hashes at their rounds, 4 +
    2 C an env at rng_rounds (the keys, the spawn fields) and the actor's
    N + 1 at actor_rng_rounds."""
    import functools

    device = tstate.ground.device
    rr, ar = rounds
    n, c = cp.n_drones, cp.num_cells
    od = fused_tick.obs_rows(cp)
    obs = obs[:k * od]
    env_ops = (4 + 2 * c) * hash_ops(rr)
    tag = f"{part} {cp.wrapper} k={k} rounds {rounds}"
    if part == "tick":
        actions = rng.randint(rng.PRNGKey(8).to(device), (n, NUM_ENVS), 0, 5)
        kw = dict(collect=k, rng_rounds=rr)
        config = _build.env_config(cp, k, rr)
        ptxas = [ln.strip() for ln in _build.build_log(config).splitlines()
                 if "registers" in ln]
        log(f"B4 {tag}: block {fused_tick.env_block_shape(config)}; ptxas "
            f"{' | '.join(ptxas)}; hashes an env {4 + 2 * c} at {rr} rounds "
            f"({env_ops} operations)")
        return time_env_kernel(
            torch, f"B4 {tag}", _build.load(config),
            "tick_launch", functools.partial(fused_tick._env_tick_args, **kw),
            functools.partial(fused_tick.tick_plain, **kw),
            (rng.PRNGKey(7), tstate, actions, cp),
            env_bound(n, c, k * od * NUM_ENVS * 4,
                      hash_ops_per_env=env_ops), card)
    kw = dict(collect=k, rng_rounds=rr, actor_rng_rounds=ar)
    eps = torch.tensor(0.0, device=device)
    widths = fused_tick.chain_widths(chain)
    weight_bytes = 4 * sum(i * o + o for i, o in zip(widths, widths[1:]))
    if part == "ring":
        ring = torch.zeros((k * od, 2 * NUM_ENVS), dtype=torch.bfloat16,
                           device=device)
        ring[:, :NUM_ENVS] = obs.to(torch.bfloat16)
        args = (rng.PRNGKey(7), tstate, ring, 0, NUM_ENVS, chain, eps, False,
                cp)
        fill, plain = fused_tick._kernel_args, fused_tick.full_tick_ring_plain
        entry, scheme, size = "full_tick_ring_launch", "bf16", 2
    else:
        args = (rng.PRNGKey(7), tstate, obs, chain, eps, False, cp)
        fill, plain = fused_tick._full_args, fused_tick.full_tick_plain
        entry, scheme, size = "full_tick_launch", "f32", 4
    t_actor, _, flops = actor_ops(widths, scheme)
    actor_ops_ = (n + 1) * hash_ops(fused_tick.actor_rounds(rr, ar))
    bound = env_bound(n, c, (1 + k) * od * NUM_ENVS * size, weight_bytes + 4,
                      flops, flop_seconds=t_actor,
                      hash_ops_per_env=env_ops + actor_ops_)
    config = fused_tick.kernel_config(cp, chain, **kw)
    lib = _build.load(config)
    smem, blocks, scratch = fused_tick.kernel_occupancy(config, scheme == "bf16")
    ptxas = [ln.strip() for ln in _build.build_log(config).splitlines()
             if "registers" in ln]
    variant = fused_tick.tick_layout(cp, widths, scheme == "bf16")["variant"]
    log(f"{tag} chain {widths}: variant {variant}, {smem} B shared memory, "
        f"{scratch} B scratch a block, {blocks} blocks an SM; ptxas "
        f"{' | '.join(ptxas)}; hashes an env {4 + 2 * c} at {rr} rounds + "
        f"{n + 1} at {fused_tick.actor_rounds(rr, ar)} "
        f"({env_ops + actor_ops_} operations)")
    return time_env_kernel(
        torch, f"{entry} {tag} chain {widths}", lib, entry,
        functools.partial(fill, **kw), functools.partial(plain, **kw), args,
        bound, card)


def time_block(torch, lib, entry, block, count):
    """Device time per launch of a prebuilt argument block (CUDA events
    over ``count`` launches back to back): the wrapper's host work stays
    out of the kernel's time."""
    launch = getattr(lib, entry)
    stream = torch.cuda.current_stream().cuda_stream
    err = launch(ctypes.byref(block), stream)
    torch.cuda.synchronize()
    if err != 0:
        fail(f"{entry} failed: {err}")
    return cuda_ms(torch, lambda: launch(ctypes.byref(block), stream), count)


def time_env_kernel(torch, tag, lib, entry, fill, plain, args, bound,
                    card):
    """One env kernel's ms per launch (``BLOCK_LAUNCHES`` launches of the
    block that ``fill(*args)`` builds), its plain version's (``plain(*args)``)
    and ``bound``, ``env_bound``'s result: logged, and returned as the
    kernel line's timing keys."""
    # _outs owns the block's output buffers: alive while it is launched.
    block, _outs = fill(*args)
    ms = time_block(torch, lib, entry, block, BLOCK_LAUNCHES)
    plain_ms = cuda_ms(torch, lambda: plain(*args), PLAIN_LAUNCHES)
    bound_ms, bound_by, total_bytes, ops = bound
    log(f"{tag}: {ms:.4f} ms/launch ({BLOCK_LAUNCHES} launches of one "
        f"block), plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms "
        f"({bound_by}: {total_bytes} B, {ops} operations); on {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def time_obs_kernel(torch, _build, fused_tick, rng, agent, carry, hidden,
                    card):
    """B3 at the full engine's shapes after its run, as the engine launches
    it: the push into the run's StreamReplay (at its last push) and the
    next observation over a copy of the carry's, every env greedy (ε = 0,
    the most work a tick can need). The bound counts the push's bytes
    besides the tick's: the input observation read again and stored into
    the replay, and the action, reward and done of each column (9 B)."""
    import functools

    params = agent.env_params
    _rng, tstate, obs_t, ag, bstate, _step = carry
    obs_t = obs_t.clone()
    eps = torch.tensor(0.0, device=obs_t.device)
    widths = (obs_t.shape[0], *hidden, 5)
    weight_bytes = 4 * sum(i * o + o for i, o in zip(widths, widths[1:]))
    t_actor, _, flops = actor_ops(widths, "f32")
    n, c = params.n_drones, params.num_cells
    cols = obs_t.shape[-1]
    push_bytes = 2 * obs_t.numel() * 4 + 9 * cols
    bound_args = (n, c, 2 * obs_t.numel() * 4, weight_bytes + 4 + push_bytes,
                  flops, 4 + (n + 1) + 2 * c)
    log(f"B3 net {hidden}: all-CUDA-core bound "
        f"{env_bound(*bound_args)[0]:.5f} ms (the push's {push_bytes} B "
        "included)")
    push = (bstate.storage, bstate.storage["obs"].shape[-1] - cols)
    return time_env_kernel(
        torch, f"B3 net {hidden} with the push",
        _build.load(fused_tick.kernel_config(params, ag.params.flat())),
        "full_tick_launch",
        functools.partial(fused_tick._full_args, replay=push),
        functools.partial(fused_tick.full_tick_plain, replay=push),
        (rng.PRNGKey(7), tstate, obs_t, ag.params.flat(), eps, False,
         params),
        env_bound(*bound_args, flop_seconds=t_actor), card)


def time_env_tick(torch, _build, fused_tick, rng, tstate, params, card):
    """B4 on ``tstate`` (the fused engine's state after its run, or a fresh
    reset of another board), with actions drawn on the card."""
    n, num_envs = tstate.air_x.shape
    actions = rng.randint(rng.PRNGKey(8).to(tstate.ground.device),
                          (n, num_envs), 0, 5)
    c = params.num_cells
    obs_bytes = fused_tick.obs_rows(params) * num_envs * 4
    return time_env_kernel(
        torch, f"B4 grid {params.grid_size} drones {n}",
        _build.load(_build.env_config(params)), "tick_launch",
        fused_tick._env_tick_args, fused_tick.tick_plain,
        (rng.PRNGKey(7), tstate, actions, params),
        env_bound(n, c, obs_bytes, hashes_per_env=4 + 2 * c), card)


def time_step(torch, _build, step_kernel, core, rng, params, card):
    """B5 at NUM_ENVS envs on one board, from a fresh reset; its plain
    version is ``core.step_batch``."""
    device = torch.device("cuda", 0)
    n, c = params.n_drones, params.num_cells
    states = core.reset_batch(rng.PRNGKey(10).to(device), params, NUM_ENVS)
    actions = rng.randint(rng.PRNGKey(11).to(device), (NUM_ENVS, n), 0, 5)
    return time_env_kernel(
        torch, f"B5 grid {params.grid_size} drones {n}",
        _build.load(_build.env_config(params)), "step_launch",
        step_kernel._kernel_args, step_kernel.step_batch_plain,
        (rng.PRNGKey(12), states, actions, params),
        env_bound(n, c, 0, hashes_per_env=4 + 2 * c), card)


def step_obs_params(wrapper="window"):
    """The bench's board (grid 9, 4 drones, radius 3) with ``wrapper``'s
    observation."""
    from dronerl_tpu_torch.env.types import EnvParams
    return EnvParams(grid_size=GRID, n_drones=DRONES, window_radius=RADIUS,
                     wrapper=wrapper)


def step_observation(torch, card):
    """Phase 3j: B5 with the jnp engine's observation
    (``step_kernel.step_batch_fused`` with ``collect`` = k) against its
    plain version (``step_batch_plain``: ``core.step_batch`` and
    ``observe_batch``) at STEP_OBS_ENVS envs, window and global,
    STEP_OBS_K drones collected, STEP_OBS_TICKS ticks of random actions
    each (the step key as a chunk row's int32 words on the card and as a
    host key, in turns): state, rewards and dones bitwise, the (E, k, OBS)
    observation bitwise but the charge channel (within CHARGE_ATOL); one
    launch a call; episodes end. Then the window build at k = 1 (the CLI's)
    timed over BLOCK_LAUNCHES launches of a prebuilt block at
    STEP_OBS_TIMED envs beside its plain version and bound. Returns the
    kernel line's entry but its launches."""
    from dronerl_tpu_torch import rng
    from dronerl_tpu_torch.env import core
    from dronerl_tpu_torch.ops import _build, fused_tick, step_kernel

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    err, ends, cases = 0.0, 0, 0
    for wrapper in ("window", "global"):
        cp = step_obs_params(wrapper)
        for num_envs in STEP_OBS_ENVS:
            for k in STEP_OBS_K:
                tag = f"3j B5 + obs {wrapper} {num_envs} envs k {k}"
                states = core.reset_batch(rng.PRNGKey(num_envs + k).to(
                    device), cp, num_envs)
                key = rng.PRNGKey(30 + k)
                for t in range(STEP_OBS_TICKS):
                    key, act_key, step_key = rng.split(key, 3)
                    words = ((step_key.to(device) & rng.MASK32).to(
                        torch.int32) if t % 2 else step_key)
                    actions = rng.randint(act_key.to(device),
                                          (num_envs, DRONES), 0, 5)
                    before = step_kernel.step_batch_fused.launches
                    out_k = step_kernel.step_batch_fused(
                        words, states, actions, cp, k)
                    out_p = step_kernel.step_batch_plain(
                        step_key, states, actions, cp, k)
                    torch.cuda.synchronize()
                    if step_kernel.step_batch_fused.launches != before + 1:
                        fail(f"{tag} tick {t}: not one launch")
                    for name in ("ground", "air_x", "air_y",
                                 "carrying_package", "charge"):
                        if not torch.equal(getattr(out_k[0], name),
                                           getattr(out_p[0], name)):
                            fail(f"{tag} tick {t}: state {name} differs")
                    for name, i in (("rewards", 1), ("dones", 2)):
                        if not torch.equal(out_k[i], out_p[i]):
                            fail(f"{tag} tick {t}: {name} differ")
                    obs_k, obs_p = (o.reshape(num_envs, k, -1, 6)
                                    for o in (out_k[3], out_p[3]))
                    if obs_k.shape != obs_p.shape:
                        fail(f"{tag}: observation {tuple(out_k[3].shape)}")
                    ch = torch.arange(6, device=device) != 4
                    if not torch.equal(obs_k[..., ch], obs_p[..., ch]):
                        fail(f"{tag} tick {t}: observation channels differ")
                    err = max(err, float((obs_k[..., 4] - obs_p[..., 4])
                                         .abs().max()))
                    if err > CHARGE_ATOL:
                        fail(f"{tag} tick {t}: charge channel off by {err}")
                    ends += int(out_k[2].sum())
                    states = out_k[0]
                cases += 1
    if ends == 0:
        fail("3j: no episode ended")
    log(f"3j B5 with the observation == core.step_batch + observe_batch: "
        f"{cases} cases (envs {STEP_OBS_ENVS}, window and global, k "
        f"{STEP_OBS_K}) x {STEP_OBS_TICKS} ticks, {ends} drone episode "
        f"ends; all bitwise but the charge channel (max err {err:.3e}); one "
        f"launch a call; on {card}")

    cp = step_obs_params()
    n, c = cp.n_drones, cp.num_cells
    lib = _build.load(_build.env_config(cp, 1))
    timed = {}
    for num_envs in STEP_OBS_TIMED:
        states = core.reset_batch(rng.PRNGKey(10).to(device), cp, num_envs)
        actions = rng.randint(rng.PRNGKey(11).to(device), (num_envs, n), 0,
                              5)
        obs_bytes = num_envs * fused_tick.obs_rows(cp) * 4
        timed[num_envs] = time_env_kernel(
            torch, f"3j B5 + obs grid {GRID} drones {n} {num_envs} envs",
            lib, "step_launch",
            lambda *a: step_kernel._kernel_args(*a, 1),
            lambda *a: step_kernel.step_batch_plain(*a, 1),
            (rng.PRNGKey(12), states, actions, cp),
            env_bound(n, c, obs_bytes, hashes_per_env=4 + 2 * c,
                      num_envs=num_envs), card)
    log(f"phase 3j took {time.perf_counter() - t_phase:.1f} s on {card}")
    return {
        "name": "step_observe",
        "route": "cuda",
        "source": "dronerl_tpu_torch/ops/csrc/env_kernel.cu",
        "replaces": ("dronerl_tpu/ops/step_kernel.py:186 (_step_kernel via "
                     "step_batch_fused), with the jnp engine's observation "
                     "that XLA fuses after it (dronerl_tpu/train.py:158)"),
        "launches": 0,
        "max_abs_err": err,
        **timed[1],
        "library_ms": None,
        "cases": {f"{e} envs": t for e, t in timed.items()},
    }


def learner_bound(widths, batch, sync):
    """The least time of one learner step on the card: each parameter
    read as params, target, mu and nu and written as params, mu, nu (and
    target with ``sync``), the batch read once, the loss written; the
    operations of two forwards, the backward and the Adam pass."""
    io = [i * o for i, o in zip(widths, widths[1:])]
    p = sum(io) + sum(widths[1:])
    total_bytes = (4 * p * (7 + sync) + 2 * widths[0] * batch * 4
                   + 3 * batch * 4 + 4)
    flops = (batch * (2 * 2 * sum(io) + 2 * sum(io) + 2 * sum(io[1:]))
             + (ADAM_OPS + SYNC_OPS * sync) * p)
    t_bytes = total_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", total_bytes, flops)


def device_ms(torch, fn, count, name=None):
    """Device time per call of ``fn`` from the profiler's CUDA events
    (those whose name holds ``name``, or all), and launches per call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in ev.name)]
    total_us = sum(ev.time_range.elapsed_us() for ev in events)
    return total_us / (1e3 * count), len(events) / count


def host_ms(torch, fn, count):
    """Host wall time per call over ``count`` calls ending in a
    synchronise (the host's issue time where the host is the slower)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / count * 1e3


def time_learner(torch, learner_kernel, agent, carry, batch, card):
    """Time the learner kernel at the main path's shapes (learn, and learn
    + sync), its plain version, and the autograd learner (train_step_t +
    apply_schedules, a sync tick) on the same batch, on copies of the
    main path's final state; work out the kernel's bound.

    The wrapper's checks and argument block take longer on the host than
    the kernel on the card, so back-to-back wrapper calls time the host.
    The kernel's time is taken over launches of one prebuilt argument
    block (CUDA events, ``LEARNER_LAUNCHES`` back to back), beside the
    profiler's kernel duration and the wrapper's host time per call."""
    import ctypes

    from dronerl_tpu_torch.ops import _build

    cfg = agent.config
    widths = (agent.obs_dim, *cfg.hidden_layers, 5)

    def operands(st, sync):
        return ((batch, st.params, st.target_params, st.opt_state.mu,
                 st.opt_state.nu, st.opt_state.count),
                dict(learn=True, sync_target=sync, decay_eps=False,
                     epsilon=None, gamma=cfg.gamma, lr=cfg.learning_rate,
                     tau=cfg.tau, eps_decay=1.0, eps_end=0.0,
                     b1=0.9, b2=0.999, adam_eps=1e-8))

    times = {}
    lib = _build.load(learner_kernel.kernel_config(carry[3].params))
    stream = torch.cuda.current_stream().cuda_stream
    for sync in (False, True):
        st = copy.deepcopy(carry[3])
        args, kw = operands(st, sync)
        block, _loss = learner_kernel._learner_args(*args, **kw)
        err = lib.td_adam_launch(ctypes.byref(block), stream)
        if err != 0:
            fail(f"learner launch failed: {_build.error_string(lib, err)}")

        def launch():
            lib.td_adam_launch(ctypes.byref(block), stream)

        times[("kernel", sync)] = cuda_ms(torch, launch, LEARNER_LAUNCHES)
        times[("profiled", sync)] = device_ms(
            torch, launch, PROFILED_CALLS, "td_adam")[0]
        times[("wrapper_host", sync)] = host_ms(
            torch, lambda: learner_kernel.td_adam(*args, **kw),
            LEARNER_LAUNCHES)
        times[("plain", sync)] = cuda_ms(
            torch, lambda: learner_kernel.td_adam_plain(*args, **kw),
            LEARNER_PLAIN_LAUNCHES)

    # An empty launch of the same cluster and shared memory.
    lib.td_adam_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    times["empty"] = cuda_ms(
        torch, lambda: lib.td_adam_empty_launch(BATCH, stream),
        EMPTY_LAUNCHES)

    st = copy.deepcopy(carry[3])

    def autograd_step():
        agent.apply_schedules(agent.train_step_t(st, batch)[0], 0,
                              torch.tensor(False, device=batch["obs"].device))

    autograd_host = host_ms(torch, autograd_step, LEARNER_PLAIN_LAUNCHES)
    autograd_device, autograd_launches = device_ms(torch, autograd_step,
                                                   PROFILED_CALLS)

    bound_ms, bound_by, total_bytes, flops = learner_bound(widths, BATCH,
                                                           False)
    sync_bound = learner_bound(widths, BATCH, True)
    log(f"learner kernel net {cfg.hidden_layers}: learn / learn + sync "
        f"{times[('kernel', False)]:.5f} / {times[('kernel', True)]:.5f} "
        f"ms/launch (CUDA events, {LEARNER_LAUNCHES} launches); profiled "
        f"kernel {times[('profiled', False)]:.5f} / "
        f"{times[('profiled', True)]:.5f} ms; wrapper host "
        f"{times[('wrapper_host', False)]:.5f} / "
        f"{times[('wrapper_host', True)]:.5f} ms/call; plain "
        f"{times[('plain', False)]:.5f} / {times[('plain', True)]:.5f} ms; "
        f"bound {bound_ms:.6f} ms ({bound_by}: {total_bytes} B, {flops} "
        f"FLOP; with sync {sync_bound[0]:.6f} ms); an empty launch of its "
        f"{learner_kernel.CLUSTER}-CTA cluster {times['empty']:.5f} ms; "
        f"autograd learner "
        f"(train_step_t + apply_schedules) host {autograd_host:.4f} ms, "
        f"device {autograd_device:.4f} ms in {autograd_launches:.1f} "
        f"launches; on {card}")
    return {"ms": times[("kernel", False)],
            "plain_ms": times[("plain", False)],
            "bound_ms": bound_ms, "bound_by": bound_by}


if __name__ == "__main__":
    main()
