#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

It drives the port's main path, the paper's own loop: compile an ISAMIR
program against the modeled GPU (``gpu_sm(8)``), tune it on the card, and
launch the hand-written CUDA kernels with the plan.

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all at once).
3. ``compile``: the main path's compiles (the 8 GEMMs, the 5 GRU
   projections and the 5 GRU cells) through the strict pipeline, whose
   ``VerifyPass`` checks each schedule before Lower (the line counts the
   compiles it let through), into a fresh ``ArtifactCache`` under
   ``build/repro_torch/`` that stays the default for the run; each fresh
   artifact is checked again by ``verify_artifact``.  A second pass with the in-process memo cleared and
   the cache read back from its file must compile nothing fresh and give
   the same artifacts (``to_dict`` but ``meta``).
   Then the graph tier's compiles: whisper-medium's decoder block (one
   layer at full width: D = 1024, 16 heads of 64, F = 4096; T = 8) and its
   trace config (D = 32), each unfused and fused (``fuse_epilogues``),
   traced and compiled with ``compile_graph`` against ``gpu_sm(8)`` through
   the same strict pipeline into the same cache; a second pass with the
   memo cleared must compile nothing fresh (``graph_compile`` line).
   Then the conv frontend's: seven of ResNet-50's inner layers at minibatch
   28 (``RESNET_LAYERS``) through ``compile_conv`` against ``gpu_sm(8)``,
   the same pipeline and cache, and again from the file with the memo
   cleared (``conv_compile`` lines: calls, transform steps, lowering, the
   fused GEMM (m, n, k) of a one-call selection, seconds).
4. Nine phases, each with every launch counter set to 0 just before it
   and read just after (one ``launches`` line each):

   * ``plan`` — with an empty tuning cache as the default, so the tile is
     the compiler's: the 8 DeepBench GEMMs (paper Fig. 3) in f32 and in
     bf16 through ``scheduled_gemm`` (K1), then for each of the 4
     DeepBench GRU sizes (paper Fig. 4; E = H, T = 128), in f32 and in
     bf16, one K3 step at the tile of the compiler's GRU plan
     (``gru_cell`` at ``gru_tile``) and the sequence through ``FusedGRU``
     (K4 on its persistent route: K2's launch projects the input of all
     128 steps at ``plan_gemm``'s tile, storing G in f32, then one
     persistent kernel runs the recurrence); each such sequence must
     launch exactly one K2 and one persistent kernel, and no K3; then one
     f32 sequence at B = 8, E = 512, H = 10240, T = 4, wider than the
     persistent kernel can place, which must take the step route: T
     launches of K3 at the compiler's GRU tile and no K2 or persistent
     kernel;
   * ``tune`` — the port's tuner (``python -m repro_torch.search.tune
     --suite gemm --backend measure --target gpu_sm --trials 8``) on the 8
     GEMMs, K1 timed on the card, into a fresh cache file under
     ``build/repro_torch/``; one ``tune`` line per case;
   * ``tuned`` — with that cache as the default: ``scheduled_gemm`` on the
     8 GEMMs in f32 and bf16 (K1 at the tuned tile), and ``gemm_bias_act``
     (K2, ``tile=None``: the tuned tile) on the 8 GEMMs x {"", sigmoid,
     tanh, relu} x {f32, bf16} with bias uniform(-1, 1);
   * ``graph`` — the four compiled blocks run on the card
     (``CompiledGraph.execute``) on the tracer's ternary inputs
     (``block_inputs``): each ``pallas_gpu_gemm`` node is one K1 launch at
     the compiled plan's tile (``simt``, f32), each other node runs its
     program through ``interpret_program`` in float64 on the card; K1's
     launches must equal the graph's ``pallas_gpu_gemm`` nodes;
   * ``learned`` — the learned cost model (``search.model.train_suites`` on
     the ``gemm`` and ``conv`` tuner suites against ``gpu_sm(8)``, a fresh
     tuning cache and a fresh model store under ``build/repro_torch/``;
     ``learned_train`` lines) made the process default; then for the
     fused GEMM of each one-call (1x1) ResNet layer, in f32 and bf16, with
     the tuning cache missing the shape and the model predicting a block,
     K1 through ``gemm(a, b)`` with no tile (``tuned_block``'s model
     branch picks it), and K1 at that tile timed (20 calls).  The store is
     deactivated afterwards;
   * ``serve`` — the model zoo's serving path, which runs no K1-K4 (the JAX
     models reach no Pallas kernel: their products are ``jnp.dot`` and
     ``jnp.einsum``, and the port's are ``torch.matmul`` and
     ``torch.einsum``), so every count of its ``launches`` line is 0.  Each
     run of ``SERVE_RUNS`` builds its model with ``build_model`` on the
     card, draws its weights with ``init`` from a CUDA ``torch.Generator``
     (f32 parameters; Mixtral's experts then perturbed, one from another),
     and serves a batch (tokens uniform over the vocabulary; whisper's 1500
     frames uniform(-1, 1)) through ``launch.serve.generate`` in bf16
     activations, then the same weights under the f32 activation config
     (``cfg.scaled(dtype="float32")``).  The runs: qwen2-7b at its full
     config, 4 x 16 tokens -> 16 and 4 x 4096 -> 16 (the query-chunked
     prefill: 2 chunks of 2048); mixtral-8x7b at full width, 2 of its 32
     layers; whisper-medium at its full config; xlstm-1.3b at its published
     config in f32 only, 4 x 16 -> 16 (a recurrent prefill and a 2.8 GB f32
     state, no KV cache), and at full width cut to 4 layers at 3:1 in
     both dtypes; jamba-1.5-large at full width, 2 of its 72 layers (one
     Mamba layer with its dense FFN, one attention layer with its
     16-expert MoE), 4 x 16 -> 16.  One ``serve`` line per
     run: event-timed prefill and decode per token (``generate``'s
     ``record``), the cast of the weights (once per ``generate``), tokens a
     second over ``generate``'s wall time, ``max_memory_allocated``, the
     parameters' bytes, the bounds, and the gates; in bf16 also a profiler
     trace of 4 decode steps (device time against event time).  Then the
     CLI, ``python -m repro_torch.launch.serve --arch qwen2-7b`` and
     ``--arch xlstm-1.3b``, run in process on the card (``serve_cli``
     lines);
   * ``train`` — the training path, which runs no K1-K4 either (the JAX
     package differentiates its plain models: no Pallas kernel, no custom
     gradient), so its ``launches`` line is all zeros.  ``train_parity``:
     olmo-1b at full width cut to 2 of its 16 layers, B = 2, T = 128, one
     seeded init drawn on the CPU and copied to the card, two
     ``make_train_step`` steps on each with TF32 off, in f32 and in bf16
     activations (one line each: losses, grad norms, the largest parameter
     difference after each step and the count of elements beyond 1e-6),
     then one AdamW step on the card's parameters, moments and gradient
     against the same step on the CPU from copies of them
     (``adamw_parity``).
     ``train``: olmo-1b at its published config (bf16 activations, f32
     parameters and AdamW state, remat), B = 8, T = 2048, through
     ``launch.train.build_trainer``'s step on ``SyntheticLM`` batches: 2
     warm-up and 8 event-timed steps, 2 more under ``torch.profiler`` (the
     device's busy share, the library GEMMs' device time, the top
     kernels), then AdamW alone (``apply_updates``, event-timed); step time
     median and spread, tokens a second, ``mfu`` (model FLOPs a step, 6 N
     tokens + 12 L T d tokens, over 989 TFLOP/s), the bound as run (remat
     repeats the forward: 4/3 of it), AdamW against its 28 bytes a
     parameter, peak memory, every loss and grad norm; no checkpoint (one
     is 20.5 GB).  ``train_families``: one f32 step of each arch's smoke
     config on the card against the CPU, then ``adamw_parity``.
     ``train_cli``: ``python -m repro_torch.launch.train --arch olmo-1b
     --smoke --steps 12 --batch 4 --seq 64`` on the card, in PyTorch's default mode (in process) and
     under ``torch.use_deterministic_algorithms`` (in a child process
     whose ``CUBLAS_WORKSPACE_CONFIG`` is ``:4096:8``; this process keeps
     cuBLAS's default, as the variable slows its calls): uninterrupted,
     with ``--save-every 4 --inject-fault-at 6``, and again with
     ``--resume``.
   * ``train_placed`` — the train phase's olmo-1b (published config, B 8 x
     T 2048, bf16, remat) on a one-rank NCCL process group (a
     ``FileStore`` under ``build/repro_torch/``) and its (1, 1)
     ``DeviceMesh``: ``build_trainer`` places the parameters and AdamW
     moments as DTensors and runs the step under the activation rules and
     ``implicit_replication``; ``PLACED_STEPS`` steps of the train phase's
     seed and batches under the profiler, each loss held to the ``train``
     line's same step (``PLACED_TOL`` relative; ``bit_equal`` says whether
     they are the same bits), step times beside ``train``'s, the busy
     share and peak memory; then a checkpoint of the placed state (20.5
     GB, written under ``build/repro_torch/`` and deleted) restored into
     an unplaced trainer, every parameter, moment and the step equal to
     the bit.  No K1-K4 run there.
   * ``dryrun`` — ``repro_torch.launch.dryrun.run_cell`` on the host (a
     ``fake`` process group of 512 ranks, each step traced under
     ``FakeTensorMode``) for ``DRYRUN_CELLS`` at their published configs:
     one line a cell with its seconds, FLOPs, bytes, collectives, memory,
     roofline terms on ``gpu_sm`` and ``model_flops_ratio``; no K1-K4.

   K1 and K2 run on the main loop their dtype and K take (``wgmma``: bf16
   after one transposing pass of B; ``simt``: f32), with split-K where the
   tiles are fewer than the SMs; the ``launches`` lines also count the
   transposing passes (``gemm_transpose``) and split-K reduces
   (``gemm_reduce``), and K3's split-step reduces (``gru_cell_reduce``).

5. Holds each output against the plain PyTorch version on the same inputs,
   and times the kernel (its whole launch sequence), the plain version and
   one PyTorch library call computing the same function with CUDA events
   (inputs repeated, so L2 is warm where they fit in it).  One JSON line
   per case, with the launch (route, split, threads, shared memory, grid)
   and the registers and spills ``-Xptxas -v`` reported for the main loop's
   instantiation.  The ``gemm`` lines also give the device time of each
   kernel of K1's launch sequence (transposing pass, main loop, reduce)
   from a ``torch.profiler`` trace of 5 calls (``device_ms``).  The
   ``tuned_gemm`` lines time K1 at the tuned tile beside K1 at the plan
   tile.  The ``gru`` lines give, per size: K3's split, grid and copy
   route; K4's launches per sequence, its projection's tile and the
   persistent launch (blocks, columns a block, k-lanes, dynamic shared
   memory, rows and bytes of U kept in shared memory); registers and
   spills of both kernels; and device time by kernel from a profiler trace
   (``step_device_ms``: K3's step and reduce; ``seq_device_ms``: K4's
   projection, recurrence and the rest: packing copies and a memset).  The
   ``gru_bf16`` lines give the same for the bf16 step and sequence, beside
   ``torch.gru_cell`` and cuDNN's ``nn.GRU`` in bf16; the ``gru_step_route``
   line times the wide f32 sequence.  One ``graph`` line per compiled block:
   its nodes, K1 launches and stream nodes; every tensor it produced held
   against the torch float64 reference (``models.traceable.
   block_reference``, on the card): bit-exact where the reference's
   magnitude stays below 2^24, else within rtol 1e-5 and atol 1e-5 *
   max|ref| (the trace config must be bit-exact throughout); ``execute``
   event-timed (5 calls), and split by node kind (``node_ms``: each node
   rerun alone, event-timed, summed over the K1 nodes and the stream
   nodes), K1's and the rest's device time in one call (profiler), the
   reference's time, and the same block in eager torch f32
   (``torch.matmul``, TF32 off) as the library yardstick.  One
   ``learned_gemm`` line per extracted GEMM and dtype: the model's block,
   its CUDA tile and launch, the host time of one prediction
   (``predict_ms``), K1 at the model's tile (``learned_ms`` inside the
   phase, ``learned_ms_2`` between two runs at the compiler's plan tile),
   K1 at the plan tile (``plan_ms``, ``scheduled_gemm``'s tile), and
   ``torch.matmul`` in the same dtype.  One ``recurrent`` line per
   DeepBench GRU size (host only): ``schedule_recurrent`` of the GRU cell
   on ``gpu_sm(8)``, its copies per stream, the bytes of U the recursive
   stream copies, the makespans and ``total_time(128)``, beside K4's
   partition (bytes of U it keeps in shared memory, f32 and bf16) and the
   f32 sequence time of this run.
6. Prints the ``kernels`` line and, last, the device line.  Exits non-zero,
   before the device line, when a comparison fails, a kernel of a phase was
   never launched in it, a bf16 DeepBench GEMM did not take the wgmma route
   or a launch with fewer tiles than SMs did not split K, a K3 step at a
   DeepBench size launched fewer blocks than the card has SMs, a DeepBench
   K4 sequence launched other than one K2 and one persistent kernel or the
   wide one other than its T K3 steps, a compile failed verification or
   the second compile pass compiled anything fresh or gave another
   artifact, or the tuner failed or wrote fewer than 8 ``measure``
   records, or a block's K1 launches differ from its GEMM nodes or a
   tensor of it disagrees with the reference, or no matmul model was
   trained, or an extracted GEMM hit the tuning cache, got no prediction
   or disagreed with its plain version, or a serve run failed a gate (decode
   against teacher forcing, greedy against the teacher's argmax, finite)
   or the CLI returned no (4, 16) tokens on the card, or a train gate
   failed (the card's f32 loss or grad norm off the CPU's by more than
   rtol 1e-5, in ``train_parity`` and each ``train_families`` arch, or the
   bf16 loss by more than 1e-2; the card's AdamW step off the CPU's by
   more than ``ADAMW_TOL`` in any element; in f32 ``train_parity`` more
   than ``PARAM_FLIP_SHARE`` of the parameters further apart than 1e-6; a
   full-config loss or grad norm not finite or the last loss not below the
   first; in either mode a CLI run that fails other than by the injected
   fault, the fault run not failing with it, the resumed run not printing
   "resumed from step 4" or its losses for steps 4-11 not equal to the
   uninterrupted run's), or a ``train_placed`` loss off the ``train``
   phase's same step by more than ``PLACED_TOL`` relative or a restored
   tensor not equal to the placed one, or a ``dryrun`` cell not ``ok``,
   with no FLOPs or collective bytes, or with one rank's parameter or
   moment bytes other than the rules' shard shapes give; when there is no
   card it prints nothing and exits 1.

Inputs: uniform(-1, 1) from ``np.random.default_rng(seed)``; the GRU
weights are uniform(-1/sqrt(H), 1/sqrt(H)), PyTorch's own GRU init.
Tolerances: GEMM f32 rtol 1e-5 and atol 1e-5 * max|want| — sums of up to
2560 products taken in another order than the plain version's (cuBLAS), so
the error scales with the outputs' magnitude (up to ~80 here); K2 f32 the
same with max|A @ B + bias|, the activation's input; GEMM and K2 bf16
rtol = atol = 2e-2 (``tests/test_kernels.py``); one GRU step (K3) rtol =
atol = 1e-5 and the GRU sequence rtol 1e-4, atol 1e-5
(``tests/test_kernels.py``); bf16 GRU steps and sequences rtol = atol =
2e-2, JAX's bf16 tolerance.  Serving (``SERVE_TOL``): every step's logits
from ``generate`` against ``logits`` of the prompt plus the generated
tokens (teacher forcing) within 1e-3 * max|teacher| under the f32
activation config (``tests/test_models.py``'s tolerance for the attention
archs) and 5e-2 * max|teacher| in bf16 (the two paths multiply at other
shapes, so cuBLAS sums in other orders, and bf16 rounds the residual stream
after every layer); each greedy token equal to the teacher's argmax wherever
the teacher's top-2 margin exceeds that tolerance; every logit finite.
With MoE layers in bf16, a position whose experts differ between the two
paths in some layer (a near tie of router probabilities that rounding
breaks the other way) is counted (``rerouted_positions``) and held to
neither of the first two gates, and at least half the positions must be
held: the first card run found one such position, at 7.9% of
max|teacher|, where every other position was within 1.6%.  xLSTM's bf16
decode is gated at 4 of its 48 layers: with random weights it leaves the
chunkwise teacher by 4.4e-2 at 8 layers in the JAX package too.
Bounds: the larger of bytes (each input read once, each output written
once) over 3.35 TB/s and operations (2mnk for a GEMM) over 67 TFLOP/s (f32,
CUDA cores) or 989 TFLOP/s (bf16) — NVIDIA H100 SXM data-sheet peaks at
700 W; a block's bound counts its inputs and output and its GEMMs' 2mnk.  K2's library call is ``torch.addmm(bias, A, B)`` followed by the
activation's torch op: two launches where there is an activation.  In the
``kernels`` line each time sums that kernel's calls over the main path's
shapes, one call per shape (for K3, one step; K1 at the tuned tile; K3
and K4 in f32 and bf16 at the DeepBench sizes), and ``launches`` sums the
seven phases.  A serve run's bounds (``serve_bounds``): for the prefill and
for one decode step, the larger of the bytes the function must move (the
weights it needs once in the activation dtype, top_k experts a token, the
KV cache, the recurrent state) over 3.35 TB/s and its operations (2 x the
parameters a token meets outside the embedding table x the tokens, plus
the full square of attention scores the model computes) over the peak;
beside them the bounds of the work as run (every expert, xLSTM's prefill
as T decode steps).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BW = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
GEMM_SIZES = [(1024, 128, 1024), (2048, 64, 2048), (1760, 128, 1760),
              (2560, 64, 2560), (5124, 700, 2048), (3072, 128, 1024),
              (35, 700, 2048), (7680, 1, 2560)]
GRU_SIZES = [(32, 512), (32, 1024), (16, 1536), (32, 1792)]
STEPS = 128
SHORT_STEPS = 2        # a sequence too short for an error to fade from h
#: (B, E, H, T) of the sequence wider than K4's persistent kernel places
#: (f32 on an H100: H > 9504), which takes the step route
WIDE_GRU = (8, 512, 10240, 4)
ACTS = ("", "sigmoid", "tanh", "relu")
TUNE_TRIALS = 8
GEMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
GRU_TOL = (1e-4, 1e-5)
CELL_TOL = (1e-5, 1e-5)
BF16_TOL = (2e-2, 2e-2)
#: the graph phase: whisper-medium's decoder block (the one config of
#: ``configs/`` whose head dim, 64, is the power of four ``trace_block``
#: needs at full width) at the graph tier's default sequence length
GRAPH_ARCH = "whisper-medium"
GRAPH_SEQ = 8
#: below it an f32 tensor of integers is exact, and so is every sum that
#: builds it; above it K1's f32 sums round where the reference's do not
EXACT_BOUND = float(1 << 24)
#: rtol, and atol as a share of max|ref|, for tensors above EXACT_BOUND:
#: K1's f32 sums of up to 4096 products differ from float64 by a few parts
#: in 10^7 of max|ref| (the graph lines' max_err_over_max_ref), so 1e-5
#: leaves a margin of about 20x
GRAPH_TOL = (1e-5, 1e-5)
#: the kernels of K1's launch sequence, by name in a profiler trace
K1_KERNELS = {"k1": ("simt_kernel", "wgmma_kernel", "reduce_kernel",
                     "transpose_kernel")}
#: ResNet-50's inner layers at minibatch 28 (``benchmarks/bench_resnet.py``,
#: paper Fig. 5): (name, H, W, kh, kw, cin, cout, stride); conv2_3x3 and
#: conv3_3x3 are left out for time (14112 and 3528 calls to schedule)
RESNET_BATCH = 28
RESNET_LAYERS = [
    ("conv2_1x1a", 56, 56, 1, 1, 64, 64, 1),
    ("conv2_1x1b", 56, 56, 1, 1, 64, 256, 1),
    ("conv3_1x1b", 28, 28, 1, 1, 128, 512, 1),
    ("conv4_3x3", 14, 14, 3, 3, 256, 256, 1),
    ("conv4_1x1b", 14, 14, 1, 1, 256, 1024, 1),
    ("conv5_3x3", 7, 7, 3, 3, 512, 512, 1),
    ("conv5_1x1b", 7, 7, 1, 1, 512, 2048, 1),
]
#: the learned phase's training suites and K1's timed calls a shape
LEARNED_SUITES = "gemm,conv"
LEARNED_REPS = 20
#: the GRU's weights the recurrent schedule copies each step
U_BUFFERS = ("Ur", "Uz", "Un")
#: the serve phase's runs: (name, arch, config overrides, batch, prompt
#: length, tokens generated).  Mixtral keeps 2 of its 32 layers (32 layers
#: of f32 parameters are 187 GB) and takes capacity_factor = E / top_k = 4,
#: with which no token can be dropped: at the config's 1.25 a 4-token decode
#: step has a capacity of 1 a expert and drops tokens that the prefill of
#: the same sequence keeps, so decode could not match teacher forcing.
#: Jamba keeps 2 of its 72 layers with attn_period 2 (one macro-block of
#: 8 layers is 45.1 G parameters, 180 GB in f32; the cut is 11.9 G, 47.6 GB,
#: and its bf16 cast 23.8 GB more) and takes capacity_factor 16 / 2 = 8.
#: xlstm-1.3b serves at its published config in f32 (SERVE_F32_ONLY) and in
#: both dtypes at full width cut to 4 layers at 3:1 (one macro-block of
#: three mLSTM blocks and an sLSTM block): with random weights its bf16
#: recurrent decode leaves the chunkwise teacher by 4.4e-2 of max |teacher|
#: at 8 layers in the JAX package itself (tests/test_torch_xlstm.py), and
#: further at more depth, so 5e-2 can judge the bf16 path only cut
SERVE_RUNS = [
    ("qwen2-7b/short", "qwen2-7b", {}, 4, 16, 16),
    ("qwen2-7b/long", "qwen2-7b", {}, 4, 4096, 16),
    ("mixtral-8x7b/L2", "mixtral-8x7b", {"n_layers": 2,
                                         "capacity_factor": 4.0}, 4, 16, 16),
    ("whisper-medium", "whisper-medium", {}, 4, 16, 16),
    ("xlstm-1.3b", "xlstm-1.3b", {}, 4, 16, 16),
    ("xlstm-1.3b/L4", "xlstm-1.3b", {"n_layers": 4, "slstm_period": 4},
     4, 16, 16),
    ("jamba-1.5-large/L2", "jamba-1.5-large-398b",
     {"n_layers": 2, "attn_period": 2, "capacity_factor": 8.0}, 4, 16, 16),
]
#: the CLI's runs at the published configs (jamba's is 1.59 TB in f32)
SERVE_CLI_ARCHS = ("qwen2-7b", "xlstm-1.3b")
#: decode against teacher forcing: max |decode - teacher| over every step's
#: logits, as a share of max |teacher|; f32 is tests/test_models.py's
#: tolerance for the attention archs
SERVE_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
#: the runs served under the f32 activation config only
SERVE_F32_ONLY = ("xlstm-1.3b",)
#: the trainer's arch: the JAX trainer's default, the one published config
#: of the zoo whose f32 parameters, gradients and AdamW moments (20.5 GB)
#: fit one card
TRAIN_ARCH = "olmo-1b"
#: train: the published config at its published context, B x T tokens a step
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED = 2, 8, 2
#: train_parity: full width cut to 2 of 16 layers, on the card and the CPU
PARITY_CUT = {"n_layers": 2}
PARITY_BATCH, PARITY_SEQ, PARITY_STEPS = 2, 128, 2
#: the card against the CPU: loss and grad_norm, f32 (TF32 off); the loss in
#: bf16, as a share of the CPU's
TRAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: parameters further apart than this after a parity step are counted
PARAM_DIFF = 1e-6
#: f32 train_parity: at most this share of the parameters beyond PARAM_DIFF.
#: Adam's update is near sign(g) * lr, so an element whose gradient is 0 to
#: within the two devices' rounding can move up to 2 lr apart; such
#: elements are few, where a fault of the update moves every element
PARAM_FLIP_SHARE = 1e-4
#: adamw_parity: the card's AdamW step against the CPU's on the same
#: parameters, moments and gradients, each element within
#: rel * max|leaf| (+ lr_rel * lr for a parameter): the same elementwise
#: f32 formula, apart by a few ulps and by the global norm's sum order
ADAMW_TOL = {"params": (1e-6, 1e-5), "mu": (1e-5, 0.0), "nu": (1e-5, 0.0)}
#: the library GEMM kernels of a profiler trace (cuBLAS, CUTLASS), by name
#: train_placed: the train phase's first steps again on a one-rank NCCL
#: DeviceMesh (DTensor parameters, moments, batches and activations)
PLACED_STEPS = 4
PLACED_TOL = 1e-6            # each loss, relative to the train phase's
#: dryrun: (arch, shape, mesh) cells traced on the fake 256/512-rank meshes
DRYRUN_CELLS = [("olmo-1b", "train_4k", "single"),
                ("olmo-1b", "train_4k", "multi"),
                ("qwen2-7b", "prefill_32k", "single"),
                ("mixtral-8x7b", "decode_32k", "single"),
                ("xlstm-1.3b", "long_500k", "single")]
GEMM_KERNEL = re.compile(r"gemm|xmma|cutlass|nvjet", re.IGNORECASE)
#: the CLI's restart check: the smoke config, 12 steps, a fault at 6
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "12", "--batch",
             "4", "--seq", "64"]


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


#: the kernels of K1's and K2's launch sequence, by name in a profiler trace
SEQUENCE_KERNELS = {"transpose": ("transpose_kernel",),
                    "main": ("simt_kernel", "wgmma_kernel"),
                    "reduce": ("reduce_kernel",)}


#: K3's kernels and K4's (projection: K2's main loop and split-K reduce;
#: the persistent recurrence); "other" in K4's is the rest of its device
#: time: the packing copies and the barrier counter's memset
STEP_KERNELS = {"step": ("gru_step_kernel",), "reduce": ("gru_sum_kernel",)}
SEQ_KERNELS = {"projection": ("simt_kernel", "wgmma_kernel", "reduce_kernel"),
               "recurrence": ("gru_seq_kernel",)}


def device_ms(fn, reps: int, parts=None, main: str = "main",
              other: bool = False) -> dict | None:
    """Device time per call of each kernel of a launch sequence (``parts``,
    by default K1/K2's ``SEQUENCE_KERNELS``), from a ``torch.profiler``
    trace of ``reps`` calls after a warm-up; with ``other``, the device
    time of every other kernel, copy and memset in the trace too.  ``None``
    when the trace holds no device time for ``main``."""
    from torch.profiler import ProfilerActivity, profile
    parts = parts or SEQUENCE_KERNELS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(parts, 0.0)
    rest = 0.0
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3 / reps
        hit = [part for part, names in parts.items()
               if any(nm in ev.key for nm in names)]
        if hit:
            out[hit[0]] += ms
        else:
            rest += ms
    if not out[main]:
        return None
    if other:
        out["other"] = rest
    out["sum"] = sum(out.values())
    return out


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """(least time in ms, what bounds it) on the data-sheet peaks."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mismatch(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float
             ) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and got.shape == want.shape \
        and bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def library_gru_bf16(params: dict, x0: torch.Tensor, xs: torch.Tensor,
                     h0: torch.Tensor) -> dict:
    """Times of ``torch.gru_cell`` (one step) and cuDNN's ``nn.GRU`` (the
    sequence) on bf16 operands; a library that refuses bf16 gives ``None``
    and its error, since it is a yardstick and not part of the port."""
    inp, hidden = params["Wr"].shape
    w_ih = torch.cat([params["Wr"], params["Wz"], params["Wn"]], 1).T \
        .contiguous()
    w_hh = torch.cat([params["Ur"], params["Uz"], params["Un"]], 1).T \
        .contiguous()
    zeros = torch.zeros_like(params["br"])
    b_ih = torch.cat([params["br"], params["bz"], params["bnx"]])
    b_hh = torch.cat([zeros, zeros, params["bnh"]])
    out = {"step_ms": None, "seq_ms": None, "error": None}
    try:
        with torch.no_grad():
            out["step_ms"] = time_ms(
                lambda: torch.gru_cell(x0, h0, w_ih, w_hh, b_ih, b_hh), 50)
            lib = torch.nn.GRU(inp, hidden).to(xs.device, torch.bfloat16)
            lib.weight_ih_l0.copy_(w_ih)
            lib.weight_hh_l0.copy_(w_hh)
            lib.bias_ih_l0.copy_(b_ih)
            lib.bias_hh_l0.copy_(b_hh)
            out["seq_ms"] = time_ms(lambda: lib(xs, h0[None]), 5)
    except RuntimeError as exc:
        out["error"] = str(exc).splitlines()[0]
    return out


def eager_block(t: dict, cfg) -> torch.Tensor:
    """The traced decoder block in eager torch f32 (``torch.matmul``, TF32
    off), from the tensors ``t`` by the tracer's names: the graph phase's
    library yardstick, used nowhere in the port."""
    scale = 2.0 ** -((cfg.hd.bit_length() - 1) // 2)
    x = t["x"]
    y1 = x
    for h in range(cfg.n_heads):
        q, k, v = x @ t[f"wq{h}"], x @ t[f"wk{h}"], x @ t[f"wv{h}"]
        y1 = y1 + (torch.relu((q @ k.T) * scale) @ v) @ t[f"wo{h}"]
    hid = torch.relu(y1 @ t["w_gate"]) + y1 @ t["w_up"]
    return y1 + hid @ t["w_down"]


def hold_graph(got: dict, want: dict) -> dict:
    """Each tensor a block produced (``got``) against the float64
    reference (``want``, by the same names): bit-exact where max|ref| is
    below ``EXACT_BOUND``, else within ``GRAPH_TOL``."""
    out = {"exact_tensors": 0, "tolerance_tensors": 0, "max_ref": 0.0,
           "max_abs_err": 0.0, "max_err_over_max_ref": 0.0, "mismatched": []}
    for name, ref in want.items():
        if name not in got:
            continue
        mag = float(ref.abs().max())
        out["max_ref"] = max(out["max_ref"], mag)
        if mag < EXACT_BOUND:
            out["exact_tensors"] += 1
            ok = torch.equal(got[name], ref)
            err = float((got[name].double() - ref.double()).abs().max())
        else:
            out["tolerance_tensors"] += 1
            err, ok = mismatch(got[name], ref, GRAPH_TOL[0],
                               GRAPH_TOL[1] * mag)
            out["max_err_over_max_ref"] = max(out["max_err_over_max_ref"],
                                              err / mag)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if not ok:
            out["mismatched"].append(name)
    return out


def node_ms(cg, env: dict, dev, reps: int = 3) -> dict:
    """Where a block's ``execute`` time goes: each node rerun alone on its
    recorded inputs and event-timed (``reps`` calls, host path included),
    summed over the K1 nodes and over the other (stream) nodes."""
    from repro_torch.graph.execute import interpret_program, run_gemm_node
    out = {"k1_nodes": 0.0, "stream_nodes": 0.0}
    for node in cg.graph.nodes:
        lowering = cg.kernels[cg.node_kernels[node.name]].lowering
        ins = {b: env[t] for b, t in node.inputs}
        if lowering["kind"] == "stream":
            out["stream_nodes"] += time_ms(
                lambda: interpret_program(node.program, ins, dev), reps)
        else:
            out["k1_nodes"] += time_ms(
                lambda: run_gemm_node(node, lowering, ins), reps)
    return out


def moe_ffns(model) -> list:
    """The model's MoE FFNs, in the order a forward pass calls them."""
    from repro_torch.models.moe import MoE
    return [m for m in model.modules() if isinstance(m, MoE)]


def serve_bounds(model, B: int, T: int, new: int) -> dict:
    """Least times of the serve run on the data-sheet peaks, in the
    activation dtype, each the larger of its bytes over HBM_BW and its
    operations over the peak.  The prefill reads each weight it needs once
    (the experts that B*T tokens can reach), writes the KV cache and the
    recurrent state once, and does 2 x the parameters a token meets
    (outside the embedding table; top_k of the experts) x B*T operations,
    plus the full square of scores in each attention layer, as the model
    computes it.  One decode step at pos T + new / 2 reads the weights it
    needs (min(E, B*top_k) experts), the KV cache of the attention layers
    and B rows of the table, and reads and writes the recurrent state.  The
    ``*_as_run`` bounds count what the implementation does instead: the
    dispatch einsum runs every expert on every token, and xLSTM's prefill
    is T decode steps (``prefill`` runs ``decode_step`` over the prompt)."""
    from repro_torch.models import build_model
    cfg, dt = model.cfg, model.dtype
    size = torch.tensor([], dtype=dt).element_size()
    per_token = sum(p.numel() for n, p in model.named_parameters()
                    if n != "embed")
    if cfg.family == "audio":                   # the decoder's weights
        per_token -= sum(p.numel() for p in model.enc.parameters())
    experts = sum(w.numel() for f in moe_ffns(model)
                  for w in (f.w_gate, f.w_up, f.w_down))
    E, k = cfg.n_experts or 1, cfg.top_k or 1

    def needs(tokens):
        """The weights ``tokens`` tokens need: top_k experts a token."""
        return per_token - experts + experts * min(E, tokens * k) // E

    H, hd = cfg.n_heads, cfg.hd
    # the attention layers, each with a KV cache
    L = {"ssm": 0, "hybrid": getattr(model, "nb", 0)}.get(cfg.family,
                                                          cfg.n_layers)

    def kv(S):
        out = 2 * L * B * S * cfg.n_kv_heads * hd * size
        if cfg.family == "audio":
            out += 2 * L * B * cfg.frontend_tokens * cfg.n_kv_heads * hd \
                * size
        return out

    S = T + new // 2
    # the recurrent state (xLSTM's, Jamba's Mamba layers'), from the
    # cache's layout on the meta device
    meta = build_model(cfg, device="meta").init_cache(B, S)
    state = sum(t.numel() * t.element_size()
                for key, sub in meta.items() if key not in ("kv", "cross")
                for t in sub.values())
    active = per_token - experts + experts * k / E
    attn = L * 4.0 * B * H * T * T * hd
    ops = 2.0 * active * B * T + attn
    ops_as_run = 2.0 * per_token * B * T + attn
    read = 0
    if cfg.family == "audio":                   # the encoder's 1500 frames
        Ta = cfg.frontend_tokens
        enc = sum(p.numel() for p in model.enc.parameters())
        read = enc * size
        extra = 2.0 * enc * B * Ta + cfg.encoder_layers * 4.0 * B * H * Ta \
            * Ta * hd + L * 4.0 * B * H * T * Ta * hd
        ops, ops_as_run = ops + extra, ops_as_run + extra
    prefill_bytes = (needs(B * T) * size + read + kv(T) + state
                     + B * T * cfg.d_model * size)

    def least(nbytes, nops):
        return max((nbytes / HBM_BW * 1e3, "bytes"),
                   (nops / PEAK[dt] * 1e3, "operations"))

    rows = B * cfg.d_model * size
    step_bytes = needs(B) * size + kv(S) + 2 * state + rows
    as_run_bytes = per_token * size + kv(S) + 2 * state + rows
    decode = least(step_bytes, 2.0 * active * B)
    decode_as_run = least(as_run_bytes, 2.0 * per_token * B)
    prefill = least(prefill_bytes, ops)
    prefill_as_run = (T * decode_as_run[0], "bytes") \
        if cfg.family == "ssm" else least(prefill_bytes, ops_as_run)
    return {"prefill_bound_ms": prefill[0], "prefill_bound_by": prefill[1],
            "decode_bound_ms": decode[0], "decode_bound_by": decode[1],
            "prefill_bound_as_run_ms": prefill_as_run[0],
            "prefill_bound_as_run_by": prefill_as_run[1],
            "decode_bound_as_run_ms": decode_as_run[0],
            "decode_bound_as_run_by": decode_as_run[1],
            "decode_step_bytes": step_bytes,
            "decode_step_bytes_as_run": as_run_bytes,
            "recurrent_state_bytes": state, "prefill_bytes": prefill_bytes,
            "prefill_flop": ops, "prefill_flop_as_run": ops_as_run}


def serve_batch(cfg, B: int, T: int, dev, gen) -> dict:
    """Prompt tokens uniform over the vocabulary; whisper's frame
    embeddings uniform(-1, 1) in the activation dtype."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["audio_embeds"] = (torch.rand(
            (B, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device=dev) * 2 - 1).to(cfg.activation_dtype)
    return batch


def perturb_experts(model, gen) -> None:
    """Make each MoE expert its own: the init repeats one draw in every
    expert, and with identical experts routing changes nothing."""
    with torch.no_grad():
        for ffn in moe_ffns(model):
            for w in (ffn.w_gate, ffn.w_up, ffn.w_down):
                for e in range(w.shape[0]):
                    w[e].mul_(1 + 0.3 * torch.randn(
                        w.shape[1:], generator=gen, device=w.device))


@contextlib.contextmanager
def record_routing(routes: list):
    """Append each MoE call's expert choice (sorted, one row a token) to
    ``routes`` while the block runs."""
    from repro_torch.models import moe
    real = moe.top_k

    def spy(probs, k):
        vals, idx = real(probs, k)
        routes.append(idx.sort(-1).values.reshape(-1, k))
        return vals, idx

    moe.top_k = spy
    try:
        yield routes
    finally:
        moe.top_k = real


def rerouted(routes: list, L: int, B: int, T: int, new: int
             ) -> torch.Tensor:
    """(B, T + new) bool: where a token's experts in some MoE FFN differ
    between ``generate`` (prefill, then one call an FFN and step) and
    teacher forcing (the last L calls); L is the model's MoE FFNs."""
    gen, tf = routes[:-L], routes[-L:]
    K = tf[0].shape[-1]
    out = torch.zeros(B, T + new, dtype=torch.bool, device=tf[0].device)
    for layer in range(L):
        want = tf[layer].view(B, T + new, K)
        out[:, :T] |= (gen[layer].view(B, T, K) != want[:, :T]).any(-1)
        for i in range(new):
            got = gen[L + i * L + layer].view(B, K)
            out[:, T + i] |= (got != want[:, T + i]).any(-1)
    return out


def serve_gates(model, batch, new: int) -> dict:
    """``generate`` (timed) and the gates on it: every step's logits against
    ``logits`` of the prompt plus the generated tokens (teacher forcing),
    within SERVE_TOL of max |teacher|; each greedy token equal to the
    teacher's argmax where the teacher's top-2 margin is above that
    tolerance; every logit finite.  With MoE layers, a position whose
    experts differ between the two paths in some layer (``rerouted``: a near
    tie of router probabilities that rounding breaks the other way) is
    held to neither of the first two gates in bf16, and counted, and at
    least half the positions must be held; in f32 no position is left
    out."""
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    dev = batch["tokens"].device
    B, T = batch["tokens"].shape
    prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    generate(model, batch, 1)                       # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rec, routes = {}, []
    with record_routing(routes) if cfg.n_experts else contextlib.nullcontext():
        t0 = time.perf_counter()
        toks = generate(model, batch, new, record=rec)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.no_grad():
            full = dict(batch, tokens=torch.cat([batch["tokens"], toks], 1))
            ref = model.logits(full)[:, prefix + T - 1:].float()
    got = rec.pop("logits").float()
    tol = SERVE_TOL[model.dtype]
    held = torch.ones(B, new + 1, dtype=torch.bool, device=dev)
    moved = 0
    if cfg.n_experts:
        moved_at = rerouted(routes, len(moe_ffns(model)), B, T, new)
        moved = int(moved_at.sum())
        if model.dtype != torch.float32:
            held = ~moved_at[:, T - 1:]
    max_ref = float(ref.abs().max())
    err = float(((got - ref).abs().amax(-1) * held).max())
    top2 = ref[:, :new].topk(2, dim=-1).values
    sure = ((top2[..., 0] - top2[..., 1]) > tol * max_ref) & held[:, :new]
    argmax_ok = bool((toks == ref[:, :new].argmax(-1))[sure].all())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    decode = rec["decode_ms"]
    return {"dtype": dtype_name(model.dtype), "wall_s": wall,
            "tok_per_s": B * new / wall, "cast_ms": rec["cast_ms"],
            "prefill_ms": rec["prefill_ms"],
            "decode_ms_per_token": sum(decode) / len(decode),
            "decode_ms": decode, "max_memory_allocated": peak,
            "max_err_over_max_ref": err / max_ref, "max_ref": max_ref,
            "tol": tol, "positions_held": int(held.sum()),
            "rerouted_positions": moved,
            "rerouted_max_err_over_max_ref":
            float((got - ref).abs().amax(-1)[~held].max()) / max_ref
            if not bool(held.all()) else None,
            "tokens_checked": int(sure.sum()), "tokens": B * new,
            "argmax_ok": argmax_ok, "finite": finite,
            "ok": err <= tol * max_ref and argmax_ok and finite
            and int(held.sum()) >= B * (new + 1) // 2,
            "sample": toks[0, :8].tolist()}


def decode_profile(model, batch, steps: int = 4) -> dict:
    """Device time of the decode step against its event-timed time: the
    prompt prefilled, then ``steps`` greedy decode steps (``generate``'s
    loop) under ``torch.profiler``; the busy share is the device time the
    trace holds over the steps' event-timed time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    B, T = batch["tokens"].shape
    prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    with torch.no_grad(), model.cast_weights():
        cache, logits = model.prefill(batch, max_len=prefix + T + steps)
        cur = logits[:, -1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for i in range(steps):
                logits, cache = model.decode_step(cache, cur, prefix + T + i)
                cur = logits.argmax(-1).to(torch.int32)
            end.record()
            torch.cuda.synchronize()
    dev_ms = sum(ev.self_device_time_total for ev in prof.key_averages()) \
        / 1e3 / steps
    event_ms = start.elapsed_time(end) / steps
    return {"decode_device_ms_per_token": dev_ms,
            "decode_event_ms_per_token": event_ms,
            "device_busy_share": dev_ms / event_ms if event_ms else None}


def run_serve(dev, seed: int, failures: list) -> None:
    """The serve phase: each of SERVE_RUNS through ``build_model`` and
    ``launch.serve.generate`` in bf16 (but those of SERVE_F32_ONLY), then
    the same weights under the f32 activation config; the CLI at each of
    SERVE_CLI_ARCHS' full config."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    def twin(model, cfg):
        """A model of ``cfg`` holding ``model``'s parameters (no copy)."""
        out = build_model(cfg, device="meta")
        out.load_state_dict(model.state_dict(), assign=True)
        return out

    model = None
    for name, arch, over, B, T, new in SERVE_RUNS:
        cfg = get_config(arch).scaled(**over)
        if model is None or model.cfg != cfg:
            model = None
            torch.cuda.empty_cache()
            gen = torch.Generator(dev).manual_seed(seed)
            model = build_model(cfg).init(gen)
            if cfg.n_experts:
                perturb_experts(model, gen)
        batch = serve_batch(cfg, B, T, dev, torch.Generator(dev).manual_seed(
            seed + 1))
        bf16 = None
        if name not in SERVE_F32_ONLY:
            bf16 = serve_gates(model, batch, new)
            bf16.update(decode_profile(model, batch))
        f32_model = twin(model, cfg.scaled(dtype="float32"))
        f32 = serve_gates(f32_model, batch, new)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        served = [r for r in (bf16, f32) if r is not None]
        emit({"phase": "serve", "run": name, "arch": arch,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "n_experts": cfg.n_experts, "batch": B, "prompt_len": T,
              "generated": new, "param_bytes": param_bytes,
              **serve_bounds(f32_model if bf16 is None else model, B, T,
                             new), "weights_cast": "once",
              "bf16": bf16, "f32": f32, "ok": all(r["ok"] for r in served)})
        for r in served:
            if not r["ok"]:
                failures.append(
                    f"serve {name} {r['dtype']}: decode off teacher forcing "
                    f"{r['max_err_over_max_ref']:.3g} x max|ref| (tol "
                    f"{r['tol']}), argmax_ok {r['argmax_ok']}, finite "
                    f"{r['finite']}")
        f32_model = None        # holds the parameters too
    model = None
    torch.cuda.empty_cache()
    # the CLI, as a user runs it: the card, the published configs
    for arch in SERVE_CLI_ARCHS:
        out = cuda.BUILD_DIR / f"serve-{os.getpid()}-{time.time_ns()}.json"
        toks = serve.main(["--arch", arch, "--seed", str(seed), "--json",
                           str(out)])
        rows = json.loads(out.read_text())["rows"]
        emit({"phase": "serve_cli", "record": rows[0],
              "device": str(toks.device)})
        if toks.device.type != "cuda" or tuple(toks.shape) != (4, 16):
            failures.append(f"serve CLI {arch}: tokens {tuple(toks.shape)} "
                            f"on {toks.device}")
        torch.cuda.empty_cache()


def parity_steps(cfg, seed: int, dev, steps: int = PARITY_STEPS) -> dict:
    """``steps`` train steps of ``cfg`` on the card and on the CPU from one
    seeded init (drawn on the CPU, copied to the card) on the same
    batches (the frontend stub's embeddings too): losses, grad norms, and
    after each step the largest parameter difference and the count of
    elements further apart than PARAM_DIFF."""
    from repro_torch.data.pipeline import (DataConfig, add_frontend_stub,
                                           make_source)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=steps)
    cpu, _, cpu_step = make_train_step(cfg, opt_cfg, device="cpu")
    cpu.init(torch.Generator().manual_seed(seed))
    card, card_opt, card_step = make_train_step(cfg, opt_cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    source = make_source(DataConfig(seed=seed, global_batch=PARITY_BATCH,
                                    seq_len=PARITY_SEQ), cfg)
    out = {"loss": [], "loss_cpu": [], "grad_norm": [], "grad_norm_cpu": [],
           "param_max_diff": [], "params_beyond": []}
    for s in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in
                 add_frontend_stub(source.batch(s), cfg, s, seed).items()}
        got = card_step({k: v.to(dev) for k, v in batch.items()})
        want = cpu_step(batch)
        for key in ("loss", "grad_norm"):
            out[key].append(float(got[key]))
            out[key + "_cpu"].append(float(want[key]))
        worst, beyond = 0.0, 0
        cpu_state = cpu.state_dict()
        for name, p in card.state_dict().items():
            diff = (p.cpu() - cpu_state[name]).abs()
            worst = max(worst, float(diff.max()))
            beyond += int((diff > PARAM_DIFF).sum())
        out["param_max_diff"].append(worst)
        out["params_beyond"].append(beyond)
    out["param_count"] = sum(p.numel() for p in cpu.parameters())
    out["adamw"] = adamw_parity(card, card_opt, {k: v.to(dev) for k, v in
                                                 batch.items()}, opt_cfg)
    return out


def adamw_parity(model, opt_state, batch, opt_cfg) -> dict:
    """One AdamW step (``apply_updates``) on the card's parameters and
    moments from the card's gradient of the loss on ``batch``, against the
    same step on the CPU from copies of those tensors: for the parameters
    and each moment, the largest element difference as a share of its
    ``ADAMW_TOL`` bound (gated at 1).  The train steps' own comparison
    cannot hold the update elementwise, as the two devices' gradients
    differ in rounding."""
    from repro_torch.optim.adamw import OptState, apply_updates
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(model.loss(batch), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    grads = dict(zip(params, grads))

    def host(tree):
        return {n: t.detach().cpu().clone() for n, t in tree.items()}

    cpu = {"params": host(params), "mu": host(opt_state.mu),
           "nu": host(opt_state.nu)}
    cpu_state = OptState(opt_state.step.cpu().clone(), cpu["mu"], cpu["nu"])
    apply_updates(params, grads, opt_state, opt_cfg)
    lr = float(apply_updates(cpu["params"], host(grads), cpu_state,
                             opt_cfg)[2]["lr"])
    card = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
    out = {"lr": lr}
    for kind, (rel, lr_rel) in ADAMW_TOL.items():
        share = 0.0
        for n, want in cpu[kind].items():
            diff = float((card[kind][n].detach().cpu() - want).abs().max())
            bound = rel * float(want.abs().max()) + lr_rel * lr
            share = max(share, diff / bound if bound else
                        (0.0 if diff == 0 else math.inf))
        out[kind] = share
    return out


def train_full(dev, seed: int) -> dict:
    """TRAIN_ARCH at its published config through ``build_trainer``'s step:
    TRAIN_WARMUP + TRAIN_TIMED steps event-timed, TRAIN_PROFILED more under
    ``torch.profiler``, then AdamW alone (``apply_updates``) event-timed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig, apply_updates
    cfg = get_config(TRAIN_ARCH)
    steps = TRAIN_WARMUP + TRAIN_TIMED + TRAIN_PROFILED
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    model, init_state, step, _ = build_trainer(cfg, opt_cfg, make_host_mesh(),
                                               device=dev)
    carry = init_state(torch.Generator(dev).manual_seed(seed))
    source = make_source(DataConfig(seed=17, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ), cfg)
    losses, gnorms, ms = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for s in range(TRAIN_WARMUP + TRAIN_TIMED):
        batch = source.batch(s)
        start.record()
        carry, m = step(carry, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    batches = [source.batch(s) for s in range(len(ms), steps)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for batch in batches:
            carry, m = step(carry, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        end.record()
        end.synchronize()
    prof_ms = start.elapsed_time(end)
    events = sorted(prof.key_averages(),
                    key=lambda ev: -ev.self_device_time_total)
    dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    gemm_ms = sum(ev.self_device_time_total for ev in events
                  if GEMM_KERNEL.search(ev.key)) / 1e3
    peak = torch.cuda.max_memory_allocated()
    # AdamW alone on the model's parameters, its moments and f32 gradients
    _, opt_state = carry
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    adamw_ms = time_ms(lambda: apply_updates(params, grads, opt_state,
                                             opt_cfg), 3)
    timed = sorted(ms[TRAIN_WARMUP:])
    n = cfg.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 12 * cfg.n_layers * TRAIN_SEQ * cfg.d_model * tokens
    flops = 6 * n * tokens + attn
    flops_as_run = flops * 4 / 3           # remat repeats the forward
    step_ms = timed[len(timed) // 2]
    adamw_bytes = 28 * n                   # read p, g, mu, nu; write p, mu, nu
    del grads, params, carry, model, step
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "grad_accum": 1, "param_count": n,
        "warmup_ms": ms[:TRAIN_WARMUP], "step_ms": ms[TRAIN_WARMUP:],
        "step_ms_median": step_ms, "step_ms_min": timed[0],
        "step_ms_max": timed[-1], "tok_per_s": tokens / (step_ms / 1e3),
        "model_flops": flops, "model_flops_as_run": flops_as_run,
        "mfu": flops / (step_ms / 1e3) / PEAK[torch.bfloat16],
        "bound_ms": flops / PEAK[torch.bfloat16] * 1e3,
        "bound_as_run_ms": flops_as_run / PEAK[torch.bfloat16] * 1e3,
        "bound_by": "operations",
        "adamw_ms": adamw_ms, "adamw_bytes": adamw_bytes,
        "adamw_bound_ms": adamw_bytes / HBM_BW * 1e3,
        "profiled_steps": TRAIN_PROFILED,
        "profiled_event_ms": prof_ms, "profiled_device_ms": dev_ms,
        "device_busy_share": dev_ms / prof_ms if prof_ms else None,
        "gemm_device_ms_per_step": gemm_ms / TRAIN_PROFILED,
        "top_kernels_ms_per_step": [
            [ev.key[:100], ev.self_device_time_total / 1e3 / TRAIN_PROFILED,
             ev.count // TRAIN_PROFILED] for ev in events[:12]],
        "max_memory_allocated": peak, "losses": losses,
        "grad_norms": gnorms}


def cli_runs(tmp: str, mode: str) -> dict:
    """The CLI on the card, as a user runs it, in this process, under
    PyTorch's default algorithms or (``mode="deterministic"``)
    ``use_deterministic_algorithms``: uninterrupted, with a checkpoint every
    4 steps and a fault at 6, and again with ``--resume``; the losses of
    each run and what it printed.  Only the fault run's RuntimeError is
    caught: any other failure ends the phase."""
    from repro_torch.launch import train
    prev = signal.getsignal(signal.SIGTERM)    # main installs its handler
    ck = os.path.join(tmp, f"train-{mode}")
    runs = {}
    try:
        torch.use_deterministic_algorithms(mode == "deterministic")
        for run, extra in (("uninterrupted", ["--ckpt-dir", ck + "-a"]),
                           ("fault", ["--ckpt-dir", ck + "-b",
                                      "--save-every", "4",
                                      "--inject-fault-at", "6"]),
                           ("resumed", ["--ckpt-dir", ck + "-b",
                                        "--resume"])):
            out, losses, error = io.StringIO(), None, None
            with contextlib.redirect_stdout(out):
                if run != "fault":
                    losses = train.main(TRAIN_CLI + extra)
                else:
                    try:
                        train.main(TRAIN_CLI + extra)
                    except RuntimeError as e:
                        error = str(e)
            lines = out.getvalue().splitlines()
            runs[f"{mode}/{run}"] = {
                "losses": losses, "error": error,
                "resumed_line": next((ln for ln in lines
                                      if ln.startswith("resumed from")),
                                     None),
                "last_line": lines[-1] if lines else None}
    finally:
        torch.use_deterministic_algorithms(False)
        signal.signal(signal.SIGTERM, prev)
    return runs


def train_cli(tmp: str) -> dict:
    """``cli_runs`` in PyTorch's default mode here, then in the
    deterministic mode in a process of its own, whose cuBLAS takes
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before its first call (set in this
    process, it slows every later cuBLAS call, the library yardsticks
    included)."""
    runs = cli_runs(tmp, "default")
    code = ("import json, sys; sys.path[:0] = {!r}; import chip_smoke; "
            "print(json.dumps(chip_smoke.cli_runs({!r}, 'deterministic')))"
            ).format([ROOT, os.path.join(ROOT, "src")], tmp)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise RuntimeError(f"the deterministic CLI runs exited "
                           f"{child.returncode}: {child.stderr[-2000:]}")
    runs.update(json.loads(child.stdout.splitlines()[-1]))
    return runs


def run_train(dev, seed: int, failures: list) -> dict:
    """The train phase: ``train_parity``, ``train``, ``train_families`` and
    ``train_cli``; returns the ``train`` record."""
    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.kernels import cuda
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(TRAIN_ARCH).scaled(dtype=dtype, **PARITY_CUT)
            t0 = time.perf_counter()
            r = parity_steps(cfg, seed, dev)
            tol = TRAIN_TOL[dtype]
            keys = ("loss", "grad_norm") if dtype == "float32" else ("loss",)
            rel = {k: max(abs(a - b) / abs(b) for a, b in
                          zip(r[k], r[k + "_cpu"])) for k in keys}
            flips = max(r["params_beyond"]) / r["param_count"]
            ok = all(v <= tol for v in rel.values()) and all(
                math.isfinite(v) for v in r["loss"] + r["grad_norm"]) and \
                all(r["adamw"][k] <= 1 for k in ADAMW_TOL) and (
                    dtype != "float32" or flips <= PARAM_FLIP_SHARE)
            emit({"phase": "train_parity", "arch": TRAIN_ARCH, "dtype": dtype,
                  "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                  "batch": PARITY_BATCH, "seq": PARITY_SEQ, "tf32": False,
                  **r, "rel_err": rel, "tol": tol, "flip_share": flips,
                  "flip_share_max": PARAM_FLIP_SHARE,
                  "seconds": time.perf_counter() - t0, "ok": ok})
            if not ok:
                failures.append(f"train_parity {dtype}: card vs CPU {rel} "
                                f"(tol {tol}), AdamW {r['adamw']} (tol 1), "
                                f"{flips} of the parameters beyond "
                                f"{PARAM_DIFF}")
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    train = train_full(dev, seed)
    ok = all(math.isfinite(v) for v in train["losses"] +
             train["grad_norms"]) and train["losses"][-1] < train["losses"][0]
    emit({"phase": "train", **train, "ok": ok})
    if not ok:
        failures.append(f"train {TRAIN_ARCH}: losses {train['losses']}, "
                        f"grad norms {train['grad_norms']}")
    torch.cuda.empty_cache()

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in ARCHS:
            cfg = get_smoke_config(arch).scaled(dtype="float32")
            r = parity_steps(cfg, seed, dev, steps=1)
            rel = {k: abs(r[k][0] - r[k + "_cpu"][0]) / abs(r[k + "_cpu"][0])
                   for k in ("loss", "grad_norm")}
            ok = all(v <= TRAIN_TOL["float32"] for v in rel.values()) and \
                all(r["adamw"][k] <= 1 for k in ADAMW_TOL)
            emit({"phase": "train_families", "arch": arch,
                  "family": cfg.family, "loss": r["loss"][0],
                  "loss_cpu": r["loss_cpu"][0], "grad_norm": r["grad_norm"][0],
                  "grad_norm_cpu": r["grad_norm_cpu"][0], "rel_err": rel,
                  "param_max_diff": r["param_max_diff"][0],
                  "params_beyond": r["params_beyond"][0],
                  "param_count": r["param_count"], "adamw": r["adamw"],
                  "tol": TRAIN_TOL["float32"], "ok": ok})
            if not ok:
                failures.append(f"train_families {arch}: card vs CPU {rel}, "
                                f"AdamW {r['adamw']} (tol 1)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    runs = train_cli(str(cuda.BUILD_DIR / f"ckpt-{os.getpid()}-"
                         f"{time.time_ns()}"))
    checks = {}
    for mode in ("default", "deterministic"):
        whole, resumed = (runs[f"{mode}/{run}"]["losses"]
                          for run in ("uninterrupted", "resumed"))
        checks[mode] = {
            "whole_run_steps": len(whole),
            "fault": runs[f"{mode}/fault"]["error"]
            == "injected fault at step 6",
            "resumed_line": runs[f"{mode}/resumed"]["resumed_line"]
            == "resumed from step 4",
            "resumed_equals_uninterrupted": len(whole) == 12
            and resumed == whole[4:]}
    ok = all(c["fault"] and c["resumed_line"]
             and c["resumed_equals_uninterrupted"] for c in checks.values())
    emit({"phase": "train_cli", "args": TRAIN_CLI, "runs": runs,
          "checks": checks, "ok": ok})
    if not ok:
        failures.append(f"train_cli: {checks}")
    return train


def run_train_placed(dev, seed: int, failures: list, train: dict) -> None:
    """The train phase's olmo-1b at its published config on a one-rank
    NCCL process group and a (1, 1) ``DeviceMesh``: ``build_trainer``
    places the parameters and moments as DTensors and runs the step under
    the activation rules; PLACED_STEPS steps of the train phase's seed and
    batches, each loss held to the train phase's same step, then a
    checkpoint of the placed state restored into the unplaced trainer,
    equal to the bit."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.dist.compat import make_mesh
    from repro_torch.dist.sharding import full
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig

    tag = f"{os.getpid()}-{time.time_ns()}"
    store = dist.FileStore(str(cuda.BUILD_DIR / f"store-{tag}"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    ckpt_dir = str(cuda.BUILD_DIR / f"ckpt-placed-{tag}")
    try:
        cfg = get_config(TRAIN_ARCH)
        steps = TRAIN_WARMUP + TRAIN_TIMED + TRAIN_PROFILED
        opt_cfg = AdamWConfig(warmup_steps=1, total_steps=steps)
        mesh = make_host_mesh()
        torch.cuda.reset_peak_memory_stats()
        model, init_state, step, shardings = build_trainer(
            cfg, opt_cfg, mesh, device=dev)
        carry = init_state(torch.Generator(dev).manual_seed(seed))
        source = make_source(DataConfig(seed=17, global_batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ), cfg)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        losses, ms = [], []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for s in range(PLACED_STEPS):
                batch = source.batch(s)
                start.record()
                carry, m = step(carry, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
                losses.append(float(m["loss"]))
        events = prof.key_averages()            # all PLACED_STEPS steps
        dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
        peak = torch.cuda.max_memory_allocated()
        want = train["losses"][:PLACED_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        timed = sorted(ms[1:])
        t0 = time.perf_counter()
        Checkpointer(ckpt_dir).save(PLACED_STEPS, carry, blocking=True)
        save_s = time.perf_counter() - t0
        placed_model, placed_opt = carry
        plain_mesh = make_mesh((1, 1), ("data", "model"), [dev])
        plain, init_plain, _, plain_sh = build_trainer(cfg, opt_cfg,
                                                       plain_mesh, device=dev)
        t0 = time.perf_counter()
        (plain, plain_opt), got = Checkpointer(ckpt_dir).restore(
            PLACED_STEPS, init_plain(torch.Generator(dev).manual_seed(seed + 1)),
            plain_sh)
        restore_s = time.perf_counter() - t0
        placed_params = dict(placed_model.named_parameters())
        unequal = [n for n, p in plain.named_parameters()
                   if not torch.equal(p, full(placed_params[n]))]
        unequal += [f"{k}/{n}" for k in ("mu", "nu")
                    for n, t in getattr(plain_opt, k).items()
                    if not torch.equal(t, full(getattr(placed_opt, k)[n]))]
        unequal += [] if int(plain_opt.step) == int(full(placed_opt.step)) \
            else ["step"]
        placements = sorted({str(tuple(p.placements))
                             for p in placed_params.values()})
        ok = all(r <= PLACED_TOL for r in rel) and not unequal \
            and got == PLACED_STEPS and all(math.isfinite(v) for v in losses)
        emit({"phase": "train_placed", "arch": TRAIN_ARCH,
              "mesh": dict(mesh.shape), "backend": dist.get_backend(),
              "param_placements": placements, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "dtype": cfg.dtype, "remat": cfg.remat,
              "losses": losses, "train_losses": want, "rel_err": rel,
              "tol": PLACED_TOL, "bit_equal": losses == want,
              "step_ms": ms, "step_ms_median": timed[len(timed) // 2],
              "step_ms_min": timed[0], "step_ms_max": timed[-1],
              "train_step_ms_median": train["step_ms_median"],
              "train_step_ms_min": train["step_ms_min"],
              "train_step_ms_max": train["step_ms_max"],
              "profiled_device_ms": dev_ms, "event_ms": sum(ms),
              "device_busy_share": dev_ms / sum(ms),
              "max_memory_allocated": peak,
              "train_max_memory_allocated": train["max_memory_allocated"],
              "checkpoint": {"save_s": save_s, "restore_s": restore_s,
                             "restored_step": got, "unequal": unequal[:8],
                             "n_unequal": len(unequal)},
              "ok": ok})
        if not ok:
            failures.append(f"train_placed: losses {losses} against "
                            f"{want} (rel {rel}, tol {PLACED_TOL}), "
                            f"checkpoint unequal {unequal[:8]}")
        del carry, placed_model, placed_opt, plain, plain_opt, model, step
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()


def run_dryrun(failures: list) -> None:
    """``repro_torch.launch.dryrun`` on DRYRUN_CELLS at their published
    configs, on the host (a ``fake`` process group of 512 ranks; each
    step traced under ``FakeTensorMode``): every cell ``ok``, FLOPs and
    collective bytes above 0, one rank's parameter and moment bytes equal
    to the rules' shard shapes."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    out = str(cuda.BUILD_DIR / f"dryrun-{os.getpid()}-{time.time_ns()}")
    try:
        for arch, shape, mesh_kind in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, mesh_kind, out)
            seconds = time.perf_counter() - t0
            mem = rec.get("memory", {})
            abstract = make_production_mesh(multi_pod=mesh_kind == "multi")
            cfg = get_config(arch)
            want_params = dryrun.rule_param_bytes(cfg, abstract)
            want_opt = 2 * dryrun.rule_param_bytes(cfg, abstract, 4) + 4 \
                if rec.get("kind") == "train" else None
            ok = rec["status"] == "ok" and rec["hlo_flops"] > 0 \
                and rec["collectives"]["total_bytes"] > 0 \
                and mem.get("param_bytes") == want_params \
                and mem.get("opt_state_bytes") == want_opt
            emit({"phase": "dryrun", "arch": arch, "shape": shape,
                  "mesh": mesh_kind, "seconds": seconds,
                  "rule_param_bytes": want_params,
                  "rule_opt_state_bytes": want_opt,
                  **{k: rec.get(k) for k in (
                      "status", "chips", "kind", "target", "compile_s",
                      "memory", "hlo_flops", "hlo_bytes", "collectives",
                      "roofline", "model_flops", "model_flops_ratio",
                      "error")}, "ok": ok})
            if not ok:
                failures.append(f"dryrun {arch} {shape} {mesh_kind}: "
                                f"{rec.get('status')} {rec.get('error', '')}"
                                f" params {mem.get('param_bytes')} against "
                                f"{want_params}, moments "
                                f"{mem.get('opt_state_bytes')} against "
                                f"{want_opt}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(out, ignore_errors=True)


def entry(name, source, replaces, count, rs):
    """One kernel's line: times summed over the main path's shapes."""
    bounds = [r["bound"] for r in rs]
    by_ops = sum(b for b, by in bounds if by == "operations")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(b for b, _ in bounds),
            "bound_by": "operations"
            if by_ops >= sum(b for b, _ in bounds) / 2 else "bytes",
            "library_ms": None if any(r["library_ms"] is None for r in rs)
            else sum(r["library_ms"] for r in rs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.compile import (ArtifactCache, compile_conv, compile_gemm,
                                     compile_gru, gru_selection,
                                     set_default_artifact_cache)
    from repro_torch.compile import driver as compile_driver
    from repro_torch.compile.driver import clear_memo
    from repro_torch.compile.features import role_extents
    from repro_torch.compile.pipeline import DEFAULT_PASSES, VerifyPass
    from repro_torch.configs import get_config, get_trace_config
    from repro_torch.core.recurrent import schedule_recurrent
    from repro_torch.core.sysgraph import gpu_sm
    from repro_torch.graph import (block_inputs, compile_graph,
                                   fuse_epilogues, trace_block)
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.gemm import (MIN_SPLIT_STEPS, block_tile,
                                          device_sms, gemm, gemm_bias_act,
                                          gemm_launch, gemm_reduce,
                                          gemm_transpose, kernel_resources,
                                          operand_route, route_tile,
                                          tuned_block, tuned_record)
    from repro_torch.kernels.gru import (STEP_KC, FusedGRU, PARAM_NAMES,
                                         device_smem, device_split, gru_cell,
                                         gru_cell_reduce, gru_seq,
                                         gru_seq_launch, pack_w, seq_route,
                                         step_route)
    from repro_torch.kernels.ops import (gru_tile, plan_gemm, plan_gru,
                                         scheduled_gemm)
    from repro_torch.models.traceable import block_reference
    from repro_torch.search import tune
    from repro_torch.search.cache import TuningCache, set_default_cache
    from repro_torch.search.model import (ModelStore, predict_gemm_block,
                                          set_default_store, train_suites)
    from repro_torch.verify import verify_artifact

    dev = torch.device("cuda")
    graph = gpu_sm(8)
    torch.backends.cudnn.allow_tf32 = False      # the library GRU's products
    print(nvidia_smi("name,power.limit"), flush=True)

    t0 = time.perf_counter()
    libs = cuda.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: os.path.relpath(p, ROOT) for n, p in libs.items()}})

    rng = np.random.default_rng(args.seed)

    def uniform(shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    gemm_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in GEMM_SIZES:
            a = torch.from_numpy(uniform((m, k))).to(dev, dtype)
            b = torch.from_numpy(uniform((k, n))).to(dev, dtype)
            bias = torch.from_numpy(uniform((n,))).to(dev)
            gemm_cases.append({"mnk": (m, n, k), "dtype": dtype, "a": a,
                               "b": b, "bias": bias})
    gru_cases = []
    for batch, hidden in GRU_SIZES:
        inp, s = hidden, hidden ** -0.5
        params = {nm: uniform({"W": (inp, hidden), "U": (hidden, hidden),
                               "b": (hidden,)}[nm[0]], -s, s)
                  for nm in PARAM_NAMES}
        xs = torch.from_numpy(uniform((STEPS, batch, inp))).to(dev)
        h0 = torch.from_numpy(uniform((batch, hidden))).to(dev)
        gru_cases.append({
            "bh": (batch, hidden), "params": params,
            "model": FusedGRU.from_numpy(params, device=dev),
            "model_bf16": FusedGRU.from_numpy(params, device=dev,
                                              dtype=torch.bfloat16),
            "xs": xs, "h0": h0, "xs_bf16": xs.bfloat16(),
            "h0_bf16": h0.bfloat16()})
    # the wide sequence: weights made on the card from the seed (1.3 GB)
    wb, we, wh, wt = WIDE_GRU
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def card_uniform(shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    wide_model = FusedGRU(we, wh, device=dev)
    with torch.no_grad():
        for nm in PARAM_NAMES:
            buf = getattr(wide_model, nm)
            buf.copy_(card_uniform(buf.shape, wh ** -0.5))
    wide = {"model": wide_model, "xs": card_uniform((wt, wb, we)),
            "h0": card_uniform((wb, wh))}
    torch.cuda.synchronize()

    counters = {"gemm": gemm, "gemm_bias_act": gemm_bias_act,
                "gru_cell": gru_cell, "gru_cell_reduce": gru_cell_reduce,
                "gru_seq": gru_seq, "gemm_transpose": gemm_transpose,
                "gemm_reduce": gemm_reduce}
    #: the counters of the kernels' own wrappers
    wrappers = ("gemm", "gemm_bias_act", "gru_cell", "gru_seq")
    phase_launches = {}
    failures = []
    sms = device_sms(dev)

    def launch_fields(a, b, tile, m, n, k):
        """The launch a K1/K2 call makes at ``tile`` (``grid_blocks``: x
        over N, y over M, z over the K slices) and what ptxas reported for
        its main loop; records a failure where a bf16 GEMM missed the wgmma
        route, or where fewer tiles than SMs did not split a K deep enough
        for two slices."""
        route = operand_route(a, b)
        tile = tile or route.default_tile
        ln = gemm_launch(m, n, k, a.dtype, tile, route, sms)
        res = kernel_resources(ln.route, a.dtype, ln.tile) or {}
        if a.dtype == torch.bfloat16 and ln.route != "wgmma":
            failures.append(f"bf16 {m}x{n}x{k} took the {ln.route} route")
        if ln.grid[0] * ln.grid[1] < sms and ln.split == 1 \
                and -(-k // ln.tile[2]) >= 2 * MIN_SPLIT_STEPS:
            failures.append(f"{m}x{n}x{k} {ln.tile}: {ln.grid} tiles on "
                            f"{sms} SMs and no split")
        return {"route": ln.route, "split": ln.split, "threads": ln.threads,
                "smem_bytes": ln.smem_bytes,
                "grid_blocks": [ln.grid[1], ln.grid[0], ln.split],
                "registers": res.get("registers"),
                "spill_bytes": res.get("spill_stores", 0)
                + res.get("spill_loads", 0) if res else None}

    @contextlib.contextmanager
    def counted(phase: str, path: tuple[str, ...]):
        """Counters at 0 just before the phase, read just after it; every
        kernel of the phase's path must have launched."""
        for c in counters.values():
            c.launches = 0
        yield
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        phase_launches[phase] = got
        emit({"phase": phase, "launches": got})
        missing = [name for name in path if got[name] == 0]
        if missing:
            failures.append(f"{phase}: kernels never launched: {missing}")

    # ---- the main path's compiles: verified, cached, replayed ------------
    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    compiled_path = cuda.BUILD_DIR / f"compiled-{os.getpid()}-{time.time_ns()}.json"
    compiles = ([("gemm", m, n, k) for m, n, k in GEMM_SIZES]
                + [("gemm", STEPS * b, 3 * h, h) for b, h in GRU_SIZES]
                + [("gemm", wt * wb, 3 * wh, we)]
                + [("gru", b, h, h) for b, h in GRU_SIZES]
                + [("gru", wb, wh, we)])

    def compile_all():
        return [compile_gemm(*dims, graph=graph) if kind == "gemm"
                else compile_gru(*dims, graph=graph)
                for kind, *dims in compiles]

    def payload(art):
        return {k: v for k, v in art.to_dict().items() if k != "meta"}

    class CountedVerifyPass(VerifyPass):
        """The driver's VerifyPass, counting the compiles it let through."""

        passed = 0

        def run(self, ctx):
            super().run(ctx)
            CountedVerifyPass.passed += ctx.verify

    t0 = time.perf_counter()
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    compile_driver.VerifyPass = CountedVerifyPass
    try:
        first = compile_all()
    finally:
        compile_driver.VerifyPass = VerifyPass
    fresh = [a for a in first if not a.from_cache]
    verified = sum(verify_artifact(a).ok for a in fresh)
    compile_s = time.perf_counter() - t0
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    second = compile_all()
    refresh = sum(not a.from_cache for a in second)
    same = sum(payload(a) == payload(b) for a, b in zip(first, second))
    emit({"phase": "compile", "cache": os.path.relpath(compiled_path, ROOT),
          "passes": [ps.name for ps in DEFAULT_PASSES],
          "compiles": len(first), "fresh": len(fresh),
          "passed_verify_pass": CountedVerifyPass.passed,
          "verify_artifact_ok": verified,
          "seconds": compile_s, "cached_artifacts":
          len(ArtifactCache(str(compiled_path))),
          "second_pass_fresh": refresh, "second_pass_identical": same})
    if "verify" not in [ps.name for ps in DEFAULT_PASSES] or not fresh \
            or not CountedVerifyPass.passed == verified == len(fresh):
        failures.append(f"compile: {len(fresh)} fresh compiles, "
                        f"{CountedVerifyPass.passed} through VerifyPass, "
                        f"{verified} verified again")
    if refresh or same != len(first):
        failures.append(f"compile: the second pass compiled {refresh} fresh, "
                        f"{same} of {len(first)} artifacts identical")

    # ---- the graph tier's compiles: whisper-medium's decoder block -------
    blocks = []
    for size, cfg in (("full", get_config(GRAPH_ARCH).scaled(n_layers=1)),
                      ("trace", get_trace_config(GRAPH_ARCH))):
        g = trace_block(cfg, seq_len=GRAPH_SEQ)
        inputs = {t: torch.from_numpy(v).to(dev)
                  for t, v in block_inputs(g).items()}
        flops = 2.0 * sum(math.prod(a.size for a in n.program.axes)
                          for n in g.nodes if n.kind == "gemm")
        fg, decisions = fuse_epilogues(g)
        blocks += [{"size": size, "fused": fused, "cfg": cfg, "g": gg,
                    "decisions": dec, "inputs": inputs, "flops": flops}
                   for fused, gg, dec in ((False, g, []),
                                          (True, fg, decisions))]

    def compile_blocks():
        return [compile_graph(b["g"], graph, decisions=b["decisions"])
                for b in blocks]

    def kernel_payloads(cg):
        return {fp: payload(k) for fp, k in cg.kernels.items()}

    t0 = time.perf_counter()
    CountedVerifyPass.passed = 0
    compile_driver.VerifyPass = CountedVerifyPass
    try:
        first_graphs = compile_blocks()
    finally:
        compile_driver.VerifyPass = VerifyPass
    graph_compile_s = time.perf_counter() - t0
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    second_graphs = compile_blocks()
    graph_rows = []
    for b, cg, cg2 in zip(blocks, first_graphs, second_graphs):
        b["cg"] = cg
        kinds = [cg.kernels[cg.node_kernels[n.name]].lowering["kind"]
                 for n in cg.graph.nodes]
        b["gemm_nodes"] = kinds.count("pallas_gpu_gemm")
        b["stream_nodes"] = kinds.count("stream")
        graph_rows.append({"graph": cg.name, "fused": b["fused"],
                     "nodes": len(kinds), "gemm_nodes": b["gemm_nodes"],
                     "stream_nodes": b["stream_nodes"],
                     "unique_programs": cg.stats["unique_programs"],
                     "fresh": cg.stats["fresh_compiles"],
                     "cache_hits": cg.stats["cache_hits"],
                     "second_pass_fresh": cg2.stats["fresh_compiles"],
                     "second_pass_identical":
                     kernel_payloads(cg) == kernel_payloads(cg2),
                     "modeled_makespan_s": cg.makespan})
    graph_fresh = sum(r["fresh"] for r in graph_rows)
    emit({"phase": "graph_compile", "target": graph.name,
          "seconds": graph_compile_s, "fresh": graph_fresh,
          "passed_verify_pass": CountedVerifyPass.passed,
          "graphs": graph_rows})
    if not graph_fresh or CountedVerifyPass.passed != graph_fresh:
        failures.append(f"graph compile: {graph_fresh} fresh compiles, "
                        f"{CountedVerifyPass.passed} through VerifyPass")
    if any(r["second_pass_fresh"] or not r["second_pass_identical"]
           for r in graph_rows):
        failures.append("graph compile: the second pass compiled something "
                        "fresh or gave another artifact")

    # ---- the conv frontend: ResNet-50's inner layers at minibatch 28 -------
    def compile_layer(h, w, kh, kw, cin, cout, stride):
        return compile_conv(graph=graph, batch=RESNET_BATCH, h=h, w=w, kh=kh,
                            kw=kw, cin=cin, cout=cout, stride=stride)

    CountedVerifyPass.passed = 0
    compile_driver.VerifyPass = CountedVerifyPass
    convs = {}
    try:
        for name, *dims in RESNET_LAYERS:
            t0 = time.perf_counter()
            art = compile_layer(*dims)
            convs[name] = {"art": art, "seconds": time.perf_counter() - t0}
    finally:
        compile_driver.VerifyPass = VerifyPass
    conv_fresh = [c["art"] for c in convs.values() if not c["art"].from_cache]
    conv_verified = sum(verify_artifact(a).ok for a in conv_fresh)
    clear_memo()
    set_default_artifact_cache(ArtifactCache(str(compiled_path)))
    for name, *dims in RESNET_LAYERS:
        convs[name]["second"] = compile_layer(*dims)
    for name, c in convs.items():
        art, sel = c["art"], c["art"].selection
        calls = sum(p.calls for p in art.instrs)
        roles = role_extents(sel)
        c["mnk"] = (roles["i"], roles["j"], roles["k"]) if calls == 1 else None
        emit({"phase": "conv_compile", "layer": name, "batch": RESNET_BATCH,
              "target": graph.name, "program": sel.program.name,
              "calls": calls, "steps": [st.name for st in sel.steps],
              "lowering": art.lowering["kind"],
              "lowering_block": art.lowering.get("block"),
              "lowering_grid": art.lowering.get("grid"),
              "fused_mnk": c["mnk"], "modeled_cost_s": art.cost,
              "seconds": c["seconds"], "fresh": not art.from_cache,
              "second_pass_fresh": not c["second"].from_cache,
              "second_pass_identical":
              payload(art) == payload(c["second"])})
    conv_refresh = sum(not c["second"].from_cache for c in convs.values())
    emit({"phase": "conv_compile", "layers": len(convs),
          "fresh": len(conv_fresh),
          "passed_verify_pass": CountedVerifyPass.passed,
          "verify_artifact_ok": conv_verified,
          "second_pass_fresh": conv_refresh,
          "left_out": ["conv2_3x3", "conv3_3x3"]})
    if len(conv_fresh) != len(RESNET_LAYERS) \
            or not CountedVerifyPass.passed == conv_verified == len(conv_fresh):
        failures.append(f"conv compile: {len(conv_fresh)} fresh of "
                        f"{len(RESNET_LAYERS)}, {CountedVerifyPass.passed} "
                        f"through VerifyPass, {conv_verified} verified again")
    if conv_refresh or any(payload(c["art"]) != payload(c["second"])
                           for c in convs.values()):
        failures.append(f"conv compile: the second pass compiled "
                        f"{conv_refresh} fresh or gave another artifact")

    # ---- main path, phase plan: the compiler's tile ----------------------
    empty = cuda.BUILD_DIR / f"tuning-empty-{os.getpid()}.json"
    set_default_cache(TuningCache(str(empty)))
    def snapshot():
        return {name: c.launches for name, c in counters.items()}

    with counted("plan", ("gemm", "gemm_bias_act", "gru_cell",
                          "gru_cell_reduce", "gru_seq")):
        for c in gemm_cases:
            c["out"], c["cfg"] = scheduled_gemm(c["a"], c["b"], graph=graph)
        def sequence(model, xs, h0):
            """The sequence through ``FusedGRU``, and the launches of each
            kernel's wrapper it made (K2's transposing pass and split-K
            reduce and K3's reduce are parts of those launches)."""
            before = snapshot()
            out = model(xs, h0)
            return out, {n: v - before[n] for n, v in snapshot().items()
                         if v > before[n] and n in wrappers}

        for c in gru_cases:
            batch, hidden = c["bh"]
            c["block"], _ = plan_gru(batch, hidden, hidden, graph=graph)
            c["tile"] = gru_tile(c["block"])
            for sfx, x_key, h_key, model in (
                    ("", "xs", "h0", c["model"]),
                    ("_bf16", "xs_bf16", "h0_bf16", c["model_bf16"])):
                c["step_out" + sfx] = gru_cell(c[x_key][0], c[h_key],
                                               model.params(), tile=c["tile"])
                c["out" + sfx], c["seq_launches" + sfx] = sequence(
                    model, c[x_key], c[h_key])
                if c["seq_launches" + sfx] != {"gemm_bias_act": 1,
                                               "gru_seq": 1}:
                    failures.append(
                        f"gru {batch}x{hidden}{sfx}: a sequence launched "
                        f"{c['seq_launches' + sfx]}, not one K2 projection "
                        "and one persistent kernel")
        wide["out"], wide["seq_launches"] = sequence(wide["model"], wide["xs"],
                                                     wide["h0"])
        if wide["seq_launches"].get("gru_cell") != wt or any(
                wide["seq_launches"].get(n) for n in ("gemm_bias_act",
                                                      "gru_seq")):
            failures.append(f"gru {wb}x{wh}: the wide sequence launched "
                            f"{wide['seq_launches']}, not {wt} K3 steps")

    # ---- main path, phase tune: K1 measured into a fresh cache -----------
    cache_path = cuda.BUILD_DIR / f"tuning-{os.getpid()}-{time.time_ns()}.json"
    report_path = cache_path.with_suffix(".report.json")
    t0 = time.perf_counter()
    with counted("tune", ("gemm",)):
        with contextlib.redirect_stdout(sys.stderr):
            tune_rc = tune.main([
                "--suite", "gemm", "--backend", "measure",
                "--target", "gpu_sm", "--trials", str(TUNE_TRIALS),
                "--seed", str(args.seed), "--cache", str(cache_path),
                "--json", str(report_path)])
    tune_s = time.perf_counter() - t0
    if tune_rc != 0:
        failures.append(f"tuner exited {tune_rc}")
    tuned_cache = TuningCache(str(cache_path))
    records = {r.meta.get("case"): r for r in tuned_cache.load().values()
               if r.backend == "measure"}
    rows = json.loads(report_path.read_text())["rows"] \
        if report_path.exists() else []
    for row in rows:
        rec = records.get(row["case"])
        emit({"phase": "tune", "case": row["case"],
              "greedy_cost_s": row["greedy_cost_s"],
              "tuned_cost_s": row["tuned_cost_s"],
              "block": list(rec.tile) if rec else None,
              "tile": list(block_tile(rec.tile)) if rec else None,
              "measured_best_ms": row["measured_s"] * 1e3
              if row["measured_s"] is not None else None,
              "tiles_ms": {t: v * 1e3 for t, v in
                           rec.meta.get("tiles_s", {}).items()} if rec else None,
              "trials": row["trials"], "oracle_exact": row["exact"],
              "validated": row["validated"]})
    emit({"phase": "tune", "seconds": tune_s, "measure_records": len(records),
          "device": next(iter(records.values())).meta.get("device")
          if records else None})
    if len(records) < len(GEMM_SIZES):
        failures.append(f"the tuner wrote {len(records)} measure records, "
                        f"not {len(GEMM_SIZES)}")

    # ---- main path, phase tuned: K1 and K2 at the tuned tile -------------
    set_default_cache(tuned_cache)
    with counted("tuned", ("gemm", "gemm_bias_act")):
        for c in gemm_cases:
            c["tuned_out"], c["tuned_cfg"] = scheduled_gemm(c["a"], c["b"],
                                                            graph=graph)
            c["k2_out"] = {fn: gemm_bias_act(c["a"], c["b"], c["bias"], fn)
                           for fn in ACTS}

    # ---- main path, phase graph: the compiled blocks on the card ---------
    with counted("graph", ("gemm",)):
        for b in blocks:
            before = counters["gemm"].launches
            b["env"] = b["cg"].execute(b["inputs"], device=dev,
                                       return_all=True)
            b["k1_launches"] = counters["gemm"].launches - before
    for b in blocks:
        if b["k1_launches"] != b["gemm_nodes"]:
            failures.append(f"graph {b['cg'].name}: {b['k1_launches']} K1 "
                            f"launches for {b['gemm_nodes']} GEMM nodes")

    # ---- main path, phase learned: K1 at the learned model's block --------
    t0 = time.perf_counter()
    store = ModelStore(str(cuda.BUILD_DIR / f"models-{os.getpid()}-"
                                            f"{time.time_ns()}.json"))
    train_rows = train_suites(
        LEARNED_SUITES, graph,
        TuningCache(str(cuda.BUILD_DIR / f"tuning-learned-{os.getpid()}-"
                                         f"{time.time_ns()}.json")),
        store, seed=args.seed)
    train_s = time.perf_counter() - t0
    for r in train_rows:
        emit({"phase": "learned_train", "family": r["family"],
              "trained": r["trained"], "samples": r["n_samples"],
              "mae_log": r.get("holdout_mae_log", r.get("train_mae_log")),
              "train_mae_log": r.get("train_mae_log"),
              "suites": LEARNED_SUITES, "suites_seconds": train_s})
    if not any(r["trained"] and r["family"] == "matmul" for r in train_rows):
        failures.append("learned: no matmul model was trained")
    learned_cases = []
    for name, c in convs.items():
        if c["mnk"] is None:
            continue
        m, n, k = c["mnk"]
        for dtype in (torch.float32, torch.bfloat16):
            learned_cases.append({
                "layer": name, "mnk": (m, n, k), "dtype": dtype,
                "a": card_uniform((m, k)).to(dtype),
                "b": card_uniform((k, n)).to(dtype)})
    set_default_store(store)
    try:
        with counted("learned", ("gemm",)):
            for c in learned_cases:
                (m, n, k), a, b = c["mnk"], c["a"], c["b"]
                if tuned_record(m, n, k) is not None:
                    failures.append(f"learned {m}x{n}x{k}: a tuning-cache hit")
                t0 = time.perf_counter()
                c["block"] = predict_gemm_block(m, n, k)
                c["predict_ms"] = (time.perf_counter() - t0) * 1e3
                if c["block"] is None or tuned_block(m, n, k) != c["block"]:
                    failures.append(f"learned {m}x{n}x{k}: the model gave "
                                    f"{c['block']}, tuned_block "
                                    f"{tuned_block(m, n, k)}")
                    continue
                c["out"] = gemm(a, b)       # tile=None: tuned_block's model
                c["tile"] = route_tile(c["block"], operand_route(a, b))
                c["learned_ms"] = time_ms(lambda: gemm(a, b, tile=c["tile"]),
                                          LEARNED_REPS)
    finally:
        set_default_store(None)

    # ---- held against the plain versions, and timed -----------------------
    k1, k2 = [], []
    for c in gemm_cases:
        a, b, bias, dtype, (m, n, k) = (c["a"], c["b"], c["bias"], c["dtype"],
                                        c["mnk"])
        want = ref.gemm_ref(a, b)
        rtol, atol = GEMM_TOL[dtype]
        if dtype == torch.float32:
            atol *= float(want.abs().max())
        err, ok = mismatch(c["out"], want, rtol, atol)
        tile = c["cfg"].tile
        reps = 20
        kernel_ms = time_ms(lambda: gemm(a, b, tile=tile), reps)
        dev_ms = device_ms(lambda: gemm(a, b, tile=tile), 5)
        plain_ms = time_ms(lambda: ref.gemm_ref(a, b), reps)
        library_ms = time_ms(lambda: torch.matmul(a, b), reps)
        bound_ms, bound_by = bound(a.element_size() * (m * k + k * n + m * n),
                                   2.0 * m * n * k, dtype)
        emit({"phase": "gemm", "m": m, "n": n, "k": k,
              "dtype": dtype_name(dtype),
              "block": list(c["cfg"].block), "tile": list(tile),
              **launch_fields(a, b, tile, m, n, k),
              "kernel_ms": kernel_ms, "device_ms": dev_ms,
              "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "max_abs_err": err, "rtol": rtol,
              "atol": atol, "ok": ok})
        if not ok:
            failures.append(f"gemm {m}x{n}x{k} {dtype}: max err {err}")

        # K1 at the tuned tile, timed beside the plan tile in turns
        tuned = c["tuned_cfg"]
        t_err, t_ok = mismatch(c["tuned_out"], want, rtol, atol)
        plan_ms = time_ms(lambda: gemm(a, b, tile=tile), reps)
        tuned_ms = time_ms(lambda: gemm(a, b, tile=tuned.tile), reps)
        tuned_ms2 = time_ms(lambda: gemm(a, b, tile=tuned.tile), reps)
        plan_ms2 = time_ms(lambda: gemm(a, b, tile=tile), reps)
        emit({"phase": "tuned_gemm", "m": m, "n": n, "k": k,
              "dtype": dtype_name(dtype), "tuned_block": list(tuned.block),
              "tuned_tile": list(tuned.tile), "plan_tile": list(tile),
              **launch_fields(a, b, tuned.tile, m, n, k),
              "tuned_ms": (tuned_ms + tuned_ms2) / 2,
              "plan_ms": (plan_ms + plan_ms2) / 2,
              "max_abs_err": t_err, "ok": t_ok})
        k1.append({"ms": (tuned_ms + tuned_ms2) / 2, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound": (bound_ms, bound_by),
                   "err": max(err, t_err)})
        if not t_ok:
            failures.append(f"tuned gemm {m}x{n}x{k} {dtype}: max err {t_err}")

        # K2: every activation, at the tuned tile
        block = tuned_block(m, n, k)
        k2_tile = route_tile(block, operand_route(a, b)) if block else None
        k2_launch = launch_fields(a, b, k2_tile, m, n, k)
        pre_max = float((a.float() @ b.float() + bias).abs().max())
        lib_bias = bias.to(dtype)
        k2_bound = bound(a.element_size() * (m * k + k * n + m * n) + 4 * n,
                         2.0 * m * n * k, dtype)
        for fn in ACTS:
            want = ref.gemm_bias_act_ref(a, b, bias, fn)
            rtol, atol = GEMM_TOL[dtype]
            if dtype == torch.float32:
                atol *= pre_max
            err, ok = mismatch(c["k2_out"][fn], want, rtol, atol)
            act = ref.ACTIVATIONS[fn]
            kernel_ms = time_ms(
                lambda: gemm_bias_act(a, b, bias, fn, tile=k2_tile), reps)
            plain_ms = time_ms(
                lambda: ref.gemm_bias_act_ref(a, b, bias, fn), reps)
            library_ms = time_ms(
                lambda: act(torch.addmm(lib_bias, a, b)), reps)
            emit({"phase": "gemm_bias_act", "m": m, "n": n, "k": k,
                  "dtype": dtype_name(dtype), "fn": fn,
                  "tile": list(k2_tile) if k2_tile else None, **k2_launch,
                  "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                  "library_ms": library_ms,
                  "library": "torch.addmm" + (f" + torch.{fn}" if fn else ""),
                  "library_launches": 2 if fn else 1,
                  "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
                  "max_abs_err": err, "rtol": rtol, "atol": atol, "ok": ok})
            k2.append({"ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound": k2_bound,
                       "err": err})
            if not ok:
                failures.append(f"gemm_bias_act {m}x{n}x{k} {dtype} {fn!r}: "
                                f"max err {err}")

    def gru_resources(pattern: str) -> dict | None:
        """Registers and spill bytes ``-Xptxas -v`` reported for the GRU
        kernel whose mangled name matches ``pattern``."""
        found = [v for name, v in cuda.ptxas_report("gru").items()
                 if re.search(pattern, name)]
        if not found:
            return None
        return {"registers": found[0].get("registers"),
                "spill_bytes": found[0].get("spill_stores", 0)
                + found[0].get("spill_loads", 0)}

    smem_limit = device_smem(dev)
    k3, k4 = [], []
    for c in gru_cases:
        (batch, hidden), xs, h0 = c["bh"], c["xs"], c["h0"]
        inp = hidden
        params = c["model"].params()
        block, tile = c["block"], c["tile"]
        want = ref.gru_seq_ref(xs, h0, params)
        err, ok = mismatch(c["out"], want, *GRU_TOL)
        if not ok:
            failures.append(f"gru {batch}x{hidden}: max err {err}")
        x0 = xs[0]
        step_err, step_ok = mismatch(c["step_out"],
                                     ref.gru_cell_ref(x0, h0, params),
                                     *CELL_TOL)
        if not step_ok:
            failures.append(f"gru_cell {batch}x{hidden}: max err {step_err}")
        # K3's launch: the split, and blocks = tiles x slices
        route = step_route(inp, hidden)
        split = device_split(batch, inp, hidden, tile, dev, route)
        step_blocks = -(-hidden // tile[1]) * -(-batch // tile[0]) * split
        if step_blocks < sms:
            failures.append(f"gru_cell {batch}x{hidden}: {step_blocks} blocks "
                            f"on {sms} SMs")
        step_res = gru_resources(
            rf"gru_step_kernelIfLi{tile[0]}ELi{tile[1]}ELb"
            f"{int(route == 'vec4')}E")
        # K4's launches: the projection's tile and the persistent partition
        proj_cfg, _ = plan_gemm(STEPS * batch, 3 * hidden, inp, graph=graph)
        seq_launch = gru_seq_launch(batch, inp, hidden, sms, smem_limit)
        seq_res = gru_resources(
            rf"gru_seq_kernelIfLb{int(hidden % 4 == 0)}E")
        # K2 at the projection's shape, held against its plain version at
        # K2's f32 tolerance: G's early rows fade from h_T, so the sequence's
        # check alone would not see a fault there
        x2d = xs.view(STEPS * batch, inp)
        w_cat, b_cat = pack_w(params)
        proj_want = ref.gemm_bias_act_ref(x2d, w_cat, b_cat, "")
        proj_rtol, proj_atol = GEMM_TOL[torch.float32]
        proj_atol *= float(proj_want.abs().max())
        proj_err, proj_ok = mismatch(
            gemm_bias_act(x2d, w_cat, b_cat, "", tile=proj_cfg.tile),
            proj_want, proj_rtol, proj_atol)
        if not proj_ok:
            failures.append(f"gru {batch}x{hidden}: projection "
                            f"{STEPS * batch}x{3 * hidden}x{inp} max err "
                            f"{proj_err}")
        # a short sequence, where an error in the recurrence cannot fade
        short_err, short_ok = mismatch(
            gru_seq(xs[:SHORT_STEPS], h0, params, proj_tile=proj_cfg.tile),
            ref.gru_seq_ref(xs[:SHORT_STEPS], h0, params), *GRU_TOL)
        if not short_ok:
            failures.append(f"gru {batch}x{hidden} T={SHORT_STEPS}: max err "
                            f"{short_err}")
        # library: PyTorch's own GRU cell and cuDNN's GRU, gates (r, z, n)
        w_ih = torch.cat([params["Wr"], params["Wz"], params["Wn"]], 1).T
        w_hh = torch.cat([params["Ur"], params["Uz"], params["Un"]], 1).T
        zeros = torch.zeros_like(params["br"])
        b_ih = torch.cat([params["br"], params["bz"], params["bnx"]])
        b_hh = torch.cat([zeros, zeros, params["bnh"]])
        lib_gru = torch.nn.GRU(inp, hidden).to(dev)
        with torch.no_grad():
            lib_gru.weight_ih_l0.copy_(w_ih)
            lib_gru.weight_hh_l0.copy_(w_hh)
            lib_gru.bias_ih_l0.copy_(b_ih)
            lib_gru.bias_hh_l0.copy_(b_hh)
            lib_err = float((lib_gru(xs, h0[None])[1][0] - want).abs().max())
            w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
            out = torch.empty_like(h0)

            def step():
                return gru_cell(x0, h0, params, tile=tile, out=out)

            def seq():
                return gru_seq(xs, h0, params, proj_tile=proj_cfg.tile)

            step_ms = time_ms(step, 50)
            step_dev = device_ms(step, 10, STEP_KERNELS, "step")
            step_plain_ms = time_ms(
                lambda: ref.gru_cell_ref(x0, h0, params), 50)
            step_lib_ms = time_ms(
                lambda: torch.gru_cell(x0, h0, w_ih, w_hh, b_ih, b_hh), 50)
            seq_ms = c["seq_ms"] = time_ms(seq, 5)
            seq_dev = device_ms(seq, 3, SEQ_KERNELS, "recurrence", other=True)
            seq_plain_ms = time_ms(lambda: ref.gru_seq_ref(xs, h0, params), 5)
            seq_lib_ms = time_ms(lambda: lib_gru(xs, h0[None]), 5)
        w_bytes = 4 * (3 * inp * hidden + 3 * hidden * hidden + 4 * hidden)
        step_flops = 2.0 * batch * hidden * 3 * (inp + hidden)
        step_bound = bound(w_bytes + 4 * batch * (inp + 2 * hidden),
                           step_flops, torch.float32)
        seq_bound = bound(w_bytes + 4 * (STEPS * batch * inp + 2 * batch * hidden),
                          STEPS * step_flops, torch.float32)
        emit({"phase": "gru", "batch": batch, "hidden": hidden, "inp": inp,
              "steps": STEPS, "block": list(block), "tile": list(tile),
              "step_split": split, "step_grid_blocks": step_blocks,
              "step_route": route, "step_kc": STEP_KC,
              "step_resources": step_res,
              "step_ms": step_ms, "step_device_ms": step_dev,
              "step_plain_ms": step_plain_ms,
              "step_library_ms": step_lib_ms, "step_bound_ms": step_bound[0],
              "step_bound_by": step_bound[1],
              "seq_launches": c["seq_launches"],
              "projection_tile": list(proj_cfg.tile),
              "projection_split": proj_cfg.split,
              "persistent": {
                  "blocks": seq_launch.blocks, "cols": seq_launch.cols,
                  "batch_rows": seq_launch.batch,
                  "threads": seq_launch.threads, "lanes": seq_launch.lanes,
                  "smem_bytes": seq_launch.smem_bytes,
                  "u_rows_on_chip": seq_launch.rows_on_chip,
                  "u_bytes_on_chip": seq_launch.u_bytes_on_chip,
                  "u_bytes": seq_launch.u_bytes},
              "seq_resources": seq_res,
              "seq_ms": seq_ms, "seq_device_ms": seq_dev,
              "seq_plain_ms": seq_plain_ms,
              "seq_library_ms": seq_lib_ms, "seq_bound_ms": seq_bound[0],
              "seq_bound_by": seq_bound[1],
              "steps_x_step_bound_ms": STEPS * step_bound[0],
              "step_max_abs_err": step_err, "max_abs_err": err,
              "projection_max_abs_err": proj_err,
              "projection_rtol": proj_rtol, "projection_atol": proj_atol,
              "short_steps": SHORT_STEPS, "short_max_abs_err": short_err,
              "library_max_abs_err": lib_err, "rtol": GRU_TOL[0],
              "atol": GRU_TOL[1], "ok": ok and step_ok and proj_ok and short_ok})
        k3.append({"ms": step_ms, "plain_ms": step_plain_ms,
                   "library_ms": step_lib_ms, "bound": step_bound,
                   "err": step_err})
        k4.append({"ms": seq_ms, "plain_ms": seq_plain_ms,
                   "library_ms": seq_lib_ms, "bound": seq_bound, "err": err})

        # the same size in bf16: operands of 2 bytes, G and the math f32
        bf = torch.bfloat16
        pb, xb, hb = c["model_bf16"].params(), c["xs_bf16"], c["h0_bf16"]
        x0b = xb[0]
        b_step_err, b_step_ok = mismatch(c["step_out_bf16"],
                                         ref.gru_cell_ref(x0b, hb, pb),
                                         *BF16_TOL)
        b_err, b_ok = mismatch(c["out_bf16"], ref.gru_seq_ref(xb, hb, pb),
                               *BF16_TOL)
        if not (b_step_ok and b_ok):
            failures.append(f"gru bf16 {batch}x{hidden}: step max err "
                            f"{b_step_err}, sequence max err {b_err}")
        b_split = device_split(batch, inp, hidden, tile, dev, route, bf)
        b_launch = gru_seq_launch(batch, inp, hidden, sms, smem_limit, bf)
        b_proj, _ = plan_gemm(STEPS * batch, 3 * hidden, inp, dtype=bf,
                              graph=graph)
        b_out = torch.empty_like(hb)

        def b_step():
            return gru_cell(x0b, hb, pb, tile=tile, out=b_out)

        def b_seq():
            return gru_seq(xb, hb, pb, proj_tile=b_proj.tile)

        b_lib = library_gru_bf16(pb, x0b, xb, hb)
        b_step_ms = time_ms(b_step, 50)
        b_step_dev = device_ms(b_step, 10, STEP_KERNELS, "step")
        b_step_plain = time_ms(lambda: ref.gru_cell_ref(x0b, hb, pb), 50)
        b_seq_ms = time_ms(b_seq, 5)
        b_seq_dev = device_ms(b_seq, 3, SEQ_KERNELS, "recurrence", other=True)
        b_seq_plain = time_ms(lambda: ref.gru_seq_ref(xb, hb, pb), 5)
        b_w_bytes = 2 * (3 * inp * hidden + 3 * hidden * hidden + 4 * hidden)
        b_step_bound = bound(b_w_bytes + 2 * batch * (inp + 2 * hidden),
                             step_flops, bf)
        b_seq_bound = bound(
            b_w_bytes + 2 * (STEPS * batch * inp + 2 * batch * hidden),
            STEPS * step_flops, bf)
        emit({"phase": "gru_bf16", "batch": batch, "hidden": hidden,
              "inp": inp, "steps": STEPS, "tile": list(tile),
              "step_split": b_split, "step_route": route,
              "step_resources": gru_resources(
                  rf"gru_step_kernelI13__nv_bfloat16Li{tile[0]}ELi{tile[1]}"
                  f"ELb{int(route == 'vec4')}E"),
              "step_ms": b_step_ms, "step_device_ms": b_step_dev,
              "step_plain_ms": b_step_plain,
              "step_library_ms": b_lib["step_ms"],
              "step_bound_ms": b_step_bound[0],
              "step_bound_by": b_step_bound[1],
              "seq_launches": c["seq_launches_bf16"],
              "projection_tile": list(b_proj.tile),
              "projection_route": b_proj.route,
              "persistent": {
                  "blocks": b_launch.blocks, "cols": b_launch.cols,
                  "batch_rows": b_launch.batch, "lanes": b_launch.lanes,
                  "smem_bytes": b_launch.smem_bytes,
                  "u_rows_on_chip": b_launch.rows_on_chip,
                  "u_bytes_on_chip": b_launch.u_bytes_on_chip,
                  "u_bytes": b_launch.u_bytes},
              "seq_resources": gru_resources(
                  rf"gru_seq_kernelI13__nv_bfloat16Lb{int(hidden % 8 == 0)}E"),
              "seq_ms": b_seq_ms, "seq_device_ms": b_seq_dev,
              "seq_plain_ms": b_seq_plain,
              "seq_library_ms": b_lib["seq_ms"],
              "library_error": b_lib["error"],
              "seq_bound_ms": b_seq_bound[0],
              "seq_bound_by": b_seq_bound[1],
              "step_max_abs_err": b_step_err, "max_abs_err": b_err,
              "rtol": BF16_TOL[0], "atol": BF16_TOL[1],
              "ok": b_step_ok and b_ok})
        k3.append({"ms": b_step_ms, "plain_ms": b_step_plain,
                   "library_ms": b_lib["step_ms"], "bound": b_step_bound,
                   "err": b_step_err})
        k4.append({"ms": b_seq_ms, "plain_ms": b_seq_plain,
                   "library_ms": b_lib["seq_ms"], "bound": b_seq_bound,
                   "err": b_err})

    # the wide f32 sequence on the step route: T launches of K3
    wp = wide["model"].params()
    w_want = ref.gru_seq_ref(wide["xs"], wide["h0"], wp)
    w_err, w_ok = mismatch(wide["out"], w_want, *GRU_TOL)
    if not w_ok:
        failures.append(f"gru {wb}x{wh} step route: max err {w_err}")
    w_tile = gru_tile(plan_gru(wb, wh, we, graph=graph)[0])
    w_ms = time_ms(lambda: gru_seq(wide["xs"], wide["h0"], wp,
                                   step_tile=w_tile), 3)
    w_plain = time_ms(lambda: ref.gru_seq_ref(wide["xs"], wide["h0"], wp), 3)
    w_flops = 2.0 * wb * wh * 3 * (we + wh)
    w_bound = bound(4 * (3 * we * wh + 3 * wh * wh + 4 * wh)
                    + 4 * (wt * wb * we + 2 * wb * wh), wt * w_flops,
                    torch.float32)
    emit({"phase": "gru_step_route", "batch": wb, "inp": we, "hidden": wh,
          "steps": wt,
          "route": seq_route(wb, we, wh, torch.float32, sms, smem_limit),
          "tile": list(w_tile),
          "split": device_split(wb, we, wh, w_tile, dev, step_route(we, wh)),
          "seq_launches": wide["seq_launches"], "seq_ms": w_ms,
          "seq_plain_ms": w_plain, "seq_bound_ms": w_bound[0],
          "seq_bound_by": w_bound[1], "max_abs_err": w_err,
          "rtol": GRU_TOL[0], "atol": GRU_TOL[1], "ok": w_ok})

    # K1 at the learned block against the plain version, the plan tile and
    # the library, in turns
    for c in learned_cases:
        if "out" not in c:
            continue
        (m, n, k), a, b, dtype = c["mnk"], c["a"], c["b"], c["dtype"]
        want = ref.gemm_ref(a, b)
        rtol, atol = GEMM_TOL[dtype]
        if dtype == torch.float32:
            atol *= float(want.abs().max())
        err, ok = mismatch(c["out"], want, rtol, atol)
        if not ok:
            failures.append(f"learned {m}x{n}x{k} {dtype}: max err {err}")
        plan_cfg, _ = plan_gemm(m, n, k, dtype=dtype, graph=graph,
                                route=operand_route(a, b))
        plan_ms = time_ms(lambda: gemm(a, b, tile=plan_cfg.tile), LEARNED_REPS)
        learned_ms2 = time_ms(lambda: gemm(a, b, tile=c["tile"]), LEARNED_REPS)
        plan_ms2 = time_ms(lambda: gemm(a, b, tile=plan_cfg.tile),
                           LEARNED_REPS)
        library_ms = time_ms(lambda: torch.matmul(a, b), LEARNED_REPS)
        l_bound = bound(a.element_size() * (m * k + k * n + m * n),
                        2.0 * m * n * k, dtype)
        emit({"phase": "learned_gemm", "layer": c["layer"], "m": m, "n": n,
              "k": k, "dtype": dtype_name(dtype),
              "model_block": list(c["block"]), "tile": list(c["tile"]),
              **launch_fields(a, b, c["tile"], m, n, k),
              "predict_ms": c["predict_ms"],
              "learned_ms": c["learned_ms"], "learned_ms_2": learned_ms2,
              "plan_block": list(plan_cfg.block),
              "plan_tile": list(plan_cfg.tile), "plan_split": plan_cfg.split,
              "plan_ms": (plan_ms + plan_ms2) / 2, "library_ms": library_ms,
              "library": "torch.matmul", "bound_ms": l_bound[0],
              "bound_by": l_bound[1], "max_abs_err": err, "rtol": rtol,
              "atol": atol, "ok": ok})

    # the recurrent schedule on the modeled GPU beside K4's partition
    for c in gru_cases:
        batch, hidden = c["bh"]
        t0 = time.perf_counter()
        _, sel = gru_selection(batch, hidden)
        rs = schedule_recurrent(sel, graph, carry={"Hout": "H"},
                                streamed=("X",))
        rec_s = time.perf_counter() - t0
        u_copied = sum(op.region.nbytes() for op in rs.recursive.ops
                       if op.kind == "copy" and op.region.buffer in U_BUFFERS)
        f32_launch = gru_seq_launch(batch, hidden, hidden, sms, smem_limit)
        bf_launch = gru_seq_launch(batch, hidden, hidden, sms, smem_limit,
                                   torch.bfloat16)
        emit({"phase": "recurrent", "batch": batch, "hidden": hidden,
              "inp": hidden, "target": graph.name,
              "copies": rs.copy_counts(),
              "recursive_u_bytes_copied": u_copied,
              "u_bytes_f32": 3 * hidden * hidden * 4,
              "makespan_s": {name: getattr(rs, name).makespan
                             for name in ("prime", "recursive", "finish")},
              "total_time_128_s": rs.total_time(STEPS),
              "seconds": rec_s,
              "k4_u_bytes_on_chip": f32_launch.u_bytes_on_chip,
              "k4_u_bytes": f32_launch.u_bytes,
              "k4_bf16_u_bytes_on_chip": bf_launch.u_bytes_on_chip,
              "k4_bf16_u_bytes": bf_launch.u_bytes,
              "k4_f32_seq_ms": c["seq_ms"]})

    # the compiled blocks against the float64 reference, and timed
    for b in blocks:
        cg, cfg, inputs = b["cg"], b["cfg"], b["inputs"]
        want = block_reference(inputs, cfg, GRAPH_SEQ, device=dev,
                               return_all=True)
        held = hold_graph(b["env"], want)
        if held["mismatched"] or (b["size"] == "trace"
                                  and held["tolerance_tensors"]):
            failures.append(f"graph {cg.name}: tensors off the reference: "
                            f"{held['mismatched']}, "
                            f"{held['tolerance_tensors']} above 2^24")
        with torch.no_grad():
            lib_out = eager_block(inputs, cfg)
        lib_err = float((lib_out.double() - want["y2"].double()).abs().max())
        nbytes = sum(cg.graph.tensors[t].nbytes
                     for t in (*cg.graph.inputs, *cg.graph.outputs))
        g_bound = bound(nbytes, b["flops"], torch.float32)
        run = lambda: cg.execute(inputs, device=dev)    # noqa: E731
        emit({"phase": "graph", "graph": cg.name, "size": b["size"],
              "fused": b["fused"], "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "seq": GRAPH_SEQ,
              "nodes": len(cg.graph.nodes), "gemm_nodes": b["gemm_nodes"],
              "k1_launches": b["k1_launches"],
              "stream_nodes": b["stream_nodes"], **held,
              "execute_ms": time_ms(run, 5),
              "node_ms": node_ms(cg, b["env"], dev),
              "device_ms": device_ms(run, 3, K1_KERNELS, "k1", other=True),
              "reference_ms": time_ms(lambda: block_reference(
                  inputs, cfg, GRAPH_SEQ, device=dev), 5),
              "library_ms": time_ms(lambda: eager_block(inputs, cfg), 5),
              "library": "eager torch f32 (torch.matmul, TF32 off)",
              "library_max_err_over_max_ref":
              lib_err / float(want["y2"].abs().max()),
              "bytes": nbytes, "gflop": b["flops"] / 1e9,
              "bound_ms": g_bound[0], "bound_by": g_bound[1],
              "ok": not held["mismatched"]})

    # the serve phase needs the card's memory for qwen2-7b in f32 (30.5 GB)
    del gemm_cases, gru_cases, wide, wide_model, blocks
    torch.cuda.empty_cache()
    with counted("serve", ()):
        run_serve(dev, args.seed, failures)
    torch.cuda.empty_cache()
    with counted("train", ()):
        train = run_train(dev, args.seed, failures)
    with counted("train_placed", ()):
        run_train_placed(dev, args.seed, failures, train)
    with counted("dryrun", ()):
        run_dryrun(failures)

    launches = {name: sum(p[name] for p in phase_launches.values())
                for name in counters}
    kernels = [
        entry("gemm", "src/repro_torch/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:103", launches["gemm"], k1),
        entry("gemm_bias_act", "src/repro_torch/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:157", launches["gemm_bias_act"], k2),
        entry("gru_cell", "src/repro_torch/csrc/gru.cu",
              "src/repro/kernels/gru.py:83", launches["gru_cell"], k3),
        entry("gru_seq", "src/repro_torch/csrc/gru.cu",
              "src/repro/kernels/gru.py:106", launches["gru_seq"], k4),
    ]
    emit({"clocks_power": nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")})
    emit({"kernels": kernels})
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    if unlaunched:
        failures.append(f"kernels never launched on the main path: {unlaunched}")
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
