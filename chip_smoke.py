"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA card and the CUDA toolkit (nvcc). It needs no network and one card.

Phases (any failure exits non-zero and prints no result):

1. device — the card's name and power limit, the torch/CUDA versions, and
   the build of the kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, all started together; nvcc's register and
   shared-memory report);
2. kernels — every level kernel over its variants (global mask none /
   [d] / [W, d], mask_in on/off, pinned ‖e′‖² on/off, a ``valid == 0``
   lane, a ``p == 0`` lane, a τ = +inf lane) and every τ-search kernel
   over its variants (γ_in on/off × the three global-mask forms, a
   ``p == 0`` lane, the histogram at branch 64 and at a branch past
   shared memory, magnitudes on the histogram's bin edges and NaN, ±inf,
   ±0 and subnormal magnitudes at both branches, taus in any order for
   ``count_ge_level``, and ``count_ge_level`` on five lanes whose rank
   tables cover other ranges — all taus ≤ 0; ties, ±inf and NaN; all
   equal; subnormals to 1e30; a first scan round — with each lane's rows
   on its table's edges, B = 1, 64 and 4095, float32 and bfloat16 rows, at
   d = 2**20 + 77) at the paper's shapes (W = 1 and 28,
   d = 7850) and a large ragged one (W = 8, d = 2**23 + 125; one variant
   per τ-search kernel there), each output held bit for bit against the
   kernel's plain PyTorch version run on the CPU on the same inputs; then
   each kernel timed with CUDA events beside its plain version on the card
   and its bound; the four kernels that take a global mask also in its
   cohort-shared [B, d] form (``gmask_cohorts=B``) at the large shape with
   B = 2 and 8 and at the paper's batched round (8 cohorts × 28 lanes,
   d = 7850), held and timed the same way (the bound counts B·d mask
   bytes). Then the resident forms (``cl_fuse_select_level``,
   ``tau_search_fused_level``, ``ia_fuse_select_level``: one block per
   lane, the lane in shared memory) at W = 1 and 28, d = 7850, and at the
   largest resident d, over every operand form (γ_in on/off, the pinned
   ‖e′‖² on/off, the four global-mask forms and, for the IA step's TC-SIA,
   a mask with values other than 0 and 1; the IA step for SIA, RE-SIA and
   TC-SIA, exact and with a given τ) and ``ref.resident_edge_lanes``' edge
   lanes (ties straddling the q-th value, NaN and ±inf, zeros with γ_in
   −0.0, p = 0, valid = 0, a NaN τ) for q ≤ 0 … q > d, bit for bit against
   their plain versions on the CPU (a NaN equal to any NaN); a level of
   d + 1 of CL-SIA, SIA, RE-SIA and TC-SIA must take the multi-block
   kernels; each timed beside its plain version, the chain it replaces on
   the same inputs and its bound;
3. main path, exact Top-Q — the paper simulator (K = 28, d = 7850,
   ``kernel_mode="auto"``) on the card, after one warm-up round of each
   algorithm, for 20 rounds of each algorithm on the chain and of each
   fused algorithm on a star tree, with launch counts read around those
   runs, each run's launches held to the prediction of
   ``tests/_torch_launches.py`` (exact CL-SIA and CL-TC-SIA one
   ``cl_fuse_select_level`` a level, SIA, RE-SIA and TC-SIA one
   ``ia_fuse_select_level``); the loss must fall, CL-SIA's bits must
   equal the §V closed form every round on both topologies, and a short
   run must agree with the same run on the CPU; one exact level of each
   fused kind's device ops (torch.profiler) must hold no sort, no kernel
   of the multi-block forms and one resident launch; then torch.profiler
   reads the device-busy share of a few rounds;
4. main path, threshold Top-Q — the same simulator with
   ``topq_impl="threshold"`` for each fused algorithm on the chain and the
   star, under ``tau_impl="scan"`` (3 rounds of 64 candidates) and
   ``"hist"`` (2 rounds), 20 rounds each after a warm-up, with launch
   counts read around the runs and held to the prediction of
   ``tests/_torch_launches.py`` (the scan one ``tau_search_fused_level``
   a level at d = 7850, SIA, RE-SIA and TC-SIA one
   ``ia_fuse_select_level`` after it); hist must equal
   the scan at 2 rounds bit for bit (bits and loss per round), 3 rounds on
   the card fed the CPU run's gradients must give the CPU run's τ, count
   integers, model and bits bit for bit (loss to rtol 1e-4), the loss must
   fall, and ``threshold_for_topq(count_fn=count_ge_level)`` on the card
   must give the default search's τ; torch.profiler reads the device-busy
   share of a threshold round;
5. the scalar kernel API — the five scalar ``[d]`` kernels, checked in
   phase 2 over their variants (float32 and bfloat16, mask_in on/off,
   include_gamma on/off, shuffled taus with −1, 0 and +inf, the scalars as
   numbers and as tensors on the card) at d = 7850, 10**6 and 2**26 + 125
   bit for bit against their plain versions on the CPU and on the card,
   and timed, and ``count_ge`` on the bucket edges of its rank table with
   B = 1, 64 and 4095 (4096 refused); then driven through the ``ops`` entries with launch counts
   read around the run: the 1-D τ search ``threshold_for_topq(x, q,
   count_fn=ops.count_ge)`` at d = 10**6 for three q, and a 28-node chain
   of scalar node steps at d = 7850 for SIA (``count_ge_fused``,
   ``sparsify_ef``, ``chain_accum``) and CL-SIA (``count_ge_fused``,
   ``cl_fuse``), τ left on the card; τ, γ, the EF rows and nnz must equal
   the same run on the CPU bit for bit;
6. routed constellation trees — the paper simulator (K = 28, d = 7850,
   exact Top-Q) on ``walker_delta(4, 7, gateways=(1, 15))`` routed by
   widest path, 20 rounds each after a warm-up: CL-SIA and SIA with
   ``tree_topology`` and a ``FailureSchedule`` that kills client 0 in
   rounds 2-7 (the tree re-routes from (L, W) = (8, 5) to (10, 4)), CL-SIA
   on a ``TopologySchedule.from_link_events`` schedule (two trees padded to
   one shape, so ``valid == 0`` lanes reach the kernels), and SIA on the
   bandwidth-aware plan (per-client ``q_budget``); level-kernel launches
   held to one per level of each round's plan, the loss must fall, CL-SIA's
   bits must equal the §V closed form over the live uplinks every round,
   three rounds across a re-route on the card fed the CPU run's gradients
   must give the CPU's model, EF rows, bits and nnz bit for bit (loss to
   rtol 1e-4), and a padded plan must give the same round as the same plan
   unpadded; ms per round beside the chain round of the same run, and
   torch.profiler's device-busy share of a tree round;
7. multi-tenant cohort rounds — ``Simulator.run_batched`` (K = 28,
   d = 7850, B = 8 seeds, 10 rounds after a warm-up): TC-SIA and CL-TC-SIA
   on the chain and the star, CL-TC-SIA on phase 6's Walker tree through
   its relay failure, and TC-SIA under threshold Top-Q (scan and hist) on
   the chain; level-kernel launches held to one per level of each round's
   plan for all cohorts together (not B per level), every cohort equal to
   the sequential ``run(seed)`` on the card bit for bit (model, EF rows,
   bits, nnz), the loss falling in every cohort, three batched rounds on
   the card fed the CPU's gradients equal to the CPU's bit for bit (four
   of the runs), and a ``RoundScheduler`` fed a chain, a star, a Walker
   tree and a K = 4 chain meeting no more input signatures than buckets;
   then one batched round against B sequential rounds at B = 1, 2, 4, 8
   (host clock), and torch.profiler's device ops and busy time of a
   batched round;
8. nested plans, the trace collector and scenarios — the level kernels
   (table rows 1-5) at an upper stage's shapes (W = 1, 2, 4 lanes at
   d = 7850, ``g`` a view of sink rows inside the inbox) bit for bit
   against their plain versions; then the paper simulator (K = 28,
   d = 7850) with ``nested_topology``: CL-SIA on ``pod_ring_nested(4, 7)``
   and CL-TC-SIA and SIA on ``cluster_routed(walker_delta(4, 7,
   gateways=(1, 15)), 4)`` for 20 rounds, TC-SIA under threshold scan and
   hist for 3, each under a ``TraceCollector``: level-kernel launches held
   to Σ over rounds of Σ_s L_s, each stage's bits equal to its staged
   closed form (CL) or under its staged bound (SIA, TC-SIA) every round,
   the loss falling; a clustered Walker scenario (a relay crash and a
   ground-link flap, 20 rounds) recorded under a collector, its trace
   valid and exact against the report's closed-form check, one input
   signature, and a replay from the trace giving the same round records;
   three nested rounds on the card fed the CPU's gradients equal to the
   CPU's bit for bit, stage EF tiers included; ms per round with the
   collector off, flushing every round and every 32 rounds, and of the
   flat Walker tree round, timed in five turns (medians); torch.profiler's
   device ops and busy time of a nested round;
9. the client-per-rank device backend — a mesh of K = 28 ranks all on
   ``cuda:0`` (one card; with two or more cards the ranks also go
   round-robin over them and must give the same run): ``execute_sharded``
   on the card against host ``execute`` on the card and against
   ``execute_sharded`` on a CPU mesh, bit for bit (aggregate, EF rows,
   nnz_*, bits; ``err_sq`` under the pinned in-kernel order and on W = 1
   plans, else to rtol 1e-6), for the six kinds on the chain, a permuted
   chain, ``star_tree(28)`` and phase 6's Walker tree with stragglers,
   both wires on the CL kinds and bf16 gradients; then
   ``Simulator(backend="device")`` beside ``backend="host"`` on the card,
   bit for bit over whole runs (model, EF, stage EF tiers, τ, bits, nnz,
   loss): CL-SIA on the chain and CL-TC-SIA on the Walker tree through its
   relay failure (5 rounds), TC-SIA threshold scan and hist (3 rounds),
   CL-SIA on ``pod_ring_nested(4, 7)`` (5 rounds) and ``run_batched`` with
   4 seeds on the Walker tree, level-kernel launches held to the plans'
   real slots; three device rounds on the card mesh fed the CPU's
   gradients equal to the CPU mesh's; phase 8's Walker scenario on the
   device backend, its trace valid and equal to the host trace's records
   (per-hop ``err_sq`` to rtol 1e-6); ``obs.smoke --device --mesh
   cuda:0``; then ms per round of the device backend beside the host
   backend on the chain, the star, the Walker tree and the pod ring, in
   five alternating turns (medians and ranges), and torch.profiler's device
   ops and busy time of a device round;
10. the rotated-segment lowering — the same 28 ranks on ``cuda:0``, the
   paper's d = 7850 padded to n = 7868 (281 per segment) and its budget per
   segment (``segment_budget(78 · 28, 28)``): ``run_plan_segments_local``
   for the six kinds on the ring's chain, a permuted chain,
   ``star_tree(28)`` and phase 6's Walker tree, CL-SIA and SIA on the Walker
   tree with client 0 dead and bandwidth budgets, TC-SIA under threshold
   scan, with stragglers — each segment equal to host ``execute`` on the
   card under the rotation relabelling (``execute_batched`` over the 28
   segments, ``execute`` alone on two), the ranks equal to the CPU mesh's,
   the butterfly equal to the static transport, four rounds on ranks
   alternating CPU / card equal to the CPU mesh's, bit for bit (``err_sq``
   under ``"jnp"`` to rtol 1e-6), level-kernel launches one per level;
   ``run_plan_segments_batched`` with 4 cohorts equal to each cohort's
   sequential round; ``hierarchical_ring_local`` and
   ``run_nested_segments_local`` on sizes (7, 4) — the plane-aligned
   ``cluster_routed`` Walker plan (static) and per-pod trees (the
   butterfly) — equal to the staged host reference on the card and to the
   CPU mesh, and ``cluster_routed(walker, 4)`` refused (not mesh-aligned);
   ``threshold_for_topq`` over 8 card shards (1-D at d = 10**6 counting
   with ``count_ge``, [4, 2**18] with ``count_ge_level``), scan and hist,
   equal to the unsharded search in τ and counts; then ms per segments
   round of the ring, the star, the Walker tree (static and butterfly),
   the pod ring and the ring at n = 28 · 2**18 beside ``execute_sharded``
   and host ``execute`` on the same rows, in five alternating turns, and
   torch.profiler's device ops and busy time of segments rounds;
11. the LM serving path (no kernel of its own: plain PyTorch on the card)
   — (a) every SMOKE architecture in float32: ``forward`` (with the vision
   and audio stub embeddings where the architecture has a frontend, and
   without), the MoE aux, ``prefill`` of all tokens but the last and
   ``decode_step`` of the last, with the caches, on the card and on the
   CPU from one ``torch.Generator``'s weights, card = CPU to rtol = atol =
   1e-3; on the card prefill and decode = ``forward`` at the reference
   test's rtol = atol = 2e-2, and mixtral's SWA ring cache 16 steps past
   its window (3e-2); (b) full width through ``launch.serve.generate``:
   batch 4, prompt 512, 32 generated tokens, bf16, for phi4-mini-3.8b (32
   layers), mamba2-130m (24 layers) and mixtral-8x7b at full widths with 2
   layers (and no token dropped); prefill's and every decode step's logits
   = the teacher-forcing ``forward`` over the prompt and the generated
   tokens (relative L2 ≤ 5e-2 and max |Δ| ≤ 0.5 over the real vocabulary
   per request and step; for the MoE on 95 % of the pairs, since a bf16
   rounding can move a token to another expert pair), every logit finite,
   and the same three models in float32 to relative L2 ≤ 1e-4 on every
   pair; (c) one full-width float32
   layer of phi4, mixtral and mamba2 on 2 × 32 tokens, card = CPU to rtol
   = atol = 1e-4; (d) prefill ms, decode ms per step (median after 2
   warm-up steps), tokens/s, weight and cache bytes, peak device memory,
   the step's bound (weight + cache bytes over 3.35 TB/s) and its share,
   and torch.profiler's device ops and busy time of one decode step;
12. LM training (``train.step.build_train_step``: autograd through the
   models, the rotated-segment lowering with the level kernels per model
   column, the flat AdamW) — (a) every SMOKE family (dense, MoE, SSM,
   hybrid) in float32 on ranks of ``cuda:0``: CL-SIA and CL-TC-SIA
   (threshold, hist) on 4 × 1 and 2 × 2 meshes, the ``"hierarchical"``
   plan on 2 × 2 × 1 and ``cohorts=2``, 3 steps with a straggler, each
   step from the CPU's state: the whole card step's loss = the CPU's to
   rtol 1e-5 (exact Top-Q: also bits and nnz equal, the transmitted
   support equal but for swaps at ties, master and params to 1e-4), and
   phases 2–3 on the card fed the CPU's gradient columns: EF, stage EF,
   ``tcs_prev``, bits and nnz bit for bit, the optimizer to 1e-6; each
   step launches the level kernels as often as its plan has levels per
   column; (b) phi4-mini-3.8b at full widths (depth cut, ``TRAIN_FULL_WHY``)
   in bf16 with the launcher's ``TrainConfig`` defaults on 2 × 2 ranks of
   ``cuda:0``, batch 8 × 512 random tokens: 5 CL-SIA (exact) steps, then 5
   CL-TC-SIA (threshold scan) steps; the loss finite, CL-SIA's bits = the
   §V closed form every step, the launches as predicted (``count_ge`` for
   the TCS τ_G scan), the peak memory under 80 GB; (c) ``launch/train``
   for mamba2-130m (24 layers) on ``--mesh 4x1 --device cuda:0``, 6 steps
   with a checkpoint every 3, then a resume to step 8: "resumed from step
   6", the restored state = the saved arrays bit for bit; (d) for (b) and
   (c) the step ms (median after a warm-up step, host clock after a
   synchronize), phase 2's ms and share, torch.profiler's device ops and
   busy ms per step, and the peak memory (and the peak of the init and the
   timed steps alone: the profiled steps keep a third state alive);
13. the dry run against the card (``launch/dryrun.py``: the port's step on
   fake tensors, no kernel launched) — (a) ``dry_run_cell`` on fake
   ``cuda:0`` tensors for phase 12's phi4 cell (its mesh, batch and
   CL-SIA config) and phase 11's three served models (the larger of a
   prefill of the prompt and a decode at prompt + generated tokens, batch
   4), each predicted device peak within ±1 % of the peak those phases
   measured, less the bytes live before them (phase 12: its init and
   timed steps), and AdamW's second moment and the error feedback each a
   larger share of phase 12's peak than the gate (a prediction without
   either fails); (b) every full SHAPES cell whose arguments alone fit
   72 GB on one card (``launch/dryrun.home_bytes``, from specs) is
   predicted by ``python -m repro_torch.launch.dryrun --arch … --shape …
   --mesh 1x1``, one background process per cell started with the phase,
   CUDA hidden from them; each predicted to fit runs one step here from
   seeded weights, mamba2-130m × decode_32k and × long_500k always, the
   others until the phase's 60 s run out, each within ±1 % and its ms
   logged; (c) the cells predicted not to fit one card, with their
   predicted peaks or their arguments' bytes;
14. the train state placed by rank on a mesh that mixes the card and the
   CPU (``train.step.init_state`` on 4 × 1 ranks ``cuda:0, cpu, cpu,
   cpu``: master, AdamW moments and EF pieces on their ranks' devices,
   the params whole on ``cuda:0`` and on the CPU) — mamba2-130m at full
   widths, 4 of 24 layers (``PLACE_WHY``), bf16, the launcher's
   ``TrainConfig`` defaults (AdamW) and then SGD, batch 8 × 64 random
   tokens, 3 CL-SIA steps each:
   every piece on its rank's device after the init and every step; each
   step's phases 2–3 also run on ``["cuda:0"] * 4`` from the same state
   and gradient columns, and the gathered placed state must equal it —
   EF, bits and nnz bit for bit, master and params bit for bit under SGD
   and to 1e-6 of their scale under AdamW (the CPU ranks round AdamW's
   ``sqrt``/``pow`` apart from the card); the card's level kernels launch
   once per level for the card's rank (the CPU ranks run the plain
   versions); the card's peak over the first AdamW step, less the bytes
   live before the phase, within ±1 % of ``launch/dryrun.dry_run_cell``'s
   prediction for ``cuda:0`` on the same mixed mesh; the state bytes on
   ``cuda:0`` against the whole state's, and the step ms;
15. tensor-parallel client compute over ``model`` (phase 12 (b) runs it
   too: a mesh with ``model > 1`` splits phase 1) — (a) phi4-mini-3.8b at
   full widths, 2 of 32 layers (``TRAIN_FULL_WHY``), 2 × 2 ranks of
   ``cuda:0``, bf16, AdamW, batch 8 × 512, CL-SIA exact and CL-TC-SIA
   threshold: M = 2 divides the heads, kv heads, ``d_ff`` and the padded
   vocabulary, so every leaf but the norms' scales is split; 1 + 3 steps
   with phase 1 timed apart, the launches as predicted, one profiled step
   (device ops, busy ms), the peak of the init and the timed steps within
   ±1 % of ``dry_run_cell``'s prediction (phase 13's gate); each client's
   TP columns against its whole-model autograd gradient through
   ``local_flatten(·, m)`` (bf16 norm check, ``TP_GRAD_TOL``), and the
   step fed the TP columns against the same step fed the whole-model ones
   (``flat_step_error``: the change's relative L2 off the support swaps,
   ``TP_STEP_TOL``, and ``assert_step_close``'s max rule logged); (b)
   ranks ``cuda:0, cpu, cuda:0, cpu`` (each client's rank 1 on the CPU, so
   the TP sums and the batch-over-model reduction cross devices) with the
   phi4 SMOKE model (tied, pad slots in its vocabulary; tensor-parallel)
   and the mamba2 SMOKE model (batch over model), f32, SGD, 3 CL-SIA steps
   each from the all-card step's state: the change within 1e-6 of the
   all-card step's scale, the loss to 1e-5, the card's level kernels once
   per level for each column's card; (c) (a)'s phi4 cell on 2 × 16 ranks
   of ``cuda:0`` (``TP_SEQ_MESH``): 16 divides neither its 24 q heads nor
   its 8 kv heads, so each client's attention splits by query sequence
   (the reference's ``_constrain_scores`` rule, ``attention.
   query_blocks``): one CL-SIA step, its attention calls counted by the
   rank whose query block they take (all 16 alike, none whole), its
   launches as predicted, the peak of the init and the step within ±1 % of
   ``dry_run_cell``'s prediction for the mesh, the fullest rank's peak on
   one fake device a rank beside the parent's form's (the sub-layer whole
   on rank (k, 0)), and the TP columns and the step fed them as (a)'s;
16. serving split over ranks of the card (``models/serve_split.py``: the
   params placed by ``param_pspecs``, the cache by ``cache_pspecs``) —
   SMOKE mixtral (its 32-slot SWA ring, heads over ``model`` on 2 × 2 with
   batch 2, the ring's slots over ``model`` on 1 × 3 with batch 1) and
   SMOKE zamba2 (2 × 2, batch 2) in f32, the split run on ranks of
   ``cuda:0`` against the same split run on ranks of the CPU and against
   the whole run on the card (rtol = atol = 1e-3); then phi4-mini-3.8b at
   full width, all 32 layers, on ranks of ``cuda:0`` (``SPLIT_CASES``):
   (a) 2 × 2, batch 4, prompt 512, 16 tokens — requests over ``data``,
   heads and kv heads over ``model``; (b) 2 × 2, batch 1, prompt 2,048, 8
   tokens — the cache sequence over ``data`` (split-K decode); (c) 1 × 3,
   batch 4, prompt 512, 8 tokens — 8 kv heads do not divide 3, so the
   cache sequence goes over ``model``:
   each split prefill and decode step fed the whole ``launch.serve.
   generate`` run's tokens (teacher forcing), its logits within phase 11's
   limits of the whole run's on every (request, step) in bf16 (relative
   L2 ≤ 5e-2, max |Δ| ≤ 0.5) and, for (a), in f32 (relative L2 ≤ 1e-4);
   then ``build_prefill_step``/``build_serve_step`` on the same mesh (a
   cache of ``serve_split.init_cache``), fed the same tokens, give the
   split run's argmax at every (request, step), as int32;
   (a)'s peak, less the bytes live before it, within ±1 % of
   ``dry_run_cell``'s prediction for the same mesh of ``cuda:0`` (phase
   13's gate); prefill ms, decode ms per step and torch.profiler's device
   ops beside the whole form's (a warm-up run first). No kernel of the
   port is on this path.

The last lines are a JSON object of per-kernel numbers, the card's
``name, power.limit`` as nvidia-smi prints them, and the result object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
LARGE = (8, 2 ** 23 + 125)
PAPER_SHAPES = [(1, 7850), (28, 7850)]
ROUNDS = 20
SEED = 0
BRANCH = 64                        # candidates per τ-search round
WIDE_BRANCH = 256                  # a histogram past shared memory
THRESHOLD = {"scan": dict(tau_impl="scan", hist_rounds=3),
             "hist": dict(tau_impl="hist", hist_rounds=2)}
# the scalar [d] kernels: the paper's d, bench_kernels.py's default, and
# the level phases' element count W·d = 8 × 2**23 with a ragged tail
SCALAR_SHAPES = [7850, 1_000_000, 2 ** 26 + 125]
SCALAR_DTYPES = (torch.float32, torch.bfloat16)
SEARCH_D = 1_000_000               # the 1-D τ search counting with count_ge
SEARCH_QS = (10, 500, 5000)
EDGE_TAUS = (1, 64, 4095)          # count_ge on its rank table's edges
LANES_D = 2 ** 20 + 77             # count_ge_level on its special lanes


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def per_level(d: int, budgets: bool = False, **cfg_kw) -> dict:
    """Level-kernel launches of one fused level step whose lanes hold d
    elements, under the ``AggConfig`` of ``cfg_kw``, as
    ``tests/_torch_launches.py`` states them (the resident forms for d up
    to 49,152), apart from the port's dispatch code."""
    from _torch_launches import level_launches
    from repro_torch.core.algorithms import AggConfig

    return level_launches(AggConfig(**cfg_kw), d, budgets=budgets)


def scaled(launches: dict, n: int) -> dict:
    return {name: c * n for name, c in launches.items()}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(w: int, d: int, seed: int) -> dict:
    """numpy inputs for one level; lanes 1 / 2 / last are the straggler,
    padding and τ = +inf lanes where W allows."""
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal((w, d), dtype=np.float32)
    x = dict(g=f(), e=f() * np.float32(0.3), gin=f(),
             weight=rng.uniform(0.2, 2.0, w).astype(np.float32),
             tau=np.full(w, 1.0, np.float32),
             part=np.ones(w, np.float32), valid=np.ones(w, np.float32),
             gm=(rng.random(d, dtype=np.float32) < 0.1).astype(np.float32),
             gmw=(rng.random((w, d), dtype=np.float32) < 0.1).astype(
                 np.float32),
             mask=(rng.random((w, d), dtype=np.float32) < 0.01).astype(
                 np.float32))
    x["gin"] *= rng.random((w, d), dtype=np.float32) < 0.3
    if w > 1:
        x["part"][1] = 0.0
        x["tau"][-1] = np.inf
    if w > 2:
        x["valid"][2] = 0.0
    return x


def variants():
    """(kernel name, options) for every variant of each kernel."""
    for gm in (None, "gm", "gmw"):
        for mask in (False, True):
            for err in (False, True):
                yield "cl_fuse_level", dict(gm=gm, mask=mask, err=err)
    for mask in (False, True):
        for err in (False, True):
            yield "sparsify_ef_level", dict(gm=None, mask=mask, err=err)
    for gm in (None, "gm", "gmw"):
        yield "chain_accum_level", dict(gm=gm, mask=False, err=False)


def call(fns, name: str, t: dict, opt: dict):
    """Call kernel ``name`` (from ``fns``: the CUDA wrappers or the plain
    versions) on tensors ``t`` with variant ``opt``."""
    gm = t[opt["gm"]] if opt["gm"] else None
    mask = t["mask"] if opt["mask"] else None
    if name == "cl_fuse_level":
        return fns[name](t["g"], t["e"], t["gin"], t["weight"], t["tau"],
                         t["part"], t["valid"], gm, mask,
                         with_err=opt["err"])
    if name == "sparsify_ef_level":
        return fns[name](t["g"], t["e"], mask, t["weight"], t["tau"],
                         t["valid"], with_err=opt["err"])
    return fns[name](t["gin"], t["g"], t["valid"], gm)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu(), b.cpu()
    # equal bits differ by 0; the widened difference of 67 M elements
    # takes seconds on the host, the bit compare a few milliseconds
    if bitwise_equal(a, b):
        return 0.0
    wide = torch.float64 if a.is_floating_point() else torch.int64
    return float((a.to(wide) - b.to(wide)).abs().max())


BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (zeros' signs included)."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in BITS:
        a, b = a.view(BITS[a.dtype]), b.view(BITS[b.dtype])
    return torch.equal(a, b)


def kernel_bytes(name: str, w: int, d: int, mask_rows: int = 1) -> int:
    """Bytes the timed variant must move: each input read once, each
    output written once (per-lane scalars and counts included); the global
    mask is ``mask_rows`` rows of d (1: lane-shared, B: cohort-shared)."""
    m = mask_rows * d
    if name == "cl_fuse_level":        # g,e,γ_in,mask_in,gm → γ,e′
        return (6 * w * d + m) * 4 + 4 * w * 4 + 2 * w * 4
    if name == "sparsify_ef_level":    # g,e,mask_in → ḡ,e′
        return 5 * w * d * 4 + 3 * w * 4 + w * 4
    return (3 * w * d + m) * 4 + w * 4 + 2 * w * 4   # γ_in,ḡ,gm → γ


TIMED = {"cl_fuse_level": dict(gm="gm", mask=True, err=False),
         "sparsify_ef_level": dict(gm=None, mask=True, err=False),
         "chain_accum_level": dict(gm="gm", mask=False, err=False)}


def cuda_time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernels(level, ref) -> dict:
    cuda_fns = {"cl_fuse_level": level.cl_fuse_level_cuda,
                "sparsify_ef_level": level.sparsify_ef_level_cuda,
                "chain_accum_level": level.chain_accum_level_cuda}
    plain_fns = {"cl_fuse_level": ref.ref_cl_fuse_level,
                 "sparsify_ef_level": ref.ref_sparsify_ef_level,
                 "chain_accum_level": ref.ref_chain_accum_level}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in cuda_fns}
    dev = torch.device("cuda")
    for si, (w, d) in enumerate(PAPER_SHAPES + [LARGE]):
        t0 = time.perf_counter()
        x = make_inputs(w, d, SEED + si)
        cpu = {k: torch.from_numpy(v) for k, v in x.items()}
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        for name, opt in variants():
            got = call(cuda_fns, name, gpu, opt)
            torch.cuda.synchronize()
            want = call(plain_fns, name, cpu, opt)
            on_card = call(plain_fns, name, gpu, opt)
            r = report[name]
            for a, b, c in zip(want, got, on_card):
                r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(a, b))
                r["max_abs_err_plain_on_card"] = max(
                    r["max_abs_err_plain_on_card"], max_abs_diff(c, b))
                if not bitwise_equal(a, b):
                    raise SystemExit(
                        f"FAIL {name} {opt} at W={w} d={d}: kernel differs "
                        f"from its plain version on the CPU "
                        f"(max |diff| {max_abs_diff(a, b)})")
            r["checked"] += 1
        log(f"[kernels] W={w} d={d}: all variants bitwise equal to the "
            f"plain CPU versions ({time.perf_counter() - t0:.1f} s)")
        # timing: every lane live, the main path's variant of each kernel
        gpu["valid"].fill_(1.0)
        gpu["part"].fill_(1.0)
        big = w * d > 10 ** 7
        for name, opt in TIMED.items():
            ms = cuda_time_ms(lambda: call(cuda_fns, name, gpu, opt),
                              20 if big else 200)
            plain_ms = cuda_time_ms(lambda: call(plain_fns, name, gpu, opt),
                                    5 if big else 50)
            bound_ms = kernel_bytes(name, w, d) / HBM_BYTES_PER_S * 1e3
            report[name]["shapes"].append(dict(
                W=w, d=d, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms))
            log(f"[time] {name} W={w} d={d}: kernel {ms:.4f} ms, plain "
                f"on card {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({100 * bound_ms / ms:.1f}% of bound)")
        del cpu, gpu
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 2 (continued): the τ-search kernels
# ---------------------------------------------------------------------------

def tau_variants(large: bool):
    """(kernel name, options) for the τ-search kernels; one variant each
    at the large shape, where the plain versions on the CPU take longest."""
    if large:
        yield "count_ge_fused_level", dict(gamma=True, gm="gm")
        yield "hist_topq_level", dict(gamma=True, gm="gm", branch=BRANCH)
        yield "count_ge_level", dict()
        return
    for gm in (None, "gm", "gmw"):
        for gamma in (False, True):
            yield "count_ge_fused_level", dict(gamma=gamma, gm=gm)
            for branch in (BRANCH, WIDE_BRANCH):
                yield "hist_topq_level", dict(gamma=gamma, gm=gm,
                                              branch=branch)
    for branch in (BRANCH, WIDE_BRANCH):
        yield "hist_topq_level", dict(gamma=False, gm=None, branch=branch,
                                      edges=True)
        yield "hist_topq_level", dict(gamma=False, gm=None, branch=branch,
                                      specials=True)
    yield "count_ge_level", dict()


def tau_tables(sp, ref, t: dict, opt: dict, branch: int):
    """The bracket tables of a first search round over the variant's
    operand (computed on the CPU; both sides get the same tables)."""
    op = ref.fused_operand(t["g"], t["e"], t["gin"], t["weight"],
                           t["part"], t[opt["gm"]] if opt["gm"] else None,
                           include_gamma=opt["gamma"])
    hi = torch.clamp(op.abs().amax(-1), min=1e-30) * sp._HI_SCALE
    return sp._hist_tables(torch.zeros_like(hi), hi, branch)


def edge_inputs(sp, ref, cpu: dict, branch: int, specials: bool) -> tuple:
    """→ (inputs, tables): operand = g exactly (w = 1, e = 0), with g on
    the bin edges of ``tables`` (the FMA-rounded round-2 candidates, tau1
    and the bracket tops) or, with ``specials``, NaN, ±inf, ±0 and
    subnormals in a tenth of lane 0 and an all-zero last lane (its tables
    take the zero-width floor)."""
    w, d = cpu["g"].shape
    plain = dict(cpu, e=torch.zeros_like(cpu["g"]),
                 weight=torch.ones(w), part=torch.ones(w))
    if specials:
        g = cpu["g"].clone()
        if w > 1:
            g[-1] = 0.0
        plain["g"] = g
    tables = tau_tables(sp, ref, plain, dict(gm=None, gamma=False), branch)
    if specials:
        g[0, :d // 10] = ref.special_magnitudes(d // 10, seed=SEED)
    else:
        g = ref.hist_edge_magnitudes(tables, d, seed=SEED)
    return dict(plain, g=g), tables


def call_tau(fns, name: str, t: dict, opt: dict, aux: dict):
    """Call τ-search kernel ``name`` (CUDA wrapper or plain version) on
    tensors ``t``; ``aux`` holds its taus or tables on the same device."""
    if name == "count_ge_level":
        return (fns[name](t["g"], aux["taus_any"]),)
    gm = t[opt["gm"]] if opt["gm"] else None
    operand = (t["g"], t["e"], t["gin"], t["weight"], t["part"])
    if name == "count_ge_fused_level":
        return (fns[name](*operand, aux["tables"][0], gm,
                          include_gamma=opt["gamma"]),)
    return fns[name](*operand, aux["tables"], gm, include_gamma=opt["gamma"])


def tau_cost(name: str, w: int, d: int, n: int,
             mask_rows: int = 1) -> tuple:
    """(bytes, f32 operations) the timed variant must spend: each input
    read once, each output written once; per element the operand's flops
    and the binary searches' compares (and candidate fmas), or for
    ``count_ge_level`` the table lookup (|x|, its bucket, one compare).
    The global mask is ``mask_rows`` rows of d."""
    search = math.ceil(math.log2(n + 1))
    if name == "count_ge_level":
        return (w * d + 2 * w * n) * 4, w * d * 3
    operand = (3 * w * d + mask_rows * d + 2 * w) * 4   # g, e, γ_in, gm, w, p
    flops = 6 + search                              # 2 fma, 1−m, ·, |·|
    if name == "count_ge_fused_level":
        return operand + 2 * w * n * 4, w * d * flops
    nb = n + 1
    tables = w * (n + 3 * nb) * 4
    outputs = w * (nb * nb + nb) * 4
    return operand + tables + outputs, w * d * (flops + 3 * search + 1)


TAU_TIMED = {"count_ge_fused_level": dict(gamma=True, gm="gm"),
             "hist_topq_level": dict(gamma=True, gm="gm", branch=BRANCH),
             "count_ge_level": dict()}


def check_tau_kernels(level, ref, sp) -> dict:
    cuda_fns = {"count_ge_fused_level": level.count_ge_fused_level_cuda,
                "hist_topq_level": level.hist_topq_level_cuda,
                "count_ge_level": level.count_ge_level_cuda}
    plain_fns = {"count_ge_fused_level": ref.ref_count_ge_fused_level,
                 "hist_topq_level": ref.ref_hist_topq_level,
                 "count_ge_level": ref.ref_count_ge_level}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in cuda_fns}
    shared_max = level.hist_shared_max_branch()
    if not BRANCH <= shared_max < WIDE_BRANCH:
        raise SystemExit(f"FAIL the histogram at branch {WIDE_BRANCH} "
                         f"would not take the global-atomics variant "
                         f"(shared memory holds up to {shared_max})")
    log(f"[tau] histogram in shared memory up to branch {shared_max}; "
        f"branch {WIDE_BRANCH} takes the global-atomics variant")
    dev = torch.device("cuda")
    for si, (w, d) in enumerate(PAPER_SHAPES + [LARGE]):
        t0 = time.perf_counter()
        large = (w, d) == LARGE
        x = make_inputs(w, d, SEED + 10 + si)
        cpu = {k: torch.from_numpy(v) for k, v in x.items()}
        rng = np.random.default_rng(SEED + si)
        taus = np.abs(rng.standard_normal((w, BRANCH))).astype(np.float32)
        taus[:, 5] = taus[:, 9]
        taus[:, 7], taus[:, 8], taus[:, 11] = np.inf, -np.inf, 0.0
        for name, opt in tau_variants(large):
            aux = {"taus_any": torch.from_numpy(taus)}
            if opt.get("edges") or opt.get("specials"):
                inp, aux["tables"] = edge_inputs(sp, ref, cpu, opt["branch"],
                                                 opt.get("specials", False))
            else:
                inp = cpu
                if name != "count_ge_level":
                    aux["tables"] = tau_tables(sp, ref, inp, opt,
                                               opt.get("branch", BRANCH))
            gpu = {k: v.to(dev) for k, v in inp.items()}
            aux_gpu = {k: (tuple(u.to(dev) for u in v)
                           if isinstance(v, tuple) else v.to(dev))
                       for k, v in aux.items()}
            got = call_tau(cuda_fns, name, gpu, opt, aux_gpu)
            torch.cuda.synchronize()
            want = call_tau(plain_fns, name, inp, opt, aux)
            on_card = call_tau(plain_fns, name, gpu, opt, aux_gpu)
            r = report[name]
            for a, b, c in zip(want, got, on_card):
                r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(a, b))
                r["max_abs_err_plain_on_card"] = max(
                    r["max_abs_err_plain_on_card"], max_abs_diff(c, b))
                if not bitwise_equal(a, b):
                    raise SystemExit(
                        f"FAIL {name} {opt} at W={w} d={d}: kernel differs "
                        f"from its plain version on the CPU "
                        f"(max |diff| {max_abs_diff(a, b)})")
            r["checked"] += 1
            del gpu, aux_gpu
        log(f"[kernels] W={w} d={d}: the τ-search kernels equal their plain "
            f"CPU versions integer for integer "
            f"({time.perf_counter() - t0:.1f} s)")
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        gpu["part"].fill_(1.0)
        for name, opt in TAU_TIMED.items():
            n = BRANCH
            aux = {"taus_any": torch.from_numpy(taus).to(dev)}
            if name != "count_ge_level":
                aux["tables"] = tuple(u.to(dev) for u in tau_tables(
                    sp, ref, cpu, opt, n))
            ms = cuda_time_ms(lambda: call_tau(cuda_fns, name, gpu, opt,
                                               aux), 20 if large else 200)
            plain_ms = cuda_time_ms(lambda: call_tau(plain_fns, name, gpu,
                                                     opt, aux),
                                    5 if large else 50)
            nbytes, ops = tau_cost(name, w, d, n)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            report[name]["shapes"].append(dict(
                W=w, d=d, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms))
            log(f"[time] {name} W={w} d={d} B={n}: kernel {ms:.4f} ms, "
                f"plain on card {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({100 * bound_ms / ms:.1f}% of bound)")
        # count_ge_level on bfloat16 rows (read as such, half the bytes)
        x16 = gpu["g"].to(torch.bfloat16)
        taus = torch.from_numpy(taus).to(dev)
        ms = cuda_time_ms(lambda: cuda_fns["count_ge_level"](x16, taus),
                          20 if large else 200)
        plain_ms = cuda_time_ms(lambda: plain_fns["count_ge_level"](x16,
                                                                    taus),
                                5 if large else 50)
        nbytes, ops = tau_cost("count_ge_level", w, d, BRANCH)
        nbytes -= w * d * 2
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        report["count_ge_level"]["shapes"].append(dict(
            W=w, d=d, dtype="bfloat16", ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_share=bound_ms / ms))
        log(f"[time] count_ge_level W={w} d={d} B={BRANCH} bfloat16: kernel "
            f"{ms:.4f} ms, plain on card {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of bound)")
        del cpu, gpu, x16
        torch.cuda.empty_cache()
    check_count_ge_level_lanes(cuda_fns["count_ge_level"], ref,
                               report["count_ge_level"])
    return report


def check_count_ge_level_lanes(count_ge_level, ref, r: dict):
    """count_ge_level at d = LANES_D on five lanes whose rank tables cover
    other ranges (``ref.count_level_edge_taus``), each lane's rows on its
    table's edges and its taus with NaN, ±inf, ±0 and subnormals in lane 0;
    B = 1, 64 and 4095 (MAX_TAUS); float32 and bfloat16 rows; the operand
    at an odd offset of a larger buffer; bit for bit against the plain
    version on the CPU. 4096 taus must be refused."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for n in EDGE_TAUS:
        taus = ref.count_level_edge_taus(n, seed=SEED + n)
        w, d = taus.shape[0], LANES_D
        x = ref.count_level_edge_rows(taus, d, seed=SEED + n)
        for dt in SCALAR_DTYPES:
            rows = x.to(dt)
            flat = torch.zeros(w * d + 1, dtype=dt, device=dev)
            flat[1:] = rows.reshape(-1).to(dev)
            want = ref.ref_count_ge_level(rows, taus)
            got = count_ge_level(flat[1:].view(w, d), taus.to(dev))
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(want, got))
            if not bitwise_equal(want, got):
                raise SystemExit(f"FAIL count_ge_level on its special lanes, "
                                 f"B={n} {dt}: kernel differs from its plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(want, got)})")
            r["checked"] += 1
    try:
        count_ge_level(x.to(dev), torch.ones((w, EDGE_TAUS[-1] + 1),
                                             device=dev))
    except ValueError:
        pass
    else:
        raise SystemExit(f"FAIL count_ge_level took {EDGE_TAUS[-1] + 1} "
                         f"taus")
    log(f"[kernels] count_ge_level on five special lanes at d={LANES_D}, "
        f"B in {EDGE_TAUS}, float32 and bfloat16: equal to the plain "
        f"version bit for bit; {EDGE_TAUS[-1] + 1} taus refused "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def paper_data():
    """The paper's configuration and synthetic MNIST on the card."""
    from repro_torch.configs import PAPER
    from repro_torch.data import make_synthetic_mnist, partition_iid

    pc = PAPER
    k = pc.num_clients
    train = make_synthetic_mnist(SEED, k * 500, device="cuda")
    test = make_synthetic_mnist(SEED + 1, 2000, device="cuda")
    fed = partition_iid(train, k, torch.Generator().manual_seed(SEED + 2))
    return pc, fed, test


def main_path(level, data) -> dict:
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed import Simulator
    from repro_torch.topo import star_tree

    pc, fed, test = data
    k = pc.num_clients
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    kinds = [AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
             AggKind.CL_TC_SIA, AggKind.DENSE_IA]
    runs = [(kind, "chain", None) for kind in kinds]
    runs += [(kind, "star", star_tree(k)) for kind in kinds
             if kind != AggKind.DENSE_IA]
    sims = {kind: Simulator(pc, AggConfig(kind=kind, **kw), fed,
                            device="cuda") for kind in kinds}
    results = {}

    # one untimed round of each first: the first use of each CUDA op
    # (sorts, cuBLAS, torch.func) costs seconds, once per process
    t0 = time.perf_counter()
    for sim in sims.values():
        sim.run(1, seed=SEED)
    torch.cuda.synchronize()
    log(f"[main] warm-up, one round of each algorithm: "
        f"{time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    path = set()
    for kind, topo_name, topo in runs:
        before = [fn.launches for fn in level.KERNELS]
        t0 = time.perf_counter()
        out = sims[kind].run(ROUNDS, seed=SEED, topology=topo,
                             test_x=test.x, test_y=test.y,
                             eval_every=ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[(kind, topo_name)] = out
        grown = {n: fn.launches - b for n, fn, b in
                 zip(names, level.KERNELS, before) if fn.launches - b}
        # the chain is k levels of one lane, the star one level of k; at
        # d = 7850 every exact level is one resident launch
        levels = ROUNDS * (k if topo is None else 1)
        want = scaled(per_level(pc.d, kind=kind, **kw), levels)
        if grown != want:
            raise SystemExit(f"FAIL {kind.value} {topo_name}: launches "
                             f"{grown}, predicted {want}")
        path |= set(want)
        log(f"[main] {kind.value:9s} {topo_name:5s}: loss "
            f"{out['loss'][0]:.4f} -> {out['loss'][-1]:.4f}, acc "
            f"{out['accuracy'][-1][1]:.3f}, bits/round "
            f"{out['bits'][-1]:.0f}, {1e3 * wall / ROUNDS:.2f} ms/round "
            f"(host clock, synchronized); launches {grown} (predicted)")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}
    log(f"[main] kernel launches over the main-path runs: {launches}")

    for name in path:
        if launches[name] <= 0:
            raise SystemExit(f"FAIL {name} was never launched on the "
                             f"main path")
    exact_level_ops(pc, kw)
    for (kind, topo_name), out in results.items():
        if not all(math.isfinite(v) for v in out["loss"]):
            raise SystemExit(f"FAIL {kind.value} {topo_name}: loss not "
                             f"finite")
        if not out["loss"][-1] < out["loss"][0]:
            raise SystemExit(f"FAIL {kind.value} {topo_name}: loss did not "
                             f"fall ({out['loss'][0]} -> {out['loss'][-1]})")
        state = out["state"]
        if (state.flat_w.shape != (pc.d,) or state.ef.shape != (k, pc.d)
                or not bool(torch.isfinite(state.flat_w).all())):
            raise SystemExit(f"FAIL {kind.value} {topo_name}: bad state")
    expect = cc.cl_sia_bits(k, pc.d, pc.q)
    for topo_name in ("chain", "star"):
        bits = results[(AggKind.CL_SIA, topo_name)]["bits"]
        if any(b != expect for b in bits):
            raise SystemExit(f"FAIL CL-SIA bits on the {topo_name} differ "
                             f"from the closed form {expect}: {bits}")
    if (results[(AggKind.CL_SIA, "chain")]["bits"]
            != results[(AggKind.CL_SIA, "star")]["bits"]):
        raise SystemExit("FAIL CL-SIA bits differ between chain and star")
    log(f"[main] CL-SIA bits = closed form {expect:.0f} in every round on "
        f"chain and star")

    # the same short run on the CPU (plain versions) must agree: losses to
    # rtol 1e-4 (the gradients' products sum in another order on the
    # card), the CL algorithms' bits exactly (constant per hop)
    for kind in (AggKind.SIA, AggKind.CL_SIA, AggKind.TC_SIA,
                 AggKind.CL_TC_SIA):
        sim_cpu = Simulator(pc, AggConfig(kind=kind, **kw), fed,
                            device="cpu")
        a = sims[kind].run(3, seed=SEED)
        b = sim_cpu.run(3, seed=SEED)
        rel = max(abs(u - v) / abs(v) for u, v in zip(a["loss"], b["loss"]))
        same_bits = a["bits"] == b["bits"]
        if rel > 1e-4 or (kind in (AggKind.CL_SIA, AggKind.CL_TC_SIA)
                          and not same_bits):
            raise SystemExit(f"FAIL {kind.value}: card and CPU runs differ "
                             f"(loss rel {rel:.2e}, bits {a['bits']} vs "
                             f"{b['bits']})")
        log(f"[main] {kind.value}: 3 rounds on the card vs the CPU: loss "
            f"max rel diff {rel:.2e}, bits equal: {same_bits}")
    for kind in (AggKind.CL_SIA, AggKind.SIA):
        for topo_name, topo in (("chain", None), ("star", star_tree(k))):
            profile_rounds(sims[kind], f"{kind.value} {topo_name}", topo)
    return launches


def level_device_ops(fn) -> tuple:
    """(device ops, device ms, {op name: calls}) of one call of ``fn``,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    busy = sum(getattr(e, "self_device_time_total", 0) or
               getattr(e, "self_cuda_time_total", 0) for e in events) / 1e3
    return sum(e.count for e in events), busy, {e.key: e.count
                                                for e in events}


# an exact level's one resident launch, by the kernel's name
EXACT_LEVEL_KERNEL = {"cl_sia": "cl_fuse_select", "cl_tc_sia": "cl_fuse_select",
                      "sia": "ia_fuse_select", "re_sia": "ia_fuse_select",
                      "tc_sia": "ia_fuse_select"}


def exact_level_ops(pc, kw):
    """One exact level of each fused kind on the chain (W = 1, d = pc.d)
    on the card: one resident launch (``cl_fuse_select_level`` for the CL
    kinds, ``ia_fuse_select_level`` for SIA, RE-SIA and TC-SIA), and no
    sort, no count kernel and no kernel of the multi-block forms
    (``cl_fuse_level``, ``sparsify_ef_level``, ``chain_accum_level``)
    among its device ops."""
    from repro_torch.core.algorithms import AggConfig, AggKind, level_step

    rng = np.random.default_rng(SEED)
    x = {n: torch.from_numpy(rng.standard_normal((1, pc.d),
                                                 dtype=np.float32)).cuda()
         for n in ("g", "gin", "e")}
    gm = torch.zeros((pc.d,), device="cuda")
    gm[:pc.q_global] = 1.0
    one = torch.ones((1,), device="cuda")
    for kind in (AggKind.CL_SIA, AggKind.CL_TC_SIA, AggKind.SIA,
                 AggKind.RE_SIA, AggKind.TC_SIA):
        step = level_step(AggConfig(kind=kind, **kw))
        ops, busy, calls = level_device_ops(
            lambda: step(x["g"], x["gin"], x["e"], one, one, gm))
        bad = [n for n in calls if "sort" in n.lower() or "count_rank" in n
               or any(k in n for k in ("cl_fuse_level", "sparsify_ef_level",
                                       "chain_accum_level"))]
        name = EXACT_LEVEL_KERNEL[kind.value]
        resident = sum(c for n, c in calls.items() if name in n)
        if bad or resident != 1:
            raise SystemExit(f"FAIL {kind.value} exact level: device ops "
                             f"{calls}")
        log(f"[main] {kind.value} exact level (W = 1, d = {pc.d}): {ops} "
            f"device ops, {busy:.4f} ms busy; no sort, one "
            f"{name}_level")


# ---------------------------------------------------------------------------
# phase 4: the main path under threshold Top-Q
# ---------------------------------------------------------------------------

class TauRecorder:
    """Records (τ, per-round counts) of every fused-operand τ search while
    active, by asking the search for its counts too (τ is unchanged)."""

    def __init__(self, sp):
        self.sp, self.orig, self.log = sp, sp.threshold_for_topq, []

    def __enter__(self):
        self.log = []

        def search(x, q, **kw):
            if kw.get("operand_fn") is None or kw.get("with_counts"):
                return self.orig(x, q, **kw)
            tau, counts = self.orig(x, q, with_counts=True, **kw)
            self.log.append((tau.cpu(), counts.cpu()))
            return tau

        self.sp.threshold_for_topq = search
        return self.log

    def __exit__(self, *exc):
        self.sp.threshold_for_topq = self.orig


def card_matches_cpu(sim_card, sim_cpu, label: str, rounds: int = 3):
    """``rounds`` rounds on the chain, both simulators fed the gradients
    of the CPU run: τ, counts, model, EF rows and bits bit for bit; the
    loss (a reduction on each device) to rtol 1e-4."""
    from repro_torch.agg import compile_plan
    from repro_torch.core import sparsify as sp
    from repro_torch.data.federated import client_minibatch

    plan = compile_plan(sim_cpu.k, num_clients=sim_cpu.k)
    gen = torch.Generator().manual_seed(SEED)
    s_cpu, s_card = sim_cpu.init(), sim_card.init()
    worst = 0.0
    for r in range(rounds):
        bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
        grads = sim_cpu.client_grads(s_cpu.flat_w, bx, by)
        with TauRecorder(sp) as taus_cpu:
            s_cpu, l_cpu = sim_cpu.aggregate_step(s_cpu, plan, grads)
        with TauRecorder(sp) as taus_card:
            s_card, l_card = sim_card.aggregate_step(s_card, plan,
                                                     grads.cuda())
        same = (len(taus_cpu) == len(taus_card) > 0 and all(
            bitwise_equal(a, b) and bitwise_equal(c, e)
            for (a, c), (b, e) in zip(taus_cpu, taus_card)))
        same = same and all(bitwise_equal(u, v) for u, v in (
            (s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef),
            (l_cpu.stats[0].bits, l_card.stats[0].bits),
            (l_cpu.stats[0].nnz_out, l_card.stats[0].nnz_out)))
        rel = abs(float(l_card.loss) - float(l_cpu.loss)) / abs(
            float(l_cpu.loss))
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} round {r}: card and CPU differ "
                             f"(τ/counts/state/bits equal: {same}, loss rel "
                             f"{rel:.2e})")
    log(f"[threshold] {label}: {rounds} rounds on the card vs the CPU with "
        f"the same gradients: τ ({len(taus_card)} searches per round), "
        f"counts, model and bits equal bit for bit; loss max rel diff "
        f"{worst:.2e}")


def threshold_path(level, data) -> dict:
    from repro_torch.core import sparsify as sp
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed import Simulator
    from repro_torch.kernels import ops
    from repro_torch.topo import star_tree

    pc, fed, test = data
    k = pc.num_clients
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local,
              topq_impl="threshold", hist_branch=BRANCH)
    kinds = [AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
             AggKind.CL_TC_SIA]
    topos = [("chain", None, k), ("star", star_tree(k), 1)]
    cfg = lambda kind, impl, **o: AggConfig(kind=kind, **kw,  # noqa: E731
                                            **{**THRESHOLD[impl], **o})
    sims = {(kind, impl): Simulator(pc, cfg(kind, impl), fed, device="cuda")
            for kind in kinds for impl in THRESHOLD}
    t0 = time.perf_counter()
    for sim in sims.values():
        sim.run(1, seed=SEED)
    torch.cuda.synchronize()
    log(f"[threshold] warm-up, one round of each: "
        f"{time.perf_counter() - t0:.1f} s")

    # at d = 7850 the scan is one resident search a level
    names = {"scan": "tau_search_fused_level", "hist": "hist_topq_level"}
    level.reset_launch_counts()
    torch.cuda.synchronize()
    results = {}
    for impl in THRESHOLD:
        for kind in kinds:
            for topo_name, topo, levels in topos:
                before = {f.__name__: f.launches for f in level.KERNELS}
                t0 = time.perf_counter()
                out = sims[(kind, impl)].run(ROUNDS, seed=SEED,
                                             topology=topo, test_x=test.x,
                                             test_y=test.y,
                                             eval_every=ROUNDS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                results[(kind, impl, topo_name)] = out
                grown = {n.replace("_cuda", ""): f.launches - before[n]
                         for n, f in ((f.__name__, f) for f in level.KERNELS)
                         if f.launches - before[n]}
                want = scaled(per_level(pc.d, kind=kind, **kw,
                                        **THRESHOLD[impl]), ROUNDS * levels)
                if grown != want or want.get(names[impl]) != ROUNDS * levels:
                    raise SystemExit(
                        f"FAIL {kind.value} {impl} {topo_name}: launches "
                        f"{grown}, predicted {want}")
                log(f"[threshold] {kind.value:9s} {impl} {topo_name:5s}: "
                    f"loss {out['loss'][0]:.4f} -> {out['loss'][-1]:.4f}, "
                    f"acc {out['accuracy'][-1][1]:.3f}, bits/round "
                    f"{np.mean(out['bits']):.0f}, "
                    f"{1e3 * wall / ROUNDS:.2f} ms/round; "
                    f"launches {grown} (predicted)")
    launches = {name: getattr(level, name + "_cuda").launches
                for name in names.values()}
    log(f"[threshold] τ-search launches over the threshold runs: "
        f"{launches}; node-step kernels: "
        + str({f.__name__.replace("_cuda", ""): f.launches
               for f in level.KERNELS if f.launches
               and f.__name__.replace("_cuda", "") not in names.values()}))
    for name in names.values():
        if launches[name] <= 0:
            raise SystemExit(f"FAIL {name} was never launched on the "
                             f"threshold path")
    for key, out in results.items():
        if not all(math.isfinite(v) for v in out["loss"]):
            raise SystemExit(f"FAIL {key}: loss not finite")
        if not out["loss"][-1] < out["loss"][0]:
            raise SystemExit(f"FAIL {key}: loss did not fall "
                             f"({out['loss'][0]} -> {out['loss'][-1]})")
        if not all(b >= 0 for b in out["bits"]):
            raise SystemExit(f"FAIL {key}: bad bits")

    # hist ≡ scan at the same two rounds, round by round
    n_cmp = 5
    for kind in kinds:
        scan2 = Simulator(pc, cfg(kind, "scan", hist_rounds=2), fed,
                          device="cuda")
        for topo_name, topo, _ in topos:
            a = scan2.run(n_cmp, seed=SEED, topology=topo)
            b = sims[(kind, "hist")].run(n_cmp, seed=SEED, topology=topo)
            if a["bits"] != b["bits"] or a["loss"] != b["loss"]:
                raise SystemExit(
                    f"FAIL {kind.value} {topo_name}: hist differs from the "
                    f"scan at 2 rounds (bits {a['bits']} vs {b['bits']}, "
                    f"loss {a['loss']} vs {b['loss']})")
    log(f"[threshold] hist = scan at hist_rounds=2, bits and loss bit for "
        f"bit over {n_cmp} rounds, every kind on chain and star")

    for kind in kinds:
        for impl in THRESHOLD:
            card_matches_cpu(sims[(kind, impl)],
                             Simulator(pc, cfg(kind, impl), fed,
                                       device="cpu"),
                             f"{kind.value} {impl}")

    # the count_fn path: counts over a materialized [28, 7850] operand
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (k, pc.d)).astype(np.float32))
    want = sp.threshold_for_topq(x, pc.q)
    level.reset_launch_counts()
    torch.cuda.synchronize()
    got = sp.threshold_for_topq(x.cuda(), pc.q, count_fn=ops.count_ge_level)
    torch.cuda.synchronize()
    launches["count_ge_level"] = level.count_ge_level_cuda.launches
    default = sp.threshold_for_topq(x.cuda(), pc.q)
    if not (bitwise_equal(want, got) and bitwise_equal(want, default)):
        raise SystemExit("FAIL threshold_for_topq(count_fn=count_ge_level) "
                         "on the card differs from the default search")
    if launches["count_ge_level"] != 3:
        raise SystemExit(f"FAIL count_ge_level launched "
                         f"{launches['count_ge_level']} times, predicted 3")
    log(f"[threshold] count_fn=count_ge_level on the card: τ equal to the "
        f"default search on the card and the CPU; "
        f"{launches['count_ge_level']} launches (one per round)")

    for impl in THRESHOLD:
        for topo_name, topo, _ in topos:
            profile_rounds(sims[(AggKind.CL_SIA, impl)],
                           f"cl_sia threshold {impl} {topo_name}", topo)
    return launches


# ---------------------------------------------------------------------------
# phase 2 (continued): the cohort-shared [B, d] global mask
# ---------------------------------------------------------------------------

# (W lanes, d, B cohorts): the large shape with 2 and 8 cohorts (B·d % 4 ≠
# 0 for every cohort row b > 0), and the paper's batched round, 8 cohorts
# of 28 lanes
COHORT_SHAPES = [(LARGE[0], LARGE[1], 2), (LARGE[0], LARGE[1], 8),
                 (8 * 28, 7850, 8)]
COHORT_KERNELS = ("cl_fuse_level", "chain_accum_level",
                  "count_ge_fused_level", "hist_topq_level")


def call_cohort(fns, name: str, t: dict, b: int, tables):
    """Kernel ``name`` (CUDA wrapper or plain version) with the cohort
    mask ``t["gmc"]`` of ``b`` cohorts: CL with mask_in, the τ search with
    γ_in (the CL-TC-SIA operand)."""
    if name == "cl_fuse_level":
        return fns[name](t["g"], t["e"], t["gin"], t["weight"], t["tau"],
                         t["part"], t["valid"], t["gmc"], t["mask"],
                         gmask_cohorts=b)
    if name == "chain_accum_level":
        return fns[name](t["gin"], t["g"], t["valid"], t["gmc"],
                         gmask_cohorts=b)
    operand = (t["g"], t["e"], t["gin"], t["weight"], t["part"])
    if name == "count_ge_fused_level":
        return (fns[name](*operand, tables[0], t["gmc"], include_gamma=True,
                          gmask_cohorts=b),)
    return fns[name](*operand, tables, t["gmc"], include_gamma=True,
                     gmask_cohorts=b)


def check_cohort_kernels(level, ref, sp, report: dict):
    """The four kernels that take a global mask, in its cohort-shared
    [B, d] form, at COHORT_SHAPES: bit for bit against their plain
    versions on the CPU (a straggler, a ``valid == 0`` and a τ = +inf lane
    among them), then timed beside their plain versions on the card; the
    bound counts B·d mask bytes."""
    cuda_fns = {n: getattr(level, n + "_cuda") for n in COHORT_KERNELS}
    plain_fns = {n: getattr(ref, "ref_" + n) for n in COHORT_KERNELS}
    dev = torch.device("cuda")
    inputs = {}
    for w, d, b in COHORT_SHAPES:
        t0 = time.perf_counter()
        if (w, d) not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[(w, d)] = {k: torch.from_numpy(v) for k, v in
                              make_inputs(w, d, SEED + 40 + w).items()
                              if k not in ("gm", "gmw")}
        cpu = dict(inputs[(w, d)])
        rng = np.random.default_rng(SEED + 50 + b)
        cpu["gmc"] = torch.from_numpy(
            (rng.random((b, d), dtype=np.float32) < 0.1).astype(np.float32))
        op = ref.fused_operand(cpu["g"], cpu["e"], cpu["gin"], cpu["weight"],
                               cpu["part"], cpu["gmc"], include_gamma=True,
                               gmask_cohorts=b)
        hi = torch.clamp(op.abs().amax(-1), min=1e-30) * sp._HI_SCALE
        tables = sp._hist_tables(torch.zeros_like(hi), hi, BRANCH)
        del op
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        tables_gpu = tuple(u.to(dev) for u in tables)
        for name in COHORT_KERNELS:
            got = call_cohort(cuda_fns, name, gpu, b, tables_gpu)
            torch.cuda.synchronize()
            want = call_cohort(plain_fns, name, cpu, b, tables)
            on_card = call_cohort(plain_fns, name, gpu, b, tables_gpu)
            r = report[name]
            for u, v, c in zip(want, got, on_card):
                r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(u, v))
                r["max_abs_err_plain_on_card"] = max(
                    r["max_abs_err_plain_on_card"], max_abs_diff(c, v))
                if not bitwise_equal(u, v):
                    raise SystemExit(
                        f"FAIL {name} cohort mask B={b} at W={w} d={d}: "
                        f"kernel differs from its plain version on the CPU "
                        f"(max |diff| {max_abs_diff(u, v)})")
            r["checked"] += 1
            r.setdefault("cohort_variants", []).append(
                f"W={w} d={d} B={b}")
            del got, want, on_card
        log(f"[kernels] cohort mask W={w} d={d} B={b}: "
            f"{', '.join(COHORT_KERNELS)} bitwise equal to the plain CPU "
            f"versions ({time.perf_counter() - t0:.1f} s)")
        gpu["valid"].fill_(1.0)
        gpu["part"].fill_(1.0)
        big = w * d > 10 ** 7
        for name in COHORT_KERNELS:
            ms = cuda_time_ms(lambda: call_cohort(cuda_fns, name, gpu, b,
                                                  tables_gpu),
                              20 if big else 200)
            plain_ms = cuda_time_ms(lambda: call_cohort(
                plain_fns, name, gpu, b, tables_gpu), 5 if big else 50)
            if name in ("cl_fuse_level", "chain_accum_level"):
                nbytes, ops_n = kernel_bytes(name, w, d, mask_rows=b), 0
            else:
                nbytes, ops_n = tau_cost(name, w, d, BRANCH, mask_rows=b)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / F32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            report[name]["shapes"].append(dict(
                W=w, d=d, cohorts=b, mask_form="cohort", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms))
            log(f"[time] {name} cohort mask W={w} d={d} B={b}: kernel "
                f"{ms:.4f} ms, plain on card {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of bound)")
        del cpu, gpu, tables_gpu
        torch.cuda.empty_cache()
    inputs.clear()


# ---------------------------------------------------------------------------
# phase 2 (continued): the resident forms (one block per lane)
# ---------------------------------------------------------------------------

RESIDENT_KERNELS = ("cl_fuse_select_level", "tau_search_fused_level",
                    "ia_fuse_select_level")
# the paper's largest resident level last: it is the kernels line's shape
RESIDENT_SHAPES = [(1, 7850), (28, 7850)]
RESIDENT_GM = ((None, 0), ("shared", 0), ("lanes", 0), ("cohort", 4))
# the IA step's TC-SIA also on a mask of values other than 0 and 1
IA_GM = RESIDENT_GM + (("odd", 0),)
# SIA last: the kernels line's kind
IA_KINDS = ("tc_sia", "re_sia", "sia")
RESIDENT_Q, RESIDENT_ROUNDS = 78, THRESHOLD["scan"]["hist_rounds"]


def resident_cases(name: str, d: int, form) -> list:
    """The keyword arguments of each check: q ≤ 0, the paper's q, q = d
    and q > d; the search also at one round; the IA step for each kind
    (TC-SIA alone where a global mask is given) and with a given τ
    (``tau=True``: ``ref.resident_taus`` of the lanes)."""
    if name == "cl_fuse_select_level":
        return [dict(q=q) for q in (0, RESIDENT_Q, d, d + 3)]
    if name == "tau_search_fused_level":
        return [dict(q=q, rounds=r) for q, r in (
            (0, 3), (RESIDENT_Q, 3), (RESIDENT_Q, 1), (d + 3, 3))]
    kinds = IA_KINDS if form is None else ("tc_sia",)
    return [dict(kind=k, q=q) for k in kinds
            for q in (0, RESIDENT_Q, d, d + 3)] + [
        dict(kind=k, tau=True) for k in kinds]


def resident_top_cases(name: str, d: int, form) -> list:
    """The checks at the largest resident d: the paper's q (and for the
    IA step a given τ) alone."""
    return [kw for kw in resident_cases(name, d, form)
            if kw.get("q") == RESIDENT_Q and kw.get("rounds", 3) == 3
            or kw.get("tau")]


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """:func:`bitwise_equal`, a NaN equal to any NaN (the card's
    arithmetic writes its own NaN payloads)."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != torch.float32 or a.shape != b.shape or b.dtype != a.dtype:
        return bitwise_equal(a, b)
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bitwise_equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def call_resident(fns, name: str, t: dict, cohorts: int, q: int = None,
                  rounds: int = RESIDENT_ROUNDS, gamma: bool = True,
                  with_err: bool = False, kind: str = "sia",
                  tau: bool = False):
    """A resident kernel ``name`` (CUDA wrapper or plain version) on the
    lanes ``t`` (``ref.resident_edge_lanes``, ``gm`` and, for a given τ,
    ``tau``)."""
    operand = (t["g"], t["e"], t["gin"], t["w"], t["p"])
    if name == "cl_fuse_select_level":
        return fns[name](*operand, t["valid"], t["gm"], q=q,
                         gmask_cohorts=cohorts, with_err=with_err)
    if name == "ia_fuse_select_level":
        return fns[name](*operand, t["valid"],
                         t["gm"] if kind == "tc_sia" else None, kind=kind,
                         q=None if tau else q, tau=t["tau"] if tau else None,
                         gmask_cohorts=cohorts, with_err=with_err)
    return fns[name](*operand, t["gm"], q=q, branch=BRANCH, rounds=rounds,
                     include_gamma=gamma, gmask_cohorts=cohorts)


def old_chain(level, ref, sp, name: str, t: dict, cohorts: int,
              kind: str = "sia"):
    """What the resident kernel replaces, as a longer lane runs it on the
    card: the exact support by the operand's sort, then ``cl_fuse_level``;
    ``threshold_for_topq`` counting with ``count_ge_fused_level`` a
    round; or the exact SIA-family level as the port ran it before its
    resident form (the Top-Q mask and unions, ``sparsify_ef_level``,
    ``chain_accum_level``: ``algorithms._ia_level`` with the dispatch rule
    saying no)."""
    operand = (t["g"], t["e"], t["gin"], t["w"], t["p"])
    if name == "ia_fuse_select_level":
        from repro_torch.core import algorithms as alg
        from repro_torch.kernels import ops
        cfg = alg.AggConfig(kind=kind, q=RESIDENT_Q, q_global=1,
                            q_local=RESIDENT_Q)
        rule = ops.resident_level
        ops.resident_level = lambda d, branch=1: False
        try:
            return alg._ia_level(
                cfg, t["g"], t["gin"], t["e"], t["w"], t["p"],
                t["gm"] if kind == "tc_sia" else None, None, t["valid"],
                cohorts, RESIDENT_Q)
        finally:
            ops.resident_level = rule

    def x():
        return ref.fused_operand(*operand, t["gm"], include_gamma=True,
                                 gmask_cohorts=cohorts)

    if name == "cl_fuse_select_level":
        inf = torch.full_like(t["w"], math.inf)
        return level.cl_fuse_level_cuda(
            t["g"], t["e"], t["gin"], t["w"], inf, t["p"], t["valid"],
            t["gm"], sp.topq_mask(x(), RESIDENT_Q), gmask_cohorts=cohorts)
    op = sp.TauOperand(
        count=lambda taus: level.count_ge_fused_level_cuda(
            *operand, taus, t["gm"], include_gamma=True,
            gmask_cohorts=cohorts),
        max_abs=lambda: sp._max_abs(x().abs()), batched=True)
    return sp.threshold_for_topq(None, RESIDENT_Q, branch=BRANCH,
                                 rounds=RESIDENT_ROUNDS, operand_fn=op)


def resident_cost(name: str, w: int, d: int, mask_rows: int) -> tuple:
    """(bytes, f32 operations) a resident kernel must spend: each input
    read once, each output written once; per element the operand (2 fma,
    1 − m, ·, |·|), then for the select its key, 4 radix digits (mask,
    compare, shift, add), the tie test and the fuse (the keep test, a
    select, a subtraction, an fma, 2 counts), for the search per round the
    binary search over the candidates and the rank's add."""
    m = mask_rows * d
    # the select reads g, e, γ_in, gm, w, p, valid and writes γ, e′
    if name == "cl_fuse_select_level":
        nbytes = (5 * w * d + m) * 4 + 3 * w * 4 + 2 * w * 4
        return nbytes, w * d * (6 + 1 + 4 * 4 + 1 + 6)
    # the IA step (exact) the same bytes; per element g~ (1 fma; with a
    # mask 1 − m and ·), the key, 4 radix digits, the tie test, the mask
    # (TC-SIA: support, −, clamp, 2 adds, > 0), the keep test, a select,
    # e′, γ_out and 2 counts
    if name == "ia_fuse_select_level":
        nbytes = (5 * w * d + m) * 4 + 3 * w * 4 + 2 * w * 4
        return nbytes, w * d * (1 + 1 + 4 * 4 + 1 + (6 if m else 1) + 7)
    search = math.ceil(math.log2(BRANCH + 1))
    nbytes = ((3 * w * d + m + 2 * w) * 4
              + (w + RESIDENT_ROUNDS * w * BRANCH) * 4)
    return nbytes, w * d * (6 + RESIDENT_ROUNDS * (search + 1))


def check_resident_kernels(level, ref, sp) -> dict:
    """The resident kernels against their plain versions on the CPU, bit
    for bit (a NaN = any NaN): every operand form (γ_in on and off for the
    search, the pinned ‖e′‖² on and off for the select, the four global
    mask forms), the edge lanes of ``ref.resident_edge_lanes`` (ties
    straddling the q-th value, NaN and ±inf, zeros, p = 0, valid = 0),
    q ≤ 0 … q > d, at the paper's shapes and the largest resident d; a
    level of d + 1 takes the multi-block kernels. Then each timed beside
    its plain version, the chain it replaces on the same inputs and its
    bound."""
    from _torch_launches import RESIDENT_D, level_launches
    from repro_torch.core.algorithms import AggConfig, level_step

    cuda_fns = {n: getattr(level, n + "_cuda") for n in RESIDENT_KERNELS}
    plain_fns = {n: getattr(ref, "ref_" + n) for n in RESIDENT_KERNELS}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in RESIDENT_KERNELS}
    limits = level.resident_limits()
    if limits != (level.RESIDENT_MAX_D, level.RESIDENT_MAX_BRANCH) or \
            level.RESIDENT_MAX_D != RESIDENT_D:
        raise SystemExit(f"FAIL the resident kernels were built for "
                         f"{limits}, the dispatch rule says d <= "
                         f"{level.RESIDENT_MAX_D}, branch <= "
                         f"{level.RESIDENT_MAX_BRANCH}, the launch gates "
                         f"d <= {RESIDENT_D}")
    dev = torch.device("cuda")
    top = level.RESIDENT_MAX_D
    # (W, d, mask form, cohorts, kernel, with_err or γ_in)
    checks = [(w, d, form, b, name, flag)
              for w, d in RESIDENT_SHAPES
              for name in RESIDENT_KERNELS
              for form, b in (IA_GM if name == "ia_fuse_select_level"
                              else RESIDENT_GM)
              if not b or w % b == 0 for flag in (False, True)]
    checks += [(28, top, form, b, name, True) for name in RESIDENT_KERNELS
               for form, b in (IA_GM if name == "ia_fuse_select_level"
                               else ((None, 0), ("lanes", 0)))]
    t0 = time.perf_counter()
    inputs = {}
    for w, d, form, b, name, flag in checks:
        key = (w, d, form)
        if key not in inputs:
            inputs.clear()
            cpu = ref.resident_edge_lanes(w, d, SEED + w + d)
            cpu["gm"] = ref.resident_gmask(form, w, d, SEED + d, b)
            cpu["tau"] = ref.resident_taus(cpu, cpu["gm"], b, RESIDENT_Q)
            inputs[key] = (cpu, {k: None if v is None else v.to(dev)
                                 for k, v in cpu.items()})
        cpu, gpu = inputs[key]
        for case in (resident_top_cases if d == top else resident_cases)(
                name, d, form):
            kw = dict(case, **({"gamma": flag}
                               if name == "tau_search_fused_level"
                               else {"with_err": flag}))
            got = call_resident(cuda_fns, name, gpu, b, **kw)
            torch.cuda.synchronize()
            want = call_resident(plain_fns, name, cpu, b, **kw)
            on_card = call_resident(plain_fns, name, gpu, b, **kw)
            r = report[name]
            for u, v, c in zip(want, got, on_card):
                finite = torch.isfinite(u) if u.is_floating_point() else None
                diff = (max_abs_diff(u[finite], v.cpu()[finite])
                        if finite is not None else max_abs_diff(u, v))
                r["max_abs_err"] = max(r["max_abs_err"], diff)
                if not same_nan(u, v):
                    raise SystemExit(
                        f"FAIL {name} {kw} gmask {form} at W={w} d={d}: "
                        f"kernel differs from its plain version on the CPU")
                if same_nan(c, v):
                    continue
                r["max_abs_err_plain_on_card"] = max(
                    r["max_abs_err_plain_on_card"],
                    max_abs_diff(c[torch.isfinite(c)],
                                 v[torch.isfinite(c)])
                    if c.is_floating_point() else max_abs_diff(c, v))
            r["checked"] += 1
    inputs.clear()
    torch.cuda.empty_cache()
    log(f"[kernels] resident kernels at {RESIDENT_SHAPES} and W=28 d={top}: "
        f"every operand form and edge lane equal to the plain CPU versions "
        f"({time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{n} {r['checked']} variants"
                    for n, r in report.items()) + ")")

    # the dispatch rule's boundary: d + 1 takes the multi-block chain
    for d in (top, top + 1):
        cpu = ref.resident_edge_lanes(3, d, SEED)
        cpu["gm"] = ref.resident_gmask("shared", 3, d, SEED)
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        for kind, impl in [(k, i) for k in ("cl_sia",) + IA_KINDS
                           for i in ("exact", "threshold")]:
            cfg = AggConfig(kind=kind, q=RESIDENT_Q, topq_impl=impl,
                            hist_branch=BRANCH, err_sq_mode="kernel")
            args = lambda t: (t["g"], t["gin"], t["e"], t["w"], t["p"],  # noqa
                              t["gm"], None, t["valid"])
            before = {f.__name__: f.launches for f in level.KERNELS}
            got = level_step(cfg)(*args(gpu))
            torch.cuda.synchronize()
            grown = {n.replace("_cuda", ""): f.launches - before[n]
                     for n, f in ((f.__name__, f) for f in level.KERNELS)
                     if f.launches - before[n]}
            resident = bool(set(grown) & set(RESIDENT_KERNELS))
            if grown != level_launches(cfg, d) or resident != (d <= top):
                raise SystemExit(f"FAIL the dispatch at d={d} ({kind} "
                                 f"{impl}): launches {grown}")
            want = level_step(cfg)(*args(cpu))
            if not all(same_nan(u, v) for u, v in zip(
                    want[:2] + tuple(want[2]), got[:2] + tuple(got[2]))):
                raise SystemExit(f"FAIL the {kind} level at d={d} ({impl}) "
                                 f"differs from the CPU")
            log(f"[kernels] dispatch at d={d}: {sorted(grown)} ({kind} "
                f"{impl}); the level equals the CPU's")
        del cpu, gpu

    # timing: the paper's level (edge lanes live), the old chain beside it
    for w, d in RESIDENT_SHAPES:
        cpu = ref.resident_edge_lanes(w, d, SEED + 7)
        cpu["gm"] = None
        gpu = {k: None if v is None else v.to(dev) for k, v in cpu.items()}
        # the IA step of TC-SIA reads a lane-shared mask (its main path's)
        gpu["gm"] = ref.resident_gmask("shared", w, d, SEED).to(dev)
        for name, kind in [(n, k) for n in RESIDENT_KERNELS for k in (
                IA_KINDS if n == "ia_fuse_select_level" else (None,))]:
            kw = dict(q=RESIDENT_Q, **({"kind": kind} if kind else {}))
            gm = gpu["gm"] if kind == "tc_sia" else None
            t = dict(gpu, gm=gm)
            ms = cuda_time_ms(lambda: call_resident(cuda_fns, name, t, 0,
                                                    **kw), 200)
            plain_ms = cuda_time_ms(lambda: call_resident(
                plain_fns, name, t, 0, **kw), 50)
            chain_ms = cuda_time_ms(lambda: old_chain(
                level, ref, sp, name, t, 0, kind), 50)
            nbytes, ops_n = resident_cost(name, w, d, int(gm is not None))
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / F32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            report[name]["shapes"].append(dict(
                W=w, d=d, **({"kind": kind} if kind else {}), ms=ms,
                plain_ms=plain_ms, chain_ms=chain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms))
            log(f"[time] {name}{' ' + kind if kind else ''} W={w} d={d}: "
                f"kernel {ms:.4f} ms, the chain it replaces {chain_ms:.4f} "
                f"ms, plain on card {plain_ms:.4f} ms, bound "
                f"{bound_ms:.6f} ms ({100 * bound_ms / ms:.2f}% of bound)")
        del cpu, gpu
    return report


# ---------------------------------------------------------------------------
# phase 2 (continued): the scalar [d] kernels
# ---------------------------------------------------------------------------

def scalar_variants():
    """(kernel, options) for every variant: both dtypes, mask_in on/off,
    include_gamma on/off, the scalars as numbers and as tensors on the card
    (a CPU-side plain result serves both scalar forms)."""
    for dt in SCALAR_DTYPES:
        yield "count_ge", dict(dtype=dt)
        for gamma in (False, True):
            yield "count_ge_fused", dict(dtype=dt, gamma=gamma)
        for mask in (False, True):
            yield "sparsify_ef", dict(dtype=dt, mask=mask)
        yield "cl_fuse", dict(dtype=dt)
        yield "chain_accum", dict(dtype=dt)


SCALAR_TIMED = {"count_ge": dict(gamma=False, mask=False),
                "count_ge_fused": dict(gamma=True, mask=False),
                "sparsify_ef": dict(gamma=False, mask=True),
                "cl_fuse": dict(gamma=False, mask=False),
                "chain_accum": dict(gamma=False, mask=False)}


def scalar_inputs(d: int, seed: int) -> dict:
    """float32 numpy rows and 64 shuffled taus with τ = −1, 0, +inf and a
    tie; the scalars w = 1.3, τ = 1.1, p = 0.6."""
    rng = np.random.default_rng(seed)
    f = lambda s: (rng.standard_normal(d, dtype=np.float32)  # noqa: E731
                   * np.float32(s))
    x = dict(g=f(1.0), e=f(0.3), gin=f(1.0),
             mask=(rng.random(d, dtype=np.float32) < 0.01).astype(
                 np.float32))
    x["gin"] *= rng.random(d, dtype=np.float32) < 0.3
    taus = np.abs(rng.standard_normal(BRANCH)).astype(np.float32) * 1.5
    taus[:4] = [-1.0, 0.0, np.inf, taus[9]]
    x["taus"] = rng.permutation(taus)
    return x


def call_scalar(fns, name: str, t: dict, opt: dict, sc: dict):
    """Call scalar kernel ``name`` (from ``fns``: the CUDA wrappers or the
    plain versions) on rows ``t`` with scalars ``sc`` (w, tau, p)."""
    if name == "count_ge":
        return (fns[name](t["g"], t["taus"]),)
    if name == "count_ge_fused":
        return (fns[name](t["g"], t["e"], t["gin"], sc["w"], sc["p"],
                          t["taus"], include_gamma=opt["gamma"]),)
    if name == "sparsify_ef":
        return fns[name](t["g"], t["e"], t["mask"] if opt["mask"] else None,
                         sc["w"], sc["tau"])
    if name == "cl_fuse":
        return fns[name](t["g"], t["e"], t["gin"], sc["w"], sc["tau"])
    return fns[name](t["gin"], t["g"])


def scalar_cost(name: str, d: int, es: int, opt: dict) -> tuple:
    """(bytes, f32 operations) a call must spend: each input read once and
    each output written once (es bytes per row element, the float32 mask,
    taus, counts and scalars included); per element the operand's flops and
    the rank search's compares."""
    search = math.ceil(math.log2(BRANCH + 1))
    taus = 2 * BRANCH * 4                          # taus in, counts out
    if name == "count_ge":
        return d * es + taus, d * (1 + search)
    if name == "count_ge_fused":
        rows = 3 if opt["gamma"] else 2
        return rows * d * es + 8 + taus, d * (2 * (rows - 1) + 1 + search)
    if name == "sparsify_ef":                      # g, e (mask) → ḡ, e′
        return 4 * d * es + opt["mask"] * d * 4 + 12, d * 5
    if name == "cl_fuse":                          # g, e, γ_in → γ, e′
        return 5 * d * es + 12, d * 6
    return 3 * d * es + 4, d * 2                   # γ_in, ḡ → γ


def check_scalar_kernels(scalar, ref) -> dict:
    """Every scalar kernel over its variants at SCALAR_SHAPES, bit for bit
    against its plain version on the CPU and on the card; then timed."""
    cuda_fns, plain_fns = scalar, {n: getattr(ref, "ref_" + n)
                                   for n in scalar}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in cuda_fns}
    dev = torch.device("cuda")
    sc_cpu = dict(w=1.3, tau=1.1, p=0.6)
    sc_card = {k: torch.tensor([v], dtype=torch.float32, device=dev)
               for k, v in sc_cpu.items()}
    for si, d in enumerate(SCALAR_SHAPES):
        t0 = time.perf_counter()
        x = scalar_inputs(d, SEED + 20 + si)
        for dt in SCALAR_DTYPES:
            cpu = {k: torch.from_numpy(v).to(dt if k in ("g", "e", "gin")
                                             else torch.float32)
                   for k, v in x.items()}
            gpu = {k: v.to(dev) for k, v in cpu.items()}
            for name, opt in scalar_variants():
                if opt["dtype"] != dt:
                    continue
                want = call_scalar(plain_fns, name, cpu, opt, sc_cpu)
                on_card = call_scalar(plain_fns, name, gpu, opt, sc_card)
                r = report[name]
                takes_scalars = name not in ("count_ge", "chain_accum")
                for sc in (sc_cpu, sc_card)[:1 + takes_scalars]:
                    got = call_scalar(cuda_fns, name, gpu, opt, sc)
                    torch.cuda.synchronize()
                    for a, b, c in zip(want, got, on_card):
                        r["max_abs_err"] = max(r["max_abs_err"],
                                               max_abs_diff(a, b))
                        r["max_abs_err_plain_on_card"] = max(
                            r["max_abs_err_plain_on_card"],
                            max_abs_diff(c, b))
                        if not (bitwise_equal(a, b) and bitwise_equal(c, b)):
                            raise SystemExit(
                                f"FAIL {name} {opt} scalars "
                                f"{'on the card' if sc is sc_card else 'as numbers'}"
                                f" at d={d}: kernel differs from its plain "
                                f"version (CPU max |diff| "
                                f"{max_abs_diff(a, b)}, card "
                                f"{max_abs_diff(c, b)})")
                    r["checked"] += 1
                del want, on_card
            big = d > 10 ** 7
            for name, opt in SCALAR_TIMED.items():
                opt = dict(opt, dtype=dt)
                ms = cuda_time_ms(lambda: call_scalar(
                    cuda_fns, name, gpu, opt, sc_card), 20 if big else 200)
                plain_ms = cuda_time_ms(lambda: call_scalar(
                    plain_fns, name, gpu, opt, sc_card), 5 if big else 50)
                nbytes, ops_n = scalar_cost(name, d, dt.itemsize, opt)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops_n / F32_OPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                report[name]["shapes"].append(dict(
                    d=d, dtype=str(dt).replace("torch.", ""), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    bound_share=bound_ms / ms))
                log(f"[time] {name} d={d} {dt}: kernel {ms:.4f} ms, plain "
                    f"on card {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({100 * bound_ms / ms:.1f}% of bound)")
            del cpu, gpu
            torch.cuda.empty_cache()
        log(f"[kernels] d={d}: every scalar kernel variant bitwise equal to "
            f"its plain version on the CPU and on the card "
            f"({time.perf_counter() - t0:.1f} s)")
    check_count_ge_edges(cuda_fns["count_ge"], ref, report["count_ge"])
    return report


def check_count_ge_edges(count_ge, ref, r: dict):
    """count_ge at d = SEARCH_D on the bucket edges of its rank table and
    on the taus (one ulp either side), with NaN, ±inf, ±0 and subnormal
    elements; taus in any order with −1, 0, +inf, NaN, ties and taus on
    bucket boundaries, B = 1, 64 and 4095 (MAX_TAUS); float32 and
    bfloat16; bit for bit against the plain version on the CPU. 4096 taus
    must be refused."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for n in EDGE_TAUS:
        taus = ref.count_edge_taus(n, seed=SEED + n)
        x = ref.count_edge_magnitudes(taus, SEARCH_D, seed=SEED + n)
        x[:1000] = ref.special_magnitudes(1000, seed=SEED + n)
        for dt in SCALAR_DTYPES:
            row = x.to(dt)
            want = ref.ref_count_ge(row, taus)
            got = count_ge(row.to(dev), taus.to(dev))
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(want, got))
            if not bitwise_equal(want, got):
                raise SystemExit(f"FAIL count_ge on its rank table's edges, "
                                 f"B={n} {dt}: kernel differs from its plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(want, got)})")
            r["checked"] += 1
    try:
        count_ge(x.to(dev), torch.ones(EDGE_TAUS[-1] + 1, device=dev))
    except ValueError:
        pass
    else:
        raise SystemExit(f"FAIL count_ge took {EDGE_TAUS[-1] + 1} taus")
    log(f"[kernels] count_ge on its rank table's edges at d={SEARCH_D}, "
        f"B in {EDGE_TAUS}, float32 and bfloat16: equal to the plain version "
        f"bit for bit; {EDGE_TAUS[-1] + 1} taus refused "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 5: the scalar kernel API and the 1-D τ search
# ---------------------------------------------------------------------------

def scalar_chain(sp, ops, ref, grads, ef, weights, q: int, kind: str):
    """One chain pass of K scalar node steps through the ``ops`` entries:
    each node's τ from ``threshold_for_topq`` over the fused operand counted
    by ``count_ge_fused``, then ``sparsify_ef`` + ``chain_accum`` (SIA) or
    ``cl_fuse`` (CL-SIA). τ and the weights stay on the rows' device.
    → (γ at the PS, new EF rows, [τ], [nnz])."""
    gamma_in = torch.zeros_like(grads[0])
    one = torch.ones((1,), dtype=torch.float32, device=grads.device)
    gamma_on = kind == "cl_sia"
    e_new, taus, nnzs = [], [], []
    for k in range(grads.shape[0]):
        g, e, w = grads[k], ef[k], weights[k:k + 1]
        gin = gamma_in

        def count(t, g=g, e=e, w=w, gin=gin):
            return ops.count_ge_fused(g, e, gin, w, one, t,
                                      include_gamma=gamma_on)

        def max_abs(g=g, e=e, w=w, gin=gin):
            return ref.fused_operand(g[None], e[None], gin[None], w, one,
                                     include_gamma=gamma_on).abs().amax()

        tau = sp.threshold_for_topq(None, q, operand_fn=sp.TauOperand(
            count=count, max_abs=max_abs, batched=False), branch=BRANCH)
        if gamma_on:
            gamma_in, e_k, nnz = ops.cl_fuse(g, e, gin, w, tau)
        else:
            gbar, e_k, _ = ops.sparsify_ef(g, e, None, w, tau)
            gamma_in, nnz = ops.chain_accum(gin, gbar)
        e_new.append(e_k)
        taus.append(tau)
        nnzs.append(nnz)
    return gamma_in, torch.stack(e_new), torch.stack(taus), torch.stack(nnzs)


def scalar_path(level, scalar) -> dict:
    from repro_torch.configs import PAPER
    from repro_torch.core import sparsify as sp
    from repro_torch.kernels import ops, ref

    k, d, q = PAPER.num_clients, PAPER.d, PAPER.q
    rng = np.random.default_rng(SEED + 30)
    grads = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32))
    ef = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)
                          * np.float32(0.1))
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(
        np.float32) / np.float32(k))
    xs = torch.from_numpy(rng.standard_normal(SEARCH_D, dtype=np.float32))
    card = [t.cuda() for t in (grads, ef, weights, xs)]
    kinds = ("sia", "cl_sia")
    for kind in kinds:                     # warm-up: first use of each op
        scalar_chain(sp, ops, ref, *card[:3], q, kind)
    sp.threshold_for_topq(card[3], q, count_fn=ops.count_ge)
    torch.cuda.synchronize()

    level.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    taus_card = [sp.threshold_for_topq(card[3], qq, count_fn=ops.count_ge)
                 for qq in SEARCH_QS]
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3 / len(SEARCH_QS)
    chains, chain_ms = {}, {}
    for kind in kinds:
        t0 = time.perf_counter()
        chains[kind] = scalar_chain(sp, ops, ref, *card[:3], q, kind)
        torch.cuda.synchronize()
        chain_ms[kind] = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__.replace("_cuda", ""): fn.launches
                for fn in scalar.values()}
    rounds = 3                                     # scan rounds per search
    want = dict(count_ge=rounds * len(SEARCH_QS),
                count_ge_fused=rounds * k * len(kinds), sparsify_ef=k,
                chain_accum=k, cl_fuse=k)
    log(f"[scalar] launches over the scalar path: {launches} (predicted "
        f"{want}); 1-D search at d={SEARCH_D}: {search_ms:.2f} ms per "
        f"search; chain of {k} scalar node steps at d={d}: "
        + ", ".join(f"{kk} {v:.2f} ms" for kk, v in chain_ms.items())
        + " (host clock, synchronized)")
    if launches != want:
        raise SystemExit(f"FAIL scalar path launches {launches}, predicted "
                         f"{want}")

    for qq, got in zip(SEARCH_QS, taus_card):
        cpu = sp.threshold_for_topq(xs, qq, count_fn=ops.count_ge)
        default = sp.threshold_for_topq(xs, qq)
        kept = int((card[3].abs() >= got).sum())
        if not (bitwise_equal(cpu, got) and bitwise_equal(default, got)
                and qq <= kept):
            raise SystemExit(f"FAIL 1-D search q={qq}: card τ {float(got)!r}"
                             f", CPU {float(cpu)!r}, default "
                             f"{float(default)!r}, {kept} kept")
    log(f"[scalar] 1-D search, count_fn=ops.count_ge on the card: τ equal "
        f"to the CPU's bit for bit for q in {SEARCH_QS}")
    for kind in kinds:
        cpu = scalar_chain(sp, ops, ref, grads, ef, weights, q, kind)
        got = chains[kind]
        if not all(bitwise_equal(a, b) for a, b in zip(cpu, got)):
            raise SystemExit(f"FAIL scalar {kind} chain: card and CPU differ "
                             f"(γ, EF, τ, nnz equal: "
                             f"{[bitwise_equal(a, b) for a, b in zip(cpu, got)]})")
        gamma, _, _, nnz = got
        if not (bool(torch.isfinite(gamma).all()) and int(nnz[-1]) >= q):
            raise SystemExit(f"FAIL scalar {kind} chain: bad result")
        log(f"[scalar] {kind} chain: γ, EF rows, τ and nnz on the card equal "
            f"the CPU's bit for bit; nnz at the PS {int(nnz[-1])}")
    for kind in kinds:
        profile_calls(f"scalar {kind} chain", lambda: scalar_chain(
            sp, ops, ref, *card[:3], q, kind), 1)
    profile_calls("1-D search", lambda: sp.threshold_for_topq(
        card[3], SEARCH_QS[0], count_fn=ops.count_ge), 1)
    return launches


# ---------------------------------------------------------------------------
# phase 6: routed constellation trees, relay failures, topology schedules
# ---------------------------------------------------------------------------

# walker_delta(4, 7, gateways=(1, 15)): 28 satellites, the paper's K; its
# widest-path tree is (L, W) = (8, 5), (10, 4) with client 0 dead
WALKER = dict(num_planes=4, sats_per_plane=7, gateways=(1, 15))
FAILURES = {2: ([0], []), 8: ([], [0])}          # client 0 dead rounds 2-7
LINK_EVENTS = {3: ([(1, 2), (1, 8)], []), 9: ([], [(1, 2), (1, 8)])}
# the rounds compared card against CPU: each crosses a re-route
TREE_CMP_ROUNDS = {"failure": (1, 2, 3), "links": (2, 3, 4),
                   "budgets": (0, 1, 2)}


def tree_card_matches_cpu(sim_card, sim_cpu, plans, label: str,
                          tag: str = "tree"):
    """Rounds over ``plans`` (a re-route among them), both simulators fed
    the CPU run's gradients: model, EF rows (and stage EF tiers), every
    stage's bits and nnz bit for bit, the loss to rtol 1e-4."""
    from repro_torch.data.federated import client_minibatch

    gen = torch.Generator().manual_seed(SEED)
    s_cpu, s_card = sim_cpu.init(), sim_card.init()
    worst = 0.0
    for r, plan in enumerate(plans):
        bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
        grads = sim_cpu.client_grads(s_cpu.flat_w, bx, by)
        s_cpu, l_cpu = sim_cpu.aggregate_step(s_cpu, plan, grads)
        s_card, l_card = sim_card.aggregate_step(s_card, plan, grads.cuda())
        same = states_equal(s_cpu, s_card) and all(
            bitwise_equal(u.bits, v.bits)
            and bitwise_equal(u.nnz_out, v.nnz_out)
            for u, v in zip(l_cpu.stats, l_card.stats))
        rel = abs(float(l_card.loss) - float(l_cpu.loss)) / abs(
            float(l_cpu.loss))
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} round {r} (plan {plan.shape}): "
                             f"card and CPU differ (state/bits equal: "
                             f"{same}, loss rel {rel:.2e})")
    log(f"[{tag}] {label}: {len(plans)} rounds over plans "
        f"{[p.shape for p in plans]} on the card vs the CPU with the same "
        f"gradients: model, EF rows, stage EF tiers, bits and nnz bit for "
        f"bit; loss max rel diff {worst:.2e}")


def states_equal(a, b) -> bool:
    """Model, EF rows and stage EF tiers bit for bit."""
    return (bitwise_equal(a.flat_w, b.flat_w) and bitwise_equal(a.ef, b.ef)
            and len(a.stage_ef) == len(b.stage_ef)
            and all(bitwise_equal(u, v)
                    for u, v in zip(a.stage_ef, b.stage_ef)))


def padded_equals_unpadded(sim, pairs, label: str):
    """Each (unpadded, padded) plan pair on the card, same state and
    gradients: bits, nnz, EF rows and model bit for bit."""
    rng = np.random.default_rng(SEED + 60)
    k, d = sim.k, sim.d
    grads = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)
                             * np.float32(0.01)).cuda()
    state = sim.init()._replace(ef=torch.from_numpy(
        rng.standard_normal((k, d), dtype=np.float32)
        * np.float32(1e-3)).cuda())
    for plain, padded in pairs:
        (s1, l1), (s2, l2) = (sim.aggregate_step(state, p, grads)
                              for p in (plain, padded))
        if not all(bitwise_equal(u, v) for u, v in (
                (s1.flat_w, s2.flat_w), (s1.ef, s2.ef),
                (l1.stats[0].bits, l2.stats[0].bits),
                (l1.stats[0].nnz_out, l2.stats[0].nnz_out))):
            raise SystemExit(f"FAIL {label}: plan {plain.shape} and the same "
                             f"plan padded to {padded.shape} differ")
    log(f"[tree] {label}: padded = unpadded on the card, bit for bit, for "
        + ", ".join(f"{a.shape} -> {b.shape}" for a, b in pairs))


def tree_path(level, data) -> dict:
    from repro_torch.agg import TopologySchedule, compile_plan
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed import Simulator
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import walker_delta

    pc, fed, test = data
    k = pc.num_clients
    g = walker_delta(**WALKER)
    if g.num_clients != k:
        raise SystemExit(f"FAIL the Walker shell has {g.num_clients} "
                         f"clients, the paper {k}")
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    topo = TreeTopology(g, "widest")
    fails = FailureSchedule(k, FAILURES)
    sched = TopologySchedule.from_link_events(g, LINK_EVENTS, rounds=ROUNDS,
                                              routing="widest")
    sia = AggConfig(kind=AggKind.SIA, **kw)
    budget_plan = topo.plan(bandwidth_aware=True, cfg=sia)
    budgets = TopologySchedule(plans=(budget_plan,), round_index=(0,))
    # (label, kind, tree_topology, run() keywords, the plan of round r)
    runs = [
        ("cl_sia failure", AggKind.CL_SIA, topo,
         dict(failure_schedule=fails),
         lambda r: topo.plan(dead=tuple(fails.dead_at(r)))),
        ("sia failure", AggKind.SIA, topo, dict(failure_schedule=fails),
         lambda r: topo.plan(dead=tuple(fails.dead_at(r)))),
        ("cl_sia links", AggKind.CL_SIA, None,
         dict(topology_schedule=sched), sched.plan_at),
        ("sia budgets", AggKind.SIA, None, dict(topology_schedule=budgets),
         budgets.plan_at),
    ]
    shapes = {label: sorted({plan_of(r).shape for r in range(ROUNDS)})
              for label, _, _, _, plan_of in runs}
    log(f"[tree] walker_delta(4, 7, gateways=(1, 15)), widest-path: plans "
        f"{shapes}; q_budget {budget_plan.q_budget.tolist()}")
    sims = {label: Simulator(pc, AggConfig(kind=kind, **kw), fed,
                             tree_topology=tt, device="cuda")
            for label, kind, tt, _, _ in runs}
    chain = Simulator(pc, AggConfig(kind=AggKind.CL_SIA, **kw), fed,
                      device="cuda")
    t0 = time.perf_counter()
    for label, _, _, rkw, _ in runs:
        sims[label].run(2, seed=SEED, **rkw)
    chain.run(1, seed=SEED)
    torch.cuda.synchronize()
    log(f"[tree] warm-up: {time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    results, per_round = {}, {}
    for label, kind, _, rkw, plan_of in runs:
        before = [fn.launches for fn in level.KERNELS]
        t0 = time.perf_counter()
        out = sims[label].run(ROUNDS, seed=SEED, test_x=test.x,
                              test_y=test.y, eval_every=ROUNDS, **rkw)
        torch.cuda.synchronize()
        per_round[label] = 1e3 * (time.perf_counter() - t0) / ROUNDS
        grown = {n: fn.launches - b for n, fn, b in
                 zip(names, level.KERNELS, before) if fn.launches - b}
        levels = sum(plan_of(r).shape[0] for r in range(ROUNDS))
        want = scaled(per_level(pc.d, "budgets" in label, kind=kind, **kw),
                      levels)
        if grown != want:
            raise SystemExit(f"FAIL {label}: level-kernel launches {grown}, "
                             f"predicted {want} (one per level)")
        results[label] = out
        log(f"[tree] {label:15s}: loss {out['loss'][0]:.4f} -> "
            f"{out['loss'][-1]:.4f}, acc {out['accuracy'][-1][1]:.3f}, "
            f"bits/round {np.mean(out['bits']):.0f}, "
            f"{per_round[label]:.2f} ms/round (host clock, synchronized); "
            f"level-kernel launches {grown} = "
            f"{levels / ROUNDS:.1f} per round (predicted)")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}
    t0 = time.perf_counter()
    chain_out = chain.run(ROUNDS, seed=SEED)
    torch.cuda.synchronize()
    chain_ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
    log(f"[tree] ms per round, same process: chain cl_sia {chain_ms:.2f}; "
        + ", ".join(f"{lb} {ms:.2f}" for lb, ms in per_round.items())
        + f"; launches over the tree runs {launches}")

    for label, out in results.items():
        if not all(math.isfinite(v) for v in out["loss"]):
            raise SystemExit(f"FAIL {label}: loss not finite")
        if not out["loss"][-1] < out["loss"][0]:
            raise SystemExit(f"FAIL {label}: loss did not fall "
                             f"({out['loss'][0]} -> {out['loss'][-1]})")
    expect = cc.cl_sia_bits(k, pc.d, pc.q)
    dead_rounds = [r for r in range(ROUNDS) if fails.dead_at(r)]
    want = [cc.cl_sia_bits_tree(k - len(fails.dead_at(r)), pc.d, pc.q)
            for r in range(ROUNDS)]
    if results["cl_sia failure"]["bits"] != want:
        raise SystemExit(f"FAIL cl_sia failure bits "
                         f"{results['cl_sia failure']['bits']}, closed form "
                         f"over the live uplinks {want}")
    if any(b != expect for b in results["cl_sia links"]["bits"]):
        raise SystemExit(f"FAIL cl_sia links bits differ from the closed "
                         f"form {expect}")
    if chain_out["bits"] != results["cl_sia links"]["bits"]:
        raise SystemExit("FAIL CL-SIA bits differ between chain and tree")
    uniform = results["sia failure"]["bits"]
    log(f"[tree] CL-SIA bits = closed form {expect:.0f} in every round with "
        f"all clients alive (failure run outside rounds {dead_rounds[0]}-"
        f"{dead_rounds[-1]}, every round of the link schedule), and "
        f"{want[dead_rounds[0]]:.0f} (K - 1 uplinks) while client 0 is "
        f"dead; SIA budgets {np.mean(results['sia budgets']['bits']):.0f} "
        f"bits/round vs uniform on the same tree "
        f"{np.mean(uniform[:dead_rounds[0]] + uniform[dead_rounds[-1] + 1:]):.0f}")

    for label, kind, _, _, plan_of in runs:
        tree_card_matches_cpu(
            sims[label], Simulator(pc, AggConfig(kind=kind, **kw), fed,
                                   device="cpu"),
            [plan_of(r) for r in TREE_CMP_ROUNDS[label.split()[1]]], label)

    # the schedule's padded plans beside their routed trees compiled alone,
    # and the dead-relay plan padded to the largest shape of the run
    pairs = [(compile_plan(sched.raw_at(r)), sched.plan_at(r))
             for r in (0, min(LINK_EVENTS))]
    dead = topo.plan(dead=(0,))
    pairs.append((dead, dead.pad((max(dead.shape[0], sched.shape[0]),
                                  max(dead.shape[1], sched.shape[1])))))
    for label in ("cl_sia failure", "sia failure"):
        padded_equals_unpadded(sims[label], pairs, label.split()[0])
    if not any(float(b.slot_mask.min()) == 0.0 for _, b in pairs):
        raise SystemExit("FAIL no padded lane reached the kernels")

    profile_rounds(sims["cl_sia failure"], "cl_sia walker tree", None)
    profile_rounds(chain, "cl_sia chain (phase 6)", None)
    return launches


# ---------------------------------------------------------------------------
# phase 7: multi-tenant cohort rounds
# ---------------------------------------------------------------------------

COHORT_SEEDS = tuple(SEED + i for i in range(8))   # B = 8 cohorts
BATCHED_ROUNDS = 10           # the walker run re-routes at 2 and back at 8
SCALING_COHORTS = (1, 2, 4, 8)
SCALING_ROUNDS = 5
# the runs compared card against CPU, and their rounds
BATCHED_CMP = {"tc_sia star": (0, 1, 2), "cl_tc_sia walker": (1, 2, 3),
               "tc_sia scan": (0, 1, 2), "tc_sia hist": (0, 1, 2)}


def batched_runs(pc, k):
    """(label, AggConfig keywords, Simulator keywords, run keywords, the
    plan of round r, level-kernel launches per level) of phase 7."""
    from repro_torch.agg import compile_plan
    from repro_torch.core.algorithms import AggKind
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import star_tree, walker_delta

    exact = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    thr = dict(exact, topq_impl="threshold", hist_branch=BRANCH)
    chain, star = compile_plan(k), compile_plan(star_tree(k))
    topo = TreeTopology(walker_delta(**WALKER), "widest")
    fails = FailureSchedule(k, FAILURES)
    tc_exact = dict(kind=AggKind.TC_SIA, **exact)
    cl_tc = dict(kind=AggKind.CL_TC_SIA, **exact)
    scan = dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["scan"])
    hist = dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["hist"])
    rule = lambda kw: per_level(pc.d, **kw)  # noqa: E731
    return [
        ("tc_sia chain", tc_exact, {}, {}, lambda r: chain, rule(tc_exact)),
        ("tc_sia star", tc_exact, {}, dict(topology=star_tree(k)),
         lambda r: star, rule(tc_exact)),
        ("cl_tc_sia chain", cl_tc, {}, {}, lambda r: chain, rule(cl_tc)),
        ("cl_tc_sia star", cl_tc, {}, dict(topology=star_tree(k)),
         lambda r: star, rule(cl_tc)),
        ("cl_tc_sia walker", cl_tc, dict(tree_topology=topo),
         dict(failure_schedule=fails),
         lambda r: topo.plan(dead=tuple(fails.dead_at(r))), rule(cl_tc)),
        ("tc_sia scan", scan, {}, {}, lambda r: chain, rule(scan)),
        ("tc_sia hist", hist, {}, {}, lambda r: chain, rule(hist)),
    ]


def batched_card_matches_cpu(sim_card, sim_cpu, plans, label: str):
    """Batched rounds over ``plans``, both simulators fed the CPU's
    gradients of every cohort: model, EF rows, bits and nnz bit for bit,
    the loss to rtol 1e-4."""
    from repro_torch.data.federated import client_minibatch

    gens = [torch.Generator().manual_seed(s) for s in COHORT_SEEDS]
    s_cpu = sim_cpu.init_batched(COHORT_SEEDS)
    s_card = sim_card.init_batched(COHORT_SEEDS)
    worst = 0.0
    for r, plan in enumerate(plans):
        grads = []
        for i, gen in enumerate(gens):
            bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
            grads.append(sim_cpu.client_grads(s_cpu.flat_w[i], bx, by))
        grads = torch.stack(grads)
        s_cpu, l_cpu = sim_cpu.aggregate_step_batched(s_cpu, plan, grads)
        s_card, l_card = sim_card.aggregate_step_batched(s_card, plan,
                                                         grads.cuda())
        same = all(bitwise_equal(u, v) for u, v in (
            (s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef),
            (l_cpu.stats[0].bits, l_card.stats[0].bits),
            (l_cpu.stats[0].nnz_out, l_card.stats[0].nnz_out)))
        rel = float(((l_card.loss.cpu() - l_cpu.loss).abs()
                     / l_cpu.loss.abs()).max())
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} batched round {r} (plan "
                             f"{plan.shape}): card and CPU differ "
                             f"(state/bits equal: {same}, loss rel "
                             f"{rel:.2e})")
    log(f"[batched] {label}: {len(plans)} rounds of {len(COHORT_SEEDS)} "
        f"cohorts over plans {[p.shape for p in plans]} on the card vs the "
        f"CPU with the same gradients: model, EF rows, bits and nnz bit for "
        f"bit; loss max rel diff {worst:.2e}")


def scheduler_buckets(cfg, k: int, d: int):
    """A RoundScheduler on the card fed three submits of a chain, a star
    and a routed Walker tree (one K = 28 bucket, padded to its running
    maximum) and a K = 4 chain (a second bucket): each cohort's result
    equals a sequential ``execute`` on its own plan, and the scheduler
    meets no more input signatures than it launched buckets."""
    from repro_torch.agg import (CohortRound, RoundScheduler, compile_plan,
                                 execute)
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.topo import star_tree, walker_delta

    walker = TreeTopology(walker_delta(**WALKER), "widest").plan()
    plans = [compile_plan(k), compile_plan(star_tree(k)), walker,
             compile_plan(4)]
    sched = RoundScheduler(cfg)
    rng = np.random.default_rng(SEED + 70)
    for sub in range(3):
        rounds = []
        for i, plan in enumerate(plans):
            kk = plan.num_clients
            t = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a, np.float32)).cuda()
            rounds.append(CohortRound(
                (sub, i), plan, t(rng.standard_normal((kk, d)) * 0.01),
                t(rng.standard_normal((kk, d)) * 1e-3),
                t(rng.uniform(0.5, 1.5, kk)),
                t(rng.random(d) < 0.01), t(rng.random(kk) < 0.9)))
        got = sched.submit(rounds)
        for r in rounds:
            want = execute(cfg, r.plan, r.grads, r.e, r.weights,
                           global_mask=r.global_mask,
                           participate=r.participate)
            res = got[r.cohort_id]
            if not all(bitwise_equal(u, v) for u, v in (
                    (want.aggregate, res.aggregate),
                    (want.e_new, res.e_new),
                    (want.stats.nnz_out, res.stats.nnz_out),
                    (want.stats.bits, res.stats.bits))):
                raise SystemExit(f"FAIL scheduler cohort {r.cohort_id} "
                                 f"(plan {r.plan.shape}) differs from "
                                 f"sequential execute")
    sched.assert_bucket_specializations()
    if sched.trace_counter.count != 2:
        raise SystemExit(f"FAIL the scheduler met "
                         f"{sched.trace_counter.count} input signatures "
                         f"for 2 buckets")
    log(f"[batched] RoundScheduler on the card: 3 submits of chain, star, "
        f"Walker tree (K = {k}) and a K = 4 chain; buckets "
        f"{[(e['key'][0], e['shape'], e['padded_cohorts']) for e in sched.bucket_log[:2]]}"
        f"; {sched.trace_counter.count} specializations for "
        f"{sched.expected_specializations} buckets; every cohort equal to "
        f"sequential execute bit for bit")


def batched_path(level, data) -> dict:
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.fed import Simulator

    pc, fed, test = data
    k = pc.num_clients
    runs = batched_runs(pc, k)
    sims = {label: Simulator(pc, AggConfig(**cfg), fed, device="cuda", **skw)
            for label, cfg, skw, _, _, _ in runs}
    b = len(COHORT_SEEDS)
    t0 = time.perf_counter()
    for label, _, _, rkw, _, _ in runs:
        sims[label].run_batched(2, seeds=COHORT_SEEDS, **rkw)
        sims[label].run(1, seed=SEED, **rkw)
    torch.cuda.synchronize()
    log(f"[batched] warm-up: {time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    results, per_round = {}, {}
    for label, _, _, rkw, plan_of, per_level in runs:
        before = [fn.launches for fn in level.KERNELS]
        t0 = time.perf_counter()
        out = sims[label].run_batched(BATCHED_ROUNDS, seeds=COHORT_SEEDS,
                                      test_x=test.x, test_y=test.y,
                                      eval_every=BATCHED_ROUNDS, **rkw)
        torch.cuda.synchronize()
        per_round[label] = 1e3 * (time.perf_counter() - t0) / BATCHED_ROUNDS
        grown = {n: fn.launches - c for n, fn, c in
                 zip(names, level.KERNELS, before)}
        levels = sum(plan_of(r).shape[0] for r in range(BATCHED_ROUNDS))
        want = {n: levels * per_level.get(n, 0) for n in names}
        if grown != want:
            raise SystemExit(f"FAIL batched {label}: level-kernel launches "
                             f"{grown}, predicted {want} (one per level for "
                             f"all {b} cohorts)")
        results[label] = out
        loss = np.asarray(out["loss"])
        log(f"[batched] {label:16s} B={b}: loss {loss[0].mean():.4f} -> "
            f"{loss[-1].mean():.4f} (cohort mean), acc "
            f"{np.mean(out['accuracy'][-1][1]):.3f}, bits/round/cohort "
            f"{np.mean(out['bits']):.0f}, {per_round[label]:.2f} ms per "
            f"batched round (host clock, synchronized); launches "
            f"{ {n: v for n, v in grown.items() if v} } = "
            f"{levels / BATCHED_ROUNDS:.1f} levels per round")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}
    log(f"[batched] launches over the batched runs: {launches}")
    for name in {n for r in runs for n in r[5]}:
        if launches[name] <= 0:
            raise SystemExit(f"FAIL {name} was never launched on the "
                             f"batched path")

    for label, _, _, rkw, _, _ in runs:
        out = results[label]
        loss = np.asarray(out["loss"])
        if not (np.isfinite(loss).all() and (loss[-1] < loss[0]).all()):
            raise SystemExit(f"FAIL batched {label}: loss did not fall in "
                             f"every cohort ({loss[0]} -> {loss[-1]})")
        st = out["state"]
        for i, seed in enumerate(COHORT_SEEDS):
            ref = sims[label].run(BATCHED_ROUNDS, seed=seed, **rkw)
            same = (bitwise_equal(st.flat_w[i], ref["state"].flat_w)
                    and bitwise_equal(st.ef[i], ref["state"].ef)
                    and [row[i] for row in out["bits"]] == ref["bits"]
                    and [row[i] for row in out["nnz"]] == ref["nnz"])
            if not same:
                raise SystemExit(f"FAIL batched {label}: cohort {i} differs "
                                 f"from run(seed={seed}) on the card")
    log(f"[batched] every cohort of every batched run equals the sequential "
        f"run(seed) on the card bit for bit: model, EF rows, bits and nnz "
        f"over {BATCHED_ROUNDS} rounds")

    for label, cfg, skw, _, plan_of, _ in runs:
        if label in BATCHED_CMP:
            batched_card_matches_cpu(
                sims[label], Simulator(pc, AggConfig(**cfg), fed,
                                       device="cpu", **skw),
                [plan_of(r) for r in BATCHED_CMP[label]], label)

    scheduler_buckets(AggConfig(**runs[0][1]), k, pc.d)

    # one batched round against B sequential rounds, B = 1, 2, 4, 8
    for label in ("tc_sia chain", "cl_tc_sia walker"):
        rkw = next(r[3] for r in runs if r[0] == label)
        sim = sims[label]
        cells = []
        for nb in SCALING_COHORTS:
            seeds = COHORT_SEEDS[:nb]
            t0 = time.perf_counter()
            sim.run_batched(SCALING_ROUNDS, seeds=seeds, **rkw)
            torch.cuda.synchronize()
            batched = 1e3 * (time.perf_counter() - t0) / SCALING_ROUNDS
            t0 = time.perf_counter()
            for seed in seeds:
                sim.run(SCALING_ROUNDS, seed=seed, **rkw)
            torch.cuda.synchronize()
            seq = 1e3 * (time.perf_counter() - t0) / SCALING_ROUNDS
            cells.append(f"B={nb}: batched {batched:.2f} ms, {nb} sequential "
                         f"{seq:.2f} ms ({seq / batched:.2f}x)")
        log(f"[batched] {label}, one batched round vs B sequential rounds "
            f"(host clock, synchronized, {SCALING_ROUNDS} rounds each): "
            + "; ".join(cells))
    for label in ("tc_sia chain", "cl_tc_sia walker", "tc_sia scan"):
        rkw = next(r[3] for r in runs if r[0] == label)
        sim = sims[label]
        profile_calls(f"batched {label} B={b}", lambda: sim.run_batched(
            3, seeds=COHORT_SEEDS, **rkw), 3)
    return launches


# ---------------------------------------------------------------------------
# phase 8: nested (staged) plans, the trace collector and scenarios
# ---------------------------------------------------------------------------

NESTED_ROUNDS = 20
NESTED_SHORT = 3                  # the threshold runs
STAGE_WS = (1, 2, 4)              # an upper stage's lanes: the pod heads
NESTED_CMP_ROUNDS = 3
TIMING_TURNS = 5                  # turns of the collector/flat timing
PHASE8_DIR = Path(__file__).resolve().parent / "build" / "phase8"


def check_stage_kernels(level, ref, sp, d: int = 7850):
    """Rows 1–5 at an upper stage's shapes (W = 1, 2, 4 lanes), ``g`` the
    sink rows k..k+W−1 of a larger inbox, every variant bit for bit
    against the plain version on the CPU."""
    cuda_fns = {"cl_fuse_level": level.cl_fuse_level_cuda,
                "sparsify_ef_level": level.sparsify_ef_level_cuda,
                "chain_accum_level": level.chain_accum_level_cuda,
                "count_ge_fused_level": level.count_ge_fused_level_cuda,
                "hist_topq_level": level.hist_topq_level_cuda}
    plain_fns = {"cl_fuse_level": ref.ref_cl_fuse_level,
                 "sparsify_ef_level": ref.ref_sparsify_ef_level,
                 "chain_accum_level": ref.ref_chain_accum_level,
                 "count_ge_fused_level": ref.ref_count_ge_fused_level,
                 "hist_topq_level": ref.ref_hist_topq_level}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n = 0
    for w in STAGE_WS:
        x = make_inputs(w, d, SEED + 80 + w)
        k = 28 + w                     # the sink rows of a stage's inbox
        inbox = np.zeros((k + w + 1, d), np.float32)
        inbox[k:k + w] = x["g"]
        cpu = {key: torch.from_numpy(v) for key, v in x.items()}
        cpu["g"] = torch.from_numpy(inbox)[k:k + w]
        gpu = {key: v.to(dev) for key, v in cpu.items()}
        gpu["g"] = torch.from_numpy(inbox).to(dev)[k:k + w]
        for name, opt in variants():
            got = call(cuda_fns, name, gpu, opt)
            torch.cuda.synchronize()
            want = call(plain_fns, name, cpu, opt)
            if not all(bitwise_equal(a, b) for a, b in zip(want, got)):
                raise SystemExit(f"FAIL {name} {opt} at the stage shape "
                                 f"W={w} d={d}: kernel differs from its "
                                 f"plain version")
            n += 1
        for name, opt in tau_variants(False):
            if name == "count_ge_level" or opt.get("edges") \
                    or opt.get("specials"):
                continue
            tables = tau_tables(sp, ref, cpu, opt, opt.get("branch", BRANCH))
            aux = {"tables": tables}
            aux_gpu = {"tables": tuple(u.to(dev) for u in tables)}
            got = call_tau(cuda_fns, name, gpu, opt, aux_gpu)
            torch.cuda.synchronize()
            want = call_tau(plain_fns, name, cpu, opt, aux)
            if not all(bitwise_equal(a, b) for a, b in zip(want, got)):
                raise SystemExit(f"FAIL {name} {opt} at the stage shape "
                                 f"W={w} d={d}: kernel differs from its "
                                 f"plain version")
            n += 1
    log(f"[nested] rows 1-5 at the upper stages' shapes W = {STAGE_WS}, "
        f"d = {d}, g a view of sink rows inside the inbox: {n} variants "
        f"bit for bit equal to the plain CPU versions "
        f"({time.perf_counter() - t0:.1f} s)")


def nested_runs(pc, k):
    """(label, AggConfig keywords, Simulator keywords, rounds, the nested
    plan, level-kernel launches per level) of phase 8."""
    from repro_torch.agg import compile_nested, pod_ring_nested
    from repro_torch.core.algorithms import AggKind
    from repro_torch.topo import cluster_routed, walker_delta

    exact = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    thr = dict(exact, topq_impl="threshold", hist_branch=BRANCH)
    pods = pod_ring_nested(4, 7)
    walker = compile_nested(cluster_routed(walker_delta(**WALKER), 4),
                            num_clients=k)
    runs = [
        ("cl_sia pods", dict(kind=AggKind.CL_SIA, **exact), pods,
         NESTED_ROUNDS),
        ("cl_tc_sia walker", dict(kind=AggKind.CL_TC_SIA, **exact), walker,
         NESTED_ROUNDS),
        ("sia walker", dict(kind=AggKind.SIA, **exact), walker,
         NESTED_ROUNDS),
        ("tc_sia scan walker",
         dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["scan"]), walker,
         NESTED_SHORT),
        ("tc_sia hist walker",
         dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["hist"]), walker,
         NESTED_SHORT),
    ]
    # every stage of the host nested executor runs lanes of the whole d
    return [r + (per_level(pc.d, **r[1]),) for r in runs]


def stage_bits_ok(kind, plan_meta, stage_bits, pc) -> tuple:
    """(within?, closed form or bound per stage) for one round's per-stage
    bits: CL-SIA equals its staged closed form over each stage's live
    units; CL-TC-SIA stays within its closed form (the TCS mask holds
    fewer than Q_G nonzeros while the model barely moves, as in round 0);
    SIA and TC-SIA stay under the staged Prop-2 bound of each stage's
    recorded subtree sizes (2 % slack: it bounds the expected count, as the
    report's check reads it)."""
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggKind
    from repro_torch.obs.record import subtree_sizes_from_parent

    alive = [int(round(sum(st["alive"]))) for st in plan_meta["stages"]]
    if kind == AggKind.CL_SIA:
        want = cc.nested_cl_sia_bits(alive, pc.d, pc.q)
        return list(stage_bits) == list(want), want
    if kind == AggKind.CL_TC_SIA:
        want = cc.nested_cl_tc_sia_bits(alive, pc.d, pc.q_global, pc.q_local)
        return all(b <= w for b, w in zip(stage_bits, want)), want
    sizes = [subtree_sizes_from_parent(st["parent"])
             for st in plan_meta["stages"]]
    qg, ql = ((pc.q_global, pc.q_local) if kind == AggKind.TC_SIA
              else (0, pc.q))
    want = cc.nested_tc_sia_bits_bound(sizes, pc.d, qg, ql)
    return all(b <= 1.02 * w for b, w in zip(stage_bits, want)), want


def nested_card_matches_cpu(sim_card, sim_cpu, plan, label: str):
    """Nested rounds, both simulators fed the CPU's gradients: model, EF
    rows, every stage EF tier and every stage's bits and counts bit for
    bit, the loss to rtol 1e-4."""
    from repro_torch.data.federated import client_minibatch

    gen = torch.Generator().manual_seed(SEED)
    s_cpu, s_card = sim_cpu.init(), sim_card.init()
    worst = 0.0
    for r in range(NESTED_CMP_ROUNDS):
        bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
        grads = sim_cpu.client_grads(s_cpu.flat_w, bx, by)
        s_cpu, l_cpu = sim_cpu.aggregate_step(s_cpu, plan, grads)
        s_card, l_card = sim_card.aggregate_step(s_card, plan, grads.cuda())
        pairs = [(s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef)]
        pairs += list(zip(s_cpu.stage_ef, s_card.stage_ef))
        pairs += [(getattr(a, f), getattr(b, f))
                  for a, b in zip(l_cpu.stats, l_card.stats)
                  for f in ("bits", "nnz_out", "nnz_global", "nnz_local")]
        same = (len(s_cpu.stage_ef) == len(s_card.stage_ef) > 0
                and all(bitwise_equal(u, v) for u, v in pairs))
        rel = abs(float(l_card.loss) - float(l_cpu.loss)) / abs(
            float(l_cpu.loss))
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} nested round {r}: card and CPU "
                             f"differ (state/tiers/bits equal: {same}, loss "
                             f"rel {rel:.2e})")
    log(f"[nested] {label}: {NESTED_CMP_ROUNDS} rounds over "
        f"{plan.shape} on the card vs the CPU with the same gradients: "
        f"model, EF rows, {len(s_card.stage_ef)} stage EF tier(s), every "
        f"stage's bits and counts bit for bit; loss max rel diff "
        f"{worst:.2e}")


def walker_scenario(pc):
    """The clustered Walker shell under a relay crash and a link flap:
    the relay is a client with children in its cluster's routed tree, the
    flap the PS's ground link to gateway 1."""
    from repro_torch.scenario import Crash, LinkFlap, Scenario, TopologySpec
    from repro_torch.topo import cluster_routed, walker_delta
    from repro_torch.topo.tree import PS

    nt = cluster_routed(walker_delta(**WALKER), 4)
    relay = next(members[p] for members, tree in zip(nt.clusters, nt.intra)
                 for p in tree.parent if p != PS)
    return Scenario(
        name="walker-clusters-crash-flap", rounds=NESTED_ROUNDS, seed=SEED,
        topology=TopologySpec(
            kind="walker_delta", clients=pc.num_clients, clusters=4,
            params={"num_planes": WALKER["num_planes"],
                    "sats_per_plane": WALKER["sats_per_plane"],
                    "gateways": list(WALKER["gateways"])}),
        agg={"kind": "cl_sia", "q": pc.q},
        crashes=(Crash(node=int(relay), round=6, recover=12),),
        link_flaps=(LinkFlap(link=(0, WALKER["gateways"][0]), start=9,
                             down=5),))


def scenario_run(pc, fed, spec, path: Path, **sim_kw):
    """One run of ``spec`` on the card under a TraceCollector → (curves,
    round records, simulator); ``sim_kw`` go to the Simulator (the device
    backend's ``backend``, ``mesh``)."""
    from repro_torch.fed import Simulator
    from repro_torch.obs import TraceCollector, iter_trace

    sim = Simulator(pc, spec.agg_config(), fed, device="cuda", **sim_kw)
    with TraceCollector(str(path)) as col:
        out = sim.run(spec.rounds, scenario=spec, collector=col,
                      flush_every=8)
    recs = [r for r in iter_trace(str(path)) if r["kind"] == "round"]
    return out, recs, sim


def nested_path(level, ref, sp, data) -> dict:
    from _torch_launches import level_launches
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.fed import Simulator
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.obs import TraceCollector, iter_trace, validate_trace
    from repro_torch.obs.report import closed_form_check, load_trace
    from repro_torch.scenario import compile_scenario, scenario_from_trace
    from repro_torch.topo import walker_delta

    pc, fed, test = data
    k = pc.num_clients
    t_phase = time.perf_counter()
    check_stage_kernels(level, ref, sp)
    PHASE8_DIR.mkdir(parents=True, exist_ok=True)
    runs = nested_runs(pc, k)
    sims = {label: Simulator(pc, AggConfig(**cfg), fed, device="cuda",
                             nested_topology=plan)
            for label, cfg, plan, _, _ in runs}
    spec = walker_scenario(pc)
    compiled = compile_scenario(spec)
    t0 = time.perf_counter()
    for label, _, _, _, _ in runs:
        sims[label].run(2, seed=SEED)
    torch.cuda.synchronize()
    log(f"[nested] plans: "
        + ", ".join(f"{label} {plan.shape}" for label, _, plan, _, _ in runs)
        + f"; warm-up {time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    stage_logs = {}
    for label, cfg, plan, rounds, per_level in runs:
        before = [fn.launches for fn in level.KERNELS]
        path = PHASE8_DIR / f"{label.replace(' ', '_')}.jsonl"
        t0 = time.perf_counter()
        with TraceCollector(str(path)) as col:
            out = sims[label].run(rounds, seed=SEED, test_x=test.x,
                                  test_y=test.y, eval_every=rounds,
                                  collector=col)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / rounds
        grown = {n: fn.launches - b for n, fn, b in
                 zip(names, level.KERNELS, before)}
        levels = rounds * sum(st.shape[0] for st in plan.stages)
        want = {n: levels * per_level.get(n, 0) for n in names}
        if grown != want:
            raise SystemExit(f"FAIL nested {label}: level-kernel launches "
                             f"{grown}, predicted {want} (Σ over rounds of "
                             f"Σ_s L_s)")
        recs = [r for r in iter_trace(str(path)) if r["kind"] == "round"]
        worst = []
        for rec in recs:
            bits = [sum(st["bits"]) for st in rec["stages"]]
            ok, bound = stage_bits_ok(cfg["kind"], rec["plan"], bits, pc)
            if not ok:
                raise SystemExit(f"FAIL nested {label} round "
                                 f"{rec['round']}: per-stage bits {bits}, "
                                 f"closed form / bound {bound}")
            worst.append([b / w for b, w in zip(bits, bound)])
        loss = out["loss"]
        if not (all(math.isfinite(v) for v in loss)
                and loss[-1] < loss[0]):
            raise SystemExit(f"FAIL nested {label}: loss did not fall "
                             f"({loss[0]} -> {loss[-1]})")
        stage_logs[label] = recs
        log(f"[nested] {label:18s}: loss {loss[0]:.4f} -> {loss[-1]:.4f}, "
            f"acc {out['accuracy'][-1][1]:.3f}, bits per stage "
            f"{[sum(st['bits']) for st in recs[-1]['stages']]} (closed form "
            f"/ bound share max {np.max(worst, axis=0).round(4).tolist()}), "
            f"{ms:.2f} ms/round with the collector (flush every 32); "
            f"launches { {n: v for n, v in grown.items() if v} } = "
            f"{levels // rounds} levels per round")

    # the scenario: a relay crash and a ground-link flap on the clustered
    # Walker shell, recorded, checked and replayed from its own trace
    before = [fn.launches for fn in level.KERNELS]
    trace = PHASE8_DIR / "scenario.jsonl"
    out, recs, sim = scenario_run(pc, fed, spec, trace)
    torch.cuda.synchronize()
    grown = {n: fn.launches - b for n, fn, b in
             zip(names, level.KERNELS, before)}
    levels = sum(st.shape[0] for r in range(spec.rounds)
                 for st in compiled.schedule.plan_at(r).stages)
    want = level_launches(sim.agg, pc.d, levels)
    if {n: c for n, c in grown.items() if c} != want:
        raise SystemExit(f"FAIL nested scenario: launches {grown}, "
                         f"predicted {want}")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}
    res = validate_trace(str(trace))
    meta, rounds, _ = load_trace(str(trace))
    check = closed_form_check(meta, rounds)
    full = sum(1 for r in rounds if all(p > 0 for p in r["participation"]))
    if (res["errors"] or check is None or check["rounds_checked"]
            != spec.rounds or check["matches"] != full
            or check["worst_abs_gap_bits"] != 0.0):
        raise SystemExit(f"FAIL nested scenario trace: validation "
                         f"{res['errors'][:3]}, closed-form check {check} "
                         f"({full} full-participation rounds)")
    if sim.trace_counter.count != 1:
        raise SystemExit(f"FAIL nested scenario: "
                         f"{sim.trace_counter.count} input signatures")
    replay_spec, _ = scenario_from_trace(str(trace))
    _, replay, _ = scenario_run(pc, fed, replay_spec,
                                PHASE8_DIR / "replay.jsonl")
    fields = lambda r: ([st["bits"] for st in r["stages"]],  # noqa: E731
                        [st["nnz"] for st in r["stages"]], r["loss"],
                        r["participation"])
    if [fields(r) for r in recs] != [fields(r) for r in replay]:
        raise SystemExit("FAIL nested scenario: the replay from the trace "
                         "gave other round records")
    stubs = sorted({r["round"] for r in recs
                    if min(r["plan"]["stages"][1]["alive"]) == 0})
    log(f"[nested] scenario {spec.name}: {len(compiled.events)} events "
        f"({', '.join(e['name'] for e in compiled.events)}), "
        f"{len(compiled.schedule.plans)} plans of shape "
        f"{compiled.schedule.shape}, stub-cluster rounds {stubs}; trace "
        f"valid ({ {k_: v for k_, v in res.items() if k_ != 'errors'} }), "
        f"closed form exact in {check['rounds_checked']} rounds (worst gap "
        f"{check['worst_abs_gap_bits']}), {check['matches']} with full "
        f"participation; 1 input signature; the replay from the trace "
        f"gives the same bits, nnz, loss and participation in every round; "
        f"launches {want} (Σ_r Σ_s L_s levels)")

    for label in ("cl_sia pods", "sia walker", "tc_sia scan walker"):
        cfg, plan = next((c, p) for lb, c, p, _, _ in runs if lb == label)
        nested_card_matches_cpu(
            sims[label], Simulator(pc, AggConfig(**cfg), fed, device="cpu",
                                   nested_topology=plan), plan, label)

    # ms per round: the collector off, flushing every round and every 32
    # rounds, and the flat Walker tree round, in turns (host speed drifts
    # within a run), each order reversed on the next turn; medians
    sim = sims["cl_sia pods"]
    flat = Simulator(pc, AggConfig(**runs[0][1]), fed, device="cuda",
                     tree_topology=TreeTopology(walker_delta(**WALKER),
                                                "widest"))
    flat.run(1, seed=SEED)

    def with_collector(cadence):
        path = PHASE8_DIR / f"flush_{cadence}.jsonl"
        with TraceCollector(str(path)) as col:
            sim.run(NESTED_ROUNDS, seed=SEED, collector=col,
                    flush_every=cadence)

    cases = {"collector off": lambda: sim.run(NESTED_ROUNDS, seed=SEED),
             "flush every round": lambda: with_collector(1),
             "flush every 32": lambda: with_collector(32),
             "flat Walker tree": lambda: flat.run(NESTED_ROUNDS, seed=SEED)}
    times = {name: [] for name in cases}
    for turn in range(TIMING_TURNS):
        order = list(cases) if turn % 2 == 0 else list(cases)[::-1]
        for name in order:
            t0 = time.perf_counter()
            cases[name]()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0)
                               / NESTED_ROUNDS)
    med = {name: float(np.median(v)) for name, v in times.items()}
    log(f"[nested] cl_sia pods ms per round (host clock, synchronized, "
        f"{NESTED_ROUNDS} rounds, median of {TIMING_TURNS} turns [min, "
        f"max]): " + "; ".join(
            f"{name} {med[name]:.2f} [{min(v):.2f}, {max(v):.2f}]"
            for name, v in times.items())
        + f"; flush 32 / off {med['flush every 32'] / med['collector off']:.3f}"
        f", flush 1 / off {med['flush every round'] / med['collector off']:.3f}"
        f", nested / flat tree "
        f"{med['collector off'] / med['flat Walker tree']:.3f}")
    profile_calls("nested cl_sia pods", lambda: sim.run(3, seed=SEED), 3)
    profile_calls("nested cl_tc_sia walker",
                  lambda: sims["cl_tc_sia walker"].run(3, seed=SEED), 3)
    profile_calls("flat cl_sia walker tree", lambda: flat.run(3, seed=SEED),
                  3)
    log(f"[nested] phase 8: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the client-per-rank device backend
# ---------------------------------------------------------------------------

DEVICE_ROUNDS = 5                 # the exact runs, device vs host backend
DEVICE_SHORT = 3                  # threshold runs and card-vs-CPU rounds
DEVICE_SEEDS = tuple(SEED + i for i in range(4))   # run_batched, B = 4
DEVICE_TURNS = 5                  # alternating turns of the timing
DEVICE_TIMED_ROUNDS = 5
PHASE9_DIR = Path(__file__).resolve().parent / "build" / "phase9"


def sharded_cases(pc, k):
    """(label, AggConfig keywords, port topology, participate or None,
    wire, gradient dtype) of the ``execute_sharded`` checks."""
    from repro_torch.core.algorithms import AggKind
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.topo import star_tree, walker_delta

    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    rng = np.random.default_rng(SEED + 90)
    perm = rng.permutation(k)
    part = (rng.random(k) < 0.8).astype(np.float32)
    topos = {"chain": k, "permuted chain": perm, "star": star_tree(k),
             "walker": TreeTopology(walker_delta(**WALKER), "widest").tree()}
    cases = []
    for kind in (AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA,
                 AggKind.TC_SIA, AggKind.CL_TC_SIA, AggKind.DENSE_IA):
        # the fused kinds with the pinned in-kernel ‖e′‖² (lane-layout
        # invariant: every HopStats field bit for bit on any plan)
        err = ({} if kind == AggKind.DENSE_IA
               else dict(err_sq_mode="kernel"))
        for name, topo in topos.items():
            cases.append((f"{kind.value} {name}", dict(kind=kind, **kw,
                                                       **err),
                          topo, part, "auto", torch.float32))
        if kind in (AggKind.CL_SIA, AggKind.CL_TC_SIA):
            for name in ("chain", "walker"):
                for wire in ("compact", "dense"):
                    cases.append((f"{kind.value} {name} {wire} wire",
                                  dict(kind=kind, **kw, **err), topos[name],
                                  None, wire, torch.float32))
    for kind in (AggKind.SIA, AggKind.CL_SIA, AggKind.DENSE_IA):
        cases.append((f"{kind.value} walker bf16", dict(kind=kind, **kw),
                      topos["walker"], part, "auto", torch.bfloat16))
    cases.append(("cl_sia star jnp err_sq", dict(kind=AggKind.CL_SIA, **kw),
                  topos["star"], part, "auto", torch.float32))
    return cases


def err_sq_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu().double(), b.cpu().double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def round_results_equal(want, got, exact_err: bool) -> tuple:
    """(equal, err_sq max rel diff): aggregate, EF rows, nnz_* and bits
    bit for bit; ``err_sq`` too when ``exact_err``, else to rtol 1e-6 (a
    torch row sum, whose order on the card depends on the row count)."""
    same = all(bitwise_equal(u, v) for u, v in (
        (want.aggregate, got.aggregate), (want.e_new, got.e_new),
        (want.stats.nnz_out, got.stats.nnz_out),
        (want.stats.nnz_global, got.stats.nnz_global),
        (want.stats.nnz_local, got.stats.nnz_local),
        (want.stats.bits, got.stats.bits)))
    rel = err_sq_rel(got.stats.err_sq, want.stats.err_sq)
    ok = (bitwise_equal(want.stats.err_sq, got.stats.err_sq) if exact_err
          else rel <= 1e-6)
    return same and ok, rel


def check_sharded(mesh, cpu_mesh, pc) -> None:
    """``execute_sharded`` on the card against host ``execute`` on the card
    and against ``execute_sharded`` on the CPU mesh (plain versions), on
    the same numpy inputs."""
    from repro_torch.agg import compile_plan, execute
    from repro_torch.agg.device import _wire_format, execute_sharded
    from repro_torch.core.algorithms import AggConfig

    k, d = pc.num_clients, pc.d
    rng = np.random.default_rng(SEED + 91)
    g = rng.standard_normal((k, d), dtype=np.float32) * np.float32(0.01)
    e = rng.standard_normal((k, d), dtype=np.float32) * np.float32(1e-3)
    w = rng.uniform(0.5, 2.0, k).astype(np.float32)
    gm = np.zeros((d,), np.float32)
    gm[rng.choice(d, pc.q_global, replace=False)] = 1.0
    t0 = time.perf_counter()
    worst = {"host": 0.0, "cpu": 0.0}
    wires = {}
    crossed = 0
    for label, kw, topo, part, wire, dtype in sharded_cases(pc, k):
        cfg = AggConfig(**kw)
        plan = compile_plan(topo, num_clients=k)
        cpu = dict(grads=torch.from_numpy(g).to(dtype),
                   e=torch.from_numpy(e).to(dtype),
                   weights=torch.from_numpy(w),
                   global_mask=torch.from_numpy(gm).to(dtype),
                   participate=(None if part is None
                                else torch.from_numpy(part)))
        card = {n: None if v is None else v.cuda() for n, v in cpu.items()}
        args = lambda x: (x["grads"], x["e"], x["weights"])  # noqa: E731
        opt = lambda x: dict(global_mask=x["global_mask"],  # noqa: E731
                             participate=x["participate"])
        host = execute(cfg, plan, *args(card), **opt(card))
        got = execute_sharded(cfg, plan, *args(card), mesh=mesh, wire=wire,
                              **opt(card))
        on_cpu = execute_sharded(cfg, plan, *args(cpu), mesh=cpu_mesh,
                                 wire=wire, **opt(cpu))
        if {t.device for t in (got.aggregate, got.e_new, *got.stats)} != {
                card["grads"].device}:
            raise SystemExit(f"FAIL device {label}: the result is not on "
                             f"the caller's device")
        exact = cfg.err_sq_mode == "kernel" or plan.shape[1] == 1
        ok_host, rel_host = round_results_equal(host, got, exact)
        ok_cpu, rel_cpu = round_results_equal(on_cpu, got,
                                              cfg.err_sq_mode == "kernel")
        if not (ok_host and ok_cpu):
            raise SystemExit(
                f"FAIL device execute_sharded {label} (plan {plan.shape}): "
                f"= host execute on the card {ok_host} (err_sq rel "
                f"{rel_host:.2e}), = the CPU mesh {ok_cpu} (err_sq rel "
                f"{rel_cpu:.2e})")
        worst["host"] = max(worst["host"], rel_host)
        worst["cpu"] = max(worst["cpu"], rel_cpu)
        wires[label] = _wire_format(cfg, d, plan, part is not None, wire)
        if dtype == torch.float32 and wire == "auto" and (
                label.endswith(" chain") or label.endswith(" walker")):
            crossed += check_crossing(cfg, plan, cpu, on_cpu, mesh, label)
    compact = sorted(lb for lb, v in wires.items() if v == "compact")
    log(f"[device] execute_sharded on the card = host execute on the card "
        f"and = the CPU mesh's plain path, bit for bit (aggregate, EF rows, "
        f"nnz_*, bits; err_sq too under err_sq_mode='kernel' and on W = 1 "
        f"plans, else max rel {worst['host']:.2e} / {worst['cpu']:.2e} "
        f"against host / CPU) over {len(wires)} cases: 6 kinds x chain, "
        f"permuted chain, star_tree(28), the widest-path Walker tree, with "
        f"stragglers; both wires on the CL kinds; bf16 gradients. Compact "
        f"wire taken in {len(compact)} of them. Across the card and the CPU "
        f"(the card mesh under a CPU caller, ranks alternating CPU / card "
        f"under a CPU and a card caller; execute_sharded and "
        f"execute_sharded_batched, B = 2): {crossed} rounds on the chain, "
        f"permuted chain and Walker cases = the CPU, bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")


def check_crossing(cfg, plan, cpu, on_cpu, mesh, label) -> int:
    """``execute_sharded`` and ``execute_sharded_batched`` on meshes whose
    payloads, rows and stats cross between the card and the CPU, against
    the CPU mesh's round and host ``execute_batched`` on the CPU: each copy
    from the card has landed before the CPU reads it. Returns the rounds
    checked."""
    from repro_torch.agg import execute_batched
    from repro_torch.agg.device import (client_mesh, execute_sharded,
                                        execute_sharded_batched)

    k = plan.num_clients
    mixed = client_mesh(k, devices=["cpu", "cuda:0"] * (k // 2))
    # cohort 1: the clients' rows in reverse
    two = {n: None if v is None else torch.stack([v, v.flip(0)])
           for n, v in cpu.items() if n != "global_mask"}
    two["global_mask"] = torch.stack([cpu["global_mask"]] * 2)
    want_b = execute_batched(cfg, plan, two["grads"], two["e"],
                             two["weights"], global_mask=two["global_mask"],
                             participate=two["participate"])
    exact = cfg.err_sq_mode == "kernel"
    n = 0
    for name, m, dev in (("card mesh, cpu caller", mesh, "cpu"),
                         ("mixed mesh, cpu caller", mixed, "cpu"),
                         ("mixed mesh, card caller", mixed, "cuda")):
        on = lambda x: None if x is None else x.to(dev)  # noqa: E731
        got = execute_sharded(cfg, plan, on(cpu["grads"]), on(cpu["e"]),
                              on(cpu["weights"]),
                              global_mask=on(cpu["global_mask"]),
                              participate=on(cpu["participate"]), mesh=m)
        got_b = execute_sharded_batched(
            cfg, plan, on(two["grads"]), on(two["e"]), on(two["weights"]),
            global_mask=on(two["global_mask"]),
            participate=on(two["participate"]), mesh=m)
        ok, rel = round_results_equal(on_cpu, got, exact)
        ok_b, rel_b = round_results_equal(want_b, got_b, exact)
        if not (ok and ok_b):
            raise SystemExit(
                f"FAIL device execute_sharded {label}, {name}: = the CPU "
                f"{ok} (err_sq rel {rel:.2e}), batched = host "
                f"execute_batched on the CPU {ok_b} (err_sq rel {rel_b:.2e})")
        n += 2
    return n


def device_runs(pc, k):
    """(label, AggConfig keywords, Simulator keywords, run keywords, rounds,
    the flat or nested plan of round r, level-kernel launches per real
    slot) of phase 9's device-backend runs."""
    from repro_torch.agg import compile_plan, pod_ring_nested
    from repro_torch.core.algorithms import AggKind
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import walker_delta

    exact = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    thr = dict(exact, topq_impl="threshold", hist_branch=BRANCH)
    chain = compile_plan(k)
    topo = TreeTopology(walker_delta(**WALKER), "widest")
    fails = FailureSchedule(k, FAILURES)
    pods = pod_ring_nested(4, 7)
    runs = [
        ("cl_sia chain", dict(kind=AggKind.CL_SIA, **exact), {}, {},
         DEVICE_ROUNDS, lambda r: chain),
        ("cl_tc_sia walker", dict(kind=AggKind.CL_TC_SIA, **exact),
         dict(tree_topology=topo), dict(failure_schedule=fails),
         DEVICE_ROUNDS, lambda r: topo.plan(dead=tuple(fails.dead_at(r)))),
        ("tc_sia scan chain",
         dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["scan"]), {}, {},
         DEVICE_SHORT, lambda r: chain),
        ("tc_sia hist chain",
         dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["hist"]), {}, {},
         DEVICE_SHORT, lambda r: chain),
        ("cl_sia pods", dict(kind=AggKind.CL_SIA, **exact),
         dict(nested_topology=pods), {}, DEVICE_ROUNDS, lambda r: pods),
    ]
    # a rank step is one W = 1 level step of the whole d
    return [r + (per_level(pc.d, **r[1]),) for r in runs]


def real_slots(plan) -> int:
    """Real slots of a flat or nested plan: the device backend's rank
    steps per round."""
    stages = plan.stages if hasattr(plan, "stages") else (plan,)
    return int(sum((np.asarray(st.slot_mask) > 0).sum() for st in stages))


def device_path(level, data) -> dict:
    from repro_torch.agg.device import client_mesh
    from repro_torch.core import sparsify as sp
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.fed import Simulator
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.obs import smoke, validate_trace
    from repro_torch.topo import star_tree, walker_delta

    pc, fed, test = data
    k = pc.num_clients
    t_phase = time.perf_counter()
    PHASE9_DIR.mkdir(parents=True, exist_ok=True)
    mesh = client_mesh(k, devices=["cuda:0"] * k)
    cpu_mesh = client_mesh(k, devices=["cpu"] * k)
    log(f"[device] mesh: {k} ranks, all on {mesh.distinct()[0]} (one card: "
        f"the ranks share it, a transfer between ranks is no copy); "
        f"{torch.cuda.device_count()} card(s) visible")
    check_sharded(mesh, cpu_mesh, pc)

    runs = device_runs(pc, k)
    host_sims = {lb: Simulator(pc, AggConfig(**cfg), fed, device="cuda",
                               **skw) for lb, cfg, skw, _, _, _, _ in runs}
    dev_sims = {lb: Simulator(pc, AggConfig(**cfg), fed, device="cuda",
                              backend="device", mesh=mesh, **skw)
                for lb, cfg, skw, _, _, _, _ in runs}
    t0 = time.perf_counter()
    for lb, _, _, rkw, _, _, _ in runs:
        dev_sims[lb].run(1, seed=SEED, **rkw)
    torch.cuda.synchronize()
    # launches held to the plans' real slots, counted on the CPU first
    predicted = {lb: {n: sum(real_slots(plan_of(r)) for r in range(rounds))
                      * per for n, per in per_slot.items()}
                 for lb, _, _, _, rounds, plan_of, per_slot in runs}
    log(f"[device] warm-up {time.perf_counter() - t0:.1f} s; predicted "
        f"level-kernel launches (real slots of the plans x launches per "
        f"slot): {predicted}")

    # the device backend's runs, the launch counts read around them only;
    # the host backend's runs for the comparison come after
    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    lb_b = "cl_tc_sia walker"
    rkw_b, plan_b = next((r[3], r[5]) for r in runs if r[0] == lb_b)
    cfg_b = next(r[1] for r in runs if r[0] == lb_b)
    predicted["run_batched " + lb_b] = scaled(per_level(pc.d, **cfg_b), sum(
        real_slots(plan_b(r)) for r in range(DEVICE_ROUNDS)))
    level.reset_launch_counts()
    torch.cuda.synchronize()
    dev_out = {}
    for lb, _, _, rkw, rounds, _, _ in runs + [("run_batched " + lb_b,
                                                None, None, rkw_b,
                                                DEVICE_ROUNDS, None, None)]:
        before = [fn.launches for fn in level.KERNELS]
        with TauRecorder(sp) as taus:
            if lb.startswith("run_batched"):
                out = dev_sims[lb_b].run_batched(
                    rounds, seeds=DEVICE_SEEDS, **rkw)
            else:
                out = dev_sims[lb].run(rounds, seed=SEED, **rkw)
        torch.cuda.synchronize()
        grown = {n: fn.launches - b for n, fn, b in
                 zip(names, level.KERNELS, before) if fn.launches - b}
        if grown != predicted[lb]:
            raise SystemExit(f"FAIL device {lb}: level-kernel launches "
                             f"{grown}, predicted {predicted[lb]}")
        dev_out[lb] = (out, list(taus), grown)
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}

    for lb, _, _, rkw, rounds, _, _ in runs:
        dev, taus_dev, grown = dev_out[lb]
        with TauRecorder(sp) as taus_host:
            host = host_sims[lb].run(rounds, seed=SEED, **rkw)
        same_tau = len(taus_dev) == len(taus_host) and all(
            bitwise_equal(a, b) and bitwise_equal(c, e)
            for (a, c), (b, e) in zip(taus_dev, taus_host))
        if not (dev["loss"] == host["loss"] and dev["bits"] == host["bits"]
                and dev["nnz"] == host["nnz"] and same_tau
                and states_equal(dev["state"], host["state"])):
            raise SystemExit(f"FAIL device {lb}: the device backend's run "
                             f"differs from the host backend's on the card "
                             f"(τ equal: {same_tau})")
        loss = dev["loss"]
        if not (all(math.isfinite(v) for v in loss) and loss[-1] < loss[0]):
            raise SystemExit(f"FAIL device {lb}: loss did not fall "
                             f"({loss[0]} -> {loss[-1]})")
        log(f"[device] {lb:17s}: {rounds} rounds, device backend = host "
            f"backend on the card bit for bit (model, EF, stage EF tiers, "
            f"{len(taus_dev)} τ searches, bits, nnz, loss); loss "
            f"{loss[0]:.4f} -> {loss[-1]:.4f}; launches {grown} = real "
            f"slots x per slot")

    bat_dev, _, grown = dev_out["run_batched " + lb_b]
    bat_host = host_sims[lb_b].run_batched(DEVICE_ROUNDS, seeds=DEVICE_SEEDS,
                                           **rkw_b)
    if not (bat_dev["loss"] == bat_host["loss"]
            and bat_dev["bits"] == bat_host["bits"]
            and states_equal(bat_dev["state"], bat_host["state"])):
        raise SystemExit(f"FAIL device run_batched {lb_b}: the run differs "
                         f"from the host backend's")
    log(f"[device] run_batched {lb_b}, B = {len(DEVICE_SEEDS)}: "
        f"{DEVICE_ROUNDS} rounds, device = host backend bit for bit "
        f"(model, EF, bits, loss per cohort); launches {grown} = one step "
        f"per real slot for all {len(DEVICE_SEEDS)} cohorts")
    log(f"[device] level-kernel launches over the device-backend runs: "
        f"{ {n: v for n, v in launches.items() if v} }")

    # the card mesh against the CPU mesh, on the CPU run's gradients
    for lb, cfg, skw, rkw, _, plan_of, _ in runs:
        if lb in ("cl_sia chain", "cl_tc_sia walker", "cl_sia pods"):
            tree_card_matches_cpu(
                dev_sims[lb], Simulator(pc, AggConfig(**cfg), fed,
                                        device="cpu", backend="device",
                                        mesh=cpu_mesh, **skw),
                [plan_of(r) for r in range(1, 1 + DEVICE_SHORT)],
                f"{lb} (device backend, card mesh vs CPU mesh)", "device")
    if torch.cuda.device_count() >= 2:
        n = torch.cuda.device_count()
        spread = client_mesh(k, devices=[f"cuda:{r % n}" for r in range(k)])
        lb, cfg, skw, rkw = runs[1][:4]
        a = Simulator(pc, AggConfig(**cfg), fed, device="cuda",
                      backend="device", mesh=spread, **skw).run(
                          DEVICE_ROUNDS, seed=SEED, **rkw)
        b = dev_sims[lb].run(DEVICE_ROUNDS, seed=SEED, **rkw)
        if a["loss"] != b["loss"] or not states_equal(a["state"],
                                                      b["state"]):
            raise SystemExit(f"FAIL device {lb}: the ranks spread over {n} "
                             f"cards differ from the one-card mesh")
        log(f"[device] {lb}: ranks round-robin over {n} cards = one card, "
            f"bit for bit")
    else:
        log("[device] one card: the round-robin spread over cards is not "
            "run")

    # the clustered Walker scenario of phase 8 on the device backend
    spec = walker_scenario(pc)
    traces = [PHASE9_DIR / f"scenario_{b}.jsonl" for b in ("host", "device")]
    out_h, recs_h, _ = scenario_run(pc, fed, spec, traces[0])
    out_d, recs_d, sim_d = scenario_run(pc, fed, spec, traces[1],
                                        backend="device", mesh=mesh)
    meta = json.loads(traces[1].read_text().splitlines()[0])
    strip = lambda r: {k_: v for k_, v in r.items()  # noqa: E731
                       if k_ != "phases"}
    err_rel = 0.0
    for a, b in zip(recs_h, recs_d):
        for sa, sb in zip(a["stages"], b["stages"]):
            err_rel = max(err_rel, max((abs(u - v) / max(abs(u), 1e-30)
                                        for u, v in zip(sa["err_sq"],
                                                        sb["err_sq"])),
                                       default=0.0))
            sb["err_sq"] = sa["err_sq"]
        b["totals"]["err_sq"] = a["totals"]["err_sq"]
    res = validate_trace(str(traces[1]))
    same = [strip(r) for r in recs_h] == [strip(r) for r in recs_d]
    if (res["errors"] or meta.get("backend") != "device"
            or sim_d.trace_counter.count != 1 or err_rel > 1e-6 or not same
            or out_h["loss"] != out_d["loss"]):
        raise SystemExit(f"FAIL device scenario: trace errors "
                         f"{res['errors'][:3]}, backend {meta.get('backend')}"
                         f", {sim_d.trace_counter.count} input signatures, "
                         f"records equal to the host trace's: {same}, "
                         f"err_sq max rel {err_rel:.2e}")
    log(f"[device] scenario {spec.name} on the device backend: trace valid "
        f"({ {k_: v for k_, v in res.items() if k_ != 'errors'} }), 1 input "
        f"signature, meta backend 'device', its {len(recs_d)} round records "
        f"= the host trace's (bits, nnz, loss, participation, EF masses, "
        f"plans, timelines bit for bit; per-hop err_sq, a row sum whose "
        f"order on the card depends on the level width, max rel "
        f"{err_rel:.2e})")
    t0 = time.perf_counter()
    smoke_log = PHASE9_DIR / "smoke.log"
    with open(smoke_log, "w") as f, contextlib.redirect_stdout(f):
        rc = smoke.main(["--device", "--mesh", "cuda:0",
                         "--out", str(PHASE9_DIR / "smoke")])
    oks = [ln.split()[1].rstrip(":") for ln in smoke_log.read_text()
           .splitlines() if ln.startswith("[OK]")]
    if rc != 0 or len(oks) != 5:
        raise SystemExit(f"FAIL obs.smoke --device exited {rc} (OK: {oks};"
                         f" see {smoke_log})")
    log(f"[device] obs.smoke --device --mesh cuda:0 (defaults: 8 clients, "
        f"10 rounds): {', '.join(oks)} OK ({time.perf_counter() - t0:.1f} "
        f"s; output in {smoke_log.relative_to(PHASE9_DIR.parents[1])})")

    # ms per round, device backend beside host backend, in turns
    cl = AggConfig(**runs[0][1])
    walker = TreeTopology(walker_delta(**WALKER), "widest")
    cells = {}
    for name, skw, rkw in (("chain", {}, {}),
                           ("star", {}, dict(topology=star_tree(k))),
                           ("walker", dict(tree_topology=walker), {}),
                           ("nested", runs[4][2], {})):
        for backend, bkw in (("host", {}),
                             ("device", dict(backend="device", mesh=mesh))):
            sim = Simulator(pc, cl, fed, device="cuda", **skw, **bkw)
            sim.run(1, seed=SEED, **rkw)
            cells[(name, backend)] = (sim, rkw)
    times = {key: [] for key in cells}
    for turn in range(DEVICE_TURNS):
        order = list(cells) if turn % 2 == 0 else list(cells)[::-1]
        for key in order:
            sim, rkw = cells[key]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(DEVICE_TIMED_ROUNDS, seed=SEED, **rkw)
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0)
                              / DEVICE_TIMED_ROUNDS)
    med = {key: float(np.median(v)) for key, v in times.items()}
    log(f"[device] {nvidia_smi()}")
    log(f"[device] cl_sia ms per round (host clock, synchronized, "
        f"{DEVICE_TIMED_ROUNDS} rounds, median of {DEVICE_TURNS} turns "
        f"[min, max]), host backend | device backend | device / host: "
        + "; ".join(
            f"{name} {med[(name, 'host')]:.2f} "
            f"[{min(times[(name, 'host')]):.2f}, "
            f"{max(times[(name, 'host')]):.2f}] | "
            f"{med[(name, 'device')]:.2f} "
            f"[{min(times[(name, 'device')]):.2f}, "
            f"{max(times[(name, 'device')]):.2f}] | "
            f"{med[(name, 'device')] / med[(name, 'host')]:.3f}"
            for name in ("chain", "star", "walker", "nested")))
    for name, backend in (("chain", "device"), ("star", "device"),
                          ("star", "host")):
        sim, rkw = cells[(name, backend)]
        profile_calls(f"{backend} backend cl_sia {name}",
                      lambda: sim.run(3, seed=SEED, **rkw), 3)
    log(f"[device] phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the rotated-segment lowering
# ---------------------------------------------------------------------------

SEG_BATCH = 4                      # run_plan_segments_batched cohorts
SEG_TURNS = 5                      # alternating turns of the timing
SEG_TIMED = 5                      # rounds per turn
SEG_LARGE = 2 ** 18                # segment width of the large chain ring
SEG_SHARDS = 8                     # shards of the sharded τ search
SEG_LANES = (4, 2 ** 18)           # its [W, d] form: lanes × width


def segment_plans(k, cfg_kw):
    """name → port plan of phase 10's flat cases: the ring's chain, a
    permuted chain (both on the register path), ``star_tree(28)`` (one
    level of 28 slots) and phase 6's Walker tree; then the Walker tree with
    client 0 dead and bandwidth budgets (the stub and budget plan)."""
    from repro_torch.agg import compile_plan
    from repro_torch.agg.device import ring_chain_plan
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.topo import star_tree, walker_delta

    walker = TreeTopology(walker_delta(**WALKER), "widest")
    perm = np.random.default_rng(SEED + 100).permutation(k)
    return {"ring": ring_chain_plan(k), "permuted chain": compile_plan(perm),
            "star": compile_plan(star_tree(k)), "walker": walker.plan(),
            "walker stub+budget": walker.plan(
                dead=(0,), bandwidth_aware=True,
                cfg=AggConfig(**cfg_kw))}


def segment_cases(k, q):
    """(label, AggConfig keywords, plan name) of the flat checks."""
    from repro_torch.core.algorithms import AggKind

    kw = dict(q=q)
    cases = []
    for kind in (AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA,
                 AggKind.TC_SIA, AggKind.CL_TC_SIA, AggKind.DENSE_IA):
        err = ({} if kind == AggKind.DENSE_IA
               else dict(err_sq_mode="kernel"))
        for name in ("ring", "permuted chain", "star", "walker"):
            cases.append((f"{kind.value} {name}",
                          dict(kind=kind, **kw, **err), name))
    for kind in (AggKind.CL_SIA, AggKind.SIA):
        cases.append((f"{kind.value} walker stub+budget",
                      dict(kind=kind, **kw, err_sq_mode="kernel"),
                      "walker stub+budget"))
    cases.append(("tc_sia walker threshold scan",
                  dict(kind=AggKind.TC_SIA, **kw, err_sq_mode="kernel",
                       topq_impl="threshold", hist_branch=BRANCH,
                       **THRESHOLD["scan"]), "walker"))
    cases.append(("cl_sia walker threshold hist",
                  dict(kind=AggKind.CL_SIA, **kw, err_sq_mode="kernel",
                       topq_impl="threshold", hist_branch=BRANCH,
                       **THRESHOLD["hist"]), "walker"))
    cases.append(("cl_sia star jnp err_sq", dict(kind=AggKind.CL_SIA, **kw),
                  "star"))
    return cases


def segment_launches(cfg, plan, width: int) -> dict:
    """Level-kernel launches of one segments round: one level step per
    level for all ranks' lanes of ``width`` elements."""
    from _torch_launches import level_launches

    return level_launches(cfg, width, plan.shape[0],
                          budgets=getattr(plan, "q_budget", None) is not None)


def pairwise_sum(v):
    """Σ over the last axis: the columns' halves added pairwise until one
    column is left, an odd last column carried to the next pass — the
    fixed order in which the lowering sums a level's per-rank stats."""
    cols = list(v.unbind(-1))
    while len(cols) > 1:
        h = len(cols) // 2
        cols = [cols[i] + cols[h + i] for i in range(h)] + cols[2 * h:]
    return cols[0]


def grown_since(level, before) -> dict:
    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    return {n: fn.launches - b for n, fn, b in zip(names, level.KERNELS,
                                                   before)
            if fn.launches - b}


def segments_inputs(k, n, q_global, seed, pieces=None):
    """[K, n] gradients and EF, a TCS mask with q_global ones in each of
    ``pieces`` (default K) equal pieces — at most Q_G ones in every segment
    a CL-TC-SIA compact wire carries, as the simulator's masks —, and
    stragglers."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.01)
    e = rng.standard_normal((k, n), dtype=np.float32) * np.float32(1e-3)
    pieces = pieces or k
    seg = n // pieces
    gm = np.zeros((pieces, seg), np.float32)
    for s in range(pieces):
        gm[s, rng.choice(seg, q_global, replace=False)] = 1.0
    part = (rng.random(k) < 0.8).astype(np.float32)
    return (torch.from_numpy(g), torch.from_numpy(e),
            torch.from_numpy(gm.reshape(n)), torch.from_numpy(part))


def run_segments(cfg, plan, mesh, x, dev, **kw):
    """``run_plan_segments_local`` on per-rank rows moved to ``dev``."""
    from repro_torch.agg.device import run_plan_segments_local

    g, e, gm, part = (t.to(dev) for t in x)
    k = g.shape[0]
    return run_plan_segments_local(cfg, plan, mesh, list(g), list(e), 1.3,
                                   global_mask=[gm] * k,
                                   participate=list(part), **kw)


def segments_equal(a, b, exact_err: bool) -> tuple:
    """(equal, err_sq max rel diff) of two segments rounds' per-rank
    lists."""
    same = all(bitwise_equal(u, v) for u, v in zip(a[0] + a[1], b[0] + b[1]))
    same &= all(bitwise_equal(s.bits, t.bits) and bitwise_equal(s.nnz, t.nnz)
                for s, t in zip(a[2], b[2]))
    ea = torch.stack([s.err_sq.cpu() for s in a[2]])
    eb = torch.stack([s.err_sq.cpu() for s in b[2]])
    rel = err_sq_rel(eb, ea)
    ok = bitwise_equal(ea, eb) if exact_err else rel <= 1e-6
    return same and ok, rel


def host_segments(cfg, plan, x, dev):
    """Host ``execute_batched`` on ``dev`` over the K rotated segments
    (position p of segment s is rank (p + s) mod K; stragglers, stubs and
    budgets relabelled), as the lowering's per-rank lists; and host
    ``execute`` on segments 0 and K − 1 alone."""
    import dataclasses

    from repro_torch.agg import execute, execute_batched, stack_plans

    g, e, gm, part = (t.to(dev) for t in x)
    k, n = g.shape
    seg = n // k
    rot = (np.arange(k)[None, :] + np.arange(k)[:, None]) % k   # [S, P]
    rot_t = torch.as_tensor(rot, device=dev)
    cols = torch.arange(k, device=dev)[:, None]
    base = dataclasses.replace(plan, alive=np.ones(k, np.float32),
                               q_budget=None)
    plans = [dataclasses.replace(
        base, q_budget=None if plan.q_budget is None
        else np.asarray(plan.q_budget)[rot[s]]) for s in range(k)]
    p_rank = part * torch.as_tensor(plan.alive, device=dev)
    gs = g.view(k, k, seg)[rot_t, cols]                          # [S, P, seg]
    es = e.view(k, k, seg)[rot_t, cols]
    res = execute_batched(cfg, stack_plans(plans), gs, es,
                          torch.full((k, k), 1.3, device=dev),
                          global_mask=gm.view(k, seg),
                          participate=p_rank[rot_t])
    ef = torch.empty_like(e).view(k, k, seg)
    ef[rot_t, cols] = res.e_new
    direct = {}
    for s in (0, k - 1):
        one = execute(cfg, plans[s], gs[s], es[s],
                      torch.full((k,), 1.3, device=dev),
                      global_mask=gm.view(k, seg)[s],
                      participate=p_rank[rot_t[s]])
        direct[s] = (bitwise_equal(one.aggregate, res.aggregate[s])
                     and bitwise_equal(one.e_new, res.e_new[s]))
    # each rank's stats as the lowering sums them: per level its lanes
    # (slot w plays position node_id[l, w] of segment (r − node) mod K),
    # in its fixed pairwise order
    node = np.asarray(plan.node_id)
    mask = torch.as_tensor(np.asarray(plan.slot_mask, np.float32),
                           device=dev)
    register = plan.shape[1] == 1 and plan.shape[0] == k and bool(
        (np.asarray(plan.slot_mask) > 0).all())
    stats = []
    for field in ("bits", "nnz_out", "err_sq"):
        h = getattr(res.stats, field).to(torch.float32)          # [S, P]
        acc = torch.zeros((k,), device=dev)
        for li in range(node.shape[0]):
            b = np.minimum(node[li], k - 1)
            s_idx = (np.arange(k)[:, None] - b[None, :]) % k
            v = h[torch.as_tensor(s_idx, device=dev),
                  torch.as_tensor(b, device=dev)[None, :]]
            v = torch.where(mask[li][None] > 0, v, torch.zeros_like(v))
            acc = acc + (v[:, 0] if register
                         else pairwise_sum(v * mask[li][None]))
        stats.append(acc)
    from repro_torch.core.ring import RingStats
    return ((list(res.aggregate), list(ef.view(k, n)),
             [RingStats(*(s[r] for s in stats)) for r in range(k)]),
            all(direct.values()))


def check_segments(level, pc, mesh, cpu_mesh, mixed) -> dict:
    """Phase 10's flat cases; returns the level-kernel launches of the
    lowering's card rounds."""
    from repro_torch.agg.device import _segments_compact
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.ring import segment_budget

    k = pc.num_clients
    n = -(-pc.d // k) * k
    q = segment_budget(pc.q * k, k)
    cases = segment_cases(k, q)
    plans = segment_plans(k, dict(q=q))
    x = segments_inputs(k, n, AggConfig(kind="cl_tc_sia", q=q).q_global,
                        SEED + 101)
    t0 = time.perf_counter()
    launches: dict = {}
    worst = {"host": 0.0, "cpu": 0.0}
    compact, crossed = [], 0
    for label, kw, name in cases:
        cfg = AggConfig(**kw)
        plan = plans[name]
        exact = cfg.err_sq_mode == "kernel"
        before = [fn.launches for fn in level.KERNELS]
        got = run_segments(cfg, plan, mesh, x, "cuda")
        torch.cuda.synchronize()
        grown = grown_since(level, before)
        if grown != segment_launches(cfg, plan, n // k):
            raise SystemExit(f"FAIL segments {label}: level-kernel launches "
                             f"{grown}, predicted "
                             f"{segment_launches(cfg, plan, n // k)}")
        for n_, v in grown.items():
            launches[n_] = launches.get(n_, 0) + v
        host, direct = host_segments(cfg, plan, x, "cuda")
        on_cpu = run_segments(cfg, plan, cpu_mesh, x, "cpu")
        bfly = run_segments(cfg, plan, mesh, x, "cuda", transport="butterfly")
        ok_host, rel_host = segments_equal(host, got, exact)
        ok_cpu, rel_cpu = segments_equal(on_cpu, got, exact)
        ok_bf, _ = segments_equal(bfly, got, True)
        if name in ("ring", "walker") and label.split()[0] in (
                "cl_tc_sia", "sia"):
            crossed += 1
            ok_mix, _ = segments_equal(
                run_segments(cfg, plan, mixed, x, "cpu"), on_cpu, exact)
        else:
            ok_mix = True
        if not (ok_host and direct and ok_cpu and ok_bf and ok_mix):
            raise SystemExit(
                f"FAIL segments {label} (plan {plan.shape}): = host execute "
                f"per segment on the card {ok_host} (err_sq rel "
                f"{rel_host:.2e}; execute alone {direct}), = the CPU mesh "
                f"{ok_cpu} (err_sq rel {rel_cpu:.2e}), = the butterfly "
                f"{ok_bf}, mixed mesh = the CPU {ok_mix}")
        worst["host"] = max(worst["host"], rel_host)
        worst["cpu"] = max(worst["cpu"], rel_cpu)
        if _segments_compact(cfg, n // k, plan, True, "auto", True):
            compact.append(label)
    log(f"[segments] run_plan_segments_local on {k} ranks of the card (n = "
        f"{n}, seg = {n // k}, q = {q} per segment) over {len(cases)} cases "
        f"(6 kinds x ring, permuted chain, star_tree(28), the Walker tree; "
        f"CL-SIA and SIA on the Walker tree with client 0 dead and "
        f"bandwidth budgets; TC-SIA threshold scan; CL-SIA threshold "
        f"hist; CL-SIA err_sq 'jnp'), "
        f"with stragglers: = host execute per rotated segment on the card "
        f"(execute_batched over the {k} segments, execute alone on two), "
        f"= the CPU mesh, = the butterfly, bit for bit (aggregate, EF rows, "
        f"bits, nnz; err_sq under 'kernel', else max rel "
        f"{worst['host']:.2e} / {worst['cpu']:.2e} against host / CPU); "
        f"{crossed} rounds on ranks alternating CPU / card = the CPU mesh; "
        f"compact wire in {len(compact)} cases; launches one level step per "
        f"level: {launches} ({time.perf_counter() - t0:.1f} s)")
    return launches


def check_segments_batched(level, pc, mesh) -> dict:
    """``run_plan_segments_batched`` with B cohorts: each cohort = its
    sequential round bit for bit, one level step per level for all."""
    from repro_torch.agg.device import (run_plan_segments_batched,
                                        run_plan_segments_local)
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.ring import segment_budget

    k = pc.num_clients
    n = -(-pc.d // k) * k
    q = segment_budget(pc.q * k, k)
    plans = segment_plans(k, dict(q=q))
    launches: dict = {}
    for kind in ("cl_tc_sia", "tc_sia"):
        cfg = AggConfig(kind=kind, q=q, err_sq_mode="kernel")
        xs = [segments_inputs(k, n, cfg.q_global, SEED + 110 + b)
              for b in range(SEG_BATCH)]
        stack = lambda i: torch.stack([x[i] for x in xs], 1).cuda()  # noqa
        for name in ("ring", "walker"):
            plan = plans[name]
            before = [fn.launches for fn in level.KERNELS]
            fin, ef, st = run_plan_segments_batched(
                cfg, plan, mesh, list(stack(0)), list(stack(1)), 1.3,
                global_mask=list(torch.stack([x[2] for x in xs]).cuda()[
                    None].expand(k, -1, -1)),
                participate=list(stack(3)))
            torch.cuda.synchronize()
            grown = grown_since(level, before)
            if grown != segment_launches(cfg, plan, n // k):
                raise SystemExit(f"FAIL segments batched {kind} {name}: "
                                 f"launches {grown}, predicted "
                                 f"{segment_launches(cfg, plan, n // k)}")
            for n_, v in grown.items():
                launches[n_] = launches.get(n_, 0) + v
            for b in range(SEG_BATCH):
                one = run_segments(cfg, plan, mesh, xs[b], "cuda")
                same = segments_equal(
                    one, ([f[b] for f in fin], [e[b] for e in ef],
                          [type(s)(*(v[b] for v in s)) for s in st]), True)
                if not same[0]:
                    raise SystemExit(f"FAIL segments batched {kind} {name}: "
                                     f"cohort {b} differs from its "
                                     f"sequential round")
    log(f"[segments] run_plan_segments_batched, B = {SEG_BATCH}, CL-TC-SIA "
        f"and TC-SIA on the ring and the Walker tree: every cohort = its "
        f"sequential round bit for bit; launches one level step per level "
        f"for all cohorts: {launches}")
    return launches


def staged_host_equal(cfg, nested, sizes, x, got) -> bool:
    """The staged host reference of a two-stage nested round on the card:
    stage 0 per data segment s on the merged forest (rank p·K_d + (k + s)
    mod K_d plays local k of pod p), stage 1 per (s, pod sub-segment t) on
    the stage-0 sink partials — against the lowering's per-rank lists."""
    import dataclasses

    from repro_torch.agg import execute

    kd, kp = sizes
    g, e, pe, gm, part = x
    k, n = g.shape
    seg1, seg2 = n // kd, n // k
    st0, st1 = nested.stages
    # stubs are physical ranks: an all-alive forest, participation·alive
    # relabelled
    p_rank = part * torch.as_tensor(st0.alive, device=g.device)
    st0 = dataclasses.replace(st0, alive=np.ones(k, np.float32))
    fin, ef, pef = got
    ok = True
    for s in range(kd):
        rows = [p * kd + (j + s) % kd for p in range(kp) for j in range(kd)]
        c1 = slice(s * seg1, (s + 1) * seg1)
        r0 = execute(cfg, st0, g[rows, c1], e[rows, c1],
                     torch.full((k,), 1.3, device=g.device),
                     global_mask=gm[c1], participate=p_rank[rows])
        ok &= all(bitwise_equal(r0.e_new[i], ef[r][c1])
                  for i, r in enumerate(rows))
        for t in range(kp):
            urows = [(u + t) % kp for u in range(kp)]
            pe_rows = [u * kd + s for u in urows]
            c2 = slice(t * seg2, (t + 1) * seg2)
            g2 = slice(s * seg1 + t * seg2, s * seg1 + (t + 1) * seg2)
            r1 = execute(cfg, st1, r0.aggregate[urows, c2].contiguous(),
                         pe[pe_rows, c2],
                         torch.ones((kp,), device=g.device),
                         global_mask=gm[g2])
            ok &= bitwise_equal(r1.aggregate, fin[t * kd + s])
            ok &= all(bitwise_equal(r1.e_new[u], pef[r][c2])
                      for u, r in enumerate(pe_rows))
    return ok


def check_nested_segments(level, pc, mesh, cpu_mesh) -> dict:
    """``hierarchical_ring_local`` and ``run_nested_segments_local`` on
    sizes (7, 4): = the staged host reference on the card and = the CPU
    mesh; a mesh-misaligned plan raises."""
    from repro_torch.agg import compile_nested
    from repro_torch.agg.device import run_nested_segments_local
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.hierarchical import hierarchical_ring_local
    from repro_torch.core.ring import segment_budget
    from repro_torch.topo import cluster_routed, walker_delta
    from repro_torch.topo.tree import PS, AggTree

    k = pc.num_clients
    sizes = (7, 4)
    n = -(-pc.d // k) * k
    q = segment_budget(pc.q * k, k)
    graph = walker_delta(**WALKER)
    aligned = compile_nested(cluster_routed(
        graph, clusters=[range(7 * p, 7 * p + 7) for p in range(4)]))
    trees = [AggTree(parent=tuple(PS if i == 0 else (i - 1) // (1 + p % 3)
                                  for i in range(7))) for p in range(4)]
    per_pod = compile_nested([[(tuple(range(7 * p, 7 * p + 7)), trees[p])
                               for p in range(4)], [((0, 1, 2, 3), None)]])
    if not (aligned.clustered[0].mesh_aligned()
            and aligned.clustered[0].uniform()
            and not per_pod.clustered[0].uniform()):
        raise SystemExit("FAIL segments nested: the plane-aligned Walker "
                         "clusters are not aligned and uniform")
    from repro_torch.agg import pod_ring_nested
    launches: dict = {}
    cases = [("hierarchical ring", pod_ring_nested(4, 7), "cl_tc_sia"),
             ("hierarchical ring", pod_ring_nested(4, 7), "sia"),
             ("plane-aligned walker", aligned, "cl_tc_sia"),
             ("per-pod trees", per_pod, "cl_sia")]
    g, e, gm, part = segments_inputs(
        k, n, AggConfig(kind="cl_tc_sia", q=q).q_global, SEED + 120,
        pieces=sizes[0])
    pe = torch.from_numpy(np.random.default_rng(SEED + 121).standard_normal(
        (k, n // 7), dtype=np.float32)) * np.float32(1e-3)
    for label, nested, kind in cases:
        cfg = AggConfig(kind=kind, q=q, err_sq_mode="kernel")
        outs = []
        for dev, m in (("cuda", mesh), ("cpu", cpu_mesh)):
            args = [t.to(dev) for t in (g, e, pe, gm, part)]
            before = [fn.launches for fn in level.KERNELS]
            if label == "hierarchical ring":
                fin, ef, pef, st = hierarchical_ring_local(
                    cfg, m, list(args[0]), list(args[1]), list(args[2]), 1.3,
                    sizes=sizes, global_mask=[args[3]] * k,
                    participate=list(args[4]))
            else:
                fin, ef, (pef,), st = run_nested_segments_local(
                    cfg, nested, m, list(args[0]), list(args[1]),
                    (list(args[2]),), 1.3, sizes=sizes,
                    global_mask=[args[3]] * k, participate=list(args[4]))
            if dev == "cuda":
                torch.cuda.synchronize()
                grown = grown_since(level, before)
                want = {}
                for s, cfg_s in enumerate((cfg, cfg)):
                    width = n // int(np.prod(sizes[:s + 1]))
                    for n_, v in segment_launches(
                            cfg_s, nested.stages[s]
                            if s else nested.clustered[0].subplan(0),
                            width).items():
                        want[n_] = want.get(n_, 0) + v
                if grown != want:
                    raise SystemExit(f"FAIL segments nested {label} {kind}: "
                                     f"launches {grown}, predicted {want}")
                for n_, v in grown.items():
                    launches[n_] = launches.get(n_, 0) + v
                host_ok = staged_host_equal(cfg, nested, sizes, args,
                                            (fin, ef, pef))
            outs.append(fin + ef + pef)
        same = all(bitwise_equal(a, b) for a, b in zip(*outs))
        if not (host_ok and same):
            raise SystemExit(f"FAIL segments nested {label} {kind}: = the "
                             f"staged host reference on the card {host_ok}, "
                             f"= the CPU mesh {same}")
    default = compile_nested(cluster_routed(graph, 4))
    z = [torch.zeros(n, device="cuda")] * k
    try:
        run_nested_segments_local(AggConfig(q=q), default, mesh, z, z,
                                  ([torch.zeros(n // 7, device="cuda")] * k,),
                                  1.0, sizes=sizes)
    except ValueError as err:
        refused = str(err)
    else:
        raise SystemExit("FAIL segments nested: cluster_routed(walker, 4) "
                         "was not refused")
    log(f"[segments] nested on sizes (7, 4): hierarchical_ring_local "
        f"(CL-TC-SIA, SIA), the plane-aligned cluster_routed Walker plan "
        f"(stages {[s.shape for s in aligned.stages]}, identical clusters: "
        f"static) and per-pod trees (the butterfly) = the staged host "
        f"reference on the card and = the CPU mesh, bit for bit; launches "
        f"{launches}; cluster_routed(walker, 4) refused: {refused!r}")
    return launches


def check_sharded_search(sp, ops, topq_threshold, level) -> dict:
    """``threshold_for_topq`` over 8 shards on the card (1-D at d = 10^6
    with ``count_ge``, [4, 2^18] with ``count_ge_level``): τ and counts =
    the unsharded search on the CPU."""
    rng = np.random.default_rng(SEED + 130)
    one = torch.from_numpy(rng.standard_normal(SEARCH_D, dtype=np.float32))
    lanes = torch.from_numpy(rng.standard_normal(SEG_LANES,
                                                 dtype=np.float32))
    out = {"count_ge": 0, "count_ge_level": 0}
    for impl in ("scan", "hist"):
        rounds = THRESHOLD[impl]["hist_rounds"]
        kw = dict(branch=BRANCH, rounds=rounds, tau_impl=impl,
                  with_counts=True)
        for x, fn, name in ((one, ops.count_ge, "count_ge"),
                            (lanes, ops.count_ge_level, "count_ge_level")):
            want = sp.threshold_for_topq(x, 500, **kw)
            c0 = (topq_threshold.count_ge_cuda.launches,
                  level.count_ge_level_cuda.launches)
            got = sp.threshold_for_topq(
                list(x.cuda().chunk(SEG_SHARDS, dim=-1)), 500, count_fn=fn,
                **kw)
            torch.cuda.synchronize()
            grown = (topq_threshold.count_ge_cuda.launches - c0[0]
                     + level.count_ge_level_cuda.launches - c0[1])
            predicted = SEG_SHARDS * rounds if impl == "scan" else 0
            if not (bitwise_equal(want[0], got[0])
                    and bitwise_equal(want[1], got[1])
                    and grown == predicted):
                raise SystemExit(f"FAIL segments sharded τ search {impl} "
                                 f"{name}: τ/counts = the unsharded search "
                                 f"{bitwise_equal(want[0], got[0])}/"
                                 f"{bitwise_equal(want[1], got[1])}, "
                                 f"launches {grown} (predicted {predicted})")
            out[name] += grown
    log(f"[segments] threshold_for_topq over {SEG_SHARDS} card shards "
        f"(d = {SEARCH_D}, count_ge; {SEG_LANES[0]} x {SEG_LANES[1]}, "
        f"count_ge_level), scan and hist: τ and counts = the unsharded "
        f"search on the CPU bit for bit; launches {out}")
    return {k_: v for k_, v in out.items() if v}


def segments_path(level, sp, ops, topq_threshold, data) -> dict:
    from repro_torch.agg import execute
    from repro_torch.agg.device import (client_mesh, execute_sharded,
                                        run_plan_segments_local)
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.hierarchical import hierarchical_ring_local
    from repro_torch.core.ring import segment_budget

    pc = data[0]
    k = pc.num_clients
    t_phase = time.perf_counter()
    mesh = client_mesh(k, devices=["cuda:0"] * k)
    cpu_mesh = client_mesh(k, devices=["cpu"] * k)
    mixed = client_mesh(k, devices=["cpu", "cuda:0"] * (k // 2))
    level.reset_launch_counts()
    launches = {}
    for part in (check_segments(level, pc, mesh, cpu_mesh, mixed),
                 check_segments_batched(level, pc, mesh),
                 check_nested_segments(level, pc, mesh, cpu_mesh),
                 check_sharded_search(sp, ops, topq_threshold, level)):
        for n_, v in part.items():
            launches[n_] = launches.get(n_, 0) + v
    log(f"[segments] launches over phase 10's lowering runs: {launches}")

    # ms per segments round beside execute_sharded and host execute on the
    # same [K, n] (costs only: those compute a whole-vector Top-Q)
    n = -(-pc.d // k) * k
    q = segment_budget(pc.q * k, k)
    cfg = AggConfig(q=q)
    x = [t.cuda() for t in segments_inputs(k, n, 1, SEED + 140)]
    plans = segment_plans(k, dict(q=q))
    rows = (list(x[0]), list(x[1]))
    w = torch.full((k,), 1.3, device="cuda")

    def seg_round(plan, transport="static"):
        return lambda: run_plan_segments_local(cfg, plan, mesh, *rows, 1.3,
                                               transport=transport)

    def pods():
        return hierarchical_ring_local(cfg, mesh, *rows,
                                       list(torch.zeros((k, n // 7),
                                                        device="cuda")),
                                       1.3, sizes=(7, 4))

    big = torch.from_numpy(np.random.default_rng(SEED + 141).standard_normal(
        (k, k * SEG_LARGE), dtype=np.float32)).cuda()
    big_rows = (list(big), list(torch.zeros_like(big)))
    cells = {}
    for name in ("ring", "star", "walker"):
        plan = plans[name]
        cells[f"{name} segments"] = seg_round(plan)
        cells[f"{name} execute_sharded"] = (
            lambda plan=plan: execute_sharded(cfg, plan, x[0], x[1], w,
                                              mesh=mesh))
        cells[f"{name} host execute"] = (
            lambda plan=plan: execute(cfg, plan, x[0], x[1], w))
    cells["walker butterfly"] = seg_round(plans["walker"], "butterfly")
    cells["star butterfly"] = seg_round(plans["star"], "butterfly")
    cells["pod ring segments"] = pods
    cells["ring segments, n = 28 x 2^18"] = (
        lambda: run_plan_segments_local(cfg, plans["ring"], mesh, *big_rows,
                                        1.3))
    for fn in cells.values():
        fn()
    torch.cuda.synchronize()
    times = {key: [] for key in cells}
    for turn in range(SEG_TURNS):
        order = list(cells) if turn % 2 == 0 else list(cells)[::-1]
        for key in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SEG_TIMED):
                cells[key]()
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0) / SEG_TIMED)
    log(f"[segments] {nvidia_smi()}")
    log(f"[segments] cl_sia ms per round (host clock, synchronized, "
        f"{SEG_TIMED} rounds, median of {SEG_TURNS} alternating turns [min, "
        f"max]; n = {n}, q = {q} per segment): "
        + "; ".join(f"{key} {float(np.median(v)):.3f} [{min(v):.3f}, "
                    f"{max(v):.3f}]" for key, v in times.items()))
    profile_calls("segments cl_sia ring", cells["ring segments"], 1)
    profile_calls("segments cl_sia star", cells["star segments"], 1)
    profile_calls("segments cl_sia ring n = 28 x 2^18",
                  cells["ring segments, n = 28 x 2^18"], 1)
    log(f"[segments] phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches




# ---------------------------------------------------------------------------
# phase 11: the LM serving path
# ---------------------------------------------------------------------------

LM_CARD_CPU_TOL = 1e-3             # (a) SMOKE, f32: card = CPU, rtol = atol
LM_DECODE_TOL = 2e-2               # (a) decode = forward on the card
LM_RING_TOL = 3e-2                 # (a) mixtral's SWA ring past its window
LM_LAYER_TOL = 1e-4                # (c) one full-width f32 layer, card = CPU
BF16_REL_L2 = 5e-2                 # (b) bf16 decode = forward: ‖Δ‖₂/‖ref‖₂
BF16_MAX_ABS = 0.5                 # (b) and max |Δ| over the real vocab
# (b) mixtral in bf16: a token whose router input moves by a bf16 rounding
# can take another expert pair, and its logits then differ by O(0.3), so
# for an MoE this share of (request, step) pairs must be within the limits
MOE_PAIRS_OK = 0.95
F32_REL_L2 = 1e-4                  # (b) the same models in f32, every pair
PROFILE_STEPS = 3                  # decode steps under torch.profiler
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
SERVE_WARM = 2                     # decode steps left out of the median
# full-width models served: (arch, replace(FULL, **cut), why cut)
SERVE_MODELS = (
    ("phi4-mini-3.8b", {}, ""),
    ("mamba2-130m", {}, ""),
    ("mixtral-8x7b", dict(num_layers=2, capacity_factor=4.0),
     "num_layers 32 -> 2 (93.4 GB of bf16 weights > the card's 80 GB); "
     "capacity_factor 1.25 -> 4.0 (cap >= group: no token is dropped, so "
     "prefill's 1024-token groups, decode's 4-token groups and the "
     "teacher-forcing forward's 543-token groups compute one function)"),
)
LAYER_TOKENS = (2, 32)


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple:
    """(every element within ``tol + tol·|want|``, max |got − want|), on
    the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    return bool(torch.all(err <= tol + tol * want.abs())), float(err.max())


def lm_smoke_archs(dev) -> dict:
    """(a): every SMOKE arch in f32, card against CPU, decode = forward."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import model as lm
    from repro_torch.models.stubs import audio_stub_embeds, vision_stub_embeds
    from repro_torch.models.transformer import tree_leaves, tree_map

    cpu = torch.device("cpu")
    worst = {"card_cpu": 0.0, "decode_forward": 0.0, "ring": 0.0}

    def check(label, key, got, want, tol):
        ok, err = _close(got, want, tol)
        if not ok:
            raise SystemExit(f"FAIL [lm] {label}: max |Δ| {err:.3e} over "
                             f"rtol = atol = {tol}")
        worst[key] = max(worst[key], err)

    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(SEED)
        p_cpu = lm.init_params(cfg, gen, cpu)
        p_card = tree_map(lambda a: a.to(dev), p_cpu)
        b, s = 2, 12
        toks = torch.randint(0, cfg.vocab_size, (b, s),
                             generator=torch.Generator().manual_seed(2))
        fe = ()
        if cfg.frontend == "vision":
            fe = vision_stub_embeds(cfg, torch.Generator().manual_seed(3),
                                    b, s, 4, cpu)
        elif cfg.frontend == "audio":
            fe = (audio_stub_embeds(cfg, torch.Generator().manual_seed(3),
                                    b, s, cpu),)
        out = {}
        for where, p in (("cpu", p_cpu), ("card", p_card)):
            d = cpu if where == "cpu" else dev
            t = toks.to(d)
            with torch.inference_mode():
                lo_fe, aux = lm.forward(cfg, p, t, *(x.to(d) for x in fe))
                lo, _ = lm.forward(cfg, p, t)
                cache = lm.init_cache(cfg, b, 32, d)
                last, cache = lm.prefill(cfg, p, t[:, :-1], cache)
                step, cache = lm.decode_step(cfg, p, cache, t[:, -1], s - 1)
            if not all(bool(torch.isfinite(x[..., :cfg.vocab_size]).all())
                       for x in (lo_fe, lo, last, step)):
                raise SystemExit(f"FAIL [lm] {arch} {where}: logits not "
                                 f"finite")
            out[where] = dict(lo_fe=lo_fe, aux=aux, lo=lo, last=last,
                              step=step, cache=cache)
        for key in ("lo_fe", "aux", "lo", "last", "step"):
            check(f"{arch} {key} card = CPU", "card_cpu", out["card"][key],
                  out["cpu"][key], LM_CARD_CPU_TOL)
        for a, c in zip(tree_leaves(out["card"]["cache"]),
                        tree_leaves(out["cpu"]["cache"])):
            check(f"{arch} cache card = CPU", "card_cpu", a, c,
                  LM_CARD_CPU_TOL)
        card = out["card"]
        check(f"{arch} prefill = forward on the card", "decode_forward",
              card["last"], card["lo"][:, -2], LM_DECODE_TOL)
        check(f"{arch} decode = forward on the card", "decode_forward",
              card["step"], card["lo"][:, -1], LM_DECODE_TOL)

    # mixtral's SWA ring cache, 16 steps past its window (window 32)
    cfg = get_config("mixtral-8x7b", smoke=True)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), cpu)
    p_card = tree_map(lambda a: a.to(dev), p_cpu)
    total = 48
    toks = torch.randint(0, cfg.vocab_size, (1, total),
                         generator=torch.Generator().manual_seed(5))
    steps = {}
    for where, p in (("cpu", p_cpu), ("card", p_card)):
        d = cpu if where == "cpu" else dev
        t = toks.to(d)
        with torch.inference_mode():
            lo, _ = lm.forward(cfg, p, t)
            cache = lm.init_cache(cfg, 1, cfg.sliding_window, d)
            _, cache = lm.prefill(cfg, p, t[:, :32], cache)
            steps[where] = []
            for pos in range(32, total):
                step, cache = lm.decode_step(cfg, p, cache, t[:, pos], pos)
                steps[where].append(step)
                if pos + 1 < total and where == "card":
                    check(f"mixtral ring step {pos} = forward", "ring",
                          step, lo[:, pos], LM_RING_TOL)
    for pos, (a, c) in enumerate(zip(steps["card"], steps["cpu"]), 32):
        check(f"mixtral ring step {pos} card = CPU", "card_cpu", a, c,
              LM_CARD_CPU_TOL)
    log(f"[lm] (a) {len(ARCHS)} SMOKE archs in f32 (forward with and "
        f"without frontend stubs, aux, prefill, decode, caches): card = "
        f"CPU max |Δ| {worst['card_cpu']:.3e} (rtol = atol = "
        f"{LM_CARD_CPU_TOL}); decode and prefill = forward on the card "
        f"max |Δ| {worst['decode_forward']:.3e} (rtol = atol = "
        f"{LM_DECODE_TOL}); mixtral's ring 16 steps past its window max "
        f"|Δ| {worst['ring']:.3e} (rtol = atol = {LM_RING_TOL})")
    return worst


def lm_full_layers(dev) -> dict:
    """(c): one full-width layer per family in f32, card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer import tree_map

    cpu = torch.device("cpu")
    errs = {}
    for arch in ("phi4-mini-3.8b", "mixtral-8x7b", "mamba2-130m"):
        cfg = dataclasses.replace(get_config(arch), num_layers=1,
                                  param_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        init = (tr._mamba_layer_init if cfg.family == "ssm"
                else tr._dense_layer_init)
        p_card = init(gen, cfg, torch.float32, dev)
        p_cpu = tree_map(lambda a: a.cpu(), p_card)
        h = torch.randn((*LAYER_TOKENS, cfg.d_model),
                        generator=torch.Generator().manual_seed(4))
        outs = []
        for p, d in ((p_cpu, cpu), (p_card, dev)):
            with torch.inference_mode():
                if cfg.family == "ssm":
                    y, _ = tr._mamba_layer(cfg, p, h.to(d))
                else:
                    y, _, _ = tr._dense_layer(cfg, p, h.to(d))
            outs.append(y)
        ok, err = _close(outs[1], outs[0], LM_LAYER_TOL)
        if not ok or not bool(torch.isfinite(outs[1]).all()):
            raise SystemExit(f"FAIL [lm] one full-width {arch} layer: card "
                             f"and CPU differ by {err:.3e}")
        errs[arch] = err
        del p_card, p_cpu
    torch.cuda.empty_cache()
    log(f"[lm] (c) one full-width f32 layer, {LAYER_TOKENS[0]} x "
        f"{LAYER_TOKENS[1]} tokens, card = CPU (rtol = atol = "
        f"{LM_LAYER_TOL}): " + ", ".join(f"{a} max |Δ| {e:.3e}"
                                        for a, e in errs.items()))
    return errs


def teacher_forcing(cfg, params, prompts, out) -> tuple:
    """Each logits row of ``generate`` against the forward over the prompt
    and the generated tokens (one request at a time): relative L2 error and
    max |Δ| over the real vocabulary, [B, gen] each."""
    from repro_torch.models import model as lm
    full = torch.cat([prompts, out.tokens[:, :-1]], dim=1)
    s, v = prompts.shape[1], cfg.vocab_size
    rel = torch.zeros(full.shape[0], len(out.logits))
    mx = torch.zeros_like(rel)
    with torch.inference_mode():
        for i in range(full.shape[0]):
            tf, _ = lm.forward(cfg, params, full[i:i + 1])
            for j, lg in enumerate(out.logits):
                if not bool(torch.isfinite(lg[i]).all()):
                    raise SystemExit(f"FAIL [serve] {cfg.name}: logits not "
                                     f"finite at step {j}")
                want = tf[0, s - 1 + j, :v].float()
                got = lg[i, :v].float()
                rel[i, j] = float((got - want).norm() / want.norm())
                mx[i, j] = float((got - want).abs().max())
            del tf
    return rel, mx


def serve_once(cfg, dev, gen: int):
    """Random weights and prompts, then ``generate`` with its logits kept
    and held against teacher forcing."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as lm
    base = torch.cuda.memory_allocated(dev)
    params = lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    generate(cfg, params, prompts, 4, dev)               # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    out = generate(cfg, params, prompts, gen, dev, keep_logits=True)
    peak = torch.cuda.max_memory_allocated(dev)
    rel, mx = teacher_forcing(cfg, params, prompts, out)
    return params, prompts, out, (peak, base), rel, mx


def lm_serve_full(dev, card: str) -> list:
    """(b) and (d): full-width models through ``launch.serve.generate``,
    timed in bf16; the same models in f32 hold decode = teacher forcing to
    ``F32_REL_L2`` on every (request, step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.models.transformer import tree_leaves

    rows = []
    for arch, cut, why in SERVE_MODELS:
        cfg = dataclasses.replace(get_config(arch), **cut)
        f32 = dataclasses.replace(cfg, param_dtype="float32")
        torch.cuda.empty_cache()
        *_, rel32, _ = serve_once(f32, dev, SERVE_GEN)
        if float(rel32.max()) > F32_REL_L2:
            raise SystemExit(f"FAIL [serve] {cfg.name} in float32: decode "
                             f"against the teacher-forcing forward rel L2 "
                             f"{float(rel32.max()):.3e} (limit {F32_REL_L2})")
        torch.cuda.empty_cache()
        params, prompts, out, (peak, base), rel, mx = serve_once(
            cfg, dev, SERVE_GEN)
        ok = (rel <= BF16_REL_L2) & (mx <= BF16_MAX_ABS)
        share = float(ok.float().mean())
        if share < (MOE_PAIRS_OK if cfg.family == "moe" else 1.0):
            raise SystemExit(f"FAIL [serve] {cfg.name}: decode against the "
                             f"teacher-forcing forward within rel L2 "
                             f"{BF16_REL_L2} and max |Δ| {BF16_MAX_ABS} on "
                             f"{100 * share:.1f} % of (request, step) pairs; "
                             f"worst rel L2 {float(rel.max()):.3e}, max |Δ| "
                             f"{float(mx.max()):.3e}")
        w_bytes = sum(a.nbytes for a in tree_leaves(params))
        max_len = SERVE_PROMPT + SERVE_GEN
        c_bytes = sum(a.nbytes for a in tree_leaves(
            lm.cache_specs(cfg, SERVE_BATCH, max_len)))
        step_ms = 1e3 * statistics.median(out.seconds[1 + SERVE_WARM:])
        bound_ms = 1e3 * (w_bytes + c_bytes) / HBM_BYTES_PER_S
        # generate's first decode steps again, under the profiler
        cache = lm.init_cache(cfg, SERVE_BATCH, max_len, dev)
        with torch.inference_mode():
            lm.prefill(cfg, params, prompts, cache)

            def steps():
                for i in range(PROFILE_STEPS):
                    lm.decode_step(cfg, params, cache, out.tokens[:, i],
                                   SERVE_PROMPT + i)
            prof = profile_calls(f"{cfg.name} decode step", steps,
                                 PROFILE_STEPS)
        row = dict(arch=cfg.name, layers=cfg.num_layers, reduced=why or None,
                   params=cfg.param_count(), weight_bytes=w_bytes,
                   cache_bytes=c_bytes, prefill_ms=1e3 * out.seconds[0],
                   decode_ms=step_ms,
                   tokens_per_s=SERVE_BATCH * 1e3 / step_ms,
                   bound_ms=bound_ms, share_of_bound=bound_ms / step_ms,
                   peak_bytes=peak, peak_base_bytes=base,
                   rel_l2=float(rel.max()),
                   rel_l2_median=float(rel.median()),
                   max_abs=float(mx.max()), pairs_within=share,
                   pairs_outside=[[i, j] for i, j in
                                  (~ok).nonzero().tolist()],
                   f32_rel_l2=float(rel32.max()), profiled_ms=prof[0],
                   device_busy_ms=prof[1], device_ops=prof[2],
                   top_kernels=prof[3])
        log(f"[serve] {cfg.name} ({cfg.num_layers} layers"
            + (f"; reduced: {why}" if why else "") + f"): batch "
            f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_GEN} generated, "
            f"bf16; prefill {row['prefill_ms']:.2f} ms, decode "
            f"{step_ms:.3f} ms/step (median of {SERVE_GEN - 1 - SERVE_WARM}"
            f"), {row['tokens_per_s']:.1f} tok/s; weights "
            f"{w_bytes / 1e9:.3f} GB, cache {c_bytes / 1e6:.1f} MB, peak "
            f"{peak / 1e9:.3f} GB; bound {bound_ms:.3f} ms "
            f"({100 * row['share_of_bound']:.1f} % of it); decode = "
            f"teacher forcing rel L2 max {row['rel_l2']:.3e} (median "
            f"{row['rel_l2_median']:.3e}), max |Δ| {row['max_abs']:.3e}, "
            f"{100 * share:.1f} % of pairs within; f32 rel L2 max "
            f"{row['f32_rel_l2']:.3e}; {card}")
        log("[serve] " + json.dumps(row))
        rows.append(row)
        del params, out, cache
    torch.cuda.empty_cache()
    return rows


def serve_path() -> dict:
    """Phase 11: the LM serving path on the card."""
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    card = nvidia_smi()
    smoke = lm_smoke_archs(dev)
    layers = lm_full_layers(dev)
    rows = lm_serve_full(dev, card)
    log(f"[serve] phase 11: {time.perf_counter() - t_phase:.1f} s")
    return dict(smoke=smoke, layers=layers, served=rows)


# ---------------------------------------------------------------------------
# Phase 12: LM training on the card
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = {"dense": "codeqwen1.5-7b", "moe": "mixtral-8x7b",
                  "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b"}
TRAIN_HIST = dict(topq_impl="threshold", tau_impl="hist", hist_rounds=2)
# (label, mesh, kind, AggConfig keywords, topology, cohorts)
TRAIN_SMOKE = (
    ("cl_sia 4x1", (4, 1), "cl_sia", {}, None, 1),
    ("cl_sia 2x2", (2, 2), "cl_sia", {}, None, 1),
    ("cl_tc_sia hist 4x1", (4, 1), "cl_tc_sia", TRAIN_HIST, None, 1),
    ("cl_tc_sia hist 2x2", (2, 2), "cl_tc_sia", TRAIN_HIST, None, 1),
    ("cl_sia hierarchical 2x2x1", (2, 2, 1), "cl_sia", {}, "hierarchical",
     1),
    ("cl_sia cohorts=2 4x1", (4, 1), "cl_sia", {}, None, 2),
)
TRAIN_SMOKE_STEPS = 3
TRAIN_LOSS_RTOL = 1e-5             # (a) card = CPU: the loss
TRAIN_STATE_RTOL = 1e-3            # (a) the step's change of master and
                                   # params, of that change's own scale
TRAIN_TIE_GAP = 1e-5               # (a) a support swap must be a tie
TRAIN_OPT_RTOL = 1e-6              # (a) phase 3 on the card = the CPU
# (b) full width: phi4-mini at its published widths, depth cut for memory
TRAIN_FULL_ARCH = "phi4-mini-3.8b"
TRAIN_FULL_LAYERS = 2
TRAIN_FULL_MESH = (2, 2)
TRAIN_FULL_WHY = ("num_layers 32 -> 2: the f32 master and AdamW moments, "
                  "bf16 EF and gradient columns and the aggregation's "
                  "working set take about 75 bytes a parameter, and the "
                  "200,064 x 3,072 tied embedding alone is 0.61 B "
                  "parameters; with 4 layers (1.017 B) the run peaked at "
                  "73.3 GB (CL-SIA) and 78.9 GB (CL-TC-SIA), above the 72 "
                  "GB this phase allows itself, and as data 4 x model 1 it "
                  "ran out of the card's 80 GB; the 4 ranks are data 2 x "
                  "model 2")
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_FULL_STEPS = 5
TRAIN_WARM = 1                     # steps left out of the median
TRAIN_PROFILE_STEPS = 2
TRAIN_PEAK_LIMIT = 80e9
# (c) the CLI at full width
CLI_ARCH, CLI_MESH, CLI_STEPS, CLI_EVERY, CLI_RESUME = (
    "mamba2-130m", "4x1", 6, 3, 2)


def train_launches(step) -> dict:
    """Kernel launches of one train step, predicted from its plan: per
    model column (all tenants at once), one level step per level (Σ over
    stages for a nested plan), τ rounds per level under threshold Top-Q,
    and the TCS τ_G scan's ``count_ge`` rounds on each column's shard."""
    import _torch_launches

    cfg = step.agg_cfg
    out = _torch_launches.train_launches(step)
    if step.needs_tcs and cfg.tau_impl == "scan":
        out["count_ge"] = step.m * cfg.hist_rounds * step.cohorts
    return out


def launch_counts(level, topq_threshold) -> dict:
    """Every kernel's launch count (the level kernels and ``count_ge``)."""
    counts = {fn.__name__.replace("_cuda", ""): fn.launches
              for fn in level.KERNELS}
    counts["count_ge"] = topq_threshold.count_ge_cuda.launches
    return counts


def grown(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] - before[k]}


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def support_swaps(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(swapped coordinates, worst relative gap): ``ef == 0`` marks the
    transmitted support; per EF row the coordinates kept by one side alone
    must pair up with equal left-behind magnitudes (a tie at the Q-th
    magnitude); an unpaired difference is an infinite gap."""
    got = got.float().cpu().reshape(-1, got.shape[-1])
    want = want.float().cpu().reshape(-1, want.shape[-1])
    swaps, worst = 0, 0.0
    for k in range(got.shape[0]):
        a = want[k][(got[k] == 0) & (want[k] != 0)].abs().sort().values
        b = got[k][(want[k] == 0) & (got[k] != 0)].abs().sort().values
        if not (a.numel() or b.numel()):
            continue
        swaps += a.numel()
        worst = max(worst, math.inf if a.numel() != b.numel() else
                    float((a - b).abs().max() / a.max()))
    return swaps, worst


def train_close(card, cpu, rtol: float,
                keys=("master", "params")) -> tuple:
    """(within, max |card − cpu| over max |cpu|) of the named state
    fields: within means every element within rtol·|cpu| + rtol·max
    |cpu|."""
    from repro_torch.models.transformer import tree_leaves

    ok, worst = True, 0.0
    pairs = []
    for key in keys:
        a, b = getattr(card, key), getattr(cpu, key)
        if key == "opt":
            pairs += [(x, y) for x, y in zip(a[1:], b[1:]) if y is not None]
        elif isinstance(b, dict):
            pairs += list(zip(tree_leaves(a), tree_leaves(b)))
        else:
            pairs.append((a, b))
    for a, b in pairs:
        a, b = a.float().cpu(), b.float()
        scale = float(b.abs().max()) or 1.0
        err = (a - b).abs()
        ok &= not bool((err > rtol * b.abs() + rtol * scale).any())
        worst = max(worst, float(err.max()) / scale)
    return ok, worst


def loose_coordinates(step, old, card, cpu) -> dict:
    """Where the card step's update may rightly differ from the CPU's by
    up to a step, as bool tensors by key path (``.master`` and each
    ``.params/…`` leaf, flat coordinates mapped through the step's
    downlink): a support swap at a tie (``ef == 0`` differs in some
    client's EF row, or under AdamW the aggregate's support differs: the
    first moment left its decay ``b1·m`` on one side only, a tie at any
    stage of the plan), and under AdamW ``0 < √v̂ < 1e3·eps`` in the CPU's
    new second moment, where ``m̂ / (√v̂ + eps)`` turns a last-bit
    difference of a gradient near zero into a change of its own size."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    flat = ((card.ef.cpu() == 0) != (cpu.ef == 0)).any(dim=-2)
    opt = step.tc.opt
    if opt.name == "adamw":
        decayed = old.opt.m * torch.tensor(opt.b1, dtype=torch.float32)
        flat = flat | ((card.opt.m.cpu() != decayed)
                       != (cpu.opt.m != decayed))
        t = cpu.opt.step.double()
        t = t[:, None] if t.dim() else t
        v = cpu.opt.v.double()
        root = (v / (1 - opt.b2 ** t)).sqrt()
        flat = flat | ((v > 0) & (root < 1e3 * opt.eps))
    rows = flat.float().reshape(-1, flat.shape[-1])
    trees = [_flatten_with_paths(step.downlink(r)) for r in rows]
    out = {".master": flat}
    for i, (parts, _) in enumerate(trees[0]):
        leaves = [t[i][1] for t in trees]
        leaf = leaves[0] if flat.dim() == 1 else torch.stack(leaves)
        out["/".join((".params",) + parts)] = leaf != 0
    return out


def train_step_error(step, old, card, cpu, slack: float) -> float:
    """How far the card step's change of master and params (``card −
    old``) is from the CPU's (``cpu − old``): the largest ``|Δcard −
    Δcpu| / (|Δcpu| + max |Δcpu|)`` over every leaf, counting only
    coordinates where the difference exceeds ``2·eps_f32·|cpu|`` (the
    roundings of the two new values) and, at the coordinates of
    :func:`loose_coordinates`, ``slack``. A missing update or one of the
    wrong sign gives about 1 or more."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    def leaves(state):
        return {"/".join(p): x.detach().cpu().double()
                for p, x in _flatten_with_paths(state)
                if p[0] in (".master", ".params")}

    loose = loose_coordinates(step, old, card, cpu)
    o, a, b = leaves(old), leaves(card), leaves(cpu)
    worst = 0.0
    for key, want in b.items():
        d_card, d_cpu = a[key] - o[key], want - o[key]
        err = (d_card - d_cpu).abs()
        free = (2 * torch.finfo(torch.float32).eps * want.abs()
                + slack * loose[key])
        scale = d_cpu.abs() + d_cpu.abs().max()
        over = err > free
        if bool(over.any()):
            worst = max(worst, float((err[over] / scale[over].clamp(
                min=1e-300)).max()))
    return worst


def train_state_diff(a, b) -> list:
    """Key paths where two train states differ in any bit."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["structure"]
    return ["/".join(p) for (p, x), (_, y) in zip(la, lb)
            if not bitwise_equal(x.cpu(), y.cpu())]


def train_smoke(level, topq_threshold) -> dict:
    """(a): every SMOKE family, f32, on ranks of ``cuda:0`` against the
    same ranks on the CPU, each step from the CPU's state before it: the
    whole step on the card (its launches counted) to tolerances, and
    phases 2–3 on the card fed the CPU's gradient columns bit for bit (a
    comparison: its launches are taken back out of the counts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainConfig, build_train_step, init_state
    from repro_torch.train.state import state_to

    t0 = time.perf_counter()
    worst = dict(loss=0.0, state=0.0, swaps=0, gap=0.0, err_sq=0.0)
    runs = 0
    for family, arch in TRAIN_FAMILIES.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="float32")
        for label, shape, kind, agg, topo, coh in TRAIN_SMOKE:
            tc = TrainConfig(agg=AggConfig(kind=AggKind(kind), q=1, **agg),
                             q_frac=0.05, agg_dtype="float32",
                             ef_dtype="float32")
            axes = (("pod", "data", "model") if len(shape) == 3
                    else ("data", "model"))
            n = math.prod(shape)
            steps = {d: build_train_step(
                cfg, tc, make_mesh(shape, axes, [d] * n), topology=topo,
                cohorts=coh) for d in ("cpu", "cuda:0")}
            cpu_step, card_step = steps["cpu"], steps["cuda:0"]
            k_dp = cpu_step.k_dp
            st = init_state(cfg, tc, make_mesh(shape, axes, ["cpu"] * n),
                            torch.Generator().manual_seed(SEED),
                            topology=topo, cohorts=coh)
            gen = torch.Generator().manual_seed(SEED + 1)
            for s in range(TRAIN_SMOKE_STEPS):
                toks = torch.randint(0, cfg.vocab_size,
                                     ((coh,) if coh > 1 else ()) + (8, 16),
                                     generator=gen)
                part = [1.0] * k_dp
                part[-1] = 0.0 if s == 1 else 1.0
                batch = {"tokens": toks, "labels": toks.roll(-1, -1),
                         "participate": torch.tensor(part)}
                what = f"{family} {label} step {s}"
                # the whole step on the card, launches counted
                before = launch_counts(level, topq_threshold)
                card, mc = card_step(state_to(st, "cuda"),
                                     {k: v.cuda() for k, v in batch.items()})
                torch.cuda.synchronize()
                got = grown(before, launch_counts(level, topq_threshold))
                want = train_launches(card_step)
                if got != want:
                    raise SystemExit(f"FAIL [train] {what}: launches {got}, "
                                     f"predicted {want}")
                # the CPU step
                plain, w, p = cpu_step.round_inputs(batch)
                cols, loss = cpu_step.phase1(st, plain)
                new, m = cpu_step.finish(st, cols, loss, w, p)
                loss_rel = float(((mc["loss"].cpu() - m["loss"]).abs()
                                  / m["loss"].abs()).max())
                if loss_rel > TRAIN_LOSS_RTOL:
                    raise SystemExit(f"FAIL [train] {what}: loss rel "
                                     f"{loss_rel:.3e}")
                worst["loss"] = max(worst["loss"], loss_rel)
                if tc.agg.topq_impl == "exact":
                    # one function of the gradients up to ties: the same
                    # support but for tied swaps, the same bits
                    swaps, gap = support_swaps(card.ef, new.ef)
                    for a, b in zip(card.stage_ef or (), new.stage_ef or ()):
                        more, g = support_swaps(a, b)
                        swaps, gap = swaps + more, max(gap, g)
                    same = all(torch.equal(mc[k].cpu(), m[k])
                               for k in ("agg_bits", "agg_nnz"))
                    err = train_step_error(
                        cpu_step, st, card, new,
                        3 * tc.opt.lr * float(m["lr_scale"].max()))
                    if not (same and err <= TRAIN_STATE_RTOL
                            and gap <= TRAIN_TIE_GAP):
                        raise SystemExit(
                            f"FAIL [train] {what}: bits/nnz equal {same}, "
                            f"support swaps {swaps} with gap {gap:.3e}, "
                            f"the step's change of master/params off by "
                            f"{err:.3e} of its scale")
                    worst["state"] = max(worst["state"], err)
                    worst["swaps"] += swaps
                    worst["gap"] = max(worst["gap"], gap)
                # phases 2-3 on the card from the CPU's columns: phase 2's
                # outputs bit for bit, phase 3's elementwise optimizer to
                # TRAIN_OPT_RTOL (torch's CPU and CUDA kernels round its
                # float32 arithmetic apart in the last bits)
                counts = [fn.launches for fn in level.KERNELS]
                c_ge = topq_threshold.count_ge_cuda.launches
                card2, mc2 = card_step.finish(
                    state_to(st, "cuda"),
                    [[c.cuda() for c in row] for row in cols], loss.cuda(),
                    w, p)
                torch.cuda.synchronize()
                for fn, c in zip(level.KERNELS, counts):
                    fn.launches = c
                topq_threshold.count_ge_cuda.launches = c_ge
                diff = [k for k in train_state_diff(card2, new)
                        if k.split("/")[0] in (".ef", ".stage_ef",
                                               ".tcs_prev", ".step")]
                diff += [k for k in ("agg_bits", "agg_nnz")
                         if not bitwise_equal(mc2[k].cpu(), m[k])]
                e_rel = float(((mc2["agg_err_sq"].cpu() - m["agg_err_sq"])
                               .abs() / m["agg_err_sq"].abs().clamp(
                                   min=1e-30)).max())
                opt_ok, opt_err = train_close(card2, new, TRAIN_OPT_RTOL,
                                              keys=("master", "opt",
                                                    "params"))
                if diff or e_rel > 1e-6 or not opt_ok:
                    raise SystemExit(f"FAIL [train] {what}: phases 2-3 on "
                                     f"the card from the CPU's gradients "
                                     f"differ in {diff}, err_sq rel "
                                     f"{e_rel:.3e}, optimizer state "
                                     f"{opt_err:.3e} of scale")
                worst["opt"] = max(worst.get("opt", 0.0), opt_err)
                worst["err_sq"] = max(worst["err_sq"], e_rel)
                st = new
            runs += 1
    log(f"[train] (a) {runs} SMOKE runs (4 families x {len(TRAIN_SMOKE)} "
        f"forms: CL-SIA and CL-TC-SIA threshold hist on 4x1 and 2x2, the "
        f"hierarchical plan on 2x2x1, cohorts=2), f32, {TRAIN_SMOKE_STEPS} "
        f"steps each with a straggler in step 1, each from the CPU's state: "
        f"the whole step on the card = the CPU's, loss max rel "
        f"{worst['loss']:.3e} (limit {TRAIN_LOSS_RTOL}); exact Top-Q also "
        f"bits and nnz equal, {worst['swaps']} support coordinates swapped "
        f"at ties (gap {worst['gap']:.3e}), the step's change of "
        f"master/params = the CPU's to {worst['state']:.3e} of its scale "
        f"(limit {TRAIN_STATE_RTOL}; 3 optimizer steps of slack only where "
        f"a tie swapped the support or AdamW's sqrt(v_hat) < 1e3 eps); "
        f"phases 2-3 on the card "
        f"fed the CPU's gradients: EF, stage EF, tcs_prev, bits and nnz = "
        f"the CPU bit for bit, err_sq max rel {worst['err_sq']:.3e}, "
        f"master, moments and params max {worst.get('opt', 0.0):.3e} of "
        f"scale (limit {TRAIN_OPT_RTOL}); launches = the plan's "
        f"levels per column every step ({time.perf_counter() - t0:.1f} s)")
    return worst


def cl_sia_step_bits(step) -> tuple:
    """(§V closed form of one CL-SIA step, the same in the lowering's
    float32 order): every (rank, column) sends q (value, index) pairs in
    each of its K_dp ring levels; a lane's bits are fl((ω + ⌈log₂ seg⌉)·q),
    a rank adds its levels in order, the step sums ranks pairwise."""
    from repro_torch.agg.device import _slot_sum
    from repro_torch.core import comm_cost as cc

    k, m, seg, q = step.k_dp, step.m, step.seg, step.agg_cfg.q
    exact = k * m * cc.cl_sia_bits(k, seg, q, step.agg_cfg.omega)
    lane = (step.agg_cfg.omega + cc.idx_bits(seg)) * torch.tensor(
        float(q), dtype=torch.float32)
    acc = torch.zeros((), dtype=torch.float32)
    for _ in range(k):
        acc = acc + lane
    return exact, float(_slot_sum(acc.expand(k * m).clone()))


def time_phase2(step, log_ms: list):
    """Wrap ``step.aggregate`` so each call's time (a synchronize on both
    sides) lands in ``log_ms``."""
    inner = step.aggregate

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        log_ms.append(1e3 * (time.perf_counter() - t))
        return out

    step.aggregate = timed


def full_width_equals_plain(level, topq_threshold, step, state,
                            batch) -> dict:
    """Model column 0 of one full-width step's phase 2, on the step's own
    gradient columns, through the lowering twice on the card: with the
    kernels, and with their plain versions on the same inputs
    (``kernel_mode="ref"``, ``ref.ref_*_level``); the outputs, EF, bits
    and nnz bit for bit, ``err_sq`` to rel 1e-6. With the TCS mask,
    ``count_ge`` also against its plain version on the column's Δ at 64
    thresholds. These launches are comparisons: they are taken back out
    of the counts."""
    from repro_torch.agg.device import run_plan_segments_local
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import tree_leaves

    t0 = time.perf_counter()
    counts = [fn.launches for fn in level.KERNELS]
    c_ge = topq_threshold.count_ge_cuda.launches
    torch.cuda.reset_peak_memory_stats()
    plain, w, p = step.round_inputs(batch)
    cols, _ = step.phase1(state, plain)
    flat = [row[0] for row in cols]
    del cols
    n, k_dp = step.layout.n_local, step.k_dp
    ef = [state.ef[k, :n] for k in range(k_dp)]
    gm, what = None, f"{step.cfg.name} {step.agg_cfg.kind.value}"
    out = dict(lanes=[k_dp, step.seg], column=n)
    if step.needs_tcs:
        gm = [step.tcs_masks(state.params, state.tcs_prev)[0]] * k_dp
        delta = (step.layout.local_flatten(tree_leaves(state.params), 0,
                                           torch.float32)
                 - step.layout.local_flatten(tree_leaves(state.tcs_prev), 0,
                                             torch.float32))
        taus = (delta.abs().max() * torch.pow(2.0, -torch.linspace(
            0.0, 24.0, 64, device=delta.device))).float()
        got = topq_threshold.count_ge_cuda(delta, taus)
        want = ref.ref_count_ge(delta, taus)
        if not torch.equal(got, want):
            raise SystemExit(f"FAIL [train] {what}: count_ge on the column's "
                             f"Δ [{delta.numel()}] differs from its plain "
                             f"version")
        out["count_ge"] = dict(d=delta.numel(), taus=64,
                               nonzero_delta=int((delta != 0).sum()))
        del delta, got, want
    runs = [run_plan_segments_local(
        dataclasses.replace(step.agg_cfg, kernel_mode=mode), step.plan,
        step.col_meshes[0], flat, ef, w, global_mask=gm, participate=p,
        transport="static") for mode in ("auto", "ref")]
    torch.cuda.synchronize()
    kernel_runs = {fn.__name__.replace("_cuda", ""): fn.launches - c
                   for fn, c in zip(level.KERNELS, counts)
                   if fn.launches - c}
    for fn, c in zip(level.KERNELS, counts):
        fn.launches = c
    topq_threshold.count_ge_cuda.launches = c_ge
    same, rel = segments_equal(runs[0], runs[1], exact_err=False)
    if not same:
        raise SystemExit(f"FAIL [train] {what}: column 0's phase 2 through "
                         f"the kernels differs from their plain versions "
                         f"(err_sq rel {rel:.3e})")
    out.update(kernels=kernel_runs, err_sq_rel=rel,
               nnz=[float(s.nnz) for s in runs[0][2]],
               peak_bytes=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t0)
    log(f"[train] {what} at full width: column 0's phase 2 on lanes "
        f"[{k_dp}, {step.seg}] through {kernel_runs} = their plain versions "
        f"on the card bit for bit (outputs, EF, bits, nnz; err_sq rel "
        f"{rel:.3e}); "
        + (f"count_ge on the column's Δ [{n}] at 64 thresholds = its "
           f"plain version; " if step.needs_tcs else "")
        + f"peak {out['peak_bytes'] / 1e9:.3f} GB "
        f"({out['seconds']:.1f} s)")
    del runs, flat, ef, gm
    torch.cuda.empty_cache()
    return out


def train_full(level, topq_threshold, card: str) -> list:
    """(b) and (d): phi4-mini at full width, bf16, the launcher's
    TrainConfig defaults, random tokens; 5 CL-SIA (exact) steps, then 5
    CL-TC-SIA (threshold scan) steps from that state."""
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import tree_map
    from repro_torch.train import TrainConfig, build_train_step, init_state

    cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH),
                              num_layers=TRAIN_FULL_LAYERS)
    axes = ("data", "model")
    mesh = make_mesh(TRAIN_FULL_MESH, axes,
                     ["cuda:0"] * math.prod(TRAIN_FULL_MESH))
    tc = TrainConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(cfg, tc, mesh,
                       torch.Generator(device="cuda").manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, measured = [], {}
    for kind, agg in (("cl_sia", {}),
                      ("cl_tc_sia", dict(topq_impl="threshold"))):
        tc_k = dataclasses.replace(
            tc, agg=AggConfig(kind=AggKind(kind), q=1, **agg))
        step = build_train_step(cfg, tc_k, mesh)
        if step.needs_tcs and state.tcs_prev is None:
            state = state._replace(tcs_prev=tree_map(
                lambda p: p.to(step.agg_dt), state.params))
        phase2: list = []
        time_phase2(step, phase2)
        want = train_launches(step)
        exact, f32_bits = cl_sia_step_bits(step)
        ms, losses, bits = [], [], []

        def one(state):
            toks = torch.randint(0, cfg.vocab_size,
                                 (TRAIN_BATCH, TRAIN_SEQ + 1),
                                 generator=gen, device="cuda")
            return step(state, {"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]})

        for i in range(TRAIN_FULL_STEPS):
            before = launch_counts(level, topq_threshold)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = one(state)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            got = grown(before, launch_counts(level, topq_threshold))
            if got != want:
                raise SystemExit(f"FAIL [train] {cfg.name} {kind} step {i}: "
                                 f"launches {got}, predicted {want}")
            losses.append(float(m["loss"]))
            bits.append(float(m["agg_bits"]))
            if not math.isfinite(losses[-1]):
                raise SystemExit(f"FAIL [train] {cfg.name} {kind}: loss "
                                 f"{losses[-1]}")
            if kind == "cl_sia" and bits[-1] != f32_bits:
                raise SystemExit(f"FAIL [train] {cfg.name} CL-SIA bits "
                                 f"{bits[-1]} differ from the closed form "
                                 f"{f32_bits} (exact {exact})")
        # init and the timed steps (the profiled ones below keep a third
        # state alive: ``state`` still names the one they start from)
        steps_peak = torch.cuda.max_memory_allocated()
        holder = [state]

        def steps():
            for _ in range(TRAIN_PROFILE_STEPS):
                holder[0], _ = one(holder[0])

        prof = profile_calls(f"{cfg.name} {kind} train step", steps,
                             TRAIN_PROFILE_STEPS)
        state = holder[0]
        peak = torch.cuda.max_memory_allocated()
        step_ms = statistics.median(ms[TRAIN_WARM:])
        p2 = statistics.median(phase2[TRAIN_WARM:TRAIN_FULL_STEPS])
        row = dict(arch=cfg.name, layers=cfg.num_layers,
                   reduced=TRAIN_FULL_WHY, params=cfg.param_count(),
                   d_flat=step.layout.d_flat, mesh=list(TRAIN_FULL_MESH),
                   k_dp=step.k_dp, model_columns=step.m, kind=kind,
                   topq=step.agg_cfg.topq_impl, q_segment=step.agg_cfg.q,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
                   agg_bits=bits, closed_form_bits=exact,
                   closed_form_bits_f32=f32_bits, launches_per_step=want,
                   step_ms=step_ms, step_ms_all=ms, phase2_ms=p2,
                   phase2_share=p2 / step_ms, profiled_ms=prof[0],
                   device_busy_ms=prof[1], device_ops=prof[2],
                   top_kernels=prof[3], peak_bytes=peak,
                   peak_steps_bytes=steps_peak, peak_base_bytes=base)
        if peak >= TRAIN_PEAK_LIMIT:
            raise SystemExit(f"FAIL [train] {cfg.name}: peak "
                             f"{peak / 1e9:.2f} GB")
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen, device="cuda")
        row["equals_plain"] = full_width_equals_plain(
            level, topq_threshold, step, state,
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        torch.cuda.reset_peak_memory_stats()
        log(f"[train] (b) {cfg.name} ({cfg.num_layers} of 32 layers, "
            f"{cfg.param_count() / 1e9:.3f} B params, d_flat "
            f"{step.layout.d_flat}; reduced: {TRAIN_FULL_WHY}) {kind} "
            f"({step.agg_cfg.topq_impl}) on {step.k_dp}x{step.m} ranks of "
            f"cuda:0, bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
            f"{[round(x, 4) for x in losses]}, agg_bits {bits[-1]:.6e}"
            + (f" = closed form {f32_bits:.6e} (exact {exact:.6e}) every "
               f"step" if kind == "cl_sia" else "")
            + f"; launches/step {want}; step {step_ms:.2f} ms (median of "
            f"{TRAIN_FULL_STEPS - TRAIN_WARM}), phase 2 {p2:.2f} ms "
            f"({100 * p2 / step_ms:.1f} %); {prof[2]:.0f} device ops, "
            f"{prof[1]:.2f} ms busy per step; peak {peak / 1e9:.3f} GB; "
            f"{card}")
        log("[train] " + json.dumps(row))
        rows.append(row)
        del step
    del state
    torch.cuda.empty_cache()
    return rows, launch_counts(level, topq_threshold)


def train_cli(level, topq_threshold, card: str) -> dict:
    """(c) and (d): ``launch/train`` for mamba2-130m at full width, then a
    resume; the restored state = the saved arrays bit for bit; the same
    step timed and profiled in-process."""
    import io
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, build_train_step, init_state
    from repro_torch.train.state import abstract_like

    out_dir = Path("build") / "phase12_ckpt"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--arch", CLI_ARCH, "--mesh", CLI_MESH, "--device", "cuda:0",
            "--ckpt-dir", str(out_dir), "--ckpt-every", str(CLI_EVERY)]
    t0 = time.perf_counter()
    texts = []
    for steps in (CLI_STEPS, CLI_RESUME):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_cli_mod.main(argv + ["--steps", str(steps)])
        texts.append(buf.getvalue())
        for line in buf.getvalue().splitlines():
            log(f"[train] (c) cli: {line}")
    end = CLI_STEPS + CLI_RESUME
    if (f"resumed from step {CLI_STEPS}" not in texts[1]
            or f"checkpointed step {end}" not in texts[1]):
        raise SystemExit(f"FAIL [train] CLI resume: {texts[1][-500:]}")
    cfg = get_config(CLI_ARCH)
    mesh = make_mesh((4, 1), ("data", "model"), ["cuda:0"] * 4)
    tc = TrainConfig(opt=OptConfig(lr=3e-4))          # the CLI's defaults
    template = abstract_like(init_state(cfg, tc, mesh,
                                        torch.Generator(device="cuda")))
    restored = ckpt.restore(str(out_dir), template, step=CLI_STEPS,
                            device="cuda")
    saved = np.load(out_dir / f"step_{CLI_STEPS:08d}" / "leaves.npz")
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    leaves = _flatten_with_paths(restored)
    for i, (path, leaf) in enumerate(leaves):
        mine = leaf.float().cpu().numpy() if leaf.is_floating_point() \
            else leaf.cpu().numpy()
        if not np.array_equal(mine, saved[f"a{i}"]):
            raise SystemExit(f"FAIL [train] restored {'/'.join(path)} "
                             f"differs from the saved array")
    cli_s = time.perf_counter() - t0
    # the CLI's step, timed in-process on random tokens
    step = build_train_step(cfg, tc, mesh)
    phase2: list = []
    time_phase2(step, phase2)
    state = restored
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ms = []

    def one(state):
        toks = torch.randint(0, cfg.vocab_size, (8, 65), generator=gen,
                             device="cuda")
        return step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})

    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + 3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = one(state)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    holder = [state]

    def steps():
        holder[0], _ = one(holder[0])

    # one step: it is host-bound, about 4 s under the profiler
    prof = profile_calls(f"{cfg.name} CLI train step", steps, 1)
    step_ms = statistics.median(ms[1:])
    p2 = statistics.median(phase2[1:4])
    row = dict(arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
               d_flat=step.layout.d_flat, mesh=[4, 1], batch=8, seq=64,
               cli_seconds=cli_s, leaves_restored=len(leaves),
               step_ms=step_ms, phase2_ms=p2, phase2_share=p2 / step_ms,
               profiled_ms=prof[0], device_busy_ms=prof[1],
               device_ops=prof[2], top_kernels=prof[3],
               peak_bytes=torch.cuda.max_memory_allocated())
    toks = torch.randint(0, cfg.vocab_size, (8, 65), generator=gen,
                         device="cuda")
    row["equals_plain"] = full_width_equals_plain(
        level, topq_threshold, step, holder[0],
        {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    log(f"[train] (c) {cfg.name} ({cfg.num_layers} layers) via launch/train "
        f"--mesh {CLI_MESH} --device cuda:0: {CLI_STEPS} steps, checkpoint "
        f"every {CLI_EVERY}, resumed from step {CLI_STEPS} to {end}; the "
        f"restored state = the saved arrays bit for bit ({len(leaves)} "
        f"leaves); step {step_ms:.2f} ms, phase 2 {p2:.2f} ms "
        f"({100 * p2 / step_ms:.1f} %), {prof[2]:.0f} device ops, "
        f"{prof[1]:.2f} ms busy per step, peak "
        f"{row['peak_bytes'] / 1e9:.3f} GB ({cli_s:.1f} s; {card})")
    log("[train] " + json.dumps(row))
    del state, holder, restored
    torch.cuda.empty_cache()
    return row


def train_path(level, topq_threshold) -> dict:
    """Phase 12: the LM train step on the card. Every launch count is set
    to 0 before each of the phase's three drives and read after it."""
    t_phase = time.perf_counter()
    card = nvidia_smi()
    level.reset_launch_counts()
    train_smoke(level, topq_threshold)
    total = launch_counts(level, topq_threshold)
    level.reset_launch_counts()
    full, counts = train_full(level, topq_threshold, card)
    total = add_counts(total, counts)
    level.reset_launch_counts()
    train_cli(level, topq_threshold, card)
    total = add_counts(total, launch_counts(level, topq_threshold))
    log(f"[train] phase 12 launches: {total}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {k: v for k, v in total.items() if v}, full


# ---------------------------------------------------------------------------
# Phase 13: the dry run against the card
# ---------------------------------------------------------------------------
DRY_PEAK_RTOL = 0.01               # predicted device peak against measured
DRY_FIT_BYTES = 72e9               # a full cell runs here if predicted below
DRY_BUDGET_S = 60.0                # the phase stops starting cells past it
DRY_MUST_RUN = (("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"))
DRY_DIR = Path("build") / "phase13"


def start_predictions(cells: list) -> list:
    """(b)'s one-card predictions: one ``python -m repro_torch.launch.dryrun
    --arch … --shape … --mesh 1x1`` process per cell, all started at once,
    one thread each (a fake run takes seconds of CPU, about 100 µs an op,
    and no card: CUDA is hidden from them, so their ranks claim a fake
    ``cpu``)."""
    root = Path(__file__).resolve().parent
    out_dir = root / DRY_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(root / "src"))
    procs = []
    for arch, shape in cells:
        out = out_dir / f"{arch}_{shape}.json"
        out.unlink(missing_ok=True)
        with open(out.with_suffix(".log"), "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "1x1", "--out", str(out)],
                cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT), out))
    return procs


def stop_predictions(procs: list) -> None:
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def gather_predictions(procs: list) -> list:
    records = []
    for proc, out in procs:
        rc = proc.wait()
        if rc != 0 or not out.exists():
            raise SystemExit(f"FAIL [dryrun] the one-card prediction "
                             f"{out.name} exited {rc}; see "
                             f"{out.with_suffix('.log')}")
        records += json.loads(out.read_text())
    bad = [r for r in records if r["status"] != "ok"]
    if bad:
        raise SystemExit(f"FAIL [dryrun] {len(bad)} one-card cells failed "
                         f"their dry run: {bad[0]}")
    return records


def held_peak(what: str, predicted: int, measured: int) -> float:
    err = predicted / measured - 1
    if abs(err) > DRY_PEAK_RTOL:
        raise SystemExit(f"FAIL [dryrun] {what}: predicted device peak "
                         f"{predicted / 1e9:.4f} GB, measured "
                         f"{measured / 1e9:.4f} GB ({100 * err:+.2f} %, "
                         f"limit ±{100 * DRY_PEAK_RTOL:.0f} %)")
    return err


def run_full_cell(cfg, shape, dev) -> tuple:
    """One step of a full SHAPES cell on the card from seeded weights →
    (bytes it added at its peak, ms). Inputs are made before the peak is
    reset (their bytes stay in it); the step is timed between
    synchronizes."""
    from repro_torch.models import model as lm
    from repro_torch.models.stubs import audio_stub_embeds, vision_stub_embeds
    from repro_torch.train.step import build_prefill_step, build_serve_step
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train import TrainConfig, build_train_step, init_state
        mesh = make_mesh((1, 1), ("data", "model"), [dev])
        tc = TrainConfig()
        state = init_state(cfg, tc, mesh, gen)
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                             device=dev)
        args = (state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        fn = build_train_step(cfg, tc, mesh)
    else:
        params = lm.init_params(cfg, gen, dev)
        cache = lm.init_cache(cfg, b, s, dev)
        if shape.kind == "prefill":
            toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                 device=dev, dtype=torch.int32)
            extra = {}
            if cfg.frontend == "vision":
                extra = dict(zip(("frontend_embeds", "frontend_mask"),
                                 vision_stub_embeds(cfg, gen, b, s, s // 2,
                                                    dev)))
            elif cfg.frontend == "audio":
                extra = {"frontend_embeds": audio_stub_embeds(cfg, gen, b, s,
                                                              dev)}
            args = (params, cache, toks) + ((extra,) if extra else ())
            fn = build_prefill_step(cfg, None)
        else:
            tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                                device=dev, dtype=torch.int32)
            args = (params, cache, tok, s - 1)
            fn = build_serve_step(cfg, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    added = torch.cuda.max_memory_allocated(dev) - base
    del out, args
    torch.cuda.empty_cache()
    return added, ms


def dryrun_path(served: list, trained: list) -> list:
    """Phase 13: ``launch/dryrun.dry_run_cell`` predicts each cell's device
    peak on fake tensors; the card measures it. (a) phase 12's phi4 train
    cell and phase 11's served models, predicted here on their own meshes
    of ``cuda:0`` and held to the peaks those phases measured (less the
    bytes live before them); the gate must be tighter than the share of
    the train cell's peak that AdamW's second moment and the error
    feedback each take, or it would pass a prediction that left one out;
    (b) every full SHAPES cell whose arguments alone fit ``DRY_FIT_BYTES``
    on one card is predicted in a background process started here, and
    runs one step here if its predicted peak fits too, until the phase's
    budget runs out (``DRY_MUST_RUN`` always); (c) the cells predicted not
    to fit, with their predicted peaks or their arguments' bytes."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, shape_cells
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainConfig, init_state

    t_phase = time.perf_counter()
    card = nvidia_smi()
    dev = torch.device("cuda")
    one = make_mesh((1, 1), ("data", "model"), ["cuda:0"])
    cells = [(a, s) for a in ARCHS for s in shape_cells(get_config(a))]
    home = {(a, s): dryrun.home_bytes(get_config(a), SHAPES[s], one)
            for a, s in cells}
    procs = start_predictions([c for c in cells
                               if home[c] <= DRY_FIT_BYTES])
    try:
        rows = []
        # (a) the cells phases 11 and 12 ran
        cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH),
                                  num_layers=TRAIN_FULL_LAYERS)
        mesh = make_mesh(TRAIN_FULL_MESH, ("data", "model"),
                         ["cuda:0"] * math.prod(TRAIN_FULL_MESH))
        t = time.perf_counter()
        rec = dryrun.dry_run_cell(cfg, ShapeSpec("phase12", TRAIN_SEQ,
                                                 TRAIN_BATCH, "train"),
                                  mesh, TrainConfig())
        got = next(r for r in trained if r["kind"] == "cl_sia")
        measured = got["peak_steps_bytes"] - got["peak_base_bytes"]
        rows.append(dict(
            cell=f"{cfg.name} x {TRAIN_FULL_LAYERS} layers train "
            f"{TRAIN_BATCH}x{TRAIN_SEQ}, {TRAIN_FULL_MESH} ranks (phase 12, "
            f"CL-SIA)", predicted=rec["device_peak_bytes"],
            measured=measured, stand_ins=rec["stand_ins"],
            dry_run_s=time.perf_counter() - t,
            err=held_peak("phase 12's phi4 cell", rec["device_peak_bytes"],
                          measured)))
        state = init_state(cfg, TrainConfig(), make_mesh(
            TRAIN_FULL_MESH, ("data", "model"),
            ["meta"] * math.prod(TRAIN_FULL_MESH)), None)
        shares = {name: part.numel() * part.element_size() / measured
                  for name, part in (("AdamW's second moment", state.opt.v),
                                     ("the error feedback", state.ef))}
        for name, share in shares.items():
            if share <= DRY_PEAK_RTOL:
                raise SystemExit(
                    f"FAIL [dryrun] the gate ±{100 * DRY_PEAK_RTOL:.0f} % "
                    f"would pass a prediction without {name} "
                    f"({100 * share:.2f} % of the measured peak)")
        rows[-1]["omitted_shares"] = shares
        log("[dryrun] phase 12's cell: a prediction without "
            + " or without ".join(f"{n} would read {100 * v:.2f} % low"
                                  for n, v in shares.items())
            + f", outside the gate ±{100 * DRY_PEAK_RTOL:.0f} %")
        for (arch, cut, _), got in zip(SERVE_MODELS, served):
            cfg = dataclasses.replace(get_config(arch), **cut)
            t = time.perf_counter()
            pred = max(dryrun.dry_run_cell(cfg, ShapeSpec(
                kind, n, SERVE_BATCH, kind), one)["device_peak_bytes"]
                for kind, n in (("prefill", SERVE_PROMPT),
                                ("decode", SERVE_PROMPT + SERVE_GEN)))
            measured = got["peak_bytes"] - got["peak_base_bytes"]
            rows.append(dict(cell=f"{cfg.name} generate {SERVE_BATCH}x"
                             f"{SERVE_PROMPT}+{SERVE_GEN} (phase 11)",
                             predicted=pred, measured=measured,
                             dry_run_s=time.perf_counter() - t,
                             err=held_peak(f"phase 11's {cfg.name}", pred,
                                           measured)))
        # (b) the full SHAPES cells predicted to fit one card
        t = time.perf_counter()
        records = gather_predictions(procs)
        wait_s = time.perf_counter() - t
    finally:
        stop_predictions(procs)
    fits = sorted((r for r in records
                   if r["device_peak_bytes"] <= DRY_FIT_BYTES),
                  key=lambda r: ((r["arch"], r["shape"]) not in DRY_MUST_RUN,
                                 r["device_peak_bytes"]))
    skipped = []
    for r in fits:
        key = (r["arch"], r["shape"])
        if (time.perf_counter() - t_phase > DRY_BUDGET_S
                and key not in DRY_MUST_RUN):
            skipped.append(key)
            continue
        measured, ms = run_full_cell(get_config(r["arch"]),
                                     SHAPES[r["shape"]], dev)
        rows.append(dict(cell=f"{r['arch']} x {r['shape']} (full, one card)",
                         predicted=r["device_peak_bytes"], measured=measured,
                         step_ms=ms, err=held_peak(
                             f"{r['arch']} x {r['shape']}",
                             r["device_peak_bytes"], measured)))
    ran = {(r["arch"], r["shape"]) for r in fits} - set(skipped)
    missing = [k for k in DRY_MUST_RUN if k not in ran]
    if missing:
        raise SystemExit(f"FAIL [dryrun] {missing} predicted above "
                         f"{DRY_FIT_BYTES / 1e9:.0f} GB; they must run")
    for row in rows:
        log(f"[dryrun] {row['cell']}: predicted "
            f"{row['predicted'] / 1e9:.4f} GB, measured "
            f"{row['measured'] / 1e9:.4f} GB ({100 * row['err']:+.2f} %)"
            + (f", step {row['step_ms']:.2f} ms" if "step_ms" in row else "")
            + f"; {card}")
    # (c) the cells predicted not to fit
    over = sorted((r for r in records
                   if r["device_peak_bytes"] > DRY_FIT_BYTES),
                  key=lambda r: r["device_peak_bytes"])
    by_args = sorted((c for c in cells if home[c] > DRY_FIT_BYTES),
                     key=home.get)
    log(f"[dryrun] (c) {len(over) + len(by_args)} of {len(cells)} full "
        f"cells predicted above {DRY_FIT_BYTES / 1e9:.0f} GB on one card: "
        f"by their fake run, "
        + ", ".join(f"{r['arch']} x {r['shape']} "
                    f"{r['device_peak_bytes'] / 1e9:.1f} GB" for r in over)
        + "; by their arguments alone, "
        + ", ".join(f"{a} x {s} {home[a, s] / 1e9:.1f} GB"
                    for a, s in by_args))
    if skipped:
        log(f"[dryrun] not run (phase budget): {skipped}")
    log("[dryrun] " + json.dumps(dict(
        rows=rows, waited_for_predictions_s=wait_s,
        one_card=[{k: r[k] for k in ("arch", "shape", "device_peak_bytes",
                                     "port_home_bytes", "trace_s")}
                  for r in records],
        one_card_arguments_over=[
            {"arch": a, "shape": s, "port_home_bytes": home[a, s]}
            for a, s in by_args])))
    log(f"[dryrun] phase 13: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 14: the train state placed by rank on a mesh that mixes the card and
# the CPU
# ---------------------------------------------------------------------------
PLACE_ARCH = "mamba2-130m"
PLACE_CARD = "cuda:0"
PLACE_DEVICES = (PLACE_CARD, "cpu", "cpu", "cpu")    # data 4 x model 1
PLACE_LAYERS = 4
PLACE_WHY = ("num_layers 24 -> 4: with all 24 layers a step took 34.3-38.8 "
             "s (three clients' bf16 forward and backward and three ranks' "
             "exact Top-Q over 32 M-entry segments on the CPU), over the 30 "
             "s a step of this phase may take")
PLACE_BATCH, PLACE_SEQ = 8, 64     # the launcher's defaults
PLACE_STEPS = 3
PLACE_OPT_RTOL = 1e-6              # AdamW: the CPU ranks against the card


def placed_pieces_off(state, mesh, m_cols: int) -> list:
    """Leaves of a placed state with a piece (or a rank's param tree) off
    its rank's device."""
    from repro_torch.train.state import RankPieces, RankShards, state_leaves
    from repro_torch.train.step import param_places, rank_device

    bad = []
    leaves = {"master": state.master, "opt.m": state.opt.m,
              "opt.v": state.opt.v, "ef": state.ef}
    for i, e in enumerate(state.stage_ef or ()):
        leaves[f"stage_ef/{i}"] = e
    for name, leaf in leaves.items():
        if leaf is None:
            continue
        if not isinstance(leaf, RankPieces):
            bad.append(name)
            continue
        bad += [f"{name}[{r}]" for r, p in enumerate(leaf.pieces)
                if p.device != rank_device(mesh, *divmod(r, m_cols))]
    for name, tree in (("params", state.params),
                       ("tcs_prev", state.tcs_prev)):
        if tree is None:
            continue
        if not (isinstance(tree, RankShards) and list(
                zip(tree.devices, tree.cols)) == list(param_places(mesh))):
            bad.append(name)
            continue
        bad += [f"{name}@{d}" for d, t in zip(tree.devices, tree.trees)
                if {x.device for x in state_leaves(t)} != {d}]
    return bad


def placed_launches(step) -> dict:
    """``train_launches`` for the card's ranks of a mixed mesh: one level
    step per level and column for each distinct card among the column's
    ranks (the CPU ranks run the plain versions)."""
    cards = sum(len({d for d in cm.devices if d.type == "cuda"})
                for cm in step.col_meshes)
    return {k: v // step.m * cards for k, v in train_launches(step).items()
            if cards}


def place_path(level, topq_threshold, cfg=None) -> dict:
    """Phase 14 (``cfg``: the full-width model unless given); every launch
    count is set to 0 before the placed run and read after it (the
    all-card comparisons are taken back out)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, build_train_step, init_state
    from repro_torch.train.state import (abstract_like, gather_state,
                                         state_leaves, state_to)

    t_phase = time.perf_counter()
    card = nvidia_smi()
    if cfg is None:
        cfg = dataclasses.replace(get_config(PLACE_ARCH),
                                  num_layers=PLACE_LAYERS)
    dev = PLACE_CARD
    axes = ("data", "model")
    shape = (len(PLACE_DEVICES), 1)
    mixed = make_mesh(shape, axes, list(PLACE_DEVICES))
    one_card = make_mesh(shape, axes, [dev] * len(PLACE_DEVICES))
    adamw = TrainConfig(opt=OptConfig(lr=3e-4))       # the CLI's defaults
    t = time.perf_counter()
    pred = dryrun.dry_run_cell(
        cfg, ShapeSpec("phase14", PLACE_SEQ, PLACE_BATCH, "train"), mixed,
        adamw)
    dry_s = time.perf_counter() - t
    if pred["device"] != dev or not pred["fits_one_card"]:
        raise SystemExit(f"FAIL [place] the dry run's record: device "
                         f"{pred['device']}, fits {pred['fits_one_card']}")
    # a process's first GEMM allocates a workspace that stays: make it with
    # the SMOKE config's step, so the reading holds the phase's own bytes
    small = get_config(PLACE_ARCH, smoke=True)
    tokens = torch.zeros((8, 16), dtype=torch.int64, device=dev)
    build_train_step(small, adamw, one_card)(
        init_state(small, adamw, one_card, torch.Generator(device=dev)),
        {"tokens": tokens, "labels": tokens})
    level.reset_launch_counts()
    rows, total = [], {}
    gen = torch.Generator().manual_seed(SEED + 14)
    for name, tc in (("adamw", adamw),
                     ("sgd", dataclasses.replace(
                         adamw, opt=OptConfig(name="sgd", lr=3e-4)))):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        state = init_state(cfg, tc, mixed,
                           torch.Generator(device=dev).manual_seed(SEED))
        step = build_train_step(cfg, tc, mixed)
        check = build_train_step(cfg, tc, one_card)
        want = placed_launches(step)
        held = {}
        for t in state_leaves(state):
            held[str(t.device)] = (held.get(str(t.device), 0)
                                   + t.numel() * t.element_size())
        whole = sum(t.numel() * t.element_size() for t in state_leaves(
            gather_state(abstract_like(state), "meta")))
        ms, worst, peak = [], 0.0, None
        for s in range(PLACE_STEPS):
            off = placed_pieces_off(state, mixed, 1)
            if off:
                raise SystemExit(f"FAIL [place] {name} step {s}: pieces off "
                                 f"their ranks' devices: {off[:8]}")
            toks = torch.randint(0, cfg.vocab_size,
                                 (PLACE_BATCH, PLACE_SEQ + 1), generator=gen)
            batch = {"tokens": toks[:, :-1].to(dev),
                     "labels": toks[:, 1:].to(dev)}
            before = launch_counts(level, topq_threshold)
            torch.cuda.synchronize()
            if s == 0:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            plain, w, p = step.round_inputs(batch)
            cols, loss = step.phase1(state, plain)
            torch.cuda.synchronize()
            t_phase1 = time.perf_counter() - t
            # kept for the check, off the clock and off the card
            kept = [[c.to("cpu", copy=True) for c in row] for row in cols]
            old = gather_state(state, "cpu")
            t = time.perf_counter()
            new, m = step.finish(state, cols, loss, w, p)
            torch.cuda.synchronize()
            ms.append(1e3 * (t_phase1 + time.perf_counter() - t))
            del cols
            if s == 0:
                peak = torch.cuda.max_memory_allocated() - base
            got = grown(before, launch_counts(level, topq_threshold))
            if got != want:
                raise SystemExit(f"FAIL [place] {name} step {s}: launches "
                                 f"{got}, predicted {want}")
            total = add_counts(total, got)
            # the same phases 2-3 on ranks of the card (a comparison: its
            # launches are taken back out of the counts)
            counts = [fn.launches for fn in level.KERNELS]
            c_ge = topq_threshold.count_ge_cuda.launches
            ref, mr = check.finish(
                state_to(old, dev), [[c.to(dev) for c in row]
                                     for row in kept], loss.to(dev), w, p)
            torch.cuda.synchronize()
            for fn, c in zip(level.KERNELS, counts):
                fn.launches = c
            topq_threshold.count_ge_cuda.launches = c_ge
            ref = state_to(ref, "cpu")
            got_state = gather_state(new, "cpu")
            exact = (".ef", ".stage_ef", ".step") + (
                (".master", ".params", ".opt") if name == "sgd" else ())
            diff = [k for k in train_state_diff(got_state, ref)
                    if k.split("/")[0] in exact]
            diff += [k for k in ("agg_bits", "agg_nnz")
                     if not bitwise_equal(m[k].cpu(), mr[k].cpu())]
            ok, err = train_close(got_state, ref, PLACE_OPT_RTOL,
                                  keys=("master", "opt", "params"))
            if diff or not ok:
                raise SystemExit(f"FAIL [place] {name} step {s}: the placed "
                                 f"state against ranks of the card differs "
                                 f"in {diff}, master/moments/params "
                                 f"{err:.3e} of scale (limit "
                                 f"{PLACE_OPT_RTOL})")
            if not math.isfinite(float(m["loss"])):
                raise SystemExit(f"FAIL [place] {name}: loss {m['loss']}")
            worst = max(worst, err)
            state = new
            del old, ref, kept, got_state
        if placed_pieces_off(state, mixed, 1):
            raise SystemExit(f"FAIL [place] {name}: pieces off their ranks' "
                             f"devices after the steps")
        row = dict(opt=name, arch=cfg.name, layers=cfg.num_layers,
                   reduced=PLACE_WHY, params=cfg.param_count(),
                   d_flat=step.layout.d_flat, devices=list(PLACE_DEVICES),
                   batch=PLACE_BATCH, seq=PLACE_SEQ, step_ms_all=ms,
                   step_ms=statistics.median(ms[1:]), state_bytes=held,
                   whole_state_bytes=whole, launches_per_step=want,
                   opt_err=worst)
        if name == "adamw":
            row.update(peak_bytes=peak, predicted=pred["device_peak_bytes"],
                       err=held_peak(f"phase 14's first AdamW step on {dev}",
                                     pred["device_peak_bytes"], peak),
                       predicted_rank_peak=pred["rank_peak_bytes"],
                       predicted_rank_device=pred["rank_peak_device"],
                       dry_run_s=dry_s)
        log(f"[place] {cfg.name} ({cfg.num_layers} layers, d_flat "
            f"{step.layout.d_flat}), {name}, ranks {list(PLACE_DEVICES)}: "
            f"state on {dev} {held.get(dev, 0) / 1e9:.4f} GB of "
            f"{whole / 1e9:.4f} GB whole (cpu {held.get('cpu', 0) / 1e9:.4f} "
            f"GB); {PLACE_STEPS} steps = ranks of the card (EF, bits, nnz bit "
            f"for bit; master/moments/params "
            + ("bit for bit" if name == "sgd" else
               f"{worst:.3e} of scale, limit {PLACE_OPT_RTOL}")
            + f"); launches/step {want}; step {row['step_ms']:.1f} ms "
            f"(median of {PLACE_STEPS - 1} after the first, all "
            f"{[round(x, 1) for x in ms]})"
            + (f"; peak over step 0 {peak / 1e9:.4f} GB, predicted "
               f"{pred['device_peak_bytes'] / 1e9:.4f} GB "
               f"({100 * row['err']:+.2f} %)" if name == "adamw" else "")
            + f"; {card}")
        log("[place] " + json.dumps(row))
        rows.append(row)
        del state, step, check
    log(f"[place] phase 14 launches: {total}; the dry run {dry_s:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 15: tensor-parallel client compute over `model`
# ---------------------------------------------------------------------------
TP_KINDS = (("cl_sia", {}), ("cl_tc_sia", dict(topq_impl="threshold")))
TP_STEPS = 3                       # (a) timed steps per kind, after one
TP_GRAD_TOL = 2e-2                 # (a) bf16: a TP column against the
                                   # whole-model column, relative L2
TP_LOSS_TOL = 1e-2                 # (a) bf16: the TP loss, relative
TP_STEP_TOL = 5e-2                 # (a) bf16: the change fed TP columns
                                   # vs fed whole-model columns, relative
                                   # L2 off the support swaps
TP_SEQ_MESH = (2, 16)              # (c) 16 divides neither phi4's 24 q
                                   # heads nor its 8 kv heads; 512 % 16 = 0
TP_MIXED_DEVICES = ("cuda:0", "cpu", "cuda:0", "cpu")   # data 2 x model 2
TP_MIXED_MODELS = (("phi4-mini-3.8b",
                    dict(tie_embeddings=True, vocab_size=500)),
                   ("mamba2-130m", {}))
TP_MIXED_STEPS = 3
TP_MIXED_RTOL = 1e-6               # (b) f32: mixed mesh = all-card mesh, of
                                   # the step's scale


def flat_parts(step, old, new) -> dict:
    """What :func:`flat_step_error` reads of a new state, on the card:
    its master, its transmitted support (``ef == 0``), and under AdamW
    where its first moment left the decay ``b1·m`` and where ``√v̂`` is
    below 1e3·eps."""
    opt = step.tc.opt
    out = {"master": new.master, "ef0": new.ef == 0}
    if opt.name == "adamw":
        decayed = old.opt.m * torch.tensor(opt.b1, dtype=torch.float32)
        out["moved"] = new.opt.m != decayed
        root = (new.opt.v.double()
                / (1 - opt.b2 ** float(new.opt.step))).sqrt()
        out["small"] = (new.opt.v > 0) & (root < 1e3 * opt.eps)
    return out


def flat_step_error(old, a: dict, b: dict, slack: float) -> tuple:
    """Two steps from ``old`` (their :func:`flat_parts`) compared on the
    flat master (the params are its casts), where a and b agree on the
    support and AdamW's ``√v̂`` is not below 1e3·eps
    (``loose_coordinates``): (the relative L2 distance of their changes,
    ``‖Δa − Δb‖ / ‖Δb‖`` — a norm check, as bf16 asks; and
    ``assert_step_close``'s rule, the largest ``|Δa − Δb| / (|Δb| + max
    |Δb|)`` over the coordinates where the difference exceeds
    ``2·eps_f32·|b|`` and, at the loose ones, ``slack``). Chunked, in
    float64."""
    loose = (a["ef0"] != b["ef0"]).any(dim=0)
    if "moved" in b:
        loose |= (a["moved"] != b["moved"]) | b["small"]
    o = old.master
    top = float((b["master"].double() - o.double()).abs().max())
    worst, num, den = 0.0, 0.0, 0.0
    for lo in range(0, o.numel(), 1 << 26):
        sl = slice(lo, lo + (1 << 26))
        db = b["master"][sl].double() - o[sl].double()
        diff = (a["master"][sl].double() - o[sl].double()) - db
        err = diff.abs()
        num += float((diff * ~loose[sl]).square().sum())
        den += float(db.square().sum())
        free = (2 * torch.finfo(torch.float32).eps
                * b["master"][sl].double().abs() + slack * loose[sl])
        over = err > free
        if bool(over.any()):
            worst = max(worst, float((err[over] / (db.abs()[over] + top)
                                      .clamp(min=1e-300)).max()))
    return math.sqrt(num / max(den, 1e-300)), worst


def tp_against_whole(step, state, batch: dict, what: str, level,
                     topq_threshold) -> dict:
    """Each client's TP columns against its whole-model autograd gradient
    through ``local_flatten(·, m)`` (bf16 norm check, ``TP_GRAD_TOL``; the
    loss ``TP_LOSS_TOL``), and the step fed the TP columns against the same
    step fed the whole-model ones (``flat_step_error``: the change's
    relative L2 off the support swaps, ``TP_STEP_TOL``; ``assert_step_
    close``'s max rule logged). The comparisons' launches are taken back
    out."""
    counts = [fn.launches for fn in level.KERNELS]
    c_ge = topq_threshold.count_ge_cuda.launches
    plain, w, p = step.round_inputs(batch)
    tp_cols, whole_cols, tp_loss, whole_loss = [], [], [], []
    grad_err, loss_err = 0.0, 0.0
    for k in range(step.k_dp):
        c, loss_k = step.client_cols(state.params, plain, k)
        g, want_k = step.client_grad(state.params, plain, k)
        ref_k = [step.layout.local_flatten(g, m_, step.agg_dt)
                 for m_ in range(step.m)]
        del g
        for a_, b_ in zip(c, ref_k):
            grad_err = max(grad_err, float(
                (a_.float() - b_.float()).norm() / b_.float().norm()))
        loss_err = max(loss_err, abs(float(loss_k) / float(want_k) - 1))
        tp_cols.append(c)
        whole_cols.append(ref_k)
        tp_loss.append(loss_k)
        whole_loss.append(want_k)
    if grad_err > TP_GRAD_TOL or loss_err > TP_LOSS_TOL:
        raise SystemExit(f"FAIL [tp] {what}: TP columns {grad_err:.3e} "
                         f"(limit {TP_GRAD_TOL}), loss {loss_err:.3e} "
                         f"(limit {TP_LOSS_TOL}) from the whole-model "
                         f"client")
    parts = []
    for cols, losses in ((whole_cols, whole_loss), (tp_cols, tp_loss)):
        new, mt = step.finish(state, cols, step._mean_loss(losses), w, p)
        parts.append(flat_parts(step, state, new))
        del new
    del tp_cols, whole_cols
    step_err, step_max = flat_step_error(
        state, parts[1], parts[0], 3 * step.tc.opt.lr * float(
            mt["lr_scale"]))
    loose = int((parts[0]["ef0"] != parts[1]["ef0"]).any(dim=0).sum())
    del parts
    torch.cuda.synchronize()
    for fn, c in zip(level.KERNELS, counts):
        fn.launches = c
    topq_threshold.count_ge_cuda.launches = c_ge
    if step_err > TP_STEP_TOL:
        raise SystemExit(f"FAIL [tp] {what}: the step fed the TP columns is "
                         f"{step_err:.3e} (relative L2 of the change) from "
                         f"the step fed the whole-model columns (limit "
                         f"{TP_STEP_TOL})")
    return dict(grad_rel_l2=grad_err, loss_rel=loss_err,
                step_rel_l2=step_err, step_max_rule=step_max,
                support_differs=loose)


def tp_full(level, topq_threshold, card: str) -> tuple:
    """(a) phi4-mini at full widths on 2 x 2 ranks of ``cuda:0``: every
    leaf split over M = 2; steps timed with phase 1 apart, the peak held
    to the dry run's prediction (phase 13's gate), each client's TP
    columns against its whole-model columns through ``local_flatten(·,
    m)``, and the step fed the TP columns against the same step fed the
    whole-model ones. The comparisons' launches are taken back out."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.models.transformer import tree_map
    from repro_torch.train import TrainConfig, build_train_step, init_state

    cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH),
                              num_layers=TRAIN_FULL_LAYERS)
    mesh = make_mesh(TRAIN_FULL_MESH, ("data", "model"),
                     ["cuda:0"] * math.prod(TRAIN_FULL_MESH))
    tc = TrainConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen, device="cuda")
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(cfg, tc, mesh,
                       torch.Generator(device="cuda").manual_seed(SEED))
    rows, total = [], {}
    for kind, agg in TP_KINDS:
        tc_k = dataclasses.replace(
            tc, agg=AggConfig(kind=AggKind(kind), q=1, **agg))
        step = build_train_step(cfg, tc_k, mesh)
        what = f"{cfg.name} {kind}"
        # every leaf split but the norms' scales
        whole = [path[-1] for (path, _), plan in zip(
            _flatten_with_paths(model_mod.param_specs(cfg)),
            step.layout.plans) if plan.model_dim is None]
        if (step.phase1_form(batch()) != "tensor_parallel"
                or set(whole) - {"ln1", "ln2", "final_norm"}):
            raise SystemExit(f"FAIL [tp] {what}: phase 1 form "
                             f"{step.phase1_form(batch())}, replicated "
                             f"leaves {whole}")
        if step.needs_tcs and state.tcs_prev is None:
            state = state._replace(tcs_prev=tree_map(
                lambda p: p.to(step.agg_dt), state.params))
        want = train_launches(step)
        ms, p1 = [], []
        for i in range(1 + TP_STEPS):
            b = batch()
            before = launch_counts(level, topq_threshold)
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain, w, p = step.round_inputs(b)
            cols, loss = step.phase1(state, plain)
            torch.cuda.synchronize()
            p1.append(1e3 * (time.perf_counter() - t))
            state, m = step.finish(state, cols, loss, w, p)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            del cols
            got = grown(before, launch_counts(level, topq_threshold))
            if got != want:
                raise SystemExit(f"FAIL [tp] {what} step {i}: launches "
                                 f"{got}, predicted {want}")
            total = add_counts(total, got)
            if not math.isfinite(float(m["loss"])):
                raise SystemExit(f"FAIL [tp] {what}: loss {m['loss']}")
        row = dict(arch=cfg.name, layers=cfg.num_layers,
                   reduced=TRAIN_FULL_WHY, mesh=list(TRAIN_FULL_MESH),
                   kind=kind, topq=step.agg_cfg.topq_impl,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, form="tensor_parallel",
                   step_ms=statistics.median(ms[1:]), step_ms_all=ms,
                   phase1_ms=statistics.median(p1[1:]), phase1_ms_all=p1,
                   launches_per_step=want)
        if kind == "cl_sia":
            # init and the timed steps, as phase 13 reads phase 12's cell
            measured = torch.cuda.max_memory_allocated() - base
            t = time.perf_counter()
            pred = dryrun.dry_run_cell(
                cfg, ShapeSpec("phase15", TRAIN_SEQ, TRAIN_BATCH, "train"),
                mesh, tc_k)
            row.update(peak_bytes=measured,
                       predicted=pred["device_peak_bytes"],
                       dry_run_s=time.perf_counter() - t,
                       peak_err=held_peak("phase 15's phi4 TP cell",
                                          pred["device_peak_bytes"],
                                          measured))
        holder = [state]

        def one():
            holder[0], _ = step(holder[0], batch())

        prof = profile_calls(f"{what} TP train step", one, 1)
        state = holder[0]
        row.update(profiled_ms=prof[0], device_busy_ms=prof[1],
                   device_ops=prof[2], top_kernels=prof[3])
        row.update(tp_against_whole(step, state, batch(), what, level,
                                    topq_threshold))
        log("[tp] " + json.dumps(row))
        grad_err, loss_err = row["grad_rel_l2"], row["loss_rel"]
        step_err, step_max = row["step_rel_l2"], row["step_max_rule"]
        loose = row["support_differs"]
        log(f"[tp] (a) {what} ({cfg.num_layers} of 32 layers; reduced: "
            f"{TRAIN_FULL_WHY}) on {step.k_dp}x{step.m} ranks of cuda:0, "
            f"every leaf split over M = {step.m}, bf16, batch {TRAIN_BATCH} "
            f"x {TRAIN_SEQ}: step {row['step_ms']:.2f} ms, phase 1 "
            f"{row['phase1_ms']:.2f} ms (medians of {TP_STEPS}), "
            f"{prof[2]:.0f} device ops, {prof[1]:.2f} ms busy a step; "
            + (f"peak {row['peak_bytes'] / 1e9:.4f} GB, dry run "
               f"{row['predicted'] / 1e9:.4f} GB "
               f"({100 * row['peak_err']:+.2f} %); " if "peak_err" in row
               else "")
            + f"TP columns = whole-model columns to {grad_err:.3e} rel L2 "
            f"(limit {TP_GRAD_TOL}), loss {loss_err:.3e}; the step fed "
            f"either set: change {step_err:.3e} rel L2 apart off the "
            f"{loose} coordinates whose support differs (limit "
            f"{TP_STEP_TOL}; assert_step_close's max rule {step_max:.3e}); "
            f"launches/step {want}; {card}")
        rows.append(row)
        del step
    del state
    torch.cuda.empty_cache()
    return rows, total


def tp_seq(level, topq_threshold, card: str) -> tuple:
    """(c) phi4-mini at full widths on ``TP_SEQ_MESH`` ranks of ``cuda:0``:
    16 divides neither its 24 q heads nor its 8 kv heads, so each client's
    attention splits by query sequence (``attention.query_blocks``; rank m
    takes query rows ``[32m, 32m + 32)`` of 512). One CL-SIA step, its
    attention calls counted by the rank whose query block they take (all
    M ranks, equally; none whole); the card's peak over the init and the
    step held to ``dry_run_cell``'s prediction for the same mesh (±1 %);
    the fullest rank's peak estimate on one fake device a rank beside the
    same for the parent's form (``query_blocks`` → 1: the sub-layer whole
    on rank (k, 0)); the TP columns and the step fed them against the
    whole-model ones (``tp_against_whole``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.train import TrainConfig, build_train_step, init_state

    cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH),
                              num_layers=TRAIN_FULL_LAYERS)
    mesh = make_mesh(TP_SEQ_MESH, ("data", "model"),
                     ["cuda:0"] * math.prod(TP_SEQ_MESH))
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1))
    step = build_train_step(cfg, tc, mesh)
    m = step.m
    what = f"{cfg.name} cl_sia on {step.k_dp}x{m}"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen, device="cuda")
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    if step.phase1_form(batch()) != "tensor_parallel":
        raise SystemExit(f"FAIL [tp] (c) {what}: phase 1 form "
                         f"{step.phase1_form(batch())}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(cfg, tc, mesh,
                       torch.Generator(device="cuda").manual_seed(SEED))
    want = train_launches(step)
    rows = TRAIN_SEQ // m
    by_rank: dict = {}
    real = attention.plain_attention

    def counted(q, k, v, **kw):
        r = (kw.get("q_offset", 0) // rows if q.shape[1] == rows
             else "whole")
        by_rank[r] = by_rank.get(r, 0) + 1
        return real(q, k, v, **kw)

    attention.plain_attention = counted
    try:
        before = launch_counts(level, topq_threshold)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, mt = step(state, batch())
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t)
    finally:
        attention.plain_attention = real
    got = grown(before, launch_counts(level, topq_threshold))
    if got != want:
        raise SystemExit(f"FAIL [tp] (c) {what}: launches {got}, predicted "
                         f"{want}")
    if not math.isfinite(float(mt["loss"])):
        raise SystemExit(f"FAIL [tp] (c) {what}: loss {mt['loss']}")
    if set(by_rank) != set(range(m)) or len(set(by_rank.values())) != 1:
        raise SystemExit(f"FAIL [tp] (c) {what}: attention calls by query "
                         f"block {by_rank}, want each of the {m} ranks' "
                         f"blocks alike and none whole")
    measured = torch.cuda.max_memory_allocated() - base
    shape = ShapeSpec("phase15-seq", TRAIN_SEQ, TRAIN_BATCH, "train")
    t = time.perf_counter()
    pred = dryrun.dry_run_cell(cfg, shape, mesh, tc)
    peak_err = held_peak("phase 15's phi4 sequence-split cell",
                         pred["device_peak_bytes"], measured)
    per = dryrun.dry_run_cell(cfg, shape, dryrun.rank_mesh(mesh), tc)
    real_blocks = attention.query_blocks
    attention.query_blocks = lambda *a: 1
    try:
        parent = dryrun.dry_run_cell(cfg, shape, dryrun.rank_mesh(mesh), tc)
    finally:
        attention.query_blocks = real_blocks
    dry_s = time.perf_counter() - t
    row = dict(arch=cfg.name, layers=cfg.num_layers,
               reduced="num_layers 32 -> 2, as (a)", mesh=list(TP_SEQ_MESH), kind="cl_sia", batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, form="tensor_parallel, attention by query "
               "sequence", step_ms=step_ms, launches_per_step=want,
               attention_calls_by_rank={str(k): v for k, v in
                                        by_rank.items()},
               peak_bytes=measured, predicted=pred["device_peak_bytes"],
               peak_err=peak_err, dry_run_s=dry_s,
               rank_peak_bytes=per["rank_peak_bytes"],
               rank_peak_device=per["rank_peak_device"],
               rank_estimate=per["memory_analysis"]["peak_bytes_estimate"],
               parent_rank_peak_bytes=parent["rank_peak_bytes"],
               parent_rank_peak_device=parent["rank_peak_device"],
               parent_rank_estimate=parent["memory_analysis"][
                   "peak_bytes_estimate"])
    log(f"[tp] (c) {what}: the fullest rank ({per['rank_peak_device']}) "
        f"peaks at {per['rank_peak_bytes'] / 1e9:.4f} GB on one fake device "
        f"a rank (estimate {row['rank_estimate'] / 1e9:.4f} GB); the "
        f"parent's form (attention whole on rank (k, 0)): "
        f"{parent['rank_peak_bytes'] / 1e9:.4f} GB on "
        f"{parent['rank_peak_device']} (estimate "
        f"{row['parent_rank_estimate'] / 1e9:.4f} GB); dry runs "
        f"{dry_s:.1f} s")
    row.update(tp_against_whole(step, state, batch(), f"(c) {what}", level,
                                topq_threshold))
    log("[tp] " + json.dumps(row))
    log(f"[tp] (c) {what} ({cfg.num_layers} of 32 layers, as (a)) on "
        f"ranks of cuda:0, bf16, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: attention calls by rank's query block {by_rank}; "
        f"one step {step_ms:.2f} ms; card peak {measured / 1e9:.4f} GB, dry "
        f"run {row['predicted'] / 1e9:.4f} GB ({100 * peak_err:+.2f} %); "
        f"TP columns = whole-model columns to {row['grad_rel_l2']:.3e} rel "
        f"L2 (limit {TP_GRAD_TOL}), loss {row['loss_rel']:.3e}; the step "
        f"fed either set: change {row['step_rel_l2']:.3e} rel L2 apart "
        f"(limit {TP_STEP_TOL}); launches/step {want}; {card}")
    del state, step
    torch.cuda.empty_cache()
    return [row], got


def tp_mixed(level, topq_threshold, card: str) -> tuple:
    """(b) ranks ``cuda:0, cpu, cuda:0, cpu`` (data 2 x model 2): each
    client's two ranks on the card and the CPU, so the TP sums and the
    batch-over-model reduction cross devices; f32 SMOKE models, each step
    from the all-card step's state before it, held to the all-card step's
    change to ``TP_MIXED_RTOL`` of its scale. SGD, whose change is the
    aggregated gradient itself (AdamW's normalisation turns a last-bit
    difference of a near-cancelling first moment into 1.2e-6 of the
    change's scale: the first chip call of this phase)."""
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import (TrainConfig, build_train_step, init_state,
                                   state_shardings)
    from repro_torch.train.state import gather_state, state_to
    from repro_torch.train.step import place_state

    axes, shape = ("data", "model"), (2, 2)
    mixed = make_mesh(shape, axes, list(TP_MIXED_DEVICES))
    one_card = make_mesh(shape, axes, ["cuda:0"] * 4)
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1),
                     opt=OptConfig(name="sgd", lr=1e-2), q_frac=0.05,
                     agg_dtype="float32", ef_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 16)
    rows, total = [], {}
    for arch, over in TP_MIXED_MODELS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="float32", **over)
        step = build_train_step(cfg, tc, mixed)
        check = build_train_step(cfg, tc, one_card)
        specs = state_shardings(cfg, tc, mixed)
        want = placed_launches(step)
        state = init_state(cfg, tc, one_card,
                           torch.Generator(device="cuda").manual_seed(SEED))
        worst, loss_err = 0.0, 0.0
        for s in range(TP_MIXED_STEPS):
            toks = torch.randint(0, cfg.vocab_size, (8, 17), generator=gen)
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            form = step.phase1_form(b)
            if form != check.phase1_form(b) or form == "whole":
                raise SystemExit(f"FAIL [tp] (b) {cfg.name}: form {form}")
            old = state_to(state, "cpu")
            before = launch_counts(level, topq_threshold)
            new, m = step(place_state(old, mixed, specs),
                          {k: v.to("cuda:0") for k, v in b.items()})
            got = grown(before, launch_counts(level, topq_threshold))
            if got != want:
                raise SystemExit(f"FAIL [tp] (b) {cfg.name} step {s}: "
                                 f"launches {got}, predicted {want}")
            total = add_counts(total, got)
            counts = [fn.launches for fn in level.KERNELS]
            c_ge = topq_threshold.count_ge_cuda.launches
            state, mc = check(state, {k: v.to("cuda:0") for k, v in b.items()})
            torch.cuda.synchronize()
            for fn, c in zip(level.KERNELS, counts):
                fn.launches = c
            topq_threshold.count_ge_cuda.launches = c_ge
            err = train_step_error(check, old, gather_state(new, "cpu"),
                                   state_to(state, "cpu"),
                                   3 * tc.opt.lr * float(mc["lr_scale"]))
            loss_err = max(loss_err, abs(float(m["loss"]) / float(mc["loss"])
                                         - 1))
            worst = max(worst, err)
            if err > TP_MIXED_RTOL or loss_err > 1e-5:
                raise SystemExit(f"FAIL [tp] (b) {cfg.name} step {s}: the "
                                 f"mixed mesh is {err:.3e} of the step's "
                                 f"scale from the all-card mesh (limit "
                                 f"{TP_MIXED_RTOL}), loss {loss_err:.3e}")
        rows.append(dict(arch=cfg.name, devices=list(TP_MIXED_DEVICES),
                         form=form, steps=TP_MIXED_STEPS, step_err=worst,
                         loss_rel=loss_err, launches_per_step=want))
        log(f"[tp] (b) {cfg.name} SMOKE f32 SGD ({form}) on ranks "
            f"{list(TP_MIXED_DEVICES)}: {TP_MIXED_STEPS} steps = the "
            f"all-card steps to {worst:.3e} of the step's scale (limit "
            f"{TP_MIXED_RTOL}), loss {loss_err:.3e}; launches/step {want}; "
            f"{card}")
    return rows, total


def tp_path(level, topq_threshold) -> dict:
    """Phase 15: tensor-parallel client compute. Every launch count is set
    to 0 before each of the phase's three drives and read after it."""
    t_phase = time.perf_counter()
    card = nvidia_smi()
    level.reset_launch_counts()
    full, total = tp_full(level, topq_threshold, card)
    level.reset_launch_counts()
    seq, more = tp_seq(level, topq_threshold, card)
    total = add_counts(total, more)
    level.reset_launch_counts()
    mixed, more = tp_mixed(level, topq_threshold, card)
    total = add_counts(total, more)
    log("[tp] " + json.dumps(dict(full=full, seq=seq, mixed=mixed)))
    log(f"[tp] phase 15 launches: {total}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 16: serving split over ranks of the card
# ---------------------------------------------------------------------------

SPLIT_ARCH = "phi4-mini-3.8b"
# (name, mesh (data, model), batch, prompt, generated, the cache layout
# cache_pspecs gives phi4-mini's 24 heads and 8 kv heads there)
SPLIT_CASES = (
    ("a", (2, 2), 4, 512, 16,
     "requests over data, heads and kv heads over model"),
    ("b", (2, 2), 1, 2048, 8,
     "batch 1: the cache sequence over data (split-K), heads over model"),
    ("c", (1, 3), 4, 512, 8,
     "8 kv heads on 3 ranks: the cache sequence over model"),
)
SPLIT_F32_CASES = ("a",)           # also held in f32 (F32_REL_L2)
# SMOKE configs in f32, card = CPU: (arch, mesh, batch, prompt, generated)
SPLIT_SMOKE = (
    ("mixtral-8x7b", (2, 2), 2, 32, 20),    # the SWA ring, heads over model
    ("mixtral-8x7b", (1, 3), 1, 32, 20),    # the ring's slots over model
    ("zamba2-1.2b", (2, 2), 2, 16, 8),
)
SPLIT_SMOKE_TOL = LM_CARD_CPU_TOL
SPLIT_PROFILE_STEPS = 3


def split_run(cfg, mesh, params, prompts, tokens, gen: int) -> dict:
    """The split form on ``mesh`` fed the whole run's ``tokens`` [B, gen]
    (teacher forcing): the params placed by ``param_pspecs``, the cache by
    ``cache_pspecs``, a prefill and ``gen - 1`` decode steps, each ended
    by a synchronize and timed; logits kept on the CPU."""
    from repro_torch.models import serve_split
    b, s = prompts.shape
    sp = serve_split.ServeSplit(cfg, mesh, b, s + gen)
    placed = serve_split.place_params(params, cfg, mesh)
    logits, ms = [], []
    with torch.inference_mode():
        cache = sp.init_cache()
        for i in range(gen):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == 0:
                out, cache = sp.prefill(placed, cache, prompts)
            else:
                out, cache = sp.decode(placed, cache, tokens[:, i - 1],
                                       s + i - 1)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            logits.append(out.float().cpu())
    return dict(logits=logits, ms=ms, split=sp, params=placed, cache=cache)


def split_steps(cfg, mesh, placed, prompts, tokens, gen: int
                ) -> torch.Tensor:
    """The serving entry points on ``mesh`` (``build_prefill_step``,
    ``build_serve_step``, a cache placed by ``serve_split.init_cache``)
    fed the same teacher-forced ``tokens`` → their next tokens [B, gen] on
    the CPU."""
    from repro_torch.models import serve_split
    from repro_torch.train.step import build_prefill_step, build_serve_step
    b, s = prompts.shape
    prefill = build_prefill_step(cfg, mesh)
    decode = build_serve_step(cfg, mesh)
    cache = serve_split.init_cache(cfg, mesh, b, s + gen)
    tok, cache = prefill(placed, cache, prompts)
    out = [tok.cpu()]
    for i in range(1, gen):
        tok, cache = decode(placed, cache, tokens[:, i - 1], s + i - 1)
        out.append(tok.cpu())
    return torch.stack(out, 1)


def split_error(cfg, got: list, want: list) -> tuple:
    """Relative L2 and max |Δ| of each (request, step) over the real
    vocabulary, [B, gen] each."""
    v = cfg.vocab_size
    rel = torch.zeros(want[0].shape[0], len(want))
    mx = torch.zeros_like(rel)
    for j, (a, w) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            raise SystemExit(f"FAIL [split] {cfg.name}: logits not finite "
                             f"at step {j}")
        d = a[:, :v] - w.float().cpu()[:, :v]
        rel[:, j] = d.norm(dim=-1) / w.float().cpu()[:, :v].norm(dim=-1)
        mx[:, j] = d.abs().amax(-1)
    return rel, mx


def split_full(card: str) -> list:
    """phi4-mini at full width, all 32 layers, on the meshes of
    ``SPLIT_CASES`` of ``cuda:0``: each split run against
    ``launch.serve.generate``'s whole run (teacher forcing), bf16 within
    phase 11's limits on every (request, step), f32 (``SPLIT_F32_CASES``)
    within ``F32_REL_L2``; (a)'s peak against the dry run's prediction;
    prefill ms, decode ms per step and device ops beside the whole
    form's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as lm

    dev = torch.device("cuda")
    rows = []
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config(SPLIT_ARCH),
                                  param_dtype=dtype)
        torch.cuda.empty_cache()
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        for name, shape, batch, prompt, gen, layout in SPLIT_CASES:
            if dtype == "float32" and name not in SPLIT_F32_CASES:
                continue
            what = f"{cfg.name} ({name}) {dtype}"
            mesh = make_mesh(shape, ("data", "model"),
                             ["cuda:0"] * math.prod(shape))
            prompts = torch.randint(
                0, cfg.vocab_size, (batch, prompt),
                generator=torch.Generator(device=dev).manual_seed(16),
                device=dev)
            generate(cfg, params, prompts, 2, dev)       # warm-up
            whole = generate(cfg, params, prompts, gen, dev,
                             keep_logits=True)
            whole_logits = [x.float().cpu() for x in whole.logits]
            tokens = whole.tokens
            del whole.logits
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run = split_run(cfg, mesh, params, prompts, tokens, gen)
            peak = torch.cuda.max_memory_allocated() - base
            rel, mx = split_error(cfg, run["logits"], whole_logits)
            if dtype == "float32":
                ok = rel <= F32_REL_L2
            else:
                ok = (rel <= BF16_REL_L2) & (mx <= BF16_MAX_ABS)
            if not bool(ok.all()):
                raise SystemExit(
                    f"FAIL [split] {what}: split logits against the whole "
                    f"run's, worst rel L2 {float(rel.max()):.3e}, max |Δ| "
                    f"{float(mx.max()):.3e} ({int((~ok).sum())} of "
                    f"{ok.numel()} (request, step) pairs outside)")
            sp = run["split"]
            # the entry points give the split run's argmax at every step
            want_tok = torch.stack([x.argmax(-1) for x in run["logits"]], 1)
            del run["logits"]
            got_tok = split_steps(cfg, mesh, run["params"], prompts, tokens,
                                  gen)
            if got_tok.dtype != torch.int32 or \
                    not torch.equal(got_tok.long(), want_tok):
                raise SystemExit(
                    f"FAIL [split] {what}: build_prefill_step/"
                    f"build_serve_step gave {got_tok.dtype} tokens, "
                    f"{int((got_tok.long() != want_tok).sum())} of "
                    f"{want_tok.numel()} unlike the split run's argmax")
            row = dict(arch=cfg.name, case=name, dtype=dtype, layout=layout,
                       mesh=list(shape), batch=batch, prompt=prompt, gen=gen,
                       groups=sp.n_groups,
                       seq_blocks=len({b.s for b in sp.attn[0]}),
                       head_blocks=sp.head_blocks,
                       rel_l2=float(rel.max()), max_abs=float(mx.max()),
                       entry_tokens=want_tok.numel(),
                       prefill_ms=run["ms"][0],
                       decode_ms=statistics.median(run["ms"][2:]),
                       whole_prefill_ms=1e3 * whole.seconds[0],
                       whole_decode_ms=1e3 * statistics.median(
                           whole.seconds[2:]),
                       peak_bytes=peak)
            if name == "a" and dtype == "bfloat16":
                t = time.perf_counter()
                pred = max(dryrun.dry_run_cell(cfg, ShapeSpec(
                    kind, n, batch, kind), mesh)["device_peak_bytes"]
                    for kind, n in (("prefill", prompt),
                                    ("decode", prompt + gen)))
                row.update(predicted=pred,
                           dry_run_s=time.perf_counter() - t,
                           peak_err=held_peak("phase 16's split phi4 (a)",
                                              pred, peak))
                # device ops of a few split decode steps and of the whole
                # form's, under the profiler (the caches re-decode the
                # positions after the prompt)
                with torch.inference_mode():
                    prof = profile_calls(
                        f"{what} split decode step",
                        lambda: [sp.decode(run["params"], run["cache"],
                                           tokens[:, i], prompt + i)
                                 for i in range(SPLIT_PROFILE_STEPS)],
                        SPLIT_PROFILE_STEPS)
                    cache = lm.init_cache(cfg, batch, prompt + gen, dev)
                    lm.prefill(cfg, params, prompts, cache)
                    wprof = profile_calls(
                        f"{what} whole decode step",
                        lambda: [lm.decode_step(cfg, params, cache,
                                                tokens[:, i], prompt + i)
                                 for i in range(SPLIT_PROFILE_STEPS)],
                        SPLIT_PROFILE_STEPS)
                    del cache
                row.update(device_ops=prof[2], device_busy_ms=prof[1],
                           whole_device_ops=wprof[2],
                           whole_device_busy_ms=wprof[1])
            log(f"[split] {what} on {shape[0]} x {shape[1]} ranks of "
                f"cuda:0, batch {batch}, prompt {prompt}, {gen} generated "
                f"({layout}): {sp.n_groups} group(s), "
                f"{row['seq_blocks']} sequence x {sp.head_blocks} head "
                f"block(s) a group; split = whole rel L2 max "
                f"{row['rel_l2']:.3e}, max |Δ| {row['max_abs']:.3e}; the "
                f"entry points' tokens = its argmax ({row['entry_tokens']}); "
                f"prefill {row['prefill_ms']:.2f} ms (whole "
                f"{row['whole_prefill_ms']:.2f}), decode "
                f"{row['decode_ms']:.3f} ms/step (whole "
                f"{row['whole_decode_ms']:.3f}); peak "
                f"{peak / 1e9:.3f} GB"
                + (f", predicted {row['predicted'] / 1e9:.3f} GB "
                   f"({100 * row['peak_err']:+.2f} %); device ops/step "
                   f"{row['device_ops']:.0f} (whole "
                   f"{row['whole_device_ops']:.0f})"
                   if "predicted" in row else "") + f"; {card}")
            rows.append(row)
            del run, sp
        del params
    torch.cuda.empty_cache()
    return rows


def split_smoke() -> list:
    """SMOKE mixtral (its SWA ring, heads over model and the ring's slots
    over model) and zamba2 in f32: the split run on ranks of the card
    against the same split run on ranks of the CPU and against the whole
    run on the card (teacher forcing)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as lm
    from repro_torch.models.transformer import tree_map

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rows = []
    for arch, shape, batch, prompt, gen in SPLIT_SMOKE:
        cfg = get_config(arch, smoke=True)
        p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                               cpu)
        p_card = tree_map(lambda a: a.to(dev), p_cpu)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=torch.Generator().manual_seed(6))
        whole = generate(cfg, p_card, prompts.to(dev), gen, dev,
                         keep_logits=True)
        n = math.prod(shape)
        runs = {}
        for where, d, p in (("card", "cuda:0", p_card), ("cpu", "cpu", p_cpu)):
            mesh = make_mesh(shape, ("data", "model"), [d] * n)
            runs[where] = split_run(cfg, mesh, p, prompts.to(d),
                                    whole.tokens.to(d), gen)["logits"]
        worst = {"card_cpu": 0.0, "whole": 0.0}
        for j, (a, c, w) in enumerate(zip(runs["card"], runs["cpu"],
                                          whole.logits)):
            for key, want in (("card_cpu", c), ("whole", w.cpu())):
                ok, err = _close(a, want, SPLIT_SMOKE_TOL)
                if not ok:
                    raise SystemExit(f"FAIL [split] SMOKE {arch} on {shape}, "
                                     f"batch {batch}, step {j}: {key} max "
                                     f"|Δ| {err:.3e} (rtol = atol = "
                                     f"{SPLIT_SMOKE_TOL})")
                worst[key] = max(worst[key], err)
        rows.append(dict(arch=arch, mesh=list(shape), batch=batch,
                         prompt=prompt, gen=gen, **worst))
        log(f"[split] SMOKE {arch} f32 on {shape[0]} x {shape[1]} ranks, "
            f"batch {batch}, prompt {prompt}, {gen} generated: card = CPU "
            f"max |Δ| {worst['card_cpu']:.3e}, = the whole run on the card "
            f"max |Δ| {worst['whole']:.3e} (rtol = atol = "
            f"{SPLIT_SMOKE_TOL})")
    return rows


def split_path() -> dict:
    """Phase 16: serving split over ranks of the card."""
    t_phase = time.perf_counter()
    card = nvidia_smi()
    smoke = split_smoke()
    full = split_full(card)
    log("[split] " + json.dumps(dict(smoke=smoke, full=full)))
    log(f"[split] phase 16: {time.perf_counter() - t_phase:.1f} s")
    return dict(smoke=smoke, full=full)


def profile_rounds(sim, label: str, topology, rounds: int = 3):
    """Device busy time and device-op count over a few rounds."""
    sim.run(1, topology=topology)
    profile_calls(label, lambda: sim.run(rounds, seed=SEED,
                                         topology=topology), rounds)


def profile_calls(label: str, fn, rounds: int):
    """Device busy time and device-op count per round of ``fn`` (which
    runs ``rounds`` rounds), from torch.profiler (its own overhead inflates
    the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(getattr(e, "self_device_time_total", 0) or
                  getattr(e, "self_cuda_time_total", 0)
                  for e in events) / 1e3 / rounds
    ops = sum(e.count for e in events) / rounds
    top = sorted(events, key=lambda e: -(getattr(
        e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)))[:4]
    log(f"[profile] {label}: {wall_ms:.2f} ms/round under the profiler, "
        f"device busy {busy_ms:.3f} ms/round ({100 * busy_ms / wall_ms:.1f}"
        f"%), {ops:.0f} device ops/round; top: "
        + ", ".join(e.key[:40] for e in top))
    return wall_ms, busy_ms, ops, [
        (e.key[:60], (getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)) / 1e3 / rounds) for e in top]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    # the launch gates' predictions, kept apart from the port's dispatch
    sys.path.append(str(root / "tests"))
    from repro_torch.core import sparsify as sp
    from repro_torch.kernels import (chain_accum, level, ops, ref,
                                     sparsify_ef, topq_threshold)

    # full-f32 products on the card, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_log = level.build()
    log(f"[build] {level.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("[ptxas]", line.strip())

    scalar = {fn.__name__.replace("_cuda", ""): fn
              for fn in (chain_accum.chain_accum_cuda,
                         chain_accum.cl_fuse_cuda,
                         sparsify_ef.sparsify_ef_cuda,
                         topq_threshold.count_ge_cuda,
                         topq_threshold.count_ge_fused_cuda)}
    report = check_kernels(level, ref)
    report.update(check_tau_kernels(level, ref, sp))
    check_cohort_kernels(level, ref, sp, report)
    report.update(check_resident_kernels(level, ref, sp))
    report.update(check_scalar_kernels(scalar, ref))
    data = paper_data()
    launches = main_path(level, data)
    launches.update(threshold_path(level, data))
    launches.update(scalar_path(level, scalar))
    for name, n in tree_path(level, data).items():
        launches[name] += n
    for name, n in batched_path(level, data).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in nested_path(level, ref, sp, data).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in device_path(level, data).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in segments_path(level, sp, ops, topq_threshold,
                                 data).items():
        launches[name] = launches.get(name, 0) + n
    served = serve_path()["served"]
    trained, train_rows = train_path(level, topq_threshold)
    for name, n in trained.items():
        launches[name] = launches.get(name, 0) + n
    dryrun_path(served, train_rows)
    for name, n in place_path(level, topq_threshold).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in tp_path(level, topq_threshold).items():
        launches[name] = launches.get(name, 0) + n
    split_path()

    csrc = "src/repro_torch/kernels/csrc/"
    source = {"cl_fuse_level": "level.cu", "sparsify_ef_level": "level.cu",
              "chain_accum_level": "level.cu",
              "count_ge_fused_level": "tau_search.cu",
              "hist_topq_level": "tau_search.cu",
              "count_ge_level": "tau_search.cu",
              "cl_fuse_select_level": "resident.cu",
              "tau_search_fused_level": "resident.cu",
              "ia_fuse_select_level": "resident.cu",
              "chain_accum": "chain_accum.cu", "cl_fuse": "chain_accum.cu",
              "sparsify_ef": "sparsify_ef.cu",
              "count_ge": "topq_threshold.cu",
              "count_ge_fused": "topq_threshold.cu"}
    replaces = {"cl_fuse_level": "src/repro/kernels/level.py:395",
                "sparsify_ef_level": "src/repro/kernels/level.py:197",
                "chain_accum_level": "src/repro/kernels/level.py:282",
                "count_ge_fused_level": "src/repro/kernels/level.py:561",
                "hist_topq_level": "src/repro/kernels/level.py:684",
                "count_ge_level": "src/repro/kernels/level.py:481",
                "cl_fuse_select_level": "src/repro/kernels/level.py:395",
                "tau_search_fused_level": "src/repro/kernels/level.py:561",
                "ia_fuse_select_level":
                    "src/repro/kernels/level.py:197 and :282",
                "chain_accum": "src/repro/kernels/chain_accum.py:74",
                "cl_fuse": "src/repro/kernels/chain_accum.py:102",
                "sparsify_ef": "src/repro/kernels/sparsify_ef.py:70",
                "count_ge": "src/repro/kernels/topq_threshold.py:79",
                "count_ge_fused": "src/repro/kernels/topq_threshold.py:157"}
    kernels = []
    for name, r in report.items():
        # the large float32 shape (a scalar kernel's last shape is bf16)
        large = [x for x in r["shapes"] if x.get("dtype") != "bfloat16"
                 and "cohorts" not in x][-1]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + source[name],
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=large["ms"],
            plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
            bound_by=large.get("bound_by", "bytes"), library_ms=None,
            max_abs_err_plain_on_card=r["max_abs_err_plain_on_card"],
            variants_checked=r["checked"], shapes=r["shapes"],
            **({"cohort_variants": r["cohort_variants"]}
               if "cohort_variants" in r else {})))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
