"""Chip smoke test for the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device — requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles the kernels of the six TPU kernels from
   ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one process a
   source, in parallel) and prints ``ptxas``'s registers, shared memory
   and spills per kernel;
3. kernels vs plain — every kernel against its plain PyTorch version on
   the card, at every shape the slice gives it and at the cohort scale of
   the ``fl_decode_agg`` table (flat update 2^20, ``ChunkedAEConfig(256,
   (32,), 8)``, cohort 256), with times, bounds and the library call. The
   grouped decode→aggregate is also held bucket by bucket against the
   per-bucket kernel (bit-equal) and timed beside it, at run (d)'s shapes,
   a ragged round and the cohort point of the ``fl_partition`` table.
   Flash attention (kernel 6) runs at run (f)'s shape (bf16, causal,
   beside ``scaled_dot_product_attention`` as the library call), at a
   window and a full, kv-padded shape, and in float32 at head dim 64.
   The chunked AE's four layers at 4096 chunks a client and run (h)'s
   server hidden layer run in float32, and so do the client and server
   shapes of runs (i), (j), (k), (n), (o), (q) and (t) (and (q)'s
   attention in bf16). Kernel 6 runs natively at MLA's heads (40 × q/k
   96, v 64, bf16, causal) at run (r)'s prefill and run (t)'s evaluate,
   and at phi-3's (32 × 96) at run (y)'s prefill, beside
   ``scaled_dot_product_attention`` (the kernels PyTorch picked named) and
   the padded route those calls took until the kernel had the pairs (q,
   k and v zero-padded to 128, ``padded_ms``), timed in the same run; its
   padded route stays held at a head dim it has no instantiation for
   (192, padded to 256). Kernel 6's whole argument
   list: ``softcap`` 50 at run (f)'s shape (SDPA has no softcap, so no
   library call there), a chunked prefill (Sq 256 at the end of Skv
   1,024, ``q_offset`` 768) causal and in a 512 window, both in float32
   at D 64 on the FMA kernel, and ``extra_qk`` at minicpm3-4b's
   decomposed MLA scores (40 heads, nope 64 + rope 32 against a shared
   ``k_rope``, v 64, 4 x 1,024: natively at (64 + 32, 64), the
   concatenation's copies timed apart, beside the padded route's time).
   Kernels 1 and 2 also run at 2^30 values (rows of 1024).
   Every kernel has routes, named in every row as ``kernel_route``:
   kernel 1 ``rows`` (16-byte loads of a row held in registers) and
   kernel 2 ``stream`` (a flat stream of 4-code words, float4 stores) on
   aligned inputs, each ``generic`` (a warp a row) on a block or pointer
   they do not take, with the block size and grid as ``plan``; their rows
   in the ``kernels`` line carry launches by route for runs (a), (o) and
   (q); ``fused_dense`` ``narrow`` at K <=
   32, else ``splitk`` at M <= 16, else ``mma`` (bf16) or ``sgemm``
   (float32); the decode→aggregate kernels per bucket ``few_rows`` at
   M_b <= 16 and K <= 512, else ``bands`` (a mixed round at K 512, N 4096
   runs both in one launch); flash attention in bf16 ``wgmma``, in float32
   ``fma`` (every head-dim pair it instantiates: D = Dv, and MLA's 96 over
   64), and ``wgmma_padded``/``fma_padded`` for head dims it pads. ``fused_dense``'s ``library_ms`` is ``torch.addmm(b, x, w)``
   at every shape, which leaves out a relu, tanh or sigmoid; kernel 4's is
   ``torch.einsum("c,cmk,kn->mn", w, h, W)``, without the bias
   (``library_call`` says so). ``ms``, ``plain_ms``, ``library_ms`` and
   ``per_bucket_ms`` are device times (calls captured in a CUDA graph and
   replayed); ``host_ms`` is the time per call of the wrapper called back
   to back from Python;
4. slice — the paper's pipeline through the port's entry points on
   ``cuda`` with the MNIST MLP at full width: (a) SyncFedAvg, 3 clients,
   q8, update payload + error feedback, 2 rounds; (b) ``run_prepass``
   with ``MNIST_AE`` then an FC-AE run; (c) a kernel-path
   ``ChunkedAECompressor`` run at the default ``ChunkedAEConfig()``;
   (d) a partitioned cohort (dense0 on two chunked-AE rungs, dense1 on
   q8/q4) and (e) a flat mixed cohort (two chunked-AE rungs, q8, q4), both
   with ``use_grouped_kernel=True``. Runs (a), (c), (d) and (e) are
   repeated on the CPU and compared; (d) and (e) also against the same run
   with the grouped round off. Launch counters are zeroed just before each
   run and read just after;
5. LM serving — the dense GQA model zoo through ``prefill`` and
   ``decode_step``: (f) deepseek-coder-33b at full width (d_model 7168, 56
   query heads over 8 KV heads, d_ff 19,200, vocab 32,256), 8 of its 62
   layers (cut from 16 to keep the script's time), its own dtypes
   (float32 parameters, bf16 compute), weights drawn on the card from a
   seed; 4 prompts of 1,024 tokens from
   ``synthetic_lm_batch``, then 16 greedy decode steps; flash attention
   must launch once a layer in prefill and never in decode; one more
   prefill then holds each layer's kernel-6 call against the plain version
   at the model's own inputs. (g) the same architecture at 2 layers in
   float32 compute, on the card and on the CPU from the same weights (1
   prompt of 128 tokens, 4 decode steps, the CPU fed the card's tokens):
   logits and cache within ``atol=1e-4, rtol=1e-3``; and a prefill in
   bf16 compute on both, within twice the CPU's own bf16-vs-float32
   error;
6. cohort round — (h) one chunked-AE server round at the full point of
   the ``fl_decode_agg`` table (a 2^20-value update, ``ChunkedAEConfig(256,
   (32,), 8)``, 64 clients): each client's ``codec.encode`` (two
   ``fused_dense`` launches), then ``stack_payloads`` and
   ``decode_and_aggregate`` (one ``fused_dense`` over the cohort, one
   kernel-4 launch); latents and the mean update held against the same
   calls on the CPU in the golden band, the launch counts checked, the
   round's wall time on a line of its own. The kernels record carries
   these counts as ``launches_run_h``.
7. scalable runtime — (i) ``SampledSync`` over the paper's CIFAR CNN at
   full width (550,586 parameters): 1,000 clients of 64 ``cifar_like``
   images, a cohort of 100 trained in one vmapped pass a step, 2 rounds of
   1 local epoch, update payload with error feedback through
   ``ComposedCompressor(ChunkedAECompressor(ChunkedAEConfig(),
   use_kernel=True), bits=8)`` (kernels 1–4 on the path: the server's
   latent dequantize, hidden layer and kernel-4 reduce); bytes, vmap
   rounds and launches checked, round times on the host clock; a reduced
   copy (16 clients, cohort 4) on the card and the CPU in the golden
   band. (j) ``AsyncBuffered`` over the MNIST MLP at
   ``PAPER_SCALE_SCENARIO`` (1,000 clients, K 50, a 10 % straggler tail),
   3 rounds, ``ChainCompressor((TopK 1 %, q8))`` (the scatter route),
   both event engines, which must agree bit for bit; a reduced copy at
   ``SMOKE_SCALE_SCENARIO`` on the card and the CPU (arrival traces
   exact, parameters in the golden band); the scatter route called twice
   on the card (``torch.equal``) and beside one ``index_add_`` over the
   whole cohort. The kernels record carries the runs' counts as
   ``launches_run_i`` and ``launches_run_j``. Run (p), part 1: run (j)
   with ``soa_state=True`` (a struct-of-arrays ``ClientPool``) on the
   vector engine, twice, in turns with the eager runs (heap, vector, SoA,
   vector, SoA, heap), each ``torch.equal`` to the first heap run
   (traces, bytes, metrics, parameters); host seconds a round of each
   printed, and round 1 of an eager and of an SoA run under ``cProfile``
   in turns, twice (the round, the calls into ``core/soa.py``, the
   garbage collector, the costliest functions).
   Run (j) then crosses a
   checkpoint: saved after round 1 with one engine, restored into the
   other, round 2 must be ``torch.equal`` to the uninterrupted run, its
   downlink bytes equal;
8. lifecycle and resume — (k) ``SyncFedAvg`` over the CIFAR CNN at full
   width, 8 clients of 64 images, run (i)'s composed kernel-path chunked
   AE on one shared params object, ``AELifecycle(refresh_every=2,
   drift_ratio=1.5, buffer_size=4, min_snapshots=2, refresh_epochs=5)``,
   6 rounds: round 0 ships the 8 initial decoders, the cadence refits at
   rounds 2 and 4 in one ``train_autoencoder_cohort`` dispatch each; the
   server reduces on kernel 4 until the first refit takes effect, then
   decodes client by client (each client has its own decoder). Per round
   its host time, launches, routes, syncs and refits; the refit's time on
   its own; ``savings.reconcile`` against the records. The run is played
   twice (``torch.equal``: the card's run-to-run determinism, cuDNN's
   deterministic algorithms on), then saved after round 3, loaded into a
   fresh run and played on: parameters, residuals, codec params, snapshot
   rings and records equal the uninterrupted run's. A reduced copy (2
   clients, 3 rounds, a refit at round 1) on the card and the CPU in the
   golden band. The kernels record carries the counts as
   ``launches_run_k``. Run (p), part 2: run (k) again with
   ``soa_state=True`` (the snapshot rings in the pool's ring buffers),
   ``torch.equal`` to the eager run in every tensor, scalar and record;
   then resumed after round 3 SoA -> SoA, an eager checkpoint into a run
   built with ``soa_state=True`` and an SoA checkpoint into an eager one
   (the checkpoint's layout decides), each ``torch.equal`` to the
   uninterrupted run. The kernels record carries the SoA runs' counts as
   ``launches_run_p``;
9. the paper's §5.2 federation — (l) ``color_imbalance_split(0, 256)``
   (collaborator 1 grayscale), each collaborator's pre-pass (5 epochs,
   then a 6-epoch fit of the paper's CIFAR FC AE at full width, 550,586 →
   320, 352.9 M parameters) and its own ``FCAECompressor``, payload
   "weights", ``AELifecycle(refresh_every=2, drift_ratio=2.0,
   buffer_size=4, min_snapshots=2, refresh_epochs=6)``, 4 rounds; uplink,
   decoder-ship bytes and ``savings.reconcile`` printed; played twice,
   then saved after round 1 and resumed, held as (k);
10. k-means and entropy — ``KMeansSpec(550,586, k=16, iters=8)`` on the
   card against the CPU (codebook in the golden band, codes equal away
   from midpoints, a second card call ``torch.equal``), and the measured
   bytes of an entropy-coded TopK → k-means chain equal on both;
11. the rate-control frontier — (m) ``benchmarks/tables.py:524-620`` at
   its FULL sizes: the MNIST MLP, 4 Dirichlet(0.5) clients of
   ``mnist_like(0, 1024)``, a 24-epoch pre-pass a client, ``fc_ae_ladder``
   of latents (8, 32, 128) behind a 128-wide hidden layer, each rung's AE
   trained 300 epochs on the card; 6 rounds x 2 local epochs, payload
   "weights", under ``FixedRate`` at each rung, ``DistortionTarget(0.15)``,
   ``ByteBudget`` and ``RDBudget`` at the matched budget 4 x 32 x 4 B, and
   ``RDBudget`` under ``AsyncBuffered(buffer_k=2, distortion_power=1)``.
   Each row runs on the card and on the CPU from the same ladder:
   switches, rung occupancy, ``bytes_up`` and ``bytes_decoder`` exact
   (where they differ, the probe values and the policy's thresholds at
   that round are printed), loss, accuracy and parameters in the golden
   band; accuracy, bytes, switches and λ printed a row. No kernel runs;
12. a per-partition ladder on kernel 5 — (n) ``SyncFedAvg`` over the
   CIFAR CNN, 8 clients of 64 images, 3 rounds x 1 epoch (6 until PR
   23, whose runs (z)-(ab) needed the time: the round-3 refit took ~59 s
   a play, three plays), payload
   "weights", ``use_grouped_kernel=True``; ``by_layer_partition`` into
   ``dense0`` (461,088 values: a kernel-path chunked AE (256, (32,)) at
   latent 4, at latent 8, then q8; each AE fitted once on the card and
   shared by all 8 clients, ``prefit``: latent 4 on the 256-chunks of a
   pre-pass weights dataset's dense0 segments, latent 8 on those of what
   the lanes send in a 2-round warm-up on the cheapest rungs) and ``rest``
   (89,498 values: q4, q8), under ``RDBudget(cooldown=2, min_snapshots=2,
   refit_epochs=1, refit_batch=4)`` at the budget halfway between the
   all-cheapest and all-dearest plans. Per round its launches by kernel
   and route, the buckets of each kernel-5 launch, the probes' launches
   and errors, switches and bytes; kernel 5 must launch once a round
   until the first switch-time refit, which must buy latent 8, ship the
   refit decoders and move the refit lanes' bucket to the batched-params
   route (every round's kernel-5 buckets are the lanes sharing a
   decoder); a rerun and a resume (saved after round 1) ``torch.equal``;
   a reduced copy (2 clients, 3 rounds) on the card and the CPU, the CPU
   encoding the card's trained local models in place of its own:
   payloads, global params a round, loss, accuracy and the controllers'
   state in the golden band, the local models too but where both
   devices' single Adam step is partial (a gradient at rounding level),
   codes, decisions and bytes exact; beside it the free-running
   trajectories' divergence, card against CPU and CPU against CPU from
   initial params one ulp apart. The
   kernels record carries the counts as ``launches_run_n``;
13. the serve loop — (o) ``benchmarks/tables.py:905-953`` at FULL through
   ``core/serve.py``'s ``run_serve``: N = 10^6 clients, jitter 0.4, a 5 %
   straggler tail, seed 0, one warm-up round; q8 over 2^16 values (block
   256) at cohorts 256 (3 timed rounds) and 4,096 (2), q8 over 2^10
   values (block 2^10) at 65,536 (2), the chunked AE ``(256, (32,), 8)``
   over 2^16 values on the kernel path at 256 (3), and the CIFAR CNN's
   550,586 values through run (i)'s composed kernel-path chunked AE at N
   1,000, K 100 (3). Each row: rounds, bytes a second and microseconds a
   round, the median and range of three ``run_serve`` calls that each
   time at least 1 s of rounds; the FULL rounds one at a time — a round's
   host time
   against its device time (CUDA events), its kernel launches (equal
   every round, and across the q8 rows' cohorts), allocated memory
   (equal after every round: two preallocated state generations), the
   reference's invariants (``tests/test_serve.py:28-53``); the two
   final states ``torch.equal``; one more round traced with
   ``torch.profiler`` (device kernels, idle share). Kernels 2, 3 and 4
   launch; the record carries the counts as ``launches_run_o``. Then the
   step at ``serve_q8_c256``'s and ``serve_ae_c256``'s shapes on the card
   and on the CPU for 3 rounds, both seams fed identical numpy draws:
   times, seqs and versions exact, the clock and ``global_flat`` in the
   golden band;
14. ``LMDeltaTask`` at full width — (q) stablelm-1.6b (d_model 2048, 32
   heads, d_ff 5,632, vocab 100,352, untied LM head), 2 of 24 layers (cut
   from 6, which drops most of its checkpoint's time) with remat on (the
   config's), float32 parameters, bf16 compute, 513,822,720 parameters
   drawn on the card; 2 clients of 8 sequences of 512 tokens, batch 4,
   update payload with error feedback, ``freeze_roles=("embedding",)``, a
   ``by_role_partition`` ``PartitionedCompressor`` (``mlp`` on a shared
   kernel-path chunked AE ``(256, (32,), 8)``, the rest q8 at block 256):
   ``SyncFedAvg`` 2 rounds, then ``SampledSync(cohort=2)`` with
   ``soa_state=True`` 2 rounds and its resume through a checkpoint
   (``torch.equal``). The embedding group's codes all zero and its
   decoded rows and means exactly zero, frozen leaves unchanged, uplink
   bytes the groups' wire bytes, evaluation finite, kernels 1, 2, 3, 4 and
   6 launched (kernel 6 once a layer an evaluate); parameter count and
   peak memory printed. A reduced copy (the config's narrow widths,
   float32) on the card and the CPU, the CPU encoding the card's local
   models against the card's round-start model: codes exact, the rest in
   the golden band. The record carries the counts as
   ``launches_run_q``;
15. MLA serving — (r) minicpm3-4b at full width (d_model 2560, 40 heads,
   q_lora 768, kv_lora 256, heads of nope 64 + rope 32 over a value head
   of 64, d_ff 6,400, vocab 73,448, tied embeddings), 16 of its 62
   layers (1,190,889,984 parameters; cut from 62 to keep the script's
   time), its own dtypes; 4 prompts of 1,024 tokens,
   16 greedy decode steps; kernel 6 once a layer in prefill at (96, 64)
   natively (``wgmma``, no padded launch), never in decode (the
   absorbed-matrix decode is plain torch, as the reference's); one more
   prefill holds each layer's call against the plain version at the
   model's own inputs; the
   latent cache's bytes beside a GQA cache of the same heads. Its 2-layer
   copy on the card and the CPU as run (g) (``c_kv``/``k_rope`` caches).
   The record carries the count as ``launches_run_r``;
16. MoE serving — (s) dbrx-132b (16 experts top-4, capacity 1.25, float32
   parameters) at 2 of 40 layers and llama4-maverick (128 experts top-1
   and a shared expert, bfloat16 parameters, drawn an expert slab at a
   time) at 1 of 48, each 4 x 1,024-token prompts and 16 decode steps,
   kernel 6 once a layer in prefill; the router's counters a layer (top-k
   assignments dropped by capacity, load-balance and z-loss terms). A
   reduced copy of each on the card and the CPU: logits and caches in the
   golden band, every dispatch mask equal;
17. MLA training with remat — (t) ``LMDeltaTask`` on minicpm3-4b at full
   width, 8 of 62 layers (689,490,432 parameters), remat on,
   ``FLConfig(optimizer="adamw")``, run (q)'s data and codec plan, 2
   ``SyncFedAvg`` rounds (kernels 1–4, and kernel 6 natively, ``wgmma``,
   once a layer an evaluate); then one local step with remat on and off
   from the trained model, deterministic algorithms on: ``torch.equal``,
   both peaks printed. The record carries the counts as
   ``launches_run_t``;
18. an MoE training step — (u) dbrx-132b at full width, 1 of 40 layers
   (4,492,234,752 parameters), remat on, 2 x 512 tokens: ``train_loss``
   under autograd, then ``make_optimizer("sgdm", lr, grad_clip=1.0)``'s
   update in place (parameters, gradients and momentum: three copies of
   the model); the loss and ``moe_aux`` finite, the peak printed;
19. SSM, hybrid, audio and VLM serving, every layer at full width and the
   config's own dtypes, weights drawn on the card from a seed, 16 greedy
   decode steps after the prefill (prefill s, decode-step median, peak
   memory, cache bytes, kernel-6 launches and routes a prefill; decode
   launches nothing and leaves the cache's bytes as they were):
   (v) mamba2-2.7b, 64 layers, 4 x 1,024 tokens — no kernel (the SSD scan
   is plain torch, as the reference's is jnp); layer 0's chunked-scan
   outputs, final SSD state and conv tail in float32 against the
   recurrence stepped token by token. (w) recurrentgemma-9b, 38 layers
   (12 (R, R, A) groups and a 2-layer tail, 10,444,984,320 float32
   parameters), 2 x 4,096 tokens, so the 2,048 window binds and the ring
   caches wrap — kernel 6 12 times at head dim 256 in window mode
   (``wgmma``). (x) whisper-medium, 24 + 24 layers, 4 x 1,500 frames and
   a 4 x 448-token decoder prompt — kernel 6 72 times: 24 full over the
   frames, 24 causal, 24 full cross calls of 448 queries over 1,500
   frames. (y) phi-3-vision-4.2b, 32 layers, 4 x 1,024 tokens of which
   the first 576 are image embeddings drawn from the seed — kernel 6 32
   times at head dim 96 natively (``wgmma``). One more prefill holds every
   kernel-6 call against the plain version and checks each call's mode
   and shapes. Each family's reduced config on the card and the CPU from
   the same weights (2 x 80 tokens, 3 decode steps, the CPU fed the
   card's tokens): logits and every cache leaf in the golden band. The
   record carries the counts as ``launches_run_v`` to ``launches_run_y``
   and kernel 6's rows at these runs' shapes (phase 3: D 256 window,
   whisper's encoder, decoder and cross calls, phi-3's heads of 96,
   each beside SDPA with the same mask);
20. the pod-axis FL round and the sharded server paths, on a one-rank
   NCCL group (a gloo group beside it for CPU tensors): (z)
   ``build_fl_round_step`` on stablelm-1.6b at full width, all 24 layers
   (float32 parameters, bf16 compute, remat, ``adamw``), ``DEFAULT_AE``
   (4096 -> 512 -> 8), 4 x 1,024 tokens a round, 3 rounds: loss and host s
   a round, the peak of ``max_memory_allocated`` (the need reckoned from
   the tree checked first against what earlier phases hold), the latent
   bytes all-reduced a round against the gradient bytes (equal to
   ``compressed_fraction``), one more round under ``torch.profiler``
   (device idle share, device ms by ``fl_round.*`` phase); its reduced
   config's round on the card and the CPU (the LM band). (ab)
   ``decode_and_aggregate_sharded`` at run (h)'s cohort (64 clients, 2^20
   values, the kernel-path chunked AE, through kernels 3 and 4) and run
   (o)'s q8 K 4,096, and 3 ``run_serve`` rounds at ``serve_q8_c256``'s
   shape with ``ServeConfig(shard=True)``, their launches counted alone;
   then each against the unsharded call on the card, the two serves'
   rounds a second as run (o)'s (median of three windows of at least
   1 s). Then two processes share the card over gloo
   (``repro_torch.launch.local.spawn``; a child's failure fails the
   script): each repeats (ab) over the two-rank group, and (aa) runs the FL
   round on stablelm-1.6b at full width, 2 of 24 layers, each rank on its
   half of a 4 x 1,024-token batch, 2 rounds; rank 0 then composes the
   same two rounds in one process (each half's latents, their mean,
   decode, the optimizer's step) and holds the pods' params to it in the
   golden band, reporting whether the bits are equal. The record carries
   the one-rank (ab)'s counts of its sharded calls as ``launches_run_ab``;
21. the example entry points — (ac) each of ``repro_torch.examples``'
   ten modules on the card, in process, at the README's command line
   (``main(argv)``; ``fl_serve`` at ``--n-clients 1000000 --buffer-k
   4096``, and again at ``--spec q4 --shard --rounds 5`` over a one-rank
   NCCL group; ``fl_color_imbalance`` also with ``--stacks``), and the two
   LM examples at full width through their factored functions:
   ``llm_serve_decode.serve`` on llama3-8b, all 32 layers, float32
   parameters (8,030,261,248, drawn on the card), the example's 4 x 32
   prompt and 16 tokens, kernel 6 once a layer; ``llm_federated.federate``
   on stablelm-1.6b at full width, 2 of 24 layers (as run (q)), cut to 2
   clients, 2 rounds of 1 local epoch and pre-pass AE fits of 4 epochs
   on the first 1,024 chunk rows of each role. ``llm_federated`` at the
   README's size is cut to its reduced twin (the CPU tests' sizes): its
   pre-pass and refit AE fits took 216 s on the card. Launch counters are
   zeroed before each call and read after it: every kernel the example's
   path has (``AC_KERNELS``) must have launched. Each call of the ten
   examples (the §5.2 federation through its reduced twin, a narrow CNN,
   run on both devices) records under ``ExampleSpies``, and one of three
   CPU child processes, started with the phase, replays the record as it
   comes: every Adam step, local training's start, classifier ReLU and
   max-pool tie, AE refit, client encode, quantizer input and serve draw
   is held (full Adam steps and floats in the golden band, partial steps
   counted, codes exact) and then taken from the card, so the runs do
   not fork at rounding; every byte count, ratio, cohort, staleness, sync
   list, rung and outcome must then be equal and every round's floats in
   the band (``ac_hold``); the README-sized LM server's logits in run
   (g)'s band, the CPU fed the card's tokens. ``adaptive_rate_control``
   stops at its own ladder-walk assertion on both, as the JAX example
   does; any other example assertion fails the script. Each call's
   launches, routes and host seconds are printed on one line, and what
   the examples print goes to ``build/chip_smoke/examples_ac.txt``.

Each phase's start is logged with the seconds since the script began.

Checkpoints go to ``build/chip_smoke/`` and are deleted after loading.
The second-to-last line is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no sparsity
GOLDEN_BAND = dict(atol=2e-5, rtol=2e-4)   # tests/test_golden_trajectory.py
ADAM_EPS = 1e-8              # autoencoder._adam_update's, the optimizers'
# kernel 6 against its plain version: float32 at the reference's
# Pallas-vs-oracle tolerance (tests/test_kernels.py); bfloat16 at two ulps
# of the output (2 * 2**-7 relative, 1e-3 near zero), since both sum in
# float32 and round once, so they differ by at most one ulp
FLASH_F32_TOL = dict(atol=3e-5, rtol=1e-3)
FLASH_BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ----------------------------------------------------------------- timing
def host_ms(fn, iters: int) -> float:
    """Time per call of ``fn`` called back to back from Python (CUDA
    events around the loop, after a warm-up). At small shapes this is the
    host's cost of a call — checks, allocation, the launch itself — not
    the card's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's cost
    of each call is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def close(got, want, atol: float, rtol: float) -> float:
    """Max |got - want|; raises unless within ``atol + rtol·|want|``."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all())
    worst = float(err.max()) if err.numel() else 0.0
    require(ok, f"mismatch: max abs err {worst} (atol={atol}, rtol={rtol})")
    require(bool(torch.isfinite(g).all()), "non-finite kernel output")
    return worst


# ------------------------------------------------------- kernels vs plain
def tie_rows(x, qmax: float, every: int):
    """Overwrite every ``every``-th row so that absmax == qmax (scale 1.0)
    and the other values sit on .5 ties: half-to-even and half-away
    rounding give different codes there."""
    import torch
    nb, block = x.shape
    vals = (torch.arange(block - 1, device=x.device) % (2 * int(qmax) - 1)
            - (qmax - 1)) + 0.5
    x[::every, 0] = qmax
    x[::every, 1:] = vals
    return x


def check_quantize(nb: int, bits: int, seed: int, iters: int,
                   block: int = 256) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import (dequantize_blocks_2d,
                                              kernel_route,
                                              quantize_blocks_2d)
    g = torch.Generator(device="cuda").manual_seed(seed)
    qmax = float(2 ** (bits - 1) - 1)
    x = torch.randn((nb, block), generator=g, device="cuda") * 3.0
    x = tie_rows(x, qmax, 7).contiguous()
    q, s = quantize_blocks_2d(x, bits=bits, block=block)
    q_r, s_r = ref.quantize_blocks_ref(x, bits)
    torch.cuda.synchronize()
    require(torch.equal(q, q_r), f"quantize codes differ (bits={bits})")
    require(torch.equal(s, s_r), f"quantize scales differ (bits={bits})")
    d = dequantize_blocks_2d(q, s, block=block)
    d_r = ref.dequantize_blocks_ref(q_r, s_r)
    require(torch.equal(d, d_r), "dequantize differs")
    # the one PyTorch call with the same function: int8 · f32 promotes to f32
    require(torch.equal(d, torch.mul(q, s[:, None])), "dequantize != torch.mul")
    n = nb * block
    rows = []
    for name, kern, plain, lib, nbytes, flops, plan in (
            ("quantize_blocks_2d",
             lambda: quantize_blocks_2d(x, bits=bits, block=block),
             lambda: ref.quantize_blocks_ref(x, bits), None,
             4 * n + n + 4 * nb, 4 * n,
             kernel_route("quantize", nb, block, x.data_ptr(),
                          q.data_ptr())),
            ("dequantize_blocks_2d",
             lambda: dequantize_blocks_2d(q, s, block=block),
             lambda: ref.dequantize_blocks_ref(q, s),
             lambda: torch.mul(q, s[:, None]),
             n + 4 * nb + 4 * n, n,
             kernel_route("dequantize", nb, block, q.data_ptr(),
                          d.data_ptr()))):
        b_ms, b_by = bound(nbytes, flops, "float32")
        rows.append(dict(name=name, shape=[nb, block], bits=bits,
                         kernel_route=plan.route,
                         plan=[plan.threads, plan.grid],
                         max_abs_err=0.0, ms=time_ms(kern, iters),
                         host_ms=host_ms(kern, iters),
                         plain_ms=time_ms(plain, iters),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=None if lib is None
                         else time_ms(lib, iters)))
    return {r["name"]: r for r in rows}


def quant_routes(counts: dict) -> dict:
    """Kernels 1 and 2's launches by route since ``ROUTE_LAUNCHES`` was
    cleared, ``{kernel: {route: n}}``; each kernel's routes must add up to
    its count in ``counts`` (``_lib.counts()`` over the same run)."""
    from repro_torch.kernels import quantize as qz
    out = {}
    for name in ("quantize_blocks_2d", "dequantize_blocks_2d"):
        kind = name.split("_")[0]
        out[name] = {k.split("/")[1]: v for k, v in qz.ROUTE_LAUNCHES.items()
                     if k.startswith(kind + "/")}
        require(sum(out[name].values()) == counts.get(name, 0),
                f"{name}: launches by route {out[name]} do not add up to "
                f"{counts.get(name, 0)}")
    return out


def check_fused_dense(M: int, K: int, N: int, act: str, dtype, seed: int,
                      iters: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dense import fused_dense, kernel_route
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=g, device="cuda")
         * K ** -0.5).to(dtype)
    b = torch.randn((N,), generator=g, device="cuda").to(dtype)
    got = fused_dense(x, w, b, act=act)
    want = ref.fused_dense_ref(x, w, b, act)
    torch.cuda.synchronize()
    require(got.dtype == dtype, "fused_dense output dtype")
    # float32: FMA accumulation in another order than cuBLAS, no TF32;
    # bfloat16: one bf16 ulp where the float32 sums round differently
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=5e-2, rtol=1e-2))
    err = close(got, want, **tol)
    es = x.element_size()
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    b_ms, b_by = bound(es * (M * K + K * N + N + M * N), 2.0 * M * K * N,
                       dname)
    # the library call computes x @ w + b; the activation is left out
    lib_ms = time_ms(lambda: torch.addmm(b, x, w), iters)
    kern = lambda: fused_dense(x, w, b, act=act)             # noqa: E731
    return dict(name="fused_dense", shape=[M, K, N], act=act, dtype=dname,
                kernel_route=kernel_route(M, K, N, dtype), max_abs_err=err,
                library_call="torch.addmm" + (
                    "" if act == "linear" else f" (without the {act})"),
                ms=time_ms(kern, iters),
                host_ms=host_ms(kern, iters),
                plain_ms=time_ms(lambda: ref.fused_dense_ref(x, w, b, act),
                                 iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_decode_agg(C: int, M: int, K: int, N: int, seed: int,
                     iters: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_agg import (fused_decode_agg,
                                                      kernel_route)
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((C, M, K), generator=g, device="cuda")
    w = torch.rand((C,), generator=g, device="cuda") + 0.1
    w = (w / w.sum()).contiguous()
    wl = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    bl = torch.randn((N,), generator=g, device="cuda")
    got = fused_decode_agg(h, w, wl, bl)
    want = ref.fused_decode_agg_ref(h, w, wl, bl)
    torch.cuda.synchronize()
    err = close(got, want, atol=2e-5, rtol=1e-4)   # tests/test_kernels.py
    # a client with weight ~1 must dominate (weighting, not averaging)
    h2 = torch.stack([torch.ones((16, 8), device="cuda"),
                      100.0 * torch.ones((16, 8), device="cuda")])
    probe = fused_decode_agg(h2, torch.tensor([0.999, 0.001], device="cuda"),
                             torch.eye(8, device="cuda"),
                             torch.zeros(8, device="cuda"))
    close(probe, torch.full((16, 8), 0.999 + 0.1, device="cuda"), 0.0, 1e-5)
    b_ms, b_by = bound(4 * (C * M * K + C + K * N + N + M * N),
                       2.0 * C * M * K + 2.0 * M * K * N + M * N, "float32")
    kern = lambda: fused_decode_agg(h, w, wl, bl)            # noqa: E731
    # the one PyTorch call with the same sum; the bias is left out
    lib_ms = time_ms(lambda: torch.einsum("c,cmk,kn->mn", w, h, wl), iters)
    return dict(name="fused_decode_agg", shape=[C, M, K, N],
                kernel_route=kernel_route(M, K), max_abs_err=err,
                ms=time_ms(kern, iters), host_ms=host_ms(kern, iters),
                plain_ms=time_ms(lambda: ref.fused_decode_agg_ref(
                    h, w, wl, bl), iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_call='torch.einsum("c,cmk,kn->mn") (without the '
                             'bias)')


def check_grouped_decode_agg(shapes, K: int, N: int, dec_idx, seed: int,
                             iters: int) -> dict:
    """The grouped ragged launch on buckets of ``(C_b, M_b)``: against its
    plain version, and each bucket bit-equal to the per-bucket kernel
    (``fused_decode_agg``) on that bucket alone, an empty bucket exact
    zeros; ``kernel_route`` lists each bucket's route. ``ms`` times the
    launch of a plan built once (the plan's table copy is the host's work,
    in ``host_ms`` with the whole wrapper); ``per_bucket_ms`` is the
    per-bucket kernel launched once per live bucket, the yardstick where no
    single PyTorch call computes this."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_agg import (
        fused_decode_agg, grouped_fused_decode_agg, grouped_launch,
        grouped_plan)
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = max(dec_idx) + 1
    hs, ws = [], []
    for C_b, M_b in shapes:
        hs.append(torch.randn((C_b, M_b, K), generator=g, device="cuda"))
        w = torch.rand((C_b,), generator=g, device="cuda") + 0.1
        ws.append((w / w.sum() if C_b else w).contiguous())
    w_stack = torch.randn((D, K, N), generator=g, device="cuda") * K ** -0.5
    b_stack = torch.randn((D, N), generator=g, device="cuda")
    decs = [(w_stack[d].contiguous(), b_stack[d].contiguous())
            for d in range(D)]
    args = (hs, ws, w_stack, b_stack, dec_idx)
    got = grouped_fused_decode_agg(*args)
    want = ref.grouped_fused_decode_agg_ref(*args)
    live = [b for b, h in enumerate(hs) if h.shape[0] > 0]
    torch.cuda.synchronize()
    err = 0.0
    for b, (h, gb, wb) in enumerate(zip(hs, got, want)):
        require(tuple(gb.shape) == (h.shape[1], N), "grouped output shape")
        if b not in live:
            require(not bool(gb.any()), "empty bucket is not exact zeros")
            continue
        err = max(err, close(gb, wb, atol=2e-5, rtol=1e-4))
        per = fused_decode_agg(h, ws[b], *decs[dec_idx[b]])
        require(torch.equal(gb, per),
                f"bucket {b}: grouped != per-bucket kernel (bit-equality)")
    plan = grouped_plan(hs, ws, decs, dec_idx)
    n_bytes = 4 * (sum(h.numel() for h in hs) + sum(w.numel() for w in ws)
                   + D * (K * N + N) + sum(h.shape[1] for h in hs) * N)
    flops = sum(2.0 * h.numel() + 2.0 * h.shape[1] * K * N + h.shape[1] * N
                for h in hs if h.shape[0] > 0)
    b_ms, b_by = bound(n_bytes, flops, "float32")
    return dict(
        name="grouped_fused_decode_agg", shape=[list(s) for s in shapes],
        K=K, N=N, dec_idx=list(dec_idx), kernel_route=plan.routes,
        bm=plan.bm, cols=plan.cols, tpr=plan.tpr, tiles=plan.tiles,
        max_abs_err=err, bit_equal_per_bucket=True,
        ms=time_ms(lambda: grouped_launch(plan), iters),
        host_ms=host_ms(lambda: grouped_fused_decode_agg(*args), iters),
        plain_ms=time_ms(lambda: ref.grouped_fused_decode_agg_ref(*args),
                         iters),
        per_bucket_ms=time_ms(lambda: [fused_decode_agg(
            hs[b], ws[b], *decs[dec_idx[b]]) for b in live], iters),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def attention_pairs(Sq: int, Skv: int, mode: str, window,
                    q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through, for one (batch, head);
    query row i sits at key position i + q_offset."""
    total = 0
    for i in range(q_offset, Sq + q_offset):
        hi = Skv if mode == "full" else min(i + 1, Skv)
        lo = max(0, i - window + 1) if mode == "window" else 0
        total += max(0, hi - lo)
    return total


def sdpa_mask(Sq: int, Skv: int, mode: str, window, q_offset: int = 0):
    """The boolean ``attn_mask`` of ``scaled_dot_product_attention`` for
    kernel 6's mask (None in full mode)."""
    import torch
    if mode == "full":
        return None
    qi = torch.arange(Sq, device="cuda")[:, None] + q_offset
    kj = torch.arange(Skv, device="cuda")[None, :]
    m = kj <= qi
    if mode == "window":
        m &= kj > qi - window
    return m


def check_flash(B: int, Sq: int, Skv: int, H: int, KV: int, D: int,
                mode: str, window, dtype, seed: int, iters: int,
                q_offset: int = 0, softcap: float = 0.0) -> dict:
    """Kernel 6 against its plain version. ``bound_ms``: q, k, v and the
    output moved once, against 4·D operations for each (query, key) pair
    the mask lets through at the input type's peak; ``library_ms``:
    ``scaled_dot_product_attention`` on the (B, H, S, D) views with the
    same mask — ``is_causal`` (top-left aligned, as the kernel's), none
    in full mode, the window (and any ``q_offset``) as a boolean
    ``attn_mask`` — with the kernels PyTorch picked for it named. SDPA has
    no softcap: with one, ``library_ms`` is None and ``library_call``
    says why."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     kernel_route)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=g, device="cuda").to(dtype)
    kw6 = dict(mode=mode, window=window, q_offset=q_offset, softcap=softcap)
    got = flash_attention(q, k, v, **kw6)
    want = ref.flash_attention_ref(q, k, v, **kw6)
    torch.cuda.synchronize()
    require(got.dtype == dtype and got.shape == q.shape, "flash output")
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = close(got, want, **tol)
    es = q.element_size()
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    pairs = B * H * attention_pairs(Sq, Skv, mode, window, q_offset)
    b_ms, b_by = bound(es * (2 * B * Sq * H * D + 2 * B * Skv * KV * D),
                       4.0 * D * pairs, dname)
    lib = dict(library_ms=None,
               library_call="none: SDPA has no softcap")
    if softcap == 0.0:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = dict(enable_gqa=True)
        if mode == "causal" and q_offset == 0:
            kw["is_causal"] = True
        elif mode != "full":
            kw["attn_mask"] = sdpa_mask(Sq, Skv, mode, window, q_offset)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
        lib = dict(
            library_ms=time_ms(sdpa, iters),
            library_kernels=[n for n, _ in
                             traced_round(sdpa, top=3)["top_kernels_ms"]],
            library_max_abs_err=float((sdpa().transpose(1, 2).float()
                                       - want.float()).abs().max()))
    kern = lambda: flash_attention(q, k, v, **kw6)           # noqa: E731
    return dict(name="flash_attention", shape=[B, Sq, Skv, H, KV, D],
                mode=mode, window=window, q_offset=q_offset,
                softcap=softcap, dtype=dname,
                kernel_route=kernel_route(dtype), max_abs_err=err,
                ms=time_ms(kern, iters), host_ms=host_ms(kern, iters),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(
                    q, k, v, **kw6), iters),
                bound_ms=b_ms, bound_by=b_by, gflop=4.0 * D * pairs / 1e9,
                **lib)


# ------------------------------------------------------------------ slice
def run_golden(device: str):
    """Run (a): the golden configuration (tests/test_golden_trajectory.py)."""
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import FederatedRun, FLConfig, QuantizeCompressor
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    train, ev = train_eval_split(mnist_like(0, 256), 64)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 3),
        FLConfig(n_rounds=2, local_epochs=1, payload="update",
                 error_feedback=True, seed=0),
        compressors=[QuantizeCompressor(bits=8) for _ in range(3)],
        eval_data=ev, device=device)
    return run, run.run()


def run_fc_ae(device: str):
    """Run (b): pre-pass + FC-AE training, then the FC-AE FL run
    (tests/test_system.py)."""
    import torch
    from repro_torch.configs.paper import MNIST_AE, MNIST_CLASSIFIER
    from repro_torch.core import (FCAECompressor, FederatedRun, FLConfig,
                                  run_prepass)
    from repro_torch.data.pipeline import (dirichlet_partition, mnist_like,
                                           train_eval_split)
    out = run_prepass(torch.Generator().manual_seed(0), MNIST_CLASSIFIER,
                      MNIST_AE, mnist_like(0, 512), prepass_epochs=12,
                      ae_epochs=200, device=device)
    train, ev = train_eval_split(mnist_like(1, 768), 256)
    run = FederatedRun(
        MNIST_CLASSIFIER, dirichlet_partition(0, train, 2, alpha=1.0),
        FLConfig(n_rounds=2, local_epochs=1, error_feedback=True),
        compressors=[FCAECompressor(out["ae_params"], MNIST_AE)
                     for _ in range(2)],
        eval_data=ev, device=device)
    return out, run, run.run()


def run_chunked(device: str):
    """Run (c): kernel-path chunked AE at the default ChunkedAEConfig()."""
    import torch
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  FederatedRun, FLConfig, init_chunked_ae)
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    cfg = ChunkedAEConfig()
    params = init_chunked_ae(torch.Generator().manual_seed(2), cfg, device)
    train, ev = train_eval_split(mnist_like(0, 256), 64)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 3),
        FLConfig(n_rounds=2, local_epochs=1, payload="update",
                 error_feedback=True, seed=0),
        compressors=[ChunkedAECompressor(params, cfg, use_kernel=True)
                     for _ in range(3)],
        eval_data=ev, device=device)
    return run, run.run()


def _rung_params(device: str):
    """Two kernel-path chunked-AE rungs at full width: the default
    ``ChunkedAEConfig()`` (4096/(512,)/8) and its latent-4 sibling, each
    freshly initialised from a seed; one params object per rung."""
    import torch
    from repro_torch.core import ChunkedAEConfig, init_chunked_ae
    cfgs = (ChunkedAEConfig(), ChunkedAEConfig(latent_chunk=4))
    return cfgs, [init_chunked_ae(torch.Generator().manual_seed(2 + i), c,
                                  device) for i, c in enumerate(cfgs)]


def _four_client_run(device: str, comps, grouped: bool):
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import FederatedRun, FLConfig
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    # 128 examples a client: two local batches of 64
    train, ev = train_eval_split(mnist_like(0, 576), 64)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 4),
        FLConfig(n_rounds=2, local_epochs=1, payload="update",
                 error_feedback=True, use_grouped_kernel=grouped, seed=0),
        compressors=comps, eval_data=ev, device=device)
    return run, run.run()


def run_partitioned(device: str, grouped: bool = True):
    """Run (d): ``by_layer_partition`` of the MLP; dense0 (15,700 values)
    on the chunked AE, clients 0-1 latent 8 and 2-3 latent 4 (one grouped
    launch, two decoder slots a round); dense1 (210) q8 for even clients,
    q4 for odd."""
    import torch
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (ChunkedAECompressor, PartitionedCompressor,
                                  QuantizeCompressor, by_layer_partition)
    from repro_torch.models.classifiers import init_classifier
    pmap = by_layer_partition(init_classifier(torch.Generator(),
                                              MNIST_CLASSIFIER, device))
    cfgs, prms = _rung_params(device)
    comps = [PartitionedCompressor(pmap, {
        "dense0": ChunkedAECompressor(prms[i // 2], cfgs[i // 2],
                                      use_kernel=True),
        "dense1": QuantizeCompressor(bits=8 if i % 2 == 0 else 4)})
        for i in range(4)]
    return _four_client_run(device, comps, grouped)


def run_flat_mixed(device: str, grouped: bool = True):
    """Run (e): a flat mixed cohort — chunked AE latent 8, latent 4, q8,
    q4 — through ``grouped_flat_server_aggregate``."""
    from repro_torch.core import ChunkedAECompressor, QuantizeCompressor
    cfgs, prms = _rung_params(device)
    comps = [ChunkedAECompressor(prms[0], cfgs[0], use_kernel=True),
             ChunkedAECompressor(prms[1], cfgs[1], use_kernel=True),
             QuantizeCompressor(bits=8), QuantizeCompressor(bits=4)]
    return _four_client_run(device, comps, grouped)


def arch_cut(arch: str, n_layers: int, **changes):
    """``arch``'s full-width config at ``n_layers`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers, **changes)


def in_model_flash_errs(run, calls: list = None) -> list:
    """Call ``run()`` with every kernel-6 call that the model makes held
    against the plain version on the same inputs: the model's own q, k and
    v after the rope, the cast to the compute type and ``.contiguous()``;
    a padded call (head dims the kernel has no instantiation for) against
    the plain version on its unpadded q, k and v at the call's scale.
    Returns each call's max
    abs err; raises outside the tolerance. ``calls`` receives each call's
    ``(padded, mode, window, q shape, k shape)``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    kernels = {"flash_kernel": attention.flash_kernel,
               "flash_kernel_padded": attention.flash_kernel_padded}
    errs = []

    def held(kernel):
        def checked(q, k, v, *, mode, window, scale=None, q_offset=0,
                    softcap=0.0):
            kw = dict(q_offset=q_offset, softcap=softcap)
            out = kernel(q, k, v, mode=mode, window=window,
                         **kw, **({} if scale is None else {"scale": scale}))
            want = ref.flash_attention_ref(q, k, v, mode=mode, window=window,
                                           scale=scale, **kw)
            tol = (FLASH_F32_TOL if q.dtype == torch.float32
                   else FLASH_BF16_TOL)
            errs.append(close(out, want, **tol))
            if calls is not None:
                calls.append((kernel is kernels["flash_kernel_padded"], mode,
                              window, tuple(q.shape), tuple(k.shape)))
            return out
        return checked

    for name, kernel in kernels.items():
        setattr(attention, name, held(kernel))
    try:
        run()
    finally:
        for name, kernel in kernels.items():
            setattr(attention, name, kernel)
    return errs


def attention_caches(cfg, cache) -> list:
    """The stacked attention caches ``(L, B, C, ...)`` of a decode cache:
    GQA's K and V (and a ring's positions) or MLA's latents; the hybrid's
    local-attention sub-layers, the audio decoder's self-attention (its
    cross K/V are the encoder's, all filled); none in the SSM."""
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [cache["layers"][f"sub{i}"]
                for i, kind in enumerate(cfg.rglru.pattern) if kind == "attn"]
    if cfg.family == "audio":
        return [cache["layers"]["self"]]
    return [cache["layers"]]


def filled(entry) -> list:
    """Per tensor ``(L, B, C, ...)`` of an attention cache (not a ring's
    positions), which ``(L, B, C)`` slots hold a nonzero entry."""
    return [t.abs().flatten(3).amax(-1) > 0 for k, t in entry.items()
            if k != "pos"]


def check_filled(cfg, cache, n: int, tag: str) -> None:
    """After ``n`` tokens each attention cache of C slots holds min(n, C):
    a linear cache its first ones, a ring (``pos``) the last min(n, C)
    positions, each at slot ``pos % C``."""
    import torch
    for entry in attention_caches(cfg, cache):
        C = next(iter(entry.values())).shape[2]
        take = min(n, C)
        for f in filled(entry):
            if "pos" in entry:
                want = torch.zeros(C, dtype=torch.bool, device=f.device)
                want[torch.arange(n - take, n, device=f.device) % C] = True
                ok = bool((f == want).all())
                ok = ok and int(entry["pos"].max()) == n - 1
            else:
                ok = bool(f[:, :, :take].all()) and not bool(
                    f[:, :, take:].any())
            require(ok, f"{cfg.name}: {tag} cache not filled")


def cache_nbytes(cache) -> int:
    from repro_torch.core.pytree import leaves
    return sum(t.numel() * t.element_size() for t in
               leaves({k: v for k, v in cache.items() if k != "index"}))


def family_inputs(cfg, B: int, S: int, seed: int, device: str) -> dict:
    """A serving batch: B prompts of S tokens (``synthetic_lm_batch``)
    and, per family, the stub frontends' inputs drawn from ``seed`` on
    ``device`` as the reference's ``input_specs`` shapes them: the audio
    encoder's (B, n_frames, d_model) frame embeddings, the VLM's (B,
    n_image_tokens, d_model) image embeddings, standard normal."""
    import torch
    from repro_torch.data.pipeline import synthetic_lm_batch
    batch = {k: t.to(device) for k, t in
             synthetic_lm_batch(seed, cfg.vocab_size, B, S).items()}
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (B, cfg.encdec.n_frames, cfg.d_model), generator=g,
            device=device)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (B, cfg.vlm.n_image_tokens, cfg.d_model), generator=g,
            device=device)
    return batch


def serve_full_width(cfg, seed: int, B: int = 4, S: int = 1024,
                     steps: int = 16, spy=None) -> tuple:
    """``cfg``'s weights drawn on the card from ``seed``, a warm-up
    prefill, then a timed prefill of B prompts of S tokens
    (:func:`family_inputs`) and ``steps`` greedy decode steps, each ended
    by a synchronize. Launch counters (``_lib`` and kernel 6's routes) are
    zeroed just before the prefill and read after it, and again around the
    decode, which must launch nothing; the prefill fills each attention
    cache's first S slots (a ring its last positions) and the decode the
    rest, and leaves the cache's bytes as they were (the recurrent states
    are O(1)). Returns (params, batch, measurements)."""
    import torch
    from repro_torch import models
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = family_inputs(cfg, B, S, 0, "cuda")
    models.prefill(params, cfg, batch, S + steps)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if spy is not None:
        spy.calls.clear()
    _lib.reset_launches()
    fa.ROUTE_LAUNCHES.clear()
    t0 = time.perf_counter()
    logits, cache = models.prefill(params, cfg, batch, S + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = (_lib.counts(), dict(fa.ROUTE_LAUNCHES))
    require(tuple(logits.shape) == (B, cfg.padded_vocab), "logits shape")
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    require(cache["index"] == S, "prefill cache index")
    check_filled(cfg, cache, S, "prefill")
    cache_bytes = cache_nbytes(cache)
    routing = spy.rows() if spy is not None else None
    _lib.reset_launches()
    fa.ROUTE_LAUNCHES.clear()
    step_s = []
    tokens = []
    for _ in range(steps):
        token = logits[:, :cfg.vocab_size].argmax(-1)[:, None]
        tokens.append(token)
        t0 = time.perf_counter()
        logits, cache = models.decode_step(params, cfg, token, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        require(bool(torch.isfinite(logits).all()), "non-finite decode")
    counts_decode = (_lib.counts(), dict(fa.ROUTE_LAUNCHES))
    require(counts_decode == ({}, {}),
            f"{cfg.name}: decode launches {counts_decode}")
    require(cache["index"] == S + steps, "decode cache index")
    check_filled(cfg, cache, S + steps, "decode")
    require(cache_nbytes(cache) == cache_bytes,
            f"{cfg.name}: the cache grew in decode")
    out = dict(arch=cfg.name, n_layers=cfg.n_layers,
               params=models.param_count(params), batch=B, prompt=S,
               decode_steps=steps, init_s=init_s, prefill_s=prefill_s,
               prefill_tokens_per_s=B * S / prefill_s, decode_step_s=step_s,
               decode_step_median_s=sorted(step_s)[steps // 2],
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches_prefill=counts_prefill[0],
               routes_prefill=counts_prefill[1], launches_decode={},
               cache_bytes=cache_bytes,
               first_tokens=torch.cat(tokens, 1)[:, :4].tolist())
    if routing is not None:
        out["routing_prefill"] = routing
    del cache, logits
    return params, batch, out


def run_lm_serving() -> dict:
    """Run (f): deepseek-coder-33b at full width, 8 layers, serving 4
    prompts of 1,024 tokens then 16 greedy decode steps on the card
    (:func:`serve_full_width`); after the counts and the peak were read,
    one more prefill holds each layer's kernel-6 call against the plain
    version at the model's own inputs."""
    from repro_torch import models
    cfg = arch_cut("deepseek-coder-33b", 8)
    params, batch, out = serve_full_width(cfg, seed=0)
    require(out["params"] == 4_705_082_368,
            f"run (f) holds {out['params']} parameters")
    require(out["launches_prefill"] == {"flash_attention": cfg.n_layers},
            f"run (f) prefill launches {out['launches_prefill']}")
    errs = in_model_flash_errs(
        lambda: models.prefill(params, cfg, batch, 1024 + 16))
    require(len(errs) == cfg.n_layers, "in-model kernel-6 checks")
    out["attention_in_model_max_abs_err"] = errs
    return out


def bf16_close(card, cpu, cpu_f32, tag: str) -> dict:
    """The card's bfloat16 result against the CPU's, relative to bfloat16
    rounding: both round at every cast to the compute type, so the card may
    differ from the CPU by at most twice the CPU's own bfloat16 error (its
    distance from the same model in float32 compute)."""
    import torch
    err = float((card.cpu().float() - cpu.float()).abs().max())
    own = float((cpu.float() - cpu_f32.float()).abs().max())
    require(bool(torch.isfinite(card).all()) and err <= 2 * own,
            f"run (g) bfloat16 {tag}: card vs CPU max abs err {err} > 2 x "
            f"the CPU's bfloat16-vs-float32 error {own}")
    return dict(max_abs_err=err, cpu_bf16_vs_f32=own)


def run_lm_card_vs_cpu() -> dict:
    """Run (g): 2 layers in float32 compute, the card against the CPU from
    the same weights; the CPU decode is fed the card's greedy tokens. Then
    a prefill in the config's own bfloat16 compute on both, held against
    the CPU by ``bf16_close``."""
    import torch
    from repro_torch import models
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.kernels import _lib
    cfg = arch_cut("deepseek-coder-33b", 2, compute_dtype="float32")
    tol = dict(atol=1e-4, rtol=1e-3)
    gparams = models.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    cparams = tree_map(lambda t: t.cpu(), gparams)
    n_params = models.param_count(gparams)
    require(n_params == 1_523_092_480, f"run (g) holds {n_params}")
    batch = synthetic_lm_batch(1, cfg.vocab_size, 1, 128)
    gbatch = {k: t.cuda() for k, t in batch.items()}
    _lib.reset_launches()
    glogits, gcache = models.prefill(gparams, cfg, gbatch, 132)
    torch.cuda.synchronize()
    counts = _lib.counts()
    require(counts == {"flash_attention": cfg.n_layers},
            f"run (g) prefill launches {counts}")
    clogits, ccache = models.prefill(cparams, cfg, batch, 132)
    errs = [close(glogits.cpu(), clogits, **tol)]
    bcfg = arch_cut("deepseek-coder-33b", 2)      # bfloat16 compute
    _lib.reset_launches()
    blogits, bcache = models.prefill(gparams, bcfg, gbatch, 132)
    torch.cuda.synchronize()
    require(_lib.counts() == {"flash_attention": bcfg.n_layers},
            f"run (g) bfloat16 prefill launches {_lib.counts()}")
    clogits16, ccache16 = models.prefill(cparams, bcfg, batch, 132)
    bf16 = {"logits": bf16_close(blogits, clogits16, clogits, "logits")}
    for k in ("k", "v"):
        bf16[f"cache_{k}"] = bf16_close(bcache["layers"][k],
                                        ccache16["layers"][k],
                                        ccache["layers"][k], f"cache {k}")
    del blogits, bcache, clogits16, ccache16
    for _ in range(4):
        token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
        glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
        clogits, ccache = models.decode_step(cparams, cfg, token.cpu(),
                                             ccache)
        errs.append(close(glogits.cpu(), clogits, **tol))
    require(gcache["index"] == ccache["index"] == 132, "cache index")
    cache_err = max(close(gcache["layers"][k].cpu(), ccache["layers"][k],
                          **tol) for k in ("k", "v"))
    return dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
                logits_max_abs_err=errs, cache_max_abs_err=cache_err,
                bf16_prefill=bf16)


def run_cohort_round(device: str, model: int = 1 << 20, cohort: int = 64):
    """Run (h): one chunked-AE server round at ``fl_decode_agg``'s full
    point (``benchmarks/tables.py:405-419``): a ``model``-value update,
    ``ChunkedAEConfig(256, (32,), 8)`` with parameters from a seed, and
    ``cohort`` clients, update i the base update x (1 + 0.01 i), weights
    i + 1 normalised. Each client runs ``codec.encode`` (the kernel path:
    its two encoder layers through ``fused_dense``); the server runs
    ``codec.stack_payloads`` and ``codec.decode_and_aggregate``
    (``chunked_hidden`` at (cohort x 4096, 8) @ (8, 32), then one kernel-4
    launch). Parameters and the base update are drawn on the CPU and moved,
    so the card and the CPU start from the same values. Returns (mean
    update, stacked latents, seconds on the host clock around the round,
    ended by a synchronize)."""
    import torch
    from repro_torch.core import (ChunkedAEConfig, codec, init_chunked_ae,
                                  normalize_weights)
    from repro_torch.core.pytree import tree_map
    cfg = ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    params = tree_map(lambda t: t.to(device),
                      init_chunked_ae(torch.Generator().manual_seed(0), cfg,
                                      "cpu"))
    flat = torch.randn((model,), generator=torch.Generator().manual_seed(1)
                       ).to(device)
    spec = codec.ChunkedAESpec(size=model, cfg=cfg, use_kernel=True)
    weights = torch.tensor(normalize_weights([float(i + 1)
                                              for i in range(cohort)]),
                           dtype=torch.float32, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads = [codec.encode(spec, params, flat * (1 + 0.01 * i))
                for i in range(cohort)]
    stacked = codec.stack_payloads(payloads)
    mean = codec.decode_and_aggregate(spec, params, stacked, weights)
    if device == "cuda":
        torch.cuda.synchronize()
    return mean, stacked["z"], time.perf_counter() - t0


# ------------------------------------------------------ scalable runtime
CIFAR_PARAMS = 550_586


def run_sampled_cnn(device: str, n_clients: int = 1000, cohort: int = 100,
                    rounds: int = 2):
    """Run (i): ``SampledSync`` over the paper's CIFAR CNN at full width
    (550,586 parameters), ``n_clients`` equal shards of 64 ``cifar_like``
    images (so the cohort takes the vmap path), a C-of-N cohort, 1 local
    epoch, update payload with error feedback, through
    ``ComposedCompressor(ChunkedAECompressor(ChunkedAEConfig(),
    use_kernel=True), bits=8)``: 135 chunks of 4,096 → 1,080 latents → q8
    at block 64. The AE is drawn from a seed, its normalizer set to the
    update's scale (std 1e-3). Returns (run, records, scheduler, host
    seconds per round, each ended by a synchronize)."""
    import torch
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  ComposedCompressor, FederatedRun, FLConfig,
                                  SampledSync, init_chunked_ae)
    from repro_torch.data.pipeline import (cifar_like, train_eval_split,
                                           uniform_partition)
    cfg = ChunkedAEConfig()
    ae = init_chunked_ae(torch.Generator().manual_seed(2), cfg, device)
    ae["norm"] = {"mean": torch.zeros((), device=device),
                  "std": torch.full((), 1e-3, device=device)}
    train, ev = train_eval_split(cifar_like(0, n_clients * 64 + 256), 256)
    sched = SampledSync(cohort=cohort)
    run = FederatedRun(
        CIFAR_CLASSIFIER, uniform_partition(0, train, n_clients),
        FLConfig(n_rounds=rounds, local_epochs=1, payload="update",
                 error_feedback=True, seed=0),
        compressors=[ComposedCompressor(
            ChunkedAECompressor(ae, cfg, use_kernel=True), bits=8)
            for _ in range(n_clients)],
        eval_data=ev, scheduler=sched, device=device)
    return (run,) + _timed_rounds(run, rounds, device) + (sched,)


def run_async_mlp(device: str, scenario=None, engine: str = "heap",
                  rounds: int = 3, soa: bool = False):
    """Run (j): :func:`build_async_mlp`, played ``rounds`` rounds. Returns
    (run, records, host seconds per round)."""
    run = build_async_mlp(device, scenario, engine, rounds, soa)
    return (run,) + _timed_rounds(run, rounds, device)


def build_async_mlp(device: str, scenario=None, engine: str = "heap",
                    rounds: int = 3, soa: bool = False):
    """Run (j)'s ``FederatedRun``: ``AsyncBuffered`` over the MNIST MLP at
    full width (15,910 parameters) at ``scenario``
    (``PAPER_SCALE_SCENARIO`` by default: 1,000 clients, K 50,
    ``LatencyModel(1.0, 0.5, straggler_frac=0.1, straggler_mult=8.0)``),
    128 examples a client and 2 local epochs (four Adam steps: after one,
    every moved parameter has moved by lr to within rounding, and top-k
    would rank the rounding), update payload with error feedback through
    ``ChainCompressor((TopK 1 %, q8))``, the scatter route; ``soa`` keeps
    the client state as a struct-of-arrays pool (run (p))."""
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.configs.paper import PAPER_SCALE_SCENARIO
    from repro_torch.core import (AsyncBuffered, ChainCompressor,
                                  FederatedRun, FLConfig, LatencyModel,
                                  QuantizeCompressor, TopKCompressor)
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    sc = PAPER_SCALE_SCENARIO if scenario is None else scenario
    n = sc.n_clients
    train, ev = train_eval_split(mnist_like(0, n * 128 + 256), 256)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, n),
        FLConfig(n_rounds=rounds, local_epochs=2, payload="update",
                 error_feedback=True, seed=0),
        compressors=[ChainCompressor([TopKCompressor(0.01),
                                      QuantizeCompressor(bits=8)])
                     for _ in range(n)],
        eval_data=ev, device=device, soa_state=soa,
        scheduler=AsyncBuffered(
            buffer_k=sc.buffer_k, engine=engine,
            latency=LatencyModel(base=sc.base_latency,
                                 jitter=sc.latency_jitter,
                                 straggler_frac=sc.straggler_frac,
                                 straggler_mult=sc.straggler_mult)))
    return run


def profiled_async_round(soa: bool) -> dict:
    """Run (j) on the vector engine (``soa`` in either layout): round 0
    played, round 1 under ``cProfile``. Host seconds of the round, of the
    calls into ``core/soa.py`` (with all they call), of the garbage
    collector's passes and of the five functions with the most time of
    their own."""
    import cProfile
    import gc
    import pstats
    import torch
    run = build_async_mlp("cuda", engine="vector", rounds=2, soa=soa)
    _timed_rounds(run, 1, "cuda")
    gc_s, gc_t0 = [0.0], [0.0]

    def gc_clock(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]
    gc.callbacks.append(gc_clock)
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    run.history.append(run.scheduler.run_round(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.disable()
    gc.callbacks.remove(gc_clock)
    stats = pstats.Stats(prof).stats
    own = sorted(((tt, f"{Path(f).name}:{ln}:{fn}")
                  for (f, ln, fn), (_, _, tt, _, _) in stats.items()),
                 reverse=True)
    def in_soa(f):
        return f.endswith(str(Path("core") / "soa.py"))
    # inclusive: calls into core/soa.py from outside it, with all they call
    soa_s = sum(edge[3] for (f, _, _), (*_, callers) in stats.items()
                if in_soa(f) for caller, edge in callers.items()
                if not in_soa(caller[0]))
    return {"round_s": wall, "soa_calls_s": soa_s, "gc_s": gc_s[0],
            "top": [[name, tt] for tt, name in own[:5]]}


def _timed_rounds(run, rounds: int, device: str):
    """``run.run()`` a round at a time, each round's host seconds ended by
    a synchronize."""
    import torch
    secs = []
    for r in range(rounds):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.history.append(run.scheduler.run_round(r))
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return run.history, secs


def check_same_trace(tag: str, a, b) -> None:
    """Two runs of one async configuration: identical arrival traces."""
    for x, y in zip(a, b, strict=True):
        for k in ("participants", "staleness", "sim_time", "bytes_up",
                  "bytes_up_raw", "bytes_down"):
            require(getattr(x, k) == getattr(y, k), f"{tag}: {k} differ")


def check_scatter_route() -> dict:
    """The scatter route of ``decode_and_aggregate`` at run (j)'s shapes
    (50 clients, top-k 159 of 15,910, q8 values) on the card: two calls
    ``torch.equal``; the CPU within the golden band; and whether one
    ``index_add_`` over the whole cohort (atomics) is bit-equal across two
    calls, reported, not required."""
    import torch
    from repro_torch.core import codec, normalize_weights
    spec = codec.ChainSpec((codec.TopKSpec(15_910, 159),
                            codec.QuantizeSpec(159)))
    g = torch.Generator().manual_seed(3)
    xs = torch.randn((50, 15_910), generator=g) * 1e-3
    w = torch.tensor(normalize_weights([float(i + 1) for i in range(50)]))
    outs = {}
    for dev in ("cuda", "cpu", "cuda"):
        st = codec.stack_payloads([codec.encode(spec, None, x.to(dev))
                                   for x in xs])
        outs.setdefault(dev, []).append(
            codec.decode_and_aggregate(spec, None, st, w.to(dev)))
    require(torch.equal(*outs["cuda"]), "scatter route: two card calls "
            "differ")
    err = close(outs["cuda"][0].cpu(), outs["cpu"][0], **GOLDEN_BAND)
    vals = codec._chain_decode_batched(spec, None, st, upto=1) * \
        w.to("cuda")[:, None]
    idx = st["s0"]["indices"].reshape(-1).long()
    one = [torch.zeros(15_910, device="cuda").index_add_(0, idx,
                                                         vals.reshape(-1))
           for _ in range(2)]
    return {"second_call_bit_equal": True, "cpu_max_abs_err": err,
            "one_call_index_add_bit_equal": bool(torch.equal(*one)),
            "one_call_vs_route_max_abs_err":
                float((one[0] - outs["cuda"][0]).abs().max())}


def check_records(hist, up: float, raw: float, down: float) -> None:
    for r in hist:
        require(r.bytes_up == up, f"bytes_up {r.bytes_up} != {up}")
        require(r.bytes_up_raw == raw, f"bytes_up_raw {r.bytes_up_raw}")
        require(r.bytes_down == down, f"bytes_down {r.bytes_down}")
        require(math.isfinite(r.global_metrics["loss"]), "non-finite loss")


def check_cuda_vs_cpu(tag: str, run_gpu, hist_gpu, run_cpu, hist_cpu,
                      atol: float = GOLDEN_BAND["atol"],
                      rtol: float = GOLDEN_BAND["rtol"]) -> float:
    """Two runs of one configuration (the card and the CPU, or grouped and
    sequential): bytes exact; loss, accuracy and the final global
    parameters within ``atol``/``rtol`` (the golden band by default).
    Returns the largest parameter difference."""
    from repro_torch.core.pytree import ravel
    for g, c in zip(hist_gpu, hist_cpu, strict=True):
        for k in ("bytes_up", "bytes_up_raw", "bytes_down",
                  "compression_ratio"):
            require(getattr(g, k) == getattr(c, k), f"{tag}: {k} differ")
        for k in ("loss", "accuracy"):
            gv, cv = g.global_metrics[k], c.global_metrics[k]
            require(abs(gv - cv) <= atol + rtol * abs(cv),
                    f"{tag}: {k} differ beyond atol={atol} rtol={rtol}: "
                    f"{gv} {cv}")
    pg = ravel(run_gpu.global_params)[0].cpu()
    pc = ravel(run_cpu.global_params)[0].cpu()
    try:
        return close(pg, pc, atol, rtol)
    except AssertionError as e:
        raise AssertionError(f"{tag}: global params: {e}") from None


# ------------------------------------------------- lifecycle and resume
CKPT_DIR = ROOT / "build" / "chip_smoke"
# run (k)'s lifecycle; refresh_epochs cut from the default 40
LIFECYCLE_K = dict(refresh_every=2, drift_ratio=1.5, buffer_size=4,
                   min_snapshots=2, refresh_epochs=5)
# run (k)'s reduced copy for card vs CPU: 2 clients, 3 rounds, a refit at
# round 1 that round 2 decodes with
LIFECYCLE_K_REDUCED = dict(refresh_every=1, drift_ratio=1.5, buffer_size=4,
                           min_snapshots=1, refresh_epochs=2)
LIFECYCLE_L = dict(refresh_every=2, drift_ratio=2.0, buffer_size=4,
                   min_snapshots=2, refresh_epochs=6)


class CohortSpy:
    """Counts ``train_autoencoder_cohort`` dispatches (the lifecycle's
    refits call it, a group of one through ``train_autoencoder``): per call
    the cohort size C, the dataset shape, the seconds it took (ended by a
    synchronize) and, on the card, the peak of allocated device memory
    during the call. A context manager that puts the function back."""

    def __enter__(self):
        from repro_torch.core import autoencoder as ae
        self.mod, self.real, self.calls = ae, ae.train_autoencoder_cohort, []

        def spy(gens, cfg, datasets, **kw):
            import torch
            if datasets.is_cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = self.real(gens, cfg, datasets, **kw)
            call = dict(C=int(datasets.shape[0]), shape=list(datasets.shape))
            if datasets.is_cuda:
                torch.cuda.synchronize()
                call["peak_bytes"] = torch.cuda.max_memory_allocated()
            call["s"] = time.perf_counter() - t0
            self.calls.append(call)
            return out
        ae.train_autoencoder_cohort = spy
        return self

    def __exit__(self, *exc):
        self.mod.train_autoencoder_cohort = self.real


def play(run, rounds: int, device: str, spy=None):
    """Play ``rounds`` rounds of ``run`` from where it stands (its round
    offset after a restore), one at a time: per round its host seconds
    (ended by a synchronize), the kernel launches and ``fused_dense``
    routes it added, and the cohort-fit dispatches it made."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import fused_dense as fd_mod
    out = []
    start = run.round_offset + len(run.history)
    for r in range(start, start + rounds):
        c0, q0 = _lib.counts(), dict(fd_mod.ROUTE_LAUNCHES)
        n0 = len(spy.calls) if spy is not None else 0
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.history.append(run.scheduler.run_round(r))
        if device == "cuda":
            torch.cuda.synchronize()
        c1, q1 = _lib.counts(), dict(fd_mod.ROUTE_LAUNCHES)
        out.append(dict(
            round=r, s=time.perf_counter() - t0,
            launches={k: v - c0.get(k, 0) for k, v in c1.items()
                      if v - c0.get(k, 0)},
            routes={k: v - q0.get(k, 0) for k, v in q1.items()
                    if v - q0.get(k, 0)},
            refits=(spy.calls[n0:] if spy is not None else [])))
    return out


def build_lifecycle_cnn(device: str, n_clients: int = 8, rounds: int = 6,
                        lifecycle=None, soa: bool = False):
    """Run (k): ``SyncFedAvg`` over the paper's CIFAR CNN at full width
    (550,586 parameters), ``n_clients`` shards of 64 ``cifar_like`` images,
    1 local epoch, update payload with error feedback, each client the
    composed kernel-path chunked AE of run (i)
    (``ComposedCompressor(ChunkedAECompressor(ChunkedAEConfig(),
    use_kernel=True), bits=8)``: 135 chunks of 4,096 → 1,080 latents → q8
    at block 64, 1,156 B), all clients on one params object drawn from a
    seed (normalizer std 1e-3), and an ``AELifecycle`` (``LIFECYCLE_K`` by
    default). The AE is drawn on the CPU and moved, so every build starts
    from the same values. ``soa`` keeps the client state as a
    struct-of-arrays pool (run (p))."""
    import torch
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core import (AELifecycle, ChunkedAECompressor,
                                  ChunkedAEConfig, ComposedCompressor,
                                  FederatedRun, FLConfig, init_chunked_ae)
    from repro_torch.data.pipeline import (cifar_like, train_eval_split,
                                           uniform_partition)
    cfg = ChunkedAEConfig()
    ae = init_chunked_ae(torch.Generator().manual_seed(2), cfg, device)
    ae["norm"] = {"mean": torch.zeros((), device=device),
                  "std": torch.full((), 1e-3, device=device)}
    train, ev = train_eval_split(cifar_like(0, n_clients * 64 + 256), 256)
    return FederatedRun(
        CIFAR_CLASSIFIER, uniform_partition(0, train, n_clients),
        FLConfig(n_rounds=rounds, local_epochs=1, payload="update",
                 error_feedback=True, seed=0),
        compressors=[ComposedCompressor(
            ChunkedAECompressor(ae, cfg, use_kernel=True), bits=8)
            for _ in range(n_clients)],
        eval_data=ev, device=device, soa_state=soa,
        lifecycle=AELifecycle(**(LIFECYCLE_K if lifecycle is None
                                 else lifecycle)))


def prepass_color_imbalance(device: str):
    """Run (l)'s pre-pass (``examples/fl_color_imbalance.py:93-101``):
    ``color_imbalance_split(0, 256)``, then for each collaborator
    ``run_prepass`` with the CIFAR CNN and the paper's CIFAR FC AE
    (``cifar_ae_for(550,586)``: 550,586 → 320, no hidden layer), 5
    pre-pass epochs and a 6-epoch AE fit. Returns (datasets, eval data, AE
    config, AE params a collaborator, AE loss histories)."""
    import torch
    from repro_torch.configs.paper import CIFAR_CLASSIFIER, cifar_ae_for
    from repro_torch.core import run_prepass
    from repro_torch.data.pipeline import color_imbalance_split
    datasets, ev = color_imbalance_split(0, 256)
    ae_cfg = cifar_ae_for(CIFAR_PARAMS)
    aes, hists = [], []
    for ci, d in enumerate(datasets):
        out = run_prepass(torch.Generator().manual_seed(10 + ci),
                          CIFAR_CLASSIFIER, ae_cfg, d, prepass_epochs=5,
                          ae_epochs=6, device=device)
        aes.append(out["ae_params"])
        hists.append(out["ae_history"]["loss"])
        del out
    return datasets, ev, ae_cfg, aes, hists


def build_color_imbalance(prepass, device: str, rounds: int):
    """Run (l): the paper's §5.2 two-collaborator federation (collaborator
    0 colour, 1 grayscale), the CIFAR CNN, payload "weights" (the
    converged weights cross the wire), each collaborator its own
    ``FCAECompressor`` from its pre-pass, ``AELifecycle(**LIFECYCLE_L)``."""
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core import (AELifecycle, FCAECompressor, FederatedRun,
                                  FLConfig)
    datasets, ev, ae_cfg, aes, _ = prepass
    return FederatedRun(
        CIFAR_CLASSIFIER, datasets,
        FLConfig(n_rounds=rounds, local_epochs=1, payload="weights", seed=0),
        compressors=[FCAECompressor(p, ae_cfg) for p in aes],
        eval_data=ev, device=device, lifecycle=AELifecycle(**LIFECYCLE_L))


RECORD_BYTES = ("bytes_up", "bytes_up_raw", "bytes_up_measured",
                "bytes_down", "bytes_down_raw", "bytes_decoder", "ae_syncs",
                "participants", "staleness", "sim_time")


def tensors_of(run) -> dict:
    """Everything a resume must reproduce, by name: global params, and per
    client its residual, dispatch snapshot, snapshot rings and codec
    params (the same reading of an eager list and of a struct-of-arrays
    pool)."""
    from repro_torch.core.pytree import leaves
    out = {"global": leaves(run.global_params)}
    for ci, (st, comp) in enumerate(zip(run.clients, run.compressors)):
        rings = {name: list(ring) for name, ring in st.part_snapshots.items()}
        out[f"client {ci}"] = leaves([st.residual, st.dispatched,
                                      list(st.snapshots), rings])
        out[f"codec {ci}"] = leaves(comp.codec_params())
    return out


def scalars_of(st) -> tuple:
    """A client's lifecycle scalars, read alike from a ``ClientState`` and
    a pool's view (a baseline set to None reads as never set)."""
    return (st.version, st.last_refresh, st.ae_baseline,
            dict(st.part_last_refresh.items()),
            {k: v for k, v in st.part_baseline.items() if v is not None})


def check_resume(tag: str, full, resumed, n_first: int) -> None:
    """A resumed run against the uninterrupted one: every tensor of
    :func:`tensors_of` ``torch.equal``; the lifecycle scalars and every
    record after the save point equal, bytes included."""
    import torch
    a, b = tensors_of(full), tensors_of(resumed)
    require(a.keys() == b.keys(), f"{tag}: state layouts differ")
    for k in a:
        require(len(a[k]) == len(b[k])
                and all(torch.equal(x, y) for x, y in zip(a[k], b[k])),
                f"{tag}: {k} differs from the uninterrupted run")
    for sa, sb in zip(full.clients, resumed.clients, strict=True):
        require(scalars_of(sa) == scalars_of(sb),
                f"{tag}: lifecycle scalars differ")
    for x, y in zip(full.history[n_first:], resumed.history, strict=True):
        require(x.round == y.round, f"{tag}: rounds differ")
        for k in RECORD_BYTES:
            require(getattr(x, k) == getattr(y, k),
                    f"{tag}: round {x.round} {k} differ")
        require(x.global_metrics == y.global_metrics,
                f"{tag}: round {x.round} metrics differ")


def resume_via_checkpoint(tag: str, build, n_first: int, n_rest: int,
                          device: str, build_resumed=None):
    """Play ``n_first`` rounds of ``build(n_first)``, ``save_state``, load
    into a fresh ``build_resumed(n_rest)`` (``build`` by default) and play
    the rest. Returns (resumed run, its per-round plays, checkpoint bytes,
    save and load seconds)."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / f"{tag}.npz"
    first = build(n_first)
    play(first, n_first, device)
    t0 = time.perf_counter()
    first.save_state(str(path))
    save_s = time.perf_counter() - t0
    del first
    resumed = (build_resumed or build)(n_rest)
    t0 = time.perf_counter()
    require(resumed.load_state(str(path)) == n_first,
            f"{tag}: restored round")
    load_s = time.perf_counter() - t0
    nbytes = path.stat().st_size
    path.unlink()
    return resumed, play(resumed, n_rest, device), nbytes, save_s, load_s


def check_kmeans() -> dict:
    """``KMeansSpec(550,586, k=16, iters=8)`` on the card against the CPU
    on one vector (a CIFAR-CNN-sized update, drawn from a seed): the
    codebook within the golden band, codes equal wherever a value is not
    within the codebooks' difference of a midpoint between neighbouring
    centroids, a second card call ``torch.equal``; and
    ``measured_bytes`` of a ``ChainCompressor([TopK 1 %, KMeans],
    entropy_coded=True)`` payload equal on the card and the CPU."""
    import torch
    from repro_torch.core import (ChainCompressor, KMeansCompressor,
                                  TopKCompressor, codec)
    spec = codec.KMeansSpec(CIFAR_PARAMS, k=16, iters=8)
    x = torch.randn((CIFAR_PARAMS,), generator=torch.Generator()
                    .manual_seed(40)) * 1e-3
    xc = x.cuda()
    cpu = codec.encode(spec, None, x)
    card = [codec.encode(spec, None, xc) for _ in range(2)]
    require(torch.equal(card[0]["codes"], card[1]["codes"])
            and torch.equal(card[0]["codebook"], card[1]["codebook"]),
            "k-means: two card calls differ")
    cb_err = close(card[0]["codebook"].cpu(), cpu["codebook"], **GOLDEN_BAND)
    cb = torch.sort(cpu["codebook"])[0]
    mids = (cb[1:] + cb[:-1]) / 2
    near = ((x[:, None] - mids[None, :]).abs()
            <= 2 * cb_err + 1e-9).any(dim=1)
    differ = card[0]["codes"].cpu() != cpu["codes"]
    require(not bool((differ & ~near).any()),
            "k-means: codes differ away from a midpoint")
    ms = host_ms(lambda: codec.encode(spec, None, xc), 10)
    chain = ChainCompressor([TopKCompressor(0.01), KMeansCompressor()],
                            entropy_coded=True)
    cspec = chain.spec(CIFAR_PARAMS)
    mb = [codec.measured_bytes(cspec, codec.encode(cspec, None, v))
          for v in (xc, x)]
    require(mb[0] == mb[1], f"measured bytes card {mb[0]} cpu {mb[1]}")
    return {"codebook_max_abs_err": cb_err,
            "codes_near_midpoint": int(near.sum()),
            "codes_differing": int(differ.sum()),
            "second_call_bit_equal": True, "encode_host_ms": ms,
            "chain_measured_bytes": mb[0],
            "chain_wire_bytes": codec.wire_bytes(cspec)}


# ------------------------------------------------------------ rate control
MLP_PARAMS = 15_910
# run (m): benchmarks/tables.py:524-620 at its FULL sizes
RATE_LATENTS = (8, 32, 128)
RATE_HIDDEN = (128,)       # as wide as the widest latent (tables.py:549)
RATE_AE_EPOCHS = 300
RATE_BUDGET = 4 * RATE_LATENTS[1] * 4.0     # the matched budget, 512 B
RATE_REFIT = dict(min_snapshots=2, refit_epochs=20, refit_batch=4)
# run (n): the CIFAR CNN's dense0 (461,088 values) on two shared chunked-AE
# rungs then q8, the other 89,498 values on q4 then q8
CNN_RATE_LATENTS = (4, 8)
CNN_RATE_CHUNK = 256
CNN_RATE_HIDDEN = (32,)
CNN_RATE_RD = dict(cooldown=2, min_snapshots=2, refit_epochs=1,
                   refit_batch=4)
# run (n)'s depth: 3 rounds (6 until PR 23; its round-3 switch-time refit
# took ~59 s a play, the first, at round 1, is kept) and a 1-epoch
# switch-time refit (at 5 epochs the round-1 refit took 43 s a play on a
# slower host, three plays, and the script passed 1,000 s)
CNN_RATE_ROUNDS = 3


def prepass_rate_ladder(device: str):
    """Run (m)'s ladder (``benchmarks/tables.py:524-620``, FULL): a
    Dirichlet(0.5) split of ``mnist_like(0, 1024)`` (128 held out) over 4
    clients (at least 16 each); per client a 24-epoch pre-pass from the
    run's own initial params (``FLConfig().seed``), then one FC AE a rung
    (latent 8, 32, 128 behind a 128-wide hidden layer) trained 300 epochs
    on that client's weights dataset. Returns (datasets, eval data,
    params[client][rung], (first, last) AE loss a rung)."""
    import torch
    from repro_torch.configs.paper import AEConfig, MNIST_CLASSIFIER
    from repro_torch.core import FLConfig, run_prepass, train_autoencoder
    from repro_torch.core.task import ClassifierTask
    from repro_torch.data.pipeline import (dirichlet_partition, mnist_like,
                                           train_eval_split)
    train, ev = train_eval_split(mnist_like(0, 1024), 128)
    data = dirichlet_partition(0, train, 4, alpha=0.5, min_per_client=16)
    init0 = ClassifierTask(MNIST_CLASSIFIER).init_params(
        torch.Generator().manual_seed(FLConfig().seed), device)
    params, losses = [], []
    for ci in range(4):
        out = run_prepass(
            torch.Generator().manual_seed(10 + ci), MNIST_CLASSIFIER,
            AEConfig(MLP_PARAMS, RATE_HIDDEN, RATE_LATENTS[0]), data[ci],
            prepass_epochs=24, ae_epochs=1, init_params=init0,
            device=device)
        row = []
        for latent in RATE_LATENTS:
            p, h = train_autoencoder(
                torch.Generator().manual_seed(100 + ci),
                AEConfig(MLP_PARAMS, RATE_HIDDEN, latent),
                out["weights_dataset"], epochs=RATE_AE_EPOCHS)
            row.append(p)
            losses.append((h["loss"][0], h["loss"][-1]))
        params.append(row)
    return data, ev, params, losses


def rate_policies():
    """Run (m)'s rows: each fixed rung, then the adaptive policies at the
    benchmark's settings, and RDBudget under distortion-weighted async
    staleness. ``(name, controller from a ladder, scheduler or None)``."""
    from repro_torch.core import (AsyncBuffered, ByteBudget,
                                  DistortionTarget, FixedRate, RDBudget)
    rows = [(f"fixed_r{k}",
             lambda lad, k=k: FixedRate(ladder=lad, initial_rung=k), None)
            for k in range(len(RATE_LATENTS))]
    rows += [
        ("distortion_target", lambda lad: DistortionTarget(
            ladder=lad, target=0.15, cooldown=2, **RATE_REFIT), None),
        ("byte_budget", lambda lad: ByteBudget(
            ladder=lad, budget=RATE_BUDGET, **RATE_REFIT), None),
        ("rd_budget", lambda lad: RDBudget(
            ladder=lad, budget=RATE_BUDGET, cooldown=2, **RATE_REFIT),
         None),
        ("rd_budget_async", lambda lad: RDBudget(
            ladder=lad, budget=RATE_BUDGET, cooldown=2, **RATE_REFIT),
         lambda: AsyncBuffered(buffer_k=2, distortion_power=1.0))]
    return rows


def build_rate_run(prepass, make_rc, make_sched, device: str):
    """A run (m) row on ``device``: the MNIST MLP over the pre-pass's
    split, 6 rounds x 2 local epochs, payload "weights", the controller over
    ``fc_ae_ladder`` seeded with the pre-pass's AEs (moved to ``device``)."""
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import FederatedRun, FLConfig, fc_ae_ladder
    from repro_torch.core.pytree import tree_map
    data, ev, params, _ = prepass
    ladder = fc_ae_ladder(
        4, MLP_PARAMS, latent_dims=RATE_LATENTS, hidden=RATE_HIDDEN,
        params=[[tree_map(lambda t: t.to(device), p) for p in row]
                for row in params], device=device)
    rc = make_rc(ladder)
    return FederatedRun(
        MNIST_CLASSIFIER, data,
        FLConfig(n_rounds=6, local_epochs=2, payload="weights", seed=0),
        eval_data=ev, ratecontrol=rc, device=device,
        scheduler=make_sched() if make_sched is not None else None)


def _thresholds(rc, r: int) -> dict:
    """What a policy compared its probes with at round ``r``."""
    out = {"policy": rc.name}
    for k in ("target", "margin", "budget", "cooldown"):
        if hasattr(rc, k):
            out[k] = getattr(rc, k)
    if hasattr(rc, "target"):
        out["margin_x_target"] = rc.margin * rc.target
    if hasattr(rc, "lambda_trace"):
        out["lambda"] = dict(rc.lambda_trace).get(r)
    return out


class ProbeSpy:
    """Records each batched probe (``RateController._probe``): its
    controller, round, partition group, lanes, ``(rung, lane)`` error
    matrix and the kernel launches it made. A context manager that puts
    the method back."""

    def __enter__(self):
        from repro_torch.core.ratecontrol import RateController
        from repro_torch.kernels import _lib
        self.cls, self.real, self.calls = (RateController,
                                           RateController._probe, [])
        real = self.real

        def spy(rc, specs, cols, flats, group, lanes):
            before = sum(_lib.counts().values())
            errs = real(rc, specs, cols, flats, group, lanes)
            self.calls.append(dict(
                rc=rc, round=rc.run.round_offset + len(rc.run.history),
                group=group, lanes=list(lanes), errs=errs,
                launches=sum(_lib.counts().values()) - before))
            return errs
        RateController._probe = spy
        return self

    def __exit__(self, *exc):
        self.cls._probe = self.real

    def of(self, rc) -> list:
        return [p for p in self.calls if p["rc"] is rc]


def check_rate_decisions(tag: str, card, cpu, probes: ProbeSpy) -> None:
    """Card against CPU for one controller run: switches, rung occupancy,
    participants, ``bytes_up`` and ``bytes_decoder`` exact. At the first
    round whose switches differ, print both sides' probe values (from
    ``probes``, which watched both runs) and the policy's thresholds, then
    fail."""
    import numpy as np
    rc_g, rc_c = card.ratecontrol, cpu.ratecontrol
    for a, b in zip(card.history, cpu.history, strict=True):
        if a.spec_switches != b.spec_switches:
            for side, rc in (("cuda", rc_g), ("cpu", rc_c)):
                for p in probes.of(rc):
                    if p["round"] == a.round:
                        log(f"{tag} r{a.round} {side} probe group "
                            f"{p['group']} lanes {p['lanes']}: "
                            + json.dumps(np.asarray(p["errs"]).tolist()))
            log(f"{tag} r{a.round} thresholds "
                + json.dumps(_thresholds(rc_g, a.round)))
            raise AssertionError(
                f"{tag}: round {a.round} switches differ card "
                f"{a.spec_switches} cpu {b.spec_switches}")
        for k in ("bytes_up", "bytes_up_raw", "bytes_decoder", "ae_syncs",
                  "participants", "staleness"):
            require(getattr(a, k) == getattr(b, k),
                    f"{tag}: round {a.round} {k} differ")
    if rc_g._partitioned:
        require(all(np.array_equal(rc_g._prung[n], rc_c._prung[n])
                    for n in rc_g._prung), f"{tag}: occupancy differs")
    else:
        require(np.array_equal(rc_g._rung, rc_c._rung),
                f"{tag}: occupancy differs")


def cnn_rate_data(n_clients: int):
    """Run (n)'s shards: ``cifar_like(0, 64 n + 256)``, 256 held out,
    ``n`` clients of 64 images."""
    from repro_torch.data.pipeline import (cifar_like, train_eval_split,
                                           uniform_partition)
    train, ev = train_eval_split(cifar_like(0, n_clients * 64 + 256), 256)
    return uniform_partition(0, train, n_clients), ev


def cnn_partition():
    """``by_layer_partition`` of the CIFAR CNN into ``dense0`` (461,088
    values, one contiguous run) and ``rest`` (89,498 values over twelve
    slices: the convs before it and the dense layers after)."""
    import torch
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core import by_layer_partition
    from repro_torch.models.classifiers import init_classifier
    tmpl = init_classifier(torch.Generator().manual_seed(0),
                           CIFAR_CLASSIFIER, "cpu")
    return by_layer_partition(
        tmpl, key_fn=lambda path: ("dense0" if path.startswith("dense0/")
                                   else "rest"))


def prefit_cnn_rungs(device: str, prepass_epochs: int = 8,
                     fit_epochs: int = 30, warmup_rounds: int = 2):
    """Run (n)'s two AE rungs, each fitted once and shared by every client
    (one ``ChunkedAEConfig(256, (32,), latent)`` AE a rung, batch 256), on
    every 256-chunk of dense0 segments as the rows (as the lifecycle's
    ``_refit_dataset`` builds them for a chunked lane). The latent-4 rung's
    segments: a pre-pass (``local_train`` from the run's initial CIFAR CNN
    params over run (n)'s 512 images, a weights snapshot an epoch). The
    latent-8 rung's: what run (n)'s 8 lanes send in the last round of a
    ``warmup_rounds`` warm-up of run (n) with every lane on its cheapest
    rung — the traffic that run (n)'s first plan probes, since no lane can
    move before it holds ``min_snapshots=2``. (Round 0 sends the random
    initial weights plus one step, which no AE compresses; a rung fitted
    on them codes later rounds no better than latent 4, and is never
    bought.) Returns (configs, params, (first, last) loss a rung)."""
    import torch
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core import ChunkedAEConfig, partition, local_train
    from repro_torch.core import train_autoencoder
    from repro_torch.core.autoencoder import chunk_vector
    from repro_torch.core.task import ClassifierTask
    shards, _ = cnn_rate_data(8)
    data = {k: torch.cat([s[k] for s in shards]).to(device)
            for k in shards[0]}
    init0 = ClassifierTask(CIFAR_CLASSIFIER).init_params(
        torch.Generator().manual_seed(0), device)
    _, snaps, _ = local_train(init0, CIFAR_CLASSIFIER, data,
                              epochs=prepass_epochs, seed=0,
                              snapshot_every_epoch=True)
    dense0 = cnn_partition().slices_of("dense0")
    cfgs, aes, losses = [], [], []

    def fit(i, flats):
        segs = partition.gather(dense0, torch.stack(flats))
        rows = torch.cat([chunk_vector(s, CNN_RATE_CHUNK)[0] for s in segs])
        cfg = ChunkedAEConfig(chunk_size=CNN_RATE_CHUNK,
                              hidden=CNN_RATE_HIDDEN,
                              latent_chunk=CNN_RATE_LATENTS[i])
        p, h = train_autoencoder(torch.Generator().manual_seed(60 + i),
                                 cfg.as_fc(), rows, epochs=fit_epochs,
                                 batch_size=256)
        cfgs.append(cfg)
        aes.append(p)
        losses.append((h["loss"][0], h["loss"][-1]))
    fit(0, snaps)
    with ExampleEncodeSpy() as warm:
        build_rate_cnn((cfgs, aes, losses), device, rounds=warmup_rounds,
                       fixed=True).run()
    fit(1, [c["own"] for c in warm.calls if c["key"][1] == warmup_rounds - 1])
    return cfgs, aes, losses


def cnn_rate_costs(pm, cfgs, aes) -> dict:
    """Wire bytes a client of each rung of each group."""
    from repro_torch.core import codec
    out = {}
    for name, rungs in cnn_rate_rungs(pm, cfgs, aes, "cpu").items():
        n = pm.group_size(name)
        comps = [f(0, n) for f in rungs]
        out[name] = [codec.wire_bytes(c.spec(n), c.codec_params())
                     for c in comps]
    return out


def cnn_rate_rungs(pm, cfgs, aes, device: str) -> dict:
    """Rung factories: dense0 on each shared AE of ``aes`` (the latent-4,
    then the latent-8; kernel path, marked ``prefit``), then q8; rest on q4
    then q8."""
    from repro_torch.core import ChunkedAECompressor, QuantizeCompressor
    from repro_torch.core.pytree import tree_map
    shared = [tree_map(lambda t: t.to(device), p) for p in aes]

    def ae_rung(i):
        def make(ci, n):
            comp = ChunkedAECompressor(shared[i], cfgs[i], use_kernel=True)
            comp.prefit = True
            return comp
        return make
    return {"dense0": [ae_rung(i) for i in range(len(aes))]
            + [lambda ci, n: QuantizeCompressor(bits=8)],
            "rest": [lambda ci, n: QuantizeCompressor(bits=4),
                     lambda ci, n: QuantizeCompressor(bits=8)]}


def build_rate_cnn(rungs_fit, device: str, n_clients: int = 8,
                   rounds: int = 6, fixed: bool = False):
    """Run (n): ``SyncFedAvg`` over the CIFAR CNN at full width, ``n``
    clients of 64 images, 1 local epoch, payload "weights", the grouped
    server round (``use_grouped_kernel=True``), a per-partition ladder
    (:func:`cnn_rate_rungs`) under ``RDBudget(cooldown=2, min_snapshots=2,
    refit_epochs=1, refit_batch=4)`` with the budget halfway between the
    all-cheapest and the all-dearest plan of the cohort; ``fixed`` holds
    every lane on its cheapest rung instead (``FixedRate``)."""
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core import (FederatedRun, FixedRate, FLConfig,
                                  RDBudget, partition_ladder)
    cfgs, aes, _ = rungs_fit
    pm = cnn_partition()
    costs = cnn_rate_costs(pm, cfgs, aes)
    budget = n_clients * (sum(c[0] for c in costs.values())
                          + sum(c[-1] for c in costs.values())) / 2
    data, ev = cnn_rate_data(n_clients)
    ladder = partition_ladder(n_clients, pm,
                              cnn_rate_rungs(pm, cfgs, aes, device))
    rc = (FixedRate(ladder=ladder, partition=pm) if fixed else
          RDBudget(ladder=ladder, partition=pm, budget=budget,
                   **CNN_RATE_RD))
    return FederatedRun(
        CIFAR_CLASSIFIER, data,
        FLConfig(n_rounds=rounds, local_epochs=1, payload="weights",
                 use_grouped_kernel=True, seed=0),
        eval_data=ev, ratecontrol=rc, device=device)


class GroupedSpy:
    """Records each grouped decode→aggregate launch's buckets ``(C_b,
    M_b)``, K, N and decoder slots (``partition._grouped_round`` calls
    ``grouped_fused_decode_agg_decoders`` once a launch). A context
    manager that puts the function back."""

    def __enter__(self):
        from repro_torch.kernels import fused_decode_agg as mod
        self.mod, self.real = mod, mod.grouped_fused_decode_agg_decoders
        self.calls = []

        def spy(hs, ws, decoders, dec_idx, *a, **kw):
            self.calls.append(dict(
                buckets=[list(h.shape[:2]) for h in hs],
                K=int(hs[0].shape[-1]), N=int(decoders[0][0].shape[-1]),
                dec_idx=list(dec_idx)))
            return self.real(hs, ws, decoders, dec_idx, *a, **kw)
        mod.grouped_fused_decode_agg_decoders = spy
        return self

    def __exit__(self, *exc):
        self.mod.grouped_fused_decode_agg_decoders = self.real


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def step_rule(tag: str, card_in, card_out, cpu_in, cpu_out, lr: float,
              t: int, card_g, cpu_g, rep: dict) -> None:
    """One Adam step, card against CPU (flat tensors on the CPU): the
    gradient the CPU took in the golden band of the card's, and every
    value of the CPU's result in the band of the card's, except where both
    devices' update is partial (smaller than 0.99 lr) on a gradient at
    rounding level: at a fit's first step (t 1, where a partial update
    means a gradient under 99 times Adam's eps) or, later, where both
    gradients are under 99 eps. There the rounding decides the gradient's
    size and sign, and Adam's normalization turns it into a step of up to
    lr either way. Adds to ``rep``'s ``grad_max_abs_err``,
    ``grad_values``, ``full_max_abs_err``, ``partial_steps`` (exempt
    values a step moved on either device), ``partial_out_of_band`` and
    ``partial_max_abs_err``."""
    try:
        err = close(card_g, cpu_g, **GOLDEN_BAND)
    except AssertionError as e:
        raise AssertionError(f"{tag}: gradient: {e}") from None
    rep["grad_max_abs_err"] = max(rep.get("grad_max_abs_err", 0.0), err)
    rep["grad_values"] = rep.get("grad_values", 0) + card_g.numel()
    ug, uc = card_out - card_in, cpu_out - cpu_in
    partial = (ug.abs() < 0.99 * lr) & (uc.abs() < 0.99 * lr)
    if t != 1:
        tiny = 99 * ADAM_EPS
        partial &= (card_g.abs() < tiny) & (cpu_g.abs() < tiny)
    d = (card_out - cpu_out).abs()
    out = d > GOLDEN_BAND["atol"] + GOLDEN_BAND["rtol"] * cpu_out.abs()
    bad = out & ~partial
    require(not bool(bad.any()),
            f"{tag}: {int(bad.sum())} params out of the band, not a "
            f"partial step on a rounding-level gradient, max {_max(d[bad])}")
    rep["full_max_abs_err"] = max(rep.get("full_max_abs_err", 0.0),
                                  _max(d[~partial]))
    rep["partial_steps"] = rep.get("partial_steps", 0) + int(
        (partial & ((ug != 0) | (uc != 0))).sum())
    rep["partial_out_of_band"] = (rep.get("partial_out_of_band", 0)
                                  + int((out & partial).sum()))
    rep["partial_max_abs_err"] = max(rep.get("partial_max_abs_err", 0.0),
                                     _max(d[partial]))


def hold_payload(tag: str, card, cpu, rep: dict) -> None:
    """One payload, card against CPU: its floats in the golden band, its
    integer codes exact. Adds to ``rep``'s ``payload`` (largest float
    difference), ``payload_floats`` and ``codes``."""
    import torch
    from repro_torch.core.pytree import leaves
    for a, b in zip(leaves(card), leaves(cpu), strict=True):
        a, b = a.cpu(), b.cpu()
        if a.dtype.is_floating_point:
            try:
                err = close(a, b, **GOLDEN_BAND)
            except AssertionError as e:
                raise AssertionError(f"{tag}: payload: {e}") from None
            rep["payload"] = max(rep.get("payload", 0.0), err)
            rep["payload_floats"] = rep.get("payload_floats", 0) + a.numel()
        else:
            require(torch.equal(a, b), f"{tag}: payload codes differ in "
                    f"{int((a != b).sum())} of {a.numel()}")
            rep["codes"] = rep.get("codes", 0) + a.numel()


def rate_cnn_replay(fit, n_clients: int = 2, rounds: int = 3) -> tuple:
    """Run (n)'s reduced copy on the card and on the CPU, the CPU replaying
    the card's record as run (ac) does (:class:`ExampleSpies`: every Adam
    step's gradient and result, each local training's start, the CNN's
    ReLU and max-pool decisions at ties within the band, the switch-time
    refits, each client's encode input and every quantizer input, held and
    then taken from the card), so a code boundary or a tie that the two
    devices straddle by rounding cannot fork the trajectories
    (:func:`rate_cnn_witness` shows that they do). Held besides: the
    global params, loss and accuracy after every round, the controllers'
    probed distortions and ladder params in the golden band; the
    switches, occupancy, bytes and the rest of the controller state
    exact. Returns what it measured and both runs' final flat params."""
    import torch
    from repro_torch.core.pytree import leaves, ravel
    tag = f"rate (n) reduced ({n_clients} clients, {rounds} rounds)"
    runs, params, record = {}, {}, None
    with ProbeSpy() as probes:
        for dev in ("cuda", "cpu"):
            params[dev] = []
            with ExampleSpies(record, tag) as spies:
                run = build_rate_cnn(fit, dev, n_clients, rounds)
                for r in range(rounds):
                    run.history.append(run.scheduler.run_round(r))
                    params[dev].append(ravel(run.global_params)[0].cpu())
            record = spies.record()
            runs[dev] = run
    g, c = runs["cuda"], runs["cpu"]
    check_rate_decisions(tag, g, c, probes)

    def held(what, got, want) -> float:
        try:
            return close(got.cpu(), want.cpu(), **GOLDEN_BAND)
        except AssertionError as e:
            raise AssertionError(f"{tag}: {what}: {e}") from None
    rep = dict(spies.report(), params=[], distortion=0.0, ladder=0.0)
    for r, (pg, pc) in enumerate(zip(params["cuda"], params["cpu"])):
        rep["params"].append(held(f"round {r} global params", pg, pc))
    for a, b in zip(g.history, c.history, strict=True):
        for k in ("loss", "accuracy"):
            held(f"round {a.round} {k}", torch.tensor(a.global_metrics[k]),
                 torch.tensor(b.global_metrics[k]))
    mg, mc = g.ratecontrol.state_meta(), c.ratecontrol.state_meta()
    dg, dc = mg.pop("distortion"), mc.pop("distortion")
    require(mg == mc and dg.keys() == dc.keys(),
            f"{tag}: controller state differs")
    rep["distortion"] = held("probed distortions",
                             torch.tensor(list(dg.values())),
                             torch.tensor(list(dc.values())))
    for a, b in zip(leaves(g.ratecontrol.state_tree()),
                    leaves(c.ratecontrol.state_tree()), strict=True):
        rep["ladder"] = max(rep["ladder"], held("ladder params", a, b))
    rep["switches"] = [r.spec_switches for r in g.history]
    return rep, params["cuda"][-1], params["cpu"][-1]


def rate_cnn_witness(fit, card_final, n_clients: int = 2,
                     rounds: int = 3) -> dict:
    """Why :func:`rate_cnn_replay` replays the card's local models: run
    (n)'s reduced copy runs free on the CPU twice, once from initial params
    nudged up by one ulp. Returns per group the parameters out of the
    golden band and the largest difference, for the card's free run
    (``card_final``, the replay's card side) against the free CPU run, and
    for the two free CPU runs."""
    import torch
    from repro_torch.core.pytree import ravel, tree_map
    finals = []
    for nudge in (False, True):
        run = build_rate_cnn(fit, "cpu", n_clients, rounds)
        if nudge:
            run.global_params = tree_map(
                lambda t: torch.nextafter(t, torch.full_like(t, torch.inf)),
                run.global_params)
        run.run()
        finals.append(ravel(run.global_params)[0])
    pm = cnn_partition()
    idx = {name: torch.cat([torch.arange(o, o + n)
                            for o, n in pm.slices_of(name)])
           for name in pm.names}

    def apart(a, b) -> dict:
        d = (a - b).abs()
        out = d > GOLDEN_BAND["atol"] + GOLDEN_BAND["rtol"] * b.abs()
        return {name: dict(out_of_band=int(out[i].sum()),
                           max_abs_err=float(d[i].max()))
                for name, i in idx.items()}
    return {"card_free_vs_cpu_free": apart(card_final, finals[0]),
            "cpu_free_vs_cpu_one_ulp": apart(finals[0], finals[1])}


def controller_state_equal(tag: str, a, b) -> None:
    import torch
    from repro_torch.core.pytree import leaves
    require(a.state_meta() == b.state_meta(),
            f"{tag}: controller state differs")
    require(all(torch.equal(x, y) for x, y in zip(
        leaves(a.state_tree()), leaves(b.state_tree()), strict=True)),
        f"{tag}: controller ladder params differ")


def lane_bytes_check(tag: str, run, costs: dict) -> list:
    """Replay the records' switches from the all-rung-0 start: each
    round's ``bytes_up`` must be the wire cost of the rungs its clients
    sat on; returns the dense0 rung occupancy of each round."""
    occ = {name: [0] * len(run.clients) for name in costs}
    per_round = []
    for rec in run.history:
        want = sum(costs[name][occ[name][ci]]
                   for name in costs for ci in rec.participants)
        require(rec.bytes_up == want,
                f"{tag} r{rec.round}: bytes_up {rec.bytes_up} != {want}")
        per_round.append(list(occ["dense0"]))
        for (ci, name), old, new in rec.spec_switches:
            require(occ[name][ci] == old, f"{tag}: switch from {old}")
            occ[name][ci] = new
    return per_round


def run_rate_frontier() -> None:
    """Phase 11, run (m): the pre-pass and rung fits on the card, then each
    of :func:`rate_policies` on the card and on the CPU from the same
    ladder, held with :func:`check_rate_decisions` and
    :func:`check_cuda_vs_cpu`; one line a policy."""
    import gc
    import torch
    from repro_torch.kernels import _lib
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre_m = prepass_rate_ladder("cuda")
    torch.cuda.synchronize()
    prepass_m_s = time.perf_counter() - t0
    require(all(last < first for first, last in pre_m[3]),
            "run (m): a rung AE fit did not descend")
    log(f"rate (m) pre-pass of 4 clients and 12 rung AEs ({RATE_LATENTS}, "
        f"hidden {RATE_HIDDEN}, {RATE_AE_EPOCHS} epochs) on the card: "
        f"{prepass_m_s!r} s; AE loss (first, last) {pre_m[3]!r}")
    _lib.reset_launches()
    for name, make_rc, make_sched in rate_policies():
        res = {}
        with ProbeSpy() as probes:
            for dev in ("cuda", "cpu"):
                run = build_rate_run(pre_m, make_rc, make_sched, dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                run.run()
                if dev == "cuda":
                    torch.cuda.synchronize()
                res[dev] = (run, time.perf_counter() - t0)
        (g, g_s), (c, c_s) = res["cuda"], res["cpu"]
        check_rate_decisions(f"rate (m) {name}", g, c, probes)
        err = check_cuda_vs_cpu(f"rate (m) {name}", g, g.history, c,
                                c.history)
        rc = g.ratecontrol
        tot = g.total_bytes()
        log("rate (m) " + json.dumps(dict(
            policy=name, accuracy=g.history[-1].global_metrics["accuracy"],
            bytes_up=tot["bytes_up"], bytes_decoder=tot["bytes_decoder"],
            switches=sum(len(r.spec_switches or []) for r in g.history),
            switches_by_round=[r.spec_switches for r in g.history],
            occupancy=[rc.rung_of(ci) for ci in range(4)],
            probe_dispatches=rc.probe_dispatches,
            probe_launches=sum(p["launches"] for p in probes.of(rc)),
            lambda_trace=getattr(rc, "lambda_trace", None),
            card_s=g_s, cpu_s=c_s, params_max_abs_err_vs_cpu=err)))
        del res, g, c
    log(f"rate (m) cuda == cpu for all {len(rate_policies())} policies: "
        "switches, occupancy, bytes_up, bytes_decoder exact; loss/accuracy/"
        "params within atol=2e-5 rtol=2e-4; kernel launches "
        f"{_lib.counts()} (the FC AEs are cuBLAS matrix products)")
    del pre_m


def ae_buckets(run, name: str = "dense0") -> tuple:
    """How the next grouped round will route ``name``'s AE lanes: the
    sizes of the buckets (lanes on one AE rung) whose lanes share one
    params object, which join the kernel-5 launch, and of those whose
    lanes hold their own, which take the batched-params route."""
    buckets = {}
    for ci, comp in enumerate(run.compressors):
        sub = comp.compressors[name]
        if sub.ae_compressor() is not None:
            buckets.setdefault(sub.cfg.latent_chunk, []).append(sub.params)
    shared = sorted(len(b) for b in buckets.values()
                    if all(p is b[0] for p in b))
    own = sorted(len(b) for b in buckets.values()
                 if not all(p is b[0] for p in b))
    return shared, own


def run_rate_cnn(launches: dict) -> dict:
    """Phase 12, run (n): the shared AE rungs fitted on the card,
    ``CNN_RATE_ROUNDS`` rounds
    of :func:`build_rate_cnn` on the card (per round its launches, routes,
    kernel-5 buckets, probes, switches, refits and decoder ships), a rerun
    and a resume held to ``torch.equal``, the reduced copy on the card and
    the CPU (:func:`rate_cnn_replay`, :func:`rate_cnn_witness`). Adds run
    (n)'s counts to ``launches``; returns its ``fused_dense`` launches by
    route."""
    import gc
    import torch
    from repro_torch.core.autoencoder import decoder_sync_bytes
    from repro_torch.kernels import _lib
    from repro_torch.kernels import fused_dense as fd_mod
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    fit_n = prefit_cnn_rungs("cuda")
    torch.cuda.synchronize()
    fit_n_s = time.perf_counter() - t0
    require(all(last < first for first, last in fit_n[2]),
            "run (n): a rung AE fit did not descend")
    pm_n = cnn_partition()
    costs_n = cnn_rate_costs(pm_n, fit_n[0], fit_n[1])
    ship_n = [decoder_sync_bytes(p) for p in fit_n[1]]
    _lib.reset_launches()
    fd_mod.ROUTE_LAUNCHES.clear()
    plays_n = []
    with CohortSpy() as spy_n, GroupedSpy() as gspy, ProbeSpy() as probes:
        run_n = build_rate_cnn(fit_n, "cuda", rounds=CNN_RATE_ROUNDS)
        for _ in range(CNN_RATE_ROUNDS):
            g0, want = len(gspy.calls), ae_buckets(run_n)
            plays_n += play(run_n, 1, "cuda", spy_n)
            plays_n[-1].update(grouped=gspy.calls[g0:], routing=want)
    torch.cuda.synchronize()
    counts_n = _lib.counts()
    routes_n = dict(fd_mod.ROUTE_LAUNCHES)
    rc_n, hist_n = run_n.ratecontrol, run_n.history
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d", "fused_dense",
              "grouped_fused_decode_agg"):
        require(counts_n.get(k, 0) > 0, f"run (n) never launched {k}")
        launches[k + "_run_n"] = counts_n[k]
    occ_n = lane_bytes_check("run (n)", run_n, costs_n)
    require(any(len(set(o)) > 1 for o in occ_n),
            "run (n): no round mixed dense0 rungs")
    n_ae = len(fit_n[1])
    for rec in hist_n:
        moved = [(lane, new) for lane, _, new in rec.spec_switches
                 if lane[1] == "dense0" and new < n_ae]
        want = sorted(([(ci, "dense0") for ci in range(8)]
                       if rec.round == 0 else []) + [ln for ln, _ in moved])
        require(rec.ae_syncs == want and rec.bytes_decoder
                == 8 * ship_n[0] * (rec.round == 0)
                + sum(ship_n[new] for _, new in moved),
                f"run (n) r{rec.round}: decoder ships {rec.ae_syncs} "
                f"{rec.bytes_decoder} are not round 0's 8 initial ships "
                "and one a switch onto an AE rung")
    refit_rounds = [p["round"] for p in plays_n if p["refits"]]
    require(refit_rounds, "run (n): no switch-time refit")
    first_refit = refit_rounds[0]
    require(any(new == 1 for r in hist_n[first_refit:first_refit + 1]
                for (_, name), _, new in r.spec_switches
                if name == "dense0"),
            "run (n): the first refit round bought no latent-8 lane")
    for p in plays_n:
        got = sorted(b[0] for c in p["grouped"] for b in c["buckets"])
        require(got == p["routing"][0],
                f"run (n) round {p['round']}: kernel-5 buckets {got}, "
                f"lanes sharing a decoder {p['routing'][0]}")
        if p["round"] <= first_refit:
            require(p["launches"].get("grouped_fused_decode_agg", 0) == 1,
                    f"run (n) round {p['round']}: kernel 5 must launch "
                    "once while the lanes share the decoders")
    require(any(p["routing"][1] for p in plays_n[first_refit + 1:]),
            "run (n): no refit lane's bucket took the batched-params route")
    require(any([8, 1802] in c["buckets"] for p in plays_n
                for c in p["grouped"]),
            "run (n): the 8-client latent-4 bucket never launched")
    probe_launches = sum(p["launches"] for p in probes.of(rc_n))
    log(f"rate (n) RDBudget({CNN_RATE_RD}, budget "
        f"{rc_n.budget!r}) over the CIFAR CNN ({CIFAR_PARAMS} params), 8 "
        f"clients, partitions {[(n, pm_n.group_size(n)) for n in pm_n.names]}"
        f", wire bytes a rung {costs_n}, decoder ship {ship_n}; rungs fitted "
        f"on the card in {fit_n_s!r} s, AE loss (first, last) {fit_n[2]!r}; "
        f"launches {counts_n}, fused_dense by route {routes_n}; probes "
        f"{rc_n.probe_dispatches}, {probe_launches} kernel launches; first "
        f"switch-time refit at round {first_refit}")
    for p, rec, occ in zip(plays_n, hist_n, occ_n):
        probed = [(q["group"], q["launches"], q["errs"].round(6).tolist())
                  for q in probes.of(rc_n) if q["round"] == rec.round]
        log(f"rate (n) r{rec.round}: {p['s']!r} s (host clock), dense0 rungs "
            f"{occ}, launches {p['launches']}, fused_dense by route "
            f"{p['routes']}, kernel-5 launches {p['grouped']}, AE buckets "
            f"(shared, own params) {p['routing']}, probes (group, launches, "
            f"errors) {probed}, switches {rec.spec_switches}, ae_syncs "
            f"{rec.ae_syncs}, bytes_up {rec.bytes_up!r}, bytes_decoder "
            f"{rec.bytes_decoder!r}, refits {p['refits']}, lambda "
            f"{dict(rc_n.lambda_trace).get(rec.round)!r}, loss "
            f"{rec.global_metrics['loss']!r}")
    run_n2 = build_rate_cnn(fit_n, "cuda", rounds=CNN_RATE_ROUNDS)
    play(run_n2, CNN_RATE_ROUNDS, "cuda")
    check_resume("run (n) rerun", run_n, run_n2, 0)
    controller_state_equal("run (n) rerun", rc_n, run_n2.ratecontrol)
    del run_n2
    res_n, plays_nr, nbytes_n, save_n, load_n = resume_via_checkpoint(
        "run_n", lambda n: build_rate_cnn(fit_n, "cuda", rounds=n),
        CNN_RATE_ROUNDS - 1, 1, "cuda")
    check_resume("run (n) resume", run_n, res_n, CNN_RATE_ROUNDS - 1)
    controller_state_equal("run (n) resume", rc_n, res_n.ratecontrol)
    k5_nr = [p["launches"].get("grouped_fused_decode_agg", 0)
             for p in plays_nr]
    log(f"rate (n) saved after round {CNN_RATE_ROUNDS - 2} ({nbytes_n} B, "
        f"{save_n!r} s), loaded into a fresh run ({load_n!r} s), round "
        f"{CNN_RATE_ROUNDS - 1} "
        f"({[p['s'] for p in plays_nr]!r} s, kernel-5 launches "
        f"{k5_nr}): params, codec params, snapshot rings, controller "
        "state and "
        "records torch.equal / equal to the uninterrupted run (which a "
        "rerun reproduced bit for bit)")
    del res_n, run_n
    gc.collect()
    torch.cuda.empty_cache()
    rep, card_final, _ = rate_cnn_replay(fit_n)
    log("rate (n) reduced (2 clients, 3 rounds) on the card and the CPU, "
        "the CPU encoding the card's local models: switches, occupancy, "
        "bytes, controller state and payload codes exact; payload floats, "
        "global params a round, loss, accuracy, probed distortions and "
        "ladder params within atol=2e-5 rtol=2e-4, local models too but "
        "where both devices' Adam step is partial (< 0.99 lr) "
        + json.dumps(rep))
    log("rate (n) reduced, free-running trajectories (parameters out of "
        "the band, largest difference, by group) "
        + json.dumps(rate_cnn_witness(fit_n, card_final)))
    del fit_n
    torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    return routes_n


# ------------------------------------------------------ the serve loop (o)
SERVE_N = 1_000_000
SERVE_CFG = dict(jitter=0.4, straggler_frac=0.05, seed=0)   # tables.py:929


def serve_rows(device: str) -> list:
    """Run (o)'s rows, ``benchmarks/tables.py:905-953`` at FULL (N 10^6,
    one warm-up round), the AE row on the kernel path, and one row at a
    model's full width: the CIFAR CNN's 550,586 values through run (i)'s
    composed kernel-path chunked AE, N 1,000, K 100
    (``PAPER_SCALE_SCENARIO``). Each is (name, spec, codec params, N, K,
    timed rounds)."""
    import torch
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  ComposedCompressor, codec, init_chunked_ae)
    q8 = codec.QuantizeSpec(size=1 << 16, bits=8, block=256)
    ae_cfg = ChunkedAEConfig(256, (32,), 8)
    ae = init_chunked_ae(torch.Generator().manual_seed(0), ae_cfg, device)
    cnn_ae = init_chunked_ae(torch.Generator().manual_seed(2),
                             ChunkedAEConfig(), device)
    cnn_ae["norm"] = {"mean": torch.zeros((), device=device),
                      "std": torch.full((), 1e-3, device=device)}
    cnn = ComposedCompressor(ChunkedAECompressor(cnn_ae, ChunkedAEConfig(),
                                                 use_kernel=True), bits=8)
    return [
        ("serve_q8_c256", q8, None, SERVE_N, 256, 3),
        ("serve_q8_c4096", q8, None, SERVE_N, 4096, 2),
        ("serve_q8_c65536", codec.QuantizeSpec(size=1 << 10, bits=8,
                                               block=1 << 10),
         None, SERVE_N, 65_536, 2),
        ("serve_ae_c256", codec.ChunkedAESpec(size=1 << 16, cfg=ae_cfg,
                                              use_kernel=True),
         ae, SERVE_N, 256, 3),
        ("serve_cnn_c100", cnn.spec(CIFAR_PARAMS), cnn.codec_params(),
         1000, 100, 3),
    ]


def check_serve_invariants(tag: str, st: dict, r: int, n: int, k: int,
                           prev_clock: float) -> float:
    """``tests/test_serve.py:28-53`` on the card after round ``r`` (from
    0): the version up by one, the clock monotone, every client one
    finite in-flight dispatch with a distinct seq, the re-dispatched
    cohort after the clock, no client version past the global one."""
    import torch
    clock = float(st["clock"])
    require(int(st["version"]) == r + 1, f"{tag}: version")
    require(clock >= prev_clock, f"{tag}: clock went back")
    require(bool(torch.isfinite(st["times"]).all()), f"{tag}: times")
    require(int(torch.unique(st["seqs"]).numel()) == n, f"{tag}: seqs")
    nxt = int(st["next_seq"])
    require(nxt == n + (r + 1) * k, f"{tag}: next_seq")
    recent = st["seqs"] >= nxt - k
    require(int(recent.sum()) == k
            and bool((st["times"][recent] >= clock).all()),
            f"{tag}: re-dispatched arrivals")
    require(int(st["versions"].max()) <= int(st["version"]),
            f"{tag}: versions")
    return clock


def busy_ms(events) -> float:
    """Union of the device kernels' intervals (``torch.profiler``
    events), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3                         # profiler times are in us


def traced_round(fn, top: int = 6, width: int = 60) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (ended by a
    synchronize), device kernels launched, device busy ms, the idle share
    of the wall time and the ``top`` kernels that took longest (ms summed
    by name, names cut to ``width`` characters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kern)
    by_name = {}
    for e in kern:
        by_name[e.name[:width]] = by_name.get(e.name[:width], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    return {"wall_ms": wall, "device_kernels": len(kern),
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:top]}


SERVE_WINDOW_S = 1.0      # the least host-clock window a throughput reading
SERVE_WINDOWS = 3         # readings a row: their median and range


def serve_windows(cfg, params, us: float, rounds: int, group=None) -> dict:
    """``SERVE_WINDOWS`` fresh ``run_serve`` calls (warm-up 1) that each
    timed at least ``SERVE_WINDOW_S`` seconds of rounds: the median
    reading, the range and the windows. ``us`` (an earlier reading's µs a
    round) sizes the first window. A sharded step over more than one rank
    agrees with the other ranks on each window's rounds (the most any rank
    asks) and on whether a reading counts (every rank's filled its
    window), so the ranks' all-reduces pair up."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.serve import run_serve
    world = dist.get_world_size(group) if cfg.shard else 1

    def agree(x: float, op) -> float:
        if world == 1:
            return x
        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=group)
        return t.item()
    reads = []
    while len(reads) < SERVE_WINDOWS:
        # as many rounds as the last reading says fill the window with a
        # fifth to spare; a reading that still falls short is taken again
        window = int(agree(max(rounds, math.ceil(
            1.2 * SERVE_WINDOW_S * 1e6 / us)), dist.ReduceOp.MAX))
        x = run_serve(cfg, window, params, warmup=1, group=group)[1]
        us = x["us_per_round"]
        if agree(window * us / 1e6, dist.ReduceOp.MIN) >= SERVE_WINDOW_S:
            reads.append(dict(x, window_rounds=window,
                              window_s=window * us / 1e6))
    reads.sort(key=lambda x: x["rounds_per_sec"])
    timed = {key: reads[len(reads) // 2][key] for key in
             ("rounds_per_sec", "bytes_per_sec", "us_per_round")}
    for key in list(timed):
        timed[key + "_range"] = [min(x[key] for x in reads),
                                 max(x[key] for x in reads)]
    return dict(timed, window_rounds=[x["window_rounds"] for x in reads],
                window_s=[x["window_s"] for x in reads])


def serve_row(name, spec, params, n: int, k: int, rounds: int) -> dict:
    """One row of run (o): ``run_serve`` (warm-up 1, ``rounds`` timed); the
    same rounds again one at a time, each round's host time (the step's
    enqueue on the host clock) against its device time (CUDA events), its
    kernel launches and allocated memory, and the invariants; the two
    final states ``torch.equal`` (two fresh runs); one more round traced
    (device kernels, idle share). The throughput is ``SERVE_WINDOWS``
    fresh ``run_serve`` calls that each timed at least ``SERVE_WINDOW_S``
    seconds of rounds: the median reading and the range. Each memory reading follows a ``gc.collect()``, so no
    earlier phase's garbage freed between two readings can move them."""
    import gc
    import torch
    from repro_torch.core import codec
    from repro_torch.core.serve import (ServeConfig, init_state, make_step,
                                        round_bytes, run_serve)
    from repro_torch.kernels import _lib
    cfg = ServeConfig(n_clients=n, buffer_k=k, spec=spec, **SERVE_CFG)
    require(round_bytes(cfg, params) == k * codec.wire_bytes(spec, params),
            f"{name}: round_bytes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    final, report = run_serve(cfg, rounds, params, warmup=1)
    step, st = make_step(cfg, params), init_state(cfg, params)
    per, clock = [], -1.0
    for r in range(1 + rounds):
        c0 = _lib.counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        st = step(st)
        host = (time.perf_counter() - t0) * 1e3
        e1.record()
        torch.cuda.synchronize()
        c1 = _lib.counts()
        gc.collect()
        per.append({"host_ms": host, "device_ms": e0.elapsed_time(e1),
                    "launches": {x: v - c0.get(x, 0) for x, v in c1.items()
                                 if v - c0.get(x, 0)},
                    "allocated": torch.cuda.memory_allocated()})
        clock = check_serve_invariants(name, st, r, n, k, clock)
    for key in final:
        require(torch.equal(final[key], st[key]),
                f"{name}: two fresh runs differ in {key}")
    require(per[0]["launches"]
            and all(p["launches"] == per[0]["launches"] for p in per),
            f"{name}: launches a round differ: "
            f"{[p['launches'] for p in per]}")
    require(len({p["allocated"] for p in per}) == 1,
            f"{name}: allocated memory not flat: "
            f"{[p['allocated'] for p in per]}")
    peak = torch.cuda.max_memory_allocated()
    holder = [st]
    trace = traced_round(lambda: holder.append(step(holder.pop())))
    require(math.isfinite(float(holder[0]["global_flat"].abs().max())),
            f"{name}: global model not finite")
    del holder, st, final, step
    timed = serve_windows(cfg, params, report["us_per_round"], rounds)
    return dict(name=name, n_clients=n, cohort=k, full_timed_rounds=rounds,
                **timed, round_bytes=report["round_bytes"],
                sim_time=report["sim_time"],
                round_host_ms=[p["host_ms"] for p in per],
                round_device_ms=[p["device_ms"] for p in per],
                launches_a_round=per[0]["launches"],
                allocated_after_round_1=per[0]["allocated"],
                allocated_after_last_round=per[-1]["allocated"],
                peak_allocated=peak, traced_round=trace)


class SeamDraws:
    """Numpy draws for ``core/serve.py``'s two seams (``_uniform``,
    ``synthetic_payloads``), as ``tests/test_torch_serve.py`` feeds them:
    two instances of one seed hand two devices identical arrays."""

    def __init__(self, seed: int):
        import numpy as np
        self.rng = np.random.RandomState(seed)

    def uniform(self, gen, shape):
        import numpy as np
        import torch
        return torch.from_numpy(self.rng.uniform(size=shape).astype(
            np.float32)).to(gen.device)

    def payloads(self, spec, params, k, gen):
        import numpy as np
        import torch
        from repro_torch.core import serve
        from repro_torch.core.pytree import unflatten
        treedef, leaf_sig = serve._payload_structure(
            spec, serve._signature(params))
        out = []
        for shape, dtype in leaf_sig:
            full = (k, *shape)
            if dtype.is_floating_point:
                x = self.rng.standard_normal(full).astype(np.float32)
            else:
                # q8 codes; no card row draws top-k indices, whose
                # duplicates would race in an index_put_
                require(dtype == torch.int8, f"no draw for {dtype}")
                x = self.rng.randint(-127, 128, size=full).astype(np.int8)
            out.append(torch.from_numpy(x).to(device=gen.device,
                                              dtype=dtype))
        return unflatten(treedef, out)


def serve_card_vs_cpu(name, spec, params, n: int, k: int,
                      rounds: int = 3) -> dict:
    """Run (o)'s step at a row's shape on the card and on the CPU for
    ``rounds`` rounds, both seams fed identical numpy draws: times, seqs,
    versions, the version and ``next_seq`` exact every round, the clock and
    ``global_flat`` in the golden band. Returns the largest differences."""
    import torch
    from repro_torch.core import serve
    from repro_torch.core.pytree import tree_map
    cfg = serve.ServeConfig(n_clients=n, buffer_k=k, spec=spec, **SERVE_CFG)
    seams = serve._uniform, serve.synthetic_payloads
    states = {}
    try:
        for dev in ("cuda", "cpu"):
            draws = SeamDraws(61)
            serve._uniform, serve.synthetic_payloads = (draws.uniform,
                                                        draws.payloads)
            p = None if params is None else tree_map(
                lambda t, d=dev: t.to(d), params)
            step, st = (serve.make_step(cfg, p, dev),
                        serve.init_state(cfg, p, device=dev))
            states[dev] = []
            for _ in range(rounds):
                st = step(st)
                states[dev].append({x: v.cpu().clone()
                                    for x, v in st.items()})
            del step, st
    finally:
        serve._uniform, serve.synthetic_payloads = seams
    errs = {"clock": 0.0, "global_flat": 0.0}
    for r, (g, c) in enumerate(zip(states["cuda"], states["cpu"])):
        for x in ("times", "seqs", "versions", "version", "next_seq"):
            require(torch.equal(g[x], c[x]),
                    f"{name} card vs cpu: {x} differ in round {r}")
        for x in errs:
            errs[x] = max(errs[x], close(g[x], c[x], **GOLDEN_BAND))
    return dict(name=f"{name}_card_vs_cpu", rounds=rounds, max_abs_err=errs,
                max_abs_global=float(states["cpu"][-1]["global_flat"]
                                     .abs().max()))


def run_serve_loop(launches: dict) -> list:
    """Phase 13, run (o): every row of :func:`serve_rows`; adds the run's
    kernel counts to ``launches`` as ``*_run_o``."""
    import gc
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import quantize as qz
    gc.collect()
    torch.cuda.empty_cache()
    _lib.reset_launches()
    qz.ROUTE_LAUNCHES.clear()
    out = [serve_row(*row) for row in serve_rows("cuda")]
    torch.cuda.synchronize()
    counts = _lib.counts()
    for x in ("dequantize_blocks_2d", "fused_dense", "fused_decode_agg"):
        require(counts.get(x, 0) > 0, f"run (o) never launched {x}")
    for x, v in counts.items():
        launches[f"{x}_run_o"] = v
    launches["quant_routes_run_o"] = quant_routes(counts)
    q8 = [r for r in out if r["name"].startswith("serve_q8")]
    require(all(r["launches_a_round"] == q8[0]["launches_a_round"]
                for r in q8), "run (o): kernel launches a round differ "
            "across K")
    rows = {row[0]: row for row in serve_rows("cuda")}
    for name in ("serve_q8_c256", "serve_ae_c256"):
        out.append(serve_card_vs_cpu(*rows[name][:5]))
    return out


# ------------------------------------------------- LMDeltaTask at width (q)
LM_Q = dict(arch="stablelm_1_6b", n_layers=2, clients=2, seqs=8,
            seq_len=512, batch=4)
LM_AE = dict(chunk_size=256, hidden=(32,), latent_chunk=8)


def lm_delta_arch(reduced: bool):
    """Run (q)'s model: stablelm-1.6b at full width, 2 of its 24 layers
    (remat on, the config's), float32 parameters, its own bf16 compute;
    ``reduced`` is the same
    architecture at the config's narrow widths in float32 compute."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get_config(LM_Q["arch"])
    return (cfg.reduced() if reduced
            else dataclasses.replace(cfg, n_layers=LM_Q["n_layers"]))


def build_lm_delta(arch, params, data, ev, device: str, sched=None,
                   soa: bool = False, rounds: int = 2,
                   optimizer: str = "adam"):
    """A ``FederatedRun`` of ``LMDeltaTask(arch, freeze_roles=
    ("embedding",))`` from ``params``: payload "update" with error
    feedback, batch 4, 1 local epoch, ``optimizer``, a ``by_role_partition``
    ``PartitionedCompressor`` a client — the ``mlp`` group on one shared
    kernel-path ``ChunkedAECompressor(ChunkedAEConfig(256, (32,), 8))``
    (normalizer std 1e-3, as run (k)'s), every other group on q8 at block
    256."""
    import torch
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  FederatedRun, FLConfig, LMDeltaTask,
                                  PartitionedCompressor, QuantizeCompressor,
                                  by_role_partition, init_chunked_ae)

    class _From(LMDeltaTask):
        def init_params(self, gen, dev):
            return params

    ae_cfg = ChunkedAEConfig(**LM_AE)
    ae = init_chunked_ae(torch.Generator().manual_seed(4), ae_cfg, device)
    ae["norm"] = {"mean": torch.zeros((), device=device),
                  "std": torch.full((), 1e-3, device=device)}
    pmap = by_role_partition(params)
    comps = [PartitionedCompressor(pmap, {
        name: (ChunkedAECompressor(ae, ae_cfg, use_kernel=True)
               if name == "mlp" else QuantizeCompressor(bits=8, block=256))
        for name in pmap.names}) for _ in data]
    return FederatedRun(
        _From(arch, freeze_roles=("embedding",)), data,
        FLConfig(n_rounds=rounds, local_epochs=1, batch_size=LM_Q["batch"],
                 payload="update", error_feedback=True, seed=0,
                 optimizer=optimizer),
        compressors=comps, eval_data=ev, scheduler=sched, soa_state=soa,
        device=device)


def lm_delta_data(vocab: int, seqs: int, seq_len: int):
    """Run (q)'s shards (``synthetic_lm_batch``, a seed a client) and its
    evaluation batch of 2 sequences."""
    from repro_torch.data.pipeline import synthetic_lm_batch
    data = [synthetic_lm_batch(20 + ci, vocab, seqs, seq_len)
            for ci in range(LM_Q["clients"])]
    return data, synthetic_lm_batch(99, vocab, 2, seq_len)


class GroupMeanSpy:
    """Wraps ``partition.scatter_groups`` (the last step of the
    partitioned server round and of each client's error-feedback decode):
    the largest |decoded mean| (or |decoded row|) of each group, a call
    each. A context manager that puts the function back."""

    def __enter__(self):
        from repro_torch.core import partition
        self.mod, self.real, self.calls = (partition,
                                           partition.scatter_groups, [])

        def spy(structure, means, size):
            self.calls.append({n: float(m.abs().max())
                               for n, m in means.items()})
            return self.real(structure, means, size)
        partition.scatter_groups = spy
        return self

    def __exit__(self, *exc):
        self.mod.scatter_groups = self.real


class FrozenCodesSpy:
    """Wraps ``scheduler._encode_local``: counts the q8 codes of the
    ``embedding`` group in every payload a client ships, and the nonzero
    ones among them."""

    def __enter__(self):
        import torch
        from repro_torch.core import scheduler as mod
        self.mod, self.real = mod, mod._encode_local
        self.codes = self.nonzero = 0

        def spy(*a, **kw):
            enc = self.real(*a, **kw)
            q = enc.payload["embedding"]["q"]
            self.codes += q.numel()
            self.nonzero += int(torch.count_nonzero(q))
            return enc
        mod._encode_local = spy
        return self

    def __exit__(self, *exc):
        self.mod._encode_local = self.real


def check_lm_round(tag: str, run, rec, frozen0) -> None:
    """Run (q)'s checks a round: uplink bytes = the groups' wire bytes
    summed over the cohort, finite evaluation, frozen leaves unchanged."""
    import torch
    from repro_torch.core import codec
    from repro_torch.core.partition import role_of_path
    from repro_torch.core.pytree import leaf_paths, leaves
    comp = run.compressors[0]
    wire = codec.wire_bytes(comp.spec(comp.pmap.size), comp.codec_params())
    require(rec.bytes_up == len(rec.participants) * wire,
            f"{tag} round {rec.round}: bytes_up {rec.bytes_up} != "
            f"{len(rec.participants)} x {wire}")
    require(all(math.isfinite(v) for v in rec.global_metrics.values()),
            f"{tag} round {rec.round}: eval metrics not finite")
    for (path, _, _), t, t0 in zip(leaf_paths(run.global_params),
                                   leaves(run.global_params), frozen0,
                                   strict=True):
        if role_of_path(path) == "embedding":
            require(torch.equal(t, t0), f"{tag}: frozen {path} moved")


def run_lm_delta(launches: dict) -> dict:
    """Phase 15, run (q): ``LMDeltaTask`` at full width on the card
    (:func:`lm_delta_arch`, :func:`build_lm_delta`): 2 clients of 8
    sequences of 512 tokens, ``SyncFedAvg`` for 2 rounds, then from its
    global model ``SampledSync(cohort=2)`` with ``soa_state=True`` for 2
    rounds, and that run resumed through a checkpoint after round 0
    (``torch.equal``). Adds the counts of the 2 + 2 rounds to
    ``launches`` as ``*_run_q``; returns what it measured."""
    import gc
    import torch
    from repro_torch.core import ClientPool, SampledSync
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels import _lib
    from repro_torch.kernels import quantize as qz
    from repro_torch.models.model import init_params, param_count
    gc.collect()
    torch.cuda.empty_cache()
    arch = lm_delta_arch(False)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         arch, "cuda")
    n_params = param_count(params)
    frozen0 = [t.clone() for t in leaves(params)]
    data, ev = lm_delta_data(arch.vocab_size, LM_Q["seqs"], LM_Q["seq_len"])
    _lib.reset_launches()
    qz.ROUTE_LAUNCHES.clear()
    with FrozenCodesSpy() as codes, GroupMeanSpy() as means:
        run = build_lm_delta(arch, params, data, ev, "cuda")
        plays_s = play(run, 2, "cuda")
        for rec in run.history:
            check_lm_round("run (q) sync", run, rec, frozen0)
        start = run.global_params
        del run, params
        gc.collect()
        full = build_lm_delta(arch, start, data, ev, "cuda",
                              SampledSync(cohort=2), soa=True)
        plays_p = play(full, 2, "cuda")
    torch.cuda.synchronize()
    counts = _lib.counts()
    peak = torch.cuda.max_memory_allocated()
    require(isinstance(full.clients, ClientPool), "run (q): not SoA")
    for rec in full.history:
        check_lm_round("run (q) sampled", full, rec, frozen0)
    require(codes.codes > 0 and codes.nonzero == 0,
            f"run (q): {codes.nonzero} of {codes.codes} embedding codes "
            "nonzero")
    require(len(means.calls) == 4 * 3
            and all(c["embedding"] == 0.0 for c in means.calls),
            f"run (q): embedding decodes {means.calls}")
    for x in ("quantize_blocks_2d", "dequantize_blocks_2d", "fused_dense",
              "fused_decode_agg", "flash_attention"):
        require(counts.get(x, 0) > 0, f"run (q) never launched {x}")
        launches[f"{x}_run_q"] = counts[x]
    launches["quant_routes_run_q"] = quant_routes(counts)
    require(counts["flash_attention"] == 4 * arch.n_layers,
            f"run (q): flash_attention {counts['flash_attention']}, not "
            f"{arch.n_layers} an evaluate")
    del frozen0
    res, plays_r, nbytes, save_s, load_s = resume_via_checkpoint(
        "run_q", lambda n: build_lm_delta(arch, start, data, ev, "cuda",
                                          SampledSync(cohort=2), soa=True,
                                          rounds=n), 1, 1, "cuda")
    require(isinstance(res.clients, ClientPool), "run (q): resumed layout")
    check_resume("run (q) resume", full, res, 1)
    out = dict(param_count=n_params, peak_allocated=peak,
               round_s=[p["s"] for p in plays_s + plays_p],
               launches_a_round=[p["launches"] for p in plays_s + plays_p],
               embedding_codes=codes.codes,
               group_mean_max=means.calls[-1],
               metrics=[r.global_metrics for r in full.history],
               bytes_up=full.history[-1].bytes_up,
               checkpoint_bytes=nbytes, save_s=save_s, load_s=load_s,
               resumed_round_s=[p["s"] for p in plays_r])
    del full, res, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_delta_replay(rounds: int = 3) -> dict:
    """Run (q)'s reduced copy on the card and the CPU (float32 compute, 2
    clients of 4 sequences of 64 tokens, one Adam step a client a round,
    ``SyncFedAvg``), the CPU replaying the card's record
    (:class:`ExampleSpies`, :func:`rate_cnn_replay`'s manner), so a q8
    code boundary that the two devices' training straddles by rounding
    cannot fork the runs: every Adam step's gradient and result, each
    encode's payload and the global params and metrics each round in the
    golden band, codes and bytes exact."""
    import torch
    from repro_torch.core.pytree import ravel, tree_map
    from repro_torch.models.model import init_params
    arch = lm_delta_arch(True)
    params = init_params(torch.Generator().manual_seed(0), arch, "cpu")
    data, ev = lm_delta_data(arch.vocab_size, LM_Q["batch"], 64)
    tag = "lm (q) reduced"
    runs, globs, record = {}, {}, None
    for dev in ("cuda", "cpu"):
        globs[dev] = []
        with ExampleSpies(record, tag) as spies:
            run = build_lm_delta(arch, tree_map(lambda t, d=dev: t.to(d),
                                                params),
                                 data, ev, dev, rounds=rounds)
            for r in range(rounds):
                run.history.append(run.scheduler.run_round(r))
                globs[dev].append(ravel(run.global_params)[0].cpu())
        record = spies.record()
        runs[dev] = run

    def held(what, got, want) -> float:
        try:
            return close(got.cpu(), want.cpu(), **GOLDEN_BAND)
        except AssertionError as e:
            raise AssertionError(f"{tag}: {what}: {e}") from None
    rep = dict(spies.report(), params=[])
    for r, (pg, pc) in enumerate(zip(globs["cuda"], globs["cpu"])):
        rep["params"].append(held(f"round {r} global params", pg, pc))
    for a, b in zip(runs["cuda"].history, runs["cpu"].history, strict=True):
        require(a.bytes_up == b.bytes_up, f"{tag}: bytes differ")
        for k in a.global_metrics:
            held(f"round {a.round} {k}", torch.tensor(a.global_metrics[k]),
                 torch.tensor(b.global_metrics[k]))
    return rep


# ------------------------------------------------ MLA and MoE (runs r-u)
def old_padded_route(q, k, v, scale: float, P: int = 128):
    """The route MLA's and phi-3's heads took before the kernel had their
    pairs: q, k and v zero-padded on the last axis to ``P``, the kernel
    at the unpadded scale, the first Dv columns."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    qp, kp, vp = (F.pad(t, (0, P - t.shape[-1])) for t in (q, k, v))
    return fa.flash_attention(qp, kp, vp, scale=scale)[..., :v.shape[-1]]


def check_flash_pair(B: int, S: int, H: int, D: int, Dv: int, dtype,
                     seed: int, iters: int) -> dict:
    """Kernel 6 at a head-dim pair it instantiates natively (MLA's 96
    over 64, phi-3's 96), causal, H query heads over H kv heads, against
    the plain version. ``bound_ms`` counts q, k (D) and v, the output (Dv)
    moved once, against ``2·D + 2·Dv`` operations for each (query, key)
    pair the causal mask lets through. ``library_ms`` is
    ``scaled_dot_product_attention(is_causal=True)`` on the (B, H, S, ·)
    views, with the kernels PyTorch picked for it named; ``padded_ms`` is
    the padded route (:func:`old_padded_route`: three pads, the kernel at
    128, a slice) on the same inputs, held against the plain version too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, H, Dv), generator=g, device="cuda").to(dtype)
    require(fa.kernel_pair(D, Dv), f"({D}, {Dv}) is not a kernel pair")
    n0 = fa.ROUTE_LAUNCHES.copy()
    got = fa.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    old = old_padded_route(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    routes = dict(fa.ROUTE_LAUNCHES - n0)
    require(routes == {fa.kernel_route(dtype): 2},
            f"({D}, {Dv}) launches by route {routes}")
    require(got.dtype == dtype and got.shape == v.shape, "pair output")
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = close(got, want, **tol)
    padded_err = close(old, want, **tol)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    pairs = B * H * attention_pairs(S, S, "causal", None)
    b_ms, b_by = bound(q.element_size() * (2 * B * S * H * D
                                           + 2 * B * S * H * Dv),
                       (2.0 * D + 2.0 * Dv) * pairs, dname)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = float((lib().transpose(1, 2).float() - want.float()).abs()
                    .max())
    lib_kernels = [n for n, _ in traced_round(lib, top=3)["top_kernels_ms"]]
    route = lambda: fa.flash_attention(q, k, v)              # noqa: E731
    return dict(name="flash_attention", shape=[B, S, S, H, H, D, Dv],
                mode="causal", window=None, dtype=dname,
                kernel_route=fa.kernel_route(dtype), max_abs_err=err,
                ms=time_ms(route, iters), host_ms=host_ms(route, iters),
                padded_ms=time_ms(lambda: old_padded_route(
                    q, k, v, D ** -0.5), iters),
                padded_max_abs_err=padded_err,
                plain_ms=time_ms(lambda: ref.flash_attention_ref(
                    q, k, v), iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters),
                library_call="scaled_dot_product_attention(is_causal=True)",
                library_kernels=lib_kernels, library_max_abs_err=lib_err,
                gflop=(2.0 * D + 2.0 * Dv) * pairs / 1e9)


def check_flash_padded(B: int, S: int, H: int, D: int, Dv: int, dtype,
                       seed: int, iters: int) -> dict:
    """Kernel 6's padded route (``flash_attention_padded``) at head dims it
    has no instantiation for, causal, H query heads over H kv heads: q and
    k zero-padded from D, v from Dv, to the next head dim the kernel has,
    the kernel at the unpadded scale ``D ** -0.5``, the first Dv columns;
    against the plain version on the unpadded inputs. ``ms`` is the whole
    route, ``launch_ms`` the kernel alone on padded inputs, ``pad_ms`` the
    three padding copies. ``bound_ms`` counts the unpadded work: q, k (D)
    and v, the output (Dv) moved once, against ``2·D + 2·Dv`` operations
    for each (query, key) pair the causal mask lets through.
    ``library_ms`` is ``scaled_dot_product_attention(is_causal=True,
    scale=D ** -0.5)`` on the unpadded (B, H, S, ·) views, with the
    kernels PyTorch picked for it named."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, H, Dv), generator=g, device="cuda").to(dtype)
    require(not fa.kernel_pair(D, Dv), f"({D}, {Dv}) is a kernel pair")
    scale = D ** -0.5
    n0 = fa.ROUTE_LAUNCHES.copy()
    got = fa.flash_attention_padded(q, k, v)
    want = ref.flash_attention_ref(q, k, v, scale=scale)
    torch.cuda.synchronize()
    routes = dict(fa.ROUTE_LAUNCHES - n0)
    require(routes == {fa.kernel_route(dtype) + "_padded": 1},
            f"padded ({D}, {Dv}) launches by route {routes}")
    require(got.dtype == dtype and got.shape == v.shape, "padded output")
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = close(got, want, **tol)
    P = fa.padded_head_dim(D, Dv)
    pads = ((q, P - D), (k, P - D), (v, P - Dv))
    qp, kp, vp = (F.pad(t, (0, n)) for t, n in pads)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    pairs = B * H * attention_pairs(S, S, "causal", None)
    b_ms, b_by = bound(q.element_size() * (2 * B * S * H * D
                                           + 2 * B * S * H * Dv),
                       (2.0 * D + 2.0 * Dv) * pairs, dname)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)
    lib_err = float((lib().transpose(1, 2).float() - want.float()).abs()
                    .max())
    lib_kernels = [n for n, _ in traced_round(lib, top=3)["top_kernels_ms"]]
    route = lambda: fa.flash_attention_padded(q, k, v)       # noqa: E731
    return dict(name="flash_attention", shape=[B, S, S, H, H, D, Dv],
                mode="causal", window=None, dtype=dname,
                kernel_route=fa.kernel_route(dtype) + "_padded",
                padded_head_dim=P, max_abs_err=err, ms=time_ms(route, iters),
                launch_ms=time_ms(lambda: fa.flash_attention(
                    qp, kp, vp, scale=scale), iters),
                pad_ms=time_ms(lambda: [F.pad(t, (0, n)) for t, n in pads],
                               iters),
                host_ms=host_ms(route, iters),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(
                    q, k, v, scale=scale), iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters),
                library_call="scaled_dot_product_attention(scale=D**-0.5)",
                library_kernels=lib_kernels, library_max_abs_err=lib_err,
                gflop=(2.0 * D + 2.0 * Dv) * pairs / 1e9)


def run_mla_serving(n_layers: int) -> dict:
    """Run (r): minicpm3-4b at full width (MLA: q_lora 768, kv_lora 256,
    heads of 64 + 32 over a value head of 64; tied embeddings), its own
    dtypes, serving 4 prompts of 1,024 tokens then 16 greedy decode steps.
    Kernel 6 launches once a layer in prefill at (96, 64) natively
    (``wgmma``, nothing padded), never in decode; one more prefill holds
    each layer's call against the plain version at the model's own
    inputs."""
    import torch
    from repro_torch import models
    cfg = arch_cut("minicpm3-4b", n_layers)
    m = cfg.mla
    params, batch, out = serve_full_width(cfg, seed=0)
    route = "wgmma"
    require(out["launches_prefill"] == {"flash_attention": cfg.n_layers}
            and out["routes_prefill"] == {route: cfg.n_layers},
            f"run (r) prefill launches {out['launches_prefill']} routes "
            f"{out['routes_prefill']}")
    # the same cache as GQA K (H, nope + rope) and V (H, v) per token
    per_tok_mla = m.kv_lora_rank + m.qk_rope_head_dim
    per_tok_gqa = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                 + m.v_head_dim)
    out["cache_bytes_gqa_same_heads"] = (out["cache_bytes"] * per_tok_gqa
                                         // per_tok_mla)
    require(out["cache_bytes"] == cfg.n_layers * 4 * (1024 + 16)
            * per_tok_mla * 2, f"run (r) cache bytes {out['cache_bytes']}")
    errs = in_model_flash_errs(
        lambda: models.prefill(params, cfg, batch, 1024 + 16))
    require(len(errs) == cfg.n_layers, "in-model kernel-6 checks")
    out["attention_in_model_max_abs_err"] = errs
    del params
    return out


def mla_card_vs_cpu() -> dict:
    """Run (r)'s 2-layer copy: minicpm3-4b at full width, 2 layers, float32
    compute, on the card and the CPU from the same weights (1 prompt of
    128 tokens, 4 decode steps, the CPU fed the card's tokens): logits and
    the ``c_kv``/``k_rope`` caches within ``atol=1e-4, rtol=1e-3``; the
    card's prefill launches kernel 6 at (96, 64) natively (``fma`` in
    float32, ``wgmma`` in bf16). Then a bf16-compute prefill on both, within
    twice the CPU's own bf16-vs-float32 error."""
    import torch
    from repro_torch import models
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    cfg = arch_cut("minicpm3-4b", 2, compute_dtype="float32")
    tol = dict(atol=1e-4, rtol=1e-3)
    gparams = models.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    cparams = tree_map(lambda t: t.cpu(), gparams)
    batch = synthetic_lm_batch(1, cfg.vocab_size, 1, 128)
    gbatch = {k: t.cuda() for k, t in batch.items()}
    _lib.reset_launches()
    fa.ROUTE_LAUNCHES.clear()
    glogits, gcache = models.prefill(gparams, cfg, gbatch, 132)
    torch.cuda.synchronize()
    routes = dict(fa.ROUTE_LAUNCHES)
    require(_lib.counts() == {"flash_attention": 2}
            and routes == {"fma": 2}, f"run (r) 2-layer {routes}")
    clogits, ccache = models.prefill(cparams, cfg, batch, 132)
    errs = [close(glogits.cpu(), clogits, **tol)]
    bcfg = arch_cut("minicpm3-4b", 2)                     # bfloat16 compute
    blogits, bcache = models.prefill(gparams, bcfg, gbatch, 132)
    clogits16, ccache16 = models.prefill(cparams, bcfg, batch, 132)
    bf16 = {"logits": bf16_close(blogits, clogits16, clogits, "logits")}
    for k in ("c_kv", "k_rope"):
        bf16[f"cache_{k}"] = bf16_close(bcache["layers"][k],
                                        ccache16["layers"][k],
                                        ccache["layers"][k], f"cache {k}")
    require(dict(fa.ROUTE_LAUNCHES) == {"fma": 2, "wgmma": 2},
            f"run (r) 2-layer routes {dict(fa.ROUTE_LAUNCHES)}")
    del blogits, bcache, clogits16, ccache16
    for _ in range(4):
        token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
        glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
        clogits, ccache = models.decode_step(cparams, cfg, token.cpu(),
                                             ccache)
        errs.append(close(glogits.cpu(), clogits, **tol))
    cache_err = max(close(gcache["layers"][k].cpu(), ccache["layers"][k],
                          **tol) for k in ("c_kv", "k_rope"))
    return dict(arch=cfg.name, n_layers=2,
                params=models.param_count(gparams),
                logits_max_abs_err=errs, cache_max_abs_err=cache_err,
                bf16_prefill=bf16)


class RouteSpy:
    """Wraps ``models.moe.route``: per call, the tokens routed, the
    capacity, the top-k assignments dropped by capacity (without a slot),
    the load-balance and z-loss terms (:meth:`rows`, read on the host after
    the run, so the spy adds no synchronization), and (``keep``) the
    dispatch mask on the host. A context manager that puts the function
    back."""

    def __init__(self, keep: bool = False):
        self.keep, self.calls, self.masks = keep, [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real = moe, moe.route

        def spy(logits, cfg, capacity):
            out = self.real(logits, cfg, capacity)
            d, _, (lb, zl) = out
            G, S, _ = logits.shape
            self.calls.append((G * S, capacity, G * S * cfg.moe.top_k,
                               d.detach().sum(), lb.detach(), zl.detach()))
            if self.keep:
                self.masks.append(d.detach().cpu())
            return out
        moe.route = spy
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real

    def rows(self) -> list:
        return [dict(tokens=n, capacity=c, dropped=routed - int(kept),
                     lb_loss=float(lb), z_loss=float(zl))
                for n, c, routed, kept, lb, zl in self.calls]


def run_moe_serving(arch: str, n_layers: int) -> dict:
    """Run (s): ``arch`` at full width and its own dtypes, ``n_layers``
    layers, serving 4 prompts of 1,024 tokens then 16 greedy decode steps;
    kernel 6 once a layer in prefill (GQA, head dim 128, no padding),
    never in decode; the router's counters per layer of the prefill."""
    import gc
    import torch
    cfg = arch_cut(arch, n_layers)
    with RouteSpy() as spy:
        params, _, out = serve_full_width(cfg, seed=2, spy=spy)
    require(out["launches_prefill"] == {"flash_attention": cfg.n_layers}
            and out["routes_prefill"] == {"wgmma": cfg.n_layers},
            f"run (s) {arch} prefill launches {out['launches_prefill']}")
    require(len(out["routing_prefill"]) == cfg.n_layers,
            "run (s): one route a layer")
    require(all(math.isfinite(c["lb_loss"]) and math.isfinite(c["z_loss"])
                for c in out["routing_prefill"]), "run (s) aux terms")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_card_vs_cpu(arch: str) -> dict:
    """Run (s)'s reduced copies: ``arch``'s reduced config (float32) on the
    card and the CPU from the same weights, 2 prompts of 64 tokens and 3
    decode steps (the CPU fed the card's tokens): logits and caches in the
    golden band, every dispatch mask equal."""
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    cfg = get_config(arch).reduced()
    cparams = models.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    gparams = tree_map(lambda t: t.cuda(), cparams)
    batch = synthetic_lm_batch(3, cfg.vocab_size, 2, 64)
    gbatch = {k: t.cuda() for k, t in batch.items()}
    spies, errs = {}, []
    with RouteSpy(keep=True) as spies["cuda"]:
        glogits, gcache = models.prefill(gparams, cfg, gbatch, 67)
        tokens = []
        for _ in range(3):
            tokens.append(glogits[:, :cfg.vocab_size].argmax(-1)[:, None])
            glogits, gcache = models.decode_step(gparams, cfg, tokens[-1],
                                                 gcache)
    with RouteSpy(keep=True) as spies["cpu"]:
        clogits, ccache = models.prefill(cparams, cfg, batch, 67)
        for t in tokens:
            clogits, ccache = models.decode_step(cparams, cfg, t.cpu(),
                                                 ccache)
    errs.append(close(glogits.cpu(), clogits, **GOLDEN_BAND))
    for k in gcache["layers"]:
        errs.append(close(gcache["layers"][k].cpu(), ccache["layers"][k],
                          **GOLDEN_BAND))
    a, b = spies["cuda"].masks, spies["cpu"].masks
    require(len(a) == len(b) == 4 * cfg.n_layers
            and all(torch.equal(x, y) for x, y in zip(a, b)),
            f"run (s) {arch} reduced: dispatch masks differ")
    return dict(arch=cfg.name, max_abs_err=max(errs), routes=len(a),
                dropped=[c["dropped"] for c in spies["cuda"].rows()])


def remat_on_off(arch, params, data, optimizer: str) -> dict:
    """One local step of ``LMDeltaTask(arch, freeze_roles=("embedding",))``
    with ``remat`` on and off from the same params and batch,
    deterministic algorithms on: the trained params ``torch.equal``, and
    each call's peak memory."""
    import dataclasses
    import torch
    from repro_torch.core import FLConfig, LMDeltaTask
    from repro_torch.core.pytree import leaves
    cfg = FLConfig(local_epochs=1, batch_size=LM_Q["batch"],
                   payload="update", optimizer=optimizer)
    one = {k: v[:LM_Q["batch"]].cuda() for k, v in data.items()}
    out, peaks = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (True, False):
            task = LMDeltaTask(dataclasses.replace(arch, remat=remat),
                               freeze_roles=("embedding",))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out[remat], _ = task.local_update(params, one, cfg, seed=0)
            torch.cuda.synchronize()
            peaks[remat] = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(torch.equal(a, b) for a, b in zip(
        leaves(out[True]), leaves(out[False]), strict=True)),
        f"{arch.name}: remat on/off local steps differ")
    require(any(not torch.equal(a, b) for a, b in zip(
        leaves(out[True]), leaves(params))), "remat step moved nothing")
    return dict(arch=arch.name, n_layers=arch.n_layers, equal=True,
                peak_remat_on=peaks[True], peak_remat_off=peaks[False])


LM_T = dict(arch="minicpm3-4b", n_layers=8)


def run_mla_delta(launches: dict) -> dict:
    """Run (t): ``LMDeltaTask`` on minicpm3-4b at full width, 8 of 62
    layers (remat on, the config's), ``FLConfig(optimizer="adamw")``, run
    (q)'s data shape and codec plan (:func:`build_lm_delta`: the ``mlp``
    group on an unfitted kernel-path chunked AE, the rest q8), 2
    ``SyncFedAvg`` rounds; then one local step with remat on and off from
    the trained global model (:func:`remat_on_off`). Adds the rounds'
    counts to ``launches`` as ``*_run_t``."""
    import gc
    import torch
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import init_params, param_count
    gc.collect()
    torch.cuda.empty_cache()
    arch = arch_cut(LM_T["arch"], LM_T["n_layers"])
    require(arch.remat, "run (t): the config trains with remat")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         arch, "cuda")
    n_params = param_count(params)
    frozen0 = [t.clone() for t in leaves(params)]
    data, ev = lm_delta_data(arch.vocab_size, LM_Q["seqs"], LM_Q["seq_len"])
    _lib.reset_launches()
    fa.ROUTE_LAUNCHES.clear()
    with FrozenCodesSpy() as codes:
        run = build_lm_delta(arch, params, data, ev, "cuda",
                             optimizer="adamw")
        plays = play(run, 2, "cuda")
    torch.cuda.synchronize()
    counts, routes = _lib.counts(), dict(fa.ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for rec in run.history:
        check_lm_round("run (t)", run, rec, frozen0)
    require(codes.codes > 0 and codes.nonzero == 0,
            f"run (t): {codes.nonzero} embedding codes nonzero")
    for x in ("quantize_blocks_2d", "dequantize_blocks_2d", "fused_dense",
              "fused_decode_agg", "flash_attention"):
        require(counts.get(x, 0) > 0, f"run (t) never launched {x}")
        launches[f"{x}_run_t"] = counts[x]
    require(routes == {"wgmma": 2 * arch.n_layers},
            f"run (t): kernel 6 routes {routes}, not the native route once "
            "a layer an evaluate")
    metrics = [r.global_metrics for r in run.history]
    start = run.global_params
    del run, params, frozen0
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_on_off(arch, start, data[0], "adamw")
    out = dict(param_count=n_params, peak_allocated=peak,
               round_s=[p["s"] for p in plays],
               launches_a_round=[p["launches"] for p in plays],
               routes_kernel6=routes, metrics=metrics, remat=remat)
    del start
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_moe_train_step(n_layers: int = 1) -> dict:
    """Run (u): one training step of dbrx-132b at full width, ``n_layers``
    of 40 layers with remat on, a batch of 2 x 512 tokens:
    ``models.train_loss`` under autograd, then ``make_optimizer("sgdm",
    lr, grad_clip=cfg.grad_clip)``'s update in place (no second copy of
    parameters or momentum: parameters, gradients and momentum are three
    copies of the model). ``moe_aux`` must be finite; peak memory
    printed."""
    import gc
    import torch
    from repro_torch import models
    from repro_torch.core.pytree import leaves, value_and_grad
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.kernels import _lib
    from repro_torch.optim.optimizers import global_norm, make_optimizer
    gc.collect()
    torch.cuda.empty_cache()
    cfg = arch_cut("dbrx-132b", n_layers)
    require(cfg.remat, "run (u): the config trains with remat")
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(5), cfg, "cuda")
    n_params = models.param_count(params)
    opt = make_optimizer("sgdm", cfg.learning_rate, grad_clip=cfg.grad_clip)
    state = opt.init(params)
    batch = {k: t.cuda() for k, t in
             synthetic_lm_batch(5, cfg.vocab_size, 2, 512).items()}
    norm0 = params["final_norm"]["scale"].clone()
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteSpy() as spy:
        loss, metrics, grads = value_and_grad(
            lambda p, b: models.train_loss(p, cfg, b), params, batch)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    norm = float(global_norm(grads))
    t0 = time.perf_counter()
    params, state = opt.update(params, grads, state, inplace=True)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(math.isfinite(float(loss))
            and math.isfinite(float(metrics["moe_aux"])),
            f"run (u): loss {float(loss)}, moe_aux {metrics['moe_aux']}")
    require(_lib.counts() == {}, f"run (u) launches {_lib.counts()}")
    require(not torch.equal(norm0, params["final_norm"]["scale"])
            and all(bool(torch.isfinite(m).all())
                    and float(m.abs().max()) > 0
                    for m in leaves(state["mu"])),
            "run (u): the step moved nothing, or a momentum is not finite")
    require(state["count"] == 1, "run (u): step count")
    out = dict(arch=cfg.name, n_layers=n_layers, params=n_params,
               batch=[2, 512], loss=float(loss),
               moe_aux=float(metrics["moe_aux"]),
               ce_loss=float(metrics["ce_loss"]), grad_global_norm=norm,
               routing=spy.rows(), grad_s=grad_s, update_s=update_s,
               peak_memory_bytes=peak)
    del params, grads, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------- SSM, hybrid, audio and VLM (runs v-y)
def ssd_state_check(params, cfg, batch) -> dict:
    """Run (v)'s SSD state and conv tail: layer 0's mixer in float32
    compute on its own prefill input (4 prompts of 1,024 tokens, 4 chunks
    of 256), the chunked dual form's outputs, final SSD state and conv
    tail (``mamba2_forward``) against ``mamba2_decode`` stepped over every
    token from a zero state, at the reference's SSD tolerance (``atol=1e-4,
    rtol=1e-3``, ``tests/test_model_consistency.py:100``)."""
    import dataclasses
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.common import apply_norm
    from repro_torch.models.model import _layer
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    lp = _layer(params, 0)
    tol = dict(atol=1e-4, rtol=1e-3)
    with torch.no_grad():
        x = apply_norm(lp["ln"], params["embed"][batch["tokens"]], c32)
        y, st = ssm.mamba2_forward(lp["mixer"], x, c32)
        step = ssm.init_mamba2_state(c32, x.shape[0], device="cuda")
        ys = []
        for t in range(x.shape[1]):
            y_t, step = ssm.mamba2_decode(lp["mixer"], x[:, t:t + 1], c32,
                                          step)
            ys.append(y_t)
        return dict(tokens=int(x.shape[1]),
                    out_max_abs_err=close(y, torch.cat(ys, 1), **tol),
                    ssm_state_max_abs_err=close(st["ssm"], step["ssm"],
                                                **tol),
                    conv_tail_max_abs_err=close(st["conv"], step["conv"],
                                                **tol),
                    ssm_state_abs_max=float(st["ssm"].abs().max()))


def run_ssm_serving() -> dict:
    """Run (v): mamba2-2.7b at full width (d_model 2560, 80 SSD heads of
    64, state 128, chunk 256), all 64 layers, its own dtypes, serving 4
    prompts of 1,024 tokens then 16 greedy decode steps. No kernel
    launches: the SSD scan is plain torch, as the reference's is jnp. The
    decode cache is the conv tails and SSD states, O(1) in the sequence;
    layer 0's state and tail are held against the recurrence
    (:func:`ssd_state_check`). A last prefill runs under
    ``torch.profiler`` (device idle share, the costliest kernels)."""
    import gc
    import torch
    from repro_torch import models
    from repro_torch.models.ssm import _dims
    cfg = arch_cut("mamba2-2.7b", 64)
    params, batch, out = serve_full_width(cfg, seed=0)
    require(out["params"] == 2_702_968_320,
            f"run (v) holds {out['params']} parameters")
    require(out["launches_prefill"] == {} and out["routes_prefill"] == {},
            f"run (v) prefill launches {out['launches_prefill']}")
    ssm, _, H, conv_ch = _dims(cfg)
    state_bytes = 64 * 4 * 4 * ((ssm.conv_width - 1) * conv_ch
                                + H * ssm.head_dim * ssm.d_state)
    require(out["cache_bytes"] == state_bytes,
            f"run (v) cache bytes {out['cache_bytes']}")
    out["ssd_check"] = ssd_state_check(params, cfg, batch)
    out["prefill_trace"] = traced_round(
        lambda: models.prefill(params, cfg, batch, 1024 + 16))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_family_serving(arch: str, B: int, S: int, want_calls: dict,
                       route: str) -> dict:
    """Runs (w), (x), (y): ``arch`` at full width, all layers, its own
    dtypes, serving B prompts of S tokens (with the stub frontend's inputs
    from the seed) then 16 greedy decode steps (:func:`serve_full_width`).
    Kernel 6 launches ``sum(want_calls.values())`` times a prefill, all on
    ``route``, never in decode; one more prefill holds each call against
    the plain version at the model's own inputs and counts the calls by
    ``(mode, window, q shape, k shape)``, which must equal
    ``want_calls``; a last one runs under ``torch.profiler`` (device idle
    share, the costliest kernels)."""
    import collections
    import gc
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    params, batch, out = serve_full_width(cfg, seed=0, B=B, S=S)
    n = sum(want_calls.values())
    require(out["launches_prefill"] == {"flash_attention": n}
            and out["routes_prefill"] == {route: n},
            f"{arch}: prefill launches {out['launches_prefill']} routes "
            f"{out['routes_prefill']}")
    calls = []
    errs = in_model_flash_errs(
        lambda: models.prefill(params, cfg, batch, S + 16), calls)
    seen = collections.Counter((m, w, q, k) for _, m, w, q, k in calls)
    require(dict(seen) == want_calls and len(errs) == n,
            f"{arch}: in-model kernel-6 calls {dict(seen)}")
    require(all(padded == route.endswith("_padded")
                for padded, *_ in calls), f"{arch}: padded route")
    out["attention_in_model_max_abs_err"] = errs
    out["attention_calls"] = [dict(mode=m, window=w, q=list(q), k=list(k),
                                   count=c)
                              for (m, w, q, k), c in seen.items()]
    out["prefill_trace"] = traced_round(
        lambda: models.prefill(params, cfg, batch, S + 16))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_runs(launches: dict) -> dict:
    """Runs (w), (x) and (y) with the launches and kernel-6 calls each
    prefill must make; adds ``flash_attention_run_*`` to ``launches``."""
    out = {}
    # (w) recurrentgemma-9b: 12 (R, R, A) groups, each A a local attention
    # over a 2,048 window, 16 heads of 256 over one kv head
    q, k = (2, 4096, 16, 256), (2, 4096, 1, 256)
    out["w"] = run_family_serving("recurrentgemma-9b", 2, 4096,
                                  {("window", 2048, q, k): 12}, "wgmma")
    ring = out["w"]
    require(ring["params"] == 10_444_984_320,
            f"run (w) holds {ring['params']} parameters")
    # (x) whisper-medium: 24 encoder layers over 1,500 frames, 24 decoder
    # layers of causal self-attention and cross-attention over the frames
    enc, dec = (4, 1500, 16, 64), (4, 448, 16, 64)
    out["x"] = run_family_serving(
        "whisper-medium", 4, 448,
        {("full", None, enc, enc): 24, ("causal", None, dec, dec): 24,
         ("full", None, dec, enc): 24}, "wgmma")
    require(out["x"]["params"] == 811_569_152,
            f"run (x) holds {out['x']['params']} parameters")
    # (y) phi-3-vision-4.2b: 32 layers of 32 heads of 96, natively
    qy = (4, 1024, 32, 96)
    out["y"] = run_family_serving("phi-3-vision-4.2b", 4, 1024,
                                  {("causal", None, qy, qy): 32}, "wgmma")
    require(out["y"]["params"] == 3_822_259_200,
            f"run (y) holds {out['y']['params']} parameters")
    for x in "wxy":
        launches[f"flash_attention_run_{x}"] = out[x]["launches_prefill"][
            "flash_attention"]
    return out


def family_card_vs_cpu(arch: str, n_attn: int) -> dict:
    """The reduced copies of runs (v)-(y): ``arch``'s reduced config
    (float32) on the card and the CPU from the same weights, 2 prompts of
    80 tokens (the hybrid's window of 64 binds and its ring wraps) with
    the stub frontend's inputs, 3 decode steps (the CPU fed the card's
    tokens): prefill and decode logits and every cache leaf in the golden
    band; the card's prefill launches kernel 6 ``n_attn`` times, once an
    attention call."""
    import torch
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import flatten, tree_map
    from repro_torch.kernels import _lib
    cfg = get_config(arch).reduced()
    cparams = models.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    gparams = tree_map(lambda t: t.cuda(), cparams)
    batch = family_inputs(cfg, 2, 80, 3, "cpu")
    gbatch = {k: t.cuda() for k, t in batch.items()}
    _lib.reset_launches()
    glogits, gcache = models.prefill(gparams, cfg, gbatch, 83)
    torch.cuda.synchronize()
    counts = _lib.counts()
    require(counts == ({"flash_attention": n_attn} if n_attn else {}),
            f"{arch} reduced: prefill launches {counts}")
    clogits, ccache = models.prefill(cparams, cfg, batch, 83)
    errs = [close(glogits.cpu(), clogits, **GOLDEN_BAND)]
    for _ in range(3):
        token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
        glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
        clogits, ccache = models.decode_step(cparams, cfg, token.cpu(),
                                             ccache)
        errs.append(close(glogits.cpu(), clogits, **GOLDEN_BAND))
    require(gcache["index"] == ccache["index"] == 83, "cache index")
    g_leaves, g_def = flatten({k: v for k, v in gcache.items()
                               if k != "index"})
    c_leaves, c_def = flatten({k: v for k, v in ccache.items()
                               if k != "index"})
    require(g_def == c_def, f"{arch} reduced: cache trees differ")
    cache_err = max(close(g.cpu(), c, **GOLDEN_BAND)
                    for g, c in zip(g_leaves, c_leaves))
    return dict(arch=cfg.name, prefill_launches=counts,
                logits_max_abs_err=errs, cache_max_abs_err=cache_err)


# ------------------------------------- kernel 6's extra_qk (item A.2)
def check_flash_extra(B: int, S: int, H: int, D: int, P2: int, Dv: int,
                      dtype, seed: int, iters: int) -> dict:
    """Kernel 6 on the reference's ``extra_qk`` scores at MLA's decomposed
    heads: q (B, S, H, D), k (B, S, H, D), v (B, S, H, Dv), q2 (B, S, H,
    P2) and a shared k2 (B, S, P2), causal, through the model-level
    ``flash_attention`` (``flash_attention_extra``: ``[q | q2]`` and ``[k
    | k2]`` concatenated, then the kernel at q's own scale ``D ** -0.5``,
    natively where ``(D + P2, Dv)`` is a kernel pair), against the plain
    chunked math of the reference's scan. ``ms`` is the whole route;
    ``concat_ms`` the two concatenations and ``launch_ms`` the kernel on
    the concatenated operands, each timed alone; ``padded_ms`` the
    concatenations and then the padded route (:func:`old_padded_route`,
    to 128). ``bound_ms`` counts q, k, q2, k2, v and the output moved
    once, against ``2·(D + P2) + 2·Dv`` operations a (query, key) pair
    the causal mask lets through. ``library_ms`` is
    ``scaled_dot_product_attention(is_causal=True, scale=D ** -0.5)`` on
    the concatenated operands (the concatenation not timed), the kernels
    PyTorch picked named."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import flash_attention as model_flash
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, q2, k2 = (
        torch.randn(shape, generator=g, device="cuda").to(dtype)
        for shape in ((B, S, H, D), (B, S, H, D), (B, S, H, Dv),
                      (B, S, H, P2), (B, S, P2)))
    n0 = fa.ROUTE_LAUNCHES.copy()
    with torch.no_grad():
        got = model_flash(q, k, v, extra_qk=(q2, k2))
    want = ref.chunked_attention_ref(q, k, v, extra_qk=(q2, k2))
    torch.cuda.synchronize()
    routes = dict(fa.ROUTE_LAUNCHES - n0)
    route_name = fa.kernel_route(dtype) + ("" if fa.kernel_pair(D + P2, Dv)
                                           else "_padded")
    require(routes == {route_name: 1}, f"extra_qk launches by route {routes}")
    require(got.dtype == dtype and tuple(got.shape) == (B, S, H, Dv),
            "extra_qk output")
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = close(got, want, **tol)
    scale = D ** -0.5
    qc, kc = fa.concat_extra(q, k, (q2, k2))
    padded_err = close(old_padded_route(qc, kc, v, scale), want, **tol)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    pairs = B * H * attention_pairs(S, S, "causal", None)
    es = q.element_size()
    b_ms, b_by = bound(es * (2 * B * S * H * D + B * S * H * P2
                             + B * S * P2 + 2 * B * S * H * Dv),
                       (2.0 * (D + P2) + 2.0 * Dv) * pairs, dname)
    qt, kt, vt = (x.transpose(1, 2) for x in (qc, kc, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)

    def padded():
        qp, kp = fa.concat_extra(q, k, (q2, k2))
        return old_padded_route(qp, kp, v, scale)
    route = lambda: fa.flash_attention_extra(q, k, v, (q2, k2))  # noqa: E731
    return dict(name="flash_attention", shape=[B, S, S, H, H, D, P2, Dv],
                mode="causal", window=None, dtype=dname,
                kernel_route=route_name, routes=routes, max_abs_err=err,
                ms=time_ms(route, iters),
                concat_ms=time_ms(lambda: fa.concat_extra(q, k, (q2, k2)),
                                  iters),
                launch_ms=time_ms(lambda: fa.flash_attention(
                    qc, kc, v, scale=scale), iters),
                padded_ms=time_ms(padded, iters),
                padded_max_abs_err=padded_err,
                host_ms=host_ms(route, iters),
                plain_ms=time_ms(lambda: ref.chunked_attention_ref(
                    q, k, v, extra_qk=(q2, k2)), iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, iters),
                library_call="scaled_dot_product_attention on [q | q2], "
                             "[k | k2], scale=D**-0.5",
                library_kernels=[n for n, _ in
                                 traced_round(lib, top=3)["top_kernels_ms"]],
                library_max_abs_err=float((lib().transpose(1, 2).float()
                                           - want.float()).abs().max()),
                gflop=(2.0 * (D + P2) + 2.0 * Dv) * pairs / 1e9)


# ------------------------------ the pod-axis FL round (z), (aa), (ab)
FL_Z = dict(arch="stablelm_1_6b", batch=4, seq=1024, rounds=3)
FL_AA = dict(arch="stablelm_1_6b", n_layers=2, batch=4, seq=1024, rounds=2)
FL_PHASES = ("fl_round.forward_backward", "fl_round.encode",
             "fl_round.all_reduce", "fl_round.decode", "fl_round.optimizer")


def fl_batch(cfg, r: int, batch: int, seq: int) -> dict:
    import torch
    from repro_torch.data.pipeline import synthetic_lm_batch
    return {k: v.to("cuda") for k, v in synthetic_lm_batch(
        100 + r, cfg.vocab_size, batch, seq).items()}


def fl_setup(cfg, seed: int = 0):
    """Full-width params drawn on the card from ``seed``, the default
    chunked AE from ``seed + 1``, the config's optimizer state."""
    import torch
    from repro_torch.core.autoencoder import init_chunked_ae
    from repro_torch.core.distributed import DEFAULT_AE
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import make_optimizer
    params = init_params(torch.Generator(device="cuda").manual_seed(seed),
                         cfg, "cuda")
    ae = init_chunked_ae(torch.Generator().manual_seed(seed + 1),
                         DEFAULT_AE, "cuda")
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip)
    return params, ae, opt, opt.init(params)


def fl_phase_split(prof) -> dict:
    """Device ms under each ``fl_round.*`` range of one traced round: the
    union of the kernels that start inside the range's device span (the
    ``gpu_user_annotation`` events ``torch.profiler`` records for
    ``record_function``); the all-reduce, which launches no kernel inside
    its range's device span, as the union of the NCCL kernels."""
    import torch
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in cuda if e.name in FL_PHASES]
    kern = [e for e in cuda if e.name not in FL_PHASES]
    out = {}
    for name in FL_PHASES:
        mine = [e for e in spans if e.name == name]
        if not mine and name == "fl_round.all_reduce":
            out[name] = busy_ms([k for k in kern if "nccl" in k.name.lower()])
            continue
        if not mine:
            out[name] = "not measured (no device span recorded)"
            continue
        inside = [k for k in kern for sp in mine
                  if sp.time_range.start <= k.time_range.start
                  < sp.time_range.end]
        out[name] = busy_ms(inside)
    return out


def run_fl_round_z(launches: dict) -> dict:
    """Run (z): ``build_fl_round_step`` on stablelm-1.6b at full width,
    all 24 layers (float32 parameters, bf16 compute, remat, ``adamw``),
    ``DEFAULT_AE`` (4096 -> 512 -> 8), on the one-rank NCCL group; 4 x
    1,024 tokens a round, 3 rounds (loss, host s, the latent bytes
    all-reduced against the gradient bytes), then one more round under
    ``torch.profiler`` (device idle share; device ms by phase)."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.distributed import (DEFAULT_AE,
                                              build_fl_round_step,
                                              compressed_fraction)
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels import _lib
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(FL_Z["arch"])
    held = torch.cuda.memory_allocated()
    params, ae, opt, state = fl_setup(cfg)
    n_params = sum(p.numel() for p in leaves(params))
    p_bytes = sum(p.numel() * p.element_size() for p in leaves(params))
    # reckoned from the tree: params, gradients, two adamw moments, the
    # decoded tree, the largest leaf's chunks through the AE, the logits
    biggest = max(p.numel() for p in leaves(params))
    logits = 4 * FL_Z["batch"] * FL_Z["seq"] * cfg.padded_vocab * 4
    need = (5 * p_bytes + 4 * (biggest // 4096 + 1) * (2 * 4096 + 512)
            + logits)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"fl (z) {cfg.name} x{cfg.n_layers} layers, {n_params} parameters "
        f"({p_bytes} B); reckoned need {need} B beside {held} B held "
        f"before the run, of {total} B")
    require(held + need < total, "run (z) would not fit on the card")
    bundle = build_fl_round_step(
        cfg, ShapeConfig("z", FL_Z["seq"], FL_Z["batch"], "train"), None,
        DEFAULT_AE)
    frac = compressed_fraction(params, DEFAULT_AE)
    lat_bytes = sum(-(-p.numel() // DEFAULT_AE.chunk_size)
                    * DEFAULT_AE.latent_chunk * 4 for p in leaves(params))
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    rounds = []
    for r in range(FL_Z["rounds"]):
        batch = fl_batch(cfg, r, FL_Z["batch"], FL_Z["seq"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = bundle.fn(params, state, ae, batch)
        torch.cuda.synchronize()
        last = bundle.stats["last_round"]
        rounds.append(dict(round=r, loss=float(m["loss"]),
                           accuracy=float(m["accuracy"]),
                           host_s=time.perf_counter() - t0,
                           latent_bytes=last["latent_bytes"],
                           grad_bytes=last["grad_bytes"]))
        require(math.isfinite(rounds[-1]["loss"]), "run (z): loss")
        require(last["grad_bytes"] == 4 * n_params
                and last["latent_bytes"] == lat_bytes
                and abs(last["latent_bytes"] / last["grad_bytes"] - frac)
                < 1e-12,
                f"run (z): latent bytes {last} against compressed_fraction "
                f"{frac!r}")
    peak = torch.cuda.max_memory_allocated()
    counts = _lib.counts()
    batch = fl_batch(cfg, FL_Z["rounds"], FL_Z["batch"], FL_Z["seq"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = bundle.fn(params, state, ae, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in FL_PHASES]
    busy = busy_ms(kern)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, n_params=n_params,
               tokens_a_round=FL_Z["batch"] * FL_Z["seq"], ae=str(DEFAULT_AE),
               rounds=rounds, compressed_fraction=frac,
               peak_memory_bytes=peak, launches=counts,
               traced=dict(wall_ms=wall, device_busy_ms=busy,
                           device_idle_share=1.0 - busy / wall,
                           device_kernels=len(kern),
                           device_ms_by_phase=fl_phase_split(prof),
                           loss=float(m["loss"])))
    del params, state, ae, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fl_card_vs_cpu(gloo) -> dict:
    """Run (z)'s reduced copy: one FL round of stablelm-1.6b's reduced
    config (float32) on the card (the NCCL group) and on the CPU (the gloo
    group) from the same params, AE and batch; loss, accuracy and params
    within the LM band ``atol=1e-4, rtol=1e-3`` (``PERF.md`` §2)."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.autoencoder import (ChunkedAEConfig,
                                              init_chunked_ae)
    from repro_torch.core.distributed import build_fl_round_step
    from repro_torch.core.pytree import leaves, tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import make_optimizer
    cfg = get_config(FL_Z["arch"]).reduced()
    ae_cfg = ChunkedAEConfig(256, (32,), 8)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ae = init_chunked_ae(torch.Generator().manual_seed(1), ae_cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(7, cfg.vocab_size, 4, 128).items()}
    out = {}
    for dev, group in (("cuda", None), ("cpu", gloo)):
        bundle = build_fl_round_step(cfg, ShapeConfig("z", 128, 4, "train"),
                                     group, ae_cfg)
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                             weight_decay=cfg.weight_decay,
                             grad_clip=cfg.grad_clip)
        out[dev] = bundle.fn(p, opt.init(p), tree_map(lambda t: t.to(dev),
                                                      ae),
                             {k: v.to(dev) for k, v in batch.items()})
    (gp, _, gm), (cp, _, cm) = out["cuda"], out["cpu"]
    errs = dict(loss=close(gm["loss"].cpu(), cm["loss"], 1e-4, 1e-3),
                accuracy=close(gm["accuracy"].cpu(), cm["accuracy"], 1e-4,
                               1e-3))
    errs["params"] = max(close(a.cpu(), b, 1e-4, 1e-3)
                         for a, b in zip(leaves(gp), leaves(cp)))
    return errs


def sharded_cases(device: str):
    """Run (ab)'s decode→aggregate inputs: run (h)'s cohort (64 clients,
    2^20 values, the kernel-path chunked AE (256, (32,), 8)) and run (o)'s
    q8 K 4,096 (2^16 values, block 256), payloads drawn from seeds."""
    import torch
    from repro_torch.core import codec, serve
    from repro_torch.core.autoencoder import (ChunkedAEConfig,
                                              init_chunked_ae)
    cfg = ChunkedAEConfig(256, (32,), 8)
    ae = init_chunked_ae(torch.Generator().manual_seed(3), cfg,
                         device)
    cases = []
    for name, spec, p, C in (
            ("chunked_ae_run_h", codec.ChunkedAESpec(size=1 << 20, cfg=cfg,
                                                     use_kernel=True), ae,
             64),
            ("q8_run_o_c4096", codec.QuantizeSpec(size=1 << 16, bits=8,
                                                  block=256), None, 4096)):
        g = torch.Generator(device=device).manual_seed(C)
        stacked = serve.synthetic_payloads(spec, p, C, g)
        w = torch.rand((C,), generator=g, device=device) + 0.1
        cases.append((name, spec, p, stacked, w / w.sum()))
    return cases


AB_KERNELS = ("dequantize_blocks_2d", "fused_dense", "fused_decode_agg")


def sharded_paths(group=None) -> dict:
    """Run (ab) on ``group``. First the sharded paths alone, their kernel
    launches counted from 0: one ``decode_and_aggregate_sharded`` at each
    of :func:`sharded_cases` and 3 rounds (after 1 of warm-up) of
    ``run_serve`` at ``serve_q8_c256``'s shape with ``shard=True``; each
    of ``AB_KERNELS`` must have launched (kernel 2 for q8, kernels 3 and 4
    for the chunked AE's kernel-terminal route). Then what they are held
    against: ``decode_and_aggregate`` on the same card (golden band;
    host-clock ms a call, CUDA events around 5 calls, both) and the
    unsharded serve (times, seqs, versions exact; ``global_flat`` in the
    golden band), and the two serves' rounds a second, each by
    :func:`serve_windows` (median of three windows of at least 1 s). The
    sharded call's ``all_reduce`` is timed alone too, at each case's
    size, as ``all_reduce_ms``."""
    import torch
    from repro_torch.core import codec, serve
    from repro_torch.core.collectives import all_reduce_sum, group_size
    from repro_torch.kernels import _lib
    cases = sharded_cases("cuda")
    q8 = codec.QuantizeSpec(size=1 << 16, bits=8, block=256)
    kw = dict(n_clients=SERVE_N, buffer_k=256, spec=q8, **SERVE_CFG)
    torch.cuda.synchronize()
    _lib.reset_launches()
    got = [codec.decode_and_aggregate_sharded(spec, p, stacked, w,
                                              group=group)
           for _, spec, p, stacked, w in cases]
    shard, rs = serve.run_serve(serve.ServeConfig(shard=True, **kw), 3,
                                group=group)
    torch.cuda.synchronize()
    counts = _lib.counts()
    for k in AB_KERNELS:
        require(counts.get(k, 0) > 0, f"run (ab) never launched {k}")
    out = {"world": group_size(group), "launches": counts,
           "all_reduce_ms": {}}
    for g in got:
        buf = torch.zeros_like(g)
        out["all_reduce_ms"][g.numel()] = host_ms(
            lambda: all_reduce_sum(buf, group), 5)
    for (name, spec, p, stacked, w), g in zip(cases, got):
        want = codec.decode_and_aggregate(spec, p, stacked, w)
        torch.cuda.synchronize()
        out[name] = dict(
            max_abs_err=close(g, want, **GOLDEN_BAND),
            equal=bool(torch.equal(g, want)),
            sharded_ms=host_ms(lambda: codec.decode_and_aggregate_sharded(
                spec, p, stacked, w, group=group), 5),
            unsharded_ms=host_ms(lambda: codec.decode_and_aggregate(
                spec, p, stacked, w), 5))
    plain, rp = serve.run_serve(serve.ServeConfig(**kw), 3)
    for key in ("times", "seqs", "versions"):
        require(torch.equal(plain[key], shard[key]),
                f"run (ab): sharded serve {key} differ")
    out["serve_q8_c256"] = dict(
        max_abs_err=close(shard["global_flat"], plain["global_flat"],
                          **GOLDEN_BAND),
        sharded=serve_windows(serve.ServeConfig(shard=True, **kw), None,
                              rs["us_per_round"], 3, group),
        unsharded=serve_windows(serve.ServeConfig(**kw), None,
                                rp["us_per_round"], 3))
    return out


def pods_child(rank: int, world: int, aa: dict) -> dict:
    """A rank of runs (aa) and (ab) in a two-process gloo group sharing
    the card: (ab) :func:`sharded_paths` over the group; (aa) the FL round
    on stablelm-1.6b at full width, ``aa["n_layers"]`` layers, each rank
    on its half of each round's batch; then rank 0 composes the same two
    rounds in this one process (each half's gradients and latents, their
    mean, decode, the optimizer's step) and compares."""
    import sys
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.distributed import (DEFAULT_AE,
                                              build_fl_round_step,
                                              leaf_decode, leaf_encode)
    from repro_torch.core.pytree import flatten, leaves, unflatten
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import grads_of_train_loss
    from repro_torch.models import model as model_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.load()
    out = {"ab": sharded_paths(None)}
    cfg = arch_cut(aa["arch"], aa["n_layers"])
    B, S, half = aa["batch"], aa["seq"], aa["batch"] // world
    bundle = build_fl_round_step(cfg, ShapeConfig("aa", S, B, "train"),
                                 None, DEFAULT_AE)
    params, ae, opt, state = fl_setup(cfg)
    metrics, host = [], []
    for r in range(aa["rounds"]):
        b = fl_batch(cfg, r, B, S)
        mine = {k: v[rank * half:(rank + 1) * half] for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = bundle.fn(params, state, ae, mine)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    out["aa"] = dict(metrics=metrics, host_s=host,
                     last=bundle.stats["last_round"])
    if rank != 0:
        return out
    got = leaves(params)
    del state
    params2, _, _, state2 = fl_setup(cfg)
    comp = []
    with torch.no_grad():
        for r in range(aa["rounds"]):
            b = fl_batch(cfg, r, B, S)
            lat_sum, likes, ms = None, None, []
            for i in range(world):
                h = {k: v[i * half:(i + 1) * half] for k, v in b.items()}
                frozen = dict(params2, embed=params2["embed"].detach())
                h0 = model_lib._embed_inputs(
                    frozen, cfg, h, model_lib._positions(half, S, "cuda"))
                with torch.enable_grad():
                    m, g = grads_of_train_loss(cfg, params2,
                                               dict(h, h0=h0),
                                               grad_dtype=torch.float32)
                gl, td = flatten(g)
                lat = [leaf_encode(ae, DEFAULT_AE, x) for x in gl]
                lat_sum = lat if lat_sum is None else [
                    a + c for a, c in zip(lat_sum, lat)]
                likes = likes or [(x.shape, x.dtype) for x in gl]
                ms.append(m)
                del g, gl
            decoded = unflatten(td, [
                leaf_decode(ae, DEFAULT_AE, z / world,
                            torch.empty(sh, dtype=dt, device="meta"))
                for z, (sh, dt) in zip(lat_sum, likes)])
            params2, state2 = opt.update(params2, decoded, state2,
                                         inplace=True)
            comp.append({k: float(sum(m[k] for m in ms) / world)
                         for k in ("loss", "accuracy")})
    want = leaves(params2)
    out["aa"]["composed_metrics"] = comp
    out["aa"]["bits_equal"] = all(torch.equal(a, c)
                                  for a, c in zip(got, want))
    out["aa"]["max_abs_err"] = max(close(a, c, **GOLDEN_BAND)
                                   for a, c in zip(got, want))
    for a, c in zip(metrics, comp):
        for k in ("loss", "accuracy"):
            close(torch.tensor(a[k]), torch.tensor(c[k]), **GOLDEN_BAND)
    return out


def run_pods() -> dict:
    """Runs (aa) and (ab) on two processes sharing the card over gloo
    (``repro_torch.launch.local.spawn``); a child's failure raises."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.local import spawn
    t0 = time.perf_counter()
    res = spawn("chip_smoke:pods_child", 2, {"aa": FL_AA},
                ROOT / "build" / "chip_smoke" / "pods", backend="gloo",
                timeout=400, path=[str(ROOT)])
    return dict(wall_s=time.perf_counter() - t0, ranks=res)


# ------------------------------------------- run (ac)'s replayed holds
# Adam steps of a tree of up to REPLAY_ALL values are held and replayed at
# every step; a larger tree's (the FC AEs, 2-4 million values) at its
# fit's first step, every REPLAY_EVERY-th step and its last
REPLAY_ALL = 1 << 20
REPLAY_EVERY = 100


def _flat(tree):
    from repro_torch.core.pytree import ravel
    return ravel(tree)[0].detach().clone()


def _unravel_like(tree, vec):
    """``vec`` (flat) cut into ``tree``'s leaves, on ``tree``'s device."""
    from repro_torch.core.pytree import flatten, unflatten
    lv, td = flatten(tree)
    vec = vec.to(lv[0].device)
    parts = vec.split([x.numel() for x in lv])
    return unflatten(td, [p.reshape(x.shape) for p, x in zip(parts, lv)])


def _to_device(x, device):
    """Every tensor of a nested dict / list / tuple on ``device``."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    return x


def _to_cpu(x):
    return _to_device(x, "cpu")


def _held_band(tag: str, got, want, rep: dict, key: str) -> None:
    """``got`` in the golden band of ``want``; the largest difference into
    ``rep[key]`` and the values held into ``rep["floats"]``."""
    try:
        err = close(got.cpu(), want.cpu(), **GOLDEN_BAND)
    except AssertionError as e:
        raise AssertionError(f"{tag}: {e}") from None
    rep[key] = max(rep.get(key, 0.0), err)
    rep["floats"] = rep.get("floats", 0) + got.numel()


class AdamSpy:
    """Every Adam step of a run, in call order a stream: ``"ae"``, the AE
    trainers' ``autoencoder._adam_update`` (pre-pass fits, lifecycle and
    switch-time refits, rung fits), and ``"opt"``, the optimizers'
    ``update`` (local training and the LM task; ``make_optimizer`` as
    ``optim.optimizers`` and ``core.prepass`` bind it). Recording
    (``replay=None``), it keeps each step's t, lr and size, and at the
    steps it holds (every step of a tree of up to ``REPLAY_ALL`` values,
    or of any tree with ``every_step``; a larger tree's first, every
    ``REPLAY_EVERY``-th and last step of each fit) the step's gradient,
    resulting parameters and moments, its input parameters at a fit's
    first step, and the result of the step before. Replaying another
    run's record, each held step is held against the record's by
    :func:`step_rule` from the same input (the step before's result is
    the record's, so the CPU's gradient is taken at the card's
    parameters), and every recorded result replaces the step's own: the
    next gradient is taken at the recorded parameters and a fit ends on
    the recorded result. A context manager; :meth:`record` gives the
    record on the CPU, ``rep`` the holds."""

    STREAMS = ("ae", "opt")

    def __init__(self, replay=None, tag: str = "adam",
                 every_step: bool = False):
        self.replay, self.tag, self.every_step = replay, tag, every_step
        self.steps = {s: [] for s in self.STREAMS}
        self.last = {s: [] for s in self.STREAMS}     # (index, result, g)
        self.pos = {s: 0 for s in self.STREAMS}
        self.rep = {s: dict(steps=0, held=0) for s in self.STREAMS}

    def __enter__(self):
        import dataclasses
        from repro_torch.core import autoencoder, prepass, task
        from repro_torch.optim import optimizers
        self.mods = (autoencoder, prepass, optimizers, task)
        self.real = (autoencoder._adam_update, optimizers.make_optimizer)
        real_adam, real_make = self.real

        def adam(p, g, m, v, t, lr):
            return self._step("ae", p, g, t, lr, real_adam(p, g, m, v, t, lr))

        def make(name, lr, **kw):
            opt = real_make(name, lr, **kw)
            if name not in ("adam", "adamw"):
                return opt

            def update(params, grads, state, *, inplace=False):
                require(not inplace, f"{self.tag}: an in-place update")
                p, st = opt.update(params, grads, state)
                p, m, v = self._step("opt", params, grads, st["count"], lr,
                                     (p, st["m"], st["v"]))
                return p, dict(st, m=m, v=v)
            return dataclasses.replace(opt, update=update)
        autoencoder._adam_update = adam
        optimizers.make_optimizer = prepass.make_optimizer = make
        task._lm_step.cache_clear()          # its optimizer is built once
        return self

    def __exit__(self, *exc):
        autoencoder, prepass, optimizers, task = self.mods
        autoencoder._adam_update = self.real[0]
        optimizers.make_optimizer = prepass.make_optimizer = self.real[1]
        task._lm_step.cache_clear()
        if exc[0] is None and self.replay is not None:
            for s in self.STREAMS:
                require(self.pos[s] == len(self.replay[s]),
                        f"{self.tag}: {self.pos[s]} {s} Adam steps on the "
                        f"CPU, {len(self.replay[s])} on the card")

    def _step(self, s, p_in, g, t: int, lr: float, out):
        t = int(t)
        size = sum(x.numel() for x in _leaves(p_in))
        if self.replay is None:
            self._record(s, p_in, g, t, lr, size, out)
            return out
        i = self.pos[s]
        self.pos[s] += 1
        rec = self.replay[s]
        require(i < len(rec) and (rec[i]["t"], rec[i]["size"]) == (t, size),
                f"{self.tag}: {s} Adam step {i} (t {t}, {size} values) "
                "is not the card's " + (f"(t {rec[i]['t']}, "
                                        f"{rec[i]['size']} values)"
                                        if i < len(rec) else "(none)"))
        e, rep = rec[i], self.rep[s]
        rep["steps"] += 1
        if "out" not in e:
            return out
        if e.get("held"):
            card_in = e["in_p"] if t == 1 else rec[i - 1]["out"][0]
            step_rule(f"{self.tag}: {s} Adam step {i} (t {t})", card_in,
                      e["out"][0], _flat(p_in).cpu(), _flat(out[0]).cpu(),
                      lr, t, e["g"], _flat(g).cpu(), rep)
            rep["held"] += 1
            rep["values"] = rep.get("values", 0) + size
        return tuple(_unravel_like(x, c) for x, c in zip(out, e["out"]))

    def _record(self, s, p_in, g, t, lr, size, out) -> None:
        steps, last = self.steps[s], self.last[s]
        if t == 1:
            self._close(s)                   # the step before ended a fit
        k = 1 if size <= REPLAY_ALL or self.every_step else REPLAY_EVERY
        steps.append(dict(t=t, size=size, lr=float(lr)))
        last.append((len(steps) - 1, out, g))
        del last[:-2]
        if t == 1 or t % k == 0:
            self._keep(s, len(steps) - 1, p_in)

    def _keep(self, s, i: int, p_in=None) -> None:
        """Hold step ``i``: its gradient and result, and its input (a fit's
        first step) or the result of the step before."""
        steps, last = self.steps[s], {j: (o, g) for j, o, g in self.last[s]}
        e = steps[i]
        if e.get("held"):
            return
        e["held"] = True
        e["out"] = tuple(_flat(x) for x in last[i][0])
        e["g"] = _flat(last[i][1])
        if e["t"] == 1:
            e["in_p"] = _flat(p_in)
        elif "out" not in steps[i - 1]:
            steps[i - 1]["out"] = tuple(_flat(x) for x in last[i - 1][0])

    def _close(self, s) -> None:
        if self.steps[s]:
            self._keep(s, len(self.steps[s]) - 1)

    def record(self) -> dict:
        for s in self.STREAMS:
            self._close(s)
            self.last[s] = []
        return _to_cpu(self.steps)


def _leaves(tree):
    from repro_torch.core.pytree import leaves
    return leaves(tree)


class RefitSpy:
    """Wraps ``AELifecycle._refit`` (the lifecycle's refits and rate
    control's switch-time refits, one ``train_autoencoder_cohort``
    dispatch a shape group) and ``_refit_dataset``: recording, each
    refit's resulting AE params per (round, lane) with the lane's shape
    group; replaying another run's record, the CPU's refit (whose Adam
    steps :class:`AdamSpy` holds and replays) is held against the
    record's in the golden band and the record's params take its place,
    so the rounds after it run on the card's AE."""

    def __init__(self, replay=None, tag: str = "refit"):
        self.replay, self.tag = replay, tag
        self.calls, self.pos = [], 0
        self.rep = dict(refits=0, lanes=0)

    def __enter__(self):
        from repro_torch.core import lifecycle
        cls = self.cls = lifecycle.AELifecycle
        self.real = (cls._refit, cls._refit_dataset)
        real_refit, real_data = self.real
        shapes = {}

        def data(lc, run, lane):
            fc, rows = real_data(lc, run, lane)
            shapes[repr(lane)] = (fc, tuple(rows.shape))
            return fc, rows

        def refit(lc, run, r, todo):
            shapes.clear()
            out = real_refit(lc, run, r, todo)
            keys = list(dict.fromkeys(shapes[repr(x)] for x, _ in out))
            groups = [keys.index(shapes[repr(x)]) for x, _ in out]
            return self._seen(r, out, groups)
        cls._refit, cls._refit_dataset = refit, data
        return self

    def __exit__(self, *exc):
        self.cls._refit, self.cls._refit_dataset = self.real
        if exc[0] is None and self.replay is not None:
            require(self.pos == len(self.replay),
                    f"{self.tag}: {self.pos} refit calls on the CPU, "
                    f"{len(self.replay)} on the card")

    def _seen(self, r: int, out, groups):
        lanes = [repr(x) for x, _ in out]
        if self.replay is None:
            self.calls.append(dict(round=r, lanes=lanes, groups=groups,
                                   params=[_flat(p) for _, p in out]))
            return out
        rec = self.replay[self.pos] if self.pos < len(self.replay) else {}
        self.pos += 1
        require((rec.get("round"), rec.get("lanes"), rec.get("groups"))
                == (r, lanes, groups),
                f"{self.tag}: refit call {self.pos - 1} at round {r} lanes "
                f"{lanes} groups {groups}, the card's {rec.get('round')} "
                f"{rec.get('lanes')} {rec.get('groups')}")
        if out:
            self.rep["refits"] += 1
        new = []
        for (lane, p), card in zip(out, rec["params"], strict=True):
            _held_band(f"{self.tag}: round {r} refit of lane {lane!r}",
                       card, _flat(p), self.rep, "max_abs_err")
            new.append((lane, _unravel_like(p, card)))
            self.rep["lanes"] += 1
        return new

    def record(self) -> list:
        return _to_cpu(self.calls)


class TrainStartSpy:
    """Wraps the tasks' local training (``ClassifierTask.local_update``
    and ``local_update_batched``, ``LMDeltaTask.local_update``), the calls
    in order: recording, the global params each starts from; replaying
    another run's record, the CPU's held in the golden band and the
    record's taken (the FedProx anchor too, where it is the same tree), so
    a client's first Adam step starts from the card's parameters."""

    def __init__(self, replay=None, tag: str = "start"):
        self.replay, self.tag = replay, tag
        self.calls, self.pos = [], 0
        self.rep = dict(starts=0)

    def __enter__(self):
        from repro_torch.core import task
        self.real = [(cls, name, getattr(cls, name)) for cls, name in (
            (task.ClassifierTask, "local_update"),
            (task.ClassifierTask, "local_update_batched"),
            (task.LMDeltaTask, "local_update"))]
        for cls, name, fn in self.real:
            setattr(cls, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def update(task_self, params, data, cfg, *, seed, anchor=None):
            if self.replay is None:
                self.calls.append(_flat(params))
            else:
                i, self.pos = self.pos, self.pos + 1
                require(i < len(self.replay), f"{self.tag}: local "
                        f"training {i} past the card's {len(self.replay)}")
                _held_band(f"{self.tag}: local training {i} start",
                           _flat(params), self.replay[i], self.rep,
                           "max_abs_err")
                card = _unravel_like(params, self.replay[i])
                anchor = card if anchor is params else anchor
                params = card
                self.rep["starts"] += 1
            return fn(task_self, params, data, cfg, seed=seed,
                      anchor=anchor)
        return update

    def __exit__(self, *exc):
        for cls, name, fn in self.real:
            setattr(cls, name, fn)
        if exc[0] is None and self.replay is not None:
            require(self.pos == len(self.replay),
                    f"{self.tag}: {self.pos} local trainings on the CPU, "
                    f"{len(self.replay)} on the card")

    def record(self) -> list:
        return _to_cpu(self.calls)


class ExampleEncodeSpy:
    """Wraps ``scheduler._encode_local`` for run (ac), the calls in order
    (each keyed by run, round and client; a run numbered by its first
    encode). Recording: the local model, the global params it trained
    from, the client's error-feedback residual before the encode, and the
    payload. Replaying another run's record: the CPU's global params and
    residual are held against the record's in the golden band, then the
    record's local model, global params and residual replace the CPU's,
    so the encode's input is the card's value for value (a code boundary
    straddled by rounding cannot fork the runs); the payload is held:
    integer codes exact, floats in the band (and kept in ``calls``).
    :class:`AdamSpy` holds the local training that made the local
    model."""

    def __init__(self, replay=None, tag: str = "encode"):
        self.replay, self.tag = replay, tag
        self.calls, self.pos, self.runs = [], 0, []
        self.rep = dict(encodes=0)

    def __enter__(self):
        from repro_torch.core import scheduler as mod
        self.mod, self.real = mod, mod._encode_local

        def spy(run, ci, local, global_params, state, metrics):
            if not any(run is x for x in self.runs):
                self.runs.append(run)
            key = (next(i for i, x in enumerate(self.runs) if x is run),
                   run.round_offset + len(run.history), ci)
            res = state.residual
            if self.replay is None:
                self.calls.append(dict(
                    key=key, own=_flat(local), start=_flat(global_params),
                    residual=None if res is None else _flat(res)))
                enc = self.real(run, ci, local, global_params, state,
                                metrics)
                self.calls[-1]["payload"] = enc.payload
                return enc
            rec = (self.replay[self.pos] if self.pos < len(self.replay)
                   else {})
            self.pos += 1
            tag = f"{self.tag}: encode {key}"
            require(rec.get("key") == key,
                    f"{tag} is not the card's {rec.get('key')}")
            _held_band(f"{tag}: global params", _flat(global_params),
                       rec["start"], self.rep, "global_params")
            require((res is None) == (rec["residual"] is None),
                    f"{tag}: a residual on one device only")
            if res is not None:
                _held_band(f"{tag}: residual", _flat(res), rec["residual"],
                           self.rep, "residual")
                state.residual = _unravel_like(res, rec["residual"])
            enc = self.real(run, ci, _unravel_like(local, rec["own"]),
                            _unravel_like(global_params, rec["start"]),
                            state, metrics)
            hold_payload(tag, rec["payload"], enc.payload, self.rep)
            self.rep["encodes"] += 1
            self.calls.append(dict(key=key, payload=enc.payload))
            return enc
        mod._encode_local = spy
        return self

    def __exit__(self, *exc):
        self.mod._encode_local = self.real
        self.runs = []
        if exc[0] is None and self.replay is not None:
            require(self.pos == len(self.replay),
                    f"{self.tag}: {self.pos} encodes on the CPU, "
                    f"{len(self.replay)} on the card")

    def record(self) -> list:
        return _to_cpu(self.calls)


class QuantSpy:
    """Wraps the blockwise quantizer's encode (``codec._QuantizeOps.fwd``:
    every q8 / q4 stage of an encode and of a drift or rate probe), the
    calls in order. Recording, each call's input; replaying another run's
    record, the CPU's input is held in the golden band and the record's
    quantized in its place, so the codes come from the card's values (a
    chain's AE latents can straddle a code boundary by rounding)."""

    def __init__(self, replay=None, tag: str = "quantize"):
        self.replay, self.tag = replay, tag
        self.calls, self.pos = [], 0
        self.rep = dict(calls=0)

    def __enter__(self):
        from repro_torch.core import codec
        self.cls, self.real = codec._QuantizeOps, codec._QuantizeOps.fwd

        def fwd(spec, params, flat):
            if self.replay is None:
                self.calls.append(flat.detach().clone())
                return self.real(spec, params, flat)
            i, self.pos = self.pos, self.pos + 1
            require(i < len(self.replay)
                    and self.replay[i].shape == flat.shape,
                    f"{self.tag}: quantize call {i} of {tuple(flat.shape)} "
                    "is not the card's")
            _held_band(f"{self.tag}: quantize call {i} input", flat,
                       self.replay[i], self.rep, "max_abs_err")
            self.rep["calls"] += 1
            return self.real(spec, params,
                             self.replay[i].to(flat.device))
        self.cls.fwd = staticmethod(fwd)
        return self

    def __exit__(self, *exc):
        self.cls.fwd = staticmethod(self.real)
        if exc[0] is None and self.replay is not None:
            require(self.pos == len(self.replay),
                    f"{self.tag}: {self.pos} quantize calls on the CPU, "
                    f"{len(self.replay)} on the card")

    def record(self) -> list:
        return _to_cpu(self.calls)


class ServeSpy:
    """Wraps the serve loop's two draw seams (``serve._uniform``,
    ``serve.synthetic_payloads``) and its step (``serve.make_step``), which
    ``fl_serve`` runs in place of ``scheduler._encode_local``. Recording,
    every draw and each round's ``global_flat`` and clock; replaying
    another run's record, the record's draws in place of the CPU's own
    (the devices' generators differ), and each round's ``global_flat`` and
    clock held in the golden band."""

    def __init__(self, replay=None, tag: str = "serve"):
        self.replay, self.tag = replay, tag
        self.draws, self.rounds, self.pos = [], [], [0, 0]
        self.rep = dict(rounds=0)

    def __enter__(self):
        import torch
        from repro_torch.core import serve
        self.mod = serve
        self.real = (serve._uniform, serve.synthetic_payloads,
                     serve.make_step)
        real_uniform, real_payloads, real_make = self.real

        def drawn(fn):
            def draw(*a):
                out = fn(*a)
                if self.replay is None:
                    self.draws.append(out)
                    return out
                i, self.pos[0] = self.pos[0], self.pos[0] + 1
                card = (self.replay["draws"][i]
                        if i < len(self.replay["draws"]) else None)
                require(card is not None and [
                    (x.shape, x.dtype) for x in _leaves(card)] == [
                    (x.shape, x.dtype) for x in _leaves(out)],
                    f"{self.tag}: draw {i} is not the card's")
                gen = next(x for x in a if isinstance(x, torch.Generator))
                return _to_device(card, gen.device)
            return draw

        def make(*a, **kw):
            step = real_make(*a, **kw)

            def call(state):
                out = step(state)
                now = (out["global_flat"].clone(), out["clock"].clone())
                if self.replay is None:
                    self.rounds.append(now)
                    return out
                r, self.pos[1] = self.pos[1], self.pos[1] + 1
                require(r < len(self.replay["rounds"]),
                        f"{self.tag}: round {r} past the card's")
                for what, got, want in zip(("global_flat", "clock"), now,
                                           self.replay["rounds"][r]):
                    _held_band(f"{self.tag}: round {r} {what}", got, want,
                               self.rep, what)
                self.rep["rounds"] += 1
                return out
            return call
        serve._uniform = drawn(real_uniform)
        serve.synthetic_payloads = drawn(real_payloads)
        serve.make_step = make
        # its encode of a zero vector is cached; every run makes it anew,
        # so two runs quantize as often (:class:`QuantSpy`)
        serve._payload_structure.cache_clear()
        return self

    def __exit__(self, *exc):
        (self.mod._uniform, self.mod.synthetic_payloads,
         self.mod.make_step) = self.real
        if exc[0] is None and self.replay is not None:
            require(self.pos == [len(self.replay["draws"]),
                                 len(self.replay["rounds"])],
                    f"{self.tag}: {self.pos} draws and rounds on the CPU, "
                    f"the card's {len(self.replay['draws'])}, "
                    f"{len(self.replay['rounds'])}")

    def record(self) -> dict:
        return _to_cpu({"draws": self.draws, "rounds": self.rounds})


class _TorchWith:
    """The ``torch`` module with some attributes replaced (a module that
    calls ``torch.relu`` sees the replacement)."""

    def __init__(self, torch, **attrs):
        self._torch = torch
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return getattr(self._torch, name)


class DecisionSpy:
    """Wraps the classifiers' ReLU and max-pool (``models.classifiers``
    calls ``torch.relu`` and ``torch.nn.functional.max_pool2d``; the spy
    stands in for that module's ``torch``), each kind's calls in order.
    Their gradients are decisions: where a pre-activation lies within
    rounding of zero, or a pooling window's two largest values within
    rounding of each other, the card and the CPU can decide apart, and a
    whole upstream gradient takes another path (``fl_color_imbalance
    --stacks``: one conv2 pre-activation 1.6e-7 from zero moved six
    gradient values across zero, by up to 1.5e-4). Recording, each call's
    ties within the golden band's atol (ReLU inputs that near zero, pool
    windows with a positive maximum whose top two are that near) with the
    card's decision there;
    replaying another run's record, each decision the CPU takes apart from
    the card's must be at a tie that is within the atol on the CPU too (a
    tie within the band), and the card's decision is taken. Tensors under
    ``torch.func`` transforms pass through unseen."""

    KINDS = ("relu", "pool")

    def __init__(self, replay=None, tag: str = "decision"):
        self.replay, self.tag = replay, tag
        self.calls = {k: [] for k in self.KINDS}
        self.pos = {k: 0 for k in self.KINDS}
        self.rep = {k: dict(calls=0, ties=0, flips=0, flip_gap=0.0)
                    for k in self.KINDS}

    def _card(self, kind, tie_idx, decision, gap, device):
        """The record's ties of this call (recording: keep them), and the
        positions where the CPU decides apart from the card (replaying:
        each checked to be a tie within the band), as (positions, the
        card's decisions there) or None."""
        if self.replay is None:
            self.calls[kind].append((tie_idx, decision[tie_idx].clone()))
            return None
        i, self.pos[kind] = self.pos[kind], self.pos[kind] + 1
        rec = self.replay[kind]
        require(i < len(rec), f"{self.tag}: {kind} call {i} past the "
                f"card's {len(rec)}")
        idx, card = (t.to(device) for t in rec[i])
        rep = self.rep[kind]
        rep["calls"] += 1
        rep["ties"] += idx.numel()
        apart = decision[idx] != card
        if not bool(apart.any()):
            return None
        at = gap[idx][apart]
        require(bool((at <= GOLDEN_BAND["atol"]).all()),
                f"{self.tag}: {kind} call {i}: a decision apart from the "
                f"card's where the CPU's tie gap is {float(at.max())}")
        rep["flips"] += int(apart.sum())
        rep["flip_gap"] = max(rep["flip_gap"], float(at.max()))
        return idx[apart], card[apart]

    def __enter__(self):
        import torch
        from repro_torch.models import classifiers
        F = torch.nn.functional
        self.mod, self.real = classifiers, classifiers.torch
        real_relu, real_pool = torch.relu, F.max_pool2d
        tie = GOLDEN_BAND["atol"]
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor

        def relu(x):
            out = real_relu(x)
            if wrapped(x):
                return out
            flat = x.detach().reshape(-1)
            gap = flat.abs()
            got = self._card("relu", torch.nonzero(gap <= tie).flatten(),
                             flat > 0, gap, x.device)
            if got is None:
                return out
            mask = (flat > 0).clone()
            mask[got[0]] = got[1]
            return torch.where(mask.reshape(x.shape), x, torch.zeros_like(x))

        def max_pool2d(h, kernel_size, stride=None, *a, **kw):
            out, idx = real_pool(h, kernel_size, stride, *a,
                                 return_indices=True,
                                 **{k: v for k, v in kw.items()
                                    if k != "return_indices"})
            if wrapped(h) or kernel_size != 2 or stride != 2:
                return out
            N, C, Ho, Wo = out.shape
            win = h.detach()[..., :2 * Ho, :2 * Wo].reshape(
                N, C, Ho, 2, Wo, 2).transpose(3, 4).reshape(-1, 4)
            top = torch.topk(win, 2, dim=1).values
            gap = top[:, 0] - top[:, 1]
            flat = idx.reshape(-1)
            # a window of ReLU zeros routes a zero gradient either way
            ties = (gap <= tie) & (top[:, 0] > 0)
            got = self._card("pool", torch.nonzero(ties).flatten(), flat,
                             gap, h.device)
            if got is None:
                return out
            flat = flat.clone()
            flat[got[0]] = got[1]
            return h.reshape(N, C, -1).gather(
                2, flat.reshape(N, C, -1)).reshape(out.shape)

        nn = _TorchWith(torch.nn, functional=_TorchWith(
            F, max_pool2d=max_pool2d))
        classifiers.torch = _TorchWith(torch, relu=relu, nn=nn)
        return self

    def __exit__(self, *exc):
        self.mod.torch = self.real
        if exc[0] is None and self.replay is not None:
            for k in self.KINDS:
                require(self.pos[k] == len(self.replay[k]),
                        f"{self.tag}: {self.pos[k]} {k} calls on the CPU, "
                        f"{len(self.replay[k])} on the card")

    def record(self) -> dict:
        return _to_cpu(self.calls)


class ExampleSpies:
    """Run (ac)'s replayed holds around one example call: :class:`AdamSpy`,
    :class:`TrainStartSpy`, :class:`DecisionSpy`, :class:`RefitSpy`,
    :class:`ExampleEncodeSpy`, :class:`QuantSpy` and :class:`ServeSpy`.
    Without ``replay`` they record (:meth:`record`, on the CPU); given
    another run's record they replay it and hold (:meth:`report`). A
    context manager."""

    KINDS = (("adam", AdamSpy), ("start", TrainStartSpy),
             ("decision", DecisionSpy), ("refit", RefitSpy),
             ("encode", ExampleEncodeSpy), ("quant", QuantSpy),
             ("serve", ServeSpy))

    def __init__(self, replay=None, tag: str = ""):
        self.spies = {k: cls(None if replay is None else replay[k],
                             f"{tag} {k}".strip())
                      for k, cls in self.KINDS}

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        for spy in self.spies.values():
            self.stack.enter_context(spy)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)

    def record(self) -> dict:
        return {k: s.record() for k, s in self.spies.items()}

    def report(self) -> dict:
        return {k: s.rep for k, s in self.spies.items()}


# --------------------------------------------------- run (ac): the examples
# the kernels each example's path has on the card, each of which must
# launch: none where the path has none (the FC AEs are cuBLAS matrix
# products). The codec stacks' top-k-prefixed chains reduce by
# scatter-add, not kernel 4; the LM federation's role AEs are a client's
# own, so the grouped round takes them on the batched-params route, not
# kernel 5 (as the reference's); kernel 6 is its evaluation prefill.
# The card's calls run in this order: the longest CPU replays first (a
# replay starts when its card call ends), the full-width runs, which have
# no CPU replay, last; each README command line (README.md:34-256) or
# factored call is in ac_call
AC_KERNELS = {
    "fl_color_imbalance_stacks": ("quantize_blocks_2d",
                                  "dequantize_blocks_2d", "fused_dense"),
    "adaptive_rate_control": (),
    "per_layer_partitions": ("quantize_blocks_2d", "dequantize_blocks_2d"),
    "llm_federated_reduced": ("quantize_blocks_2d", "dequantize_blocks_2d",
                              "fused_dense", "flash_attention"),
    "ae_lifecycle_refresh": (),
    "fl_serve": ("dequantize_blocks_2d",),
    "quickstart": (),
    "fl_async_sampling": ("quantize_blocks_2d", "dequantize_blocks_2d"),
    "batched_server_decode": ("fused_dense", "fused_decode_agg"),
    "fl_serve_q4_shard": ("dequantize_blocks_2d",),
    "fl_color_imbalance_reduced": (),
    "llm_serve_decode": ("flash_attention",),
    "fl_color_imbalance": (),
    "llm_serve_decode_full": ("flash_attention",),
    "llm_federated_full": ("quantize_blocks_2d", "dequantize_blocks_2d",
                           "fused_dense", "flash_attention"),
}
AC_ORDER = tuple(AC_KERNELS)
# the CPU replays each card run is held to (:class:`ExampleSpies`): the
# same call, or (for the full-width LM runs and the §5.2 federation at
# full width) a reduced twin run on both devices; child processes
# (threads, labels) replay them as the card's records come in
# (``ac_cpu_child``), and run the free CPU runs of ``AC_FREE`` (labels
# "free:<label>", which need no record) first. ``llm_federated`` at the
# README's size is cut to its twin: its 40-epoch pre-pass fits and
# 20-epoch refits took 216.19 s on the card (host-bound Adam steps,
# ROADMAP Backlog B2), past the phase's time. ``llm_serve_decode`` is held
# in this process (its logits along the card's tokens,
# ``ac_lm_serve_vs_cpu``)
AC_CPU_JOBS = ((2, ("fl_color_imbalance_stacks",)),
               (4, ("adaptive_rate_control",)),
               (2, ("free:ae_lifecycle_refresh", "per_layer_partitions",
                    "ae_lifecycle_refresh", "fl_serve",
                    "batched_server_decode", "fl_serve_q4_shard",
                    "free:quickstart", "free:batched_server_decode",
                    "free:fl_color_imbalance_reduced",
                    "llm_federated_reduced", "quickstart",
                    "fl_async_sampling", "fl_color_imbalance_reduced")),
               (2, ("free:adaptive_rate_control",)))
AC_REPLAYED = tuple(x for _, labels in AC_CPU_JOBS for x in labels
                    if not x.startswith("free:"))
# the examples whose card run is also held to a free CPU run, floats in
# the golden band up to the first warm-started AE refit
# (``ac_hold_free``): those with no quantizing codec on the path, where
# neither a code boundary nor a refit forks the free runs
AC_FREE = ("adaptive_rate_control", "ae_lifecycle_refresh", "quickstart",
           "batched_server_decode", "fl_color_imbalance_reduced")
AC_EXACT_KEYS = frozenset((
    "bytes_up", "bytes_up_raw", "bytes_down", "bytes_decoder",
    "compression_ratio", "effective_ratio", "participants", "staleness",
    "sim_time", "ae_syncs", "spec_switches", "rungs", "round_bytes",
    "version", "updates", "up_bytes", "raw_bytes", "prices", "groups",
    "snapshots", "original_bytes", "compressed_bytes", "cohort", "model",
    "params", "ae_params", "decoder_syncs", "observed_decoder_bytes",
    "predicted_decoder_bytes", "decoder_rel_err", "savings_rel_err",
    "vmap_rounds", "loop_rounds", "round", "name", "assertion"))
AC_FLOAT_KEYS = frozenset(("accuracy", "collab_accuracy", "ce_loss",
                           "ae_history", "curve", "aggregate",
                           "global_flat"))
# run (ac)'s cuts: the full-width LM federation (stablelm-1.6b at 2 of 24
# layers, as run (q); 2 clients, 2 rounds of 1 local epoch, the pre-pass
# AEs fitted 4 epochs on the first 1,024 chunk rows of each role) and the
# reduced twins (the CPU tests' sizes: 2 clients, 2 rounds of 1 local
# epoch, 2 x 16 tokens, 4-epoch pre-pass fits, 2-epoch refits)
AC_LM_FULL = dict(arch="stablelm_1_6b", n_layers=2, rounds=2, clients=2,
                  seqs=8, seq=64, batch=4, local_epochs=1, prepass_epochs=4,
                  fit_rows=1024)
AC_LM_REDUCED = dict(rounds=2, clients=2, seqs=2, seq=16, batch=2,
                     local_epochs=1, prepass_epochs=4, refresh_epochs=2)
AC_SERVE_FULL = dict(arch="llama3-8b", batch=4, prompt=32, new_tokens=16)
AC_LLAMA_PARAMS = 8_030_261_248       # llama3-8b's 32 layers, float32
NARROW_CNN = dict(name="cifar-cnn-narrow", kind="cnn",
                  input_shape=(32, 32, 3), n_classes=10,
                  conv_channels=(4, 4, 8, 8), conv_kernel=3,
                  dense_hidden=(16,))
LM_BAND = dict(atol=1e-4, rtol=1e-3)       # run (g)'s float32 LM band
AC_LOG = ROOT / "build" / "chip_smoke" / "examples_ac.txt"   # what they print


def ac_call(label: str, device: str, small: bool = False) -> dict:
    """One of run (ac)'s example calls on ``device``: the example's
    ``main(argv)`` at the README's command line, or a factored call (the
    full-width LM runs, the reduced twins). ``small`` takes the CPU tests'
    sizes (the card tests). ``adaptive_rate_control``'s ladder-walk
    assertion is returned as ``{"assertion": its args, ...the round
    table}``: the reference stops there too, and the caller holds the
    outcome to the CPU's; every other assertion raises through."""
    import argparse
    import dataclasses
    import importlib
    import torch
    from repro_torch.examples._common import Printer
    name = label.removesuffix("_full").removesuffix("_reduced") \
        .removesuffix("_stacks").removesuffix("_q4_shard")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    dev = ["--device", device]
    dv = torch.device(device)
    out = Printer()

    def ns(**kw):
        return argparse.Namespace(device=dv, **kw)

    if label == "llm_serve_decode_full":
        from repro_torch import models
        cfg = arch_cut(AC_SERVE_FULL["arch"], 32)
        params = models.init_params(
            torch.Generator(device=device).manual_seed(0), cfg, device)
        batch = mod.prompt_batch(cfg, AC_SERVE_FULL["batch"],
                                 AC_SERVE_FULL["prompt"], dv)
        res = mod.serve(cfg, params, batch, AC_SERVE_FULL["new_tokens"], dv,
                        out)
        res["params"] = models.param_count(params)
        del params
        return dict(res, lines=out.lines)
    if label == "llm_federated_full":
        a = AC_LM_FULL
        cfg = arch_cut(a["arch"], a["n_layers"])
        return dict(mod.federate(
            ns(rounds=a["rounds"], clients=a["clients"], seqs=a["seqs"],
               seq=a["seq"], batch=a["batch"],
               local_epochs=a["local_epochs"]), cfg, out,
            prepass_epochs=a["prepass_epochs"], fit_rows=a["fit_rows"]),
            lines=out.lines)
    if label == "llm_federated_reduced":
        from repro_torch.configs import get_config
        a = AC_LM_REDUCED
        return dict(mod.federate(
            ns(**{k: a[k] for k in ("rounds", "clients", "seqs", "seq",
                                    "batch", "local_epochs")}),
            get_config("llama3-8b").reduced(), out,
            prepass_epochs=a["prepass_epochs"],
            refresh_epochs=a["refresh_epochs"]), lines=out.lines)
    if label == "fl_color_imbalance_reduced":
        from repro_torch.configs.paper import ClassifierConfig
        return dict(mod.run_federation(
            ns(rounds=2, n=32, local_epochs=1), out,
            clf_cfg=ClassifierConfig(**NARROW_CNN)), lines=out.lines)
    if label == "adaptive_rate_control":
        table = {}
        try:
            if small:
                mod.rate_runs(dv, out, rounds=4, rung_epochs=60,
                              table=table)
            else:
                mod.main(dev, table=table)
        except AssertionError as e:
            if e.args != ("the demo should actually walk the ladder",):
                raise
            return dict(table, assertion=list(e.args), lines=out.lines)
        return dict(table, assertion=None, lines=out.lines)
    if small:
        from repro_torch.configs.paper import SMOKE_SCALE_SCENARIO
        calls = {
            "quickstart": lambda: mod.pipeline(dv, out, n=256,
                                               prepass_epochs=4,
                                               ae_epochs=10),
            "batched_server_decode": lambda: mod.server_round(
                dv, out, cohort=8, model=4096),
            "fl_async_sampling": lambda: mod.schedulers(
                dv, out, dataclasses.replace(SMOKE_SCALE_SCENARIO,
                                             n_clients=8, rounds=2)),
            "ae_lifecycle_refresh": lambda: mod.lifecycle_run(
                dv, out, n_clients=2, rounds=4, ae_epochs=10,
                refresh_epochs=5),
            "per_layer_partitions": lambda: mod.partitioned_run(
                dv, out, n_clients=2, rounds=4, refresh_epochs=20),
        }
        if label in calls:
            return dict(calls[label](), lines=out.lines)
    argv = {
        "fl_serve": ["--n-clients", "1000000", "--buffer-k", "4096"],
        "fl_serve_q4_shard": ["--spec", "q4", "--shard", "--rounds", "5"],
        "fl_color_imbalance_stacks": ["--stacks"],
    }.get(label, [])
    if small:
        argv = {
            "fl_serve": ["--n-clients", "5000", "--buffer-k", "64",
                         "--rounds", "2"],
            "fl_serve_q4_shard": ["--spec", "q4", "--shard",
                                  "--n-clients", "5000", "--buffer-k", "64",
                                  "--rounds", "2"],
            "fl_color_imbalance_stacks": ["--stacks", "--rounds", "2",
                                          "--n", "32"],
        }.get(label, argv)
    return mod.main(dev + argv)


def ac_fields(res, keys) -> dict:
    """The values under ``keys`` anywhere in an example's result, by
    path; a serve run's host-clock throughput and sim clock are skipped
    (the card's and the CPU's latency draws come from their own
    generators)."""
    import torch
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                if k in ("lines", "throughput"):
                    continue
                if k in keys:
                    out[path + str(k)] = v
                elif isinstance(v, (dict, list, tuple)):
                    walk(v, f"{path}{k}.")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                if isinstance(v, (dict, list, tuple)):
                    walk(v, f"{path}{i}.")
    walk(res, "")
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def ac_hold(label: str, card: dict, cpu: dict) -> dict:
    """Every byte count, ratio, cohort, staleness, sync list, rung and
    outcome of ``card`` equal to ``cpu``'s; every round's floats in the
    golden band (the CPU run replays the card's record, so the runs do not
    fork at a code boundary or an AE refit: :class:`ExampleSpies`).
    Returns the number of exact values, the floats held and the largest
    float difference."""
    import torch
    ex_g, ex_c = ac_fields(card, AC_EXACT_KEYS), ac_fields(cpu, AC_EXACT_KEYS)
    require(ex_g.keys() == ex_c.keys() and ex_g,
            f"(ac) {label}: fields {sorted(ex_g)} vs {sorted(ex_c)}")
    for k in ex_g:
        require(ex_g[k] == ex_c[k],
                f"(ac) {label}: {k} card {ex_g[k]!r} != cpu {ex_c[k]!r}")
    err, n = 0.0, 0
    fl_g, fl_c = ac_fields(card, AC_FLOAT_KEYS), ac_fields(cpu, AC_FLOAT_KEYS)
    require(fl_g.keys() == fl_c.keys() and fl_g, f"(ac) {label} floats")
    for k in fl_g:
        a = (fl_g[k] if isinstance(fl_g[k], torch.Tensor)
             else torch.tensor(flat_floats(fl_g[k]), dtype=torch.float64))
        b = (fl_c[k] if isinstance(fl_c[k], torch.Tensor)
             else torch.tensor(flat_floats(fl_c[k]), dtype=torch.float64))
        try:
            err = max(err, close(a, b, **GOLDEN_BAND))
        except AssertionError as e:
            raise AssertionError(f"(ac) {label}: {k}: {e}") from None
        n += a.numel()
    return {"exact": len(ex_g), "floats": n, "max_abs_err": err}


def ac_hold_free(label: str, card: dict, cpu: dict) -> dict:
    """``card`` against a free CPU run (no replay): every exact field
    equal, the floats in the golden band up to the first round that
    shipped a refit decoder (``ac_first_refit``; a warm-started refit
    inherits the rounding that the free runs' AE fits gathered, ROADMAP
    Queue C item 2). Returns the number of exact values, the floats held,
    the largest float difference and the last round held."""
    import torch
    ex_g, ex_c = ac_fields(card, AC_EXACT_KEYS), ac_fields(cpu, AC_EXACT_KEYS)
    require(ex_g.keys() == ex_c.keys() and ex_g,
            f"(ac) {label} free: fields {sorted(ex_g)} vs {sorted(ex_c)}")
    for k in ex_g:
        require(ex_g[k] == ex_c[k], f"(ac) {label} free: {k} card "
                f"{ex_g[k]!r} != cpu {ex_c[k]!r}")
    fl_g, fl_c = ac_fields(card, AC_FLOAT_KEYS), ac_fields(cpu, AC_FLOAT_KEYS)
    refit = ac_first_refit(card)
    if refit is not None:
        fl_g = {k: v for k, v in fl_g.items()
                if int(k.split(".")[1]) <= refit}
    require(fl_g and all(k in fl_c for k in fl_g),
            f"(ac) {label} free floats")
    err, n = 0.0, 0
    for k in fl_g:
        a = (fl_g[k] if isinstance(fl_g[k], torch.Tensor)
             else torch.tensor(flat_floats(fl_g[k]), dtype=torch.float64))
        b = (fl_c[k] if isinstance(fl_c[k], torch.Tensor)
             else torch.tensor(flat_floats(fl_c[k]), dtype=torch.float64))
        try:
            err = max(err, close(a, b, **GOLDEN_BAND))
        except AssertionError as e:
            raise AssertionError(f"(ac) {label} free: {k}: {e}") from None
        n += a.numel()
    return {"exact": len(ex_g), "floats": n, "max_abs_err": err,
            "up_to_round": refit}


def ac_first_refit(res):
    """The first round after round 0 that shipped a refit decoder, or
    None (only ``rounds.<r>.*`` floats come after it)."""
    for r in res.get("rounds", []):
        if r["round"] > 0 and r.get("ae_syncs"):
            return r["round"]
    return None


def ac_same(label: str, a: dict, b: dict) -> int:
    """Every exact and float field of two results of one call identical
    (``torch.equal`` for tensors): a replay of a run's own record gives
    that run. Returns the number of fields."""
    import torch
    fa = ac_fields(a, AC_EXACT_KEYS | AC_FLOAT_KEYS)
    fb = ac_fields(b, AC_EXACT_KEYS | AC_FLOAT_KEYS)
    require(fa.keys() == fb.keys() and fa, f"{label}: fields differ")
    for k in fa:
        x, y = fa[k], fb[k]
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else flat_floats(x) == flat_floats(y)
                if k.rsplit(".", 1)[-1] in AC_FLOAT_KEYS else x == y)
        require(same, f"{label}: {k} differs")
    return len(fa)


def flat_floats(x) -> list:
    """A nested dict/list of numbers as one flat list (sorted keys)."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat_floats(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in flat_floats(e)]
    return [float(x)]


def ac_card(label: str, small: bool = False) -> tuple:
    """``ac_call`` on the card between zeroed and read launch counters,
    recording under :class:`ExampleSpies` where a CPU replay holds it
    (``AC_REPLAYED``): (result, launches, routes, host seconds, record or
    None). Every kernel of ``AC_KERNELS[label]`` must have launched."""
    import gc
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_dense as fd
    from repro_torch.kernels import quantize as qz
    gc.collect()
    torch.cuda.empty_cache()
    routes = (qz.ROUTE_LAUNCHES, fd.ROUTE_LAUNCHES, fa.ROUTE_LAUNCHES)
    for r in routes:
        r.clear()
    _lib.reset_launches()
    spies = (ExampleSpies(tag=f"(ac) {label}") if label in AC_REPLAYED
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text, spies:
        res = ac_call(label, "cuda", small)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = _lib.counts()
    record = spies.record() if label in AC_REPLAYED else None
    AC_LOG.parent.mkdir(parents=True, exist_ok=True)
    with AC_LOG.open("a") as f:
        f.write(f"== {label} (card)\n{text.getvalue()}")
    missing = [k for k in AC_KERNELS[label] if launches.get(k, 0) < 1]
    require(not missing, f"(ac) {label}: no launch of {missing} "
            f"(launches {launches})")
    return res, launches, {k: v for r in routes for k, v in r.items()}, \
        host_s, record


def ac_replay(label: str, record: dict, small: bool = False) -> tuple:
    """``ac_call`` on the CPU replaying the card's ``record``
    (:class:`ExampleSpies`): (result, the spies' holds)."""
    with contextlib.redirect_stdout(io.StringIO()), \
            ExampleSpies(record, tag=f"(ac) {label}") as spies:
        res = ac_call(label, "cpu", small)
    return res, spies.report()


def ac_record_path(label: str) -> Path:
    return CKPT_DIR / f"ac_record_{label}.pt"


def ac_cpu_child(out_path: str, threads: str, labels) -> int:
    """A child process of run (ac): for each of ``labels`` in turn, with
    ``threads`` threads, either a free CPU run ("free:<label>",
    ``ac_call``) or, waiting for the card's record (``ac_record_path``,
    written whole by a rename), its replay (``ac_replay``), the record
    deleted after; the results, holds and seconds are saved to
    ``out_path`` with ``torch.save``."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(int(threads))
    res, holds, secs = {}, {}, {}
    for label in labels:
        t0 = time.perf_counter()
        if label.startswith("free:"):
            with contextlib.redirect_stdout(io.StringIO()):
                res[label] = ac_call(label.removeprefix("free:"), "cpu")
            secs[label] = time.perf_counter() - t0
            continue
        path = ac_record_path(label)
        deadline = time.perf_counter() + 1200
        while not path.exists():
            require(time.perf_counter() < deadline,
                    f"(ac) no card record for {label}")
            time.sleep(0.2)
        record = torch.load(path, weights_only=False)
        path.unlink()
        t0 = time.perf_counter()
        res[label], holds[label] = ac_replay(label, record)
        secs[label] = time.perf_counter() - t0
        del record
    torch.save({"results": res, "holds": holds, "seconds": secs}, out_path)
    return 0


def ac_start_cpu_jobs() -> list:
    """Start ``AC_CPU_JOBS``' child processes: (process, output path,
    labels) each. Stale records are removed first."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    for label in AC_REPLAYED:
        ac_record_path(label).unlink(missing_ok=True)
    jobs = []
    for i, (threads, labels) in enumerate(AC_CPU_JOBS):
        path = CKPT_DIR / f"ac_cpu_{i}.pt"
        path.unlink(missing_ok=True)
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ac-cpu",
             str(path), str(threads), *labels],
            env=dict(env, OMP_NUM_THREADS=str(threads)), cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, path, labels))
    return jobs


def ac_send_record(label: str, record: dict) -> None:
    """Hand the card's record to the child that replays ``label``."""
    import torch
    path = ac_record_path(label)
    tmp = path.with_suffix(".tmp")
    torch.save(record, tmp)
    os.replace(tmp, path)


def ac_join_cpu_jobs(jobs, timeout: float) -> tuple:
    """Wait for the children (killing any still running at the end or on
    failure); a child that failed fails the run. Returns (results, holds,
    seconds) by label."""
    import torch
    results, holds, secs = {}, {}, {}
    deadline = time.perf_counter() + timeout
    try:
        for proc, path, labels in jobs:
            left = max(1.0, deadline - time.perf_counter())
            out, _ = proc.communicate(timeout=left)
            require(proc.returncode == 0,
                    f"(ac) CPU child {labels} exit {proc.returncode}:\n"
                    f"{out[-4000:]}")
            got = torch.load(path, weights_only=False)
            path.unlink()
            results.update(got["results"])
            holds.update(got["holds"])
            secs.update(got["seconds"])
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for label in AC_REPLAYED:
            ac_record_path(label).unlink(missing_ok=True)
    return results, holds, secs


def ac_lm_serve_vs_cpu(card: dict) -> dict:
    """The README-sized ``llm_serve_decode`` (llama3-8b reduced, float32
    compute, kernel 6 on the FMA route) held against the CPU fed the
    card's tokens: every step's logits in run (g)'s LM band."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import llm_serve_decode as sd
    from repro_torch.examples._common import Printer
    from repro_torch.models import init_params
    cfg = get_config("llama3-8b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = sd.prompt_batch(cfg, 4, 32, torch.device("cpu"))
    forced = [card["tokens"][:, i:i + 1] for i in range(16)]
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = sd.serve(cfg, params, batch, 16, torch.device("cpu"),
                       Printer(), forced=forced)
    err = 0.0
    for i, (a, b) in enumerate(zip(card["logits"], cpu["logits"],
                                   strict=True)):
        try:
            err = max(err, close(a, b, **LM_BAND))
        except AssertionError as e:
            raise AssertionError(f"(ac) llm_serve_decode step {i}: {e}") \
                from None
    return {"steps": len(cpu["logits"]), "max_abs_err": err,
            "greedy_tokens_equal_cpu": bool(torch.equal(
                card["tokens"], cpu["tokens"]))}


def run_examples() -> dict:
    """Run (ac): every example entry point on the card (``AC_ORDER``),
    its launches (``AC_KERNELS``) and host seconds, and each held to its
    CPU replay (``ac_hold`` and the :class:`ExampleSpies` holds; child
    processes replay each card call's record as it comes)."""
    import torch
    AC_LOG.unlink(missing_ok=True)
    jobs = ac_start_cpu_jobs()
    card, rows = {}, {}
    t_phase = time.perf_counter()
    try:
        for label in AC_ORDER:
            rows[label] = {"start_s": time.perf_counter() - t_phase}
            res, counts, routes, host_s, record = ac_card(label)
            if record is not None:
                ac_send_record(label, record)
                del record
            card[label] = res
            rows[label].update(launches=counts, routes=routes,
                               host_s=host_s)
            log(f"(ac) {label}: {host_s:.3f} s, launches {counts}")
        t_card = time.perf_counter() - t_phase
        cpu, holds, cpu_s = ac_join_cpu_jobs(jobs, timeout=600)
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label in AC_REPLAYED:
        rows[label]["held"] = ac_hold(label, card[label], cpu[label])
        rows[label]["replay"] = holds[label]
        rows[label]["cpu_s"] = cpu_s[label]
    for label in AC_FREE:
        rows[label]["free"] = dict(
            ac_hold_free(label, card[label], cpu["free:" + label]),
            cpu_s=cpu_s["free:" + label])
    rows["llm_serve_decode"]["held"] = ac_lm_serve_vs_cpu(
        card["llm_serve_decode"])
    require(card["adaptive_rate_control"]["assertion"]
            == cpu["adaptive_rate_control"]["assertion"],
            "(ac) adaptive_rate_control: a different outcome on the card")
    full = card["llm_serve_decode_full"]
    require(full["params"] == AC_LLAMA_PARAMS and all(
        bool(torch.isfinite(x).all()) for x in full["logits"]),
        f"(ac) llama3-8b: {full['params']} parameters or non-finite logits")
    require(rows["llm_serve_decode_full"]["launches"] == {
        "flash_attention": 32},
        "(ac) llama3-8b: kernel 6 once a layer in prefill, nothing else")
    lm = card["llm_federated_full"]["runs"]
    require(all(math.isfinite(r["ce_loss"]) for s in lm.values()
                for r in s["rounds"]), "(ac) stablelm-1.6b: a loss")
    return {"rows": rows, "card_s": t_card,
            "phase_s": time.perf_counter() - t_phase,
            "last_start_s": max(r["start_s"] for r in rows.values())}


def main() -> int:
    # ---------------------------------------------------------- 1. device
    import torch
    t_start = time.perf_counter()

    def at(tag: str) -> None:
        """Logs the seconds since the script started, at a phase's start."""
        log(f"[{time.perf_counter() - t_start:.1f} s] phase {tag}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    require(Path(repro_torch.__file__).resolve().is_relative_to(ROOT),
            "repro_torch must come from this checkout")
    from repro_torch.core import codec
    from repro_torch.core.pytree import leaves, ravel
    from repro_torch.kernels import _lib
    from repro_torch.kernels import quantize as qz
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 references
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    # ----------------------------------------------------------- 2. build
    at("2. build")
    path, secs, ptxas = _lib.build()
    log(f"build: {len(_lib.SOURCES)} sources -> {path.name} in {secs:.1f} s")
    entry, spills = "?", ""
    for line in ptxas.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}")

    # -------------------------------------------------- 3. kernels vs plain
    at("3. kernels vs plain")
    slice_rows = {}
    slice_rows.update(check_quantize(63, 8, 0, 200))        # 15,910 / 256
    check_quantize(189, 4, 1, 20)                           # 4-bit ties
    # every layer shape of run (c): client encode 4096→512→8, client EF
    # decode and server decode 8→512→4096 (4 chunks a client, 3 clients)
    fd = [check_fused_dense(4, 4096, 512, "relu", torch.float32, 2, 50),
          check_fused_dense(4, 512, 8, "relu", torch.float32, 11, 50),
          check_fused_dense(4, 8, 512, "relu", torch.float32, 12, 50),
          check_fused_dense(4, 512, 4096, "linear", torch.float32, 3, 50),
          check_fused_dense(12, 8, 512, "relu", torch.float32, 4, 50),
          check_fused_dense(4096, 256, 32, "relu", torch.bfloat16, 5, 50)]
    slice_rows["fused_dense"] = fd[0]
    slice_rows["fused_decode_agg"] = check_decode_agg(3, 4, 512, 4096, 6, 50)
    # run (d)'s launch: 2 rungs of 2 clients, 4 chunks, 512 → 4096, 2 slots
    slice_rows["grouped_fused_decode_agg"] = check_grouped_decode_agg(
        [(2, 4), (2, 4)], 512, 4096, [0, 1], 13, 50)
    # ragged: uneven C_b and M_b, C_b = 1, an empty bucket, a shared slot;
    # mixed routes at run (d)'s widths: few_rows (3, 4) and (1, 16) beside
    # bands (2, 100) in one launch
    grouped = [check_grouped_decode_agg(
        [(3, 37), (0, 8), (1, 8), (6, 100)], 32, 256, [1, 0, 0, 1], 14, 50),
        check_grouped_decode_agg([(3, 4), (0, 8), (2, 100), (1, 16)], 512,
                                 4096, [0, 1, 0, 1], 20, 50)]
    # 2^30 values: rows of 1024, each held in a lane's registers
    cohort = (list(check_quantize(256 * 4096, 8, 7, 10).values())
              + list(check_quantize(1_048_576, 8, 81, 3,
                                    block=1024).values()))
    cohort.append(check_fused_dense(256 * 4096, 8, 32, "relu",
                                    torch.float32, 8, 10))
    cohort.append(check_fused_dense(256 * 4096, 32, 256, "linear",
                                    torch.float32, 9, 5))
    cohort.append(check_decode_agg(256, 4096, 32, 256, 10, 10))
    # the chunked AE at the cohort scale, a client's four layers (4096
    # chunks of 256): encode 256 -> 32 -> 8, EF decode 8 -> 32 -> 256; and
    # run (h)'s server hidden layer over its cohort of 64
    client = [check_fused_dense(4096, 256, 32, "relu", torch.float32, 21, 50),
              check_fused_dense(4096, 32, 8, "relu", torch.float32, 22, 50),
              check_fused_dense(4096, 8, 32, "relu", torch.float32, 23, 50),
              check_fused_dense(4096, 32, 256, "linear", torch.float32, 24,
                                50),
              check_fused_dense(64 * 4096, 8, 32, "relu", torch.float32, 25,
                                20)]
    # fl_partition's REPRO_BENCH_FULL point: bulk 983,040 = 3,840 chunks of
    # 256, hidden 32, cohort 64 as two rungs of 32 clients, two slots
    cohort.append(check_grouped_decode_agg(
        [(32, 3840), (32, 3840)], 32, 256, [0, 1], 15, 10))
    # kernel 6: run (f)'s attention (deepseek-coder-33b, 4 x 1,024 tokens,
    # 56 query heads over 8 KV heads, head dim 128, bf16, causal); a window;
    # full attention with kv lengths off the 64-row tile; float32 at D = 64
    slice_rows["flash_attention"] = check_flash(
        4, 1024, 1024, 56, 8, 128, "causal", None, torch.bfloat16, 16, 10)
    flash = [check_flash(2, 1000, 1000, 56, 8, 128, "window", 256,
                         torch.bfloat16, 17, 10),
             check_flash(2, 333, 517, 56, 8, 128, "full", None,
                         torch.bfloat16, 18, 10),
             check_flash(2, 512, 512, 32, 32, 64, "causal", None,
                         torch.float32, 19, 10)]
    # runs (i) and (j): the q8 of 1,080 latents (17 blocks of 64) a
    # client and the server's 100 x 17 rows; a client's chunked-AE
    # encode 4096 -> 512 -> 8 and EF decode 8 -> 512 -> 4096 over 135
    # chunks, the server's hidden layer over 100 x 135 chunks and its
    # kernel-4 reduce; the q8 of 159 top-k values (one block of 256) a
    # client and the server's 50 rows
    runtime = (list(check_quantize(17, 8, 26, 50, block=64).values())
               + list(check_quantize(1700, 8, 27, 50, block=64).values())
               + [check_fused_dense(135, 4096, 512, "relu", torch.float32,
                                    28, 50),
                  check_fused_dense(135, 512, 8, "relu", torch.float32, 29,
                                    50),
                  check_fused_dense(135, 8, 512, "relu", torch.float32, 30,
                                    50),
                  check_fused_dense(135, 512, 4096, "linear", torch.float32,
                                    31, 50),
                  check_fused_dense(13_500, 8, 512, "relu", torch.float32,
                                    32, 20),
                  check_decode_agg(100, 135, 512, 4096, 33, 20)]
               + list(check_quantize(1, 8, 34, 50).values())
               + list(check_quantize(50, 8, 35, 50).values()))
    # run (k)'s server (8 clients, until the first refit): the latents'
    # dequantize (8 x 17 rows), the hidden layer over 8 x 135 chunks and
    # the kernel-4 reduce; its clients' layers are run (i)'s above
    runtime += (list(check_quantize(136, 8, 36, 50, block=64).values())
                + [check_fused_dense(1080, 8, 512, "relu", torch.float32,
                                     37, 50),
                   check_decode_agg(8, 135, 512, 4096, 38, 20)])
    # run (n): a client's chunked-AE encode of dense0 (1,802 chunks of 256
    # -> 32 -> 4), the server's hidden layer over 8 x 1,802 latent chunks
    # and its grouped launch (one bucket of 8 clients on one decoder, K 32,
    # N 256), the probe's folded encode and decode over the 8 lanes' 14,416
    # chunks, and the q8 rung of dense0 (1,802 blocks)
    rate_n = (list(check_quantize(1802, 8, 41, 20).values())
              + [check_fused_dense(1802, 256, 32, "relu", torch.float32,
                                   42, 50),
                 check_fused_dense(1802, 32, 4, "relu", torch.float32, 43,
                                   50),
                 check_fused_dense(14_416, 4, 32, "relu", torch.float32, 44,
                                   20),
                 check_fused_dense(14_416, 256, 32, "relu", torch.float32,
                                   45, 20),
                 check_fused_dense(14_416, 32, 256, "linear", torch.float32,
                                   46, 20),
                 check_grouped_decode_agg([(8, 1802)], 32, 256, [0], 47,
                                          20)])
    # runs (o) and (q): the serve loop's AE row (its server hidden layer
    # over 256 clients' 256 chunks, its kernel-4 reduce); the q8 rows'
    # dequantize at K 65,536 (one block of 2^10 a client) and at K 256
    # (256 blocks of 256 a client; K 4,096's is the (2^20, 256) above);
    # run (q)'s LM path at 2 layers: the
    # q8 of the embedding group (1,605,632 blocks of 256) and of the
    # attention group (131,072), the mlp group's chunked AE over 270,336
    # chunks (encode 256 -> 32 -> 8, EF decode 8 -> 32 -> 256), the
    # server's hidden layer over both clients' chunks and its reduce, and
    # evaluate's attention (2 x 512 tokens, 32 heads of 64, bf16, causal)
    serve_lm = (
        [check_fused_dense(65_536, 8, 32, "relu", torch.float32, 48, 20),
         check_decode_agg(256, 256, 32, 256, 49, 20)]
        + list(check_quantize(65_536, 8, 59, 10, block=1024).values())
        + list(check_quantize(65_536, 8, 60, 10).values())
        + list(check_quantize(1_605_632, 8, 50, 5).values())
        + list(check_quantize(131_072, 8, 51, 10).values())
        + [check_fused_dense(270_336, 256, 32, "relu", torch.float32, 52,
                             5),
           check_fused_dense(270_336, 32, 8, "relu", torch.float32, 53, 5),
           check_fused_dense(270_336, 8, 32, "relu", torch.float32, 54, 5),
           check_fused_dense(270_336, 32, 256, "linear", torch.float32, 55,
                             5),
           check_fused_dense(540_672, 8, 32, "relu", torch.float32, 56, 5),
           check_decode_agg(2, 270_336, 32, 256, 57, 5),
           check_flash(2, 512, 512, 32, 32, 64, "causal", None,
                       torch.bfloat16, 58, 10)])
    # runs (r) and (t): MLA's attention on kernel 6 natively (40 heads,
    # q/k 96, v 64, bf16, causal) at run (r)'s prefill (4 x 1,024) and run
    # (t)'s evaluate (2 x 512), each beside the padded route; run (t)'s
    # codec layers: the q8 of its embedding (734,720 blocks of 256) and
    # attention (422,433) groups, the mlp group's chunked AE over 1,536,000
    # chunks and the server's hidden layer and reduce
    mla = [check_flash_pair(4, 1024, 40, 96, 64, torch.bfloat16, 61, 10),
           check_flash_pair(2, 512, 40, 96, 64, torch.bfloat16, 62, 10)]
    mla_t = (list(check_quantize(734_720, 8, 63, 5).values())
             + list(check_quantize(422_433, 8, 64, 5).values())
             + [check_fused_dense(1_536_000, 256, 32, "relu", torch.float32,
                                  65, 3),
                check_fused_dense(1_536_000, 32, 8, "relu", torch.float32,
                                  66, 3),
                check_fused_dense(3_072_000, 8, 32, "relu", torch.float32,
                                  67, 3),
                check_decode_agg(2, 1_536_000, 32, 256, 68, 3)])
    # runs (w), (x), (y): kernel 6 at head dim 256 (recurrentgemma-9b's
    # local attention, window 2,048, 16 heads over one kv head), whisper's
    # encoder (full over 1,500 frames), its decoder's self-attention
    # (causal) and cross-attention (full, 448 queries over 1,500 frames),
    # phi-3's heads of 96 natively (beside the padded route), all bf16; the
    # padded route at a head dim with no instantiation (192 -> 256)
    fam = dict(
        d256_window_run_w=check_flash(2, 4096, 4096, 16, 1, 256, "window",
                                      2048, torch.bfloat16, 71, 5),
        encoder_run_x=check_flash(4, 1500, 1500, 16, 16, 64, "full", None,
                                  torch.bfloat16, 72, 10),
        decoder_run_x=check_flash(4, 448, 448, 16, 16, 64, "causal", None,
                                  torch.bfloat16, 73, 10),
        cross_run_x=check_flash(4, 448, 1500, 16, 16, 64, "full", None,
                                torch.bfloat16, 74, 10),
        pair_run_y=check_flash_pair(4, 1024, 32, 96, 96, torch.bfloat16, 75,
                                    10),
        padded_d192=check_flash_padded(2, 512, 8, 192, 192, torch.bfloat16,
                                       81, 10))
    # kernel 6's whole argument list: softcap 50 at run (f)'s shape; a
    # chunked prefill, Sq 256 at the end of Skv 1,024 (q_offset 768),
    # causal and window 512; both in float32 at D 64 on the FMA kernel;
    # extra_qk at minicpm3-4b's decomposed MLA scores (40 heads, nope 64 +
    # rope 32 against a shared k_rope, v 64, 4 x 1,024, bf16 causal)
    args6 = dict(
        softcap_run_f=check_flash(4, 1024, 1024, 56, 8, 128, "causal", None,
                                  torch.bfloat16, 76, 10, softcap=50.0),
        q_offset_causal=check_flash(4, 256, 1024, 56, 8, 128, "causal",
                                    None, torch.bfloat16, 77, 10,
                                    q_offset=768),
        q_offset_window=check_flash(4, 256, 1024, 56, 8, 128, "window",
                                    512, torch.bfloat16, 78, 10,
                                    q_offset=768),
        q_offset_softcap_f32=check_flash(2, 256, 512, 32, 32, 64, "causal",
                                         None, torch.float32, 79, 10,
                                         q_offset=256, softcap=30.0),
        extra_qk_minicpm3=check_flash_extra(4, 1024, 40, 64, 32, 64,
                                            torch.bfloat16, 80, 10))
    for r in (fd[1:] + grouped + cohort + client
              + [slice_rows["flash_attention"]] + flash + runtime + rate_n
              + serve_lm + mla + mla_t + list(fam.values())
              + list(args6.values())):
        log("kernel " + json.dumps(r))
    log("kernels vs plain: all within tolerance")

    # ------------------------------------------------------------ 4. slice
    at("4. slice")
    launches = {}
    _lib.reset_launches()
    qz.ROUTE_LAUNCHES.clear()
    run_a, hist_a = run_golden("cuda")
    torch.cuda.synchronize()
    counts_a = _lib.counts()
    launches["quant_routes_run_a"] = quant_routes(counts_a)
    log(f"slice (a) q8 golden config: launches {counts_a}; "
        + "; ".join(f"r{r.round} loss {r.global_metrics['loss']!r} acc "
                    f"{r.global_metrics['accuracy']!r}" for r in hist_a))
    check_records(hist_a, 3 * (63 * 256 + 63 * 4), 3 * 15_910 * 4,
                  3 * 15_910 * 4)
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d"):
        require(counts_a.get(k, 0) > 0, f"run (a) never launched {k}")
        launches[k] = counts_a[k]
    err = check_cuda_vs_cpu("run (a)", run_a, hist_a, *run_golden("cpu"))
    log("slice (a) cuda == cpu: bytes exact, loss/accuracy/params within "
        f"atol=2e-5 rtol=2e-4 (params max abs err {err!r})")

    _lib.reset_launches()
    t0 = time.perf_counter()
    pre, run_b, hist_b = run_fc_ae("cuda")
    torch.cuda.synchronize()
    counts_b = _lib.counts()
    ae_hist = pre["ae_history"]["loss"]
    log(f"slice (b) prepass + FC-AE: {time.perf_counter() - t0:.1f} s, AE "
        f"loss {ae_hist[0]!r} -> {ae_hist[-1]!r}, ratio "
        f"{hist_b[-1].compression_ratio!r}, launches {counts_b} (the FC AE "
        "is plain matrix products)")
    require(ae_hist[-1] < ae_hist[0], "AE training did not descend")
    check_records(hist_b, 2 * 32 * 4, 2 * 15_910 * 4, 2 * 15_910 * 4)
    require(hist_b[-1].compression_ratio > 300, "FC-AE ratio <= 300")
    require(run_b.total_bytes()["effective_ratio"] > 300, "effective ratio")

    from repro_torch.kernels import fused_dense as fd_mod
    _lib.reset_launches()
    fd_mod.ROUTE_LAUNCHES.clear()
    run_c, hist_c = run_chunked("cuda")
    torch.cuda.synchronize()
    counts_c = _lib.counts()
    routes_c = dict(fd_mod.ROUTE_LAUNCHES)
    log(f"slice (c) chunked AE 4096/(512,)/8 kernel path: launches "
        f"{counts_c}, fused_dense by route {routes_c}; loss "
        f"{hist_c[-1].global_metrics['loss']!r}")
    check_records(hist_c, 3 * 4 * 8 * 4, 3 * 15_910 * 4, 3 * 15_910 * 4)
    for k in ("fused_dense", "fused_decode_agg"):
        require(counts_c.get(k, 0) > 0, f"run (c) never launched {k}")
        launches[k] = counts_c[k]
    require(sum(routes_c.values()) == counts_c["fused_dense"],
            "run (c): route counts do not add up")
    err = check_cuda_vs_cpu("run (c)", run_c, hist_c, *run_chunked("cpu"))
    log("slice (c) cuda == cpu: bytes exact, loss/accuracy/params within "
        f"atol=2e-5 rtol=2e-4 (params max abs err {err!r})")

    raw4 = 4 * 15_910 * 4
    for tag, runner, up in (("(d) partitioned", run_partitioned,
                             2 * 128 + 2 * 64 + 2 * 260 + 2 * 132),
                            ("(e) flat mixed", run_flat_mixed,
                             128 + 64 + 16_380 + 8_316)):
        _lib.reset_launches()
        run_x, hist_x = runner("cuda")
        torch.cuda.synchronize()
        counts_x = _lib.counts()
        log(f"slice {tag} grouped: launches {counts_x}; "
            + "; ".join(f"r{r.round} loss {r.global_metrics['loss']!r} acc "
                        f"{r.global_metrics['accuracy']!r}" for r in hist_x))
        check_records(hist_x, up, raw4, raw4)
        require(counts_x.get("grouped_fused_decode_agg", 0) > 0,
                f"run {tag} never launched grouped_fused_decode_agg")
        require("fused_decode_agg" not in counts_x,
                f"run {tag} launched the per-bucket fused_decode_agg")
        launches.setdefault("grouped_fused_decode_agg",
                            counts_x["grouped_fused_decode_agg"])
        err = check_cuda_vs_cpu(f"run {tag} cuda/cpu", run_x, hist_x,
                                *runner("cpu"))
        err_off = check_cuda_vs_cpu(f"run {tag} grouped/sequential", run_x,
                                    hist_x, *runner("cuda", grouped=False),
                                    atol=1e-5, rtol=1e-4)
        log(f"slice {tag} cuda == cpu: bytes exact, loss/accuracy/params "
            f"within atol=2e-5 rtol=2e-4 (params max abs err {err!r}); "
            "== grouped off on the card within atol=1e-5 rtol=1e-4 "
            f"(params max abs err {err_off!r})")

    # ----------------------------------------------------- 5. LM serving
    at("5. LM serving")
    lm = run_lm_serving()
    launches["flash_attention"] = lm["launches_prefill"]["flash_attention"]
    log("lm (f) " + json.dumps(lm))
    log(f"lm (f) deepseek-coder-33b x{lm['n_layers']} layers: prefill 4 x "
        f"1024 tokens in "
        f"{lm['prefill_s']:.4f} s, decode step median "
        f"{lm['decode_step_median_s']:.4f} s, peak "
        f"{lm['peak_memory_bytes'] / 2**30:.2f} GiB; flash_attention "
        f"{lm['launches_prefill']} in prefill, none in decode")
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    lm_g = run_lm_card_vs_cpu()
    log("lm (g) cuda == cpu within atol=1e-4 rtol=1e-3 (float32 compute), "
        "bfloat16 prefill within 2 x the CPU's bfloat16 error: "
        + json.dumps(lm_g))

    # ------------------------------------------------- 6. cohort round
    at("6. cohort round")
    gc.collect()
    torch.cuda.empty_cache()
    run_cohort_round("cuda", cohort=2)                   # warm-up
    _lib.reset_launches()
    fd_mod.ROUTE_LAUNCHES.clear()
    mean_h, z_h, round_s = run_cohort_round("cuda")
    counts_h = _lib.counts()
    routes_h = dict(fd_mod.ROUTE_LAUNCHES)
    require(counts_h.get("fused_dense", 0) >= 2 * 64 + 1
            and counts_h.get("fused_decode_agg", 0) == 1
            and set(counts_h) == {"fused_dense", "fused_decode_agg"},
            f"run (h) launches {counts_h}")
    require(tuple(mean_h.shape) == (1 << 20,)
            and tuple(z_h.shape) == (64, 4096, 8), "run (h) shapes")
    mean_c, z_c, _ = run_cohort_round("cpu")
    err_z = close(z_h.cpu(), z_c, **GOLDEN_BAND)
    err_mean = close(mean_h.cpu(), mean_c, **GOLDEN_BAND)
    shapes_h = {f"{M},{K},{N}": fd_mod.kernel_route(M, K, N, torch.float32)
                for M, K, N in ((4096, 256, 32), (4096, 32, 8),
                                (64 * 4096, 8, 32))}
    require(sum(routes_h.values()) == counts_h["fused_dense"]
            and routes_h.get("sgemm") == 64 and routes_h.get("narrow") == 65,
            f"run (h) fused_dense by route {routes_h}")
    launches["fused_dense_run_h"] = counts_h["fused_dense"]
    launches["fused_decode_agg_run_h"] = counts_h["fused_decode_agg"]
    log(f"cohort (h) chunked AE 256/(32,)/8, 2^20 values, 64 clients: "
        f"launches {counts_h}, fused_dense by route {routes_h}; routes by "
        f"shape {shapes_h}; latents and mean update == cpu within "
        f"atol=2e-5 rtol=2e-4 (max abs err {err_z!r}, {err_mean!r})")
    log(f"cohort (h) round wall time {round_s!r} s (host clock, 64 encodes "
        "+ stack + decode_and_aggregate, ended by a synchronize)")

    # ------------------------------------------------ 7. scalable runtime
    at("7. scalable runtime")
    gc.collect()
    torch.cuda.empty_cache()
    _lib.reset_launches()
    fd_mod.ROUTE_LAUNCHES.clear()
    run_i, hist_i, secs_i, sched_i = run_sampled_cnn("cuda")
    counts_i = _lib.counts()
    routes_i = dict(fd_mod.ROUTE_LAUNCHES)
    n_i = sum(t.numel() for t in leaves(run_i.global_params))
    require(n_i == CIFAR_PARAMS, f"run (i) holds {n_i} parameters")
    require((sched_i.vmap_rounds, sched_i.loop_rounds) == (2, 0),
            f"run (i) vmap/loop rounds {sched_i.vmap_rounds}, "
            f"{sched_i.loop_rounds}")
    # 135 chunks x 8 latents = 1,080 -> 17 blocks of 64: codes + scales
    comp_i = run_i.compressors[0]
    wire_i = codec.wire_bytes(comp_i.spec(CIFAR_PARAMS),
                              comp_i.codec_params())
    require(wire_i == 17 * 64 + 17 * 4, f"run (i) wire bytes {wire_i}")
    check_records(hist_i, 100 * wire_i, 100 * CIFAR_PARAMS * 4,
                  100 * CIFAR_PARAMS * 4)
    for r in hist_i:
        require(len(r.participants) == 100, "run (i) cohort size")
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d", "fused_dense",
              "fused_decode_agg"):
        require(counts_i.get(k, 0) > 0, f"run (i) never launched {k}")
        launches[k + "_run_i"] = counts_i[k]
    log(f"runtime (i) SampledSync CIFAR CNN ({n_i} params), 100 of 1,000 "
        f"clients, composed chunked AE q8: launches {counts_i}, fused_dense "
        f"by route {routes_i}; vmap rounds {sched_i.vmap_rounds}; "
        + "; ".join(f"r{r.round} loss {r.global_metrics['loss']!r} up "
                    f"{r.bytes_up!r} B" for r in hist_i))
    log(f"runtime (i) round wall time {secs_i!r} s (host clock, vmapped "
        "local step + 100 encodes + EF decodes + decode_and_aggregate + "
        "eval, each ended by a synchronize)")
    del run_i
    gc.collect()
    torch.cuda.empty_cache()
    run_ig, hist_ig, _, _ = run_sampled_cnn("cuda", 16, 4)
    run_ic, hist_ic, _, _ = run_sampled_cnn("cpu", 16, 4)
    for g, c in zip(hist_ig, hist_ic, strict=True):
        require(g.participants == c.participants, "run (i) reduced cohorts")
    err = check_cuda_vs_cpu("run (i) reduced", run_ig, hist_ig, run_ic,
                            hist_ic)
    log("runtime (i) reduced (16 clients, cohort 4) cuda == cpu: cohorts "
        "and bytes exact, loss/accuracy/params within atol=2e-5 rtol=2e-4 "
        f"(params max abs err {err!r})")

    from repro_torch.configs.paper import SMOKE_SCALE_SCENARIO
    # the two engines and, for run (p), the struct-of-arrays pool on the
    # vector engine in turns (heap, vector, soa, vector, soa, heap): every
    # run must give the first one's traces and bit-identical parameters
    from repro_torch.core import ClientPool
    runs_j, secs_j = [], {"heap": [], "vector": [], "soa": []}
    for layout in ("heap", "vector", "soa", "vector", "soa", "heap"):
        _lib.reset_launches()
        run_x, hist_x, secs_x = run_async_mlp(
            "cuda", engine="heap" if layout == "heap" else "vector",
            soa=layout == "soa")
        require(isinstance(run_x.clients, ClientPool) == (layout == "soa"),
                f"run (j) {layout}: client layout")
        runs_j.append((layout, hist_x, ravel(run_x.global_params)[0],
                       _lib.counts()))
        secs_j[layout].append(secs_x)
        if len(runs_j) == 1:
            comp_j = run_x.compressors[0]
        del run_x
    _, hist_jh, params_jh, counts_j = runs_j[0]
    for layout, hist_x, params_x, _ in runs_j[1:]:
        check_same_trace(f"run (j) heap/{layout}", hist_jh, hist_x)
        require(all(x.global_metrics == y.global_metrics
                    for x, y in zip(hist_jh, hist_x)),
                f"run (j) heap/{layout}: metrics differ")
        require(torch.equal(params_jh, params_x),
                f"run (j): the {layout} run's parameters differ")
    for r in hist_jh:
        require(len(r.participants) == 50, "run (j) buffer size")
        require(math.isfinite(r.global_metrics["loss"]), "run (j) loss")
    # k = 159: int32 indices + one q8 block of the values
    wire_j = codec.wire_bytes(comp_j.spec(15_910))
    require(wire_j == 159 * 4 + 256 + 4, f"run (j) wire bytes {wire_j}")
    require(all(r.bytes_up == 50 * wire_j for r in hist_jh),
            "run (j) bytes_up")
    require(hist_jh[0].bytes_down == 1000 * 15_910 * 4
            and all(r.bytes_down == 50 * 15_910 * 4 for r in hist_jh[1:]),
            "run (j) bytes_down")
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d"):
        require(counts_j.get(k, 0) > 0, f"run (j) never launched {k}")
        launches[k + "_run_j"] = counts_j[k]
    counts_pj = runs_j[2][3]
    log(f"runtime (j) AsyncBuffered MNIST MLP, 1,000 clients, K 50, TopK "
        f"1 % -> q8: launches {counts_j}; heap == vector (traces, bytes, "
        "torch.equal params); "
        + "; ".join(f"r{r.round} staleness max {max(r.staleness)} sim_time "
                    f"{r.sim_time!r} loss {r.global_metrics['loss']!r}"
                    for r in hist_jh))
    log(f"runtime (j) round wall time in turns heap, vector, soa, vector, "
        f"soa, heap: heap {secs_j['heap']!r} s, vector {secs_j['vector']!r} "
        "s (host clock, each ended by a synchronize)")
    del runs_j
    log(f"soa (p) run (j) soa_state=True, vector engine == eager heap "
        f"(traces, bytes, metrics, torch.equal params), twice: launches "
        f"{counts_pj}; round host s in turns with the eager vector runs: "
        f"eager {secs_j['vector']!r}, SoA {secs_j['soa']!r}")
    log("soa (p) run (j) round 1 under cProfile, eager and SoA in turns, "
        "twice (host s: the round, the calls into core/soa.py, the garbage "
        "collector, the five costliest functions): "
        + json.dumps([{layout: profiled_async_round(layout == "soa")
                       for layout in ("vector", "soa")} for _ in range(2)]))
    for engine in ("heap", "vector"):
        run_g, hist_g, _ = run_async_mlp("cuda", SMOKE_SCALE_SCENARIO,
                                         engine)
        run_jc, hist_jc, _ = run_async_mlp("cpu", SMOKE_SCALE_SCENARIO,
                                           engine)
        check_same_trace(f"run (j) reduced {engine} cuda/cpu", hist_g,
                         hist_jc)
        err = check_cuda_vs_cpu(f"run (j) reduced {engine}", run_g, hist_g,
                                run_jc, hist_jc)
        log(f"runtime (j) reduced ({engine}, 16 clients, K 4) cuda == cpu: "
            "arrival traces exact, loss/accuracy/params within atol=2e-5 "
            f"rtol=2e-4 (params max abs err {err!r})")
    log("runtime scatter route: " + json.dumps(check_scatter_route()))
    # run (j) across a checkpoint: save after round 1 with one engine,
    # restore into the other, play round 2; it must equal the first
    # uninterrupted run (heap) bit for bit, downlink bytes included
    for saver, loader in (("heap", "vector"), ("vector", "heap")):
        path = CKPT_DIR / f"run_j_{saver}.npz"
        CKPT_DIR.mkdir(parents=True, exist_ok=True)
        first = build_async_mlp("cuda", engine=saver, rounds=2)
        _timed_rounds(first, 2, "cuda")
        first.save_state(str(path))
        del first
        resumed = build_async_mlp("cuda", engine=loader, rounds=1)
        require(resumed.load_state(str(path)) == 2, "run (j) restore")
        path.unlink()
        resumed.run()
        require(torch.equal(ravel(resumed.global_params)[0], params_jh),
                f"run (j) {saver} -> {loader}: parameters differ")
        x, y = hist_jh[2], resumed.history[0]
        for k in RECORD_BYTES:
            require(getattr(x, k) == getattr(y, k),
                    f"run (j) {saver} -> {loader}: {k} differ")
        log(f"runtime (j) saved after round 1 ({saver} engine), restored "
            f"into the {loader} engine: round 2 torch.equal to the "
            f"uninterrupted run, bytes_down {y.bytes_down!r} equal")
        del resumed

    # ---------------------------------------- 8. lifecycle and resume (k)
    at("8. lifecycle and resume (k)")
    gc.collect()
    torch.cuda.empty_cache()
    # cuDNN's conv weight gradient may add with atomics; a resume is held
    # to torch.equal, so runs (k) and (l) take its deterministic algorithms
    torch.backends.cudnn.deterministic = True
    _lib.reset_launches()
    fd_mod.ROUTE_LAUNCHES.clear()
    with CohortSpy() as spy:
        run_k = build_lifecycle_cnn("cuda")
        plays_k = play(run_k, 6, "cuda", spy)
    torch.cuda.synchronize()
    counts_k = _lib.counts()
    routes_k = dict(fd_mod.ROUTE_LAUNCHES)
    hist_k = run_k.history
    from repro_torch.core import (ChunkedAEConfig, SavingsModel,
                                  ae_param_count, train_autoencoder_cohort)
    from repro_torch.core.autoencoder import decoder_sync_bytes
    from repro_torch.core.pytree import stack as stack_trees, tree_map
    # decoder ships and AE sizes depend on shapes alone
    ae_k = run_k.compressors[0].codec_params()
    ship_k = decoder_sync_bytes(ae_k)
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d", "fused_dense",
              "fused_decode_agg"):
        require(counts_k.get(k, 0) > 0, f"run (k) never launched {k}")
        launches[k + "_run_k"] = counts_k[k]
    require(hist_k[0].ae_syncs == list(range(8))
            and hist_k[0].bytes_decoder == 8 * ship_k,
            "run (k): round 0 must ship the 8 initial decoders")
    refit_rounds = [p["round"] for p in plays_k if p["refits"]]
    require(2 in refit_rounds and hist_k[2].ae_syncs == list(range(8)),
            "run (k): the cadence must refit all 8 clients at round 2")
    for p, rec in zip(plays_k, hist_k):
        n_refit = len(rec.ae_syncs) if rec.round else 0
        require(len(p["refits"]) == (1 if n_refit else 0)
                and all(c["C"] == n_refit for c in p["refits"]),
                f"run (k) round {rec.round}: refits {p['refits']} for "
                f"{n_refit} clients, not one cohort dispatch")
        require(rec.bytes_up == 8 * 1156.0
                and rec.bytes_up_measured == rec.bytes_up
                and rec.bytes_down == 8 * CIFAR_PARAMS * 4
                + len(rec.ae_syncs) * ship_k
                and math.isfinite(rec.global_metrics["loss"]),
                f"run (k) round {rec.round} bytes")
        # one decoder for all until the first refit takes effect; then
        # each client decodes with its own (the per-client route)
        k4 = p["launches"].get("fused_decode_agg", 0)
        require(k4 == (1 if rec.round <= refit_rounds[0] else 0),
                f"run (k) round {rec.round}: kernel 4 launched {k4} times")
    ae_size = ae_param_count(ae_k)
    rec_k = run_k.savings_report(SavingsModel(
        original_size=CIFAR_PARAMS, compressed_size=1156 // 4,
        autoencoder_size=ae_size))
    require(rec_k["observed_decoder_bytes"]
            == sum(r.bytes_decoder for r in hist_k)
            and rec_k["decoder_syncs"] == sum(len(r.ae_syncs)
                                              for r in hist_k)
            and rec_k["decoder_rel_err"] < 0.01,
            f"run (k) reconcile {rec_k}")
    log(f"lifecycle (k) SyncFedAvg CIFAR CNN ({CIFAR_PARAMS} params), 8 "
        f"clients, composed chunked AE q8, AELifecycle({LIFECYCLE_K}): "
        f"launches {counts_k}, fused_dense by route {routes_k}")
    for p, rec in zip(plays_k, hist_k):
        log(f"lifecycle (k) r{rec.round}: {p['s']!r} s (host clock), "
            f"launches {p['launches']}, fused_dense by route {p['routes']}, "
            f"ae_syncs {rec.ae_syncs}, bytes_decoder {rec.bytes_decoder!r}, "
            f"refits {p['refits']}, loss {rec.global_metrics['loss']!r}")
    log("lifecycle (k) savings.reconcile " + json.dumps(rec_k))
    # run-to-run: the uninterrupted run again must be torch.equal, so a
    # difference after a resume is the resume's
    run_k2 = build_lifecycle_cnn("cuda")
    play(run_k2, 6, "cuda")
    check_resume("run (k) rerun", run_k, run_k2, 0)
    del run_k2
    with CohortSpy() as spy_r:
        res_k, plays_kr, nbytes_k, save_k, load_k = resume_via_checkpoint(
            "run_k", lambda n: build_lifecycle_cnn("cuda", rounds=n), 4, 2,
            "cuda")
    check_resume("run (k) resume", run_k, res_k, 4)
    require([c["C"] for c in spy_r.calls]
            == [len(r.ae_syncs) for r in run_k.history
                if r.round and r.ae_syncs],
            "run (k) resume: refits differ")
    log(f"lifecycle (k) saved after round 3 ({nbytes_k} B, {save_k!r} s), "
        f"loaded into a fresh run ({load_k!r} s), rounds 4-5 "
        f"({[p['s'] for p in plays_kr]!r} s): params, residuals, codec "
        "params, snapshot rings and records torch.equal / equal to the "
        "uninterrupted run (which a rerun reproduced bit for bit)")
    del res_k
    # run (p), part 2: run (k) with the client state a struct-of-arrays
    # pool (the snapshot rings in use), against the eager run; an SoA
    # resume; and the cross restores (the checkpoint's layout decides)
    _lib.reset_launches()
    with CohortSpy() as spy_s:
        run_ks = build_lifecycle_cnn("cuda", soa=True)
        plays_ks = play(run_ks, 6, "cuda", spy_s)
    torch.cuda.synchronize()
    counts_pk = _lib.counts()
    require(isinstance(run_ks.clients, ClientPool), "run (p) (k): not SoA")
    check_resume("run (p) (k) SoA vs eager", run_k, run_ks, 0)
    require([c["C"] for c in spy_s.calls] == [c["C"] for c in spy.calls],
            "run (p) (k): refits differ")
    del run_ks
    for x in set(counts_pj) | set(counts_pk):
        launches[f"{x}_run_p"] = counts_pj.get(x, 0) + counts_pk.get(x, 0)

    def k_soa(n):
        return build_lifecycle_cnn("cuda", rounds=n, soa=True)

    def k_eager(n):
        return build_lifecycle_cnn("cuda", rounds=n)
    cross = {}
    for tag, saver, loader in (("soa", k_soa, None),
                               ("eager_to_soa", k_eager, k_soa),
                               ("soa_to_eager", k_soa, k_eager)):
        res_x, plays_x, nbytes_x, _, _ = resume_via_checkpoint(
            f"run_k_{tag}", saver, 4, 2, "cuda", build_resumed=loader)
        require(isinstance(res_x.clients, ClientPool)
                == (saver is k_soa), f"run (p) (k) {tag}: the checkpoint's "
                "layout must decide")
        check_resume(f"run (p) (k) {tag}", run_k, res_x, 4)
        cross[tag] = nbytes_x
        del res_x
    log(f"soa (p) run (k) soa_state=True == eager: params, residuals, "
        f"codec params, snapshot rings, scalars and records torch.equal / "
        f"equal; launches {counts_pk}; round host s eager "
        f"{[p['s'] for p in plays_k]!r}, SoA {[p['s'] for p in plays_ks]!r}; "
        f"resumed after round 3 SoA -> SoA, eager -> SoA ctor, SoA -> "
        f"eager ctor: torch.equal (checkpoint bytes {cross})")
    del run_k
    gc.collect()
    torch.cuda.empty_cache()
    runs_kr = {dev: build_lifecycle_cnn(dev, 2, 3, LIFECYCLE_K_REDUCED)
               for dev in ("cuda", "cpu")}
    hists_kr = {dev: r.run() for dev, r in runs_kr.items()}
    for g, c in zip(hists_kr["cuda"], hists_kr["cpu"], strict=True):
        require(g.ae_syncs == c.ae_syncs and g.bytes_decoder
                == c.bytes_decoder, "run (k) reduced: syncs differ")
    err_kr = check_cuda_vs_cpu("run (k) reduced", runs_kr["cuda"],
                               hists_kr["cuda"], runs_kr["cpu"],
                               hists_kr["cpu"])
    # the refit on identical inputs: the CPU copy's refit rows and AE
    # params, fitted as its next refit would be, on the card and the CPU
    lc_kr, run_kc = runs_kr["cpu"].lifecycle, runs_kr["cpu"]
    rows = torch.stack([lc_kr._refit_dataset(run_kc, ci)[1]
                        for ci in range(2)])
    init = stack_trees([c.codec_params() for c in run_kc.compressors])
    fits = {}
    for dev in ("cuda", "cpu"):
        fits[dev] = train_autoencoder_cohort(
            [lc_kr._rng(3, ci) for ci in range(2)],
            ChunkedAEConfig().as_fc(), rows.to(dev),
            init=tree_map(lambda t, d=dev: t.to(d), init),
            epochs=LIFECYCLE_K_REDUCED["refresh_epochs"],
            refit_normalizer=False)[0]
    err_fit = max(close(a.cpu(), b, **GOLDEN_BAND) for a, b in zip(
        leaves(fits["cuda"]), leaves(fits["cpu"])))
    # what the two runs' clients hold: their snapshot rings and refit AEs
    # follow each client's own error feedback, where a latent's q8 code
    # may round differently on the two sides (reported, not held)
    run_kg = runs_kr["cuda"]
    err_snap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        leaves([c.snapshots for c in run_kg.clients]),
        leaves([c.snapshots for c in run_kc.clients])))
    err_ae = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        leaves([c.codec_params() for c in run_kg.compressors]),
        leaves([c.codec_params() for c in run_kc.compressors])))
    log(f"lifecycle (k) reduced (2 clients, 3 rounds, "
        f"AELifecycle({LIFECYCLE_K_REDUCED})) cuda == cpu: syncs and bytes "
        f"exact, loss/accuracy/params within atol=2e-5 rtol=2e-4 (params "
        f"max abs err {err_kr!r}); a refit on identical rows and warm start "
        f"within atol=2e-5 rtol=2e-4 (max abs err {err_fit!r}); the runs' "
        f"snapshot rings differ by up to {err_snap!r}, their refit AE "
        f"params by up to {err_ae!r}; ae_syncs "
        f"{[r.ae_syncs for r in hists_kr['cuda']]}")
    del runs_kr, hists_kr, fits

    # ------------------------------- 9. the paper's §5.2 federation (l)
    at("9. the paper's §5.2 federation (l)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre_l = prepass_color_imbalance("cuda")
    torch.cuda.synchronize()
    prepass_s = time.perf_counter() - t0
    ae_cfg_l, aes_l = pre_l[2], pre_l[3]
    n_ae_l = ae_param_count(aes_l[0])
    ship_l = decoder_sync_bytes(aes_l[0])
    for h in pre_l[4]:
        require(h[-1] < h[0], "run (l): the pre-pass AE fit did not descend")
    with CohortSpy() as spy_l:
        run_l = build_color_imbalance(pre_l, "cuda", 4)
        plays_l = play(run_l, 4, "cuda", spy_l)
    hist_l = run_l.history
    require(run_l.clients[0].last_refresh >= 0 and hist_l[0].ae_syncs
            == [0, 1] and hist_l[0].bytes_decoder == 2 * ship_l,
            "run (l): round 0 must ship both decoders")
    require(hist_l[2].ae_syncs == [0, 1] and len(spy_l.calls) >= 1
            and any(c["C"] == 2 for c in spy_l.calls),
            "run (l): the cadence must refit both in one cohort dispatch")
    for p, rec in zip(plays_l, hist_l):
        require(len(p["refits"]) <= 1, f"run (l) round {rec.round} refits")
        require(rec.bytes_up == 2 * 320 * 4
                and rec.bytes_up_raw == 2 * CIFAR_PARAMS * 4
                and rec.bytes_down == 2 * CIFAR_PARAMS * 4
                + len(rec.ae_syncs) * ship_l
                and math.isfinite(rec.global_metrics["loss"]),
                f"run (l) round {rec.round} bytes")
    rec_l = run_l.savings_report(SavingsModel(
        original_size=CIFAR_PARAMS, compressed_size=320,
        autoencoder_size=n_ae_l))
    require(rec_l["observed_decoder_bytes"]
            == sum(r.bytes_decoder for r in hist_l)
            and rec_l["decoder_rel_err"] < 0.01, f"run (l) reconcile {rec_l}")
    log(f"paper (l) §5.2 colour imbalance, CIFAR CNN, FC AE "
        f"{ae_cfg_l.input_dim} -> {ae_cfg_l.latent_dim} ({n_ae_l} params), "
        f"pre-pass of both collaborators {prepass_s!r} s, AE loss "
        f"{[(h[0], h[-1]) for h in pre_l[4]]!r}; AELifecycle({LIFECYCLE_L})")
    for p, rec in zip(plays_l, hist_l):
        log(f"paper (l) r{rec.round}: {p['s']!r} s (host clock), up "
            f"{rec.bytes_up!r} B (ratio {rec.compression_ratio!r}), "
            f"decoder ships {rec.ae_syncs} = {rec.bytes_decoder!r} B "
            f"({ship_l!r} B a ship), refits {p['refits']}, acc "
            f"{rec.global_metrics['accuracy']!r}, collaborator acc "
            f"{[m.get('accuracy') for m in rec.collab_metrics]!r}")
    log("paper (l) savings.reconcile " + json.dumps(rec_l))
    run_l2 = build_color_imbalance(pre_l, "cuda", 4)
    play(run_l2, 4, "cuda")
    check_resume("run (l) rerun", run_l, run_l2, 0)
    del run_l2
    res_l, plays_lr, nbytes_l, save_l, load_l = resume_via_checkpoint(
        "run_l", lambda n: build_color_imbalance(pre_l, "cuda", n), 2, 2,
        "cuda")
    check_resume("run (l) resume", run_l, res_l, 2)
    log(f"paper (l) saved after round 1 ({nbytes_l} B, {save_l!r} s), "
        f"loaded into a fresh run ({load_l!r} s), rounds 2-3 "
        f"({[p['s'] for p in plays_lr]!r} s): torch.equal / equal to the "
        "uninterrupted run (which a rerun reproduced bit for bit)")
    del res_l, run_l, pre_l, aes_l
    torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------ 10. k-means and entropy
    at("10. k-means and entropy")
    log("kmeans KMeansSpec(550586, k=16, iters=8) card vs cpu: "
        + json.dumps(check_kmeans()))

    # -------------------------------- 11. the rate-control frontier (m)
    at("11. the rate-control frontier (m)")
    run_rate_frontier()

    # -------------------- 12. a per-partition ladder on kernel 5 (n)
    at("12. a per-partition ladder on kernel 5 (n)")
    routes_n = run_rate_cnn(launches)

    # ------------------------------------------- 13. the serve loop (o)
    at("13. the serve loop (o)")
    for row in run_serve_loop(launches):
        log("serve (o) " + json.dumps(row))

    # ------------------------------------- 14. LMDeltaTask at width (q)
    at("14. LMDeltaTask at width (q)")
    lm_q = run_lm_delta(launches)
    log(f"lm delta (q) stablelm-1.6b x{LM_Q['n_layers']} layers "
        + json.dumps(lm_q))
    log("lm delta (q) reduced cuda == cpu (replay): "
        + json.dumps(lm_delta_replay()))

    # ---------------------------------------------- 15. MLA serving (r)
    at("15. MLA serving (r)")
    gc.collect()
    torch.cuda.empty_cache()
    lm_r = run_mla_serving(16)
    launches["flash_attention_run_r"] = lm_r["launches_prefill"][
        "flash_attention"]
    log("mla (r) " + json.dumps(lm_r))
    log(f"mla (r) minicpm3-4b x{lm_r['n_layers']} layers: prefill 4 x 1024 "
        f"tokens in {lm_r['prefill_s']:.4f} s, decode step median "
        f"{lm_r['decode_step_median_s']:.4f} s, peak "
        f"{lm_r['peak_memory_bytes'] / 2**30:.2f} GiB, cache "
        f"{lm_r['cache_bytes']} B (GQA of the same heads "
        f"{lm_r['cache_bytes_gqa_same_heads']} B); kernel 6 "
        f"{lm_r['routes_prefill']} in prefill, none in decode")
    log("mla (r) 2-layer cuda == cpu within atol=1e-4 rtol=1e-3 (float32 "
        "compute), bfloat16 prefill within 2 x the CPU's bfloat16 error: "
        + json.dumps(mla_card_vs_cpu()))

    # ---------------------------------------------- 16. MoE serving (s)
    at("16. MoE serving (s)")
    gc.collect()
    torch.cuda.empty_cache()
    for arch, n in (("dbrx-132b", 2), ("llama4-maverick-400b-a17b", 1)):
        row = run_moe_serving(arch, n)
        log(f"moe (s) {arch} x{n} " + json.dumps(row))
    for arch in ("dbrx_132b", "llama4_maverick_400b_a17b"):
        log(f"moe (s) {arch} reduced cuda == cpu in the golden band, "
            "dispatch masks equal: " + json.dumps(moe_card_vs_cpu(arch)))

    # ------------------------------ 17. MLA training with remat (t)
    at("17. MLA training with remat (t)")
    lm_t = run_mla_delta(launches)
    log("lm delta (t) minicpm3-4b x8 layers " + json.dumps(lm_t))

    # --------------------------------- 18. an MoE training step (u)
    at("18. an MoE training step (u)")
    lm_u = run_moe_train_step()
    log("moe train (u) dbrx-132b x1 layer " + json.dumps(lm_u))

    # --------------------- 19. SSM, hybrid, audio and VLM serving (v-y)
    at("19. SSM, hybrid, audio and VLM serving (v-y)")
    gc.collect()
    torch.cuda.empty_cache()
    lm_v = run_ssm_serving()
    launches["flash_attention_run_v"] = 0
    log("ssm (v) " + json.dumps(lm_v))
    fam_runs = family_runs(launches)
    for x, tag in (("w", "hybrid (w) recurrentgemma-9b"),
                   ("x", "audio (x) whisper-medium"),
                   ("y", "vlm (y) phi-3-vision-4.2b")):
        log(f"{tag} " + json.dumps(fam_runs[x]))
    for x, r in [("v", lm_v)] + list(fam_runs.items()):
        log(f"family ({x}) {r['arch']} x{r['n_layers']} layers, {r['batch']} "
            f"x {r['prompt']} tokens: prefill {r['prefill_s']:.4f} s, decode "
            f"step median {r['decode_step_median_s']:.4f} s, peak "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, cache "
            f"{r['cache_bytes']} B; kernel 6 {r['routes_prefill']} in "
            "prefill, none in decode")
    for arch, n_attn in (("mamba2_2_7b", 0), ("recurrentgemma_9b", 1),
                         ("whisper_medium", 6), ("phi3_vision_4_2b", 2)):
        log(f"family {arch} reduced cuda == cpu in the golden band: "
            + json.dumps(family_card_vs_cpu(arch, n_attn)))

    # ------------- 20. the pod-axis FL round and sharded paths (z)-(ab)
    at("20. the pod-axis FL round and the sharded server paths (z)-(ab)")
    import datetime
    import torch.distributed as dist
    store = ROOT / "build" / "chip_smoke" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{store}",
        rank=0, world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=300))
    try:
        gloo = dist.new_group(backend="gloo")
        fl_z = run_fl_round_z(launches)
        log("fl (z) " + json.dumps(fl_z))
        for r in fl_z["rounds"]:
            log(f"fl (z) round {r['round']}: loss {r['loss']!r}, "
                f"{r['host_s']!r} s (host clock), latents all-reduced "
                f"{r['latent_bytes']} B of {r['grad_bytes']} B of "
                f"gradients ({r['latent_bytes'] / r['grad_bytes']!r}; "
                f"compressed_fraction {fl_z['compressed_fraction']!r})")
        log(f"fl (z) peak {fl_z['peak_memory_bytes'] / 2**30:.2f} GiB; "
            f"traced round: {json.dumps(fl_z['traced'])}")
        log("fl (z) reduced cuda == cpu within atol=1e-4 rtol=1e-3: "
            + json.dumps(fl_card_vs_cpu(gloo)))
        ab1 = sharded_paths(None)
        for k in AB_KERNELS:
            launches[k + "_run_ab"] = ab1["launches"][k]
        log("sharded (ab) one-rank NCCL " + json.dumps(ab1))
    finally:
        dist.destroy_process_group()
    pods = run_pods()
    for r, res in enumerate(pods["ranks"]):
        log(f"sharded (ab) two-process gloo, rank {r} "
            + json.dumps(res["ab"]))
        log(f"pods (aa) rank {r} " + json.dumps(res["aa"]))
    aa0 = pods["ranks"][0]["aa"]
    log(f"pods (aa) two pods on one card over gloo, stablelm-1.6b x"
        f"{FL_AA['n_layers']} layers at full width, {FL_AA['rounds']} rounds "
        f"({pods['wall_s']!r} s with the processes' start): against one "
        f"process composing the same math, max abs err "
        f"{aa0['max_abs_err']!r} (golden band), bits equal "
        f"{aa0['bits_equal']}")

    # ------------------------------------- 21. the example entry points (ac)
    at("21. the example entry points (ac)")
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter() - t_start
    ac = run_examples()
    log("examples (ac) " + json.dumps({
        label: {k: r[k] for k in ("start_s", "host_s", "launches",
                                  "routes", "cpu_s", "held", "replay")
                if k in r}
        for label, r in ac["rows"].items()}))
    log(f"examples (ac): {len(AC_ORDER)} card calls in {ac['card_s']:.1f} "
        f"s; the last started at {t21 + ac['last_start_s']:.1f} s; the "
        f"phase took {ac['phase_s']:.1f} s")

    # --------------------------------------------------------- 22. report
    at("22. report")
    src = {"quantize_blocks_2d": ("src/repro_torch/csrc/quantize.cu",
                                  "src/repro/kernels/quantize.py:22"),
           "dequantize_blocks_2d": ("src/repro_torch/csrc/quantize.cu",
                                    "src/repro/kernels/quantize.py:31"),
           "fused_dense": ("src/repro_torch/csrc/fused_dense.cu",
                           "src/repro/kernels/fused_dense.py:39"),
           "fused_decode_agg": ("src/repro_torch/csrc/fused_decode_agg.cu",
                                "src/repro/kernels/fused_decode_agg.py:53"),
           "grouped_fused_decode_agg": (
               "src/repro_torch/csrc/grouped_decode_agg.cu",
               "src/repro/kernels/fused_decode_agg.py:120"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:29")}
    kernels = []
    for name, (source, replaces) in src.items():
        r = slice_rows[name]
        extra = {f"launches_run_{x}": launches[f"{name}_run_{x}"]
                 for x in "hijknopqrtvwxy" if f"{name}_run_{x}" in launches}
        if name == "flash_attention":
            extra.update(mla_run_r=mla[0], mla_run_t=mla[1], **fam, **args6)
        if f"{name}_run_ab" in launches:
            extra["launches_run_ab"] = launches[f"{name}_run_ab"]
        if name in ("quantize_blocks_2d", "dequantize_blocks_2d"):
            extra.update({f"launches_by_route_run_{x}":
                          launches[f"quant_routes_run_{x}"][name]
                          for x in "aoq"})
        if name == "fused_dense":
            extra.update(launches_by_route_run_c=routes_c,
                         launches_by_route_run_h=routes_h,
                         launches_by_route_run_k=routes_k,
                         launches_by_route_run_n=routes_n)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            **extra,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            host_ms=r["host_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"], shape=r["shape"],
                            **{k: r[k] for k in ("kernel_route", "plan",
                                                 "library_call",
                                                 "per_bucket_ms") if k in r}))
    for line in smi:
        log(line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ac-cpu"]:           # run (ac)'s CPU children
        sys.exit(ac_cpu_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
