"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each ending in one line:
  1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
  2. the build: ``nvcc`` compiles every kernel of the serve and
     calibration paths; ``cuobjdump`` gives
     chacha20's instruction mix and the bf16 ``flash_attention``'s
     tensor-core instructions (``HGMMA``), ``ptxas -v`` the registers,
     spills and static shared memory of each bf16 attention kernel, and
     the decode grid at the serving shape is printed with its launches a
     call;
  3. the kernels: each kernel against its plain PyTorch version on the card.
     The attention kernels in fp32 (tolerance 2e-5, TF32 off) and bf16
     (2e-2 prefill, 3e-2 decode), at the serving shapes of qwen1.5-0.5b,
     at a GQA shape of starcoder2-15b's widths and ``flash_attention`` at
     deepseek-v3's MLA prefill shape (B1 H128 S512, q/k head dim 192, v
     head dim 128, v a slice of the decompressed K/V), at phase 10's
     shapes (zamba2-2.7b's shared block, B1 H32 KVH32 D80: S512 causal
     prefill, decode over a 576-position cache; stablelm-12b, B1 H32 KVH8
     D160: S512, a 528-position cache; decode at the prompt's length, the
     first, 16th, middle and last steps'; the bf16 prefill and first
     decode step timed), at phase 11's whisper-large-v3 shapes (B1 H20
     KVH20 D64: cross-attention at Sq 64, Skv 1500 and the encoder at
     S1500, both not causal, and ``flash_decode`` over all 1500 frames,
     timed in fp32 and bf16; the decoder's causal prefill and its
     self-attention decode), at the published Zamba2-2.7B's shared block
     (B1 H32 KVH32 D160, scores scaled by (160 / 2)^-1/2 as given to both
     kernels: S512 causal prefill, decode over a 704-position cache),
     with one PyTorch
     library call's time (``scaled_dot_product_attention``, a yardstick
     the port never calls). ``chacha20`` bit-exact (0 mismatched words) on
     the RFC 7539 vector, across the 2^32 counter wrap at a block count
     that is no multiple of 256, at the calibration shapes (256 and 64
     blocks) and on 64 MiB of keystream (1,048,576 blocks), which is
     timed (no PyTorch call computes ChaCha20: no library time). Each
     timed case prints its time, the plain version's and the least time
     the card could take, all device-only (``device_ms``: 50 calls queued
     behind a spin kernel, so the host's per-call work is hidden); decode
     rotates over copies of its inputs that exceed the 50 MB L2, so every
     call finds its cache cold, and also prints the older flushed
     single-pair time. ``flash_decode`` is also checked, fp32 and bf16,
     at the cache phase 7's runs give it (batch 1, prompt + max_new =
     520 positions, whose last split chunk is ragged) at the first and
     last decode lengths. The attention kernels are also checked in fp32
     at every shape phase 6's calibration gives them (the kernel suite's
     and the reduced model differential's, from the constants of
     ``repro_torch.analysis.calibrate``). ``flash_decode`` is also held
     with its log-sum-exp output (the same launch) at every shape it is
     checked at: the output unchanged bit for bit, the lse within 1e-4 x
     (1 + |lse|) of the plain version's, and where timed, timed with and
     without it. (b) the sequence-parallel decode's kernel work in one
     process, at three caches in bf16 cut into the 16 sequence shards of
     the (16, 16) mesh's model axis: qwen1.5-0.5b's and
     whisper-large-v3's self-attention over decode_32k's cache (B 8,
     32,768 positions) and zamba2-2.7b's shared block over long_500k's
     (B 1, 524,288 positions, H 32, D 80: 5.4 GB of K and V);
     ``flash_decode`` with its lse on each shard at its local lengths and
     the partials merged in fp32 by ``models.attention.merge_partials``,
     against one whole-cache call and the plain version (3e-2; lse 1e-4 x
     (1 + |lse|); empty rows 0), with the launch counters reset just
     before the shard calls and read just after (16), each way timed.
     (c) ``mamba2_step``, the port's own kernel of a Mamba2 layer's decode
     step (no TPU kernel: the reference computes it as plain ops), against
     its plain version at the published Zamba2-2.7B's layer (80 heads of
     64, d_state 64, a 4-tap conv), B 1 and 4, fp32 and bf16 (the window
     bit for bit, the fp32 state within 1e-5, y within 2e-5 / 2e-2); 64
     steps in place against 64 plain ones; one call captured in a CUDA
     graph and replayed on new inputs against eager calls, bit for bit;
     its device time at B 1 in bf16 (rotated over copies beyond the L2)
     against its bytes bound and the plain version's; and the published
     block (``portbench/configs/zamba2-2.7b.json``, 54 layers, bf16) at
     full width: one eager decode step issues it 54 times, two launches a
     call;
  4. serving: qwen1.5-0.5b at its published width and depth through the
     engine (``repro_torch.launch.serve.main``), with the kernels'
     executions on the card counted in a CUDA-activity profile of the run
     (``executed_kernels``: a replayed CUDA graph's kernels count at each
     replay) and the launch counters, which count what the host issued,
     reset just before and printed beside them; then one prefill and
     a few decode steps of the served model under ``torch.profiler``, for
     the device's busy time, idle share and top kernels;
  5. the end-to-end check: at the published width in fp32, prefill and
     greedy decode through the kernels against the same model with the
     kernels' plain versions swapped in, on the card; and the served bf16
     ``unembed`` against fp32 sums, to show its logits stay fp32;
  6. calibration: ``repro_torch.analysis.calibrate.main`` on the card at
     the full published configs of all ten archs, with the launch
     counters reset just before and read just after: all three kernels
     must launch, each kernel and every arch's ``prefill`` must be tagged
     heavy as in the reference's ``derived.json`` (``decode_step``'s tags
     are printed beside the reference's), ``derived.json`` must be
     unchanged, and the committed ``derived_cuda.json`` must equal the
     run's kernel and workload entries (their differentials aside);
  7. cluster serving: qwen1.5-0.5b at its published width through
     ``repro_torch.launch.serve``'s cluster path, 2 shards sharing the
     card under ``cluster-adaptive`` and the seeded ``crash`` fault plan,
     24 requests 2.5 s of engine time apart, with the cluster oracle
     attached and the launch counters reset just before and read just
     after: 0 oracle violations, exact conservation (injected = completed
     + shed + expired), at least one fault and one shard recovery, both
     attention kernels launched on every shard's path, and for 4
     completed requests the greedy tokens of the executor that finished
     each equal a fresh single-request run of its recorded prompt; then
     8 requests of the ``multi_tenant`` workload in engine mode must all
     complete;
  8. the intermittency lint (``repro_torch.analysis.lint``) on the card,
     over all ten archs, counters reset just before: all three kernels must launch, and the
     ranked findings must equal the committed ``lint_baseline_cuda.json``
     (its three untagged ``decode_step`` findings included, which
     ``--check-baseline`` fails on by design);
  9. the moe family at full width, phases 4-8's models freed first:
     grok-1-314b (4 of 64 layers) and deepseek-v3-671b (2 of 61 layers)
     in bf16, one after the other, each served through
     ``repro_torch.launch.serve.run_engine`` (4 requests, 512-token
     prompts, 16 new tokens, batch 2) with its kernels' executions
     counted as in phase 4 (``flash_attention`` must launch for
     both, ``flash_decode`` for grok and never for deepseek, whose MLA
     decode is matrix products), its memory and a profiled prefill and
     decode steps printed; then each at 1 layer in fp32 through the
     end-to-end check of phase 5, with the routing choices the kernel and
     plain runs share;
 10. zamba2-2.7b (the hybrid: 54 Mamba2 layers, the shared attention
     block at head dim 80 nine times) and stablelm-12b (40 layers, head
     dim 160) whole at their published widths in bf16, one after the
     other, each served through ``repro_torch.launch.serve.run_engine``
     (4 requests, 512-token prompts, 64 and 16 new tokens, batch 2) with
     its kernels' executions counted as in phase 4 (both
     attention kernels must launch once a shared-block application or a
     layer, prefill and decode), TTFT/ITL, the weights' and the peak
     memory and a profiled prefill and decode steps printed; for the
     hybrid also the SSD chunk loop at a 512- and a 509-token prompt
     (chunk 128 and 1: iterations, kernels, time) and the share of a
     prefill and a decode step in the SSD core; then each in fp32 at 6
     and 2 layers through the end-to-end check of phase 5;
 11. rwkv6-3b and whisper-large-v3 whole at their published widths in
     bf16. rwkv6-3b (32 layers, attention-free: no kernel on its path)
     served through ``repro_torch.launch.serve.main`` in engine mode (4
     requests, 512-token prompts, 16 new tokens, batch 2), TTFT/ITL, the
     weights' and the peak memory, a profiled prefill and decode steps,
     and finite logits at every position of a 512-token prompt (its chunk
     of 128 run as blocks of 32); then in fp32 at 2 layers, the chunked
     prefill against the recurrence fed one token a call. whisper-large-v3
     (32 encoder and 32 decoder layers) through its Model API, which the
     serving executor cannot drive (it passes no frames): ``init_cache``
     over seeded frames [1, 1500, 1280] (the encoder) and ``prefill`` of
     a 64-token transcript, each timed, the self-KV filled step by step
     from length 0 and 16 greedy decode steps (ITL), the launch counters
     reset just before and read just after (both kernels must launch),
     a profiled prefill and decode steps; then at 2 + 2 layers in fp32,
     the kernels against their plain versions end to end and the last
     decode step against the teacher-forced decoder;
 12. training on the card. (a) qwen1.5-0.5b whole at its published size
     in bf16 (24 layers, 463.9M parameters) trained 20 steps through
     ``repro_torch.launch.train.main`` (B 8 x S 1024, ``--data-order 1``,
     ``--lr 1e-3``, remat full, CE in chunks of 512), the launch counters reset just
     before and read just after (``flash_attention`` twice a layer a
     step: forward and recompute; its backward is plain PyTorch): every
     loss finite and the mean of the last 5 below the first 5's, step ms
     (p50, last, sum), tokens/s and model FLOP/s (6 x params x tokens)
     over the p50 step, over all 20 steps and over steps 1-19, with their
     share of the bf16 peak, the weights', the optimizer state's and the
     peak memory; the same run in fp32 (``--dtype float32``), the bf16
     curve within 0.02 nats of it at every step and its fall within half
     of the fp32 fall; the step-10 checkpoint resumed to step 20, its
     losses within 1e-3 x max(1, |loss|) of the uninterrupted run's (the
     embedding's backward adds with atomics), its last step under
     ``torch.profiler`` (``--profile-step``: busy, idle share, kernels,
     the loop's forward / backward / optimizer ranges' shares, the
     attention backward's share, top items).
     (b) fp32 at the published width and 1 layer, B 2 x S 512: loss and
     every gradient through the kernel and its registered backward
     against autograd through the plain version (1e-4 x max(1, |loss|),
     1e-3 x each leaf's largest |grad|), and the backward alone at phase
     3's causal and Sq != Skv shapes. (c) one bf16 train step (loss,
     gradients, AdamW) of zamba2-2.7b (6 layers), rwkv6-3b (2),
     whisper-large-v3 (2 + 2) at published widths, grok-1-314b and
     deepseek-v3-671b at their reduced configs in bf16 (deepseek's with
     MLA's published head dims, which the kernel takes, and its MTP
     head): loss and every gradient finite, every leaf with a gradient
     (a MoE router or shared expert may have none, at most 2, as in the
     reference's test);
 13. distribution on the card through NCCL, on a world of one rank (NCCL
     refuses two ranks on one card; the tests hold the multi-rank
     semantics on gloo CPU meshes) and the mesh (1, 1) ("data",
     "model"). (a) qwen1.5-0.5b whole in bf16, phase 12's batches (B 8 x
     S 1024, ``--data-order 1``, lr 1e-3): 5 steps of the single-device
     ``make_train_step`` and of the same on a mesh under FSDP, under
     ZeRO-1 and under ``seq_parallel`` (each with the per-layer gathers;
     a model axis of 1 has no tensor-parallel plan, so every region is
     the identity), from one state, in alternating turns, the launch
     counters reset just before and read just after each sharded step;
     every sharded loss and, after the 5 steps, every parameter equal to
     the single device's (bit for bit, or within 1e-6 relative with the
     difference and the leaves that differ printed, and whether the
     single-device step run twice from one state differs from itself),
     each run's step p50
     and peak memory, and one more sharded step of each under
     ``torch.profiler``: the collective calls a step and the device time
     of what they launched (``collectives`` range). (b)
     ``compressed_allreduce`` over every fp32 gradient leaf of one step:
     its device time, its error against the exact mean at most the
     leaf's |v|max / 254, and the residual fed into a second call
     shrinking the two calls' error. (c) grok-1-314b's MoE FFN at full
     width (d 6144, 8 experts, top-2, expert d_ff 32768, bf16, 9.7 GB of
     experts) on a 512-token input: ``_moe_a2a_body`` and
     ``_moe_replicated_body`` (experts gathered over "data" as under FSDP)
     against ``moe_local`` at a capacity factor of 4 (no drops): outputs
     within 2e-2 of the output's scale, the same routing, each path's
     device time; then in fp32 at an expert d_ff of 4096, within 1e-5.
     (d) ``elastic_restore`` of phase 12's step-10 checkpoint onto the
     mesh: every leaf bit for bit. (e) whisper-large-v3 whole (32 + 32
     layers) in bf16, B 2 of 1,500 frames and 448 tokens: 5 steps each of
     the single-device step and the FSDP step (its per-layer gathers over
     both stacks) in alternating turns, losses and parameters bit for bit
     (or 1e-6 relative), ``flash_attention`` launched 192 times a step.
     The process group is destroyed at the end;
 14. the dry-run. (a) ``python -m repro_torch.launch.dryrun`` for the
     reference test's four family cells on the (2, 4) test mesh
     (qwen1.5-0.5b train_4k, rwkv6-3b decode_32k, zamba2-2.7b long_500k,
     whisper-large-v3 prefill_32k) and for qwen1.5-0.5b's train_4k,
     prefill_32k and decode_32k, deepseek-v3-671b's prefill_32k and
     zamba2-2.7b's and whisper-large-v3's decode_32k (their temporaries
     and wire a step each below their counts when the sequence-sharded
     cache was relaid every step) on the (16, 16) mesh, each as rank 0 of a
     fake world in a child process
     of its own, and ``python -m repro_torch.launch.perf --cell
     chameleon_decode`` and ``--cell qwen_train --variant seqpar``, all
     at once: a child's non-zero exit, or a result not ``ok``, fails the
     phase; each
     cell's roofline terms, bottleneck, mfu, per-rank arguments and
     temporaries, collectives and trace time printed. (b) qwen1.5-0.5b
     whole at world 1 on three paths, phase 12's train step (B 8 x S
     1024), phase 4's prefill (B 1 x 512) and one decode step over that
     cache: the dry-run's counter over a fake CUDA trace and over the
     card's run (``flash_attention`` launched in the train step and the
     prefill, ``flash_decode`` in the decode), flops and bytes equal
     within 1e-9 relative and the traced arguments within 1% of the bytes
     the card holds for them; printed beside them the traced temporaries
     against the card's peak above the arguments and the roofline's
     step against the measured p50;
then the ``kernels`` JSON line, the card line, and the result line.

Any failed phase exits non-zero. Nothing runs on the CPU in place of the
card: without CUDA the script fails.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "qwen1.5-0.5b"
SERVE = dict(requests=8, prompt=512, max_new=64, batch=4)
# phase 7: 24 arrivals 2.5 s of engine time apart (a 57.5 s window, in
# which the seeded crash plan fails and recovers shards), 2 shards
CLUSTER = dict(shards=2, cluster_policy="cluster-adaptive",
               fault_plan="crash", requests=24, rate=0.4, prompt=512,
               max_new=8, batch=4)
CLUSTER_TOKEN_CHECKS = 4
WORKLOAD = dict(workload="multi_tenant", requests=8, prompt=512, max_new=8,
                batch=4)
CALIB_OUT = ROOT / "build" / "repro_torch" / "derived_cuda.json"
# phase 9: the moe family at full width, depth cut to what one H100 holds
MOE_DEPTH = {"grok-1-314b": 4, "deepseek-v3-671b": 2}
MOE_SERVE = dict(requests=4, prompt=512, max_new=16, batch=2)
# phase 10: zamba2-2.7b whole (54 layers) and stablelm-12b whole (40
# layers) at their published widths in bf16; the depth of each one's fp32
# end-to-end check (the hybrid's: one group of six Mamba2 layers and the
# shared block)
WIDE_SERVE = {"zamba2-2.7b": dict(requests=4, prompt=512, max_new=64,
                                  batch=2),
              "stablelm-12b": dict(requests=4, prompt=512, max_new=16,
                                   batch=2)}
WIDE_E2E_DEPTH = {"zamba2-2.7b": 6, "stablelm-12b": 2}
# the prompts whose SSD chunk loop phase 10 counts: the served one (chunks
# of 128) and a prime one, which the chunk shrinks to divide (Q = 1)
SSD_PROMPTS = (512, 509)
# phase 11: rwkv6-3b whole (32 layers) served at its published width in
# bf16, and its fp32 check against the recurrence at 2 layers; whisper-
# large-v3 whole (32 + 32 layers) through its Model API: a 64-token
# transcript (calibration's audio traffic: transcripts uniform over
# 48-160 tokens) and 16 greedy steps, and its fp32 checks at 2 + 2 layers
RWKV_SERVE = dict(requests=4, prompt=512, max_new=16, batch=2)
RWKV_E2E_DEPTH = 2
WHISPER_RUN = dict(transcript=64, max_new=16)
WHISPER_E2E_DEPTH = 2
# phase 12: training. (a) qwen1.5-0.5b whole in bf16 through
# ``repro_torch.launch.train`` (remat full, CE chunks of 512), checkpointed
# at step 10 and resumed from it to step 20; (b) the kernel path against the
# plain path in fp32 at 1 layer; (c) one bf16 train step of each other
# family, depth cut (None: the reduced config, cast to bf16)
# (the learning rate: at the reference's default of 3e-3 the loss rises
# over 20 steps, in fp32 as in bf16, so the optimizer's rate and not the
# bf16 path makes it rise; PERF.md §6 PR 18 run 3)
TRAIN = dict(batch=8, seq=1024, steps=20, ckpt_every=10, data_order=1,
             lr=1e-3)
# the bf16 curve against the same run's in fp32 (same seed, same batches):
# no step's loss further apart than ``gap`` nats, and the falls over the
# first and last 5 steps apart at most ``fall`` of the fp32 fall (about
# twice and three times what run 3 of PERF.md §6 PR 18 measured, 0.0089
# and 0.17; a bf16 gradient that stopped the fall would part them by the
# whole fall)
TRAIN_FP32_TOL = dict(gap=0.02, fall=0.5)
TRAIN_CHECK = dict(batch=2, seq=512, layers=1)
TRAIN_FAMILIES = {"zamba2-2.7b": 6, "rwkv6-3b": 2, "whisper-large-v3": 2,
                  "grok-1-314b": None, "deepseek-v3-671b": None}
TRAIN_STEP_BATCH = dict(batch=2, seq=256, transcript=64)
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train"
# phase 13: distribution through NCCL on a world of one rank: the sharded
# train step's steps a run, grok-1-314b's full-width MoE FFN (capacity
# factor 4 = E / k: no token can drop; a 512-token input; fp32 at an
# expert d_ff of 4096), tolerances, and where the group meets and phase
# 12's step-10 checkpoint waits
DIST = dict(steps=5, moe_arch="grok-1-314b", moe_tokens=512, moe_cf=4.0,
            moe_fp32_ff=4096, moe_tol={"bfloat16": 2e-2, "float32": 1e-5},
            loss_rel=1e-6,
            # the sharded steps beside one device's: make_dist's knobs
            sharded={"fsdp": {}, "zero1": {"zero1": True},
                     "seqpar": {"seq_parallel": True}})
# phase 13 (e): whisper-large-v3 whole (32 + 32 layers) in bf16, one
# device's step and the FSDP step at world 1, on B 2 of 1,500 frames and
# 448 tokens (the published decoder length)
DIST_WHISPER = dict(arch="whisper-large-v3", batch=2, tokens=448, steps=5)
DIST_DIR = ROOT / "build" / "chip_smoke_dist"
# phase 14: the dry-run. (a) its cells, each traced by
# ``python -m repro_torch.launch.dryrun`` in a child process of its own (all
# at once: tracing runs on the CPU), and ``launch.perf``'s chameleon_decode:
# the reference test's four family cells on the (2, 4) test mesh (8 fake
# ranks) and qwen1.5-0.5b's train, prefill and decode on the (16, 16) mesh
# (256 fake ranks). deepseek-v3-671b's train_4k traces 5 microbatches of 61
# layers, about 430 s on a CPU (PERF.md section 6): its prefill_32k
# stands in, the same arch with the MoE's all-to-all dispatch at 256 ranks.
# (b) the counter over a fake trace and over the card's run of qwen1.5-0.5b
# whole at world 1: phase 12's train step, phase 4's prefill and one decode
# step over that cache, (batch, sequence) each
DRYRUN_CELLS = [("test", "qwen1.5-0.5b", "train_4k"),
                ("test", "rwkv6-3b", "decode_32k"),
                ("test", "zamba2-2.7b", "long_500k"),
                ("test", "whisper-large-v3", "prefill_32k"),
                ("single", "qwen1.5-0.5b", "train_4k"),
                ("single", "qwen1.5-0.5b", "prefill_32k"),
                ("single", "qwen1.5-0.5b", "decode_32k"),
                ("single", "deepseek-v3-671b", "prefill_32k"),
                ("single", "zamba2-2.7b", "decode_32k"),
                ("single", "whisper-large-v3", "decode_32k")]
# the decode cells whose sequence-sharded caches were relaid on every step
# before the sequence-parallel decode: their temporaries and wire a step
# then, in bytes a rank (the dry-run's counts on (16, 16), PERF.md section
# 6), which each must now stay below
DRYRUN_BELOW = {"zamba2-2.7b|decode_32k|single": (41.1e9, 27.2e9),
                "whisper-large-v3|decode_32k|single": (67.5e9, 43.3e9)}
# launch.perf's jobs: (cell, variant, or None for all of the cell's)
DRYRUN_PERF = [("chameleon_decode", None), ("qwen_train", "seqpar")]
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT = 600
ESTIMATE = {"train": (TRAIN["batch"], TRAIN["seq"]),
            "prefill": (1, SERVE["prompt"]), "decode": (1, SERVE["prompt"])}
ESTIMATE_TOL = dict(counts=1e-9, arguments=0.01)
ESTIMATE_REPS = {"train": 5, "prefill": 10, "decode": 20}
# decode timings rotate over copies of their inputs that together exceed
# the H100's 50 MB L2 cache
ROTATE_BYTES = 75e6
TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash_decode": {"float32": 2e-5, "bfloat16": 3e-2}}
# flash_decode's log-sum-exp against its plain version's, fp32 both (the
# kernel sums in base 2 from prescaled scores): x (1 + |lse|)
LSE_TOL = 1e-4
# the published Zamba2-2.7B's shared block (portbench/configs/zamba2-2.7b.
# json): heads of 160 over [x; embedding], scores scaled by (160 / 2)^-1/2,
# a 512-token prompt and up to 192 new tokens
ZAMBA2_PUBLISHED = dict(H=32, D=160, prompt=512, cache=704,
                        scale=(160 / 2) ** -0.5)
# phase 3 (b): the sequence-parallel decode's caches cut into the 16
# sequence shards of the (16, 16) mesh's model axis, in one process:
# qwen1.5-0.5b's and whisper-large-v3's self-attention over decode_32k's
# cache (32,768 positions, the 8 rows a data rank holds of its 128; row
# lengths: empty, one position, a shard's edge and past it, midway, and
# the whole cache), and zamba2-2.7b's shared block over long_500k's (one
# row of 524,288 positions, 5.4 GB of bf16 K and V; its last shard one
# position short)
_LENGTHS_32K = (0, 1, 2048, 2049, 10000, 20480, 32767, 32768)
SEQ_DECODE = [
    dict(arch="qwen1.5-0.5b", cell="decode_32k", batch=8, seq=32768,
         shards=16, lengths=_LENGTHS_32K),
    dict(arch="zamba2-2.7b", cell="long_500k", batch=1, seq=524288,
         shards=16, lengths=(524287,)),
    dict(arch="whisper-large-v3", cell="decode_32k", batch=8, seq=32768,
         shards=16, lengths=_LENGTHS_32K)]
KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93"},
    "flash_decode": {
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:75"},
    "chacha20": {
        "source": "src/repro_torch/csrc/chacha20.cu",
        "replaces": "src/repro/kernels/chacha20.py:89"},
}
# the port's own kernels, with no TPU kernel behind them: built in phase 2,
# checked in phase 3 (c)
OWN_KERNELS = {"mamba2_step": "src/repro_torch/csrc/mamba2_step.cu"}
# the device functions each kernel runs, as a device trace names them
KERNEL_FUNCTIONS = {
    "flash_attention": ("flash_attention_kernel", "flash_attention_tc_kernel"),
    "flash_decode": ("flash_decode_kernel",),
    "chacha20": ("chacha20_kernel",),
    "mamba2_step": ("mamba2_step_kernel", "mamba2_norm_kernel")}
# phase 3 (c): the published Zamba2-2.7B's Mamba2 layer, and the kernel's
# tolerances against its plain version (y; the fp32 state within 1e-5)
MAMBA2_PUBLISHED = dict(nh=80, hd=64, N=64, G=1, K=4)
MAMBA2_EPS = 1e-5
MAMBA2_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "state": 1e-5}
# ChaCha20 keystream block 1 of RFC 7539 section 2.3.2 (key 00..1f,
# nonce 000000090000004a00000000, counter 1), little-endian bytes
RFC_BLOCK1 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
# 32-bit instructions the card issues for one ChaCha20 block: 10 double
# rounds x 8 quarter rounds x (4 adds, 4 xors, 4 rotates as one SHF or
# PRMT each) + 16 final adds (csrc/chacha20.cu)
CHACHA20_INSTR_PER_BLOCK = 10 * 8 * 12 + 16


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def machine():
    """The H100's data-sheet rates, kept in one place: the port's
    ``MachineModel`` (``repro_torch.analysis.regions``)."""
    from repro_torch.analysis.regions import MachineModel
    return MachineModel()


# ----------------------------------------------------------------- timing


def flushed_ms(fn, iters: int = 50, warmup: int = 5, flush=None) -> float:
    """Time of one call from CUDA events: the median of ``iters``
    single-call event pairs, with ``flush`` (a large tensor) rewritten
    before each pair outside it so that the call finds the L2 cache cold.
    A single pair also holds whatever of the host's per-call work the
    rewrite does not cover; kept for continuity with PERF.md's history."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fns, iters: int = 50, reps: int = 5) -> dict:
    """Device time of one call, with the host left out: ``iters`` calls,
    rotating over ``fns`` (each a call on its own copy of the inputs, so
    that enough copies find the L2 cache cold), queued between one
    CUDA-event pair behind a spin kernel (``torch.cuda._sleep``) that
    lasts longer than the host takes to queue them. The device then runs
    the calls back to back whatever the host's per-call work (argument
    checks, custom-op dispatch, ``ctypes``). Returns the median over
    ``reps`` pairs of the pair's time over ``iters``, and ``hidden``:
    whether in every pair the host queued the last call before the device
    could have run out of work (the host's queueing time below the spin's
    plus the calls'). A host that blocks on a full launch queue (a plain
    version's many small kernels) waits for the device and hides too."""
    import torch
    fns = list(fns)
    for fn in fns:                      # warm every copy once
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2 GHz is above the SM clock, so the spin lasts at least this long
    cycles = int(2.0e9 * (2 * host_s + 2e-4))
    runs = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        runs.append((ev, host_ms))
    torch.cuda.synchronize()
    spins = [ev[0].elapsed_time(ev[1]) for ev, _ in runs]
    calls = [ev[1].elapsed_time(ev[2]) for ev, _ in runs]
    return {"ms": statistics.median(calls) / iters,
            "hidden": all(h < sp + c for (_, h), sp, c
                          in zip(runs, spins, calls))}


# ----------------------------------------------------------------- phases


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def prefill_case(B, H, KVH, S, D, dtype, causal, gen, contiguous=False,
                 Dv=None, Skv=None):
    """q/k/v as transpose views of [B,S,*,D] tensors, as the model passes
    them, or ``contiguous`` [B,*,S,D] tensors, as calibration passes
    them; k and v of ``Skv`` positions where given (cross-attention, not
    causal), else S. With a value head dim ``Dv`` of its own (MLA), v is
    the slice of a [B,S,KVH,D'+Dv] tensor that MLA's decompression gives
    (D' = 128, MLA's nope dim). Returns (args, kwargs, bytes, flops)."""
    import torch
    Skv = Skv or S

    def make(heads, d=D, length=S):
        t = torch.randn(B, length, heads, d, generator=gen, device="cuda")
        t = t.to(dtype).transpose(1, 2)
        return t.contiguous() if contiguous else t

    q, k = make(H), make(KVH, length=Skv)
    v = make(KVH, length=Skv) if Dv is None \
        else make(KVH, 128 + Dv, Skv)[..., 128:]
    Dv = Dv or D
    item = q.element_size()
    nbytes = item * (B * H * S * (D + Dv) + B * KVH * Skv * (D + Dv))
    pairs = S * (S + 1) // 2 if causal else S * Skv
    flops = 2 * B * H * (D + Dv) * pairs
    return (q, k, v), {"causal": causal}, nbytes, flops


def decode_case(B, H, KVH, S, D, dtype, lengths, gen, contiguous=False):
    """q [B,H,D] and the cache [B,S,KVH,D] as a permute view, as the
    model's cache gives it, or ``contiguous`` [B,KVH,S,D], as calibration
    passes it; with ragged lengths. Returns (args, kwargs, bytes, flops)."""
    import torch

    def make():
        t = torch.randn(B, S, KVH, D, generator=gen, device="cuda")
        t = t.to(dtype).permute(0, 2, 1, 3)
        return t.contiguous() if contiguous else t

    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc, vc = make(), make()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    item = q.element_size()
    n = sum(min(x, S) for x in lengths)
    nbytes = item * (2 * B * H * D + 2 * n * KVH * D) + 4 * B
    flops = 4 * H * D * n
    return (q, kc, vc, lens), {}, nbytes, flops


def library_call(name, args, kwargs):
    """One PyTorch call computing the same function (timed only)."""
    import torch
    import torch.nn.functional as F
    if name == "flash_attention":
        q, k, v = args
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs["causal"], enable_gqa=True)
    q, k, v, lens = args
    mask = (torch.arange(k.shape[2], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True)


def check_kernel(name, case, label, dtype_name, timed):
    """Kernel against its plain version on the same inputs; optionally
    timed. Returns a result dict."""
    import torch
    from repro_torch.kernels import decode_attention, flash_attention, ref
    kern = {"flash_attention": flash_attention.flash_attention,
            "flash_decode": decode_attention.flash_decode}[name]
    plain = {"flash_attention": ref.attention_ref,
             "flash_decode": ref.decode_attention_ref}[name]
    args, kwargs, nbytes, flops = case
    got = kern(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {label}: {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name} {label}: non-finite")
    tol = TOL[name][dtype_name]
    err = (g - w).abs().max().item()
    ok = bool(((g - w).abs() <= tol + tol * w.abs()).all())
    res = {"shape": label, "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": ok}
    if name == "flash_decode":
        # the same launch with its log-sum-exp: the output unchanged, the
        # lse against the plain version's
        o, lse = kern(*args, with_lse=True, **kwargs)
        _, want_lse = ref.decode_attention_lse_ref(*args, **kwargs)
        torch.cuda.synchronize()
        fin = torch.isfinite(want_lse)
        lse_err = (lse - want_lse)[fin].abs().max().item() if fin.any() \
            else 0.0
        res["lse_max_abs_err"] = lse_err
        res["ok"] = ok = ok and torch.equal(o, got) and torch.equal(
            torch.isfinite(lse), fin) and bool(((lse - want_lse)[fin].abs()
                                                <= LSE_TOL * (1 + want_lse[
                                                    fin].abs())).all())
    if timed:
        copies = [args]
        if name == "flash_decode":
            # a decode call reads a cache that the previous layer's call did
            # not leave in L2: rotate over copies that together exceed it
            per = sum(t.numel() * t.element_size() for t in args)
            copies += [tuple(t.clone() for t in args)
                       for _ in range(math.ceil(ROTATE_BYTES / per) - 1)]
        res["host_hidden"] = {}
        timings = [("ms", lambda a: lambda: kern(*a, **kwargs)),
                   ("plain_ms", lambda a: lambda: plain(*a, **kwargs)),
                   ("library_ms", lambda a: library_call(name, a, kwargs))]
        if name == "flash_decode":
            timings.append(("lse_ms", lambda a: lambda: kern(
                *a, with_lse=True, **kwargs)))
        for key, make in timings:
            t = device_ms([make(a) for a in copies])
            res[key] = t["ms"]
            res["host_hidden"][key] = t["hidden"]
        res["copies"] = len(copies)
        if name == "flash_decode":
            flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
            res["flushed_ms"] = flushed_ms(lambda: kern(*args, **kwargs),
                                           flush=flush)
        m = machine()
        peak = {"bfloat16": m.tensor_flops_per_s,
                "float32": m.vector_flops_per_s}[dtype_name]
        by_bytes = nbytes / m.hbm_bytes_per_s * 1e3
        by_ops = flops / peak * 1e3
        res["bound_ms"] = max(by_bytes, by_ops)
        res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    say(f"  {name} {label} {dtype_name}: max_abs_err={err:.3g} (tol {tol})"
        + (f", lse max_abs_err={res['lse_max_abs_err']:.3g} (tol {LSE_TOL}"
           f" x (1 + |lse|))" if "lse_max_abs_err" in res else "")
        + (f" ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
           + (f"with lse ms={res['lse_ms']:.4f} " if "lse_ms" in res
              else "")
           + f"library_ms={res['library_ms']:.4f} bound_ms="
           f"{res['bound_ms']:.4f} ({res['bound_by']}); device-only over "
           f"{res['copies']} input copies, host hidden (kernel/plain/"
           f"library): {'/'.join(str(v) for v in res['host_hidden'].values())}"
           + (f"; flushed single-pair ms={res['flushed_ms']:.4f}"
              if "flushed_ms" in res else "") if timed else "")
        + ("" if ok else "  MISMATCH"))
    return res


def seq_decode_check():
    """Phase 3 (b): the sequence-parallel decode's kernel work in one
    process (NCCL refuses two ranks on one card), at each of
    ``SEQ_DECODE``'s caches at its arch's full width in bf16, cut into 16
    sequence shards as the (16, 16) mesh's model axis rests it:
    ``flash_decode`` with its log-sum-exp on each shard at its local
    lengths (clamp(L - r S_r, 0, S_r)), the partials merged in fp32 by
    ``models.attention.merge_partials``, against one whole-cache call
    and the plain version (each output within the bf16 tolerance of its
    row's largest |value|, the lse within ``LSE_TOL``); an empty row (and
    every row at length 0) merged to 0; the limit shown to reject a merge
    with shard 1 dropped and an output of zeros; each timed device-only.
    Returns each cache's shard launches, counted from 0 just before its
    shard calls."""
    out = {}
    for case in SEQ_DECODE:
        out[f"{case['arch']} {case['cell']}"] = seq_decode_case(case)
        free_cuda()
    return out


def seq_decode_case(case: dict) -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import merge_partials
    cfg = get_arch(case["arch"])
    B, S, R = case["batch"], case["seq"], case["shards"]
    H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(1)
    (q, kc, vc, lens), _, nbytes, _ = decode_case(
        B, H, KVH, S, D, torch.bfloat16, list(case["lengths"]), gen)
    Sr = S // R
    label = (f"{case['arch']} {case['cell']} B{B} H{H} KVH{KVH} S{S} D{D} "
             f"bf16, {R} shards of {Sr}")

    def sharded(lengths=lens, drop=None):
        parts = [ops.flash_decode_lse(
            q, kc[:, :, r * Sr:(r + 1) * Sr], vc[:, :, r * Sr:(r + 1) * Sr],
            (lengths - r * Sr).clamp(0, Sr)) for r in range(R) if r != drop]
        return merge_partials(torch.stack([o for o, _ in parts]),
                              torch.stack([lse for _, lse in parts]))

    def whole():
        return ops.flash_decode_lse(q, kc, vc, lens)
    ops.reset_launch_counts()
    o, lse = sharded()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    require(launches["flash_decode"] == R, f"seq decode {label}: {launches}")
    want_o, want_lse = whole()
    plain_o, _ = ref.decode_attention_lse_ref(q, kc, vc, lens)
    torch.cuda.synchronize()
    tol = TOL["flash_decode"]["bfloat16"]
    got = o.to(q.dtype).float()         # as the decode hands it on
    fin = torch.isfinite(want_lse)

    def excess(x, w):
        """The largest |x - w| over tol x the largest |w| of its row (a
        (b, head) pair): above 1 fails. Outputs over a long cache are
        small (about sqrt(e / length) for random q, k and v), so a limit
        of tol in absolute terms would pass zeros."""
        lim = (tol * w.abs().amax(-1, keepdim=True)).clamp_min(1e-30)
        return ((x - w).abs() / lim).max().item()
    errs = {}
    for what, w in (("whole-cache kernel", want_o), ("plain", plain_o)):
        w = w.float()
        errs[what] = ((got - w).abs().max().item(), excess(got, w))
        require(errs[what][1] <= 1,
                f"seq decode {label}: the merged shards against the {what} "
                f"call, max abs {errs[what][0]:.3g}, {errs[what][1]:.3g} of "
                f"the limit (tol {tol} x the row's max |value|)")
    # the limit catches a fault in a shard's output or in the weighting
    w = want_o.float()
    faults = {"shard 1 dropped": excess(
        sharded(drop=1)[0].to(q.dtype).float(), w),
        "zeros": excess(torch.zeros_like(w), w)}
    require(all(v > 1 for v in faults.values()),
            f"seq decode {label}: the limit passes a faulty merge: {faults}")
    lse_err = (lse - want_lse)[fin].abs().max().item()
    require(torch.equal(torch.isfinite(lse), fin) and bool(
        ((lse - want_lse)[fin].abs() <= LSE_TOL * (1 + want_lse[fin].abs()))
        .all()), f"seq decode {label}: merged lse against the whole call's, "
        f"max abs {lse_err:.3g}")
    empty, _ = sharded(torch.zeros_like(lens))
    require(not bool(torch.isnan(o).any()) and bool((empty == 0).all())
            and all(bool((o[b] == 0).all())
                    for b, n in enumerate(case["lengths"]) if n == 0),
            f"seq decode {label}: an empty row is not 0")
    t_shards = device_ms([sharded], iters=20)
    t_whole = device_ms([whole], iters=20)
    m = machine()
    kern_err, plain_err = errs["whole-cache kernel"], errs["plain"]
    rejected = ", ".join(f"{k} {v:.3g}" for k, v in faults.items())
    say(f"  seq-parallel decode, {label}, lengths {list(case['lengths'])}: "
        f"merged against the whole-cache kernel max abs {kern_err[0]:.3g} "
        f"({kern_err[1]:.3g} of the limit), against the plain version "
        f"{plain_err[0]:.3g} ({plain_err[1]:.3g}) (limit {tol} x the row's "
        f"max |value|); faults rejected at {rejected} of the limit; lse max "
        f"abs {lse_err:.3g} (tol "
        f"{LSE_TOL} x (1 + |lse|)); empty rows 0; launches {launches}; "
        f"device ms ({card_line()}): {R} shard calls and the merge "
        f"{t_shards['ms']:.4f}, one whole-cache call {t_whole['ms']:.4f}, "
        f"bound {nbytes / m.hbm_bytes_per_s * 1e3:.4f} (bytes); host hidden "
        f"{t_shards['hidden']}/{t_whole['hidden']}")
    return launches


def u32_words(n, gen):
    """n random u32 words on the card, made through their int32 bits."""
    import torch
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                         generator=gen, device="cuda").view(torch.uint32)


def check_chacha20(label, key, nonce, counter0, n_blocks, timed=False):
    """The kernel against its plain version, bit-exact; optionally timed
    (the plain version over fewer launches: it runs about 2,500 int64
    kernels a call)."""
    import torch
    from repro_torch.kernels import chacha20, ref
    got = chacha20.keystream(key, nonce, counter0, n_blocks)
    want = ref.chacha20_keystream_ref(key, nonce, counter0, n_blocks)
    torch.cuda.synchronize()
    require(got.shape == want.shape == (n_blocks, 16)
            and got.dtype == want.dtype == torch.uint32,
            f"chacha20 {label}: {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = int((ref.u32_to_i64(got) - ref.u32_to_i64(want)).abs().max())
    res = {"shape": label, "dtype": "uint32", "max_abs_err": err,
           "mismatched_words": bad, "tol": 0, "ok": bad == 0}
    if timed:
        m = machine()
        res["ms"] = device_ms(
            [lambda: chacha20.keystream(key, nonce, counter0, n_blocks)])["ms"]
        res["plain_ms"] = device_ms(
            [lambda: ref.chacha20_keystream_ref(key, nonce, counter0,
                                                n_blocks)], iters=5,
            reps=3)["ms"]
        res["library_ms"] = None
        nbytes = 4 * (8 + 3) + 64 * n_blocks
        by_bytes = nbytes / m.hbm_bytes_per_s * 1e3
        by_ops = CHACHA20_INSTR_PER_BLOCK * n_blocks / m.lane_ops_per_s * 1e3
        res["bound_ms"] = max(by_bytes, by_ops)
        res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    say(f"  chacha20 {label}: {bad} mismatched words, max_abs_err={err}"
        + (f" ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
           f"library_ms=none bound_ms={res['bound_ms']:.4f} "
           f"({res['bound_by']}: {CHACHA20_INSTR_PER_BLOCK} 32-bit "
           f"instructions a block at {m.lane_ops_per_s:.4g}/s, "
           f"{nbytes} bytes at {m.hbm_bytes_per_s:.4g} B/s)"
           if timed else "")
        + ("" if res["ok"] else "  MISMATCH"))
    return res


def chacha20_checks():
    import torch
    from repro_torch.kernels import chacha20
    gen = torch.Generator(device="cuda").manual_seed(5)
    rfc_key = torch.frombuffer(bytearray(range(32)), dtype=torch.int32)
    rfc_nonce = torch.frombuffer(
        bytearray.fromhex("000000090000004a00000000"), dtype=torch.int32)
    rfc_key, rfc_nonce = (t.to("cuda").view(torch.uint32)
                          for t in (rfc_key, rfc_nonce))
    rfc = check_chacha20("RFC 7539 2.3.2, counter 1, 4 blocks", rfc_key,
                         rfc_nonce, 1, 4)
    block1 = chacha20.keystream(rfc_key, rfc_nonce, 1, 1).view(torch.int32)
    same = block1.cpu().numpy().astype("<i4").tobytes() == RFC_BLOCK1
    rfc["ok"] = rfc["ok"] and same
    say(f"  chacha20 RFC block 1 equals the RFC's bytes: {same}")
    key, nonce = u32_words(8, gen), u32_words(3, gen)
    return [rfc] + [
        check_chacha20(label, key, nonce, ctr, n, timed)
        for label, ctr, n, timed in (
            ("counter 2^32-3, 1000 blocks (wrap, tail)", 2**32 - 3, 1000,
             False),
            ("calibration 256 blocks", 1, 256, False),
            ("calibration 64 blocks", 1, 64, False),
            ("64 MiB, 1048576 blocks", 7, 1 << 20, True))]


def demangle(names):
    """C++ names of mangled kernel symbols (``c++filt``), or the symbols."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return [o.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for o in out] \
        if len(out) == len(names) else list(names)


def sass_ops(name: str) -> dict:
    """SASS opcode counts of each kernel in the built library ``name``,
    from ``cuobjdump``, keyed by the kernel's C++ name."""
    import collections
    import re

    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(build._so_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)[1:]
    funcs = {}
    for fn, body in zip(demangle(parts[0::2]), parts[1::2]):
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                body))
        ops.pop("NOP", None)
        funcs[fn] = ops
    return funcs


def chacha20_sass() -> str:
    """Instruction mix of the built chacha20 kernel, beside the count its
    bound assumes. The kernel has no loop left after unrolling, so each
    instruction runs once a block."""
    import collections
    funcs = sass_ops("chacha20")
    if not funcs:
        return "not measured (no cuobjdump)"
    ops = sum(funcs.values(), collections.Counter())
    top = ", ".join(f"{k} {v}" for k, v in ops.most_common(8))
    return (f"{sum(ops.values())} instructions ({top}); the bound counts "
            f"{CHACHA20_INSTR_PER_BLOCK}")


def ptxas_usage(name: str) -> dict:
    """Registers, spills and static shared memory of each kernel of the
    library ``name``, from ``ptxas -v`` as this process's build printed
    it, keyed by the kernel's C++ name."""
    import re

    from repro_torch.kernels import build
    usage, fn = {}, None
    for line in build.LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[fn]["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            usage[fn]["smem"] = int(s.group(1)) if s else 0
    return dict(zip(demangle(list(usage)), usage.values()))


def is_bf16(fn: str) -> bool:
    """Whether a kernel's C++ name is a bf16 instantiation (the tensor-core
    attention kernel takes bf16 only and has no type parameter)."""
    return "bfloat16" in fn or "_tc_kernel" in fn


def kernel_build_report() -> None:
    """Phase 2's lines for the attention kernels: each bf16 instantiation's
    registers, spills and static shared memory (``ptxas -v``), the
    tensor-core instructions
    of the bf16 ``flash_attention`` (``HGMMA`` for ``wgmma``, ``HMMA`` for
    ``mma.sync``), and the decode grid at the serve shape."""
    import collections

    from repro_torch.kernels import build, decode_attention, flash_attention
    for name in ("flash_attention", "flash_decode"):
        use = {fn: u for fn, u in ptxas_usage(name).items() if is_bf16(fn)}
        warn = sorted({line.split(":", 1)[-1].strip()[:160] for line in
                       build.LOGS.get(name, "").splitlines()
                       if "Performance" in line or "arning" in line})
        if warn:
            say(f"  {name} ptxas warnings: " + " | ".join(warn))
        say(f"  {name} ptxas (bf16): " + ("; ".join(
            f"{fn} {u.get('registers')} regs, {u.get('spills')} B spilled, "
            f"{u.get('smem')} B static smem" for fn, u in sorted(use.items()))
            or "not measured (the library was not built by this process)"))
    say("  flash_attention dynamic shared memory a block, (Dqk, Dv) "
        f"{list(build.ATTENTION_DIMS)}: "
        + "; ".join(f"{dt}{gl} {[flash_attention.smem_bytes(dt, d, dv, g) for d, dv in build.ATTENTION_DIMS]}"
                    for dt, g, gl in (("float32", 1, ""),
                                      ("bfloat16", 1, " G odd"),
                                      ("bfloat16", 2, " G even"))))
    funcs = sass_ops("flash_attention")
    tc = {fn: {op: n for op, n in ops.items() if op in ("HGMMA", "HMMA")}
          for fn, ops in funcs.items()
          if is_bf16(fn) and "flash_attention" in fn}
    tc_total = sum((collections.Counter(v) for v in tc.values()),
                   collections.Counter())
    say(f"  flash_attention bf16 tensor-core SASS: {dict(tc_total) or 0} "
        f"over {len(tc)} instantiations" if funcs else
        "  flash_attention SASS: not measured (no cuobjdump)")
    grid = (decode_attention.plan_splits(1, 16, 576, 132)[0], 16, 1)
    say(f"  flash_decode grid at the serve shape (B1 KVH16 S576): {grid}, "
        f"{math.prod(grid)} blocks; {decode_attention.LAUNCHES_PER_CALL} "
        "CUDA launch a call")
    return tc_total


def calibration_shape_checks(gen):
    """The attention kernels at the shapes, layouts and dtypes that phase
    6's calibration gives them (constants of
    ``repro_torch.analysis.calibrate``), on random data: the kernel
    suite's timelines and differential, contiguous fp32, and the reduced
    configs' prefills of the model differential, as the model passes
    them."""
    import torch
    from repro_torch.analysis import calibrate as cal
    from repro_torch.configs import get_arch
    checks = {"flash_attention": [], "flash_decode": []}
    for what, (B, H, S, D) in (("timeline", cal.TIMELINE_ATTENTION_SHAPE),
                               ("differential", cal.DIFF_ATTENTION_SHAPE)):
        checks["flash_attention"].append(check_kernel(
            "flash_attention", prefill_case(B, H, H, S, D, torch.float32,
                                            True, gen, contiguous=True),
            f"calibration {what} B{B} H{H} S{S} D{D} causal", "float32",
            False))
    B, H, S, D = cal.TIMELINE_DECODE_SHAPE
    checks["flash_decode"].append(check_kernel(
        "flash_decode", decode_case(B, H, H, S, D, torch.float32, [S] * B,
                                    gen, contiguous=True),
        f"calibration timeline B{B} H{H} S{S} D{D} len{S}", "float32",
        False))
    for arch in cal.DIFFERENTIAL_ARCHS:
        cfg = get_arch(arch).reduced()
        if cfg.attention == "none":     # rwkv6-3b: no kernel on its path
            continue
        H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
        dname = cfg.compute_dtype
        checks["flash_attention"].append(check_kernel(
            "flash_attention", prefill_case(
                1, H, KVH, cal.DIFF_PROMPT, D, getattr(torch, dname), True,
                gen), f"calibration {arch} reduced prefill B1 H{H} KVH{KVH} "
            f"S{cal.DIFF_PROMPT} D{D} causal", dname, False))
    return checks


def cluster_decode_checks(dname, dtype, gen):
    """``flash_decode`` at the cache that phase 7's cluster and workload
    runs give it: batch 1, ``prompt + max_new`` positions, which the
    split planner cuts into chunks with a ragged last one. Lengths: the
    prompt (a whole number of chunks), the first decode step's and the
    last's."""
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    checks = []
    for P, N in sorted({(run["prompt"], run["max_new"])
                        for run in (CLUSTER, WORKLOAD)}):
        S = P + N
        for length in (P, P + 1, S - 1):
            checks.append(check_kernel(
                "flash_decode",
                decode_case(1, H, KVH, S, D, dtype, [length], gen),
                f"cluster B1 H{H} KVH{KVH} S{S} D{D} len{length}", dname,
                False))
    return checks


def serve_shape_checks(runs, dname, dtype, gen, timed=False):
    """The attention kernels at the shapes that the archs of ``runs`` (arch
    -> serve settings) give them when served, heads from the published
    configs: the causal prefill of one prompt, and for GQA decode over the
    executor's batch-1 cache of ``prompt + max_new`` positions, which the
    split planner cuts into chunks with a ragged last one. Lengths: the
    prompt, the first decode step's, the 16th's, one midway and the
    last's. With ``timed``, the prefill and the first decode step are
    timed."""
    from repro_torch.configs import get_arch
    checks = {"flash_attention": [], "flash_decode": []}
    for arch, run in runs.items():
        cfg = get_arch(arch)
        P, N = run["prompt"], run["max_new"]
        S = P + N
        if cfg.attention == "mla":
            H, m = cfg.n_heads, cfg.mla
            D, Dv = m.nope_head_dim + m.rope_head_dim, m.v_head_dim
            checks["flash_attention"].append(check_kernel(
                "flash_attention",
                prefill_case(1, H, H, P, D, dtype, True, gen, Dv=Dv),
                f"{arch} B1 H{H} KVH{H} S{P} Dqk{D} Dv{Dv} causal", dname,
                timed))
            continue
        H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
        checks["flash_attention"].append(check_kernel(
            "flash_attention", prefill_case(1, H, KVH, P, D, dtype, True, gen),
            f"{arch} B1 H{H} KVH{KVH} S{P} D{D} causal", dname, timed))
        for length in sorted({P, P + 1, P + 15, P + N // 2, S - 1}):
            checks["flash_decode"].append(check_kernel(
                "flash_decode",
                decode_case(1, H, KVH, S, D, dtype, [length], gen),
                f"{arch} B1 H{H} KVH{KVH} S{S} D{D} len{length}", dname,
                timed and length == P + 1))
    return checks


def whisper_shape_checks(dname, dtype, gen):
    """The attention kernels at whisper-large-v3's shapes (heads from the
    published config, phase 11's transcript): cross-attention (Sq = the
    transcript, Skv = the frames) and the encoder (S = the frames), both
    not causal, and ``flash_decode`` over all the frames, timed; the
    decoder's causal prefill and its self-attention decode over the
    transcript's cache, untimed."""
    from repro_torch.configs import get_arch
    cfg = get_arch("whisper-large-v3")
    H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    T, P = cfg.enc_dec.n_frames, WHISPER_RUN["transcript"]
    S = P + WHISPER_RUN["max_new"]
    fa = [check_kernel("flash_attention",
                       prefill_case(1, H, KVH, P, D, dtype, False, gen,
                                    Skv=T),
                       f"whisper cross B1 H{H} KVH{KVH} Sq{P} Skv{T} D{D} "
                       "full", dname, True),
          check_kernel("flash_attention",
                       prefill_case(1, H, KVH, T, D, dtype, False, gen),
                       f"whisper encoder B1 H{H} KVH{KVH} S{T} D{D} full",
                       dname, True),
          check_kernel("flash_attention",
                       prefill_case(1, H, KVH, P, D, dtype, True, gen),
                       f"whisper decoder B1 H{H} KVH{KVH} S{P} D{D} causal",
                       dname, False)]
    fd = [check_kernel("flash_decode",
                       decode_case(1, H, KVH, T, D, dtype, [T], gen),
                       f"whisper cross B1 H{H} KVH{KVH} S{T} D{D} len{T}",
                       dname, True)]
    fd += [check_kernel("flash_decode",
                        decode_case(1, H, KVH, S, D, dtype, [n], gen),
                        f"whisper self B1 H{H} KVH{KVH} S{S} D{D} len{n}",
                        dname, False) for n in (1, P + 1, S)]
    return {"flash_attention": fa, "flash_decode": fd}


def scaled_checks(gen):
    """Both attention kernels with a score scale of their caller's, at the
    published Zamba2-2.7B's shared block, in fp32 and bf16: the causal
    prefill of the prompt and decode at the first, a middle and the last
    step's length, each against the plain version at the same scale."""
    import torch
    z = ZAMBA2_PUBLISHED
    H, D, P, S = z["H"], z["D"], z["prompt"], z["cache"]
    checks = {"flash_attention": [], "flash_decode": []}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        args, kw, nb, fl = prefill_case(1, H, H, P, D, dtype, True, gen)
        checks["flash_attention"].append(check_kernel(
            "flash_attention", (args, dict(kw, scale=z["scale"]), nb, fl),
            f"zamba2 published B1 H{H} KVH{H} S{P} D{D} causal scale "
            f"{z['scale']:.6f}", dname, False))
        for length in (P + 1, P + (S - P) // 2, S):
            args, kw, nb, fl = decode_case(1, H, H, S, D, dtype, [length],
                                           gen)
            checks["flash_decode"].append(check_kernel(
                "flash_decode", (args, dict(kw, scale=z["scale"]), nb, fl),
                f"zamba2 published B1 H{H} KVH{H} S{S} D{D} len{length} "
                f"scale {z['scale']:.6f}", dname, False))
    return checks


def mamba2_operands(B, dtype, gen, nh, hd, N, G, K):
    """A Mamba2 step's operands on the card: zx and the weights in
    ``dtype``, the window, the state, dt_bias, A_log and D in fp32."""
    import torch
    d_in, cc = nh * hd, nh * hd + 2 * G * N

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")
                ).to(dt)

    p = {"conv_w": rnd(K, cc, scale=0.3, dt=dtype),
         "conv_b": rnd(cc, scale=0.1, dt=dtype),
         "dt_bias": rnd(nh, scale=0.5) - 2.0,
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device="cuda")),
         "D": rnd(nh), "out_norm": (rnd(d_in, scale=0.1) + 1).to(dtype)}
    zx = rnd(B, 2 * d_in + 2 * G * N + nh, dt=dtype)
    return zx, rnd(B, K - 1, cc, scale=0.5), rnd(B, nh, hd, N, scale=0.3), p


def mamba2_check(B, dname, dtype, gen, timed=False):
    """The kernel against its plain version on copies of one window and
    state; optionally timed. Returns a result dict."""
    import torch
    from repro_torch.kernels import mamba2_step as m2
    from repro_torch.kernels import ref
    z, eps = MAMBA2_PUBLISHED, MAMBA2_EPS
    zx, conv, h, p = mamba2_operands(B, dtype, gen, **z)
    kc, kh, pc, ph = conv.clone(), h.clone(), conv.clone(), h.clone()
    got = m2.mamba2_step(zx, kc, kh, *p.values(), eps)
    want = ref.mamba2_step_ref(zx, pc, ph, *p.values(), eps)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    state_err = (kh - ph).abs().max().item()
    tol = MAMBA2_TOL[dname]
    win_eq = torch.equal(kc, pc)
    ok = bool(((got.float() - want.float()).abs()
               <= tol + tol * want.float().abs()).all()) \
        and state_err <= MAMBA2_TOL["state"] and win_eq \
        and bool(torch.isfinite(got.float()).all())
    label = (f"zamba2 published B{B} nh{z['nh']} hd{z['hd']} N{z['N']} "
             f"G{z['G']} K{z['K']}")
    res = {"shape": label, "dtype": dname, "max_abs_err": err,
           "state_max_abs_err": state_err, "tol": tol, "ok": ok}
    if timed:
        # every byte the step moves: the state read and written, the window
        # read and written, zx, the conv weights, the small parameters, and
        # y written and read back by the norm
        item, witem = zx.element_size(), p["conv_w"].element_size()
        nbytes = (2 * h.numel() * 4 + 2 * conv.numel() * 4
                  + zx.numel() * item
                  + sum(t.numel() * t.element_size() for t in p.values())
                  + 3 * got.numel() * item)
        copies = [(zx, kc, kh)] + [
            (zx.clone(), kc.clone(), kh.clone())
            for _ in range(math.ceil(ROTATE_BYTES / nbytes) - 1)]
        t = device_ms([lambda a=a: m2.mamba2_step(*a, *p.values(), eps)
                       for a in copies])
        tp = device_ms([lambda a=a: ref.mamba2_step_ref(*a, *p.values(),
                                                        eps)
                        for a in copies[:4]], iters=20, reps=3)
        m = machine()
        res.update(ms=t["ms"], plain_ms=tp["ms"], library_ms=None,
                   bound_ms=nbytes / m.hbm_bytes_per_s * 1e3,
                   bound_by="bytes", bytes=nbytes, copies=len(copies),
                   host_hidden={"ms": t["hidden"], "plain_ms": tp["hidden"]},
                   weights_bytes_per_elem=witem)
    say(f"  mamba2_step {label} {dname}: max_abs_err={err:.3g} (tol {tol}),"
        f" state max_abs_err={state_err:.3g} (tol {MAMBA2_TOL['state']}),"
        f" window equal {win_eq}"
        + (f" ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
           f"library_ms=none bound_ms={res['bound_ms']:.4f} (bytes: "
           f"{res['bytes']} at {machine().hbm_bytes_per_s:.4g} B/s); "
           f"device-only over {res['copies']} input copies, host hidden "
           f"(kernel/plain): {t['hidden']}/{tp['hidden']}" if timed else "")
        + ("" if ok else "  MISMATCH"))
    return res


def mamba2_steps_check(gen, steps: int = 64, B: int = 4):
    """``steps`` kernel calls on one window and state, in place, against
    as many plain ones, bf16: every y within the tolerance, the final
    state within 1e-5 and the window bit for bit."""
    import torch
    from repro_torch.kernels import mamba2_step as m2
    from repro_torch.kernels import ref
    z = MAMBA2_PUBLISHED
    zx, conv, h, p = mamba2_operands(B, torch.bfloat16, gen, **z)
    kc, kh, pc, ph = conv.clone(), h.clone(), conv.clone(), h.clone()
    err = 0.0
    for _ in range(steps):
        zx = torch.randn(zx.shape, generator=gen, device="cuda").to(zx.dtype)
        got = m2.mamba2_step(zx, kc, kh, *p.values(), MAMBA2_EPS)
        want = ref.mamba2_step_ref(zx, pc, ph, *p.values(), MAMBA2_EPS)
        err = max(err, ((got.float() - want.float()).abs()
                        / (1 + want.float().abs())).max().item())
    state_err = (kh - ph).abs().max().item()
    ok = err <= MAMBA2_TOL["bfloat16"] and state_err <= MAMBA2_TOL["state"] \
        and torch.equal(kc, pc)
    say(f"  mamba2_step {steps} steps in place, B{B} bf16: worst y "
        f"|diff| / (1 + |y|) {err:.3g}, final state max_abs_err "
        f"{state_err:.3g}, window equal {torch.equal(kc, pc)}"
        + ("" if ok else "  MISMATCH"))
    return {"shape": f"{steps} steps in place B{B}", "dtype": "bfloat16",
            "max_abs_err": err, "state_max_abs_err": state_err, "ok": ok}


def mamba2_graph_check(gen, replays: int = 8):
    """One call captured in a CUDA graph, replayed on ``replays`` new
    inputs, against eager calls: outputs, window and state bit for bit."""
    import torch
    from repro_torch.kernels import mamba2_step as m2
    z, eps = MAMBA2_PUBLISHED, MAMBA2_EPS
    zx, conv, h, p = mamba2_operands(1, torch.bfloat16, gen, **z)
    zxs = [torch.randn(zx.shape, generator=gen, device="cuda").to(zx.dtype)
           for _ in range(replays)]
    ec, eh = conv.clone(), h.clone()
    eager = [m2.mamba2_step(x, ec, eh, *p.values(), eps) for x in zxs]
    gc, gh, static = conv.clone(), h.clone(), zx.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        m2.mamba2_step(static, gc.clone(), gh.clone(), *p.values(), eps)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = m2.mamba2_step(static, gc, gh, *p.values(), eps)
    gc.copy_(conv)
    gh.copy_(h)
    same = True
    for x, want in zip(zxs, eager):
        static.copy_(x)
        graph.replay()
        same = same and torch.equal(out, want)
    torch.cuda.synchronize()
    ok = same and torch.equal(gc, ec) and torch.equal(gh, eh)
    say(f"  mamba2_step captured once, replayed {replays} times: outputs, "
        f"window and state equal the eager calls' {ok}"
        + ("" if ok else "  MISMATCH"))
    return {"shape": f"CUDA graph, {replays} replays", "dtype": "bfloat16",
            "max_abs_err": 0.0 if ok else float("nan"), "ok": ok}


def mamba2_published_launches():
    """The published Zamba2-2.7B block (54 layers, bf16, full width) built
    from the benchmark's configuration: one eager decode step after a
    16-token prefill issues ``mamba2_step`` once a layer, each call its
    two launches."""
    import torch
    from portbench.harness import arch_config
    from repro_torch.kernels import mamba2_step as m2
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    free_cuda()
    m = json.loads((ROOT / "portbench" / "configs" / "zamba2-2.7b.json")
                   .read_text())["model"]
    cfg = arch_config(m)
    model = build_model(cfg, "cuda")
    with torch.no_grad():
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (1, 16), device="cuda")
        cache = model.init_cache(params, {"tokens": toks}, 1, 32)
        lg, cache = model.prefill(params, {"tokens": toks}, cache)
        ops.reset_launch_counts()
        model.decode_step(params, cache, lg.argmax(-1)[:, None],
                          torch.full((1,), 16, dtype=torch.int32,
                                     device="cuda"))
        torch.cuda.synchronize()
    n = ops.launch_counts()["mamba2_step"]
    want = cfg.n_layers * m2.LAUNCHES_PER_CALL
    say(f"  mamba2_step launches in one eager decode step of the published "
        f"block ({cfg.n_layers} layers): {n} (want {want})")
    del model, params, cache
    free_cuda()
    return {"shape": f"published block, {cfg.n_layers} layers, one eager "
            "decode step", "dtype": "bfloat16", "launches": n,
            "max_abs_err": 0.0, "ok": n == want}


def mamba2_checks():
    """Phase 3 (c): the Mamba2 step kernel."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(29)
    out = [mamba2_check(B, dname, dtype, gen,
                        timed=(B == 1 and dname == "bfloat16"))
           for dname, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16))
           for B in (1, 4)]
    out += [mamba2_steps_check(gen), mamba2_graph_check(gen),
            mamba2_published_launches()]
    bad = [(r["shape"], r["dtype"]) for r in out if not r["ok"]]
    require(not bad, f"mamba2_step disagrees: {bad}")
    return out


def kernel_phase():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": [], "flash_decode": [],
               "chacha20": chacha20_checks()}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        timed = True
        results["flash_attention"] += [
            check_kernel("flash_attention",
                         prefill_case(1, 16, 16, 512, 64, dtype, True, gen),
                         "serve B1 H16 KVH16 S512 D64 causal", dname, timed),
            check_kernel("flash_attention",
                         prefill_case(4, 48, 4, 500, 128, dtype, True, gen),
                         "gqa B4 H48 KVH4 S500 D128 causal", dname, timed),
            check_kernel("flash_attention",
                         prefill_case(2, 48, 4, 77, 128, dtype, False, gen),
                         "gqa B2 H48 KVH4 S77 D128 full", dname, False),
            check_kernel("flash_attention",
                         prefill_case(1, 128, 128, 512, 192, dtype, True,
                                      gen, Dv=128),
                         "mla B1 H128 KVH128 S512 Dqk192 Dv128 causal",
                         dname, timed),
            check_kernel("flash_attention",
                         prefill_case(2, 4, 4, 77, 192, dtype, False, gen,
                                      Dv=128),
                         "mla B2 H4 KVH4 S77 Dqk192 Dv128 full", dname,
                         False),
        ]
        results["flash_decode"] += [
            check_kernel("flash_decode",
                         decode_case(1, 16, 16, 576, 64, dtype, [513], gen),
                         "serve B1 H16 KVH16 S576 D64 len513", dname, timed),
            check_kernel("flash_decode",
                         decode_case(4, 48, 4, 576, 128, dtype,
                                     [1, 100, 511, 576], gen),
                         "gqa B4 H48 KVH4 S576 D128 len{1,100,511,576}",
                         dname, timed),
        ]
        results["flash_decode"] += cluster_decode_checks(dname, dtype, gen)
        for name, checks in whisper_shape_checks(dname, dtype, gen).items():
            results[name] += checks
        for runs, timed in (({a: MOE_SERVE for a in MOE_DEPTH}, False),
                            (WIDE_SERVE, dname == "bfloat16")):
            for name, checks in serve_shape_checks(runs, dname, dtype, gen,
                                                   timed).items():
                results[name] += checks
    for name, checks in calibration_shape_checks(gen).items():
        results[name] += checks
    for name, checks in scaled_checks(gen).items():
        results[name] += checks
    bad = [(n, r["shape"], r["dtype"]) for n, rs in results.items()
           for r in rs if not r["ok"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    return results


def serve_argv(mode: str, settings: dict) -> list:
    argv = ["--arch", ARCH, "--mode", mode]
    for k, v in settings.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def kernel_function(name: str) -> str:
    """``void ns::f<T, 4>(float*)`` -> ``f``."""
    name = name.strip().replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


@contextlib.contextmanager
def executed_kernels(into: dict):
    """Fills ``into`` with each kernel's executions on the current card
    inside the block, counted by function name in a profile of the card's
    activity: a replayed CUDA graph's kernels count at every replay,
    where the launch counters count what the host issued (a graph's once,
    at its capture). The launch counters are reset just before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    seen = collections.Counter(
        kernel_function(e.name())
        for e in prof.profiler.kineto_results.events()
        if str(e.device_type()).endswith("CUDA"))
    into.update({name: sum(seen[f] for f in fns)
                 for name, fns in KERNEL_FUNCTIONS.items()})


def serve_phase():
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = serve_argv("engine", SERVE)
    launches = {}
    with executed_kernels(launches):
        m, ex = serve.main(argv)
    say(f"  kernels executed {launches}, issued by the host "
        f"{ops.launch_counts()}")
    n, N = SERVE["requests"], SERVE["max_new"]
    require(m.completed == n, f"{m.completed}/{n} requests completed")
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    need = {"flash_attention": n * cfg.n_layers,
            "flash_decode": n * (N - 1) * cfg.n_layers}
    for name, k in need.items():
        require(launches[name] >= k,
                f"{name} launched {launches[name]} times, expected >= {k}")
    for rid in range(n):
        toks = ex.generated(rid)
        require(len(toks) == N and all(0 <= t < cfg.vocab for t in toks),
                f"request {rid}: tokens {toks[:8]}...")
    return m, ex, launches


def profile_phase(model, params, steps: int = 8, top: int = 5, extra=None,
                  prompt=None):
    """Where a serving step's time goes: one prefill of ``prompt`` tokens
    (the serve prompt by default; ``extra`` adds inputs such as the
    encoder-decoder's frames, whose ``init_cache`` runs the encoder inside
    the traced prefill) and ``steps`` decode steps of one request, traced
    with ``torch.profiler``. Prints wall time, device busy time (union of
    the kernels' intervals), the idle share and the ``top`` kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    P, dev = prompt or SERVE["prompt"], model.device
    toks = torch.randint(0, model.cfg.vocab, (1, P), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    batch = {"tokens": toks, **(extra or {})}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def traced(fn):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
        busy, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        return wall_us, busy, len(kern), sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]

    state = {}

    def prefill():
        cache = model.init_cache(params, batch, 1, P + steps + 1)
        logits, state["cache"] = model.prefill(params, batch, cache)
        state["tok"] = logits.argmax(-1)[:, None]

    def decode():
        lengths = torch.full((1,), P, dtype=torch.int32, device=dev)
        for _ in range(steps):
            logits, state["cache"] = model.decode_step(
                params, state["cache"], state["tok"], lengths)
            state["tok"], lengths = logits.argmax(-1)[:, None], lengths + 1

    prefill()                                       # warm
    for name, fn, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        wall, busy, nk, heavy = traced(fn)
        if nk == 0:
            say(f"  {name}: wall {wall / n / 1e3:.3f} ms/step; device time "
                "not measured (the profiler saw no CUDA kernels)")
            continue
        say(f"  {name}: wall {wall / n / 1e3:.3f} ms/step, device busy "
            f"{busy / n / 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f}, "
            f"{nk / n:.0f} kernels/step; top: " + "; ".join(
                f"{k[:48]} {v / n:.1f} us" for k, v in heavy))


@contextlib.contextmanager
def plain_attention():
    """Swap the kernels' plain versions into the model's dispatchers."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.flash_decode
    ops.flash_attention = ref.attention_ref
    ops.flash_decode = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = saved


@contextlib.contextmanager
def recorded_routes(into: list):
    """Append the expert ids of every MoE routing call (``moe._route``)
    to ``into``."""
    from repro_torch.models import moe
    route = moe._route

    def recording(*args, **kwargs):
        w, ids, aux = route(*args, **kwargs)
        into.append(ids)
        return w, ids, aux

    moe._route = recording
    try:
        yield
    finally:
        moe._route = route


def routing_agreement(a: list, b: list) -> tuple:
    """(choices of run ``a`` that run ``b`` made for the same token and
    routing call, all choices): per token, the size of the intersection
    of the two top-k sets."""
    same = total = 0
    for x, y in zip(a, b, strict=True):
        hit = (x[:, :, None] == y[:, None, :]).any(-1)
        same += int(hit.sum())
        total += x.numel()
    return same, total


def end_to_end_phase(cfg=None, steps: int = 8, prompt: int = 512):
    """Full width in fp32 (``cfg``'s depth, the published qwen1.5-0.5b by
    default): prefill + greedy decode through the kernels, against the
    same weights with the plain versions. For an MoE config it also
    prints how many routing choices the two runs share."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(cfg or get_arch(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, prompt), generator=gen,
                         device="cuda")

    def run(routes):
        with recorded_routes(routes):
            cache = model.init_cache(params, None, 2, prompt + steps)
            logits, cache = model.prefill(params, {"tokens": toks}, cache)
            out, tok = [logits], logits.argmax(-1)[:, None]
            lengths = torch.full((2,), prompt, dtype=torch.int32,
                                 device="cuda")
            for _ in range(steps):
                logits, cache = model.decode_step(params, cache, tok,
                                                  lengths)
                out.append(logits)
                tok, lengths = logits.argmax(-1)[:, None], lengths + 1
        return torch.stack(out)

    routes_k, routes_p = [], []
    got = run(routes_k)
    with plain_attention():
        want = run(routes_p)
    require(bool(torch.isfinite(got).all()), "end-to-end logits not finite")
    err = (got - want).abs().max().item()
    tol = 1e-3 * max(1.0, want.abs().max().item())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    routed = ""
    if cfg.moe is not None:
        agree, total = routing_agreement(routes_k, routes_p)
        routed = (f"; routing choices shared by both runs: {agree}/{total}"
                  f" ({cfg.moe.top_k} of {cfg.moe.n_experts} a token)")
    say(f"  end-to-end fp32 {cfg.name} {cfg.n_layers} layer(s) at width "
        f"{cfg.d_model}, prompt {prompt} + {steps} decode steps x 2 "
        f"sequences: max logit err {err:.3g} (tol {tol:.3g}), max |logit| "
        f"{want.abs().max().item():.3g}, greedy tokens equal: {same}"
        + routed)
    require(err <= tol and same, f"{cfg.name}: kernel path disagrees with "
            "the plain path at full width")
    return err


def unembed_phase(rows: int = 4, tol: float = 1e-3):
    """The served bf16 ``unembed`` at the published width keeps fp32
    logits: against the same bf16 operands widened to fp32 (exact
    products, fp32 sums), at logits of standard deviation about 19, where
    the bf16 step is 0.06 to 0.5."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import unembed
    cfg = get_arch(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(rows, 1, cfg.d_model, generator=gen, device="cuda")
    w = torch.randn(cfg.vocab, cfg.d_model, generator=gen, device="cuda")
    x, w = x.to(torch.bfloat16), (w * 0.6).to(torch.bfloat16)
    got = unembed(x, w, torch.bfloat16)
    want = x.float() @ w.float().T
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    big = want.abs().max().item()
    say(f"  unembed bf16 [{rows},{cfg.d_model}] x [{cfg.vocab},"
        f"{cfg.d_model}]: logits {got.dtype}, max |logit| {big:.3g}, max "
        f"err vs fp32 sums {err:.3g} (tol {tol})")
    require(got.dtype == torch.float32 and got.shape == want.shape,
            f"unembed gave {got.dtype} {tuple(got.shape)}")
    require(big > 10.0 and err <= tol,
            "unembed logits are not fp32-accurate")


def calibration_phase():
    """``python -m repro_torch.analysis.calibrate`` on the card, through its
    ``main``: kernel timelines and differentials launch the three kernels,
    every arch is analysed at its published config on the meta device.
    Returns the launches of that run."""
    import hashlib

    from repro_torch.analysis import derived
    from repro_torch.analysis.calibrate import DERIVED_CUDA_PATH
    from repro_torch.analysis.calibrate import main as calibrate_main
    from repro_torch.analysis.calibrate import ported_archs
    from repro_torch.kernels import ops

    def digest():
        return hashlib.sha256(derived.DERIVED_PATH.read_bytes()).hexdigest()

    before = digest()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = calibrate_main(["--out", str(CALIB_OUT)])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    say(f"  calibration wall {wall:.1f}s, exit {rc}, launches {launches}")
    require(rc == 0, f"calibration exited {rc}")
    for name in KERNELS:
        require(launches[name] >= 1,
                f"{name} launched {launches[name]} times in calibration")
    data = json.loads(CALIB_OUT.read_text())
    ref = json.loads(derived.DERIVED_PATH.read_text())
    ported, _ = ported_archs()
    require(sorted(data["workloads"]) == sorted(ported),
            f"calibrated {sorted(data['workloads'])}, expected {ported}")
    for name in KERNELS:
        tags = data["kernels"][name]["tags"]
        require(name in tags and name in ref["kernels"][name]["tags"],
                f"kernel {name} tags {tags} (reference "
                f"{ref['kernels'][name]['tags']})")
    for arch, w in sorted(data["workloads"].items()):
        pre, dec = w["prefill"], w["decode_step"]
        heavy = [dec["est_us"] * dec["heavy_share"],
                 pre["est_us"] * pre["heavy_share"]]
        say(f"  {arch}: tags {w['tags']} (reference "
            f"{ref['workloads'][arch]['tags']}); decode/prefill heavy time "
            f"{heavy[0]:.1f}/{heavy[1]:.1f} us = {heavy[0] / heavy[1]:.4f} "
            "(tag_heavy's rel_duration is 0.10)")
        require("prefill" in w["tags"]
                and "prefill" in ref["workloads"][arch]["tags"],
                f"{arch}: prefill not tagged heavy ({w['tags']})")
    require(digest() == before, "derived.json changed during calibration")
    committed = json.loads(DERIVED_CUDA_PATH.read_text())
    stale = [f"{part}/{name}" for part in ("kernels", "workloads")
             for name, entry in committed[part].items()
             if {k: v for k, v in entry.items() if k != "differential"}
             != {k: v for k, v in data[part][name].items()
                 if k != "differential"}]
    say(f"  the committed derived_cuda.json equals this run's kernels and "
        f"workloads (differentials aside): {not stale}")
    require(not stale, f"derived_cuda.json is stale for {stale}")
    return launches


@contextlib.contextmanager
def counting_executors():
    """Make every executor the serve path builds count the kernel launches
    of its own calls (``ex.launches``), from the wrappers' counters."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    base = serve.RealModelExecutor

    class Counting(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.launches = dict.fromkeys(ops.KERNEL_MODULES, 0)

        def _counted(self, call, *args):
            before = ops.launch_counts()
            out = call(*args)
            for name, n in ops.launch_counts().items():
                self.launches[name] += n - before[name]
            return out

        def prefill(self, *args):
            return self._counted(super().prefill, *args)

        def decode(self, *args):
            return self._counted(super().decode, *args)

    serve.RealModelExecutor = Counting
    try:
        yield
    finally:
        serve.RealModelExecutor = base


def greedy_tokens(ex, prompt, max_new: int) -> list:
    """A fresh single-request run of ``prompt`` through the executor's
    model: prefill and ``max_new - 1`` greedy decode steps at batch 1."""
    import torch
    model, params = ex.model, ex.params
    toks = torch.as_tensor(prompt[None], dtype=torch.long,
                           device=model.device)
    cache = model.init_cache(params, {"tokens": toks}, 1, ex.max_seq)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    tok = logits.argmax(-1)[:, None]
    out = [int(tok)]
    length = torch.full((1,), toks.shape[1], dtype=torch.int32,
                        device=model.device)
    for _ in range(max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, length)
        tok, length = logits.argmax(-1)[:, None], length + 1
        out.append(int(tok))
    return out


def cluster_phase():
    """Cluster serving with the crash fault plan at the published width,
    then a workload in engine mode. Returns the cluster run's launches,
    its summary and the phase's wall seconds."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    with counting_executors():
        ops.reset_launch_counts()
        m, executors, oracle = serve.main(serve_argv("cluster", CLUSTER))
        launches = ops.launch_counts()
    s = m.summary()
    n = CLUSTER["requests"]
    say(f"  cluster: {s['completed']}/{n} completed, shed "
        f"{s['shed_total']}, expired {s['expired_total']}, leftover "
        f"{s['leftover']}; faults {dict(m.faults_injected)}, recoveries "
        f"{s['shard_recoveries']}, drained {s['drained']}, retries "
        f"{s['retries']}; oracle violations {oracle.n_violations}; "
        f"launches {launches}")
    require(oracle.n_violations == 0,
            f"cluster oracle violations: {oracle.violations[:5]}")
    require(s["injected"] == n and s["leftover"] == 0
            and s["injected"] == s["completed"] + s["shed_total"]
            + s["expired_total"],
            f"conservation broken: {s['injected']} injected, "
            f"{s['completed']} completed, {s['shed_total']} shed, "
            f"{s['expired_total']} expired, {s['leftover']} left over")
    require(s["faults_injected"] >= 1 and s["shard_recoveries"] >= 1,
            f"the crash plan injected {s['faults_injected']} faults and "
            f"{s['shard_recoveries']} recoveries in this window")
    import torch
    copies = len({id(ex.params) for ex in executors.values()})
    require(copies == min(CLUSTER["shards"], torch.cuda.device_count()),
            f"{copies} copies of the weights for {len(executors)} shards")
    for name, ex in executors.items():
        say(f"  {name} on {ex.device}: kernel launches {ex.launches}, "
            f"finished {len(ex.done)} requests")
        for kernel in ("flash_attention", "flash_decode"):
            require(ex.launches[kernel] >= 1,
                    f"{name} launched {kernel} {ex.launches[kernel]} times")
    # the executor that finished a request holds its highest attempt
    finished = {}
    for name, ex in executors.items():
        for rid, attempt in ex.done.items():
            if rid not in finished or attempt > finished[rid][0]:
                finished[rid] = (attempt, name)
    require(len(finished) == s["completed"],
            f"{len(finished)} requests finished on executors, "
            f"{s['completed']} completed")
    # the checked requests: those finished on other attempts first, then
    # one a shard in turn
    order = sorted(finished, key=lambda r: (-finished[r][0], r))
    by_shard = {}
    for rid in order:
        by_shard.setdefault(finished[rid][1], []).append(rid)
    picks = []
    while len(picks) < min(CLUSTER_TOKEN_CHECKS, len(order)):
        for rids in by_shard.values():
            if rids and len(picks) < CLUSTER_TOKEN_CHECKS:
                picks.append(rids.pop(0))
    for rid in picks:
        attempt, name = finished[rid]
        ex = executors[name]
        got = ex.generated(rid)
        want = greedy_tokens(ex, ex.prompts[rid], CLUSTER["max_new"])
        say(f"  request {rid} (attempt {attempt}, finished on {name}): "
            f"tokens {got} equal a fresh run: {got == want}")
        require(got == want, f"request {rid}: served {got}, fresh {want}")

    wm, _ = serve.main(serve_argv("engine", WORKLOAD))
    ws = wm.summary()
    say(f"  workload {WORKLOAD['workload']!r} (engine): "
        f"{wm.completed}/{WORKLOAD['requests']} completed, ttft p50/p99 "
        f"{ws['ttft_p50_ms']:.3f}/{ws['ttft_p99_ms']:.3f} ms, itl p50/p99 "
        f"{ws['itl_p50_ms']:.3f}/{ws['itl_p99_ms']:.3f} ms")
    require(wm.completed == WORKLOAD["requests"],
            f"workload: {wm.completed}/{WORKLOAD['requests']} completed")
    return launches, s, time.perf_counter() - t0


def full_width_phase(runs):
    """Archs at their published widths in bf16, one after the other: for
    each ``(cfg, serve settings, end-to-end depth)`` of ``runs``, the
    model built and initialised on the card, served through
    ``serve.run_engine`` with its kernels' executions on the card counted
    (``executed_kernels``: ``flash_attention`` once a layer, or once an
    application of the hybrid's shared block, a request; ``flash_decode``
    as often a decode step, and never on MLA's absorbed decode), its
    memory and a profiled prefill and decode steps printed, MLA's decode
    held to ``mla_decode_naive`` and the hybrid's SSD chunk loop measured
    (``ssd_phase``), then freed; and the fp32 end-to-end check of phase 5
    at the end-to-end depth. Returns each arch's serving executions."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model

    out = {}
    for cfg, run, e2e_depth in runs:
        arch = cfg.name
        free_cuda()
        model = build_model(cfg, "cuda")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights = torch.cuda.memory_allocated()
        say(f"  {arch}: {cfg.n_layers} of {get_arch(arch).n_layers} layers "
            f"at d {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads x "
            f"{cfg.resolved_head_dim}, {cfg.param_count() / 1e9:.2f}B "
            f"params, {weights / 1e9:.2f} GB of bf16 weights on the card, "
            f"initialised in {init_s:.1f}s (peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
        args = serve.build_parser().parse_args(
            ["--arch", arch] + serve_argv("engine", run)[2:])
        launches = {}
        with executed_kernels(launches):
            m, ex = serve.run_engine(args, cfg, model, params)
        s = m.summary()
        n, N = run["requests"], run["max_new"]
        say(f"  {arch} serving: {m.completed}/{n} requests, ttft p50/p99 "
            f"{s['ttft_p50_ms']:.3f}/{s['ttft_p99_ms']:.3f} ms, itl p50/p99 "
            f"{s['itl_p50_ms']:.3f}/{s['itl_p99_ms']:.3f} ms, launches "
            f"{launches}, weights {weights / 1e9:.2f} GB, max memory "
            f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        require(m.completed == n, f"{arch}: {m.completed}/{n} completed")
        for rid in range(n):
            toks = ex.generated(rid)
            require(len(toks) == N and all(0 <= t < cfg.vocab for t in toks),
                    f"{arch} request {rid}: tokens {toks[:8]}...")
        attn = cfg.n_layers // (cfg.hybrid.shared_attn_every
                                if cfg.hybrid else 1)
        require(launches["flash_attention"] >= n * attn,
                f"{arch}: flash_attention launched "
                f"{launches['flash_attention']} times, expected >= {n * attn}")
        if cfg.attention == "mla":      # absorbed decode: matrix products
            require(launches["flash_decode"] == 0,
                    f"{arch}: flash_decode launched {launches['flash_decode']}"
                    " times on MLA's path")
        else:
            require(launches["flash_decode"] >= n * (N - 1) * attn,
                    f"{arch}: flash_decode launched "
                    f"{launches['flash_decode']} times, expected >= "
                    f"{n * (N - 1) * attn}")
        if cfg.hybrid is not None:      # each Mamba2 layer's decode step
            want = n * (N - 1) * cfg.n_layers * 2
            require(launches["mamba2_step"] >= want,
                    f"{arch}: mamba2_step's kernels ran "
                    f"{launches['mamba2_step']} times, expected >= {want}")
        say(f"  {arch} where a serving step's time goes (torch.profiler):")
        profile_phase(model, params, steps=4, top=8)
        if cfg.attention == "mla":
            mla_decode_check(cfg, params)
        if cfg.hybrid is not None:
            ssd_phase(model, params)
        out[arch] = launches
        del model, params, ex, m
        free_cuda()
        end_to_end_phase(dataclasses.replace(get_arch(arch),
                                             n_layers=e2e_depth))
    free_cuda()
    return out


def mla_decode_check(cfg, params, tol: float = 2e-2):
    """The served absorbed MLA decode (layer 0's weights, full width, the
    compute dtype) against the decompressing form, ``mla_decode_naive``,
    on one random latent cache of the executor's length: a batch of 2 at
    the prompt's length and the last step's, held at ``tol`` of the
    output's scale (the bf16 tolerance of the kernel checks)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import layer_slices
    p = layer_slices(params["layers"], cfg.n_layers)[0]["attn"]
    P, N = MOE_SERVE["prompt"], MOE_SERVE["max_new"]
    dtype = p["wkv_b"]["w"].dtype
    gen = torch.Generator(device="cuda").manual_seed(2)
    cache = attn.mla_init_cache(cfg, 2, P + N, dtype, "cuda")
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    x = torch.randn(2, 1, cfg.d_model, generator=gen, device="cuda")
    lengths = torch.tensor([P, P + N - 1], dtype=torch.int32, device="cuda")
    y_abs, _ = attn.mla_decode(p, x.to(dtype), cfg,
                               {k: t.clone() for k, t in cache.items()},
                               lengths)
    y_naive, _ = attn.mla_decode_naive(p, x.to(dtype), cfg, cache, lengths)
    a, n = y_abs.float(), y_naive.float()
    err, scale = (a - n).abs().max().item(), n.abs().max().item()
    say(f"  {cfg.name} absorbed MLA decode ({dtype}, layer 0) against "
        f"mla_decode_naive: max_abs_err={err:.4g}, output scale "
        f"{scale:.4g} (tol {tol} x scale)")
    require(bool(torch.isfinite(a).all()) and err <= tol * scale,
            f"{cfg.name}: absorbed MLA decode disagrees with the naive "
            f"form ({err:.4g} against {tol * scale:.4g})")


def free_cuda():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def ssd_phase(model, params):
    """The hybrid's SSD chunk loop on the card. For layer 0's Mamba2
    prefill at each of ``SSD_PROMPTS`` (full width, a random bf16 residual
    stream): the chunk it runs with, the loop's iterations, the CUDA
    kernels the layer launches (``torch.profiler``) and its time between
    synchronisations, and those kernels times the layer count for one
    prefill's Mamba2 layers. Then the share of a served prefill spent in
    ``_ssd_chunk_scan`` and of a decode step in the Mamba2 layers, each
    timed between synchronisations inside one synchronised step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import hybrid, mamba2
    from repro_torch.models.transformer import layer_slices
    cfg = model.cfg
    p0 = layer_slices(params["layers"], cfg.n_layers)[0]["m"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    for P in SSD_PROMPTS:
        Q = mamba2._chunk_len(P, cfg.ssm.chunk)
        x = torch.randn(1, P, cfg.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)

        def layer():
            return mamba2.mamba2_prefill(
                p0, x, cfg, mamba2.mamba2_init_state(cfg, 1, "cuda"))

        layer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = layer()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        require(bool(torch.isfinite(y).all()),
                f"Mamba2 prefill at prompt {P} not finite")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            layer()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        say(f"  SSD chunk loop at prompt {P}: chunk {Q}, {P // Q} "
            f"iterations a layer; layer 0's prefill launches {len(kern)} "
            f"CUDA kernels ({dev_ms:.3f} ms of device time) in {ms:.3f} ms; "
            f"x {cfg.n_layers} layers = {len(kern) * cfg.n_layers} kernels "
            "in one prefill's Mamba2 layers")

    spent = {"scan": 0.0, "mamba": 0.0}

    def timed(key, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return call

    P = WIDE_SERVE[cfg.name]["prompt"]
    toks = torch.randint(0, cfg.vocab, (1, P), device="cuda",
                         generator=gen)
    scan, decode = mamba2._ssd_chunk_scan, hybrid.mamba2_decode
    mamba2._ssd_chunk_scan = timed("scan", scan)
    hybrid.mamba2_decode = timed("mamba", decode)
    try:
        cache = model.init_cache(params, None, 1, P + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.decode_step(params, cache, logits.argmax(-1)[:, None],
                          torch.full((1,), P, dtype=torch.int32,
                                     device="cuda"))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    finally:
        mamba2._ssd_chunk_scan, hybrid.mamba2_decode = scan, decode
    say(f"  SSD share at prompt {P}: _ssd_chunk_scan {spent['scan'] * 1e3:.3f}"
        f" of {pre_s * 1e3:.3f} ms of a prefill "
        f"({spent['scan'] / pre_s:.3f}); the Mamba2 layers "
        f"{spent['mamba'] * 1e3:.3f} of {dec_s * 1e3:.3f} ms of a decode step "
        f"({spent['mamba'] / dec_s:.3f}); each timed between "
        "synchronisations, which the step's time includes")


def weights(params) -> tuple:
    """(parameters in billions, their GB) of a parameter dict."""
    from repro_torch.bridge import flatten
    ts = flatten(params).values()
    return (sum(t.numel() for t in ts) / 1e9,
            sum(t.numel() * t.element_size() for t in ts) / 1e9)


def rwkv_phase():
    """rwkv6-3b whole at its published width in bf16, served through
    ``serve.main`` in engine mode with the launch counters reset just
    before and read just after (attention-free: no kernel launches), its
    memory, finite logits at every position of a served-length prompt and
    a profiled prefill and decode steps; then the fp32 check against the
    recurrence (``rwkv_recurrence_check``). Returns the serving
    launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import rwkv6
    arch, run = "rwkv6-3b", RWKV_SERVE
    cfg = get_arch(arch)
    free_cuda()
    ops.reset_launch_counts()
    m, ex = serve.main(["--arch", arch] + serve_argv("engine", run)[2:])
    launches = ops.launch_counts()
    s = m.summary()
    n, N, P = run["requests"], run["max_new"], run["prompt"]
    n_b, gb = weights(ex.params)
    say(f"  {arch} serving (serve.main, engine): {m.completed}/{n} "
        f"requests, {cfg.n_layers} of {cfg.n_layers} layers at d "
        f"{cfg.d_model}, {n_b:.2f}B params, ttft "
        f"p50/p99 {s['ttft_p50_ms']:.3f}/{s['ttft_p99_ms']:.3f} ms, itl "
        f"p50/p99 {s['itl_p50_ms']:.3f}/{s['itl_p99_ms']:.3f} ms, launches "
        f"{launches}, weights {gb:.2f} GB, max memory "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    require(m.completed == n, f"{arch}: {m.completed}/{n} completed")
    for rid in range(n):
        toks = ex.generated(rid)
        require(len(toks) == N and all(0 <= t < cfg.vocab for t in toks),
                f"{arch} request {rid}: tokens {toks[:8]}...")
    Q = rwkv6._chunk_len(P, cfg.rwkv.chunk)
    block = rwkv6.wkv_block_len(P, cfg.rwkv.chunk)
    toks = torch.randint(0, cfg.vocab, (1, P), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5))
    logits, states = rwkv6.rwkv6_lm_apply(ex.params, toks, cfg)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in states.values())
    say(f"  {arch} at prompt {P}: chunk {Q} run as {P // block} blocks of "
        f"{block}; logits at all {P} positions and the states finite: "
        f"{finite}, max |logit| {logits.abs().max().item():.4g}")
    require(finite, f"{arch}: non-finite logits at prompt {P}")
    say(f"  {arch} where a serving step's time goes (torch.profiler):")
    profile_phase(ex.model, ex.params, steps=4, top=8)
    del m, ex, logits, states
    free_cuda()
    rwkv_recurrence_check()
    return launches


def rwkv_recurrence_check(steps: int = 8):
    """rwkv6-3b at its published width in fp32 and ``RWKV_E2E_DEPTH``
    layers: the chunked prefill of 2 x 512 tokens against the same
    recurrence fed one token a call (the decode path), logits at every
    position within 1e-3 x max(1, max |logit|), and ``steps`` greedy
    tokens from each path's final states equal."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import rwkv6
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=RWKV_E2E_DEPTH,
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    P = RWKV_SERVE["prompt"]
    toks = torch.randint(0, cfg.vocab, (2, P), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))
    chunked, st_c = rwkv6.rwkv6_lm_apply(params, toks, cfg)
    st, out = model.init_cache(params, None, 2, 0), []
    for t in range(P):
        logits, st = model.decode_step(params, st, toks[:, t:t + 1], None)
        out.append(logits)
    step = torch.stack(out, dim=1)

    def greedy(states, last):
        tok, seq = last.argmax(-1)[:, None], []
        for _ in range(steps):
            seq.append(tok)
            logits, states = model.decode_step(params, states, tok, None)
            tok = logits.argmax(-1)[:, None]
        return torch.cat(seq, dim=1)

    same = bool(torch.equal(greedy(st_c, chunked[:, -1]),
                            greedy(st, step[:, -1])))
    err = (chunked - step).abs().max().item()
    tol = 1e-3 * max(1.0, step.abs().max().item())
    finite = bool(torch.isfinite(chunked).all())
    say(f"  rwkv6-3b fp32 {cfg.n_layers} layers at width {cfg.d_model}: "
        f"chunked prefill of 2 x {P} against the recurrence one token a "
        f"call: max logit err {err:.3g} (tol {tol:.3g}), max |logit| "
        f"{step.abs().max().item():.3g}, finite {finite}, {steps} greedy "
        f"tokens from each path's states equal: {same}")
    require(finite and err <= tol and same,
            "rwkv6-3b: the chunked prefill disagrees with the recurrence")
    del model, params, chunked, step
    free_cuda()


def whisper_phase():
    """whisper-large-v3 whole at its published width in bf16 through its
    Model API: ``init_cache`` over seeded frames (the encoder) and the
    prefill of a transcript, each timed between synchronisations; the
    self-KV filled step by step from length 0 and greedy decode steps,
    each step timed (ITL); the launch counters reset just before and read
    just after (``flash_attention`` once an encoder layer a pass and once
    for each decoder layer's self- and cross-attention; ``flash_decode``
    twice a decoder layer a step); the memory and a profiled prefill and
    decode steps. Then ``whisper_end_to_end_check``. Returns the
    launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import dt
    cfg = get_arch("whisper-large-v3")
    L, E = cfg.n_layers, cfg.enc_dec.n_encoder_layers
    T, P, N = cfg.enc_dec.n_frames, WHISPER_RUN["transcript"], \
        WHISPER_RUN["max_new"]
    free_cuda()
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn(1, T, cfg.d_model, generator=gen,
                         device="cuda").to(dt(cfg.compute_dtype))
    toks = torch.randint(0, cfg.vocab, (1, P), generator=gen, device="cuda")
    batch = {"tokens": toks, "frames": frames}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    model.prefill(params, batch, model.init_cache(params, batch, 1, P + N))
    torch.cuda.synchronize()                        # warm: builds, plans
    ops.reset_launch_counts()
    cache, enc_ms = timed(lambda: model.init_cache(params, batch, 1, P + N))
    (pre_logits, cache), pre_ms = timed(
        lambda: model.prefill(params, batch, cache))
    lengths = torch.zeros((1,), dtype=torch.int32, device="cuda")
    fill = []
    for t in range(P):
        (logits, cache), ms = timed(lambda: model.decode_step(
            params, cache, toks[:, t:t + 1], lengths))
        fill.append(ms)
        lengths = lengths + 1
    tf_err = (logits - pre_logits).abs().max().item()
    itl, out = [], []
    for _ in range(N):
        tok = logits.argmax(-1)[:, None]
        out.append(int(tok))
        (logits, cache), ms = timed(lambda: model.decode_step(
            params, cache, tok, lengths))
        itl.append(ms)
        lengths = lengths + 1
    launches = ops.launch_counts()
    finite = bool(torch.isfinite(pre_logits).all()) \
        and bool(torch.isfinite(logits).all())
    q = statistics.quantiles(itl, n=100)
    n_b, gb = weights(params)
    say(f"  whisper-large-v3 (Model API): {E} + {L} layers at d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads x "
        f"{cfg.resolved_head_dim}, {n_b:.2f}B params, "
        f"{gb:.2f} GB of bf16 weights, initialised in "
        f"{init_s:.1f}s; init_cache (the encoder over {T} frames) "
        f"{enc_ms:.3f} ms, prefill of {P} tokens {pre_ms:.3f} ms, self-KV "
        f"fill p50 {statistics.median(fill):.3f} ms a step, itl p50/p99 "
        f"{statistics.median(itl):.3f}/{q[98]:.3f} ms over {N} greedy "
        f"steps, tokens {out[:8]}...; prefill's logits against the last "
        f"fill step's (teacher forcing, bf16): max err {tf_err:.3g}; "
        f"finite {finite}; launches {launches}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    require(finite and all(0 <= t < cfg.vocab for t in out),
            f"whisper-large-v3: logits finite {finite}, tokens {out[:8]}")
    need = {"flash_attention": 2 * E + 2 * L,
            "flash_decode": 2 * L * (P + N)}
    for name, k in need.items():
        require(launches[name] >= k,
                f"whisper-large-v3: {name} launched {launches[name]} "
                f"times, expected >= {k}")
    say("  whisper-large-v3 where a step's time goes (torch.profiler; the "
        "prefill includes init_cache's encoder):")
    profile_phase(model, params, steps=4, top=8, extra={"frames": frames},
                  prompt=P)
    del model, params, cache, frames
    free_cuda()
    whisper_end_to_end_check()
    return launches


def whisper_end_to_end_check(steps: int = 8, tol_tf: float = 5e-4):
    """whisper-large-v3 at its published width in fp32 and
    ``WHISPER_E2E_DEPTH`` encoder and decoder layers, 2 sequences:
    init_cache, prefill, the self-KV filled step by step and ``steps``
    greedy steps through the kernels, against the same weights with the
    kernels' plain versions (logits within 1e-3 x max(1, max |logit|),
    greedy tokens equal); and the last decode step against the
    teacher-forced decoder over the same tokens, within ``tol_tf`` (the
    reference test's 5e-4)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    base = get_arch("whisper-large-v3")
    cfg = dataclasses.replace(
        base, n_layers=WHISPER_E2E_DEPTH, param_dtype="float32",
        compute_dtype="float32", enc_dec=dataclasses.replace(
            base.enc_dec, n_encoder_layers=WHISPER_E2E_DEPTH))
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    P = WHISPER_RUN["transcript"]
    frames = torch.randn(2, cfg.enc_dec.n_frames, cfg.d_model,
                         generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, P), generator=gen, device="cuda")
    batch = {"tokens": toks, "frames": frames}

    def run():
        cache = model.init_cache(params, batch, 2, P + steps)
        logits, cache = model.prefill(params, batch, cache)
        out, seq = [logits], [toks]
        lengths = torch.zeros((2,), dtype=torch.int32, device="cuda")
        for t in range(P):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], lengths)
            lengths = lengths + 1
        for _ in range(steps):
            out.append(logits)
            tok = logits.argmax(-1)[:, None]
            seq.append(tok)
            logits, cache = model.decode_step(params, cache, tok, lengths)
            lengths = lengths + 1
        return torch.stack(out + [logits]), torch.cat(seq, dim=1)

    got, seq = run()
    with plain_attention():
        want, _ = run()
    err = (got - want).abs().max().item()
    tol = 1e-3 * max(1.0, want.abs().max().item())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    tf = encdec.decode_forward(params, seq, encdec.encode(params, frames,
                                                          cfg), cfg)[:, -1]
    tf_err = (got[-1] - tf).abs().max().item()
    say(f"  end-to-end fp32 whisper-large-v3 {cfg.enc_dec.n_encoder_layers}"
        f" + {cfg.n_layers} layers at width {cfg.d_model}, {P}-token "
        f"transcripts filled step by step + {steps} greedy steps x 2: max "
        f"logit err {err:.3g} (tol {tol:.3g}), max |logit| "
        f"{want.abs().max().item():.3g}, greedy tokens equal: {same}; last "
        f"decode step against the teacher-forced decoder: max err "
        f"{tf_err:.3g} (tol {tol_tf})")
    require(bool(torch.isfinite(got).all()) and err <= tol and same,
            "whisper-large-v3: kernel path disagrees with the plain path")
    require(tf_err < tol_tf, "whisper-large-v3: decode disagrees with "
            "teacher forcing")
    del model, params
    free_cuda()


def train_phase():
    """Phase 12 (a): qwen1.5-0.5b whole at its published size in bf16,
    trained through ``repro_torch.launch.train.main`` with the launch
    counters reset just before and read just after (``flash_attention``
    twice a layer a step: the forward and remat's recompute), checkpointed
    at step 10; then the same run in fp32 (``--dtype float32``, same seed
    and batches), the bf16 curve held against it (``TRAIN_FP32_TOL``);
    then the step-10 checkpoint alone resumed to step 20, its losses
    against the uninterrupted run's, its last step profiled
    (``--profile-step``, ``train_profile``). Returns the uninterrupted
    run's launches."""
    import shutil

    import torch
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    cfg = get_arch(ARCH)
    B, S, steps, every = (TRAIN[k] for k in ("batch", "seq", "steps",
                                             "ckpt_every"))
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    argv = ["--arch", ARCH, "--batch", str(B), "--seq", str(S), "--steps",
            str(steps), "--data-order", str(TRAIN["data_order"]),
            "--lr", str(TRAIN["lr"]),
            "--ckpt-every", str(every), "--log-every", "5"]
    free_cuda()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = train.main(argv + ["--ckpt-dir", str(TRAIN_CKPT / "whole")])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, ms = run.losses, run.step_ms
    p50 = statistics.median(ms)
    tokens = B * S
    # tokens/s three ways: one p50 step; every token over all the steps'
    # time; the same without the first step (its compiles and allocations)
    rates = {"p50 step": tokens / (p50 / 1e3),
             "all steps": tokens * steps / (sum(ms) / 1e3),
             "steps 1-19": tokens * (steps - 1) / (sum(ms[1:]) / 1e3)}
    flops = 6 * cfg.param_count() * tokens
    peak_flops = machine().tensor_flops_per_s
    sizes = {k: sum(t.numel() * t.element_size()
                    for t in flatten(run.state[part]).values()) / 1e9
             for k, part in (("weights", "params"), ("optimizer", "opt"))}
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    say(f"  {ARCH} trained {steps} steps (train.main, {cfg.n_layers} layers "
        f"at d {cfg.d_model}, {cfg.param_count() / 1e6:.1f}M params, "
        f"{cfg.param_dtype}, remat full, B {B} x S {S} = {tokens} tokens a "
        f"step, lr {TRAIN['lr']}, {wall:.1f}s wall with the checkpoints)")
    say(f"  losses: {[round(x, 4) for x in losses]}; mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    say(f"  step ms p50 {p50:.1f}, last {ms[-1]:.1f}, first {ms[0]:.1f}, "
        f"sum {sum(ms):.1f}; tokens/s " + ", ".join(
            f"{r:.0f} ({k})" for k, r in rates.items())
        + f"; model FLOP 6 x {cfg.param_count() / 1e6:.1f}M x {tokens} = "
        f"{flops / 1e12:.2f} TFLOP a step; model FLOP/s and share of the "
        f"bf16 peak ({peak_flops / 1e12:.0f} TFLOP/s, {card_line()}): "
        + ", ".join(f"{r * 6 * cfg.param_count() / 1e12:.1f} TFLOP/s = "
                    f"{r * 6 * cfg.param_count() / peak_flops:.3f} ({k})"
                    for k, r in rates.items()))
    say(f"  weights {sizes['weights']:.2f} GB, optimizer state "
        f"{sizes['optimizer']:.2f} GB, max memory allocated "
        f"{peak / 1e9:.2f} GB; launches {launches} "
        f"({launches['flash_attention'] / steps:.0f} flash_attention a step,"
        f" {cfg.n_layers} layers)")
    require(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    require(last < first, f"train: loss did not fall ({first} -> {last})")
    require(launches["flash_attention"] == 2 * cfg.n_layers * steps,
            f"train: flash_attention launched {launches['flash_attention']}"
            f" times, expected {2 * cfg.n_layers * steps}")
    require(launches["flash_decode"] == 0, "train: flash_decode launched")
    del run
    free_cuda()
    # the same run in fp32: a wrong bf16 gradient (the unembed's, the
    # attention backward's in bf16) would part the curves by the fall
    t0 = time.perf_counter()
    ref32 = train.main(argv + ["--dtype", "float32"])
    fwall = time.perf_counter() - t0
    gap = max(abs(a - b) for a, b in zip(losses, ref32.losses))
    fall16 = first - last
    fall32 = (statistics.mean(ref32.losses[:5])
              - statistics.mean(ref32.losses[-5:]))
    say(f"  fp32 run ({fwall:.1f}s wall, step p50 "
        f"{statistics.median(ref32.step_ms):.1f} ms, max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB): losses "
        f"{[round(x, 4) for x in ref32.losses]}; bf16 against fp32: largest"
        f" gap {gap:.4f} (tol {TRAIN_FP32_TOL['gap']}), fall over the first"
        f" and last 5 {fall16:.4f} against {fall32:.4f} (apart at most "
        f"{TRAIN_FP32_TOL['fall']} of the fp32 fall)")
    require(gap <= TRAIN_FP32_TOL["gap"]
            and abs(fall16 - fall32) <= TRAIN_FP32_TOL["fall"] * fall32,
            "train: the bf16 curve parts from the fp32 curve")
    del ref32
    free_cuda()
    # resume: the step-10 checkpoint alone; as in the reference, it is
    # taken after step 10's update, so the resumed steps 10-18 retrace the
    # uninterrupted steps 11-19
    (TRAIN_CKPT / "resumed").mkdir(parents=True)
    shutil.copytree(TRAIN_CKPT / "whole" / f"step_{every}",
                    TRAIN_CKPT / "resumed" / f"step_{every}")
    t0 = time.perf_counter()
    rest = train.main(argv + ["--ckpt-dir", str(TRAIN_CKPT / "resumed"),
                              "--profile-step", str(steps - 1)])
    rwall = time.perf_counter() - t0
    got, want = rest.losses[:steps - every - 1], losses[every + 1:]
    err = max(abs(a - b) for a, b in zip(got, want))
    tol = 1e-3 * max(1.0, max(abs(x) for x in want))
    say(f"  resumed from step {rest.start_step} ({rwall:.1f}s wall): "
        f"losses {[round(x, 4) for x in rest.losses]}; against the "
        f"uninterrupted run's steps {every + 1}-{steps - 1}: max err "
        f"{err:.3g} (tol {tol:.3g}; the embedding's backward adds with "
        f"atomics, so not bit for bit), first step equal: "
        f"{got[0] == want[0]}")
    require(rest.start_step == every and err <= tol,
            "train: the resumed run disagrees with the uninterrupted one")
    train_profile(rest.profile, rest.step_ms[-1])
    del rest
    # phase 13 (d) restores the step-10 checkpoint onto a mesh
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    (DIST_DIR / "ckpt").mkdir(parents=True)
    shutil.move(TRAIN_CKPT / "whole" / f"step_{every}",
                DIST_DIR / "ckpt" / f"step_{every}")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    free_cuda()
    return launches


def train_profile(prof, wall_ms):
    """The ``torch.profiler`` window of one train step (the resumed run's
    last, ``--profile-step``; ``wall_ms`` its time under the profiler):
    device busy time, idle share, kernels, the top device items, and the
    share of the kernels' time in each range of the step (``forward``,
    ``backward`` and ``optimizer`` of ``train.loop``, and the
    ``flash_attention backward`` of ``kernels.library``, inside
    ``backward``). A kernel belongs to a range when the op that launched
    it (linked by the profiler's correlation id) started inside it on the
    host; nothing synchronises at the ranges' ends."""
    from torch.autograd import DeviceType
    events = prof.events()
    named = ("forward", "backward", "optimizer", "flash_attention backward")
    # the device's kernels, without the GPU copies of the named ranges
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in named
            and not getattr(e, "is_user_annotation", False)]
    if not kern:
        say("  train step: device time not measured (the profiler saw no "
            "CUDA kernels)")
        return

    def busy(spans):
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    all_busy = busy([(e.time_range.start, e.time_range.end) for e in kern])
    kern_us = sum(e.time_range.elapsed_us() for e in kern)
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.name in named and e.device_type == DeviceType.CPU]
    owned, linked = dict.fromkeys(named, 0.0), 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or e.name in named:
            continue
        us = sum(k.duration for k in e.kernels if k.name not in named)
        linked += us
        for name, a, b in ranges:
            if us and a <= e.time_range.start <= b:
                owned[name] += us
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    fa_fwd = sum(v for k, v in by_name.items() if "flash_attention" in k)
    say(f"  train step (torch.profiler, the step of train.loop): wall "
        f"{wall_ms:.1f} ms, device busy {all_busy / 1e3:.1f} ms, idle share "
        f"{1 - all_busy / 1e3 / wall_ms:.3f}, {len(kern)} kernels "
        f"({kern_us / 1e3:.1f} ms, {linked / 1e3:.1f} ms of it linked to "
        f"a launching op); share of the kernels' time: "
        + ", ".join(f"{k} {v / kern_us:.3f}" for k, v in owned.items())
        + f" (the attention backward, plain PyTorch, fp32, "
        f"{owned[named[3]] / 1e3:.1f} ms; the forward kernel, forward and "
        f"recompute, {fa_fwd / 1e3:.1f} ms = {fa_fwd / kern_us:.3f}); top: "
        + "; ".join(f"{kernel_label(k)} {v / 1e3:.2f} ms" for k, v in top))


def kernel_label(name: str) -> str:
    """A device kernel's name, short: a templated ATen kernel with the
    last functor (else kernel function) among its arguments, which names
    the op (``elementwise_kernel<MulFunctor>``)."""
    head = name.split("<")[0].replace("void ", "").split("::")[-1]
    inner = (re.findall(r"([A-Za-z_]+(?:Functor|_functor))\b", name)
             or re.findall(r"([A-Za-z_]+_kernel_cuda)\b", name))
    return f"{head}<{inner[-1]}>" if inner and "<" in name else name[:60]


def train_check_phase():
    """Phase 12 (b): qwen1.5-0.5b at its published width, 1 layer, fp32:
    ``Model.loss`` and every parameter's gradient through the kernel and
    its registered backward, against the same under ``plain_attention``
    (autograd through ``attention_ref``); then the registered backward
    alone against autograd through the plain version at phase 3's shapes
    where the forward is causal or Sq != Skv. Tolerances: 1e-4 x max(1,
    |loss|) on the loss, 1e-3 x a leaf's largest |grad| on each leaf."""
    import torch
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import build_model
    B, S, L = (TRAIN_CHECK[k] for k in ("batch", "seq", "layers"))
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=L,
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                              device="cuda") for k in ("tokens", "targets")}

    def run():
        loss, _ = model.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))

    ops.reset_launch_counts()
    loss_k, grads_k = run()
    launched = ops.launch_counts()["flash_attention"]
    with plain_attention():
        loss_p, grads_p = run()
    worst = max(((g - w).abs().max().item()
                 / max(w.abs().max().item(), 1e-30), k)
                for k, g, w in zip(leaves, grads_k, grads_p))
    lerr = abs(loss_k.item() - loss_p.item())
    ltol = 1e-4 * max(1.0, abs(loss_p.item()))
    say(f"  train fp32 {ARCH} {L} layer at width {cfg.d_model}, B {B} x S "
        f"{S}: loss {loss_k.item():.6f} vs plain {loss_p.item():.6f} (err "
        f"{lerr:.3g}, tol {ltol:.3g}); worst leaf grad err {worst[0]:.3g} of "
        f"its scale at {worst[1]} (tol 1e-3), {len(leaves)} leaves; "
        f"flash_attention launched {launched}")
    require(lerr <= ltol and worst[0] <= 1e-3 and launched == 2 * L,
            "train: the kernel path's loss or gradients disagree with the "
            "plain path")
    del model, params, leaves, grads_k, grads_p
    free_cuda()
    cases = [("serve", (1, 16, 16, 512, 64), {}, True),
             ("gqa", (4, 48, 4, 500, 128), {}, True),
             ("mla", (1, 128, 128, 512, 192), {"Dv": 128}, True),
             ("zamba2 D80", (1, 32, 32, 512, 80), {}, True),
             ("stablelm D160", (1, 32, 8, 512, 160), {}, True),
             ("whisper cross", (1, 20, 20, 64, 64), {"Skv": 1500}, False),
             ("whisper encoder", (1, 20, 20, 1500, 64), {}, False)]
    worst_all = 0.0
    for label, (Bq, H, KVH, Sq, D), extra, causal in cases:
        (q, k, v), _, _, _ = prefill_case(Bq, H, KVH, Sq, D, torch.float32,
                                          causal, gen, **extra)
        do = torch.randn(Bq, H, Sq, v.shape[-1], generator=gen,
                         device="cuda")
        grads = []
        for fn in (ops.flash_attention, ref.attention_ref):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            grads.append(torch.autograd.grad(fn(*ins, causal=causal), ins,
                                             do))
        errs = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for g, w in zip(*grads)]
        worst_all = max(worst_all, *errs)
        say(f"  flash_attention backward {label} B{Bq} H{H} KVH{KVH} Sq{Sq} "
            f"Skv{k.shape[2]} Dqk{D} Dv{v.shape[-1]} "
            f"{'causal' if causal else 'full'} fp32: dq/dk/dv err of scale "
            + "/".join(f"{e:.3g}" for e in errs) + " (tol 1e-3)")
        require(max(errs) <= 1e-3, f"flash_attention backward {label}: "
                "disagrees with autograd through the plain version")
    free_cuda()
    return worst, worst_all


def train_family_phase():
    """Phase 12 (c): one bf16 train step of each other family, at the
    depths of ``TRAIN_FAMILIES`` (published widths) or the reduced config,
    deepseek-v3's with its MTP head's loss added: the loss finite, every
    gradient leaf finite and nonzero somewhere (the reference's
    ``test_grad_flows_everywhere``; as there, a MoE router or shared
    expert may see no gradient in a small batch: at most 2 such leaves),
    then the AdamW update. Returns each arch's launches."""
    import torch
    from repro_torch.bridge import flatten, unflatten
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state)
    out = {}
    for arch, depth in TRAIN_FAMILIES.items():
        free_cuda()
        base = get_arch(arch)
        if depth is None:
            cfg = dataclasses.replace(base.reduced(), param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
            if cfg.mla is not None:
                # the reduced MLA head dims (q/k 24, v 16) are not the
                # kernel's: keep the published ones (q/k 192, v 128)
                cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
                    cfg.mla, nope_head_dim=base.mla.nope_head_dim,
                    rope_head_dim=base.mla.rope_head_dim,
                    v_head_dim=base.mla.v_head_dim))
        else:
            cfg = dataclasses.replace(base, n_layers=depth)
            if cfg.enc_dec is not None:
                cfg = dataclasses.replace(cfg, enc_dec=dataclasses.replace(
                    cfg.enc_dec, n_encoder_layers=depth))
        model = build_model(cfg, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = {"model": model.init(gen)}
        mtp = cfg.mla is not None
        if mtp:
            params["mtp"] = transformer.mtp_init(gen, cfg, "cuda")
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        B = TRAIN_STEP_BATCH["batch"]
        S = TRAIN_STEP_BATCH["transcript" if cfg.enc_dec else "seq"]
        batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                  device="cuda")
                 for k in ("tokens", "targets")}
        if cfg.enc_dec is not None:
            batch["frames"] = 0.1 * torch.randn(
                B, cfg.enc_dec.n_frames, cfg.d_model, generator=gen,
                device="cuda").to(torch.bfloat16)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(params["model"], batch)
        if mtp:
            loss = loss + transformer.mtp_loss(
                params["model"], params["mtp"], batch["tokens"],
                torch.roll(batch["tokens"], -2, dims=1), cfg)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        opt_cfg = OptConfig()
        new, _, stats = adamw_update(params, unflatten(grads),
                                     init_opt_state(params, opt_cfg), opt_cfg)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        bad = [k for k, g in grads.items()
               if not bool(torch.isfinite(g.float()).all())]
        dead = [k for k, g in grads.items() if float(g.abs().max()) == 0.0]
        moved = all(bool(torch.isfinite(t.float()).all())
                    for t in flatten(new).values())
        say(f"  train step {arch}: {cfg.n_layers} layers"
            + (f" + {cfg.enc_dec.n_encoder_layers} encoder" if cfg.enc_dec
               else "") + f" at d {cfg.d_model}"
            + (" (reduced" + (", MLA head dims published"
                              if cfg.mla else "") + ")"
               if depth is None else "")
            + f", {cfg.param_dtype}, B {B} x S {S}"
            + (" + MTP head" if mtp else "")
            + f": loss {loss.item():.4f}, grad norm "
            f"{float(stats['grad_norm']):.4g}, {len(grads)} leaves, "
            f"non-finite {bad}, without gradient {dead}, updated params "
            f"finite {moved}, {step_ms:.0f} ms (first call), launches "
            f"{launches}, max memory allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        allowed = 2 if cfg.moe is not None else 0
        require(math.isfinite(loss.item()) and not bad and moved
                and len(dead) <= allowed,
                f"train step {arch}: non-finite or missing gradients")
        attn = 0 if cfg.attention == "none" else 1
        require((launches["flash_attention"] > 0) == bool(attn),
                f"train step {arch}: flash_attention launches {launches}")
        out[arch] = launches
        del model, params, leaves, grads, new, loss, batch
    free_cuda()
    return out


def dist_phase():
    """Phase 13: distribution through NCCL on a world of one rank, the
    mesh (1, 1) ("data", "model"); (a)-(d) as the module docstring says.
    Returns the launches of the sharded steps, counted per step."""
    import shutil

    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_test_mesh
    torch.cuda.set_device(0)
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    rdv = DIST_DIR / "rendezvous"
    rdv.unlink(missing_ok=True)
    tdist.init_process_group("nccl", init_method=f"file://{rdv}",
                             world_size=1, rank=0)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        say(f"  NCCL world of {tdist.get_world_size()}, mesh "
            f"{mesh.shape} on {mesh.device} (torch.distributed "
            f"{tdist.get_backend()}, NCCL {torch.cuda.nccl.version()})")
        walls = {}
        t0 = time.perf_counter()
        launches, grads = dist_train_phase(mesh)
        walls["a"] = time.perf_counter() - t0
        dist_compressed_phase(mesh, grads)
        del grads
        free_cuda()
        walls["b"] = time.perf_counter() - t0 - sum(walls.values())
        dist_moe_phase(mesh)
        free_cuda()
        walls["c"] = time.perf_counter() - t0 - sum(walls.values())
        dist_restore_phase(mesh)
        walls["d"] = time.perf_counter() - t0 - sum(walls.values())
        free_cuda()
        whisper_launches = dist_whisper_phase(mesh)
        walls["e"] = time.perf_counter() - t0 - sum(walls.values())
        say("  phase 13 walls: " + ", ".join(f"({k}) {v:.1f}s"
                                             for k, v in walls.items()))
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    return {"dist": launches,
            f"dist {DIST_WHISPER['arch']}": whisper_launches}


def dist_whisper_phase(mesh):
    """Phase 13 (e): whisper-large-v3 whole in bf16 (``DIST_WHISPER``), one
    device's step and the FSDP step on the mesh from one state, 5 steps
    each in alternating turns: the losses and, after the steps, every
    parameter bit-equal (or within ``DIST["loss_rel"]`` relative). At a
    model axis of 1 the tensor-parallel plan is None, so this checks the
    wiring of whisper's sharded step (its per-layer gathers over the
    encoder's and decoder's stacks, the frames' rows) at full width, not
    its split. Returns the FSDP steps' launches."""
    import torch
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.context import make_dist
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        shard_train_state)
    from repro_torch.train.optimizer import OptConfig
    w = DIST_WHISPER
    cfg = get_arch(w["arch"])
    B, T, steps = w["batch"], w["tokens"], w["steps"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                        device="cuda"),
                "targets": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                         device="cuda"),
                "frames": (torch.randn(B, cfg.enc_dec.n_frames, cfg.d_model,
                                       generator=gen, device="cuda") * 0.5
                           ).to(torch.bfloat16)} for _ in range(steps)]
    opt = OptConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=steps)
    single = build_model(cfg, "cuda")
    state0 = init_train_state(single, gen, opt)
    model = build_model(cfg, "cuda", make_dist(mesh))
    shape = ShapeConfig("train", T, B, "train")
    runs = {"single": (make_train_step(single, opt),
                       clone_state(state0, grad=True)),
            "fsdp": (make_train_step(model, opt,
                                     batch_specs=model.batch_specs(shape)),
                     shard_train_state(state0, model, opt))}
    del state0
    free_cuda()
    losses = {n: [] for n in runs}
    ms = {n: [] for n in runs}
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for i in range(steps):
        for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            step, state = runs[name]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            losses[name].append(float(m["loss"]))
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "fsdp":
                for k, n in ops.launch_counts().items():
                    launches[k] += n
            runs[name] = (step, state)
    got, want = losses["fsdp"], losses["single"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    finite = all(math.isfinite(x) for x in got + want)
    a, b = (flatten(runs[n][1]["params"]) for n in ("fsdp", "single"))
    worst = max(float((a[k].detach() - v.detach()).abs().max())
                / max(float(v.detach().abs().max()), 1e-30)
                for k, v in b.items())
    layers = cfg.enc_dec.n_encoder_layers + 2 * cfg.n_layers
    say(f"  {w['arch']} whole ({cfg.enc_dec.n_encoder_layers} + "
        f"{cfg.n_layers} layers) in bf16, B {B} x {cfg.enc_dec.n_frames} "
        f"frames x {T} tokens, {steps} steps each in alternating turns "
        f"({card_line()}): single-device losses "
        f"{[round(x, 6) for x in want]}; FSDP {[round(x, 6) for x in got]},"
        f" bit-equal: {got == want} (largest relative difference "
        f"{rel:.3g}); parameters after {steps} steps: worst leaf "
        f"{worst:.3g} of its scale; step ms p50 single "
        f"{statistics.median(ms['single']):.1f}, FSDP "
        f"{statistics.median(ms['fsdp']):.1f}; FSDP launches {launches}")
    require(finite and rel <= DIST["loss_rel"]
            and worst <= DIST["loss_rel"],
            f"dist: whisper's FSDP step parts from one device's")
    # attention a layer (encoder: self; decoder: self and cross), forward
    # and remat's recompute
    require(launches["flash_attention"] == 2 * layers * steps,
            f"dist: whisper's FSDP steps launched flash_attention "
            f"{launches['flash_attention']} times")
    del runs, batches
    return launches


def clone_state(state, grad: bool):
    """A copy of a train state; its parameters require grad if ``grad``."""
    from repro_torch.bridge import flatten, unflatten
    out = {k: v.detach().clone() for k, v in flatten(state).items()}
    if grad:
        for k, v in out.items():
            if k.startswith("params/"):
                v.requires_grad_(True)
    return unflatten(out)


def collective_profile(prof):
    """(collective calls by name, device ms by device activity, device
    ms of kernels named for NCCL) in a profile: the process-group ops (``c10d::*``) that started inside a
    ``collectives`` range (``dist.collectives`` wraps each process-group
    call, and nothing else, in one) and the device work that any op
    inside such a range launched (NCCL's kernels, or its copies on a
    world of one rank)."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "collectives" and e.device_type == DeviceType.CPU]
    calls, device = {}, {}
    for e in events:
        if e.device_type != DeviceType.CPU or e.name == "collectives" or \
                not any(a <= e.time_range.start <= b for a, b in spans):
            continue
        if e.name.startswith("c10d::"):
            calls[e.name] = calls.get(e.name, 0) + 1
        for k in e.kernels:
            name = kernel_label(k.name)
            device[name] = device.get(name, 0.0) + k.duration / 1e3
    # NCCL's own kernels, wherever the profiler linked them
    nccl = sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA
               and "nccl" in e.name.lower()) / 1e3
    return calls, device, nccl


def dist_train_phase(mesh):
    """Phase 13 (a): qwen1.5-0.5b whole in bf16, the single-device step and
    the sharded step under FSDP and ZeRO-1 from one state, 5 steps each
    in alternating turns on phase 12's batches; the losses held equal.
    Returns (the sharded steps' launches, one step's fp32 gradients)."""
    import torch
    from repro_torch.bridge import flatten, unflatten
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.dist.context import make_dist
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        shard_train_state)
    from repro_torch.train.optimizer import OptConfig
    cfg = get_arch(ARCH)
    B, S, steps = TRAIN["batch"], TRAIN["seq"], DIST["steps"]
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                               seed=0, synthetic_order=TRAIN["data_order"]))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in pipe.next_batch().items()} for _ in range(steps)]
    opt = OptConfig(lr=TRAIN["lr"], warmup_steps=min(20, steps // 5),
                    total_steps=steps)
    single = build_model(cfg, "cuda")
    state0 = init_train_state(single, torch.Generator(
        device="cuda").manual_seed(0), opt)
    runs = {"single": (make_train_step(single, opt),
                       clone_state(state0, grad=True))}
    shape = ShapeConfig("train", S, B, "train")
    for name, kw in DIST["sharded"].items():
        model = build_model(cfg, "cuda", make_dist(mesh, **kw))
        runs[name] = (make_train_step(
            model, opt, batch_specs=model.batch_specs(shape)),
            shard_train_state(state0, model, opt))
    del state0
    free_cuda()
    losses = {n: [] for n in runs}
    ms = {n: [] for n in runs}
    peak = dict.fromkeys(runs, 0)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for i in range(steps):
        for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            step, state = runs[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            loss = float(m["loss"])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if name != "single":
                for k, n in ops.launch_counts().items():
                    launches[k] += n
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
            runs[name] = (step, state)
            losses[name].append(loss)
    want = losses["single"]
    say(f"  {ARCH} whole in bf16, B {B} x S {S}, {steps} steps each in "
        f"alternating turns ({card_line()}): single-device losses "
        f"{[round(x, 6) for x in want]}")
    differ = False
    for name in DIST["sharded"]:
        got = losses[name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        same = got == want
        differ |= not same
        say(f"  sharded step, {name}: losses {[round(x, 6) for x in got]};"
            f" bit-equal to the single device: {same}"
            + ("" if same else f", largest relative difference {rel:.3g} "
               f"(tol {DIST['loss_rel']})"))
        require(rel <= DIST["loss_rel"],
                f"dist: the {name} step's losses part from one device's")
    say("  step ms p50 (each step's ms): "
        + ", ".join(f"{n} {statistics.median(v):.1f} "
                    f"{[round(x, 1) for x in v]}" for n, v in ms.items())
        + "; peak memory allocated during a step (all the runs' states "
        "resident): " + ", ".join(f"{n} {v / 1e9:.2f} GB"
                                  for n, v in peak.items()))
    require(launches["flash_attention"] == len(DIST["sharded"]) * 2
            * cfg.n_layers * steps,
            f"dist: flash_attention launched {launches['flash_attention']}"
            f" times in the sharded steps")
    want = flatten(runs["single"][1]["params"])
    for name in DIST["sharded"]:
        got = flatten(runs[name][1]["params"])     # full on a world of one
        rels = {k: float((got[k] - w.detach()).abs().max())
                / max(float(w.abs().max()), 1e-30) for k, w in want.items()}
        parted = sorted((k for k, r in rels.items() if r), key=rels.get,
                        reverse=True)
        differ |= bool(parted)
        worst = max(rels.values())
        say(f"  {name}: parameters after {steps} steps bit-equal to the "
            f"single device's: {not parted} (worst leaf {worst:.3g} of "
            f"its scale)" + ("" if not parted else
                             f"; {len(parted)} of {len(rels)} leaves differ,"
                             f" most: " + ", ".join(f"{k} {rels[k]:.3g}"
                                                    for k in parted[:5])))
        require(worst <= DIST["loss_rel"],
                f"dist: the {name} step's parameters part from one device's")
    if differ:
        # the cause: does one device's step differ from itself?
        step, state = runs["single"]
        outs = [step(clone_state(state, grad=True), batches[0])
                for _ in range(2)]
        a, b = (flatten(o[0]["params"]) for o in outs)
        selfsame = float(outs[0][1]["loss"]) == float(outs[1][1]["loss"]) \
            and all(torch.equal(a[k], b[k]) for k in a)
        say("  the single-device step run twice from one state: "
            f"bit-equal to itself: {selfsame} ("
            + ("so the sharded step's difference is its own"
               if selfsame else "so one device's own run-to-run "
               "variation covers the difference") + ")")
        del outs, a, b
        free_cuda()
    for name in DIST["sharded"]:
        step, state = runs[name]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            state, _ = step(state, batches[0])
            torch.cuda.synchronize()
        calls, device, nccl = collective_profile(prof)
        say(f"  sharded step, {name}, under torch.profiler: "
            f"{sum(calls.values())} collectives a step {calls}, "
            f"{sum(device.values()):.3f} ms of device time launched by "
            f"them {{" + ", ".join(f"{k}: {v:.3f}" for k, v in
                                   device.items()) + f"}}, NCCL kernels "
            f"{nccl:.3f} ms")
        runs[name] = (step, state)
    # one step's fp32 gradients, for (b)
    step, state = runs["fsdp"]
    params = {k: v.detach().requires_grad_(True)
              for k, v in flatten(state["params"]).items()}
    loss, _ = single.loss(unflatten(params), batches[0])
    grads = [g.float() for g in torch.autograd.grad(loss,
                                                    list(params.values()))]
    del runs, params, loss
    free_cuda()
    return launches, grads


def dist_compressed_phase(mesh, grads):
    """Phase 13 (b): ``compressed_allreduce`` over every gradient leaf on
    NCCL: its device time over all leaves, its error against the exact
    mean (the gradient itself on a world of one) at most |v|max / 254 a
    leaf (and an fp32 ulp of |v|max for the products), and the residual
    fed into a second call making the two calls' sum nearer twice the
    gradient than twice one call's."""
    import torch
    from repro_torch.dist.collectives import compressed_allreduce
    group = mesh.group(("data", "model"))
    zeros = [torch.zeros_like(g) for g in grads]
    first = [compressed_allreduce(g, z, group) for g, z in zip(grads, zeros)]
    worst = 0.0
    for g, (m, _) in zip(grads, first):
        err = float((m - g).abs().max())
        amax = float(g.abs().max())
        bound = amax / 254
        worst = max(worst, err / bound if bound else 0.0)
        require(err <= bound + amax * 2 ** -23,
                f"dist: compressed_allreduce error {err} above {bound}")
    second = [compressed_allreduce(g, e, group)[0]
              for g, (_, e) in zip(grads, first)]
    fb = sum(float((m1 + m2 - 2 * g).square().sum())
             for g, (m1, _), m2 in zip(grads, first, second)) ** 0.5
    nofb = sum(float((2 * (m1 - g)).square().sum())
               for g, (m1, _) in zip(grads, first)) ** 0.5
    require(fb < nofb, "dist: error feedback did not shrink the error")
    n = sum(g.numel() for g in grads)
    t = device_ms([lambda: [compressed_allreduce(g, z, group)
                            for g, z in zip(grads, zeros)]], iters=5, reps=3)
    mach = machine()
    bound_ms = 16 * n / mach.hbm_bytes_per_s * 1e3
    say(f"  compressed_allreduce over {len(grads)} fp32 gradient leaves "
        f"({n / 1e6:.1f}M values, {4 * n / 1e9:.2f} GB): {t['ms']:.3f} ms "
        f"of device time (hidden {t['hidden']}); bound {bound_ms:.3f} ms "
        f"(bytes: x and the residual read, the mean and the new residual "
        f"written), {card_line()}; worst error {worst:.3f} of the half "
        f"step |v|max / 254; two calls' error with the residual fed back "
        f"{fb:.4g} against {nofb:.4g} without")


def dist_moe_phase(mesh):
    """Phase 13 (c): grok-1-314b's MoE FFN at full width through both
    sharded bodies against ``moe_local``, bf16 and then fp32 at a cut
    expert width; routing recorded, each path's device time."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist.context import make_dist
    from repro_torch.models import moe
    from repro_torch.models.layers import materialize
    dist = make_dist(mesh)
    base = get_arch(DIST["moe_arch"])
    for dname in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, param_dtype=dname,
                                  compute_dtype=dname,
                                  moe=dataclasses.replace(
                                      base.moe,
                                      capacity_factor=DIST["moe_cf"]))
        if dname == "float32":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, d_ff=DIST["moe_fp32_ff"]))
        gen = torch.Generator(device="cuda").manual_seed(0)
        dtype = getattr(torch, dname)
        p = materialize(moe.moe_init(cfg), gen, dtype, "cuda")
        x2 = (torch.randn(DIST["moe_tokens"], cfg.d_model, generator=gen,
                          device="cuda") * 0.5).to(dtype)
        lay = moe.expert_layout(cfg, 1)
        paths = {"moe_local": lambda: moe.moe_local(p, x2, cfg),
                 "a2a": lambda: moe._moe_a2a_body(p, x2, cfg, lay, dist),
                 "replicated": lambda: moe._moe_replicated_body(
                     p, x2, cfg, lay, dist)}
        out, routes = {}, {}
        for name, fn in paths.items():
            routes[name] = []
            with torch.no_grad(), recorded_routes(routes[name]):
                out[name] = fn()
        y0, aux0 = out["moe_local"]
        scale = float(y0.float().abs().max())
        tol = DIST["moe_tol"][dname]
        experts = sum(p[k].numel() * p[k].element_size()
                      for k in ("up", "gate", "down")) / 1e9
        line = []
        for name in ("a2a", "replicated"):
            y, aux = out[name]
            err = float((y.float() - y0.float()).abs().max())
            same = torch.equal(routes[name][0], routes["moe_local"][0])
            require(err <= tol * scale and same
                    and float(aux["drop_frac"]) == 0.0,
                    f"dist: {name} body disagrees with moe_local in {dname}"
                    f" (err {err}, scale {scale}, routing equal {same})")
            line.append(f"{name} max err {err:.3g} (tol {tol} x {scale:.3g}),"
                        f" routing equal {same}")
        require(float(aux0["drop_frac"]) == 0.0, "dist: moe_local dropped")
        times = ""
        if dname == "bfloat16":
            with torch.no_grad():
                t = {n: device_ms([fn], iters=5, reps=3)
                     for n, fn in paths.items()}
            times = "; device ms " + ", ".join(
                f"{n} {v['ms']:.3f}" for n, v in t.items()) + \
                f" ({card_line()})"
        say(f"  {cfg.name} MoE FFN, {dname}, d {cfg.d_model}, "
            f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, expert d_ff "
            f"{cfg.moe.d_ff} ({experts:.2f} GB of experts), "
            f"{DIST['moe_tokens']} tokens, capacity factor "
            f"{DIST['moe_cf']}, no drops: " + "; ".join(line) + times)
        del p, x2, out, paths
        free_cuda()


def dist_restore_phase(mesh):
    """Phase 13 (d): phase 12's step-10 checkpoint restored onto the mesh
    through ``elastic_restore`` (this rank's shards, on the card), then
    gathered: every leaf bit for bit the file's (as the checkpoint's own
    restore reads it, on the host)."""
    import torch
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_arch
    from repro_torch.dist.context import make_dist
    from repro_torch.models.api import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.train.loop import gather_train_state, train_state_specs
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    model = build_model(get_arch(ARCH), "cuda", make_dist(mesh))
    abstract = model.abstract_params()
    opt = OptConfig(lr=TRAIN["lr"])
    like = {"params": abstract, "opt": init_opt_state(abstract, opt)}
    t0 = time.perf_counter()
    state, meta = elastic_restore(CheckpointManager(DIST_DIR / "ckpt"),
                                  like, model.dist, train_state_specs(model))
    full = flatten(gather_train_state(state, model, opt))
    wall = time.perf_counter() - t0
    host, _ = CheckpointManager(DIST_DIR / "ckpt").restore(like)
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for k, h in flatten(host).items():
        t = full[k]
        require(t.dtype == h.dtype and t.shape == h.shape and torch.equal(
            t.view(bits[t.element_size()]),
            h.to(t.device).view(bits[t.element_size()])),
            f"dist: restored leaf {k} differs from the checkpoint")
    size = sum(t.numel() * t.element_size() for t in full.values()) / 1e9
    say(f"  elastic_restore of phase 12's step-{meta['step']} checkpoint "
        f"({len(full)} leaves, {size:.2f} GB) onto the (1, 1) NCCL mesh "
        f"and gathered back in {wall:.1f}s: every leaf bit for bit")


# ---------------------------------------------------------------- phase 14


def dryrun_children():
    """Phase 14 (a): ``DRYRUN_CELLS`` and ``launch.perf --cell
    DRYRUN_PERF``'s cells and variants, each in a child process (``python
    -m``, as a user runs them) writing its own results file; a child's
    non-zero exit, or a result not ``ok``, fails the phase. Prints
    each cell's roofline terms, bottleneck, mfu, per-rank arguments and
    temporaries, collectives and trace time."""
    import os
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    jobs = []
    for mesh, arch, shape in DRYRUN_CELLS:
        out = DRYRUN_DIR / f"dryrun-{mesh}-{arch}-{shape}.json"
        jobs.append((out, ["repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", shape, "--mesh", mesh, "--out",
                           str(out)]))
    for cell, variant in DRYRUN_PERF:
        out = DRYRUN_DIR / f"perf-{cell}-{variant}.json"
        jobs.append((out, ["repro_torch.launch.perf", "--cell", cell,
                           "--out", str(out)]
                     + (["--variant", variant] if variant else [])))
    t0 = time.perf_counter()
    procs = [(out, args, subprocess.Popen(
        [sys.executable, "-m", *args], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for out, args in jobs]
    results = {}
    try:
        for out, args, p in procs:
            log = p.communicate(timeout=DRYRUN_TIMEOUT)[0]
            require(p.returncode == 0, f"{' '.join(args)} exited "
                    f"{p.returncode}:\n{log[-3000:]}")
            results.update(json.loads(out.read_text()))
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for key, res in results.items():
        require(res["status"] == "ok", f"dry-run {key}: {res.get('error')}")
        r, mem, c = res["roofline"], res["memory"], res["collectives"]
        say(f"  {key}: compute {r['compute_s']:.4g} s, memory "
            f"{r['memory_s']:.4g} s (floor {r['memory_floor_s']:.4g} s), "
            f"collective {r['collective_s']:.4g} s -> {r['bottleneck']}, "
            f"step {r['step_s']:.4g} s, mfu {r['mfu']:.4g}; per rank: "
            f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, "
            f"{ {k: int(v) for k, v in c['coll_counts'].items()} }, wire "
            f"{c['total_wire'] / 1e9:.3f} GB {c['wire_by_link']}; "
            f"replicas {res['replicas']}, traced on {res['traced_on']} in "
            f"{res['trace_s']} s")
    for key, (temp, wire) in DRYRUN_BELOW.items():
        res = results[key]
        t = res["memory"]["temp_size_in_bytes"]
        c = res["collectives"]["total_wire"]
        say(f"  {key}: temporaries {t / 1e9:.3f} GB and wire "
            f"{c / 1e9:.3f} GB a step a rank, against {temp / 1e9:.1f} and "
            f"{wire / 1e9:.1f} GB with the cache relaid")
        require(t < temp and c < wire, f"dry-run {key}: not below the "
                f"relaid cache's {temp / 1e9:.1f} / {wire / 1e9:.1f} GB")
    return results, wall


def estimate_phase():
    """Phase 14 (b): qwen1.5-0.5b whole at world 1, on ``ESTIMATE``'s three
    paths (phase 12's train step, phase 4's prefill, one decode step). The
    dry-run's counter (``roofline.op_cost.CostCounter``) over a fake CUDA
    trace (``launch.dryrun.trace_cell``) and over the same call on the
    card, where the kernels launch: flops and bytes equal, and the traced
    arguments within 1% of what the card holds for the state before the
    call. Printed beside them: the traced temporaries against the card's
    peak above the arguments, and the roofline's step against the
    measured p50. Returns the card runs' launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.roofline import analysis as ra
    from repro_torch.roofline.op_cost import CostCounter
    from repro_torch.train.loop import (init_train_state, make_serve_steps,
                                        make_train_step)
    from repro_torch.train.optimizer import OptConfig
    cfg, opt = get_arch(ARCH), OptConfig(lr=TRAIN["lr"])
    wants = {"train": "flash_attention", "prefill": "flash_attention",
             "decode": "flash_decode"}
    launches = {name: 0 for name in KERNELS}
    for kind, (B, S) in ESTIMATE.items():
        shape = ShapeConfig(kind, S, B, kind)
        tr, meta = dryrun.trace_cell(cfg, shape, None, device="cuda",
                                     opt_cfg=opt)
        require(meta["traced_on"] == "cuda", "the trace is not CUDA's")
        free_cuda()
        base = torch.cuda.memory_allocated()
        model = build_model(cfg, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   dtype=v.dtype, device="cuda")
                  for k, v in model.input_specs(shape).items()}
        if kind == "decode":
            inputs["lengths"].fill_(S - 1)
        if kind == "train":
            box = [init_train_state(model, gen, opt)]
            step = make_train_step(model, opt)

            def call():
                box[0], _ = step(box[0], inputs)
        else:
            with torch.no_grad():
                params = model.init(gen)
                cache = model.init_cache(params, inputs, B, S)
            prefill, decode = make_serve_steps(model, cache)

            def call():
                if kind == "prefill":
                    return prefill(params, inputs, cache)
                return decode(params, cache, inputs["tokens"],
                              inputs["lengths"])
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        for _ in range(2):                   # allocations, kernel loads
            call()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with CostCounter() as cc:
            call()
        torch.cuda.synchronize()
        n = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - before
        times = []
        for _ in range(ESTIMATE_REPS[kind]):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(times)
        require(n[wants[kind]] > 0, f"{kind}: {wants[kind]} never launched")
        for name in launches:
            launches[name] += n[name]
        got, want = cc.totals, tr.totals
        for k in ("flops", "bytes"):
            a, b = getattr(got, k), getattr(want, k)
            require(abs(a - b) <= ESTIMATE_TOL["counts"] * b,
                    f"{kind}: the card's {k} {a} against the trace's {b}")
        args = meta["memory"]["argument_size_in_bytes"]
        require(abs(args - held) <= ESTIMATE_TOL["arguments"] * held,
                f"{kind}: traced arguments {args} against the card's {held}")
        rf = ra.summarize(ARCH, kind, "world1", 1, want,
                          ra.model_flops(cfg, shape),
                          ra.memory_floor_bytes(cfg, shape, 1, 1))
        say(f"  {kind} (B {B} x S {S}): flops {want.flops:.6g} and bytes "
            f"{want.bytes:.6g} on both (cast {want.cast_bytes:.4g}); "
            f"arguments traced {args / 1e9:.4f} GB, card {held / 1e9:.4f} "
            f"GB; temp traced {meta['memory']['temp_size_in_bytes'] / 1e9:.4f}"
            f" GB, card peak above them {peak / 1e9:.4f} GB; roofline step "
            f"{rf.step_s * 1e3:.4f} ms ({rf.bottleneck}; compute "
            f"{rf.compute_s * 1e3:.4f}, memory floor "
            f"{rf.memory_floor_s * 1e3:.4f}, traced bytes "
            f"{rf.memory_s * 1e3:.4f} ms), "
            f"measured p50 {p50:.3f} ms, ratio {p50 / (rf.step_s * 1e3):.2f}; "
            f"launches {n}; traced in {meta['trace_s']:.1f} s")
        del call, model, inputs
        if kind == "train":
            del box, step
        else:
            del params, cache, prefill, decode
    free_cuda()
    return launches


def dryrun_phase():
    """Phase 14: (a) the dry-run's cells in child processes, then (b) the
    estimate against the card. Returns (b)'s launches."""
    results, wall = dryrun_children()
    say(f"  phase 14 (a): {len(results)} results in {wall:.1f} s wall")
    return estimate_phase()


def lint_phase():
    """``repro_torch.analysis.lint``'s ``run_lint`` on the card, held to
    the committed baseline. Returns the run's launches and wall seconds."""
    from repro_torch.analysis import lint
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = lint.run_lint(device="cuda")
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(lint.render(result), flush=True)
    untagged = [f"{f['workload']}/{f['entrypoint']}"
                for f in result["findings"]
                if f["kind"] == "untagged-heavy-entrypoint"]
    say(f"  lint wall {wall:.1f}s, launches {launches}; "
        f"n_untagged {result['n_untagged']}: {untagged}")
    for name in KERNELS:
        require(launches[name] >= 1,
                f"{name} launched {launches[name]} times in the lint")
    committed = json.loads(lint.BASELINE_PATH.read_text())
    same = json.loads(json.dumps(result)) == committed
    say(f"  the findings equal the committed {lint.BASELINE_PATH.name}: "
        f"{same}")
    require(same, f"lint findings differ from {lint.BASELINE_PATH.name}")
    return launches, wall


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("[chip_smoke] FAIL: src/repro_torch not found; run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false; "
              "this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = card_line()
        say(f"phase 1 card: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")

        from repro_torch.kernels import build
        secs = build.build([*KERNELS, *OWN_KERNELS])
        say(f"phase 2 build: {len(KERNELS) + len(OWN_KERNELS)} kernels "
            f"with nvcc in "
            f"{secs:.1f}s ({' '.join(build.NVCC_FLAGS)})")
        say(f"  chacha20 SASS (one block a thread, fully unrolled): "
            f"{chacha20_sass()}")
        kernel_build_report()

        say("phase 3 kernels against their plain versions:")
        results = kernel_phase()
        seq_launches = seq_decode_check()
        results["mamba2_step"] = mamba2_checks()
        say("phase 3 kernels: all agree")

        say("phase 4 serving:")
        m, ex, launches = serve_phase()
        s = m.summary()
        say(f"phase 4 serving: {m.completed}/{SERVE['requests']} requests, "
            f"ttft p50/p99 {s['ttft_p50_ms']:.3f}/{s['ttft_p99_ms']:.3f} ms, "
            f"itl p50/p99 {s['itl_p50_ms']:.3f}/{s['itl_p99_ms']:.3f} ms, "
            f"launches {launches}, pool_busy {m.pool_busy}, "
            f"freq {{{', '.join(f'{k}: {v['avg_freq_ghz']:.3f} GHz' for k, v in m.pool_freq.items())}}}")
        say("phase 4 where a serving step's time goes (torch.profiler):")
        profile_phase(ex.model, ex.params)

        say("phase 5 end to end against the plain path:")
        end_to_end_phase()
        unembed_phase()

        say("phase 6 calibration on the card "
            "(repro_torch.analysis.calibrate):")
        calib_launches = calibration_phase()
        say("phase 6 calibration: all kernels launched and tagged")

        say("phase 7 cluster serving under the crash fault plan:")
        cluster_launches, cs, cluster_s = cluster_phase()
        say(f"phase 7 cluster: {cs['completed']}/{CLUSTER['requests']} "
            f"requests, ttft p50/p99 {cs['ttft_p50_ms']:.3f}/"
            f"{cs['ttft_p99_ms']:.3f} ms, itl p50/p99 "
            f"{cs['itl_p50_ms']:.3f}/{cs['itl_p99_ms']:.3f} ms, "
            f"{cluster_s:.1f}s wall")

        say("phase 8 the intermittency lint on the card "
            "(repro_torch.analysis.lint):")
        lint_launches, lint_s = lint_phase()
        say(f"phase 8 lint: all kernels launched, baseline equal, "
            f"{lint_s:.1f}s wall")

        say("phase 9 the moe family at full width (grok-1-314b, "
            "deepseek-v3-671b):")
        del m, ex                       # phase 4's served model
        from repro_torch.configs import get_arch
        t9 = time.perf_counter()
        moe_launches = full_width_phase(
            [(dataclasses.replace(get_arch(arch), n_layers=depth), MOE_SERVE,
              1) for arch, depth in MOE_DEPTH.items()])
        say(f"phase 9 moe: both archs served and checked, "
            f"{time.perf_counter() - t9:.1f}s wall")

        say("phase 10 zamba2-2.7b and stablelm-12b whole at full width:")
        t10 = time.perf_counter()
        wide_launches = full_width_phase(
            [(get_arch(arch), run, WIDE_E2E_DEPTH[arch])
             for arch, run in WIDE_SERVE.items()])
        say(f"phase 10 wide: both archs served and checked, "
            f"{time.perf_counter() - t10:.1f}s wall")

        say("phase 11 rwkv6-3b and whisper-large-v3 whole at full width:")
        t11 = time.perf_counter()
        rwkv_launches = rwkv_phase()
        whisper_launches = whisper_phase()
        say(f"phase 11: rwkv6-3b served and whisper-large-v3 run and "
            f"checked, {time.perf_counter() - t11:.1f}s wall")

        say("phase 12 training on the card (repro_torch.launch.train):")
        t12 = time.perf_counter()
        train_launches = train_phase()
        worst, worst_bwd = train_check_phase()
        family_launches = train_family_phase()
        say(f"phase 12 training: qwen1.5-0.5b trained, resumed and "
            f"profiled; kernel path equals the plain path (worst leaf "
            f"{worst[0]:.3g}, backward {worst_bwd:.3g}); "
            f"{len(family_launches)} families stepped, "
            f"{time.perf_counter() - t12:.1f}s wall")

        say("phase 13 distribution through NCCL (world of one rank, mesh "
            "(1, 1)):")
        free_cuda()
        t13 = time.perf_counter()
        dist_launches = dist_phase()
        say(f"phase 13 distribution: the sharded step equals one device's, "
            f"compressed_allreduce, both MoE bodies and the restore "
            f"checked, {time.perf_counter() - t13:.1f}s wall")

        say("phase 14 the dry-run (repro_torch.launch.dryrun, launch.perf) "
            "and its estimate against the card:")
        t14 = time.perf_counter()
        estimate_launches = dryrun_phase()
        say(f"phase 14 dry-run: every cell traced, the estimate's counts "
            f"equal the card's, {time.perf_counter() - t14:.1f}s wall")
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    line = []
    for name, meta in KERNELS.items():
        main_case = next(r for r in results[name]
                         if r["dtype"] in ("bfloat16", "uint32")
                         and "ms" in r)
        # each kernel's launches on its own path: serving for attention,
        # calibration for chacha20 (serving never runs it)
        path_launches = calib_launches if name == "chacha20" else launches
        line.append({
            "name": name, "route": "cuda", **meta,
            "launches": path_launches[name],
            "launches_by_path": {"serve": launches[name],
                                 "calibrate": calib_launches[name],
                                 "cluster": cluster_launches[name],
                                 "lint": lint_launches[name],
                                 **{f"serve {arch}": n[name] for arch, n
                                    in {**moe_launches,
                                        **wide_launches}.items()},
                                 "serve rwkv6-3b": rwkv_launches[name],
                                 "model api whisper-large-v3":
                                     whisper_launches[name],
                                 "train": train_launches[name],
                                 **{f"train {arch}": n[name] for arch, n
                                    in family_launches.items()},
                                 **{k: n[name] for k, n
                                    in dist_launches.items()},
                                 **{f"seq-parallel decode {c} (16 shards, "
                                    f"one process)": n[name] for c, n
                                    in seq_launches.items()},
                                 "estimate": estimate_launches[name]},
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            **({"ms_with_lse": main_case["lse_ms"]}
               if "lse_ms" in main_case else {}),
            "shape": main_case["shape"],
            "checks": results[name]})
    say(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
