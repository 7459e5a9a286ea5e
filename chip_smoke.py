"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line(s):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compile `src/repro_torch/csrc/*.cu` with nvcc for sm_90a, one
   nvcc per source, all at once;
3. kernels: the segment-sum kernel against its plain version and
   `np.add.at`, exactly, on float64 and int64 layouts (empty segments,
   one segment of millions of elements, p, p+1 and p^2+1 segments at
   p=1024, a random sorted layout from a fixed seed, segments of 31 to
   34 values around the kernel's short/long threshold);
4. partition path: `run_pipeline(..., backend="cuda")` on the
   n=3,000,000 power-law graph (5,528,199 edges) at p=1024 and p=64,
   held against the port's host engine `backend="fast"` (cut, replica
   CSR, core_of and core_times bit-identical; exec_time and
   data_comm_bytes to rtol 1e-12), with the kernel's launch count read
   around each run;
4b. trace path: the port's `synthesize_trace` writes the JAX package's
   headline ingest input (1,000,000 lines, seed 0), the default dispatch
   ingests it to exactly 1,148,081 vertices and 1,849,605 edges, the
   graph round-trips through `.rtb` array-equal, the scanner (forced on)
   and the streaming engine (forced off) give equal graphs on 100,000
   lines; then `run_pipeline(<.rtb path>, p, backend="cuda",
   profile=...)` at p=1024 and p=64, held against `fast` as in phase 4
   with the segment sum's launches counted around each run, the
   profile's phase table logged, and `python -m repro_torch.trace
   partition <.rtb> -p 64` in a subprocess, whose plan must have the
   in-process `est_exec_time`;
4c. dist path, on the host, at the JAX package's `dist_scaling` sizes:
   the host's core count and the pools' start method logged; a
   2,760,000-line seed-0 trace (~5.1M edges) parsed on one shard and
   cut on one worker (the two-phase wall; the cut equal to `vertex_cut(
   backend="fast")` bit for bit), parsed on 8 shards (the graph equal to
   the one-shard graph), then the pipelined parse→cut at W=4 and W=8 on
   the process and the thread pools with p=64 and merge_period=65,536
   (equal cuts; wall, speedup over W=1, replication factor, the `dist.*`
   histograms and span totals of a scoped collector), and `run_pipeline(<path>, backend="dist", workers=8)`
   (its cut equal to the two-phase cut of the 8-shard graph); on a
   276,000-line trace, W=4 on the thread and the process pools, twice
   each, with equal assignment, loads and replica CSR, and `python -m
   repro_torch.trace partition <trace> -p 64 --workers 4` in a
   subprocess, whose plan must have the in-process `est_exec_time`; no
   kernel is launched (the dist backend maps and simulates on the host);
4d. plan service on the card, on phase 4b's trace: `PlanService(backend=
   "cuda")` plans the `.rtb` (p=64, lam=1.1) cold, then as a memory hit,
   then as a disk hit in a new service on the same directory (the three
   bundles equal; the segment sum launched on the cold plan only), the
   cold bundle equal to a `backend="fast"` service's (cut, replica CSR,
   core_of and core_times bit for bit, the cost to rtol 1e-12); the
   incremental planner on the NDJSON, cold over the whole file and warm
   (90 % then 10 %), the two plans bit-identical to each other and to a
   `backend="fast"` planner's; the JAX package's Zipf request mix (8
   sources of 2,000 lines, 1,000 requests, exponent 1.2, 4 hot entries,
   p=16), hit rate at least 0.9 with evictions, `metrics()` agreeing
   with the request history; `python -m repro_torch.serve plan` in a
   subprocess, whose summary must be the cold plan's;
4e. expert placement on the card (PR 22): `expert_placement` at its
   default `backend="cuda"` on the JAX package's benchmark inputs
   (`synth_routing`, copied here: deepseek-v3's 256 experts, top-8, 16
   devices; dbrx's 16, top-4, 8), equal to `backend="fast"` field for
   field, bit for bit, with exactly 2 segment-sum launches each (the
   cut's finalize: loads and edge counts; `fast` makes none); its and
   `naive_expert_placement`'s load imbalance, all-to-all fraction and
   replication logged; `mesh_device_order` of a 16-shard comm matrix
   over a 4 x 4 mesh equal to the fast engine's;
5. model kernels: flash attention on the shapes of the JAX package's
   `FA_CASES` and a GQA group of 6 at head_dim 128 (B=2, S=77, 12 heads
   on 2), at the serving shape (B=2, S=3072, 16 heads, 1 kv head,
   head_dim 256, causal, window 2048) and at dbrx-132b's prefill shape
   (B=2, S=2048, 48 heads on 8, head_dim 128, causal; float32 and
   bfloat16), and at MLA's head dims, q/k 192 and v 128, with
   independent q, k and v (B=2, S=77, 8 heads on 8 kv heads causal and
   not causal, with a window of 32, and on 2 kv heads; deepseek-v3's
   prefill shape, B=2, S=2048, 128 heads, causal; each in float32 and
   bfloat16), and at every shape phases 10f-10h launch it at
   (seamless's encoder and cross attention B=2, S=2048, 16 heads of 64,
   no mask, and its decoder's self-attention there, causal; at B=4 the
   launcher's prompt of 32, causal, the encoder over 1,000 frames, the
   cross attention at Sq=32 and, in decode, Sq=1 by Sk=1000, no mask;
   qwen2-vl-2b's B=2, S=2048, 12 heads on 2 of 128, causal), then
   without a mask at Sq=2048 by Sk=1000 and ragged (Sq, Sk) of (24, 8),
   (1, 1), (100, 77) and (77, 300) with GQA groups of 1 and 2, each in
   float32 and bfloat16, against its plain version (float32 2e-5,
   bfloat16 2e-2); the RG-LRU scan at the
   serving shape (B=2, S=3072, D=4096) and on layouts that stress its ring (D of 33, 96 and
   4,096 by S of 1, 33 and 3,071; a view that is not 16-byte aligned; in
   bfloat16), with and without h0, h and h_last equal to the plain
   version's bit for bit in float32 and within 3e-2 in bfloat16, and at
   S=1 with x = 1 on every float a in [0, 1] (its gate, bit for bit);
6. prefill path: recurrentgemma-9b at full width and depth (9,396,195,328
   float32 parameters from a seeded generator) runs `make_prefill_step`
   on 2 prompts of 3,072 tokens, with the launch counts of both kernels
   read around the run (12 flash attention, 26 RG-LRU) and finite logits;
7. serving path: the port's launcher (`repro_torch.launch.serve.serve`)
   with the JAX launcher's defaults (batch 4, prompt 32, generate 32) at
   full width; its logits after replaying the prompt are held against
   `prefill` on the same prompts (1e-3);
8. RWKV6 kernel: the WKV scan against its plain version on the shapes
   of the JAX package's `test_rwkv6_kernel_vs_ref` (1e-5), at the
   prefill shape (B=2, S=4096, H=64, Dk=Dv=64) with and without s0, at
   the decode shape (B=4, S=1, with s0) and on layouts that stress its
   register tiles (Dk of 8, 40 and 64 by Dv of 20, 24 and 64, 33 steps,
   with s0; Dk 40 by Dv 24 in bfloat16, one step), all with out within
   1e-5·max(1, max|out|), and in bfloat16 (2e-2·max(1, max|out|));
   S_last exactly equal everywhere;
9. rwkv6-7b prefill path, after the recurrentgemma-9b model is freed: at
   full width and depth (7,534,415,872 float32 parameters from a seeded
   generator), `make_prefill_step` on 2 prompts of 4,096 tokens, exactly
   32 RWKV6 launches and none of the other kernels, finite logits;
10. rwkv6-7b serving path: the launcher at its defaults, exactly
   (32 + 32) x 32 = 2,048 RWKV6 launches (one per layer and decode step,
   with the cached state as s0), prefill vs prompt replay (1e-3);
10b. dbrx-132b prefill path (PR 22), after the earlier models are freed:
   full width cut to 4 layers (14,269,470,720 float32 parameters from a
   seeded generator), `make_prefill_step` on 2 prompts of 2,048 tokens at
   the config's capacity factor 1.25 (the MoE layer's expert products on
   cuBLAS), exactly 4 flash-attention launches and no other kernel,
   finite logits, a second run with the same bits (every prefill path is
   held to that), and a third under `torch.profiler` (device time by
   kernel, the flash-attention and GEMM shares, the idle share);
10c. dbrx-132b serving path: the launcher at its defaults on the same
   4-layer cut, dropless (capacity factor 16, as the JAX package's
   decode-vs-forward test for MoE); no launch in the launcher (decode
   computes attention inline), 4 in the comparison prefill; the replay
   within 1e-3 of the prefill, with the router's top-k margins and any
   token the two route differently logged;
10d. deepseek-v3-671b prefill path, after dbrx is freed: full
   width cut to 1 of its 61 layers and without the MTP head
   (13,360,651,264 float32 parameters from a seeded generator; MLA with
   q/k head dim 192 and v 128), `make_prefill_step` on 2 prompts of
   2,048 tokens at the config's capacity factor 1.25, exactly 1
   flash-attention launch (the kernel's (192, 128) instantiation) and no
   other kernel, finite logits, a second run with the same bits, a third
   under `torch.profiler`;
10e. deepseek-v3-671b serving path: the launcher at its defaults on the
   same cut, dropless (capacity factor n_experts / experts_per_token =
   32, the smallest that drops nothing); no launch in the launcher (the
   absorbed MLA decode computes attention inline), 1 in the comparison
   prefill; the replay within 1e-3 of the prefill, with the router's
   smallest top-k margin logged;
10f. seamless-m4t-large-v2 prefill path (PR 24), whole (24 encoder and
   24 decoder layers, 2,034,784,256 float32 parameters from a seeded
   generator): `make_prefill_step` on 2 prompts of 2,048 tokens with 2 x
   2,048 frame embeddings, exactly 72 flash-attention launches (24 in
   the encoder, 24 causal self-attentions, 24 cross attentions) and no
   other kernel, finite logits, a second run with the same bits, a
   third under `torch.profiler`; then without frames (the decoder
   alone): exactly 24;
10g. seamless-m4t-large-v2 serving path: the launcher at its defaults,
   decoder-only as the JAX launcher runs it (no launch in the launcher,
   24 in the comparison prefill; the replay within 1e-3); then the
   encoder-decoder decode: `prefill` on 4 prompts of 32 tokens with 1,000
   frames each (72 launches; the cache's `enc` the encoder's output),
   the prompts replayed and 32 greedy tokens through `decode_step`
   reading the cache's `enc`, exactly (32 + 32) x 24 = 1,536 launches
   (the cross attention at Sq = 1), the replay within 1e-3 of the
   prefill; the step's device time beside its bounds (the decoder's and
   the unembedding's weights read once, and the operations of the cross
   attentions' keys and values that every step recomputes from `enc`),
   and the recompute's own device time;
10h. qwen2-vl-2b prefill path with the vision frontend (PR 24), whole
   (1,543,656,960 float32 parameters): 2 prompts of 2,048 tokens whose
   first 256 embeddings are patch embeddings, with M-RoPE positions of a
   16 x 16 grid, exactly 28 flash-attention launches, finite logits, the
   same bits twice;
11. timing: each kernel and, where one exists, one PyTorch call
   computing the same function (timed only, as a yardstick) on the
   card's clock (CUDA events after a sleep that lets the host queue
   every call first), and its plain version on the host's clock, at the
   main paths' largest shapes, with RG-LRU also timed with h0 (`ms_h0`)
   and RWKV6 also at its decode shape with s0 (`ms_decode`, the launch
   the launcher makes 2,048 times; flash attention also at dbrx-132b's
   shape as `ms_dbrx`, at deepseek-v3's MLA prefill shape as `ms_mla`,
   and at seamless's encoder shape as `ms_seamless`, each beside its
   bound and SDPA's time, the four also in bf16 as `ms_bf16`,
   `ms_dbrx_bf16`, `ms_mla_bf16` and `ms_seamless_bf16`, and in float32
   at training path A's layer as `ms_path_a` and at seamless's decode
   cross attention (Sq = 1 by 1,000 keys) as `ms_decode`, each held
   against the plain version and beside its bound and SDPA's time on the
   same inputs); then one JSON
   line `{"kernels": [...]}` with all four kernels (flash attention's
   bound on the tensor cores, and on the CUDA cores as
   `bound_cuda_core_ms`; the dbrx and deepseek-v3 prefills' and the
   expert placements' launches as `launches_dbrx_prefill`,
   `launches_deepseek_prefill` and `launches_expert_placement`; the
   seamless prefill's with and without frames, its encoder-decoder
   decode's and the qwen2-vl-2b prefill's as
   `launches_seamless_prefill`, `launches_seamless_prefill_no_frames`,
   `launches_seamless_decode` and `launches_qwen2_vl_prefill`; the
   capture path's planning as `launches_capture_plan`), and the
   three
   backward kernels (flash attention's at path A's layer shape and, as
   `ms_path_b` beside its `bound_path_b_ms` and SDPA's backward
   `library_path_b_ms`, at path B's, with the 1.5 ms
   aim at path A stated as met or missed; its (192, 128) instantiation,
   row 2c, at path D's MLA layer as `ms_mla` beside `bound_mla_ms`,
   `plain_mla_ms` and SDPA's `library_mla_ms` (and in bf16 as
   `ms_mla_bf16`; each launch apart as `ms_mla_dkdv`, `ms_mla_dq` from
   path D's profile and `ms_mla_bf16_dkdv`, `ms_mla_bf16_dq` from a
   profiled call in a fresh process), and at path E's cross attention as
   `ms_seamless_cross` with its bound and SDPA's time; its launches in
   paths D and E as `launches_path_d` and `launches_path_e`; RG-LRU's
   at path B's layer
   shape, with the bound for the bytes its design moves beside the
   function's (`bound_design_ms`) and its 0.25 ms aim; RWKV6's at path
   C's layer shape, with the forward beside it with and without its
   checkpoint write, its scratch bytes and its 1.25 ms aim; the flash
   attention forward's and backward's launches in the captured train
   step as `launches_capture_step`, and in phase 18's step on a mesh as
   `launches_mesh_step`), and the fused AdamW (phase 13b: its device
   time at path A's leaves beside its bound on bytes, the tree path's
   and `torch.optim.AdamW(fused=True)`'s, its host cost `host_ms` and
   the leaf tables' `host_table_ms` with the 2 ms aim stated as met or
   missed, its updates a step of path A): eight entries; each bound from the function's
   work as `repro_torch.analysis.hlo_cost` (and, for the segment sum,
   `repro_torch.core.cuda.cost`) counts it, over the card's peaks;
12. backward kernels: flash attention's (`csrc/flash_attention_bwd.cu`)
   on `FA_CASES`, on every head dim and MLA's (192, 128) in float32 and
   bfloat16 over `FA_BWD_EDGES` (GQA groups of 1, 2, 3 and 16, lengths
   that are not a multiple of its tiles, last tiles of 2 and 3 rows, a
   window shorter than a tile, softcap with a static q_offset, Sq != Sk
   without a mask), at the two training paths' attention shapes (4 x
   2,048, 15 heads of 64 on 5, causal; 1 x 3,072, 16 heads of 256 on 1,
   window 2048) and at every shape paths D and E train it at
   (`FA_BWD_PATHS`: phase 5's MLA cases with deepseek-v3's [2, 2,048,
   128, 192/128]; seamless's encoder [2, 1,000, 16, 64] and cross
   attention [2, 2,048] by [2, 1,000] without a mask, its decoder's [2,
   2,048, 16 on 16, 64] causal), float32 and bfloat16, against the
   plain version's autograd in float64 on the card (5e-5 and 2e-2 of
   max(1, max|g|), dq, dk and dv each), two calls bit-identical and the
   forward's output unchanged by its log-sum-exp write; RG-LRU's
   (`csrc/rglru_bwd.cu`, time-parallel over chunks of 16 steps) at (1,
   3,072, 4,096) with and without
   h0 alike, at S one short of a chunk, one past it, three chunks and 5
   and 3,071 (a ragged last chunk, S shorter than a chunk), and at S = 1
   on every float a in [0, 1] (and outside it) equal to the float32
   autograd, NaN and infinities included;
12b. RWKV6 backward (`csrc/rwkv6_bwd.cu`, thread-block clusters over
   time chunks of a head): through `rwkv6_scan`'s
   autograd Function against the plain version's autograd in float64
   (5e-5 and 2e-2 of max(1, max|g|)) on the shapes of the JAX package's
   kernel test and on layouts with Dk of 8, 40 and 64 and Dv != Dk (33
   steps), at path C's layer shape (1 x 4,096, 64 heads of 64) in
   float32 and bfloat16 with and without s0 and dS_last, and at w = 0,
   w = 1 and log w down to -69; each twice, bit-identical, with out and
   S_last the same bits as a launch without the checkpoint write;
13. training path A: a train step through the kernels on a 4-layer
   full-width smollm-360m held against `impl="ref"` (loss and grad_norm
   to 1e-4 relative), then `make_train_step` on the whole model
   (361,821,120 float32 parameters, 8 x 2,048 tokens in 2 microbatches,
   AdamW with warm-up 2) for 8 steps: exactly 512 flash-attention
   forward and 512 backward launches, 8 fused AdamW updates and no other
   kernel, finite losses, the last below the first; step time, tokens/s
   and peak memory;
13b. the fused AdamW (`csrc/adamw.cu`) at path A's 290 full-width
   leaves against the tree path (`adamw._tree_update`) on the same card
   tensors, two steps: with the clip off, p, m, v and the rate bit for
   bit and grad_norm within 1e-6 relative; with the clip engaged, every
   leaf within 1e-6 of its largest value; one counted update a call;
   then its timing (the kernels line);
14. training path B: recurrentgemma-9b at full width, one pattern period
   (rec, rec, attn; 1,705,062,400 parameters), B = 1, S = 3,072, 3
   steps: per step exactly 1 flash-attention forward and backward, 2
   RG-LRU forward and backward launches and 1 fused AdamW update,
   finite losses;
16. training path C: rwkv6-7b at full width (d 4,096, 64 heads
   of 64, d_ff 14,336, vocab 65,536) cut to 4 layers (1,411,567,616
   float32 parameters: AdamW's state for all 32 does not fit one card),
   2 x 4,096 tokens in 2 microbatches, 3 steps: first a 2-layer step
   through the kernels held against `impl="chunked"` (what the JAX
   package trains with; loss and grad_norm to 1e-4 relative, and every
   gradient leaf of one microbatch to 1e-4 of max(1, max|g|)), then
   exactly 24 RWKV6 forward and 24 backward launches, 3 fused AdamW
   updates (1 in each check step) and no other kernel, finite losses; step time, tokens/s, peak memory and one step
   under `torch.profiler`;
15. the training CLI (`python -m repro_torch.launch.train`, reduced
   smollm-360m on the card) twice on one `--ckpt-dir`: the second run
   resumes from the first's checkpoint;
16d. path D, deepseek-v3-671b's MLA: on phase 10d's cut (full width, 1
   layer, no MTP head), `torch.autograd.grad` of `models.loss_fn` with
   respect to the layer's 8 MLA leaves only (187,107,328 parameters; no
   optimizer), sized first by the dry run (fake tensors, the kernels as
   regions); at B = 1, S = 2,048 through the kernels (exactly 1
   flash-attention and 1 backward launch, at (192, 128)) against
   impl="ref" on the same weights and batch (no launch): the loss and
   the MLA gradients' norm within 1e-4 relative, each leaf's scaled
   error logged, everything finite; then at B = 2 three calls (seconds,
   peak memory beside the dry run's) and one under `torch.profiler`
   (the flash-attention backward's share of the device time);
16e. path E, seamless-m4t-large-v2 whole (24 + 24 layers,
   2,034,784,256 parameters): the microbatch sized by the dry run; a
   train step of 2 encoder and 2 decoder layers at full width through
   the kernels against impl="ref" (loss and grad_norm to 1e-4 relative;
   impl="ref" still launches the kernel in the encoder, 2 + 2 a
   microbatch, as the JAX package's `_encode` takes no impl), then 2 x
   2,048 tokens with 2 x 1,000 frames in 2 microbatches for 3 AdamW
   steps: exactly (24 + 24 + 24) x 2 x 3 = 432 flash-attention forward
   and 432 backward launches, 3 fused AdamW updates (1 in each check
   step) and no other kernel, finite losses, the
   last below the first; step time, tokens/s, peak memory and one step
   under `torch.profiler`;
17. capture path (`repro_torch.core.op_graph`): (a) `python -m
   repro_torch.trace record` on the card for the three demo programs, one
   process each, all started together, each trace ingesting to the
   in-process capture's graph on the card and on the host, bit for bit
   with the labels; (b) a reduced recurrentgemma-9b forward through the
   flash-attention and RG-LRU kernels captured on the card and on the
   host, the two graphs bit-identical and its kernel vertices equal to
   the launches read around the call; (c) path A's full-width
   smollm-360m train step (8 x 2,048 tokens in 2 microbatches) captured
   on the card: its loss and every updated parameter bit-identical to an
   uncaptured step from the same seed, its `flash_attention` and
   `flash_attention_bwd` vertices equal to the launches (64 each), one
   `adamw` vertex for its one fused update, one
   `silu_backward` vertex a layer and microbatch (the backward's
   operators seen on autograd's device thread), its vertex and edge
   counts, ten most frequent labels and wall time captured against
   uncaptured logged; (d) `optimal_parallelism` over p in (2, 4, 8, 16,
   32) with `backend="cuda"` on that step: each report's cut and replica
   CSR bit-identical to `plan_graph(backend="fast")` on the same graph,
   exec_time and comm_bytes to rtol 1e-12, `run_pipeline` at each p equal
   to `fast` as in phase 4 (core_of included), the argmin picked,
   `plan_step(p=8)` equal to the p=8 report, the segment sum's launches
   and each plan's seconds logged;
18. mesh and cost (`repro_torch.parallel`, `.launch.{mesh,cells,dryrun}`,
   `.analysis`): (a) path A's step on a (1, 1) `DeviceMesh("cuda")`, every
   parameter a DTensor placed by `param_specs`, against the unsharded
   step from the same seed: the same 64 + 64 flash-attention launches
   (the unsharded step's one fused AdamW update the mesh's DTensors
   leave to the tree path), the loss and every parameter within 1e-4 (bit-identity logged), the
   placed arguments' bytes equal to the unsharded ones'; (b)
   `analyze_program` of one more step on the mesh: its mm FLOPs equal to
   `FlopCounterMode`'s, FLOPs and bytes by operator class beside the
   profiler's device time by class; (c) the dry run of the same step
   (fake tensors, a (1, 1) CPU mesh, the kernels as regions): its
   argument bytes equal to the card's params, moments, step and batch to
   the byte, its peak beside `max_memory_allocated` of the real step;
   (d) `repro_torch.launch.dryrun.run_cell` on the fake 16 x 16 mesh for
   `MESH_CELLS` (a dense, an MoE and a recurrent train cell at full
   width cut in depth, and a decode cell whole), one subprocess each,
   started at the phase's start; (e) `tools/capture_census.py`'s step
   captured on the card and on the host: the card's kernel vertices
   equal to its launches, the two graphs apart only by the
   flash-attention backward (`CENSUS_PLAIN_BWD` a call on the host, one
   `flash_attention_bwd` vertex on the card) and by AdamW (the tree
   path's operators on the host, `adamw_tree_labels`; one `adamw` vertex
   on the card; ROADMAP.md queue 3, item
   2).

The last line is `{"ok": true, "device": {...}}`.  Any failure raises
and the script exits non-zero before that line.  It imports nothing of
JAX and nothing of the JAX package; without a CUDA device, or outside a
checkout of the repository, it fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3; 34 TFLOP/s float64 and
# 67 TFLOP/s float32 outside the tensor cores; dense tensor cores 495
# TFLOP/s TF32 and 989 TFLOP/s bf16
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_OPS_PER_S = 34e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
PEAK_BF16_OPS_PER_S = 989e12

ARCH = "recurrentgemma-9b"
N_PARAMS = 9_396_195_328
RWKV_ARCH = "rwkv6-7b"
RWKV_N_PARAMS = 7_534_415_872
RWKV_LAYERS = 32
RWKV_PREFILL_B, RWKV_PREFILL_S = 2, 4096     # rwkv6-7b's train_4k context
# (B, S, H, Dk, Dv): the prefill and decode shapes of one rwkv6-7b layer,
# and tests/test_kernels.py::test_rwkv6_kernel_vs_ref's shapes
RWKV_MAIN = (RWKV_PREFILL_B, RWKV_PREFILL_S, 64, 64, 64)
RWKV_DECODE = (4, 1, 64, 64, 64)
RWKV_CASES = [(2, 32, 2, 16, 16), (1, 48, 4, 32, 32), (1, 16, 1, 8, 24)]
RWKV_BF16 = (2, 256, 64, 64, 64)
# layouts that stress the kernel's register tiles: Dk short of and at its
# 64 rows by Dv short of a block's 64 columns, over 33 steps (a ragged
# last round)
RWKV_STRESS = [(1, 33, 2, Dk, Dv) for Dk in (8, 40, 64)
               for Dv in (20, 24, 64)]
RWKV_TOL = 1e-5
RWKV_BF16_TOL = 2e-2
PREFILL_B, PREFILL_S = 2, 3072
# the serving shape of one attention layer and one recurrent layer
FA_MAIN = (PREFILL_B, PREFILL_S, PREFILL_S, 16, 1, 256, True, 2048, None,
           "float32")
RG_MAIN = (PREFILL_B, PREFILL_S, 4096)
# tests/test_kernels.py::FA_CASES, then dbrx-132b's GQA group of 6 at
# head_dim 128 on a short, ragged length:
# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype)
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 256, 8, 1, 64, True, 64, None, "float32"),
    (2, 64, 64, 4, 4, 128, True, None, 50.0, "float32"),
    (1, 100, 100, 2, 2, 64, False, None, None, "float32"),
    (1, 192, 320, 4, 2, 64, True, None, None, "float32"),
    (2, 128, 128, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 128, 128, 6, 3, 32, True, 32, 30.0, "float32"),
    (2, 77, 77, 12, 2, 128, True, None, None, "float32"),
]
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# RG-LRU: float32 is held bit for bit; bfloat16 to this
RG_BF16_TOL = 3e-2
# (B, S, D, dtype): the serving shape, then layouts that stress the ring:
# D ragged, 16-byte aligned but not a multiple of 32, and full; S of one
# step, shorter than a tile, one short of a tile multiple
RG_CASES = [RG_MAIN + ("float32",)] + [
    (2 if D == 4096 else 1, S, D, "float32") for D in (33, 96, 4096)
    for S in (1, 33, 3071)] + [
    (1, 33, 33, "bfloat16"), (2, 3071, 96, "bfloat16"),
    (2, 3072, 4096, "bfloat16")]
SERVE_TOL = 1e-3

# dbrx-132b (PR 22): full width (d 6,144, 48 heads of 128 on 8 kv heads,
# 16 experts of d_ff 10,752, top 4, vocab 100,352) cut to 4 layers: the
# 40 layers take 528 GB in float32, and 4 (57.08 GB) leave room for the
# prefill's activations on one 80 GB card.  The prefill runs at the
# config's capacity factor 1.25; the launcher dropless (capacity factor
# = the expert count), since the prompt replay routes each token as its
# own group and agrees with the prefill only when nothing is dropped.
DBRX_ARCH, DBRX_LAYERS, DBRX_PARAMS = "dbrx-132b", 4, 14_269_470_720
DBRX_PREFILL_B, DBRX_PREFILL_S = 2, 2048
FA_DBRX = (DBRX_PREFILL_B, DBRX_PREFILL_S, DBRX_PREFILL_S, 48, 8, 128, True,
           None, None, "float32")
# deepseek-v3-671b: full width (d 7,168, 128 heads; MLA with a q
# LoRA of rank 1,536, a kv latent of 512, q/k head dim 128 + 64 and v
# 128; 256 routed experts of d_ff 2,048, top 8, one shared; vocab
# 129,280) cut to 1 of its 61 layers and without the MTP head (which
# `forward`, `prefill` and `decode_step` never read): one MoE layer is
# 11.5 B parameters, 11.27 B of them the routed experts, so 1 layer with
# the embeddings is 53.44 GB and the head's block would add 46 GB.  The
# prefill runs at the config's capacity factor 1.25, the launcher
# dropless at n_experts / experts_per_token = 32: then C = S, and no
# expert can receive more than S tokens of a group (a token's k experts
# are distinct); `n_experts` would allocate 8x the buffers.
DSV3_ARCH, DSV3_LAYERS, DSV3_PARAMS = "deepseek-v3-671b", 1, 13_360_651_264
DSV3_PREFILL_B, DSV3_PREFILL_S = 2, 2048
# MLA's attention: q and k of head dim dn + dr = 192, v of 128.  A case's
# D is then the pair (Dqk, Dv).  Small cases (a GQA group of 4 catches a
# stride that mixes q's and k's heads with v's), then deepseek-v3's
# prefill shape
MLA_D = (192, 128)
FA_MLA = (DSV3_PREFILL_B, DSV3_PREFILL_S, DSV3_PREFILL_S, 128, 128, MLA_D,
          True, None, None, "float32")
FA_MLA_CASES = [
    (2, 77, 77, 8, Hkv, MLA_D, causal, window, None, dt)
    for dt in ("float32", "bfloat16")
    for Hkv, causal, window in ((8, True, None), (8, False, None),
                                (8, True, 32), (2, True, None))
] + [FA_MLA, FA_MLA[:9] + ("bfloat16",)]
# seamless-m4t-large-v2 (PR 24): whole, 24 encoder and 24 decoder layers
# (d 1,024, 16 heads of 64 on 16 kv heads, gated gelu MLP of d_ff 8,192,
# vocab 256,206, untied), 2,034,784,256 float32 parameters.  The prefill
# takes 2 prompts of 2,048 tokens with 2 x 2,048 frame embeddings (Se =
# S, the JAX package's convention, src/repro/launch/cells.py:112-114);
# the encoder-decoder decode 4 prompts of 32 tokens (the launcher's
# defaults) with 1,000 frames each, and 32 greedy tokens
SEAMLESS_ARCH, SEAMLESS_PARAMS = "seamless-m4t-large-v2", 2_034_784_256
SEAMLESS_B, SEAMLESS_S = 2, 2048
SEAMLESS_DEC_B, SEAMLESS_SE, SEAMLESS_PROMPT, SEAMLESS_GEN = 4, 1000, 32, 32
# qwen2-vl-2b whole with its vision frontend: 28 layers (d 1,536,
# 12 heads of 128 on 2 kv heads, M-RoPE), 1,543,656,960 float32
# parameters; 2 prompts of 2,048 tokens whose first 256 are patch
# embeddings (src/repro/launch/cells.py:107-111), on a 16 x 16 grid
QWEN_ARCH, QWEN_PARAMS = "qwen2-vl-2b", 1_543_656_960
QWEN_B, QWEN_S, QWEN_PATCHES = 2, 2048, 256
# the flash-attention kernel at every shape phases 10f-10h launch it at,
# each in float32 and bfloat16: (B, Sq, Sk, Hq, Hkv, D, causal)
FA_SEAMLESS = (SEAMLESS_B, SEAMLESS_S, SEAMLESS_S, 16, 16, 64, False, None,
               None, "float32")
FA_PATH_SHAPES = (
    # 10f: the encoder and the cross attention (Se = S), the decoder's
    # self-attention (with and without frames)
    FA_SEAMLESS[:7], (SEAMLESS_B, SEAMLESS_S, SEAMLESS_S, 16, 16, 64, True),
    # 10g: the launcher's comparison prefill and the encoder-decoder
    # prefill (encoder over Se frames, self-attention, cross attention)
    (SEAMLESS_DEC_B, SEAMLESS_PROMPT, SEAMLESS_PROMPT, 16, 16, 64, True),
    (SEAMLESS_DEC_B, SEAMLESS_SE, SEAMLESS_SE, 16, 16, 64, False),
    (SEAMLESS_DEC_B, SEAMLESS_PROMPT, SEAMLESS_SE, 16, 16, 64, False),
    # 10g: the cross attention of a decode step (Sq = 1)
    (SEAMLESS_DEC_B, 1, SEAMLESS_SE, 16, 16, 64, False),
    # 10h: qwen2-vl-2b's prefill
    (QWEN_B, QWEN_S, QWEN_S, 12, 2, 128, True),
)
# timed on the kernels line too: training path A's layer (smollm-360m, 15
# heads on 5 of 64, one microbatch of 4 x 2,048) and seamless's decode
# cross attention (one query against 1,000 frames, batch 4)
FA_PATH_A = (4, 2048, 2048, 15, 5, 64, True, None, None, "float32")
FA_DECODE = (SEAMLESS_DEC_B, 1, SEAMLESS_SE, 16, 16, 64, False, None, None,
             "float32")
# then a cross attention at Sq = 2,048 by Se = 1,000 and ragged Sq != Sk
# without a mask, GQA groups of 1 and 2
FA_PATH_CASES = [
    shape + (None, None, dt)
    for shape in FA_PATH_SHAPES
    + ((SEAMLESS_B, SEAMLESS_S, SEAMLESS_SE, 16, 16, 64, False),)
    + tuple((1, Sq, Sk, 4, Hkv, 64, False)
            for Sq, Sk in ((24, 8), (1, 1), (100, 77), (77, 300))
            for Hkv in (4, 2))
    for dt in ("float32", "bfloat16")]
# expert placement: benchmarks/expert_placement.py's two inputs,
# (label, experts, top k, devices)
EP_ROUTING = (("deepseek-v3", 256, 8, 16), ("dbrx", 16, 4, 8))
# the segment sums of one `vertex_cut(backend="cuda")` finalize: the
# per-cluster loads and edge counts (`keyed_sum` each)
EP_SEGSUM_LAUNCHES = 2

# training (PR 18).  Path A: smollm-360m whole (32 layers, d 960, 15
# heads of 64 on 5 kv heads, float32, tied embeddings), 8 sequences of
# 2,048 tokens (SmolLM's context) in 2 microbatches, 8 steps.  Path B:
# recurrentgemma-9b at full width cut to one pattern period (rec, rec,
# attn), B = 1, S = 3,072 (the 2,048 window bites), 3 steps.
TRAIN_A_ARCH, TRAIN_A_PARAMS = "smollm-360m", 361_821_120
TRAIN_A_B, TRAIN_A_S, TRAIN_A_MICRO, TRAIN_A_STEPS = 8, 2048, 2, 8
TRAIN_A_CHECK_LAYERS = 4        # the kernels-against-ref train step
TRAIN_B_ARCH, TRAIN_B_PARAMS = "recurrentgemma-9b", 1_705_062_400
TRAIN_B_LAYERS, TRAIN_B_B, TRAIN_B_S, TRAIN_B_STEPS = 3, 1, 3072, 3
TRAIN_LR, TRAIN_TOL = 1e-3, 1e-4
# the fused AdamW (csrc/adamw.cu) at path A's leaves: the tree path's
# bits with the clip off, this relative gap with it on (the norm's
# squares summed in another order), and the host's cost of an update
ADAMW_CLIP_TOL, ADAMW_HOST_AIM_MS = 1e-6, 2.0
# the backward kernels against their plain versions in float64 on the
# card: (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype) at the
# two paths' attention shapes, after FA_CASES
FA_BWD_A = (TRAIN_A_B // TRAIN_A_MICRO, TRAIN_A_S, TRAIN_A_S, 15, 5, 64,
            True, None, None, "float32")
FA_BWD_B = (TRAIN_B_B, TRAIN_B_S, TRAIN_B_S, 16, 1, 256, True, 2048, None,
            "float32")
RG_BWD = (TRAIN_B_B, TRAIN_B_S, 4096)
# the RG-LRU backward's aim at path B's layer shape, and the RWKV6
# backward's at path C's (ms, H100)
RG_BWD_AIM_MS = 0.25
RWKV_BWD_AIM_MS = 1.25
BWD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# the flash-attention backward on every head dim, both dtypes: (B, Sq, Sk,
# Hq, Hkv, causal, window, softcap, q_offset), as
# tests/test_torch_kernels.py::FA_BWD_EDGES
FA_BWD_EDGES = [
    (2, 77, 77, 2, 1, True, None, None, 0),
    (2, 20, 9, 2, 2, False, None, None, 0),
    (2, 100, 100, 4, 2, True, 7, None, 0),
    (2, 70, 130, 2, 1, True, 48, 30.0, 60),
    (2, 150, 150, 15, 5, True, None, None, 0),
    (2, 100, 100, 16, 1, True, 7, None, 0),
    (2, 66, 66, 4, 2, True, None, None, 0),
    (2, 131, 195, 2, 2, False, None, None, 0),
]
# the aim for the backward at path A's shape (ms, H100)
FA_BWD_AIM_MS = 1.5
# the backward at every shape paths D and E train it at, each in float32
# and bfloat16: MLA's (192, 128) cases of phase 5 with deepseek-v3's
# prefill shape, then seamless-m4t-large-v2's encoder over Se = 1,000
# frames and its cross attention (Sq = S by Se), no mask, and its
# decoder's self-attention, causal
FA_BWD_SEAMLESS_CROSS = (SEAMLESS_B, SEAMLESS_S, SEAMLESS_SE, 16, 16, 64,
                         False, None, None, "float32")
FA_BWD_PATHS = FA_MLA_CASES + [
    shape + (None, None, dt)
    for shape in ((SEAMLESS_B, SEAMLESS_SE, SEAMLESS_SE, 16, 16, 64, False),
                  FA_BWD_SEAMLESS_CROSS[:7],
                  (SEAMLESS_B, SEAMLESS_S, SEAMLESS_S, 16, 16, 64, True))
    for dt in ("float32", "bfloat16")]
# training path C: rwkv6-7b at full width (d 4,096, 64 heads of
# 64, d_ff 14,336, vocab 65,536, float32) cut to 4 layers, 2 sequences
# of 4,096 tokens (the JAX package's train_4k context) in 2
# microbatches, 3 steps; the check against impl="chunked" on 2 layers
TRAIN_C_ARCH, TRAIN_C_PARAMS = "rwkv6-7b", 1_411_567_616
TRAIN_C_LAYERS, TRAIN_C_B, TRAIN_C_S = 4, 2, 4096
TRAIN_C_MICRO, TRAIN_C_STEPS = 2, 3
# a fine-tuning rate: at d 4,096, AdamW's first sign-like step at paths A
# and B's 1e-3 moves every weight by ~6 % of its scale and raised the loss
# from 12.0 to 36.1
TRAIN_C_LR = 1e-5
TRAIN_C_CHECK_LAYERS, TRAIN_C_CHECK_PARAMS = 2, 974_221_312
# the RWKV6 backward kernel: (B, S, H, Dk, Dv) of one path-C layer and
# microbatch; layouts with Dk != Dv that stress its tiles (Dk of 8, 40
# and 64 rows, Dv short of a 32-column group, 33 steps: a ragged last
# checkpoint interval; Dv of ten groups, some ranks walking two; 300
# steps, three time chunks); the decay edges' shape
RWKV_BWD = (TRAIN_C_B // TRAIN_C_MICRO, TRAIN_C_S, 64, 64, 64)
RWKV_BWD_STRESS = [(1, 33, 2, 8, 20), (1, 33, 2, 40, 24), (1, 33, 2, 64, 20),
                   (1, 37, 2, 64, 300), (2, 300, 2, 64, 40)]
RWKV_BWD_EDGES = (1, 512, 8, 64, 64)

# path D: the gradient of deepseek-v3-671b's loss at full width, 1 layer,
# no MTP head (phase 10d's cut), with respect to its MLA leaves only (no
# optimizer: the MoE layer's 11.3 B parameters with AdamW's state would be
# 181 GB); held to impl="ref" at B = 1 (its [B, 128, S, S] float32 scores
# and their gradients take ~4.3 GB a copy at B = 2), timed at the
# prefill's B = 2
PATH_D_LEAVES = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b",
                 "wv_b", "wo")
PATH_D_PARAMS = 187_107_328
PATH_D_CHECK_B, PATH_D_B, PATH_D_S = 1, DSV3_PREFILL_B, DSV3_PREFILL_S
# path E: seamless-m4t-large-v2 whole, 2 x 2,048 tokens with 2 x 1,000
# frames (phase 10g's ~20 s of speech) in 2 microbatches, 3 AdamW steps;
# the check against impl="ref" on 2 encoder and 2 decoder layers
TRAIN_E_B, TRAIN_E_S, TRAIN_E_SE = 2, SEAMLESS_S, SEAMLESS_SE
TRAIN_E_MICRO, TRAIN_E_STEPS, TRAIN_E_CHECK_LAYERS = 2, 3, 2

# the capture path: the reduced recurrentgemma-9b forward's tokens (B, S)
# and optimal_parallelism's candidates, the JAX package's defaults
CAPTURE_MODEL_TOKENS = (2, 64)
CAPTURE_P = (2, 4, 8, 16, 32)
# phase 18: the dry run's cells on the fake 16x16 mesh, (arch, shape,
# depth or None for the whole model), one subprocess each, all started
# together; the train cells cut in depth (the plan is the cell's) to fit
# the phase's time, the decode cell whole
MESH_CELLS = (("smollm-360m", "train_4k", 2), ("dbrx-132b", "train_4k", 2),
              ("recurrentgemma-9b", "train_4k", 3),
              ("smollm-360m", "decode_32k", None))
MESH_CELLS_TIMEOUT = 240
# the operators a flash-attention call's plain backward adds to the
# captured census step on the host, where the card has one
# `flash_attention_bwd` vertex (its 8 operators and the 3 clones of its
# non-contiguous gradients; PERF.md, PR 26 (e))
CENSUS_PLAIN_BWD = {"bmm": 4, "_softmax_backward_data": 1,
                    "scalar_tensor": 1, "where": 1, "mul": 1, "clone": 3}

GRAPH_N, GRAPH_ALPHA, GRAPH_SEED = 3_000_000, 2.2, 0
P_MAIN = (1024, 64)
# the trace path: the JAX package's headline ingest size
# (benchmarks/trace_ingest.py) and the graph it ingests to
TRACE_LINES, TRACE_SEED = 1_000_000, 0
TRACE_VERTICES, TRACE_EDGES = 1_148_081, 1_849_605
TRACE_CHECK_LINES = 100_000     # scanner forced on vs the stream engine
# the dist path: the JAX package's benchmarks/dist_scaling.py sizes
DIST_BIG_LINES, DIST_LINES = 2_760_000, 276_000
DIST_P, DIST_MERGE_PERIOD = 64, 1 << 16
DIST_WORKERS = (4, 8)
# the plan service: the JAX package's benchmarks/plan_service.py knobs
SERVE_P, SERVE_LAM, SERVE_WARM = 64, 1.1, 0.9
ZIPF_SOURCES, ZIPF_LINES, ZIPF_REQUESTS = 8, 2_000, 1_000
ZIPF_EXPONENT, ZIPF_HOT, ZIPF_P, ZIPF_MIN_HIT_RATE = 1.2, 4, 16, 0.9


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------- #
# 1. device
# ---------------------------------------------------------------------- #
def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device: {name} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi.stdout.strip().splitlines()[0])
    return name


# ---------------------------------------------------------------------- #
# 2. build
# ---------------------------------------------------------------------- #
def phase_build() -> None:
    from repro_torch.core.cuda import _build
    t0 = time.perf_counter()
    path, report = _build.build_library()
    _build.load_library()
    log(f"build: {len(_build.sources())} CUDA source(s) -> "
        f"{os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            log(f"build: {line.strip()}")


# ---------------------------------------------------------------------- #
# 3. the kernel against its plain version
# ---------------------------------------------------------------------- #
def _layouts(rng: np.random.Generator):
    """(name, sorted ids, num_segments) at the main path's shapes."""
    m_edges = 5_528_199
    yield "empty-stream", np.zeros(0, np.int64), 1024
    yield ("mostly-empty-segments",
           np.sort(rng.integers(0, 1 << 20, 4096)), 1 << 20)
    yield "one-giant-segment", np.zeros(4_000_000, np.int64), 1
    for nseg in (1024, 1025):
        yield f"p={nseg}", np.sort(rng.integers(0, nseg, m_edges)), nseg
    yield ("p^2+1", np.sort(rng.integers(0, 1024 * 1024 + 1, 2_000_000)),
           1024 * 1024 + 1)
    # random runs, with empty segments and runs of every length
    nseg = 200_003
    lens = rng.geometric(0.02, size=nseg) * (rng.random(nseg) < 0.6)
    yield "random-runs", np.repeat(np.arange(nseg), lens), nseg
    # runs of 31..34 values, a short segment's most being 32
    lens = rng.integers(31, 35, 100_000) * (rng.random(100_000) < 0.9)
    yield "lengths-31-to-34", np.repeat(np.arange(100_000), lens), 100_000


def phase_kernel_vs_plain() -> float:
    from repro_torch.core.cuda import segsum
    rng = np.random.default_rng(11)
    worst = 0.0
    for name, ids, nseg in _layouts(rng):
        for dtype in (np.float64, np.int64):
            if dtype is np.float64:
                data = rng.integers(-50, 50, len(ids)) * np.pi
            else:
                data = rng.integers(-10**12, 10**12, len(ids))
            d = torch.from_numpy(data).cuda()
            i = torch.from_numpy(ids).cuda()
            got = segsum.segment_sum(d, i, nseg, validate=True)
            torch.cuda.synchronize()
            plain = segsum.segment_sum_plain(d, i, nseg)
            want = np.zeros(nseg, dtype)
            np.add.at(want, ids, data)
            check(got.dtype == d.dtype and got.shape == (nseg,),
                  f"{name}/{dtype.__name__}: dtype or shape")
            check(torch.equal(got, plain),
                  f"{name}/{dtype.__name__}: kernel != plain version")
            host = got.cpu().numpy()
            check(np.array_equal(host, want),
                  f"{name}/{dtype.__name__}: kernel != np.add.at")
            worst = max(worst, float((got - plain).abs().max())
                        if nseg else 0.0)
            log(f"kernel {name:22s} {dtype.__name__:8s} m={len(ids):>9d} "
                f"segments={nseg:>8d}: equal to plain and np.add.at")
    return worst


# ---------------------------------------------------------------------- #
# 4. the partition path
# ---------------------------------------------------------------------- #
CUT_FIELDS = ("assignment", "loads", "edge_counts", "replica_indptr",
              "replica_flat")


def _close(a: float, b: float) -> bool:
    """Within the reference's rtol 1e-12."""
    return np.isfinite(a) and abs(a - b) <= 1e-12 * abs(b)


def _compare(cuda, fast, p: int) -> None:
    (cp, cm, cr), (fp, fm, fr) = cuda, fast
    for field in CUT_FIELDS:
        a, b = getattr(cp, field), getattr(fp, field)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"p={p}: {field} differs from fast")
    check(np.array_equal(cm.core_of, fm.core_of), f"p={p}: core_of")
    check(np.array_equal(cr.core_times, fr.core_times),
          f"p={p}: core_times")
    for field in ("exec_time", "data_comm_bytes"):
        a, b = getattr(cr, field), getattr(fr, field)
        check(_close(a, b), f"p={p}: {field} {a!r} vs {b!r}")


def _timed_run(g, p: int, backend: str):
    """One `run_pipeline` on the card's default device: (result, wall
    seconds, {span name: seconds}) with the port's spans recorded (the
    collector keeps microseconds)."""
    from repro_torch import obs
    from repro_torch.core import run_pipeline
    torch.cuda.synchronize()
    with obs.scoped(merge=False) as col:
        t0 = time.perf_counter()
        out = run_pipeline(g, p, "wb_libra", backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages = {e["name"]: round(e["dur"] / 1e6, 6) for e in col.events
              if e["ph"] == "X" and e["name"].startswith(
                  ("pipeline.", "cut.", "map.", "sim."))}
    return out, wall, stages


def phase_main_path() -> dict:
    from repro_torch.core import resolve_backend, synthesize_powerlaw_graph
    from repro_torch.core.cuda import segsum
    engine = resolve_backend("fast")
    log(f"resolve_backend('fast') = {engine}")
    check(engine == "native", "the host stream must run on the C engine")
    t0 = time.perf_counter()
    g = synthesize_powerlaw_graph(n=GRAPH_N, alpha=GRAPH_ALPHA,
                                  seed=GRAPH_SEED)
    log(f"graph: n={g.n} edges={g.num_edges} "
        f"({time.perf_counter() - t0:.3f} s to build on the host)")
    check(g.num_edges == 5_528_199, "unexpected edge count")
    runs = {}
    for p in P_MAIN:
        # fast, cuda, cuda, fast: the first cuda run is the one whose
        # launches are counted and whose outputs are checked; the wall
        # times are the better of each pair
        fast, t_fast, fast_stages = _timed_run(g, p, "fast")
        segsum.launches = 0
        cuda, t_cuda, cuda_stages = _timed_run(g, p, "cuda")
        launches = segsum.launches
        _compare(cuda, fast, p)
        check(launches > 0, f"p={p}: the main path launched no kernel")
        t_cuda = min(t_cuda, _timed_run(g, p, "cuda")[1])
        t_fast = min(t_fast, _timed_run(g, p, "fast")[1])
        log(f"main path p={p}: segment_sum launches {launches}, exec_time "
            f"{cuda[2].exec_time!r}, data_comm_bytes "
            f"{cuda[2].data_comm_bytes!r}, replication_factor "
            f"{cuda[0].replication_factor!r}: bit-identical to fast")
        log(f"wall p={p} (host clock, better of two runs): cuda "
            f"{t_cuda:.6f} s, fast {t_fast:.6f} s")
        log(f"stages p={p} cuda (host clock, s): {json.dumps(cuda_stages)}")
        log(f"stages p={p} fast (host clock, s): {json.dumps(fast_stages)}")
        runs[p] = {"launches": launches, "part": cuda[0], "graph": g}
    return runs


# ---------------------------------------------------------------------- #
# 4b. the trace path: NDJSON file -> IRGraph -> .rtb -> plan on the card
# ---------------------------------------------------------------------- #
def _same_graph(a, b) -> bool:
    return (a.n == b.n and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("src", "dst", "w")))


def _ingest_timed(path: str, scanner: "str | None" = None):
    """`ingest_trace_with_stats(path)` under the scanner policy `scanner`
    (None: the default dispatch); (graph, stats, host seconds)."""
    from repro_torch.trace import SCANNER_ENV, ingest_trace_with_stats
    old = os.environ.pop(SCANNER_ENV, None)
    if scanner is not None:
        os.environ[SCANNER_ENV] = scanner
    try:
        t0 = time.perf_counter()
        g, st = ingest_trace_with_stats(path)
        return g, st, time.perf_counter() - t0
    finally:
        os.environ.pop(SCANNER_ENV, None)
        if old is not None:
            os.environ[SCANNER_ENV] = old


def phase_trace_path(tmp: str) -> dict:
    """The port's trace front end at the JAX package's headline ingest
    size, then the `cuda` plan of the ingested graph from its `.rtb`
    path, with the telemetry profile that `run_pipeline(profile=)`
    writes, and the `partition` CLI in a subprocess.  The trace and its
    `.rtb` stay in `tmp` for phase 4d."""
    from repro_torch.core import run_pipeline
    from repro_torch.obs.export import events_from_chrome, load_profile
    from repro_torch.obs.summarize import render_summary, summarize_events
    from repro_torch.trace import (read_trace_bin, synthesize_trace,
                                   write_trace_bin)
    out = {"launches": {}}
    ndjson = os.path.join(tmp, "synth.ndjson")
    t0 = time.perf_counter()
    lines = synthesize_trace(ndjson, TRACE_LINES, seed=TRACE_SEED)
    t_synth = time.perf_counter() - t0
    nbytes = os.path.getsize(ndjson)
    check(lines == TRACE_LINES, "synthesize_trace wrote too few lines")
    log(f"trace synth: {lines} lines, seed {TRACE_SEED}, {nbytes} "
        f"bytes in {t_synth:.3f} s (host clock)")
    g, st, t_ingest = _ingest_timed(ndjson)
    check(g.n == TRACE_VERTICES and g.num_edges == TRACE_EDGES,
          f"ingested {g.n} vertices and {g.num_edges} edges, expected "
          f"{TRACE_VERTICES} and {TRACE_EDGES}")
    log(f"trace ingest: engine {st.engine}, {g.n} vertices, "
        f"{g.num_edges} edges, {st.records} records in {t_ingest:.3f} s "
        f"({g.num_edges / t_ingest:.1f} edges/s, host clock)")
    rtb = os.path.join(tmp, "synth.rtb")
    t0 = time.perf_counter()
    write_trace_bin(rtb, g, st)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_bin, st_bin = read_trace_bin(rtb)
    t_read = time.perf_counter() - t0
    check(st_bin.engine == "binary" and _same_graph(g_bin, g),
          ".rtb round trip changed the graph")
    log(f"trace .rtb: {os.path.getsize(rtb)} bytes, write "
        f"{t_write:.3f} s, read {t_read:.3f} s "
        f"({g.num_edges / t_read:.1f} edges/s, {t_ingest / t_read:.1f}x "
        f"the NDJSON ingest; host clock): src, dst, w and n equal")
    small = os.path.join(tmp, "small.ndjson")
    synthesize_trace(small, TRACE_CHECK_LINES, seed=TRACE_SEED)
    g_scan, st_scan, t_scan = _ingest_timed(small, scanner="1")
    g_seq, st_seq, t_seq = _ingest_timed(small, scanner="0")
    check(st_scan.engine == "scan" and st_seq.engine == "stream",
          f"engines {st_scan.engine} and {st_seq.engine}")
    check(_same_graph(g_scan, g_seq),
          "the scanner and the streaming engine built different graphs")
    log(f"trace scanner vs stream, {TRACE_CHECK_LINES} lines: equal "
        f"graphs ({g_seq.num_edges} edges); scan {t_scan:.3f} s, "
        f"stream {t_seq:.3f} s (host clock)")
    del g_bin, g_scan, g_seq
    for p in P_MAIN:
        t0 = time.perf_counter()
        fast = run_pipeline(rtb, p, "wb_libra", backend="fast")
        t_fast = time.perf_counter() - t0
        prof = os.path.join(tmp, f"profile_p{p}.json")
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        cuda = run_pipeline(rtb, p, "wb_libra", backend="cuda",
                            profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        _compare(cuda, fast, p)
        check(launches["segment_sum"] > 0
              and launches == _expect(
                  segment_sum=launches["segment_sum"]),
              f"trace p={p}: launches {launches}")
        out["launches"][p] = launches["segment_sum"]
        out[p] = cuda[2].exec_time
        doc = load_profile(prof)
        events = events_from_chrome(doc)
        names = {e["name"] for e in events}
        want = {"pipeline.ingest", "trace.ingest", "pipeline.partition",
                "cut.stream", "cut.finalize", "map.cluster_graphs",
                "map.place", "sim.run"}
        check(want <= names, f"profile lacks {sorted(want - names)}")
        log(f"trace path p={p}: segment_sum launches "
            f"{launches['segment_sum']}, exec_time "
            f"{cuda[2].exec_time!r}, replication_factor "
            f"{cuda[0].replication_factor!r}: bit-identical to fast; "
            f"wall {wall:.6f} s, fast {t_fast:.6f} s (host clock, one "
            f"run each, .rtb read included)")
        summary = render_summary(summarize_events(events),
                                 doc.get("repro", {}).get("counters"))
        for line in summary.splitlines():
            log(f"trace profile p={p} | {line}")
    plan, t_cli = _port_cli("trace", "partition", rtb, "-p", "64")
    check(plan["est_exec_time"] == out[64],
          f"partition CLI est_exec_time {plan['est_exec_time']!r}, "
          f"in-process {out[64]!r}")
    log(f"trace CLI partition -p 64: exit 0 in {t_cli:.3f} s (host "
        f"clock, process start included), plan {json.dumps(plan)}")
    out["ndjson"], out["rtb"] = ndjson, rtb
    return out


def _port_cli(module: str, *args: str):
    """`python -m repro_torch.<module> *args` in a subprocess: (its JSON
    output, host seconds with the process start)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")))))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", f"repro_torch.{module}",
                          *args], capture_output=True, text=True,
                         timeout=600, env=env)
    t_cli = time.perf_counter() - t0
    check(cli.returncode == 0, f"{module} CLI {args[0]} exited "
          f"{cli.returncode}: {cli.stderr[-2000:]}")
    return json.loads(cli.stdout), t_cli


# ---------------------------------------------------------------------- #
# 4c. the dist path: sharded parse and cut on the host's cores
# ---------------------------------------------------------------------- #
def _same_cut(a, b) -> bool:
    return all(getattr(a, f).dtype == getattr(b, f).dtype
               and np.array_equal(getattr(a, f), getattr(b, f))
               for f in CUT_FIELDS)


def _span_totals(events) -> dict:
    """Host seconds and count of each span name in a collector's events;
    spans of parallel lanes add up, so a name's total can pass the
    wall."""
    out: dict = {}
    for e in events:
        if e.get("ph") == "X":
            t = out.setdefault(e["name"], [0.0, 0])
            t[0] += e["dur"] / 1e6
            t[1] += 1
    return {k: [round(v[0], 3), v[1]] for k, v in sorted(out.items())}


def _fork_warnings(rec) -> list:
    return sorted({re.sub(r" \(pid=\d+\)", "", str(w.message))
                   for w in rec if "fork" in str(w.message)})


def phase_dist_path(tmp: str) -> dict:
    """The sharded parser and the pipelined parse→cut of `repro_torch.
    dist` at the JAX package's `dist_scaling` sizes.  Everything runs on
    the host; the parent holds a CUDA context while its pools fork."""
    import multiprocessing as mp
    import warnings

    from repro_torch import obs
    from repro_torch.core import run_pipeline, vertex_cut
    from repro_torch.core.planner import plan_graph
    from repro_torch.dist import dist_ingest, dist_vertex_cut
    from repro_torch.trace import synthesize_trace
    cores = os.cpu_count()
    usable = (len(os.sched_getaffinity(0))
              if hasattr(os, "sched_getaffinity") else cores)
    method = "fork" if "fork" in mp.get_all_start_methods() else "default"
    log(f"dist host: os.cpu_count() {cores}, usable cores {usable}; pools "
        f"start processes with {method!r} (multiprocessing default "
        f"{mp.get_start_method()!r}); threads in this process "
        f"{__import__('threading').active_count()}, CUDA initialised "
        f"{torch.cuda.is_initialized()}")
    out = {"cores": cores}
    zero_launches()
    big = os.path.join(tmp, f"synth_{DIST_BIG_LINES}_seed0.ndjson")
    t0 = time.perf_counter()
    synthesize_trace(big, DIST_BIG_LINES, seed=0)
    log(f"dist synth: {DIST_BIG_LINES} lines, {os.path.getsize(big)} bytes "
        f"in {time.perf_counter() - t0:.3f} s (host clock)")
    kw = dict(method="wb_libra", merge_period=DIST_MERGE_PERIOD)
    # W=1: the two-phase wall the pipelined speedups are measured against
    t0 = time.perf_counter()
    g1 = dist_ingest(big, workers=1)
    t_ingest1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    cut1 = dist_vertex_cut(g1, DIST_P, workers=1, **kw)
    t_cut1 = time.perf_counter() - t0
    wall1 = t_ingest1 + t_cut1
    fast = vertex_cut(g1, DIST_P, method="wb_libra", backend="fast")
    check(_same_cut(cut1, fast), "dist W=1 differs from backend='fast'")
    log(f"dist W=1 two-phase: {g1.n} vertices, {g1.num_edges} edges; "
        f"ingest {t_ingest1:.3f} s + cut {t_cut1:.3f} s = {wall1:.3f} s "
        f"(host clock); replication_factor {cut1.replication_factor!r}; "
        f"cut bit-identical to vertex_cut(backend='fast')")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        g8 = dist_ingest(big, workers=8)
        t_ingest8 = time.perf_counter() - t0
        check(_same_graph(g8, g1), "dist_ingest W=8 differs from W=1")
        log(f"dist ingest W=8: {t_ingest8:.3f} s ({t_ingest1 / t_ingest8:.2f}"
            f"x W=1; host clock), graph array-equal to W=1")
        piped = {}
        for w, pool in [(w, pool) for w in DIST_WORKERS
                        for pool in ("process", "thread")]:
            tl: dict = {}
            with obs.scoped(merge=False) as col:
                t0 = time.perf_counter()
                cut = dist_vertex_cut(big, DIST_P, workers=w, pool=pool,
                                      timeline=tl, **kw)
                wall = time.perf_counter() - t0
            check(tl["mode"] == "pipelined" and tl["pool"] == pool,
                  f"W={w}: mode {tl['mode']}, pool {tl['pool']}")
            if (w, "process") in piped:
                check(_same_cut(cut, piped[w, "process"]),
                      f"W={w}: the thread pool's cut differs from the "
                      f"process pool's")
            piped[w, pool] = cut
            check(len(cut.assignment) == g1.num_edges
                  and int(cut.assignment.min()) >= 0
                  and int(cut.assignment.max()) < DIST_P,
                  f"W={w}: not a {DIST_P}-way cut of every edge")
            names = {e["name"] for e in col.events}
            check({"dist.parse_wait", "dist.cut", "parse.shard"} <= names,
                  f"W={w} did not pipeline: {sorted(names)}")
            hists = {k: {"count": h["count"], "p50": h["p50"]}
                     for k, h in sorted(col.metrics.snapshot()[
                         "histograms"].items()) if k.startswith("dist.")}
            out[w, pool] = {"wall": wall, "rf": cut.replication_factor}
            log(f"dist W={w} pipelined ({pool} pool): wall {wall:.3f} s, "
                f"speedup {wall1 / wall:.3f}x over W=1, replication_factor "
                f"{cut.replication_factor!r} ({cut.replication_factor / cut1.replication_factor:.4f}"
                f"x W=1), full merges {tl['full_merges']} of "
                f"{tl['round_merges']}, rounds {len(tl['rounds'])}")
            log(f"dist W={w} {pool} histograms (count, p50 us): "
                f"{json.dumps(hists)}")
            log(f"dist W={w} {pool} spans (host s summed over lanes, count): "
                f"{json.dumps(_span_totals(col.events))}")
        del piped
        t0 = time.perf_counter()
        part, mapping, rep = run_pipeline(big, DIST_P, "wb_libra",
                                          backend="dist", workers=8,
                                          merge_period=DIST_MERGE_PERIOD)
        t_run = time.perf_counter() - t0
        two_phase = dist_vertex_cut(g8, DIST_P, workers=8, **kw)
        check(_same_cut(part, two_phase),
              "run_pipeline(backend='dist') differs from the two-phase cut")
        check(np.isfinite(rep.exec_time) and rep.exec_time > 0,
              "run_pipeline(backend='dist') gave no cost")
        log(f"dist run_pipeline(<path>, backend='dist', workers=8): "
            f"{t_run:.3f} s (host clock), exec_time {rep.exec_time!r}, "
            f"replication_factor {part.replication_factor!r}; cut equal to "
            f"the two-phase W=8 cut of the 8-shard graph")
        del g1, g8, cut1, fast, part, two_phase
        small = os.path.join(tmp, f"synth_{DIST_LINES}_seed0.ndjson")
        synthesize_trace(small, DIST_LINES, seed=0)
        cuts = {}
        for pool in ("thread", "process"):
            for run in (1, 2):
                t0 = time.perf_counter()
                cuts[pool, run] = dist_vertex_cut(small, DIST_P, workers=4,
                                                  pool=pool, **kw)
                log(f"dist {DIST_LINES} lines W=4 {pool} pool run {run}: "
                    f"{time.perf_counter() - t0:.3f} s (host clock)")
        first = cuts["thread", 1]
        check(all(_same_cut(c, first) for c in cuts.values()),
              "W=4 differs across pool kinds or runs")
        log(f"dist {DIST_LINES} lines W=4: {len(first.assignment)} edges, "
            f"assignment, loads and replica CSR equal on the thread and "
            f"process pools and across two runs each")
        plan = plan_graph(small, DIST_P, backend="dist", workers=4)
    log(f"dist fork warnings: {_fork_warnings(rec) or 'none'}")
    got, t_cli = _port_cli("trace", "partition", small, "-p", str(DIST_P),
                           "--workers", "4")
    check(got["est_exec_time"] == plan.exec_time,
          f"partition --workers 4 est_exec_time {got['est_exec_time']!r}, "
          f"in-process {plan.exec_time!r}")
    log(f"dist CLI partition -p {DIST_P} --workers 4: exit 0 in "
        f"{t_cli:.3f} s (host clock, process start included), plan "
        f"{json.dumps(got)}")
    launches = read_launches()
    check(launches == _expect(), f"the dist path launched {launches}")
    log("dist path: no kernel launched (it maps and simulates on the host)")
    os.remove(big)
    return out


# ---------------------------------------------------------------------- #
# 4d. the plan service and the incremental planner on the card
# ---------------------------------------------------------------------- #
def _same_bundle(a, b) -> bool:
    return all(np.asarray(getattr(a, f)).dtype
               == np.asarray(getattr(b, f)).dtype
               and np.array_equal(getattr(a, f), getattr(b, f))
               for f in CUT_FIELDS + ("core_of", "core_times")) and all(
        getattr(a, f) == getattr(b, f)
        for f in ("exec_time", "comm_bytes", "graph_name", "n_vertices",
                  "total_weight", "p", "method", "lam"))


def _same_plan(a, b) -> bool:
    """Two incremental plans: the cut, core_of, core_times and exec_time
    bit for bit (exec_time is the largest core time plus the sync term),
    the comm bytes to rtol 1e-12 (a device sum may reassociate them)."""
    (_, ca, ma, ra), (_, cb, mb, rb) = a, b
    return (_same_cut(ca, cb) and np.array_equal(ma.core_of, mb.core_of)
            and np.array_equal(ra.core_times, rb.core_times)
            and ra.exec_time == rb.exec_time
            and _close(ra.data_comm_bytes, rb.data_comm_bytes))


def _incremental(windows, backend: str, warm_windows: int = 0):
    """Feed `windows` to a fresh planner, planning after the first
    `warm_windows` (the warm state); (plan, seconds of the appends and
    the plan after the warm state, segment-sum launches of that plan)."""
    from repro_torch.serve import IncrementalPlanner
    pl = IncrementalPlanner(p=SERVE_P, lam=SERVE_LAM, backend=backend)
    for window in windows[:warm_windows]:
        pl.append(window)
    if warm_windows:
        pl.plan()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for window in windows[warm_windows:]:
        pl.append(window)
    zero_launches()
    plan = pl.plan()
    torch.cuda.synchronize()
    return plan, time.perf_counter() - t0, read_launches()


def phase_plan_service(tmp: str, trace: dict) -> dict:
    """`PlanService` on the card over phase 4b's trace: cold, memory and
    disk tiers; the incremental planner cold and warm; the Zipf mix."""
    import io

    from repro_torch.serve import PlanRequest, PlanService
    from repro_torch.trace import synthesize_trace
    out = {}
    req = PlanRequest(trace["rtb"], p=SERVE_P, lam=SERVE_LAM)
    cache = os.path.join(tmp, "plans_cuda")
    svc = PlanService(cache_dir=cache, backend="cuda")
    responses, times = {}, {}
    from repro_torch import obs
    for tier, service in (("cold", svc), ("memory", svc),
                          ("disk", PlanService(cache_dir=cache))):
        torch.cuda.synchronize()
        zero_launches()
        with obs.scoped(merge=False) as col:
            t0 = time.perf_counter()
            responses[tier] = service.plan(req)
            torch.cuda.synchronize()
            times[tier] = time.perf_counter() - t0
        log(f"serve {tier} spans (host s, count): "
            f"{json.dumps(_span_totals(col.events))}")
        launches = read_launches()
        check(responses[tier].cache == tier,
              f"expected a {tier} plan, got {responses[tier].cache}")
        if tier == "cold":
            out["launches_serve"] = launches["segment_sum"]
            check(launches == _expect(segment_sum=out["launches_serve"])
                  and out["launches_serve"] > 0,
                  f"the cold plan launched {launches}")
        else:
            check(launches == _expect(), f"the {tier} hit launched "
                  f"{launches}")
    cold = responses["cold"]
    check(all(_same_bundle(r.bundle, cold.bundle)
              for r in responses.values()),
          "the memory or disk bundle differs from the cold bundle")
    t0 = time.perf_counter()
    fast = PlanService(cache_dir=os.path.join(tmp, "plans_fast"),
                       backend="fast").plan(req)
    t_fast = time.perf_counter() - t0
    b, f = cold.bundle, fast.bundle
    check(fast.fingerprint == cold.fingerprint, "fingerprints differ")
    check(all(np.array_equal(getattr(b, k), getattr(f, k))
              for k in CUT_FIELDS + ("core_of", "core_times")),
          "the cuda service's cold bundle differs from fast's")
    check(_close(b.exec_time, f.exec_time)
          and _close(b.comm_bytes, f.comm_bytes),
          f"cost {b.exec_time!r}/{b.comm_bytes!r} vs fast "
          f"{f.exec_time!r}/{f.comm_bytes!r}")
    log(f"serve PlanService(backend='cuda') p={SERVE_P} lam={SERVE_LAM}: "
        f"cold {times['cold']:.6f} s (segment_sum launches "
        f"{out['launches_serve']}), memory {times['memory']:.6f} s, disk "
        f"{times['disk']:.6f} s (0 launches each; host clock); bundles "
        f"equal; cold {cold.summary()}")
    log(f"serve fast service cold {t_fast:.6f} s: bundle equal to the cuda "
        f"one (cut, core_of, core_times bit for bit; exec_time "
        f"{'equal' if b.exec_time == f.exec_time else 'within 1e-12'})")
    with open(trace["ndjson"]) as fh:
        text = fh.readlines()
    cut_at = int(len(text) * SERVE_WARM)
    head, tail = "".join(text[:cut_at]), "".join(text[cut_at:])
    del text
    cold_plan, t_cold, l_cold = _incremental([io.StringIO(head + tail)],
                                             "cuda")
    warm_plan, t_warm, l_warm = _incremental(
        [io.StringIO(head), io.StringIO(tail)], "cuda", warm_windows=1)
    fast_plan, t_ifast, l_fast = _incremental([io.StringIO(head + tail)],
                                              "fast")
    del head, tail
    check(l_cold["segment_sum"] > 0 and l_warm["segment_sum"] > 0,
          f"the incremental plans launched {l_cold} and {l_warm}")
    check(l_fast == _expect(), f"the fast planner launched {l_fast}")
    check(_same_plan(warm_plan, cold_plan) and warm_plan[3].data_comm_bytes
          == cold_plan[3].data_comm_bytes,
          "the warm incremental plan differs from the cold one")
    check(_same_plan(cold_plan, fast_plan),
          "the cuda incremental plan differs from fast's")
    exact = cold_plan[3].data_comm_bytes == fast_plan[3].data_comm_bytes
    out["launches_incremental"] = l_cold["segment_sum"]
    log(f"serve IncrementalPlanner p={SERVE_P}: cold (whole file) "
        f"{t_cold:.3f} s, warm (last {1 - SERVE_WARM:.0%} after "
        f"{SERVE_WARM:.0%}) {t_warm:.3f} s, speedup {t_cold / t_warm:.3f}x, "
        f"fast cold {t_ifast:.3f} s (host clock, parse included); "
        f"segment_sum launches {l_cold['segment_sum']} a plan; warm == cold "
        f"== fast (cut, core_of, core_times, exec_time bit for bit; comm "
        f"bytes {'equal' if exact else 'within 1e-12'}); exec_time "
        f"{cold_plan[3].exec_time!r}, replication_factor "
        f"{cold_plan[1].replication_factor!r}")
    paths = []
    for i in range(ZIPF_SOURCES):
        path = os.path.join(tmp, f"zipf_{i}.ndjson")
        synthesize_trace(path, ZIPF_LINES, seed=100 + i)
        paths.append(path)
    pop = 1.0 / np.arange(1, ZIPF_SOURCES + 1) ** ZIPF_EXPONENT
    picks = np.random.default_rng(0).choice(
        ZIPF_SOURCES, size=ZIPF_REQUESTS, p=pop / pop.sum())
    zipf = PlanService(cache_dir=os.path.join(tmp, "plans_zipf"),
                       max_hot_entries=ZIPF_HOT)
    zero_launches()
    t0 = time.perf_counter()
    tiers = [zipf.plan(PlanRequest(paths[i], p=ZIPF_P,
                                   lam=SERVE_LAM)).cache for i in picks]
    torch.cuda.synchronize()
    t_zipf = time.perf_counter() - t0
    launches = read_launches()
    m = zipf.metrics()
    hits = sum(t != "cold" for t in tiers)
    check(m["plans"] == ZIPF_REQUESTS and m["hits"] == hits
          and m["misses"] == ZIPF_REQUESTS - hits
          and m["hit_rate"] == round(hits / ZIPF_REQUESTS, 4)
          and all(m["tiers"].get(t, {}).get("count", 0) == tiers.count(t)
                  for t in ("cold", "memory", "disk"))
          and m["evictions"] == zipf.cache.evictions,
          f"metrics() disagree with the history: {m}")
    check(m["hit_rate"] >= ZIPF_MIN_HIT_RATE and m["evictions"] > 0,
          f"Zipf hit rate {m['hit_rate']}, evictions {m['evictions']}")
    check(launches["segment_sum"] > 0
          and launches == _expect(segment_sum=launches["segment_sum"]),
          f"the Zipf mix launched {launches}")
    log(f"serve Zipf mix: {ZIPF_REQUESTS} requests over {ZIPF_SOURCES} "
        f"sources ({ZIPF_LINES} lines, p={ZIPF_P}, {ZIPF_HOT} hot entries) "
        f"in {t_zipf:.3f} s (host clock): {json.dumps({t: tiers.count(t) for t in ('cold', 'memory', 'disk')})}, "
        f"hit_rate {m['hit_rate']}, evictions {m['evictions']}, "
        f"plans_per_s {m['plans_per_s']}, p50 {m['plan_latency_p50_us']} us, "
        f"p99 {m['plan_latency_p99_us']} us, segment_sum launches "
        f"{launches['segment_sum']}")
    got, t_cli = _port_cli("serve", "--cache-dir",
                           os.path.join(tmp, "plans_cli"), "plan",
                           trace["rtb"], "-p", str(SERVE_P), "--lam",
                           str(SERVE_LAM))
    check(got == json.loads(json.dumps(cold.summary(), default=float)),
          f"serve CLI plan {got} differs from {cold.summary()}")
    log(f"serve CLI plan: exit 0 in {t_cli:.3f} s (host clock, process "
        f"start included), the cold plan's summary")
    return out


# ---------------------------------------------------------------------- #
# 4e. expert placement on the card
# ---------------------------------------------------------------------- #
def synth_routing(n_experts: int, zipf_a: float = 1.2, seed: int = 0,
                  k: int = 8, n_tokens: int = 100_000):
    """Zipf expert popularity + correlated co-activation counts: a copy
    of `benchmarks/expert_placement.py::synth_routing` (this script
    imports neither `benchmarks` nor the JAX package), held equal to it
    by tests/test_torch_moe.py."""
    rng = np.random.default_rng(seed)
    pop = (np.arange(1, n_experts + 1, dtype=np.float64) ** -zipf_a)
    pop = pop[rng.permutation(n_experts)]
    pop /= pop.sum()
    load = pop * n_tokens * k
    co = np.zeros((n_experts, n_experts))
    draws = rng.choice(n_experts, size=(n_tokens // 50, k), p=pop)
    for row in draws:
        for i in range(k):
            for j in range(i + 1, k):
                co[row[i], row[j]] += 1
                co[row[j], row[i]] += 1
    return load, co


def _placement_fields(ep) -> tuple:
    return (ep.n_experts, ep.n_devices, ep.device_experts,
            ep.expert_devices, ep.device_load.dtype,
            ep.device_load.tobytes(), ep.replication_factor,
            ep.all_to_all_fraction)


def phase_expert_placement() -> dict:
    """`expert_placement` at its default `backend="cuda"` (its cut's
    finalize on the card) on the JAX package's benchmark inputs, equal to
    `backend="fast"` field for field, bit for bit, with the segment sum's
    launches counted around each; `mesh_device_order` of a 16-shard comm
    matrix over a 4 x 4 mesh equal to the fast engine's."""
    from repro_torch.core.planner import (expert_placement,
                                          mesh_device_order,
                                          naive_expert_placement)
    launches = {}
    for label, E, k, n_dev in EP_ROUTING:
        load, co = synth_routing(E, k=k)
        zero_launches()
        want = expert_placement(load, co, n_devices=n_dev, backend="fast")
        check(read_launches() == _expect(),
              f"expert placement {label}: the fast backend launched")
        zero_launches()
        t0 = time.perf_counter()
        got = expert_placement(load, co, n_devices=n_dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[label] = read_launches()
        check(launches[label] == _expect(segment_sum=EP_SEGSUM_LAUNCHES),
              f"expert placement {label}: launches {launches[label]}, "
              f"expected {EP_SEGSUM_LAUNCHES} segment sums")
        check(_placement_fields(got) == _placement_fields(want),
              f"expert placement {label}: the card's differs from fast's")
        naive = naive_expert_placement(load, n_dev)
        log(f"expert placement {label} (E={E}, top-{k}, {n_dev} devices) "
            f"on the card in {secs:.6f} s, equal to fast bit for bit, "
            f"{EP_SEGSUM_LAUNCHES} segment-sum launches: vertex cut "
            f"{json.dumps(got.summary())}; contiguous "
            f"{json.dumps(naive.summary())}")
    rng = np.random.default_rng(0)
    comm = rng.random((16, 16))
    comm = comm + comm.T
    got = mesh_device_order(comm, 4, 4, backend="cuda")
    want = mesh_device_order(comm, 4, 4, backend="fast")
    check(got.dtype == want.dtype and np.array_equal(got, want),
          "mesh_device_order: cuda differs from fast")
    log(f"mesh_device_order, 16 shards on a 4 x 4 mesh: {got.tolist()} "
        f"(equal to fast)")
    return {label: n["segment_sum"] for label, n in launches.items()}


# ---------------------------------------------------------------------- #
# 5. the model kernels against their plain versions
# ---------------------------------------------------------------------- #
def _head_dims(D) -> tuple[int, int]:
    """(Dqk, Dv) of a case's D: an int, or MLA's pair."""
    return D if isinstance(D, tuple) else (D, D)


def _fa_inputs(case, seed: int = 0):
    """Independent normal q, k and v of a case."""
    B, Sq, Sk, Hq, Hkv, D, _, _, _, dt = case
    Dqk, Dv = _head_dims(D)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dt)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, Hq, Dqk), (B, Sk, Hkv, Dqk),
                               (B, Sk, Hkv, Dv)))


def _rg_inputs(B: int, S: int, D: int, seed: int = 0,
               dtype=torch.float32, offset: int = 0):
    """x normal, a uniform(0.05, 0.99) (the JAX package's test draws), h0
    normal; x and a start `offset` elements into their storage."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = B * S * D
    x = torch.randn(n + offset, generator=g, device="cuda")
    a = torch.rand(n + offset, generator=g, device="cuda") * 0.94 + 0.05
    h0 = torch.randn((B, D), generator=g, device="cuda")
    return (x.to(dtype)[offset:].view(B, S, D),
            a.to(dtype)[offset:].view(B, S, D), h0)


def _rg_check(x, a, h0, what: str) -> float:
    """The RG-LRU kernel against its plain version: bit for bit in
    float32, within RG_BF16_TOL in bfloat16; returns the largest error."""
    from repro_torch.kernels import rglru
    h, last = rglru.rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    want_h, want_last = rglru.rglru_plain(x, a, h0)
    check(h.dtype == x.dtype and h.shape == x.shape
          and last.dtype == x.dtype, f"rglru {what}: dtype or shape")
    err = max(float((h.float() - want_h.float()).abs().max()),
              float((last.float() - want_last.float()).abs().max()))
    if x.dtype == torch.float32:
        check(torch.equal(h, want_h) and torch.equal(last, want_last),
              f"rglru {what}: not bit for bit the plain version ({err!r})")
    else:
        check(err <= RG_BF16_TOL, f"rglru {what}: error {err!r}")
    return err


def phase_model_kernels_vs_plain() -> dict:
    from repro_torch.kernels import flash_attention as fa
    worst = {}
    for case in FA_CASES + [FA_MAIN, FA_DBRX, FA_DBRX[:9] + ("bfloat16",)] \
            + FA_MLA_CASES + FA_PATH_CASES:
        if case is FA_MLA_CASES[0]:
            t_mla = time.perf_counter()
        if case is FA_PATH_CASES[0]:
            t_nc = time.perf_counter()
        causal, window, cap, dt = case[6:]
        q, k, v = _fa_inputs(case)
        # the default scale, Dqk ** -0.5, is MLA's (dn + dr) ** -0.5
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, softcap=cap)
        check(got.dtype == q.dtype and got.shape == q.shape[:3]
              + v.shape[3:], f"flash attention {case}: dtype or shape")
        err = float((got.float() - want.float()).abs().max())
        check(err <= FA_TOL[dt], f"flash attention {case}: error {err!r}")
        if case is FA_MAIN:
            worst["flash_attention"] = err
        if case is FA_DBRX:
            worst["flash_attention_dbrx"] = err
        if case is FA_MLA:
            worst["flash_attention_mla"] = err
        if case == FA_SEAMLESS:
            worst["flash_attention_seamless"] = err
        log(f"kernel flash_attention {case}: max abs error {err!r} "
            f"(tolerance {FA_TOL[dt]})")
        del q, k, v, got, want
    log(f"phase seconds: 5's MLA cases {t_nc - t_mla:.1f}, its seamless "
        f"and qwen2-vl cases {time.perf_counter() - t_nc:.1f}")
    for B, S, D, dt in RG_CASES:
        for offset in ((0, 1) if (B, S, D) == RG_MAIN else (0,)):
            x, a, h0 = _rg_inputs(B, S, D, dtype=getattr(torch, dt),
                                  offset=offset)
            for init in (None, h0):
                what = (f"B={B} S={S} D={D} {dt} h0="
                        f"{'given' if init is not None else 'none'}"
                        f"{' one element into its storage' if offset else ''}")
                err = _rg_check(x, a, init, what)
                if (B, S, D, dt) == RG_MAIN + ("float32",):
                    worst["rglru"] = max(worst.get("rglru", 0.0), err)
                log(f"kernel rglru {what}: "
                    + ("h and h_last equal to the plain version"
                       if dt == "float32" else
                       f"max abs error {err!r} (tolerance {RG_BF16_TOL})"))
            del x, a, h0
    # the gate of every float a in [0, 1] (and -0.5, 1.5, 2): S = 1, x = 1
    a = torch.arange(0, 0x3F800001, dtype=torch.int32, device="cuda")
    a = torch.cat([a.view(torch.float32), torch.tensor(
        [-0.5, 1.5, 2.0], device="cuda")]).view(1, 1, -1)
    _rg_check(torch.ones_like(a), a, None, "every a in [0, 1]")
    log(f"kernel rglru gate of every float a in [0, 1] ({a.numel()} "
        f"values): equal to the plain version")
    del a
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------- #
# 6/9. the prefill path at full width
# ---------------------------------------------------------------------- #
def _counted():
    """Every kernel's launch counter, by kernel name: (its wrapper's
    module, the counter's name there)."""
    from repro_torch.core.cuda import segsum
    from repro_torch.kernels import flash_attention, rglru, rwkv6
    from repro_torch.optim import adamw_cuda
    return {"segment_sum": (segsum, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "launches_bwd"),
            "rglru": (rglru, "launches"),
            "rglru_bwd": (rglru, "launches_bwd"),
            "rwkv6": (rwkv6, "launches"),
            "rwkv6_bwd": (rwkv6, "launches_bwd"),
            "adamw": (adamw_cuda, "launches")}


def zero_launches() -> None:
    for module, attr in _counted().values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in _counted().items()}


def _expect(**counts) -> dict:
    return {name: counts.get(name, 0) for name in _counted()}


def _build_model(cfg, n_params: int, seed: int = 0):
    from repro_torch import models
    t0 = time.perf_counter()
    model = models.Model(cfg, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    kinds = {k: model.kinds.count(k) for k in dict.fromkeys(model.kinds)}
    log(f"model {cfg.name}: {n} float32 parameters "
        f"({n * 4 / 1e9:.3f} GB) built on the card in "
        f"{time.perf_counter() - t0:.3f} s; layers {json.dumps(kinds)}")
    check(n == n_params, f"expected {n_params} parameters, built {n}")
    return model


def phase_prefill(cfg, n_params: int, B: int, S: int,
                  expect: dict, profile: bool = False,
                  extra: dict | None = None, label: str = "") -> dict:
    """`make_prefill_step` on B random prompts of S tokens (and the
    frontends' inputs in `extra`), with every kernel's launches counted
    around the first run; a second run gives the same bits.  With
    `profile`, a third run under `torch.profiler` (`_profile`: device
    time by kernel, idle share)."""
    from repro_torch.launch.steps import make_prefill_step
    arch = cfg.name + label
    model = _build_model(cfg, n_params)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        0, model.cfg.vocab_size, (B, S))).cuda()
    batch = {"tokens": tokens, **(extra or {})}
    step = make_prefill_step(model.cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    logits = step(model, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches == expect,
          f"{arch} prefill launches {launches}, expected {expect}")
    check(tuple(logits.shape) == (B, model.cfg.vocab_size),
          "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    t0 = time.perf_counter()
    again = step(model, batch)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    rerun_diff = float((again - logits).abs().max())
    check(torch.equal(again, logits),
          f"{arch} prefill: a second run differs by {rerun_diff!r}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"prefill path {arch} B={B} S={S}: launches "
        f"{json.dumps(launches)}, logits finite, |logits| max "
        f"{float(logits.abs().max())!r}, second run differs by "
        f"{rerun_diff!r}")
    log(f"prefill wall {arch} (host clock after synchronize): first "
        f"{first_s:.6f} s, second {second_s:.6f} s "
        f"({B * S / second_s:.1f} prompt tokens/s); peak "
        f"device memory {peak:.3f} GB")
    del again
    if profile:
        prof = _profile(f"prefill profile {arch}",
                        lambda: step(model, batch))
        check(prof["fa_fwd_ms"] > 0, f"{arch} prefill profile finds no "
              f"flash-attention kernel by name, though it launched")
    del model, logits, batch
    torch.cuda.empty_cache()
    out = {"launches": launches, "first_s": first_s, "second_s": second_s,
           "peak_gb": peak, "tokens_per_s": B * S / second_s}
    if profile:
        out["profile"] = prof
    return out


# ---------------------------------------------------------------------- #
# 7/10. the serving path at full width
# ---------------------------------------------------------------------- #
def rwkv_logits_f64(model, tokens: torch.Tensor) -> torch.Tensor:
    """Last-position logits of an rwkv6-7b `model` on `tokens`, evaluated
    in float64 on the card from its weights by the block's equations
    written out (`tools/rwkv6_replay_drift.py`), apart from the code under
    test: it separates float32 rounding from a fault."""
    from rwkv6_replay_drift import f64_block, f64_logits, zero_carry
    h = model.embed["table"][tokens.long()].double()
    for layer in model.layers:
        h, _ = f64_block(layer, model.cfg, h,
                         zero_carry(model.cfg, h.shape[0], h.device))
    return f64_logits(model, h[:, -1])


class _RoutingRecorder:
    """Records the router probabilities of every `MoE.apply` and
    `MoE.aux_loss` call while it is entered, in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.module, self.calls = moe, []
        self.inner = moe._router_probs

        def record(p, x):
            probs = self.inner(p, x)
            self.calls.append(probs.detach().cpu())
            return probs

        moe._router_probs = record
        return self

    def __exit__(self, *exc):
        self.module._router_probs = self.inner


def _routing_report(cfg, replay_calls: list, prefill_calls: list,
                    prompt_len: int) -> str:
    """Where the prompt replay and the prefill route a prompt token to
    different experts, and the smallest top-k margin (the k-th minus the
    (k+1)-th router probability, from the prefill) over all tokens and
    layers and over the ones that differ: a margin at float32 rounding
    is a routing near-tie, a wide one a fault."""
    L, k = cfg.n_layers, cfg.experts_per_token
    # the replay: one apply a layer and step; the prefill: apply, then
    # aux_loss, a layer
    replay = [torch.cat([replay_calls[t * L + layer]
                         for t in range(prompt_len)], dim=1)
              for layer in range(L)]
    prefill = prefill_calls[0::2]
    worst, differ = None, []
    for layer in range(L):
        srt = torch.sort(prefill[layer], dim=-1, descending=True,
                         stable=True)
        margin = srt.values[..., k - 1] - srt.values[..., k]      # [B, S]
        want = srt.indices[..., :k].sort(-1).values
        got = torch.sort(replay[layer], dim=-1, descending=True,
                         stable=True).indices[..., :k].sort(-1).values
        m = float(margin.min())
        worst = m if worst is None else min(worst, m)
        for b, t in (want != got).any(-1).nonzero().tolist():
            differ.append((layer, b, t, float(margin[b, t])))
    where = "; ".join(f"layer {layer} sequence {b} token {t} margin {m!r}"
                      for layer, b, t, m in differ[:8])
    return (f"smallest top-{k} margin over the prompts' tokens and layers "
            f"{worst!r}; routing differs at {len(differ)} (token, layer)"
            f"{': ' + where if differ else ''}")


def phase_serve(cfg, expect_serve: dict, expect_prefill: dict,
                note: str = "", reference=None) -> dict:
    """The launcher at the JAX launcher's defaults (batch 4, prompt 32,
    generate 32), with every kernel's launches counted around it; its
    logits after the prompt replay held against `make_prefill_step`.

    With a float64 `reference` (model, prompts) -> logits, the replay is
    held to it instead: it may be no farther from the float64 logits
    than max(SERVE_TOL, twice the prefill's own distance), i.e. the
    decode path through the kernel must be as accurate as the prefill.
    A float32 model whose rounding grows through its depth can put the
    two float32 paths more than SERVE_TOL apart while both are right.

    For an MoE config the router's probabilities are recorded in both
    runs, and where the two route a prompt token differently is logged
    with the top-k margins (`_routing_report`)."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    arch = cfg.name
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must stay off: the checks are float32")
    with _RoutingRecorder() as replay_routing:
        zero_launches()
        out = serve(cfg, device="cuda")
        serve_launches = read_launches()
    check(serve_launches == expect_serve,
          f"{arch} launcher launches {serve_launches}, expected "
          f"{expect_serve}")
    gen = out["generated"]
    check(tuple(gen.shape) == (4, 32) and gen.dtype == torch.int32,
          "generated ids shape or dtype")
    check(bool(((gen >= 0) & (gen < out["model"].cfg.vocab_size)).all()),
          "generated ids outside the vocabulary")
    with _RoutingRecorder() as prefill_routing:
        zero_launches()
        last = make_prefill_step(out["model"].cfg)(
            out["model"], {"tokens": out["prompts"]})
        torch.cuda.synchronize()
        prefill_launches = read_launches()
    check(prefill_launches == expect_prefill,
          f"the comparison prefill's launches {prefill_launches}, "
          f"expected {expect_prefill}")
    err = float((last - out["last_logits"]).abs().max())
    ref_note = ""
    if cfg.is_moe:
        log(f"routing {arch}, prompt replay vs prefill: " + _routing_report(
            cfg, replay_routing.calls, prefill_routing.calls,
            out["prompts"].shape[1]))
    if reference is None:
        check(err <= SERVE_TOL,
              f"prefill vs prompt replay: max abs difference {err!r}")
    else:
        want = reference(out["model"], out["prompts"])
        e_prefill = float((last.double() - want).abs().max())
        e_replay = float((out["last_logits"].double() - want).abs().max())
        bound = max(SERVE_TOL, 2.0 * e_prefill)
        check(e_replay <= bound,
              f"prompt replay is {e_replay!r} from the float64 logits, "
              f"more than max({SERVE_TOL}, 2 x the prefill's "
              f"{e_prefill!r})")
        ref_note = (f"; against the float64 evaluation: prefill "
                    f"{e_prefill!r}, replay {e_replay!r} (bound "
                    f"{bound!r})")
        del want
    decode_ms = out["gen_s"] / gen.shape[1] * 1e3
    log(f"serving path {arch}: prefill (prompt replay) "
        f"{out['prefill_s'] * 1e3:.3f} ms, decode "
        f"{decode_ms:.3f} ms/step, "
        f"{out['tok_per_s']:.3f} tok/s; launches in the launcher "
        f"{json.dumps(serve_launches)}{note}")
    log(f"serving first generated ids {arch}: {gen[0, :16].tolist()}")
    log(f"prefill vs prompt replay {arch}, last-position logits: max abs "
        f"difference {err!r}"
        f"{f' (tolerance {SERVE_TOL})' if reference is None else ref_note}; "
        f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} (no "
        f"convolution runs)")
    del out, last
    torch.cuda.empty_cache()
    return {"max_abs_diff": err, "launches": serve_launches,
            "decode_ms": decode_ms}


# ---------------------------------------------------------------------- #
# 10f-10h. the encoder and the vision frontend
# ---------------------------------------------------------------------- #
def _normal(shape, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda")


def _qwen_inputs(cfg) -> dict:
    """qwen2-vl-2b's frontend inputs: QWEN_PATCHES patch embeddings in
    place of the first tokens' embeddings, and M-RoPE positions as
    Qwen2-VL assigns them: the patches at temporal position 0 on a square
    (height, width) grid, the text after them from the grid's side on,
    on all three streams."""
    n = QWEN_PATCHES
    side = int(round(n ** 0.5))
    i = torch.arange(QWEN_S, device="cuda")
    text = i - n + side
    pos = torch.stack([torch.where(i < n, 0, text),
                       torch.where(i < n, i // side, text),
                       torch.where(i < n, i % side, text)])
    return {"patch_embeds": _normal((QWEN_B, n, cfg.d_model), seed=2),
            "mrope_pos": pos[:, None].expand(3, QWEN_B, QWEN_S).contiguous()}


def phase_seamless_decode(cfg) -> dict:
    """The encoder-decoder decode: `prefill` on SEAMLESS_DEC_B prompts of
    SEAMLESS_PROMPT tokens with SEAMLESS_SE frames each (the encoder and
    the prompt's forward; the cache's `enc` is the encoder's output),
    then the prompt replayed and SEAMLESS_GEN greedy tokens through
    `decode_step`, whose cross attentions read the cache's `enc`: one
    flash-attention launch a layer and step (Sq = 1 by Se), the
    self-attention computed inline.  The replay within SERVE_TOL of the
    prefill.  Then one decode step under `torch.profiler` (its device
    busy time and idle share: the host's dispatch of ~1,000 small
    launches outlasts the card's work) and the device time of the cross
    attentions' key and value projections that every step recomputes
    from `enc` (`CrossAttention.project_kv`, as the step calls it),
    beside the step's bounds: the decoder's and the unembedding's
    weights, `enc` and the cache read once, and the recompute's
    operations on the CUDA cores (the products run in
    float32, TF32 off)."""
    from repro_torch import models
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.attention import CrossAttention
    L, E = cfg.n_layers, cfg.n_encoder_layers
    B, P, G, Se = SEAMLESS_DEC_B, SEAMLESS_PROMPT, SEAMLESS_GEN, SEAMLESS_SE
    model = _build_model(cfg, SEAMLESS_PARAMS)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                              dtype=torch.int32).cuda()
    frames = _normal((B, Se, cfg.d_model), seed=3)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        zero_launches()
        last, cache = models.prefill(model, {"tokens": prompts,
                                             "frame_embeds": frames},
                                     max_len=P + G)
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == _expect(flash_attention=E + 2 * L),
              f"seamless prefill with {Se} frames: launches {launches}")
        check(tuple(cache.enc.shape) == (B, Se, cfg.d_model),
              "the cache holds no encoder output")
        zero_launches()
        t0 = time.perf_counter()
        for t in range(P):
            logits, cache = models.decode_step(model, cache, prompts[:, t], t)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        tok, out = torch.argmax(logits, dim=-1).to(torch.int32), []
        t0 = time.perf_counter()
        for t in range(P, P + G):
            out.append(tok)
            tok, cache = step(model, cache, tok, t)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        decode_launches = read_launches()
    check(decode_launches == _expect(flash_attention=(P + G) * L),
          f"seamless decode launches {decode_launches}, expected "
          f"{(P + G) * L}")
    err = float((logits - last).abs().max())
    check(err <= SERVE_TOL, f"seamless prefill vs prompt replay: max abs "
          f"difference {err!r}")
    gen = torch.stack(out, dim=1)
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          "generated ids outside the vocabulary")
    with torch.inference_mode():
        enc = cache.enc
        prof = _profile("seamless decode step profile",
                        lambda: models.decode_step(model, cache, tok,
                                                   P + G - 1), top=6)
        kv_ms = _cuda_ms(lambda: [
            CrossAttention.project_kv(p["xattn"], cfg, enc)
            for p in model.layers], reps=5)
    weights = sum(p.numel() for layer in model.layers
                  for p in layer.parameters()) \
        + model.final_ln["scale"].numel() + model.embed["unembed"].numel()
    nbytes = 4 * weights + enc.numel() * enc.element_size() + sum(
        t.numel() * t.element_size() for c in cache for t in c.values())
    kv_ops = 2 * B * Se * cfg.d_model * 2 * cfg.n_kv_heads * cfg.head_dim * L
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = kv_ops / PEAK_F32_OPS_PER_S * 1e3
    decode_ms = gen_s / G * 1e3
    log(f"seamless encoder-decoder decode B={B} prompt={P} gen={G} "
        f"Se={Se}: prefill launches {json.dumps(launches)}; replay and "
        f"generation launches {json.dumps(decode_launches)}; prefill vs "
        f"prompt replay max abs difference {err!r} (tolerance "
        f"{SERVE_TOL}); replay {replay_s * 1e3:.3f} ms, generation "
        f"{decode_ms:.3f} ms/step (host clock), "
        f"{B * G / gen_s:.3f} tok/s; first generated ids "
        f"{gen[0, :16].tolist()}")
    busy = prof["busy_ms"]
    log(f"seamless decode step: device busy {busy!r} ms of a "
        f"{prof['wall_ms']!r} ms profiled wall; the cross attentions' key "
        f"and value projections from enc {kv_ms!r} ms ({kv_ms / busy:.4f} "
        f"of the device time, {kv_ms / decode_ms:.4f} of the host-clock "
        f"step; {kv_ops / 1e9:.1f} GFLOP); bounds: {nbytes / 1e9:.3f} GB "
        f"read once {t_bytes!r} ms, the recompute's operations on the "
        f"CUDA cores {t_ops!r} ms")
    del model, cache, enc, frames, last, logits
    torch.cuda.empty_cache()
    return {"prefill_launches": launches["flash_attention"],
            "launches": decode_launches["flash_attention"],
            "max_abs_diff": err, "decode_ms": decode_ms,
            "busy_ms": busy, "kv_ms": kv_ms, "bound_bytes_ms": t_bytes,
            "bound_ops_ms": t_ops}


# ---------------------------------------------------------------------- #
# 8. the RWKV6 kernel against its plain version
# ---------------------------------------------------------------------- #
def _rwkv_inputs(B: int, S: int, H: int, Dk: int, Dv: int,
                 dtype=torch.float32, seed: int = 0):
    """r, v normal; k normal * 0.3; w uniform(0.4, 0.99); u normal * 0.1
    (the draws of the JAX package's kernel test); s0 normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r = normal(B, S, H, Dk).to(dtype)
    k = (normal(B, S, H, Dk) * 0.3).to(dtype)
    v = normal(B, S, H, Dv).to(dtype)
    w = (torch.rand((B, S, H, Dk), generator=g, device="cuda") * 0.59
         + 0.4).to(dtype)
    u = normal(H, Dk) * 0.1
    s0 = normal(B, H, Dk, Dv)
    return r, k, v, w, u, s0


def phase_rwkv_kernel_vs_plain() -> float:
    """out within tol (absolute at the JAX test shapes; times max(1,
    max|out|) at the model's shapes), S_last exactly equal: the kernel
    rounds w*S + kv as the plain version's two operations do."""
    from repro_torch.kernels import rwkv6
    cases = ([(c, torch.float32, False, False) for c in RWKV_CASES]
             + [(RWKV_MAIN, torch.float32, s0, True) for s0 in (False, True)]
             + [(RWKV_DECODE, torch.float32, True, True),
                (RWKV_BF16, torch.bfloat16, True, True)]
             + [(c, torch.float32, True, True) for c in RWKV_STRESS]
             + [((2, 1, 3, 40, 24), torch.bfloat16, True, True)])
    worst = 0.0
    for shape, dtype, with_s0, relative in cases:
        r, k, v, w, u, s0 = _rwkv_inputs(*shape, dtype=dtype)
        s0 = s0 if with_s0 else None
        out, s_last = rwkv6.rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        want_o, want_s = rwkv6.rwkv6_plain(r, k, v, w, u, s0)
        check(out.dtype == dtype and tuple(out.shape) == tuple(v.shape)
              and s_last.dtype == torch.float32,
              f"rwkv6 {shape}: dtype or shape")
        tol = RWKV_TOL if dtype == torch.float32 else RWKV_BF16_TOL
        scale = max(1.0, float(want_o.float().abs().max())) if relative \
            else 1.0
        err = float((out.float() - want_o.float()).abs().max())
        check(err <= tol * scale, f"rwkv6 {shape} {dtype}: out error "
              f"{err!r} > {tol} x {scale!r}")
        check(torch.equal(s_last, want_s),
              f"rwkv6 {shape} {dtype}: S_last differs from the plain "
              f"version by {float((s_last - want_s).abs().max())!r}")
        if shape == RWKV_MAIN:
            worst = max(worst, err)
        log(f"kernel rwkv6 (B, S, H, Dk, Dv)={shape} "
            f"{str(dtype).split('.')[-1]} s0={'given' if with_s0 else 'none'}"
            f": out max abs error {err!r} (tolerance {tol}"
            f"{f' x {scale!r}' if relative else ''}), S_last equal")
        del r, k, v, w, out, s_last, want_o, want_s
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------- #
# 12. the backward kernels against their plain versions
# ---------------------------------------------------------------------- #
def _grad_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), the tolerance's scale."""
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def _fa_bwd_plain_f64(q, k, v, dout, **kw):
    """The plain version's autograd in float64, over kv heads a few at a
    time (with their q heads), so that the [B, H, Sq, Sk] float64 scores
    of a large case stay near 2 GB."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Hq, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    step = max(1, min(Hkv, (1 << 28) // max(1, B * group * Sq * Sk)))
    parts = []
    for h in range(0, Hkv, step):
        qs = slice(h * group, (h + step) * group)
        parts.append(fa.flash_attention_bwd_plain(
            q[:, :, qs].double(), k[:, :, h:h + step].double(),
            v[:, :, h:h + step].double(), dout[:, :, qs].double(), **kw))
    return [torch.cat(g, dim=2) for g in zip(*parts)]


def _fa_bwd_check(case, seed: int = 0, q_offset: int = 0) -> dict:
    """Flash attention's backward kernel on `case` against the plain
    version's autograd in float64: the scaled error of dq, dk and dv,
    each checked (a stride of the wrong width reads wrong columns without
    a fault); also two calls bit-identical and `out` the same with and
    without the log-sum-exp write."""
    from repro_torch.kernels import flash_attention as fa
    causal, window, cap, dt = case[6:]
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    q, k, v = _fa_inputs(case, seed)
    dout = torch.randn(q.shape[:3] + v.shape[3:], generator=torch.Generator(
        device="cuda").manual_seed(seed + 1), device="cuda").to(q.dtype)
    with torch.no_grad():
        out_plain = fa.flash_attention(q, k, v, **kw)
    grads = []
    for _ in range(2):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*qkv, **kw)
        check(torch.equal(out.detach(), out_plain),
              f"flash attention {case}: out differs with the lse write")
        out.backward(dout)
        grads.append([x.grad for x in qkv])
        del out, qkv
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*grads)),
          f"flash attention backward {case}: two calls differ")
    want = _fa_bwd_plain_f64(q, k, v, dout, **kw)
    check(all(g.dtype == q.dtype and g.shape == w.shape
              for g, w in zip(grads[0], want)),
          f"flash attention backward {case}: dtype or shape")
    errs = {name: _grad_err(g, w)
            for name, g, w in zip(("dq", "dk", "dv"), grads[0], want)}
    check(max(errs.values()) <= BWD_TOL[dt],
          f"flash attention backward {case}: errors {errs}")
    del q, k, v, dout, grads, want
    return errs


def _rg_bwd_check(B: int, S: int, D: int, dtype, with_h0: bool) -> float:
    """The RG-LRU backward kernel against the plain version's autograd in
    float64 (dx, da, dh0); two calls bit-identical."""
    from repro_torch.kernels import rglru
    x, a, h0 = _rg_inputs(B, S, D, dtype=dtype, seed=3)
    h0 = h0 if with_h0 else None
    g = torch.Generator(device="cuda").manual_seed(4)
    dh = torch.randn((B, S, D), generator=g, device="cuda").to(dtype)
    dlast = torch.randn((B, D), generator=g, device="cuda").to(dtype)
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_(True) for t in (x, a)] + (
            [h0.clone().requires_grad_(True)] if with_h0 else [])
        h, last = rglru.rglru_scan(*ins)
        torch.autograd.backward((h, last), (dh, dlast))
        runs.append([t.grad for t in ins])
    torch.cuda.synchronize()
    check(all(torch.equal(p, q) for p, q in zip(*runs)),
          "rglru backward: two calls differ")
    want = rglru.rglru_bwd_plain(
        x.double(), a.double(), h0.double() if with_h0 else None,
        dh.double(), dlast.double())
    err = max(_grad_err(gr, w) for gr, w in zip(runs[0], want))
    name = "float32" if dtype == torch.float32 else "bfloat16"
    check(err <= BWD_TOL[name], f"rglru backward B={B} S={S} D={D} "
          f"{name} h0={with_h0}: error {err!r}")
    return err


def phase_backward_kernels_vs_plain() -> dict:
    from repro_torch.kernels import rglru
    worst = {}
    # FA_CASES, the training paths' layers (A, B), and every shape paths D
    # and E train at: MLA's (192, 128) and seamless's, no mask at Sq != Sk
    for case in FA_CASES + [FA_BWD_A, FA_BWD_A[:9] + ("bfloat16",),
                            FA_BWD_B, FA_BWD_B[:9] + ("bfloat16",)] \
            + FA_BWD_PATHS:
        errs = _fa_bwd_check(case)
        worst[case] = max(errs.values())
        log(f"kernel flash_attention_bwd {case}: scaled max error "
            f"{json.dumps(errs)} (tolerance {BWD_TOL[case[-1]]} of max(1, "
            f"max|g|)); two calls bit-identical; out unchanged by the lse "
            f"write")
        torch.cuda.empty_cache()
    worst["flash_attention_bwd"] = worst[FA_BWD_A]
    # every instantiation: each head dim and MLA's pair, both dtypes, on
    # the edges
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    errs = {}
    for D in HEAD_DIMS + (MLA_D,):
        for dt in ("float32", "bfloat16"):
            for B, Sq, Sk, Hq, Hkv, causal, window, cap, off in FA_BWD_EDGES:
                case = (B, Sq, Sk, Hq, Hkv, D, causal, window, cap, dt)
                err = max(_fa_bwd_check(case, seed=_head_dims(D)[0],
                                        q_offset=off).values())
                errs[dt] = max(errs.get(dt, 0.0), err)
    log(f"kernel flash_attention_bwd on every head dim {HEAD_DIMS} and "
        f"{MLA_D} x float32, bfloat16 x {len(FA_BWD_EDGES)} edges: worst "
        f"scaled error {errs} (tolerances {BWD_TOL}); each twice, "
        f"bit-identical; out unchanged by the lse write")
    for dtype in (torch.float32, torch.bfloat16):
        for with_h0 in (False, True):
            err = _rg_bwd_check(*RG_BWD, dtype, with_h0)
            if dtype == torch.float32 and not with_h0:
                worst["rglru_bwd"] = err
            log(f"kernel rglru_bwd B={RG_BWD[0]} S={RG_BWD[1]} "
                f"D={RG_BWD[2]} {dtype} h0={with_h0}: scaled max error "
                f"{err!r}; two calls bit-identical")
    # S off the chunks: one short of a chunk, one past it, three chunks
    # and 5, and path B's length less one (a ragged last chunk)
    C = rglru.chunk_steps()
    for S in (C - 1, C + 1, 3 * C + 5, RG_BWD[1] - 1):
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                err = _rg_bwd_check(RG_BWD[0], S, RG_BWD[2], dtype, with_h0)
        log(f"kernel rglru_bwd S={S} (chunks of {C}) D={RG_BWD[2]}: "
            f"float32 and bfloat16, h0 or none, within {BWD_TOL}; two "
            f"calls bit-identical")
    # the gate's gradient on every float a in [0, 1] (and outside it):
    # S = 1, x = 1, h0 = 0, dh = 1, equal to the plain version's float32
    # autograd, the infinite square-root gradient at a = 1 included
    chunk = 1 << 26
    edges = torch.tensor([-1.0, -0.5, 1.5, 2.0, -2.0], device="cuda")
    for lo in range(0, 0x3F800001, chunk):
        a = torch.arange(lo, min(lo + chunk, 0x3F800001), dtype=torch.int32,
                         device="cuda").view(torch.float32)
        if lo == 0:
            a = torch.cat([a, edges])
        a = a.view(1, 1, -1)
        x, h0, dh = torch.ones_like(a), torch.zeros_like(a[:, 0]), \
            torch.ones_like(a)
        ins = [t.clone().requires_grad_(True) for t in (x, a, h0)]
        h, last = rglru.rglru_scan(*ins)
        torch.autograd.backward((h, last), (dh, torch.zeros_like(h0)))
        want = rglru.rglru_bwd_plain(x, a, h0, dh, torch.zeros_like(h0))
        for g, w in zip((t.grad for t in ins), want):
            check(torch.equal(torch.isnan(g), torch.isnan(w))
                  and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)),
                  f"rglru backward at the gate, a from {lo:#x}: differs")
        del a, x, h0, dh, ins, h, last, want
    log("kernel rglru_bwd gate of every float a in [0, 1] (and -1, -0.5, "
        "1.5, 2, -2): dx, da, dh0 equal to the plain version's float32 "
        "autograd, NaN and infinities included")
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------- #
# 12b. the RWKV6 backward kernel against its plain version
# ---------------------------------------------------------------------- #
def _rwkv_bwd_inputs(shape, dtype, w_case: str = "uniform", seed: int = 5):
    """_rwkv_inputs' draws, w replaced by 0, 1 or exp(-69·uniform) (log w
    down to -69) on request, then dout and dS_last, normal."""
    B, S, H, Dk, Dv = shape
    r, k, v, w, u, s0 = _rwkv_inputs(*shape, dtype=dtype, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    if w_case == "zero":
        w = torch.zeros_like(w)
    elif w_case == "one":
        w = torch.ones_like(w)
    elif w_case == "tiny":
        w = torch.exp(-69.0 * torch.rand(w.shape, generator=g,
                                         device="cuda")).to(dtype)
    dout = torch.randn((B, S, H, Dv), generator=g, device="cuda").to(dtype)
    dsl = torch.randn((B, H, Dk, Dv), generator=g, device="cuda")
    return r, k, v, w, u, s0, dout, dsl


def _rwkv_bwd_check(shape, dtype, with_s0: bool, with_dsl: bool,
                    w_case: str = "uniform") -> float:
    """The RWKV6 backward kernel (through `rwkv6_scan`'s autograd Function)
    against the plain version's autograd in float64: the scaled error of
    dr, dk, dv, dw, du (and ds0); also two calls bit-identical and out and
    S_last the same bits with and without the checkpoint write."""
    from repro_torch.kernels import rwkv6
    r, k, v, w, u, s0, dout, dsl = _rwkv_bwd_inputs(shape, dtype, w_case)
    s0 = s0 if with_s0 else None
    dsl = dsl if with_dsl else None
    with torch.no_grad():
        want_o, want_s = rwkv6.rwkv6_scan(r, k, v, w, u, s0)
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)] + (
            [s0.clone().requires_grad_(True)] if with_s0 else [])
        out, s_last = rwkv6.rwkv6_scan(*ins[:5],
                                       ins[5] if with_s0 else None)
        check(torch.equal(out.detach(), want_o)
              and torch.equal(s_last.detach(), want_s),
              f"rwkv6 {shape}: out or S_last differs with the checkpoint "
              f"write")
        outs, grads = [out], [dout]
        if with_dsl:
            outs.append(s_last)
            grads.append(dsl)
        torch.autograd.backward(outs, grads)
        runs.append([t.grad for t in ins])
        del out, s_last, ins
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"rwkv6 backward {shape}: two calls differ")
    check(all(g.dtype == x.dtype and g.shape == x.shape
              for g, x in zip(runs[0], (r, k, v, w, u, s0))),
          f"rwkv6 backward {shape}: dtype or shape")
    want = rwkv6.rwkv6_bwd_plain(*(t.double() if t is not None else None
                                   for t in (r, k, v, w, u, s0, dout, dsl)))
    err = max(_grad_err(g, wt) for g, wt in zip(runs[0], want)
              if wt is not None)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    check(err <= BWD_TOL[name], f"rwkv6 backward {shape} {name} s0="
          f"{with_s0} dS_last={with_dsl} w={w_case}: error {err!r}")
    log(f"kernel rwkv6_bwd (B, S, H, Dk, Dv)={shape} {name} s0="
        f"{'given' if with_s0 else 'none'} dS_last="
        f"{'given' if with_dsl else 'none'} w={w_case}: scaled max error "
        f"{err!r} (tolerance {BWD_TOL[name]} of max(1, max|g|)); two calls "
        f"bit-identical; out and S_last unchanged by the checkpoints")
    del r, k, v, w, u, s0, dout, dsl, runs, want
    torch.cuda.empty_cache()
    return err


def phase_rwkv_backward_vs_plain() -> float:
    """RWKV_CASES and the stress layouts (float32, s0 and dS_last given),
    path C's layer shape in float32 and bfloat16 with and without s0 and
    dS_last, and w = 0, w = 1 and log w down to -69: the worst float32
    error at path C's shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in RWKV_CASES + RWKV_BWD_STRESS:
        _rwkv_bwd_check(shape, f32, True, True)
    worst = 0.0
    for dtype in (f32, bf16):
        for given in (True, False):
            err = _rwkv_bwd_check(RWKV_BWD, dtype, given, given)
            if dtype == f32:
                worst = max(worst, err)
    for w_case in ("zero", "one", "tiny"):
        for dtype in (f32, bf16):
            _rwkv_bwd_check(RWKV_BWD_EDGES, dtype, True, True, w_case)
    return worst


# ---------------------------------------------------------------------- #
# 13/14/16. the training paths at full width
# ---------------------------------------------------------------------- #
def _train_batches(cfg, B: int, S: int, n_micro: int, steps: int) -> list:
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    return [{"tokens": torch.as_tensor(
        data.batch(s, n_micro=n_micro)["tokens"]).cuda()}
        for s in range(steps)]


def _train_model(cfg, n_params: int, seed: int = 0):
    from repro_torch import models
    model = models.Model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).requires_grad_(True)
    n = sum(p.numel() for p in model.parameters())
    check(n == n_params, f"{cfg.name}: expected {n_params} parameters, "
          f"built {n}")
    return model


def _run_steps(cfg, model, batches, n_micro: int, steps: int,
               impl: str = "auto", lr: float = TRAIN_LR) -> tuple[list, list]:
    """`make_train_step` over `batches`: (per-step metrics as floats,
    per-step host seconds after a synchronize)."""
    from repro_torch import models
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=2, total_steps=steps)
    step = make_train_step(cfg, opt_cfg,
                           ParallelConfig(microbatches=n_micro), impl=impl)
    opt = adamw_init(models.param_tree(model), opt_cfg)
    metrics, seconds = [], []
    for batch in batches[:steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    del opt
    return metrics, seconds


def _profile(label: str, run, top: int = 10,
             groups: dict | None = None) -> dict:
    """`run()` (one train step or prefill) under `torch.profiler`: the
    device time by kernel (the `top` largest logged), the share of the
    flash-attention kernels, of each of `groups` (label -> kernel name
    parts) and the device's idle share of the run's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []      # the kernels' own events (an operator's device time
    for ev in prof.key_averages():      # repeats its kernels')
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((ev.key, ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    # the port's kernels are in their sources' anonymous namespaces (the
    # flash-attention forward: fa_fwd_kernel; the backward: delta_kernel,
    # then bwd_kernel, or bf16's (192, 128) mla_bwd_kernel, for dK/dV and
    # for dQ); PyTorch's own kernels are not
    ours = "(anonymous namespace)::"
    fa_fwd = sum(r[2] for r in rows if ours + "fa_fwd_kernel<" in r[0])
    fa_bwd = sum(r[2] for r in rows if any(
        ours + k in r[0]
        for k in ("bwd_kernel<", "mla_bwd_kernel<", "delta_kernel<")))
    # cuBLAS's and CUTLASS's matrix products name themselves *gemm*
    gemm = sum(r[2] for r in rows if "gemm" in r[0].lower())
    log(f"{label}: wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms (idle {max(0.0, 1 - busy / wall_ms):.4f} of "
        f"the wall); flash attention forward {fa_fwd:.3f} ms "
        f"({fa_fwd / busy:.4f} of the device time), backward "
        f"{fa_bwd:.3f} ms ({fa_bwd / busy:.4f}); GEMM kernels "
        f"{gemm:.3f} ms ({gemm / busy:.4f})")
    shares = {label: sum(r[2] for r in rows
                         if any(ours + k in r[0] for k in parts))
              for label, parts in (groups or {}).items()}
    if shares:
        log(f"{label}: " + "; ".join(
            f"{label} {ms:.3f} ms ({ms / busy:.4f} of the device time)"
            for label, ms in shares.items()))
    for name, count, ms in rows[:top]:
        log(f"{label}: {ms:.3f} ms ({ms / busy:.4f})"
            f" x{count} {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "fa_fwd_ms": fa_fwd,
            "fa_bwd_ms": fa_bwd, "gemm_ms": gemm, **shares}


def phase_train_a() -> dict:
    """Path A: the kernels' train step held against impl="ref" on a
    4-layer full-width copy, then 8 steps of the whole model."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import tree_map
    cfg = get_config(TRAIN_A_ARCH)
    batches = _train_batches(cfg, TRAIN_A_B, TRAIN_A_S, TRAIN_A_MICRO,
                             TRAIN_A_STEPS)
    small = dataclasses.replace(cfg, n_layers=TRAIN_A_CHECK_LAYERS)
    base = models.Model(small, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    got = {}
    for impl in ("auto", "ref"):     # each on its own copy of the weights
        model = models.Model(small, device="cuda", params=tree_map(
            lambda w: w.detach().clone(), models.param_tree(base)))
        model.requires_grad_(True)
        got[impl] = _run_steps(small, model, batches, TRAIN_A_MICRO, 1,
                               impl=impl)[0][0]
        del model
        torch.cuda.empty_cache()
    for key in ("loss", "grad_norm"):
        rel = abs(got["auto"][key] - got["ref"][key]) / abs(got["ref"][key])
        check(rel <= TRAIN_TOL, f"train step {TRAIN_A_CHECK_LAYERS}-layer "
              f"{cfg.name}: {key} {got['auto'][key]!r} through the kernels, "
              f"{got['ref'][key]!r} through impl='ref' ({rel!r})")
    log(f"train step check {cfg.name} {TRAIN_A_CHECK_LAYERS} layers at "
        f"full width, B={TRAIN_A_B} S={TRAIN_A_S} in {TRAIN_A_MICRO} "
        f"microbatches: kernels loss {got['auto']['loss']!r} grad_norm "
        f"{got['auto']['grad_norm']!r}; impl='ref' loss "
        f"{got['ref']['loss']!r} grad_norm {got['ref']['grad_norm']!r} "
        f"(tolerance {TRAIN_TOL} relative)")
    del base
    torch.cuda.empty_cache()

    model = _train_model(cfg, TRAIN_A_PARAMS)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    metrics, seconds = _run_steps(cfg, model, batches, TRAIN_A_MICRO,
                                  TRAIN_A_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = TRAIN_A_STEPS * TRAIN_A_MICRO * cfg.n_layers
    expect = _expect(flash_attention=n, flash_attention_bwd=n,
                     adamw=TRAIN_A_STEPS)
    check(launches == expect, f"path A launches {launches}, expected "
          f"{expect}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(losses)), f"path A losses not finite: {losses}")
    check(losses[-1] < losses[0], f"path A loss did not fall: {losses}")
    prof = _profile(f"train step profile {cfg.name}", lambda: _run_steps(
        cfg, model, batches[:1], TRAIN_A_MICRO, 1))
    check(prof["fa_bwd_ms"] > 0, "path A's profile finds no flash-attention "
          "backward kernel by name, though the backward launched")
    steady = float(np.mean(seconds[1:]))
    tokens = TRAIN_A_B * TRAIN_A_S
    log(f"train path A {cfg.name} ({TRAIN_A_PARAMS} float32 parameters, "
        f"{cfg.n_layers} layers) B={TRAIN_A_B} S={TRAIN_A_S} in "
        f"{TRAIN_A_MICRO} microbatches, {TRAIN_A_STEPS} steps: losses "
        f"{[round(x, 6) for x in losses]}; launches {json.dumps(launches)}")
    log(f"train path A wall (host clock after synchronize): step seconds "
        f"{[round(s, 6) for s in seconds]}; steps 2-{TRAIN_A_STEPS} mean "
        f"{steady:.6f} s ({tokens / steady:.1f} tokens/s); peak device "
        f"memory {peak:.3f} GB")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "step_s": steady, "peak_gb": peak,
            "per_step": {k: v // TRAIN_A_STEPS for k, v in launches.items()}}


def phase_adamw(train_a: dict) -> dict:
    """13b. The fused AdamW (`csrc/adamw.cu`) at path A's full-width
    leaves (smollm-360m's 290, 361,821,120 float32 parameters) against the
    tree path (`adamw._tree_update`) on the same card tensors, two steps
    each: with the clip off (clip 1e9) p, m, v and the step bit for bit;
    with it on (clip 1.0 under a norm of ~19) p, m, v within
    ADAMW_CLIP_TOL of each leaf's largest value and grad_norm and lr
    within it relative; one counted update a call.  Then its kernels
    entry: the update's device time beside its bound on bytes (g read for
    the norm, p, g, m, v read and p, m, v written: 32 B an element), the
    tree path's and `torch.optim.AdamW(fused=True)` after
    `clip_grad_norm_`'s, and the host's cost of `adamw_update` and of its
    leaf tables against the ADAMW_HOST_AIM_MS aim."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig, adamw, adamw_cuda, adamw_init
    from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_map
    cfg = get_config(TRAIN_A_ARCH)
    model = _train_model(cfg, TRAIN_A_PARAMS)
    base = tree_map(lambda w: w.detach().clone(), models.param_tree(model))
    del model
    n = sum(w.numel() for w in tree_leaves(base))
    gen = torch.Generator(device="cuda").manual_seed(4)
    grads = tree_map(lambda w: torch.randn(
        w.shape, device="cuda", generator=gen) * 1e-3, base)
    worst = {}
    for clip in (1e9, 1.0):
        opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=8,
                              clip_norm=clip)
        runs = []
        for fused in (True, False):
            params = tree_map(torch.clone, base)
            state = adamw_init(params, opt_cfg)
            before = adamw_cuda.launches
            for _ in range(2):
                if fused:
                    _, _, m = adamw_update(params, grads, state, opt_cfg,
                                           inplace=True)
                else:
                    _, _, m = adamw._tree_update(params, grads, state,
                                                 opt_cfg, True)
            torch.cuda.synchronize()
            check(adamw_cuda.launches - before == (2 if fused else 0),
                  f"adamw clip {clip}: {adamw_cuda.launches - before} fused "
                  f"updates in two {'fused' if fused else 'tree'} steps")
            runs.append((tree_leaves((params, state["m"], state["v"])),
                         int(state["step"]), float(m["grad_norm"]),
                         float(m["lr"])))
            del params, state
        (fl, fs, fn, flr), (tl, ts, tn, tlr) = runs
        engaged = tn > clip
        check(fs == ts == 2 and engaged == (clip == 1.0),
              f"adamw clip {clip}: steps {fs} fused, {ts} tree; the norm "
              f"{tn!r} {'engages' if engaged else 'leaves'} the clip")
        # the norm's squares are summed in another order: grad_norm within
        # the tolerance, the rate bit for bit
        gaps = [abs(fn - tn) / tn, abs(flr - tlr) / tlr]
        if engaged:
            gaps += [float((a.double() - b.double()).abs().max())
                     / max(float(b.double().abs().max()), 1e-30)
                     for a, b in zip(fl, tl)]
        worst[clip] = max(gaps)
        check(worst[clip] <= ADAMW_CLIP_TOL and (engaged or (
            flr == tlr and all(a.dtype == b.dtype and torch.equal(a, b)
                               for a, b in zip(fl, tl)))),
              f"adamw clip {clip}: the fused update differs from the tree "
              f"path's (worst relative {worst[clip]!r}; grad_norm {fn!r} / "
              f"{tn!r}, lr {flr!r} / {tlr!r})")
        log(f"adamw {len(fl) // 3} leaves ({n} float32 parameters), clip "
            f"{clip} (norm {tn!r}): two fused steps against the tree "
            f"path's: {'p, m, v bit for bit, ' if not engaged else ''}"
            f"worst relative {worst[clip]!r} (grad_norm {fn!r} / {tn!r})")
        del runs, fl, tl
        torch.cuda.empty_cache()

    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=8)
    params = tree_map(torch.clone, base)
    state = adamw_init(params, opt_cfg)
    ms = _cuda_ms(lambda: adamw_update(params, grads, state, opt_cfg,
                                       inplace=True))
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw_update(params, grads, state, opt_cfg, inplace=True)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    quads = adamw._zip_leaves(params, grads, state["m"], state["v"])
    cols = [list(c) for c in zip(*quads)]
    table = []
    for _ in range(20):
        t0 = time.perf_counter()
        adamw_cuda.leaf_tables(*cols, cols[0], cols[2], cols[3],
                               adamw_cuda._library().adamw_max_leaves())
        table.append((time.perf_counter() - t0) * 1e3)
    host_ms, table_ms = float(np.median(host)), float(np.median(table))

    def tree_step():
        with torch.no_grad():
            adamw._tree_update(params, grads, state, opt_cfg, True)

    plain_ms = _host_ms(tree_step)
    del params, state, quads, cols
    torch.cuda.empty_cache()
    lib_params = [torch.nn.Parameter(w.clone()) for w in tree_leaves(base)]
    for w, g in zip(lib_params, tree_leaves(grads)):
        w.grad = g.clone()
    lib = torch.optim.AdamW(lib_params, lr=TRAIN_LR, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.1, fused=True)

    def lib_step():
        torch.nn.utils.clip_grad_norm_(lib_params, 1.0, foreach=True)
        lib.step()

    library_ms = _cuda_ms(lib_step)
    del lib, lib_params, base, grads
    torch.cuda.empty_cache()
    bound_ms = 32 * n / PEAK_BYTES_PER_S * 1e3
    aim = (f"{'met' if host_ms <= ADAMW_HOST_AIM_MS else 'missed'}: "
           f"{host_ms!r} ms of host time an update against "
           f"{ADAMW_HOST_AIM_MS} ms")
    entry = {
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/csrc/adamw.cu",
        "replaces": "src/repro/optim/adamw.py:60 (plain jnp that XLA "
                    "fuses; the port's tree path, PyTorch operators a "
                    "leaf)",
        "launches": train_a["per_step"]["adamw"],
        "launches_path": train_a["launches"]["adamw"],
        "max_abs_err": worst[1.0], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
        "library": "torch.nn.utils.clip_grad_norm_(foreach=True) and "
                   "torch.optim.AdamW(fused=True), its own bias "
                   "corrections",
        "host_ms": host_ms, "host_table_ms": table_ms, "aim_host": aim,
        "shape": f"smollm-360m's {TRAIN_A_PARAMS} float32 parameters in "
                 f"290 leaves, in place, clip engaged",
        "plain_on": "the card (adamw._tree_update, host-paced)",
        "launches_note": "fused updates (three kernel launches each) per "
                         "train step of path A; launches_path over its "
                         f"{TRAIN_A_STEPS} steps",
        "max_abs_err_note": "relative to each leaf's largest value, the "
                            "clip engaged; bit for bit with it off"}
    log(f"timing adamw at {entry['shape']}: kernels {ms!r} ms "
        f"({bound_ms / ms:.3f} of the {bound_ms!r} ms bound on bytes), tree "
        f"path {plain_ms!r} ms, library {library_ms!r} ms; host "
        f"{host_ms!r} ms an update (leaf tables {table_ms!r} ms), {aim}")
    return entry


def phase_train_b() -> dict:
    """Path B: recurrentgemma-9b at full width, one pattern period."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(TRAIN_B_ARCH),
                              n_layers=TRAIN_B_LAYERS)
    batches = _train_batches(cfg, TRAIN_B_B, TRAIN_B_S, 1, TRAIN_B_STEPS)
    model = _train_model(cfg, TRAIN_B_PARAMS)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    metrics, seconds = _run_steps(cfg, model, batches, 1, TRAIN_B_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_rec = model.kinds.count("rec")
    n_attn = len(model.kinds) - n_rec
    s = TRAIN_B_STEPS
    expect = _expect(flash_attention=n_attn * s,
                     flash_attention_bwd=n_attn * s, rglru=n_rec * s,
                     rglru_bwd=n_rec * s, adamw=s)
    check(launches == expect, f"path B launches {launches}, expected "
          f"{expect}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(losses)), f"path B losses not finite: {losses}")
    # the FA backward's two launches apart (float32 (256, 256))
    prof = _profile(f"train step profile {cfg.name}", lambda: _run_steps(
        cfg, model, batches[:1], 1, 1),
        groups={"dkdv": ("bwd_kernel<float, 256, 256, false>",),
                "dq": ("bwd_kernel<float, 256, 256, true>",)})
    check(prof["fa_bwd_ms"] > 0, "path B's profile finds no flash-attention "
          "backward kernel by name, though the backward launched")
    steady = float(np.mean(seconds[1:]))
    log(f"train path B {cfg.name} at full width, layers {model.kinds} "
        f"({TRAIN_B_PARAMS} float32 parameters) B={TRAIN_B_B} "
        f"S={TRAIN_B_S}, {s} steps: losses {[round(x, 6) for x in losses]};"
        f" launches {json.dumps(launches)}")
    log(f"train path B wall (host clock after synchronize): step seconds "
        f"{[round(x, 6) for x in seconds]}; steps 2-{s} mean {steady:.6f} "
        f"s ({TRAIN_B_B * TRAIN_B_S / steady:.1f} tokens/s); peak device "
        f"memory {peak:.3f} GB")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "step_s": steady, "peak_gb": peak,
            "per_step": {k: v // s for k, v in launches.items()},
            "profile": prof}


def phase_train_c() -> dict:
    """Path C: rwkv6-7b at full width, 4 layers; first the kernels' train
    step held against impl="chunked" (what the JAX package trains with)
    on a 2-layer copy."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import tree_leaves, tree_map
    full = get_config(TRAIN_C_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_C_LAYERS)
    batches = _train_batches(cfg, TRAIN_C_B, TRAIN_C_S, TRAIN_C_MICRO,
                             TRAIN_C_STEPS)
    small = dataclasses.replace(full, n_layers=TRAIN_C_CHECK_LAYERS)
    base = _train_model(small, TRAIN_C_CHECK_PARAMS, seed=1)
    got = {}
    for impl in ("auto", "chunked"):    # each on its own copy of the weights
        model = models.Model(small, device="cuda", params=tree_map(
            lambda w: w.detach().clone(), models.param_tree(base)))
        model.requires_grad_(True)
        zero_launches()
        got[impl] = _run_steps(small, model, batches, TRAIN_C_MICRO, 1,
                               impl=impl, lr=TRAIN_C_LR)[0][0]
        n = TRAIN_C_MICRO * TRAIN_C_CHECK_LAYERS
        expect = (_expect(rwkv6=n, rwkv6_bwd=n, adamw=1) if impl == "auto"
                  else _expect(adamw=1))
        check(read_launches() == expect, f"path C check {impl}: launches "
              f"{read_launches()}, expected {expect}")
        del model
        torch.cuda.empty_cache()
    rels = {}
    for key in ("loss", "grad_norm"):
        rel = rels[key] = abs(got["auto"][key] - got["chunked"][key]) / abs(
            got["chunked"][key])
        check(rel <= TRAIN_TOL, f"train step {TRAIN_C_CHECK_LAYERS}-layer "
              f"{full.name}: {key} {got['auto'][key]!r} through the "
              f"kernels, {got['chunked'][key]!r} through impl='chunked' "
              f"({rel!r})")
    log(f"train step check {full.name} {TRAIN_C_CHECK_LAYERS} layers at "
        f"full width ({TRAIN_C_CHECK_PARAMS} parameters), B={TRAIN_C_B} "
        f"S={TRAIN_C_S} in {TRAIN_C_MICRO} microbatches: kernels loss "
        f"{got['auto']['loss']!r} grad_norm {got['auto']['grad_norm']!r}; "
        f"impl='chunked' loss {got['chunked']['loss']!r} grad_norm "
        f"{got['chunked']['grad_norm']!r}; relative differences "
        f"{rels['loss']!r} and {rels['grad_norm']!r} (tolerance {TRAIN_TOL})")
    # every gradient leaf of the first microbatch both ways: the averaged
    # loss and grad_norm may not show the two paths' last-bit differences
    leaves = tree_leaves(models.param_tree(base))
    micro = {k: x[0] for k, x in batches[0].items()}
    grads = {impl: torch.autograd.grad(
        models.loss_fn(base, micro, impl=impl), leaves)
        for impl in ("auto", "chunked")}
    leaf_err = max(_grad_err(a, b) for a, b in zip(grads["auto"],
                                                   grads["chunked"]))
    check(leaf_err <= TRAIN_TOL, f"path C check: a gradient leaf through "
          f"the kernels is {leaf_err!r} from impl='chunked'")
    log(f"train step check {full.name} {TRAIN_C_CHECK_LAYERS} layers: every "
        f"gradient leaf of one microbatch through the kernels within "
        f"{leaf_err!r} of impl='chunked' (max|diff| / max(1, max|g|); "
        f"tolerance {TRAIN_TOL})")
    del base, leaves, grads
    torch.cuda.empty_cache()

    model = _train_model(cfg, TRAIN_C_PARAMS)
    log(f"path C model {cfg.name} x {cfg.n_layers} layers: "
        f"{sum(p.numel() for p in model.parameters())} float32 parameters "
        f"from init_params")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    metrics, seconds = _run_steps(cfg, model, batches, TRAIN_C_MICRO,
                                  TRAIN_C_STEPS, lr=TRAIN_C_LR)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = TRAIN_C_STEPS * TRAIN_C_MICRO * cfg.n_layers
    expect = _expect(rwkv6=n, rwkv6_bwd=n, adamw=TRAIN_C_STEPS)
    check(launches == expect, f"path C launches {launches}, expected "
          f"{expect}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(losses)), f"path C losses not finite: {losses}")
    prof = _profile(f"train step profile {cfg.name}", lambda: _run_steps(
        cfg, model, batches[:1], TRAIN_C_MICRO, 1), groups={
        "RWKV6 forward": ("rwkv6_kernel",),
        "RWKV6 backward": ("rwkv6_bwd_",)})
    steady = float(np.mean(seconds[1:]))
    log(f"train path C {full.name} at full width, {cfg.n_layers} layers "
        f"({TRAIN_C_PARAMS} float32 parameters) B={TRAIN_C_B} "
        f"S={TRAIN_C_S} in {TRAIN_C_MICRO} microbatches, {TRAIN_C_STEPS} "
        f"steps at lr {TRAIN_C_LR}: losses {[round(x, 6) for x in losses]}; launches "
        f"{json.dumps(launches)}")
    log(f"train path C wall (host clock after synchronize): step seconds "
        f"{[round(x, 6) for x in seconds]}; steps 2-{TRAIN_C_STEPS} mean "
        f"{steady:.6f} s ({TRAIN_C_B * TRAIN_C_S / steady:.1f} tokens/s); "
        f"peak device memory {peak:.3f} GB")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "step_s": steady, "peak_gb": peak,
            "profile": prof,
            "per_step": {k: v // TRAIN_C_STEPS for k, v in launches.items()}}


# ---------------------------------------------------------------------- #
# 16d. path D: the gradient of deepseek-v3-671b's MLA on the card
# ---------------------------------------------------------------------- #
def _mla_leaves(model) -> list:
    """(path, tensor) of every layer's MLA leaves (`PATH_D_LEAVES`)."""
    from repro_torch import models
    out = []
    for i, layer in enumerate(models.param_tree(model)["layers"]):
        for name in PATH_D_LEAVES:
            for key, t in sorted(layer["attn"][name].items()):
                out.append((f"layers/{i}/attn/{name}/{key}", t))
    return out


def _mla_grad(model, batch, impl: str):
    """(loss, gradients of `models.loss_fn` with respect to the MLA
    leaves)."""
    from repro_torch import models
    loss = models.loss_fn(model, batch, impl=impl)
    grads = torch.autograd.grad(loss, [t for _, t in _mla_leaves(model)])
    return loss.detach(), grads


def _dry_peak(cfg, B: int, S: int, impl: str, run, extra=None) -> int:
    """The peak bytes of `run(model, batch, impl)` as the dry run sizes
    it: fake tensors (the kernels as regions), the parameters' bytes and
    the peak of the bytes the run holds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import models
    from repro_torch.analysis import analyze_program
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        fmodel = models.Model(cfg, device="cpu")
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
                 **{k: torch.empty(shape) for k, shape in
                    (extra or {}).items()}}
    params = sum(p.numel() * p.element_size()
                 for p in fmodel.parameters())
    with fake:
        cost = analyze_program(lambda: run(fmodel, batch, impl))
    del fmodel, batch
    return int(params + cost.peak_bytes)


def phase_train_d(cfg) -> dict:
    """Path D: `torch.autograd.grad` of the 1-layer cut's loss with respect
    to its MLA leaves, through the kernels against impl="ref" at B = 1,
    then timed and profiled at B = 2; each sized by the dry run first."""
    t_start = time.perf_counter()

    def run(model, batch, impl):
        model.requires_grad_(False)
        for _, t in _mla_leaves(model):
            t.requires_grad_(True)
        return _mla_grad(model, batch, impl)

    sizes = {(B, impl): _dry_peak(cfg, B, PATH_D_S, impl, run)
             for B, impl in ((PATH_D_CHECK_B, "auto"),
                             (PATH_D_CHECK_B, "ref"), (PATH_D_B, "auto"))}
    log(f"path D sizing (fake tensors, the kernels as regions): peak "
        + "; ".join(f"B={B} S={PATH_D_S} impl={impl} {v / 1e9:.3f} GB"
                    for (B, impl), v in sizes.items()))
    model = _build_model(cfg, DSV3_PARAMS)
    model.requires_grad_(False)
    leaves = _mla_leaves(model)
    for _, t in leaves:
        t.requires_grad_(True)
    n = sum(t.numel() for _, t in leaves)
    check(n == PATH_D_PARAMS, f"path D: {n} MLA parameters, expected "
          f"{PATH_D_PARAMS}")
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (PATH_D_B, PATH_D_S))).cuda()
    one = {"tokens": tokens[:PATH_D_CHECK_B]}
    got, peaks = {}, {}
    for impl in ("auto", "ref"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        loss, grads = _mla_grad(model, one, impl)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = read_launches()
        peaks[impl] = torch.cuda.max_memory_allocated()
        want = (_expect(flash_attention=1, flash_attention_bwd=1)
                if impl == "auto" else _expect())
        check(launches == want, f"path D impl={impl} launches {launches}, "
              f"expected {want}")
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads),
            f"path D impl={impl}: a loss or gradient not finite")
        got[impl] = (float(loss), grads, s)
    loss_k, g_k, s_k = got["auto"]
    loss_r, g_r, s_r = got["ref"]
    norm = {impl: float(torch.sqrt(sum((g.double() ** 2).sum()
                                       for g in got[impl][1])))
            for impl in got}
    rel = {"loss": abs(loss_k - loss_r) / abs(loss_r),
           "grad_norm": abs(norm["auto"] - norm["ref"]) / norm["ref"]}
    leaf_err = {path.split("/attn/")[1]: _grad_err(a, b)
                for (path, _), a, b in zip(leaves, g_k, g_r)}
    log(f"path D check {cfg.name} ({cfg.n_layers} layer at full width, no "
        f"MTP head; {n} MLA parameters) B={PATH_D_CHECK_B} S={PATH_D_S}: "
        f"through the kernels loss {loss_k!r}, MLA grad norm "
        f"{norm['auto']!r} ({s_k:.3f} s, peak "
        f"{peaks['auto'] / 1e9:.3f} GB, dry run "
        f"{sizes[(PATH_D_CHECK_B, 'auto')] / 1e9:.3f}); impl='ref' loss "
        f"{loss_r!r}, grad norm {norm['ref']!r} ({s_r:.3f} s, peak "
        f"{peaks['ref'] / 1e9:.3f} GB, dry run "
        f"{sizes[(PATH_D_CHECK_B, 'ref')] / 1e9:.3f}); relative "
        f"{json.dumps(rel)} (tolerance {TRAIN_TOL}); each leaf's scaled "
        f"error against impl='ref' {json.dumps(leaf_err)}")
    for key, r in rel.items():
        check(r <= TRAIN_TOL, f"path D: {key} through the kernels differs "
              f"from impl='ref' by {r!r} relative")
    del got, g_k, g_r, grads
    torch.cuda.empty_cache()

    batch = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        loss, grads = _mla_grad(model, batch, "auto")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = read_launches()
        check(launches == _expect(flash_attention=1, flash_attention_bwd=1),
              f"path D B={PATH_D_B} launches {launches}")
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads),
            "path D: a loss or gradient not finite")
        del grads
    peak = torch.cuda.max_memory_allocated()
    # the FA backward's two launches apart: path D's layer is FA_MLA's shape
    prof = _profile(f"path D profile {cfg.name} B={PATH_D_B}",
                    lambda: _mla_grad(model, batch, "auto"),
                    groups={"dkdv": ("bwd_kernel<float, 192, 128, false>",),
                            "dq": ("bwd_kernel<float, 192, 128, true>",)})
    check(prof["fa_bwd_ms"] > 0, "path D's profile finds no flash-attention "
          "backward kernel by name, though the backward launched")
    log(f"path D {cfg.name} B={PATH_D_B} S={PATH_D_S} (q/k [{PATH_D_B},"
        f"{PATH_D_S},{cfg.n_heads},192], v [..,128], causal): loss "
        f"{float(loss)!r}, call seconds (host clock after synchronize) "
        f"{[round(x, 6) for x in seconds]}; launches a call "
        f"{json.dumps(launches)}; peak {peak / 1e9:.3f} GB (dry run "
        f"{sizes[(PATH_D_B, 'auto')] / 1e9:.3f}); the FA backward "
        f"{prof['fa_bwd_ms']:.3f} ms, {prof['fa_bwd_ms'] / prof['busy_ms']:.4f}"
        f" of the profiled call's device time")
    del model, batch, tokens, one, loss
    torch.cuda.empty_cache()
    # row 2c's launches one by one at this layer's shape, both dtypes
    # (None: the profiler saw no device time, so not measured)
    split = {"float32": {"dkdv": prof["dkdv"] or None,
                         "dq": prof["dq"] or None},
             "bfloat16": _fa_bwd_mla_bf16_launches()}
    check(all(split["bfloat16"][key] is not None
              and split["bfloat16"][key] > 0 for key in ("dkdv", "dq")),
          f"row 2c's bf16 launches not measured: {split['bfloat16']}")
    log(f"row 2c at {FA_MLA[:6]}, each launch's device ms (one profiled "
        f"call; null: not measured): {json.dumps(split)}")
    log(f"phase seconds: 16d {time.perf_counter() - t_start:.1f}")
    return {"launches": launches, "seconds": seconds, "peak_gb": peak / 1e9,
            "profile": prof, "split": split}


# ---------------------------------------------------------------------- #
# 16e. path E: seamless-m4t-large-v2 trains whole on the card
# ---------------------------------------------------------------------- #
def _train_e_batches(cfg, n_micro: int, steps: int) -> list:
    """`_train_batches`' tokens with frame embeddings from a seeded
    generator, [n_micro, B / n_micro, Se, d] a step."""
    batches = _train_batches(cfg, TRAIN_E_B, TRAIN_E_S, n_micro, steps)
    for s, batch in enumerate(batches):
        batch["frame_embeds"] = _normal(
            (n_micro, TRAIN_E_B // n_micro, TRAIN_E_SE, cfg.d_model),
            seed=100 + s)
    return batches


def phase_train_e(cfg) -> dict:
    """Path E: a train step of 2 encoder and 2 decoder layers at full
    width through the kernels held against impl="ref" (whose encoder still
    launches the kernel: `_encode` takes no impl, as in the JAX package),
    then the whole model for 3 steps, its microbatch sized by the dry run
    first."""
    from repro_torch import models
    from repro_torch.optim.adamw import tree_map
    t_start = time.perf_counter()
    n_layers = cfg.n_encoder_layers + 2 * cfg.n_layers   # FA calls a micro
    batches = _train_e_batches(cfg, TRAIN_E_MICRO, TRAIN_E_STEPS)

    def grad_call(model, batch, impl):
        model.requires_grad_(True)
        loss = models.loss_fn(model, batch, impl=impl)
        return torch.autograd.grad(loss, list(model.parameters()))

    micro_b = TRAIN_E_B // TRAIN_E_MICRO
    dry = _dry_peak(cfg, micro_b, TRAIN_E_S, "auto", grad_call,
                    extra={"frame_embeds": (micro_b, TRAIN_E_SE,
                                            cfg.d_model)})
    # the step also holds the accumulator and AdamW's two moments
    # (float32, the parameters' size each)
    step_dry = dry + 3 * 4 * SEAMLESS_PARAMS
    log(f"path E sizing (fake tensors, the kernels as regions): one "
        f"microbatch of {micro_b} x {TRAIN_E_S} tokens and {TRAIN_E_SE} "
        f"frames, parameters and their gradients {dry / 1e9:.3f} GB; with "
        f"the accumulator and the moments {step_dry / 1e9:.3f} GB")

    small = dataclasses.replace(cfg, n_layers=TRAIN_E_CHECK_LAYERS,
                                n_encoder_layers=TRAIN_E_CHECK_LAYERS)
    base = models.Model(small, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    got = {}
    n_small = 3 * TRAIN_E_CHECK_LAYERS * TRAIN_E_MICRO
    n_enc = TRAIN_E_CHECK_LAYERS * TRAIN_E_MICRO
    for impl, n in (("auto", n_small), ("ref", n_enc)):
        model = models.Model(small, device="cuda", params=tree_map(
            lambda w: w.detach().clone(), models.param_tree(base)))
        model.requires_grad_(True)
        zero_launches()
        got[impl] = _run_steps(small, model, batches, TRAIN_E_MICRO, 1,
                               impl=impl)[0][0]
        launches = read_launches()
        want = _expect(flash_attention=n, flash_attention_bwd=n, adamw=1)
        check(launches == want, f"path E check impl={impl}: launches "
              f"{launches}, expected {want} (impl='ref' still launches the "
              f"kernel in the encoder)")
        del model
        torch.cuda.empty_cache()
    rel = {key: abs(got["auto"][key] - got["ref"][key]) / abs(got["ref"][key])
           for key in ("loss", "grad_norm")}
    log(f"train step check {cfg.name} {TRAIN_E_CHECK_LAYERS} + "
        f"{TRAIN_E_CHECK_LAYERS} layers at full width, B={TRAIN_E_B} "
        f"S={TRAIN_E_S} Se={TRAIN_E_SE} in {TRAIN_E_MICRO} microbatches: "
        f"kernels loss {got['auto']['loss']!r} grad_norm "
        f"{got['auto']['grad_norm']!r}; impl='ref' loss "
        f"{got['ref']['loss']!r} grad_norm {got['ref']['grad_norm']!r} "
        f"(its encoder through the kernel: {n_enc} + {n_enc} launches); "
        f"relative {json.dumps(rel)} (tolerance {TRAIN_TOL})")
    for key, r in rel.items():
        check(r <= TRAIN_TOL, f"path E check: {key} through the kernels "
              f"differs from impl='ref' by {r!r} relative")
    del base
    torch.cuda.empty_cache()

    model = _train_model(cfg, SEAMLESS_PARAMS)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    metrics, seconds = _run_steps(cfg, model, batches, TRAIN_E_MICRO,
                                  TRAIN_E_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = n_layers * TRAIN_E_MICRO * TRAIN_E_STEPS
    expect = _expect(flash_attention=n, flash_attention_bwd=n,
                     adamw=TRAIN_E_STEPS)
    check(launches == expect, f"path E launches {launches}, expected "
          f"{expect}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(losses)), f"path E losses not finite: {losses}")
    check(losses[-1] < losses[0], f"path E loss did not fall: {losses}")
    prof = _profile(f"train step profile {cfg.name}", lambda: _run_steps(
        cfg, model, batches[:1], TRAIN_E_MICRO, 1))
    check(prof["fa_bwd_ms"] > 0, "path E's profile finds no flash-attention "
          "backward kernel by name, though the backward launched")
    steady = float(np.mean(seconds[1:]))
    tokens = TRAIN_E_B * TRAIN_E_S
    log(f"train path E {cfg.name} ({SEAMLESS_PARAMS} float32 parameters, "
        f"{cfg.n_encoder_layers} + {cfg.n_layers} layers) B={TRAIN_E_B} "
        f"S={TRAIN_E_S} with {TRAIN_E_SE} frames in {TRAIN_E_MICRO} "
        f"microbatches, {TRAIN_E_STEPS} steps: losses "
        f"{[round(x, 6) for x in losses]}; launches {json.dumps(launches)}")
    log(f"train path E wall (host clock after synchronize): step seconds "
        f"{[round(s, 6) for s in seconds]}; steps 2-{TRAIN_E_STEPS} mean "
        f"{steady:.6f} s ({tokens / steady:.1f} tokens/s); peak device "
        f"memory {peak / 1e9:.3f} GB (dry run {step_dry / 1e9:.3f})")
    del model, batches
    torch.cuda.empty_cache()
    log(f"phase seconds: 16e {time.perf_counter() - t_start:.1f}")
    return {"launches": launches, "step_s": steady, "peak_gb": peak / 1e9,
            "profile": prof}


# ---------------------------------------------------------------------- #
# 15. the training CLI, resumed from its checkpoint
# ---------------------------------------------------------------------- #
def phase_train_cli(tmp: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")))))
    ck = os.path.join(tmp, "train_ckpt")
    outs = []
    for steps in (4, 6):
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "smollm-360m", "--reduced", "--steps", str(steps), "--batch",
             "8", "--seq", "256", "--log-every", "1", "--ckpt-dir", ck],
            capture_output=True, text=True, timeout=600, env=env)
        check(cli.returncode == 0, f"train CLI exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        outs.append((cli.stdout, time.perf_counter() - t0))
    check("resumed from step" not in outs[0][0],
          "the first train CLI run resumed")
    check("resumed from step 4" in outs[1][0] and "step     5 " in
          outs[1][0], f"the second train CLI run did not resume: "
          f"{outs[1][0][-500:]}")
    for out, secs in outs:
        log(f"train CLI ({secs:.1f} s with the process start): "
            + " | ".join(out.strip().splitlines()[-3:]))


# ---------------------------------------------------------------------- #
# 17. the capture path: program -> IR graph -> NDJSON, and a full-width
# train step planned on the card
# ---------------------------------------------------------------------- #
def _same_labelled(a, b) -> bool:
    return _same_graph(a, b) and list(a.node_labels) == list(b.node_labels)


def _graph_diff(a, b) -> str:
    """Where two captured graphs part: their sizes, the labels one has
    more of than the other, and the first vertex whose label differs."""
    import collections
    ca, cb = (collections.Counter(g.node_labels) for g in (a, b))
    la, lb = list(a.node_labels), list(b.node_labels)
    i = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
             min(len(la), len(lb)))
    return (f"{a.n} vs {b.n} vertices, {a.num_edges} vs {b.num_edges} "
            f"edges; labels only in the first {dict(ca - cb)}, only in the "
            f"second {dict(cb - ca)}; first differing vertex {i}: "
            f"{la[max(0, i - 3):i + 4]} vs {lb[max(0, i - 3):i + 4]}")


def _capture_demos(tmp: str) -> None:
    """(a) `python -m repro_torch.trace record` on the card, one process
    per demo program, all started together; each trace ingests to the
    in-process capture's graph on the card and on the host."""
    from repro_torch.core.op_graph import trace_to_graph
    from repro_torch.trace import DEMO_PROGRAMS, demo_program, ingest_trace
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")))))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.trace", "record",
         os.path.join(tmp, f"{name}.ndjson"), "--program", name],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name in sorted(DEMO_PROGRAMS)}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        check(proc.returncode == 0, f"record {name} exited "
              f"{proc.returncode}: {err[-2000:]}")
    t_cli = time.perf_counter() - t0
    for name in procs:
        g = ingest_trace(os.path.join(tmp, f"{name}.ndjson"),
                         weight_model="bytes", keep_labels=True)
        on = {}
        for dev in ("cuda", "cpu"):
            fn, args = demo_program(name, device=dev)
            on[dev] = trace_to_graph(fn, *args, name=name)
        check(_same_labelled(g, on["cuda"]) and _same_labelled(g, on["cpu"]),
              f"record {name}: the trace, the card's and the host's "
              f"captures differ: {_graph_diff(g, on['cuda'])}; "
              f"{_graph_diff(g, on['cpu'])}")
        log(f"capture demo {name}: {g.n} vertices, {g.num_edges} edges, "
            f"{g.w.sum():.0f} bytes; the recorded trace, the card's and the "
            f"host's graphs bit-identical (labels included)")
    log(f"capture demos: 3 record processes on the card in {t_cli:.1f} s "
        f"(with the process starts)")


def _capture_reduced_model() -> dict:
    """(b) A reduced recurrentgemma-9b forward through the kernels: the
    card's graph is the host's, and its kernel vertices are the launches
    read around the same call."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.op_graph import trace_to_graph
    cfg = reduced_config(get_config(ARCH))
    cpu = models.Model(cfg, device="cpu", generator=torch.Generator()
                       .manual_seed(0))
    gpu = models.from_jax_params(cfg, models.to_jax_params(cpu),
                                 device="cuda")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, CAPTURE_MODEL_TOKENS))

    def fwd(model, batch):
        return models.forward(model, batch, impl="cuda")[0]

    with torch.no_grad():
        want = trace_to_graph(fwd, cpu, {"tokens": toks}, name=cfg.name)
        zero_launches()
        got = trace_to_graph(fwd, gpu, {"tokens": toks.cuda()},
                             name=cfg.name)
        torch.cuda.synchronize()
        launches = read_launches()
    check(_same_labelled(got, want), f"reduced {cfg.name}: the card's graph "
          f"differs from the host's: {_graph_diff(got, want)}")
    labels = {k: got.node_labels.count(k) for k in launches}
    check(labels == launches and launches["flash_attention"] > 0
          and launches["rglru"] > 0, f"reduced {cfg.name}: kernel vertices "
          f"{labels}, launches {launches}")
    log(f"capture reduced {cfg.name} ({cfg.n_layers} layers, tokens "
        f"{CAPTURE_MODEL_TOKENS}): {got.n} vertices, {got.num_edges} edges, "
        f"the card's graph bit-identical to the host's; kernel vertices = "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


def _top_labels(g, top: int = 10) -> list:
    import collections
    return collections.Counter(g.node_labels).most_common(top)


def phase_capture() -> dict:
    """(c) A full-width smollm-360m train step (path A's shape) captured on
    the card, against an uncaptured step from the same seed; (d)
    `optimal_parallelism` and `plan_step` on it with `backend="cuda"`,
    held against `fast`."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import plan_graph, run_pipeline
    from repro_torch.core.cuda import segsum
    from repro_torch.core.op_graph import capture
    from repro_torch.core.planner import optimal_parallelism, plan_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as tmp:
        _capture_demos(tmp)
    reduced_launches = _capture_reduced_model()

    cfg = get_config(TRAIN_A_ARCH)
    batch = _train_batches(cfg, TRAIN_A_B, TRAIN_A_S, TRAIN_A_MICRO, 1)[0]
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_A_STEPS)
    step = make_train_step(cfg, opt_cfg,
                           ParallelConfig(microbatches=TRAIN_A_MICRO),
                           impl="cuda")
    runs = {}
    for captured in (False, True):
        model = _train_model(cfg, TRAIN_A_PARAMS)
        opt = adamw_init(models.param_tree(model), opt_cfg)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if captured:
            g, (_, _, metrics) = capture(step, model, opt, batch,
                                         name="smollm-360m train step")
        else:
            _, _, metrics = step(model, opt, batch)
        torch.cuda.synchronize()
        runs[captured] = {
            "s": time.perf_counter() - t0, "launches": read_launches(),
            "loss": metrics["loss"].item(),
            "params": [p.detach().clone() for p in model.parameters()]}
        if not captured:
            del model, opt
            torch.cuda.empty_cache()
    plain, capt = runs.pop(False), runs.pop(True)
    check(capt["loss"] == plain["loss"] and all(
        torch.equal(a, b) for a, b in zip(capt["params"], plain["params"])),
          f"the captured step differs from the uncaptured one: loss "
          f"{capt['loss']!r} against {plain['loss']!r}")
    del plain["params"], capt["params"]
    n = TRAIN_A_MICRO * cfg.n_layers
    expect = _expect(flash_attention=n, flash_attention_bwd=n, adamw=1)
    labels = {k: g.node_labels.count(k) for k in expect}
    check(capt["launches"] == plain["launches"] == expect == labels,
          f"capture path: kernel vertices {labels}, launches "
          f"{capt['launches']} (uncaptured {plain['launches']}), expected "
          f"{expect}")
    # the backward's operators ran on autograd's device thread: the
    # capture saw them there
    n_silu = g.node_labels.count("silu_backward")
    check(n_silu == n, f"capture path: {n_silu} silu_backward vertices, "
          f"expected {n}")
    log(f"capture path {cfg.name} train step ({TRAIN_A_PARAMS} float32 "
        f"parameters, B={TRAIN_A_B} S={TRAIN_A_S} in {TRAIN_A_MICRO} "
        f"microbatches): {g.n} vertices, {g.num_edges} edges, "
        f"{g.w.sum():.0f} bytes on the edges; loss {capt['loss']!r} and "
        f"every parameter bit-identical to an uncaptured step from the same "
        f"seed; kernel vertices = launches {json.dumps(labels)}")
    log(f"capture path top labels: {json.dumps(_top_labels(g))}")
    # the wall in turns: uncaptured and captured above (each a fresh
    # model's first step), then captured and uncaptured on the second model
    walls = [plain["s"], capt["s"]]
    for captured in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if captured:
            capture(step, model, opt, batch)
        else:
            step(model, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"capture path wall (host clock after synchronize, one step each; "
        f"uncaptured, captured on fresh models, then captured, uncaptured): "
        f"{[round(t, 6) for t in walls]} s; captured / uncaptured "
        f"{(walls[1] + walls[2]) / (walls[0] + walls[3]):.4f}")

    # (d) plan the step; the model and its state move on one step per capture
    segsum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, reports = optimal_parallelism(step, model, opt, batch,
                                        candidates=CAPTURE_P,
                                        backend="cuda")
    t_opt = time.perf_counter() - t0
    opt_launches = segsum.launches
    check(opt_launches > 0, "optimal_parallelism launched no segment sum")
    gp = reports[0].graph
    check(_same_labelled(gp, g), f"the step's graph changed between "
          f"steps: {_graph_diff(gp, g)}")
    times = {}
    for rep in reports:
        p = rep.p
        t0 = time.perf_counter()
        fast = plan_graph(gp, p, backend="fast")
        t_fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        cuda = plan_graph(gp, p, backend="cuda")
        torch.cuda.synchronize()
        t_cuda = time.perf_counter() - t0
        for field in CUT_FIELDS:
            a, b = getattr(rep.cut, field), getattr(fast.cut, field)
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"capture plan p={p}: {field} differs from fast")
        for a, b, what in ((rep.exec_time, fast.exec_time, "exec_time"),
                           (rep.comm_bytes, fast.comm_bytes, "comm_bytes"),
                           (cuda.exec_time, rep.exec_time, "a second plan")):
            check(_close(a, b), f"capture plan p={p}: {what} {a!r} vs {b!r}")
        _compare(run_pipeline(gp, p, "wb_libra", backend="cuda"),
                 run_pipeline(gp, p, "wb_libra", backend="fast"), p)
        times[p] = (t_cuda, t_fast)
        log(f"capture plan p={p}: exec_time {rep.exec_time!r}, comm_bytes "
            f"{rep.comm_bytes!r}, replication_factor "
            f"{rep.cut.replication_factor!r}: bit-identical to fast (cut, "
            f"replica CSR, core_of); plan seconds (host clock) cuda "
            f"{t_cuda:.6f}, fast {t_fast:.6f}")
    check(best == min(reports, key=lambda r: r.exec_time).p,
          "optimal_parallelism did not pick the argmin")
    rep8 = plan_step(step, model, opt, batch, p=8, backend="cuda")
    want8 = next(r for r in reports if r.p == 8)
    check(_same_labelled(rep8.graph, gp)
          and rep8.summary() == want8.summary()
          and np.array_equal(rep8.cut.assignment, want8.cut.assignment)
          and rep8.exec_time == want8.exec_time,
          "plan_step(p=8) differs from optimal_parallelism's p=8 report")
    log(f"capture plan: optimal_parallelism over {list(CAPTURE_P)} picks "
        f"p={best} in {t_opt:.3f} s (one captured step and "
        f"{len(CAPTURE_P)} plans), {opt_launches} segment-sum launches; "
        f"plan_step(p=8) equals its p=8 report")
    del model, opt
    torch.cuda.empty_cache()
    return {"launches_plan": opt_launches, "launches_step": labels,
            "launches_reduced": reduced_launches, "best_p": best,
            "plan_s": times, "walls": walls}


# ---------------------------------------------------------------------- #
# 18. mesh and cost on the card
# ---------------------------------------------------------------------- #
_DRY_RUN_CELL = """
import json, sys
from repro_torch.launch.cells import enumerate_cells
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import fake_world, make_production_mesh
arch, shape, n_layers, out = sys.argv[1:]
cell, = [c for c in enumerate_cells() if (c.arch, c.shape) == (arch, shape)]
with fake_world(256):
    mesh = make_production_mesh(device_type="cpu")
    rec = run_cell(cell, mesh, False, n_layers=int(n_layers) or None)
with open(out, "w") as f:
    json.dump([rec], f)
"""


def _start_mesh_cells(tmp: str) -> list:
    """18d's dry runs, one `launch.dryrun.run_cell` on the fake 16x16 mesh
    each, in subprocesses on the CPU started together: [(cell, output
    path, process, start)]."""
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src"),
           "OMP_NUM_THREADS": "1"}
    runs = []
    for arch, shape, n_layers in MESH_CELLS:
        out = os.path.join(tmp, f"{arch}_{shape}.json")
        cmd = [sys.executable, "-c", _DRY_RUN_CELL, arch, shape,
               str(n_layers or 0), out]
        runs.append(((arch, shape, n_layers), out, subprocess.Popen(
            cmd, env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), time.perf_counter()))
    return runs


def _finish_mesh_cells(runs: list) -> None:
    try:
        for (arch, shape, n_layers), out, proc, t0 in runs:
            text = proc.communicate(timeout=MESH_CELLS_TIMEOUT)[0]
            check(proc.returncode == 0, f"dry run {arch}/{shape}: exit "
                  f"{proc.returncode}: {text[-2000:]}")
            rec = json.load(open(out))[0]
            check(rec["ok"] is True and rec["mesh"] == "16x16",
                  f"dry run {arch}/{shape}: {rec}")
            mem, coll = rec["memory"], rec["collectives"]
            check(mem["argument_bytes"] > 0 and rec["flops"] > 0
                  and coll["total_bytes"] > 0,
                  f"dry run {arch}/{shape}: no work recorded: {rec}")
            depth = (f"depth cut to {n_layers} layers" if n_layers
                     else "whole")
            log(f"mesh 18d dry run {arch}/{shape} on the fake 16x16 mesh "
                f"({depth}, {rec['parallel']['microbatches']} microbatches; "
                f"rank 0 of 256): argument {mem['argument_bytes']} bytes, "
                f"temp {mem['temp_bytes']} bytes, {rec['flops']:.6e} FLOPs, "
                f"{rec['hlo_hbm_bytes']:.6e} bytes, collectives "
                f"{coll['total_bytes']:.6e} bytes "
                f"{json.dumps(coll['counts'])}; {rec['lower_s']} s in the "
                f"run, {time.perf_counter() - t0:.1f} s wall")
    finally:
        for _, _, proc, _ in runs:
            proc.kill()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _class_device_ms(prof) -> dict:
    """Device ms by operator class (`hlo_cost.op_class` of each ATen
    operator's own kernels; the port's kernels by their names)."""
    from torch.autograd import DeviceType

    from repro_torch.analysis.hlo_cost import op_class
    out: dict = {}
    for ev in prof.key_averages():
        dev_ms = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if dev_ms <= 0:
            continue
        if ev.device_type == DeviceType.CUDA:
            if "(anonymous namespace)::" in ev.key:
                out["kernel"] = out.get("kernel", 0.0) + dev_ms
            continue
        if ev.key.startswith("aten::"):
            cls = op_class(ev.key[len("aten::"):])
            out[cls] = out.get(cls, 0.0) + dev_ms
    return out


def phase_mesh() -> dict:
    """18. (a) path A's step on a (1, 1) DeviceMesh against the unsharded
    step; (b) its cost analysis against FlopCounterMode and the
    profiler; (c) the dry run of the same step against the card's
    memory; (d) dry runs of cells on the fake 16x16 mesh, in
    subprocesses started first; (e) the census step captured on the card
    against the host (ROADMAP.md queue 3, item 2)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import models
    from repro_torch.analysis import analyze_program
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.cells import lower_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    cells = _start_mesh_cells(tmp)
    dist.init_process_group("cuda:nccl,cpu:gloo", store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        cfg = get_config(TRAIN_A_ARCH)
        batch = _train_batches(cfg, TRAIN_A_B, TRAIN_A_S, TRAIN_A_MICRO,
                               1)[0]
        opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                              total_steps=TRAIN_A_STEPS)
        par = ParallelConfig(microbatches=TRAIN_A_MICRO)
        # (a) the unsharded step, its memory, then the sharded one
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = _train_model(cfg, TRAIN_A_PARAMS)
        opt = adamw_init(models.param_tree(model), opt_cfg)
        card_args = _nbytes(tree_leaves(models.param_tree(model))
                            + tree_leaves(opt) + list(batch.values()))
        torch.cuda.synchronize()
        args_alloc = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        _, _, m_plain = make_train_step(cfg, opt_cfg, par)(model, opt, batch)
        torch.cuda.synchronize()
        s_plain = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches_plain = read_launches()
        want = [p.detach().clone() for p in
                tree_leaves(models.param_tree(model))]
        want_m = {k: m_plain[k].item() for k in ("loss", "grad_norm")}
        del model, opt, m_plain
        torch.cuda.empty_cache()

        mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
        model = _train_model(cfg, TRAIN_A_PARAMS)
        prepared = lower_step(model, "train", mesh, par=par,
                              opt_cfg=opt_cfg, batch=batch)
        check(prepared.argument_bytes == card_args,
              f"mesh 18a: the placed arguments hold "
              f"{prepared.argument_bytes} bytes, the unsharded step's "
              f"{card_args}")
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = prepared.run()
        torch.cuda.synchronize()
        s_mesh = time.perf_counter() - t0
        launches = read_launches()
        n = TRAIN_A_MICRO * cfg.n_layers
        # the mesh's DTensor leaves keep AdamW's tree path
        expect = _expect(flash_attention=n, flash_attention_bwd=n)
        check(launches == expect and launches_plain == dict(expect, adamw=1),
              f"mesh 18a: launches {launches} on the mesh, "
              f"{launches_plain} without, expected {expect} and one fused "
              f"AdamW without")
        got = [_full(p).detach() for p in
               tree_leaves(models.param_tree(model))]
        got_m = {k: _full(m[k]).item() for k in ("loss", "grad_norm")}
        identical = all(torch.equal(a, b) for a, b in zip(got, want)) \
            and got_m == want_m
        worst = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(got, want))
        for key in ("loss", "grad_norm"):
            rel = abs(got_m[key] - want_m[key]) / abs(want_m[key])
            check(rel <= TRAIN_TOL, f"mesh 18a: {key} {got_m[key]!r} on "
                  f"the mesh, {want_m[key]!r} without ({rel!r})")
        check(worst <= TRAIN_TOL, f"mesh 18a: a parameter differs by "
              f"{worst!r} of max(1, max|p|)")
        placements = sorted({str(tuple(p.placements)) for p in
                             tree_leaves(models.param_tree(model))})
        log(f"mesh 18a {cfg.name} train step on a (1, 1) DeviceMesh "
            f"('data', 'model'), every parameter a DTensor placed by "
            f"param_specs ({placements}): launches {json.dumps(launches)} "
            f"= the unsharded step's but its fused AdamW (the mesh's "
            f"DTensors take the tree path); loss {got_m['loss']!r} "
            f"(unsharded {want_m['loss']!r}), grad_norm "
            f"{got_m['grad_norm']!r} ({want_m['grad_norm']!r}); "
            f"parameters {'' if identical else 'not '}bit-identical "
            f"(worst {worst!r} of max(1, max|p|)); step seconds (host "
            f"clock) {s_mesh:.6f} on the mesh, {s_plain:.6f} without")
        del got, want
        # (b) the cost of one more step, beside FlopCounterMode and the
        # profiler's device time by class
        with prepared.context(), FlopCounterMode(display=False) as fc, \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            cost = analyze_program(prepared.step, *prepared.args)
            torch.cuda.synchronize()
        mm = cost.by_class.get("mm", {}).get("flops", 0.0)
        counted = fc.get_total_flops()
        check(mm == counted, f"mesh 18b: analyze_program's mm family "
              f"{mm!r} FLOPs, FlopCounterMode {counted!r}")
        dev = _class_device_ms(prof)
        rows = []
        for cls, row in sorted(cost.by_class.items(),
                               key=lambda kv: -kv[1]["flops"]):
            ms = dev.get(cls, 0.0)
            rate = row["flops"] / ms * 1e-9 if ms else 0.0
            rows.append(f"{cls}: {row['count']} ops, {row['flops']:.6e} "
                        f"FLOPs, {row['bytes']:.6e} bytes, {ms:.3f} device "
                        f"ms ({rate:.1f} TFLOP/s)" if ms else
                        f"{cls}: {row['count']} ops, {row['flops']:.6e} "
                        f"FLOPs, {row['bytes']:.6e} bytes, no device time")
        log(f"mesh 18b analyze_program of the step: {cost.flops:.6e} FLOPs "
            f"(mm family {mm:.6e} = FlopCounterMode's {counted:.6e}), "
            f"{cost.hbm_bytes:.6e} bytes, collectives "
            f"{json.dumps(cost.collective_counts)}; by class: "
            + "; ".join(rows) + f"; device ms by class "
            f"{json.dumps({k: round(v, 3) for k, v in dev.items()})}")
        del model, opt, prepared, m
        torch.cuda.empty_cache()

        # (c) the dry run of path A's step at its batch, (1, 1) mesh
        cpu_mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data",
                                                             "model"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            fmodel = models.Model(cfg, device="cpu").requires_grad_(True)
            fbatch = {k: torch.empty(v.shape, dtype=v.dtype)
                      for k, v in batch.items()}
        t0 = time.perf_counter()
        dry = lower_step(fmodel, "train", cpu_mesh, par=par, opt_cfg=opt_cfg,
                         batch=fbatch, impl="cuda", fake_mode=fake)
        with dry.context():
            dcost = analyze_program(dry.step, *dry.args)
        s_dry = time.perf_counter() - t0
        check(dry.argument_bytes == card_args,
              f"mesh 18c: the dry run's argument bytes "
              f"{dry.argument_bytes}, the card's {card_args}")
        dry_peak = dry.argument_bytes + dcost.peak_bytes
        log(f"mesh 18c dry run of the step (fake tensors, (1, 1) mesh, the "
            f"kernels as regions): argument bytes {dry.argument_bytes} = "
            f"the card's params, moments, step and batch {card_args} "
            f"(allocated: {args_alloc}); peak {dry_peak} bytes "
            f"(arguments + temp {int(dcost.peak_bytes)}) against "
            f"max_memory_allocated {peak} (ratio {dry_peak / peak:.4f}); "
            f"FLOPs {dcost.flops:.6e} (the card's step {cost.flops:.6e}); "
            f"{s_dry:.1f} s on the host")
        del fmodel, dry
    finally:
        dist.destroy_process_group()
    # (e) the census step captured on the card and on the host
    census = _census_on_both()
    from repro_torch.analysis.hlo_cost import RWKV6_CKPT_STEPS
    from repro_torch.kernels import rwkv6
    check(rwkv6.ckpt_steps() == RWKV6_CKPT_STEPS, f"mesh: the dry run "
          f"allocates RWKV6 checkpoints every {RWKV6_CKPT_STEPS} steps, "
          f"the kernel writes them every {rwkv6.ckpt_steps()}")
    t_d = time.perf_counter()
    _finish_mesh_cells(cells)
    log(f"phase seconds: 18 {time.perf_counter() - t_start:.1f} (18d's "
        f"wait after 18a-c, e: {time.perf_counter() - t_d:.1f})")
    return {"launches": launches, "census": census}


def _census_on_both() -> dict:
    """`tools/capture_census.py`'s step (smollm-360m at full depth and the
    tests' reduced width, 2 microbatches of 2 x 64, impl="cuda") captured
    on the card and on the host (ROADMAP.md queue 3, item 2): the card's
    kernel vertices equal its launches, and the two graphs differ only by
    the flash-attention backward, one `flash_attention_bwd` vertex a call
    on the card where the host runs its plain version's operators
    (`CENSUS_PLAIN_BWD`, the account PERF.md gives), and by AdamW, one
    `adamw` vertex on the card where the host runs the tree path's
    operators (`adamw_tree_labels`: the same leaves' update captured
    alone)."""
    import collections

    from capture_census import adamw_tree_labels, census_step
    from repro_torch.core.op_graph import capture
    step, args = census_step(device="cuda")
    zero_launches()
    card, _ = capture(step, *args)
    launches = read_launches()
    del step, args
    step, args = census_step(device="cpu")
    host, _ = capture(step, *args)
    opt_labels = adamw_tree_labels(census_step(device="cpu")[1])
    labels = {name: collections.Counter(g.node_labels)
              for name, g in (("card", card), ("host", host))}
    calls = labels["card"]["flash_attention"]
    only_host = labels["host"] - labels["card"]
    only_card = labels["card"] - labels["host"]
    log(f"mesh 18e census step: the card {card.n} vertices, "
        f"{card.num_edges} edges; the host {host.n}, {host.num_edges}: "
        f"only there {json.dumps(dict(only_host))}, only on the card "
        f"{json.dumps(dict(only_card))} ({calls} flash-attention calls, "
        f"launches {json.dumps(launches)})")
    check(calls > 0 and launches == _expect(
        flash_attention=calls, flash_attention_bwd=labels["card"][
            "flash_attention_bwd"], adamw=labels["card"]["adamw"]),
          f"mesh 18e: the card's graph has {calls} flash-attention "
          f"vertices, its run launched {launches}")
    want = collections.Counter({k: calls * n
                                for k, n in CENSUS_PLAIN_BWD.items()})
    want.update(opt_labels)
    check(only_card == collections.Counter(flash_attention_bwd=calls,
                                           adamw=1)
          and only_host == want,
          f"mesh 18e: the graphs differ beyond the flash-attention "
          f"backward and AdamW: only on the host {dict(only_host)} (want "
          f"{dict(want)}), only on the card {dict(only_card)}")
    log(f"mesh 18e: AdamW one `adamw` vertex on the card where the host's "
        f"tree path makes {sum(opt_labels.values())}")
    return {"card": card.n, "host": host.n, "calls": calls,
            "edges": card.num_edges}


# ---------------------------------------------------------------------- #
# 11. timing of the segment sum at the partition path's largest shapes
# ---------------------------------------------------------------------- #
def _cuda_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around `reps` calls, after a
    warm-up.  The card first sleeps ~0.1 s, so the host has queued every
    call before the card reaches the first: the events measure the card's
    work, not the host's dispatch of a call that takes microseconds."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _host_ms(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _bound(work: tuple, ops_per_s: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the function's work, (its
    operations, the bytes it moves) as `repro_torch.analysis.hlo_cost`
    and `repro_torch.core.cuda.cost` count them, over the card's memory
    rate and over `ops_per_s`."""
    ops, nbytes = work
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _segsum_bound(m: int, nseg: int, value_size: int,
                  id_size: int) -> tuple[float, str]:
    """One segment sum: the values and ids read once, the sums written
    once, one float64 addition a value."""
    from repro_torch.core.cuda.cost import segment_sum_work
    return _bound(segment_sum_work(m, nseg, value_size, id_size),
                  PEAK_F64_OPS_PER_S)


def _time_shape(name: str, data: torch.Tensor, ids: torch.Tensor,
                nseg: int) -> dict:
    from repro_torch.core.cuda import segsum
    m = data.numel()
    ms = _cuda_ms(lambda: segsum.segment_sum(data, ids, nseg))
    plain_ms = _host_ms(lambda: segsum.segment_sum_plain(data, ids, nseg))
    library_ms = _cuda_ms(lambda: torch.zeros(
        nseg, dtype=data.dtype, device=data.device).index_add_(0, ids, data))
    bound_ms, bound_by = _segsum_bound(m, nseg, data.element_size(),
                                       ids.element_size())
    return {"shape": f"{name}: m={m} segments={nseg} {data.dtype}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_timing(runs: dict, max_abs_err: float) -> dict:
    from repro_torch.core import vertex_bytes_model
    from repro_torch.core.cuda import metrics as cm
    from repro_torch.core.cuda import segsum
    dev = torch.device("cuda")
    part, g = runs[1024]["part"], runs[1024]["graph"]
    p = part.p
    # the m-element loads sum of _finalize: keyed_sum(assignment, w, p)
    a = cm.as_tensor(part.assignment, torch.int64, dev)
    keys, order = torch.sort(a, stable=True)
    w = cm.as_tensor(g.w, torch.float64, dev)[order].contiguous()
    loads = _time_shape("loads sum", w, keys, p)
    # the p^2-key star-comm sum of the interaction graphs
    owners, replicas, b = cm.star_triples(
        *part.replica_csr(), vertex_bytes_model(g), dev)
    keys, order = torch.sort(owners * p + replicas, stable=True)
    star = _time_shape("star-comm sum", b[order].contiguous(), keys, p * p)
    entry = {"name": "segment_sum", "route": "cuda",
             "source": "src/repro_torch/csrc/segsum.cu",
             "replaces": "src/repro/core/pallas/segsum.py:138",
             "launches": runs[1024]["launches"],
             "launches_p64": runs[64]["launches"],
             "max_abs_err": max_abs_err,
             **{k: loads[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "shape")},
             "plain_on": "host CPU, copies to and from the card included",
             "at_shapes": [loads, star]}
    check(segsum.launches > 0, "timing launched no kernel")
    return {"kernels": [entry]}


# ---------------------------------------------------------------------- #
# 11b. timing of the model kernels at the serving shapes
# ---------------------------------------------------------------------- #
def _fa_bound(case) -> tuple[float, str, float]:
    """Least time for one flash attention call: its unmasked (query, key)
    pairs at 2*(Dqk + Dv) operations each (4*D at equal head dims) on the
    tensor cores (float32 as three TF32 products, the split that meets the
    float32 tolerance; bf16 at the bf16 rate), against q, k, v read once
    and the output written once over the memory rate.  Also the
    operations' time on the CUDA cores' float32 peak, the bound of the
    kernel's first, CUDA-core design."""
    from repro_torch.analysis.hlo_cost import attention_work
    B, Sq, Sk, Hq, Hkv, D, causal, window, _, dt = case
    Dqk, Dv = _head_dims(D)
    size = torch.tensor([], dtype=getattr(torch, dt)).element_size()
    return _tensor_core_bound(attention_work(B, Sq, Sk, Hq, Hkv, Dqk, Dv,
                                             causal, window, size), dt)


def _tensor_core_bound(work: tuple, dt: str) -> tuple[float, str, float]:
    """`_bound` on the tensor cores (float32 as three TF32 products, bf16
    at the bf16 rate), and the operations' time on the CUDA cores'
    float32 peak."""
    ops, nbytes = work
    if dt == "float32":
        bound_ms, by = _bound((3 * ops, nbytes), PEAK_TF32_OPS_PER_S)
    else:
        bound_ms, by = _bound((ops, nbytes), PEAK_BF16_OPS_PER_S)
    return bound_ms, by, ops / PEAK_F32_OPS_PER_S * 1e3


def _fa_timed(case, reps: int = 10) -> dict:
    """The forward kernel at `case` on the card's clock, held against the
    plain version (FA_TOL), beside its bound and one
    `scaled_dot_product_attention` call on the same inputs (an explicit
    mask with a window, `is_causal` without, `enable_gqa` for a GQA
    group)."""
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    B, Sq, Sk, Hq, Hkv, D, causal, window, cap, dt = case
    q, k, v = _fa_inputs(case)

    def call():
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cap)
    err = float((call().float() - fa.flash_attention_plain(
        q, k, v, causal=causal, window=window, softcap=cap).float()
    ).abs().max())
    check(err < FA_TOL[dt], f"flash_attention at {case}: error {err!r}")
    ms = _cuda_ms(call, reps=reps)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = {"enable_gqa": Hq != Hkv}
    if window is not None:
        pos_q = torch.arange(Sq, device="cuda")[:, None]
        pos_k = torch.arange(Sk, device="cuda")[None, :]
        kw["attn_mask"] = (pos_k <= pos_q) & (pos_k > pos_q - window)
    elif causal:
        kw["is_causal"] = True
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **kw), reps=reps)
    bound_ms, by, _ = _fa_bound(case)
    Dqk, Dv = _head_dims(D)
    shape = (f"q [{B},{Sq},{Hq},{Dqk}] k [{B},{Sk},{Hkv},{Dqk}] v "
             f"[{B},{Sk},{Hkv},{Dv}] {dt}, "
             + ("causal" if causal else "no mask")
             + (f", window {window}" if window is not None else ""))
    log(f"timing flash_attention at {shape}: kernel {ms!r} ms, bound "
        f"{bound_ms!r} ms ({by}), library {library_ms!r} ms, max abs "
        f"error {err!r}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "max_abs_err": err, "shape": shape}


def phase_model_timing(prefill: dict, errs: dict) -> list[dict]:
    from repro_torch.analysis.hlo_cost import rglru_work
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    F = torch.nn.functional
    causal, window, cap, _ = FA_MAIN[6:]
    q, k, v = _fa_inputs(FA_MAIN)
    ms = _cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                             window=window, softcap=cap),
                  reps=10)
    plain_ms = _host_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window, softcap=cap))
    # the yardstick: one PyTorch call with an explicit causal+window mask
    S = FA_MAIN[1]
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=10)
    bound_ms, bound_by, cuda_core_ms = _fa_bound(FA_MAIN)
    fa_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "body": "fa_fwd_kernel (wgmma) at every instantiation; at float32 "
                "(256, 256), this shape, two warpgroups of 64 q rows and "
                "32-key tiles with K and V streamed as 128-column halves",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": prefill["launches"]["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_cuda_core_ms": cuda_core_ms,
        "library_ms": library_ms,
        "shape": "q [2,3072,16,256] k/v [2,3072,1,256] float32, causal, "
                 "window 2048",
        "library": "scaled_dot_product_attention, explicit bool mask, "
                   "enable_gqa",
        "plain_on": "the card (attention_ref: einsum, mask, softmax)"}
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    # dbrx-132b's prefill shape (PR 22): 48 heads on 8, head_dim 128
    q, k, v = _fa_inputs(FA_DBRX)
    ms_dbrx = _cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                       reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_dbrx = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    bound_dbrx, by_dbrx, _ = _fa_bound(FA_DBRX)
    fa_entry.update({
        "ms_dbrx": ms_dbrx, "bound_dbrx_ms": bound_dbrx,
        "bound_dbrx_by": by_dbrx, "library_dbrx_ms": library_dbrx,
        "max_abs_err_dbrx": errs["flash_attention_dbrx"],
        "shape_dbrx": "q [2,2048,48,128] k/v [2,2048,8,128] float32, "
                      "causal (library: is_causal, enable_gqa)"})
    log(f"timing flash_attention at {fa_entry['shape_dbrx']}: kernel "
        f"{ms_dbrx!r} ms, bound {bound_dbrx!r} ms ({by_dbrx}), library "
        f"{library_dbrx!r} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # deepseek-v3's MLA prefill shape: q/k head dim 192, v 128
    q, k, v = _fa_inputs(FA_MLA)
    ms_mla = _cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                      reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_mla = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=10)
    bound_mla, by_mla, cuda_core_mla = _fa_bound(FA_MLA)
    fa_entry.update({
        "ms_mla": ms_mla, "bound_mla_ms": bound_mla,
        "bound_mla_by": by_mla, "bound_mla_cuda_core_ms": cuda_core_mla,
        "library_mla_ms": library_mla,
        "max_abs_err_mla": errs["flash_attention_mla"],
        "shape_mla": "q/k [2,2048,128,192] v [2,2048,128,128] float32, "
                     "causal (library: is_causal)"})
    log(f"timing flash_attention at {fa_entry['shape_mla']}: kernel "
        f"{ms_mla!r} ms, bound {bound_mla!r} ms ({by_mla}; on the CUDA "
        f"cores {cuda_core_mla!r}), library {library_mla!r} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # seamless's encoder self-attention (PR 24): no mask, 16 heads of 64
    q, k, v = _fa_inputs(FA_SEAMLESS)
    ms_sm = _cuda_ms(lambda: fa.flash_attention(q, k, v, causal=False),
                     reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_sm = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt), reps=10)
    bound_sm, by_sm, cuda_core_sm = _fa_bound(FA_SEAMLESS)
    fa_entry.update({
        "ms_seamless": ms_sm, "bound_seamless_ms": bound_sm,
        "bound_seamless_by": by_sm,
        "bound_seamless_cuda_core_ms": cuda_core_sm,
        "library_seamless_ms": library_sm,
        "max_abs_err_seamless": errs["flash_attention_seamless"],
        "shape_seamless": "q/k/v [2,2048,16,64] float32, no mask "
                          "(library: no mask)"})
    log(f"timing flash_attention at {fa_entry['shape_seamless']}: kernel "
        f"{ms_sm!r} ms, bound {bound_sm!r} ms ({by_sm}; on the CUDA cores "
        f"{cuda_core_sm!r}), library {library_sm!r} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # the four shapes in bf16, then training path A's layer and seamless's
    # decode cross attention (Sq = 1) in float32, each with its bound and
    # one scaled_dot_product_attention call on the same inputs
    for suffix, case in (("bf16", FA_MAIN), ("dbrx_bf16", FA_DBRX),
                         ("mla_bf16", FA_MLA), ("seamless_bf16", FA_SEAMLESS),
                         ("path_a", FA_PATH_A), ("decode", FA_DECODE)):
        if suffix.endswith("bf16"):
            case = case[:9] + ("bfloat16",)
        r = _fa_timed(case)
        fa_entry.update({
            f"ms_{suffix}": r["ms"], f"bound_{suffix}_ms": r["bound_ms"],
            f"bound_{suffix}_by": r["bound_by"],
            f"library_{suffix}_ms": r["library_ms"],
            f"max_abs_err_{suffix}": r["max_abs_err"],
            f"shape_{suffix}": r["shape"]})

    B, S, D = RG_MAIN
    x, a, h0 = _rg_inputs(B, S, D)
    ms = _cuda_ms(lambda: rglru.rglru_scan(x, a), reps=10)
    ms_h0 = _cuda_ms(lambda: rglru.rglru_scan(x, a, h0), reps=10)
    plain_ms = _host_ms(lambda: rglru.rglru_plain(x, a))
    bound_ms, bound_by = _bound(rglru_work(B, S, D, 4), PEAK_F32_OPS_PER_S)
    rg_entry = {
        "name": "rglru", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru.py:25",
        "launches": prefill["launches"]["rglru"],
        "max_abs_err": errs["rglru"], "ms": ms, "ms_h0": ms_h0,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence",
        "shape": "x, a [2,3072,4096] float32, no h0",
        "plain_on": "the card (rglru_ref: one step of elementwise ops "
                    "per time step)"}
    for e in (fa_entry, rg_entry):
        log(f"timing {e['name']} at {e['shape']}: kernel {e['ms']!r} ms, "
            f"plain {e['plain_ms']!r} ms, bound {e['bound_ms']!r} ms "
            f"({e['bound_by']}), library {e['library_ms']!r} ms")
    log(f"timing rglru with h0: kernel {ms_h0!r} ms")
    return [fa_entry, rg_entry]


def _fa_bwd_bound(case) -> tuple[float, str, float]:
    """Least time for one flash-attention backward call: 10*D operations
    a unmasked (query, key) pair (S, dP, dV, dK, dQ) on the tensor cores
    (float32 as three TF32 products), against q, k, v, O, dO read once,
    L read once and dq, dk, dv written once; also the operations on the
    CUDA cores' float32 peak."""
    from repro_torch.analysis.hlo_cost import attention_bwd_work
    B, Sq, Sk, Hq, Hkv, D, causal, window, _, dt = case
    Dqk, Dv = _head_dims(D)
    size = torch.tensor([], dtype=getattr(torch, dt)).element_size()
    return _tensor_core_bound(attention_bwd_work(B, Sq, Sk, Hq, Hkv, Dqk,
                                                 Dv, causal, window, size),
                              dt)


_MLA_BF16_LAUNCHES = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa
B, S, H = (int(x) for x in sys.argv[1:4])
g = torch.Generator(device="cuda").manual_seed(0)
q, k = (torch.randn((B, S, H, 192), generator=g, device="cuda")
        .bfloat16().requires_grad_(True) for _ in range(2))
v = torch.randn((B, S, H, 128), generator=g, device="cuda").bfloat16()
v.requires_grad_(True)
dout = torch.randn((B, S, H, 128), generator=g, device="cuda").bfloat16()
out = fa.flash_attention(q, k, v, causal=True)   # builds and warms up
torch.autograd.grad(out, (q, k, v), dout)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    out = fa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
ms = {"dkdv": 0.0, "dq": 0.0}
for ev in prof.key_averages():
    us = getattr(ev, "self_device_time_total",
                 getattr(ev, "self_cuda_time_total", 0.0))
    if ev.device_type == DeviceType.CUDA and "mla_bwd_kernel<" in ev.key:
        ms["dq" if "<true>" in ev.key else "dkdv"] += us / 1e3
print(json.dumps(ms))
"""


def _fa_bwd_mla_bf16_launches() -> dict:
    """Row 2c's bf16 launches at path D's layer shape, one by one: the
    device ms of the dK/dV and dQ kernels in one autograd call of
    `flash_attention` (bf16, FA_MLA's shape) under `torch.profiler`, in a
    fresh process (as tools/fa_bwd_sweep.py measures them): late in this
    run a window that held only the port's kernels showed no device time
    at all (phase 16d of two runs on an H100), where a fresh process sees
    them.  None where it saw none."""
    B, S, _, H = FA_MLA[:4]
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
    proc = subprocess.run([sys.executable, "-c", _MLA_BF16_LAUNCHES,
                           str(B), str(S), str(H)], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"row 2c's bf16 launches: exit "
          f"{proc.returncode}: {(proc.stdout + proc.stderr)[-2000:]}")
    ms = json.loads(proc.stdout.strip().splitlines()[-1])
    return {key: (v if v > 0 else None) for key, v in ms.items()}


def _fa_bwd_timed(case, reps: int, plain: bool = False) -> dict:
    """The flash-attention backward kernel at `case` (no window) on the
    card's clock beside its bound and the backward of one
    `scaled_dot_product_attention` call (`is_causal`), and with `plain`
    the plain version's autograd on the host's clock."""
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    B, Sq, Sk, Hq, Hkv, D, causal, _, _, dt = case
    Dqk = _head_dims(D)[0]
    q, k, v = _fa_inputs(case)
    dout = torch.randn(q.shape[:3] + v.shape[3:], device="cuda").to(q.dtype)
    scale = Dqk ** -0.5
    out, lse = fa._launch(q, k, v, causal, None, None, scale, 0,
                          with_lse=True)
    res = {"ms": _cuda_ms(lambda: fa._launch_bwd(
        q, k, v, out, dout, lse, causal, None, None, scale, 0), reps=reps)}
    res["bound_ms"], res["bound_by"], res["cuda_core_ms"] = \
        _fa_bwd_bound(case)
    res["plain_ms"] = _host_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, dout, causal=causal, scale=scale), reps=2) if plain else None
    del out, lse
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                        scale=scale, enable_gqa=Hq != Hkv)
    dt_ = dout.transpose(1, 2).contiguous()
    res["library_ms"] = _cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dt_, retain_graph=True), reps=reps)
    res["shape"] = (f"q [{B},{Sq},{Hq},{Dqk}], k/v [{B},{Sk},{Hkv},"
                    f"{_head_dims(D)[0]}/{_head_dims(D)[1]}] {dt}, "
                    f"{'causal' if causal else 'no mask'}")
    del q, k, v, dout, qt, kt, vt, ot, dt_
    torch.cuda.empty_cache()
    return res


def phase_train_timing(train_a: dict, train_b: dict, train_d: dict,
                       train_e: dict, errs: dict) -> list:
    """The backward kernels at the training paths' shapes: flash
    attention's at path A's attention layer (and at path B's, at
    deepseek-v3's MLA layer of path D, row 2c, and at seamless's cross
    attention of path E), RG-LRU's at path B's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.analysis.hlo_cost import rglru_bwd_work
    from repro_torch.kernels import rglru
    F = torch.nn.functional
    B, Sq, Sk, Hq, Hkv, D = FA_BWD_A[:6]
    q, k, v = _fa_inputs(FA_BWD_A)
    dout = torch.randn_like(q)
    scale = D ** -0.5
    out, lse = fa._launch(q, k, v, True, None, None, scale, 0,
                          with_lse=True)
    ms = _cuda_ms(lambda: fa._launch_bwd(q, k, v, out, dout, lse, True,
                                         None, None, scale, 0), reps=10)
    ms_fwd = _cuda_ms(lambda: fa._launch(q, k, v, True, None, None, scale,
                                         0, with_lse=True), reps=10)
    plain_ms = _host_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, dout, causal=True))
    # the yardstick: the backward of one PyTorch call, explicit causal mask
    pos = torch.arange(Sq, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                        enable_gqa=True)
    dt_ = dout.transpose(1, 2).contiguous()
    library_ms = _cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dt_, retain_graph=True), reps=10)
    bound_ms, bound_by, cuda_core_ms = _fa_bwd_bound(FA_BWD_A)
    del q, k, v, dout, out, lse, qt, kt, vt, ot, dt_, mask
    torch.cuda.empty_cache()
    # path B's attention layer (head_dim 256, window 2048)
    Bb, Sb, _, Hqb, Hkvb, Db, _, win_b = FA_BWD_B[:8]
    q, k, v = _fa_inputs(FA_BWD_B)
    dout = torch.randn_like(q)
    scale_b = Db ** -0.5
    out, lse = fa._launch(q, k, v, True, win_b, None, scale_b, 0,
                          with_lse=True)
    ms_b = _cuda_ms(lambda: fa._launch_bwd(q, k, v, out, dout, lse, True,
                                           win_b, None, scale_b, 0),
                    reps=10)
    bound_b_ms = _fa_bwd_bound(FA_BWD_B)[0]
    # the yardstick at path B: SDPA's backward, causal window as a mask
    pos = torch.arange(Sb, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] >
                                             pos[:, None] - win_b)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                        scale=scale_b, enable_gqa=True)
    dt_ = dout.transpose(1, 2).contiguous()
    library_b_ms = _cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dt_, retain_graph=True), reps=10)
    del q, k, v, dout, out, lse, qt, kt, vt, ot, dt_, mask
    torch.cuda.empty_cache()
    aim = (f"{'met' if ms <= FA_BWD_AIM_MS else 'missed'}: {ms!r} ms "
           f"against {FA_BWD_AIM_MS} ms at path A's shape")
    # path B: below one PyTorch call (SDPA's backward) in the same run
    aim_b = (f"{'met' if ms_b < library_b_ms else 'missed'}: {ms_b!r} ms "
             f"against SDPA's backward {library_b_ms!r} ms at path B's "
             f"shape")
    prof_b = train_b["profile"]
    split_b = {"dkdv": prof_b["dkdv"] or None, "dq": prof_b["dq"] or None}
    log(f"flash attention backward at path B: {aim_b}; its launches in "
        f"path B's profiled step (device ms; null: not measured): "
        f"{json.dumps(split_b)}")
    fa_entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29 (its "
                    "gradient; the JAX package differentiates "
                    "attention_ref, src/repro/kernels/ops.py:96-118)",
        "launches": train_a["per_step"]["flash_attention_bwd"],
        "launches_path": train_a["launches"]["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_cuda_core_ms": cuda_core_ms,
        "library_ms": library_ms,
        "ms_forward_with_lse": ms_fwd,
        "ms_path_b": ms_b, "bound_path_b_ms": bound_b_ms,
        "library_path_b_ms": library_b_ms,
        "shape_path_b": f"q, dout [{Bb},{Sb},{Hqb},{Db}] k/v "
                        f"[{Bb},{Sb},{Hkvb},{Db}] float32, causal, window "
                        f"{win_b} (one recurrentgemma-9b attention layer)",
        "aim": aim, "aim_path_b": aim_b,
        "ms_path_b_launches": split_b,
        "shape": f"q, dout [{B},{Sq},{Hq},{D}] k/v [{B},{Sk},{Hkv},{D}] "
                 f"float32, causal (one smollm-360m layer, one microbatch)",
        "library": "backward of scaled_dot_product_attention, explicit "
                   "bool mask, enable_gqa (timed only)",
        "plain_on": "the card (autograd of attention_ref)",
        "launches_note": "per train step of path A (32 layers x 2 "
                         "microbatches); launches_path over its 8 steps",
        "max_abs_err_note": "scaled: max|err| / max(1, max|g|) against "
                            "float64"}
    log(f"timing flash_attention_bwd at path B's shape: kernel {ms_b!r} ms,"
        f" bound {bound_b_ms!r} ms, library {library_b_ms!r} ms; the "
        f"{FA_BWD_AIM_MS} ms aim at path A {aim}")
    # row 2c: the (192, 128) instantiation at path D's attention (float32
    # with the plain version's time, and bf16), then path E's cross
    # attention
    mla = _fa_bwd_timed(FA_MLA, reps=5, plain=True)
    mla16 = _fa_bwd_timed(FA_MLA[:9] + ("bfloat16",), reps=5)
    cross = _fa_bwd_timed(FA_BWD_SEAMLESS_CROSS, reps=10)
    fa_entry.update({
        "ms_mla": mla["ms"], "bound_mla_ms": mla["bound_ms"],
        "bound_mla_by": mla["bound_by"],
        "bound_mla_cuda_core_ms": mla["cuda_core_ms"],
        "plain_mla_ms": mla["plain_ms"], "library_mla_ms": mla["library_ms"],
        "max_abs_err_mla": errs[FA_MLA], "shape_mla": mla["shape"]
        + " (path D's layer, row 2c)",
        "ms_mla_dkdv": train_d["split"]["float32"]["dkdv"],
        "ms_mla_dq": train_d["split"]["float32"]["dq"],
        "ms_mla_bf16": mla16["ms"], "bound_mla_bf16_ms": mla16["bound_ms"],
        "library_mla_bf16_ms": mla16["library_ms"],
        "ms_mla_bf16_dkdv": train_d["split"]["bfloat16"]["dkdv"],
        "ms_mla_bf16_dq": train_d["split"]["bfloat16"]["dq"],
        "source_mla_bf16": "src/repro_torch/csrc/"
                           "flash_attention_bwd_mla.cuh (mla_bwd_kernel)",
        "ms_mla_split_note": "each launch's device time in one call under "
                             "torch.profiler, phase 16d (float32: path D's "
                             "profiled call, bwd_kernel; bf16: "
                             "mla_bwd_kernel, one call in a fresh "
                             "process); null: the profiler saw no "
                             "device time, not measured",
        "ms_seamless_cross": cross["ms"],
        "bound_seamless_cross_ms": cross["bound_ms"],
        "library_seamless_cross_ms": cross["library_ms"],
        "max_abs_err_seamless_cross": errs[FA_BWD_SEAMLESS_CROSS],
        "shape_seamless_cross": cross["shape"] + " (path E's cross "
                                                 "attention, one step's "
                                                 "batch)",
        "launches_path_d": train_d["launches"]["flash_attention_bwd"],
        "launches_path_e": train_e["launches"]["flash_attention_bwd"],
        "launches_path_d_note": "per call of path D (its one MLA layer); "
                                "launches_path_e over path E's 3 steps"})
    for name, r in (("row 2c (MLA)", mla), ("row 2c bf16", mla16),
                    ("seamless cross", cross)):
        log(f"timing flash_attention_bwd {name} at {r['shape']}: kernel "
            f"{r['ms']!r} ms, bound {r['bound_ms']!r} ms ({r['bound_by']}; "
            f"on the CUDA cores {r['cuda_core_ms']!r}), plain "
            f"{r['plain_ms']!r} ms, SDPA's backward {r['library_ms']!r} ms")

    B, S, D = RG_BWD
    x, a, _ = _rg_inputs(B, S, D)
    h, _ = rglru._launch(x, a, None)
    dh, dlast = torch.randn_like(x), torch.randn((B, D), device="cuda")
    ms = _cuda_ms(lambda: rglru._launch_bwd(x, a, None, h, dh, dlast),
                  reps=10)
    plain_ms = _host_ms(lambda: rglru.rglru_bwd_plain(x, a, None, dh,
                                                      dlast))
    n = B * S * D
    bound_ms, bound_by = _bound(rglru_bwd_work(B, S, D, 4),
                                PEAK_F32_OPS_PER_S)
    # what this design moves: a and dh read twice, and per chunk and
    # channel alpha and beta written, read, the carry written and read
    n_chunks = -(-S // rglru.chunk_steps())
    design_bytes = 4 * (8 * n + 5 * B * n_chunks * D + B * D)
    rg_aim = (f"{'met' if ms <= RG_BWD_AIM_MS else 'missed'}: {ms!r} ms "
              f"against {RG_BWD_AIM_MS} ms")
    rg_entry = {
        "name": "rglru_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_bwd.cu",
        "replaces": "src/repro/kernels/rglru.py:25 (its gradient; the JAX "
                    "package differentiates rglru_ref, "
                    "src/repro/kernels/ops.py:124-130)",
        "launches": train_b["per_step"]["rglru_bwd"],
        "launches_path": train_b["launches"]["rglru_bwd"],
        "max_abs_err": errs["rglru_bwd"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_design_ms": design_bytes / PEAK_BYTES_PER_S * 1e3,
        "bound_design_note": "the bytes this design moves: 8 arrays (a "
                             "and dh read twice) and 5 floats a chunk "
                             "and channel",
        "aim": rg_aim,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence "
                   "or its gradient",
        "shape": f"x, a, h, dh [{B},{S},{D}] float32, no h0 (one "
                 f"recurrentgemma-9b layer)",
        "plain_on": "the card (autograd of rglru_ref)",
        "launches_note": "per train step of path B (2 recurrent layers); "
                         "launches_path over its 3 steps",
        "max_abs_err_note": "scaled: max|err| / max(1, max|g|) against "
                            "float64"}
    del x, a, h, dh, dlast
    torch.cuda.empty_cache()
    log(f"timing rglru_bwd: the {RG_BWD_AIM_MS} ms aim at path B's layer "
        f"{rg_aim}; bound for this design's bytes "
        f"{rg_entry['bound_design_ms']!r} ms")
    for e in (fa_entry, rg_entry):
        log(f"timing {e['name']} at {e['shape']}: kernel {e['ms']!r} ms, "
            f"plain {e['plain_ms']!r} ms, bound {e['bound_ms']!r} ms "
            f"({e['bound_by']}), library {e['library_ms']!r} ms")
    return [fa_entry, rg_entry]


def phase_rwkv_bwd_timing(train_c: dict, err: float) -> dict:
    """The RWKV6 backward kernel at path C's layer shape; the forward
    with and without its checkpoint write beside it."""
    from repro_torch.analysis.hlo_cost import rwkv6_bwd_work
    from repro_torch.core.cuda import _build
    from repro_torch.kernels import rwkv6
    B, S, H, Dk, Dv = RWKV_BWD
    r, k, v, w, u, _ = _rwkv_inputs(*RWKV_BWD)
    dout = torch.randn_like(v)
    _, _, ckpt = rwkv6._launch(r, k, v, w, u, None, with_ckpt=True)
    ms = _cuda_ms(lambda: rwkv6._launch_bwd(r, k, v, w, u, None, ckpt,
                                            dout, None), reps=10)
    ms_fwd = _cuda_ms(lambda: rwkv6._launch(r, k, v, w, u, None), reps=10)
    ms_fwd_ckpt = _cuda_ms(lambda: rwkv6._launch(r, k, v, w, u, None,
                                                 with_ckpt=True), reps=10)
    plain_ms = _host_ms(lambda: rwkv6.rwkv6_bwd_plain(r, k, v, w, u, None,
                                                      dout, None), reps=1)
    # what the gradient must move: r, k, w, v, dout and u read once, dr,
    # dk, dw, dv and du written once (the checkpoints are this design's
    # choice, not the function's, and stand beside it as ckpt_bytes);
    # 13*Dk*Dv float32 operations per (b, t, h)
    scratch_bytes = 4 * _build.load_library().rwkv6_bwd_scratch_len(
        B, S, H, Dk, Dv)
    aim = (f"{'met' if ms <= RWKV_BWD_AIM_MS else 'missed'}: {ms!r} ms "
           f"against {RWKV_BWD_AIM_MS} ms")
    bound_ms, bound_by = _bound(rwkv6_bwd_work(B, S, H, Dk, Dv, 4),
                                PEAK_F32_OPS_PER_S)
    entry = {
        "name": "rwkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6.py:28 (its gradient; the JAX "
                    "package differentiates rwkv6_chunked, "
                    "src/repro/kernels/ops.py:133-157)",
        "launches": train_c["per_step"]["rwkv6_bwd"],
        "launches_path": train_c["launches"]["rwkv6_bwd"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence "
                   "or its gradient",
        "ms_forward": ms_fwd, "ms_forward_with_ckpt": ms_fwd_ckpt,
        "shape": f"r, k, v, w, dout [{B},{S},{H},{Dk}] float32, no s0 or "
                 f"dS_last, checkpoints [{B},{H},{ckpt.shape[2]},{Dk},{Dv}] "
                 f"(one rwkv6-7b layer, one microbatch)",
        "plain_on": "the card (autograd of rwkv6_ref), one run",
        "launches_note": f"per train step of path C ({TRAIN_C_LAYERS} "
                         f"layers x {TRAIN_C_MICRO} microbatches); "
                         f"launches_path over its {TRAIN_C_STEPS} steps",
        "bound_note": "inputs and gradients only; the checkpoints the "
                      "kernel also reads are ckpt_bytes",
        "ckpt_bytes": 4 * ckpt.numel(),
        "scratch_bytes": scratch_bytes,
        "aim": aim,
        "max_abs_err_note": "scaled: max|err| / max(1, max|g|) against "
                            "float64"}
    log(f"timing {entry['name']} at {entry['shape']}: kernel {ms!r} ms, "
        f"plain {plain_ms!r} ms, bound {entry['bound_ms']!r} ms "
        f"({entry['bound_by']}), library none; checkpoints "
        f"{entry['ckpt_bytes']} bytes; forward {ms_fwd!r} ms, with the "
        f"checkpoint write {ms_fwd_ckpt!r} ms; scratch {scratch_bytes} "
        f"bytes; the {RWKV_BWD_AIM_MS} ms aim {aim}")
    del r, k, v, w, dout, ckpt
    torch.cuda.empty_cache()
    return entry


def _rwkv_bound(B: int, S: int, H: int, Dk: int, Dv: int,
                size: int) -> tuple[float, str]:
    """Least time for one WKV scan without s0: r, k, w, v read once, out
    and S_last (float32) written once, over the memory rate, against
    7*Dk*Dv float32 operations per (b, t, h) over the float32 peak."""
    from repro_torch.analysis.hlo_cost import rwkv6_work
    return _bound(rwkv6_work(B, S, H, Dk, Dv, size), PEAK_F32_OPS_PER_S)


def phase_rwkv_timing(prefill: dict, serve: dict, err: float) -> dict:
    from repro_torch.kernels import ref, rwkv6
    r, k, v, w, u, s0 = _rwkv_inputs(*RWKV_DECODE)
    ms_decode = _cuda_ms(lambda: rwkv6.rwkv6_scan(r, k, v, w, u, s0),
                         reps=200)
    r, k, v, w, u, _ = _rwkv_inputs(*RWKV_MAIN)
    ms = _cuda_ms(lambda: rwkv6.rwkv6_scan(r, k, v, w, u), reps=10)
    plain_ms = _host_ms(lambda: rwkv6.rwkv6_plain(r, k, v, w, u))
    # the JAX package's chunk-parallel matmul form, on the card: a
    # yardstick of its own, not one PyTorch call
    chunked_ms = _host_ms(lambda: ref.rwkv6_chunked(r, k, v, w, u))
    bound_ms, bound_by = _rwkv_bound(*RWKV_MAIN, size=4)
    entry = {
        "name": "rwkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:28",
        "launches": prefill["launches"]["rwkv6"],
        "launches_serve": serve["launches"]["rwkv6"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence",
        "ms_decode": ms_decode,
        "decode_shape": "r, k, v, w [4,1,64,64] float32, s0 [4,64,64,64]",
        "chunked_ms": chunked_ms,
        "chunked": "rwkv6_chunked (chunk 64, sub-blocks of 8) on the card, "
                   "host clock",
        "shape": "r, k, v, w [2,4096,64,64] float32, u [64,64], no s0",
        "plain_on": "the card (rwkv6_ref: one step of einsum and "
                    "elementwise ops per time step)"}
    log(f"timing rwkv6 at {entry['shape']}: kernel {ms!r} ms, plain "
        f"{plain_ms!r} ms, chunked {chunked_ms!r} ms, bound {bound_ms!r} "
        f"ms ({bound_by}), library none; at {entry['decode_shape']}: "
        f"kernel {ms_decode!r} ms")
    del r, k, v, w
    torch.cuda.empty_cache()
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(HERE, "src"), os.path.join(HERE, "tools")]
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    max_abs_err = phase_kernel_vs_plain()
    runs = phase_main_path()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        t0 = time.perf_counter()
        trace = phase_trace_path(tmp)
        t1 = time.perf_counter()
        phase_dist_path(tmp)
        t2 = time.perf_counter()
        serve = phase_plan_service(tmp, trace)
        log(f"phase seconds: 4b {t1 - t0:.1f}, 4c {t2 - t1:.1f}, 4d "
            f"{time.perf_counter() - t2:.1f}")
    t0 = time.perf_counter()
    ep_launches = phase_expert_placement()
    t1 = time.perf_counter()
    errs = phase_model_kernels_vs_plain()
    log(f"phase seconds: 4e {t1 - t0:.1f}, 5 {time.perf_counter() - t1:.1f}")
    from repro_torch.configs import get_config
    prefill = phase_prefill(get_config(ARCH), N_PARAMS, PREFILL_B,
                            PREFILL_S, _expect(flash_attention=12, rglru=26),
                            profile=True)
    phase_serve(get_config(ARCH), _expect(),
                _expect(flash_attention=12, rglru=26),
                note=" (its decode computes attention and the recurrence "
                     "inline, as the JAX launcher's does)")
    rwkv_err = phase_rwkv_kernel_vs_plain()
    n_rwkv = RWKV_LAYERS
    rwkv_prefill = phase_prefill(get_config(RWKV_ARCH), RWKV_N_PARAMS,
                                 RWKV_PREFILL_B, RWKV_PREFILL_S,
                                 _expect(rwkv6=n_rwkv))
    rwkv_serve = phase_serve(get_config(RWKV_ARCH),
                             _expect(rwkv6=(32 + 32) * n_rwkv),
                             _expect(rwkv6=n_rwkv),
                             note=" (one per layer and decode step, with "
                                  "the cached state as s0)",
                             reference=rwkv_logits_f64)
    t0 = time.perf_counter()
    dbrx = dataclasses.replace(get_config(DBRX_ARCH), n_layers=DBRX_LAYERS)
    dbrx_prefill = phase_prefill(dbrx, DBRX_PARAMS, DBRX_PREFILL_B,
                                 DBRX_PREFILL_S,
                                 _expect(flash_attention=DBRX_LAYERS),
                                 profile=True)
    t1 = time.perf_counter()
    phase_serve(dataclasses.replace(dbrx, capacity_factor=float(
                    dbrx.n_experts)),
                _expect(), _expect(flash_attention=DBRX_LAYERS),
                note=f" ({DBRX_LAYERS} layers, dropless: capacity factor "
                     f"{dbrx.n_experts}; its decode computes attention "
                     f"inline and reads every expert's weights)")
    log(f"phase seconds: 10b {t1 - t0:.1f}, 10c "
        f"{time.perf_counter() - t1:.1f}")
    t0 = time.perf_counter()
    dsv3 = dataclasses.replace(get_config(DSV3_ARCH), n_layers=DSV3_LAYERS,
                               mtp_depth=0)
    dsv3_prefill = phase_prefill(dsv3, DSV3_PARAMS, DSV3_PREFILL_B,
                                 DSV3_PREFILL_S,
                                 _expect(flash_attention=DSV3_LAYERS),
                                 profile=True)
    t1 = time.perf_counter()
    dropless = dsv3.n_experts / dsv3.experts_per_token
    phase_serve(dataclasses.replace(dsv3, capacity_factor=dropless),
                _expect(), _expect(flash_attention=DSV3_LAYERS),
                note=f" ({DSV3_LAYERS} layer, no MTP head, dropless: "
                     f"capacity factor {dropless}; its absorbed MLA decode "
                     f"computes attention inline in the latent space and "
                     f"reads every expert's weights)")
    log(f"phase seconds: 10d {t1 - t0:.1f}, 10e "
        f"{time.perf_counter() - t1:.1f}")
    t0 = time.perf_counter()
    seamless = get_config(SEAMLESS_ARCH)
    n_sm = seamless.n_encoder_layers + 2 * seamless.n_layers
    sm_prefill = phase_prefill(
        seamless, SEAMLESS_PARAMS, SEAMLESS_B, SEAMLESS_S,
        _expect(flash_attention=n_sm), profile=True, label=" (frames)",
        extra={"frame_embeds": _normal(
            (SEAMLESS_B, SEAMLESS_S, seamless.d_model), seed=1)})
    sm_decoder = phase_prefill(
        seamless, SEAMLESS_PARAMS, SEAMLESS_B, SEAMLESS_S,
        _expect(flash_attention=seamless.n_layers), label=" (no frames)")
    t1 = time.perf_counter()
    phase_serve(seamless, _expect(),
                _expect(flash_attention=seamless.n_layers),
                note=" (decoder only, as the JAX launcher runs it: no "
                     "frames, its decode computes attention inline)")
    sm_decode = phase_seamless_decode(seamless)
    t2 = time.perf_counter()
    qwen = get_config(QWEN_ARCH)
    qwen_prefill = phase_prefill(
        qwen, QWEN_PARAMS, QWEN_B, QWEN_S,
        _expect(flash_attention=qwen.n_layers), extra=_qwen_inputs(qwen),
        label=" (patches)")
    log(f"phase seconds: 10f {t1 - t0:.1f}, 10g {t2 - t1:.1f}, 10h "
        f"{time.perf_counter() - t2:.1f}")
    t0 = time.perf_counter()
    bwd_errs = phase_backward_kernels_vs_plain()
    t1 = time.perf_counter()
    rwkv_bwd_err = phase_rwkv_backward_vs_plain()
    t1b = time.perf_counter()
    train_a = phase_train_a()
    adamw_entry = phase_adamw(train_a)
    t2 = time.perf_counter()
    train_b = phase_train_b()
    t3 = time.perf_counter()
    train_c = phase_train_c()
    t3c = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        phase_train_cli(tmp)
    t3d = time.perf_counter()
    train_d = phase_train_d(dsv3)
    train_e = phase_train_e(seamless)
    t3e = time.perf_counter()
    capture = phase_capture()
    log(f"phase seconds: 12 {t1 - t0:.1f}, 12b {t1b - t1:.1f}, 13 "
        f"{t2 - t1b:.1f}, 14 {t3 - t2:.1f}, 16 {t3c - t3:.1f}, 15 "
        f"{t3d - t3c:.1f}, 16d and 16e {t3e - t3d:.1f}, 17 "
        f"{time.perf_counter() - t3e:.1f}")
    mesh = phase_mesh()
    kernels = phase_timing(runs, max_abs_err)
    kernels["kernels"][0]["launches_trace"] = trace["launches"]
    kernels["kernels"][0]["launches_serve"] = serve["launches_serve"]
    kernels["kernels"][0]["launches_incremental"] = \
        serve["launches_incremental"]
    kernels["kernels"][0]["launches_expert_placement"] = ep_launches
    kernels["kernels"][0]["launches_capture_plan"] = capture["launches_plan"]
    kernels["kernels"] += phase_model_timing(prefill, errs)
    kernels["kernels"][1]["launches_dbrx_prefill"] = \
        dbrx_prefill["launches"]["flash_attention"]
    kernels["kernels"][1]["launches_deepseek_prefill"] = \
        dsv3_prefill["launches"]["flash_attention"]
    kernels["kernels"][1].update({
        "launches_seamless_prefill": sm_prefill["launches"]["flash_attention"],
        "launches_seamless_prefill_no_frames":
            sm_decoder["launches"]["flash_attention"],
        "launches_seamless_decode": sm_decode["launches"],
        "launches_qwen2_vl_prefill":
            qwen_prefill["launches"]["flash_attention"]})
    kernels["kernels"].append(phase_rwkv_timing(rwkv_prefill, rwkv_serve,
                                                rwkv_err))
    t4 = time.perf_counter()
    kernels["kernels"] += phase_train_timing(train_a, train_b, train_d,
                                             train_e, bwd_errs)
    kernels["kernels"].append(adamw_entry)
    log(f"phase seconds: 11 (backward timing) "
        f"{time.perf_counter() - t4:.1f}")
    for entry in kernels["kernels"]:
        if capture["launches_step"].get(entry["name"]):
            entry["launches_capture_step"] = \
                capture["launches_step"][entry["name"]]
        if mesh["launches"].get(entry["name"]):
            entry["launches_mesh_step"] = mesh["launches"][entry["name"]]
    t4 = time.perf_counter()
    kernels["kernels"].append(phase_rwkv_bwd_timing(train_c, rwkv_bwd_err))
    log(f"phase seconds: 11 (rwkv6_bwd timing) "
        f"{time.perf_counter() - t4:.1f}")
    check(len(kernels["kernels"]) == 8, "the kernels line lists eight")
    check(not any(m in sys.modules for m in ("jax", "repro")),
          "the port imported JAX or the JAX package")
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
