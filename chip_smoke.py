#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero and prints
no result:

1. the card's name and power limit, torch and CUDA versions;
2. build every kernel of the main paths from the sources in the checkout
   (one nvcc per source, started together; sm_90a) and print the build
   times and ptxas reports;
3. hold the forward conv kernel (B1) against its plain PyTorch version on
   the card, TF32 off, at the serving shapes and at others (general
   stride, ragged N and rows), in every mode;
3b. hold the gated stem kernel (B5), both its bodies (B1's at depth 0,
   the gated ring of B2 at depths 2 and 3, block_h 1, 2, 4), against B1
   followed by `torch.where` and against the dense kernel at the same
   blocks followed by it, bit for bit, and against its plain version,
   over masks (all re-run, all skip, mixed, one slot), at the stream
   shape, at s < k and at Ho = 1, in every mode;
3c. hold the chunked WKV kernel (B7) against its plain version at the LM
   serving tick's shape (8, 64, 40, 64), at S in {1, 15, 17, 100} x D
   in {16, 64}, at S = 0 and 64, at D = 33, and on unaligned views (also
   bitwise equal to the aligned inputs' result), from a random initial
   state, within 1e-4 of the largest |plain|; a row whose lw and k are
   all zero keeps its state bit for bit;
3d. hold the pipelined conv (B2, `p2m_conv_fused(pipeline_depth>=2)`)
   against B1 bit for bit, `out` and `raw`, at depths 2, 3 and 8 (clamped
   to k) x block_h 1, 2, 4, in every mode, at the serving, stream and
   training shapes and over random geometries (s < k, N in {5, 8, 24},
   dx 1-4), one line per shape and mode;
3e. at the training shape, the gradients through `ops.p2m_conv` with
   pipeline_depth 2 and 0 are equal bit for bit;
3f. the tuner at the serving, stream and training signatures: its first
   call's time, each candidate's shared memory and time, the winner; no
   candidate may fail;
3g. hold the P²M product (B6) against its plain twin at (100,352, 75, 8)
   and (4096, 147, 32) in every mode, and `ops.p2m_matmul`'s gradients
   (B6, B3, B4) against float64 autograd of `p2m_matmul_plain`;
4. hold the backward kernels (B3 dX, B4 dW) against their plain versions
   in float64 over conv geometries (s < k, ragged M and N, dx = 1..4)
   and at the training shape;
5. the serving path: `VisionEngine` serving the full-width deploy-folded
   P²M-MobileNetV2 (`configs/p2m_vww.py::CONFIG`, 560², width 1.0,
   microbatch 8) with random weights from a seed, 24 SyntheticVWW
   requests with staggered arrivals through `drive()`; every request
   completes in order, B1 launched once per engine launch, and each
   batch's probabilities equal the same forward with the plain stem;
   the stem is B1 or B2, as the tuner picked;
5d. the patch-level path: the serving batch's patches through
   `ops.p2m_matmul` (B6, quant), held to the deploy stem by the count
   rule, with its gradients through B3 and B4;
5e. B2 inside an engine: the 24 requests served again with a depth-0
   (B1) and then a depth-2 (B2) winner in the tuner's cache entry of the
   serving signature; the two passes' probabilities equal bit for bit;
5b. the streaming path: `StreamEngine` on `CONFIG` with 4 slots, a
   detection head from a seed, six hold-2 `SyntheticVideo` streams of
   12, 8, 12, 6, 12 and 10 frames at 560² (the 6-frame one noisy), on the
   gated stem (the default on the card), on the where stem and dense
   (``threshold=None``); gated == where and gated == dense bit for bit,
   the measured skip rate and bandwidth reduction exact, B5 once a tick
   on the body of the tuner's depth for the engines' stem signature (the
   ring at depth >= 2) and no B1 or B2 on the gated engine, B1 or B2 once
   a tick on the where engine; a NaN cache forces its slot to re-run and
   drops its gate to dense;
5c. the LM path: RWKV-6 3B (`configs/rwkv6_3b.py::CONFIG`, 32 layers,
   d_model 2560, float32) with random weights from a seed, served through
   `ServeEngine` (8 slots, max_len 512, chunked prefill 64): 16
   SyntheticLMDataset prompts of 24-150 tokens with staggered arrivals,
   16 new tokens each, through `drive()`; every request completes, B7
   launches 32 times on each prefill tick and never on a decode tick; the
   first prefill tick replayed with each layer's B7 call held against the
   plain WKV on the same inputs (within 1e-4 of the largest |plain|); that
   tick's logits with B7 within the model's own float32 spread of those
   with the plain WKV (the spread: the largest difference among the
   plain WKV, the per-token scan and a float64 run, which at full depth is
   1e-2 of the logits); the tokens equal a plain-WKV run's, or first differ
   at a near-tie (top-2 margin within that spread); then `SessionEngine`:
   4 sessions of 3 turns on 4 slots, all complete, B7 on every turn
   prefill;
5h. the front door: phase 5c's LM (the same params; `ServeEngine`, 8
   slots, max_len 512, chunk 64, ``tick_cost`` 4), a `ReplicaPool` of two
   full-width `VisionEngine`s on phase 5's params and a gated
   `StreamEngine` (4 slots, phase 5b's head) behind one traced
   `FrontDoor`; phase 5c's 16 requests, phase 5's 24 frames at its
   arrivals and phase 5b's six streams one a tick, on the door's clock.
   (a) every request completes, no engine down, the trace valid, B1 + B2
   launches = the replicas' (each launched), B5 = the stream engine's
   ticks, B7 = 32 a prefill tick and none on decode; probabilities within
   1e-4 of phase 5's, boxes and scores within 1e-5 of phase 5b's gated
   run, tokens phase 5c's up to a near-tie (how many bit for bit
   printed), the latency summaries on the door's clock and the wall time;
   (b) every ``tick_cost`` 1: the event-driven and the lockstep door give
   the same completions and byte-identical traces; (c) the traffic again
   under `SMOKE_PLAN` on every engine plus one explicit launch-error tick,
   NaN tick and stuck uid an engine: it drains, every uid lands on one
   ledger, every uid poisoned by NaN or a stuck slot fails, a launch
   victim fails or is cleared by its retry, every launch fault is an
   injected one, every completed request equals (a)'s, and each
   injector's summary; (d) (a)'s tick-domain export equals, byte for
   byte, that of a door of the same shape on the CPU (SMOKE LM, 40²
   vision and streams); (e) ``python -m repro_torch.launch.serve --arch
   rwkv6-3b --mixed ...`` in a subprocess exits 0 with the front-door
   summary;
5f. the port's repaired faults: a prompt token ``padded_vocab`` fails
   only its request (SMOKE rwkv), and the engine serves the next; every
   kernel wrapper raises on an input that requires grad under grad mode;
5g. LM training: (a) the WKV autograd Function (B7 forward, the
   closed-form backward) at (8, 64, 40, 64) from a nonzero state with both
   cotangents, its outputs and six gradients within 1e-4 of the largest
   |value| of float64 autograd of the plain twin; (b) RWKV-6 3B's first
   two layers at full width, batch 8 x 128: every gradient leaf through
   B7 within 1e-3 of the leaf's largest |value| through the plain WKV
   (both float32); (c) `launch/train.py`'s ``main`` for RWKV-6 3B at full
   width and depth, float32, AdamW in place, 3 steps at 8 x 128 (the
   served weights freed first): every loss finite, the moments finite
   (so every gradient was), B7 twice a layer a step (forward and remat
   recompute), the step's time by the host clock through a synchronize,
   tokens/s and the peak memory beside the card's name and power limit,
   then the step's parts by CUDA events (forward, forward + backward, a
   layer's recompute, B7, the closed-form WKV backward, head + CE, the
   in-place AdamW); (d) at SMOKE, 4 steps with checkpoints, a fresh run
   that restores and takes 2 more: the losses equal one 6-step run's bit
   for bit;
5i. the dense family (float32, random weights from a seed on the card,
   TF32 off): (a) Llama-3.2-1B (`configs/llama3_2_1b.py::CONFIG`, 16
   layers, d_model 2048, GQA 32/8, vocab 128256, tied) at full width, 2
   of its 16 layers (cut to make room for 5n), through
   `ServeEngine` (8 slots, max_len 512, chunk 64, the
   masked decode scan) on phase 5c's 16 requests: every request
   completes, no kernel of the port launches; the first prefill tick's last-active
   logits from the scan against `transformer.forward` (flash) in float32
   and in float64 (one layer converted at a time), each float32 one
   within 1e-3 of the largest |float64 logit|, the spread printed; each
   request's tokens equal its own `greedy_generate` run's, or first
   differ at a near-tie (top-2 margin within the spread); the prefill
   and decode ticks warm beside the decode step's weight-read bound;
   (b) StableLM-2-1.6B at full width and depth (LayerNorm, full MHA) and
   (c) Qwen3-32B (2 of 64 layers: qk-norm, head_dim 128) and Qwen2-72B (2
   of 80: QKV bias) at full width, 4 requests each, decode against
   forward as in (a), each model freed before the next; (d) ``python -m
   repro_torch.launch.serve --arch llama3.2-1b --mixed ...`` in a
   subprocess exits 0 with the front-door summary, every engine launched;
5j. the MoE and RG-LRU families (float32, random weights from a seed on
   the card, TF32 off): (a) Qwen3-30B-A3B (128 experts top-8, d_ff 768,
   qk-norm, 4 KV heads of 128) and (b) Mixtral-8x22B (8 experts top-2,
   d_ff 16384, window 4096) at published widths, depth cut to 4 of 48
   and 2 of 56 layers, phase 5c's first 4 requests each through
   `ServeEngine` as in 5i: every request completes, no kernel of the port
   launches; the first prefill tick's logits from the scan (decode groups
   of one token drop nothing) against the forward in float32 and in
   float64 at the capacity factor E/k, at which nothing drops, each
   float32 one within 1e-3 of the largest |float64 logit|, with the
   (token, expert) slots the published factor would drop in that forward
   counted; the warm prefill and decode ticks beside the whole tree's and
   the active parameters' weight-read bounds; (c) RecurrentGemma-9B whole
   (38 layers: 12 groups of rec/rec/attn and a tail of 2) through
   `greedy_generate(prefill_chunk=1)`, 16 tokens for each of phase 5c's
   first 4 prompts cut to the shortest: the token-by-token logits at the
   last prompt position against `rglru.forward` in float32 and in float64
   (one group converted at a time) within the same limit, the decode
   step's time beside both bounds; (d) `ServeEngine` (``cache_batch``)
   and `SessionEngine` (``prefill``) refuse RecurrentGemma at SMOKE on the
   card before allocating anything, ``launch.serve --arch
   qwen3-moe-30b-a3b --smoke`` serves on cuda and ``--arch
   recurrentgemma-9b --smoke`` exits non-zero with ``cache_batch`` in its
   stderr;
5k. the multimodal families and the P²M frontend (float32, random weights
   from a seed on the card, TF32 off; phase 5j's models freed first):
   (a) the frontend at the reference's default `P2MFrontendConfig()`
   (560², k = s = 5, pool 4: 784 tokens of 128 features, d_model 4096),
   folded (`deploy_params`, `premix_deploy`), on 4 SyntheticVWW frames:
   one B1 or B2 launch, as the tuner picks (printed), the stem held to
   ``impl="plain"`` by the count rule and the embeddings within 1e-5 of
   the plain run's on every token whose counts all agree; (b)
   Llama-3.2-Vision-11B whole (40 layers: 8 groups of 4 self layers and
   a gated cross layer; 9,775,157,264 parameters, 39.10 GB) with its
   gates set to nonzero values from the seed (printed): on the frontend's
   tokens and then on the config's 1600 stub embeddings, `vlm.forward`,
   `prefill_cross_kv` and `decode_step` over phase 5c's first 4 prompts
   cut to 32 tokens and 16 greedy tokens, the decode's logits at every
   prompt position and the forward's each within 1e-3 of the largest
   |logit| of a float64 forward (one group converted at a time); another
   frame's tokens move the logits by more than the float32 spread; the
   warm decode step beside the weight read; the peak memory; (c)
   Whisper-tiny whole (36,651,264 parameters): `prefill_cross_kv` on 8
   rows of stub source frames (8, 1500, 384), 64 teacher-forced decode
   steps against `whisper.forward` in float32 and float64 within the
   same limit, the decode step's time; no kernel of the port launches in
   (b) or (c); (d) the frontend's train form on 8 frames (BN on batch
   statistics): the gradients of a fixed scalar of the embeddings with
   respect to θ, the BN affine and ``proj`` through `P2MConvFunction`
   (B1 or B2 forward, B3 and B4 once each) against ``impl="plain"``
   within 1e-3 of each leaf's largest value, and the conv's backward on
   the run's own cotangent within 1e-4, as phase 7 (b); (e) ``launch.serve
   --arch llama-3.2-vision-11b --smoke`` and ``--arch whisper-tiny
   --smoke`` exit non-zero with the reference's refusal, and
   `SessionEngine` refuses the SMOKE VLM (``prefill``) before allocating
   anything;
5l. scale-out of the vision path (run, as 5m is, after phase 9's
   timings, which no world of processes precedes; `parallel`,
   `launch.mesh`, `launch.world.spawn_world`; ranks are spawned
   processes, one
   process tunes the stem for all of them): (a) a one-rank NCCL world on
   cuda:0, mesh (1, 1): one data-parallel `make_vww_train_step` at
   `CONFIG`, batch 32, `int8_ef`, against the single-process step, the
   loss within 1e-6, params and BN within 1e-3, bit for bit or not
   printed, B1 or B2, B3 and B4 once; (b) NCCL's refusal of two ranks on
   one card, printed, then a two-rank gloo world, both ranks on cuda:0:
   one step at 16 images a rank against the single-process step within
   1e-3 on loss, params and BN, four more with finite losses, ``step``
   5 and both ranks' params, EF error and BN equal bit for bit; the
   sharded `VisionEngine` on phase 5's 24 requests, the where
   `StreamEngine` on phase 5b's six streams, the gated engine's refusal
   of a mesh and a `ReplicaPool` over two one-rank submeshes, each
   against a single engine (rtol 1e-4, atol 1e-3; 1e-3); each rank's
   launches by part and the worlds' wall times, two ranks sharing one
   card (not a scaling figure);
5m. scale-out of the LM path (two-rank gloo worlds on cuda:0, TF32 off
   in every rank; not a scaling figure): (a) tensor parallelism,
   RWKV-6 3B at full width with 1 of 32 layers, mesh (1, 2), two AdamW
   steps at 8 x 128 through `launch/train.py`'s plan path: step 1's loss
   within 1e-5 (relative) of the single process's on the same weights,
   every reduced float32 gradient leaf within 1e-4 of its largest |g| of
   one process's that adds in the ranks' parts (`split_grads`), and so
   with the model in float64 of the single process's, each
   rank's leaves at the plan's shard shapes, the replicated leaves equal
   bit for bit across ranks after both steps, B7 twice a step a rank
   (forward, remat recompute) at (8, 128, 20, 64), its first call held against the plain twin;
   (b) the same under FSDP, mesh (2, 1), 4 sequences a rank, B7 at (4,
   128, 40, 64); (c) expert parallelism, Qwen3-30B-A3B at full width
   with 2 of 48 layers, mesh (1, 2), 64 experts a rank: the loss and aux
   of both ``moe_impl``s within 1e-5 (relative) of the single process's;
   (d) split-KV decode, Llama-3.2-1B at full width, 2 of 16 layers, mesh
   (1, 2) under ``cache_seq_shard`` (a cache of 64, 32 a rank): phase
   5c's first 4
   prompts cut to the shortest, 16 greedy tokens through
   `greedy_generate` under the plan equal to the single process's up to
   a near-tie, and every teacher-forced step's logits within 1e-5 of its
   largest |logit|; (e) the sharded engines, RWKV-6 3B whole replicated,
   mesh (2, 1), 8 slots (4 a rank): `ServeEngine` on phase 5c's 16
   requests and `SessionEngine` on its 4 three-turn sessions, each
   rank's first prefill tick equal bit for bit to the single process's
   on the rank's 4 slots, tokens equal to 5c's single engines' up to the
   model's float32 spread (a top-2 margin within 0.3), B7 on every prefill
   tick of each rank; every world's memory and wall time printed; no
   kernel but B7 launches on the path; B7 timed at phase 9's shape
   before and after the worlds;
5n. the rest of the LM path's scale-out (gloo worlds on cuda:0, TF32 off,
   held in float64 against the single process within 1e-5 of each
   leaf's largest |g| and of the largest |logit|, the single process's
   gradients written under a temporary directory and read by each rank
   in its slices; not a scaling figure): (a) RWKV-6 3B at full width, 1
   of 32 layers, 16 ranks through `launch/train.py --world 16
   --model-parallel 16` (2560 columns split, the 40 heads whole on every
   rank), one AdamW step at 8 x 128, B7 on every rank at (8, 128, 40,
   64), then step 1 in float64 under the plan; (b) Whisper-tiny whole,
   TP 2, FSDP 2 and TP 4 (6 heads over 4), (c) RecurrentGemma-9B at full
   width, its first block period, TP 2 (its FSDP 2 on the CPU only:
   78 s of gloo traffic on the card), (d)
   Llama-3.2-Vision-11B at full width, its first group, TP 2 on the P²M
   frontend's tokens of 4 frames (B1/B2 once a rank, the parent's tuner
   entries), gates nonzero: a train step's gradients and 16 decode steps
   (teacher-forced; (d) 16 prompt + 16 greedy tokens) each; (e) sharded
   checkpoints of RWKV-6 3B (2 of 32 layers, TP 2, `--ckpt-dir
   --ckpt-every 2`): 2 steps, a save, a restore and step
   3 equal an uninterrupted run's bit for bit, and the checkpoint
   restored by an FSDP-2 plan and into one process equals the saved
   tree bit for bit; (f) every world's state bytes equal the census's
   (`launch/specs.py`, `launch/op_analysis.argument_bytes`);
6. the training path: 6 steps of `make_vww_train_step` on `CONFIG` at
   batch 32 with the paper's `sgd(step_decay(...), momentum=0.9)`; every
   loss finite, each step launches B1 or B2 (as tuned), B3 and B4
   exactly once;
7. the first step's gradients (cuDNN deterministic): the CUDA step
   twice gives the same bits; the conv's backward through B3 and B4
   equals autograd through the plain conv on the step's own cotangent;
   the step with the plain conv has the same loss; the rest of the two
   steps' differences, and the network's own reach (the CUDA step with
   its stem output moved by as much), are reported;
8. the trained model folded and 8-bit quantized (`deploy_params`,
   `quantize_deploy`) and served: 8 requests through `VisionEngine`; the
   served stem against the plain stem by the count rule, the
   probabilities against the plain stem's where no count differs;
9. times on the card (CUDA events, median of 25, L2 flushed between
   runs) of each kernel, its plain version and one library call beside
   the least time the card could take (B5 at skip shares 0, 1/2, 1, its
   ring at the engine's blocks and its B1 body in turns, beside the dense
   B2 at those blocks over 4, 1 and 2 images, one `amax` read of the
   images and one launch that writes 4 bytes, with the ring's launch,
   which must spill nothing; B2
   at depths 2 and 3 x block_h in turns with B1 at the serving, stream
   and training shapes, each with its launch: pixels a thread, threads,
   blocks an SM, registers and local bytes, none spilled, one read of
   the images by `amax` and the library conv; B1's launch (tiles, tile
   pixels, blocks, threads, shared memory, blocks an SM, registers and
   local bytes, which must be 0) beside one `amax` read of the images;
   B6 with its tuned blocks and its launch (tiles, rows a thread, ring
   slots, blocks, registers, local bytes 0) beside one `amax` read of x;
   B4's two passes apart, by the profiler, and its launch:
   blocks, threads, shared memory, registers, blocks an SM and local
   bytes, which must be 0);
   the vision engine's time per launch and its parts; the stream
   engines' time per tick and its parts; the train step's time and its
   parts; B7 at the serving tick's shape (with its launch geometry:
   blocks, threads, shared memory and its one ring depth), and the LM
   engine's time per prefill and per decode tick with their parts;
10. one JSON line ``{"kernels": [...]}`` (B1-B7; the door's launches
    of B1/B2, B5 and B7 under ``launches_by_path["door"]``; the
    frontend's of B1/B2, B3 and B4 under ``"frontend"``, the scale-out
    worlds' ranks' under ``"scale_out"``, the LM scale-out's under
    ``"lm_scale_out"`` (B7's; 0 for B1-B6), the rest of the scale-out's
    under ``"scale_out_rest"`` (B1/B2 and B7; 0 for B3-B6); B7's
    ``"dense"``, ``"moe"``, ``"rglru"``, ``"vlm"`` and ``"encdec"``
    paths, each 0);
11. the card's name and power limit as nvidia-smi gives them, then the
    last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --b4`` runs phases 1, 4 and B4's times alone
(`b4_only`), ``python3 chip_smoke.py --b1b6`` phase 1, the builds of
B1's and B6's sources and their checks and times alone (`b1b6_only`),
each on this tree or, copied into its root, on an older one;
``python3 chip_smoke.py --lm-train`` phase 1, the build of ``wkv.cu``
and phase 5g alone (`lm_train_only`); ``python3 chip_smoke.py --door``
phase 1, the builds of ``p2m_conv.cu`` and ``wkv.cu``, phase 5c and
phase 5h alone, with phase 5's and 5b's main runs as its references
(`door_only`); ``python3 chip_smoke.py --dense`` phase 1, the build of
``p2m_conv.cu`` and phase 5i alone (`dense_only`);
``python3 chip_smoke.py --moe-rglru`` phase 1 and phase 5j alone
(`moe_rglru_only`); ``python3 chip_smoke.py --multimodal`` phase 1, the
builds of ``p2m_conv.cu`` and ``p2m_bwd.cu`` and phase 5k alone
(`multimodal_only`); ``python3 chip_smoke.py --scale-out`` phase 1, the
same two builds and phase 5l alone (`scale_out_only`);
``python3 chip_smoke.py --lm-scale-out`` phase 1, the build of
``wkv.cu``, phase 5c (the single engines 5m (e) is held to) and phase
5m alone (`lm_scale_out_only`); ``python3 chip_smoke.py
--scale-out-rest`` phase 1, the builds of ``p2m_conv.cu`` and ``wkv.cu``
and phase 5n alone (`scale_out_rest_only`).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
REPS = 25
# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet, dense): HBM3 bytes/s, fp32 FLOP/s outside the tensor cores.
# `main` reads them from `repro_torch.launch.mesh`, the port's roofline
# denominators.
PEAK_BYTES_PER_S = PEAK_FP32_FLOPS = None
RAW_TOL = 1e-5
PROBS_TOL = 1e-4


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> list[str]:
    """One line a kernel from nvcc's ``-Xptxas -v`` report: its name
    (demangled where the toolkit's ``cu++filt`` is found), its registers,
    shared memory and its stack frame and spills."""
    import re
    import shutil

    filt = (shutil.which("cu++filt") or shutil.which("c++filt")
            or next((str(p) for p in [Path("/usr/local/cuda/bin/cu++filt")]
                     if p.exists()), None))
    out, name, frame = [], "?", ""
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name, frame = found.group(1), ""
            if filt:
                proc = subprocess.run([filt, name], capture_output=True,
                                      text=True, timeout=60)
                full = re.sub(r"\(anonymous namespace\)::|<unnamed>::|"
                              r"\((?:int|bool)\)", "", proc.stdout.strip())
                name = full.split("(")[0].removeprefix("void ") or name
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {frame}")
    return out


def cuda_ms(torch, fn, flush, reps=REPS) -> float:
    """Median device time of ``fn`` by CUDA events over ``reps`` runs, L2
    flushed before each run (the engine's caller finds it cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn, flush) -> float:
    """Median host time of ``fn`` through its synchronize."""
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and FLOPs over the fp32 rate, and which of them it is."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bwd_inputs(torch, np, dev, images, k, s, n, coeffs, seed):
    """(g, w, x) for the backward kernels: x the im2col matrix of
    ``images``, w (K, N) weights off 0, g (M, N) a random cotangent."""
    from repro_torch.kernels.p2m_conv import conv
    rng = np.random.default_rng(seed)
    x = conv.im2col_matrix(images, k, s).contiguous()
    m, kk = x.shape
    w = rng.uniform(0.05, 1.0, (kk, n)) * rng.choice([-1.0, 1.0], (kk, n))
    g = rng.standard_normal((m, n))
    return (torch.from_numpy(g.astype(np.float32)).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev), x)


def check_backward_kernels(torch, np, dev):
    """Phase 4: B3 and B4 against their plain twins in float64, max abs
    error within 1e-4 of the largest |plain|.  Returns the errors at the
    training shape and that shape's inputs."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.core.p2m_conv import _flat_weights, init_p2m_conv
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import backward, conv
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

    rng = np.random.default_rng(SEED + 7)

    def rand_coeffs(dw, dx):
        return tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                     for _ in range(dw))

    def rand_images(b, h, w, c):
        return torch.from_numpy(rng.random((b, h, w, c), np.float32)).to(dev)

    cases = [  # name, (B, H, W, C), k, s, N, coeffs
        ("k5 s3 N8 dx3", (2, 64, 64, 3), 5, 3, 8, rand_coeffs(3, 3)),
        ("k4 s4 N5 ragged", (3, 37, 41, 3), 4, 4, 5, rand_coeffs(3, 3)),
        ("k5 s5 N13 dx1", (1, 50, 50, 3), 5, 5, 13, rand_coeffs(2, 1)),
        ("k3 s2 N16 dx2", (2, 33, 30, 3), 3, 2, 16, rand_coeffs(3, 2)),
        ("k5 s5 N40 dx4", (1, 40, 40, 3), 5, 5, 40, rand_coeffs(4, 4)),
    ]
    cfg = CONFIG.p2m
    coeffs = _coeff_tuple(default_pixel_model())
    train_imgs = torch.from_numpy(SyntheticVWW(
        image_size=CONFIG.image_size, batch=TRAIN_BATCH,
        seed=SEED).batch_at(0)["images"]).to(dev)
    w_train = _flat_weights(init_p2m_conv(torch.Generator().manual_seed(SEED),
                                          cfg, device=dev)["theta"], cfg)
    errs = {}
    for i, (name, shape, kk, ss, n, cf) in enumerate(
            cases + [("training shape", None, cfg.kernel, cfg.stride,
                      cfg.out_channels, coeffs)]):
        if shape is None:
            g, _, x = bwd_inputs(torch, np, dev, train_imgs, kk, ss, n, cf,
                                 SEED)
            w = w_train.contiguous()
        else:
            g, w, x = bwd_inputs(torch, np, dev, rand_images(*shape), kk, ss,
                                 n, cf, SEED + i)
        wmix = conv.premix_weights(w, cf)
        gx = backward.p2m_bwd_dx(g, wmix, x, cf)
        gw = backward.p2m_bwd_dw(g, w, x, cf)
        torch.cuda.synchronize()
        ref_x = backward.p2m_bwd_dx_plain(g.double(), wmix.double(),
                                          x.double())
        ref_w = backward.p2m_bwd_dw_plain(g.double(), w.double(), x.double(),
                                          cf)
        again = backward.p2m_bwd_dw(g, w, x, cf)
        line = f"[4] {name:16s} M={x.shape[0]} K={x.shape[1]} N={n} " \
               f"dw={len(cf)} dx={len(cf[0])}:"
        for key, got, ref in (("p2m_bwd_dx", gx, ref_x),
                              ("p2m_bwd_dw", gw, ref_w)):
            err = float((got.double() - ref).abs().max())
            scale = float(ref.abs().max())
            line += f" {key} err {err:.3e} (of {scale:.3e})"
            check(err <= 1e-4 * scale, f"{name}: {key} differs by {err}, "
                  f"more than 1e-4 of {scale}")
            if shape is None:
                errs[key] = err
        check(torch.equal(gw, again), f"{name}: B4 differs from run to run")
        print(line)
    return errs, {"g": g, "w": w, "wmix": wmix, "x": x, "coeffs": coeffs}


def train_path(torch, np, dev):
    """Phase 6: the training path at full width.  Returns what the later
    phases read."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import backward, conv
    from repro_torch.models.mobilenetv2 import init_mnv2
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train.vision import make_vww_train_step, vww_train_state

    steps = 6
    params, bn = init_mnv2(torch.Generator().manual_seed(SEED), CONFIG,
                           device=dev)
    # the example's recipe: lr 0.05, x0.2 at 60 % and 85 % of the steps
    opt = sgd(step_decay(0.05, (int(steps * 0.6), int(steps * 0.85))),
              momentum=0.9)
    state = init_state = vww_train_state(params, bn, opt.init(params))
    step = make_vww_train_step(CONFIG, opt)
    data = SyntheticVWW(image_size=CONFIG.image_size, batch=TRAIN_BATCH,
                        seed=SEED)
    batches = [data.batch_at(i) for i in range(steps)]  # set-up, untimed
    wrappers = {"p2m_bwd_dx": backward.p2m_bwd_dx,
                "p2m_bwd_dw": backward.p2m_bwd_dw}

    def counts():
        return {**stem_launches(conv),
                **{k: fn.launches for k, fn in wrappers.items()}}

    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    reset_stem_launches(conv)
    ms, losses = [], []
    for i, batch in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        losses.append(loss)
        check(np.isfinite(loss), f"step {i}: loss {loss}")
        now = counts()
        diff = {k: now[k] - before[k] for k in now}
        # the stem's forward is B1 or B2, as the tuner picked
        check(diff["p2m_bwd_dx"] == diff["p2m_bwd_dw"] == 1
              and diff["p2m_conv_fused"]
              + diff["p2m_conv_fused_pipelined"] == 1,
              f"step {i}: launches {diff}")
        print(f"[6] step {i}: loss {loss:.4f} acc "
              f"{float(metrics['acc']):.3f} {ms[-1]:.1f} ms")
    launches = counts()
    check(launches["p2m_bwd_dx"] == launches["p2m_bwd_dw"] == steps,
          f"training launches {launches}")
    check(state["step"] == steps, f"state step {state['step']}")
    step_ms = statistics.median(ms[1:])
    print(f"[6] trained {steps} steps at batch {TRAIN_BATCH}, "
          f"{CONFIG.image_size}² width {CONFIG.width}: {step_ms:.2f} ms per "
          f"step (median of steps 2-{steps}, host clock through "
          f"synchronize), {TRAIN_BATCH / step_ms * 1e3:.1f} images/s; first "
          f"step {ms[0]:.1f} ms; launches {launches}")
    return {"state": state, "init_state": init_state, "batch": batches[0],
            "opt": opt,
            "launches": launches, "step_ms": step_ms, "losses": losses}


def grad_parity(torch, train):
    """Phase 7: gradients of the first step, the stem's conv on its CUDA
    kernels and on its plain PyTorch version (cuDNN deterministic).

    Held: (a) the CUDA step twice gives the same bits; (b) the conv's
    backward, B3 and B4 through `P2MConvFunction`, equals autograd through
    the plain conv on the step's own cotangent of the conv's output,
    within 1e-4 of the largest gradient; (c) the two steps' losses within
    1e-5.  Reported: the rest of the two steps' differences, and the same
    step with the CUDA stem's output moved by as much as the two convs
    differ, which shows how far the network itself carries such a
    difference."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.core import p2m_conv as core
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.models.mobilenetv2 import apply_mnv2_backbone
    from repro_torch.train.vision import _batch_to, softmax_ce
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    state, batch = train["init_state"], train["batch"]
    params, bn = state["params"], state["bn"]
    cfg, model = CONFIG.p2m, default_pixel_model()
    images, labels = _batch_to(batch, params["fc"]["w"].device)
    backbone = {k: v for k, v in params.items() if k != "stem"}

    def step(impl, nudge=None):
        """Loss, backbone grads, the stem output and its cotangent, the
        conv output's cotangent and the stem's grads: the train form
        written out (`core.apply_p2m_conv_train`'s ops) so that the conv's
        output is at hand."""
        theta = params["stem"]["theta"].detach().requires_grad_(True)
        gamma = params["stem"]["bn_gamma"].detach().requires_grad_(True)
        beta = params["stem"]["bn_beta"].detach().requires_grad_(True)
        raw = core._conv_raw(images, core._flat_weights(theta, cfg), cfg,
                             model, impl)
        flat = raw.reshape(-1, cfg.out_channels)
        mean, var = flat.mean(dim=0), flat.var(dim=0, correction=0)
        y = core.clip(gamma * (flat - mean) / torch.sqrt(var + cfg.bn_eps)
                      + beta, 0.0, cfg.adc.full_scale).reshape(raw.shape)
        x = y.detach() if nudge is None else y.detach() + nudge
        x.requires_grad_(True)
        live = [p.detach().requires_grad_(True) for p in tree_leaves(backbone)]
        tree = tree_unflatten(backbone, live)
        feats, _ = apply_mnv2_backbone(tree, bn, x, CONFIG, train=True)
        loss = softmax_ce(feats.mean(dim=(1, 2)) @ tree["fc"]["w"]
                          + tree["fc"]["b"], labels)
        *g_rest, g_x = torch.autograd.grad(loss, live + [x])
        g_raw, *g_stem = torch.autograd.grad(y, [raw, theta, gamma, beta],
                                             g_x)
        return {"loss": float(loss.detach()), "y": y.detach(), "g_x": g_x,
                "g_raw": g_raw, "rest": tree_unflatten(backbone, g_rest),
                "stem": dict(zip(("theta", "bn_gamma", "bn_beta"), g_stem))}

    def diff(a, b):
        return float((a - b).abs().max()), float(b.abs().max())

    def rel_tree(a, b):
        # per leaf, relative to its own scale, with a floor at float32
        # rounding of the largest gradient for leaves whose exact gradient
        # is 0 (the BN shift before a BN on batch statistics)
        top = max(float(t.abs().max()) for t in tree_leaves(b))
        rel = []
        tree_map(lambda u, v: rel.append(float((u - v).abs().max()) / (
            float(v.abs().max()) + 1e-7 * top)), a, b)
        return max(rel)

    def report(name, a, b):
        print(f"[7] {name}: loss {abs(a['loss'] - b['loss']):.3e} of "
              f"{b['loss']:.4f}; stem output %.3e of %.3e; its cotangent "
              f"%.3e of %.3e; backbone grads largest relative diff "
              f"{rel_tree(a['rest'], b['rest']):.3e}; stem grads " % (
                  *diff(a["y"], b["y"]), *diff(a["g_x"], b["g_x"]))
              + ", ".join(f"{k} %.3e of %.3e" % diff(a["stem"][k],
                                                      b["stem"][k])
                          for k in a["stem"]))

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cuda, again, plain = step("cuda"), step("cuda"), step("plain")
    # (a) the same bits from the same step
    same = (cuda["loss"] == again["loss"]
            and all(torch.equal(u, v) for u, v in zip(
                tree_leaves(cuda["rest"]), tree_leaves(again["rest"])))
            and all(torch.equal(cuda["stem"][k], again["stem"][k])
                    for k in cuda["stem"]))
    print(f"[7] the CUDA step twice: bitwise equal {same}")
    check(same, "the CUDA step is not deterministic")
    # (b) the conv's backward on the step's own cotangent
    conv_cotangent_check(torch, "[7]", images,
                         core._flat_weights(params["stem"]["theta"], cfg),
                         cuda["g_raw"], cfg, model)
    # (c) the two steps
    report("CUDA step vs plain step", cuda, plain)
    check(abs(cuda["loss"] - plain["loss"]) <= 1e-5 * abs(plain["loss"]),
          f"losses {cuda['loss']} and {plain['loss']}")
    # the network's own reach: the CUDA step, its stem output moved by as
    # much as the two convs' outputs differ
    gen = torch.Generator(device=images.device).manual_seed(SEED)
    shift = diff(cuda["y"], plain["y"])[0]
    nudge = shift * (2 * torch.rand(cuda["y"].shape, generator=gen,
                                    device=images.device) - 1)
    report(f"CUDA step vs itself with its stem output moved by up to "
           f"{shift:.1e}", step("cuda", nudge), cuda)
    torch.backends.cudnn.deterministic = False


def fold_and_serve(torch, np, dev, train):
    """Phase 8: fold and 8-bit quantize the trained stem and serve with
    it, the example's train -> deploy -> evaluate flow."""
    from repro_torch.configs.p2m_vww import CONFIG, SERVE_QUANT_BITS
    from repro_torch.core.bn_fold import deploy_params
    from repro_torch.core.p2m_conv import apply_p2m_conv_deploy
    from repro_torch.core.quant import QuantSpec, quantize_deploy
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.models.mobilenetv2 import apply_mnv2_backbone
    from repro_torch.serving import VisionEngine, VisionRequest, drive
    from repro_torch.train.vision import make_vww_eval

    params, bn = train["state"]["params"], train["state"]["bn"]
    dep = quantize_deploy(deploy_params(params["stem"], bn["stem"],
                                        CONFIG.p2m),
                          QuantSpec(SERVE_QUANT_BITS, SERVE_QUANT_BITS))
    engine = VisionEngine(params, bn, CONFIG, device=dev)
    check(torch.equal(engine._deploy["w"], dep["w"])
          and torch.equal(engine._deploy["shift"], dep["shift"]),
          "the engine's deploy tree is not the folded, quantized stem")
    images = SyntheticVWW(image_size=CONFIG.image_size, batch=8,
                          seed=SEED + 2).batch_at(0)
    before = sum(stem_launches(conv).values())
    drive(engine, [VisionRequest(uid=i, image=images["images"][i])
                   for i in range(8)], on_undrained="raise")
    torch.cuda.synchronize()
    done = engine.completed
    check([r.uid for r in done] == list(range(8)),
          f"completion order {[r.uid for r in done]}")
    check(sum(stem_launches(conv).values()) - before
          == engine.stats["launches"], "served without the kernel")
    probs = np.stack([r.probs for r in done])
    check(bool(np.isfinite(probs).all()), "served probs not finite")
    x = torch.from_numpy(images["images"]).to(dev)
    cfg = CONFIG.p2m
    with torch.no_grad():
        stem_k = apply_p2m_conv_deploy(engine._deploy, x, cfg)
        stem_p = apply_p2m_conv_deploy(engine._deploy, x, cfg, impl="plain")
        _, raw = conv.p2m_conv_premixed_plain(
            x, engine._deploy["wrows"], torch.zeros_like(dep["shift"]),
            kernel=cfg.kernel, stride=cfg.stride, mode="raw", want_raw=True)
    rep = conv.quant_disagreement(stem_k, stem_p, raw, cfg.adc.v_lsb)
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"served stem vs plain stem: {rep}")
    # The served probabilities, every one, against the backbone run here
    # on the kernel's own stem: both sides see the same stem values.
    with torch.no_grad():
        feats, _ = apply_mnv2_backbone(engine._params, engine._bn, stem_k,
                                       CONFIG)
        logits = (feats.mean(dim=(1, 2)) @ engine._params["fc"]["w"]
                  + engine._params["fc"]["b"])
        own = torch.softmax(logits, dim=-1).cpu().numpy()
    own_diff = float(np.abs(own - probs).max())
    check(own_diff <= PROBS_TOL, f"served probs differ from the backbone "
          f"on the kernel's stem by {own_diff}")
    # Against the plain stem's, on every image whose stem counts all agree:
    # a count that flips at a half count (the count rule allows it) moves
    # its image's probabilities by the trained network's gain on one
    # count, which can exceed PROBS_TOL.
    plain = engine.forward(x, p2m_impl="plain").cpu().numpy()
    agree = (stem_k == stem_p).flatten(1).all(dim=1).cpu().numpy()
    diff = float(np.abs(plain - probs)[agree].max(initial=0.0))
    check(diff <= PROBS_TOL, f"served probs differ from the plain stem's "
          f"by {diff} on an image whose stem counts all agree")
    # The unfolded model on its running statistics, for comparison only:
    # six steps leave them far from the weights' batch statistics.
    acc_eval = make_vww_eval(CONFIG)(params, bn, images)
    acc_served = float((probs.argmax(-1) == images["labels"]).mean())
    print(f"[8] folded, {SERVE_QUANT_BITS}-bit stem served 8 requests in "
          f"{engine.stats['launches']} launch(es); stem vs plain stem "
          f"{rep['n_diff']} counts differ (at half counts); probs vs the "
          f"backbone on the kernel's stem {own_diff:.3e} (8 images), vs "
          f"plain stem {diff:.3e} ({int(agree.sum())} images whose stem "
          f"counts all agree); accuracy served {acc_served:.3f}, unfolded "
          f"eval {acc_eval:.3f}")


def time_backward_kernels(torch, bwd, flush):
    """Times of B3 and B4 at the training shape beside their plain twins,
    a one-call library yardstick of their contraction part and the
    bound.  Returns each kernel's row of the kernels line."""
    from repro_torch.kernels.p2m_conv import backward

    g, w, wmix, x, coeffs = (bwd[k] for k in ("g", "w", "wmix", "x",
                                              "coeffs"))
    m, kk = x.shape
    n = g.shape[1]
    dx = wmix.shape[0]
    counted = (backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches)
    rows = {}
    # B3: the contraction part is one product g @ W~cat^T.
    wcat_t = wmix.permute(2, 0, 1).reshape(n, dx * kk).contiguous()
    nbytes = 4 * (x.numel() + g.numel() + wmix.numel() + x.numel())
    flops = 2 * m * n * dx * kk + 3 * dx * m * kk
    b_ms, b_by = bound(nbytes, flops)
    rows["p2m_bwd_dx"] = {
        "ms": cuda_ms(torch, lambda: backward.p2m_bwd_dx(g, wmix, x, coeffs),
                      flush),
        "plain_ms": cuda_ms(torch, lambda: backward.p2m_bwd_dx_plain(
            g, wmix, x), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lambda: torch.matmul(g, wcat_t), flush),
    }
    # B4: the contraction part is one product xcat^T @ g, xcat built here.
    xcat = torch.cat([x ** (j + 1) for j in range(dx)], dim=1)
    nbytes = 4 * (x.numel() + g.numel() + w.numel() + w.numel())
    flops = 2 * m * kk * n * dx + m * kk * (dx - 1)
    b_ms, b_by = bound(nbytes, flops)
    rows["p2m_bwd_dw"] = {
        "ms": cuda_ms(torch, lambda: backward.p2m_bwd_dw(g, w, x, coeffs),
                      flush),
        "plain_ms": cuda_ms(torch, lambda: backward.p2m_bwd_dw_plain(
            g, w, x, coeffs), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lambda: torch.matmul(xcat.t(), g),
                              flush),
    }
    del xcat
    backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches = counted
    for name, row in rows.items():
        print(f"[9] {name} at M={m} K={kk} N={n} dx={dx}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"matmul of the contraction {row['library_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
    # B4's two passes apart, and its launch
    passes = b4_passes(torch, g, w, x, coeffs, flush)
    check(bool(passes), "the profiler saw no device time of B4")
    launch = backward.dw_launch(m, kk, n, dx)
    check(launch["local_bytes"] == 0 and launch["pass2_local_bytes"] == 0,
          f"B4 spills to local memory: {launch}")
    rows["p2m_bwd_dw"]["passes_ms"] = passes
    # one read of B4's inputs under the same timing: the flush leaves L2
    # dirty, so a read of X and G pays for write-backs too
    read_ms = cuda_ms(torch, lambda: (x.amax(), g.amax()), flush)
    print("[9] p2m_bwd_dw by kernel (mean of "
          f"{REPS}, profiler, L2 flushed): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
          + f"; one read of X and G (amax) {read_ms:.4f} ms")
    print(f"[9] p2m_bwd_dw launch: pass one {launch['blocks_x']} x "
          f"{launch['blocks_y']} blocks of {launch['threads']} threads "
          f"({launch['rows_per_block']} rows a block in tiles of "
          f"{launch['tile_rows']}), {launch['smem_bytes']} B dynamic shared "
          f"memory, {launch['registers']} registers, "
          f"{launch['local_bytes']} B local, {launch['blocks_per_sm']} "
          f"blocks an SM; pass two {launch['pass2_blocks']} blocks of "
          f"{launch['pass2_threads']} threads, {launch['pass2_registers']} "
          f"registers, {launch['pass2_local_bytes']} B local, "
          f"{launch['pass2_blocks_per_sm']} blocks an SM")
    return rows


def b4_passes(torch, g, w, x, coeffs, flush) -> dict:
    """B4's device time by kernel: ``torch.profiler`` (CUPTI) over REPS
    calls at these inputs, L2 flushed before each; the mean ms a launch
    of each kernel whose name holds ``p2m_bwd_dw``, by its short name.
    Empty where the profiler saw no device time.  Restores the count."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.p2m_conv import backward

    counted = backward.p2m_bwd_dw.launches
    for _ in range(3):
        backward.p2m_bwd_dw(g, w, x, coeffs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            backward.p2m_bwd_dw(g, w, x, coeffs)
        torch.cuda.synchronize()
    backward.p2m_bwd_dw.launches = counted
    out = {}
    for ev in prof.key_averages():
        found = re.search(r"p2m_bwd_dw\w*(<\d+>)?", ev.key)
        total = (getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0))
        if found and total > 0 and ev.count:
            out[found.group(0)] = total / ev.count / 1e3
    return out


def b4_only(torch, np, dev) -> int:
    """``chip_smoke.py --b4``: phase 1, the build of ``p2m_bwd.cu`` with
    its ptxas lines, phase 4, then B4 at the training shape timed whole
    (CUDA events) and by kernel (`b4_passes`).  It reads only what every
    tree of the port since PR 13 has, so a copy of this script in the
    root of an older tree times that tree's B4."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import backward

    print(f"[1] card: {smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    backward.build_p2m_bwd()
    seconds, report = _build.BUILD_INFO["p2m_bwd"]
    print(f"[2] p2m_bwd.cu: nvcc {seconds:.2f} s")
    for line in ptxas_summary(report):
        print(f"    ptxas: {line}")
    bwd_err, bwd = check_backward_kernels(torch, np, dev)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    g, w, x, coeffs = (bwd[k] for k in ("g", "w", "x", "coeffs"))
    ms = cuda_ms(torch, lambda: backward.p2m_bwd_dw(g, w, x, coeffs), flush)
    passes = b4_passes(torch, g, w, x, coeffs, flush)
    check(bool(passes), "the profiler saw no device time of B4")
    read_ms = cuda_ms(torch, lambda: (x.amax(), g.amax()), flush)
    print(f"[9] p2m_bwd_dw at M={x.shape[0]} K={x.shape[1]} N={g.shape[1]}: "
          f"{ms:.4f} ms (median of {REPS}, CUDA events); by kernel "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
          + f" (mean, profiler); one read of X and G (amax) {read_ms:.4f} ms")
    print(json.dumps({"b4": {"ms": ms, "passes_ms": passes,
                             "read_ms": read_ms,
                             "max_abs_err": bwd_err["p2m_bwd_dw"]}}))
    return 0


def b1b6_inputs(torch, np, dev):
    """``--b1b6``'s inputs, random from a seed: 8 SyntheticVWW images at
    560² (the serving batch; its first 4 the stream's), 32 random images
    (the training batch), the stem's weights (75 x 8, the model's init
    scale) premixed with the default pixel model, a shift, and x
    (100,352 x 75) for B6.  Returns (stem shapes as `b2_shapes` gives
    them, (x, w, shift, coeffs))."""
    from repro_torch.configs.p2m_vww import CONFIG, SERVE_MAX_BATCH
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv, ops

    coeffs = ops._coeff_tuple(default_pixel_model())
    size = CONFIG.image_size
    rng = np.random.default_rng(SEED + 40)
    imgs = torch.from_numpy(SyntheticVWW(
        image_size=size, batch=SERVE_MAX_BATCH, seed=SEED).batch_at(0)[
            "images"]).to(dev)
    wt = torch.from_numpy((rng.uniform(-1, 1, (75, 8)) * (3.0 / 75) ** 0.5)
                          .astype(np.float32))
    wrows = conv.premix_rows(wt, coeffs, 5).to(dev)
    shift = torch.from_numpy(rng.uniform(-0.2, 0.2, 8).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.random((100_352, 75), np.float32)).to(dev)
    return (b2_shapes(torch, np, dev, (imgs, wrows, shift)),
            (x, wt.to(dev), shift, coeffs))


def b1b6_only(torch, np, dev) -> int:
    """``chip_smoke.py --b1b6``: phase 1, the builds of ``p2m_conv.cu`` and
    ``p2m_matmul.cu`` with their ptxas lines, then B1 and B6 alone.  At
    phase 9's three stem shapes (serving and stream quant, training raw):
    B1 against its plain twin, B2 == B1 bit for bit, then B1 and B2
    (depths 2, 3 x block_h 1, 2, 4) in turns (`time_b2_shape`) and one
    `amax` read of the images.  At (100,352, 75, 8) quant: B6 with the
    tuner's blocks against its plain twin, beside `torch.matmul` of the
    power concat and one `amax` read of x.  Every time by `cuda_ms`.  It
    reads only what every tree of the port with B6 and the tuner has
    (B1's and B6's launch reports where the tree has them), so a copy of
    this script in the root of an older tree times that tree's B1 and
    B6."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv, tune
    from repro_torch.kernels.p2m_conv import kernel as mm_kernel

    adc = CONFIG.p2m.adc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] card: {smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(mm_kernel.build_p2m_matmul)]:
            job.result()
    for name in ("p2m_conv", "p2m_matmul"):
        seconds, report = _build.BUILD_INFO[name]
        print(f"[2] {name}.cu: nvcc {seconds:.2f} s")
        for line in ptxas_summary(report):
            print(f"    ptxas: {line}")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    shapes, (x, w, sh, coeffs) = b1b6_inputs(torch, np, dev)
    result = {"b1": {}}
    for name, ((imgs, wrows, shift), mode, _) in shapes.items():
        qkw = dict(kernel=5, stride=5, mode=mode, v_lsb=adc.v_lsb,
                   max_count=adc.max_count)
        out1, raw1 = conv.p2m_conv_fused(imgs, wrows, shift, want_raw=True,
                                         **qkw)
        _, ref_raw = conv.p2m_conv_premixed_plain(imgs, wrows, shift,
                                                  want_raw=True, **qkw)
        err = float((raw1 - ref_raw).abs().max())
        check(err <= RAW_TOL, f"B1 at {name}: raw differs by {err}")
        for depth in (2, 3):
            out2, raw2 = conv.p2m_conv_fused(imgs, wrows, shift, want_raw=True,
                                             pipeline_depth=depth, **qkw)
            check(torch.equal(out2, out1) and torch.equal(raw2, raw1),
                  f"B2 at {name}, depth {depth}, differs from B1")
        times, b1 = time_b2_shape(torch, flush, (imgs, wrows, shift), qkw,
                                  (1, 2, 4))
        read_ms = cuda_ms(torch, imgs.amax, flush)
        best = min(times, key=times.get)
        print(f"[9] B1 at {name} {mode}: {b1[0]:.4f} and {b1[1]:.4f} ms (in "
              f"turns with B2); raw vs plain {err:.1e}; B2 == B1 bitwise; "
              f"B2 (block_h, depth): "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; fastest B2 {best} {times[best]:.4f} ms; one read of the "
              f"images (amax) {read_ms:.4f} ms")
        result["b1"][name] = {"b1_ms": b1, "b2_ms": {
            f"{k[0]},{k[1]}": v for k, v in times.items()},
            "read_ms": read_ms, "raw_err": err}
        if hasattr(conv, "b1_launch"):
            dx = wrows.shape[1] // (5 * imgs.shape[3])
            geo = conv.b1_launch(tuple(imgs.shape), wrows.shape[2], dx,
                                 kernel=5, stride=5)
            print(f"[9] B1 launch at {name}: {geo}")
            result["b1"][name]["launch"] = geo
    m, kk = x.shape
    n = w.shape[1]
    blocks = tune.get_matmul_blocks(m, kk, n, coeffs, "quant", device=dev)
    rec = tune.decision_records()[-1]
    print(f"[3f] B6 tuner at ({m}, {kk}, {n}) quant, (block_m, block_n, "
          f"block_k): ms: " + ", ".join(
              f"{tuple(c)} {t * 1e3:.4f}" for c, t in zip(
                  rec["candidates"], rec["times_s"]) if t is not None))
    bm, bn, bk = blocks
    kw = dict(coeffs=coeffs, mode="quant", v_lsb=adc.v_lsb,
              max_count=adc.max_count)
    _, raw = mm_kernel.p2m_matmul_fused(x, w, sh, want_raw=True, block_m=bm,
                                        block_n=bn, block_k=bk, **kw)
    ref_raw = mm_kernel.p2m_matmul_raw_plain(x, w, coeffs)
    err = float((raw - ref_raw).abs().max())
    check(err <= RAW_TOL, f"B6 raw differs by {err}")
    dx = len(coeffs[0])
    xcat = torch.cat([x ** (j + 1) for j in range(dx)], dim=1)
    wcat = conv.premix_weights(w, coeffs).reshape(dx * kk, n)
    b6 = []
    library = []
    for _ in range(2):  # in turns: B6, library, B6, library
        b6.append(cuda_ms(torch, lambda: mm_kernel.p2m_matmul_fused(
            x, w, sh, block_m=bm, block_n=bn, block_k=bk, **kw), flush))
        library.append(cuda_ms(torch, lambda: torch.matmul(xcat, wcat),
                               flush))
    read_ms = cuda_ms(torch, x.amax, flush)
    print(f"[9] B6 at ({m}, {kk}, {n}) quant, tuner's blocks {blocks}: "
          f"{b6[0]:.4f} and {b6[1]:.4f} ms; raw vs plain {err:.1e}; "
          f"torch.matmul of the power concat {library[0]:.4f} and "
          f"{library[1]:.4f} ms; one read of x (amax) {read_ms:.4f} ms")
    result["b6"] = {"blocks": list(blocks), "ms": b6, "library_ms": library,
                    "read_ms": read_ms, "raw_err": err}
    if hasattr(mm_kernel, "matmul_launch"):
        geo = mm_kernel.matmul_launch(m, kk, n, dx, block_m=bm, block_n=bn,
                                      block_k=bk)
        print(f"[9] B6 launch: {geo}")
        result["b6"]["launch"] = geo
    print(json.dumps({"b1b6": result}))
    return 0


def time_train_step(torch, train, flush):
    """Where a training step's time goes: each part timed alone on the
    step's own inputs (device time by CUDA events, launch gaps
    included), beside the whole step (host clock)."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.core.p2m_conv import _flat_weights
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import backward, conv
    from repro_torch.kernels.p2m_conv.ops import p2m_conv
    from repro_torch.models.mobilenetv2 import (
        apply_mnv2_backbone,
        apply_mnv2_stem,
    )
    from repro_torch.train.vision import _batch_to, softmax_ce
    from repro_torch.tree import tree_leaves, tree_unflatten

    state, batch, opt = train["state"], train["batch"], train["opt"]
    params, bn = state["params"], state["bn"]
    dev = params["fc"]["w"].device
    images, labels = _batch_to(batch, dev)
    counted = {fn: fn.launches for fn in (backward.p2m_bwd_dx,
                                          backward.p2m_bwd_dw)}
    counted_stem = stem_launches(conv)
    cfg = CONFIG.p2m
    theta = params["stem"]["theta"].detach().requires_grad_(True)
    stem_p = {**params["stem"], "theta": theta}

    def stem_fwd():
        return apply_mnv2_stem({"stem": stem_p}, bn, images, CONFIG,
                               train=True)[0]

    stem_out = stem_fwd()
    g_stem = torch.randn_like(stem_out)
    parts = {"batch to the card (numpy, pageable; host clock)": wall_ms(
        torch, lambda: _batch_to(batch, dev), flush)}
    fwd_name = "stem forward (conv, B1 or B2 as tuned, + BN + clamp)"
    parts[fwd_name] = cuda_ms(torch, stem_fwd, flush)
    parts["stem backward (forward + backward, less the forward)"] = cuda_ms(
        torch, lambda: torch.autograd.grad(stem_fwd(), theta, g_stem),
        flush) - parts[fwd_name]
    w = _flat_weights(theta.detach(), cfg)
    zero = torch.zeros(cfg.out_channels, device=dev)
    parts["  im2col of the images"] = cuda_ms(
        torch, lambda: conv.im2col_matrix(images, cfg.kernel, cfg.stride),
        flush)
    im = images.detach().requires_grad_(True)
    x = conv.im2col_matrix(im, cfg.kernel, cfg.stride)
    gx = torch.randn_like(x)
    parts["  col2im (autograd of im2col)"] = cuda_ms(
        torch, lambda: torch.autograd.grad(x, im, gx, retain_graph=True),
        flush)
    w.requires_grad_(True)
    parts["  conv Function forward + backward (B1 or B2, im2col, B3, B4, "
          "col2im)"] = cuda_ms(torch, lambda: torch.autograd.grad(
              p2m_conv(images, w, zero, default_pixel_model(), cfg.adc,
                       "raw", cfg.kernel, cfg.stride).sum(), w), flush)

    leaves = tree_leaves({k: v for k, v in params.items() if k != "stem"})
    live = [p.detach().requires_grad_(True) for p in leaves]
    rest = tree_unflatten({k: v for k, v in params.items() if k != "stem"},
                          live)
    stem_in = stem_out.detach().requires_grad_(True)

    def backbone_fwd():
        feats, _ = apply_mnv2_backbone(rest, bn, stem_in, CONFIG, train=True)
        logits = feats.mean(dim=(1, 2)) @ rest["fc"]["w"] + rest["fc"]["b"]
        return softmax_ce(logits, labels)

    parts["backbone + head forward"] = cuda_ms(torch, backbone_fwd, flush)
    parts["backbone + head forward + backward"] = cuda_ms(
        torch, lambda: torch.autograd.grad(backbone_fwd(), live + [stem_in]),
        flush)
    grads = tree_unflatten(params, [torch.randn_like(p)
                                    for p in tree_leaves(params)])
    parts["optimizer update (sgd, momentum)"] = cuda_ms(
        torch, lambda: opt.update(grads, state["opt"], params, 6), flush)
    for fn, n in counted.items():
        fn.launches = n
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted_stem.values()
    for name, ms in parts.items():
        print(f"[9] train step part: {name}: {ms:.3f} ms")
    print(f"[9] train step, whole: {train['step_ms']:.3f} ms (host clock)")


STREAM_LENGTHS = (12, 8, 12, 6, 12, 10)
NOISY_STREAM = 3  # the one stream with per-frame noise: it never skips


#: B5's bodies and blocks phase 3b holds: (pipeline_depth, block_h).
#: Depth 0 is B1's gated body; the rest the ring, block_h clamped to a
#: divisor of Ho.
GATED_BLOCKS = ((0, None), (2, 1), (2, 2), (3, 4))


def check_gated_kernel(torch, np, dev, imgs, wrows, shift, rand_case, adc):
    """Phase 3b: the gated stem (B5), both bodies (B1's and the ring, at
    `GATED_BLOCKS`), against B1 + `torch.where` and against the dense
    kernel at the same blocks + where, bit for bit, and against its plain
    twin (raw, relu within 1e-5; quant by the count rule), over masks
    (all re-run, all skip, mixed, one slot), geometries (the stream shape,
    s < k, Ho = 1) and modes.  Returns the largest raw/relu difference
    from the plain twin at the stream shape."""
    from repro_torch.kernels.p2m_conv import conv, gated

    masks = {"all rerun": [1, 1, 1, 1], "all skip": [0, 0, 0, 0],
             "mixed": [1, 0, 0, 1], "one slot": [0, 0, 1, 0]}
    gen = torch.Generator().manual_seed(SEED + 3)
    geoms = [("stream k5 s5", (imgs, wrows, shift), 5, 5),
             ("k5 s3", rand_case(4, 64, 64, 3, 5, 8), 5, 3),
             ("Ho=1 k5 s5", rand_case(4, 5, 5, 3, 5, 8), 5, 5)]
    stream_err = 0.0
    for name, (x, wr, sh), kk, ss in geoms:
        b = x.shape[0]
        ho = (x.shape[1] - kk) // ss + 1
        wo = (x.shape[2] - kk) // ss + 1
        cached = torch.rand((b, ho, wo, wr.shape[2]), generator=gen).to(dev)
        for mode in ("raw", "relu", "quant"):
            kw = dict(kernel=kk, stride=ss, mode=mode, v_lsb=adc.v_lsb,
                      max_count=adc.max_count)
            b1 = conv.p2m_conv_fused(x, wr, sh, **kw)
            _, raw = conv.p2m_conv_premixed_plain(
                x, wr, torch.zeros_like(sh), want_raw=True,
                **{**kw, "mode": "raw"})
            line = f"[3b] {name:13s} {mode:5s} {tuple(b1.shape)}:"
            errs = {}
            for depth, bh in GATED_BLOCKS:
                aligned = gated.aligned_block_h(
                    ho, bh or conv.default_block_h(b * ho, wo))
                dense = conv.p2m_conv_fused(x, wr, sh, block_h=aligned,
                                            pipeline_depth=depth, **kw)
                for mname, mask in masks.items():
                    rerun = torch.tensor(mask, dtype=torch.bool, device=dev)
                    got = gated.p2m_conv_fused_gated(
                        x, wr, sh, cached, rerun, block_h=bh,
                        pipeline_depth=depth, **kw)
                    torch.cuda.synchronize()
                    sel = rerun[:, None, None, None]
                    case = f"{name} {mode} {mname} depth {depth} block_h {bh}"
                    check(torch.equal(got, torch.where(sel, b1, cached)),
                          f"{case}: B5 differs from B1 + where")
                    check(torch.equal(got, torch.where(sel, dense, cached)),
                          f"{case}: B5 differs from the dense kernel at its "
                          "blocks + where")
                    plain = gated.p2m_conv_gated_plain(x, wr, sh, cached,
                                                       rerun, **kw)
                    if mode == "quant":
                        rep = conv.quant_disagreement(got, plain, raw,
                                                      adc.v_lsb)
                        check(rep["max_count_diff"] <= 1
                              and rep["share"] <= 1e-4
                              and rep["all_near_half"],
                              f"{case}: quant counts disagree: {rep}")
                        errs[mname] = f"={rep['n_diff']} counts"
                    else:
                        err = float((got - plain).abs().max())
                        check(err <= RAW_TOL, f"{case}: B5 vs plain {err}")
                        if name.startswith("stream"):
                            stream_err = max(stream_err, err)
                        errs[mname] = f"{err:.1e}"
            line += "".join(f" {m} {e}" for m, e in errs.items())
            print(line + " (bitwise = B1 + where and = the dense kernel at "
                  "the same blocks + where, in every mask, at (depth, "
                  f"block_h) {GATED_BLOCKS})")
    return stream_err


def stream_frames(image_size: int) -> list:
    """Phase 5b's six hold-2 streams (the 6-frame one noisy)."""
    from repro_torch.video import SyntheticVideo

    return [SyntheticVideo(image_size=image_size, n_frames=n, hold=2,
                           seed=SEED + i,
                           noise=0.02 if i == NOISY_STREAM else 0.0).frames()
            for i, n in enumerate(STREAM_LENGTHS)]


def stream_head(torch, dev, cfg):
    """Phase 5b's detection head: `DetectConfig()` from seed 1."""
    from repro_torch.models.mobilenetv2 import head_out_channels
    from repro_torch.video import DetectConfig, init_detect_head

    return init_detect_head(torch.Generator().manual_seed(SEED + 1),
                            head_out_channels(cfg), DetectConfig(),
                            device=dev)


def stream_path(torch, np, dev, params, bn):
    """Phase 5b: the streaming path at full width.  ``StreamEngine`` on
    `CONFIG` with 4 slots (`STREAM_MAX_SLOTS`), the port's detection head
    from a seed, six hold-2 `SyntheticVideo` streams of mixed lengths at
    560² (one with per-frame noise), through `drive()`: the gated engine
    (the default on the card), the where engine and the dense engine
    (``threshold=None``).  Returns what the timings read."""
    from repro_torch.configs.p2m_vww import CONFIG, STREAM_MAX_SLOTS
    from repro_torch.core.bandwidth import frame_output_bits
    from repro_torch.core.p2m_conv import deploy_conv_blocks
    from repro_torch.kernels.p2m_conv import conv, gated
    from repro_torch.serving import drive
    from repro_torch.video import DeltaGateConfig, StreamEngine, StreamRequest

    t0 = time.perf_counter()
    frames = stream_frames(CONFIG.image_size)
    setup_s = time.perf_counter() - t0
    det = stream_head(torch, dev, CONFIG)

    def requests():
        return [StreamRequest(uid=i, frames=f) for i, f in enumerate(frames)]

    def run(threshold=0.0, **kw):
        eng = StreamEngine(params, bn, CONFIG, det,
                           gate=DeltaGateConfig(threshold=threshold),
                           device=dev, **kw)
        torch.cuda.synchronize()
        reset_gated_launches(gated)
        reset_stem_launches(conv)
        t0 = time.perf_counter()
        drive(eng, requests(), on_undrained="raise")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**gated_launches(gated), **stem_launches(conv)}
        done = eng.completed
        check(sorted(r.uid for r in done) == list(range(len(frames)))
              and not eng.failed and not eng.evicted,
              f"{eng.stem_path}: completion {[r.uid for r in done]}, failed "
              f"{len(eng.failed)}, evicted {len(eng.evicted)}")
        for r in done:
            for boxes, scores in r.frame_outputs:
                check(boxes.shape == (eng.det_cfg.max_dets, 4)
                      and scores.shape == (eng.det_cfg.max_dets,)
                      and bool(np.isfinite(boxes).all())
                      and bool(np.isfinite(scores).all()),
                      f"stream {r.uid}: outputs not finite or misshapen")
        print(f"[5b] {eng.stem_path:5s} engine, threshold {threshold}: "
              f"{len(done)} streams, {sum(r.frames_done for r in done)} "
              f"frames in {eng.stats['launches']} ticks ({seconds:.2f} s); "
              f"launches {counts}; summary {eng.stream_summary()}")
        return eng, done, counts

    def same_outputs(a, b):
        return all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                   for ra, rb in zip(a, b)
                   for x, y in zip(ra.frame_outputs, rb.frame_outputs))

    def ledgers(done):
        return [(r.uid, r.served_tick, r.finished_tick, r.frames_done,
                 r.ledger.summary()) for r in done]

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    g_eng, g_done, g_counts = run()  # the main path: stem_path="auto"
    w_eng, w_done, w_counts = run(stem_path="where")
    d_eng, d_done, _ = run(threshold=None)
    check(g_eng.stem_path == "gated" and d_eng.stem_path == "gated",
          f"auto picked {g_eng.stem_path} on the card")
    ticks = g_eng.stats["launches"]
    # The tuner's blocks for the engines' stem signature (a cache hit: the
    # engines asked it): B5 runs the body of its depth, once a tick.
    blocks = deploy_conv_blocks(torch.empty(
        STREAM_MAX_SLOTS, CONFIG.image_size, CONFIG.image_size, 3,
        device=dev), CONFIG.p2m)
    body = ("p2m_conv_fused_gated_pipelined" if blocks[2] >= 2
            else "p2m_conv_fused_gated")
    want = {name: 0 for name in g_counts}
    check(g_counts == {**want, body: ticks},
          f"gated engine launches {g_counts} in {ticks} ticks, tuner's "
          f"blocks {blocks}")
    # the where engine's stem is B1 or B2, as the tuner picked
    check(w_counts["p2m_conv_fused_gated"] == 0
          and w_counts["p2m_conv_fused_gated_pipelined"] == 0
          and w_counts["p2m_conv_fused"]
          + w_counts["p2m_conv_fused_pipelined"] == w_eng.stats["launches"],
          f"where engine launches {w_counts}")
    check(ledgers(g_done) == ledgers(w_done),
          "gated and where engines' ledgers differ")
    check(same_outputs(g_done, w_done),
          "gated and where engines' boxes or scores differ")
    check(same_outputs(g_done, d_done),
          "gated (threshold 0) and dense engines' boxes or scores differ")
    check(all(r.skip_count == 0 for r in d_done), "the dense engine skipped")
    for r in g_done:
        want = 0.0 if r.uid == NOISY_STREAM else 0.5
        check(r.skip_rate == want, f"stream {r.uid}: skip rate "
              f"{r.skip_rate}, not {want}")
    frames_n = sum(STREAM_LENGTHS)
    skips = sum(n // 2 for i, n in enumerate(STREAM_LENGTHS)
                if i != NOISY_STREAM)
    dense_bits = frame_output_bits(g_eng.geom)
    bits = (frames_n - skips) * dense_bits + frames_n
    summary = g_eng.stream_summary()
    check(summary["frames"] == frames_n
          and summary["stem_skip_rate"] == skips / frames_n
          and summary["stem_flops_skipped_ratio"] == skips / frames_n
          and summary["measured_reduction_vs_dense"]
          == dense_bits / (bits / frames_n),
          f"stream summary {summary}")
    print(f"[5b] gated == where (ledgers, boxes, scores: bitwise), gated == "
          f"dense at threshold 0 (bitwise); skip rate {skips}/{frames_n} = "
          f"{skips / frames_n:.4f} (each noiseless stream 0.5, the noisy "
          f"one 0); measured reduction vs dense "
          f"{summary['measured_reduction_vs_dense']:.6f}; B5 launched "
          f"{g_counts[body]} times in {ticks} ticks on "
          f"{'the ring' if blocks[2] >= 2 else 'the B1 body'} at the "
          f"tuner's blocks {tuple(blocks)}, B1 and B2 0 times; the where "
          f"engine launched B1 {w_counts['p2m_conv_fused']} and B2 "
          f"{w_counts['p2m_conv_fused_pipelined']} times; frames made in "
          f"{setup_s:.2f} s")

    # A corrupted cache: slot 0's stem becomes NaN after its first frame.
    eng = StreamEngine(params, bn, CONFIG, det, device=dev, max_streams=2)
    for r in requests()[:2]:
        eng.submit(r)
    eng.step()
    eng._cached_stem[0] = float("nan")
    eng.run(on_undrained="raise")
    a, b = eng.completed
    check(a.uid == 1 and b.uid == 0, f"order {[a.uid, b.uid]}")
    check(b.skip_count == 0 and eng._gates[0].disabled
          and eng.health()["gate_faults"] == 1 and a.skip_count == 4,
          f"NaN cache: skips {b.skip_count}/{a.skip_count}, health "
          f"{eng.health()}")
    check(all(bool(np.isfinite(s).all()) for r in (a, b)
              for _, s in r.frame_outputs), "NaN reached the outputs")
    print(f"[5b] NaN cache in slot 0: the stream re-ran every frame "
          f"(skips 0 of {b.frames_done}), its gate dropped to dense, "
          f"gate_faults {eng.health()['gate_faults']}; slot 1 kept "
          f"skipping ({a.skip_count} of {a.frames_done})")
    torch.backends.cudnn.deterministic = False
    return {"gated": g_eng, "where": w_eng, "frames": frames,
            "requests": requests, "launches": g_counts,
            "where_launches": w_counts, "ticks": ticks,
            "slots": STREAM_MAX_SLOTS, "blocks": tuple(blocks)}


def time_stream(torch, np, dev, stream, flush, adc):
    """Phase 9, stream part: B5 alone at skip shares 0, 1/2 and 1, its
    ring at the engine's blocks (the tuner's) and its B1 body (depth 0) in
    turns (ring, B1 body, B1 body, ring), beside its bound, the dense B2 at
    the same blocks, one `amax` read of the images, its plain twin and the
    library conv2d + where; the ring's launch; the engines' time per tick,
    warm; and the parts of a tick.  Returns B5's row of the kernels line,
    without launches and error."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.kernels.p2m_conv import conv, gated
    from repro_torch.models.mobilenetv2 import apply_mnv2_backbone
    from repro_torch.serving import drive
    from repro_torch.video.delta import frame_delta
    from repro_torch.video.detect import (
        apply_detect_head,
        decode_detections,
        det_grid,
    )

    eng = stream["gated"]
    b = stream["slots"]
    cfg = CONFIG.p2m
    k, s = cfg.kernel, cfg.stride
    size = CONFIG.image_size
    dep = eng._deploy
    wrows, shift = dep["wrows"], dep["shift"]
    n = wrows.shape[2]
    dx = wrows.shape[1] // (k * 3)
    ho = cfg.out_spatial(size)
    frames = stream["frames"]
    images = torch.from_numpy(np.stack([f[0] for f in frames[:b]])).to(dev)
    cached = torch.rand((b, ho, ho, n), generator=torch.Generator()
                        .manual_seed(SEED + 4)).to(dev)
    qkw = dict(kernel=k, stride=s, mode="quant", v_lsb=adc.v_lsb,
               max_count=adc.max_count)
    counted = (gated_launches(gated), stem_launches(conv))
    # The engine's blocks; the ring at (2, None, 2) where the tuner picked
    # B1 (then the engine ran the B1 body).
    bh, bn, depth = stream["blocks"]
    engine_kw = dict(block_h=bh, block_n=bn, pipeline_depth=depth)
    ring_kw = engine_kw if depth >= 2 else dict(block_h=2, block_n=None,
                                                pipeline_depth=2)
    bodies = {"ring": ring_kw, "B1 body": dict(pipeline_depth=0)}
    launch = gated.gated_launch(tuple(images.shape), n, dx, kernel=k,
                                stride=s, **ring_kw)
    check(launch["local_bytes"] == 0, f"B5's ring at {ring_kw} uses "
          f"{launch['local_bytes']} bytes of local memory a thread")

    def dense_b2():
        return conv.p2m_conv_fused(images, wrows, shift, **qkw, **ring_kw)

    dense_ms = [cuda_ms(torch, dense_b2, flush)]
    img_bytes = 4 * size * size * 3
    out_bytes = 4 * ho * ho * n
    rows = {}
    # The kernel alone takes its int32 mask; the engine hands the wrapper a
    # bool mask, which costs one more (conversion) launch, timed apart.
    for share, mask in (("0", [1] * b), ("0.5", [1, 0] * (b // 2)),
                        ("1", [0] * b)):
        rerun = torch.tensor(mask, dtype=torch.int32, device=dev)
        n_run = sum(mask)
        nbytes = (n_run * img_bytes + (b - n_run) * out_bytes
                  + b * out_bytes + 4 * (wrows.numel() + shift.numel() + b))
        flops = 2 * n_run * ho * ho * k * wrows.shape[1] * n
        b_ms, b_by = bound(nbytes, flops)
        turns = {name: [] for name in bodies}
        for name in ("ring", "B1 body", "B1 body", "ring"):
            turns[name].append(cuda_ms(
                torch, lambda: gated.p2m_conv_fused_gated(
                    images, wrows, shift, cached, rerun, **qkw,
                    **bodies[name]), flush))
        rows[share] = {"turns": turns, "ms": statistics.mean(turns["ring"]),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "flops": flops}
        if share == "0.5":
            half = rerun.to(torch.bool)
    dense_ms.append(cuda_ms(torch, dense_b2, flush))
    read_ms = cuda_ms(torch, images.amax, flush)
    # Whether B5's time here follows its work or one block's chain of k
    # rows: the dense B2 at the same blocks over the first 1 and 2 images
    # (a quarter and a half of the blocks, each the same chain).
    fewer = {nb: images[:nb] for nb in (1, 2)}
    fewer_ms = {nb: cuda_ms(torch, lambda: conv.p2m_conv_fused(
        x, wrows, shift, **qkw, **ring_kw), flush)
        for nb, x in fewer.items()}
    # The floor of this timing: one launch that writes 4 bytes.
    launch_ms = cuda_ms(torch, torch.zeros(1, device=dev).zero_, flush)
    rows["0.5"]["plain_ms"] = cuda_ms(torch, lambda: gated.p2m_conv_gated_plain(
        images, wrows, shift, cached, half, **qkw), flush)
    bool_ms = cuda_ms(torch, lambda: gated.p2m_conv_fused_gated(
        images, wrows, shift, cached, half, **qkw, **engine_kw), flush)
    # Yardstick: cuDNN's conv over the power stack (the raw accumulation,
    # every slot) and the select.
    library = conv2d_yardstick(torch, images, wrows, k, s)
    cached_nchw = cached.permute(0, 3, 1, 2)
    rows["0.5"]["library_ms"] = cuda_ms(torch, lambda: torch.where(
        half[:, None, None, None], library(), cached_nchw), flush)
    print(f"[9] p2m_conv_fused_gated (B5) at ({b},{size},{size},3) quant; "
          f"the engine ran {'the ring' if depth >= 2 else 'the B1 body'} "
          f"at the tuner's blocks {stream['blocks']}; ring {ring_kw}: block_h "
          f"{launch['block_h']}, {launch['ring_slots']} slots, "
          f"{launch['pixels_per_thread']} px, {launch['threads']} x "
          f"{launch['blocks_x']}x{launch['blocks_y']}, {launch['smem_bytes']}"
          f" B shared, {launch['blocks_per_sm']} an SM, "
          f"{launch['registers']} regs, {launch['local_bytes']} B local")
    for share, row in rows.items():
        extra = (f"; with a bool mask (+ its conversion) {bool_ms:.4f} ms, "
                 f"plain {row['plain_ms']:.4f} ms, library conv2d + where "
                 f"{row['library_ms']:.4f} ms" if share == "0.5" else "")
        print(f"[9] B5 skip share {share}: ring "
              + " and ".join(f"{v:.4f}" for v in row["turns"]["ring"])
              + " ms, B1 body "
              + " and ".join(f"{v:.4f}" for v in row["turns"]["B1 body"])
              + f" ms (in turns){extra}; bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({row['bytes']} bytes, {row['flops']} FLOP)")
    print(f"[9] beside B5: dense B2 at {ring_kw} {dense_ms[0]:.4f} and "
          f"{dense_ms[1]:.4f} ms (before and after), over the first 1 and 2 "
          f"images {fewer_ms[1]:.4f} and {fewer_ms[2]:.4f} ms; one read of "
          f"the images (amax) {read_ms:.4f} ms; one launch that writes 4 "
          f"bytes {launch_ms:.4f} ms")

    # The engines per tick, warm: the same six streams again, in turns
    # (gated, where, where, gated).
    per_tick = {"gated": [], "where": []}
    for path in ("gated", "where", "where", "gated"):
        e = stream[path]
        before_l, before_us = e.stats["launches"], e.stats["wall_us"]
        drive(e, stream["requests"](), on_undrained="raise")
        per_tick[path].append((e.stats["wall_us"] - before_us)
                              / (e.stats["launches"] - before_l) / 1e3)
    print(f"[9] stream engine per tick (4 slots, warm, host clock, "
          f"{stream['ticks']} ticks a run, runs in turns): gated "
          + " and ".join(f"{v:.3f}" for v in per_tick["gated"]) + " ms, where "
          + " and ".join(f"{v:.3f}" for v in per_tick["where"]) + " ms")

    # Where a tick goes, each part timed alone as `_launch` runs it.
    def assemble():
        x = np.zeros((b, size, size, 3), np.float32)
        for i in range(b):
            x[i] = frames[i][0]
        return torch.from_numpy(x).to(dev)

    parts = {"host: frames assembled in numpy, pageable copy to the card":
             wall_ms(torch, assemble, flush),
             "host: delta-gate decisions (mean |frame - reference| a slot)":
             wall_ms(torch, lambda: [frame_delta(frames[i][0], frames[i][1])
                                     for i in range(b)], flush)}
    rerun = torch.tensor([1, 0] * (b // 2), dtype=torch.bool, device=dev)
    fwd = eng.forward
    with torch.no_grad():
        stem = gated.p2m_conv_fused_gated(images, wrows, shift, cached,
                                          rerun, **qkw)
        feats, _ = apply_mnv2_backbone(eng._params, eng._bn, stem, CONFIG)
        grid = det_grid(ho)
        parts["stem, gated (B5 + the bool mask's conversion, skip share "
              "1/2)"] = bool_ms
        parts["stem, where (the tuner's B1 or B2 + torch.where)"] = cuda_ms(
            torch, lambda: torch.where(
                rerun[:, None, None, None],
                conv.p2m_conv_fused(images, wrows, shift, **qkw,
                                    **engine_kw), cached),
            flush)
        parts["backbone"] = cuda_ms(torch, lambda: apply_mnv2_backbone(
            eng._params, eng._bn, stem, CONFIG), flush)
        stem8 = torch.cat([stem, stem])
        parts["(backbone on 8 such stems, the vision engine's batch)"] = \
            cuda_ms(torch, lambda: apply_mnv2_backbone(
                eng._params, eng._bn, stem8, CONFIG), flush)
        parts["detection head + decode"] = cuda_ms(
            torch, lambda: decode_detections(apply_detect_head(
                eng._det, feats, grid), eng.det_cfg.max_dets), flush)
        parts["forward, gated (device)"] = cuda_ms(
            torch, lambda: fwd(images, cached, rerun), flush)
        parts["forward, gated, with the results to the host (host clock)"] = \
            wall_ms(torch, lambda: [t.cpu() for t in fwd(images, cached,
                                                          rerun)[1:]], flush)
    (gated.p2m_conv_fused_gated.launches,
     gated.p2m_conv_fused_gated.launches_pipelined) = counted[0].values()
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted[1].values()
    for name, ms in parts.items():
        print(f"[9] stream tick part: {name}: {ms:.3f} ms")
    row = rows["0.5"]
    return {"ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "body": "ring" if depth >= 2 else "B1 body",
            "blocks": list(stream["blocks"]),
            "ms_by_skip_share": {k: v["ms"] for k, v in rows.items()},
            "turns_by_skip_share": {k: v["turns"] for k, v in rows.items()},
            "bound_ms_by_skip_share": {k: v["bound_ms"]
                                       for k, v in rows.items()},
            "dense_b2_ms": dense_ms, "dense_b2_ms_by_images": fewer_ms,
            "read_ms": read_ms, "empty_launch_ms": launch_ms,
            "launch": launch}


LM_ARCH = "rwkv6-3b"
LM_MAX_BATCH, LM_MAX_LEN, LM_CHUNK = 8, 512, 64
LM_REQUESTS, LM_NEW_TOKENS = 16, 16
WKV_SERVE_SHAPE = (LM_MAX_BATCH, LM_CHUNK, 40, 64)  # (B, S, H, D) a tick
WKV_TOL = 1e-4  # of the largest |plain|: fp32 sums and exps in another order
# The first prefill tick's logits, absolute (the largest |logit| is 4.6 at
# this seed).  Float32 rounding, carried through 32 random-weight layers,
# moves them 0.045 between B7 and the plain twin and up to 0.20 between
# runs with no kernel; a wrong WKV moves them further (PERF.md §6).
LM_LOGIT_TOL = 0.1  # B7 vs the plain twin; a differing token's top-2 margin
LM_SPREAD_TOL = 0.3  # any two of B7, plain, per-token scan and float64
LM_SWEEP_DEPTHS = (1, 2, 4, 8, 16)


def wkv_inputs(torch, np, dev, b, s, h, d, seed):
    """r, k, v, lw, u, state for B7: lw in the model's band [-5, -1e-6],
    a random nonzero initial state."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    lw = torch.from_numpy(-rng.uniform(1e-6, 5.0, (b, s, h, d)).astype(
        np.float32)).to(dev)
    return f(b, s, h, d), f(b, s, h, d), f(b, s, h, d), lw, f(h, d) * 0.3, \
        f(b, h, d, d) * 0.5


def unaligned_copy(torch, t):
    """A contiguous copy of ``t`` at a storage offset of one float, so its
    data pointer is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_wkv_kernel(torch, np, dev):
    """Phase 3c: B7 against its plain twin at the serving tick's shape, at
    S in {1, 15, 17, 100} x D in {16, 64}, at S = 0 and S = 64, at D = 33
    (a partial warp slice), with a random initial state, and on inputs
    that are views at an offset that is not 16-byte aligned (which must
    also give the aligned inputs' bits); a row whose lw and k are all zero
    keeps its state bit for bit.  Returns the largest abs error at the
    serving shape and its inputs."""
    from repro_torch.kernels.rwkv_wkv import kernel, ref

    cases = [("serving tick", WKV_SERVE_SHAPE, False)] + [
        (f"S={s} D={d}", (2, s, 3, d), False) for s in (1, 15, 17, 100)
        for d in (16, 64)] + [
        (f"S={s} D={d}", (2, s, 3, d), False)
        for s, d in ((0, 64), (64, 64), (17, 33), (64, 33), (100, 33))] + [
        ("unaligned", (2, 37, 3, 64), True),
        ("unaligned", (2, 20, 3, 33), True)]
    for i, (name, shape, moved) in enumerate(cases):
        r, k, v, lw, u, s0 = wkv_inputs(torch, np, dev, *shape, SEED + 20 + i)
        lw[1], k[1] = 0.0, 0.0  # row 1 advances no token
        ins = (r, k, v, lw, u, s0)
        if moved:
            aligned = kernel.wkv_fused(*ins)
            ins = tuple(unaligned_copy(torch, a) for a in ins)
            check(all(a.data_ptr() % 16 for a in ins), f"{name}: the views "
                  "are 16-byte aligned")
        y, sf = kernel.wkv_fused(*ins)
        torch.cuda.synchronize()
        y_p, s_p = ref.wkv_chunked_plain(*ins)
        line = f"[3c] {name:12s} {shape}:"
        errs = {}
        for key, got, want in (("y", y, y_p), ("state", sf, s_p)):
            check(got.shape == want.shape, f"{name}: B7 {key} has shape "
                  f"{tuple(got.shape)}, not {tuple(want.shape)}")
            err = float((got - want).abs().max()) if want.numel() else 0.0
            scale = float(want.abs().max()) if want.numel() else 0.0
            errs[key] = err
            line += f" {key} err {err:.3e} (of {scale:.3e})"
            check(err <= WKV_TOL * scale, f"{name}: B7 {key} differs by "
                  f"{err}, more than {WKV_TOL} of {scale}")
        check(torch.equal(sf[1], s0[1]), f"{name}: the masked row's state "
              "changed")
        line += "; masked row's state bitwise kept"
        if moved:
            check(torch.equal(y, aligned[0]) and torch.equal(sf, aligned[1]),
                  f"{name}: the unaligned views' result differs from the "
                  "aligned inputs'")
            line += "; bitwise equal to the aligned inputs'"
        print(line)
        if i == 0:
            serve_err = max(errs.values())
            serve_inputs = (r, k, v, lw, u, s0)
    return serve_err, serve_inputs


def lm_instrument(torch, eng, first=None):
    """Record each step's kind and B7 launches, and the top-2 margin
    of the logits behind each emitted token; keep the first chunk
    step's inputs and logits in ``first``."""
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.tree import tree_map

    ticks, margins, now = [], {}, {}
    steps = {"prefill": eng._chunk_step, "decode": eng._step}

    def wrap(kind):
        def step(params_, state, *args):
            if kind == "prefill" and first is not None and not first:
                first["inputs"] = (tree_map(torch.clone, state),
                                   *(a.clone() for a in args))
            before = kernel.wkv_fused.launches
            last, new_state = steps[kind](params_, state, *args)
            ticks.append((kind, kernel.wkv_fused.launches - before))
            top = torch.topk(last, 2, dim=-1).values
            now["margin"] = (top[:, 0] - top[:, 1]).cpu().numpy()
            if kind == "prefill" and first is not None \
                    and "last" not in first:
                first["last"] = last.clone()
            return last, new_state
        return step

    eng._chunk_step, eng._step = wrap("prefill"), wrap("decode")
    absorb = eng._absorb

    def absorb_and_record(i, req, result):
        n = len(eng._gen(req))
        finished = absorb(i, req, result)
        if len(eng._gen(req)) > n:
            margins.setdefault(req.uid, []).append(float(now["margin"][i]))
        return finished

    eng._absorb = absorb_and_record
    return ticks, margins


def lm_traffic(np, vocab, n=LM_REQUESTS):
    """Phase 5c's LM traffic: the first ``n`` of 16 SyntheticLMDataset
    prompts of 24-150 tokens at arrivals 0 x6, 1 x2, 3 x4, 7 x4, 16 new
    tokens each.  Returns (prompt lengths, a function that makes fresh
    requests)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 12)
    lengths = rng.integers(24, 151, LM_REQUESTS)[:n]
    data = SyntheticLMDataset(vocab=vocab, seq_len=150, batch=LM_REQUESTS,
                              seed=SEED).batch_at(0)
    prompts = [data["tokens"][i, :k].tolist() for i, k in enumerate(lengths)]
    arrivals = ([0] * 6 + [1] * 2 + [3] * 4 + [7] * 4)[:n]

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS,
                        arrival_tick=t)
                for i, (p, t) in enumerate(zip(prompts, arrivals))]

    return lengths, requests


def lm_path(torch, np, dev, cfg):
    """Phase 5c: serve ``cfg`` (rwkv6-3b, float32, random weights from
    ``SEED``) through `ServeEngine` with chunked prefill and through
    `SessionEngine`.  Returns what phase 9 reads."""
    from repro_torch.common.pytree import param_count
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.models import rwkv6
    from repro_torch.models.families import get_family
    from repro_torch.serving import (
        ServeEngine,
        SessionEngine,
        SessionRequest,
        drive,
    )
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"[5c] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_rwkv_heads} heads of {cfg.rwkv_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
          f"({4 * n_params / 1e9:.2f} GB fp32), initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    lengths, requests = lm_traffic(np, cfg.vocab)

    def serve(run_cfg, first=None):
        eng = ServeEngine(params, run_cfg, max_batch=LM_MAX_BATCH,
                          max_len=LM_MAX_LEN, prefill_chunk=LM_CHUNK,
                          device=dev)
        ticks, margins = lm_instrument(torch, eng, first)
        torch.cuda.synchronize()
        kernel.wkv_fused.launches = 0
        t0 = time.perf_counter()
        drive(eng, requests(), on_undrained="raise")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel.wkv_fused.launches
        done = sorted(eng.completed, key=lambda r: r.uid)
        check([r.uid for r in done] == list(range(LM_REQUESTS))
              and not eng.failed and not eng.evicted,
              f"{run_cfg.wkv_impl}: completed {[r.uid for r in done]}, "
              f"failed {len(eng.failed)}, evicted {len(eng.evicted)}")
        check(all(len(r.output) == LM_NEW_TOKENS
                  and all(0 <= t < cfg.vocab for t in r.output)
                  for r in done), f"{run_cfg.wkv_impl}: outputs misshapen")
        kinds = [k for k, _ in ticks]
        print(f"[5c] ServeEngine ({run_cfg.wkv_impl}): {len(done)} requests "
              f"(prompts {min(lengths)}-{max(lengths)} tokens), "
              f"{sum(len(r.output) for r in done)} tokens in "
              f"{eng.stats['launches']} ticks ({kinds.count('prefill')} "
              f"prefill, {kinds.count('decode')} decode), {seconds:.2f} s; "
              f"B7 launches {launches}")
        return eng, done, ticks, margins, launches

    first = {}
    eng, done, ticks, margins, launches = serve(cfg, first)
    first_last = first["last"].cpu().numpy()
    for j, (kind, n) in enumerate(ticks):
        want = cfg.n_layers if kind == "prefill" else 0
        check(n == want, f"step {j} ({kind}) launched B7 {n} times, not "
              f"{want}")
    check(launches == cfg.n_layers * sum(k == "prefill" for k, _ in ticks)
          and launches > 0, f"B7 launches {launches}")
    # The first prefill tick again, each layer's B7 call held against the
    # plain twin on the same inputs (these launches are not the path's).
    from repro_torch.kernels.rwkv_wkv import ops, ref

    plain_cfg = cfg.replace(wkv_impl="plain")
    state, tokens, _, n_active = first["inputs"]
    layer_errs = []

    def layer_err(y, s_new, r, k, v, lw, u, st, chunk):
        """Largest error of a WKV call's (y, state) against the plain
        twin's on the same inputs, of the largest |plain|."""
        y_p, s_p = ref.wkv_chunked_plain(r, k, v, lw, u, st, chunk)
        return max(float((y - y_p).abs().max()) / float(y_p.abs().max()),
                   float((s_new - s_p).abs().max()) / float(s_p.abs().max()))

    def checked(r, k, v, lw, u, st, *, chunk):
        y, s_new = real(r, k, v, lw, u, st, chunk=chunk)
        layer_errs.append(layer_err(y, s_new, r, k, v, lw, u, st, chunk))
        return y, s_new

    real, counted = ops.wkv_fused, kernel.wkv_fused.launches
    ops.wkv_fused = checked
    try:
        with torch.no_grad():
            replay, _ = rwkv6.prefill_step(params, state, tokens, n_active,
                                           cfg)
    finally:
        ops.wkv_fused = real
    kernel.wkv_fused.launches = counted
    print(f"[5c] first prefill tick replayed: B7 vs plain twin on each "
          f"layer's own inputs, largest error (of the largest |plain|) "
          f"{max(layer_errs):.3e} over {len(layer_errs)} layers; logits "
          f"equal to the run's bit for bit: {torch.equal(replay, first['last'])}")
    check(len(layer_errs) == cfg.n_layers
          and max(layer_errs) <= WKV_TOL, f"B7 on the model's inputs: "
          f"{layer_errs}")
    check(torch.equal(replay, first["last"]), "the replayed tick's logits "
          "differ from the run's")
    # The same tick on each half of the slots alone: the rows a rank of
    # phase 5m (e) holds, whose first tick must give these bits.
    counted, halves = kernel.wkv_fused.launches, []
    with torch.no_grad():
        for rows in torch.arange(LM_MAX_BATCH).chunk(2):
            halves.append(rwkv6.prefill_step(
                params, tree_map(lambda a, r=rows: a[:, r].clone(), state),
                tokens[rows], n_active[rows], cfg)[0])
    kernel.wkv_fused.launches = counted
    first_halves = torch.cat(halves).cpu().numpy()
    print(f"[5c] first prefill tick on 4 slots at a time (a 5m (e) rank's "
          f"rows): logits {np.abs(first_halves[:4] - first_last[:4]).max():.3e}"
          f" (slots 0-3) and {np.abs(first_halves[4:] - first_last[4:]).max():.3e}"
          f" (slots 4-7) from the 8-slot tick's")
    # The tick's logits from the first ``depth`` layers: B7, the plain
    # twin, the per-token scan, and the plain twin with every weight and
    # activation outside the WKV (which the model runs in float32) in
    # float64.  Shallower depths show how the spread grows; two wrong
    # WKVs show what the limit must catch.
    rows = n_active > 0
    p64 = tree_map(lambda a: a.double(), params)
    s64 = {k: a if k == "wkv" else a.double() for k, a in state.items()}
    f64_cfg = plain_cfg.replace(dtype=torch.float64)

    def tick(p, s, depth, run_cfg):
        p = {"embed": p["embed"],
             "layers": tree_map(lambda a: a[:depth], p["layers"])}
        s = tree_map(lambda a: a[:depth], s)
        with torch.no_grad():
            return rwkv6.prefill_step(p, s, tokens, n_active, run_cfg.replace(
                n_layers=depth))[0][rows].double()

    def gap(a, b):
        return float((a - b).abs().max())

    counted = kernel.wkv_fused.launches
    for depth in (d for d in LM_SWEEP_DEPTHS if d < cfg.n_layers):
        plain = tick(params, state, depth, plain_cfg)
        print(f"[5c] first prefill tick, first {depth:2d} layers: logits "
              f"cuda-plain {gap(tick(params, state, depth, cfg), plain):.3e}"
              f", plain-f64 {gap(plain, tick(p64, s64, depth, f64_cfg)):.3e}")
    kernel.wkv_fused.launches = counted
    last = {"cuda": first["last"][rows].double(),
            "plain": tick(params, state, cfg.n_layers, plain_cfg),
            "naive": tick(params, state, cfg.n_layers,
                          cfg.replace(wkv_impl="naive")),
            "f64": tick(p64, s64, cfg.n_layers, f64_cfg)}
    del p64, s64
    torch.cuda.empty_cache()
    dist = {f"{a}-{b}": gap(last[a], last[b])
            for a, b in (("cuda", "plain"), ("cuda", "naive"),
                         ("plain", "naive"), ("cuda", "f64"), ("plain", "f64"),
                         ("naive", "f64"))}
    print(f"[5c] first prefill tick ({int(rows.sum())} slots, "
          f"{int(n_active.sum())} tokens), all {cfg.n_layers} layers: logits "
          f"max abs differences (of {float(last['f64'].abs().max()):.3e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in dist.items()))
    check(dist["cuda-plain"] <= LM_LOGIT_TOL, f"first prefill tick: B7's "
          f"logits {dist['cuda-plain']} from the plain twin's, more than "
          f"{LM_LOGIT_TOL}")
    check(max(dist.values()) <= LM_SPREAD_TOL, f"first prefill tick: the "
          f"logits' float32 spread {dist} exceeds {LM_SPREAD_TOL}")
    plain_wkv = ops.wkv_chunked_plain

    def no_bonus(r, k, v, lw, u, st, chunk):
        return plain_wkv(r, k, v, lw, torch.zeros_like(u), st, chunk)

    def no_carry(r, k, v, lw, u, st, chunk):
        ys = []
        for i in range(0, r.shape[1], chunk):
            y, s_new = plain_wkv(*(a[:, i:i + chunk] for a in (r, k, v, lw)),
                                 u, st, chunk)
            ys.append(y)
        return torch.cat(ys, 1), s_new

    # Each wrong WKV must fail the per-layer check or the logits limit.
    for name, wrong in (("bonus u dropped", no_bonus),
                        ("state not carried across chunks", no_carry)):
        errs = []

        def traced(r, k, v, lw, u, st, chunk, wrong=wrong, errs=errs):
            y, s_new = wrong(r, k, v, lw, u, st, chunk)
            errs.append(layer_err(y, s_new, r, k, v, lw, u, st, chunk))
            return y, s_new

        ops.wkv_chunked_plain = traced
        try:
            moved = gap(tick(params, state, cfg.n_layers, plain_cfg),
                        last["plain"])
        finally:
            ops.wkv_chunked_plain = plain_wkv
        print(f"[5c] wrong WKV, {name}: per layer {max(errs):.3e} of the "
              f"largest |plain| (limit {WKV_TOL}), logits {moved:.3e} "
              f"(limit {LM_LOGIT_TOL})")
        check(max(errs) > WKV_TOL or moved > LM_LOGIT_TOL, f"the wrong WKV "
              f"({name}) passes both the per-layer check and the logits "
              "limit")
    del state, first
    # Tokens of a plain-twin run: identical, or the first difference at a
    # near-tie.
    p_eng, p_done, _, p_margins, p_launches = serve(plain_cfg)
    check(p_launches == 0, f"the plain run launched B7 {p_launches} times")
    same = 0
    for a, b in zip(done, p_done):
        if a.output == b.output:
            same += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.output, b.output))
                 if x != y)
        m = min(margins[a.uid][j], p_margins[b.uid][j])
        print(f"[5c] request {a.uid}: tokens differ first at output {j} "
              f"({a.output[j]} vs {b.output[j]}), top-2 margin {m:.3e} "
              f"(limit {LM_LOGIT_TOL})")
        check(m <= LM_LOGIT_TOL, f"request {a.uid}: tokens differ at output "
              f"{j}, not a near-tie (margin {m})")
    print(f"[5c] tokens: {same} of {len(done)} requests identical to the "
          f"plain-twin run; the smallest top-2 margin behind any emitted "
          f"token {min(min(v) for v in margins.values()):.3e}")
    del p_eng, p_done

    # Sessions: 4 conversations of 3 turns on 4 slots.
    srng = np.random.default_rng(SEED + 13)
    sdata = SyntheticLMDataset(vocab=cfg.vocab, seq_len=90, batch=12,
                               seed=SEED + 1).batch_at(0)["tokens"]
    turns = [[sdata[3 * i + t, :int(srng.integers(20, 91))].tolist()
              for t in range(3)] for i in range(4)]
    sess = SessionEngine(params, cfg, max_batch=4, max_len=LM_MAX_LEN,
                         prefill_chunk=LM_CHUNK, device=dev)
    s_ticks, s_margins = lm_instrument(torch, sess)
    torch.cuda.synchronize()
    kernel.wkv_fused.launches = 0
    t0 = time.perf_counter()
    sreqs = [SessionRequest(uid=i, turns=t, max_new_tokens=8)
             for i, t in enumerate(turns)]
    drive(sess, sreqs, on_undrained="raise")
    torch.cuda.synchronize()
    s_launches = kernel.wkv_fused.launches
    check(sorted(r.uid for r in sess.completed) == [0, 1, 2, 3]
          and all(r.done and len(r.outputs) == 3
                  and all(len(o) == 8 for o in r.outputs) for r in sreqs),
          "sessions did not all complete their 3 turns")
    n_prefill = sum(k == "prefill" for k, _ in s_ticks)
    check(all(n == (cfg.n_layers if k == "prefill" else 0)
              for k, n in s_ticks) and s_launches == cfg.n_layers * n_prefill
          and n_prefill >= 3, f"session B7 launches {s_launches} over "
          f"{n_prefill} prefill ticks")
    print(f"[5c] SessionEngine: 4 sessions x 3 turns (turn prompts "
          f"{min(len(t) for ts in turns for t in ts)}-"
          f"{max(len(t) for ts in turns for t in ts)} tokens) in "
          f"{sess.stats['launches']} ticks ({n_prefill} prefill), "
          f"{time.perf_counter() - t0:.2f} s; B7 launches {s_launches}")
    return {"params": params, "cfg": cfg, "requests": requests,
            "launches": launches + s_launches, "serve_launches": launches,
            "session_launches": s_launches,
            "outputs": {r.uid: r.output for r in done}, "margins": margins,
            "n_params": n_params, "first_last": first_last,
            "first_halves": first_halves,
            "session_turns": turns,
            "session_outputs": {r.uid: r.outputs for r in sreqs},
            "session_margins": s_margins}


LM_TRAIN_STEPS = 3  # full width and depth, through launch/train.py
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128  # the launcher's defaults
WKV_TRAIN_SHAPE = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, 40, 64)  # (B, S, H, D)
WKV_GRAD_TOL = 1e-4  # of the largest |float64 value|, as B3 and B4
# Depth 2 at full width: each gradient leaf of the B7 path within this
# share of the leaf's largest |value| of the plain-WKV path's, both
# float32, and of the path whose WKV runs in float64 (every leaf sat
# near 2e-4 from the plain path's at this seed, PERF.md §6).
LM_GRAD_TOL = 1e-3
LM_LOSS_RTOL = 1e-5  # depth 2: the three losses, of the float64 one
LM_RESUME_STEPS = (4, 2)  # SMOKE: 4 steps, a restore, 2 more
TRAIN_REPS = 5  # CUDA-event runs a part of the full-width step


def check_wkv_grads(torch, np, dev):
    """Phase 5g (a): `ops.wkv` (B7 forward, the closed-form backward) at
    the serving tick's shape and at the train step's, from a nonzero
    state with both cotangents, its outputs and six gradients against
    autograd of the plain twin in float64 on the card.  Returns the
    largest error (of the largest |value|)."""
    from repro_torch.kernels.rwkv_wkv import kernel, ops, ref

    worst = 0.0
    for i, (what, shape) in enumerate((("serving tick", WKV_SERVE_SHAPE),
                                       ("train step", WKV_TRAIN_SHAPE))):
        ins = wkv_inputs(torch, np, dev, *shape, SEED + 40 + 2 * i)
        gen = torch.Generator(dev).manual_seed(SEED + 41 + 2 * i)
        dy = torch.randn(ins[0].shape, generator=gen, device=dev)
        ds = torch.randn(ins[5].shape, generator=gen, device=dev)
        counted = kernel.wkv_fused.launches
        live = [a.clone().requires_grad_() for a in ins]
        y, sf = ops.wkv(*live)
        grads = torch.autograd.grad((y, sf), live, (dy, ds))
        torch.cuda.synchronize()
        check(kernel.wkv_fused.launches == counted + 1, "the WKV Function "
              "did not launch B7 once")
        kernel.wkv_fused.launches = counted
        live64 = [a.double().requires_grad_() for a in ins]
        y64, s64 = ref.wkv_chunked_plain(*live64)
        want = torch.autograd.grad((y64, s64), live64, (dy.double(),
                                                        ds.double()))
        line = ""
        for name, got, w in zip(("y", "state", "dr", "dk", "dv", "dlw", "du",
                                 "dstate0"), (y, sf, *grads),
                                (y64, s64, *want)):
            got, w = got.detach(), w.detach()
            err = float((got.double() - w).abs().max())
            scale = float(w.abs().max())
            worst = max(worst, err / scale)
            line += f" {name} {err / scale:.2e} (of {scale:.2e})"
            check(err <= WKV_GRAD_TOL * scale, f"WKV Function at {shape}: "
                  f"{name} differs by {err}, more than {WKV_GRAD_TOL} of "
                  f"{scale}")
        print(f"[5g] (a) WKV Function at the {what}'s {shape} vs float64 "
              f"autograd of the plain twin, nonzero state, both cotangents; "
              f"error of the largest |value| (limit {WKV_GRAD_TOL}):{line}")
    return worst


def lm_batch(torch, dev, vocab, seed=0):
    """The launcher's batch: `SyntheticLMDataset` at 8 x 128, on ``dev``."""
    from repro_torch.data import SyntheticLMDataset

    data = SyntheticLMDataset(vocab=vocab, seq_len=LM_TRAIN_SEQ,
                              batch=LM_TRAIN_BATCH, seed=seed).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def lm_value_and_grad(torch, params, batch, cfg):
    """(loss, gradient leaves in `tree_leaves` order) of the LM loss."""
    from repro_torch.models.families import get_family
    from repro_torch.tree import tree_leaves, tree_unflatten

    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = get_family(cfg).loss(tree_unflatten(params, live), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, live)


def wkv_float64(r, k, v, lw, u, state, chunk=None, impl=None):
    """The plain WKV twin in float64, its outputs rounded to float32: the
    depth-2 witness's WKV (autograd runs through it in float64)."""
    from repro_torch.kernels.rwkv_wkv import ref

    y, sf = ref.wkv_chunked_plain(*(a.double() for a in (r, k, v, lw, u,
                                                         state)))
    return y.float(), sf.float()


def check_lm_grads_depth2(torch, np, dev, cfg):
    """Phase 5g (b): the first two layers at full width, batch 8 x 128:
    the gradient tree through B7 against the one through the plain WKV,
    both float32, and against a third whose WKV runs in float64 (the rest
    of the model as in the other two), each leaf within ``LM_GRAD_TOL`` of
    its largest |value|; the three losses within ``LM_LOSS_RTOL``.  Prints
    how far each float32 WKV path sits from the float64 one.  Returns the
    largest share of B7 against the plain WKV."""
    from repro_torch.common.pytree import (
        assert_trees_all_finite,
        flatten_with_names,
    )
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.models import rwkv6
    from repro_torch.models.families import get_family
    from repro_torch.tree import tree_unflatten

    c2 = cfg.replace(n_layers=2)
    params, _ = get_family(c2).init(torch.Generator(dev).manual_seed(SEED),
                                    c2)
    batch = lm_batch(torch, dev, cfg.vocab, SEED + 1)
    counted = kernel.wkv_fused.launches
    runs = {impl: lm_value_and_grad(torch, params, batch,
                                    c2.replace(wkv_impl=impl))
            for impl in ("cuda", "plain")}
    torch.cuda.synchronize()
    check(kernel.wkv_fused.launches - counted == 2 * c2.n_layers,
          f"depth 2: B7 launched {kernel.wkv_fused.launches - counted} "
          "times, not twice a layer")
    kernel.wkv_fused.launches = counted
    real = rwkv6.wkv_chunked
    rwkv6.wkv_chunked = wkv_float64
    try:
        runs["float64"] = lm_value_and_grad(torch, params, batch,
                                            c2.replace(wkv_impl="plain"))
    finally:
        rwkv6.wkv_chunked = real
    check(kernel.wkv_fused.launches == counted, "the float64 witness "
          "launched B7")
    named = {impl: dict(flatten_with_names(tree_unflatten(params, list(g))))
             for impl, (_, g) in runs.items()}
    assert_trees_all_finite(named["cuda"], "depth-2 gradient (B7)")

    def shares(got, want):
        out = {}
        for name, w in named[want].items():
            scale = float(w.abs().max())
            err = float((named[got][name] - w).abs().max())
            out[name] = err / scale if scale else err
        return sorted(out.items(), key=lambda kv: -kv[1])

    pairs = {("cuda", "plain"): "B7 vs plain", ("cuda", "float64"):
             "B7 vs float64", ("plain", "float64"): "plain vs float64"}
    worst = {}
    loss = {impl: float(run[0]) for impl, run in runs.items()}
    print(f"[5g] (b) {c2.name} at depth 2, full width, batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: loss B7 {loss['cuda']:.9f}, "
          f"plain {loss['plain']:.9f}, float64 WKV {loss['float64']:.9f}")
    for pair, what in pairs.items():
        ranked = shares(*pair)
        worst[pair] = ranked[0]
        print(f"[5g] (b) gradient leaves, {what}: largest error of the "
              f"leaf's largest |value| (limit {LM_GRAD_TOL}): "
              + ", ".join(f"{n} {v:.2e}" for n, v in ranked[:5])
              + f"; the median leaf "
              f"{statistics.median(v for _, v in ranked):.2e}")
    for a, b in (("cuda", "plain"), ("cuda", "float64"),
                 ("plain", "float64")):
        check(abs(loss[a] - loss[b]) <= LM_LOSS_RTOL * abs(loss["float64"]),
              f"depth 2: loss {a} {loss[a]} and {b} {loss[b]} differ by more "
              f"than {LM_LOSS_RTOL}")
    for pair in (("cuda", "plain"), ("cuda", "float64")):
        name, share = worst[pair]
        check(share <= LM_GRAD_TOL, f"depth 2, {pairs[pair]}: gradient leaf "
              f"{name} differs by {share} of its largest value")
    return worst[("cuda", "plain")][1], worst[("cuda", "float64")][1], \
        worst[("plain", "float64")][1]


def time_lm_train(torch, np, dev, trainer, cfg, flush):
    """Phase 5g: the parts of the full-width train step on its own state,
    each timed alone by CUDA events (median of ``TRAIN_REPS``): the
    forward (loss with remat), forward + backward, one layer's recompute,
    B7 forward and the closed-form WKV backward at a layer's shape, the
    head and CE forward + backward, and the in-place AdamW update (which
    writes the state).  Returns the parts in ms a step."""
    from repro_torch.common.pytree import param_count
    from repro_torch.kernels.rwkv_wkv import kernel, ops
    from repro_torch.models import rwkv6
    from repro_torch.models.families import cross_entropy, get_family
    from repro_torch.models.layers import lm_head
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    counted = kernel.wkv_fused.launches
    state = trainer.state
    params = state["params"]
    batch = lm_batch(torch, dev, cfg.vocab, SEED + 2)
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, live)
    family = get_family(cfg)

    def forward():
        return family.loss(tree, batch, cfg)[0]

    def forward_backward():
        return torch.autograd.grad(forward(), live)

    parts = {"forward (remat: layer inputs kept)":
             cuda_ms(torch, forward, flush, TRAIN_REPS)}
    parts["forward + backward"] = cuda_ms(torch, forward_backward, flush,
                                          TRAIN_REPS)
    b, s, d = LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.d_model
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    x = torch.randn((b, s, d), generator=gen, device=dev)
    lp = tree_map(lambda a: a[0], tree["layers"])
    st = tree_map(lambda a: a[0], rwkv6.init_rwkv_state(cfg, b,
                                                        device=dev)[0])
    layer_ms = cuda_ms(torch, lambda: rwkv6._layer(x, lp, st, cfg), flush)
    wkv_in = [torch.randn((b, s, h, hd), generator=gen, device=dev)
              for _ in range(3)]
    lw = -torch.rand((b, s, h, hd), generator=gen, device=dev) * 5
    u = params["layers"]["att"]["u"][0].float()
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    dy = torch.randn((b, s, h, hd), generator=gen, device=dev)
    with torch.no_grad():
        b7_ms = cuda_ms(torch, lambda: kernel.wkv_fused(*wkv_in, lw, u, s0),
                        flush)
    bwd_ms = cuda_ms(torch, lambda: ops.wkv_backward(*wkv_in, lw, u, s0, dy,
                                                     None), flush)
    head = [tree["embed"]["final_norm"]["scale"], tree["embed"]["head"]]
    xh = x.clone().requires_grad_()

    def head_ce():
        logits = lm_head(tree["embed"], xh, cfg)
        return torch.autograd.grad(cross_entropy(logits, batch["targets"]),
                                   [xh, *head])

    head_ms = cuda_ms(torch, head_ce, flush)
    grads = tree_unflatten(params, list(forward_backward()))
    opt = adamw(cosine_warmup(3e-3, warmup=20, total=LM_TRAIN_STEPS))
    opt_ms = cuda_ms(torch, lambda: opt.update_in_place(
        grads, state["opt"], params, state["step"]), flush, TRAIN_REPS)
    del grads
    kernel.wkv_fused.launches = counted
    n_params = param_count(params)
    # read p, g, m, v and write p, m, v once each, float32
    opt_bound_ms, _ = bound(7 * 4 * n_params, 0)
    n = cfg.n_layers
    parts.update({
        f"  of which recompute, one layer's forward x {n}": n * layer_ms,
        f"  of which B7 forward x {2 * n} (forward and recompute)":
            2 * n * b7_ms,
        f"  of which WKV backward (closed form, plain) x {n}": n * bwd_ms,
        "  of which head + CE forward and backward": head_ms,
        "optimizer (AdamW in place, clip included)": opt_ms,
        "  its bound (p, g, m, v read and p, m, v written once)":
            opt_bound_ms})
    for name, t in parts.items():
        print(f"[5g] train step part: {name}: {t:.3f} ms")
    print(f"[5g] train step parts: forward + backward + optimizer "
          f"{parts['forward + backward'] + opt_ms:.3f} ms; one layer's "
          f"forward {layer_ms:.3f} ms, B7 {b7_ms:.4f} ms, WKV backward "
          f"{bwd_ms:.3f} ms at ({b}, {s}, {h}, {hd})")
    return parts


def lm_train_path(torch, np, dev, lm, flush=None):
    """Phase 5g: LM training.  (a) the WKV Function against float64
    autograd; (b) depth 2 at full width, B7 against the plain WKV's
    gradients; (c) `launch/train.py`'s ``main`` at full width and depth for
    ``LM_TRAIN_STEPS`` steps (every loss and gradient finite, B7 twice a
    layer a step, the step's time and peak memory), then its parts; (d)
    at SMOKE, 4 steps with checkpoints, a fresh run that restores and
    takes 2 more, bit for bit the losses of 6 steps in one run.  The
    served parameters are freed for (c) and drawn again from the seed
    after it.  Returns what the kernels line reads."""
    import tempfile

    from repro_torch.common.pytree import (
        assert_trees_all_finite,
        param_count,
    )
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.rwkv_wkv import kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.models.families import get_family

    cfg = lm["cfg"]
    wkv_grad_err = check_wkv_grads(torch, np, dev)
    depth2_err, depth2_err64, plain_err64 = check_lm_grads_depth2(
        torch, np, dev, cfg)

    # (c) the served parameters give way to the train state
    lm["params"] = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    real, per_step = launch_train.make_train_step, []

    def counting_step(*args, **kw):
        step = real(*args, **kw)

        def counted(state, batch):
            before = kernel.wkv_fused.launches
            out = step(state, batch)
            per_step.append(kernel.wkv_fused.launches - before)
            return out

        return counted

    launch_train.make_train_step = counting_step
    kernel.wkv_fused.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = launch_train.main(["--arch", LM_ARCH, "--steps",
                                     str(LM_TRAIN_STEPS)])
    finally:
        launch_train.make_train_step = real
    torch.cuda.synchronize()
    launches = kernel.wkv_fused.launches
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    hist = trainer.history
    state = trainer.state
    n_params = param_count(state["params"])
    losses = [h["loss"] for h in hist]
    step_s = [h["step_time_s"] for h in hist]
    print(f"[5g] (c) launch/train.py --arch {LM_ARCH} --steps "
          f"{LM_TRAIN_STEPS}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters fp32, batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ}, AdamW in place; {run_s:.2f} s with the init")
    print(f"[5g] (c) losses {losses}; step times (host clock, through a "
          f"synchronize) " + ", ".join(f"{t * 1e3:.1f}" for t in step_s)
          + f" ms; B7 launches a step {per_step}")
    check(len(hist) == LM_TRAIN_STEPS and state["step"] == LM_TRAIN_STEPS,
          f"{len(hist)} steps ran, state step {state['step']}")
    check(all(np.isfinite(v) for v in losses), f"a loss is not finite: "
          f"{losses}")
    # AdamW's moments are finite only if every step's gradient was
    for name, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"])):
        assert_trees_all_finite(tree, f"the train state's {name}")
    check(per_step == [2 * cfg.n_layers] * LM_TRAIN_STEPS
          and launches == 2 * cfg.n_layers * LM_TRAIN_STEPS,
          f"B7 launched {per_step} a step ({launches} in all), not "
          f"{2 * cfg.n_layers} a step")
    check(peak_gb < total_gb, f"peak {peak_gb} GB of {total_gb} GB")
    steady = statistics.median(step_s[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"[5g] (c) train step {steady * 1e3:.1f} ms (median of steps "
          f"2-{LM_TRAIN_STEPS}), {tokens / steady:.1f} tokens/s; peak "
          f"memory allocated {peak_gb:.2f} GB (max_memory_allocated, "
          f"{base_gb:.2f} GB of other phases resident before) of "
          f"{total_gb:.2f} GB; card {smi_line()}")
    if flush is None:
        flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                            device=dev)
    parts = time_lm_train(torch, np, dev, trainer, cfg, flush)
    del trainer, state, flush
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (d) resume at SMOKE, bit for bit
    smoke = ["--arch", LM_ARCH, "--smoke"]
    whole = launch_train.main(smoke + ["--steps", str(sum(LM_RESUME_STEPS))])
    with tempfile.TemporaryDirectory(prefix=".ckpt-", dir=ROOT) as ckdir:
        ck = ["--ckpt-dir", ckdir, "--ckpt-every", "2"]
        first = launch_train.main(smoke + ck + ["--steps",
                                                str(LM_RESUME_STEPS[0])])
        second = launch_train.main(smoke + ck + ["--steps",
                                                 str(LM_RESUME_STEPS[1])])
    got = [h["loss"] for h in first.history + second.history]
    want = [h["loss"] for h in whole.history]
    scfg = get_smoke_config(LM_ARCH)
    print(f"[5g] (d) {scfg.name} on the card: {LM_RESUME_STEPS[0]} steps, "
          f"restored at step {first.state['step']} by a fresh trainer, "
          f"{LM_RESUME_STEPS[1]} more: losses {got}; one run of "
          f"{sum(LM_RESUME_STEPS)}: {want}; bit for bit: {got == want}")
    check(second.state["step"] == sum(LM_RESUME_STEPS) and got == want,
          "the resumed run's losses differ from one uninterrupted run's")
    del whole, first, second

    lm["params"], _ = get_family(cfg).init(
        torch.Generator(dev).manual_seed(SEED), cfg)
    return {"launches": launches, "wkv_grad_err": wkv_grad_err,
            "depth2_err": depth2_err, "depth2_err_vs_float64": depth2_err64,
            "plain_err_vs_float64": plain_err64, "step_ms": steady * 1e3,
            "peak_gb": peak_gb, "parts": parts}


def time_lm(torch, np, dev, lm, wkv_in, flush):
    """Phase 9, LM part: B7 alone at the serving tick's shape beside its
    bound and its plain twin; the engine's time per prefill and per
    decode tick, warm; and the parts of each, timed alone.  Returns B7's
    row of the kernels line, without launches and error."""
    from repro_torch.common.pytree import param_count
    from repro_torch.kernels.rwkv_wkv import kernel, ref
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import apply_norm, embed_tokens, lm_head
    from repro_torch.serving import drive
    from repro_torch.tree import tree_map

    counted = kernel.wkv_fused.launches
    r, k, v, lw, u, s0 = wkv_in
    b, s, h, d = r.shape
    ms = cuda_ms(torch, lambda: kernel.wkv_fused(r, k, v, lw, u, s0), flush)
    plain_ms = cuda_ms(torch, lambda: ref.wkv_chunked_plain(
        r, k, v, lw, u, s0), flush)
    nbytes = 4 * (5 * r.numel() + u.numel() + 2 * s0.numel())
    n_chunks = -(-s // 16)
    # per chunk and head: inter q@S0 and the state's kd^T v (2 C D^2 each),
    # the strictly causal scores and their product with v (C(C-1) D each),
    # the decay's scale of S (D^2), the bonus diagonal (3 C D)
    flops = b * h * n_chunks * (4 * 16 * d * d + 2 * 16 * 15 * d + d * d
                                + 3 * 16 * d)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[9] wkv_fused at {tuple(r.shape)}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no library call computes it; bound "
          f"{b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} FLOP)")
    geo = kernel.launch_geometry(b, h, d)
    print(f"[9] wkv_fused launch geometry at {tuple(r.shape)}: "
          f"{geo['blocks']} blocks x {geo['threads']} threads, "
          f"{geo['smem_bytes']} bytes of shared memory a block, a ring of "
          f"{geo['stages']} chunk tiles")

    # The engine per tick, warm: the same requests again, each step timed
    # on the host clock (a step ends in the copy of its tokens to the
    # host).
    from repro_torch.serving import ServeEngine

    cfg, params = lm["cfg"], lm["params"]
    eng = ServeEngine(params, cfg, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                      prefill_chunk=LM_CHUNK, device=dev)
    launch = eng._launch
    per = {"prefill": [], "decode": []}

    def timed(active):
        t0 = time.perf_counter()
        nxt, adv = launch(active)
        per["prefill" if int(adv.max()) > 1 else "decode"].append(
            (time.perf_counter() - t0) * 1e3)
        return nxt, adv

    eng._launch = timed
    drive(eng, lm["requests"](), on_undrained="raise")
    tick = {kind: statistics.median(v) for kind, v in per.items()}
    weight_bytes = 4 * param_count(params)
    print(f"[9] LM engine, warm (host clock): prefill tick "
          f"{tick['prefill']:.3f} ms (median of {len(per['prefill'])}, "
          f"{LM_MAX_BATCH} slots x {LM_CHUNK} tokens), decode tick "
          f"{tick['decode']:.3f} ms (median of {len(per['decode'])}, "
          f"{LM_MAX_BATCH} slots); reading the weights once takes "
          f"{weight_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at the HBM rate")

    # Where a tick goes: one layer's parts at each tick's shape, timed
    # alone (CUDA events), times the layers; the head once.
    lp = tree_map(lambda a: a[0], params["layers"])
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    with torch.no_grad():
        for kind, seq in (("prefill", LM_CHUNK), ("decode", 1)):
            x = torch.randn((LM_MAX_BATCH, seq, cfg.d_model), generator=gen,
                            device=dev)
            prev = torch.randn((LM_MAX_BATCH, cfg.d_model), generator=gen,
                               device=dev)
            st = torch.randn((LM_MAX_BATCH, cfg.n_rwkv_heads,
                              cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                             generator=gen, device=dev) * 0.1
            lengths = torch.full((LM_MAX_BATCH,), seq, device=dev)
            chunked = kind == "prefill"
            kw = dict(chunked=chunked, lengths=lengths if chunked else None)
            parts = {
                "norms (2 a layer)": cuda_ms(torch, lambda: (
                    apply_norm(lp["att_norm"], x, cfg),
                    apply_norm(lp["ffn_norm"], x, cfg)), flush),
                "time mix (ddlerp, r/k/v/g/decay projections, WKV, "
                "GroupNorm, output)": cuda_ms(torch, lambda: rwkv6._time_mix(
                    lp["att"], x, prev, st, cfg, **kw), flush),
            }
            hh, dd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
            wk = [torch.randn((LM_MAX_BATCH, seq, hh, dd), generator=gen,
                              device=dev) for _ in range(3)]
            wl = -torch.rand((LM_MAX_BATCH, seq, hh, dd), generator=gen,
                             device=dev) * 5
            uu = lp["att"]["u"].float()
            wkv_fn = ((lambda: kernel.wkv_fused(*wk, wl, uu, st)) if chunked
                      else (lambda: rwkv6.wkv_naive(*wk, wl, uu, st)))
            parts["  of which WKV (B7)" if chunked else
                  "  of which WKV (per-token scan, plain)"] = cuda_ms(
                      torch, wkv_fn, flush)
            parts["channel mix (ddlerp, squared-ReLU FFN, receptance)"] = \
                cuda_ms(torch, lambda: rwkv6._channel_mix(
                    lp["ffn"], x, prev, cfg, lengths=kw["lengths"]), flush)
            toks = torch.zeros((LM_MAX_BATCH, seq), dtype=torch.long,
                               device=dev)
            once = {"embedding": cuda_ms(torch, lambda: embed_tokens(
                        params["embed"], toks, cfg), flush),
                    f"head (final norm, {cfg.d_model} x "
                    f"{cfg.padded_vocab} projection, all positions)":
                    cuda_ms(torch, lambda: lm_head(
                        params["embed"], x, cfg), flush)}
            wkv_key = [key for key in parts if key.startswith("  of which")][0]
            proj = parts["time mix (ddlerp, r/k/v/g/decay projections, WKV, "
                         "GroupNorm, output)"] - parts[wkv_key]
            total = (cfg.n_layers * (sum(parts.values()) - parts[wkv_key])
                     + sum(once.values()))
            for name, t in parts.items():
                print(f"[9] LM {kind} tick part, one layer: {name}: {t:.4f} "
                      f"ms (x {cfg.n_layers} = {cfg.n_layers * t:.3f} ms)")
            print(f"[9] LM {kind} tick part: projections and the rest of the "
                  f"time mix (time mix less WKV), x {cfg.n_layers}: "
                  f"{cfg.n_layers * proj:.3f} ms")
            for name, t in once.items():
                print(f"[9] LM {kind} tick part: {name}: {t:.3f} ms")
            print(f"[9] LM {kind} tick: parts sum to {total:.3f} ms of "
                  f"{tick[kind]:.3f} ms")
    kernel.wkv_fused.launches = counted
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def stem_launches(conv) -> dict:
    """B1's and B2's launch counts (the tuner picks either for a stem)."""
    return {"p2m_conv_fused": conv.p2m_conv_fused.launches,
            "p2m_conv_fused_pipelined":
                conv.p2m_conv_fused.launches_pipelined}


def reset_stem_launches(conv) -> None:
    conv.p2m_conv_fused.launches = 0
    conv.p2m_conv_fused.launches_pipelined = 0


def gated_launches(gated) -> dict:
    """B5's launch counts by body: B1's gated body and the ring."""
    return {"p2m_conv_fused_gated": gated.p2m_conv_fused_gated.launches,
            "p2m_conv_fused_gated_pipelined":
                gated.p2m_conv_fused_gated.launches_pipelined}


def reset_gated_launches(gated) -> None:
    gated.p2m_conv_fused_gated.launches = 0
    gated.p2m_conv_fused_gated.launches_pipelined = 0


def check_pipelined_kernel(torch, np, dev, serve_in, adc):
    """Phase 3d: B2 (the pipelined ring) against B1, bit for bit, `out`
    and `raw`, at depths 2, 3 and 8 (which clamps to k) and block_h 1, 2
    and 4, in every mode, at the serving (8x560²x3, the engine's folded
    stem), stream (4x560²x3) and training (32x560²x3, random weights)
    shapes, and over random geometries with s < k, N in {5, 8, 24} and
    dx 1-4.  Also against the plain twin at the serving shape.  Returns
    that largest raw/relu difference."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.kernels.p2m_conv import conv

    rng = np.random.default_rng(SEED + 30)
    size = CONFIG.image_size

    def case(b, h, w, c, k, n, dw, dx):
        coeffs = tuple(tuple(float(v) for v in rng.uniform(-1, 1, dx))
                       for _ in range(dw))
        imgs = torch.from_numpy(rng.random((b, h, w, c), np.float32)).to(dev)
        wt = torch.from_numpy(rng.uniform(-0.4, 0.4, (k * k * c, n)).astype(
            np.float32))
        sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32))
        return imgs, conv.premix_rows(wt, coeffs, k).to(dev), sh.to(dev)

    paper_imgs, wrows, shift = serve_in
    train_imgs = torch.from_numpy(rng.random((TRAIN_BATCH, size, size, 3),
                                             np.float32)).to(dev)
    cases = [  # name, inputs, k, s
        (f"serving {len(paper_imgs)}x{size}²", (paper_imgs, wrows, shift),
         5, 5),
        (f"stream 4x{size}²", (paper_imgs[:4].contiguous(), wrows, shift),
         5, 5),
        (f"training {TRAIN_BATCH}x{size}²", (train_imgs, wrows, shift), 5,
         5),
        ("k5 s3 N8 dx3", case(2, 64, 64, 3, 5, 8, 3, 3), 5, 3),
        ("k4 s3 N5 dx1", case(3, 37, 41, 3, 4, 5, 3, 1), 4, 3),
        ("k3 s2 N24 dx2", case(2, 33, 30, 3, 3, 24, 3, 2), 3, 2),
        ("k5 s4 N24 dx4", case(2, 40, 43, 3, 5, 24, 4, 4), 5, 4),
        ("k5 s2 N5 dx2", case(1, 50, 50, 3, 5, 5, 2, 2), 5, 2),
        ("k4 s2 N8 dx4", case(4, 29, 31, 2, 4, 8, 3, 4), 4, 2),
    ]
    serve_err = 0.0
    for name, (x, wr, sh), kk, ss in cases:
        for mode in ("raw", "relu", "quant"):
            kw = dict(kernel=kk, stride=ss, mode=mode, v_lsb=adc.v_lsb,
                      max_count=adc.max_count, want_raw=True)
            out1, raw1 = conv.p2m_conv_fused(x, wr, sh, **kw)
            n_b2 = 0
            for depth in (2, 3, 8):
                for bh in (1, 2, 4):
                    out2, raw2 = conv.p2m_conv_fused(
                        x, wr, sh, block_h=bh, pipeline_depth=depth, **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(out2, out1) and torch.equal(raw2, raw1),
                          f"{name} {mode} depth {depth} block_h {bh}: B2 "
                          "differs from B1")
                    n_b2 += 1
            line = (f"[3d] {name:17s} {mode:5s} {tuple(out1.shape)}: B2 == "
                    f"B1 bitwise (out and raw) at depths 2, 3, 8 x block_h "
                    f"1, 2, 4 ({n_b2} launches)")
            if name.startswith("serving"):
                ref_out, ref_raw = conv.p2m_conv_premixed_plain(
                    x, wr, sh, **kw)
                err = float((raw1 - ref_raw).abs().max())
                if mode != "quant":
                    err = max(err, float((out1 - ref_out).abs().max()))
                    check(err <= RAW_TOL, f"{name}: B2 vs plain {err}")
                serve_err = max(serve_err, err)
                line += f"; vs plain {err:.3e}"
            print(line)
    del train_imgs
    return serve_err


def check_pipelined_grads(torch, np, dev):
    """Phase 3e: at the training shape (32x560²x3, the train stem's raw
    mode), `ops.p2m_conv` with pipeline_depth=2 and with 0 give the same
    gradients for images, w and shift, bit for bit."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import conv, ops

    cfg = CONFIG.p2m
    rng = np.random.default_rng(SEED + 31)
    size = CONFIG.image_size
    kk = cfg.kernel * cfg.kernel * cfg.in_channels
    imgs = torch.from_numpy(rng.random((TRAIN_BATCH, size, size, 3),
                                       np.float32)).to(dev)
    wt = torch.from_numpy((rng.uniform(-1, 1, (kk, cfg.out_channels))
                           * (3.0 / kk) ** 0.5).astype(np.float32)).to(dev)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, cfg.out_channels).astype(
        np.float32)).to(dev)
    ho = cfg.out_spatial(size)
    ct = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, ho, ho, cfg.out_channels)).astype(np.float32)).to(dev)
    grads, counts = {}, {}
    for depth in (0, 2):
        ins = [t.clone().requires_grad_(True) for t in (imgs, wt, sh)]
        before = stem_launches(conv)
        out = ops.p2m_conv(*ins, default_pixel_model(), cfg.adc, "relu",
                           cfg.kernel, cfg.stride, pipeline_depth=depth)
        grads[depth] = torch.autograd.grad((out * ct).sum(), ins)
        counts[depth] = {k: v - before[k]
                         for k, v in stem_launches(conv).items()}
    torch.cuda.synchronize()
    check(counts[0] == {"p2m_conv_fused": 1, "p2m_conv_fused_pipelined": 0}
          and counts[2] == {"p2m_conv_fused": 0,
                            "p2m_conv_fused_pipelined": 1},
          f"forward launches {counts}")
    for name, a, b in zip(("images", "w", "shift"), grads[0], grads[2]):
        check(torch.equal(a, b), f"d/d {name} differs between depth 2 and 0")
    print(f"[3e] training shape {tuple(imgs.shape)}, relu: gradients for "
          f"images, w and shift through p2m_conv at pipeline_depth 2 (B2) "
          f"== at 0 (B1), bit for bit; forward launches {counts}")


def tune_signatures(torch, dev, signatures):
    """Phase 3f: the tuner at each signature (name -> get_conv_blocks
    arguments), timed as the first call of a path would meet it; print
    each decision record: every candidate with its shared-memory bytes and
    time, and the winner.  Fails if a candidate failed.  Returns the
    winners and the first-call seconds."""
    from repro_torch.kernels.p2m_conv import tune

    out = {}
    for name, args in signatures.items():
        n_before = len(tune.decision_records())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = tune.get_conv_blocks(*args, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        records = tune.decision_records()
        check(len(records) == n_before + 1, f"{name}: no new decision")
        rec = records[-1]
        check(rec["n_failed"] == 0, f"{name}: candidates failed: "
              f"{[e for e in rec['errors'] if e]}")
        print(f"[3f] tuner at the {name} signature {args[:7]} "
              f"mode {args[8]}: first call {seconds * 1e3:.1f} ms, winner "
              f"{tuple(best)} ({rec['best_s'] * 1e3:.4f} ms); candidates "
              f"(block_h, block_n, depth): smem bytes, ms:")
        for cand, smem, t in zip(rec["candidates"], rec["smem_bytes"],
                                 rec["times_s"]):
            print(f"    {tuple(cand)}: {smem} B, {t * 1e3:.4f} ms")
        out[name] = {"best": tuple(best), "first_call_s": seconds,
                     "key": rec["key"]}
    return out


def check_matmul_kernel(torch, np, dev, adc):
    """Phase 3g: B6 against its plain twin at (100,352, 75, 8) (8 images
    at 112², the reference benchmark's shape) and (4096, 147, 32), in
    every mode: raw and relu within 1e-5, quant by the count rule; and
    `ops.p2m_matmul`'s gradients (B6 forward, B3 and B4 backward) against
    autograd of `p2m_matmul_plain` in float64 within 1e-4 of the largest
    value.  Returns the largest raw/relu difference at the first shape."""
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import conv, kernel, ops

    model = default_pixel_model()
    coeffs = ops._coeff_tuple(model)
    rng = np.random.default_rng(SEED + 32)
    first_err = 0.0
    for m, kk, n in ((100_352, 75, 8), (4096, 147, 32)):
        x = torch.from_numpy(rng.random((m, kk), np.float32)).to(dev)
        w = torch.from_numpy((rng.uniform(-1, 1, (kk, n)) * (3.0 / kk) ** 0.5)
                             .astype(np.float32)).to(dev)
        sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
            np.float32)).to(dev)
        line = f"[3g] p2m_matmul_fused at ({m}, {kk}, {n}):"
        for mode in ("raw", "relu", "quant"):
            out, raw = kernel.p2m_matmul_fused(
                x, w, sh, coeffs=coeffs, mode=mode, v_lsb=adc.v_lsb,
                max_count=adc.max_count, want_raw=True)
            torch.cuda.synchronize()
            ref_raw = kernel.p2m_matmul_raw_plain(x, w, coeffs)
            ref_out = conv._epilogue_values(ref_raw, sh, mode=mode,
                                            v_lsb=adc.v_lsb,
                                            max_count=adc.max_count)
            err = float((raw - ref_raw).abs().max())
            check(err <= RAW_TOL, f"B6 ({m}, {kk}, {n}) raw differs by {err}")
            if mode == "quant":
                rep = conv.quant_disagreement(out, ref_out, ref_raw,
                                              adc.v_lsb)
                check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
                      and rep["all_near_half"],
                      f"B6 ({m}, {kk}, {n}) quant counts disagree: {rep}")
                line += f" quant {rep['n_diff']} counts differ (raw {err:.1e})"
            else:
                err = max(err, float((out - ref_out).abs().max()))
                check(err <= RAW_TOL, f"B6 ({m}, {kk}, {n}) {mode} differs "
                      f"by {err}")
                line += f" {mode} {err:.2e};"
                if m == 100_352:
                    first_err = max(first_err, err)
        print(line)
    m, kk, n = 20_000, 75, 8
    x = torch.from_numpy(rng.random((m, kk), np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (kk, n)) * (3.0 / kk) ** 0.5)
                         .astype(np.float32)).to(dev)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((m, n)).astype(
        np.float32)).to(dev)
    line = f"[3g] p2m_matmul gradients at ({m}, {kk}, {n}) vs float64 autograd:"
    for mode in ("raw", "relu", "quant"):
        ins = [t.clone().requires_grad_(True) for t in (x, w, sh)]
        got = torch.autograd.grad(
            (ops.p2m_matmul(*ins, model, adc, mode) * ct).sum(), ins)
        ref_ins = [t.double().requires_grad_(True) for t in (x, w, sh)]
        want = torch.autograd.grad(
            (ops.p2m_matmul_plain(*ref_ins, model, adc,
                                  "relu" if mode == "quant" else mode)
             * ct.double()).sum(), ref_ins)
        for name, a, b in zip(("x", "w", "shift"), got, want):
            err = float((a.double() - b).abs().max())
            scale = float(b.abs().max())
            check(err <= 1e-4 * scale, f"p2m_matmul {mode} d/d {name}: "
                  f"{err} of {scale}")
            line += f" {mode} d{name} {err:.1e} of {scale:.1e};"
    print(line)
    return first_err


def matmul_path(torch, np, dev, engine, images, adc):
    """Phase 5d: the patch-level path (the reference's "patches + kernel"
    tier): the serving batch's stem through `extract_patches` and
    `ops.p2m_matmul` (B6, quant) with the engine's folded weights, held to
    the deploy stem (B1/B2) by the count rule, and its gradients through
    B3 and B4.  Returns B6's launches."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.core.p2m_conv import (
        apply_p2m_conv_deploy,
        extract_patches,
    )
    from repro_torch.kernels.p2m_conv import backward, conv, kernel, ops

    cfg = CONFIG.p2m
    dep = engine._deploy
    b = images.shape[0]
    ho = cfg.out_spatial(images.shape[1])
    w = dep["w"].contiguous()
    shift = dep["shift"].float().contiguous()
    with torch.no_grad():
        stem = apply_p2m_conv_deploy(dep, images, cfg)
    torch.cuda.synchronize()
    counted = {fn: fn.launches for fn in (backward.p2m_bwd_dx,
                                          backward.p2m_bwd_dw)}
    kernel.p2m_matmul_fused.launches = 0
    x = extract_patches(images, cfg.kernel, cfg.stride).reshape(b * ho * ho,
                                                                -1)
    xg = x.contiguous().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    out = ops.p2m_matmul(xg, wg, shift, engine._pixel_model, adc, "quant")
    grads = torch.autograd.grad(out.sum(), [xg, wg])
    torch.cuda.synchronize()
    launches = kernel.p2m_matmul_fused.launches
    check(launches == 1, f"patch path launched B6 {launches} times")
    for fn, n in counted.items():
        check(fn.launches == n + 1, "patch path backward missed a kernel")
        fn.launches = n
    _, raw = conv.p2m_conv_premixed_plain(
        images, dep["wrows"], torch.zeros_like(shift), kernel=cfg.kernel,
        stride=cfg.stride, mode="raw", want_raw=True)
    rep = conv.quant_disagreement(out.detach().reshape(stem.shape), stem,
                                  raw, adc.v_lsb)
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"patch path vs deploy stem: {rep}")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "patch path gradients not finite")
    print(f"[5d] patch path: {tuple(x.shape)} patches of the serving batch "
          f"through p2m_matmul (B6, quant): {launches} launch, "
          f"{rep['n_diff']} counts differ from the deploy stem; its "
          f"gradients through B3 and B4 finite")
    return launches


def engine_b2_pass(torch, np, dev, params, bn, reqs_fn, serve_key):
    """Phase 5e: B2 inside an engine, whatever the tuner picked.  The
    serving signature's tuner cache entry is set to a depth-0 winner (B1)
    and then to a depth-2 winner (B2) by `tune.set_winner`, the way the
    reference's tests reach it, and the same 24 requests are served
    through a fresh `VisionEngine` each time; the probabilities must be
    equal bit for bit.  Returns each pass's launch counts."""
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.kernels.p2m_conv import conv, tune
    from repro_torch.serving import VisionEngine, drive

    (rec,) = [r for r in tune.decision_records() if r["key"] == serve_key]
    b2 = [tuple(c) for c in rec["candidates"] if c[2] >= 2]
    b2_best = min(b2, key=lambda c: rec["times_s"][
        rec["candidates"].index(list(c))])
    b1 = [tuple(c) for c in rec["candidates"] if c[2] == 0][0]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probs, counts = {}, {}
    try:
        for name, winner in (("B1", b1), ("B2", b2_best)):
            tune.set_winner(serve_key, winner)
            eng = VisionEngine(params, bn, CONFIG, device=dev)
            torch.cuda.synchronize()
            reset_stem_launches(conv)
            drive(eng, reqs_fn(), on_undrained="raise")
            torch.cuda.synchronize()
            counts[name] = stem_launches(conv)
            done = eng.completed
            check([r.uid for r in done] == list(range(len(done)))
                  and not eng.failed, f"{name} pass: completion")
            probs[name] = np.stack([r.probs for r in done])
            print(f"[5e] {name} pass, serving winner {winner}: "
                  f"{len(done)} requests in {eng.stats['launches']} "
                  f"launches; launches {counts[name]}")
    finally:
        tune.set_winner(serve_key, rec["best"])
        torch.backends.cudnn.deterministic = False
    check(counts["B2"]["p2m_conv_fused_pipelined"] > 0
          and counts["B2"]["p2m_conv_fused"] == 0
          and counts["B1"]["p2m_conv_fused_pipelined"] == 0
          and counts["B1"]["p2m_conv_fused"] > 0, f"launches {counts}")
    check(np.array_equal(probs["B1"], probs["B2"]),
          "B2 pass probabilities differ from the B1 pass's")
    print(f"[5e] the B2 pass's probabilities equal the B1 pass's bit for "
          f"bit ({probs['B2'].shape})")
    return counts


def check_faults(torch, np, dev):
    """Phase 5f: the port's two fixed faults, on the card.  C1: a request
    with prompt token ``cfg.padded_vocab`` fails alone at submit (SMOKE
    rwkv), the others complete, and the same engine then serves a good
    request.  C2: every kernel wrapper raises on an input that requires
    grad under grad mode, and launches the same call under no_grad."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.p2m_conv import backward, conv, gated, kernel
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
    from repro_torch.models.families import get_family
    from repro_torch.serving import Request, ServeEngine, drive
    from repro_torch.serving.engine import FAILED_TOKEN

    cfg = get_smoke_config(LM_ARCH).replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    eng = ServeEngine(params, cfg, max_batch=2, max_len=64, prefill_chunk=4,
                      device=dev)
    good = [5, 17, 300, 2, 9]
    reqs = [Request(uid=0, prompt=good, max_new_tokens=4),
            Request(uid=1, prompt=[3, cfg.padded_vocab, 4],
                    max_new_tokens=4),
            Request(uid=2, prompt=good[::-1], max_new_tokens=4)]
    statuses = [eng.submit(r) for r in reqs]
    drive(eng, [], on_undrained="raise")
    torch.cuda.synchronize()
    check(statuses[1] == FAILED_TOKEN and eng.failed == [reqs[1]]
          and sorted(r.uid for r in eng.completed) == [0, 2],
          f"C1: statuses {statuses}, failed {[r.uid for r in eng.failed]}, "
          f"completed {[r.uid for r in eng.completed]}")
    drive(eng, [Request(uid=3, prompt=good, max_new_tokens=4)],
          on_undrained="raise")
    torch.cuda.synchronize()
    check(eng.completed[-1].uid == 3
          and eng.completed[-1].output == reqs[0].output,
          "C1: the engine did not serve the next request")
    print(f"[5f] C1: token {cfg.padded_vocab} (= padded_vocab) fails its "
          f"request alone at submit ({statuses[1]}); the other 2 completed, "
          f"then a good request served with the same tokens as before")

    rng = np.random.default_rng(SEED + 33)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, np.float32)).to(dev)

    x, shift = t(2, 20, 20, 3), t(8)
    wrows = t(5, 45, 8) - 0.5
    xg = x.clone().requires_grad_(True)
    r, k, v = t(1, 16, 2, 16), t(1, 16, 2, 16), t(1, 16, 2, 16)
    lw, u, s0 = -t(1, 16, 2, 16), t(2, 16), t(1, 2, 16, 16)
    mx, mw, mg = t(64, 75), t(75, 8) - 0.5, t(64, 8) - 0.5
    coeffs = ((0.5, 0.1, 0.0), (0.2, 0.0, 0.0), (0.1, 0.0, 0.0))
    calls = {
        "p2m_conv_fused (B1)": lambda: conv.p2m_conv_fused(
            xg, wrows, shift, kernel=5, stride=5),
        "p2m_conv_fused (B2)": lambda: conv.p2m_conv_fused(
            xg, wrows, shift, kernel=5, stride=5, pipeline_depth=2),
        "p2m_conv_fused_gated (B5)": lambda: gated.p2m_conv_fused_gated(
            xg, wrows, shift, torch.zeros((2, 4, 4, 8), device=dev),
            torch.ones(2, dtype=torch.bool, device=dev), kernel=5, stride=5),
        "p2m_matmul_fused (B6)": lambda: kernel.p2m_matmul_fused(
            mx, mw.clone().requires_grad_(True), t(8), coeffs=coeffs),
        "p2m_bwd_dx (B3)": lambda: backward.p2m_bwd_dx(
            mg.clone().requires_grad_(True), mw, mx, coeffs),
        "p2m_bwd_dw (B4)": lambda: backward.p2m_bwd_dw(
            mg.clone().requires_grad_(True), mw, mx, coeffs),
        "wkv_fused (B7)": lambda: wkv_kernel.wkv_fused(
            r, k.clone().requires_grad_(True), v, lw, u, s0),
    }
    counted = (stem_launches(conv), gated.p2m_conv_fused_gated.launches,
               kernel.p2m_matmul_fused.launches, backward.p2m_bwd_dx.launches,
               backward.p2m_bwd_dw.launches, wkv_kernel.wkv_fused.launches)
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as exc:
            check("requires grad" in str(exc), f"C2 {name}: {exc}")
        else:
            check(False, f"C2: {name} launched on an input that requires "
                  "grad under grad mode")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted[0].values()
    (gated.p2m_conv_fused_gated.launches, kernel.p2m_matmul_fused.launches,
     backward.p2m_bwd_dx.launches, backward.p2m_bwd_dw.launches,
     wkv_kernel.wkv_fused.launches) = counted[1:]
    print(f"[5f] C2: {', '.join(calls)} each raise on an input that "
          f"requires grad under grad mode, and launch under no_grad")


VISION_ARRIVALS = [0] * 8 + [1] * 3 + [2] * 6 + [4] * 7  # phase 5's
DOOR_LM_COST = 4  # front-door ticks one LM engine tick costs (phase 5h)
DOOR_STREAM_TOL = 1e-5  # boxes, scores: phase 5h against phase 5b
DOOR_LAUNCHER = ["--arch", LM_ARCH, "--mixed", "--prefill-chunk",
                 str(LM_CHUNK), "--vision-requests", "12", "--video-streams",
                 "2", "--vision-replicas", "2", "--lm-tick-cost",
                 str(DOOR_LM_COST)]
# Chaos (5h (c)): SMOKE_PLAN on every engine (one seed each) plus one
# explicit launch-error tick, NaN tick and stuck uid an engine, one retry
# a launch, and a watchdog above the engine's longest request (LM: 3
# prefill + 16 decode ticks; a frame 1 tick; a stream 12).  An explicit
# launch tick raises on every attempt, so it fails its whole cohort; a
# drawn one is keyed by attempt and may clear on the retry.
DOOR_CHAOS = {  # engine: (launch tick, NaN tick, stuck uid, watchdog)
    "lm": (3, 6, 13, 48),
    "vision[0]": (1, 2, 1009, 3),
    "vision[1]": (2, 1, 1009, 3),
    "stream": (4, 7, 2003, 16),
}


def door_requests(lm_reqs, images, frames) -> list:
    """Phase 5h's traffic on the door's clock: phase 5c's LM requests,
    phase 5's 24 frames (uids 1000-1023) at its arrivals, phase 5b's
    streams (uids 2000-2005) one a tick."""
    from repro_torch.serving import VisionRequest
    from repro_torch.video import StreamRequest

    return (list(lm_reqs)
            + [VisionRequest(uid=1000 + i, image=images[i], arrival_tick=t)
               for i, t in enumerate(VISION_ARRIVALS)]
            + [StreamRequest(uid=2000 + i, frames=f, arrival_tick=i)
               for i, f in enumerate(frames)])


def build_door(torch, dev, lm_params, lm_cfg, vparams, vbn, vcfg, det, *,
               lm_cost, lockstep=False, chaos=False):
    """A door of phase 5h's shape on ``dev``: ``lm`` a `ServeEngine`
    (8 slots, max_len 512, chunk 64, ``tick_cost`` ``lm_cost``),
    ``vision`` a `ReplicaPool` of two `VisionEngine`s (microbatch 8,
    8-bit deploy stem), ``stream`` a gated `StreamEngine` (4 slots),
    traced.  Returns the door, its tracer, the LM's tick record and
    margins (`lm_instrument`) and the injectors (``chaos``)."""
    import dataclasses

    from repro_torch.launch.serve import FrontDoor
    from repro_torch.obs import Tracer
    from repro_torch.serving import (
        SMOKE_PLAN,
        FaultInjector,
        ReplicaPool,
        ServeEngine,
        VisionEngine,
    )
    from repro_torch.video import DeltaGateConfig, StreamEngine

    injectors = {}

    def core(name, seed):
        if not chaos:
            return {}
        launch, nan, stuck, watchdog = DOOR_CHAOS[name]
        injectors[name] = FaultInjector(dataclasses.replace(
            SMOKE_PLAN, seed=SEED + seed, launch_error_ticks=(launch,),
            nan_ticks=(nan,), stuck_uids=(stuck,)))
        return {"faults": injectors[name], "launch_retries": 1,
                "max_serve_ticks": watchdog}

    lm = ServeEngine(lm_params, lm_cfg, max_batch=LM_MAX_BATCH,
                     max_len=LM_MAX_LEN, prefill_chunk=LM_CHUNK,
                     tick_cost=lm_cost, device=dev, **core("lm", 21))
    vision = ReplicaPool(*[VisionEngine(vparams, vbn, vcfg, device=dev,
                                        **core(f"vision[{k}]", 22 + k))
                           for k in range(2)])
    stream = StreamEngine(vparams, vbn, vcfg, det,
                          gate=DeltaGateConfig(threshold=0.0), device=dev,
                          **core("stream", 24))
    tracer = Tracer()
    door = FrontDoor(lockstep=lockstep, tracer=tracer, lm=lm, vision=vision,
                     stream=stream)
    ticks, margins = lm_instrument(torch, lm)
    return door, tracer, ticks, margins, injectors


def check_door_launches(tag, door, counts, lm_ticks, n_layers) -> int:
    """The kernels' counts against the engines' own: B1 + B2 = the two
    replicas' launches (each launched), B5 = the stream engine's, B7 =
    32 a prefill tick and none on a decode tick.  Returns the prefill
    ticks."""
    pool, stream = door.engines["vision"], door.engines["stream"]
    per = [rep.stats["launches"] for rep in pool.replicas]
    stem = counts["p2m_conv_fused"] + counts["p2m_conv_fused_pipelined"]
    check(stem == sum(per) and all(n > 0 for n in per),
          f"5h {tag}: B1 + B2 launched {stem} times, the replicas {per}")
    b5 = (counts["p2m_conv_fused_gated"]
          + counts["p2m_conv_fused_gated_pipelined"])
    check(b5 == stream.stats["launches"] and b5 > 0,
          f"5h {tag}: B5 launched {b5} times in the stream engine's "
          f"{stream.stats['launches']} ticks")
    prefill = sum(k == "prefill" for k, _ in lm_ticks)
    check(all(n == (n_layers if k == "prefill" else 0) for k, n in lm_ticks)
          and counts["wkv_fused"] == n_layers * prefill and prefill > 0,
          f"5h {tag}: B7 launched {counts['wkv_fused']} times over "
          f"{prefill} prefill ticks")
    return prefill


def check_door_outputs(np, tag, door, ref, margins) -> dict:
    """Each completed request's output against ``ref`` (uid → LM tokens,
    vision probabilities or stream frame outputs; ``ref["margins"]``
    the LM run's top-2 margins): vision within ``PROBS_TOL``, stream
    boxes and scores within ``DOOR_STREAM_TOL``, LM tokens equal up to a
    near-tie (phase 5c's rule).  Returns how many were bit for bit."""
    same = {"lm": 0, "vision": 0, "stream": 0}
    worst = {"vision": 0.0, "stream": 0.0}
    for name, r in door.completed:
        want = ref[r.uid]
        if name == "vision":
            d = float(np.abs(r.probs - want).max())
            worst["vision"] = max(worst["vision"], d)
            check(d <= PROBS_TOL, f"5h {tag}: frame {r.uid}'s probs differ "
                  f"by {d}")
            same["vision"] += bool(np.array_equal(r.probs, want))
        elif name == "stream":
            check(len(r.frame_outputs) == len(want),
                  f"5h {tag}: stream {r.uid} has {len(r.frame_outputs)} "
                  f"frames")
            d = max(max(float(np.abs(b - wb).max()),
                        float(np.abs(s - ws).max()))
                    for (b, s), (wb, ws) in zip(r.frame_outputs, want))
            worst["stream"] = max(worst["stream"], d)
            check(d <= DOOR_STREAM_TOL, f"5h {tag}: stream {r.uid}'s boxes "
                  f"or scores differ by {d}")
            same["stream"] += all(
                np.array_equal(b, wb) and np.array_equal(s, ws)
                for (b, s), (wb, ws) in zip(r.frame_outputs, want))
        else:
            if r.output == want:
                same["lm"] += 1
                continue
            j = next(i for i, (x, y) in enumerate(zip(r.output, want))
                     if x != y)
            m = min(margins[r.uid][j], ref["margins"][r.uid][j])
            print(f"[5h] {tag}: request {r.uid}'s tokens differ first at "
                  f"output {j}, top-2 margin {m:.3e} (limit "
                  f"{LM_LOGIT_TOL})")
            check(m <= LM_LOGIT_TOL, f"5h {tag}: request {r.uid}'s tokens "
                  f"differ at output {j}, not a near-tie (margin {m})")
    return {"bitwise": same, "worst": worst}


def door_summary_lines(door) -> list[str]:
    """One line an engine (and a replica) of the door's latency summary,
    tick figures on the door's clock."""
    lines = []

    def line(label, s):
        lines.append(
            f"{label}: served {s['served']}, launches {s['launches']}, "
            f"queue ticks mean {s['mean_queue_ticks']:.3f} p50 "
            f"{s['p50_queue_ticks']:.1f} p95 {s['p95_queue_ticks']:.1f} "
            f"p99 {s['p99_queue_ticks']:.1f}, serve ticks mean "
            f"{s['mean_serve_ticks']:.3f} p50 {s['p50_serve_ticks']:.1f} "
            f"p95 {s['p95_serve_ticks']:.1f} p99 {s['p99_serve_ticks']:.1f},"
            f" mean launch {s['mean_launch_us'] / 1e3:.3f} ms")

    for name, s in door.latency_summary().items():
        line(name, s)
        for k, rep in enumerate(s.get("replicas", ())):
            line(f"{name}[{k}]", rep)
    return lines


def door_path(torch, np, dev, lm, vision, stream_ref, smi):
    """Phase 5h: the front door on the card.  ``lm``: phase 5c's result
    (its params, requests, tokens and margins); ``vision``: phase 5's
    params, BN state, images and probabilities by uid; ``stream_ref``:
    phase 5b's gated frame outputs by uid.  (a) LM, vision and video
    traffic through one `FrontDoor`, fault-free and traced; (b) every
    ``tick_cost`` 1: the event-driven door and the lockstep door; (c) the
    traffic again under seeded fault injection; (d) (a)'s tick-domain
    export against a door of the same shape on the CPU; (e) the
    launcher's ``--mixed`` in a subprocess.  Returns the kernels'
    launches in (a)-(c); no engine outlives it."""
    import gc
    import os

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.p2m_vww import CONFIG, SERVE_MAX_BATCH
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv, gated
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
    from repro_torch.launch.serve import _make_vision_engine
    from repro_torch.models.families import get_family
    from repro_torch.obs import validate_trace_events
    from repro_torch.serving import Request, drive

    cfg = lm["cfg"]
    frames = stream_frames(CONFIG.image_size)
    det = stream_head(torch, dev, CONFIG)
    ref = {**{1000 + uid: p for uid, p in vision["probs"].items()},
           **{2000 + uid: o for uid, o in stream_ref.items()},
           **lm["outputs"], "margins": lm["margins"]}

    def requests():
        return door_requests(lm["requests"](), vision["images"], frames)

    def run(tag, lm_cost, **kw):
        door, tracer, ticks, margins, inj = build_door(
            torch, dev, lm["params"], cfg, vision["params"], vision["bn"],
            CONFIG, det, lm_cost=lm_cost, **kw)
        reqs = requests()
        torch.cuda.synchronize()
        reset_stem_launches(conv)
        reset_gated_launches(gated)
        wkv_kernel.wkv_fused.launches = 0
        t0 = time.perf_counter()
        drive(door, reqs, on_undrained="raise")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**stem_launches(conv), **gated_launches(gated),
                  "wkv_fused": wkv_kernel.wkv_fused.launches}
        prefill = check_door_launches(tag, door, counts, ticks, cfg.n_layers)
        return {"door": door, "tracer": tracer, "margins": margins,
                "inj": inj, "reqs": reqs, "counts": counts,
                "seconds": seconds, "prefill": prefill, "ticks": ticks}

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # (a) fault-free and traced; nothing injected before this check
    a = run("(a)", DOOR_LM_COST)
    door = a["door"]
    n_req = len(a["reqs"])
    check(len(door.completed) == n_req and not door.down,
          f"5h (a): {len(door.completed)} of {n_req} completed, down "
          f"{door.down}")
    for name, eng in door.engines.items():
        check(not eng.failed and not eng.evicted and not eng.rejected,
              f"5h (a): {name} failed {len(eng.failed)}, evicted "
              f"{len(eng.evicted)}, rejected {len(eng.rejected)}")
    events = a["tracer"].trace_events()
    problems = validate_trace_events(events)
    check(problems == [], f"5h (a): trace problems {problems[:5]}")
    a_out = check_door_outputs(np, "(a)", door, ref, a["margins"])
    export = a["tracer"].export()
    decode = sum(k == "decode" for k, _ in a["ticks"])
    print(f"[5h] (a) {n_req} requests (16 LM, 24 frames, 6 streams) through "
          f"one FrontDoor (lm tick_cost {DOOR_LM_COST}, vision a pool of 2, "
          f"stream) in {door.tick} door ticks, {a['seconds']:.3f} s wall "
          f"on {smi}; none failed, evicted or rejected, no engine down; "
          f"{len(events)} trace events, valid; kernel launches "
          f"{a['counts']} (replicas "
          f"{[r.stats['launches'] for r in door.engines['vision'].replicas]}"
          f", stream ticks {door.engines['stream'].stats['launches']}, LM "
          f"{a['prefill']} prefill and {decode} decode ticks)")
    print(f"[5h] (a) outputs vs phases 5, 5b, 5c: bit for bit "
          f"{a_out['bitwise']} of 16 LM, 24 frames, 6 streams; largest "
          f"difference vision {a_out['worst']['vision']:.3e}, stream "
          f"{a_out['worst']['stream']:.3e}")
    for line in door_summary_lines(door):
        print(f"[5h] (a) latency, door clock: {line}")
    out = {"seconds": a["seconds"], "door_ticks": door.tick,
           "counts": dict(a["counts"])}
    a_ref = {**{r.uid: (r.probs if n == "vision" else
                        r.frame_outputs if n == "stream" else r.output)
                for n, r in door.completed}, "margins": a["margins"]}
    del door, a

    # (b) every tick_cost 1: event-driven == lockstep
    b = [run(f"(b) {kind}", 1, lockstep=kind == "lockstep")
         for kind in ("event", "lockstep")]
    order = [[(n, r.uid) for n, r in x["door"].completed] for x in b]
    exports = [x["tracer"].export() for x in b]
    check(order[0] == order[1] and exports[0] == exports[1]
          and all(len(o) == n_req for o in order),
          "5h (b): the event-driven and the lockstep doors differ")
    print(f"[5h] (b) every tick_cost 1: event-driven and lockstep doors "
          f"give the same {len(order[0])} completions in "
          f"{b[0]['door'].tick} door ticks and byte-identical traces "
          f"({len(exports[0])} bytes); {b[0]['seconds']:.3f} s and "
          f"{b[1]['seconds']:.3f} s wall")
    out["lockstep_counts"] = [dict(x["counts"]) for x in b]
    del b, exports

    # (c) chaos
    c = run("(c)", DOOR_LM_COST, chaos=True)
    door, inj = c["door"], c["inj"]
    engines = {"lm": [door.engines["lm"]],
               "vision": door.engines["vision"].replicas,
               "stream": [door.engines["stream"]]}
    poisoned = set().union(*(i.poisoned_uids for i in inj.values()))
    by_uid = {}
    for name, engs in engines.items():
        for e in engs:
            for kind in ("completed", "failed", "evicted", "rejected"):
                for r in getattr(e, kind):
                    by_uid.setdefault(r.uid, []).append(kind)
    want_uids = sorted(r.uid for r in c["reqs"])
    check(sorted(by_uid) == want_uids
          and all(len(v) == 1 for v in by_uid.values()),
          f"5h (c): not every uid on exactly one ledger: "
          f"{ {u: v for u, v in by_uid.items() if len(v) != 1} }")
    failed = {u for u, v in by_uid.items() if v == ["failed"]}
    # what poisoned each uid, from the trace's inject instants
    kinds: dict = {}
    for ev in c["tracer"].trace_events():
        if ev["name"] == "inject" and ev["args"].get("uid") is not None:
            kinds.setdefault(ev["args"]["uid"], set()).add(ev["args"]["kind"])
    hard = {u for u, k in kinds.items() if k != {"launch"}}
    cleared = poisoned - hard - failed
    check(set(kinds) == poisoned and hard <= failed
          and all(by_uid[u] == ["completed"] for u in cleared),
          f"5h (c): poisoned {sorted(poisoned)} by {kinds}, failed "
          f"{sorted(failed)}")
    names = ["lm", "vision[0]", "vision[1]", "stream"]
    flat = [door.engines["lm"], *door.engines["vision"].replicas,
            door.engines["stream"]]
    for name, e in zip(names, flat):
        check(e.stats["launch_faults"] == inj[name].counts["launch"],
              f"5h (c): {name} counted {e.stats['launch_faults']} launch "
              f"faults, its injector raised {inj[name].counts['launch']}")
    problems = validate_trace_events(c["tracer"].trace_events())
    check(problems == [], f"5h (c): trace problems {problems[:5]}")
    # every completed request, a launch victim cleared by its retry too
    # (the raise came before the launch), equals (a)'s
    c_out = check_door_outputs(np, "(c)", door, a_ref, c["margins"])
    survivors = sum(1 for v in by_uid.values() if v == ["completed"])
    print(f"[5h] (c) SMOKE_PLAN + one launch-error tick, NaN tick and stuck "
          f"uid an engine, one retry: drained in {door.tick} door ticks "
          f"({c['seconds']:.3f} s); {survivors} completed, {len(failed)} "
          f"failed ({sorted(failed)}), every uid on one ledger; poisoned "
          f"by NaN or stuck {len(hard)}, all failed; by launch alone "
          f"{len(poisoned) - len(hard)}, {len(cleared)} of them cleared by "
          f"the retry and completed; every launch fault an injected one; "
          f"every completed request equals (a)'s (bit for bit "
          f"{c_out['bitwise']}); down {door.down}")
    for name in names:
        print(f"[5h] (c) injector {name}: {inj[name].summary()}")
    out["chaos_counts"] = dict(c["counts"])
    del door, c, inj, flat, engines

    # (d) the same door's shape on the CPU: the same tick-domain bytes
    cpu = torch.device("cpu")
    smoke = get_smoke_config(LM_ARCH).replace(dtype=torch.float32)
    s_params, _ = get_family(smoke).init(torch.Generator().manual_seed(SEED),
                                         smoke)
    small, vcfg = _make_vision_engine(max_batch=SERVE_MAX_BATCH, device=cpu)
    cdoor, ctracer, _, _, _ = build_door(
        torch, cpu, s_params, smoke, small._params, small._bn, vcfg,
        stream_head(torch, cpu, vcfg), lm_cost=DOOR_LM_COST)
    imgs = SyntheticVWW(image_size=vcfg.image_size,
                        batch=len(VISION_ARRIVALS),
                        seed=SEED + 1).batch_at(0)["images"]
    lm_reqs = [Request(uid=r.uid, prompt=[t % smoke.vocab for t in r.prompt],
                       max_new_tokens=r.max_new_tokens,
                       arrival_tick=r.arrival_tick)
               for r in lm["requests"]()]
    t0 = time.perf_counter()
    drive(cdoor, door_requests(lm_reqs, imgs, stream_frames(vcfg.image_size)),
          on_undrained="raise")
    cpu_s = time.perf_counter() - t0
    same = ctracer.export() == export
    check(same, "5h (d): the card's tick-domain export differs from the "
          "CPU door's")
    print(f"[5h] (d) a door of the same shape on the CPU (SMOKE LM, 40² "
          f"vision and streams, {cpu_s:.2f} s): tick-domain export equal "
          f"to the card's byte for byte ({len(export)} bytes, no argument "
          f"left out)")
    del cdoor, ctracer, small, s_params

    # (e) the launcher in a subprocess on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *DOOR_LAUNCHER],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    lines = proc.stdout.strip().splitlines()
    first = next((k for k, ln in enumerate(lines)
                  if ln.startswith("front door: ")), None)
    lines = lines[first:first + 5] if first is not None else []
    check(proc.returncode == 0 and len(lines) == 5 and lines[0].startswith(
        "front door: 8 LM requests (128 tokens) + 12 frames + 2 video "
        "streams") and "on cuda" in lines[0]
          and [ln.split(":")[0].strip() for ln in lines[1:]]
          == ["stream", "lm", "vision", "stream"],
          f"5h (e): launcher exited {proc.returncode}: {proc.stdout} "
          f"{proc.stderr[-2000:]}")
    print(f"[5h] (e) python -m repro_torch.launch.serve "
          f"{' '.join(DOOR_LAUNCHER)}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in lines:
        print(f"[5h] (e)   {line}")
    torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    return out


DENSE_ARCH = "llama3.2-1b"
DENSE_LAYERS = 2  # (a): Llama-3.2-1B's depth cut, of 16 (room for 5n)
# Phase 5i (c): published widths, depth cut to fit float32 in 80 GB.
DENSE_CUT = (("qwen3-32b", 2), ("qwen2-72b", 2))
DENSE_REQUESTS = 4  # (b) and (c): the first four of phase 5c's prompts
# Each of the float32 scan's and forward's first-prefill-tick logits
# within this share of the largest |float64 logit| of the float64
# forward.  The spread printed beside it (the largest difference among
# the three) is the near-tie limit for the tokens.
DENSE_F64_TOL = 1e-3
DENSE_LAUNCHER = ["--arch", DENSE_ARCH, "--mixed", "--video-streams", "2",
                  "--vision-replicas", "2", "--prefill-chunk", str(LM_CHUNK)]


def forward_f64(torch, params, tokens, cfg):
    """The family's forward (`transformer.forward`, `rglru.forward`) in
    float64 on the float32 ``params``, one layer's weights (rglru: one
    group's, then each tail layer's) converted at a time, with the
    embedding rows and the head, so a cut Qwen2-72B (24 GB in float32) or
    a Mixtral layer needs no float64 copy of the whole model.  The casts
    the model itself makes to float32 stay: norms, attention scores and
    softmax, the MoE router, the RG-LRU's gates and scan, the logits."""
    from repro_torch.models import rglru, transformer
    from repro_torch.models.layers import lm_head
    from repro_torch.tree import tree_map

    cfg64 = cfg.replace(dtype=torch.float64)
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = params["embed"]["table"][tokens].double()
    with torch.no_grad():
        if cfg.family == "rglru":
            n_groups, rem = rglru._pattern_split(cfg)
            for g in range(n_groups):
                gp = tree_map(lambda a: a[g].double(), params["groups"])
                x = rglru._group(x, gp, pos, cfg64)
                del gp
            for i in range(rem):
                tp = tree_map(lambda a: a[i].double(), params["tail"])
                x, _ = rglru._rec_block(tp, x, None, cfg64)
                del tp
        else:
            for i in range(cfg.n_layers):
                lp = tree_map(lambda a: a[i].double(), params["layers"])
                if "moe" in lp:  # the router is float32 by definition
                    lp["moe"]["router"] = params["layers"]["moe"]["router"][i]
                x, _ = transformer._layer(x, lp, pos, cfg64, impl="flash")
                del lp
        head = "table" if cfg.tie_embeddings else "head"
        emb = {"final_norm": tree_map(lambda a: a.double(),
                                      params["embed"]["final_norm"]),
               head: params["embed"][head].double()}
        return lm_head(emb, x, cfg64)


def forward_f32(params, tokens, cfg):
    """The family's own forward, float32 logits."""
    from repro_torch.models import rglru, transformer

    module = rglru if cfg.family == "rglru" else transformer
    return module.forward(params, tokens, cfg)[0]


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count (B1 and B2, B5 on both bodies,
    B6, B3, B4, B7)."""
    from repro_torch.kernels.p2m_conv import backward, conv, gated, kernel
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    return {**stem_launches(conv), **gated_launches(gated),
            "p2m_matmul_fused": kernel.p2m_matmul_fused.launches,
            "p2m_bwd_dx": backward.p2m_bwd_dx.launches,
            "p2m_bwd_dw": backward.p2m_bwd_dw.launches,
            "wkv_fused": wkv_kernel.wkv_fused.launches}


def reset_kernel_counts() -> None:
    from repro_torch.kernels.p2m_conv import backward, conv, gated, kernel
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    reset_stem_launches(conv)
    reset_gated_launches(gated)
    kernel.p2m_matmul_fused.launches = 0
    backward.p2m_bwd_dx.launches = 0
    backward.p2m_bwd_dw.launches = 0
    wkv_kernel.wkv_fused.launches = 0


def moe_drops(cfg, fn):
    """Run ``fn()`` with each MoE layer's input routed once more at
    ``cfg``'s own capacity factor: returns (fn's result, the (token,
    expert) slots that factor would drop, the slots routed)."""
    from repro_torch.models import moe, transformer

    real, count = transformer.apply_moe, [0, 0]

    def counting(p, x, run_cfg, **kw):
        _, _, idx = moe.route(p, x, run_cfg)
        pos = moe.positions(idx, cfg.n_experts)
        count[0] += int((pos >= moe.capacity(cfg, x.shape[1])).sum())
        count[1] += pos.numel()
        return real(p, x, run_cfg, **kw)

    transformer.apply_moe = counting
    try:
        out = fn()
    finally:
        transformer.apply_moe = real
    return out, count[0], count[1]


def served_model(torch, np, dev, cfg, tag, n_requests, published=None,
                 phase="5i"):
    """Serve ``cfg`` (float32, random weights from ``SEED`` on the card)
    through `ServeEngine` (8 slots, max_len 512, chunk 64) on the first
    ``n_requests`` of phase 5c's requests: every request completes, no
    kernel of the port launches (the counts are set to 0 before and read
    after); then the first prefill tick's last-active logits from the
    masked decode scan against the family's forward in float32 and in
    float64 on the same prompts.  A MoE model's two forwards run at the
    capacity factor E/k, at which ``capacity(S) ≥ S`` and nothing drops
    (decode groups hold one token and drop nothing at the published
    factor); the slots the published factor would drop in that forward
    are counted.  Returns the engine, the params, the outputs, the
    margins, the spread and the parameter count."""
    from repro_torch.common.pytree import param_count
    from repro_torch.models import moe
    from repro_torch.models.families import get_family
    from repro_torch.serving import ServeEngine, drive

    t0 = time.perf_counter()
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    torch.cuda.synchronize()
    n_params = param_count(params)
    est = cfg.param_count_estimate()
    depth = (f"{cfg.n_layers} of {published} layers run" if published
             else f"{cfg.n_layers} layers")
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}"
           if cfg.family == "moe" else f"d_ff {cfg.d_ff}")
    print(f"[{phase}] {tag} {cfg.name}: {depth}, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.resolved_head_dim} ({cfg.n_kv_heads} "
          f"KV), {ffn}, vocab {cfg.vocab}; {n_params} parameters in the "
          f"tree, {est} by the reference's estimate (no norms or biases"
          f"{'; active experts' if cfg.family == 'moe' else ''}), "
          f"{4 * n_params / 1e9:.2f} GB fp32, initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    lengths, requests = lm_traffic(np, cfg.vocab, n_requests)
    eng = ServeEngine(params, cfg, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                      prefill_chunk=LM_CHUNK, device=dev)
    cache_gb = sum(a.numel() * a.element_size()
                   for a in eng.state.values()) / 1e9
    first = {}
    ticks, margins = lm_instrument(torch, eng, first)
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    drive(eng, requests(), on_undrained="raise")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = kernel_counts()
    done = sorted(eng.completed, key=lambda r: r.uid)
    check([r.uid for r in done] == list(range(n_requests))
          and not eng.failed and not eng.evicted,
          f"{phase} {tag}: completed {[r.uid for r in done]}, failed "
          f"{len(eng.failed)}, evicted {len(eng.evicted)}")
    check(all(len(r.output) == LM_NEW_TOKENS
              and all(0 <= t < cfg.vocab for t in r.output) for r in done),
          f"{phase} {tag}: outputs misshapen")
    check(not any(launched.values()),
          f"{phase} {tag}: the {cfg.family} path launched kernels {launched}")
    kinds = [k for k, _ in ticks]
    print(f"[{phase}] {tag} ServeEngine: {len(done)} requests (prompts "
          f"{min(lengths)}-{max(lengths)} tokens), "
          f"{sum(len(r.output) for r in done)} tokens in "
          f"{eng.stats['launches']} ticks ({kinds.count('prefill')} prefill, "
          f"{kinds.count('decode')} decode), {seconds:.2f} s cold; KV cache "
          f"{cache_gb:.3f} GB; kernel launches {sum(launched.values())} "
          f"(B7 {launched['wkv_fused']})")

    # The first prefill tick: every slot starts at position 0 from an
    # empty cache, so the forward over the tick's tokens sees each
    # slot's prompt prefix; a row's logits at its last active position
    # are the scan's.
    _, tokens, pos, n_active = first["inputs"]
    rows = n_active > 0
    check(bool((pos[rows] == 0).all()), f"{phase} {tag}: the first prefill "
          "tick does not start at position 0")
    idx = (n_active[rows] - 1).long()
    sel = torch.arange(int(rows.sum()), device=dev)
    ref_cfg, drops = cfg, ""
    if cfg.family == "moe":
        ref_cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        s = tokens.shape[1]
        check(moe.capacity(ref_cfg, s) >= s and moe.capacity(cfg, 1)
              >= cfg.top_k, f"{phase} {tag}: capacities")
    with torch.no_grad():
        if cfg.family == "moe":
            f32, n_drop, n_slot = moe_drops(
                cfg, lambda: forward_f32(params, tokens[rows], ref_cfg))
            cf = ref_cfg.capacity_factor
            drops = (f"; the forwards at capacity factor {cf:g} (capacity "
                     f"{moe.capacity(ref_cfg, s)} of "
                     f"{s} tokens) drop nothing, the published "
                     f"{cfg.capacity_factor:g} (capacity "
                     f"{moe.capacity(cfg, s)}) would drop {n_drop} of "
                     f"{n_slot} (token, expert) slots in that forward; "
                     f"decode capacity {moe.capacity(cfg, 1)} a "
                     f"one-token group drops none")
        else:
            f32 = forward_f32(params, tokens[rows], cfg)
        f32 = f32[sel, idx]
    f64 = forward_f64(torch, params, tokens[rows], ref_cfg)[sel, idx]
    last = {"scan": first["last"][rows].double(), "forward": f32.double(),
            "f64": f64}
    del first, f32
    torch.cuda.empty_cache()
    dist = {f"{a}-{b}": float((last[a] - last[b]).abs().max())
            for a, b in (("scan", "forward"), ("scan", "f64"),
                         ("forward", "f64"))}
    scale = float(last["f64"].abs().max())
    spread = max(dist.values())
    print(f"[{phase}] {tag} first prefill tick ({int(rows.sum())} slots, "
          f"{int(n_active.sum())} tokens), masked decode scan vs the "
          f"forward (flash): logits max abs differences (of "
          f"{scale:.3e}): " + ", ".join(f"{k} {v:.3e}" for k, v in
                                         dist.items())
          + f"; the float32 spread {spread:.3e} ({spread / scale:.2e} of "
          f"the largest |logit|){drops}")
    check(max(dist["scan-f64"], dist["forward-f64"]) <= DENSE_F64_TOL * scale,
          f"{phase} {tag}: float32 logits {dist} from float64, more than "
          f"{DENSE_F64_TOL} of {scale}")
    return {"engine": eng, "params": params, "cfg": cfg, "requests": requests,
            "outputs": {r.uid: r.output for r in done}, "margins": margins,
            "spread": spread, "n_params": n_params, "ticks": ticks,
            "b7": launched["wkv_fused"]}


def greedy_margins(torch, engine_mod, keep_last=False):
    """Wrap the engine module's step factories so `greedy_generate`'s
    steps record, in call order, the top-2 margin of each row's logits,
    each step's host time through a synchronize, and with ``keep_last``
    the logits.  Returns (the record, a function that restores the
    factories)."""
    rec = {"margins": [], "ms": [], "last": []}
    real = engine_mod._decode_step_for, engine_mod._chunk_step_for

    def wrapped(factory):
        def make(*args):
            step = factory(*args)

            def run(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last, state = step(*a)
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                top = torch.topk(last, 2, dim=-1).values
                rec["margins"].append(float((top[:, 0] - top[:, 1]).min()))
                if keep_last:
                    rec["last"].append(last.clone())
                return last, state
            return run
        return make

    engine_mod._decode_step_for = wrapped(real[0])
    engine_mod._chunk_step_for = wrapped(real[1])

    def restore():
        engine_mod._decode_step_for, engine_mod._chunk_step_for = real

    return rec, restore


def warm_ticks(dev, params, cfg, requests):
    """Serve ``requests()`` once more on a fresh `ServeEngine` (8 slots,
    max_len 512, chunk 64): the median host time of its prefill and of
    its decode ticks, and how many of each."""
    from repro_torch.serving import ServeEngine, drive

    eng = ServeEngine(params, cfg, max_batch=LM_MAX_BATCH,
                      max_len=LM_MAX_LEN, prefill_chunk=LM_CHUNK, device=dev)
    launch = eng._launch
    per = {"prefill": [], "decode": []}

    def timed(active):
        t0 = time.perf_counter()
        nxt, adv = launch(active)
        per["prefill" if int(adv.max()) > 1 else "decode"].append(
            (time.perf_counter() - t0) * 1e3)
        return nxt, adv

    eng._launch = timed
    drive(eng, requests(), on_undrained="raise")
    return {kind: statistics.median(v) for kind, v in per.items()}, \
        {kind: len(v) for kind, v in per.items()}


def dense_path(torch, np, dev, smi):
    """Phase 5i: the dense family on the card, float32, TF32 off.  (a)
    Llama-3.2-1B at full width, 2 of 16 layers: phase 5c's 16 requests through
    `ServeEngine` (masked decode scan), decode against forward, each
    request's tokens against its own `greedy_generate` run, and the
    prefill and decode ticks warm beside the decode step's weight-read
    bound; (b) StableLM-2-1.6B at full width and depth and (c) Qwen3-32B
    and Qwen2-72B at full width, depth cut, 4 requests each, decode
    against forward; (d) ``launch.serve --arch llama3.2-1b --mixed`` in a
    subprocess.  Every model is freed before the next.  Returns what the
    summary reads."""
    import gc
    import os

    from repro_torch.configs import get_config
    from repro_torch.serving import greedy_generate
    from repro_torch.serving import engine as engine_mod

    out = {}
    # (a)
    cfg = get_config(DENSE_ARCH).replace(dtype=torch.float32,
                                         n_layers=DENSE_LAYERS)
    a = served_model(torch, np, dev, cfg, "(a)", LM_REQUESTS,
                     published=get_config(DENSE_ARCH).n_layers)
    rec, restore = greedy_margins(torch, engine_mod)
    margins = rec["margins"]
    same, t0 = 0, time.perf_counter()
    try:
        for req in a["requests"]():
            del margins[:]
            got = greedy_generate(a["params"], cfg, np.asarray([req.prompt]),
                                  LM_NEW_TOKENS, max_len=LM_MAX_LEN)[0]
            got = got.tolist()
            served = a["outputs"][req.uid]
            if got == served:
                same += 1
                continue
            j = next(i for i, (x, y) in enumerate(zip(served, got))
                     if x != y)
            m = min(a["margins"][req.uid][j], margins[j])
            print(f"[5i] (a) request {req.uid}: the engine's tokens differ "
                  f"from greedy_generate's first at output {j} "
                  f"({served[j]} vs {got[j]}), top-2 margin {m:.3e} (the "
                  f"spread {a['spread']:.3e})")
            check(m <= a["spread"], f"5i (a): request {req.uid} differs "
                  f"at output {j}, not a near-tie (margin {m})")
    finally:
        restore()
    print(f"[5i] (a) tokens: {same} of {LM_REQUESTS} requests bit for bit "
          f"the tokens of their own greedy_generate run "
          f"({time.perf_counter() - t0:.2f} s); the smallest top-2 margin "
          f"behind an emitted token "
          f"{min(min(v) for v in a['margins'].values()):.3e}")
    # The engine per tick, warm: the same requests again.
    tick, n_ticks = warm_ticks(dev, a["params"], cfg, a["requests"])
    bound_ms = 4 * a["n_params"] / PEAK_BYTES_PER_S * 1e3
    print(f"[5i] (a) {smi}: LM engine warm (host clock): prefill tick "
          f"{tick['prefill']:.3f} ms (median of {n_ticks['prefill']}, "
          f"{LM_MAX_BATCH} slots x up to {LM_CHUNK} tokens, one decode step "
          f"a token), decode tick {tick['decode']:.3f} ms (median of "
          f"{n_ticks['decode']}); the decode step's weight-read bound "
          f"{bound_ms:.3f} ms ({4 * a['n_params'] / 1e9:.2f} GB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    out["b7"] = a["b7"]
    kinds = [k for k, _ in a["ticks"]]
    out["a"] = {"prefill_ticks": kinds.count("prefill"),
                "decode_ticks": kinds.count("decode"), "same": same,
                "spread": a["spread"], "prefill_ms": tick["prefill"],
                "decode_ms": tick["decode"], "bound_ms": bound_ms}
    del a
    gc.collect()
    torch.cuda.empty_cache()
    # (b), (c)
    for tag, name, layers in (("(b)", "stablelm-1.6b", None),
                              *(("(c)", n, k) for n, k in DENSE_CUT)):
        full = get_config(name).replace(dtype=torch.float32)
        run = full if layers is None else full.replace(n_layers=layers)
        r = served_model(torch, np, dev, run, tag, DENSE_REQUESTS,
                         published=full.n_layers if layers else None)
        out["b7"] += r["b7"]
        out[name] = {"spread": r["spread"], "layers": run.n_layers,
                     "published": full.n_layers,
                     "gb": 4 * r["n_params"] / 1e9}
        del r
        gc.collect()
        torch.cuda.empty_cache()
    # (d) the launcher in a subprocess on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *DENSE_LAUNCHER],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    lines = proc.stdout.strip().splitlines()
    first = next((k for k, ln in enumerate(lines)
                  if ln.startswith("front door: ")), None)
    lines = lines[first:first + 5] if first is not None else []
    launches = {ln.split(":")[0].strip(): ln for ln in lines[2:]}
    check(proc.returncode == 0 and len(lines) == 5 and lines[0].startswith(
        "front door: 8 LM requests (128 tokens) + 8 frames + 2 video "
        "streams") and "on cuda" in lines[0]
          and sorted(launches) == ["lm", "stream", "vision"]
          and all("launches=0 " not in ln for ln in launches.values()),
          f"5i (d): launcher exited {proc.returncode}: {proc.stdout} "
          f"{proc.stderr[-2000:]}")
    print(f"[5i] (d) python -m repro_torch.launch.serve "
          f"{' '.join(DENSE_LAUNCHER)}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in lines:
        print(f"[5i] (d)   {line}")
    return out


def dense_only(torch, np, dev) -> int:
    """``chip_smoke.py --dense``: phase 1, the build of ``p2m_conv.cu``
    (the launcher's vision and stream engines in (d) find it built) and
    phase 5i alone."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    conv.build_p2m_conv()
    print(f"[2] p2m_conv.cu: nvcc {_build.BUILD_INFO['p2m_conv'][0]:.2f} s")
    print(json.dumps(dense_path(torch, np, dev, smi)))
    print(smi)
    return 0


# Phase 5j: the MoE family at published widths, depth cut to fit float32
# in 80 GB beside the rest of the run; RecurrentGemma-9B whole.
MOE_CUT = (("qwen3-moe-30b-a3b", 4), ("mixtral-8x22b", 2))
RGLRU_ARCH = "recurrentgemma-9b"
RGLRU_ROWS = 4  # the first four of phase 5c's prompts, cut to the shortest
MOE_RGLRU_LAUNCHERS = (  # (arguments, should it serve)
    (["--arch", MOE_CUT[0][0], "--smoke"], True),
    (["--arch", RGLRU_ARCH, "--smoke"], False))


def bounds_line(cfg, n_params) -> tuple[float, float, str]:
    """The whole tree's and the active parameters' read at
    ``PEAK_BYTES_PER_S``, ms, and the text that names them."""
    tree_ms = 4 * n_params / PEAK_BYTES_PER_S * 1e3
    est = cfg.param_count_estimate()
    active_ms = 4 * est / PEAK_BYTES_PER_S * 1e3
    return tree_ms, active_ms, (
        f"weight-read bounds: the whole tree {tree_ms:.3f} ms "
        f"({4 * n_params / 1e9:.2f} GB), the active parameters "
        f"(param_count_estimate {est}) {active_ms:.3f} ms, at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")


def rglru_model(torch, np, dev, smi):
    """Phase 5j (c): RecurrentGemma-9B whole (38 layers: 12 groups of
    (rec, rec, attn) and a recurrent tail of 2), float32, random weights
    from ``SEED`` on the card: `greedy_generate` with
    ``prefill_chunk=1`` on one batch of phase 5c's first four prompts
    cut to the shortest, no kernel of the port launched; the token-by-
    token logits at the last prompt position against `rglru.forward` in
    float32 and in float64, each float32 one within ``DENSE_F64_TOL`` of
    the largest |float64 logit|; the warm per-step time beside both
    weight-read bounds."""
    from repro_torch.common.pytree import param_count
    from repro_torch.configs import get_config
    from repro_torch.models import rglru
    from repro_torch.models.families import get_family
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import greedy_generate

    cfg = get_config(RGLRU_ARCH).replace(dtype=torch.float32)
    t0 = time.perf_counter()
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    torch.cuda.synchronize()
    n_params = param_count(params)
    n_groups, rem = rglru._pattern_split(cfg)
    print(f"[5j] (c) {cfg.name}: {cfg.n_layers} layers ({n_groups} groups "
          f"of {'/'.join(cfg.block_pattern)}, a tail of {rem}), d_model "
          f"{cfg.d_model}, d_rnn {cfg.d_rnn}, {cfg.n_heads} heads "
          f"({cfg.n_kv_heads} KV), window {cfg.sliding_window}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters in the "
          f"tree, {cfg.param_count_estimate()} by the reference's estimate, "
          f"{4 * n_params / 1e9:.2f} GB fp32, initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    lengths, requests = lm_traffic(np, cfg.vocab, RGLRU_ROWS)
    p = int(min(lengths))
    prompts = np.asarray([r.prompt[:p] for r in requests()])
    rec, restore = greedy_margins(torch, engine_mod, keep_last=True)
    reset_kernel_counts()
    t0 = time.perf_counter()
    try:
        out = greedy_generate(params, cfg, prompts, LM_NEW_TOKENS,
                              max_len=LM_MAX_LEN, prefill_chunk=1)
        torch.cuda.synchronize()
    finally:
        restore()
    seconds = time.perf_counter() - t0
    launched = kernel_counts()
    check(tuple(out.shape) == (RGLRU_ROWS, LM_NEW_TOKENS)
          and bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"5j (c): greedy_generate gave {tuple(out.shape)}")
    check(len(rec["last"]) == p + LM_NEW_TOKENS,
          f"5j (c): {len(rec['last'])} decode steps, not {p} + "
          f"{LM_NEW_TOKENS}")
    check(not any(launched.values()),
          f"5j (c): the rglru path launched kernels {launched}")
    step_ms = statistics.median(rec["ms"][1:])
    tree_ms, active_ms, bounds = bounds_line(cfg, n_params)
    print(f"[5j] (c) greedy_generate(prefill_chunk=1): {RGLRU_ROWS} rows of "
          f"{p} prompt tokens, {LM_NEW_TOKENS} tokens a row, "
          f"{p + LM_NEW_TOKENS} decode steps in {seconds:.2f} s cold; kernel "
          f"launches {sum(launched.values())} (B7 {launched['wkv_fused']}); "
          f"the smallest top-2 margin {min(rec['margins']):.3e}")
    print(f"[5j] (c) {smi}: decode step {step_ms:.3f} ms (host clock through "
          f"a synchronize, median of {len(rec['ms']) - 1} steps, batch "
          f"{RGLRU_ROWS}); {bounds}")
    tokens = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        f32 = forward_f32(params, tokens, cfg)[:, -1]
    f64 = forward_f64(torch, params, tokens, cfg)[:, -1]
    last = {"decode": rec["last"][p - 1].double(), "forward": f32.double(),
            "f64": f64}
    del rec
    dist = {f"{a}-{b}": float((last[a] - last[b]).abs().max())
            for a, b in (("decode", "forward"), ("decode", "f64"),
                         ("forward", "f64"))}
    scale = float(last["f64"].abs().max())
    spread = max(dist.values())
    print(f"[5j] (c) the last prompt position, token-by-token decode vs "
          f"rglru.forward: logits max abs differences (of {scale:.3e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
          + f"; the float32 spread {spread:.3e} ({spread / scale:.2e} of "
          f"the largest |logit|)")
    check(max(dist["decode-f64"], dist["forward-f64"])
          <= DENSE_F64_TOL * scale,
          f"5j (c): float32 logits {dist} from float64, more than "
          f"{DENSE_F64_TOL} of {scale}")
    return {"n_params": n_params, "layers": cfg.n_layers, "spread": spread,
            "step_ms": step_ms, "tree_bound_ms": tree_ms,
            "active_bound_ms": active_ms, "b7": launched["wkv_fused"]}


def moe_rglru_path(torch, np, dev, smi):
    """Phase 5j: the MoE and RG-LRU families on the card, float32, TF32
    off.  (a) Qwen3-30B-A3B and (b) Mixtral-8x22B at published widths,
    depth cut, 4 requests each through `ServeEngine` (the masked decode
    scan), decode against a no-drop forward in float32 and float64, warm
    ticks beside both weight-read bounds; (c) RecurrentGemma-9B whole
    through `greedy_generate(prefill_chunk=1)`; (d) the refusals:
    `ServeEngine` and `SessionEngine` on RecurrentGemma at SMOKE raise
    the reference's ValueErrors before allocating anything, and the
    launcher serves ``--arch qwen3-moe-30b-a3b --smoke`` and refuses
    ``--arch recurrentgemma-9b --smoke``.  Every model is freed before
    the next.  Returns what the summary reads."""
    import gc
    import os

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.families import get_family
    from repro_torch.serving import ServeEngine, SessionEngine

    out = {"b7": {}}
    for tag, (name, layers) in zip(("(a)", "(b)"), MOE_CUT):
        full = get_config(name).replace(dtype=torch.float32)
        run = full.replace(n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        r = served_model(torch, np, dev, run, tag, DENSE_REQUESTS,
                         published=full.n_layers, phase="5j")
        tick, n_ticks = warm_ticks(dev, r["params"], run,
                                   r["requests"])
        tree_ms, active_ms, bounds = bounds_line(run, r["n_params"])
        print(f"[5j] {tag} {smi}: {name} engine warm (host clock): prefill "
              f"tick {tick['prefill']:.3f} ms (median of "
              f"{n_ticks['prefill']}), decode tick {tick['decode']:.3f} ms "
              f"(median of {n_ticks['decode']}); the decode step's {bounds}; "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"allocated")
        out["b7"][name] = r["b7"]
        out[name] = {"layers": run.n_layers, "published": full.n_layers,
                     "n_params": r["n_params"],
                     "gb": 4 * r["n_params"] / 1e9, "spread": r["spread"],
                     "prefill_ms": tick["prefill"],
                     "decode_ms": tick["decode"], "tree_bound_ms": tree_ms,
                     "active_bound_ms": active_ms}
        del r
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = rglru_model(torch, np, dev, smi)
    print(f"[5j] (c) peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"allocated")
    out["b7"][RGLRU_ARCH] = c.pop("b7")
    out[RGLRU_ARCH] = c
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the refusals on the card, at SMOKE
    cfg = get_smoke_config(RGLRU_ARCH).replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for engine, match in ((ServeEngine, "cache_batch"),
                          (SessionEngine, "prefill")):
        try:
            engine(params, cfg, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                   prefill_chunk=LM_CHUNK, device=dev)
        except ValueError as exc:
            refusal = str(exc)
        else:
            refusal = None
        check(refusal is not None and match in refusal
              and torch.cuda.memory_allocated() == before,
              f"5j (d): {engine.__name__} on {cfg.name}: {refusal}")
        print(f"[5j] (d) {engine.__name__} on {cfg.name} ({dev}): "
              f"ValueError before allocating: {refusal[:110]}...")
    del params
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def launch(argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(MOE_RGLRU_LAUNCHERS)) as pool:
        runs = list(pool.map(launch, [a for a, _ in MOE_RGLRU_LAUNCHERS]))
    for (argv, serves), (proc, seconds) in zip(MOE_RGLRU_LAUNCHERS, runs):
        lines = proc.stdout.strip().splitlines()
        if serves:
            ok = (proc.returncode == 0 and lines
                  and lines[0].startswith("served ") and "on cuda" in lines[0])
            said = lines[0] if lines else ""
        else:
            said = proc.stderr.strip().splitlines()[-1][:160] \
                if proc.stderr.strip() else ""
            ok = proc.returncode != 0 and "cache_batch" in proc.stderr
        check(bool(ok), f"5j (d): launcher {' '.join(argv)} exited "
              f"{proc.returncode}: {proc.stdout[-2000:]} "
              f"{proc.stderr[-2000:]}")
        print(f"[5j] (d) python -m repro_torch.launch.serve {' '.join(argv)}: "
              f"exit {proc.returncode} in {seconds:.1f} s: {said}")
    return out


def moe_rglru_only(torch, np, dev) -> int:
    """``chip_smoke.py --moe-rglru``: phase 1 and phase 5j alone (its
    paths and launchers run no kernel of the port, so nothing is
    built)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(json.dumps(moe_rglru_path(torch, np, dev, smi)))
    print(smi)
    return 0


# Phase 5k: the P²M frontend feeding Llama-3.2-Vision-11B whole, and
# Whisper-tiny whole (float32, TF32 off, random weights from a seed).
VLM_ARCH = "llama-3.2-vision-11b"
WHISPER_ARCH = "whisper-tiny"
MM_FRAMES = 4  # (a), (b): one 560² frame a prompt
MM_PROMPT = 32  # (b): phase 5c's first four prompts, cut to 32 tokens
MM_NEW_TOKENS = 16  # (b): greedy tokens after the prompt
MM_TRAIN_FRAMES = 8  # (d)
WHISPER_ROWS = 8  # (c): stub source frames at max_source_positions
WHISPER_STEPS = 64  # (c): teacher-forced decode steps
MM_EMB_TOL = 1e-5  # (a): tokens whose stem counts all agree, of max |emb|
MM_GRAD_TOL = 1e-3  # (d): end-to-end gradients, of each leaf's max |value|
MM_LAUNCHERS = (["--arch", VLM_ARCH, "--smoke"],
                ["--arch", WHISPER_ARCH, "--smoke"])
MM_REFUSAL = "pure-text families"  # the reference's launcher's message


def conv_cotangent_check(torch, label, images, w, g_raw, cfg, model):
    """The conv's backward on a given cotangent of its raw output: B3 (and
    the col2im) and B4 through `P2MConvFunction` against autograd through
    the plain conv, d/d images and d/d w each within 1e-4 of its largest
    value (phase 7 (b), 5k (d))."""
    from repro_torch.core import p2m_conv as core

    got = {}
    for impl in ("cuda", "plain"):
        im = images.detach().requires_grad_(True)
        ww = w.detach().clone().requires_grad_(True)
        raw = core._conv_raw(im, ww, cfg, model, impl)
        got[impl] = torch.autograd.grad(raw, [im, ww], g_raw)
    for i, name in enumerate(("images (B3, col2im)", "w (B4)")):
        a, b = got["cuda"][i], got["plain"][i]
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        print(f"{label} conv backward on the step's cotangent, d/d {name}: "
              f"{err:.3e} of {scale:.3e}")
        check(err <= 1e-4 * scale, f"{label}: conv gradient for {name} "
              f"differs by {err}, more than 1e-4 of {scale}")


def logits_vs_f64(tag, runs, f64, vocab, tol=DENSE_F64_TOL):
    """Each float32 run's logits (name -> tensor, the shape of ``f64``) and
    their differences, over the real vocabulary: every run within ``tol``
    of the largest |float64 logit|.  Returns (the float32 spread, the
    scale)."""
    f64 = f64[..., :vocab]
    runs = {k: v[..., :vocab].double() for k, v in runs.items()}
    names = list(runs)
    dist = {f"{a}-f64": float((runs[a] - f64).abs().max()) for a in names}
    dist.update({f"{a}-{b}": float((runs[a] - runs[b]).abs().max())
                 for i, a in enumerate(names) for b in names[i + 1:]})
    scale = float(f64.abs().max())
    spread = max(dist.values())
    print(f"[5k] {tag}: logits max abs differences (of {scale:.3e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
          + f"; the float32 spread {spread:.3e} ({spread / scale:.2e} of the "
          f"largest |logit|)")
    check(all(dist[f"{a}-f64"] <= tol * scale for a in names),
          f"5k {tag}: float32 logits {dist} from float64, more than {tol} "
          f"of {scale}")
    return spread, scale


def vlm_forward_f64(torch, params, tokens, image_embeds, cfg):
    """`vlm.forward` in float64 on the float32 ``params``, one group's
    weights (its self layers and its cross block) converted at a time,
    with the embedding rows and the head; the casts the model makes to
    float32 stay (norms, attention scores and softmax, the logits)."""
    from repro_torch.models import vlm
    from repro_torch.models.layers import lm_head
    from repro_torch.tree import tree_map

    cfg64 = cfg.replace(dtype=torch.float64)
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = params["embed"]["table"][tokens].double()
    img = image_embeds.double()
    n_groups, _ = vlm._n_groups(cfg)
    with torch.no_grad():
        for g in range(n_groups):
            sp = tree_map(lambda a: a[g].double(), params["self"])
            cp = tree_map(lambda a: a[g].double(), params["cross"])
            x = vlm._group(x, sp, cp, img, pos, cfg64)
            del sp, cp
        emb = {"final_norm": tree_map(lambda a: a.double(),
                                      params["embed"]["final_norm"]),
               "head": params["embed"]["head"].double()}
        return lm_head(emb, x, cfg64)


def teacher_decode(torch, decode_step, params, state, tokens, cfg,
                   new_tokens=0):
    """``decode_step`` over ``tokens`` (B, S) one position at a time, then
    ``new_tokens`` greedy steps: (the logits at each prompt position (B,
    S, V), the greedy tokens (B, new_tokens), each step's host ms through
    a synchronize)."""
    b, s = tokens.shape
    logits, out, ms = [], [], []
    nxt = tokens[:, :1]
    with torch.no_grad():
        for t in range(s + new_tokens):
            if t < s:
                nxt = tokens[:, t:t + 1]
            pos = torch.full((b,), t, dtype=torch.int32,
                             device=tokens.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, state = decode_step(params, state, nxt, pos, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if t < s:
                logits.append(lg[:, 0])
            nxt = lg[:, :, :cfg.vocab].argmax(-1)
            if t >= s - 1 and len(out) < new_tokens:
                out.append(nxt)
    gen = torch.cat(out, dim=1) if out else tokens[:, :0]
    return torch.stack(logits, dim=1), gen, ms


def frontend_deploy(torch, np, dev, fcfg, fparams, fstate):
    """5k (a): 4 SyntheticVWW frames through the deploy-folded, 8-bit
    frontend (B1 or B2, as the tuner picks), held to ``impl="plain"`` by
    the count rule on the stem, then on every token whose counts all
    agree.  Returns (the embeddings, the B1/B2 launches)."""
    from repro_torch.core import bn_fold, frontend
    from repro_torch.core import p2m_conv as core
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

    ccfg = fcfg.conv
    deploy = core.premix_deploy(bn_fold.deploy_params(
        fparams["conv"], fstate["conv"], ccfg), ccfg)
    frames = torch.from_numpy(SyntheticVWW(
        image_size=fcfg.image_size, batch=MM_FRAMES, seed=SEED
    ).batch_at(0)["images"]).to(dev)
    blocks = core.deploy_conv_blocks(frames, ccfg, mode="quant")  # tuned
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        emb, same = frontend.apply_p2m_frontend(fparams, fstate, frames,
                                                fcfg, deploy=deploy)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = kernel_counts()
    stem = {k: launched[k] for k in ("p2m_conv_fused",
                                     "p2m_conv_fused_pipelined")}
    check(sum(stem.values()) == 1 and sum(launched.values()) == 1
          and same is fstate,
          f"5k (a): the frontend launched {launched}, not one B1 or B2")
    check(tuple(emb.shape) == (MM_FRAMES, fcfg.tokens, fcfg.d_model)
          and bool(torch.isfinite(emb).all()),
          f"5k (a): embeddings {tuple(emb.shape)}")
    print(f"[5k] (a) P2MFrontendConfig(): {fcfg.image_size}² frames, k = s "
          f"= {ccfg.kernel}, pool {fcfg.pool}: {fcfg.tokens} tokens of "
          f"{fcfg.token_feature_dim} features → d_model {fcfg.d_model}; "
          f"the tuner's pick at ({MM_FRAMES}, {fcfg.image_size}, "
          f"{fcfg.image_size}, 3) quant (block_h, block_n, depth) "
          f"{tuple(blocks)}: {'B2' if blocks[2] >= 2 else 'B1'}; launches "
          f"B1 {stem['p2m_conv_fused']}, B2 "
          f"{stem['p2m_conv_fused_pipelined']}; {seconds * 1e3:.1f} ms "
          f"warm tuner, cold frontend (host clock)")
    # against the plain stem, on the same frames (not counted)
    with torch.no_grad():
        plain, _ = frontend.apply_p2m_frontend(fparams, fstate, frames, fcfg,
                                               deploy=deploy, impl="plain")
        fmap = core.apply_p2m_conv_deploy(deploy, frames, ccfg)
        fmap_p = core.apply_p2m_conv_deploy(deploy, frames, ccfg,
                                            impl="plain")
        raw_p = conv.p2m_conv_raw_plain(
            frames, deploy["w"], kernel=ccfg.kernel, stride=ccfg.stride,
            coeffs=_coeff_tuple(default_pixel_model())).reshape(fmap.shape)
    reset_kernel_counts()
    v_lsb = ccfg.adc.v_lsb
    rep = conv.quant_disagreement(fmap, fmap_p, raw_p, v_lsb)
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"],
          f"5k (a): the stem's counts against the plain stem's: {rep}")
    agree = (torch.round(fmap / v_lsb) == torch.round(fmap_p / v_lsb))
    tok_ok = frontend.pool_tokens(agree.float(), fcfg.pool).min(
        dim=-1).values.bool()
    err = float((emb - plain)[tok_ok].abs().max())
    scale = float(plain.abs().max())
    nonzero = float((fmap > 0).float().mean())
    print(f"[5k] (a) stem vs the plain stem: {rep['n_diff']} of "
          f"{fmap.numel()} counts differ (at half counts: "
          f"{rep['all_near_half']}), {nonzero:.3f} of the counts nonzero; "
          f"embeddings vs plain {err:.3e} of {scale:.3e} on "
          f"{int(tok_ok.sum())} of {tok_ok.numel()} tokens whose counts all "
          f"agree")
    check(err <= MM_EMB_TOL * scale and int(tok_ok.sum())
          >= tok_ok.numel() - rep["n_diff"],
          f"5k (a): embeddings differ from the plain stem's by {err} of "
          f"{scale}")
    return emb, stem


def vlm_decode_parts(torch, params, state, tokens, cfg, step_ms):
    """5k (b): the VLM decode step's parts, each alone by CUDA events
    (median of 10, L2 flushed) at the decode shape: a self layer's
    attention (norm, projections, the cached attention) and its MLP, a
    cross block on the cached image K/V, and the head.  Printed beside
    the step and each part's weight read."""
    from repro_torch.models import vlm
    from repro_torch.models.layers import (
        apply_mlp,
        apply_norm,
        cached_attention,
        lm_head,
    )
    from repro_torch.tree import tree_map

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=tokens.device)
    lp = tree_map(lambda a: a[0, 0], params["self"])
    cp = tree_map(lambda a: a[0], params["cross"])
    pos = torch.full((tokens.shape[0],), tokens.shape[1] - 1,
                     dtype=torch.int32, device=tokens.device)
    kv = (state["cross"]["k"][0], state["cross"]["v"][0])
    with torch.no_grad():
        x = params["embed"]["table"][tokens[:, :1]]
        fns = {
            "self attention": lambda: cached_attention(
                lp["attn"], apply_norm(lp["attn_norm"], x, cfg),
                state["self"]["k"][0], state["self"]["v"][0], pos, cfg),
            "self MLP": lambda: apply_mlp(
                lp["mlp"], apply_norm(lp["mlp_norm"], x, cfg)),
            "cross block": lambda: vlm._cross_block(cp, x, None, cfg, kv=kv),
            "head": lambda: lm_head(params["embed"], x, cfg)}
        ms = {k: cuda_ms(torch, fn, flush, reps=10) for k, fn in fns.items()}
    del flush
    n_groups, n_self = vlm._n_groups(cfg)
    times = {"self attention": n_groups * n_self, "self MLP":
             n_groups * n_self, "cross block": n_groups, "head": 1}
    nbytes = {"self attention": 4 * sum(lp["attn"][k].numel() for k in
                                        ("wq", "wk", "wv", "wo")),
              "self MLP": 4 * sum(a.numel() for a in lp["mlp"].values()),
              "cross block": 4 * (cp["attn"]["wq"].numel()
                                  + cp["attn"]["wo"].numel()
                                  + sum(a.numel() for a in
                                        cp["mlp"].values())),
              "head": 4 * params["embed"]["head"].numel()}
    total = sum(ms[k] * times[k] for k in ms)
    print(f"[5k] (b) the decode step's parts (CUDA events, median of 10, L2 "
          f"flushed, batch {tokens.shape[0]}): "
          + "; ".join(f"{k} {ms[k]:.4f} ms x {times[k]} (its weight read "
                      f"{nbytes[k] / PEAK_BYTES_PER_S * 1e3:.4f})"
                      for k in ms)
          + f"; sum {total:.3f} of the step's {step_ms:.3f} ms (the rest: "
          f"the host between launches)")
    return {k: ms[k] for k in ms}


def vlm_model(torch, np, dev, smi, emb):
    """5k (b): Llama-3.2-Vision-11B whole on ``emb``, the frontend's
    tokens, and on the config's own stub of n_image_tokens embeddings:
    forward, `prefill_cross_kv`, decode over the prompt and greedy tokens,
    each float32 run within ``DENSE_F64_TOL`` of the largest |float64
    logit|; the image moves the logits by more than the float32 spread;
    no kernel of the port launches."""
    from repro_torch.common.pytree import param_count
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_batch_transform
    from repro_torch.models import vlm
    from repro_torch.models.families import get_family

    cfg = get_config(VLM_ARCH).replace(dtype=torch.float32)
    fam = get_family(cfg)
    t0 = time.perf_counter()
    params, _ = fam.init(torch.Generator(dev).manual_seed(SEED), cfg)
    # nonzero gates (zero at init, where the image path adds nothing)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    for gate in ("gate_attn", "gate_mlp"):
        params["cross"][gate] = 0.5 + 0.5 * torch.rand(
            params["cross"][gate].shape, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    n_groups, n_self = vlm._n_groups(cfg)
    print(f"[5k] (b) {cfg.name}: {cfg.n_layers} layers ({n_groups} groups "
          f"of {n_self} self layers + 1 gated cross layer), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} KV), d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters in the "
          f"tree, {cfg.param_count_estimate()} by the reference's estimate, "
          f"{4 * n_params / 1e9:.2f} GB fp32, initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    print("[5k] (b) gates drawn from the seed (tanh of each scales its "
          "branch): gate_attn "
          + ", ".join(f"{float(g):.4f}" for g in params["cross"]["gate_attn"])
          + "; gate_mlp "
          + ", ".join(f"{float(g):.4f}" for g in params["cross"]["gate_mlp"]))
    _, requests = lm_traffic(np, cfg.vocab, MM_FRAMES)
    tokens = torch.tensor([r.prompt[:MM_PROMPT] for r in requests()],
                          device=dev)
    stub = torch.from_numpy(build_batch_transform(cfg, MM_FRAMES, MM_PROMPT)(
        {})["image_embeds"]).to(dev)
    out = {"n_params": n_params, "gb": 4 * n_params / 1e9}
    reset_kernel_counts()
    for tag, img in (("P²M tokens", emb), ("stub embeddings", stub)):
        state, _ = fam.init_decode_state(cfg, MM_FRAMES,
                                         MM_PROMPT + MM_NEW_TOKENS,
                                         device=dev)
        state["cross"] = vlm.prefill_cross_kv(params, img, cfg)
        with torch.no_grad():
            f32 = vlm.forward(params, tokens, img, cfg)[0]
        dec, gen_toks, ms = teacher_decode(torch, vlm.decode_step, params,
                                           state, tokens, cfg, MM_NEW_TOKENS)
        f64 = vlm_forward_f64(torch, params, tokens, img, cfg)
        spread, scale = logits_vs_f64(
            f"(b) {tag} ({img.shape[1]} image tokens), all {MM_PROMPT} "
            f"prompt positions, decode vs vlm.forward",
            {"decode": dec, "forward": f32}, f64, cfg.vocab)
        check(tuple(gen_toks.shape) == (MM_FRAMES, MM_NEW_TOKENS)
              and bool(((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()),
              f"5k (b): greedy tokens {tuple(gen_toks.shape)}")
        step_ms = statistics.median(ms[2:])
        print(f"[5k] (b) {tag}: decode {MM_PROMPT} prompt + {MM_NEW_TOKENS} "
              f"greedy tokens a row ({MM_FRAMES} rows), {len(ms)} steps; "
              f"{smi}: decode step {step_ms:.3f} ms warm (host clock through "
              f"a synchronize, median of {len(ms) - 2}), first {ms[0]:.1f} "
              f"ms")
        if tag == "P²M tokens":
            out["parts"] = vlm_decode_parts(torch, params, state, tokens,
                                            cfg, step_ms)
            # the image matters: another frame's tokens a row
            with torch.no_grad():
                other = vlm.forward(params, tokens, img.roll(1, 0), cfg)[0]
            moved = float((other - f32).abs().max())
            print(f"[5k] (b) another frame's tokens a row move the logits by "
                  f"{moved:.3e} ({moved / scale:.2e} of the largest "
                  f"|logit|), against the float32 spread {spread:.3e}")
            check(moved > spread, f"5k (b): the image moved the logits by "
                  f"{moved}, not more than the spread {spread}")
            out.update(step_ms=step_ms, spread=spread, moved=moved,
                       tokens=gen_toks[0].tolist())
        else:
            out.update(stub_step_ms=step_ms, stub_spread=spread)
        del f32, f64, dec, state
    launched = kernel_counts()
    check(not any(launched.values()),
          f"5k (b): the VLM path launched kernels {launched}")
    tree_ms, _, bounds = bounds_line(cfg, n_params)
    out.update(tree_bound_ms=tree_ms, b7=launched["wkv_fused"])
    print(f"[5k] (b) {smi}: decode step {out['step_ms']:.3f} ms beside the "
          f"{bounds}; kernel launches {sum(launched.values())}")
    return out


def whisper_model(torch, np, dev, smi):
    """5k (c): Whisper-tiny whole: `prefill_cross_kv` on 8 rows of stub
    source frames at max_source_positions, then ``WHISPER_STEPS`` teacher-
    forced decode steps against `whisper.forward` in float32 and in
    float64 (the whole tree converted); no kernel of the port launches."""
    from repro_torch.common.pytree import param_count
    from repro_torch.configs import get_config
    from repro_torch.models import whisper
    from repro_torch.models.families import get_family
    from repro_torch.tree import tree_map

    cfg = get_config(WHISPER_ARCH).replace(dtype=torch.float32)
    fam = get_family(cfg)
    params, _ = fam.init(torch.Generator(dev).manual_seed(SEED), cfg)
    n_params = param_count(params)
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    src = torch.randn((WHISPER_ROWS, cfg.max_source_positions, cfg.d_model),
                      generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (WHISPER_ROWS, WHISPER_STEPS),
                           generator=gen, device=dev)
    print(f"[5k] (c) {cfg.name}: {cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
          f"{cfg.padded_vocab}); {n_params} parameters, "
          f"{cfg.param_count_estimate()} by the reference's estimate, "
          f"{4 * n_params / 1e9:.3f} GB fp32; {WHISPER_ROWS} rows of "
          f"{cfg.max_source_positions} stub source frames")
    reset_kernel_counts()
    state, _ = fam.init_decode_state(cfg, WHISPER_ROWS, WHISPER_STEPS,
                                     device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        state["cross"] = whisper.prefill_cross_kv(params, src, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    dec, _, ms = teacher_decode(torch, whisper.decode_step, params, state,
                                tokens, cfg)
    with torch.no_grad():
        f32 = whisper.forward(params, src, tokens, cfg)[0]
        p64 = tree_map(lambda a: a.double(), params)
        f64 = whisper.forward(p64, src.double(), tokens,
                              cfg.replace(dtype=torch.float64))[0]
    launched = kernel_counts()
    check(not any(launched.values()),
          f"5k (c): the whisper path launched kernels {launched}")
    spread, _ = logits_vs_f64(
        f"(c) {WHISPER_STEPS} teacher-forced decode steps vs "
        f"whisper.forward", {"decode": dec, "forward": f32}, f64, cfg.vocab)
    step_ms = statistics.median(ms[2:])
    print(f"[5k] (c) {smi}: prefill_cross_kv (encoder + {cfg.n_layers} "
          f"cross K/V) {prefill_ms:.2f} ms cold; decode step {step_ms:.3f} ms "
          f"(host clock through a synchronize, median of {len(ms) - 2}, "
          f"batch {WHISPER_ROWS}); the weight read "
          f"{4 * n_params / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
    return {"n_params": n_params, "spread": spread, "step_ms": step_ms,
            "prefill_ms": prefill_ms, "b7": launched["wkv_fused"]}


def frontend_train(torch, np, dev, fcfg, fparams, fstate):
    """5k (d): the frontend's train form on 8 frames (BN on batch
    statistics): the gradient of a fixed scalar of the embeddings with
    respect to θ, the BN affine and ``proj`` through `P2MConvFunction`
    (B1 or B2 forward, B3 and B4 once) against the same run with
    ``impl="plain"``, and the conv's backward on the run's own cotangent
    within 1e-4.  Returns the launches."""
    from repro_torch.core import frontend
    from repro_torch.core import p2m_conv as core
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.data import SyntheticVWW

    frames = torch.from_numpy(SyntheticVWW(
        image_size=fcfg.image_size, batch=MM_TRAIN_FRAMES, seed=SEED + 1
    ).batch_at(0)["images"]).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    probe = torch.randn((MM_TRAIN_FRAMES, fcfg.tokens, fcfg.d_model),
                        generator=gen, device=dev)
    real_conv_raw = core._conv_raw

    def run(impl):
        seen = {}

        def conv_raw(*args):  # keep the conv's output and its cotangent
            raw = real_conv_raw(*args)
            seen["raw"] = raw
            raw.register_hook(lambda g: seen.__setitem__("g_raw", g))
            return raw

        live = {"conv": {k: v.detach().clone().requires_grad_(True)
                         for k, v in fparams["conv"].items()},
                "proj": fparams["proj"].detach().clone().requires_grad_(True)}
        core._conv_raw = conv_raw
        try:
            emb, new = frontend.apply_p2m_frontend(live, fstate, frames, fcfg,
                                                   train=True, impl=impl)
            loss = (emb * probe).sum()
            leaves = {**live["conv"], "proj": live["proj"]}
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        finally:
            core._conv_raw = real_conv_raw
        torch.cuda.synchronize()
        return {"loss": float(loss.detach()), "emb": emb.detach(),
                "state": new["conv"], "grads": grads, "g_raw": seen["g_raw"]}

    torch.cuda.synchronize()
    reset_kernel_counts()
    cuda = run(None)
    launched = kernel_counts()
    plain = run("plain")
    reset_kernel_counts()
    stem = launched["p2m_conv_fused"] + launched["p2m_conv_fused_pipelined"]
    check(stem == 1 and launched["p2m_bwd_dx"] == 1
          and launched["p2m_bwd_dw"] == 1
          and sum(launched.values()) == 3,
          f"5k (d): the train form launched {launched}, not B1 or B2, B3 "
          f"and B4 once each")
    err_emb = float((cuda["emb"] - plain["emb"]).abs().max())
    scale_emb = float(plain["emb"].abs().max())
    print(f"[5k] (d) train form on {MM_TRAIN_FRAMES} frames (BN on batch "
          f"statistics): launches {launched}; scalar {cuda['loss']:.6e} vs "
          f"plain {plain['loss']:.6e}; embeddings {err_emb:.3e} of "
          f"{scale_emb:.3e}; new BN state "
          + ", ".join(f"{k} {float((cuda['state'][k] - plain['state'][k]).abs().max()):.3e}"
                      for k in cuda["state"]))
    check(err_emb <= MM_EMB_TOL * scale_emb
          and all(torch.allclose(cuda["state"][k], plain["state"][k],
                                 rtol=MM_EMB_TOL, atol=0)
                  for k in cuda["state"]),
          f"5k (d): train-form embeddings {err_emb} of {scale_emb}, or the "
          f"BN state, differ from plain")
    rel = {}
    for k, g in plain["grads"].items():
        err = float((cuda["grads"][k] - g).abs().max())
        rel[k] = err / float(g.abs().max())
        print(f"[5k] (d) d/d {k}: {err:.3e} of {float(g.abs().max()):.3e}")
    check(max(rel.values()) <= MM_GRAD_TOL,
          f"5k (d): gradients differ from the plain run's: {rel}")
    conv_cotangent_check(
        torch, "[5k] (d)", frames,
        core._flat_weights(fparams["conv"]["theta"], fcfg.conv),
        cuda["g_raw"], fcfg.conv, default_pixel_model())
    reset_kernel_counts()
    return launched


def multimodal_path(torch, np, dev, smi):
    """Phase 5k: (a) the P²M frontend at the reference's default config on
    4 frames, deploy form, held to the plain stem; (b) Llama-3.2-Vision-11B
    whole on its tokens and on the stub; (c) Whisper-tiny whole; (d) the
    frontend's train form and its gradients through B3/B4; (e) the
    launcher's and `SessionEngine`'s refusals.  The earlier phases' models
    are freed first.  Returns what the summary and the kernel line read."""
    import gc
    import os

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import frontend
    from repro_torch.models.families import get_family
    from repro_torch.serving import SessionEngine

    gc.collect()
    torch.cuda.empty_cache()
    fcfg = frontend.P2MFrontendConfig()
    fparams = frontend.init_p2m_frontend(torch.Generator().manual_seed(SEED),
                                         fcfg, device=dev)
    fstate = frontend.init_p2m_frontend_state(fcfg, device=dev)
    emb, deploy_launches = frontend_deploy(torch, np, dev, fcfg, fparams,
                                           fstate)
    torch.cuda.reset_peak_memory_stats()
    out = {"vlm": vlm_model(torch, np, dev, smi, emb)}
    print(f"[5k] (b) peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"allocated")
    gc.collect()
    torch.cuda.empty_cache()
    out["encdec"] = whisper_model(torch, np, dev, smi)
    train_launches = frontend_train(torch, np, dev, fcfg, fparams, fstate)
    out["launches"] = {
        k: deploy_launches.get(k, 0) + train_launches[k]
        for k in ("p2m_conv_fused", "p2m_conv_fused_pipelined",
                  "p2m_bwd_dx", "p2m_bwd_dw")}
    # (e) the refusals on the card, at SMOKE
    cfg = get_smoke_config(VLM_ARCH).replace(dtype=torch.float32)
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        SessionEngine(params, cfg, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                      device=dev)
    except ValueError as exc:
        refusal = str(exc)
    else:
        refusal = None
    check(refusal is not None and "prefill" in refusal
          and torch.cuda.memory_allocated() == before,
          f"5k (e): SessionEngine on {cfg.name}: {refusal}")
    print(f"[5k] (e) SessionEngine on {cfg.name} ({dev}): ValueError before "
          f"allocating: {refusal[:110]}...")
    del params
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def launch(argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(MM_LAUNCHERS)) as pool:
        runs = list(pool.map(launch, MM_LAUNCHERS))
    for argv, (proc, seconds) in zip(MM_LAUNCHERS, runs):
        said = proc.stderr.strip().splitlines()[-1][:160] \
            if proc.stderr.strip() else ""
        check(proc.returncode != 0 and MM_REFUSAL in proc.stderr,
              f"5k (e): launcher {' '.join(argv)} exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        print(f"[5k] (e) python -m repro_torch.launch.serve {' '.join(argv)}: "
              f"exit {proc.returncode} in {seconds:.1f} s: {said}")
    return out


def multimodal_only(torch, np, dev) -> int:
    """``chip_smoke.py --multimodal``: phase 1, the builds of
    ``p2m_conv.cu`` and ``p2m_bwd.cu`` (together) and phase 5k alone."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import backward, conv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(backward.build_p2m_bwd)]:
            job.result()
    for name in ("p2m_conv", "p2m_bwd"):
        print(f"[2] {name}.cu: nvcc {_build.BUILD_INFO[name][0]:.2f} s")
    print(json.dumps(multimodal_path(torch, np, dev, smi)))
    print(smi)
    return 0


def conv2d_yardstick(torch, images, wrows, k, s):
    """One cuDNN conv over the power stack [x, x², x³] (NCHW) with the
    premixed weights, which computes the fused conv's raw accumulation:
    returns it as a call, its inputs built once."""
    c = images.shape[3]
    dx = wrows.shape[1] // (k * c)
    xs = images.permute(0, 3, 1, 2)
    stack = torch.cat([xs, xs * xs, xs * xs * xs][:dx], dim=1).contiguous()
    wlib = (wrows.reshape(k, dx, k, c, -1).permute(4, 1, 3, 0, 2)
            .reshape(-1, dx * c, k, k).contiguous())
    return lambda: torch.nn.functional.conv2d(stack, wlib, stride=s)


def conv_bound(images, wrows, shift, k) -> tuple[float, str]:
    """The least time (ms) of one fused conv at stride = kernel = ``k``:
    each image, weight and shift byte read once, each output written
    once."""
    b, h, w, _ = images.shape
    n = wrows.shape[2]
    m = b * ((h - k) // k + 1) * ((w - k) // k + 1)
    nbytes = 4 * (images.numel() + wrows.numel() + shift.numel() + m * n)
    return bound(nbytes, 2 * m * k * wrows.shape[1] * n)


def time_b2_shape(torch, flush, inputs, qkw, block_hs):
    """B2 at depths 2 and 3 x ``block_hs`` in turns with B1 (B1, the B2s,
    B1) on one shape, each by `cuda_ms`; the launch counters restored.
    Returns ({(block_h, depth): ms}, [B1 before, B1 after])."""
    from repro_torch.kernels.p2m_conv import conv

    x, wr, sh = inputs
    counted = (conv.p2m_conv_fused.launches,
               conv.p2m_conv_fused.launches_pipelined)
    b1 = [cuda_ms(torch, lambda: conv.p2m_conv_fused(x, wr, sh, **qkw),
                  flush)]
    times = {}
    for depth in (2, 3):
        for bh in block_hs:
            times[(bh, depth)] = cuda_ms(torch, lambda: conv.p2m_conv_fused(
                x, wr, sh, block_h=bh, pipeline_depth=depth, **qkw), flush)
    b1.append(cuda_ms(torch, lambda: conv.p2m_conv_fused(x, wr, sh, **qkw),
                      flush))
    (conv.p2m_conv_fused.launches,
     conv.p2m_conv_fused.launches_pipelined) = counted
    return times, b1


def b2_shapes(torch, np, dev, serve_in):
    """Phase 9's B2 shapes: name -> (inputs, mode, tuner signature name):
    the serving batch (quant), its first 4 images as the stream's (quant)
    and 32 random images as the training batch (raw, the train stem's
    mode), all with the serving stem's weights."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH

    paper_imgs, wrows, shift = serve_in
    size = CONFIG.image_size
    rng = np.random.default_rng(SEED + 35)
    train_imgs = torch.from_numpy(rng.random((TRAIN_BATCH, size, size, 3),
                                             np.float32)).to(dev)
    return {
        f"serving {len(paper_imgs)}x{size}²": (serve_in, "quant", "serving"),
        f"stream 4x{size}²": ((paper_imgs[:4].contiguous(), wrows, shift),
                              "quant", "stream"),
        f"training {TRAIN_BATCH}x{size}²": ((train_imgs, wrows, shift), "raw",
                                            "training"),
    }


def time_pipelined(torch, np, dev, flush, serve_in, adc, tuned, b1_row):
    """Phase 9, B2: at the serving, stream and training shapes, B2 at
    depths 2 and 3 with block_h 1, 2, 4 and the tuned block_h, in turns
    with B1 (B1, B2s, B1), each with its launch (pixels a thread, threads
    and blocks, registers and local bytes a thread, blocks an SM), and one
    read of the images (`amax`, each byte read once, nothing written)
    and the library yardstick (`conv2d_yardstick`) under the same timing;
    the served kernel spills nothing.  Returns B2's row of the kernels line
    (its ms at the serving shape's fastest setting, beside B1's bound,
    plain and library rows), without launches and error."""
    from repro_torch.kernels.p2m_conv import conv

    by_shape = {}
    for name, ((x, wr, sh), mode, sig) in b2_shapes(torch, np, dev,
                                                    serve_in).items():
        qkw = dict(kernel=5, stride=5, mode=mode, v_lsb=adc.v_lsb,
                   max_count=adc.max_count)
        best_bh = tuned[sig]["best"][0]
        bhs = sorted({1, 2, 4} | ({best_bh} if best_bh else set()))
        times, b1 = time_b2_shape(torch, flush, (x, wr, sh), qkw, bhs)
        read_ms = cuda_ms(torch, x.amax, flush)
        library_ms = cuda_ms(torch, conv2d_yardstick(torch, x, wr, 5, 5),
                             flush)
        dx = wr.shape[1] // (5 * x.shape[3])
        geo = {key: conv.pipelined_launch(
            tuple(x.shape), wr.shape[2], dx, kernel=5, stride=5,
            block_h=key[0], pipeline_depth=key[1]) for key in times}
        for key, g in geo.items():
            check(g["local_bytes"] == 0, f"B2 at {name} {key} uses "
                  f"{g['local_bytes']} bytes of local memory a thread")
        b_ms, b_by = conv_bound(x, wr, sh, 5)
        best = min(times, key=times.get)
        print(f"[9] p2m_conv_fused pipelined (B2) at {name} {mode}; (block_h, "
              f"depth): ms, pixels a thread, threads x blocks, blocks an SM, "
              f"registers, local bytes:")
        for key, ms in times.items():
            g = geo[key]
            print(f"    {key}: {ms:.4f} ms, {g['pixels_per_thread']} px, "
                  f"{g['threads']} x {g['blocks_x']}x{g['blocks_y']}, "
                  f"{g['blocks_per_sm']} an SM, {g['registers']} regs, "
                  f"{g['local_bytes']} B")
        print(f"    B1 {b1[0]:.4f} and {b1[1]:.4f} ms (before and after); "
              f"fastest B2 {best} {times[best]:.4f} ms; tuned winner "
              f"{tuned[sig]['best']}; bound {b_ms:.4f} ms by {b_by}; one "
              f"read of the images (amax) {read_ms:.4f} ms; library conv2d "
              f"{library_ms:.4f} ms")
        by_shape[name] = {
            "mode": mode, "bound_ms": b_ms, "b1_ms_in_turns": b1,
            "read_ms": read_ms, "library_ms": library_ms,
            "ms_by_block_h_depth": {f"{k[0]},{k[1]}": v
                                    for k, v in times.items()},
            "launch": {f"{k[0]},{k[1]}": v for k, v in geo.items()}}
    serving = next(iter(by_shape.values()))
    return {"ms": min(serving["ms_by_block_h_depth"].values()),
            "plain_ms": b1_row["plain_ms"], "bound_ms": b1_row["bound_ms"],
            "bound_by": b1_row["bound_by"],
            "library_ms": b1_row["library_ms"],
            "ms_by_block_h_depth": serving["ms_by_block_h_depth"],
            "b1_ms_in_turns": serving["b1_ms_in_turns"],
            "by_shape": by_shape}


def time_matmul(torch, np, dev, flush, adc):
    """Phase 9, B6 at (100,352, 75, 8), quant, with the tuner's blocks,
    beside its plain twin, one `torch.matmul` of the power concat with the
    premixed W̃ (the raw accumulation) and the bound.  Returns B6's row of
    the kernels line, without launches and error."""
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv import conv, kernel, ops, tune

    coeffs = ops._coeff_tuple(default_pixel_model())
    m, kk, n = 100_352, 75, 8
    rng = np.random.default_rng(SEED + 34)
    x = torch.from_numpy(rng.random((m, kk), np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (kk, n)) * (3.0 / kk) ** 0.5)
                         .astype(np.float32)).to(dev)
    sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(np.float32)).to(dev)
    counted = kernel.p2m_matmul_fused.launches
    t0 = time.perf_counter()
    blocks = tune.get_matmul_blocks(m, kk, n, coeffs, "quant", device=dev)
    tune_s = time.perf_counter() - t0
    rec = tune.decision_records()[-1]
    check(rec["n_failed"] == 0, f"B6 tuner: {rec['errors']}")
    bm, bn, bk = blocks
    kw = dict(coeffs=coeffs, mode="quant", v_lsb=adc.v_lsb,
              max_count=adc.max_count)
    ms = cuda_ms(torch, lambda: kernel.p2m_matmul_fused(
        x, w, sh, block_m=bm, block_n=bn, block_k=bk, **kw), flush)
    plain_ms = cuda_ms(torch, lambda: ops.p2m_matmul_plain(
        x, w, sh, default_pixel_model(), adc, "quant"), flush)
    dx = len(coeffs[0])
    xcat = torch.cat([x ** (j + 1) for j in range(dx)], dim=1)
    wcat = conv.premix_weights(w, coeffs).reshape(dx * kk, n)
    lib_err = float((torch.matmul(xcat, wcat)
                     - kernel.p2m_matmul_raw_plain(x, w, coeffs)).abs().max())
    check(lib_err <= 1e-4, f"B6 library yardstick differs by {lib_err}")
    library_ms = cuda_ms(torch, lambda: torch.matmul(xcat, wcat), flush)
    kernel.p2m_matmul_fused.launches = counted
    read_ms = cuda_ms(torch, x.amax, flush)
    geo = kernel.matmul_launch(m, kk, n, dx, block_m=bm, block_n=bn,
                               block_k=bk)
    check(geo["local_bytes"] == 0, f"B6 uses local memory a thread: {geo}")
    nbytes = 4 * (x.numel() + w.numel() + sh.numel() + m * n)
    flops = 2 * m * kk * n * dx
    b_ms, b_by = bound(nbytes, flops)
    print(f"[9] p2m_matmul_fused at ({m}, {kk}, {n}) quant, blocks "
          f"{blocks} (tuner first call {tune_s * 1e3:.1f} ms over "
          f"{len(rec['candidates'])} candidates): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library matmul of the power concat "
          f"{library_ms:.4f} ms (raw err {lib_err:.1e}); bound {b_ms:.4f} ms "
          f"by {b_by} ({nbytes} bytes, {flops} FLOP); one read of x (amax) "
          f"{read_ms:.4f} ms")
    print(f"[9] p2m_matmul_fused launch: {geo['tiles']} tiles of "
          f"{geo['block_m']} rows over {geo['blocks_x']} x {geo['blocks_y']} "
          f"blocks of {geo['threads']} threads ({geo['rows_per_thread']} rows "
          f"a thread), {geo['slots']} slots, {geo['smem_bytes']} B dynamic "
          f"shared memory, {geo['blocks_per_sm']} blocks an SM, "
          f"{geo['registers']} registers, {geo['local_bytes']} B local")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "blocks": list(blocks), "read_ms": read_ms, "launch": geo}


def lm_train_only(torch, np, dev) -> int:
    """``chip_smoke.py --lm-train``: phase 1, the build of ``wkv.cu`` with
    its ptxas lines, and phase 5g alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] card: {smi_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    wkv_kernel.build_wkv()
    seconds, report = _build.BUILD_INFO["wkv"]
    print(f"[2] wkv.cu: nvcc {seconds:.2f} s")
    for line in ptxas_summary(report):
        print(f"    ptxas: {line}")
    lm = {"cfg": get_config(LM_ARCH).replace(dtype=torch.float32)}
    out = lm_train_path(torch, np, dev, lm)
    print(json.dumps({k: v for k, v in out.items()}))
    return 0


def door_launches(door, name) -> int:
    """A kernel's launches in phase 5h's three runs on the card."""
    return (door["counts"][name] + door["chaos_counts"][name]
            + sum(c[name] for c in door["lockstep_counts"]))


def door_only(torch, np, dev) -> int:
    """``chip_smoke.py --door``: phase 1, the builds of ``p2m_conv.cu``
    and ``wkv.cu``, phase 5c and phase 5h alone.  Phase 5h's vision and
    stream references are phases 5's and 5b's main runs, made here the
    way those phases make them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.p2m_vww import CONFIG
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
    from repro_torch.models.mobilenetv2 import init_mnv2
    from repro_torch.serving import VisionEngine, VisionRequest, drive
    from repro_torch.video import DeltaGateConfig, StreamEngine, StreamRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(wkv_kernel.build_wkv)]:
            job.result()
    for name in ("p2m_conv", "wkv"):
        print(f"[2] {name}.cu: nvcc {_build.BUILD_INFO[name][0]:.2f} s")
    params, bn = init_mnv2(torch.Generator().manual_seed(SEED), CONFIG,
                           device=dev)
    images = SyntheticVWW(image_size=CONFIG.image_size,
                          batch=len(VISION_ARRIVALS),
                          seed=SEED + 1).batch_at(0)["images"]
    engine = VisionEngine(params, bn, CONFIG, device=dev)
    drive(engine, [VisionRequest(uid=i, image=images[i], arrival_tick=t)
                   for i, t in enumerate(VISION_ARRIVALS)],
          on_undrained="raise")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    stream = StreamEngine(params, bn, CONFIG, stream_head(torch, dev, CONFIG),
                          gate=DeltaGateConfig(threshold=0.0), device=dev)
    drive(stream, [StreamRequest(uid=i, frames=f) for i, f in
                   enumerate(stream_frames(CONFIG.image_size))],
          on_undrained="raise")
    torch.backends.cudnn.deterministic = False
    check(len(engine.completed) == len(VISION_ARRIVALS)
          and len(stream.completed) == len(STREAM_LENGTHS),
          "the references did not complete")
    print(f"[5] {len(engine.completed)} frames and [5b] "
          f"{len(stream.completed)} streams served alone, the door's "
          "references")
    lm = lm_path(torch, np, dev,
                 get_config(LM_ARCH).replace(dtype=torch.float32))
    out = door_path(torch, np, dev, lm,
                    {"params": params, "bn": bn, "images": images,
                     "probs": {r.uid: r.probs for r in engine.completed}},
                    {r.uid: r.frame_outputs for r in stream.completed}, smi)
    print(json.dumps(out))
    print(smi)
    return 0


SCALE_OUT_STEPS = 5  # (b): one step held to the single process, four more
SCALE_OUT_TOL = 1e-3  # params and BN against the single-process step
SCALE_OUT_LOSS_TOL = 1e-6  # (a): the one-rank world's loss
SCALE_OUT_TIMEOUT = 600.0  # seconds a world may take


def scale_out_optimizer():
    """Phase 5l's optimizer: the reference's sharded test's, with int8
    error feedback on the step."""
    from repro_torch.optim import constant, sgd

    return sgd(constant(0.01), momentum=0.9)


def scale_out_signatures(cfg, world: int) -> dict:
    """The stem's tuner signatures phase 5l meets: the single-process
    references' (training 32 raw, serving 8 and stream 4 quant) and a
    rank's (its slice of each)."""
    from repro_torch.configs.p2m_vww import (
        SERVE_MAX_BATCH,
        STREAM_MAX_SLOTS,
        TRAIN_BATCH,
    )
    from repro_torch.core.pixel_model import default_pixel_model
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple

    p = cfg.p2m
    sig = (cfg.image_size, cfg.image_size, 3, p.out_channels, p.kernel,
           p.stride, _coeff_tuple(default_pixel_model()))
    return {"training": (TRAIN_BATCH, *sig, "raw"),
            "serving": (SERVE_MAX_BATCH, *sig, "quant"),
            "stream": (STREAM_MAX_SLOTS, *sig, "quant"),
            "rank training": (TRAIN_BATCH // world, *sig, "raw"),
            "rank serving": (SERVE_MAX_BATCH // world, *sig, "quant"),
            "rank stream": (STREAM_MAX_SLOTS // world, *sig, "quant")}


def tree_digest(tree) -> str:
    """sha256 over a tree's leaves' bytes in key order: equal digests, equal
    bits."""
    import hashlib

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):  # each leaf's bytes, without a second copy
        h.update(t.detach().cpu().contiguous().reshape(-1).numpy()
                 .view("uint8"))
    return h.hexdigest()


def host_arrays(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def scale_out_rank(rank, world, tune_entries, steps, engines,
                   device="cuda"):
    """Phase 5l in one rank (a spawned process on cuda:0): the
    data-parallel VWW step at full width from the seed's weights, ``steps``
    steps on the seed's batches, each rank on its slice; with ``engines``
    the sharded vision engine, the where stream engine, the gated
    refusal and a pool over two submeshes.  The tuner's decisions are
    the parent's (``tune_entries``): a rank times nothing.  Returns what
    the parent checks, and this rank's kernel launches by part."""
    import torch

    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import tune
    from repro_torch.launch.mesh import make_debug_mesh, make_submeshes
    from repro_torch.models.mobilenetv2 import init_mnv2
    from repro_torch.parallel import use_plan, vision_plan_for
    from repro_torch.parallel.sharding_utils import local_tree
    from repro_torch.serving import (
        ReplicaPool,
        VisionEngine,
        VisionRequest,
        drive,
    )
    from repro_torch.train.vision import (
        make_vww_train_step,
        vww_train_shardings,
        vww_train_state,
    )
    from repro_torch.video import DeltaGateConfig, StreamEngine, StreamRequest

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tune.load_cache_entries(tune_entries)
    tuned = set(tune.cache_info())
    mesh = make_debug_mesh(device=dev)
    plan = vision_plan_for(mesh)
    params, bn = init_mnv2(torch.Generator().manual_seed(SEED), CONFIG,
                           device=dev)
    opt = scale_out_optimizer()
    state = vww_train_state(params, bn, opt.init(params),
                            grad_compression="int8_ef")
    step = make_vww_train_step(CONFIG, opt, grad_compression="int8_ef")
    data = SyntheticVWW(image_size=CONFIG.image_size, batch=TRAIN_BATCH,
                        seed=SEED)
    out = {"losses": [], "step_ms": [], "launches": {}}
    torch.cuda.synchronize()
    reset_kernel_counts()
    t_all = time.perf_counter()
    with use_plan(plan):
        _, b_sh = vww_train_shardings(state, data.batch_at(0), plan)
        for i in range(steps):
            local = local_tree(data.batch_at(i), b_sh)
            t0 = time.perf_counter()
            state, metrics = step(state, local)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(float(metrics["loss"]))
            if i == 0:
                out["local_batch"] = len(local["labels"])
                out["first"] = {"params": host_arrays(state["params"]),
                                "bn": host_arrays(state["bn"]),
                                "acc": float(metrics["acc"])}
                out["launches"]["first step"] = kernel_counts()
    out["launches"]["train"] = kernel_counts()
    out["step"] = state["step"]
    out["digest"] = {"params": tree_digest(state["params"]),
                     "ef": tree_digest(state["extras"]["ef_error"]),
                     "bn": tree_digest(state["bn"])}
    out["train_s"] = time.perf_counter() - t_all
    if not engines:
        out["tuned_in_rank"] = sorted(set(tune.cache_info()) - tuned)
        return out

    images = SyntheticVWW(image_size=CONFIG.image_size,
                          batch=len(VISION_ARRIVALS),
                          seed=SEED + 1).batch_at(0)["images"]

    def vision_requests():
        return [VisionRequest(uid=i, image=images[i], arrival_tick=t)
                for i, t in enumerate(VISION_ARRIVALS)]

    reset_kernel_counts()
    t0 = time.perf_counter()
    eng = VisionEngine(params, bn, CONFIG, mesh=mesh, device=dev)
    drive(eng, vision_requests(), on_undrained="raise")
    torch.cuda.synchronize()
    out["vision_s"] = time.perf_counter() - t0
    out["vision"] = {r.uid: r.probs for r in eng.completed}
    out["vision_rows"] = eng._shards.rows.tolist()
    out["vision_failed"] = len(eng.failed) + len(eng.evicted)
    out["launches"]["vision"] = kernel_counts()

    reset_kernel_counts()
    t0 = time.perf_counter()
    det = stream_head(torch, dev, CONFIG)
    seng = StreamEngine(params, bn, CONFIG, det,
                        gate=DeltaGateConfig(threshold=0.0), mesh=mesh,
                        device=dev)
    drive(seng, [StreamRequest(uid=i, frames=f) for i, f in
                 enumerate(stream_frames(CONFIG.image_size))],
          on_undrained="raise")
    torch.cuda.synchronize()
    out["stream_s"] = time.perf_counter() - t0
    out["stream"] = {r.uid: r.frame_outputs for r in seng.completed}
    out["stream_path"] = seng.stem_path
    out["stream_rows"] = seng._shards.rows.tolist()
    out["launches"]["stream"] = kernel_counts()
    try:
        StreamEngine(params, bn, CONFIG, det, mesh=mesh, stem_path="gated",
                     device=dev)
        out["gated_refusal"] = None
    except ValueError as exc:
        out["gated_refusal"] = str(exc)

    reset_kernel_counts()
    t0 = time.perf_counter()
    subs = make_submeshes(2, device=dev)
    pool = ReplicaPool(*(VisionEngine(params, bn, CONFIG, mesh=m, device=dev)
                         for m in subs))
    drive(pool, vision_requests(), on_undrained="raise")
    torch.cuda.synchronize()
    out["pool_s"] = time.perf_counter() - t0
    out["pool"] = {r.uid: r.probs for r in pool.completed}
    out["pool_completed"] = [len(r.completed) for r in pool.replicas]
    out["launches"]["pool"] = kernel_counts()
    out["tuned_in_rank"] = sorted(set(tune.cache_info()) - tuned)
    return out


def nccl_pair_rank(rank, world):
    """One all-reduce over NCCL; with both ranks on one card NCCL refuses."""
    import torch

    x = torch.ones(1, device="cuda")
    torch.distributed.all_reduce(x)
    return float(x)


def scale_out_path(torch, np, dev, smi):
    """Phase 5l: scale-out of the vision path (`parallel`, `launch.mesh`)
    on the card.  (a) a one-rank NCCL world (mesh (1, 1)): one DP step at
    full width (`CONFIG`, batch 32, int8_ef) against the single-process
    step, the loss within 1e-6, params and BN within 1e-3, bit for bit or
    not; (b) NCCL's refusal of two ranks on one card, then a two-rank
    gloo world, both ranks on cuda:0: one DP step at 16 images a rank
    against the single-process step within 1e-3 on loss, params and BN,
    four more with finite losses and both ranks' params, EF error and BN
    equal bit for bit; `VisionEngine` on a (2, 1) mesh serving phase 5's
    24 requests, the where `StreamEngine` on phase 5b's six streams, the
    gated engine's refusal and a `ReplicaPool` over two one-rank
    submeshes, each against a single engine in this process.  Returns the
    kernels' launches on the path, both worlds' ranks summed."""
    from repro_torch.configs.p2m_vww import CONFIG, TRAIN_BATCH
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import tune
    from repro_torch.launch.world import spawn_world
    from repro_torch.models.mobilenetv2 import init_mnv2
    from repro_torch.serving import VisionEngine, VisionRequest, drive
    from repro_torch.train.vision import make_vww_train_step, vww_train_state
    from repro_torch.video import DeltaGateConfig, StreamEngine, StreamRequest

    # the tuner decides here, once, for the references and every rank
    for name, args in scale_out_signatures(CONFIG, 2).items():
        best = tune.get_conv_blocks(*args, device=dev)
        print(f"[5l] tuner at the {name} signature {args[:7]} mode "
              f"{args[8]}: {tuple(best)}")
    entries = tune.cache_entries()

    # the single-process references, from the same seeds
    params, bn = init_mnv2(torch.Generator().manual_seed(SEED), CONFIG,
                           device=dev)
    opt = scale_out_optimizer()
    state = vww_train_state(params, bn, opt.init(params),
                            grad_compression="int8_ef")
    batch = SyntheticVWW(image_size=CONFIG.image_size, batch=TRAIN_BATCH,
                         seed=SEED).batch_at(0)
    ref, ref_m = make_vww_train_step(CONFIG, opt, grad_compression="int8_ef")(
        state, batch)
    ref = {"params": host_arrays(ref["params"]), "bn": host_arrays(ref["bn"]),
           "loss": float(ref_m["loss"]), "acc": float(ref_m["acc"])}
    images = SyntheticVWW(image_size=CONFIG.image_size,
                          batch=len(VISION_ARRIVALS),
                          seed=SEED + 1).batch_at(0)["images"]
    single = VisionEngine(params, bn, CONFIG, device=dev)
    drive(single, [VisionRequest(uid=i, image=images[i], arrival_tick=t)
                   for i, t in enumerate(VISION_ARRIVALS)],
          on_undrained="raise")
    single_probs = {r.uid: r.probs for r in single.completed}
    sstream = StreamEngine(params, bn, CONFIG, stream_head(torch, dev, CONFIG),
                           gate=DeltaGateConfig(threshold=0.0),
                           stem_path="where", device=dev)
    drive(sstream, [StreamRequest(uid=i, frames=f) for i, f in
                    enumerate(stream_frames(CONFIG.image_size))],
          on_undrained="raise")
    single_stream = {r.uid: r.frame_outputs for r in sstream.completed}
    del params, bn, state, single, sstream
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def max_diff(a, b) -> float:
        if isinstance(a, dict):
            return max(max_diff(a[k], b[k]) for k in a)
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())

    def bitwise(a, b) -> bool:
        if isinstance(a, dict):
            return all(bitwise(a[k], b[k]) for k in a)
        return np.array_equal(a, b)

    def hold_first_step(tag, res, loss_tol):
        loss = res["losses"][0]
        pd = max_diff(res["first"]["params"], ref["params"])
        bd = max_diff(res["first"]["bn"], ref["bn"])
        same = (bitwise(res["first"]["params"], ref["params"])
                and bitwise(res["first"]["bn"], ref["bn"])
                and loss == ref["loss"])
        print(f"[5l] {tag}: step 1 on {res['local_batch']} images a rank: "
              f"loss {loss:.7f} vs single process {ref['loss']:.7f} "
              f"(|diff| {abs(loss - ref['loss']):.3e}), acc "
              f"{res['first']['acc']:.4f} vs {ref['acc']:.4f}; params max "
              f"|diff| {pd:.3e}, BN {bd:.3e}; bit for bit: {same}")
        check(abs(loss - ref["loss"]) <= loss_tol,
              f"5l {tag}: loss {loss} vs {ref['loss']}")
        check(pd <= SCALE_OUT_TOL and bd <= SCALE_OUT_TOL,
              f"5l {tag}: params differ by {pd}, BN by {bd}")
        first = res["launches"]["first step"]
        check(first["p2m_conv_fused"] + first["p2m_conv_fused_pipelined"]
              == 1 and first["p2m_bwd_dx"] == 1 and first["p2m_bwd_dw"] == 1,
              f"5l {tag}: first step's launches {first}")
        check(not res["tuned_in_rank"],
              f"5l {tag}: a rank tuned {res['tuned_in_rank']}")

    # (a) one rank over NCCL
    on_card = dev.type == "cuda"
    card = 0 if on_card else None
    t0 = time.perf_counter()
    (one,) = spawn_world(scale_out_rank, 1,
                         backend="nccl" if on_card else "gloo",
                         cuda_index=card, timeout=SCALE_OUT_TIMEOUT,
                         args=(entries, 1, False, dev.type))
    one_s = time.perf_counter() - t0
    hold_first_step("(a) one rank, NCCL, mesh (1, 1)", one,
                    SCALE_OUT_LOSS_TOL)
    print(f"[5l] (a) {smi}: world wall {one_s:.2f} s (spawn, NCCL init, one "
          f"step {one['step_ms'][0]:.1f} ms, host clock); launches "
          f"{one['launches']['train']}")

    # (b) two ranks on one card: NCCL refuses, gloo serves
    try:
        spawn_world(nccl_pair_rank, 2, backend="nccl", cuda_index=card,
                    timeout=120)
        refusal = "NCCL accepted two ranks on one card"
    except RuntimeError as exc:
        text = str(exc).splitlines()
        lines = ([ln.strip() for ln in text if "Duplicate GPU" in ln]
                 or [ln.strip() for ln in text if "ncclInvalidUsage" in ln]
                 or text[:1])
        refusal = lines[0]
    print(f"[5l] (b) NCCL, two ranks on cuda:0: {refusal[:300]}; the "
          "two-rank world runs over gloo")
    t0 = time.perf_counter()
    two = spawn_world(scale_out_rank, 2, backend="gloo", cuda_index=card,
                      args=(entries, SCALE_OUT_STEPS, True, dev.type),
                      timeout=SCALE_OUT_TIMEOUT)
    two_s = time.perf_counter() - t0
    for rank, res in enumerate(two):
        hold_first_step(f"(b) rank {rank} of 2, gloo", res, SCALE_OUT_TOL)
        check(res["step"] == SCALE_OUT_STEPS
              and all(np.isfinite(res["losses"])),
              f"5l (b) rank {rank}: step {res['step']}, losses "
              f"{res['losses']}")
        check(res["digest"] == two[0]["digest"]
              and res["losses"] == two[0]["losses"],
              f"5l (b): rank {rank}'s state differs from rank 0's")
        train = res["launches"]["train"]
        check(train["p2m_conv_fused"] + train["p2m_conv_fused_pipelined"]
              == train["p2m_bwd_dx"] == train["p2m_bwd_dw"]
              == SCALE_OUT_STEPS, f"5l (b) rank {rank}: launches {train}")
    print(f"[5l] (b) {SCALE_OUT_STEPS} steps: losses "
          f"{[round(x, 6) for x in two[0]['losses']]}, step "
          f"{two[0]['step']}; both ranks' params, EF error and BN equal bit "
          f"for bit (sha256 {two[0]['digest']['params'][:16]}...)")

    for rank, res in enumerate(two):
        check(sorted(res["vision"]) == list(range(len(VISION_ARRIVALS)))
              and not res["vision_failed"],
              f"5l (b) rank {rank}: vision completed {sorted(res['vision'])}")
        worst = max(float(np.abs(res["vision"][u] - p).max())
                    for u, p in single_probs.items())
        check(all(np.allclose(res["vision"][u], p, rtol=1e-4, atol=1e-3)
                  for u, p in single_probs.items()),
              f"5l (b) rank {rank}: sharded vision differs by {worst}")
        print(f"[5l] (b) rank {rank}: VisionEngine on mesh (2, 1), slots "
              f"{res['vision_rows']} here: 24 requests vs a single engine, "
              f"probs max |diff| {worst:.3e}; launches "
              f"{res['launches']['vision']}")
        check(res["stream_path"] == "where"
              and sorted(res["stream"]) == sorted(single_stream),
              f"5l (b) rank {rank}: stream {res['stream_path']} "
              f"{sorted(res['stream'])}")
        sworst = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                     for u, frames in single_stream.items()
                     for want, got in zip(frames, res["stream"][u])
                     for x, y in zip(want, got))
        check(sworst <= 1e-3, f"5l (b) rank {rank}: stream differs by "
              f"{sworst}")
        check(res["gated_refusal"] is not None
              and "needs mesh=None" in res["gated_refusal"],
              f"5l (b) rank {rank}: the gated engine took a mesh")
        print(f"[5l] (b) rank {rank}: where StreamEngine, slots "
              f"{res['stream_rows']} here: boxes and scores max |diff| "
              f"{sworst:.3e} vs a single where engine; launches "
              f"{res['launches']['stream']}; gated + mesh: "
              f"{res['gated_refusal'][:60]}...")
        pworst = max(float(np.abs(res["pool"][u] - p).max())
                     for u, p in single_probs.items())
        check(sorted(res["pool"]) == sorted(single_probs)
              and all(np.allclose(res["pool"][u], p, rtol=1e-4, atol=1e-3)
                      for u, p in single_probs.items()),
              f"5l (b) rank {rank}: the pool differs by {pworst}")
        print(f"[5l] (b) rank {rank}: ReplicaPool over two one-rank "
              f"submeshes, completed by replica {res['pool_completed']}, "
              f"probs max |diff| {pworst:.3e}; launches "
              f"{res['launches']['pool']}")
        steps_ms = [round(x, 1) for x in res["step_ms"]]
        print(f"[5l] (b) rank {rank}: {smi}, two ranks sharing one card (not "
              f"a scaling figure): steps {steps_ms} ms, train "
              f"{res['train_s']:.2f} s, vision {res['vision_s']:.2f} s, "
              f"stream {res['stream_s']:.2f} s, pool {res['pool_s']:.2f} s "
              "(host clock)")
    print(f"[5l] (b) world wall {two_s:.2f} s, spawn and gloo init included")

    launches = {name: 0 for name in kernel_counts()}
    for res in [one, *two]:
        for part in ("train", "vision", "stream", "pool"):
            for name, n in res["launches"].get(part, {}).items():
                launches[name] += n
    print(f"[5l] kernel launches on the scale-out path (both worlds, every "
          f"rank): {launches}")
    return {"launches": launches, "one_s": one_s, "two_s": two_s}


def scale_out_only(torch, np, dev) -> int:
    """``chip_smoke.py --scale-out``: phase 1, the builds of
    ``p2m_conv.cu`` and ``p2m_bwd.cu`` (together) and phase 5l alone."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import backward, conv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(backward.build_p2m_bwd)]:
            job.result()
    for name in ("p2m_conv", "p2m_bwd"):
        print(f"[2] {name}.cu: nvcc {_build.BUILD_INFO[name][0]:.2f} s")
    print(json.dumps(scale_out_path(torch, np, dev, smi)))
    print(smi)
    return 0


# Phase 5m: the LM path's scale-out.  Worlds of two ranks share cuda:0
# over gloo (NCCL refuses two ranks on one card, phase 5l (b)): no time
# here is a scaling figure.
LM_SO_LAYERS = 1  # (a), (b): RWKV-6 3B's depth cut, of 32 (room for 5n)
LM_SO_ARGV = ["--arch", LM_ARCH, "--layers", str(LM_SO_LAYERS), "--steps",
              "2", "--batch", "8", "--seq", "128", "--world", "2",
              "--device", "cuda"]
LM_SO_LOSS_RTOL = 1e-5  # step 1's loss against the single process's
# Each gradient leaf, of its largest |g|: in float32 against one process
# that adds what the ranks add in their parts (`split_grads`), and with
# the model in float64 (its WKV and GroupNorm float32) against the single
# process.  Against the plain single process in float32 the ranks' other
# order of sums moves a leaf by ~1e-2 at this depth (PERF.md §6).
LM_SO_GRAD_TOL = 1e-4
EP_ARCH, EP_LAYERS, EP_BATCH = "qwen3-moe-30b-a3b", 2, (4, 64)
EP_RTOL = 1e-5  # (c): loss and aux against the single process's
SPLIT_KV_PROMPTS, SPLIT_KV_NEW, SPLIT_KV_LEN = 4, 16, 64
SPLIT_KV_TOL = 1e-5  # (d): of the single process's largest |logit|
SPLIT_KV_LAYERS = 2  # (d): Llama-3.2-1B's depth cut, of 16 (room for 5n)
LM_SO_TIMEOUT = 900.0


def _rank_card(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def _local_copy(torch, params, cfg, plan):
    """This rank's parts of a whole tree, as copies (the whole freed)."""
    from repro_torch.parallel.sharding_utils import local_tree, param_shardings
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(),
                    local_tree(params, param_shardings(cfg, plan)))


def split_grads(torch, params, batch, cfg, plan, shardings):
    """Step 1's float32 gradient tree from one process that adds what the
    plan's ranks add, in their parts: the batch in the data axis's parts
    (each part's mean loss over the number of parts, the parts' gradients
    summed), and each product with a weight the plan splits over a model
    axis of ``m`` ranks in the ranks' parts: a column-split weight's as
    the parts' products joined (autograd then adds the input's gradients,
    as *f* does), a row-split weight's as the parts' products added (*g*),
    and the log-sum-exp over the vocab as the vocab-parallel
    cross-entropy takes it (the max, then the parts' sums of exponentials
    added), which a model axis of one runs too.  The model runs without
    remat, whose recompute in the autograd engine's thread would leave
    the mode."""
    from torch.overrides import TorchFunctionMode

    from repro_torch.common.pytree import flatten_with_names
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.axes import mesh_shape
    from repro_torch.tree import tree_unflatten

    shape = mesh_shape(plan.mesh)
    m = shape.get("model", 0)
    kinds = {}  # data_ptr of a layer's weight -> how the plan splits it
    if m > 1:
        split = dict(flatten_with_names(shardings))
        for name, w in flatten_with_names(params):
            d = col.model_dim(split[name])
            if d is not None and d >= w.ndim - 2:
                for x in (w.unbind(0) if w.ndim == 3 else [w]):
                    kinds[x.data_ptr()] = "col" if d == w.ndim - 1 else "row"

    class Dense(torch.autograd.Function):
        """Identity whose backward hands on a contiguous cotangent, as a
        rank's own product (not a slice of the joined one) receives."""

        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    def parts(t, dim):
        n = t.shape[dim] // m
        return [t.narrow(dim, i * n, n).contiguous() for i in range(m)]

    def total(terms):
        out = terms[0]
        for t in terms[1:]:
            out = out + t
        return out

    class Split(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if getattr(func, "__name__", None) in ("matmul", "__matmul__"):
                x, w = args
                kind = kinds.get(w.data_ptr()) if w.ndim == 2 else None
                if kind == "col":
                    return torch.cat([Dense.apply(x @ wp)
                                      for wp in parts(w, 1)], -1)
                if kind == "row":
                    return total([a @ b for a, b in zip(parts(x, -1),
                                                        parts(w, 0))])
            if func is torch.logsumexp and m and kwargs == {"dim": -1}:
                top = args[0].detach().amax(-1)
                return torch.log(total([
                    torch.exp(lg - top[..., None]).sum(-1)
                    for lg in parts(args[0], -1)])) + top
            return func(*args, **kwargs)

    n_parts = shape.get("data", 1)
    n = next(iter(batch.values())).shape[0] // n_parts
    grads = None
    for i in range(n_parts):
        part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        with Split():
            _, g = lm_value_and_grad(torch, params, part,
                                     cfg.replace(remat=False))
        g = [t / n_parts for t in g]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    return tree_unflatten(params, grads)


def lm_train_rank(rank, world, argv):
    """Phase 5m (a)/(b) in one rank: `launch/train.py`'s plan path
    (``_train`` under ``plan_for(make_debug_mesh(model=…), fsdp=…)``) for
    two AdamW steps in float32, with the first step's reduced gradients
    and every B7 call's shape recorded (the first held against the plain
    twin on its inputs); then, on the same weights and batch, the single
    process's float32 step-1 loss and gradients (through B7 and through
    the plain WKV: the model's own float32 spread), the float32 gradients
    of one process that adds in the ranks' parts (`split_grads`, which
    the launcher's are held to), and step 1's gradients with the model in
    float64 (its WKV and GroupNorm float32, through B7), under the plan
    against the single process's."""
    import torch

    from repro_torch.common.pytree import flatten_with_names
    from repro_torch.kernels.rwkv_wkv import ops, ref
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.families import get_family
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import plan_for, use_plan
    from repro_torch.parallel.sharding_utils import (
        batch_shardings,
        local_tree,
        param_shardings,
    )
    from repro_torch.train.step import reduce_gradients
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    dev = _rank_card(torch)
    args = launch_train._parse(argv)
    cfg = launch_train.launch_config(args)
    plan = plan_for(make_debug_mesh(model=args.model_parallel, device=dev),
                    fsdp=args.fsdp)
    first, b7 = {}, {"shapes": [], "err": None}
    adamw, fused = launch_train.adamw, ops.wkv_fused

    def recording_adamw(*a, **kw):
        opt = adamw(*a, **kw)

        def update_in_place(grads, state, params, step, grad_norm=None):
            if step == 0:
                first["grads"] = tree_map(torch.clone, grads)
            opt.update_in_place(grads, state, params, step,
                                grad_norm=grad_norm)
        return Optimizer(opt.init, opt.update, update_in_place)

    def watched(r, k, v, lw, u, st, *, chunk):
        y, s_new = fused(r, k, v, lw, u, st, chunk=chunk)
        b7["shapes"].append(tuple(r.shape))
        if b7["err"] is None:
            y_p, s_p = ref.wkv_chunked_plain(r, k, v, lw, u, st, chunk)
            b7["err"] = max(
                float((y - y_p).abs().max() / y_p.abs().max()),
                float((s_new - s_p).abs().max() / s_p.abs().max()))
        return y, s_new

    launch_train.adamw, ops.wkv_fused = recording_adamw, watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    try:
        trainer, shapes = launch_train._train(args, dev, plan)
    finally:
        launch_train.adamw, ops.wkv_fused = adamw, fused
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0,
           "launches": kernel_counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": [h["loss"] for h in trainer.history],
           "shapes_agree": all(a == b for a, b in shapes.values()),
           "b7_shapes": sorted(set(b7["shapes"])),
           "b7_calls": len(b7["shapes"]), "b7_err": b7["err"]}
    sh = param_shardings(cfg, plan)
    out["replicated_digest"] = tree_digest({str(i): t for i, t in enumerate(
        tree_leaves(tree_map(lambda t, s: t if not col.sharded_over(s)
                             else None, trainer.state["params"], sh)))
        if t is not None})
    out["local_gb"] = sum(t.numel() * 4 for t in tree_leaves(
        trainer.state["params"])) / 1e9
    del trainer
    torch.cuda.empty_cache()

    family = get_family(cfg)
    batch = lm_batch(torch, dev, cfg.vocab)
    weights, _ = family.init(torch.Generator(dev).manual_seed(0), cfg)

    def errors(got, want_local, scale):
        """The largest error of a leaf, of the leaf's largest |value| in
        ``scale`` (the whole gradient), and that leaf's name."""
        w, s = dict(flatten_with_names(want_local)), dict(
            flatten_with_names(scale))
        errs = {n: float((g - w[n]).abs().max() / s[n].abs().max())
                for n, g in flatten_with_names(got)}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    def single(params, run_cfg):
        loss, grads = lm_value_and_grad(torch, params, batch, run_cfg)
        return float(loss), tree_unflatten(params, list(grads))

    out["single_loss"], g32 = single(weights, cfg)
    out["f32_err"] = errors(first["grads"], local_tree(g32, sh), g32)
    _, g_plain = single(weights, cfg.replace(wkv_impl="plain"))
    out["f32_spread"] = errors(g_plain, g32, g32)
    del g_plain
    g_split = split_grads(torch, weights, batch, cfg, plan, sh)
    out["f32_split"] = errors(first["grads"], local_tree(g_split, sh), g32)
    out["split_spread"] = errors(g_split, g32, g32)
    del first, g32, g_split
    torch.cuda.empty_cache()

    c64 = cfg.replace(dtype=torch.float64)
    w64 = tree_map(torch.Tensor.double, weights)
    del weights
    loss64, g64 = single(w64, c64)
    want = tree_map(torch.clone, local_tree(g64, sh))
    scale = tree_map(lambda t: t.abs().max(), g64)  # each leaf's, whole
    local = tree_map(torch.clone, local_tree(w64, sh))
    del g64, w64
    torch.cuda.empty_cache()
    part = local_tree(batch, batch_shardings(batch, plan))
    with use_plan(plan):
        tp_loss, tp = single(local, c64)
        tp = reduce_gradients(tp, sh, plan)
        tp_loss = float(col.all_reduce_sum(torch.tensor(
            tp_loss, dtype=torch.float64, device=dev), col.axis_groups(
                plan.mesh, col.batch_axes(plan))))
    out["f64_loss"] = (tp_loss, loss64)
    out["grad_err"], out["grad_worst"] = errors(tp, want, scale)
    out["n_leaves"] = len(tree_leaves(tp))
    return out


def ep_rank(rank, world, batch):
    """Phase 5m (c) in one rank: Qwen3-30B-A3B at full width, depth cut,
    its experts over the model axis (mesh (1, world)); the loss and aux
    of both ``moe_impl``s under the plan."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.families import get_family
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import plan_for, use_plan

    dev = _rank_card(torch)
    cfg = get_config(EP_ARCH).replace(dtype=torch.float32,
                                      n_layers=EP_LAYERS)
    mesh = make_debug_mesh(model=world, device=dev)
    plan = plan_for(mesh)
    family = get_family(cfg)
    local = _local_copy(torch, family.init(
        torch.Generator(dev).manual_seed(SEED), cfg)[0], cfg, plan)
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_kernel_counts()
    out = {"experts_here": int(local["layers"]["moe"]["wi"].shape[1]),
           "gb": torch.cuda.memory_allocated() / 1e9}
    for impl in ("xla", "shard_map"):
        run_cfg = cfg.replace(moe_impl=impl)
        with use_plan(plan), torch.no_grad():
            loss, metrics = family.loss(local, batch, run_cfg)
            loss = col.all_reduce_sum(loss, col.axis_groups(
                mesh, col.batch_axes(plan)))
        out[impl] = (float(loss), float(metrics["aux"]))
    out["launches"] = kernel_counts()
    return out


def split_kv_rank(rank, world, prompts, single_logits):
    """Phase 5m (d) in one rank: Llama-3.2-1B, 2 of 16 layers, mesh (1, world),
    ``cache_seq_shard``: `greedy_generate` under the plan, then the
    prompts and the single process's tokens teacher-forced through the
    split-KV ``decode_step``, each step's logits against the single
    process's (the rank's vocab columns gathered)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.families import get_family
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import plan_for, use_plan
    from repro_torch.parallel.sharding_utils import local_tree, shardings_for
    from repro_torch.serving import greedy_generate

    dev = _rank_card(torch)
    cfg = get_config(DENSE_ARCH).replace(dtype=torch.float32,
                                         n_layers=SPLIT_KV_LAYERS)
    mesh = make_debug_mesh(model=world, device=dev)
    plan = plan_for(mesh, cache_seq_shard=True)
    family = get_family(cfg)
    local = _local_copy(torch, family.init(
        torch.Generator(dev).manual_seed(SEED), cfg)[0], cfg, plan)
    torch.cuda.empty_cache()
    b, p = prompts.shape
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with use_plan(plan), torch.no_grad():
        tokens = greedy_generate(local, cfg, prompts, SPLIT_KV_NEW,
                                 max_len=SPLIT_KV_LEN)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        seq = torch.from_numpy(np.concatenate(
            [prompts, single_logits.argmax(-1)[:, p - 1:-1]], axis=1)).to(dev)
        state, axes = family.init_decode_state(cfg, b, SPLIT_KV_LEN,
                                               device=dev)
        state_sh = shardings_for(state, axes, plan)
        state = local_tree(state, state_sh)
        worst = 0.0
        groups = col.axis_groups(mesh, ("model",))
        for t in range(seq.shape[1]):
            lg, state = family.decode(local, state, seq[:, t:t + 1],
                                      torch.full((b,), t, device=dev), cfg,
                                      cache_shardings=state_sh)
            whole = col.gather_from_model(lg[:, 0], groups, -1)
            want = torch.from_numpy(single_logits[:, t]).to(dev)
            worst = max(worst, float((whole - want).abs().max()))
    return {"tokens": tokens.cpu().numpy(), "logit_err": worst,
            "gen_s": gen_s, "cache_local": tuple(state["k"].shape),
            "launches": kernel_counts(),
            "gb": torch.cuda.memory_allocated() / 1e9}


def lm_engines_rank(rank, world, turns, first_last):
    """Phase 5m (e) in one rank: RWKV-6 3B whole (replicated), mesh
    (world, 1): `ServeEngine` on phase 5c's 16 requests and
    `SessionEngine` on its 4 three-turn sessions, 8 slots each, this
    rank's 8/world computed; B7's launches in the rank, and the first
    prefill tick's logits against 5c's single engine's (``first_last``,
    the same requests in the same slots)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.families import get_family
    from repro_torch.serving import (
        ServeEngine,
        SessionEngine,
        SessionRequest,
        drive,
    )

    dev = _rank_card(torch)
    cfg = get_config(LM_ARCH).replace(dtype=torch.float32)
    mesh = make_debug_mesh(device=dev)
    params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(SEED),
                                     cfg)
    _, requests = lm_traffic(np, cfg.vocab)
    out = {"gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    eng = ServeEngine(params, cfg, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                      prefill_chunk=LM_CHUNK, mesh=mesh, device=dev)
    chunk_step, first = eng._chunk_step, {}

    def watched(*a):
        last, state = chunk_step(*a)
        first.setdefault("last", last.cpu().numpy())
        return last, state

    eng._chunk_step = watched
    drive(eng, requests(), on_undrained="raise")
    out["first_logits"] = first["last"]
    out["first_tick"] = float(np.abs(
        first["last"] - first_last[eng._shards.rows]).max())
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    out["serve_launches"] = kernel_counts()
    out["outputs"] = {r.uid: r.output for r in eng.completed}
    out["failed"] = len(eng.failed) + len(eng.evicted)
    out["rows"] = eng._shards.rows.tolist()
    out["ticks"] = eng.stats["launches"]
    reset_kernel_counts()
    t0 = time.perf_counter()
    sess = SessionEngine(params, cfg, max_batch=LM_MAX_BATCH,
                         max_len=LM_MAX_LEN, prefill_chunk=LM_CHUNK,
                         mesh=mesh, device=dev)
    sreqs = [SessionRequest(uid=i, turns=t, max_new_tokens=8)
             for i, t in enumerate(turns)]
    drive(sess, sreqs, on_undrained="raise")
    torch.cuda.synchronize()
    out["session_s"] = time.perf_counter() - t0
    out["session_launches"] = kernel_counts()
    out["session_outputs"] = {r.uid: r.outputs for r in sreqs}
    out["session_done"] = all(r.done for r in sreqs)
    return out


def _near_tie_tokens(got, want, margins, tag, limit=LM_LOGIT_TOL):
    """Tokens equal, or the first difference at a near-tie of the
    reference (its top-2 margin within ``limit``); how many equal."""
    same = 0
    for uid, w in want.items():
        g = got[uid]
        if g == w:
            same += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
        m = margins[uid][j]
        print(f"[5m] {tag} {uid}: tokens first differ at output {j} "
              f"({g[j]} vs {w[j]}), top-2 margin {m:.3e} (limit {limit})")
        check(m <= limit, f"5m {tag} {uid}: tokens differ at {j}, "
              f"not a near-tie (margin {m}, limit {limit})")
    return same


def lm_scale_out_path(torch, np, dev, smi, lm):
    """Phase 5m: the LM path's scale-out on one card, ranks over gloo.
    (a) TP train and (b) FSDP train through `launch/train.py`'s plan
    path, (c) EP, (d) split-KV decode, (e) the sharded engines against
    phase 5c's (``lm``).  Returns every kernel's launches on the path
    (the ranks' sums) and the worlds' wall times."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.world import spawn_world
    from repro_torch.models.families import get_family
    from repro_torch.serving import greedy_generate
    from repro_torch.tree import tree_leaves

    from repro_torch.kernels.rwkv_wkv import kernel

    launches = {name: 0 for name in kernel_counts()}
    walls = {}
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    b7_in = wkv_inputs(torch, np, dev, *WKV_SERVE_SHAPE, SEED + 60)

    def time_b7(when):
        """B7 at phase 9's shape, as phase 9 times it, and its wrapper's
        host time, with the card's clocks and the parent's live children:
        whether 5m's worlds leave the card or the host slower."""
        import multiprocessing
        import threading

        counted = kernel.wkv_fused.launches
        ms = cuda_ms(torch, lambda: kernel.wkv_fused(*b7_in), flush)
        host = wall_ms(torch, lambda: kernel.wkv_fused(*b7_in), flush)
        kernel.wkv_fused.launches = counted
        state = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=60).stdout.strip()
        print(f"[5m] B7 at {WKV_SERVE_SHAPE} {when} 5m's worlds: {ms:.4f} ms "
              f"(CUDA events, L2 flushed), through its wrapper {host:.4f} "
              f"ms (host clock); card (SM clock, memory clock, temperature, "
              f"power) {state}; the parent's live children "
              f"{len(multiprocessing.active_children())}, threads "
              f"{threading.active_count()}; {smi}")
        return ms, host

    b7_ms = {"before": time_b7("before")}

    def spawn(tag, fn, args):
        print(f"[5m] {tag}: the parent holds "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        t0 = time.perf_counter()
        res = spawn_world(fn, 2, backend="gloo", cuda_index=0, args=args,
                          timeout=LM_SO_TIMEOUT)
        walls[tag] = time.perf_counter() - t0
        return res

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    # (a) and (b): the launcher's plan path, two AdamW steps
    rwkv = get_config(LM_ARCH).replace(n_layers=LM_SO_LAYERS)
    n_params = rwkv.param_count_estimate()
    heads = rwkv.n_rwkv_heads
    for tag, extra, want_shape in (
            ("(a) TP, mesh (1, 2)", ["--model-parallel", "2"],
             (8, 128, heads // 2, rwkv.rwkv_head_dim)),
            ("(b) FSDP, mesh (2, 1)", ["--model-parallel", "1", "--fsdp"],
             (4, 128, heads, rwkv.rwkv_head_dim))):
        print(f"[5m] {tag}: RWKV-6 3B at full width, {LM_SO_LAYERS} of 32 "
              f"layers (about {n_params / 1e9:.2f} B params by the "
              f"reference's count, {4 * n_params / 1e9:.2f} GB fp32 whole); "
              f"a rank holds its part, AdamW's two moments and, for the "
              f"check, the whole tree and its gradient")
        ranks = spawn(tag, lm_train_rank, (LM_SO_ARGV + extra,))
        for rank, res in enumerate(ranks):
            loss_err = abs(res["losses"][0] - res["single_loss"]) / abs(
                res["single_loss"])
            l64, want64 = res["f64_loss"]
            loss64_err = abs(l64 - want64) / abs(want64)
            print(f"[5m] {tag} rank {rank}: losses {res['losses']}, step 1 "
                  f"vs the single process {loss_err:.3e} (relative); "
                  f"float32 gradients: worst leaf {res['f32_err'][0]:.3e} "
                  f"of its largest |g| ({res['f32_err'][1]}), the single "
                  f"process's own spread (B7 vs plain WKV) "
                  f"{res['f32_spread'][0]:.3e} ({res['f32_spread'][1]}); "
                  f"B7 {res['b7_calls']} calls at {res['b7_shapes']}, first "
                  f"vs plain twin {res['b7_err']:.3e}; local params "
                  f"{res['local_gb']:.2f} GB, peak {res['peak_gb']:.2f} GB; "
                  f"{res['seconds']:.2f} s (host clock)")
            print(f"[5m] {tag} rank {rank}: float32 gradients against "
                  f"one process that adds in the ranks' parts "
                  f"(`split_grads`): worst leaf {res['f32_split'][0]:.3e} "
                  f"({res['f32_split'][1]}; limit {LM_SO_GRAD_TOL}); that "
                  f"process against the plain single one "
                  f"{res['split_spread'][0]:.3e} ({res['split_spread'][1]})")
            print(f"[5m] {tag} rank {rank}: step 1 in float64 (WKV and "
                  f"GroupNorm float32, B7): loss {loss64_err:.3e} "
                  f"(relative), {res['n_leaves']} gradient leaves, worst "
                  f"{res['grad_err']:.3e} of its largest |g| "
                  f"({res['grad_worst']})")
            check(loss_err <= LM_SO_LOSS_RTOL and loss64_err
                  <= LM_SO_LOSS_RTOL, f"5m {tag} rank {rank}: loss "
                  f"{loss_err}, float64 {loss64_err}")
            check(res["grad_err"] <= LM_SO_GRAD_TOL, f"5m {tag} rank {rank}: "
                  f"gradient {res['grad_worst']} {res['grad_err']}")
            check(res["f32_split"][0] <= LM_SO_GRAD_TOL, f"5m {tag} rank "
                  f"{rank}: float32 gradient {res['f32_split'][1]} "
                  f"{res['f32_split'][0]} from the split single process's")
            check(res["shapes_agree"], f"5m {tag} rank {rank}: a leaf's "
                  "shape is not the plan's shard shape")
            check(res["b7_shapes"] == [want_shape]
                  and res["b7_calls"] == 2 * 2 * LM_SO_LAYERS
                  and res["launches"]["wkv_fused"] == 2 * 2 * LM_SO_LAYERS,
                  f"5m {tag} rank {rank}: B7 {res['b7_calls']} calls, "
                  f"{res['launches']['wkv_fused']} launches at "
                  f"{res['b7_shapes']}")
            check(res["b7_err"] <= WKV_TOL, f"5m {tag}: B7 vs plain "
                  f"{res['b7_err']}")
            check(res["replicated_digest"] == ranks[0]["replicated_digest"]
                  and res["losses"] == ranks[0]["losses"],
                  f"5m {tag}: rank {rank}'s replicated leaves differ")
            add(res["launches"])
        print(f"[5m] {tag}: both ranks' replicated leaves equal bit for bit "
              f"after 2 steps (sha256 {ranks[0]['replicated_digest'][:16]}"
              f"...); world wall {walls[tag]:.2f} s, {smi}, two ranks "
              f"sharing one card over gloo (not a scaling figure)")

    # (c) EP: the single process's loss first, then the world
    cfg = get_config(EP_ARCH).replace(dtype=torch.float32,
                                      n_layers=EP_LAYERS)
    rng = np.random.default_rng(SEED + 20)
    toks = rng.integers(0, cfg.vocab, EP_BATCH).astype(np.int64)
    batch = {"tokens": toks, "targets": toks}
    family = get_family(cfg)
    params, _ = family.init(torch.Generator(dev).manual_seed(SEED), cfg)
    n_ep = sum(t.numel() for t in tree_leaves(params))
    with torch.no_grad():
        loss, metrics = family.loss(params, {k: torch.from_numpy(v).to(dev)
                                             for k, v in batch.items()}, cfg)
    want = (float(loss), float(metrics["aux"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[5m] (c) EP: {EP_ARCH} at full width, {EP_LAYERS} of "
          f"{get_config(EP_ARCH).n_layers} layers ({n_ep} params, "
          f"{4 * n_ep / 1e9:.2f} GB fp32 whole, the experts' half a rank), "
          f"batch {EP_BATCH}; single process loss {want[0]:.6f}, aux "
          f"{want[1]:.6f}")
    ranks = spawn("(c) EP, mesh (1, 2)", ep_rank, (batch,))
    for rank, res in enumerate(ranks):
        for impl in ("xla", "shard_map"):
            got = res[impl]
            err = max(abs(got[0] - want[0]) / abs(want[0]),
                      abs(got[1] - want[1]) / abs(want[1]))
            check(err <= EP_RTOL, f"5m (c) rank {rank} {impl}: {got} vs "
                  f"{want}")
            print(f"[5m] (c) rank {rank} {impl}: loss {got[0]:.6f}, aux "
                  f"{got[1]:.6f}, relative error {err:.3e}; "
                  f"{res['experts_here']} experts here, {res['gb']:.2f} GB")
        check(res["experts_here"] == cfg.n_experts // 2,
              f"5m (c): {res['experts_here']} experts a rank")
        add(res["launches"])

    # (d) split-KV decode: the single process's greedy run and logits
    dcfg = get_config(DENSE_ARCH).replace(dtype=torch.float32,
                                          n_layers=SPLIT_KV_LAYERS)
    lengths, requests = lm_traffic(np, dcfg.vocab, SPLIT_KV_PROMPTS)
    p = int(min(lengths))
    prompts = np.stack([np.asarray(r.prompt[:p], np.int64)
                        for r in requests()])
    family = get_family(dcfg)
    params, _ = family.init(torch.Generator(dev).manual_seed(SEED), dcfg)
    with torch.no_grad():
        tokens = greedy_generate(params, dcfg, prompts, SPLIT_KV_NEW,
                                 max_len=SPLIT_KV_LEN,
                                 prefill_chunk=1).cpu().numpy()
        seq = torch.from_numpy(np.concatenate([prompts, tokens[:, :-1]],
                                              axis=1)).to(dev)
        state, _ = family.init_decode_state(dcfg, len(prompts),
                                            SPLIT_KV_LEN, device=dev)
        logits = []
        for t in range(seq.shape[1]):
            lg, state = family.decode(params, state, seq[:, t:t + 1],
                                      torch.full((len(prompts),), t,
                                                 device=dev), dcfg)
            logits.append(lg[:, 0].cpu().numpy())
    logits = np.stack(logits, 1)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    scale = float(np.abs(logits).max())
    top2 = np.sort(logits[:, p - 1:], axis=-1)[..., -2:]
    margins = {i: list(top2[i, :, 1] - top2[i, :, 0])
               for i in range(len(prompts))}
    print(f"[5m] (d) split-KV: {DENSE_ARCH} at full width, "
          f"{SPLIT_KV_LAYERS} of 16 layers, prompts {prompts.shape} "
          f"(phase 5c's first {SPLIT_KV_PROMPTS}, cut to the shortest), "
          f"{SPLIT_KV_NEW} greedy tokens, cache of {SPLIT_KV_LEN} "
          f"({SPLIT_KV_LEN // 2} a rank); single process's largest |logit| "
          f"{scale:.3f}")
    ranks = spawn("(d) split-KV, mesh (1, 2)", split_kv_rank,
                  (prompts, logits))
    for rank, res in enumerate(ranks):
        same = _near_tie_tokens(
            {i: list(res["tokens"][i]) for i in range(len(prompts))},
            {i: list(tokens[i]) for i in range(len(prompts))}, margins,
            "(d)")
        print(f"[5m] (d) rank {rank}: cache {res['cache_local']} here; "
              f"logits max |diff| {res['logit_err']:.3e} "
              f"({res['logit_err'] / scale:.3e} of the largest), "
              f"{same}/{len(prompts)} rows' tokens equal; greedy "
              f"{res['gen_s']:.2f} s (host clock, gloo), {res['gb']:.2f} GB")
        check(res["logit_err"] <= SPLIT_KV_TOL * scale, f"5m (d) rank {rank}: "
              f"logits differ by {res['logit_err']}")
        check(res["cache_local"][2] == SPLIT_KV_LEN // 2,
              f"5m (d): cache {res['cache_local']}")
        add(res["launches"])

    # (e) the sharded engines against phase 5c's single ones
    print(f"[5m] (e) engines: RWKV-6 3B whole on each rank "
          f"({4 * lm['n_params'] / 1e9:.2f} GB fp32 replicated), 8 slots, 4 "
          "a rank")
    ranks = spawn("(e) engines, mesh (2, 1)", lm_engines_rank,
                  (lm["session_turns"], lm["first_last"]))
    for rank, res in enumerate(ranks):
        check(res["failed"] == 0 and sorted(res["outputs"]) == sorted(
            lm["outputs"]), f"5m (e) rank {rank}: served "
            f"{sorted(res['outputs'])}, {res['failed']} failed")
        # A rank's first tick equals the single process's on its 4 slots
        # bit for bit (below); those round otherwise than 5c's 8-slot
        # products (cuBLAS picks by shape), which 32 layers carry to the
        # logits as any two float32 runs of this model: a later differing
        # token's margin is held to the model's spread limit (5c), not
        # B7's.
        same = _near_tie_tokens(res["outputs"], lm["outputs"], lm["margins"],
                                "(e) serve", LM_SPREAD_TOL)
        flat = {u: sum(o, []) for u, o in res["session_outputs"].items()}
        want = {u: sum(o, []) for u, o in lm["session_outputs"].items()}
        check(res["session_done"], f"5m (e) rank {rank}: sessions undone")
        s_same = _near_tie_tokens(flat, want, lm["session_margins"],
                                  "(e) sessions", LM_SPREAD_TOL)
        b7 = (res["serve_launches"]["wkv_fused"],
              res["session_launches"]["wkv_fused"])
        check(all(n > 0 and n % lm["cfg"].n_layers == 0 for n in b7),
              f"5m (e) rank {rank}: B7 launches {b7}")
        rows = res["rows"]
        same_first = rows in ([0, 1, 2, 3], [4, 5, 6, 7]) and np.array_equal(
            res["first_logits"], lm["first_halves"][rows])
        print(f"[5m] (e) rank {rank}: the first prefill tick's logits equal "
              f"bit for bit to the single process's tick on slots {rows} "
              f"alone: {same_first}; {res['first_tick']:.3e} from 5c's "
              f"8-slot tick's")
        check(same_first, f"5m (e) rank {rank}: the first tick's logits "
              f"differ from the single process's on slots {rows}")
        print(f"[5m] (e) rank {rank}: slots {res['rows']}; ServeEngine "
              f"{len(res['outputs'])} requests in {res['ticks']} ticks, "
              f"{same}/{len(lm['outputs'])} token lists equal "
              f"to 5c's, {res['serve_s']:.2f} s; SessionEngine "
              f"{s_same}/{len(want)} sessions equal, "
              f"{res['session_s']:.2f} s; B7 {b7[0]} + {b7[1]} launches "
              f"here; {res['gb']:.2f} GB (host clock, gloo)")
        add(res["serve_launches"])
        add(res["session_launches"])
    others = {k: n for k, n in launches.items() if k != "wkv_fused"}
    check(not any(others.values()), f"5m: a kernel other than B7 launched "
          f"on the LM scale-out path: {others}")
    check(launches["wkv_fused"] > 0, "5m: B7 never launched")
    print(f"[5m] kernel launches on the LM scale-out path (every rank): "
          f"{launches}; world walls {walls}")
    b7_ms["after"] = time_b7("after")
    del flush, b7_in
    return {"launches": launches, "walls": walls, "b7_ms": b7_ms}


def lm_scale_out_only(torch, np, dev) -> int:
    """``chip_smoke.py --lm-scale-out``: phase 1, the build of ``wkv.cu``,
    phase 5c (the single engines (e) is held to) and phase 5m alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    wkv_kernel.build_wkv()
    print(f"[2] wkv.cu: nvcc {_build.BUILD_INFO['wkv'][0]:.2f} s")
    lm = lm_path(torch, np, dev, get_config(LM_ARCH).replace(
        dtype=torch.float32))
    print(json.dumps(lm_scale_out_path(torch, np, dev, smi, lm)))
    print(smi)
    return 0


# Phase 5n: the rest of the LM path's scale-out.  Worlds of gloo ranks
# share cuda:0, as in 5m: no time here is a scaling figure.
REST_TOL = 1e-5  # float64: of each leaf's / the logits' largest |value|
REST_TIMEOUT = 1200.0
REST_RWKV_ARGV = ["--arch", LM_ARCH, "--layers", "1", "--steps", "1",
                  "--batch", "8", "--seq", "128", "--world", "16",
                  "--model-parallel", "16", "--device", "cuda"]
REST_CKPT_ARGV = ["--arch", LM_ARCH, "--layers", "2", "--batch", "8",
                  "--seq", "128", "--world", "2", "--device", "cuda"]
REST_ARCHS = ((WHISPER_ARCH, None), (RGLRU_ARCH, 3), (VLM_ARCH, 5))
# (tag, arch, layers or None, ranks, model axis, fsdp, decode).  (c) runs
# TP 2 alone here: its float64 FSDP step gathers and reduce-scatters 22 GB
# through gloo (78 s on the card), more than the script's time limit
# leaves; the CPU tests hold RG-LRU's FSDP step and decode
REST_WORLDS = (  # each world runs its cases in this order, the two-rank
    # world's largest (~35 GB a rank) first
    ("(c) TP 2", RGLRU_ARCH, 3, 2, 2, False, True),
    ("(d) TP 2", VLM_ARCH, 5, 2, 2, False, True),
    ("(b) TP 2", WHISPER_ARCH, None, 2, 2, False, True),
    ("(b) FSDP 2", WHISPER_ARCH, None, 2, 1, True, True),
    ("(b) TP 4", WHISPER_ARCH, None, 16, 4, False, True),  # in (a)'s world
)
REST_ROWS = {WHISPER_ARCH: 4, RGLRU_ARCH: 2, VLM_ARCH: MM_FRAMES}
REST_PROMPT = 16  # tokens teacher-forced before (d)'s greedy ones
REST_NEW = 16  # decode steps: teacher-forced (b), (c); greedy (d)
REST_SEQ = 32  # the train step's sequence


def rest_config(torch, arch, layers=None):
    """The world's config at full width in float64, depth cut."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(dtype=torch.float64)
    return cfg.replace(n_layers=layers) if layers else cfg


def rest_weights(torch, dev, cfg, gates=True):
    """The family's init on ``dev`` seeded ``SEED`` in float32 (the same
    draw in every process), the VLM's gates nonzero as in 5k."""
    from repro_torch.models.families import get_family

    params, _ = get_family(cfg).init(
        torch.Generator(dev).manual_seed(SEED),
        cfg.replace(dtype=torch.float32))
    if cfg.family == "vlm" and gates:
        gen = torch.Generator(dev).manual_seed(SEED + 5)
        for gate in ("gate_attn", "gate_mlp"):
            params["cross"][gate] = 0.5 + 0.5 * torch.rand(
                params["cross"][gate].shape, generator=gen, device=dev)
    return params


def rest_frontend(torch, dev, tune_entries=None):
    """4 SyntheticVWW frames through the deploy-folded P²M frontend
    (B1 or B2 as tuned; with ``tune_entries`` the parent's decisions, so
    a rank times nothing): (B, 784, 4096) float32 tokens."""
    from repro_torch.core import bn_fold, frontend
    from repro_torch.core import p2m_conv as core
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels.p2m_conv import tune

    if tune_entries is not None:
        tune.load_cache_entries(tune_entries)
    fcfg = frontend.P2MFrontendConfig()
    fparams = frontend.init_p2m_frontend(torch.Generator().manual_seed(SEED),
                                         fcfg, device=dev)
    fstate = frontend.init_p2m_frontend_state(fcfg, device=dev)
    deploy = core.premix_deploy(bn_fold.deploy_params(
        fparams["conv"], fstate["conv"], fcfg.conv), fcfg.conv)
    frames = torch.from_numpy(SyntheticVWW(
        image_size=fcfg.image_size, batch=MM_FRAMES, seed=SEED
    ).batch_at(0)["images"]).to(dev)
    with torch.no_grad():
        emb, _ = frontend.apply_p2m_frontend(fparams, fstate, frames, fcfg,
                                             deploy=deploy)
    return emb


def rest_inputs(torch, np, dev, cfg, rows, emb=None):
    """The world's batch (train step) and decode rows, made from the seed
    on ``dev``: {"batch": ..., "seq": (rows, the decode's) tokens,
    "embeds": the rows' source or image embeddings}."""
    rng = np.random.default_rng(SEED + 31)
    tok = rng.integers(0, cfg.vocab, (rows, REST_SEQ))
    tgt = rng.integers(0, cfg.vocab, (rows, REST_SEQ))
    batch = {"tokens": torch.from_numpy(tok).to(dev),
             "targets": torch.from_numpy(tgt).to(dev)}
    embeds = None
    if cfg.family == "encdec":
        embeds = torch.from_numpy(rng.normal(
            0, 1, (rows, cfg.max_source_positions, cfg.d_model))).to(dev)
        batch["src_embeds"] = embeds
    if cfg.family == "vlm":
        embeds = emb.double()
        batch["image_embeds"] = embeds
    steps = REST_PROMPT + REST_NEW if cfg.family == "vlm" else REST_NEW
    return {"batch": batch, "embeds": embeds,
            "seq": batch["tokens"][:, :steps]}


def rest_grads(torch, cfg, params, batch, plan=None):
    """(loss, gradient tree) of the family's loss; under ``plan`` on this
    rank's parts, the gradients reduced by the train step's rule and the
    loss the shares' sum."""
    from repro_torch.models.families import get_family
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import use_plan
    from repro_torch.parallel.sharding_utils import param_shardings
    from repro_torch.train.step import reduce_gradients
    from repro_torch.tree import tree_leaves, tree_unflatten

    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    if plan is None:
        loss, _ = get_family(cfg).loss(tree_unflatten(params, live), batch,
                                       cfg)
        return float(loss), tree_unflatten(
            params, list(torch.autograd.grad(loss, live)))
    with use_plan(plan):
        loss, _ = get_family(cfg).loss(tree_unflatten(params, live), batch,
                                       cfg)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss, live)))
        grads = reduce_gradients(grads, param_shardings(cfg, plan), plan)
        loss = col.all_reduce_sum(loss.detach(), col.axis_groups(
            plan.mesh, col.batch_axes(plan)))
    return float(loss), grads


def rest_decode(torch, cfg, params, seq, embeds, plan=None):
    """Teacher-forced decode of ``seq`` (B, T): each step's logits (B, T,
    V) whole (under ``plan`` the ranks' vocab columns and rows gathered),
    the cross K/V prefilled from ``embeds`` for vlm and encdec."""
    from repro_torch.models import vlm, whisper
    from repro_torch.models.families import get_family
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import use_plan
    from repro_torch.parallel.sharding_utils import (
        batch_shardings,
        local_tree,
        shardings_for,
    )

    family = get_family(cfg)
    b, t = seq.shape
    state, axes = family.init_decode_state(cfg, b, t, device=seq.device)
    kw, rows = {}, seq
    if plan is not None:
        kw["cache_shardings"] = shardings_for(state, axes, plan)
        state = local_tree(state, kw["cache_shardings"])
        rows = local_tree(seq, batch_shardings(seq, plan))
        embeds = None if embeds is None else local_tree(
            embeds, batch_shardings(embeds, plan))
    out = []
    with use_plan(plan), torch.no_grad():
        if cfg.family in ("vlm", "encdec"):
            mod = vlm if cfg.family == "vlm" else whisper
            state["cross"] = mod.prefill_cross_kv(params, embeds, cfg)
        for i in range(t):
            lg, state = family.decode(
                params, state, rows[:, i:i + 1],
                torch.full((rows.shape[0],), i, device=seq.device), cfg,
                **kw)
            if plan is not None:
                lg = col.gather_from_model(
                    lg, col.axis_groups(plan.mesh, ("model",)), -1)
                lg = col.all_gather_batch(lg, col.axis_groups(
                    plan.mesh, col.batch_axes(plan, b)))
            out.append(lg[:, 0])
    return torch.stack(out, 1)


def rest_forward(torch, cfg, params, seq, embeds):
    """The single process's float64 forward logits of ``seq``."""
    from repro_torch.models import rglru, vlm, whisper

    with torch.no_grad():
        if cfg.family == "encdec":
            return whisper.forward(params, embeds, seq, cfg)[0]
        if cfg.family == "vlm":
            return vlm.forward(params, seq, embeds, cfg)[0]
        return rglru.forward(params, seq, cfg)[0]


def save_reference(np, grads, directory) -> dict:
    """Each float64 gradient leaf to ``directory/<path>.npy`` (the ranks
    read their slices of it by memory map) rounded to float32, whose
    6e-8 of a value is far inside ``REST_TOL`` and halves the bytes to
    write; each leaf's largest |g|, from the float64 values."""
    from repro_torch.common.pytree import flatten_with_names

    scales = {}
    for name, g in flatten_with_names(grads):
        scales[name] = float(g.detach().abs().max())
        np.save(f"{directory}/{name}.npy", g.detach().float().cpu().numpy())
    return scales


def reference_errors(np, grads, shardings, directory, scales):
    """(the worst leaf's error of its whole largest |g|, its name, the
    leaves compared): this rank's parts of the reduced gradients against
    its slices of the single process's (`save_reference`)."""
    from repro_torch.common.pytree import flatten_with_names

    import torch

    split = dict(flatten_with_names(shardings))
    errs = {}
    for name, g in flatten_with_names(grads):
        want = split[name].local(np.load(f"{directory}/{name}.npy",
                                         mmap_mode="r"))
        # on the rank's device: the host holds one slice at a time
        want = torch.from_numpy(np.ascontiguousarray(want)).to(
            g.device, g.dtype)
        errs[name] = float((g.detach() - want).abs().max()
                           / max(scales[name], 1e-300))
        del want
    worst = max(errs, key=errs.get)
    return errs[worst], worst, len(errs)


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "numel"))


def census_bytes(cfg, plan, batch: int, seq: int, kind: str) -> int:
    """The census's per-rank argument bytes of the state under ``plan``
    (`launch/specs.py` builders, `op_analysis.argument_bytes`): params
    and AdamW's moments for a train state, the params alone else."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.op_analysis import argument_bytes
    from repro_torch.launch.specs import build_prefill_cell, build_train_cell

    spec = ShapeSpec(kind, kind, seq, batch)
    if kind == "train":
        _, (state, _), (state_sh, _) = build_train_cell(cfg, spec, plan)
        return argument_bytes(state, state_sh)
    _, (params, _), (params_sh, _) = build_prefill_cell(cfg, spec, plan)
    return argument_bytes(params, params_sh)


def _rest_card(torch, device):
    if device == "cuda":
        return _rank_card(torch)
    return torch.device(device)


def rest_rwkv_rank(rank, world, argv, ref_dir, scales, cases, device):
    """5n (a) in one rank: `launch/train.py`'s plan path for one AdamW step
    at a model axis of ``world`` (RWKV-6 3B's 40 heads whole on every
    rank, its 2560 columns split), with B7's calls recorded; the rank's
    state bytes beside the census's; then step 1 with the model in
    float64 (WKV and GroupNorm float32, through B7) under the plan,
    against the single process's gradients (``ref_dir``)."""
    import torch

    from repro_torch.kernels.rwkv_wkv import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import plan_for
    from repro_torch.parallel.sharding_utils import local_tree, param_shardings
    from repro_torch.tree import tree_map

    dev = _rest_card(torch, device)
    args = launch_train._parse(argv)
    cfg = launch_train.launch_config(args)
    plan = plan_for(make_debug_mesh(model=args.model_parallel, device=dev),
                    fsdp=args.fsdp)
    shapes, fused = [], ops.wkv_fused

    def watched(r, k, v, lw, u, st, *, chunk):
        shapes.append(tuple(r.shape))
        return fused(r, k, v, lw, u, st, chunk=chunk)

    ops.wkv_fused = watched
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    try:
        trainer, leaf_shapes = launch_train._train(args, dev, plan)
    finally:
        ops.wkv_fused = fused
    if dev.type == "cuda":
        torch.cuda.synchronize()
    state = {k: v for k, v in trainer.state.items() if k in ("params", "opt")}
    out = {"seconds": time.perf_counter() - t0, "launches": kernel_counts(),
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if dev.type == "cuda" else 0.0),
           "losses": [h["loss"] for h in trainer.history],
           "shapes_agree": all(a == b for a, b in leaf_shapes.values()),
           "b7_shapes": sorted(set(shapes)), "b7_calls": len(shapes),
           "state_bytes": tree_bytes(state),
           "census_bytes": census_bytes(cfg, plan, args.batch, args.seq,
                                        "train")}
    del trainer, state
    sh = param_shardings(cfg, plan)
    weights = rest_weights(torch, dev, cfg)
    local = tree_map(lambda t: t.double(), local_tree(weights, sh))
    del weights
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from repro_torch.parallel.sharding_utils import batch_shardings

    batch = lm_batch(torch, dev, cfg.vocab)
    batch = local_tree(batch, batch_shardings(batch, plan))
    out["f64_loss"], grads = rest_grads(
        torch, cfg.replace(dtype=torch.float64), local, batch, plan)
    import numpy as np

    out["grad_err"], out["grad_worst"], out["n_leaves"] = reference_errors(
        np, grads, sh, ref_dir, scales)
    del grads, local, batch
    rest_free(torch, dev)
    out["cases"] = [rest_case(rank, case, dev) for case in cases]
    return out


def rest_case(rank, case, dev):
    """5n (b)-(d), one case in one rank: the case's plan, the rank's parts
    of the weights (float32 bytes beside the census's, then float64), the
    VLM's image tokens from the frontend on the rank's card (B1/B2
    counted), one train step's reduced float64 gradients against the
    single process's (``case["ref_dir"]``) and the teacher-forced decode's
    logits (returned by rank 0)."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import plan_for
    from repro_torch.parallel.sharding_utils import (
        batch_shardings,
        local_tree,
        param_shardings,
    )
    from repro_torch.tree import tree_map

    cfg = rest_config(torch, case["arch"], case["layers"])
    plan = plan_for(make_debug_mesh(model=case["model"], device=dev),
                    fsdp=case["fsdp"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    emb = None
    if cfg.family == "vlm":
        emb = rest_frontend(torch, dev, case["tune"])
    front = kernel_counts()
    c32 = cfg.replace(dtype=torch.float32)
    sh = param_shardings(cfg, plan)
    weights = rest_weights(torch, dev, cfg)
    local32 = local_tree(weights, param_shardings(c32, plan))
    out = {"state_bytes": tree_bytes(local32),
           "census_bytes": census_bytes(c32, plan, REST_ROWS[case["arch"]],
                                        REST_SEQ, "prefill")}
    params = tree_map(lambda t: t.double(), local32)
    del weights, local32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    inputs = rest_inputs(torch, np, dev, cfg, REST_ROWS[case["arch"]], emb)
    batch = local_tree(inputs["batch"], batch_shardings(inputs["batch"],
                                                         plan))
    out["loss"], grads = rest_grads(torch, cfg, params, batch, plan)
    out["grad_err"], out["grad_worst"], out["n_leaves"] = reference_errors(
        np, grads, sh, case["ref_dir"], case["scales"])
    del grads
    out["logits"] = None
    if case["decode"]:
        logits = rest_decode(torch, cfg, params,
                             torch.from_numpy(case["seq"]).to(dev),
                             inputs["embeds"], plan)
        out["logits"] = logits.cpu().numpy() if rank == 0 else None
    out["launches"] = kernel_counts()
    out["frontend"] = front
    out["seconds"] = time.perf_counter() - t0
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if dev.type == "cuda" else 0.0)
    out["host_gb"] = host_available_gb()
    return out


def host_available_gb() -> float:
    """The machine's available host memory (`MemAvailable`), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def rest_train(argv, dev, compared=True):
    """5n (e): `launch/train.py`'s plan path for ``argv`` with its
    checkpoints (every rank saves, rank 0 writes; a restore gives each
    rank its part by the current plan), B7 counted; where ``compared``,
    the state's digest, bytes and the census's."""
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import plan_for

    args = launch_train._parse(argv)
    cfg = launch_train.launch_config(args)
    plan = plan_for(make_debug_mesh(model=args.model_parallel, device=dev),
                    fsdp=args.fsdp)
    reset_kernel_counts()
    t0 = time.perf_counter()
    trainer, _ = launch_train._train(args, dev, plan)
    out = {"seconds": time.perf_counter() - t0, "launches": kernel_counts(),
           "losses": [h["loss"] for h in trainer.history],
           "step": int(trainer.state["step"])}
    if compared:
        state = {k: v for k, v in trainer.state.items()
                 if k in ("params", "opt")}
        out.update(digest=tree_digest(state), state_bytes=tree_bytes(state),
                   census_bytes=census_bytes(cfg, plan, args.batch, args.seq,
                                             "train"))
    return out


def npz_views(path):
    """Each array of an uncompressed ``.npz`` (`np.savez`'s) by name, as
    a read-only memory map of its bytes in the archive: a check reads
    only the slices it compares, and no array is copied whole."""
    import struct
    import zipfile

    import numpy as np

    fmt = np.lib.format
    views = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            check(info.compress_type == zipfile.ZIP_STORED,
                  f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            local = f.read(30)  # the member's local header, then its name
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            major, _ = fmt.read_magic(f)
            shape, fortran, dtype = (fmt.read_array_header_1_0(f)
                                     if major == 1 else
                                     fmt.read_array_header_2_0(f))
            name = info.filename.removesuffix(".npy")
            if not shape:  # a scalar: np.memmap takes no empty shape
                views[name] = np.frombuffer(f.read(dtype.itemsize),
                                            dtype)[0]
                continue
            views[name] = np.memmap(path, dtype, "r", offset=f.tell(),
                                    shape=shape,
                                    order="F" if fortran else "C")
    return views


def rest_restore(argv, ckpt_dir, dev):
    """5n (e): the checkpoint in ``ckpt_dir`` restored by ``argv``'s plan,
    each rank's parts against its slices of the saved global arrays, bit
    for bit."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.pytree import flatten_with_names
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.families import get_family
    from repro_torch.parallel import plan_for

    args = launch_train._parse(argv)
    cfg = launch_train.launch_config(args)
    plan = plan_for(make_debug_mesh(model=args.model_parallel, device=dev),
                    fsdp=args.fsdp)
    params, axes = get_family(cfg).init(torch.Generator(dev).manual_seed(1),
                                        cfg)
    opt = launch_train.adamw(launch_train.cosine_warmup(1e-3, 1, 2))
    local, _, sh = launch_train._local_state(params, axes, opt, plan)
    del params
    t0 = time.perf_counter()
    state, _ = CheckpointManager(ckpt_dir).restore_latest(local, shardings=sh)
    seconds = time.perf_counter() - t0
    steps = CheckpointManager(ckpt_dir).steps()
    split = dict(flatten_with_names(sh))
    same = n = 0
    saved = npz_views(f"{ckpt_dir}/step_{steps[-1]}/arrays.npz")
    for name, leaf in flatten_with_names(state):  # a leaf at a time
        if name == "step":
            continue
        n += 1
        same += bool(np.array_equal(leaf.cpu().numpy(),
                                    split[name].local(saved[name])))
    del saved
    return {"step": int(state["step"]), "same": same, "leaves": n,
            "seconds": seconds}


def rest_free(torch, dev):
    """The card's cached blocks and the pinned host buffers gloo stages
    CUDA tensors through (the host allocator keeps them, and the
    machine's host memory is shared by every rank and file)."""
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        empty_host = (getattr(torch._C, "_host_emptyCache", None)
                      or getattr(torch._C, "_accelerator_emptyHostCache",
                                 None))
        if empty_host is not None:
            empty_host()


def rest_world_rank(rank, world, cases, ckpt_dir, device):
    """One rank of a 5n world: each of ``cases`` in turn (`rest_case`,
    memory freed between them), then, with ``ckpt_dir``, (e): an
    uninterrupted 3-step TP-2 run, 2 steps and a save, a restore and step
    3, and the checkpoint restored by an FSDP-2 plan."""
    import torch

    dev = _rest_card(torch, device)

    def free():
        rest_free(torch, dev)

    import shutil

    import torch.distributed as dist

    def drop(path):
        """Remove ``path`` once every rank is done with it: the machine's
        files and processes share its host memory."""
        dist.barrier()
        if rank == 0:
            shutil.rmtree(path, ignore_errors=True)

    out = {"cases": []}
    for case in cases:
        out["cases"].append(rest_case(rank, case, dev))
        free()
        if case["drop_ref"]:
            drop(case["ref_dir"])
    if ckpt_dir is None:
        return out
    tp = REST_CKPT_ARGV + ["--model-parallel", "2", "--ckpt-every", "2"]
    ck = tp + ["--ckpt-dir", ckpt_dir]
    for key, argv in (("whole", tp + ["--steps", "3"]),
                      ("first", ck + ["--steps", "2"]),
                      ("second", ck + ["--steps", "1"])):
        out[key] = rest_train(argv, dev, compared=key != "first")
        free()
    drop(f"{ckpt_dir}/step_2")  # the restores read the latest, step 3
    out["restored"] = rest_restore(
        REST_CKPT_ARGV + ["--model-parallel", "1", "--fsdp"], ckpt_dir, dev)
    return out


def scale_out_rest_path(torch, np, dev, smi):
    """Phase 5n: (a) RWKV-6 3B at a model axis of 16, (b) Whisper-tiny,
    (c) RecurrentGemma-9B, (d) Llama-3.2-Vision-11B fed by the P²M
    frontend, each tensor- or fully-sharded against the single process in
    float64, (e) sharded checkpoints across layouts, (f) the census's
    per-rank bytes against each world's.  Returns every kernel's
    launches on the path (the ranks' sums) and the worlds' walls."""
    import gc
    import os
    import shutil
    import tempfile

    from repro_torch.kernels.p2m_conv import tune
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.world import spawn_world
    from repro_torch.tree import tree_leaves, tree_map

    device = dev.type
    launches = {name: 0 for name in kernel_counts()}
    walls = {}
    # the ranks' allocator maps what it needs (two ranks' float64 checks
    # of RecurrentGemma's 256000-row tables, ~35 GB a rank, share one card
    # with room to spare only without the caching allocator's split
    # blocks)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    def spawn(tag, fn, n, args):
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            print(f"[5n] {tag}: the parent holds "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
                  f"the host has {host_available_gb():.1f} GB available")
        t0 = time.perf_counter()
        res = spawn_world(fn, n, backend="gloo", args=(*args, device),
                          cuda_index=0 if device == "cuda" else None,
                          timeout=REST_TIMEOUT)
        walls[tag] = time.perf_counter() - t0
        return res

    def add(counts):
        for name, k in counts.items():
            launches[name] += k

    def census_line(tag, rank, res):
        print(f"[5n] (f) {tag} rank {rank}: the rank's state "
              f"{res['state_bytes']} bytes, the census's argument bytes "
              f"{res['census_bytes']} for the same arch, shape and mesh")
        check(res["state_bytes"] == res["census_bytes"], f"5n (f) {tag} "
              f"rank {rank}: state {res['state_bytes']} bytes, census "
              f"{res['census_bytes']}")

    # the single process's references of (b)-(d), written under ``root``;
    # then the (a) world, which also runs (b)'s TP-4 case, one world of
    # two ranks for every two-rank case and the checkpoints
    root = tempfile.mkdtemp(prefix="rest-")
    refs, tune_entries = {}, [None]

    def reference(arch, layers):
        """The single process's float64 loss, decode logits and (written
        under ``root``) gradients of ``arch``, for the worlds' cases."""
        cfg = rest_config(torch, arch, layers)
        emb = None
        if cfg.family == "vlm":
            reset_kernel_counts()
            emb = rest_frontend(torch, dev)
            tune_entries[0] = tune.cache_entries()
            reset_kernel_counts()
        t0 = time.perf_counter()
        weights = tree_map(lambda t: t.double(), rest_weights(torch, dev, cfg))
        inputs = rest_inputs(torch, np, dev, cfg, REST_ROWS[arch], emb)
        seq = inputs["seq"]
        if cfg.family == "vlm":  # greedy tokens after the prompt
            seq = seq.clone()
            for i in range(REST_PROMPT, seq.shape[1]):
                lg = rest_forward(torch, cfg, weights, seq[:, :i],
                                  inputs["embeds"])
                seq[:, i] = lg[:, -1].argmax(-1)
        want = rest_forward(torch, cfg, weights, seq, inputs["embeds"])
        loss, grads = rest_grads(torch, cfg, weights, inputs["batch"])
        n_params = sum(t.numel() for t in tree_leaves(weights))
        del weights, inputs, emb
        t1 = time.perf_counter()
        ref = f"{root}/{arch}"
        os.mkdir(ref)
        scales = save_reference(np, grads, ref)
        del grads
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        refs[arch] = {"cfg": cfg, "loss": loss, "want": want.cpu().numpy(),
                      "seq": seq.cpu().numpy(), "ref_dir": ref,
                      "scales": scales}
        print(f"[5n] reference {cfg.name}: full width, {cfg.n_layers} layers, "
              f"{n_params} parameters, float64 single process: loss "
              f"{loss:.9f}, {seq.shape[1]} decode positions; "
              f"{t1 - t0:.2f} s on the card, {time.perf_counter() - t1:.2f} s "
              f"to write its gradients ({4 * n_params / 1e9:.2f} GB)")
        del want

    def world_cases(n):
        return [{"tag": tag, "arch": arch, "layers": layers, "model": model,
                 "fsdp": fsdp, "decode": decode, "tune": tune_entries[0],
                 "ref_dir": refs[arch]["ref_dir"],
                 "scales": refs[arch]["scales"], "seq": refs[arch]["seq"]}
                for tag, arch, layers, ranks_n, model, fsdp, decode
                in REST_WORLDS if ranks_n == n]

    try:
        # (a) RWKV-6 3B, 1 of 32 layers, model axis 16
        args = launch_train._parse(REST_RWKV_ARGV)
        cfg = launch_train.launch_config(args)
        c64 = cfg.replace(dtype=torch.float64)
        heads, world = cfg.n_rwkv_heads, args.world
        want_shape = (args.batch, args.seq, heads, cfg.rwkv_head_dim)
        reference(WHISPER_ARCH, None)
        cases = {world: world_cases(world)}
        ref = f"{root}/a"
        os.mkdir(ref)
        weights = tree_map(lambda t: t.double(), rest_weights(torch, dev, cfg))
        loss64, grads = rest_grads(torch, c64, weights,
                                   lm_batch(torch, dev, cfg.vocab))
        del weights
        scales = save_reference(np, grads, ref)
        del grads
        print(f"[5n] (a) RWKV-6 3B at full width, {cfg.n_layers} of 32 layers "
              f"({cfg.param_count_estimate() / 1e9:.2f} B params by the "
              f"reference's count), model axis {world}: {cfg.d_model} "
              f"columns split ({cfg.d_model // world} a rank), {heads} heads "
              f"whole (every rank runs them); single process float64 loss "
              f"{loss64:.9f}")
        for case in cases[world]:  # its reference serves the later world
            case["drop_ref"] = False
        ranks = spawn("(a) TP 16", rest_rwkv_rank, world,
                      (REST_RWKV_ARGV, ref, scales, cases[world]))
        shutil.rmtree(ref)
        for rank, res in enumerate(ranks):
            err = abs(res["f64_loss"] - loss64) / abs(loss64)
            check(err <= REST_TOL and res["grad_err"] <= REST_TOL,
                  f"5n (a) rank {rank}: loss {err}, gradient {res['grad_worst']} "
                  f"{res['grad_err']}")
            check(res["b7_shapes"] == [want_shape] and res["b7_calls"] > 0
                  and res["launches"]["wkv_fused"] == res["b7_calls"],
                  f"5n (a) rank {rank}: B7 {res['b7_calls']} calls at "
                  f"{res['b7_shapes']}, {res['launches']['wkv_fused']} launches")
            check(res["shapes_agree"] and all(np.isfinite(res["losses"])),
                  f"5n (a) rank {rank}: shapes {res['shapes_agree']}, losses "
                  f"{res['losses']}")
            check(res["losses"] == ranks[0]["losses"], f"5n (a) rank {rank}: "
                  f"losses {res['losses']} vs rank 0's {ranks[0]['losses']}")
            census_line("(a)", rank, res)
            add(res["launches"])
        res = ranks[0]
        print(f"[5n] (a) every rank: B7 at {res['b7_shapes']} (all {heads} "
              f"heads), {res['b7_calls']} calls in the AdamW step (forward and "
              f"remat recompute); loss {res['losses']}; float64 loss vs the "
              f"single process {abs(res['f64_loss'] - loss64) / abs(loss64):.3e}"
              f", {res['n_leaves']} gradient leaves, worst "
              f"{max(r['grad_err'] for r in ranks):.3e} of its largest |g| "
              f"({res['grad_worst']}; limit {REST_TOL}); rank 0's peak "
              f"{res['peak_gb']:.2f} GB, step {res['seconds']:.2f} s; world "
              f"wall {walls['(a) TP 16']:.2f} s, {smi}, {world} ranks sharing "
              f"one card over gloo (not a scaling figure)")

        # (b)-(e)
        for arch, layers in REST_ARCHS:
            if arch not in refs:
                reference(arch, layers)
        cases[2] = world_cases(2)
        order = cases[2]
        for i, case in enumerate(order):
            case["drop_ref"] = all(c["arch"] != case["arch"]
                                   for c in order[i + 1:])
        ckpt = f"{root}/ckpt"
        pair = spawn("(b)-(e) two ranks", rest_world_rank, 2,
                     (cases[2], ckpt))
        results = [(case, [r["cases"][i] for r in pair])
                   for i, case in enumerate(cases[2])]
        results += [(case, [r["cases"][i] for r in ranks])
                    for i, case in enumerate(cases[world])]
        for case, ranks in results:
            tag, ref = case["tag"], refs[case["arch"]]
            cfg, loss, want = ref["cfg"], ref["loss"], ref["want"]
            logits = ranks[0]["logits"]
            decoded = "no decode"
            if case["decode"]:
                scale = float(np.abs(want).max())
                logit_err = float(np.abs(logits - want).max()) / scale
                same = int((logits.argmax(-1) == want.argmax(-1)).sum())
                check(logit_err <= REST_TOL, f"5n {tag}: decode logits "
                      f"{logit_err} of the largest")
                kind = ("teacher-forced" if cfg.family != "vlm" else
                        f"{REST_PROMPT} prompt + {REST_NEW} greedy")
                decoded = (f"{logits.shape[1]} decode steps ({kind}) logits "
                           f"{logit_err:.3e} of the largest |float64 forward "
                           f"logit|, {same} of "
                           f"{logits.shape[0] * logits.shape[1]} argmax equal")
            for rank, res in enumerate(ranks):
                err = abs(res["loss"] - loss) / abs(loss)
                check(err <= REST_TOL and res["grad_err"] <= REST_TOL,
                      f"5n {tag} rank {rank}: loss {err}, gradient "
                      f"{res['grad_worst']} {res['grad_err']}")
                census_line(tag, rank, res)
                add(res["launches"])
                b12 = (res["frontend"]["p2m_conv_fused"]
                       + res["frontend"]["p2m_conv_fused_pipelined"])
                check(b12 == (1 if cfg.family == "vlm" else 0),
                      f"5n {tag} rank {rank}: the frontend launched B1/B2 "
                      f"{b12} times")
                others = {k: v for k, v in res["launches"].items()
                          if k not in ("p2m_conv_fused",
                                       "p2m_conv_fused_pipelined") and v}
                check(not others, f"5n {tag} rank {rank}: launched {others}")
            print(f"[5n] {tag}: {cfg.name}, mesh ({len(ranks) // case['model']}"
                  f", {case['model']}): every rank's float64 loss within "
                  f"{max(abs(r['loss'] - loss) / abs(loss) for r in ranks):.3e}"
                  f" (relative), {ranks[0]['n_leaves']} gradient leaves, worst "
                  f"{max(r['grad_err'] for r in ranks):.3e} of its largest |g| "
                  f"({ranks[0]['grad_worst']}; limit {REST_TOL}); {decoded}; "
                  f"B1/B2 {ranks[0]['frontend']['p2m_conv_fused']} + "
                  f"{ranks[0]['frontend']['p2m_conv_fused_pipelined']} a rank"
                  f"; rank 0 {ranks[0]['seconds']:.2f} s, peak "
                  f"{ranks[0]['peak_gb']:.2f} GB, the host's available "
                  f"memory after it {ranks[0]['host_gb']:.1f} GB; {smi}")

        # (e) sharded checkpoints: RWKV-6 3B, 2 of 32 layers, TP 2
        for rank, res in enumerate(pair):
            a, b = res["whole"], res["second"]
            check(b["step"] == 3 and a["digest"] == b["digest"]
                  and a["losses"][-1] == b["losses"][-1],
                  f"5n (e) rank {rank}: resumed step {b['step']}, loss "
                  f"{b['losses']} vs {a['losses']}")
            census_line("(e) 3 steps", rank, a)
            census_line("(e) resumed", rank, b)
            for key in ("whole", "first", "second"):
                check(res[key]["launches"]["wkv_fused"] > 0, f"5n (e) rank "
                      f"{rank}: B7 never launched in the {key} run")
                add(res[key]["launches"])
            r = res["restored"]
            check(r["step"] == 3 and r["same"] == r["leaves"],
                  f"5n (e) FSDP rank {rank}: {r['same']} of {r['leaves']} "
                  f"leaves equal the saved ones")
        first = pair[0]
        print(f"[5n] (e) TP 2: 2 steps and a save, then a restore and step "
              f"3: its loss {first['second']['losses']} and every rank's "
              f"state (sha256 {first['second']['digest'][:16]}...) equal an "
              f"uninterrupted 3-step run's bit for bit; B7 "
              f"{[r['whole']['launches']['wkv_fused'] for r in pair]} a rank "
              f"in the 3 steps; runs {first['whole']['seconds']:.2f}, "
              f"{first['first']['seconds']:.2f}, "
              f"{first['second']['seconds']:.2f} s (rank 0, host clock)")
        # and into one process
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.common.pytree import flatten_with_names
        from repro_torch.models.families import get_family
        from repro_torch.train import TrainState

        cfg = launch_train.launch_config(launch_train._parse(REST_CKPT_ARGV))
        params, _ = get_family(cfg).init(torch.Generator(dev).manual_seed(1),
                                         cfg)
        opt = launch_train.adamw(launch_train.cosine_warmup(1e-3, 1, 2))
        t0 = time.perf_counter()
        state, _ = CheckpointManager(ckpt).restore_latest(
            TrainState(params, opt.init(params)))
        one_s = time.perf_counter() - t0
        del params
        saved = npz_views(f"{ckpt}/step_3/arrays.npz")
        names = [k for k in saved if k != "step"]
        same = sum(bool(np.array_equal(leaf.cpu().numpy(), saved[name]))
                   for name, leaf in flatten_with_names(state)
                   if name != "step")  # a leaf at a time
        del saved
        n_leaves = len(names)
        check(state["step"] == 3 and same == n_leaves, f"5n (e) one process: "
              f"{same} of {n_leaves} leaves equal the saved ones")
        gb = tree_bytes({k: v for k, v in state.items() if k != "step"}) / 1e9
        del state
        print(f"[5n] (e) the step-3 checkpoint ({gb:.2f} GB) restored into "
              f"an FSDP-2 plan ({pair[0]['restored']['same']} and "
              f"{pair[1]['restored']['same']} of "
              f"{pair[0]['restored']['leaves']} leaves a rank equal the "
              f"saved slices bit for bit, {pair[0]['restored']['seconds']:.2f}"
              f" s) and into one process ({same} of {n_leaves} leaves equal, "
              f"{one_s:.2f} s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    others = {k: v for k, v in launches.items()
              if k not in ("p2m_conv_fused", "p2m_conv_fused_pipelined",
                           "wkv_fused")}
    check(not any(others.values()), f"5n: a kernel besides B1/B2 and B7 "
          f"launched: {others}")
    print(f"[5n] kernel launches on the path (every rank): {launches}; "
          f"world walls {walls}")
    if alloc is None:
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
    else:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    return {"launches": launches, "walls": walls}


def scale_out_rest_only(torch, np, dev) -> int:
    """``chip_smoke.py --scale-out-rest``: phase 1, the builds of
    ``p2m_conv.cu`` and ``wkv.cu`` and phase 5n alone."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.p2m_conv import conv
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(wkv_kernel.build_wkv)]:
            job.result()
    for name in ("p2m_conv", "wkv"):
        print(f"[2] {name}.cu: nvcc {_build.BUILD_INFO[name][0]:.2f} s")
    t0 = time.perf_counter()
    print(json.dumps(scale_out_rest_path(torch, np, dev, smi)))
    print(f"[5n] {time.perf_counter() - t0:.1f} s")
    print(smi)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32

    PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = HBM_BW, PEAK_FLOPS_FP32
    if sys.argv[1:] == ["--scale-out"]:
        return scale_out_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--lm-scale-out"]:
        return lm_scale_out_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--scale-out-rest"]:
        return scale_out_rest_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--b4"]:
        return b4_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--b1b6"]:
        return b1b6_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--lm-train"]:
        return lm_train_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--door"]:
        return door_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--dense"]:
        return dense_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--moe-rglru"]:
        return moe_rglru_only(torch, np, torch.device("cuda"))
    if sys.argv[1:] == ["--multimodal"]:
        return multimodal_only(torch, np, torch.device("cuda"))

    from repro_torch.configs.p2m_vww import (
        CONFIG,
        SERVE_MAX_BATCH,
        TRAIN_BATCH,
    )
    from repro_torch.core.p2m_conv import apply_p2m_conv_deploy
    from repro_torch.data import SyntheticVWW
    from repro_torch.kernels import _build
    from repro_torch.configs import get_config
    from repro_torch.kernels.p2m_conv import backward, conv, gated, tune
    from repro_torch.kernels.p2m_conv import kernel as mm_kernel
    from repro_torch.kernels.p2m_conv.ops import _coeff_tuple
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
    from repro_torch.models.mobilenetv2 import (
        apply_mnv2_backbone,
        apply_mnv2_stem,
        init_mnv2,
    )
    from repro_torch.serving import VisionEngine, VisionRequest, drive

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()

    def stamp(phase):
        """How far into the run a phase ended (host clock)."""
        print(f"[t] {phase} done at {time.perf_counter() - started:.1f} s")

    # ------------------------------------------------------- phase 1
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    # ------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:  # one nvcc per source, together
        for job in [pool.submit(conv.build_p2m_conv),
                    pool.submit(backward.build_p2m_bwd),
                    pool.submit(mm_kernel.build_p2m_matmul),
                    pool.submit(wkv_kernel.build_wkv)]:
            job.result()
    print(f"[2] built the four sources in {time.perf_counter() - t0:.2f} s "
          "with loading")
    for name in ("p2m_conv", "p2m_bwd", "p2m_matmul", "wkv"):
        seconds, report = _build.BUILD_INFO[name]
        print(f"[2] {name}.cu: nvcc {seconds:.2f} s")
        for line in ptxas_summary(report):
            print(f"    ptxas: {line}")

    # ------------------------------------------------------- phase 3
    gen = torch.Generator().manual_seed(SEED)
    params, bn = init_mnv2(gen, CONFIG, device=dev)
    engine = VisionEngine(params, bn, CONFIG, device=dev)
    cfg = CONFIG.p2m
    k, s, adc = cfg.kernel, cfg.stride, cfg.adc
    size = CONFIG.image_size
    B = SERVE_MAX_BATCH
    paper_imgs = torch.from_numpy(SyntheticVWW(
        image_size=size, batch=B, seed=SEED).batch_at(0)["images"]).to(dev)
    wrows = engine._deploy["wrows"]
    shift = engine._deploy["shift"].float().contiguous()
    rng = np.random.default_rng(SEED)

    def rand_case(b, h, w, c, kk, n):
        imgs = torch.from_numpy(rng.random((b, h, w, c), np.float32)).to(dev)
        wt = torch.from_numpy(rng.uniform(-0.4, 0.4, (kk * kk * c, n)).astype(
            np.float32))
        coeffs = tuple(tuple(float(v) for v in row)
                       for row in engine._pixel_model.coeffs)
        wr = conv.premix_rows(wt, coeffs, kk).to(dev)
        sh = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
            np.float32)).to(dev)
        return imgs, wr, sh

    general = rand_case(2, 64, 64, 3, 5, 8)
    ragged5 = rand_case(3, 37, 41, 3, 4, 5)
    ragged16 = rand_case(3, 37, 41, 3, 4, 16)
    cases = [  # name, inputs, kernel, stride, mode, want_raw
        ("paper raw", (paper_imgs, wrows, shift), k, s, "raw", False),
        ("paper relu", (paper_imgs, wrows, shift), k, s, "relu", False),
        ("paper quant", (paper_imgs, wrows, shift), k, s, "quant", False),
        ("paper quant+raw", (paper_imgs, wrows, shift), k, s, "quant", True),
    ]
    for mode in ("raw", "relu", "quant"):
        cases += [("k5 s3 " + mode, general, 5, 3, mode, True),
                  ("N5 ragged " + mode, ragged5, 4, 4, mode, True),
                  ("N16 ragged " + mode, ragged16, 4, 3, mode, True)]
    paper_err = 0.0
    for name, (x, wr, sh), kk, ss, mode, want_raw in cases:
        kw = dict(kernel=kk, stride=ss, mode=mode, v_lsb=adc.v_lsb,
                  max_count=adc.max_count)
        got = conv.p2m_conv_fused(x, wr, sh, want_raw=want_raw, **kw)
        torch.cuda.synchronize()
        out, raw = got if want_raw else (got, None)
        ref_out, ref_raw = conv.p2m_conv_premixed_plain(x, wr, sh,
                                                        want_raw=True, **kw)
        err = float((out - ref_out).abs().max())
        line = f"[3] {name:18s} {tuple(out.shape)} max_abs_err {err:.3e}"
        if raw is not None:
            raw_err = float((raw - ref_raw).abs().max())
            line += f" raw_err {raw_err:.3e}"
            check(raw_err <= RAW_TOL, f"{name}: raw differs by {raw_err}")
        if mode == "quant":
            rep = conv.quant_disagreement(out, ref_out, ref_raw, adc.v_lsb)
            line += (f" counts_differing {rep['n_diff']} "
                     f"(share {rep['share']:.2e}, max "
                     f"{rep['max_count_diff']:.0f})")
            check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
                  and rep["all_near_half"],
                  f"{name}: quant counts disagree: {rep}")
        else:
            check(err <= RAW_TOL, f"{name}: differs by {err}")
        if name.startswith("paper") and mode != "quant":
            paper_err = max(paper_err, err)
        if name.startswith("paper") and raw is not None:
            paper_err = max(paper_err, raw_err)
        print(line)

    stamp("3")
    gated_err = check_gated_kernel(torch, np, dev,
                                   paper_imgs[:4].contiguous(), wrows, shift,
                                   rand_case, adc)
    wkv_err, wkv_in = check_wkv_kernel(torch, np, dev)
    serve_in = (paper_imgs, wrows, shift)
    pipe_err = check_pipelined_kernel(torch, np, dev, serve_in, adc)
    check_pipelined_grads(torch, np, dev)
    coeffs = _coeff_tuple(engine._pixel_model)
    sig = (size, size, 3, cfg.out_channels, k, s, coeffs)
    tuned = tune_signatures(torch, dev, {
        "serving": (B, *sig, "quant"),
        "stream": (4, *sig, "quant"),
        "training": (TRAIN_BATCH, *sig, "raw")})
    mm_err = check_matmul_kernel(torch, np, dev, adc)

    stamp("3b-3g")
    # ------------------------------------------------------- phase 4
    bwd_err, bwd = check_backward_kernels(torch, np, dev)

    # ------------------------------------------------------- phase 5
    n_req = 24
    data = SyntheticVWW(image_size=size, batch=n_req, seed=SEED + 1)
    images = data.batch_at(0)["images"]

    def vision_requests():
        return [VisionRequest(uid=i, image=images[i], arrival_tick=t)
                for i, t in enumerate(VISION_ARRIVALS)]

    reset_stem_launches(conv)
    t0 = time.perf_counter()
    drive(engine, vision_requests(), on_undrained="raise")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    serve_launches = stem_launches(conv)
    launches = sum(serve_launches.values())
    done = engine.completed
    check([r.uid for r in done] == list(range(n_req)),
          f"completion order {[r.uid for r in done]}")
    check(not engine.failed and not engine.evicted,
          f"failed {len(engine.failed)}, evicted {len(engine.evicted)}")
    check(launches == engine.stats["launches"] and launches > 0,
          f"kernel launches {serve_launches} != engine launches "
          f"{engine.stats['launches']}")
    vision_probs = {r.uid: r.probs for r in done}
    probs = np.stack([r.probs for r in done])
    check(probs.shape == (n_req, CONFIG.num_classes)
          and bool(np.isfinite(probs).all()), "probs not finite")
    batches: dict[int, list] = {}
    for r in done:
        batches.setdefault(r.served_tick, []).append(r)
    worst = 0.0
    for tick, group in sorted(batches.items()):
        x = np.zeros((B, size, size, 3), np.float32)
        for i, r in enumerate(group):
            x[i] = r.image
        plain = engine.forward(torch.from_numpy(x).to(dev),
                               p2m_impl="plain").cpu().numpy()
        diff = float(np.abs(plain[:len(group)] -
                            np.stack([r.probs for r in group])).max())
        worst = max(worst, diff)
        print(f"[5] tick {tick}: batch of {len(group)}, probs vs plain stem "
              f"max diff {diff:.3e}")
        check(diff <= PROBS_TOL, f"tick {tick}: probs differ by {diff}")
    # The stem against the patch-materializing reference conv (no premix).
    dep = engine._deploy
    stem_k = apply_p2m_conv_deploy(dep, paper_imgs, cfg, impl="cuda")
    stem_p = apply_p2m_conv_deploy(dep, paper_imgs, cfg, impl="patches")
    _, stem_raw = conv.p2m_conv_premixed_plain(
        paper_imgs, wrows, torch.zeros_like(shift), kernel=k, stride=s,
        mode="raw", want_raw=True)
    rep = conv.quant_disagreement(stem_k, stem_p, stem_raw, adc.v_lsb)
    print(f"[5] served {len(done)} requests in {engine.stats['launches']} "
          f"launches ({main_s:.2f} s) with the tuned stem "
          f"{tuned['serving']['best']}, kernel launches {serve_launches}; "
          f"stem vs patches reference: {rep['n_diff']} counts differ")
    check(rep["max_count_diff"] <= 1 and rep["share"] <= 1e-4
          and rep["all_near_half"], f"stem vs patches: {rep}")
    mm_launches = matmul_path(torch, np, dev, engine, paper_imgs, adc)
    pass_launches = engine_b2_pass(torch, np, dev, params, bn,
                                   vision_requests, tuned["serving"]["key"])

    stamp("4-5e")
    stream = stream_path(torch, np, dev, params, bn)
    stamp("5b")

    lm = lm_path(torch, np, dev,
                 get_config(LM_ARCH).replace(dtype=torch.float32))
    stamp("5c")
    door = door_path(
        torch, np, dev, lm,
        {"params": params, "bn": bn, "images": images,
         "probs": vision_probs},
        {r.uid: r.frame_outputs for r in stream["gated"].completed}, smi)
    stamp("5h")
    check_faults(torch, np, dev)
    lm_train = lm_train_path(torch, np, dev, lm)
    stamp("5f-5g")
    dense = dense_path(torch, np, dev, smi)
    stamp("5i")
    moe_rglru = moe_rglru_path(torch, np, dev, smi)
    stamp("5j")
    multimodal = multimodal_path(torch, np, dev, smi)
    stamp("5k")

    # ------------------------------------------------------- phase 6
    train = train_path(torch, np, dev)

    # ------------------------------------------------------- phase 7
    grad_parity(torch, train)

    # ------------------------------------------------------- phase 8
    fold_and_serve(torch, np, dev, train)
    stamp("6-8")

    # ------------------------------------------------------- phase 9
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    qkw = dict(kernel=k, stride=s, mode="quant", v_lsb=adc.v_lsb,
               max_count=adc.max_count)
    counted = conv.p2m_conv_fused.launches
    counted_b2 = conv.p2m_conv_fused.launches_pipelined
    kernel_ms = cuda_ms(torch, lambda: conv.p2m_conv_fused(
        paper_imgs, wrows, shift, **qkw), flush)
    wrapper_ms = wall_ms(torch, lambda: conv.p2m_conv_fused(
        paper_imgs, wrows, shift, **qkw), flush)
    plain_ms = cuda_ms(torch, lambda: conv.p2m_conv_premixed_plain(
        paper_imgs, wrows, shift, **qkw), flush)
    conv.p2m_conv_fused.launches = counted  # timing launches are not the path's
    library = conv2d_yardstick(torch, paper_imgs, wrows, k, s)
    _, ker_raw = conv.p2m_conv_fused(paper_imgs, wrows, shift, want_raw=True,
                                     **qkw)
    conv.p2m_conv_fused.launches = counted
    lib_err = float((library().permute(0, 2, 3, 1) - ker_raw).abs().max())
    check(lib_err <= 1e-4, f"library yardstick computes another function "
          f"({lib_err})")
    library_ms = cuda_ms(torch, library, flush)
    n = wrows.shape[2]
    ho = wo = cfg.out_spatial(size)
    m = B * ho * wo
    bytes_moved = 4 * (paper_imgs.numel() + wrows.numel() + shift.numel()
                       + m * n)
    flops = 2 * m * k * wrows.shape[1] * n
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f"[9] p2m_conv_fused at ({B},{size},{size},3) k=s={k} N={n} quant: "
          f"kernel {kernel_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms (host), "
          f"plain {plain_ms:.4f} ms, library conv2d {library_ms:.4f} ms "
          f"(raw err {lib_err:.1e}); bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved} bytes, {flops} FLOP)")
    b1_geo = conv.b1_launch(tuple(paper_imgs.shape), n,
                            wrows.shape[1] // (k * paper_imgs.shape[3]),
                            kernel=k, stride=s)
    check(b1_geo["local_bytes"] == 0,
          f"B1 uses local memory a thread: {b1_geo}")
    b1_read_ms = cuda_ms(torch, paper_imgs.amax, flush)
    print(f"[9] p2m_conv_fused (B1) launch: {b1_geo['tiles']} tiles of "
          f"{b1_geo['tile_px']} pixels over {b1_geo['blocks_x']} x "
          f"{b1_geo['blocks_y']} blocks of {b1_geo['threads']} threads "
          f"({b1_geo['pixels_per_thread']} pixels a thread), "
          f"{b1_geo['smem_bytes']} B dynamic shared memory, "
          f"{b1_geo['blocks_per_sm']} blocks an SM, {b1_geo['registers']} "
          f"registers, {b1_geo['local_bytes']} B local; one read of the "
          f"images (amax) {b1_read_ms:.4f} ms")
    # Engine time per launch, warm: five full microbatches.
    before_l, before_us = engine.stats["launches"], engine.stats["wall_us"]
    warm = [VisionRequest(uid=100 + i, image=images[i % n_req])
            for i in range(5 * B)]
    drive(engine, warm, on_undrained="raise")
    n_launch = engine.stats["launches"] - before_l
    engine_ms = (engine.stats["wall_us"] - before_us) / n_launch / 1e3
    first_ms = engine.completed[0].launch_wall_us / 1e3
    print(f"[9] engine: {engine_ms:.3f} ms per launch of {B} images "
          f"(warm, {n_launch} launches, tuned stem "
          f"{tuned['serving']['best']}); first launch {first_ms:.3f} ms "
          f"(the tuner ran before it: "
          f"{tuned['serving']['first_call_s'] * 1e3:.1f} ms at this "
          f"signature, phase 3f)")
    # Where a warm launch goes, each part timed alone as `_launch` runs
    # it: the host assembles the batch and copies it to the card, then
    # the stem and the backbone run.
    def batch_to_card():
        x = np.zeros((B, size, size, 3), np.float32)
        for i in range(B):
            x[i] = images[i]
        return torch.from_numpy(x).to(dev)

    host_ms = wall_ms(torch, batch_to_card, flush)
    xdev = batch_to_card()
    with torch.inference_mode():
        stem_out, _ = apply_mnv2_stem(engine._params, engine._bn, xdev,
                                      CONFIG, p2m_deploy=engine._deploy)
        stem_ms = cuda_ms(torch, lambda: apply_mnv2_stem(
            engine._params, engine._bn, xdev, CONFIG,
            p2m_deploy=engine._deploy), flush)
        backbone_ms = cuda_ms(torch, lambda: apply_mnv2_backbone(
            engine._params, engine._bn, stem_out, CONFIG), flush)
    conv.p2m_conv_fused.launches = counted
    conv.p2m_conv_fused.launches_pipelined = counted_b2
    print(f"[9] launch parts: host batch + copy {host_ms:.3f} ms, stem "
          f"{stem_ms:.3f} ms, backbone {backbone_ms:.3f} ms (device, "
          f"launch gaps included); sum "
          f"{host_ms + stem_ms + backbone_ms:.3f} of {engine_ms:.3f} ms")

    b1_row = {"plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "read_ms": b1_read_ms, "launch": b1_geo}
    pipe_row = time_pipelined(torch, np, dev, flush, serve_in, adc, tuned,
                              b1_row)
    mm_row = time_matmul(torch, np, dev, flush, adc)
    gated_row = time_stream(torch, np, dev, stream, flush, adc)
    bwd_rows = time_backward_kernels(torch, bwd, flush)
    time_train_step(torch, train, flush)
    wkv_row = time_lm(torch, np, dev, lm, wkv_in, flush)
    del flush
    # The multi-process phases come after the timings: a B7 read after
    # 5m's worlds took 1.19x the one before them (PERF.md §6).
    stamp("9")
    scale_out = scale_out_path(torch, np, dev, smi)
    stamp("5l")
    lm_scale_out = lm_scale_out_path(torch, np, dev, smi, lm)
    stamp("5m")
    # 5n needs the card: keep the counts the kernel line reads, free the
    # served LM and the door's engines
    door_counts = {name: door_launches(door, name) for name in door["counts"]}
    lm_launches = lm["launches"]
    del door, lm
    rest = scale_out_rest_path(torch, np, dev, smi)["launches"]
    stamp("5n")

    # ------------------------------------------------------- phase 10
    # B1 and B2 run, as the tuner picks, on the serving run, the training
    # run and the stream run's where path; the two forced passes of phase
    # 5e run each once through the engine.
    stem_paths = {}
    for name in ("p2m_conv_fused", "p2m_conv_fused_pipelined"):
        stem_paths[name] = {
            "serve": serve_launches[name],
            "serve_forced": pass_launches["B1" if name == "p2m_conv_fused"
                                          else "B2"][name],
            "train": train["launches"][name],
            "stream": stream["where_launches"][name],
            "door": door_counts[name],
            "frontend": multimodal["launches"][name],
            "scale_out": scale_out["launches"][name],
            "lm_scale_out": lm_scale_out["launches"][name],
            "scale_out_rest": rest[name]}
        check(sum(stem_paths[name].values()) > 0,
              f"{name} launched no time on the main paths")
    kernels = [{
        "name": "p2m_conv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/conv.py:466",
        "launches": sum(stem_paths["p2m_conv_fused"].values()),
        "launches_by_path": stem_paths["p2m_conv_fused"],
        "max_abs_err": paper_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "read_ms": b1_read_ms,
        "launch": b1_geo,
    }, {
        "name": "p2m_conv_fused_pipelined",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/conv.py:438",
        "launches": sum(stem_paths["p2m_conv_fused_pipelined"].values()),
        "launches_by_path": stem_paths["p2m_conv_fused_pipelined"],
        "max_abs_err": pipe_err,
        **pipe_row,
    }]
    for name, replaces in (
            ("p2m_bwd_dx", "src/repro/kernels/p2m_conv/backward.py:95"),
            ("p2m_bwd_dw", "src/repro/kernels/p2m_conv/backward.py:176")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_bwd.cu",
            "replaces": replaces,
            "launches": (train["launches"][name]
                         + multimodal["launches"][name]
                         + scale_out["launches"][name]
                         + lm_scale_out["launches"][name] + rest[name]),
            "launches_by_path": {"train": train["launches"][name],
                                 "frontend": multimodal["launches"][name],
                                 "scale_out": scale_out["launches"][name],
                                 "lm_scale_out":
                                     lm_scale_out["launches"][name],
                                 "scale_out_rest": rest[name]},
            "max_abs_err": bwd_err[name],
            **bwd_rows[name],
        })
    b5_stream = sum(stream["launches"][name]
                    for name in gated_launches(gated))
    b5_door = sum(door_counts[name]
                  for name in gated_launches(gated))
    b5_lm_so = sum(lm_scale_out["launches"][name]
                   for name in gated_launches(gated))
    b5_rest = sum(rest[name] for name in gated_launches(gated))
    b5 = b5_stream + b5_door + b5_lm_so + b5_rest
    check(b5_stream > 0 and b5_door > 0,
          "p2m_conv_fused_gated launched no time on a main path")
    kernels.append({
        "name": "p2m_conv_fused_gated",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_conv.cu",
        "replaces": "src/repro/kernels/p2m_conv/gated.py:221",
        # the gated stem runs on the stream path (its default on the card)
        # and the door's stream engine, on the body of the tuner's depth:
        # the ring (launches_pipelined) or B1's
        "launches": b5,
        "launches_pipelined":
            stream["launches"]["p2m_conv_fused_gated_pipelined"]
            + door_counts["p2m_conv_fused_gated_pipelined"],
        "launches_by_path": {"stream": b5_stream, "door": b5_door,
                             "lm_scale_out": b5_lm_so,
                             "scale_out_rest": b5_rest},
        "max_abs_err": gated_err,
        **gated_row,
    })
    kernels.append({
        "name": "p2m_matmul_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p2m_conv/csrc/p2m_matmul.cu",
        "replaces": "src/repro/kernels/p2m_conv/kernel.py:159",
        # the patch-level path of phase 5d
        "launches": (mm_launches + lm_scale_out["launches"]["p2m_matmul_fused"]
                     + rest["p2m_matmul_fused"]),
        "launches_by_path": {
            "patches": mm_launches,
            "lm_scale_out": lm_scale_out["launches"]["p2m_matmul_fused"],
            "scale_out_rest": rest["p2m_matmul_fused"]},
        "max_abs_err": mm_err,
        **mm_row,
    })
    kernels.append({
        "name": "wkv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv_wkv/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv/kernel.py:108",
        # the LM path: ServeEngine's and SessionEngine's prefill ticks;
        # the door's LM engine (phase 5h); the LM train steps (forward
        # and recompute, phase 5g (c)); the LM scale-out's ranks (the TP
        # and FSDP train steps on a rank's heads or batch, the sharded
        # engines' prefill ticks on a rank's slots, phase 5m); none on the
        # dense path (5i), the MoE path or the RG-LRU path (5j), the VLM
        # or Whisper (5k)
        "launches": (lm_launches + door_counts["wkv_fused"]
                     + lm_train["launches"] + dense["b7"]
                     + sum(moe_rglru["b7"].values())
                     + multimodal["vlm"]["b7"]
                     + multimodal["encdec"]["b7"]
                     + lm_scale_out["launches"]["wkv_fused"]
                     + rest["wkv_fused"]),
        "launches_by_path": {"lm": lm_launches,
                             "door": door_counts["wkv_fused"],
                             "lm_train": lm_train["launches"],
                             "dense": dense["b7"],
                             "moe": sum(moe_rglru["b7"][name]
                                        for name, _ in MOE_CUT),
                             "rglru": moe_rglru["b7"][RGLRU_ARCH],
                             "vlm": multimodal["vlm"]["b7"],
                             "encdec": multimodal["encdec"]["b7"],
                             "lm_scale_out":
                                 lm_scale_out["launches"]["wkv_fused"],
                             "scale_out_rest": rest["wkv_fused"]},
        "max_abs_err": wkv_err,
        **wkv_row,
    })
    check(len(kernels) == 7, f"{len(kernels)} kernels in the line")
    b7_paths = kernels[-1]["launches_by_path"]
    check(all(b7_paths[path] == 0
              for path in ("dense", "moe", "rglru", "vlm", "encdec")),
          f"B7 launched on a path that has no WKV: {b7_paths}")
    check(b7_paths["lm_scale_out"] > 0
          and all(k["launches_by_path"]["lm_scale_out"] == 0
                  for k in kernels[:-1]),
          "the LM scale-out path launched B7 no time, or another kernel")
    check(b7_paths["scale_out_rest"] > 0
          and sum(k["launches_by_path"]["scale_out_rest"]
                  for k in kernels[:2]) > 0
          and all(k["launches_by_path"]["scale_out_rest"] == 0
                  for k in kernels[2:-1]),
          "the rest of the scale-out launched B7 or B1/B2 no time, or "
          "another kernel")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
