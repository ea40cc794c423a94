"""Smoke run of the PyTorch/CUDA port (`lwdetr_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

1. Builds the kernels of the eval and train paths (K1-K10 and M1, thirteen
   entry symbols in nine sources of `lwdetr_tpu_torch/csrc/`) with nvcc, one
   process per source, all at once, and prints the `-Xptxas -v` register,
   shared-memory and spill report of every template case.
2. Holds each kernel against its plain PyTorch version, in f32 and bf16, at
   every shape a 640x640 path gives it (eval batch 8, train batch 4): K1 and
   K2 at small's, large's and xlarge's (head_dim 16, 32, 64; medium's are
   large's and small's), with one `F.scaled_dot_product_attention` call timed
   on the same inputs (a yardstick the port never calls; `sdpa_ratio`), the
   registers and spilled bytes of the case that ran, and K2's log-sum-exp
   against the plain one; the samplers on one set of inputs (border and
   far-outside queries included) in their three layouts: K3 (channel-major) at
   small's and tiny's eval forward, tiny's "cm" train step and large's two
   levels, K4 (panels) at large's two levels and at small's and tiny's train
   step, K5 at small's, tiny's and large's train shape, K8 at tiny's 1300 and
   small's 3900 train queries and at large's two levels, K3 and K8 also on
   every route of `csrc/deform_cm.cuh` (1001 queries, Q = 1, a map of no
   multiple of 16 bytes, head_dim 32), each with the route its source chose
   (shared bytes, CTAs a map, registers, local bytes), K10 (row-major)
   forward and backward at
   tiny's eval and train shapes, K4 and K10 also at Q = 1001, Q = 1, head_dim
   32 and 64 and four levels, with points on grid lines, far outside and NaN,
   each with its route (work order, tile, threads, shared bytes, registers;
   any local byte fails), each with its call and CUDA-graph device times
   and the reference's F.grid_sample formulation timed on the same values (its
   backward for K5, K8, K10b; a yardstick the port never calls); K6 and K7 at
   small's and medium's train step
   (K6 also at head_dim 64), in bf16 against `bf16_bwd_error_bound`, with
   SDPA's backward, the CUDA-graph device times and the registers and spills
   of every pass beside them; K9 (the short attention
   without a bias) at tiny's decoder, batch 8 and 13 groups x 4, with K2 and
   SDPA on the same inputs, and its backward with SDPA's beside it. M1, the
   matcher's assignment (`csrc/matcher.cu`), against its plain version (the
   same columns) and scipy (the total cost within 1e-5 relative) at small's
   and large's train costs, T = 100 all valid, integer costs (ties), the
   (T, Q) sweep and NaN rows, each launch polled with a time limit; its call,
   CUDA-graph device and plain times, scipy's host time with the copy (what
   the port ran before), registers, shared and local bytes.
3. Drives five eval forwards + `post_process` at 640x640 from
   `init_state_dict(seed=0)`, batch 8, f32: small, then xlarge, large, tiny
   (100 queries) and medium (ViT-small on P4).
   Every launch counter is set to 0 just before a forward and read just after:
   small and medium must launch K1 6 times, K2 7, K3 3 and K4 0; xlarge and
   large K1 6, K2 7, K3 0 and K4 3; tiny K1 3, K2 3, K9 3 and K3 3; no other
   kernel. The same model forced onto the plain versions, and given the same
   two-stage proposal picks (near-tied scores may swap under rounding; the
   picks are compared on their own), gives the reference outputs. The same
   weights in bf16 (float32 parameters, bf16 compute) launch the same
   kernels and, with the same picks, agree with their forward on the plain
   versions over all queries within the bf16 drift ceiling, with float32
   boxes. Then the bf16 throughput of each preset at batch 32
   (`lwdetr_tpu_torch.bench`).
4. Drives the train step of LW-DETR-small at 640x640, f32, batch 4, on one
   synthetic batch with 7 boxes an image: one step's gradients through the
   kernels against the same forward with the plain backward versions, per
   parameter tensor, and against the whole step on the plain versions
   (proposal picks and matching replayed); the launch counts of that step
   (K1 6, K2 7, K3 0, K4 3, K5 3, K6 7, K7 6, M1 1: every train path
   matches once a step); 8 steps with the release optimizer settings (finite
   losses that fall, an EMA that moves); then the step time, img/s, the
   matcher's host time per step (costs built, M1 enqueued), M1's device time
   and peak device memory.
5. Drives the train step of LW-DETR-tiny the same way in each branch of the
   decoder's cross-attention: the default (panels: K1 3, K2 3, K9 3, K4 3,
   K5 3, K6 3, K7 3 with a bias and 3 without), `force_branch="cm"` (K3 3,
   K8 3 in place of K4, K5) and `"gather"` (K10 3 forward, 3 backward). The
   three losses must agree within 1e-4; the default branch takes the
   optimizer steps, and every branch's step is timed. Each branch logs the
   error of every `sampling_offsets.weight` gradient (the first that the
   samplers' d(loc) feeds) against the plain backwards on the same forward.
6. Drives the train step of LW-DETR-medium (ViT-small, head_dim 32) as
   small's: the same launch counts, 4 optimizer steps.
7. Drives the eval entry point on the mAP fixture (`tests/fixtures/micro_map/`,
   20 JPEGs): the micro model in f32 through `lwdetr_tpu_torch.main --eval`
   with a .pth of the fixture's weights, batch 4 (K1 5, K2 5, K9 10, K3 10
   over its 5 batches), its 12 stats within 1e-7 of `golden_stats.json`; in
   bf16, every stat within 0.55 of the f32 golden (the distance to the JAX
   bf16 golden printed); each again on the plain versions with the picks
   replayed, the detections paired by the index `post_process` selected and
   held within the f32 bounds or the bf16 drift ceiling; small at full width,
   bf16, batch 8, seeded weights (K1 18, K2 21, K3 9), its detections against
   the plain versions' within the bf16 drift ceiling, and the eval loop's
   img/s, the loader's share of its wall time and the device's idle share;
   then, on the fixture only, the same over 10 passes with the first left
   out, the loader alone, the step alone and each image's decode and resize.
8. Trains small (640, 13 groups of 300 queries, f32, batch 4, EMA, seeded
   weights as `--pretrain_weights`) through
   `lwdetr_tpu_torch.main` for 2 epochs over a COCO dir whose train2017 and
   val2017 are the fixture's 20 images (`train_cli_phase`): finite losses,
   two log records with the JAX CLI's keys, the checkpoint directories, the
   launches per step and eval batch; resumes from the epoch-0 save (the
   restored state equal to the saved one bit for bit; the first step's loss
   within 1e-6 relative of the straight run's, later ones within 1e-3, its
   train steps replaying the straight run's picks and matchings); then
   `lwdetr_tpu_torch.demo` on one fixture image from the last checkpoint, its
   detections equal to `build_eval_step`'s.
9. Padded batches (`padded_phase`): K2 / K6 on windows of 273 and 441 tokens
   and global blocks of 4368 and 7056 (small at the legacy recipe's sizes),
   K4 / K5 on 52 x 84 and 84 x 84 panels zeroed where padded, each against
   its plain version in f32 and bf16; F4's head dims: K2 / K6 / K9 / K7nb at
   head_dim 128, attention at 80 through `attention_cm`'s zero padding, the
   samplers at 12, 72 and 128 through their pad-and-split routes (forward and
   backward in each layout); K2 / K6 / K4 / K5 (K3 below 4096 positions)
   untimed at every size the padded paths below draw from the fixture
   (`PADDED_TRAIN_SIZES`, `PADDED_EVAL_SIZES`; a drawn size outside them
   fails the script); small's eval forward on a padded batch of 4 fixture
   images (one portrait; K2 13, K4 3) against the plain versions on the same
   picks; small's padded f32 train step (the legacy train recipe, batch 4):
   its forward against the plain forwards on the same picks, its gradients
   against the plain backwards on the same forward, and one step enqueued
   under `torch.cuda.set_sync_debug_mode("error")`;
   the eval CLI on the legacy recipe (the micro model on
   `tests/fixtures/micro_map_padded/`, batch 2) with its 12 stats within 1e-7
   of `golden_stats_padded.json`; small trained one epoch from scratch
   through the CLI on the legacy recipe (the fresh model's mean class
   probability near the prior 0.01), then `--eval` of its checkpoint, whose
   stats equal the training run's eval.
10. The decoder and encoder variants (`variants_phase`), F7 first: K2 / K9
   forwards and K6 / K7nb backwards at head_dim 128, 192, 256, 384, 512, 1024,
   2048 and 2112 (the wide case, on the tensor cores) at the decoder's eval
   (batch 8, 300 / 100 queries, and K2 at 150) and train shapes (13 groups of
   batch 4), f32 and bf16, against their plain versions, timed beside SDPA
   and their bound, with their registers and no spilled byte; untimed, odd
   token counts (301 / 99: plain loads in bf16) in the resident kernels and
   in FlashAttention-2's shape, and a head of 2112 over 3201 / 1501 tokens
   (the streaming kernels, in both dtypes); 300 and 2100
   through the zero padding to 320 and 2112; one decoder layer at
   --hidden_dim 512 --sa_nheads 1 in train mode (K2 1, K4 1, K6 1, K5 1)
   against the plain versions; then at 640 x 640 with
   seeded weights: (a) res50vd under small's decoder, (b) small's ViT with the
   Deformable-DETR-style decoder (one-stage, box logits, the iterative
   refinement, the learned embedding): the bf16 eval forward at batch 8
   (res50vd K2 3, K3 3; (b) small's K1 6, K2 7, K3 3) against the plain
   versions on the same picks, and the f32 train step at batch 4 (res50vd K2
   3, K6 3, K4 3, K5 3, M1 1; (b) small's), its gradients against the plain
   backwards on one forward, one optimizer step after which PResNet's
   statistics are bit-equal and its norm weights moved, the learned
   embedding decayed by (1 - lr wd) bit for bit, and the step time; (c) the
   eval forward, f32 and bf16, of two-stage with box logits (+inf
   proposals) and of the iterative refinement of reparameterized boxes; (e)
   the micro model with (b)'s decoder through the eval CLI on
   `tests/fixtures/micro_map_variants/` (the 12 f32 stats of
   `golden_stats_variants.json` within 1e-7) and one train epoch through the
   CLI (finite loss, launch invariants).
11. The deploy path (`deploy_phase`): small (f32 and bf16 at batch 1, bf16
   at batch 32), large and tiny (bf16, batch 1) at 640 x 640 from the JAX
   initialisation, exported by `torch.export` on the card
   (`lwdetr_tpu_torch/deploy/export.py`), saved, loaded and called: each
   artifact launches EXPECTED_LAUNCHES and gives the eager forward's scores,
   labels and boxes bit for bit (else the first module that differs is
   printed and its raw outputs held to the f32 forward bounds or the bf16
   drift ceiling); the weight casts each graph makes a call; `measure` of
   small's bf16 artifact and of its eager call at batch 1 and 32 (and their
   host time under the profiler), and `python -m
   lwdetr_tpu_torch.deploy.benchmark` on those artifacts in a process of its
   own, beside `bench.run("small", 32)`; the host
   us a call of K1, K2 and K3's operators against their direct launches;
   the micro model's f32 artifact through `evaluate_coco` on the fixture
   (K1 20, K2 20, K9 40, K3 40; its 12 stats within 1e-7 of
   `golden_stats_deploy.json`; the bf16 artifact's printed);
   `python -m lwdetr_tpu_torch.main ... export_model --infer_dir` in a
   process of its own, exiting 0 with its top 5.
12. The startup self-benchmark (`startup_bench_phase`): `benchmark_model`
   (`lwdetr_tpu_torch/utils/benchmark.py`, which `lwdetr_tpu_torch.main` runs
   on rank 0 at start-up unless `--dont_bench`) for small at 640 x 640, batch
   1, f32 and bf16: the parameter count against SMALL_PARAMETERS (the CPU
   test's number), the operators' FLOPs against `bench_operator_flops` (K1 6,
   K2 7, K3 3 calls a forward), its 26 forwards' launches, and the GFLOPs by
   class, fps and latency printed beside the card. The CLI phases above pass
   `--dont_bench`.
13. Multi-process training and eval (`dist_phase`): this script in two
   processes on the one card (`gloo`, cuda:0 each), launched with torchrun's
   variables: (a) small's f32 train step, 2 x batch 2, against this process's
   step on the same 4 images (its picks, matchings, sampling cells and ReLU
   units replayed: another batch size rounds otherwise, trap (b)): the mean loss
   within 1e-5 relative, every gradient within 1e-4 x max(1, max |g|), the
   projector's running statistics within 1e-6, each process's launches
   small's train step's; (b) ZeRO-1 (`--shard_opt_state`) after 2 engine
   steps whose optimizer takes the unsharded run's gradients: parameters and
   EMA bit for bit, the optimizer-state bytes; (c) large's bf16 step at drop_path 0.1, 2 x 1 against 1 x 2: each
   process's masks its rows of the one-process draw, the loss within 2^-6
   relative; (d) `lwdetr_tpu_torch.main --eval` in 2 processes on the
   fixture: the merged stats within 1e-7 of `golden_stats.json`, printed and
   written by rank 0 only. A process that fails, outlives its time limit or
   runs on the CPU fails the script.
14. The JAX CLI's orbax train state (`orbax_phase`), read by
   `lwdetr_tpu_torch/train/orbax_read.py` (no JAX, orbax or tensorstore; its
   zstd decoder `csrc/zstd_decode.cpp` built with g++): (a) the fixture
   `tests/fixtures/micro_orbax/ckpt/5/` read, every leaf's dtype, shape and
   sha256 against `orbax_digests.json`, the bytes decoded, seconds and MB/s
   of the card machine's host; (b) `lwdetr_tpu_torch.main --eval --resume`
   of it with `--use_ema`, f32: both blocks within 1e-7 of
   `golden_stats_orbax.json`, K1 1 / K2 1 / K9 2 / K3 2 a batch, and the
   detections against the same pipeline on the plain versions (the picks
   replayed); (c) one train epoch through the CLI resumed from it: the
   restored weights, EMA and AdamW moments equal to (a)'s leaves through the
   weights' mapping before the first step, start epoch 1 and the first
   step's lr as the JAX schedule gives them at step 5, the decoder's kernels
   first held to their plain versions at every size the epoch draws
   (ORBAX_CLI_DRAWN_SEP, the VARIANT_CLI_DRAWN_ATTENTION shapes), finite
   losses and the launch invariants; (d) the demo with `--checkpoint <dir>
   --ema`, its detections equal to the demo's on a `.pth` of the same EMA
   weights.
15. The train step and the batch-1 forward as CUDA graphs (`chain_phase`):
   `train/engine.py::build_train_chain` for small f32 at batch 4, large bf16
   at batch 2 (drop_path 0.1: masks drawn) and tiny f32 at batch 4 in the
   "cm" and "gather" branches, 2 steps an epoch with lr_drop 1: 4 replays
   against 4 eager steps (`build_train_step`, the usual AdamW and LambdaLR)
   on a second state built alike, the eager steps replaying each replay's
   proposal picks and matching: the first loss bit-equal, the lrs equal to the eager
   schedule's in float32 across the drop, the masks equal and new at each
   replay, the first grad_norm, the later losses and what the steps changed
   in the parameters, AdamW moments and EMA (relative L2 by kind) within 1e-3
   / 5e-2 or twice a second eager run's difference from the first, the
   kernels' launches of a replay (profiler) equal to an
   eager step's, and building the chain (2 warm-up steps and the capture)
   launching 3 x TRAIN_LAUNCHES; small's and large's eager and chain step ms
   in turns (the host's share of the step); each preset's bf16 batch-1
   forward + `post_process` as a guarded graph (`utils/graphs.py`), bit-equal
   to the eager call, its `bs1_device_ms` beside `bs1_ms` and the
   reference's T4 TensorRT figure, small's graph refusing a replay after a
   weight was written; `train_flop_report` for small at batch 4 at the
   chain's step ms; one `breakdown --trace` of small's eval at batch 4 whose
   file parses and whose stages sum to the busy time.

Any failure exits non-zero. Without a CUDA card, or outside a checkout, it
exits non-zero and prints no result. The line before the last holds one JSON
object with every kernel's numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace
from unittest import mock

# peak rates of one H100 SXM (NVIDIA data sheet, dense): the least time the
# card could take for a kernel's work is the largest of its bytes over the
# memory rate and its operations over the rate for their type
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 tensor cores
# f32 products as 3xTF32 on the tensor cores (three TF32 products for one, 495
# TFLOP/s dense TF32): the f32 rate of the kernels that take that route, the
# attention backwards (K6, K7, K7nb) and the wide case's forwards (K2, K9 above
# head_dim 64)
F32_3XTF32_FLOPS_PER_S = 495e12 / 3
# exp2 on the special-function units: 16 per clock per SM (CUDA C++ Programming
# Guide, throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz boost
EXP_PER_S = 16 * 132 * 1.98e9

# kernel vs plain version on the same inputs, element by element:
# |kernel - plain| <= ATOL + RTOL * |plain|. The plain version runs in f32 on
# the inputs upcast to f32 (for bf16 inputs, the exact values the kernel
# loads). f32: the same f32 arithmetic summed in another order (ATOL). bf16:
# the kernel computes in f32 and rounds its result to bf16 once, to nearest
# even, so it lies within half a bf16 ulp of the f32 result, which is at most
# 2^-8 of the value. A dropped or mis-scaled key tile, or a truncating
# conversion, breaks that bound.
# The bf16 attention kernels (K1, K2, K9) also round the softmax weights p to
# bf16 before PV, as the JAX kernels do: they are held to
# `flash_attention.bf16_error_bound`, ATOL + 2^-8 |plain| + 2^-8
# plain(q, k, |v|), against the plain version that rounds alike (and, beside
# it, against the f32 plain version on the same bf16 values).
ATOL = 2e-5
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# The bf16 samplers K3, K4, K10 and the backwards K5 and K8 (its d(value))
# round where the JAX kernels round (`ops/deform_attn.py`, "bf16"), as their plain versions on the same
# bf16 values do: held to those within ATOL + one bf16 ulp (2^-7 |plain|), as a
# sum in another f32 order may tip a rounding; K5's bf16 d(loc) and d(weights)
# within `sep_panels_bwd_bf16_bound` (one ulp of each bf16 weight gradient).
SAMPLER_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
ROUNDED_AS_JAX = ("K3", "K4", "K10")
SAMPLER_BF16_TOL = (f"bf16: |kernel - plain bf16| <= {ATOL} (x max(1, max |plain|), x 4 on "
                    "d(value)) + 2^-7 x |plain|, the plain version on the same bf16 values "
                    "rounding where the JAX kernel does; K5's d(loc), d(weights) + "
                    "sep_panels_bwd_bf16_bound; f32: as the other samplers")
ATTENTION_BF16_TOL = ("|kernel - plain| <= 2e-5 + 2^-8 |plain| + 2^-8 plain(q, k, |v|), plain "
                      "rounding p to bf16 before PV (and f32 plain on the same values); f32: 2e-5")
# the bf16 attention backwards (K6, K7, K7nb) round ds and p to bf16 before
# their products, as the JAX kernels do: `flash_attention.bf16_bwd_error_bound`
ATTENTION_BWD_BF16_TOL = ("|kernel - plain| <= 2e-5 max(1, max |plain|) + ulp(plain) + 2^-8 "
                          "[sum |ds| |k|, sum |ds| |q|, sum p |d(out)|], plain rounding ds and p "
                          "to bf16 before the products (and f32 plain on the same values); "
                          "f32: 2e-5 x max(1, max |plain|)")
# K2's row log-sum-exp (log2 units) against the plain one from the f32 scores
LSE_ATOL, LSE_RTOL = 2e-5, 2.0 ** -8
# bf16 eval forward, kernels vs plain versions with the same picks, over all
# queries: the JAX package's own bf16-vs-f32 drift ceiling
# (tests/test_micro_map_golden.py::test_bf16_forward_drift_vs_f32)
BF16_DRIFT = {"prob_mean": 0.01, "prob_max": 0.2, "box_mean": 0.03}
# whole 640x640 forward, kernels vs plain versions, f32: ~20 layers of
# f32 sums in another order. On an H100 the three presets read 1.6e-5 to
# 3.1e-5 on the logits and 1.5e-6 to 4.7e-6 on the boxes (the largest on
# large); the bounds leave two orders of magnitude for other cards and
# library versions, and a dropped key tile or a wrong corner moves the
# logits by 1e-1 or more
FWD_ATOL_LOGITS = 2e-3
FWD_ATOL_BOXES = 5e-4
MIN_TOPK_OVERLAP = 0.98  # of the 300 (tiny: 100) picks / (query, label) pairs per image
# a detection's score against its query's sigmoid for its label, computed by
# another launch on the same f32 value; and a shared detection's box difference
# (over the image's size) against its query's: f32 rounding of a scale to
# 3200 pixels and back, where a box set against another query's moves by 1e-2 or more
SCORE_MATCH_ATOL = 1e-6
PAIRING_ATOL = 1e-6

BATCH = 8
MICRO_BATCH = 4  # the eval batch of the mAP fixture's pipeline (its golden was made at 4)
KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7nb", "K8", "K9", "K10", "K10b",
                "M1")
BACKWARD_KERNELS = ("K5", "K6", "K7", "K7nb", "K8", "K10b")
# the keys every entry of the kernels line carries
CONTRACT_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")


def launch_counts(**counts):
    """Expected launches of every kernel: those given, 0 for the others."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


# launches per forward: 6 window blocks; 4 global blocks + 3 decoder
# self-attentions; 3 decoder cross-attentions, from channel-major values below
# 4096 memory positions (small: 1600) and from panels above (P3 + P5: 6800).
# tiny has 3 window and 3 global blocks, and its decoder's self-attention over
# 100 queries takes the short kernel without a bias (K9). No eval forward
# launches a backward kernel.
EXPECTED_LAUNCHES = {"small": launch_counts(K1=6, K2=7, K3=3),
                     "xlarge": launch_counts(K1=6, K2=7, K4=3),
                     "large": launch_counts(K1=6, K2=7, K4=3),
                     "tiny": launch_counts(K1=3, K2=3, K9=3, K3=3),
                     "medium": launch_counts(K1=6, K2=7, K3=3)}
# one train step: the forward's launches (the decoder samples from panels in
# train mode: K4, not K3), one backward launch for each, and one matching
# launch (M1) for all output sets, images and query groups; tiny's decoder
# folds its 13 groups of 100 queries into the batch, so K9 and the short
# backward without a bias (K7nb) take its self-attention; "cm" and "gather"
# are `force_branch` on the decoder's cross-attention
_TINY_TRAIN = dict(K1=3, K2=3, K9=3, K6=3, K7=3, K7nb=3, M1=1)
TRAIN_LAUNCHES = {
    "small": launch_counts(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6, M1=1),
    "medium": launch_counts(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6, M1=1),
    "tiny": launch_counts(K4=3, K5=3, **_TINY_TRAIN),
    "tiny/cm": launch_counts(K3=3, K8=3, **_TINY_TRAIN),
    "tiny/gather": launch_counts(K10=3, K10b=3, **_TINY_TRAIN)}
TRAIN_BRANCHES = {"small": (None,), "tiny": (None, "cm", "gather"), "medium": (None,)}
# the release train steps of large and xlarge at batch 2, 640x640, with the
# release drop_path (0.1) at its schedule's step-0 rate: (path, preset, dtype,
# remat). Remat recomputes each ViT block's forward in the backward: K1 6 + 6,
# K2 4 + 4 + 3.
LARGE_TRAIN_BATCH = 2
LARGE_TRAIN_PATHS = (("large_train_f32", "large", "float32", False),
                     ("large_train_bf16", "large", "bfloat16", False),
                     ("xlarge_train_bf16", "xlarge", "bfloat16", False),
                     ("xlarge_train_f32", "xlarge", "float32", False),
                     ("xlarge_train_f32_remat", "xlarge", "float32", True))
_RELEASE_TRAIN = dict(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6, M1=1)
TRAIN_LAUNCHES.update({"large": launch_counts(**_RELEASE_TRAIN),
                       "xlarge": launch_counts(**_RELEASE_TRAIN),
                       "xlarge/remat": launch_counts(**dict(_RELEASE_TRAIN, K1=12, K2=11))})
# bf16 step, backward kernels vs the plain bf16 backwards on one bf16 forward,
# per parameter tensor (max |difference| over the tensor's max |gradient|,
# floored as in f32): every backward kernel lies within a bf16 ulp or two of
# its plain version (`bf16_bwd_error_bound`: an ulp of the result plus the
# rounding of p and ds at another f32 sum; the samplers: one ulp, 2^-7, and
# K5's d(loc) from one ulp of its bf16 weight gradients), and each layer behind
# them rounds the difference it is handed to bf16 again. A bias gradient sums
# such differences over every token of the batch, and where its terms cancel
# the difference grows against its value: the worst tensor is held to 2^-3,
# the median one to 2^-6 (two ulps); on an H100 the worst tensor read 0.021 /
# 0.062 (large / xlarge, block 0's v_bias), the median 0.004 / 0.005 (PERF.md),
# and the JAX package's own bf16 step lies 0.79 / 0.18 (worst / median tensor)
# from its f32 step at the reduced size of tests/test_torch_port_drop.py. Trap (a): a
# gradient that is zero in exact arithmetic (the bias of each projector tap's
# last resampling layer, whose per-channel constant the C2f's 1x1 convolution
# and train-mode BatchNorm remove) is rounding noise on both sides; in bf16
# that noise reaches the tensor's own size, so those tensors are held to one
# bf16 ulp of the largest gradient of all instead (f32 keeps GRAD_FLOOR).
BF16_TRAIN_GRAD_RTOL = 2.0 ** -3
BF16_TRAIN_GRAD_MEDIAN = 2.0 ** -6
BF16_ZERO_GRAD_ATOL = 2.0 ** -8


def exact_zero_grads(model):
    """Trap (a)'s tensors: the bias of the last layer of each projector tap's
    resampling (its output goes, concatenated, through the C2f's 1x1
    convolution into a train-mode BatchNorm)."""
    names = set()
    for si, stage in enumerate(model.backbone[0].projector.stages_sampling):
        for ti, seq in enumerate(stage):
            if len(seq) and getattr(seq[-1], "bias", None) is not None:
                names.add(f"backbone.0.projector.stages_sampling.{si}.{ti}.{len(seq) - 1}.bias")
    return names
TRAIN_BATCH = 4
TRAIN_STEPS = {"small": 8, "tiny": 6, "medium": 4}
BRANCH_LOSS_ATOL = 1e-4  # one function from three value layouts
# how the backward kernels' absolute bound scales (see `grad_scale`)
_SCATTER_TOL = " x max(1, max |plain|), x 4 on d(value) for the order of its additions"
BWD_TOL = {"K5": _SCATTER_TOL, "K8": _SCATTER_TOL, "K10b": _SCATTER_TOL,
           "K6": " x max(1, max |plain|)", "K7": " x max(1, max |plain|)",
           "K7nb": " x max(1, max |plain|)"}
# one train step, f32: backward kernels vs plain backwards on the same forward,
# per parameter tensor, max |difference| over that tensor's max |gradient|
# (floored at GRAD_FLOOR x the largest gradient of all); and kernels vs the
# whole step on the plain versions, relative L2 error over all gradients
TRAIN_GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-5
TRAIN_GRAD_L2 = 5e-2
REPLACES = {
    "K1": "lwdetr_tpu/ops/flash_attention.py:95 _attn_cm_allheads_bias_kernel",
    "K2": "lwdetr_tpu/ops/flash_attention.py:43 _attn_cm_kernel",
    "K3": "lwdetr_tpu/ops/deform_attn.py:444 _deform_cm_kernel",
    "K4": "lwdetr_tpu/ops/deform_attn.py:853 _sep_kernel",
    "K5": "lwdetr_tpu/ops/deform_attn.py:1105 _sep_bwd_kernel",
    "K6": "lwdetr_tpu/ops/flash_attention.py:287 _attn_cm_bwd_kernel",
    "K7": "lwdetr_tpu/ops/flash_attention.py:347 _attn_cm_bwd_allheads_kernel",
    "K7nb": "lwdetr_tpu/ops/flash_attention.py:347 _attn_cm_bwd_allheads_kernel",
    "K8": "lwdetr_tpu/ops/deform_attn.py:480 _dvalue_cm_kernel",
    "K9": "lwdetr_tpu/ops/flash_attention.py:88 _attn_cm_allheads_kernel",
    "K10": "lwdetr_tpu/ops/deform_attn.py:149 _deform_kernel",
    "K10b": "lwdetr_tpu/ops/deform_attn.py:213 _dvalue_kernel",
    # device code of the JAX package that is not Pallas: its lax.while_loop solver
    "M1": "lwdetr_tpu/models/matcher.py:29 solve_assignment",
}
ALSO_REPLACES = {"K8": "lwdetr_tpu/ops/deform_attn.py:509 _dweight_cm_kernel",
                 "K10b": "lwdetr_tpu/ops/deform_attn.py:243 _dweight_kernel"}
SOURCES = {"K1": "lwdetr_tpu_torch/csrc/window_attention.cu",
           "K2": "lwdetr_tpu_torch/csrc/flash_attention.cu",
           "K3": "lwdetr_tpu_torch/csrc/deform_attn.cu",
           "K4": "lwdetr_tpu_torch/csrc/deform_attn_sep.cu",
           "K5": "lwdetr_tpu_torch/csrc/deform_attn_sep_bwd.cu",
           "K6": "lwdetr_tpu_torch/csrc/flash_attention_bwd.cu",
           "K7": "lwdetr_tpu_torch/csrc/window_attention_bwd.cu",
           "K7nb": "lwdetr_tpu_torch/csrc/window_attention_bwd.cu",
           "K8": "lwdetr_tpu_torch/csrc/deform_attn_bwd.cu",
           "K9": "lwdetr_tpu_torch/csrc/window_attention.cu",
           "K10": "lwdetr_tpu_torch/csrc/deform_attn_sep.cu",
           "K10b": "lwdetr_tpu_torch/csrc/deform_attn_sep_bwd.cu",
           "M1": "lwdetr_tpu_torch/csrc/matcher.cu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bound_ms(nbytes: float, flops: float, exps: float, dtype: str, tf32x3: bool = False):
    """The least time (ms) for the work, what bounds it, and each part (s);
    `tf32x3`: the kernel's f32 products run as 3xTF32 on the tensor cores."""
    rate = F32_3XTF32_FLOPS_PER_S if tf32x3 and dtype == "float32" else FLOPS_PER_S[dtype]
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "flops": flops / rate,
         "exps": exps / EXP_PER_S}
    by = max(t, key=t.get)
    return t[by] * 1e3, ("bytes" if by == "bytes" else "operations"), t


def build_kernels():
    from lwdetr_tpu_torch.ops import _build

    for src in _build.SOURCES:  # build from this checkout's sources, now
        _build.library_path(src).unlink(missing_ok=True)
    logs = _build.build(_build.SOURCES)
    for src, text in logs.items():
        for line in text.splitlines():
            if line.startswith("ptxas info") and ("Compiling" in line or "Used" in line):
                print(f"[{src}] {line.strip()}")
            elif "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"[{src}] {line.strip()}")


def check_close(torch, name, dtype, out, ref, atol_scale=1.0, rtol=None, bound=None):
    """max |out - ref|; raises unless every element is within ATOL x atol_scale +
    rtol |ref| (default RTOL[dtype]) + `bound` (an elementwise tensor, or 0)."""
    diff = (out.float() - ref).abs()
    atol = ATOL * atol_scale
    rtol = RTOL[dtype] if rtol is None else rtol
    excess = (diff - (atol + rtol * ref.abs() + (0.0 if bound is None else bound))).max().item()
    err = diff.max().item()
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{name} {dtype}: max abs err {err}, over ATOL {atol} + RTOL "
                             f"{rtol} x |plain|{'' if bound is None else ' + bound'} by {excess}")
    return err


def grad_scale(ref):
    """A gradient sums many terms of either sign, so its f32 bound scales with
    its magnitude: ATOL x max(1, max |plain|)."""
    return max(1.0, ref.abs().max().item())


def attention_inputs(torch, B, C, N, heads, dtype, bias, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = (0.5 * torch.randn((B, 3 * C, N), generator=g, device="cuda")).to(dtype)
    b = 0.1 * torch.randn((3 * C,), generator=g, device="cuda") if bias else None
    return qkv, b


def check_bound(torch, name, out, ref, bound):
    """max |out - ref|; raises unless every element is within `bound`."""
    diff = (out.float() - ref).abs()
    excess = (diff - bound).max().item()
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{name}: max abs err {diff.max().item()}, over its bound by {excess}")
    return diff.max().item()


def compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype,
                      timed=True, iters=20):
    """Kernel vs plain (and SDPA) on one attention shape; returns the numbers.
    `ms` is the time of back-to-back calls, host work included; `device_ms`
    the time of the same calls replayed from a CUDA graph, the device's alone
    (the two part where the wrapper's host time exceeds the kernel's).
    Without `timed`, the check alone: the errors, no times; `iters` calls a
    timing sample."""
    import math

    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    qkv, b = attention_inputs(torch, B, C, N, heads, dt, bias, seed=N + C)
    D = C // heads
    kernel_obj = {"K1": fa.window_attention_bias_kernel, "K2": fa.flash_attention_cm_kernel,
                  "K9": fa.window_attention_kernel}[name]
    if bias:
        kernel = lambda: fa.window_attention_bias(qkv, b, heads, scale)  # noqa: E731
        # the panel the kernel attends over: in bf16 one rounding of x + bf16(b)
        # (`attention_cm`'s CPU path and the JAX kernel), in f32 the f32 sum
        panel = qkv + b.to(dt)[:, None]
        # the plain version as `attention_cm`'s CPU path runs it, here on the card
        plain = lambda: fa.attention_cm_plain(qkv + b.to(dt)[:, None], heads, scale)  # noqa: E731
    else:
        wrapper = fa.window_attention if name == "K9" else fa.flash_attention_cm
        kernel = lambda: wrapper(qkv, heads, scale)  # noqa: E731
        panel = qkv
        plain = lambda: fa.attention_cm_plain(qkv, heads, scale)  # noqa: E731
    q, k, v = (panel.reshape(B, 3, heads, D, N)[:, i].transpose(-1, -2).contiguous()
               for i in range(3))
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        ref32 = fa.attention_cm_plain(panel.float(), heads, scale)  # f32 on the same values
        lib = library().transpose(-1, -2).reshape(B, C, N)
        torch.cuda.synchronize()
        tag = f"{name} {dtype} {tuple(qkv.shape)}"
        if dtype == "bfloat16":
            ref = fa.attention_cm_plain(panel, heads, scale).float()  # p rounded to bf16
            err = check_bound(torch, tag, out, ref, fa.bf16_error_bound(panel, heads, scale, ref))
            err32 = check_bound(torch, tag + " vs f32 plain", out, ref32,
                                fa.bf16_error_bound(panel, heads, scale, ref32))
        else:
            ref = ref32
            err = err32 = check_close(torch, tag, dtype, out, ref)
        lib_err = (lib.float() - ref32).abs().max().item()
        lse_err = None
        if name == "K2":  # the row log-sum-exp K6 reads, log2 units, vs the f32 scores'
            out2, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
            x = panel.float().reshape(B, 3, heads, D, N)
            s = torch.einsum("bhdn,bhdm->bhnm", x[:, 0] * scale, x[:, 1])
            lse_ref = torch.logsumexp(s, dim=-1) / math.log(2.0)
            del s
            lse_err = check_bound(torch, tag + " lse", lse, lse_ref,
                                  LSE_ATOL + LSE_RTOL * lse_ref.abs())
            if not torch.equal(out2, out):
                raise AssertionError(f"{tag}: writing the log-sum-exp changed the output")
        if not timed:
            log(f"{tag}: err {err:.3g} (vs f32 plain {err32:.3g}"
                + (f"; lse {lse_err:.3g}" if lse_err is not None else "") + ")")
            return {"shape": list(qkv.shape), "max_abs_err": err, "max_abs_err_vs_f32_plain": err32}
        attrs = fa.kernel_attributes(kernel_obj, qkv, heads)
        ms = measure_ms(kernel, iters=iters)["ms"]
        device_ms = measure_graph_ms(kernel, iters=iters)["ms"]
        plain_ms = measure_ms(plain, iters=min(iters, 5))["ms"]
        library_ms = measure_ms(library, iters=iters)["ms"]
        library_device_ms = measure_graph_ms(library, iters=iters)["ms"]
        # the long-sequence kernel on the short kernel's inputs: what the decoder ran before K9
        k2 = lambda: fa.flash_attention_cm(qkv, heads, scale)  # noqa: E731
        k2_ms = measure_ms(k2)["ms"] if name == "K9" else None
        k2_device_ms = measure_graph_ms(k2)["ms"] if name == "K9" else None
    isz = qkv.element_size()
    nbytes = B * 4 * C * N * isz + (3 * C * 4 if bias else 0)
    flops = 4 * B * heads * N * N * D
    exps = B * heads * N * N
    bms, by, parts = bound_ms(nbytes, flops, exps, dtype, tf32x3=fa.is_wide_head_dim(D))
    log(f"{tag}: err {err:.3g} (vs f32 plain {err32:.3g}; sdpa vs f32 plain {lib_err:.3g}"
        + (f"; lse {lse_err:.3g}" if lse_err is not None else "") + f") ms {ms:.4f} plain "
        f"{plain_ms:.4f} sdpa {library_ms:.4f} (x{ms / library_ms:.2f}); device (graph) {device_ms:.4f}"
        f" sdpa {library_device_ms:.4f} "
        + (f"K2 {k2_ms:.4f} / {k2_device_ms:.4f} " if k2_ms is not None else "")
        + f"bound {bms:.4f} ({by}; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items())
        + f"); {attrs['registers']} registers, {attrs['spill_bytes']} spilled bytes")
    res = {"shape": list(qkv.shape), "max_abs_err": err, "max_abs_err_vs_f32_plain": err32,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": library_ms, "sdpa_ratio": ms / library_ms, "device_ms": device_ms,
           "library_device_ms": library_device_ms,
           "sdpa_ratio_device": device_ms / library_device_ms,
           "registers": attrs["registers"], "spill_bytes": attrs["spill_bytes"],
           "bound_parts_ms": {k: v * 1e3 for k, v in parts.items()}}
    if lse_err is not None:
        res["lse_max_abs_err"] = lse_err
    if k2_ms is not None:
        res["k2_ms_same_inputs"] = k2_ms
        res["k2_device_ms_same_inputs"] = k2_device_ms
    return res


def touched_positions(torch, loc_l, hw):
    """Distinct (b, h, y, x) map positions that the bilinear corners of one
    level's points loc_l (B, Q, H, P, 2) fall on; corners outside the map read
    nothing."""
    Hl, Wl = hw
    B, _, H = loc_l.shape[:3]
    x0 = torch.floor(loc_l[..., 0].double() * Wl - 0.5)
    y0 = torch.floor(loc_l[..., 1].double() * Hl - 0.5)
    plane = (torch.arange(B, device=loc_l.device)[:, None, None, None] * H
             + torch.arange(H, device=loc_l.device)[None, None, :, None])  # (B, 1, H, 1)
    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            inside = (x >= 0) & (x < Wl) & (y >= 0) & (y < Hl)
            key = (plane * Hl + y.clamp(0, Hl - 1).long()) * Wl + x.clamp(0, Wl - 1).long()
            keys.append(key[inside])
    return torch.unique(torch.cat(keys)).numel()


# sampler shapes: (B, heads, head_dim, points, queries, levels)
SEP_SMALL = (BATCH, 16, 16, 2, 300, [(40, 40)])                 # small's eval forward
SEP_LARGE = (BATCH, 24, 16, 4, 300, [(80, 80), (20, 20)])       # large / xlarge eval
SEP_SMALL_TRAIN = (4, 16, 16, 2, 3900, [(40, 40)])              # small's train step, batch 4
SEP_LARGE_TRAIN = (BATCH, 24, 16, 4, 3900, [(80, 80), (20, 20)])  # large with 13 query groups
SEP_TINY_TRAIN = (4, 16, 16, 2, 1300, [(40, 40)])               # tiny's train step, batch 4
SEP_TINY = (BATCH, 16, 16, 2, 100, [(40, 40)])                  # tiny's eval forward
SEP_MICRO = (MICRO_BATCH, 8, 8, 2, 12, [(40, 40)])               # the mAP fixture's micro model
# large's and xlarge's train step at their release batch of 2
SEP_LARGE_TRAIN_B2 = (LARGE_TRAIN_BATCH, 24, 16, 4, 3900, [(80, 80), (20, 20)])
# head dims 8 (the micro fixture's cross-attention) and 64 of the panel and
# row-major backwards (K5, K10b), and 24, a multiple of 8 but no power of two
SEP_BWD_CHECKS = (("d8", (2, 8, 8, 4, 60, [(16, 16), (4, 4)])),
                  ("d64", (2, 4, 64, 3, 77, [(20, 20), (10, 10)])),
                  ("d24", (2, 4, 24, 2, 33, [(12, 10)])))
# the channel-major pair's other routes (`csrc/deform_cm.cuh`): tiny's train map
# with a Q that no CTA's query slice divides; Q = 1; a map of 840 bytes in bf16,
# no multiple of 16 (copied element by element); D = 32 (f32: 205 KB, device memory)
CM_Q1001 = (4, 16, 16, 2, 1001, [(40, 40)])
CM_Q1 = (2, 2, 16, 1, 1, [(5, 7)])
CM_ODD_MAP = (2, 3, 12, 2, 37, [(5, 7)])
CM_D32 = (4, 8, 32, 2, 300, [(40, 40)])
CM_CHECKS = (("q1001", CM_Q1001), ("q1", CM_Q1), ("odd_map", CM_ODD_MAP), ("d32", CM_D32))
# K4 and K10 beyond the paths' shapes, each in both layouts, with points on
# grid lines (pixel centres), far outside and NaN besides the borders: a Q
# that no query tile divides; Q = 1; head_dim 32 and 64 (3 points a level: 6
# a (q, h), padded to 8); four levels (kMaxLevels, 16 points a (q, h))
SEP_CHECKS = (("q1001", CM_Q1001), ("q1", CM_Q1), ("d32", CM_D32),
              ("d64", (2, 4, 64, 3, 77, [(20, 20), (10, 10)])),
              ("d8", (2, 8, 8, 4, 60, [(16, 16), (4, 4)])),
              ("four_levels", (2, 8, 16, 4, 150, [(40, 40), (20, 20), (10, 10), (5, 5)])))


def sep_inputs(torch, dt, shape, seed=4, special=False, masked=False):
    """Values, locations, softmax weights and d(out) at `shape`. With
    `special`, some points also lie on grid lines (the pixel centres of the last
    five queries) and one is NaN (query 2): its plain reference takes it as a
    point far outside (`torch.nan_to_num`). With `masked`, the values are
    zero where a padded batch's are: image 0's last quarter of rows (a
    landscape) and image 1's last quarter of columns (a portrait), as the
    decoder zeroes them before its sampler."""
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = [torch.randn((B, H, h, w * D), generator=g, device="cuda").to(dt) for h, w in shapes]
    if masked:
        for v, (h, w) in zip(vals, shapes):
            v[0, :, h - h // 4:] = 0
            if B > 1:
                v[1, :, :, (w - w // 4) * D:] = 0
    # about a sixth of the points fall outside [0, 1] in x or y, so some or all
    # of their corners drop out; query 0 sits on the borders, query 1 far outside
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.1 - 0.05
    if special:
        n = min(Q, 5)
        for lvl, (h, w) in enumerate(shapes):
            for axis, size in ((0, w), (1, h)):
                pick = torch.randint(0, size, (B, n, H, P), generator=g, device="cuda")
                loc[:, Q - n:, :, lvl, :, axis] = (pick.float() + 0.5) / size
        if Q > 2:
            loc[:, 2, 0, 0, 0, 0] = float("nan")
    loc[:, 0, :, :, 0::2] = 0.0
    loc[:, 0, :, :, 1::2] = 1.0
    if Q > 1:
        loc[:, 1] = loc[:, 1] * 1e6 - 3e5
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    w = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1).reshape(B, Q, H, L, P)
    dout = torch.randn((B, Q, H * D), generator=g, device="cuda").to(dt)
    return vals, loc, w, dout, outside


def sep_panel_bytes(torch, vals, loc, shapes, D):
    """Bytes of each panel that the run's points name: the distinct in-map
    corners (each D channels wide), once each, never more than the panel."""
    touched = [touched_positions(torch, loc[:, :, :, lvl], hw) for lvl, hw in enumerate(shapes)]
    return [min(v.numel(), n * D) * v.element_size() for v, n in zip(vals, touched)]


def as_layout(torch, da, layout, vals, shapes, dout):
    """The same values in one of the samplers' three layouts, with that
    layout's wrappers: `value` is the list of panels ("panels": K4 / K5), one
    row-major tensor (B, Len_in, H, D) ("rowmajor": K10) or one channel-major
    tensor (B, C, Len_in), whose output and d(out) are (B, C, Q) ("cm": K3 / K8)."""
    B, H = vals[0].shape[:2]
    D = vals[0].shape[3] // shapes[0][1]
    if layout == "panels":
        return SimpleNamespace(
            value=vals, dout=dout,
            fwd=lambda v, l, a: da.ms_deform_attn_sep_panels(v, shapes, l, a),
            fwd_plain=lambda v, l, a: da.ms_deform_attn_sep_panels_plain(v, shapes, l, a),
            bwd=lambda v, l, a, g: da.ms_deform_attn_sep_panels_bwd(v, shapes, l, a, g),
            bwd_plain=lambda v, l, a, g: da.ms_deform_attn_sep_panels_bwd_plain(v, shapes, l, a, g))
    rows = torch.cat([v.reshape(B, H, -1, D) for v in vals], dim=2)  # (B, H, Len_in, D)
    if layout == "rowmajor":
        return SimpleNamespace(
            value=rows.transpose(1, 2).contiguous(), dout=dout,
            fwd=lambda v, l, a: da.ms_deform_attn(v, shapes, l, a),
            fwd_plain=lambda v, l, a: da.ms_deform_attn_plain(v, shapes, l, a),
            bwd=lambda v, l, a, g: da.ms_deform_attn_bwd(v, shapes, l, a, g),
            bwd_plain=lambda v, l, a, g: da.ms_deform_attn_bwd_plain(v, shapes, l, a, g))
    return SimpleNamespace(
        value=rows.transpose(2, 3).reshape(B, H * D, -1).contiguous(),
        dout=dout.transpose(1, 2).contiguous(),
        fwd=lambda v, l, a: da.ms_deform_attn_cm(v, shapes, l, a, H),
        fwd_plain=lambda v, l, a: da.ms_deform_attn_cm_plain(v, shapes, l, a, H),
        bwd=lambda v, l, a, g: da.ms_deform_attn_cm_bwd(v, shapes, l, a, g, H),
        bwd_plain=lambda v, l, a, g: da.ms_deform_attn_cm_bwd_plain(v, shapes, l, a, g, H))


def tensors(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def to_f32(x):
    return [t.float() for t in x] if isinstance(x, (list, tuple)) else x.float()


def grid_sample_sampler(torch, F, maps, loc, w):
    """The reference's own PyTorch formulation of the sampling
    (`ms_deform_attn_core_pytorch`): F.grid_sample(mode='bilinear',
    padding_mode='zeros', align_corners=False) per level, times the weights,
    summed; maps[l] (B H, D, H_l, W_l) -> (B, Q, H D). A yardstick the port
    never calls."""
    B, Q, H, L, P, _ = loc.shape
    grids = (2 * loc - 1).to(maps[0].dtype)
    out = 0
    for lvl, v in enumerate(maps):
        grid = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (B H, Q, P, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        wl = w[:, :, :, lvl].transpose(1, 2).flatten(0, 1)[:, None].to(v.dtype)  # (B H, 1, Q, P)
        out = out + (s * wl).sum(-1)  # (B H, D, Q)
    return out.reshape(B, -1, Q).transpose(1, 2)


def library_sampler(torch, F, measure_ms, vals, shapes, loc, w, dout, backward, iters):
    """Call time of `grid_sample_sampler` on the panels' values (its backward
    through torch.autograd.grad, the forward outside the timing), and its max
    abs difference from the f32 plain forward (`ref`, given by the caller)."""
    B, H = vals[0].shape[:2]
    D = vals[0].shape[3] // shapes[0][1]
    maps = [v.reshape(B, H, h, wd, D).permute(0, 1, 4, 2, 3).reshape(B * H, D, h, wd).contiguous()
            for v, (h, wd) in zip(vals, shapes)]
    if not backward:
        with torch.no_grad():
            return measure_ms(lambda: grid_sample_sampler(torch, F, maps, loc, w),
                              iters=iters)["ms"]
    leaves = [m.detach().requires_grad_() for m in maps] + [loc.detach().requires_grad_(),
                                                           w.detach().requires_grad_()]
    out = grid_sample_sampler(torch, F, leaves[:-2], leaves[-2], leaves[-1])
    g = dout.to(out.dtype)
    return measure_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                      iters=iters)["ms"]


def sampler_route(da, name, layout, value, shape):
    """The route K3 or K8 takes on the channel-major `value`, or K4 or K10 at
    `shape`, as the kernel's source chooses it (None for the backwards of the
    other layouts). K4 and K10 must keep no stack and spill nothing."""
    B, H, D, P, Q, shapes = shape
    if layout == "cm":
        kernel = da.deform_attn_cm_kernel if name == "K3" else da.deform_attn_cm_bwd_kernel
        return da.cm_route(kernel, value, Q, H)
    if name not in ("K4", "K10"):
        return None
    kernel = da.deform_attn_sep_kernel if name == "K4" else da.deform_attn_rowmajor_kernel
    route = da.sep_route(kernel, B, Q, H, D, len(shapes), P, tensors(value)[0].dtype)
    if route["local_bytes"]:
        raise AssertionError(f"{name} at {shape}: {route['local_bytes']} local bytes a thread")
    return route


def route_note(route):
    if not route:
        return ""
    if "work_order" in route:
        return (f"; route: {route['work_order']}, tile {route['queries_a_cta']} queries x "
                f"{route['heads_a_cta']} heads, {route['threads']} threads a CTA, "
                f"{route['ctas']} CTAs, {route['channels_a_thread']} channels a thread, "
                f"{route['points_in_flight']} points in flight, {route['shared_bytes']} shared "
                f"bytes, {route['registers']} registers, {route['local_bytes']} local bytes")
    return (f"; route: {route['route']}, {route['shared_bytes']} shared bytes, no cluster, "
            f"{route['ctas_per_map']} CTAs a map of {route['threads']} threads, "
            f"{route['registers']} registers, {route['local_bytes']} local bytes")


def compare_deform_sep(torch, da, measure_ms, dtype, shape, name="K4",
                       layout="panels", special=False, masked=False, timed=True):
    """A sampler's forward against its plain version at `shape`: K4 on panels,
    K10 on the row-major and K3 on the channel-major layout of the same values
    (`special`: points on grid lines and NaN too, see `sep_inputs`); call and
    device (CUDA-graph) times, and the reference's grid_sample formulation on
    the same values beside them (without `timed`, the check alone)."""
    import torch.nn.functional as F

    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    vals, loc, w, dout, outside = sep_inputs(torch, dt, shape, special=special, masked=masked)
    lay = as_layout(torch, da, layout, vals, shapes, dout)
    value = lay.value
    kernel = lambda: lay.fwd(value, loc, w)  # noqa: E731
    plain = lambda: lay.fwd_plain(value, loc, w)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        clean = torch.nan_to_num(loc, nan=-5.0)
        if dtype == "bfloat16" and name in ROUNDED_AS_JAX:  # the plain version rounding alike
            ref = lay.fwd_plain(value, clean, w).float()
        else:
            ref = lay.fwd_plain(to_f32(value), clean, w)
        torch.cuda.synchronize()
        if out.shape != lay.dout.shape or out.dtype != dt:
            raise AssertionError(f"{name} output {tuple(out.shape)} {out.dtype}")
        err = check_close(torch, name, dtype, out, ref,
                          rtol=SAMPLER_RTOL[dtype] if name in ROUNDED_AS_JAX else None)
        if not timed:
            log(f"{name} {dtype} {layout} {[tuple(v.shape) for v in tensors(value)]} Q {Q}: err "
                f"{err:.3g}")
            return {"shape": [list(v.shape) for v in tensors(value)] + [Q], "max_abs_err": err}
        # ~0.05 ms a call: 200 calls a sample, so that launch jitter averages out
        timed = measure_ms(kernel, iters=200, repeats=7)
        ms = timed["ms"]
        device_ms = measure_graph_ms(kernel)["ms"]
        plain_ms = measure_ms(plain, iters=5)["ms"]
        panel_bytes = sep_panel_bytes(torch, vals, loc, shapes, D)
    route = sampler_route(da, name, layout, value, shape)
    library_ms = library_sampler(torch, F, measure_ms, vals, shapes, loc, w, dout, False, 20)
    # bytes the function must move for these locations: of each level only the
    # distinct in-map corners the points name (each D channels wide), once
    # each, and never more than the level; loc and weights in, (B, Q, C) out
    isz = vals[0].element_size()
    nbytes = sum(panel_bytes) + out.numel() * isz + (loc.numel() + w.numel()) * 4
    flops = 2 * 4 * B * Q * H * D * L * P  # 4 corners x (multiply + add) per output channel
    bms, by, _ = bound_ms(nbytes, flops, 0, dtype)
    log(f"{name} {dtype} {layout} {[tuple(v.shape) for v in tensors(value)]} Q {Q}: {outside:.3f} "
        f"of the points outside [0, 1]; err {err:.3g} ms {ms:.4f} (samples {timed['ms_min']:.4f}-"
        f"{timed['ms_max']:.4f}) device {device_ms:.4f} plain {plain_ms:.4f} grid_sample "
        f"{library_ms:.4f} bound {bms:.4f} ({by}, {nbytes / 1e6:.1f} MB: "
        f"levels {[round(b / 1e6, 1) for b in panel_bytes]} of "
        f"{[round(v.numel() * isz / 1e6, 1) for v in vals]} MB){route_note(route)}")
    return {"shape": [list(v.shape) for v in tensors(value)] + [Q], "max_abs_err": err, "ms": ms,
            "ms_min": timed["ms_min"], "ms_max": timed["ms_max"], "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "bound_bytes": nbytes, "panel_bytes_needed": panel_bytes,
            "panel_bytes": [v.numel() * isz for v in vals], "points_outside_share": outside,
            **({"kernel_route": route} if route else {})}


def compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape, name="K5", layout="panels",
                           masked=False, timed=True):
    """A sampler's backward against its plain version: d(value), d(loc) and
    d(weights) from d(out). K5 on panels, K10's backward on the row-major and
    K8 on the channel-major layout of the same values; call and device
    (CUDA-graph) times, and the backward of the reference's grid_sample
    formulation on the same values beside them (without `timed`, the check
    alone)."""
    import torch.nn.functional as F

    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    vals, loc, w, dout, outside = sep_inputs(torch, dt, shape, masked=masked)
    lay = as_layout(torch, da, layout, vals, shapes, dout)
    sep_dout = dout
    value, dout = lay.value, lay.dout
    kernel = lambda: lay.bwd(value, loc, w, dout)  # noqa: E731
    plain = lambda: lay.bwd_plain(value, loc, w, dout)  # noqa: E731
    with torch.no_grad():
        dvals, dloc, dw = kernel()
        bloc = bw = None
        rtol = None
        if dtype == "bfloat16" and name in ("K5", "K8"):  # the plain version rounding alike
            rvals, rloc, rw = lay.bwd_plain(value, loc, w, dout)
            rvals = [rv.float() for rv in tensors(rvals)]
            if name == "K5":
                bloc, bw = da.sep_panels_bwd_bf16_bound(value, shapes, loc, w, dout)
            rtol = SAMPLER_RTOL[dtype]
        else:
            rvals, rloc, rw = lay.bwd_plain(to_f32(value), loc, w, dout.float())
        dvals, rvals = tensors(dvals), tensors(rvals)
        torch.cuda.synchronize()
        # d(value): up to hundreds of f32 additions per position, in an order
        # that changes from run to run: 4 x the f32 bound of the other outputs
        err = max(check_close(torch, f"{name} d(value {i})", dtype, dv, rv, 4.0 * grad_scale(rv),
                              rtol=rtol)
                  for i, (dv, rv) in enumerate(zip(dvals, rvals)))
        err_loc = check_close(torch, f"{name} d(loc)", "float32", dloc, rloc, grad_scale(rloc),
                              bound=bloc)
        err_w = check_close(torch, f"{name} d(weights)", "float32", dw, rw, grad_scale(rw),
                            bound=bw)
        untouched = sum(int(((rv == 0) & (dv.float() != 0)).sum()) for dv, rv in zip(dvals, rvals))
        if untouched:
            raise AssertionError(f"{name}: {untouched} positions no point touches got a gradient")
        if not timed:
            log(f"{name} {dtype} {layout} {[tuple(v.shape) for v in tensors(value)]} Q {Q} P {P}: "
                f"err d(value) {err:.3g} d(loc) {err_loc:.3g} d(w) {err_w:.3g}")
            return {"shape": [list(v.shape) for v in tensors(value)] + [Q], "max_abs_err": err,
                    "max_abs_err_dloc": err_loc, "max_abs_err_dweights": err_w}
        iters = 200 if Q * L * P * B < 1e5 else 50
        timed = measure_ms(kernel, iters=iters, repeats=5)
        ms = timed["ms"]
        device_ms = measure_graph_ms(kernel, iters=iters)["ms"]
        plain_ms = measure_ms(plain, iters=3, repeats=3)["ms"]
        panel_bytes = sep_panel_bytes(torch, vals, loc, shapes, D)
    route = sampler_route(da, name, layout, value, shape)
    library_ms = library_sampler(torch, F, measure_ms, vals, shapes, loc, w, sep_dout, True,
                                 min(iters, 20))
    # bytes: the corners the points name and d(out), loc, weights in; every
    # d(value) position (touched or zero), d(loc) and d(weights) out
    isz = vals[0].element_size()
    nbytes = (sum(panel_bytes) + dout.numel() * isz + (loc.numel() + w.numel()) * 4
              + sum(v.numel() for v in vals) * isz + (loc.numel() + w.numel()) * 4)
    flops = 2 * 2 * 4 * B * Q * H * D * L * P  # per corner and channel: a dot term and an add
    bms, by, _ = bound_ms(nbytes, flops, 0, dtype)
    adds = B * Q * H * L * P * 4 * D
    log(f"{name} {dtype} {layout} {[tuple(v.shape) for v in tensors(value)]} Q {Q} P {P}: "
        f"{outside:.3f} of the points outside [0, 1]; err d(value) {err:.3g} (max |plain| "
        f"{max(rv.abs().max().item() for rv in rvals):.3g}) d(loc) {err_loc:.3g} d(w) {err_w:.3g} "
        f"ms {ms:.4f} (samples {timed['ms_min']:.4f}-{timed['ms_max']:.4f}) device {device_ms:.4f} "
        f"plain {plain_ms:.4f} grid_sample bwd {library_ms:.4f} bound {bms:.4f} ({by}, "
        f"{nbytes / 1e6:.1f} MB; at most {adds / 1e6:.1f} M additions into d(value))"
        f"{route_note(route)}")
    return {"shape": [list(v.shape) for v in tensors(value)] + [Q], "max_abs_err": err,
            "max_abs_err_dloc": err_loc, "max_abs_err_dweights": err_w, "ms": ms,
            "ms_min": timed["ms_min"], "ms_max": timed["ms_max"], "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "bound_bytes": nbytes, "dvalue_additions": adds, "points_outside_share": outside,
            **({"kernel_route": route} if route else {})}


def compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype,
                          iters, timed=True):
    """K6, K7 (with `bias`) or K7nb (the short backward without one) vs the plain
    backward, and SDPA's backward, on one shape: call and device (CUDA-graph)
    times, registers and spills. bf16 is held to `bf16_bwd_error_bound` against
    the plain version that rounds ds and p as the kernels do, and against the
    f32 plain version on the same values; f32 to ATOL x max(1, max |plain|).
    Without `timed`, the check alone."""
    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    qkv, b = attention_inputs(torch, B, C, N, heads, dt, bias, seed=N + C + 1)
    g = torch.Generator(device="cuda").manual_seed(N)
    dout = torch.randn((B, C, N), generator=g, device="cuda").to(dt)
    D = C // heads
    kernel_obj = {"K6": fa.flash_attention_cm_bwd_kernel, "K7": fa.window_attention_bias_bwd_kernel,
                  "K7nb": fa.window_attention_bwd_kernel}[name]
    tag = f"{name} {dtype} qkv {tuple(qkv.shape)}"
    with torch.no_grad():
        if name == "K6":
            # K6 reads the row log-sum-exp that K2 saved
            _, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
            kernel = lambda: fa.flash_attention_cm_bwd(qkv, lse, dout, heads, scale)  # noqa: E731
        else:
            kernel = lambda: fa.window_attention_bias_bwd(qkv, b, dout, heads, scale)  # noqa: E731
        plain = lambda: fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=b)  # noqa: E731
        # the values the kernel works on: in bf16 the panel with the bias rounded in once
        panel = qkv if b is None else qkv + b.to(dt)[:, None]
        ref32 = fa.attention_cm_bwd_plain(panel.float(), dout.float(), heads, scale)
        dqkv = kernel()
        torch.cuda.synchronize()
        if dtype == "bfloat16":
            ref = plain().float()  # ds and p rounded to bf16 before the products
            err = check_bound(torch, tag, dqkv, ref,
                              fa.bf16_bwd_error_bound(qkv, dout, heads, scale, ref, bias=b))
            err32 = check_bound(torch, tag + " vs f32 plain", dqkv, ref32,
                                fa.bf16_bwd_error_bound(qkv, dout, heads, scale, ref32, bias=b))
        else:
            ref = ref32
            err = err32 = check_close(torch, tag, dtype, dqkv, ref, grad_scale(ref))
        if not timed:
            log(f"{tag}: err {err:.3g} (vs f32 plain {err32:.3g}) of max |plain| "
                f"{ref.abs().max().item():.3g}")
            return {"shape": list(qkv.shape), "max_abs_err": err, "max_abs_err_vs_f32_plain": err32}
        attrs = fa.kernel_attributes(kernel_obj, qkv, heads)
        ms = measure_ms(kernel, iters=iters)["ms"]
        device_ms = measure_graph_ms(kernel, iters=iters)["ms"]
        plain_ms = measure_ms(plain, iters=3, repeats=3)["ms"]
    # the library's backward of the same attention: the forward (and its
    # graph) is made here, outside the timing
    q, k, v = (panel.reshape(B, 3, heads, D, N)[:, i].transpose(-1, -2).contiguous()
               .requires_grad_() for i in range(3))
    do_lib = dout.reshape(B, heads, D, N).transpose(-1, -2).contiguous()
    fwd = {"o": F.scaled_dot_product_attention(q, k, v, scale=scale), "leaves": (q, k, v)}
    library = lambda: torch.autograd.grad(fwd["o"], fwd["leaves"], do_lib,  # noqa: E731
                                          retain_graph=True)
    lib = torch.stack([t.transpose(-1, -2) for t in library()], dim=1).reshape(B, 3 * C, N)
    lib_err = (lib.float() - ref32).abs().max().item()
    library_ms = measure_ms(library, iters=iters)["ms"]

    def forward_on_capture_stream():
        # fresh leaves: a leaf keeps the stream of its first forward for its
        # gradient's accumulation, and the captured backward must not leave
        # the capture stream
        fwd.clear()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fwd["o"] = F.scaled_dot_product_attention(*leaves, scale=scale)
        fwd["leaves"] = leaves

    library_device_ms = measure_graph_ms(library, iters=iters,
                                         prepare=forward_on_capture_stream)["ms"]
    isz = qkv.element_size()
    # qkv, d(out), (K7) the bias and (K6) the log-sum-exp in; d(qkv) out
    nbytes = B * (7 * C) * N * isz
    if bias:
        nbytes += 3 * C * 4
    elif name == "K6":
        nbytes += B * heads * N * 4
    flops = 10 * B * heads * N * N * D  # five (N, N, D) products: s, dp, dq, dk, dv
    exps = B * heads * N * N
    bms, by, parts = bound_ms(nbytes, flops, exps, dtype, tf32x3=True)
    log(f"{tag}: err {err:.3g} (vs f32 plain {err32:.3g}) of max |plain| "
        f"{ref.abs().max().item():.3g} (sdpa bwd vs f32 plain {lib_err:.3g}) ms {ms:.4f} plain "
        f"{plain_ms:.4f} sdpa bwd {library_ms:.4f}; device (graph) {device_ms:.4f} sdpa "
        f"{library_device_ms:.4f} (x{device_ms / library_device_ms:.2f}) bound {bms:.4f} ({by}; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items())
        + f"); {attrs['registers']} registers, {attrs['spill_bytes']} spilled bytes"
        + (f" (passes {[(p['registers'], p['spill_bytes']) for p in attrs['passes']]})"
           if "passes" in attrs else ""))
    res = {"shape": list(qkv.shape), "max_abs_err": err, "max_abs_err_vs_f32_plain": err32,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": library_ms, "device_ms": device_ms,
           "library_device_ms": library_device_ms,
           "sdpa_ratio_device": device_ms / library_device_ms,
           "registers": attrs["registers"], "spill_bytes": attrs["spill_bytes"],
           "bound_parts_ms": {k: v * 1e3 for k, v in parts.items()}}
    if "passes" in attrs:
        res["passes"] = attrs["passes"]
    return res


# the attention shapes of the three forwards at batch 8: (key, kernel, B, C, N,
# heads, scale, bias). The ViT folds its scale into q (scale 1); 16 windows an image.
ATTENTION_SHAPES = (
    ("K1", "K1", BATCH * 16, 192, 100, 12, 1.0, True),            # small: head_dim 16
    ("K2", "K2", BATCH, 192, 1600, 12, 1.0, False),
    ("K2dec", "K2", BATCH, 256, 300, 8, 32 ** -0.5, False),       # small's decoder
    ("K1@large", "K1", BATCH * 16, 384, 100, 12, 1.0, True),      # ViT-small: head_dim 32
    ("K2@large", "K2", BATCH, 384, 1600, 12, 1.0, False),
    ("K1@xlarge", "K1", BATCH * 16, 768, 100, 12, 1.0, True),     # ViT-base: head_dim 64
    ("K2@xlarge", "K2", BATCH, 768, 1600, 12, 1.0, False),
    ("K2dec@large", "K2", BATCH, 384, 300, 12, 32 ** -0.5, False),  # large and xlarge decoder
    ("K9", "K9", BATCH, 256, 100, 8, 32 ** -0.5, False),            # tiny's decoder: 100 queries
    ("K9@train", "K9", TRAIN_BATCH * 13, 256, 100, 8, 32 ** -0.5, False),  # 13 groups in the batch
    # the mAP fixture's micro model at the eval pipeline's batch of 4: its
    # window and global blocks, and its decoder's self-attention (12 queries,
    # 4 heads of 16)
    ("K1@micro", "K1", MICRO_BATCH * 16, 192, 100, 12, 1.0, True),
    ("K2@micro", "K2", MICRO_BATCH, 192, 1600, 12, 1.0, False),
    ("K9@micro", "K9", MICRO_BATCH, 64, 12, 4, 16 ** -0.5, False),
)


# the backward shapes of one small train step at batch 4 (3900 queries in 13
# groups of 300, folded into the batch for the decoder's self-attention),
# medium's (ViT-small: head_dim 32; its decoder is small's), K6 at head_dim
# 64, and large's and xlarge's train step at batch 2 (K6, K7 at head_dim 32 /
# 64; their decoder is large's eval decoder, 13 groups a batch element):
# (key, kernel, B, C, N, heads, scale, bias, calls a sample). K7 takes 200
# calls a sample, so that host enqueue time is not in it.
ATTENTION_BWD_SHAPES = (
    ("K7", "K7", TRAIN_BATCH * 16, 192, 100, 12, 1.0, True, 200),
    ("K6", "K6", TRAIN_BATCH, 192, 1600, 12, 1.0, False, 20),
    ("K6dec", "K6", TRAIN_BATCH * 13, 256, 300, 8, 32 ** -0.5, False, 20),
    ("K6@xlarge", "K6", BATCH, 768, 1600, 12, 1.0, False, 5),
    ("K7nb", "K7nb", TRAIN_BATCH * 13, 256, 100, 8, 32 ** -0.5, False, 200),  # tiny's decoder
    ("K6@medium", "K6", TRAIN_BATCH, 384, 1600, 12, 1.0, False, 20),
    ("K7@medium", "K7", TRAIN_BATCH * 16, 384, 100, 12, 1.0, True, 200),
    ("K6@large_train", "K6", LARGE_TRAIN_BATCH, 384, 1600, 12, 1.0, False, 20),
    ("K6@xlarge_train", "K6", LARGE_TRAIN_BATCH, 768, 1600, 12, 1.0, False, 10),
    ("K7@large_train", "K7", LARGE_TRAIN_BATCH * 16, 384, 100, 12, 1.0, True, 200),
    ("K7@xlarge", "K7", LARGE_TRAIN_BATCH * 16, 768, 100, 12, 1.0, True, 200),
    ("K6dec@large_train", "K6", LARGE_TRAIN_BATCH * 13, 384, 300, 12, 32 ** -0.5, False, 20),
)


# The train CLI's loader draws one square size a batch from the release
# recipe's SCALES_SQUARE (data/transforms.py): small's train step at each size
# but 640 (the tables above), patch 16, 4 x 4 windows an image, one memory
# level at stride 16. A window of (g / 4)^2 tokens takes K1 / K7 up to 128
# tokens and K2 / K6 above (the qkv bias added first), a global block K2 / K6
# over g^2 tokens, the decoder's cross-attention the (g, g) panel (K4, K5).
CLI_SCALES = (448, 512, 576, 704, 768, 832, 896)


def cli_scale_shapes():
    """(attention forwards, attention backwards, sampler shapes) of small's
    train step at each of CLI_SCALES, in the formats of the tables above."""
    fwd, bwd, sep = [], [], []
    for size in CLI_SCALES:
        g = size // 16
        win = (g // 4) ** 2
        short = win <= 128
        fk, bk, iters = ("K1", "K7", 200) if short else ("K2", "K6", 20)
        fwd += [(f"{fk}@cli{size}_windows", fk, TRAIN_BATCH * 16, 192, win, 12, 1.0, short),
                (f"K2@cli{size}_global", "K2", TRAIN_BATCH, 192, g * g, 12, 1.0, False)]
        bwd += [(f"{bk}@cli{size}_windows", bk, TRAIN_BATCH * 16, 192, win, 12, 1.0, short, iters),
                (f"K6@cli{size}_global", "K6", TRAIN_BATCH, 192, g * g, 12, 1.0, False, 20)]
        sep.append((f"cli{size}", (TRAIN_BATCH, 16, 16, 2, 3900, [(g, g)])))
    return tuple(fwd), tuple(bwd), tuple(sep)


CLI_ATTENTION_SHAPES, CLI_ATTENTION_BWD_SHAPES, CLI_SEP_SHAPES = cli_scale_shapes()


# M1 against its plain version (the same columns) and scipy (the total within
# 1e-5 relative), (key, S output sets, B, G, Qg, T, valid rows an image, cost):
# small's and large's train steps (last, 2 auxiliary and encoder outputs, 13
# groups of 300 queries, max_gt 100, 7 boxes an image), the worst case (T = 100
# all valid), integer costs in {0, 1, 2} (ties everywhere), the (T, Q) sweep of
# tests/test_matcher.py, and NaN rows (the JAX loop's finite 1e15 ends them)
M1_SWEEP = ((1, 5), (4, 4), (7, 20), (30, 100), (100, 300))
M1_CHECKS = (("small_train", 4, TRAIN_BATCH, 13, 300, 100, (7,) * TRAIN_BATCH, "match"),
             ("large_train", 4, LARGE_TRAIN_BATCH, 13, 300, 100, (7,) * LARGE_TRAIN_BATCH,
              "match"),
             ("worst_T100", 4, TRAIN_BATCH, 13, 300, 100, (100,) * TRAIN_BATCH, "match"),
             ("ties_012", 4, TRAIN_BATCH, 13, 300, 100, (7, 30, 0, 100), "int"),
             *((f"sweep_{t}x{q}", 1, 3, 2, q, t, (t, max(t - 1, 0), t // 2), "normal")
               for t, q in M1_SWEEP),
             ("nan_rows", 4, TRAIN_BATCH, 13, 300, 100, (7,) * TRAIN_BATCH, "nan"))
M1_TIMED = ("small_train", "large_train", "worst_T100")
M1_TIME_LIMIT_S = 60.0  # a launch that has not ended by then has hung: the script fails
M1_SCIPY_RTOL = 1e-5


def m1_inputs(torch, S, B, G, Qg, T, counts, kind, seed):
    """(cost (S, B, T, G * Qg) f32, valid (B, T)) on the card: "match" builds
    the matcher's own cost from random predictions (91 classes), "int" draws
    {0, 1, 2}, "normal" N(0, 9); "nan" is "match" with a valid row of image 0
    and a padded row of image 1 made NaN."""
    from lwdetr_tpu_torch.models import matcher as tm

    g = torch.Generator(device="cuda").manual_seed(seed)
    valid = torch.arange(T, device="cuda")[None, :] < torch.tensor(counts, device="cuda")[:, None]
    if kind in ("match", "nan"):
        logits = torch.randn((S, B, G * Qg, 91), generator=g, device="cuda")
        boxes = torch.rand((S, B, G * Qg, 4), generator=g, device="cuda") * 0.4 + 0.2
        labels = torch.randint(0, 91, (B, T), generator=g, device="cuda")
        tboxes = torch.rand((B, T, 4), generator=g, device="cuda") * 0.4 + 0.2
        cost = tm.match_cost_matrix(logits, boxes, labels, tboxes, valid)
        if kind == "nan":
            cost[:, 0, 1] = float("nan")
            cost[:, 1 % B, T - 1] = float("nan")
    elif kind == "int":
        cost = torch.randint(0, 3, (S, B, T, G * Qg), generator=g, device="cuda").float()
    else:
        cost = 3.0 * torch.randn((S, B, T, G * Qg), generator=g, device="cuda")
    return cost.contiguous(), valid


def within_time(torch, fn, limit_s):
    """fn() launched, then waited for by polling an event; exits the process
    (status 3) rather than wait past `limit_s` on a launch that hangs."""
    import os
    import time

    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > limit_s:
            log(f"M1 did not finish within {limit_s} s: failing")
            os._exit(3)
        time.sleep(1e-3)
    return out, time.perf_counter() - t0


def compare_assignment(torch, measure_ms, key, S, B, G, Qg, T, counts, kind, seed=5):
    """M1 against its plain version and scipy on one set of problems; times at M1_TIMED."""
    import time

    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from lwdetr_tpu_torch.models import matcher as tm
    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    cost, valid = m1_inputs(torch, S, B, G, Qg, T, counts, kind, seed)
    out, wait_s = within_time(torch, lambda: tm.assign(cost, valid, G), M1_TIME_LIMIT_S)
    ref = tm.assign_plain(cost, valid, G)
    if not torch.equal(out, ref):
        bad = (out != ref).nonzero()[:4].tolist()
        raise AssertionError(f"M1 {key}: columns differ from the plain version at {bad}")
    res = {"shape": {"S": S, "B": B, "G": G, "Qg": Qg, "T": T, "valid": list(counts)},
           "cost": kind, "columns_equal_plain": True, "first_wait_s": wait_s}
    host = cost.cpu().numpy().astype(np.float64)
    got = out.cpu().numpy()
    worst = 0.0
    if kind != "nan":
        for s in range(S):
            for b, n in enumerate(counts):
                n = min(n, Qg)
                for g in range(G):
                    block = host[s, b, :n, g * Qg:(g + 1) * Qg]
                    if not n:
                        continue
                    cols = got[s, b, g, :n] - g * Qg
                    if len(set(cols.tolist())) != n:
                        raise AssertionError(f"M1 {key}: columns not distinct at {(s, b, g)}")
                    ri, ci = linear_sum_assignment(block)
                    ours, best = block[np.arange(n), cols].sum(), block[ri, ci].sum()
                    rel = abs(ours - best) / max(1.0, abs(best))
                    worst = max(worst, rel)
        if worst > M1_SCIPY_RTOL:
            raise AssertionError(f"M1 {key}: total cost {worst} from scipy's (relative)")
        res["total_vs_scipy_max_rel"] = worst
    log(f"M1 {key}: columns equal the plain version's; total vs scipy {worst:.3g}")
    if key not in M1_TIMED:
        return res
    call = measure_ms(lambda: tm.assign(cost, valid, G), iters=20, warmup=2, repeats=3)
    device = measure_graph_ms(lambda: tm.assign(cost, valid, G), iters=20, repeats=3)
    plain = measure_ms(lambda: tm.assign_plain(cost, valid, G), iters=1, warmup=0, repeats=1)
    # what the port ran before M1: the valid rows copied to the host, scipy a problem
    scipy_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vb, vt = torch.nonzero(valid, as_tuple=True)
        rows = cost[:, vb, vt].cpu().numpy()
        start = 0
        for b in range(B):
            n = int((vb == b).sum())
            for s in range(S):
                for g in range(G):
                    if n:
                        linear_sum_assignment(rows[s, start:start + n, g * Qg:(g + 1) * Qg])
            start += n
        scipy_s.append(time.perf_counter() - t0)
    nbytes = cost.numel() * 4 + valid.numel() + out.numel() * 8
    bms, by, _ = bound_ms(nbytes, 0.0, 0.0, "float32")
    attrs = tm.kernel_attributes()
    if attrs["local_bytes"]:
        raise AssertionError(f"M1 spills: {attrs}")
    layout = tm.shared_layout(T, Qg)
    res.update({"ms": call["ms"], "device_ms": device["ms"], "plain_ms": plain["ms"],
                "scipy_host_ms_with_copy": sorted(scipy_s)[1] * 1e3,
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "registers": attrs["registers"], "local_bytes": attrs["local_bytes"],
                "shared_bytes": layout["shared_bytes"] + attrs["static_shared_bytes"],
                "staged_rows": layout["staged_rows"],
                "threads": (Qg + 1 + 31) // 32 * 32, "ctas": S * B * G})
    print(f"M1 {key}: {S * B * G} problems, call {call['ms']:.4f} ms, device (CUDA graph) "
          f"{device['ms']:.4f} ms, plain {plain['ms']:.2f} ms, scipy on the host with the copy "
          f"{res['scipy_host_ms_with_copy']:.2f} ms; byte bound {bms:.4f} ms; "
          f"{attrs['registers']} registers, {res['shared_bytes']} shared bytes, "
          f"{attrs['local_bytes']} local bytes")
    return res


def kernel_phase(torch, F, fa, da, measure_ms):
    """Every kernel against its plain version at the eval and train paths' shapes."""
    from lwdetr_tpu_torch.data import transforms

    if set(CLI_SCALES) | {640} != set(transforms.SCALES_SQUARE):
        raise AssertionError(f"CLI_SCALES {CLI_SCALES} + 640 are not the loader's "
                             f"{transforms.SCALES_SQUARE}")
    res = {}
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in ATTENTION_SHAPES + CLI_ATTENTION_SHAPES:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype)
        for key, shape in (("K3", SEP_SMALL), ("K3@tiny", SEP_TINY), ("K3@micro", SEP_MICRO),
                           ("K3@tiny_train", SEP_TINY_TRAIN), ("K3@large", SEP_LARGE),
                           *((f"K3@{k}", v) for k, v in CM_CHECKS)):
            res[(key, dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape, "K3", "cm")
        for key, shape in (("K4", SEP_LARGE), ("K4@train", SEP_SMALL_TRAIN),
                           ("K4@tiny_train", SEP_TINY_TRAIN), ("K4@large_train", SEP_LARGE_TRAIN_B2),
                           *((f"K4@{k}", v) for k, v in CLI_SEP_SHAPES)):
            res[(key, dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape)
        for key, name, B, C, N, heads, scale, bias, iters in (ATTENTION_BWD_SHAPES
                                                              + CLI_ATTENTION_BWD_SHAPES):
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters)
        for key, shape in (("K5", SEP_SMALL_TRAIN), ("K5@large", SEP_LARGE_TRAIN),
                           ("K5@tiny_train", SEP_TINY_TRAIN), ("K5@large_train", SEP_LARGE_TRAIN_B2),
                           *((f"K5@{k}", v) for k, v in SEP_BWD_CHECKS + CLI_SEP_SHAPES)):
            res[(key, dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape)
        for key, shape in SEP_BWD_CHECKS:
            res[(f"K10b@{key}", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape,
                                                                 "K10b", "rowmajor")
        for key, shape in (("K8", SEP_TINY_TRAIN), ("K8@small", SEP_SMALL_TRAIN),
                           ("K8@large", SEP_LARGE_TRAIN), *((f"K8@{k}", v) for k, v in CM_CHECKS)):
            res[(key, dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape,
                                                       "K8", "cm")
        for key, shape in (("K10", SEP_TINY_TRAIN), ("K10@eval", SEP_TINY)):
            res[(key, dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape,
                                                   "K10", "rowmajor")
        for key, shape in SEP_CHECKS:
            for name, layout in (("K4", "panels"), ("K10", "rowmajor")):
                res[(f"{name}@{key}", dtype)] = compare_deform_sep(
                    torch, da, measure_ms, dtype, shape, name, layout, special=True)
        res[("K10b", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype,
                                                      SEP_TINY_TRAIN, "K10b", "rowmajor")
    for key, *shape in M1_CHECKS:  # float32 costs only
        res[(f"M1@{key}", "float32")] = compare_assignment(torch, measure_ms, key, *shape)
    return res


def plain_attention(fa):
    """`attention_cm` on the plain version (autograd through it gives the reference gradients)."""

    def attention(qkv_t, num_heads, scale=None, bias=None):
        if bias is not None:
            qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
        return fa.attention_cm_plain(qkv_t, num_heads, scale)

    return attention


def plain_patches(fa, da):
    """Every kernel of the eval forward, and the matcher, swapped for its plain version."""
    from lwdetr_tpu_torch.models import matcher as tm

    return (mock.patch.object(fa, "attention_cm", plain_attention(fa)),
            mock.patch.object(da, "ms_deform_attn_cm", da.ms_deform_attn_cm_plain),
            mock.patch.object(da, "ms_deform_attn_sep_panels", da.ms_deform_attn_sep_panels_plain),
            mock.patch.object(tm, "assign", tm.assign_plain))


def plain_backward_patches(fa, da):
    """Every backward kernel swapped for its plain version (the forward kernels stay)."""
    return (mock.patch.object(fa, "window_attention_bias_bwd",
                              lambda qkv, bias, dout, heads, scale:
                              fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=bias)),
            mock.patch.object(fa, "flash_attention_cm_bwd",
                              lambda qkv, lse, dout, heads, scale:
                              fa.attention_cm_bwd_plain(qkv, dout, heads, scale)),
            mock.patch.object(da, "ms_deform_attn_sep_panels_bwd",
                              da.ms_deform_attn_sep_panels_bwd_plain),
            mock.patch.object(da, "ms_deform_attn_cm_bwd", da.ms_deform_attn_cm_bwd_plain),
            mock.patch.object(da, "ms_deform_attn_bwd", da.ms_deform_attn_bwd_plain))


ULP_JITTER = 2.0 ** -23  # one f32 ulp of a value in [1, 2)
# an f32 variant eval's kernels against the plain run, each output set: at
# most this many times the one-ulp run's distance, plus the floor (on an
# H100 the two read 0.85-1.22 of each other at the decoder's last layer)
JITTER_FACTOR, JITTER_FLOOR = 4.0, 1e-5


def jittered_plain_patches(torch, fa, da, seed):
    """`plain_patches` with each output of the kernels' plain versions moved by
    one f32 ulp: times 1 +- 2^-23, the sign drawn an element from `seed`. The
    least rounding difference a kernel can make there; the outputs' distance
    from the unjittered plain run is how far the model carries it."""
    from lwdetr_tpu_torch.models import matcher as tm

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jittered(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            sign = torch.randint(0, 2, out.shape, generator=gen, device=out.device) * 2 - 1
            return out * (1 + sign.to(out.dtype) * ULP_JITTER)

        return call

    return (mock.patch.object(fa, "attention_cm", jittered(plain_attention(fa))),
            mock.patch.object(da, "ms_deform_attn_cm", jittered(da.ms_deform_attn_cm_plain)),
            mock.patch.object(da, "ms_deform_attn_sep_panels",
                              jittered(da.ms_deform_attn_sep_panels_plain)),
            mock.patch.object(tm, "assign", tm.assign_plain))


def run_patched(fn, patches):
    from contextlib import ExitStack

    with ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        return fn()


def counted(torch, kernels, fn):
    """fn() with every launch counter set to 0 just before and read just after."""
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in kernels}


class Picks:
    """`transformer.select_proposals` recorded on a first run and replayed on
    later ones, cyclically: the two-stage head picks its queries by score,
    near-tied scores can swap under another rounding, and a swap reseeds
    whole queries (trap (d)). A replaying run's own picks are kept in `own`,
    to be compared with the replayed ones on their own. The patches replace
    a module attribute, so the model must call `tr.select_proposals` through
    its module: the launch and replay counts check that it does."""

    def __init__(self, tr, recorded=None):
        self.tr, self.select = tr, tr.select_proposals
        self.recorded = [] if recorded is None else recorded
        self.own, self.pool = [], None

    def record(self, scores, k):
        self.pool = scores.shape[1]
        self.recorded.append(self.select(scores, k))
        return self.recorded[-1]

    def replay(self, scores, k):
        self.own.append(self.select(scores, k))
        return self.recorded[(len(self.own) - 1) % len(self.recorded)]

    def patch(self, replay):
        return mock.patch.object(self.tr, "select_proposals",
                                 self.replay if replay else self.record)


def forward_phase(torch, fa, da, kernels, preset):
    """`preset`'s eval path once through the kernels (counted), once through the plain versions."""
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.models.lwdetr import build_model, post_process
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = get_config(preset)
    model = build_model(cfg, device="cuda", dtype=torch.float32,
                        state_dict=init_state_dict(cfg, seed=0))
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((BATCH, 640, 640, 3), generator=g, device="cuda")
    sizes = torch.full((BATCH, 2), 640.0, device="cuda")

    def run():
        with torch.no_grad():
            out = model(images)
            dets = post_process(out["pred_logits"], out["pred_boxes"], sizes, cfg.num_select)
        torch.cuda.synchronize()
        return out, dets

    # the two-stage head picks 300 (tiny: 100) of the 1600 (P4) or 6800 (P3 +
    # P5) proposals by score: the plain run reuses the kernel run's picks
    # (compared on their own), so that the outputs compare query for query
    picks = Picks(tr)
    (out, dets), launches = counted(torch, kernels, lambda: run_patched(run, (picks.patch(False),)))
    log(f"{preset}@640 launches: {launches}")
    if launches != EXPECTED_LAUNCHES[preset]:
        raise AssertionError(f"{preset}: launches {launches} != {EXPECTED_LAUNCHES[preset]}")

    (ref, ref_dets), n = counted(torch, kernels, lambda: run_patched(
        run, plain_patches(fa, da) + (picks.patch(True),)))
    if any(n.values()):
        raise AssertionError(f"{preset}: the plain forward launched a kernel: {n}")
    if len(picks.recorded) != 1 or len(picks.own) != 1:
        raise AssertionError(f"proposal picks: {len(picks.recorded)} recorded, "
                             f"{len(picks.own)} replayed")
    recorded, own = picks.recorded[0], picks.own[0]
    same_pos = (recorded == own).float().mean().item()
    same_set = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
                   for a, b in zip(recorded, own))
    log(f"{preset}@640 two-stage picks ({recorded.shape[1]} of {picks.pool}), kernels vs plain: "
        f"same position {same_pos:.4f}, same set min {same_set:.4f}")
    if same_set < MIN_TOPK_OVERLAP:
        raise AssertionError(f"two-stage picks differ: set overlap {same_set}")

    logits, boxes = out["pred_logits"], out["pred_boxes"]
    if logits.shape != (BATCH, cfg.num_queries, 91) or boxes.shape != (BATCH, cfg.num_queries, 4):
        raise AssertionError(f"shapes {tuple(logits.shape)} {tuple(boxes.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
        raise AssertionError("non-finite outputs")
    err_l = (logits - ref["pred_logits"]).abs().max().item()
    err_b = (boxes - ref["pred_boxes"]).abs().max().item()
    K = logits.shape[-1]
    overlap = []
    for b in range(BATCH):
        sel = lambda lg: set(torch.topk(lg[b].reshape(-1), cfg.num_select).indices.tolist())  # noqa: E731
        overlap.append(len(sel(logits) & sel(ref["pred_logits"])) / cfg.num_select)
    log(f"{preset}@640 f32 forward, kernels vs plain: logits err {err_l:.3g}, boxes err {err_b:.3g}, "
        f"top-{cfg.num_select} (query, label) overlap min {min(overlap):.4f} (K={K})")
    if err_l > FWD_ATOL_LOGITS or err_b > FWD_ATOL_BOXES or min(overlap) < MIN_TOPK_OVERLAP:
        raise AssertionError(f"{preset}: forward disagrees with the plain versions: logits {err_l}, "
                             f"boxes {err_b}, overlap {min(overlap)}")
    scores = dets[0]
    if not torch.isfinite(scores).all() or scores.shape != (BATCH, cfg.num_select):
        raise AssertionError("post_process scores are not finite or of the wrong shape")

    # the same weights in bf16 (the deployed precision: float32 parameters,
    # bf16 compute), with the f32 run's proposal picks (bf16 scores tie often):
    # the same launches; how far from f32 (reported: bf16 rounds at every
    # layer); and, on the same picks, the bf16 forward on the plain versions
    # (which round p as the kernels do) over all queries, within the JAX
    # package's bf16 drift ceiling, with float32 boxes
    model16 = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                          state_dict=init_state_dict(cfg, seed=0))
    images16 = images.to(torch.bfloat16)
    picks.own.clear()
    with torch.no_grad():
        out16, launches16 = counted(torch, kernels, lambda: run_patched(
            lambda: model16(images16), (picks.patch(True),)))
    if launches16 != EXPECTED_LAUNCHES[preset]:
        raise AssertionError(f"{preset} bf16: launches {launches16} != {EXPECTED_LAUNCHES[preset]}")
    if len(picks.own) != 1:
        raise AssertionError(f"bf16 forward replayed {len(picks.own)} of 1 picks")
    if not (torch.isfinite(out16["pred_logits"]).all() and torch.isfinite(out16["pred_boxes"]).all()):
        raise AssertionError("non-finite bf16 outputs")
    if out16["pred_boxes"].dtype != torch.float32 or out16["pred_logits"].dtype != torch.bfloat16:
        raise AssertionError(f"bf16 forward: boxes {out16['pred_boxes'].dtype}, logits "
                             f"{out16['pred_logits'].dtype}")
    bf16_set = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
                   for a, b in zip(recorded, picks.own[0]))
    bf16_l = (out16["pred_logits"].float() - logits).abs().max().item()
    bf16_b = (out16["pred_boxes"].float() - boxes).abs().max().item()
    log(f"{preset}@640 bf16 forward vs f32 (f32 picks): logits max diff {bf16_l:.3g}, "
        f"boxes {bf16_b:.3g}; bf16's own picks share {bf16_set:.4f} of the f32 set")
    picks.own.clear()
    with torch.no_grad():
        ref16, n = counted(torch, kernels, lambda: run_patched(
            lambda: model16(images16), plain_patches(fa, da) + (picks.patch(True),)))
    if any(n.values()):
        raise AssertionError(f"{preset}: the plain bf16 forward launched a kernel: {n}")
    dp = (out16["pred_logits"].float().sigmoid() - ref16["pred_logits"].float().sigmoid()).abs()
    db = (out16["pred_boxes"] - ref16["pred_boxes"]).abs()
    drift = {"prob_mean": dp.mean().item(), "prob_max": dp.max().item(),
             "box_mean": db.mean().item()}
    log(f"{preset}@640 bf16 forward, kernels vs plain, all {cfg.num_queries} queries: " +
        ", ".join(f"{k} {v:.3g} (ceiling {BF16_DRIFT[k]})" for k, v in drift.items()) +
        f"; boxes max {db.max().item():.3g}")
    if any(v >= BF16_DRIFT[k] for k, v in drift.items()):
        raise AssertionError(f"{preset}: bf16 forward drifts from its plain versions: {drift}")
    return launches, {"logits_max_abs_err": err_l, "boxes_max_abs_err": err_b,
                      "bf16_vs_f32_logits_max_diff": bf16_l, "bf16_vs_f32_boxes_max_diff": bf16_b,
                      "bf16_own_picks_same_set_min": bf16_set,
                      "bf16_kernels_vs_plain": {**drift, "box_max": db.max().item()},
                      "topk_overlap_min": min(overlap), "proposal_picks_same_position": same_pos,
                      "proposal_picks_same_set_min": same_set}


def train_phase(torch, fa, da, kernels, measure_ms, card, preset):
    """`preset`'s f32 train step at 640x640, batch 4, in each cross-attention
    branch of TRAIN_BRANCHES: launch counts, gradients through the kernels vs the
    plain versions, the branches' losses against one another, a few optimizer
    steps in the default branch, every branch's step time. Returns
    ({path: launches}, numbers)."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import transformer as tr

    state, step = bench_train.make_train_step(preset, TRAIN_BATCH, seed=0)
    model = state.model
    mcfg = model.cfg
    criterion = cm.SetCriterion(mcfg, bench_train.get_train_config(preset))
    data = bench_train.synthetic_batch(mcfg.num_classes, TRAIN_BATCH, 640, 100, 7, "cuda", seed=0)
    targets = cm.Targets(data["labels"], data["boxes"], data["valid"])
    tag = f"{preset}@640 train step"

    # (a) one forward + backward through the kernels, then (a1) the same forward
    # with each backward kernel swapped for its plain version, in every branch,
    # and (a2) the whole step on the plain versions with torch.autograd. Near-tied
    # proposal scores and matching costs can flip under f32 rounding and would
    # reseed whole queries, so every run after the first replays the first run's
    # picks (13 groups) and its matching. The step has more kinks than those: a
    # plain forward differs from the kernels' by ~1e-6, which flips ReLU units of
    # the decoder's FFN and moves sampling points across grid lines, and each
    # flip moves a gradient tensor by up to 1e-2 of its maximum. So the
    # per-tensor bound holds (a1), where both runs share one forward bit for bit,
    # and (a2) is held to the loss and to the relative L2 error over all gradients.
    picks, match, matchings = Picks(tr), cm.hungarian_match, []

    def record_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def grads():
        model.zero_grad(set_to_none=True)
        out = model(data["images"])
        total, losses = criterion(out, targets, train=True)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}

    def compare(grads_k, grads_ref, label):
        """Per tensor: max |difference| over max |reference|, with a floor of
        GRAD_FLOOR x the largest gradient of all, since some gradients are zero
        in exact arithmetic (a bias in front of a train-mode BatchNorm)."""
        top = max(g.abs().max().item() for g in grads_ref.values())
        rel = {n: ((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
               for n, g in grads_ref.items()}
        worst = max(rel, key=rel.get)
        num = sum((grads_k[n] - g).double().square().sum() for n, g in grads_ref.items())
        l2 = (num / sum(g.double().square().sum() for g in grads_ref.values())).sqrt().item()
        log(f"{tag}, kernels vs {label}, f32, batch {TRAIN_BATCH}: gradient max "
            f"rel err over {len(rel)} parameter tensors {rel[worst]:.3g} ({worst}), median "
            f"{sorted(rel.values())[len(rel) // 2]:.3g}; relative L2 error of all gradients {l2:.3g}")
        return rel[worst], worst, l2, rel

    def replay_match(*args, **kwargs):
        match(*args, **kwargs)  # M1 runs on every path, once a step; the first run's matching
        return matchings[0]     # is what the step uses, so that the runs compare

    def replay():
        return (picks.patch(True), mock.patch.object(cm, "hungarian_match", replay_match))

    launches, branch_res, default_grads = {}, {}, None
    for branch in TRAIN_BRANCHES[preset]:
        path = preset if branch is None else f"{preset}/{branch}"
        tr.set_force_branch(model, branch)
        first = not picks.recorded
        patches = ((picks.patch(False), mock.patch.object(cm, "hungarian_match", record_match))
                   if first else replay())
        (loss_k, grads_k), launches[path] = counted(torch, kernels,
                                                    lambda: run_patched(grads, patches))
        log(f"{path}@640 train step launches: {launches[path]}")
        if launches[path] != TRAIN_LAUNCHES[path]:
            raise AssertionError(f"{path} train step: launches {launches[path]} != "
                                 f"{TRAIN_LAUNCHES[path]}")
        if not all(torch.isfinite(g).all() for g in grads_k.values()):
            raise AssertionError(f"{path}: non-finite gradients")

        (loss_b, grads_b), n = counted(torch, kernels, lambda: run_patched(
            grads, replay() + plain_backward_patches(fa, da)))
        if any(n[k] for k in BACKWARD_KERNELS):
            raise AssertionError(f"{path}: the step on the plain backwards launched a backward "
                                 f"kernel: {n}")
        bwd_err, bwd_worst, bwd_l2, rel = compare(
            grads_k, grads_b, f"the plain backwards on the same forward ({path})")
        # the gradients that d(loc) of the samplers feeds first (trap (c))
        offsets = {n: e for n, e in rel.items() if n.endswith("sampling_offsets.weight")}
        log(f"{path}@640 sampling_offsets.weight vs the plain backwards: "
            + ", ".join(f"{n.split('.cross_attn')[0]} {e:.3g}" for n, e in offsets.items()))
        if abs(loss_b - loss_k) > 1e-6 * abs(loss_k) or bwd_err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{path}: backward kernels disagree with their plain versions: "
                                 f"{bwd_worst} {bwd_err}, loss {loss_k} vs {loss_b}")
        branch_res[path] = {"loss_kernels": loss_k, "grad_max_rel_err_plain_backwards": bwd_err,
                            "grad_worst_tensor_plain_backwards": bwd_worst,
                            "grad_rel_l2_plain_backwards": bwd_l2,
                            "sampling_offsets_weight_rel_err": offsets}
        if branch is None:
            default_grads = grads_k
        del grads_b
    tr.set_force_branch(model, None)
    branch_losses = [r["loss_kernels"] for r in branch_res.values()]
    log(f"{tag} loss by branch: " + ", ".join(f"{p} {r['loss_kernels']:.7f}"
                                               for p, r in branch_res.items()))
    if max(branch_losses) - min(branch_losses) > BRANCH_LOSS_ATOL:
        raise AssertionError(f"{preset}: the branches' losses differ: {branch_losses}")
    loss_k, grads_k = branch_res[preset]["loss_kernels"], default_grads

    n_replayed = len(picks.own)
    (loss_p, grads_p), n = counted(torch, kernels, lambda: run_patched(
        grads, replay() + plain_patches(fa, da)))
    if any(n.values()):
        raise AssertionError(f"the plain train step launched a kernel: {n}")
    runs = 2 * len(TRAIN_BRANCHES[preset])  # every run after the first replays
    if (len(picks.recorded) != mcfg.group_detr or len(picks.own) != runs * len(picks.recorded)
            or len(matchings) != 1):
        raise AssertionError(f"{len(picks.recorded)} picks recorded, {len(picks.own)} replayed, "
                             f"{len(matchings)} matchings")
    same_pick = min((a == b).float().mean().item()
                    for a, b in zip(picks.recorded, picks.own[n_replayed:]))
    log(f"{tag} loss, kernels {loss_k:.7f} vs all plain {loss_p:.7f}; the plain "
        f"forward's own picks at the same position {same_pick:.4f}")
    all_err, all_worst, all_l2, _ = compare(grads_k, grads_p,
                                            "the whole step on the plain versions")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or all_l2 > TRAIN_GRAD_L2:
        raise AssertionError(f"train step disagrees with the plain versions: loss {loss_k} vs "
                             f"{loss_p}, relative L2 error of the gradients {all_l2}")
    del grads_k, grads_p, default_grads
    model.zero_grad(set_to_none=True)

    # (c) a few steps on that batch with the release optimizer settings
    n_steps = TRAIN_STEPS[preset]
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step()["loss"]) for _ in range(n_steps)]
    log(f"{preset}@640 {n_steps} train steps, loss: " + " ".join(f"{x:.4f}" for x in losses))
    moved = max((state.ema[k] - v.detach()).abs().max().item()
                for k, v in model.named_parameters())
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if losses[-1] >= losses[0] or state.step != n_steps or moved <= 0:
        raise AssertionError(f"training made no progress: loss {losses[0]} -> {losses[-1]}, "
                             f"step {state.step}, max |ema - parameters| {moved}")

    # (d) step time after those warm-up steps, in every branch, and the matcher's host time
    timer = bench_train.HostTimer(cm.hungarian_match)
    step_ms = {}
    with mock.patch.object(cm, "hungarian_match", timer):
        for branch in TRAIN_BRANCHES[preset]:
            tr.set_force_branch(model, branch)
            path = preset if branch is None else f"{preset}/{branch}"
            step_ms[path] = measure_ms(step, iters=5, warmup=0 if branch is None else 1, repeats=3)
    tr.set_force_branch(model, None)
    t = step_ms[preset]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    m1_ms = bench_train.matcher_device_ms(step)
    res = {"batch": TRAIN_BATCH, "launches": launches[preset], "loss_kernels": loss_k,
           "loss_plain": loss_p, **{k: v for k, v in branch_res[preset].items() if k.startswith("grad")},
           "branches": branch_res,
           "grad_max_rel_err_all_plain": all_err, "grad_worst_tensor_all_plain": all_worst,
           "grad_rel_l2_all_plain": all_l2,
           "picks_same_position_min": same_pick, "losses": losses,
           "ema_max_abs_distance": moved, "step_ms": t["ms"], "step_ms_samples": t["samples"],
           "step_ms_by_branch": {p: v["ms"] for p, v in step_ms.items()},
           "img_per_s": TRAIN_BATCH / (t["ms"] / 1e3),
           "matcher_host_ms_per_step": timer.seconds * 1e3 / timer.calls,
           "matcher_device_ms_per_step": m1_ms,
           "peak_memory_mb": peak, "card": card}
    print(f"{preset}@640 f32 train step, batch {TRAIN_BATCH}: {t['ms']:.3f} ms "
          f"({card}), samples {[round(x, 3) for x in t['samples']]}"
          + "".join(f"; {p} {v['ms']:.3f} ms" for p, v in step_ms.items() if p != preset))
    print(f"lwdetr_{preset}_640_f32_train_throughput: {res['img_per_s']:.3f} img/s ({card})")
    print(f"matcher: host {res['matcher_host_ms_per_step']:.3f} ms a step (the costs built and "
          f"M1 enqueued, no wait), M1 device {m1_ms:.4f} ms a step ({card})")
    print(f"peak device memory over the train steps: {peak:.1f} MiB ({card})")
    return launches, res


def release_train_phase(torch, fa, da, kernels, measure_ms, card, path, preset, dtype, remat):
    """`preset`'s release train step at 640x640, batch LARGE_TRAIN_BATCH, in
    `dtype` (f32 parameters), with remat if asked: stochastic depth at the
    release rate's step-0 value, its masks drawn once and replayed; the launch
    counts; the gradients through the backward kernels against the plain
    backwards on one shared forward (picks, matching and masks replayed), per
    parameter tensor; a few steps' time and the peak device memory of a step.
    Returns (launches, numbers)."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import drop
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.train.optim import drop_path_rates_for, drop_scheduler

    dt = getattr(torch, dtype)
    B = LARGE_TRAIN_BATCH
    torch.cuda.empty_cache()
    state, step = bench_train.make_train_step(preset, B, seed=0, dtype=dt, grad_checkpointing=remat)
    model = state.model
    mcfg = model.cfg
    tcfg = bench_train.get_train_config(preset)
    criterion = cm.SetCriterion(mcfg, tcfg)
    data = bench_train.synthetic_batch(mcfg.num_classes, B, 640, 100, 7, "cuda", seed=0)
    targets = cm.Targets(data["labels"], data["boxes"], data["valid"])
    sched = drop_scheduler(mcfg.drop_path, tcfg.epochs, bench_train.NITER_PER_EP,
                           tcfg.cutoff_epoch, tcfg.drop_mode, tcfg.drop_schedule)
    rates = drop_path_rates_for(float(sched[0]), mcfg.vit_encoder_num_layers)
    bern = drop.Bernoulli(drop.step_generator("cuda", 0, 0))
    masks = []

    def record_mask(keep, shape, like):
        masks.append(bern(keep, shape, like))
        return masks[-1]

    picks, match, matchings = Picks(tr), cm.hungarian_match, []

    def record_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def grads(source):
        model.zero_grad(set_to_none=True)
        out = model(data["images"], None, rates, mcfg.dropout, source)
        total, _ = criterion(out, targets, train=True)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}

    torch.cuda.reset_peak_memory_stats()
    (loss_k, grads_k), launches = counted(torch, kernels, lambda: run_patched(
        lambda: grads(record_mask),
        (picks.patch(False), mock.patch.object(cm, "hungarian_match", record_match))))
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 20
    expect = TRAIN_LAUNCHES[f"{preset}/remat" if remat else preset]
    log(f"{path} launches: {launches}; {len(masks)} drop-path masks")
    if launches != expect:
        raise AssertionError(f"{path}: launches {launches} != {expect}")
    if len(masks) != 2 * (mcfg.vit_encoder_num_layers - 1):  # block 0's rate is 0
        raise AssertionError(f"{path}: {len(masks)} drop-path masks drawn")
    if not all(torch.isfinite(g).all() for g in grads_k.values()):
        raise AssertionError(f"{path}: non-finite gradients")
    fed = drop.Fed(masks)
    (loss_b, grads_b), n = counted(torch, kernels, lambda: run_patched(
        lambda: grads(fed),
        (picks.patch(True), mock.patch.object(cm, "hungarian_match", lambda *a, **kw: matchings[0]))
        + plain_backward_patches(fa, da)))
    if len(picks.own) != len(picks.recorded) or fed.used != len(masks):
        raise AssertionError(f"{path}: {len(picks.own)} of {len(picks.recorded)} picks and "
                             f"{fed.used} of {len(masks)} masks replayed")
    if any(n[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"{path}: the step on the plain backwards launched a backward "
                             f"kernel: {n}")
    top = max(g.abs().max().item() for g in grads_b.values())
    zero = exact_zero_grads(model) if dtype == "bfloat16" else set()
    rel = {n: ((grads_k[n].float() - g.float()).abs().max()
               / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
           for n, g in grads_b.items() if n not in zero}
    zero_err = max([(grads_k[n] - grads_b[n]).abs().max().item() / top for n in zero] + [0.0])
    worst = max(rel, key=rel.get)
    median = sorted(rel.values())[len(rel) // 2]
    bound = TRAIN_GRAD_RTOL if dtype == "float32" else BF16_TRAIN_GRAD_RTOL
    log(f"{path}, kernels vs the plain backwards on the same forward: gradient max rel err over "
        f"{len(rel)} tensors {rel[worst]:.3g} ({worst}), median {median:.3g} (bound {bound}); "
        f"{len(zero)} trap (a) tensors within {zero_err:.3g} of the largest gradient "
        f"(bound {BF16_ZERO_GRAD_ATOL}); loss {loss_k:.7f} vs {loss_b:.7f}")
    median_bound = BF16_TRAIN_GRAD_MEDIAN if dtype == "bfloat16" else TRAIN_GRAD_RTOL
    if (abs(loss_b - loss_k) > 1e-6 * abs(loss_k) or rel[worst] > bound
            or median > median_bound or zero_err > BF16_ZERO_GRAD_ATOL):
        raise AssertionError(f"{path}: backward kernels disagree with their plain versions: "
                             f"{worst} {rel[worst]}, trap (a) {zero_err}, loss {loss_k} vs {loss_b}")
    del grads_k, grads_b
    model.zero_grad(set_to_none=True)
    losses = [float(step()["loss"]) for _ in range(2)]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"{path}: non-finite loss {losses}")
    t = measure_ms(step, iters=3, warmup=0, repeats=2)
    res = {"batch": B, "dtype": dtype, "remat": remat, "launches": launches,
           "loss_kernels": loss_k, "grad_max_rel_err_plain_backwards": rel[worst],
           "grad_worst_tensor_plain_backwards": worst, "grad_median_rel_err": median,
           "grad_bound": bound, "grad_trap_a_err": zero_err,
           "drop_path_rate_step0": float(sched[0]),
           "masks": len(masks), "losses": losses, "step_ms": t["ms"],
           "step_ms_samples": t["samples"], "img_per_s": B / (t["ms"] / 1e3),
           "peak_memory_mb_first_step": peak_step, "card": card}
    print(f"{path}: {t['ms']:.3f} ms a step, {res['img_per_s']:.3f} img/s, peak device memory "
          f"{peak_step:.1f} MiB ({card})")
    del state, step, model
    torch.cuda.empty_cache()
    return launches, res


# the eval entry point on the mAP fixture (`tests/fixtures/micro_map/`: 20
# JPEGs, COCO annotations, the micro model's weights and the 12 stats the JAX
# package's pipeline gives them). The micro model through the port's CLI
# (`lwdetr_tpu_torch.main --eval`), batch 4: 5 batches, each launching K1 once
# (one window block), K2 once (one global block), K9 twice (the decoder's
# self-attention over 12 queries), K3 twice (its cross-attention, 1600
# memory positions) and M1 once (the eval losses' matching); small's release
# preset at batch 8: 3 batches of K1 6, K2 7, K3 3, M1 1.
FIXTURE = "tests/fixtures/micro_map"
MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()
MICRO_EVAL_BATCHES = 5
MICRO_EVAL_LAUNCHES = launch_counts(K1=5, K2=5, K9=10, K3=10, M1=5)
SMALL_EVAL_BATCH = 8
SMALL_EVAL_BATCHES = 3  # 20 images, the last batch padded with repeats
SMALL_EVAL_LAUNCHES = launch_counts(K1=18, K2=21, K3=9, M1=3)
FIXTURE_REPEATS = 10  # the fixture's passes in the eval loop's longer window
# the f32 pipeline holds the JAX package's golden stats as its test does
# (tests/test_micro_map_golden.py); the bf16 one is held to the JAX test's
# envelope around the f32 golden (random weights: scores within a bf16 ulp
# of one another swap ranks, and AP on 20 images moves with them)
GOLDEN_ATOL = 1e-7
BF16_GOLDEN_ENVELOPE = 0.55


class Recorder(Picks):
    """The two-stage proposal picks (recorded, or replayed from another run
    so that near-tied scores pick alike: trap (d)) and, for each batch, the
    model's outputs and `post_process`'s detections, copied to the host,
    with the flat (query, label) index of each detection."""

    def __init__(self, torch, tr, engine, replay_from=None):
        super().__init__(tr, None if replay_from is None else replay_from.recorded)
        self.torch, self.replaying = torch, replay_from is not None
        self.engine, self.post_process = engine, engine.post_process
        self.outputs = []

    def record_post_process(self, logits, boxes, sizes, num_select):
        dets = self.post_process(logits, boxes, sizes, num_select=num_select)
        self.outputs.append({"logits": logits.float().cpu(), "boxes": boxes.float().cpu(),
                             "sizes": sizes.float().cpu(),
                             "picks": detection_index(self.torch, logits, boxes, sizes, dets).cpu(),
                             "dets": [d.float().cpu() for d in dets]})
        return dets

    def patches(self):
        return (self.patch(self.replaying),
                mock.patch.object(self.engine, "post_process", self.record_post_process))


def detection_index(torch, logits, boxes, sizes, dets):
    """The flat (query, label) index of each detection `post_process`
    returned: the query whose box, scaled as `post_process` scales it, is
    the detection's box bit for bit, and whose score for the detection's
    label is nearest its score. A second top-k call would not do: among tied
    bf16 logits the order of a top-k on the card may change from one call to
    the next, and a detection would then be set against another's box."""
    from lwdetr_tpu_torch.ops import box_ops

    scores, labels, det_boxes = dets
    B, Q, K = logits.shape
    h, w = sizes[:, 0], sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=1).to(torch.float32)
    all_boxes = box_ops.box_cxcywh_to_xyxy(boxes.float()) * scale[:, None, :]  # (B, Q, 4)
    same_box = (all_boxes[:, :, None, :] == det_boxes[:, None, :, :]).all(-1)  # (B, Q, S)
    label_scores = logits.float().sigmoid().gather(2, labels[:, None, :].expand(-1, Q, -1))
    gap = (label_scores - scores[:, None, :]).abs().masked_fill(~same_box, float("inf"))
    best, query = gap.min(dim=1)
    if not (best <= SCORE_MATCH_ATOL).all():
        raise AssertionError(f"a detection matches no query's box and score: gap {best.max()}")
    return query * K + labels


def compare_detections(torch, tag, run, ref, num_select, bf16):
    """The kernel run's outputs against the plain run's, batch by batch, on
    the same proposal picks. f32: logits within FWD_ATOL_LOGITS, boxes within
    FWD_ATOL_BOXES (normalized) over every query; the detections' scores,
    sorted, within FWD_ATOL_LOGITS, and the boxes of the detections both
    runs pick (the same query and label) within FWD_ATOL_BOXES of the image's
    size. bf16: the drift ceiling over every query (BF16_DRIFT). Both: the
    difference of each shared detection's boxes is its query's (xyxy, over
    the image's size) within PAIRING_ATOL, which holds only if each
    detection was paired by the index `post_process` itself selected."""
    from lwdetr_tpu_torch.ops import box_ops

    if len(run.outputs) != len(ref.outputs) or len(ref.own) != len(run.recorded):
        raise AssertionError(f"{tag}: {len(run.outputs)} / {len(ref.outputs)} batches, "
                             f"{len(run.recorded)} picks, {len(ref.own)} replayed")
    worst = {"logits": 0.0, "boxes": 0.0, "scores": 0.0, "det_boxes": 0.0, "pairing": 0.0}
    probs, boxes_d, overlap, same_picks = [], [], [], []
    for a, b, own, replayed in zip(run.outputs, ref.outputs, ref.own, run.recorded):
        same_picks.append(min(len(set(x.tolist()) & set(y.tolist())) / x.numel()
                              for x, y in zip(own, replayed)))
        worst["logits"] = max(worst["logits"], (a["logits"] - b["logits"]).abs().max().item())
        worst["boxes"] = max(worst["boxes"], (a["boxes"] - b["boxes"]).abs().max().item())
        probs.append((a["logits"].sigmoid() - b["logits"].sigmoid()).abs())
        boxes_d.append((a["boxes"] - b["boxes"]).abs())
        query_d = box_ops.box_cxcywh_to_xyxy(a["boxes"]) - box_ops.box_cxcywh_to_xyxy(b["boxes"])
        K = a["logits"].shape[-1]
        for i in range(a["logits"].shape[0]):
            # scores sorted (a near-tie may swap two picks), boxes of the picks both share
            worst["scores"] = max(worst["scores"],
                                  (a["dets"][0][i] - b["dets"][0][i]).abs().max().item())
            ia, ib = a["picks"][i].tolist(), b["picks"][i].tolist()
            common = set(ia) & set(ib)
            overlap.append(len(common) / num_select)
            h, w = a["sizes"][i].tolist()
            scale = torch.tensor([w, h, w, h])
            for flat in common:
                d = (a["dets"][2][i, ia.index(flat)] - b["dets"][2][i, ib.index(flat)]) / scale
                worst["det_boxes"] = max(worst["det_boxes"], d.abs().max().item())
                worst["pairing"] = max(worst["pairing"],
                                       (d - query_d[i, flat // K]).abs().max().item())
    dp, db = torch.cat([p.reshape(-1) for p in probs]), torch.cat([d.reshape(-1) for d in boxes_d])
    drift = {"prob_mean": dp.mean().item(), "prob_max": dp.max().item(), "box_mean": db.mean().item()}
    res = {**{f"{k}_max_abs_err": v for k, v in worst.items()}, "bf16_drift": drift,
           "topk_overlap_min": min(overlap), "own_proposal_picks_same_set_min": min(same_picks)}
    log(f"{tag}, kernels vs plain on the card: " + json.dumps(res))
    if worst["pairing"] > PAIRING_ATOL:
        raise AssertionError(f"{tag}: a detection was paired with another query's box: "
                             f"{worst['pairing']}")
    if bf16:
        if any(v >= BF16_DRIFT[k] for k, v in drift.items()):
            raise AssertionError(f"{tag}: bf16 pipeline drifts from its plain versions: {drift}")
    elif (worst["logits"] > FWD_ATOL_LOGITS or worst["boxes"] > FWD_ATOL_BOXES
          or worst["scores"] > FWD_ATOL_LOGITS or worst["det_boxes"] > FWD_ATOL_BOXES):
        raise AssertionError(f"{tag}: detections disagree with the plain versions: {worst}")
    return res


def micro_pth(torch, path, args):
    """The fixture's JAX weights (`weights.npz`) as a reference-style .pth."""
    from lwdetr_tpu_torch.main import config_from_args
    from lwdetr_tpu_torch.weights import read_jax_npz, state_dict_from_jax

    tree = read_jax_npz(f"{FIXTURE}/weights.npz")
    sd = state_dict_from_jax(tree["params"], tree.get("batch_stats"), config_from_args(args).model)
    torch.save({"model": sd, "epoch": 0}, path)


def eval_pipeline_phase(torch, fa, da, kernels, card):
    """The eval entry point on the mAP fixture: (i) the micro model in f32
    through `lwdetr_tpu_torch.main --eval` (launch counts; the 12 stats against
    the golden), (ii) the same in bf16 (the envelope around the f32 golden;
    the distance to the JAX bf16 golden printed); each again with every
    kernel swapped for its plain version, detections against the kernel
    run's on the same picks; (iii) small's release preset at full width,
    bf16, batch 8, random weights from seed 0 (launch counts, detections
    against the plain run within the bf16 ceiling, the eval loop's img/s,
    the loader's share of its wall time and the device's idle share); (iv)
    fixture-only host numbers: the loop over the fixture 10 times over
    with its first epoch left out, the loader alone and the step alone over
    it, and each image's decode and resize + normalize on one thread."""
    import copy
    import os
    import time

    from torch.profiler import ProfilerActivity, profile

    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.config import get_config, get_train_config
    from lwdetr_tpu_torch.data import native
    from lwdetr_tpu_torch.data.coco import CocoDetection
    from lwdetr_tpu_torch.data.coco_eval import CocoEvaluator
    from lwdetr_tpu_torch.data.loader import DetectionLoader, to_device
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.models.criterion import SetCriterion
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import init_state_dict

    with open(f"{FIXTURE}/golden_stats.json") as f:
        golden = json.load(f)["stats"]
    with open(f"{FIXTURE}/golden_stats_bf16.json") as f:
        golden16 = json.load(f)["stats"]
    out_dir = "build/chip_smoke"
    os.makedirs(out_dir, exist_ok=True)
    pth = f"{out_dir}/micro.pth"
    res = {}
    launches = {}

    def cli_args(*extra):
        return cli.parser().parse_args(["--eval", "--coco_path", FIXTURE, *MICRO_FLAGS,
                                        "--batch_size", str(MICRO_BATCH), "--resume", pth,
                                        "--output_dir", out_dir, "--dont_bench", *extra])

    micro_pth(torch, pth, cli_args())
    micro_runs = (("micro_eval_f32", ()), ("micro_eval_bf16", ("--bf16",)))
    runs = {}
    for tag, extra in micro_runs:
        rec = Recorder(torch, tr, engine)
        t0 = time.perf_counter()
        out, n = counted(torch, kernels, lambda: run_patched(lambda: cli.main(cli_args(*extra)),
                                                             rec.patches()))
        wall = time.perf_counter() - t0
        launches[tag] = n
        log(f"{tag} launches (5 batches of 4): {n}")
        if n != MICRO_EVAL_LAUNCHES:
            raise AssertionError(f"{tag}: launches {n} != {MICRO_EVAL_LAUNCHES}")
        stats = out["stats"]
        dist = {k: stats[k] - golden[k] for k in golden}
        dist16 = {k: stats[k] - golden16[k] for k in golden16}
        runs[tag] = rec
        res[tag] = {"stats": {k: stats[k] for k in golden}, "minus_golden_f32": dist,
                    "minus_golden_bf16": dist16, "wall_s": wall}
        print(f"{tag}: the 12 stats {json.dumps({k: stats[k] for k in golden})}; minus the f32 "
              f"golden: max |d| {max(abs(v) for v in dist.values()):.3g}; minus the JAX bf16 "
              f"golden: max |d| {max(abs(v) for v in dist16.values()):.3g} ({card})")
        if tag.endswith("f32"):
            bad = {k: v for k, v in dist.items() if abs(v) > GOLDEN_ATOL}
            if bad:
                raise AssertionError(f"{tag}: stats off the golden by more than {GOLDEN_ATOL}: {bad}")
        else:
            res[tag]["envelope_headroom"] = (BF16_GOLDEN_ENVELOPE
                                             - max(abs(v) for v in dist.values()))
            bad = {k: v for k, v in dist.items() if abs(v) >= BF16_GOLDEN_ENVELOPE}
            if bad:
                raise AssertionError(f"{tag}: bf16 stats off the f32 golden by "
                                     f"{BF16_GOLDEN_ENVELOPE} or more: {bad}")
    # (i) and (ii) again with every kernel swapped for its plain version, on each run's picks
    for tag, extra in micro_runs:
        plain = Recorder(torch, tr, engine, replay_from=runs[tag])
        out, n = counted(torch, kernels, lambda: run_patched(
            lambda: cli.main(cli_args(*extra)), plain_patches(fa, da) + plain.patches()))
        if any(n.values()):
            raise AssertionError(f"{tag}: the plain pipeline launched kernels: {n}")
        res[tag]["kernels_vs_plain"] = compare_detections(torch, tag, runs[tag], plain, 10,
                                                          bf16=tag.endswith("bf16"))
        res[tag]["plain_stats_minus_golden"] = {k: out["stats"][k] - golden[k] for k in golden}

    # (iii) small at full width, bf16, batch 8, over the fixture's 20 images
    cfg = get_config("small")
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                        state_dict=init_state_dict(cfg, seed=0))
    ds = CocoDetection(f"{FIXTURE}/val2017", f"{FIXTURE}/annotations/instances_val2017.json")

    def make_loader(dataset):
        return DetectionLoader(dataset, batch_size=SMALL_EVAL_BATCH, train=False, max_gt=100,
                               square_div_64=True, num_workers=2, image_dtype=torch.bfloat16)

    loader = make_loader(ds)
    eval_step = engine.build_eval_step(model, cfg.num_select,
                                       criterion=SetCriterion(cfg, get_train_config("small")))
    put = lambda b: to_device(b, "cuda")  # noqa: E731

    def evaluate(timed_loader=None):
        return engine.evaluate(eval_step, timed_loader or loader, CocoEvaluator(ds.coco),
                               put_fn=put, logger=log)

    rec = Recorder(torch, tr, engine)
    _, n = counted(torch, kernels, lambda: run_patched(evaluate, rec.patches()))
    launches["small_eval_fixture"] = n
    log(f"small_eval_fixture launches (3 batches of 8): {n}")
    if n != SMALL_EVAL_LAUNCHES:
        raise AssertionError(f"small_eval_fixture: launches {n} != {SMALL_EVAL_LAUNCHES}")
    plain = Recorder(torch, tr, engine, replay_from=rec)
    _, n = counted(torch, kernels, lambda: run_patched(evaluate, plain_patches(fa, da) +
                                                       plain.patches()))
    if any(n.values()):
        raise AssertionError(f"the plain small pipeline launched kernels: {n}")
    small = {"kernels_vs_plain": compare_detections(torch, "small_eval_fixture", rec, plain,
                                                    cfg.num_select, bf16=True)}

    class TimedLoader:
        """A loader, with the time of each request for a batch (one more at
        the end) and the caller's wait for each batch."""

        def __init__(self, inner):
            self.inner, self.starts, self.waits = inner, [], []

        def __iter__(self):
            it = iter(self.inner)
            while True:
                t = time.perf_counter()
                self.starts.append(t)
                batch = next(it, None)
                if batch is None:
                    return
                self.waits.append(time.perf_counter() - t)
                yield batch

        def periods(self, first):
            """Each batch's share of the loop from batch `first` on: (waits, periods)."""
            return (self.waits[first:],
                    [b - a for a, b in zip(self.starts[first:], self.starts[first + 1:])])

    walls, waits = [], []
    for _ in range(3):
        timed = TimedLoader(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = evaluate(timed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        waits.append(sum(timed.waits))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        evaluate()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    wall = sorted(walls)[1]
    n_img = len(ds)
    small.update({"stats": {k: stats[k] for k in golden}, "wall_s": walls,
                  "loader_wait_s": waits, "img_per_s": n_img / wall,
                  "loader_share": waits[walls.index(wall)] / wall,
                  "device_busy_s_profiled": busy, "device_idle_share": 1.0 - busy / wall,
                  "images": n_img, "batch": SMALL_EVAL_BATCH, "card": card})
    print(f"small_eval_fixture: bf16, batch {SMALL_EVAL_BATCH}, {n_img} images, start-up "
          f"included: eval loop {small['img_per_s']:.2f} img/s (median of 3 walls "
          f"{[round(w, 4) for w in walls]} s), loader wait {small['loader_share']:.3f} of the "
          f"wall, device idle share {small['device_idle_share']:.3f} ({card})")

    # (iv) fixture only, not COCO traffic (two of its 20 JPEGs are 1600x1200
    # and 3200x2400): the same loop over the fixture FIXTURE_REPEATS times,
    # with its first epoch (start-up, the evaluator's updates) left out; the
    # loader alone over the same images, its first batch left out; the step
    # alone (copy in, forward, eval losses, post_process) on one batch
    repeated = copy.copy(ds)
    repeated.ids = ds.ids * FIXTURE_REPEATS
    timed = TimedLoader(make_loader(repeated))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        evaluate(timed)
        torch.cuda.synchronize()
    steady_busy = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    wait_s, period_s = timed.periods(SMALL_EVAL_BATCHES)
    alone = TimedLoader(make_loader(repeated))
    batches = [b for b in alone]
    loader_s = sum(alone.periods(1)[1])
    step_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        eval_step(put(batches[0]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # each fixture image's decode and resize + normalize on one thread, best of 3
    decode_s, resize_s, pixels = [], [], []
    for img_id in ds.ids:
        path = os.path.join(ds.img_folder, ds.coco.imgs[img_id]["file_name"])
        best_d = best_r = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            rgb = native.decode_jpeg(path)
            t1 = time.perf_counter()
            native.resize_normalize(rgb, 640)
            best_d, best_r = min(best_d, t1 - t0), min(best_r, time.perf_counter() - t1)
        decode_s.append(best_d)
        resize_s.append(best_r)
        pixels.append(rgb.shape[0] * rgb.shape[1])
    big = sorted(range(len(pixels)), key=pixels.__getitem__)[-2:]
    small["fixture_steady"] = {
        "repeats": FIXTURE_REPEATS, "batches_in_window": len(period_s),
        "img_per_s": SMALL_EVAL_BATCH * len(period_s) / sum(period_s),
        "loader_share": sum(wait_s) / sum(period_s),
        "device_idle_share_whole_run": 1.0 - steady_busy / (timed.starts[-1] - timed.starts[0]),
        "loader_alone_img_per_s": SMALL_EVAL_BATCH * (len(batches) - 1) / loader_s,
        "step_alone_ms": sorted(step_s)[len(step_s) // 2] * 1e3,
        "decode_ms_per_pass": sum(decode_s) * 1e3, "resize_ms_per_pass": sum(resize_s) * 1e3,
        "decode_share_of_two_largest": sum(decode_s[i] for i in big) / sum(decode_s),
        "megapixels_per_pass": sum(pixels) / 1e6, "card": card}
    s = small["fixture_steady"]
    print(f"small_eval_fixture, fixture only ({FIXTURE_REPEATS} passes, the first left out; "
          f"not COCO traffic): eval loop {s['img_per_s']:.2f} img/s, loader wait "
          f"{s['loader_share']:.3f} of the wall, device idle {s['device_idle_share_whole_run']:.3f}"
          f"; the loader alone {s['loader_alone_img_per_s']:.2f} img/s, the step alone "
          f"{s['step_alone_ms']:.2f} ms a batch of {SMALL_EVAL_BATCH}; one thread over the 20 "
          f"images ({s['megapixels_per_pass']:.2f} MP): decode {s['decode_ms_per_pass']:.2f} ms "
          f"({s['decode_share_of_two_largest']:.3f} of it the two largest), resize + normalize "
          f"{s['resize_ms_per_pass']:.2f} ms ({card})")
    res["small_eval_fixture"] = small
    return launches, res


# training through the port's CLI (`lwdetr_tpu_torch.main`, no --eval): small's
# release preset at full width (640, 13 groups of 300 queries), f32, batch 4,
# 2 epochs with EMA, from seeded weights given as --pretrain_weights (the
# release recipe's start), over a COCO dir whose train2017 and val2017 are the
# fixture's 20 images: 5 steps an epoch; after each epoch 5 eval batches of the
# model and 5 of its EMA. The train recipe draws a square size a batch from
# 448..896, and a window of more than 128 tokens (above 704) takes K2 / K6 for
# K1 / K7, so the phase holds what does not depend on the sizes: per step
# K1 + K2 = 13, K6 + K7 = 13, K4 = K5 = 3 and M1 = 1; per eval batch (640)
# K1 + K2 = 13, K3 = 3, M1 = 1. The kernel phase holds every kernel against
# its plain version at each of these sizes (CLI_SCALES), and the phase fails
# if a step draws another. Resumed from the epoch-0 save, the first
# step's loss is the straight run's within CLI_FIRST_LOSS_RTOL (a bit-equal
# state on the same batch), later ones within CLI_LOSS_RTOL (K5 adds its
# float sums in run-dependent order, so the weights part after one backward;
# the resumed steps replay the straight run's proposal picks and matchings,
# trap (d), so that a near tie cannot turn that part into a jump).
CLI_EPOCHS = 2
CLI_STEPS = 5
CLI_EVAL_BATCHES = 10  # an epoch: 5 of the model, 5 of its EMA
CLI_FIRST_LOSS_RTOL = 1e-6
CLI_LOSS_RTOL = 1e-3


def cli_launch_invariants(launches, steps, eval_batches):
    """{check: (got, expected)} of a CLI run's launch counts."""
    n = launches
    return {"K1+K2": (n["K1"] + n["K2"], 13 * (steps + eval_batches)),
            "K6+K7": (n["K6"] + n["K7"], 13 * steps), "K4": (n["K4"], 3 * steps),
            "K5": (n["K5"], 3 * steps), "K3": (n["K3"], 3 * eval_batches),
            "M1": (n["M1"], steps + eval_batches),
            "others": (sum(n[k] for k in ("K7nb", "K8", "K9", "K10", "K10b")), 0)}


def train_cli_phase(torch, kernels, card):
    """small trained through `lwdetr_tpu_torch.main` for 2 epochs (finite
    losses, two log records with the JAX CLI's keys, the checkpoint
    directories), resumed from its epoch-0 save (the restored state equal to
    the saved one bit for bit; the losses against the straight run's), then
    the demo on one fixture image from the last checkpoint against
    `build_eval_step` on the same image. Returns (launches, numbers)."""
    import os
    import shutil
    import time

    import numpy as np
    from PIL import Image

    from lwdetr_tpu_torch import demo
    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.data import transforms as T
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import checkpoint as ckpt
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import init_state_dict

    work = os.path.abspath("build/chip_smoke/train_cli")
    shutil.rmtree(work, ignore_errors=True)
    coco = os.path.join(work, "coco")
    os.makedirs(os.path.join(coco, "annotations"))
    # the release recipe starts from a detector checkpoint (--pretrain_weights,
    # scripts/lwdetr_small_coco_train.sh): here small's seeded weights
    pretrain = os.path.join(work, "pretrain.pth")
    torch.save({"model": init_state_dict(get_config("small"), seed=0)}, pretrain)
    for split in ("train2017", "val2017"):
        os.symlink(os.path.abspath(f"{FIXTURE}/val2017"), os.path.join(coco, split))
        shutil.copy(f"{FIXTURE}/annotations/instances_val2017.json",
                    os.path.join(coco, "annotations", f"instances_{split}.json"))
    # trap (d): the two-stage picks and the matching are discrete; a weight
    # apart by one run-dependent f32 sum can swap a near-tied pick or
    # assignment and move the loss by far more than the sum did. So the
    # straight run's epoch-1 train steps record theirs and the resumed run's
    # train steps replay them (M1 still runs there); the evals run free
    losses, tape = [], {"mode": None, "picks": [], "match": [], "at": [0, 0]}
    build, select, match = engine.build_train_step, tr.select_proposals, cm.hungarian_match

    def taped(kind, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            i = ("picks", "match").index(kind)
            if tape["mode"] == "record":
                tape[kind].append(out)
            elif tape["mode"] == "replay":
                out = tape[kind][tape["at"][i]]
                tape["at"][i] += 1
            return out

        return call

    def recording_build(state, *a, **kw):
        step = build(state, *a, **kw)

        def recording(*sa, **skw):
            sizes[-1].append(int(sa[0]["images"].shape[1]))  # (B, H, W, 3), square
            tape["mode"] = modes[-1](len(losses[-1]))
            metrics = step(*sa, **skw)
            tape["mode"] = None
            losses[-1].append(metrics["loss"])
            return metrics

        return recording

    modes, sizes = [], []

    def run(out, mode, *extra):
        losses.append([])
        sizes.append([])
        modes.append(mode)
        argv = ["--preset", "small", "--coco_path", coco, "--batch_size", str(TRAIN_BATCH),
                "--epochs", str(CLI_EPOCHS), "--use_ema", "--checkpoint_interval", "1",
                "--num_workers", "2", "--pretrain_weights", pretrain, "--output_dir", out,
                "--dont_bench", *extra]
        t0 = time.perf_counter()
        result, n = counted(torch, kernels, lambda: run_patched(
            lambda: cli.main(cli.parser().parse_args(argv)),
            (mock.patch.object(engine, "build_train_step", recording_build),
             mock.patch.object(tr, "select_proposals", taped("picks", select)),
             mock.patch.object(cm, "hungarian_match", taped("match", match)))))
        return result, n, time.perf_counter() - t0, [float(x) for x in losses[-1]]

    res, launches = {}, {}
    out = os.path.join(work, "straight")
    straight, launches["train_cli"], wall, loss_a = run(
        out, lambda i: "record" if i >= CLI_STEPS else None)
    bad = {k: v for k, v in cli_launch_invariants(launches["train_cli"], CLI_EPOCHS * CLI_STEPS,
                                                  CLI_EPOCHS * CLI_EVAL_BATCHES).items()
           if v[0] != v[1]}
    log(f"train_cli launches: {launches['train_cli']}; train sizes {sizes[0]}")
    if bad or len(loss_a) != CLI_EPOCHS * CLI_STEPS or not all(np.isfinite(loss_a)):
        raise AssertionError(f"train_cli: launch checks {bad}, losses {loss_a}")
    if not set(sizes[0]) <= set(CLI_SCALES) | {640}:  # the kernel phase's shapes
        raise AssertionError(f"train_cli: train sizes {sizes[0]} outside the kernel checks'")
    with open(os.path.join(out, "log.txt")) as f:
        records = [json.loads(line) for line in f]
    keys = {"epoch", "best_regular", "best_ema", "train_loss", "test_AP", "ema_test_AP"}
    if [r["epoch"] for r in records] != [0, 1] or not all(keys <= set(r) for r in records) \
            or not all(k in keys or k.startswith(("train_", "test_", "ema_test_"))
                       for r in records for k in r):
        raise AssertionError(f"train_cli: log records {[sorted(r) for r in records]}")
    dirs = {sub: ckpt.checkpoint_keys(os.path.join(out, sub)) for sub in ckpt.KEEP}
    want = {"ckpt": [CLI_STEPS, 2 * CLI_STEPS], "ckpt_epochs": [0, 1]}
    if any(dirs[k] != v for k, v in want.items()) or len(dirs["ckpt_best_regular"]) != 1 \
            or len(dirs["ckpt_best_ema"]) != 1:
        raise AssertionError(f"train_cli: checkpoint dirs {dirs}")

    # resume from the epoch-0 save: the restored state against the file
    restore, restored = ckpt.restore_checkpoint, {}

    def checked_restore(path, state, loaded=None):
        step = restore(path, state, loaded)
        saved = torch.load(ckpt.checkpoint_file(path), map_location="cpu", weights_only=False)
        model = state.model.state_dict()
        opt = state.optimizer.state_dict()
        restored.update({
            "model": model.keys() == saved["model"].keys() and all(
                torch.equal(v.cpu(), saved["model"][k]) for k, v in model.items()),
            "optimizer": opt["param_groups"] == saved["optimizer"]["param_groups"] and all(
                torch.equal(t.cpu(), saved["optimizer"]["state"][i][name])
                for i, st in opt["state"].items() for name, t in st.items()),
            "ema": all(torch.equal(v.cpu(), saved["ema_model"][k]) for k, v in state.ema.items()),
            "scheduler": state.scheduler.state_dict() == saved["lr_scheduler"],
            "step": step == saved["step"] == CLI_STEPS})
        return step

    with mock.patch.object(ckpt, "restore_checkpoint", checked_restore):
        resumed, launches["train_cli_resumed"], wall_r, loss_b = run(
            os.path.join(work, "resumed"), lambda i: "replay", "--resume",
            os.path.join(out, "ckpt", f"{CLI_STEPS}.pth"))
    replayed = tape["at"] == [len(tape["picks"]), len(tape["match"])] and tape["match"]
    bad = {k: v for k, v in cli_launch_invariants(launches["train_cli_resumed"], CLI_STEPS,
                                                  CLI_EVAL_BATCHES).items() if v[0] != v[1]}
    rel = [abs(a - b) / max(abs(a), 1e-12) for a, b in zip(loss_a[CLI_STEPS:], loss_b)]
    log(f"train_cli resumed: restored equal {restored}; losses straight {loss_a[CLI_STEPS:]} "
        f"resumed {loss_b}; relative differences {rel}")
    if bad or not restored or not all(restored.values()) or len(loss_b) != CLI_STEPS \
            or not replayed:
        raise AssertionError(f"train_cli resumed: launches {bad}, restored {restored}, "
                             f"{len(loss_b)} steps, replayed {tape['at']} of "
                             f"{len(tape['picks'])} picks and {len(tape['match'])} matchings")
    if rel[0] > CLI_FIRST_LOSS_RTOL or max(rel) > CLI_LOSS_RTOL:
        raise AssertionError(f"train_cli resumed: losses off the straight run's: {rel}")

    # the demo from the last checkpoint, against build_eval_step on the same image
    image = os.path.join(FIXTURE, "val2017", sorted(os.listdir(f"{FIXTURE}/val2017"))[1])
    dets, launches["demo"] = counted(torch, kernels, lambda: demo.main(
        ["--image", image, "--checkpoint", os.path.join(out, "ckpt"),
         "--output", os.path.join(work, "demo.jpg"), "--threshold", "0.3"]))
    cfg = get_config("small")
    saved = torch.load(ckpt.checkpoint_file(os.path.join(out, "ckpt")), map_location="cpu",
                       weights_only=False)
    model = build_model(cfg, device="cuda", state_dict=saved["model"])
    pil = Image.open(image).convert("RGB")
    arr, _ = T.val_transform_square(pil, None, 640)
    batch = {"images": torch.from_numpy(np.ascontiguousarray(arr))[None].cuda(),
             "orig_size": torch.tensor([[pil.height, pil.width]], dtype=torch.float32,
                                       device="cuda")}
    (scores, labels, boxes), _ = engine.build_eval_step(model, cfg.num_select)(batch)
    same = (np.array_equal(dets["scores"], scores[0].cpu().numpy())
            and np.array_equal(dets["labels"], labels[0].cpu().numpy())
            and np.array_equal(dets["boxes"], boxes[0].cpu().numpy()))
    if not same or launches["demo"] != launch_counts(K1=6, K2=7, K3=3):
        raise AssertionError(f"demo: detections equal the eval step's: {same}; launches "
                             f"{launches['demo']}")
    res = {"straight_wall_s": wall, "resumed_wall_s": wall_r, "losses_straight": loss_a,
           "losses_resumed": loss_b, "resumed_loss_rel_diff": rel, "restored_equal": restored,
           "train_sizes": sizes[0], "resumed_train_sizes": sizes[1],
           "records": records, "checkpoint_keys": dirs, "demo_kept": dets["kept"],
           "demo_equals_eval_step": same, "card": card}
    print(f"train_cli: small@640 f32, batch {TRAIN_BATCH}, {CLI_EPOCHS} epochs through "
          f"lwdetr_tpu_torch.main in {wall:.1f} s (evals included), resumed from step "
          f"{CLI_STEPS} in {wall_r:.1f} s: first step's loss {rel[0]:.3g} from the straight "
          f"run's, the worst {max(rel):.3g}; demo {dets['kept']} detections, equal to the eval "
          f"step's ({card})")
    return launches, res


# ---- padded batches (the legacy recipe and --per_image_scales) ---------------------------------

PADDED_FIXTURE = "tests/fixtures/micro_map_padded"
PADDED_BATCH = 4
# small at the legacy recipe's sizes (shortest side 800, longest at most 1333,
# padded to a multiple of 64): a 84 x 52 token map (4368 memory positions, the
# panel branch K4 in eval) or 84 x 84 (7056); windows of 21 x 13 = 273 and
# 21 x 21 = 441 tokens take K2 / K6 with the qkv bias added inline, not K1 /
# K7. The global blocks' batch is cut to keep the plain backward's (B, H, N,
# N) score tensors in memory.
PADDED_ATTENTION_SHAPES = (
    ("K2@pad_windows273", "K2", PADDED_BATCH * 16, 192, 273, 12, 1.0, False),
    ("K2@pad_windows441", "K2", PADDED_BATCH * 16, 192, 441, 12, 1.0, False),
    ("K2@pad_global4368", "K2", 2, 192, 4368, 12, 1.0, False),
    ("K2@pad_global7056", "K2", 1, 192, 7056, 12, 1.0, False),
    # F4: a decoder of 2 self-attention heads of 128 channels (--sa_nheads 2),
    # over 300 queries in 13 groups a batch element (K2) and over 100 (K9)
    ("K2@d128", "K2", TRAIN_BATCH * 13, 256, 300, 2, 128 ** -0.5, False),
    ("K9@d128", "K9", BATCH, 256, 100, 2, 128 ** -0.5, False),
)
PADDED_ATTENTION_BWD_SHAPES = (
    ("K6@pad_windows273", "K6", PADDED_BATCH * 16, 192, 273, 12, 1.0, False, 20),
    ("K6@pad_windows441", "K6", PADDED_BATCH * 16, 192, 441, 12, 1.0, False, 20),
    ("K6@pad_global4368", "K6", 2, 192, 4368, 12, 1.0, False, 5),
    ("K6@pad_global7056", "K6", 1, 192, 7056, 12, 1.0, False, 3),
    ("K6@d128", "K6", TRAIN_BATCH * 13, 256, 300, 2, 128 ** -0.5, False, 20),
    ("K7nb@d128", "K7nb", TRAIN_BATCH * 13, 256, 100, 2, 128 ** -0.5, False, 50),
)
# the decoder's cross-attention on a padded map (values zeroed where padded):
# eval (300 queries) on 52 x 84, train (13 groups) on 84 x 84; small's 16
# heads of 16 channels, 2 points
PADDED_SEP_SHAPES = (("pad52x84", (PADDED_BATCH, 16, 16, 2, 300, [(52, 84)])),
                     ("pad84x84_train", (PADDED_BATCH, 16, 16, 2, 3900, [(84, 84)])))
# F4 through the wrappers' routes: attention zero-padded from head_dim 80 to
# the wide case (K2 / K6 over 300 queries, K9 / K7nb over 100), the samplers'
# pad-and-split at head_dims 12, 72 and 128 (a decoder of 16, 8 or 2
# cross-attention heads over hidden 192, 576 or 256) in each layout, forward
# and backward through autograd
F4_ATTENTION = (("K2", 300, 80), ("K9", 100, 80))
F4_SAMPLER_DIMS = (12, 72, 128)
F4_SAMPLER_SHAPE = (2, 2, None, 2, 300, [(40, 40), (20, 20)])  # D filled in
# small's padded eval forward: the first batch of the padded fixture (640x480,
# 480x640, 640x360, 280x210 through the legacy resize: 1088 x 1344 padded, 68 x
# 84 tokens, windows of 17 x 21 = 357, 5712 memory positions)
PADDED_EVAL_LAUNCHES = launch_counts(K2=13, K4=3)
# the padded CLI runs: the micro model's eval on the padded fixture, 3
# batches of 2 (68 x 68, 52 x 84 and 52 x 68 tokens: every window above 128
# tokens, K4 at 4624 and 4368 memory positions, K3 at 3536), its eval losses
# matched once a batch
PADDED_CLI_LAUNCHES = launch_counts(K2=6, K9=6, K4=4, K3=2, M1=3)
PADDED_CLI_STEPS = 5  # small, one epoch of the fixture's 20 images at batch 4
PRIOR_PROB = 0.01  # sigmoid of the class heads' prior bias
# The (height, width) that the padded paths draw from the fixture's 20 images
# at batch 4 (data/loader.py; tests/test_torch_port_isolation.py ties these
# tables to the loader): small's train step (c) takes the first batch of the
# legacy train recipe at seed PADDED_TRAIN_SEED, the train CLI one epoch of it
# at PADDED_CLI_SEED, and the CLI's evals (and the padded fixture's first
# batch, (b)) the legacy val recipe's batches. `padded_size_shapes` gives the
# kernels' shapes at each; the script fails on a drawn size outside them.
PADDED_TRAIN_SEED, PADDED_CLI_SEED = 3, 7
PADDED_TRAIN_SIZES = ((960, 704), (1024, 1024), (832, 1088), (832, 896), (896, 960), (1088, 832))
PADDED_EVAL_SIZES = ((1088, 1088), (1088, 1344), (1344, 1088))


def padded_size_shapes():
    """(attention forwards, attention backwards, sampler forwards, sampler
    backwards) of small at each size of PADDED_TRAIN_SIZES (its train step at
    batch 4: 13 query groups, the panel branch) and of PADDED_EVAL_SIZES (its
    eval forward at batch 4: 300 queries, K4 above 4096 memory positions,
    else K3), in the formats of the tables above, each shape once. A window of
    (g_h / 4) (g_w / 4) tokens takes K1 / K7 up to 128 tokens, K2 / K6 above;
    a global block K2 / K6 over g_h g_w tokens."""
    fwd, bwd, sep, sep_bwd = {}, {}, {}, {}
    for train, sizes in ((True, PADDED_TRAIN_SIZES), (False, PADDED_EVAL_SIZES)):
        for height, width in sizes:
            gh, gw = height // 16, width // 16
            win, glob = (gh // 4) * (gw // 4), gh * gw
            short = win <= 128
            fk, bk, iters = ("K1", "K7", 200) if short else ("K2", "K6", 20)
            fwd[f"{fk}@padcli_windows{win}"] = (fk, PADDED_BATCH * 16, 192, win, 12, 1.0, short)
            fwd[f"K2@padcli_global{glob}"] = ("K2", PADDED_BATCH, 192, glob, 12, 1.0, False)
            if train:
                bwd[f"{bk}@padcli_windows{win}"] = (bk, PADDED_BATCH * 16, 192, win, 12, 1.0,
                                                    short, iters)
                bwd[f"K6@padcli_global{glob}"] = ("K6", PADDED_BATCH, 192, glob, 12, 1.0, False, 5)
                shape = (PADDED_BATCH, 16, 16, 2, 3900, [(gh, gw)])
                sep[f"K4@padcli{gh}x{gw}_train"] = shape
                sep_bwd[f"K5@padcli{gh}x{gw}_train"] = shape
            else:
                name = "K4" if glob > 4096 else "K3"
                sep[f"{name}@padcli{gh}x{gw}_eval"] = (PADDED_BATCH, 16, 16, 2, 300, [(gh, gw)])
    return (tuple((key, *v) for key, v in fwd.items()), tuple((key, *v) for key, v in bwd.items()),
            tuple(sep.items()), tuple(sep_bwd.items()))


(PADDED_DRAWN_ATTENTION, PADDED_DRAWN_ATTENTION_BWD, PADDED_DRAWN_SEP,
 PADDED_DRAWN_SEP_BWD) = padded_size_shapes()


def small_cli_flags():
    """LW-DETR-small's model and loss flags for `lwdetr_tpu_torch.main` without
    `--preset` (a preset brings its data recipe, `square_resize_div_64`) and
    without `--square_resize_div_64`: the legacy recipe."""
    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.config import get_config, get_train_config

    cfg, tcfg = get_config("small"), get_train_config("small")
    flags = []
    for name in ("encoder", "vit_encoder_num_layers", "hidden_dim", "dim_feedforward",
                 "sa_nheads", "ca_nheads", "dec_n_points", "dec_layers", "group_detr",
                 "num_queries", "num_select"):
        flags += [f"--{name}", str(getattr(cfg, name))]
    for name in ("window_block_indexes", "out_feature_indexes", "projector_scale"):
        flags += [f"--{name}", *map(str, getattr(cfg, name))]
    flags += [f"--{name}" for name in ("two_stage", "lite_refpoint_refine", "bbox_reparam")
              if getattr(cfg, name)]
    flags += ["--ia_bce_loss", "--cls_loss_coef", str(tcfg.cls_loss_coef),
              "--lr_component_decay", str(tcfg.lr_component_decay)]
    parsed = cli.config_from_args(cli.parser().parse_args(["--coco_path", "x", *flags]))
    if parsed.model != cfg or parsed.data.square_resize_div_64:
        raise AssertionError(f"small's CLI flags give {parsed.model}")
    return flags


def padded_train_launches(height, width, steps):
    """Launches of `steps` small train steps at a padded (height, width):
    windows of at most 128 tokens take K1 / K7, longer ones K2 / K6."""
    win = (height // 64) * (width // 64)
    short = win <= 128
    per = dict(K1=6 if short else 0, K2=7 if short else 13, K7=6 if short else 0,
               K6=7 if short else 13, K4=3, K5=3, M1=1)
    return launch_counts(**{k: v * steps for k, v in per.items()})


def compare_split_route(torch, F, da, measure_ms, dtype, layout, D):
    """F4: a sampler at a head_dim its kernels do not take, through the
    public wrapper (zero-padded and split into `head_groups`), forward and
    backward by autograd, against the same route with the plain versions
    standing in for the two kernels (in bf16 they round as the JAX kernels;
    the route with the plain versions equals the unsplit plain version,
    tests/test_torch_port_ops.py): each kernel launched once; the output
    within ATOL + SAMPLER_RTOL x |plain|, d(value) within 4 x ATOL x max(1,
    max |plain|) + SAMPLER_RTOL x |plain|, d(loc) and d(weights) within ATOL x
    max(1, max |plain|), and in bf16 on panels the groups' summed
    `sep_panels_bwd_bf16_bound` besides (K5 rounds each group's weight
    gradients)."""
    B, H, _, P, Q, shapes = F4_SAMPLER_SHAPE
    shape = (B, H, D, P, Q, shapes)
    dt = getattr(torch, dtype)
    vals, loc, w, dout, _ = sep_inputs(torch, dt, shape)
    layout_name = {"K4": "panels", "K10": "rowmajor", "K3": "cm"}[layout]
    lay = as_layout(torch, da, layout_name, vals, shapes, dout)
    kern = {"K4": (da.deform_attn_sep_kernel, da.deform_attn_sep_bwd_kernel),
            "K10": (da.deform_attn_rowmajor_kernel, da.deform_attn_rowmajor_bwd_kernel),
            "K3": (da.deform_attn_cm_kernel, da.deform_attn_cm_bwd_kernel)}[layout]
    G, Dg = da.head_groups(D, *((4, 128) if layout == "K3" else (8, 64)))
    bounds = []

    def panels_bwd_plain(v, sh, lc, a, g):
        if dtype == "bfloat16" and not bounds:  # the bound on this group split's inputs
            bounds.append(da.sep_panels_bwd_bf16_bound(v, sh, lc, a, g))
        return da.ms_deform_attn_sep_panels_bwd_plain(v, sh, lc, a, g)

    plain = {"K4": (("ms_deform_attn_sep_panels_fwd", da.ms_deform_attn_sep_panels_plain),
                    ("ms_deform_attn_sep_panels_bwd", panels_bwd_plain)),
             "K10": (("ms_deform_attn_fwd", da.ms_deform_attn_plain),
                     ("ms_deform_attn_bwd", da.ms_deform_attn_bwd_plain)),
             "K3": (("ms_deform_attn_cm_fwd", da.ms_deform_attn_cm_plain),
                    ("ms_deform_attn_cm_bwd", da.ms_deform_attn_cm_bwd_plain))}[layout]

    def run():
        leaves = [t.detach().clone().requires_grad_() for t in tensors(lay.value) + [loc, w]]
        v = leaves[:-2] if isinstance(lay.value, (list, tuple)) else leaves[0]
        out = lay.fwd(v, leaves[-2], leaves[-1])
        return [out] + list(torch.autograd.grad(out, leaves, lay.dout))

    before = [k.launches for k in kern]
    got = run()
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kern, before)]
    if launched != [1, 1]:
        raise AssertionError(f"F4 {layout} D={D}: launches {launched} != [1, 1]")
    ref = run_patched(run, tuple(mock.patch.object(da, n, f) for n, f in plain))
    if [k.launches - b for k, b in zip(kern, before)] != [1, 1]:
        raise AssertionError(f"F4 {layout} D={D}: the plain route launched a kernel")
    bloc = bw = None
    if bounds:  # the groups' bounds summed, as autograd sums their d(loc), d(weights)
        b_loc, b_w = bounds[0]
        bloc = b_loc.reshape(B, Q, H, G, *b_loc.shape[3:]).sum(3)
        bw = b_w.reshape(B, Q, H, G, *b_w.shape[3:]).sum(3)
    rtol = SAMPLER_RTOL[dtype]
    tag = f"F4 {layout} {dtype} D={D}"
    err = check_close(torch, tag + " out", dtype, got[0], ref[0].float(), rtol=rtol)
    err_v = max(check_close(torch, f"{tag} d(value {i})", dtype, a, b.float(),
                            4.0 * grad_scale(b.float()), rtol=rtol)
                for i, (a, b) in enumerate(zip(got[1:-2], ref[1:-2])))
    err_l = check_close(torch, tag + " d(loc)", "float32", got[-2], ref[-2], grad_scale(ref[-2]),
                        bound=bloc)
    err_w = check_close(torch, tag + " d(weights)", "float32", got[-1], ref[-1],
                        grad_scale(ref[-1]), bound=bw)
    timed = measure_ms(run, iters=10, repeats=3)
    plain_ms = measure_ms(lambda: run_patched(run, tuple(mock.patch.object(da, n, f)
                                                         for n, f in plain)),
                          iters=3, repeats=3)["ms"]
    # the reference's F.grid_sample formulation at head_dim D, forward and backward
    library_ms = sum(library_sampler(torch, F, measure_ms, vals, shapes, loc, w, dout, bwd, 10)
                     for bwd in (False, True))
    # the bound of the sampler at head_dim D, forward and backward: the corners
    # the points name read twice, the output and d(out), loc and weights in and
    # their gradients out, every d(value) position written
    isz = vals[0].element_size()
    touched = sum(sep_panel_bytes(torch, vals, loc, shapes, D))
    nbytes = (2 * touched + 2 * B * Q * H * D * isz + 4 * (loc.numel() + w.numel()) * 4
              + sum(v.numel() for v in vals) * isz)
    bms, by, _ = bound_ms(nbytes, 3 * 2 * 4 * B * Q * H * D * len(shapes) * P, 0, dtype)
    log(f"{tag} ({G} groups of {Dg}): err {err:.3g}, d(value) {err_v:.3g}, d(loc) {err_l:.3g}, "
        f"d(weights) {err_w:.3g}; forward + backward ms {timed['ms']:.4f} plain {plain_ms:.4f} "
        f"grid_sample {library_ms:.4f} bound {bms:.4f} ({by}, {nbytes / 1e6:.2f} MB)")
    return {"shape": [list(t.shape) for t in tensors(lay.value)] + [Q], "head_dim": D,
            "groups": G, "group_head_dim": Dg, "max_abs_err": err, "max_abs_err_dvalue": err_v,
            "max_abs_err_dloc": err_l, "max_abs_err_dweights": err_w,
            "fwd_bwd_ms": timed["ms"], "plain_fwd_bwd_ms": plain_ms,
            "library_fwd_bwd_ms": library_ms, "bound_ms": bms, "bound_by": by}


def compare_padded_attention(torch, fa, measure_ms, dtype, name, N, D):
    """F4: attention at a head_dim between two kernel cases through
    `attention_cm` (zero-padded to the next case), forward and backward: the
    forward kernel and its backward launched once each; f32 against the plain
    version on the unpadded inputs within ATOL (x max(1, max |plain|) on
    d(qkv)); bf16 on the zero-padded inputs, as the kernels see them, against
    the plain version within `bf16_error_bound` / `bf16_bwd_error_bound` at
    the padded head_dim (tests/test_torch_port_gpu.py's rule)."""
    heads, B = 2, TRAIN_BATCH * 13 if N > 128 else BATCH
    scale = D ** -0.5
    Dp = fa.padded_head_dim(D)
    dt = getattr(torch, dtype)
    qkv, _ = attention_inputs(torch, B, heads * D, N, heads, dt, False, seed=D + N)
    g = torch.Generator(device="cuda").manual_seed(D)
    dout = torch.randn((B, heads * D, N), generator=g, device="cuda").to(dt)
    fwd, bwd = {"K2": (fa.flash_attention_cm_kernel, fa.flash_attention_cm_bwd_kernel),
                "K9": (fa.window_attention_kernel, fa.window_attention_bwd_kernel)}[name]

    def run():
        x = qkv.detach().requires_grad_()
        out = fa.attention_cm(x, heads, scale)
        return out, torch.autograd.grad(out, x, dout)[0]

    def padded(t):  # (B, heads * D, N) -> each head's channels zero-padded to Dp
        return torch.nn.functional.pad(t.reshape(B, heads, D, N), (0, 0, 0, Dp - D)).reshape(
            B, heads * Dp, N)

    before = (fwd.launches, bwd.launches)
    out, dqkv = run()
    torch.cuda.synchronize()
    launched = (fwd.launches - before[0], bwd.launches - before[1])
    tag = f"F4 {name} D={D}"
    with torch.no_grad():
        if dtype == "float32":
            ref = fa.attention_cm_plain(qkv, heads, scale)
            dref = fa.attention_cm_bwd_plain(qkv, dout, heads, scale)
            err = check_close(torch, tag + " out", dtype, out, ref)
            derr = check_close(torch, tag + " d(qkv)", dtype, dqkv, dref, grad_scale(dref))
        else:
            xp, gp = fa._pad_heads(qkv, heads, D, Dp), padded(dout)
            ref = fa.attention_cm_plain(xp, heads, scale).float()
            dref = fa.attention_cm_bwd_plain(xp, gp, heads, scale).float()
            err = check_bound(torch, tag + " out", padded(out), ref,
                              fa.bf16_error_bound(xp, heads, scale, ref))
            derr = check_bound(torch, tag + " d(qkv)", fa._pad_heads(dqkv, heads, D, Dp), dref,
                               fa.bf16_bwd_error_bound(xp, gp, heads, scale, dref))
    if launched != (1, 1):
        raise AssertionError(f"F4 {name} D={D}: launches {launched} != (1, 1)")
    timed = measure_ms(run, iters=10, repeats=3)
    log(f"F4 {name} D={D} (padded to {Dp}) {dtype} qkv {tuple(qkv.shape)}: "
        f"err {err:.3g}, d(qkv) {derr:.3g}; forward + backward ms {timed['ms']:.4f}")
    return {"shape": list(qkv.shape), "head_dim": D, "padded_to": Dp,
            "max_abs_err": err, "max_abs_err_dqkv": derr, "fwd_bwd_ms": timed["ms"]}


def padded_phase(torch, F, fa, da, kernels, measure_ms, card, res):
    """Padded batches on the card: (a) the kernels against their plain versions
    at the legacy recipe's shapes (K2 / K6 on windows of 273 and 441 tokens and
    global blocks of 4368 and 7056, K4 / K5 on masked 52 x 84 and 84 x 84
    panels) and F4's head dims (attention 80 and 128, the samplers 12, 72 and
    128), and untimed at every size that (b)-(d) draw (`padded_size_shapes`),
    into `res`; (b) small's padded eval forward against the plain versions;
    (c) small's padded f32 train step: its forward against the plain forwards
    on the same picks, its gradients against the plain backwards on the same
    forward, one step enqueued under
    `torch.cuda.set_sync_debug_mode("error")`; (d) the eval CLI on the legacy
    recipe against `golden_stats_padded.json`, and small trained one epoch
    from scratch through the CLI on the legacy recipe (the first batch's mean
    class probability at the prior), then `--eval` of its checkpoint. Returns
    (launches, numbers)."""
    import os
    import shutil
    import time

    import numpy as np

    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.config import get_config, get_train_config
    from lwdetr_tpu_torch.data.coco import CocoDetection
    from lwdetr_tpu_torch.data.loader import DetectionLoader, to_device
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import init_state_dict

    out = {"card": card}
    launches = {}
    # (a) kernels at the padded and F4 shapes
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in PADDED_ATTENTION_SHAPES:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype)
        for key, name, B, C, N, heads, scale, bias, iters in PADDED_ATTENTION_BWD_SHAPES:
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters)
        for key, shape in PADDED_SEP_SHAPES:
            res[(f"K4@{key}", dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape,
                                                           masked=True)
            res[(f"K5@{key}", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype,
                                                               shape, masked=True)
        # every shape the padded paths below draw, checked untimed
        for key, name, B, C, N, heads, scale, bias in PADDED_DRAWN_ATTENTION:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype, timed=False)
        for key, name, B, C, N, heads, scale, bias, iters in PADDED_DRAWN_ATTENTION_BWD:
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters,
                                                      timed=False)
        for key, shape in PADDED_DRAWN_SEP:
            name = key.split("@")[0]
            res[(key, dtype)] = compare_deform_sep(
                torch, da, measure_ms, dtype, shape, name=name,
                layout="panels" if name == "K4" else "cm", masked=True, timed=False)
        for key, shape in PADDED_DRAWN_SEP_BWD:
            res[(key, dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape,
                                                       masked=True, timed=False)
        out[f"f4_attention_{dtype}"] = {f"{n}_d{D}": compare_padded_attention(
            torch, fa, measure_ms, dtype, n, N, D) for n, N, D in F4_ATTENTION}
        out[f"f4_samplers_{dtype}"] = {f"{lay}_d{D}": compare_split_route(
            torch, F, da, measure_ms, dtype, lay, D)
            for D in F4_SAMPLER_DIMS for lay in ("K4", "K10", "K3")}

    # (b) small's padded eval forward, kernels against the plain versions on the same picks
    cfg = get_config("small")
    ds = CocoDetection(f"{PADDED_FIXTURE}/val2017",
                       f"{PADDED_FIXTURE}/annotations/instances_val2017.json")
    batch = next(iter(DetectionLoader(ds, batch_size=PADDED_BATCH, train=False, max_gt=100,
                                      square_div_64=False, num_workers=2)))
    data = to_device(batch, "cuda")
    masks = data["pad_mask"]
    if tuple(data["images"].shape[1:3]) not in PADDED_EVAL_SIZES:
        raise AssertionError(f"small padded eval: size {tuple(data['images'].shape[1:3])} outside "
                             "the kernel checks'")
    model = build_model(cfg, device="cuda", state_dict=init_state_dict(cfg, seed=0))

    def forward():
        with torch.no_grad():
            return model(data["images"], masks)

    picks = Picks(tr)
    fwd_k, n = counted(torch, kernels, lambda: run_patched(forward, (picks.patch(False),)))
    launches["padded_eval_small"] = n
    log(f"small padded eval forward {tuple(data['images'].shape)} launches: {n}")
    if n != PADDED_EVAL_LAUNCHES:
        raise AssertionError(f"small padded eval: launches {n} != {PADDED_EVAL_LAUNCHES}")
    fwd_p, n = counted(torch, kernels, lambda: run_patched(
        forward, plain_patches(fa, da) + (picks.patch(True),)))
    if any(n.values()):
        raise AssertionError(f"the plain padded forward launched a kernel: {n}")
    err_l = (fwd_k["pred_logits"] - fwd_p["pred_logits"]).abs().max().item()
    err_b = (fwd_k["pred_boxes"] - fwd_p["pred_boxes"]).abs().max().item()
    same_set = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
                   for a, b in zip(picks.recorded[0], picks.own[0]))
    with torch.no_grad():
        forward_unmasked = model(data["images"])
    unmasked = (forward_unmasked["pred_logits"] - fwd_k["pred_logits"]).abs().max().item()
    log(f"small padded eval forward, kernels vs plain: logits {err_l:.3g}, boxes {err_b:.3g}; own "
        f"picks same set {same_set:.4f}; the mask moves the logits by {unmasked:.3g}")
    if err_l > FWD_ATOL_LOGITS or err_b > FWD_ATOL_BOXES or not unmasked > 1e-3:
        raise AssertionError(f"small padded eval forward: logits {err_l}, boxes {err_b}, the "
                             f"mask's effect {unmasked}")
    out["eval_forward"] = {"images": list(data["images"].shape),
                           "padded_share": masks.float().mean().item(),
                           "logits_max_abs_err": err_l, "boxes_max_abs_err": err_b,
                           "proposal_picks_same_set_min": same_set,
                           "mask_moves_logits_by": unmasked}
    del model, fwd_k, fwd_p, forward_unmasked

    # (c) small's padded train step, f32, batch 4, the legacy train recipe
    tcfg = get_train_config("small")
    train_ds = CocoDetection(f"{FIXTURE}/val2017", f"{FIXTURE}/annotations/instances_val2017.json")
    tbatch = next(iter(DetectionLoader(train_ds, batch_size=PADDED_BATCH, train=True,
                                       max_gt=100, seed=PADDED_TRAIN_SEED, square_div_64=False,
                                       num_workers=2)))
    tdata = to_device(tbatch, "cuda")
    state = engine.create_train_state(cfg, tcfg, niter_per_ep=10, device="cuda",
                                      state_dict=init_state_dict(cfg, seed=0))
    model = state.model
    criterion = cm.SetCriterion(cfg, tcfg)
    targets = cm.Targets(tdata["labels"], tdata["boxes"], tdata["valid"])
    height, width = tdata["images"].shape[1:3]
    if (height, width) not in PADDED_TRAIN_SIZES:
        raise AssertionError(f"small padded train step: size {(height, width)} outside the kernel "
                             "checks'")
    expected = padded_train_launches(height, width, 1)
    picks, match, matchings = Picks(tr), cm.hungarian_match, []

    def record_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def replay_match(*args, **kwargs):
        match(*args, **kwargs)
        return matchings[0]

    def grads():
        model.zero_grad(set_to_none=True)
        outputs = model(tdata["images"], tdata["pad_mask"])
        total, _ = criterion(outputs, targets, train=True)
        total.backward()
        torch.cuda.synchronize()
        grads.outputs = {k: outputs[k].detach() for k in ("pred_logits", "pred_boxes")}
        return total.item(), {k: p.grad.clone() for k, p in model.named_parameters()
                              if p.grad is not None}

    (loss_k, grads_k), n = counted(torch, kernels, lambda: run_patched(
        grads, (picks.patch(False), mock.patch.object(cm, "hungarian_match", record_match))))
    launches["padded_train_small"] = n
    log(f"small padded train step {tuple(tdata['images'].shape)} (padded share "
        f"{tdata['pad_mask'].float().mean().item():.3f}) launches: {n}")
    if n != expected:
        raise AssertionError(f"small padded train step: launches {n} != {expected}")
    (loss_b, grads_b), n = counted(torch, kernels, lambda: run_patched(
        grads, (picks.patch(True), mock.patch.object(cm, "hungarian_match", replay_match))
        + plain_backward_patches(fa, da)))
    if any(n[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"the plain padded backward launched a backward kernel: {n}")
    fwd_k = grads.outputs
    # the forward kernels against the plain forwards on the same picks
    with torch.no_grad():
        fwd_p, n = counted(torch, kernels, lambda: run_patched(
            lambda: model(tdata["images"], tdata["pad_mask"]),
            plain_patches(fa, da) + (picks.patch(True),)))
    if any(n.values()):
        raise AssertionError(f"the plain padded train forward launched a kernel: {n}")
    err_fl = (fwd_k["pred_logits"] - fwd_p["pred_logits"]).abs().max().item()
    err_fb = (fwd_k["pred_boxes"] - fwd_p["pred_boxes"]).abs().max().item()
    log(f"small padded train forward, kernels vs plain on the same picks: logits {err_fl:.3g}, "
        f"boxes {err_fb:.3g}")
    if err_fl > FWD_ATOL_LOGITS or err_fb > FWD_ATOL_BOXES:
        raise AssertionError(f"small padded train forward: logits {err_fl}, boxes {err_fb}")
    del fwd_p
    top = max(g.abs().max().item() for g in grads_b.values())
    rel = {k: ((grads_k[k] - g).abs().max() / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
           for k, g in grads_b.items()}
    worst = max(rel, key=rel.get)
    log(f"small padded train step, kernels vs the plain backwards on the same forward: loss "
        f"{loss_k:.7f} vs {loss_b:.7f}; gradient max rel err {rel[worst]:.3g} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3g} over {len(rel)} tensors")
    if abs(loss_k - loss_b) > 1e-6 * abs(loss_k) or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"small padded train step: {worst} {rel[worst]}, loss {loss_k} vs "
                             f"{loss_b}")
    del grads_k, grads_b
    # one whole train step, enqueued with any host sync raising
    step = engine.build_train_step(state, criterion, tcfg, static_zero_drop_path=True,
                                   static_zero_dropout=True)
    step(tdata)  # the first step builds what it caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics, n = counted(torch, kernels, lambda: step(tdata))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches["padded_train_step_no_sync"] = n
    if n != expected or not torch.isfinite(metrics["loss"]).item():
        raise AssertionError(f"padded train step without host syncs: launches {n}, loss "
                             f"{metrics['loss']}")
    step_ms = measure_ms(lambda: step(tdata), iters=3, warmup=1, repeats=3)["ms"]
    out["train_step"] = {"images": list(tdata["images"].shape),
                         "padded_share": tdata["pad_mask"].float().mean().item(),
                         "forward_logits_max_abs_err": err_fl,
                         "forward_boxes_max_abs_err": err_fb,
                         "loss_kernels": loss_k, "loss_plain_backwards": loss_b,
                         "grad_max_rel_err_plain_backwards": rel[worst],
                         "grad_worst_tensor": worst, "enqueued_without_host_sync": True,
                         "step_ms": step_ms}
    print(f"small padded f32 train step {tuple(tdata['images'].shape)}: {step_ms:.3f} ms ({card})")
    del state, model, step

    # (d) the eval CLI on the legacy recipe against the JAX golden, then small
    # trained from scratch one epoch through the CLI and evaluated by it
    with open(f"{FIXTURE}/golden_stats_padded.json") as f:
        golden = json.load(f)
    work = os.path.abspath("build/chip_smoke/padded_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pth = os.path.join(work, "micro.pth")
    eval_argv = ["--eval", "--coco_path", PADDED_FIXTURE, *golden["flags"], "--resume", pth,
                 "--output_dir", work, "--dont_bench"]
    if "--square_resize_div_64" in eval_argv:
        raise AssertionError("the padded CLI run must take the legacy recipe")
    micro_pth(torch, pth, cli.parser().parse_args(eval_argv))
    t0 = time.perf_counter()
    result, n = counted(torch, kernels, lambda: cli.main(cli.parser().parse_args(eval_argv)))
    wall = time.perf_counter() - t0
    launches["padded_cli_micro_eval"] = n
    dist = {k: result["stats"][k] - v for k, v in golden["stats"].items()}
    print(f"padded eval CLI (micro, f32, legacy recipe): the 12 stats "
          f"{json.dumps({k: result['stats'][k] for k in golden['stats']})}; minus "
          f"golden_stats_padded.json: max |d| {max(abs(v) for v in dist.values()):.3g} ({card})")
    if n != PADDED_CLI_LAUNCHES:
        raise AssertionError(f"padded eval CLI: launches {n} != {PADDED_CLI_LAUNCHES}")
    bad = {k: v for k, v in dist.items() if abs(v) > GOLDEN_ATOL}
    if bad:
        raise AssertionError(f"padded eval CLI: stats off the golden by more than {GOLDEN_ATOL}: "
                             f"{bad}")
    out["cli_micro_eval"] = {"stats": result["stats"], "minus_golden": dist, "wall_s": wall}

    coco = os.path.join(work, "coco")
    os.makedirs(os.path.join(coco, "annotations"))
    for split in ("train2017", "val2017"):
        os.symlink(os.path.abspath(f"{FIXTURE}/val2017"), os.path.join(coco, split))
        shutil.copy(f"{FIXTURE}/annotations/instances_val2017.json",
                    os.path.join(coco, "annotations", f"instances_{split}.json"))
    seed = PADDED_CLI_SEED
    small = small_cli_flags()
    train_argv = [*small, "--coco_path", coco, "--batch_size", str(PADDED_BATCH),
                  "--epochs", "1", "--num_workers", "2", "--seed", str(seed),
                  "--output_dir", os.path.join(work, "train"), "--dont_bench"]
    # the fresh model the CLI trains (the JAX package's initialisation drawn
    # from --seed), on the first train batch: its class probabilities at the prior
    args = cli.parser().parse_args(train_argv)
    ccfg = cli.config_from_args(args)
    fresh = engine.create_train_state(ccfg.model, ccfg.train, niter_per_ep=PADDED_CLI_STEPS,
                                      device="cuda").model.eval()
    first = next(iter(DetectionLoader(CocoDetection(f"{coco}/train2017",
                                                    f"{coco}/annotations/instances_train2017.json"),
                                      batch_size=PADDED_BATCH, train=True, max_gt=100, seed=seed,
                                      square_div_64=False, num_workers=2)))
    first = to_device(first, "cuda")
    with torch.no_grad():
        fresh_out = fresh(first["images"], first["pad_mask"])
    mean_prob = fresh_out["pred_logits"].float().sigmoid().mean().item()
    del fresh, fresh_out
    log(f"a fresh small model (seed {seed}) on the first padded train batch: mean class "
        f"probability {mean_prob:.4f} (prior {PRIOR_PROB})")
    if not PRIOR_PROB / 2 < mean_prob < 3 * PRIOR_PROB:
        raise AssertionError(f"a fresh model scores {mean_prob}, not near the prior {PRIOR_PROB}")
    losses, sizes, eval_sizes = [], [], []
    build, build_eval = engine.build_train_step, engine.build_eval_step

    def recording_eval_build(*a, **kw):
        step_fn = build_eval(*a, **kw)

        def recording(batch, *sa, **skw):
            eval_sizes.append(tuple(batch["images"].shape[1:3]))
            return step_fn(batch, *sa, **skw)

        return recording

    def recording_build(st, *a, **kw):
        step_fn = build(st, *a, **kw)

        def recording(*sa, **skw):
            sizes.append(list(sa[0]["images"].shape[1:3]))
            if "pad_mask" not in sa[0]:
                raise AssertionError("the legacy recipe's train batch came without its pad_mask")
            metrics = step_fn(*sa, **skw)
            losses.append(metrics["loss"])
            return metrics

        return recording

    t0 = time.perf_counter()
    trained, n = counted(torch, kernels, lambda: run_patched(
        lambda: cli.main(cli.parser().parse_args(train_argv)),
        (mock.patch.object(engine, "build_train_step", recording_build),
         mock.patch.object(engine, "build_eval_step", recording_eval_build))))
    wall_train = time.perf_counter() - t0
    launches["padded_cli_train"] = n
    losses = [float(x) for x in losses]
    log(f"padded train CLI: launches {n}; sizes {sizes}; losses {losses}")
    if len(losses) != PADDED_CLI_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"padded train CLI: losses {losses}")
    # a step launches M1 once and K5 3 times; the eval's 5 batches M1 once each
    if n["M1"] != PADDED_CLI_STEPS + 5 or n["K5"] != 3 * PADDED_CLI_STEPS:
        raise AssertionError(f"padded train CLI: launches {n}")
    ckpt_dir = os.path.join(work, "train", "ckpt")
    result_eval, n = counted(torch, kernels, lambda: run_patched(
        lambda: cli.main(cli.parser().parse_args(
            ["--eval", *small, "--coco_path", coco, "--batch_size", str(PADDED_BATCH),
             "--num_workers", "2", "--resume", ckpt_dir, "--output_dir", work,
             "--dont_bench"])),
        (mock.patch.object(engine, "build_eval_step", recording_eval_build),)))
    launches["padded_cli_eval"] = n
    same = {k: result_eval["stats"][k] == trained["stats"][k] for k in golden["stats"]}
    log(f"padded --eval of the trained checkpoint: launches {n}; stats equal the training "
        f"run's eval: {same}; eval sizes {eval_sizes}")
    outside = ({tuple(x) for x in sizes} - set(PADDED_TRAIN_SIZES)) | (set(eval_sizes)
                                                                       - set(PADDED_EVAL_SIZES))
    if outside or len(eval_sizes) != 10:  # 5 batches in each of the two evals
        raise AssertionError(f"padded CLI: sizes {sorted(outside)} outside the kernel checks', "
                             f"{len(eval_sizes)} eval batches")
    if not all(same.values()):
        raise AssertionError(f"padded --eval: stats {result_eval['stats']} != the training run's "
                             f"{trained['stats']}")
    out["cli_train"] = {"fresh_mean_class_prob": mean_prob, "losses": losses, "sizes": sizes,
                        "eval_sizes": eval_sizes,
                        "wall_s": wall_train, "eval_stats": trained["stats"]}
    print(f"padded train CLI: small from scratch (seed {seed}), {PADDED_CLI_STEPS} steps of the "
          f"legacy recipe in {wall_train:.1f} s with its eval, first mean class probability "
          f"{mean_prob:.4f}, losses {[round(x, 4) for x in losses]} ({card})")
    return launches, out


def m1_entry(res, launches):
    """M1's entry of the kernels line: small's train step (f32 costs), its
    other shapes beside it; columns are integers, held equal (max_abs_err 0)."""
    head = res[("M1@small_train", "float32")]
    path = "small_train"
    if launches[path]["M1"] < 1:
        raise AssertionError(f"M1 was not launched on its path {path}")
    return {"name": "M1", "route": "cuda", "source": SOURCES["M1"], "replaces": REPLACES["M1"],
            "launches": launches[path]["M1"], "path": path,
            "launches_by_path": {p: launches[p]["M1"] for p in launches}, "dtype": "float32",
            "max_abs_err": 0, **{k: v for k, v in head.items() if k != "shape"},
            "shape": head["shape"], "library_ms": None,
            "tolerance": "columns equal to the plain version's (the JAX loop's); total cost "
                         f"within {M1_SCIPY_RTOL} relative of scipy's; a launch ends within "
                         f"{M1_TIME_LIMIT_S} s",
            "other_shapes": {k: res[(f"M1@{k}", "float32")] for k, *_ in M1_CHECKS
                             if k != "small_train"}}


# ---- the decoder and encoder variants (ROADMAP.md § 1 item 6) and F7 ------------

# F7: the wide attention case (`csrc/attention_wide.cuh`: every multiple of
# 64 from 128 up; 2112 is wider than the widest head it once took): K2 / K9
# forwards at the decoder's eval shapes (batch 8, 300 / 100 queries) and K2 at
# a ragged 150, K6 / K7nb backwards at its train shapes (13 groups of batch 4
# folded), one head: (key, kernel, B, C, N, heads, scale, bias[, calls a
# sample]). F7_UNTIMED, checked untimed: odd token counts (bf16 rows of odd
# length staged by plain loads, f32 by 4-byte copies) in the resident kernels,
# in clusters, and in FlashAttention-2's shape (bf16 heads of 128 at a batch
# that fills the card); and rows too long for the resident kernels in either
# dtype (the streaming ones take them), at odd lengths too.
F7_HEAD_DIMS = (128, 192, 256, 384, 512, 1024, 2048, 2112)
F7_PADDED_HEAD_DIMS = (300, 2100)  # zero-padded to 320 and 2112 by attention_cm
F7_ATTENTION_SHAPES = tuple(
    (f"{name}@f7_{D}" + ("" if N != 150 else "_n150"), name, BATCH, D, N, 1, D ** -0.5, False)
    for D in F7_HEAD_DIMS for name, N in (("K2", 300), ("K9", 100), ("K2", 150)))
F7_ATTENTION_BWD_SHAPES = tuple(
    (f"{name}@f7_{D}", name, TRAIN_BATCH * 13, D, N, 1, D ** -0.5, False, 2)
    for D in F7_HEAD_DIMS for name, N in (("K6", 300), ("K7nb", 100)))
F7_UNTIMED = (("K2@f7_128_n301", "K2", TRAIN_BATCH * 13, 256, 301, 2, 128 ** -0.5, False),
              ("K9@f7_2112_n99", "K9", BATCH, 2112, 99, 1, 2112 ** -0.5, False),
              ("K2@f7_tail", "K2", 2, 2112, 3201, 1, 2112 ** -0.5, False),
              ("K6@f7_128_n301", "K6", TRAIN_BATCH * 13, 256, 301, 2, 128 ** -0.5, False, 2),
              ("K7nb@f7_192_n99", "K7nb", TRAIN_BATCH * 13, 192, 99, 1, 192 ** -0.5, False, 2),
              ("K6@f7_tail", "K6", 2, 2112, 1501, 1, 2112 ** -0.5, False, 2))
# (path, overrides of small's flag set): (a) PResNet-50 under small's decoder;
# (b) small's ViT with the Deformable-DETR-style decoder (one-stage, boxes as
# logits, the iterative refinement, the learned embedding); (c) eval only:
# two-stage with logit boxes (+inf proposals) and the iterative refinement of
# reparameterized boxes. No preset sets them: full flag sets, as scripts/*.sh.
VARIANT_CONFIGS = {
    "res50vd": dict(encoder="res50vd"),
    "deformable": dict(two_stage=False, bbox_reparam=False, lite_refpoint_refine=False,
                       position_embedding="learned"),
    "two_stage_logits": dict(bbox_reparam=False, lite_refpoint_refine=False),
    "iterative_reparam": dict(lite_refpoint_refine=False),
}
VARIANT_TRAINED = ("res50vd", "deformable")
# PResNet carries no attention: its path runs the decoder's kernels alone
VARIANT_EVAL_LAUNCHES = {"res50vd": launch_counts(K2=3, K3=3),
                         **{p: EXPECTED_LAUNCHES["small"] for p in VARIANT_CONFIGS
                            if p != "res50vd"}}
VARIANT_TRAIN_LAUNCHES = {"res50vd": launch_counts(K2=3, K4=3, K5=3, K6=3, M1=1),
                          "deformable": TRAIN_LAUNCHES["small"]}
# one decoder layer at --hidden_dim 512 --sa_nheads 1 (a head of 512 channels),
# train mode, 13 groups of 300 queries at batch 4, small's 40 x 40 memory
WIDE_LAYER_LAUNCHES = launch_counts(K2=1, K4=1, K6=1, K5=1)
VARIANTS_FIXTURE = "tests/fixtures/micro_map_variants"
VARIANT_CLI_EVAL_LAUNCHES = MICRO_EVAL_LAUNCHES
# The variant train CLI's loader draws one square size a batch from the release
# recipe's SCALES_SQUARE at VARIANT_CLI_SEED: one epoch of the fixture's 20
# images at batch 4 (tests/test_torch_port_isolation.py ties the table to the
# loader and the shapes below to the model). At those sizes the micro model's
# ViT runs shapes of the kernel phase's tables (CLI_SCALES and 640 at batch 4);
# its decoder, 2 groups of 12 queries folded into the batch, runs K9 / K7nb
# over 8 x 12 queries (4 heads of 16) and K4 / K5 on the (g, g) panel with 24
# queries (8 heads of 8, 2 points). The script fails on a drawn size outside
# the table.
VARIANT_CLI_SEED = 42
VARIANT_CLI_SIZES = (576, 640, 704, 768)
VARIANT_CLI_DRAWN_ATTENTION = (
    ("K9@variant_cli", "K9", MICRO_BATCH * 2, 64, 12, 4, 16 ** -0.5, False),)
VARIANT_CLI_DRAWN_ATTENTION_BWD = (
    ("K7nb@variant_cli", "K7nb", MICRO_BATCH * 2, 64, 12, 4, 16 ** -0.5, False, 50),)
VARIANT_CLI_DRAWN_SEP = tuple((f"variant_cli{size}", (MICRO_BATCH, 8, 8, 2, 24,
                                                      [(size // 16, size // 16)]))
                              for size in VARIANT_CLI_SIZES)


def variant_cli_launch_invariants(n, steps, eval_batches):
    """{check: (got, expected)} of the micro variant model through the CLI: its
    two ViT blocks (one window, one global: K1 or K2 by the drawn size), its
    two decoder layers' self-attention over 12 queries a group (K9, backward
    K7nb), the samplers (K4 / K5 in train mode, K3 in eval), one matching a
    step and an eval batch."""
    return {"K1+K2": (n["K1"] + n["K2"], 2 * (steps + eval_batches)),
            "K9": (n["K9"], 2 * (steps + eval_batches)), "K6+K7": (n["K6"] + n["K7"], 2 * steps),
            "K7nb": (n["K7nb"], 2 * steps), "K4": (n["K4"], 2 * steps),
            "K5": (n["K5"], 2 * steps), "K3": (n["K3"], 2 * eval_batches),
            "M1": (n["M1"], steps + eval_batches),
            "others": (sum(n[k] for k in ("K8", "K10", "K10b")), 0)}


def f7_checks(torch, F, fa, measure_ms, res):
    """F7 on the card: K2 / K9 forwards and K6 / K7nb backwards at every head
    dim of F7_HEAD_DIMS (the wide case) against their plain versions, f32 and
    bf16, timed beside SDPA and their bound, with their registers and no local
    bytes; F7_UNTIMED's odd and long rows untimed; 300 and 2100 through
    `attention_cm`'s zero padding to 320 and 2112. Into `res`."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in F7_ATTENTION_SHAPES:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype, iters=3)
        for key, name, B, C, N, heads, scale, bias, iters in F7_ATTENTION_BWD_SHAPES:
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters)
        for key, name, B, C, N, heads, scale, bias, *iters in F7_UNTIMED:
            if name in BACKWARD_KERNELS:
                res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C,
                                                          N, heads, scale, bias, dtype, *iters,
                                                          timed=False)
            else:
                res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, timed=False)
        for D in F7_PADDED_HEAD_DIMS:
            for name, N in (("K2", 300), ("K9", 100)):
                out[f"{name}_{D}_{dtype}"] = compare_padded_attention(torch, fa, measure_ms,
                                                                       dtype, name, N, D)
    spilled = {k: v["spill_bytes"] for k, v in res.items()
               if "@f7_" in k[0] and v.get("spill_bytes")}
    if spilled:
        raise AssertionError(f"F7: the wide case spilled: {spilled}")
    return out


def variant_cli_checks(torch, F, fa, da, measure_ms, res):
    """The variant train CLI's decoder kernels at every size it draws
    (VARIANT_CLI_DRAWN_*) against their plain versions, f32 and bf16, the
    check alone (no times). Into `res`."""
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in VARIANT_CLI_DRAWN_ATTENTION:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype, timed=False)
        for key, name, B, C, N, heads, scale, bias, iters in VARIANT_CLI_DRAWN_ATTENTION_BWD:
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters,
                                                      timed=False)
        for key, shape in VARIANT_CLI_DRAWN_SEP:
            res[(f"K4@{key}", dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape,
                                                           timed=False)
            res[(f"K5@{key}", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype,
                                                               shape, timed=False)


def wide_decoder_layer(torch, fa, da, kernels):
    """One decoder layer at --hidden_dim 512 --sa_nheads 1 in train mode (13
    groups folded into the batch: its self-attention is K2 at head_dim 512, its
    cross-attention K4), forward and backward through the kernels against the
    same inputs on the plain versions: the output within the f32 forward
    bound, each parameter's gradient on the plain backwards of the same forward
    within TRAIN_GRAD_RTOL of the tensor's largest. Returns (launches, numbers)."""
    from lwdetr_tpu_torch.models.transformer import DecoderLayer

    C, B, G, Qg = 512, TRAIN_BATCH, 13, 300
    layer = DecoderLayer(C, 1, 16, 2048, 1, 2, group_detr=G)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every weight drawn (the in-projection starts at zero)
        for name, p in layer.named_parameters():
            scale = p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=gen) * scale
                    + (1.0 if name.startswith("norm") and name.endswith("weight") else 0.0))
    layer = layer.cuda().train()
    g = torch.Generator(device="cuda").manual_seed(1)
    tgt = torch.randn((B, G * Qg, C), generator=g, device="cuda")
    pos = torch.randn((B, G * Qg, C), generator=g, device="cuda")
    ref = torch.rand((B, G * Qg, 1, 4), generator=g, device="cuda") * 0.5 + 0.25
    memory = torch.randn((B, 1600, C), generator=g, device="cuda")
    dout = torch.randn((B, G * Qg, C), generator=g, device="cuda")

    def run():
        layer.zero_grad(set_to_none=True)
        out = layer(tgt, memory, pos, ref, [(40, 40)], [memory])
        out.backward(dout)
        torch.cuda.synchronize()
        return out.detach(), {n: p.grad.clone() for n, p in layer.named_parameters()}

    (out_k, grads_k), launches = counted(torch, kernels, run)
    if launches != WIDE_LAYER_LAUNCHES:
        raise AssertionError(f"decoder layer at head_dim 512: launches {launches}")
    (out_p, _), n = counted(torch, kernels, lambda: run_patched(run, plain_patches(fa, da)))
    (out_b, grads_b), nb = counted(torch, kernels, lambda: run_patched(
        run, plain_backward_patches(fa, da)))
    if any(n.values()) or any(nb[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"the plain runs launched kernels: {n}, {nb}")
    err = (out_k - out_p).abs().max().item()
    top = max(gr.abs().max().item() for gr in grads_b.values())
    rel = {k: ((grads_k[k] - gr).abs().max() / gr.abs().max().clamp(min=GRAD_FLOOR * top)).item()
           for k, gr in grads_b.items()}
    worst = max(rel, key=rel.get)
    log(f"decoder layer, hidden 512, one self-attention head of 512, train mode ({B} x {G} "
        f"groups of {Qg}): launches {launches}; output vs plain {err:.3g}; gradients vs the "
        f"plain backwards, worst tensor {rel[worst]:.3g} ({worst})")
    if err > FWD_ATOL_LOGITS or rel[worst] > TRAIN_GRAD_RTOL or not torch.equal(out_k, out_b):
        raise AssertionError(f"decoder layer at head_dim 512: output {err}, gradients "
                             f"{worst} {rel[worst]}")
    return launches, {"output_max_abs_err": err, "grad_max_rel_err": rel[worst],
                      "grad_worst_tensor": worst}


def variant_config(path):
    from lwdetr_tpu_torch.config import get_config

    return get_config("small", **VARIANT_CONFIGS[path])


def variant_eval(torch, fa, da, kernels, path, dtype):
    """`path`'s eval forward at 640 x 640, batch 8, seeded weights, through the
    kernels (counted) and on the plain versions with the same two-stage picks
    (trap (d)): f32 within FWD_ATOL_LOGITS / _BOXES, bf16 (f32 parameters)
    within the bf16 drift ceiling over all queries. In f32 also each output
    set's distance from the plain run, through the kernels and through the
    plain versions moved by one ulp (`jittered_plain_patches`): how far the
    model carries a rounding difference, layer by layer; the kernels' may be
    at most JITTER_FACTOR times it (+ JITTER_FLOOR). Returns (launches,
    numbers)."""
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = variant_config(path)
    dt = getattr(torch, dtype)
    model = build_model(cfg, device="cuda", dtype=dt, state_dict=init_state_dict(cfg, seed=0))
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((BATCH, 640, 640, 3), generator=g, device="cuda").to(dt)

    def run():
        with torch.no_grad():
            return model(images)

    picks = Picks(tr)
    out, launches = counted(torch, kernels, lambda: run_patched(run, (picks.patch(False),)))
    ref, n = counted(torch, kernels, lambda: run_patched(run, plain_patches(fa, da)
                                                         + (picks.patch(True),)))
    tag = f"{path}@640 {dtype} eval forward"
    if launches != VARIANT_EVAL_LAUNCHES[path] or any(n.values()):
        raise AssertionError(f"{tag}: launches {launches} (plain run {n})")
    if len(picks.recorded) != int(cfg.two_stage):
        raise AssertionError(f"{tag}: {len(picks.recorded)} proposal picks recorded")
    logits, boxes = out["pred_logits"].float(), out["pred_boxes"]
    if logits.shape != (BATCH, cfg.num_queries, 91) or boxes.dtype != torch.float32:
        raise AssertionError(f"{tag}: logits {tuple(logits.shape)}, boxes {boxes.dtype}")
    if not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
        raise AssertionError(f"{tag}: non-finite outputs")
    if ("enc_outputs" in out) != cfg.two_stage:
        raise AssertionError(f"{tag}: encoder outputs {'enc_outputs' in out}")
    if dtype == "float32":
        err = {"logits_max_abs_err": (logits - ref["pred_logits"]).abs().max().item(),
               "boxes_max_abs_err": (boxes - ref["pred_boxes"]).abs().max().item()}
        bad = (err["logits_max_abs_err"] > FWD_ATOL_LOGITS
               or err["boxes_max_abs_err"] > FWD_ATOL_BOXES)
        # where the distance comes from: each output set (the encoder's, then
        # the decoder's layer by layer) through the kernels and, on the same
        # picks, through the plain versions moved by one ulp, each from the
        # plain run
        jit, n = counted(torch, kernels, lambda: run_patched(
            run, jittered_plain_patches(torch, fa, da, seed=1) + (picks.patch(True),)))
        if any(n.values()):
            raise AssertionError(f"{tag}: the jittered plain run launched kernels: {n}")

        def by_set(a, b):
            sets = ([("enc", a["enc_outputs"], b["enc_outputs"])] if cfg.two_stage else []) + [
                (f"layer{i}", x, y) for i, (x, y) in enumerate(zip(a["aux_outputs"],
                                                                   b["aux_outputs"]))] + [
                (f"layer{len(a['aux_outputs'])}", a, b)]
            return {name: [(x[k].float() - y[k].float()).abs().max().item()
                           for k in ("pred_logits", "pred_boxes")] for name, x, y in sets}

        err["by_set_kernels"] = by_set(out, ref)
        err["by_set_plain_ulp_jitter"] = by_set(jit, ref)
        # the kernels may lie no farther than rounding carries: a real fault
        # below FWD_ATOL_* would stand out against the one-ulp run
        bad = bad or any(k > JITTER_FACTOR * j + JITTER_FLOOR
                         for name, ks in err["by_set_kernels"].items()
                         for k, j in zip(ks, err["by_set_plain_ulp_jitter"][name]))
    else:
        dp = (logits.sigmoid() - ref["pred_logits"].float().sigmoid()).abs()
        db = (boxes - ref["pred_boxes"]).abs()
        err = {"prob_mean": dp.mean().item(), "prob_max": dp.max().item(),
               "box_mean": db.mean().item()}
        bad = any(v >= BF16_DRIFT[k] for k, v in err.items())
        err["box_max"] = db.max().item()
    log(f"{tag}, kernels vs plain on the same picks: launches {launches}; "
        + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in err.items()))
    if bad:
        raise AssertionError(f"{tag}: kernels disagree with the plain versions: {err}")
    return launches, err


def variant_train(torch, fa, da, kernels, measure_ms, path, card):
    """`path`'s f32 train step at 640 x 640, batch 4, 7 boxes an image, seeded
    weights, release optimizer settings: launches; the gradients through the
    kernels against the plain backwards on the same forward (per tensor,
    TRAIN_GRAD_RTOL); one optimizer step after which PResNet's BatchNorm
    statistics are bit-equal and its norm weights have moved, and the learned
    embedding, which no forward reads, is its value times (1 - lr wd) bit for
    bit (AdamW's decay with a zero gradient: the JAX optimizer's, to an ulp);
    then the step time. Returns (launches, numbers)."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.config import get_train_config
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = variant_config(path)
    tcfg = get_train_config("small", max_gt=100)
    state = engine.create_train_state(cfg, tcfg, niter_per_ep=bench_train.NITER_PER_EP,
                                      device="cuda", state_dict=init_state_dict(cfg, seed=0))
    model = state.model
    criterion = cm.SetCriterion(cfg, tcfg)
    step = engine.build_train_step(state, criterion, tcfg, static_zero_drop_path=True,
                                   static_zero_dropout=True)
    data = bench_train.synthetic_batch(cfg.num_classes, TRAIN_BATCH, 640, 100, 7, "cuda", seed=0)
    targets = cm.Targets(data["labels"], data["boxes"], data["valid"])
    picks, match, matchings = Picks(tr), cm.hungarian_match, []
    tag = f"{path}@640 f32 train step"

    def record_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def replay_match(*args, **kwargs):
        match(*args, **kwargs)
        return matchings[0]

    def grads():
        model.zero_grad(set_to_none=True)
        total, _ = criterion(model(data["images"]), targets, train=True)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}

    (loss_k, grads_k), launches = counted(torch, kernels, lambda: run_patched(
        grads, (picks.patch(False), mock.patch.object(cm, "hungarian_match", record_match))))
    if launches != VARIANT_TRAIN_LAUNCHES[path]:
        raise AssertionError(f"{tag}: launches {launches} != {VARIANT_TRAIN_LAUNCHES[path]}")
    (loss_b, grads_b), n = counted(torch, kernels, lambda: run_patched(
        grads, (picks.patch(True), mock.patch.object(cm, "hungarian_match", replay_match))
        + plain_backward_patches(fa, da)))
    if any(n[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"{tag}: the plain backwards launched a backward kernel: {n}")
    top = max(g.abs().max().item() for g in grads_b.values())
    rel = {k: ((grads_k[k] - g).abs().max() / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
           for k, g in grads_b.items()}
    worst = max(rel, key=rel.get)
    median = sorted(rel.values())[len(rel) // 2]
    log(f"{tag}: launches {launches}; gradients vs the plain backwards on the same forward, "
        f"worst of {len(rel)} tensors {rel[worst]:.3g} ({worst}), median {median:.3g}; "
        f"loss {loss_k:.7f} vs {loss_b:.7f}")
    if rel[worst] > TRAIN_GRAD_RTOL or abs(loss_k - loss_b) > 1e-6 * abs(loss_k):
        raise AssertionError(f"{tag}: backward kernels disagree: {worst} {rel[worst]}")
    del grads_k, grads_b
    model.zero_grad(set_to_none=True)

    # one optimizer step: frozen statistics, moving norm weights, the embedding's decay
    sd = model.state_dict()
    stats = {k: v.clone() for k, v in sd.items() if ".norm.running_" in k}
    norms = {k: v.clone() for k, v in sd.items() if ".encoder." in k and ".norm.weight" in k}
    embed = {k: v.clone() for k, v in sd.items() if k.startswith("backbone.1.")}
    decay = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            decay[p] = 1 - group["lr"] * group["weight_decay"]
    loss = float(step(data)["loss"])
    sd = model.state_dict()
    named = dict(model.named_parameters())
    checks = {"finite loss": loss == loss and abs(loss) != float("inf"),
              "statistics unchanged": all(torch.equal(sd[k], v) for k, v in stats.items()),
              "norm weights moved": all(not torch.equal(sd[k], v) for k, v in norms.items()),
              "embedding decayed as AdamW": all(
                  torch.equal(sd[k], v * decay[named[k]]) for k, v in embed.items()),
              "embedding within an ulp of optax": all(
                  ((sd[k] - (v - (1 - decay[named[k]]) * v)).abs()
                   <= 2.0 ** -23 * v.abs()).all().item() for k, v in embed.items())}
    if path == "res50vd" and not (stats and norms):
        checks["PResNet norms present"] = False
    if path == "deformable" and not embed:
        checks["embedding present"] = False
    log(f"{tag}: one optimizer step, loss {loss:.5f}; {len(stats)} BatchNorm statistics, "
        f"{len(norms)} encoder norm weights, {len(embed)} embedding tables: "
        + ", ".join(f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{tag}: {checks}")
    t = measure_ms(step, data, iters=3, warmup=1, repeats=3)
    print(f"{path}@640 f32 train step, batch {TRAIN_BATCH}: {t['ms']:.3f} ms, samples "
          f"{[round(x, 3) for x in t['samples']]} ({card}): measured, not claimed")
    return launches, {"loss_kernels": loss_k, "grad_max_rel_err_plain_backwards": rel[worst],
                      "grad_worst_tensor": worst, "grad_median_rel_err": median,
                      "step_loss": loss, **{k.replace(" ", "_"): v for k, v in checks.items()},
                      "step_ms": t["ms"], "step_ms_samples": t["samples"], "card": card}


def variant_tables(embed_seed, num_pos_feats):
    """The micro variant model's learned-embedding tables (never read): numpy's
    default_rng(`embed_seed`) in U[0, 1), row first, as the golden's generator
    (tests/gen_micro_map_variants_golden.py) draws them."""
    import numpy as np

    rng = np.random.default_rng(embed_seed)
    return {"row_embed": rng.uniform(0.0, 1.0, (50, num_pos_feats)).astype(np.float32),
            "col_embed": rng.uniform(0.0, 1.0, (50, num_pos_feats)).astype(np.float32)}


def variants_cli_phase(torch, kernels, card):
    """The micro model with the Deformable-DETR-style decoder through the CLI:
    `--eval` on `tests/fixtures/micro_map_variants/` (its 12 f32 stats equal to
    `golden_stats_variants.json` within 1e-7), then one train epoch (the
    fixture's 20 images as train2017, batch 4, from the fixture's weights):
    finite losses, the launch invariants, every drawn size in
    VARIANT_CLI_SIZES (whose kernel shapes `variant_cli_checks` held to the
    plain versions). Returns (launches, numbers)."""
    import os
    import shutil

    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import read_jax_npz, state_dict_from_jax

    with open(f"{FIXTURE}/golden_stats_variants.json") as f:
        golden = json.load(f)
    work = os.path.abspath("build/chip_smoke/variants_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    flags = golden["flags"]
    args = cli.parser().parse_args(["--eval", "--coco_path", VARIANTS_FIXTURE, *flags])
    cfg = cli.config_from_args(args).model
    tree = read_jax_npz(f"{FIXTURE}/weights.npz")
    params = dict(tree["params"], pos_embedding=variant_tables(golden["embed_seed"],
                                                              cfg.hidden_dim // 2))
    pth = os.path.join(work, "micro_variant.pth")
    torch.save({"model": state_dict_from_jax(params, tree.get("batch_stats"), cfg)}, pth)
    launches = {}
    argv = ["--eval", "--coco_path", VARIANTS_FIXTURE, *flags, "--resume", pth,
            "--output_dir", os.path.join(work, "eval"), "--num_workers", "2", "--dont_bench"]
    out, launches["variants_cli_eval"] = counted(
        torch, kernels, lambda: cli.main(cli.parser().parse_args(argv)))
    stats = out["stats"]
    dist = {k: stats[k] - v for k, v in golden["stats"].items()}
    print(f"variants_cli_eval (one-stage, logits, iterative, learned): the 12 stats "
          f"{json.dumps({k: stats[k] for k in golden['stats']})}; minus the golden: max |d| "
          f"{max(abs(v) for v in dist.values()):.3g} ({card})")
    if launches["variants_cli_eval"] != VARIANT_CLI_EVAL_LAUNCHES:
        raise AssertionError(f"variants_cli_eval: launches {launches['variants_cli_eval']}")
    bad = {k: v for k, v in dist.items() if abs(v) > GOLDEN_ATOL}
    if bad:
        raise AssertionError(f"variants_cli_eval: stats off the golden by more than "
                             f"{GOLDEN_ATOL}: {bad}")

    coco = os.path.join(work, "coco")
    os.makedirs(os.path.join(coco, "annotations"))
    for split in ("train2017", "val2017"):
        os.symlink(os.path.abspath(f"{FIXTURE}/val2017"), os.path.join(coco, split))
        shutil.copy(f"{FIXTURE}/annotations/instances_val2017.json",
                    os.path.join(coco, "annotations", f"instances_{split}.json"))
    train_out = os.path.join(work, "train")
    argv = ["--coco_path", coco, *flags, "--epochs", "1", "--num_workers", "2",
            "--seed", str(VARIANT_CLI_SEED), "--pretrain_weights", pth,
            "--output_dir", train_out, "--dont_bench"]
    build, sizes = engine.build_train_step, []

    def recording_build(state, *a, **kw):
        step = build(state, *a, **kw)

        def recording(*sa, **skw):
            sizes.append(int(sa[0]["images"].shape[1]))  # (B, H, W, 3), square
            return step(*sa, **skw)

        return recording

    _, launches["variants_cli_train"] = counted(torch, kernels, lambda: run_patched(
        lambda: cli.main(cli.parser().parse_args(argv)),
        (mock.patch.object(engine, "build_train_step", recording_build),)))
    with open(os.path.join(train_out, "log.txt")) as f:
        record = json.loads(f.readline())
    inv = variant_cli_launch_invariants(launches["variants_cli_train"], CLI_STEPS,
                                        MICRO_EVAL_BATCHES)
    bad = {k: v for k, v in inv.items() if v[0] != v[1]}
    loss = record.get("train_loss")
    log(f"variants_cli_train: one epoch of {CLI_STEPS} steps, train_loss {loss}, launches "
        f"{launches['variants_cli_train']}; train sizes {sizes}")
    if bad or loss is None or not (loss == loss and abs(loss) != float("inf")):
        raise AssertionError(f"variants_cli_train: launch checks {bad}, train_loss {loss}")
    if len(sizes) != CLI_STEPS or not set(sizes) <= set(VARIANT_CLI_SIZES):
        raise AssertionError(f"variants_cli_train: train sizes {sizes} outside the kernel "
                             f"checks' {VARIANT_CLI_SIZES}")
    return launches, {"eval_stats": {k: stats[k] for k in golden["stats"]},
                      "eval_minus_golden_max": max(abs(v) for v in dist.values()),
                      "train_loss": loss, "train_sizes": sizes, "card": card}


def variants_phase(torch, F, fa, da, kernels, measure_ms, card, res):
    """ROADMAP.md § 1 item 6 on the card, F7 first: (d) the wide attention case
    (`f7_checks`) and one decoder layer at head_dim 512; (a) res50vd under
    small's decoder, (b) small's ViT with the Deformable-DETR-style decoder:
    the bf16 eval forward at batch 8 and the f32 train step at batch 4; (c) the
    eval forward of two-stage with logit boxes and of the iterative refinement
    of reparameterized boxes, f32 and bf16; (e) the micro variant model through
    the eval CLI (its golden) and one train epoch, its decoder's kernels first
    held to their plain versions at every size the epoch draws
    (`variant_cli_checks`). Returns (launches, numbers)."""
    import time

    t0 = time.perf_counter()
    out = {"f7_padded": f7_checks(torch, F, fa, measure_ms, res)}
    launches = {}
    launches["decoder_512"], out["decoder_512"] = wide_decoder_layer(torch, fa, da, kernels)
    for path in VARIANT_CONFIGS:
        dtypes = ("bfloat16",) if path in VARIANT_TRAINED else ("float32", "bfloat16")
        for dtype in dtypes:
            key = path if dtype == "bfloat16" else f"{path}_f32"
            launches[key], out[f"{key}_eval"] = variant_eval(torch, fa, da, kernels, path, dtype)
        if path in VARIANT_TRAINED:
            launches[f"{path}_train"], out[f"{path}_train"] = variant_train(
                torch, fa, da, kernels, measure_ms, path, card)
    variant_cli_checks(torch, F, fa, da, measure_ms, res)
    by_path, out["cli"] = variants_cli_phase(torch, kernels, card)
    launches.update(by_path)
    out["wall_s"] = time.perf_counter() - t0
    print(f"variants phase: {out['wall_s']:.1f} s ({card})")
    return launches, out


# ---- the JAX CLI's orbax train state (ROADMAP.md § 1 item 4) ---------------------------------

ORBAX_FIXTURE = "tests/fixtures/micro_orbax"
ORBAX_STEP = 5  # the fixture's step: one epoch of 5 steps, so the resumed run starts at epoch 1
ORBAX_EVAL_LAUNCHES = launch_counts(K1=10, K2=10, K9=20, K3=20, M1=10)  # 2 blocks x 5 batches
ORBAX_DEMO_LAUNCHES = launch_counts(K1=1, K2=1, K9=2, K3=2)
# The resumed train CLI's loader draws its epoch-1 sizes at the CLI's default
# seed 42 (tests/test_torch_port_isolation.py ties the table to the loader):
# the micro model's ViT at those sizes runs the kernel phase's CLI shapes; its
# decoder runs VARIANT_CLI_DRAWN_ATTENTION's K9 / K7nb and K4 / K5 on each
# size's map. The script fails on a drawn size outside the table.
ORBAX_CLI_SIZES = (448, 512, 704, 896)
ORBAX_CLI_DRAWN_SEP = tuple((f"orbax_cli{size}", (MICRO_BATCH, 8, 8, 2, 24,
                                                  [(size // 16, size // 16)]))
                            for size in ORBAX_CLI_SIZES)


def orbax_cli_checks(torch, F, fa, da, measure_ms, res):
    """The resumed train CLI's decoder kernels at every size it draws against
    their plain versions, f32 and bf16, the check alone (no times). Into `res`."""
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in VARIANT_CLI_DRAWN_ATTENTION:
            res[(key.replace("variant_cli", "orbax_cli"), dtype)] = compare_attention(
                torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype, timed=False)
        for key, name, B, C, N, heads, scale, bias, iters in VARIANT_CLI_DRAWN_ATTENTION_BWD:
            res[(key.replace("variant_cli", "orbax_cli"), dtype)] = compare_attention_bwd(
                torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype, iters,
                timed=False)
        for key, shape in ORBAX_CLI_DRAWN_SEP:
            res[(f"K4@{key}", dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape,
                                                           timed=False)
            res[(f"K5@{key}", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype,
                                                               shape, timed=False)


def orbax_phase(torch, F, fa, da, kernels, measure_ms, card, res):
    """(a)-(d) of item 14 of the docstring. Returns (launches, numbers)."""
    import hashlib
    import os
    import shutil
    import time

    import numpy as np

    from lwdetr_tpu_torch import demo
    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.train import checkpoint as ckpt
    from lwdetr_tpu_torch.train import engine, orbax_read
    from lwdetr_tpu_torch.weights import param_tensors_from_jax, state_dict_from_jax

    t_phase = time.perf_counter()
    work = os.path.abspath("build/chip_smoke/orbax")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt_dir = os.path.join(ORBAX_FIXTURE, "ckpt")
    with open(os.path.join(ORBAX_FIXTURE, "orbax_digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(ORBAX_FIXTURE, "golden_stats_orbax.json")) as f:
        golden = json.load(f)
    out, launches = {}, {}

    # (a) the reader, on the card machine's host
    orbax_read.restore(ckpt_dir)  # builds the decoder; the timed read below is the second
    tree = orbax_read.restore(ckpt_dir)

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k], path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from leaves(v, path + (str(i),))
        elif node is not None:
            yield path, node

    got = [{"path": list(p), "dtype": a.dtype.str, "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()} for p, a in leaves(tree)]
    if got != digests["leaves"] or tree.step != digests["step"] != ORBAX_STEP:
        bad = next((g["path"] for g, d in zip(got, digests["leaves"]) if g != d), None)
        raise AssertionError(f"orbax (a): {len(got)} leaves vs {len(digests['leaves'])} in "
                             f"orbax_digests.json, the first that differs {bad}; step {tree.step}")
    rate = tree.bytes_decoded / tree.seconds / 1e6
    out["a_read"] = {"leaves": len(got), "bytes_decoded": tree.bytes_decoded,
                     "bytes_read": tree.bytes_read, "seconds": tree.seconds,
                     "mb_per_s": rate, "warm": True}
    print(f"orbax (a): {len(got)} leaves equal to orbax's digests; {tree.bytes_decoded} bytes "
          f"decoded from {tree.bytes_read} in {tree.seconds:.4f} s, {rate:.1f} MB/s on the "
          f"host, files warm in the page cache ({card})")

    # (b) the eval CLI, both blocks, then the same on the plain versions
    def eval_args():
        return cli.parser().parse_args(
            ["--eval", "--coco_path", FIXTURE, *MICRO_FLAGS, "--batch_size", str(MICRO_BATCH),
             "--resume", ckpt_dir, "--use_ema", "--output_dir", os.path.join(work, "eval"),
             "--dont_bench", "--num_workers", "2"])

    rec = Recorder(torch, tr, engine)
    t0 = time.perf_counter()
    result, launches["orbax_eval_cli"] = counted(torch, kernels, lambda: run_patched(
        lambda: cli.main(eval_args()), rec.patches()))
    wall = time.perf_counter() - t0
    blocks = {"stats": result["stats"], "ema_stats": result["ema_stats"]}
    off = {key: {k: blocks[key][k] - v for k, v in golden[key].items()} for key in blocks}
    worst = max(abs(v) for d in off.values() for v in d.values())
    print(f"orbax (b): eval CLI --resume {ckpt_dir} --use_ema, f32: the stats "
          f"{json.dumps({k: blocks['stats'][k] for k in golden['stats']})}, EMA "
          f"{json.dumps({k: blocks['ema_stats'][k] for k in golden['ema_stats']})}; minus "
          f"golden_stats_orbax.json, both blocks: max |d| {worst:.3g}; {wall:.1f} s ({card})")
    if launches["orbax_eval_cli"] != ORBAX_EVAL_LAUNCHES or worst > GOLDEN_ATOL:
        raise AssertionError(f"orbax (b): launches {launches['orbax_eval_cli']}, stats off the "
                             f"golden: {off}")
    plain = Recorder(torch, tr, engine, replay_from=rec)
    _, n = counted(torch, kernels, lambda: run_patched(
        lambda: cli.main(eval_args()), plain_patches(fa, da) + plain.patches()))
    if any(n.values()):
        raise AssertionError(f"orbax (b): the plain pipeline launched kernels: {n}")
    out["b_eval_cli"] = {"stats": {k: blocks["stats"][k] for k in golden["stats"]},
                         "ema_stats": {k: blocks["ema_stats"][k] for k in golden["ema_stats"]},
                         "max_abs_minus_golden": worst, "wall_s": wall,
                         "kernels_vs_plain": compare_detections(torch, "orbax_eval_cli", rec,
                                                                plain, 10, bf16=False)}

    # (c) one epoch through the train CLI, resumed from the fixture
    orbax_cli_checks(torch, F, fa, da, measure_ms, res)
    coco = os.path.join(work, "coco")
    os.makedirs(os.path.join(coco, "annotations"))
    for split in ("train2017", "val2017"):
        os.symlink(os.path.abspath(f"{FIXTURE}/val2017"), os.path.join(coco, split))
        shutil.copy(f"{FIXTURE}/annotations/instances_val2017.json",
                    os.path.join(coco, "annotations", f"instances_{split}.json"))
    argv = ["--coco_path", coco, *MICRO_FLAGS, "--batch_size", str(MICRO_BATCH), "--epochs",
            "2", "--use_ema", "--resume", ckpt_dir, "--output_dir", os.path.join(work, "train"),
            "--dont_bench", "--num_workers", "2"]
    args = cli.parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    mcfg, tcfg = cfg.model, cfg.train
    restore, checks = ckpt.restore_orbax_train_state, {}

    def checked_restore(path, state, model_cfg, loaded=None):
        step = restore(path, state, model_cfg, loaded)
        adam, sched = tree["opt_state"][1], tree["opt_state"][2]
        want = state_dict_from_jax(tree["params"], tree["batch_stats"], mcfg)
        ema = state_dict_from_jax(tree["ema"]["params"], tree["ema"]["batch_stats"], mcfg)
        mu, nu = param_tensors_from_jax(adam["mu"], mcfg), param_tensors_from_jax(adam["nu"], mcfg)
        named = dict(state.model.named_parameters())
        opt = [state.optimizer.state[p] for p in named.values()]
        checks.update({
            "model": all(torch.equal(v.cpu(), want[k])
                         for k, v in state.model.state_dict().items()),
            "ema": all(torch.equal(v.cpu(), ema[k]) for k, v in state.ema.items()),
            "exp_avg": all(torch.equal(st["exp_avg"].cpu(), mu[k])
                           for k, st in zip(named, opt)),
            "exp_avg_sq": all(torch.equal(st["exp_avg_sq"].cpu(), nu[k])
                              for k, st in zip(named, opt)),
            "adam_step": all(float(st["step"]) == int(adam["count"]) == ORBAX_STEP
                             for st in opt),
            "schedule": state.scheduler.last_epoch == int(sched["count"]) == ORBAX_STEP,
            "step": step == int(tree["step"]) == ORBAX_STEP})
        return step

    one_epoch, first = engine.train_one_epoch, {}

    def recording_epoch(train_step, state, loader, epoch, *a, **kw):
        first.setdefault("epoch", epoch)
        first.setdefault("lr", [g["lr"] for g in state.optimizer.param_groups])
        first.setdefault("initial_lr", [g["initial_lr"] for g in state.optimizer.param_groups])
        return one_epoch(train_step, state, loader, epoch, *a, **kw)

    build, sizes, losses = engine.build_train_step, [], []

    def recording_build(state, *a, **kw):
        step = build(state, *a, **kw)

        def recording(*sa, **skw):
            sizes.append(int(sa[0]["images"].shape[1]))
            metrics = step(*sa, **skw)
            losses.append(float(metrics["loss"]))
            return metrics

        return recording

    t0 = time.perf_counter()
    trained, launches["orbax_train_cli"] = counted(torch, kernels, lambda: run_patched(
        lambda: cli.main(args),
        (mock.patch.object(ckpt, "restore_orbax_train_state", checked_restore),
         mock.patch.object(engine, "train_one_epoch", recording_epoch),
         mock.patch.object(engine, "build_train_step", recording_build))))
    wall_c = time.perf_counter() - t0
    niter = CLI_STEPS
    # the JAX schedule (lwdetr_tpu/train/optim.py:105-110) at the restored count
    mult = 0.1 ** ((ORBAX_STEP // niter) // tcfg.lr_drop)
    lr_ok = all(abs(lr - base * mult) <= 1e-12 * base
                for lr, base in zip(first.get("lr", []), first.get("initial_lr", [])))
    inv = variant_cli_launch_invariants(launches["orbax_train_cli"], CLI_STEPS,
                                        CLI_EVAL_BATCHES)
    bad = {k: v for k, v in inv.items() if v[0] != v[1]}
    log(f"orbax (c): restored equal {checks}; start epoch {first.get('epoch')}, first lr "
        f"{first.get('lr', [None])[:3]} (multiplier {mult}); train sizes {sizes}, losses "
        f"{losses}; launches {launches['orbax_train_cli']}")
    if (not checks or not all(checks.values()) or first.get("epoch") != ORBAX_STEP // niter
            or not lr_ok or bad or trained["epochs"] != [1] or len(losses) != CLI_STEPS
            or not all(np.isfinite(losses))):
        raise AssertionError(f"orbax (c): restored {checks}, epoch {first.get('epoch')}, lr ok "
                             f"{lr_ok}, launch checks {bad}, epochs {trained['epochs']}, losses "
                             f"{losses}")
    if not set(sizes) <= set(ORBAX_CLI_SIZES):
        raise AssertionError(f"orbax (c): train sizes {sizes} outside the kernel checks' "
                             f"{ORBAX_CLI_SIZES}")
    out["c_train_cli"] = {"restored_equal": checks, "start_epoch": first["epoch"],
                          "first_lr": first["lr"], "losses": losses, "train_sizes": sizes,
                          "wall_s": wall_c}

    # (d) the demo: the orbax directory's EMA against a .pth of the same weights
    image = os.path.join(FIXTURE, "val2017", sorted(os.listdir(f"{FIXTURE}/val2017"))[1])
    pth = os.path.join(work, "ema.pth")
    torch.save({"model": ckpt.load_orbax_variables(ckpt_dir, mcfg, use_ema=True, tree=tree)},
               pth)

    def run_demo(path, *extra):
        return counted(torch, kernels, lambda: run_patched(
            lambda: demo.main(["--image", image, "--checkpoint", path, "--output",
                               os.path.join(work, "demo.jpg"), "--threshold", "0.05", *extra]),
            (mock.patch("lwdetr_tpu_torch.config.get_config", lambda preset: mcfg),)))

    (dets, launches["orbax_demo"]), (ref, n) = run_demo(ckpt_dir, "--ema"), run_demo(pth)
    same = all(np.array_equal(dets[k], ref[k]) for k in ("scores", "labels", "boxes"))
    if not same or launches["orbax_demo"] != ORBAX_DEMO_LAUNCHES or n != ORBAX_DEMO_LAUNCHES:
        raise AssertionError(f"orbax (d): detections equal the .pth demo's {same}; launches "
                             f"{launches['orbax_demo']}, {n}")
    out["d_demo"] = {"kept": dets["kept"], "equal_to_pth_demo": same}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"orbax phase: (a)-(d) held in {out['wall_s']:.1f} s; train epoch from step "
          f"{ORBAX_STEP} {wall_c:.1f} s, losses {losses}; demo {dets['kept']} detections, equal "
          f"to the .pth demo's ({card})")
    return launches, out


# ---- the deploy path (ROADMAP.md § 1, "Deploy: export and its benchmark") ------------------

# the startup self-benchmark (`startup_bench_phase`): small's parameters, which
# tests/test_torch_port_bench.py holds to the JAX package's count
SMALL_PARAMETERS = 14557378
BENCH_FORWARDS = 26  # one counted by FlopCounterMode, 5 warm-up, 20 timed

DEPLOY_HW = (640, 640)
# (path, preset, compute dtype, batch), each exported on the card from the JAX
# initialisation (seed 0), saved, loaded again and called
DEPLOY_PATHS = (("deploy_small_f32", "small", "float32", 1),
                ("deploy_small_bf16", "small", "bfloat16", 1),
                ("deploy_small_bf16_b32", "small", "bfloat16", 32),
                ("deploy_large_bf16", "large", "bfloat16", 1),
                ("deploy_tiny_bf16", "tiny", "bfloat16", 1))
DEPLOY_MEASURED = ("deploy_small_bf16", "deploy_small_bf16_b32")  # `measure`d, with the eager call
DEPLOY_REPEATS = 20
DEPLOY_GOLDEN = f"{FIXTURE}/golden_stats_deploy.json"
# the micro model's artifact over the fixture's 20 images at batch 1: a
# window block (K1) and a global block (K2), two decoder layers of 12 queries
# (K9) sampling 1600 positions (K3) an image
MICRO_DEPLOY_LAUNCHES = launch_counts(K1=20, K2=20, K9=40, K3=40)


def first_difference(torch, model, images):
    """Where the exported forward first leaves the eager one: the model's
    forward (its pred_logits and pred_boxes) exported, its graph run node by
    node, and the last node of each module held against that module's eager
    output (forward hooks), in the graph's order. Returns (the first module
    that differs, its node, the node's target) or None, and the graph's
    (pred_logits, pred_boxes)."""
    import torch.fx

    class Raw(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.model = m

        def forward(self, x):
            out = self.model(x)
            return out["pred_logits"], out["pred_boxes"]

    raw = Raw(model)
    gm = torch.export.export(raw, (images,)).module()
    eager, hooks = {}, []
    for name, mod in raw.named_modules():
        hooks.append(mod.register_forward_hook(  # a module called again: its last call
            lambda m, i, o, name=name: eager.__setitem__(name, o)))
    with torch.no_grad():
        raw(images)
    for h in hooks:
        h.remove()
    values, last = {}, {}

    class Recording(torch.fx.Interpreter):
        def run_node(self, n):
            values[n.name] = super().run_node(n)
            for path, _ in (n.meta.get("nn_module_stack") or {}).values():
                last[path] = n  # a module's last node (its children's included)
            return values[n.name]

    with torch.no_grad():
        outs = Recording(gm).run(images)
    for path, node in sorted(last.items(), key=lambda kv: list(gm.graph.nodes).index(kv[1])):
        a, b = values[node.name], eager.get(path)
        if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.shape == b.shape
                and not torch.equal(a, b)):
            return (path, node.name, str(node.target)), outs
    return None, outs


def weight_casts(torch, gm):
    """The casts of weights (float32 parameters and buffers) that an exported
    graph makes at every call: (count, bytes read and written)."""
    import functools

    count = nbytes = 0
    for n in gm.graph.nodes:
        if (n.op == "call_function" and str(n.target) in ("aten.to.dtype", "aten._to_copy.default")
                and n.args[0].op == "get_attr"):
            w = functools.reduce(getattr, n.args[0].target.split("."), gm)
            count += 1
            nbytes += w.numel() * (w.element_size() + 2)
    return count, nbytes


def host_profile(torch, call, images, calls=5):
    """torch.profiler over `calls` calls of `call(images)`: a call's self CPU
    ms (every op and runtime call), device ms, kernel launches, and the `lwdetr`
    operators' self CPU us a call of each (their Python: the dispatcher's
    autograd and backend frames, the wrapper, the ctypes launch)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call(images)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.key != "Activity Buffer Request"]  # the profiler's own set-up
    return {"self_cpu_ms_a_call": sum(e.self_cpu_time_total for e in events) / 1e3 / calls,
            "device_ms_a_call": sum(e.self_device_time_total for e in events) / 1e3 / calls,
            "kernel_launches_a_call": sum(e.count for e in events if e.key in (
                "cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC")) / calls,
            "operator_self_cpu_us": {e.key: e.self_cpu_time_total / e.count for e in events
                                     if e.key.startswith("lwdetr::")}}


def operator_dispatch_us(torch, fa, da, turns=2, calls=500):
    """Host us a call of each forward kernel's direct launch (`*_fwd`) and of
    its operator, in turns, on small inputs (the enqueue, not the kernel):
    what the operator's dispatch adds to a launch."""
    import time

    g = torch.Generator(device="cuda").manual_seed(0)
    q1 = torch.randn((2, 576, 100), generator=g, device="cuda")
    bias = torch.randn((576,), generator=g, device="cuda")
    q2 = torch.randn((1, 768, 300), generator=g, device="cuda")
    v = torch.randn((1, 256, 1600), generator=g, device="cuda")
    loc = torch.rand((1, 300, 8, 1, 4, 2), generator=g, device="cuda")
    w = torch.rand((1, 300, 8, 1, 4), generator=g, device="cuda")
    cases = {"K1": (lambda: fa.window_attention_bias_fwd(q1, bias, 12, 0.25),
                    lambda: fa.window_attention_bias(q1, bias, 12, 0.25)),
             "K2": (lambda: fa.flash_attention_cm_fwd(q2, 8, 0.17),
                    lambda: fa.flash_attention_cm(q2, 8, 0.17)),
             "K3": (lambda: da.ms_deform_attn_cm_fwd(v, [(40, 40)], loc, w, 8),
                    lambda: da.ms_deform_attn_cm(v, [(40, 40)], loc, w, 8))}
    out = {name: {"launch": [], "operator": []} for name in cases}
    with torch.no_grad():
        for _ in range(turns):
            for name, fns in cases.items():
                for kind, fn in zip(("launch", "operator"), fns):
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    out[name][kind].append((time.perf_counter() - t) / calls * 1e6)
                    torch.cuda.synchronize()
    return out


def deploy_phase(torch, fa, da, kernels, card):
    """ROADMAP.md § 1, "Deploy: export and its benchmark", on the card: each of
    DEPLOY_PATHS exported (`deploy/export.py`), saved, loaded and called; its
    launches equal to the eager forward's (EXPECTED_LAUNCHES) and its scores,
    labels and boxes to the eager forward's bit for bit (else the first
    module that differs is printed and the raw outputs held to the forward
    bounds: f32 2e-3 / 5e-4 with the same picks, bf16 the drift ceiling);
    the weight casts each graph makes a call; `measure` of the bf16 small
    artifact and of its eager call at batch 1 and 32 (with their host time
    under the profiler), and the deploy benchmark's CLI on those artifacts in a
    process of its own, beside `bench.run`; the host us a call of each
    operator against its direct launch; the
    micro model's f32 artifact through `evaluate_coco` on the fixture (its 12
    stats within 1e-7 of golden_stats_deploy.json; its bf16 artifact's
    printed); the CLI's `export_model --infer_dir` in a process of its own.
    Returns (launches, numbers)."""
    import os
    import subprocess
    import time

    from lwdetr_tpu_torch import bench
    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.deploy import benchmark, export
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.weights import jax_init_state_dict

    t0 = time.perf_counter()
    work = "build/chip_smoke/deploy"
    os.makedirs(work, exist_ok=True)
    launches, out, inits = {}, {}, {}
    for path, preset, dtype, batch in DEPLOY_PATHS:
        cfg = get_config(preset)
        if preset not in inits:
            inits[preset] = jax_init_state_dict(cfg, torch.Generator().manual_seed(0))
        model = build_model(cfg, device="cuda", dtype=getattr(torch, dtype),
                            state_dict=inits[preset])
        t = time.perf_counter()
        file = export.export_serialized(model, f"{work}/{path}.pt2", DEPLOY_HW, batch,
                                        cfg.num_select)
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        call, meta = export.load_serialized(file)
        load_s = time.perf_counter() - t
        g = torch.Generator(device="cuda").manual_seed(1)
        images = torch.randn((batch, *DEPLOY_HW, 3), generator=g, device="cuda")
        fn = export.make_export_fn(model, cfg.num_select, DEPLOY_HW, batch)
        with torch.no_grad():
            ref, eager_n = counted(torch, kernels, lambda: fn(images))
        got, launches[path] = counted(torch, kernels, lambda: call(images))
        if launches[path] != EXPECTED_LAUNCHES[preset] or eager_n != EXPECTED_LAUNCHES[preset]:
            raise AssertionError(f"{path}: artifact launches {launches[path]}, eager {eager_n}, "
                                 f"!= {EXPECTED_LAUNCHES[preset]}")
        shapes = [(batch, cfg.num_select), (batch, cfg.num_select), (batch, cfg.num_select, 4)]
        if [list(t.shape) for t in got] != [list(s) for s in shapes] or not all(
                torch.isfinite(t).all() for t in (got[0], got[2])):
            raise AssertionError(f"{path}: outputs {[tuple(t.shape) for t in got]}, not finite "
                                 f"or not {shapes}")
        equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref))
        casts, cast_bytes = weight_casts(torch, call)
        entry = {"meta": meta, "export_s": export_s, "load_s": load_s, "bit_equal": equal,
                 "launches": launches[path], "weight_casts_a_call": casts,
                 "weight_cast_bytes_a_call": cast_bytes,
                 "artifact_bytes": os.path.getsize(file)}
        if not equal:
            where, (logits, boxes) = first_difference(torch, model, images)
            with torch.no_grad():
                eager = model(images)
            err_l = (logits.float() - eager["pred_logits"].float()).abs().max().item()
            err_b = (boxes.float() - eager["pred_boxes"].float()).abs().max().item()
            entry.update(first_difference=where, logits_max_abs_err=err_l, boxes_max_abs_err=err_b)
            log(f"{path}: the artifact is not bit-equal to the eager forward; first at "
                f"{where}; logits {err_l:.3g}, boxes {err_b:.3g}")
            if dtype == "float32":
                same_picks = torch.equal(got[1], ref[1]) and torch.equal(
                    torch.topk(logits.reshape(batch, -1), cfg.num_select).indices,
                    torch.topk(eager["pred_logits"].reshape(batch, -1), cfg.num_select).indices)
                if err_l > FWD_ATOL_LOGITS or err_b > FWD_ATOL_BOXES or not same_picks:
                    raise AssertionError(f"{path}: logits {err_l}, boxes {err_b}, same picks "
                                         f"{same_picks}")
            else:
                dp = (logits.float().sigmoid() - eager["pred_logits"].float().sigmoid()).abs()
                db = (boxes - eager["pred_boxes"]).abs()
                drift = {"prob_mean": dp.mean().item(), "prob_max": dp.max().item(),
                         "box_mean": db.mean().item()}
                entry["drift"] = drift
                if any(v >= BF16_DRIFT[k] for k, v in drift.items()):
                    raise AssertionError(f"{path}: drifts from the eager forward: {drift}")
        if path in DEPLOY_MEASURED:
            with torch.no_grad():
                entry["eager_measure"] = benchmark.measure(fn, DEPLOY_HW, batch, DEPLOY_REPEATS)
            entry["measure"] = benchmark.measure(call, DEPLOY_HW, batch, DEPLOY_REPEATS)
            entry["eager_host"] = host_profile(torch, fn, images)
            entry["host"] = host_profile(torch, call, images)
            print(f"{path}: a call, artifact / eager: self CPU "
                  f"{entry['host']['self_cpu_ms_a_call']:.2f} / "
                  f"{entry['eager_host']['self_cpu_ms_a_call']:.2f} ms, device "
                  f"{entry['host']['device_ms_a_call']:.2f} / "
                  f"{entry['eager_host']['device_ms_a_call']:.2f} ms, kernel launches "
                  f"{entry['host']['kernel_launches_a_call']:.0f} / "
                  f"{entry['eager_host']['kernel_launches_a_call']:.0f}; operators' self CPU us "
                  f"a call {json.dumps(entry['host']['operator_self_cpu_us'])} / "
                  f"{json.dumps(entry['eager_host']['operator_self_cpu_us'])} (profiled)")
            print(f"{path}: artifact median {entry['measure']['median_ms']:.3f} ms, pipelined "
                  f"{entry['measure']['pipelined_ms']:.3f} ms, {entry['measure']['imgs_per_s']:.1f}"
                  f" img/s; eager median {entry['eager_measure']['median_ms']:.3f} ms, pipelined "
                  f"{entry['eager_measure']['pipelined_ms']:.3f} ms ({card})")
        log(f"{path}: exported in {export_s:.1f} s, loaded in {load_s:.1f} s, bit-equal {equal}, "
            f"launches {launches[path]}, {casts} weight casts a call ({cast_bytes / 1e6:.1f} MB)")
        out[path] = entry
        del model, call, fn
    # the deploy benchmark's CLI, as a user runs it: a process of its own
    for path in DEPLOY_MEASURED:
        proc = subprocess.run([sys.executable, "-m", "lwdetr_tpu_torch.deploy.benchmark", "--path",
                               f"{work}/{path}.pt2", "--repeats", str(DEPLOY_REPEATS)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"deploy benchmark CLI on {path} failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        lat = json.loads(proc.stdout.strip().splitlines()[-1])["latency"]
        out[path]["benchmark_cli"] = lat
        print(f"{path}: python -m lwdetr_tpu_torch.deploy.benchmark: median {lat['median_ms']:.3f} "
              f"ms, pipelined {lat['pipelined_ms']:.3f} ms, {lat['imgs_per_s']:.1f} img/s ({card})")
    out["operator_dispatch_us"] = operator_dispatch_us(torch, fa, da)
    print(f"host us a call, direct launch / operator (2 turns): "
          f"{json.dumps(out['operator_dispatch_us'])} ({card})")
    out["bench_small_b32"] = bench.run("small", batch=32)
    print(f"small@640 bf16 eager bench: {out['bench_small_b32']['value']:.1f} img/s at batch 32 "
          f"({card})")

    # the micro model's artifacts through evaluate_coco on the fixture
    with open(DEPLOY_GOLDEN) as f:
        golden = json.load(f)["stats"]
    pth = f"{work}/micro.pth"
    micro_args = cli.parser().parse_args([*MICRO_FLAGS, "--resume", pth, "--output_dir",
                                          f"{work}/cli", "export_model"])
    micro_pth(torch, pth, micro_args)
    mcfg = cli.config_from_args(micro_args).model
    sd = torch.load(pth, map_location="cpu")["model"]
    for dtype in ("float32", "bfloat16"):
        model = build_model(mcfg, device="cuda", dtype=getattr(torch, dtype), state_dict=sd)
        file = export.export_serialized(model, f"{work}/micro_{dtype}.pt2", DEPLOY_HW, 1,
                                        mcfg.num_select)
        call, meta = export.load_serialized(file)
        stats, n = counted(torch, kernels, lambda: benchmark.evaluate_coco(
            call, FIXTURE, DEPLOY_HW, 1))
        tag = f"deploy_micro_coco_{dtype}"
        launches[tag] = n
        dist = {k: stats[k] - golden[k] for k in golden}
        out[tag] = {"stats": {k: stats[k] for k in golden}, "minus_golden": dist}
        print(f"{tag}: the 12 stats {json.dumps(out[tag]['stats'])}; minus golden_stats_deploy: "
              f"max |d| {max(abs(v) for v in dist.values()):.3g} ({card})")
        if n != MICRO_DEPLOY_LAUNCHES:
            raise AssertionError(f"{tag}: launches {n} != {MICRO_DEPLOY_LAUNCHES}")
        bad = {k: v for k, v in dist.items() if abs(v) > GOLDEN_ATOL}
        if dtype == "float32" and bad:
            raise AssertionError(f"{tag}: stats off golden_stats_deploy by more than "
                                 f"{GOLDEN_ATOL}: {bad}")

    # the CLI, as a user runs it
    image = f"{FIXTURE}/val2017/000000000001.jpg"
    cmd = [sys.executable, "-m", "lwdetr_tpu_torch.main", *MICRO_FLAGS, "--resume", pth,
           "--output_dir", f"{work}/cli", "export_model", "--shape", "640", "640",
           "--infer_dir", image]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    top = [ln for ln in proc.stdout.splitlines() if "top-5" in ln]
    out["cli"] = {"returncode": proc.returncode, "top5": top, "wall_s": time.perf_counter() - t,
                  "meta": export.read_meta(f"{work}/cli/{export.ARTIFACT}")
                  if proc.returncode == 0 else None}
    print(f"deploy CLI export_model --infer_dir: exit {proc.returncode}; {top}")
    if proc.returncode != 0 or len(top) != 1 or out["cli"]["meta"]["dtype"] != "bfloat16":
        raise AssertionError(f"deploy CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"deploy phase: {out['wall_s']:.1f} s ({card})")
    return launches, out


# the startup self-benchmark (`startup_bench_phase`): `utils/benchmark.py`'s
# `benchmark_model` for small at 640, batch 1, f32 and bf16, as the CLI runs it
# at start-up; its forwards launch small's eval kernels
BENCH_DTYPES = ("float32", "bfloat16")


def bench_operator_flops(cfg, size=640, batch=1):
    """The attention and sampling FLOPs of one eval forward of a ViT model
    with a channel-major sampler, counted from the config: QK^T and PV, 4 B
    N^2 C, for each window block (16 windows), each global block and each
    decoder self-attention, under the operator `attention_cm` dispatches it
    to (N <= 128: K1 with a bias, K9 without; else K2); 8 FLOPs an output
    element a (level, point) for each cross-attention (K3)."""
    side = size // 16
    window = len(cfg.window_block_indexes)
    flops = {"window_attention_bias": 0, "window_attention": 0, "flash_attention_cm": 0}

    def attention(blocks, B, N, width, bias):
        op = ("window_attention_bias" if bias else "window_attention") if N <= 128 else \
            "flash_attention_cm"
        flops[op] += blocks * 4 * B * N * N * width

    attention(window, 16 * batch, (side // 4) ** 2, cfg.embed_dim, True)
    attention(cfg.vit_encoder_num_layers - window, batch, side * side, cfg.embed_dim, True)
    attention(cfg.dec_layers, batch, cfg.num_queries, cfg.hidden_dim, False)
    flops["ms_deform_attn_cm"] = (cfg.dec_layers * 8 * batch * cfg.num_queries * cfg.hidden_dim
                                  * len(cfg.projector_scale) * cfg.dec_n_points)
    return flops


def startup_bench_phase(torch, kernels, card):
    """`benchmark_model` (`lwdetr_tpu_torch/utils/benchmark.py`, what
    `lwdetr_tpu_torch.main` runs on rank 0 at start-up) for small at 640 x 640,
    batch 1, in f32 and in bf16 (f32 parameters), seeded weights: the
    parameter count against SMALL_PARAMETERS, the operators' FLOPs against
    `bench_operator_flops`, the launches of its 26 forwards, and the GFLOPs by
    class, the fps and the latency printed beside the card. Returns
    (launches, numbers)."""
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.utils import benchmark as bm
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = get_config("small")
    sd = init_state_dict(cfg, seed=0)
    want_flops = bench_operator_flops(cfg)
    want = {k: n * BENCH_FORWARDS for k, n in EXPECTED_LAUNCHES["small"].items()}
    launches, res = {}, {}
    for dtype in BENCH_DTYPES:
        path = f"startup_bench_{dtype}"
        model = build_model(cfg, device="cuda", dtype=getattr(torch, dtype), state_dict=sd)
        stats, launches[path] = counted(
            torch, kernels, lambda: bm.benchmark_model(model, image_size=640, batch=1,
                                                       logger=log))
        ops = stats["detailed_flops"]["flops_by_op"]
        got_flops = {k: ops.get(k, 0) for k in want_flops}
        log(f"{path} launches: {launches[path]}; operator FLOPs {got_flops}")
        if launches[path] != want:
            raise AssertionError(f"{path}: launches {launches[path]} != {want}")
        if stats["n_parameters"] != SMALL_PARAMETERS:
            raise AssertionError(f"{path}: {stats['n_parameters']} parameters, not "
                                 f"{SMALL_PARAMETERS}")
        if got_flops != want_flops:
            raise AssertionError(f"{path}: operator FLOPs {got_flops} != {want_flops}")
        by_class = stats["gflops_by_class"]
        print(f"startup bench, small@640 batch 1 {dtype}: {stats['n_parameters']} parameters, "
              f"{stats['gflops']:.4f} GFLOPs/img ("
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_class.items()))
              + f"), {stats['fps']:.2f} img/s (median {stats['median_ms']:.4f} ms, mean "
              f"{stats['mean_ms']:.4f}, p95 {stats['p95_ms']:.4f}) ({card})")
        res[path] = {k: stats[k] for k in ("n_parameters", "gflops", "gflops_by_class", "fps",
                                           "median_ms", "mean_ms", "p95_ms", "batch",
                                           "image_size", "dtype")}
        res[path]["gflops_by_stage"] = {
            stage: {c: f / 1e9 for c, f in by.items()}
            for stage, by in stats["detailed_flops"]["flops_by_stage"].items()}
        res[path]["card"] = card
        del model
    torch.cuda.empty_cache()
    return launches, res


# multi-process training and eval (`dist_phase`): two processes of this script
# on the one card (`gloo`, each on cuda:0; NCCL refuses two ranks on a device),
# launched with torchrun's variables. (a) small's f32 train step, 2 x batch 2
# against this process's step on the same 4 images from the same weights; (b)
# ZeRO-1 against the unsharded run; (c) large's bf16 step at its release
# drop_path, 2 x 1 against 1 x 2; (d) the eval CLI on the fixture.
DIST_WORLD = 2
DIST_DIR = "build/chip_smoke/dist"
DIST_TIMEOUT = 600  # seconds a launch of two processes may take
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_TOL = 1e-4  # x max(1, the tensor's max |g|)
DIST_BN_ATOL = 1e-6
DIST_BF16_LOSS_RTOL = BF16_TRAIN_GRAD_MEDIAN
DIST_ZERO_STEPS = 2
DIST_EVAL_LAUNCHES = launch_counts(K1=3, K2=3, K9=6, K3=6, M1=3)  # 10 images: 3 batches of 4


def port_kernels():
    """{name: kernel} of every kernel of the port, in KERNEL_NAMES' order."""
    from lwdetr_tpu_torch.models import matcher as tm
    from lwdetr_tpu_torch.ops import deform_attn as da
    from lwdetr_tpu_torch.ops import flash_attention as fa

    kernels = {k.name: k for k in (
        fa.window_attention_bias_kernel, fa.flash_attention_cm_kernel, da.deform_attn_cm_kernel,
        da.deform_attn_sep_kernel, da.deform_attn_sep_bwd_kernel,
        fa.flash_attention_cm_bwd_kernel, fa.window_attention_bias_bwd_kernel,
        fa.window_attention_bwd_kernel, da.deform_attn_cm_bwd_kernel, fa.window_attention_kernel,
        da.deform_attn_rowmajor_kernel, da.deform_attn_rowmajor_bwd_kernel,
        tm.assignment_kernel)}
    if tuple(kernels) != KERNEL_NAMES:
        raise AssertionError(f"kernels {tuple(kernels)} != {KERNEL_NAMES}")
    return kernels


def max_ulp(torch, a, b):
    """The largest distance in f32 ulps between two float32 tensors."""
    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() else 0


def own_rows(full, like, rank):
    """This process's part of a tensor recorded on the global batch: `rank`'s
    slice along the first axis where `full` is larger than `like` (the batch
    axis), `full` itself where they agree."""
    for ax, (n, m) in enumerate(zip(full.shape, like.shape)):
        if n != m:
            return full.narrow(ax, rank * m, m).to(like.device)
    return full.to(like.device)


def dist_step(torch, kernels, cfg, tcfg, sd, batch, dtype, rate, replay=None, rank=0, steps=1,
              shard=False, keep_state=False, feed_grads=None):
    """`steps` train steps of `cfg` from `sd` through `engine.build_train_step`
    on `batch` (DDP above one process), the drop-path rate `rate`: per step
    the loss, the gradients before clipping and the BatchNorm statistics; the
    launches; the drop masks the engine drew. With `feed_grads` (a dict of
    gradients a step) the clip and the optimizer take those in place of the
    step's own. The step's discrete choices are
    recorded, or with `replay` replayed (this process's part of them, trap
    (b)): the proposal picks and the matching (trap (d)), each sampling
    point's cell (the points themselves, with d(loc) passed through: a point
    within an ulp of a grid line takes the other cell under another rounding)
    and each ReLU's active units (its input's signs, the gradient through the
    recorded units)."""
    import time

    import torch.nn.functional as F

    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import drop
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.ops import deform_attn as da
    from lwdetr_tpu_torch.train import engine

    state = engine.create_train_state(cfg, tcfg, niter_per_ep=1000, device="cuda", state_dict=sd,
                                      dtype=dtype, shard_opt_state=shard)
    step = engine.build_train_step(state, cm.SetCriterion(cfg, tcfg), tcfg)
    named = list(state.model.named_parameters())
    rec = {"picks": [], "matchings": [], "grads": [], "masks": [], "steps": [], "locs": [],
           "relus": []}
    select, match, clip = tr.select_proposals, cm.hungarian_match, torch.nn.utils.clip_grad_norm_
    sampler, relu = da.ms_deform_attn_sep_panels, F.relu
    draw = drop.RankRows.__call__  # the engine's source at every world size

    def replayed(key, own):
        rec[key].append(own)
        if replay is None:
            return own
        return own_rows(replay[key][len(rec[key]) - 1], own, rank)

    def spy_clip(params, max_norm):
        if feed_grads is not None:
            fed = feed_grads[len(rec["grads"])]
            for n, p in named:
                if p.grad is not None:
                    p.grad.copy_(fed[n])
        rec["grads"].append({n: p.grad.detach().clone() for n, p in named if p.grad is not None})
        return clip(params, max_norm)

    def record(self, keep, shape, like):
        rec["masks"].append(draw(self, keep, shape, like))
        return rec["masks"][-1]

    def sample(panels, shapes, loc, weights):
        given = replayed("locs", loc.detach())
        return sampler(panels, shapes, loc + (given - loc).detach(), weights)

    def replay_relu(x, inplace=False):
        active = replayed("relus", x.detach() > 0)
        return x * active.to(x.dtype) if replay is not None else relu(x)

    patches = (mock.patch.object(tr, "select_proposals",
                                 lambda scores, k: replayed("picks", select(scores, k))),
               mock.patch.object(cm, "hungarian_match",
                                 lambda *a, **kw: replayed("matchings", match(*a, **kw))),
               mock.patch.object(torch.nn.utils, "clip_grad_norm_", spy_clip),
               mock.patch.object(drop.RankRows, "__call__", record),
               mock.patch.object(da, "ms_deform_attn_sep_panels", sample),
               mock.patch.object(F, "relu", replay_relu))

    def run():
        for _ in range(steps):
            metrics = step(batch, rate, cfg.dropout)
            rec["steps"].append({
                "loss": float(metrics["loss"]),
                "bn": {k: v.detach().clone() for k, v in state.model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}})

    t0 = time.perf_counter()
    _, rec["launches"] = counted(torch, kernels, lambda: run_patched(run, patches))
    rec["wall_ms_a_step"] = (time.perf_counter() - t0) * 1e3 / steps
    rec["device"] = str(next(state.model.parameters()).device)
    if keep_state:
        rec["state"] = state
    return rec


def dist_inputs(torch):
    """(a)'s and (c)'s configs, weights and batches: small f32 at batch 4 with
    EMA, large bf16 at batch 2 with its release drop_path."""
    import dataclasses

    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.config import get_config, get_train_config
    from lwdetr_tpu_torch.weights import init_state_dict

    out = {}
    for key, preset, batch, dtype in (("a", "small", TRAIN_BATCH, "float32"),
                                      ("c", "large", LARGE_TRAIN_BATCH, "bfloat16")):
        cfg = get_config(preset)
        tcfg = dataclasses.replace(get_train_config(preset), use_ema=True)
        out[key] = {"cfg": cfg, "tcfg": tcfg, "sd": init_state_dict(cfg, seed=0), "dtype": dtype,
                    "rate": cfg.drop_path,
                    "batch": bench_train.synthetic_batch(cfg.num_classes, batch, 640, 100, 7,
                                                         "cpu", seed=0)}
    return out


def dist_launch(mode, port, timeout=DIST_TIMEOUT):
    """This script in DIST_WORLD processes, `mode` as its argument, with
    torchrun's variables; each process's stdout. A process that fails or runs
    past `timeout` fails the phase; none is left running."""
    import os
    import subprocess

    procs = []
    for r in range(DIST_WORLD):
        env = dict(os.environ, WORLD_SIZE=str(DIST_WORLD), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(DIST_WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=os.getcwd())
        procs.append(subprocess.Popen([sys.executable, __file__, mode, DIST_DIR], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            sys.stderr.write(err[-6000:])
            if p.returncode != 0:
                raise AssertionError(f"{mode} rank {r} exited {p.returncode}:\n{out[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_child(out_dir) -> int:
    """One process of `dist_phase`'s train launch: (a) the small step on this
    process's rows of the batch, the parent's discrete choices replayed
    (`dist_step`);
    (b) ZeRO-1: DIST_ZERO_STEPS steps unsharded (its choices and gradients
    recorded), then sharded (the choices replayed, the optimizer fed the
    recorded gradients); (c) large's
    bf16 step, the engine drawing its masks. Writes out_dir/rank<r>.pt."""
    import os

    import torch

    from lwdetr_tpu_torch.parallel import dist as pdist
    from lwdetr_tpu_torch.train import engine, optim

    rank, world = pdist.init_distributed("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32, as in the parent
    torch.backends.cudnn.allow_tf32 = False
    kernels = list(port_kernels().values())
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    result = {"rank": rank, "world": world, "backend": pdist.backend()}
    for key in ("a", "c"):
        x = inp[key]
        n = x["batch"]["images"].shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        batch = {k: v[rows].cuda() for k, v in x["batch"].items()}
        dtype = getattr(torch, x["dtype"])
        rec = dist_step(torch, kernels, x["cfg"], x["tcfg"], x["sd"], batch, dtype, x["rate"],
                        replay=inp[f"{key}_replay"], rank=rank)
        result[key] = {"loss": rec["steps"][0]["loss"], "launches": rec["launches"],
                       "wall_ms_a_step": rec["wall_ms_a_step"],
                       "device": rec["device"], "masks": [m.cpu() for m in rec["masks"]],
                       "bn": {k: v.cpu() for k, v in rec["steps"][0]["bn"].items()},
                       "grad_sums": {k: float(g.double().square().sum())
                                     for k, g in rec["grads"][0].items()}}
        if key == "a" and rank == 0:
            result[key]["grads"] = {k: g.cpu() for k, g in rec["grads"][0].items()}
        torch.cuda.empty_cache()

        if key != "a":
            continue
        # (b) ZeRO-1 against the unsharded run, both through the engine's step: the
        # sharded run's optimizer takes the unsharded run's gradients (the backward
        # kernels' atomic sums are not bit-reproducible from run to run)
        runs = {}
        for name, shard in (("unsharded", False), ("sharded", True)):
            fed = runs["unsharded"]["grads"] if shard else None
            r = dist_step(torch, kernels, x["cfg"], x["tcfg"], x["sd"], batch, dtype, x["rate"],
                          replay=runs["unsharded"] if shard else None, steps=DIST_ZERO_STEPS,
                          shard=shard, keep_state=True, feed_grads=fed)
            st = r.pop("state")
            r["params"] = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
            r["ema"] = {k: v.clone() for k, v in optim.ema_full(st.ema, st.shards).items()}
            r["opt_bytes"] = optim.state_bytes(st.optimizer)
            r["planned"] = len(st.shards or {})
            runs[name] = r
            del st
        base, other = runs["unsharded"], runs["sharded"]
        zero = {
            "launches": other["launches"],
            "params_bit_equal": all(torch.equal(base["params"][k], v)
                                    for k, v in other["params"].items()),
            "ema_bit_equal": all(torch.equal(base["ema"][k], v) for k, v in other["ema"].items()),
            "params_max_ulp": max(max_ulp(torch, base["params"][k], v)
                                  for k, v in other["params"].items() if v.is_floating_point()),
            "ema_max_ulp": max(max_ulp(torch, base["ema"][k], v)
                               for k, v in other["ema"].items() if v.is_floating_point()),
            "opt_bytes": other["opt_bytes"], "planned": other["planned"],
            "unsharded_opt_bytes": base["opt_bytes"]}
        result["b"] = zero
        del runs, base, other
        torch.cuda.empty_cache()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    pdist.shutdown()
    return 0


def dist_eval_child(out_dir) -> int:
    """One process of `dist_phase`'s eval launch: `lwdetr_tpu_torch.main
    --eval` on the fixture, f32, batch 4, `--resume micro.pth`, its launches
    counted; writes out_dir/eval_rank<r>.json."""
    import os

    import torch

    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.parallel import dist as pdist

    kernels = list(port_kernels().values())
    argv = ["--eval", "--coco_path", FIXTURE, *MICRO_FLAGS, "--batch_size", str(MICRO_BATCH),
            "--resume", os.path.join(out_dir, "micro.pth"), "--output_dir",
            os.path.join(out_dir, "eval"), "--dont_bench", "--num_workers", "2"]
    out, launches = counted(torch, kernels, lambda: cli.main(cli.parser().parse_args(argv)))
    rank = pdist.rank()
    with open(os.path.join(out_dir, f"eval_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": pdist.world_size(), "backend": pdist.backend(),
                   "device": f"cuda:{torch.cuda.current_device()}", "launches": launches,
                   "stats": out["stats"]}, f)
    pdist.shutdown()
    return 0


def dist_phase(torch, kernels, card):
    """Multi-process training and eval (`lwdetr_tpu_torch/parallel/`), two
    processes of this script on the one card over `gloo`:
    (a) small's f32 train step, 2 x batch 2 against this process's step on the
        same 4 images from the same weights (its proposal picks, matchings,
        sampling cells and ReLU units replayed, trap (b)): the mean of the
        processes' losses within 1e-5
        relative, every gradient within 1e-4 x max(1, max |g|), the
        projector's running statistics within 1e-6, each process's launches
        small's train step's;
    (b) ZeRO-1 after DIST_ZERO_STEPS engine steps against the unsharded run,
        its optimizer fed the unsharded run's gradients (the backward kernels'
        atomic sums are not bit-reproducible): parameters and EMA bit for bit,
        each process's launches, the optimizer-state bytes;
    (c) large's bf16 step at drop_path 0.1, 2 x batch 1 against 1 x 2: each
        process's masks its rows of the one-process draw, the loss within
        DIST_BF16_LOSS_RTOL;
    (d) `lwdetr_tpu_torch.main --eval` in 2 processes on the fixture: the
        merged 12 stats within 1e-7 of `golden_stats.json`, printed and
        written by rank 0 only.
    The step times of two processes sharing one card measure nothing a user
    runs and are not taken. Returns (launches, numbers)."""
    import os
    import shutil
    import time

    from lwdetr_tpu_torch import main as cli

    t0 = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    inp = dist_inputs(torch)
    ref = {}
    for key, x in list(inp.items()):
        batch = {k: v.cuda() for k, v in x["batch"].items()}
        ref[key] = dist_step(torch, kernels, x["cfg"], x["tcfg"], x["sd"], batch,
                             getattr(torch, x["dtype"]), x["rate"])
        inp[f"{key}_replay"] = {k: [t.cpu() for t in ref[key][k]]
                                for k in ("picks", "matchings", "locs", "relus")}
        torch.cuda.empty_cache()
    if ref["a"]["launches"] != TRAIN_LAUNCHES["small"]:
        raise AssertionError(f"dist (a): one-process launches {ref['a']['launches']}")
    torch.save(inp, os.path.join(DIST_DIR, "inputs.pt"))
    dist_launch("--dist-child", free_port())
    ranks = [torch.load(os.path.join(DIST_DIR, f"rank{r}.pt"), weights_only=False)
             for r in range(DIST_WORLD)]
    launches, res = {}, {"card": card}

    # (a)
    a = [r["a"] for r in ranks]
    for r, x in enumerate(a):
        launches[f"dist_small_train_rank{r}"] = x["launches"]
        if x["launches"] != TRAIN_LAUNCHES["small"] or not x["device"].startswith("cuda"):
            raise AssertionError(f"dist (a) rank {r}: launches {x['launches']} on {x['device']}")
        if ranks[r]["backend"] != "gloo":
            raise AssertionError(f"dist rank {r}: backend {ranks[r]['backend']}")
    loss = sum(x["loss"] for x in a) / DIST_WORLD
    loss_ref = ref["a"]["steps"][0]["loss"]
    grads_ref = {k: g.cpu() for k, g in ref["a"]["grads"][0].items()}
    errs = {k: (a[0]["grads"][k] - g).abs().max().item() / max(1.0, g.abs().max().item())
            for k, g in grads_ref.items()}
    worst = max(errs, key=errs.get)
    same = all(a[0]["grad_sums"][k] == a[1]["grad_sums"][k] for k in grads_ref)
    bn = max((x["bn"][k] - v.cpu()).abs().max().item()
             for x in a for k, v in ref["a"]["steps"][0]["bn"].items())
    top = sorted(errs, key=errs.get)[-6:]
    log("dist (a) largest gradient errors: " + ", ".join(
        f"{k} {errs[k]:.3g} (max |g| {grads_ref[k].abs().max().item():.3g})" for k in top))
    log(f"dist (a) small f32, 2 x {TRAIN_BATCH // DIST_WORLD} vs 1 x {TRAIN_BATCH}: loss "
        f"{loss:.8f} vs {loss_ref:.8f} (ranks {[x['loss'] for x in a]}); gradient max err "
        f"{errs[worst]:.3g} x max(1, max |g|) ({worst}), median "
        f"{sorted(errs.values())[len(errs) // 2]:.3g}; BN statistics {bn:.3g}; the ranks' "
        f"gradients equal: {same}")
    if (abs(loss - loss_ref) > DIST_LOSS_RTOL * abs(loss_ref) or errs[worst] > DIST_GRAD_TOL
            or bn > DIST_BN_ATOL or not same or set(a[0]["grads"]) != set(grads_ref)):
        raise AssertionError(f"dist (a): loss {loss} vs {loss_ref}, gradient {worst} "
                             f"{errs[worst]}, BN {bn}, ranks' gradients equal {same}")
    res["a_small_f32_train"] = {"loss_2proc_mean": loss, "loss_1proc": loss_ref,
                                "rank_losses": [x["loss"] for x in a],
                                "grad_max_err": errs[worst], "grad_worst_tensor": worst,
                                "grad_median_err": sorted(errs.values())[len(errs) // 2],
                                "bn_max_abs_err": bn}

    # (b)
    b = [r["b"] for r in ranks]
    for r, z in enumerate(b):
        launches[f"dist_small_zero1_rank{r}"] = z["launches"]
        log(f"dist (b) rank {r}, {DIST_ZERO_STEPS} steps on the same gradients: ZeRO-1 vs "
            f"unsharded params bit-equal {z['params_bit_equal']} (max {z['params_max_ulp']} "
            f"ulp), EMA {z['ema_bit_equal']} ({z['ema_max_ulp']} ulp); optimizer state "
            f"{z['opt_bytes']} B sharded ({z['planned']} planned leaves) vs "
            f"{z['unsharded_opt_bytes']} B")
        if (not (z["params_bit_equal"] and z["ema_bit_equal"])
                or not z["opt_bytes"] < z["unsharded_opt_bytes"] or z["planned"] == 0
                or z["launches"] != {k: DIST_ZERO_STEPS * v
                                     for k, v in TRAIN_LAUNCHES["small"].items()}):
            raise AssertionError(f"dist (b) rank {r}: {z}")
    res["b_zero1"] = b

    # (c)
    c = [r["c"] for r in ranks]
    n = LARGE_TRAIN_BATCH // DIST_WORLD
    ref_masks = ref["c"]["masks"]
    for r, x in enumerate(c):
        launches[f"dist_large_bf16_train_rank{r}"] = x["launches"]
        rows_ok = len(x["masks"]) == len(ref_masks) > 0 and all(
            torch.equal(m, full.cpu()[r * m.shape[0]:(r + 1) * m.shape[0]])
            for m, full in zip(x["masks"], ref_masks))
        if not rows_ok or x["launches"] != TRAIN_LAUNCHES["large"]:
            raise AssertionError(f"dist (c) rank {r}: masks are rows of the one-process draw: "
                                 f"{rows_ok}; launches {x['launches']}")
    differ = any(not torch.equal(m0, m1) for m0, m1 in zip(c[0]["masks"], c[1]["masks"]))
    loss = sum(x["loss"] for x in c) / DIST_WORLD
    loss_ref = ref["c"]["steps"][0]["loss"]
    log(f"dist (c) large bf16, drop_path {inp['c']['rate']}, 2 x {n} vs 1 x "
        f"{LARGE_TRAIN_BATCH}: {len(ref_masks)} masks, each process's its rows of the one-process "
        f"draw, the processes' masks differ: {differ}; loss {loss:.6f} vs {loss_ref:.6f} (bound "
        f"{DIST_BF16_LOSS_RTOL} relative)")
    if not differ or abs(loss - loss_ref) > DIST_BF16_LOSS_RTOL * abs(loss_ref):
        raise AssertionError(f"dist (c): masks differ {differ}, loss {loss} vs {loss_ref}")
    res["c_large_bf16_train"] = {"masks": len(ref_masks), "loss_2proc_mean": loss,
                                 "loss_1proc": loss_ref, "rank_losses": [x["loss"] for x in c]}

    # (d)
    with open(f"{FIXTURE}/golden_stats.json") as f:
        golden = json.load(f)["stats"]
    micro_pth(torch, os.path.join(DIST_DIR, "micro.pth"),
              cli.parser().parse_args(["--eval", "--coco_path", FIXTURE, *MICRO_FLAGS]))
    outs = dist_launch("--dist-eval", free_port())
    evals = []
    for r in range(DIST_WORLD):
        with open(os.path.join(DIST_DIR, f"eval_rank{r}.json")) as f:
            evals.append(json.load(f))
        launches[f"dist_eval_cli_rank{r}"] = evals[r]["launches"]
        if (evals[r]["launches"] != DIST_EVAL_LAUNCHES or not evals[r]["device"].startswith("cuda")
                or evals[r]["backend"] != "gloo"):
            raise AssertionError(f"dist (d) rank {r}: {evals[r]}")
    printed = [[ln for ln in out.splitlines() if ln.startswith("{")] for out in outs]
    stats = json.loads(printed[0][-1]) if printed[0] else {}
    off = {k: abs(stats.get(k, float("nan")) - v) for k, v in golden.items()}
    with open(os.path.join(DIST_DIR, "eval", "log.txt")) as f:
        records = f.read().splitlines()
    log(f"dist (d) eval CLI, 2 processes x 10 images: the 12 stats minus the golden, largest "
        f"{max(off.values()):.3g}; rank 1 printed {len(printed[1])} lines of stats; log.txt "
        f"{len(records)} record(s)")
    if (not all(d <= GOLDEN_ATOL for d in off.values()) or printed[1] or len(records) != 1
            or any(evals[r]["stats"][k] != stats[k] for r in range(DIST_WORLD) for k in golden)):
        raise AssertionError(f"dist (d): stats {stats} vs golden {golden}; rank 1 printed "
                             f"{printed[1]}; {len(records)} log records")
    res["d_eval_cli"] = {"stats": {k: stats[k] for k in golden}, "max_abs_minus_golden":
                         max(off.values())}
    res["wall_s"] = time.perf_counter() - t0
    # context only: two processes share one card through gloo, which no user runs
    res["context_wall_ms_a_step"] = {
        key: {"one_process": ref[key]["wall_ms_a_step"],
              "two_processes": [r[key]["wall_ms_a_step"] for r in ranks]} for key in ("a", "c")}
    print(f"dist phase: 2 processes on one card over gloo, (a)-(d) held, {res['wall_s']:.1f} s; "
          f"first-step wall ms, context only (processes sharing a card measure nothing a user "
          f"runs): {json.dumps(res['context_wall_ms_a_step'])} ({card})")
    return launches, res


# the train step and the batch-1 eval forward as CUDA graphs (`chain_phase`):
# (path, preset, dtype, batch, force_branch). Large's release drop_path (0.1)
# draws masks; the others draw none. Every path's state takes CHAIN_NITER steps
# an epoch with lr_drop 1, so the lr drops (x 0.1) before the third step.
CHAIN_PATHS = (("chain_small_f32", "small", "float32", 4, None),
               ("chain_large_bf16", "large", "bfloat16", LARGE_TRAIN_BATCH, None),
               ("chain_tiny_cm", "tiny", "float32", 4, "cm"),
               ("chain_tiny_gather", "tiny", "float32", 4, "gather"))
CHAIN_LAUNCHES = {"chain_small_f32": TRAIN_LAUNCHES["small"],
                  "chain_large_bf16": TRAIN_LAUNCHES["large"],
                  "chain_tiny_cm": TRAIN_LAUNCHES["tiny/cm"],
                  "chain_tiny_gather": TRAIN_LAUNCHES["tiny/gather"]}
CHAIN_STEPS = 4
CHAIN_NITER = 2
CHAIN_SEED = 7  # the mask generator's
# after the first step the chain and the eager steps part as two runs of one
# eager step do: K5, K8 and K10b sum d(value) in run-dependent order, so the
# parameters differ by rounding after one step; that moves sampling points
# across grid lines and flips ReLU units (trap (c)), each flip moving a gradient
# tensor by up to 1e-2 of its largest element, and in bf16 it flips the
# forward's roundings. So the later losses, the first grad_norm and what the
# steps changed in the parameters, AdamW moments and EMA (relative L2 by kind,
# not tensor by tensor: Adam divides each gradient element by its own scale)
# are held to their floor (the train CLI's resumed-run loss bound; the train
# phase's whole-step gradient bound TRAIN_GRAD_L2) or CHAIN_NOISE_FACTOR times
# a second eager run's difference from the first, whichever is larger. In bf16
# both runs' updates part by ~0.19 of their L2 (two eager runs as much), and a
# loss formed from bf16 outputs on such parameters moved 3.7e-4 to 8.3e-3 in
# three runs on an NVIDIA H100 80GB HBM3 at 700 W: its floor is four bf16 ulps, 2^-6
CHAIN_LOSS_RTOL = {"float32": 1e-3, "bfloat16": 2.0 ** -6}
CHAIN_STATE_L2 = TRAIN_GRAD_L2
CHAIN_NOISE_FACTOR = 2.0
CHAIN_TIMED = ("chain_small_f32", "chain_large_bf16")
CHAIN_TIMING = dict(steps=5, turns=2)
EVAL_GRAPH_PRESETS = ("tiny", "small", "medium", "large", "xlarge")


class RecordedMasks:
    """A `drop.Bernoulli` that keeps every mask it hands out (in a graph, the
    tensors each replay rewrites)."""

    def __init__(self, torch, drop, seed):
        self.generator = torch.Generator(device="cuda").manual_seed(seed)
        self.source, self.masks = drop.Bernoulli(self.generator), []

    def __call__(self, keep, shape, like):
        self.masks.append(self.source(keep, shape, like))
        return self.masks[-1]


def profiled_launches(torch, fn):
    """(fn(), {kernel group: launches}) of the port's kernels (K*, M1) as
    `torch.profiler` reads them off the device, grouped by `breakdown.GROUPS`,
    in the second of two calls: a profiler's first cycle can miss the launches
    at its start (seen on the card: one K1 of a step's six), so the first call
    is its warm-up."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from lwdetr_tpu_torch import breakdown

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()  # the warm-up cycle ends: only the next call is recorded
        out = fn()
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith(breakdown.ANNOTATIONS)):
            group = breakdown._group(evt.key)
            if group.startswith(("K", "M1")):
                counts[group] = counts.get(group, 0) + evt.count
    return out, counts


def chain_state(torch, state):
    """{kind:name: tensor} of a train state: parameters, AdamW moments, EMA."""
    out = {f"param:{n}": p.detach() for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            if k in state.optimizer.state.get(p, {}):
                out[f"{k}:{n}"] = state.optimizer.state[p][k]
    out.update({f"ema:{k}": v for k, v in (state.ema or {}).items() if v.is_floating_point()})
    return out


class Recorded:
    """A function whose every result is kept (in a graph, the tensors each
    replay rewrites)."""

    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self, *args, **kwargs):
        self.out.append(self.fn(*args, **kwargs))
        return self.out[-1]


def chain_train_path(torch, kernels, card, path, preset, dtype, batch, branch):
    """`chain_check` of `preset`'s release step at 640x640 (`bench_train`'s
    recipe) in `dtype`, `batch`, `branch`, with CHAIN_NITER steps an epoch
    and lr_drop 1; checks the launches of building the chain (the warm-up
    steps and the capture) against CHAIN_LAUNCHES. Returns (launches, numbers)."""
    from lwdetr_tpu_torch import bench_train

    dt = getattr(torch, dtype)

    def setup():
        return bench_train.make_train_setup(preset, batch, seed=0, dtype=dt, force_branch=branch,
                                            niter_per_ep=CHAIN_NITER, lr_drop=1)

    launches, res = chain_check(torch, kernels, card, path, setup, path in CHAIN_TIMED)
    if path == "chain_large_bf16" and res["masks_per_step"] == 0:
        raise AssertionError(f"{path}: drop_path 0.1 drew no mask")
    warm = bench_train.CHAIN_WARMUP + 1  # the warm-up steps and the capture
    expect = {k: warm * n for k, n in CHAIN_LAUNCHES[path].items()}
    if launches != expect:
        raise AssertionError(f"{path}: launches while building the chain {launches} != {expect}")
    return launches, dict(res, batch=batch, dtype=dtype, force_branch=branch)


def chain_state_l2(torch, a, b, start):
    """{kind: relative L2 error} of what the steps changed, state `a` against
    state `b` (both `chain_state`s), over all tensors of a kind; `start` is
    the state before the steps (the moments start at 0)."""
    l2 = {}
    for k, v in b.items():
        kind = k.split(":")[0]
        moved = v.double() - start[k].double() if k in start else v.double()
        num, den = l2.get(kind, (0.0, 0.0))
        l2[kind] = (num + (a[k].double() - v.double()).square().sum().item(),
                    den + moved.square().sum().item())
    return {kind: (num / den) ** 0.5 for kind, (num, den) in l2.items()}


def chain_check(torch, kernels, card, path, setup, timed=False):
    """A train step's CUDA graph against eager steps: CHAIN_STEPS replays of
    `build_train_chain` on one `setup()` (`bench_train.make_train_setup`'s
    namespace) against CHAIN_STEPS eager steps (`build_train_step`, the
    usual AdamW and LambdaLR) on a second `setup()`, and those against a
    third, eager again (the noise reference: two runs of one eager step part
    where K5, K8 and K10b sum in run-dependent order); masks from generators
    seeded alike; the eager steps replay each replay's proposal picks and
    matching (trap (d): a near tie flips under another rounding and reseeds
    whole queries). The first step's loss bit-equal; its grad_norm, later
    losses and what the steps changed in the state (`chain_state_l2`) within
    their floor (CHAIN_LOSS_RTOL, CHAIN_STATE_L2) or CHAIN_NOISE_FACTOR times
    the eager pair's difference, whichever is larger; every lr equal to the
    eager schedule's in float32 (across the drop, which `setup` must put
    before the third step); the masks equal step by step and new at each
    replay; the port's kernels' launches of one replay equal to an eager
    step's (profiler); with `timed`, eager and chain step times in turns.
    Returns (launches while building the chain, numbers)."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import drop
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.train.engine import build_train_step

    torch.cuda.empty_cache()
    chained = setup()
    start = {k: v.clone() for k, v in chain_state(torch, chained.state).items()}
    rates = bench_train.rates_at(chained, 0)
    warm = bench_train.CHAIN_WARMUP + 1  # the warm-up steps and the capture
    src_c = RecordedMasks(torch, drop, CHAIN_SEED)
    picks, match = Recorded(tr.select_proposals), Recorded(cm.hungarian_match)
    with mock.patch.object(tr, "select_proposals", picks), \
            mock.patch.object(cm, "hungarian_match", match):
        chain, launches = counted(torch, kernels, lambda: bench_train.make_train_chain(
            chained, mask_source=src_c))
    per = {k: len(v) // warm for k, v in (("masks", src_c.masks), ("picks", picks.out),
                                         ("match", match.out))}
    captured = {k: v[len(v) - per[k]:] for k, v in (("masks", src_c.masks), ("picks", picks.out),
                                                    ("match", match.out))}
    runs = {"chain": []}
    fed = []
    for i in range(CHAIN_STEPS):
        lrs = chained.state.scheduler.lrs.cpu()
        m = chain(1)
        runs["chain"].append((m["loss"].item(), m["grad_norm"].item(), lrs,
                              [x.clone() for x in captured["masks"]]))
        fed.append({k: [x.clone() for x in captured[k]] for k in ("picks", "match")})

    def eager_run(name):
        """CHAIN_STEPS eager steps on a fresh `setup()`, replaying `fed`; (state, step)."""
        st = setup()
        src = RecordedMasks(torch, drop, CHAIN_SEED)
        train_step = build_train_step(st.state, st.criterion, st.tcfg, **st.static)
        runs[name] = []
        for i in range(CHAIN_STEPS):
            lrs = torch.tensor([float(g["lr"]) for g in st.state.optimizer.param_groups],
                               dtype=torch.float32)
            n0 = len(src.masks)
            given = {k: iter(v) for k, v in fed[i].items()}
            with mock.patch.object(tr, "select_proposals", lambda s, k: next(given["picks"])), \
                    mock.patch.object(cm, "hungarian_match",
                                      lambda *a, **kw: next(given["match"])):
                m = train_step(st.data, *rates, mask_source=src)
            runs[name].append((m["loss"].item(), m["grad_norm"].item(), lrs,
                               [x.clone() for x in src.masks[n0:]]))
        return st, lambda: train_step(st.data, *rates, mask_source=src)

    eager, eager_step = eager_run("eager")
    se, sc = chain_state(torch, eager.state), chain_state(torch, chained.state)
    again, _ = eager_run("again")
    sa = chain_state(torch, again.state)
    del again
    if set(se) != set(sc) or set(se) != set(sa):
        raise AssertionError(f"{path}: chain and eager states hold different tensors")

    def diffs(other):
        """(first grad_norm, later losses) relative to the eager run's."""
        pairs = list(zip(runs["eager"], runs[other]))
        return (abs(pairs[0][1][1] - pairs[0][0][1]) / pairs[0][0][1],
                [abs(o[0] - e[0]) / abs(e[0]) for e, o in pairs[1:]])

    (norm_rel, rel_losses), (norm_noise, loss_noise) = diffs("chain"), diffs("again")
    loss_c, loss_e = runs["chain"][0][0], runs["eager"][0][0]
    lr_equal = all(torch.equal(e[2], c[2]) for e, c in zip(runs["eager"], runs["chain"]))
    lr_dropped = bool((runs["eager"][2][2] < runs["eager"][0][2]).all())
    n_masks = per["masks"]
    masks_equal = all(len(e[3]) == len(c[3]) == n_masks
                      and all(torch.equal(a, b) for a, b in zip(e[3], c[3]))
                      for e, c in zip(runs["eager"], runs["chain"]))
    masks_new = n_masks == 0 or all(
        any(not torch.equal(a, b) for a, b in zip(runs["chain"][i][3], runs["chain"][i + 1][3]))
        for i in range(CHAIN_STEPS - 1))
    l2, l2_noise = chain_state_l2(torch, sc, se, start), chain_state_l2(torch, sa, se, start)
    # the port's kernels' launches of one more replay and one more eager step (profiler)
    _, launches_c = profiled_launches(torch, lambda: chain(1))
    _, launches_e = profiled_launches(torch, eager_step)
    dtype = str(chained.state.model.compute_dtype).replace("torch.", "")
    loss_bound = max(CHAIN_LOSS_RTOL[dtype], CHAIN_NOISE_FACTOR * max([norm_noise] + loss_noise))
    l2_bound = {k: max(CHAIN_STATE_L2, CHAIN_NOISE_FACTOR * v) for k, v in l2_noise.items()}
    log(f"{path}: first step loss {loss_c!r} vs eager {loss_e!r}; chain / second eager run "
        f"against eager: first grad_norm rel {norm_rel:.3g} / {norm_noise:.3g}, later losses rel "
        f"{rel_losses} / {loss_noise} (bound {loss_bound:.3g}); lrs equal {lr_equal} (dropped "
        f"{lr_dropped}); a step: {n_masks} masks (equal {masks_equal}, new each replay "
        f"{masks_new}), {per['picks']} picks, {per['match']} matchings replayed; launches a "
        f"step: eager {launches_e}, replay {launches_c}; after {CHAIN_STEPS} steps, the changes' "
        f"relative L2 error by kind {l2} / {l2_noise}")
    if (loss_c != loss_e or max([norm_rel] + rel_losses) > loss_bound or not lr_equal
            or not lr_dropped or not masks_equal or not masks_new or launches_c != launches_e
            or not launches_e or any(l2[k] > l2_bound[k] for k in l2) or per["match"] != 1):
        raise AssertionError(f"{path}: the chain disagrees with the eager steps")
    res = {"launches": launches,
           "launches_per_replay_profiled": launches_c, "launches_per_eager_step_profiled":
           launches_e, "first_loss": loss_c, "first_grad_norm_rel_err": norm_rel,
           "later_loss_rel_err": rel_losses, "eager_pair_loss_rel_err": loss_noise,
           "masks_per_step": n_masks, "state_change_rel_l2_by_kind": l2,
           "eager_pair_state_change_rel_l2_by_kind": l2_noise, "card": card}
    if timed:
        ms = {"eager": [], "chain": []}
        for _ in range(CHAIN_TIMING["turns"]):
            ms["eager"] += measure_eager(torch, eager_step, CHAIN_TIMING["steps"])
            ms["chain"] += bench_train.chain_ms(chain, CHAIN_TIMING["steps"], 1)
        med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
        res.update(eager_step_ms=med["eager"], chain_step_ms=med["chain"],
                   eager_step_ms_samples=ms["eager"], chain_step_ms_samples=ms["chain"],
                   host_share=1.0 - med["chain"] / med["eager"])
        print(f"{path}: eager {med['eager']:.3f} ms a step, chain {med['chain']:.3f} ms a step, "
              f"host share {res['host_share']:.3f} ({card})")
    del eager, chained, chain
    torch.cuda.empty_cache()
    return launches, res


def measure_eager(torch, step, steps):
    """One window of `steps` eager steps between CUDA events: [ms a step]."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    end.record()
    end.synchronize()
    return [start.elapsed_time(end) / steps]


def chain_eval_graphs(torch, card):
    """Each preset's bf16 batch-1 forward + `post_process` as a guarded CUDA
    graph: scores, labels and boxes bit-equal to the eager forward's,
    `bs1_device_ms` beside `bs1_ms` and the reference's T4 TensorRT latency;
    small's graph refuses a replay after a weight changed in place."""
    from lwdetr_tpu_torch import bench_all

    out = {}
    for preset in EVAL_GRAPH_PRESETS:
        torch.cuda.empty_cache()
        model, forward = bench_all.make_forward(preset, torch.bfloat16)
        img1 = bench_all.synthetic_images(1, torch.bfloat16, "cuda")
        with torch.no_grad():
            ref = [t.clone() for t in forward(img1)]
            t_bs1 = bench_all.measure_ms(forward, img1, iters=10, warmup=3, repeats=5)
        graph = bench_all.batch1_graph(model, forward, img1)
        got = graph.replay()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        samples = sorted(bench_all.graph_ms(graph))
        dev = samples[len(samples) // 2]
        refused = None
        if preset == "small":
            with torch.no_grad():
                model.class_embed.weight.mul_(1.0)  # a write in place: _version moves
            try:
                graph.replay()
                refused = False
            except RuntimeError:
                refused = True
        out[preset] = {"bitequal": equal, "bs1_ms": t_bs1["ms"], "bs1_device_ms": dev,
                       "bs1_device_ms_spread": [samples[0], samples[-1]],
                       "bs1_dispatch_overhead_ms": t_bs1["ms"] - dev,
                       "ref_trt_fp16_ms_bs1": bench_all.BASELINE_TRT_MS[preset],
                       "guard_refused": refused}
        print(f"{preset}@640 bf16 batch 1: graph bit-equal {equal}; bs1_ms {t_bs1['ms']:.3f}, "
              f"bs1_device_ms {dev:.3f} (T4 TensorRT fp16 in the reference's README: "
              f"{bench_all.BASELINE_TRT_MS[preset]}; {card})")
        if not equal or refused is False:
            raise AssertionError(f"{preset}: batch-1 graph: bit-equal {equal}, guard {refused}")
        del model, forward, graph
    return out


TRACE_PATH = "build/chip_smoke/breakdown_trace.json"
# the stages (unattributed included) against the busy time: two readings of one
# trace, the kernels by the CPU operation that launched them and the device's
# own events; they have parted by 0.18% (small's eval at batch 32, 5 steps on an
# NVIDIA H100 80GB HBM3), a few kernels counted twice or in neither (not found)
STAGE_SUM_RTOL = 1e-2


def chain_tools(torch, card, small_chain_ms):
    """`train_flop_report` of small at batch 4 with the chain's step ms, and
    one `breakdown --trace` of small's eval at batch 4: the trace file parses
    and the stages sum to the busy time."""
    import os

    from lwdetr_tpu_torch import breakdown, train_flop_report

    torch.cuda.empty_cache()
    flops = train_flop_report.report("small", 4, step_ms=small_chain_ms)
    log(f"small@640 train step, batch 4: {flops['total'] / 1e9:.3f} GFLOP "
        f"({ {k: v / 1e9 for k, v in flops['flops_by_class'].items()} }), forward "
        f"{flops['forward_total'] / 1e9:.3f}; at the chain's {small_chain_ms:.3f} ms a step "
        f"{flops['tflops_per_s']:.2f} TFLOP/s ({card})")
    stage_sum = sum(sum(v.values()) for v in flops["flops_by_stage"].values())
    if stage_sum != flops["total"] or not flops["flops_by_class"].get("attention"):
        raise AssertionError(f"train FLOPs: stages {stage_sum} != total {flops['total']}")
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    torch.cuda.empty_cache()
    bd = breakdown.run("small", batch=4, dtype=torch.bfloat16, steps=2, trace=TRACE_PATH)
    with open(TRACE_PATH) as f:
        events = len(json.load(f)["traceEvents"])
    busy, staged = bd["device_busy_ms_per_step"], bd["stages_sum_ms_per_step"]
    log(f"breakdown --trace: {events} trace events in {os.path.getsize(TRACE_PATH)} bytes; stages "
        f"{bd['stages_ms_per_step']} sum {staged:.4f} ms against busy {busy:.4f} ms")
    if abs(staged - busy) > STAGE_SUM_RTOL * busy or events == 0:
        raise AssertionError(f"breakdown stages sum to {staged} ms, busy {busy} ms")
    os.remove(TRACE_PATH)
    return {"train_flops": {k: flops[k] for k in ("total", "forward_total", "flops_by_class",
                                                  "flops_by_stage", "tflops_per_s", "step_ms")},
            "breakdown_stages_ms": bd["stages_ms_per_step"], "breakdown_busy_ms": busy,
            "trace_events": events}


def chain_phase(torch, kernels, card):
    """The train chains of CHAIN_PATHS against eager steps, the five batch-1
    eval graphs, the train FLOP report and a breakdown trace. Returns
    ({path: launches}, numbers)."""
    launches, res = {}, {}
    for path, preset, dtype, batch, branch in CHAIN_PATHS:
        launches[path], res[path] = chain_train_path(torch, kernels, card, path, preset, dtype,
                                                     batch, branch)
    res["eval_graphs"] = chain_eval_graphs(torch, card)
    res["tools"] = chain_tools(torch, card, res["chain_small_f32"]["chain_step_ms"])
    return launches, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 1
    import torch.nn.functional as F

    from lwdetr_tpu_torch import bench
    from lwdetr_tpu_torch.ops import deform_attn as da
    from lwdetr_tpu_torch.ops import flash_attention as fa
    from lwdetr_tpu_torch.utils.device import card_line
    from lwdetr_tpu_torch.utils.timing import measure_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32, so that the
    torch.backends.cudnn.allow_tf32 = False  # projector convs hide no kernel error
    kernels = port_kernels()

    build_kernels()
    res = kernel_phase(torch, F, fa, da, measure_ms)
    launches, fwd, thr, train = {}, {}, {}, {}
    for preset in EXPECTED_LAUNCHES:
        launches[preset], fwd[preset] = forward_phase(torch, fa, da, list(kernels.values()), preset)
    for preset in TRAIN_BRANCHES:
        by_path, train[preset] = train_phase(torch, fa, da, list(kernels.values()), measure_ms,
                                             card_line(), preset)
        launches.update({f"{path}_train": n for path, n in by_path.items()})
    release = {}
    for path, preset, dtype, remat in LARGE_TRAIN_PATHS:
        launches[path], release[path] = release_train_phase(
            torch, fa, da, list(kernels.values()), measure_ms, card_line(), path, preset, dtype,
            remat)
    # remat's peak memory against the same step without it
    peaks = [release[p]["peak_memory_mb_first_step"]
             for p in ("xlarge_train_f32", "xlarge_train_f32_remat")]
    release["xlarge_f32_remat_peak_memory_share"] = peaks[1] / peaks[0]
    print(f"xlarge@640 f32 train step, batch {LARGE_TRAIN_BATCH}, peak device memory: "
          f"{peaks[0]:.1f} MiB, with remat {peaks[1]:.1f} MiB ({card_line()})")
    by_path, eval_pipeline = eval_pipeline_phase(torch, fa, da, list(kernels.values()), card_line())
    launches.update(by_path)
    by_path, train_cli = train_cli_phase(torch, list(kernels.values()), card_line())
    launches.update(by_path)
    by_path, padded = padded_phase(torch, F, fa, da, list(kernels.values()), measure_ms,
                                   card_line(), res)
    launches.update(by_path)
    by_path, variants = variants_phase(torch, F, fa, da, list(kernels.values()), measure_ms,
                                       card_line(), res)
    launches.update(by_path)
    by_path, orbax = orbax_phase(torch, F, fa, da, list(kernels.values()), measure_ms,
                                 card_line(), res)
    launches.update(by_path)
    by_path, deploy = deploy_phase(torch, fa, da, list(kernels.values()), card_line())
    launches.update(by_path)
    by_path, startup_bench = startup_bench_phase(torch, list(kernels.values()), card_line())
    launches.update(by_path)
    by_path, dist = dist_phase(torch, list(kernels.values()), card_line())
    launches.update(by_path)
    by_path, chain = chain_phase(torch, list(kernels.values()), card_line())
    launches.update(by_path)
    for preset in EXPECTED_LAUNCHES:
        thr[preset] = bench.run(preset, batch=32)
        log(f"{preset}@640 bf16 throughput: {thr[preset]['value']} img/s at batch 32 "
            f"({thr[preset]['ms_per_batch']} ms)")

    def both(key):
        return {"bfloat16": res[(key, "bfloat16")], "float32": res[(key, "float32")]}

    # each kernel's headline numbers are bf16 at the first path that runs it
    # (small's eval for K1-K3, large's for K4, small's train step for K5-K7,
    # tiny's eval for K9, tiny's train step for K7nb and, in the "cm" and
    # "gather" branches, for K8 and K10 / K10b); its other shapes and f32 stand
    # beside them
    headline_path = {"K4": "large", "K5": "small_train", "K6": "small_train", "K7": "small_train",
                     "K7nb": "tiny_train", "K8": "tiny/cm_train", "K9": "tiny",
                     "K10": "tiny/gather_train", "K10b": "tiny/gather_train"}
    entries = []
    for name in kernels:
        if name == "M1":
            entries.append(m1_entry(res, launches))
            continue
        path = headline_path.get(name, "small")
        if launches[path][name] < 1:
            raise AssertionError(f"{name} was not launched on its path {path}")
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[path][name], "path": path,
                 "launches_by_path": {p: launches[p][name] for p in launches},
                 "dtype": "bfloat16", **res[(name, "bfloat16")], "f32": res[(name, "float32")],
                 "tolerance": (ATTENTION_BF16_TOL if name in ("K1", "K2", "K9") else
                               ATTENTION_BWD_BF16_TOL if name in ("K6", "K7", "K7nb") else
                               SAMPLER_BF16_TOL if name in ROUNDED_AS_JAX + ("K5", "K8") else
                               f"|kernel - plain f32| <= {ATOL}{BWD_TOL.get(name, '')} + "
                               f"{RTOL['bfloat16']} x |plain| (f32: {ATOL}{BWD_TOL.get(name, '')})")}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name in ("K2", "K6"):
            entry["decoder_shape"] = both(name + "dec")
        others = {key.split("@")[1] + ("_decoder" if "dec" in key else ""): both(key)
                  for key, kname, *_ in (ATTENTION_SHAPES + ATTENTION_BWD_SHAPES
                                         + CLI_ATTENTION_SHAPES + CLI_ATTENTION_BWD_SHAPES
                                         + PADDED_ATTENTION_SHAPES
                                         + PADDED_ATTENTION_BWD_SHAPES
                                         + F7_ATTENTION_SHAPES + F7_ATTENTION_BWD_SHAPES)
                  if kname == name and "@" in key}
        if name == "K3":
            others.update(tiny=both("K3@tiny"), micro=both("K3@micro"),
                          tiny_cm_train=both("K3@tiny_train"),
                          large=both("K3@large"))
        if name in ("K3", "K8"):
            others.update({k: both(f"{name}@{k}") for k, _ in CM_CHECKS})
        if name in ("K4", "K5"):
            others.update({k: both(f"{name}@{k}") for k, _ in CLI_SEP_SHAPES + PADDED_SEP_SHAPES})
        if name == "K4":
            others.update(small_train=both("K4@train"), tiny_train=both("K4@tiny_train"),
                          large_train=both("K4@large_train"))
        if name in ("K4", "K10"):
            others.update({k: both(f"{name}@{k}") for k, _ in SEP_CHECKS})
        if name == "K5":
            others.update(large_batch8=both("K5@large"), tiny_train=both("K5@tiny_train"),
                          large_train=both("K5@large_train"))
        if name in ("K5", "K10b"):
            others.update({k: both(f"{name}@{k}") for k, _ in SEP_BWD_CHECKS})
        if name == "K8":
            others.update(small_train=both("K8@small"), large_train=both("K8@large"))
        if name == "K10":
            others["tiny_eval"] = both("K10@eval")
        if others:
            entry["other_shapes"] = others
        checked = {key.split("@")[1]: both(key) for key, kname, *_ in (
            PADDED_DRAWN_ATTENTION + PADDED_DRAWN_ATTENTION_BWD + VARIANT_CLI_DRAWN_ATTENTION
            + VARIANT_CLI_DRAWN_ATTENTION_BWD + F7_UNTIMED) if kname == name}
        checked.update({key.split("@")[1].replace("variant_cli", "orbax_cli"):
                        both(key.replace("variant_cli", "orbax_cli"))
                        for key, kname, *_ in (VARIANT_CLI_DRAWN_ATTENTION
                                               + VARIANT_CLI_DRAWN_ATTENTION_BWD)
                        if kname == name})
        checked.update({key.split("@")[1]: both(key) for key, _ in (
            PADDED_DRAWN_SEP + PADDED_DRAWN_SEP_BWD) if key.split("@")[0] == name})
        if name in ("K4", "K5"):
            checked.update({key: both(f"{name}@{key}")
                            for key, _ in VARIANT_CLI_DRAWN_SEP + ORBAX_CLI_DRAWN_SEP})
        if checked:  # the padded and variant CLI paths' drawn sizes, checked untimed
            entry["checked_shapes"] = checked
        entries.append(entry)
    for entry in entries:  # the kernels line's contract: a shape's numbers must not shadow it
        if entry["route"] not in ("cuda", "triton") or any(k not in entry for k in CONTRACT_KEYS):
            raise AssertionError(f"{entry['name']}: kernels-line entry breaks its contract")
    print(json.dumps({"forward_f32": fwd, "throughput": thr, "train_f32": train,
                      "release_train": release, "eval_pipeline": eval_pipeline,
                      "train_cli": train_cli, "padded": padded, "variants": variants,
                      "deploy": deploy, "startup_bench": startup_bench, "dist": dist,
                      "orbax": orbax, "chain": chain}))
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # `dist_phase` runs this script as its processes: --dist-child DIR, --dist-eval DIR
    CHILDREN = {"--dist-child": dist_child, "--dist-eval": dist_eval_child}
    if len(sys.argv) == 3 and sys.argv[1] in CHILDREN:
        sys.exit(CHILDREN[sys.argv[1]](sys.argv[2]))
    sys.exit(main())
