#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root, on a machine with a card and nvcc. Each phase
prints one JSON line, and the first failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of every CUDA kernel from its source (one
   nvcc each, all at once) with ptxas' registers, shared memory and spills.
2. kernel: on bf16 inputs from a numpy seed at B=12, H=12, D=64,
   - K1-fwd (`fused_attention_qkv`, no stats) at N = 1568 (student), 1569
     (teacher), 1570 (the multi-task student: CLS, patches, scene token)
     and 77 (small, ragged), within PLAIN_TOL of the plain version in bf16
     and KERNEL_TOL of it in f32;
   - K1-fwd stats (`attention_qkv_fwd_stats`) at N = 1568, 1569, 1570 and
     77: o within KERNEL_TOL, m within STATS_M_TOL and l within
     STATS_L_TOL of the plain version in bf16 and in f32;
   - K1-bwd (`attention_qkv_bwd`, dO ~ N(0, 1), o, m, l from the stats
     kernel) at N = 1568, 1569, 1570 and 77: dq, dk, dv each within
     BWD_TOL of the plain version on the same inputs and of the f32
     gradient;
   and at N = 1568 and 1570 (and 1569 for K1-fwd) each kernel, its plain
   version and `scaled_dot_product_attention` (forward, or forward +
   backward; timed as a yardstick only, the port never calls it) timed
   with CUDA events. kernel_tp: the three forms of K1 at the
   tensor-parallel shape, 6 of the 12 heads at N = 1568 (o within
   KERNEL_TOL of the f32 plain version and PLAIN_TOL of the bf16 one, m, l
   and the backward within theirs), timed beside the plain versions and
   `scaled_dot_product_attention` at 6 heads.
   kernel_q_kv: K2-fwd (`fused_attention_q_kv`), K2-fwd stats and K2-bwd
   at (Nq, Nk) = (392, 1568) (four shards), (1568, 1568) (the one-card SP
   step) and (77, 301) (ragged), within K1's tolerances, timed at the
   first two. sp_compose: K2 on four 392-row query shards of a 1568-token
   qkv against its whole kv, concatenated (and the shards' dkv summed),
   against K1 and K1-bwd on that qkv. kernel_head_major: K3-fwd
   (`fused_attention`) and K3-bwd (`attention_head_major_bwd`) at N = 1568
   and 77, timed at 1568. kernel_slot_attention: K4
   (`fused_slot_attention`) at the flagship agg round (12 x 2 slots,
   D=768, 4 heads x 512) over N = 1568 and 301 keys, out and sim within
   PLAIN_TOL of the bf16 plain version and KERNEL_TOL of the f32 one, the
   Function's backward within BWD_TOL of autograd of the f32 plain
   version, timed at 1568 warm (ctx left in L2 by the launch before, as in
   the tied agg rounds) and cold (L2 flushed by a 64 MB write before each
   launch); no single PyTorch call computes K4.
   kernel_patch_embed: K5 (`patchify_embed`) at [12, 16, 224, 224, 3] and
   the ragged [2, 4, 48, 80, 3], within PLAIN_TOL and KERNEL_TOL, timed at
   the first with patchify + a bf16 matmul as the yardstick.
3. slice: the flagship SlotViT-B (ViT-B/16 on 16x224x224 clips, 8 tied
   agg rounds over 2 slots, 400+365 head, bf16, fused attention, patchify
   embed) and the CLS scene teacher, random weights from a seed, through
   `validation_one_epoch` and the scene-label `final_test` over 3 synthetic
   batches of 12 clips. The kernels' launch counts are zeroed just before
   and read just after; one batch then goes through the same weights with
   `fused_attention=False` and the two are held to SLICE_TOL.
4. throughput: both eval protocols again over THROUGHPUT_BATCHES batches
   (the 3 clip batches in turn), timed on the host clock as clips/s.
5. train: the flagship slot train step as `bench.py:87-115` builds it
   (that student and teacher, AdamW lr 5e-4 over 1000 steps with 10 of
   warmup, the KL slot loss, FAME with beta 0.5 and prob_aug 0.8) on 12
   synthetic clips: TRAIN_STEPS steps with the launch counts zeroed just
   before and read just after (12 K1-fwd in the teacher, 12 K1-fwd stats
   and 12 K1-bwd in the student per step), finite metrics, parameters
   changed; then TRAIN_WINDOW steps timed on the host clock, and
   PROFILE_STEPS more under `torch.profiler` (`train_profile`: device busy
   and idle share, device time by kernel class and the top kernels).
6. train_vs_plain: one micro-batch of 2 clips with fixed FAME draws
   through the same weights with fused and with plain attention; the loss
   and three parameters' gradients held to TRAIN_TOL.
7. sp_train: the same flagship step made with `sp_mesh=make_sp_mesh(1)`
   over a one-process NCCL group (`maybe_init_distributed`), initialised
   for this phase and destroyed after it: TRAIN_STEPS counted steps and one
   deterministic `seq_parallel_tokens` pass (12 teacher K1-fwd, 12 student
   K2-fwd stats and K2-bwd per step, 12 K2-fwd in the token pass, no other
   kernel), the tokens held to SLICE_TOL of the ordinary forward's;
   SP_TRAIN_WINDOW timed steps (sp_train_throughput), PROFILE_STEPS under
   `torch.profiler` (sp_train_profile); sp_vs_train, the SP
   and the ordinary step's loss on 2 clips with the same weights and FAME
   draws, held as train_vs_plain holds them.
8. cli: the port's entry point, `devias_tpu_torch.cli.run_slot_finetuning`,
   in-process at full width on synthetic 16x240x320 clips (after a line
   with the cv2 and PIL versions it reads them with): a 4-step epoch of 12
   samples drawn twice (`--num_sample 2`), a resume to the second epoch,
   then --eval --eval_scene --run_knn on the trained checkpoint with a
   scene teacher written from the port's seeded teacher. Each run's
   kernel counts are zeroed just before and read just after (K1 only: 84
   K1-fwd, 48 K1-fwd stats and 48 K1-bwd per train run, 432 K1-fwd in the
   evaluation); the loop's ms per step on the host clock (over the epoch,
   and over the steps after the first, whose batches were prefetched)
   beside the direct step's; then the README's `--smoke_tiny` command on
   the card (64 wide, 4 heads: head dim 16, so K1 stays off and no kernel
   launches). Fails on a missing result file, a non-finite metric or
   launch counts other than these.
9. dp_train: data parallelism with a data axis of two on the one card:
   two processes of this script (`--dp-rank`) join a gloo group (NCCL
   refuses two ranks on one device; gloo all-reduces CUDA tensors through
   the host) and run the flagship step made with `dp_mesh=make_mesh()`,
   each on its 6 of the 12 clips with its shard's fixed FAME draws: one
   compared step and DP_WINDOW timed ones, 12 K1-fwd, 12 K1-fwd stats and
   12 K1-bwd per step on each rank. Rank 0 then runs the one-process step
   with `num_data_shards=2` on all 12 clips from the same weights and
   draws; the loss, grad_norm and three parameters' reduced gradients and
   values after the step are held to it as train_vs_plain holds its
   numbers, and the ranks must agree bitwise. The ms per step printed is a
   two-process gloo run on one card, not a data-parallel throughput.
10. hat: the CLI in-process at full width with --hat_eval on synthetic
   Kinetics-HAT assets written with PIL (HAT_RECORDS records of
   HAT_FRAMES 240x320 frames, one version dir of three splits), once with
   action targets and once with --eval_scene, on the CLI's seeded student
   and scene teacher: every split's result files, finite accuracies, and
   12 K1-fwd per student batch (12 more per teacher batch in the scene
   run). The dp_train ranks also time `over_data_group`'s gather of the
   12-clip micro-batch (float32 and bfloat16), the cost FAME-HVU and mixup
   pay under data parallelism.
11. hvu_train: the HVU train step (`make_hvu_train_step`) on the HVU CLI's
   model (739 + 248 head, 4 latents, 4 untied agg layers, K1) with
   FAME-HVU at B=12: TRAIN_STEPS counted steps (12 K1-fwd stats and 12
   K1-bwd per step), HVU_WINDOW timed ones (ms/step, clips/s, peak
   memory), and hvu_vs_plain, the fused against the plain step on 2 clips
   as train_vs_plain holds the slot step.
12. hvu_cli: `run_slot_finetuning_hvu` in-process at full width on
   synthetic HVU filelists, a 2-step epoch with validation, then
   `eval_slot_finetuning_hvu` on a SEEN/UNSEEN pair with its checkpoint:
   the four blocks finite, K1 counts exact.
13. class_train: `make_classification_train_step` on
   `vit_base_patch16_224` as `run_class_finetuning` builds it, mixup /
   CutMix on, at 400 classes mean-pooled and at 365 with the CLS token
   (1569 tokens): counted and timed steps and class_vs_plain for each.
14. class_cli: `run_class_finetuning` for a 2-step epoch with `--opt sgd`,
   `--use_cls` and `--scene_labels_from` a teacher checkpoint the phase
   writes, then `--eval` on its checkpoint (the same top-1).
15. downstream_train: the classification step on `SlotFusionViT` as
   `run_slot_downstream` builds it for the Diving-48 recipe (48 classes, a
   400 + 365 selection head, concat with the MLP fusion head, 2 latents, 8
   tied agg rounds, label smoothing 0.1, AdamW with layer decay 0.75 and
   agg scale 0.8) at B=12: counted steps (12 K1-fwd stats and 12 K1-bwd
   each), timed ones, and downstream_vs_plain on 2 clips.
16. downstream_cli: `run_slot_downstream` with `--finetune` on a slot
   checkpoint the phase writes, a 2-step epoch, validation, the final
   test, then `--eval` on its checkpoint (the same top-1).
17. mt_train: `make_multi_task_train_step` on `MultiTaskViT` (1570 tokens)
   and its CLS teacher (1569) as `run_multi_task_finetuning` builds them,
   with separate heads under KL and with a unified head under CE: counted
   steps (12 K1-fwd, 12 K1-fwd stats, 12 K1-bwd each), timed ones, and
   mt_vs_plain on 2 clips.
18. mt_cli: `run_multi_task_finetuning --unified_head` with the teacher
   from `--scene_model_path`, a 2-step epoch, validation, the final test,
   then `--eval --eval_scene` on its checkpoint (the same top-1).
19. options_train: phase 5's step with checkpointed blocks (`remat`),
   drop-path 0.1 and FAME's exact top-k
   selection: counted steps (12 K1-fwd, 24 K1-fwd stats, the forward's and
   the recompute's, and 12 K1-bwd each), timed ones beside phase 5's, then
   the same without `remat` (12 K1-fwd stats each); options_vs_plain on 2
   clips; remat_vs_not, the checkpointed against
   the plain blocks on 2 clips with one generator seed (gradients within
   REMAT_TOL, the generator's final state equal).
20. fame_modes: `compute_fame_masks` at B=12 on structured 16x224x224
   clips in the threshold, exact top-k and 4x downsampled modes: ms each,
   and the card's masks against the CPU's (share of equal pixels).
21. attn_drop_train: the flagship step with attention dropout 0.1 (the
   student's layers take the plain attention with dropout, as in JAX):
   counted steps (12 teacher K1-fwd each, no K1 stats or backward), timed
   ones, peak memory; then its weights in eval (12 K1-fwd) against the
   same weights at attn_drop 0, bitwise.
22. int8_teacher: the CLS teacher's forward at B=12 in bf16 and with
   `int8_dense` (w8a8 through `torch._int_mm`): ms each, 12 K1-fwd each,
   the logits' cosine and argmax agreement, a profile of each; one
   `int8_dot` card vs CPU.
23. options_cli: `run_slot_finetuning --use_checkpoint --teacher_int8
   --drop_path 0.1`, a 2-step epoch, validation, the final test, then
   `--eval` on its checkpoint (K1: 12 K1-fwd, 24 stats and 12 bwd per step).

24. real_video_cli: mp4 files written with cv2 (12 train, 4 val, 4 test,
   64 frames of 240x320 each), then `run_slot_finetuning` on them at full
   width: one step of 24 clips, validation, the final test. It prints the
   reader (the C++ FFmpeg decode core where `pkg-config` resolves FFmpeg,
   else cv2) and whether the C++ augment core ran, counts the readers the
   pipeline opened and the calls that reached the core (K1: 36 K1-fwd, 12
   stats, 12 bwd).
25. loader_split: the CLI's host pipeline on those files, ms per sample by
   stage (decode, RandAugment with the augment core on and off, crop and
   normalize, random erasing, collate, the pinned copy), and the training
   loader's clips/s with the core on and off beside the direct step's.
26. segformer_train: the slot step with the Segformer mix in place of FAME
   (`segformer_apply`: the B3 geometry in bfloat16 on random weights, its
   person bias raised to cover about 30 % of the pixels): the mask model's
   ms, coverage and bf16-vs-f32 mask agreement, counted steps (12 K1-fwd,
   12 stats, 12 bwd each), timed ones, a profile, segformer_vs_plain.
27. segformer_cli: `run_slot_finetuning --mask_model Segformer
   --segformer_variant b0 --segformer_ckpt` an HF-layout .pth the phase
   writes, a 2-step epoch and `--eval`; then convert: that checkpoint
   through `convert_checkpoint to_reference` and `to_port`, bitwise, and
   `--eval` on the result with the same top-1.

28. parallel_modes: ZeRO-1, FSDP, TP and PP over two gloo ranks on the
   one card (`--parallel-rank` processes; PP's stage hand-offs through
   pinned host buffers), the flagship step at full width and depth on the
   12 clips: `--zero1` and `--fsdp` over two data rows of 6 clips, TP over
   one model group of two (K1 on 6 heads per rank), PP over two stages of 6
   blocks with 4 micro-batches of 3 clips. Each mode is held to the
   one-process step on the same weights and FAME draws as dp_train holds
   DP, the ranks bitwise equal on every parameter both hold whole; per mode
   and rank the K1 launches of a step by form and head count against
   `parallel_launches_per_step`, ms per step (a two-process gloo run on one
   card, not a throughput), peak memory, and the placed state's resident
   bytes against the replicated state's. Then `python -m
   devias_tpu_torch.dryrun`'s `dryrun_multichip(2)` on the card.
29. overfit: `devias_tpu_torch.scripts.full_scale_overfit.main` at its
   defaults (200 steps of the slot step with the CLS teacher memorising 12
   fixed clips; the JAX script's asserts): the loss at steps 0 and 199,
   the accuracy at 199, the first step at 1.0, ms per step, 12 launches of
   each K1 form per step.
30. health_run: `devias_tpu_torch.scripts.health_run.main` with
   `--steps 1000` (HEALTH_STEPS, half its default, for this script's time
   limit; at its defaults otherwise: HVU steps with FAME-HVU, the cosine
   schedule and EMA 0.999 on 60 synthetic clips held on the card; the action slot must read
   the motion and the scene slot the background at 0.85 or more): losses,
   steps/s, the probe's readings of the parameters and the EMA, the
   held-out pair, peak memory; 12 K1-fwd stats and 12 K1-bwd per step, 12
   K1-fwd per probe batch.
31. profile_step: `devias_tpu_torch.scripts.profile_step.main` (3 + 5
   steps of the flagship FAME step, 5 traced): the card's ms per step by
   kernel family from the exported trace. The family table and
   `profile_breakdown` of the other profile phases live in that module.
32. layerscale_train: phase 5's step with LayerScale (`init_values` 0.1)
   and a learned `pos_embed` on the student, AdamW with layer decay 0.75:
   counted steps (12 of each K1 form), timed ones, peak memory; then
   layerscale_vs_plain on 2 clips, the gammas' and `pos_embed`'s
   gradients finite and non-zero.
33. geometry_eval: a SlotViT-B of 32x32 patches (392 tokens), a 2x MLP, no
   q/v biases, logit scale 0.1 (applied to q before K1, which folds only a
   power of two) and eps 1e-5: 12 K1-fwd at N = 392, its logits against
   the plain attention's; block 0's `Attention(return_attn=True)` of the
   flagship student: no K1, `out` against K1's, rows of the
   probabilities summing to 1.
34. int8_student: the flagship student's forward in bf16 and with
   `int8_dense` (the w8a8 student): ms each, the logits' largest
   difference and cosine.
35. agg_options: an agg block of 8 heads x 96, a 2x feed-forward, both
   dropouts at 0.1, no final norm and 'sine1d' key positions on the
   student's tokens: training forward and backward, eval, the dropout
   keep share, and the eval output against the port's float32 CPU run.
36. yuv_wire: the CLI's loader on mp4 files with `wire_format='yuv420'`
   and RGB (clips/s, bytes per clip), the card's `i420_to_rgb` against
   cv2, one slot step on the I420 clips with `device_normalize`.
37. kill_resume: the CLI at full width for 3 epochs of 2 steps in
   processes of `tests/_torch_kill_resume_worker.py`, one SIGKILLed in
   epoch 2 and relaunched: train records and final checkpoint bitwise
   equal to an uninterrupted run's.

Then a `script` line with the script's own seconds, one
`{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
Exits non-zero, printing no result, without CUDA or without the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
BF16_PEAK = 989e12
FP32_PEAK = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# Published special-function rate of the H100 SXM (FlashAttention-3 paper,
# Shah et al. 2024): the ceiling on exponentials per second.
SFU_PER_S = 3.9e12

B, H, D = 12, 12, 64
SCALE = D ** -0.5
# K1 errors are held relative to the RMS of the f32 output. On N(0, 1)
# inputs each output is a softmax mean over N keys: RMS ~0.042 at
# N=1568/1569, ~0.18 at N=77. The kernel keeps logits and probabilities in
# f32 and rounds only exp(s - m) and the output to bf16: against the plain
# version evaluated in f32 it errs by ~0.024 RMS. KERNEL_TOL = 0.04 RMS
# (1.7e-3 at N=1568) leaves room for that and is below what a kernel that
# leaves the ragged keys of the last tile unmasked gives (0.07-0.1 RMS).
KERNEL_TOL = 0.04
# The plain version in bf16 rounds the logits and probabilities to bf16
# and itself errs by up to ~0.14 RMS against f32; the kernel is held to
# PLAIN_TOL of it, which catches a wrong tile, row or head (O(1) RMS).
PLAIN_TOL = 0.25
# K1 stats: m and l held relative to their RMS against the plain version
# in f32. m is a max of f32 logits (~1e-7 relative); l sums bf16-rounded
# exponentials, ~3e-4 (N=1568) to ~1e-3 (N=77) of its RMS in a CPU
# emulation, while zero-filled ragged keys left in the softmax move it by
# 0.04 (N=1568) to 0.9 (N=77).
STATS_M_TOL = 1e-4
STATS_L_TOL = 5e-3
# K1-bwd: each of dq, dk, dv held to BWD_TOL of its f32 RMS, against the
# plain version on the same bf16 inputs and against the f32 gradient. The
# kernel rounds t, e, q scale / l, dO / l and the outputs to bf16. The plain
# version, which rounds at the same places, reads up to 0.091 RMS against
# f32 at B=12, H=12 (its largest error over 144 heads; 0.06 at B=1, H=6 in
# the CPU emulation), the kernel 0.023-0.046 against the plain version. A
# kernel that leaves the ragged keys and rows of its last tiles unmasked
# reads 2.7-5.9 (`tests/test_torch_attention.py`).
BWD_TOL = 0.2
# Fused vs plain model, both bf16: per layer the two attentions differ by
# bf16 rounding (above), carried through 12 residual blocks and 8 agg
# rounds; held relative to the plain output's largest magnitude.
SLICE_TOL = 5e-2
# Fused vs plain train step on the same micro-batch, both bf16: the loss
# held to TRAIN_LOSS_TOL of its value, each watched gradient to TRAIN_TOL of
# the plain gradient's largest magnitude (bf16 attention rounding carried
# through 12 blocks forward and back).
TRAIN_LOSS_TOL = 2e-2
TRAIN_TOL = 0.1
TRAIN_WATCH = ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight", "agg_block.latents")
TRAIN_STEPS = 3
TRAIN_WINDOW = 20
PROFILE_STEPS = 2
N_BATCHES = 3
# ~4 s of validation and ~8 s of final_test at the rates measured so far
THROUGHPUT_BATCHES = 120
CLIPS = (B, 16, 224, 224, 3)
NUM_CLASSES, NUM_SCENE_CLASSES = 400, 365
SLOT_KW = dict(num_classes=NUM_CLASSES, num_scene_classes=NUM_SCENE_CLASSES, num_latents=2, agg_depth=8,
               agg_weights_tie=True, dtype=torch.bfloat16, patch_embed_mode="patchify")
TEACHER_KW = dict(num_classes=NUM_SCENE_CLASSES, use_mean_pooling=False, dtype=torch.bfloat16,
                  patch_embed_mode="patchify")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def grad_errors(got, want, exact):
    """Max abs error of each gradient in `got` against `want`, over the RMS
    of the same gradient in `exact` (three sequences of tensors)."""
    return [(g.float() - w.float()).abs().max().item() / e.float().square().mean().sqrt().item()
            for g, w, e in zip(got, want, exact)]


def bwd_errors(got, want, exact):
    """`grad_errors` of dq, dk and dv in K1's dqkv [B, N, 3*H*D]."""
    return grad_errors(got.chunk(3, -1), want.chunk(3, -1), exact.chunk(3, -1))


def q_kv_bwd_errors(got, want, exact):
    """`grad_errors` of dq, dk and dv in K2's (dq [B, Nq, H*D],
    dkv [B, Nk, 2*H*D])."""
    return grad_errors(*((dq, *dkv.chunk(2, -1)) for dq, dkv in (got, want, exact)))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in r["ptxas"].splitlines() if "Used" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "ptxas": ptxas})
    sass = {name: sass_counts(build.library_path(name)) for name in build.SOURCES}
    emit({"phase": "sass", "counts": sass})
    for name in ("attention_fwd", "attention_bwd", "patch_embed"):
        if not (sass[name]["HGMMA"] and sass[name]["UTMALDG"]):
            fail(f"{name} has no wgmma (HGMMA) or TMA load (UTMALDG) in its SASS: {sass[name]}")
    return card


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    for path in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if path and os.path.exists(path):
            return path
    import triton
    return os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")


def sass_counts(lib) -> dict:
    """Instructions of each name in SASS_OPS in a built library's SASS
    (`cuobjdump -sass`): wgmma (HGMMA), TMA loads (UTMALDG), mma.sync (HMMA)."""
    out = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib} exited {out.returncode}: {out.stderr.strip()[-400:]}")
    ops = [ln.split("*/", 1)[1].split() for ln in out.stdout.splitlines() if "*/" in ln and "/*" in ln]
    ops = [w[0] if not w[0].startswith("@") else (w[1] if len(w) > 1 else "") for w in ops if w]
    return {name: sum(op.split(".")[0] == name for op in ops) for name in SASS_OPS}


def _bound(flops: int, nbytes: int, peak: float = BF16_PEAK):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def attention_bound(N: int, stats: bool = False, heads: int = H):
    """Forward: 4BHN^2D operations; q/k/v read, o (and m, l) written once."""
    return _bound(4 * B * heads * N * N * D,
                  (B * N * 3 * heads * D + B * N * heads * D) * 2 + (2 * B * heads * N * 4 if stats else 0))


def attention_bwd_bound(N: int, heads: int = H):
    """Backward: five N x N x D products, 10BHN^2D operations; qkv, o, dO,
    m, l read once, dqkv written once."""
    return _bound(10 * B * heads * N * N * D,
                  (2 * B * N * 3 * heads * D + 2 * B * N * heads * D) * 2 + 2 * B * heads * N * 4)


def q_kv_bound(Nq: int, Nk: int, stats: bool = False):
    """K2 forward: 4BHNqNkD operations; q and kv read, o (and m, l) written once."""
    return _bound(4 * B * H * Nq * Nk * D,
                  (2 * B * Nq * H * D + 2 * B * Nk * H * D) * 2 + (2 * B * H * Nq * 4 if stats else 0))


def q_kv_bwd_bound(Nq: int, Nk: int):
    """K2 backward: 10BHNqNkD operations; q, kv, o, dO, m, l read once, dq
    and dkv written once."""
    return _bound(10 * B * H * Nq * Nk * D,
                  (4 * B * Nq * H * D + 4 * B * Nk * H * D) * 2 + 2 * B * H * Nq * 4)


def head_major_bound(N: int, bwd: bool = False):
    """K3: the forward's 4BHN^2D operations on q, k, v in and o out, or the
    backward's 10BHN^2D on q, k, v, o, dO in and dq, dk, dv out (the
    statistics it recomputes come from the S product counted there)."""
    if bwd:
        return _bound(10 * B * H * N * N * D, 8 * B * H * N * D * 2)
    return _bound(4 * B * H * N * N * D, 4 * B * H * N * D * 2)


def _rms(t) -> float:
    return t.float().square().mean().sqrt().item()


def _normal(shape, seed: int):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", torch.bfloat16)


def phase_kernel(attn):
    dev = torch.device("cuda")
    worst = 0.0
    timing = {}
    for N in (1568, 1569, 1570, 77):
        rng = np.random.default_rng(N)
        qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * D), dtype=np.float32)).to(dev, torch.bfloat16)
        out = attn.fused_attention_qkv(qkv, H, SCALE)
        torch.cuda.synchronize()
        plain = attn.attention_qkv_reference(qkv, H, SCALE)
        exact = attn.attention_qkv_reference(qkv.float(), H, SCALE)
        rms = exact.square().mean().sqrt().item()
        err = (out.float() - plain.float()).abs().max().item()
        err_f32 = (out.float() - exact).abs().max().item()
        plain_err_f32 = (plain.float() - exact).abs().max().item()
        row = {"phase": "kernel", "kernel": "K1-fwd", "N": N, "rms_f32": rms,
               "max_abs_err": err, "tol": PLAIN_TOL * rms,
               "max_abs_err_vs_f32": err_f32, "tol_vs_f32": KERNEL_TOL * rms,
               "plain_max_abs_err_vs_f32": plain_err_f32,
               "finite": bool(torch.isfinite(out).all().item())}
        if N in (1568, 1569, 1570):
            q, k, v = qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
            bound_ms, bound_by, flops, nbytes = attention_bound(N)
            row.update(
                ms=time_ms(lambda: attn.fused_attention_qkv(qkv, H, SCALE), 20),
                plain_ms=time_ms(lambda: attn.attention_qkv_reference(qkv, H, SCALE), 5),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE), 20),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                exp_bound_ms=B * H * N * N / SFU_PER_S * 1e3)
            row["tflops"] = flops / row["ms"] / 1e9
            timing[N] = row
        emit(row)
        if not row["finite"] or err > row["tol"] or err_f32 > row["tol_vs_f32"]:
            fail(f"K1 at N={N}: non-finite output, or max abs err {err} > {row['tol']} against the plain "
                 f"version or {err_f32} > {row['tol_vs_f32']} against it in f32")
        worst = max(worst, err)
        del qkv, out, plain, exact
    torch.cuda.empty_cache()
    return worst, timing


def _inputs(N: int, seed: int):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * D), dtype=np.float32)).to(dev, torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, N, H * D), dtype=np.float32)).to(dev, torch.bfloat16)
    return qkv, do


def phase_kernel_stats(attn):
    worst, timing = 0.0, {}
    for N in (1568, 1569, 1570, 77):
        qkv, _ = _inputs(N, 10 + N)
        o, m, l = attn.attention_qkv_fwd_stats(qkv, H, SCALE)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "kernel": "K1-fwd-stats", "N": N}
        ok = bool(torch.isfinite(o).all().item() and torch.isfinite(m).all().item() and torch.isfinite(l).all().item())
        # o against the bf16 plain version: KERNEL_TOL at 1568 and 77; at
        # 1569 and 1570 PLAIN_TOL, as K1-fwd's o and K2 stats' o are held,
        # since one bf16 ulp of an output above 0.25 (0.00195) is 0.047 of
        # the RMS there. Against f32, KERNEL_TOL at every N.
        o_tol = {"plain": KERNEL_TOL if N in (1568, 77) else PLAIN_TOL, "f32": KERNEL_TOL}
        for label, src in (("plain", qkv), ("f32", qkv.float())):
            po, pm, pl = attn.attention_qkv_fwd_stats_reference(src, H, SCALE)
            errs = {"o": (o.float() - po.float()).abs().max().item() / _rms(po),
                    "m": (m - pm).abs().max().item() / _rms(pm),
                    "l": (l - pl).abs().max().item() / _rms(pl)}
            row[f"err_rms_vs_{label}"] = errs
            ok &= errs["o"] <= o_tol[label] and errs["m"] <= STATS_M_TOL and errs["l"] <= STATS_L_TOL
            if label == "plain":
                row["max_abs_err"] = (o.float() - po.float()).abs().max().item()
                worst = max(worst, row["max_abs_err"])
            del po, pm, pl
        row["tol_rms"] = {"o_vs_plain": o_tol["plain"], "o_vs_f32": o_tol["f32"], "m": STATS_M_TOL, "l": STATS_L_TOL}
        if N in (1568, 1570):
            q, k, v = qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
            bound_ms, bound_by, flops, nbytes = attention_bound(N, stats=True)
            row.update(
                ms=time_ms(lambda: attn.attention_qkv_fwd_stats(qkv, H, SCALE), 20),
                plain_ms=time_ms(lambda: attn.attention_qkv_fwd_stats_reference(qkv, H, SCALE), 5),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE), 20),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            row["tflops"] = flops / row["ms"] / 1e9
            timing[N] = row
        emit(row)
        if not ok:
            fail(f"K1-fwd stats at N={N} beyond its limits: {row}")
        del qkv, o, m, l
    torch.cuda.empty_cache()
    return worst, timing


def phase_kernel_bwd(attn):
    worst, timing = 0.0, {}
    for N in (1568, 1569, 1570, 77):
        qkv, do = _inputs(N, 20 + N)
        o, m, l = attn.attention_qkv_fwd_stats(qkv, H, SCALE)
        got = attn.attention_qkv_bwd(qkv, o, do, m, l, H, SCALE)
        torch.cuda.synchronize()
        plain = attn.attention_qkv_bwd_reference(qkv, o, do, m, l, H, SCALE)
        eo, em, el = attn.attention_qkv_fwd_stats_reference(qkv.float(), H, SCALE)
        exact = attn.attention_qkv_bwd_reference(qkv.float(), eo, do.float(), em, el, H, SCALE)
        del eo, em, el
        row = {"phase": "kernel", "kernel": "K1-bwd", "N": N, "tol_rms": BWD_TOL,
               "err_rms_vs_plain": bwd_errors(got, plain, exact), "err_rms_vs_f32": bwd_errors(got, exact, exact),
               "plain_err_rms_vs_f32": bwd_errors(plain, exact, exact),
               "max_abs_err": (got.float() - plain.float()).abs().max().item(),
               "finite": bool(torch.isfinite(got).all().item())}
        worst = max(worst, row["max_abs_err"])
        del plain, exact
        if N in (1568, 1570):
            torch.cuda.empty_cache()
            heads = [t.detach().requires_grad_() for t in qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)]
            do_h = do.view(B, N, H, D).transpose(1, 2)

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(*heads, scale=SCALE)
                torch.autograd.grad(out, heads, do_h)

            bound_ms, bound_by, flops, nbytes = attention_bwd_bound(N)
            row.update(
                ms=time_ms(lambda: attn.attention_qkv_bwd(qkv, o, do, m, l, H, SCALE), 20),
                plain_ms=time_ms(lambda: attn.attention_qkv_bwd_reference(qkv, o, do, m, l, H, SCALE), 3),
                library_ms=time_ms(sdpa_fwd_bwd, 20), library_call="scaled_dot_product_attention forward + backward",
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                exp_bound_ms=B * H * N * N / SFU_PER_S * 1e3)
            row["tflops"] = flops / row["ms"] / 1e9
            timing[N] = row
            del heads, do_h
        emit(row)
        if not row["finite"] or max(row["err_rms_vs_plain"] + row["err_rms_vs_f32"]) > BWD_TOL:
            fail(f"K1-bwd at N={N} beyond {BWD_TOL} of the f32 RMS: {row}")
        del qkv, do, o, m, l, got
        torch.cuda.empty_cache()
    return worst, timing


TP_HEADS = H // 2  # a rank's heads of the flagship student under --tp_size 2


def phase_kernel_tp(attn):
    """K1 at the tensor-parallel shape: the student's 1568 tokens with
    TP_HEADS of its 12 heads, as each rank of `--tp_size 2` runs it. The
    no-stats forward (TP eval) and the stats forward's o within KERNEL_TOL
    of the plain version's RMS in f32 and PLAIN_TOL of it in bf16 (one bf16
    ulp of an output above 0.25 is 0.047 of the RMS here), as phase_kernel
    holds K1-fwd; m and l within their tolerances, the backward's dq, dk,
    dv within BWD_TOL; each timed beside its plain version and
    `scaled_dot_product_attention` at 6 heads (forward, or forward +
    backward for K1-bwd). Returns {kernel: timing} for the kernels line."""
    N, heads = 1568, TP_HEADS
    rng = np.random.default_rng(40)
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * heads * D), dtype=np.float32)).to(dev, torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, N, heads * D), dtype=np.float32)).to(dev, torch.bfloat16)
    out = attn.fused_attention_qkv(qkv, heads, SCALE)
    o, m, l = attn.attention_qkv_fwd_stats(qkv, heads, SCALE)
    dqkv = attn.attention_qkv_bwd(qkv, o, do, m, l, heads, SCALE)
    torch.cuda.synchronize()
    eo, em, el = attn.attention_qkv_fwd_stats_reference(qkv.float(), heads, SCALE)
    po, pm, pl = attn.attention_qkv_fwd_stats_reference(qkv, heads, SCALE)
    plain_d = attn.attention_qkv_bwd_reference(qkv, o, do, m, l, heads, SCALE)
    exact_d = attn.attention_qkv_bwd_reference(qkv.float(), eo, do.float(), em, el, heads, SCALE)
    errs = {"K1-fwd": {"o_vs_plain": (out.float() - po.float()).abs().max().item() / _rms(po),
                       "o_vs_f32": (out.float() - eo).abs().max().item() / _rms(eo)},
            "K1-fwd-stats": {"o_vs_plain": (o.float() - po.float()).abs().max().item() / _rms(po),
                             "o_vs_f32": (o.float() - eo).abs().max().item() / _rms(eo),
                             "m": (m - em).abs().max().item() / _rms(em), "l": (l - el).abs().max().item() / _rms(el)},
            "K1-bwd": {"vs_plain": bwd_errors(dqkv, plain_d, exact_d), "vs_f32": bwd_errors(dqkv, exact_d, exact_d)}}
    max_abs = {"K1-fwd": (out.float() - po.float()).abs().max().item(),
               "K1-fwd-stats": (o.float() - po.float()).abs().max().item(),
               "K1-bwd": (dqkv.float() - plain_d.float()).abs().max().item()}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, o, m, l, dqkv))
    del eo, em, el, po, pm, pl, plain_d, exact_d
    torch.cuda.empty_cache()
    timing = {}
    q, k, v = qkv.view(B, N, 3, heads, D).permute(2, 0, 3, 1, 4)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    for name, fn, plain, library, bound in (
            ("K1-fwd", lambda: attn.fused_attention_qkv(qkv, heads, SCALE),
             lambda: attn.attention_qkv_reference(qkv, heads, SCALE), sdpa, attention_bound(N, heads=heads)),
            ("K1-fwd-stats", lambda: attn.attention_qkv_fwd_stats(qkv, heads, SCALE),
             lambda: attn.attention_qkv_fwd_stats_reference(qkv, heads, SCALE), sdpa,
             attention_bound(N, stats=True, heads=heads)),
            ("K1-bwd", lambda: attn.attention_qkv_bwd(qkv, o, do, m, l, heads, SCALE),
             lambda: attn.attention_qkv_bwd_reference(qkv, o, do, m, l, heads, SCALE),
             _sdpa_fwd_bwd(q, k, v, do.view(B, N, heads, D).transpose(1, 2)), attention_bwd_bound(N, heads=heads))):
        timing[name] = {"heads": heads, "N": N, "ms": time_ms(fn, 20), "plain_ms": time_ms(plain, 3),
                        "library_ms": time_ms(library, 20), "bound_ms": bound[0], "bound_by": bound[1],
                        "max_abs_err": max_abs[name]}
    row = {"phase": "kernel_tp", "heads": heads, "N": N, "err_rms": errs, "finite": finite, "timing": timing,
           "tol_rms": {"o_vs_plain": PLAIN_TOL, "o_vs_f32": KERNEL_TOL, "m": STATS_M_TOL, "l": STATS_L_TOL,
                       "bwd": BWD_TOL}}
    emit(row)
    e = errs
    ok = finite and all(e[k]["o_vs_plain"] <= PLAIN_TOL and e[k]["o_vs_f32"] <= KERNEL_TOL
                        for k in ("K1-fwd", "K1-fwd-stats"))
    ok &= e["K1-fwd-stats"]["m"] <= STATS_M_TOL and e["K1-fwd-stats"]["l"] <= STATS_L_TOL
    ok &= max(e["K1-bwd"]["vs_plain"] + e["K1-bwd"]["vs_f32"]) <= BWD_TOL
    if not ok:
        fail(f"K1 at {heads} heads beyond its limits: {row}")
    del qkv, do, out, o, m, l, dqkv, q, k, v
    torch.cuda.empty_cache()
    return timing


# K2's shapes: the four-shard shape (the local quarter of a 1568-token clip
# against all its keys), the one-shard shape the main path runs, and a
# shape ragged on both axes
Q_KV_SHAPES = ((392, 1568), (1568, 1568), (77, 301))


def _sdpa_fwd_bwd(q, k, v, do):
    """`scaled_dot_product_attention` forward + backward on head-major
    copies: the library yardstick of a backward kernel."""
    heads = [t.detach().requires_grad_() for t in (q, k, v)]

    def run():
        out = F.scaled_dot_product_attention(*heads, scale=SCALE)
        torch.autograd.grad(out, heads, do)

    return run


def phase_kernel_q_kv(attn):
    """K2-fwd, K2-fwd stats and K2-bwd against their plain versions at
    Q_KV_SHAPES, within K1's tolerances, and timed at the first two."""
    worst = {"K2-fwd": 0.0, "K2-fwd-stats": 0.0, "K2-bwd": 0.0}
    timing = {}
    for Nq, Nk in Q_KV_SHAPES:
        q, kv, do = _normal((B, Nq, H * D), Nq), _normal((B, Nk, 2 * H * D), Nk + 1), _normal((B, Nq, H * D), 3)
        out = attn.fused_attention_q_kv(q, kv, H, SCALE)
        o, m, l = attn.attention_q_kv_fwd_stats(q, kv, H, SCALE)
        dq, dkv = attn.attention_q_kv_bwd(q, kv, o, do, m, l, H, SCALE)
        torch.cuda.synchronize()
        row = {"phase": "kernel_q_kv", "Nq": Nq, "Nk": Nk,
               "finite": all(bool(torch.isfinite(t).all().item()) for t in (out, o, m, l, dq, dkv))}
        plain = attn.attention_q_kv_reference(q, kv, H, SCALE)
        exact = attn.attention_q_kv_reference(q.float(), kv.float(), H, SCALE)
        rms = _rms(exact)
        err, err_f32 = (out.float() - plain.float()).abs().max().item(), (out.float() - exact).abs().max().item()
        row["K2-fwd"] = {"max_abs_err": err, "tol": PLAIN_TOL * rms, "max_abs_err_vs_f32": err_f32,
                         "tol_vs_f32": KERNEL_TOL * rms}
        ok = row["finite"] and err <= PLAIN_TOL * rms and err_f32 <= KERNEL_TOL * rms
        worst["K2-fwd"] = max(worst["K2-fwd"], err)
        del plain, exact
        # o against the plain version in bf16 to PLAIN_TOL, as the no-stats
        # form: both are rounded to bf16, and one ulp of the largest output
        # (2^-9 near 0.5) is already 0.047 of the RMS at Nq=392
        o_tol = {"plain": PLAIN_TOL, "f32": KERNEL_TOL}
        stats = {"tol_rms": {"o": o_tol, "m": STATS_M_TOL, "l": STATS_L_TOL}}
        for label, src in (("plain", (q, kv)), ("f32", (q.float(), kv.float()))):
            po, pm, pl = attn.attention_q_kv_fwd_stats_reference(*src, H, SCALE)
            errs = {"o": (o.float() - po.float()).abs().max().item() / _rms(po),
                    "m": (m - pm).abs().max().item() / _rms(pm), "l": (l - pl).abs().max().item() / _rms(pl)}
            stats[f"err_rms_vs_{label}"] = errs
            ok &= errs["o"] <= o_tol[label] and errs["m"] <= STATS_M_TOL and errs["l"] <= STATS_L_TOL
            if label == "plain":
                stats["max_abs_err"] = (o.float() - po.float()).abs().max().item()
                worst["K2-fwd-stats"] = max(worst["K2-fwd-stats"], stats["max_abs_err"])
        row["K2-fwd-stats"] = stats
        plain_g = attn.attention_q_kv_bwd_reference(q, kv, o, do, m, l, H, SCALE)
        eo, em, el = attn.attention_q_kv_fwd_stats_reference(q.float(), kv.float(), H, SCALE)
        exact_g = attn.attention_q_kv_bwd_reference(q.float(), kv.float(), eo, do.float(), em, el, H, SCALE)
        bwd = {"tol_rms": BWD_TOL, "err_rms_vs_plain": q_kv_bwd_errors((dq, dkv), plain_g, exact_g),
               "err_rms_vs_f32": q_kv_bwd_errors((dq, dkv), exact_g, exact_g),
               "plain_err_rms_vs_f32": q_kv_bwd_errors(plain_g, exact_g, exact_g),
               "max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in zip((dq, dkv), plain_g))}
        row["K2-bwd"] = bwd
        ok &= max(bwd["err_rms_vs_plain"] + bwd["err_rms_vs_f32"]) <= BWD_TOL
        worst["K2-bwd"] = max(worst["K2-bwd"], bwd["max_abs_err"])
        del plain_g, eo, em, el, exact_g
        torch.cuda.empty_cache()
        if (Nq, Nk) != Q_KV_SHAPES[-1]:
            qh = q.view(B, Nq, H, D).transpose(1, 2)
            kh, vh = kv.view(B, Nk, 2, H, D).permute(2, 0, 3, 1, 4)
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=SCALE), 20)
            t = {}
            for name, fn, plain_fn, lib_ms, bound in (
                    ("K2-fwd", lambda: attn.fused_attention_q_kv(q, kv, H, SCALE),
                     lambda: attn.attention_q_kv_reference(q, kv, H, SCALE), sdpa_ms, q_kv_bound(Nq, Nk)),
                    ("K2-fwd-stats", lambda: attn.attention_q_kv_fwd_stats(q, kv, H, SCALE),
                     lambda: attn.attention_q_kv_fwd_stats_reference(q, kv, H, SCALE), sdpa_ms,
                     q_kv_bound(Nq, Nk, stats=True)),
                    ("K2-bwd", lambda: attn.attention_q_kv_bwd(q, kv, o, do, m, l, H, SCALE),
                     lambda: attn.attention_q_kv_bwd_reference(q, kv, o, do, m, l, H, SCALE),
                     time_ms(_sdpa_fwd_bwd(qh, kh, vh, do.view(B, Nq, H, D).transpose(1, 2)), 20),
                     q_kv_bwd_bound(Nq, Nk))):
                bound_ms, bound_by, flops, nbytes = bound
                t[name] = {"ms": time_ms(fn, 20), "plain_ms": time_ms(plain_fn, 3), "library_ms": lib_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                           "exp_bound_ms": B * H * Nq * Nk / SFU_PER_S * 1e3}
                t[name]["tflops"] = flops / t[name]["ms"] / 1e9
                torch.cuda.empty_cache()
            t["K2-bwd"]["library_call"] = "scaled_dot_product_attention forward + backward"
            row["timing"] = t
            timing[(Nq, Nk)] = t
        emit(row)
        if not ok:
            fail(f"K2 at Nq={Nq}, Nk={Nk} beyond its limits: {row}")
        del q, kv, do, out, o, m, l, dq, dkv
        torch.cuda.empty_cache()
    return worst, timing


def phase_sp_compose(attn):
    """The four-shard composition at N=1568: K2 on four 392-row query
    shards against the full kv, concatenated, against K1 on the same qkv;
    the shards' dkv summed, against K1-bwd."""
    N, C, S = 1568, H * D, 4
    n = N // S
    qkv, do = _inputs(N, 40)
    o1, m1, l1 = attn.attention_qkv_fwd_stats(qkv, H, SCALE)
    dqkv = attn.attention_qkv_bwd(qkv, o1, do, m1, l1, H, SCALE)
    kv = qkv[..., C:].contiguous()
    parts, dkv = [], torch.zeros(B, N, 2 * C, device="cuda")
    for r in range(S):
        q = qkv[:, r * n:(r + 1) * n, :C].contiguous()
        o, m, l = attn.attention_q_kv_fwd_stats(q, kv, H, SCALE)
        dq, dkv_r = attn.attention_q_kv_bwd(q, kv, o, do[:, r * n:(r + 1) * n].contiguous(), m, l, H, SCALE)
        parts.append((o, m, l, dq))
        dkv += dkv_r.float()
    torch.cuda.synchronize()
    o, m, l, dq = (torch.cat([p[i] for p in parts], dim=1 if i in (0, 3) else -1) for i in range(4))
    errs = {"o": (o.float() - o1.float()).abs().max().item() / _rms(o1),
            "m": (m - m1).abs().max().item() / _rms(m1), "l": (l - l1).abs().max().item() / _rms(l1)}
    grads = grad_errors((dq, *dkv.chunk(2, -1)), dqkv.chunk(3, -1), dqkv.chunk(3, -1))
    row = {"phase": "sp_compose", "shards": S, "N": N, "err_rms_vs_k1": errs, "grad_err_rms_vs_k1": grads,
           "tol_rms": {"o": KERNEL_TOL, "m": STATS_M_TOL, "l": STATS_L_TOL, "grads": BWD_TOL}}
    emit(row)
    if errs["o"] > KERNEL_TOL or errs["m"] > STATS_M_TOL or errs["l"] > STATS_L_TOL or max(grads) > BWD_TOL:
        fail(f"four K2 shards disagree with K1: {row}")
    del qkv, do, o1, m1, l1, dqkv, kv, parts, dkv, o, m, l, dq
    torch.cuda.empty_cache()


def phase_kernel_head_major(attn):
    """K3-fwd and K3-bwd against their plain versions at N = 1568 and 77,
    timed at 1568."""
    worst, timing = {"K3-fwd": 0.0, "K3-bwd": 0.0}, None
    for N in (1568, 77):
        q, k, v, do = (_normal((B, H, N, D), 50 + N + i) for i in range(4))
        out = attn.fused_attention(q, k, v, SCALE)
        grads = attn.attention_head_major_bwd(q, k, v, out, do, SCALE)
        torch.cuda.synchronize()
        plain = attn.attention_head_major_reference(q, k, v, SCALE)
        exact = attn.attention_head_major_reference(q.float(), k.float(), v.float(), SCALE)
        rms = _rms(exact)
        err, err_f32 = (out.float() - plain.float()).abs().max().item(), (out.float() - exact).abs().max().item()
        plain_g = attn.attention_head_major_bwd_reference(q, k, v, out, do, SCALE)
        exact_g = attn.attention_head_major_bwd_reference(q.float(), k.float(), v.float(), exact, do.float(), SCALE)
        row = {"phase": "kernel_head_major", "N": N,
               "finite": all(bool(torch.isfinite(t).all().item()) for t in (out, *grads)),
               "K3-fwd": {"max_abs_err": err, "tol": PLAIN_TOL * rms, "max_abs_err_vs_f32": err_f32,
                          "tol_vs_f32": KERNEL_TOL * rms},
               "K3-bwd": {"tol_rms": BWD_TOL, "err_rms_vs_plain": grad_errors(grads, plain_g, exact_g),
                          "err_rms_vs_f32": grad_errors(grads, exact_g, exact_g),
                          "plain_err_rms_vs_f32": grad_errors(plain_g, exact_g, exact_g),
                          "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                             for a, b in zip(grads, plain_g))}}
        worst["K3-fwd"] = max(worst["K3-fwd"], err)
        worst["K3-bwd"] = max(worst["K3-bwd"], row["K3-bwd"]["max_abs_err"])
        ok = row["finite"] and err <= PLAIN_TOL * rms and err_f32 <= KERNEL_TOL * rms \
            and max(row["K3-bwd"]["err_rms_vs_plain"] + row["K3-bwd"]["err_rms_vs_f32"]) <= BWD_TOL
        del plain, exact, plain_g, exact_g
        torch.cuda.empty_cache()
        if N == 1568:
            t = {}
            for name, fn, plain_fn, lib, bound in (
                    ("K3-fwd", lambda: attn.fused_attention(q, k, v, SCALE),
                     lambda: attn.attention_head_major_reference(q, k, v, SCALE),
                     lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE), head_major_bound(N)),
                    ("K3-bwd", lambda: attn.attention_head_major_bwd(q, k, v, out, do, SCALE),
                     lambda: attn.attention_head_major_bwd_reference(q, k, v, out, do, SCALE),
                     _sdpa_fwd_bwd(q, k, v, do), head_major_bound(N, bwd=True))):
                bound_ms, bound_by, flops, nbytes = bound
                t[name] = {"ms": time_ms(fn, 20), "plain_ms": time_ms(plain_fn, 3), "library_ms": time_ms(lib, 20),
                           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes}
                t[name]["tflops"] = flops / t[name]["ms"] / 1e9
                torch.cuda.empty_cache()
            t["K3-bwd"]["library_call"] = "scaled_dot_product_attention forward + backward"
            row["timing"] = timing = t
        emit(row)
        if not ok:
            fail(f"K3 at N={N} beyond its limits: {row}")
        del q, k, v, do, out, grads
        torch.cuda.empty_cache()
    return worst, timing


# K4 at the flagship agg round: 2 slots, D=768, 4 heads x 512, over the
# student's 1568 tokens and a ragged 301
SLOTS, AGG_DIM, AGG_HEADS, AGG_DIM_HEAD = 2, 768, 4, 512
SLOT_ATTN_N = (1568, 301)


def slot_attention_bound(N: int):
    """K4, the least work these inputs need: the factorised form, in which k
    and v are never formed (`csrc/slot_attention.cu`). The logits ctx·u and
    c = a·ctx (2B·heads·S·N·D each) and the four projections q = x wq,
    u = scale wk_h q_h^T, num = c wv_h and o wo (2B·S·D·inner each), f32
    FMAs on the FP32 pipe; x, ctx, the four weights and bo read once, out
    and sim written once."""
    D, inner = AGG_DIM, AGG_HEADS * AGG_DIM_HEAD
    flops = 4 * B * AGG_HEADS * SLOTS * N * D + 8 * B * SLOTS * D * inner
    nbytes = 2 * (B * SLOTS * D + B * N * D + 4 * D * inner + D + B * SLOTS * D) + 4 * B * AGG_HEADS * SLOTS * N
    return _bound(flops, nbytes, FP32_PEAK)


# bytes written between K4's launches when it is timed with L2 cold (the
# card's L2 holds 50 MB)
L2_FLUSH_BYTES = 64 * 2 ** 20


def time_cold_ms(fn, iters: int = 50) -> float:
    """ms of `fn` per launch with L2 flushed before each: a 64 MB write,
    then CUDA events around `fn` alone, summed over `iters` launches."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _slot_inputs(N: int, seed: int):
    """x, ctx ~ N(0, 1) (the normed slots and context) and the round's
    weights ~ N(0, 0.02^2) (the agg Linear's init), bf16 on the card."""
    rng = np.random.default_rng(seed)
    D, inner = AGG_DIM, AGG_HEADS * AGG_DIM_HEAD
    shapes = ((B, SLOTS, D, 1.0), (B, N, D, 1.0), (D, inner, 0.02), (D, inner, 0.02), (D, inner, 0.02),
              (inner, D, 0.02), (D, 0.02))
    return [torch.from_numpy(rng.standard_normal(s[:-1], dtype=np.float32) * np.float32(s[-1])).to(
        "cuda", torch.bfloat16) for s in shapes]


def phase_kernel_slot_attention(sa):
    """K4 against its plain version at N in SLOT_ATTN_N: out and sim within
    PLAIN_TOL (bf16 plain version) and KERNEL_TOL (f32) of the f32 RMS, the
    Function's backward within BWD_TOL of autograd of the f32 plain version;
    timed at N=1568."""
    worst, timing = 0.0, None
    for N in SLOT_ATTN_N:
        inputs = _slot_inputs(N, 60 + N)
        with torch.no_grad():
            out, sim = sa.fused_slot_attention(*inputs, AGG_HEADS, AGG_DIM_HEAD)
            torch.cuda.synchronize()
            plain = sa.slot_attention_reference(*inputs, AGG_HEADS, AGG_DIM_HEAD)
            exact = sa.slot_attention_reference(*(t.float() for t in inputs), AGG_HEADS, AGG_DIM_HEAD)
        row = {"phase": "kernel_slot_attention", "N": N, "tol_rms": {"vs_plain": PLAIN_TOL, "vs_f32": KERNEL_TOL},
               "finite": bool(torch.isfinite(out).all().item() and torch.isfinite(sim).all().item())}
        ok = row["finite"]
        for name, got, p, e in (("out", out, plain[0], exact[0]), ("sim", sim, plain[1], exact[1])):
            rms = _rms(e)
            errs = {"max_abs_err": (got.float() - p.float()).abs().max().item(),
                    "max_abs_err_vs_f32": (got.float() - e).abs().max().item(), "rms_f32": rms}
            row[name] = errs
            ok &= errs["max_abs_err"] <= PLAIN_TOL * rms and errs["max_abs_err_vs_f32"] <= KERNEL_TOL * rms
            worst = max(worst, errs["max_abs_err"])
        # the backward: autograd of the plain version on the saved bf16
        # inputs, against autograd of the f32 plain version
        rng = np.random.default_rng(70 + N)
        g_out = torch.from_numpy(rng.standard_normal(tuple(out.shape), dtype=np.float32)).cuda()
        g_sim = torch.from_numpy(rng.standard_normal(tuple(sim.shape), dtype=np.float32)).cuda()
        leaves = [t.detach().requires_grad_() for t in inputs]
        o, s = sa.fused_slot_attention(*leaves, AGG_HEADS, AGG_DIM_HEAD)
        got = torch.autograd.grad((o, s), leaves, (g_out.to(o.dtype), g_sim))
        leaves32 = [t.detach().float().requires_grad_() for t in inputs]
        o, s = sa.slot_attention_reference(*leaves32, AGG_HEADS, AGG_DIM_HEAD)
        want = torch.autograd.grad((o, s), leaves32, (g_out, g_sim))
        row["bwd_err_rms_vs_f32"] = grad_errors(got, want, want)
        row["bwd_tol_rms"] = BWD_TOL
        ok &= all(bool(torch.isfinite(g).all().item()) for g in got) and max(row["bwd_err_rms_vs_f32"]) <= BWD_TOL
        del leaves, leaves32, o, s, got, want, plain, exact
        torch.cuda.empty_cache()
        if N == SLOT_ATTN_N[0]:
            bound_ms, bound_by, flops, nbytes = slot_attention_bound(N)
            with torch.no_grad():
                # warm: ctx (28.9 MB) stays in L2 across launches, as in the
                # tied agg rounds that reuse it; the kernels line carries it
                row.update(ms=time_ms(lambda: sa.fused_slot_attention(*inputs, AGG_HEADS, AGG_DIM_HEAD), 200),
                           cold_ms=time_cold_ms(lambda: sa.fused_slot_attention(*inputs, AGG_HEADS, AGG_DIM_HEAD)),
                           plain_ms=time_ms(lambda: sa.slot_attention_reference(*inputs, AGG_HEADS, AGG_DIM_HEAD), 5),
                           library_ms=None, library_call="none: no single PyTorch call computes K4",
                           bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            row["tflops"] = flops / row["ms"] / 1e9
            row["bound_share"] = {"warm": bound_ms / row["ms"], "cold": bound_ms / row["cold_ms"]}
            timing = row
        emit(row)
        if not ok:
            fail(f"K4 at N={N} beyond its limits: {row}")
        del inputs, out, sim
        torch.cuda.empty_cache()
    return worst, timing


PATCH_SHAPES = ((B, 16, 224, 224, 3), (2, 4, 48, 80, 3))


def patch_embed_bound(shape, dout: int = 768):
    """K5: 2·M·1536·Dout operations for M tokens; the f32 clip and the bf16
    kernel read once, the bf16 tokens written once."""
    Bx, T, Hx, Wx, C = shape
    M = Bx * (T // 2) * (Hx // 16) * (Wx // 16)
    return _bound(2 * M * 1536 * dout, 4 * Bx * T * Hx * Wx * C + 2 * 1536 * dout + 2 * M * dout)


def phase_kernel_patch_embed(pe):
    """K5 against its plain version at PATCH_SHAPES, within PLAIN_TOL (bf16
    plain version) and KERNEL_TOL (f32 clip and kernel) of the f32 RMS;
    timed at the flagship shape with the patchify + bf16 matmul yardstick."""
    worst, timing = 0.0, None
    for shape in PATCH_SHAPES:
        rng = np.random.default_rng(sum(shape))
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
        kernel = torch.from_numpy(rng.standard_normal((1536, 768), dtype=np.float32) * np.float32(1536 ** -0.5)).to(
            "cuda", torch.bfloat16)
        out = pe.patchify_embed(x, kernel)
        torch.cuda.synchronize()
        plain = pe.patchify_embed_reference(x, kernel)
        exact = pe.patchify_embed_reference(x, kernel.float())
        rms = _rms(exact)
        err, err_f32 = (out.float() - plain.float()).abs().max().item(), (out.float() - exact).abs().max().item()
        row = {"phase": "kernel_patch_embed", "shape": list(shape), "out_shape": list(out.shape), "rms_f32": rms,
               "max_abs_err": err, "tol": PLAIN_TOL * rms, "max_abs_err_vs_f32": err_f32,
               "tol_vs_f32": KERNEL_TOL * rms, "finite": bool(torch.isfinite(out).all().item())}
        worst = max(worst, err)
        ok = row["finite"] and tuple(out.shape) == tuple(plain.shape) and err <= PLAIN_TOL * rms \
            and err_f32 <= KERNEL_TOL * rms
        del plain, exact
        if shape == PATCH_SHAPES[0]:
            bound_ms, bound_by, flops, nbytes = patch_embed_bound(shape)
            row.update(ms=time_ms(lambda: pe.patchify_embed(x, kernel), 20),
                       plain_ms=time_ms(lambda: pe.patchify_embed_reference(x, kernel), 5),
                       library_ms=time_ms(lambda: pe._patches(x.bfloat16()) @ kernel, 20),
                       library_call="two calls: the patchify copy of x.bfloat16() and torch.matmul (cuBLAS)",
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
            row["tflops"] = flops / row["ms"] / 1e9
            row["bound_share"] = bound_ms / row["ms"]
            timing = row
        emit(row)
        if not ok:
            fail(f"K5 at {shape} beyond its limits: {row}")
        del x, kernel, out
        torch.cuda.empty_cache()
    return worst, timing


def synthetic_batches():
    rng = np.random.default_rng(0)
    batches = []
    for b in range(N_BATCHES):
        batches.append({
            "videos": rng.standard_normal(CLIPS, dtype=np.float32),
            "labels": rng.integers(0, NUM_CLASSES, size=B),
            "video_id": [f"clip{b:02d}_{i:02d}" for i in range(B)],
            "chunk": np.zeros(B, np.int64),
            "split": np.full(B, b, np.int64),
        })
    return batches


def phase_slice(attn, card):
    from devias_tpu_torch.eval import final_test, merge_results, parse_result_file, validation_one_epoch
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import make_eval_step

    t0 = time.perf_counter()
    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
    batches = synthetic_batches()
    setup_s = time.perf_counter() - t0

    action_step = make_eval_step(student, "action_logit")
    scene_step = make_eval_step(student, "scene_logit")
    teacher_step = make_eval_step(teacher, "logits")

    def scene_fn(videos):
        return scene_step(videos)[:, NUM_CLASSES:]

    # warm-up (cuBLAS handles, allocator) outside the counted run
    action_step(batches[0]["videos"])
    teacher_step(batches[0]["videos"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    attn.reset_launch_counts()
    val = validation_one_epoch(batches, action_step, B)
    val_launches = attn.fused_attention_qkv.launches
    with tempfile.TemporaryDirectory() as out_dir:
        test = final_test(batches, scene_fn, B, out_dir, scene_label_fn=teacher_step)
        torch.cuda.synchronize()
        launches = attn.fused_attention_qkv.launches
        counts = attn.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = parse_result_file(os.path.join(out_dir, "0.txt"))  # raises on non-finite logits
        merged = merge_results(out_dir, 1)
    row = {"phase": "slice", "card": card, "batches": N_BATCHES, "clips_per_batch": B, "setup_s": setup_s,
           "validation": val, "final_test": test, "merged": merged, "result_rows": len(rows),
           "peak_memory_gib": peak_gib,
           "launches": {"validation": val_launches, "final_test": launches - val_launches, "total": launches}}
    emit(row)
    if val_launches != 12 * N_BATCHES or launches - val_launches != 24 * N_BATCHES:
        fail(f"K1 launches {row['launches']}: want 12 per batch in validation, 24 per batch in final_test")
    if counts["K1-fwd-stats"] or counts["K1-bwd"]:
        fail(f"the eval path launched training kernels: {counts}")
    if len(rows) != N_BATCHES * B or not all(np.isfinite(v) for v in (*val.values(), *test.values(), *merged)):
        fail(f"protocol results wrong: {row}")

    # the same weights with the plain attention, on one batch
    plain = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=False, **SLOT_KW)
    plain.load_state_dict(student.state_dict())
    videos = batches[0]["videos"]
    fused_out = make_eval_step(student)(videos)
    plain_out = make_eval_step(plain)(videos)
    cmp = {"phase": "slice_vs_plain", "tol": SLICE_TOL}
    ok = True
    for key in ("slots_head", "attn"):
        got, want = fused_out[key].float(), plain_out[key].float()
        finite = bool(torch.isfinite(got).all().item())
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        cmp[key] = {"shape": list(got.shape), "max_abs_err": err, "max_abs_plain": ref, "finite": finite}
        ok &= finite and err <= SLICE_TOL * ref
    emit(cmp)
    if tuple(fused_out["slots_head"].shape) != (B, 2, NUM_CLASSES + NUM_SCENE_CLASSES) \
            or tuple(fused_out["attn"].shape) != (B, 4, 2, 1568):
        fail("slice output shapes wrong")
    if not ok:
        fail(f"fused and plain slices disagree beyond {SLICE_TOL} of the plain output's magnitude")
    del plain, plain_out, fused_out
    torch.cuda.empty_cache()

    # throughput over a window of seconds; the launch counts above are final
    loader = [batches[i % N_BATCHES] for i in range(THROUGHPUT_BATCHES)]
    t0 = time.perf_counter()
    validation_one_epoch(loader, action_step, B)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        final_test(loader, scene_fn, B, out_dir, scene_label_fn=teacher_step)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
    emit({"phase": "throughput", "card": card, "batches": THROUGHPUT_BATCHES, "clips_per_batch": B,
          "validation_s": val_s, "final_test_s": test_s,
          "validation_clips_per_s": THROUGHPUT_BATCHES * B / val_s,
          "final_test_clips_per_s": THROUGHPUT_BATCHES * B / test_s})
    return launches


def vit_flops_per_clip(N: int, C: int = 768, depth: int = 12) -> float:
    """Forward operations of a ViT-B's blocks on one clip: qkv, proj and
    the MLP (24 N C^2) and the two attention products (4 N^2 C) per block.
    The patch embed, the agg block and the heads add about 1 %."""
    return depth * (24 * N * C * C + 4 * N * N * C)


def _train_parts():
    from devias_tpu_torch.aug import FAMEConfig
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.train import TrainStepConfig

    return SlotLossConfig(NUM_CLASSES, NUM_SCENE_CLASSES), TrainStepConfig(
        use_fame=True, fame=FAMEConfig(beta=0.5, prob_aug=0.8))


def phase_train(attn, card):
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.scripts.profile_step import profile_breakdown
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step

    t0 = time.perf_counter()
    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
    opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10))
    state = TrainState.create(student, opt)
    loss_cfg, step_cfg = _train_parts()
    step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn)
    rng = np.random.default_rng(0)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, NUM_CLASSES, size=B)}
    params = dict(student.named_parameters())
    before = {n: params[n].detach().clone() for n in TRAIN_WATCH}
    setup_s = time.perf_counter() - t0

    attn.reset_launch_counts()
    t0 = time.perf_counter()
    history = [step(state, batch, host_metrics=True) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = attn.launch_counts()
    changed = {n: (params[n].detach() - before[n]).abs().max().item() for n in TRAIN_WATCH}
    finite = all(np.isfinite(v) for m in history for v in m.values())
    emit({"phase": "train", "card": card, "steps": TRAIN_STEPS, "clips_per_step": B, "setup_s": setup_s,
          "first_steps_s": first_s, "metrics": history, "launches": counts, "param_max_change": changed,
          "state_step": state.step})
    want = {name: 12 * TRAIN_STEPS if name.startswith("K1") else 0 for name in counts}
    if counts != want:
        fail(f"train launches {counts}; want {want} (12 teacher K1-fwd, 12 student K1-fwd stats and K1-bwd per step)")
    if not finite or state.step != TRAIN_STEPS or not all(v > 0 for v in changed.values()):
        fail(f"train steps wrong: finite={finite} step={state.step} changes={changed}")
    if set(history[0]) != {"loss", "action_loss", "scene_loss", "cosine_loss", "mask_prediction_loss",
                           "mask_distill_loss", "class_acc", "grad_norm", "lr"}:
        fail(f"train metrics {sorted(history[0])}")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_WINDOW):
        metrics = step(state, batch)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    ms = window_s / TRAIN_WINDOW * 1e3
    flops = B * (3 * vit_flops_per_clip(1568) + vit_flops_per_clip(1569))
    emit({"phase": "train_throughput", "card": card, "steps": TRAIN_WINDOW, "clips_per_step": B,
          "window_s": window_s, "ms_per_step": ms, "clips_per_s": TRAIN_WINDOW * B / window_s,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "loss": float(metrics["loss"]),
          "tflop_per_step": flops / 1e12, "share_of_bf16_peak": flops / (ms * 1e-3) / BF16_PEAK})
    emit({"phase": "train_profile", "card": card, **profile_breakdown(lambda: step(state, batch), PROFILE_STEPS)})
    del student, teacher, opt, state, step
    torch.cuda.empty_cache()
    return counts, ms


def phase_train_vs_plain(card):
    """One micro-batch of 2 clips through the step's loss with fused and
    with plain attention on the same weights and FAME draws."""
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train.step import slot_loss

    loss_cfg, step_cfg = _train_parts()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    videos = torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=2)).to(dev)
    draws = {"perm": torch.tensor([1, 0], device=dev), "keep": torch.tensor([True, True], device=dev)}
    out = {}
    for fused in (True, False):
        student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=fused, **SLOT_KW).train()
        teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=fused, **TEACHER_KW)
        total, _ = slot_loss(student, teacher, videos, labels, loss_cfg, step_cfg, draws=draws)
        total.backward()
        params = dict(student.named_parameters())
        out[fused] = (total.item(), {n: params[n].grad.float().clone() for n in TRAIN_WATCH})
        del student, teacher, total, params
        torch.cuda.empty_cache()
    (loss_f, grads_f), (loss_p, grads_p) = out[True], out[False]
    row = {"phase": "train_vs_plain", "card": card, "clips": 2, "loss_fused": loss_f, "loss_plain": loss_p,
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_TOL, "grads": {}}
    ok = np.isfinite(loss_f) and abs(loss_f - loss_p) <= TRAIN_LOSS_TOL * abs(loss_p)
    for n in TRAIN_WATCH:
        err = (grads_f[n] - grads_p[n]).abs().max().item()
        ref = grads_p[n].abs().max().item()
        finite = bool(torch.isfinite(grads_f[n]).all().item())
        row["grads"][n] = {"max_abs_err": err, "max_abs_plain": ref, "finite": finite}
        ok &= finite and ref > 0 and err <= TRAIN_TOL * ref
    emit(row)
    if not ok:
        fail("fused and plain train steps disagree beyond their limits")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


SP_TRAIN_WINDOW = 10


def phase_sp_train(attn, card):
    """The sequence-parallel slot train step on a seq group of this one card
    over NCCL (`maybe_init_distributed` with a one-process coordinator,
    `make_sp_mesh(1)`): TRAIN_STEPS counted steps and one deterministic SP
    token pass (`seq_parallel_tokens`, K2-fwd) held to SLICE_TOL of the
    ordinary forward, a SP_TRAIN_WINDOW-step timed window, a profile, and
    sp_vs_train.
    The group exists for this phase only."""
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import make_sp_mesh, maybe_init_distributed, reduce_backbone_grads, seq_parallel_tokens
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.scripts.profile_step import profile_breakdown
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step
    from devias_tpu_torch.train.step import slot_loss, to_device

    os.environ.update(DEVIAS_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}", DEVIAS_TPU_NUM_PROCS="1",
                      DEVIAS_TPU_PROC_ID="0")
    if not maybe_init_distributed("cuda") or dist.get_backend() != "nccl":
        fail("no NCCL process group for the SP phase")
    try:
        mesh = make_sp_mesh(1)
        t0 = time.perf_counter()
        student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
        teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
        opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10))
        state = TrainState.create(student, opt)
        loss_cfg, step_cfg = _train_parts()
        step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn, sp_mesh=mesh)
        rng = np.random.default_rng(0)
        batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32),
                 "labels": rng.integers(0, NUM_CLASSES, size=B)}
        videos = to_device(batch["videos"], torch.device("cuda"))
        params = dict(student.named_parameters())
        before = {n: params[n].detach().clone() for n in TRAIN_WATCH}
        setup_s = time.perf_counter() - t0

        attn.reset_launch_counts()
        t0 = time.perf_counter()
        history = [step(state, batch, host_metrics=True) for _ in range(TRAIN_STEPS)]
        with torch.no_grad():
            sp_tokens = seq_parallel_tokens(student, videos, mesh)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = attn.launch_counts()
        student.eval()
        with torch.no_grad():
            tokens = student.forward_features(videos)
        student.train()
        token_err = (sp_tokens.float() - tokens.float()).abs().max().item()
        token_ref = tokens.float().abs().max().item()
        changed = {n: (params[n].detach() - before[n]).abs().max().item() for n in TRAIN_WATCH}
        finite = all(np.isfinite(v) for m in history for v in m.values())
        emit({"phase": "sp_train", "card": card, "backend": dist.get_backend(), "seq": mesh.seq_size,
              "steps": TRAIN_STEPS, "clips_per_step": B, "setup_s": setup_s, "first_steps_s": first_s,
              "metrics": history, "launches": counts, "param_max_change": changed, "state_step": state.step,
              "sp_tokens_max_abs_err": token_err, "tokens_max_abs": token_ref, "tokens_tol": SLICE_TOL})
        want = {name: 0 for name in counts}
        want.update({"K1-fwd": 12 * TRAIN_STEPS, "K2-fwd": 12, "K2-fwd-stats": 12 * TRAIN_STEPS,
                     "K2-bwd": 12 * TRAIN_STEPS})
        if counts != want:
            fail(f"SP train launches {counts}; want {want} (12 teacher K1-fwd, 12 student K2-fwd stats and "
                 f"K2-bwd per step, 12 K2-fwd in the deterministic SP token pass)")
        if not finite or state.step != TRAIN_STEPS or not all(v > 0 for v in changed.values()):
            fail(f"SP train steps wrong: finite={finite} step={state.step} changes={changed}")
        if not token_err <= SLICE_TOL * token_ref:
            fail(f"SP tokens differ from the ordinary forward's by {token_err} (> {SLICE_TOL} x {token_ref})")
        del sp_tokens, tokens

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SP_TRAIN_WINDOW):
            metrics = step(state, batch)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        emit({"phase": "sp_train_throughput", "card": card, "steps": SP_TRAIN_WINDOW, "clips_per_step": B,
              "window_s": window_s, "ms_per_step": window_s / SP_TRAIN_WINDOW * 1e3,
              "clips_per_s": SP_TRAIN_WINDOW * B / window_s,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "loss": float(metrics["loss"])})
        emit({"phase": "sp_train_profile", "card": card,
              **profile_breakdown(lambda: step(state, batch), PROFILE_STEPS)})
        del opt, state, step

        # sp_vs_train: one micro-batch of 2 clips, the same weights and FAME draws
        dev = torch.device("cuda")
        rng = np.random.default_rng(1)
        clips = torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=2)).to(dev)
        draws = {"perm": torch.tensor([1, 0], device=dev), "keep": torch.tensor([True, True], device=dev)}
        out = {}
        for sp in (True, False):
            student.zero_grad(set_to_none=True)
            total, _ = slot_loss(student, teacher, clips, labels, loss_cfg, step_cfg,
                                 torch.Generator(device=dev).manual_seed(0), draws, mesh if sp else None)
            total.backward()
            if sp:
                reduce_backbone_grads(student, mesh)
            out[sp] = (total.item(), {n: params[n].grad.float().clone() for n in TRAIN_WATCH})
        (loss_sp, grads_sp), (loss_ref, grads_ref) = out[True], out[False]
        row = {"phase": "sp_vs_train", "card": card, "clips": 2, "loss_sp": loss_sp, "loss_train": loss_ref,
               "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_TOL, "grads": {}}
        ok = np.isfinite(loss_sp) and abs(loss_sp - loss_ref) <= TRAIN_LOSS_TOL * abs(loss_ref)
        for n in TRAIN_WATCH:
            err = (grads_sp[n] - grads_ref[n]).abs().max().item()
            ref = grads_ref[n].abs().max().item()
            finite = bool(torch.isfinite(grads_sp[n]).all().item())
            row["grads"][n] = {"max_abs_err": err, "max_abs_train": ref, "finite": finite}
            ok &= finite and ref > 0 and err <= TRAIN_TOL * ref
        emit(row)
        if not ok:
            fail("the SP and the ordinary train step disagree beyond their limits")
        del student, teacher, params
        torch.cuda.empty_cache()
        return counts
    finally:
        dist.destroy_process_group()
        for key in ("DEVIAS_TPU_COORDINATOR", "DEVIAS_TPU_NUM_PROCS", "DEVIAS_TPU_PROC_ID"):
            os.environ.pop(key, None)


# the CLI phase's synthetic filelists: 48 training clips (4 steps of 12
# samples, each drawn twice by --num_sample 2), 12 validation and 12 test
# clips (24 test views at 1 segment x 2 crops)
CLI_TRAIN, CLI_VAL, CLI_TEST = 48, 12, 12
CLI_FLAGS = ["--model", "slot_vit_base_patch16_224", "--num_latents", "2", "--agg_depth", "8", "--agg_weights_tie",
             "--mask_model", "FAME", "--batch_size", "12", "--max_steps_per_epoch", "4", "--test_num_segment", "1",
             "--test_num_crop", "2", "--synthetic_data"]
# the README's tiny command (without --device cpu), one epoch
TINY_CLI_FLAGS = ["--smoke_tiny", "--synthetic_data", "--data_set", "UCF101", "--nb_classes", "5", "--num_latents",
                  "2", "--agg_depth", "2", "--agg_weights_tie", "--mask_model", "FAME", "--batch_size", "4",
                  "--epochs", "1", "--num_frames", "8", "--input_size", "32", "--short_side_size", "32"]


def write_tiny_filelists(path: str) -> None:
    """train.csv, val.csv and test.csv of 16, 8 and 8 synthetic clips over
    the tiny command's 5 classes."""
    os.makedirs(path, exist_ok=True)
    for name, n in (("train.csv", 16), ("val.csv", 8), ("test.csv", 8)):
        with open(os.path.join(path, name), "w") as f:
            f.write("\n".join(f"{name[0]}{i}.mp4 {i % 5}" for i in range(n)))


def _cli_run(attn, cli, argv):
    """One in-process run of the CLI with the kernels' counts zeroed just
    before and read just after. Returns (result, counts, seconds)."""
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(cli.get_args(argv))
    torch.cuda.synchronize()
    return result, attn.launch_counts(), time.perf_counter() - t0


def phase_cli(attn, card, direct_step_ms: float):
    """The port's CLI (`devias_tpu_torch.cli.run_slot_finetuning`) at full
    width on synthetic clips: train one epoch of 4 steps, resume to a
    second epoch, then --eval --eval_scene --run_knn on the trained
    checkpoint with a scene teacher written from the port's seeded teacher.
    Fails on a missing result file, a non-finite metric or K1 launch counts
    other than the path's."""
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.eval import merge_results, parse_result_file
    from devias_tpu_torch.nn import create_model

    import cv2
    import PIL

    emit({"phase": "cli_host_libraries", "cv2": cv2.__version__, "PIL": PIL.__version__})
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "filelist")
        os.makedirs(data)
        for name, n in (("train.csv", CLI_TRAIN), ("val.csv", CLI_VAL), ("test.csv", CLI_TEST)):
            with open(os.path.join(data, name), "w") as f:
                f.write("\n".join(f"clip{i:03d}.mp4 {i % NUM_CLASSES}" for i in range(n)))
        out, eval_out = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
        base = CLI_FLAGS + ["--data_path", data, "--output_dir", out]
        runs = {}
        for label, extra in (("train", ["--epochs", "1"]), ("resume", ["--epochs", "2", "--auto_resume"])):
            result, counts, seconds = _cli_run(attn, cli, base + extra)
            epoch = result["epochs"][-1]
            runs[label] = {"seconds": seconds, "epochs_run": [e["epoch"] for e in result["epochs"]],
                           "n_steps": epoch["n_steps"], "loop_s": epoch["loop_s"],
                           "first_step_s": epoch["first_step_s"],
                           "loop_ms_per_step": epoch["loop_s"] * 1e3 / epoch["n_steps"],
                           # the steps after the first, whose batches the
                           # prefetch had time to prepare
                           "after_first_ms_per_step": (epoch["loop_s"] - epoch["first_step_s"]) * 1e3
                           / (epoch["n_steps"] - 1),
                           "final_top1": result["final_top1"], "launches": counts}
        teacher_pth = os.path.join(tmp, "teacher.pth")
        teacher = create_model("vit_base_patch16_224", seed=1, **TEACHER_KW)
        torch.save({"model": {k: v.cpu() for k, v in teacher.state_dict().items()}}, teacher_pth)
        del teacher
        ckpt = os.path.join(out, "ckpt", "checkpoint-1.pth")
        result, counts, seconds = _cli_run(attn, cli, CLI_FLAGS + [
            "--data_path", data, "--output_dir", eval_out, "--eval", "--eval_scene", "--run_knn",
            "--finetune", ckpt, "--scene_model_path", teacher_pth])
        runs["eval"] = {"seconds": seconds, "launches": counts, "eval": result.get("eval"),
                        "eval_scene": result.get("eval_scene"), "knn": result.get("knn")}
        tiny_data, tiny_out = os.path.join(tmp, "tiny_filelist"), os.path.join(tmp, "tiny")
        write_tiny_filelists(tiny_data)
        result, counts, seconds = _cli_run(attn, cli, TINY_CLI_FLAGS + ["--data_path", tiny_data,
                                                                        "--output_dir", tiny_out])
        runs["tiny"] = {"seconds": seconds, "launches": counts, "epochs_run": [e["epoch"] for e in result["epochs"]],
                        "final_top1": result.get("final_top1")}
        with open(os.path.join(tiny_out, "log.txt")) as f:
            tiny_records = [json.loads(line) for line in f if line.strip()]
        files = [os.path.join(out, "log.txt"), os.path.join(out, "test", "0.txt"), ckpt,
                 os.path.join(eval_out, "test", "0.txt"), os.path.join(eval_out, "scene_test", "0.txt")]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            fail(f"the CLI left no {missing}")
        with open(files[0]) as f:
            records = [json.loads(line) for line in f if line.strip()]
        rows = {d: len(parse_result_file(os.path.join(eval_out, d, "0.txt"))) for d in ("test", "scene_test")}
        merged = {d: merge_results(os.path.join(eval_out, d), 1) for d in ("test", "scene_test")}
    knn = runs["eval"]["knn"] or {}
    numbers = [v for r in records for k, v in r.items() if k.startswith(("train_", "val_", "final_"))]
    numbers += [v for m in merged.values() for v in m]
    numbers += [v for cells in knn.values() for ks in cells.values() for pair in ks.values() for v in pair]
    numbers += [v for r in tiny_records for k, v in r.items() if k.startswith(("train_", "val_", "final_"))]
    steps = runs["train"]["n_steps"]
    clips = 2 * B  # --num_sample 2
    row = {"phase": "cli", "card": card, "runs": runs, "log_records": len(records), "result_rows": rows,
           "merged": merged, "knn_datasets": sorted(knn), "clips_per_step": clips,
           "loop_ms_per_clip": {k: runs[k]["loop_ms_per_step"] / clips for k in ("train", "resume")},
           "after_first_ms_per_clip": {k: runs[k]["after_first_ms_per_step"] / clips for k in ("train", "resume")},
           "direct_step_ms_per_clip": direct_step_ms / B}
    emit(row)
    if runs["resume"]["epochs_run"] != [1] or runs["train"]["epochs_run"] != [0] or steps != 4:
        fail(f"the CLI ran epochs {runs['train']['epochs_run']} then {runs['resume']['epochs_run']} ({steps} steps)")
    if len(records) != 4 or set(knn) != {"HMDB51", "UCF101", "Diving-48"} or not numbers \
            or not all(np.isfinite(v) for v in numbers) or runs["tiny"]["epochs_run"] != [0] or not tiny_records:
        fail(f"CLI results incomplete or not finite: {row}")
    # K1 on the CLI's path: per train epoch 12 student stats forwards and
    # backwards and 12 teacher forwards per step, 12 student forwards per
    # validation batch and per test batch
    val_b, test_b = -(-CLI_VAL // B), -(-CLI_TEST * 2 // B)
    want_train = {"K1-fwd": 12 * (steps + val_b + test_b), "K1-fwd-stats": 12 * steps, "K1-bwd": 12 * steps}
    # eval: --eval (student), --eval_scene (student + teacher), k-NN over
    # three datasets' train and val lists (student + teacher)
    knn_b = 3 * (-(-CLI_TRAIN // B) + -(-CLI_VAL // B))
    want_eval = {"K1-fwd": 12 * test_b + 24 * test_b + 24 * knn_b}
    for label, want in (("train", want_train), ("resume", want_train), ("eval", want_eval), ("tiny", {})):
        got = {k: v for k, v in runs[label]["launches"].items() if v}
        if got != want:
            fail(f"CLI {label} launched {got}; want {want}")
    return {name: sum(runs[k]["launches"][name] for k in runs) for name in runs["train"]["launches"]}


# samples of the host-rate phase's epoch: 20 batches of 12, 480 clips, long
# against the loader's head start (it submits a whole epoch at once)
CLI_HOST_SAMPLES = 240


def phase_cli_host_rate(card, direct_step_ms: float):
    """The CLI's training loader alone, on the host: the dataset and loader
    that `run_slot_finetuning` builds from CLI_FLAGS, over one epoch of
    CLI_HOST_SAMPLES synthetic samples, nothing sent to the card. Reports
    the clips per second it delivers over the whole epoch and after its
    first batch, beside the clips per second of the direct train step."""
    from devias_tpu_torch.cli import common
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.data import build_dataset

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "train.csv"), "w") as f:
            f.write("\n".join(f"clip{i:03d}.mp4 {i % NUM_CLASSES}" for i in range(CLI_HOST_SAMPLES)))
        args = cli.get_args(CLI_FLAGS + ["--data_path", tmp, "--output_dir", os.path.join(tmp, "out")])
        dataset, _ = build_dataset(True, False, common.make_data_config(args))
        loader = common.make_train_loader(dataset, args)
        loader.set_epoch(0)
        t0 = time.perf_counter()
        arrivals, clips = [], []
        try:
            for batch in loader:
                arrivals.append(time.perf_counter() - t0)
                clips.append(batch["videos"].shape[0])
        finally:
            loader.close()
    n = len(arrivals)
    row = {"phase": "cli_host_rate", "card": card, "host_cpus": os.cpu_count(), "num_workers": args.num_workers,
           "batches": n, "clips": sum(clips), "clip_shape": list(batch["videos"].shape[1:]),
           "first_batch_s": arrivals[0], "epoch_s": arrivals[-1],
           "clips_per_s": sum(clips) / arrivals[-1],
           "clips_per_s_after_first": sum(clips[1:]) / (arrivals[-1] - arrivals[0]),
           "direct_step_clips_per_s": B * 1e3 / direct_step_ms}
    emit(row)
    if n != CLI_HOST_SAMPLES // args.batch_size or set(clips) != {2 * args.batch_size}:
        fail(f"the CLI's loader gave {n} batches of {sorted(set(clips))} clips")


# dp_train: a data axis of two on the one card, 6 of the 12 clips per rank
DP_RANKS = 2
DP_WINDOW = 3


def _dp_batch():
    """The 12 clips of the train phase, their labels and each data shard's
    fixed FAME draws (a donor permutation of its 6 clips and the samples
    that take the mix)."""
    rng = np.random.default_rng(0)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, NUM_CLASSES, size=B)}
    draws_rng = np.random.default_rng(2)
    local = B // DP_RANKS
    draws = [{"perm": torch.from_numpy(draws_rng.permutation(local)),
              "keep": torch.from_numpy(draws_rng.random(local) < 0.8)} for _ in range(DP_RANKS)]
    return batch, draws


def _flagship_step(step_cfg, **layout):
    """The train phase's student, teacher, optimizer, state and step, with
    `step_cfg` and a process layout; and a dict the optimizer fills with
    the watched parameters' (reduced) gradients just before its first
    update."""
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step

    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
    opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10))
    state = TrainState.create(student, opt)
    loss_cfg, _ = _train_parts()
    step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn, **layout)
    params = dict(student.named_parameters())
    grads = {}
    update = opt.step

    def recording_update(*args, **kw):
        if not grads:
            grads.update({n: params[n].grad.float().cpu() for n in TRAIN_WATCH})
        return update(*args, **kw)

    opt.step = recording_update
    return student, state, step, grads


def _time_data_group_gather(videos: np.ndarray, mesh) -> dict:
    """The cost of `over_data_group` (FAME-HVU's and mixup's batch ops
    under DP): this rank's clips gathered into the global micro-batch on
    the card, in float32 and in bfloat16, DP_WINDOW times each after one
    warm-up; bytes of the gathered tensor and host-clock ms per gather."""
    from devias_tpu_torch.core.dist import over_data_group

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(videos).to("cuda", dtype)
        mine = over_data_group(lambda v: (v,), (x,), mesh)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_WINDOW):
            over_data_group(lambda v: (v,), (x,), mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / DP_WINDOW * 1e3
        if not torch.equal(mine, x):
            raise RuntimeError("over_data_group did not give this rank its own rows back")
        out[str(dtype).split(".")[1]] = {"bytes": mesh.data_size * x.numel() * x.element_size(), "ms": ms}
    return out


def dp_rank_main(rank: int, port: int, out: str) -> None:
    """One rank of the dp_train phase, in a process of its own: a gloo
    group of DP_RANKS ranks on the one card, the data-parallel flagship
    step (`make_mesh()`) on this rank's 6 clips with its shard's FAME
    draws, one compared step and DP_WINDOW timed ones, the K1 launches
    counted over them; rank 0 then runs the one-process step with
    `num_data_shards=2` on all 12 clips from the same weights and draws.
    Writes its results to `out`/dp{rank}.pt."""
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import make_mesh
    from devias_tpu_torch.kernels import attention as attn

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=DP_RANKS, rank=rank)
    try:
        _, step_cfg = _train_parts()
        batch, draws = _dp_batch()
        local = B // DP_RANKS
        mine = {k: v[rank * local:(rank + 1) * local] for k, v in batch.items()}
        student, state, step, grads = _flagship_step(step_cfg, dp_mesh=make_mesh())
        attn.reset_launch_counts()
        metrics = step(state, mine, draws=draws[rank], host_metrics=True)
        params = dict(student.named_parameters())
        res = {"metrics": metrics, "grads": grads,
               "params": {n: params[n].detach().float().cpu() for n in TRAIN_WATCH}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_WINDOW):
            step(state, mine, draws=draws[rank])
        torch.cuda.synchronize()
        res["ms_per_step"] = (time.perf_counter() - t0) / DP_WINDOW * 1e3
        res["launches"] = attn.launch_counts()
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["gather"] = _time_data_group_gather(mine["videos"], make_mesh())
        if rank == 0:
            del student, state, step, params
            torch.cuda.empty_cache()
            student, state, step, grads = _flagship_step(dataclasses.replace(step_cfg, num_data_shards=DP_RANKS))
            metrics = step(state, batch, draws=[draws], host_metrics=True)
            params = dict(student.named_parameters())
            res["one_process"] = {"metrics": metrics, "grads": grads,
                                  "params": {n: params[n].detach().float().cpu() for n in TRAIN_WATCH}}
        torch.save(res, os.path.join(out, f"dp{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_dp_train(attn, card):
    """Data parallelism on the one card: DP_RANKS processes (`dp_rank_main`)
    joined by gloo, which all-reduces CUDA tensors through the host (NCCL
    refuses two ranks on one device). The DP step is held to the one-process
    step with `num_data_shards=2` on the same 12 clips and draws: the loss
    within TRAIN_LOSS_TOL, grad_norm and each watched parameter's gradient
    and value after the step within TRAIN_TOL, as train_vs_plain holds
    them; the ranks must end bitwise equal, each with 12 K1-fwd, 12 K1-fwd
    stats and 12 K1-bwd per step. Its ms per step is a two-process gloo run
    on one card, not a DP throughput. Returns the K1 counts of both ranks'
    DP steps."""
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), str(port), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(DP_RANKS)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if any(p.returncode for p in procs):
            fail(f"dp_train ranks exited {[p.returncode for p in procs]}:\n" + "\n".join(logs)[-4000:])
        ranks = [torch.load(os.path.join(tmp, f"dp{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
    ref = ranks[0]["one_process"]
    m, m_ref = ranks[0]["metrics"], ref["metrics"]
    row = {"phase": "dp_train", "card": card, "ranks": DP_RANKS, "backend": "gloo",
           "clips_per_rank": B // DP_RANKS, "steps": 1 + DP_WINDOW, "metrics": m, "metrics_one_process": m_ref,
           "launches": [r["launches"] for r in ranks], "loss_tol": TRAIN_LOSS_TOL, "tol": TRAIN_TOL,
           "gloo_one_card_ms_per_step": [r["ms_per_step"] for r in ranks],
           "peak_memory_gib": [r["peak_memory_gib"] for r in ranks], "grads": {}, "params": {},
           "data_group_gather": [r["gather"] for r in ranks]}
    ok = np.isfinite(m["loss"]) and abs(m["loss"] - m_ref["loss"]) <= TRAIN_LOSS_TOL * abs(m_ref["loss"])
    ok &= abs(m["grad_norm"] - m_ref["grad_norm"]) <= TRAIN_TOL * m_ref["grad_norm"]
    for kind in ("grads", "params"):
        for n in TRAIN_WATCH:
            got, want = ranks[0][kind][n], ref[kind][n]
            err, top = (got - want).abs().max().item(), want.abs().max().item()
            row[kind][n] = {"max_abs_err": err, "max_abs_one_process": top}
            ok &= bool(torch.isfinite(got).all()) and top > 0 and err <= TRAIN_TOL * top
    same = all(ranks[r]["metrics"] == m and all(torch.equal(ranks[r]["params"][n], ranks[0]["params"][n])
                                                 for n in TRAIN_WATCH) for r in range(1, DP_RANKS))
    row["ranks_bitwise_equal"] = same
    emit(row)
    if not (ok and same):
        fail("the data-parallel step disagrees with the one-process step, or its ranks with each other")
    want = {name: 12 * (1 + DP_WINDOW) if name.startswith("K1") else 0 for name in ranks[0]["launches"]}
    for r in ranks:
        if r["launches"] != want:
            fail(f"dp_train launched {r['launches']} on a rank; want {want}")
    return {name: sum(r["launches"][name] for r in ranks) for name in want}


# parallel_modes: the four placements and layouts of item 17 over two gloo
# ranks on the one card, each held to the one-process step
PARALLEL_MODES = ("zero1", "fsdp", "tp", "pp")
PARALLEL_RANKS = 2
PARALLEL_WINDOW = 2
PP_MICRO = 4


def _parallel_batch():
    """The 12 clips of the train phase with dp_train's per-shard FAME draws
    (the two data rows of zero1 and fsdp) and one draw over all 12 clips
    (the one row of tp and pp)."""
    batch, shard_draws = _dp_batch()
    rng = np.random.default_rng(3)
    whole = {"perm": torch.from_numpy(rng.permutation(B)), "keep": torch.from_numpy(rng.random(B) < 0.8)}
    return batch, shard_draws, whole


def parallel_launches_per_step(mode: str) -> dict:
    """K1's launches one rank makes in one step of `mode`, by form and head
    count: the teacher's 12 no-stats forwards at its 12 heads; the
    student's 12 stats forwards and 12 backwards, at 12 / 2 heads under TP
    (each rank its half of the heads) and, under PP, for each of its
    12 / 2 blocks once per micro-batch."""
    depth = heads = 12
    student_heads = heads // PARALLEL_RANKS if mode == "tp" else heads
    per = depth // PARALLEL_RANKS * PP_MICRO if mode == "pp" else depth
    return {"K1-fwd": {heads: depth}, "K1-fwd-stats": {student_heads: per}, "K1-bwd": {student_heads: per}}


def _digests(model, skip=()) -> dict:
    """A hash of each parameter's bytes (those not in `skip`)."""
    import hashlib

    return {n: hashlib.blake2b(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters() if n not in skip}


def parallel_rank_main(rank: int, port: int, out: str) -> None:
    """One rank of the parallel_modes phase, in a process of its own: a gloo
    group of PARALLEL_RANKS ranks on the one card runs the flagship step in
    each mode in turn: `--zero1` and `--fsdp` over two data rows (this
    rank's 6 clips and its shard's FAME draws), TP over one model group of
    two and PP over one pipe group of two with PP_MICRO micro-batches (all
    12 clips, one FAME draw). Per mode: one compared step with K1's
    launches counted by form and head count, the watched gradients and
    parameters gathered whole, the resident bytes of the placed state
    against the replicated one, PARALLEL_WINDOW timed steps with the peak
    memory, and a hash of every parameter both ranks hold whole. Rank 0
    then runs the one-process step with `num_data_shards=2` and with 1 on
    all 12 clips from the same weights and draws. Writes
    `out`/parallel{rank}.pt."""
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import gather_shards, make_mesh, resident_bytes, shard_train_state
    from devias_tpu_torch.core.pipeline import make_pp_mesh
    from devias_tpu_torch.kernels import attention as attn

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=PARALLEL_RANKS, rank=rank)
    try:
        _, step_cfg = _train_parts()
        batch, shard_draws, whole = _parallel_batch()
        local = B // PARALLEL_RANKS
        res = {}
        for mode in PARALLEL_MODES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cfg, data, draws = step_cfg, batch, whole
            if mode in ("zero1", "fsdp"):
                mesh = make_mesh()
                layout = {"dp_mesh": mesh}
                data = {k: v[rank * local:(rank + 1) * local] for k, v in batch.items()}
                draws = shard_draws[rank]
            elif mode == "tp":
                mesh = make_mesh(model_parallel=PARALLEL_RANKS)
                layout = {"dp_mesh": mesh}
            else:
                mesh = make_pp_mesh(PARALLEL_RANKS)
                layout = {"pp_mesh": mesh}
                cfg = dataclasses.replace(step_cfg, pp_microbatches=PP_MICRO)
            student, state, step, grads = _flagship_step(cfg, **layout)
            replicated = resident_bytes(state)
            shard_train_state(state, mesh, zero1=mode == "zero1", fsdp=mode == "fsdp", tp=mode == "tp")
            pl = state.placement
            attn.reset_launch_counts()
            metrics = step(state, data, draws=draws, host_metrics=True)
            torch.cuda.synchronize()
            by_heads, counts = attn.launch_counts_by_heads(), attn.launch_counts()
            resident = resident_bytes(state)
            params = dict(student.named_parameters())
            cut = {} if pl is None or pl.full else pl.params
            watched = [n for n in TRAIN_WATCH if n in cut]

            def whole_of(tensors):
                full = gather_shards([tensors[n].to("cuda") for n in watched], [cut[n] for n in watched])
                return {n: dict(zip(watched, full)).get(n, tensors[n]).float().cpu() for n in TRAIN_WATCH}

            grads_whole = whole_of(grads) if mode == "tp" else {n: g.float().cpu() for n, g in grads.items()}
            params_whole = whole_of({n: params[n].detach() for n in TRAIN_WATCH})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PARALLEL_WINDOW):
                step(state, data, draws=draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PARALLEL_WINDOW * 1e3
            counts_window = attn.launch_counts()
            if pl is not None:
                pl.gather_params()
            res[mode] = {"metrics": metrics, "grads": grads_whole, "params": params_whole,
                         "launches_by_heads": by_heads, "launches_first_step": counts, "launches": counts_window,
                         "gloo_one_card_ms_per_step": ms,
                         "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "resident_bytes": resident, "replicated_bytes": replicated,
                         "digests": _digests(student, pl.params if mode == "tp" else ())}
            del student, state, step, grads, params, pl
        if rank == 0:
            for shards, draws in ((2, [shard_draws]), (1, whole)):
                torch.cuda.empty_cache()
                student, state, step, grads = _flagship_step(dataclasses.replace(step_cfg, num_data_shards=shards))
                metrics = step(state, batch, draws=draws, host_metrics=True)
                params = dict(student.named_parameters())
                res[f"one_process_{shards}"] = {
                    "metrics": metrics, "grads": {n: g.float().cpu() for n, g in grads.items()},
                    "params": {n: params[n].detach().float().cpu() for n in TRAIN_WATCH}}
                del student, state, step, grads, params
        torch.save(res, os.path.join(out, f"parallel{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_parallel_modes(attn, card):
    """ZeRO-1, FSDP, TP and PP on the one card: PARALLEL_RANKS processes
    (`parallel_rank_main`) joined by gloo, which moves CUDA tensors through
    the host (NCCL refuses two ranks on one device); PP's stage hand-offs
    go through pinned host buffers. Each mode is held to the one-process
    step on the same weights and draws (`num_data_shards=2` for the two data
    rows of zero1 and fsdp, 1 for the one row of tp and pp): the loss within
    TRAIN_LOSS_TOL, grad_norm and each watched parameter's gradient and
    value after the step within TRAIN_TOL; the ranks must hold every
    parameter they both hold whole bitwise equal, and launch K1 as
    `parallel_launches_per_step` derives. The ms per step printed is a
    two-process gloo run on one card, not a throughput. Then the port's dry
    run, `dryrun_multichip(2)`, on the card. Returns the K1 counts of both
    ranks' steps."""
    from devias_tpu_torch.dryrun import dryrun_multichip

    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r), str(port),
                                   tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(PARALLEL_RANKS)]
        try:
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if any(p.returncode for p in procs):
            fail(f"parallel_modes ranks exited {[p.returncode for p in procs]}:\n" + "\n".join(logs)[-4000:])
        ranks = [torch.load(os.path.join(tmp, f"parallel{r}.pt"), weights_only=False) for r in range(PARALLEL_RANKS)]
        seconds = time.perf_counter() - t0
    total = {}
    for mode in PARALLEL_MODES:
        ref = ranks[0][f"one_process_{2 if mode in ('zero1', 'fsdp') else 1}"]
        got = [r[mode] for r in ranks]
        m, m_ref = got[0]["metrics"], ref["metrics"]
        want = parallel_launches_per_step(mode)
        row = {"phase": "parallel_modes", "mode": mode, "card": card, "ranks": PARALLEL_RANKS, "backend": "gloo",
               "pp_hand_off": "pinned host buffers" if mode == "pp" else None,
               "metrics": m, "metrics_one_process": m_ref, "loss_tol": TRAIN_LOSS_TOL, "tol": TRAIN_TOL,
               "k1_launches_per_step": [r["launches_by_heads"] for r in got], "k1_want_per_step": want,
               "gloo_one_card_ms_per_step": [r["gloo_one_card_ms_per_step"] for r in got],
               "peak_memory_gib": [r["peak_memory_gib"] for r in got],
               "resident_bytes": [r["resident_bytes"] for r in got], "replicated_bytes": got[0]["replicated_bytes"],
               "grads": {}, "params": {}}
        ok = np.isfinite(m["loss"]) and abs(m["loss"] - m_ref["loss"]) <= TRAIN_LOSS_TOL * abs(m_ref["loss"])
        ok &= abs(m["grad_norm"] - m_ref["grad_norm"]) <= TRAIN_TOL * m_ref["grad_norm"]
        for kind in ("grads", "params"):
            for n in TRAIN_WATCH:
                g, w = got[0][kind][n], ref[kind][n]
                err, top = (g - w).abs().max().item(), w.abs().max().item()
                row[kind][n] = {"max_abs_err": err, "max_abs_one_process": top}
                ok &= bool(torch.isfinite(g).all()) and top > 0 and err <= TRAIN_TOL * top
        same = got[1]["metrics"] == m and got[1]["digests"] == got[0]["digests"]
        row["ranks_bitwise_equal"] = same
        row["parameters_compared_bitwise"] = len(got[0]["digests"])
        emit(row)
        if not (ok and same):
            fail(f"parallel_modes {mode}: disagrees with the one-process step, or its ranks with each other")
        for r in got:
            by_heads = r["launches_by_heads"]
            other = {k: n for k, n in r["launches_first_step"].items() if k not in want and n}
            window_want = {k: sum(want[k].values()) * (1 + PARALLEL_WINDOW) if k in want else 0
                           for k in r["launches"]}
            if by_heads != want or other or r["launches"] != window_want:
                fail(f"parallel_modes {mode}: K1 launched {by_heads} in a step (want {want}), "
                     f"{r['launches']} over all steps (want {window_want}), others {other}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    emit({"phase": "parallel_modes_script", "card": card, "seconds": seconds})
    t0 = time.perf_counter()
    try:
        dryrun_multichip(PARALLEL_RANKS)
    except RuntimeError as exc:
        fail(f"dryrun_multichip({PARALLEL_RANKS}): {exc}")
    emit({"phase": "dryrun", "card": card, "processes": PARALLEL_RANKS, "seconds": time.perf_counter() - t0})
    return total


K1_FORMS = ("K1-fwd", "K1-fwd-stats", "K1-bwd")


def _check_k1(phase: str, counts: dict, want: dict) -> None:
    """Fail unless the K1 forms launched `want` times and no other kernel ran."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        fail(f"{phase} launched {counts}; want {full}")


def phase_overfit(attn, card):
    """`python -m devias_tpu_torch.scripts.full_scale_overfit` at its
    defaults, in-process: 200 steps of the flagship slot step (the CLS
    teacher, no FAME) memorising 12 fixed clips, its asserts those of
    `scripts/full_scale_overfit.py:63-65`. Prints the loss at steps 0 and
    199, the accuracy at 199, the first step whose accuracy reached 1.0, ms
    per step from step 1 on, and K1's launches: 12 of each form per step.
    Returns the K1 counts."""
    from devias_tpu_torch.scripts import full_scale_overfit as overfit

    attn.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = overfit.main([])
    except AssertionError as exc:
        fail(f"overfit: an assert of the JAX script failed: {exc!r}")
    seconds = time.perf_counter() - t0
    counts = attn.launch_counts()
    (_, m0), (s_last, m_last) = result["history"][0], result["history"][-1]
    emit({"phase": "overfit", "card": card, "steps": overfit.STEPS, "clips": overfit.B, "loss_step0": m0["loss"],
          "loss_last": m_last["loss"], "acc_last": m_last["class_acc"], "last_step": s_last,
          "first_step_acc_1": result["first_full_acc_step"], "ms_per_step": result["ms_per_step"],
          "wall_s": result["wall_s"], "seconds": seconds, "launches": counts})
    _check_k1("overfit", counts, {name: 12 * overfit.STEPS for name in K1_FORMS})
    del result
    torch.cuda.empty_cache()
    return counts


HEALTH_STEPS = 1000  # half the script's default 2000, for the script's time limit


def phase_health_run(attn, card):
    """`python -m devias_tpu_torch.scripts.health_run --steps HEALTH_STEPS`,
    in-process (its other defaults): HVU steps with FAME-HVU, the cosine schedule and the
    EMA on the 60-clip pool held on the card, then the disentanglement
    probe; its asserts those of `scripts/health_run.py:213-225`. Prints the
    loss at the first and last steps, steps/s, the four readings of the parameters
    and of the EMA, and of the EMA with its share of the initial weights
    taken out (read after the counts), the held-out pair, peak memory and
    K1's launches: 12
    stats forwards and 12 backwards per step, and 12 no-stats forwards per
    probe batch of 12 (the pool twice, the held-out clips once). Returns
    the K1 counts."""
    from devias_tpu_torch.scripts import health_run

    torch.cuda.reset_peak_memory_stats()
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = health_run.main(["--steps", str(HEALTH_STEPS)])
    except AssertionError as exc:
        fail(f"health_run: an assert of the JAX script failed: {exc!r}")
    seconds = time.perf_counter() - t0
    counts = attn.launch_counts()
    (_, m0), (s_last, m_last) = result["history"][0], result["history"][-1]
    steps, pool = s_last + 1, 5 * health_run.N_MOTION * health_run.N_SCENE
    # the EMA holds decay^steps of the initial weights (0.999^1000 = 0.368):
    # the probe of the EMA with that share taken out, (ema - share * init) /
    # (1 - share), on the same pool; not a launch of the run
    state = result["state"]
    share = state.ema_decay ** state.step
    unbiased, init = health_run.ema_model(state), dict(health_run.health_model("cuda").named_parameters())
    with torch.no_grad():
        for name, p in unbiased.named_parameters():
            p.sub_(share * init[name]).div_(1 - share)
    videos, action, scene = health_run.make_pool(np.random.default_rng(0), 5)
    ema_unbiased = health_run.slot_accuracies(unbiased, torch.from_numpy(videos).cuda(), action, scene,
                                              health_run.N_MOTION)
    del unbiased, init, videos
    emit({"phase": "health_run", "card": card, "steps": steps, "clips": health_run.B, "pool": pool,
          "loss_step0": m0["loss"], "loss_last": m_last["loss"], "last_step": s_last, "metrics_last": m_last,
          "steps_per_s": result["steps_per_s"], "train": result["train"], "ema": result["ema"],
          "ema_start_share": share, "ema_without_start": ema_unbiased,
          "held_out": {k: result["held_out"][k] for k in ("action_slot_motion", "scene_slot_scene")},
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "seconds": seconds, "launches": counts})
    probe_batches = 2 * pool // health_run.B + 1
    _check_k1("health_run", counts, {"K1-fwd": 12 * probe_batches, "K1-fwd-stats": 12 * steps,
                                     "K1-bwd": 12 * steps})
    del result
    torch.cuda.empty_cache()
    return counts


def phase_profile_step(attn, card):
    """`python -m devias_tpu_torch.scripts.profile_step --out DIR` at its
    other defaults: 3 warm-up steps of the flagship FAME step, then 5 under
    `profile_trace`, and the trace's aggregation. Prints the card's ms per
    step and ms per step by kernel family; K1 launches 12 of each form per
    step. Returns the K1 counts."""
    from devias_tpu_torch.scripts import profile_step

    with tempfile.TemporaryDirectory() as out:
        attn.reset_launch_counts()
        report = profile_step.main(["--out", out])
        counts = attn.launch_counts()
    steps = report["steps"]
    emit({"phase": "profile_step", "card": card, "steps": steps, "device_ms_per_step": report["device_ms_per_step"],
          "ms_per_step_by_family": report["ms_per_step_by_family"], "tail_ms_per_step": report["tail_ms_per_step"],
          "top5": report["top"][:5], "launches": counts})
    if not report["device_ms_per_step"] > 0:
        fail(f"profile_step: the trace holds no kernel on the card: {report}")
    _check_k1("profile_step", counts, {name: 12 * (profile_step.WARMUP_STEPS + steps) for name in K1_FORMS})
    return counts


# the hat phase: Kinetics-HAT assets, one version dir of three splits of
# HAT_RECORDS records, HAT_FRAMES frames of 240x320 (16 frames at sampling
# rate 4); 6 test views a record (2 segments x 3 crops)
HAT_RECORDS = 2
HAT_FRAMES = 64
HAT_HW = (240, 320)


def write_hat_assets(root: str):
    """Synthetic Kinetics-HAT assets written with PIL (the layout of
    `tests/test_hat.py`): per record a foreground video with its person
    masks, an inpainted background video with its masks, and the
    actionswap pickles of far/1-3 with labels.csv two directories above
    them. Returns (data prefix, version dir)."""
    import pickle

    from PIL import Image

    data = os.path.join(root, "data")
    h, w = HAT_HW
    rng = np.random.default_rng(3)

    def video(kind, name, color, box):
        fdir, mdir = os.path.join(data, kind, name), os.path.join(data, "seg/videos", name)
        os.makedirs(fdir, exist_ok=True)
        os.makedirs(mdir, exist_ok=True)
        y, x = box
        for i in range(HAT_FRAMES):
            frame = np.clip(color + rng.integers(-25, 25, size=(h, w, 3)), 0, 255).astype(np.uint8)
            frame[y:y + 96, x + i:x + i + 48] = 250  # the "person", walking
            mask = np.zeros((h, w), np.uint8)
            mask[y:y + 96, x + i:x + i + 48] = 255
            Image.fromarray(frame).save(os.path.join(fdir, f"{i + 1:06d}.jpg"), quality=90)
            Image.fromarray(mask).save(os.path.join(mdir, f"{i + 1:06d}.png"))

    for r in range(HAT_RECORDS):
        video("original/videos", f"fg{r}.mp4", 40 + 40 * r, (20 + 30 * r, 30))
        video("inpaint/videos", f"bg{r}.mp4", 200 - 40 * r, (120, 150 - 60 * r))
    version = os.path.join(root, "hat", "kinetics", "far")
    os.makedirs(version)
    with open(os.path.join(root, "hat", "kinetics", "labels.csv"), "w") as f:
        f.write("".join(f"{c},class{c}\n" for c in range(3)))
    anno = {f"class{r % 3}/fg{r}.mp4": (f"x/bg{r}.mp4", HAT_FRAMES) for r in range(HAT_RECORDS)}
    for split in (1, 2, 3):
        with open(os.path.join(version, f"actionswap_far_{split}.pickle"), "wb") as f:
            pickle.dump(anno, f)
    return data, version


def phase_hat(attn, card):
    """The port's CLI in-process at full width with --hat_eval on synthetic
    Kinetics-HAT assets: once with action targets, once with --eval_scene,
    on the CLI's seeded flagship student and scene teacher. Fails on a
    missing result file, a non-finite accuracy, or K1 counts other than 12
    K1-fwd per student batch (and 12 more per teacher batch in the scene
    run)."""
    from devias_tpu_torch.cli import run_slot_finetuning as cli

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data, version = write_hat_assets(tmp)
        write_s = time.perf_counter() - t0
        base = ["--model", "slot_vit_base_patch16_224", "--num_latents", "2", "--agg_depth", "8", "--agg_weights_tie",
                "--batch_size", str(B), "--data_set", "Kinetics-400", "--data_prefix", data, "--hat_eval",
                "--hat_anno_path", version]
        for label, extra in (("action", []), ("scene", ["--eval_scene"])):
            out = os.path.join(tmp, label)
            result, counts, seconds = _cli_run(attn, cli, base + extra + ["--output_dir", out])
            files = [os.path.join(out, "hat", "far", str(s), name) for s in (1, 2, 3) for name in ("0.txt", "log.txt")]
            missing = [f for f in files if not os.path.exists(f)]
            if missing:
                fail(f"--hat_eval ({label}) left no {missing}")
            splits = []
            for s in (1, 2, 3):
                with open(os.path.join(out, "hat", "far", str(s), "log.txt")) as f:
                    splits.append(json.loads(f.read()))
            runs[label] = {"seconds": seconds, "launches": counts, "hat": result.get("hat"), "splits": splits}
    batches = 3 * -(-6 * HAT_RECORDS // B)  # three splits of 6 views a record
    row = {"phase": "hat", "card": card, "records": HAT_RECORDS, "frames": HAT_FRAMES, "frame_hw": list(HAT_HW),
           "views_per_split": 6 * HAT_RECORDS, "assets_write_s": write_s, "runs": runs}
    emit(row)
    numbers = [v for r in runs.values() for sp in r["splits"] for v in sp.values()]
    numbers += [v for r in runs.values() for acc in (r["hat"] or {}).values() for v in acc.values()]
    if len(numbers) != 2 * (3 * 2 + 2) or not all(np.isfinite(v) for v in numbers):
        fail(f"--hat_eval results incomplete or not finite: {row}")
    for label, per_batch in (("action", 12), ("scene", 24)):
        got = {k: v for k, v in runs[label]["launches"].items() if v}
        if got != {"K1-fwd": per_batch * batches}:
            fail(f"--hat_eval ({label}) launched {got}; want {{'K1-fwd': {per_batch * batches}}}")
    return {name: sum(r["launches"][name] for r in runs.values()) for name in runs["action"]["launches"]}


# hvu_train / hvu_cli: the HVU CLI's model (739 + 248 head, 4 latents, 4
# untied agg layers, its default drop-path 0.1) with FAME-HVU
HVU_ACTION, HVU_SCENE = 739, 248
HVU_WINDOW = 10
HVU_WATCH = ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight", "agg_block.layers.3.0.fn.to_q.weight")


def _hvu_parts(argv=()):
    """The HVU CLI's args (`--mask_model FAME`), its loss and step configs."""
    from devias_tpu_torch.aug import FAMEConfig
    from devias_tpu_torch.cli import run_slot_finetuning_hvu as hvu
    from devias_tpu_torch.losses import SlotLossConfig
    from devias_tpu_torch.train import TrainStepConfig

    args = hvu.get_args(["--mask_model", "FAME", *argv])
    loss_cfg = SlotLossConfig(HVU_ACTION, HVU_SCENE, mask_prediction_loss_weight=args.mask_prediction_loss_weight,
                              mask_distill_loss_weight=args.mask_distill_loss_weight)
    step_cfg = TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=args.beta, prob_aug=args.prob_aug))
    return args, loss_cfg, step_cfg


def _hvu_batch(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"videos": rng.standard_normal((n,) + CLIPS[1:], dtype=np.float32),
            "labels": rng.integers(0, HVU_ACTION, size=n), "scene_labels": rng.integers(0, HVU_SCENE, size=n)}


def _held(row: dict, loss_f: float, loss_p: float, grads_f: dict, grads_p: dict) -> bool:
    """train_vs_plain's limits: the loss within TRAIN_LOSS_TOL of the plain
    step's, each watched gradient within TRAIN_TOL of the plain gradient's
    largest magnitude; the numbers go into `row`."""
    row.update(loss_fused=loss_f, loss_plain=loss_p, loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_TOL, grads={})
    ok = np.isfinite(loss_f) and abs(loss_f - loss_p) <= TRAIN_LOSS_TOL * abs(loss_p)
    for n in grads_f:
        err = (grads_f[n] - grads_p[n]).abs().max().item()
        ref = grads_p[n].abs().max().item()
        finite = bool(torch.isfinite(grads_f[n]).all().item())
        row["grads"][n] = {"max_abs_err": err, "max_abs_plain": ref, "finite": finite}
        ok &= finite and ref > 0 and err <= TRAIN_TOL * ref
    return ok


def _fused_vs_plain(build, loss_of, watch):
    """(loss, watched gradients) of one micro-batch through `build(fused)`'s
    model in train mode, for fused and plain attention on the same weights,
    the same draws and a generator in the same state; `watch` None: every
    parameter that has a gradient."""
    out = {}
    for fused in (True, False):
        model = build(fused).train()
        total = loss_of(model, torch.Generator(device="cuda").manual_seed(3))
        total.backward()
        params = dict(model.named_parameters())
        out[fused] = (total.item(), {n: p.grad.float().clone() for n, p in params.items()
                                     if (watch is None or n in watch) and p.grad is not None})
        del model, total, params
        torch.cuda.empty_cache()
    return out[True], out[False]


def _group_errors(grads_f: dict, grads_p: dict) -> dict:
    """The fused-vs-plain gradient error by parameter group (each block,
    else the top-level module): the group's largest absolute error, its
    plain gradients' largest magnitude and their ratio."""
    groups = {}
    for n, gp in grads_p.items():
        parts = n.split(".")
        g = ".".join(parts[:2]) if parts[0] == "blocks" else parts[0]
        err, ref = groups.get(g, (0.0, 0.0))
        groups[g] = (max(err, (grads_f[n] - gp).abs().max().item()), max(ref, gp.abs().max().item()))
    return {g: {"max_abs_err": e, "max_abs_plain": r, "share": e / r if r else None} for g, (e, r) in groups.items()}


def phase_hvu_train(attn, card):
    """The HVU train step (`make_hvu_train_step`) at full width on the HVU
    CLI's model, B=12, FAME-HVU: TRAIN_STEPS counted steps (12 K1-fwd stats
    and 12 K1-bwd per step, no teacher, so no K1-fwd), finite metrics,
    parameters changed; HVU_WINDOW timed steps (ms/step, clips/s, peak
    memory); then hvu_vs_plain: one micro-batch of 2 clips with fixed FAME
    draws through fused and plain attention, held as train_vs_plain holds
    the slot step. Returns the K1 counts and ms per step."""
    from devias_tpu_torch.cli import run_slot_finetuning_hvu as hvu
    from devias_tpu_torch.train import OptimConfig, TrainState, make_hvu_train_step, make_optimizer
    from devias_tpu_torch.train.step import hvu_loss

    dev = torch.device("cuda")
    args, loss_cfg, step_cfg = _hvu_parts()
    t0 = time.perf_counter()
    model = hvu.build_hvu_model(args, dev)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10,
                                                   agg_block_scale=args.agg_block_scale))
    state = TrainState.create(model, opt)
    step = make_hvu_train_step(model, opt, loss_cfg, step_cfg, lr_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = _hvu_batch(B, 0)
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in HVU_WATCH}
    setup_s = time.perf_counter() - t0

    attn.reset_launch_counts()
    history = [step(state, batch, generator=gen, host_metrics=True) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = attn.launch_counts()
    changed = {n: (params[n].detach() - before[n]).abs().max().item() for n in HVU_WATCH}
    finite = all(np.isfinite(v) for m in history for v in m.values())
    counted_steps = state.step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(HVU_WINDOW):
        metrics = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    ms = window_s / HVU_WINDOW * 1e3
    emit({"phase": "hvu_train", "card": card, "steps": TRAIN_STEPS, "clips_per_step": B, "setup_s": setup_s,
          "metrics": history, "launches": counts, "param_max_change": changed, "window_steps": HVU_WINDOW,
          "ms_per_step": ms, "clips_per_s": HVU_WINDOW * B / window_s,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "loss": float(metrics["loss"])})
    want = {name: 12 * TRAIN_STEPS if name in ("K1-fwd-stats", "K1-bwd") else 0 for name in counts}
    if counts != want:
        fail(f"hvu_train launches {counts}; want {want} (12 K1-fwd stats and 12 K1-bwd per step)")
    if not finite or counted_steps != TRAIN_STEPS or not all(v > 0 for v in changed.values()):
        fail(f"hvu_train steps wrong: finite={finite} step={counted_steps} changes={changed}")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    del model, opt, state, step, params
    torch.cuda.empty_cache()

    videos = torch.from_numpy(_hvu_batch(2, 1)["videos"]).to(dev)
    small = _hvu_batch(2, 1)
    action, scene = (torch.from_numpy(small[k]).to(dev) for k in ("labels", "scene_labels"))
    draws = {"perm": torch.tensor([1, 0], device=dev), "keep": torch.tensor([True, True], device=dev)}

    def build(fused):
        m = hvu.build_hvu_model(args, dev) if fused else _plain(hvu.build_hvu_model(args, dev))
        m.load_state_dict(sd)
        return m

    (loss_f, grads_f), (loss_p, grads_p) = _fused_vs_plain(
        build, lambda m, g: hvu_loss(m, videos, action, scene, loss_cfg, step_cfg, g, draws)[0], HVU_WATCH)
    row = {"phase": "hvu_vs_plain", "card": card, "clips": 2}
    ok = _held(row, loss_f, loss_p, grads_f, grads_p)
    emit(row)
    if not ok:
        fail("fused and plain HVU train steps disagree beyond their limits")
    return counts, ms


def _plain(model):
    """`model` with the plain attention in every block: each `Attention`'s
    kernel flag turned off (a model with none fails)."""
    from devias_tpu_torch.nn.vit import Attention

    blocks = [m for m in model.modules() if isinstance(m, Attention)]
    if not blocks or not all(m.fused for m in blocks):
        fail("the CLI built a model without K1 in every block")
    for m in blocks:
        m.fused = False
    return model


# the hvu_cli phase: 24 training samples (2 steps of 12, each drawn twice by
# --num_sample 2), 12 validation samples, SEEN and UNSEEN lists of 12
HVU_CLI_TRAIN, HVU_CLI_VAL = 24, 12
HVU_CLI_FLAGS = ["--mask_model", "FAME", "--batch_size", str(B), "--synthetic_data", "--epochs", "1"]


def phase_hvu_cli(attn, card):
    """`devias_tpu_torch.cli.run_slot_finetuning_hvu` in-process at full
    width on synthetic HVU filelists and 16x240x320 clips: a 2-step epoch
    with validation (action and scene top-1) and its checkpoint; then
    `eval_slot_finetuning_hvu` on a SEEN/UNSEEN pair with that checkpoint:
    the four blocks, finite. K1 counts: 12 K1-fwd stats and 12 K1-bwd per
    step, 12 K1-fwd per validation batch and per eval batch."""
    from devias_tpu_torch.cli import eval_slot_finetuning_hvu as hvu_eval
    from devias_tpu_torch.cli import run_slot_finetuning_hvu as hvu

    with tempfile.TemporaryDirectory() as tmp:
        for name, n in (("train.csv", HVU_CLI_TRAIN), ("val.csv", HVU_CLI_VAL), ("seen.csv", HVU_CLI_VAL),
                        ("unseen.csv", HVU_CLI_VAL)):
            with open(os.path.join(tmp, name), "w") as f:
                f.write("\n".join(f"{name[0]}{i:03d} {(7 * i) % HVU_ACTION} {(5 * i) % HVU_SCENE}" for i in range(n)))
        out = os.path.join(tmp, "out")
        result, train_counts, train_s = _cli_run(attn, hvu, HVU_CLI_FLAGS + ["--data_path", tmp, "--output_dir", out])
        with open(os.path.join(out, "log.txt")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        ckpt = os.path.join(out, "ckpt", "checkpoint-0.pth")
        if not os.path.exists(ckpt):
            fail("the HVU CLI left no checkpoint")
        blocks, eval_counts, eval_s = _cli_run(attn, hvu_eval, [
            "--batch_size", str(B), "--synthetic_data", "--finetune", ckpt,
            "--anno_path", os.path.join(tmp, "seen.csv"), os.path.join(tmp, "unseen.csv")])
    epoch = result["epochs"][0]
    steps = epoch["n_steps"]
    row = {"phase": "hvu_cli", "card": card, "train_s": train_s, "n_steps": steps,
           "loop_ms_per_step": epoch["loop_s"] * 1e3 / steps, "clips_per_step": 2 * B, "records": records,
           "train_launches": train_counts, "eval_s": eval_s, "eval_blocks": blocks, "eval_launches": eval_counts}
    emit(row)
    numbers = [v for r in records for k, v in r.items() if k.startswith(("train_", "val_"))]
    numbers += [v for b in blocks.values() for v in b.values()]
    if steps != HVU_CLI_TRAIN // B or len(records) != 1 or "val_scene_acc1" not in records[0] \
            or set(blocks) != {"action_seen", "scene_seen", "action_unseen", "scene_unseen"} \
            or not all(np.isfinite(v) for v in numbers):
        fail(f"HVU CLI results incomplete or not finite: {row}")
    val_b = -(-HVU_CLI_VAL // B)
    for label, got, want in (
            ("train", train_counts, {"K1-fwd": 12 * val_b, "K1-fwd-stats": 12 * steps, "K1-bwd": 12 * steps}),
            ("eval", eval_counts, {"K1-fwd": 12 * 2 * val_b})):
        got = {k: v for k, v in got.items() if v}
        if got != want:
            fail(f"HVU CLI {label} launched {got}; want {want}")
    return {name: train_counts[name] + eval_counts[name] for name in train_counts}


CLASS_WINDOW = 10
CLASS_WATCH = ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight", "head.weight")
# (label, classes, CLS token): the baseline action model at 400 classes,
# mean-pooled; the Places-365 scene model with the CLS token, 1569 tokens
CLASS_CONFIGS = (("mean_pool_400", 400, False), ("cls_365", 365, True))


def phase_class_train(attn, card):
    """The classification train step (`make_classification_train_step`)
    at full width on `vit_base_patch16_224` as `run_class_finetuning`
    builds it, B=12, mixup / CutMix on (`--mixup 0.8 --cutmix 1.0`, soft
    targets), AdamW: for each of CLASS_CONFIGS, TRAIN_STEPS counted steps
    (12 K1-fwd stats and 12 K1-bwd per step), HVU_WINDOW timed ones
    (ms/step), and one micro-batch of 2 clips with fixed mixup draws
    through fused and plain attention, held as train_vs_plain holds the
    slot step. Returns the K1 counts and ms per step by config."""
    from devias_tpu_torch.cli import run_class_finetuning as cls_cli
    from devias_tpu_torch.losses import soft_target_cross_entropy
    from devias_tpu_torch.train import (
        OptimConfig,
        TrainState,
        make_classification_train_step,
        make_optimizer,
    )
    from devias_tpu_torch.train.step import classification_loss

    dev = torch.device("cuda")
    total_counts, ms_by = None, {}
    for label, classes, use_cls in CLASS_CONFIGS:
        args = cls_cli.get_args(["--nb_classes", str(classes), "--mixup", "0.8", "--cutmix", "1.0"]
                                + (["--use_cls"] if use_cls else []))
        criterion, mixup_cfg = cls_cli.make_criterion(args)
        model = cls_cli.build_class_model(args, dev)
        opt, lr_fn = make_optimizer(model, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10, layer_decay=0.75))
        state = TrainState.create(model, opt)
        step = make_classification_train_step(model, opt, criterion, 1, lr_fn, mixup_cfg=mixup_cfg)
        rng = np.random.default_rng(2)
        batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, classes, size=B)}
        counts, ms_by[label], first = _step_phase(
            attn, card, {"phase": "class_train", "config": label, "classes": classes, "cls_token": use_cls,
                         "tokens": 1568 + use_cls, "mixup": dataclasses.asdict(mixup_cfg)},
            step, state, batch, {"K1-fwd-stats": 12, "K1-bwd": 12}, CLASS_WINDOW)
        if set(first) != {"loss", "class_acc", "grad_norm", "lr"}:
            fail(f"class_train {label}: metrics {sorted(first)}")
        total_counts = counts if total_counts is None else {k: total_counts[k] + counts[k] for k in counts}
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        del model, opt, state, step
        torch.cuda.empty_cache()

        small = {"videos": torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev),
                 "labels": torch.tensor([1, classes - 1], device=dev)}
        draws = {"mix": torch.tensor([True]), "switch": torch.tensor([True]), "lam_mix": torch.tensor([0.7]),
                 "lam_cut": torch.tensor([0.6]), "cy": torch.tensor([100]), "cx": torch.tensor([120])}

        def build(fused):
            m = cls_cli.build_class_model(args, dev) if fused else _plain(cls_cli.build_class_model(args, dev))
            m.load_state_dict(sd)
            return m

        (loss_f, grads_f), (loss_p, grads_p) = _fused_vs_plain(
            build, lambda m, g: classification_loss(m, small["videos"], small["labels"], soft_target_cross_entropy,
                                                    mixup_cfg=mixup_cfg, generator=g, draws=draws)[0], CLASS_WATCH)
        row = {"phase": "class_vs_plain", "card": card, "config": label, "clips": 2}
        ok = _held(row, loss_f, loss_p, grads_f, grads_p)
        emit(row)
        if not ok:
            fail(f"fused and plain classification steps ({label}) disagree beyond their limits")
    return total_counts, ms_by


# the short CLI phases' data (class_cli, downstream_cli, mt_cli): 24
# training samples (2 steps of 12, each drawn twice by --num_sample 2), 12
# validation and 12 test clips (24 test views in 2 batches)
SHORT_TRAIN, SHORT_VAL, SHORT_TEST = 24, 12, 12
SHORT_VIEWS = ["--test_num_segment", "1", "--test_num_crop", "2", "--batch_size", str(B), "--synthetic_data"]
# the class_cli phase: the scene-model recipe (--use_cls, 365 classes,
# labels from a CLS teacher) with SGD
CLASS_CLI_FLAGS = ["--use_cls", "--nb_classes", "365", "--opt", "sgd", "--lr", "0.01", "--data_set",
                   "Kinetics-400"] + SHORT_VIEWS


def _write_filelists(path: str, classes: int) -> None:
    """train.csv, val.csv and test.csv of SHORT_TRAIN, SHORT_VAL and
    SHORT_TEST synthetic clips (`<prefix><i>.mp4 <label>`), labels
    cycling over `classes`."""
    for name, n in (("train.csv", SHORT_TRAIN), ("val.csv", SHORT_VAL), ("test.csv", SHORT_TEST)):
        with open(os.path.join(path, name), "w") as f:
            f.write("\n".join(f"{name[0]}{i:03d}.mp4 {(7 * i) % classes}" for i in range(n)))


def _train_then_eval(attn, cli, base, train_argv, eval_argv, out):
    """The CLI's one-epoch training run into `out`, then its evaluation of
    that run's checkpoint. Returns (train result, log.txt records, train
    counts, train s, eval result, eval counts, eval s)."""
    result, train_counts, train_s = _cli_run(attn, cli, base + train_argv + ["--epochs", "1", "--output_dir", out])
    with open(os.path.join(out, "log.txt")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    ckpt = os.path.join(out, "ckpt", "checkpoint-0.pth")
    if not os.path.exists(ckpt):
        fail(f"{cli.__name__} left no checkpoint")
    again, eval_counts, eval_s = _cli_run(attn, cli, base + eval_argv + [
        "--finetune", ckpt, "--output_dir", out + "_eval"])
    return result, records, train_counts, train_s, again, eval_counts, eval_s


def _cli_row(phase, card, runs, **extra):
    """Emit a CLI phase's row from `_train_then_eval`'s `runs`; returns it."""
    result, records, train_counts, train_s, again, eval_counts, eval_s = runs
    epoch = result["epochs"][0]
    row = {"phase": phase, "card": card, "train_s": train_s, "n_steps": epoch["n_steps"],
           "loop_ms_per_step": epoch["loop_s"] * 1e3 / epoch["n_steps"], "clips_per_step": 2 * B,
           "records": records, "final_top1": result.get("final_top1"), "train_launches": train_counts,
           "eval_s": eval_s, "eval": again.get("eval"), "eval_launches": eval_counts, **extra}
    emit(row)
    return row


def _check_cli(name, row, runs, want_train, want_eval):
    """A CLI phase's checks on `_train_then_eval`'s `runs`: 2 steps, finite
    records, the evaluation of the trained checkpoint giving the final
    test's top-1, exact K1 counts. Returns the two runs' counts summed."""
    result, records, train_counts, _, again, eval_counts, _ = runs
    numbers = [v for r in records for k, v in r.items() if k.startswith(("train_", "val_", "final_"))]
    steps = result["epochs"][0]["n_steps"]
    if steps != SHORT_TRAIN // B or not numbers or not all(np.isfinite(v) for v in numbers) \
            or again.get("eval") is None or again["eval"]["top1"] != result.get("final_top1"):
        fail(f"{name} results incomplete, not finite or inconsistent: {row}")
    for label, got, want in (("train", train_counts, want_train), ("eval", eval_counts, want_eval)):
        got = {k: v for k, v in got.items() if v}
        if got != want:
            fail(f"{name} {label} launched {got}; want {want}")
    return {k: train_counts[k] + eval_counts[k] for k in train_counts}


def phase_class_cli(attn, card):
    """`devias_tpu_torch.cli.run_class_finetuning` in-process at full width
    on synthetic clips: one 2-step epoch with `--opt sgd`, mixup on (the
    parser's default) and `--scene_labels_from` a CLS teacher checkpoint
    this phase writes from the port's seeded teacher, validation, the
    final test and merge; then `--eval` on the trained checkpoint, which
    must give the same top-1. K1 counts: per step 12 K1-fwd stats and 12
    K1-bwd in the student and 12 K1-fwd in the teacher, 12 K1-fwd per
    validation and test batch."""
    from devias_tpu_torch.cli import run_class_finetuning as cls_cli
    from devias_tpu_torch.nn import create_model

    with tempfile.TemporaryDirectory() as tmp:
        _write_filelists(tmp, NUM_SCENE_CLASSES)
        teacher_pth = os.path.join(tmp, "teacher.pth")
        teacher = create_model("vit_base_patch16_224", seed=5, **TEACHER_KW)
        torch.save({"model": {k: v.cpu() for k, v in teacher.state_dict().items()}}, teacher_pth)
        del teacher
        out = os.path.join(tmp, "out")
        runs = _train_then_eval(attn, cls_cli, CLASS_CLI_FLAGS + ["--data_path", tmp],
                                ["--scene_labels_from", teacher_pth], ["--eval"], out)
        opt_state = torch.load(os.path.join(out, "ckpt", "checkpoint-0.pth"), map_location="cpu",
                               weights_only=True)["optimizer"]["state"]
    row = _cli_row("class_cli", card, runs, optimizer_buffers=sorted(next(iter(opt_state.values()))))
    if row["optimizer_buffers"] != ["momentum_buffer"]:
        fail(f"class CLI's optimizer state holds {row['optimizer_buffers']}")
    steps, val_b, test_b = SHORT_TRAIN // B, -(-SHORT_VAL // B), -(-SHORT_TEST * 2 // B)
    return _check_cli("class CLI", row, runs,
                      {"K1-fwd": 12 * (steps + val_b + test_b), "K1-fwd-stats": 12 * steps, "K1-bwd": 12 * steps},
                      {"K1-fwd": 12 * test_b})


# downstream_train / downstream_cli: the Diving-48 transfer recipe
# (docs/TRAIN.md:94-100) on the downstream CLI's model: a 400 + 365
# selection head, `concat` fusion with the MLP head, 2 latents, 8 tied agg
# rounds; the parser's label smoothing 0.1, layer decay 0.75, agg scale 0.8
DS_CLASSES = 48
DS_RECIPE = ["--data_set", "Diving-48", "--downstream_nb_classes", str(DS_CLASSES), "--nb_classes",
             str(NUM_CLASSES), "--slot_fusion_method", "concat", "--head_type", "mlp", "--num_latents", "2",
             "--agg_depth", "8", "--agg_weights_tie"]
DS_WATCH = ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight", "fusion_head.classifier.weight")
# the std of the smoke's selection and multi-task heads: a trained head's
# margins between slots, not the init's near-ties (a tie could let bf16
# rounding pick another slot in the fused and the plain step)
SELECT_HEAD_STD = 0.05


def _spread_heads(model, seed: int) -> None:
    """`model.head`'s weights (and `model.scene_head`'s, where it has one)
    drawn with SELECT_HEAD_STD from `seed`: logits of a trained head's
    size, not the init's."""
    with torch.no_grad():
        for k, name in enumerate(("head", "scene_head")):
            head = getattr(model, name, None)
            if head is not None:
                w = head.weight
                w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(seed + k)) * SELECT_HEAD_STD)


def _step_phase(attn, card, phase, step, state, batch, want_per_step, window):
    """TRAIN_STEPS counted steps of `step` (the kernels' counts zeroed just
    before and read just after; `want_per_step` the K1 launches of one
    step), finite metrics, then `window` timed steps. Emits the phase's
    row and returns (counts, ms per step, metrics of the first step)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn.reset_launch_counts()
    history = [step(state, batch, generator=gen, host_metrics=True) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = attn.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(window):
        step(state, batch, generator=gen)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    ms = window_s / window * 1e3
    row = {**phase, "card": card, "steps": TRAIN_STEPS, "clips_per_step": B, "metrics": history,
           "launches": counts, "window_steps": window, "ms_per_step": ms, "clips_per_s": window * B / window_s,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(row)
    want = {name: want_per_step.get(name, 0) * TRAIN_STEPS for name in counts}
    finite = all(np.isfinite(v) for m in history for v in m.values())
    if counts != want or not finite or state.step != TRAIN_STEPS + window:
        fail(f"{phase}: launches {counts} (want {want}), finite={finite}, step {state.step}")
    return counts, ms, history[0]


def phase_downstream_train(attn, card):
    """The downstream step (`make_classification_train_step` on the fusion
    model's logits, as `run_slot_downstream` builds it) at full width on the
    Diving-48 recipe, B=12, AdamW with layer decay 0.75 and agg scale 0.8:
    TRAIN_STEPS counted steps (12 K1-fwd stats and 12 K1-bwd per step),
    CLASS_WINDOW timed ones; then downstream_vs_plain, one micro-batch of
    2 clips through fused and plain attention, held as train_vs_plain holds
    the slot step, with the gradient error of every parameter group and
    the slots `select_slots_by_head` picks in each run. Returns the K1
    counts and ms per step."""
    from devias_tpu_torch.cli import run_slot_downstream as ds_cli
    from devias_tpu_torch.cli.common import hard_label_criterion
    from devias_tpu_torch.nn import select_slots_by_head
    from devias_tpu_torch.train import OptimConfig, TrainState, make_classification_train_step, make_optimizer
    from devias_tpu_torch.train.step import classification_loss

    dev = torch.device("cuda")
    args = ds_cli.get_args(DS_RECIPE)
    criterion = hard_label_criterion(args)
    model = ds_cli.build_fusion_model(args, dev)
    _spread_heads(model, 11)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10, layer_decay=0.75,
                                                   agg_block_scale=args.agg_block_scale))
    state = TrainState.create(model, opt)
    step = make_classification_train_step(model, opt, criterion, 1, lr_fn)
    rng = np.random.default_rng(3)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, DS_CLASSES, size=B)}
    counts, ms, first = _step_phase(attn, card, {"phase": "downstream_train", "recipe": DS_RECIPE,
                                                 "smoothing": args.smoothing, "agg_block_scale": args.agg_block_scale},
                                    step, state, batch, {"K1-fwd-stats": 12, "K1-bwd": 12}, CLASS_WINDOW)
    if set(first) != {"loss", "class_acc", "grad_norm", "lr"}:
        fail(f"downstream_train metrics {sorted(first)}")
    del model, opt, state, step
    torch.cuda.empty_cache()

    videos = torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev)
    labels = torch.tensor([1, DS_CLASSES - 1], device=dev)

    heads = {}

    def build(fused):
        m = ds_cli.build_fusion_model(args, dev) if fused else _plain(ds_cli.build_fusion_model(args, dev))
        m.load_state_dict(sd)
        # the selection head's input and logits: the slots each run selects
        m.head.register_forward_hook(lambda mod, inp, o: heads.__setitem__(fused, (inp[0].detach(), o.detach())))
        return m

    (loss_f, grads_f), (loss_p, grads_p) = _fused_vs_plain(
        build, lambda m, g: classification_loss(m, videos, labels, criterion, generator=g)[0], None)
    row = {"phase": "downstream_vs_plain", "card": card, "clips": 2}
    ok = _held(row, loss_f, loss_p, {n: grads_f[n] for n in DS_WATCH}, {n: grads_p[n] for n in DS_WATCH})
    row["grad_error_by_group"] = _group_errors(grads_f, grads_p)
    sel = {}
    for fused, (slots, logits) in heads.items():
        picked = select_slots_by_head(slots, logits, NUM_CLASSES, NUM_SCENE_CLASSES)
        # each slot's largest action probability: how near the selection is to a tie
        sel[fused] = {"action_idx": picked["action_idx"].tolist(), "scene_idx": picked["scene_idx"].tolist(),
                      "action_max_prob": logits.float().softmax(-1)[..., :NUM_CLASSES].amax(-1).tolist()}
    row["selection"] = {"fused": sel[True], "plain": sel[False],
                        "same_slots": all(sel[True][k] == sel[False][k] for k in ("action_idx", "scene_idx"))}
    emit(row)
    if not ok:
        fail("fused and plain downstream steps disagree beyond their limits")
    return counts, ms


def phase_downstream_cli(attn, card):
    """`devias_tpu_torch.cli.run_slot_downstream` in-process at full width on
    the Diving-48 recipe and synthetic clips: `--finetune` on a slot
    checkpoint this phase writes (SlotViT-B, 400 + 365 head, 8 tied rounds
    over 2 slots), one 2-step epoch, validation, the final test and merge;
    then `--eval` on the trained checkpoint, which must give the same
    top-1. K1 counts: per step 12 K1-fwd stats and 12 K1-bwd, 12 K1-fwd per
    validation and test batch."""
    from devias_tpu_torch.cli import run_slot_downstream as ds_cli
    from devias_tpu_torch.nn import create_model

    with tempfile.TemporaryDirectory() as tmp:
        _write_filelists(tmp, DS_CLASSES)
        slot_pth = os.path.join(tmp, "slot.pth")
        slot = create_model("slot_vit_base_patch16_224", seed=6, **SLOT_KW)
        _spread_heads(slot, 12)
        torch.save({"model": {k: v.cpu() for k, v in slot.state_dict().items()}}, slot_pth)
        del slot
        runs = _train_then_eval(attn, ds_cli, DS_RECIPE + SHORT_VIEWS + ["--data_path", tmp],
                                ["--finetune", slot_pth], ["--eval"], os.path.join(tmp, "out"))
    row = _cli_row("downstream_cli", card, runs)
    steps, val_b, test_b = SHORT_TRAIN // B, -(-SHORT_VAL // B), -(-SHORT_TEST * 2 // B)
    return _check_cli("downstream CLI", row, runs,
                      {"K1-fwd": 12 * (val_b + test_b), "K1-fwd-stats": 12 * steps, "K1-bwd": 12 * steps},
                      {"K1-fwd": 12 * test_b})

# mt_train: (label, unified head, logit criterion); 1570 student tokens (CLS,
# 1568 patches, the scene token), the CLS teacher's 1569
MT_CONFIGS = (("separate_kl", False, "KL"), ("unified_ce", True, "CE"))
MT_WATCH = ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.weight", "scene_token")


def phase_mt_train(attn, card):
    """The multi-task step (`make_multi_task_train_step`) at full width on
    `disentangle_vit_base_patch16_224` and its CLS scene teacher as
    `run_multi_task_finetuning` builds them, B=12, for each of MT_CONFIGS:
    TRAIN_STEPS counted steps (per step 12 K1-fwd stats and 12 K1-bwd in
    the student at N = 1570, 12 K1-fwd in the teacher at N = 1569),
    CLASS_WINDOW timed ones, and mt_vs_plain: one micro-batch of 2 clips
    through fused and plain attention (student and teacher), held as
    train_vs_plain holds the slot step. Returns the K1 counts and ms per
    step by config."""
    from devias_tpu_torch.cli import run_multi_task_finetuning as mt_cli
    from devias_tpu_torch.cli.common import hard_label_criterion
    from devias_tpu_torch.train import OptimConfig, TrainState, make_multi_task_train_step, make_optimizer
    from devias_tpu_torch.train.step import multi_task_loss_of

    dev = torch.device("cuda")
    total_counts, ms_by = None, {}
    for label, unified, criterion in MT_CONFIGS:
        args = mt_cli.get_args(["--logit_criterion", criterion] + (["--unified_head"] if unified else []))
        action_criterion = hard_label_criterion(args)
        model, teacher = mt_cli.build_models(args, dev)
        _spread_heads(model, 13)
        _spread_heads(teacher, 14)
        sd, tsd = ({k: v.clone() for k, v in m.state_dict().items()} for m in (model, teacher))
        opt, lr_fn = make_optimizer(model, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10, layer_decay=0.75))
        state = TrainState.create(model, opt)
        step = make_multi_task_train_step(model, teacher, opt, NUM_CLASSES, criterion, 1.0, unified, action_criterion,
                                          1, lr_fn)
        rng = np.random.default_rng(4)
        batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32),
                 "labels": rng.integers(0, NUM_CLASSES, size=B)}
        # the tokens each model's first attention takes, read in the steps
        tokens = {}

        def seen(key):
            def hook(module, inputs):
                tokens.setdefault(key, inputs[0].shape[1])
            return hook

        hooks = [m.blocks[0].attn.register_forward_pre_hook(seen(key)) for key, m in (("student", model),
                                                                                       ("teacher", teacher))]
        counts, ms_by[label], first = _step_phase(
            attn, card, {"phase": "mt_train", "config": label, "unified_head": unified, "logit_criterion": criterion,
                         "tokens": tokens}, step, state, batch, {"K1-fwd": 12, "K1-fwd-stats": 12, "K1-bwd": 12},
            CLASS_WINDOW)
        for h in hooks:
            h.remove()
        if tokens != {"student": 1570, "teacher": 1569} \
                or set(first) != {"loss", "action_loss", "logit_loss", "class_acc", "grad_norm", "lr"}:
            fail(f"mt_train {label}: tokens {tokens}, metrics {sorted(first)}")
        total_counts = counts if total_counts is None else {k: total_counts[k] + counts[k] for k in counts}
        del model, teacher, opt, state, step
        torch.cuda.empty_cache()

        videos = torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev)
        labels = torch.tensor([1, NUM_CLASSES - 1], device=dev)
        teachers = {}

        def build(fused):
            m, t = mt_cli.build_models(args, dev)
            if not fused:
                m, t = _plain(m), _plain(t)
            m.load_state_dict(sd)
            t.load_state_dict(tsd)
            teachers[fused] = t.eval().requires_grad_(False)
            return m

        def loss_of(m, g):
            t = teachers[m.blocks[0].attn.fused]
            return multi_task_loss_of(m, t, videos, labels, NUM_CLASSES, criterion, 1.0, unified, action_criterion,
                                      g)[0]

        (loss_f, grads_f), (loss_p, grads_p) = _fused_vs_plain(build, loss_of, MT_WATCH)
        teachers.clear()
        row = {"phase": "mt_vs_plain", "card": card, "config": label, "clips": 2}
        ok = _held(row, loss_f, loss_p, grads_f, grads_p)
        emit(row)
        if not ok:
            fail(f"fused and plain multi-task steps ({label}) disagree beyond their limits")
    return total_counts, ms_by


def phase_mt_cli(attn, card):
    """`devias_tpu_torch.cli.run_multi_task_finetuning` in-process at full
    width on synthetic clips with a unified head and the teacher from
    `--scene_model_path` (a CLS checkpoint this phase writes): one 2-step
    epoch, validation, the final test and merge; then `--eval --eval_scene`
    on the trained checkpoint (the same top-1; the scene test against the
    teacher's labels). K1 counts: per step 12 K1-fwd stats and 12 K1-bwd in
    the student and 12 K1-fwd in the teacher; 12 K1-fwd per validation and
    test batch; 12 more per scene-test batch for the teacher."""
    from devias_tpu_torch.cli import run_multi_task_finetuning as mt_cli
    from devias_tpu_torch.nn import create_model

    with tempfile.TemporaryDirectory() as tmp:
        _write_filelists(tmp, NUM_CLASSES)
        teacher_pth = os.path.join(tmp, "teacher.pth")
        teacher = create_model("vit_base_patch16_224", seed=5, **TEACHER_KW)
        _spread_heads(teacher, 15)
        torch.save({"model": {k: v.cpu() for k, v in teacher.state_dict().items()}}, teacher_pth)
        del teacher
        base = ["--unified_head", "--nb_classes", str(NUM_CLASSES), "--data_set", "Kinetics-400", "--data_path", tmp,
                "--scene_model_path", teacher_pth] + SHORT_VIEWS
        runs = _train_then_eval(attn, mt_cli, base, [], ["--eval", "--eval_scene"], os.path.join(tmp, "out"))
    scene = runs[4].get("eval_scene")
    row = _cli_row("mt_cli", card, runs, eval_scene=scene)
    if scene is None or not all(np.isfinite(v) for v in scene.values()):
        fail(f"multi-task CLI --eval_scene incomplete: {row}")
    steps, val_b, test_b = SHORT_TRAIN // B, -(-SHORT_VAL // B), -(-SHORT_TEST * 2 // B)
    # the scene test runs the student and the teacher on each test batch
    return _check_cli("multi-task CLI", row, runs,
                      {"K1-fwd": 12 * (steps + val_b + test_b), "K1-fwd-stats": 12 * steps, "K1-bwd": 12 * steps},
                      {"K1-fwd": 12 * test_b + 24 * test_b})

# options_train: the flagship step with the options this slice ported
OPTIONS_KW = dict(remat=True, drop_path_rate=0.1)
OPTIONS_WINDOW = 10
# remat_vs_not: the checkpointed step's gradients against the plain one's,
# relative to the largest magnitude (bitwise is expected)
REMAT_TOL = 1e-5


def _options_parts():
    """The flagship step's loss config and its step config with FAME's
    exact top-k selection."""
    from devias_tpu_torch.aug import FAMEConfig

    loss_cfg, step_cfg = _train_parts()
    return loss_cfg, dataclasses.replace(step_cfg, fame=FAMEConfig(beta=0.5, prob_aug=0.8, exact_topk=True))


def _small_slot_batch(seed: int):
    """2 clips, their labels and fixed FAME draws on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    videos = torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=2)).to(dev)
    draws = {"perm": torch.tensor([1, 0], device=dev), "keep": torch.tensor([True, True], device=dev)}
    return videos, labels, draws


def phase_options_train(attn, card, train_ms: float):
    """The flagship slot step of phase 5 with checkpointed blocks
    (`remat`), drop-path 0.1 and FAME's exact top-k
    selection at B=12: TRAIN_STEPS counted steps (12 teacher K1-fwd; 24
    student K1-fwd stats, the forward's and the recompute's, and 12 K1-bwd
    per step), OPTIONS_WINDOW timed ones beside phase 5's ms; then the
    same without `remat` (12 K1-fwd stats per step), timed the same way,
    for what the recompute costs and saves. Then options_vs_plain, the
    step's loss on 2 clips through fused and plain attention, held as
    train_vs_plain holds it; and remat_vs_not, the same 2 clips through
    the checkpointed and the plain blocks with one generator seed: every
    gradient within REMAT_TOL of its largest magnitude and the generator's
    state after the step equal. Returns the K1 counts."""
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step
    from devias_tpu_torch.train.step import slot_loss

    loss_cfg, step_cfg = _options_parts()
    rng = np.random.default_rng(0)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, NUM_CLASSES, size=B)}
    watch = TRAIN_WATCH
    counted, sd = None, None
    for remat in (True, False):
        student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True,
                               **dict(OPTIONS_KW, remat=remat), **SLOT_KW)
        teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
        opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10))
        state = TrainState.create(student, opt)
        step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn)
        params = dict(student.named_parameters())
        before = {n: params[n].detach().clone() for n in watch}
        counts, ms, _ = _step_phase(
            attn, card, {"phase": "options_train" if remat else "options_train_no_remat",
                         "options": dict(OPTIONS_KW, remat=remat), "fame_exact_topk": True,
                         "phase5_ms_per_step": train_ms},
            step, state, batch, {"K1-fwd": 12, "K1-fwd-stats": 24 if remat else 12, "K1-bwd": 12}, OPTIONS_WINDOW)
        changed = {n: (params[n].detach() - before[n]).abs().max().item() for n in watch}
        if not all(v > 0 for v in changed.values()):
            fail(f"options_train left parameters unchanged: {changed}")
        counted = counts if counted is None else {k: counted[k] + counts[k] for k in counts}
        if remat:
            sd = {k: v.clone() for k, v in student.state_dict().items()}
        del student, teacher, opt, state, step, params
        torch.cuda.empty_cache()

    videos, labels, draws = _small_slot_batch(1)
    out = {}
    for fused, remat in ((True, True), (False, True), (True, False)):
        model = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=fused,
                             **dict(OPTIONS_KW, remat=remat), **SLOT_KW).train()
        model.load_state_dict(sd)
        teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=fused, **TEACHER_KW)
        gen = torch.Generator(device="cuda").manual_seed(3)
        loss, _ = slot_loss(model, teacher, videos, labels, loss_cfg, step_cfg, gen, draws)
        loss.backward()
        out[fused, remat] = (loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()},
                             gen.get_state())
        del model, teacher, loss
        torch.cuda.empty_cache()
    (loss_f, grads_f, state_f), (loss_p, grads_p, _), (loss_n, grads_n, state_n) = (
        out[True, True], out[False, True], out[True, False])
    row = {"phase": "options_vs_plain", "card": card, "clips": 2}
    ok = _held(row, loss_f, loss_p, {n: grads_f[n] for n in watch}, {n: grads_p[n] for n in watch})
    emit(row)
    if not ok:
        fail("the options step with fused and plain attention disagree beyond their limits")
    worst = max(((grads_f[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item() for n, g in grads_n.items())
    bitwise = all(torch.equal(grads_f[n], g) for n, g in grads_n.items()) and loss_f == loss_n
    same_state = torch.equal(state_f, state_n)
    emit({"phase": "remat_vs_not", "card": card, "clips": 2, "loss_remat": loss_f, "loss_plain": loss_n,
          "max_rel_grad_err": worst, "tol": REMAT_TOL, "bitwise": bitwise, "generator_states_equal": same_state})
    if worst > REMAT_TOL or not same_state:
        fail("checkpointed and plain blocks disagree, or the generator ended elsewhere")
    return counted


# fame_modes: 12 structured clips (a static textured background, a moving
# square, noise, and a static noise-free band where the differences are 0)
FAME_MODES = (("threshold", {}), ("exact_topk", {"exact_topk": True}), ("downsample4", {"tubelet_mask_downsample": 4}))
FAME_ITERS = 5
FAME_EQUAL_SHARE = 0.999


def _structured_clips(seed: int) -> np.ndarray:
    """[B, 16, 224, 224, 3] clips in [0, 1] (denormalised)."""
    rng = np.random.default_rng(seed)
    T, S = CLIPS[1], CLIPS[2]
    bg = rng.uniform(size=(B, 1, S, S, 3)).astype(np.float32) * 0.5
    x = np.repeat(bg, T, axis=1)
    for b in range(B):
        color = rng.uniform(0.4, 1.0, size=3).astype(np.float32)
        for t in range(T):
            r, c = 20 + 4 * t + b, 30 + 5 * t
            x[b, t, r:r + 64, c:c + 64] = color * (0.8 + 0.2 * rng.uniform(size=(64, 64, 1)).astype(np.float32))
    x += 0.02 * rng.standard_normal(x.shape, dtype=np.float32)
    x[:, :, 160:] = bg[:, :, 160:]
    return np.clip(x, 0.0, 1.0)


def phase_fame_modes(card):
    """`compute_fame_masks` at B=12 on 16x224x224 clips in three modes
    (threshold, exact_topk, tubelet_mask_downsample 4): ms per call on the
    card, and the card's masks against the port's CPU masks on the same
    clips, the share of equal pixels held to FAME_EQUAL_SHARE."""
    from devias_tpu_torch.aug.fame import FAMEConfig, compute_fame_masks

    clips = _structured_clips(2)
    on_card = torch.from_numpy(clips).cuda()
    rows = {}
    for label, kw in FAME_MODES:
        cfg = FAMEConfig(**kw)
        mask, per = compute_fame_masks(on_card, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FAME_ITERS):
            compute_fame_masks(on_card, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / FAME_ITERS * 1e3
        mask_c, per_c = compute_fame_masks(torch.from_numpy(clips), cfg)
        share = {"clip": (mask.cpu() == mask_c).float().mean().item(),
                 "per_pair": (per.cpu() == per_c).float().mean().item()}
        rows[label] = {"ms": ms, "equal_share": share, "per_pair_shape": list(per.shape),
                       "fg_fraction": mask.mean().item()}
    emit({"phase": "fame_modes", "card": card, "clips": B, "iters": FAME_ITERS, "min_share": FAME_EQUAL_SHARE,
          "modes": rows})
    if any(v < FAME_EQUAL_SHARE for r in rows.values() for v in r["equal_share"].values()):
        fail("FAME masks on the card and on the CPU disagree beyond their limit")


def phase_attn_drop_train(attn, card):
    """The flagship slot step with attention-probability dropout 0.1 at
    B=12: the student's training layers take the plain attention with
    dropout (the JAX package's dispatch), so per step only the teacher's 12
    K1-fwd launch; metrics finite, parameters changed, ms and peak memory.
    Then the trained weights in eval, where K1 runs (12 K1-fwd per batch),
    against the same weights at attn_drop_rate 0: bitwise equal outputs.
    Returns the K1 counts of the steps and the eval batch."""
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step

    loss_cfg, step_cfg = _train_parts()
    kw = dict(SLOT_KW, attn_drop_rate=0.1)
    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **kw)
    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
    opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10))
    state = TrainState.create(student, opt)
    step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn)
    rng = np.random.default_rng(0)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, NUM_CLASSES, size=B)}
    params = dict(student.named_parameters())
    before = {n: params[n].detach().clone() for n in TRAIN_WATCH}
    counts, ms, _ = _step_phase(attn, card, {"phase": "attn_drop_train", "attn_drop_rate": 0.1}, step, state, batch,
                                {"K1-fwd": 12}, CLASS_WINDOW)
    changed = {n: (params[n].detach() - before[n]).abs().max().item() for n in TRAIN_WATCH}
    if not all(v > 0 for v in changed.values()):
        fail(f"attn_drop_train left parameters unchanged: {changed}")
    del teacher, opt, state, step, params
    no_drop = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
    no_drop.load_state_dict(student.state_dict())
    videos = torch.from_numpy(batch["videos"]).cuda()
    attn.reset_launch_counts()
    with torch.inference_mode():
        got = student.eval()(videos)
        eval_counts = attn.launch_counts()
        want = no_drop(videos)
    torch.cuda.synchronize()
    same = all(torch.equal(got[k], want[k]) for k in ("slots", "slots_head", "attn"))
    emit({"phase": "attn_drop_eval", "card": card, "clips": B, "launches": eval_counts, "bitwise_equal": same})
    if {k: v for k, v in eval_counts.items() if v} != {"K1-fwd": 12} or not same:
        fail(f"attn_drop eval launched {eval_counts} or differs from attn_drop 0 (bitwise {same})")
    del student, no_drop
    torch.cuda.empty_cache()
    return {k: counts[k] + eval_counts[k] for k in counts}


INT8_ITERS = 10
INT8_COSINE = 0.99
INT8_DOT_TOL = 1e-6


def phase_int8_teacher(attn, card):
    """The CLS scene teacher's forward at B=12 in bf16 and with
    `int8_dense=True` (w8a8 qkv, proj, fc1, fc2 through `torch._int_mm`),
    the same seeded weights with a spread head: 12 K1-fwd each, ms per
    forward, the logits' cosine (held to INT8_COSINE, as
    `tests/test_quant.py` holds JAX's) and argmax agreement, a profile of
    two forwards of each (where the int8 teacher's time goes); and one
    `int8_dot` at the teacher's qkv shape on the card against the CPU on
    the same inputs, within INT8_DOT_TOL relative. Returns the K1 counts."""
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.nn.quant import int8_dot
    from devias_tpu_torch.scripts.profile_step import profile_breakdown

    videos = torch.from_numpy(np.random.default_rng(5).standard_normal(CLIPS, dtype=np.float32)).cuda()
    logits, ms, profiles, total = {}, {}, {}, None
    for label, int8 in (("bf16", False), ("int8", True)):
        teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, int8_dense=int8, **TEACHER_KW)
        _spread_heads(teacher, 25)
        attn.reset_launch_counts()
        with torch.inference_mode():
            logits[label] = teacher(videos)["logits"].float()
            counts = attn.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INT8_ITERS):
                teacher(videos)
            torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) / INT8_ITERS * 1e3
        with torch.inference_mode():
            profiles[label] = profile_breakdown(lambda: teacher(videos), 2)
        if {k: v for k, v in counts.items() if v} != {"K1-fwd": 12}:
            fail(f"the {label} teacher launched {counts}; want 12 K1-fwd")
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        qkv_w = teacher.blocks[0].attn.qkv.weight.detach()
        del teacher
    a, b = logits["bf16"], logits["int8"]
    cosine = (F.cosine_similarity(a.flatten(), b.flatten(), dim=0)).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 1569, 768), dtype=np.float32)).to(torch.bfloat16)
    want = int8_dot(x, qkv_w.cpu())
    got = int8_dot(x.cuda(), qkv_w).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    emit({"phase": "int8_teacher", "card": card, "clips": B, "iters": INT8_ITERS, "ms": ms,
          "int8_over_bf16": ms["int8"] / ms["bf16"], "logits_cosine": cosine, "cosine_min": INT8_COSINE,
          "argmax_agreement": agree, "int8_dot_shape": [B * 1569, 768, qkv_w.shape[0]], "int8_dot_rel_err": rel,
          "int8_dot_bitwise": torch.equal(got, want), "int8_dot_tol": INT8_DOT_TOL, "profile": profiles})
    if not cosine >= INT8_COSINE or rel > INT8_DOT_TOL:
        fail(f"int8 teacher: cosine {cosine}, int8_dot card vs CPU {rel}")
    return total


OPTIONS_CLI_FLAGS = ["--model", "slot_vit_base_patch16_224", "--num_latents", "2", "--agg_depth", "8",
                     "--agg_weights_tie", "--mask_model", "FAME", "--data_set", "Kinetics-400", "--use_checkpoint",
                     "--teacher_int8", "--drop_path", "0.1"] + SHORT_VIEWS


def phase_options_cli(attn, card):
    """`run_slot_finetuning` in-process at full width with
    `--use_checkpoint --teacher_int8 --drop_path 0.1`: a 2-step epoch,
    validation, the final test, then `--eval` on its checkpoint (the same
    top-1). K1 counts: per step 12 K1-fwd in the int8 teacher, 24 K1-fwd
    stats and 12 K1-bwd in the checkpointed student; 12 K1-fwd per
    validation and test batch."""
    from devias_tpu_torch.cli import run_slot_finetuning as cli

    with tempfile.TemporaryDirectory() as tmp:
        _write_filelists(tmp, NUM_CLASSES)
        runs = _train_then_eval(attn, cli, OPTIONS_CLI_FLAGS + ["--data_path", tmp], [], ["--eval"],
                                os.path.join(tmp, "out"))
    row = _cli_row("options_cli", card, runs)
    steps, val_b, test_b = SHORT_TRAIN // B, -(-SHORT_VAL // B), -(-SHORT_TEST * 2 // B)
    return _check_cli("options CLI", row, runs,
                      {"K1-fwd": 12 * (steps + val_b + test_b), "K1-fwd-stats": 24 * steps, "K1-bwd": 12 * steps},
                      {"K1-fwd": 12 * test_b})


# real_video_cli / loader_split: mp4 files (mp4v) written with cv2, as the
# JAX package's real-video tests write them: smooth textures that move, so
# the codec compresses them as it does camera video
REAL_SPLITS = (("train", 12), ("val", 4), ("test", 4))
REAL_FRAMES, REAL_HW = 64, (240, 320)
REAL_CLI_FLAGS = ["--model", "slot_vit_base_patch16_224", "--num_latents", "2", "--agg_depth", "8",
                  "--agg_weights_tie", "--mask_model", "FAME", "--batch_size", str(B), "--test_num_segment", "1",
                  "--test_num_crop", "2", "--data_set", "Kinetics-400"]
# the loader's rate: the train files listed this many times (120 samples,
# 10 batches of 24 clips)
LOADER_REPEAT = 10


def write_real_videos(root: str) -> dict:
    """REAL_SPLITS' mp4 files of REAL_FRAMES 240x320 frames under `root`,
    and train.csv, val.csv and test.csv listing them (absolute paths,
    labels cycling over NUM_CLASSES). Returns the seconds and bytes."""
    import cv2

    rng = np.random.default_rng(21)
    t0, nbytes = time.perf_counter(), 0
    for split, n in REAL_SPLITS:
        rows = []
        for i in range(n):
            path = os.path.join(root, f"{split}{i:02d}.mp4")
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (REAL_HW[1], REAL_HW[0]))
            small = rng.integers(0, 256, size=(REAL_HW[0] // 8, REAL_HW[1] // 8, 3), dtype=np.uint8)
            texture = cv2.resize(small, (REAL_HW[1], REAL_HW[0]), interpolation=cv2.INTER_LINEAR)
            for f in range(REAL_FRAMES):
                writer.write(np.roll(texture, (2 * f, 3 * f), axis=(0, 1)))
            writer.release()
            nbytes += os.path.getsize(path)
            rows.append(f"{path} {(7 * i) % NUM_CLASSES}")
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows))
    return {"write_s": time.perf_counter() - t0, "bytes": nbytes}


def host_cores() -> dict:
    """Which reader and which RandAugment path the port's data pipeline
    takes here: the FFmpeg decode core where pkg-config resolves FFmpeg,
    else cv2; the C++ augment core unless DEVIAS_NO_NATIVE_AUGMENT is set.
    Builds the cores that are on (their build seconds)."""
    from devias_tpu_torch.data import native_augment, native_decode, video_reader

    row = {"reader": video_reader.reader_name(), "pkg_config_ffmpeg": native_decode.ffmpeg_flags()}
    t0 = time.perf_counter()
    row["augment_core"] = native_augment.available()
    row["augment_core_build_s"] = time.perf_counter() - t0
    if native_decode.available():
        t0 = time.perf_counter()
        native_decode._load()
        row["decode_core_build_s"] = time.perf_counter() - t0
    return row


def phase_real_video_cli(attn, card, root: str):
    """`run_slot_finetuning` in-process at full width on REAL_SPLITS' mp4
    files: one epoch (1 step of 24 clips), validation, the final test.
    Every video is opened through the data pipeline's `open_video`, whose
    readers this phase counts, as it counts the calls that reach the C++
    augment core. K1: 12 K1-fwd, 12 stats and 12 bwd for the step, 12 K1-fwd
    per validation and test batch."""
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.data import datasets, native_augment

    readers, core_calls = {}, [0]
    open_video, available = datasets.open_video, native_augment.available

    def counted_open(path, *a, **k):
        r = open_video(path, *a, **k)
        readers[type(r).__name__] = readers.get(type(r).__name__, 0) + 1
        return r

    def counted_available():
        on = available()
        core_calls[0] += on
        return on

    datasets.open_video, native_augment.available = counted_open, counted_available
    try:
        out = os.path.join(root, "out")
        result, counts, seconds = _cli_run(attn, cli, REAL_CLI_FLAGS + ["--data_path", root, "--epochs", "1",
                                                                        "--output_dir", out])
    finally:
        datasets.open_video, native_augment.available = open_video, available
    with open(os.path.join(out, "log.txt")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    epoch = result["epochs"][0]
    cores = host_cores()
    row = {"phase": "real_video_cli", "card": card, **cores, "readers_opened": readers,
           "augment_core_calls": core_calls[0], "seconds": seconds, "n_steps": epoch["n_steps"],
           "loop_s": epoch["loop_s"], "first_step_s": epoch["first_step_s"], "final_top1": result.get("final_top1"),
           "records": records, "launches": counts}
    emit(row)
    want_reader = "NativeVideoReader" if cores["reader"] == "native_decode" else "OpenCVVideoReader"
    n_files = sum(n for _, n in REAL_SPLITS)
    numbers = [v for r in records for k, v in r.items() if k.startswith(("train_", "val_", "final_"))]
    if set(readers) != {want_reader} or readers[want_reader] < n_files or epoch["n_steps"] != 1 \
            or not numbers or not all(np.isfinite(v) for v in numbers) \
            or (core_calls[0] == 0) == cores["augment_core"]:
        fail(f"real_video_cli: {row}")
    want = {"K1-fwd": 36, "K1-fwd-stats": 12, "K1-bwd": 12}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        fail(f"real_video_cli launched {got}; want {want}")
    return counts


def _per_sample_ms(fn, items) -> float:
    t0 = time.perf_counter()
    for item in items:
        fn(item)
    return (time.perf_counter() - t0) * 1e3 / len(items)


def _loader_rate(args, root: str) -> dict:
    """The CLI's training loader alone over LOADER_REPEAT passes of the
    train files: clips/s over the epoch and after its first batch."""
    from devias_tpu_torch.cli import common
    from devias_tpu_torch.data import build_dataset

    dataset, _ = build_dataset(True, False, common.make_data_config(args, data_path=root))
    loader = common.make_train_loader(dataset, args)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    arrivals, clips = [], []
    try:
        for batch in loader:
            arrivals.append(time.perf_counter() - t0)
            clips.append(batch["videos"].shape[0])
    finally:
        loader.close()
    return {"batches": len(arrivals), "clips": sum(clips), "clips_per_s": sum(clips) / arrivals[-1],
            "clips_per_s_after_first": sum(clips[1:]) / (arrivals[-1] - arrivals[0])}


def phase_loader_split(card, root: str, direct_step_ms: float):
    """Where the CLI's host pipeline spends its time on REAL_SPLITS' train
    files, in ms per dataset sample (one decode, then `--num_sample` 2
    augmented clips): decode (the active reader, and cv2 beside it where
    the core is on), RandAugment with the augment core on and off (the
    same op draws), the crop, normalize and flip, random erasing when it
    fires (it fires with --reprob 0.25), collate and the pinned copy to the
    card; then the training loader's clips/s with the augment core on and
    off, beside the direct step's consumption."""
    import random

    from devias_tpu_torch.cli import common
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.data import build_dataset, native_augment, native_decode
    from devias_tpu_torch.data import transforms as T
    from devias_tpu_torch.data.loader import _collate, _to_tensors

    args = cli.get_args(REAL_CLI_FLAGS + ["--data_path", root, "--output_dir", os.path.join(root, "split_out")])
    cfg = common.make_data_config(args)
    ds, _ = build_dataset(True, False, cfg)
    ds.set_epoch(0)
    idx = list(range(len(ds)))
    rngs = {i: ds._sample_rngs(i) for i in idx}
    stages = {}
    clips = {}

    def decode(i):
        clips[i] = ds._load_clip(ds.entries[i], True, rng=rngs[i][1])

    stages["decode"] = _per_sample_ms(decode, idx)
    if native_decode.available():
        native_decode._FFMPEG, ffmpeg = None, native_decode._FFMPEG
        try:
            stages["decode_cv2"] = _per_sample_ms(lambda i: ds._load_clip(ds.entries[i], True, rng=rngs[i][1]), idx)
        finally:
            native_decode._FFMPEG = ffmpeg

    def randaug(i):
        r = random.Random(i)
        for _ in range(cfg.num_sample):
            T.rand_augment_clip(clips[i], cfg.aa, r, interpolation=cfg.train_interpolation)

    stages["randaugment_core_on"] = _per_sample_ms(randaug, idx) if native_augment.available() else None
    lib, searched = native_augment._LIB, native_augment._SEARCHED
    native_augment._LIB, native_augment._SEARCHED = None, True
    try:
        stages["randaugment_core_off"] = _per_sample_ms(randaug, idx)
    finally:
        native_augment._LIB, native_augment._SEARCHED = lib, searched
    normed = {}

    def crop(i):
        r = random.Random(i)
        normed[i] = [T.horizontal_flip_clip(T.normalize_clip(T.random_resized_crop_clip(clips[i], cfg.input_size,
                                                                                         rng=r)), 0.5, r)
                     for _ in range(cfg.num_sample)]

    stages["crop_normalize_flip"] = _per_sample_ms(crop, idx)
    stages["erase_when_fired"] = _per_sample_ms(
        lambda i: [T.random_erase_clip(c, 1.0, rng=random.Random(i)) for c in normed[i]], idx)
    samples = [ds[i] for i in idx]
    t0 = time.perf_counter()
    batch = _collate(samples)
    stages["collate"] = (time.perf_counter() - t0) * 1e3 / len(samples)
    dev = torch.device("cuda")
    _to_tensors(batch, dev, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _to_tensors(batch, dev, True)
    torch.cuda.synchronize()
    stages["pinned_copy"] = (time.perf_counter() - t0) * 1e3 / len(samples)

    loader_root = os.path.join(root, "loader")
    os.makedirs(loader_root, exist_ok=True)
    with open(os.path.join(root, "train.csv")) as f:
        rows = f.read().splitlines()
    with open(os.path.join(loader_root, "train.csv"), "w") as f:
        f.write("\n".join(rows * LOADER_REPEAT))
    rates = {"core_on": _loader_rate(args, loader_root)}
    native_augment._LIB, native_augment._SEARCHED = None, True
    try:
        rates["core_off"] = _loader_rate(args, loader_root)
    finally:
        native_augment._LIB, native_augment._SEARCHED = lib, searched
    row = {"phase": "loader_split", "card": card, **host_cores(), "host_cpus": os.cpu_count(),
           "num_workers": args.num_workers, "samples": len(idx), "clips_per_sample": cfg.num_sample,
           "frames_decoded": REAL_HW + (cfg.num_frames,), "ms_per_sample": stages, "reprob": cfg.reprob,
           "loader": rates, "direct_step_clips_per_s": B * 1e3 / direct_step_ms}
    emit(row)
    want = len(rows) * LOADER_REPEAT // B
    if any(r["batches"] != want for r in rates.values()) or not all(
            v is None or (np.isfinite(v) and v >= 0) for v in stages.values()):
        fail(f"loader_split: {row}")


def _raise_person_bias(seg, frames: torch.Tensor, share: float) -> float:
    """Raise the classifier's person bias of `seg` so that about `share` of
    the quarter-res pixels of `frames` take the person class. Returns the
    raise."""
    from devias_tpu_torch.nn.segformer import CITYSCAPES_PERSON_CLASS as P

    with torch.no_grad():
        lg = seg(frames).float()
        gap = torch.cat([lg[..., :P], lg[..., P + 1:]], -1).amax(-1) - lg[..., P]
        raise_by = torch.quantile(gap.flatten()[:1 << 20], share).item()
        seg.decode_head.classifier.bias[P] += raise_by
    return raise_by


SEG_WINDOW = 10
SEG_SHARE = 0.3  # the share of pixels the raised person bias aims at


def phase_segformer_train(attn, card):
    """The slot train step with the Segformer mix (`segformer_apply`) in
    place of FAME, as `_flagship_step` builds it, B=12 clips of 16x224x224:
    the mask model is the B3 geometry (`segformer_b3`) in bfloat16 on
    random weights from a seed, its person bias raised to cover about
    SEG_SHARE of the pixels of this phase's clips. The mask model alone
    (ms for the 96 frames of a step), its masks' coverage and their
    agreement with the same weights in float32; TRAIN_STEPS counted steps
    (12 K1-fwd, 12 K1-fwd stats and 12 K1-bwd each), SEG_WINDOW timed ones
    with the peak memory, a profile (device busy share); then
    segformer_vs_plain: 2 clips with fixed draws through fused and plain
    attention, held as train_vs_plain."""
    from devias_tpu_torch.aug import FAMEConfig, segformer_frame_masks
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.nn.segformer import create_segformer, segformer_b3
    from devias_tpu_torch.scripts.profile_step import profile_breakdown
    from devias_tpu_torch.train import TrainStepConfig
    from devias_tpu_torch.train.step import slot_loss

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, NUM_CLASSES, size=B)}
    videos = torch.from_numpy(batch["videos"]).to(dev)
    seg = create_segformer(segformer_b3(), seed=7, dtype=torch.bfloat16)
    raised = _raise_person_bias(seg, videos[:, ::2].reshape(-1, *CLIPS[2:]), SEG_SHARE)
    masks = segformer_frame_masks(seg, videos)
    seg32 = create_segformer(segformer_b3(), seed=7)
    seg32.load_state_dict(seg.state_dict())
    masks32 = segformer_frame_masks(seg32, videos)
    seg_info = {"variant": "b3", "params_m": sum(p.numel() for p in seg.parameters()) / 1e6,
                "person_bias_raise": raised, "coverage_bf16": masks.mean().item(),
                "coverage_f32": masks32.mean().item(),
                "bf16_f32_mask_agreement": (masks == masks32).float().mean().item(),
                "mask_model_ms": time_ms(lambda: segformer_frame_masks(seg, videos), 5),
                "mask_model_f32_ms": time_ms(lambda: segformer_frame_masks(seg32, videos), 2)}
    del seg32, masks32, videos
    loss_cfg, _ = _train_parts()
    step_cfg = TrainStepConfig(use_fame=False, fame=FAMEConfig(beta=0.5, prob_aug=0.8))
    student, state, step, _ = _flagship_step(step_cfg, segformer_apply=seg)
    counts, ms, first = _step_phase(attn, card, {"phase": "segformer_train", **seg_info}, step, state, batch,
                                    {"K1-fwd": 12, "K1-fwd-stats": 12, "K1-bwd": 12}, SEG_WINDOW)
    emit({"phase": "segformer_profile", "card": card,
          **profile_breakdown(lambda: step(state, batch), PROFILE_STEPS)})
    if not 0.05 < seg_info["coverage_bf16"] < 0.95 or first["mask_distill_loss"] <= 0:
        fail(f"segformer_train: masks cover {seg_info['coverage_bf16']}, mask loss {first['mask_distill_loss']}")
    del student, state, step
    torch.cuda.empty_cache()

    small = torch.from_numpy(rng.standard_normal((2,) + CLIPS[1:], dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=2)).to(dev)
    draws = {"perm": torch.tensor([1, 0], device=dev), "keep": torch.tensor([True, True], device=dev),
             "frame": torch.tensor(3, device=dev)}

    def build(fused):
        return create_model("slot_vit_base_patch16_224", seed=0, fused_attention=fused, **SLOT_KW)

    def loss_of(model, gen):
        teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=model.blocks[0].attn.fused,
                               **TEACHER_KW)
        return slot_loss(model, teacher, small, labels, loss_cfg, step_cfg, draws=draws, segformer_apply=seg)[0]

    (loss_f, grads_f), (loss_p, grads_p) = _fused_vs_plain(build, loss_of, TRAIN_WATCH)
    row = {"phase": "segformer_vs_plain", "card": card, "clips": 2}
    ok = _held(row, loss_f, loss_p, grads_f, grads_p)
    emit(row)
    if not ok:
        fail("fused and plain Segformer train steps disagree beyond their limits")
    del seg
    torch.cuda.empty_cache()
    return counts


SEG_CLI_FLAGS = ["--model", "slot_vit_base_patch16_224", "--num_latents", "2", "--agg_depth", "8",
                 "--agg_weights_tie", "--mask_model", "Segformer", "--segformer_variant", "b0", "--data_set",
                 "Kinetics-400"] + SHORT_VIEWS
CONVERT_FLAGS = ["--model_kind", "slot", "--nb_classes", str(NUM_CLASSES), "--num_latents", "2", "--agg_depth", "8",
                 "--agg_weights_tie"]


def phase_segformer_cli(attn, card):
    """`run_slot_finetuning --mask_model Segformer --segformer_variant b0
    --segformer_ckpt` an HF-layout .pth this phase writes (b0 on random
    weights from a seed, the person bias raised on synthetic frames) at
    full width: a 2-step epoch, validation, the final test, then `--eval`
    on its checkpoint (the same top-1); then the convert phase on that
    checkpoint. K1 as options_cli without `--use_checkpoint`: 12 K1-fwd,
    12 stats and 12 bwd per step, 12 K1-fwd per validation and test batch."""
    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.nn.segformer import create_segformer, segformer_b0

    with tempfile.TemporaryDirectory() as tmp:
        _write_filelists(tmp, NUM_CLASSES)
        seg = create_segformer(segformer_b0(), seed=8, dtype=torch.bfloat16)
        frames = torch.randn((16,) + CLIPS[2:], generator=torch.Generator().manual_seed(9)).cuda()
        raised = _raise_person_bias(seg, frames, SEG_SHARE)
        pth = os.path.join(tmp, "segformer_b0.pth")
        torch.save({k: v.cpu() for k, v in seg.state_dict().items()}, pth)
        del seg
        out = os.path.join(tmp, "out")
        runs = _train_then_eval(attn, cli, SEG_CLI_FLAGS + ["--data_path", tmp], ["--segformer_ckpt", pth],
                                ["--eval"], out)
        row = _cli_row("segformer_cli", card, runs, person_bias_raise=raised)
        steps, val_b, test_b = SHORT_TRAIN // B, -(-SHORT_VAL // B), -(-SHORT_TEST * 2 // B)
        counts = _check_cli("segformer CLI", row, runs,
                            {"K1-fwd": 12 * (steps + val_b + test_b), "K1-fwd-stats": 12 * steps,
                             "K1-bwd": 12 * steps}, {"K1-fwd": 12 * test_b})
        conv = phase_convert(attn, card, cli, tmp, out, runs[4]["eval"]["top1"])
    return {k: counts[k] + conv[k] for k in counts}


def phase_convert(attn, card, cli, data: str, out: str, top1: float):
    """`devias_tpu_torch.cli.convert_checkpoint` on the Segformer CLI's
    full-size checkpoint: `to_reference` ({'model', 'epoch'}), then
    `to_port` of that file (every key consumed, the model bitwise the
    checkpoint's), then the CLI's `--eval` with `--finetune` on the
    round-tripped checkpoint, which must give the original's top-1
    (12 K1-fwd per test batch)."""
    from devias_tpu_torch.cli import convert_checkpoint

    ref = os.path.join(data, "reference.pth")
    t0 = time.perf_counter()
    convert_checkpoint.main(["to_reference", "--input", os.path.join(out, "ckpt"), "--output", ref, *CONVERT_FLAGS])
    back = convert_checkpoint.main(["to_port", "--input", ref, "--output", os.path.join(data, "port"),
                                    *CONVERT_FLAGS])
    convert_s = time.perf_counter() - t0
    orig = torch.load(os.path.join(out, "ckpt", "checkpoint-0.pth"), map_location="cpu", weights_only=True)["model"]
    got = torch.load(back["path"], map_location="cpu", weights_only=True)["model"]
    ref_obj = torch.load(ref, map_location="cpu", weights_only=True)
    bitwise = sorted(got) == sorted(orig) and all(torch.equal(got[k], orig[k]) for k in orig)
    result, counts, seconds = _cli_run(attn, cli, SEG_CLI_FLAGS + [
        "--data_path", data, "--eval", "--finetune", back["path"], "--output_dir", os.path.join(data, "conv_eval")])
    test_b = -(-SHORT_TEST * 2 // B)
    row = {"phase": "convert", "card": card, "convert_s": convert_s, "reference_keys": len(ref_obj["model"]),
           "reference_epoch": ref_obj["epoch"], "loaded": len(back["report"]["loaded"]),
           "unused": back["report"]["unused_in_ckpt"], "bitwise": bitwise, "eval_s": seconds,
           "eval": result.get("eval"), "original_top1": top1, "launches": counts}
    emit(row)
    got_counts = {k: v for k, v in counts.items() if v}
    if not bitwise or row["unused"] or result.get("eval", {}).get("top1") != top1 \
            or got_counts != {"K1-fwd": 12 * test_b}:
        fail(f"convert: {row}")
    return counts


# ---------------------------------------------------------------- the last model options

LS_KW = dict(init_values=0.1, use_learnable_pos_emb=True)
LS_WATCH = ("blocks.0.gamma_1", "blocks.11.gamma_2", "pos_embed", "blocks.0.attn.qkv.weight")
LS_WINDOW = 10


def phase_layerscale_train(attn, card, train_ms: float):
    """Phase 5's flagship slot step with LayerScale (`init_values` 0.1) and
    a learned `pos_embed` on the student: TRAIN_STEPS counted steps (12
    teacher K1-fwd, 12 K1-fwd stats and 12 K1-bwd each), LS_WINDOW timed
    ones beside phase 5's ms, peak memory, the gammas and `pos_embed`
    moved; then layerscale_vs_plain, one micro-batch of 2 clips through
    fused and plain attention held as train_vs_plain holds the slot step,
    the gammas' and `pos_embed`'s gradients finite and non-zero. Returns
    the K1 counts."""
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step
    from devias_tpu_torch.train.step import slot_loss

    loss_cfg, step_cfg = _train_parts()
    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **LS_KW, **SLOT_KW)
    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, **TEACHER_KW)
    sd = {k: v.cpu() for k, v in student.state_dict().items()}  # on the host: out of the peak memory read
    opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10, layer_decay=0.75))
    state = TrainState.create(student, opt)
    step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn)
    rng = np.random.default_rng(0)
    batch = {"videos": rng.standard_normal(CLIPS, dtype=np.float32), "labels": rng.integers(0, NUM_CLASSES, size=B)}
    params = dict(student.named_parameters())
    counts, ms, _ = _step_phase(attn, card, {"phase": "layerscale_train", "options": LS_KW,
                                             "extra_params": sum(params[n].numel() for n in params
                                                                 if "gamma" in n or n == "pos_embed"),
                                             "phase5_ms_per_step": train_ms},
                                step, state, batch, {"K1-fwd": 12, "K1-fwd-stats": 12, "K1-bwd": 12}, LS_WINDOW)
    changed = {n: (params[n].detach().cpu() - sd[n]).abs().max().item() for n in LS_WATCH}
    if not all(v > 0 for v in changed.values()):
        fail(f"layerscale_train left parameters unchanged: {changed}")
    del student, teacher, opt, state, step, params
    torch.cuda.empty_cache()

    videos, labels, draws = _small_slot_batch(1)

    def build(fused):
        m = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=fused, **LS_KW, **SLOT_KW)
        m.load_state_dict(sd)
        return m

    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=False, **TEACHER_KW)
    (loss_f, grads_f), (loss_p, grads_p) = _fused_vs_plain(
        build, lambda m, g: slot_loss(m, teacher, videos, labels, loss_cfg, step_cfg, g, draws)[0], LS_WATCH)
    row = {"phase": "layerscale_vs_plain", "card": card, "clips": 2, "param_max_change": changed}
    ok = _held(row, loss_f, loss_p, grads_f, grads_p)
    emit(row)
    nonzero = all(grads_f[n].abs().max().item() > 0 for n in LS_WATCH)
    if not ok or not nonzero:
        fail(f"layerscale: fused and plain disagree beyond their limits, or a watched gradient is zero: {row}")
    del teacher
    torch.cuda.empty_cache()
    return counts


GEOMETRY_KW = dict(patch_size=32, mlp_ratio=2.0, qkv_bias=False, qk_scale=0.1, norm_eps=1e-5)
GEOMETRY_ITERS = 10
ROWSUM_TOL = 1e-2


def phase_geometry_eval(attn, card):
    """The eval forward of a SlotViT-B with GEOMETRY_KW (392 tokens of
    32x32 patches, a 2x MLP, no q/v biases, logit scale 0.1, eps 1e-5) at
    B=12 in bf16: 12 K1-fwd at N = 392 (the scale, not a power of two,
    applied to q before the kernel), its logits against the plain
    attention's on the same weights within PLAIN_TOL of their RMS; then
    block 0's `Attention` of the flagship student with `return_attn=True`
    on a [12, 1568, 768] input: no K1 launch, `out` within PLAIN_TOL of
    K1's output's RMS, every row of the probabilities summing to 1 within
    ROWSUM_TOL. Returns the K1 counts."""
    from devias_tpu_torch.nn import create_model

    videos = torch.from_numpy(np.random.default_rng(7).standard_normal(CLIPS, dtype=np.float32)).cuda()
    model = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **GEOMETRY_KW, **SLOT_KW)
    plain = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=False, **GEOMETRY_KW, **SLOT_KW)
    plain.load_state_dict(model.state_dict())
    attn.reset_launch_counts()
    with torch.inference_mode():
        got = model(videos)
        torch.cuda.synchronize()
        counts = attn.launch_counts()
        by_heads = attn.launch_counts_by_heads()
        t0 = time.perf_counter()
        for _ in range(GEOMETRY_ITERS):
            model(videos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / GEOMETRY_ITERS * 1e3
        want = plain(videos)
    a, b = got["slots_head"].float(), want["slots_head"].float()
    err, rms = (a - b).abs().max().item(), _rms(b)
    row = {"phase": "geometry_eval", "card": card, "options": GEOMETRY_KW, "clips": B,
           "tokens": (CLIPS[1] // 2) * (CLIPS[2] // GEOMETRY_KW["patch_size"]) ** 2,
           "launches": counts, "launches_by_heads": by_heads, "ms": ms, "logits_max_abs_err": err, "logits_rms": rms,
           "tol": PLAIN_TOL * rms, "finite": bool(torch.isfinite(a).all().item()),
           "mask_width": got["mask_predictions"].shape[-1]}
    del model, plain, got, want
    torch.cuda.empty_cache()

    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
    block = student.blocks[0].attn
    n = (CLIPS[1] // 2) * (CLIPS[2] // 16) ** 2  # 1568
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, n, student.embed_dim), dtype=np.float32))
    x = x.cuda().to(torch.bfloat16)
    with torch.inference_mode():
        k1 = block(x)
        attn.reset_launch_counts()
        out, probs = block(x, return_attn=True)
        torch.cuda.synchronize()
        ra_counts = attn.launch_counts()
        rows = probs.float().sum(-1)
    ra = {"probs_shape": list(probs.shape), "out_max_abs_err_vs_k1": (out.float() - k1.float()).abs().max().item(),
          "k1_rms": _rms(k1.float()), "row_sum_max_dev": (rows - 1).abs().max().item(), "launches": ra_counts}
    row["return_attn"] = ra
    emit(row)
    del student, block, x, k1, out, probs, rows
    torch.cuda.empty_cache()
    ok = (row["finite"] and err <= PLAIN_TOL * rms and row["mask_width"] == 49
          and ra["out_max_abs_err_vs_k1"] <= PLAIN_TOL * ra["k1_rms"] and ra["row_sum_max_dev"] <= ROWSUM_TOL
          and not any(ra_counts.values()))
    if not ok:
        fail(f"geometry_eval: {row}")
    _check_k1("geometry_eval", counts, {"K1-fwd": 12})
    return counts


def phase_int8_student(attn, card):
    """The flagship student's eval forward at B=12 in bf16 and with
    `int8_dense=True` (the w8a8 student: the blocks' qkv, proj, fc1 and fc2
    through `torch._int_mm`), the same seeded weights with a spread head:
    12 K1-fwd each, ms per forward, the slot logits' largest difference,
    cosine (held to INT8_COSINE) and argmax agreement. Returns the K1
    counts."""
    from devias_tpu_torch.nn import create_model

    videos = torch.from_numpy(np.random.default_rng(9).standard_normal(CLIPS, dtype=np.float32)).cuda()
    logits, ms, total = {}, {}, None
    for label, int8 in (("bf16", False), ("int8", True)):
        student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, int8_dense=int8, **SLOT_KW)
        _spread_heads(student, 26)
        attn.reset_launch_counts()
        with torch.inference_mode():
            logits[label] = student(videos)["slots_head"].float()
            counts = attn.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INT8_ITERS):
                student(videos)
            torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) / INT8_ITERS * 1e3
        _check_k1(f"int8_student ({label})", counts, {"K1-fwd": 12})
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        del student
    a, b = logits["bf16"], logits["int8"]
    cosine = F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
    emit({"phase": "int8_student", "card": card, "clips": B, "iters": INT8_ITERS, "ms": ms,
          "int8_over_bf16": ms["int8"] / ms["bf16"], "logits_max_abs_diff": (a - b).abs().max().item(),
          "logits_max_abs": a.abs().max().item(), "logits_cosine": cosine, "cosine_min": INT8_COSINE,
          "argmax_agreement": (a.argmax(-1) == b.argmax(-1)).float().mean().item()})
    if not cosine >= INT8_COSINE:
        fail(f"int8 student: cosine {cosine}")
    torch.cuda.empty_cache()
    return total


AGG_OPTIONS = dict(heads=8, dim_head=96, ff_mult=2, attn_dropout=0.1, ff_dropout=0.1, last_ln=False,
                   pos_enc_type="sine1d")
AGG_ITERS = 10


def phase_agg_options(card):
    """`AggregationBlock(**AGG_OPTIONS)` (8 tied rounds over 2 slots) on the
    flagship student's tokens [12, 1568, 768] in bf16: forward and backward
    in training (ms, the gradients finite, the share of dropout keeps
    drawn), the eval forward (ms) against the same weights run by the port
    in float32 on the CPU: the RMS of the difference within SLICE_TOL of
    that output's RMS (8 rounds of bf16 residual adds without the final
    norm; the largest difference is printed beside it)."""
    from devias_tpu_torch.nn import AggregationBlock, create_model
    from devias_tpu_torch.nn import vit

    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, **SLOT_KW)
    videos = torch.from_numpy(np.random.default_rng(10).standard_normal(CLIPS, dtype=np.float32)).cuda()
    with torch.no_grad():
        tokens = student.forward_features(videos)
    del student
    D = tokens.shape[-1]
    agg = AggregationBlock(2, D, 8, True, torch.bfloat16, **AGG_OPTIONS)
    vit.init_weights(agg, torch.Generator().manual_seed(12))
    cpu_agg = AggregationBlock(2, D, 8, True, torch.float32, **AGG_OPTIONS)
    cpu_agg.load_state_dict(agg.state_dict())
    cpu_agg.eval()
    agg.cuda().train()

    kept, keep_mask = [], vit._keep_mask

    def counting(shape, keep, generator, device):
        mask = keep_mask(shape, keep, generator, device)
        kept.append(mask.float().mean())
        return mask

    gen = torch.Generator(device="cuda").manual_seed(13)
    vit._keep_mask = counting
    try:
        ctx = tokens.detach().requires_grad_()
        slots, P = agg(ctx, gen)
        (slots.float().square().mean() + P.float().mean()).backward()
    finally:
        vit._keep_mask = keep_mask
    grads_finite = all(bool(torch.isfinite(p.grad).all().item()) for p in agg.parameters()) \
        and bool(torch.isfinite(ctx.grad).all().item())
    keep_share = torch.stack(kept).mean().item()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AGG_ITERS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / AGG_ITERS * 1e3

    def train_step():
        agg.zero_grad(set_to_none=True)
        s, p = agg(tokens.detach().requires_grad_(), gen)
        (s.float().square().mean() + p.float().mean()).backward()

    train_ms = timed(train_step)
    agg.eval()
    with torch.no_grad():
        eval_ms = timed(lambda: agg(tokens))
        got, got_P = agg(tokens)
        want, want_P = cpu_agg(tokens.float().cpu())
    diff = got.float().cpu() - want
    err, rms_err, rms = diff.abs().max().item(), _rms(diff), _rms(want)
    row = {"phase": "agg_options", "card": card, "options": AGG_OPTIONS, "depth": 8, "tokens": list(tokens.shape),
           "draws": len(kept), "keep_share": keep_share, "keep_expected": 0.9, "grads_finite": grads_finite,
           "train_ms": train_ms, "eval_ms": eval_ms, "slots_max_abs_err_vs_cpu_f32": err,
           "slots_rms_err_vs_cpu_f32": rms_err, "slots_rms": rms,
           "P_max_abs_err_vs_cpu_f32": (got_P.float().cpu() - want_P).abs().max().item(), "tol": SLICE_TOL * rms,
           "last_layer": agg.last_layer is not None}
    emit(row)
    if not grads_finite or len(kept) != 16 or abs(keep_share - 0.9) > 0.01 or rms_err > SLICE_TOL * rms:
        fail(f"agg_options: {row}")
    del agg, cpu_agg, tokens, ctx, slots, P, got, want
    torch.cuda.empty_cache()


YUV_REPEAT = 2  # passes over the 12 train files (24 clips each) for the loader's rate
YUV_LEVELS = 2.0


def _wire_loader(args, root: str, wire: str) -> dict:
    """The CLI's training loader over YUV_REPEAT passes of the train files
    with uint8 clips on `wire` (random erasing off): clips/s after the
    first batch, bytes per clip, and the first batch."""
    from devias_tpu_torch.cli import common
    from devias_tpu_torch.data import build_dataset

    train = os.path.join(root, "train.csv")
    with open(train) as f:
        lines = f.read().splitlines()
    listed = os.path.join(root, f"wire_{wire}")
    os.makedirs(listed, exist_ok=True)
    with open(os.path.join(listed, "train.csv"), "w") as f:
        f.write("\n".join(lines * YUV_REPEAT))
    # uint8 clips leave the host only without random erasing (its output is
    # normalised floats), in both packages
    cfg = common.make_data_config(args, data_path=listed, host_normalize=False, wire_format=wire, reprob=0.0)
    dataset, _ = build_dataset(True, False, cfg)
    loader = common.make_train_loader(dataset, args)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    arrivals, clips, first = [], [], None
    try:
        for batch in loader:
            arrivals.append(time.perf_counter() - t0)
            clips.append(batch["videos"].shape[0])
            first = batch if first is None else first
    finally:
        loader.close()
    v = first["videos"]
    return {"batches": len(arrivals), "clips": sum(clips), "clip_shape": list(v.shape[1:]), "dtype": str(v.dtype),
            "bytes_per_clip": v[0].nbytes, "clips_per_s": sum(clips) / arrivals[-1],
            "clips_per_s_after_first": sum(clips[1:]) / (arrivals[-1] - arrivals[0]), "first": first}


def phase_yuv_wire(attn, card, root: str):
    """The I420 wire on REAL_SPLITS' mp4 files: the CLI's training loader
    (24 clips a batch, YUV_REPEAT passes) with `wire_format='yuv420'` and
    with uint8 RGB, their clips/s and bytes per clip (I420 half of RGB's);
    `i420_to_rgb` on the card against cv2's `COLOR_YUV2RGB_I420` on the
    host for the first I420 batch, within YUV_LEVELS of 255; then one slot
    train step at B=12 on the I420 clips with `device_normalize` (student
    and teacher with `input_norm`): ms, a finite loss, 12 of each K1 form.
    Returns the K1 counts."""
    import cv2

    from devias_tpu_torch.cli import run_slot_finetuning as cli
    from devias_tpu_torch.data import i420_to_rgb
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer, make_slot_train_step

    args = cli.get_args(REAL_CLI_FLAGS + ["--data_path", root, "--output_dir", os.path.join(root, "wire_out")])
    wires = {wire: _wire_loader(args, root, wire) for wire in ("yuv420", "rgb")}
    yuv_batch = wires["yuv420"].pop("first")
    wires["rgb"].pop("first")
    planes = yuv_batch["videos"][0]  # [T, H*3/2, W] uint8
    with torch.inference_mode():
        rgb = (i420_to_rgb(torch.from_numpy(planes).cuda()) * 255.0).cpu().numpy()
    ref = np.stack([cv2.cvtColor(p, cv2.COLOR_YUV2RGB_I420) for p in planes]).astype(np.float32)
    levels = float(np.abs(rgb - ref).max())

    loss_cfg, step_cfg = _train_parts()
    step_cfg = dataclasses.replace(step_cfg, wire_format="yuv420", device_normalize=True)
    student = create_model("slot_vit_base_patch16_224", seed=0, fused_attention=True, input_norm=True, **SLOT_KW)
    teacher = create_model("vit_base_patch16_224", seed=1, fused_attention=True, input_norm=True, **TEACHER_KW)
    opt, lr_fn = make_optimizer(student, OptimConfig(lr=5e-4, total_steps=1000, warmup_steps=10))
    state = TrainState.create(student, opt)
    step = make_slot_train_step(student, teacher, opt, loss_cfg, step_cfg, lr_fn)
    batch = {k: torch.from_numpy(yuv_batch[k][:B]).cuda() for k in ("videos", "labels")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch, generator=gen)  # warm
    torch.cuda.synchronize()
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = step(state, batch, generator=gen, host_metrics=True)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = attn.launch_counts()
    ratio = wires["yuv420"]["bytes_per_clip"] / wires["rgb"]["bytes_per_clip"]
    row = {"phase": "yuv_wire", "card": card, "loaders": wires, "i420_over_rgb_bytes": ratio,
           "i420_to_rgb_max_levels_vs_cv2": levels, "levels_tol": YUV_LEVELS, "step_clips": B, "step_ms": step_ms,
           "loss": metrics["loss"], "launches": counts}
    emit(row)
    if ratio != 0.5 or levels > YUV_LEVELS or not np.isfinite(metrics["loss"]):
        fail(f"yuv_wire: {row}")
    _check_k1("yuv_wire", counts, {"K1-fwd": 12, "K1-fwd-stats": 12, "K1-bwd": 12})
    del student, teacher, opt, state, step, batch, yuv_batch
    torch.cuda.empty_cache()
    return counts


KILL_EPOCHS, KILL_STEPS = 3, 2
KILL_WORKER = os.path.join("tests", "_torch_kill_resume_worker.py")


def _kill_runs(flags, runs) -> list:
    """Processes of the port's CLI through the kill-resume program, one per
    (output dir, stopping point) of `runs`, started at once, each with its
    stdout under its output dir; a run with a stopping point gets SIGKILL
    once it stops there. Returns each run's stdout."""
    import signal

    procs, texts = [], []
    try:
        for out, kill_at in runs:
            env = dict(os.environ, PYTHONPATH=os.getcwd())
            env.pop("DEVIAS_KILL_AT", None)
            marker = os.path.join(out, "stopped")
            if kill_at is not None:
                env.update(DEVIAS_KILL_AT=kill_at, DEVIAS_KILL_MARKER=marker)
            os.makedirs(out, exist_ok=True)
            log = open(os.path.join(out, f"stdout_{kill_at or 'run'}.log"), "w")
            procs.append((subprocess.Popen([sys.executable, KILL_WORKER] + flags + ["--output_dir", out], env=env,
                                           stdout=log, stderr=subprocess.STDOUT), log, marker, kill_at, out))
        for p, log, marker, kill_at, out in procs:
            deadline = time.monotonic() + 600
            while kill_at is not None and not os.path.exists(marker):
                if p.poll() is not None or time.monotonic() > deadline:
                    fail(f"kill_resume: the run ended or stalled before its stopping point ({out})")
                time.sleep(0.1)
            if kill_at is not None:
                os.kill(p.pid, signal.SIGKILL)
            rc = p.wait(timeout=600)
            log.close()
            with open(log.name) as f:
                text = f.read()
            if (rc != -signal.SIGKILL) if kill_at is not None else (rc != 0):
                fail(f"kill_resume: exit {rc}: {text[-3000:]}")
            texts.append(text)
    finally:
        for p, log, *_ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return texts


def _train_records(out: str) -> dict:
    recs = {}
    with open(os.path.join(out, "log.txt")) as f:
        for line in f:
            r = json.loads(line)
            if "epoch" in r and "train_loss" in r:
                recs[r["epoch"]] = {k: v for k, v in r.items() if k.startswith("train_") and k != "train_time_s"}
    return recs


def _diff(a, b, where: str, out: list) -> None:
    """The paths where `a` and `b` differ, with the largest difference of
    each differing tensor."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)):
            d = (a.double() - b.double()).abs().max().item() if isinstance(b, torch.Tensor) and a.shape == b.shape \
                and a.is_floating_point() else None
            out.append((where, d))
    elif isinstance(a, dict):
        if set(a) != set(b):
            out.append((where, "keys"))
        for k in a:
            if k in b:
                _diff(a[k], b[k], f"{where}.{k}", out)
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            out.append((where, "length"))
        for i, (x, y) in enumerate(zip(a, b)):
            _diff(x, y, f"{where}[{i}]", out)
    elif a != b:
        out.append((where, (a, b)))


def phase_kill_resume(card):
    """The CLI's full-width flags (CLI_FLAGS, EMA on) for KILL_EPOCHS
    epochs of KILL_STEPS steps with a checkpoint each epoch, in processes
    of `tests/_torch_kill_resume_worker.py`, one after another (two at once
    on the card were not bitwise: their atomic sums interleave
    differently): an uninterrupted run; a run SIGKILLed at its stopping
    point, the second step of epoch 2 (after `checkpoint-1.pth`); the same
    flags relaunched, which resumes after epoch 1. The resumed run's train records and final checkpoint (model,
    EMA, optimizer state and count, step, generator state) must equal the
    uninterrupted run's bitwise. The K1 launches are the processes' own,
    not counted here."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "filelist")
        os.makedirs(data)
        for name, n in (("train.csv", B * KILL_STEPS), ("val.csv", B), ("test.csv", B // 2)):
            with open(os.path.join(data, name), "w") as f:
                f.write("\n".join(f"clip{i:03d}.mp4 {i % NUM_CLASSES}" for i in range(n)))
        flags = CLI_FLAGS + ["--data_path", data, "--epochs", str(KILL_EPOCHS), "--max_steps_per_epoch",
                             str(KILL_STEPS), "--save_ckpt_freq", "1", "--model_ema", "--disable_eval_during_finetuning"]
        seconds = {}
        t0 = time.perf_counter()
        full, killed = os.path.join(tmp, "full"), os.path.join(tmp, "killed")
        _kill_runs(flags, [(full, None)])
        seconds["uninterrupted"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _kill_runs(flags, [(killed, f"step:{2 * KILL_STEPS + 1}")])
        seconds["killed"] = time.perf_counter() - t0
        saved = sorted(os.listdir(os.path.join(killed, "ckpt")))
        partial = sorted(_train_records(killed))
        t0 = time.perf_counter()
        text, = _kill_runs(flags, [(killed, None)])
        seconds["resumed"] = time.perf_counter() - t0
        final = f"checkpoint-{KILL_EPOCHS - 1}.pth"
        want = torch.load(os.path.join(full, "ckpt", final), map_location="cpu", weights_only=True)
        got = torch.load(os.path.join(killed, "ckpt", final), map_location="cpu", weights_only=True)
        diffs = []
        _diff(got, want, "checkpoint", diffs)
        same_records = _train_records(killed) == _train_records(full)
    row = {"phase": "kill_resume", "card": card, "epochs": KILL_EPOCHS, "steps_per_epoch": KILL_STEPS,
           "checkpoints_at_kill": saved, "records_at_kill": partial,
           "resumed_after_epoch_1": "auto-resumed from epoch 1" in text, "seconds": seconds,
           "records_equal": same_records, "checkpoint_bitwise": not diffs, "differences": diffs[:20],
           "ema": want["model_ema"] is not None, "step": want["step"]}
    emit(row)
    if saved != ["checkpoint-0.pth", "checkpoint-1.pth"] or partial != [0, 1] or not row["resumed_after_epoch_1"] \
            or not same_records or diffs or not row["ema"]:
        fail(f"kill_resume: {row}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-rank"]:  # a process of the dp_train phase
        dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--parallel-rank"]:  # a process of the parallel_modes phase
        parallel_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    try:
        from devias_tpu_torch.kernels import _build as build
        from devias_tpu_torch.kernels import attention as attn
        from devias_tpu_torch.kernels import patch_embed as pe
        from devias_tpu_torch.kernels import slot_attention as sa
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root", file=sys.stderr)
        return 1

    start = time.perf_counter()
    card = phase_device(build)
    fwd_err, fwd_timing = phase_kernel(attn)
    stats_err, stats_timing = phase_kernel_stats(attn)
    bwd_err, bwd_timing = phase_kernel_bwd(attn)
    tp_timing = phase_kernel_tp(attn)
    q_kv_err, q_kv_timing = phase_kernel_q_kv(attn)
    phase_sp_compose(attn)
    hm_err, hm_timing = phase_kernel_head_major(attn)
    sa_err, sa_timing = phase_kernel_slot_attention(sa)
    pe_err, pe_timing = phase_kernel_patch_embed(pe)
    # K4 and K5 lie on no path: their counts over the main paths below
    sa.fused_slot_attention.launches = pe.patchify_embed.launches = 0
    eval_launches = phase_slice(attn, card)
    train_launches, train_ms = phase_train(attn, card)
    phase_train_vs_plain(card)
    sp_launches = phase_sp_train(attn, card)
    cli_launches = phase_cli(attn, card, train_ms)
    phase_cli_host_rate(card, train_ms)
    dp_launches = phase_dp_train(attn, card)
    hat_launches = phase_hat(attn, card)
    hvu_launches, _ = phase_hvu_train(attn, card)
    hvu_cli_launches = phase_hvu_cli(attn, card)
    class_launches, _ = phase_class_train(attn, card)
    class_cli_launches = phase_class_cli(attn, card)
    ds_launches, _ = phase_downstream_train(attn, card)
    ds_cli_launches = phase_downstream_cli(attn, card)
    mt_launches, _ = phase_mt_train(attn, card)
    mt_cli_launches = phase_mt_cli(attn, card)
    options_launches = phase_options_train(attn, card, train_ms)
    phase_fame_modes(card)
    attn_drop_launches = phase_attn_drop_train(attn, card)
    int8_launches = phase_int8_teacher(attn, card)
    options_cli_launches = phase_options_cli(attn, card)
    with tempfile.TemporaryDirectory() as videos:
        emit({"phase": "real_videos", **write_real_videos(videos)})
        real_launches = phase_real_video_cli(attn, card, videos)
        phase_loader_split(card, videos, train_ms)
    seg_launches = phase_segformer_train(attn, card)
    seg_cli_launches = phase_segformer_cli(attn, card)
    parallel_launches = phase_parallel_modes(attn, card)
    overfit_launches = phase_overfit(attn, card)
    health_launches = phase_health_run(attn, card)
    profile_launches = phase_profile_step(attn, card)
    layerscale_launches = phase_layerscale_train(attn, card, train_ms)
    geometry_launches = phase_geometry_eval(attn, card)
    int8_student_launches = phase_int8_student(attn, card)
    phase_agg_options(card)
    with tempfile.TemporaryDirectory() as videos:
        write_real_videos(videos)
        yuv_launches = phase_yuv_wire(attn, card, videos)
    phase_kill_resume(card)

    def launches(name):
        return sum(c[name] for c in (train_launches, sp_launches, cli_launches, dp_launches, hat_launches,
                                     hvu_launches, hvu_cli_launches, class_launches, class_cli_launches,
                                     ds_launches, ds_cli_launches, mt_launches, mt_cli_launches, options_launches,
                                     attn_drop_launches, int8_launches, options_cli_launches, real_launches,
                                     seg_launches, seg_cli_launches, parallel_launches, overfit_launches,
                                     health_launches, profile_launches, layerscale_launches, geometry_launches,
                                     int8_student_launches, yuv_launches))

    def at_1570(t):
        return {k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    # K2 in the kernels line at the shape the one-card SP step gives it; the
    # four-shard shape beside it
    main_shape, shard_shape = Q_KV_SHAPES[1], Q_KV_SHAPES[0]
    rows = (
        ("K1-fwd fused_attention_qkv", "attention_fwd.cu", "devias_tpu/kernels/attention.py:377",
         eval_launches + launches("K1-fwd"), fwd_err,
         dict(fwd_timing[1568], n1570=at_1570(fwd_timing[1570]), tp_heads6=tp_timing["K1-fwd"])),
        ("K1-fwd-stats attention_qkv_fwd_stats", "attention_fwd.cu", "devias_tpu/kernels/attention.py:377",
         launches("K1-fwd-stats"), stats_err,
         dict(stats_timing[1568], n1570=at_1570(stats_timing[1570]), tp_heads6=tp_timing["K1-fwd-stats"])),
        ("K1-bwd attention_qkv_bwd", "attention_bwd.cu", "devias_tpu/kernels/attention.py:426",
         launches("K1-bwd"), bwd_err,
         dict(bwd_timing[1568], n1570=at_1570(bwd_timing[1570]), tp_heads6=tp_timing["K1-bwd"])),
    ) + tuple(
        (f"{kid} {fn}", src, f"devias_tpu/kernels/attention.py:{line}", launches(kid), q_kv_err[kid],
         dict(q_kv_timing[main_shape][kid], shape=list(main_shape), four_shard=q_kv_timing[shard_shape][kid]))
        for kid, fn, src, line in (("K2-fwd", "fused_attention_q_kv", "attention_fwd.cu", 546),
                                   ("K2-fwd-stats", "attention_q_kv_fwd_stats", "attention_fwd.cu", 546),
                                   ("K2-bwd", "attention_q_kv_bwd", "attention_bwd.cu", 593))
    ) + (
        ("K3-fwd fused_attention", "attention_fwd.cu", "devias_tpu/kernels/attention.py:169",
         launches("K3-fwd"), hm_err["K3-fwd"], hm_timing["K3-fwd"]),
        ("K3-bwd attention_head_major_bwd", "attention_fwd.cu + attention_bwd.cu",
         "devias_tpu/kernels/attention.py:192", launches("K3-bwd"), hm_err["K3-bwd"], hm_timing["K3-bwd"]),
        ("K4 fused_slot_attention", "slot_attention.cu", "devias_tpu/kernels/slot_attention.py:101",
         sa.fused_slot_attention.launches, sa_err, sa_timing),
        ("K5 patchify_embed", "patch_embed.cu", "scripts/retest_patchify_pallas.py:35",
         pe.patchify_embed.launches, pe_err, pe_timing),
    )
    emit({"phase": "script", "card": card, "seconds": time.perf_counter() - start})
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": " + ".join(f"devias_tpu_torch/kernels/csrc/{f}" for f in src.split(" + ")),
        "replaces": replaces, "launches": n, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        **{k: t[k] for k in ("shape", "four_shard", "n1570", "tp_heads6") if k in t},
    } for name, src, replaces, n, err, t in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
