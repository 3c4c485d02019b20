"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one status line each:
  1. the card (torch and ``nvidia-smi`` name / power limit);
  2. build of the CUDA kernels from the repository's sources (nvcc, one
     process per source, all started together), and ``cuobjdump -sass`` of
     the library: the halo log-mel's kernel, the bf16 v1/v2 halves' qkv and
     proj products and the f32 block's and merge's products hold HGMMA and
     UTMALDG (wgmma, fed by TMA), the f32 MLP's fc1 and fc2 also USETMAXREG
     (setmaxnreg), the int8 MLP's fc1 and fc2 IGMMA and
     UTMALDG (int8 wgmma), the f32 window attention and the merged
     attention (bf16, f32) HMMA (mma.sync on the tensor cores), the PRDC
     statistics' LDGSTS (cp.async); no instantiation
     of the deleted WMMA gemm_kernel and no IMMA (int8 mma.sync) is left;
  3. each kernel against its plain PyTorch version on the card, at the
     main-path shapes, with errors, tolerances and times: first the f32
     MLP (#9 f32, whose two products are the f32 block's launches 6-7) at
     C = 96, 128, 256, 512 and 1024 on the row counts that reach the edges
     of its products' schedule (``testing.mlp_f32_edge_rows``: a partial
     last 128-row tile within one consumer warpgroup's 64 rows or across
     both, three row tiles, one tile a block and 2 or 3 a block; depths on
     both sides of the consumers' epilogue share, an odd number of K
     steps), the allocator's blocks filled with NaN before each call, with
     bitwise repeats; bf16 Swin blocks
     (every stage shifted and unshifted), patch merges and the 5 s
     frontend (B=4) with weights under which every part of a block moves
     its output; the f32 k-NN radii and PRDC statistics at (2048, 2048) x
     512 (bench.py's size) and (10000, 12345) x 512 (ragged against any
     tile), the booleans and counts under the near-tie rule; the two
     log-mels at the CLAP 10 s geometry (BatchNorm affine, bf16 out), on
     CLAP 7 s clips and at the VGGish convention, the v1 kernel also at
     CLAP's frame at hop 484 (the halo kernel at that hop: phase 20), each twice on
     the same inputs (bitwise equal), with its DFT's achieved TFLOP/s and
     the time of each of its two launches (torch.profiler), and the v1
     kernel's output against the halo kernel's on the same clips (printed:
     they should be bitwise equal); the FAD device tail against the host
     float64 path; and the f32 MLP's three launches at every stage of
     HTSAT-base and HTSAT-tiny at B = 64 (torch.profiler) with each
     product's TFLOP/s against 165 (``profile_mlp_f32``'s table);
  4. the main path end to end: ``AudioMetrics(metrics=["fad", "kd",
     "prdc"])`` with LaionCLAP HTSAT-base in bf16 (random weights from a
     seed) over 2048 reference and 2048 candidate 5 s clips at 48 kHz
     already on the card (bench.py's eval set), with the kernels' launch
     counts, FAD of a set against itself, PRDC through the kernels against
     PRDC through the plain versions on the same stored embeddings, and the
     same evaluate through the plain versions;
  5. the 10 s path: ``win_dur=10.0`` (windows that do not tile 10 s take
     the halo log-mel kernel), 128 + 128 clips, launch counts, FAD of a set
     against itself, embeddings against the plain path, clips/s;
  6. split blocks: ``AM_TPU_V4_STAGES=""``, every Swin block as the v3
     attention-half kernel then the fused-MLP kernel (or the XLA MLP at
     stage 3's 4096 rows), 512 + 512 5 s clips: launch counts, FAD of a set
     against itself, embeddings against the plain path and against the
     default (whole-block) configuration on the same clips, clips/s;
  7. v1 attention: ``AM_TPU_ATTN_V1=1``, the v1 attention-half kernel at
     stages 0 and 1 and the XLA attention at stages 2 and 3, 256 + 256
     clips, as phase 6;
  8. v1 log-mel: ``AM_TPU_MEL_V1=1`` on the 10 s path (phase 5's clips):
     launch counts (one v1 log-mel a forward), clips/s, and embeddings
     against phase 5's halo log-mel path;
  9. the two opt-in ops, which no model path calls (in the JAX package as
     here), on the activations of a real forward: one default HTSAT-base
     bf16 forward of 64 clips of 5 s with phase 4's weights captures each
     of the 18 Swin blocks' inputs; on each, the v2 attention half
     (``swin_attention_half_v2``) with that block's weights, then the int8
     MLP (``mlp_block_int8``) on its output with that block's f32 MLP
     weights, their codes held (``mlp_int8_operands``): launch counts, each
     against its plain version, the int8 MLP's branch against the fused
     bf16 MLP kernel's, per-forward times (the int8 MLP also quantising its
     weights per call, and that quantisation alone);
     then the same two ops in f32 on the inputs of one f32 forward with
     phase 10's weights (their f32 kernels);
 10. the default configuration, f32: phase 3's weights written as a
     LAION-named checkpoint (``module.`` prefix, fused qkv) under the
     default embedder's file name in a temporary directory, named by
     ``AM_TPU_CKPT_DIR`` around this phase only; ``AudioMetrics(metrics=
     ["fad", "kd", "prdc"])`` with no embedder builds ``laion_clap_music``
     from it (HTSAT-base, f32) and evaluates 256 + 256 5 s clips: launch
     counts (the f32 whole-block and merge kernels only), finite metrics,
     FAD of a set against itself, embeddings against the f32 plain chain
     on the card, clips/s;
 11. the default configuration, f32, split: phase 10's checkpoint and
     clips under ``AM_TPU_V4_STAGES=""`` (the f32 v3 attention half and the
     f32 fused MLP, the XLA MLP at stage 3's 4096 rows) and under
     ``AM_TPU_ATTN_V1=1`` (the f32 v1 half at stages 0-1, the XLA attention
     at 2-3), each as phase 10: launch counts (f32 kernels only), finite
     metrics, FAD of a set against itself, embeddings against the f32 plain
     chain, clips/s;
 12. VGGish (bench.py's ``main_vggish`` without its APA mix): seeded
     torchvggish-named weights written as ``vggish-10086976.pth`` in a
     temporary directory that ``AM_TPU_CKPT_DIR`` names around this phase;
     bf16 ``VGGish`` over 2048 + 2048 5 s clips at 16 kHz, batch 512,
     FAD+KD+PRDC: launch counts (#4 and #5 only), finite metrics, FAD of a
     set against itself, PRDC through the kernels against the plain
     versions, clips/s of three warm evaluates (median and spread),
     ``timings``, the log-mel's and the conv stack's times on one batch;
     then ``vggish`` by name (f32) on 256 + 256 of the clips, its
     embeddings against the bf16 ones (``VGGISH_BF16_TOL``);
 13. the stems options on HTSAT-base bf16 with phase 4's weights:
     ``hop_dur=2.5`` on 128 + 128 10 s clips (3 windows a clip, FAD of a
     set against itself, the windows' embeddings against the same slices
     embedded directly); ``input_sr=44100`` on 128 + 128 5 s clips (the
     resampler against ``scipy.signal.resample_poly`` at atol 2e-6 and its
     time on 64 windows, finite metrics, clips/s); ``n_pca=64`` on 256 +
     256 clips (finite, FAD of a set against itself); ``precompile()`` on
     that instance (its references and projection bitwise as before, the
     next evaluate equal to a fresh instance's); ``AM_TPU_NO_MEL_TILE=1``
     (set around it only) on 128 + 128 5 s clips: one #6 a forward and no
     #3, embeddings against the default path under ``CONFIG_TOL``;
 14. the OOM retry: under ``torch.cuda.set_per_process_memory_fraction``
     (restored in a ``finally``), ``AudioMetrics`` at batch 1024 on 1024 +
     1024 5 s clips halves its batch until it fits, logging the warning
     each time; its result against a run at the batch that fit, under
     phase 4's end-to-end bounds;
 15. the APA path: (a) ``bench.py``'s ``main_apa``, ``AudioMetrics(
     metrics=["apa", "fad"])``, ``L0``, HTSAT-base bf16 with phase 4's
     weights, 1024 + 1024 5 s pairs made on the card
     (``testing.seeded_pairs``), batch 512: launch counts, d(x, x'), APA in
     [0, 1], APA of the reference against itself, the evaluate through the
     plain versions on the same state file, pairs/s and ``timings``, the
     card's L0 mix against the CPU's and its loudness against -20 LUFS in
     the float64 oracle, its time beside its bound; (b) ``AudioMetrics(
     input_sr=48000)`` at its defaults (``laion_clap_music`` f32 from phase
     10's checkpoint), 128 + 128 pairs: launch counts, finite metrics,
     pairs/s;
 16. the host-fed path and the command line: (a) Python lists of numpy
     mono songs of 5.5-39.5 s at 48 kHz (``testing.seeded_songs``, each
     ending in a partial window) holding 2304 + 2304 5 s windows,
     ``AudioMetrics(metrics=["fad", "kd", "prdc", "fad_inf"])`` on
     HTSAT-base bf16 with phase 4's weights at the pre-ReLU projection tap
     (``laion_clap_music_l-2``'s; the default tap's embeddings of random
     weights have no full-rank covariance): launch counts, finite
     metrics, FAD of a set against itself, the same windows stacked on the
     card through the device path (stored embeddings bitwise equal, fad
     and kd under E2E_TOL, PRDC equal), FAD-inf on the card against the
     CPU over the same embeddings, clips/s (median and spread of three warm
     evaluates) and ``timings`` for the Python feeder,
     ``AM_TPU_NATIVE_LOADER=1``, ``AM_TPU_TRANSFER_INT16=1`` (each set
     around its run only) and the device path; (b) lists of context+stem
     songs holding 256 + 256 windows, ``metrics=["apa", "fad"]``, ``L0``,
     through both feeders: launch counts, finite metrics, APA in [0, 1],
     APA of the reference against itself, pairs/s; (c) the command line
     in-process (``__main__.main``): 64 + 64 mono 5 s WAV files at 48 kHz
     written by the port's ``wavio`` (float32, int16), ``evaluate
     --metrics fad kd prdc fad_inf`` in 0.5 s windows with
     ``laion_clap_music_l-2`` (f32) from phase 10's checkpoint
     (``AM_TPU_CKPT_DIR`` set around it): finite JSON, ``--save-state`` then ``--load-state`` FAD equal to
     rtol 1e-6, ``convert`` of the checkpoint equal to
     ``convert.convert_checkpoint``'s arrays;
 17. one ``AudioMetrics`` over a mesh (``parallel.mesh``: shards, each a
     device, a stream and a host thread of its own; ``phase_mesh``): (a)
     phase 4's main path over 4 shards on card 0 against one device on the
     same clips: launch counts (#1 1152, #2 192, #3 64, #4 8, #5 4),
     stored embeddings and k-NN radii bitwise equal, KD to 1e-12, the PRDC
     values equal, FAD (host float64 tail of four moment triples) within
     phase 4's bound of the device tail, warm clips/s of both and the
     card's busy and idle time in one traced evaluate of each; #4's
     query-row blocks of 512 bitwise equal to the whole set's radii, a
     block against its plain version, its time beside the whole set's;
     (b) the same shards laid out (dcn, data) = (2, 2), and
     ``replicate`` on card 0 (no storage shared, embeddings bitwise
     equal); (c) the APA pair path and the host-fed path over 2 shards
     against one device; (d) with two cards or more, (a) over every card,
     else one line saying why not; (e) the examples ``basic_usage`` and
     ``streaming_eval`` at small sizes;
 18. the public surface beyond ``AudioMetrics``' own embedders
     (``phase_surface``): (a) a forward-only wrapper of
     ``LaionCLAP.forward`` through ``AudioMetrics(["fad", "kd", "prdc"])``
     on phase 4's clips (launches #1 1152, #2 192, #3 64, #4 2, #5 1;
     stored embeddings bitwise phase 4's; warm clips/s beside phase 4's)
     and ``LaionCLAP.forward`` on 12 s clips bitwise ``embed`` of its host
     crops; (b) ``nearest_neighbour_distances`` and
     ``pairwise_distance_stats`` on 2048 x 512 features, one launch of #4 /
     #5 a call, against their plain versions on the CPU,
     ``kid_features_to_metric`` equal to ``kernel_distance``, the
     ``newton_schulz`` FAD within 1e-4 of ``eigh``; (c) ``AudioMetricsData``
     on numpy batches on the card, ``a + b`` against numpy float64.
 19. HTSAT-tiny (``phase_tiny``: embed 96, depths 2/2/6/2, heads 4/8/16/32
     of 24, the audio tower of LAION-CLAP's 630k checkpoints): (a) at its
     B = 64 shapes, #1 bf16 and f32 at every stage shifted and unshifted,
     #2 bf16 and f32 at the three merges, #3 at C = 96, each against its
     plain version under phase 3's bounds, one launch a call, repeated
     bitwise, ms per forward against the bound and the products alone;
     the window attention alone (``am_window_attn``, ``_f32``) at 24- and
     32-wide heads against ``ops.attention._window_context``; (b) its
     weights written as a LAION-named ``630k-audioset-best.pt``,
     ``LaionCLAP(cfg=HTSAT_TINY, ckpt=...)`` through phase 4's run in bf16
     (2048 + 2048 clips; #1 768, #2 192, #3 64, #4 2, #5 1) and phase 10's
     in f32 (256 + 256; #1 f32 96, #2 f32 24), warm clips/s the median of 3.
 20. The last narrow contracts (``phase_tiny_split``): (a) at HTSAT-tiny's
     B = 64 shapes, in bf16 and f32, #8 at every stage shifted and
     unshifted, #9 at stages 0-2, #10 at stages 0-1, then #11 and #12 on
     the Swin blocks' inputs of one real tiny forward, each against its
     plain version under phase 3's bounds, one launch a call, repeated
     bitwise, ms per forward against the bound and the library yardstick;
     (b) phase 19's checkpoint under ``AM_TPU_V4_STAGES=""`` (#8 12, #9 10,
     #2 3, #3 1 a forward) and ``AM_TPU_ATTN_V1=1`` (#10 4, #9 10), each in
     bf16 and f32 (the ``_f32`` kernels, no #3), 256 + 256 5 s clips:
     exact launches, finite metrics, self-FAD, embeddings against the
     plain path and within CONFIG_TOL of the tiny whole-block
     configuration on the same clips, warm clips/s the median of 3; (c)
     the halo and v1 log-mels at 128 and 96 mels and at hop 484 (the halo
     kernel's hop rows padded to 488) on CLAP's 10 s geometry against
     their plain versions under phase 3's log-mel bounds, repeated bitwise,
     timed against the bound.  That no kernel of the parent changed is a
     separate command: ``python -m audio_metrics_tpu_torch.sass_diff
     PARENT_CHECKOUT``.
 21. The merged one-window form of #10 and #11 (``phase_merged``;
     ``AM_TPU_MERGED_ATTN``: window = resolution = 16 at stage 2, one
     256-token attention an image on a dense (1, heads, 256, 256) table,
     kernels/csrc/merged_attn.cuh): (a) the merged v1 and v2 halves at
     stage 2 of HTSAT-base (C = 512) and
     HTSAT-tiny (C = 384), 16 heads, shift 0 and 4, bf16 and f32, B = 64,
     against their plain versions (the allocator's blocks filled with NaN
     first), one launch a call on their own counts, repeated bitwise, v2
     bitwise v1, v2 also on a dense random table (the kernel assumes no
     block structure); printed: each against the 8x8-window v1 half, the merged
     attention launch against the per-window one (torch.profiler), times
     against the bound, the library yardstick (qkv + proj) and the
     attention alone through ``scaled_dot_product_attention``; (b) under
     the switch, HTSAT-base bf16 (phase 4's weights), ``laion_clap_music``
     f32 (phase 10's checkpoint) and HTSAT-tiny bf16 (phase 19's), 256 +
     256 clips each after its whole-block configuration on the same clips:
     exact launches (base: #1 6, merged #10 12, #9 12 a forward), finite
     metrics, self-FAD, embeddings against the plain path and within
     CONFIG_TOL["merged"] of the whole block, clips/s as a ratio to it.
Phase 3 runs each kernel redesigned for Hopper on the wgmma core (the
whole Swin block at every stage and shift, its v3, v1 and v2 attention
halves and fused MLP, the three patch merges, the fused frontend, the two
log-mels, the int8 MLP) twice on the same inputs, at B = 4 and at B = 64,
and fails unless the outputs are bitwise equal (their GEMM core has no
atomics but the int8 MLP's integer max, so a race in its TMA ring shows as
a difference); it times the products of the
block, the merges, the frontend and the split halves alone through
``torch.matmul`` at B = 64 as their yardstick (``library_ms``, the port
never calls it), and prints their achieved TFLOP/s.  Every call it holds
against a plain version must launch its kernel exactly once.  The kernels
of ~0.3 ms or less (patch merge, k-NN radii and PRDC statistics at N =
2048, the two log-mels) are timed over 200 launches (``TIMING_ITERS``).
Phase 3 holds the f32 whole block (every stage and shift) and the f32
merges (their products on the 3xTF32 wgmma core) against their f32 plain
versions too, at B = 4 and at B = 64, with bitwise repeats, and times their
products alone through ``torch.matmul`` in full f32; and so the f32 kernels
of the split block and the opt-in ops (v3 and v2 halves at every stage, v1
at stages 0-1, the fused MLP and the int8 MLP at the row counts of stages
0-3), the v3 half then the MLP against the whole f32 block and the v2 half
against the v1 half (each pair bitwise equal: the same launches).
Phase 3 also holds the split block's kernels (v3 attention half at every
stage, the fused MLP at the row counts of stages 0-3, the v1 attention
half at stages 0 and 1, each on the operands the block holds from load),
the opt-in ops (the v2 attention half at every stage on its
``half_operands``, bitwise equal to the v1 kernel at stages 0 and 1; the
int8 MLP at the row counts of stages 0-3 on its ``mlp_int8_operands``) and
the v1 log-mel against their plain versions, the v3, v1 and v2 halves and
the int8 MLP at B = 4 and 64, and the v3 half then the MLP against the
whole-block kernel.  Each
environment variable is set only around the phase that reads it.
Then one JSON line with each kernel's numbers, the card line, and last the
ok line.  Any failure exits non-zero and prints no ok line.  Imports no JAX.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch

N_CLIPS = 2048   # bench.py's eval set
N_CLIPS_10S = 128
N_CLIPS_SPLIT = 512  # phase 6
N_CLIPS_V1 = 256     # phase 7
N_CLIPS_F32 = 256    # phases 10, 11
VGGISH_BATCH = 512   # phase 12, bench.py's main_vggish cap
N_CLIPS_VGGISH_F32 = 256  # phase 12 (b)
N_CLIPS_PCA = 256    # phase 13, n_pca and precompile
OOM_BATCH, OOM_FIT = 1024, 128  # phase 14: the batch asked for, the one the limit is set by
N_PAIRS_APA = 1024   # phase 15 (a), bench.py's main_apa
APA_BATCH = 512      # phase 15 (a), bench.py's min(BATCH_SIZE, n_pairs, 512)
N_PAIRS_DEFAULT = 128  # phase 15 (b)
MIX_CHUNK = 64       # the pair path's chunk for registry mixes
N_WIN_HOSTFED = 2304  # phase 16 (a): 36 batches of 64 5 s windows a set, >= 4 (d + 2)
N_WIN_HOSTFED_APA = 256  # phase 16 (b)
N_WAV = 64           # phase 16 (c): WAV files a directory
WAV_WIN_S = 0.5      # phase 16 (c): 10 windows a 5 s file, 640 > d + 2 for fad_inf
N_SHARDS = 4         # phase 17 (a), (b): shards of the mesh on card 0
N_SHARDS_SMALL = 2   # phase 17 (c)
N_PAIRS_MESH = 256   # phase 17 (c): APA pairs
N_WIN_MESH = 256     # phase 17 (c): host-fed windows a set
KNN_BLOCK = 512      # phase 17: #4's query-row block, a quarter of N_CLIPS
CLIP_S = 5
SR = 48000
BATCH = 64       # e2e batch size
CHECK_B = 4      # kernel-vs-plain batch
# the card's peaks (NVIDIA data sheet, H100 SXM, dense, at 700 W): bytes/s
# and operations/s by type, for each kernel's bound
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}
# bf16 kernel vs bf16 plain on the same inputs: same rounding points, other
# f32 summation order, so they differ by the odd bf16 rounding flip and what
# it propagates.  Bounds: (mean abs error / mean abs signal, max abs error),
# where the signal is what the kernel adds: out - x for the residual Swin
# block, the output itself for the others.  Set at 2-5x the readings of a
# correct kernel (PERF.md): the Swin block's relative error grows with the
# stage's width, so its bound is per stage.  A planted fault (wrong roll,
# dropped mask, swapped merge quadrants) reads 10x or more above them.
TOL = {"swin_block": ((2e-4, 5e-4, 1.5e-3, 3.5e-3), 0.0625),
       "patch_merge": (1e-5, 0.03125),
       "clap_frontend": (4e-3, 0.0625),
       "swin_attn_v3": ((4e-5, 1e-4, 2.5e-4, 5e-4), 0.0625),
       "swin_mlp": ((1e-5, 2.5e-5, 6e-5, 1.2e-4), 0.0625),
       "swin_attn_v1": ((1e-4, 2e-4), 0.0625),
       "swin_attn_v2": ((1e-4, 2e-4, 5e-4, 1e-3), 0.0625),
       "swin_mlp_int8": ((2.5e-6, 5e-6, 7e-6, 7e-6), 0.0625),
       # f32 kernels vs f32 plain versions: the same arithmetic, the
       # products as three TF32 products on the tensor cores (f32-level
       # accuracy; readings 4.2e-7..5.8e-7 relative, max 5.7e-6; merges
       # 2.5e-7..3.5e-7, max 5.0e-6; the SIMT f32 products they replaced
       # read 2.1e-7..8.6e-7 and 3e-8..6.7e-7); under the JAX suite's f32
       # bounds (max abs 2e-4 for the v4 block, tests/
       # test_pallas_model_kernels.py:588; 5e-5 for a kernel against XLA,
       # :122,226)
       "swin_block_f32": ((1e-6, 2e-6, 2.5e-6, 4e-6), 5e-5),
       "patch_merge_f32": (3e-6, 3e-5),
       # the f32 split halves run the f32 block's launches and arithmetic:
       # its bounds, relative to what each half adds; the f32 int8 MLP, the
       # bf16 int8 kernel's (its codes are f32 arithmetic in both dtypes)
       "swin_attn_v3_f32": ((1e-6, 2e-6, 2.5e-6, 4e-6), 5e-5),
       "swin_mlp_f32": ((1e-6, 2e-6, 2.5e-6, 4e-6), 5e-5),
       "swin_attn_v1_f32": ((1e-6, 2e-6), 5e-5),
       "swin_attn_v2_f32": ((1e-6, 2e-6, 2.5e-6, 4e-6), 5e-5),
       "swin_mlp_int8_f32": ((2.5e-6, 5e-6, 7e-6, 7e-6), 0.0625)}
# the int8 MLP's branch (out - x) against the fused bf16 MLP kernel's, each
# held against the f32 branch (the plain MLP in f32 on the same input, f32
# weights) by relative Frobenius error: the int8 branch's error may exceed
# the bf16 kernel's by at most the JAX suite's bound for W8A8 quantisation
# error (tests/test_pallas_model_kernels.py:291-292).  The bf16 kernel's own
# error there is mostly the bf16 rounding of out = x + branch, where the
# branch is a few percent of x.
INT8_EXCESS_TOL = 0.02
# the v3 half then the MLP kernel against the whole-block kernel on the same
# inputs: they differ by the bf16 rounding of the mid-block residual (the
# whole block keeps it f32) and what it propagates; (mean abs error / mean
# |out - x|, max abs error), ~4x the readings at every stage (PERF.md).
SPLIT_VS_WHOLE_TOL = (1e-2, 0.25)
# log-mel kernel vs plain (same bf16 rounding of frames and basis, other
# f32 summation order): (mean abs error / mean |out|, max abs error) per
# convention, about 5x a correct kernel's readings (PERF.md); the bf16
# output's max at one bf16 ulp of values in [32, 64).
LOG_MEL_TOL = {"clap": (1e-5, 0.25), "vggish": (1e-6, 3e-5)}
# PRDC kernels (f32): radii rtol / atol, the JAX suite's kernel-vs-XLA
# bound (tests/test_pallas_distance.py:20); ref_min rtol / atol
# (test_pallas_distance.py:38); booleans and counts equal up to near-ties
# (pairs with |d - r| <= NEAR_TIE * r in a float64 recomputation).
RADII_TOL = (1e-4, 1e-5)
REF_MIN_TOL = (1e-5, 1e-6)
NEAR_TIE = 1e-5
# End to end, kernels vs plain versions (same weights, same clips): each
# bound about 10x the reading of a correct run (PERF.md).  KD's std is a
# spread of ~1e-6 over subsets and moves most.
E2E_TOL = {"1-cos": 1e-5, "max_abs": 3e-3, "fad": 1e-3, "kernel_distance_mean": 1e-3,
           "kernel_distance_std": 3e-2}
# phases 10 and 11, the f32 kernels' embeddings against the f32 plain
# chain's on the same clips: (1 - min cosine, max abs); readings 1.79e-7
# (the f32 rounding of a unit row's squared norm: equal embeddings read the
# same) and 6.3e-8
F32_E2E_TOL = (1e-6, 6e-7)
# Embeddings of one configuration against another on the same clips (same
# weights): the split blocks and the v1 attention against the whole-block
# default, the v1 log-mel against the halo one; (1 - min cosine, max abs),
# ~10x the readings (PERF.md; the two log-mels gave equal embeddings, so
# theirs is the kernel-vs-plain scale).
CONFIG_TOL = {"split": (5e-5, 5e-3), "attn_v1": (5e-5, 5e-3), "mel_v1": (2e-6, 1e-3),
              "no_mel_tile": (5e-5, 5e-3), "merged": (5e-5, 5e-3)}
# phase 15: APA of the reference pairs against themselves, |1 - apa|; APA
# through the kernels against the plain versions on the same reference
# state, abs (~10x the reading: FAD moves by ~2e-5 relative between the
# two paths, APA by that times d / (2 d(x, x'))); the card's L0 mix of
# 64 pairs against the port's on the CPU, max abs (~10x the CPU reading of
# the port against the JAX package on these pairs, 8.9e-8 on mixes up to
# 0.36); the mix's loudness in the float64 oracle against -20 LUFS on the
# items it did not limit, dB
APA_SELF_TOL = 1e-3
APA_E2E_TOL = 2e-4
MIX_CARD_TOL = 1e-6
MIX_LUFS_TOL = 0.01
# phase 16 (a): FAD-inf on the card against the port's FAD-inf on the CPU
# over the same embeddings and reference statistics, relative to max(1,
# |value|): tests/test_fad_inf.py's bounds for the f32 sweep against its
# float64 oracle
FAD_INF_TOL = {"fad_inf": 5e-3, "fad_inf_slope": 2e-2}
# phase 17: KD over a mesh against one device, relative: each subset's Gram
# sums are the one-device products (the shards take whole chunks of
# subsets), so only an exact result passes
KD_MESH_TOL = 1e-12
# phase 12 (b): VGGish f32 against bf16 embeddings of the same clips (not
# unit rows: norms ~45); the CPU reading of the same arithmetic on 32 of
# these clips, 1.23e-5 and 0.064, times ~10
VGGISH_BF16_TOL = (2e-4, 0.6)
# kernels that must repeat bitwise on the same inputs: those on the wgmma
# GEMM cores (gemm_sm90.cuh, bf16 and int8; gemm_tf32x3_sm90.cuh, f32 as
# three TF32 products), which have no atomics but the int8 MLP's, an
# integer max, which no order changes
REPEATS = ("swin_block", "patch_merge", "clap_frontend", "log_mel", "log_mel_v1",
           "swin_attn_v3", "swin_mlp", "swin_attn_v1", "swin_attn_v2", "swin_mlp_int8",
           "swin_block_f32", "patch_merge_f32", "swin_attn_v3_f32", "swin_mlp_f32",
           "swin_attn_v1_f32", "swin_attn_v2_f32", "swin_mlp_int8_f32")
# kernels also held against their plain versions at B = BATCH, the batch at
# which the main path and the f32 configurations run them (phases 6, 7,
# 9-11), under the same bounds
AT_BATCH = ("swin_attn_v3", "swin_mlp", "swin_attn_v1", "swin_attn_v2", "swin_mlp_int8",
            "swin_block_f32", "patch_merge_f32", "swin_attn_v3_f32", "swin_mlp_f32",
            "swin_attn_v1_f32", "swin_attn_v2_f32", "swin_mlp_int8_f32")
# launches timed per reading (10 elsewhere): kernels of ~0.1 ms or less
# moved by 20-40% between runs at 10
TIMING_ITERS = {"patch_merge": 200, "knn_radii": 200, "prdc_stats": 200, "log_mel": 200,
                "log_mel_v1": 200}


# the SASS that shows a kernel's design: instructions that the instantiations
# of each named kernel (a pattern searched in the mangled name) must contain
# (cuobjdump -sass of the built library): the log-mels' DFT (one kernel,
# log_mel_sm90_kernel, serves the halo and the v1 log-mel) and the
# f32 block's and merge's 3xTF32 products on wgmma (HGMMA) fed by TMA
# (UTMALDG), the f32 MLP's fc1 and fc2 (the instantiations of EPI_GELU = 2
# and EPI_RESID = 3) also with setmaxnreg (USETMAXREG); the bf16 v1 and v2
# halves' qkv and proj products (the gemm_sm90_kernel instantiations of
# EPI_BIAS_BF16 = 9 and EPI_PROJ_BF16 = 8, gemm.cuh's enum Epi) likewise; the f32 window attention's 3xTF32
# products (the float instantiation of window_attn_kernel, inside #1 and
# #8-#11 in f32) and both instantiations of the merged attention (the
# merged form of #10 and #11) on mma.sync (HMMA); the PRDC statistics' products fed by
# cp.async (LDGSTS); the int8 MLP's fc1 and fc2 (the instantiations of
# EPI_S8_GELU = 11, and of EPI_S8_OUT = 12 and EPI_S8_OUT_F32 = 13) on int8
# wgmma (IGMMA) fed by TMA
SASS_WANT = {"log_mel": ("log_mel_sm90_kernel", ("HGMMA", "UTMALDG")),
             "log_mel any mel count": ("log_mel_cols_kernel", ("HGMMA", "UTMALDG")),
             "swin_attn_v1 qkv": (r"gemm_sm90_kernelILi\d+ELi9E", ("HGMMA", "UTMALDG")),
             "swin_attn_v1 proj": (r"gemm_sm90_kernelILi\d+ELi8E", ("HGMMA", "UTMALDG")),
             "swin_mlp_int8 fc1": (r"gemm_sm90_kernelILi\d+ELi11E", ("IGMMA", "UTMALDG")),
             "swin_mlp_int8 fc2": (r"gemm_sm90_kernelILi\d+ELi1[23]E", ("IGMMA", "UTMALDG")),
             "swin_block_f32": ("gemm_tf32x3_kernel.*RowsA", ("HGMMA", "UTMALDG")),
             "swin_mlp_f32 fc1, fc2": (r"gemm_tf32x3_kernelILi\d+ELi[23]E",
                                       ("HGMMA", "UTMALDG", "USETMAXREG")),
             "patch_merge_f32": ("gemm_tf32x3_kernel.*MergeA", ("HGMMA", "UTMALDG")),
             "window_attn_f32": (r"window_attn_kernelILi\d+E+vPKf", ("HMMA",)),
             "merged_attn_bf16": ("merged_attn_bf16", ("HMMA",)),
             "merged_attn_f32": ("merged_attn_f32", ("HMMA",)),
             "prdc_stats": ("stats_split_kernel", ("LDGSTS",))}
# kernels the library must hold no instantiation of: gemm.cuh's WMMA
# gemm_kernel, deleted with its last user (#7's DFT is on the wgmma core)
SASS_GONE = {"gemm.cuh's WMMA gemm_kernel": r"11gemm_kernelI"}
# instructions the library must not hold: IMMA, the int8 mma.sync / WMMA of
# the int8 MLP's old GEMM (every int8 product is on wgmma)
SASS_NONE = {"int8 mma.sync / WMMA": r"\bIMMA\b"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: dict, n_bytes: float) -> tuple[float, str, float]:
    """Least time (ms) the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type (the
    times of the types add); then which of the two binds, and the
    operations of all types."""
    t_ops = sum(n / PEAK[t] for t, n in ops.items())
    t_bytes = n_bytes / PEAK["bytes"]
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            float(sum(ops.values())))


def swin_bound(cfg, b, part="block", stages=(0, 1, 2, 3), dt="bf16", merged=False):
    """The Swin blocks of ``stages`` in one forward, in ``dt`` (bf16 or
    f32).  ``part`` "block": the qkv, proj, fc1 and fc2 products (24 T C^2)
    and the window attention (4 T win^2 C); "attn": qkv, proj and attention
    (8 T C^2 + 4 T win^2 C); "mlp": fc1 and fc2 (16 T C^2).  ``merged``:
    the attention over one window of the whole image (win^2 = R^2, the
    merged one-window form) where R > the window.  In f32 the
    products and the window attention's are reckoned as the card's fastest
    f32-accurate route computes them, three TF32 products each (3xTF32);
    the operations returned are then the f32 ones.  Bytes: each block's
    input and output rows and its weights (12, 4 or 8 C^2) in ``dt``."""
    size = 2 if dt == "bf16" else 4
    prod = attn = n_bytes = 0
    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, t = cfg.embed_dim * 2**stage, b * res * res
        if stage in stages:
            prod += depth * {"block": 24, "attn": 8, "mlp": 16}[part] * t * c * c
            if part != "mlp":
                win2 = res * res if merged else min(cfg.window_size, res) ** 2
                attn += depth * 4 * t * win2 * c
            n_bytes += depth * (2 * t * c + {"block": 12, "attn": 4, "mlp": 8}[part] * c * c) * size
        res //= 2
    if dt == "f32":
        ms, by, _ = bound({"tf32": 3 * (prod + attn)}, n_bytes)
        return ms, by, float(prod + attn)
    return bound({dt: prod + attn}, n_bytes)


def int8_mlp_bound(cfg, b, dt="bf16"):
    """The int8 MLP on the rows of every Swin block of one forward: fc1 and
    fc2, 16 T C^2 int8 operations; bytes: each block's rows in and out in
    ``dt`` (bf16 or f32), its f32 weights (8 C^2) and f32 vectors (LN
    affine, biases: 7 C)."""
    size = 2 if dt == "bf16" else 4
    ops = n_bytes = 0
    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, t = cfg.embed_dim * 2**stage, b * res * res
        ops += depth * 16 * t * c * c
        n_bytes += depth * (2 * t * c * size + (8 * c * c + 7 * c) * 4)
        res //= 2
    return bound({"int8": ops}, n_bytes)


def merge_bound(cfg, b, dt="bf16"):
    """The three patch merges of one forward: (T/4, 4C) x (4C, 2C), in
    ``dt`` (bf16, or f32 reckoned as three TF32 products, as ``swin_bound``
    does; the operations returned are the f32 ones)."""
    size = 2 if dt == "bf16" else 4
    ops = n_bytes = 0
    res = cfg.grid_size
    for stage in range(len(cfg.depths) - 1):
        c, t_out = cfg.embed_dim * 2**stage, b * (res // 2) ** 2
        ops += 2 * t_out * 4 * c * 2 * c
        n_bytes += (b * res * res * c + t_out * 2 * c + 8 * c * c) * size
        res //= 2
    if dt == "f32":
        ms, by, _ = bound({"tf32": 3 * ops}, n_bytes)
        return ms, by, float(ops)
    return bound({dt: ops}, n_bytes)


def fb_bins(fb) -> int:
    """The frequency bins a log-mel needs: up to the last bin with any mel
    weight (CLAP's 50-14000 Hz at 48 kHz, n_fft 1024: 299), not the
    kernels' basis padded to whole N tiles."""
    return int(np.nonzero(np.any(fb != 0.0, axis=1))[0][-1]) + 1


def vggish_fb() -> np.ndarray:
    """VGGish's filterbank (257 bins of n_fft 512 at 16 kHz, 64 HTK mels
    over 125-7500 Hz), as phase 3 hands it to the log-mels."""
    from audio_metrics_tpu_torch.ops.mel import mel_filter_bank

    return mel_filter_bank(257, 64, 125.0, 7500.0, 16000, norm=None, mel_scale="htk",
                           triangle_domain="mel", zero_dc=True).astype(np.float32)


def log_mel_bound(b, frames, frame_length, fb, n, out_size):
    """A log-mel of ``b`` clips of ``n`` samples into ``frames`` frames a
    clip: the DFT of ``frame_length`` samples into the ``fb_bins`` bins that
    the filterbank ``fb`` (bins x mels) weighs, in bf16, and the mel product
    over them in f32; bytes: the f32 clips in, the log-mel out
    (``out_size`` bytes a value)."""
    n_keep, n_mels = fb_bins(fb), fb.shape[1]
    return bound({"bf16": 2 * b * frames * frame_length * 2 * n_keep,
                  "f32": 2 * b * frames * n_keep * n_mels},
                 b * n * 4 + b * frames * n_mels * out_size)


def frontend_bound(cfg, b, n):
    """The fused frontend on (b, n) clips: the DFT of the p+2 head and the
    tail frames into the ``fb_bins`` bins CLAP's filterbank weighs, the
    bicubic interp and the patch embed in bf16; the mel product of those
    frames in f32; bytes: the f32 clips in, the bf16 tokens out."""
    from audio_metrics_tpu_torch.models.clap import _clap_fb
    from audio_metrics_tpu_torch.ops.frontend_fused import FRAME, HOP, _plan

    pln = _plan(n, SR, FRAME, HOP, cfg.num_mel_bins, cfg.spec_size, cfg.patch_size)
    frames = pln["head_frames"] + pln["n_frames"] - pln["t_tail0"]
    n_keep, n_mels, ps = fb_bins(_clap_fb()), cfg.num_mel_bins, cfg.patch_size
    rg = pln["ratio"] * pln["gw"]
    bf16 = b * (2 * frames * FRAME * 2 * n_keep + 2 * ps * rg * pln["n_frames"] * n_mels
                + 2 * rg * ps * n_mels * pln["fb"] * cfg.embed_dim)
    f32 = b * 2 * frames * n_keep * n_mels
    tokens = b * (cfg.grid_size ** 2) * cfg.embed_dim
    return bound({"bf16": bf16, "f32": f32}, b * n * 4 + tokens * 2)


def prdc_values(stats, ref_radii, k):
    """PRDC from the four reductions, float64 on the host, as the port's
    ``metrics.prdc`` reduces them."""
    ca, cc, ra, rm = (t.cpu().numpy() for t in stats)
    rr = ref_radii.cpu().numpy()
    return dict(precision=float(np.mean(ca.astype(np.float64))),
                recall=float(np.mean(ra.astype(np.float64))),
                density=float(np.mean(cc.astype(np.float64))) / k,
                coverage=float(np.mean((rm < rr).astype(np.float64))))


def check_radii(what, got, want, result=None):
    """The kernel's k-NN radii against the plain version's: none outside
    RADII_TOL."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    out = int((err > RADII_TOL[1] + RADII_TOL[0] * want.abs()).sum())
    if result is not None:
        result["max_abs_err"] = max(result["max_abs_err"], err.max().item())
    log(f"  knn_radii {what}: radii {want.min().item():.4g}..{want.max().item():.4g}, max abs "
        f"err {err.max().item():.4g}, max rel err {(err / want).max().item():.4g}, bitwise "
        f"equal {int((got == want).sum())} of {len(want)}; outside rtol {RADII_TOL[0]} atol "
        f"{RADII_TOL[1]}: {out} {'ok' if not out else 'FAIL'}")
    if out:
        raise AssertionError(f"knn_radii {what}: the kernel disagrees with its plain version")


def check_repeats(what, runs):
    """Determinism of a kernel on the wgmma core, which has no atomics: a
    race in its TMA ring shows as a difference.  ``runs``: (B, a first
    output, the call that made it); the call again must equal it
    bitwise."""
    for b, first, fn in runs:
        same = torch.equal(first, fn())
        log(f"    repeat at B={b}: {'bitwise equal' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"{what} differs between two runs on the same inputs")


def check_params(cfg):
    """HTSAT-base weights for the kernel checks.  Every matrix at std
    1/sqrt(fan_in), biases and relative-position tables at std 0.5, LN and
    BN affines away from 1/0: each half of a block then moves its output by
    O(1).  (``init_params``' 0.02 std leaves the attention branch at
    ~0.007 beside a residual of ~1, where a wrong roll or a dropped mask
    hides under the output's bf16 rounding.)"""
    from audio_metrics_tpu_torch.models.htsat import init_params

    rng = np.random.default_rng(0)
    params = init_params(cfg, seed=0)
    for k, v in params.items():
        if k.endswith(".bias") or "bias_table" in k:
            params[k] = rng.normal(scale=0.5, size=v.shape).astype(np.float32)
        elif v.ndim == 2:  # (out, in) linear weights
            params[k] = rng.normal(scale=v.shape[1] ** -0.5, size=v.shape).astype(np.float32)
        elif k.endswith(".weight") and "norm" in k:
            params[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    params["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 3.0, 64).astype(np.float32)
    return params


def compare(name, got, want, signal, results):
    """Error of the kernel's output against the plain version's, absolute
    and relative to the mean size of ``signal``."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got.float() - want.float()).abs()
    mx, rel = err.max().item(), err.mean().item() / signal.float().abs().mean().item()
    r = results.setdefault(name, {"max_abs_err": 0.0, "rel_mean_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], mx)
    r["rel_mean_err"] = max(r["rel_mean_err"], rel)
    return mx, rel


def v2_weights(params, prefix, block, dtype=torch.bfloat16):
    """The opt-in ops' operands for ``block``'s weights, on the card: the v2
    attention half's (matrices in ``dtype``), the int8 MLP's (f32 weights),
    and the v2 half's ``half_operands`` (its kernel's K-major matrices,
    made once here as a caller makes them at load)."""
    from audio_metrics_tpu_torch.models.htsat import _Folded, _mlp_weights, _v2_kernel_weights
    from audio_metrics_tpu_torch.ops.attention import half_operands

    w = _Folded(_v2_kernel_weights(params, prefix, block.resolution, block.shift, block.heads,
                                   block.window), dtype).to("cuda")
    m = _Folded(_mlp_weights(params, prefix), torch.float32).to("cuda")
    ops = half_operands(w.wqkv, w.wp)
    return ((w.ln1_w, w.ln1_b, w.wqkv, w.bq3, w.wp, w.bp, w.bm),
            (m.ln2_w, m.ln2_b, m.w1, m.b1, m.w2, m.b2), ops)


def int8_ties(x, mlp, eps, results, name="swin_mlp_int8"):
    """The int8 MLP (``name``: its bf16 or f32 kernel, as ``x``'s dtype)
    where every LN output is a code and a half: with a zero
    LN weight the LN output is the LN bias, here 127 and then +-(k + 1/2),
    so sx = 1 and each quotient lies exactly halfway (random rows rarely
    do).  Half to even (the JAX kernel's jnp.round) and half away from zero
    give other codes for every even k."""
    from audio_metrics_tpu_torch.ops.mlp import mlp_block_int8, mlp_block_int8_plain

    c = x.shape[-1]
    k = torch.arange(1, c, device=x.device)
    ln_b = torch.cat([torch.tensor([127.0], device=x.device),
                      ((k % 20) + 0.5) * (1 - 2 * (k % 2))])
    args = (torch.zeros_like(mlp[0]), ln_b.float(), *mlp[2:])
    got, want = mlp_block_int8(x, *args, eps=eps), mlp_block_int8_plain(x, *args, eps=eps)
    mx, rel = compare(name, got, want, want.float() - x.float(), results)
    rel_tol, max_tol = TOL[name][0][0], TOL[name][1]
    ok = mx <= max_tol and rel <= rel_tol
    log(f"  {name} LN outputs at halves, C={c}: max_abs_err {mx:.4g} (tol {max_tol}) "
        f"mean_abs_err / mean |out - x| {rel:.4g} (tol {rel_tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} rounds halves otherwise than its plain version")


def phase_kernels(cfg, params, results):
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.models.clap import ClapFrontend
    from audio_metrics_tpu_torch.models.htsat import PatchMerge, SwinBlock
    from audio_metrics_tpu_torch.ops.attention import (
        swin_attention_half_v1,
        swin_attention_half_v1_plain,
        swin_attention_half_v2,
        swin_attention_half_v2_plain,
        swin_attention_half_v3,
        swin_attention_half_v3_plain,
    )
    from audio_metrics_tpu_torch.ops.frontend_fused import (
        clap_tokens_fused,
        clap_tokens_fused_plain,
    )
    from audio_metrics_tpu_torch.ops.mlp import (
        mlp_block,
        mlp_block_int8,
        mlp_block_int8_plain,
        mlp_block_plain,
        mlp_int8_operands,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    times = {k: {"ms": {}, "plain_ms": {}} for k in TOL}

    def check(name, shape_key, kfn, pfn, counts, x=None, stage=None, xb=None):
        """``kfn``, ``pfn``: kernel and plain at B = CHECK_B; ``counts``: the
        same at B = BATCH, and the calls in one forward; ``x``, ``xb``: a
        residual block's inputs at the two batches."""
        rel_tol, max_tol = TOL[name]
        if stage is not None:
            rel_tol = rel_tol[stage]
        held = [(CHECK_B, kfn, pfn, x)]
        if name in AT_BATCH:
            held.append((BATCH, counts[0], counts[1], xb))
        first = None
        for b, kf, pf, xin in held:
            before = KERNELS[name].launches
            got, want = kf(), pf()
            if KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} {shape_key}: "
                                     f"{KERNELS[name].launches - before} launches in one call")
            first = got if first is None else first
            mx, rel = compare(name, got, want,
                              want if xin is None else want.float() - xin.float(), results)
            ok = mx <= max_tol and rel <= rel_tol
            at = "" if b == CHECK_B else f" at B={b}"
            log(f"  {name} {shape_key}{at}: max_abs_err {mx:.4g} (tol {max_tol}) "
                f"mean_abs_err / mean |{'out' if xin is None else 'out - x'}| {rel:.4g} "
                f"(tol {rel_tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {shape_key}{at} disagrees with its plain version")
        if name in REPEATS:
            check_repeats(f"{name} {shape_key}", ((CHECK_B, first, kfn),
                                                  (BATCH, counts[0](), counts[0])))
        for b in (CHECK_B, BATCH):
            ms = cuda_ms(kfn if b == CHECK_B else counts[0], TIMING_ITERS.get(name, 10),
                         warmup=10 if name in TIMING_ITERS else 2)
            pms = cuda_ms(pfn if b == CHECK_B else counts[1], iters=3)
            times[name]["ms"].setdefault(b, 0.0)
            times[name]["plain_ms"].setdefault(b, 0.0)
            times[name]["ms"][b] += ms * counts[2]
            times[name]["plain_ms"][b] += pms * counts[2]
            log(f"    B={b}: kernel {ms:.4f} ms, plain {pms:.4f} ms")

    def check_on(name, key, xin, kfn, pfn, n, stage):
        """``check`` of the residual kernel ``kfn(x)`` against ``pfn(x)`` on
        the inputs ``xin`` (by batch), ``n`` calls a forward."""
        check(name, key, lambda: kfn(xin[CHECK_B]), lambda: pfn(xin[CHECK_B]),
              (lambda: kfn(xin[BATCH]), lambda: pfn(xin[BATCH]), n),
              x=xin[CHECK_B], stage=stage, xb=xin[BATCH])

    def same(what, key, got, want):
        """Two kernel paths that run the same launches on the same values:
        bitwise equal."""
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        log(f"  {what} {key}: {'bitwise equal' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError(f"{what} {key} differ")

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    res = cfg.grid_size
    mlp_stages = []
    for stage, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2**stage
        split_checks, split_f32 = [], []
        for shift in ((0, cfg.window_size // 2) if res > cfg.window_size else (0,)):
            prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
            block = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage],
                              torch.bfloat16).to(dev)
            xs = {b: randn((b, res * res, c)) for b in (CHECK_B, BATCH)}
            # blocks of this (stage, shift) in one forward
            n_blocks = depth // 2 if res > cfg.window_size else depth
            key = f"stage {stage} R={res} C={c} shift={shift}"
            check("swin_block", key, lambda: block(xs[CHECK_B]),
                  lambda: block(xs[CHECK_B], plain=True),
                  (lambda: block(xs[BATCH]), lambda: block(xs[BATCH], plain=True), n_blocks),
                  x=xs[CHECK_B], stage=stage)
            # the f32 whole block (#1 in f32) on the same weights and inputs
            b32 = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage],
                            torch.float32).to(dev)
            x32 = {b: xs[b].float() for b in xs}
            check("swin_block_f32", key, lambda: b32(x32[CHECK_B]),
                  lambda: b32(x32[CHECK_B], plain=True),
                  (lambda: b32(x32[BATCH]), lambda: b32(x32[BATCH], plain=True), n_blocks),
                  x=x32[CHECK_B], stage=stage, xb=x32[BATCH])
            # the f32 v3 attention half (#8 f32) on the same weights and
            # inputs, reading the f32 block's split stacks
            geo = dict(heads=block.heads, window=block.window, shift=block.shift, eps=block.eps)
            ops32 = b32.kernel_operands()
            attn32 = (b32.wqkv, b32.bq3, b32.wp, b32.bp, b32.bm)
            mlp32 = (b32.ln2_w, b32.ln2_b, b32.w1, b32.b1, b32.w2, b32.b2)
            x432 = {b: x32[b].view(b, res, res, c) for b in x32}
            check_on("swin_attn_v3_f32", key, x432,
                     lambda x: swin_attention_half_v3(x, *attn32, **geo, operands=ops32),
                     lambda x: swin_attention_half_v3_plain(x, *attn32, **geo), n_blocks, stage)
            split_f32.append((key, b32, x32[CHECK_B], attn32, mlp32, ops32, geo))

            # the v3 attention half on the same block weights (#8), reading
            # the operands the block holds from load; the v3 half + MLP
            # kernel against the whole-block kernel after #9's check
            attn = (block.wqkv, block.bq3, block.wp, block.bp, block.bm)
            mlp = (block.ln2_w, block.ln2_b, block.w1, block.b1, block.w2, block.b2)
            ops = block.kernel_operands()
            x4 = {b: xs[b].view(b, res, res, c) for b in xs}
            check_on("swin_attn_v3", key, x4,
                     lambda x: swin_attention_half_v3(x, *attn, **geo, operands=ops),
                     lambda x: swin_attention_half_v3_plain(x, *attn, **geo), n_blocks, stage)
            split_checks.append((key, block, xs[CHECK_B], x4[CHECK_B], attn, mlp, ops, geo))

            if stage < 2:  # the v1 attention half (#10): stages of >= 16 windows
                v1 = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage],
                               torch.bfloat16, attention="v1").to(dev)
                a1 = (v1.ln1_w, v1.ln1_b, v1.wq, v1.bq, v1.wk, v1.wv, v1.wp, v1.bp, v1.bm)
                ops1 = v1.kernel_operands()
                check_on("swin_attn_v1", key, x4,
                         lambda x: swin_attention_half_v1(x, *a1, **geo, operands=ops1),
                         lambda x: swin_attention_half_v1_plain(x, *a1, **geo), n_blocks, stage)
                # the f32 v1 half (#10 f32) on its f32 operands made at load
                v132 = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage],
                                 torch.float32, attention="v1").to(dev)
                a132 = (v132.ln1_w, v132.ln1_b, v132.wq, v132.bq, v132.wk, v132.wv, v132.wp,
                        v132.bp, v132.bm)
                ops132 = v132.kernel_operands()
                check_on("swin_attn_v1_f32", key, x432,
                         lambda x: swin_attention_half_v1(x, *a132, **geo, operands=ops132),
                         lambda x: swin_attention_half_v1_plain(x, *a132, **geo), n_blocks, stage)

            # the v2 attention half (#11), an opt-in op: every stage; on v1's
            # operands laid side by side it runs the v1 kernel's launches
            a2, _, ops2 = v2_weights(params, prefix, block)
            check_on("swin_attn_v2", key, x4,
                     lambda x: swin_attention_half_v2(x, *a2, **geo, operands=ops2),
                     lambda x: swin_attention_half_v2_plain(x, *a2, **geo), n_blocks, stage)
            if stage < 2:
                same("v2 kernel vs v1 kernel", key,
                     swin_attention_half_v2(x4[CHECK_B], *a2, **geo, operands=ops2),
                     swin_attention_half_v1(x4[CHECK_B], *a1, **geo, operands=ops1))

            # the f32 v2 half (#11 f32), every stage; on v1's operands laid
            # side by side it runs the f32 v1 kernel's launches
            a232, _, ops232 = v2_weights(params, prefix, block, torch.float32)
            check_on("swin_attn_v2_f32", key, x432,
                     lambda x: swin_attention_half_v2(x, *a232, **geo, operands=ops232),
                     lambda x: swin_attention_half_v2_plain(x, *a232, **geo), n_blocks, stage)
            if stage < 2:
                same("f32 v2 kernel vs f32 v1 kernel", key,
                     swin_attention_half_v2(x432[CHECK_B], *a232, **geo, operands=ops232),
                     swin_attention_half_v1(x432[CHECK_B], *a132, **geo, operands=ops132))

        # the fused MLP (#9) at this stage's rows; blocks of one forward at
        # B=BATCH that take it (the XLA MLP below 1024 tokens and 16384 rows)
        n_mlp = depth if block.fused_mlp(BATCH) else 0
        if n_mlp:
            mlp_stages.append(stage)
        check_on("swin_mlp", f"stage {stage} rows B x {res * res} C={c}", xs,
                 lambda x: mlp_block(x, *mlp, eps=block.eps, operands=ops),
                 lambda x: mlp_block_plain(x, *mlp, eps=block.eps), n_mlp, stage)
        check_on("swin_mlp_f32", f"stage {stage} rows B x {res * res} C={c}", x32,
                 lambda x: mlp_block(x, *mlp32, eps=block.eps, operands=ops32),
                 lambda x: mlp_block_plain(x, *mlp32, eps=block.eps), n_mlp, stage)

        # the int8 MLP (#12), an opt-in op: every block's rows at this stage,
        # on the weights' codes held as a caller holds them from load
        m8 = v2_weights(params, prefix, block)[1]
        ops8 = mlp_int8_operands(m8[2], m8[4])
        check_on("swin_mlp_int8", f"stage {stage} rows B x {res * res} C={c}", xs,
                 lambda x: mlp_block_int8(x, *m8, eps=block.eps, operands=ops8),
                 lambda x: mlp_block_int8_plain(x, *m8, eps=block.eps), depth, stage)
        if stage == 0:
            int8_ties(xs[CHECK_B], m8, block.eps, results)
        check_on("swin_mlp_int8_f32", f"stage {stage} rows B x {res * res} C={c}", x32,
                 lambda x: mlp_block_int8(x, *m8, eps=block.eps, operands=ops8),
                 lambda x: mlp_block_int8_plain(x, *m8, eps=block.eps), depth, stage)
        if stage == 0:
            int8_ties(x32[CHECK_B], m8, block.eps, results, "swin_mlp_int8_f32")

        for key, block, x, x4, attn, mlp, ops, geo in split_checks:
            split = mlp_block(swin_attention_half_v3(x4, *attn, **geo, operands=ops).view(x.shape),
                              *mlp, eps=block.eps, operands=ops)
            whole = block(x)
            mx, rel = compare("split_vs_whole", split, whole, whole.float() - x.float(), results)
            ok = mx <= SPLIT_VS_WHOLE_TOL[1] and rel <= SPLIT_VS_WHOLE_TOL[0]
            log(f"  v3 half + MLP kernels vs whole-block kernel {key}: max_abs_err {mx:.4g} "
                f"(tol {SPLIT_VS_WHOLE_TOL[1]}) mean_abs_err / mean |out - x| {rel:.4g} (tol "
                f"{SPLIT_VS_WHOLE_TOL[0]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"split block {key} disagrees with the whole block")
        for key, b32, x, attn32, mlp32, ops32, geo in split_f32:
            half = swin_attention_half_v3(x.view(*x.shape[:1], res, res, c), *attn32, **geo,
                                          operands=ops32)
            same("f32 v3 half + f32 MLP kernels vs f32 whole-block kernel", key,
                 mlp_block(half.view(x.shape), *mlp32, eps=b32.eps, operands=ops32), b32(x))

        if stage < len(cfg.depths) - 1:
            merge = PatchMerge(params, f"audio_encoder.layers.{stage}.downsample", cfg, res,
                               torch.bfloat16).to(dev)
            xs = {b: randn((b, res * res, c)) for b in (CHECK_B, BATCH)}
            check("patch_merge", f"merge {stage} R={res} C={c}",
                  lambda: merge(xs[CHECK_B]), lambda: merge(xs[CHECK_B], plain=True),
                  (lambda: merge(xs[BATCH]), lambda: merge(xs[BATCH], plain=True), 1))
            m32 = PatchMerge(params, f"audio_encoder.layers.{stage}.downsample", cfg, res,
                             torch.float32).to(dev)
            x32 = {b: xs[b].float() for b in xs}
            check("patch_merge_f32", f"merge {stage} R={res} C={c}",
                  lambda: m32(x32[CHECK_B]), lambda: m32(x32[CHECK_B], plain=True),
                  (lambda: m32(x32[BATCH]), lambda: m32(x32[BATCH], plain=True), 1))
            res //= 2
    fr = ClapFrontend(params, cfg).to(dev)
    audio = {b: 0.2 * torch.randn((b, CLIP_S * SR), generator=gen, device=dev)
             for b in (CHECK_B, BATCH)}
    check("clap_frontend", f"B x {CLIP_S * SR} samples",
          lambda: clap_tokens_fused(audio[CHECK_B], fr, sr=SR, cfg=cfg),
          lambda: clap_tokens_fused_plain(audio[CHECK_B], fr, sr=SR, cfg=cfg),
          (lambda: clap_tokens_fused(audio[BATCH], fr, sr=SR, cfg=cfg),
           lambda: clap_tokens_fused_plain(audio[BATCH], fr, sr=SR, cfg=cfg), 1))
    bounds = {"swin_block": swin_bound(cfg, BATCH), "patch_merge": merge_bound(cfg, BATCH),
              "clap_frontend": frontend_bound(cfg, BATCH, CLIP_S * SR),
              "swin_attn_v3": swin_bound(cfg, BATCH, "attn"),
              "swin_mlp": swin_bound(cfg, BATCH, "mlp", stages=mlp_stages),
              "swin_attn_v1": swin_bound(cfg, BATCH, "attn", stages=(0, 1)),
              "swin_attn_v2": swin_bound(cfg, BATCH, "attn"),
              "swin_mlp_int8": int8_mlp_bound(cfg, BATCH),
              "swin_block_f32": swin_bound(cfg, BATCH, dt="f32"),
              "patch_merge_f32": merge_bound(cfg, BATCH, "f32"),
              "swin_attn_v3_f32": swin_bound(cfg, BATCH, "attn", dt="f32"),
              "swin_mlp_f32": swin_bound(cfg, BATCH, "mlp", stages=mlp_stages, dt="f32"),
              "swin_attn_v1_f32": swin_bound(cfg, BATCH, "attn", stages=(0, 1), dt="f32"),
              "swin_attn_v2_f32": swin_bound(cfg, BATCH, "attn", dt="f32"),
              "swin_mlp_int8_f32": int8_mlp_bound(cfg, BATCH, "f32")}
    for name, t in times.items():
        for b in (CHECK_B, BATCH):
            log(f"  {name} per forward at B={b}: kernel {t['ms'][b]:.4f} ms, "
                f"plain {t['plain_ms'][b]:.4f} ms")
        results[name].update(ms=t["ms"][BATCH], plain_ms=t["plain_ms"][BATCH],
                             bound_ms=bounds[name][0], bound_by=bounds[name][1])
        log(f"  {name} bound at B={BATCH}: {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    # the split halves' products alone over the blocks each path runs:
    # qkv and proj (attention), fc1 and fc2 (MLP), in each dtype
    halves = {"swin_attn_v3": ("attn", range(len(cfg.depths))),
              "swin_mlp": ("mlp", mlp_stages), "swin_attn_v1": ("attn", (0, 1)),
              "swin_attn_v2": ("attn", range(len(cfg.depths)))}
    for dtype, suffix, what in ((torch.bfloat16, "", "in bf16"),
                                (torch.float32, "_f32", "in full f32 (TF32 off)")):
        alone, per_block = products_alone_ms(cfg, BATCH, dtype)
        for name, (part, stages) in halves.items():
            alone[f"{name}{suffix} ({part} products)"] = sum(cfg.depths[st] * per_block[st][part]
                                                            for st in stages)
            results[name + suffix]["library_ms"] = alone[f"{name}{suffix} ({part} products)"]
        log(f"  yardstick, the products alone through torch.matmul {what} at B={BATCH}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in alone.items()))
        results["swin_block" + suffix]["library_ms"] = \
            alone[f"Swin blocks ({sum(cfg.depths)} x qkv, proj, fc1, fc2)"]
        results["patch_merge" + suffix]["library_ms"] = \
            alone["patch merges (3 x (M, 4C) @ (4C, 2C))"]
        if dtype == torch.bfloat16:
            results["clap_frontend"]["library_ms"] = alone["frontend DFT"]
    for name in ("swin_block", "patch_merge", "clap_frontend", "swin_block_f32",
                 "patch_merge_f32", *halves, *(h + "_f32" for h in halves)):
        r, ops = results[name], bounds[name][2]
        log(f"  {name} at B={BATCH}: {ops / (r['ms'] * 1e-3) / 1e12:.1f} TFLOP/s achieved "
            f"({ops:.4g} operations in {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms, the "
            f"products alone {r['library_ms']:.4f} ms)")


def phase_mlp_f32_edges(results) -> None:
    """#9 f32 against its plain version at the row counts of
    ``testing.mlp_f32_edge_rows``, at C = 96, 128, 256, 512 and 1024, under the f32
    MLP's bounds of the stage of that width: one launch a call, repeats
    bitwise equal.  The allocator's blocks of the call's sizes are filled
    with NaN before each call, so a tile that no warpgroup writes shows."""
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.ops.mlp import mlp_block, mlp_block_plain, mlp_operands
    from audio_metrics_tpu_torch.testing import mlp_f32_edge_rows, mlp_f32_schedule

    gen = torch.Generator(device="cuda").manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rel_tols, max_tol = TOL["swin_mlp_f32"]

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    for c, stage in ((96, 0), (128, 0), (256, 1), (512, 2), (1024, 3)):
        w1, w2 = randn(c, 4 * c, std=c**-0.5), randn(4 * c, c, std=(4 * c) ** -0.5)
        mlp = (1.0 + randn(c, std=0.1), randn(c, std=0.5), w1, randn(4 * c, std=0.5), w2,
               randn(c, std=0.5))
        ops = mlp_operands(w1, w2)
        for what, m in mlp_f32_edge_rows(c, sms).items():
            x = randn(m, c)

            def kernel():
                poison = [torch.full((m, w), float("nan"), device="cuda") for w in (c, 4 * c, c)]
                del poison
                return mlp_block(x, *mlp, operands=ops)

            before = KERNELS["swin_mlp_f32"].launches
            got = kernel()
            if KERNELS["swin_mlp_f32"].launches != before + 1:
                raise AssertionError(f"swin_mlp_f32 C={c} M={m}: "
                                     f"{KERNELS['swin_mlp_f32'].launches - before} launches")
            want = mlp_block_plain(x, *mlp)
            mx, rel = compare("swin_mlp_f32", got, want, want - x, results)
            ok = mx <= max_tol and rel <= rel_tols[stage]
            sched = "; ".join(
                f"{k} {s['tiles']} tiles of 128 x {s['bn']}, <= {s['per_block']} a block, last "
                f"{s['last_rows']} rows, {s['ksteps']} K steps, "
                f"{'consumers share the epilogue' if s['shared'] else 'epilogue warps alone'}"
                for k, s in mlp_f32_schedule(c, m, sms).items())
            log(f"  swin_mlp_f32 edge C={c} M={m} ({what}; {sched}; {sms} SMs): max_abs_err "
                f"{mx:.4g} (tol {max_tol}) mean_abs_err / mean |out - x| {rel:.4g} "
                f"(tol {rel_tols[stage]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"swin_mlp_f32 C={c} M={m} ({what}) disagrees with its "
                                     "plain version")
            check_repeats(f"swin_mlp_f32 edge C={c} M={m}", ((m, got, kernel),))


def mlp_f32_launches(cfg, name: str) -> None:
    """Step 1's table for the f32 MLP kernel as it is: each of its three
    launches at every stage of ``cfg`` at B = BATCH (torch.profiler, per
    call), each product's TFLOP/s, and the sums over one forward's blocks
    (``profile_mlp_f32``)."""
    from audio_metrics_tpu_torch import kernels
    from audio_metrics_tpu_torch.profile_evaluate import launch_ms
    from audio_metrics_tpu_torch.profile_mlp_f32 import (
        PEAK_F32_ACCURATE,
        mlp_call,
        part_of,
        stage_inputs,
    )

    lib, gen = kernels.build(), torch.Generator(device="cuda").manual_seed(10)
    total: dict = {}
    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, m = cfg.embed_dim * 2**stage, BATCH * res * res
        inputs, flops = stage_inputs(gen, m, c), 8 * m * c * c
        per = {part_of(k): v for k, v in launch_ms(lambda: mlp_call(lib, *inputs), 20).items()}
        log(f"  swin_mlp_f32 {name} stage {stage} C={c} M={m} launches (torch.profiler, per "
            "call): " + ", ".join(
                f"{k} {v:.4f} ms" + ("" if k == "LN2" else
                                     f" ({flops / (v * 1e-3) / 1e12:.1f} TFLOP/s, "
                                     f"{flops / (v * 1e-3) / PEAK_F32_ACCURATE:.3f} of 165)")
                for k, v in per.items()))
        for k, v in per.items():
            total[k] = total.get(k, 0.0) + depth * v
        res //= 2
    log(f"  swin_mlp_f32 {name} launches over {sum(cfg.depths)} blocks (#1 f32's launches "
        "5-7): " + ", ".join(f"{k} {v:.4f} ms" for k, v in total.items()))


def products_alone_ms(cfg, b, dtype=torch.bfloat16):
    """The yardstick of #1, #2 and #3 and of the split halves, which the
    port never calls: their products alone, one ``torch.matmul`` each in
    ``dtype`` (bf16, or f32 with TF32 off, as ``main`` sets it, for the f32
    kernels) on random operands of the main path's shapes at batch ``b``:
    per forward, the qkv, proj, fc1 and fc2 products of the Swin blocks,
    the three patch merges' (M, 4C) x (4C, 2C) products on the quadrant
    concat, and in bf16 the frontend's DFT (every clip's frame rows x the
    basis), interp and patch products.  Returns those times and, by stage,
    one block's attention (qkv, proj) and MLP (fc1, fc2) products."""
    from audio_metrics_tpu_torch.ops.frontend_fused import FRAME, HOP, _plan

    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    blocks = f"Swin blocks ({sum(cfg.depths)} x qkv, proj, fc1, fc2)"
    out = {blocks: 0.0}
    per_block = {}
    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, m = cfg.embed_dim * 2**stage, b * res * res
        x, h = randn(m, c), randn(m, 4 * c)
        wqkv, wp, w1, w2 = randn(c, 3 * c), randn(c, c), randn(c, 4 * c), randn(4 * c, c)
        per_block[stage] = {"attn": cuda_ms(lambda: (x @ wqkv, x @ wp)),
                            "mlp": cuda_ms(lambda: (x @ w1, h @ w2))}
        out[blocks] += depth * sum(per_block[stage].values())
        if stage < len(cfg.depths) - 1:
            key = "patch merges (3 x (M, 4C) @ (4C, 2C))"
            cat, wg = randn(m // 4, 4 * c), randn(4 * c, 2 * c)
            out[key] = out.get(key, 0.0) + cuda_ms(lambda: cat @ wg)
        res //= 2
    if dtype != torch.bfloat16:
        return out, per_block
    n_mels, ps = cfg.num_mel_bins, cfg.patch_size
    pln = _plan(CLIP_S * SR, SR, FRAME, HOP, n_mels, cfg.spec_size, ps)
    rg, mel_pad = pln["ratio"] * pln["gw"], pln["mel_pad"]
    frames, basis = randn(b * pln["frame_rows"], FRAME), randn(FRAME, 768)
    wi, mel = randn(ps * rg, mel_pad), randn(b, mel_pad, n_mels)
    xi, qcat = randn(b * rg, ps * n_mels), randn(ps * n_mels, pln["fb"] * cfg.embed_dim)
    out["frontend DFT"] = cuda_ms(lambda: frames @ basis)
    out["frontend interp"] = cuda_ms(lambda: wi @ mel)
    out["frontend patch"] = cuda_ms(lambda: xi @ qcat)
    return out, per_block


def phase_prdc_kernels(results):
    """k-NN radii and PRDC statistics, kernel vs plain (f32, TF32 off)."""
    from audio_metrics_tpu_torch.ops.distance import (
        knn_radii,
        knn_radii_plain,
        pairwise_stats,
        pairwise_stats_plain,
    )
    from audio_metrics_tpu_torch.testing import near_duplicate_rows, stats_mismatches

    gen = torch.Generator(device="cuda").manual_seed(4)
    k, d = 10, 512

    def sets(n, m):  # candidate 0.05 + 1.02 N(0, I): every metric inside (0, 1)
        ref = torch.randn((n, d), generator=gen, device="cuda")
        return ref, 0.05 + 1.02 * torch.randn((m, d), generator=gen, device="cuda")

    knn = results.setdefault("knn_radii", {"max_abs_err": 0.0})
    st = results.setdefault("prdc_stats", {"max_abs_err": 0.0})
    for n, m in ((2048, 2048), (10000, 12345)):
        ref, cand = sets(n, m)
        rr_p, cr_p = knn_radii_plain(ref, k), knn_radii_plain(cand, k)
        for x, want in ((ref, rr_p), (cand, cr_p)):
            check_radii(f"({len(want)}, {d}) k={k + 1}", knn_radii(x, k), want, knn)
        got = pairwise_stats(ref, cand, rr_p, cr_p)
        torch.cuda.synchronize()
        want = pairwise_stats_plain(ref, cand, rr_p, cr_p)
        n_diff, n_bad = stats_mismatches(ref, cand, got, want, (rr_p, cr_p), rel=NEAR_TIE)
        mn_err = (got[3] - want[3]).abs()
        mn_out = int((mn_err > REF_MIN_TOL[1] + REF_MIN_TOL[0] * want[3].abs()).sum())
        st["max_abs_err"] = max(st["max_abs_err"], mn_err.max().item())
        log(f"  prdc_stats ({n}, {m}) x {d}: {n_diff} differing elements, "
            f"{n_diff - n_bad} near-ties (|d - r| <= {NEAR_TIE} r in float64), {n_bad} not; "
            f"ref_min max abs err {mn_err.max().item():.4g}, outside rtol {REF_MIN_TOL[0]} "
            f"atol {REF_MIN_TOL[1]}: {mn_out} {'ok' if not (n_bad or mn_out) else 'FAIL'}")
        log(f"    kernel PRDC {prdc_values(got, rr_p, k)}")
        if n_bad or mn_out:
            raise AssertionError("prdc_stats kernel disagrees with its plain version")
    # unit rows whose radii are small against their norms, where the formula
    # cancels and a dot product rounded otherwise than the plain version's
    # moves radii out of the bound: groups of 8 near-duplicates (k = 4
    # radii ~0.3, closer ones ~0.1) and one tight cluster, like the main
    # path's embeddings
    for what, kn, x in (("in groups of 8 near-duplicates", 3, near_duplicate_rows(2048, d, 5)),
                        ("in groups of 8 near-duplicates", 10, near_duplicate_rows(2048, d, 5)),
                        ("in groups of 8 closer near-duplicates", 3,
                         near_duplicate_rows(2048, d, 7, noise=3e-3)),
                        ("in one cluster", 10, near_duplicate_rows(2048, d, 6, group=2048,
                                                                  noise=3e-3))):
        check_radii(f"(2048, {d}) unit rows {what}, k={kn + 1}", knn_radii(x, kn),
                    knn_radii_plain(x, kn), knn)
    x = ref[:2048]
    r = knn_radii(x, k)
    same = prdc_values(pairwise_stats(x, x, r, r), r, k)
    log(f"  the same 2048 rows against themselves: {same}")
    if not same["precision"] == same["recall"] == same["coverage"] == 1.0:
        raise AssertionError("PRDC of a set against itself is not 1")

    for n in (2048, 20480):
        ref, cand = sets(n, n)
        rr, cr = knn_radii_plain(ref, k), knn_radii_plain(cand, k)
        kit, sit = ((TIMING_ITERS["knn_radii"], TIMING_ITERS["prdc_stats"]) if n == 2048
                    else (10, 3))
        t = {"knn_radii": (cuda_ms(lambda: knn_radii(ref, k), kit, warmup=10),
                           cuda_ms(lambda: knn_radii_plain(ref, k), kit, warmup=10)),
             "prdc_stats": (cuda_ms(lambda: pairwise_stats(ref, cand, rr, cr), sit, warmup=10),
                            cuda_ms(lambda: pairwise_stats_plain(ref, cand, rr, cr), sit,
                                    warmup=10))}
        b = {"knn_radii": bound({"f32": 2 * n * n * d}, n * d * 4 + n * 4 * 2),
             "prdc_stats": bound({"f32": 2 * n * n * d}, 2 * n * d * 4 + 2 * n * 4 + 2 * n * 5)}
        for name, (ms, pms) in t.items():
            log(f"  {name} at ({n}, {n}) x {d}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"bound {b[name][0]:.4f} ms ({b[name][1]}, f32 CUDA cores)")
            if n == 2048:  # bench.py's size, the main path's
                results[name].update(ms=ms, plain_ms=pms, bound_ms=b[name][0],
                                     bound_by=b[name][1])


def phase_log_mel(cfg, params, results):
    """The halo and the v1 log-mel kernels vs their plain versions: CLAP 10 s
    (centered, dB, BatchNorm affine, bf16 out) and VGGish (400-sample
    frames, n_fft 512, uncentered, natural log, f32 out).  Both compute one
    function on the same inputs, so they share the bound; where both run,
    the v1 kernel's output against the halo kernel's (bitwise equal
    expected: one DFT + mel kernel, the same tables and bf16 frame values,
    each row's sums its own)."""
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.models.clap import ClapFrontend, _clap_fb
    from audio_metrics_tpu_torch.ops.mel import (
        log_mel_halo,
        log_mel_halo_plain,
        log_mel_v1,
        log_mel_v1_plain,
    )
    from audio_metrics_tpu_torch.profile_evaluate import launch_ms

    fr = ClapFrontend(params, cfg).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    vgg_fb = vggish_fb()
    clap = dict(frame_length=1024, hop_length=480, n_fft=1024, fb=_clap_fb(), center=True,
                log_mode="db", out_affine=(fr.bn_scale, fr.bn_offset), out_dtype=torch.bfloat16)
    # (tolerance key, samples, arguments): the model path's CLAP 10 s window,
    # a CLAP 7 s clip (another frame count, a last row tile of 61 rows; v1:
    # tiles that span clips), VGGish (K 400 padded to 448), and CLAP's frame
    # at hop 484, here for the v1 kernel (its rows' pitch is k_pad; the halo
    # kernel pads its hop rows to 488 samples there: phase 20)
    convs = {
        "clap": ("clap", 10 * SR, clap),
        "clap 7 s": ("clap", 7 * SR, clap),
        "vggish": ("vggish", 10 * 16000, dict(frame_length=400, hop_length=160, n_fft=512,
                                              fb=vgg_fb, center=False, log_mode="natural")),
        "clap hop 484": ("clap", 10 * SR, dict(clap, hop_length=484)),
    }
    kernels = {"log_mel": (log_mel_halo, log_mel_halo_plain),
               "log_mel_v1": (log_mel_v1, log_mel_v1_plain)}
    for conv, (tol_key, n, kw) in convs.items():
        audio = {b: 0.2 * torch.randn((b, n), generator=gen, device="cuda")
                 for b in (CHECK_B, BATCH)}
        for name, (kfn, pfn) in kernels.items():
            if name == "log_mel" and kw["hop_length"] % 8:
                continue
            before = KERNELS[name].launches
            got = kfn(audio[CHECK_B], **kw)
            if KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} {conv}: {KERNELS[name].launches - before} "
                                     "launches in one call")
            want = pfn(audio[CHECK_B], **kw)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {conv}: {got.shape} {got.dtype} vs {want.shape} "
                                     f"{want.dtype}")
            mx, rel = compare(name, got, want, want, results)
            rel_tol, max_tol = LOG_MEL_TOL[tol_key]
            ok = mx <= max_tol and rel <= rel_tol
            log(f"  {name} {conv} {tuple(got.shape)} {got.dtype}: max_abs_err {mx:.4g} (tol "
                f"{max_tol}) mean_abs_err / mean |out| {rel:.4g} (tol {rel_tol}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {conv} disagrees with its plain version")
            if name in REPEATS:
                again = {b: (lambda b=b: kfn(audio[b], **kw)) for b in (CHECK_B, BATCH)}
                check_repeats(f"{name} {conv}", ((CHECK_B, got, again[CHECK_B]),
                                                 (BATCH, again[BATCH](), again[BATCH])))
            ms = cuda_ms(lambda: kfn(audio[BATCH], **kw), TIMING_ITERS.get(name, 10),
                         warmup=10 if name in TIMING_ITERS else 2)
            pms = cuda_ms(lambda: pfn(audio[BATCH], **kw), iters=3)
            frames = got.shape[1]
            dft = 2 * BATCH * frames * kw["frame_length"] * 2 * fb_bins(kw["fb"])
            b = log_mel_bound(BATCH, frames, kw["frame_length"], kw["fb"], n,
                              got.element_size())
            log(f"    B={BATCH}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.4f} ms "
                f"({b[1]}); the DFT's {dft:.4g} operations at {dft / (ms * 1e-3) / 1e12:.1f} "
                f"TFLOP/s over the kernel's time")
            per = launch_ms(lambda: kfn(audio[BATCH], **kw), 20)
            log(f"    B={BATCH} launches (torch.profiler, per call): " + (", ".join(
                f"{k} {v:.4f} ms" for k, v in per.items()) or "not measured"))
            if conv == "clap":
                results[name].update(ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])
        if kw["hop_length"] % 8 == 0:  # #7 against #6 on the same clips
            for b in (CHECK_B, BATCH):
                v1, halo = log_mel_v1(audio[b], **kw), log_mel_halo(audio[b], **kw)
                d = (v1.float() - halo.float()).abs()
                log(f"  log_mel_v1 vs log_mel {conv} at B={b}: " + (
                    "bitwise equal" if torch.equal(v1, halo) else
                    f"DIFFER in {int((d > 0).sum())} of {d.numel()} values, max abs "
                    f"{d.max().item():.4g} (not a gate: each is held to its plain version)"))


def sass_check(lib_path: str) -> None:
    """``cuobjdump -sass`` of the built kernel library: each kernel of
    ``SASS_WANT`` has instantiations, and they contain its instructions;
    none of ``SASS_GONE``'s kernels and none of ``SASS_NONE``'s
    instructions is left."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    for name, (symbol, ops) in SASS_WANT.items():
        bodies = [f for f in functions if re.search(symbol, f.split("\n", 1)[0])]
        counts = {op: sum(b.count(op) for b in bodies) for op in ops}
        ok = bool(bodies) and all(counts.values())
        log(f"  SASS of {name} ({symbol}, {len(bodies)} instantiations): "
            + ", ".join(f"{op} x{n}" for op, n in counts.items()) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: {symbol} lacks {ops} in its SASS")
    for name, symbol in SASS_GONE.items():
        n = sum(bool(re.search(symbol, f.split("\n", 1)[0])) for f in functions)
        log(f"  {name} ({symbol}): {n} instantiation(s) {'ok' if n == 0 else 'FAIL'}")
        if n:
            raise AssertionError(f"{name}: {n} instantiations left, want none")
    for name, pattern in SASS_NONE.items():
        n = len(re.findall(pattern, sass))
        log(f"  {name} ({pattern}) in the library: x{n} {'ok' if n == 0 else 'FAIL'}")
        if n:
            raise AssertionError(f"{name}: {n} instructions left in the library")


def phase_fad_tail():
    """nsdev device tail vs the host f64 path on full-rank moments
    (d=512, n=1024): rel 1e-5, the bound of tests/test_fad_device_tail.py."""
    from audio_metrics_tpu_torch.data import AudioMetricsData, batch_moments
    from audio_metrics_tpu_torch.metrics.fad import fad_device_tail, frechet_distance

    gen = torch.Generator(device="cuda").manual_seed(2)
    mix = torch.randn((512, 512), generator=gen, device="cuda") / 24
    ref_e = torch.randn((1024, 512), generator=gen, device="cuda") @ mix
    cand_e = torch.randn((1024, 512), generator=gen, device="cuda") @ mix + 0.05
    ref = AudioMetricsData()
    ref.add_moments_device(1024, *batch_moments(ref_e)[1:])
    cand = AudioMetricsData()
    cand.add_moments_device(1024, *batch_moments(cand_e)[1:])
    dev = fad_device_tail(cand, ref)
    if dev is None:
        raise AssertionError("FAD device tail did not apply to full-rank moments")
    host = frechet_distance(cand, ref)
    rel = abs(dev - host) / abs(host)
    log(f"  fad nsdev device tail {dev:.8g} vs host f64 {host:.8g}: rel {rel:.3g} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("FAD device tail disagrees with the host path")


def set_counts_to_zero():
    from audio_metrics_tpu_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0


def read_counts() -> dict:
    from audio_metrics_tpu_torch.kernels import KERNELS

    torch.cuda.synchronize()
    return {k.name: k.launches for k in KERNELS.values()}


def check_counts(what: str, launches: dict, want: dict) -> None:
    log(f"  launches {what}: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"a kernel of the path was not launched as expected ({what})")


def compare_embeddings(e_k, e_p):
    cos = (e_k * e_p).sum(dim=1).min().item()
    emax = (e_k - e_p).abs().max().item()
    log(f"  embeddings kernel vs plain: 1 - min cosine {1 - cos:.3g} (tol {E2E_TOL['1-cos']}), "
        f"max abs {emax:.4g} (tol {E2E_TOL['max_abs']})")
    if not (1 - cos <= E2E_TOL["1-cos"] and emax <= E2E_TOL["max_abs"]):
        raise AssertionError("kernel-path embeddings disagree with the plain path")


def clips(n_clips, seconds, seed):
    """Seeded clips made on the card (``testing.seeded_clips``)."""
    from audio_metrics_tpu_torch.testing import seeded_clips

    reference, candidate = seeded_clips(n_clips, seconds * SR, SR, seed)
    log(f"  {n_clips} + {n_clips} clips of {seconds} s on the card "
        f"({2 * reference.numel() * 4 / 2**30:.3f} GiB f32), batch {BATCH}")
    return reference, candidate


SWITCHES = ("AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1", "AM_TPU_MEL_V1", "AM_TPU_MERGED_ATTN")


@contextmanager
def environ(**values):
    """Set the port's configuration variables for one phase (the model's
    construction and its evaluates), then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plain_path(clap, mel_plain=None):
    """An embedder with ``clap``'s weights through the kernels' plain
    versions: the fused frontend's (5 s), or ``mel_plain`` on the
    repeat-padded clip then the plain frontend products (10 s); then the
    encoder's (each block on its own path)."""
    from audio_metrics_tpu_torch.models.clap import _clap_fb, repeat_pad
    from audio_metrics_tpu_torch.models.htsat import frontend_tokens
    from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused_plain

    model, fr = clap.model, clap.model.frontend

    class PlainPath:
        sr, device = clap.sr, clap.device

        @staticmethod
        @torch.no_grad()
        def embed(audio):
            if mel_plain is None:
                tokens = clap_tokens_fused_plain(audio, fr, sr=SR, cfg=model.cfg)
            else:
                mel = mel_plain(
                    repeat_pad(audio), frame_length=1024, hop_length=480, n_fft=1024,
                    fb=_clap_fb(), center=True, log_mode="db",
                    out_affine=(fr.bn_scale, fr.bn_offset), out_dtype=torch.bfloat16)
                tokens = frontend_tokens(mel, fr.patch_w, fr.patch_b, fr.ln_w, fr.ln_b,
                                         model.cfg, torch.bfloat16)
            return model._projection_taps(model.encoder(tokens, plain=True))[clap.layer]

    return PlainPath()


def check_prdc_paths(am, candidate, what: str) -> None:
    """PRDC through the kernels vs through the plain versions, on the same
    stored embeddings (the candidate's embedded once more): radii under
    RADII_TOL, the reductions equal up to near-ties."""
    from audio_metrics_tpu_torch.ops.distance import (
        knn_radii,
        knn_radii_plain,
        pairwise_stats,
        pairwise_stats_plain,
    )
    from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory
    from audio_metrics_tpu_torch.testing import stats_mismatches

    ref_e = am.stem_reference.embeddings
    cand_e = am._run_pipeline(candidate, None)[ItemCategory.stem].embeddings
    k = max(1, min(10, len(ref_e), len(cand_e)))
    rr_k, cr_k = am.stem_reference.radii[f"radii_{k}"], knn_radii(cand_e, k)
    rr_p, cr_p = knn_radii_plain(ref_e, k), knn_radii_plain(cand_e, k)
    for name, got, want in (("reference", rr_k, rr_p), ("candidate", cr_k, cr_p)):
        check_radii(f"of the {what}'s {name} embeddings", got, want)
    st_k = pairwise_stats(ref_e, cand_e, rr_k, cr_k)
    st_p = pairwise_stats_plain(ref_e, cand_e, rr_p, cr_p)
    n_diff, n_bad = stats_mismatches(ref_e, cand_e, st_k, st_p, (rr_k, cr_k), (rr_p, cr_p),
                                     rel=NEAR_TIE)
    v_k, v_p = prdc_values(st_k, rr_k, k), prdc_values(st_p, rr_p, k)
    log(f"  PRDC on the stored embeddings: kernels {v_k}, plain {v_p}; {n_diff} differing "
        f"elements, {n_diff - n_bad} near-ties, {n_bad} not {'ok' if not n_bad else 'FAIL'}")
    if n_bad:
        raise AssertionError(f"{what} PRDC through the kernels disagrees with the plain one")


def phase_e2e(card: str, clap=None, per_forward=None, warm_runs: int = 1):
    """The main path end to end (phase 4): ``clap`` (default LaionCLAP
    HTSAT-base bf16, seeded random weights) in ``AudioMetrics(["fad",
    "kd", "prdc"])`` over N_CLIPS + N_CLIPS 5 s clips (seed 3): launch
    counts (``per_forward`` a forward, HTSAT-base's by default), clips/s,
    PRDC through the kernels against the plain versions, self-FAD, the
    plain path; with ``warm_runs`` > 1 that many more warm evaluates, their
    median and spread."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE

    metrics = ["fad", "kd", "prdc"]
    if clap is None:
        clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                         device="cuda")
    per_forward = per_forward or dict(swin_block=18, patch_merge=3, clap_frontend=1)
    am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S),
                      input_sr=SR, batch_size=BATCH, device="cuda")
    reference, candidate = clips(N_CLIPS, CLIP_S, seed=3)

    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = read_counts()
    forwards = 2 * -(-N_CLIPS // BATCH)
    log(f"  result {result}")
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", launches,
                 expected(forwards, **per_forward))
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")

    set_counts_to_zero()
    t0 = time.perf_counter()
    again = am.evaluate(candidate)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check_counts("second evaluate (reference radii cached)", read_counts(),
                 expected(forwards // 2, knn_radii=1, **per_forward))
    log(f"  evaluate of {N_CLIPS} clips: {N_CLIPS / warm:.2f} clips/s warm ({warm:.4f} s), "
        f"{N_CLIPS / cold:.2f} clips/s first ({cold:.4f} s) [{card}; real_weights: false]")
    if warm_runs > 1:
        log(f"  {warm_evaluates(am, candidate, N_CLIPS, warm_runs)} [{card}]")
    if again != result:
        log(f"  note: repeat evaluate {again}")

    check_prdc_paths(am, candidate, "main path")

    self_fad = am.evaluate(reference)["fad"]
    log(f"  FAD of the reference against itself: {self_fad:.3g} (tol |fad| <= 1e-4)")
    if not abs(self_fad) <= 1e-4:
        raise AssertionError("FAD(reference, reference) is not ~0")

    amp = AudioMetrics(metrics=metrics, embedder=plain_path(clap), win_dur=float(CLIP_S),
                       input_sr=SR, batch_size=BATCH, device="cuda")
    amp.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = amp.evaluate(candidate)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    log(f"  plain path: {plain} ({N_CLIPS / plain_s:.2f} clips/s)")
    compare_embeddings(am.stem_reference.embeddings, amp.stem_reference.embeddings)
    for key, v in result.items():
        rel = abs(v - plain[key]) / max(abs(plain[key]), 1e-12)
        if key not in E2E_TOL:  # PRDC over embeddings that differ by ~1e-4: printed only
            log(f"  {key}: kernel path {v:.6g} plain path {plain[key]:.6g} rel {rel:.3g}")
            continue
        log(f"  {key}: kernel {v:.6g} plain {plain[key]:.6g} rel {rel:.3g} "
            f"(tol {E2E_TOL[key]})")
        if not rel <= E2E_TOL[key]:
            raise AssertionError(f"{key} through the kernels disagrees with the plain path")
    return launches, {"embeddings": am.stem_reference.embeddings, "clips_s": N_CLIPS / warm,
                      "result": result}


def expected(forwards: int, knn_radii: int = 2, **per_forward) -> dict:
    """Every kernel's launches over ``forwards`` forward batches and one
    PRDC evaluate (``knn_radii`` 2 when the reference radii are computed
    too); a kernel not named is launched no time."""
    from audio_metrics_tpu_torch.kernels import KERNELS

    want = {name: per_forward.get(name, 0) * forwards for name in KERNELS}
    want.update(knn_radii=knn_radii, prdc_stats=1)
    return want


def phase_config(card: str, switches: dict, n_clips: int, seconds: int, seed: int,
                 per_forward: dict, tol_key: str | None = None, against=None):
    """One configuration end to end under ``switches``: ``AudioMetrics
    (metrics=["fad", "kd", "prdc"])`` with LaionCLAP HTSAT-base bf16 over
    ``n_clips`` + ``n_clips`` clips of ``seconds``: the launch counts
    (``per_forward`` per forward batch), finite metrics, clips/s first and
    warm, FAD of the reference against itself, the reference embeddings
    against the same weights through the plain versions, and, under
    ``tol_key``, against ``against`` (the embeddings of another
    configuration on the same clips; None: the default configuration's).
    Returns (launches, reference embeddings)."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.mel import log_mel_halo_plain, log_mel_v1_plain

    metrics = ["fad", "kd", "prdc"]
    reference, candidate = clips(n_clips, seconds, seed)

    def metrics_for(embedder):
        return AudioMetrics(metrics=metrics, embedder=embedder, win_dur=float(seconds),
                            input_sr=SR, batch_size=BATCH, device="cuda")

    def model():
        return LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                         device="cuda")

    with environ(**switches):
        clap = model()
        am = metrics_for(clap)
        set_counts_to_zero()
        am.add_reference(reference)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = am.evaluate(candidate)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = read_counts()
        forwards = 2 * -(-n_clips // BATCH)
        log(f"  result {result}")
        check_counts(f"add_reference + first evaluate, {forwards} forward batches", launches,
                     expected(forwards, **per_forward))
        if not all(np.isfinite(v) for v in result.values()):
            raise AssertionError("non-finite metric")
        t0 = time.perf_counter()
        am.evaluate(candidate)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        log(f"  evaluate of {n_clips} {seconds} s clips: {n_clips / warm:.2f} clips/s warm "
            f"({warm:.4f} s), {n_clips / cold:.2f} clips/s first ({cold:.4f} s) "
            f"[{card}; real_weights: false]")
        self_fad = am.evaluate(reference)["fad"]
        log(f"  FAD of the reference against itself: {self_fad:.3g} (tol |fad| <= 1e-4)")
        if not abs(self_fad) <= 1e-4:
            raise AssertionError("FAD(reference, reference) is not ~0")
        mel_plain = None
        if seconds != CLIP_S:
            mel_plain = log_mel_v1_plain if os.environ.get("AM_TPU_MEL_V1") else log_mel_halo_plain
        amp = metrics_for(plain_path(clap, mel_plain))
        amp.add_reference(reference)
        plain = amp.evaluate(candidate)
        log(f"  plain path: {plain}")
        compare_embeddings(am.stem_reference.embeddings, amp.stem_reference.embeddings)
    emb = am.stem_reference.embeddings
    if tol_key is not None:
        if against is None:
            base = metrics_for(model())
            base.add_reference(reference)
            against = base.stem_reference.embeddings
        cos = (emb * against).sum(dim=1).min().item()
        emax = (emb - against).abs().max().item()
        tol = CONFIG_TOL[tol_key]
        ok = 1 - cos <= tol[0] and emax <= tol[1]
        log(f"  embeddings against the {'default' if tol_key != 'mel_v1' else 'halo'} "
            f"configuration on the same clips: 1 - min cosine {1 - cos:.3g} (tol {tol[0]}), "
            f"max abs {emax:.4g} (tol {tol[1]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tol_key} embeddings disagree with the other configuration")
    return launches, emb


def phase_opt_in(card: str, results: dict) -> dict:
    """The two opt-in ops on the activations of one default HTSAT-base bf16
    forward of BATCH 5 s clips with phase 4's weights (``LaionCLAP``'s
    random weights from seed 0, given as the numpy dict the ops' weights are
    laid out from).  A forward pre-hook captures each Swin block's input;
    then, counts at 0, the v2 attention half with the block's weights and
    the int8 MLP on its output with the block's f32 MLP weights (their
    codes held as a caller holds them from load, ``mlp_int8_operands``),
    for all 18 blocks; then each against its plain version, the int8 MLP's
    branch against the fused bf16 MLP kernel's, and per-forward times: the
    int8 MLP also as a call without held codes, which quantises the weights
    itself, and that quantisation alone."""
    from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, init_params
    from audio_metrics_tpu_torch.ops.attention import (
        swin_attention_half_v2,
        swin_attention_half_v2_plain,
    )
    from audio_metrics_tpu_torch.ops.mlp import (
        mlp_block,
        mlp_block_int8,
        mlp_block_int8_plain,
        mlp_block_plain,
        mlp_int8_operands,
    )

    cfg = HTSAT_BASE
    params = init_params(cfg, seed=0)
    params.update(init_projection_params(cfg, seed=0))
    clap = LaionCLAP(params=params, cfg=cfg, compute_dtype="bfloat16", device="cuda")
    audio, _ = clips(BATCH, CLIP_S, seed=3)
    blocks = [(i, j, blk) for i, stage in enumerate(clap.model.encoder.blocks)
              for j, blk in enumerate(stage)]
    inputs = []
    hooks = [blk.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
             for _, _, blk in blocks]
    clap.embed(audio)
    for h in hooks:
        h.remove()
    ops = []
    for (i, j, blk), x in zip(blocks, inputs):
        attn, mlp, a_ops = v2_weights(params, f"audio_encoder.layers.{i}.blocks.{j}", blk)
        geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
        r, c = blk.resolution, x.shape[-1]
        ops.append((i, j, blk, x.view(BATCH, r, r, c), attn, mlp, a_ops, geo,
                    mlp_int8_operands(mlp[2], mlp[4])))

    set_counts_to_zero()
    outs = []
    with torch.no_grad():
        for i, j, blk, x4, attn, mlp, a_ops, geo, m_ops in ops:
            a = swin_attention_half_v2(x4, *attn, **geo, operands=a_ops)
            outs.append((a, mlp_block_int8(a.view(BATCH, -1, a.shape[-1]), *mlp, eps=blk.eps,
                                           operands=m_ops)))
    launches = read_counts()
    check_counts(f"{len(ops)} blocks, the v2 attention half then the int8 MLP", launches,
                 {name: len(ops) if name in ("swin_attn_v2", "swin_mlp_int8") else 0
                  for name in launches})

    ms = {"swin_attn_v2": 0.0, "swin_mlp_int8": 0.0, "swin_mlp_int8 quantising per call": 0.0,
          "mlp_int8_operands alone": 0.0, "swin_mlp (bf16)": 0.0}
    for (i, j, blk, x4, attn, mlp, a_ops, geo, m_ops), (a, m) in zip(ops, outs):
        a3 = a.view(BATCH, -1, a.shape[-1])
        bf16_mlp = (blk.ln2_w, blk.ln2_b, blk.w1, blk.b1, blk.w2, blk.b2)
        want_a = swin_attention_half_v2_plain(x4, *attn, **geo)
        want_m = mlp_block_int8_plain(a3, *mlp, eps=blk.eps)
        m9 = mlp_block(a3, *bf16_mlp, eps=blk.eps, operands=blk.kernel_operands())
        exact = mlp_block_plain(a3.float(), *mlp, eps=blk.eps) - a3.float()
        line = f"  block {i}.{j} R={blk.resolution} C={a.shape[-1]}:"
        ok = True
        for name, got, want, x in (("swin_attn_v2", a, want_a, x4), ("swin_mlp_int8", m, want_m, a3)):
            mx, rel = compare(name, got, want, want.float() - x.float(), results)
            rel_tol, max_tol = TOL[name][0][i], TOL[name][1]
            ok &= mx <= max_tol and rel <= rel_tol
            line += f" {name} max_abs_err {mx:.4g} rel {rel:.4g} (tol {max_tol}, {rel_tol});"
        fro = {k: (torch.linalg.norm(v.float() - a3.float() - exact) /
                   torch.linalg.norm(exact)).item() for k, v in (("int8", m), ("bf16", m9))}
        direct = (torch.linalg.norm(m.float() - m9.float()) /
                  torch.linalg.norm(m9.float() - a3.float())).item()
        ok &= fro["int8"] <= fro["bf16"] + INT8_EXCESS_TOL
        log(f"{line} branch vs the f32 branch: int8 {fro['int8']:.4g}, bf16 kernel "
            f"{fro['bf16']:.4g} (int8 - bf16 tol {INT8_EXCESS_TOL}); int8 vs bf16 kernel "
            f"{direct:.4g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"an opt-in op disagrees at block {i}.{j}")
        ms["swin_attn_v2"] += cuda_ms(lambda: swin_attention_half_v2(x4, *attn, **geo,
                                                                     operands=a_ops))
        ms["swin_mlp_int8"] += cuda_ms(lambda: mlp_block_int8(a3, *mlp, eps=blk.eps,
                                                              operands=m_ops))
        ms["swin_mlp_int8 quantising per call"] += cuda_ms(
            lambda: mlp_block_int8(a3, *mlp, eps=blk.eps))
        ms["mlp_int8_operands alone"] += cuda_ms(lambda: mlp_int8_operands(mlp[2], mlp[4]))
        ms["swin_mlp (bf16)"] += cuda_ms(
            lambda: mlp_block(a3, *bf16_mlp, eps=blk.eps, operands=blk.kernel_operands()))
    # yardstick, used nowhere in the port: the int8 MLP's two products
    # alone through torch._int_mm (cuBLASLt), on random codes of each
    # block's shapes, the weights (K, N) row-major and, as the kernel reads
    # them, K-major (the (N, K) codes' transpose); the faster is the
    # yardstick
    gen = torch.Generator(device="cuda").manual_seed(9)
    yard = {"torch._int_mm, the two products": 0.0,
            "torch._int_mm, the two products, K-major weights": 0.0}
    for i, j, blk, x4, *_ in ops:
        m, c = x4.numel() // x4.shape[-1], x4.shape[-1]
        a, w1, h, w2 = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                      dtype=torch.int8)
                        for shape in ((m, c), (c, 4 * c), (m, 4 * c), (4 * c, c)))
        w1k, w2k = w1.t().contiguous().t(), w2.t().contiguous().t()
        for key, (u, v) in zip(yard, ((w1, w2), (w1k, w2k))):
            yard[key] += cuda_ms(lambda: (torch._int_mm(a, u), torch._int_mm(h, v)))
    ms.update(yard)
    # the f32 int8 kernel runs the same int8 products: the same yardstick
    for name in ("swin_mlp_int8", "swin_mlp_int8_f32"):
        results[name]["library_ms"] = min(yard.values())
    log(f"  per forward of {BATCH} clips over the {len(ops)} blocks: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()) + f" [{card}]")
    return launches


def phase_opt_in_f32(card: str, params: dict, results: dict) -> dict:
    """The two opt-in ops in f32 (their f32 kernels) on the activations of
    one f32 forward of BATCH 5 s clips with phase 10's weights (``params``,
    phase 3's, with seeded projection weights): each Swin block's input
    captured by a forward pre-hook; then, counts at 0, the f32 v2 attention
    half with the block's f32 weights (and their ``half_operands``) and the
    f32 int8 MLP on its output (on its ``mlp_int8_operands``), for all 18
    blocks; then each against its plain version in full f32 (phase 3's f32
    bounds at the block's stage), the int8 branch against the exact f32
    branch, and per-forward times (the int8 MLP also quantising per
    call)."""
    from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.attention import (
        swin_attention_half_v2,
        swin_attention_half_v2_plain,
    )
    from audio_metrics_tpu_torch.ops.mlp import (
        mlp_block_int8,
        mlp_block_int8_plain,
        mlp_block_plain,
        mlp_int8_operands,
    )

    cfg = HTSAT_BASE
    clap = LaionCLAP(params=dict(params, **init_projection_params(cfg, seed=0)), cfg=cfg,
                     compute_dtype="float32", device="cuda")
    audio, _ = clips(BATCH, CLIP_S, seed=11)
    blocks = [(i, j, blk) for i, stage in enumerate(clap.model.encoder.blocks)
              for j, blk in enumerate(stage)]
    inputs = []
    hooks = [blk.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
             for _, _, blk in blocks]
    clap.embed(audio)
    for h in hooks:
        h.remove()
    ops = []
    for (i, j, blk), x in zip(blocks, inputs):
        attn, mlp, a_ops = v2_weights(params, f"audio_encoder.layers.{i}.blocks.{j}", blk,
                                      torch.float32)
        geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
        ops.append((i, j, blk, x.view(BATCH, blk.resolution, blk.resolution, -1), attn, mlp,
                    a_ops, geo, mlp_int8_operands(mlp[2], mlp[4])))

    set_counts_to_zero()
    outs = []
    with torch.no_grad():
        for i, j, blk, x4, attn, mlp, a_ops, geo, m_ops in ops:
            a = swin_attention_half_v2(x4, *attn, **geo, operands=a_ops)
            outs.append((a, mlp_block_int8(a.view(BATCH, -1, a.shape[-1]), *mlp, eps=blk.eps,
                                           operands=m_ops)))
    launches = read_counts()
    check_counts(f"{len(ops)} f32 blocks, the f32 v2 attention half then the f32 int8 MLP",
                 launches, {name: len(ops) if name in ("swin_attn_v2_f32", "swin_mlp_int8_f32")
                            else 0 for name in launches})

    ms = {"swin_attn_v2_f32": 0.0, "swin_mlp_int8_f32": 0.0,
          "swin_mlp_int8_f32 quantising per call": 0.0}
    for (i, j, blk, x4, attn, mlp, a_ops, geo, m_ops), (a, m) in zip(ops, outs):
        a3 = a.view(BATCH, -1, a.shape[-1])
        want_a = swin_attention_half_v2_plain(x4, *attn, **geo)
        want_m = mlp_block_int8_plain(a3, *mlp, eps=blk.eps)
        exact = mlp_block_plain(a3, *mlp, eps=blk.eps) - a3
        line = f"  block {i}.{j} R={blk.resolution} C={a.shape[-1]}:"
        ok = True
        for name, got, want, x in (("swin_attn_v2_f32", a, want_a, x4),
                                   ("swin_mlp_int8_f32", m, want_m, a3)):
            mx, rel = compare(name, got, want, want - x, results)
            rel_tol, max_tol = TOL[name][0][i], TOL[name][1]
            ok &= mx <= max_tol and rel <= rel_tol
            line += f" {name} max_abs_err {mx:.4g} rel {rel:.4g} (tol {max_tol}, {rel_tol});"
        fro = (torch.linalg.norm(m - a3 - exact) / torch.linalg.norm(exact)).item()
        log(f"{line} int8 branch vs the exact f32 branch {fro:.4g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"an f32 opt-in op disagrees at block {i}.{j}")
        ms["swin_attn_v2_f32"] += cuda_ms(lambda: swin_attention_half_v2(x4, *attn, **geo,
                                                                         operands=a_ops))
        ms["swin_mlp_int8_f32"] += cuda_ms(lambda: mlp_block_int8(a3, *mlp, eps=blk.eps,
                                                                  operands=m_ops))
        ms["swin_mlp_int8_f32 quantising per call"] += cuda_ms(
            lambda: mlp_block_int8(a3, *mlp, eps=blk.eps))
    log(f"  per forward of {BATCH} f32 clips over the {len(ops)} blocks: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()) + f" [{card}]")
    return launches


def f32_plain_path(clap):
    """An embedder with ``clap``'s f32 weights through the f32 plain chain:
    the f32 mel chain (PyTorch ops), then every block's and merge's plain
    version, in full f32."""
    from audio_metrics_tpu_torch.utils.precision import full_f32

    model = clap.model

    class PlainPath:
        sr, device = clap.sr, clap.device

        @staticmethod
        @torch.no_grad()
        def embed(audio):
            with full_f32():
                tokens = model.f32_tokens(audio)
                return model._projection_taps(model.encoder(tokens, plain=True))[clap.layer]

    return PlainPath()


def write_clap_checkpoint(params: dict, ckpt_dir: str, cfg=None, name: str | None = None) -> str:
    """``params`` (phase 3's weights, or phase 19's of ``cfg``) with seeded
    projection weights, written as a LAION-named ``.pt`` (``module.``
    prefix, fused qkv) under ``name`` (default: the default embedder's
    checkpoint file name) in ``ckpt_dir``; returns the name."""
    from audio_metrics_tpu_torch.models.clap import (
        LAION_CLAP_MUSIC_CHECKPOINT_URL,
        init_projection_params,
    )
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.testing import laion_state_dict

    weights = dict(params, **init_projection_params(cfg or HTSAT_BASE, seed=0))
    name = name or LAION_CLAP_MUSIC_CHECKPOINT_URL.rsplit("/", 1)[-1]
    torch.save({"state_dict": laion_state_dict(weights)}, os.path.join(ckpt_dir, name))
    return name


def phase_f32(card: str, params: dict, switches: dict, per_forward: dict, against=None,
              clap=None, warm_runs: int = 1):
    """The default configuration on the card: ``AudioMetrics(metrics=["fad",
    "kd", "prdc"])`` with no embedder, which builds the registry default
    ``laion_clap_music`` (HTSAT-base, f32) from its checkpoint, here
    ``params`` (phase 3's weights, with seeded projection weights) written
    as a LAION-named ``.pt`` (``module.`` prefix, fused qkv) under the
    checkpoint URL's file name in a temporary directory that
    ``AM_TPU_CKPT_DIR`` names, with the configuration variables
    ``switches``, around the model's construction only (the encoder reads
    them when it is built).
    N_CLIPS_F32 + N_CLIPS_F32 5 s clips (seed 11): launch counts
    (``per_forward`` a forward, no other kernel), finite metrics, clips/s
    first and warm, FAD of the reference against itself, the reference
    embeddings against the f32 plain chain on the same weights, and, given
    ``against`` (another configuration's on the same clips), their distance
    to it, printed.  Given ``clap`` (an f32 LaionCLAP built by the caller),
    that embedder in ``AudioMetrics`` instead, and ``params`` unused; with
    ``warm_runs`` > 1 that many more warm evaluates, their median and
    spread.  Returns (launches, reference embeddings)."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP

    metrics = ["fad", "kd", "prdc"]
    reference, candidate = clips(N_CLIPS_F32, CLIP_S, seed=11)
    if clap is not None:
        name = "the caller's checkpoint"
        am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S), input_sr=SR,
                          batch_size=BATCH, device="cuda")
    else:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            name = write_clap_checkpoint(params, ckpt_dir)
            with environ(AM_TPU_CKPT_DIR=ckpt_dir, **switches):  # the encoder reads them
                am = AudioMetrics(metrics=metrics, batch_size=BATCH, device="cuda")
    clap = am.embedder
    log(f"  embedder {type(clap).__name__} {clap.layer} from {name}, compute dtype "
        f"{clap.model.compute_dtype}, win_dur {am.win_dur}")
    if not isinstance(clap, LaionCLAP) or clap.model.compute_dtype != torch.float32:
        raise AssertionError("the default embedder is not LaionCLAP in f32")

    # a user's process runs one configuration: release what the earlier
    # phases left in the allocator's cache, and count the allocator's
    # retries (each a synchronising free of the cache) in the evaluates
    cached = torch.cuda.memory_reserved() / 2**30
    torch.cuda.empty_cache()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = read_counts()
    forwards = 2 * -(-N_CLIPS_F32 // BATCH)
    log(f"  result {result}")
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", launches,
                 expected(forwards, **per_forward))
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    t0 = time.perf_counter()
    am.evaluate(candidate)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"  evaluate of {N_CLIPS_F32} 5 s clips in f32: {N_CLIPS_F32 / warm:.2f} clips/s warm "
        f"({warm:.4f} s), {N_CLIPS_F32 / cold:.2f} clips/s first ({cold:.4f} s) "
        f"[{card}; real_weights: false]; allocator: {cached:.2f} GiB cached by earlier phases "
        f"released, {torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries} alloc "
        "retries since")
    if warm_runs > 1:
        log(f"  {warm_evaluates(am, candidate, N_CLIPS_F32, warm_runs)} in f32 [{card}]")
    self_fad = am.evaluate(reference)["fad"]
    log(f"  FAD of the reference against itself: {self_fad:.3g} (tol |fad| <= 1e-4)")
    if not abs(self_fad) <= 1e-4:
        raise AssertionError("FAD(reference, reference) is not ~0")

    amp = AudioMetrics(metrics=metrics, embedder=f32_plain_path(clap), batch_size=BATCH,
                       device="cuda")
    amp.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = amp.evaluate(candidate)
    torch.cuda.synchronize()
    log(f"  f32 plain path: {plain} ({N_CLIPS_F32 / (time.perf_counter() - t0):.2f} clips/s)")
    e_k, e_p = am.stem_reference.embeddings, amp.stem_reference.embeddings
    cos = (e_k * e_p).sum(dim=1).min().item()
    emax = (e_k - e_p).abs().max().item()
    ok = 1 - cos <= F32_E2E_TOL[0] and emax <= F32_E2E_TOL[1]
    log(f"  embeddings f32 kernels vs f32 plain chain: 1 - min cosine {1 - cos:.3g} (tol "
        f"{F32_E2E_TOL[0]}), max abs {emax:.4g} (tol {F32_E2E_TOL[1]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32 kernel-path embeddings disagree with the f32 plain chain")
    for key, v in result.items():
        rel = abs(v - plain[key]) / max(abs(plain[key]), 1e-12)
        log(f"  {key}: kernels {v:.8g} plain {plain[key]:.8g} rel {rel:.3g}")
    if against is not None:
        cos = (e_k * against).sum(dim=1).min().item()
        log(f"  embeddings against phase 10's (whole blocks) on the same clips: 1 - min cosine "
            f"{1 - cos:.3g}, max abs {(e_k - against).abs().max().item():.4g}")
    return launches, e_k


def warm_evaluates(am, candidate, n_clips: int, runs: int = 3, unit: str = "clips") -> str:
    """``runs`` warm evaluates, each timed up to ``torch.cuda.synchronize``:
    ``unit``/s median and spread (min..max), as a printable string."""
    return warm_rate(am, candidate, n_clips, runs, unit)[1]


def warm_rate(am, candidate, n_clips: int, runs: int = 3,
              unit: str = "clips") -> tuple[float, str]:
    """:func:`warm_evaluates`' median rate and its printable string."""
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        am.evaluate(candidate)
        torch.cuda.synchronize()
        rates.append(n_clips / (time.perf_counter() - t0))
    med = float(np.median(rates))
    return med, (f"{med:.2f} {unit}/s warm, median of {runs} "
                 f"({min(rates):.2f}..{max(rates):.2f})")


def check_self_fad(am, reference) -> None:
    self_fad = am.evaluate(reference)["fad"]
    log(f"  FAD of the reference against itself: {self_fad:.3g} (tol |fad| <= 1e-4)")
    if not abs(self_fad) <= 1e-4:
        raise AssertionError("FAD(reference, reference) is not ~0")


def embeddings_close(what: str, got, want, tol) -> None:
    """(1 - min cosine, max abs) of two embeddings of the same clips, under
    ``tol``."""
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1).min().item()
    emax = (got - want).abs().max().item()
    ok = 1 - cos <= tol[0] and emax <= tol[1]
    log(f"  {what}: 1 - min cosine {1 - cos:.3g} (tol {tol[0]}), max abs {emax:.4g} (tol "
        f"{tol[1]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} disagree")


def phase_vggish(card: str) -> None:
    """VGGish (bench.py's main_vggish without its APA mix) on the card:
    seeded torchvggish-named weights written as the URL's file in a
    temporary directory that ``AM_TPU_CKPT_DIR`` names around this phase.
    (a) bf16, N_CLIPS + N_CLIPS 5 s clips at 16 kHz, batch VGGISH_BATCH,
    FAD+KD+PRDC: launch counts (#4 and #5 only), finite metrics, FAD of a
    set against itself, PRDC through the kernels against the plain
    versions, clips/s of three warm evaluates, ``timings``, and the times of
    the log-mel and of the conv stack alone on one batch; (b) ``vggish`` by
    name (f32) on N_CLIPS_VGGISH_F32 + N_CLIPS_VGGISH_F32 of the clips: its
    embeddings against (a)'s bf16 ones, bounded."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models import get_embedder
    from audio_metrics_tpu_torch.models.vggish import (
        VGGISH_CHECKPOINT_URL,
        VGGish,
        init_params,
        vggish_log_mel_patches,
    )
    from audio_metrics_tpu_torch.testing import seeded_clips

    sr = 16000
    params = init_params(seed=0)
    rng = np.random.default_rng(12)
    for key in params:  # init_params zeroes the biases
        if key.endswith(".bias"):
            params[key] = (0.1 * rng.standard_normal(params[key].shape)).astype(np.float32)
    name = VGGISH_CHECKPOINT_URL.rsplit("/", 1)[-1]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        torch.save({k: torch.from_numpy(v) for k, v in params.items()},
                   os.path.join(ckpt_dir, name))
        with environ(AM_TPU_CKPT_DIR=ckpt_dir):
            bf16 = VGGish(compute_dtype="bfloat16", device="cuda")
            f32 = get_embedder("vggish", device="cuda")
    if not (isinstance(f32, VGGish) and f32.compute_dtype == torch.float32
            and np.array_equal(f32.features_0_bias.cpu().numpy(), params["features.0.bias"])):
        raise AssertionError("vggish by name is not f32 VGGish with the file's weights")
    reference, candidate = seeded_clips(N_CLIPS, CLIP_S * sr, sr, seed=12)
    log(f"  VGGish from {name}: {N_CLIPS} + {N_CLIPS} clips of {CLIP_S} s at {sr} Hz on the "
        f"card, batch {VGGISH_BATCH}")
    metrics = ["fad", "kd", "prdc"]
    am = AudioMetrics(metrics=metrics, embedder=bf16, win_dur=float(CLIP_S), input_sr=sr,
                      batch_size=VGGISH_BATCH, device="cuda")
    torch.cuda.empty_cache()
    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    log(f"  result (bf16) {result}")
    check_counts("add_reference + first evaluate (bf16 VGGish: no CLAP kernel)", read_counts(),
                 expected(0))
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    log(f"  evaluate of {N_CLIPS} clips: {warm_evaluates(am, candidate, N_CLIPS)}, "
        f"{N_CLIPS / cold:.2f} clips/s first [{card}; real_weights: false]")
    log(f"  timings of the last evaluate (s): {am.timings}")
    check_prdc_paths(am, candidate, "VGGish path")
    check_self_fad(am, reference)
    batch = reference[:VGGISH_BATCH]
    patches = vggish_log_mel_patches(batch).reshape(-1, 96, 64)
    with torch.no_grad():
        mel_ms = cuda_ms(lambda: vggish_log_mel_patches(batch))
        net_ms = cuda_ms(lambda: bf16.patch_net(patches))
        net32_ms = cuda_ms(lambda: f32.patch_net(patches))
    log(f"  one batch of {VGGISH_BATCH} clips ({patches.shape[0]} patches): log-mel "
        f"{mel_ms:.3f} ms (f32 products, library), conv stack + FCs bf16 {net_ms:.3f} ms, "
        f"f32 {net32_ms:.3f} ms (F.conv2d and products in full f32, library) [{card}]")

    n = N_CLIPS_VGGISH_F32
    e16 = am.stem_reference.embeddings[:n]
    am32 = AudioMetrics(metrics=metrics, embedder=f32, win_dur=float(CLIP_S), input_sr=sr,
                        batch_size=VGGISH_BATCH, device="cuda")
    am32.add_reference(reference[:n])
    result32 = am32.evaluate(candidate[:n])
    log(f"  f32 by name on {n} + {n} clips: {result32}")
    if not all(np.isfinite(v) for v in result32.values()):
        raise AssertionError("non-finite metric")
    embeddings_close("VGGish f32 embeddings against bf16 on the same clips",
                     am32.stem_reference.embeddings, e16, VGGISH_BF16_TOL)


def phase_stems_options(card: str) -> None:
    """The stems options on CLAP HTSAT-base bf16 with phase 4's weights:
    ``hop_dur``, ``input_sr`` 44.1 kHz, ``n_pca``, ``precompile`` and
    ``AM_TPU_NO_MEL_TILE`` (set around its sub-phase only)."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.resample import resample_batch
    from audio_metrics_tpu_torch.testing import seeded_clips

    metrics = ["fad", "kd", "prdc"]
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    per_forward = dict(swin_block=18, patch_merge=3, clap_frontend=1)

    def metrics_for(**kw):
        return AudioMetrics(metrics=metrics, embedder=clap, batch_size=BATCH, device="cuda",
                            **kw)

    log("  hop_dur=2.5 s under win_dur=5 s on 10 s clips")
    reference, candidate = clips(N_CLIPS_10S, 10, seed=13)
    am = metrics_for(win_dur=5.0, hop_dur=2.5, input_sr=SR)
    set_counts_to_zero()
    am.add_reference(reference)
    result = am.evaluate(candidate)
    n_win = am.stem_reference.n
    log(f"  result {result}; {n_win} reference windows (3 a clip expected)")
    if n_win != 3 * N_CLIPS_10S or not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("hop_dur: wrong window count or non-finite metric")
    check_counts(f"add_reference + first evaluate, {2 * -(-n_win // BATCH)} forward batches",
                 read_counts(), expected(2 * -(-n_win // BATCH), **per_forward))
    check_self_fad(am, reference)
    win, hop = 5 * SR, SR * 5 // 2
    slices = torch.stack([reference[:, i * hop : i * hop + win] for i in range(3)], dim=1)
    direct = torch.cat([clap.embed(b) for b in slices.reshape(-1, win).split(BATCH)])
    embeddings_close("windows' embeddings against the same slices embedded directly",
                     am.stem_reference.embeddings, direct,
                     (E2E_TOL["1-cos"], E2E_TOL["max_abs"]))

    log("  input_sr=44100 on 5 s clips (resampled on the card to 48 kHz)")
    sr_in = 44100
    reference, candidate = seeded_clips(N_CLIPS_10S, CLIP_S * sr_in, sr_in, seed=14)
    rows = reference[:4]
    got = resample_batch(rows, sr_in, SR).cpu().numpy()
    import scipy.signal as ss

    want = ss.resample_poly(rows.double().cpu().numpy(), 160, 147, axis=1)
    err = float(np.abs(got - want).max())
    log(f"  resampled windows against scipy.signal.resample_poly: max abs {err:.3g} (tol 2e-6) "
        f"{'ok' if err <= 2e-6 else 'FAIL'}")
    if not err <= 2e-6:
        raise AssertionError("the resampler disagrees with scipy")
    batch = reference[:BATCH]
    rs_ms = cuda_ms(lambda: resample_batch(batch, sr_in, SR), iters=20)
    n_bytes = 4 * batch.numel() * (1 + SR / sr_in)
    log(f"  resample_batch of {BATCH} 5 s windows 44.1 -> 48 kHz: {rs_ms:.4f} ms (conv1d, "
        f"full f32, library; bytes bound {1e3 * n_bytes / PEAK['bytes']:.4f} ms) [{card}]")
    am = metrics_for(win_dur=float(CLIP_S), input_sr=sr_in)
    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    log(f"  result {result}")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    check_counts(f"add_reference + first evaluate, {2 * -(-N_CLIPS_10S // BATCH)} forward "
                 "batches", read_counts(), expected(2 * -(-N_CLIPS_10S // BATCH), **per_forward))
    log(f"  evaluate of {N_CLIPS_10S} clips at 44.1 kHz: "
        f"{warm_evaluates(am, candidate, N_CLIPS_10S)}, {N_CLIPS_10S / cold:.2f} clips/s first "
        f"[{card}; real_weights: false]; timings {am.timings}")

    log(f"  n_pca=64 on {N_CLIPS_PCA} + {N_CLIPS_PCA} 5 s clips")
    reference, candidate = clips(N_CLIPS_PCA, CLIP_S, seed=15)
    am = metrics_for(win_dur=float(CLIP_S), input_sr=SR, n_pca=64)
    am.add_reference(reference)
    result = am.evaluate(candidate)
    log(f"  result {result}; timings {am.timings}")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    check_self_fad(am, reference)

    log("  precompile() on the n_pca instance, which holds a reference and a fitted projection")
    ref_data, ref_pca = am.stem_reference, am.stem_reference_pca
    before = (ref_data.embeddings.clone(), *(a.copy() for a in ref_data.stats()[:2]),
              {k: v.clone() for k, v in ref_data.radii.items()}, ref_pca.embeddings.clone(),
              {k: np.copy(v) for k, v in am.stem_projection.__getstate__().items()})
    t0 = time.perf_counter()
    am.precompile()
    torch.cuda.synchronize()
    log(f"  precompile(n_items=256): {time.perf_counter() - t0:.3f} s")
    after = (am.stem_reference.embeddings, *am.stem_reference.stats()[:2],
             am.stem_reference.radii, am.stem_reference_pca.embeddings,
             am.stem_projection.__getstate__())
    same = (am.stem_reference is ref_data and am.stem_reference_pca is ref_pca
            and torch.equal(before[0], after[0]) and np.array_equal(before[1], after[1])
            and np.array_equal(before[2], after[2]) and before[3].keys() == after[3].keys()
            and all(torch.equal(before[3][k], after[3][k]) for k in before[3])
            and torch.equal(before[4], after[4]) and before[5].keys() == after[5].keys()
            and all(np.array_equal(before[5][k], after[5][k]) for k in before[5]))
    log(f"  references and projection after precompile bitwise as before: {same}")
    if not same:
        raise AssertionError("precompile changed the instance's state")
    got = am.evaluate(candidate)
    fresh = metrics_for(win_dur=float(CLIP_S), input_sr=SR, n_pca=64)
    fresh.add_reference(reference)
    want = fresh.evaluate(candidate)
    log(f"  next evaluate {got}; a fresh instance's {want}")
    if got != want:
        raise AssertionError("the evaluate after precompile differs from a fresh instance's")

    log("  AM_TPU_NO_MEL_TILE=1 on 5 s clips: the halo log-mel (#6), no fused frontend (#3)")
    reference, candidate = clips(N_CLIPS_10S, CLIP_S, seed=16)
    base = metrics_for(win_dur=float(CLIP_S), input_sr=SR)
    base.add_reference(reference)
    with environ(AM_TPU_NO_MEL_TILE="1"):
        am = metrics_for(win_dur=float(CLIP_S), input_sr=SR)
        set_counts_to_zero()
        am.add_reference(reference)
        result = am.evaluate(candidate)
        forwards = 2 * -(-N_CLIPS_10S // BATCH)
        check_counts(f"add_reference + first evaluate, {forwards} forward batches",
                     read_counts(), expected(forwards, swin_block=18, patch_merge=3, log_mel=1))
        log(f"  result {result}; {warm_evaluates(am, candidate, N_CLIPS_10S)} "
            f"[{card}; real_weights: false]")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    embeddings_close("embeddings against the default path on the same clips",
                     am.stem_reference.embeddings, base.stem_reference.embeddings,
                     CONFIG_TOL["no_mel_tile"])


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_oom_retry(card: str) -> None:
    """The OOM retry on the card: with the allocator held by
    ``torch.cuda.set_per_process_memory_fraction`` to the allocations so far
    (the clips among them; reserved memory, which the fraction counts) and
    1.4 times the peak of one forward of OOM_FIT clips, an ``AudioMetrics``
    at batch OOM_BATCH runs out of memory and halves its batch until it fits (OOM_FIT or above), logging the warning
    each time, in ``add_reference`` and again in ``evaluate``; its result is
    held against a run at the batch that fit under phase 4's end-to-end
    bounds.  The fraction is restored in a ``finally``."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE

    metrics = ["fad", "kd", "prdc"]
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    # the clips in segments of their own (not in the free parts of segments
    # that earlier phases left cached, which would stay reserved around them)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reference, candidate = clips(OOM_BATCH, CLIP_S, seed=17)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        clap.embed(reference[:OOM_FIT])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()  # what the fraction counts
    total = torch.cuda.get_device_properties(0).total_memory
    limit = held + 1.4 * peak
    log(f"  one forward of {OOM_FIT} clips peaks at {peak / 2**30:.3f} GiB over "
        f"{base / 2**30:.3f} GiB allocated ({held / 2**30:.3f} GiB reserved); allocator limit "
        f"{limit / 2**30:.3f} GiB of {total / 2**30:.1f}")
    handler = _Records()
    pipe_log = logging.getLogger("audio_metrics_tpu_torch.parallel.pipeline")
    pipe_log.addHandler(handler)
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S), input_sr=SR,
                          batch_size=OOM_BATCH, device="cuda")
        am.add_reference(reference)
        result = am.evaluate(candidate)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        pipe_log.removeHandler(handler)
    torch.cuda.empty_cache()
    prefix = "fused embed loop exhausted device memory; retrying at batch_size="
    steps = len(handler.messages) // 2
    fit = OOM_BATCH >> steps
    want_msgs = [f"{prefix}{OOM_BATCH >> i}" for i in range(1, steps + 1)]
    log(f"  warnings: {handler.messages}")
    if not (steps and fit >= OOM_FIT and handler.messages == 2 * want_msgs):
        raise AssertionError(f"the retry did not step {OOM_BATCH} down by halves to a batch "
                             f">= {OOM_FIT}, in add_reference and in evaluate")
    direct = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S), input_sr=SR,
                          batch_size=fit, device="cuda")
    direct.add_reference(reference)
    want = direct.evaluate(candidate)
    log(f"  result after the retries (batch {fit}) {result}; at batch {fit} directly {want}")
    for key in ("fad", "kernel_distance_mean", "kernel_distance_std"):
        rel = abs(result[key] - want[key]) / max(abs(want[key]), 1e-12)
        log(f"  {key}: rel {rel:.3g} (tol {E2E_TOL[key]})")
        if not rel <= E2E_TOL[key]:
            raise AssertionError(f"{key} after the OOM retry disagrees with the direct run")


def mix_bound(n_pairs: int, n: int, limited: bool) -> tuple[float, str, float]:
    """``bound`` of one registry L0 mix of ``n_pairs`` pairs of ``n``
    samples, by what ``ops.iir.lfilter_blocked`` multiplies: its (L, L)
    chunk product, 2 L = 512 f32 operations a sample a section, over the
    K-weighting's 3 sections of 3 n_pairs signals (context, stem, mix);
    and the limiter's one section of n_pairs signals when an item peaks
    (it runs for every chunk and is selected per item, but this run's data
    needs it only then).  Bytes: the pairs read, the mixes written."""
    from audio_metrics_tpu_torch.ops.iir import _k_weighting_sections

    sections = len(_k_weighting_sections(float(SR)))
    ops = 512.0 * n * (sections * 3 * n_pairs + (n_pairs if limited else 0))
    return bound({"f32": ops}, 4.0 * n * n_pairs * 3)


def phase_apa(card: str) -> None:
    """(a) ``bench.py``'s ``main_apa`` on the card: ``AudioMetrics(metrics=
    ["apa", "fad"])``, ``L0``, LaionCLAP HTSAT-base bf16 with phase 4's
    seeded weights, batch APA_BATCH, over N_PAIRS_APA + N_PAIRS_APA 5 s
    pairs at 48 kHz (``testing.seeded_pairs``: a tone and its octave under
    one envelope; half of the candidate pairs misaligned): launch counts of
    ``add_reference`` + first evaluate (aligned, misaligned and stem sets,
    then aligned and stems: 10 forwards), d(x, x'), APA of the reference
    against itself, the candidate evaluate through the plain versions on
    the same reference state, pairs/s of three warm evaluates and
    ``timings``; then the L0 mix of the first MIX_CHUNK reference pairs on
    the card against the same mix on the CPU, its loudness in the float64
    oracle against -20 LUFS, and its time (CUDA events) beside
    ``mix_bound``."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.loudness import integrated_loudness_batch
    from audio_metrics_tpu_torch.ops.mix import MIX_FUNCTIONS
    from audio_metrics_tpu_torch.testing import seeded_pairs

    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    am = AudioMetrics(metrics=["apa", "fad"], embedder=clap, mix_function="L0",
                      win_dur=float(CLIP_S), input_sr=SR, batch_size=APA_BATCH, device="cuda")
    n = N_PAIRS_APA
    torch.cuda.empty_cache()
    reference = seeded_pairs(n, CLIP_S * SR, SR, seed=15)
    candidate = seeded_pairs(n, CLIP_S * SR, SR, seed=16, misaligned=n // 2)
    log(f"  {n} + {n} pairs of {CLIP_S} s on the card ({2 * reference.numel() * 4 / 2**30:.3f} "
        f"GiB f32), L0, batch {APA_BATCH}")
    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    forwards = 5 * -(-n // APA_BATCH)
    want = {name: 0 for name in read_counts()}
    want.update(swin_block=18 * forwards, patch_merge=3 * forwards, clap_frontend=forwards)
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", read_counts(),
                 want)
    log(f"  result {result}; d(x, x') {am.apa_d_x_xp:.6g} (must exceed 10x phase 4's self-FAD "
        "bound 1e-4)")
    if not (all(np.isfinite(v) for v in result.values()) and 0.0 <= result["apa"] <= 1.0):
        raise AssertionError("APA outside [0, 1] or a non-finite metric")
    if not am.apa_d_x_xp > 1e-3:
        raise AssertionError("d(x, x') is near FAD's self-noise: APA would measure noise")
    log(f"  evaluate of {n} pairs: {warm_evaluates(am, candidate, n, unit='pairs')}, "
        f"{n / cold:.2f} pairs/s first [{card}; real_weights: false]")
    log(f"  timings of the last evaluate (s): {am.timings}")
    self_apa = am.evaluate(reference)["apa"]
    log(f"  APA of the reference pairs against themselves: {self_apa:.8g} (tol |1 - apa| <= "
        f"{APA_SELF_TOL})")
    if not abs(1.0 - self_apa) <= APA_SELF_TOL:
        raise AssertionError("APA(reference, reference) is not ~1")

    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "apa_state.npz")
        am.save_state(state)
        amp = AudioMetrics(metrics=["apa", "fad"], embedder=plain_path(clap), mix_function="L0",
                           device="cuda")
        amp.load_state(state)
    amp.batch_size = BATCH  # phase 4's batch for the plain versions
    plain = amp.evaluate(candidate)
    log(f"  plain path on the same reference state: {plain}")
    rel = abs(result["fad"] - plain["fad"]) / abs(plain["fad"])
    diff = abs(result["apa"] - plain["apa"])
    log(f"  fad: rel {rel:.3g} (tol {E2E_TOL['fad']}); apa: abs {diff:.3g} (tol {APA_E2E_TOL})")
    if not (rel <= E2E_TOL["fad"] and diff <= APA_E2E_TOL):
        raise AssertionError("APA or FAD through the kernels disagrees with the plain path")

    pairs = reference[:MIX_CHUNK]
    l0 = MIX_FUNCTIONS["L0"]
    mixed = l0(pairs, sr=SR, diag=[])
    on_cpu = l0(pairs.cpu(), sr=SR, diag=[])
    err = (mixed.cpu() - on_cpu).abs().max().item()
    peak = mixed.abs().amax(dim=1).cpu()
    lufs = integrated_loudness_batch(mixed, SR, method="scan").cpu()[peak <= 1.0]
    lufs_err = (lufs + 20.0).abs().max().item()
    log(f"  L0 mix of {MIX_CHUNK} pairs, card against CPU: max abs {err:.3g} (tol {MIX_CARD_TOL}"
        f", max |mix| {mixed.abs().max().item():.4g}); float64 loudness of the {len(lufs)} items "
        f"not limited against -20 LUFS: max {lufs_err:.3g} dB (tol {MIX_LUFS_TOL})")
    if not (err <= MIX_CARD_TOL and len(lufs) and lufs_err <= MIX_LUFS_TOL):
        raise AssertionError("the card's L0 mix disagrees with the CPU's or misses -20 LUFS")
    mix_ms = cuda_ms(lambda: l0(pairs, sr=SR, diag=[]))
    b_ms, b_by, b_ops = mix_bound(MIX_CHUNK, pairs.shape[1], bool((peak > 1.0).any()))
    log(f"  L0 mix of {MIX_CHUNK} pairs: {mix_ms:.4f} ms (CUDA events) against a bound of "
        f"{b_ms:.4f} ms ({b_by}: {b_ops / 1e9:.2f} GFLOP f32 in lfilter_blocked's chunk "
        f"products) [{card}]")
    del am, amp, reference, candidate


def phase_apa_defaults(card: str, params: dict) -> None:
    """(b) the defaults: ``AudioMetrics(input_sr=48000)`` builds
    ``laion_clap_music`` (f32) from phase 10's checkpoint, written again in
    a temporary directory that ``AM_TPU_CKPT_DIR`` names around the
    construction only, and takes APA + FAD over N_PAIRS_DEFAULT +
    N_PAIRS_DEFAULT pairs at its batch of 32: launch counts (f32 kernels
    only), finite metrics, APA in [0, 1], pairs/s."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.testing import seeded_pairs

    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_clap_checkpoint(params, ckpt_dir)
        with environ(AM_TPU_CKPT_DIR=ckpt_dir):
            am = AudioMetrics(input_sr=48000)
    n = N_PAIRS_DEFAULT
    log(f"  AudioMetrics(input_sr=48000): metrics {am.metrics}, embedder "
        f"{type(am.embedder).__name__} {am.embedder.model.compute_dtype}, mix "
        f"{am.mix_function.keywords}, batch {am.batch_size}; {n} + {n} pairs")
    torch.cuda.empty_cache()
    reference = seeded_pairs(n, CLIP_S * SR, SR, seed=25)
    candidate = seeded_pairs(n, CLIP_S * SR, SR, seed=26, misaligned=n // 2)
    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    forwards = 5 * -(-n // am.batch_size)
    want = {name: 0 for name in read_counts()}
    want.update(swin_block_f32=18 * forwards, patch_merge_f32=3 * forwards)
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", read_counts(),
                 want)
    log(f"  result {result}; d(x, x') {am.apa_d_x_xp:.6g}")
    if not (all(np.isfinite(v) for v in result.values()) and 0.0 <= result["apa"] <= 1.0):
        raise AssertionError("APA outside [0, 1] or a non-finite metric at the defaults")
    log(f"  evaluate of {n} pairs: {warm_evaluates(am, candidate, n, unit='pairs')}, "
        f"{n / cold:.2f} pairs/s first [{card}; real_weights: false]")



def stacked_windows(songs, win: int) -> torch.Tensor:
    """The whole windows of ``songs`` (numpy), in the host-fed path's order,
    stacked as one (N, win) f32 tensor on the card."""
    return torch.cat([torch.from_numpy(s[: len(s) // win * win]).view(-1, win)
                      for s in songs]).cuda()


def phase_hostfed(card: str) -> None:
    """(a) The host-fed stems path: ``AudioMetrics(metrics=["fad", "kd",
    "prdc", "fad_inf"])``, LaionCLAP HTSAT-base bf16 with phase 4's seeded
    weights at the ``laion_clap_music_l-2`` tap (``audio_projection.0``,
    before the projection's ReLU: with random weights the default tap's
    embeddings span only the ReLU units that fire, so their covariance has
    no Cholesky factor and FAD-inf cannot run), batch 64, over Python lists
    of numpy mono songs at 48 kHz
    (``testing.seeded_songs``: 5.5-39.5 s each, every song ending in a
    partial window, which is dropped) holding N_WIN_HOSTFED 5 s windows a
    set: launch counts, finite metrics, FAD of a set against itself; the
    same windows stacked on the card through the device path: stored
    reference embeddings bitwise equal, fad, kd and prdc under phase 4's
    E2E_TOL; FAD-inf on the card against the port's FAD-inf on the CPU
    over the same embeddings (FAD_INF_TOL); clips/s of three warm
    evaluates and ``timings`` for the Python feeder,
    ``AM_TPU_NATIVE_LOADER=1``, ``AM_TPU_TRANSFER_INT16=1`` (each set
    around its run only) and the device path on the same windows."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.data import AudioMetricsData
    from audio_metrics_tpu_torch.metrics.fad import fad_inf_parts
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.parallel.native_loader import load_library
    from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory
    from audio_metrics_tpu_torch.testing import seeded_songs

    win, n = CLIP_S * SR, N_WIN_HOSTFED
    metrics = ["fad", "kd", "prdc", "fad_inf"]
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     layer="audio_projection.0", device="cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference = seeded_songs(n, win, SR, seed=31, device="cuda")
    candidate = seeded_songs(n, win, SR, seed=32, candidate=True, device="cuda")
    gib = sum(s.nbytes for s in reference + candidate) / 2**30
    log(f"  {len(reference)} + {len(candidate)} mono songs ({min(len(s) for s in reference) / SR:.1f}"
        f"-{max(len(s) for s in reference) / SR:.1f} s) holding {n} + {n} windows of {CLIP_S} s, "
        f"numpy on the host ({gib:.3f} GiB f32), made in {time.perf_counter() - t0:.2f} s; "
        f"batch {BATCH}")
    am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S), input_sr=SR,
                      batch_size=BATCH, device="cuda")
    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    forwards = 2 * -(-n // BATCH)
    log(f"  result {result}")
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", read_counts(),
                 expected(forwards, swin_block=18, patch_merge=3, clap_frontend=1))
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric on the host-fed path")
    check_self_fad(am, reference)

    ref_stack, cand_stack = stacked_windows(reference, win), stacked_windows(candidate, win)
    if not (ref_stack.shape[0] == cand_stack.shape[0] == n):
        raise AssertionError("the songs do not hold the windows asked for")
    amd = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S), input_sr=SR,
                       batch_size=BATCH, device="cuda")
    amd.add_reference(ref_stack)
    device = amd.evaluate(cand_stack)
    same = torch.equal(am.stem_reference.embeddings, amd.stem_reference.embeddings)
    log(f"  the same windows stacked on the card, device path: {device}; stored reference "
        f"embeddings bitwise equal: {same}")
    if not same:
        raise AssertionError("host-fed embeddings differ from the device path's on the same "
                             "windows")
    for key in ("fad", "kernel_distance_mean", "kernel_distance_std"):
        rel = abs(result[key] - device[key]) / max(abs(device[key]), 1e-12)
        log(f"  {key}: host-fed {result[key]:.8g} device path {device[key]:.8g} rel {rel:.3g} "
            f"(tol {E2E_TOL[key]})")
        if not rel <= E2E_TOL[key]:
            raise AssertionError(f"{key} of the host-fed path disagrees with the device path")
    prdc_keys = ("precision", "recall", "density", "coverage")
    log(f"  prdc host-fed {[result[k] for k in prdc_keys]} device path "
        f"{[device[k] for k in prdc_keys]}")
    if any(result[k] != device[k] for k in prdc_keys):
        raise AssertionError("PRDC of the host-fed path differs from the device path's on "
                             "bitwise equal embeddings")

    cand_set = am._run_pipeline(candidate, None)[ItemCategory.stem]
    arrays, reduce_fn = fad_inf_parts(cand_set, am.stem_reference)
    card_inf = reduce_fn(tuple(a.double().cpu().numpy() for a in arrays))
    cpu = [AudioMetricsData.deserialize(x.serialize(), device="cpu")
           for x in (cand_set, am.stem_reference)]
    arrays, reduce_fn = fad_inf_parts(*cpu)
    cpu_inf = reduce_fn(tuple(a.double().numpy() for a in arrays))
    for key, tol in FAD_INF_TOL.items():
        err = abs(card_inf[key] - cpu_inf[key]) / max(1.0, abs(cpu_inf[key]))
        log(f"  {key}: card {card_inf[key]:.8g} (evaluate {result[key]:.8g}) CPU "
            f"{cpu_inf[key]:.8g}: {err:.3g} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{key} on the card disagrees with the CPU")
    smallest_subset_trace_sqrt(cand_set, am.stem_reference, card)

    t0 = time.perf_counter()
    load_library()
    log(f"  native batcher built and loaded in {time.perf_counter() - t0:.2f} s (g++)")
    for what, env, cand in (("Python feeder", {}, candidate),
                            ("AM_TPU_NATIVE_LOADER=1", {"AM_TPU_NATIVE_LOADER": "1"}, candidate),
                            ("AM_TPU_TRANSFER_INT16=1", {"AM_TPU_TRANSFER_INT16": "1"}, candidate),
                            ("device path, the same windows stacked", {}, cand_stack)):
        with environ(**env):
            rate = warm_evaluates(am, cand, n)
        timings = {k: round(v, 4) for k, v in am.timings.items()}
        log(f"  {what}: evaluate of {n} windows {rate} [{card}; real_weights: false]; "
            f"timings (s) {timings}")
    log(f"  first evaluate (Python feeder): {n / cold:.2f} clips/s")
    del am, amd, ref_stack, cand_stack, reference, candidate


def smallest_subset_trace_sqrt(cand, ref, card: str) -> None:
    """Why FAD-inf's sweep runs in float64 (printed, not checked): ``Tr
    sqrt(L^T C_s L)`` of its smallest subset (``default_rng(1234)``, as
    ``fad_inf_parts`` draws it) by Newton-Schulz in f32, as the JAX package
    runs it, and in float64, against the float64 eigenvalues, on the card
    and on the CPU."""
    from audio_metrics_tpu_torch.metrics.fad import _ns_trace_sqrt_sym

    emb = cand.embeddings.double()
    n, d = emb.shape
    s = int(np.round(max(d + 2, 0.25 * n)))
    x = emb[torch.from_numpy(np.random.default_rng(1234).permutation(n)[:s]).cuda()]
    x = x - x.mean(dim=0)
    l = torch.from_numpy(ref.chol_cov()).cuda()
    m = l.T @ ((x.T @ x) / (s - 1)) @ l
    m = 0.5 * (m + m.T)
    eig = torch.linalg.eigvalsh(m)
    want = eig.clamp(min=0).sqrt().sum().item()
    got = {f"{dev} {dt} {it}": _ns_trace_sqrt_sym(m.to(dev, dt), it).item()
           for dev in ("cuda", "cpu") for dt in (torch.float32, torch.float64)
           for it in (30, 60)}
    log(f"  FAD-inf's smallest subset ({s} of {n} rows, d = {d}): eigenvalues of L^T C L "
        f"{eig[0].item():.3g}..{eig[-1].item():.3g}; Tr sqrt float64 eigh {want:.8g}; Newton-"
        "Schulz (device dtype iterations): " + ", ".join(f"{k} {v:.8g}" for k, v in got.items())
        + f" [{card}]")


def phase_hostfed_apa(card: str) -> None:
    """(b) The host-fed APA path: ``AudioMetrics(metrics=["apa", "fad"])``,
    ``L0``, LaionCLAP HTSAT-base bf16, batch 64, over lists of numpy
    context+stem songs (``testing.seeded_songs(pairs=True)``) holding
    N_WIN_HOSTFED_APA 5 s windows a set, through the Python feeder and the
    C++ batcher: launch counts, finite metrics, APA in [0, 1], APA of the
    reference against itself, pairs/s."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.testing import seeded_songs

    n = N_WIN_HOSTFED_APA
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    reference = seeded_songs(n, CLIP_S * SR, SR, seed=33, pairs=True, device="cuda")
    candidate = seeded_songs(n, CLIP_S * SR, SR, seed=34, pairs=True, device="cuda")
    log(f"  {len(reference)} + {len(candidate)} context+stem songs holding {n} + {n} windows "
        f"of {CLIP_S} s, L0, batch {BATCH}")
    for what, native in (("Python feeder", "0"), ("AM_TPU_NATIVE_LOADER=1", "1")):
        with environ(AM_TPU_NATIVE_LOADER=native):
            am = AudioMetrics(metrics=["apa", "fad"], embedder=clap, mix_function="L0",
                              win_dur=float(CLIP_S), input_sr=SR, batch_size=BATCH,
                              device="cuda")
            set_counts_to_zero()
            am.add_reference(reference)
            result = am.evaluate(candidate)
            forwards = 5 * -(-n // BATCH)
            want = {name: 0 for name in read_counts()}
            want.update(swin_block=18 * forwards, patch_merge=3 * forwards,
                        clap_frontend=forwards)
            check_counts(f"{what}: add_reference + first evaluate, {forwards} forward batches",
                         read_counts(), want)
            log(f"  {what}: result {result}; d(x, x') {am.apa_d_x_xp:.6g}; sets "
                f"{len(am.mix_reference)} aligned, {len(am.mix_anti_reference)} misaligned, "
                f"{len(am.stem_reference)} stems")
            if not (all(np.isfinite(v) for v in result.values()) and 0.0 <= result["apa"] <= 1.0):
                raise AssertionError("APA outside [0, 1] or a non-finite metric (host-fed)")
            log(f"  {what}: evaluate of {n} pairs {warm_evaluates(am, candidate, n, unit='pairs')} "
                f"[{card}; real_weights: false]; timings (s) "
                f"{ {k: round(v, 4) for k, v in am.timings.items()} }")
            self_apa = am.evaluate(reference)["apa"]
        log(f"  {what}: APA of the reference songs against themselves {self_apa:.8g} (tol "
            f"|1 - apa| <= {APA_SELF_TOL})")
        if not abs(1.0 - self_apa) <= APA_SELF_TOL:
            raise AssertionError("APA(reference, reference) is not ~1 on the host-fed path")


def phase_cli(card: str, params: dict) -> None:
    """(c) The command line, in-process ``main([...])`` on the card: WAV
    directories written by the port's ``wavio``, N_WAV + N_WAV mono 5 s
    files at 48 kHz (the reference in float32, the candidate in int16);
    ``evaluate`` with ``--embedder laion_clap_music_l-2`` (the default
    embedder's checkpoint and f32 forward at its pre-ReLU tap, for the
    reason (a) gives) built from phase 10's checkpoint (``AM_TPU_CKPT_DIR``
    set around this phase only), ``--metrics fad kd prdc fad_inf`` over
    WAV_WIN_S windows
    (d + 2 < 640 windows, so that FAD-inf runs), ``--save-state``: finite
    JSON; ``--load-state`` alone: FAD equal to rtol 1e-6; ``convert`` of the
    checkpoint: the arrays of ``convert.convert_checkpoint``, bitwise."""
    import contextlib
    import io

    from audio_metrics_tpu_torch.__main__ import main as cli_main
    from audio_metrics_tpu_torch.convert import convert_checkpoint
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.utils.wavio import write_wav

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        if rc != 0:
            raise AssertionError(f"the command line exited {rc}: {argv}")
        return out.getvalue()

    gen = np.random.default_rng(35)
    with tempfile.TemporaryDirectory() as tmp:
        for name, dtype, loud in (("ref", "float32", 0.2), ("cand", "int16", 0.3)):
            os.makedirs(os.path.join(tmp, name))
            for i in range(N_WAV):
                write_wav(os.path.join(tmp, name, f"{i:03d}.wav"),
                          np.clip(loud * gen.standard_normal(CLIP_S * SR), -1, 1), SR,
                          dtype=dtype)
        ckpt_name = write_clap_checkpoint(params, tmp)
        state = os.path.join(tmp, "ref_state.npz")
        common = ["--metrics", "fad", "kd", "prdc", "fad_inf", "--win-dur", str(WAV_WIN_S),
                  "--batch-size", str(BATCH), "--embedder", "laion_clap_music_l-2"]
        with environ(AM_TPU_CKPT_DIR=tmp):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = json.loads(run(["evaluate", "--reference", os.path.join(tmp, "ref"),
                                    "--candidate", os.path.join(tmp, "cand"), "--save-state",
                                    state] + common))
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            second = json.loads(run(["evaluate", "--load-state", state, "--candidate",
                                     os.path.join(tmp, "cand")] + common))
        log(f"  evaluate of {N_WAV} + {N_WAV} WAV files (float32, int16), {WAV_WIN_S} s windows, "
            f"laion_clap_music_l-2 f32 from {ckpt_name}: {first} ({t_first:.2f} s with the "
            f"embedder's build and the files' reading) [{card}]")
        if list(first) != ["fad", "kernel_distance_mean", "kernel_distance_std", "precision",
                           "recall", "density", "coverage", "fad_inf", "fad_inf_slope"] or \
                not all(np.isfinite(v) for v in first.values()):
            raise AssertionError("the command line's metrics are not the finite keys asked for")
        rel = abs(second["fad"] - first["fad"]) / abs(first["fad"])
        log(f"  --load-state then evaluate: fad {second['fad']:.10g} against {first['fad']:.10g}"
            f", rel {rel:.3g} (tol 1e-6)")
        if not rel <= 1e-6:
            raise AssertionError("FAD from the state file differs")
        out = os.path.join(tmp, "clap.npz")
        run(["convert", os.path.join(tmp, ckpt_name), out])
        want = convert_checkpoint(torch.load(os.path.join(tmp, ckpt_name), map_location="cpu",
                                             weights_only=True)["state_dict"],
                                  cfg=HTSAT_BASE, strict=True)
        with np.load(out) as got:
            same = sorted(got.files) == sorted(want) and all(
                np.array_equal(got[k], want[k]) for k in want)
            log(f"  convert: {len(got.files)} arrays, equal to convert_checkpoint's: {same}")
        if not same:
            raise AssertionError("convert wrote other arrays than convert_checkpoint")


def mesh_metrics(what: str, got: dict, want: dict, am, one) -> None:
    """A mesh's evaluate against one device's on the same clips: stored
    reference embeddings and k-NN radii bitwise equal, KD within
    KD_MESH_TOL, the PRDC values equal, FAD within E2E_TOL (the host
    float64 tail of several moment triples against the device tail)."""
    same_e = torch.equal(am.stem_reference.embeddings, one.stem_reference.embeddings)
    key = next(iter(one.stem_reference.radii))
    same_r = torch.equal(am.stem_reference.radii[key], one.stem_reference.radii[key])
    log(f"  {what}: {got}")
    log(f"  stored reference embeddings {'bitwise equal' if same_e else 'DIFFER'}, "
        f"{key} {'bitwise equal' if same_r else 'DIFFER'}")
    bad = [] if same_e and same_r else ["embeddings or radii"]
    for k, w in want.items():
        rel = abs(got[k] - w) / max(abs(w), 1e-300)
        tol = (KD_MESH_TOL if k.startswith("kernel_distance") else
               E2E_TOL["fad"] if k == "fad" else 0.0)
        ok = rel <= tol
        log(f"    {k}: mesh {got[k]!r} one device {w!r} rel {rel:.3g} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(k)
    if bad:
        raise AssertionError(f"{what} disagrees with one device: {bad}")


def trace_evaluate(am, candidate) -> str:
    """One warm evaluate under ``torch.profiler``: its wall time, the
    kernels' device time summed and as the union of their intervals (the
    card's busy time: kernels of several streams overlap), the idle share
    1 - busy / wall, as a printable string."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        am.evaluate(candidate)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0]
    total = sum(ev.device_time_total for ev in events) / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy /= 1e3
    return (f"wall {wall:.1f} ms, {len(events)} kernels, device time {total:.1f} ms summed, "
            f"{busy:.1f} ms busy (their union), idle share {1 - busy / wall:.3f}")


def mesh_expected(forwards: int, knn: int, stats: int, **per_forward) -> dict:
    want = expected(forwards, knn_radii=knn, **per_forward)
    want["prdc_stats"] = stats
    return want


def phase_mesh(card: str, params: dict) -> None:
    """Phase 17, one AudioMetrics spread over a mesh (``parallel.mesh``):
    (a) phase 4's main path (HTSAT-base bf16, N_CLIPS + N_CLIPS 5 s clips,
    fad + kd + prdc, batch 64) over N_SHARDS shards on card 0 (each a
    stream and a host thread of its own; ``am.mesh`` set after
    construction, as no constructor argument names a card twice) against
    the same clips on one device: launch counts, ``mesh_metrics``, warm
    clips/s of both (median of 3, spread), the host stage times of the
    last warm evaluate (pipeline, fad, kd_dispatch, prdc_dispatch) and one
    traced evaluate of each (``trace_evaluate``: the card's busy and idle
    time); #4's query-row
    range: blocks of KNN_BLOCK rows concatenated bitwise equal to the whole set's radii (the
    stored embeddings and Gaussian rows), a block against its plain
    version, the block's and the whole set's times.  (b) The same four
    shards as (dcn, data) = (2, 2): ``mesh_metrics`` against one device;
    ``replicate`` on card 0: a new object, no storage shared, embeddings
    of 64 clips bitwise equal.  (c) N_SHARDS_SMALL shards: the APA pair
    path (``embedding_pipeline``, ``L0``, N_PAIRS_MESH 5 s pairs, seed 7)
    against one device, every category's embeddings bitwise, moments, d(x,
    x'); the host-fed path (lists of songs, N_WIN_MESH windows a set,
    batch 64, cut into two slices of 32) against one device at batch 32:
    embeddings bitwise, FAD and KD under E2E_TOL, PRDC equal.  (d) With two
    cards or more, (a) over every card (``device_indices`` naming them
    all); else one line saying why not.  (e) ``examples.basic_usage`` (laion_clap_music
    f32 from a checkpoint of ``params`` under ``AM_TPU_CKPT_DIR``) and
    ``examples.streaming_eval`` (the dummy) at small sizes."""
    import contextlib
    import io

    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.examples import basic_usage, streaming_eval
    from audio_metrics_tpu_torch.models.base import _held_tensors
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.distance import knn_radii, knn_radii_plain
    from audio_metrics_tpu_torch.ops.mix import MIX_FUNCTIONS
    from audio_metrics_tpu_torch.metrics.apa import apa_compute_d_x_xp
    from audio_metrics_tpu_torch.parallel.mesh import make_mesh
    from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory, embedding_pipeline
    from audio_metrics_tpu_torch.testing import seeded_pairs, seeded_songs

    t17 = time.perf_counter()
    card0 = torch.device("cuda", 0)
    metrics = ["fad", "kd", "prdc"]
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    torch.cuda.empty_cache()
    reference, candidate = clips(N_CLIPS, CLIP_S, seed=3)
    forwards = 2 * -(-N_CLIPS // BATCH)

    def build(mesh=None, device_indices=(0,), batch=BATCH):
        am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S), input_sr=SR,
                          batch_size=batch, device="cuda",
                          device_indices=None if device_indices is None else
                          list(device_indices))
        if mesh is not None:
            am.mesh = mesh
        return am

    one = build()
    one.add_reference(reference)
    want = one.evaluate(candidate)

    log(f"  (a) the main path over {N_SHARDS} shards on card 0")
    am = build(make_mesh(devices=[card0] * N_SHARDS))
    set_counts_to_zero()
    am.add_reference(reference)
    got = am.evaluate(candidate)
    check_counts(f"add_reference + first evaluate over {am.mesh}", read_counts(),
                 mesh_expected(forwards, 2 * N_SHARDS, N_SHARDS, swin_block=18, patch_merge=3,
                               clap_frontend=1))
    mesh_metrics(f"{N_SHARDS} shards on card 0", got, want, am, one)
    log(f"  {N_SHARDS} shards on card 0: {warm_evaluates(am, candidate, N_CLIPS)} [{card}]")
    log(f"  one device:    {warm_evaluates(one, candidate, N_CLIPS)} [{card}]")
    for what, a in ((f"{N_SHARDS} shards on card 0", am), ("one device", one)):
        log(f"  host stage times of the last warm evaluate, {what}: " + ", ".join(
            f"{k} {a.timings.get(k, float('nan')) * 1e3:.3f} ms"
            for k in ("pipeline", "fad", "kd_dispatch", "prdc_dispatch")) + f" [{card}]")
    log(f"  traced evaluate, {N_SHARDS} shards on card 0: {trace_evaluate(am, candidate)}")
    log(f"  traced evaluate, one device:    {trace_evaluate(one, candidate)}")

    # #4's query-row range, on the stored embeddings and on Gaussian rows
    gen = torch.Generator(device="cuda").manual_seed(17)
    k = 10
    for what, x in (("stored embeddings", one.stem_reference.embeddings),
                    ("Gaussian rows", torch.randn((N_CLIPS, 512), generator=gen,
                                                  device="cuda"))):
        whole = knn_radii(x, k)
        parts = torch.cat([knn_radii(x, k, r, KNN_BLOCK) for r in range(0, len(x), KNN_BLOCK)])
        same = torch.equal(parts, whole)
        log(f"  knn_radii of {what}, query-row blocks of {KNN_BLOCK} against the whole set: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("#4's query-row blocks disagree with the whole set")
        check_radii(f"({KNN_BLOCK} of {len(x)}, 512) rows 512.. of {what}, k={k + 1}",
                    knn_radii(x, k, 512, KNN_BLOCK), knn_radii_plain(x, k, 512, KNN_BLOCK))
    n, d = x.shape
    t_whole = cuda_ms(lambda: knn_radii(x, k), TIMING_ITERS["knn_radii"], warmup=10)
    t_block = cuda_ms(lambda: knn_radii(x, k, 0, KNN_BLOCK), TIMING_ITERS["knn_radii"],
                      warmup=10)
    t_plain = cuda_ms(lambda: knn_radii_plain(x, k, 0, KNN_BLOCK), 20, warmup=3)
    b_whole = bound({"f32": 2 * n * n * d}, n * d * 4 + n * 4 * 2)
    b_block = bound({"f32": 2 * KNN_BLOCK * n * d}, n * d * 4 + n * 4 + KNN_BLOCK * 4)
    log(f"  knn_radii at ({n}, {n}) x {d}: whole set {t_whole:.4f} ms (bound "
        f"{b_whole[0]:.4f}); query rows [0, {KNN_BLOCK}) {t_block:.4f} ms (bound "
        f"{b_block[0]:.4f}, {b_block[1]}; plain {t_plain:.4f} ms) [{card}]")

    log("  (b) the same shards as (dcn, data) = (2, 2); replicate on card 0")
    dcn = build(make_mesh(devices=[card0] * N_SHARDS, dcn_slices=2))
    dcn.add_reference(reference)
    mesh_metrics(f"{dcn.mesh}", dcn.evaluate(candidate), want, dcn, one)
    twin = clap.replicate(card0)
    shared = {t.data_ptr() for t in _held_tensors(clap)} & {
        t.data_ptr() for t in _held_tensors(twin)}
    x = reference[:BATCH]
    same = torch.equal(twin.embed(x), clap.embed(x))
    log(f"  replicate(cuda:0): a new object {twin is not clap}, {len(_held_tensors(twin))} "
        f"tensors, {len(shared)} shared with the original; embeddings of {BATCH} clips "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if twin is clap or shared or not same:
        raise AssertionError("replicate did not copy every held tensor, or its embeddings differ")
    del twin, dcn

    log(f"  (c) the APA pair path and the host-fed path over {N_SHARDS_SMALL} shards")
    mesh2 = make_mesh(devices=[card0] * N_SHARDS_SMALL)
    pairs = seeded_pairs(N_PAIRS_MESH, CLIP_S * SR, SR, seed=11, misaligned=N_PAIRS_MESH // 4)
    kw = dict(mix_function=MIX_FUNCTIONS["L0"], apa_mode="reference", stems_mode=True,
              store_mix_embeddings=True, store_stem_embeddings=True, batch_size=BATCH,
              win_dur=float(CLIP_S), seed=7)
    set_counts_to_zero()
    two = embedding_pipeline(pairs, clap, mesh=mesh2, **kw)
    per = 3 * N_PAIRS_MESH // BATCH
    check_counts("APA reference pairs over 2 shards", read_counts(),
                 mesh_expected(per, 0, 0, swin_block=18, patch_merge=3, clap_frontend=1))
    single = embedding_pipeline(pairs, clap, **kw)
    for c in (ItemCategory.aligned, ItemCategory.misaligned, ItemCategory.stem):
        same = torch.equal(two[c].embeddings, single[c].embeddings)
        (m2, c2, n2), (m1, c1, n1) = two[c].stats(), single[c].stats()
        rel = max(np.abs(m2 - m1).max() / np.abs(m1).max(), np.abs(c2 - c1).max() /
                  np.abs(c1).max())
        log(f"    {c.name}: {n2} windows, embeddings {'bitwise equal' if same else 'DIFFER'}, "
            f"moments rel {rel:.3g} (tol {E2E_TOL['fad']})")
        if not (same and n2 == n1 and rel <= E2E_TOL["fad"]):
            raise AssertionError(f"the {c.name} set over 2 shards disagrees with one device")
    d2 = apa_compute_d_x_xp(two[ItemCategory.aligned], two[ItemCategory.misaligned])
    d1 = apa_compute_d_x_xp(single[ItemCategory.aligned], single[ItemCategory.misaligned])
    log(f"    d(x, x') 2 shards {d2!r}, one device {d1!r}, rel {abs(d2 - d1) / d1:.3g}")
    if not abs(d2 - d1) <= E2E_TOL["fad"] * abs(d1):
        raise AssertionError("d(x, x') over 2 shards disagrees with one device")
    del two, single, pairs

    win = CLIP_S * SR
    songs_ref = seeded_songs(N_WIN_MESH, win, SR, seed=41)
    songs_cand = seeded_songs(N_WIN_MESH, win, SR, seed=42, candidate=True)
    hf = build(mesh2)
    set_counts_to_zero()
    hf.add_reference(songs_ref)
    got_hf = hf.evaluate(songs_cand)
    check_counts("host-fed over 2 shards", read_counts(),
                 mesh_expected(2 * N_WIN_MESH // (BATCH // N_SHARDS_SMALL), 2 * N_SHARDS_SMALL,
                               N_SHARDS_SMALL, swin_block=18, patch_merge=3, clap_frontend=1))
    hf1 = build(batch=BATCH // N_SHARDS_SMALL)
    hf1.add_reference(songs_ref)
    want_hf = hf1.evaluate(songs_cand)
    same = torch.equal(hf.stem_reference.embeddings, hf1.stem_reference.embeddings)
    log(f"    host-fed: {got_hf}; one device at batch {BATCH // N_SHARDS_SMALL}: {want_hf}; "
        f"stored embeddings {'bitwise equal' if same else 'DIFFER'}")
    bad = [] if same else ["embeddings"]
    for key, v in want_hf.items():
        tol = E2E_TOL.get(key, 0.0)
        rel = abs(got_hf[key] - v) / max(abs(v), 1e-300)
        log(f"    {key}: rel {rel:.3g} (tol {tol}) {'ok' if rel <= tol else 'FAIL'}")
        if not rel <= tol:
            bad.append(key)
    if bad:
        raise AssertionError(f"the host-fed path over 2 shards disagrees with one device: {bad}")
    del hf, hf1

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        log(f"  (d) the main path over every card ({n_cards})")
        every = build(device_indices=range(n_cards))
        set_counts_to_zero()
        every.add_reference(reference)
        got = every.evaluate(candidate)
        check_counts(f"over {every.mesh}", read_counts(),
                     mesh_expected(forwards, 2 * n_cards, n_cards, swin_block=18,
                                   patch_merge=3, clap_frontend=1))
        mesh_metrics(f"{n_cards} cards", got, want, every, one)
        log(f"  {n_cards} cards: {warm_evaluates(every, candidate, N_CLIPS)} [{card}]")
        del every
    else:
        log(f"  (d) not run: it spreads the main path over every card, and this host has "
            f"{n_cards}")
    del am, one, reference, candidate

    log("  (e) the examples basic_usage and streaming_eval")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_clap_checkpoint(params, ckpt_dir)
        for name, main_fn, argv, env in (
                ("basic_usage", basic_usage.main, ["--n-items", "4", "--device", "cuda"],
                 {"AM_TPU_CKPT_DIR": ckpt_dir}),
                ("streaming_eval", streaming_eval.main,
                 ["--n-clips", "512", "--batch-size", "64", "--devices",
                  f"0-{torch.cuda.device_count() - 1}", "--metrics", "fad,kd",
                  "--device", "cuda"], {})):
            out = io.StringIO()
            t0 = time.perf_counter()
            with environ(**env), contextlib.redirect_stdout(out):
                rc = main_fn(argv)
            text = out.getvalue()
            numbers = [float(v) for v in re.findall(r"'[a-z_]+': (-?[0-9.e+-]+|nan|inf)", text)]
            ok = rc == 0 and numbers and all(np.isfinite(numbers))
            log(f"  {name} ({time.perf_counter() - t0:.1f} s): exit {rc}, {len(numbers)} "
                f"metric values, all finite {ok}")
            for line in text.splitlines()[-3:]:
                log(f"    {line}")
            if not ok:
                raise AssertionError(f"example {name} failed or printed a non-finite value")
    log(f"  phase 17: {time.perf_counter() - t17:.1f} s [{card}]")


class ClapForward:
    """A user's embedder written to the reference's protocol: ``sr`` and
    ``forward(data)`` only, a wrapper of ``LaionCLAP.forward``."""

    def __init__(self, clap):
        self.clap, self.sr = clap, clap.sr

    def forward(self, data):
        return self.clap.forward(data)


def timed_s(fn):
    """``(fn(), its seconds)``, the card's queue drained before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_surface(card: str, e2e: dict) -> None:
    """The public surface beyond ``AudioMetrics``' own embedders: (a) a
    forward-only wrapper of ``LaionCLAP.forward`` (HTSAT-base bf16, phase
    4's weights) through ``AudioMetrics(["fad", "kd", "prdc"])`` on phase
    4's clips: launches as phase 4's, stored embeddings bitwise phase 4's,
    warm clips/s beside phase 4's; ``forward`` on 12 s clips bitwise
    ``embed`` of the host crops its generator draws; (b) the metric
    functions on 2048 x 512 features (phase 3's sets, candidate 0.05 +
    1.02 N(0, I)) on the card: ``nearest_neighbour_distances`` (#4) and
    ``pairwise_distance_stats`` (#5), one launch a call, against their
    plain versions on the CPU under RADII_TOL / REF_MIN_TOL and the
    near-tie rule, ``kid_features_to_metric`` equal to ``kernel_distance``,
    ``frechet_distance(method="newton_schulz")`` within 1e-4 of
    ``"eigh"``; (c) numpy batches accumulated by ``AudioMetricsData`` on
    the card, two accumulators added, mean and covariance against numpy
    float64."""
    import copy

    from audio_metrics_tpu_torch import AudioMetrics, AudioMetricsData
    from audio_metrics_tpu_torch.metrics import (
        frechet_distance,
        kernel_distance,
        kid_features_to_metric,
        nearest_neighbour_distances,
    )
    from audio_metrics_tpu_torch.metrics.prdc import pairwise_distance_stats
    from audio_metrics_tpu_torch.models.base import ForwardEmbedder
    from audio_metrics_tpu_torch.models.clap import MAX_SAMPLES, LaionCLAP, rand_trunc
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.distance import knn_radii_plain, pairwise_stats_plain
    from audio_metrics_tpu_torch.testing import stats_mismatches

    t18 = time.perf_counter()
    log("  (a) a forward-only wrapper of LaionCLAP.forward through AudioMetrics")
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=ClapForward(clap),
                      win_dur=float(CLIP_S), input_sr=SR, batch_size=BATCH, device="cuda")
    if not isinstance(am.embedder, ForwardEmbedder):
        raise AssertionError("AudioMetrics did not wrap the forward-only object")
    reference, candidate = clips(N_CLIPS, CLIP_S, seed=3)
    set_counts_to_zero()
    am.add_reference(reference)
    result, cold = timed_s(lambda: am.evaluate(candidate))
    forwards = 2 * -(-N_CLIPS // BATCH)
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", read_counts(),
                 expected(forwards, swin_block=18, patch_merge=3, clap_frontend=1))
    same = torch.equal(am.stem_reference.embeddings, e2e["embeddings"])
    log(f"  result {result} ({'equal to' if result == e2e['result'] else 'NOT equal to'} "
        f"phase 4's); stored reference embeddings {'bitwise equal to' if same else 'DIFFER from'}"
        f" phase 4's")
    if not same:
        raise AssertionError("the forward-only wrapper's embeddings differ from phase 4's")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    _, warm = timed_s(lambda: am.evaluate(candidate))
    log(f"  evaluate of {N_CLIPS} clips through the wrapper: {N_CLIPS / warm:.2f} clips/s warm "
        f"({warm:.4f} s), {N_CLIPS / cold:.2f} clips/s first; phase 4 (LaionCLAP itself) "
        f"{e2e['clips_s']:.2f} clips/s warm [{card}; real_weights: false]")
    del reference, candidate, am

    gen = torch.Generator(device="cuda").manual_seed(18)
    long = 0.2 * torch.randn((8, 12 * SR), generator=gen, device="cuda")
    rng = copy.deepcopy(clap._rng)
    got = clap.forward({"audio": long})["embedding"]
    crops = rand_trunc(long.cpu().numpy(), MAX_SAMPLES, rng)
    want = clap.embed(torch.from_numpy(crops).cuda())
    same = torch.equal(got, want)
    log(f"  LaionCLAP.forward on 8 clips of 12 s: {tuple(got.shape)}, "
        f"{'bitwise equal to' if same else 'DIFFERS from'} embed on the host crops of its "
        "generator")
    if not (same and got.shape == (8, 512) and bool(torch.isfinite(got).all())):
        raise AssertionError("LaionCLAP.forward on 12 s clips is not embed of its crops")
    del clap, long

    log("  (b) the metric functions on (2048, 2048) x 512 features")
    k, d, n = 10, 512, N_CLIPS
    gen = torch.Generator(device="cuda").manual_seed(4)
    ref = torch.randn((n, d), generator=gen, device="cuda")
    cand = 0.05 + 1.02 * torch.randn((n, d), generator=gen, device="cuda")
    ref_np = ref.cpu().numpy()
    set_counts_to_zero()
    rr, rr_s = timed_s(lambda: nearest_neighbour_distances(ref_np, k))  # numpy: to the card
    counts = [read_counts()["knn_radii"]]
    cr = nearest_neighbour_distances(cand, k)
    counts.append(read_counts()["knn_radii"])
    stats, st_s = timed_s(lambda: pairwise_distance_stats(ref, cand, rr, cr, k))
    counts.append(read_counts()["prdc_stats"])
    log(f"  launches: #4 {counts[0]} then {counts[1]} after nearest_neighbour_distances on "
        f"numpy then on a tensor, #5 {counts[2]} after pairwise_distance_stats (expected 1, 2, "
        f"1); {rr_s * 1e3:.3f} ms (numpy upload included) and {st_s * 1e3:.3f} ms [{card}]")
    if counts != [1, 2, 1] or rr.device.type != "cuda":
        raise AssertionError("the functional PRDC calls did not launch #4 / #5 once each")
    ref_c, cand_c = ref.cpu(), cand.cpu()
    rr_p, cr_p = knn_radii_plain(ref_c, k), knn_radii_plain(cand_c, k)
    for what, got, want in (("reference", rr, rr_p), ("candidate", cr, cr_p)):
        check_radii(f"nearest_neighbour_distances of the {what} against the plain version "
                    "on the CPU", got.cpu(), want)
    stats_p = pairwise_stats_plain(ref_c, cand_c, rr_p, cr_p)
    stats_c = tuple(t.cpu() for t in stats)
    n_diff, n_bad = stats_mismatches(ref_c, cand_c, stats_c, stats_p, (rr.cpu(), cr.cpu()),
                                     (rr_p, cr_p), rel=NEAR_TIE)
    mn_err = (stats_c[3] - stats_p[3]).abs()
    mn_out = int((mn_err > REF_MIN_TOL[1] + REF_MIN_TOL[0] * stats_p[3].abs()).sum())
    log(f"  pairwise_distance_stats against the plain version on the CPU: {n_diff} differing "
        f"elements, {n_diff - n_bad} near-ties, {n_bad} not; ref_min outside rtol "
        f"{REF_MIN_TOL[0]} atol {REF_MIN_TOL[1]}: {mn_out} "
        f"{'ok' if not (n_bad or mn_out) else 'FAIL'}; PRDC {prdc_values(stats, rr, k)}")
    if n_bad or mn_out:
        raise AssertionError("pairwise_distance_stats disagrees with its plain version")

    x, y = AudioMetricsData(), AudioMetricsData()
    x.add(cand)
    y.add(ref)
    kd_fn, kd_fn_s = timed_s(lambda: kid_features_to_metric(cand, ref))
    kd_amd = kernel_distance(x, y)
    _, kd_warm_s = timed_s(lambda: kid_features_to_metric(cand, ref))
    log(f"  kid_features_to_metric {kd_fn} ({kd_fn_s * 1e3:.2f} ms first, "
        f"{kd_warm_s * 1e3:.2f} ms warm) {'==' if kd_fn == kd_amd else '!='} kernel_distance "
        f"{kd_amd} [{card}]")
    if kd_fn != kd_amd:
        raise AssertionError("kid_features_to_metric differs from kernel_distance")
    fad_eigh, eigh_s = timed_s(lambda: frechet_distance(x, y))
    fad_ns, ns_s = timed_s(lambda: frechet_distance(x, y, method="newton_schulz"))
    again, ns_warm_s = timed_s(lambda: frechet_distance(x, y, method="newton_schulz"))
    rel = abs(fad_ns - fad_eigh) / abs(fad_eigh)
    log(f"  frechet_distance newton_schulz {fad_ns!r} ({ns_s * 1e3:.2f} ms first, "
        f"{ns_warm_s * 1e3:.2f} ms warm, on the card; repeat {again!r}) vs eigh {fad_eigh!r} "
        f"({eigh_s * 1e3:.2f} ms, host float64): rel {rel:.3g} (tol 1e-4) [{card}]")
    if not rel <= 1e-4:
        raise AssertionError("the newton_schulz FAD is not within 1e-4 of eigh")
    del ref, cand, x, y

    log("  (c) AudioMetricsData on numpy batches, on the card")
    rng = np.random.default_rng(18)
    batches = [rng.standard_normal((512, d)).astype(np.float32) * (1 + i) for i in range(8)]
    a, b = AudioMetricsData(), AudioMetricsData()
    for i, rows in enumerate(batches):
        (a if i < 4 else b).add(rows)
    c = a + b
    rows = np.concatenate(batches).astype(np.float64)
    mean_err = np.abs(c.mean - rows.mean(0)).max() / np.abs(rows.mean(0)).max()
    cov_want = np.cov(rows, rowvar=False)
    cov_err = np.abs(c.cov - cov_want).max() / np.abs(cov_want).max()
    on_card = c.embeddings.device.type == "cuda"
    rows_same = np.array_equal(c.embeddings.cpu().numpy(), np.concatenate(batches))
    log(f"  a + b of 8 numpy batches of (512, {d}): n {c.n}, mean rel {mean_err:.3g}, cov rel "
        f"{cov_err:.3g} against numpy float64 (tol 1e-12); rows on {c.embeddings.device}, "
        f"{'bitwise the batches' if rows_same else 'NOT the batches'}; a.n {a.n}, b.n {b.n}")
    if not (c.n == 4096 and a.n == b.n == 2048 and mean_err <= 1e-12 and cov_err <= 1e-12
            and on_card and rows_same):
        raise AssertionError("AudioMetricsData on numpy batches disagrees with numpy")
    back = AudioMetricsData.deserialize(c.serialize())
    if back.embeddings.device.type != "cuda" or back.n != c.n:
        raise AssertionError("deserialize did not restore the rows on the card")
    log(f"  phase 18: {time.perf_counter() - t18:.1f} s [{card}]")


# phase 19: HTSAT-tiny, LAION-CLAP's general-audio (630k) checkpoints' audio
# tower, written under the file name of 630k-audioset-best.pt
TINY_CKPT = "630k-audioset-best.pt"
# the window attention alone (am_window_attn, am_window_attn_f32) against its
# plain version (ops.attention._window_context) on the same rows: (mean abs
# error / mean |ctx|, max abs error), ~5x the 32-wide heads' readings, the
# kernel of every earlier phase (bf16 <= 3.6e-7 and 0.0078, one bf16 ulp;
# f32 <= 4.1e-7 and 3.8e-6; PERF.md)
WINDOW_ATTN_TOL = {"bf16": (2e-6, 0.03125), "f32": (2e-6, 2e-5)}


def window_attn_alone(card: str) -> dict:
    """The window attention alone (launch 3 of #1 and of the attention
    halves) through the library's ``am_window_attn`` (bf16) and
    ``am_window_attn_f32`` entries, which no model path calls, at every
    stage's shapes at B = BATCH: HTSAT-tiny's 24-wide heads and, the bound's
    yardstick, HTSAT-base's 32-wide; unshifted (one table) and shifted (a
    table per window of an image); q pre-scaled by 1/sqrt(d).  Each against
    ``ops.attention._window_context`` under WINDOW_ATTN_TOL; ms per forward
    (CUDA events).  Returns {(dtype, head width): ms per forward}."""
    import ctypes

    from audio_metrics_tpu_torch import kernels
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, HTSAT_TINY
    from audio_metrics_tpu_torch.ops.attention import _window_context

    lib = kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(19)
    per_forward = {}
    for dtype, key, entry in ((torch.bfloat16, "bf16", lib.am_window_attn),
                              (torch.float32, "f32", lib.am_window_attn_f32)):
        for cfg in (HTSAT_TINY, HTSAT_BASE):
            res, total = cfg.grid_size, 0.0
            for stage, depth in enumerate(cfg.depths):
                c, heads = cfg.embed_dim * 2**stage, cfg.num_heads[stage]
                d, per_image = c // heads, (res // cfg.window_size) ** 2
                windows = BATCH * per_image
                qkv = torch.randn((windows * 64, 3 * c), generator=gen, device="cuda")
                qkv[:, :c] *= d**-0.5
                qkv = qkv.to(dtype)
                ctx = torch.empty((windows * 64, c), dtype=dtype, device="cuda")
                shifted = depth // 2 if res > cfg.window_size else 0
                for nbm, blocks in ((1, depth - shifted), (per_image, shifted)):
                    if not blocks:
                        continue
                    bm = torch.randn((nbm, heads, 64, 64), generator=gen, device="cuda")

                    def launch():
                        stream = torch.cuda.current_stream().cuda_stream
                        rc = entry(ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(bm.data_ptr()),
                                   ctypes.c_int(nbm), ctypes.c_int(windows), ctypes.c_int(heads),
                                   ctypes.c_int(c), ctypes.c_void_p(ctx.data_ptr()),
                                   ctypes.c_void_p(stream))
                        if rc:
                            raise RuntimeError(f"window attention failed with cudaError {rc}")

                    launch()
                    want = _window_context(qkv, bm, heads)
                    torch.cuda.synchronize()
                    err = (ctx.float() - want.float()).abs()
                    mx, rel = err.max().item(), err.mean().item() / want.float().abs().mean().item()
                    ms = cuda_ms(launch, 20)
                    total += blocks * ms
                    tol = WINDOW_ATTN_TOL[key]
                    ok = torch.isfinite(ctx.float()).all().item() and rel <= tol[0] and mx <= tol[1]
                    log(f"  window attention {key} heads {heads} x {d} stage {stage} R={res} "
                        f"tables {nbm}: max_abs_err {mx:.4g} (tol {tol[1]}) mean_abs_err / mean "
                        f"|ctx| {rel:.4g} (tol {tol[0]}) {'ok' if ok else 'FAIL'}; {ms:.4f} ms "
                        f"x{blocks} a forward")
                    if not ok:
                        raise AssertionError(f"window attention {key} at head width {d} "
                                             "disagrees with its plain version")
                res //= 2
            per_forward[(key, d)] = total
            log(f"  window attention {key}, {d}-wide heads, per forward ({sum(cfg.depths)} "
                f"blocks) at B={BATCH}: {total:.4f} ms [{card}]")
    return per_forward


def phase_tiny_kernels(card: str, cfg, params) -> dict:
    """Phase 19 (a): HTSAT-tiny's kernels against their plain versions at
    B = BATCH (the batch its path runs): #1 bf16 and f32 at every stage,
    shifted and unshifted (stage 3: one window, unshifted), under phase 3's
    per-stage bounds; #2 bf16 and f32 at the three merges; #3 at C = 96;
    each call one launch, repeated bitwise; kernel and plain ms per forward
    (CUDA events); the products alone through ``torch.matmul`` as the
    yardstick, the bounds from ``swin_bound`` / ``merge_bound`` /
    ``frontend_bound``.  Returns {kernel: its numbers}."""
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.models.clap import ClapFrontend
    from audio_metrics_tpu_torch.models.htsat import PatchMerge, SwinBlock
    from audio_metrics_tpu_torch.ops.frontend_fused import (
        clap_tokens_fused,
        clap_tokens_fused_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    times = {k: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0} for k in
             ("swin_block", "swin_block_f32", "patch_merge", "patch_merge_f32", "clap_frontend")}

    def check(name, key, kfn, pfn, n, x=None, stage=None):
        rel_tol, max_tol = TOL[name]
        if stage is not None:
            rel_tol = rel_tol[stage]
        before = KERNELS[name].launches
        got, want = kfn(), pfn()
        if KERNELS[name].launches != before + 1:
            raise AssertionError(f"{name} {key}: {KERNELS[name].launches - before} launches")
        mx, rel = compare(name, got, want, want if x is None else want.float() - x.float(), {})
        ok = mx <= max_tol and rel <= rel_tol
        log(f"  {name} {key} at B={BATCH}: max_abs_err {mx:.4g} (tol {max_tol}) mean_abs_err / "
            f"mean |{'out' if x is None else 'out - x'}| {rel:.4g} (tol {rel_tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {key} disagrees with its plain version")
        check_repeats(f"{name} {key}", ((BATCH, got, kfn),))
        ms = cuda_ms(kfn, TIMING_ITERS.get(name, 10), warmup=10 if name in TIMING_ITERS else 2)
        pms = cuda_ms(pfn, iters=3)
        log(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, x{n} a forward")
        t = times[name]
        t["ms"] += n * ms
        t["plain_ms"] += n * pms
        t["max_abs_err"] = max(t["max_abs_err"], mx)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2**stage
        x = randn((BATCH, res * res, c))
        for shift in ((0, cfg.window_size // 2) if res > cfg.window_size else (0,)):
            prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
            n_blocks = depth // 2 if res > cfg.window_size else depth
            key = f"stage {stage} R={res} C={c} heads {cfg.num_heads[stage]} x " \
                  f"{c // cfg.num_heads[stage]} shift={shift}"
            for name, dtype in (("swin_block", torch.bfloat16), ("swin_block_f32", torch.float32)):
                block = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage],
                                  dtype).to(dev)
                xd = x.to(dtype)
                check(name, key, lambda: block(xd), lambda: block(xd, plain=True), n_blocks,
                      x=xd, stage=stage)
                del block
        if stage < len(cfg.depths) - 1:
            key = f"merge {stage} R={res} C={c}"
            for name, dtype in (("patch_merge", torch.bfloat16),
                                ("patch_merge_f32", torch.float32)):
                merge = PatchMerge(params, f"audio_encoder.layers.{stage}.downsample", cfg, res,
                                   dtype).to(dev)
                xd = x.to(dtype)
                check(name, key, lambda: merge(xd), lambda: merge(xd, plain=True), 1)
            res //= 2
    fr = ClapFrontend(params, cfg).to(dev)
    audio = 0.2 * torch.randn((BATCH, CLIP_S * SR), generator=gen, device=dev)
    check("clap_frontend", f"C={cfg.embed_dim}, B x {CLIP_S * SR} samples",
          lambda: clap_tokens_fused(audio, fr, sr=SR, cfg=cfg),
          lambda: clap_tokens_fused_plain(audio, fr, sr=SR, cfg=cfg), 1)

    bounds = {"swin_block": swin_bound(cfg, BATCH), "swin_block_f32": swin_bound(cfg, BATCH,
                                                                                 dt="f32"),
              "patch_merge": merge_bound(cfg, BATCH), "patch_merge_f32": merge_bound(cfg, BATCH,
                                                                                      "f32"),
              "clap_frontend": frontend_bound(cfg, BATCH, CLIP_S * SR)}
    blocks = f"Swin blocks ({sum(cfg.depths)} x qkv, proj, fc1, fc2)"
    merges = "patch merges (3 x (M, 4C) @ (4C, 2C))"
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        alone, _ = products_alone_ms(cfg, BATCH, dtype)
        times["swin_block" + suffix]["library_ms"] = alone[blocks]
        times["patch_merge" + suffix]["library_ms"] = alone[merges]
        if dtype == torch.bfloat16:
            times["clap_frontend"]["library_ms"] = alone["frontend DFT"]
    for name, t in times.items():
        t["bound_ms"], t["bound_by"], ops = bounds[name]
        log(f"  {name} tiny per forward at B={BATCH}: kernel {t['ms']:.4f} ms "
            f"({ops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library {t['library_ms']:.4f} ms "
            f"[{card}]")
    return times


def phase_tiny(card: str) -> None:
    """Phase 19: HTSAT-tiny (embed 96, depths 2/2/6/2, heads 4/8/16/32 of
    24, the audio tower of LAION-CLAP's 630k checkpoints) on the card.
    (a) ``phase_tiny_kernels`` and ``window_attn_alone`` at tiny's B = 64
    shapes, with weights under which every part of a block moves its
    output (``check_params``); (b) those weights with seeded projection
    weights written as a LAION-named ``630k-audioset-best.pt`` in a
    temporary directory that ``AM_TPU_CKPT_DIR`` names, ``LaionCLAP(cfg=
    HTSAT_TINY, ckpt=<that file>)``: bf16 through phase 4's run (2048 +
    2048 clips; launches #1 768, #2 192, #3 64, #4 2, #5 1; embeddings
    against the plain versions under E2E_TOL), f32 through phase 10's (256
    + 256; #1 f32 96, #2 f32 24; against the f32 plain chain under
    F32_E2E_TOL); finite metrics, self-FAD, warm clips/s the median of 3."""
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_TINY

    t19 = time.perf_counter()
    cfg = HTSAT_TINY
    params = check_params(cfg)
    log("  (a) the kernels at HTSAT-tiny's shapes against their plain versions")
    times = phase_tiny_kernels(card, cfg, params)
    window_attn_alone(card)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_clap_checkpoint(params, ckpt_dir, cfg, TINY_CKPT)
        path = os.path.join(ckpt_dir, TINY_CKPT)
        with environ(AM_TPU_CKPT_DIR=ckpt_dir):
            clap16 = LaionCLAP(ckpt=path, cfg=cfg, compute_dtype="bfloat16", device="cuda")
            clap32 = LaionCLAP(ckpt=path, cfg=cfg, device="cuda")
    log(f"  (b) bf16: LaionCLAP(cfg=HTSAT_TINY, ckpt={TINY_CKPT}) in AudioMetrics(['fad', 'kd', "
        "'prdc'])")
    launches, _ = phase_e2e(card, clap16, dict(swin_block=12, patch_merge=3, clap_frontend=1),
                            warm_runs=3)
    del clap16
    log("  (b) f32: the same checkpoint, compute dtype f32")
    launches32, _ = phase_f32(card, params, {}, dict(swin_block_f32=12, patch_merge_f32=3),
                              clap=clap32, warm_runs=3)
    for name, t in times.items():
        n = (launches32 if name.endswith("_f32") else launches)[name]
        log(f"  {name} tiny: launches {n} (add_reference + first evaluate), kernel {t['ms']:.4f} "
            f"ms a forward, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}), library {t['library_ms']:.4f}, max abs err "
            f"{t['max_abs_err']:.4g} [{card}]")
    log(f"  phase 19: {time.perf_counter() - t19:.1f} s [{card}]")


# phase 20: the last narrow contracts, at HTSAT-tiny's widths and the
# log-mels at any mel count and hop
N_CLIPS_TINY_SPLIT = 256  # (b): 256 + 256 5 s clips a configuration
# (c): the log-mels' forms beyond CLAP's and VGGish's: (label, mel count,
# hop, kernels) on CLAP's 10 s frame geometry
MEL_FORMS = (("128 mels", 128, 480, ("log_mel", "log_mel_v1")),
             ("96 mels", 96, 480, ("log_mel", "log_mel_v1")),
             ("hop 484", 64, 484, ("log_mel", "log_mel_v1")))


def phase_tiny_split_kernels(card: str, cfg, params) -> dict:
    """Phase 20 (a): the split block's kernels and the opt-in ops at
    HTSAT-tiny's widths (C = 96·2^i, heads of 24), each in bf16 and f32
    against its plain version at B = BATCH under phase 3's per-stage bounds
    (#8 at every stage, shifted and unshifted, #9 at stages 0-2 (stage 3's
    4096 rows take the XLA MLP), #10 at stages 0-1, the stages of >= 16
    windows), each call one launch, repeated bitwise; then #11 and #12 on
    the Swin blocks' inputs of one real tiny forward of BATCH clips, as
    phase 9 does, under phase 9's bounds.  Per forward: kernel and plain ms
    (CUDA events) over the blocks the path runs, the bound, the library
    yardstick (qkv + proj or fc1 + fc2 through ``torch.matmul``; the int8
    MLP's two products through ``torch._int_mm`` on K-major codes).
    Returns {kernel: its numbers}."""
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
    from audio_metrics_tpu_torch.models.htsat import SwinBlock
    from audio_metrics_tpu_torch.ops.attention import (
        swin_attention_half_v1,
        swin_attention_half_v1_plain,
        swin_attention_half_v2,
        swin_attention_half_v2_plain,
        swin_attention_half_v3,
        swin_attention_half_v3_plain,
    )
    from audio_metrics_tpu_torch.ops.mlp import (
        mlp_block,
        mlp_block_int8,
        mlp_block_int8_plain,
        mlp_block_plain,
        mlp_int8_operands,
    )
    from audio_metrics_tpu_torch.utils.precision import full_f32

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    names = [n + s for n in ("swin_attn_v3", "swin_mlp", "swin_attn_v1", "swin_attn_v2",
                             "swin_mlp_int8") for s in ("", "_f32")]
    times = {k: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0} for k in names}

    def check(name, key, kfn, pfn, n, x, stage):
        rel_tol, max_tol = TOL[name][0][stage], TOL[name][1]
        before = KERNELS[name].launches
        got = kfn()
        if KERNELS[name].launches != before + 1:
            raise AssertionError(f"{name} {key}: {KERNELS[name].launches - before} launches")
        with full_f32():
            want = pfn()
        mx, rel = compare(name, got, want, want.float() - x.float(), {})
        ok = mx <= max_tol and rel <= rel_tol
        log(f"  {name} {key} at B={x.shape[0]}: max_abs_err {mx:.4g} (tol {max_tol}) "
            f"mean_abs_err / mean |out - x| {rel:.4g} (tol {rel_tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {key} disagrees with its plain version")
        check_repeats(f"{name} {key}", ((x.shape[0], got, kfn),))
        ms, pms = cuda_ms(kfn), cuda_ms(pfn, iters=3)
        log(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, x{n} a forward")
        t = times[name]
        t["ms"] += n * ms
        t["plain_ms"] += n * pms
        t["max_abs_err"] = max(t["max_abs_err"], mx)
        return got

    res, mlp_stages = cfg.grid_size, []
    for stage, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2**stage
        x = torch.randn((BATCH, res, res, c), generator=gen, device=dev)
        for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            xd = x.to(dtype)
            for shift in ((0, cfg.window_size // 2) if res > cfg.window_size else (0,)):
                prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
                n_blocks = depth // 2 if res > cfg.window_size else depth
                key = (f"stage {stage} R={res} C={c} heads {cfg.num_heads[stage]} x "
                       f"{c // cfg.num_heads[stage]} shift={shift}")
                blk = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage], dtype,
                                attention="v3").to(dev)
                geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
                attn, ops = (blk.wqkv, blk.bq3, blk.wp, blk.bp, blk.bm), blk.kernel_operands()
                check("swin_attn_v3" + sfx, key,
                      lambda: swin_attention_half_v3(xd, *attn, **geo, operands=ops),
                      lambda: swin_attention_half_v3_plain(xd, *attn, **geo), n_blocks, xd,
                      stage)
                if stage < 2:  # the stages AM_TPU_ATTN_V1 runs #10 at: >= 16 windows
                    v1 = SwinBlock(params, prefix, cfg, res, shift, cfg.num_heads[stage], dtype,
                                   attention="v1").to(dev)
                    a1 = (v1.ln1_w, v1.ln1_b, v1.wq, v1.bq, v1.wk, v1.wv, v1.wp, v1.bp, v1.bm)
                    ops1 = v1.kernel_operands()
                    check("swin_attn_v1" + sfx, key,
                          lambda: swin_attention_half_v1(xd, *a1, **geo, operands=ops1),
                          lambda: swin_attention_half_v1_plain(xd, *a1, **geo), n_blocks, xd,
                          stage)
            if blk.fused_mlp(BATCH):  # stage 3's 4096 rows take the XLA MLP
                if stage not in mlp_stages:
                    mlp_stages.append(stage)
                x3 = xd.view(BATCH, res * res, c)
                mlp = (blk.ln2_w, blk.ln2_b, blk.w1, blk.b1, blk.w2, blk.b2)
                check("swin_mlp" + sfx, f"stage {stage} rows B x {res * res} C={c}",
                      lambda: mlp_block(x3, *mlp, eps=blk.eps, operands=ops),
                      lambda: mlp_block_plain(x3, *mlp, eps=blk.eps), depth, x3, stage)
        if stage < len(cfg.depths) - 1:
            res //= 2

    # #11 and #12 on the blocks' inputs of one real forward, each dtype
    proj = init_projection_params(cfg, seed=0)
    audio, _ = clips(BATCH, CLIP_S, seed=3)
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        clap = LaionCLAP(params=dict(params, **proj), cfg=cfg,
                         compute_dtype=str(dtype).split(".")[-1], device="cuda")
        blocks = [(i, j, b) for i, st in enumerate(clap.model.encoder.blocks)
                  for j, b in enumerate(st)]
        inputs = []
        hooks = [b.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
                 for _, _, b in blocks]
        clap.embed(audio)
        for h in hooks:
            h.remove()
        for (i, j, blk), x in zip(blocks, inputs):
            a2, m8, ops2 = v2_weights(params, f"audio_encoder.layers.{i}.blocks.{j}", blk, dtype)
            geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
            x4 = x.view(BATCH, blk.resolution, blk.resolution, -1)
            key = f"block {i}.{j} R={blk.resolution} C={x4.shape[-1]}"
            a = check("swin_attn_v2" + sfx, key,
                      lambda: swin_attention_half_v2(x4, *a2, **geo, operands=ops2),
                      lambda: swin_attention_half_v2_plain(x4, *a2, **geo), 1, x4, i)
            a3, ops8 = a.view(BATCH, -1, a.shape[-1]), mlp_int8_operands(m8[2], m8[4])
            check("swin_mlp_int8" + sfx, key,
                  lambda: mlp_block_int8(a3, *m8, eps=blk.eps, operands=ops8),
                  lambda: mlp_block_int8_plain(a3, *m8, eps=blk.eps), 1, a3, i)
        del clap

    paths = {"swin_attn_v3": ("attn", range(len(cfg.depths))), "swin_mlp": ("mlp", mlp_stages),
             "swin_attn_v1": ("attn", (0, 1)), "swin_attn_v2": ("attn", range(len(cfg.depths)))}
    for dtype, sfx, dt in ((torch.bfloat16, "", "bf16"), (torch.float32, "_f32", "f32")):
        _, per_block = products_alone_ms(cfg, BATCH, dtype)
        for name, (part, stages) in paths.items():
            t = times[name + sfx]
            t["library_ms"] = sum(cfg.depths[s] * per_block[s][part] for s in stages)
            t["bound_ms"], t["bound_by"], t["ops"] = swin_bound(cfg, BATCH, part, tuple(stages),
                                                                dt)
        t = times["swin_mlp_int8" + sfx]
        t["bound_ms"], t["bound_by"], t["ops"] = int8_mlp_bound(cfg, BATCH, dt)
    # the int8 MLP's yardstick, used nowhere in the port: its two products
    # through torch._int_mm on random codes of each block's shapes, the
    # weights K-major as the kernel reads them
    yard, res = 0.0, cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, m = cfg.embed_dim * 2**stage, BATCH * res * res
        a, w1, h, w2 = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                      dtype=torch.int8)
                        for shape in ((m, c), (4 * c, c), (m, 4 * c), (c, 4 * c)))
        w1k, w2k = w1.t(), w2.t()
        yard += depth * cuda_ms(lambda: (torch._int_mm(a, w1k), torch._int_mm(h, w2k)))
        res //= 2
    for sfx in ("", "_f32"):
        times["swin_mlp_int8" + sfx]["library_ms"] = yard
    for name, t in times.items():
        log(f"  {name} tiny per forward at B={BATCH}: kernel {t['ms']:.4f} ms "
            f"({t['ops'] / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library {t['library_ms']:.4f} ms, "
            f"max abs err {t['max_abs_err']:.4g} [{card}]")
    return times


def phase_tiny_config(card: str, clap, per_forward: dict, tol_key: str | None, against,
                      whole_rate: float, reference, candidate):
    """Phase 20 (b) and 21 (b), one configuration: ``clap`` (built by the caller under
    its switches) in ``AudioMetrics(["fad", "kd", "prdc"])`` over
    ``reference`` + ``candidate``, batch BATCH: exact launches
    (``per_forward`` a forward), finite metrics, warm clips/s (median of 3),
    self-FAD, the reference embeddings against the plain path (bf16: the
    fused frontend's and the encoder's plain versions, E2E_TOL; f32: the f32
    plain chain, F32_E2E_TOL) and, under ``tol_key``, against ``against``
    (the whole-block configuration's on the same clips, CONFIG_TOL).
    ``whole_rate`` is that configuration's warm clips/s in this run: at
    256 + 256 clips the fixed cost of an evaluate weighs, so the rate
    against it, not the rate alone, is the reading.  Returns (launches,
    reference embeddings)."""
    from audio_metrics_tpu_torch import AudioMetrics

    metrics = ["fad", "kd", "prdc"]
    f32 = clap.model.compute_dtype == torch.float32
    n = reference.shape[0]

    def metrics_for(embedder):
        return AudioMetrics(metrics=metrics, embedder=embedder, win_dur=float(CLIP_S),
                            input_sr=SR, batch_size=BATCH, device="cuda")

    am = metrics_for(clap)
    torch.cuda.empty_cache()
    set_counts_to_zero()
    am.add_reference(reference)
    result = am.evaluate(candidate)
    launches = read_counts()
    log(f"  result {result}")
    check_counts(f"add_reference + first evaluate, {2 * -(-n // BATCH)} forward batches",
                 launches, expected(2 * -(-n // BATCH), **per_forward))
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    rate, line = warm_rate(am, candidate, n)
    log(f"  {line}, {rate / whole_rate:.4f}x the whole-block configuration's {whole_rate:.2f} "
        f"in this run [{card}; real_weights: false]")
    check_self_fad(am, reference)
    emb = am.stem_reference.embeddings
    amp = metrics_for(f32_plain_path(clap) if f32 else plain_path(clap))
    amp.add_reference(reference)
    embeddings_close("embeddings kernels vs plain path", emb, amp.stem_reference.embeddings,
                     F32_E2E_TOL if f32 else (E2E_TOL["1-cos"], E2E_TOL["max_abs"]))
    if tol_key is not None:
        embeddings_close("embeddings against the whole-block configuration", emb, against,
                         CONFIG_TOL[tol_key])
    return launches, emb


def phase_tiny_mel(card: str) -> dict:
    """Phase 20 (c): #6 and #7 at 128 and 96 mels and at hop 484 (#6's hop
    rows padded to 488 samples) on CLAP's 10 s geometry (centered, dB, a
    seeded affine, bf16 out), each against its plain version under
    LOG_MEL_TOL["clap"] at B = CHECK_B, one launch a call, repeated bitwise
    at B = CHECK_B and BATCH; ms at B = BATCH against the bound (the DFT of
    frame_length samples into the ``fb_bins`` bins the filterbank weighs, in
    bf16, and the mel product over them in f32; the clips in, the log-mel
    out); #6 against #7 at hop 484, printed (their K grouping
    differs).  Returns {(kernel, form): its numbers}."""
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.ops.mel import (
        log_mel_halo,
        log_mel_halo_plain,
        log_mel_v1,
        log_mel_v1_plain,
        mel_filter_bank,
    )

    gen = torch.Generator(device="cuda").manual_seed(20)
    fns = {"log_mel": (log_mel_halo, log_mel_halo_plain),
           "log_mel_v1": (log_mel_v1, log_mel_v1_plain)}
    n, out = 10 * SR, {}
    audio = {b: 0.2 * torch.randn((b, n), generator=gen, device="cuda") for b in (CHECK_B, BATCH)}
    for form, n_mels, hop, kernels in MEL_FORMS:
        fb = mel_filter_bank(513, n_mels, 50.0, 14000.0, SR, norm="slaney",
                             mel_scale="slaney").astype(np.float32)
        affine = (1 + 0.3 * torch.randn(n_mels, generator=gen, device="cuda"),
                  torch.randn(n_mels, generator=gen, device="cuda"))
        kw = dict(frame_length=1024, hop_length=hop, n_fft=1024, fb=fb, center=True,
                  log_mode="db", out_affine=affine, out_dtype=torch.bfloat16)
        got_of = {}
        for name in kernels:
            kfn, pfn = fns[name]
            before = KERNELS[name].launches
            got = kfn(audio[CHECK_B], **kw)
            if KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} {form}: {KERNELS[name].launches - before} launches")
            want = pfn(audio[CHECK_B], **kw)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {form}: {got.shape} vs {want.shape}")
            mx, rel = compare(name, got, want, want, {})
            rel_tol, max_tol = LOG_MEL_TOL["clap"]
            ok = mx <= max_tol and rel <= rel_tol
            log(f"  {name} {form} {tuple(got.shape)}: max_abs_err {mx:.4g} (tol {max_tol}) "
                f"mean_abs_err / mean |out| {rel:.4g} (tol {rel_tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {form} disagrees with its plain version")
            again = {b: (lambda b=b: kfn(audio[b], **kw)) for b in (CHECK_B, BATCH)}
            check_repeats(f"{name} {form}", ((CHECK_B, got, again[CHECK_B]),
                                             (BATCH, again[BATCH](), again[BATCH])))
            got_of[name] = again[BATCH]()
            ms = cuda_ms(again[BATCH], TIMING_ITERS[name], warmup=10)
            pms = cuda_ms(lambda: pfn(audio[BATCH], **kw), iters=3)
            b = log_mel_bound(BATCH, got.shape[1], 1024, fb, n, 2)
            out[(name, form)] = dict(ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                                     max_abs_err=mx)
            log(f"    B={BATCH}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.4f} ms "
                f"({b[1]}) [{card}]")
        if len(got_of) == 2:
            v1, halo = got_of["log_mel_v1"], got_of["log_mel"]
            d = (v1.float() - halo.float()).abs()
            log(f"  log_mel_v1 vs log_mel {form} at B={BATCH}: " + (
                "bitwise equal" if torch.equal(v1, halo) else
                f"differ in {int((d > 0).sum())} of {d.numel()} values, max abs "
                f"{d.max().item():.4g}" + (" (expected: the halo's K runs over padded hop rows)"
                                           if hop % 8 else " (not a gate: each is held to its "
                                           "plain version)")))
    return out


def phase_tiny_split(card: str) -> None:
    """Phase 20: the last narrow contracts.  (a) ``phase_tiny_split_kernels``
    at HTSAT-tiny's B = 64 shapes with ``check_params``' weights; (b) phase
    19's 630k-named checkpoint (written again, LAION names) in
    ``AudioMetrics(["fad", "kd", "prdc"])`` over 256 + 256 5 s clips, batch
    64, under ``AM_TPU_V4_STAGES=""`` and ``AM_TPU_ATTN_V1=1``, each in
    bf16 and f32, after the whole-block configuration of each dtype on the
    same clips (``phase_tiny_config``); (c) ``phase_tiny_mel``."""
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_TINY

    t20 = time.perf_counter()
    cfg = HTSAT_TINY
    params = check_params(cfg)
    log("  (a) the split block's kernels and the opt-in ops at HTSAT-tiny's widths")
    times = phase_tiny_split_kernels(card, cfg, params)
    reference, candidate = clips(N_CLIPS_TINY_SPLIT, CLIP_S, seed=11)
    launches = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_clap_checkpoint(params, ckpt_dir, cfg, TINY_CKPT)
        path = os.path.join(ckpt_dir, TINY_CKPT)
        for dtype, sfx, frontend in (("bfloat16", "", dict(clap_frontend=1)),
                                     ("float32", "_f32", {})):
            with environ(AM_TPU_CKPT_DIR=ckpt_dir):
                whole = LaionCLAP(ckpt=path, cfg=cfg, compute_dtype=dtype, device="cuda")
            log(f"  (b) {dtype}: the whole-block configuration on the same clips")
            against, whole_rate = phase_tiny_whole(card, whole, reference, candidate)
            del whole
            for switches, tol_key, per_forward in (
                    ({"AM_TPU_V4_STAGES": ""}, "split",
                     {"swin_attn_v3" + sfx: 12, "swin_mlp" + sfx: 10}),
                    ({"AM_TPU_ATTN_V1": "1"}, "attn_v1",
                     {"swin_attn_v1" + sfx: 4, "swin_mlp" + sfx: 10})):
                with environ(AM_TPU_CKPT_DIR=ckpt_dir, **switches):
                    clap = LaionCLAP(ckpt=path, cfg=cfg, compute_dtype=dtype, device="cuda")
                log(f"  (b) {dtype} {switches}: LaionCLAP(cfg=HTSAT_TINY, ckpt={TINY_CKPT}) in "
                    "AudioMetrics(['fad', 'kd', 'prdc'])")
                got, _ = phase_tiny_config(
                    card, clap, dict(per_forward, **{"patch_merge" + sfx: 3}, **frontend),
                    tol_key, against, whole_rate, reference, candidate)
                for name in per_forward:  # #9's on the split path, where it runs every block
                    launches.setdefault(name, (got[name], "AM_TPU_V4_STAGES=\"\"" if
                                               tol_key == "split" else "AM_TPU_ATTN_V1=1"))
                del clap
    log("  (c) the log-mels at 128 and 96 mels and at hop 484")
    mel = phase_tiny_mel(card)
    for name, t in times.items():
        n, path = launches.get(name, (0, "opt-in: no path runs it"))
        log(f"  {name} tiny: launches {n} ((b) {path}, add_reference + first evaluate), kernel "
            f"{t['ms']:.4f} ms a forward, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}), library {t['library_ms']:.4f}, max abs err "
            f"{t['max_abs_err']:.4g} [{card}]")
    for (name, form), t in mel.items():
        log(f"  {name} {form}: kernel {t['ms']:.4f} ms per {BATCH} 10 s clips, plain "
            f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']}), library none, "
            f"max abs err {t['max_abs_err']:.4g} [{card}]")
    log(f"  phase 20: {time.perf_counter() - t20:.1f} s [{card}]")


def phase_tiny_whole(card: str, clap, reference, candidate):
    """Phase 20 (b)'s and 21 (b)'s yardstick for the selectable paths: the
    whole-block configuration ``clap`` on the same clips: its reference
    embeddings and warm clips/s (median of 3), returned."""
    from audio_metrics_tpu_torch import AudioMetrics

    am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=clap, win_dur=float(CLIP_S),
                      input_sr=SR, batch_size=BATCH, device="cuda")
    torch.cuda.empty_cache()
    am.add_reference(reference)
    am.evaluate(candidate)
    rate, line = warm_rate(am, candidate, reference.shape[0])
    log(f"  {line} [{card}; real_weights: false]")
    return am.stem_reference.embeddings, rate


# phase 21: the merged one-window form of #10 and #11 (AM_TPU_MERGED_ATTN:
# window = resolution = 16 at stage 2, one 256-token attention an image on
# a dense (1, heads, 256, 256) table)
N_CLIPS_MERGED = 256  # (b): 256 + 256 5 s clips a configuration
# (a) the merged halves against their plain versions at stage 2: the v2
# half's stage-2 bounds of each dtype (the same function of the same
# operands as the per-window halves, whose bounds these are; the readings in
# PERF.md)
MERGED_TOL = {"bf16": (TOL["swin_attn_v2"][0][2], TOL["swin_attn_v2"][1]),
              "f32": (TOL["swin_attn_v2_f32"][0][2], TOL["swin_attn_v2_f32"][1])}


def merged_table(params, prefix, cfg, shift, heads, dtype):
    """Stage 2's v2 weights of ``prefix`` (matrices in ``dtype``) with the
    merged one-window table, on the card: the v2 half's operands and its
    ``half_operands``."""
    from audio_metrics_tpu_torch.models.htsat import (
        _Folded,
        _merged_bias_mask,
        _v2_kernel_weights,
    )
    from audio_metrics_tpu_torch.ops.attention import half_operands

    w = _v2_kernel_weights(params, prefix, 16, shift, heads, cfg.window_size)
    w["bm"] = _merged_bias_mask(w["bm"], 16, cfg.window_size)
    v2 = _Folded(w, dtype).to("cuda")
    return (v2.ln1_w, v2.ln1_b, v2.wqkv, v2.bq3, v2.wp, v2.bp, v2.bm), half_operands(v2.wqkv, v2.wp)


def phase_merged_kernels(card: str, cfg, params, label: str) -> dict:
    """(a) At stage 2 of ``cfg`` (R = 16, 16 heads) at B = BATCH, shifted
    and unshifted, bf16 and f32: the merged v1 half (``SwinBlock(...,
    attention="merged")``'s weights, what the model path runs) and the
    merged v2 half (v2's weights on the merged table) against their plain
    versions under MERGED_TOL, the allocator's blocks of the half's sizes
    filled with NaN before each call, one launch a call on its own count,
    repeated bitwise; v2 bitwise equal to v1 (the same launches on the
    same operands); the merged v2 half on a dense random table too (no
    block structure: the public ops take any table).  Printed, not gated:
    each merged half against the
    8x8-window v1 half on the same input and weights, and the merged
    attention launch against the per-window one (torch.profiler).  Times
    per forward over the stage's blocks: kernel, plain, the bound, the
    library yardstick (qkv + proj through ``torch.matmul``) and, as a
    second figure, the attention alone through one
    ``F.scaled_dot_product_attention`` with the table as a float mask.
    Returns {kernel: its numbers}."""
    import torch.nn.functional as F

    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.models.htsat import SwinBlock
    from audio_metrics_tpu_torch.ops.attention import (
        swin_attention_half_v1,
        swin_attention_half_v1_plain,
        swin_attention_half_v2,
        swin_attention_half_v2_plain,
    )
    from audio_metrics_tpu_torch.profile_evaluate import launch_ms
    from audio_metrics_tpu_torch.utils.precision import full_f32

    gen = torch.Generator(device="cuda").manual_seed(24)
    stage, res, depth = 2, 16, cfg.depths[2]
    c, heads = cfg.embed_dim * 4, cfg.num_heads[2]
    times = {}
    for dtype, sfx, dt in ((torch.bfloat16, "", "bf16"), (torch.float32, "_f32", "f32")):
        x = torch.randn((BATCH, res, res, c), generator=gen, device="cuda").to(dtype)
        m = BATCH * res * res
        rel_tol, max_tol = MERGED_TOL[dt]
        t = {f"swin_attn_{v}_merged{sfx}": dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, checked=0)
             for v in ("v1", "v2")}
        sdpa_ms = 0.0

        def check(v, key, kfn, pfn, n):
            """``v``'s merged kernel against its plain version; timed as
            ``n`` blocks of a forward."""
            name = f"swin_attn_{v}_merged{sfx}"

            def kernel():
                poison = [torch.full((m, w), float("nan"), dtype=dtype, device="cuda")
                          for w in (c, 3 * c, c, c)]
                del poison
                return kfn()

            before = KERNELS[name].launches
            got = kernel()
            if KERNELS[name].launches != before + 1:
                raise AssertionError(f"{name} {key}: {KERNELS[name].launches - before} launches")
            with full_f32():
                want = pfn()
            mx, rel = compare(name, got, want, want.float() - x.float(), {})
            ok = mx <= max_tol and rel <= rel_tol
            log(f"  {name} {key} at B={BATCH}: max_abs_err {mx:.4g} (tol {max_tol}) "
                f"mean_abs_err / mean |out - x| {rel:.4g} (tol {rel_tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {key} disagrees with its plain version")
            check_repeats(f"{name} {key}", ((BATCH, got, kernel),))
            r = t[name]
            r["max_abs_err"] = max(r["max_abs_err"], mx)
            r["checked"] += 1
            if n:
                ms, pms = cuda_ms(kfn), cuda_ms(pfn, iters=3)
                log(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, x{n} a forward")
                r["ms"] += n * ms
                r["plain_ms"] += n * pms
            return got

        for shift in (0, cfg.window_size // 2):
            prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
            blk = SwinBlock(params, prefix, cfg, res, shift, heads, dtype,
                            attention="merged").to("cuda")
            geo = dict(heads=heads, window=blk.window, shift=blk.shift, eps=blk.eps)
            a1 = (blk.ln1_w, blk.ln1_b, blk.wq, blk.bq, blk.wk, blk.wv, blk.wp, blk.bp, blk.bm)
            ops1 = blk.kernel_operands()
            a2, ops2 = merged_table(params, prefix, cfg, shift, heads, dtype)
            key = f"{label} stage 2 R=16 window 16 C={c} heads {heads} x {c // heads} shift={shift}"
            outs = {
                "v1": check("v1", key, lambda: swin_attention_half_v1(x, *a1, **geo, operands=ops1),
                            lambda: swin_attention_half_v1_plain(x, *a1, **geo), depth // 2),
                "v2": check("v2", key, lambda: swin_attention_half_v2(x, *a2, **geo, operands=ops2),
                            lambda: swin_attention_half_v2_plain(x, *a2, **geo), depth // 2)}
            same = torch.equal(outs["v1"], outs["v2"])
            log(f"    v2 against v1 (the same launches on the same operands): "
                f"{'bitwise equal' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"merged v2 differs from merged v1 ({key})")
            # the 8x8-window v1 half on the same input and weights
            w8 = SwinBlock(params, prefix, cfg, res, shift, heads, dtype,
                           attention="v1").to("cuda")
            a8 = (w8.ln1_w, w8.ln1_b, w8.wq, w8.bq, w8.wk, w8.wv, w8.wp, w8.bp, w8.bm)
            geo8 = dict(heads=heads, window=w8.window, shift=w8.shift, eps=w8.eps)
            per_window = swin_attention_half_v1(x, *a8, **geo8, operands=w8.kernel_operands())
            for v, out in outs.items():
                d = (out.float() - per_window.float()).abs()
                log(f"    merged {v} against the 8x8-window v1 half: "
                    + ("bitwise equal" if torch.equal(out, per_window) else
                       f"max abs {d.max().item():.4g}, mean abs / mean |out - x| "
                       f"{d.mean().item() / (out.float() - x.float()).abs().mean().item():.4g}, "
                       f"differ in {int((d > 0).sum())} of {d.numel()}")
                    + " (printed, not a gate)")
            merged_launch = launch_ms(lambda: swin_attention_half_v1(x, *a1, **geo,
                                                                     operands=ops1), 10)
            window_launch = launch_ms(lambda: swin_attention_half_v1(
                x, *a8, **geo8, operands=w8.kernel_operands()), 10)
            log("    attention launch (torch.profiler, per call): merged "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in merged_launch.items()
                            if "merged_attn" in k)
                + "; per-window " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                               window_launch.items() if "window_attn" in k)
                + f" [{card}]")
            # yardstick: the attention alone in one library call (never on the path)
            q, k, v = (torch.randn((BATCH, heads, 256, c // heads), generator=gen,
                                   device="cuda").to(dtype) for _ in range(3))
            mask = blk.bm.to(dtype)
            with full_f32():
                sdpa_ms += depth // 2 * cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=1.0))
            del blk, w8
        # any table: the public ops take any (1, heads, 256, 256) table, and
        # the kernel assumes no block structure in it (a dense random one)
        dense = (*a2[:-1], torch.randn((1, heads, 256, 256), generator=gen, device="cuda"))
        geo0 = dict(geo, shift=0)
        check("v2", f"{label} stage 2 C={c} on a dense random table",
              lambda: swin_attention_half_v2(x, *dense, **geo0, operands=ops2),
              lambda: swin_attention_half_v2_plain(x, *dense, **geo0), 0)
        _, per_block = products_alone_ms(cfg, BATCH, dtype)
        b = swin_bound(cfg, BATCH, "attn", (stage,), dt, merged=True)
        for name, r in t.items():
            r.update(bound_ms=b[0], bound_by=b[1], ops=b[2],
                     library_ms=depth * per_block[stage]["attn"], sdpa_ms=sdpa_ms)
            log(f"  {name} {label} per forward at B={BATCH} ({depth} blocks): kernel "
                f"{r['ms']:.4f} ms ({r['ops'] / (r['ms'] * 1e-3) / 1e12:.1f} TFLOP/s), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"library {r['library_ms']:.4f} ms (qkv + proj, torch.matmul), attention alone "
                f"through scaled_dot_product_attention {sdpa_ms:.4f} ms, max abs err "
                f"{r['max_abs_err']:.4g} [{card}]")
        times.update(t)
    return times


def phase_merged(card: str, results: dict) -> dict:
    """Phase 21: the merged one-window form of #10 and #11.  (a)
    ``phase_merged_kernels`` at HTSAT-base's and HTSAT-tiny's stage 2 with
    ``check_params``' weights; (b) under
    ``AM_TPU_MERGED_ATTN=1``, set around each model's construction only:
    HTSAT-base bf16 with phase 4's weights, ``laion_clap_music`` (f32) from
    phase 10's checkpoint and HTSAT-tiny bf16 from phase 19's, each in
    ``AudioMetrics(["fad", "kd", "prdc"])`` over 256 + 256 5 s clips at
    batch 64 after its whole-block configuration on the same clips
    (``phase_tiny_whole``, ``phase_tiny_config``): exact launches, finite
    metrics, self-FAD, embeddings against the plain path and within
    CONFIG_TOL["merged"] of the whole-block configuration, warm clips/s as
    a ratio to it.  Fills ``results`` with HTSAT-base's kernel numbers and
    returns HTSAT-base's launches of each merged kernel: the v1 half's in
    (b), the v2 half's (no path runs it) in (a)'s checked calls."""
    from audio_metrics_tpu_torch.models import get_embedder
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, HTSAT_TINY

    t21 = time.perf_counter()
    log("  (a) the merged halves at stage 2 against their plain versions")
    base = phase_merged_kernels(card, HTSAT_BASE, check_params(HTSAT_BASE), "HTSAT-base")
    tiny_params = check_params(HTSAT_TINY)
    tiny = phase_merged_kernels(card, HTSAT_TINY, tiny_params, "HTSAT-tiny")
    for name, r in base.items():
        results[name] = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
    reference, candidate = clips(N_CLIPS_MERGED, CLIP_S, seed=21)
    merged = {"AM_TPU_MERGED_ATTN": "1"}
    launches = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_clap_checkpoint(check_params(HTSAT_BASE), ckpt_dir)
        write_clap_checkpoint(tiny_params, ckpt_dir, HTSAT_TINY, TINY_CKPT)
        configs = (
            ("HTSAT-base", "bf16 (phase 4's weights)", "",
             lambda: LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16",
                               allow_random_weights=True, device="cuda"),
             dict(swin_block=6, swin_attn_v1_merged=12, swin_mlp=12, patch_merge=3,
                  clap_frontend=1)),
            ("HTSAT-base", "laion_clap_music f32 (phase 10's checkpoint)", "_f32",
             lambda: get_embedder("laion_clap_music", device="cuda"),
             dict(swin_block_f32=6, swin_attn_v1_merged_f32=12, swin_mlp_f32=12,
                  patch_merge_f32=3)),
            ("HTSAT-tiny", "bf16 (phase 19's checkpoint)", "",
             lambda: LaionCLAP(ckpt=os.path.join(ckpt_dir, TINY_CKPT), cfg=HTSAT_TINY,
                               compute_dtype="bfloat16", device="cuda"),
             dict(swin_block=6, swin_attn_v1_merged=6, swin_mlp=6, patch_merge=3,
                  clap_frontend=1)))
        for model, label, sfx, make, per_forward in configs:
            with environ(AM_TPU_CKPT_DIR=ckpt_dir):
                whole = make()
            log(f"  (b) {model} {label}: the whole-block configuration on the same clips")
            against, whole_rate = phase_tiny_whole(card, whole, reference, candidate)
            del whole
            with environ(AM_TPU_CKPT_DIR=ckpt_dir, **merged):
                clap = make()
            kinds = [b.attention for st in clap.model.encoder.blocks for b in st]
            log(f"  (b) {model} {label} under AM_TPU_MERGED_ATTN=1: block paths {kinds}")
            got, _ = phase_tiny_config(card, clap, per_forward, "merged", against, whole_rate,
                                       reference, candidate)
            name = f"swin_attn_v1_merged{sfx}"
            launches[(model, name)] = got[name]
            del clap
    for model, times in (("HTSAT-base", base), ("HTSAT-tiny", tiny)):
        for name, r in times.items():
            if name.startswith("swin_attn_v2"):  # opt-in, no path: (a)'s checked calls
                launches[(model, name)] = r["checked"]
            log(f"  {name} {model}: launches {launches.get((model, name), '-')} ("
                + ("(b), add_reference + first evaluate" if "v1" in name else
                   "(a)'s checked calls; opt-in, no path")
                + f"), kernel {r['ms']:.4f} ms a forward, plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}), library {r['library_ms']:.4f}, "
                f"scaled_dot_product_attention {r['sdpa_ms']:.4f}, max abs err "
                f"{r['max_abs_err']:.4g} [{card}]")
    log(f"  phase 21: {time.perf_counter() - t21:.1f} s [{card}]")
    return {name: n for (model, name), n in launches.items() if model == "HTSAT-base"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from audio_metrics_tpu_torch import kernels
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, HTSAT_TINY
    from audio_metrics_tpu_torch.testing import card_line

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 references
    torch.backends.cudnn.allow_tf32 = False
    for k in SWITCHES:  # phases 1-5 run the default configuration
        os.environ.pop(k, None)
    card = card_line()
    log(f"phase 1 card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s)")
    sass_check(lib._name)

    log("phase 3 kernels vs plain")
    cfg = HTSAT_BASE
    params = check_params(cfg)
    results: dict = {}
    phase_mlp_f32_edges(results)
    phase_kernels(cfg, params, results)
    mlp_f32_launches(cfg, "HTSAT-base")
    mlp_f32_launches(HTSAT_TINY, "HTSAT-tiny")
    phase_prdc_kernels(results)
    phase_log_mel(cfg, params, results)
    phase_fad_tail()

    log("phase 4 main path end to end (fad + kd + prdc, HTSAT-base bf16, 5 s windows)")
    launches, e2e = phase_e2e(card)
    log("phase 5 the 10 s path (fad + kd + prdc, HTSAT-base bf16, 10 s windows)")
    launches_10s, emb_10s = phase_config(card, {}, N_CLIPS_10S, 10, 6,
                                         dict(swin_block=18, patch_merge=3, log_mel=1))
    log('phase 6 split blocks (AM_TPU_V4_STAGES="": v3 attention half + fused MLP)')
    launches_split, _ = phase_config(
        card, {"AM_TPU_V4_STAGES": ""}, N_CLIPS_SPLIT, CLIP_S, 3,
        dict(swin_attn_v3=18, swin_mlp=16, patch_merge=3, clap_frontend=1), tol_key="split")
    log("phase 7 v1 attention (AM_TPU_ATTN_V1=1: v1 at stages 0-1, XLA at 2-3)")
    launches_v1, _ = phase_config(
        card, {"AM_TPU_ATTN_V1": "1"}, N_CLIPS_V1, CLIP_S, 3,
        dict(swin_attn_v1=4, swin_mlp=16, patch_merge=3, clap_frontend=1), tol_key="attn_v1")
    log("phase 8 v1 log-mel (AM_TPU_MEL_V1=1, the 10 s path)")
    launches_mel_v1, _ = phase_config(
        card, {"AM_TPU_MEL_V1": "1"}, N_CLIPS_10S, 10, 6,
        dict(swin_block=18, patch_merge=3, log_mel_v1=1), tol_key="mel_v1", against=emb_10s)

    log("phase 9 the opt-in ops (v2 attention half, int8 MLP) on a real forward's activations")
    launches_opt_in = phase_opt_in(card, results)
    launches_opt_in_f32 = phase_opt_in_f32(card, params, results)
    log("phase 10 the default configuration: laion_clap_music by name from AM_TPU_CKPT_DIR, "
        "f32, fad + kd + prdc, 5 s windows")
    launches_f32, emb_f32 = phase_f32(card, params, {},
                                      dict(swin_block_f32=18, patch_merge_f32=3), warm_runs=3)
    log('phase 11 the default configuration in f32, split: AM_TPU_V4_STAGES="" (f32 v3 half + '
        "f32 fused MLP), then AM_TPU_ATTN_V1=1 (f32 v1 half at stages 0-1, XLA at 2-3)")
    launches_v3_f32, _ = phase_f32(
        card, params, {"AM_TPU_V4_STAGES": ""},
        dict(swin_attn_v3_f32=18, swin_mlp_f32=16, patch_merge_f32=3), against=emb_f32)
    launches_v1_f32, _ = phase_f32(
        card, params, {"AM_TPU_ATTN_V1": "1"},
        dict(swin_attn_v1_f32=4, swin_mlp_f32=16, patch_merge_f32=3), against=emb_f32)
    log("phase 12 VGGish (bf16 fad + kd + prdc, 5 s at 16 kHz; f32 by name from "
        "AM_TPU_CKPT_DIR)")
    phase_vggish(card)
    log("phase 13 the stems options on HTSAT-base bf16: hop_dur, input_sr, n_pca, precompile, "
        "AM_TPU_NO_MEL_TILE")
    phase_stems_options(card)
    log("phase 14 the OOM retry (set_per_process_memory_fraction)")
    phase_oom_retry(card)
    log("phase 15 (a) the APA path: apa + fad, L0, HTSAT-base bf16, 5 s pairs (main_apa)")
    phase_apa(card)
    log("phase 15 (b) AudioMetrics(input_sr=48000) at its defaults: apa + fad, L0, "
        "laion_clap_music f32 from AM_TPU_CKPT_DIR")
    phase_apa_defaults(card, params)
    t16 = time.perf_counter()
    log("phase 16 (a) the host-fed stems path: lists of songs, fad + kd + prdc + fad_inf, "
        "HTSAT-base bf16")
    phase_hostfed(card)
    log("phase 16 (b) the host-fed APA path: lists of context+stem songs, apa + fad, L0")
    phase_hostfed_apa(card)
    log("phase 16 (c) the command line: evaluate and convert, laion_clap_music_l-2 f32 from "
        "AM_TPU_CKPT_DIR")
    phase_cli(card, params)
    log(f"  phase 16: {time.perf_counter() - t16:.1f} s [{card}]")
    log(f"phase 17 one AudioMetrics over a mesh: {N_SHARDS} shards on card 0, its DCN layout, "
        "replicate, the APA and host-fed paths on 2 shards, every card, two examples")
    phase_mesh(card, params)
    log("phase 18 the public surface: a forward-only embedder, the metric functions on raw "
        "features, AudioMetricsData on numpy batches")
    phase_surface(card, e2e)
    log("phase 19 HTSAT-tiny: the kernels at its widths (24-wide heads), then LaionCLAP("
        "cfg=HTSAT_TINY) from a 630k-named checkpoint in bf16 and f32, fad + kd + prdc")
    phase_tiny(card)
    log('phase 20 the last narrow contracts: HTSAT-tiny\'s split blocks and opt-in ops, '
        'AM_TPU_V4_STAGES="" and AM_TPU_ATTN_V1=1 in bf16 and f32, the log-mels at any mel '
        "count and hop")
    phase_tiny_split(card)
    log("phase 21 the merged one-window form of #10/#11 (AM_TPU_MERGED_ATTN: 256-token "
        "attention at stage 2), bf16 and f32, HTSAT-base and HTSAT-tiny")
    launches_merged = phase_merged(card, results)

    # launches: each kernel's count on the path that runs it
    path_of = {"log_mel": launches_10s, "swin_attn_v3": launches_split,
               "swin_mlp": launches_split, "swin_attn_v1": launches_v1,
               "log_mel_v1": launches_mel_v1, "swin_attn_v2": launches_opt_in,
               "swin_mlp_int8": launches_opt_in, "swin_block_f32": launches_f32,
               "patch_merge_f32": launches_f32, "swin_attn_v3_f32": launches_v3_f32,
               "swin_mlp_f32": launches_v3_f32, "swin_attn_v1_f32": launches_v1_f32,
               "swin_attn_v2_f32": launches_opt_in_f32,
               "swin_mlp_int8_f32": launches_opt_in_f32,
               **{name: launches_merged for name in launches_merged}}
    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": path_of.get(k.name, launches)[k.name],
         **{key: results[k.name][key] for key in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": results[k.name].get("library_ms")}
        for k in kernels.KERNELS.values()
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
