"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout and drives the port's
main paths on the card. The sources build in the background, as many at
a time as the cores, in the order the phases first load them, and the
phases run in the order K, 3-10, J, A-I, L, M, N-Z, AA, so that each starts
once its own libraries are built while the rest still build, and those
that compute most on the host's cores (L, M) run once most are built
(W, X, Y and Z come last, X's, Y's and Z's libraries last in the build):

- phases 3-6, the product render: the dense flagship through
  ``LoadedModel.prepare_network_render`` in FUSED mode (512x512, world
  stepsize 1/512), the kernel against its plain PyTorch version, the
  render against the plain lattice oracle, and its timing;
- phases 7-10, screen-space training: ``train.main.run`` in screen mode
  at the flagship's widths (512x512, 1/512, 2 cameras, 2 epochs) through
  the differentiable forward and backward kernels; the kernels against
  their plain differentiable version at full frame and against autograd
  through the float32 lattice oracle on 64 tiles; the training step's
  timing;
- phases A-E, the FUSED renders of the per-segment engine
  (``csrc/segment_fwd.cu``): route 2 of the dense flagship at 1920x1080
  (A, timed), of a network without a latent grid (B) and of a color-output
  network with a 24-channel grid (C); route 1b, the bucketed lattice
  march of a grid over the megakernel's slab budget (D); the FUSED and
  FUSED_BF16 isosurface render (E). Each against the engine's plain
  version, and A, C and E against the plain per-ray marches;
- phases F-G, screen training through the per-segment engine's scan
  route (``evaluate_screen``'s default engine: ``csrc/segment_fwd.cu``
  storing carries, ``csrc/segment_bwd.cu``): ``train_screen`` on the
  dense flagship at 512x512, 1/512 (2 cameras, 1 epoch), one timed step
  and each kernel, the kernels against the plain pair at full frame (F);
  then the plain pair on the flagship at 256x256, a color-output network
  with a 24-channel grid and direction input, lattice sampling, and
  autograd through the plain per-ray march on 16384 rays (G);
- phases H-I, Monte-Carlo path tracing through the fused sample evaluator
  (``csrc/sample_eval.cu``): the kernel alone on 2^20 seeded positions of
  the dense flagship, value and position gradient against its plain
  version, a bf16 table against the float32 one, timed, with the value
  instance's persistent grid and every instance's registers and spills
  (H); then
  ``trace_mc(use_fused=True)`` on the flagship at 512x512 (HG g=0.3, 2
  bounces, 256 iterations) against ``trace_mc`` on the plain
  ``eval_density`` with the same key, timed with and without live-ray
  compaction and with the host's live-ray check every 1, 4, 8 and 16 rounds,
  one frame with the kernel's launches timed, and the frame's first
  launch (512x512 positions) alone against its plain version, timed (I);
- phase J, the sparse arm: the sparse flagship (a TF with a zero-opacity
  band) at 512x512, 1/512 through ``prepare_network_render`` in FUSED
  mode with occupancy culling (the ``segment_active`` mask in all three
  megakernel launches) and one masked training step: the culled share,
  culled vs unculled, kernel vs plain, the lattice oracle with
  bench.py's sparse gates, the step's network gradients, timings;
- phase K, TPU kernel rows 8-11 (``csrc/probes.cu``): the port's probe
  tools at the JAX tools' shapes, each kernel against the tools' NumPy
  oracles and its plain version, timed beside its bound and the library
  call;
- phase L, world-space training, the trainer's default mode (no TPU
  kernel on its path): ``train.main.run --mode world`` at the flagship's
  widths (65,536 halton samples, batch 8192, 2 epochs), then with random
  positions, an importance-sampled half and a rebuild every epoch; JAX's
  draws (random positions, the epoch permutation, uniform and normal) on
  the card against the CPU's, the dataset's targets and the first step's
  loss and gradients against the CPU's, the step timed; then
  ``render_image`` supersampled (4 samples, 64x64), ``phase.sample`` and
  ``sample_light_position`` from a key, card against CPU;
- phase M, a voxel volume end to end: MARSCHNER_LOBB voxelized at 256^3
  on the card (``create_implicit_grid``) with a uint8 copy, written as a
  ``.cvol`` uncompressed and LZ4-compressed and read back (equal, timed);
  a scene JSON naming it (piecewise TF, "Grid", trilinear) resolved by
  ``load_from_json``; the grid's three samplers, ``eval_normal`` and
  ``eval_curvature`` timed on 2^20 positions, card against CPU on 2^18;
  ``train.main.run --mode world`` on the scene at the flagship's widths
  (65,536 halton samples, batch 8192, 2 epochs: dataset and first step
  card against CPU, the step timed) and in screen mode (512x512, 1/512,
  2 cameras, 1 epoch: rows 2-3, the first step's kernels against their
  plain version at full frame); ``LoadedModel.render_reference`` of the
  grid and the world-trained network's FUSED render (row 1), PSNR
  printed; a curvature-texture iso render of the grid at 64x64, card
  against CPU;
- phase N, the TF modes of rows 1-6 (texture, 1D- and 2D-preintegrated,
  Gaussians: ``scenes.dense_tf_modes``, the dense ramp as a 256-texel
  texture, its 512-row and 128^2 preintegrations, four Gaussians) on the
  flagship at 512x512, 1/512: ``train.main.run --mode screen`` on a scene
  JSON naming a texture TF (rows 2-3); then per mode the product render on
  route 1 (``prepare_network_render(mode="FUSED")``, which refuses the
  Gaussians; the Gaussians through ``mega_trace_dvr``) and the per-segment
  engine on route 2's rays (``fused_trace_dvr``), each kernel against its
  plain version and row 1 (row 4 in the texture mode: cut in depth, the
  oracle takes ~3 s a call) against the f32 oracle (``trace_dvr``) on
  16384 rays, and one
  differentiable step (mean(img^2)) on each engine (rows 2-3 and 5-6),
  timed at full frame, every gradient leaf (the TF's tables too) against
  the plain pair on 64 whole tiles;
  frames, kernels and steps timed beside phases 6, 10 and F's piecewise
  figures, the launches counted;
- phase O, the paper's network sweeps on rows 1-3;
- phase P, normals and shading: rows 1 and 4's normals instances on the
  dense flagship at 512x512, 1/512 with the JAX tests' BRDF and with a
  point light and magnitude scaling, timed beside the unshaded render in
  the same call, kernel vs plain and the f32 kernel vs the lattice oracle
  on 64 whole tiles (share of rays off bounded: a gradient gate flips on
  float32 noise); the trained 64:64:64 network of phase O and a 48-wide
  ReLU network with direction input at 128x128 on both tables; the MC
  walk with a gradient-scaled Gaussian at 256x256 through row 7's
  gradient instance (once a camera-walk round) against the plain walk;
  ``eval_gradient_networks`` at its defaults;
- phase Q, BASELINE config 5: a time- and ensemble-keyframed network at
  the flagship's widths (time grid 8 x 8 x 32^3, ensemble grid 4 x 8 x
  32^3) world-trained on the card to two implicit fields at two (time,
  ensemble), the keyframed and the latent-only step's first step card
  against CPU and timed (Q1); the FUSED render at 512^2, 1/512 at three
  (t, e) on rows 1 and 4, each kernel against its plain version, and at
  the middle (t, e) against the f32 oracle of the network volume there
  (cut in depth: ~6 s a call), and an 8-frame animation
  with the resolve and table build timed apart from the call (Q2); one
  differentiable step on each engine: rows 5-6 at t = 3.5 on 64 whole
  tiles with every leaf (keyframes included, those outside the bracket
  exactly 0) against the plain pair, rows 2-3 through
  ``evaluate_screen(engine="mega")`` on the flagship with latent vectors
  (Q3); ``trace_mc(use_fused=True)`` at 256^2 against the plain walk and
  row 7 alone (Q4); a ``.volnet`` round trip rendered FUSED (Q5).

- phase R, bench.py's contracted configuration (``bench.py:133-176``):
  the dense and the sparse flagship at 512^2, 1/512, bench.py's camera
  in 16x8 pixel blocks, the saturation clip, a 3-bucket plan of 128-ray
  tiles, the sparse arm's per-bucket occupancy masks, a bf16 latent
  table under training (``fused_trace_dvr_bucketed(engine="mega",
  tile=128, table_dtype=bf16, segment_active_groups=...)``): the forward
  frame and the training step (mean(c^2), SGD 1e-7) counted by kernel
  instance and timed over 6 frames, beside a float32-table step and
  phase 10's 256-ray float32 step; bench.py's gates against the f32
  lattice oracle and the kernels against their plain versions on 128
  tiles; rows 5-6 with a bf16 table against the plain pair;
- phase S, row 3's ray gradients: the camera matrix's gradient through
  ``generate_rays`` and ``mega_trace_dvr(ray_grads=True)`` on the
  flagship at 512^2, the kernels against the plain version on 64 whole
  tiles, row 3 timed with and without them;
- phase T, camera pose recovery through row 1
  (``tools.pose_recovery_demo``: the trained flagship at 64^2 with 4
  fixed jittered samples a pixel, 1/128, Levenberg-Marquardt on forward
  renders), gated as the JAX package's pose tests, row 1 against its
  plain version on one of the renders;
- phase U, data parallelism on ``torch.distributed``, ranks spawned from
  this script through a ``file://`` store once their libraries are
  built: two ``gloo`` ranks sharing the card take the data-parallel
  screen step on the flagship at 512^2 through rows 2-3 against one
  process's step on both cameras, the overlapped latent all-reduce
  against the trailing one (U1); one ``nccl`` rank runs ``train.main.run
  --data_parallel 1`` against the single-process trainer (U2); the two
  ``gloo`` ranks' halves of config 5's MC frame through row 7 against
  one process's (U3);
- phase V, the paper's evaluation harnesses through their own entry
  points (``fvsrn_tpu_torch/eval``): ``eval_volumetric_features --scene
  dense`` at its defaults but 2 cameras at 256^2 (1/512, FUSED and
  PLAIN32 timed, SSIM against ``render_reference``; row 1, camera 0's FUSED frame
  against its plain version) (V1); ``eval_screen_vs_world`` (its screen
  entry through rows 2-3) and ``eval_density_vs_color --render`` (row 1
  for each head) at 2 epochs, every trained network's FUSED 128^2 frame
  against its plain version (V2); ``eval_compression_teaser`` (the SRN
  fitted on the card, the host codecs at 64^3, each decoding to its
  volume) (V3);
- phase W, the last modules through their entry points, no TPU kernel
  on their paths: the viewer (``viewer.serve`` on an ephemeral port,
  JAX's main scene: MARSCHNER_LOBB, DVR at 1/256) answering ``/``,
  ``/meta`` and four 512^2 renders (orbits and opacity), a progressive
  MC evaluator at 128^2 counting its passes (W1); ``eval_scaling
  --device cuda --devices 1 2`` at its defaults, one ``nccl`` rank and
  two ``gloo`` ranks sharing the card (no scaling figure) (W2); the
  variant and meta networks at the JAX package's defaults world-trained
  200 steps of 2^16 positions on MARSCHNER_LOBB, rendered PLAIN32 at
  128^2, card against CPU, their FUSED render refused (W3); ``cli.main``
  on a 256^3 float32 ``.xyz`` and a 256^3 UCHAR ``.dat`` to LZ4 ``.cvol``
  with 2 mipmaps, reloaded, and ``warp_image``/``inpaint`` on a 4x512^2
  image card against CPU (W4);
- phase X, the texture, 1D- and 2D-preintegrated TFs on networks other
  than SnakeAlt without direction input (the flagship's widths as ReLU
  with direction input and as Sine:30, a 64:64:64 ReLU network with
  direction input) through ``prepare_network_render(mode="FUSED")``:
  route 1 at 512^2, 1/512 (``csrc/mega_fwd_anytf*.cu``) and route 2 at
  1920x1080 (``csrc/segment_fwd_anytf.cu``), each kernel against its
  plain version on 64 whole tiles, timed beside the same network's
  piecewise frame and the flagship's frame in the same mode;
- phase Y, every TF mode on every network in training: phase X's
  networks under the texture, 1D- and 2D-preintegrated TFs and four
  Gaussians, one differentiable step (mean(img^2)) at 512^2, 1/512 on
  each engine, rows 2-3 (``csrc/mega_fwd_anytf*.cu`` or, for the
  Gaussians, ``csrc/mega_fwd_anyg*.cu``; ``mega_bwd*``) and rows 5-6
  (``csrc/segment_fwd_anytf.cu`` or ``csrc/segment_fwd_anyg.cu``;
  ``segment_bwd``), launches counted by library; each pair against its
  plain version on 64 whole tiles (image, every gradient leaf; row 3
  once more on a bf16 table), each step timed beside the same network's
  piecewise step and the flagship's in the same mode, the Gaussian
  instances' forward alone at full frame; then ``train.main.run --mode
  screen --activation ReLU`` on a scene JSON written to a temporary
  directory (the voxelized MARSCHNER_LOBB ``.cvol`` with a ``Texture``,
  then a ``Gaussian`` TF): fused, through those libraries, loss falling;
- phase Z, Table 1's wide networks through the width-128 instances
  (``csrc/*128.cu``: hidden matrices read from device memory):
  ``train.main.run --mode screen --layers 128:128:128`` at the flagship's
  inputs (128x128, 2 cameras, 1 epoch; ``mega_fwd128``, ``mega_bwd128``
  launched); the trained network's main path with the counts reset (the
  FUSED render at 512x512, 1/512, culled under the ramp with a zero band
  to the network's median density, route 2 at 1920x1080, a training step on each engine, row 7 at 2^20
  positions), every kernel timed at full size and held against its
  plain version on 64 whole tiles, steps in the piecewise and texture
  TFs; a mixed 64:32 network (the 64 instance) on rows 1, 4 and 7 and a
  96:96:96 ReLU network with direction input (padded to 128) on rows
  1-7, against their plain versions; every wide instance's registers and
  spills;
- phase AA, TFs of any size and normals at width 128: the dense flagship
  with its ramp as 40 and TF_STAGED_POINTS + 1 piecewise knots (above
  the count the kernels stage in shared memory: read from device
  memory), counts reset, the FUSED render at 512x512 on route 1 and at
  1920x1080 on route 2 and a training step on each engine, and a step on
  each engine with the ramp as 24 Gaussians, each kernel held against its
  plain version on 64 whole tiles (route 1 also against the f32 lattice
  oracle) and timed beside the ramp's; then on phase Z's trained
  128:128:128 network, counts reset, a Phong-shaded 512x512 frame on rows
  1 and 4 (``csrc/mega_fwd_nrm128.cu``, ``csrc/segment_fwd_nrm128.cu``),
  ``eval_gradient_networks``' normal scores and shaded render, row 7's
  gradient instance (``csrc/sample_eval128.cu``) at 2^20 positions and a
  gradient-scaled MC walk, each against its plain version, with the new
  instances' registers and spills.

Prints one JSON line with every kernel and a last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Exits non-zero without a CUDA device.
"""
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
WIDTH = HEIGHT = 512
STEPSIZE = 1.0 / 512
CAMERA = dict(pitch=0.3, yaw=0.5, distance=1.6)
KERNEL_TOL = 1e-4      # kernel vs its plain version, same inputs
ORACLE_TOL = 2e-2      # bf16-table render vs the f32 lattice oracle
# kernel vs plain, relative norm error per leaf: on an H100 the kernels read
# 3.94e-5 at most (float32 summation order); a plain version that split the
# clips' ties 0.5/0.5 read 5.83e-4
GRAD_TOL = 2e-4
ORACLE_GRAD_TOL = 5e-3  # vs the f32 lattice oracle (bench.py:68-69)
# phase J, the sparse arm vs the f32 lattice oracle (bench.py:80-82): the
# bf16 table's rounding, amplified by the zero-band TF's steep edge
SPARSE_P99_TOL = 2e-2
SPARSE_MAX_TOL = 1.5e-1
SPARSE_GRAD_TOL = 2e-2
ORACLE_TILES = 64      # 16384 rays, the oracle subset of bench.py:67
BENCH_TILE, BENCH_SEG = 128, 32      # phase R: bench.py's march
BENCH_FRAMES = 6                     # phase R: bench.py's TIMED_FRAMES
BENCH_GATE_RAYS = 16384              # phase R: bench.py's GATE_RAYS
# phase R: a bf16 table's gradient, kernel vs plain, per element: two bf16
# ulps (a float32 sum summed in another order may round to the
# neighbouring bf16 value) plus GRAD_TOL of the leaf's largest
BF16_GRID_REL = 2.0 ** -7
TIMED_CAMERAS = 4
TIMED_STEPS = 3
# phase 2: the sources in the order the phases first load them (the
# phases run K, 3-10, J, A-I, L, M, N-Z, AA), then those no phase
# launches, then phase X's (its four take ~840 s of nvcc), phase Y's and
# phase Z's width-128 instances; phase AA's normals instances at 128, the
# two slowest sources (~450 s of nvcc each), start with the first six, so
# that the build does not end on them
BUILD_ORDER = ("probes", "mega_fwd", "mega_bwd", "segment_fwd",
               "segment_bwd", "sample_eval", "mega_fwd_nrm128",
               "segment_fwd_nrm128", "mega_fwd_tf", "segment_fwd_tf",
               "mega_fwd_any", "mega_fwd48", "mega_fwd_any48", "mega_bwd48",
               "mega_fwd64", "mega_fwd_any64", "mega_bwd64", "mega_fwd_nrm",
               "segment_fwd_nrm", "mega_fwd_nrm48", "mega_fwd_nrm64",
               "mega_fwd_t128", "mega_bwd_t128", "mega_fwd_tf48",
               "mega_fwd_tf64", "mega_fwd48_t128", "mega_bwd48_t128",
               "mega_fwd64_t128", "mega_bwd64_t128", "mega_fwd_tf_t128",
               "mega_fwd_tf48_t128", "mega_fwd_tf64_t128",
               "mega_fwd_any_t128", "mega_fwd_any48_t128",
               "mega_fwd_any64_t128", "segment_fwd_anytf", "mega_fwd_anytf",
               "mega_fwd_anytf48", "mega_fwd_anytf64", "segment_fwd_anyg",
               "mega_fwd_anyg", "mega_fwd_anyg48", "mega_fwd_anyg64",
               "mega_fwd128", "mega_bwd128", "segment_fwd128",
               "segment_bwd128", "sample_eval128", "mega_fwd_any128",
               "mega_fwd_tf128", "segment_fwd_tf128", "mega_fwd_anytf128",
               "segment_fwd_anytf128", "mega_fwd_anyg128",
               "segment_fwd_anyg128")
SEG_WIDTH, SEG_HEIGHT = 1920, 1080   # phase A: not multiples of 16
RGBO_SIZE = 504                      # phase C
ISO_VALUE = 0.5                      # phase E
# phase E: share of rays whose first-hit sample may flip on float32 noise
# (the fused and plain networks differ by ~1e-6), and of pixels a bf16
# table may move past ORACLE_TOL (a table rounded to bf16 moves values by
# ~1e-3: a flip wherever the crossing sample is that close to the
# isovalue)
ISO_FLIP_SHARE = 1e-4
ISO_BF16_SHARE = 0.05
SAMPLE_POSITIONS = 1 << 20           # phase H
MC_MATCH_SHARE = 0.98                # phase I: rays of the fused frame within
MC_TOL = 1e-3                        # MC_TOL of the plain one (a knife-edge
                                     # collision may flip on float32 noise)
MC_REPS = 5                          # phase I: frames per schedule
TRAIN_ARGS = ["IMPLICIT:MARSCHNER_LOBB", "--mode", "screen",
              "--layers", "32:32:32", "--activation", "SnakeAlt:2",
              "--fouriercount", "14", "--outputmode", "density:direct",
              "--volumetric_features_channels", "16",
              "--volumetric_features_resolution", "32",
              "--screen_size", str(WIDTH), "--stepsize", str(STEPSIZE),
              "--screen_cameras", "2", "-i", "2", "-o", "Adam",
              "-lr", "1e-3"]
WORLD_ARGS = ["IMPLICIT:MARSCHNER_LOBB", "--mode", "world",
              "--layers", "32:32:32", "--activation", "SnakeAlt:2",
              "--fouriercount", "14", "--outputmode", "density:direct",
              "--volumetric_features_channels", "16",
              "--volumetric_features_resolution", "32",
              "--samples", "65536", "--sampler", "halton",
              "--batch_size", "8192", "-i", "2"]
GRID_RES = 256                       # phase M: MARSCHNER_LOBB voxelized
GRID_POSITIONS = 1 << 20             # phase M: sampler timing
GRID_CPU_POSITIONS = 1 << 18         # phase M: card vs CPU (cut in depth)
GRID_ISO_SIZE = 64                   # phase M: curvature iso render (cut)
GRID_ISO_RANGE = 64.0                # phase M: curvature texture's range
GRID_ISO_SHARE = 0.99                # phase M: iso pixels card = CPU (1e-4)
# phase M's scene TF: train.main's IMPLICIT TF as a scene JSON gives it
GRID_SCENE_TF = {"absorptionScaling": 20.0,
                 "colorPoints": [[0.0, 0.9, 0.4, 0.1], [1.0, 1.0, 1.0, 0.6]],
                 "opacityPoints": [[0.0, 0.0], [1.0, 1.0]]}
# phase N: the 1D preintegration's near branch (|d - prev| < 1e-3) and the
# 2D table's nearest cell are discontinuous in the density; where the
# kernel's TF32 three-pass products and the plain float32 ones round a
# density (~1e-6 apart) to the two sides of an edge, the sample takes the
# other branch. Those modes bound the share of rays off KERNEL_TOL and how
# far off they are.
TF_FLIP_SHARE = 2e-3
TF_FLIP_TOL = 5e-2
# their gradients: a flipped sample's adjoint differs whole (the near
# branch's 1/(d - prev) factors are ~1e3), so each leaf of those modes is
# held to TF_FLIP_GRAD times the plain version's own change when every
# weight moves by a seeded relative TF_FLIP_EPS (a density noise of the
# two versions' size), or GRAD_TOL if larger
TF_FLIP_GRAD = 2.0
TF_FLIP_EPS = 1e-6
TF_ORACLE_RAYS = 16384
# operations of a sample's TF beyond the piecewise lookup's (phase N's
# bound): two lerped texels (8 multiply-adds); preint1d three lerps, the
# quotients and an exp; preint2d one cell and a divide; four Gaussians'
# exps and multiply-adds
TF_FLOPS = {"texture": 16, "preint1d": 64, "preint2d": 12, "gaussian": 72}
# phase N, cut in depth: each step timed once after a warm-up, and row
# 1's and 4's f32 oracle (a plain trace_dvr, ~3 s a call) for these modes
# only
N_TIMED_STEPS = 1
N_ROW4_ORACLE = ("texture",)
# phase O: the networks of the paper's sweeps on rows 1-3. The widest of
# fvsrn_tpu/eval/eval_network_configs.py (NET_TRAIN_ARGS), trained
# briefly by the trainer at NET_SIZE^2 and then timed at 512^2; the rest
# (NET_CASES) against the plain versions at NET_SIZE^2. Each case:
# (SceneRepresentationNetwork.make options beyond 32:32:32 SnakeAlt:2, 14
# Fourier features and a sigmoid density head, which keeps a random
# network's samples contributing; the latent grid's (channels,
# resolution), or None).
NET_SIZE = 128
NET_TRAIN_ARGS = ["IMPLICIT:MARSCHNER_LOBB", "--mode", "screen",
                  "--layers", "64:64:64", "--activation", "SnakeAlt:2",
                  "--fouriercount", "14", "--outputmode", "density:direct",
                  "--volumetric_features_channels", "16",
                  "--volumetric_features_resolution", "32",
                  "--screen_size", str(NET_SIZE), "--stepsize",
                  str(STEPSIZE), "--screen_cameras", "2", "-i", "1",
                  "-o", "Adam", "-lr", "1e-3"]
NET_CASES = {
    "48:48:48 8x16^3": (dict(layers="48:48:48"), (8, 16)),
    "32:32 16x32^3": (dict(layers="32:32"), (16, 32)),
    "64:64 no grid": (dict(layers="64:64"), None),
    "ReLU": (dict(activation="ReLU"), (8, 16)),
    "Sine:30": (dict(activation="Sine:30"), (8, 16)),
    "Snake:1": (dict(activation="Snake:1"), (8, 16)),
    "Sigmoid": (dict(activation="Sigmoid"), (8, 16)),
    "Softplus": (dict(activation="Softplus"), (8, 16)),
    "rgbo": (dict(output_mode="rgbo"), (8, 16)),
    "rgbo:exp": (dict(output_mode="rgbo:exp"), (8, 16)),
    "direction": (dict(use_direction=True, disable_direction_in_fourier=False),
                  (8, 16)),
}
# Sine:30 is ill-conditioned in float32 (30x pre-activations): one ulp of
# seeded weight noise moves the plain version's image by 6.5e-4 to 9.1e-4
# (the card tests' 64x64 case) and its gradient leaves by 0.4-4.7%
# (tools/port_conditioning.py, on the CPU). Its kernel-vs-plain
# image and leaves are held to NOISE_FLIP times the plain version's own
# change under NOISE_EPS relative weight noise (KERNEL_TOL and GRAD_TOL
# at least), as phase N holds the discontinuous TF modes.
NET_ILL = {"Sine:30"}
# O3's cases held against the f32 lattice oracle as well (~3 s a call, so
# cut in depth to a density and an rgbo head; every case is held against
# its plain version)
O3_ORACLE = ("48:48:48 8x16^3", "rgbo")
NOISE_EPS = 1e-7
NOISE_FLIP = 5.0
# phase P: normals and shading (rows 1, 4 and 7). The JAX tests' BRDF
# (tests/test_fused.py:345) and a point light with magnitude scaling
NRM_BRDF = dict(enable_phong=True, ambient=0.2, specular=0.3,
                magnitude_center=0.02, magnitude_radius=0.02,
                light=(0.3, -0.5, -1.0))
NRM_POINT = dict(NRM_BRDF, light=(0.8, 1.2, -1.5), light_type="point",
                 specular_exponent=5, enable_magnitude_scaling=True,
                 magnitude_scaling=200.0)
# kernel vs plain with normals: colour 2e-4 (shaded), normal 5e-4, depth
# 1e-4 (the JAX package's gates) on all but this share of the rays: a
# sample at a clip or ReLU kink, or at |g|^2 = 1e-12, switches its
# gradient (normal, shading) on float32 noise
NRM_FLIP_SHARE = 1e-2
NRM_SIZE = 128                       # phase P3's networks
MC_NRM_SIZE = 256                    # phase P4's frame
# a gradient-scaled Gaussian TF for the MC walk (the flagship's densities
# and |grad| put the scaled widths at ~0.05-0.5)
MC_NRM_TF = [[0.9, 0.3, 0.2, 8.0, 0.3, 0.5], [0.2, 0.8, 0.9, 6.0, 0.7, 0.5]]
MC_CHECK_SIZE = 64                   # phase L: render_image supersampled
MC_CHECK_SAMPLES = 4
MC_CHECK_STEPSIZE = 1.0 / 128
# H100 SXM published dense peaks (NVIDIA data sheet) at 700 W
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_timed(fn, iters):
    """(Mean device milliseconds, mean host microseconds) a call of ``fn``
    over ``iters`` calls, after one warm-up call (CUDA events; the host's
    clock around the loop that enqueues them). A device-side sleep queued
    before the first event (1 ms and 0.2 ms a call at ~2 GHz) lets the
    host enqueue the calls ahead of the device: a kernel shorter than its
    host-side launch cost is timed, not the shared host's launch rate,
    and the host's cost is read apart."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (1.0 + 0.2 * iters)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_us


def cuda_ms(fn, iters):
    """Mean device milliseconds a call of ``fn`` (:func:`cuda_timed`)."""
    return cuda_timed(fn, iters)[0]


def sample_flops(net, composite=True):
    """Floating-point operations of one evaluated sample, from the weight
    shapes: Fourier projection, the MLP's multiply-adds, the trilerp of
    16 channels over 8 corners with its weights, and with ``composite``
    TF and compositing (the sample evaluator does neither)."""
    f = net.input.num_fourier
    mlp = sum(l.weight.numel() for l in net.layers)
    trilerp = 8 * 16 * 2 + 8 * 3
    return 2 * (3 * f + mlp) + trilerp + (24 if composite else 0)


def adjoint_flops(net):
    """Operations of one contributing sample's adjoint beyond its forward
    evaluation: the transposed layers (as many multiply-adds as the
    forward), the weight gradient's outer products (one multiply-add per
    parameter), d_cos/d_sin -> d_B and the trilerp adjoint. (The backward
    kernel also evaluates each contributing sample's MLP a second time;
    that is its own choice, work done and not part of the bound.)"""
    f = net.input.num_fourier
    params = sum(p.numel() for n, p in net.named_parameters()
                 if not n.startswith("latent."))
    mlp = sum(l.weight.numel() for l in net.layers)
    return 2 * mlp + 2 * params + 4 * f + 8 * 16 * 2


def ptxas_summary(name):
    """Registers, stack, spills and shared memory of each kernel instance
    in ``name``'s ptxas report, one line each."""
    from fvsrn_tpu_torch.ops import _build

    lines, props = [], None
    for line in _build.ptxas_report(name).splitlines():
        if "Function properties for" in line:
            props = line.split("for ")[-1].strip()
        elif props and ("stack frame" in line or "registers" in line):
            lines.append(f"{props}: {line.strip()}")
    return "; ".join(lines)


def ptxas_instances(name, kernel):
    """{instance: (registers, spill store bytes, spill load bytes)} of
    every instance of the kernel template ``kernel`` in ``name``'s ptxas
    report, an instance named by its template arguments."""
    import re

    from fvsrn_tpu_torch.ops import _build

    found = {}
    for fn, v in _build.ptxas_instances(_build.ptxas_report(name)).items():
        m = re.search(kernel + r"I(Li(\d+)E)?N5march\d+(\w+?Table)", fn)
        if m:
            found[(f"H{m.group(2)} " if m.group(2) else "")
                  + m.group(3)] = v[:3]
    return found


def rel_err(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def grads_of(net, tf_leaf):
    g = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    g["tf"] = tf_leaf.grad.detach().clone()
    return g


def cuda_once(fn):
    """(result, device milliseconds) of one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def training(smi, reset_counts, counts, npz, tf, cam):
    """Phases 7-10, the second main path: screen-space training. Returns
    the kernels' JSON rows."""
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               probe_saturation_tmax)
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train.checkpoints import load_weights
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    n_rays = WIDTH * HEIGHT

    # 7. the second main path: the trainer's entry point
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    opt = vars(train_main.init_parser().parse_args(
        TRAIN_ARGS[:1] + [os.path.join(out_dir, "train_run.npz")]
        + TRAIN_ARGS[1:]))
    steps = opt["screen_cameras"] * opt["epochs"]
    reset_counts()
    t0 = time.perf_counter()
    result = train_main.run(opt)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts()
    hist = result["history"]
    print(f"phase 7 trainer: train.main.run screen {WIDTH}x{HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)}, {steps} steps in {train_s:.1f} s "
          f"(dataset included), fused {result['fused']}, losses {hist}, "
          f"launches {train_counts}", flush=True)
    check(result["fused"], "the trainer did not take the fused route")
    check(len(hist) == opt["epochs"] and all(math.isfinite(v) for v in hist),
          f"losses {hist}")
    check(train_counts["mega_fwd_diff"] >= steps
          and train_counts["mega_bwd"] >= steps,
          f"the trainer launched {train_counts} in {steps} steps")

    # 8. kernels vs their plain version at full frame: dense flagship, L1
    # loss against the implicit field's render at the smoke camera
    net = load_weights(npz).to(dev)
    tf_d = tf.tensor.to(dev)
    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    rs = rs.reshape(-1, 3)[perm].contiguous()
    rd = rd.reshape(-1, 3)[perm].contiguous()
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    steps_max = max_steps_bound(box[1], STEPSIZE)
    with torch.no_grad():
        target = trace_dvr(rs, rd, VolumeInterpolationImplicit.make(
            "MARSCHNER_LOBB", device=dev), tf.to(dev), cfg,
            steps_max).color

    def fwd_bwd(fn, rays_s, rays_d, cotangent, **kw):
        """(image, samples, grads, fwd ms, bwd ms) of one fwd+bwd, the
        backward seeded with ``cotangent(image)``."""
        net.zero_grad(set_to_none=True)
        tf_leaf = tf_d.clone().requires_grad_(True)
        (img, samples), f_ms = cuda_once(lambda: fn(
            rays_s, rays_d, net, *box, tf_leaf, stepsize=STEPSIZE,
            differentiable=True, return_samples=True, **kw))
        d_out = cotangent(img.detach())
        _, b_ms = cuda_once(lambda: img.backward(d_out))
        return img.detach(), samples, grads_of(net, tf_leaf), f_ms, b_ms

    def l1(img):
        return (img - target).abs().mean()

    l1_seed = {}

    def l1_cotangent(img):
        """The L1 loss's cotangent sign(img - target) / n, taken from the
        first image it sees (the plain one) and reused: where the two
        images straddle the target by ~1e-6 its sign would differ."""
        if "d" not in l1_seed:
            l1_seed["d"] = torch.sign(img - target) / img.numel()
        return l1_seed["d"]

    img_p, samples_p, g_p, plain_fwd_ms, plain_bwd_ms = fwd_bwd(
        fused_mega.mega_trace_dvr_plain, rs, rd, l1_cotangent)
    fwd_bwd(fused_mega.mega_trace_dvr, rs, rd, l1_cotangent)  # warm-up
    img_k, samples_k, g_k, _, _ = fwd_bwd(fused_mega.mega_trace_dvr, rs, rd,
                                          l1_cotangent)
    img_err = float((img_k - img_p).abs().max())
    grad_rel = {n: rel_err(g_k[n], g_p[n]) for n in g_p}
    grad_abs = max(float((g_k[n] - g_p[n]).abs().max()) for n in g_p)
    worst = max(grad_rel, key=grad_rel.get)
    print(f"phase 8 kernels vs plain, full frame: image max|d| "
          f"{img_err:.3e} (tol {KERNEL_TOL}), samples "
          f"{int(samples_k.sum())} vs {int(samples_p.sum())}, grad rel "
          f"norm err max {grad_rel[worst]:.3e} ({worst}, tol {GRAD_TOL}), "
          f"grad max|d| {grad_abs:.3e}; plain fwd {plain_fwd_ms:.1f} ms, "
          f"bwd {plain_bwd_ms:.1f} ms", flush=True)
    print("  per leaf: " + ", ".join(f"{n} {v:.2e}"
                                     for n, v in grad_rel.items()))
    check(img_err <= KERNEL_TOL, f"image kernel vs plain {img_err}")
    check(all(float(g.norm()) > 0 for g in g_p.values()), "a zero gradient")
    check(grad_rel[worst] <= GRAD_TOL, f"grad kernel vs plain {grad_rel}")

    # 9. kernels vs autograd through the f32 lattice oracle on 64 whole
    # tiles of the product render's rays and saturation clip
    vol = VolumeInterpolationNetwork(net, *box)
    with torch.no_grad():
        clip = probe_saturation_tmax(rs, rd, vol, tf.to(dev),
                                     stepsize=STEPSIZE, max_steps=steps_max,
                                     coarse=8, margin_steps=16)
    tiles = torch.arange(0, n_rays // 256, n_rays // 256 // ORACLE_TILES,
                         device=dev)[:ORACLE_TILES]
    sel = (tiles[:, None] * 256 + torch.arange(256, device=dev)).reshape(-1)
    o_rs, o_rd, o_clip = rs[sel], rd[sel], clip[sel]

    def sq(img):
        return (img ** 2).mean()

    img_o, _, g_o, _, _ = fwd_bwd(fused_mega.mega_trace_dvr, o_rs, o_rd,
                                  lambda img: 2.0 * img / img.numel(),
                                  tmax_clip=o_clip)
    net.zero_grad(set_to_none=True)
    tf_leaf = tf_d.clone().requires_grad_(True)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)
    ref = trace_dvr(o_rs, o_rd, vol, type(tf)(tf_leaf), ocfg, steps_max,
                    tmax_in=o_clip, lattice=True, checkpoint_chunk=64).color
    sq(ref).backward()
    g_ref = grads_of(net, tf_leaf)
    o_img_err = float((img_o - ref.detach()).abs().max())
    o_grad = {n: rel_err(g_o[n], g_ref[n]) for n in g_ref}
    o_worst = max(o_grad, key=o_grad.get)
    print(f"phase 9 kernels vs f32 lattice oracle, {sel.numel()} rays: "
          f"image max|d| {o_img_err:.3e} (tol {ORACLE_TOL}), grad rel norm "
          f"err max {o_grad[o_worst]:.3e} ({o_worst}, tol {ORACLE_GRAD_TOL})",
          flush=True)
    check(o_img_err < ORACLE_TOL, f"image kernel vs oracle {o_img_err}")
    check(o_grad[o_worst] < ORACLE_GRAD_TOL, f"grad vs oracle {o_grad}")

    # 10. timing: one training step (fwd, loss, bwd, Adam) on the flagship
    tnet = copy.deepcopy(net)
    opt_, sched = make_optimizer(tnet.parameters(), "Adam", lr=1e-3)

    def train_step():
        opt_.zero_grad(set_to_none=True)
        img = fused_mega.mega_trace_dvr(rs, rd, tnet, *box, tf_d,
                                        stepsize=STEPSIZE,
                                        differentiable=True)
        l1(img).backward()
        opt_.step()
        sched.step()

    step_ms = cuda_ms(train_step, TIMED_STEPS)
    spec = fused_mega._spec(net, *box, stepsize=STEPSIZE, seg=32, tile=256,
                            density_min=0.0, density_max=1.0,
                            enable_early_out=True)
    rays = fused_mega.ray_packet(rs, rd, *box, STEPSIZE)
    params = fused_mega._params(net, tf_d)
    widths = fused_mega._widths(params)
    weights = fused_mega._pack_weights(params, spec)
    table = fused_mega.latent_table(params[2], torch.float32)
    n_seg = fused_mega.segments_needed(rays, spec)
    fwd = fused_mega._launch_fwd(rays, weights, table, spec, *widths[:3],
                                 n_seg_max=n_seg)
    d_out = torch.sign(fwd[0] - target) / fwd[0].numel()
    fwd_ms = cuda_ms(lambda: fused_mega._launch_fwd(
        rays, weights, table, spec, *widths[:3], n_seg_max=n_seg),
        TIMED_STEPS)
    bwd_ms = cuda_ms(lambda: fused_mega._launch_bwd(
        rays, weights, table, fwd[2], fwd[3], d_out, spec, *widths),
        TIMED_STEPS)
    # the same backward with no latent channel scatters no atomics: the
    # difference is the latent-gradient scatter's share of the kernel
    no_scatter_ms = cuda_ms(lambda: fused_mega._launch_bwd(
        rays, weights, table, fwd[2], fwd[3], d_out, spec, *widths[:3], 0),
        TIMED_STEPS)
    scatter_share = 1.0 - no_scatter_ms / bwd_ms
    work = fused_mega._launch_bwd(rays, weights, table, fwd[2], fwd[3],
                                  d_out, spec, *widths)[2].sum(dim=0)
    n_samples = int(fwd[1].sum())
    n_replayed, n_contrib = int(work[0]), int(work[1])
    carries_bytes = int(fwd[3].sum()) * 256 * 16
    table_bytes = table.numel() * 4
    fwd_flops = n_samples * sample_flops(net)
    fwd_bytes = (n_rays * (32 + 16) + carries_bytes + table_bytes
                 + weights.numel() * 4)
    bwd_flops = (n_replayed * sample_flops(net)
                 + n_contrib * adjoint_flops(net))
    bwd_work_flops = bwd_flops + n_contrib * sample_flops(net)
    bwd_bytes = (n_rays * (32 + 16) + carries_bytes + 2 * table_bytes
                 + rays.shape[0] // 256 * weights.numel() * 4)

    def bound(flops, nbytes, peak):
        return max(flops / peak, nbytes / PEAK_BYTES) * 1e3

    rows = []
    for name, replaces, ms, plain, flops, nbytes, err_, extra in (
            ("mega_fwd_diff", "fvsrn_tpu/ops/fused_mega.py:962", fwd_ms,
             plain_fwd_ms, fwd_flops, fwd_bytes, img_err,
             {"samples": n_samples, "ptxas": ptxas_summary("mega_fwd")}),
            ("mega_bwd", "fvsrn_tpu/ops/fused_mega.py:1023", bwd_ms,
             plain_bwd_ms, bwd_flops, bwd_bytes, grad_abs,
             {"grad_rel_err": grad_rel[worst], "samples_replayed":
              n_replayed, "samples_contributing": n_contrib,
              "no_scatter_ms": no_scatter_ms,
              "scatter_share": scatter_share,
              "work_gflop": bwd_work_flops / 1e9,
              "ptxas": ptxas_summary("mega_bwd")})):
        b_tc = bound(flops, nbytes, PEAK_BF16_TC)
        b_32 = bound(flops, nbytes, PEAK_F32)
        by = ("operations" if flops / PEAK_BF16_TC > nbytes / PEAK_BYTES
              else "bytes")
        print(f"phase 10 {name} [{smi}]: {ms:.3f} ms/launch, plain "
              f"{plain:.1f} ms; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} "
              f"MB; bound {b_tc:.4f} ms (bf16 tensor cores, share "
              f"{b_tc / ms:.4f}), {b_32:.4f} ms (f32 CUDA cores, share "
              f"{b_32 / ms:.4f}), bound by {by}", flush=True)
        rows.append(dict({
            "name": name, "route": "cuda",
            "source": "fvsrn_tpu_torch/csrc/" + ("mega_bwd.cu"
                                                 if name == "mega_bwd"
                                                 else "mega_fwd.cu"),
            "replaces": replaces, "launches": train_counts[name],
            "max_abs_err": err_, "ms": ms, "plain_ms": plain,
            "bound_ms": b_tc, "bound_by": by,
            "library_ms": None, "bound_f32_ms": b_32,
            "oracle_max_abs_err": o_img_err,
            "oracle_grad_rel_err": o_grad[o_worst]}, **extra))
    print(f"phase 10 training step [{smi}]: {step_ms:.3f} ms/step "
          f"(fwd + L1 + bwd + Adam, mean of {TIMED_STEPS} after a warm-up), "
          f"{n_rays / step_ms / 1e3:.3f} Mrays/s; kernels fwd {fwd_ms:.3f} "
          f"+ bwd {bwd_ms:.3f} ms (without the latent scatter "
          f"{no_scatter_ms:.3f} ms, scatter share {scatter_share:.3f}); "
          f"plain fwd+bwd "
          f"{plain_fwd_ms + plain_bwd_ms:.1f} ms; backward work done "
          f"{bwd_work_flops / 1e9:.1f} GFLOP (the bound's "
          f"{bwd_flops / 1e9:.1f} plus the MLP recomputed); "
          f"samples/step {n_samples} "
          f"(replayed {n_replayed}, contributing {n_contrib}), carries "
          f"{carries_bytes / 1e6:.1f} MB, n_seg_max {n_seg}", flush=True)
    return rows


def max_err(a, b):
    return float((a - b).abs().max())


def segment_paths(smi, reset_counts, counts, npz, tf, cam):
    """Phases A-E: the FUSED renders of the per-segment engine. Returns
    the kernel's JSON row."""
    import numpy as np

    from fvsrn_tpu_torch.camera import camera_matrix, generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel, pad_rays
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops.fused_dvr import (fused_trace_dvr,
                                               fused_trace_dvr_plain,
                                               mega_supported)
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.raytracer.iso import RayEvaluationSteppingIso
    from fvsrn_tpu_torch.train.checkpoints import load_weights

    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    steps_max = max_steps_bound((1.0, 1.0, 1.0), STEPSIZE)
    flagship = LoadedModel.from_checkpoint(npz, tf=tf, config=cfg)
    errs = {}

    def drive(name, model, width, height, route):
        """Render one frame through the entry point with the counts reset
        just before; check the route, the launches and the image."""
        render = model.prepare_network_render(cam, width, height, "FUSED")
        reset_counts()
        img = render()
        torch.cuda.synchronize()
        c = counts()
        check(render.route == route, f"{name}: route {render.route}")
        check(c["segment_fwd"] > 0 and c["mega_fwd"] == 0,
              f"{name}: launches {c}")
        check(tuple(img.shape) == (height, width, 4), f"{name}: shape")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        return render, img, c

    def vs_plain(name, render):
        (got, st), k_ms = cuda_once(lambda: render.march(return_stats=True))
        (want, st_p), p_ms = cuda_once(lambda: render.march(
            fused_trace_dvr_plain, return_stats=True))
        errs[name] = max_err(got, want)
        check(errs[name] <= KERNEL_TOL, f"{name}: kernel vs plain "
              f"{errs[name]}")
        return got, st, st_p, p_ms

    def per_ray_oracle(render, n):
        vol = VolumeInterpolationNetwork(render.network, (-0.5,) * 3,
                                         (1.0,) * 3)
        with torch.no_grad():
            return trace_dvr(render.ray_start[:n], render.ray_dir[:n], vol,
                             render.tf, cfg, steps_max).color

    # A. route 2 of the dense flagship: 1920x1080 is no multiple of 16
    n_a = SEG_WIDTH * SEG_HEIGHT
    render, img, c_a = drive("phase A", flagship, SEG_WIDTH, SEG_HEIGHT,
                             "segment")
    got, st, st_p, plain_ms = vs_plain("A", render)
    stop, samples = int(st.stop), int(st.samples)
    scheduled = render.ray_start.shape[0] * stop * 32
    oracle = per_ray_oracle(render, n_a)
    oerr = max_err(got[:n_a], oracle)
    check(oerr < ORACLE_TOL, f"phase A: vs per-ray trace_dvr {oerr}")
    mean_ms, std_ms, frames = flagship.time_rendering(
        LoadedModel.rotation_cameras(TIMED_CAMERAS), SEG_WIDTH, SEG_HEIGHT)
    kernel_ms = cuda_ms(lambda: render.march(), 3)
    flops = samples * sample_flops(render.network)
    io_bytes = (render.ray_start.shape[0] * (8 + 4) * 4
                + render.network.latent.static_grid.numel() * 2 + 15_000)
    bound_s = max(flops / PEAK_BF16_TC, io_bytes / PEAK_BYTES)
    bound_f32_s = max(flops / PEAK_F32, io_bytes / PEAK_BYTES)
    bound_by = ("operations" if flops / PEAK_BF16_TC > io_bytes / PEAK_BYTES
                else "bytes")
    print(f"phase A route 2 [{smi}]: flagship {SEG_WIDTH}x{SEG_HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)}, launches {c_a}, kernel vs plain "
          f"max|d| {errs['A']:.3e} (tol {KERNEL_TOL}), vs per-ray f32 "
          f"trace_dvr {oerr:.3e} (tol {ORACLE_TOL}); stop S {stop} (plain "
          f"{int(st_p.stop)}), samples valid {samples} (plain "
          f"{int(st_p.samples)}), scheduled R*S*seg {scheduled}; frame "
          f"{mean_ms:.3f} ms (std {std_ms:.3f}, {len(frames)} cameras), "
          f"{n_a / mean_ms / 1e3:.3f} Mrays/s; kernel {kernel_ms:.3f} ms "
          f"({kernel_ms * 1e6 / samples:.3f} ns/valid sample); plain "
          f"{plain_ms:.1f} ms; bound {bound_s * 1e3:.4f} ms (bf16 tensor "
          f"cores, share {bound_s * 1e3 / kernel_ms:.4f}), "
          f"{bound_f32_s * 1e3:.4f} ms (f32 CUDA cores, share "
          f"{bound_f32_s * 1e3 / kernel_ms:.4f}), bound by {bound_by} "
          f"({flops / 1e9:.1f} GFLOP)", flush=True)

    # B. route 2, no latent grid: the trainer's default network
    net_b = SceneRepresentationNetwork.make(
        layers="32:32:32", activation="SnakeAlt:2",
        output_mode="density:direct", num_fourier=14, seed=42)
    render, _, c_b = drive("phase B", LoadedModel(net_b, tf, config=cfg),
                           WIDTH, HEIGHT, "segment")
    _, st, _, _ = vs_plain("B", render)
    print(f"phase B route 2, no grid: {WIDTH}x{HEIGHT}, launches {c_b}, "
          f"kernel vs plain max|d| {errs['B']:.3e}, S {int(st.stop)}, "
          f"samples {int(st.samples)}", flush=True)

    # C. route 2, color output, 24 channels (float32 features)
    rng = np.random.default_rng(7)
    grid = torch.from_numpy((rng.standard_normal((24, 32, 32, 32)) * 0.5
                             ).astype(np.float32))
    net_c = SceneRepresentationNetwork.make(
        layers="48:48:48", activation="Sine:3", output_mode="rgbo",
        num_fourier=14, latent=LatentSpace(static_grid=grid), seed=7)
    render, img, c_c = drive("phase C", LoadedModel(net_c, tf, config=cfg),
                             RGBO_SIZE, RGBO_SIZE, "segment")
    got, st, _, _ = vs_plain("C", render)
    n_c = RGBO_SIZE * RGBO_SIZE
    oerr_c = max_err(got[:n_c], per_ray_oracle(render, n_c))
    check(oerr_c < ORACLE_TOL, f"phase C: vs per-ray trace_dvr {oerr_c}")
    print(f"phase C route 2, rgbo 48:48:48 Sine:3, 24x32^3 grid: "
          f"{RGBO_SIZE}x{RGBO_SIZE}, launches {c_c}, kernel vs plain "
          f"max|d| {errs['C']:.3e}, vs per-ray trace_dvr {oerr_c:.3e}, "
          f"S {int(st.stop)}, alpha max {float(img[..., 3].max()):.3f}",
          flush=True)

    # D. route 1b: a 16x64^3 grid fails the megakernel's slab budget
    net_d = load_weights(npz)
    g = net_d.latent.static_grid
    with torch.no_grad():
        net_d.latent.static_grid = torch.nn.Parameter(torch.from_numpy((
            np.random.default_rng(11).standard_normal((16, 64, 64, 64))
            * float(g.std())).astype(np.float32)))
    check(not mega_supported((16, 64, 64, 64), torch.bfloat16),
          "phase D: the grid fits the slab")
    render, _, c_d = drive("phase D", LoadedModel(net_d, tf, config=cfg),
                           WIDTH, HEIGHT, "bucketed")
    _, st, _, _ = vs_plain("D", render)
    print(f"phase D route 1b, flagship net with a 16x64^3 grid: "
          f"{WIDTH}x{HEIGHT}, {len(render.plan.group_sizes)} buckets, "
          f"launches {c_d}, kernel vs plain max|d| {errs['D']:.3e}, "
          f"stops {st.stop.tolist()}, samples {int(st.samples)}", flush=True)

    # E. the isosurface render, FUSED (f32 table) and FUSED_BF16. A ray
    # whose first-hit sample lies within float32 noise (~1e-6) of the
    # isovalue can flip to the next sample between two evaluations of the
    # network; bisection then brackets the crossing from the other side
    # and the shade moves by ~1e-4 (a bf16 table flips many more rays,
    # some from hit to miss). So the iso checks bound the share of rays
    # off the tolerance, and print the largest difference.
    iso = RayEvaluationSteppingIso.make(stepsize=STEPSIZE,
                                        isovalue=ISO_VALUE)
    want = flagship.render_network_iso(cam, WIDTH, HEIGHT, iso, "PLAIN32")
    hit = float((want[..., 3] > 0.5).float().mean())
    check(0.05 < hit < 0.95, f"phase E: hit share {hit}")
    rs, rd = generate_rays(camera_matrix(cam), WIDTH, HEIGHT,
                           cam.fov_y_radians, device=DEVICE)
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), 128)
    raw_args = (rs, rd, copy.deepcopy(flagship.network).to(DEVICE),
                (-0.5,) * 3, (1.0,) * 3, tf.tensor.to(DEVICE))
    raw_kw = dict(stepsize=STEPSIZE, max_steps=steps_max, seg=32, tile=128,
                  iso_value=ISO_VALUE)
    raw_k = fused_trace_dvr(*raw_args, **raw_kw)
    raw_p = fused_trace_dvr_plain(*raw_args, **raw_kw)
    flips = float(((raw_k[:, 3] != raw_p[:, 3])
                   | ((raw_k[:, 3] > 0.5) & (raw_k[:, 0] != raw_p[:, 0])))
                  .float().mean())
    print(f"phase E iso march kernel vs plain, {WIDTH}x{HEIGHT}: first-hit "
          f"samples differing on {flips:.2e} of the rays (limit "
          f"{ISO_FLIP_SHARE}), depth max|d| {max_err(raw_k, raw_p):.3e}",
          flush=True)
    check(flips <= ISO_FLIP_SHARE, f"phase E: iso march flips {flips}")
    for mode, tol, share_max in (("FUSED", KERNEL_TOL, ISO_FLIP_SHARE),
                                 ("FUSED_BF16", ORACLE_TOL,
                                  ISO_BF16_SHARE)):
        reset_counts()
        (out, st), ms = cuda_once(lambda: flagship.render_network_iso(
            cam, WIDTH, HEIGHT, iso, mode, return_stats=True))
        c_e = counts()
        check(c_e["segment_fwd"] > 0, f"phase E {mode}: launches {c_e}")
        diff = (out - want).abs().amax(dim=-1)
        off = float((diff > tol).float().mean())
        errs["E " + mode] = float(diff.max())
        print(f"phase E iso {mode}: {WIDTH}x{HEIGHT}, isovalue {ISO_VALUE},"
              f" hit share {hit:.4f}, launches {c_e}, vs PLAIN32 trace_iso: "
              f"pixels off {tol} {off:.2e} (limit {share_max}), max|d| "
              f"{errs['E ' + mode]:.3e}; S {int(st.stop)}, samples "
              f"{int(st.samples)}, render {ms:.1f} ms", flush=True)
        check(off <= share_max, f"phase E {mode}: {off} of the pixels off")

    return {
        "name": "segment_fwd", "route": "cuda",
        "source": "fvsrn_tpu_torch/csrc/segment_fwd.cu",
        "replaces": "fvsrn_tpu/ops/fused_dvr.py:1626",
        "launches": c_a["segment_fwd"],
        "max_abs_err": max(errs[k] for k in "ABCD"),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": bound_by, "library_ms": None, "bound_f32_ms": bound_f32_s * 1e3,
        "frame_ms": mean_ms, "stop": stop, "samples_valid": samples,
        "samples_scheduled": scheduled, "oracle_max_abs_err": oerr,
        "phase_errors": errs, "iso_hit_share": hit,
        "ptxas": ptxas_summary("segment_fwd")}


def scan_training(smi, reset_counts, counts, npz, tf, cam):
    """Phases F-G: screen training through the per-segment engine's
    differentiable march. Returns the two kernels' JSON rows."""
    import numpy as np

    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_trace_dvr,
                                               fused_trace_dvr_plain)
    from fvsrn_tpu_torch.ops.fused_dvr_bwd import launch_segment_bwd
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.train.checkpoints import load_weights
    from fvsrn_tpu_torch.train.losses import LossNetScreen
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.train.screen import (build_screen_dataset,
                                              evaluate_screen, train_screen)
    from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

    dev = torch.device("cuda")
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    steps_max = max_steps_bound(box[1], STEPSIZE)
    scan_kw = dict(stepsize=STEPSIZE, max_steps=steps_max,
                   enable_early_out=False)
    tf_d = tf.tensor.to(dev)
    loss = LossNetScreen(l1=1.0)
    n_rays = WIDTH * HEIGHT

    # F. the slice's main path: train_screen on the scan engine (no
    # fused_kwargs: evaluate_screen's default engine)
    ds = build_screen_dataset(VolumeInterpolationImplicit.make(
        "MARSCHNER_LOBB"), tf, cfg, num_cameras=2, width=WIDTH,
        height=HEIGHT, device=dev)
    net = load_weights(npz).to(dev)
    reset_counts()
    t0 = time.perf_counter()
    _, hist = train_screen(net, ds, tf, cfg, loss, make_optimizer(
        net.parameters(), "Adam", lr=1e-3), epochs=1, max_steps=steps_max,
        use_fused=True, fused_kwargs=None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    c_f = counts()
    print(f"phase F train_screen, scan engine: {WIDTH}x{HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)}, 2 cameras x 1 epoch in "
          f"{train_s:.1f} s, losses {hist}, launches {c_f}", flush=True)
    check(len(hist) == 1 and all(math.isfinite(v) for v in hist),
          f"phase F: losses {hist}")
    check(c_f["segment_fwd_diff"] >= 2 and c_f["segment_bwd"] >= 2
          and c_f["mega_fwd_diff"] == 0 and c_f["mega_bwd"] == 0,
          f"phase F: launches {c_f}")

    # F. timing: one training step (fwd, L1, bwd, Adam) and each kernel
    tnet = copy.deepcopy(net)
    tf_dev = tf.to(dev)
    opt_, sched = make_optimizer(tnet.parameters(), "Adam", lr=1e-3)

    def train_step():
        opt_.zero_grad(set_to_none=True)
        total, _ = evaluate_screen(tnet, ds.ray_start[:1], ds.ray_dir[:1],
                                   ds.targets[:1], tf_dev, cfg, loss,
                                   steps_max, WIDTH, HEIGHT, use_fused=True)
        total.backward()
        opt_.step()
        sched.step()

    step_ms = cuda_ms(train_step, TIMED_STEPS)
    # each kernel alone, on the smoke camera's rays (row-major, as the scan
    # route takes them)
    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    spec, rays, kbase = fused_dvr._segment_setup(
        rs, rd, net, *box, density_min=0.0, density_max=1.0,
        blend_mode="beer_lambert", alpha_early_out=0.999, seg=32, tile=256,
        differentiable=True, latent_mode="table", table_dtype=torch.float32,
        n_seg=None, need_normals=False, iso_value=None, tf_mode="piecewise",
        tmax_clip=None, **scan_kw)
    weights = fused_dvr.pack_segment_weights(net, tf_d)
    table = fused_dvr.segment_table(net, torch.float32, dev)
    fwd_args = (spec, net, rays, kbase, weights, table, tf_d.shape[0])
    out, st, carries, death = fused_dvr.launch_segment(*fwd_args,
                                                       store_carries=True)
    d_out = torch.empty(out.shape, device=dev).uniform_(
        -1, 1, generator=torch.Generator(dev).manual_seed(3)) / out.numel()
    bwd_args = (spec, net, rays, kbase, weights, table, carries, death,
                d_out, tf_d.shape[0])
    fwd_ms = cuda_ms(lambda: fused_dvr.launch_segment(
        *fwd_args, store_carries=True), TIMED_STEPS)
    bwd_ms = cuda_ms(lambda: launch_segment_bwd(*bwd_args), TIMED_STEPS)
    # the same backward scattering no latent gradient: the difference is
    # the scatter's share of the kernel
    no_scatter_ms = cuda_ms(lambda: launch_segment_bwd(*bwd_args, n_lat=0),
                            TIMED_STEPS)
    scatter_share = 1.0 - no_scatter_ms / bwd_ms
    work = launch_segment_bwd(*bwd_args)[2]
    n_valid, n_replayed, n_contrib = (int(st.samples), int(work[0]),
                                      int(work[1]))
    carry_bytes = int(death.sum()) * 16
    stop = int(st.stop)

    def run(fn, rs_, rd_, net_, cotangent=None, **kw):
        """(image, grads, fwd ms, bwd ms, cotangent) of one fwd+bwd of the
        scan engine's differentiable march, seeded with ``cotangent`` or
        with that of mean(image^2). (A coherent loss: under a random-sign
        cotangent each leaf's gradient is a cancelling sum whose norm
        grows like sqrt(samples), and one strictly gated sample that
        flips on float32 noise reads ~1/sqrt(samples) relative.)"""
        net_.zero_grad(set_to_none=True)
        tf_leaf = tf_d.clone().requires_grad_(True)
        img, f_ms = cuda_once(lambda: fn(rs_, rd_, net_, *box, tf_leaf,
                                         differentiable=True,
                                         **dict(scan_kw, **kw)))
        if cotangent is None:
            cotangent = 2.0 * img.detach() / img.numel()
        _, b_ms = cuda_once(lambda: img.backward(cotangent))
        g = {n: p.grad.detach().clone() for n, p in net_.named_parameters()}
        if not net_.output_mode.startswith("rgbo"):   # rgbo reads no TF
            g["tf"] = tf_leaf.grad.detach().clone()
        return img.detach(), g, f_ms, b_ms, cotangent

    errs = {}

    def vs_plain(name, rs_, rd_, net_, **kw):
        """Kernels vs the plain pair on the same inputs; returns the plain
        fwd and bwd ms."""
        img_p, g_p, p_f, p_b, cot = run(fused_trace_dvr_plain, rs_, rd_,
                                        net_, **kw)
        img_k, g_k, _, _, _ = run(fused_trace_dvr, rs_, rd_, net_, cot, **kw)
        rel = {n: rel_err(g_k[n], g_p[n]) for n in g_p}
        worst = max(rel, key=rel.get)
        errs[name] = (max_err(img_k, img_p),
                      max(max_err(g_k[n], g_p[n]) for n in g_p), rel[worst])
        print(f"  {name}: {rs_.shape[0]} rays, image max|d| "
              f"{errs[name][0]:.3e} (tol {KERNEL_TOL}), grad rel norm err "
              f"max {rel[worst]:.3e} ({worst}, tol {GRAD_TOL}), grad max|d| "
              f"{errs[name][1]:.3e}; plain fwd {p_f:.1f} ms, bwd "
              f"{p_b:.1f} ms", flush=True)
        check(errs[name][0] <= KERNEL_TOL, f"{name}: image {errs[name]}")
        check(all(float(g.norm()) > 0 for g in g_p.values()),
              f"{name}: a zero gradient")
        check(rel[worst] <= GRAD_TOL, f"{name}: gradients {rel}")
        return p_f, p_b

    print(f"phase F kernels vs plain pair, full frame:", flush=True)
    plain_fwd_ms, plain_bwd_ms = vs_plain("F flagship 512", rs, rd, net)

    # G. kernels vs the plain pair on more of what the engine serves
    print("phase G kernels vs plain pair:", flush=True)
    rs_g, rd_g = generate_rays(cam, 256, 256, device=dev)
    vs_plain("G flagship 256", rs_g.reshape(-1, 3), rd_g.reshape(-1, 3), net)
    rng = np.random.default_rng(7)
    grid = torch.from_numpy((rng.standard_normal((24, 32, 32, 32)) * 0.5
                             ).astype(np.float32))
    net_c = SceneRepresentationNetwork.make(
        layers="48:48:48", activation="Sine:3", output_mode="rgbo",
        num_fourier=14, latent=LatentSpace(static_grid=grid),
        use_direction=True, disable_direction_in_fourier=False,
        seed=7).to(dev)
    rs_c, rd_c = generate_rays(cam, 64, 64, device=dev)
    vs_plain("G rgbo 48:48:48 Sine:3 24ch dir 64", rs_c.reshape(-1, 3),
             rd_c.reshape(-1, 3), net_c)
    rs_l, rd_l = generate_rays(cam, 128, 128, device=dev)
    perm, _ = block_ray_permutation(128, 128, 16, 16, device=dev)
    vs_plain("G flagship lattice 128", rs_l.reshape(-1, 3)[perm],
             rd_l.reshape(-1, 3)[perm], net, latent_mode="boxfeat")

    # G. kernels vs autograd through the plain per-ray f32 march, on 64
    # row-major tiles spread over the frame
    tiles = torch.arange(0, n_rays // 256, n_rays // 256 // ORACLE_TILES,
                         device=dev)[:ORACLE_TILES]
    sel = (tiles[:, None] * 256 + torch.arange(256, device=dev)).reshape(-1)
    o_rs, o_rd = rs[sel].contiguous(), rd[sel].contiguous()
    img_o, g_o, _, _, _ = run(fused_trace_dvr, o_rs, o_rd, net)
    net.zero_grad(set_to_none=True)
    tf_leaf = tf_d.clone().requires_grad_(True)
    ref = trace_dvr(o_rs, o_rd, VolumeInterpolationNetwork(net, *box),
                    type(tf)(tf_leaf),
                    RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                                  enable_early_out=False),
                    steps_max, checkpoint_chunk=64).color
    (ref ** 2).mean().backward()
    g_ref = grads_of(net, tf_leaf)
    o_img = max_err(img_o, ref.detach())
    o_rel = {n: rel_err(g_o[n], g_ref[n]) for n in g_ref}
    o_worst = max(o_rel, key=o_rel.get)
    print(f"  vs autograd through the per-ray f32 trace_dvr, {sel.numel()} "
          f"rays: image max|d| {o_img:.3e} (tol {ORACLE_TOL}), grad rel "
          f"norm err max {o_rel[o_worst]:.3e} ({o_worst}, tol "
          f"{ORACLE_GRAD_TOL})", flush=True)
    check(o_img < ORACLE_TOL, f"phase G: image vs oracle {o_img}")
    check(o_rel[o_worst] < ORACLE_GRAD_TOL, f"phase G: grads vs oracle "
          f"{o_rel}")

    table_bytes = table.numel() * 4
    ray_bytes = n_rays * (32 + 16)
    fwd_flops = n_valid * sample_flops(net)
    fwd_bytes = (ray_bytes + carry_bytes + n_rays * 4 + table_bytes
                 + weights.numel() * 4)
    bwd_flops = (n_replayed * sample_flops(net)
                 + n_contrib * adjoint_flops(net))
    bwd_bytes = (ray_bytes + carry_bytes + n_rays * 4 + 2 * table_bytes
                 + 2 * weights.numel() * 4)

    def bound(flops, nbytes, peak):
        return max(flops / peak, nbytes / PEAK_BYTES) * 1e3

    img_err = max(e[0] for e in errs.values())
    grad_abs = max(e[1] for e in errs.values())
    grad_rel = max(e[2] for e in errs.values())
    rows = []
    for name, replaces, source, ms, plain, flops, nbytes, err_ in (
            ("segment_fwd_diff", "fvsrn_tpu/ops/fused_dvr_bwd.py:1144",
             "segment_fwd.cu", fwd_ms, plain_fwd_ms, fwd_flops, fwd_bytes,
             img_err),
            ("segment_bwd", "fvsrn_tpu/ops/fused_dvr_bwd.py:1272",
             "segment_bwd.cu", bwd_ms, plain_bwd_ms, bwd_flops, bwd_bytes,
             grad_abs)):
        b_tc = bound(flops, nbytes, PEAK_BF16_TC)
        b_32 = bound(flops, nbytes, PEAK_F32)
        by = ("operations" if flops / PEAK_BF16_TC > nbytes / PEAK_BYTES
              else "bytes")
        print(f"phase F {name} [{smi}]: {ms:.3f} ms/launch, plain "
              f"{plain:.1f} ms; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} "
              f"MB; bound {b_tc:.4f} ms (bf16 tensor cores, share "
              f"{b_tc / ms:.4f}), {b_32:.4f} ms (f32 CUDA cores, share "
              f"{b_32 / ms:.4f}), bound by {by}", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": "fvsrn_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": c_f[name],
            "max_abs_err": err_, "ms": ms, "plain_ms": plain,
            "bound_ms": b_tc, "bound_by": by, "library_ms": None,
            "bound_f32_ms": b_32, "grad_rel_err": grad_rel,
            "oracle_max_abs_err": o_img,
            "oracle_grad_rel_err": o_rel[o_worst],
            "samples_valid": n_valid, "samples_replayed": n_replayed,
            "samples_contributing": n_contrib, "carry_bytes": carry_bytes,
            "stop": stop, "n_seg": spec.n_seg}
            | ({"no_scatter_ms": no_scatter_ms,
                "scatter_share": scatter_share,
                "ptxas": ptxas_summary("segment_bwd")}
               if name == "segment_bwd"
               else {"ptxas": ptxas_summary("segment_fwd")}))
    print(f"phase F training step, scan engine [{smi}]: {step_ms:.3f} "
          f"ms/step (fwd + L1 + bwd + Adam, mean of {TIMED_STEPS} after a "
          f"warm-up), {n_rays / step_ms / 1e3:.3f} Mrays/s; kernels fwd "
          f"{fwd_ms:.3f} + bwd {bwd_ms:.3f} ms "
          f"({bwd_ms * 1e6 / max(n_valid, 1):.3f} ns/valid sample; without "
          f"the latent scatter {no_scatter_ms:.3f} ms, scatter share "
          f"{scatter_share:.3f}); valid "
          f"samples {n_valid} (replayed {n_replayed}, contributing "
          f"{n_contrib}), stop {stop} of n_seg {spec.n_seg}, carries "
          f"{carry_bytes / 1e6:.1f} MB stored ({spec.n_seg * n_rays * 16 / 1e6:.1f}"
          f" MB allocated)", flush=True)
    return rows


def monte_carlo(smi, reset_counts, counts, npz, tf, cam):
    """Phases H-I: the sample evaluator alone, then Monte-Carlo path
    tracing through it. Returns the kernel's JSON row."""
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr, fused_eval
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer import montecarlo
    from fvsrn_tpu_torch.raytracer.montecarlo import (RayEvaluationMonteCarlo,
                                                      trace_mc)
    from fvsrn_tpu_torch.utils.prng import prng_key

    dev = torch.device("cuda")
    model = LoadedModel.from_checkpoint(npz, tf=tf)
    net = model.network.to(dev)
    box = (model.box_min, model.box_size)
    vol = VolumeInterpolationNetwork(net, *box)
    n = SAMPLE_POSITIONS

    # H. the kernel alone: positions over the box with 20% spill, unit
    # directions (the flagship reads none)
    gen = torch.Generator(dev).manual_seed(0)
    pos = torch.rand(n, 3, device=dev, generator=gen) * 1.4 - 0.7
    d = torch.randn(n, 3, device=dev, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    pos01 = ((pos - vol.box_min) / vol.box_size).contiguous()
    value_k, inside_k = fused_eval.make_fused_eval(net, *box)(pos, d)
    with torch.no_grad():
        _, inside_p = vol.eval_density(pos, d)
    value_p, _ = fused_eval.fused_eval_plain(net, pos01)
    err = max_err(value_k, value_p)
    check(err <= KERNEL_TOL, f"phase H: value kernel vs plain {err}")
    check(bool(torch.equal(inside_k, inside_p)), "phase H: inside masks")
    # the gradient on interior positions where both versions took the
    # same clip gate: a density within float32 noise of a clip edge may
    # clip in one and not the other (counted, bounded by ISO_FLIP_SHARE)
    def clipped(v):
        return (v <= 0.0) | (v >= 1.0)
    inner = (pos.abs() < 0.45).all(dim=1)
    flips = inner & (clipped(value_k) != clipped(value_p))
    n_flips = int(flips.sum())
    check(n_flips <= ISO_FLIP_SHARE * int(inner.sum()),
          f"phase H: {n_flips} clip gates differ")
    inner = inner & ~flips
    _, _, grad_k = fused_eval.make_fused_eval(net, *box, want_grad=True)(
        pos, d)
    _, grad_p = fused_eval.fused_eval_plain(net, pos01, want_grad=True)
    grad_rel = rel_err(grad_k[inner], grad_p[inner] / vol.box_size)
    check(grad_rel <= GRAD_TOL, f"phase H: gradient kernel vs autograd "
          f"{grad_rel}")
    value_bf, _ = fused_eval.make_fused_eval(
        net, *box, table_dtype=torch.bfloat16)(pos, d)
    bf_err = max_err(value_bf, value_p)
    check(bf_err < ORACLE_TOL, f"phase H: bf16 table vs f32 plain {bf_err}")
    no_tf = torch.tensor(fused_eval._NO_TF, device=dev)
    weights = fused_dvr.pack_segment_weights(net, no_tf)
    tables = {dt: fused_dvr.segment_table(net, dt, dev)
              for dt in (torch.float32, torch.bfloat16)}

    def launch(dt=torch.float32, want_grad=False):
        return fused_eval.launch_sample_eval(net, pos01, None, weights,
                                             tables[dt], want_grad)

    def bounds(n_pos):
        """The float32-table evaluator's bound on ``n_pos`` positions: its
        operations (no TF, no compositing) at the bf16 tensor-core and the
        float32 peak, 16 bytes a position plus the table and weights.
        Returns (bf16 TC ms, f32 ms, bound_by)."""
        flops = n_pos * sample_flops(net, composite=False)
        nbytes = (n_pos * 16 + tables[torch.float32].numel() * 4
                  + weights.numel() * 4)
        by = ("operations" if flops / PEAK_BF16_TC > nbytes / PEAK_BYTES
              else "bytes")
        return (max(flops / PEAK_BF16_TC, nbytes / PEAK_BYTES) * 1e3,
                max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3, by)

    k_ms, k_host_us = cuda_timed(launch, 10)
    kg_ms = cuda_ms(lambda: launch(want_grad=True), 10)
    kbf_ms = cuda_ms(lambda: launch(torch.bfloat16), 10)
    plain_ms = cuda_ms(lambda: fused_eval.fused_eval_plain(net, pos01), 3)
    b_tc, b_32, bound_by = bounds(n)
    # the value instance's persistent grid at this call's size and the
    # MC path's, and ptxas's registers and spills of every instance: the
    # value instances run two 256-thread blocks an SM, <= 128 registers
    widths = (fused_dvr.kernel_width(net), net.input.num_fourier,
              fused_dvr._latent_chunks(net), len(net.layers) - 2)
    grid = {m: fused_eval.device_eval_grid(m, *widths)
            for m in (n, WIDTH * HEIGHT)}
    regs = {f"value {k}": v for k, v in ptxas_instances(
        "sample_eval", "sample_eval_kernel").items()}
    regs.update({f"gradient {k}": v for k, v in ptxas_instances(
        "sample_eval", "sample_grad_kernel").items()})
    values = [v for k, v in regs.items() if k.startswith("value")]
    check(len(values) == 6 and all(v[0] <= 128 and v[1] == v[2] == 0
                                   for v in values),
          f"phase H: value instances' registers and spills {regs}")
    print(f"phase H sample_eval value instance: plan {grid[n][0]} bytes, "
          f"{grid[n][1]} warps a block, matrices pre-split {grid[n][2]}; "
          f"persistent grid {grid[n][3]} blocks on {grid[n][4]} SMs for "
          f"{n} positions, {grid[WIDTH * HEIGHT][3]} for "
          f"{WIDTH * HEIGHT}; ptxas (registers, spill stores, spill loads) "
          + ", ".join(f"{k} {v}" for k, v in sorted(regs.items())),
          flush=True)
    print(f"phase H sample_eval [{smi}]: flagship, {n} positions, value "
          f"kernel vs plain max|d| {err:.3e} (tol {KERNEL_TOL}), inside "
          f"masks equal, gradient vs autograd rel norm err {grad_rel:.3e} "
          f"on {int(inner.sum())} interior positions (tol {GRAD_TOL}; "
          f"{n_flips} left out whose clip gate differs), bf16 "
          f"table vs f32 plain {bf_err:.3e} (tol {ORACLE_TOL}); kernel "
          f"{k_ms:.4f} ms/launch ({k_ms * 1e6 / n:.4f} ns/position; host "
          f"{k_host_us:.1f} us a call of launch_sample_eval), "
          f"gradient instance {kg_ms:.4f} ms, bf16 table {kbf_ms:.4f} ms; "
          f"plain {plain_ms:.3f} ms; {n * sample_flops(net, False) / 1e9:.3f}"
          f" GFLOP; bound {b_tc:.5f} ms (bf16 tensor cores, share "
          f"{b_tc / k_ms:.5f}) / {b_32:.5f} ms (f32, share "
          f"{b_32 / k_ms:.4f}), bound by {bound_by}", flush=True)

    # I. the slice's main path: trace_mc through the fused sampler at the
    # smoke camera, tools/bench_mc.py's configuration
    phase = PhaseFunctionHenyeyGreenstein.make(g=0.3)
    config = RayEvaluationMonteCarlo.make(max_absorption=30.0,
                                          num_bounces=2, max_iterations=256)
    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    tf_dev = tf.to(dev)
    key = prng_key(7)

    def frame(use_fused=True, compact=False):
        return trace_mc(key, rs, rd, vol, tf_dev, phase, config,
                        use_fused=use_fused, compact=compact)

    reset_counts()
    out_f, first_ms = cuda_once(frame)
    c_i = counts()
    check(c_i["sample_eval"] > 0, f"phase I: launches {c_i}")
    out_p, plain_frame_ms = cuda_once(lambda: frame(use_fused=False))
    check(counts()["sample_eval"] == c_i["sample_eval"],
          "phase I: the plain frame launched the kernel")
    a, b = out_f.color, out_p.color
    check(bool(torch.isfinite(a).all()) and tuple(a.shape) == (
        WIDTH * HEIGHT, 4), "phase I: the fused frame")
    close = ((a - b).abs() < MC_TOL).all(dim=-1)
    share = float(close.float().mean())
    alpha = float(a[:, 3].mean())
    print(f"phase I trace_mc fused vs plain [{smi}]: flagship "
          f"{WIDTH}x{HEIGHT}, HG g=0.3, 2 bounces, max_iterations 256, "
          f"launches {c_i}, tracking rounds {c_i['tracking_rounds']}, "
          f"positions {c_i['sample_eval_positions']}; rays within {MC_TOL}: "
          f"{share:.5f} (limit {MC_MATCH_SHARE}), max|d| over all "
          f"{max_err(a, b):.3e}; alpha mean {alpha:.4f}, emission mean "
          f"{float(a[:, :3].mean()):.4f}; first fused frame {first_ms:.1f} "
          f"ms, plain frame {plain_frame_ms:.1f} ms", flush=True)
    check(share >= MC_MATCH_SHARE, f"phase I: only {share} of the rays "
          f"within {MC_TOL}")
    check(0.05 < alpha < 0.95 and float(a[:, :3].max()) > 0,
          f"phase I: alpha mean {alpha}")

    # the frame under each schedule, interleaved: a host-bound frame's
    # time drifts by tens of percent within one call, so each repetition
    # runs every schedule once, in a rotated order, and the median is
    # kept. Schedules: compaction off and on; the host read of "any ray
    # walks" every 1, 4, 8 and 16 rounds (a read waits for the device; a
    # round past a walk's end costs a round of launches)
    live_every = montecarlo.LIVE_CHECK_EVERY
    schedules = [(False, e) for e in (1, 4, 8, 16)] + [(True, live_every)]
    frames = {s_: [] for s_ in schedules}
    per = {}
    try:
        frame()
        for rep in range(MC_REPS):
            for i in range(len(schedules)):
                s_ = schedules[(i + rep) % len(schedules)]
                montecarlo.LIVE_CHECK_EVERY = s_[1]
                reset_counts()
                frames[s_].append(cuda_once(lambda: frame(compact=s_[0]))[1])
                c = counts()
                per[s_] = {k: c[k] for k in ("tracking_rounds",
                                             "sample_eval_positions",
                                             "sample_eval")}
    finally:
        montecarlo.LIVE_CHECK_EVERY = live_every
    med = {s_: statistics.median(v) for s_, v in frames.items()}
    for s_ in schedules:
        print(f"phase I timing [{smi}], compact={s_[0]}, live-ray read "
              f"every {s_[1]} rounds: {med[s_]:.1f} ms/frame (median of "
              f"{MC_REPS}, interleaved; min {min(frames[s_]):.1f}, max "
              f"{max(frames[s_]):.1f}), {WIDTH * HEIGHT / med[s_] / 1e3:.4f} "
              f"Mrays/s; per frame {per[s_]['tracking_rounds']} tracking "
              f"rounds, {per[s_]['sample_eval_positions']} positions, "
              f"{per[s_]['sample_eval']} sample_eval launches; frames "
              f"{' '.join(f'{t:.1f}' for t in frames[s_])}", flush=True)
    default, compacted = (False, live_every), (True, live_every)

    # one frame with CUDA events around every launch of the kernel (an
    # event pair also spans the host's launch latency while the device
    # waits on the host); the first launch's inputs are kept to time the
    # path's launch alone
    events, first = [], []
    untimed = fused_eval.launch_sample_eval

    def timed(*args):
        if not first:
            first.extend(a.clone() if torch.is_tensor(a) else a
                         for a in args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = untimed(*args)
        end.record()
        events.append((start, end))
        return out

    fused_eval.launch_sample_eval = timed
    try:
        _, inst_ms = cuda_once(frame)
    finally:
        fused_eval.launch_sample_eval = untimed
    kern_ms = sum(s_.elapsed_time(e_) for s_, e_ in events)
    print(f"phase I instrumented frame [{smi}], compact=False: frame "
          f"{inst_ms:.1f} ms, {len(events)} sample_eval launches "
          f"{kern_ms:.2f} ms by events, the share {kern_ms / inst_ms:.4f}",
          flush=True)

    # the path's launch alone: the frame's first launch, its own positions
    pos_path, g_path = first[1], first[5]
    n_path = pos_path.shape[0]
    check(n_path == WIDTH * HEIGHT and not g_path,
          f"phase I: first launch {n_path} positions")
    err_path = max_err(untimed(*first),
                       fused_eval.fused_eval_plain(net, pos_path)[0])
    check(err_path <= KERNEL_TOL, f"phase I: path launch kernel vs plain "
          f"{err_path}")
    path_ms, path_host_us = cuda_timed(lambda: untimed(*first), 20)
    path_plain_ms = cuda_ms(
        lambda: fused_eval.fused_eval_plain(net, pos_path), 5)
    p_tc, p_32, p_by = bounds(n_path)
    print(f"phase I path launch alone [{smi}]: {n_path} positions, kernel "
          f"vs plain max|d| {err_path:.3e}; kernel {path_ms:.4f} ms "
          f"({path_ms * 1e6 / n_path:.4f} ns/position; host "
          f"{path_host_us:.1f} us a call of launch_sample_eval; x "
          f"{len(events)} launches = {path_ms * len(events):.1f} ms, share "
          f"of the frame {path_ms * len(events) / inst_ms:.4f}), plain "
          f"{path_plain_ms:.3f} ms; bound {p_tc:.5f} ms (bf16 tensor cores, "
          f"share {p_tc / path_ms:.5f}) / {p_32:.5f} ms (f32, share "
          f"{p_32 / path_ms:.4f}), bound by {p_by}", flush=True)
    return {
        "name": "sample_eval", "route": "cuda",
        "source": "fvsrn_tpu_torch/csrc/sample_eval.cu",
        "replaces": "fvsrn_tpu/ops/fused_eval.py:42",
        "launches": c_i["sample_eval"], "max_abs_err": max(err, err_path),
        "ms": path_ms, "plain_ms": path_plain_ms, "bound_ms": p_tc,
        "bound_by": p_by, "library_ms": None, "bound_f32_ms": p_32,
        "positions": n_path, "big_positions": n, "big_ms": k_ms,
        "big_plain_ms": plain_ms, "big_bound_ms": b_tc,
        "big_bound_f32_ms": b_32, "big_grad_ms": kg_ms,
        "big_bf16_ms": kbf_ms, "big_ns_per_position": k_ms * 1e6 / n,
        "ns_per_position": path_ms * 1e6 / n_path,
        "host_us": path_host_us, "big_host_us": k_host_us,
        "grid_blocks": {str(m): g[3] for m, g in grid.items()},
        "ptxas": {k: list(v) for k, v in regs.items()},
        "grad_rel_err": grad_rel,
        "gate_flips": n_flips, "bf16_max_abs_err": bf_err,
        "frame_ms": med[default], "frame_ms_compact": med[compacted],
        "plain_frame_ms": plain_frame_ms,
        "per_frame": per[default], "per_frame_compact": per[compacted],
        "frame_kernel_ms_events": kern_ms,
        "frame_kernel_ms_alone": path_ms * len(events),
        "live_check_ms": {str(e): med[(False, e)] for e in (1, 4, 8, 16)},
        "frames_ms": {f"compact={c},every={e}": v
                      for (c, e), v in frames.items()},
        "rays_within_tol": share}


def sparse_arm(smi, reset_counts, counts, cam):
    """Phase J, the sparse arm: the sparse flagship (MULTI_SHELL, a TF
    with a zero-opacity band) through the FUSED product render with
    occupancy culling, and one masked training step with network-only
    gradients. Returns its figures (they ride on the mega_fwd row)."""
    import numpy as np

    from fvsrn_tpu_torch.inference import ALPHA_SKIP, LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import fused_mega
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.scenes import sparse_scene

    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    steps_max = max_steps_bound(box[1], STEPSIZE)
    _, tf, npz = sparse_scene()
    model = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=STEPSIZE))

    # planning: the occupancy grid (zero-band probe, 128^3, fine=2), then
    # the camera's plan and mask
    t0 = time.perf_counter()
    occ = model._occupancy_grid(STEPSIZE)
    occ_s = time.perf_counter() - t0
    check(occ is not None, "phase J: the sparse TF built no occupancy grid")
    t0 = time.perf_counter()
    render = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    mask = render.segment_active
    check(render.route == "mega" and mask is not None,
          f"phase J: route {render.route}, mask {mask is not None}")
    unculled = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED",
                                            occupancy_culling=False)
    net = render.network
    step_net = copy.deepcopy(net)
    tf_d = render.tf.tensor
    opt = torch.optim.SGD(step_net.parameters(), lr=1e-7)

    def masked_step(rs, rd, clip, m):
        """One fwd+bwd+SGD step of mean(rgba^2) through the masked
        differentiable march (a copy of the network is trained, the TF
        is not)."""
        opt.zero_grad(set_to_none=True)
        img = fused_mega.mega_trace_dvr(
            rs, rd, step_net, *box, tf_d, stepsize=STEPSIZE, tmax_clip=clip,
            differentiable=True, segment_active=m)
        (img ** 2).mean().backward()
        opt.step()

    # the main path: the culled frame and one masked step
    reset_counts()
    img = render()
    masked_step(render.ray_start, render.ray_dir, render.tmax_clip, mask)
    torch.cuda.synchronize()
    c_j = counts()
    check(c_j["mega_fwd"] > 0 and c_j["mega_fwd_diff"] > 0
          and c_j["mega_bwd"] > 0, f"phase J: launches {c_j}")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 4)
          and bool(torch.isfinite(img).all()), "phase J: the culled frame")
    amax = float(img[..., 3].max())
    check(amax > 0.5, f"phase J: alpha max {amax}")

    # the culled share of (tile, segment) programs, of all and of those
    # with a live lattice point
    spec = fused_mega._spec(render.network, *box, stepsize=STEPSIZE, seg=32,
                            tile=256, density_min=0.0, density_max=1.0,
                            enable_early_out=True)
    rays = fused_mega.ray_packet(render.ray_start, render.ray_dir, *box,
                                 STEPSIZE, render.tmax_clip)
    _, k0r, tmx, k0t = fused_mega._tile_geometry(rays, 256)
    live = torch.stack([fused_mega._segment_state(spec, k0r, tmx, k0t, s)[1]
                        for s in range(mask.shape[1])], dim=1)
    culled = 1.0 - float(mask.float().mean())
    culled_live = float((live & ~mask).sum()) / max(1, int(live.sum()))
    img_u = unculled()
    d_cull = max_err(img, img_u)
    bitwise = bool(torch.equal(img, img_u))
    cull_tol = steps_max * ALPHA_SKIP
    got, samples = render.march(return_samples=True)
    _, samples_u = unculled.march(return_samples=True)
    plain, samples_p = render.march(fused_mega.mega_trace_dvr_plain,
                                    return_samples=True)
    err = max_err(got, plain)
    print(f"phase J sparse arm: MULTI_SHELL flagship {WIDTH}x{HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)}, occupancy grid {tuple(occ.shape)} "
          f"({float(occ.mean()):.4f} occupied) in {occ_s:.2f} s, camera "
          f"plan {plan_s:.2f} s; mask {tuple(mask.shape)}: culled "
          f"{culled:.4f} of (tile, segment) programs, {culled_live:.4f} of "
          f"the live ones; samples {int(samples.sum())} culled vs "
          f"{int(samples_u.sum())} unculled; launches {c_j}", flush=True)
    print(f"phase J culled vs unculled: max|d| {d_cull:.3e} (tol "
          f"{cull_tol:.3e}), bitwise equal {bitwise}; kernel vs plain "
          f"(same mask) max|d| {err:.3e} (tol {KERNEL_TOL}), samples "
          f"{int(samples.sum())} vs {int(samples_p.sum())}", flush=True)
    check(d_cull <= cull_tol, f"phase J: culled vs unculled {d_cull}")
    check(err <= KERNEL_TOL, f"phase J: kernel vs plain {err}")

    # the f32 lattice oracle at the same clip on 64 tiles, spread evenly
    # over the tiles that take samples (bench.py's sparse gates)
    hit = torch.nonzero(samples_u > 0).flatten()
    tiles = hit[torch.linspace(0, hit.numel() - 1, ORACLE_TILES,
                               device=hit.device).long()]
    sel = (tiles[:, None] * 256 + torch.arange(256, device=hit.device)
           ).reshape(-1)
    o_rs, o_rd = render.ray_start[sel], render.ray_dir[sel]
    o_clip, o_mask = render.tmax_clip[sel], mask[tiles]
    vol = VolumeInterpolationNetwork(net, *box)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)
    with torch.no_grad():
        oracle = trace_dvr(o_rs, o_rd, vol, render.tf, ocfg, steps_max,
                           tmax_in=o_clip, lattice=True).color
    ad = (got[sel] - oracle).abs()
    o_max = float(ad.max())
    o_p99 = float(torch.quantile(ad.flatten(), 0.99))

    # the masked step on those tiles: kernel vs plain, and vs autograd
    # through the oracle, network leaves only
    def net_grads(fn):
        net.zero_grad(set_to_none=True)
        out = fn()
        (out ** 2).mean().backward()
        return {n: p.grad.detach().clone() for n, p in net.named_parameters()}

    kw = dict(stepsize=STEPSIZE, tmax_clip=o_clip, differentiable=True,
              segment_active=o_mask)
    g_k = net_grads(lambda: fused_mega.mega_trace_dvr(
        o_rs, o_rd, net, *box, tf_d, **kw))
    g_p, gp_ms = cuda_once(lambda: net_grads(
        lambda: fused_mega.mega_trace_dvr_plain(o_rs, o_rd, net, *box, tf_d,
                                                **kw)))
    g_o = net_grads(lambda: trace_dvr(
        o_rs, o_rd, vol, render.tf, ocfg, steps_max, tmax_in=o_clip,
        lattice=True, checkpoint_chunk=64).color)
    rel_p = {n: rel_err(g_k[n], g_p[n]) for n in g_p}
    rel_o = {n: rel_err(g_k[n], g_o[n]) for n in g_o}
    wp, wo = max(rel_p, key=rel_p.get), max(rel_o, key=rel_o.get)
    print(f"phase J vs f32 lattice oracle, {sel.numel()} rays: image max|d| "
          f"{o_max:.3e} (tol {SPARSE_MAX_TOL}), p99 {o_p99:.3e} (tol "
          f"{SPARSE_P99_TOL}); masked step network grads: kernel vs plain "
          f"rel err max {rel_p[wp]:.3e} ({wp}, tol {GRAD_TOL}), vs oracle "
          f"{rel_o[wo]:.3e} ({wo}, tol {SPARSE_GRAD_TOL}); plain fwd+bwd "
          f"{gp_ms:.1f} ms", flush=True)
    check(o_max <= SPARSE_MAX_TOL and o_p99 <= SPARSE_P99_TOL,
          f"phase J: vs oracle max {o_max} p99 {o_p99}")
    check(all(float(g.norm()) > 0 for g in g_p.values()),
          "phase J: a zero network gradient")
    check(rel_p[wp] <= GRAD_TOL, f"phase J: grads kernel vs plain {rel_p}")
    check(rel_o[wo] <= SPARSE_GRAD_TOL, f"phase J: grads vs oracle {rel_o}")

    # timing: the product frame (time_rendering, culled by default), the
    # culled and unculled frames and kernels at the bench camera, and the
    # masked and unmasked training steps
    mean_ms, std_ms, frames = model.time_rendering(
        LoadedModel.rotation_cameras(TIMED_CAMERAS), WIDTH, HEIGHT)
    frame_ms = cuda_ms(render, 10)
    frame_u_ms = cuda_ms(unculled, 10)
    kernel_ms = cuda_ms(lambda: render.march(), 10)
    kernel_u_ms = cuda_ms(lambda: unculled.march(), 10)
    full = (render.ray_start, render.ray_dir, render.tmax_clip)
    step_ms = cuda_ms(lambda: masked_step(*full, mask), TIMED_STEPS)
    step_u_ms = cuda_ms(lambda: masked_step(*full, None), TIMED_STEPS)
    n_rays = WIDTH * HEIGHT
    print(f"phase J timing [{smi}]: product render (time_rendering, "
          f"culled) {mean_ms:.3f} ms/frame (std {std_ms:.3f}, {len(frames)} "
          f"cameras), {n_rays / mean_ms / 1e3:.3f} Mrays/s; bench camera "
          f"frame culled {frame_ms:.3f} / unculled {frame_u_ms:.3f} ms, "
          f"kernel {kernel_ms:.3f} / {kernel_u_ms:.3f} ms; masked step "
          f"(fwd + mean(rgba^2) + bwd + SGD) {step_ms:.3f} ms, "
          f"{n_rays / step_ms / 1e3:.3f} Mrays/s, unmasked {step_u_ms:.3f} "
          f"ms", flush=True)
    return {"frame_ms": mean_ms, "frame_std_ms": std_ms,
            "bench_frame_ms": frame_ms, "bench_frame_unculled_ms": frame_u_ms,
            "kernel_ms": kernel_ms, "kernel_unculled_ms": kernel_u_ms,
            "step_ms": step_ms, "step_unmasked_ms": step_u_ms,
            "culled": culled, "culled_live": culled_live,
            "samples": int(samples.sum()),
            "samples_unculled": int(samples_u.sum()),
            "cull_max_abs_diff": d_cull, "cull_bitwise": bitwise,
            "kernel_vs_plain": err, "oracle_max": o_max, "oracle_p99": o_p99,
            "grad_rel_plain": rel_p[wp], "grad_rel_oracle": rel_o[wo],
            "occupancy_s": occ_s, "plan_s": plan_s, "launches": c_j}


def probe_rows(smi):
    """Phase K, TPU kernel rows 8-11: the port's probe tools
    (``fvsrn_tpu_torch/tools/``) at the JAX tools' shapes, each kernel
    against the JAX tools' NumPy oracles, then against its plain version,
    with the library call beside it. Returns the kernels' JSON rows."""
    from fvsrn_tpu_torch.ops import probes
    from fvsrn_tpu_torch.tools import probe_lane_gather, proto_mega

    # the main path: the tools' runs, with the counts set to 0 before
    probes.reset_counts()
    proto = proto_mega.run("cuda")
    gathers = probe_lane_gather.run_all("cuda")
    torch.cuda.synchronize()
    c_k = probes.counts()
    check(all(v > 0 for v in c_k.values()), f"phase K: launches {c_k}")
    check(proto["ok"], f"phase K: proto_mega vs oracle {proto}")
    for _, res in gathers:
        check(res["ok"], f"phase K: {res['name']} vs oracle {res}")

    # then each against its plain version and the library call
    cases = {"proto_mega": [dict(proto, name="proto_mega",
                                 **proto_mega.run("cuda", compare=True))]}
    for (kernel, fn), (_, res) in zip(probe_lane_gather.PROBES, gathers):
        res.update(fn("cuda", compare=True))
        cases.setdefault(kernel, []).append(res)
    sources = {"proto_mega": "tools/proto_mega.py:78",
               "gather_single": "tools/probe_lane_gather.py:46",
               "gather_chunked": "tools/probe_lane_gather.py:78",
               "onehot_resolve": "tools/probe_lane_gather.py:103"}
    rows = []
    for name, replaces in sources.items():
        runs = cases[name]
        for r in runs:
            r["bound_ms"] = r["bytes"] / PEAK_BYTES * 1e3
            err = r.get("max_abs_err", r.get("out_rel_err"))
            per = ("" if name == "proto_mega" else
                   f" ({r['us'] * 1e3 / probe_lane_gather.N:.4f} ns/sample)")
            print(f"phase K {r['name']} [{smi}]: {r['us']:.2f} us/launch"
                  f"{per}, vs oracle {err:.3e}, vs plain "
                  f"{r['plain_max_abs_err']:.3e}; bound "
                  f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes'] / 1e6:.3f} MB, "
                  f"share {r['bound_ms'] * 1e3 / r['us']:.4f}); plain "
                  f"{r['plain_us']:.1f} us; library "
                  + (f"{r['library_us']:.2f} us" if "library_us" in r
                     else "none"), flush=True)
            check(r["plain_max_abs_err"] <= (1e-5 if name == "proto_mega"
                                             else 0.0),
                  f"phase K: {r['name']} kernel vs plain {r}")
        first = runs[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": "fvsrn_tpu_torch/csrc/probes.cu", "replaces": replaces,
            "launches": c_k[name],
            "max_abs_err": max(r["plain_max_abs_err"] for r in runs),
            "ms": first["us"] / 1e3, "plain_ms": first["plain_us"] / 1e3,
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": (first["library_us"] / 1e3
                           if "library_us" in first else None),
            "cases": {r["name"]: {k: r[k] for k in (
                "us", "plain_us", "bound_ms", "library_us")
                if k in r} for r in runs}})
    return rows


def profile_top(fn, k=6):
    """The ``k`` CUDA kernels with the most self device time in one call
    of ``fn`` (torch.profiler), as {name: (ms, share of the device
    time)}; empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)] or list(prof.key_averages())

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    total = sum(dev_us(e) for e in events)
    if total <= 0:
        return {}
    top = sorted(events, key=dev_us, reverse=True)[:k]
    return {e.key[:60]: (round(dev_us(e) / 1e3, 4),
                         round(dev_us(e) / total, 4)) for e in top}


def world_first_step(phase, opt, loss, ds, ds_cpu, idx):
    """The world trainer's first step, from the run's initial weights on
    the batch ``idx`` of the dataset ``ds`` (card) and ``ds_cpu`` (its
    CPU copy): loss and every gradient leaf card against CPU, each within
    1e-5 relative. Returns (loss rel, {leaf: rel}, worst leaf)."""
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train import world

    step_out = []
    for data in (ds, ds_cpu):
        d = data.positions.device
        net = train_main.make_network(opt).to(d)
        b = world.WorldDataset(*(a[idx.to(d)] for a in data))
        total, _ = world.evaluate_world(net, b, loss)
        total.backward()
        step_out.append((float(total.detach()), {
            k: p.grad.detach().cpu() for k, p in net.named_parameters()}))
    (l_dev, g_dev), (l_cpu, g_cpu) = step_out
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    grad_rel = {k: rel_err(g_dev[k], g_cpu[k]) for k in g_cpu}
    worst = max(grad_rel, key=grad_rel.get)
    check(loss_rel <= 1e-5, f"{phase}: first-step loss card {l_dev} vs "
          f"CPU {l_cpu}")
    check(grad_rel[worst] <= 1e-5, f"{phase}: first-step gradients "
          f"{grad_rel}")
    return loss_rel, grad_rel, worst


def world_training(smi, reset_counts, counts, npz, tf):
    """Phase L, the trainer's default mode: ``train.main.run --mode world``
    at the flagship's widths on the card (JAX's random draws, the halton
    dataset, Adam), then with random positions, an importance-sampled half
    and a rebuild from the loss grid; the draws, the dataset and the first
    step against the CPU's; the step timed. Then the Monte-Carlo draws and
    supersampling that JAX's draws unblocked, card against CPU. No TPU
    kernel lies on this path: the JAX package's world step is plain XLA.
    Returns the figures printed."""
    from fvsrn_tpu_torch.camera import CameraOnASphere
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import probes
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer import evaluator
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    from fvsrn_tpu_torch.raytracer.montecarlo import (
        RayEvaluationMonteCarlo, sample_light_position)
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train import world
    from fvsrn_tpu_torch.train.losses import LossNetWorld
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.train.sampling import get_sampled_positions
    from fvsrn_tpu_torch.utils import prng
    from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    opt = vars(train_main.init_parser().parse_args(
        WORLD_ARGS[:1] + [os.path.join(out_dir, "world_run.npz")]
        + WORLD_ARGS[1:]))
    n, batch = opt["samples"], opt["batch_size"]

    # the draws on the card against the CPU's, bit for bit
    key = prng.prng_key(opt["seed"])
    for name, fn in (
            ("random positions", lambda d: get_sampled_positions(
                "random", n, key=key, device=d)),
            ("epoch permutation", lambda d: prng.permutation(
                prng.split(prng.prng_key(0))[1], n, device=d)),
            ("uniform (-2.5, 3.7)", lambda d: prng.uniform(
                key, (n, 3), -2.5, 3.7, device=d))):
        check(torch.equal(fn(dev).cpu(), fn(cpu)),
              f"phase L: {name} on the card differ from the CPU's")
    nerr = float((prng.normal(key, (n, 3), device=dev).cpu()
                  - prng.normal(key, (n, 3), device=cpu)).abs().max())
    check(nerr <= 1e-6, f"phase L: normal card vs CPU {nerr}")

    # the dataset: halton positions, densities of the implicit field
    volume = VolumeInterpolationImplicit.make("MARSCHNER_LOBB")
    t0 = time.perf_counter()
    ds = world.build_world_dataset(volume, n, sampler=opt["sampler"],
                                   device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ds_cpu = world.build_world_dataset(volume, n, sampler=opt["sampler"],
                                       device=cpu)
    terr = float((ds.targets.cpu() - ds_cpu.targets).abs().max())
    check(torch.equal(ds.positions.cpu(), ds_cpu.positions),
          "phase L: dataset positions")
    check(terr <= 1e-6, f"phase L: dataset targets card vs CPU {terr}")

    # the first step from the run's initial weights and its first batch,
    # on the card and on the CPU
    loss = LossNetWorld(mode="density", l1=opt["l1"], l2=opt["l2"])
    perm = prng.permutation(prng.split(prng.prng_key(0))[1], n, device=dev)
    loss_rel, grad_rel, worst = world_first_step("phase L", opt, loss, ds,
                                                 ds_cpu, perm[:batch])

    # the main path, twice: the JAX parser's defaults, then random
    # positions with an importance-sampled half and a rebuild every epoch
    runs = {}
    for name, extra in (("halton", []),
                        ("random+importance+rebuild",
                         ["--sampler", "random", "--importance", "0.5",
                          "--rebuild_dataset", "1"])):
        o = vars(train_main.init_parser().parse_args(
            WORLD_ARGS[:1] + [os.path.join(out_dir, "world_run.npz")]
            + WORLD_ARGS[1:] + extra))
        reset_counts()
        probes.reset_counts()
        t0 = time.perf_counter()
        hist = train_main.run(o)["history"]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        c_l = dict(counts(), **probes.counts())
        print(f"phase L trainer [{smi}]: train.main.run --mode world "
              f"{name}, {n} samples, batch {batch}, {o['epochs']} epochs "
              f"in {run_s:.2f} s (dataset included), losses {hist}, "
              f"kernel launches {c_l} (none on this path)", flush=True)
        check(len(hist) == o["epochs"]
              and all(math.isfinite(v) for v in hist) and hist[1] < hist[0],
              f"phase L {name}: losses {hist}")
        runs[name] = {"losses": hist, "seconds": run_s}

    # the step's time: CUDA events over an epoch's steps after a warm-up
    # epoch (forward, L1, autograd, Adam and the scheduler)
    net = train_main.make_network(opt).to(dev)
    step = world.make_train_step(loss, make_optimizer(
        net.parameters(), opt["optimizer"], lr=opt["lr"]))
    nbatch = n // batch
    batches = [world.WorldDataset(*(a[perm[i * batch:(i + 1) * batch]]
                                    for a in ds)) for i in range(nbatch)]

    def epoch():
        for b in batches:
            step(net, b)
    step_ms = cuda_ms(epoch, 1) / nbatch
    # the step's layers: the forward and loss alone, then with autograd's
    # backward; the rest of the step is Adam and the scheduler
    fwd_ms = cuda_ms(lambda: world.evaluate_world(net, batches[0], loss), 8)
    fwd_bwd_ms = cuda_ms(lambda: world.evaluate_world(
        net, batches[0], loss)[0].backward(), 8)
    net.zero_grad(set_to_none=True)
    top = profile_top(epoch)
    print(f"phase L world step [{smi}]: {step_ms:.4f} ms/step, "
          f"{batch / step_ms * 1e3:.0f} samples/s (batch {batch}, mean of "
          f"{nbatch} steps after a warm-up epoch): forward and loss "
          f"{fwd_ms:.4f} ms, backward {fwd_bwd_ms - fwd_ms:.4f} ms, Adam "
          f"and the rest {step_ms - fwd_bwd_ms:.4f} ms; the epoch's device "
          f"time by kernel (torch.profiler, self time) {top}", flush=True)
    print(f"phase L world data [{smi}]: dataset build "
          f"{build_s:.3f} s ({n} halton samples, host clock); draws card "
          f"= CPU bit for bit, normal max|d| {nerr:.2e}; targets max|d| "
          f"{terr:.2e}; first step loss rel {loss_rel:.2e}, worst "
          f"gradient leaf {worst} rel {grad_rel[worst]:.2e}", flush=True)

    # Monte-Carlo draws from a key and supersampling, card against CPU
    model = LoadedModel.from_checkpoint(npz, tf=tf)
    cam = CameraOnASphere.make(**CAMERA)
    imgs = {}
    for d in (dev, cpu):
        ev = evaluator.ImageEvaluatorSimple(
            camera=cam, volume=VolumeInterpolationNetwork(
                model.network.to(d), model.box_min, model.box_size),
            tf=tf, ray_config=RayEvaluationSteppingDvr.make(
                stepsize=MC_CHECK_STEPSIZE), samples=MC_CHECK_SAMPLES)
        with torch.no_grad():
            imgs[d.type] = evaluator.render_image(
                ev, MC_CHECK_SIZE, MC_CHECK_SIZE, device=d).cpu()
    img_err = float((imgs["cuda"] - imgs["cpu"]).abs().max())
    amax = float(imgs["cuda"][:, 3].max())
    check(img_err <= 1e-4 and amax > 0.1, f"phase L: render_image "
          f"samples={MC_CHECK_SAMPLES} card vs CPU {img_err}, alpha {amax}")
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        np.random.default_rng(3).standard_normal((n, 3)).astype(
            np.float32)), dim=1)
    phase = PhaseFunctionHenyeyGreenstein.make(g=0.3)
    # the uniforms are equal bit for bit; the direction's trigonometry
    # differs by ulps between the card's libm and the CPU's, held as the
    # CPU tests hold the port against JAX (2e-5)
    k1, _ = prng.split(key)
    check(torch.equal(prng.uniform(k1, (n,), device=dev).cpu(),
                      prng.uniform(k1, (n,), device=cpu)),
          "phase L: phase.sample's uniforms")
    ph_err = float((phase.sample(key, dirs.to(dev)).cpu()
                    - phase.sample(key, dirs)).abs().max())
    cfg = RayEvaluationMonteCarlo.make()
    light_err = float((sample_light_position(
        key, cfg, (n,), torch.float32, device=dev).cpu()
        - sample_light_position(key, cfg, (n,), torch.float32,
                                device=cpu)).abs().max())
    print(f"phase L MC draws: render_image dvr samples={MC_CHECK_SAMPLES} "
          f"{MC_CHECK_SIZE}^2 card vs CPU max|d| {img_err:.2e} (alpha max "
          f"{amax:.3f}); phase.sample from a key {ph_err:.2e}; "
          f"sample_light_position without ray ids {light_err:.2e}",
          flush=True)
    check(ph_err <= 2e-5 and light_err <= 1e-5,
          f"phase L: MC draws card vs CPU {ph_err}, {light_err}")
    return {"step_ms": step_ms, "samples_per_s": batch / step_ms * 1e3,
            "forward_ms": fwd_ms, "backward_ms": fwd_bwd_ms - fwd_ms,
            "dataset_build_s": build_s, "runs": runs,
            "first_step_loss_rel": loss_rel,
            "first_step_grad_rel": grad_rel[worst],
            "render_samples_err": img_err}


def voxel_volume(smi, reset_counts, counts):
    """Phase M, a voxel volume end to end: MARSCHNER_LOBB voxelized at
    256^3 on the card, written as a ``.cvol`` uncompressed and with LZ4
    and read back; a scene JSON naming it, resolved; the grid's samplers,
    normal and curvature card against CPU and timed; world training and
    screen training (rows 2-3) on the scene; the reference render and
    the world-trained network's FUSED render (row 1); a curvature iso
    render card against CPU. Returns the figures printed."""
    from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.modules.registry import load_from_json
    from fvsrn_tpu_torch.ops import fused_mega
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound)
    from fvsrn_tpu_torch.raytracer.iso import (RayEvaluationSteppingIso,
                                               trace_iso)
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train import world
    from fvsrn_tpu_torch.train.losses import LossNetWorld
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.train.screen import (build_screen_dataset,
                                              screen_mega_kwargs)
    from fvsrn_tpu_torch.utils import prng
    from fvsrn_tpu_torch.volume.grid import VolumeInterpolationGrid
    from fvsrn_tpu_torch.volume.implicit import create_implicit_grid
    from fvsrn_tpu_torch.volume.volume import Volume

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))

    # M1. the volume, voxelized on the card, written twice and read back
    t0 = time.perf_counter()
    density = create_implicit_grid(GRID_RES, "MARSCHNER_LOBB", device=dev)
    torch.cuda.synchronize()
    voxel_ms = (time.perf_counter() - t0) * 1e3
    density = density.cpu().numpy()
    vol = Volume(world_size=(1.0, 1.0, 1.0))
    vol.add_feature("density", density)
    vol.add_feature("density_u8", np.round(density * 255).astype(np.uint8))
    payload = vol.estimate_memory()
    io = {}
    for name, compression in (("raw", 0), ("lz4", 1)):
        path = os.path.join(out_dir, f"mlobb{GRID_RES}_{name}.cvol")
        t0 = time.perf_counter()
        vol.save(path, compression=compression)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Volume.load(path)
        load_s = time.perf_counter() - t0
        for f, fb in zip(vol.features, back.features, strict=True):
            check(f.name == fb.name and np.array_equal(f.levels[0].data,
                                                       fb.levels[0].data),
                  f"phase M: the {name} file's {f.name} after a round trip")
        io[name] = {"path": path, "bytes": os.path.getsize(path),
                    "save_s": save_s, "load_s": load_s,
                    "save_mb_s": payload / save_s / 1e6,
                    "load_mb_s": payload / load_s / 1e6}
    check(io["lz4"]["bytes"] < io["raw"]["bytes"],
          f"phase M: LZ4 file {io['lz4']['bytes']} B not below the "
          f"uncompressed {io['raw']['bytes']} B")
    print(f"phase M volume [{smi}]: MARSCHNER_LOBB voxelized at "
          f"{GRID_RES}^3 on the card in {voxel_ms:.2f} ms; .cvol payload "
          f"{payload / 2**20:.1f} MiB (float32 + uint8 feature); "
          + "; ".join(f"{k}: {v['bytes']} B, save {v['save_s']:.3f} s "
                      f"({v['save_mb_s']:.1f} MB/s), load {v['load_s']:.3f} "
                      f"s ({v['load_mb_s']:.1f} MB/s)" for k, v in io.items())
          + f"; LZ4 ratio {io['lz4']['bytes'] / io['raw']['bytes']:.4f} "
          "(host clock)", flush=True)

    # M2. a scene JSON naming the compressed file, resolved
    scene_path = os.path.join(out_dir, f"mlobb{GRID_RES}.json")
    with open(scene_path, "w") as f:
        json.dump({
            "ImageEvaluator": {"Simple": {
                "selectedCamera": "Sphere", "selectedRayEvaluator": "DVR",
                "selectedVolume": "Grid"}},
            "RayEvaluation": {"DVR": {"stepsize": STEPSIZE,
                                      "selectedTF": "Piecewise"}},
            "camera": {"Sphere": dict(CAMERA)},
            "tf": {"Piecewise": GRID_SCENE_TF},
            "volume": {"Grid": {
                "source": "VOLUME", "interpolation": "TRILINEAR",
                "volumePath": os.path.basename(io["lz4"]["path"])}}}, f)
    sc = load_from_json(scene_path)
    ref, tf = sc.evaluator.volume, sc.evaluator.tf
    check(isinstance(ref, VolumeInterpolationGrid)
          and ref.resolution == (GRID_RES,) * 3
          and torch.equal(ref.data, torch.from_numpy(density))
          and ref.box_size.tolist() == [1.0, 1.0, 1.0],
          "phase M: the scene's grid is not the volume written")

    # M3. samplers, normal and curvature on 2^20 positions on the card,
    # card vs CPU on the first 2^18 (the CPU's share cut in depth: it runs
    # beside the build)
    pos_d = torch.from_numpy(np.random.default_rng(5).uniform(
        -0.52, 0.52, (GRID_POSITIONS, 3)).astype(np.float32)).to(dev)
    pos = pos_d[:GRID_CPU_POSITIONS].cpu()
    pos_h = pos_d[:GRID_CPU_POSITIONS]
    samplers = {}
    for interp in ("nearest", "trilinear", "tricubic"):
        g_c = VolumeInterpolationGrid.from_grid(ref.data,
                                                interpolation=interp)
        g_d = g_c.to(dev)
        v_d, in_d = g_d.eval_density(pos_h)
        v_c, in_c = g_c.eval_density(pos)
        check(torch.equal(in_d.cpu(), in_c), f"phase M: {interp} inside")
        samplers[interp] = {
            "max_abs_err": max_err(v_d.cpu(), v_c),
            "ns_per_position": cuda_ms(lambda: g_d.eval_density(pos_d), 10)
            * 1e6 / GRID_POSITIONS}
    check(samplers["nearest"]["max_abs_err"] == 0.0
          and samplers["trilinear"]["max_abs_err"] <= 1e-6
          and samplers["tricubic"]["max_abs_err"] <= 1e-6,
          f"phase M: samplers card vs CPU {samplers}")
    g_c = VolumeInterpolationGrid.from_grid(ref.data)
    g_d = g_c.to(dev)
    n_c = g_c.eval_normal(pos)
    normal_rel = max_err(g_d.eval_normal(pos_h).cpu(), n_c) / float(
        n_c.abs().max())
    normal_ns = cuda_ms(lambda: g_d.eval_normal(pos_d), 3) * 1e6 \
        / GRID_POSITIONS
    k_c = g_c.eval_curvature(pos)
    k_d = g_d.eval_curvature(pos_h).cpu()
    gnorm = n_c.norm(dim=-1)
    keep = gnorm >= 1e-3
    k_err = (k_d - k_c).abs().amax(dim=-1)[keep]
    k_scale = k_c.abs().amax(dim=-1)[keep]
    curv = {"max_abs_err": float(k_err.max()),
            "p999_abs_err": float(torch.quantile(k_err[:1 << 16], 0.999)),
            "max_rel_err": float((k_err / (1.0 + k_scale)).max()),
            "max_abs_k": float(k_scale.max()),
            "kept_share": float(keep.float().mean()),
            "ns_per_position": cuda_ms(lambda: g_d.eval_curvature(pos_d), 2)
            * 1e6 / GRID_POSITIONS}
    print(f"phase M grid [{smi}]: {GRID_POSITIONS} positions timed, "
          f"{GRID_CPU_POSITIONS} card vs CPU "
          + ", ".join(f"{k} max|d| {v['max_abs_err']:.2e} "
                      f"{v['ns_per_position']:.3f} ns/position"
                      for k, v in samplers.items())
          + f"; eval_normal rel {normal_rel:.2e}, {normal_ns:.3f} ns/position;"
          f" eval_curvature (|g| >= 1e-3, {curv['kept_share']:.4f} of "
          f"positions) max|d| {curv['max_abs_err']:.3e}, p99.9 "
          f"{curv['p999_abs_err']:.3e}, max |d| / (1 + |k|) "
          f"{curv['max_rel_err']:.3e} (|k| up to {curv['max_abs_k']:.1f}), "
          f"{curv['ns_per_position']:.3f} ns/position (CUDA events)",
          flush=True)
    check(normal_rel <= 1e-5, f"phase M: eval_normal card vs CPU "
          f"{normal_rel}")
    check(curv["max_rel_err"] <= 1e-3, f"phase M: eval_curvature card vs "
          f"CPU {curv}")

    # M4. world training on the scene
    wopt = vars(train_main.init_parser().parse_args(
        [scene_path, os.path.join(out_dir, "grid_world.npz")]
        + WORLD_ARGS[1:]))
    n, batch = wopt["samples"], wopt["batch_size"]
    t0 = time.perf_counter()
    ds = world.build_world_dataset(ref, n, sampler=wopt["sampler"],
                                   device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ds_cpu = world.build_world_dataset(ref, n, sampler=wopt["sampler"],
                                       device=cpu)
    terr = max_err(ds.targets.cpu(), ds_cpu.targets)
    check(torch.equal(ds.positions.cpu(), ds_cpu.positions)
          and terr <= 1e-6, f"phase M: world dataset card vs CPU {terr}")
    loss = LossNetWorld(mode="density", l1=wopt["l1"], l2=wopt["l2"])
    perm = prng.permutation(prng.split(prng.prng_key(0))[1], n, device=dev)
    loss_rel, grad_rel, worst = world_first_step("phase M", wopt, loss, ds,
                                                 ds_cpu, perm[:batch])
    reset_counts()
    t0 = time.perf_counter()
    wres = train_main.run(wopt)
    torch.cuda.synchronize()
    wrun_s = time.perf_counter() - t0
    c_world = counts()
    whist = wres["history"]
    check(len(whist) == wopt["epochs"]
          and all(math.isfinite(v) for v in whist) and whist[1] < whist[0],
          f"phase M world: losses {whist}")
    net = train_main.make_network(wopt).to(dev)
    step = world.make_train_step(loss, make_optimizer(
        net.parameters(), wopt["optimizer"], lr=wopt["lr"]))
    batches = [world.WorldDataset(*(a[perm[i * batch:(i + 1) * batch]]
                                    for a in ds)) for i in range(n // batch)]

    def epoch():
        for b in batches:
            step(net, b)
    wstep_ms = cuda_ms(epoch, 1) / len(batches)
    print(f"phase M world [{smi}]: train.main.run {os.path.basename(scene_path)}"
          f" --mode world, {n} halton samples, batch {batch}, "
          f"{wopt['epochs']} epochs in {wrun_s:.2f} s, losses {whist}, "
          f"launches {c_world}; dataset build {build_s:.4f} s (host "
          f"clock), targets card vs CPU {terr:.2e}; first step loss rel "
          f"{loss_rel:.2e}, worst leaf {worst} {grad_rel[worst]:.2e}; step "
          f"{wstep_ms:.4f} ms (CUDA events, an epoch after a warm-up)",
          flush=True)

    # M5. screen training on the scene: rows 2-3 with the grid as truth
    sopt = vars(train_main.init_parser().parse_args(
        [scene_path, os.path.join(out_dir, "grid_screen.npz")]
        + TRAIN_ARGS[1:] + ["-i", "1"]))
    cfg = RayEvaluationSteppingDvr.make(**dict(
        sc.evaluator.ray_config.__dict__, stepsize=sopt["stepsize"]))
    t0 = time.perf_counter()
    sds = build_screen_dataset(ref, tf, cfg,
                               num_cameras=sopt["screen_cameras"],
                               width=WIDTH, height=HEIGHT, device=dev)
    torch.cuda.synchronize()
    sds_s = time.perf_counter() - t0
    steps = sopt["screen_cameras"] * sopt["epochs"]
    reset_counts()
    t0 = time.perf_counter()
    sres = train_main.run(sopt)
    torch.cuda.synchronize()
    srun_s = time.perf_counter() - t0
    c_screen = counts()
    shist = sres["history"]
    check(sres["fused"] and all(math.isfinite(v) for v in shist),
          f"phase M screen: fused {sres['fused']}, losses {shist}")
    check(c_screen["mega_fwd_diff"] >= steps and c_screen["mega_bwd"] >= steps,
          f"phase M screen: launches {c_screen} in {steps} steps")
    # the first step's kernels against their plain version at full frame:
    # the run's initial weights, camera 0's block-ordered rays, L1 against
    # the grid's render
    kw = screen_mega_kwargs(sds)
    rs = sds.ray_start[0][kw["block_perm"]].contiguous()
    rd = sds.ray_dir[0][kw["block_perm"]].contiguous()
    target = sds.targets[0][kw["block_perm"]]
    snet = train_main.make_network(sopt).to(dev)
    tf_d = tf.tensor.to(dev)
    seed = {}

    def fwd_bwd(fn):
        snet.zero_grad(set_to_none=True)
        tf_leaf = tf_d.clone().requires_grad_(True)
        img, f_ms = cuda_once(lambda: fn(rs, rd, snet, *box, tf_leaf,
                                         stepsize=STEPSIZE,
                                         differentiable=True))
        if "d" not in seed:
            seed["d"] = torch.sign(img.detach() - target) / img.numel()
        _, b_ms = cuda_once(lambda: img.backward(seed["d"]))
        return img.detach(), grads_of(snet, tf_leaf), f_ms, b_ms

    img_p, g_p, pf_ms, pb_ms = fwd_bwd(fused_mega.mega_trace_dvr_plain)
    fwd_bwd(fused_mega.mega_trace_dvr)
    img_k, g_k, kf_ms, kb_ms = fwd_bwd(fused_mega.mega_trace_dvr)
    simg_err = max_err(img_k, img_p)
    sgrad = {k: rel_err(g_k[k], g_p[k]) for k in g_p}
    sworst = max(sgrad, key=sgrad.get)
    print(f"phase M screen [{smi}]: train.main.run screen {WIDTH}x{HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)}, {steps} steps in {srun_s:.2f} s, "
          f"losses {shist}, launches {c_screen}; dataset build (the plain "
          f"trace_dvr of the grid, {sopt['screen_cameras']} cameras) "
          f"{sds_s:.3f} s (host clock); first step kernels vs plain: image "
          f"max|d| {simg_err:.3e} (tol {KERNEL_TOL}), grad rel max "
          f"{sgrad[sworst]:.3e} ({sworst}, tol {GRAD_TOL}); kernels fwd "
          f"{kf_ms:.2f} + bwd {kb_ms:.2f} ms, plain {pf_ms:.1f} + "
          f"{pb_ms:.1f} ms", flush=True)
    check(simg_err <= KERNEL_TOL, f"phase M screen: image kernel vs plain "
          f"{simg_err}")
    check(all(float(g.norm()) > 0 for g in g_p.values()),
          "phase M screen: a zero gradient")
    check(sgrad[sworst] <= GRAD_TOL, f"phase M screen: gradients {sgrad}")

    # M6. the reference render and the world-trained network's FUSED one
    model = LoadedModel(wres["network"], tf, config=RayEvaluationSteppingDvr
                        .make(stepsize=STEPSIZE), reference_volume=ref)
    cam = CameraOnASphere.make(**CAMERA)
    ref_img = model.render_reference(cam, WIDTH, HEIGHT, device=dev)
    ref_ms = cuda_ms(lambda: model.render_reference(cam, WIDTH, HEIGHT,
                                                    device=dev), 2)
    render = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED",
                                          device=dev)
    reset_counts()
    net_img = render()
    torch.cuda.synchronize()
    c_render = counts()
    frame_ms = cuda_ms(render, 5)
    check(render.route == "mega" and c_render["mega_fwd"] >= 1,
          f"phase M render: route {render.route}, launches {c_render}")
    check(bool(torch.isfinite(ref_img).all() and torch.isfinite(net_img).all())
          and float(ref_img[..., 3].max()) > 0.5,
          "phase M render: non-finite pixels or an empty reference")
    mse = float(((net_img - ref_img) ** 2).mean())
    psnr = 10 * math.log10(1.0 / max(mse, 1e-30))
    print(f"phase M render [{smi}]: render_reference {WIDTH}x{HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)} {ref_ms:.2f} ms (the plain trace_dvr "
          f"of the grid, CUDA events); the world-trained network FUSED "
          f"(route {render.route}) {frame_ms:.3f} ms, launches {c_render}; "
          f"PSNR vs the reference {psnr:.2f} dB after {wopt['epochs']} "
          "epochs (not gated)", flush=True)

    # M7. a curvature-texture iso render of the grid, card vs CPU
    tex = np.random.default_rng(11).random((32, 32, 4)).astype(np.float32)
    icfg = RayEvaluationSteppingIso.make(
        stepsize=1 / 256, isovalue=0.5, surface_feature="curvature_texture",
        isocontour_range=GRID_ISO_RANGE, isocontour_texture=tex)
    isteps = max_steps_bound(ref.box_size.tolist(), icfg.stepsize)
    iso = []
    for d in (dev, cpu):
        irs, ird = generate_rays(cam, GRID_ISO_SIZE, GRID_ISO_SIZE, device=d)
        t0 = time.perf_counter()
        iso.append(trace_iso(irs[0], ird[0], ref.to(d), icfg,
                             isteps).color.cpu())
        iso.append(time.perf_counter() - t0)
    ic, iso_s, icc, _ = iso
    hit = float((icc[..., 3] > 0.5).float().mean())
    close = float(((ic - icc).abs() <= KERNEL_TOL).all(dim=-1).float().mean())
    print(f"phase M iso [{smi}]: curvature-texture iso {GRID_ISO_SIZE}^2, "
          f"1/256, hit share {hit:.4f}, pixels card = CPU within "
          f"{KERNEL_TOL}: {close:.5f} (gate {GRID_ISO_SHARE}), card "
          f"{iso_s:.3f} s (host clock)", flush=True)
    check(hit > 0.1 and close >= GRID_ISO_SHARE,
          f"phase M iso: hit share {hit}, close share {close}")
    return {"io": io, "samplers": samplers, "normal_rel": normal_rel,
            "curvature": curv, "world_step_ms": wstep_ms,
            "world_dataset_s": build_s, "world_losses": whist,
            "screen_dataset_s": sds_s, "screen_losses": shist,
            "screen_img_err": simg_err, "screen_grad_rel": sgrad[sworst],
            "reference_ms": ref_ms, "frame_ms": frame_ms, "psnr": psnr,
            "iso_close_share": close,
            "launches": {"mega_fwd": c_render["mega_fwd"],
                         "mega_fwd_diff": c_screen["mega_fwd_diff"],
                         "mega_bwd": c_screen["mega_bwd"]}}


def image_check(phase, got, want, mode, share=TF_FLIP_SHARE):
    """(largest error, share of rays off KERNEL_TOL) of a TF mode's kernel
    image against its plain version; fails past the mode's bound (every
    ray, or for the discontinuous modes ``share`` of the rays, by default
    TF_FLIP_SHARE, within TF_FLIP_TOL)."""
    err = (got - want).abs().reshape(-1, 4).amax(dim=1)
    mx, off = float(err.max()), float((err > KERNEL_TOL).float().mean())
    if mode in ("preint1d", "preint2d"):
        check(off <= share and mx <= TF_FLIP_TOL,
              f"{phase} {mode}: kernel vs plain {mx} ({off} of the rays)")
    else:
        check(mx <= KERNEL_TOL, f"{phase} {mode}: kernel vs plain {mx}")
    return mx, off


def tf_step(march, args, tf, pre, kw):
    """(image, gradients incl. "tf" and "pre") of one differentiable
    march on the flagship with loss mean(img^2)."""
    net = args[2]
    net.zero_grad(set_to_none=True)
    tf_leaf = tf.detach().clone().requires_grad_(True)
    pre_leaf = (pre.detach().clone().requires_grad_(True)
                if pre is not None else None)
    img = march(*args, tf_leaf, tf_pre=pre_leaf, **kw)
    (img ** 2).mean().backward()
    g = {n: p.grad.detach().clone() for n, p in net.named_parameters()
         if p.grad is not None}
    for name, leaf in (("tf", tf_leaf), ("pre", pre_leaf)):
        if leaf is not None and leaf.grad is not None:
            g[name] = leaf.grad.detach().clone()
    return img.detach(), g


def tf_modes(smi, reset_counts, counts, npz, cam, frame_ms):
    """Phase N, the TF modes of rows 1-6 (see the module doc), each timed
    beside the piecewise ramp's figures from the same call (``frame_ms``:
    phase 6's frame; the rest timed here). Returns {mode: {figures}} with
    "piecewise" among them, and the trainer's counts."""
    from fvsrn_tpu_torch.camera import camera_matrix, generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_tf_args)
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.scenes import dense_scene, dense_tf_modes
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train.checkpoints import load_weights

    dev = torch.device(DEVICE)
    root = os.path.dirname(os.path.abspath(__file__))
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    modes = dense_tf_modes(STEPSIZE)
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)
    steps = max_steps_bound(box[1], STEPSIZE)

    # N1. the trainer on a scene JSON naming a texture TF (rows 2-3)
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    tex = modes["texture"].tensor
    scene_path = os.path.join(out_dir, "mlobb_texture.json")
    with open(scene_path, "w") as f:
        json.dump({
            "ImageEvaluator": {"Simple": {
                "selectedCamera": "Sphere", "selectedRayEvaluator": "DVR",
                "selectedVolume": "Implicit"}},
            "RayEvaluation": {"DVR": {"stepsize": STEPSIZE,
                                      "selectedTF": "Texture"}},
            "camera": {"Sphere": dict(CAMERA)},
            "tf": {"Texture": {
                "absorptionScaling": 1.0,
                "colorPoints": [[(i + 0.5) / tex.shape[0], *tex[i, :3]
                                 .tolist()] for i in range(tex.shape[0])],
                "opacityPoints": tex[:, 3].tolist()}},
            "volume": {"Implicit": {"function": "MarschnerLobb"}}}, f)
    opt = vars(train_main.init_parser().parse_args(
        [scene_path, os.path.join(out_dir, "train_texture.npz")]
        + TRAIN_ARGS[1:] + ["-i", "1"]))
    reset_counts()
    t0 = time.perf_counter()
    result = train_main.run(opt)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer_counts = counts()
    hist = result["history"]
    print(f"phase N trainer: train.main.run screen on a texture-TF scene "
          f"JSON, {WIDTH}x{HEIGHT} h=1/{round(1 / STEPSIZE)}, 2 steps in "
          f"{train_s:.1f} s (dataset included), fused {result['fused']}, "
          f"losses {hist}, launches {trainer_counts}", flush=True)
    check(result["fused"] and all(math.isfinite(v) for v in hist),
          f"phase N trainer: fused {result['fused']}, losses {hist}")
    check(trainer_counts["mega_fwd_diff"] >= 2
          and trainer_counts["mega_bwd"] >= 2,
          f"phase N trainer: launches {trainer_counts}")

    net = load_weights(npz).to(dev)
    rs, rd = generate_rays(camera_matrix(cam), WIDTH, HEIGHT,
                           cam.fov_y_radians, device=dev)
    rs = rs.reshape(-1, 3).contiguous()
    rd = rd.reshape(-1, 3).contiguous()
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    rs_b, rd_b = rs[perm].contiguous(), rd[perm].contiguous()
    vol = VolumeInterpolationNetwork(net, *box)
    n_o = TF_ORACLE_RAYS
    engines = (
        ("mega", ("mega_fwd_diff", "mega_bwd"), fused_mega.mega_trace_dvr,
         fused_mega.mega_trace_dvr_plain,
         dict(stepsize=STEPSIZE, differentiable=True), rs_b, rd_b),
        ("scan", ("segment_fwd_diff", "segment_bwd"),
         fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain,
         dict(stepsize=STEPSIZE, max_steps=steps, enable_early_out=False,
              differentiable=True), rs, rd))
    # the piecewise ramp's figures in this call
    ramp = dense_scene()[1].tensor.to(dev)
    pw = {"frame_ms": frame_ms,
          "row1_ms": cuda_ms(lambda: fused_mega.mega_trace_dvr(
              rs_b, rd_b, net, *box, ramp, stepsize=STEPSIZE), 5),
          "row4_ms": cuda_ms(lambda: fused_dvr.fused_trace_dvr(
              rs, rd, net, *box, ramp, stepsize=STEPSIZE, max_steps=steps,
              tile=128, table_dtype=torch.bfloat16), 5)}
    for engine, _, march, _, kw, r_, d_ in engines:
        pw[f"{engine}_step_ms"] = cuda_ms(lambda: tf_step(
            march, (r_, d_, net, *box), ramp, None, kw), N_TIMED_STEPS)
    print(f"phase N piecewise [{smi}]: frame {pw['frame_ms']:.3f} ms, row 1 "
          f"{pw['row1_ms']:.3f} ms, row 4 {pw['row4_ms']:.3f} ms, step mega "
          f"{pw['mega_step_ms']:.3f} ms, scan {pw['scan_step_ms']:.3f} ms "
          "(fwd + mean(img^2) + bwd)", flush=True)
    figures = {"piecewise": pw}
    for mode, tfo in modes.items():
        tfo = tfo.to(dev)
        tensor, tf_kw = fused_tf_args(tfo)
        pre = tf_kw.pop("tf_pre", None)
        fig = {}
        # N2. row 1, route 1: the product render (its clip), or for the
        # Gaussians, which it refuses, the megakernel on its rays
        model = LoadedModel(net, tfo, config=cfg)
        if mode == "gaussian":
            try:
                model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED",
                                             device=dev)
                fail("phase N: the FUSED render took a Gaussian TF")
            except NotImplementedError:
                pass
            args = (rs_b, rd_b, net, *box, tensor)
            kw = dict(stepsize=STEPSIZE, tf_pre=pre, **tf_kw)
            clip = None

            def frame(fn=fused_mega.mega_trace_dvr):
                return fn(*args, **kw)
        else:
            render = model.prepare_network_render(cam, WIDTH, HEIGHT,
                                                  "FUSED", device=dev)
            check(render.route == "mega"
                  and render.march_kwargs["tf_mode"] == mode,
                  f"phase N {mode}: route {render.route}")
            clip = render.tmax_clip

            def frame(fn=None):
                return render() if fn is None else render.march(fn)
        reset_counts()
        img = frame()
        torch.cuda.synchronize()
        c1 = counts()
        check(c1["mega_fwd"] == 1 and bool(torch.isfinite(img).all())
              and float(img[..., 3].max()) > 0.5,
              f"phase N {mode} row 1: launches {c1}")
        got = frame(fused_mega.mega_trace_dvr).reshape(-1, 4)
        plain, plain_ms = cuda_once(
            lambda: frame(fused_mega.mega_trace_dvr_plain).reshape(-1, 4))
        fig["row1_err"], fig["row1_off"] = image_check("phase N row 1", got,
                                                       plain, mode)
        # whole tiles spread over the frame (the megakernel's tiles march
        # on their own)
        tiles = torch.linspace(0, rs_b.shape[0] // 256 - 1, n_o // 256,
                               device=dev).long()
        sel = (tiles[:, None] * 256 + torch.arange(256, device=dev)
               ).reshape(-1)
        fig["row1_oracle"] = None
        if mode in N_ROW4_ORACLE:
            with torch.no_grad():
                oracle = trace_dvr(rs_b[sel], rd_b[sel], vol, tfo, ocfg,
                                   steps, tmax_in=None if clip is None
                                   else clip[sel], lattice=True).color
            fig["row1_oracle"] = float((got[sel] - oracle).abs().max())
            check(fig["row1_oracle"] < ORACLE_TOL,
                  f"phase N {mode} row 1 vs oracle {fig['row1_oracle']}")
        fig["frame_ms"] = cuda_ms(frame, 5)
        fig["row1_ms"] = cuda_ms(lambda: frame(fused_mega.mega_trace_dvr), 5)
        fig["row1_plain_ms"] = plain_ms
        fig["row1_launches"] = c1["mega_fwd"]
        per_sample = sample_flops(net) + TF_FLOPS[mode]
        n1 = int(fused_mega.mega_trace_dvr(
            rs_b, rd_b, net, *box, tensor, stepsize=STEPSIZE, tmax_clip=clip,
            tf_pre=pre, return_samples=True, **tf_kw)[1].sum())
        fig["row1_samples"] = n1
        fig["row1_bound_ms"] = n1 * per_sample / PEAK_BF16_TC * 1e3

        # N3. row 4: the per-segment engine on route 2's (row-major) rays
        seg_kw = dict(stepsize=STEPSIZE, max_steps=steps, tile=128,
                      table_dtype=torch.bfloat16, tf_pre=pre, **tf_kw)
        reset_counts()
        got4 = fused_dvr.fused_trace_dvr(rs, rd, net, *box, tensor,
                                         **seg_kw)
        torch.cuda.synchronize()
        c4 = counts()
        check(c4["segment_fwd"] == 2,
              f"phase N {mode} row 4: launches {c4}")
        plain4, plain4_ms = cuda_once(lambda: fused_dvr.fused_trace_dvr_plain(
            rs, rd, net, *box, tensor, **seg_kw))
        fig["row4_err"], fig["row4_off"] = image_check("phase N row 4", got4,
                                                       plain4, mode)
        fig["row4_oracle"] = None
        if mode in N_ROW4_ORACLE:
            sel = torch.arange(0, rs.shape[0], rs.shape[0] // n_o,
                               device=dev)
            with torch.no_grad():
                oracle4 = trace_dvr(rs[sel], rd[sel], vol, tfo, ocfg,
                                    steps).color
            fig["row4_oracle"] = float((got4[sel] - oracle4).abs().max())
            check(fig["row4_oracle"] < ORACLE_TOL,
                  f"phase N {mode} row 4 vs oracle {fig['row4_oracle']}")
        fig["row4_ms"] = cuda_ms(lambda: fused_dvr.fused_trace_dvr(
            rs, rd, net, *box, tensor, **seg_kw), 5)
        fig["row4_plain_ms"] = plain4_ms
        fig["row4_launches"] = c4["segment_fwd"]
        n4 = int(fused_dvr.fused_trace_dvr(rs, rd, net, *box, tensor,
                                           return_stats=True,
                                           **seg_kw)[1].samples)
        fig["row4_samples"] = n4
        fig["row4_bound_ms"] = n4 * per_sample / PEAK_BF16_TC * 1e3

        # N4. one differentiable step on each engine at full frame (its
        # launches counted, timed), the kernels vs the plain pair on
        # ORACLE_TILES whole 256-ray tiles spread over the frame (the
        # plain pair's full-frame steps took ~60 s of the phase)
        for engine, rows, march, plain_march, mkw, r_, d_ in engines:
            kw = dict(mkw, **tf_kw)
            args = (r_, d_, net, *box)
            reset_counts()
            tf_step(march, args, tensor, pre, kw)
            torch.cuda.synchronize()
            ck = counts()
            check(ck[rows[0]] == 1 and ck[rows[1]] == 1,
                  f"phase N {mode} {engine} step: launches {ck}")
            n_t = r_.shape[0] // 256
            step_tiles = torch.arange(0, n_t, n_t // ORACLE_TILES,
                                      device=dev)[:ORACLE_TILES]
            step_sel = (step_tiles[:, None] * 256
                        + torch.arange(256, device=dev)).reshape(-1)
            args = (r_[step_sel].contiguous(), d_[step_sel].contiguous(),
                    net, *box)
            img_k, g_k = tf_step(march, args, tensor, pre, kw)
            (img_p, g_p), pms = cuda_once(
                lambda: tf_step(plain_march, args, tensor, pre, kw))
            ierr, ioff = image_check(f"phase N {engine} step", img_k, img_p,
                                     mode)
            check(sorted(g_k) == sorted(g_p), f"phase N {mode}: leaves")
            rel = {n: (rel_err(g_k[n], g_p[n]) if float(g_p[n].norm()) > 0
                       else float(g_k[n].norm())) for n in g_p}
            tol = {n: GRAD_TOL for n in g_p}
            if mode in ("preint1d", "preint2d"):
                moved = copy.deepcopy(net)
                gen = torch.Generator(dev).manual_seed(0)
                with torch.no_grad():
                    for p in moved.parameters():
                        p.mul_(1.0 + TF_FLIP_EPS * torch.randn(
                            p.shape, device=dev, generator=gen))
                _, g_q = tf_step(plain_march, (*args[:2], moved, *box),
                                 tensor, pre, kw)
                tol = {n: max(GRAD_TOL, TF_FLIP_GRAD * rel_err(g_q[n], g_p[n]))
                       if float(g_p[n].norm()) > 0 else GRAD_TOL for n in g_p}
            worst = max(rel, key=lambda n: rel[n] / tol[n])
            check(rel[worst] <= tol[worst],
                  f"phase N {mode} {engine}: grad {worst} {rel[worst]} "
                  f"(tol {tol[worst]})")
            fig[f"{engine}_grad_tol"] = tol[worst]
            fig[f"{engine}_step_ms"] = cuda_ms(
                lambda: tf_step(march, (r_, d_, net, *box), tensor, pre, kw),
                N_TIMED_STEPS)
            fig[f"{engine}_plain_ms"] = pms
            fig[f"{engine}_img_err"] = ierr
            fig[f"{engine}_grad_rel"] = rel[worst]
            fig[f"{engine}_grad_worst"] = worst
            fig[f"{engine}_launches"] = [ck[rows[0]], ck[rows[1]]]
        print(f"phase N {mode} [{smi}]: row 1 frame {fig['frame_ms']:.3f} "
              f"ms (piecewise {pw['frame_ms']:.3f}), kernel "
              f"{fig['row1_ms']:.3f} ms, plain {plain_ms:.1f} ms, vs plain "
              f"max|d| {fig['row1_err']:.3e} ({fig['row1_off']:.2e} of rays "
              f"> {KERNEL_TOL}), vs oracle {fig['row1_oracle']}, "
              f"bound {fig['row1_bound_ms']:.4f} ms ({n1} samples); row 4 "
              f"{fig['row4_ms']:.3f} ms (piecewise {pw['row4_ms']:.3f}), "
              f"plain {plain4_ms:.1f} ms, vs plain "
              f"{fig['row4_err']:.3e} ({fig['row4_off']:.2e}), vs oracle "
              f"{fig['row4_oracle']}, bound {fig['row4_bound_ms']:.4f} "
              f"ms ({n4} samples); step mega "
              f"{fig['mega_step_ms']:.3f} ms (piecewise "
              f"{pw['mega_step_ms']:.3f}), grad rel "
              f"{fig['mega_grad_rel']:.2e} ({fig['mega_grad_worst']}, tol "
              f"{fig['mega_grad_tol']:.2e}); step "
              f"scan {fig['scan_step_ms']:.3f} ms (piecewise "
              f"{pw['scan_step_ms']:.3f}), grad rel "
              f"{fig['scan_grad_rel']:.2e} ({fig['scan_grad_worst']}, tol "
              f"{fig['scan_grad_tol']:.2e}); plain "
              f"steps on {ORACLE_TILES} tiles {fig['mega_plain_ms']:.0f} / "
              f"{fig['scan_plain_ms']:.0f} ms", flush=True)
        figures[mode] = fig
    return figures, trainer_counts


def mega_instances(width):
    """{instance: (registers, spill stores, spill loads)} of the
    megakernels' instances at ``width`` from the build's ptxas report, an
    instance named by its kernel and mangled template arguments
    (``mega_fwd<Li64EN5march9Bf16TableELb0ELi0ELin1E>``: width 64, bf16
    table, unmasked, piecewise, any activation)."""
    import re

    from fvsrn_tpu_torch.ops import _build

    out = {}
    for lib in ("mega_fwd", "mega_fwd_tf", "mega_fwd_any", "mega_bwd"):
        name = lib if width == 32 else f"{lib}{width}"
        kind = lib.removesuffix("_tf").removesuffix("_any")
        for fn, v in _build.ptxas_instances(
                _build.ptxas_report(name)).items():
            args = re.search(r"_kernelI(.*?)EEv", fn)
            out[f"{kind}<{args.group(1) if args else fn}>"] = v[:3]
    return out


def networks(smi, reset_counts, counts, tf, cam):
    """Phase O, the networks of the paper's sweeps on rows 1-3: the
    widest of eval_network_configs.py (64:64:64, 16x32^3) trained by
    ``train.main.run`` in screen mode (rows 2-3), rendered FUSED at 512^2,
    1/512 (row 1) and one training step, both timed; then every case of
    NET_CASES at NET_SIZE^2: the FUSED render (route 1) kernel vs plain
    and vs the f32 lattice oracle, the differentiable pair kernel vs
    plain (image, every gradient leaf) and each kernel timed. Returns
    {row name: {case: figures}}, every width's ptxas, and the trainer's
    launches."""
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops import fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

    dev = torch.device(DEVICE)
    root = os.path.dirname(os.path.abspath(__file__))
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)
    steps_max = max_steps_bound(box[1], STEPSIZE)
    tf_d = tf.tensor.to(dev)
    rows = {"mega_fwd": {}, "mega_fwd_diff": {}, "mega_bwd": {}}
    t_phase = time.perf_counter()

    # O1. the widest network trained by the trainer (rows 2-3)
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    opt = vars(train_main.init_parser().parse_args(
        NET_TRAIN_ARGS[:1] + [os.path.join(out_dir, "net64_run.npz")]
        + NET_TRAIN_ARGS[1:]))
    steps = opt["screen_cameras"] * opt["epochs"]
    reset_counts()
    t0 = time.perf_counter()
    result = train_main.run(opt)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer_counts = counts()
    hist = result["history"]
    print(f"phase O1 trainer: 64:64:64 SnakeAlt:2, 16x32^3, train.main.run "
          f"screen {NET_SIZE}x{NET_SIZE}, {steps} steps in {train_s:.1f} s, "
          f"fused {result['fused']}, losses {hist}, launches "
          f"{trainer_counts}", flush=True)
    check(result["fused"] and all(math.isfinite(v) for v in hist),
          f"phase O1: fused {result['fused']}, losses {hist}")
    check(trainer_counts["mega_fwd_diff"] >= steps
          and trainer_counts["mega_bwd"] >= steps,
          f"phase O1: launches {trainer_counts}")
    trained = result["network"].to(dev)

    def bound_ms(flops):
        return flops / PEAK_BF16_TC * 1e3

    def noisy(net, seed=3):
        """``net`` with every parameter times (1 + NOISE_EPS N(0, 1))."""
        out = copy.deepcopy(net)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for p in out.parameters():
                p.mul_(1.0 + NOISE_EPS * torch.randn(
                    p.shape, device=p.device, generator=gen))
        return out

    def block_rays(size):
        rs, rd = generate_rays(cam, size, size, device=dev)
        perm, _ = block_ray_permutation(size, size, 16, 16, device=dev)
        return (rs.reshape(-1, 3)[perm].contiguous(),
                rd.reshape(-1, 3)[perm].contiguous())

    def render_case(net, size, iters, ill=False, oracle_check=True):
        """Row 1 on the product render: (figures, the prepared render).
        With ``oracle_check`` the f32 oracle is held against the kernel
        on a float32 table:
        the product's bf16 table moves a Sine:30 network's image by
        ~6e-2 in its own right (30x pre-activations); that distance is
        recorded, not gated."""
        model = LoadedModel(net, tf, config=cfg)
        render = model.prepare_network_render(cam, size, size, "FUSED",
                                              device=dev)
        check(render.route == "mega", f"phase O: route {render.route}")
        reset_counts()
        img = render()
        torch.cuda.synchronize()
        c = counts()
        check(c["mega_fwd"] >= 1 and bool(torch.isfinite(img).all()),
              f"phase O: render launches {c}")
        got, samples = render.march(return_samples=True)
        plain, plain_ms = cuda_once(
            lambda: render.march(fused_mega.mega_trace_dvr_plain))
        err = float((got - plain).abs().max())
        tol = KERNEL_TOL
        if ill:
            moved_net = noisy(render.network)
            moved = render.march(lambda rs, rd, _net, *a, **k:
                                 fused_mega.mega_trace_dvr_plain(
                                     rs, rd, moved_net, *a, **k))
            tol = max(tol, NOISE_FLIP * float((moved - plain).abs().max()))
        check(err <= tol, f"phase O: render kernel vs plain {err} "
              f"(tol {tol})")
        sel = slice(None)
        if size * size > ORACLE_TILES * 256:   # 64 tiles spread over it
            n = size * size // 256
            tiles = torch.arange(0, n, n // ORACLE_TILES,
                                 device=dev)[:ORACLE_TILES]
            sel = (tiles[:, None] * 256
                   + torch.arange(256, device=dev)).reshape(-1)
        oerr = oerr_bf16 = None
        if oracle_check:
            vol = VolumeInterpolationNetwork(render.network, *box)
            with torch.no_grad():
                oracle = trace_dvr(
                    render.ray_start[sel], render.ray_dir[sel], vol,
                    render.tf, ocfg, steps_max, lattice=True,
                    tmax_in=(render.tmax_clip[sel]
                             if render.tmax_clip is not None
                             else None)).color
            got32 = render.march(table_dtype=torch.float32)
            oerr = float((got32[sel] - oracle).abs().max())
            oerr_bf16 = float((got[sel] - oracle).abs().max())
            check(oerr < ORACLE_TOL, f"phase O: render vs oracle {oerr}")
        ms = cuda_ms(lambda: render.march(), iters)
        n_samples = int(samples.sum())
        return {"ms": ms, "launches": c["mega_fwd"], "max_abs_err": err,
                "plain_ms": plain_ms, "tol": tol, "oracle_max_abs_err": oerr,
                "oracle_bf16_max_abs_err": oerr_bf16,
                "samples": n_samples,
                "bound_ms": bound_ms(n_samples * sample_flops(net)),
                "alpha_max": float(got[:, 3].max())}, render

    def pair(fn, net, rs, rd):
        """(image, grads) of one fwd+bwd of mean(img^2)."""
        net.zero_grad(set_to_none=True)
        tf_leaf = tf_d.clone().requires_grad_(True)
        img = fn(rs, rd, net, *box, tf_leaf, stepsize=STEPSIZE,
                 differentiable=True)
        img.backward(2.0 * img.detach() / img.numel())
        return img.detach(), grads_of(net, tf_leaf)

    def train_case(net, size, iters, ill=False):
        """Rows 2-3: the kernels through mega_trace_dvr (launch counts),
        then against the plain differentiable version (image, every
        leaf; the cotangent of mean(img^2)), each kernel timed alone."""
        rs, rd = block_rays(size)
        reset_counts()
        img_k, g_k = pair(fused_mega.mega_trace_dvr, net, rs, rd)
        c = counts()
        check(c["mega_fwd_diff"] >= 1 and c["mega_bwd"] >= 1,
              f"phase O: training launches {c}")
        img_p, g_p = pair(fused_mega.mega_trace_dvr_plain, net, rs, rd)
        img_tol, g_tol = KERNEL_TOL, {n: GRAD_TOL for n in g_p}
        if ill:
            img_n, g_n = pair(fused_mega.mega_trace_dvr_plain, noisy(net),
                              rs, rd)
            img_tol = max(img_tol, NOISE_FLIP * float(
                (img_n - img_p).abs().max()))
            g_tol = {n: max(GRAD_TOL, NOISE_FLIP * rel_err(g_n[n], g_p[n]))
                     for n in g_p if float(g_p[n].norm()) > 0}
        img_err = float((img_k - img_p).abs().max())
        check(img_err <= img_tol, f"phase O: image kernel vs plain "
              f"{img_err} (tol {img_tol})")
        rgbo = not net.output_mode.startswith("density")
        rel = {}
        for n in g_p:
            if n == "tf" and rgbo:   # reads no TF: zero in both
                check(not g_k[n].any() and not g_p[n].any(),
                      "phase O: an rgbo TF gradient")
                continue
            check(float(g_p[n].norm()) > 0, f"phase O: zero gradient {n}")
            rel[n] = rel_err(g_k[n], g_p[n])
            check(rel[n] <= g_tol[n], f"phase O: grad kernel vs plain {n} "
                  f"{rel[n]} (tol {g_tol[n]})")
        worst = max(rel, key=rel.get)
        spec = fused_mega._spec(net, *box, stepsize=STEPSIZE, seg=32,
                                tile=256, density_min=0.0, density_max=1.0,
                                enable_early_out=True)
        rays = fused_mega.ray_packet(rs, rd, *box, STEPSIZE)
        params = fused_mega._params(net, tf_d)
        widths = fused_mega._widths(params)
        weights = fused_mega._pack_weights(params, spec)
        table = fused_mega._kernel_table(params[2], torch.float32, dev)
        n_seg = fused_mega.segments_needed(rays, spec)
        fwd = fused_mega._launch_fwd(rays, weights, table, spec, *widths[:3],
                                     n_seg_max=n_seg)
        d_out = 2.0 * fwd[0] / fwd[0].numel()
        fwd_ms = cuda_ms(lambda: fused_mega._launch_fwd(
            rays, weights, table, spec, *widths[:3], n_seg_max=n_seg), iters)
        bwd_ms = cuda_ms(lambda: fused_mega._launch_bwd(
            rays, weights, table, fwd[2], fwd[3], d_out, spec, *widths),
            iters)
        work = fused_mega._launch_bwd(rays, weights, table, fwd[2], fwd[3],
                                      d_out, spec, *widths)[2].sum(dim=0)
        n_samples = int(fwd[1].sum())
        return ({"ms": fwd_ms, "launches": c["mega_fwd_diff"],
                 "max_abs_err": img_err, "tol": img_tol,
                 "samples": n_samples,
                 "bound_ms": bound_ms(n_samples * sample_flops(net))},
                {"ms": bwd_ms, "launches": c["mega_bwd"],
                 "max_abs_err": rel[worst], "grad_worst": worst,
                 "tol": g_tol[worst],
                 "samples_replayed": int(work[0]),
                 "samples_contributing": int(work[1]),
                 "bound_ms": bound_ms(int(work[0]) * sample_flops(net)
                                      + int(work[1]) * adjoint_flops(net))})

    # O2. the trained 64:64:64 network: FUSED at 512^2 and one step, timed
    fig1, render = render_case(trained, WIDTH, 10)
    frame_ms, frame_std, _ = LoadedModel(trained, tf, config=cfg) \
        .time_rendering(LoadedModel.rotation_cameras(TIMED_CAMERAS), WIDTH,
                        HEIGHT)
    fig1["frame_ms"] = frame_ms
    rs, rd = block_rays(WIDTH)
    with torch.no_grad():
        target = trace_dvr(rs, rd, VolumeInterpolationImplicit.make(
            "MARSCHNER_LOBB", device=dev), tf.to(dev), cfg, steps_max).color
    tnet = copy.deepcopy(trained)
    opt_, sched = make_optimizer(tnet.parameters(), "Adam", lr=1e-3)

    def train_step():
        opt_.zero_grad(set_to_none=True)
        img = fused_mega.mega_trace_dvr(rs, rd, tnet, *box, tf_d,
                                        stepsize=STEPSIZE,
                                        differentiable=True)
        (img - target).abs().mean().backward()
        opt_.step()
        sched.step()

    step_ms = cuda_ms(train_step, TIMED_STEPS)
    name = "64:64:64 16x32^3"
    rows["mega_fwd"][name] = fig1
    fig2, fig3 = train_case(trained, NET_SIZE, 3)
    fig2["step_ms_512"] = fig3["step_ms_512"] = step_ms
    rows["mega_fwd_diff"][name] = fig2
    rows["mega_bwd"][name] = fig3
    print(f"phase O2 64:64:64 [{smi}]: FUSED {WIDTH}x{HEIGHT} frame "
          f"{frame_ms:.3f} ms (std {frame_std:.3f}), kernel "
          f"{fig1['ms']:.3f} ms (bound {fig1['bound_ms']:.4f}, "
          f"{fig1['samples']} samples), plain {fig1['plain_ms']:.1f} ms, "
          f"vs plain {fig1['max_abs_err']:.2e}, vs oracle "
          f"{fig1['oracle_max_abs_err']:.2e}; training step {step_ms:.3f} "
          f"ms; at {NET_SIZE}^2 fwd {fig2['ms']:.3f} ms, bwd "
          f"{fig3['ms']:.3f} ms, grad rel {fig3['max_abs_err']:.2e} "
          f"({fig3['grad_worst']})", flush=True)

    # O3. the cases at NET_SIZE^2
    for name, (kw, grid) in NET_CASES.items():
        lat = LatentSpace()
        if grid is not None:
            c, r = grid
            g = np.random.default_rng(7).standard_normal((c, r, r, r)) * 0.3
            lat = LatentSpace(static_grid=torch.tensor(g, dtype=torch.float32))
        net = SceneRepresentationNetwork.make(latent=lat, seed=7, **kw).to(dev)
        ill = name in NET_ILL
        if grid is not None:
            rows["mega_fwd"][name] = render_case(
                net, NET_SIZE, 5, ill, oracle_check=name in O3_ORACLE)[0]
        f2, f3 = train_case(net, NET_SIZE, 3, ill)
        rows["mega_fwd_diff"][name] = f2
        rows["mega_bwd"][name] = f3
        f1 = rows["mega_fwd"].get(name)
        print(f"phase O3 {name}: "
              + (f"render {f1['ms']:.3f} ms vs plain {f1['max_abs_err']:.2e}"
                 f" vs oracle {f1['oracle_max_abs_err']}; "
                 if f1 else "no grid: route 2 renders it; ")
              + f"fwd {f2['ms']:.3f} ms image {f2['max_abs_err']:.2e}, bwd "
              f"{f3['ms']:.3f} ms grad rel {f3['max_abs_err']:.2e} "
              f"({f3['grad_worst']})", flush=True)
    ptxas = {w: mega_instances(w) for w in (32, 48, 64)}
    for w in (48, 64):
        print(f"phase O ptxas width {w}: " + "; ".join(
            f"{k} {v}" for k, v in ptxas[w].items()), flush=True)
    print(f"phase O: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, ptxas, trainer_counts, trained


def position_grad_flops(net):
    """Operations of one sample's position gradient beyond its forward:
    the transposed layers (as many multiply-adds as the forward), the
    Fourier features' chain (d_cos, d_sin -> d_phase -> B^T: 4 a feature
    and 6) and the trilinear derivative (16 channels x 8 corners, x 3
    axes)."""
    f = net.input.num_fourier
    mlp = sum(l.weight.numel() for l in net.layers)
    return 2 * mlp + 10 * f + 8 * 16 * 2 + 3 * 8 * 2


def nrm_off(got, want, shaded=True):
    """(share of rays off the normals contract, worst ratio to its
    tolerance) of two RayEvaluationOutputs (NRM_FLIP_SHARE's gates)."""
    err = torch.stack([
        (got.color - want.color).abs().amax(1) / (2e-4 if shaded else 1e-4),
        (got.normal - want.normal).abs().amax(1) / 5e-4,
        (got.depth - want.depth).abs().amax(1) / 1e-4], 1).amax(1)
    return float((err > 1.0).float().mean()), float(err.max())


def normals(smi, reset_counts, counts, npz, tf, cam, net64):
    """Phase P, normals and shading: row 1's and row 4's normals instances
    on the dense flagship at 512^2, 1/512 (shaded with the JAX tests'
    BRDF and with a point light, timed beside the unshaded render of the
    same call; kernel vs plain and vs the f32 oracle on 64 whole tiles),
    the networks (the trained 64:64:64 of phase O, a 48-wide ReLU network
    with direction input) at 128^2 on both tables, the MC walk with a
    gradient-scaled Gaussian through row 7's gradient instance at 256^2,
    and ``eval_gradient_networks`` at its defaults. Returns {row name:
    figures}."""
    from fvsrn_tpu_torch.brdf import BRDFLambert
    from fvsrn_tpu_torch.eval import eval_gradient_networks as ev
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import _build, fused_dvr, fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_trace_dvr,
                                               fused_trace_dvr_plain)
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.raytracer.montecarlo import (RayEvaluationMonteCarlo,
                                                      trace_mc)
    from fvsrn_tpu_torch.train.checkpoints import load_weights
    from fvsrn_tpu_torch.transfer import TransferFunctionGaussian
    from fvsrn_tpu_torch.utils.prng import prng_key

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    steps = max_steps_bound(box[1], STEPSIZE)
    net = load_weights(npz).to(dev)
    tf_d = tf.tensor.to(dev)
    phong = BRDFLambert.make(**NRM_BRDF)
    point = BRDFLambert.make(**NRM_POINT)

    def block_rays(size):
        from fvsrn_tpu_torch.camera import generate_rays
        rs, rd = generate_rays(cam, size, size, device=dev)
        perm, _ = block_ray_permutation(size, size, 16, 16, device=dev)
        return (rs.reshape(-1, 3)[perm].contiguous(),
                rd.reshape(-1, 3)[perm].contiguous())

    rs, rd = block_rays(WIDTH)
    n_tiles = rs.shape[0] // 256
    tiles = torch.arange(0, n_tiles, n_tiles // ORACLE_TILES,
                         device=dev)[:ORACLE_TILES]
    sel = (tiles[:, None] * 256 + torch.arange(256, device=dev)).reshape(-1)
    rs_s, rd_s = rs[sel].contiguous(), rd[sel].contiguous()
    fwd = sample_flops(net)
    grad = position_grad_flops(net)
    rows = {}

    def mega(rs_, rd_, net_=net, march=fused_mega.mega_trace_dvr, **kw):
        return march(rs_, rd_, net_, *box, tf_d, stepsize=STEPSIZE, **kw)

    def seg(rs_, rd_, net_=net, march=fused_trace_dvr, **kw):
        return march(rs_, rd_, net_, *box, tf_d, stepsize=STEPSIZE,
                     max_steps=steps, **kw)

    # P1, P2. rows 1 and 4 on the flagship at 512^2: launches, image,
    # kernel vs plain and vs the f32 oracle on 64 whole tiles, timings
    vol = VolumeInterpolationNetwork(net, *box)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False,
                                         need_normals=True)
    for row, march, plain, nkey, ukey in (
            ("mega_fwd", mega, fused_mega.mega_trace_dvr_plain,
             "mega_fwd_nrm", "mega_fwd"),
            ("segment_fwd", seg, fused_trace_dvr_plain, "segment_fwd_nrm",
             "segment_fwd")):
        stats = ({"return_samples": True} if row == "mega_fwd"
                 else {"return_stats": True})
        reset_counts()
        out, st = march(rs, rd, need_normals=True, brdf=phong, **stats)
        torch.cuda.synchronize()
        c = counts()
        samples = int(st.sum() if row == "mega_fwd" else st.samples)
        check(c[nkey] >= 1 and c[ukey] == 0,
              f"phase P {row}: launches {c}")
        check(bool(torch.isfinite(out.color).all()
                   and torch.isfinite(out.normal).all()
                   and torch.isfinite(out.depth).all())
              and float(out.color[:, 3].max()) > 0.5
              and float(out.normal.abs().max()) > 0.5,
              f"phase P {row}: the shaded frame")
        fig = {"launches": c[nkey], "samples": samples}
        for name, b in (("phong", phong), ("point", point)):
            got = march(rs_s, rd_s, need_normals=True, brdf=b)
            want = march(rs_s, rd_s, march=plain, need_normals=True,
                         brdf=b)
            off, worst = nrm_off(got, want)
            check(off <= NRM_FLIP_SHARE, f"phase P {row} {name}: kernel "
                  f"vs plain, {off} of the rays off")
            fig[f"{name}_vs_plain_off"] = off
            fig[f"{name}_vs_plain_worst"] = worst
            fig[f"{name}_max_abs_err"] = max_err(got.color, want.color)
        kw32 = dict(table_dtype=torch.float32, enable_early_out=False)
        got32 = march(rs_s, rd_s, need_normals=True, brdf=phong, **kw32)
        with torch.no_grad():
            oracle = trace_dvr(rs_s, rd_s, vol, tf.to(dev), ocfg, steps,
                               brdf=phong, lattice=row == "mega_fwd")
        fig["oracle_off"], fig["oracle_worst"] = nrm_off(got32, oracle)
        check(fig["oracle_off"] <= NRM_FLIP_SHARE, f"phase P {row}: f32 "
              f"kernel vs oracle, {fig['oracle_off']} of the rays off")
        fig["oracle_max_abs_err"] = max_err(got32.color, oracle.color)
        # the shaded and unshaded frames of this call, in turns
        times = {"unshaded": [], "phong": [], "point": []}
        for rep in range(2):
            for name in (("unshaded", "phong", "point") if rep == 0
                         else ("point", "phong", "unshaded")):
                kw = ({} if name == "unshaded" else
                      dict(need_normals=True,
                           brdf=phong if name == "phong" else point))
                times[name].append(cuda_ms(lambda: march(rs, rd, **kw),
                                           3 if name == "unshaded" else 1))
        fig.update({f"{k}_ms": min(v) for k, v in times.items()})
        fig["ms"] = fig["phong_ms"]
        fig["ns_per_sample"] = fig["ms"] * 1e6 / samples
        fig["plain_ms"] = cuda_ms(lambda: march(
            rs_s, rd_s, march=plain, need_normals=True, brdf=phong), 1)
        fig["plain_rays"] = rs_s.shape[0]
        fig["bound_ms"] = samples * (fwd + grad) / PEAK_BF16_TC * 1e3
        fig["bound_f32_ms"] = samples * (fwd + grad) / PEAK_F32 * 1e3
        fig["bound_by"] = "operations"
        fig["library_ms"] = None
        rows[row] = fig
        print(f"phase P {row} normals [{smi}]: flagship {WIDTH}x{HEIGHT} "
              f"h=1/{round(1 / STEPSIZE)}, {samples} samples, launches "
              f"{c}; shaded (Phong) {fig['phong_ms']:.3f} ms, point light "
              f"+ magnitude {fig['point_ms']:.3f} ms, unshaded "
              f"{fig['unshaded_ms']:.3f} ms (this call), "
              f"{fig['ns_per_sample']:.4f} ns/sample; bound "
              f"{fig['bound_ms']:.4f} ms (bf16 tensor cores) / "
              f"{fig['bound_f32_ms']:.4f} ms (f32); plain "
              f"{fig['plain_ms']:.1f} ms on {rs_s.shape[0]} rays; kernel vs "
              f"plain off {fig['phong_vs_plain_off']:.5f} / "
              f"{fig['point_vs_plain_off']:.5f} of the rays (worst "
              f"{fig['phong_vs_plain_worst']:.3g} / "
              f"{fig['point_vs_plain_worst']:.3g} of the tolerance), f32 "
              f"kernel vs oracle off {fig['oracle_off']:.5f} (colour "
              f"max|d| {fig['oracle_max_abs_err']:.3e})", flush=True)

    # P3. the networks at NRM_SIZE^2, both tables, rows 1 and 4
    relu = relu_direction_net(dev)
    nets = {"64:64:64 16x32^3 (phase O)": net64,
            "48:48:48 ReLU, direction": relu}
    rs3, rd3 = block_rays(NRM_SIZE)
    cases = {}
    for name, n_ in nets.items():
        for tdt in (torch.float32, torch.bfloat16):
            for row, march, plain in (
                    ("mega_fwd", mega, fused_mega.mega_trace_dvr_plain),
                    ("segment_fwd", seg, fused_trace_dvr_plain)):
                kw = dict(need_normals=True, brdf=phong, table_dtype=tdt)
                got = march(rs3, rd3, n_, **kw)
                want = march(rs3, rd3, n_, march=plain, **kw)
                off, worst = nrm_off(got, want)
                key = f"{row} {name} {str(tdt)[6:]}"
                cases[key] = {"off": off, "worst": worst,
                              "max_abs_err": max_err(got.color, want.color)}
                check(off <= NRM_FLIP_SHARE and float(
                    want.normal.abs().max()) > 0.1, f"phase P3 {key}: "
                    f"kernel vs plain, {off} of the rays off")
                print(f"phase P3 {key}: kernel vs plain off {off:.5f} of "
                      f"the rays (worst {worst:.3g} of the tolerance)",
                      flush=True)
    for row in ("mega_fwd", "segment_fwd"):
        rows[row]["networks"] = {k[len(row) + 1:]: v for k, v in
                                 cases.items() if k.startswith(row)}

    # P4. the MC walk with a gradient-scaled Gaussian at MC_NRM_SIZE^2
    from fvsrn_tpu_torch.camera import generate_rays
    rs4, rd4 = generate_rays(cam, MC_NRM_SIZE, MC_NRM_SIZE, device=dev)
    rs4, rd4 = rs4.reshape(-1, 3).contiguous(), rd4.reshape(-1, 3).contiguous()
    gtf = TransferFunctionGaussian(torch.tensor(MC_NRM_TF, device=dev),
                                   scale_with_gradient=True)
    mcfg = RayEvaluationMonteCarlo.make(max_absorption=14.0, num_bounces=2,
                                        max_iterations=256)
    hg = PhaseFunctionHenyeyGreenstein.make(g=0.3)

    def frame(use_fused=True):
        return trace_mc(prng_key(11), rs4, rd4, vol, gtf, hg, mcfg,
                        use_fused=use_fused)

    reset_counts()
    out_f, fused_ms = cuda_once(frame)
    c = counts()
    check(c["sample_eval_grad"] == c["normal_rounds"] > 0
          and c["sample_eval"] == c["tracking_rounds"],
          f"phase P4: launches {c}")
    out_p, plain_ms = cuda_once(lambda: frame(False))
    a = torch.cat([out_f.color, out_f.normal, out_f.depth], 1)
    b = torch.cat([out_p.color, out_p.normal, out_p.depth], 1)
    share = float(((a - b).abs() < MC_TOL).all(dim=1).float().mean())
    alpha = float(out_f.color[:, 3].mean())
    check(share >= MC_MATCH_SHARE and 0.05 < alpha < 0.95,
          f"phase P4: {share} of the rays within {MC_TOL}, alpha {alpha}")
    _, warm_ms = cuda_once(frame)
    rows["sample_eval"] = {
        "frame_ms": warm_ms, "first_frame_ms": fused_ms,
        "plain_frame_ms": plain_ms, "rays_within_tol": share,
        "alpha_mean": alpha, "grad_launches": c["sample_eval_grad"],
        "value_launches": c["sample_eval"] - c["sample_eval_grad"],
        "normal_rounds": c["normal_rounds"],
        "tracking_rounds": c["tracking_rounds"]}
    print(f"phase P4 trace_mc, gradient-scaled Gaussian [{smi}]: flagship "
          f"{MC_NRM_SIZE}x{MC_NRM_SIZE}, HG g=0.3, 2 bounces; launches {c} "
          f"(gradient instance once a camera-walk round); rays within "
          f"{MC_TOL} of the plain walk {share:.5f} (limit "
          f"{MC_MATCH_SHARE}), alpha mean {alpha:.4f}; fused frame "
          f"{warm_ms:.1f} ms (first {fused_ms:.1f}), plain frame "
          f"{plain_ms:.1f} ms", flush=True)

    # P5. the gradient-network evaluation at its defaults, on the card
    reset_counts()
    res = ev.evaluate(ev.parse_args([]))
    c = counts()
    check(c["mega_fwd_nrm"] >= 1 and res["ssim"] > 0.9,
          f"phase P5: launches {c}, SSIM {res['ssim']}")
    rows["mega_fwd"]["eval_gradient_networks"] = dict(res, launches=c)
    print(f"phase P5 eval_gradient_networks [{smi}]: trained in "
          f"{res['train_s']:.1f} s, rows {res['rows']}, shaded render "
          f"{res['ms']:.1f} ms at 128^2, SSIM {res['ssim']:.4f}, launches "
          f"{c}", flush=True)

    ptxas = {n_: {k: list(v) for k, v in _build.ptxas_instances(
        _build.ptxas_report(n_)).items()}
        for n_ in ("mega_fwd_nrm", "mega_fwd_nrm48", "mega_fwd_nrm64",
                   "segment_fwd_nrm")}
    for n_, v in ptxas.items():
        print(f"phase P ptxas {n_}: " + "; ".join(
            f"{k} {r}" for k, r in v.items()), flush=True)
    rows["mega_fwd"]["ptxas"] = {k: v for k, v in ptxas.items()
                                 if k.startswith("mega")}
    rows["segment_fwd"]["ptxas"] = ptxas["segment_fwd_nrm"]
    print(f"phase P: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def relu_direction_net(dev):
    """Phase P3's second network: 48:48:48 ReLU with direction input, a
    sigmoid density head and a 16x32^3 grid, seeded."""
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    g = np.random.default_rng(7).standard_normal((16, 32, 32, 32)) * 0.3
    return SceneRepresentationNetwork.make(
        layers="48:48:48", activation="ReLU", output_mode="density",
        num_fourier=14, use_direction=True,
        disable_direction_in_fourier=False,
        latent=LatentSpace(static_grid=torch.tensor(g, dtype=torch.float32)),
        seed=7).to(dev)


# phase Q: BASELINE config 5, a time- and ensemble-keyframed network at the
# flagship's widths: time grid 8 keyframes x 8 channels, ensemble grid 4 x
# 8, both 32^3 (resolved: the flagship's 16 x 32^3 table); world-trained to
# MARSCHNER_LOBB at (t, e) = (0, 0) and SPHERE at (7, 3)
Q_TIME, Q_ENS, Q_CHANNELS, Q_RES = 8, 4, 8, 32
Q_FIELDS = (("MARSCHNER_LOBB", 0.0, 0.0), ("SPHERE", 7.0, 3.0))
Q_STEPS = 200                        # world steps a keyframe pair
Q_BATCH = 8192
Q_SAMPLES = 65536
Q_FRAMES = ((0.0, 0.0), (3.5, 1.5), (7.0, 3.0))
Q_ANIMATION = 8                      # frames, t = 0 .. 7
Q_DIFF = (3.5, 1.5)                  # rows 5-6's (t, e)
Q_ORACLE = (3.5, 1.5)                # Q2's f32 oracle (~6 s a call) here only
Q_SCREEN = 128                       # rows 2-3 vs plain: 64 whole tiles
Q_MC_SIZE = 256


def keyframed_net(dev, seed=15):
    """Config 5's network, seeded: 32:32:32 SnakeAlt:2, 14 Fourier
    features, ``density:direct``, time and ensemble keyframed grids."""
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    rng = np.random.default_rng(seed)
    shape = (Q_CHANNELS, Q_RES, Q_RES, Q_RES)
    lat = LatentSpace(
        time_grid=torch.tensor(rng.standard_normal((Q_TIME,) + shape) * 0.1,
                               dtype=torch.float32),
        ensemble_grid=torch.tensor(rng.standard_normal((Q_ENS,) + shape)
                                   * 0.1, dtype=torch.float32),
        time_dependent=True)
    return SceneRepresentationNetwork.make(
        layers="32:32:32", activation="SnakeAlt:2", num_fourier=14,
        output_mode="density:direct", latent=lat, seed=seed).to(dev)


def vector_net(npz, dev, seed=16):
    """The flagship with a time vector (8 channels, 4 keyframes) and an
    ensemble vector (4 channels, 3 keyframes) added before its grid's
    channels, their layer-0 columns seeded small: the flagship's image,
    moved by the vectors."""
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.train.checkpoints import load_weights
    net = load_weights(npz)
    rng = np.random.default_rng(seed)
    tv = torch.tensor(rng.standard_normal((1, 8, 4)), dtype=torch.float32)
    ev = torch.tensor(rng.standard_normal((1, 4, 3)), dtype=torch.float32)
    w = net.layers[0].weight.detach()
    start = net.input.num_input_channels() + 2 * net.input.num_fourier
    cols = torch.tensor(rng.standard_normal((w.shape[0], 12)) * 0.05,
                        dtype=torch.float32)
    with torch.no_grad():
        net.layers[0].weight = torch.nn.Parameter(
            torch.cat([w[:, :start], cols, w[:, start:]], dim=1))
    net.latent = LatentSpace(static_grid=net.latent.static_grid.detach(),
                             time_vector=tv, ensemble_vector=ev)
    return net.to(dev)


def keyframes(smi, reset_counts, counts, npz, tf, cam, frame_ms):
    """Phase Q, BASELINE config 5 on the card: a time- and
    ensemble-keyframed network world-trained (Q1: the keyframed step and
    the latent-only step after ``generalize_to_new_ensembles``, first step
    card vs CPU, timed), rendered FUSED at 512^2, 1/512 at three (t, e)
    on rows 1 and 4 (Q2: kernel vs plain, vs the f32 oracle of the
    network volume at Q_ORACLE, an 8-frame animation with the resolve and
    the march timed apart), one differentiable step on each engine (Q3:
    rows 5-6 at t = 3.5 on 64 whole tiles, rows 2-3 through
    ``evaluate_screen(engine="mega")`` on a network with latent vectors;
    kernel vs plain, out-of-bracket keyframes exactly 0), ``trace_mc``
    through row 7 at t = 3.5 (Q4) and a ``.volnet`` round trip rendered
    FUSED (Q5). Returns {row name: figures}."""
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.latent import resolve_grid
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import fused_eval, fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_trace_dvr,
                                               fused_trace_dvr_plain,
                                               resolve_network)
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.raytracer.montecarlo import (RayEvaluationMonteCarlo,
                                                      trace_mc)
    from fvsrn_tpu_torch.train import generalization, world
    from fvsrn_tpu_torch.train.losses import LossNetScreen, LossNetWorld
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.train.screen import (evaluate_screen,
                                              fused_screen_supported)
    from fvsrn_tpu_torch.utils.prng import prng_key
    from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

    t_phase = time.perf_counter()
    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    steps = max_steps_bound(box[1], STEPSIZE)
    tf_d = tf.tensor.to(dev)
    rows = {}

    # Q1. world training: one (positions, targets) set a field, on the card
    net = keyframed_net(dev)
    gen = torch.Generator(dev).manual_seed(5)
    sets = []
    for field, t_, e_ in Q_FIELDS:
        pos = torch.rand(Q_SAMPLES, 3, device=dev, generator=gen)
        sets.append(world.build_world_dataset(
            VolumeInterpolationImplicit.make(field, device=dev), Q_SAMPLES,
            positions=pos, time=t_, ensemble=e_, device=dev))
    loss = LossNetWorld(mode="density", l1=1.0)

    def first_step(name, n_dev, trainable=None):
        """Loss and every gradient leaf of one step from ``n_dev``'s
        weights on the first batch of each field, card vs CPU (1e-5
        relative, phase L's gate)."""
        worst = 0.0
        for ds in sets:
            out = []
            for d in (dev, cpu):
                n_ = copy.deepcopy(n_dev).to(d)
                b = world.WorldDataset(*(a[:Q_BATCH].to(d) for a in ds))
                total, _ = world.evaluate_world(n_, b, loss)
                total.backward()
                if trainable is not None:
                    trainable(n_)
                out.append((float(total.detach()), {
                    k: p.grad.detach().cpu()
                    for k, p in n_.named_parameters()}))
            (l_d, g_d), (l_c, g_c) = out
            rel = {k: (rel_err(g_d[k], g_c[k]) if float(g_c[k].norm()) > 0
                       else float(g_d[k].norm())) for k in g_c}
            worst = max(worst, abs(l_d - l_c) / abs(l_c), *rel.values())
            check(abs(l_d - l_c) <= 1e-5 * abs(l_c)
                  and max(rel.values()) <= 1e-5,
                  f"phase Q1 {name}: first step card vs CPU, loss {l_d} vs "
                  f"{l_c}, leaves {rel}")
        return worst

    def train(n_, trainable=None, n_steps=Q_STEPS):
        opt = make_optimizer(n_.parameters(), "Adam", lr=1e-2)
        step = world.make_train_step(loss, opt, trainable=trainable)
        hist = []
        for i in range(n_steps):
            sl = slice((i * Q_BATCH) % Q_SAMPLES,
                       (i * Q_BATCH) % Q_SAMPLES + Q_BATCH)
            for ds in sets:
                hist.append(step(n_, world.WorldDataset(
                    *(a[sl] for a in ds)))[0])
        torch.cuda.synchronize()
        hist = [float(v) for v in hist]
        batch = world.WorldDataset(*(a[:Q_BATCH] for a in sets[0]))
        return hist, cuda_ms(lambda: step(n_, batch), 10)

    key_worst = first_step("keyframed step", net)
    t0 = time.perf_counter()
    hist, key_ms = train(net)
    train_s = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in hist)
          and hist[-2] < 0.5 * hist[0] and hist[-1] < 0.5 * hist[1],
          f"phase Q1: losses {hist[:2]} -> {hist[-2:]}")
    gnet = generalization.generalize_to_new_ensembles(net, Q_ENS, seed=0)
    mlp = [l.weight.detach().clone() for l in gnet.layers]
    ens0 = gnet.latent.ensemble_grid.detach().clone()
    mask_worst = first_step("latent-only step", gnet,
                            generalization.latent_only_mask)
    ghist, mask_ms = train(gnet, generalization.latent_only_mask, 20)
    check(all(torch.equal(a, l.weight.detach())
              for a, l in zip(mlp, gnet.layers))
          and not torch.equal(ens0, gnet.latent.ensemble_grid.detach()),
          "phase Q1: the latent-only step moved the MLP or not the grid")
    q1 = {"steps": len(hist), "train_s": train_s, "loss_first": hist[:2],
          "loss_last": hist[-2:], "step_ms": key_ms,
          "first_step_worst_rel": key_worst,
          "latent_only_step_ms": mask_ms,
          "latent_only_first_step_worst_rel": mask_worst,
          "latent_only_loss": [ghist[0], ghist[-1]]}
    print(f"phase Q1 world training [{smi}]: config 5 (time {Q_TIME}x"
          f"{Q_CHANNELS}, ensemble {Q_ENS}x{Q_CHANNELS}, {Q_RES}^3), "
          f"{len(hist)} steps of {Q_BATCH} in {train_s:.1f} s, losses "
          f"{hist[0]:.4f}/{hist[1]:.4f} -> {hist[-2]:.4f}/{hist[-1]:.4f}; "
          f"step {key_ms:.3f} ms, latent-only step {mask_ms:.3f} ms; first "
          f"step card vs CPU worst rel {key_worst:.2e} / "
          f"{mask_worst:.2e}", flush=True)

    # Q2. the FUSED render at three (t, e): rows 1 and 4
    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    brs, brd = rs[perm].contiguous(), rd[perm].contiguous()
    n_tiles = brs.shape[0] // 256
    tiles = torch.arange(0, n_tiles, n_tiles // ORACLE_TILES,
                         device=dev)[:ORACLE_TILES]
    sel = (tiles[:, None] * 256 + torch.arange(256, device=dev)).reshape(-1)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)

    def mega(n_, t_, e_, march=fused_mega.mega_trace_dvr, rays=(brs, brd),
             **kw):
        return march(*rays, n_, *box, tf_d, stepsize=STEPSIZE, time=t_,
                     ensemble=e_, **kw)

    def seg(n_, t_, e_, march=fused_trace_dvr, rays=(rs, rd), **kw):
        return march(*rays, n_, *box, tf_d, stepsize=STEPSIZE,
                     max_steps=steps, tile=128, time=t_, ensemble=e_, **kw)

    with torch.no_grad():
        grid = resolve_grid(net.latent)
    check(grid is not None and tuple(grid.shape) == (2 * Q_CHANNELS, Q_RES,
                                                     Q_RES, Q_RES)
          and not fused_screen_supported(net, tf, WIDTH, HEIGHT),
          "phase Q2: the resolved grid or the screen gate")
    q2 = {"mega_fwd": {}, "segment_fwd": {}}
    for t_, e_ in Q_FRAMES:
        for row, march, plain, key in (
                ("mega_fwd", mega, fused_mega.mega_trace_dvr_plain,
                 "mega_fwd"),
                ("segment_fwd", seg, fused_trace_dvr_plain, "segment_fwd")):
            reset_counts()
            got, st = march(net, t_, e_, **(
                {"return_samples": True} if row == "mega_fwd"
                else {"return_stats": True}))
            torch.cuda.synchronize()
            c = counts()
            samples = int(st.sum() if row == "mega_fwd" else st.samples)
            check(c[key] >= 1 and sum(v for k, v in c.items()
                                      if k != key) == 0,
                  f"phase Q2 {row} ({t_}, {e_}): launches {c}")
            want = march(net, t_, e_, march=plain)
            err = max_err(got, want)
            check(bool(torch.isfinite(got).all())
                  and float(got[:, 3].max()) > 0.5 and err <= KERNEL_TOL,
                  f"phase Q2 {row} ({t_}, {e_}): alpha max "
                  f"{float(got[:, 3].max())}, kernel vs plain {err}")
            oerr = None
            if (t_, e_) == Q_ORACLE:
                vol = VolumeInterpolationNetwork(net, *box, time=t_,
                                                 ensemble=e_)
                o_rays = ((brs[sel], brd[sel]) if row == "mega_fwd"
                          else (rs[sel], rd[sel]))
                with torch.no_grad():
                    oracle = trace_dvr(*o_rays, vol, tf.to(dev), ocfg, steps,
                                       lattice=row == "mega_fwd").color
                oerr = max_err(march(net, t_, e_, rays=o_rays), oracle)
                check(oerr < ORACLE_TOL, f"phase Q2 {row} ({t_}, {e_}): vs "
                      f"the f32 oracle {oerr}")
            ms = cuda_ms(lambda: march(net, t_, e_), 3)
            q2[row][f"{t_},{e_}"] = {
                "launches": c[key], "max_abs_err": err,
                "oracle_max_abs_err": oerr, "ms": ms, "samples": samples,
                "ns_per_sample": ms * 1e6 / samples}
            print(f"phase Q2 {row} (t, e) = ({t_}, {e_}) [{smi}]: "
                  f"{WIDTH}x{HEIGHT} h=1/{round(1 / STEPSIZE)}, launches "
                  f"{c[key]}, kernel vs plain {err:.3e}, vs f32 oracle "
                  f"{oerr}, {ms:.3f} ms, {samples} samples "
                  f"({ms * 1e6 / samples:.4f} ns each)", flush=True)
    # the animation: t = 0 .. 7, e = 3t/7; the resolve plus the table
    # build timed apart from the whole call (resolve + table + march)
    anim = []
    for i in range(Q_ANIMATION):
        t_ = float(i)
        e_ = 3.0 * i / (Q_ANIMATION - 1)

        def resolve():
            with torch.no_grad():
                view = resolve_network(net, t_, e_)
                return fused_mega._kernel_table(view.latent.static_grid,
                                                torch.bfloat16, dev)

        res_ms = cuda_ms(resolve, 3)
        with torch.no_grad():
            call_ms = cuda_ms(lambda: mega(net, t_, e_), 3)
        anim.append({"t": t_, "e": e_, "resolve_table_ms": res_ms,
                     "call_ms": call_ms, "march_ms": call_ms - res_ms})
    print(f"phase Q2 animation [{smi}]: {Q_ANIMATION} frames, per frame "
          f"resolve+table / whole call (ms): " + ", ".join(
              f"t={a['t']:.0f} {a['resolve_table_ms']:.3f}/"
              f"{a['call_ms']:.3f}" for a in anim)
          + f"; phase 6's static flagship kernel {frame_ms:.3f} ms",
          flush=True)

    # Q3. one differentiable step on each engine
    def leaf_grads(n_):
        return {k: p.grad.detach().clone() for k, p in n_.named_parameters()
                if p.grad is not None}

    t_, e_ = Q_DIFF
    d_rs, d_rd = rs[sel], rd[sel]
    diff = {}
    for fn in (fused_trace_dvr, fused_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        reset_counts()

        def step_fn():
            img = seg(net, t_, e_, march=fn, rays=(d_rs, d_rd),
                      differentiable=True)
            (img ** 2).mean().backward()
            return img.detach()

        img, ms = cuda_once(step_fn)
        diff[fn] = (img, leaf_grads(net), counts(), ms)
    (img_k, g_k, c_k, _), (img_p, g_p, c_p, plain_ms) = diff.values()
    check(c_k["segment_fwd_diff"] == 1 and c_k["segment_bwd"] == 1
          and c_p["segment_fwd_diff"] == 0, f"phase Q3 rows 5-6: {c_k}")
    img_err = max_err(img_k, img_p)
    rel = {k: rel_err(g_k[k], g_p[k]) for k in g_p
           if float(g_p[k].norm()) > 0}
    lo_t, lo_e = int(t_), int(e_)
    outside = float(max(
        g_k["latent.time_grid"][[k for k in range(Q_TIME)
                                 if k not in (lo_t, lo_t + 1)]].abs().max(),
        g_k["latent.ensemble_grid"][[k for k in range(Q_ENS)
                                     if k not in (lo_e, lo_e + 1)]]
        .abs().max()))
    check(img_err <= KERNEL_TOL and max(rel.values()) <= GRAD_TOL
          and "latent.time_grid" in rel and "latent.ensemble_grid" in rel
          and outside == 0.0, f"phase Q3 rows 5-6: image {img_err}, leaves "
          f"{rel}, outside the bracket {outside}")
    net.zero_grad(set_to_none=True)
    step_ms = cuda_ms(lambda: (seg(net, t_, e_, rays=(d_rs, d_rd),
                                   differentiable=True) ** 2).mean()
                      .backward(), 3)
    q3_seg = {"launches": c_k, "max_abs_err": img_err,
              "grad_rel_max": max(rel.values()), "outside_bracket": outside,
              "step_ms": step_ms, "plain_step_ms": plain_ms,
              "rays": d_rs.shape[0]}
    print(f"phase Q3 rows 5-6 [{smi}]: fused_trace_dvr(differentiable, "
          f"t={t_}, e={e_}) on {d_rs.shape[0]} rays, image vs plain "
          f"{img_err:.3e}, leaves rel max {max(rel.values()):.3e} (time "
          f"grid {rel['latent.time_grid']:.2e}, ensemble grid "
          f"{rel['latent.ensemble_grid']:.2e}), outside the bracket "
          f"{outside}; step {step_ms:.3f} ms (plain {plain_ms:.1f} ms)",
          flush=True)

    vnet = vector_net(npz, dev)
    check(fused_screen_supported(vnet, tf, WIDTH, HEIGHT),
          "phase Q3: a network with latent vectors should train fused")
    sperm, sinv = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    fk = dict(engine="mega", block_perm=sperm, block_perm_inv=sinv, seg=32,
              tile=256)
    scfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    target = torch.zeros(1, WIDTH * HEIGHT, 4, device=dev)

    def screen_step():
        vnet.zero_grad(set_to_none=True)
        total, _ = evaluate_screen(vnet, rs[None], rd[None], target,
                                   tf.to(dev), scfg, LossNetScreen(l1=1.0),
                                   steps, WIDTH, HEIGHT, use_fused=True,
                                   fused_kwargs=fk)
        total.backward()
        return total

    reset_counts()
    total = screen_step()
    torch.cuda.synchronize()
    c_s = counts()
    check(c_s["mega_fwd_diff"] == 1 and c_s["mega_bwd"] == 1
          and math.isfinite(float(total.detach()))
          and float(vnet.latent.time_vector.grad.norm()) > 0,
          f"phase Q3 rows 2-3: launches {c_s}, loss {float(total.detach())}")
    screen_ms = cuda_ms(screen_step, 3)
    q_rs, q_rd = generate_rays(cam, Q_SCREEN, Q_SCREEN, device=dev)
    qperm, _ = block_ray_permutation(Q_SCREEN, Q_SCREEN, 16, 16, device=dev)
    q_rs = q_rs.reshape(-1, 3)[qperm].contiguous()
    q_rd = q_rd.reshape(-1, 3)[qperm].contiguous()
    mdiff = {}
    for fn in (fused_mega.mega_trace_dvr, fused_mega.mega_trace_dvr_plain):
        vnet.zero_grad(set_to_none=True)
        img = fn(q_rs, q_rd, vnet, *box, tf_d, stepsize=STEPSIZE,
                 differentiable=True)
        (img ** 2).mean().backward()
        mdiff[fn] = (img.detach(), leaf_grads(vnet))
    (mi_k, mg_k), (mi_p, mg_p) = mdiff.values()
    m_err = max_err(mi_k, mi_p)
    m_rel = {k: rel_err(mg_k[k], mg_p[k]) for k in mg_p
             if float(mg_p[k].norm()) > 0}
    check(m_err <= KERNEL_TOL and max(m_rel.values()) <= GRAD_TOL
          and "latent.time_vector" in m_rel
          and "latent.ensemble_vector" in m_rel,
          f"phase Q3 rows 2-3: image {m_err}, leaves {m_rel}")
    q3_mega = {"launches": c_s, "max_abs_err": m_err,
               "grad_rel_max": max(m_rel.values()), "step_ms": screen_ms}
    print(f"phase Q3 rows 2-3 [{smi}]: evaluate_screen(engine=mega) on the "
          f"flagship with time/ensemble vectors at {WIDTH}x{HEIGHT}, step "
          f"{screen_ms:.3f} ms, launches {c_s}; at {Q_SCREEN}^2 image vs "
          f"plain {m_err:.3e}, leaves rel max {max(m_rel.values()):.3e} "
          f"(time vector {m_rel['latent.time_vector']:.2e}, ensemble vector "
          f"{m_rel['latent.ensemble_vector']:.2e})", flush=True)

    # Q4. MC through row 7 at t = 3.5
    m_rs, m_rd = generate_rays(cam, Q_MC_SIZE, Q_MC_SIZE, device=dev)
    m_rs, m_rd = m_rs.reshape(-1, 3).contiguous(), m_rd.reshape(-1, 3)
    mvol = VolumeInterpolationNetwork(net, *box, time=Q_DIFF[0],
                                      ensemble=Q_DIFF[1])
    mcfg = RayEvaluationMonteCarlo.make(max_absorption=30.0, num_bounces=2,
                                        max_iterations=256)
    hg = PhaseFunctionHenyeyGreenstein.make(g=0.3)

    def mc_frame(use_fused=True):
        return trace_mc(prng_key(11), m_rs, m_rd, mvol, tf.to(dev), hg, mcfg,
                        use_fused=use_fused).color

    reset_counts()
    out_f, mc_first = cuda_once(mc_frame)
    c_m = counts()
    check(c_m["sample_eval"] == c_m["tracking_rounds"] > 0,
          f"phase Q4: launches {c_m}")
    out_p, mc_plain = cuda_once(lambda: mc_frame(False))
    share = float(((out_f - out_p).abs() < MC_TOL).all(dim=1).float().mean())
    alpha = float(out_f[:, 3].mean())
    check(share >= MC_MATCH_SHARE and 0.02 < alpha,
          f"phase Q4: {share} of the rays within {MC_TOL}, alpha {alpha}")
    _, mc_ms = cuda_once(mc_frame)
    # row 7 alone at the frame's launch size, kernel vs plain at (t, e)
    ev = fused_eval.make_fused_eval(net, *box, time=Q_DIFF[0],
                                    ensemble=Q_DIFF[1])
    e_pos = torch.rand(Q_MC_SIZE ** 2, 3, device=dev, generator=gen) - 0.5
    ev_err = max_err(ev(e_pos)[0], fused_eval.fused_eval_plain(
        net, e_pos + 0.5, time=Q_DIFF[0], ensemble=Q_DIFF[1])[0])
    check(ev_err <= KERNEL_TOL, f"phase Q4: row 7 vs plain {ev_err}")
    ev_ms = cuda_ms(lambda: ev(e_pos), 10)
    q4 = {"launches": c_m["sample_eval"], "frame_ms": mc_ms,
          "first_frame_ms": mc_first, "plain_frame_ms": mc_plain,
          "rays_within_tol": share, "max_abs_err": ev_err, "ms": ev_ms}
    print(f"phase Q4 trace_mc [{smi}]: config 5 at t={Q_DIFF[0]}, "
          f"e={Q_DIFF[1]}, {Q_MC_SIZE}x{Q_MC_SIZE}, 2 bounces; launches "
          f"{c_m}; rays within {MC_TOL} of the plain walk {share:.5f}, alpha "
          f"mean {alpha:.4f}; frame {mc_ms:.1f} ms (first {mc_first:.1f}), "
          f"plain {mc_plain:.1f} ms; row 7 alone on {e_pos.shape[0]} "
          f"positions {ev_ms:.4f} ms, vs plain {ev_err:.3e}", flush=True)

    # Q5. the .volnet round trip, rendered FUSED through row 1
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "chip_smoke", "config5.volnet")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cfg5 = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    LoadedModel(copy.deepcopy(net).cpu(), tf, config=cfg5).save_volnet(path)
    loaded = LoadedModel.from_volnet(path, tf=tf, config=cfg5)
    render = loaded.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED",
                                           device=DEVICE)
    reset_counts()
    img = render()
    torch.cuda.synchronize()
    c_v = counts()
    got = render.march()
    want = render.march(fused_mega.mega_trace_dvr_plain)
    v_err = max_err(got, want)
    check(render.route == "mega" and c_v["mega_fwd"] == 1
          and float(img[..., 3].max()) > 0.5 and v_err <= KERNEL_TOL,
          f"phase Q5: route {render.route}, launches {c_v}, kernel vs "
          f"plain {v_err}")
    q5 = {"launches": c_v["mega_fwd"], "max_abs_err": v_err,
          "bytes": os.path.getsize(path)}
    print(f"phase Q5 .volnet [{smi}]: {q5['bytes']} bytes, from_volnet FUSED "
          f"{WIDTH}x{HEIGHT} route {render.route}, launches {c_v}, kernel "
          f"vs plain {v_err:.3e}", flush=True)

    mid = f"{Q_FRAMES[1][0]},{Q_FRAMES[1][1]}"
    rows["mega_fwd"] = dict(q2["mega_fwd"][mid], frames=q2["mega_fwd"],
                            animation=anim, volnet=q5, world=q1)
    rows["segment_fwd"] = dict(q2["segment_fwd"][mid],
                               frames=q2["segment_fwd"])
    for name, q, c in (("mega_fwd_diff", q3_mega, c_s),
                       ("mega_bwd", q3_mega, c_s),
                       ("segment_fwd_diff", q3_seg, c_k),
                       ("segment_bwd", q3_seg, c_k)):
        rows[name] = dict(q, launches=c[name], ms=q["step_ms"])
    rows["sample_eval"] = q4
    print(f"phase Q: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def bench_grid_check(got, want):
    """(ok, largest element error over its own value, over the leaf's
    largest) of a bf16 table's grid gradient, kernel against plain: each
    element within BF16_GRID_REL of its value plus GRAD_TOL of the leaf's
    largest (the float32 contract, for sums that cancel)."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    bound = BF16_GRID_REL * want.abs() + GRAD_TOL * scale
    rel_el = float((err / want.abs().clamp_min(1e-30))[
        want.abs() > GRAD_TOL * scale].max())
    return bool((err <= bound).all()), rel_el, float(err.max()) / scale


def bench_step(smi, reset_counts, counts, cam):
    """Phase R: bench.py's contracted configuration on the port: the
    dense and the sparse flagship at 512^2, 1/512, bench.py's camera and
    16x8 pixel blocks, the saturation clip (coarse 8, margin 16), a
    3-bucket plan of 128-ray tiles (seg 32), the sparse arm's per-bucket
    occupancy masks (128^3, fine 2, alpha_skip 1e-5), the march on 128-ray
    tiles with a bf16 table, forward frame and training step (mean(c^2),
    SGD 1e-7), each timed over bench.py's 6 frames after a warm-up, and
    the same process's tile-256 float32-table step beside it; bench.py's
    gates against the f32 lattice oracle, the kernels against their plain
    versions on the gate's 128 tiles; then rows 5-6 with a bf16 table.
    Returns rows 1-3 and 5-6's figures."""
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr, fused_dvr_bwd, fused_mega
    from fvsrn_tpu_torch.ops import occupancy
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_trace_dvr_bucketed,
                                               plan_ray_buckets,
                                               probe_saturation_tmax)
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.scenes import dense_scene, sparse_scene
    from fvsrn_tpu_torch.train.checkpoints import load_weights

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    steps_max = max_steps_bound(box[1], STEPSIZE)
    n_rays = WIDTH * HEIGHT
    bf16 = torch.bfloat16
    rs_all, rd_all = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 8, device=dev)
    rs = rs_all.reshape(-1, 3)[perm].contiguous()
    rd = rd_all.reshape(-1, 3)[perm].contiguous()
    rs_np, rd_np = rs.cpu().numpy(), rd.cpu().numpy()
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)

    def setup(scene, sparse):
        """The camera-static planning pre-pass, timed: clip, plan, masks."""
        _, tf, npz = scene()
        net = load_weights(npz).to(dev)
        tf_dev = tf.to(dev)
        vol = VolumeInterpolationNetwork(net, *box)
        t0 = time.perf_counter()
        with torch.no_grad():
            clip = probe_saturation_tmax(rs, rd, vol, tf_dev,
                                         stepsize=STEPSIZE,
                                         max_steps=steps_max, coarse=8,
                                         margin_steps=16)
        clip_np = clip.cpu().numpy().astype(np.float32)
        plan = plan_ray_buckets(rs_np, rd_np, *box, stepsize=STEPSIZE,
                                seg=BENCH_SEG, tile=BENCH_TILE, n_buckets=3,
                                grid_sizes=(32, 32, 32), tmax_clip=clip_np)
        occ, masks = None, None
        if sparse:
            occ = occupancy.build_occupancy(vol, tf_dev, resolution=128,
                                            fine=2, stepsize=STEPSIZE,
                                            alpha_skip=1e-5)
            masks = tuple(torch.from_numpy(m).to(dev)
                          for m in occupancy.plan_segment_occupancy(
                              plan, rs_np, rd_np, occ, *box,
                              stepsize=STEPSIZE, seg=BENCH_SEG,
                              tile=BENCH_TILE))
        torch.cuda.synchronize()
        return dict(net=net, tf=tf_dev, vol=vol, plan=plan, occ=occ,
                    masks=masks, plan_s=time.perf_counter() - t0)

    def trace(a, n, t, diff, rs_=None, rd_=None, plan=None, masks=None,
              march=None, table=bf16, stats=False):
        return fused_trace_dvr_bucketed(
            rs if rs_ is None else rs_, rd if rd_ is None else rd_, n, *box,
            t, plan=a["plan"] if plan is None else plan, engine="mega",
            march=march, stepsize=STEPSIZE, seg=BENCH_SEG, tile=BENCH_TILE,
            enable_early_out=True, differentiable=diff, table_dtype=table,
            segment_active_groups=(a["masks"] if masks is None else masks),
            return_stats=stats)

    arms = {"dense": setup(dense_scene, False),
            "sparse": setup(sparse_scene, True)}
    steps = {}
    for name, a in arms.items():
        a["step_net"] = copy.deepcopy(a["net"])
        a["step_tf"] = a["tf"].tensor.clone().requires_grad_(name == "dense")
        params = list(a["step_net"].parameters()) + (
            [a["step_tf"]] if name == "dense" else [])
        a["opt"] = torch.optim.SGD(params, lr=1e-7)

        def step(a=a, table=bf16):
            a["opt"].zero_grad(set_to_none=True)
            img = trace(a, a["step_net"], a["step_tf"], True, table=table)
            (img ** 2).mean().backward()
            a["opt"].step()
        steps[name] = step

    # the main path: each arm's forward frame and one training step, the
    # counts reset just before and read just after
    reset_counts()
    for name, a in arms.items():
        with torch.no_grad():
            a["img"], a["stats"] = trace(a, a["net"], a["tf"].tensor, False,
                                         stats=True)
        steps[name]()
    torch.cuda.synchronize()
    c_r = counts()
    inst = dict(fused_mega.LAUNCHES)
    for kind in ("mega_fwd", "mega_fwd_diff", "mega_bwd"):
        check(inst.get(f"{kind}:t128:bf16", 0) > 0,
              f"phase R: no {kind} launch on 128-ray tiles with a bf16 "
              f"table ({inst})")
    for name, a in arms.items():
        img = a["img"]
        check(tuple(img.shape) == (n_rays, 4)
              and bool(torch.isfinite(img).all())
              and float(img[:, 3].max()) > 0.5,
              f"phase R {name}: the frame")
    culled = {}
    for name, a in arms.items():
        if a["masks"] is not None:
            tot = sum(int(m.numel()) for m in a["masks"])
            culled[name] = 1.0 - sum(int(m.sum()) for m in a["masks"]) / tot
    print(f"phase R main path [{smi}]: bench.py's configuration, "
          f"{WIDTH}x{HEIGHT} h=1/{round(1 / STEPSIZE)}, 16x8 blocks, tile "
          f"{BENCH_TILE}, seg {BENCH_SEG}, bf16 table; planning dense "
          f"{arms['dense']['plan_s']:.2f} s, sparse "
          f"{arms['sparse']['plan_s']:.2f} s; buckets "
          f"{[int(n) for n in arms['dense']['plan'].group_sizes]} / "
          f"{[int(n) for n in arms['sparse']['plan'].group_sizes]}; sparse "
          f"culled share "
          f"{culled['sparse']:.4f}; launches {c_r}, by instance {inst}",
          flush=True)

    # the gates: bench.py's gate_check on GATE rays from the start of the
    # middle bucket, and the kernels against their plain versions there
    res = {}
    for name, a in arms.items():
        plan = a["plan"]
        gs = plan.dead + plan.group_sizes[0]
        gs = min(gs, n_rays - BENCH_GATE_RAYS)
        g_rs_np = rs_np[plan.perm][gs:gs + BENCH_GATE_RAYS]
        g_rd_np = rd_np[plan.perm][gs:gs + BENCH_GATE_RAYS]
        g_clip = plan.tmax_clip[gs:gs + BENCH_GATE_RAYS]
        gplan = plan_ray_buckets(g_rs_np, g_rd_np, *box, stepsize=STEPSIZE,
                                 seg=BENCH_SEG, tile=BENCH_TILE, n_buckets=1,
                                 grid_sizes=(32, 32, 32), tmax_clip=g_clip)
        g_masks = None
        if a["occ"] is not None:
            g_masks = tuple(torch.from_numpy(m).to(dev)
                            for m in occupancy.plan_segment_occupancy(
                                gplan, g_rs_np, g_rd_np, a["occ"], *box,
                                stepsize=STEPSIZE, seg=BENCH_SEG,
                                tile=BENCH_TILE))
        g_rs = torch.from_numpy(g_rs_np).to(dev)
        g_rd = torch.from_numpy(g_rd_np).to(dev)
        net_only = name == "sparse"
        net = a["net"]

        def grads(fn):
            net.zero_grad(set_to_none=True)
            tf_leaf = a["tf"].tensor.clone().requires_grad_(not net_only)
            img = fn(tf_leaf)
            (img ** 2).mean().backward()
            g = {n: p.grad.detach().clone() for n, p in
                 net.named_parameters()}
            if not net_only:
                g["tf"] = tf_leaf.grad.detach().clone()
            return img.detach(), g

        img_k, g_k = grads(lambda t: trace(a, net, t, True, g_rs, g_rd,
                                           gplan, g_masks))
        (img_p, g_p), gp_ms = cuda_once(lambda: grads(
            lambda t: trace(a, net, t, True, g_rs, g_rd, gplan, g_masks,
                            march=fused_mega.mega_trace_dvr_plain)))
        gsteps = int(max(gplan.group_steps))
        img_o, g_o = grads(lambda t: trace_dvr(
            g_rs, g_rd, a["vol"], type(a["tf"])(t), ocfg, gsteps,
            tmax_in=torch.from_numpy(g_clip).to(dev), lattice=True,
            checkpoint_chunk=64).color)
        ad = (img_k - img_o).abs()
        o_max, o_p99 = float(ad.max()), float(torch.quantile(ad.flatten(),
                                                                0.99))
        o_rel = {n: rel_err(g_k[n], g_o[n]) for n in g_o}
        o_worst = max(o_rel, key=o_rel.get)
        if net_only:
            gate = (o_p99 < SPARSE_P99_TOL and o_max < SPARSE_MAX_TOL
                    and o_rel[o_worst] < SPARSE_GRAD_TOL)
        else:
            gate = o_max < ORACLE_TOL and o_rel[o_worst] < ORACLE_GRAD_TOL
        k_err = max_err(img_k, img_p)
        grid = "latent.static_grid"
        p_rel = {n: rel_err(g_k[n], g_p[n]) for n in g_p if n != grid}
        p_worst = max(p_rel, key=p_rel.get)
        grid_ok, grid_el, grid_leaf = bench_grid_check(g_k[grid], g_p[grid])
        print(f"phase R {name} gates [{smi}], {BENCH_GATE_RAYS} rays: vs "
              f"f32 lattice oracle image max|d| {o_max:.3e} (p99 "
              f"{o_p99:.3e}), grad-norm rel err {o_rel[o_worst]:.3e} "
              f"({o_worst}) -> {'ok' if gate else 'FAIL'}; kernels vs plain "
              f"image max|d| {k_err:.3e} (tol {KERNEL_TOL}), leaves rel "
              f"{p_rel[p_worst]:.3e} ({p_worst}, tol {GRAD_TOL}), bf16 grid "
              f"largest element error {grid_el:.3e} of its value "
              f"({grid_leaf:.3e} of the leaf's largest; bound "
              f"{BF16_GRID_REL:.3e} + {GRAD_TOL} of the largest) -> "
              f"{'ok' if grid_ok else 'FAIL'}; plain fwd+bwd {gp_ms:.1f} ms",
              flush=True)
        check(gate, f"phase R {name}: bench.py's gate")
        check(k_err <= KERNEL_TOL, f"phase R {name}: image kernel vs plain")
        check(all(float(g.norm()) > 0 for g in g_p.values()),
              f"phase R {name}: a zero gradient")
        check(p_rel[p_worst] <= GRAD_TOL, f"phase R {name}: leaves {p_rel}")
        check(grid_ok, f"phase R {name}: the bf16 grid's gradient")
        res[name] = {"oracle_max": o_max, "oracle_p99": o_p99,
                     "oracle_grad_rel": o_rel[o_worst],
                     "kernel_vs_plain": k_err,
                     "grad_rel_plain": p_rel[p_worst],
                     "grid_elem_rel": grid_el, "grid_leaf_rel": grid_leaf,
                     "plain_fwd_bwd_ms": gp_ms}

    # timing: bench.py's 6 frames after a warm-up; the step also with a
    # float32 table, and phase 10's march (16x16 blocks, no clip, tile
    # 256, float32 table) with bench.py's loss and SGD, in turns
    perm16, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    rs16 = rs_all.reshape(-1, 3)[perm16].contiguous()
    rd16 = rd_all.reshape(-1, 3)[perm16].contiguous()

    def kernel_ms(a):
        """Device ms of rows 1, 2 and 3 alone, summed over the plan's
        buckets (each its clip and mask, 128-ray tiles, the bf16 table),
        the backward seeded with mean(c^2)'s cotangent."""
        plan, net = a["plan"], a["net"]
        spec = fused_mega._spec(net, *box, stepsize=STEPSIZE, seg=BENCH_SEG,
                                tile=BENCH_TILE, density_min=0.0,
                                density_max=1.0, enable_early_out=True)
        params = fused_mega._params(net, a["tf"].tensor)
        widths = fused_mega._widths(params)
        weights = fused_mega._pack_weights(params, spec)
        table = fused_mega.latent_table(params[2], bf16)
        perm_t = torch.as_tensor(plan.perm, device=dev)
        rs_p, rd_p = rs[perm_t], rd[perm_t]
        times = [0.0, 0.0, 0.0]
        ofs = plan.dead
        for g, size in enumerate(plan.group_sizes):
            sl = slice(ofs, ofs + size)
            rays = fused_mega.ray_packet(
                rs_p[sl], rd_p[sl], *box, STEPSIZE,
                torch.as_tensor(plan.tmax_clip[sl], device=dev))
            mask = (None if a["masks"] is None else fused_mega._check_mask(
                a["masks"][g], size // BENCH_TILE, dev))
            n_seg = fused_mega.segments_needed(rays, spec)
            fwd = fused_mega._launch_fwd(rays, weights, table, spec,
                                         *widths[:3], n_seg_max=n_seg,
                                         mask=mask)
            d_out = 2.0 * fwd[0] / n_rays
            times[0] += cuda_ms(lambda: fused_mega._launch_fwd(
                rays, weights, table, spec, *widths[:3], mask=mask),
                BENCH_FRAMES)
            times[1] += cuda_ms(lambda: fused_mega._launch_fwd(
                rays, weights, table, spec, *widths[:3], n_seg_max=n_seg,
                mask=mask), BENCH_FRAMES)
            times[2] += cuda_ms(lambda: fused_mega._launch_bwd(
                rays, weights, table, fwd[2], fwd[3], d_out, spec, *widths,
                mask), BENCH_FRAMES)
            ofs += size
        return times

    for name, a in arms.items():
        def frame(a=a):
            with torch.no_grad():
                return trace(a, a["net"], a["tf"].tensor, False)

        def step256(a=a):
            a["opt"].zero_grad(set_to_none=True)
            img = fused_mega.mega_trace_dvr(
                rs16, rd16, a["step_net"], *box, a["step_tf"],
                stepsize=STEPSIZE, differentiable=True,
                table_dtype=torch.float32)
            (img ** 2).mean().backward()
            a["opt"].step()

        frame_ms = cuda_ms(frame, BENCH_FRAMES)
        step_ms = cuda_ms(steps[name], BENCH_FRAMES)
        step_f32_ms = cuda_ms(lambda: steps[name](table=torch.float32),
                              BENCH_FRAMES)
        step256_ms = cuda_ms(step256, BENCH_FRAMES)
        step_ms2 = cuda_ms(steps[name], BENCH_FRAMES)
        k1, k2, k3 = kernel_ms(a)
        samples = int(a["stats"].samples)
        res[name].update({
            "frame_ms": frame_ms, "frame_mrays": n_rays / frame_ms / 1e3,
            "ns_per_sample": frame_ms * 1e6 / max(1, samples),
            "step_ms": step_ms, "step_ms_again": step_ms2,
            "step_mrays": n_rays / step_ms / 1e3,
            "step_f32_table_ms": step_f32_ms, "step_t256_f32_ms": step256_ms,
            "row1_ms": k1, "row2_ms": k2, "row3_ms": k3,
            "samples": samples, "culled": culled.get(name, 0.0),
            "plan_s": a["plan_s"],
            "buckets": [int(n) for n in a["plan"].group_sizes]})
        print(f"phase R {name} timing [{smi}]: forward frame "
              f"{frame_ms:.3f} ms ({n_rays / frame_ms / 1e3:.3f} Mrays/s, "
              f"{samples} samples, {frame_ms * 1e6 / max(1, samples):.4f} "
              f"ns a sample); training step (fwd + mean(c^2) + bwd + SGD "
              f"1e-7) {step_ms:.3f} / {step_ms2:.3f} ms "
              f"({n_rays / step_ms / 1e3:.3f} Mrays/s); the same with a "
              f"float32 table {step_f32_ms:.3f} ms; phase 10's march (tile "
              f"256, f32 table, 16x16 blocks, no clip) {step256_ms:.3f} ms; "
              f"the kernels alone over the buckets: row 1 {k1:.3f}, row 2 "
              f"{k2:.3f}, row 3 {k3:.3f} ms; culled share "
              f"{culled.get(name, 0.0):.4f} (mean of {BENCH_FRAMES} after a "
              f"warm-up)", flush=True)

    # rows 5-6 with a bf16 table: phase F's march (per ray, tile 128) of
    # the flagship on 64 whole 256-ray tiles against the plain pair, and
    # a full-frame step on both tables
    a = arms["dense"]
    net = a["net"]
    sel = (torch.arange(0, n_rays // 256, n_rays // 256 // ORACLE_TILES,
                        device=dev)[:ORACLE_TILES, None] * 256
           + torch.arange(256, device=dev)).reshape(-1)
    seg_kw = dict(stepsize=STEPSIZE, max_steps=steps_max, seg=32, tile=128,
                  differentiable=True)

    def seg_grads(fn, r_s, r_d, table):
        net.zero_grad(set_to_none=True)
        tf_leaf = a["tf"].tensor.clone().requires_grad_(True)
        img = fn(r_s, r_d, net, *box, tf_leaf, table_dtype=table, **seg_kw)
        (img ** 2).mean().backward()
        g = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        g["tf"] = tf_leaf.grad.detach().clone()
        return img.detach(), g

    reset_counts()
    s_img_k, s_g_k = seg_grads(fused_dvr.fused_trace_dvr, rs16[sel],
                               rd16[sel], bf16)
    torch.cuda.synchronize()
    c_s = counts()
    s_inst = dict(fused_dvr_bwd.LAUNCHES)
    check(s_inst.get("segment_fwd_diff:bf16", 0) > 0
          and s_inst.get("segment_bwd:bf16", 0) > 0,
          f"phase R rows 5-6: the bf16 instances did not run ({s_inst})")
    s_img_p, s_g_p = seg_grads(fused_dvr.fused_trace_dvr_plain, rs16[sel],
                               rd16[sel], bf16)
    s_err = max_err(s_img_k, s_img_p)
    s_rel = {n: rel_err(s_g_k[n], s_g_p[n]) for n in s_g_p
             if n != "latent.static_grid"}
    s_worst = max(s_rel, key=s_rel.get)
    s_grid_ok, s_grid_el, s_grid_leaf = bench_grid_check(
        s_g_k["latent.static_grid"], s_g_p["latent.static_grid"])

    def seg_step(table):
        return lambda: seg_grads(fused_dvr.fused_trace_dvr, rs16, rd16,
                                 table)

    s_bf16_ms = cuda_ms(seg_step(bf16), TIMED_STEPS)
    s_f32_ms = cuda_ms(seg_step(torch.float32), TIMED_STEPS)
    print(f"phase R rows 5-6 bf16 table [{smi}]: {sel.numel()} rays, kernel "
          f"vs plain image max|d| {s_err:.3e} (tol {KERNEL_TOL}), leaves rel "
          f"{s_rel[s_worst]:.3e} ({s_worst}, tol {GRAD_TOL}), bf16 grid "
          f"largest element error {s_grid_el:.3e} of its value "
          f"({s_grid_leaf:.3e} of the leaf's largest) -> "
          f"{'ok' if s_grid_ok else 'FAIL'}; full-frame fwd+bwd "
          f"{s_bf16_ms:.3f} ms bf16, {s_f32_ms:.3f} ms f32 table; launches "
          f"{c_s}, by instance {s_inst}", flush=True)
    check(s_err <= KERNEL_TOL, "phase R rows 5-6: image kernel vs plain")
    check(s_rel[s_worst] <= GRAD_TOL, f"phase R rows 5-6: leaves {s_rel}")
    check(s_grid_ok, "phase R rows 5-6: the bf16 grid's gradient")
    res["rows56"] = {"kernel_vs_plain": s_err,
                     "grad_rel_plain": s_rel[s_worst],
                     "grid_elem_rel": s_grid_el,
                     "grid_leaf_rel": s_grid_leaf,
                     "step_bf16_ms": s_bf16_ms, "step_f32_ms": s_f32_ms,
                     "launches": s_inst}
    res["launches"] = inst
    print(f"phase R: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return res


def ray_gradients(smi, reset_counts, counts, cam):
    """Phase S: row 3's ray gradients on the card. The flagship at 512^2,
    1/512, the camera matrix's gradient through ``generate_rays`` and
    ``mega_trace_dvr(ray_grads=True)`` (as the JAX package's
    test_mega_ray_gradients_camera_matrix: no early-out, loss
    mean(c^2)); the kernels against the plain version on 64 whole tiles
    (the matrix's, the rays' and every leaf's gradient); row 3 timed with
    and without the ray gradients (phase 10's march) in turns. Returns
    row 3's figures."""
    from fvsrn_tpu_torch.camera import camera_matrix, generate_rays
    from fvsrn_tpu_torch.ops import fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
    from fvsrn_tpu_torch.scenes import dense_scene
    from fvsrn_tpu_torch.train.checkpoints import load_weights

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    n_rays = WIDTH * HEIGHT
    _, tf, npz = dense_scene()
    net = load_weights(npz).to(dev)
    tf_d = tf.tensor.to(dev)
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    m0 = camera_matrix(cam).to(dev)

    def frame(march, sel=None):
        """(matrix, start, direction gradients, leaves) of one step."""
        net.zero_grad(set_to_none=True)
        m = m0.clone().requires_grad_(True)
        r_s, r_d = generate_rays(m, WIDTH, HEIGHT, cam.fov_y_radians)
        r_s, r_d = r_s.reshape(-1, 3)[perm], r_d.reshape(-1, 3)[perm]
        if sel is not None:
            r_s, r_d = r_s[sel], r_d[sel]
        r_s.retain_grad()
        r_d.retain_grad()
        img = march(r_s, r_d, net, *box, tf_d, stepsize=STEPSIZE,
                    differentiable=True, ray_grads=True,
                    enable_early_out=False)
        (img ** 2).mean().backward()
        return (m.grad.detach().clone(), r_s.grad.detach().clone(),
                r_d.grad.detach().clone(),
                {n: p.grad.detach().clone() for n, p in
                 net.named_parameters()})

    reset_counts()
    g_m, _, _, _ = frame(fused_mega.mega_trace_dvr)
    torch.cuda.synchronize()
    c_s = counts()
    inst = dict(fused_mega.LAUNCHES)
    check(inst.get("mega_bwd:t256:f32:rays", 0) > 0,
          f"phase S: the ray-gradient instance did not run ({inst})")
    check(bool(torch.isfinite(g_m).all()) and float(g_m.abs().max()) > 0,
          f"phase S: the camera gradient {g_m}")
    sel = (torch.arange(0, n_rays // 256, n_rays // 256 // ORACLE_TILES,
                        device=dev)[:ORACLE_TILES, None] * 256
           + torch.arange(256, device=dev)).reshape(-1)
    k = frame(fused_mega.mega_trace_dvr, sel)
    p, p_ms = cuda_once(lambda: frame(fused_mega.mega_trace_dvr_plain, sel))
    errs = {"matrix": rel_err(k[0], p[0]), "ray_start": rel_err(k[1], p[1]),
            "ray_dir": rel_err(k[2], p[2])}
    errs.update({n: rel_err(k[3][n], p[3][n]) for n in p[3]})
    worst = max(errs, key=errs.get)
    print(f"phase S ray gradients [{smi}]: {WIDTH}x{HEIGHT} "
          f"h=1/{round(1 / STEPSIZE)}, camera gradient {g_m.flatten()}; "
          f"kernels vs plain on {sel.numel()} rays: rel norm err "
          f"{', '.join(f'{n} {v:.2e}' for n, v in errs.items())} (tol "
          f"{GRAD_TOL}, worst {worst}); plain fwd+bwd {p_ms:.1f} ms; "
          f"launches {c_s}, by instance {inst}", flush=True)
    check(errs[worst] <= GRAD_TOL, f"phase S: kernel vs plain {errs}")

    # row 3 alone with and without the ray gradients, phase 10's march
    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    rs = rs.reshape(-1, 3)[perm].contiguous()
    rd = rd.reshape(-1, 3)[perm].contiguous()
    spec = fused_mega._spec(net, *box, stepsize=STEPSIZE, seg=32, tile=256,
                            density_min=0.0, density_max=1.0,
                            enable_early_out=True)
    rays = fused_mega.ray_packet(rs, rd, *box, STEPSIZE)
    params = fused_mega._params(net, tf_d)
    widths = fused_mega._widths(params)
    weights = fused_mega._pack_weights(params, spec)
    table = fused_mega.latent_table(params[2], torch.float32)
    n_seg = fused_mega.segments_needed(rays, spec)
    fwd = fused_mega._launch_fwd(rays, weights, table, spec, *widths[:3],
                                 n_seg_max=n_seg)
    d_out = 2.0 * fwd[0] / fwd[0].numel()

    def bwd(ray_grads):
        return lambda: fused_mega._launch_bwd(
            rays, weights, table, fwd[2], fwd[3], d_out, spec, *widths,
            ray_grads=ray_grads)

    t = [cuda_ms(bwd(False), TIMED_STEPS), cuda_ms(bwd(True), TIMED_STEPS),
         cuda_ms(bwd(True), TIMED_STEPS), cuda_ms(bwd(False), TIMED_STEPS)]
    plain_ms, rays_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    d_rays = bwd(True)()[3]
    check(bool(torch.isfinite(d_rays).all())
          and float(d_rays[:, :6].abs().max()) > 0
          and float(d_rays[:, 6:].abs().max()) == 0.0,
          "phase S: the ray cotangent's columns")
    print(f"phase S row 3 timing [{smi}]: without ray gradients "
          f"{t[0]:.3f} / {t[3]:.3f} ms, with {t[1]:.3f} / {t[2]:.3f} ms "
          f"(overhead {rays_ms / plain_ms - 1.0:.4f}); phase S "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"bwd_ms": plain_ms, "bwd_ray_grads_ms": rays_ms,
            "overhead": rays_ms / plain_ms - 1.0, "timings": t,
            "grad_rel_plain": errs,
            "plain_fwd_bwd_ms": p_ms,
            "launches": inst, "camera_grad": g_m.flatten().tolist()}


POSE_TOL = KERNEL_TOL                # phase T: row 1 vs plain on an LM render
DP_SIZE = 128                        # phase U2's trainer, U3's MC frame
DP_LOSS_RTOL = 1e-5                  # phase U: loss vs the single process
MC_SHARD_TOL = 2e-6                  # phase U3 (tests/test_parallel.py:271)
DP_TIME = (1.5, 0.5)                 # phase U3's (t, e) of config 5


def pose_recovery(smi, reset_counts, counts):
    """Phase T: camera pose recovery through row 1, the counterpart of the
    JAX package's demo (``tools.pose_recovery_demo``: the trained
    flagship, 64x64 with 4 fixed jittered samples a pixel, 1/128, LM for
    15 iterations on central differences, every render one launch of
    ``mega_fwd``), gated as JAX's tests/test_pose.py (final cost below 5%
    of the start's, pose error below 35% of the perturbation's); row 1
    against its plain version on the rays of the render at the recovered
    pose (image <= 1e-4), both timed. Returns its figures."""
    from fvsrn_tpu_torch.ops import fused_mega
    from fvsrn_tpu_torch.tools import pose_recovery_demo as demo

    t_phase = time.perf_counter()
    reset_counts()
    rec = demo.run(device=DEVICE)
    c = counts()
    check(c["mega_fwd"] == rec["renders"] > 0,
          f"phase T: {rec['renders']} renders, launches {c}")
    check(rec["cost1"] < 0.05 * rec["cost0"]
          and rec["err1"] < 0.35 * rec["err0"],
          f"phase T: cost {rec['cost0']} -> {rec['cost1']}, pose error "
          f"{rec['err0']} -> {rec['err1']}")
    kernel = demo.make_render_rays(DEVICE)
    plain = demo.make_render_rays(DEVICE, fused_mega.mega_trace_dvr_plain)
    rays = {}

    def capture(rs, rd):
        rays["rs"], rays["rd"] = rs, rd
        return kernel(rs, rd)

    demo.make_render(capture, DEVICE)(np.asarray(rec["recovered"],
                                                 np.float32))
    rs, rd = rays["rs"], rays["rd"]
    err = max_err(kernel(rs, rd), plain(rs, rd))
    check(err <= POSE_TOL, f"phase T: row 1 vs plain {err}")
    ms = cuda_ms(lambda: kernel(rs, rd), 10)
    plain_ms = cuda_ms(lambda: plain(rs, rd), 1)
    out = dict(rec, launches=c["mega_fwd"], max_abs_err=err, ms=ms,
               plain_ms=plain_ms, rays=rs.shape[0],
               seconds=time.perf_counter() - t_phase)
    print(f"phase T pose recovery [{smi}]: {rec['iterations']} iterations, "
          f"{rec['renders']} renders of {rs.shape[0]} rays (mega_fwd "
          f"launches {c['mega_fwd']}); cost {rec['cost0']:.4e} -> "
          f"{rec['cost1']:.4e} (costs {rec['costs']}); pose error "
          f"{rec['err0']:.4f} -> {rec['err1']:.3e} (ratio "
          f"{rec['err_ratio']:.3e}), recovered {rec['recovered']}; LM wall "
          f"{rec['wall_s']:.3f} s; row 1 vs plain {err:.3e} (tol "
          f"{POSE_TOL}), row 1 {ms:.3f} ms, plain {plain_ms:.1f} ms a "
          f"render; phase T {out['seconds']:.1f} s", flush=True)
    return out


def _grads(net):
    return {n: p.grad.detach().cpu().clone() for n, p in
            net.named_parameters()}


def _rank_counts():
    from fvsrn_tpu_torch.ops import fused_eval, fused_mega
    return {"mega_fwd_diff": fused_mega.launches("mega_fwd_diff"),
            "mega_bwd": fused_mega.launches("mega_bwd"),
            "sample_eval": fused_eval.SAMPLE_EVAL_LAUNCHES}


def _reset_rank_counts():
    from fvsrn_tpu_torch.ops import fused_eval, fused_mega
    fused_mega.LAUNCHES.clear()
    fused_eval.SAMPLE_EVAL_LAUNCHES = 0


def _dp_screen_setup(dev, npz, data):
    """The flagship, its TF, stepping and loss, and the two-camera 512^2
    dataset on ``dev``."""
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    from fvsrn_tpu_torch.scenes import dense_scene
    from fvsrn_tpu_torch.train.checkpoints import load_weights
    from fvsrn_tpu_torch.train.losses import LossNetScreen
    from fvsrn_tpu_torch.train.screen import (ScreenDataset,
                                              screen_mega_kwargs)
    _, tf, _ = dense_scene()
    ds = ScreenDataset(*(torch.from_numpy(a).to(dev) for a in data), WIDTH,
                       HEIGHT)
    return (load_weights(npz).to(dev), tf.to(dev),
            RayEvaluationSteppingDvr.make(stepsize=STEPSIZE),
            LossNetScreen(l1=1.0), ds, screen_mega_kwargs(ds))


def _dp_gloo_ranks(mesh, npz, data):
    """Phase U1 and U3 on one rank of two ``gloo`` ranks sharing the card:
    the data-parallel screen step (rows 2-3) with the latent all-reduce
    trailing, overlapped, trailing again; then this rank's half of config
    5's MC frame through row 7. Rank 0's results go back."""
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from fvsrn_tpu_torch.parallel.train_step import make_dp_screen_train_step
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.dvr import max_steps_bound
    from fvsrn_tpu_torch.raytracer.montecarlo import (
        RayEvaluationMonteCarlo, trace_mc)
    from fvsrn_tpu_torch.scenes import dense_scene
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.utils.prng import prng_key

    dev = mesh.device
    out = {"backend": mesh.backend, "device": str(dev), "steps": []}
    for overlap in (False, True, False):
        net, tf, cfg, loss, ds, fk = _dp_screen_setup(dev, npz, data)
        step = make_dp_screen_train_step(
            mesh, tf, cfg, loss, make_optimizer(net.parameters(), "Adam",
                                                lr=1e-3),
            width=WIDTH, height=HEIGHT,
            max_steps=max_steps_bound((1.0, 1.0, 1.0), STEPSIZE),
            use_fused=True, fused_kwargs=fk, overlap_grads=overlap)
        _reset_rank_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = step(net, *shard_batch(mesh, (ds.ray_start, ds.ray_dir,
                                              ds.targets)))
        torch.cuda.synchronize()
        out["steps"].append({"overlap": overlap, "loss": float(total),
                             "grads": _grads(net),
                             "seconds": time.perf_counter() - t0,
                             "counts": _rank_counts()})
    # U3: config 5's network, this rank's rays, draws keyed by ray id
    net = vector_net(npz, dev)
    tf = dense_scene()[1].to(dev)
    rs, rd, rid = _mc_rays(dev)
    vol = VolumeInterpolationNetwork(net, (-0.5, -0.5, -0.5),
                                     (1.0, 1.0, 1.0), time=DP_TIME[0],
                                     ensemble=DP_TIME[1])
    cfg = RayEvaluationMonteCarlo.make(max_absorption=30.0, num_bounces=2,
                                       max_iterations=256)
    rs_k, rd_k, rid_k = shard_batch(mesh, (rs, rd, rid))
    _reset_rank_counts()
    color = trace_mc(prng_key(11), rs_k, rd_k, vol, tf,
                     PhaseFunctionHenyeyGreenstein.make(g=0.3), cfg,
                     ray_id=rid_k, use_fused=True).color
    out["mc_counts"] = _rank_counts()
    out["mc"] = gather_batch(mesh, color).cpu()
    return out


def _mc_rays(dev):
    from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
    rs, rd = generate_rays(CameraOnASphere.make(**CAMERA), DP_SIZE, DP_SIZE,
                           device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    return rs, rd, torch.arange(rs.shape[0], dtype=torch.int64, device=dev)


def _dp_trainer_args(out, data_parallel):
    args = list(TRAIN_ARGS)
    args[args.index("--screen_size") + 1] = str(DP_SIZE)
    args[args.index("-i") + 1] = "1"
    args.insert(1, out)
    if data_parallel:
        args += ["--data_parallel", str(data_parallel)]
    return args


def _dp_nccl_rank(mesh, out):
    """Phase U2 on one ``nccl`` rank: ``train.main.run --data_parallel 1``
    in the group ``spawn`` made."""
    from fvsrn_tpu_torch.train import main as train_main
    opt = vars(train_main.init_parser().parse_args(_dp_trainer_args(out, 1)))
    _reset_rank_counts()
    res = train_main.run(opt)
    return {"backend": mesh.backend, "history": res["history"],
            "fused": res["fused"], "counts": _rank_counts(),
            "params": {n: p.detach().cpu() for n, p in
                       res["network"].named_parameters()}}


def data_parallel(smi, reset_counts, counts, npz):
    """Phase U, data parallelism on ``torch.distributed`` (BASELINE
    configs 4 and 5), ranks spawned from this script (``parallel.mesh
    .spawn``, a ``file://`` store) once every library they load is
    built; a rank's failure or a mismatch fails the run. U1: two ``gloo``
    ranks share the card and take one data-parallel screen step on the
    flagship at 512^2, 1/512 through rows 2-3 (two cameras, one a rank,
    L1, Adam 1e-3) against one process's step on both cameras (loss rtol
    1e-5, every leaf's averaged gradient within 2e-4 relative norm), the
    latent all-reduce overlapped with the backward against the trailing
    one. U2: one ``nccl`` rank runs ``train.main.run --data_parallel 1``
    (2 cameras at 128^2, 1 epoch: 2 steps) against the single-process
    trainer. U3: config 5's ray-sharded MC, the two ``gloo`` ranks' halves
    of a 128^2 frame through row 7 (draws keyed by ray id) against one
    process's ``trace_mc``, atol 2e-6 (JAX's bound). Returns the figures
    of rows 2, 3 and 7."""
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import _build
    from fvsrn_tpu_torch.parallel.mesh import spawn
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.montecarlo import (
        RayEvaluationMonteCarlo, trace_mc)
    from fvsrn_tpu_torch.scenes import dense_scene
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.train.screen import (build_screen_dataset,
                                              evaluate_screen)
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound)
    from fvsrn_tpu_torch.utils.prng import prng_key

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    _build.build(["mega_fwd", "mega_bwd", "sample_eval"])
    vol, tf, _ = dense_scene()
    ds = build_screen_dataset(vol, tf, RayEvaluationSteppingDvr.make(
        stepsize=STEPSIZE), num_cameras=2, width=WIDTH, height=HEIGHT,
        device=dev)
    data = tuple(t.cpu().numpy() for t in ds[:3])

    # U1 and U3 on two gloo ranks
    t0 = time.perf_counter()
    ranks = spawn(_dp_gloo_ranks, 2, npz, data, device=DEVICE,
                  backend="gloo")
    gloo_s = time.perf_counter() - t0
    check(ranks["backend"] == "gloo" and ranks["device"] == "cuda:0",
          f"phase U1: {ranks['backend']} on {ranks['device']}")
    # the single-process step on both cameras
    net, tf_d, cfg, loss, ds_d, fk = _dp_screen_setup(dev, npz, data)
    reset_counts()
    total, _ = evaluate_screen(net, ds_d.ray_start, ds_d.ray_dir,
                               ds_d.targets, tf_d, cfg, loss,
                               max_steps_bound((1.0, 1.0, 1.0), STEPSIZE),
                               WIDTH, HEIGHT, use_fused=True,
                               fused_kwargs=fk)
    total.backward()
    total = float(total.detach())
    c1 = counts()
    single = _grads(net)
    steps = ranks["steps"]
    for s in steps:
        check(s["counts"]["mega_fwd_diff"] >= 1 and s["counts"]["mega_bwd"]
              >= 1, f"phase U1: a rank's launches {s['counts']}")
    loss_rel = abs(steps[0]["loss"] - total) / abs(total)
    rel = {n: rel_err(steps[0]["grads"][n], single[n]) for n in single}
    worst = max(rel, key=rel.get)
    print(f"phase U1 data-parallel screen step [{smi}]: 2 gloo ranks on "
          f"cuda:0, flagship {WIDTH}x{HEIGHT} h=1/{round(1 / STEPSIZE)}, "
          f"rows 2-3 (a rank's launches {steps[0]['counts']}); loss "
          f"{steps[0]['loss']:.7e} vs one process {total:.7e} (rel "
          f"{loss_rel:.2e}, tol {DP_LOSS_RTOL}); averaged gradients vs one "
          f"process, rel norm "
          f"{', '.join(f'{n} {v:.2e}' for n, v in rel.items())} (tol "
          f"{GRAD_TOL}); a rank's steps, host clock: trailing "
          f"{steps[0]['seconds'] * 1e3:.1f} ms (the process's first), "
          f"overlapped {steps[1]['seconds'] * 1e3:.1f} ms, trailing "
          f"{steps[2]['seconds'] * 1e3:.1f} ms; one process's launches "
          f"{c1}", flush=True)
    check(loss_rel <= DP_LOSS_RTOL and rel[worst] <= GRAD_TOL,
          f"phase U1: loss rel {loss_rel}, gradients {rel}")
    # overlapped vs trailing all-reduce; the trailing one twice shows what
    # the backward's latent atomics change between two identical steps
    a, b, again = (s["grads"] for s in steps)
    diff = [n for n in a if not torch.equal(a[n], b[n])]
    noisy = [n for n in a if not torch.equal(a[n], again[n])]
    over = {n: rel_err(b[n], a[n]) for n in diff}
    print(f"phase U1 overlap: losses {[s['loss'] for s in steps]}; leaves "
          f"not bitwise equal, overlapped vs trailing {diff} (rel "
          f"{over}), trailing vs trailing again {noisy}", flush=True)
    check(steps[1]["loss"] == steps[0]["loss"] == steps[2]["loss"]
          and set(diff) <= set(noisy)
          and all(v <= GRAD_TOL for v in over.values()),
          f"phase U1: overlap changed {diff} beyond the step's own "
          f"run-to-run noise {noisy}")

    # U3: config 5's MC frame, one process against the ranks' halves
    mnet = vector_net(npz, dev)
    rs, rd, rid = _mc_rays(dev)
    mvol = VolumeInterpolationNetwork(mnet, (-0.5, -0.5, -0.5),
                                      (1.0, 1.0, 1.0), time=DP_TIME[0],
                                      ensemble=DP_TIME[1])
    mcfg = RayEvaluationMonteCarlo.make(max_absorption=30.0, num_bounces=2,
                                        max_iterations=256)
    whole = trace_mc(prng_key(11), rs, rd, mvol, tf.to(dev),
                     PhaseFunctionHenyeyGreenstein.make(g=0.3), mcfg,
                     ray_id=rid, use_fused=True).color.cpu()
    mc_err = float((ranks["mc"] - whole).abs().max())
    alpha = float(whole[:, 3].mean())
    print(f"phase U3 ray-sharded MC [{smi}]: config 5 (the flagship with "
          f"latent vectors) at t={DP_TIME[0]}, e={DP_TIME[1]}, "
          f"{DP_SIZE}x{DP_SIZE}, 2 bounces, 2 gloo ranks through row 7 "
          f"(a rank's launches {ranks['mc_counts']}); max|d| vs one "
          f"process {mc_err:.3e} (tol {MC_SHARD_TOL}), alpha mean "
          f"{alpha:.4f}; the gloo job {gloo_s:.1f} s", flush=True)
    check(ranks["mc_counts"]["sample_eval"] > 0 and mc_err <= MC_SHARD_TOL
          and alpha > 0.02, f"phase U3: {mc_err}, {ranks['mc_counts']}")

    # U2: one nccl rank, the trainer's --data_parallel 1, against the
    # single-process trainer
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    nccl = spawn(_dp_nccl_rank, 1, os.path.join(tmp, "dp1.npz"),
                 device=DEVICE, backend="nccl")
    nccl_s = time.perf_counter() - t0
    plain = train_main.run(vars(train_main.init_parser().parse_args(
        _dp_trainer_args(os.path.join(tmp, "single.npz"), 0))))
    h_rel = float(np.max(np.abs(np.asarray(nccl["history"])
                                - np.asarray(plain["history"]))
                         / np.abs(np.asarray(plain["history"]))))
    p_rel = {n: rel_err(nccl["params"][n], p.detach().cpu())
             for n, p in plain["network"].named_parameters()}
    worst = max(p_rel, key=p_rel.get)
    print(f"phase U2 trainer --data_parallel 1 [{smi}]: 1 {nccl['backend']} "
          f"rank, {DP_SIZE}x{DP_SIZE}, 2 steps, fused {nccl['fused']} "
          f"(launches {nccl['counts']}); history {nccl['history']} vs the "
          f"single-process trainer {plain['history']} (rel {h_rel:.2e}); "
          f"parameters rel norm worst {worst} {p_rel[worst]:.2e} (tol "
          f"{GRAD_TOL}); the nccl job {nccl_s:.1f} s; phase U "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(nccl["backend"] == "nccl" and nccl["fused"]
          and nccl["counts"]["mega_bwd"] >= 2
          and h_rel <= DP_LOSS_RTOL and p_rel[worst] <= GRAD_TOL,
          f"phase U2: history {h_rel}, parameters {p_rel}, "
          f"{nccl['counts']}")
    u1 = {"launches": steps[0]["counts"], "loss_rel": loss_rel,
          "grad_rel": rel, "step_ms": steps[2]["seconds"] * 1e3,
          "overlap_step_ms": steps[1]["seconds"] * 1e3,
          "first_step_ms": steps[0]["seconds"] * 1e3,
          "overlap_not_bitwise": diff, "rerun_not_bitwise": noisy,
          "job_s": gloo_s}
    u2 = {"launches": nccl["counts"], "history_rel": h_rel,
          "param_rel": p_rel, "job_s": nccl_s}
    return {"mega_fwd_diff": {"u1": u1, "u2": u2},
            "mega_bwd": {"u1": u1, "u2": u2},
            "sample_eval": {"launches": ranks["mc_counts"]["sample_eval"],
                            "max_abs_err": mc_err, "job_s": gloo_s},
            "seconds": time.perf_counter() - t_phase}


# phase V: the paper's evaluation harnesses (fvsrn_tpu_torch/eval)
EVAL_EPOCHS = 2                      # V2's sweeps, cut in depth only
EVAL_CAMERAS = 2                     # V1: its PLAIN32 frames cut in depth
EVAL_V1_SIZE = 256                   # and in size (3.2 s a frame at 512^2)
EVAL_SIZE = 128                      # V2: the sweeps' FUSED render (sweep.py)
TEASER_EPOCHS = 10                   # V3's fit
TEASER_MIN_PSNR = 20.0               # V3: every codec decodes to its volume
# V1: FUSED (bf16 table, lattice march) against PLAIN32 in SSIM vs the
# reference: JAX's own harness reads them 4e-4 apart at 32^2 on the CPU
# (tests/test_torch_eval.py)
EVAL_SSIM_TOL = 1e-3


def _held_frame(phase, render):
    """A prepared FUSED render's kernel against its plain version on the
    same rays (image <= KERNEL_TOL): the error and the kernel's ms."""
    from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
    plain = (fused_mega.mega_trace_dvr_plain if render.route == "mega"
             else fused_dvr.fused_trace_dvr_plain)
    err = max_err(render.march(), render.march(plain))
    check(err <= KERNEL_TOL, f"phase {phase}: {render.route} kernel vs "
          f"plain {err}")
    return err, cuda_ms(lambda: render.march(), 5)


def evaluation(smi, reset_counts, counts):
    """Phase V, the paper's evaluation harnesses on rows 1-3, through the
    scripts' own entry points. V1: ``eval_volumetric_features --scene
    dense`` at its defaults but EVAL_CAMERAS cameras at EVAL_V1_SIZE^2
    (1/512, the plain PLAIN32 frames cut in depth; FUSED and PLAIN32,
    SSIM vs ``render_reference``): row 1 launched, camera 0's FUSED frame
    the kernel's and the kernel against its plain version (<= 1e-4), both
    SSIMs finite and within EVAL_SSIM_TOL. V2: ``eval_screen_vs_world``
    and ``eval_density_vs_color --render`` through ``sweep_main``,
    ``--epochs 2``: rows 2-3 launched by the screen entry, row 1 by each
    render; every trained net's FUSED 128^2 frame against its plain
    version (<= 1e-4). V3: ``eval_compression_teaser --train-epochs 10``
    at 64^3: every codec decodes to its volume (PSNR >= 20 dB). Returns
    the figures of rows 1-3."""
    from fvsrn_tpu_torch.eval import (eval_compression_teaser,
                                      eval_density_vs_color,
                                      eval_screen_vs_world, sweep)
    from fvsrn_tpu_torch.eval import eval_volumetric_features as evf
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.train.main import _resolve_scene

    t_phase = time.perf_counter()
    # V1. the headline harness on the dense flagship
    args = evf.parse_args(["--scene", "dense", "--cameras",
                           str(EVAL_CAMERAS), "--width", str(EVAL_V1_SIZE),
                           "--height", str(EVAL_V1_SIZE)])
    model = evf.load_model(args)
    images = {}
    reset_counts()
    t0 = time.perf_counter()
    res = evf.evaluate(model, args, images=images)
    torch.cuda.synchronize()
    v1_s = time.perf_counter() - t0
    c1 = counts()
    cam0 = LoadedModel.rotation_cameras(args.cameras, **evf.CAMERA)[0]
    render = model.prepare_network_render(cam0, args.width, args.height,
                                          "FUSED", device=DEVICE)
    check(render.route == "mega", f"phase V1: route {render.route}")
    frame_err = max_err(images["FUSED"], render())
    err, kernel_ms = _held_frame("V1", render)
    fused, plain = res["FUSED"], res["PLAIN32"]
    d_ssim = abs(fused["ssim_vs_reference"] - plain["ssim_vs_reference"])
    modes_err = max_err(images["FUSED"], images["PLAIN32"])
    print(f"phase V1 eval_volumetric_features --scene dense [{smi}]: "
          f"{args.width}x{args.height}, 1/{round(1 / args.stepsize)}, "
          f"{args.cameras} cameras: FUSED {fused['frame_ms_mean']} ms/frame "
          f"(std {fused['frame_ms_std']}, {fused['mrays_per_s']} Mrays/s, "
          f"SSIM {fused['ssim_vs_reference']}), PLAIN32 "
          f"{plain['frame_ms_mean']} ms/frame (std {plain['frame_ms_std']}, "
          f"{plain['mrays_per_s']} Mrays/s, SSIM "
          f"{plain['ssim_vs_reference']}); LPIPS "
          f"{fused['lpips_vs_reference']}; mega_fwd launches "
          f"{c1['mega_fwd']}; camera 0's frame vs the kernel's "
          f"{frame_err:.3e}, kernel vs plain {err:.3e} (tol {KERNEL_TOL}), "
          f"kernel {kernel_ms:.3f} ms; FUSED vs PLAIN32 image max|d| "
          f"{modes_err:.3e}, SSIM |d| {d_ssim:.2e} (tol {EVAL_SSIM_TOL}); "
          f"harness {v1_s:.1f} s", flush=True)
    check(c1["mega_fwd"] > 0 and frame_err <= KERNEL_TOL,
          f"phase V1: launches {c1}, frame vs kernel {frame_err}")
    check(all(math.isfinite(r["ssim_vs_reference"]) for r in (fused, plain))
          and d_ssim <= EVAL_SSIM_TOL, f"phase V1: SSIM {fused} {plain}")
    v1 = {"launches": c1["mega_fwd"], "frame_ms": fused["frame_ms_mean"],
          "frame_ms_std": fused["frame_ms_std"],
          "mrays_per_s": fused["mrays_per_s"],
          "plain32_frame_ms": plain["frame_ms_mean"],
          "ssim": fused["ssim_vs_reference"],
          "plain32_ssim": plain["ssim_vs_reference"],
          "max_abs_err": err, "ms": kernel_ms,
          "fused_vs_plain32_max_abs": modes_err, "seconds": v1_s}

    # V2. two sweep scripts, cut in depth only
    v2 = {}
    for mod, extra in ((eval_screen_vs_world, []),
                       (eval_density_vs_color, ["--render"])):
        name = mod.__name__.rsplit(".", 1)[1]
        nets = {}
        reset_counts()
        t0 = time.perf_counter()
        sweep.sweep_main(mod.configs, mod.__doc__,
                         ["--epochs", str(EVAL_EPOCHS)] + extra,
                         networks=nets)
        torch.cuda.synchronize()
        c = counts()
        entry = {"launches": c, "seconds": time.perf_counter() - t0,
                 "nets": {}}
        if mod is eval_screen_vs_world:
            check(c["mega_fwd_diff"] >= EVAL_EPOCHS
                  and c["mega_bwd"] >= EVAL_EPOCHS,
                  f"phase V2 {name}: the screen entry's launches {c}")
        else:
            check(c["mega_fwd"] >= 2 * len(nets),
                  f"phase V2 {name}: render launches {c}")
        _, tf, cfg = _resolve_scene("IMPLICIT:MARSCHNER_LOBB")
        for key, net in nets.items():
            lm = LoadedModel(net, tf, config=cfg)
            r = lm.prepare_network_render(lm.rotation_cameras(1)[0],
                                          EVAL_SIZE, EVAL_SIZE, "FUSED",
                                          device=DEVICE)
            reset_counts()
            r()
            torch.cuda.synchronize()
            n = counts()
            n = n["mega_fwd"] if r.route == "mega" else n["segment_fwd"]
            check(n >= 1, f"phase V2 {name} {key}: {r.route} not launched")
            err, ms = _held_frame(f"V2 {name} {key}", r)
            entry["nets"][key] = {"route": r.route, "launches": n,
                                  "max_abs_err": err, "ms": ms,
                                  "head": net.output_mode}
        print(f"phase V2 {name} --epochs {EVAL_EPOCHS} {' '.join(extra)} "
              f"[{smi}]: launches {c}; {EVAL_SIZE}^2 FUSED kernel vs plain "
              + ", ".join(f"{k} ({v['head']}, {v['route']}) "
                          f"{v['max_abs_err']:.2e} in {v['ms']:.3f} ms"
                          for k, v in entry["nets"].items())
              + f"; {entry['seconds']:.1f} s", flush=True)
        v2[name] = entry

    # V3. the compression teaser
    t0 = time.perf_counter()
    table = eval_compression_teaser.teaser(train_epochs=TEASER_EPOCHS,
                                           device=DEVICE)
    v3_s = time.perf_counter() - t0
    codecs = {k: v for k, v in table.items() if k != "network"}
    print(f"phase V3 eval_compression_teaser --train-epochs "
          f"{TEASER_EPOCHS} [{smi}]: 64^3, "
          + ", ".join(f"{k} {v['bytes']} B {v['psnr']:.2f} dB"
                      for k, v in table.items())
          + f"; {v3_s:.1f} s", flush=True)
    check(len(codecs) == 12 and all(
        math.isfinite(v["psnr"]) and v["psnr"] >= TEASER_MIN_PSNR
        and 0 < v["bytes"] < 64 ** 3 * 4 for v in codecs.values())
          and math.isfinite(table["network"]["psnr"]),
          f"phase V3: {table}")
    seconds = time.perf_counter() - t_phase
    print(f"phase V evaluation: {seconds:.1f} s", flush=True)
    screen = v2["eval_screen_vs_world"]["launches"]
    renders = v2["eval_density_vs_color"]
    return {"mega_fwd": {"v1": v1, "v2_render_launches":
                         renders["launches"]["mega_fwd"],
                         "v2_nets": renders["nets"],
                         "v3": {"table": table, "seconds": v3_s},
                         "seconds": seconds},
            "mega_fwd_diff": {"v2_screen_launches": screen["mega_fwd_diff"]},
            "mega_bwd": {"v2_screen_launches": screen["mega_bwd"]}}


# phase W: the last slice's modules on the card
W_SIZE = 512                         # W1: the viewer's render requests
W_MC_SIZE = 128                      # W1: the progressive MC evaluator
W_ORBITS = (dict(pitch=0.35, yaw=0.6, distance=1.8),
            dict(pitch=0.35, yaw=2.6, distance=1.8),
            dict(pitch=0.35, yaw=0.6, distance=1.8, opacity=0.4),
            dict(pitch=-0.3, yaw=4.0, distance=1.5, opacity=2.0))
W_STEPS = 200                        # W3: world steps a network
W_BATCH = 1 << 16                    # W3: positions a step
W_RENDER = 128                       # W3: PLAIN32 render
W_CPU_POSITIONS = 4096               # W3: card vs CPU forward
W_NET_TOL = 1e-5                     # W3: card vs CPU forward
W_GRID = 256                         # W4: the converted volumes
W_IMAGE = (4, 512, 512)              # W4: imageops on the card
W_IMAGE_TOL = 1e-6
# phase X: the texture and preintegrated TFs on networks other than
# SnakeAlt without direction input, rows 1 (route 1) and 4 (route 2)
X_NETS = {
    "relu_dir": dict(layers="32:32:32", activation="ReLU",
                     use_direction=True, disable_direction_in_fourier=False),
    "sine30": dict(layers="32:32:32", activation="Sine:30"),
    "relu_dir64": dict(layers="64:64:64", activation="ReLU",
                       use_direction=True,
                       disable_direction_in_fourier=False),
}
X_MODES = ("texture", "preint1d", "preint2d")
# phase Y: every TF mode on every network in training, rows 2-3 and 5-6:
# phase X's networks (random, seeded) under phase N's four modes; the
# networks whose gradients float32 itself conditions badly (NET_ILL's
# rule); the trainer's own entry point on phase M's volume
Y_MODES = ("texture", "preint1d", "preint2d", "gaussian")
Y_ILL = {"sine30"}
Y_BF16 = ("relu_dir", "texture")     # row 3 on a bf16 table besides
Y_ROW_CASE = ("relu_dir", "gaussian")  # the Gaussian instances' rows
Y_TRAIN_ARGS = ["--mode", "screen", "--layers", "32:32:32",
                "--activation", "ReLU", "--fouriercount", "14",
                "--outputmode", "density",
                "--volumetric_features_channels", "16",
                "--volumetric_features_resolution", "32",
                "--screen_size", str(WIDTH), "--stepsize", str(STEPSIZE),
                "--screen_cameras", "2", "-i", "3", "-o", "Adam",
                "-lr", "1e-3"]


def _get(url, timeout=300):
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body, headers = r.read(), dict(r.headers)
    return body, headers, (time.perf_counter() - t0) * 1e3


def last_modules(smi, reset_counts, counts):
    """Phase W, the last slice's modules on the card through their entry
    points: W1 the viewer serving JAX's main scene (MARSCHNER_LOBB, DVR at
    1/256) at 512^2 and a progressive MC evaluator at 128^2; W2
    ``eval_scaling --device cuda --devices 1 2`` at its defaults (ranks
    sharing the one card: no scaling figure); W3 the variant and meta
    networks at the JAX package's defaults, world-trained W_STEPS steps on
    MARSCHNER_LOBB, PLAIN32 at 128^2, card vs CPU; W4 ``cli.main`` on a
    256^3 float32 .xyz and a 256^3 UCHAR .dat (LZ4, 2 mipmaps) and
    ``warp_image``/``inpaint`` card vs CPU. No TPU kernel runs here; the
    counts show none launched. Returns the figures."""
    import urllib.error

    from fvsrn_tpu_torch import cli
    from fvsrn_tpu_torch.camera import CameraOnASphere
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.meta import MetaSceneNetwork
    from fvsrn_tpu_torch.models.variants import (ModulatedSineNetwork,
                                                 ResidualSineNetwork)
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    from fvsrn_tpu_torch.raytracer.evaluator import ImageEvaluatorSimple
    from fvsrn_tpu_torch.raytracer.montecarlo import RayEvaluationMonteCarlo
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.transfer import (TransferFunctionIdentity,
                                          TransferFunctionPiecewiseLinear)
    from fvsrn_tpu_torch.utils.imageops import inpaint, warp_image
    from fvsrn_tpu_torch.viewer import default_evaluator, serve
    from fvsrn_tpu_torch.volume.implicit import (VolumeInterpolationImplicit,
                                                 create_implicit_grid)
    from fvsrn_tpu_torch.volume.volume import Volume

    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    fig = {}
    reset_counts()

    # W1. the viewer on the card: the page, /meta, four 512^2 renders
    server = serve(default_evaluator("MARSCHNER_LOBB", stepsize=1 / 256,
                                     device=dev),
                   port=0, block=False, device=dev)
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        page, _, _ = _get(f"{base}/")
        meta = json.loads(_get(f"{base}/meta")[0])
        check(b"fvsrn_tpu viewer" in page and meta["progressive"] is False,
              f"phase W1: page or meta {meta}")
        pngs, ms = [], []
        for q in W_ORBITS:
            query = "&".join(f"{k}={v}" for k, v in dict(
                q, size=W_SIZE).items())
            png, _, t = _get(f"{base}/render?{query}")
            check(png[:8] == b"\x89PNG\r\n\x1a\n", f"phase W1: {query}")
            pngs.append(png)
            ms.append(t)
        check(pngs[0] != pngs[1] and pngs[0] != pngs[2],
              "phase W1: an orbit or an opacity change left the image")
        try:
            _get(f"{base}/render?size=-1")
            fail("phase W1: a bad request rendered")
        except urllib.error.HTTPError as e:
            check(e.code == 500 and "error" in json.loads(e.read()),
                  f"phase W1: a bad request answered {e.code}")
    finally:
        server.shutdown()
    fig["viewer_ms"] = ms
    mc = ImageEvaluatorSimple(
        camera=CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6),
        volume=VolumeInterpolationImplicit.make("SPHERE", device=dev),
        tf=TransferFunctionIdentity.make(absorption=8.0, emission=1.0),
        ray_config=RayEvaluationMonteCarlo.make(
            max_absorption=8.0, density_min=0.3, num_bounces=1,
            max_iterations=32),
        phase=PhaseFunctionHenyeyGreenstein.make(g=0.0), ray_mode="mc")
    server = serve(mc, port=0, block=False, device=dev)
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        check(json.loads(_get(f"{base}/meta")[0])["progressive"] is True,
              "phase W1: the MC evaluator is not progressive")
        frames, mc_ms = [], []
        for yaw in (0.5, 0.5, 2.0):
            png, h, t = _get(f"{base}/render?size={W_MC_SIZE}&pitch=0.3"
                             f"&yaw={yaw}&distance=1.6")
            check(png[:8] == b"\x89PNG\r\n\x1a\n", "phase W1: MC render")
            frames.append(h["X-Frames"])
            mc_ms.append(t)
        check(frames == ["1", "2", "1"], f"phase W1: X-Frames {frames}")
    finally:
        server.shutdown()
    fig["viewer_mc_ms"] = mc_ms
    print(f"phase W1 viewer [{smi}]: {W_SIZE}^2 renders "
          f"{', '.join(f'{t:.1f}' for t in ms)} ms a request (the first "
          f"with the warm-up); MC {W_MC_SIZE}^2 X-Frames {frames}, "
          f"{', '.join(f'{t:.1f}' for t in mc_ms)} ms", flush=True)

    # W2. the scaling harness, one nccl rank and two gloo ranks sharing
    # the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fvsrn_tpu_torch.eval.eval_scaling",
         "--device", "cuda", "--devices", "1", "2"], cwd=root,
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"phase W2: eval_scaling exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    scaling = json.loads(proc.stdout.strip().splitlines()[-1])
    check(sorted(scaling) == ["1", "2"]
          and all(r["rays_per_s"] > 0 for r in scaling.values())
          and scaling["2"].get("shared_device") is True
          and "shared_device" not in scaling["1"],
          f"phase W2: {scaling}")
    fig["scaling"] = scaling
    print(f"phase W2 eval_scaling [{smi}]: n=1 (nccl) "
          f"{scaling['1']['rays_per_s'] / 1e6:.3f} Mrays/s, n=2 (two gloo "
          f"ranks sharing the card, not a scaling figure) "
          f"{scaling['2']['rays_per_s'] / 1e6:.3f} Mrays/s, 256^2 h=1/64; "
          f"{time.perf_counter() - t0:.1f} s with the spawns", flush=True)

    # W3. the variant and meta networks: world training, PLAIN32, card vs
    # CPU, the fused paths refused
    target = VolumeInterpolationImplicit.make("MARSCHNER_LOBB", device=dev)
    rng = np.random.default_rng(19)
    latent = LatentSpace(ensemble_vector=torch.from_numpy(
        rng.random((1, 4, 3)).astype(np.float32)))
    nets = {"ResidualSine": (ResidualSineNetwork.make(), 2e-4),
            "ModulatedSine": (ModulatedSineNetwork.make(
                latent=copy.deepcopy(latent)), 1e-3),
            "Meta": (MetaSceneNetwork.make(latent=copy.deepcopy(latent)),
                     1e-3)}
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.1, 0.1, 0.8], [0.8, 0.3, 0.1], [1.0, 1.0, 0.6]],
        opacity=[0.0, 8.0, 25.0], positions=[0.0, 0.5, 1.0])
    cfg = RayEvaluationSteppingDvr.make(stepsize=1 / 256)
    cam = CameraOnASphere.make(pitch=0.35, yaw=0.6, distance=1.8)
    gen = torch.Generator(dev).manual_seed(0)
    fig["networks"] = {}
    for name, (net, lr) in nets.items():
        net = net.to(dev)
        opt, _ = make_optimizer(net.parameters(), "Adam", lr=lr,
                                lr_gamma=1.0)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(W_STEPS):
            x = torch.rand(W_BATCH, 3, device=dev, generator=gen)
            with torch.no_grad():
                want = target.eval_density(
                    target.box_min + x * target.box_size)[0][:, None]
            opt.zero_grad(set_to_none=True)
            loss = torch.mean(torch.abs(net(x, mode="world") - want))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / W_STEPS
        losses = [float(v) for v in losses]
        check(all(math.isfinite(v) for v in losses)
              and np.mean(losses[-10:]) < 0.9 * np.mean(losses[:10]),
              f"phase W3 {name}: losses {losses[:3]} ... {losses[-3:]}")
        model = LoadedModel(net, tf, cfg)
        render = model.prepare_network_render(cam, W_RENDER, W_RENDER,
                                              "PLAIN32", device=dev)
        img, plain_ms = cuda_once(render)
        check(tuple(img.shape) == (W_RENDER, W_RENDER, 4)
              and bool(torch.isfinite(img).all()),
              f"phase W3 {name}: PLAIN32 image")
        try:
            model.prepare_network_render(cam, W_RENDER, W_RENDER, "FUSED",
                                         device=dev)
            fail(f"phase W3 {name}: a FUSED render did not raise")
        except NotImplementedError as e:
            check(type(net).__name__ in str(e), f"phase W3 {name}: {e}")
        x = torch.rand(W_CPU_POSITIONS, 3, device=dev, generator=gen)
        e = torch.full((W_CPU_POSITIONS,), 1.5, device=dev)
        with torch.no_grad():
            got = net(x, ensemble=e, mode="world")
            want = copy.deepcopy(net).to(cpu)(x.cpu(), ensemble=e.cpu(),
                                              mode="world")
        err = float((got.cpu() - want).abs().max())
        check(err <= W_NET_TOL, f"phase W3 {name}: card vs CPU {err}")
        fig["networks"][name] = {
            "loss_first": losses[0], "loss_last": losses[-1],
            "step_ms": step_ms, "plain32_ms": plain_ms,
            "alpha_max": float(img[..., 3].max()), "card_vs_cpu": err}
        print(f"phase W3 {name} [{smi}]: {W_STEPS} world steps of "
              f"{W_BATCH} positions, L1 {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{step_ms:.2f} ms a step (host clock); PLAIN32 "
              f"{W_RENDER}^2 {plain_ms:.1f} ms, alpha max "
              f"{float(img[..., 3].max()):.3f}; FUSED refused; card vs "
              f"CPU {err:.2e}", flush=True)

    # W4. the converter on two 256^3 volumes, imageops card vs CPU
    grid = create_implicit_grid(W_GRID, "MARSCHNER_LOBB",
                                device=dev).cpu().numpy()     # [x, y, z]
    xyz = os.path.join(out_dir, f"mlobb{W_GRID}.xyz")
    with open(xyz, "wb") as f:
        f.write(np.asarray([W_GRID] * 3, np.uint32).tobytes())
        f.write(np.asarray([1.0] * 3, np.float64).tobytes())
        f.write(np.ascontiguousarray(grid).tobytes())     # z fastest
    u8 = np.round(np.clip(grid, 0, 1) * 255).astype(np.uint8)
    with open(os.path.join(out_dir, f"mlobb{W_GRID}.raw"), "wb") as f:
        f.write(np.ascontiguousarray(u8.transpose(2, 1, 0)).tobytes())
    dat = os.path.join(out_dir, f"mlobb{W_GRID}.dat")
    with open(dat, "w") as f:
        f.write(f"ObjectFileName: mlobb{W_GRID}.raw\nResolution: {W_GRID} "
                f"{W_GRID} {W_GRID}\nSliceThickness: 1 1 1\n"
                "Format: UCHAR\n")
    fig["cli"] = {}
    for src, data in ((xyz, grid), (dat, u8)):
        out = src[:-4] + "_lz4.cvol"
        t0 = time.perf_counter()
        check(cli.main([src, out, "--compression", "1", "--mipmaps",
                        "2"]) == 0, f"phase W4: cli on {src}")
        secs = time.perf_counter() - t0
        back = Volume.load(out).features[0].levels[0].data[..., 0]
        check(np.array_equal(back, data.transpose(2, 1, 0)),
              f"phase W4: {os.path.basename(out)} reloaded")
        mb_s = data.nbytes / secs / 1e6
        fig["cli"][os.path.basename(src)] = {
            "seconds": secs, "mb_s": mb_s, "bytes": os.path.getsize(out)}
        print(f"phase W4 cli: {os.path.basename(src)} ({data.nbytes / 2**20:.0f}"
              f" MiB) -> LZ4 .cvol with 2 mipmaps in {secs:.2f} s, "
              f"{mb_s:.1f} MB/s (host), {os.path.getsize(out) / 2**20:.1f} "
              f"MiB, reloaded equal", flush=True)
    g = torch.Generator().manual_seed(3)
    image = torch.rand(W_IMAGE, generator=g)
    flow = (torch.rand((2,) + W_IMAGE[1:], generator=g) - 0.5) * 9.0
    mask = (torch.rand(W_IMAGE[1:], generator=g) > 0.3).float()
    for name, fn, args in (("warp_image", warp_image, (image, flow)),
                           ("inpaint", inpaint, (image, mask))):
        want = fn(*args)
        dargs = [a.to(dev) for a in args]
        got, ms = cuda_once(lambda: fn(*dargs))
        ms = cuda_ms(lambda: fn(*dargs), 5)
        err = float((got.cpu() - want).abs().max())
        check(err <= W_IMAGE_TOL, f"phase W4 {name}: card vs CPU {err}")
        fig[name] = {"ms": ms, "card_vs_cpu": err}
        print(f"phase W4 {name} [{smi}]: {W_IMAGE} on the card "
              f"{ms:.3f} ms, card vs CPU {err:.2e}", flush=True)
    # the MC viewer's walk counts its tracking rounds; no kernel launched
    c = {k: v for k, v in counts().items()
         if k not in ("tracking_rounds", "normal_rounds",
                      "sample_eval_positions")}
    check(not any(c.values()), f"phase W: a TPU kernel launched {c}")
    return fig


def flip_share(plain_fn, args, kw, want):
    """The share of rays a preintegrating mode's kernel image may have off
    KERNEL_TOL: the larger of TF_FLIP_SHARE and NOISE_FLIP times the share
    its plain version moves off ``want`` when every weight moves by a
    seeded relative NOISE_EPS (one float32 ulp). The near branch and the
    nearest 2D cell flip on density noise of that size, and an
    ill-conditioned network (Sine:30: its 30x pre-activations) flips many
    more rays than phase N's flagship."""
    moved = copy.deepcopy(args[2])
    gen = torch.Generator(moved.layers[0].weight.device).manual_seed(0)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1.0 + NOISE_EPS * torch.randn(p.shape, device=p.device,
                                                 generator=gen))
    err = (plain_fn(*args[:2], moved, *args[3:], **kw) - want).abs().amax(
        dim=-1)
    return max(TF_FLIP_SHARE,
               NOISE_FLIP * float((err > KERNEL_TOL).float().mean()))


def any_tf(smi, reset_counts, counts, cam):
    """Phase X, the texture and preintegrated TFs on networks other than
    SnakeAlt without direction input: the flagship's widths (32:32:32, 14
    Fourier features, a 16x32^3 grid) as ReLU with direction input and as
    Sine:30, and a 64:64:64 ReLU network with direction input, each under
    texture, preint1d and preint2d, through
    ``LoadedModel.prepare_network_render(mode="FUSED")``: route 1 at
    512^2, 1/512 (``mega_fwd_anytf*``) and route 2 at 1920x1080
    (``segment_fwd_anytf``); each kernel against its plain version on 64
    whole tiles (every ray within KERNEL_TOL, the preintegrated modes a
    share of rays, ``flip_share``), and the first network's texture frames at
    full frame; each frame timed beside the same network's piecewise
    frame (``mega_fwd_any``) and the flagship's frame in the same mode
    (``mega_fwd_tf``). Returns the two rows of the kernels line."""
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    from fvsrn_tpu_torch.scenes import dense_scene, dense_tf_modes
    from fvsrn_tpu_torch.train.checkpoints import load_weights

    dev = torch.device(DEVICE)
    _, ramp, npz = dense_scene()
    modes = dense_tf_modes(STEPSIZE)
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    flagship = load_weights(npz).to(dev)
    grid = np.random.default_rng(23).standard_normal((16, 32, 32, 32)) * 0.3
    rows = {"mega_fwd_anytf": {}, "segment_fwd_anytf": {}}

    def subset(render, n_tile):
        """Whole tiles of ``n_tile`` rays spread over the frame (64 of
        them): the kernel and its plain version on the same rays."""
        n = render.ray_start.shape[0] // n_tile
        tiles = torch.arange(0, n, max(n // ORACLE_TILES, 1),
                             device=dev)[:ORACLE_TILES]
        sel = (tiles[:, None] * n_tile
               + torch.arange(n_tile, device=dev)).reshape(-1)
        kw = dict(render.march_kwargs)
        if render.route == "mega":
            kw["tmax_clip"] = render.tmax_clip[sel]
            if render.segment_active is not None:
                kw["segment_active"] = render.segment_active[tiles]
        args = (render.ray_start[sel].contiguous(),
                render.ray_dir[sel].contiguous(), render.network,
                render.box_min, render.box_size, render.tf.tensor)
        return args, kw

    def frame_ms(net, tf, w, h):
        r = LoadedModel(net, tf, cfg).prepare_network_render(cam, w, h,
                                                             "FUSED")
        return cuda_ms(r, 3)

    t_phase = time.perf_counter()
    snake_ms = {(m, size): frame_ms(flagship, modes[m], *size)
                for m in X_MODES
                for size in ((WIDTH, HEIGHT), (SEG_WIDTH, SEG_HEIGHT))}
    for name, kw in X_NETS.items():
        net = SceneRepresentationNetwork.make(
            num_fourier=14, output_mode="density", seed=11,
            latent=LatentSpace(static_grid=torch.tensor(
                grid, dtype=torch.float32)), **kw).to(dev)
        width = fused_mega.kernel_width(net)
        pw = {size: frame_ms(net, ramp, *size)
              for size in ((WIDTH, HEIGHT), (SEG_WIDTH, SEG_HEIGHT))}
        for mode in X_MODES:
            model = LoadedModel(net, modes[mode], cfg)
            for row, size, n_tile, plain_fn in (
                    ("mega_fwd_anytf", (WIDTH, HEIGHT), 256,
                     fused_mega.mega_trace_dvr_plain),
                    ("segment_fwd_anytf", (SEG_WIDTH, SEG_HEIGHT), 128,
                     fused_dvr.fused_trace_dvr_plain)):
                lib = (fused_mega.library_name(row, width)
                       if row.startswith("mega") else row)
                render = model.prepare_network_render(cam, *size, "FUSED")
                check(render.route == ("mega" if row.startswith("mega")
                                       else "segment"),
                      f"phase X {name} {mode}: route {render.route}")
                reset_counts()
                img = render()
                torch.cuda.synchronize()
                c = counts()
                libs = dict(fused_mega.LIBRARY_LAUNCHES)
                libs.update(fused_dvr.LIBRARY_LAUNCHES)
                want_n = 1 if row.startswith("mega") else 2
                check(libs == {lib: want_n}
                      and bool(torch.isfinite(img).all())
                      and float(img[..., 3].max()) > 0.5,
                      f"phase X {name} {mode} {row}: launches {libs}, "
                      f"counts {c}, alpha {float(img[..., 3].max())}")
                args, skw = subset(render, n_tile)
                kernel = fused_mega.mega_trace_dvr if row.startswith(
                    "mega") else fused_dvr.fused_trace_dvr
                want = plain_fn(*args, **skw)
                share = (flip_share(plain_fn, args, skw, want)
                         if mode in ("preint1d", "preint2d")
                         else TF_FLIP_SHARE)
                err, off = image_check(f"phase X {name} {row}",
                                       kernel(*args, **skw), want, mode,
                                       share)
                fig = {"launches": want_n, "max_abs_err": err,
                       "off_share": off, "off_bound": share,
                       "frame_ms": cuda_ms(render, 3),
                       "ms": cuda_ms(lambda: render.march(), 3),
                       "piecewise_frame_ms": pw[size],
                       "snakealt_frame_ms": snake_ms[(mode, size)]}
                if name == "relu_dir" and mode == "texture":
                    # the row's figures: the whole frame against its plain
                    # version, its samples and bound
                    plain, fig["plain_ms"] = cuda_once(
                        lambda: render.march(plain_fn))
                    got = render.march()
                    fig["frame_err"] = max_err(got, plain)
                    check(fig["frame_err"] <= KERNEL_TOL,
                          f"phase X {row}: whole frame vs plain "
                          f"{fig['frame_err']}")
                    if row.startswith("mega"):
                        n_s = int(render.march(return_samples=True)[1]
                                  .sum())
                    else:
                        n_s = int(render.march(return_stats=True)[1]
                                  .samples)
                    flops = n_s * (sample_flops(net) + TF_FLOPS[mode])
                    io_bytes = (render.ray_start.shape[0] * (6 + 1 + 4) * 4
                                + 16 * 32 ** 3 * 2)
                    fig["samples"] = n_s
                    fig["bound_ms"] = max(flops / PEAK_BF16_TC,
                                          io_bytes / PEAK_BYTES) * 1e3
                    fig["bound_by"] = ("operations" if flops / PEAK_BF16_TC
                                       > io_bytes / PEAK_BYTES else "bytes")
                rows[row][f"{name}:{mode}"] = fig
                print(f"phase X {name} {mode} {row} [{smi}]: {size[0]}x"
                      f"{size[1]} FUSED frame {fig['frame_ms']:.3f} ms "
                      f"(kernel {fig['ms']:.3f}; the same network's "
                      f"piecewise frame {pw[size]:.3f}, the flagship's "
                      f"{mode} frame {snake_ms[(mode, size)]:.3f}), "
                      f"launches {libs}, vs plain on {ORACLE_TILES} tiles "
                      f"max|d| {err:.3e} ({off:.2e} of rays > "
                      f"{KERNEL_TOL}, bound {share:.2e})", flush=True)
    print(f"phase X: {time.perf_counter() - t_phase:.1f} s", flush=True)
    out = []
    for row, src, replaces in (
            ("mega_fwd_anytf", "fvsrn_tpu_torch/csrc/mega_fwd_anytf.cu",
             "fvsrn_tpu/ops/fused_mega.py:274"),
            ("segment_fwd_anytf", "fvsrn_tpu_torch/csrc/segment_fwd_anytf.cu",
             "fvsrn_tpu/ops/fused_dvr.py:1626")):
        main = rows[row]["relu_dir:texture"]
        out.append({
            "name": row, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(f["launches"] for f in rows[row].values()),
            "max_abs_err": max(main["frame_err"], max(
                f["max_abs_err"] for k, f in rows[row].items()
                if not k.endswith(("preint1d", "preint2d")))),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "frame_ms": main["frame_ms"],
            "samples": main["samples"], "cases": rows[row],
            "ptxas": ptxas_summary(src.split("/")[-1][:-3])})
    return out


def tf_training(smi, reset_counts, counts, cam, tfm):
    """Phase Y, every TF mode on every network in training: phase X's
    networks (the flagship's widths as ReLU with direction input and as
    Sine:30, a 64:64:64 ReLU network with direction input) under the
    texture, 1D- and 2D-preintegrated TFs and four Gaussians, one
    differentiable step (mean(img^2)) on each engine at 512^2, 1/512:
    rows 2-3 on 256-ray tiles (``mega_fwd_anytf*`` or ``mega_fwd_anyg*``,
    ``mega_bwd*``) and rows 5-6 (``segment_fwd_anytf`` or
    ``segment_fwd_anyg``, ``segment_bwd``), the launches counted by
    library, each pair against its plain version on 64 whole tiles
    (phase N's bounds; Sine:30's in units of its plain version's own
    change under one ulp of weight noise, as phase O holds it), row 3
    once more on a bf16 table, each full-frame step timed beside the same
    network's piecewise step and the flagship's step in the same mode
    (phase N's, ``tfm``), and the Gaussian instances' differentiable
    forward alone at full frame (their rows of the kernels line); then
    ``train.main.run`` in screen mode on a scene JSON written to a
    temporary directory (phase M's voxelized MARSCHNER_LOBB, a
    ``Texture`` and then a ``Gaussian`` TF, a ReLU network): fused,
    through these libraries, loss falling. Returns ({row name: {case:
    figures}} for rows 2, 3, 5 and 6, the rows of ``mega_fwd_anyg`` and
    ``segment_fwd_anyg``)."""
    import tempfile

    from fvsrn_tpu_torch.camera import camera_matrix, generate_rays
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_tf_args)
    from fvsrn_tpu_torch.raytracer.dvr import max_steps_bound
    from fvsrn_tpu_torch.scenes import dense_scene, dense_tf_modes
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.volume.implicit import create_implicit_grid
    from fvsrn_tpu_torch.volume.volume import Volume

    dev = torch.device(DEVICE)
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    modes = dense_tf_modes(STEPSIZE)
    ramp = dense_scene()[1].tensor.to(dev)
    steps = max_steps_bound(box[1], STEPSIZE)
    rs, rd = generate_rays(camera_matrix(cam), WIDTH, HEIGHT,
                           cam.fov_y_radians, device=dev)
    rs = rs.reshape(-1, 3).contiguous()
    rd = rd.reshape(-1, 3).contiguous()
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    rs_b, rd_b = rs[perm].contiguous(), rd[perm].contiguous()
    grid = np.random.default_rng(23).standard_normal((16, 32, 32, 32)) * 0.3
    engines = (
        ("mega", ("mega_fwd_diff", "mega_bwd"), fused_mega.mega_trace_dvr,
         fused_mega.mega_trace_dvr_plain,
         dict(stepsize=STEPSIZE, differentiable=True), rs_b, rd_b),
        ("scan", ("segment_fwd_diff", "segment_bwd"),
         fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain,
         dict(stepsize=STEPSIZE, max_steps=steps, enable_early_out=False,
              differentiable=True), rs, rd))
    n_t = rs.shape[0] // 256
    sub = (torch.arange(0, n_t, n_t // ORACLE_TILES,
                        device=dev)[:ORACLE_TILES, None] * 256
           + torch.arange(256, device=dev)).reshape(-1)
    rows = {r: {} for r in ("mega_fwd_diff", "mega_bwd", "segment_fwd_diff",
                            "segment_bwd")}

    def noisy(net, eps):
        out = copy.deepcopy(net)
        gen = torch.Generator(dev).manual_seed(0)
        with torch.no_grad():
            for p in out.parameters():
                p.mul_(1.0 + eps * torch.randn(p.shape, device=dev,
                                               generator=gen))
        return out

    def library(engine, mode, width):
        kind = "anyg" if mode == "gaussian" else "anytf"
        if engine == "mega":
            return fused_mega.library_name(f"mega_fwd_{kind}", width)
        return f"segment_fwd_{kind}"

    def held(name, engine, mode, net, march, plain, kw, r_, d_, tensor,
             pre, grid_bf16=False):
        """The pair against its plain version on the 64 tiles: (image
        error, share off, worst leaf, its error, its bound)."""
        ill = name in Y_ILL
        args = (r_[sub].contiguous(), d_[sub].contiguous(), net, *box)
        img_k, g_k = tf_step(march, args, tensor, pre, kw)
        (img_p, g_p), pms = cuda_once(
            lambda: tf_step(plain, args, tensor, pre, kw))
        check(sorted(g_k) == sorted(g_p), f"phase Y {name} {mode} "
              f"{engine}: leaves {sorted(g_k)} vs {sorted(g_p)}")
        preint = mode in ("preint1d", "preint2d")
        tol = {n: GRAD_TOL for n in g_p}
        img_tol = KERNEL_TOL
        if ill or preint:
            eps, factor = ((NOISE_EPS, NOISE_FLIP) if ill
                           else (TF_FLIP_EPS, TF_FLIP_GRAD))
            img_q, g_q = tf_step(plain, (*args[:2], noisy(net, eps), *box),
                                 tensor, pre, kw)
            tol = {n: max(GRAD_TOL, factor * rel_err(g_q[n], g_p[n]))
                   if float(g_p[n].norm()) > 0 else GRAD_TOL for n in g_p}
            if ill:
                img_tol = max(KERNEL_TOL, NOISE_FLIP * float(
                    (img_q - img_p).abs().max()))
        if preint:
            share = flip_share(lambda *a, **k: plain(
                *a, **k).detach(), (*args, tensor), dict(kw, tf_pre=pre),
                img_p)
            ierr, off = image_check(f"phase Y {name} {engine}", img_k,
                                    img_p, mode, share)
        else:
            ierr = float((img_k - img_p).abs().max())
            off = float(((img_k - img_p).abs().amax(dim=-1)
                         > KERNEL_TOL).float().mean())
            check(ierr <= img_tol, f"phase Y {name} {mode} {engine}: image "
                  f"kernel vs plain {ierr} (tol {img_tol})")
        rel = {}
        for n in g_p:
            if float(g_p[n].norm()) == 0:
                rel[n] = float(g_k[n].norm())
                check(rel[n] == 0.0, f"phase Y {name} {mode} {engine}: "
                      f"{n} nonzero where plain is zero")
                continue
            if grid_bf16 and n == "latent.static_grid":
                ok, el, _ = bench_grid_check(g_k[n], g_p[n])
                check(ok, f"phase Y {name} {mode} {engine} bf16: grid per "
                      f"element {el}")
                rel[n] = 0.0
                continue
            rel[n] = rel_err(g_k[n], g_p[n])
        worst = max(rel, key=lambda n: rel[n] / tol[n])
        check(rel[worst] <= tol[worst],
              f"phase Y {name} {mode} {engine}: grad {worst} {rel[worst]} "
              f"(tol {tol[worst]})")
        return {"img_err": ierr, "img_tol": img_tol if not preint else None,
                "off_share": off, "grad_rel": rel[worst],
                "grad_worst": worst, "grad_tol": tol[worst],
                "plain_ms": pms}

    def forward_row(engine, lib, net, march, plain, mkw, r_, d_, tensor,
                    fig, launches):
        """The kernels line's row of the Gaussian instance ``lib``: its
        differentiable forward alone at full frame (storing the carries,
        no backward) against its plain version, timed, with its bound
        (the run's samples at the bf16 tensor cores' rate, or the rays,
        the table and the carries of the segments holding samples at the
        memory's)."""
        kw = dict(mkw, tf_mode="gaussian")
        stat = ({"return_samples": True} if engine == "mega"
                else {"return_stats": True})
        with torch.no_grad():
            got, st = march(r_, d_, net, *box, tensor, **kw, **stat)
            want, pms = cuda_once(lambda: plain(r_, d_, net, *box, tensor,
                                                **kw))
            ms = cuda_ms(lambda: march(r_, d_, net, *box, tensor, **kw), 5)
        err = max_err(got, want)
        check(err <= KERNEL_TOL, f"phase Y {lib}: the whole frame's "
              f"differentiable forward vs plain {err}")
        n_s = int(st.sum()) if engine == "mega" else int(st.samples)
        flops = n_s * (sample_flops(net) + TF_FLOPS["gaussian"])
        io_bytes = (r_.shape[0] * (7 + 4) * 4 + 16 * 32 ** 3 * 4
                    + n_s // 32 * 20)
        src = (f"fvsrn_tpu_torch/csrc/{lib}.cu" if engine == "mega"
               else "fvsrn_tpu_torch/csrc/segment_fwd_anyg.cu")
        return {"name": lib if engine == "scan" else "mega_fwd_anyg",
                "route": "cuda", "source": src,
                "replaces": ("fvsrn_tpu/ops/fused_mega.py:962"
                             if engine == "mega"
                             else "fvsrn_tpu/ops/fused_dvr_bwd.py:1144"),
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": pms,
                "bound_ms": max(flops / PEAK_BF16_TC,
                                io_bytes / PEAK_BYTES) * 1e3,
                "bound_by": ("operations" if flops / PEAK_BF16_TC
                             > io_bytes / PEAK_BYTES else "bytes"),
                "library_ms": None, "samples": n_s,
                "step_ms": fig["step_ms"], "step_grad_rel": fig["grad_rel"],
                "ptxas": ptxas_summary(src.split("/")[-1][:-3])}

    kernel_rows = {}
    t_phase = time.perf_counter()
    for name, nkw in X_NETS.items():
        net = SceneRepresentationNetwork.make(
            num_fourier=14, output_mode="density", seed=11,
            latent=LatentSpace(static_grid=torch.tensor(
                grid, dtype=torch.float32)), **nkw).to(dev)
        width = fused_mega.kernel_width(net)
        pw = {engine: cuda_ms(lambda: tf_step(
            march, (r_, d_, net, *box), ramp, None, mkw), 1)
            for engine, _, march, _, mkw, r_, d_ in engines}
        for mode in Y_MODES:
            tensor, tf_kw = fused_tf_args(modes[mode].to(dev))
            pre = tf_kw.pop("tf_pre", None)
            for engine, keys, march, plain, mkw, r_, d_ in engines:
                kw = dict(mkw, **tf_kw)
                lib = library(engine, mode, width)
                # Y1. one full-frame step, its launches by library
                reset_counts()
                img, _ = tf_step(march, (r_, d_, net, *box), tensor, pre, kw)
                torch.cuda.synchronize()
                ck = counts()
                libs = dict(fused_mega.LIBRARY_LAUNCHES)
                libs.update(fused_dvr.LIBRARY_LAUNCHES)
                check(libs == {lib: 1} and ck[keys[0]] == 1
                      and ck[keys[1]] == 1
                      and bool(torch.isfinite(img).all())
                      and float(img[:, 3].max()) > 0.5,
                      f"phase Y {name} {mode} {engine}: launches {libs}, "
                      f"counts {ck}, alpha {float(img[:, 3].max())}")
                # Y2. kernel vs plain on 64 whole tiles
                fig = held(name, engine, mode, net, march, plain, kw, r_, d_,
                           tensor, pre)
                if engine == "mega" and (name, mode) == Y_BF16:
                    fig["bf16_table"] = held(
                        name, engine, mode, net, march, plain,
                        dict(kw, table_dtype=torch.bfloat16), r_, d_, tensor,
                        pre, grid_bf16=True)
                # Y3. the full-frame step timed once (Y1's step warmed it)
                _, fig["step_ms"] = cuda_once(lambda: tf_step(
                    march, (r_, d_, net, *box), tensor, pre, kw))
                fig["piecewise_step_ms"] = pw[engine]
                fig["flagship_step_ms"] = tfm[mode][f"{engine}_step_ms"]
                fig["library"] = lib
                fig["launches"] = [libs.get(lib, 0), ck[keys[1]]]
                if (name, mode) == Y_ROW_CASE:
                    kernel_rows[engine] = forward_row(
                        engine, lib, net, march, plain, mkw, r_, d_, tensor,
                        fig, libs.get(lib, 0))
                for row in keys:
                    rows[row][f"{name}:{mode}"] = fig
                print(f"phase Y {name} {mode} {engine} [{smi}]: step "
                      f"{fig['step_ms']:.3f} ms (the network's piecewise "
                      f"{pw[engine]:.3f}, the flagship's {mode} "
                      f"{fig['flagship_step_ms']:.3f}), launches {libs} + "
                      f"{keys[1]} {ck[keys[1]]}; on {ORACLE_TILES} tiles vs "
                      f"plain image {fig['img_err']:.3e} "
                      f"({fig['off_share']:.2e} of rays > {KERNEL_TOL}), "
                      f"grad rel {fig['grad_rel']:.2e} ({fig['grad_worst']}, "
                      f"tol {fig['grad_tol']:.2e}), plain step "
                      f"{fig['plain_ms']:.0f} ms"
                      + (f"; bf16 table grad rel "
                         f"{fig['bf16_table']['grad_rel']:.2e} "
                         f"({fig['bf16_table']['grad_worst']})"
                         if "bf16_table" in fig else ""), flush=True)
    print(f"phase Y steps: {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # Y4. the trainer's entry point on a scene JSON: phase M's volume, a
    # texture TF and then the Gaussians, a ReLU network (the trainer has
    # no direction option, as JAX's has none)
    tex = modes["texture"].tensor
    tfs = {"Texture": {
        "absorptionScaling": 1.0,
        "colorPoints": [[(i + 0.5) / tex.shape[0], *tex[i, :3].tolist()]
                        for i in range(tex.shape[0])],
        "opacityPoints": tex[:, 3].tolist()},
        "Gaussian": {"absorptionScaling": 1.0,
                     "points": modes["gaussian"].tensor.tolist()}}
    trainer = {}
    with tempfile.TemporaryDirectory() as tmp:
        vol = Volume(world_size=(1.0, 1.0, 1.0))
        vol.add_feature("density", create_implicit_grid(
            GRID_RES, "MARSCHNER_LOBB", device=dev).cpu().numpy())
        vol.save(os.path.join(tmp, f"mlobb{GRID_RES}.cvol"), compression=1)
        for kind, lib in (("Texture", "mega_fwd_anytf"),
                          ("Gaussian", "mega_fwd_anyg")):
            scene = os.path.join(tmp, f"mlobb_{kind.lower()}.json")
            with open(scene, "w") as f:
                json.dump({
                    "ImageEvaluator": {"Simple": {
                        "selectedCamera": "Sphere",
                        "selectedRayEvaluator": "DVR",
                        "selectedVolume": "Grid"}},
                    "RayEvaluation": {"DVR": {"stepsize": STEPSIZE,
                                              "selectedTF": kind}},
                    "camera": {"Sphere": dict(CAMERA)},
                    "tf": {kind: tfs[kind]},
                    "volume": {"Grid": {
                        "source": "VOLUME", "interpolation": "TRILINEAR",
                        "volumePath": f"mlobb{GRID_RES}.cvol"}}}, f)
            opt = vars(train_main.init_parser().parse_args(
                [scene, os.path.join(tmp, f"{kind}.npz")] + Y_TRAIN_ARGS))
            reset_counts()
            t0 = time.perf_counter()
            result = train_main.run(opt)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            c = counts()
            n_lib = fused_mega.LIBRARY_LAUNCHES[lib]
            hist = result["history"]
            n_steps = opt["screen_cameras"] * opt["epochs"]
            print(f"phase Y trainer {kind} [{smi}]: train.main.run screen on "
                  f"a {GRID_RES}^3 .cvol scene, ReLU 32:32:32, {WIDTH}x"
                  f"{HEIGHT}, {n_steps} steps in {train_s:.1f} s (dataset "
                  f"included), fused {result['fused']}, losses {hist}, "
                  f"{lib} {n_lib}, launches {c}", flush=True)
            check(result["fused"] and n_lib >= n_steps
                  and c["mega_bwd"] >= n_steps
                  and all(math.isfinite(v) for v in hist)
                  and hist[-1] < hist[0],
                  f"phase Y trainer {kind}: fused {result['fused']}, "
                  f"{lib} {n_lib}, launches {c}, losses {hist}")
            trainer[kind] = {"fused": result["fused"], "losses": hist,
                             "library_launches": n_lib,
                             "mega_bwd": c["mega_bwd"], "seconds": train_s}
    for row in ("mega_fwd_diff", "mega_bwd"):
        rows[row]["trainer"] = trainer
    print(f"phase Y: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, [kernel_rows["mega"], kernel_rows["scan"]]


# phase Z: Table 1's wide networks on rows 1-7 (the width-128 instances,
# csrc/*128.cu: hidden matrices read from device memory). The flagship's
# inputs (SnakeAlt:2, 14 Fourier features, a 16x32^3 grid, density:direct,
# the ramp TF) at hidden layers 128:128:128, trained by the trainer as
# phase O trains 64:64:64 (2 cameras, 1 epoch at NET_SIZE^2: cut in depth),
# then timed at full size; a mixed 64:32 network (the 64 instance; rows 1,
# 4 and 7: training takes one width) and a 96:96:96 ReLU network with
# direction input (padded to 128; rows 1-7), random and seeded, held
# against the plain versions on 64 whole tiles.
# seed 3: at the trainer's default seed the 128-wide density:direct head
# starts below 0 at every position (nothing renders, and its clip passes
# no gradient, so nothing trains); at seed 3 it starts at 0-0.10, as the
# 64-wide network does at the default
Z_TRAIN_ARGS = [("128:128:128" if a == "64:64:64" else a)
                for a in NET_TRAIN_ARGS] + ["--seed", "3"]
Z_MODE = "texture"                   # the steps' TF mode besides piecewise
Z_POSITIONS = 1 << 20                # row 7 timed
Z_HELD = ORACLE_TILES * 256          # rays (positions) held against plain
Z_NETS = {
    "64:32": ((1, 4, 7), dict(layers="64:32")),
    "96:96:96 ReLU dir": ((1, 2, 3, 4, 5, 6, 7), dict(
        layers="96:96:96", activation="ReLU", use_direction=True,
        disable_direction_in_fourier=False)),
}
Z_LIBS = ("mega_fwd128", "mega_bwd128", "segment_fwd128", "segment_bwd128",
          "sample_eval128")


def wide_networks(smi, reset_counts, counts, cam):
    """Phase Z, Table 1's wide networks through the width-128 instances:
    ``train.main.run --mode screen --layers 128:128:128`` (rows 2-3,
    launches by library); then the trained network's main path with the
    counts reset (the FUSED render at 512^2, 1/512 on route 1, culled
    under a zero band to the network's median density, route 2 at
    1920x1080, one training step on
    each engine, row 7 at 2^20 positions), each kernel timed at full size
    (rows 2-3 and 5-6 alone, a step on each engine in the piecewise and
    the texture TF), every kernel against its plain version on 64 whole
    tiles (image, every gradient leaf); the mixed 64:32 network on rows 1,
    4 and 7 and the 96:96:96 ReLU network with direction input on rows
    1-7 the same way; every wide instance's registers and spills. Returns
    the kernels line's rows of the width-128 libraries and the trained
    network."""
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops import (_build, fused_dvr, fused_dvr_bwd,
                                     fused_eval, fused_mega)
    from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                               fused_tf_args)
    from fvsrn_tpu_torch.ops.fused_dvr_bwd import launch_segment_bwd
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound)
    from fvsrn_tpu_torch.scenes import dense_scene, dense_tf_modes
    from fvsrn_tpu_torch.train import main as train_main
    from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear

    dev = torch.device(DEVICE)
    root = os.path.dirname(os.path.abspath(__file__))
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    ramp_tf = dense_scene()[1]
    ramp = ramp_tf.tensor.to(dev)
    tex, tex_kw = fused_tf_args(dense_tf_modes(STEPSIZE)[Z_MODE].to(dev))
    tex_pre = tex_kw.pop("tf_pre", None)
    steps_max = max_steps_bound(box[1], STEPSIZE)
    t_phase = time.perf_counter()

    def libs():
        out = {}
        for c in (fused_mega.LIBRARY_LAUNCHES, fused_dvr.LIBRARY_LAUNCHES,
                  fused_mega.BWD_LIBRARY_LAUNCHES,
                  fused_dvr_bwd.LIBRARY_LAUNCHES,
                  fused_eval.LIBRARY_LAUNCHES):
            out.update({k: v for k, v in c.items() if v})
        return out

    # Z1. the trainer on 128:128:128 (rows 2-3 through mega_fwd128 and
    # mega_bwd128)
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    opt = vars(train_main.init_parser().parse_args(
        Z_TRAIN_ARGS[:1] + [os.path.join(out_dir, "net128_run.npz")]
        + Z_TRAIN_ARGS[1:]))
    n_steps = opt["screen_cameras"] * opt["epochs"]
    reset_counts()
    t0 = time.perf_counter()
    result = train_main.run(opt)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer_libs = libs()
    hist = result["history"]
    print(f"phase Z1 trainer: 128:128:128 SnakeAlt:2, 16x32^3, "
          f"train.main.run screen {NET_SIZE}x{NET_SIZE}, {n_steps} steps in "
          f"{train_s:.1f} s, fused {result['fused']}, losses {hist}, "
          f"launches by library {trainer_libs}", flush=True)
    check(result["fused"] and all(math.isfinite(v) for v in hist)
          and trainer_libs.get("mega_fwd128", 0) >= n_steps
          and trainer_libs.get("mega_bwd128", 0) >= n_steps,
          f"phase Z1: fused {result['fused']}, losses {hist}, "
          f"{trainer_libs}")
    trained = result["network"].to(dev)

    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    rs_b, rd_b = rs[perm].contiguous(), rd[perm].contiguous()
    n_t = rs.shape[0] // 256
    sub = (torch.arange(0, n_t, n_t // ORACLE_TILES,
                        device=dev)[:ORACLE_TILES, None] * 256
           + torch.arange(256, device=dev)).reshape(-1)
    mkw = dict(stepsize=STEPSIZE, differentiable=True)
    skw = dict(stepsize=STEPSIZE, max_steps=steps_max,
               enable_early_out=False, differentiable=True)
    engines = {"mega": (fused_mega.mega_trace_dvr,
                        fused_mega.mega_trace_dvr_plain, mkw, rs_b, rd_b),
               "scan": (fused_dvr.fused_trace_dvr,
                        fused_dvr.fused_trace_dvr_plain, skw, rs, rd)}
    gen = torch.Generator(dev).manual_seed(5)
    pos = torch.rand(Z_POSITIONS, 3, device=dev, generator=gen) - 0.5

    def subset(render, n_tile):
        """The render's march on 64 whole tiles spread over the frame."""
        n = render.ray_start.shape[0] // n_tile
        tiles = torch.arange(0, n, max(n // ORACLE_TILES, 1),
                             device=dev)[:ORACLE_TILES]
        sel = (tiles[:, None] * n_tile
               + torch.arange(n_tile, device=dev)).reshape(-1)
        kw = dict(render.march_kwargs)
        if render.route == "mega":
            kw["tmax_clip"] = render.tmax_clip[sel]
            if render.segment_active is not None:
                kw["segment_active"] = render.segment_active[tiles]
        return (render.ray_start[sel].contiguous(),
                render.ray_dir[sel].contiguous(), render.network,
                render.box_min, render.box_size, render.tf.tensor), kw

    def held_render(name, render, n_tile):
        """(error, kernel ms, plain ms) of the render's kernel against its
        plain version on 64 tiles."""
        args, kw = subset(render, n_tile)
        kernel, plain = ((fused_mega.mega_trace_dvr,
                          fused_mega.mega_trace_dvr_plain)
                         if render.route == "mega" else
                         (fused_dvr.fused_trace_dvr,
                          fused_dvr.fused_trace_dvr_plain))
        got, kms = cuda_once(lambda: kernel(*args, **kw))
        want, pms = cuda_once(lambda: plain(*args, **kw))
        err = max_err(got, want)
        check(err <= KERNEL_TOL and float(want[:, 3].max()) > 0.05,
              f"phase Z {name} route {render.route}: kernel vs plain {err}, "
              f"alpha {float(want[:, 3].max())}")
        return err, kms, pms

    def held_step(name, engine, net, tensor, pre, kw):
        """(image error, worst leaf's relative error, the leaf, kernel ms,
        plain ms) of one differentiable step (mean(img^2)) against the
        plain pair on 64 tiles."""
        march, plain, _, r_, d_ = engines[engine]
        args = (r_[sub].contiguous(), d_[sub].contiguous(), net, *box)
        (img_k, g_k), kms = cuda_once(lambda: tf_step(march, args, tensor,
                                                      pre, kw))
        (img_p, g_p), pms = cuda_once(lambda: tf_step(plain, args, tensor,
                                                      pre, kw))
        ierr = max_err(img_k, img_p)
        check(sorted(g_k) == sorted(g_p) and ierr <= KERNEL_TOL
              and float(img_p[:, 3].max()) > 0.05,
              f"phase Z {name} {engine}: image vs plain {ierr}, leaves "
              f"{sorted(g_k)} vs {sorted(g_p)}")
        rel = {}
        for n in g_p:
            check(float(g_p[n].norm()) > 0, f"phase Z {name} {engine}: "
                  f"zero gradient {n}")
            rel[n] = rel_err(g_k[n], g_p[n])
        worst = max(rel, key=rel.get)
        check(rel[worst] <= GRAD_TOL, f"phase Z {name} {engine}: grad "
              f"{worst} {rel[worst]} (tol {GRAD_TOL})")
        return ierr, rel[worst], worst, kms, pms

    def held_eval(name, net):
        """(error, kernel ms, plain ms) of row 7's values on Z_HELD
        positions against its plain version."""
        ev = fused_eval.make_fused_eval(net, *box)
        p = pos[:Z_HELD].contiguous()
        (got, _), kms = cuda_once(lambda: ev(p))
        (want, _), pms = cuda_once(lambda: fused_eval.fused_eval_plain(
            net, p + 0.5, None))
        err = max_err(got, want)
        check(err <= KERNEL_TOL, f"phase Z {name}: row 7 vs plain {err}")
        return err, kms, pms

    # Z2. the main path of the trained network, counts reset: rows 1 (and
    # culled), 4, 2-3 and 5-6 (a piecewise step each), 7. The culled
    # render's TF: the ramp with a zero band up to the network's median
    # density (the sparse scene's band lies above this briefly trained
    # network's densities, which would cull every sample)
    model = LoadedModel(trained, ramp_tf, config=cfg)
    tnet = copy.deepcopy(trained)
    ev = fused_eval.make_fused_eval(trained, *box)
    band = min(max(float(ev(pos[:Z_HELD])[0].median()), 1e-3), 0.5)
    sparse_tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.1, 0.1, 0.8], [0.1, 0.1, 0.8], [0.9, 0.4, 0.1],
             [1.0, 1.0, 0.6]],
        opacity=[0.0, 0.0, 10.0, 30.0],
        positions=[0.0, band, band + 0.1, 1.0])
    reset_counts()
    render = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
    img = render()
    culled = LoadedModel(trained, sparse_tf, config=cfg) \
        .prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
    img_c = culled()
    screen = model.prepare_network_render(cam, SEG_WIDTH, SEG_HEIGHT,
                                          "FUSED")
    img_s = screen()
    for engine, (march, _, kw, r_, d_) in engines.items():
        tf_step(march, (r_, d_, tnet, *box), ramp, None, kw)
    values, _ = ev(pos)
    torch.cuda.synchronize()
    launched, c_z = libs(), counts()
    print(f"phase Z2 main path (128:128:128): launches by library "
          f"{launched}, counts {c_z}", flush=True)
    check(render.route == "mega" and culled.route == "mega"
          and culled.segment_active is not None
          and screen.route == "segment",
          f"phase Z2: routes {render.route} {culled.route} {screen.route}")
    check(all(launched.get(lib, 0) >= 1 for lib in Z_LIBS),
          f"phase Z2: launches {launched}")
    for name, im in (("render", img), ("culled", img_c), ("route 2", img_s)):
        check(bool(torch.isfinite(im).all()) and float(im[..., 3].max())
              > 0.05, f"phase Z2 {name}: alpha {float(im[..., 3].max())}")
    check(bool(torch.isfinite(values).all()), "phase Z2: row 7 values")

    # Z3. the trained network at full size, timed; each kernel vs plain on
    # 64 tiles
    z = {"trainer": {"seconds": train_s, "losses": hist,
                     "launches": trainer_libs},
         "main_path_launches": launched}
    n_s1 = int(render.march(return_samples=True)[1].sum())
    (_, st4), ms4 = cuda_once(lambda: screen.march(return_stats=True))
    n_s4 = int(st4.samples)
    flops1 = n_s1 * sample_flops(trained)
    io1 = WIDTH * HEIGHT * (6 + 1 + 4) * 4 + 16 * 32 ** 3 * 2
    flops4 = n_s4 * sample_flops(trained)
    io4 = SEG_WIDTH * SEG_HEIGHT * (6 + 1 + 4) * 4 + 16 * 32 ** 3 * 2
    mask = culled.segment_active
    z["row1"] = {
        "frame_ms": cuda_ms(render, 3), "ms": cuda_ms(render.march, 3),
        "samples": n_s1, "flops": flops1, "io_bytes": io1,
        "culled_frame_ms": cuda_ms(culled, 3),
        "culled_ms": cuda_ms(culled.march, 3),
        "culled_samples": int(culled.march(return_samples=True)[1].sum()),
        "culled_share": 1.0 - float(mask.float().mean()),
        "zero_band": band}
    (z["row1"]["err"], z["row1"]["ms_64"],
     z["row1"]["plain_ms_64"]) = held_render("128 render", render, 256)
    z["row1"]["culled_err"] = held_render("128 culled", culled, 256)[0]
    z["row4"] = {"frame_ms": cuda_once(screen)[1], "ms": ms4,
                 "samples": n_s4,
                 "flops": flops4, "io_bytes": io4}
    (z["row4"]["err"], z["row4"]["ms_64"],
     z["row4"]["plain_ms_64"]) = held_render("128 route 2", screen, 128)
    z["row7"] = {"ms": cuda_ms(lambda: ev(pos), 5),
                 "positions": Z_POSITIONS,
                 "flops": Z_POSITIONS * sample_flops(trained, False),
                 "io_bytes": Z_POSITIONS * 16 + 16 * 32 ** 3 * 4}
    (z["row7"]["err"], z["row7"]["ms_64"],
     z["row7"]["plain_ms_64"]) = held_eval("128", trained)
    # the steps on each engine, piecewise and texture, timed once warm
    for engine, (march, _, kw, r_, d_) in engines.items():
        for mode, tensor, pre, mkw_ in (("piecewise", ramp, None, kw),
                                        (Z_MODE, tex, tex_pre,
                                         dict(kw, **tex_kw))):
            # the held step (64 tiles) warms the full frame's
            ierr, grel, worst, kms, pms = held_step(
                f"128 {mode}", engine, trained, tensor, pre, mkw_)
            _, ms = cuda_once(lambda: tf_step(march, (r_, d_, tnet, *box),
                                              tensor, pre, mkw_))
            z[f"{engine}_{mode}"] = {
                "step_ms": ms, "img_err": ierr, "grad_rel": grel,
                "grad_worst": worst, "step_ms_64": kms,
                "plain_step_ms_64": pms}
    # rows 2-3 and 5-6 alone at full frame (piecewise), their work
    spec = fused_mega._spec(trained, *box, stepsize=STEPSIZE, seg=32,
                            tile=256, density_min=0.0, density_max=1.0,
                            enable_early_out=True)
    rays = fused_mega.ray_packet(rs_b, rd_b, *box, STEPSIZE)
    params = fused_mega._params(trained, ramp)
    widths = fused_mega._widths(params)
    weights = fused_mega._pack_weights(params, spec)
    table = fused_mega._kernel_table(params[2], torch.float32, dev)
    n_seg = fused_mega.segments_needed(rays, spec)
    fwd = fused_mega._launch_fwd(rays, weights, table, spec, *widths[:3],
                                 n_seg_max=n_seg)
    d_out = 2.0 * fwd[0] / fwd[0].numel()
    z["row2"] = {"ms": cuda_once(lambda: fused_mega._launch_fwd(
        rays, weights, table, spec, *widths[:3], n_seg_max=n_seg))[1],
        "samples": int(fwd[1].sum())}
    bwd, z["row3"] = cuda_once(lambda: fused_mega._launch_bwd(
        rays, weights, table, fwd[2], fwd[3], d_out, spec, *widths))
    z["row3"] = {"ms": z["row3"]}
    work = bwd[2].sum(dim=0)
    z["row3"]["samples_replayed"] = int(work[0])
    z["row3"]["samples_contributing"] = int(work[1])
    sspec, srays, kbase = fused_dvr._segment_setup(
        rs, rd, trained, *box, density_min=0.0, density_max=1.0,
        blend_mode="beer_lambert", alpha_early_out=0.999, seg=32, tile=256,
        differentiable=True, latent_mode="table", table_dtype=torch.float32,
        n_seg=None, need_normals=False, iso_value=None, tf_mode="piecewise",
        tmax_clip=None, stepsize=STEPSIZE, max_steps=steps_max,
        enable_early_out=False)
    sweights = fused_dvr.pack_segment_weights(trained, ramp)
    stable = fused_dvr.segment_table(trained, torch.float32, dev)
    fwd_args = (sspec, trained, srays, kbase, sweights, stable,
                ramp.shape[0])
    out, st, carries, death = fused_dvr.launch_segment(*fwd_args,
                                                       store_carries=True)
    bwd_args = (sspec, trained, srays, kbase, sweights, stable, carries,
                death, 2.0 * out / out.numel(), ramp.shape[0])
    z["row5"] = {"ms": cuda_once(lambda: fused_dvr.launch_segment(
        *fwd_args, store_carries=True))[1], "samples": int(st.samples),
        "carry_bytes": int(death.sum()) * 16}
    sbwd, ms6 = cuda_once(lambda: launch_segment_bwd(*bwd_args))
    z["row6"] = {"ms": ms6}
    swork = sbwd[2]
    z["row6"]["samples_replayed"] = int(swork[0])
    z["row6"]["samples_contributing"] = int(swork[1])
    # the adjoint's weights read from L2: each 16-row block of a tile reads
    # every hidden matrix a few times (replay, adjoint forward, transposed
    # product), 4 KB a sample and matrix a read (the forward's once)
    l2 = 4 * 128 * 128 // 16 * (len(trained.layers) - 2)
    z["l2_bytes_per_sample_fwd"] = l2
    print(f"phase Z3 128:128:128 [{smi}]: FUSED {WIDTH}x{HEIGHT} frame "
          f"{z['row1']['frame_ms']:.3f} ms, kernel {z['row1']['ms']:.3f} ms "
          f"({n_s1} samples, {z['row1']['ms'] * 1e6 / max(n_s1, 1):.3f} ns a "
          f"sample, bound shares bf16 "
          f"{flops1 / PEAK_BF16_TC * 1e3 / z['row1']['ms']:.4f} / f32 "
          f"{flops1 / PEAK_F32 * 1e3 / z['row1']['ms']:.4f}), vs plain on "
          f"{ORACLE_TILES} tiles {z['row1']['err']:.2e}; culled frame "
          f"{z['row1']['culled_frame_ms']:.3f} ms "
          f"({z['row1']['culled_share']:.3f} of programs culled, vs plain "
          f"{z['row1']['culled_err']:.2e}); "
          f"route 2 {SEG_WIDTH}x{SEG_HEIGHT} frame "
          f"{z['row4']['frame_ms']:.3f} ms, kernel {z['row4']['ms']:.3f} ms "
          f"({n_s4} samples, {z['row4']['ms'] * 1e6 / max(n_s4, 1):.3f} ns), "
          f"vs plain {z['row4']['err']:.2e}; row 7 {Z_POSITIONS} positions "
          f"{z['row7']['ms']:.4f} ms "
          f"({z['row7']['ms'] * 1e6 / Z_POSITIONS:.3f} ns), vs plain "
          f"{z['row7']['err']:.2e}; rows 2/3/5/6 alone "
          f"{z['row2']['ms']:.3f} / {z['row3']['ms']:.3f} / "
          f"{z['row5']['ms']:.3f} / {z['row6']['ms']:.3f} ms; steps "
          + ", ".join(f"{k} {z[k]['step_ms']:.1f} ms (grad rel "
                      f"{z[k]['grad_rel']:.2e} {z[k]['grad_worst']}, image "
                      f"{z[k]['img_err']:.2e})"
                      for k in z if k.startswith(("mega_", "scan_"))),
          flush=True)

    # Z4. the mixed 64:32 network and the 96:96:96 ReLU network with
    # direction input, against the plain versions on 64 tiles
    grid = np.random.default_rng(23).standard_normal((16, 32, 32, 32)) * 0.3
    for name, (rows_, kw) in Z_NETS.items():
        net = SceneRepresentationNetwork.make(
            num_fourier=14, output_mode="density", seed=11,
            latent=LatentSpace(static_grid=torch.tensor(
                grid, dtype=torch.float32)), **kw).to(dev)
        m = LoadedModel(net, ramp_tf, config=cfg)
        fig = {"kernel_width": fused_mega.kernel_width(net)}
        reset_counts()
        r1 = m.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
        r4 = m.prepare_network_render(cam, SEG_WIDTH, SEG_HEIGHT, "FUSED")
        fig["row1_err"], fig["row1_ms_64"], _ = held_render(name, r1, 256)
        fig["row4_err"], fig["row4_ms_64"], _ = held_render(name, r4, 128)
        fig["row7_err"], fig["row7_ms_64"], _ = held_eval(name, net)
        if 2 in rows_:
            for engine in engines:
                (fig[f"{engine}_img_err"], fig[f"{engine}_grad_rel"],
                 fig[f"{engine}_grad_worst"], _, _) = held_step(
                    name, engine, net, ramp, None, engines[engine][2])
        torch.cuda.synchronize()
        fig["launches"] = libs()
        print(f"phase Z4 {name} [{smi}]: padded to {fig['kernel_width']}, "
              f"launches {fig['launches']}, vs plain on {ORACLE_TILES} "
              f"tiles: " + ", ".join(f"{k} {v:.2e}" for k, v in fig.items()
                                     if k.endswith(("_err", "_rel"))),
              flush=True)
        z[name] = fig
    check(z["64:32"]["launches"].get("mega_fwd64", 0) >= 1
          and z["64:32"]["launches"].get("segment_fwd", 0) >= 1
          and z["64:32"]["launches"].get("sample_eval", 0) >= 1,
          f"phase Z4 64:32: launches {z['64:32']['launches']}")
    wide = z["96:96:96 ReLU dir"]["launches"]
    check(all(wide.get(lib, 0) >= 1 for lib in
              ("mega_fwd_any128",) + Z_LIBS[1:]),
          f"phase Z4 96:96:96: launches {wide}")

    # Z5. registers and spills of every wide instance
    ptxas = {}
    for src in _build.WIDE_SOURCES:
        ptxas[src] = {k: list(v[:3]) for k, v in _build.ptxas_instances(
            _build.ptxas_report(src)).items()}
        spills = max((v[1] + v[2] for v in ptxas[src].values()), default=0)
        regs = sorted({v[0] for v in ptxas[src].values()})
        print(f"phase Z5 ptxas {src}: {len(ptxas[src])} instances, "
              f"registers {regs}, largest spill stores + loads {spills} B",
              flush=True)
    print(f"phase Z: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # the kernels line's rows: each library's main-path launches, its time
    # at full size beside its bound; the plain version's time on 64 tiles
    # (the full frame's plain backward takes minutes at this width)
    def row(name, src, replaces, n, ms, flops, nbytes, err, plain_ms, **kw):
        return dict({
            "name": name, "route": "cuda",
            "source": f"fvsrn_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flops / PEAK_BF16_TC, nbytes / PEAK_BYTES) * 1e3,
            "bound_by": ("operations" if flops / PEAK_BF16_TC
                         > nbytes / PEAK_BYTES else "bytes"),
            "library_ms": None,
            "bound_f32_ms": max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3,
            "plain_rays": Z_HELD, "ptxas": ptxas[src]}, **kw)

    fa = sample_flops(trained)
    bwd3 = (z["row3"]["samples_replayed"] * fa
            + z["row3"]["samples_contributing"] * adjoint_flops(trained))
    bwd6 = (z["row6"]["samples_replayed"] * fa
            + z["row6"]["samples_contributing"] * adjoint_flops(trained))
    wbytes = weights.numel() * 4
    mega_step, scan_step = z["mega_piecewise"], z["scan_piecewise"]
    return trained, [
        row("mega_fwd128", "mega_fwd128", "fvsrn_tpu/ops/fused_mega.py:274",
            c_z["mega_fwd"], z["row1"]["ms"], flops1, io1,
            z["row1"]["err"], z["row1"]["plain_ms_64"], cases=z),
        row("mega_fwd128_diff", "mega_fwd128",
            "fvsrn_tpu/ops/fused_mega.py:962", c_z["mega_fwd_diff"],
            z["row2"]["ms"], z["row2"]["samples"] * fa,
            WIDTH * HEIGHT * 48 + wbytes, mega_step["img_err"],
            mega_step["plain_step_ms_64"]),
        row("mega_bwd128", "mega_bwd128", "fvsrn_tpu/ops/fused_mega.py:1023",
            launched.get("mega_bwd128", 0), z["row3"]["ms"], bwd3,
            WIDTH * HEIGHT * 48 + wbytes, mega_step["grad_rel"],
            mega_step["plain_step_ms_64"]),
        row("segment_fwd128", "segment_fwd128",
            "fvsrn_tpu/ops/fused_dvr.py:1626",
            c_z["segment_fwd"], z["row4"]["ms"], flops4, io4,
            z["row4"]["err"], z["row4"]["plain_ms_64"]),
        row("segment_fwd128_diff", "segment_fwd128",
            "fvsrn_tpu/ops/fused_dvr_bwd.py:1144", c_z["segment_fwd_diff"],
            z["row5"]["ms"], z["row5"]["samples"] * fa,
            WIDTH * HEIGHT * 48 + z["row5"]["carry_bytes"] + wbytes,
            scan_step["img_err"], scan_step["plain_step_ms_64"]),
        row("segment_bwd128", "segment_bwd128",
            "fvsrn_tpu/ops/fused_dvr_bwd.py:1272",
            launched.get("segment_bwd128", 0), z["row6"]["ms"], bwd6,
            WIDTH * HEIGHT * 48 + z["row5"]["carry_bytes"] + wbytes,
            scan_step["grad_rel"], scan_step["plain_step_ms_64"]),
        row("sample_eval128", "sample_eval128",
            "fvsrn_tpu/ops/fused_eval.py:42",
            launched.get("sample_eval128", 0), z["row7"]["ms"],
            z["row7"]["flops"], z["row7"]["io_bytes"], z["row7"]["err"],
            z["row7"]["plain_ms_64"])]


# phase AA: TFs of any size on rows 1-6, the dense flagship's ramp as
# that many points (scenes.dense_tf_points; above the kernels' staged
# count, ops.sample_mlp.TF_STAGED_POINTS, they read it from device
# memory), and normals and position gradients on phase Z's trained
# 128:128:128 network (rows 1, 4, 7)
AA_KNOTS = 40                        # and TF_STAGED_POINTS + 1
AA_GAUSSIANS = 24
AA_MC_SIZE = 128                     # AA2's gradient-scaled MC frame


def tf_points_wide_normals(smi, reset_counts, counts, npz, cam, trained):
    """Phase AA. AA1, TFs of any size: the dense flagship with its ramp as
    AA_KNOTS and TF_STAGED_POINTS + 1 piecewise knots, counts reset: the
    FUSED render at 512^2 on route 1 and at 1920x1080 on route 2, a
    training step (mean(img^2)) on each engine, and a step on each
    engine with the ramp as AA_GAUSSIANS Gaussians; every kernel held
    against its plain version on 64 whole tiles, route 1 also against
    the f32 lattice oracle, each timed at full size beside the ramp's in
    the same call. AA2, phase Z's trained 128:128:128 network, counts
    reset: a shaded frame (Phong) on rows 1 and 4 at 512^2,
    ``eval_gradient_networks``' normal scores and shaded render, row 7's
    gradient instance at Z_POSITIONS positions and a gradient-scaled MC
    walk at AA_MC_SIZE^2; each held against its plain version on 64
    tiles (Z_HELD positions), timed, with the new instances' registers
    and spills. Returns ({row name: figures} of rows 1-6 with many
    points, the kernels line's rows of the width-128 normals and
    gradient instances)."""
    from fvsrn_tpu_torch.brdf import BRDFLambert
    from fvsrn_tpu_torch.camera import generate_rays
    from fvsrn_tpu_torch.eval import eval_gradient_networks as egn
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import (_build, fused_dvr, fused_dvr_bwd,
                                     fused_eval, fused_mega)
    from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
    from fvsrn_tpu_torch.ops.sample_mlp import TF_STAGED_POINTS
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.raytracer.montecarlo import (RayEvaluationMonteCarlo,
                                                      trace_mc)
    from fvsrn_tpu_torch.scenes import dense_scene, dense_tf_points
    from fvsrn_tpu_torch.train.checkpoints import load_weights
    from fvsrn_tpu_torch.transfer import (TransferFunctionGaussian,
                                          TransferFunctionPiecewiseLinear)
    from fvsrn_tpu_torch.utils.prng import prng_key

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    steps_max = max_steps_bound(box[1], STEPSIZE)
    volume, ramp_tf, _ = dense_scene()
    net = load_weights(npz).to(dev)
    rs, rd = generate_rays(cam, WIDTH, HEIGHT, device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    perm, _ = block_ray_permutation(WIDTH, HEIGHT, 16, 16, device=dev)
    rs_b, rd_b = rs[perm].contiguous(), rd[perm].contiguous()
    n_t = rs.shape[0] // 256
    sub = (torch.arange(0, n_t, n_t // ORACLE_TILES,
                        device=dev)[:ORACLE_TILES, None] * 256
           + torch.arange(256, device=dev)).reshape(-1)
    engines = {
        "mega": (fused_mega.mega_trace_dvr, fused_mega.mega_trace_dvr_plain,
                 dict(stepsize=STEPSIZE, differentiable=True), rs_b, rd_b),
        "scan": (fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain,
                 dict(stepsize=STEPSIZE, max_steps=steps_max,
                      enable_early_out=False, differentiable=True), rs, rd)}

    def libs():
        out = {}
        for c in (fused_mega.LIBRARY_LAUNCHES, fused_dvr.LIBRARY_LAUNCHES,
                  fused_mega.BWD_LIBRARY_LAUNCHES,
                  fused_dvr_bwd.LIBRARY_LAUNCHES,
                  fused_eval.LIBRARY_LAUNCHES):
            out.update({k: v for k, v in c.items() if v})
        return out

    def subset(render, n_tile):
        """The render's march arguments on 64 whole tiles of the frame."""
        n = render.ray_start.shape[0] // n_tile
        tiles = torch.arange(0, n, max(n // ORACLE_TILES, 1),
                             device=dev)[:ORACLE_TILES]
        sel = (tiles[:, None] * n_tile
               + torch.arange(n_tile, device=dev)).reshape(-1)
        kw = dict(render.march_kwargs)
        if render.route == "mega":
            kw["tmax_clip"] = render.tmax_clip[sel]
        return (render.ray_start[sel].contiguous(),
                render.ray_dir[sel].contiguous(), render.network,
                render.box_min, render.box_size, render.tf.tensor), kw

    def held_render(name, render, n_tile):
        """(error, plain ms) of the render's kernel against its plain
        version on 64 tiles; route 1 also (its f32-table kernel) against
        the f32 lattice oracle: (error, plain ms, oracle error)."""
        args, kw = subset(render, n_tile)
        kernel, plain = ((fused_mega.mega_trace_dvr,
                          fused_mega.mega_trace_dvr_plain)
                         if render.route == "mega" else
                         (fused_dvr.fused_trace_dvr,
                          fused_dvr.fused_trace_dvr_plain))
        got = kernel(*args, **kw)
        want, pms = cuda_once(lambda: plain(*args, **kw))
        err = max_err(got, want)
        check(err <= KERNEL_TOL and float(want[:, 3].max()) > 0.5,
              f"phase AA1 {name} route {render.route}: kernel vs plain "
              f"{err}, alpha {float(want[:, 3].max())}")
        if render.route != "mega":
            return err, pms, None
        got32 = kernel(*args, **dict(kw, table_dtype=torch.float32))
        ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                             enable_early_out=False)
        vol = VolumeInterpolationNetwork(render.network, *box)
        with torch.no_grad():
            oracle = trace_dvr(args[0], args[1], vol, render.tf, ocfg,
                               steps_max, tmax_in=kw["tmax_clip"],
                               lattice=True).color
        oerr = max_err(got32, oracle)
        check(oerr < ORACLE_TOL, f"phase AA1 {name}: f32 kernel vs the "
              f"lattice oracle {oerr}")
        return err, pms, oerr

    def held_step(name, engine, tensor, kw):
        """(image error, worst leaf's relative error, the leaf, plain ms)
        of one step (mean(img^2)) against the plain pair on 64 tiles."""
        march, plain, _, r_, d_ = engines[engine]
        args = (r_[sub].contiguous(), d_[sub].contiguous(), net, *box)
        img_k, g_k = tf_step(march, args, tensor, None, kw)
        (img_p, g_p), pms = cuda_once(lambda: tf_step(plain, args, tensor,
                                                      None, kw))
        ierr = max_err(img_k, img_p)
        check(sorted(g_k) == sorted(g_p) and ierr <= KERNEL_TOL
              and float(img_p[:, 3].max()) > 0.5,
              f"phase AA1 {name} {engine}: image vs plain {ierr}, leaves "
              f"{sorted(g_k)} vs {sorted(g_p)}")
        rel = {n: rel_err(g_k[n], g_p[n]) for n in g_p}
        check(float(g_p["tf"].abs().max()) > 0,
              f"phase AA1 {name} {engine}: the TF's gradient")
        worst = max(rel, key=rel.get)
        check(rel[worst] <= GRAD_TOL, f"phase AA1 {name} {engine}: grad "
              f"{worst} {rel[worst]} (tol {GRAD_TOL})")
        return ierr, rel[worst], worst, pms

    # AA1. the main path with many knots and Gaussians, counts reset
    n_big = TF_STAGED_POINTS + 1
    cases = {"ramp": (ramp_tf.tensor, {})}
    for n in (AA_KNOTS, n_big):
        cases[f"knots{n}"] = (dense_tf_points(n), {})
    cases[f"gauss{AA_GAUSSIANS}"] = (dense_tf_points(AA_GAUSSIANS, True),
                                     dict(tf_mode="gaussian"))
    renders = {}
    reset_counts()
    for name, (tensor, tf_kw) in cases.items():
        if name == "ramp":
            continue
        if not tf_kw:
            model = LoadedModel(net, TransferFunctionPiecewiseLinear(tensor),
                                config=cfg)
            r1 = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
            r4 = model.prepare_network_render(cam, SEG_WIDTH, SEG_HEIGHT,
                                              "FUSED")
            renders[name] = (r1, r4, r1(), r4())
        for engine, (march, _, kw, r_, d_) in engines.items():
            tf_step(march, (r_, d_, net, *box), tensor.to(dev), None,
                    dict(kw, **tf_kw))
    torch.cuda.synchronize()
    c1, l1 = counts(), libs()
    n_fused = len(renders)
    n_steps = len(cases) - 1
    print(f"phase AA1 main path (TFs of {AA_KNOTS} and {n_big} knots, "
          f"{AA_GAUSSIANS} Gaussians; TF_STAGED_POINTS {TF_STAGED_POINTS}): "
          f"counts {c1}, launches by library {l1}", flush=True)
    check(all(r1.route == "mega" and r4.route == "segment"
              for r1, r4, _, _ in renders.values()),
          "phase AA1: FUSED routes")
    check(c1["mega_fwd"] >= n_fused and c1["segment_fwd"] >= 2 * n_fused
          and c1["mega_fwd_diff"] >= n_steps and c1["mega_bwd"] >= n_steps
          and c1["segment_fwd_diff"] >= n_steps
          and c1["segment_bwd"] >= n_steps
          and l1.get("mega_fwd_tf", 0) >= 1
          and l1.get("segment_fwd_tf", 0) >= 1,
          f"phase AA1: launches {c1} {l1}")
    for name, (_, _, i1, i4) in renders.items():
        for im in (i1, i4):
            check(bool(torch.isfinite(im).all())
                  and float(im[..., 3].max()) > 0.5,
                  f"phase AA1 {name}: the frame")
    # each case held and timed at full size, the ramp's in the same call
    ramp_model = LoadedModel(net, ramp_tf, config=cfg)
    renders["ramp"] = (ramp_model.prepare_network_render(cam, WIDTH, HEIGHT,
                                                         "FUSED"),
                       ramp_model.prepare_network_render(
                           cam, SEG_WIDTH, SEG_HEIGHT, "FUSED"), None, None)
    fig = {}
    for name, (tensor, tf_kw) in cases.items():
        f = {"points": int(tensor.shape[0]),
             "staged": tensor.shape[0] <= TF_STAGED_POINTS}
        if name in renders:
            r1, r4 = renders[name][:2]
            f["row1_ms"] = cuda_ms(r1.march, 3)
            f["row1_samples"] = int(r1.march(return_samples=True)[1].sum())
            (_, st4), f["row4_ms"] = cuda_once(
                lambda: r4.march(return_stats=True))
            f["row4_samples"] = int(st4.samples)
            if name != "ramp":
                (f["row1_err"], f["row1_plain_ms_64"],
                 f["row1_oracle_err"]) = held_render(name, r1, 256)
                f["row4_err"], f["row4_plain_ms_64"], _ = held_render(
                    name, r4, 128)
        tensor = tensor.to(dev)
        for engine, (march, _, kw, r_, d_) in engines.items():
            kw = dict(kw, **tf_kw)
            if name != "ramp":
                (f[f"{engine}_img_err"], f[f"{engine}_grad_rel"],
                 f[f"{engine}_grad_worst"],
                 f[f"{engine}_plain_step_ms_64"]) = held_step(
                    name, engine, tensor, kw)
            _, f[f"{engine}_step_ms"] = cuda_once(
                lambda: tf_step(march, (r_, d_, net, *box), tensor, None,
                                kw))
        fig[name] = f
        print(f"phase AA1 {name} [{smi}]: "
              + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in f.items()),
              flush=True)
    out = {
        "mega_fwd": {k: {q: f.get(q) for q in ("row1_ms", "row1_samples",
                                              "row1_err", "row1_oracle_err",
                                              "row1_plain_ms_64")}
                     for k, f in fig.items() if "row1_ms" in f},
        "segment_fwd": {k: {q: f.get(q) for q in ("row4_ms", "row4_samples",
                                                 "row4_err",
                                                 "row4_plain_ms_64")}
                        for k, f in fig.items() if "row4_ms" in f}}
    for row, engine in (("mega_fwd_diff", "mega"), ("mega_bwd", "mega"),
                        ("segment_fwd_diff", "scan"),
                        ("segment_bwd", "scan")):
        out[row] = {k: {q: f.get(f"{engine}_{q}") for q in
                        ("step_ms", "img_err", "grad_rel", "grad_worst",
                         "plain_step_ms_64")} for k, f in fig.items()}
    for row in out:
        out[row]["launches"] = c1
    out["mega_fwd"]["libraries"] = l1

    # AA2. the trained 128:128:128 network's normals and position
    # gradients, counts reset
    ramp = ramp_tf.tensor.to(dev)
    phong = BRDFLambert.make(**NRM_BRDF)
    gen = torch.Generator(dev).manual_seed(5)
    pos = torch.rand(Z_POSITIONS, 3, device=dev, generator=gen) - 0.5

    def shaded(row, march=None, rays=(rs_b, rd_b), **kw):
        if row == "mega":
            march = march or fused_mega.mega_trace_dvr
            return march(*rays, trained, *box, ramp, stepsize=STEPSIZE,
                         **kw)
        march = march or fused_dvr.fused_trace_dvr
        return march(*rays, trained, *box, ramp, stepsize=STEPSIZE,
                     max_steps=steps_max, **kw)

    rs4, rd4 = generate_rays(cam, AA_MC_SIZE, AA_MC_SIZE, device=dev)
    rs4, rd4 = rs4.reshape(-1, 3).contiguous(), rd4.reshape(-1, 3).contiguous()
    vol128 = VolumeInterpolationNetwork(trained, *box)
    gtf = TransferFunctionGaussian(torch.tensor(MC_NRM_TF, device=dev),
                                   scale_with_gradient=True)
    mcfg = RayEvaluationMonteCarlo.make(max_absorption=14.0, num_bounces=2,
                                        max_iterations=256)
    hg = PhaseFunctionHenyeyGreenstein.make(g=0.3)

    def mc_frame(use_fused=True):
        return trace_mc(prng_key(11), rs4, rd4, vol128, gtf, hg, mcfg,
                        use_fused=use_fused)

    ev_g = fused_eval.make_fused_eval(trained, *box, want_grad=True)
    reset_counts()
    frames = {}
    for row in ("mega", "segment"):
        frames[row] = shaded(row, need_normals=True, brdf=phong,
                             **({"return_samples": True} if row == "mega"
                                else {"return_stats": True}))
    with torch.no_grad():
        egn_render = egn.shaded_render(trained, device=dev)
    egn_rows = egn.normal_rows(trained, volume, eval_samples=8192,
                               fd_step=1e-3, device=dev)
    _, _, grad_k = ev_g(pos)
    mc_out = mc_frame()
    torch.cuda.synchronize()
    c2, l2 = counts(), libs()
    print(f"phase AA2 main path (128:128:128 normals, gradients): counts "
          f"{c2}, launches by library {l2}", flush=True)
    check(l2.get("mega_fwd_nrm128", 0) >= 2
          and l2.get("segment_fwd_nrm128", 0) >= 2
          and c2["sample_eval_grad"] >= 1 + c2["normal_rounds"]
          and c2["normal_rounds"] > 0 and l2.get("sample_eval128", 0) >= 2,
          f"phase AA2: launches {c2} {l2}")
    for row, (o, _) in frames.items():
        check(bool(torch.isfinite(o.color).all()
                   and torch.isfinite(o.normal).all())
              and float(o.color[:, 3].max()) > 0.05
              and float(o.normal.abs().max()) > 0.5,
              f"phase AA2 {row}: the shaded frame")
    check(bool(torch.isfinite(grad_k).all()), "phase AA2: row 7 gradients")
    check(egn_render["ssim"] > 0.9 and all(
        math.isfinite(r["mean_cosine"]) for r in egn_rows),
          f"phase AA2 eval_gradient_networks: SSIM {egn_render['ssim']}, "
          f"rows {egn_rows}")
    # held on 64 tiles, timed beside the unshaded frame of this call
    aa2 = {"eval_gradient_networks": {"rows": egn_rows,
                                      "ssim": egn_render["ssim"],
                                      "ms": egn_render["ms"]},
           "launches": c2, "libraries": l2}
    fwd, grad = sample_flops(trained), position_grad_flops(trained)
    # the bound: the tile's layers on the tensor cores for every evaluated
    # sample, then the scalar network and its position-gradient sweep in
    # float32 for every counting one (value >= density_min = 0: with a
    # density head every evaluated sample counts); the float32 part is
    # the larger by far
    check(trained.output_mode.startswith("density"),
          f"phase AA2: a density head, not {trained.output_mode}")
    for row, (o, st) in frames.items():
        samples = int(st.sum() if row == "mega" else st.samples)
        counting = samples
        got = shaded(row, rays=(rs_b[sub], rd_b[sub]), need_normals=True,
                     brdf=phong)
        want, pms = cuda_once(lambda: shaded(
            row, march=(fused_mega.mega_trace_dvr_plain if row == "mega"
                        else fused_dvr.fused_trace_dvr_plain),
            rays=(rs_b[sub], rd_b[sub]), need_normals=True, brdf=phong))
        off, worst = nrm_off(got, want)
        check(off <= NRM_FLIP_SHARE, f"phase AA2 {row}: kernel vs plain, "
              f"{off} of the rays off")
        ms = cuda_ms(lambda: shaded(row, need_normals=True, brdf=phong), 1)
        unshaded = cuda_ms(lambda: shaded(row), 1)
        aa2[row] = {"ms": ms, "unshaded_ms": unshaded, "samples": samples,
                    "ns_per_sample": ms * 1e6 / max(samples, 1),
                    "vs_plain_off": off, "vs_plain_worst": worst,
                    "max_abs_err": max_err(got.color, want.color),
                    "plain_ms": pms, "counting_samples": counting,
                    "flops_tc": samples * fwd,
                    "flops_f32": counting * (fwd + grad)}
    # row 7's gradient instance: timed at Z_POSITIONS, held on Z_HELD
    g_ms = cuda_ms(lambda: ev_g(pos), 3)
    p = pos[:Z_HELD].contiguous()
    v_k, _, g_k = ev_g(p)
    (v_p, g_p), g_pms = cuda_once(lambda: fused_eval.fused_eval_plain(
        trained, p + 0.5, None, want_grad=True))
    g_p = g_p / torch.tensor(box[1], device=dev)

    def clipped(v):
        return (v <= 0.0) | (v >= 1.0)
    inner = (p.abs() < 0.45).all(dim=1)
    flips = inner & (clipped(v_k) != clipped(v_p))
    check(int(flips.sum()) <= ISO_FLIP_SHARE * int(inner.sum()) + 1,
          f"phase AA2: {int(flips.sum())} clip gates differ")
    inner &= ~flips
    v_err, g_rel = max_err(v_k, v_p), rel_err(g_k[inner], g_p[inner])
    check(v_err <= KERNEL_TOL and g_rel <= GRAD_TOL
          and float(g_p[inner].norm()) > 0,
          f"phase AA2 row 7: values {v_err}, gradient {g_rel}")
    aa2["sample_eval"] = {"ms": g_ms, "positions": Z_POSITIONS,
                          "max_abs_err": v_err, "grad_rel": g_rel,
                          "plain_ms": g_pms, "plain_positions": Z_HELD,
                          "flops_tc": Z_POSITIONS * sample_flops(trained,
                                                                 False),
                          "flops_f32": Z_POSITIONS * (
                              sample_flops(trained, False) + grad)}
    # the gradient-scaled MC walk against the plain walk, same key
    mc_p, mc_pms = cuda_once(lambda: mc_frame(False))
    _, mc_ms = cuda_once(mc_frame)
    a = torch.cat([mc_out.color, mc_out.normal, mc_out.depth], 1)
    b = torch.cat([mc_p.color, mc_p.normal, mc_p.depth], 1)
    share = float(((a - b).abs() < MC_TOL).all(dim=1).float().mean())
    check(share >= MC_MATCH_SHARE, f"phase AA2 MC: {share} of the rays "
          f"within {MC_TOL}")
    aa2["mc"] = {"frame_ms": mc_ms, "plain_frame_ms": mc_pms,
                 "rays_within_tol": share, "size": AA_MC_SIZE,
                 "normal_rounds": c2["normal_rounds"]}
    ptxas = {src: {k: list(v[:3]) for k, v in _build.ptxas_instances(
        _build.ptxas_report(src)).items()}
        for src in ("mega_fwd_nrm128", "segment_fwd_nrm128",
                    "sample_eval128")}
    for src, v in ptxas.items():
        print(f"phase AA2 ptxas {src}: " + "; ".join(
            f"{k[-60:]} {r}" for k, r in v.items()), flush=True)
    print(f"phase AA2 128:128:128 [{smi}]: shaded {WIDTH}x{HEIGHT} row 1 "
          f"{aa2['mega']['ms']:.1f} ms (unshaded "
          f"{aa2['mega']['unshaded_ms']:.1f}), row 4 "
          f"{aa2['segment']['ms']:.1f} ms (unshaded "
          f"{aa2['segment']['unshaded_ms']:.1f}); vs plain on "
          f"{ORACLE_TILES} tiles off {aa2['mega']['vs_plain_off']:.5f} / "
          f"{aa2['segment']['vs_plain_off']:.5f} of the rays; row 7 "
          f"gradient {Z_POSITIONS} positions {g_ms:.3f} ms, values "
          f"{v_err:.2e}, gradient rel {g_rel:.2e}; MC {AA_MC_SIZE}^2 "
          f"{mc_ms:.1f} ms (plain {mc_pms:.1f}), {share:.5f} of the rays "
          f"within {MC_TOL}; eval_gradient_networks SSIM "
          f"{egn_render['ssim']:.4f}, rows {egn_rows}", flush=True)
    out["mega_fwd"]["wide_normals"] = aa2["mega"]
    out["segment_fwd"]["wide_normals"] = aa2["segment"]
    print(f"phase AA: {time.perf_counter() - t_phase:.1f} s", flush=True)

    def row(name, src, replaces, n, f, err):
        tc_ms = f["flops_tc"] / PEAK_BF16_TC * 1e3
        f32_ms = f["flops_f32"] / PEAK_F32 * 1e3
        return {"name": name, "route": "cuda",
                "source": f"fvsrn_tpu_torch/csrc/{src}.cu",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": f["ms"], "plain_ms": f["plain_ms"],
                "bound_ms": max(tc_ms, f32_ms),
                "bound_by": "operations", "library_ms": None,
                "bound_part": ("float32 gradient sweep" if f32_ms >= tc_ms
                               else "tensor-core layers"),
                "bound_tc_ms": tc_ms, "bound_f32_ms": f32_ms,
                "plain_rays": Z_HELD, "ptxas": ptxas[src],
                "figures": f}
    return out, [
        row("mega_fwd_nrm128", "mega_fwd_nrm128",
            "fvsrn_tpu/ops/fused_mega.py:274", l2.get("mega_fwd_nrm128", 0),
            aa2["mega"], aa2["mega"]["max_abs_err"]),
        row("segment_fwd_nrm128", "segment_fwd_nrm128",
            "fvsrn_tpu/ops/fused_dvr.py:1626", l2.get("segment_fwd_nrm128", 0),
            aa2["segment"], aa2["segment"]["max_abs_err"]),
        row("sample_eval128_grad", "sample_eval128",
            "fvsrn_tpu/ops/fused_eval.py:42", c2["sample_eval_grad"],
            aa2["sample_eval"], aa2["sample_eval"]["max_abs_err"])]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from fvsrn_tpu_torch.camera import CameraOnASphere
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import (_build, fused_dvr, fused_dvr_bwd,
                                     fused_eval, fused_mega)
    from fvsrn_tpu_torch.raytracer import montecarlo
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.scenes import dense_scene

    t_start = time.perf_counter()

    def clock(phase):
        print(f"chip_smoke clock: {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {kind} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build every kernel of the path: one nvcc per source in the
    # background, as many at a time as the cores, in the order the phases
    # first load them (a phase waits for its own sources only) and below
    # the phases' own priority
    t_build = time.perf_counter()
    jobs = len(os.sched_getaffinity(0))
    builds = _build.start(BUILD_ORDER, jobs=jobs, nice=10)
    check(set(builds) == set(_build.SOURCES), "phase 2: BUILD_ORDER is not "
          f"the sources {sorted(set(_build.SOURCES) ^ set(builds))}")
    print(f"phase 2 build: {len(builds)} sources, {jobs} at a time, in the "
          "background", flush=True)

    def reset_counts():
        fused_mega.LAUNCHES.clear()
        fused_dvr.SEGMENT_LAUNCHES = 0
        fused_dvr_bwd.LAUNCHES.clear()
        fused_eval.SAMPLE_EVAL_LAUNCHES = 0
        fused_eval.SAMPLE_EVAL_POSITIONS = 0
        montecarlo.TRACKING_ROUNDS = 0
        fused_dvr.SEGMENT_NRM_LAUNCHES = 0
        fused_eval.SAMPLE_GRAD_LAUNCHES = 0
        montecarlo.NORMAL_ROUNDS = 0
        fused_mega.LIBRARY_LAUNCHES.clear()
        fused_dvr.LIBRARY_LAUNCHES.clear()
        fused_mega.BWD_LIBRARY_LAUNCHES.clear()
        fused_dvr_bwd.LIBRARY_LAUNCHES.clear()
        fused_eval.LIBRARY_LAUNCHES.clear()

    def counts():
        return {"mega_fwd": fused_mega.launches("mega_fwd"),
                "mega_fwd_diff": fused_mega.launches("mega_fwd_diff"),
                "mega_bwd": fused_mega.launches("mega_bwd"),
                "segment_fwd": fused_dvr.SEGMENT_LAUNCHES,
                "segment_fwd_diff": fused_dvr_bwd.launches("segment_fwd_diff"),
                "segment_bwd": fused_dvr_bwd.launches("segment_bwd"),
                "sample_eval": fused_eval.SAMPLE_EVAL_LAUNCHES,
                "sample_eval_positions": fused_eval.SAMPLE_EVAL_POSITIONS,
                "tracking_rounds": montecarlo.TRACKING_ROUNDS,
                "mega_fwd_nrm": fused_mega.launches("mega_fwd_nrm"),
                "segment_fwd_nrm": fused_dvr.SEGMENT_NRM_LAUNCHES,
                "sample_eval_grad": fused_eval.SAMPLE_GRAD_LAUNCHES,
                "normal_rounds": montecarlo.NORMAL_ROUNDS,
                "mega_fwd_anytf": sum(
                    n for k, n in fused_mega.LIBRARY_LAUNCHES.items()
                    if k.startswith("mega_fwd_anytf")),
                "segment_fwd_anytf":
                    fused_dvr.LIBRARY_LAUNCHES["segment_fwd_anytf"]}

    # phase K launches the smallest library
    _, tf, npz = dense_scene()
    probe = probe_rows(smi)
    clock("phase K")

    # 3. the first main path: product render of the dense flagship
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    model = LoadedModel.from_checkpoint(npz, tf=tf, config=cfg)
    cam = CameraOnASphere.make(**CAMERA)
    t0 = time.perf_counter()
    render = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    reset_counts()
    img = render()
    torch.cuda.synchronize()
    render_counts = counts()
    launches = render_counts["mega_fwd"]
    check(tuple(img.shape) == (HEIGHT, WIDTH, 4), f"shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    amax = float(img[..., 3].max())
    check(amax > 0.5, f"alpha max {amax}")
    check(launches > 0, "the render did not launch mega_fwd")
    print(f"phase 3 render: {WIDTH}x{HEIGHT} h=1/{round(1 / STEPSIZE)} "
          f"alpha max {amax:.4f}, launches {render_counts}, "
          f"planning {plan_s:.2f} s", flush=True)

    # 4. kernel vs its plain version on the same rays and clip
    got, samples = render.march(return_samples=True)
    plain, samples_plain = render.march(fused_mega.mega_trace_dvr_plain,
                                        return_samples=True)
    err = float((got - plain).abs().max())
    n_samples = int(samples.sum())
    n_samples_plain = int(samples_plain.sum())
    print(f"phase 4 kernel vs plain: max|d| {err:.3e} (tol {KERNEL_TOL}), "
          f"samples {n_samples} vs {n_samples_plain}", flush=True)
    check(err <= KERNEL_TOL, f"kernel vs plain {err}")

    # 5. kernel vs the f32 lattice oracle (bf16-table contract)
    vol = VolumeInterpolationNetwork(render.network, model.box_min,
                                     model.box_size)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)
    with torch.no_grad():
        oracle = trace_dvr(render.ray_start, render.ray_dir, vol, render.tf,
                           ocfg, max_steps_bound(model.box_size, STEPSIZE),
                           tmax_in=render.tmax_clip, lattice=True).color
    oerr = float((got - oracle).abs().max())
    print(f"phase 5 kernel vs lattice oracle: max|d| {oerr:.3e} "
          f"(tol {ORACLE_TOL})", flush=True)
    check(oerr < ORACLE_TOL, f"kernel vs oracle {oerr}")

    # 6. timing
    mean_ms, std_ms, frames = model.time_rendering(
        LoadedModel.rotation_cameras(TIMED_CAMERAS), WIDTH, HEIGHT)
    kernel_ms = cuda_ms(lambda: render.march(), 10)
    plain_ms = cuda_ms(
        lambda: render.march(fused_mega.mega_trace_dvr_plain), 1)
    flops = n_samples * sample_flops(render.network)
    table_bytes = 16 * render.network.latent.static_grid[0].numel() * 2
    n_rays = WIDTH * HEIGHT
    io_bytes = n_rays * (6 + 1 + 4) * 4 + table_bytes + 15_000
    bound_s = max(flops / PEAK_BF16_TC, io_bytes / PEAK_BYTES)
    bound_f32_s = max(flops / PEAK_F32, io_bytes / PEAK_BYTES)
    print(f"phase 6 timing [{smi}]: product render {mean_ms:.3f} ms/frame "
          f"(std {std_ms:.3f}, {len(frames)} cameras), "
          f"{n_rays / mean_ms / 1e3:.3f} Mrays/s; kernel {kernel_ms:.3f} ms; "
          f"plain {plain_ms:.1f} ms; samples/frame {n_samples} "
          f"({n_samples / n_rays:.1f}/ray); bound {bound_s * 1e3:.4f} ms "
          f"(bf16 tensor cores, share {bound_s * 1e3 / kernel_ms:.4f}), "
          f"{bound_f32_s * 1e3:.4f} ms (f32 CUDA cores, share "
          f"{bound_f32_s * 1e3 / kernel_ms:.4f}), bound by operations "
          f"({flops / 1e9:.1f} GFLOP, {io_bytes / 1e6:.1f} MB)", flush=True)

    render_row = {
        "name": "mega_fwd", "route": "cuda",
        "source": "fvsrn_tpu_torch/csrc/mega_fwd.cu",
        "replaces": "fvsrn_tpu/ops/fused_mega.py:274",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": ("operations" if flops / PEAK_BF16_TC
                     > io_bytes / PEAK_BYTES else "bytes"),
        "library_ms": None,
        "bound_f32_ms": bound_f32_s * 1e3, "frame_ms": mean_ms,
        "samples": n_samples, "oracle_max_abs_err": oerr,
        "ptxas": ptxas_summary("mega_fwd")}
    train_rows = training(smi, reset_counts, counts, npz, tf, cam)
    clock("phases 3-10")
    # the megakernel's sparse arm while the per-segment engine builds
    render_row["sparse"] = sparse_arm(smi, reset_counts, counts, cam)
    clock("phase J")
    segment_row = segment_paths(smi, reset_counts, counts, npz, tf, cam)
    clock("phases A-E")
    scan_rows = scan_training(smi, reset_counts, counts, npz, tf, cam)
    clock("phases F-G")
    mc_row = monte_carlo(smi, reset_counts, counts, npz, tf, cam)
    clock("phases H-I")
    # the phases that compute most on the host's cores, once the sources
    # that the phases before them need are built
    world_training(smi, reset_counts, counts, npz, tf)
    clock("phase L")
    voxel = voxel_volume(smi, reset_counts, counts)
    clock("phase M")
    for row in [render_row] + train_rows:
        row["phase_m_launches"] = voxel["launches"][row["name"]]
    tfm, tfm_counts = tf_modes(smi, reset_counts, counts, npz, cam, mean_ms)
    clock("phase N")
    # each TF mode's figures ride on its rows (1-6)
    keys = {"mega_fwd": ("row1_ms", "row1_err", "row1_launches"),
            "segment_fwd": ("row4_ms", "row4_err", "row4_launches"),
            "mega_fwd_diff": ("mega_step_ms", "mega_img_err",
                              "mega_launches"),
            "mega_bwd": ("mega_step_ms", "mega_grad_rel", "mega_launches"),
            "segment_fwd_diff": ("scan_step_ms", "scan_img_err",
                                 "scan_launches"),
            "segment_bwd": ("scan_step_ms", "scan_grad_rel",
                            "scan_launches")}
    for row in [render_row, segment_row] + train_rows + scan_rows:
        ms_key, err_key, n_key = keys[row["name"]]
        row["tf_modes"] = {
            mode: {"ms" if "step" not in ms_key else "step_ms": f[ms_key],
                   "err": f.get(err_key), "launches": f.get(n_key)}
            for mode, f in tfm.items()}
    render_row["tf_modes_trainer_launches"] = tfm_counts
    nets, ptxas, net_counts, net64 = networks(smi, reset_counts, counts, tf,
                                              cam)
    for row in [render_row] + train_rows:   # rows 1-3
        row["networks"] = nets[row["name"]]
    render_row["networks_ptxas"] = {str(w): v for w, v in ptxas.items()}
    render_row["networks_trainer_launches"] = net_counts
    # the normals and shading of rows 1 and 4, row 7 in the MC walk
    clock("phase O")
    nrm = normals(smi, reset_counts, counts, npz, tf, cam, net64)
    clock("phase P")
    for row in (render_row, segment_row, mc_row):
        row["normals"] = nrm[row["name"]]
    # config 5, time- and ensemble-keyframed: rows 1-7 through the resolve
    kf = keyframes(smi, reset_counts, counts, npz, tf, cam, kernel_ms)
    clock("phase Q")
    for row in [render_row, segment_row, mc_row] + train_rows + scan_rows:
        row["keyframes"] = kf[row["name"]]
    # bench.py's configuration (rows 1-3; rows 5-6 with a bf16 table) and
    # row 3's ray gradients
    bench = bench_step(smi, reset_counts, counts, cam)
    clock("phase R")
    keys = {"mega_fwd": ("frame_ms", "row1_ms", "frame_mrays",
                         "ns_per_sample", "samples", "culled", "plan_s",
                         "buckets"),
            "mega_fwd_diff": ("row2_ms", "step_ms", "step_ms_again",
                              "step_mrays", "step_f32_table_ms",
                              "step_t256_f32_ms"),
            "mega_bwd": ("row3_ms", "step_ms", "oracle_max", "oracle_p99",
                         "oracle_grad_rel", "kernel_vs_plain",
                         "grad_rel_plain", "grid_elem_rel", "grid_leaf_rel",
                         "plain_fwd_bwd_ms")}
    for row in [render_row] + train_rows:
        row["bench_config"] = {
            arm: {k: bench[arm][k] for k in keys[row["name"]]}
            for arm in ("dense", "sparse")}
        row["bench_config"]["launches"] = {
            k: v for k, v in bench["launches"].items()
            if k.startswith(row["name"] + ":")}
    for row in scan_rows:
        row["bf16_table"] = bench["rows56"]
    train_rows[1]["ray_grads"] = ray_gradients(smi, reset_counts, counts,
                                               cam)
    clock("phase S")
    # pose recovery through row 1; data parallelism through rows 2-3 and 7
    render_row["pose"] = pose_recovery(smi, reset_counts, counts)
    clock("phase T")
    dp = data_parallel(smi, reset_counts, counts, npz)
    for row in train_rows + [mc_row]:
        row["data_parallel"] = dp[row["name"]]
    clock("phase U")
    # the paper's evaluation harnesses through rows 1-3
    ev = evaluation(smi, reset_counts, counts)
    for row in [render_row] + train_rows:
        row["evaluation"] = ev[row["name"]]
    clock("phase V")
    # the last modules (no TPU kernel), then the texture and preintegrated
    # TFs on every network in rows 1 and 4
    last_modules(smi, reset_counts, counts)
    clock("phase W")
    anytf_rows = any_tf(smi, reset_counts, counts, cam)
    clock("phase X")
    # every TF mode on every network in training, rows 2-3 and 5-6
    tfn, anyg_rows = tf_training(smi, reset_counts, counts, cam, tfm)
    for row in train_rows + scan_rows:
        row["tf_modes_networks"] = tfn[row["name"]]
    clock("phase Y")
    # Table 1's wide networks on rows 1-7 (the width-128 instances)
    trained128, wide_rows = wide_networks(smi, reset_counts, counts, cam)
    clock("phase Z")
    # TFs of any size on rows 1-6; normals and position gradients on the
    # trained 128:128:128 network (rows 1, 4, 7)
    aa, aa_rows = tf_points_wide_normals(smi, reset_counts, counts, npz,
                                         cam, trained128)
    for row in [render_row, segment_row] + train_rows + scan_rows:
        row["tf_points"] = aa[row["name"]]
    clock("phase AA")

    # 2, finished: every source built, each nvcc's seconds, the seconds the
    # phases waited for one, the ptxas reports
    secs = {name: f.result() for name, f in builds.items()}
    done = {k: _build.FINISHED[k] - t_build for k in secs
            if k in _build.FINISHED}
    print(f"phase 2 build: the last source built "
          f"{max(done.values(), default=0.0):.1f} s after the start, "
          f"{sum(secs.values()):.1f} s of nvcc in all "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}); the "
          f"phases waited {sum(_build.WAITED.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in _build.WAITED.items())
          + "); built at (s after the start) "
          + ", ".join(f"{k} {v:.1f}" for k, v in done.items()), flush=True)
    for name in secs:
        print(_build.ptxas_report(name).strip(), flush=True)

    # 11. kernels
    print(json.dumps({"kernels": [render_row] + train_rows
                      + [segment_row] + scan_rows + [mc_row] + probe
                      + anytf_rows + anyg_rows + wide_rows + aa_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        # a failed phase stops the sources still building
        b = sys.modules.get("fvsrn_tpu_torch.ops._build")
        if b is not None:
            b.stop()
        raise
    sys.exit(code)
